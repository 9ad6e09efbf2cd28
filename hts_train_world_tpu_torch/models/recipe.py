"""HMM-voice training recipe — the Training.pl driver, on the card.

Counterpart of `hts_train_world_tpu/models/recipe.py`: one typed config
with the reference's stage switches (Config.pm.in:310-349) and training
knobs (nIte, DAEM, configure.ac:698-713), and one driver that runs the HTS
flow on the MSD-HSMM stack:

  IN_RE   init_modelset (HInit/HRest bootstrap from label spans)
  ERST0   monophone embedded re-estimation — full Baum-Welch (batched),
          DAEM-annealed, or segmental Viterbi (Training.pl:417-446)
  SEMIT   semi-tied block-diagonal transforms of the monophones
          (`cfg.semitied`; Training.pl:1017-1035; K17 + K20, K34), a side
          product on a copy of the set
  UPMIX/ERST5   1 -> 2 mixture components and their embedded
          re-estimation (`cfg.upmix`; Training.pl:1086-1098, 2155-2177;
          K33, K20, K19), a side product
  CXCL/ERST2   full-context stats -> MDL tree clustering -> tied model
  UNTIE/CXCL2/ERST4   untied statistics from the tied model, the second
          clustering round and its re-estimation (Training.pl:553-599)
  FALGN   Viterbi forced alignment under the CLUSTERED model
          (HSMMAlign on the tied mmf, Training.pl:601-618)
  MCDGV   context-dependent GV models from per-utterance static
          variances (Training.pl:620-685, make_data_gv :1402-1491)
  MSPF    natural vs generated modulation-spectrum statistics under the
          forced alignment (make_mspf, Training.pl:687-724; K8, K21)
  PGEN/WGEN  label sequence -> waveform (synthesize_utterance,
          Training.pl:730-759; models/pgen.py)
  CONVM   .htsvoice export incl. GV sections (export;
          Training.pl:761-797)

The E-steps, alignments and generation run on the card (`device="cuda"`,
the default; K17-K20, K8, K21, K33, K34) or, with `device="cpu"`, through
the kernels' plain twins; the tree search and the M-steps are host numpy.
SEMIT and UPMIX leave every later stage as it is without them (the
clustering starts from ERST0's monophones).  `RecipeState.stage_seconds`
records each stage's wall time (host clock; every stage ends in a read of
its results to the host).  `state_from_numpy` builds a RecipeState from
plain parts (a voice trained elsewhere, e.g. by the JAX package).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.models import clustering, context_clustered
from hts_train_world_tpu_torch.models import gv_model, hsmm
from hts_train_world_tpu_torch.models import hsmm_variants as hv
from hts_train_world_tpu_torch.models import hsmm_batch as hb
from hts_train_world_tpu_torch.models import pgen as pgen_mod
from hts_train_world_tpu_torch.ops import postfilter as pf_mod


@dataclasses.dataclass(frozen=True)
class RecipeConfig:
    """Stage switches + knobs (Config.pm.in:310-349, configure.ac)."""
    n_states: int = 5            # $nState
    n_iters: int = 5             # $nIte embedded EM sweeps
    max_dur: int = 60            # HSMM duration cap (MAXSTDDEVCOEF analog)
    var_floor_scale: float = 0.01   # $vflr
    # DAEM (configure.ac:701-703)
    daem: bool = False
    daem_n_iter: int = 10        # DAEMNITER
    daem_alpha: float = 1.0      # DAEMALPHA
    # clustering (Config.pm.in:69-97)
    mdl_factor: float = 1.0
    min_occupancy: float = 1.0
    # tied-model refinement (ERST2 / UNTIE->CXCL2 / ERST4)
    tied_iters: int = 1          # embedded EM sweeps on the tied model
    recluster: bool = True       # UNTIE + second clustering round
    # variants
    upmix: bool = False          # UPMIX + ERST5
    upmix_iters: int = 2
    semitied: bool = False       # SEMIT
    semitied_iters: int = 20     # MAXSEMITIEDITER
    # E-step flavor for embedded stages
    soft_counts: bool = True     # full BW (HERest) vs segmental (HInit)
    # voice building (MCDGV/MSPF/PGEN/WGEN/CONVM, Training.pl:620-797)
    n_win: int = 3               # delta windows in the cmp layout
    use_gv: bool = True          # $useHmmGV
    cdgv: bool = True            # $cdgv (context-dependent GV trees)
    nosilgv: bool = True         # $nosilgv (drop silence frames from GV)
    silence_phones: Tuple[str, ...] = ("sil", "pau")   # @slnt
    use_mspf: bool = False       # $useMSPF
    mspf_weight: float = 1.0
    pgtype: int = 0              # HMGenS -c {0,1,2}
    postfilter_mcp: float = 0.0  # mcep postfilter strength (ref 1.4)
    alpha: float = 0.42          # frequency warping for the postfilter


@dataclasses.dataclass
class RecipeState:
    monophone: Optional[hsmm.ModelSet] = None
    clustered: Optional[context_clustered.ClusteredModel] = None
    mixture: Optional[hv.MixtureModelSet] = None
    semitied: Optional[hv.SemiTiedModelSet] = None
    alignments: Optional[Dict[int, np.ndarray]] = None
    gv: Optional[gv_model.GVModel] = None
    mspf: Optional[tuple] = None          # (nat, gen) MspfStats
    log_history: List[str] = dataclasses.field(default_factory=list)
    # stage -> wall seconds: IN_RE, ERST0, SEMIT, UPMIX (with ERST5), CXCL
    # estep, CXCL trees, ERST2, CXCL2 estep, CXCL2 trees, ERST4, FALGN,
    # MCDGV, MSPF (those that ran)
    stage_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)


def train_voice(corpus, questions, cfg: RecipeConfig = RecipeConfig(),
                streams: Sequence[hsmm.StreamDef] | None = None,
                bootstrap_spans=None, log=print,
                device="cuda") -> RecipeState:
    """Run the recipe.

    corpus: list of (frames (T, D), full_context_label_seq).
    questions: clustering questions (`models.clustering.Question`, e.g.
    from `clustering.questions_from_config(qconf.parse_config(...))`).
    bootstrap_spans: optional {utt_index: phone end frames} for HInit-style
    supervised bootstrapping; uniform cuts otherwise.  device: where the
    E-steps and alignments run ("cuda" raises without a card).
    """
    device_mod.resolve(device)
    streams = tuple(streams or hsmm.world_streams())
    state = RecipeState()
    clock = [time.perf_counter()]

    def say(msg):
        state.log_history.append(msg)
        log(msg)

    def lap(stage):
        now = time.perf_counter()
        state.stage_seconds[stage] = now - clock[0]
        clock[0] = now

    # ---- IN_RE: monophone bootstrap --------------------------------
    say("IN_RE: monophone initialization")
    mono_seqs = [[context_clustered.phone_of(c) for c in seq]
                 for _, seq in corpus]
    names = sorted({p for seq in mono_seqs for p in seq})
    frames_by_model: Dict[str, list] = {n: [] for n in names}
    for ui, (frames, _) in enumerate(corpus):
        seq = mono_seqs[ui]
        if bootstrap_spans and ui in bootstrap_spans:
            ends = np.asarray(bootstrap_spans[ui])
        else:
            ends = np.linspace(0, len(frames), len(seq) + 1)[1:].astype(int)
        starts = np.concatenate([[0], ends[:-1]])
        for i, p in enumerate(seq):
            frames_by_model[p].append(frames[starts[i]:ends[i]])
    ms = hsmm.init_modelset(names, frames_by_model, streams,
                            n_states=cfg.n_states,
                            var_floor_scale=cfg.var_floor_scale)
    lap("IN_RE")

    # ---- ERST0: monophone embedded re-estimation -------------------
    utts_mono = [(f, mono_seqs[ui]) for ui, (f, _) in enumerate(corpus)]
    if cfg.daem:
        say(f"ERST0: DAEM-annealed embedded re-estimation "
            f"({cfg.daem_n_iter} x {cfg.n_iters})")
        hsmm.daem_reestimate(ms, utts_mono, n_outer=cfg.daem_n_iter,
                             n_inner=cfg.n_iters, alpha=cfg.daem_alpha,
                             var_floor_scale=cfg.var_floor_scale,
                             max_dur=cfg.max_dur, log=say,
                             batched=cfg.soft_counts, device=device)
    elif cfg.soft_counts:
        say("ERST0: embedded re-estimation (batched Baum-Welch)")
        hb.reestimate_modelset_batched(
            ms, utts_mono, n_iters=cfg.n_iters,
            var_floor_scale=cfg.var_floor_scale, max_dur=cfg.max_dur,
            log=say, device=device)
    else:
        say("ERST0: embedded re-estimation (viterbi)")
        hsmm.embedded_reestimate(ms, utts_mono, n_iters=cfg.n_iters,
                                 var_floor_scale=cfg.var_floor_scale,
                                 max_dur=cfg.max_dur, log=say,
                                 mode="viterbi", device=device)
    state.monophone = ms
    lap("ERST0")

    # ---- SEMIT ------------------------------------------------------
    if cfg.semitied:
        say("SEMIT: semi-tied covariance transforms")
        # estimate_semitied updates the set it is given with
        # transformed-space variances, while UPMIX, CXCL and FALGN consume
        # untransformed frames: it runs on a copy, and the SemiTiedModelSet
        # is the stage's side product
        state.semitied = hv.estimate_semitied(
            copy.deepcopy(ms), utts_mono, n_iter=cfg.semitied_iters,
            max_dur=cfg.max_dur, var_floor_scale=cfg.var_floor_scale,
            log=say, device=device)
        lap("SEMIT")

    # ---- UPMIX + ERST5 ----------------------------------------------
    if cfg.upmix:
        say("UPMIX: 1 -> 2 mixture components + embedded mixture EM")
        mms = hv.upmix(ms)
        hv.embedded_reestimate_mix(mms, utts_mono, n_iters=cfg.upmix_iters,
                                   var_floor_scale=cfg.var_floor_scale,
                                   max_dur=cfg.max_dur, log=say,
                                   device=device)
        state.mixture = mms
        lap("UPMIX")

    # ---- MN2FL/ERST1/CXCL: full-context clustering -------------------
    say("CXCL: full-context statistics + MDL tree clustering")
    utts_full = [(f, seq) for f, seq in corpus]
    if cfg.soft_counts:
        # reference-true flow (Training.pl:449-494): clone untied
        # full-context models, HERest them, cluster from THEIR counts
        contexts = sorted({c for _, seq in corpus for c in seq})
        full_ms = context_clustered.clone_full_context(ms, contexts)
        stream_stats, msd_stats, dur_stats = \
            context_clustered.collect_context_stats_soft(
                full_ms, utts_full, cfg.max_dur, n_reest=1,
                var_floor_scale=cfg.var_floor_scale, log=say, device=device)
    else:
        stream_stats, msd_stats, dur_stats = \
            context_clustered.collect_context_stats(ms, utts_full,
                                                    cfg.max_dur, device)
    lap("CXCL estep")
    state.clustered = context_clustered.build_clustered_model(
        ms, stream_stats, msd_stats, dur_stats, questions,
        mdl_factor=cfg.mdl_factor, min_occupancy=cfg.min_occupancy)
    lap("CXCL trees")

    # ---- ERST2: embedded re-estimation of the tied model -------------
    if cfg.tied_iters > 0:
        if cfg.soft_counts:
            say("ERST2: tied-model re-estimation (batched Baum-Welch)")
            hb.reestimate_clustered_batched(
                state.clustered, utts_full, n_iters=cfg.tied_iters,
                max_dur=cfg.max_dur, var_floor_scale=cfg.var_floor_scale,
                log=say, device=device)
        else:
            say("ERST2: tied-model embedded re-estimation (viterbi)")
            context_clustered.reestimate_clustered(
                state.clustered, utts_full, n_iters=cfg.tied_iters,
                max_dur=cfg.max_dur, var_floor_scale=cfg.var_floor_scale,
                log=say, device=device)
        lap("ERST2")

    # ---- UNTIE -> CXCL2 -> ERST4 --------------------------------------
    if cfg.recluster:
        say("UNTIE/CXCL2: untied statistics from the tied model "
            "+ second clustering round")
        if cfg.soft_counts:
            contexts = sorted({c for _, seq in corpus for c in seq})
            untied = context_clustered.clone_from_clustered(
                state.clustered, contexts)
            ss2, ms2_, ds2 = context_clustered.collect_context_stats_soft(
                untied, utts_full, cfg.max_dur, n_reest=1,
                var_floor_scale=cfg.var_floor_scale, log=say, device=device)
        else:
            ss2, ms2_, ds2 = context_clustered.collect_context_stats_tied(
                state.clustered, utts_full, cfg.max_dur, device)
        lap("CXCL2 estep")
        state.clustered = context_clustered.build_clustered_model(
            ms, ss2, ms2_, ds2, questions,
            mdl_factor=cfg.mdl_factor, min_occupancy=cfg.min_occupancy)
        lap("CXCL2 trees")
        if cfg.tied_iters > 0:
            say("ERST4: re-estimation of the reclustered model")
            if cfg.soft_counts:
                hb.reestimate_clustered_batched(
                    state.clustered, utts_full, n_iters=cfg.tied_iters,
                    max_dur=cfg.max_dur,
                    var_floor_scale=cfg.var_floor_scale, log=say,
                    device=device)
            else:
                context_clustered.reestimate_clustered(
                    state.clustered, utts_full, n_iters=cfg.tied_iters,
                    max_dur=cfg.max_dur,
                    var_floor_scale=cfg.var_floor_scale, log=say,
                    device=device)
            lap("ERST4")

    # ---- FALGN: forced alignment under the CLUSTERED model -----------
    # (the reference aligns with the re-estimated tied mmf, not the
    # monophone set: HSMMAlign -H $reclmmf, Training.pl:613)
    say("FALGN: Viterbi forced alignment (clustered model)")
    state.alignments = {}
    aligned = context_clustered.align_corpus_with_clustered(
        state.clustered, corpus, cfg.max_dur, device)
    for ui, res in enumerate(aligned):
        if isinstance(res, ValueError):
            # drop unalignable utterances like the reference's screening
            # gates (data/Makefile.in:216-238, Training.pl:601-618)
            say(f"FALGN: dropping utt {ui}: {res}")
            continue
        state.alignments[ui] = res[1]
    lap("FALGN")

    # ---- MCDGV: context-dependent GV models ---------------------------
    if cfg.use_gv:
        say("MCDGV: GV models from per-utterance static variances")
        state.gv = make_gv(state, corpus, cfg, questions)
        lap("MCDGV")

    # ---- MSPF: modulation-spectrum postfilter statistics --------------
    if cfg.use_mspf:
        say("MSPF: natural/generated modulation-spectrum statistics")
        state.mspf = make_mspf(state, corpus, cfg, device)
        lap("MSPF")

    say("recipe complete")
    return state


# ---------------------------------------------------------------------------
# MCDGV (Training.pl:620-685) — per-utterance GV observations
# ---------------------------------------------------------------------------


def _statics(frames: np.ndarray, st: hsmm.StreamDef, n_win: int):
    """Static block of one stream from cmp-layout frames (the window
    expansion is [static | delta | delta2], features/windows.py)."""
    width = (st.sl.stop - st.sl.start) // n_win
    return frames[:, st.sl.start:st.sl.start + width]


def _phone_ends(state: RecipeState, ui: int, n_states: int):
    ends = state.alignments.get(ui)
    return None if ends is None else ends[n_states - 1::n_states]


def make_gv(state: RecipeState, corpus, cfg: RecipeConfig,
            questions) -> gv_model.GVModel:
    """make_data_gv + MCDGV: per utterance, the per-dimension variance of
    each stream's statics over non-silence (and MSD-present) frames, one
    observation labeled by the utterance's first full-context label,
    clustered by the usual questions when cdgv (Training.pl:1402-1491)."""
    model = state.clustered
    obs = []
    for ui, (frames, ctx_seq) in enumerate(corpus):
        keep = np.ones(len(frames), bool)
        if cfg.nosilgv and cfg.silence_phones:
            pe = _phone_ends(state, ui, cfg.n_states)
            if pe is not None:
                keep = gv_model.silence_keep_mask(
                    [context_clustered.phone_of(c) for c in ctx_seq],
                    pe, cfg.silence_phones, len(frames))
        statics = {}
        keeps = {}
        for st in model.streams:
            statics[st.name] = _statics(frames, st, cfg.n_win)
            k = keep
            if st.msd:
                k = keep & (frames[:, st.msd_flag_col] != 0.0)
            keeps[st.name] = k
        ctx0 = ctx_seq[0] if cfg.cdgv else "gv"
        obs.append((ctx0, statics, keeps))
    stats = gv_model.gv_observations(obs)
    return gv_model.build_gv_model(
        stats, questions, mdl_factor=cfg.mdl_factor,
        min_occupancy=cfg.min_occupancy, context_dependent=cfg.cdgv)


# ---------------------------------------------------------------------------
# MSPF (Training.pl:687-724) — natural vs aligned-generation stats
# ---------------------------------------------------------------------------


def make_mspf(state: RecipeState, corpus, cfg: RecipeConfig, device="cuda"):
    """Natural mgc statics vs parameters generated under the FORCED
    alignment (HMGenS -m with fal labels, Training.pl:713-721): the two
    modulation-spectrum statistics the postfilter maps between.  Per
    aligned utterance one MLPG (K8) on `device`; each set of trajectories
    analysed by K21, one launch an utterance."""
    dev = device_mod.resolve(device)
    model = state.clustered
    mgc_st = next(st for st in model.streams if st.name == "mgc")
    nat_trajs, gen_trajs = [], []
    for ui, (frames, ctx_seq) in enumerate(corpus):
        ends = state.alignments.get(ui)
        if ends is None:
            continue
        durs = np.diff(np.concatenate([[0], ends]))
        fp = pgen_mod.frame_params(model, ctx_seq, durs, dev)
        statics = pgen_mod.mlpg_streams(fp, model.streams, cfg.n_win)
        nat_trajs.append(_statics(frames, mgc_st, cfg.n_win))
        gen_trajs.append(statics["mgc"])
    nat = pf_mod.mspf_stats(nat_trajs, dev)
    gen = pf_mod.mspf_stats(gen_trajs, dev)
    return nat, gen


# ---------------------------------------------------------------------------
# PGEN + WGEN (Training.pl:730-759) — label sequence -> waveform
# ---------------------------------------------------------------------------


def synthesize_utterance(state: RecipeState, label_seq: Sequence[str],
                         cfg: RecipeConfig, fs: int,
                         frame_period: float = 5.0, fft_size: int = 0,
                         rho: float = 0.0, durs=None, noise=None,
                         seed: int = 0, device="cuda"):
    """Generate one utterance from the trained voice: durations (pgtype /
    rho) -> MLPG -> GV -> postfilter -> WORLD synthesis.  Returns
    (waveform, statics, vuv, durs): the waveform a float32 tensor, the
    statics float64 tensors and vuv a bool tensor on `device`, durs numpy.
    `noise` (y_length+16,) replaces synthesis's draw from `seed`."""
    gcfg = pgen_mod.GenConfig(
        pgtype=cfg.pgtype, rho=rho, max_dur=cfg.max_dur, n_win=cfg.n_win,
        use_gv=cfg.use_gv and state.gv is not None,
        postfilter_mcp=cfg.postfilter_mcp, alpha=cfg.alpha)
    statics, vuv, durs = pgen_mod.generate_parameters(
        state.clustered, label_seq, gcfg, gv_model=state.gv, durs=durs,
        mspf=state.mspf if cfg.use_mspf else None,
        mspf_weight=cfg.mspf_weight, device=device)
    y = pgen_mod.generate_waveform(statics, vuv, fs, fft_size,
                                   frame_period, noise=noise, seed=seed,
                                   device=device)
    return y, statics, vuv, durs


def state_from_numpy(clustered, gv=None, mspf=None, alignments=None,
                     gv_context_dependent: bool = True, mixture=None,
                     semitied=None) -> RecipeState:
    """A RecipeState from plain parts: `clustered` the dict of
    `ClusteredModel.to_plain`; `gv` {stream: `Tree.to_plain` pair} or
    None; `mspf` ((nat_mean, nat_std), (gen_mean, gen_std)) arrays or
    None; `alignments` {utterance: state end frames}; `mixture` and
    `semitied` the arguments of `hsmm_variants.mixture_from_numpy` and
    `semitied_from_numpy`, or None.  `to_plain` reads attributes only, so
    this carries a voice trained by the JAX package across."""
    g = None
    if gv is not None:
        g = gv_model.GVModel({n: clustering.tree_from_plain(*t)
                              for n, t in gv.items()}, gv_context_dependent)
    m = None
    if mspf is not None:
        m = tuple(pf_mod.MspfStats(np.array(mean, dtype=np.float64),
                                   np.array(std, dtype=np.float64))
                  for mean, std in mspf)
    return RecipeState(
        clustered=context_clustered.clustered_from_plain(clustered),
        alignments=None if alignments is None else {
            int(k): np.array(v) for k, v in alignments.items()},
        gv=g, mspf=m,
        mixture=None if mixture is None else hv.mixture_from_numpy(*mixture),
        semitied=None if semitied is None
        else hv.semitied_from_numpy(*semitied))


def export(state: RecipeState, path: str, fs: int, frame_shift: int,
           cfg: RecipeConfig, alpha: float = 0.0) -> None:
    """CONVM: package the trained voice (+ GV models) as .htsvoice."""
    model = state.clustered
    static_dims = {st.name: (st.sl.stop - st.sl.start) // cfg.n_win
                   for st in model.streams}
    context_clustered.export_voice(
        model, path, fs, frame_shift, static_dims, gv_model=state.gv,
        alpha=alpha or cfg.alpha,
        gv_off_context=tuple(f"*-{p}+*" for p in cfg.silence_phones)
        if cfg.nosilgv else ())
