"""HMGenS-equivalent parameter generation from a clustered HSMM voice —
the reference's PGEN/WGEN stages (Training.pl:730-759, gen_wave
:2813-2947) and HMGenS's three generation algorithms, on the card.

Counterpart of `hts_train_world_tpu/models/pgen.py`:

  pgtype 0  ML generation given the state sequence from the duration
            pdfs (Tokuda et al. 2000 case 1): d_k = round(mu_k +
            rho sigma^2_k) (HMGenS -r), rho solved from a target length
            when given;
  pgtype 1  EM over state sequences (case 2): E-step = HSMM
            forward-backward of the CURRENT windowed trajectory against
            the chain states (K7, K17, K18), M-step = MLPG with
            gamma-mixed precisions (two `torch.matmul`s a stream, then K8);
  pgtype 2  EM over state + space (MSD voicing) sequences (case 3).

Where the work runs: the durations and the tree lookups are host numpy
(each tree walked once per label and state, `context_clustered.
_chain_arrays`); the per-state tables go to `device` once and are
expanded to frames there by a `repeat_interleave` gather.  Everything
before the vocoder is float64: MLPG (K8's float64 instantiation, all
streams of an utterance in one launch), GV scaling (K23), the
modulation-spectrum postfilter (K21) or the mel-cepstral postfilter
(K22).  WGEN casts the statics to float32 and runs the synth CLI's
decode (K12) and fast-mode WORLD synthesis (K9-K11), as `cli synth
--f32` does; its noise comes from a seeded `torch.Generator` unless
given.  `engine="sptk"` is the reference's excite | mglsadf branch in
float64: mixed excitation (K35, K36) through the MGLSA filter (K37).

Entry points take `device="cuda"` (the default; raises without a card) or
`device="cpu"`, where every kernel runs as its plain twin.  Statics come
back as float64 tensors on the device, V/UV as a bool tensor, durations
as numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hts_train_world_tpu_torch import config as wcfg
from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.features import decode, filters
from hts_train_world_tpu_torch.features import windows as win_mod
from hts_train_world_tpu_torch.models import context_clustered as cc
from hts_train_world_tpu_torch.models import hsmm
from hts_train_world_tpu_torch.ops import excitation as ex_mod
from hts_train_world_tpu_torch.ops import gv as gv_mod
from hts_train_world_tpu_torch.ops import mlpg as mlpg_mod
from hts_train_world_tpu_torch.ops import postfilter as pf_mod
from hts_train_world_tpu_torch.ops import prims
from hts_train_world_tpu_torch.ops import synthesis as syn
from hts_train_world_tpu_torch.parallel import batch as batch_mod

MAGIC = -1.0e10


# ---------------------------------------------------------------------------
# durations (HMGenS -r / -m)
# ---------------------------------------------------------------------------


def state_durations(model: cc.ClusteredModel, label_seq: Sequence[str],
                    rho: float = 0.0) -> np.ndarray:
    """(K,) integer state durations d_k = round(mu_k + rho*sigma^2_k)
    (np.round: half to even), floored at 1 — HMGenS's duration decision."""
    out = []
    for ctx in label_seq:
        dm, dv = model.durations(ctx)
        out.append(np.maximum(1, np.round(dm + rho * dv)).astype(int))
    return np.concatenate(out)


def rho_for_total(model: cc.ClusteredModel, label_seq: Sequence[str],
                  total_frames: int) -> float:
    """Solve rho so sum(mu_k + rho*sigma^2_k) == total_frames (HMGenS's
    total-length constraint when an utterance length is imposed)."""
    mu = 0.0
    v = 0.0
    for ctx in label_seq:
        dm, dv = model.durations(ctx)
        mu += float(dm.sum())
        v += float(dv.sum())
    return (total_frames - mu) / max(v, 1e-8)


# ---------------------------------------------------------------------------
# chain-state tables and their frame expansion
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChainTables:
    """The chain's per-state pdfs on the device: per stream (K, w*D)
    means/vars and (K,) MSD weights (1 for a non-MSD stream), duration
    (K,) mean/var, all float64."""
    means: Dict[str, torch.Tensor]
    vars: Dict[str, torch.Tensor]
    msd_w: Dict[str, torch.Tensor]
    dur_mean: torch.Tensor
    dur_var: torch.Tensor


def chain_tables(model: cc.ClusteredModel, label_seq: Sequence[str],
                 device="cuda") -> ChainTables:
    """Each tree walked once per (label, state) on the host, the stacked
    tables uploaded once."""
    dev = device_mod.resolve(device)
    means, vars_, msd_w, _, _, dmean, dvar = cc._chain_arrays(model,
                                                              label_seq)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    return ChainTables({n: t(v) for n, v in means.items()},
                       {n: t(v) for n, v in vars_.items()},
                       {n: t(v) for n, v in msd_w.items()}, t(dmean),
                       t(dvar))


@dataclasses.dataclass
class FrameParams:
    """Frame-level generation inputs: per stream (T, w*D) mean/var in the
    cmp column layout, the frame V/UV decision and the state spans."""
    means: Dict[str, torch.Tensor]
    vars: Dict[str, torch.Tensor]
    vuv: torch.Tensor          # (T,) bool
    durs: np.ndarray           # (K,)
    frame_state: torch.Tensor  # (T,) chain-state index


def frame_params(model: cc.ClusteredModel, label_seq: Sequence[str],
                 durs: np.ndarray, device="cuda",
                 chain: Optional[ChainTables] = None) -> FrameParams:
    """Expand chain-state pdfs to frames under explicit state durations
    (HMGenS with -m model alignment, or pgtype-0 durations): one
    `repeat_interleave` of the state indices, one gather per table.
    V/UV is the lf0 stream's per-state MSD weight > 0.5."""
    ch = chain if chain is not None else chain_tables(model, label_seq,
                                                      device)
    dev = ch.dur_mean.device
    durs = np.asarray(durs)
    fs_ = torch.repeat_interleave(
        torch.arange(len(durs), device=dev),
        torch.as_tensor(durs, dtype=torch.long, device=dev),
        output_size=int(durs.sum()))
    names = [st.name for st in model.streams]
    if "lf0" in names:
        vuv = (ch.msd_w["lf0"] > 0.5)[fs_]
    else:
        vuv = torch.ones(fs_.shape, dtype=torch.bool, device=dev)
    return FrameParams({n: ch.means[n][fs_] for n in names},
                       {n: ch.vars[n][fs_] for n in names}, vuv, durs, fs_)


# ---------------------------------------------------------------------------
# per-stream MLPG (K8, float64)
# ---------------------------------------------------------------------------


def _mlpg_msd(means, vars_, vuv, streams, n_win: int, windows):
    """MLPG of every stream in one K8 launch (the solve is independent per
    dimension): means/vars {name: (T, n_win*D)}.  MSD streams: unvoiced
    frames get their variances x1e8 (near-zero precision: the solution
    interpolates through unvoiced gaps) and are set to MAGIC after."""
    wins = tuple(tuple(w) for w in windows[:n_win])
    T = vuv.shape[0]
    uv = ~vuv
    mus, vs, dims = [], [], []
    for st in streams:
        D = means[st.name].shape[1] // n_win
        mu = means[st.name].reshape(T, n_win, D)
        va = vars_[st.name].reshape(T, n_win, D)
        if st.msd:
            va = torch.where(uv[:, None, None], va * 1e8, va)
        mus.append(mu)
        vs.append(va)
        dims.append(D)
    statics = mlpg_mod.mlpg(torch.cat(mus, -1), torch.cat(vs, -1), wins)
    out = {}
    for st, part in zip(streams, torch.split(statics, dims, dim=-1)):
        if st.msd:
            part = torch.where(vuv[:, None], part,
                               torch.full_like(part, MAGIC))
        out[st.name] = part
    return out


def mlpg_streams(fp: FrameParams, streams, n_win: int = 3,
                 windows=mlpg_mod.DEFAULT_WINDOWS) -> Dict[str, torch.Tensor]:
    """Run MLPG per stream -> statics {name: (T, D)} (float64 tensors)."""
    return _mlpg_msd(fp.means, fp.vars, fp.vuv, streams, n_win, windows)


# ---------------------------------------------------------------------------
# EM generation (pgtype 1 / 2)
# ---------------------------------------------------------------------------


def _windowed_obs(statics: Dict[str, torch.Tensor], streams, vuv,
                  n_win: int = 3):
    """The cmp-layout windowed observation of the current trajectory: per
    stream the statics expanded by the delta windows (K7, float64); MSD
    streams zero their unvoiced frames (flag column semantics)."""
    parts = []
    for st in streams:
        x = statics[st.name]
        x = torch.where(x == MAGIC, torch.zeros_like(x), x)
        w = win_mod.expand(x, win_mod.DEFAULT_WINDOWS[:n_win])
        if st.msd:
            w = torch.where(vuv[:, None], w, torch.zeros_like(w))
        parts.append(w)
    return torch.cat(parts, dim=1)


def generate_em(model: cc.ClusteredModel, label_seq: Sequence[str],
                durs: Optional[np.ndarray] = None, n_iters: int = 3,
                max_dur: int = 60, n_win: int = 3, pgtype: int = 1,
                windows=mlpg_mod.DEFAULT_WINDOWS, device="cuda"):
    """pgtype 1/2 generation (Tokuda et al. 2000 cases 2-3; HMGenS -c 1/2).

    Start from the pgtype-0 trajectory, then iterate
      E: gamma = HSMM forward-backward of the current windowed trajectory
         against the composed chain (K7, K17, K18);
      M: per-frame mixed precision P_t = sum_k gamma_tk / var_k and
         mean-precision b_t = sum_k gamma_tk mu_k / var_k -> MLPG on
         (b/P, 1/P) (K8).
    pgtype 2 also re-estimates the voicing each iteration:
    vuv_t = sum_k gamma_tk w_k > 0.5.

    Returns (statics, vuv, gamma, log_evidence_history); the history is
    read to the host once an iteration."""
    dev = device_mod.resolve(device)
    if durs is None:
        durs = state_durations(model, label_seq)
    ch = chain_tables(model, label_seq, dev)
    fp = frame_params(model, label_seq, durs, dev, chain=ch)
    statics = mlpg_streams(fp, model.streams, n_win, windows)
    vuv = fp.vuv.clone()
    names = [st.name for st in model.streams]
    sls = []
    off = 0
    for st in model.streams:
        w = st.sl.stop - st.sl.start
        sls.append((off, off + w))
        off += w
    sls = tuple(sls)
    flags = tuple(st.msd for st in model.streams)
    wts = tuple(st.weight for st in model.streams)
    means_t = tuple(ch.means[n] for n in names)
    vars_t = tuple(ch.vars[n] for n in names)
    msd_t = tuple(ch.msd_w[n] for n in names)

    history = []
    gamma = None
    for _ in range(n_iters):
        obs = _windowed_obs(statics, model.streams, vuv, n_win)
        obs_ll = hsmm.frame_loglik(obs, means_t, vars_t, msd_t, sls, flags,
                                   wts)
        ll, gamma, _ = hsmm.forward_backward_segment(
            obs_ll, ch.dur_mean, ch.dur_var, max_dur)
        history.append(float(ll))
        gamma = torch.clamp(gamma, min=0.0)
        gsum = torch.clamp(gamma.sum(dim=1, keepdim=True), min=1e-12)
        gamma = gamma / gsum                              # (T, K)
        if pgtype >= 2 and "lf0" in names:
            vuv = gamma @ ch.msd_w["lf0"] > 0.5
        mean_eff, var_eff = {}, {}
        for n in names:
            mu, va = ch.means[n], ch.vars[n]              # (K, wD)
            prec = gamma @ prims.rdiv(1.0, va)            # (T, wD)
            mp = gamma @ (mu / va)
            var_eff[n] = prims.rdiv(1.0, torch.clamp(prec, min=1e-12))
            mean_eff[n] = mp * var_eff[n]
        statics = _mlpg_msd(mean_eff, var_eff, vuv, model.streams, n_win,
                            windows)
    return statics, vuv, gamma, history


# ---------------------------------------------------------------------------
# full PGEN: durations -> MLPG -> GV -> postfilter
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GenConfig:
    pgtype: int = 0
    rho: float = 0.0
    em_iters: int = 3
    max_dur: int = 60
    n_win: int = 3
    use_gv: bool = False
    gv_weight: float = 1.0
    gv_streams: Sequence[str] = ("mgc", "lf0")
    postfilter_mcp: float = 0.0     # mcep postfilter strength (ref 1.4)
    alpha: float = 0.42
    fft_size: int = 1024


def parameter_stages(model: cc.ClusteredModel, label_seq: Sequence[str],
                     cfg: GenConfig = GenConfig(), gv_model=None,
                     durs: Optional[np.ndarray] = None, mspf=None,
                     mspf_weight: float = 1.0, device="cuda"):
    """PGEN one stage at a time, yielding (stage name, result):
    "durations" (numpy, host), "frames" (the FrameParams: host tree
    lookups, upload and the frame gather; absent for pgtype >= 1),
    "mlpg" or "em" ((statics, vuv)), "gv" (statics), "postfilter"
    ((statics, vuv, durs)); the stages that do not apply yield their
    input unchanged."""
    dev = device_mod.resolve(device)
    if durs is None:
        durs = state_durations(model, label_seq, cfg.rho)
    yield "durations", durs
    if cfg.pgtype == 0:
        fp = frame_params(model, label_seq, durs, dev)
        yield "frames", fp
        statics = mlpg_streams(fp, model.streams, cfg.n_win)
        vuv = fp.vuv
        yield "mlpg", (statics, vuv)
    else:
        statics, vuv, _, _ = generate_em(
            model, label_seq, durs, cfg.em_iters, cfg.max_dur, cfg.n_win,
            cfg.pgtype, device=dev)
        yield "em", (statics, vuv)

    if cfg.use_gv and gv_model is not None:
        ctx0 = label_seq[0]   # make_data_gv labels GV by the first label
        for name in cfg.gv_streams:
            if name not in gv_model.trees or name not in statics:
                continue
            gmean, _ = gv_model.params(name, ctx0)
            x = statics[name]
            mask = vuv & (x[:, 0] != MAGIC) if name == "lf0" else None
            statics[name] = gv_mod.gv_scale(x, gmean, cfg.gv_weight, mask)
    yield "gv", statics

    if mspf is not None and "mgc" in statics:
        nat, gen = mspf
        statics["mgc"] = pf_mod.apply_mspf(statics["mgc"], nat, gen,
                                           mspf_weight)
    elif cfg.postfilter_mcp > 0 and "mgc" in statics:
        statics["mgc"] = pf_mod.mcep_postfilter(
            statics["mgc"], cfg.alpha, cfg.postfilter_mcp, cfg.fft_size)
    yield "postfilter", (statics, vuv, durs)


def generate_parameters(model: cc.ClusteredModel, label_seq: Sequence[str],
                        cfg: GenConfig = GenConfig(), gv_model=None,
                        durs: Optional[np.ndarray] = None,
                        mspf=None, mspf_weight: float = 1.0, device="cuda"):
    """The PGEN stage for one utterance: (statics per stream, vuv, durs).

    gv_model: models/gv_model.GVModel (applied via ops.gv.gv_scale to
    cfg.gv_streams; lf0 GV runs over voiced, non-MAGIC frames only).
    mspf: an (nat, gen) pair of ops/postfilter.MspfStats for the
    modulation-spectrum postfilter on mgc (Training.pl:2950-3000); it takes
    precedence over cfg.postfilter_mcp."""
    *_, (_, out) = parameter_stages(model, label_seq, cfg, gv_model, durs,
                                    mspf, mspf_weight, device)
    return out


def _f64(a, dev):
    return torch.as_tensor(a, dtype=torch.float64, device=dev)


def _sptk_stages(statics, vuv, fs: int, fft_size: int, frame_period: float,
                 alpha: float, noise, seed: int, dev):
    """The excite | mglsadf branch: "excitation" (the mixed excitation,
    K35 + K36) and "filter" (the MGLSA filter, K37), float64."""
    lf0 = _f64(statics["lf0"], dev)[:, 0]
    vuv = torch.as_tensor(vuv, dtype=torch.bool, device=dev)
    lf0_m = torch.where(vuv & (lf0 != MAGIC), lf0, torch.full_like(lf0,
                                                                   MAGIC))
    shift = int(fs * frame_period / 1000.0)
    N = fft_size or wcfg.cheaptrick_fft_size(fs)
    low, high = filters.band_split_filters(fs)
    gen = None
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
    exc, _ = ex_mod.mixed_excitation(lf0_m, shift, low, high, noise, gen,
                                     sr=fs)
    yield "excitation", exc
    yield "filter", ex_mod.mglsa_synthesis(exc, _f64(statics["mgc"], dev),
                                           alpha, shift, N)


def waveform_stages(statics, vuv, fs: int, fft_size: int = 0,
                    frame_period: float = 5.0, engine: str = "world",
                    alpha: float = 0.42, noise=None, seed: int = 0,
                    device="cuda"):
    """WGEN one stage at a time, yielding (stage name, result).
    engine="world": "decode" (f0, sp, ap of the float32 features, K12),
    "count" (the pulse bucket, one host read) and "synthesis" (the
    waveform (y_length,), float32).  engine="sptk": "excitation" and
    "filter" (the waveform ((T-1)*shift,), float64)."""
    if engine not in ("world", "sptk"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = device_mod.resolve(device)
    if engine == "sptk":
        yield from _sptk_stages(statics, vuv, fs, fft_size, frame_period,
                                alpha, noise, seed, dev)
        return
    lf0 = _f64(statics["lf0"], dev)
    vuv = torch.as_tensor(vuv, dtype=torch.bool, device=dev)
    lf0_1 = torch.where((lf0[:, 0] == MAGIC) | ~vuv, torch.zeros_like(
        lf0[:, 0]), lf0[:, 0])
    N = fft_size or wcfg.cheaptrick_fft_size(fs)
    f0, sp, ap = decode.decode_features(
        lf0_1.float()[None], _f64(statics["mgc"], dev).float()[None],
        _f64(statics["bap"], dev).float()[None], fs, N)
    yield "decode", (f0, sp, ap)
    yl = wcfg.y_length_for(f0.shape[1], frame_period, fs)
    ncs = syn.count_pulses(f0, frame_period, fs, yl, N)
    bucket = batch_mod._pulse_bucket(int(ncs.max().item()) + 8,
                                     syn.default_max_pulses(yl, fs))
    yield "count", bucket
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        stream = batch_mod.synthesis_noise_batch(gen, 1, yl, sp.dtype)
    else:
        stream = torch.as_tensor(noise, dtype=sp.dtype,
                                 device=dev).reshape(1, -1)
    yield "synthesis", syn.synthesis(f0, sp, ap, N, frame_period, fs, yl,
                                     stream, bucket)[0]


def generate_waveform(statics: Dict, vuv, fs: int, fft_size: int = 0,
                      frame_period: float = 5.0, engine: str = "world",
                      alpha: float = 0.42, noise=None, seed: int = 0,
                      device="cuda"):
    """WGEN for one utterance.  engine="world": the statics (lf0 zeroed
    where MAGIC or unvoiced) cast to float32, decoded as the synth CLI
    decodes (K12) and synthesised by WORLD's fast mode (K9-K11) ->
    waveform (y_length,) float32 on `device`; `noise` (y_length+16,)
    replaces the draw from `seed`.  engine="sptk": the excite | mglsadf
    branch (Training.pl:2873-2899) in float64 at warping `alpha` ->
    waveform ((T-1)*shift,) float64; `noise` is the pair (n0, n1) of (n,)
    draws that `ops.excitation.mixed_excitation` takes."""
    *_, (_, y) = waveform_stages(statics, vuv, fs, fft_size, frame_period,
                                 engine, alpha, noise, seed, device)
    return y
