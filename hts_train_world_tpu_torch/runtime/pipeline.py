"""Corpus pipeline orchestrator: the port's counterpart of
`hts_train_world_tpu/runtime/pipeline.py` (the Training.pl equivalent for
the DNN singing-synthesis path, SURVEY.md T3-T7, §3.4), restartable per
stage.

Stages (each idempotent, tracked by the StageManifest):
  ANALYZE  raw audio -> f0/sp/ap -> lf0(2)/mgc(50)/bap(25)/vib(2)
           (data/Makefile.in `features` + Extract.py): the native loader,
           `bucketed_extract` on the device, LOWESS and the vibrato scan on
           the host, raw float32 files
  COMPOSE  delta windows -> cmp (HTK) + ffo targets (`cmp`/`ffo` targets)
  STATS    ffo.var / stream vars / gv.var (`stats`)
  HALGN    the HSMM recipe on the cmp corpus -> labels/align state-level +
           labels/fal phone-level alignments + the duration model
           (FALGN + convert_state2phone, Training.pl:601-618, 1604-1635)
  MKDAT    aligned labels + question config -> ffi inputs (makefeature.pl)
  TRDNN    frame-mode acoustic training with checkpoints (DNNTraining.py)
  TRJGV    trajectory fine-tuning with the GV term (K28/K29), warm-started
           from the frame checkpoint, Adam moments and step included
           (Training.pl:930-940)
  MSPFD    modulation-spectrum postfilter statistics from aligned DNN
           generations (MSPF1 dnn branch, Training.pl:842-882; K8, K21)
  PGEN     forward + MLPG generation (K8 in float64) + the MSPF (K21) or
           mcep (K22) postfilter (gen_param)
  WGEN     decode (K12) and WORLD synthesis (K9, K10, K30, K11) -> wav

synthesize_unseen() is PGEND/WGEND (Training.pl:885-928): durations from
the HALGN duration model -> convert_dur2lab -> DNN -> MLPG -> WORLD.

Every stage runs on `PipelineConfig.device` (the card by default).
`stage_seconds` keeps each stage's wall seconds and ANALYZE's parts
(loader, extract, vibrato, writes); `halgn_seconds` keeps `train_voice`'s
own stage seconds.  Analysis and synthesis run in fast mode (float32)
by default.  `parity=True` runs them as the JAX pipeline does at parity:
ANALYZE analyses and encodes each utterance in float64 on the reference's
noise streams (`vocoder.analyze(parity=True)`, K6 in float64), and WGEN
decodes in float64 (K12) and synthesises by `vocoder.synthesize(parity=
True)`.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import pickle
import shutil
import time
from typing import List, Optional

import numpy as np
import torch

from hts_train_world_tpu_torch import config as cfg_mod
from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch import vocoder
from hts_train_world_tpu_torch.features import compose, decode, encode, htk
from hts_train_world_tpu_torch.features import labels as labels_mod
from hts_train_world_tpu_torch.features import qconf as qconf_mod
from hts_train_world_tpu_torch.features import vibrato
from hts_train_world_tpu_torch.io import loader as nloader
from hts_train_world_tpu_torch.io import rawio, wavio
from hts_train_world_tpu_torch.models import acoustic, dataio, training
from hts_train_world_tpu_torch.ops import generation, postfilter
from hts_train_world_tpu_torch.parallel import bucketing
from hts_train_world_tpu_torch.parallel import features as feat_mod
from hts_train_world_tpu_torch.runtime.checkpoint import (Checkpointer,
                                                          StageManifest)

STAGES = ["ANALYZE", "COMPOSE", "STATS", "HALGN", "MKDAT", "TRDNN",
          "TRJGV", "MSPFD", "PGEN", "WGEN"]


@dataclasses.dataclass
class PipelineConfig:
    workdir: str
    fs: int = 48000
    frame_period: float = 5.0
    layout: compose.StreamLayout = dataclasses.field(
        default_factory=compose.StreamLayout)
    parity: bool = False                 # exact reference noise streams
    model: acoustic.ModelConfig = None   # filled at MKDAT (n_in known)
    train: training.TrainConfig = dataclasses.field(
        default_factory=training.TrainConfig)
    postfilter_mcp: float = 0.0          # 0 = off; reference default 1.4
    alpha: float = 0.0                   # 0 -> freqwarp_for_fs(fs)
    # HALGN (HSMM alignment + duration model)
    use_hmm_align: bool = False
    hmm: object = None                   # models/recipe.RecipeConfig
    # TRJGV
    trajectory_steps: int = 0            # extra trajectory-mode steps
    # MSPF postfilter ($useMSPF)
    use_mspf: bool = False
    mspf_weight: float = 1.0
    device: str = "cuda"                 # where every stage runs


class SingingPipeline:
    def __init__(self, pcfg: PipelineConfig):
        self.cfg = pcfg
        self.dev = device_mod.resolve(pcfg.device)
        self.wd = os.path.abspath(pcfg.workdir)
        self.manifest = StageManifest(self.wd)
        self.fft_size = cfg_mod.cheaptrick_fft_size(pcfg.fs)
        self.stage_seconds: dict = {}
        self.halgn_seconds: dict = {}
        for d in ("lf0", "mgc", "bap", "vib", "cmp", "ffo", "ffi", "stats",
                  "model", "gen"):
            os.makedirs(os.path.join(self.wd, d), exist_ok=True)

    # -- corpus discovery --
    def utterances(self) -> List[str]:
        wavs = sorted(glob.glob(os.path.join(self.wd, "raw", "*.wav")))
        return [os.path.splitext(os.path.basename(w))[0] for w in wavs]

    def _p(self, sub: str, base: str, ext: str) -> str:
        return os.path.join(self.wd, sub, f"{base}.{ext}")

    def _lap(self, key: str, t0: float) -> float:
        t = time.perf_counter()
        self.stage_seconds[key] = self.stage_seconds.get(key, 0.0) + t - t0
        return t

    # -- stages --
    def analyze(self) -> None:
        if self.manifest.done("ANALYZE"):
            return
        t_stage = t = time.perf_counter()
        lay = self.cfg.layout
        bases = self.utterances()
        paths = [os.path.join(self.wd, "raw", f"{b}.wav") for b in bases]
        sigs: list = [None] * len(bases)
        if self.cfg.parity:
            # float64 samples, as the JAX pipeline's wavread gives them
            for i, path in enumerate(paths):
                sigs[i], sr = wavio.wavread(path)
                if sr != self.cfg.fs:
                    raise ValueError(f"{bases[i]}: fs {sr} != {self.cfg.fs}")
        else:
            with nloader.CorpusLoader(paths, nloader.WAV) as dl:
                for i, x, sr in dl:
                    if x is None:
                        raise ValueError(f"{bases[i]}: unreadable wav")
                    if sr != self.cfg.fs:
                        raise ValueError(
                            f"{bases[i]}: fs {sr} != {self.cfg.fs}")
                    sigs[i] = x
        t = self._lap("ANALYZE loader", t)
        if len(bases) > 1 and not self.cfg.parity:
            # the corpus path: length-bucketed batched analysis and the
            # encode on the device; only the features come back
            feats = bucketing.bucketed_extract(
                sigs, self.cfg.fs, self.cfg.frame_period,
                mgc_dim=lay.mgc_dim, bap_dim=lay.bap_dim, device=self.dev)
        else:
            feats = []
            # one utterance, or parity: analysed and encoded one by one
            # (the JAX pipeline's per-utterance route)
            for x in sigs:
                a = vocoder.analyze(x, self.cfg.fs, self.cfg.frame_period,
                                    parity=self.cfg.parity, device=self.dev)
                feats.append(tuple(v.cpu().numpy() for v in
                                   encode.encode_features(
                                       a.f0, a.spectrogram, a.aperiodicity,
                                       a.fs, a.fft_size, lay.mgc_dim,
                                       lay.bap_dim)))
        t = self._lap("ANALYZE extract", t)
        for base, (lf0_1d, mgc, bap) in zip(bases, feats):
            mono = os.path.join(self.wd, "labels", "mono", f"{base}.lab")
            full = os.path.join(self.wd, "labels", "full", f"{base}.lab")
            if os.path.exists(full) and not os.path.exists(mono):
                labels_mod.make_mono_from_full(full, mono)
            labs = (labels_mod.load_labels(mono, full)
                    if os.path.exists(full) else [])
            t = self._lap("ANALYZE writes", t)
            lf0_2d, vib = vibrato.extract(np.asarray(lf0_1d), labs,
                                          self.cfg.frame_period)
            t = self._lap("ANALYZE vibrato", t)
            rawio.write_f32(self._p("lf0", base, "lf0"), lf0_2d)
            rawio.write_f32(self._p("mgc", base, "mgc"), np.asarray(mgc))
            rawio.write_f32(self._p("bap", base, "bap"), np.asarray(bap))
            rawio.write_f32(self._p("vib", base, "vib"), vib)
            t = self._lap("ANALYZE writes", t)
        self.manifest.mark("ANALYZE", n=len(bases))
        self._lap("ANALYZE", t_stage)

    def _streams(self, base: str):
        lay = self.cfg.layout
        return (rawio.read_f32(self._p("mgc", base, "mgc"), lay.mgc_dim),
                rawio.read_f32(self._p("lf0", base, "lf0"), lay.lf0_dim),
                rawio.read_f32(self._p("bap", base, "bap"), lay.bap_dim),
                rawio.read_f32(self._p("vib", base, "vib"), lay.vib_dim))

    def compose_stage(self) -> None:
        if self.manifest.done("COMPOSE"):
            return
        t0 = time.perf_counter()
        lay = self.cfg.layout
        shift = int(self.cfg.frame_period / 1000.0 * self.cfg.fs)
        for base in self.utterances():
            streams = self._streams(base)
            cmp_ = compose.compose_cmp(*streams, lay, device=self.dev)
            htk.write_htk(self._p("cmp", base, "cmp"), cmp_, self.cfg.fs,
                          shift)
            ffo = compose.compose_ffo(*streams, lay, device=self.dev)
            rawio.write_f32(self._p("ffo", base, "ffo"), ffo)
        self.manifest.mark("COMPOSE")
        self._lap("COMPOSE", t0)

    def stats(self) -> None:
        if self.manifest.done("STATS"):
            return
        t0 = time.perf_counter()
        lay = self.cfg.layout
        ffos = [rawio.read_f32(self._p("ffo", b, "ffo"), lay.ffo_dim)
                for b in self.utterances()]
        var = compose.ffo_variance(ffos)
        rawio.write_f32(os.path.join(self.wd, "stats", "ffo.var"), var)
        for name, v in compose.stream_variances(var, lay).items():
            rawio.write_f32(os.path.join(self.wd, "stats",
                                         f"{name}.var"), v)
        rawio.write_f32(os.path.join(self.wd, "stats", "gv.var"),
                        compose.gv_variance(ffos, lay))
        self.manifest.mark("STATS")
        self._lap("STATS", t0)

    def mkdat(self) -> None:
        if self.manifest.done("MKDAT"):
            return
        t0 = time.perf_counter()
        conf = open(os.path.join(self.wd, "qconf.conf")).read()
        feats = qconf_mod.parse_config(conf)
        shift_100ns = int(self.cfg.frame_period * 1e4)
        for base in self.utterances():
            lab = os.path.join(self.wd, "labels", "align", f"{base}.lab")
            if not os.path.exists(lab):
                lab = os.path.join(self.wd, "labels", "full", f"{base}.lab")
            labs = qconf_mod.parse_aligned_labels(open(lab).read(),
                                                  shift_100ns)
            ffi = qconf_mod.encode_labels(feats, labs)
            rawio.write_f32(self._p("ffi", base, "ffi"), ffi)
        self.manifest.mark("MKDAT", n_in=len(feats))
        self._lap("MKDAT", t0)

    # -- HALGN: HSMM alignment + duration model ------------------------
    def _read_cmp(self, base: str) -> np.ndarray:
        return compose.compose_cmp(*self._streams(base), self.cfg.layout,
                                   device=self.dev).astype(np.float64)

    def _full_label(self, base: str):
        """(ctx_seq, phone end frames) from labels/full (100 ns times)."""
        path = os.path.join(self.wd, "labels", "full", f"{base}.lab")
        if not os.path.exists(path):
            return None, None
        shift_100ns = int(self.cfg.frame_period * 1e4)
        ctx, ends = [], []
        for ln in open(path).read().splitlines():
            parts = ln.split()
            if len(parts) >= 3:
                ctx.append(parts[2])
                ends.append(int(round(int(parts[1]) / shift_100ns)))
        return ctx, np.asarray(ends)

    def halgn(self) -> None:
        if self.manifest.done("HALGN"):
            return
        if not self.cfg.use_hmm_align:
            self.manifest.mark("HALGN", skipped=True)
            return
        from hts_train_world_tpu_torch.models import clustering, hsmm
        from hts_train_world_tpu_torch.models import recipe as recipe_mod
        t0 = time.perf_counter()
        lay = self.cfg.layout
        shift_100ns = int(self.cfg.frame_period * 1e4)
        qs = clustering.questions_from_config(qconf_mod.parse_config(
            open(os.path.join(self.wd, "qconf.conf")).read()))
        corpus, spans, bases = [], {}, []
        for base in self.utterances():
            ctx_seq, ends = self._full_label(base)
            if ctx_seq is None:
                continue
            frames = self._read_cmp(base)
            spans[len(corpus)] = np.minimum(ends, len(frames))
            corpus.append((frames, ctx_seq))
            bases.append(base)
        rcfg = self.cfg.hmm or recipe_mod.RecipeConfig(
            n_states=5, n_iters=2, tied_iters=1, recluster=False,
            use_gv=False, use_mspf=False)
        st = recipe_mod.train_voice(corpus, qs, rcfg,
                                    streams=hsmm.world_streams(lay),
                                    bootstrap_spans=spans,
                                    log=lambda m: None, device=self.dev)
        self.halgn_seconds = dict(st.stage_seconds)
        os.makedirs(os.path.join(self.wd, "labels", "align"), exist_ok=True)
        os.makedirs(os.path.join(self.wd, "labels", "fal"), exist_ok=True)
        S = rcfg.n_states
        for i, base in enumerate(bases):
            ends = st.alignments.get(i)
            if ends is None:
                continue
            ctx_seq = corpus[i][1]
            with open(os.path.join(self.wd, "labels", "align",
                                   f"{base}.lab"), "w") as f:
                f.write(labels_mod.state_alignment_lines(
                    ctx_seq, ends, S, shift_100ns))
            with open(os.path.join(self.wd, "labels", "fal",
                                   f"{base}.lab"), "w") as f:
                f.write(labels_mod.phone_alignment_lines(
                    ctx_seq, ends, S, shift_100ns))
        # plain values only (numpy and tuples), no torch objects
        with open(os.path.join(self.wd, "model", "hmm.pkl"), "wb") as f:
            pickle.dump({"clustered": st.clustered.to_plain(), "cfg": rcfg},
                        f)
        self.manifest.mark("HALGN", n=len(bases))
        self._lap("HALGN", t0)

    def _load_hmm(self):
        with open(os.path.join(self.wd, "model", "hmm.pkl"), "rb") as f:
            return pickle.load(f)

    # -- TRDNN: frame-mode training ---------------------------------------
    def _pairs(self) -> List[dataio.UtterancePair]:
        lay = self.cfg.layout
        n_in = self._model_cfg().n_in
        return [dataio.load_pair(b, self._p("ffi", b, "ffi"),
                                 self._p("ffo", b, "ffo"), n_in,
                                 lay.ffo_dim) for b in self.utterances()]

    def _model_cfg(self) -> acoustic.ModelConfig:
        if self.cfg.model is not None:
            return self.cfg.model
        conf = open(os.path.join(self.wd, "qconf.conf")).read()
        n_in = len(qconf_mod.parse_config(conf))
        self.cfg.model = acoustic.ModelConfig(
            n_in=n_in, n_out=self.cfg.layout.ffo_dim)
        return self.cfg.model

    def train_dnn(self) -> None:
        if self.manifest.done("TRDNN"):
            return
        t0 = time.perf_counter()
        training.train(self._model_cfg(), self.cfg.train, self._pairs(),
                       os.path.join(self.wd, "model"), device=self.dev)
        self.manifest.mark("TRDNN", steps=self.cfg.train.num_steps)
        self._lap("TRDNN", t0)

    # -- TRJGV: trajectory fine-tuning with the GV term -----------------
    def _traj_meta(self):
        lay = self.cfg.layout
        feature_dims = (lay.mgc_dim, lay.lf0_dim, lay.bap_dim, lay.vib_dim)
        msd_flags = (0, 1, 0, 0)   # ffo carries one lf0 flag (compose.py)
        gv = rawio.read_f32(os.path.join(self.wd, "stats", "gv.var"))
        # gv.var covers [mgc | lf0 | bap] (data/Makefile.in:441-456);
        # vib gets unit variance
        gv_var = np.concatenate([gv, np.ones(lay.vib_dim)])
        return feature_dims, msd_flags, np.maximum(gv_var, 1e-8)

    def trjgv(self) -> None:
        if self.manifest.done("TRJGV"):
            return
        if self.cfg.trajectory_steps <= 0:
            self.manifest.mark("TRJGV", skipped=True)
            return
        t0 = time.perf_counter()
        # warm start: copy the frame-mode checkpoints (Training.pl:936-938)
        src = os.path.join(self.wd, "model")
        dst = os.path.join(self.wd, "model_trj")
        if not os.path.isdir(dst):
            shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
                "hmm.pkl"))
        feature_dims, msd_flags, gv_var = self._traj_meta()
        tcfg = dataclasses.replace(
            self.cfg.train, trajectory=True,
            num_steps=self.cfg.train.num_steps + self.cfg.trajectory_steps,
            batch_size=1)
        training.train(self._model_cfg(), tcfg, self._pairs(), dst,
                       feature_dims=feature_dims, msd_flags=msd_flags,
                       gv_variances=gv_var, device=self.dev)
        self.manifest.mark("TRJGV", steps=self.cfg.trajectory_steps)
        self._lap("TRJGV", t0)

    def _params_dir(self) -> str:
        trj = os.path.join(self.wd, "model_trj")
        return trj if os.path.isdir(trj) else os.path.join(self.wd,
                                                           "model")

    def _restore_params(self, ckpt_dir: Optional[str] = None
                        ) -> acoustic.AcousticModel:
        """The latest checkpoint's model (TRJGV's when it ran) on the
        pipeline's device."""
        restored = Checkpointer(ckpt_dir or self._params_dir()).restore(
            map_location=self.dev)
        if restored is None:
            raise RuntimeError("no trained checkpoint")
        return acoustic.from_state_dict(self._model_cfg(), restored["params"])

    # -- parameter generation ------------------------------------------
    def _alpha(self) -> float:
        return self.cfg.alpha or cfg_mod.freqwarp_for_fs(self.cfg.fs)

    def _gen_one(self, ffi, params, var, alpha, mspf):
        """forward -> MLPG -> postfilter for one utterance's inputs."""
        ffo = training.forward_corpus(params, ffi)
        g = generation.generate_parameters(ffo, var, self.cfg.layout)
        mgc = g.mgc
        if mspf is not None:
            nat, gen = mspf
            mgc = postfilter.apply_mspf(mgc, nat, gen,
                                        self.cfg.mspf_weight)
        elif self.cfg.postfilter_mcp > 0:
            mgc = postfilter.mcep_postfilter(
                mgc, alpha, self.cfg.postfilter_mcp, self.fft_size)
        return mgc, g

    def _load_mspf(self):
        path = os.path.join(self.wd, "stats", "mspf.npz")
        if not os.path.exists(path):
            return None
        z = np.load(path)
        return (postfilter.MspfStats(z["nat_mean"], z["nat_std"]),
                postfilter.MspfStats(z["gen_mean"], z["gen_std"]))

    def _ffo_var(self) -> torch.Tensor:
        return torch.as_tensor(rawio.read_f32(os.path.join(
            self.wd, "stats", "ffo.var")), dtype=torch.float64,
            device=self.dev)

    def mspfd(self) -> None:
        """MSPF statistics for the DNN path (Training.pl:842-882): the
        natural mgc statics vs generations from the ALIGNED training
        inputs (the tdn scp is the aligned ffi set)."""
        if self.manifest.done("MSPFD"):
            return
        if not self.cfg.use_mspf:
            self.manifest.mark("MSPFD", skipped=True)
            return
        t0 = time.perf_counter()
        lay = self.cfg.layout
        params = self._restore_params()
        var = self._ffo_var()
        mcfg = self._model_cfg()
        nat_trajs, gen_trajs = [], []
        for base in self.utterances():
            ffi = rawio.read_f32(self._p("ffi", base, "ffi"), mcfg.n_in)
            _, g = self._gen_one(ffi, params, var, self._alpha(), mspf=None)
            gen_trajs.append(g.mgc)
            nat_trajs.append(rawio.read_f32(
                self._p("mgc", base, "mgc"),
                lay.mgc_dim).astype(np.float64))
        nat = postfilter.mspf_stats(nat_trajs, device=self.dev)
        gen = postfilter.mspf_stats(gen_trajs, device=self.dev)
        np.savez(os.path.join(self.wd, "stats", "mspf.npz"),
                 nat_mean=nat.mean, nat_std=nat.std,
                 gen_mean=gen.mean, gen_std=gen.std)
        self.manifest.mark("MSPFD")
        self._lap("MSPFD", t0)

    def generate(self) -> None:
        if self.manifest.done("PGEN"):
            return
        t0 = time.perf_counter()
        params = self._restore_params()
        mcfg = self._model_cfg()
        var = self._ffo_var()
        mspf = self._load_mspf() if self.cfg.use_mspf else None
        for base in self.utterances():
            ffi = rawio.read_f32(self._p("ffi", base, "ffi"), mcfg.n_in)
            mgc, g = self._gen_one(ffi, params, var, self._alpha(), mspf)
            for ext, v in (("mgc", mgc), ("lf0", g.lf0), ("bap", g.bap),
                           ("vuv", g.vuv.to(torch.float32))):
                rawio.write_f32(self._p("gen", base, ext), v.cpu().numpy())
        self.manifest.mark("PGEN")
        self._lap("PGEN", t0)

    # -- WGEN: decode + WORLD synthesis ----------------------------------
    def _synthesize(self, mgc, lf0, bap, noise=None, seed: int = 0):
        """(T, mgc_dim), (T, lf0_dim) with MAGIC unvoiced, (T, bap_dim) ->
        the waveform (y_length,) on the device: K12's decode and fast-mode
        synthesis in float32 (the synth lane), on `noise` (1, y_length+16)
        or noise drawn from `seed`; at parity, the decode in float64 and
        `vocoder.synthesize(parity=True)` (float64, the reference's noise
        stream), as the JAX pipeline does."""
        lf0 = torch.as_tensor(lf0, device=self.dev)
        lf0_1 = torch.where(lf0[:, 0] == generation.MAGIC,
                            torch.zeros_like(lf0[:, 0]), lf0[:, 0])
        if self.cfg.parity:
            fft_size = cfg_mod.cheaptrick_fft_size(self.cfg.fs)
            f0, sp, ap = decode.decode_features(
                *(torch.as_tensor(v, dtype=torch.float64, device=self.dev)
                  for v in (lf0_1, mgc, bap)), self.cfg.fs, fft_size)
            return vocoder.synthesize(f0, sp, ap, self.cfg.fs, fft_size,
                                      self.cfg.frame_period, parity=True,
                                      device=self.dev)
        return feat_mod.synth_lane(lf0_1[None], torch.as_tensor(mgc)[None],
                                   torch.as_tensor(bap)[None], self.cfg.fs,
                                   self.cfg.frame_period, noise=noise,
                                   seed=seed, device=self.dev)[0]

    def synthesize_stage(self) -> None:
        if self.manifest.done("WGEN"):
            return
        t0 = time.perf_counter()
        lay = self.cfg.layout
        for base in self.utterances():
            y = self._synthesize(
                rawio.read_f32(self._p("gen", base, "mgc"), lay.mgc_dim),
                rawio.read_f32(self._p("gen", base, "lf0"), lay.lf0_dim),
                rawio.read_f32(self._p("gen", base, "bap"), lay.bap_dim))
            wavio.wavwrite(y.cpu().numpy(), self.cfg.fs,
                           self._p("gen", base, "wav"))
        self.manifest.mark("WGEN")
        self._lap("WGEN", t0)

    # -- PGEND/WGEND: unseen labels via the HSMM duration model ---------
    def synthesize_unseen(self, base: str, rho: float = 0.0) -> str:
        """Synthesize labels/full/<base>.lab with durations PREDICTED by
        the HALGN duration model (HMGenS -> convert_dur2lab ->
        DNNSynthesis -> gen_param -> gen_wave; Training.pl:885-928).
        Returns the wav path."""
        from hts_train_world_tpu_torch.models import context_clustered
        from hts_train_world_tpu_torch.models import pgen as pgen_mod
        hmm = self._load_hmm()
        model = context_clustered.clustered_from_plain(hmm["clustered"])
        rcfg = hmm["cfg"]
        ctx_seq, _ = self._full_label(base)
        if ctx_seq is None:
            raise FileNotFoundError(f"labels/full/{base}.lab")
        shift_100ns = int(self.cfg.frame_period * 1e4)
        durs = pgen_mod.state_durations(model, ctx_seq, rho)
        lab = labels_mod.durations_to_state_lines(
            ctx_seq, durs, rcfg.n_states, shift_100ns)
        with open(self._p("gen", base, "lab"), "w") as f:
            f.write(lab)
        feats = qconf_mod.parse_config(
            open(os.path.join(self.wd, "qconf.conf")).read())
        labs = qconf_mod.parse_aligned_labels(lab, shift_100ns)
        ffi = qconf_mod.encode_labels(feats, labs)
        mspf = self._load_mspf() if self.cfg.use_mspf else None
        mgc, g = self._gen_one(np.asarray(ffi), self._restore_params(),
                               self._ffo_var(), self._alpha(), mspf)
        if self.cfg.parity:     # the generated float64 features as they are
            y = self._synthesize(mgc, g.lf0, g.bap)
        else:
            y = self._synthesize(mgc.float(), g.lf0, g.bap.float())
        out = self._p("gen", base, "wav")
        wavio.wavwrite(y.cpu().numpy(), self.cfg.fs, out)
        return out

    def run(self, upto: Optional[str] = None) -> None:
        for stage, fn in zip(STAGES, (
                self.analyze, self.compose_stage, self.stats, self.halgn,
                self.mkdat, self.train_dnn, self.trjgv, self.mspfd,
                self.generate, self.synthesize_stage)):
            fn()
            if stage == upto:
                break
