"""Corpus pipeline orchestrator, front half: the port's counterpart of
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
  TRDNN, TRJGV, MSPFD, PGEN, WGEN: the DNN half, not in the port yet
           (ROADMAP Queue A 4); each raises NotImplementedError.

`stage_seconds` keeps each stage's wall seconds and ANALYZE's parts
(loader, extract, vibrato, writes); `halgn_seconds` keeps `train_voice`'s
own stage seconds.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import pickle
import time
from typing import List, Optional

import numpy as np

from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch import vocoder
from hts_train_world_tpu_torch.features import compose, encode, htk
from hts_train_world_tpu_torch.features import labels as labels_mod
from hts_train_world_tpu_torch.features import qconf as qconf_mod
from hts_train_world_tpu_torch.features import vibrato
from hts_train_world_tpu_torch.io import loader as nloader
from hts_train_world_tpu_torch.io import rawio
from hts_train_world_tpu_torch.parallel import bucketing
from hts_train_world_tpu_torch.runtime.checkpoint import StageManifest

STAGES = ["ANALYZE", "COMPOSE", "STATS", "HALGN", "MKDAT", "TRDNN",
          "TRJGV", "MSPFD", "PGEN", "WGEN"]

_DNN = ("the DNN half of the pipeline (TRDNN, TRJGV, MSPFD, PGEN, WGEN, "
        "synthesize_unseen) is not in the port yet (ROADMAP Queue A 4)")


@dataclasses.dataclass
class PipelineConfig:
    workdir: str
    fs: int = 48000
    frame_period: float = 5.0
    layout: compose.StreamLayout = dataclasses.field(
        default_factory=compose.StreamLayout)
    parity: bool = False                 # exact reference noise streams
    model: object = None                 # the DNN's config (Queue A 4)
    train: object = None                 # the DNN's training (Queue A 4)
    # HALGN (HSMM alignment + duration model)
    use_hmm_align: bool = False
    hmm: object = None                   # models/recipe.RecipeConfig
    device: str = "cuda"                 # where analysis and HALGN run


class SingingPipeline:
    def __init__(self, pcfg: PipelineConfig):
        self.cfg = pcfg
        self.dev = device_mod.resolve(pcfg.device)
        self.wd = os.path.abspath(pcfg.workdir)
        self.manifest = StageManifest(self.wd)
        self.stage_seconds: dict = {}
        self.halgn_seconds: dict = {}
        for d in ("lf0", "mgc", "bap", "vib", "cmp", "ffo", "ffi", "stats",
                  "model"):
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
        if self.cfg.parity:
            raise NotImplementedError(vocoder._PARITY)
        t_stage = t = time.perf_counter()
        lay = self.cfg.layout
        bases = self.utterances()
        paths = [os.path.join(self.wd, "raw", f"{b}.wav") for b in bases]
        sigs: list = [None] * len(bases)
        with nloader.CorpusLoader(paths, nloader.WAV) as dl:
            for i, x, sr in dl:
                if x is None:
                    raise ValueError(f"{bases[i]}: unreadable wav")
                if sr != self.cfg.fs:
                    raise ValueError(f"{bases[i]}: fs {sr} != {self.cfg.fs}")
                sigs[i] = x
        t = self._lap("ANALYZE loader", t)
        if len(bases) > 1:
            # the corpus path: length-bucketed batched analysis and the
            # encode on the device; only the features come back
            feats = bucketing.bucketed_extract(
                sigs, self.cfg.fs, self.cfg.frame_period,
                mgc_dim=lay.mgc_dim, bap_dim=lay.bap_dim, device=self.dev)
        else:
            feats = []
            for x in sigs:
                a = vocoder.analyze(x, self.cfg.fs, self.cfg.frame_period,
                                    parity=False, device=self.dev)
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

    # -- the DNN half (ROADMAP Queue A 4) -------------------------------
    def train_dnn(self) -> None:
        raise NotImplementedError(_DNN)

    def trjgv(self) -> None:
        raise NotImplementedError(_DNN)

    def mspfd(self) -> None:
        raise NotImplementedError(_DNN)

    def generate(self) -> None:
        raise NotImplementedError(_DNN)

    def synthesize_stage(self) -> None:
        raise NotImplementedError(_DNN)

    def synthesize_unseen(self, base: str, rho: float = 0.0) -> str:
        raise NotImplementedError(_DNN)

    def run(self, upto: Optional[str] = None) -> None:
        for stage, fn in zip(STAGES, (
                self.analyze, self.compose_stage, self.stats, self.halgn,
                self.mkdat, self.train_dnn, self.trjgv, self.mspfd,
                self.generate, self.synthesize_stage)):
            fn()
            if stage == upto:
                break
