"""CMP / ffo composition and corpus statistics — equivalents of the
data/Makefile.in `cmp`, `ffo` and `stats` targets under the WORLD config
(SURVEY.md F5-F7).

Counterpart of `hts_train_world_tpu/features/compose.py`.  Layouts
(configure.ac:575-585, data/Makefile.in:276-320,360-409):
  cmp frame = [mgc-win 150 | lf0-win 6 | bap-win 75 | vib-win 6] = 237
  ffo frame = [mgc-win 150 | lf0-msd 1 | lf0-win(interp) 6 | bap-win 75 |
               vib-win 6] = 238
(the intended ffo layout: one MSD flag from lf0 dim 0; the reference's
own ffo under WORLD is latently broken, see the JAX package's module).

`compose_cmp` / `compose_ffo` expand each stream by the delta windows in
float64 on `device` (K7's float64 instantiation on the card, its plain
twin on the CPU) and return float32 numpy frames, as the JAX package
does.  The corpus statistics are host numpy sums that merge by `+`.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.features import msd, windows


@dataclasses.dataclass(frozen=True)
class StreamLayout:
    mgc_dim: int = 50
    lf0_dim: int = 2
    bap_dim: int = 25
    vib_dim: int = 2
    n_win: int = 3

    @property
    def cmp_dim(self):
        return self.n_win * (self.mgc_dim + self.lf0_dim + self.bap_dim
                             + self.vib_dim)

    @property
    def ffo_dim(self):
        return self.cmp_dim + 1  # + lf0 MSD flag

    def cmp_slices(self):
        w = self.n_win
        sizes = [w * self.mgc_dim, w * self.lf0_dim, w * self.bap_dim,
                 w * self.vib_dim]
        offs = np.cumsum([0] + sizes)
        return {k: slice(offs[i], offs[i + 1])
                for i, k in enumerate(["mgc", "lf0", "bap", "vib"])}


def _expanded(streams, dev):
    """Each (T, D) stream expanded by the delta windows in float64 on
    `dev`, read back as numpy float64."""
    return [windows.expand(torch.as_tensor(np.asarray(s, np.float64),
                                           device=dev)).cpu().numpy()
            for s in streams]


def compose_cmp(mgc, lf0_2d, bap, vib, layout: StreamLayout = StreamLayout(),
                device="cuda"):
    """(T, 237) float32 cmp body (header added by an HTK writer)."""
    dev = device_mod.resolve(device)
    parts = _expanded((mgc, lf0_2d, bap, vib), dev)
    return np.concatenate(parts, axis=-1).astype(np.float32)


def compose_ffo(mgc, lf0_2d, bap, vib, layout: StreamLayout = StreamLayout(),
                device="cuda"):
    """(T, 238) float32 DNN target frame (intended WORLD layout)."""
    dev = device_mod.resolve(device)
    lf0 = np.asarray(lf0_2d, np.float64)
    flag = msd.msd_flags(np.where(lf0[:, :1] == 0.0, msd.MAGIC, lf0[:, :1]))
    lf0_ip = msd.interpolate_gaps(np.where(lf0 == 0.0, msd.MAGIC, lf0))
    m, l, b, v = _expanded((mgc, lf0_ip, bap, vib), dev)
    return np.concatenate([m, flag, l, b, v], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# corpus statistics (sums/sumsq accumulate across shards)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunningStats:
    """Accumulable first/second moments; merge via +."""
    n: float
    s1: np.ndarray
    s2: np.ndarray

    @staticmethod
    def from_frames(x: np.ndarray) -> "RunningStats":
        x = np.asarray(x, np.float64)
        return RunningStats(float(x.shape[0]), x.sum(0), (x * x).sum(0))

    def __add__(self, o: "RunningStats") -> "RunningStats":
        return RunningStats(self.n + o.n, self.s1 + o.s1, self.s2 + o.s2)

    @property
    def mean(self):
        return self.s1 / self.n

    @property
    def var(self):
        return self.s2 / self.n - self.mean ** 2


def ffo_variance(ffos: List[np.ndarray]) -> np.ndarray:
    """stats/ffo.var: per-dim variance over all corpus frames (vstat -o 2)."""
    acc = RunningStats.from_frames(ffos[0])
    for f in ffos[1:]:
        acc = acc + RunningStats.from_frames(f)
    return acc.var


def gv_variance(ffos: List[np.ndarray],
                layout: StreamLayout = StreamLayout()) -> np.ndarray:
    """stats/gv.var: variance over utterances of the per-utterance variance
    of the static coefficients [mgc | lf0 | bap] (data/Makefile.in:441-456)."""
    utt_vars = np.stack([np.var(np.asarray(f, np.float64), axis=0)
                         for f in ffos])
    w = layout.n_win
    mgc_s = slice(0, layout.mgc_dim)
    lf0_s = slice(w * layout.mgc_dim + 1,
                  w * layout.mgc_dim + 1 + layout.lf0_dim)
    bap_off = w * layout.mgc_dim + 1 + w * layout.lf0_dim
    bap_s = slice(bap_off, bap_off + layout.bap_dim)
    gv = np.var(utt_vars, axis=0)
    return np.concatenate([gv[mgc_s], gv[lf0_s], gv[bap_s]])


def stream_variances(ffo_var: np.ndarray,
                     layout: StreamLayout = StreamLayout()):
    """stats/{mgc,lf0,bap}.var slices of ffo.var (data/Makefile.in:437-440)."""
    w = layout.n_win
    mgc_end = w * layout.mgc_dim
    lf0_start = mgc_end + 1
    lf0_end = lf0_start + w * layout.lf0_dim
    bap_end = lf0_end + w * layout.bap_dim
    return dict(mgc=ffo_var[:mgc_end], lf0=ffo_var[lf0_start:lf0_end],
                bap=ffo_var[lf0_end:bap_end])
