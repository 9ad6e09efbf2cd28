"""Parameter generation from acoustic-model outputs: the port's
counterpart of `hts_train_world_tpu/ops/generation.py`, the gen_param
equivalent (Training.pl:2755-2810).  Split the ffo frame into streams,
decide V/UV from the MSD flag, run MLPG with the corpus variances and
restore the -1e10 magic on unvoiced frames of the lf0 and vib streams.

MLPG runs in float64 through K8 (`ops.mlpg.mlpg`) on the device of the
model outputs: every stream's dimensions side by side in one launch (each
dimension's solve is independent of the others).
"""
from __future__ import annotations

import dataclasses

import torch

from hts_train_world_tpu_torch.features.compose import StreamLayout
from hts_train_world_tpu_torch.ops import mlpg as mlpg_mod

MAGIC = -1.0e10
STREAMS = ("mgc", "lf0", "bap", "vib")


@dataclasses.dataclass
class GeneratedParams:
    mgc: torch.Tensor   # (T, mgc_dim)
    lf0: torch.Tensor   # (T, lf0_dim), MAGIC where unvoiced
    bap: torch.Tensor
    vib: torch.Tensor
    vuv: torch.Tensor   # (T,) bool


def _stream_cols(layout: StreamLayout):
    """Column layout of the ffo frame: [mgc-win | lf0-msd | lf0-win |
    bap-win | vib-win] (data/Makefile.in:360-409; vib carries no flag —
    its V/UV follows lf0's, closing the reference's missing-flag gap)."""
    w = layout.n_win
    cols = {}
    off = 0
    cols["mgc"] = (None, slice(off, off + w * layout.mgc_dim))
    off += w * layout.mgc_dim
    cols["lf0"] = (off, slice(off + 1, off + 1 + w * layout.lf0_dim))
    off += 1 + w * layout.lf0_dim
    cols["bap"] = (None, slice(off, off + w * layout.bap_dim))
    off += w * layout.bap_dim
    cols["vib"] = (None, slice(off, off + w * layout.vib_dim))
    return cols


def generate_parameters(ffo, ffo_var, layout: StreamLayout = StreamLayout(),
                        windows=mlpg_mod.DEFAULT_WINDOWS) -> GeneratedParams:
    """ffo: (T, ffo_dim) model means; ffo_var: (ffo_dim,) corpus variances
    (stats/ffo.var).  MLPG runs over all frames (as the reference's SPTK
    mlpg does) in float64 on ffo's device; MSD masking comes after."""
    ffo = torch.as_tensor(ffo, dtype=torch.float64)
    ffo_var = torch.as_tensor(ffo_var, dtype=torch.float64,
                              device=ffo.device)
    T = ffo.shape[0]
    w = layout.n_win
    cols = _stream_cols(layout)
    dims = dict(mgc=layout.mgc_dim, lf0=layout.lf0_dim, bap=layout.bap_dim,
                vib=layout.vib_dim)
    vuv = ffo[:, cols["lf0"][0]] > 0.5  # SOPR -s 0.5 -UNIT (Training.pl:2782)
    mean = torch.cat([ffo[:, cols[n][1]].reshape(T, w, dims[n])
                      for n in STREAMS], dim=2)
    var = torch.cat([ffo_var[cols[n][1]].reshape(1, w, dims[n])
                     for n in STREAMS], dim=2).expand(T, -1, -1)
    statics = torch.split(mlpg_mod.mlpg(mean, var.contiguous(), windows),
                          [dims[n] for n in STREAMS], dim=1)
    out = {}
    for name, st in zip(STREAMS, statics):
        if name in ("lf0", "vib"):
            st = torch.where(vuv[:, None], st, torch.full_like(st, MAGIC))
        out[name] = st
    return GeneratedParams(out["mgc"], out["lf0"], out["bap"], out["vib"],
                           vuv)


def lf0_to_f0(lf0_static, vuv) -> torch.Tensor:
    """First lf0 dim -> f0 contour for the synthesizer (0 = unvoiced)."""
    lf0_static = torch.as_tensor(lf0_static)
    vuv = torch.as_tensor(vuv, device=lf0_static.device)
    return torch.where(vuv, torch.exp(lf0_static[:, 0]),
                       torch.zeros_like(lf0_static[:, 0]))
