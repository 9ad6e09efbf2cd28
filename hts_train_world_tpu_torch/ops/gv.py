"""Global-variance (GV) scaling — the closed form of HMGenS's GV term.

Counterpart of `hts_train_world_tpu/ops/gv.py:22-27` (`gv_scale`):
rescale each dimension's deviation from its utterance mean so that its
variance becomes the GV model's mean, c' = mean + (gv / var)^(w/2)
(c - mean), with the variance floored at 1e-12 and nothing else.  `mask`
(rows) restricts the statistics and the rescaling to the rows it keeps
(pgen's lf0: voiced, non-MAGIC frames) and leaves the input as it is when
it keeps 2 rows or fewer.

`gv_scale` runs kernel K23 (csrc/gv_scale.cu) for CUDA tensors, one block
per column with two-pass float64 statistics; `gv_scale_plain` is its twin,
run for CPU tensors.  (`gv_refine`, the gradient GV generation, has no
caller on any path of the JAX package and is not ported.)
"""
from __future__ import annotations

import torch

from hts_train_world_tpu_torch import kernels


def _scale(x, gv_mean, weight):
    mu = x.mean(dim=0, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=0, keepdim=True)
    ratio = torch.sqrt(gv_mean[None] / torch.clamp(var, min=1e-12)) ** weight
    return mu + ratio * (x - mu)


def gv_scale_plain(statics, gv_mean, weight: float = 1.0, mask=None):
    gv_mean = torch.as_tensor(gv_mean, dtype=statics.dtype,
                              device=statics.device)
    if mask is None:
        return _scale(statics, gv_mean, weight)
    out = statics.clone()
    if int(mask.sum()) > 2:
        out[mask] = _scale(statics[mask], gv_mean, weight)
    return out


def gv_scale(statics, gv_mean, weight: float = 1.0, mask=None):
    """K23: statics (T, D) float64, gv_mean (D,), mask (T,) bool or None ->
    the scaled statics (T, D), a new tensor."""
    if not statics.is_cuda:
        return gv_scale_plain(statics, gv_mean, weight, mask)
    gv_mean = torch.as_tensor(gv_mean, dtype=torch.float64,
                              device=statics.device)
    if (statics.dtype != torch.float64 or statics.dim() != 2
            or gv_mean.shape != (statics.shape[1],)
            or (mask is not None and (mask.dtype != torch.bool
                                      or mask.shape != statics.shape[:1]))):
        raise ValueError("gv_scale: float64 statics (T, D), gv_mean (D,), "
                         "mask (T,) bool or None")
    x = statics.contiguous()
    T, D = x.shape
    m = None if mask is None else mask.contiguous().view(torch.uint8)
    kernels.check_cuda("gv_scale", x, gv_mean,
                       *(() if m is None else (m,)))
    out = torch.empty_like(x)
    kernels.launch("gv_scale", [
        x.data_ptr(), T, D, gv_mean.data_ptr(), float(weight),
        0 if m is None else m.data_ptr(), out.data_ptr()],
        dict(statics=statics, gv_mean=gv_mean, weight=float(weight),
             mask=mask))
    return out
