"""Delta-window expansion (data/scripts/window.pl), batched.

Counterpart of `hts_train_world_tpu/features/windows.py`: for each window
w of size 2n+1 the output at frame t is sum_k w[k] * x[clamp(t+k, 0, T-1)];
if any tap inside the window's nonzero support reads the -1e10 magic value
the output is -1e10 (MSD boundary propagation).  The default HTS windows
are [1], [-0.5, 0, 0.5], [1, -2, 1].

`expand` runs as kernel K7 (csrc/delta_window.cu) for CUDA tensors and as
its plain twin `expand_plain` (shifted adds) for CPU tensors; the two do
the same operations in the same order, so they agree bit for bit, in
float32 (the feature lane) or float64 (composition and generation).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hts_train_world_tpu_torch import kernels

MAGIC = -1.0e10

DEFAULT_WINDOWS = (
    np.array([1.0]),
    np.array([-0.5, 0.0, 0.5]),
    np.array([1.0, -2.0, 1.0]),
)


def _support(win: np.ndarray):
    """chkbound flags (window.pl:81-91): taps between the first and last
    nonzero coefficient, inclusive."""
    flags2 = np.ones(len(win), bool)
    for j in range(len(win)):
        if win[j] != 0.0:
            break
        flags2[j] = False
    for j in range(len(win) - 1, -1, -1):
        if win[j] != 0.0:
            break
        flags2[j] = False
    return flags2


def apply_window(x, win: np.ndarray):
    """One window over statics x (..., T, D) -> (..., T, D)."""
    T = x.shape[-2]
    nlr = (len(win) - 1) // 2
    support = _support(win)
    out = torch.zeros_like(x)
    boundary = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    t = torch.arange(T, device=x.device)
    for k in range(-nlr, nlr + 1):
        xi = x[..., torch.clamp(t + k, 0, T - 1), :]
        if win[k + nlr] != 0.0:
            out = out + float(win[k + nlr]) * xi
        if support[k + nlr]:
            boundary = boundary | (xi == MAGIC)
    return torch.where(boundary, MAGIC, out)


def expand_plain(x, windows=DEFAULT_WINDOWS):
    return torch.cat([apply_window(x, np.asarray(w, np.float64))
                      for w in windows], dim=-1)


@functools.lru_cache(maxsize=None)
def _window_table(windows: tuple, dtype, device):
    """(coefficients, support) of the windows centred in a common odd
    width, as (n_win, width) tensors of `dtype` on `device`."""
    nlr = max((len(w) - 1) // 2 for w in windows)
    width = 2 * nlr + 1
    coef = np.zeros((len(windows), width))
    sup = np.zeros((len(windows), width))
    for i, w in enumerate(windows):
        w = np.asarray(w, np.float64)
        o = nlr - (len(w) - 1) // 2
        coef[i, o:o + len(w)] = w
        sup[i, o:o + len(w)] = _support(w)
    return (torch.as_tensor(coef, dtype=dtype, device=device),
            torch.as_tensor(sup, dtype=dtype, device=device))


def expand(x, windows=DEFAULT_WINDOWS):
    """K7: statics x (..., T, D) -> (..., T, n_win*D), per-window blocks
    in the order [static | delta | delta-delta] (window.pl's layout)."""
    if not x.is_cuda:
        return expand_plain(x, windows)
    if x.dtype not in (torch.float32, torch.float64) or x.dim() < 2:
        raise ValueError("expand: f32 or f64 statics (..., T, D)")
    if any(len(w) % 2 == 0 for w in windows):
        raise ValueError("expand: windows of odd length")
    *lead, T, D = x.shape
    xc = x.reshape(-1, T, D).contiguous()
    key = tuple(tuple(float(v) for v in w) for w in windows)
    coef, sup = _window_table(key, x.dtype, x.device)
    kernels.check_cuda("expand", xc, coef, sup)
    out = torch.empty((xc.shape[0], T, len(windows) * D), dtype=x.dtype,
                      device=x.device)
    kernels.launch("delta_window", [
        xc.data_ptr(), xc.shape[0], T, D, coef.data_ptr(), sup.data_ptr(),
        coef.shape[0], coef.shape[1], int(x.dtype == torch.float64),
        out.data_ptr()],
        dict(x=x, windows=windows))
    return out.reshape(*lead, T, len(windows) * D)
