"""K1: F0-adaptive windowed frames, written compactly at offset 0.

Counterpart of the JAX package's slab windows: `ops/d4c.py:71-119`
(`_slab_frames` + `_slab_window`), `ops/cheaptrick.py:113-125`
(`slab_wave`) and `ops/stonemask.py:91-108` (`windows`).  The JAX code
lays every frame out in a regular slab row and lets the window float
inside it (a TPU has no cheap gather); here each frame reads `x` at its
own offset, clamped to x[0] / x[-1] (the JAX edge padding), and writes its
window of 2h+1 samples at offset 0 of a zero-padded row.  The N-point DFT
of such a row is the true DFT, so power spectra and same-offset
cross-products equal those of the JAX slab formulation.

Per-frame integer parameters (window centre `origin`, half-length `h`)
are computed by the callers in PyTorch, shared by the kernel and its
plain twin, so both place every window on the same samples.

Modes (csrc/frame_window.cu); each fixes its window:
- MEAN:          Hann window, then weighted mean removal (D4C);
- MEAN_BLACKMAN: Blackman window, then weighted mean removal (LoveTrain);
- CHEAPTRICK:    Hann window scaled to unit energy, then mean removal;
- CENTROID:      Blackman, mean removal, unit energy; second output =
                 out * (j+1);
- STONEMASK:  Blackman of absolute time t_j - pos over 2h+1 samples
              centred one sample early (stonemask.cpp's 1-based index);
              outputs x*w and x*dw with dw the centred difference of w.
"""
from __future__ import annotations

import numpy as np
import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops.prims import exact_div

MEAN, CHEAPTRICK, CENTROID, STONEMASK, MEAN_BLACKMAN = 0, 1, 2, 3, 4


def frame_windows_plain(x, origin, h, f0, pos, fs: int, ratio: float,
                        width: int, mode: int):
    B, L = x.shape
    R = origin.shape[0]
    T = R // B
    dtype, dev = x.dtype, x.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    j = torch.arange(width, device=dev)[None, :]
    hh = h.long()[:, None]
    valid = j <= 2 * hh
    idx = origin.long()[:, None] - hh + j
    utt = (torch.arange(R, device=dev) // T)[:, None]
    seg = x[utt, idx.clamp(0, L - 1)]
    if mode == STONEMASK:
        tmp = exact_div(idx.to(dtype), fs) - pos[:, None]
        wt = exact_div((2 * hh + 1).to(dtype), fs)
        mw = (0.42 + 0.5 * torch.cos((2.0 * np.pi) * tmp / wt)
              + 0.08 * torch.cos((4.0 * np.pi) * tmp / wt))
        mw = torch.where(valid, mw, zero)
        pad = torch.zeros((R, 1), dtype=dtype, device=dev)
        mw_p = torch.cat([mw[:, 1:], pad], dim=1)
        mw_m = torch.cat([pad, mw[:, :-1]], dim=1)
        dw = torch.where(valid, -(mw_p - mw_m) / 2.0, zero)
        return seg * mw, seg * dw
    position = exact_div(exact_div(2.0 * (j - hh).to(dtype), ratio), fs)
    arg = np.pi * position * f0[:, None]
    if mode in (MEAN_BLACKMAN, CENTROID):
        w = 0.42 + 0.5 * torch.cos(arg) + 0.08 * torch.cos(arg * 2.0)
    else:
        w = 0.5 * torch.cos(arg) + 0.5
    w = torch.where(valid, w, zero)
    if mode == CHEAPTRICK:
        w = w / torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))
    wave = torch.where(valid, seg * w, zero)
    coef = torch.sum(wave, dim=1, keepdim=True) / torch.sum(w, dim=1,
                                                            keepdim=True)
    wave = torch.where(valid, wave - w * coef, zero)
    if mode != CENTROID:
        return wave, None
    wave = wave / torch.sqrt(torch.sum(wave * wave, dim=1, keepdim=True))
    return wave, wave * (j + 1).to(dtype)


def frame_windows(x, origin, h, f0, fs: int, ratio: float, width: int,
                  mode: int, pos=None):
    """x (B, L) f32; per-frame (R = B*T,) origin / h (integer), f0 and,
    for STONEMASK, pos (seconds) -> (out1, out2) rows (R, width); out2
    is None for MEAN and CHEAPTRICK.  Requires 2*max(h)+1 <= width."""
    if not x.is_cuda:
        return frame_windows_plain(x, origin, h, f0, pos, fs, ratio, width,
                                   mode)
    B, L = x.shape
    R = origin.shape[0]
    if x.dtype != torch.float32 or R % B or width > 11520:
        raise ValueError("frame_windows: f32 x, B*T frames, width <= 11520 "
                         "(the window is staged in shared memory)")
    x = x.contiguous()
    o32 = origin.to(torch.int32).contiguous()
    h32 = h.to(torch.int32).contiguous()
    f0c = f0.to(torch.float32).contiguous()
    posc = (pos if pos is not None else f0).to(torch.float32).contiguous()
    kernels.check_cuda("frame_windows", x, o32, h32, f0c, posc)
    out1 = torch.empty((R, width), dtype=torch.float32, device=x.device)
    two = mode in (CENTROID, STONEMASK)
    out2 = torch.empty_like(out1) if two else None
    kernels.launch("frame_window", [
        x.data_ptr(), L, R // B, o32.data_ptr(), h32.data_ptr(),
        f0c.data_ptr(), posc.data_ptr(), float(fs), float(ratio), R, width,
        mode, out1.data_ptr(),
        out2.data_ptr() if two else None],
        dict(x=x, origin=origin, h=h, f0=f0, fs=fs, ratio=ratio,
             width=width, mode=mode, pos=pos))
    return out1, out2
