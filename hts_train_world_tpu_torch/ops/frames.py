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
plain twin, so both place every window on the same samples.  The
callers' origins come from `frame_origins`: on a frame grid of a whole
number of samples, the grid point moved by at most a few samples (the
JAX package's slab windows); on any other grid (44.1 or 22.05 kHz at 5
ms), each frame's own rounded position (its generic windows, grid_step
0).  K1 reads every window from its own origin either way.

Modes (csrc/frame_window.cu); each fixes its window:
- MEAN:          Hann window, then weighted mean removal (D4C);
- MEAN_BLACKMAN: Blackman window, then weighted mean removal (LoveTrain);
- CHEAPTRICK:    Hann window scaled to unit energy, then mean removal;
- CENTROID:      Blackman, mean removal, unit energy; second output =
                 out * (j+1);
- STONEMASK:  Blackman of absolute time t_j - pos over 2h+1 samples
              centred one sample early (stonemask.cpp's 1-based index);
              outputs x*w and x*dw with dw the centred difference of w.

float32 is the fast path.  float64 is the parity analysis (the JAX
package's generic windows, cheaptrick.py:127-148, d4c.py:35-68,
stonemask.py:179-205): the windows there add the reference's noise,
randn * 1e-12, read from the reseeded stream `noise` from each row's
offset `noff` (device tensors, so no host read a frame), and STONEMASK
with `parity` (the bucket path's, float64 only) reads sample j at its own
rounded index round((pos + (j-h)/fs) * fs) - 1 instead of the contiguous
run from `origin`.  `rowutt` names each row's utterance where the rows
are not the B*T frames in order.
"""
from __future__ import annotations

import numpy as np
import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import prims
from hts_train_world_tpu_torch.ops.prims import exact_div

MEAN, CHEAPTRICK, CENTROID, STONEMASK, MEAN_BLACKMAN = 0, 1, 2, 3, 4
_STONEMASK_ROUNDED = 5      # K1's code for STONEMASK with parity


def window_plan(width: int):
    """K1's block for a mode with sums: (NT, K), NT threads of K <= 4
    chunks of four samples, the fewest that hold a row of `width`;
    STONEMASK's modes take 128 threads that loop over the row's chunks.
    A copy of csrc/frame_window.cu's `plan_of` for the CPU's emulation;
    the card tests hold it to the kernel's `frame_window_plan`."""
    nq = -(-width // 4)
    for nt, k in ((128, 2), (128, 4), (256, 4), (512, 4)):
        if nq <= nt * k:
            return nt, k
    return 1024, 4


def _check_parity(mode: int, dtype, parity: bool):
    if parity and mode == STONEMASK and dtype != torch.float64:
        raise ValueError("frame_windows: STONEMASK's per-sample index "
                         "(parity) is the float64 bucket path's")


def _row_utterance(R: int, T: int, rowutt, dev):
    return (rowutt.long() if rowutt is not None
            else torch.arange(R, device=dev) // T)[:, None]


def frame_origins(u, T: int, grid_step: int, lim: int):
    """Each frame's window origin from u (B*T,), its rounded sample index:
    u itself where every frame sits at a position of its own (grid_step
    0, the JAX package's generic windows), else the grid point f *
    grid_step moved toward u by at most `lim` samples (the slab windows of
    the regular frame grid, which absorb only small deviations)."""
    if grid_step <= 0:
        return u
    base = (torch.arange(T, device=u.device) * grid_step).repeat(
        u.shape[0] // T)
    return base + torch.clamp(u - base, -lim, lim)


def frame_windows_plain(x, origin, h, f0, pos, fs: int, ratio: float,
                        width: int, mode: int, noise=None, noff=None,
                        rowutt=None, parity: bool = False):
    _check_parity(mode, x.dtype, parity)
    B, L = x.shape
    R = h.shape[0]
    T = max(R // B, 1)
    dtype, dev = x.dtype, x.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    j = torch.arange(width, device=dev)[None, :]
    hh = h.long()[:, None]
    valid = j <= 2 * hh
    utt = _row_utterance(R, T, rowutt, dev)
    if mode == STONEMASK:
        if parity:                      # each sample rounded on its own
            # pos + (j-h)/fs as XLA compiles the JAX package's, a fused
            # multiply-add with 1/fs: at 44.1 kHz the frame grid puts the
            # samples on rounding ties, and this decides them alike
            u = prims.fma((j - hh).to(dtype),
                          torch.full((), 1.0 / fs, dtype=dtype, device=dev),
                          pos[:, None])
            idx = prims.matlab_round_i(u * fs) - 1
        else:
            idx = origin.long()[:, None] - hh + j
        seg = x[utt, idx.clamp(0, L - 1)]
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
    idx = origin.long()[:, None] - hh + j
    seg = x[utt, idx.clamp(0, L - 1)]
    position = exact_div(exact_div(2.0 * (j - hh).to(dtype), ratio), fs)
    arg = np.pi * position * f0[:, None]
    if mode in (MEAN_BLACKMAN, CENTROID):
        w = 0.42 + 0.5 * torch.cos(arg) + 0.08 * torch.cos(arg * 2.0)
    else:
        w = 0.5 * torch.cos(arg) + 0.5
    w = torch.where(valid, w, zero)
    if mode == CHEAPTRICK:
        w = w / torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))
    wave = seg * w
    if noise is not None:
        nz = noise[(noff[:, None] + j).clamp(0, noise.shape[0] - 1)]
        wave = torch.where(noff[:, None] >= 0, wave + nz * 1e-12, wave)
    wave = torch.where(valid, wave, zero)
    coef = torch.sum(wave, dim=1, keepdim=True) / torch.sum(w, dim=1,
                                                            keepdim=True)
    wave = torch.where(valid, wave - w * coef, zero)
    if mode != CENTROID:
        return wave, None
    wave = wave / torch.sqrt(torch.sum(wave * wave, dim=1, keepdim=True))
    return wave, wave * (j + 1).to(dtype)


def frame_windows(x, origin, h, f0, fs: int, ratio: float, width: int,
                  mode: int, pos=None, noise=None, noff=None, rowutt=None,
                  parity: bool = False):
    """x (B, L) float32 or float64; per-frame (R,) origin / h (integer),
    f0 and, for STONEMASK, pos (seconds) -> (out1, out2) rows (R, width)
    in x's dtype; out2 is None for MEAN and CHEAPTRICK.  R = B*T frames in
    order, or any R with `rowutt` (R,) naming each row's utterance.
    `noise` (the stream, x's dtype) and `noff` (R,) add the reference's
    noise to the windows (float64); a row whose offset is negative gets
    none.  `parity` (STONEMASK, float64): each sample at its own rounded
    index.  A window wider than `width` is cut at the row's end."""
    if not x.is_cuda:
        return frame_windows_plain(x, origin, h, f0, pos, fs, ratio, width,
                                   mode, noise, noff, rowutt, parity)
    _check_parity(mode, x.dtype, parity)
    B, L = x.shape
    R = h.shape[0]
    dt = x.dtype
    if (dt not in (torch.float32, torch.float64)
            or (rowutt is None and R % B)
            or width * dt.itemsize > 46 * 1024
            or (noise is not None and (noise.dtype != dt or noff is None))):
        raise ValueError("frame_windows: f32 or f64 x, B*T frames or a "
                         "row utterance index, width * itemsize <= 46 KB "
                         "(float64's window is staged in shared memory), "
                         "noise of x's dtype with its offsets")
    f64 = dt == torch.float64
    x = x.contiguous()
    o32 = origin.to(torch.int32).contiguous()
    h32 = h.to(torch.int32).contiguous()
    f0c = f0.to(dt).contiguous()
    posc = (pos if pos is not None else f0c).to(dt).contiguous()
    ru = rowutt.to(torch.int32).contiguous() if rowutt is not None else None
    nz = noise.contiguous() if noise is not None else None
    no = noff.to(torch.int64).contiguous() if noise is not None else None
    kernels.check_cuda("frame_windows", x, o32, h32, f0c, posc,
                       *[t for t in (ru, nz, no) if t is not None])
    out1 = torch.empty((R, width), dtype=dt, device=x.device)
    two = mode in (CENTROID, STONEMASK)
    out2 = torch.empty_like(out1) if two else None
    kernels.launch("frame_window", [
        x.data_ptr(), L, max(R // B, 1), ru.data_ptr() if ru is not None
        else None, o32.data_ptr(), h32.data_ptr(), f0c.data_ptr(),
        posc.data_ptr(), float(fs), float(ratio), R, width,
        _STONEMASK_ROUNDED if parity and mode == STONEMASK else mode,
        nz.data_ptr() if nz is not None else None,
        no.data_ptr() if no is not None else None, int(f64),
        out1.data_ptr(), out2.data_ptr() if two else None],
        dict(x=x, origin=origin, h=h, f0=f0, fs=fs, ratio=ratio,
             width=width, mode=mode, pos=pos, noise=noise, noff=noff,
             rowutt=rowutt, parity=parity), variant="f64" if f64 else None)
    return out1, out2
