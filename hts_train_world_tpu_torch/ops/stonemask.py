"""StoneMask F0 refinement.

Counterpart of `hts_train_world_tpu/ops/stonemask.py`
(externs/WORLD_v2/src/stonemask.cpp).  The f32 fast path runs
each frame's Blackman window and its centred-difference derivative
(kernel K1, STONEMASK mode), ONE B_max-point DFT of each (K39), and the
harmonic instantaneous-frequency readout at bin stride r = B_max / B_c
(K24), which equals the frame's own B_c-point DFT because every window is
zero beyond its 2h+1 samples.  The IF readouts |sm|^2 and Im(conj(sm) sd)
do not depend on where the window sits in its row.  On a frame grid of a
whole number of samples it is the JAX package's `_stonemask_slab` (h
capped, each window's origin within 4 samples of its grid point, every
ungated frame refined); with grid_step 0 (any frame grid: 44.1 kHz at 5
ms, or `estimate_f0` without `fast_grid`) it is the JAX package's float32
bucket path (stonemask.py:154-226, fast=True): each window from its own
origin round(pos*fs) - h - 1, h not capped, and a frame whose DFT size
4 * 2^floor(log2(2h+1)) is no bucket's left at 0.  One B_max DFT in place
of a DFT a bucket: every frame of a bucket B_c has at most B_c/2 samples,
so its B_c bins are the B_max bins at stride r, and no host read of a
bucket's frame count is needed.

The parity path (`parity=True`, float64) is the JAX package's bucket
path (stonemask.py:170-226): the frames of each reachable DFT size B (a
bucket) are windowed at their own positions, each sample at its own
rounded index (K1, STONEMASK mode with parity), transformed at B by
`torch.fft.rfft`, and read out at stride 1 (K24 in float64).  It places
every window from its own position, so it serves any frame grid.

The readout is kernel K24 (csrc/stonemask_if.cu, `if_readout`), with its
plain PyTorch twin `if_readout_plain`: the wrapper launches the kernel for
CUDA tensors and runs the twin only for CPU tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import fftmat, frames, prims


def _fft_size_for_f0(fs: int, f0: float) -> int:
    half = int(1.5 * fs / f0 + 1.0)
    return int(2 ** (2 + int(math.log(half * 2.0 + 1.0) / cfg.K_LOG2)))


def frame_fft_size(h, dtype):
    """Each frame's DFT size, 4 * 2^floor(log2(2h+1)) for its half width
    h (integers), the log taken in `dtype` as the JAX package takes it
    in the waveform's."""
    e_c = torch.floor(torch.log((2 * h + 1).to(dtype)) / cfg.K_LOG2).long()
    return 4 * torch.pow(2, e_c)


def stonemask_buckets(fs: int, f0_floor: float = cfg.K_FLOOR_F0,
                      f0_ceil: float = cfg.K_CEIL_F0):
    out = []
    b = _fft_size_for_f0(fs, f0_ceil)
    while b <= _fft_size_for_f0(fs, f0_floor):
        out.append(b)
        b *= 2
    return out


def stonemask(xs, fs: int, temporal_positions, f0,
              f0_floor: float = cfg.K_FLOOR_F0,
              f0_ceil: float = cfg.K_CEIL_F0, grid_step: int = 0,
              parity: bool = False):
    """StoneMask (stonemask.cpp:211-217) for xs (B, L) and f0 (B, T):
    with `parity`, the bucket path (float64 xs) at any temporal positions
    (T,) or (B, T); else the fast path, on the regular frame grid
    (grid_step samples per frame: the slab path) or, with grid_step 0,
    at any temporal positions (the float32 bucket path)."""
    if parity:
        if xs.dtype != torch.float64:
            raise ValueError("stonemask: the bucket path (parity) takes "
                             "float64 waveforms")
        return _stonemask_buckets(xs, fs, temporal_positions, f0, f0_floor,
                                  f0_ceil)
    B, T = f0.shape
    buckets = stonemask_buckets(fs, f0_floor, f0_ceil)
    B_max = buckets[-1]
    h_cap = (B_max // 2 - 1) // 2
    width = min(B_max, -(-(2 * h_cap + 1) // 128) * 128)

    gate = (f0 <= cfg.K_FLOOR_F0_STONEMASK) | (f0 > fs / 12.0)
    f0s = torch.where(gate, torch.full_like(f0, 100.0), f0).reshape(-1)
    gate = gate.reshape(-1)
    pos = temporal_positions.expand(B, T).reshape(-1)
    h = torch.clamp(prims.rdiv(1.5 * fs, f0s) + 1.0, max=2.0 ** 30).long()
    if grid_step <= 0:
        # the bucket path: a frame whose DFT size (from its own h, in the
        # waveform's dtype) is no bucket's stays 0; the others' windows
        # are at most B_c/2 <= B_max/2 samples, so h needs no cap there
        bc = frame_fft_size(h, xs.dtype)
        gate = gate | (bc < buckets[0]) | (bc > B_max)
    h = torch.clamp(h, max=h_cap)
    origin = frames.frame_origins(prims.matlab_round_i(pos * fs), T,
                                  grid_step, 4) - 1
    segm, segd = frames.frame_windows(xs, origin, h, f0s, fs, 0.0, width,
                                      frames.STONEMASK, pos=pos)
    smr, smi = fftmat.rfft(segm, B_max)
    sdr, sdi = fftmat.rfft(segd, B_max)
    return if_readout(smr, smi, sdr, sdi, f0s, h, gate, fs,
                      B_max).reshape(B, T)


def _stonemask_buckets(xs, fs: int, temporal_positions, f0,
                       f0_floor: float, f0_ceil: float):
    """The bucket path (stonemask.py:170-226) for float64 xs (B, L), f0
    (B, T): per bucket B_c, its frames (compacted: one host read of the
    bucket's frame count), windowed at W = B_c/2 by K1, transformed at
    B_c, read out by K24 at stride 1; frames in no bucket stay 0."""
    B, T = f0.shape
    dev, dtype = xs.device, xs.dtype
    f0r = f0.reshape(-1)
    pos = temporal_positions.expand(B, T).reshape(-1).to(dtype)
    gate = (f0r <= cfg.K_FLOOR_F0_STONEMASK) | (f0r > fs / 12.0)
    f0s = torch.where(gate, torch.full_like(f0r, 100.0), f0r)
    h = torch.trunc(prims.rdiv(1.5 * fs, f0s) + 1.0).long()
    frame_fft = frame_fft_size(h, dtype)
    utt = torch.arange(B * T, device=dev) // T
    refined = torch.zeros_like(f0r)
    for b_c in stonemask_buckets(fs, f0_floor, f0_ceil):
        rows = torch.nonzero((frame_fft == b_c) & ~gate)[:, 0]
        if rows.numel() == 0:
            continue
        # STONEMASK with parity places each sample from pos (origin unused)
        segm, segd = frames.frame_windows(
            xs, h[rows], h[rows], f0s[rows], fs, 0.0, b_c // 2,
            frames.STONEMASK, pos=pos[rows], rowutt=utt[rows], parity=True)
        sm = torch.fft.rfft(segm, n=b_c, dim=1)
        sd = torch.fft.rfft(segd, n=b_c, dim=1)
        refined[rows] = if_readout(sm.real, sm.imag, sd.real, sd.imag,
                                   f0s[rows], h[rows], gate[rows], fs, b_c)
    return torch.where(gate, torch.zeros_like(refined), refined).reshape(
        B, T)


# The order of the six-term sums, written out so that the twin and K24 add
# alike: the order a CPU build of torch.sum was seen to take over a row of
# six float32 (the JAX package's and the port's earlier jnp.sum /
# torch.sum), which keeps the CPU results where they were.  It is no
# contract of torch's: the twin no longer calls torch.sum here.
SUM_ORDER = (0, 4, 5, 1, 2, 3)


def if_readout_plain(smr, smi, sdr, sdi, f0s, h, gate, fs: int, b_max: int):
    """The harmonic IF readout (stonemask.cpp:119-168): rows of the
    B_max-point DFTs of the window (smr, smi) and of its derivative (sdr,
    sdi), the seed f0s, the half widths h and the gate (R,) -> refined f0
    (R,), 0 where gated.  The six-term sums add in SUM_ORDER, as K24 does;
    2 pi is float32's in float32 rows, double's in float64 rows."""
    dtype, dev = smr.dtype, smr.device
    two_pi = (2.0 * np.pi if dtype == torch.float64
              else float(np.float32(2.0 * np.pi)))
    # per-frame fft size B_c and its bin stride
    bc = frame_fft_size(h, dtype)
    r = (b_max // 4) // (bc // 4)
    bcf = bc.to(dtype)
    ks = torch.arange(1, 7, dtype=dtype, device=dev)
    k6 = torch.arange(6, device=dev)

    def fix(f0_seed, n_harmonics: int):
        idx_c = prims.matlab_round_i(
            prims.exact_div(f0_seed * bcf, fs)[:, None] * ks)
        idx_c = torch.minimum(torch.clamp(idx_c, min=0), (bc // 2)[:, None])
        idx = idx_c * r[:, None]
        a, b, c, d = (torch.gather(t, 1, idx) for t in (smr, smi, sdr, sdi))
        p = a * a + b * b
        n = a * d - b * c
        inst = torch.where(
            p == 0.0, torch.zeros_like(p),
            (idx_c.to(dtype) * fs) / bcf[:, None]
            + prims.exact_div(n / p * fs, two_pi))
        amp = torch.sqrt(p)
        mask = (k6 < n_harmonics).to(dtype)
        tn, td = amp * inst * mask, amp * ks * mask
        num, den = tn[:, 0], td[:, 0]
        for k in SUM_ORDER[1:]:
            num = num + tn[:, k]
            den = den + td[:, k]
        return num / (den + cfg.K_MY_SAFE_GUARD_MINIMUM)

    t1 = fix(f0s, 2)
    ok1 = (t1 > 0.0) & (t1 <= f0s * 2.0)
    t2 = fix(t1, 6)            # seeded with t1, like the bucket path
    mean_f0 = torch.where(ok1, t2, torch.zeros_like(t2))
    refined = torch.where(torch.abs(mean_f0 - f0s) / f0s > 0.2, f0s, mean_f0)
    return torch.where(gate, torch.zeros_like(refined), refined)


def if_readout(smr, smi, sdr, sdi, f0s, h, gate, fs: int, b_max: int):
    """K24: `if_readout_plain` with one thread a frame reading only the
    <= 12 harmonic bins of each DFT row it needs; f32 or f64 rows (R,
    b_max/2+1), f0s (R,), h (R,) integers, gate (R,) bool."""
    if not smr.is_cuda:
        return if_readout_plain(smr, smi, sdr, sdi, f0s, h, gate, fs, b_max)
    R, H = smr.shape
    dt = smr.dtype
    if dt not in (torch.float32, torch.float64) or H != b_max // 2 + 1 \
            or f0s.shape != (R,):
        raise ValueError("if_readout: f32 or f64 rows (R, b_max/2+1) and "
                         "f0s (R,)")
    f64 = dt == torch.float64
    sp = [t.to(dt).contiguous() for t in (smr, smi, sdr, sdi)]
    f0c = f0s.to(dt).contiguous()
    hc = h.to(torch.int32).contiguous()
    gc = gate.to(torch.uint8).contiguous()
    kernels.check_cuda("if_readout", *sp, f0c, hc, gc)
    out = torch.empty(R, dtype=dt, device=smr.device)
    kernels.launch("stonemask_if", [
        *(t.data_ptr() for t in sp), R, H, f0c.data_ptr(), hc.data_ptr(),
        gc.data_ptr(), float(fs), b_max, int(f64), out.data_ptr()],
        dict(smr=sp[0], smi=sp[1], sdr=sp[2], sdi=sp[3], f0s=f0c, h=h,
             gate=gate, fs=fs, b_max=b_max), variant="f64" if f64 else None)
    return out
