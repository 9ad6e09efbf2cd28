"""StoneMask F0 refinement, f32 fast path on the regular frame grid.

Counterpart of `hts_train_world_tpu/ops/stonemask.py:_stonemask_slab`
(externs/WORLD_v2/src/stonemask.cpp): each frame's Blackman window and its
centred-difference derivative (kernel K1, STONEMASK mode), ONE B_max-point
DFT of each, and the harmonic instantaneous-frequency readout at bin stride
r = B_max / B_c, which equals the frame's own B_c-point DFT because every
window is zero beyond its 2h+1 samples.  The IF readouts |sm|^2 and
Im(conj(sm) sd) do not depend on where the window sits in its row.

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
              f0_ceil: float = cfg.K_CEIL_F0, grid_step: int = 0):
    """StoneMask (stonemask.cpp:211-217) for f32 xs (B, L) and f0 (B, T)
    on the regular frame grid (grid_step samples per frame)."""
    if grid_step <= 0:
        raise NotImplementedError(
            "the port implements StoneMask on the regular frame grid only "
            "(grid_step > 0); the bucketed parity path is a later slice")
    dev = xs.device
    B, T = f0.shape
    B_max = stonemask_buckets(fs, f0_floor, f0_ceil)[-1]
    h_cap = (B_max // 2 - 1) // 2
    width = min(B_max, -(-(2 * h_cap + 1) // 128) * 128)

    gate = (f0 <= cfg.K_FLOOR_F0_STONEMASK) | (f0 > fs / 12.0)
    f0s = torch.where(gate, torch.full_like(f0, 100.0), f0).reshape(-1)
    pos = temporal_positions.expand(B, T).reshape(-1)
    base = (torch.arange(T, device=dev) * grid_step).repeat(B)
    h = torch.clamp(prims.rdiv(1.5 * fs, f0s) + 1.0, max=2.0 ** 30).long()
    h = torch.clamp(h, max=h_cap)
    s0 = torch.clamp(prims.matlab_round_i(pos * fs) - base, -4, 4)
    segm, segd = frames.frame_windows(xs, base + s0 - 1, h, f0s, fs, 0.0,
                                      width, frames.STONEMASK, pos=pos)
    smr, smi = fftmat.rfft_matmul(segm, B_max)
    sdr, sdi = fftmat.rfft_matmul(segd, B_max)
    return if_readout(smr, smi, sdr, sdi, f0s, h, gate.reshape(-1), fs,
                      B_max).reshape(B, T)


# The order of the six-term sums, written out so that the twin and K24 add
# alike: the order a CPU build of torch.sum was seen to take over a row of
# six float32 (the JAX package's and the port's earlier jnp.sum /
# torch.sum), which keeps the CPU results where they were.  It is no
# contract of torch's: the twin no longer calls torch.sum here.
SUM_ORDER = (0, 4, 5, 1, 2, 3)


def if_readout_plain(smr, smi, sdr, sdi, f0s, h, gate, fs: int, b_max: int):
    """The harmonic IF readout (stonemask.cpp:119-168 on the fixed grid):
    rows of the B_max-point DFTs of the window (smr, smi) and of its
    derivative (sdr, sdi), the seed f0s, the half widths h and the gate
    (R,) -> refined f0 (R,), 0 where gated.  The six-term sums add in
    SUM_ORDER, as K24 does."""
    dtype, dev = smr.dtype, smr.device
    # per-frame fft size B_c = 4 * 2^floor(log2(2h+1)) and its bin stride
    e_c = torch.floor(torch.log((2 * h + 1).to(dtype))
                      / cfg.K_LOG2).long()
    bc = 4 * torch.pow(2, e_c)
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
            + prims.exact_div(n / p * fs, float(np.float32(2.0 * np.pi))))
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
    <= 12 harmonic bins of each DFT row it needs; f32 rows (R, b_max/2+1),
    f0s (R,) f32, h (R,) integers, gate (R,) bool."""
    if not smr.is_cuda:
        return if_readout_plain(smr, smi, sdr, sdi, f0s, h, gate, fs, b_max)
    R, H = smr.shape
    if smr.dtype != torch.float32 or H != b_max // 2 + 1 \
            or f0s.shape != (R,):
        raise ValueError("if_readout: f32 rows (R, b_max/2+1) and f0s (R,)")
    sp = [t.contiguous() for t in (smr, smi, sdr, sdi)]
    f0c = f0s.to(torch.float32).contiguous()
    hc = h.to(torch.int32).contiguous()
    gc = gate.to(torch.uint8).contiguous()
    kernels.check_cuda("if_readout", *sp, f0c, hc, gc)
    out = torch.empty(R, dtype=torch.float32, device=smr.device)
    kernels.launch("stonemask_if", [
        *(t.data_ptr() for t in sp), R, H, f0c.data_ptr(), hc.data_ptr(),
        gc.data_ptr(), float(fs), b_max, out.data_ptr()],
        dict(smr=sp[0], smi=sp[1], sdr=sp[2], sdi=sp[3], f0s=f0c, h=h,
             gate=gate, fs=fs, b_max=b_max))
    return out
