"""StoneMask F0 refinement, f32 fast path on the regular frame grid.

Counterpart of `hts_train_world_tpu/ops/stonemask.py:_stonemask_slab`
(externs/WORLD_v2/src/stonemask.cpp): each frame's Blackman window and its
centred-difference derivative (kernel K1, STONEMASK mode), ONE B_max-point
DFT of each, and the harmonic instantaneous-frequency readout at bin stride
r = B_max / B_c, which equals the frame's own B_c-point DFT because every
window is zero beyond its 2h+1 samples.  The IF readouts |sm|^2 and
Im(conj(sm) sd) do not depend on where the window sits in its row.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from hts_train_world_tpu_torch import config as cfg
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
    dtype, dev = xs.dtype, xs.device
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
    power = smr * smr + smi * smi
    numer = smr * sdi - smi * sdr

    # per-frame fft size B_c = 4 * 2^floor(log2(2h+1)) and its bin stride
    e_c = torch.floor(torch.log((2 * h + 1).to(dtype))
                      / cfg.K_LOG2).long()
    bc = 4 * torch.pow(2, e_c)
    r = (B_max // 4) // (bc // 4)
    bcf = bc.to(dtype)
    ks = torch.arange(1, 7, dtype=dtype, device=dev)
    k6 = torch.arange(6, device=dev)

    def fix(f0_seed, n_harmonics: int):
        idx_c = prims.matlab_round_i(
            prims.exact_div(f0_seed * bcf, fs)[:, None] * ks)
        idx_c = torch.minimum(torch.clamp(idx_c, min=0), (bc // 2)[:, None])
        idx = idx_c * r[:, None]
        p = torch.gather(power, 1, idx)
        n = torch.gather(numer, 1, idx)
        inst = torch.where(
            p == 0.0, torch.zeros_like(p),
            (idx_c.to(dtype) * fs) / bcf[:, None]
            + prims.exact_div(n / p * fs, float(np.float32(2.0 * np.pi))))
        amp = torch.sqrt(p)
        mask = (k6 < n_harmonics).to(dtype)
        num = torch.sum(amp * inst * mask, dim=1)
        den = torch.sum(amp * ks * mask, dim=1)
        return num / (den + cfg.K_MY_SAFE_GUARD_MINIMUM)

    t1 = fix(f0s, 2)
    ok1 = (t1 > 0.0) & (t1 <= f0s * 2.0)
    t2 = fix(t1, 6)            # seeded with t1, like the bucket path
    mean_f0 = torch.where(ok1, t2, torch.zeros_like(t2))
    refined = torch.where(torch.abs(mean_f0 - f0s) / f0s > 0.2, f0s, mean_f0)
    return torch.where(gate, torch.zeros_like(f0),
                       refined.reshape(B, T))
