"""CheapTrick spectral envelope, f32 fast path on the regular frame grid.

Counterpart of the slab branch of `hts_train_world_tpu/ops/cheaptrick.py`
(externs/WORLD_v2/src/cheaptrick.cpp): per frame a pitch-adaptive Hann
window scaled to unit energy with its weighted mean removed (kernel K1,
CHEAPTRICK mode), the power spectrum as a DFT matmul, DC correction and
linear smoothing over 2*f0/3 (kernel K2), a floor relative to the frame
peak, and the cepstral lifter as two matmuls.

The floor and log, the lifter and the exp are kernel K25
(csrc/cheaptrick_lifter.cu, `lifter`, one launch each around the two
matmuls), with the plain PyTorch twin `lifter_plain`: the wrapper launches
the kernel for CUDA tensors and runs the twin only for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import fftmat, frames, prims


def _max_f0(fs: int) -> float:
    # voiced f0 <= fs/12 after StoneMask; unvoiced frames use kDefaultF0;
    # raw DIO can reach f0_ceil.  Static bound for the smoothing extents.
    return max(fs / 12.0, cfg.K_DEFAULT_F0, cfg.K_CEIL_F0)


def cheaptrick(xs, fs: int, temporal_positions, f0, fft_size: int = 0,
               q1: float = -0.15, grid_step: int = 0):
    """CheapTrick (cheaptrick.cpp:200-228) for f32 xs (B, L), f0 (B, T)
    -> spectrogram (B, T, N/2+1)."""
    if grid_step <= 0:
        raise NotImplementedError(
            "the port implements CheapTrick on the regular frame grid only "
            "(grid_step > 0); the parity path is a later slice")
    dtype, dev = xs.dtype, xs.device
    B, T = f0.shape
    N = fft_size or cfg.cheaptrick_fft_size(fs)
    half = N // 2
    f0_floor = cfg.cheaptrick_f0_floor(fs, N)
    fmax = _max_f0(fs)
    ul_max = 2 + int(fmax * N / fs) + 1
    b_max = int(fmax * 2.0 / 3.0 * N / fs) + 1
    h_cap = int(1.5 * fs / f0_floor + 0.5) + 1
    width = min(N, -(-(2 * h_cap + 1) // 128) * 128)

    cf0 = torch.where(f0 <= f0_floor, torch.full_like(f0, cfg.K_DEFAULT_F0),
                      f0).reshape(-1)
    pos = temporal_positions.expand(B, T).reshape(-1)
    base = (torch.arange(T, device=dev) * grid_step).repeat(B)
    s_reg = torch.clamp(prims.matlab_round_i(pos * fs + 0.001) - base, -2, 2)
    h = torch.clamp(prims.matlab_round_i(prims.rdiv(1.5 * fs, cf0)),
                    max=h_cap)
    wave, _ = frames.frame_windows(xs, base + s_reg, h, cf0, fs, 3.0, width,
                                   frames.CHEAPTRICK)
    ps = fftmat.rfft_power_matmul(wave, N)
    ps = prims.smooth_spectrum(ps, fs, N, f0=cf0, ul_max=ul_max,
                               width=prims.exact_div(cf0 * 2.0, 3.0),
                               b_max=b_max)
    creal = fftmat.matmul(lifter(ps, LOG),
                          fftmat.sym_rfft_real_mat(N, dtype, dev))
    spec2 = lifter(creal, LIFTER, cf0, fs, N, q1)
    A, _ = fftmat.irfft_half_mats(N, dtype, dev)
    return lifter(fftmat.matmul(spec2, A), EXP).reshape(B, T, half + 1)


LOG, LIFTER, EXP = 0, 1, 2      # K25's three stages


def lifter_plain(x, stage: int, cf0=None, fs: int = 0, fft_size: int = 0,
                 q1: float = 0.0):
    """One stage of the chain around the cepstrum matmuls, rows x (R,
    N/2+1): LOG, the floor relative to the frame peak and the log; LIFTER,
    SmoothingWithRecovery's sl * cl / N (cheaptrick.cpp:22-57) for the
    frames' f0 cf0 (R,); EXP, the exp."""
    dtype, dev = x.dtype, x.device
    if stage == LOG:
        # f32 smoothing cancellation makes valleys below ~1e-7 of the
        # frame peak meaningless; floor relative to the peak (a tiny
        # absolute floor puts log(denormal) spikes into the lifter)
        floor = torch.clamp(x.amax(dim=1, keepdim=True) * 1e-7,
                            min=prims.tiny_floor(dtype))
        return torch.log(torch.maximum(x, floor))
    if stage == EXP:
        return torch.exp(x)
    half = fft_size // 2
    q = prims.exact_div(torch.arange(half + 1, dtype=dtype, device=dev), fs)
    qf = (float(np.float32(np.pi)) * cf0)[:, None] * q
    sl = torch.where(torch.arange(half + 1, device=dev) == 0,
                     torch.ones((), dtype=dtype, device=dev),
                     torch.sin(qf) / qf)
    cl = (1.0 - 2.0 * q1) + (2.0 * q1) * torch.cos(
        (2.0 * np.pi) * q * cf0[:, None])
    return prims.exact_div(x * sl * cl, fft_size)


def lifter(x, stage: int, cf0=None, fs: int = 0, fft_size: int = 0,
           q1: float = 0.0):
    """K25: `lifter_plain` of f32 rows x (R, N/2+1) in one launch."""
    if not x.is_cuda:
        return lifter_plain(x, stage, cf0, fs, fft_size, q1)
    R, H = x.shape
    if x.dtype != torch.float32 or stage not in (LOG, LIFTER, EXP) \
            or (stage == LIFTER and (H != fft_size // 2 + 1
                                     or cf0.shape != (R,))):
        raise ValueError("lifter: f32 rows (R, N/2+1), a stage of 0-2 and "
                         "cf0 (R,) for the lifter")
    x = x.contiguous()
    cf0c = cf0.to(torch.float32).contiguous() if stage == LIFTER else None
    kernels.check_cuda("lifter", x, *([cf0c] if cf0c is not None else []))
    out = torch.empty_like(x)
    kernels.launch("cheaptrick_lifter", [
        stage, x.data_ptr(), cf0c.data_ptr() if cf0c is not None else None,
        R, H, float(fs), fft_size, float(np.float32(1.0 - 2.0 * q1)),
        float(np.float32(2.0 * q1)), prims.tiny_floor(torch.float32),
        out.data_ptr()],
        dict(x=x, stage=stage, cf0=cf0c, fs=fs, fft_size=fft_size, q1=q1))
    return out
