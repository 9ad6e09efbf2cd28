"""WORLD waveform synthesis, fast path (cumsum phase), batched.

Counterpart of `hts_train_world_tpu/ops/synthesis.py` with
exact_phase=False (externs/WORLD_v2/src/synthesis.cpp): the time base as a
cumsum of phase increments and a wrapped-phase jump mask; per pulse the
frame-interpolated envelope, the periodic response (min-phase spectrum x
fractional-delay phase -> irfft -> fftshift -> DC remover) and the
aperiodic response (mean-removed noise x min-phase spectrum), all as DFT
matmuls; then overlap-add with `index_add_`.

Every function here is dtype-generic (float32 on the card, float64 in the
tests against the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch.ops import fftmat, prims


def synthesis_stream_len(y_length: int) -> int:
    """Noise draws consumed <= y_length (sum of pulse gaps)."""
    return y_length + 16


def default_max_pulses(y_length: int, fs: int) -> int:
    # pulse rate <= f0_ceil (800) voiced, kDefaultF0 (500) unvoiced; the
    # end-of-contour extrapolation overshoots only within the last frame
    return int(y_length * 810.0 / fs) + 80


def _time_base(f0, frame_period: float, fs: int, y_length: int,
               fft_size: int):
    """GetTimeBase (synthesis.cpp:223-320) for f0 (B, T) -> (if0, ivuv,
    wrap, jump), the first three (B, y_length), jump (B, y_length-1)."""
    dtype, dev = f0.dtype, f0.device
    T = f0.shape[1]
    fp = frame_period / 1000.0
    lowest_f0 = fs / fft_size + 1.0
    zero = torch.zeros((), dtype=dtype, device=dev)
    coarse_time = torch.arange(T + 1, dtype=dtype, device=dev) * fp
    cf0 = torch.where(f0 < lowest_f0, zero, f0)
    cvuv = torch.where(cf0 == 0.0, zero, torch.ones((), dtype=dtype,
                                                    device=dev))
    cf0 = torch.cat([cf0, (cf0[:, -1] * 2 - cf0[:, -2])[:, None]], dim=1)
    cvuv = torch.cat([cvuv, (cvuv[:, -1] * 2 - cvuv[:, -2])[:, None]], dim=1)
    time_axis = prims.exact_div(
        torch.arange(y_length, dtype=dtype, device=dev), float(fs))
    if0 = prims.interp1(coarse_time, cf0, time_axis)
    ivuv = prims.interp1(coarse_time, cvuv, time_axis)
    ivuv = torch.where(ivuv > 0.5, 1.0, 0.0).to(dtype)
    if0 = torch.where(ivuv == 0.0, torch.full_like(if0, cfg.K_DEFAULT_F0),
                      if0)
    total_phase = torch.cumsum(prims.exact_div(2.0 * np.pi * if0, fs), dim=1)
    wrap = torch.remainder(total_phase, 2.0 * np.pi)
    jump = torch.abs(wrap[:, 1:] - wrap[:, :-1]) > np.pi
    return if0, ivuv, wrap, jump


def count_pulses(f0, frame_period: float, fs: int, y_length: int,
                 fft_size: int):
    """Exact fast-mode pulse count per utterance (B,)."""
    _, _, _, jump = _time_base(f0, frame_period, fs, y_length, fft_size)
    return jump.sum(dim=1)


def _dc_remover_np(fft_size: int) -> np.ndarray:
    """GetDCRemover (synthesis.cpp:322-334), numpy f64."""
    half = fft_size // 2
    i = np.arange(half)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (i + 1.0) / (1.0 + fft_size))
    dc = np.sum(w) * 2.0
    w = w / dc
    return np.concatenate([w, w[::-1]])


def synthesis(f0, spectrogram, aperiodicity, fft_size: int,
              frame_period: float, fs: int, y_length: int, stream,
              max_pulses: int = 0):
    """Synthesis (synthesis.cpp:338-397) for a batch: f0 (B, T),
    spectrogram / aperiodicity (B, T, N/2+1), stream (B, >= y_length)
    white noise -> waveform (B, y_length)."""
    dtype, dev = spectrogram.dtype, spectrogram.device
    B, T = f0.shape
    N = fft_size
    half = N // 2
    fp = frame_period / 1000.0
    if not max_pulses:
        max_pulses = default_max_pulses(y_length, fs)
    P = max_pulses
    zero = torch.zeros((), dtype=dtype, device=dev)

    # ---- GetTimeBase (synthesis.cpp:223-320) ----
    _, ivuv, wrap, jump = _time_base(f0, frame_period, fs, y_length, N)
    n_pulses = jump.sum(dim=1, keepdim=True)
    pidx = prims.compact_indices(jump, P, y_length - 2)       # (B, P)
    slot = torch.arange(P, device=dev)[None, :]
    p_valid = slot < n_pulses
    y1 = torch.gather(wrap, 1, pidx) - 2.0 * np.pi
    y2 = torch.gather(wrap, 1, pidx + 1)
    time_shift = prims.exact_div(-y1 / (y2 - y1), float(fs))
    pulse_time = prims.exact_div(pidx.to(dtype), float(fs))
    pidx_next = torch.where(slot + 1 < n_pulses, torch.roll(pidx, -1, dims=1),
                            pidx)
    noise_size = pidx_next - pidx
    noise_off = torch.cumsum(noise_size, dim=1) - noise_size
    vuv = torch.gather(ivuv, 1, pidx)

    # frame interpolation of envelope and aperiodicity at each pulse
    pos = prims.exact_div(pulse_time, fp)
    fl = torch.clamp(torch.floor(pos), max=T - 1).long()
    ce = torch.clamp(torch.ceil(pos), max=T - 1).long()
    frac = (pos - torch.floor(pos))[..., None]
    same = (fl == ce)[..., None]

    def lerp(table):
        a = torch.gather(table, 1, fl[..., None].expand(B, P, half + 1))
        b = torch.gather(table, 1, ce[..., None].expand(B, P, half + 1))
        return torch.where(same, a, a * (1.0 - frac) + b * frac)

    sp_env = lerp(torch.abs(spectrogram))
    ap = lerp(torch.clamp(aperiodicity, 0.001, 0.999999999999))
    apr = ap * ap

    # periodic response (synthesis.cpp:105-138)
    unvoiced = (vuv <= 0.5) | (apr[..., 0] > 0.999)
    log_p = torch.log(sp_env * (1.0 - apr)
                      + cfg.K_MY_SAFE_GUARD_MINIMUM) / 2.0
    coef = prims.exact_div(2.0 * np.pi * time_shift * fs, N)
    re2 = torch.cos(coef[..., None]
                    * torch.arange(half + 1, dtype=dtype, device=dev))
    im2 = torch.sqrt(1.0 - re2 * re2)
    re, im = fftmat.minphase_matmul(log_p, N)
    sre = re * re2 + im * im2
    sim = im * re2 - re * im2
    per = prims.fftshift(fftmat.irfft_scaled_matmul(sre, sim, N))
    dc_rm = torch.as_tensor(_dc_remover_np(N), dtype=dtype, device=dev)
    dc = per[..., half:].sum(dim=-1, keepdim=True)
    kj = torch.arange(N, device=dev)
    per = torch.where(kj < half, -dc * dc_rm, per - dc * dc_rm)
    per = torch.where(unvoiced[..., None], zero, per)

    # aperiodic response (synthesis.cpp:38-68)
    ns = noise_size[..., None]
    stream_p = torch.cat([stream, torch.zeros((B, N), dtype=dtype,
                                              device=dev)], dim=1)
    noise = torch.gather(stream_p, 1, (noise_off[..., None] + kj)
                         .reshape(B, P * N)).reshape(B, P, N)
    noise = torch.where(kj < ns, noise, zero)
    avg = noise.sum(dim=-1, keepdim=True) / torch.clamp(ns, min=1)
    noise = torch.where(kj < ns, noise - avg, zero)
    tiny = prims.tiny_floor(dtype)
    log_a = torch.where(vuv[..., None] != 0.0,
                        torch.log(torch.clamp(sp_env * apr, min=tiny)) / 2.0,
                        torch.log(torch.clamp(sp_env, min=tiny)) / 2.0)
    nre, nim = fftmat.rfft_matmul(noise, N)
    are, aim = fftmat.minphase_matmul(log_a, N)
    aper = prims.fftshift(fftmat.irfft_scaled_matmul(
        are * nre - aim * nim, are * nim + aim * nre, N))

    resp = prims.exact_div(per * torch.sqrt(ns.to(dtype)) + aper, N)
    resp = torch.where((p_valid & (noise_size > 0))[..., None], resp, zero)

    # ---- OLA (synthesis.cpp:378-383): response k of pulse p lands at
    # output sample pidx + 1 + k - half; skipped slots add exact zeros ----
    Lb = y_length + N + 1
    out = torch.zeros(B * Lb, dtype=dtype, device=dev)
    at = ((torch.arange(B, device=dev) * Lb)[:, None, None]
          + (pidx + 1)[..., None] + kj)
    out.index_add_(0, at.reshape(-1), resp.reshape(-1))
    return out.reshape(B, Lb)[:, half:half + y_length]
