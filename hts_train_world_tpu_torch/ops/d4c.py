"""D4C band aperiodicity, f32 fast path on the regular frame grid.

Counterpart of the slab branch of `hts_train_world_tpu/ops/d4c.py`
(externs/WORLD_v2/src/d4c.cpp):
- LoveTrain (d4c.cpp:258-282): per-frame V/UV from cumulative band power
  at 4000 / 7900 Hz of a Blackman window (K1, MEAN mode);
- main body (d4c.cpp:290-316): two unit-energy centroid windows at
  +-0.25/f0 and their index-weighted twins (K1, CENTROID mode), the Hann
  power spectrum (K1, MEAN mode), DC correction and three linear
  smoothings (K2), the static group delay, and the coarse aperiodicity of
  each 3 kHz band from an exact top-k sum (K3);
- `to_full`: interpolation onto the CheapTrick frequency axis.
"""
from __future__ import annotations

import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch.ops import fftmat, frames, prims


def _round_up(n: int, m: int = 128) -> int:
    return -(-n // m) * m


def _love_train(xs, fs: int, f0, origin):
    """D4CLoveTrain (d4c.cpp:258-282) -> aperiodicity0 per frame (R,)."""
    n = cfg.d4c_love_train_fft_size(fs)
    b0 = int(-(-100.0 * n // fs))   # ceil
    b1 = int(-(-4000.0 * n // fs))
    b2 = int(-(-7900.0 * n // fs))
    h_cap = int(1.5 * fs / 40.0 + 1.0)
    width = min(n, _round_up(2 * h_cap + 1))
    lf0 = torch.clamp(f0, min=40.0)
    h = torch.clamp(prims.matlab_round_i(
        prims.exact_div(prims.rdiv(3.0 * fs, lf0), 2.0)), max=h_cap)
    wave, _ = frames.frame_windows(xs, origin, h, lf0, fs, 3.0, width,
                                   frames.MEAN_BLACKMAN)
    p = fftmat.rfft_power_matmul(wave, n)
    k = torch.arange(n // 2 + 1, device=xs.device)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    p = torch.where(k <= b0, zero, p)
    c = torch.cumsum(torch.where(k <= b2, p, zero), dim=1)
    ap0 = c[:, b1] / torch.clamp(c[:, b2], min=prims.tiny_floor(p.dtype))
    return torch.where(f0 == 0.0, zero, ap0)


def _coarse_aperiodicity(sgd, fs: int, fft_d: int, n_ap: int):
    """GetCoarseAperiodicity (d4c.cpp:192-223) for rows sgd (R, N/2+1)
    -> (R, n_ap) in dB: each band's Nuttall-windowed slice, its power
    spectrum, and 10*log10((total - sum of the top b+1) / total)."""
    window_length = int(cfg.K_FREQUENCY_INTERVAL * fft_d / fs) * 2 + 1
    window = torch.as_tensor(prims.nuttall_window_np(window_length),
                             dtype=sgd.dtype, device=sgd.device)
    boundary = int(fft_d * 8.0 / window_length + 0.5)
    hw = window_length // 2
    segs = torch.stack([
        sgd[:, c - hw:c - hw + window_length]
        for c in (int(cfg.K_FREQUENCY_INTERVAL * (i + 1) * fft_d / fs)
                  for i in range(n_ap))], dim=1) * window
    R = sgd.shape[0]
    p = fftmat.rfft_power_matmul(segs, fft_d).reshape(R * n_ap, -1)
    den = p.sum(dim=1)
    num = den - prims.sum_top_k(p, boundary + 1)
    tiny = prims.tiny_floor(p.dtype)
    return (10.0 * torch.log10(torch.clamp(num, min=tiny)
                               / torch.clamp(den, min=tiny))
            ).reshape(R, n_ap)


def to_full(coarse, fs: int, fft_size: int):
    """GetAperiodicity (d4c.cpp:325-333): coarse dB bands (R, n_ap) ->
    linear aperiodicity on the CheapTrick axis (R, fft_size/2+1)."""
    dtype, dev = coarse.dtype, coarse.device
    n_ap = coarse.shape[1]
    coarse_axis = torch.cat([
        torch.arange(n_ap + 1, dtype=dtype, device=dev)
        * cfg.K_FREQUENCY_INTERVAL,
        torch.full((1,), fs / 2.0, dtype=dtype, device=dev)])
    freq_axis = prims.exact_div(
        torch.arange(fft_size // 2 + 1, dtype=dtype, device=dev) * fs,
        fft_size)
    R = coarse.shape[0]
    vals = torch.cat([torch.full((R, 1), -60.0, dtype=dtype, device=dev),
                      coarse,
                      torch.full((R, 1), -cfg.K_MY_SAFE_GUARD_MINIMUM,
                                 dtype=dtype, device=dev)], dim=1)
    return torch.pow(10.0, prims.exact_div(
        prims.interp1(coarse_axis, vals, freq_axis), 20.0))


def d4c(xs, fs: int, temporal_positions, f0, fft_size: int,
        threshold: float = cfg.K_THRESHOLD, f0_floor: float = cfg.K_FLOOR_F0,
        grid_step: int = 0):
    """D4C (d4c.cpp:337-397) for f32 xs (B, L), f0 (B, T) ->
    (aperiodicity (B, T, fft_size/2+1), LoveTrain ratio (B, T)).
    fft_size is the CheapTrick (output) size; `f0_floor` (the F0
    estimator's floor) sizes the window trim."""
    if grid_step <= 0:
        raise NotImplementedError(
            "the port implements D4C on the regular frame grid only "
            "(grid_step > 0); the parity path is a later slice")
    dtype, dev = xs.dtype, xs.device
    B, T = f0.shape
    fft_d = cfg.d4c_fft_size(fs)
    n_ap = cfg.number_of_aperiodicities(fs)
    fmax = max(fs / 12.0, cfg.K_CEIL_F0)
    ul_max = 2 + int(fmax * fft_d / fs) + 1
    b_max = int(fmax * fft_d / fs) + 1

    # processed frames carry f0 >= f0_floor and the body clamps at 47 Hz,
    # so windows are at most 2*h_cap+1 wide (d4c.py's fast-mode trim)
    eff_floor = max(float(f0_floor), cfg.K_FLOOR_F0_D4C)
    h_cap = int(2.0 * fs / eff_floor + 1.0)
    width = min(fft_d, _round_up(2 * h_cap + 1))
    margin = int(0.25 * fs / eff_floor) + 2   # centroid +-0.25/f0 clip

    f0r = f0.reshape(-1)
    pos = temporal_positions.expand(B, T).reshape(-1)
    base = (torch.arange(T, device=dev) * grid_step).repeat(B)
    s_reg = torch.clamp(prims.matlab_round_i(pos * fs + 0.001) - base, -2, 2)

    ap0 = _love_train(xs, fs, f0r, base + s_reg)
    process = (f0r != 0.0) & (ap0 > threshold)
    cf0 = torch.where(process, torch.clamp(f0r, min=cfg.K_FLOOR_F0_D4C),
                      torch.full_like(f0r, 100.0))

    h = torch.clamp(prims.matlab_round_i(
        prims.exact_div(prims.rdiv(4.0 * fs, cf0), 2.0)), max=h_cap)
    quarter = prims.rdiv(0.25, cf0)

    def centroid(shift):
        s = prims.matlab_round_i((pos + shift) * fs + 0.001) - base
        origin = base + torch.clamp(s, -margin, margin)
        r1_in, r2_in = frames.frame_windows(xs, origin, h, cf0, fs, 4.0,
                                            width, frames.CENTROID)
        r1, i1 = fftmat.rfft_matmul(r1_in, fft_d)
        r2, i2 = fftmat.rfft_matmul(r2_in, fft_d)
        return r2 * r1 + i1 * i2

    sc = prims.dc_correction(centroid(-quarter) + centroid(quarter), cf0, fs,
                             fft_d, ul_max)
    wave, _ = frames.frame_windows(xs, base + s_reg, h, cf0, fs, 4.0, width,
                                   frames.MEAN)
    sps = prims.smooth_spectrum(fftmat.rfft_power_matmul(wave, fft_d), fs,
                                fft_d, f0=cf0, ul_max=ul_max, width=cf0,
                                b_max=b_max)
    # GetStaticGroupDelay (d4c.cpp:170-186); f32 noise-floor bins can
    # underflow sps and blow the ratio up: sanitize
    sgd = sc / sps
    sgd = torch.where(torch.isfinite(sgd), sgd, torch.zeros((), dtype=dtype,
                                                            device=dev))
    sgd = prims.linear_smoothing(sgd, prims.exact_div(cf0, 2.0), fs, fft_d,
                                 b_max)
    sgd = sgd - prims.linear_smoothing(sgd, cf0, fs, fft_d, b_max)
    ca = _coarse_aperiodicity(sgd, fs, fft_d, n_ap)
    coarse = torch.clamp(ca + prims.exact_div(cf0 - 100.0, 50.0)[:, None],
                         max=0.0)                    # d4c.cpp:309-311

    ap = to_full(coarse, fs, fft_size)
    ap = torch.where(process[:, None], ap,
                     torch.full_like(ap, 1.0 - cfg.K_MY_SAFE_GUARD_MINIMUM))
    return ap.reshape(B, T, -1), ap0.reshape(B, T)
