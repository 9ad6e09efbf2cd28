"""CheapTrick spectral envelope.

Counterpart of `hts_train_world_tpu/ops/cheaptrick.py`
(externs/WORLD_v2/src/cheaptrick.cpp).  The f32 fast path runs per frame
a pitch-adaptive Hann window scaled to unit energy with its weighted mean
removed (kernel K1, CHEAPTRICK mode), the power spectrum (K39), DC
correction and linear smoothing over 2*f0/3 (kernel K2), a floor relative
to the frame peak, and the cepstral lifter around two inverse FFTs (K40).
Each window sits at round(pos*fs + 0.001) of its frame's position: on a
frame grid of a whole number of samples held within 2 samples of its grid
point (the JAX package's slab branch), on any other grid where it falls
(its generic float32 frame, cheaptrick.py:127-148 with the edge-padded
`xp`).

The float64 parity path (`cheaptrick_parity`, the JAX package's f64
frame, cheaptrick.py:127-191) places each window at its own position with
the reference's noise (K1 in float64), takes the power by `torch.fft`,
smooths in the reference's order (K2's parity mode), adds |randn| * eps
and floors at the absolute tiny before the log (K25's float64 LOG stage),
and lifters through the symmetric rfft and its irfft.  Its noise comes
from the reseeded stream at per-frame offsets kept on the device
(`noise_offsets`).

The floor and log, the lifter and the exp are kernel K25
(csrc/cheaptrick_lifter.cu, `lifter`, one launch each around the two
transforms), with the plain PyTorch twin `lifter_plain`: the wrapper
launches the kernel for CUDA tensors and runs the twin only for CPU
tensors.
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


def cheaptrick_stream_len(f0_length: int, fft_size: int) -> int:
    """Upper bound on the draws one utterance consumes (cheaptrick.py:29-
    32): a window of 2h+1 <= N-2 draws and N/2+1 spectral draws a frame."""
    return f0_length * (fft_size - 1 + fft_size // 2 + 1) + 16


def noise_offsets(f0, fs: int, fft_size: int):
    """CheapTrick's use of the reseeded stream (cheaptrick_noise,
    cheaptrick.py:35-53): frame by frame, 2h+1 window draws then N/2+1
    spectral draws, h = round(1.5 fs / f0) with f0 at 500 Hz below the
    floor.  f0 (B, T) -> (window offsets, spectral offsets) (B*T,) int64
    on f0's device: cumulative sums of the counts, so no host read."""
    f0_floor = cfg.cheaptrick_f0_floor(fs, fft_size)
    cf0 = torch.where(f0 <= f0_floor, torch.full_like(f0, cfg.K_DEFAULT_F0),
                      f0)
    h = prims.matlab_round_i(prims.rdiv(1.5 * fs, cf0))
    counts = 2 * h + 1 + fft_size // 2 + 1
    off = torch.cumsum(counts, dim=1) - counts
    return off.reshape(-1), (off + 2 * h + 1).reshape(-1)


def cheaptrick_parity(xs, fs: int, temporal_positions, f0,
                      fft_size: int = 0, q1: float = -0.15, stream=None):
    """CheapTrick's parity path (cheaptrick.py:127-191 in float64) for
    float64 xs (B, L), f0 (B, T) at any temporal positions (T,) or (B,
    T), on the reseeded `stream` (each utterance reads it from its start)
    -> spectrogram (B, T, N/2+1)."""
    dtype, dev = xs.dtype, xs.device
    B, T = f0.shape
    N = fft_size or cfg.cheaptrick_fft_size(fs)
    half = N // 2
    f0_floor = cfg.cheaptrick_f0_floor(fs, N)
    fmax = _max_f0(fs)
    ul_max = 2 + int(fmax * N / fs) + 1
    b_max = int(fmax * 2.0 / 3.0 * N / fs) + 1
    cf0 = torch.where(f0 <= f0_floor, torch.full_like(f0, cfg.K_DEFAULT_F0),
                      f0).reshape(-1)
    pos = temporal_positions.expand(B, T).reshape(-1).to(dtype)
    origin = prims.matlab_round_i(pos * fs + 0.001)
    h = prims.matlab_round_i(prims.rdiv(1.5 * fs, cf0))
    win_off, spec_off = noise_offsets(f0, fs, N)
    wave, _ = frames.frame_windows(xs, origin, h, cf0, fs, 3.0, N,
                                   frames.CHEAPTRICK, noise=stream,
                                   noff=win_off)
    spec = torch.fft.rfft(wave, dim=1)
    ps = spec.real * spec.real + spec.imag * spec.imag
    ps = prims.smooth_spectrum(ps, fs, N, f0=cf0, ul_max=ul_max,
                               width=prims.exact_div(cf0 * 2.0, 3.0),
                               b_max=b_max, parity=True)
    log_ps = lifter(ps, LOG, noise=stream, noff=spec_off, parity=True)
    sym = torch.cat([log_ps, log_ps[:, 1:half].flip(1)], dim=1)
    creal = torch.fft.rfft(sym, dim=1).real    # the conjugate's real part
    spec2 = lifter(creal.contiguous(), LIFTER, cf0, fs, N, q1)
    wave2 = torch.fft.irfft(torch.complex(spec2, torch.zeros_like(spec2)),
                            n=N, dim=1) * N
    return lifter(wave2[:, :half + 1].contiguous(), EXP).reshape(
        B, T, half + 1)


def cheaptrick(xs, fs: int, temporal_positions, f0, fft_size: int = 0,
               q1: float = -0.15, grid_step: int = 0):
    """CheapTrick (cheaptrick.cpp:200-228) fast path for f32 xs (B, L),
    f0 (B, T) -> spectrogram (B, T, N/2+1): on the regular frame grid of
    grid_step samples, or with grid_step 0 at any temporal positions (T,)
    or (B, T)."""
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
    origin = frames.frame_origins(prims.matlab_round_i(pos * fs + 0.001), T,
                                  grid_step, 2)
    # cf0 > f0_floor keeps h under the cap (cheaptrick.cpp:196-198)
    h = torch.clamp(prims.matlab_round_i(prims.rdiv(1.5 * fs, cf0)),
                    max=h_cap)
    wave, _ = frames.frame_windows(xs, origin, h, cf0, fs, 3.0, width,
                                   frames.CHEAPTRICK)
    ps = fftmat.rfft_power(wave, N)
    ps = prims.smooth_spectrum(ps, fs, N, f0=cf0, ul_max=ul_max,
                               width=prims.exact_div(cf0 * 2.0, 3.0),
                               b_max=b_max)
    creal = fftmat.sym_rfft_real(lifter(ps, LOG), N)
    spec2 = lifter(creal, LIFTER, cf0, fs, N, q1)
    return lifter(fftmat.irfft_half(spec2, N), EXP).reshape(B, T, half + 1)


LOG, LIFTER, EXP = 0, 1, 2      # K25's three stages


def lifter_plain(x, stage: int, cf0=None, fs: int = 0, fft_size: int = 0,
                 q1: float = 0.0, noise=None, noff=None,
                 parity: bool = False):
    """One stage of the chain around the cepstrum transforms, rows x (R,
    N/2+1): LOG, the floor and the log; LIFTER, SmoothingWithRecovery's
    sl * cl / N (cheaptrick.cpp:22-57) for the frames' f0 cf0 (R,); EXP,
    the exp.  The fast LOG floors relative to the frame peak; the parity
    LOG (`parity`) adds |noise[noff + k]| * eps where noise is given
    (AddInfinitesimalNoise) and floors at the absolute tiny, as the JAX
    f64 frame does."""
    dtype, dev = x.dtype, x.device
    f64 = dtype == torch.float64
    if stage == LOG:
        if parity:
            if noise is not None:
                k = torch.arange(x.shape[1], device=dev)
                x = x + torch.abs(noise[noff[:, None] + k]) * cfg.K_EPS
            return torch.log(torch.clamp(x, min=prims.tiny_floor(dtype)))
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
    pi = np.pi if f64 else float(np.float32(np.pi))
    qf = (pi * cf0)[:, None] * q
    sl = torch.where(torch.arange(half + 1, device=dev) == 0,
                     torch.ones((), dtype=dtype, device=dev),
                     torch.sin(qf) / qf)
    cl = (1.0 - 2.0 * q1) + (2.0 * q1) * torch.cos(
        (2.0 * np.pi) * q * cf0[:, None])
    return prims.exact_div(x * sl * cl, fft_size)


def lifter(x, stage: int, cf0=None, fs: int = 0, fft_size: int = 0,
           q1: float = 0.0, noise=None, noff=None, parity: bool = False):
    """K25: `lifter_plain` of f32 or f64 rows x (R, N/2+1) in one
    launch.  The fast LOG takes float32 rows, the parity LOG (`parity`)
    float64 rows; `noise` (the float64 stream) and `noff` (R,) are the
    parity LOG's alone."""
    if not x.is_cuda:
        return lifter_plain(x, stage, cf0, fs, fft_size, q1, noise, noff,
                            parity)
    R, H = x.shape
    dt = x.dtype
    f64 = dt == torch.float64
    if dt not in (torch.float32, torch.float64) \
            or stage not in (LOG, LIFTER, EXP) \
            or (stage == LOG and parity != f64) \
            or (stage == LIFTER and (H != fft_size // 2 + 1
                                     or cf0.shape != (R,))) \
            or (noise is not None and (not parity or stage != LOG
                                       or noise.dtype != dt or noff is None)):
        raise ValueError("lifter: f32 or f64 rows (R, N/2+1), a stage of "
                         "0-2, cf0 (R,) for the lifter; the fast log on "
                         "float32 rows, the parity log on float64 rows, "
                         "noise with its offsets for the parity log only")
    x = x.contiguous()
    cf0c = cf0.to(dt).contiguous() if stage == LIFTER else None
    nz = noise.contiguous() if noise is not None else None
    no = noff.to(torch.int64).contiguous() if noise is not None else None
    kernels.check_cuda("lifter", x, *[t for t in (cf0c, nz, no)
                                      if t is not None])
    out = torch.empty_like(x)
    if f64:
        c0, c1 = 1.0 - 2.0 * q1, 2.0 * q1
    else:
        c0, c1 = float(np.float32(1.0 - 2.0 * q1)), float(np.float32(2.0 * q1))
    kernels.launch("cheaptrick_lifter", [
        stage, x.data_ptr(), cf0c.data_ptr() if cf0c is not None else None,
        R, H, float(fs), fft_size, c0, c1, prims.tiny_floor(dt),
        nz.data_ptr() if nz is not None else None,
        no.data_ptr() if no is not None else None, int(f64), out.data_ptr()],
        dict(x=x, stage=stage, cf0=cf0c, fs=fs, fft_size=fft_size, q1=q1,
             noise=noise, noff=noff, parity=parity),
        variant="f64" if f64 else None)
    return out
