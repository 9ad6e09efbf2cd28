"""Spectral-envelope and aperiodicity coding (the encoding half).

Counterpart of `hts_train_world_tpu/ops/codec.py` (WORLD's codec.cpp):
the per-frame work is a gather-lerp onto the mel axis and a DCT, both
precomputed into tables (numpy float64, built by the same code as the
JAX package, so the tables are equal bit for bit).  Inputs are batched
(..., N/2+1) spectra.  The fused f32 pass that the feature encoder runs on
the card (kernel K6) lives in `features/encode.py`; these functions are
the plain formulation it is held against.  The decoding half serves the
synthesis CLI and is not ported yet.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch.ops import fftmat


def _mel(f):
    return cfg.K_M0 * np.log(f / cfg.K_F0 + 1.0)


def _interp_table(x, xi):
    """interp1 gather/weight tables on static axes (histc semantics:
    k = #(x <= xi) clipped to [1, len(x)-1]; linear with extrapolation)."""
    k = np.clip(np.searchsorted(x, xi, side="right"), 1, len(x) - 1)
    s = (xi - x[k - 1]) / (x[k] - x[k - 1])
    return k.astype(np.int32), s


@functools.lru_cache(maxsize=None)
def _coding_tables(fs: int, fft_size: int, n_dims: int):
    """GetParametersForCoding (codec.cpp:162-180) + DCTForCodec (:73-88):
    the mel-axis gather/weight tables k, s (M = N/2 entries) and the DCT
    matrix D (M, n_dims)."""
    M = fft_size // 2
    floor_mel = _mel(cfg.K_FLOOR_FREQUENCY)
    ceil_mel = _mel(min(fs / 2.0, cfg.K_CEIL_FREQUENCY))
    mel_axis = (ceil_mel - floor_mel) * np.arange(M) / M + floor_mel
    # entry M is never consulted for these axes (codec.cpp:178-179 leaves
    # it unset); +inf is the sentinel
    fm = np.empty(M + 1)
    fm[:M] = _mel(np.arange(M) * fs / fft_size)
    fm[M] = np.inf
    k, s = _interp_table(fm, mel_axis)

    # DCT: waveform[i]=ms[2i], waveform[i+M/2]=ms[M-2i-1]; rfft(M);
    # mc_k = Re(S_k * w_k)/sqrt(M), w_k = 2 e^{i k pi/N}/sqrt(N), w_0 /= sqrt2
    sigma = np.empty(M, dtype=np.int64)
    i = np.arange(M // 2)
    sigma[2 * i] = i
    sigma[M - 2 * i - 1] = i + M // 2
    kk = np.arange(n_dims)[:, None]
    ang = kk * np.pi / fft_size - 2.0 * np.pi * kk * sigma[None, :] / M
    D = 2.0 * np.cos(ang) / math.sqrt(fft_size * M)
    D[0] /= math.sqrt(2.0)
    return k, s, np.ascontiguousarray(D.T)  # (M, n_dims)


@functools.lru_cache(maxsize=None)
def coding_tensors(fs: int, fft_size: int, n_dims: int, dtype, device):
    """The coding tables as tensors: k (int64), s (dtype), D (M, n_dims)
    in dtype, on `device`."""
    k, s, D = _coding_tables(fs, fft_size, n_dims)
    return (torch.as_tensor(k, dtype=torch.long, device=device),
            torch.as_tensor(s, dtype=dtype, device=device),
            torch.as_tensor(D, dtype=dtype, device=device))


def gather_lerp(vals, k, s):
    """vals (..., X) -> (..., len(k)): y[k-1] + s*(y[k]-y[k-1])."""
    v0 = vals[..., k - 1]
    v1 = vals[..., torch.clamp(k, max=vals.shape[-1] - 1)]
    return v0 + s * (v1 - v0)


def code_spectral_envelope(spectrogram, fs: int, fft_size: int,
                           n_dims: int):
    """CodeSpectralEnvelope (codec.cpp:266-295): log -> mel-axis lerp ->
    DCT (a full-f32 matmul).  spectrogram (..., N/2+1) -> (..., n_dims)."""
    k, s, D = coding_tensors(fs, fft_size, n_dims, spectrogram.dtype,
                             spectrogram.device)
    return fftmat.matmul(gather_lerp(torch.log(spectrogram), k, s), D)


def code_aperiodicity(aperiodicity, fs: int, fft_size: int):
    """CodeAperiodicity (codec.cpp:217-235): dB + interp1Q down to the
    3 kHz coarse bands.  (..., N/2+1) -> (..., n_ap)."""
    n_ap = cfg.number_of_aperiodicities(fs)
    coarse_hz = cfg.K_FREQUENCY_INTERVAL * (np.arange(n_ap) + 1.0)
    delta = fs / fft_size
    base = (coarse_hz / delta).astype(np.int64)
    fracs = coarse_hz / delta - base
    dev = aperiodicity.device
    log_ap = 20.0 * torch.log10(aperiodicity)
    v0 = log_ap[..., torch.as_tensor(base, device=dev)]
    v1 = log_ap[..., torch.as_tensor(np.minimum(base + 1, fft_size // 2),
                                     device=dev)]
    return v0 + (v1 - v0) * torch.as_tensor(fracs, dtype=aperiodicity.dtype,
                                            device=dev)
