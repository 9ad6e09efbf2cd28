"""Spectral-envelope and aperiodicity coding and the SPTK warping of the
synth CLI.

Counterpart of `hts_train_world_tpu/ops/codec.py` (WORLD's codec.cpp and
the mgc2sp path of test/sptkfunctions.cpp): the per-frame work is a
gather-lerp between the mel and Hz axes and a DCT / IDCT, both
precomputed into tables (numpy float64, built by the same code as the
JAX package, so the tables are equal bit for bit), and SPTK's freqt as a
matrix.  Inputs are batched over leading axes.

The fused f32 passes the card runs live elsewhere: the feature encode
(kernel K6) in `features/encode.py`, the synth CLI's decode (kernel K12)
in `features/decode.py`.  These functions are the plain formulation they
are held against.  `decode_aperiodicity` (WORLD's coarse-band decode) is
on no path of the port and stays plain.
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


def _mel_to_freq(m):
    return cfg.K_F0 * (np.exp(m / cfg.K_M0) - 1.0)


def _frozen(*arrays):
    """Cached tables are shared by every caller: read-only, so no write
    anywhere can reach the cache (the tensor caches below hold copies)."""
    for a in arrays:
        a.setflags(write=False)
    return arrays


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
    return _frozen(k, s, np.ascontiguousarray(D.T))  # (M, n_dims)


@functools.lru_cache(maxsize=None)
def coding_tensors(fs: int, fft_size: int, n_dims: int, dtype, device):
    """The coding tables as tensors: k (int64), s (dtype), D (M, n_dims)
    in dtype, on `device`."""
    k, s, D = _coding_tables(fs, fft_size, n_dims)
    return (torch.tensor(k, dtype=torch.long, device=device),
            torch.tensor(s, dtype=dtype, device=device),
            torch.tensor(D, dtype=dtype, device=device))


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


@functools.lru_cache(maxsize=None)
def _decoding_tables(fs: int, fft_size: int, n_dims: int):
    """GetParametersForDecoding (codec.cpp:185-208) + IDCTForCodec
    (:93-115): the Hz-axis gather/weight tables k, s (N/2+1 entries) over
    the boundary-padded mel spectrum (M+2 entries) and the IDCT matrix
    Dinv (n_dims, M)."""
    M = fft_size // 2
    floor_mel = _mel(cfg.K_FLOOR_FREQUENCY)
    ceil_mel = _mel(min(fs / 2.0, cfg.K_CEIL_FREQUENCY))
    mel_axis_hz = np.empty(M + 2)
    mel_axis_hz[1:M + 1] = _mel_to_freq(
        (ceil_mel - floor_mel) * np.arange(M) / M + floor_mel)
    mel_axis_hz[0] = 0.0
    mel_axis_hz[M + 1] = fs / 2.0
    freq_axis = np.arange(fft_size // 2 + 1) * fs / fft_size
    k, s = _interp_table(mel_axis_hz, freq_axis)

    # in_k = mc_k sqrt(N) sqrt(M) e^{-i k pi/N}; the reference's backward
    # c2c (fft.cpp:36-46) sums conj(in_k) e^{+2 pi i n k / M};
    # ms[2i] = Re(out[i]), ms[2i+1] = Re(out[M-1-i])
    sigma = np.empty(M, dtype=np.int64)
    i = np.arange(M // 2)
    sigma[2 * i] = i
    sigma[2 * i + 1] = M - 1 - i
    kk = np.arange(n_dims)[None, :]
    ang = 2.0 * np.pi * sigma[:, None] * kk / M + kk * np.pi / fft_size
    Dinv = math.sqrt(fft_size * M) * np.cos(ang)
    Dinv[:, 0] /= math.sqrt(2.0)
    return _frozen(k, s, np.ascontiguousarray(Dinv.T))  # (n_dims, M)


@functools.lru_cache(maxsize=None)
def decoding_tensors(fs: int, fft_size: int, n_dims: int, dtype, device):
    """The decoding tables as tensors: k (int64), s and Dinv in dtype."""
    k, s, Dinv = _decoding_tables(fs, fft_size, n_dims)
    return (torch.tensor(k, dtype=torch.long, device=device),
            torch.tensor(s, dtype=dtype, device=device),
            torch.tensor(Dinv, dtype=dtype, device=device))


def decode_spectral_envelope(coded, fs: int, fft_size: int, n_dims: int):
    """DecodeSpectralEnvelope (codec.cpp:297-324): IDCT (a full-f32
    matmul) -> boundary duplication -> Hz-axis lerp -> exp(x / (N/2)).
    coded (..., n_dims) -> (..., N/2+1)."""
    k, s, Dinv = decoding_tensors(fs, fft_size, n_dims, coded.dtype,
                                  coded.device)
    mel_sp = fftmat.matmul(coded, Dinv)                       # (..., M)
    padded = torch.cat([mel_sp[..., :1], mel_sp, mel_sp[..., -1:]], dim=-1)
    return torch.exp(gather_lerp(padded, k, s) / (fft_size // 2))


def decode_aperiodicity(coded, fs: int, fft_size: int):
    """DecodeAperiodicity (codec.cpp:237-264) with the CheckVUV gate:
    (..., n_ap) dB coarse bands -> (..., N/2+1)."""
    n_ap = coded.shape[-1]
    dtype, dev = coded.dtype, coded.device
    coarse_axis = np.concatenate([
        np.arange(n_ap + 1) * cfg.K_FREQUENCY_INTERVAL, [fs / 2.0]])
    freq_axis = np.arange(fft_size // 2 + 1) * fs / fft_size
    k, s = _interp_table(coarse_axis, freq_axis)
    lead = coded.shape[:-1] + (1,)
    vals = torch.cat([
        torch.full(lead, -60.0, dtype=dtype, device=dev), coded,
        torch.full(lead, -cfg.K_MY_SAFE_GUARD_MINIMUM, dtype=dtype,
                   device=dev)], dim=-1)
    ap = 10.0 ** (gather_lerp(vals, torch.as_tensor(k, dtype=torch.long,
                                                    device=dev),
                              torch.as_tensor(s, dtype=dtype, device=dev))
                  / 20.0)
    voiced = coded.mean(dim=-1) > -0.5      # CheckVUV, codec.cpp:31-41
    return torch.where(voiced[..., None],
                       torch.full((), 1.0 - cfg.K_MY_SAFE_GUARD_MINIMUM,
                                  dtype=dtype, device=dev), ap)


@functools.lru_cache(maxsize=None)
def freqt_matrix(m1: int, m2: int, a: float):
    """freqt (sptkfunctions.cpp:596-631) as a (m1+1, m2+1) numpy float64
    matrix: the recursion is linear in c1, so the rows are the recursion
    run on unit vectors with the C's update order (d = old g; g[j] uses
    the new g[j-1])."""
    b = 1.0 - a * a
    # row u of c1 is the unit vector e_u: all rows run at once, each with
    # the same scalar operations in the same order
    c1 = np.eye(m1 + 1)
    g = np.zeros((m1 + 1, m2 + 1))
    for i in range(-m1, 1):
        d = g
        g = np.empty((m1 + 1, m2 + 1))
        g[:, 0] = c1[:, -i] + a * d[:, 0]
        if m2 >= 1:
            g[:, 1] = b * d[:, 0] + a * d[:, 1]
        for j in range(2, m2 + 1):
            g[:, j] = d[:, j - 1] + a * (d[:, j] - g[:, j - 1])
    return g


def mgc2sp_real(mgc, alpha: float, fft_size: int):
    """mgc2sp with gamma = 0 (sptkfunctions.cpp:186-219): freqt to a plain
    cepstrum (alpha -> -alpha), then the real part of its FFT (c2sp,
    :256-274).  mgc (..., m+1) -> (..., N/2+1) log-amplitude values."""
    T = torch.as_tensor(freqt_matrix(mgc.shape[-1] - 1, fft_size // 2,
                                     -alpha), dtype=mgc.dtype,
                        device=mgc.device)
    c = fftmat.matmul(mgc, T)                                 # (..., M+1)
    return torch.fft.rfft(c, n=fft_size, dim=-1).real
