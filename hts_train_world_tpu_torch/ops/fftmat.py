"""Small DFTs as matmuls against cached operator tables.

Counterpart of `hts_train_world_tpu/ops/fftmat.py`.  The tables are built
in float64 numpy by the same code as the JAX package (so they are equal
bit for bit) and cached per (size, dtype, device):

- rfft_mats(N):     x (.., L<=N)   -> (Re, Im) of rfft(x, N)
- irfft_mats(N):    (Re, Im) spec  -> irfft(X) * N (WORLD c2r)
- minphase_mats(N): log|S| half    -> (Re, Im) of the log min-phase spectrum
- sym_rfft_real_mat(N), irfft_half_mats(N): CheapTrick's cepstral lifter.

The products run in full float32: reduced precision (TF32) tripled the
fast path's envelope error in the JAX package's measurements, so every
product goes through `matmul`, which turns TF32 off for its own call only.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


@contextlib.contextmanager
def full_precision():
    """float32 matmuls in full float32 (no TF32) inside the block; the
    caller's settings are restored after it."""
    precision = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def matmul(a, b):
    """a @ b in full float32."""
    with full_precision():
        return a @ b


@functools.lru_cache(maxsize=None)
def _rfft_mats_np(N: int):
    k = np.arange(N // 2 + 1)
    n = np.arange(N)
    ang = -2.0 * np.pi * np.outer(n, k) / N
    return np.cos(ang), np.sin(ang)  # (N, half+1)


@functools.lru_cache(maxsize=None)
def _irfft_mats_np(N: int):
    # irfft(X)*N = sum_k w_k (Re X_k cos(2pi nk/N) - Im X_k sin(2pi nk/N))
    # with w_0 = w_{N/2} = 1, else 2 (real-even expansion), no 1/N since
    # the WORLD c2r convention is unnormalized
    half = N // 2
    k = np.arange(half + 1)
    n = np.arange(N)
    w = np.where((k == 0) | (k == half), 1.0, 2.0)
    ang = 2.0 * np.pi * np.outer(k, n) / N
    A = (w[:, None] * np.cos(ang))          # (half+1, N) for Re
    B = (-w[:, None] * np.sin(ang))         # (half+1, N) for Im
    return A, B


@functools.lru_cache(maxsize=None)
def _minphase_mats_np(N: int):
    half = N // 2
    eye = np.eye(half + 1)
    # mirror: (N, half+1)
    sym = np.concatenate([eye, eye[-2:0:-1]], axis=0)
    C = np.conj(np.fft.rfft(sym, axis=0))            # (half+1, half+1)
    scale = np.where((np.arange(half + 1) == 0)
                     | (np.arange(half + 1) == half), 1.0, 2.0)
    ceps = C * scale[:, None]                        # fold
    cep_full = np.concatenate(
        [ceps, np.zeros((N - half - 1, half + 1), complex)], axis=0)
    D = np.fft.fft(cep_full, axis=0)[:half + 1] / N  # (half+1, half+1)
    # operator acts on log_half from the right: out = M @ ls
    return np.ascontiguousarray(D.real.T), np.ascontiguousarray(D.imag.T)


@functools.lru_cache(maxsize=None)
def _sym_rfft_real_mat_np(N: int):
    half = N // 2
    eye = np.eye(half + 1)
    sym = np.concatenate([eye, eye[-2:0:-1]], axis=0)   # (N, half+1)
    return np.ascontiguousarray(np.fft.rfft(sym, axis=0).real.T)


@functools.lru_cache(maxsize=None)
def _irfft_half_mats_np(N: int):
    A, B = _irfft_mats_np(N)
    half = N // 2
    return (np.ascontiguousarray(A[:, :half + 1]),
            np.ascontiguousarray(B[:, :half + 1]))


@functools.lru_cache(maxsize=None)
def _on(builder, N: int, dtype, device):
    out = builder(N)
    if isinstance(out, tuple):
        return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                     for m in out)
    return torch.as_tensor(out, dtype=dtype, device=device)


def rfft_matmul(x, N: int):
    """x (..., L) with L <= N (implied zero padding) -> (Re, Im) of the
    N-point rfft, each (..., N/2+1)."""
    C, S = _on(_rfft_mats_np, N, x.dtype, x.device)
    L = x.shape[-1]
    return matmul(x, C[:L]), matmul(x, S[:L])


def rfft_power_matmul(x, N: int):
    re, im = rfft_matmul(x, N)
    return re * re + im * im


def irfft_scaled_matmul(re, im, N: int):
    """(Re, Im) (..., N/2+1) -> irfft(X) * N (..., N)."""
    A, B = _on(_irfft_mats_np, N, re.dtype, re.device)
    return matmul(re, A) + matmul(im, B)


def minphase_log_matmul(log_half, N: int):
    """log_half (..., N/2+1) -> (Re, Im) of D, the log of the min-phase
    spectrum."""
    R, I = _on(_minphase_mats_np, N, log_half.dtype, log_half.device)
    return matmul(log_half, R), matmul(log_half, I)


def minphase_matmul(log_half, N: int):
    """log_half (..., N/2+1) -> (Re, Im) of the min-phase spectrum exp(D)."""
    dre, dim = minphase_log_matmul(log_half, N)
    mag = torch.exp(dre)
    return mag * torch.cos(dim), mag * torch.sin(dim)


def sym_rfft_real_mat(N: int, dtype, device):
    """Linear map log-half-spectrum -> Re(rfft(mirrored)), (h+1, h+1)."""
    return _on(_sym_rfft_real_mat_np, N, dtype, device)


def irfft_half_mats(N: int, dtype, device):
    """irfft(X)*N restricted to the first N/2+1 output samples."""
    return _on(_irfft_half_mats_np, N, dtype, device)
