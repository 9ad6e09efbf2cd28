"""The per-frame and per-pulse DFTs of the float32 paths.

Counterpart of `hts_train_world_tpu/ops/fftmat.py`, which runs every DFT
up to 4096 points as a matmul against cached cos/sin tables (the TPU's
MXU outpaced its FFT).  Here the same functions are two hand-written FFT
kernels on the card and the table products on the CPU:

- rfft(x, N):            x (.., L<=N) -> (Re, Im) of rfft(x, N)     K39
- rfft_power(x, N):      |rfft(x, N)|^2                             K39
- irfft_scaled(re, im, N): (Re, Im) -> irfft(X) * N (WORLD c2r)     K40
- minphase_log(lh, N):   log|S| half -> (Re, Im) of the log
                         min-phase spectrum: K40's half c2r, then
                         K39 on the folded cepstrum                 K40, K39
- sym_rfft_real(x, N), irfft_half(x, N): CheapTrick's cepstrum and
                         its inverse, each the first N/2+1 samples
                         of irfft(x) * N                            K40

K39 and K40 transform in float64 and round once to the rows' type, on
one FFT core (csrc/fft_r2c_core.cuh): K39 runs its passes forward with the
split on registers, K40 the inverse split in registers and the same
forward passes on its conjugate (`r2c_plan`, `c2r_plan`, `r2c_table_np`
mirror the passes and their tables).
Each function takes the table product (`rfft_matmul`, `rfft_power_matmul`,
`irfft_scaled_matmul`, `minphase_log_matmul`, `sym_rfft_real_matmul`,
`irfft_half_matmul`: the plain twins) for a CPU tensor and launches
K39/K40 (`r2c`, `c2r`) for a CUDA tensor, or raises; it never falls back
to the tables or to torch.fft there.  The tables are built in float64
numpy by the same code as the JAX package (so they are equal bit for bit)
and cached per (size, dtype, device).  `table_calls` counts the table
products run on CUDA tensors, so a run can show that a path did not take
them.

The products run in full float32: reduced precision (TF32) tripled the
fast path's envelope error in the JAX package's measurements, so every
product goes through `matmul`, which turns TF32 off for its own call only.
"""
from __future__ import annotations

import collections
import contextlib
import functools

import numpy as np
import torch

from hts_train_world_tpu_torch import kernels

# K39's modes
REIM, POWER, FOLD = 0, 1, 2
# the sizes K39/K40 take
MIN_N, MAX_N = 64, 8192

table_calls: collections.Counter = collections.Counter()


def _on_card(name: str, t) -> None:
    if t.is_cuda:
        table_calls[name] += 1


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
    _on_card("rfft_matmul", x)
    C, S = _on(_rfft_mats_np, N, x.dtype, x.device)
    L = x.shape[-1]
    return matmul(x, C[:L]), matmul(x, S[:L])


def rfft_power_matmul(x, N: int):
    re, im = rfft_matmul(x, N)
    return re * re + im * im


def irfft_scaled_matmul(re, im, N: int):
    """(Re, Im) (..., N/2+1) -> irfft(X) * N (..., N)."""
    _on_card("irfft_scaled_matmul", re)
    A, B = _on(_irfft_mats_np, N, re.dtype, re.device)
    return matmul(re, A) + matmul(im, B)


def minphase_log_matmul(log_half, N: int):
    """log_half (..., N/2+1) -> (Re, Im) of D, the log of the min-phase
    spectrum."""
    _on_card("minphase_log_matmul", log_half)
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


def sym_rfft_real_matmul(x, N: int):
    """x (..., N/2+1) -> Re(rfft(mirrored x)) (..., N/2+1) by the table."""
    _on_card("sym_rfft_real_matmul", x)
    return matmul(x, sym_rfft_real_mat(N, x.dtype, x.device))


def irfft_half_matmul(x, N: int):
    """Real half spectra x (..., N/2+1) -> the first N/2+1 samples of
    irfft(x) * N by the table."""
    _on_card("irfft_half_matmul", x)
    A, _ = irfft_half_mats(N, x.dtype, x.device)
    return matmul(x, A)


# ---------------------------------------------------------------------------
# K39 / K40
# ---------------------------------------------------------------------------


# K39's pass plans (csrc/fft_r2c_core.cuh: `n_passes`, `radix`,
# `sparse_ok`): the N/2 = M-point FFT of z_m = x_2m + i x_2m+1 in passes
# of radix 16 and one of 2^(log2 M mod 4); where z is zero past M/4 the
# sparse plan first folds a radix-8 pass into the next pass's loads, at
# the M where that saves a pass.
R2C_SPARSE_M = (64, 128, 512, 1024, 2048)


def r2c_plan(N: int, L: int):
    """K39's plan for rows of L samples at N points: (sparse, [(radix,
    Ns), ...]), Ns the product of the earlier radices (8 after the
    sparse plan's folded pass)."""
    M = N // 2
    sparse = (L + 1) // 2 <= M // 4 and M in R2C_SPARSE_M
    m = M.bit_length() - 1 - (3 if sparse else 0)
    plan, ns = [], 8 if sparse else 1
    for R in [16] * (m // 4) + ([1 << (m % 4)] if m % 4 else []):
        plan.append((R, ns))
        ns *= R
    return sparse, plan


def c2r_plan(N: int):
    """K40's pass plan: K39's dense plan at N (an inverse reads every
    bin), run on the conjugate of the inverse split."""
    return r2c_plan(N, N)[1]


def _w(num, den):
    """W_den^num = (cos, -sin)(2 pi num / den), num reduced mod den."""
    ang = 2.0 * np.pi * (np.asarray(num) % den) / den
    return np.cos(ang) - 1j * np.sin(ang)


@functools.lru_cache(maxsize=None)
def r2c_table_np(N: int, sparse: bool):
    """K39's twiddle table for a launch size, in the threads' order: W_N^k
    for the split (k <= N/4), then for each pass with Ns > 1 the values
    W_{R Ns}^(r k) at [(r-1) Ns + k], r in [1, R), k < Ns; (n, 2)
    interleaved float64."""
    M = N // 2
    _, plan = r2c_plan(N, 1 if sparse else N)
    parts = [_w(np.arange(M // 2 + 1), N)]
    for R, ns in plan:
        if ns > 1:
            parts.append(_w(np.arange(1, R)[:, None] * np.arange(ns)[None],
                            R * ns).reshape(-1))
    w = np.concatenate(parts)
    return np.ascontiguousarray(np.stack([w.real, w.imag], 1))


@functools.lru_cache(maxsize=None)
def _r2c_table(N: int, sparse: bool, device):
    return torch.as_tensor(r2c_table_np(N, sparse), dtype=torch.float64,
                           device=device)


def fold_weights(N: int, dtype, device):
    """w_n / N for the n <= N/2 samples of a half cepstrum (w = 1 at 0
    and N/2, else 2): the minimum-phase fold."""
    w = torch.full((N // 2 + 1,), 2.0 / N, dtype=dtype, device=device)
    w[0] = w[-1] = 1.0 / N
    return w


def _check(name: str, N: int, *ts):
    dt = ts[0].dtype
    if (dt not in (torch.float32, torch.float64)
            or any(t.dtype != dt for t in ts)
            or not MIN_N <= N <= MAX_N or N & (N - 1)):
        raise ValueError(f"{name}: float32 or float64 rows, N a power of "
                         f"two in [{MIN_N}, {MAX_N}] (got {dt}, N {N})")


def r2c_plain(x, N: int, mode: int = REIM):
    """K39's plain twin: the table products of `r2c`'s modes."""
    if mode == POWER:
        return rfft_power_matmul(x, N)
    if mode == FOLD:
        x = x * fold_weights(N, x.dtype, x.device)[:x.shape[-1]]
    return rfft_matmul(x, N)


def r2c(x, N: int, mode: int = REIM):
    """K39: rows x (..., L), L <= N, zero-padded to N -> (Re, Im) of
    rfft(x, N) (REIM), Re^2 + Im^2 (POWER), or (Re, Im) of rfft of x
    scaled by `fold_weights` (FOLD, L <= N/2+1), each (..., N/2+1)."""
    if not x.is_cuda:
        return r2c_plain(x, N, mode)
    _check("r2c", N, x)
    L = x.shape[-1]
    if mode not in (REIM, POWER, FOLD) or not 1 <= L <= N \
            or (mode == FOLD and L > N // 2 + 1):
        raise ValueError(f"r2c: mode 0-2 and 1 <= L <= N (L <= N/2+1 to "
                         f"fold); got mode {mode}, L {L}, N {N}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, L).contiguous()
    sparse, _ = r2c_plan(N, L)
    tw = _r2c_table(N, sparse, x.device)
    kernels.check_cuda("r2c", x2, tw)
    R, H = x2.shape[0], N // 2 + 1
    out0 = torch.empty((R, H), dtype=x.dtype, device=x.device)
    out1 = None if mode == POWER else torch.empty_like(out0)
    f64 = x.dtype == torch.float64
    kernels.launch("fft_r2c", [
        x2.data_ptr(), R, L, N, mode, tw.data_ptr(), int(sparse), int(f64),
        out0.data_ptr(), out1.data_ptr() if out1 is not None else None],
        dict(x=x2, N=N, mode=mode), variant="f64" if f64 else None)
    if mode == POWER:
        return out0.reshape(*lead, H)
    return out0.reshape(*lead, H), out1.reshape(*lead, H)


def c2r_plain(re, im, N: int, n_out: int):
    """K40's plain twin: the table products of `c2r`."""
    if n_out == N:
        return irfft_scaled_matmul(
            re, torch.zeros_like(re) if im is None else im, N)
    out = irfft_half_matmul(re, N)
    if im is None:
        return out
    return out + matmul(im, irfft_half_mats(N, im.dtype, im.device)[1])


def c2r(re, im, N: int, n_out: int):
    """K40: half spectra (Re, Im) (..., N/2+1), Im None for zero ->
    irfft(X) * N, its first n_out samples (n_out = N or N/2+1); Im X_0
    and Im X_{N/2} count as 0.  The kernel reads K39's dense table at N
    (its split entries give W_N^-k)."""
    if not re.is_cuda:
        return c2r_plain(re, im, N, n_out)
    _check("c2r", N, re, *(() if im is None else (im,)))
    H = N // 2 + 1
    if re.shape[-1] != H or (im is not None and im.shape != re.shape) \
            or n_out not in (N, H):
        raise ValueError(f"c2r: (Re, Im) (..., N/2+1) and n_out N or "
                         f"N/2+1; got {tuple(re.shape)}, N {N}, n_out "
                         f"{n_out}")
    lead = re.shape[:-1]
    re2 = re.reshape(-1, H).contiguous()
    im2 = None if im is None else im.reshape(-1, H).contiguous()
    tw = _r2c_table(N, False, re.device)
    kernels.check_cuda("c2r", re2, tw, *(() if im2 is None else (im2,)))
    R = re2.shape[0]
    out = torch.empty((R, n_out), dtype=re.dtype, device=re.device)
    f64 = re.dtype == torch.float64
    kernels.launch("fft_c2r", [
        re2.data_ptr(), im2.data_ptr() if im2 is not None else None, R, N,
        n_out, tw.data_ptr(), int(f64), out.data_ptr()],
        dict(re=re2, im=im2, N=N, n_out=n_out),
        variant="f64" if f64 else None)
    return out.reshape(*lead, n_out)


def minphase_log_composed(log_half, N: int, c2r_half, r2c_fold):
    """The minimum-phase log spectrum as two transforms: c, the first
    N/2+1 samples of irfft(log_half) * N (the real cepstrum, through
    `c2r_half(x, N)`), then rfft of c folded by `fold_weights` (through
    `r2c_fold(c, N)`) -> (Re, Im) (..., N/2+1).  The card runs it on
    K40 and K39; a test runs it on torch.fft."""
    return r2c_fold(c2r_half(log_half, N), N)


# ---------------------------------------------------------------------------
# the public functions: table products on the CPU, K39/K40 on the card
# ---------------------------------------------------------------------------


def rfft(x, N: int):
    """x (..., L), L <= N -> (Re, Im) of the N-point rfft (..., N/2+1)."""
    return r2c(x, N, REIM)


def rfft_power(x, N: int):
    """x (..., L), L <= N -> |rfft(x, N)|^2 (..., N/2+1)."""
    return r2c(x, N, POWER)


def irfft_scaled(re, im, N: int):
    """(Re, Im) (..., N/2+1) -> irfft(X) * N (..., N)."""
    return c2r(re, im, N, N)


def minphase_log(log_half, N: int):
    """log_half (..., N/2+1) -> (Re, Im) of D, the log of the min-phase
    spectrum."""
    if not log_half.is_cuda:
        return minphase_log_matmul(log_half, N)
    return minphase_log_composed(
        log_half, N, lambda x, n: c2r(x, None, n, n // 2 + 1),
        lambda c, n: r2c(c, n, FOLD))


def sym_rfft_real(x, N: int):
    """x (..., N/2+1) -> Re(rfft(mirrored x)) (..., N/2+1), which is the
    first N/2+1 samples of irfft(x) * N (its own table on the CPU)."""
    if not x.is_cuda:
        return sym_rfft_real_matmul(x, N)
    return c2r(x, None, N, N // 2 + 1)


def irfft_half(x, N: int):
    """Real half spectra x (..., N/2+1) -> the first N/2+1 samples of
    irfft(x) * N."""
    return c2r(x, None, N, N // 2 + 1)
