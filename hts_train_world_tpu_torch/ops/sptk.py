"""SPTK functions — counterpart of `hts_train_world_tpu/ops/sptk.py`
(sptkfunctions.cpp, theq.cpp): freqt, frqtr, mc2b/b2mc, c2acr,
gnorm/ignorm, the Toeplitz-plus-Hankel solve, mel-cepstral analysis,
gc2gc and mgc2mgc.

Each per-frame transform is linear in the cepstrum (a cached float64
matrix) or a batched FFT, in the input's dtype and on its device.

- `mcep` (kernel K38, csrc/mcep_newton.cu): the initial cepstrum, then
  `itr` Newton steps, one block of threads a frame with the loop inside
  the block.  The kernel reads three float64 tables that fold each linear
  chain of the step (`mcep_tables`); `mcep_plain` is the JAX formulation
  in torch (`torch.fft`, `torch.linalg.solve`).
- `gc2gc` loops over the output index in Python, batched over frames.

The wrapper runs the kernel for CUDA tensors (float32 or float64; the
engine's path is float64) and the twin for CPU tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops.codec import freqt_matrix

MCEP_ITERS = 30


@functools.lru_cache(maxsize=None)
def frqtr_matrix(m1: int, m2: int, a: float) -> np.ndarray:
    """frqtr (sptkfunctions.cpp:651-684) as a (m1+1, m2+1) numpy float64
    matrix (the freqt recursion without the b*d[0] term).  Every row runs
    the recursion on its unit vector with the same scalar operations in
    the same order, all rows at once."""
    c1 = np.eye(m1 + 1)
    g = np.zeros((m1 + 1, m2 + 1))
    for i in range(-m1, 1):
        d = g
        g = np.empty((m1 + 1, m2 + 1))
        g[:, 0] = c1[:, -i]
        for j in range(1, m2 + 1):
            g[:, j] = d[:, j - 1] + a * (d[:, j] - g[:, j - 1])
    g.setflags(write=False)
    return g


def freqt(c, m2: int, a: float):
    """Frequency warping, batched: (..., m1+1) -> (..., m2+1)."""
    m1 = c.shape[-1] - 1
    return c @ torch.as_tensor(freqt_matrix(m1, m2, a), dtype=c.dtype,
                               device=c.device)


@functools.lru_cache(maxsize=None)
def _mc2b_matrix(m: int, a: float):
    """mc2b as a (m+1, m+1) numpy float64 matrix (the recursion on unit
    vectors)."""
    M = np.zeros((m + 1, m + 1))
    for u in range(m + 1):
        c = np.zeros(m + 1)
        c[u] = 1.0
        b = np.zeros(m + 1)
        b[m] = c[m]
        for i in range(m - 1, -1, -1):
            b[i] = c[i] - a * b[i + 1]
        M[u] = b
    return M


def mc2b(mc, a: float):
    """mel-cepstrum -> MLSA filter coefficients: b[m]=c[m],
    b[i]=c[i]-a*b[i+1] (SPTK mc2b).  Linear -> cached matrix."""
    m = mc.shape[-1] - 1
    return mc @ torch.as_tensor(_mc2b_matrix(m, a), dtype=mc.dtype,
                                device=mc.device)


def b2mc(b, a: float):
    """Inverse of mc2b: c[i] = b[i] + a*b[i+1] (SPTK b2mc)."""
    shifted = torch.cat([b[..., 1:], torch.zeros_like(b[..., :1])], dim=-1)
    return b + a * shifted


def c2acr(c, m_out: int, fft_size: int):
    """cepstrum -> autocorrelation (SPTK c2acr): r = irfft(exp(2*Re C)).
    Like `jnp.fft.rfft(c, fft_size)`, a cepstrum longer than fft_size is
    cropped to its first fft_size coefficients."""
    spec = torch.fft.rfft(c, n=fft_size, dim=-1).real
    p = torch.exp(2.0 * spec)
    r = torch.fft.irfft(p, n=fft_size, dim=-1)
    return r[..., :m_out + 1]


def gnorm(c, g: float):
    """Gain normalization (sptkfunctions.cpp:313-328)."""
    if g != 0.0:
        k = 1.0 + g * c[..., :1]
        return torch.cat([k ** (1.0 / g), c[..., 1:] / k], dim=-1)
    return torch.cat([torch.exp(c[..., :1]), c[..., 1:]], dim=-1)


def ignorm(c, g: float):
    """Inverse gain normalization (sptkfunctions.cpp:330-345)."""
    if g != 0.0:
        k = c[..., :1] ** g
        return torch.cat([(k - 1.0) / g, k * c[..., 1:]], dim=-1)
    return torch.cat([torch.log(c[..., :1]), c[..., 1:]], dim=-1)


def theq_dense(t, h, b):
    """Solve (Toeplitz(t) + Hankel(h)) a = b (theq.cpp as mcep uses it).
    t: (..., n) first column/row; h: (..., 2n-1) antidiagonals; b: (...,
    n)."""
    n = t.shape[-1]
    i = torch.arange(n, device=t.device)
    A = t[..., (i[:, None] - i[None, :]).abs()] + h[..., i[:, None]
                                                    + i[None, :]]
    return torch.linalg.solve(A, b[..., None])[..., 0]


def _newton_terms(r, al, m: int):
    """One Newton step's system from the warped ratio r (..., 2m+1): the
    Toeplitz column t, the Hankel antidiagonals y and the right side b,
    as sptkfunctions.cpp:130-150 forms them."""
    m2 = 2 * m
    b_vec = r[..., :m + 1] - al
    ev = torch.arange(m2 + 1, device=r.device) % 2 == 0
    y = torch.where(ev, r[..., :m2 + 1] - r[..., :1], r[..., :m2 + 1])
    j = torch.arange(m + 1, device=r.device)
    t = torch.where((j % 2 == 0) & (j >= 2), r[..., :m + 1] + r[..., :1],
                    r[..., :m + 1])
    t = torch.cat([2.0 * t[..., :1], t[..., 1:]], dim=-1)
    return t, y, b_vec


@functools.lru_cache(maxsize=8)
def _alpha_powers(m: int, alpha: float, dtype, device):
    return torch.as_tensor((-alpha) ** np.arange(m + 1), dtype=dtype,
                           device=device)


def mcep_plain(log_periodogram_half, order: int, alpha: float,
               fft_size: int, itr: int = MCEP_ITERS):
    """Mel-cepstral analysis (sptkfunctions.cpp:11-184, the itype-agnostic
    core), as the JAX package writes it: log periodogram (..., N/2+1) ->
    (..., order+1) after a fixed `itr` Newton steps."""
    logp = log_periodogram_half
    dtype, dev = logp.dtype, logp.device
    f2 = fft_size // 2
    m = order
    x_half = torch.exp(logp)
    cep = torch.fft.irfft(logp, n=fft_size, dim=-1)
    half = torch.ones(fft_size, dtype=dtype, device=dev)
    half[0] = half[f2] = 0.5
    cep = cep * half
    mc = freqt(cep[..., :f2 + 1], m, alpha)
    al = _alpha_powers(m, alpha, dtype, dev)
    Tb = torch.tensor(freqt_matrix(m, f2, -alpha), dtype=dtype, device=dev)
    Tr = torch.tensor(frqtr_matrix(f2, 2 * m, alpha), dtype=dtype,
                      device=dev)
    for _ in range(itr):
        c = mc @ Tb
        spec = torch.fft.rfft(c, n=fft_size, dim=-1).real
        ratio_half = x_half / torch.exp(2.0 * spec)
        r_full = torch.fft.irfft(ratio_half, n=fft_size, dim=-1)
        r = r_full[..., :f2 + 1] @ Tr
        mc = mc + theq_dense(*_newton_terms(r, al, m))
    return mc


def _irfft_rows(fft_size: int) -> np.ndarray:
    """(N/2+1, N/2+1) float64: x @ table is irfft(x, N)[:N/2+1] for a real
    half spectrum x (the C2R weights 1 at bins 0 and N/2, 2 elsewhere)."""
    f2 = fft_size // 2
    k = np.arange(f2 + 1)
    w = np.where((k == 0) | (k == f2), 1.0, 2.0) / fft_size
    return w[:, None] * np.cos(2.0 * np.pi * (np.outer(k, k) % fft_size)
                               / fft_size)


@functools.lru_cache(maxsize=8)
def mcep_tables(order: int, alpha: float, fft_size: int):
    """K38's three folded float64 tables, each (rows, N/2+1) so that a
    warp reads a row's consecutive bins:
      A0 (m+1, N/2+1): log x -> irfft, ends halved, freqt(., m, alpha);
      Tb (m+1, N/2+1): mc -> freqt(., N/2, -alpha), Re rfft at N;
      Tr (2m+1, N/2+1): the ratio -> irfft[:N/2+1], frqtr(., 2m, alpha)."""
    f2 = fft_size // 2
    m = order
    irf = _irfft_rows(fft_size)
    halve = np.ones(f2 + 1)
    halve[0] = halve[f2] = 0.5
    A0 = (irf * halve[None, :]) @ freqt_matrix(f2, m, alpha)
    k = np.arange(f2 + 1)
    cos = np.cos(2.0 * np.pi * (np.outer(k, k) % fft_size) / fft_size)
    Tb = freqt_matrix(m, f2, -alpha) @ cos
    Tr = irf @ frqtr_matrix(f2, 2 * m, alpha)
    tables = tuple(np.ascontiguousarray(a) for a in (A0.T, Tb, Tr.T))
    for a in tables:
        a.setflags(write=False)
    return tables


@functools.lru_cache(maxsize=8)
def _mcep_tensors(order: int, alpha: float, fft_size: int, dtype, device):
    return tuple(torch.tensor(a, dtype=dtype, device=device)
                 for a in mcep_tables(order, alpha, fft_size))


def mcep(log_periodogram_half, order: int, alpha: float, fft_size: int,
         itr: int = MCEP_ITERS):
    """K38: log periodogram (T, N/2+1) -> mel-cepstra (T, order+1)."""
    x = log_periodogram_half
    if not x.is_cuda:
        return mcep_plain(x, order, alpha, fft_size, itr)
    if (x.dtype not in (torch.float32, torch.float64) or x.dim() != 2
            or fft_size < 4 or fft_size % 2
            or x.shape[1] != fft_size // 2 + 1 or not 0 <= order <= 127
            or itr < 0):
        raise ValueError("mcep: float32 or float64 (T, N/2+1) log spectra, "
                         "even N, order <= 127")
    x = x.contiguous()
    A0, Tb, Tr = _mcep_tensors(int(order), float(alpha), int(fft_size),
                               x.dtype, x.device)
    kernels.check_cuda("mcep_newton", x, A0, Tb, Tr)
    al = _alpha_powers(order, alpha, x.dtype, x.device)
    out = torch.empty(x.shape[0], order + 1, dtype=x.dtype, device=x.device)
    kernels.launch("mcep_newton", [
        x.data_ptr(), x.shape[0], x.shape[1], order, A0.data_ptr(),
        Tb.data_ptr(), Tr.data_ptr(), al.data_ptr(), itr,
        int(x.dtype == torch.float64), out.data_ptr()],
        dict(log_periodogram_half=log_periodogram_half, order=int(order),
             alpha=float(alpha), fft_size=int(fft_size), itr=int(itr)))
    return out


def gc2gc(c1, g1: float, m2: int, g2: float):
    """Generalized-cepstrum gamma conversion (sptkfunctions.cpp:347-385):
    c2[i] = c1[i] + (g2 ss2 - g1 ss1) / i, the in-index recurrence run as
    a Python loop over the output index, batched over leading dims."""
    m1 = c1.shape[-1] - 1
    dev = c1.device
    k = torch.arange(1, m2 + 1, device=dev)
    kf = k.to(c1.dtype)
    cak = c1[..., k.clamp(0, m1)]
    zero = torch.zeros((), dtype=c1.dtype, device=dev)
    c2 = torch.zeros(c1.shape[:-1] + (m2 + 1,), dtype=c1.dtype, device=dev)
    c2[..., 0] = c1[..., 0]
    for i in range(1, m2 + 1):
        valid = k <= min(m1, i - 1)
        cc = torch.where(valid, cak * c2[..., (i - k).clamp(0, m2)], zero)
        ss2 = (kf * cc).sum(-1)
        ss1 = ((i - kf) * cc).sum(-1)
        base = c1[..., i] if i <= m1 else zero
        c2[..., i] = base + (g2 * ss2 - g1 * ss1) / i
    return c2


def mgc2mgc(c, a1: float, g1: float, m2: int, a2: float, g2: float):
    """mgc2mgc (sptkfunctions.cpp:221-254): frequency warp via freqt, then
    gnorm/gc2gc/ignorm for the gamma conversion."""
    a = (a2 - a1) / (1.0 - a1 * a2)
    if a == 0.0:
        m1 = c.shape[-1] - 1
        if m2 <= m1:
            w = c[..., :m2 + 1]
        else:
            w = torch.cat([c, torch.zeros(c.shape[:-1] + (m2 - m1,),
                                          dtype=c.dtype, device=c.device)],
                          dim=-1)
    else:
        w = freqt(c, m2, a)
    if g1 == g2:
        return w
    w = gnorm(w, g1)
    w = gc2gc(w, g1, m2, g2)
    return ignorm(w, g2)
