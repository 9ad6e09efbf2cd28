"""The SPTK transforms the mel-cepstral postfilter needs — counterparts of
`hts_train_world_tpu/ops/sptk.py:44-85` (freqt, mc2b, b2mc, c2acr).

Each per-frame transform is linear in the cepstrum (a cached float64
matrix) or a batched FFT, in the input's dtype and on its device.  The
rest of the JAX module (mcep, theq, gc2gc, mgc2mgc, gnorm/ignorm, frqtr)
belongs to the SPTK engine, which the port does not have yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hts_train_world_tpu_torch.ops.codec import freqt_matrix


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
