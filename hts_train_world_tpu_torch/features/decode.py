"""HTS features (lf0, mgc, bap) -> WORLD parameters (f0, sp, ap).

Counterpart of `hts_train_world_tpu/cli.py:decode_features` (the decode
that the reference's `synth` binary applies, synth.cpp:171-256), batched
over leading axes, with every quirk of that binary:

- f0 = exp(lf0) where lf0 != 0, else 0;
- mgc[0] -= 12, DecodeSpectralEnvelope, then / 1e4;
- bap[0] += 9.210340 (the CLIs' literal), SPTK mgc2sp (alpha 0.55,
  gamma 0), exp / 1e4 for the first `apl` bins only; an odd bap dimension
  gives order apl = dim - 1 but all dim coefficients are still read
  (oddApl); the remaining bins are 0 (synthesis clamps them to 0.001).

f0 is exp taken in float64 and rounded to the working dtype, in the kernel
and in its twin, so the card and the CPU decode the same contour (and fire
the same pulses in synthesis).

The whole decode runs as kernel K12 (csrc/codec_decode.cu) for CUDA
tensors, in float32 (the fast path) or float64 (the parity path, the
synth CLI's default): one launch reads (lf0, mgc, bap) once and writes
(f0, sp, ap).
The IDCT, the boundary-padded Hz lerp and exp are fused per frame; for the
aperiodicity, freqt and the real part of the FFT are two linear maps, so
the kernel applies their product W (apl + 1, apl) and needs no FFT.
`decode_features_plain` is its twin (the codec functions in the JAX
order: freqt matmul, then `torch.fft.rfft`), which runs for CPU tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.features.encode import LN_1E4
from hts_train_world_tpu_torch.ops import codec

ALPHA = 0.55   # the synth CLI's all-pass constant for the bap decode


def ap_order(bap_dim: int) -> int:
    """The number of decoded aperiodicity bins, `apl` (oddApl rule)."""
    return bap_dim - bap_dim % 2


def decode_features_plain(lf0, mgc, bap, fs: int, fft_size: int):
    """lf0 (..., T), mgc (..., T, mgc_dim), bap (..., T, bap_dim) ->
    (f0, sp, ap), sp and ap (..., T, N/2+1)."""
    dtype = mgc.dtype
    f0 = torch.where(lf0 != 0.0, torch.exp(lf0.double()).to(lf0.dtype),
                     torch.zeros((), dtype=lf0.dtype, device=lf0.device))
    mgc = torch.cat([mgc[..., :1] - 12.0, mgc[..., 1:]], dim=-1)
    sp = codec.decode_spectral_envelope(mgc, fs, fft_size,
                                        mgc.shape[-1]) / 1e4
    apl = ap_order(bap.shape[-1])
    bap = torch.cat([bap[..., :1] + LN_1E4, bap[..., 1:]], dim=-1)
    xx = codec.mgc2sp_real(bap[..., :apl + 1], ALPHA, fft_size)
    ap = torch.cat([torch.exp(xx[..., :apl]) / 1e4,
                    torch.zeros(xx.shape[:-1] + (xx.shape[-1] - apl,),
                                dtype=dtype, device=bap.device)], dim=-1)
    return f0, sp, ap


@functools.lru_cache(maxsize=None)
def _ap_matrix_np(bap_dim: int, fft_size: int) -> np.ndarray:
    """W = freqt(m, N/2, -alpha) @ cos(2 pi k i / N) over the first apl
    bins: the bap coefficients read -> log aperiodicity, (m + 1, apl)."""
    apl = ap_order(bap_dim)
    m = min(apl + 1, bap_dim) - 1
    T = codec.freqt_matrix(m, fft_size // 2, -ALPHA)
    k = np.arange(fft_size // 2 + 1)[:, None]
    C = np.cos(2.0 * np.pi * k * np.arange(apl)[None, :] / fft_size)
    return np.ascontiguousarray(T @ C)


def decode_limit(lf0, mgc, bap, fs: int, fft_size: int):
    """Per-element limits on |log K12 - log twin| for sp and ap (f0 is
    held bit-equal).

    sp: both sum 50-term IDCT rows in f32 in different orders (the twin
    through a matmul), then lerp and scale by 1/(N/2) before exp: the log
    error is within (2 mgc_dim + 8) eps32 x sum_d |mgc_d| max|Dinv| / (N/2),
    plus 8 ulps of the log for the lerp, exp and /1e4.  ap: the twin's
    freqt matmul and FFT round at the scale of sum_k |c_k| over its
    N/2 + 1 cepstral terms; (4 log2 N + 16) eps32 of that, plus 8 ulps."""
    eps = torch.finfo(torch.float32).eps
    M = fft_size // 2
    c = torch.cat([mgc[..., :1] - 12.0, mgc[..., 1:]], dim=-1).double()
    s_mgc = c.abs().sum(-1, keepdim=True) * np.sqrt(fft_size * M)
    lim_sp = (2 * mgc.shape[-1] + 8) * eps * s_mgc / M
    apl = ap_order(bap.shape[-1])
    b = torch.cat([bap[..., :1] + LN_1E4, bap[..., 1:]],
                  dim=-1)[..., :apl + 1].double()
    T = torch.as_tensor(codec.freqt_matrix(b.shape[-1] - 1, M, -ALPHA),
                        device=b.device)
    s_ap = (b.abs() @ T.abs()).sum(-1, keepdim=True)
    lim_ap = (4 * np.log2(fft_size) + 16) * eps * s_ap
    return lim_sp + 8 * eps, lim_ap + 8 * eps


@functools.lru_cache(maxsize=None)
def _kernel_tables(fs: int, fft_size: int, mgc_dim: int, bap_dim: int,
                   dtype, device):
    """K12's tables on the card: the Hz lerp's k (int32) and s, Dinv
    (mgc_dim, M) and W (m + 1, apl), all in `dtype` but k."""
    k, s, dinv = codec._decoding_tables(fs, fft_size, mgc_dim)
    fl = dict(dtype=dtype, device=device)
    return (torch.as_tensor(k, dtype=torch.int32, device=device),
            torch.as_tensor(s, **fl), torch.as_tensor(dinv, **fl),
            torch.as_tensor(_ap_matrix_np(bap_dim, fft_size), **fl))


def decode_features(lf0, mgc, bap, fs: int, fft_size: int):
    """K12: the synth CLI's decode of f32 or f64 features (one dtype),
    batched over leading axes (see `decode_features_plain`)."""
    if not lf0.is_cuda:
        return decode_features_plain(lf0, mgc, bap, fs, fft_size)
    lead = lf0.shape
    dt = lf0.dtype
    if (dt not in (torch.float32, torch.float64) or mgc.dtype != dt
            or bap.dtype != dt or mgc.shape[:-1] != lead
            or bap.shape[:-1] != lead or bap.shape[-1] < 2
            or mgc.shape[-1] < 1 or fft_size % 4):
        raise ValueError("decode_features: f32 or f64 lf0 (..., T), mgc "
                         "(..., T, D) and bap (..., T, >= 2) of one dtype, "
                         "N a multiple of 4")
    H = fft_size // 2 + 1
    Dm, Db = mgc.shape[-1], bap.shape[-1]
    l2 = lf0.reshape(-1).contiguous()
    m2 = mgc.reshape(-1, Dm).contiguous()
    b2 = bap.reshape(-1, Db).contiguous()
    k, s, dinv, w = _kernel_tables(fs, fft_size, Dm, Db, dt, lf0.device)
    kernels.check_cuda("decode_features", l2, m2, b2, k, s, dinv, w)
    R = l2.shape[0]
    f64 = dt == torch.float64
    f0 = torch.empty(R, dtype=dt, device=lf0.device)
    sp = torch.empty((R, H), dtype=dt, device=lf0.device)
    ap = torch.empty((R, H), dtype=dt, device=lf0.device)
    kernels.launch("codec_decode", [
        l2.data_ptr(), m2.data_ptr(), b2.data_ptr(), R, Dm, Db, H,
        k.data_ptr(), s.data_ptr(), dinv.data_ptr(), w.data_ptr(),
        w.shape[0], w.shape[1], int(f64), f0.data_ptr(), sp.data_ptr(),
        ap.data_ptr()],
        dict(lf0=lf0, mgc=mgc, bap=bap, fs=fs, fft_size=fft_size),
        variant="f64" if f64 else None)
    return (f0.reshape(lead), sp.reshape(*lead, H),
            ap.reshape(*lead, H))
