"""WORLD parameters -> HTS training features (lf0, mgc, bap).

Counterpart of `hts_train_world_tpu/cli.py:encode_features` (the encoding
that reference's `analysis` binary applies, analysis.cpp:293-358), batched
over leading axes:

- mgc: CodeSpectralEnvelope of sp*1e4 with zeros floored to 1e-4, then
  mgc[0] += 12;
- bap: CodeSpectralEnvelope of ap*1e4 (a 25-dim mel-cepstrum), then
  bap[0] -= LN_1E4, a tiny positive bap[0] snapped to 0;
- lf0: log f0 where voiced, else 0.

The two spectral encodes run as kernel K6 (csrc/codec_encode.cu): one
launch reads sp and ap once, floors and scales them, takes the log of each
bin the mel axis reads, lerps onto the mel axis and applies the DCT as a
tiled product, writing mgc and bap with their c0 fixes, in float32 (the
feature lane) or float64 (the `analysis` command's parity output, as the
JAX CLI encodes under x64).  `encode_spectra_plain`
is its plain twin (`ops/codec.py`), which runs for CPU tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import codec

LN_1E4 = 9.210340  # the literal the reference CLIs use (not full-precision ln 1e4)


def encode_spectra_plain(sp, ap, fs: int, fft_size: int, mgc_dim: int = 50,
                         bap_dim: int = 25):
    """sp, ap (..., N/2+1) -> mgc (..., mgc_dim), bap (..., bap_dim)."""
    sp4 = sp * 1e4
    sp4 = torch.where(sp4 == 0.0, 1e-4, sp4)
    mgc = codec.code_spectral_envelope(sp4, fs, fft_size, mgc_dim)
    mgc[..., 0] += 12.0
    bap = codec.code_spectral_envelope(ap * 1e4, fs, fft_size, bap_dim)
    bap0 = bap[..., 0] - LN_1E4
    bap[..., 0] = torch.where((bap0 > 0.0) & (bap0 < 1e-4), 0.0, bap0)
    return mgc, bap


def encode_spectra_limit(mgc, bap):
    """Per-element limit on |K6 - plain| for the plain result (mgc, bap):
    1e-5 of the value plus 1e-5 of the row's largest magnitude, taken
    before the c0 offsets (the DCT sums round at the scale of the raw
    coefficients; the offsets are added after them)."""
    def lim(p, c0_raw):
        raw = torch.cat([c0_raw[..., None].abs(), p[..., 1:].abs()], dim=-1)
        return 1e-5 * p.abs() + 1e-5 * raw.amax(-1, keepdim=True)
    return lim(mgc, mgc[..., 0] - 12.0), lim(bap, bap[..., 0] + LN_1E4)


# K6's mel entries a chunk (KC in csrc/codec_encode.cu; the launcher
# refuses another)
ENCODE_CHUNK = 32


@functools.lru_cache(maxsize=None)
def _kernel_tables(fs: int, fft_size: int, mgc_dim: int, bap_dim: int,
                   dtype, device):
    """K6's tables on the card: the distinct source bins the mel axis
    reads (int32), each mel entry's two bins as positions among them
    (int32 (2, M)), s, the DCT matrices (M, n_dims) zero-padded to a
    multiple of 8 columns, in `dtype` (copies: nothing here shares the
    cached numpy tables), and the most of those bins that a chunk of
    ENCODE_CHUNK mel entries reads."""
    k, s, dm = codec._coding_tables(fs, fft_size, mgc_dim)
    kb, sb, db = codec._coding_tables(fs, fft_size, bap_dim)
    assert np.array_equal(k, kb) and np.array_equal(s, sb)
    M = fft_size // 2
    lo, hi = k - 1, np.minimum(k, M)
    bins = np.unique(np.concatenate([lo, hi]))
    iu = np.stack([np.searchsorted(bins, lo), np.searchsorted(bins, hi)])
    first = np.arange(0, M, ENCODE_CHUNK)
    last = np.minimum(first + ENCODE_CHUNK, M) - 1
    nb_max = int((iu[1, last] - iu[0, first] + 1).max())
    fl = dict(dtype=dtype, device=device)

    def padded(d):
        return torch.tensor(np.pad(d, ((0, 0), (0, -d.shape[1] % 8))), **fl)
    return (torch.tensor(bins, dtype=torch.int32, device=device),
            torch.tensor(iu, dtype=torch.int32, device=device),
            torch.tensor(s, **fl), padded(dm), padded(db), nb_max)


def encode_spectra(sp, ap, fs: int, fft_size: int, mgc_dim: int = 50,
                   bap_dim: int = 25):
    """K6: the fused mgc/bap encode of f32 or f64 spectra (..., N/2+1)."""
    if not sp.is_cuda:
        return encode_spectra_plain(sp, ap, fs, fft_size, mgc_dim, bap_dim)
    n = fft_size // 2 + 1
    dt = sp.dtype
    if (dt not in (torch.float32, torch.float64) or ap.dtype != dt
            or sp.shape != ap.shape or sp.shape[-1] != n):
        raise ValueError("encode_spectra: f32 or f64 sp and ap of one shape "
                         "and dtype (..., N/2+1)")
    f64 = dt == torch.float64
    lead = sp.shape[:-1]
    sp2 = sp.reshape(-1, n).contiguous()
    ap2 = ap.reshape(-1, n).contiguous()
    bins, iu, s, dm, db, nb_max = _kernel_tables(fs, fft_size, mgc_dim,
                                                 bap_dim, dt, sp.device)
    kernels.check_cuda("encode_spectra", sp2, ap2, bins, iu, s, dm, db)
    R = sp2.shape[0]
    mgc = torch.empty((R, mgc_dim), dtype=dt, device=sp.device)
    bap = torch.empty((R, bap_dim), dtype=dt, device=sp.device)
    kernels.launch("codec_encode", [
        sp2.data_ptr(), ap2.data_ptr(), R, n, bins.data_ptr(), iu.data_ptr(),
        s.data_ptr(), fft_size // 2, ENCODE_CHUNK, nb_max, dm.data_ptr(),
        mgc_dim, dm.shape[1], db.data_ptr(), bap_dim, db.shape[1],
        int(f64), mgc.data_ptr(), bap.data_ptr()],
        dict(sp=sp, ap=ap, fs=fs, fft_size=fft_size, mgc_dim=mgc_dim,
             bap_dim=bap_dim), variant="f64" if f64 else None)
    return mgc.reshape(*lead, mgc_dim), bap.reshape(*lead, bap_dim)


def lf0_of(f0):
    """ToLF0 (analysis.cpp:216-224): log f0 where f0 != 0, else 0."""
    return torch.where(f0 != 0.0,
                       torch.log(torch.where(f0 > 0, f0, torch.ones_like(f0))),
                       torch.zeros_like(f0))


def encode_features(f0, sp, ap, fs: int, fft_size: int, mgc_dim: int = 50,
                    bap_dim: int = 25):
    """f0 (..., T), sp and ap (..., T, N/2+1) -> (lf0, mgc, bap), the
    compressed outputs of the reference `analysis` binary."""
    mgc, bap = encode_spectra(sp, ap, fs, fft_size, mgc_dim, bap_dim)
    return lf0_of(f0), mgc, bap
