"""The SPTK engine's synthesis — gen_wave's excite | mglsadf branch
(Training.pl:2873-2899): pitch-synchronous mixed excitation through the
MGLSA synthesis filter.

Counterpart of `hts_train_world_tpu/ops/excitation.py`.  Reference chain
per utterance:
  SOPR -magic -1e10 -EXP -INV -m sr -MAGIC 0   lf0 -> pitch period
  EXCITE -n -p shift           pulse train (sqrt-period amplitude) / noise
  DFS -b lowpass / highpass    makefilter.pl's band split
  VOPR -a                      voiced-low + noise-high
  MGLSADF -m M-1 -p shift -a fw    synthesis filter

- `excite` (kernel K35, csrc/excite.cu): lf0 -> period where the
  caller gives the sampling rate (`lf0_to_pitch`, XLA's exp), the
  per-sample period lerp, 1/period, the phase as a cumulative sum in
  the order of the JAX package's `jnp.cumsum` (XLA's blocked scan,
  `prims.xla_cumsum`), the onset base forward-filled by a running max,
  a pulse of sqrt(period) where floor(phase) steps, the injected noise
  where unvoiced.  The pulse positions are decided by rounding ties at
  periods that divide exactly, so the order of the sum is the JAX
  package's, bit for bit.
- `mixed_excitation` (kernel K36, csrc/band_fir.cu): the two causal
  31-tap FIRs (`jnp.convolve(..)[:n]`) and their sum.  The JAX package's
  second EXCITE run has pitch 0 everywhere, so its output is its noise:
  the port passes the noise through without a launch.
- `mglsa_synthesis` (kernel K37, csrc/mglsa_filter.cu): per frame the
  exact transfer function exp(mgc2sp) (one product for all frames on the
  FP64 tensor cores), a Hann segment of 2 shift filtered through it by
  K39's FFT core at N, the taps [-K, L+K) with K = 2 shift; then the
  overlap-add, a gather in frame order.

Noise is injected, never reproduced: `noise=` takes the JAX signatures'
arrays; without it the draws come from a `torch.Generator` on the device,
seeded by the caller.  The wrappers run the kernels for CUDA tensors
(float32 or float64 for K35 and K36; K37 float64, the engine's type) and
the twins (`*_plain`, the JAX formulation in torch) for CPU tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import codec
from hts_train_world_tpu_torch.ops import fftmat
from hts_train_world_tpu_torch.ops import prims

MAGIC = -1.0e10
PITCH_FLOOR = 1e-6


def lf0_to_pitch(lf0, sr: int):
    """SOPR -magic -1.0E+10 -EXP -INV -m sr -MAGIC 0.0: per-frame pitch
    period in samples (0 = unvoiced).  lf0: (T,) with MAGIC unvoiced.  The
    exp is XLA's (`prims.xla_exp`), so the periods are the JAX package's
    bit for bit and the pulses at exact periods fall where its do."""
    return torch.where(lf0 == MAGIC, torch.zeros_like(lf0),
                       prims.rdiv(float(sr), prims.xla_exp(lf0)))


def _per_sample_pitch(pitch, shift: int):
    """EXCITE's linear inter-frame interpolation of the period, one value
    per output sample ((T-1)*shift samples)."""
    T = pitch.shape[0]
    n = (T - 1) * shift
    pos = prims.exact_div(torch.arange(n, dtype=pitch.dtype,
                                       device=pitch.device), float(shift))
    i0 = torch.floor(pos).long().clamp(0, T - 2)
    frac = pos - i0.to(pitch.dtype)
    p0 = pitch[i0]
    p1 = pitch[i0 + 1]
    # a frame boundary into/out of unvoiced does not interpolate through 0
    both = (p0 > 0) & (p1 > 0)
    return torch.where(both, p0 + (p1 - p0) * frac, p0)


def excite_plain(pitch, shift: int, noise, sr=None):
    """EXCITE -n -p shift as the JAX package writes it (cumsum phase,
    running-max onset reset): (excitation (n,), voiced (n,)).  With `sr`,
    `pitch` is lf0 and goes through `lf0_to_pitch(pitch, sr)` first."""
    if sr is not None:
        pitch = lf0_to_pitch(pitch, sr)
    p = _per_sample_pitch(pitch, shift)
    voiced = p > 0.0
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    freq = torch.where(voiced, prims.rdiv(1.0, p.clamp(min=PITCH_FLOOR)),
                       zero)
    raw = prims.xla_cumsum(freq)
    onset = voiced & ~torch.cat([voiced.new_zeros(1), voiced[:-1]])
    # raw - freq and raw - base as written: raw - (raw - freq) is not freq
    base = torch.cummax(torch.where(onset, raw - freq, zero), dim=0).values
    phase = raw - base
    fired = torch.floor(phase) > torch.floor(
        torch.cat([phase.new_zeros(1), phase[:-1]]))
    pulse = torch.where(voiced & fired, prims.ieee_sqrt(p.clamp(
        min=PITCH_FLOOR)), zero)
    return torch.where(voiced, pulse, noise), voiced


def _scan_levels(n: int) -> list:
    """The blocked scan's level lengths: n, ceil(n/16), ... down to the
    first of at most 16 (`prims.xla_cumsum`'s recursion)."""
    sizes = [n]
    while sizes[-1] > prims.XLA_SCAN_BLOCK:
        sizes.append(-(-sizes[-1] // prims.XLA_SCAN_BLOCK))
    return sizes


def _dtype_ok(*ts) -> bool:
    return (ts[0].dtype in (torch.float32, torch.float64)
            and all(t.dtype == ts[0].dtype for t in ts))


def excite(pitch, shift: int, noise=None, generator=None, sr=None):
    """K35: pitch (T,) -> (excitation (n,), voiced (n,) bool), n =
    (T-1)*shift.  `noise` (n,) is used where unvoiced; without it one is
    drawn from `generator` (a seeded `torch.Generator` on the device).
    With the sampling rate `sr`, the first argument is lf0 (MAGIC
    unvoiced, float64) and the kernel takes `lf0_to_pitch(lf0, sr)` of it
    in the same launch."""
    T = pitch.shape[0]
    n = (T - 1) * shift
    if noise is None:
        noise = torch.randn(n, generator=generator, dtype=pitch.dtype,
                            device=pitch.device)
    if not pitch.is_cuda:
        return excite_plain(pitch, shift, noise, sr)
    if (not _dtype_ok(pitch, noise) or pitch.dim() != 1 or T < 2
            or shift < 1 or noise.shape != (n,)
            or (sr is not None and (pitch.dtype != torch.float64
                                    or not sr > 0))):
        raise ValueError("excite: float32 or float64 pitch (T,) (lf0 in "
                         "float64 with sr > 0), T >= 2, noise (n,) of its "
                         "type")
    pitch, noise = pitch.contiguous(), noise.contiguous()
    kernels.check_cuda("excite", pitch, noise)
    scratch = torch.empty(sum(_scan_levels(n)) + n
                          + (T if sr is not None else 0),
                          dtype=pitch.dtype, device=pitch.device)
    out = torch.empty(n, dtype=pitch.dtype, device=pitch.device)
    voiced = torch.empty(n, dtype=torch.bool, device=pitch.device)
    kernels.launch("excite", [
        pitch.data_ptr(), T, shift, float(sr or 0), noise.data_ptr(),
        int(pitch.dtype == torch.float64), scratch.data_ptr(),
        out.data_ptr(), voiced.data_ptr()],
        dict(pitch=pitch, shift=int(shift), noise=noise, sr=sr))
    return out, voiced


def fir(x, b):
    """DFS -b: direct-form FIR y[t] = sum_k b[k] x[t-k] (the taps in
    order, each product rounded, then added)."""
    b = torch.as_tensor(np.asarray(b), dtype=x.dtype, device=x.device)
    y = b[0] * x
    for k in range(1, min(len(b), x.shape[0])):
        y = torch.cat([y[:k], y[k:] + b[k] * x[:-k]])
    return y


def band_fir_plain(voiced_ex, noise_ex, lowpass, highpass):
    """The mixed excitation: fir(voiced_ex, lowpass) + fir(noise_ex,
    highpass)."""
    return fir(voiced_ex, lowpass) + fir(noise_ex, highpass)


@functools.lru_cache(maxsize=8)
def _taps_tensor(key: bytes, device):
    """The (2, K) float64 taps on the device, one copy per filter pair
    (keyed by its bytes, so a call costs a hash of 2 K doubles)."""
    return torch.frombuffer(bytearray(key), dtype=torch.float64).reshape(
        2, -1).to(device)


def band_fir(voiced_ex, noise_ex, lowpass, highpass):
    """K36: two (n,) excitations -> their band-split sum (n,)."""
    if not voiced_ex.is_cuda:
        return band_fir_plain(voiced_ex, noise_ex, lowpass, highpass)
    low, high = (np.asarray(f, dtype=np.float64) for f in (lowpass,
                                                          highpass))
    if (not _dtype_ok(voiced_ex, noise_ex) or voiced_ex.dim() != 1
            or noise_ex.shape != voiced_ex.shape or low.ndim != 1
            or low.shape != high.shape or not 1 <= len(low) <= 64):
        raise ValueError("band_fir: two float32 or float64 (n,) "
                         "excitations of one type, two filters of one "
                         "length <= 64")
    v, u = voiced_ex.contiguous(), noise_ex.contiguous()
    taps = _taps_tensor(low.tobytes() + high.tobytes(), v.device)
    kernels.check_cuda("band_fir", v, u, taps)
    out = torch.empty_like(v)
    kernels.launch("band_fir", [
        v.data_ptr(), u.data_ptr(), v.shape[0], taps.data_ptr(), len(low),
        int(v.dtype == torch.float64), out.data_ptr()],
        dict(voiced_ex=voiced_ex, noise_ex=noise_ex, lowpass=low,
             highpass=high))
    return out


def mixed_excitation(pitch, shift: int, lowpass, highpass, noise=None,
                     generator=None, sr=None):
    """The reference's two EXCITE runs (Training.pl:2884-2890): the pitch
    excitation low-passed plus the noise excitation (pitch 0 everywhere,
    so its output is its noise) high-passed.  noise: (n0, n1), each (n,)
    (JAX's `noise=` pair), or None for two draws from `generator`.  With
    `sr`, `pitch` is lf0, as `excite` takes it."""
    n = (pitch.shape[0] - 1) * shift
    if noise is None:
        noise = torch.randn(2, n, generator=generator, dtype=pitch.dtype,
                            device=pitch.device)
    n0, n1 = (a.to(pitch.device, pitch.dtype) if isinstance(a, torch.Tensor)
              else torch.tensor(a, dtype=pitch.dtype, device=pitch.device)
              for a in noise)
    voiced_ex, voiced = excite(pitch, shift, noise=n0, sr=sr)
    return band_fir(voiced_ex, n1, lowpass, highpass), voiced


def _mglsa_dims(shift: int, fft_size: int):
    L = K = 2 * shift
    if L + K > fft_size:
        raise ValueError(f"mglsa_synthesis: fft_size {fft_size} < 4 shift "
                         f"({4 * shift})")
    return L, K


@functools.lru_cache(maxsize=8)
def _hann(L: int, dtype, device):
    return torch.tensor(np.hanning(L + 1)[:L], dtype=dtype, device=device)


def mglsa_synthesis_plain(excitation, mgc, alpha: float, shift: int,
                          fft_size: int = 1024):
    """MGLSADF as the JAX package writes it: each frame's excitation
    through the frame's exact transfer function |H| = exp(mgc2sp) by a
    Hann-windowed (50 %) overlap-add with zero-phase taps [-K, L+K)."""
    exc = excitation
    T = mgc.shape[0]
    n = exc.shape[0]
    L, K = _mglsa_dims(shift, fft_size)
    H = torch.exp(codec.mgc2sp_real(mgc, alpha, fft_size))
    win = _hann(L, exc.dtype, exc.device)
    pad = torch.cat([exc.new_zeros(shift), exc, exc.new_zeros(L)])
    starts = torch.arange(T, device=exc.device) * shift
    segs = pad[starts[:, None] + torch.arange(L, device=exc.device)] * win
    spec = torch.fft.rfft(segs, n=fft_size, dim=-1)
    filt = torch.fft.irfft(spec * H, n=fft_size, dim=-1)
    seg_out = torch.cat([filt[:, fft_size - K:], filt[:, :L + K]], dim=-1)
    out = exc.new_zeros(T * shift + L + 2 * K)
    idx = (starts[:, None] + torch.arange(L + 2 * K,
                                          device=exc.device)).reshape(-1)
    out.index_add_(0, idx, seg_out.reshape(-1))
    return out[K + shift:K + shift + n]


def mglsa_table(order: int, alpha: float, fft_size: int) -> np.ndarray:
    """(order+1, N/2+1) float64: mgc @ table is `codec.mgc2sp_real`'s log
    |H| (freqt to N/2 at -alpha, then the real part of an rfft at N)."""
    f2 = fft_size // 2
    k = np.arange(f2 + 1)
    cos = np.cos(2.0 * np.pi * (np.outer(k, k) % fft_size) / fft_size)
    return codec.freqt_matrix(order, f2, -alpha) @ cos


@functools.lru_cache(maxsize=8)
def _mglsa_tables(order: int, alpha: float, fft_size: int, L: int, device):
    """K37's constants on the card: the folded table G, the Hann window,
    and where N is a power of two in K39's range its two twiddle tables
    (the forward's plan, sparse where `fftmat.r2c_plan` takes it, and the
    dense inverse's); else None, None (the direct DFT)."""
    f64 = torch.float64
    G = torch.tensor(mglsa_table(order, alpha, fft_size), dtype=f64,
                     device=device)
    N = fft_size
    if not (fftmat.MIN_N <= N <= fftmat.MAX_N and N & (N - 1) == 0):
        return G, _hann(L, f64, device), None, None, False
    sparse = fftmat.r2c_plan(N, L)[0]
    return (G, _hann(L, f64, device), fftmat._r2c_table(N, sparse, device),
            fftmat._r2c_table(N, False, device), sparse)


def mglsa_synthesis(excitation, mgc, alpha: float, shift: int,
                    fft_size: int = 1024):
    """K37: excitation (n,) and mgc (T, M) -> the waveform (n,), float64.
    Two launches: the frames' taps (T, L+2K) into scratch (H = exp(mgc G)
    for all frames, then the frames' FFTs), then the overlap-add gather.
    mgc may have a row stride (its columns contiguous)."""
    if not excitation.is_cuda:
        return mglsa_synthesis_plain(excitation, mgc, alpha, shift,
                                     fft_size)
    L, K = _mglsa_dims(shift, fft_size)
    f64 = torch.float64
    if (excitation.dtype != f64 or mgc.dtype != f64
            or excitation.dim() != 1 or mgc.dim() != 2
            or not 1 <= mgc.shape[1] <= 256 or fft_size > 8192):
        raise ValueError("mglsa_synthesis: float64 excitation (n,) and mgc "
                         "(T, M) on the card, M <= 256, fft_size <= 8192")
    exc = excitation.contiguous()
    c = (mgc if mgc.stride(1) == 1 and mgc.stride(0) >= mgc.shape[1]
         else mgc.contiguous())
    T, M = c.shape
    n = exc.shape[0]
    N = int(fft_size)
    dev = exc.device
    G, win, tw_f, tw_i, sparse = _mglsa_tables(M - 1, float(alpha), N, L,
                                               dev)
    kernels.check_cuda("mglsa_filter", exc, c[:1], G, win)
    F, W = N // 2 + 1, L + 2 * K
    scratch = torch.empty(T * (F + W), dtype=f64, device=dev)   # H, taps
    taps = scratch[T * F:]
    out = torch.empty(n, dtype=f64, device=dev)
    kernels.launch("mglsa_filter", [
        exc.data_ptr(), n, c.data_ptr(), T, M, c.stride(0), G.data_ptr(),
        win.data_ptr(), shift, N, 0 if tw_f is None else tw_f.data_ptr(),
        0 if tw_i is None else tw_i.data_ptr(), int(sparse),
        scratch.data_ptr(), taps.data_ptr()],
        dict(excitation=excitation, mgc=mgc, alpha=float(alpha),
             shift=int(shift), fft_size=N),
        fn="mglsa_frames_launch")
    kernels.launch("mglsa_filter", [
        taps.data_ptr(), T, shift, W, n, out.data_ptr()], None,
        fn="mglsa_ola_launch")
    return out


def lsp_branch_to_mgc(mgc_lsp, alpha: float, gamma_stages: int,
                      pf: float = 0.0, log_gain: bool = True):
    """gen_wave's gm>0 preamble (Training.pl:2860-2866): optional LSP
    postfilter, stability projection (lspcheck -c -r), LSP -> LPC, then
    mgc2mgc to the normalized mel-generalized cepstrum."""
    from hts_train_world_tpu_torch.ops import postfilter as pf_mod
    from hts_train_world_tpu_torch.ops import sptk
    x = mgc_lsp
    if pf and pf != 1.0:
        x = pf_mod.lsp_postfilter(x, pf)
    gain = x[..., 0]
    lsp = pf_mod.lsp_check(x[..., 1:])
    a = pf_mod.lsp_to_lpc(lsp)
    g = gain if log_gain else torch.log(gain.clamp(min=1e-12))
    lpc = torch.cat([torch.exp(g)[..., None], a], dim=-1)
    gamma = -1.0 / gamma_stages
    return sptk.mgc2mgc(lpc, 0.0, gamma, x.shape[-1] - 1, alpha, gamma)


def synthesize_sptk(lf0, mgc, fs: int, sr_shift: int, alpha: float,
                    lowpass, highpass, fft_size: int = 1024, noise=None,
                    generator=None):
    """The full gen_wave SPTK branch for one utterance: lf0 (T,) with
    MAGIC unvoiced, mgc (T, M) mel-cepstra, float64 tensors on one device
    -> the waveform ((T-1)*shift,).  noise: (n0, n1) as
    `mixed_excitation` takes it."""
    exc, _ = mixed_excitation(lf0, sr_shift, lowpass, highpass, noise,
                              generator, sr=fs)
    return mglsa_synthesis(exc, mgc, alpha, sr_shift, fft_size)
