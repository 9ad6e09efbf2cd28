"""WORLD waveform synthesis, fast path (cumsum phase), batched.

Counterpart of `hts_train_world_tpu/ops/synthesis.py` with
exact_phase=False (externs/WORLD_v2/src/synthesis.cpp).  Four kernels
carry it on the card, each with its plain PyTorch twin here, which runs
for CPU tensors:

- K9 `time_base` (csrc/synth_time_base.cu): GetTimeBase (coarse f0/vuv,
  interpolation to the sample rate, the phase sum, the wrapped-phase jump
  mask), the compaction of the pulses to the pulse cap and each pulse's
  time shift, time, noise size and offset and V/UV flag.  The phase sum
  runs sequentially in a float64 accumulator, rounding each output to the
  working dtype, in the kernel and in the twin (the CPU's `torch.cumsum`
  of f32 does the same), so the card and the CPU fire the same pulses.
  `count_pulses` is the same launch without the per-pulse outputs.
- K10 `pulse_spectra` (csrc/synth_pulse_spectra.cu): per pulse the
  frame-interpolated envelope and aperiodicity, the periodic and
  aperiodic log spectra and the mean-removed noise segment: the inputs of
  the first DFT matmuls.
- K11 `overlap_add` (csrc/synth_ola.cu): fftshift, the DC remover, the
  unvoiced mask, the sqrt(noise size) scale and the valid-pulse mask of
  each response, and the overlap-add as a gather that sums each output
  sample's responses in pulse order (the order the twin's `index_add_`
  adds them on the CPU): no atomics, the same result on every run.
- K30 `midpass` (csrc/synth_midpass.cu): between K10 and K11, the
  min-phase spectra (exp/cos/sin), the fractional-delay factor and the
  noise product, one fused pass between the DFT matmuls of `fftmat`
  (which stay `torch.matmul`, as the JAX package leaves them to XLA).

Every twin is dtype-generic (float32 on the card, float64 in the tests
against the JAX package); the kernels take float32.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import fftmat, prims


def synthesis_stream_len(y_length: int) -> int:
    """Noise draws consumed <= y_length (sum of pulse gaps)."""
    return y_length + 16


def default_max_pulses(y_length: int, fs: int) -> int:
    # pulse rate <= f0_ceil (800) voiced, kDefaultF0 (500) unvoiced; the
    # end-of-contour extrapolation overshoots only within the last frame
    return int(y_length * 810.0 / fs) + 80


class Pulses(NamedTuple):
    """The time base's pulses: n (B,) int64 count of all pulses; the rest
    (B, P) over the pulse cap, slots past the count holding y_length - 2
    as their sample index."""
    n: torch.Tensor
    pidx: torch.Tensor          # int64 sample index
    time_shift: torch.Tensor    # fractional-delay of the wrap, seconds
    pulse_time: torch.Tensor    # pidx / fs
    noise_size: torch.Tensor    # int64 gap to the next pulse (0 for the last)
    noise_off: torch.Tensor     # int64 exclusive sum of the gaps
    vuv: torch.Tensor           # interpolated V/UV flag at the pulse


# ---------------------------------------------------------------------------
# K9: the time base and the pulses
# ---------------------------------------------------------------------------


def _increments(f0, frame_period: float, fs: int, y_length: int,
                fft_size: int):
    """GetTimeBase (synthesis.cpp:223-320) up to the phase sum: f0 (B, T)
    -> (ivuv, the per-sample phase increments 2 pi if0 / fs), each
    (B, y_length)."""
    dtype, dev = f0.dtype, f0.device
    T = f0.shape[1]
    fp = frame_period / 1000.0
    lowest_f0 = fs / fft_size + 1.0
    zero = torch.zeros((), dtype=dtype, device=dev)
    coarse_time = torch.arange(T + 1, dtype=dtype, device=dev) * fp
    cf0 = torch.where(f0 < lowest_f0, zero, f0)
    cvuv = torch.where(cf0 == 0.0, zero, torch.ones((), dtype=dtype,
                                                    device=dev))
    cf0 = torch.cat([cf0, (cf0[:, -1] * 2 - cf0[:, -2])[:, None]], dim=1)
    cvuv = torch.cat([cvuv, (cvuv[:, -1] * 2 - cvuv[:, -2])[:, None]], dim=1)
    time_axis = prims.exact_div(
        torch.arange(y_length, dtype=dtype, device=dev), float(fs))
    if0 = prims.interp1(coarse_time, cf0, time_axis)
    ivuv = prims.interp1(coarse_time, cvuv, time_axis)
    ivuv = torch.where(ivuv > 0.5, 1.0, 0.0).to(dtype)
    if0 = torch.where(ivuv == 0.0, torch.full_like(if0, cfg.K_DEFAULT_F0),
                      if0)
    return ivuv, prims.exact_div(2.0 * np.pi * if0, fs)


def phase_increments(f0, frame_period: float, fs: int, y_length: int,
                     fft_size: int):
    """The increments K9 sums (B, y_length), for timing the library's
    `torch.cumsum` beside it."""
    return _increments(f0, frame_period, fs, y_length, fft_size)[1]


def time_base_plain(f0, frame_period: float, fs: int, y_length: int,
                    fft_size: int, max_pulses: int) -> Pulses:
    """K9's twin: f0 (B, T) -> Pulses over a cap of max_pulses (0: the
    count alone, the per-pulse fields (B, 0))."""
    dtype, dev = f0.dtype, f0.device
    ivuv, inc = _increments(f0, frame_period, fs, y_length, fft_size)
    # sequential float64 sum, each output rounded to dtype
    total_phase = torch.cumsum(inc, dim=1, dtype=torch.float64).to(dtype)
    wrap = torch.remainder(total_phase, 2.0 * np.pi)
    jump = torch.abs(wrap[:, 1:] - wrap[:, :-1]) > np.pi
    n = jump.sum(dim=1)
    P = max_pulses
    pidx = prims.compact_indices(jump, P, y_length - 2)       # (B, P)
    slot = torch.arange(P, device=dev)[None, :]
    y1 = torch.gather(wrap, 1, pidx) - 2.0 * np.pi
    y2 = torch.gather(wrap, 1, pidx + 1)
    time_shift = prims.exact_div(-y1 / (y2 - y1), float(fs))
    pulse_time = prims.exact_div(pidx.to(dtype), float(fs))
    pidx_next = torch.where(slot + 1 < n[:, None],
                            torch.roll(pidx, -1, dims=1), pidx)
    noise_size = pidx_next - pidx
    noise_off = torch.cumsum(noise_size, dim=1) - noise_size
    vuv = torch.gather(ivuv, 1, pidx)
    return Pulses(n, pidx, time_shift, pulse_time, noise_size, noise_off,
                  vuv)


def time_base(f0, frame_period: float, fs: int, y_length: int,
              fft_size: int, max_pulses: int) -> Pulses:
    """K9: the time base and the first max_pulses pulses of f32 contours
    f0 (B, T >= 2), one block per utterance."""
    if not f0.is_cuda:
        return time_base_plain(f0, frame_period, fs, y_length, fft_size,
                               max_pulses)
    if f0.dtype != torch.float32 or f0.dim() != 2 or f0.shape[1] < 2 \
            or y_length < 2 or max_pulses < 0:
        raise ValueError("time_base: f32 contours (B, T >= 2), y_length >= "
                         "2 and max_pulses >= 0")
    f0 = f0.contiguous()
    kernels.check_cuda("time_base", f0)
    B, T = f0.shape
    P = max_pulses
    dev = f0.device
    n = torch.empty(B, dtype=torch.long, device=dev)
    ints = torch.empty((3, B, P), dtype=torch.long, device=dev)
    flts = torch.empty((3, B, P), dtype=torch.float32, device=dev)
    kernels.launch("synth_time_base", [
        f0.data_ptr(), B, T, y_length, P,
        float(np.float32(frame_period / 1000.0)),
        float(np.float32(fs / fft_size + 1.0)), float(fs), n.data_ptr(),
        ints[0].data_ptr(), ints[1].data_ptr(), ints[2].data_ptr(),
        flts[0].data_ptr(), flts[1].data_ptr(), flts[2].data_ptr()],
        dict(f0=f0, frame_period=frame_period, fs=fs, y_length=y_length,
             fft_size=fft_size, max_pulses=max_pulses))
    return Pulses(n, ints[0], flts[0], flts[1], ints[1], ints[2], flts[2])


def count_pulses(f0, frame_period: float, fs: int, y_length: int,
                 fft_size: int):
    """Exact fast-mode pulse count per utterance (B,): K9 without the
    per-pulse outputs, the same arithmetic as synthesis."""
    return time_base(f0, frame_period, fs, y_length, fft_size, 0).n


# ---------------------------------------------------------------------------
# K10: per-pulse spectra and noise segments
# ---------------------------------------------------------------------------


def pulse_spectra_plain(sp, ap, stream, pulse_time, vuv, noise_size,
                        noise_off, frame_period: float, fft_size: int):
    """K10's twin.  sp, ap (B, T, N/2+1), stream (B, S) white noise and
    the pulses' time, V/UV flag, noise size and offset (B, P) ->
    (log_p, log_a (B, P, N/2+1), noise (B, P, N), unvoiced (B, P) bool)."""
    dtype, dev = sp.dtype, sp.device
    B, T, H = sp.shape
    P = pulse_time.shape[1]
    N = fft_size
    zero = torch.zeros((), dtype=dtype, device=dev)
    # frame interpolation of envelope and aperiodicity at each pulse
    pos = prims.exact_div(pulse_time, frame_period / 1000.0)
    fl = torch.clamp(torch.floor(pos), max=T - 1).long()
    ce = torch.clamp(torch.ceil(pos), max=T - 1).long()
    frac = (pos - torch.floor(pos))[..., None]
    same = (fl == ce)[..., None]

    def lerp(table):
        a = torch.gather(table, 1, fl[..., None].expand(B, P, H))
        b = torch.gather(table, 1, ce[..., None].expand(B, P, H))
        return torch.where(same, a, a * (1.0 - frac) + b * frac)

    sp_env = lerp(torch.abs(sp))
    apr = lerp(torch.clamp(ap, 0.001, 0.999999999999))
    apr = apr * apr
    unvoiced = (vuv <= 0.5) | (apr[..., 0] > 0.999)
    log_p = torch.log(sp_env * (1.0 - apr)
                      + cfg.K_MY_SAFE_GUARD_MINIMUM) / 2.0
    tiny = prims.tiny_floor(dtype)
    log_a = torch.where(vuv[..., None] != 0.0,
                        torch.log(torch.clamp(sp_env * apr, min=tiny)) / 2.0,
                        torch.log(torch.clamp(sp_env, min=tiny)) / 2.0)
    # the noise segment of each pulse, mean removed (synthesis.cpp:38-68)
    kj = torch.arange(N, device=dev)
    ns = noise_size[..., None]
    stream_p = torch.cat([stream, torch.zeros((B, N), dtype=dtype,
                                              device=dev)], dim=1)
    noise = torch.gather(stream_p, 1, (noise_off[..., None] + kj)
                         .reshape(B, P * N)).reshape(B, P, N)
    noise = torch.where(kj < ns, noise, zero)
    avg = noise.sum(dim=-1, keepdim=True) / torch.clamp(ns, min=1)
    noise = torch.where(kj < ns, noise - avg, zero)
    return log_p, log_a, noise, unvoiced


def pulse_spectra_limit(log_p, log_a, noise, stream):
    """Per-element limits on |K10 - twin| for the twin's (log_p, log_a,
    noise): the logs within 4 f32 ulps of their magnitude plus 4 ulps of
    1 (CUDA's logf and PyTorch's log each err by under an ulp or two);
    the noise within 1e-5 of the stream's largest magnitude (the segment
    means sum up to N f32 terms in two orders)."""
    eps = torch.finfo(torch.float32).eps
    return (4 * eps * (log_p.abs() + 1.0), 4 * eps * (log_a.abs() + 1.0),
            torch.full_like(noise, 1e-5 * float(stream.abs().max())))


def pulse_spectra(sp, ap, stream, pulse_time, vuv, noise_size, noise_off,
                  frame_period: float, fft_size: int):
    """K10: one block per pulse writes its log spectra, its noise segment
    and its unvoiced flag (f32 inputs; see `pulse_spectra_plain`)."""
    if not sp.is_cuda:
        return pulse_spectra_plain(sp, ap, stream, pulse_time, vuv,
                                   noise_size, noise_off, frame_period,
                                   fft_size)
    B, T, H = sp.shape
    P = pulse_time.shape[1]
    N = fft_size
    if (sp.dtype != torch.float32 or ap.dtype != torch.float32
            or stream.dtype != torch.float32
            or pulse_time.dtype != torch.float32
            or vuv.dtype != torch.float32 or ap.shape != sp.shape
            or H != N // 2 + 1 or stream.dim() != 2
            or stream.shape[0] != B
            or pulse_time.shape != (B, P) or vuv.shape != (B, P)
            or noise_size.shape != (B, P) or noise_off.shape != (B, P)
            or noise_size.dtype != torch.long
            or noise_off.dtype != torch.long):
        raise ValueError("pulse_spectra: f32 sp, ap (B, T, N/2+1), stream "
                         "(B, S), pulse_time and vuv (B, P) f32, noise "
                         "size and offset (B, P) int64")
    sp, ap, stream, pulse_time, vuv, noise_size, noise_off = (
        t.contiguous() for t in (sp, ap, stream, pulse_time, vuv,
                                 noise_size, noise_off))
    kernels.check_cuda("pulse_spectra", sp, ap, stream, pulse_time, vuv,
                       noise_size, noise_off)
    dev = sp.device
    log_pa = torch.empty((2, B, P, H), dtype=torch.float32, device=dev)
    noise = torch.empty((B, P, N), dtype=torch.float32, device=dev)
    unvoiced = torch.empty((B, P), dtype=torch.bool, device=dev)
    kernels.launch("synth_pulse_spectra", [
        sp.data_ptr(), ap.data_ptr(), B, T, H, stream.data_ptr(),
        stream.shape[1], pulse_time.data_ptr(), vuv.data_ptr(),
        noise_size.data_ptr(), noise_off.data_ptr(), P, N,
        float(np.float32(frame_period / 1000.0)),
        float(prims.tiny_floor(torch.float32)), log_pa[0].data_ptr(),
        log_pa[1].data_ptr(), noise.data_ptr(), unvoiced.data_ptr()],
        dict(sp=sp, ap=ap, stream=stream, pulse_time=pulse_time, vuv=vuv,
             noise_size=noise_size, noise_off=noise_off,
             frame_period=frame_period, fft_size=fft_size))
    return log_pa[0], log_pa[1], noise, unvoiced


# ---------------------------------------------------------------------------
# K11: response finish + overlap-add
# ---------------------------------------------------------------------------


def _dc_remover_np(fft_size: int) -> np.ndarray:
    """GetDCRemover (synthesis.cpp:322-334), numpy f64."""
    half = fft_size // 2
    i = np.arange(half)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (i + 1.0) / (1.0 + fft_size))
    dc = np.sum(w) * 2.0
    w = w / dc
    return np.concatenate([w, w[::-1]])


@functools.lru_cache(maxsize=None)
def _dc_remover(fft_size: int, dtype, device):
    return torch.as_tensor(_dc_remover_np(fft_size), dtype=dtype,
                           device=device)


def halving_sum(x):
    """Sum over the last axis by halving (x[:h] + x[h:], zero-padded to a
    power of two): a fixed order the kernel repeats."""
    n = x.shape[-1]
    p2 = 1 << max(n - 1, 0).bit_length()
    if p2 != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p2 - n,))], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def finish_responses(per_raw, aper_raw, unvoiced, noise_size, n):
    """The twin's response finish (synthesis.cpp:73-82,105-138): fftshift,
    the DC remover (its DC a halving sum), the unvoiced mask, (per
    sqrt(ns) + aper) / N and the valid-pulse mask -> (B, P, N)."""
    dtype, dev = per_raw.dtype, per_raw.device
    B, P, N = per_raw.shape
    half = N // 2
    zero = torch.zeros((), dtype=dtype, device=dev)
    per = prims.fftshift(per_raw)
    dc = halving_sum(per[..., half:])[..., None]
    dc_rm = _dc_remover(N, dtype, dev)
    kj = torch.arange(N, device=dev)
    per = torch.where(kj < half, -dc * dc_rm, per - dc * dc_rm)
    per = torch.where(unvoiced[..., None], zero, per)
    ns = noise_size[..., None]
    resp = prims.exact_div(per * torch.sqrt(ns.to(dtype))
                           + prims.fftshift(aper_raw), N)
    valid = (torch.arange(P, device=dev)[None, :] < n[:, None]) \
        & (noise_size > 0)
    return torch.where(valid[..., None], resp, zero)


def ola_index(pidx, N: int, y_length: int):
    """The OLA's flat target of every response element: response k of
    pulse p of utterance b lands at b Lb + pidx + 1 + k, Lb = y_length +
    N + 1, the output being [N/2, N/2 + y_length) of each row."""
    B = pidx.shape[0]
    Lb = y_length + N + 1
    kj = torch.arange(N, device=pidx.device)
    return (((torch.arange(B, device=pidx.device) * Lb)[:, None, None]
             + (pidx + 1)[..., None] + kj).reshape(-1), Lb)


def overlap_add_plain(per_raw, aper_raw, unvoiced, pidx, noise_size, n,
                      y_length: int):
    """K11's twin.  per_raw, aper_raw (B, P, N): the periodic and aperiodic
    irfft * N before fftshift; unvoiced, pidx, noise_size (B, P); n (B,)
    the pulse count -> waveform (B, y_length)."""
    B, P, N = per_raw.shape
    resp = finish_responses(per_raw, aper_raw, unvoiced, noise_size, n)
    # OLA (synthesis.cpp:378-383); skipped slots add exact zeros
    at, Lb = ola_index(pidx, N, y_length)
    out = torch.zeros(B * Lb, dtype=per_raw.dtype, device=per_raw.device)
    out.index_add_(0, at, resp.reshape(-1))
    return out.reshape(B, Lb)[:, N // 2:N // 2 + y_length]


def overlap_add(per_raw, aper_raw, unvoiced, pidx, noise_size, n,
                y_length: int):
    """K11: the responses finished and overlap-added as a gather: each
    output sample sums, in ascending pulse order from 0, the responses
    that cover it (f32; pidx ascending, as K9 writes it)."""
    if not per_raw.is_cuda:
        return overlap_add_plain(per_raw, aper_raw, unvoiced, pidx,
                                 noise_size, n, y_length)
    B, P, N = per_raw.shape
    if (per_raw.dtype != torch.float32 or aper_raw.dtype != torch.float32
            or aper_raw.shape != per_raw.shape or N % 2
            or unvoiced.dtype != torch.bool or unvoiced.shape != (B, P)
            or pidx.dtype != torch.long or pidx.shape != (B, P)
            or noise_size.dtype != torch.long
            or noise_size.shape != (B, P) or n.dtype != torch.long
            or n.shape != (B,) or y_length < 1):
        raise ValueError("overlap_add: f32 responses (B, P, N even), "
                         "unvoiced (B, P) bool, pidx and noise_size (B, P) "
                         "int64, n (B,) int64")
    per_raw, aper_raw, unvoiced, pidx, noise_size, n = (
        t.contiguous() for t in (per_raw, aper_raw, unvoiced, pidx,
                                 noise_size, n))
    dc_rm = _dc_remover(N, torch.float32, per_raw.device)
    kernels.check_cuda("overlap_add", per_raw, aper_raw, unvoiced, pidx,
                       noise_size, n, dc_rm)
    dc = torch.empty((B, P), dtype=torch.float32, device=per_raw.device)
    y = torch.empty((B, y_length), dtype=torch.float32,
                    device=per_raw.device)
    kernels.launch("synth_ola", [
        per_raw.data_ptr(), aper_raw.data_ptr(), unvoiced.data_ptr(),
        pidx.data_ptr(), noise_size.data_ptr(), n.data_ptr(), B, P, N,
        dc_rm.data_ptr(), y_length, dc.data_ptr(), y.data_ptr()],
        dict(per_raw=per_raw, aper_raw=aper_raw, unvoiced=unvoiced,
             pidx=pidx, noise_size=noise_size, n=n, y_length=y_length))
    return y


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------


def midpass_plain(lpr, lpi, lar, lai, nre, nim, coef):
    """K30's twin.  lpr, lpi = log_p @ (R, I) and lar, lai = log_a @ (R, I)
    (the min-phase tables), nre, nim the noise spectrum, each (B, P, H);
    coef (B, P) = 2 pi shift fs / N -> (sre, sim, pre, pim), the periodic
    spectrum times the conjugate fractional delay (re2 = cos(coef k), im2 =
    sqrt(1 - re2^2), synthesis.cpp:105-138) and the aperiodic spectrum
    times the noise spectrum (synthesis.cpp:38-68)."""
    k = torch.arange(lpr.shape[-1], dtype=lpr.dtype, device=lpr.device)
    re2 = torch.cos(coef[..., None] * k)
    im2 = torch.sqrt(1.0 - re2 * re2)
    mag = torch.exp(lpr)
    re, im = mag * torch.cos(lpi), mag * torch.sin(lpi)
    amag = torch.exp(lar)
    are, aim = amag * torch.cos(lai), amag * torch.sin(lai)
    return (re * re2 + im * im2, im * re2 - re * im2,
            are * nre - aim * nim, are * nim + aim * nre)


def midpass(lpr, lpi, lar, lai, nre, nim, coef):
    """K30: `midpass_plain`'s contract in one fused pass (f32)."""
    if not lpr.is_cuda:
        return midpass_plain(lpr, lpi, lar, lai, nre, nim, coef)
    ins = (lpr, lpi, lar, lai, nre, nim)
    if (any(t.dtype != torch.float32 or t.shape != lpr.shape for t in ins)
            or coef.dtype != torch.float32
            or coef.shape != lpr.shape[:-1]):
        raise ValueError("midpass: six f32 (..., H) spectra of one shape "
                         "and f32 coef (...)")
    H = lpr.shape[-1]
    ins = tuple(t.contiguous() for t in ins)
    coef = coef.contiguous()
    kernels.check_cuda("midpass", *ins, coef)
    outs = tuple(torch.empty_like(lpr) for _ in range(4))
    kernels.launch("synth_midpass", [
        *(t.data_ptr() for t in ins), coef.data_ptr(), coef.numel(), H,
        *(t.data_ptr() for t in outs)],
        dict(lpr=lpr, lpi=lpi, lar=lar, lai=lai, nre=nre, nim=nim,
             coef=coef))
    return outs


def responses(log_p, log_a, noise, time_shift, fs: int, fft_size: int):
    """The mid-pass: min-phase spectra x fractional-delay phase and x
    noise spectrum (K30), between the DFT matmuls -> (per_raw, aper_raw)
    (B, P, N), irfft * N before fftshift (synthesis.cpp:38-138)."""
    N = fft_size
    coef = prims.exact_div(2.0 * np.pi * time_shift * fs, N)
    lpr, lpi = fftmat.minphase_log_matmul(log_p, N)
    nre, nim = fftmat.rfft_matmul(noise, N)
    lar, lai = fftmat.minphase_log_matmul(log_a, N)
    sre, sim, pre, pim = midpass(lpr, lpi, lar, lai, nre, nim, coef)
    return (fftmat.irfft_scaled_matmul(sre, sim, N),
            fftmat.irfft_scaled_matmul(pre, pim, N))


def synthesis(f0, spectrogram, aperiodicity, fft_size: int,
              frame_period: float, fs: int, y_length: int, stream,
              max_pulses: int = 0):
    """Synthesis (synthesis.cpp:338-397) for a batch: f0 (B, T),
    spectrogram / aperiodicity (B, T, N/2+1), stream (B, >= y_length)
    white noise -> waveform (B, y_length)."""
    if not max_pulses:
        max_pulses = default_max_pulses(y_length, fs)
    pl = time_base(f0, frame_period, fs, y_length, fft_size, max_pulses)
    log_p, log_a, noise, unvoiced = pulse_spectra(
        spectrogram, aperiodicity, stream, pl.pulse_time, pl.vuv,
        pl.noise_size, pl.noise_off, frame_period, fft_size)
    per_raw, aper_raw = responses(log_p, log_a, noise, pl.time_shift, fs,
                                  fft_size)
    return overlap_add(per_raw, aper_raw, unvoiced, pl.pidx, pl.noise_size,
                       pl.n, y_length)
