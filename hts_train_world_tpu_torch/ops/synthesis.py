"""WORLD waveform synthesis, batched: the fast path (cumsum phase, DFT
matmuls) and the exact path (float64, the sequential phase fold, FFTs).

Counterpart of `hts_train_world_tpu/ops/synthesis.py`
(externs/WORLD_v2/src/synthesis.cpp).  Four kernels carry it on the card,
each with its plain PyTorch twin here, which runs for CPU tensors:

- K9 `time_base` (csrc/synth_time_base.cu): GetTimeBase (coarse f0/vuv,
  interpolation to the sample rate, the phase sum, the wrapped-phase jump
  mask), the compaction of the pulses to the pulse cap and each pulse's
  time shift, time, noise size and offset and V/UV flag.  The phase sum
  runs sequentially in a float64 accumulator, rounding each output to the
  working dtype, in the kernel and in the twin (the CPU's `torch.cumsum`
  of f32 does the same), so the card and the CPU fire the same pulses; in
  float64 it is the JAX exact path's left fold.  `count_pulses` is the
  same launch without the per-pulse outputs.  `chunk_pulses` is its chunk
  mode, the streaming synthesizer's per-chunk pulses (ops/synthesis_rt.py).
- K10 `pulse_spectra` (csrc/synth_pulse_spectra.cu): per pulse the
  frame-interpolated envelope and aperiodicity, the periodic and
  aperiodic log spectra and the mean-removed noise segment: the inputs of
  the first transforms.
- K11 `overlap_add` (csrc/synth_ola.cu): fftshift, the DC remover, the
  unvoiced mask, the sqrt(noise size) scale and the valid-pulse mask of
  each response, and the overlap-add as a gather that sums each output
  sample's responses in pulse order (the order the twin's `index_add_`
  adds them on the CPU): no atomics, the same result on every run.
- K30 `midpass` (csrc/synth_midpass.cu): between K10 and K11, the
  min-phase spectra (exp/cos/sin), the fractional-delay factor and the
  noise product, one fused pass.  In the fast path it sits between the DFT
  matmuls of `fftmat` (which stay `torch.matmul`, as the JAX package
  leaves them to XLA); in the exact path between `torch.fft` transforms
  (`prims.minimum_phase_log`, `torch.fft.rfft` of the noise,
  `torch.fft.irfft`), as the JAX exact path takes `jnp.fft`.

`synthesis(..., exact=True)` is the JAX package's `exact_phase=True`
(vocoder.synthesize(parity=True)): float64 throughout, the reference's
reseeded noise stream (`ops/rand.randn_stream`), one view of it for every
utterance of a batch.  Every twin is dtype-generic; the kernels take
float32 (the fast path) or float64 (the exact path).
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
    """K9: the time base and the first max_pulses pulses of f32 or f64
    contours f0 (B, T >= 2), one block per utterance."""
    if not f0.is_cuda:
        return time_base_plain(f0, frame_period, fs, y_length, fft_size,
                               max_pulses)
    if f0.dtype not in (torch.float32, torch.float64) or f0.dim() != 2 \
            or f0.shape[1] < 2 or y_length < 2 or max_pulses < 0:
        raise ValueError("time_base: f32 or f64 contours (B, T >= 2), "
                         "y_length >= 2 and max_pulses >= 0")
    f0 = f0.contiguous()
    kernels.check_cuda("time_base", f0)
    B, T = f0.shape
    P = max_pulses
    dev = f0.device
    f64 = f0.dtype == torch.float64
    n = torch.empty(B, dtype=torch.long, device=dev)
    ints = torch.empty((3, B, P), dtype=torch.long, device=dev)
    flts = torch.empty((3, B, P), dtype=f0.dtype, device=dev)
    fp, lowest = frame_period / 1000.0, fs / fft_size + 1.0
    if not f64:
        fp, lowest = float(np.float32(fp)), float(np.float32(lowest))
    kernels.launch("synth_time_base", [
        f0.data_ptr(), B, T, y_length, P, fp, lowest, float(fs), int(f64),
        n.data_ptr(), ints[0].data_ptr(), ints[1].data_ptr(),
        ints[2].data_ptr(), flts[0].data_ptr(), flts[1].data_ptr(),
        flts[2].data_ptr()],
        dict(f0=f0, frame_period=frame_period, fs=fs, y_length=y_length,
             fft_size=fft_size, max_pulses=max_pulses),
        fn="synth_time_base_launch", variant="f64" if f64 else None)
    return Pulses(n, ints[0], flts[0], flts[1], ints[1], ints[2], flts[2])


def trim_pulses(pl: Pulses) -> Pulses:
    """The pulses cut to the largest count of the batch (at most the cap):
    every slot past it is masked (noise size 0, past the count), so the
    synthesis is unchanged.  Reads the counts on the host."""
    P = pl.pidx.shape[1]
    keep = max(1, min(P, int(pl.n.max()))) if P else 0
    return Pulses(pl.n, *(t[:, :keep] for t in pl[1:]))


def count_pulses(f0, frame_period: float, fs: int, y_length: int,
                 fft_size: int):
    """Exact fast-mode pulse count per utterance (B,): K9 without the
    per-pulse outputs, the same arithmetic as synthesis."""
    return time_base(f0, frame_period, fs, y_length, fft_size, 0).n


class ChunkPulses(NamedTuple):
    """K9's chunk mode: counts (2,) int64 = (pulses, pulses synthesised
    now); the rest (1, P) over the chunk's pulse cap, slots past the count
    holding the fill index s0 + n - 2."""
    counts: torch.Tensor
    pidx: torch.Tensor
    time_shift: torch.Tensor
    pulse_time: torch.Tensor
    noise_size: torch.Tensor
    noise_off: torch.Tensor
    vuv: torch.Tensor


def chunk_state(device):
    """A fresh chunk-mode state: (phase, pending shift) float64 and
    (pending index, stream base) int64, on `device`."""
    return (torch.zeros(2, dtype=torch.float64, device=device),
            torch.tensor([-1, 0], dtype=torch.long, device=device))


def chunk_pulses_plain(f0, s0: int, n: int, max_pulses: int,
                       frame_period: float, fs: int, fft_size: int,
                       state_d, state_i) -> ChunkPulses:
    """K9 chunk mode's twin (synthesis_rt.py:38-100): the pulses of the
    samples [s0, s0 + n) of the float64 contour f0 (T,) (interp1 over the
    T frames, no extrapolated frame), the phase carried in state_d[0], the
    pending pulse (state_i[0], state_d[1]) prepended, new pulses under the
    cap max_pulses - 1, noise sizes of all but the last pulse from the
    stream base state_i[1].  Updates the state in place."""
    dtype, dev = f0.dtype, f0.device
    T, P = f0.shape[0], max_pulses
    two_pi = 2.0 * np.pi
    zero = torch.zeros((), dtype=dtype, device=dev)
    cf0 = torch.where(f0 < fs / fft_size + 1.0, zero, f0)
    cvuv = torch.where(cf0 == 0.0, zero, torch.ones((), dtype=dtype,
                                                    device=dev))
    t_frames = torch.arange(T, dtype=dtype, device=dev) * (
        frame_period / 1000.0)
    time_axis = prims.exact_div(
        torch.arange(s0, s0 + n, device=dev).to(dtype), float(fs))
    if0 = prims.interp1(t_frames, cf0, time_axis)
    ivuv = prims.interp1(t_frames, cvuv, time_axis) > 0.5
    if0 = torch.where(ivuv, if0, torch.full_like(if0, cfg.K_DEFAULT_F0))
    inc = prims.exact_div(2.0 * np.pi * if0, fs)
    phase0 = state_d[0]
    total = torch.cumsum(torch.cat([phase0[None], inc]), 0)[1:]
    wrap = torch.remainder(total, two_pi)
    wrap_prev = torch.cat([torch.remainder(phase0, two_pi)[None],
                           wrap[:-1]])
    jump = torch.abs(wrap - wrap_prev) > np.pi
    k = prims.compact_indices(jump, P - 1, n - 1)
    y1 = wrap_prev[k] - two_pi
    new_shift = prims.exact_div(-y1 / (wrap[k] - y1), float(fs))
    first = int(state_i[0] >= 0)
    n_new = min(int(jump.sum()), P - 1)
    n_p = first + n_new
    pidx = torch.full((P,), s0 + n - 2, dtype=torch.long, device=dev)
    shift = torch.zeros(P, dtype=dtype, device=dev)
    if first:
        pidx[0], shift[0] = state_i[0], state_d[1]
    pidx[first:n_p] = s0 + k[:n_new] - 1
    shift[first:n_p] = new_shift[:n_new]
    ptime = prims.exact_div(pidx.to(dtype), float(fs))
    vuv = (prims.interp1(t_frames, cvuv, ptime) > 0.5).to(dtype)
    n_s = max(n_p - 1, 0)
    slot = torch.arange(P, device=dev)
    ns = torch.where(slot < n_s, torch.roll(pidx, -1) - pidx, 0)
    noff = state_i[1] + torch.cumsum(ns, 0) - ns
    state_d[0] = total[-1]
    state_d[1] = shift[n_p - 1] if n_p else 0.0
    state_i[0] = pidx[n_p - 1] if n_p else -1
    state_i[1] = noff[-1] + ns[-1]
    counts = torch.tensor([n_p, n_s], dtype=torch.long, device=dev)
    return ChunkPulses(counts, pidx[None], shift[None], ptime[None],
                       ns[None], noff[None], vuv[None])


def chunk_pulses(f0, s0: int, n: int, max_pulses: int, frame_period: float,
                 fs: int, fft_size: int, state_d, state_i) -> ChunkPulses:
    """K9's chunk mode: one block runs `chunk_pulses_plain`'s contract on
    the card, reading and writing the state there (no host sync)."""
    if not f0.is_cuda:
        return chunk_pulses_plain(f0, s0, n, max_pulses, frame_period, fs,
                                  fft_size, state_d, state_i)
    if (f0.dtype != torch.float64 or f0.dim() != 1 or f0.shape[0] < 2
            or n < 2 or max_pulses < 2 or s0 < 0
            or state_d.dtype != torch.float64 or state_d.shape != (2,)
            or state_i.dtype != torch.long or state_i.shape != (2,)):
        raise ValueError("chunk_pulses: f64 contour (T >= 2), n >= 2, "
                         "max_pulses >= 2, s0 >= 0, state (2,) f64 and "
                         "(2,) int64")
    f0 = f0.contiguous()
    kernels.check_cuda("chunk_pulses", f0, state_d, state_i)
    P, dev = max_pulses, f0.device
    if kernels.record is not None:
        inputs = dict(f0=f0, s0=s0, n=n, max_pulses=max_pulses,
                      frame_period=frame_period, fs=fs, fft_size=fft_size,
                      state_d=state_d.clone(), state_i=state_i.clone())
    else:
        inputs = {}
    counts = torch.empty(2, dtype=torch.long, device=dev)
    ints = torch.empty((3, 1, P), dtype=torch.long, device=dev)
    flts = torch.empty((3, 1, P), dtype=torch.float64, device=dev)
    kernels.launch("synth_time_base", [
        f0.data_ptr(), f0.shape[0], s0, n, P, frame_period / 1000.0,
        fs / fft_size + 1.0, float(fs), state_d.data_ptr(),
        state_i.data_ptr(), counts.data_ptr(), ints[0].data_ptr(),
        ints[1].data_ptr(), ints[2].data_ptr(), flts[0].data_ptr(),
        flts[1].data_ptr(), flts[2].data_ptr()], inputs,
        fn="synth_time_base_chunk_launch", variant="chunk")
    return ChunkPulses(counts, ints[0], flts[0], flts[1], ints[1], ints[2],
                       flts[2])


# ---------------------------------------------------------------------------
# K10: per-pulse spectra and noise segments
# ---------------------------------------------------------------------------


def pulse_spectra_plain(sp, ap, stream, pulse_time, vuv, noise_size,
                        noise_off, frame_period: float, fft_size: int,
                        exact: bool = False):
    """K10's twin.  sp, ap (B, T, N/2+1), stream (B, S) white noise (rows
    may be views of one prefix) and the pulses' time, V/UV flag, noise size
    and offset (B, P) -> (log_p, log_a (B, P, N/2+1), noise (B, P, N),
    unvoiced (B, P) bool).

    exact (float64, the exact path): the frame lerps and the log guard
    round as the JAX exact path's compiled `(1 - f) a + f b` and `env (1 -
    apr) + 1e-12` do, fma(f, b, (1 - f) a) and fma(env, 1 - apr, 1e-12)
    (XLA's CPU compiler contracts them; the fast path's lerp is a matmul
    there, which it does not).  Where ap is clipped near 1, 1 - apr^2
    magnifies one ulp of the lerp ~1e12-fold (more than 1e-9 in the
    waveform), so only the same rounding holds the exact path to the JAX
    package at 1e-10."""
    dtype, dev = sp.dtype, sp.device
    B, T, H = sp.shape
    P = pulse_time.shape[1]
    N = fft_size
    zero = torch.zeros((), dtype=dtype, device=dev)
    # frame interpolation of envelope and aperiodicity at each pulse
    pos = prims.exact_div(pulse_time, frame_period / 1000.0)
    fl = torch.clamp(torch.floor(pos), min=0, max=T - 1).long()
    ce = torch.clamp(torch.ceil(pos), min=0, max=T - 1).long()
    frac = (pos - torch.floor(pos))[..., None]
    same = (fl == ce)[..., None]

    def lerp(table):
        a = torch.gather(table, 1, fl[..., None].expand(B, P, H))
        b = torch.gather(table, 1, ce[..., None].expand(B, P, H))
        mid = (prims.fma(frac, b, a * (1.0 - frac)) if exact
               else a * (1.0 - frac) + b * frac)
        return torch.where(same, a, mid)

    sp_env = lerp(torch.abs(sp))
    apr = lerp(torch.clamp(ap, 0.001, 0.999999999999))
    apr = apr * apr
    unvoiced = (vuv <= 0.5) | (apr[..., 0] > 0.999)
    if exact:
        guarded = prims.fma(sp_env, 1.0 - apr, torch.full_like(
            sp_env, cfg.K_MY_SAFE_GUARD_MINIMUM))
    else:
        guarded = sp_env * (1.0 - apr) + cfg.K_MY_SAFE_GUARD_MINIMUM
    log_p = torch.log(guarded) / 2.0
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
                  frame_period: float, fft_size: int, exact: bool = False):
    """K10: one block per pulse writes its log spectra, its noise segment
    and its unvoiced flag (f32 inputs for the fast path, f64 for the exact
    one; the stream's rows contiguous, possibly one row expanded over the
    batch; see `pulse_spectra_plain`)."""
    if not sp.is_cuda:
        return pulse_spectra_plain(sp, ap, stream, pulse_time, vuv,
                                   noise_size, noise_off, frame_period,
                                   fft_size, exact)
    B, T, H = sp.shape
    P = pulse_time.shape[1]
    N = fft_size
    dt = sp.dtype
    if (dt != (torch.float64 if exact else torch.float32) or ap.dtype != dt
            or stream.dtype != dt or pulse_time.dtype != dt
            or vuv.dtype != dt or ap.shape != sp.shape
            or H != N // 2 + 1 or stream.dim() != 2
            or stream.shape[0] != B or stream.stride(1) != 1
            or pulse_time.shape != (B, P) or vuv.shape != (B, P)
            or noise_size.shape != (B, P) or noise_off.shape != (B, P)
            or noise_size.dtype != torch.long
            or noise_off.dtype != torch.long):
        raise ValueError("pulse_spectra: f32 (fast) or f64 (exact) sp, ap "
                         "(B, T, N/2+1), stream (B, S) with contiguous "
                         "rows, pulse_time and vuv (B, P) of that dtype, "
                         "noise size and offset (B, P) int64")
    sp, ap, pulse_time, vuv, noise_size, noise_off = (
        t.contiguous() for t in (sp, ap, pulse_time, vuv, noise_size,
                                 noise_off))
    kernels.check_cuda("pulse_spectra", sp, ap, pulse_time, vuv,
                       noise_size, noise_off)
    if not stream.is_cuda or stream.device != sp.device:
        raise ValueError("pulse_spectra: all tensors must be on one CUDA "
                         "device")
    f64 = dt == torch.float64
    dev = sp.device
    log_pa = torch.empty((2, B, P, H), dtype=dt, device=dev)
    noise = torch.empty((B, P, N), dtype=dt, device=dev)
    unvoiced = torch.empty((B, P), dtype=torch.bool, device=dev)
    fp = frame_period / 1000.0
    kernels.launch("synth_pulse_spectra", [
        sp.data_ptr(), ap.data_ptr(), B, T, H, stream.data_ptr(),
        stream.shape[1], stream.stride(0), pulse_time.data_ptr(),
        vuv.data_ptr(), noise_size.data_ptr(), noise_off.data_ptr(), P, N,
        fp if f64 else float(np.float32(fp)), float(prims.tiny_floor(dt)),
        int(f64), int(exact), log_pa[0].data_ptr(), log_pa[1].data_ptr(),
        noise.data_ptr(), unvoiced.data_ptr()],
        dict(sp=sp, ap=ap, stream=stream, pulse_time=pulse_time, vuv=vuv,
             noise_size=noise_size, noise_off=noise_off,
             frame_period=frame_period, fft_size=fft_size, exact=exact),
        variant="f64" if f64 else None)
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


def ola_index(pidx, N: int, y_length: int, y0: int = 0):
    """The OLA's flat target of every response element: response k of
    pulse p of utterance b lands at global sample pidx + 1 + k - N/2, in
    column pidx + 1 + k - y0 of row b of a (B, y_length + N + 1) buffer
    whose columns [N/2, N/2 + y_length) are the samples [y0, y0 +
    y_length); targets past either end are clamped into the padding (the
    reference skips them).  Returns (index, row width)."""
    B = pidx.shape[0]
    Lb = y_length + N + 1
    kj = torch.arange(N, device=pidx.device)
    t = ((pidx + 1 - y0)[..., None] + kj).clamp(0, Lb - 1)
    return (((torch.arange(B, device=pidx.device) * Lb)[:, None, None]
             + t).reshape(-1), Lb)


def overlap_add_plain(per_raw, aper_raw, unvoiced, pidx, noise_size, n,
                      y_length: int, y0: int = 0, acc=None):
    """K11's twin.  per_raw, aper_raw (B, P, N): the periodic and aperiodic
    irfft * N before fftshift; unvoiced, pidx, noise_size (B, P); n (B,)
    the pulse count -> waveform (B, y_length) over the global samples
    [y0, y0 + y_length): a new tensor, or, given `acc` (B, y_length),
    added to acc's values in place."""
    B, P, N = per_raw.shape
    resp = finish_responses(per_raw, aper_raw, unvoiced, noise_size, n)
    # OLA (synthesis.cpp:378-383); skipped slots add exact zeros
    at, Lb = ola_index(pidx, N, y_length, y0)
    out = torch.zeros((B, Lb), dtype=per_raw.dtype, device=per_raw.device)
    window = slice(N // 2, N // 2 + y_length)
    if acc is not None:
        out[:, window] = acc
    out.view(-1).index_add_(0, at, resp.reshape(-1))
    if acc is None:
        return out[:, window]
    acc.copy_(out[:, window])
    return acc


def overlap_add(per_raw, aper_raw, unvoiced, pidx, noise_size, n,
                y_length: int, y0: int = 0, acc=None):
    """K11: the responses finished and overlap-added as a gather: each
    output sample sums, in ascending pulse order, the responses that cover
    it, from 0 or (given `acc`, in place) from acc's value (f32 or f64;
    pidx ascending, as K9 writes it)."""
    if not per_raw.is_cuda:
        return overlap_add_plain(per_raw, aper_raw, unvoiced, pidx,
                                 noise_size, n, y_length, y0, acc)
    B, P, N = per_raw.shape
    dt = per_raw.dtype
    if (dt not in (torch.float32, torch.float64) or aper_raw.dtype != dt
            or aper_raw.shape != per_raw.shape or N % 2
            or unvoiced.dtype != torch.bool or unvoiced.shape != (B, P)
            or pidx.dtype != torch.long or pidx.shape != (B, P)
            or noise_size.dtype != torch.long
            or noise_size.shape != (B, P) or n.dtype != torch.long
            or n.shape != (B,) or y_length < 1
            or (acc is not None and (acc.dtype != dt
                                     or acc.shape != (B, y_length)
                                     or not acc.is_contiguous()))):
        raise ValueError("overlap_add: f32 or f64 responses (B, P, N "
                         "even), unvoiced (B, P) bool, pidx and noise_size "
                         "(B, P) int64, n (B,) int64, acc (B, y_length) of "
                         "the responses' dtype, contiguous")
    per_raw, aper_raw, unvoiced, pidx, noise_size, n = (
        t.contiguous() for t in (per_raw, aper_raw, unvoiced, pidx,
                                 noise_size, n))
    f64 = dt == torch.float64
    dc_rm = _dc_remover(N, dt, per_raw.device)
    y = (torch.empty((B, y_length), dtype=dt, device=per_raw.device)
         if acc is None else acc)
    kernels.check_cuda("overlap_add", per_raw, aper_raw, unvoiced, pidx,
                       noise_size, n, dc_rm, y)
    inputs = dict(per_raw=per_raw, aper_raw=aper_raw, unvoiced=unvoiced,
                  pidx=pidx, noise_size=noise_size, n=n, y_length=y_length)
    if y0 or acc is not None:
        inputs.update(y0=y0, acc=None if acc is None else (
            acc.clone() if kernels.record is not None else acc))
    dc = torch.empty((B, P), dtype=dt, device=per_raw.device)
    kernels.launch("synth_ola", [
        per_raw.data_ptr(), aper_raw.data_ptr(), unvoiced.data_ptr(),
        pidx.data_ptr(), noise_size.data_ptr(), n.data_ptr(), B, P, N,
        dc_rm.data_ptr(), y_length, y0, int(acc is not None), int(f64),
        dc.data_ptr(), y.data_ptr()], inputs,
        variant="f64" if f64 else None)
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
    """K30: `midpass_plain`'s contract in one fused pass (f32 or f64)."""
    if not lpr.is_cuda:
        return midpass_plain(lpr, lpi, lar, lai, nre, nim, coef)
    ins = (lpr, lpi, lar, lai, nre, nim)
    dt = lpr.dtype
    if (dt not in (torch.float32, torch.float64)
            or any(t.dtype != dt or t.shape != lpr.shape for t in ins)
            or coef.dtype != dt or coef.shape != lpr.shape[:-1]):
        raise ValueError("midpass: six f32 or f64 (..., H) spectra of one "
                         "shape and coef (...) of their dtype")
    H = lpr.shape[-1]
    ins = tuple(t.contiguous() for t in ins)
    coef = coef.contiguous()
    kernels.check_cuda("midpass", *ins, coef)
    f64 = dt == torch.float64
    outs = tuple(torch.empty_like(lpr) for _ in range(4))
    kernels.launch("synth_midpass", [
        *(t.data_ptr() for t in ins), coef.data_ptr(), coef.numel(), H,
        int(f64), *(t.data_ptr() for t in outs)],
        dict(lpr=lpr, lpi=lpi, lar=lar, lai=lai, nre=nre, nim=nim,
             coef=coef), variant="f64" if f64 else None)
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


def responses_exact(log_p, log_a, noise, time_shift, fs: int,
                    fft_size: int):
    """The exact path's mid-pass (synthesis.py:180-209,215-235 of the JAX
    package): the min-phase logs and the noise spectrum by `torch.fft`,
    K30's products, and `torch.fft.irfft` * N -> (per_raw, aper_raw)
    (B, P, N) before fftshift."""
    N = fft_size
    coef = prims.exact_div(2.0 * np.pi * time_shift * fs, N)
    # both log spectra through one set of transforms
    lr, li = prims.minimum_phase_log(torch.stack([log_p, log_a]), N)
    nspec = torch.fft.rfft(noise, dim=-1)
    sre, sim, pre, pim = midpass(lr[0], li[0], lr[1], li[1],
                                 nspec.real.contiguous(),
                                 nspec.imag.contiguous(), coef)
    del lr, li, nspec
    per_raw = torch.fft.irfft(torch.complex(sre, sim), N, dim=-1) * N
    del sre, sim
    return per_raw, torch.fft.irfft(torch.complex(pre, pim), N, dim=-1) * N


def synthesis(f0, spectrogram, aperiodicity, fft_size: int,
              frame_period: float, fs: int, y_length: int, stream,
              max_pulses: int = 0, exact: bool = False):
    """Synthesis (synthesis.cpp:338-397) for a batch: f0 (B, T),
    spectrogram / aperiodicity (B, T, N/2+1), stream (B, >= y_length)
    white noise -> waveform (B, y_length).

    exact=True is the JAX package's exact_phase=True: float64 inputs, the
    pulses cut to the batch's largest count (`trim_pulses`), FFTs in place
    of the DFT matmuls; the stream's rows may be views of one prefix
    (`ops/rand.randn_stream(...).expand(B, -1)`)."""
    if not max_pulses:
        max_pulses = default_max_pulses(y_length, fs)
    pl = time_base(f0, frame_period, fs, y_length, fft_size, max_pulses)
    if exact:
        pl = trim_pulses(pl)
    log_p, log_a, noise, unvoiced = pulse_spectra(
        spectrogram, aperiodicity, stream, pl.pulse_time, pl.vuv,
        pl.noise_size, pl.noise_off, frame_period, fft_size, exact)
    per_raw, aper_raw = (responses_exact if exact else responses)(
        log_p, log_a, noise, pl.time_shift, fs, fft_size)
    del log_p, log_a, noise
    return overlap_add(per_raw, aper_raw, unvoiced, pl.pidx, pl.noise_size,
                       pl.n, y_length)
