"""DIO F0 estimation, batched over utterances.

Counterpart of `hts_train_world_tpu/ops/dio.py` (externs/WORLD_v2/src/
dio.cpp): the band filtering; per band, four zero-crossing streams
compacted under a cap and interpolated onto the frame grid, which is
kernel K5 (csrc/dio_candidates.cu, all bands in one launch) with its
plain twin `band_candidates_plain`; the band argmin; and the contour
fixing, which is kernel K4 (csrc/fix_f0.cu) with its plain twin
`fix_f0_contour_plain`.

The fast path (float32): the constant band-filter spectra times the
utterance spectrum in one batched irfft, a band cap from the low-pass's
crossing rate, the regular-grid interpolation.  `parity=True` is the
parity path (the JAX package's f64 branch, dio.py:298-318), for float64
waveforms: the reference's op order in complex128 (the spectrum times the
low-cut filter's, then per band times the Nuttall low-pass's, and an
irfft), the worst-case cap y_length/2 + 2, and interp1 at arange(T) *
frame_period.  The dtype picks only the kernels' instantiation.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import prims


def zero_crossings(sig, fs: float, cap: int):
    """ZeroCrossingEngine (dio.cpp:357-393) on rows sig (R, n):
    negative-going crossings -> (locations, intervals, n_intervals,
    t_limit, positions), each (R, cap) / (R,); the valid prefix of each
    row is n_intervals long, `positions` holds the first min(#crossings,
    cap) crossing samples, then n-1.  A shorter signal is passed padded
    with its last value, which adds no crossing."""
    dtype = sig.dtype
    n_s = sig.shape[1]
    mask = (sig[:, :-1] > 0.0) & (sig[:, 1:] <= 0.0)
    n_edges = mask.sum(dim=1)
    pos = prims.compact_indices(mask, cap, n_s - 1)
    e = pos + 1  # edge sample index (dio.cpp:363)
    s_em1 = torch.gather(sig, 1, e - 1)
    s_e = torch.gather(sig, 1, e.clamp(max=n_s - 1))
    fine = e.to(dtype) - s_em1 / (s_e - s_em1)
    fine_next = torch.roll(fine, -1, dims=1)
    intervals = prims.rdiv(fs, fine_next - fine)
    locations = prims.exact_div(prims.exact_div(fine + fine_next, 2.0), fs)
    n = torch.where(n_edges < 2, 0, n_edges - 1)
    # cap saturation: the kept prefix is exact; frames past its last
    # covered time get no candidate (see the JAX zero_crossings)
    saturated = n_edges > cap
    n = torch.clamp(n, max=cap - 1)
    last_loc = torch.gather(locations, 1, torch.clamp(n - 1, min=0)[:, None])
    big = torch.finfo(dtype).max
    t_limit = torch.where(saturated, last_loc[:, 0],
                          torch.full_like(last_loc[:, 0], big))
    return locations, intervals, n, t_limit, pos


def _four_streams(filtered):
    """GetFourZeroCrossingIntervals' signals (dio.cpp:402-435) of rows
    (..., L): filtered, -filtered, diff, -diff -> (..., 4, L); the diff
    is padded with its last value, which adds no crossing."""
    d = filtered[..., 1:] - filtered[..., :-1]
    d = torch.cat([d, d[..., -1:]], dim=-1)
    return torch.stack([filtered, -filtered, d, -d], dim=-2)


def _band_candidate(filtered, y_length: int, actual_fs: float,
                    boundary_f0: float, f0_floor: float, f0_ceil: float,
                    temporal_positions, cap: int, fp_s: float,
                    parity: bool = False):
    """GetF0CandidateFromRawEvent minus the filtering (dio.cpp:441-508)
    for a batch of band-filtered rows (B, y_length) -> (cand, score,
    n (B, 4), positions (B, 4, cap)).  The fast path interpolates on the
    regular grid; `parity` by interp1 at temporal_positions, the 4-stream
    mean and spread added in sequence (as K5 adds them)."""
    B = filtered.shape[0]
    T = temporal_positions.shape[0]
    streams = _four_streams(filtered)
    locs, vals, n, t_lim, pos = zero_crossings(
        streams.reshape(B * 4, y_length), actual_fs, cap)
    if parity:
        f = prims.interp1_rows(locs, vals, n, temporal_positions)
        f = f.reshape(B, 4, T)
        cand = (((f[:, 0] + f[:, 1]) + f[:, 2]) + f[:, 3]) / 4.0
        d = f - cand[:, None, :]
        ss = (((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
              + d[:, 3] * d[:, 3])
        score = torch.sqrt(ss / 3.0)
    else:
        f = prims.interp1_regular_grid(locs, vals, T, fp_s, n)
        f = f.reshape(B, 4, T)
        cand = f.mean(dim=1)
        score = torch.sqrt(((f - cand[:, None, :]) ** 2).sum(dim=1) / 3.0)
    n = n.reshape(B, 4)
    enough = (n > 2).all(dim=1)[:, None]        # CheckEvent, dio.cpp:475
    t_limit = t_lim.reshape(B, 4).min(dim=1).values[:, None]
    bad = ((cand > boundary_f0) | (cand < boundary_f0 / 2.0)
           | (cand > f0_ceil) | (cand < f0_floor)
           | (temporal_positions[None, :] > t_limit))
    zero = torch.zeros((), dtype=cand.dtype, device=cand.device)
    big = torch.full((), cfg.K_MAXIMUM_VALUE, dtype=cand.dtype,
                     device=cand.device)
    cand = torch.where(bad, zero, cand)
    score = torch.where(bad, big, score)
    cand = torch.where(enough, cand, zero)
    score = torch.where(enough, score, big)
    return cand, score, n, pos.reshape(B, 4, cap)


# ---------------------------------------------------------------------------
# K5: every band's candidates (zero crossings -> compaction -> grid interp)
# ---------------------------------------------------------------------------

# above this many bytes of crossings per block, K5 keeps them in device
# memory instead of shared memory (the launcher refuses more shared memory)
K5_SMEM_LIMIT = 200 * 1024


def band_layout(plan: dict, parity: bool = False):
    """Per band: (boundary F0, offset of the delay-compensated rows in
    the filtered band, band cap).  The fast path caps a band's crossings
    by its low-pass's rate; parity keeps the worst case for every band."""
    y_length, actual_fs = plan["y_length"], plan["actual_fs"]
    cap = y_length // 2 + 2
    duration = y_length / actual_fs
    out = []
    for boundary in plan["boundary_f0"]:
        half_avg = int(actual_fs / boundary / 2.0 + 0.5)
        # the Nuttall low-pass bounds the crossing rate by ~boundary_f0
        out.append((boundary, 2 * half_avg,
                    cap if parity
                    else min(cap, int(2.5 * boundary * duration) + 64)))
    return out


def band_candidates_plain(filt_bands, plan: dict, f0_floor: float,
                          f0_ceil: float, T: int, fp_s: float,
                          crossings: bool = False, parity: bool = False):
    """Every band of `filt_bands` (B, bands, fft_size) -> candidates and
    scores (B, bands, T), each score divided by its candidate + guard
    (dio.cpp:563).  With `crossings`, also the interval counts n (B, bands,
    4) and the compacted crossing positions (B, bands, 4, max cap; filled
    with y_length-1), as int32.  `parity`: the parity forms."""
    y_length = plan["y_length"]
    tp = torch.arange(T, dtype=filt_bands.dtype,
                      device=filt_bands.device) * fp_s
    layout = band_layout(plan, parity)
    cap_max = max(c for _, _, c in layout)
    cands, scores, ns, poss = [], [], [], []
    for bi, (boundary, off, band_cap) in enumerate(layout):
        filt = filt_bands[:, bi, off:off + y_length]
        c, s, n, pos = _band_candidate(filt, y_length, plan["actual_fs"],
                                       boundary, f0_floor, f0_ceil, tp,
                                       band_cap, fp_s, parity)
        cands.append(c)
        scores.append(s / (c + cfg.K_MY_SAFE_GUARD_MINIMUM))
        ns.append(n)
        poss.append(torch.nn.functional.pad(pos, (0, cap_max - band_cap),
                                            value=y_length - 1))
    out = torch.stack(cands, dim=1), torch.stack(scores, dim=1)
    if crossings:
        out += (torch.stack(ns, dim=1).int(), torch.stack(poss, dim=1).int())
    return out


@functools.lru_cache(maxsize=None)
def _band_tables(plan_key: tuple, dtype, device, parity: bool):
    """K5's per-band parameters: int32 (bands, 2) [offset, cap] and
    (bands, 2) [boundary, boundary / 2] in the bands' dtype."""
    layout = band_layout(dict(plan_key), parity)
    ints = torch.tensor([[off, cap] for _, off, cap in layout],
                        dtype=torch.int32, device=device)
    flts = torch.tensor([[b, b / 2.0] for b, _, _ in layout],
                        dtype=dtype, device=device)
    return ints, flts


def band_candidates(filt_bands, plan: dict, f0_floor: float, f0_ceil: float,
                    T: int, fp_s: float, crossings: bool = False,
                    parity: bool = False):
    """K5: `band_candidates_plain` in one launch, one block per
    (utterance, band); float32 or float64 bands."""
    if not filt_bands.is_cuda:
        return band_candidates_plain(filt_bands, plan, f0_floor, f0_ceil, T,
                                     fp_s, crossings, parity)
    B, bands, fft_size = filt_bands.shape
    dt = filt_bands.dtype
    f64 = dt == torch.float64
    layout = band_layout(plan, parity)
    y_length = plan["y_length"]
    if (dt not in (torch.float32, torch.float64) or bands != len(layout)
            or max(off for _, off, _ in layout) + y_length > fft_size):
        raise ValueError("band_candidates: f32 or f64 filtered bands (B, "
                         "bands, fft_size) of this plan")
    fb = filt_bands.contiguous()
    key = tuple((k, tuple(v) if isinstance(v, list) else v)
                for k, v in sorted(plan.items()))
    ints, flts = _band_tables(key, dt, fb.device, parity)
    kernels.check_cuda("band_candidates", fb, ints, flts)
    cap_max = max(c for _, _, c in layout)
    dev = fb.device
    scratch = (torch.empty((B * bands, 4, cap_max), dtype=dt, device=dev)
               if 4 * cap_max * dt.itemsize > K5_SMEM_LIMIT else None)
    cands = torch.empty((B, bands, T), dtype=dt, device=dev)
    scores = torch.empty_like(cands)
    n = pos = None
    if crossings:
        n = torch.empty((B, bands, 4), dtype=torch.int32, device=dev)
        pos = torch.empty((B, bands, 4, cap_max), dtype=torch.int32,
                          device=dev)
    kernels.launch("dio_candidates", [
        fb.data_ptr(), B * bands, bands, fft_size, y_length,
        ints.data_ptr(), flts.data_ptr(), float(plan["actual_fs"]),
        float(f0_floor), float(f0_ceil), T, float(fp_s), cap_max, int(f64),
        scratch.data_ptr() if scratch is not None else None,
        cands.data_ptr(), scores.data_ptr(),
        n.data_ptr() if crossings else None,
        pos.data_ptr() if crossings else None],
        dict(filt_bands=fb, plan=plan, f0_floor=f0_floor, f0_ceil=f0_ceil,
             T=T, fp_s=fp_s, parity=parity), variant="f64" if f64 else None)
    return (cands, scores) + ((n, pos) if crossings else ())


def crossing_interp_f64(rows, fs: float, t, n, pos):
    """The f64 oracle of a crossing kernel (K5, K14) and its twin: the
    4-stream mean of float64 interp1 over the given compacted crossings
    (n (B, C, 4), pos (B, C, 4, cap)) of the band rows (B, C, L) at the f32
    frame times t (T,), before any gate -> (B, C, T) float64.  The
    crossings' locations and intervals are the f32 values kernel and twin
    form (the same f32 operations); only the interpolation onto the frame
    grid, where the two differ, runs in float64."""
    L = rows.shape[-1]
    s = _four_streams(rows)
    p = pos.long()
    e = p + 1
    s0 = torch.gather(s, -1, p)
    s1 = torch.gather(s, -1, e.clamp(max=L - 1))
    fine = e.to(s.dtype) - s0 / (s1 - s0)
    loc = prims.exact_div(prims.exact_div(fine[..., :-1] + fine[..., 1:],
                                          2.0), fs).double()
    itv = prims.rdiv(fs, fine[..., 1:] - fine[..., :-1]).double()
    return prims.interp1_rows(loc, itv, n, t.double()).mean(dim=2)


def crossing_candidates_f64(filt_bands, plan: dict, T: int, fp_s: float, n,
                            pos):
    """crossing_interp_f64 of K5's delay-compensated band rows on DIO's
    frame grid -> (B, bands, T) float64."""
    L = plan["y_length"]
    rows = torch.stack([filt_bands[:, bi, off:off + L]
                        for bi, (_, off, _) in enumerate(band_layout(plan))],
                       dim=1)
    t = torch.arange(T, dtype=torch.float32,
                     device=rows.device) * np.float32(fp_s)
    return crossing_interp_f64(rows, plan["actual_fs"], t, n, pos)


# ---------------------------------------------------------------------------
# K4: contour fixing (FixStep1..4, dio.cpp:132-289)
# ---------------------------------------------------------------------------


def _vrm(frame_period: float, f0_floor: float) -> int:
    return int(0.5 + 1000.0 / frame_period / f0_floor) * 2 + 1


def _select_best_f0(current, past, cands, allowed_range: float):
    """SelectBestF0 (dio.cpp:190-209); cands (B, bands) at the target
    frame, current / past (B,)."""
    ref = (current * 3.0 - past) / 2.0
    err = torch.abs(ref[:, None] - cands)
    best = torch.gather(cands, 1, torch.argmin(err, dim=1, keepdim=True))[:, 0]
    rel = torch.abs(1.0 - best / ref)
    ok = (rel <= allowed_range) & (ref != 0.0)
    return torch.where(ok, best, torch.zeros_like(best))


def fix_f0_contour_plain(best_f0, f0_candidates, frame_period: float,
                         f0_floor: float, allowed_range: float):
    """FixF0Contour (dio.cpp:259-289).  best_f0 (B, T), f0_candidates
    (B, bands, T)."""
    B, T = best_f0.shape
    vrm = _vrm(frame_period, f0_floor)
    if T <= vrm:
        return torch.zeros_like(best_f0)
    dev = best_f0.device
    zero = torch.zeros((), dtype=best_f0.dtype, device=dev)
    idx = torch.arange(T, device=dev)[None, :]

    # Step1: zero the edges, kill jumps (dio.cpp:132-150)
    base = torch.where((idx < vrm) | (idx >= T - vrm), zero, best_f0)
    prev = torch.cat([torch.zeros_like(base[:, :1]), base[:, :-1]], dim=1)
    jump = torch.abs((base - prev) / (cfg.K_MY_SAFE_GUARD_MINIMUM + base))
    s1 = torch.where((idx >= vrm) & (jump < allowed_range), base, zero)

    # Step2: zero any frame with a zero inside +/-center (dio.cpp:156-169)
    center = (vrm - 1) // 2
    has_zero = torch.zeros_like(s1, dtype=torch.bool)
    for k in range(-center, center + 1):
        has_zero = has_zero | (torch.roll(s1, -k, dims=1) == 0.0)
    inner = (idx >= center) & (idx < T - center)
    s2 = torch.where(inner & has_zero, zero, s1)

    # Step3 (forward extension from negative boundaries, dio.cpp:215-231)
    out = [s2[:, 0]]
    active = torch.zeros(B, dtype=torch.bool, device=dev)
    p1, p2 = s2[:, 0], torch.zeros_like(s2[:, 0])
    for j in range(T - 1):
        active = active | ((s2[:, j] != 0.0) & (s2[:, j + 1] == 0.0))
        v = torch.where(active, _select_best_f0(
            p1, p2, f0_candidates[:, :, j + 1], allowed_range), s2[:, j + 1])
        out.append(v)
        active = active & (v != 0.0)
        p1, p2 = v, p1
    s3 = torch.stack(out, dim=1)

    # Step4 (backward extension from positive boundaries, dio.cpp:237-253)
    out = [None] * T
    out[T - 1] = s3[:, T - 1]
    active = torch.zeros(B, dtype=torch.bool, device=dev)
    p1, p2 = s3[:, T - 1], torch.zeros_like(s3[:, 0])
    for j in range(T - 2, -1, -1):
        active = active | ((s2[:, j + 1] != 0.0) & (s2[:, j] == 0.0))
        v = torch.where(active, _select_best_f0(
            p1, p2, f0_candidates[:, :, j], allowed_range), s3[:, j])
        out[j] = v
        active = active & (v != 0.0)
        p1, p2 = v, p1
    return torch.stack(out, dim=1)


def fix_f0_contour(best_f0, f0_candidates, frame_period: float,
                   f0_floor: float, allowed_range: float):
    """K4: FixF0Contour for a batch, steps 1-4 in one launch (float32 or
    float64)."""
    if not best_f0.is_cuda:
        return fix_f0_contour_plain(best_f0, f0_candidates, frame_period,
                                    f0_floor, allowed_range)
    B, T = best_f0.shape
    bands = f0_candidates.shape[1]
    dt = best_f0.dtype
    if dt not in (torch.float32, torch.float64) \
            or f0_candidates.shape != (B, bands, T):
        raise ValueError("fix_f0_contour: f32 or f64 best (B, T), cands "
                         "(B, bands, T)")
    f64 = dt == torch.float64
    best = best_f0.contiguous()
    cands = f0_candidates.to(dt).contiguous()
    kernels.check_cuda("fix_f0_contour", best, cands)
    scratch = torch.empty((B, 2, T), dtype=dt, device=best.device)
    out = torch.empty_like(best)
    kernels.launch("fix_f0", [
        best.data_ptr(), cands.data_ptr(), B, bands, T,
        _vrm(frame_period, f0_floor), float(allowed_range), int(f64),
        scratch.data_ptr(), out.data_ptr()],
        dict(best_f0=best, f0_candidates=cands, frame_period=frame_period,
             f0_floor=f0_floor, allowed_range=allowed_range),
        variant="f64" if f64 else None)
    return out


# ---------------------------------------------------------------------------
# DIO main body
# ---------------------------------------------------------------------------


def _low_cut_filter_np(n: int, fft_size: int) -> np.ndarray:
    """dio.cpp:40-53: the zero-phase low-cut FIR (a delta minus a Hann
    low-pass), circularly rotated, float64 numpy."""
    i = np.arange(1, n + 1)
    lcf = np.zeros(fft_size)
    lcf[:n] = 0.5 - 0.5 * np.cos(i * 2.0 * np.pi / (n + 1))
    lcf[:n] = -lcf[:n] / lcf[:n].sum()
    lcf = np.roll(lcf, -((n - 1) // 2))
    lcf[0] += 1.0
    return lcf


@functools.lru_cache(maxsize=None)
def _band_filter_specs_np(fft_size: int, cutoff: int,
                          boundaries: tuple, actual_fs: float):
    """Static per-band filter spectra (low-cut FIR, dio.cpp:40-53, times
    each band's Nuttall low-pass, dio.cpp:325-333), numpy f64.
    Returns (bands, fft/2+1) complex128."""
    lcf_spec = np.fft.rfft(_low_cut_filter_np(cutoff * 2 + 1, fft_size))
    specs = []
    for boundary in boundaries:
        half_avg = int(actual_fs / boundary / 2.0 + 0.5)
        m = half_avg * 4
        t = np.arange(m) / (m - 1.0)
        w = (0.355768 - 0.487396 * np.cos(2 * np.pi * t)
             + 0.144232 * np.cos(4 * np.pi * t)
             - 0.012604 * np.cos(6 * np.pi * t))
        lpf = np.zeros(fft_size)
        lpf[:m] = w
        specs.append(np.fft.rfft(lpf) * lcf_spec)
    return np.stack(specs)


def dio_plan(x_length: int, fs: int, frame_period: float = 5.0,
             f0_floor: float = cfg.K_FLOOR_F0, f0_ceil: float = cfg.K_CEIL_F0,
             channels_in_octave: float = 2.0, speed: int = 1):
    """Static shape plan (DioGeneralBody setup, dio.cpp:578-609)."""
    number_of_bands = 1 + int(math.log(f0_ceil / f0_floor) / cfg.K_LOG2
                              * channels_in_octave)
    boundary_f0 = [f0_floor * 2.0 ** ((i + 1) / channels_in_octave)
                   for i in range(number_of_bands)]
    ratio = max(min(speed, 12), 1)
    y_length = 1 + x_length // ratio
    actual_fs = fs / ratio
    fft_size = cfg.get_suitable_fft_size(
        y_length + 4 * int(1.0 + actual_fs / boundary_f0[0] / 2.0))
    f0_length = cfg.samples_for_dio(fs, x_length, frame_period)
    return dict(number_of_bands=number_of_bands, boundary_f0=boundary_f0,
                ratio=ratio, y_length=y_length, actual_fs=actual_fs,
                fft_size=fft_size, f0_length=f0_length)


def dio(xs, fs: int, frame_period: float = 5.0,
        f0_floor: float = cfg.K_FLOOR_F0, f0_ceil: float = cfg.K_CEIL_F0,
        channels_in_octave: float = 2.0, allowed_range: float = 0.1,
        parity: bool = False):
    """Dio (dio.cpp:642-647) for utterances xs (B, L) at speed 1 ->
    (temporal_positions (T,), f0 (B, T), candidates and scores (B, bands,
    T)): the fast path, or with `parity` the parity path (float64 xs)."""
    if parity and xs.dtype != torch.float64:
        raise ValueError("dio: the parity path takes float64 waveforms")
    B, L = xs.shape
    dtype, dev = xs.dtype, xs.device
    plan = dio_plan(L, fs, frame_period, f0_floor, f0_ceil,
                    channels_in_octave)
    y_length = plan["y_length"]
    actual_fs = plan["actual_fs"]
    fft_size = plan["fft_size"]
    T = plan["f0_length"]

    # GetSpectrumForEstimation (dio.cpp:60-106).  Speed 1: y_length = L+1,
    # the extra sample is a zero that still joins the mean (dio.cpp:69-79)
    y = torch.zeros((B, fft_size), dtype=dtype, device=dev)
    y[:, :L] = xs
    mean_y = prims.exact_div(y[:, :y_length].sum(dim=1, keepdim=True),
                             y_length)
    y[:, :y_length] -= mean_y
    y_spec = torch.fft.rfft(y, dim=1)
    cutoff = int(actual_fs / 50.0 + 0.5)
    if parity:
        # the reference's order: the low-cut filter's spectrum, then each
        # band's Nuttall low-pass (dio.cpp:40-53, 325-333)
        lcf = torch.as_tensor(_low_cut_filter_np(cutoff * 2 + 1, fft_size),
                              device=dev)
        y_spec = y_spec * torch.fft.rfft(lcf)
        lpf = torch.zeros((len(plan["boundary_f0"]), fft_size),
                          dtype=dtype, device=dev)
        for bi, boundary in enumerate(plan["boundary_f0"]):
            m = int(actual_fs / boundary / 2.0 + 0.5) * 4
            lpf[bi, :m] = torch.as_tensor(prims.nuttall_window_np(m),
                                          device=dev)
        filt_bands = torch.fft.irfft(
            y_spec[:, None, :] * torch.fft.rfft(lpf, dim=1)[None],
            n=fft_size, dim=2) * fft_size
    else:
        specs = torch.as_tensor(_band_filter_specs_np(
            fft_size, cutoff, tuple(plan["boundary_f0"]), actual_fs),
            dtype=torch.complex64, device=dev)
        filt_bands = torch.fft.irfft(y_spec[:, None, :] * specs, n=fft_size,
                                     dim=2) * fft_size

    fp_s = frame_period / 1000.0
    tp = torch.arange(T, dtype=dtype, device=dev) * fp_s
    # the rows of band b start at its delay compensation (dio.cpp:335-337)
    f0_candidates, f0_scores = band_candidates(filt_bands, plan, f0_floor,
                                               f0_ceil, T, fp_s,
                                               parity=parity)
    best = torch.gather(f0_candidates, 1,
                        torch.argmin(f0_scores, dim=1, keepdim=True))[:, 0]
    f0 = fix_f0_contour(best, f0_candidates, frame_period, f0_floor,
                        allowed_range)
    return tp, f0, f0_candidates, f0_scores
