"""Harvest F0 estimation, batched over utterances: the f32 fast path,
and in float64 the parity analysis' Harvest (the JAX package's f64 path).

Counterpart of the device path of `hts_train_world_tpu/ops/harvest.py`
(externs/WORLD_v2/src/harvest.cpp), run on a batch of equal-length
utterances:

- decimation to ~8 kHz with the edge extension of GetWaveformAndSpectrumSub
  (harvest.cpp:43-66): kernel K13 (`prims.decimate`), then mean removal;
- the 152-channel Nuttall band-pass (harvest.cpp:99-148) as one batched
  `torch.fft` product, the JAX package's f64 formulation;
- per channel, four zero-crossing streams interpolated onto the 1 ms grid,
  averaged and gated (harvest.cpp:211-254): kernel K14
  (csrc/harvest_candidates.cu) with its twin `raw_candidates_plain`;
- candidate detection and overlap spreading (harvest.cpp:388-429):
  kernel K32 (csrc/harvest_detect.cu) with its twins `detect_candidates`
  and `overlap_candidates`;
- the instantaneous-frequency refinement of every (1 ms frame, candidate)
  pair (harvest.cpp:589-631): kernel K15 (csrc/harvest_refine.cu) with its
  twin `refine_plain`;
- the contour stack (harvest.cpp:652-1113): kernel K16, `harvest_fix.py`.

Every stage runs in the waveform's dtype, float32 or float64.  Every
wrapper launches its kernel for CUDA tensors and runs its plain twin only
for CPU tensors.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import dio as dio_mod
from hts_train_world_tpu_torch.ops import harvest_fix as hf
from hts_train_world_tpu_torch.ops import prims

TARGET_FS = 8000.0
CHANNELS_IN_OCTAVE = 40.0
OVERLAP_PARAMETER = 7
FRAME_S = 0.001            # Harvest always runs on a 1 ms grid


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


def harvest_plan(x_length: int, fs: int, f0_floor: float, f0_ceil: float):
    """Static sizes (HarvestGeneralBody setup, harvest.cpp:1155-1180)."""
    adj_floor = f0_floor * 0.9
    adj_ceil = f0_ceil * 1.1
    n_ch = 1 + int(math.log(adj_ceil / adj_floor) / cfg.K_LOG2
                   * CHANNELS_IN_OCTAVE)
    boundaries = [adj_floor * 2.0 ** ((i + 1) / CHANNELS_IN_OCTAVE)
                  for i in range(n_ch)]
    ratio = max(min(int(fs / TARGET_FS + 0.5), 12), 1)
    y_length = int(math.ceil(x_length / ratio))
    actual_fs = fs / ratio
    fft_size = cfg.get_suitable_fft_size(
        y_length + 5 + 2 * int(2.0 * actual_fs / boundaries[0]))
    max_candidates = int(n_ch / 10.0 + 0.5) * OVERLAP_PARAMETER
    # a detected run needs >= 10 voiced channels + 1 gap, so at most
    # (n_ch+1)//11 base candidates exist; x7 for the overlap spreading
    nc_pad = min(int(n_ch / 10.0 + 0.5), (n_ch + 1) // 11) \
        * OVERLAP_PARAMETER
    return dict(n_ch=n_ch, boundaries=boundaries, ratio=ratio,
                y_length=y_length, actual_fs=actual_fs, fft_size=fft_size,
                max_candidates=max_candidates, nc_pad=nc_pad)


def _key(plan: dict) -> tuple:
    return tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in sorted(plan.items()))


# ---------------------------------------------------------------------------
# decimated waveform
# ---------------------------------------------------------------------------


def waveform_sub(xs, plan: dict):
    """GetWaveformAndSpectrumSub (harvest.cpp:43-66) for rows xs (B, L):
    hold the ends for ceil(140/r)*r samples, decimate (K13), cut
    y_length samples, and remove each row's mean (harvest.cpp:81-86)."""
    r, y_length = plan["ratio"], plan["y_length"]
    if r == 1:
        y = xs[:, :y_length]
    else:
        lag = int(math.ceil(140.0 / r) * r)
        ext = torch.cat([xs[:, :1].expand(-1, lag), xs,
                         xs[:, -1:].expand(-1, lag)], dim=1)
        y = prims.decimate(ext, r)[:, lag // r:lag // r + y_length]
    return y - prims.exact_div(y.sum(dim=1, keepdim=True), y_length)


# ---------------------------------------------------------------------------
# band filter
# ---------------------------------------------------------------------------


def channel_layout(plan: dict):
    """Per channel: (boundary F0, FIR half length h, crossing cap).  The
    band-passed row of channel c starts at h + 1 of its circular
    convolution (index bias, harvest.cpp:139-147); the cap is the JAX
    f32 path's per-octave bound min(y_length/2+2, 2.5*2^ceil(log2 b)*dur
    + 64): the cos-modulated band-pass oscillates at ~b."""
    fs8, y_length = plan["actual_fs"], plan["y_length"]
    dur = y_length / fs8
    cap = y_length // 2 + 2
    return [(b, int(fs8 / b * 2.0 + 0.5),
             min(cap, int(2.5 * 2.0 ** math.ceil(math.log2(b)) * dur) + 64))
            for b in plan["boundaries"]]


@functools.lru_cache(maxsize=None)
def _band_specs_np(fft_size: int, fs8: float, boundaries: tuple):
    """Spectra of the cos-modulated Nuttall FIRs (harvest.cpp:112-132),
    float64 numpy (n_ch, fft_size/2+1)."""
    specs = []
    for b in boundaries:
        h = int(fs8 / b * 2.0 + 0.5)
        j = np.arange(2 * h + 1)
        t = j / (2.0 * h)
        w = (0.355768 - 0.487396 * np.cos(2 * np.pi * t)
             + 0.144232 * np.cos(4 * np.pi * t)
             - 0.012604 * np.cos(6 * np.pi * t))
        w = w * np.cos(2 * np.pi * b * (j - h) / fs8)
        specs.append(np.fft.rfft(w, fft_size))
    return np.stack(specs)


@functools.lru_cache(maxsize=8)
def _band_specs(fft_size: int, fs8: float, boundaries: tuple, dtype, device):
    """The spectra above as a tensor on `device`, built once per plan."""
    return torch.as_tensor(_band_specs_np(fft_size, fs8, boundaries),
                           dtype=dtype, device=device)


def band_filter(y, plan: dict):
    """Every channel's band-passed signal as one batched FFT product:
    y (B, y_length) -> (B, n_ch, fft_size), the circular convolution whose
    row c, read from h_c + 1, is the filtered signal (the JAX package's
    f64 formulation, harvest.py:180-192; no convolution, so no TF32)."""
    n = plan["fft_size"]
    Y = torch.fft.rfft(y, n=n, dim=1)
    W = _band_specs(n, plan["actual_fs"], tuple(plan["boundaries"]),
                    Y.dtype, y.device)
    return torch.fft.irfft(Y[:, None, :] * W, n=n, dim=2)


# ---------------------------------------------------------------------------
# K14: raw band candidates
# ---------------------------------------------------------------------------


def _grid(T: int, dtype, device):
    return torch.arange(T, dtype=dtype, device=device) * FRAME_S


def raw_candidates_plain(filt, plan: dict, f0_floor: float, f0_ceil: float,
                         T: int, crossings: bool = False):
    """GetRawF0Candidates (harvest.cpp:334-343) for filtered rows
    (B, n_ch, fft_size) -> raw candidates (B, n_ch, T): per channel the
    four zero-crossing streams (filtered, -filtered, diff, -diff) under
    the channel's cap, interpolated onto the 1 ms grid, averaged, and
    gated to +-10 % of the boundary, the F0 range and the saturation
    limit; all four streams need > 2 intervals.  Channels run in groups
    of one cap.  With `crossings`, also the interval counts (B, n_ch, 4)
    and the compacted crossing positions (B, n_ch, 4, max cap; filled with
    y_length-1), as int32."""
    B = filt.shape[0]
    L, fs8 = plan["y_length"], plan["actual_fs"]
    layout = channel_layout(plan)
    cap_max = max(c for _, _, c in layout)
    tq = _grid(T, filt.dtype, filt.device)
    out = torch.zeros((B, len(layout), T), dtype=filt.dtype,
                      device=filt.device)
    ns = torch.zeros((B, len(layout), 4), dtype=torch.int32,
                     device=filt.device)
    poss = torch.full((B, len(layout), 4, cap_max), L - 1, dtype=torch.int32,
                      device=filt.device)
    groups = {}
    for c, (_, _, cap) in enumerate(layout):
        groups.setdefault(cap, []).append(c)
    for cap, chans in groups.items():
        rows = channel_rows(filt, plan)[:, chans]
        G = len(chans)
        streams = dio_mod._four_streams(rows).reshape(B * G * 4, L)
        loc, val, n, t_lim, pos = dio_mod.zero_crossings(streams, fs8, cap)
        f = prims.interp1_rows(loc, val, n, tq).reshape(B, G, 4, T)
        n = n.reshape(B, G, 4)
        enough = (n > 2).all(dim=2)[..., None]
        t_limit = t_lim.reshape(B, G, 4).min(dim=2).values[..., None]
        cand = (((f[:, :, 0] + f[:, :, 1]) + f[:, :, 2]) + f[:, :, 3]) / 4.0
        bnd = torch.tensor([layout[c][0] for c in chans], dtype=filt.dtype,
                           device=filt.device)[None, :, None]
        bad = ((cand > bnd * 1.1) | (cand < bnd * 0.9) | (cand > f0_ceil)
               | (cand < f0_floor) | (tq > t_limit))
        idx = torch.as_tensor(chans, device=filt.device)
        out[:, idx] = torch.where(bad | ~enough, torch.zeros_like(cand),
                                  cand)
        ns[:, idx] = n.int()
        poss[:, idx, :, :cap] = pos.reshape(B, G, 4, cap).int()
    return (out, ns, poss) if crossings else out


@functools.lru_cache(maxsize=None)
def _channel_tables(plan_key: tuple, dtype, device):
    """K14's per-channel parameters: int32 (n_ch, 2) [row offset h+1,
    cap] and (n_ch, 2) [boundary*1.1, boundary*0.9] in `dtype`, the gates
    formed as the products the twin forms in that dtype."""
    layout = channel_layout(dict(plan_key))
    ints = torch.tensor([[h + 1, cap] for _, h, cap in layout],
                        dtype=torch.int32)
    b = torch.tensor([b for b, _, _ in layout], dtype=dtype)
    flts = torch.stack([b * 1.1, b * 0.9], dim=1)
    return ints.to(device), flts.contiguous().to(device)


def raw_candidates(filt, plan: dict, f0_floor: float, f0_ceil: float,
                   T: int, crossings: bool = False):
    """K14: `raw_candidates_plain` in one launch, one block per
    (utterance, channel); f32 or float64 filtered rows."""
    if not filt.is_cuda:
        return raw_candidates_plain(filt, plan, f0_floor, f0_ceil, T,
                                    crossings)
    B, n_ch, fft_size = filt.shape
    layout = channel_layout(plan)
    L = plan["y_length"]
    dt = filt.dtype
    if (dt not in (torch.float32, torch.float64) or n_ch != len(layout)
            or max(h for _, h, _ in layout) + 1 + L > fft_size):
        raise ValueError("raw_candidates: f32 or f64 filtered rows (B, "
                         "n_ch, fft_size) of this plan")
    f64 = dt == torch.float64
    fb = filt.contiguous()
    ints, flts = _channel_tables(_key(plan), dt, fb.device)
    kernels.check_cuda("raw_candidates", fb, ints, flts)
    cap_max = max(c for _, _, c in layout)
    dev = fb.device
    scratch = (torch.empty((B * n_ch, 4, cap_max), dtype=dt, device=dev)
               if 4 * cap_max * dt.itemsize > dio_mod.K5_SMEM_LIMIT
               else None)
    raw = torch.empty((B, n_ch, T), dtype=dt, device=dev)
    n = pos = None
    if crossings:
        n = torch.empty((B, n_ch, 4), dtype=torch.int32, device=dev)
        pos = torch.empty((B, n_ch, 4, cap_max), dtype=torch.int32,
                          device=dev)
    kernels.launch("harvest_candidates", [
        fb.data_ptr(), B * n_ch, n_ch, fft_size, L, ints.data_ptr(),
        flts.data_ptr(), float(plan["actual_fs"]), float(f0_floor),
        float(f0_ceil), T, FRAME_S, cap_max, int(f64),
        scratch.data_ptr() if scratch is not None else None,
        raw.data_ptr(), n.data_ptr() if crossings else None,
        pos.data_ptr() if crossings else None],
        dict(filt=fb, plan=plan, f0_floor=f0_floor, f0_ceil=f0_ceil, T=T),
        variant="f64" if f64 else None)
    return (raw, n, pos) if crossings else raw


def channel_rows(filt, plan: dict):
    """Each channel's band-passed signal, read from h+1 of its circular
    convolution: (B, n_ch, fft_size) -> (B, n_ch, y_length)."""
    L = plan["y_length"]
    return torch.stack([filt[:, c, h + 1:h + 1 + L]
                        for c, (_, h, _) in enumerate(channel_layout(plan))],
                       dim=1)


def crossing_candidates_f64(filt, plan: dict, T: int, n, pos):
    """The float64 oracle of K14 and its twin (dio.crossing_interp_f64 of
    the channel rows on the 1 ms grid) -> (B, n_ch, T)."""
    return dio_mod.crossing_interp_f64(
        channel_rows(filt, plan), plan["actual_fs"],
        _grid(T, torch.float32, filt.device), n, pos)


# ---------------------------------------------------------------------------
# K32: candidate detection and overlap spreading
# ---------------------------------------------------------------------------


def detect_candidates(raw, nc_cap: int):
    """DetectOfficialF0Candidates (harvest.cpp:388-412): per frame, every
    run of >= 10 voiced channels (first and last channel forced unvoiced)
    becomes one candidate, the run mean.  raw (B, n_ch, T) -> candidates
    (B, T, nc_cap) and each utterance's largest per-frame count (B,).
    The run sums are cumulative sums in float64 (the C sums doubles)."""
    col = raw.transpose(1, 2)                       # (B, T, n_ch)
    n_ch = col.shape[-1]
    v = col > 0
    v[..., 0] = False
    v[..., -1] = False
    st_m, ed_m = hf.start_end_masks(v)
    rcap = n_ch // 2 + 1
    st = prims.compact_indices(st_m, rcap, 0)
    ed = prims.compact_indices(ed_m, rcap, 0) + 1   # exclusive ends
    kk = torch.arange(rcap, device=raw.device)
    ok = (kk < st_m.sum(-1, keepdim=True)) & (ed - st >= 10)
    csum = torch.nn.functional.pad(torch.cumsum(col, -1, dtype=torch.float64),
                                   (1, 0))
    means = ((torch.gather(csum, -1, ed) - torch.gather(csum, -1, st))
             / (ed - st).clamp(min=1)).to(raw.dtype)
    sel = prims.compact_indices(ok, nc_cap, 0)
    k = ok.sum(-1, keepdim=True)
    cands = torch.where(torch.arange(nc_cap, device=raw.device) < k,
                        torch.gather(means, -1, sel),
                        torch.zeros((), dtype=raw.dtype, device=raw.device))
    return cands, k[..., 0].amax(dim=1)


def overlap_candidates(cands, nc):
    """OverlapF0Candidates (harvest.cpp:417-429), n = 3: column j + nc*i
    of frame t holds candidate j of frame t-i (i = 1..3) or t+i-3
    (i = 4..6).  nc (B,) is each utterance's own count; columns past
    7*nc are zero."""
    B, T, NC = cands.shape
    dev = cands.device
    ncb = nc.clamp(min=1)[:, None]
    cols = torch.arange(NC, device=dev)[None, :]
    blk = torch.div(cols, ncb, rounding_mode="floor")        # (B, NC)
    j = cols - blk * ncb
    shift = torch.where(blk == 0, 0, torch.where(blk <= 3, blk, -(blk - 3)))
    src_t = torch.arange(T, device=dev)[None, :, None] - shift[:, None, :]
    ok = (blk[:, None, :] < 7) & (src_t >= 0) & (src_t < T)
    flat = src_t.clamp(0, T - 1) * NC + j.clamp(0, NC - 1)[:, None, :]
    g = torch.gather(cands.reshape(B, -1), 1, flat.reshape(B, -1))
    return torch.where(ok, g.reshape(B, T, NC),
                       torch.zeros((), dtype=cands.dtype, device=dev))


def detect_overlap_plain(raw, nc_cap: int):
    """K32's twin: `detect_candidates` then `overlap_candidates` ->
    (spread candidates (B, T, nc_cap), each utterance's count (B,))."""
    cands, nc = detect_candidates(raw, nc_cap)
    return overlap_candidates(cands, nc), nc


def detect_overlap(raw, nc_cap: int):
    """K32: `detect_overlap_plain` in two launches, the detection one
    thread per (utterance, frame), the spreading one thread per output;
    f32 or float64 raw candidates (B, n_ch, T)."""
    if not raw.is_cuda:
        return detect_overlap_plain(raw, nc_cap)
    B, n_ch, T = raw.shape
    dt = raw.dtype
    if dt not in (torch.float32, torch.float64) or n_ch < 2 or nc_cap < 1:
        raise ValueError("detect_overlap: f32 or f64 raw candidates (B, "
                         "n_ch >= 2, T), nc_cap >= 1")
    f64 = dt == torch.float64
    rc = raw.contiguous()
    kernels.check_cuda("detect_overlap", rc)
    dev = rc.device
    dets = torch.empty((B, T, nc_cap), dtype=dt, device=dev)
    kc = torch.empty((B, T), dtype=torch.int32, device=dev)
    nc = torch.zeros(B, dtype=torch.int32, device=dev)
    out = torch.empty_like(dets)
    variant = "f64" if f64 else None
    kernels.launch("harvest_detect", [
        rc.data_ptr(), B, n_ch, T, nc_cap, int(f64), dets.data_ptr(),
        kc.data_ptr(), nc.data_ptr()], dict(raw=rc, nc_cap=nc_cap),
        fn="harvest_detect_launch", variant=variant)
    kernels.launch("harvest_detect", [
        dets.data_ptr(), kc.data_ptr(), nc.data_ptr(), B, T, nc_cap,
        int(f64), out.data_ptr()], None, fn="harvest_overlap_launch",
        variant=variant)
    return out, nc.long()


# ---------------------------------------------------------------------------
# K15: refinement of every (frame, candidate) pair
# ---------------------------------------------------------------------------


def refine_sizes(fs8: float, f0_floor: float):
    """(h_cap, B): the longest window's half length and the DFT size of
    the longest window (harvest.cpp:593-598 at f0_floor); a candidate's
    own size B_c = 4*2^e_c divides B, so its bin m is bin m*B/B_c of a
    B-point DFT."""
    h_cap = int(1.5 * fs8 / f0_floor + 1.0)
    e_max = int(math.log((2 * h_cap + 1) * 1.0) / cfg.K_LOG2)
    return h_cap, 4 * 2 ** e_max


@functools.lru_cache(maxsize=None)
def dft_table_np(B: int):
    """cos and sin of 2*pi*k/B, k < B, in float64 numpy."""
    a = 2.0 * np.pi * np.arange(B) / B
    return np.cos(a), np.sin(a)


def pair_integers(f0, t, fs8: float, B: int):
    """The integers of GetRefinedF0 (harvest.cpp:589-617) for candidates
    f0 at 1 ms frames t, in f0's dtype and in the JAX package's order:
    h, e_c (log2 of a quarter of B_c), B_c, the window's first sample
    base0 - 1, nh, and the six bins idx_c at B_c."""
    dtype = f0.dtype
    pos = t.to(dtype) * FRAME_S
    h = (prims.rdiv(1.5 * fs8, f0) + 1.0).long()
    e_c = torch.floor(prims.exact_div(torch.log(h.to(dtype) * 2.0 + 1.0),
                                      cfg.K_LOG2)).long()
    Bc = 4 * (1 << e_c)
    base0 = prims.matlab_round_i(
        (pos + prims.exact_div((-h).to(dtype), fs8)) * fs8 + 0.001)
    nh = torch.clamp(prims.rdiv(fs8 / 2.0, f0).long(), max=6)
    ks = torch.arange(1, 7, dtype=dtype, device=f0.device)
    idx_c = prims.matlab_round_i(
        prims.exact_div(f0 * Bc.to(dtype), fs8)[:, None] * ks)
    idx_c = torch.minimum(idx_c.clamp(min=0), 2 * (1 << e_c)[:, None])
    return h, e_c, Bc, base0 - 1, nh, idx_c


def _readout(sm_re, sm_im, sd_re, sd_im, f0, idx_c, Bc, nh, fs8: float,
             f0_floor: float, f0_ceil: float):
    """The IF readout of the six harmonic bins (harvest.cpp:600-617) ->
    (refined f0, score), 0 where the gates fail."""
    dtype = f0.dtype
    ks = torch.arange(1, 7, dtype=dtype, device=f0.device)
    p = sm_re * sm_re + sm_im * sm_im
    nm = sm_re * sd_im - sm_im * sd_re
    zero = torch.zeros((), dtype=dtype, device=f0.device)
    inst = torch.where(
        p == 0.0, zero,
        idx_c.to(dtype) * fs8 / Bc.to(dtype)[:, None]
        + prims.exact_div(nm / p * fs8, 2.0 * math.pi))
    amp = torch.sqrt(p)
    mask = (torch.arange(6, device=f0.device)[None, :]
            < nh[:, None]).to(dtype)
    num = (amp * inst * mask).sum(1)
    den = (amp * ks * mask).sum(1)
    ssum = (torch.abs((inst / ks - f0[:, None]) / f0[:, None]) * mask).sum(1)
    rf0 = num / (den + cfg.K_MY_SAFE_GUARD_MINIMUM)
    score = prims.rdiv(1.0, ssum / nh.to(dtype) + cfg.K_MY_SAFE_GUARD_MINIMUM)
    bad = (rf0 < f0_floor) | (rf0 > f0_ceil) | (score < 2.5)
    return torch.where(bad, zero, rf0), torch.where(bad, zero, score)


def windowed_pairs(y, ub, t, f0, fs8: float, f0_floor: float):
    """The windowed segments of pairs (utterance ub, frame t, candidate
    f0 > 0) of the decimated rows y (B, L): the Blackman window and its
    derivative over the window's 2h+1 samples (edge samples held), padded
    to the longest window -> (x*w, x*dw (P, 2*h_cap+1), the pair's
    integers of `pair_integers`)."""
    dtype, dev = y.dtype, y.device
    L = y.shape[1]
    h_cap, B = refine_sizes(fs8, f0_floor)
    ints = pair_integers(f0, t, fs8, B)
    h, first = ints[0], ints[3]
    jj = torch.arange(2 * h_cap + 1, device=dev)
    valid = jj[None, :] <= 2 * h[:, None]
    # the window's time axis in float64, rounded once (the C's doubles):
    # in f32 the rounding of (first + j)/fs8 near the frame position, times
    # 2*pi/wt ~ 700, would put 1e-5 into the window and its derivative
    tmp = (prims.exact_div((first[:, None] + jj).double(), fs8)
           - t.double()[:, None] * FRAME_S).to(dtype)
    wt = prims.exact_div(2.0 * h.to(dtype) + 1.0, fs8)[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    mw = torch.where(valid, 0.42 + 0.5 * torch.cos(2 * math.pi * tmp / wt)
                     + 0.08 * torch.cos(4 * math.pi * tmp / wt), zero)
    mw_p = torch.nn.functional.pad(mw[:, 1:], (0, 1))
    mw_m = torch.nn.functional.pad(mw[:, :-1], (1, 0))
    dw = torch.where(valid, -(mw_p - mw_m) / 2.0, zero)
    seg = y[ub[:, None], (first[:, None] + jj).clamp(0, L - 1)]
    return seg * mw, seg * dw, ints


def refine_pairs(y, ub, t, f0, fs8: float, f0_floor: float, f0_ceil: float):
    """GetRefinedF0 for pairs (utterance ub, frame t, candidate f0 > 0):
    each windowed segment's DFT at only the <= 6 bins the readout reads,
    with the phase index reduced exactly, (idx*j) mod B, into a table of B
    entries in y's dtype built in float64."""
    dtype, dev = y.dtype, y.device
    h_cap, B = refine_sizes(fs8, f0_floor)
    xm, xd, (h, e_c, Bc, _, nh, idx_c) = windowed_pairs(y, ub, t, f0, fs8,
                                                        f0_floor)
    jj = torch.arange(xm.shape[1], device=dev)
    cos_t, sin_t = (torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in dft_table_np(B))
    idx_b = idx_c * (B // Bc)[:, None]                   # bins at B
    ph = (idx_b[:, :, None] * jj) % B                    # (P, 6, W)
    c, s = cos_t[ph], sin_t[ph]
    sm_re = (xm[:, None, :] * c).sum(-1)
    sm_im = -(xm[:, None, :] * s).sum(-1)
    sd_re = (xd[:, None, :] * c).sum(-1)
    sd_im = -(xd[:, None, :] * s).sum(-1)
    rf0, score = _readout(sm_re, sm_im, sd_re, sd_im, f0, idx_c, Bc, nh, fs8,
                          f0_floor, f0_ceil)
    # a window longer than the plan's longest (f0 below the floor) is
    # refused, as K15 refuses it
    ok = h <= h_cap
    zero = torch.zeros((), dtype=dtype, device=dev)
    return torch.where(ok, rf0, zero), torch.where(ok, score, zero)


def refine_plain(y, cands, fs8: float, f0_floor: float, f0_ceil: float,
                 chunk: int = 8192):
    """K15's twin: every non-zero (frame, candidate) pair of cands
    (B, T, NC), compacted and refined in chunks -> (refined, scores), each
    (B, T, NC), zero where the candidate is zero or fails the gates."""
    Bt, T, NC = cands.shape
    refined = torch.zeros_like(cands)
    scores = torch.zeros_like(cands)
    ub, t, c = torch.nonzero(cands > 0, as_tuple=True)
    for at in range(0, ub.shape[0], chunk):
        sl = slice(at, at + chunk)
        r, s = refine_pairs(y, ub[sl], t[sl], cands[ub[sl], t[sl], c[sl]],
                            fs8, f0_floor, f0_ceil)
        refined[ub[sl], t[sl], c[sl]] = r
        scores[ub[sl], t[sl], c[sl]] = s
    return refined, scores


@functools.lru_cache(maxsize=None)
def _dft_table(B: int, dtype, device):
    """K15's table: cos then sin of 2*pi*k/B, built in float64, in
    `dtype`."""
    cos_t, sin_t = dft_table_np(B)
    return torch.as_tensor(np.concatenate([cos_t, sin_t]), dtype=dtype,
                           device=device)


def refine(y, cands, fs8: float, f0_floor: float, f0_ceil: float):
    """K15: `refine_plain` in one launch, one block per (utterance,
    frame), one warp per non-zero candidate; f32 or float64."""
    if not y.is_cuda:
        return refine_plain(y, cands, fs8, f0_floor, f0_ceil)
    Bt, T, NC = cands.shape
    dt = y.dtype
    if (dt not in (torch.float32, torch.float64) or cands.dtype != dt
            or y.shape[0] != Bt):
        raise ValueError("refine: f32 or f64 rows y (B, L) and cands (B, "
                         "T, NC) of one dtype")
    f64 = dt == torch.float64
    y, cands = y.contiguous(), cands.contiguous()
    h_cap, B = refine_sizes(fs8, f0_floor)
    table = _dft_table(B, dt, y.device)
    kernels.check_cuda("refine", y, cands, table)
    refined = torch.empty_like(cands)
    scores = torch.empty_like(cands)
    kernels.launch("harvest_refine", [
        y.data_ptr(), cands.data_ptr(), Bt, y.shape[1], T, NC, h_cap, B,
        table.data_ptr(), float(fs8), float(f0_floor), float(f0_ceil),
        int(f64), refined.data_ptr(), scores.data_ptr()],
        dict(y=y, cands=cands, fs8=fs8, f0_floor=f0_floor, f0_ceil=f0_ceil),
        variant="f64" if f64 else None)
    return refined, scores


# ---------------------------------------------------------------------------
# the lane
# ---------------------------------------------------------------------------


def harvest_f0_stages(xs, fs: int, f0_floor: float = cfg.K_FLOOR_F0,
                      f0_ceil: float = cfg.K_CEIL_F0):
    """HarvestGeneralBody (harvest.cpp:1155-1218) for utterances xs
    (B, L), f32 or float64, one stage at a time, yielding (stage name,
    result); the last result is f0 (B, T1) on the 1 ms grid.  The
    refinement runs at the plan's candidate width nc_pad: zero columns
    change nothing and K15 skips them."""
    L = xs.shape[1]
    plan = harvest_plan(L, fs, f0_floor, f0_ceil)
    T1 = cfg.samples_for_dio(fs, L, 1.0)
    fs8 = plan["actual_fs"]
    y = waveform_sub(xs, plan)
    yield "decimate", y
    filt = band_filter(y, plan)
    yield "band_filter", filt
    raw = raw_candidates(filt, plan, f0_floor, f0_ceil, T1)
    del filt
    yield "candidates", raw
    cands, _ = detect_overlap(raw, plan["nc_pad"])
    yield "detect", cands
    refined, scores = refine(y, cands, fs8, f0_floor, f0_ceil)
    yield "refine", (refined, scores)
    yield "contour", hf.contour(refined, scores)


def harvest_f0_batch(xs, fs: int, f0_floor: float = cfg.K_FLOOR_F0,
                     f0_ceil: float = cfg.K_CEIL_F0):
    """Batched Harvest: xs (B, L) -> f0 (B, T1) on the 1 ms grid."""
    *_, (_, f0) = harvest_f0_stages(xs, fs, f0_floor, f0_ceil)
    return f0


def frame_pick(f0_1ms, fs: int, x_length: int, frame_period: float):
    """The 1 ms contour onto the frame grid (harvest.cpp:1246-1251):
    frame k takes 1 ms frame min(T1-1, trunc(t_k*1000 + 0.5)), computed in
    float64 on the host.  -> (temporal positions (T,) in the contour's
    dtype, as the JAX package gives them in x's, f0 (B, T))."""
    T1 = f0_1ms.shape[1]
    T = cfg.samples_for_dio(fs, x_length, frame_period)
    tnp = np.arange(T) * frame_period / 1000.0
    idx = np.minimum(T1 - 1, np.trunc(tnp * 1000.0 + 0.5).astype(np.int64))
    t = torch.as_tensor(tnp, dtype=f0_1ms.dtype, device=f0_1ms.device)
    return t, f0_1ms[:, torch.as_tensor(idx, device=f0_1ms.device)]


def harvest(xs, fs: int, frame_period: float = 5.0,
            f0_floor: float = cfg.K_FLOOR_F0, f0_ceil: float = cfg.K_CEIL_F0):
    """Harvest (harvest.cpp:1223-1255) for utterances xs (B, L) ->
    (temporal positions (T,), f0 (B, T))."""
    f0 = harvest_f0_batch(xs, fs, f0_floor, f0_ceil)
    return frame_pick(f0, fs, xs.shape[1], frame_period)
