"""D4C band aperiodicity.

Counterpart of `hts_train_world_tpu/ops/d4c.py` (externs/WORLD_v2/src/
d4c.cpp).  The f32 fast path (the JAX package's slab branch on a frame
grid of a whole number of samples, its generic float32 frame on any
other: d4c.py:35-68 with `xp`, :122-150 and :323-364) runs:
- LoveTrain (d4c.cpp:258-282): per-frame V/UV from cumulative band power
  at 4000 / 7900 Hz of a Blackman window (K1, MEAN mode);
- main body (d4c.cpp:290-316): two unit-energy centroid windows at
  +-0.25/f0 and their index-weighted twins (K1, CENTROID mode), the Hann
  power spectrum (K1, MEAN mode), DC correction and three linear
  smoothings (K2), the static group delay, and the coarse aperiodicity of
  each 3 kHz band from an exact top-k sum (K3);
- `to_full`: interpolation onto the CheapTrick frequency axis.

Two kernels carry the body, each with its plain PyTorch twin; a wrapper
launches its kernel for CUDA tensors and runs the twin only for CPU
tensors:
- K26 (csrc/d4c_group_delay.cu), four stages between the DFT matmuls and
  K2: `love_train_sums` (LoveTrain's band sums -> ap0, process, cf0),
  `centroid_sum` (the cross-products of both shifts), `group_delay_ratio`
  (sc / sps, non-finite -> 0) and `band_segments` (the smoothing
  difference times the Nuttall window in each band);
- K27 (csrc/d4c_aperiodicity.cu), `aperiodicity`: the coarse dB from the
  band totals and top-k sums, the f0 correction and clamp, `to_full` and
  the `process` mask.

The float64 parity path (`d4c_parity`, the JAX package's generic frame,
d4c.py:122-150 and 279-360) places every window at its own position with
the reference's noise (K1 in float64): LoveTrain's Blackman window over
all its draws first, then three blocks of 2h+1 draws per processed frame,
at offsets that are cumulative sums on the device (`love_train_offsets`,
`body_offsets`).  Its
DFTs are `torch.fft`, its smoothing K2's parity mode, K26 and K27 run in
float64, and each band's ratio is the ascending sort and the cumulative
sum in the JAX package's order (jnp.cumsum's blocked scan on the CPU),
kernel K31 (csrc/d4c_band_sort.cu, `band_sort_sums`, with its twin
`band_sort_sums_plain`).
"""
from __future__ import annotations

import functools

import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import fftmat, frames, prims


def _round_up(n: int, m: int = 128) -> int:
    return -(-n // m) * m


LOVE, CENTROID, RATIO, SEGMENTS = 0, 1, 2, 3     # K26's four stages


def _launch_k26(stage: int, fn: str, args: list, inputs: dict,
                f64: bool = False):
    """One K26 launch through the stage's launcher `fn`; `inputs` (the
    stage wrapper's arguments) is what `kernels.record` keeps."""
    kernels.launch("d4c_group_delay", args, dict(stage=stage, **inputs),
                   fn=fn, variant="f64" if f64 else None)


def _rows(name: str, *ts):
    """Rows of one shape and one floating dtype (float32 or float64) ->
    (contiguous rows, f64 flag)."""
    R, H = ts[0].shape
    dt = ts[0].dtype
    if dt not in (torch.float32, torch.float64) \
            or any(t.dtype != dt or t.shape != (R, H) for t in ts):
        raise ValueError(f"{name}: f32 or f64 rows of one shape and dtype")
    return [t.contiguous() for t in ts], dt == torch.float64


def love_train_sums_plain(p, f0, b0: int, b1: int, b2: int,
                          threshold: float):
    """D4CLoveTrain's ratio (d4c.cpp:258-282) from the power rows p (R,
    n/2+1) of its Blackman windows: the power above 100 Hz up to 4 kHz over
    that up to 7.9 kHz (cumulative sums), 0 where f0 = 0; then the frames
    D4C processes, (f0 != 0) & (ap0 > threshold), and their f0 clamped to
    47 Hz (100 Hz elsewhere) -> (ap0, process, cf0)."""
    k = torch.arange(p.shape[1], device=p.device)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    p = torch.where(k <= b0, zero, p)
    c = torch.cumsum(torch.where(k <= b2, p, zero), dim=1)
    ap0 = c[:, b1] / torch.clamp(c[:, b2], min=prims.tiny_floor(p.dtype))
    ap0 = torch.where(f0 == 0.0, zero, ap0)
    process = (f0 != 0.0) & (ap0 > threshold)
    cf0 = torch.where(process, torch.clamp(f0, min=cfg.K_FLOOR_F0_D4C),
                      torch.full_like(f0, 100.0))
    return ap0, process, cf0


def love_train_sums(p, f0, b0: int, b1: int, b2: int, threshold: float):
    """K26, stage LOVE: `love_train_sums_plain` with one block a frame
    (float64 block sums)."""
    if not p.is_cuda:
        return love_train_sums_plain(p, f0, b0, b1, b2, threshold)
    R, H = p.shape
    (p,), f64 = _rows("love_train_sums", p)
    f0c = f0.to(p.dtype).contiguous()
    if f0c.shape != (R,) or not 0 <= b0 <= b1 <= b2 < H:
        raise ValueError("love_train_sums: f0 (R,) and 0 <= b0 <= b1 <= b2 "
                         "< n/2+1")
    ap0 = torch.empty(R, dtype=p.dtype, device=p.device)
    cf0 = torch.empty_like(ap0)
    process = torch.empty(R, dtype=torch.uint8, device=p.device)
    kernels.check_cuda("d4c_group_delay", p, f0c, ap0, process, cf0)
    _launch_k26(LOVE, "d4c_love_train_launch", [
        p.data_ptr(), R, H, b0, b1, b2, f0c.data_ptr(), float(threshold),
        prims.tiny_floor(p.dtype), int(f64), ap0.data_ptr(),
        process.data_ptr(), cf0.data_ptr()],
        dict(p=p, f0=f0c, b0=b0, b1=b1, b2=b2, threshold=threshold), f64)
    return ap0, process.bool(), cf0


def centroid_sum_plain(r1a, i1a, r2a, i2a, r1b, i1b, r2b, i2b):
    """The centroid cross-products r2 r1 + i1 i2 of the shifts -0.25/f0
    (a) and +0.25/f0 (b), summed (d4c.cpp:145-168)."""
    return (r2a * r1a + i1a * i2a) + (r2b * r1b + i1b * i2b)


def centroid_sum(r1a, i1a, r2a, i2a, r1b, i1b, r2b, i2b):
    """K26, stage CENTROID: `centroid_sum_plain`, one thread a bin."""
    if not r1a.is_cuda:
        return centroid_sum_plain(r1a, i1a, r2a, i2a, r1b, i1b, r2b, i2b)
    ins, f64 = _rows("centroid_sum", r1a, i1a, r2a, i2a, r1b, i1b, r2b,
                     i2b)
    R, H = ins[0].shape
    sc = torch.empty_like(ins[0])
    kernels.check_cuda("d4c_group_delay", *ins, sc)
    _launch_k26(CENTROID, "d4c_centroid_launch",
                [t.data_ptr() for t in ins] + [R, H, int(f64), sc.data_ptr()],
                dict(zip(("r1a", "i1a", "r2a", "i2a", "r1b", "i1b", "r2b",
                          "i2b"), ins)), f64)
    return sc


def group_delay_ratio_plain(sc, sps):
    """GetStaticGroupDelay's ratio (d4c.cpp:170-186); f32 noise-floor bins
    can underflow sps and blow the ratio up: non-finite results are 0."""
    sgd = sc / sps
    return torch.where(torch.isfinite(sgd), sgd,
                       torch.zeros((), dtype=sgd.dtype, device=sgd.device))


def group_delay_ratio(sc, sps):
    """K26, stage RATIO: `group_delay_ratio_plain`, one thread a bin."""
    if not sc.is_cuda:
        return group_delay_ratio_plain(sc, sps)
    (sc, sps), f64 = _rows("group_delay_ratio", sc, sps)
    R, H = sc.shape
    sgd = torch.empty_like(sc)
    kernels.check_cuda("d4c_group_delay", sc, sps, sgd)
    _launch_k26(RATIO, "d4c_ratio_launch",
                [sc.data_ptr(), sps.data_ptr(), R, H, int(f64),
                 sgd.data_ptr()], dict(sc=sc, sps=sps), f64)
    return sgd


def band_layout(fs: int, fft_d: int, n_ap: int):
    """GetCoarseAperiodicity's bands (d4c.cpp:192-223): the Nuttall
    window's length, each band's first bin, and the top-k boundary."""
    window_length = int(cfg.K_FREQUENCY_INTERVAL * fft_d / fs) * 2 + 1
    hw = window_length // 2
    starts = [int(cfg.K_FREQUENCY_INTERVAL * (i + 1) * fft_d / fs) - hw
              for i in range(n_ap)]
    boundary = int(fft_d * 8.0 / window_length + 0.5)
    return window_length, starts, boundary


def band_segments_plain(a, b, starts, window):
    """Each band's slice of the group delay minus its second smoothing,
    a - b (R, N/2+1), times the Nuttall window -> (R, n_ap, wl); starts:
    each band's first bin (a sequence of ints)."""
    wl = window.shape[0]
    if not starts:           # fs <= 12 kHz: no bands (d4c.cpp:212-215)
        return a.new_zeros((a.shape[0], 0, wl))
    d = a - b
    return torch.stack([d[:, s:s + wl] for s in starts], dim=1) * window


@functools.lru_cache(maxsize=None)
def _starts_on(starts: tuple, device):
    return torch.tensor(starts, dtype=torch.int32, device=device)


def band_segments(a, b, starts, window):
    """K26, stage SEGMENTS: `band_segments_plain`, one thread an output."""
    if not a.is_cuda:
        return band_segments_plain(a, b, starts, window)
    (a, b), f64 = _rows("band_segments", a, b)
    R, H = a.shape
    starts = tuple(int(v) for v in starts)
    n_ap, wl = len(starts), window.shape[0]
    seg = torch.empty((R, n_ap, wl), dtype=a.dtype, device=a.device)
    if not starts:           # fs <= 12 kHz: no bands, nothing to launch
        return seg
    if window.dtype != a.dtype or min(starts) < 0 \
            or max(starts) + wl > H:
        raise ValueError("band_segments: a window of the rows' dtype, bands "
                         "inside the rows")
    w = window.contiguous()
    st = _starts_on(starts, a.device)
    kernels.check_cuda("d4c_group_delay", a, b, st, w, seg)
    _launch_k26(SEGMENTS, "d4c_segments_launch", [
        a.data_ptr(), b.data_ptr(), R, H, st.data_ptr(), n_ap, w.data_ptr(),
        wl, int(f64), seg.data_ptr()], dict(a=a, b=b, starts=starts,
                                            window=w), f64)
    return seg


_STAGES = {LOVE: (love_train_sums, love_train_sums_plain),
           CENTROID: (centroid_sum, centroid_sum_plain),
           RATIO: (group_delay_ratio, group_delay_ratio_plain),
           SEGMENTS: (band_segments, band_segments_plain)}


def group_delay(stage: int, **inputs):
    """K26 by stage (a recorded launch's inputs replayed)."""
    return _STAGES[stage][0](**inputs)


def group_delay_plain(stage: int, **inputs):
    return _STAGES[stage][1](**inputs)


def to_full(coarse, fs: int, fft_size: int):
    """GetAperiodicity (d4c.cpp:325-333): coarse dB bands (R, n_ap) ->
    linear aperiodicity on the CheapTrick axis (R, fft_size/2+1)."""
    dtype, dev = coarse.dtype, coarse.device
    n_ap = coarse.shape[1]
    coarse_axis = torch.cat([
        torch.arange(n_ap + 1, dtype=dtype, device=dev)
        * cfg.K_FREQUENCY_INTERVAL,
        torch.full((1,), fs / 2.0, dtype=dtype, device=dev)])
    freq_axis = prims.exact_div(
        torch.arange(fft_size // 2 + 1, dtype=dtype, device=dev) * fs,
        fft_size)
    R = coarse.shape[0]
    vals = torch.cat([torch.full((R, 1), -60.0, dtype=dtype, device=dev),
                      coarse,
                      torch.full((R, 1), -cfg.K_MY_SAFE_GUARD_MINIMUM,
                                 dtype=dtype, device=dev)], dim=1)
    return torch.pow(10.0, prims.exact_div(
        prims.interp1(coarse_axis, vals, freq_axis), 20.0))


def aperiodicity_plain(den, topk, cf0, process, fs: int, fft_size: int,
                       num: bool = False):
    """From each band's power total den and its top-k sum (R, n_ap): the
    coarse dB 10 log10((den - top-k) / den) (d4c.cpp:192-223) plus the f0
    correction (cf0 - 100) / 50, clamped at 0 (d4c.cpp:309-311), then
    `to_full` and 1 - kMySafeGuardMinimum where the frame is not
    processed -> (aperiodicity (R, fft_size/2+1), coarse (R, n_ap)).
    With `num`, the second input is the numerator itself (the parity
    path's sorted cumulative sum, K31)."""
    tiny = prims.tiny_floor(den.dtype)
    ca = 10.0 * torch.log10(torch.clamp(topk if num else den - topk,
                                        min=tiny)
                            / torch.clamp(den, min=tiny))
    coarse = torch.clamp(ca + prims.exact_div(cf0 - 100.0, 50.0)[:, None],
                         max=0.0)
    ap = to_full(coarse, fs, fft_size)
    ap = torch.where(process[:, None], ap,
                     torch.full_like(ap, 1.0 - cfg.K_MY_SAFE_GUARD_MINIMUM))
    return ap, coarse


def aperiodicity(den, topk, cf0, process, fs: int, fft_size: int,
                 num: bool = False):
    """K27: `aperiodicity_plain`, one thread an output bin."""
    if not den.is_cuda:
        return aperiodicity_plain(den, topk, cf0, process, fs, fft_size, num)
    (den, topk), f64 = _rows("aperiodicity", den, topk)
    R, n_ap = den.shape
    cf0c = cf0.to(den.dtype).contiguous()
    pc = process.to(torch.uint8).contiguous()
    if cf0c.shape != (R,) or pc.shape != (R,):
        raise ValueError("aperiodicity: cf0 and process (R,)")
    kernels.check_cuda("aperiodicity", den, topk, cf0c, pc)
    H = fft_size // 2 + 1
    ap = torch.empty((R, H), dtype=den.dtype, device=den.device)
    coarse = torch.empty_like(den)
    kernels.launch("d4c_aperiodicity", [
        den.data_ptr(), topk.data_ptr(), int(num), cf0c.data_ptr(),
        pc.data_ptr(), R, n_ap, H, float(fs), fft_size,
        prims.tiny_floor(den.dtype), int(f64), coarse.data_ptr(),
        ap.data_ptr()],
        dict(den=den, topk=topk, cf0=cf0c, process=process, fs=fs,
             fft_size=fft_size, num=num), variant="f64" if f64 else None)
    return ap, coarse


# ---------------------------------------------------------------------------
# K31: the parity path's sorted band sums
# ---------------------------------------------------------------------------


NAN_KEY = 0x7FFFFFFFFFFFFFFE    # every NaN's sort key: after +inf


def _sort_keys(p):
    """float64 -> int64 keys in jnp.sort's order: -inf ... -0, +0 ...
    +inf, then every NaN (the bits, flipped below the sign for negatives;
    a NaN's key decodes to a NaN)."""
    b = p.contiguous().view(torch.int64)
    return torch.where(torch.isnan(p), NAN_KEY,
                       torch.where(b < 0, b ^ 0x7FFFFFFFFFFFFFFF, b))


def band_sort_sums_plain(p, i_num: int):
    """Each float64 row of p (R, H) sorted ascending (as the JAX
    package's jnp.sort: NaNs last, whatever their sign) and summed as the
    JAX package's jnp.cumsum sums on the CPU, XLA's blocked scan
    (`prims.xla_cumsum`): (num, den) = (c[i_num], c[H-1]) of the
    cumulative sum (d4c.py:191-195 there; d4c.cpp:215-220)."""
    keys, _ = torch.sort(_sort_keys(p), dim=1)
    vals = torch.where(keys < 0, keys ^ 0x7FFFFFFFFFFFFFFF, keys).view(
        p.dtype)
    c = prims.xla_cumsum(vals)
    return c[:, i_num], c[:, -1]


def band_sort_sums(p, i_num: int):
    """K31: `band_sort_sums_plain` with one block a row: the first 2^k
    keys sorted in registers (H = 2^k + 1), the last merged by its rank,
    and the blocked sum's blocks of 16 in parallel."""
    if not p.is_cuda:
        return band_sort_sums_plain(p, i_num)
    R, H = p.shape
    if p.dtype != torch.float64 or not 0 <= i_num < H:
        raise ValueError("band_sort_sums: float64 rows (R, H) and "
                         "0 <= i_num < H")
    p = p.contiguous()
    kernels.check_cuda("band_sort_sums", p)
    num = torch.empty(R, dtype=torch.float64, device=p.device)
    den = torch.empty_like(num)
    kernels.launch("d4c_band_sort", [p.data_ptr(), R, H, i_num,
                                     num.data_ptr(), den.data_ptr()],
                   dict(p=p, i_num=i_num))
    return num, den


def d4c(xs, fs: int, temporal_positions, f0, fft_size: int,
        threshold: float = cfg.K_THRESHOLD, f0_floor: float = cfg.K_FLOOR_F0,
        grid_step: int = 0):
    """D4C (d4c.cpp:337-397) for f32 xs (B, L), f0 (B, T) ->
    (aperiodicity (B, T, fft_size/2+1), LoveTrain ratio (B, T)).
    fft_size is the CheapTrick (output) size; `f0_floor` (the F0
    estimator's floor) sizes the window trim.  On the regular frame grid
    of grid_step samples every window sits within a few samples of its
    grid point (the JAX package's slab branch); with grid_step 0 at
    round(p*fs + 0.001) of its own position p, at any temporal positions
    (T,) or (B, T) (its generic float32 frame)."""
    dtype, dev = xs.dtype, xs.device
    B, T = f0.shape
    fft_d = cfg.d4c_fft_size(fs)
    n_ap = cfg.number_of_aperiodicities(fs)
    fmax = max(fs / 12.0, cfg.K_CEIL_F0)
    ul_max = 2 + int(fmax * fft_d / fs) + 1
    b_max = int(fmax * fft_d / fs) + 1

    # processed frames carry f0 >= f0_floor and the body clamps at 47 Hz,
    # so windows are at most 2*h_cap+1 wide (d4c.py's fast-mode trim);
    # the generic frame caps h at what its trimmed row holds
    eff_floor = max(float(f0_floor), cfg.K_FLOOR_F0_D4C)
    h_cap = int(2.0 * fs / eff_floor + 1.0)
    width = min(fft_d, _round_up(2 * h_cap + 1))
    if grid_step <= 0:
        h_cap = (width - 1) // 2
    margin = int(0.25 * fs / eff_floor) + 2   # centroid +-0.25/f0 clip

    f0r = f0.reshape(-1)
    pos = temporal_positions.expand(B, T).reshape(-1)

    def origin(p, lim):
        return frames.frame_origins(prims.matlab_round_i(p * fs + 0.001), T,
                                    grid_step, lim)

    o_pos = origin(pos, 2)

    # D4CLoveTrain (d4c.cpp:258-282) on a Blackman window (K1)
    n = cfg.d4c_love_train_fft_size(fs)
    nb = n // 2
    b0, b1, b2 = (min(int(-(-hz * n // fs)), nb)      # ceil, clipped like
                  for hz in (100.0, 4000.0, 7900.0))   # JAX's index
    h_lt = int(1.5 * fs / 40.0 + 1.0)
    lf0 = torch.clamp(f0r, min=40.0)
    h0 = torch.clamp(prims.matlab_round_i(
        prims.exact_div(prims.rdiv(3.0 * fs, lf0), 2.0)), max=h_lt)
    wave, _ = frames.frame_windows(xs, o_pos, h0, lf0, fs, 3.0,
                                   min(n, _round_up(2 * h_lt + 1)),
                                   frames.MEAN_BLACKMAN)
    ap0, process, cf0 = love_train_sums(fftmat.rfft_power(wave, n),
                                        f0r, b0, b1, b2, threshold)

    h = torch.clamp(prims.matlab_round_i(
        prims.exact_div(prims.rdiv(4.0 * fs, cf0), 2.0)), max=h_cap)
    quarter = prims.rdiv(0.25, cf0)

    def centroid(shift):
        r1_in, r2_in = frames.frame_windows(xs, origin(pos + shift, margin),
                                            h, cf0, fs, 4.0, width,
                                            frames.CENTROID)
        return fftmat.rfft(r1_in, fft_d) + fftmat.rfft(r2_in, fft_d)

    sc = prims.dc_correction(
        centroid_sum(*centroid(-quarter), *centroid(quarter)), cf0, fs,
        fft_d, ul_max)
    wave, _ = frames.frame_windows(xs, o_pos, h, cf0, fs, 4.0, width,
                                   frames.MEAN)
    sps = prims.smooth_spectrum(fftmat.rfft_power(wave, fft_d), fs,
                                fft_d, f0=cf0, ul_max=ul_max, width=cf0,
                                b_max=b_max)
    # GetStaticGroupDelay (d4c.cpp:170-186)
    sgd = prims.linear_smoothing(group_delay_ratio(sc, sps),
                                 prims.exact_div(cf0, 2.0), fs, fft_d, b_max)
    # GetCoarseAperiodicity (d4c.cpp:192-223): each band's Nuttall-windowed
    # slice of sgd - smooth(sgd), its power spectrum, the top-k remainder
    wl, starts, boundary = band_layout(fs, fft_d, n_ap)
    window = torch.as_tensor(prims.nuttall_window_np(wl), dtype=dtype,
                             device=dev)
    segs = band_segments(
        sgd, prims.linear_smoothing(sgd, cf0, fs, fft_d, b_max),
        tuple(starts), window)
    R = sgd.shape[0]
    p = fftmat.rfft_power(segs, fft_d).reshape(R * n_ap,
                                                      fft_d // 2 + 1)
    den = p.sum(dim=1).reshape(R, n_ap)
    topk = prims.sum_top_k(p, boundary + 1).reshape(R, n_ap)
    ap, _ = aperiodicity(den, topk, cf0, process, fs, fft_size)
    return ap.reshape(B, T, -1), ap0.reshape(B, T)


# ---------------------------------------------------------------------------
# the float64 parity path
# ---------------------------------------------------------------------------


def d4c_stream_len(f0_length: int, fs: int) -> int:
    """Upper bound on the draws one utterance consumes (d4c.py:29-32):
    LoveTrain's window and three body windows a frame."""
    w_lt = 2 * int(1.5 * fs / 40.0 + 0.5) + 1
    w_b = 2 * int(2.0 * fs / cfg.K_FLOOR_F0_D4C + 0.5) + 1
    return f0_length * (w_lt + 3 * w_b) + 16


def love_train_offsets(f0, fs: int):
    """LoveTrain's draws (d4c.py:287-295): 2h+1 for each voiced frame, h =
    round(1.5 fs / max(f0, 40)), in frame order from the stream's start.
    f0 (B, T) -> (h (B*T,), offsets (B*T,) with -1 where f0 = 0, the
    draws of each utterance (B,)); cumulative sums on f0's device."""
    h = prims.matlab_round_i(prims.rdiv(1.5 * fs, torch.clamp(f0, min=40.0)))
    counts = torch.where(f0 == 0.0, 0, 2 * h + 1)
    off = torch.cumsum(counts, dim=1) - counts
    off = torch.where(f0 == 0.0, -1, off)
    return h.reshape(-1), off.reshape(-1), counts.sum(dim=1)


def body_offsets(h, process, lt_total):
    """The body's draws (d4c.py:305-316): three blocks of 2h+1 for each
    processed frame, past all of LoveTrain's.  h, process (B, T), lt_total
    (B,) -> the three blocks' offsets (B*T,) each, -1 where the frame is
    not processed."""
    w = 2 * h + 1
    counts = torch.where(process, 3 * w, 0)
    off = lt_total[:, None] + torch.cumsum(counts, dim=1) - counts
    return [torch.where(process, off + k * w, -1).reshape(-1)
            for k in range(3)]


def d4c_parity(xs, fs: int, temporal_positions, f0, fft_size: int,
               threshold: float = cfg.K_THRESHOLD, stream=None):
    """D4C's parity path (d4c.py:211-418 with a stream, in float64) for
    float64 xs (B, L), f0 (B, T) at any temporal positions (T,) or (B, T),
    on the reseeded `stream` (each utterance reads it from its start) ->
    (aperiodicity (B, T, fft_size/2+1), LoveTrain ratio (B, T))."""
    dtype, dev = xs.dtype, xs.device
    B, T = f0.shape
    fft_d = cfg.d4c_fft_size(fs)
    half_d = fft_d // 2
    n_ap = cfg.number_of_aperiodicities(fs)
    fmax = max(fs / 12.0, cfg.K_CEIL_F0)
    ul_max = 2 + int(fmax * fft_d / fs) + 1
    b_max = int(fmax * fft_d / fs) + 1
    f0r = f0.reshape(-1)
    pos = temporal_positions.expand(B, T).reshape(-1).to(dtype)
    origin = prims.matlab_round_i(pos * fs + 0.001)

    # D4CLoveTrain (d4c.cpp:258-282): a Blackman window over n_lt
    n = cfg.d4c_love_train_fft_size(fs)
    nb = n // 2
    b0, b1, b2 = (min(int(-(-hz * n // fs)), nb)
                  for hz in (100.0, 4000.0, 7900.0))
    h_lt, off_lt, lt_total = love_train_offsets(f0, fs)
    wave, _ = frames.frame_windows(xs, origin, h_lt,
                                   torch.clamp(f0r, min=40.0), fs, 3.0, n,
                                   frames.MEAN_BLACKMAN, noise=stream,
                                   noff=off_lt)
    spec = torch.fft.rfft(wave, dim=1)
    ap0, process, cf0 = love_train_sums(
        spec.real * spec.real + spec.imag * spec.imag, f0r, b0, b1, b2,
        threshold)

    # the body (d4c.cpp:290-316), each window on its block of the stream
    h = prims.matlab_round_i(prims.exact_div(prims.rdiv(4.0 * fs, cf0),
                                             2.0))
    off_c1, off_c2, off_sp = body_offsets(h.reshape(B, T),
                                          process.reshape(B, T), lt_total)
    quarter = prims.rdiv(0.25, cf0)

    def centroid(shift, noff):
        o = prims.matlab_round_i((pos + shift) * fs + 0.001)
        w1, w2 = frames.frame_windows(xs, o, h, cf0, fs, 4.0, fft_d,
                                      frames.CENTROID, noise=stream,
                                      noff=noff)
        s1 = torch.fft.rfft(w1, dim=1)
        s2 = torch.fft.rfft(w2, dim=1)
        return s1.real, s1.imag, s2.real, s2.imag

    sc = prims.dc_correction(
        centroid_sum(*centroid(-quarter, off_c1), *centroid(quarter, off_c2)),
        cf0, fs, fft_d, ul_max, parity=True)
    wave, _ = frames.frame_windows(xs, origin, h, cf0, fs, 4.0, fft_d,
                                   frames.MEAN, noise=stream, noff=off_sp)
    spec = torch.fft.rfft(wave, dim=1)
    sps = prims.smooth_spectrum(spec.real * spec.real
                                + spec.imag * spec.imag, fs, fft_d, f0=cf0,
                                ul_max=ul_max, width=cf0, b_max=b_max,
                                parity=True)
    # GetStaticGroupDelay (d4c.cpp:170-186)
    sgd = prims.linear_smoothing(group_delay_ratio(sc, sps),
                                 prims.exact_div(cf0, 2.0), fs, fft_d, b_max,
                                 parity=True)
    # GetCoarseAperiodicity (d4c.cpp:192-223): each band's power, sorted
    # ascending and summed (K31)
    wl, starts, boundary = band_layout(fs, fft_d, n_ap)
    window = torch.as_tensor(prims.nuttall_window_np(wl), dtype=dtype,
                             device=dev)
    segs = band_segments(
        sgd, prims.linear_smoothing(sgd, cf0, fs, fft_d, b_max, parity=True),
        tuple(starts), window)
    R = sgd.shape[0]
    spec = torch.fft.rfft(segs, n=fft_d, dim=2).reshape(R * n_ap,
                                                        half_d + 1)
    num, den = band_sort_sums(spec.real * spec.real + spec.imag * spec.imag,
                              half_d - boundary - 1)
    ap, _ = aperiodicity(den.reshape(R, n_ap), num.reshape(R, n_ap), cf0,
                         process, fs, fft_size, num=True)
    return ap.reshape(B, T, -1), ap0.reshape(B, T)
