"""K1's and K2's layouts on the CPU: numpy emulations of the kernels'
schedules against their plain twins.

K1 (`csrc/frame_window.cu`): `k1_emulate` places each row's samples as
the kernel's threads hold them (`frames.window_plan`: thread t owns the
chunks of four samples c = t + NT i), reads x once a sample at the
frame's clamped index, takes the frame sums in the kernel's order (each
thread's chunks in sequence, the warp's xor butterfly, the warps in
order), computes only the chunks that hold window samples and leaves
the rest as stored zeros, and for STONEMASK reads each chunk's window
values and its two neighbours' from the window computed once a sample.  It is
held to `frames.frame_windows_plain` on frames at both ends of an odd-
length x at every width the float32 paths use (48, 44.1 and 22.05 kHz).

K2 (`csrc/spectral_smooth.cu`, the fast kernel): `k2_emulate` stages each
row by the kernel's 16-byte loads from the row's first 16-byte boundary
(rows of N/2+1 floats start 4 r n bytes into the tensor), applies the DC
fold bin by bin as the mirrored row is read, sums each thread's odd run
(`prims.smooth_plan`) in sequence in float64, scans the runs across the
lanes as the shuffles do and the warps' totals in order, and reads the
scan at the row's two shifts, their difference times the reciprocal of
the width.  It is held to
`prims.smooth_spectrum_plain` element by element within
`prims.smooth_spectrum_limit`, the DC fold bit for bit.

The kernels run only on the card; `tests/test_torch_cuda.py` holds them
to the same twins there.
"""
import numpy as np
import pytest
import torch

from hts_train_world_tpu_torch.ops import frames, prims

F = np.float32
PI1, PI2, PI4 = F(3.14159265358979), F(6.28318530717959), F(12.5663706143592)


def _cos(a):
    """float32 cosines as the twin takes them (torch's, which differ from
    numpy's by an ulp; on the card kernel and twin share CUDA's)."""
    return torch.cos(torch.as_tensor(np.ascontiguousarray(a, F))).numpy()


def _block_sum(part, nt: int):
    """The kernel's block sum of the threads' partial sums part (R, NT):
    each warp's xor butterfly, then the warp totals in order."""
    s = part.reshape(part.shape[0], nt // 32, 32)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = (s + s[..., lane ^ o]).astype(s.dtype)
    tot = s[:, 0, 0]
    for w in range(1, nt // 32):
        tot = (tot + s[:, w, 0]).astype(s.dtype)
    return tot[:, None, None]


def _seq_sum(v):
    """Each thread's values (R, NT, C) added in sequence."""
    s = np.zeros(v.shape[:2], v.dtype)
    for k in range(v.shape[2]):
        s = (s + v[:, :, k]).astype(v.dtype)
    return s


def k1_emulate(x, origin, h, f0, pos, fs: int, ratio: float, width: int,
               mode: int):
    """K1's float32 rows (out1, out2) of frames (origin, h, f0, pos) of
    x (B, L) in order (R = B T)."""
    x = np.asarray(x, F)
    B, L = x.shape
    R = h.shape[0]
    utt = np.arange(R) // (R // B)
    h = h.astype(np.int64)[:, None, None]
    o = origin.astype(np.int64)[:, None, None]
    n = 2 * h + 1
    nq = -(-width // 4)
    if mode == frames.STONEMASK:
        nt, k = 128, -(-nq // 128)      # one thread loops over its chunks
    else:
        nt, k = frames.window_plan(width)
    # slot (t, 4 i + e) holds sample 4 (t + NT i) + e: every sample of the
    # row in one slot, the rest past it
    j = (4 * (np.arange(nt)[:, None, None] + nt * np.arange(k)[None, :, None])
         + np.arange(4)[None, None, :]).reshape(nt, 4 * k)
    inrow = j < width
    assert np.array_equal(np.sort(j[inrow]), np.arange(width))
    j = j[None]
    ne = np.minimum(n, width)           # a wider window cut at the row's end
    live = j < ne
    # x read once a sample: the contiguous run o-h .. o+h, clamped at the
    # ends of x (the JAX edge padding)
    idx = np.clip(o - h + j, 0, L - 1)
    xs = np.where(live, x[utt[:, None, None], idx], F(0))
    if mode == frames.STONEMASK:
        p = pos.astype(F)[:, None, None]
        wt = (n.astype(F) / F(fs)).astype(F)

        def win(jj):
            tmp = ((o - h + jj).astype(F) / F(fs) - p).astype(F)
            a1 = (PI2 * tmp / wt).astype(F)
            a2 = (PI4 * tmp / wt).astype(F)
            w = (F(0.42) + F(0.5) * _cos(a1) + F(0.08) * _cos(a2))
            return np.where((jj >= 0) & (jj < ne), w, F(0)).astype(F)
        # each chunk its four window values and its neighbours'
        wm, w0, wp = win(j - 1), win(j), win(j + 1)
        m = np.where(live, xs * w0, F(0))
        d = np.where(live, xs * (-(wp - wm) / F(2)), F(0))
        return _rows(m, j, inrow, width), _rows(d, j, inrow, width)
    position = ((F(2) * (j - h).astype(F) / F(ratio)).astype(F)
                / F(fs)).astype(F)
    arg = ((PI1 * position).astype(F) * f0.astype(F)[:, None, None])
    if mode in (frames.MEAN_BLACKMAN, frames.CENTROID):
        w = F(0.42) + F(0.5) * _cos(arg) + F(0.08) * _cos(arg * F(2))
    else:
        w = F(0.5) * _cos(arg) + F(0.5)
    w = np.where(live, w, F(0)).astype(F)
    if mode == frames.CHEAPTRICK:
        w = (w / np.sqrt(_block_sum(_seq_sum(w * w), nt))).astype(F)
    v = np.where(live, xs * w, F(0)).astype(F)
    coef = _block_sum(_seq_sum(v), nt) / _block_sum(_seq_sum(w), nt)
    v = np.where(live, v - w * coef, F(0)).astype(F)
    if mode != frames.CENTROID:
        return _rows(v, j, inrow, width), None
    nrm = np.sqrt(_block_sum(_seq_sum(v * v), nt))
    v = (v / nrm).astype(F)
    return (_rows(v, j, inrow, width),
            _rows((v * (j + 1).astype(F)).astype(F), j, inrow, width))


def _rows(v, j, inrow, width):
    """The slots' values (R, NT, C) stored into rows (R, width)."""
    out = np.full((v.shape[0], width), np.nan, F)
    out[:, j[0][inrow]] = v[:, inrow]
    assert not np.isnan(out).any()
    return out


# every width of K1 on the float32 paths: 48 kHz (CheapTrick and
# StoneMask 2048, D4C 2816, LoveTrain 3712), 44.1 kHz (2048, 2560, 3328),
# 22.05 kHz (1024, 1280, 1664)
K1_CASES = [(48000, 2048, frames.CHEAPTRICK, 3.0),
            (48000, 2048, frames.STONEMASK, 0.0),
            (48000, 2816, frames.MEAN, 4.0),
            (48000, 2816, frames.CENTROID, 4.0),
            (48000, 3712, frames.MEAN_BLACKMAN, 3.0),
            (44100, 2048, frames.STONEMASK, 0.0),
            (44100, 2560, frames.CENTROID, 4.0),
            (44100, 3328, frames.MEAN_BLACKMAN, 3.0),
            (22050, 1024, frames.CHEAPTRICK, 3.0),
            (22050, 1280, frames.MEAN, 4.0),
            (22050, 1664, frames.MEAN_BLACKMAN, 3.0)]


def _k1_check(fs, width, mode, ratio, h, origin, seed):
    """k1_emulate against the twin on frames (h, origin) of an odd-length
    x: every row within 1e-5 of its largest value, the samples past the
    window zero as the twin's."""
    rng = np.random.default_rng(seed)
    B = 2
    L = 4 * width + 1
    x = rng.standard_normal((B, L)).astype(F)
    origin = np.where(origin < 0, L + origin, origin)
    f0 = np.clip(rng.uniform(40, 800, h.shape[0]), 40, None).astype(F)
    pos = (origin / fs).astype(F)
    got = k1_emulate(x, origin, h, f0, pos, fs, ratio, width, mode)
    want = frames.frame_windows_plain(
        torch.as_tensor(x), torch.as_tensor(origin), torch.as_tensor(h),
        torch.as_tensor(f0), torch.as_tensor(pos), fs, ratio, width, mode)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        w = w.numpy()
        past = np.arange(width)[None, :] > 2 * h[:, None]
        assert (g[past] == 0).all() and (w[past] == 0).all()
        err = np.abs(g - w).max(1)
        assert (err <= 1e-5 * np.abs(w).max(1)).all(), err.max()


@pytest.mark.parametrize("fs,width,mode,ratio", K1_CASES)
def test_k1_emulated_layout_matches_the_twin(fs, width, mode, ratio):
    """Frames at both ends of an odd-length x and inside it, windows
    from 1 sample to the whole row."""
    hmax = (width - 1) // 2
    h = np.array([3, 1, hmax, hmax // 2, 37, hmax, 300 % hmax, hmax - 1] * 2)
    origin = np.array([0, -1, 2, -3, 2 * width, hmax + 5, -hmax, 1] * 2)
    _k1_check(fs, width, mode, ratio, h, origin, width + mode)


@pytest.mark.parametrize("width,mode,ratio", [
    (2048, frames.CENTROID, 4.0), (2048, frames.STONEMASK, 0.0),
    (1027, frames.CHEAPTRICK, 3.0), (1027, frames.STONEMASK, 0.0)])
def test_k1_emulated_layout_cuts_wide_windows(width, mode, ratio):
    """Windows of 2h+1 samples past the row (h from half the width to 1.5
    times it), at a width of whole chunks and at one that is not: cut at
    the row's end as the twin cuts them, the sums over the cut row."""
    h = np.array([width // 2, width - 1, width, 3 * width // 2] * 2)
    origin = np.array([0, -1, 2 * width, width] * 2)
    _k1_check(48000, width, mode, ratio, h, origin, width + 7 * mode)


def test_k1_window_plan_holds_every_width():
    """`window_plan` holds every width up to the 46 KB limit of float32
    rows (11776) in at most 4 chunks a thread (16 values: the window and
    the samples, 32 registers in float32; float64 stages its window in
    shared memory), 128 threads up to 2048, at most 512 for float64's
    5888."""
    for width in list(range(1, 600)) + [1024, 1025, 1280, 1664, 2048, 2049,
                                        2560, 2816, 3328, 3712, 4096, 5888,
                                        8192, 11776]:
        nt, k = frames.window_plan(width)
        assert 4 * nt * k >= width and k <= 4 and nt <= 1024
        assert (nt == 128) == (width <= 2048)
        assert nt == 128 or 4 * (nt // 2) * 4 < width
        assert width > 5888 or nt <= 512


def _staged(row, off: int):
    """The row as the kernel stages it: 16-byte loads from its first
    16-byte boundary (the row starts at word `off` of an aligned tensor),
    the words before it by threads 0-2 and after the last one by threads
    4-6; each word exactly once."""
    n = row.shape[0]
    head = min((-off) % 4, n)
    nv = (n - head) // 4
    tail0 = head + 4 * nv
    hits = np.zeros(n, np.int64)
    hits[head:tail0] += 1                       # the float4 body
    hits[:head] += 1
    hits[tail0:] += 1
    assert (hits == 1).all() and n - tail0 <= 3 and head <= 3
    return row.copy()


def _fold(row, f0, fs: int, N: int, ul_max: int):
    """The DC fold of one float32 row, bin by bin as the kernel reads it
    from the unfolded row."""
    half = N // 2
    c = F(F(F(f0) * F(N)) / F(fs))
    tc = np.trunc(c)
    ic, frac = int(tc), F(c - tc)
    out = row.copy()
    for i in range(min(ul_max, half + 1)):
        add = F(0)
        if i <= ic:
            y0, y1 = row[min(ic - i, half)], row[min(ic + 1 - i, half)]
            add = F(y0 + F(F(y1 - y0) * frac))
        out[i] = F(row[i] + add)
    return out


def k2_emulate(ps, fs: int, N: int, f0=None, ul_max: int = 0, width=None,
               b_max: int = 0, off: int = 0):
    """K2's fast kernel on float32 rows ps (R, N/2+1) of a tensor whose
    first row starts at word `off` of an aligned buffer."""
    ps = np.asarray(ps, F)
    R, n = ps.shape
    half = N // 2
    b = b_max if width is not None else 0
    ul = ul_max if f0 is not None else 0
    tpr, run, _ = prims.smooth_plan(N, b)
    P = half + 2 * b + 1
    scale = F(fs / N)
    out = np.empty_like(ps)
    for r in range(R):
        row = _staged(ps[r], off + r * n)
        row = _fold(row, f0[r], fs, N, ul) if ul else row
        if b == 0:
            out[r] = row
            continue
        m = np.arange(tpr * run)
        src = np.where(m < b, b - m, np.where(m <= b + half, m - b,
                                              2 * half + b - m))
        live = m < P
        vals = np.where(live, row[np.clip(src, 0, half)] * scale,
                        F(0)).astype(F).astype(np.float64)
        vals = vals.reshape(tpr, run)           # thread t's odd run
        tot = np.zeros(tpr)
        for i in range(run):
            tot = tot + vals[:, i]
        incl = tot.reshape(tpr // 32, 32).copy()
        for d in (1, 2, 4, 8, 16):              # the shuffle-up scan
            up = incl.copy()
            up[:, d:] = incl[:, :-d]
            incl = np.where(np.arange(32) >= d, incl + up, incl)
        excl = np.concatenate([np.zeros((tpr // 32, 1)), incl[:, :-1]], 1)
        # each warp's offset: the totals of the warps before it, in order
        base = np.array([sum(incl[v, 31] for v in range(w)) if w else 0.0
                         for w in range(tpr // 32)])
        acc = (base[:, None] + excl).reshape(tpr)
        S = np.empty(tpr * run)
        for i in range(run):
            acc = acc + vals[:, i]
            S[np.arange(tpr) * run + i] = acc
        S = S[:P]
        wd = F(width[r])
        wb = F(F(F(wd * F(N)) / F(fs)) / F(2))
        bm = F(F(b) - F(0.5))
        s_hi, s_lo = F(bm + wb), F(bm - wb)
        t_hi, t_lo = np.trunc(s_hi), np.trunc(s_lo)
        f_hi, f_lo = float(F(s_hi - t_hi)), float(F(s_lo - t_lo))
        st_hi = min(max(int(t_hi), 0), P - half - 2)
        st_lo = min(max(int(t_lo), 0), P - half - 2)
        k = np.arange(n)
        a0, a1 = S[st_hi + k], S[st_hi + k + 1]
        b0, b1 = S[st_lo + k], S[st_lo + k + 1]
        out[r] = (((a0 + f_hi * (a1 - a0)) - (b0 + f_lo * (b1 - b0)))
                  * (1.0 / float(wd))).astype(F)
    return out


def _harmonic_rows(R: int, n: int, f0, fs: int, N: int, rng):
    """Power rows: harmonics of each row's f0 on a noise floor six decades
    down, every other row a millionth of the level."""
    j = np.arange(n)[None, :]
    c = (f0 * N / fs)[:, None]
    ps = 1e-6 * rng.standard_normal((R, n)) ** 2
    for k, a in enumerate([1.0, 0.4, 0.2, 0.05, 0.02], 1):
        ps = ps + a * np.exp(-((j - k * c) / 1.5) ** 2)
    ps[::2] *= 1e-6
    return ps.astype(F)


# (fs, N, ul_max, b_max) of each float32 path: CheapTrick and D4C at 48 and
# 44.1 kHz (173/114, 344/342), at 22.05 kHz (88/57, 173/171)
K2_CASES = [(48000, 2048, 173, 114), (48000, 4096, 344, 342),
            (22050, 1024, 88, 57), (22050, 2048, 173, 171)]


@pytest.mark.parametrize("fs,N,ul_max,b_max", K2_CASES)
@pytest.mark.parametrize("dc,ls", [(True, True), (True, False),
                                   (False, True)])
def test_k2_emulated_order_within_the_limit(fs, N, ul_max, b_max, dc, ls):
    """f0 from 40 Hz to past the ul_max and b_max edges (the last taps of
    the fold, the reads' clamps at both ends of the mirrored row), widths
    f0 and 2 f0 / 3, rows at every 4-byte offset from 16-byte alignment:
    each element within `smooth_spectrum_limit`, the fold alone bit for
    bit."""
    n = N // 2 + 1
    rng = np.random.default_rng(N + b_max)
    fmax = (ul_max - 2) * fs / N
    f0 = np.concatenate([[40.0, 41.3, fmax - 1.0, fmax, fmax * 1.004,
                          (b_max - 0.5) * fs / N, 2 * b_max * fs / N],
                         rng.uniform(60, fmax, 5)]).astype(F)
    R = f0.shape[0]
    ps = _harmonic_rows(R, n, f0, fs, N, rng)
    width = (f0 if N == 4096 or fs == 22050 and N == 2048
             else (f0 * F(2) / F(3)).astype(F))
    args = dict(f0=f0 if dc else None, ul_max=ul_max,
                width=width if ls else None, b_max=b_max)
    targs = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
             for k, v in args.items()}
    want = prims.smooth_spectrum_plain(torch.as_tensor(ps), fs, N, **targs)
    lim = prims.smooth_spectrum_limit(torch.as_tensor(ps), want, fs, N,
                                      **targs).numpy()
    want = want.numpy()
    for off in range(4):
        got = k2_emulate(ps, fs, N, off=off, **args)
        if not ls:
            assert np.array_equal(got.view(np.int32), want.view(np.int32))
        assert (np.abs(got.astype(np.float64) - want) <= lim).all()


def test_k2_plan_covers_each_row():
    """`smooth_plan`'s odd runs cover the mirrored row (or the row) with
    the fewest threads (32-256): 64 at N = 2048, 128 at 4096 (b_max 114,
    342), several rows a block of 128 threads below 128."""
    assert prims.smooth_plan(2048, 114)[:2] == (64, 21)
    assert prims.smooth_plan(4096, 342)[:2] == (128, 23)
    assert prims.smooth_plan(4096, 0)[0] == 128
    for N in (256, 512, 1024, 2048, 4096, 8192):
        for b in (0, 1, 57, 114, 171, 342, 683):
            plan = prims.smooth_plan(N, b)
            need = max(N // 2 + 2 * b + 1 if b else 0, N // 2 + 1)
            if plan is None:
                assert need > 256 * prims.SMOOTH_RUN_MAX
                continue
            tpr, run, rpb = plan
            assert run % 2 == 1 and tpr * run >= need
            assert tpr == 32 or (tpr // 2) * prims.SMOOTH_RUN_MAX < need
            assert rpb * tpr == max(128, tpr)
