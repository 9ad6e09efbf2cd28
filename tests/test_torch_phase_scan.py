"""K9's tiled phase sum and K17's row prologue, written out in torch on the
CPU and held against the twins and the JAX package.

K9 sums float32 phase increments in tiles over many blocks where
`synthesis.phase_sum_exact` holds (every partial sum exact in float64, so
every order of addition gives the sequential sum) and in sequence
elsewhere.  The emulation below follows the kernels' orders: the stats
kernel's strided per-thread sums and butterfly reductions for the tile
sums, the carry as a reduction of the earlier tiles' sums, and the scan
kernel's contiguous per-thread runs, warp scans and block scan; then the
wraps, the jumps and the compaction by tiles (per-tile counts, each
pulse's slot at its tile's offset, the noise sizes from the next pulse
and the offsets as differences to the first).  K17's row prologue (1/v,
sum log v, log w, log1p(-w)) is put back together into log-likelihoods
and held against JAX's `frame_loglik`, through the buffer layout the
wrapper hands the kernel.  `tests/test_torch_cuda.py` holds the kernels
themselves against the twins on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu.models import hsmm as jhsmm
from hts_train_world_tpu.ops import prims as jprims
from hts_train_world_tpu.ops import synthesis as jsyn
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch.models import hsmm
from hts_train_world_tpu_torch.ops import synthesis as syn

FP = 5.0
TILE = syn.K9_TILE           # samples a tile
BT, PER = 256, 8             # threads a block, samples a thread


def _contour(T, seed, kind):
    """headline: a 90-250 Hz sung contour with vibrato and unvoiced runs
    (as the headline batch's analysis gives it); falling: the same voiced
    to the end, its last two frames 119.998 and 40 Hz, so that the
    extrapolated frame 2 a - z lies at -39.998 Hz and the lerp toward it
    passes 0.001 Hz half a frame on, a sample at 16 and 48 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    f0 = (170.0 + 80.0 * np.sin(t / 37.0 + rng.uniform(0, 3))
          + 6.0 * np.sin(2 * np.pi * 5.5 * t * FP / 1000.0))
    if kind == "headline":
        for at in rng.integers(5, T - 20, 3):
            f0[at:at + rng.integers(4, 12)] = 0.0
        f0[-3:] = 0.0
    else:
        f0[-2:] = (119.998, 40.0)
    return f0


def _increments(f0, fs, yl):
    N = cfg.cheaptrick_fft_size(fs)
    return syn.phase_increments(torch.as_tensor(f0, dtype=torch.float32),
                                FP, fs, yl, N)


def _butterfly(v):
    """A warp's xor-shuffle sum (the kernels' block_reduce), v (..., 32)
    -> (...,): every lane ends with the same value."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., torch.arange(32) ^ o]
    return v[..., 0]


def _block_sum(v):
    """block_reduce(Add) over BT threads, v (..., BT) -> (...,): the warps'
    butterflies, then the eight warp sums in order."""
    w = _butterfly(v.reshape(*v.shape[:-1], BT // 32, 32))
    out = w[..., 0]
    for i in range(1, BT // 32):
        out = out + w[..., i]
    return out


def _warp_scan(x):
    """Inclusive Hillis-Steele scan over the last axis of 32 lanes (the
    kernels' shfl_up doubling)."""
    for o in (1, 2, 4, 8, 16):
        y = torch.zeros_like(x)
        y[..., o:] = x[..., :-o]
        x = x + y
    return x


def _block_exclusive(v):
    """block_exclusive_scan over BT threads, v (..., BT): the warp scans,
    warp 0's scan of the warp totals, then prefix + inclusive - v."""
    x = _warp_scan(v.reshape(*v.shape[:-1], BT // 32, 32))
    tot = torch.zeros(v.shape[:-1] + (32,), dtype=v.dtype)
    tot[..., :BT // 32] = x[..., -1]
    tot = _warp_scan(tot)[..., :BT // 32]
    before = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], -1)
    return ((before[..., None] + x).reshape(v.shape) - v)


def tiled_sum(inc):
    """K9's float route in torch: inc (y,) float32 -> the float64 partial
    sums (y,) in the kernels' orders (tile sums, carries, block scans);
    the phases are these rounded to float32."""
    y = inc.shape[0]
    nt = -(-y // TILE)
    x = torch.zeros(nt * TILE, dtype=torch.float64)
    x[:y] = inc.double()
    tiles = x.reshape(nt, TILE)
    # the stats kernel: thread tid holds samples tid + q BT, q = 0..7
    strided = tiles.reshape(nt, PER, BT)
    run = strided[:, 0]
    for q in range(1, PER):
        run = run + strided[:, q]
    tsum = _block_sum(run)
    # the scan kernel's carry: thread i holds tile i's sum where i < k
    held = torch.zeros(nt, BT, dtype=torch.float64)
    for k in range(nt):
        for i in range(k):
            held[k, i % BT] = held[k, i % BT] + tsum[i]
    carry = _block_sum(held)
    # the tile: thread tid owns samples tid PER + [0, PER)
    own = tiles.reshape(nt, BT, PER)
    pre = torch.cumsum(own, -1)       # in sequence: one thread's run
    off = carry[:, None] + _block_exclusive(pre[..., -1])
    return (off[..., None] + pre).reshape(-1)[:y]


def tiled_pulses(wrap, vuv, y, P, fs, dtype):
    """K9's compaction by tiles on the wraps (y,) and V/UV flags (y,): the
    tiles' pulse counts, each pulse at its tile's offset, noise sizes from
    the next pulse (in the tile or the next tile's first; the cap's last
    slot wraps to the first pulse), offsets as differences to the first
    pulse, the fill slots from y - 2.  Returns the seven Pulses fields of
    one row."""
    w = np.asarray(wrap)
    jump_at = np.nonzero(np.abs(w[1:] - w[:-1]) > np.pi)[0] + 1   # at s
    nt = -(-y // TILE)
    by_tile = [jump_at[(jump_at >= k * TILE) & (jump_at < (k + 1) * TILE)]
               for k in range(nt)]
    count = len(jump_at)
    p0 = int(jump_at[0]) - 1 if count else 0
    pidx = np.zeros(P, np.int64)
    nsize = np.zeros(P, np.int64)
    noff = np.zeros(P, np.int64)
    shift = np.zeros(P, dtype)
    ptime = np.zeros(P, dtype)
    pv = np.zeros(P, dtype)
    two_pi, fsd = dtype(2.0 * np.pi), dtype(fs)
    before = 0
    for k in range(nt):
        pulses = by_tile[k] - 1
        later = [t for t in by_tile[k + 1:] if len(t)]
        after = int(later[0][0]) - 1 if later else -1
        for li, i in enumerate(pulses):
            r = before + li
            if r >= P:
                break
            pidx[r] = i
            y1 = w[i] - two_pi
            shift[r] = (-y1 / (w[i + 1] - y1)) / fsd
            ptime[r] = dtype(i) / fsd
            pv[r] = 1.0 if vuv[i] else 0.0
            if r + 1 < count:
                nxt = ((pulses[li + 1] if li + 1 < len(pulses) else after)
                       if r + 1 < P else p0)
                nsize[r] = nxt - i
            noff[r] = i - p0
        before += len(pulses)
    for r in range(min(count, P), P):
        pidx[r] = y - 2
        y1 = w[y - 2] - two_pi
        shift[r] = (-y1 / (w[y - 1] - y1)) / fsd
        ptime[r] = dtype(y - 2) / fsd
        pv[r] = 1.0 if vuv[y - 2] else 0.0
        noff[r] = int(jump_at[-1]) - 1 - p0 if count else 0
    return [np.int64(count), pidx, shift, ptime, nsize, noff, pv]


@pytest.mark.parametrize("fs", [16000, 44100, 48000])
def test_the_condition_holds_on_headline_contours(fs):
    T = 401
    yl = cfg.y_length_for(T, FP, fs)
    f0 = np.stack([_contour(T, s, "headline") for s in range(4)])
    assert syn.phase_sum_exact(_increments(f0, fs, yl)).all()


@pytest.mark.parametrize("fs", [16000, 48000])
def test_the_condition_rejects_the_falling_tail(fs):
    """Past the last frame the interpolation reaches the extrapolated
    frame: increments near 0 (a small exponent) and below 0."""
    T = 401
    yl = cfg.y_length_for(T, FP, fs) + fs // 200
    f0 = _contour(T, 0, "falling")[None]
    inc = _increments(f0, fs, yl)
    tail = inc[0, -fs // 200:]
    assert (tail.abs() < 1e-6).any() and (tail < 0).any()
    assert not syn.phase_sum_exact(inc).any()
    assert syn.phase_sum_exact(inc[:, :cfg.y_length_for(T, FP, fs)]).all()


def test_the_condition_rejects_non_finite_and_accepts_zeros():
    inc = torch.tensor([[0.0, 0.0, 0.0], [0.1, float("inf"), 0.1],
                        [0.1, float("nan"), 0.1], [0.1, 0.2, 0.3]])
    assert syn.phase_sum_exact(inc).tolist() == [True, False, False, True]


@pytest.mark.parametrize("fs", [16000, 44100, 48000])
def test_tile_order_equals_the_sequential_sum(fs):
    """The kernels' order of float64 additions gives the twin's
    sequential sum bit for bit on rows the condition accepts."""
    T = 401
    yl = cfg.y_length_for(T, FP, fs)
    f0 = np.stack([_contour(T, s, "headline") for s in range(3)])
    inc = _increments(f0, fs, yl)
    want = torch.cumsum(inc, 1, dtype=torch.float64).float()
    for u in range(3):
        assert torch.equal(tiled_sum(inc[u]).float(), want[u])


def test_tile_order_differs_where_the_condition_fails():
    """On a row the condition rejects the kernels' order need not give the
    sequential sum: 1 followed by 2^-53 steps stays 1 in sequence (each
    add ties to even) and grows in tiles.  Such a row takes the serial
    route."""
    inc = torch.full((5000,), 2.0 ** -53)
    inc[0] = 1.0
    assert not syn.phase_sum_exact(inc[None]).any()
    want = torch.cumsum(inc, 0, dtype=torch.float64)
    assert (want == 1.0).all()
    assert not torch.equal(tiled_sum(inc), want)


@pytest.mark.parametrize("fs", [16000, 48000])
@pytest.mark.parametrize("cap", ["default", "below", "zero"])
def test_tiled_route_equals_the_twin(fs, cap):
    """The emulated route (tiled sum, wraps, jumps, compaction by tiles)
    gives time_base_plain's seven outputs bit for bit."""
    T = 401
    N = cfg.cheaptrick_fft_size(fs)
    yl = cfg.y_length_for(T, FP, fs)
    f0 = np.stack([_contour(T, s, "headline") for s in (4, 5)])
    P = {"default": syn.default_max_pulses(yl, fs), "below": 37,
         "zero": 0}[cap]
    want = syn.time_base_plain(torch.as_tensor(f0, dtype=torch.float32), FP,
                               fs, yl, N, P)
    inc = _increments(f0, fs, yl)
    ivuv = syn._increments(torch.as_tensor(f0, dtype=torch.float32), FP, fs,
                           yl, N)[0]
    for u in range(2):
        wrap = torch.remainder(tiled_sum(inc[u]).float(), 2.0 * np.pi)
        got = tiled_pulses(wrap.numpy(), ivuv[u].numpy() > 0, yl, P, fs,
                           np.float32)
        for name, g, w in zip(syn.Pulses._fields, got, want):
            assert np.array_equal(np.asarray(g), w[u].numpy()), name
    if cap == "below":
        assert (want.n > P).all()


@pytest.mark.parametrize("fs", [16000, 48000])
def test_tiled_compaction_matches_jax_pulses(fs):
    """The compaction by tiles on JAX's own wraps and V/UV flags (the exact
    path, float64) gives JAX's pulse setup (synthesis.py:130-143)."""
    T = 401 if fs == 48000 else 120
    N = cfg.cheaptrick_fft_size(fs)
    yl = cfg.y_length_for(T, FP, fs)
    P = syn.default_max_pulses(yl, fs)
    f0 = _contour(T, 6, "headline")
    _, ivuv, wrap, jump = jsyn._time_base(jnp.asarray(f0), FP, fs, yl, N,
                                          True)
    n = jnp.sum(jump)
    pidx = jprims.compact_indices(jump, P, yl - 2)
    y1 = jnp.take(wrap, pidx) - 2.0 * jnp.pi
    y2 = jnp.take(wrap, pidx + 1)
    pnext = jnp.where(jnp.arange(P) + 1 < n, jnp.roll(pidx, -1), pidx)
    ns = pnext - pidx
    want = [np.asarray(v) for v in (
        n, pidx, (-y1 / (y2 - y1)) / fs,
        jprims.exact_div(pidx.astype(wrap.dtype), float(fs)), ns,
        jnp.cumsum(ns) - ns, jnp.take(ivuv, pidx))]
    got = tiled_pulses(np.asarray(wrap), np.asarray(ivuv) > 0, yl, P, fs,
                       np.float64)
    assert int(got[0]) == int(want[0]) > 100
    for k in (1, 4, 5, 6):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=0)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-15, atol=0)


# ---------------------------------------------------------------------------
# K17's row prologue
# ---------------------------------------------------------------------------


def _loglik_inputs(B=2, T=29, K=11, R=16, seed=0):
    rng = np.random.default_rng(seed)
    sts = hsmm.world_streams()
    D = sts[-1].sl.stop
    fr = rng.standard_normal((B, T, D)) * 2.0 + 1.0
    for st in sts:
        if st.msd:
            fr[:, ::3, st.sl] = 0.0
    means = [rng.standard_normal((R, st.sl.stop - st.sl.start)) + 1.0
             for st in sts]
    vars_ = [rng.uniform(0.01, 3.0, (R, st.sl.stop - st.sl.start))
             for st in sts]
    msd_w = [rng.uniform(0.0, 1.0, R) for _ in sts]
    msd_w[1][:2] = (0.0, 1.0)                     # clipped to [1e-4, 1-1e-4]
    rows = [rng.integers(0, R, (B, K)) for _ in sts]
    return sts, fr, means, vars_, msd_w, rows


def _jax_loglik(sts, fr, means, vars_, msd_w, rows):
    args = hsmm.stream_args(sts)
    return np.stack([np.asarray(jhsmm.frame_loglik(
        jnp.asarray(fr[b]), tuple(jnp.asarray(m[r[b]])
                                  for m, r in zip(means, rows)),
        tuple(jnp.asarray(v[r[b]]) for v, r in zip(vars_, rows)),
        tuple(jnp.asarray(w[r[b]]) for w, r in zip(msd_w, rows)), *args))
        for b in range(fr.shape[0])])


def _from_rows(fr, rows, means, tables, sts):
    """The kernel's scoring from the prologue's tables: per stream
    -0.5 ((sum (x - mu)^2 (1/v) + sum log v) + D log 2pi), the MSD
    switch, the weighted sum in stream order."""
    x = torch.as_tensor(fr)
    total = torch.zeros(x.shape[:2] + (rows[0].shape[1],),
                        dtype=torch.float64)
    for st, m, (iv, slv, lw, l1), r in zip(sts, means, tables, rows):
        a, e = st.sl.start, st.sl.stop
        r = torch.as_tensor(r)
        d = x[:, :, None, a:e] - m[r][:, None]
        q = (d * iv[r][:, None] * d).sum(-1)
        ll = -0.5 * ((q + slv[r][:, None]) + (e - a) * hsmm.LOG_2PI)
        if st.msd:
            present = (x[:, :, a] != 0.0)[..., None]
            ll = torch.where(present, lw[r][:, None] + ll, l1[r][:, None])
        total = total + st.weight * ll
    return total


def test_k17_row_prologue_rebuilds_jax_frame_loglik():
    sts, fr, means, vars_, msd_w, rows = _loglik_inputs()
    m_t = [torch.as_tensor(m) for m in means]
    tables = hsmm.loglik_rows_plain(
        m_t, [torch.as_tensor(v) for v in vars_],
        [torch.as_tensor(w) for w in msd_w], [st.msd for st in sts])
    got = _from_rows(fr, rows, m_t, tables, sts).numpy()
    want = _jax_loglik(sts, fr, means, vars_, msd_w, rows)
    assert np.all(np.abs(got - want) <= 1e-12 * (1.0 + np.abs(want)))


def test_k17_buffer_layout_feeds_the_same_log_likelihoods():
    """The buffer and meta the wrapper builds for the kernel: the prologue
    run over it in place (a row at a time, as the kernel's first stage)
    and the scores read through meta's offsets match JAX."""
    sts, fr, means, vars_, msd_w, rows = _loglik_inputs(seed=3)
    args = hsmm.stream_args(sts)
    t = [tuple(torch.as_tensor(a) for a in x) for x in (means, vars_, msd_w)]
    buf, meta, wts, entry = hsmm._row_tables(*t, *args)
    assert entry is not None and list(wts) == list(args[2])
    meta = np.asarray(list(meta)).reshape(len(sts), 9)
    buf = buf.clone()
    tables, mus = [], []
    for st, (a, e, f, R, o_mu, o_iv, o_slv, o_lw, o_l1) in zip(sts, meta):
        D = e - a
        assert (a, e, f) == (st.sl.start, st.sl.stop, st.msd)
        v = buf[o_iv:o_iv + R * D].reshape(R, D)
        slv = torch.log(v).sum(-1)
        buf[o_slv:o_slv + R] = slv
        buf[o_iv:o_iv + R * D] = (1.0 / v).reshape(-1)
        if f:
            w = buf[o_lw:o_lw + R].clamp(1e-4, 1.0 - 1e-4)
            buf[o_lw:o_lw + R], buf[o_l1:o_l1 + R] = w.log(), torch.log1p(-w)
        mus.append(buf[o_mu:o_mu + R * D].reshape(R, D))
        tables.append((buf[o_iv:o_iv + R * D].reshape(R, D),
                       buf[o_slv:o_slv + R],
                       buf[o_lw:o_lw + R] if f else None,
                       buf[o_l1:o_l1 + R] if f else None))
    got = _from_rows(fr, rows, mus, tables, sts).numpy()
    want = _jax_loglik(sts, fr, means, vars_, msd_w, rows)
    assert np.all(np.abs(got - want) <= 1e-12 * (1.0 + np.abs(want)))
