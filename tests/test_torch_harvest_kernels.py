"""The plain twins of the Harvest kernels (K13-K16) against the JAX
package, on the CPU, and the kernels' arithmetic written out in numpy.

On the CPU each kernel wrapper runs its plain PyTorch twin; these tests
hold the twins against the JAX functions on the same numpy inputs, at
48 kHz (decimation ratio 6) unless a test says otherwise, and the whole
float64 chain against the JAX f64 Harvest.  `tests/test_torch_cuda.py`
holds each CUDA kernel against its twin on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu.ops import fftmat as jfftmat
from hts_train_world_tpu.ops import harvest as jhv
from hts_train_world_tpu.ops import harvest_fix as jhf
from hts_train_world_tpu.ops import prims as jprims
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import harvest as hv
from hts_train_world_tpu_torch.ops import harvest_fix as hf
from hts_train_world_tpu_torch.ops import prims

FS, L = 48000, 14400             # 0.3 s at 48 kHz: fs8 = 8000, T1 = 301


def _voices(fs, n, seed=1, B=2):
    """Harmonic utterances of 180 and 220 Hz with a 3 % vibrato, 1 % noise
    and, in the first, a quiet stretch in the middle."""
    t = np.arange(n) / fs
    rng = np.random.default_rng(seed)
    xs = []
    for i in range(B):
        f0 = (180.0 + 40.0 * i) * (1 + 0.03 * np.sin(2 * np.pi * 3.0 * t))
        ph = np.cumsum(2 * np.pi * f0 / fs)
        x = (0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph + 0.3)
             + 0.01 * rng.standard_normal(n))
        if i == 0:
            x[n // 2:n // 2 + n // 6] = 0.02 * rng.standard_normal(n // 6)
        xs.append(x)
    return np.stack(xs)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def front():
    """The port's float64 and f32 front (decimate -> band filter -> raw
    candidates -> detect/overlap) on two utterances."""
    xs = _voices(FS, L)
    plan = hv.harvest_plan(L, FS, cfg.K_FLOOR_F0, cfg.K_CEIL_F0)
    T1 = cfg.samples_for_dio(FS, L, 1.0)
    out = dict(xs=xs, plan=plan, T1=T1)
    for dt, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        y = hv.waveform_sub(_t(xs, dt), plan)
        filt = hv.band_filter(y, plan)
        raw = hv.raw_candidates(filt, plan, cfg.K_FLOOR_F0, cfg.K_CEIL_F0,
                                T1)
        cands, nc = hv.detect_candidates(raw, plan["nc_pad"])
        out[name] = dict(y=y, filt=filt, raw=raw, nc=nc,
                         cands=hv.overlap_candidates(cands, nc))
    return out


# ---------------------------------------------------------------------------
# constants carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs,n", [(8000, 4000), (16000, 6144),
                                  (44100, 13230), (48000, 14400)])
def test_plan_and_constants_equal(fs, n):
    """The plan, the decimation and Butterworth coefficients, the IIR block
    operators, the refinement sizes and DFT table, and the section caps
    equal the JAX package's."""
    assert hv.harvest_plan(n, fs, 71.0, 800.0) == jhv.harvest_plan(
        n, fs, 71.0, 800.0)
    assert prims.DECIMATE_COEF == jprims._DECIMATE_COEF
    assert hf.BUTTER_B == jhf._BUTTER_B and hf.BUTTER_A == jhf._BUTTER_A
    assert hv.OVERLAP_PARAMETER == jhv.OVERLAP_PARAMETER
    coefs = prims.DECIMATE_COEF[6][:3]
    F, _, Fb = prims.affine_kernel(coefs, 64)
    jF, jK, jFb = jprims._affine_kernel(coefs, 3, 64)
    np.testing.assert_array_equal(F, jF)
    np.testing.assert_array_equal(Fb, jFb)
    fs8 = hv.harvest_plan(n, fs, 71.0, 800.0)["actual_fs"]
    h_cap, B = hv.refine_sizes(fs8, 71.0)
    assert h_cap == int(1.5 * fs8 / 71.0 + 1.0)
    assert B == 4 * 2 ** int(np.log(2 * h_cap + 1.0) / cfg.K_LOG2)
    C, S = jfftmat._rfft_mats_np(B)
    cos_t, sin_t = hv.dft_table_np(B)
    np.testing.assert_array_equal(cos_t, C[:, 1])
    np.testing.assert_array_equal(sin_t, -S[:, 1])
    T = cfg.samples_for_dio(fs, n, 1.0)
    assert hf.step3_section_cap(T) == jhf.step3_section_cap(T)
    assert hf.smooth_section_cap(T) == jhf.smooth_section_cap(T)


# ---------------------------------------------------------------------------
# K13: decimation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [6])
def test_decimate_matches_jax(r):
    """On an f32-representable input: the float64 twin within 1e-12 of the
    peak of JAX's f64 decimate, with the C's output count; on its f32
    cast, the port's output no further from JAX f64 than JAX's own f32
    path is."""
    x32 = _voices(8000 * r, 2400 * r)[0].astype(np.float32)
    want = np.asarray(jprims.decimate(jnp.asarray(x32, jnp.float64), r))
    got = prims.decimate_plain(_t(x32)[None], r)[0].numpy()
    assert got.shape == want.shape == (prims.decimate_count(len(x32), r),)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    j32 = np.asarray(jprims.decimate(jnp.asarray(x32), r))
    p32 = prims.decimate_plain(_t(x32, torch.float32)[None], r)[0].numpy()
    assert p32.dtype == np.float32
    assert np.abs(p32 - want).max() <= np.abs(j32 - want).max()


def _k13_numpy(x, r):
    """K13's arithmetic in numpy float64: 1024 chunks run from zero, the
    in-warp and cross-warp scans of their end states with the powers of
    P = A^chunk, the reruns from the true start states, the pick."""
    a0, a1, a2, b0, b1 = prims.DECIMATE_COEF[r]
    n = len(x)
    M = n + 2 * prims.DECIMATE_PAD
    chunk = -(-M // 1024)
    tab = prims._decimate_table(r, chunk, torch.device("cpu")).numpy()
    pw = tab[5:].reshape(37, 3, 3)
    xd = x.astype(np.float64)
    k = np.arange(9)
    padded = np.concatenate([2 * xd[0] - xd[9 - k], xd,
                             2 * xd[-1] - xd[n - 2 - k]])

    def run(inp, s, t0, t1, out=None):
        w1, w2, w3 = s
        for t in range(t0, t1):
            wt = inp[t] + a0 * w1 + a1 * w2 + a2 * w3
            if out is not None:
                out[t] = b0 * wt + b1 * w1 + b1 * w2 + b0 * w3
            w3, w2, w1 = w2, w1, wt
        return np.array([w1, w2, w3])

    def filter_pass(inp):
        bounds = [(min(i * chunk, M), min(min(i * chunk, M) + chunk, M))
                  for i in range(1024)]
        v = np.stack([run(inp, (0.0, 0.0, 0.0), a, b)
                      for a, b in bounds]).reshape(32, 32, 3)
        for o in (1, 2, 4, 8, 16):
            u = v.copy()
            v[:, o:] = u[:, o:] + u[:, :-o] @ pw[o].T
        prev = np.concatenate([np.zeros((32, 1, 3)), v[:, :-1]], axis=1)
        g = v[:, 31].copy()
        for kk, o in enumerate((1, 2, 4, 8, 16)):
            u = g.copy()
            g[o:] = u[o:] + u[:-o] @ pw[32 + kk].T
        out = np.zeros(M)
        for i, (a, b) in enumerate(bounds):
            w, lane = divmod(i, 32)
            s = prev[w, lane] + (pw[lane] @ g[w - 1] if w > 0 else 0.0)
            run(inp, s, a, b, out)
        return out

    y1 = filter_pass(padded)
    v = filter_pass(y1[::-1].copy())
    nout = (n - 1) // r + 1
    nbeg = r - r * nout + n
    last = M - 1 - nbeg - (prims.DECIMATE_PAD - 1)
    return v[last - r * np.arange(prims.decimate_count(n, r))]


@pytest.mark.parametrize("r,n", [(6, 14688), (2, 6144), (3, 2000)])
def test_k13_arithmetic_in_numpy(r, n):
    """The kernel's chunked scan, written out in numpy, lands within
    1e-12 of the peak of the twin's block formulation."""
    x = _voices(8000 * r, n)[1].astype(np.float32)
    want = prims.decimate_plain(_t(x)[None], r)[0].numpy()
    got = _k13_numpy(x, r)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# ---------------------------------------------------------------------------
# band filter and K14: raw candidates
# ---------------------------------------------------------------------------


def test_band_filter_matches_jax(front):
    """The FFT product, read from h+1, equals JAX's direct convolution
    (band_filter_f32 run in float64) within 1e-10 of each row's peak."""
    plan = front["plan"]
    y = front["f64"]["y"][0].numpy()
    hs = tuple(h for _, h, _ in hv.channel_layout(plan))
    want = np.asarray(jhv.band_filter_f32(
        jnp.asarray(y), plan["y_length"], hs, tuple(plan["boundaries"]),
        plan["actual_fs"]))
    filt = front["f64"]["filt"][0].numpy()
    got = np.stack([filt[c, h + 1:h + 1 + plan["y_length"]]
                    for c, h in enumerate(hs)])
    assert np.abs(got - want).max(1).max() <= 1e-10 * np.abs(want).max()


def test_k14_plain_matches_jax_f64(front):
    """float64: the twin's raw candidates equal JAX's f64 _raw_candidates
    of the same decimated signal: the same zero pattern, values within
    1e-9 relative (the f64 path filters by FFT and interpolates with
    interp1, as the twin does; no channel saturates its cap here)."""
    plan, T1 = front["plan"], front["T1"]
    got = front["f64"]["raw"].numpy()
    for u in range(2):
        want = np.asarray(jhv._raw_candidates(
            jnp.asarray(front["f64"]["y"][u].numpy()), plan["actual_fs"],
            plan["fft_size"], plan["y_length"], T1,
            tuple(plan["boundaries"]), cfg.K_FLOOR_F0, cfg.K_CEIL_F0, 1.0))
        np.testing.assert_array_equal(got[u] > 0, want > 0)
        np.testing.assert_allclose(got[u], want, rtol=1e-9, atol=0)
    assert (got > 0).mean() > 0.05


def test_k14_plain_f32_vs_jax_zc_candidates(front):
    """f32, the same band rows into JAX's _zc_candidates (the f32
    scatter+cumsum interpolation) and into the twin (binary-search
    interp1, K14's formula): on frames nonzero in both, rel within 1e-4;
    gate flips (zero in one only) under 0.5 %.  Both against the float64
    interp1 of the twin's crossings: the twin within 1e-5 relative."""
    plan, T1 = front["plan"], front["T1"]
    Ly, fs8 = plan["y_length"], plan["actual_fs"]
    filt = front["f32"]["filt"]
    got, n, pos = hv.raw_candidates_plain(filt, plan, cfg.K_FLOOR_F0,
                                          cfg.K_CEIL_F0, T1, crossings=True)
    got = got.numpy()
    temporal = jnp.arange(T1, dtype=jnp.float32) * 0.001
    layout = hv.channel_layout(plan)
    # one JAX cap for every channel: caps only matter once a channel's
    # crossings overrun them, and none does here (see the f64 test)
    cap = max(c for _, _, c in layout)
    fn = jax.jit(jax.vmap(lambda f, b: jhv._zc_candidates(
        f, b, Ly, temporal, fs8, cfg.K_FLOOR_F0, cfg.K_CEIL_F0, cap)))
    rows = np.stack([filt[:, c, h + 1:h + 1 + Ly].numpy()
                     for c, (_, h, _) in enumerate(layout)], 1)
    bnd = np.asarray([b for b, _, _ in layout], np.float32)
    want = np.stack([np.asarray(fn(jnp.asarray(rows[u]), jnp.asarray(bnd)))
                     for u in range(2)])
    both = (got > 0) & (want > 0)
    assert both.mean() > 0.05
    assert ((got > 0) != (want > 0)).mean() < 0.005
    rel = np.abs(got[both] - want[both]) / want[both]
    assert rel.max() < 1e-4
    ref = hv.crossing_candidates_f64(filt, plan, T1, n, pos).numpy()
    rel_p = np.abs(got[got > 0] - ref[got > 0]) / ref[got > 0]
    assert rel_p.max() < 1e-5


# ---------------------------------------------------------------------------
# detection and overlap
# ---------------------------------------------------------------------------


def _raw_field(seed, voiced=0.55, n_ch=152, T=90):
    """test_harvest_device.py's random field: `voiced` of the channels
    voiced at random, with clean runs injected."""
    rng = np.random.default_rng(seed)
    raw = np.where(rng.random((n_ch, T)) < voiced,
                   rng.uniform(60, 800, (n_ch, T)), 0.0)
    raw[20:45, :] = 150.0 + np.arange(T) * 0.1
    raw[60:75, ::2] = 300.0
    return raw


def test_detect_overlap_match_jax():
    """detect_candidates and overlap_candidates against the JAX functions
    at 1e-12 on two fields of different counts, batched: each utterance
    spreads with its own count as the column stride."""
    raws = np.stack([_raw_field(7), _raw_field(8, voiced=0.1)])
    nc_pad = 13 * 7
    got, nc = hv.detect_candidates(_t(raws), nc_pad)
    ov = hv.overlap_candidates(got, nc).numpy()
    jnc = []
    detect = jax.jit(jhf.detect_candidates, static_argnums=1)
    for u in range(2):
        jc, jn = detect(jnp.asarray(raws[u]), nc_pad)
        np.testing.assert_allclose(got[u].numpy(), np.asarray(jc),
                                   atol=1e-12)
        np.testing.assert_allclose(ov[u], np.asarray(
            jhf.overlap_candidates(jc, jn)), atol=1e-12)
        jnc.append(int(jn))
    assert nc.tolist() == jnc and jnc[0] != jnc[1]


def _k32_numpy(raw, nc_cap):
    """K32's arithmetic in numpy: per (utterance, frame) the channels in
    order, the float64 prefix sum, a run's mean as the difference of the
    sums at its ends over its length, rounded once to the field's type;
    then the overlap from each utterance's largest count."""
    B, n_ch, T = raw.shape
    dets = np.zeros((B, T, nc_cap), raw.dtype)
    kc = np.zeros((B, T), np.int64)
    nc = np.zeros(B, np.int64)
    for u in range(B):
        for t in range(T):
            csum, at, start, k = 0.0, 0.0, -1, 0
            for c in range(n_ch):
                v = raw[u, c, t]
                voiced = v > 0 and 0 < c < n_ch - 1
                if voiced and start < 0:
                    start, at = c, csum
                elif not voiced and start >= 0:
                    if c - start >= 10:
                        if k < nc_cap:
                            dets[u, t, k] = (csum - at) / float(c - start)
                        k += 1
                    start = -1
                csum += float(v)
            kc[u, t] = min(k, nc_cap)
            nc[u] = max(nc[u], k)
    out = np.zeros_like(dets)
    for u in range(B):
        ncb = max(nc[u], 1)
        for t in range(T):
            for col in range(nc_cap):
                blk, j = divmod(col, ncb)
                src = t - (0 if blk == 0 else blk if blk <= 3 else 3 - blk)
                if blk < 7 and 0 <= src < T and j < kc[u, src]:
                    out[u, t, col] = dets[u, src, j]
    return out, nc


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k32_arithmetic_in_numpy(dtype):
    """K32's two stages, written out in numpy, equal the twin
    (detect_candidates + overlap_candidates) bit for bit on two random
    fields of different counts: the twin's float64 cumsum on the CPU sums
    in sequence as the kernel does."""
    raws = np.stack([_raw_field(7, T=40), _raw_field(8, voiced=0.1, T=40)]
                    ).astype(dtype)
    got, nc = _k32_numpy(raws, 91)
    want, nc_t = hv.detect_overlap(torch.as_tensor(raws), 91)
    assert nc.tolist() == nc_t.tolist() and nc[0] != nc[1]
    np.testing.assert_array_equal(got, want.numpy())


# ---------------------------------------------------------------------------
# K15: refinement
# ---------------------------------------------------------------------------


def test_k15_plain_matches_jax_f64(front):
    """float64: the twin's ≤ 6-bin DFTs against JAX's refine_all (full
    1024-point FFTs) at 1e-9 relative, zero where JAX is zero."""
    plan, T1 = front["plan"], front["T1"]
    f = front["f64"]
    got_r, got_s = hv.refine_plain(f["y"], f["cands"], plan["actual_fs"],
                                   cfg.K_FLOOR_F0, cfg.K_CEIL_F0)
    pos = jnp.arange(T1, dtype=jnp.float64) * 0.001
    for u in range(2):
        wr, ws = jhv.refine_all(jnp.asarray(f["y"][u].numpy()), pos,
                                jnp.asarray(f["cands"][u].numpy()),
                                plan["actual_fs"], cfg.K_FLOOR_F0,
                                cfg.K_CEIL_F0)
        np.testing.assert_allclose(got_r[u].numpy(), np.asarray(wr),
                                   rtol=1e-9, atol=0)
        np.testing.assert_allclose(got_s[u].numpy(), np.asarray(ws),
                                   rtol=1e-9, atol=0)
    assert (got_r > 0).sum() > 100


def test_k15_plain_f32_vs_jax_slab(front):
    """f32: the twin against JAX's _refine_all_slab (four 384 x 513
    matmuls a frame): refined f0 at rtol 1e-4 where both are nonzero,
    flips (nonzero in one only) under 1 % of the nonzero pairs.  A score
    is 1 / (mean relative harmonic error), whose weak harmonics read an
    ill-conditioned IF, so scores are held through that error against the
    float64 twin (test_k15_plain_matches_jax_f64 holds it to JAX's f64):
    the twin's median and 99th percentile no worse than 1.5x JAX's."""
    plan = front["plan"]
    f = front["f32"]
    args = (plan["actual_fs"], cfg.K_FLOOR_F0, cfg.K_CEIL_F0)
    got_r, got_s = (v.numpy() for v in hv.refine_plain(f["y"], f["cands"],
                                                       *args))
    ref_s = hv.refine_plain(f["y"].double(), f["cands"].double(),
                            *args)[1].numpy()
    for u in range(2):
        wr, ws = (np.asarray(v) for v in jhv._refine_all_slab(
            jnp.asarray(f["y"][u].numpy()), jnp.asarray(f["cands"][u].numpy()),
            *args))
        both = (got_r[u] > 0) & (wr > 0)
        assert ((got_r[u] > 0) != (wr > 0)).sum() <= 0.01 * (wr > 0).sum()
        np.testing.assert_allclose(got_r[u][both], wr[both], rtol=1e-4)
        live = both & (ref_s[u] > 0)
        e_p = np.abs(1.0 / got_s[u][live] - 1.0 / ref_s[u][live])
        e_j = np.abs(1.0 / ws[live] - 1.0 / ref_s[u][live])
        for q in (50, 99):
            assert np.percentile(e_p, q) <= 1.5 * np.percentile(e_j, q)


def _k15_numpy(y, u, t, f0, fs8, h_cap, B):
    """K15's per-pair arithmetic in numpy float32: the integers in the
    kernel's order, the window, the 32 lanes' strided sums of the six bins
    through the f32 table and their butterfly reduction, the readout."""
    f32 = np.float32
    L = y.shape[1]
    cos_t, sin_t = (a.astype(f32) for a in hv.dft_table_np(B))
    pos = f32(t) * f32(0.001)
    h = int(f32(f32(1.5 * fs8) / f0) + f32(1.0))
    e_c = int(np.floor(f32(np.log(f32(h) * f32(2.0) + f32(1.0)))
                       / f32(cfg.K_LOG2)))
    Bc = 4 << e_c
    x = f32(f32(pos + f32(f32(-h) / f32(fs8))) * f32(fs8)) + f32(0.001)
    base0 = int(np.trunc(x + f32(0.5) if x > 0 else x - f32(0.5)))
    first = base0 - 1
    nh = min(int(f32(f32(fs8 / 2.0) / f0)), 6)
    wt = f32(f32(f32(2.0) * f32(h) + f32(1.0)) / f32(fs8))
    fb = f32(f32(f0 * f32(Bc)) / f32(fs8))
    idx_c = []
    for k in range(6):
        v = f32(fb * f32(k + 1))
        idx_c.append(min(max(int(np.trunc(v + f32(0.5))), 0), Bc // 2))
    r = B // Bc
    j = np.arange(2 * h + 1)
    tmp = ((first + j) / fs8 - t * 0.001).astype(f32)   # float64, rounded
    mw = (f32(0.42) + f32(0.5) * np.cos(f32(2 * np.pi) * tmp / wt)
          + f32(0.08) * np.cos(f32(4 * np.pi) * tmp / wt)).astype(f32)
    mwp = np.concatenate([[f32(0)], mw, [f32(0)]])
    dw = -(mwp[2:] - mwp[:-2]) / f32(2.0)
    seg = y[u, np.clip(first + j, 0, L - 1)]
    xm, xd = seg * mw, seg * dw
    acc = np.zeros((32, 24), f32)
    for jj in range(2 * h + 1):
        lane = jj % 32
        for k in range(6):
            ph = (idx_c[k] * r * jj) % B
            acc[lane, 4 * k] += xm[jj] * cos_t[ph]
            acc[lane, 4 * k + 1] -= xm[jj] * sin_t[ph]
            acc[lane, 4 * k + 2] += xd[jj] * cos_t[ph]
            acc[lane, 4 * k + 3] -= xd[jj] * sin_t[ph]
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[np.arange(32) ^ o]
    return (h, e_c, Bc, first, nh, idx_c), acc[0]


def test_k15_arithmetic_in_numpy(front):
    """For 60 pairs: the kernel's integers (h, e_c, B_c, the window's first
    sample, nh, the six bins) equal the twin's pair_integers, and its six
    bins' sums (the windowed segment's real part, the derivative window's
    imaginary part) land within 1e-6 of the sum of their terms' magnitudes
    (the derivative window's sums cancel to 1e-3 of it)."""
    plan = front["plan"]
    fs8 = plan["actual_fs"]
    h_cap, B = hv.refine_sizes(fs8, cfg.K_FLOOR_F0)
    y = front["f32"]["y"]
    cands = front["f32"]["cands"]
    ub, t, c = torch.nonzero(cands > 0, as_tuple=True)
    pick = np.linspace(0, len(ub) - 1, 60).astype(int)
    ub, t, c = ub[pick], t[pick], c[pick]
    f0 = cands[ub, t, c]
    xm, xd, ints = hv.windowed_pairs(y, ub, t, f0, fs8, cfg.K_FLOOR_F0)
    cos_t, sin_t = (torch.as_tensor(a, dtype=torch.float32)
                    for a in hv.dft_table_np(B))
    for i in range(len(pick)):
        (h, e_c, Bc, first, nh, idx_c), acc = _k15_numpy(
            y.numpy(), int(ub[i]), int(t[i]), np.float32(f0[i]), fs8, h_cap,
            B)
        assert (h, e_c, Bc, first, nh) == tuple(
            int(v[i]) for v in ints[:5])
        assert idx_c == ints[5][i].tolist()
        # the twin's sums of this pair's windowed segment
        jj = torch.arange(xm.shape[1])
        ph = (torch.tensor(idx_c)[:, None] * (B // Bc) * jj) % B
        sm_re = (xm[i] * cos_t[ph]).sum(1).numpy()
        sd_im = -(xd[i] * sin_t[ph]).sum(1).numpy()
        # f32 sums of ~2h+1 terms: within 1e-6 of the terms' magnitude
        for got, want, x in ((acc[0::4], sm_re, xm[i]),
                             (acc[3::4], sd_im, xd[i])):
            assert np.abs(got - want).max() <= 1e-6 * float(x.abs().sum())


# ---------------------------------------------------------------------------
# K16: the contour stack
# ---------------------------------------------------------------------------


def _random_candidates(seed, T=220, NC=21):
    """test_harvest_device.py's candidate/score fields: voiced stretches
    with up to NC candidates near a base contour, dropouts, outliers."""
    rng = np.random.default_rng(seed)
    cands = np.zeros((T, NC))
    scores = np.zeros((T, NC))
    t0 = 0
    while t0 < T - 10:
        seg = int(rng.integers(5, 60))
        if rng.random() < 0.35:
            t0 += seg
            continue
        base = rng.uniform(80, 700)
        for t in range(t0, min(T, t0 + seg)):
            k = int(rng.integers(1, NC + 1))
            vals = base * (1 + 0.01 * rng.standard_normal(k))
            if rng.random() < 0.1:
                vals[rng.integers(0, k)] *= rng.uniform(1.5, 3.0)
            cands[t, :k] = np.abs(vals)
            scores[t, :k] = rng.uniform(2.5, 60.0, k)
            drop = rng.random(NC) < 0.2
            cands[t, drop] = 0.0
            scores[t, drop] = 0.0
        t0 += seg + int(rng.integers(1, 12))
    return cands, scores


@pytest.fixture(scope="module")
def fields():
    c, s = zip(*[_random_candidates(seed) for seed in range(6)])
    return np.stack(c), np.stack(s)


def test_k16_remove_unreliable_matches_jax(fields):
    c, s = fields
    gc, gs = hf.remove_unreliable(_t(c[:3]), _t(s[:3]))
    remove = jax.jit(jhf.remove_unreliable)
    for u in range(3):
        jc, js = remove(jnp.asarray(c[u]), jnp.asarray(s[u]))
        np.testing.assert_allclose(gc[u].numpy(), np.asarray(jc), atol=1e-12)
        np.testing.assert_allclose(gs[u].numpy(), np.asarray(js), atol=1e-12)


def test_k16_fix_contour_matches_jax(fields):
    """Seeds 0-5 in one batch, float64, within 1e-9."""
    c, s = fields
    T = c.shape[1]
    got = hf.fix_contour_plain(_t(c), _t(s), hf.step3_section_cap(T)).numpy()
    fix = jax.jit(jhf.fix_contour, static_argnums=2)
    for u in range(6):
        want = fix(jnp.asarray(c[u]), jnp.asarray(s[u]),
                   jhf.step3_section_cap(T))
        np.testing.assert_allclose(got[u], np.asarray(want), atol=1e-9,
                                   err_msg=f"seed {u}")


def test_k16_smooth_matches_jax(fields):
    c, s = fields
    T = c.shape[1]
    s4 = np.stack([np.asarray(jhv.fix_contour(c[u], s[u])) for u in range(3)])
    got = hf.smooth_contour_plain(_t(s4), hf.smooth_section_cap(T)).numpy()
    smooth = jax.jit(jhf.smooth_contour, static_argnums=1)
    for u in range(3):
        want = smooth(jnp.asarray(s4[u]), jhf.smooth_section_cap(T))
        np.testing.assert_allclose(got[u], np.asarray(want), atol=1e-9)


def test_k16_silence_has_no_section():
    """All-zero fields: no section, so FixStep3 returns its input and the
    contour is zero; no kernel launches on the CPU."""
    z = torch.zeros((2, 50, 7), dtype=torch.float32)
    kernels.reset_counts()
    assert (hf.contour(z, z) == 0).all()
    s2 = torch.zeros((2, 50))
    s2[1, 10:20] = 3.0        # one section in the second utterance only
    out = hf.fix_step3(s2, z, z, hf.step3_section_cap(50))
    assert torch.equal(out[0], s2[0])
    assert sum(kernels.launches.values()) == 0


# ---------------------------------------------------------------------------
# the chain in float64
# ---------------------------------------------------------------------------


def test_harvest_f0_f64_matches_jax(front):
    """The port's whole float64 chain (decimate -> band filter -> raw
    candidates -> detect/overlap -> refine -> contour) against JAX's f64
    harvest_f0_batch within 1e-6 Hz."""
    xs = front["xs"]
    got = hv.harvest_f0_batch(_t(xs), FS).numpy()
    want = np.asarray(jhv.harvest_f0_batch(jnp.asarray(xs), FS))
    assert got.shape == want.shape == (2, front["T1"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want > 0).mean() > 0.5
