"""The plain twins of the synth path's kernels (K9-K12) against the JAX
formulations they replace, on the CPU, and the kernels' own arithmetic
written out in numpy against the twins.

On the CPU each kernel wrapper runs its plain PyTorch twin.  The numpy
versions below follow each kernel's operations and order (the binary
search, the float64 running sum, the halving DC tree, the pulse-order
gather, the composed bap matrix), so they show on the CPU that the
kernels' formulations give the twins' results; `tests/test_torch_cuda.py`
holds the kernels themselves against the twins on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import cli as jcli
from hts_train_world_tpu.ops import fftmat as jfftmat
from hts_train_world_tpu.ops import prims as jprims
from hts_train_world_tpu.ops import synthesis as jsyn
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.features import decode
from hts_train_world_tpu_torch.ops import codec, synthesis as syn

FP = 5.0


def _contour(T, seed, kind):
    """voiced: a smooth 90-210 Hz contour; unvoiced: with unvoiced runs
    inside and at the end; boundary: voiced frames at exactly 500 Hz next
    to unvoiced ones (500 N / fs is integral, so phase wraps land on
    sample boundaries)."""
    rng = np.random.default_rng(seed)
    f0 = 150.0 + 60.0 * np.sin(np.arange(T) / 7.0 + rng.uniform(0, 3))
    if kind in ("unvoiced", "boundary"):
        f0[T // 3:T // 3 + 8] = 0.0
        f0[-5:] = 0.0
    if kind == "boundary":
        f0[T // 3 - 4:T // 3] = 500.0
        f0[T // 2:T // 2 + 3] = 20.0       # below the lowest f0: unvoiced
    return f0


def _sizes(fs, T):
    N = cfg.cheaptrick_fft_size(fs)
    yl = cfg.y_length_for(T, FP, fs)
    return N, yl, syn.default_max_pulses(yl, fs)


def _jax_pulses(f0, fs, yl, N, P, exact):
    """synthesis.py:130-143 of the JAX package for one contour."""
    _, ivuv, wrap, jump = jsyn._time_base(jnp.asarray(f0), FP, fs, yl, N,
                                          exact)
    n = jnp.sum(jump)
    pidx = jprims.compact_indices(jump, P, yl - 2)
    y1 = jnp.take(wrap, pidx) - 2.0 * jnp.pi
    y2 = jnp.take(wrap, pidx + 1)
    pnext = jnp.where(jnp.arange(P) + 1 < n, jnp.roll(pidx, -1), pidx)
    ns = pnext - pidx
    return [np.asarray(v) for v in (
        n, pidx, (-y1 / (y2 - y1)) / fs,
        jprims.exact_div(pidx.astype(wrap.dtype), float(fs)), ns,
        jnp.cumsum(ns) - ns, jnp.take(ivuv, pidx))]


# ---------------------------------------------------------------------------
# K9: the time base
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", [16000, 48000])
@pytest.mark.parametrize("kind", ["voiced", "unvoiced"])
def test_k9_twin_matches_jax_time_base(fs, kind):
    """float64: pulse count, indices, noise sizes and offsets identical to
    the JAX pulse setup; times and flags within 1e-12 and the time shifts
    within 1e-9 (a ratio of wrapped-phase differences, where the two
    cumsums' last-bit differences surface).  Voiced
    contours against the fast path (exact_phase=False), contours with
    unvoiced frames against the exact path (the jitted JAX cumsum fires
    other pulses at the 500 Hz default; ROADMAP.md Queue C)."""
    T = 40 if fs == 16000 else 24
    N, yl, P = _sizes(fs, T)
    f0 = np.stack([_contour(T, s, kind) for s in (0, 1)])
    got = syn.time_base(torch.as_tensor(f0), FP, fs, yl, N, P)
    for u in range(2):
        want = _jax_pulses(f0[u], fs, yl, N, P, exact=kind != "voiced")
        g = [v[u].numpy() for v in got]
        assert int(g[0]) == int(want[0]) > 10
        for k in (1, 4, 5):                    # pidx, noise size, offset
            np.testing.assert_array_equal(g[k], want[k])
        np.testing.assert_allclose(g[2], want[2], rtol=1e-9, atol=0)
        for k in (3, 6):                       # time, vuv
            np.testing.assert_allclose(g[k], want[k], rtol=1e-12, atol=0)


def test_k9_count_is_the_synthesis_count():
    """count_pulses (the count-only launch) equals the full launch's
    count; slots past it hold y_length - 2 and noise size 0; the last
    pulse's noise size is 0 (the reference quirk)."""
    fs, T = 16000, 40
    N, yl, P = _sizes(fs, T)
    f0 = torch.as_tensor(np.stack([_contour(T, s, k) for s, k in
                                   ((0, "voiced"), (1, "boundary"))]),
                         dtype=torch.float32)
    n = syn.count_pulses(f0, FP, fs, yl, N)
    pl = syn.time_base(f0, FP, fs, yl, N, P)
    assert torch.equal(n, pl.n) and (n < P).all()
    for u in range(2):
        k = int(n[u])
        assert (pl.pidx[u, k:] == yl - 2).all()
        assert (pl.noise_size[u, k - 1:] == 0).all()
        assert (pl.noise_size[u, :k - 1] > 0).all()
        assert (torch.diff(pl.pidx[u]) >= 0).all()


def k9_numpy(f0, fs, yl, N, P):
    """K9's arithmetic in numpy float32: the binary search over the
    computed coarse times, the float64 running sum rounded each step,
    fmod for the wrap, the jump scan and the compaction."""
    f32 = np.float32
    fp, lowest, fsf = f32(FP / 1000.0), f32(fs / N + 1.0), f32(fs)
    two_pi, pi = f32(2.0 * np.pi), f32(np.pi)
    out = []
    for row in f0.astype(np.float32):
        T = len(row)
        cf = np.where(row < lowest, f32(0), row).astype(np.float32)
        cv = np.where(cf == 0, f32(0), f32(1)).astype(np.float32)
        cf = np.append(cf, cf[-1] * f32(2) - cf[-2])
        cv = np.append(cv, cv[-1] * f32(2) - cv[-2])
        ct = np.arange(T + 1).astype(np.float32) * fp
        xi = np.arange(yl).astype(np.float32) / fsf
        k = np.clip(np.searchsorted(ct, xi, side="right"), 1, T)
        s = (xi - ct[k - 1]) / (ct[k] - ct[k - 1])
        iv = cv[k - 1] + s * (cv[k] - cv[k - 1])
        voiced = iv > f32(0.5)
        if0 = np.where(voiced, cf[k - 1] + s * (cf[k] - cf[k - 1]), f32(500))
        inc = (if0.astype(np.float32) * two_pi) / fsf
        total = np.cumsum(inc.astype(np.float64)).astype(np.float32)
        w = np.fmod(total, two_pi)
        w = np.where(w < 0, w + two_pi, w).astype(np.float32)
        jumps = np.nonzero(np.abs(w[1:] - w[:-1]) > pi)[0]
        n = len(jumps)
        pidx = np.full(P, yl - 2, np.int64)
        pidx[:min(n, P)] = jumps[:P]
        y1 = w[pidx] - two_pi
        shift = (-y1 / (w[pidx + 1] - y1)) / fsf
        nxt = np.where(np.arange(P) + 1 < n, np.roll(pidx, -1), pidx)
        ns = nxt - pidx
        out.append((n, pidx, shift, pidx.astype(np.float32) / fsf, ns,
                    np.cumsum(ns) - ns, voiced[pidx].astype(np.float32)))
    return [np.stack(v) for v in zip(*out)]


@pytest.mark.parametrize("fs", [16000, 48000])
@pytest.mark.parametrize("kind", ["voiced", "unvoiced", "boundary"])
def test_k9_kernel_arithmetic_equals_twin(fs, kind):
    """The kernel's float32 operations, in numpy, equal the twin bit for
    bit: counts, indices, sizes, offsets, shifts, times, flags."""
    T = 60 if fs == 16000 else 30
    N, yl, P = _sizes(fs, T)
    f0 = np.stack([_contour(T, s, kind) for s in (2, 3)]).astype(np.float32)
    want = k9_numpy(f0, fs, yl, N, P)
    got = syn.time_base(torch.as_tensor(f0), FP, fs, yl, N, P)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w), (g, w)


# ---------------------------------------------------------------------------
# K10: per-pulse spectra
# ---------------------------------------------------------------------------


def _spectra(fs, T, seed):
    rng = np.random.default_rng(seed)
    N = cfg.cheaptrick_fft_size(fs)
    freq = np.arange(N // 2 + 1) / N * fs
    sp = (np.exp(-freq[None, :] / 1500.0)
          * (1.0 + 0.5 * rng.random((T, 1))) + 1e-6)
    ap = np.clip(freq[None, :] / (fs / 2) + 0.1 * rng.random((T, 1)), 0, 1)
    ap[: T // 4, :3] = 0.9995             # frames the apr[0] > 0.999 test hits
    return sp, ap


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k10_twin_matches_jax_pulse_body(fs):
    """float64: log_p, log_a and the noise segments against the JAX fast
    path's interpolation-weight matmul, log spectra and noise slice
    (synthesis.py:154-175,177-194,217-227) at the same pulses, within
    1e-12; the unvoiced flags equal."""
    T = 40 if fs == 16000 else 24
    N, yl, P = _sizes(fs, T)
    f0 = np.stack([_contour(T, s, "unvoiced") for s in (0, 1)])
    sps, aps = zip(*(_spectra(fs, T, s) for s in (0, 1)))
    stream = np.random.default_rng(5).standard_normal(
        (2, syn.synthesis_stream_len(yl)))
    pl = syn.time_base(torch.as_tensor(f0), FP, fs, yl, N, P)
    lp, la, nz, unv = syn.pulse_spectra(
        torch.as_tensor(np.stack(sps)), torch.as_tensor(np.stack(aps)),
        torch.as_tensor(stream), pl.pulse_time, pl.vuv, pl.noise_size,
        pl.noise_off, FP, N)
    for u in range(2):
        pt, vuv = jnp.asarray(pl.pulse_time[u]), jnp.asarray(pl.vuv[u])
        pos = jprims.exact_div(pt, FP / 1000.0)
        fl = jnp.minimum(T - 1, jnp.floor(pos)).astype(jnp.int32)
        ce = jnp.minimum(T - 1, jnp.ceil(pos)).astype(jnp.int32)
        frac = pos - jnp.floor(pos)
        tt = jnp.arange(T)
        Wfl = (tt[None, :] == fl[:, None]).astype(jnp.float64)
        Wce = (tt[None, :] == ce[:, None]).astype(jnp.float64)
        W = jnp.where((fl == ce)[:, None], Wfl, Wfl * (1.0 - frac)[:, None]
                      + Wce * frac[:, None])
        env = jfftmat.mm(W, jnp.abs(jnp.asarray(sps[u])))
        apr = jfftmat.mm(W, jnp.clip(jnp.asarray(aps[u]), 0.001,
                                     0.999999999999)) ** 2
        want_lp = jnp.log(env * (1.0 - apr) + cfg.K_MY_SAFE_GUARD_MINIMUM) / 2
        tiny = jprims.tiny_floor(jnp.float64)
        want_la = jnp.where(vuv[:, None] != 0.0,
                            jnp.log(jnp.maximum(env * apr, tiny)) / 2.0,
                            jnp.log(jnp.maximum(env, tiny)) / 2.0)
        ns = np.asarray(pl.noise_size[u])[:, None]
        kj = np.arange(N)[None, :]
        sp_ = np.concatenate([stream[u], np.zeros(N)])
        seg = np.where(kj < ns, sp_[np.asarray(pl.noise_off[u])[:, None]
                                    + kj], 0.0)
        avg = seg.sum(1, keepdims=True) / np.maximum(ns, 1)
        want_nz = np.where(kj < ns, seg - avg, 0.0)
        np.testing.assert_allclose(lp[u].numpy(), want_lp, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(la[u].numpy(), want_la, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(nz[u].numpy(), want_nz, rtol=0,
                                   atol=1e-12)
        want_unv = (vuv <= 0.5) | (apr[:, 0] > 0.999)
        assert np.array_equal(unv[u].numpy(), np.asarray(want_unv))
    assert unv.any() and not unv.all()


# ---------------------------------------------------------------------------
# K11: response finish and overlap-add
# ---------------------------------------------------------------------------


def _ola_inputs(fs, T, seed, dtype):
    N, yl, P = _sizes(fs, T)
    rng = np.random.default_rng(seed)
    f0 = np.stack([_contour(T, s, "unvoiced") for s in (seed, seed + 1)])
    pl = syn.time_base(torch.as_tensor(f0, dtype=dtype), FP, fs, yl, N, P)
    per = torch.as_tensor(rng.standard_normal((2, P, N)), dtype=dtype)
    aper = torch.as_tensor(0.1 * rng.standard_normal((2, P, N)), dtype=dtype)
    unv = torch.as_tensor(rng.random((2, P)) < 0.3)
    return per, aper, unv, pl, yl, N


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k11_twin_matches_jax_ola(fs):
    """float64: the twin (DC remover, masks, index_add_) against the JAX
    fast path's finish and chunked one-hot OLA (synthesis.py:210-215,
    233,239-270) on the same raw responses, within 1e-12."""
    per, aper, unv, pl, yl, N = _ola_inputs(fs, 30, 0, torch.float64)
    half = N // 2
    got = syn.overlap_add(per, aper, unv, pl.pidx, pl.noise_size, pl.n, yl)
    dc_rm = jsyn._dc_remover(N, jnp.float64)
    kj = jnp.arange(N)
    for u in range(2):
        p = jprims.fftshift(jnp.asarray(per[u].numpy()))
        dc = jnp.sum(p[:, half:], axis=1, keepdims=True)
        p = jnp.where(kj < half, -dc * dc_rm, p - dc * dc_rm)
        p = jnp.where(jnp.asarray(unv[u].numpy())[:, None], 0.0, p)
        ns = jnp.asarray(pl.noise_size[u].numpy())
        resp = (p * jnp.sqrt(ns.astype(jnp.float64))[:, None]
                + jprims.fftshift(jnp.asarray(aper[u].numpy()))) / N
        P = ns.shape[0]
        valid = jnp.arange(P) < int(pl.n[u])
        resp = jnp.where((valid & (ns > 0))[:, None], resp, 0.0)
        start = jnp.asarray(pl.pidx[u].numpy()) + 1
        n_chunks = (yl + half) // N + 2
        chunk = jnp.where(valid, start // N, n_chunks + 4)
        rows = jnp.stack([jnp.zeros(2 * N).at[o:o + N].set(r) for r, o in
                          zip(resp, np.asarray(start % N))])
        onehot = (chunk[None, :] == jnp.arange(n_chunks)[:, None]) \
            .astype(jnp.float64)
        R = jfftmat.mm(onehot, rows)
        yp = (jnp.pad(R[:, :N], ((0, 1), (0, 0)))
              + jnp.pad(R[:, N:], ((1, 0), (0, 0)))).reshape(-1)
        want = np.asarray(yp[half:half + yl])
        assert np.abs(want).max() > 0.01
        np.testing.assert_allclose(got[u].numpy(), want, rtol=0, atol=1e-12)


def test_k11_halving_sum():
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((3, 1000)))
    assert torch.allclose(syn.halving_sum(x), x.sum(-1), rtol=1e-13)
    assert syn.halving_sum(x[:, :1]).shape == (3,)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k11_kernel_gather_equals_twin(fs):
    """The kernel's formulation in float32: each response element from
    the shifted index arithmetic and the halving-tree DC, masked pulses
    skipped, and each output sample summed in ascending pulse order from
    0 (a slice add per pulse, in order) equals the twin's index_add_ bit
    for bit."""
    per, aper, unv, pl, yl, N = _ola_inputs(fs, 30, 3, torch.float32)
    half = N // 2
    want = syn.overlap_add(per, aper, unv, pl.pidx, pl.noise_size, pl.n, yl)
    k = np.arange(N)
    src = np.where(k < half, k + half, k - half)
    rm = syn._dc_remover(N, torch.float32, "cpu").numpy()
    got = np.zeros((2, yl + N + 1), np.float32)
    for u in range(2):
        for p in range(per.shape[1]):
            ns = int(pl.noise_size[u, p])
            if p >= int(pl.n[u]) or ns <= 0:
                continue
            raw = per[u, p].numpy()
            tree = raw[:half].copy()
            while len(tree) > 1:
                h = len(tree) // 2
                tree = tree[:h] + tree[h:]
            d = tree[0]
            body = np.where(k < half, (-d) * rm, raw[src] - d * rm)
            body = np.zeros(N, np.float32) if bool(unv[u, p]) else body
            r = (body.astype(np.float32) * np.sqrt(np.float32(ns))
                 + aper[u, p].numpy()[src]) / np.float32(N)
            a = int(pl.pidx[u, p]) + 1
            got[u, a:a + N] += r.astype(np.float32)
    assert np.array_equal(got[:, half:half + yl], want.numpy())


# ---------------------------------------------------------------------------
# K12: the feature decode
# ---------------------------------------------------------------------------


def _features(fs, T, bap_dim, seed):
    """mgc / bap rows of the size and scale the encoder writes."""
    rng = np.random.default_rng(seed)
    mgc = rng.standard_normal((2, T, 50)) / (1.0 + np.arange(50)) ** 1.2
    mgc[..., 0] += 3.0
    bap = 0.5 * rng.standard_normal((2, T, bap_dim)) \
        / (1.0 + np.arange(bap_dim))
    bap[..., 0] -= 2.0
    lf0 = np.log(120.0 + 60.0 * rng.random((2, T)))
    lf0[:, T // 2:T // 2 + 4] = 0.0
    return lf0, mgc, bap


@pytest.mark.parametrize("fs", [16000, 48000])
@pytest.mark.parametrize("bap_dim", [24, 25])
def test_k12_twin_matches_jax_decode(fs, bap_dim):
    """float64: f0, sp and ap of the twin against cli.decode_features
    within rel 1e-10 (bap 24 reads 24 coefficients, bap 25 all 25 under
    the odd-apl rule; 24 bins set, the rest 0)."""
    N = cfg.cheaptrick_fft_size(fs)
    lf0, mgc, bap = _features(fs, 12, bap_dim, 1)
    got = decode.decode_features(*(torch.as_tensor(v)
                                   for v in (lf0, mgc, bap)), fs, N)
    for u in range(2):
        want = jcli.decode_features(jnp.asarray(lf0[u]), jnp.asarray(mgc[u]),
                                    jnp.asarray(bap[u]), fs, N)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[u].numpy(), np.asarray(w),
                                       rtol=1e-10, atol=0)
    assert (got[2][..., 24:] == 0).all() and (got[2][..., :24] > 0).all()


@pytest.mark.parametrize("bap_dim", [24, 25])
def test_k12_composed_bap_matrix(bap_dim):
    """The kernel's map W (freqt composed with the real DFT) equals the
    twin's freqt matmul + rfft in float64 (1e-10), and its float32 sums,
    written out in the kernel's order, lie within decode_limit of the
    twin's float32 result."""
    fs = 48000
    N = cfg.cheaptrick_fft_size(fs)
    lf0, mgc, bap = (torch.as_tensor(v) for v in _features(fs, 10, bap_dim,
                                                          2))
    apl = decode.ap_order(bap_dim)
    W = decode._ap_matrix_np(bap_dim, N)
    assert W.shape == (min(apl + 1, bap_dim), apl)
    b = torch.cat([bap[..., :1] + decode.LN_1E4, bap[..., 1:]], -1)
    b = b[..., :W.shape[0]]
    want64 = codec.mgc2sp_real(b, decode.ALPHA, N)[..., :apl]
    np.testing.assert_allclose((b @ torch.as_tensor(W)).numpy(), want64,
                               rtol=1e-10, atol=1e-12)
    b32, W32 = b.float(), torch.as_tensor(W, dtype=torch.float32)
    acc = b32[..., 0:1] * W32[0]
    for j in range(1, W32.shape[0]):
        acc = acc + b32[..., j:j + 1] * W32[j]
    ap_k = torch.exp(acc) / np.float32(1e4)
    _, _, ap_p = decode.decode_features_plain(lf0.float(), mgc.float(),
                                              bap.float(), fs, N)
    _, lim_ap = decode.decode_limit(lf0.float(), mgc.float(), bap.float(),
                                    fs, N)
    err = (ap_k.log() - ap_p[..., :apl].log()).abs()
    assert (err <= lim_ap).all()


def test_k12_decode_launches_nothing_on_cpu():
    kernels.reset_counts()
    lf0, mgc, bap = (torch.as_tensor(v, dtype=torch.float32)
                     for v in _features(16000, 5, 25, 0))
    f0, sp, ap = decode.decode_features(lf0, mgc, bap, 16000, 1024)
    assert sum(kernels.launches.values()) == 0
    assert f0.dtype == sp.dtype == ap.dtype == torch.float32
    assert sp.shape == ap.shape == (2, 5, 513)
