"""The generation lane's kernels as their plain twins, against the JAX
package on the CPU, in float64: K21 (the modulation-spectrum postfilter,
`ops/postfilter.mspf_plain`), K22 (the mel-cepstral postfilter,
`mcep_postfilter_plain`), K23 (GV scaling, `ops/gv.gv_scale_plain`), the
SPTK transforms under K22, and K7/K8's float64 twins at the 1e16 spread
of precisions generation gives them.  Each kernel's own arithmetic (K21's
direct 64-point DFTs and gather overlap-add, K22's folded table) is also
written out in numpy and held against the twin."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu.features import windows as jwindows
from hts_train_world_tpu.ops import gv as jgv
from hts_train_world_tpu.ops import mlpg as jmlpg
from hts_train_world_tpu.ops import postfilter as jpf
from hts_train_world_tpu.ops import sptk as jsptk
from hts_train_world_tpu_torch.features import windows
from hts_train_world_tpu_torch.ops import gv, mlpg, postfilter, sptk


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _traj(T, D, seed):
    """Smooth random trajectories with a level, as MLPG gives them."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((T, D)) * 0.1, axis=0)
    return x + rng.standard_normal(D)[None] * 2.0


def _stats(D, seed, smooth=False):
    """Statistics as make_mspf gathers them: over rough (natural) or
    smoothed (generated) trajectories of a few utterances."""
    trajs = [_traj(T, D, seed + i) for i, T in enumerate((90, 150, 211))]
    if smooth:
        k = np.ones(5) / 5.0
        trajs = [np.stack([np.convolve(t[:, d], k, "same")
                           for d in range(D)], 1) for t in trajs]
    return jpf.mspf_stats(trajs)


# ---------------------------------------------------------------------------
# K21: the modulation-spectrum postfilter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [37, 400])
def test_k21_twin_seq2msmp_and_msmp2seq_match_jax(T):
    x = _traj(T, 1, T)[:, 0]
    ms, mp = postfilter.seq2msmp(_t(x))
    jms, jmp = (np.asarray(v) for v in jpf.seq2msmp(jnp.asarray(x)))
    assert ms.shape == jms.shape == (postfilter.n_frames(T), 33)
    np.testing.assert_allclose(ms.numpy(), jms, rtol=0, atol=1e-10)
    # phases as unit phasors (a bin with a signed-zero imaginary part reads
    # +-1 by the sign of that zero, the same angle), where the spectrum is
    # not exactly 0: a frame whose windowed samples are all 0 (the last
    # one when T = 1 mod 12) has the phase of its FFT's signed zeros
    live = jms > 0.5 * np.log(1e-30) + 1.0
    assert (T % 12 == 1) == (not live[-1].any())
    for f in (np.cos, np.sin):
        np.testing.assert_allclose(f(np.pi * mp.numpy())[live],
                                   f(np.pi * jmp)[live], rtol=0, atol=1e-10)
    y = postfilter.msmp2seq(ms, mp, T).numpy()
    jy = np.asarray(jpf.msmp2seq(jnp.asarray(jms), jnp.asarray(jmp), T))
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-10)


@pytest.mark.parametrize("T", [37, 400])
def test_k21_twin_apply_and_stats_match_jax(T):
    D = 5
    trajs = [_traj(T, D, 1), _traj(T + 13, D, 2)]
    nat, gen = _stats(D, 3), _stats(D, 4, smooth=True)
    for w in (1.0, 0.6):
        got = postfilter.apply_mspf(_t(trajs[0]), nat, gen, w).numpy()
        want = np.asarray(jpf.apply_mspf(jnp.asarray(trajs[0]), nat, gen, w))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    st = postfilter.mspf_stats(trajs, device="cpu")
    jst = jpf.mspf_stats(trajs)
    np.testing.assert_allclose(st.mean, jst.mean, rtol=1e-12)
    np.testing.assert_allclose(st.std, jst.std, rtol=1e-12)
    # tests/test_sptk_postfilter.py's gate: stats mapped onto themselves
    # leave the trajectory within 5% (+ 0.05)
    one = postfilter.mspf_stats(trajs[:1], device="cpu")
    out = postfilter.apply_mspf(_t(trajs[0]), one, one, 1.0).numpy()
    assert np.abs(out - trajs[0]).max() < \
        0.05 * np.abs(trajs[0]).max() + 0.05


def test_k21_twin_gives_jax_inf_and_nan_for_a_zero_gen_std():
    """A dimension whose generated std is 0 at some bins: the map divides
    by it unguarded, as in JAX, and the inf/NaN reach the trajectory."""
    T, D = 60, 3
    x = _traj(T, D, 5)
    nat, gen = _stats(D, 6), _stats(D, 7, smooth=True)
    gen.std[1, ::3] = 0.0
    got = postfilter.apply_mspf(_t(x), nat, gen, 1.0).numpy()
    want = np.asarray(jpf.apply_mspf(jnp.asarray(x), nat, gen, 1.0))
    assert not np.isfinite(want[:, 1]).any()
    assert np.isfinite(want[:, [0, 2]]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-10)


def _k21_numpy(x, stats, weight):
    """K21's arithmetic (csrc/mspf.cu) in numpy, one trajectory: the mean,
    direct 64-point DFTs of the 25 windowed samples, the map, the inverse
    with bins 0 and 32 real, and the gather overlap-add in ascending frame
    order from 0.0."""
    T = len(x)
    F = postfilter.n_frames(T)
    j = np.arange(64)
    cs, sn = np.cos(2 * np.pi * j / 64), np.sin(2 * np.pi * j / 64)
    bart = 1.0 - np.abs((np.arange(25) - 12.0) / 12.0)
    mean = x.sum() / T
    ms = np.zeros((F, 33))
    Y = np.zeros((F, 33), complex)
    for f in range(F):
        t = f * 12 + np.arange(25) - 12
        ok = (t >= 0) & (t < T)
        v = np.where(ok, (x[np.clip(t, 0, T - 1)] - mean) * bart, 0.0)
        for k in range(33):
            jj = (k * np.arange(25)) & 63
            re, im = 0.0, 0.0
            for n in range(25):
                re = re + v[n] * cs[jj[n]]
                im = im - v[n] * sn[jj[n]]
            ms[f, k] = 0.5 * np.log(re * re + im * im + 1e-30)
            if stats is not None:
                nm, ns, gm, gs = (s[k] for s in stats)
                conv = ((ms[f, k] - gm) / gs) * ns + nm
                mag = np.exp(ms[f, k] + weight * (conv - ms[f, k]))
                ph = np.pi * (np.arctan2(im, re) / np.pi)
                Y[f, k] = mag * np.cos(ph) + 1j * mag * np.sin(ph)
    if stats is None:
        return ms
    frames = np.zeros((F, 64))
    for f in range(F):
        for n in range(64):
            acc = 0.0
            for k in range(1, 32):
                jj = (k * n) & 63
                acc = acc + (Y[f, k].real * cs[jj] - Y[f, k].imag * sn[jj])
            nyq = -Y[f, 32].real if n & 1 else Y[f, 32].real
            frames[f, n] = (Y[f, 0].real + nyq + 2.0 * acc) / 64
    out = np.zeros(T)
    for t in range(T):
        p = t + 12
        acc = 0.0
        for k in range(max(0, -(-(p - 63) // 12)), min(F - 1, p // 12) + 1):
            acc = acc + frames[k, p - k * 12]
        out[t] = acc + mean
    return out


def test_k21_arithmetic_in_numpy_matches_the_twin():
    T = 53
    x = _traj(T, 2, 7)
    nat, gen = _stats(2, 8), _stats(2, 9, smooth=True)
    ms = postfilter.mspf_plain(_t(x)).numpy()
    stats = tuple(_t(a) for a in (nat.mean, nat.std, gen.mean, gen.std))
    y = postfilter.mspf_plain(_t(x), stats, 0.8).numpy()
    for d in range(2):
        np.testing.assert_allclose(_k21_numpy(x[:, d], None, 0.8), ms[d],
                                   rtol=0, atol=1e-11)
        st = [a[d] for a in (nat.mean, nat.std, gen.mean, gen.std)]
        np.testing.assert_allclose(_k21_numpy(x[:, d], st, 0.8), y[:, d],
                                   rtol=0, atol=1e-11)


def test_k21_twin_overlap_add_is_index_add_in_frame_order():
    """The twin's index_add_ adds each output sample's frames in ascending
    order from 0.0: the order the kernel's gather uses."""
    rng = np.random.default_rng(10)
    ms = _t(rng.normal(-2.0, 1.0, (9, 33)))
    mp = _t(rng.uniform(-1.0, 1.0, (9, 33)))
    T = 90
    y = postfilter.msmp2seq(ms, mp, T).numpy()
    w = np.fft.irfft(np.exp(ms.numpy()) * np.exp(1j * np.pi * mp.numpy()),
                     64)
    want = np.zeros(T)
    for t in range(T):
        p, acc = t + 12, 0.0
        for k in range(9):
            if 0 <= p - 12 * k < 64:
                acc = acc + w[k, p - 12 * k]
        want[t] = acc
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# K22: the mel-cepstral postfilter, and the SPTK transforms under it
# ---------------------------------------------------------------------------


def _mgc(T, M, seed):
    rng = np.random.default_rng(seed)
    mgc = rng.standard_normal((T, M)) * 0.3 / (1.0 + np.arange(M))
    mgc[:, 0] -= 2.0
    return mgc


def test_sptk_transforms_match_jax():
    mc = _mgc(7, 13, 11)
    a = 0.42
    np.testing.assert_allclose(sptk.freqt(_t(mc), 300, -a).numpy(),
                               np.asarray(jsptk.freqt(jnp.asarray(mc), 300,
                                                      -a)),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(sptk._mc2b_matrix(12, a),
                                  jsptk._mc2b_matrix(12, a))
    b = sptk.mc2b(_t(mc), a)
    np.testing.assert_allclose(b.numpy(), np.asarray(
        jsptk.mc2b(jnp.asarray(mc), a)), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(sptk.b2mc(b, a).numpy(), mc, atol=1e-12)
    for n in (16, 64):
        np.testing.assert_allclose(
            sptk.c2acr(_t(mc), 3, n).numpy(),
            np.asarray(jsptk.c2acr(jnp.asarray(mc), 3, n)), rtol=1e-12)


@pytest.mark.parametrize("fft_size", [1024, 4096])
def test_k22_twin_matches_jax(fft_size):
    """At 1024 the rfft crops the 2048-term warped cepstrum; at 4096 it
    pads it."""
    mgc = _mgc(6, 13, fft_size)
    got = postfilter.mcep_postfilter_plain(_t(mgc), 0.42, 1.4,
                                           fft_size).numpy()
    want = np.asarray(jpf.mcep_postfilter(jnp.asarray(mgc), 0.42, 1.4,
                                          fft_size))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert np.abs(got[:, 0] - mgc[:, 0]).max() > 1e-3   # c0 moved


@pytest.mark.parametrize("fft_size", [1024, 4096])
def test_k22_cosine_table_crops_and_pads_as_the_rfft(fft_size):
    """The folded table's cosine half on a 2048-term sequence that does not
    decay: the real part of an rfft at fft_size, which takes the first
    1024 terms at 1024 and zero-pads to 4096."""
    rng = np.random.default_rng(fft_size)
    s = rng.standard_normal(postfilter.CO + 1)
    C = postfilter.cosine_table(fft_size)
    assert C.shape == (min(fft_size, postfilter.CO + 1), fft_size // 2 + 1)
    np.testing.assert_allclose(s[:C.shape[0]] @ C,
                               np.fft.rfft(s, fft_size).real, rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("fft_size", [1024, 4096])
def test_k22_folded_table_arithmetic_matches_the_twin(fft_size):
    """K22's arithmetic in numpy: Re C_k as dot products with the folded
    table, the C2R-weighted sums of exp(2 Re C_k), and the emphasised
    cepstrum with c0 moved by half the log ratio."""
    M = 13
    mgc = _mgc(5, M, 20 + fft_size)
    G = postfilter.folded_table(M, 0.42, fft_size)
    H = fft_size // 2 + 1
    assert G.shape == (M, H)
    w = mgc * np.where(np.arange(M) >= 2, 1.4, 1.0)
    a = np.full(H, 2.0)
    a[0] = a[-1] = 1.0
    r = (a * np.exp(2.0 * (mgc @ G))).sum(1)
    rw = (a * np.exp(2.0 * (w @ G))).sum(1)
    want = w.copy()
    want[:, 0] += np.log(r / rw) / 2.0
    got = postfilter.mcep_postfilter_plain(_t(mgc), 0.42, 1.4,
                                           fft_size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)


# ---------------------------------------------------------------------------
# K23: GV scaling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight", [1.0, 0.5])
def test_k23_twin_matches_jax(weight):
    rng = np.random.default_rng(30)
    x = rng.standard_normal((200, 7)) * rng.uniform(0.1, 3.0, 7)
    x[:, 3] = 1.5                                   # var 0: the 1e-12 floor
    g = rng.uniform(0.2, 2.0, 7)
    got = gv.gv_scale(_t(x), g, weight).numpy()
    want = np.asarray(jgv.gv_scale(jnp.asarray(x), jnp.asarray(g), weight))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    if weight == 1.0:
        keep = np.arange(7) != 3
        np.testing.assert_allclose(got.var(0)[keep], g[keep], rtol=1e-9)


def test_k23_twin_with_the_lf0_mask_matches_jax():
    """pgen's lf0: voiced, non-MAGIC rows only, and only with more than 2
    of them; the other rows keep their values."""
    rng = np.random.default_rng(31)
    x = rng.normal(5.3, 0.2, (120, 1))
    v = rng.random(120) > 0.4
    x[~v] = -1.0e10
    got = gv.gv_scale(_t(x), [0.09], 0.8, mask=torch.as_tensor(v)).numpy()
    want = x.copy()
    want[v] = np.asarray(jgv.gv_scale(jnp.asarray(x[v]), jnp.asarray([0.09]),
                                      0.8))
    np.testing.assert_allclose(got, want, rtol=1e-9)
    few = np.zeros(120, bool)
    few[[4, 9]] = True
    same = gv.gv_scale(_t(x), [0.09], 0.8, mask=torch.as_tensor(few))
    np.testing.assert_array_equal(same.numpy(), x)


# ---------------------------------------------------------------------------
# K7 and K8 in float64
# ---------------------------------------------------------------------------


def _spread_inputs(T, D, seed):
    """MLPG inputs with precisions spread over ~1e16: unvoiced frames'
    variances x1e8, a leaf at its 1e-8 floor, ordinary variances."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((T, 3, D))
    var = rng.uniform(0.05, 2.0, (T, 3, D))
    var[T // 4:T // 2] *= 1e8
    var[T // 2:T // 2 + 7] = 1e-8
    return mu, var


@pytest.mark.parametrize("T", [50, 400])
def test_k8_float64_twin_matches_jax_at_a_1e16_precision_spread(T):
    mu, var = _spread_inputs(T, 4, T)
    got = mlpg.mlpg_plain(_t(mu), _t(var)).numpy()
    want = np.asarray(jmlpg.mlpg(jnp.asarray(mu), jnp.asarray(var)))
    scale = np.abs(want).max(0)
    assert (np.abs(got - want) <= 1e-9 * scale).all()


def test_k7_float64_twin_matches_jax():
    rng = np.random.default_rng(40)
    x = rng.standard_normal((60, 5)) * 1e3
    x[10:14, 2] = -1.0e10
    got = windows.expand_plain(_t(x)).numpy()
    want = np.asarray(jwindows.expand(jnp.asarray(x)))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
