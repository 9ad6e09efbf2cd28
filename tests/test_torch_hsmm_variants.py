"""The port's HSMM variants (models/hsmm_variants.py: UPMIX, ERST5, SEMIT)
against the JAX package, on the CPU, in float64.

The corpora are the JAX package's own tests': tests/test_hsmm.py's tiny
10-dim streams and three-phone corpus, and tests/test_hsmm_variants.py's
bimodal (`default_rng(5)`) and whitening (`default_rng(11)`) corpora,
rebuilt here from their seeds.  JAX model sets come across through
`hsmm.modelset_from_numpy` and `hsmm_variants.mixture_from_numpy`; the
entry points run with `device="cpu"`, where K33 and K34 run as their plain
twins (no kernel launches here).

Bounds, each case's reason in its docstring:
- `upmix`, the M-step's host parts and generation: bit for bit;
- the mixture log-likelihood (K33's chain twin): 1e-12 * max(1, |ll|), the
  two packages summing each quadratic form in another order;
- alignments: ends equal, log-likelihoods within 1e-12 relative;
- posteriors (K33's posterior twin): 1e-12 absolute;
- ERST5 after 4 iterations: parameters within 1e-9 of each array's largest
  magnitude, the per-iteration log-likelihoods within 1e-10 relative;
- Gales' update (K34's twin): A within 1e-9 of max|A|, sigmas 1e-8
  relative, aux 1e-12 relative (an independent float64 version sits at
  2.0e-12, 9.0e-11 and 2.4e-14 of JAX's at d = 50, G = 200).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import tests.test_hsmm as th
from tests.test_torch_hsmm import _port
from hts_train_world_tpu.models import hsmm as jhsmm
from hts_train_world_tpu.models import hsmm_variants as jhv
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.models import hsmm
from hts_train_world_tpu_torch.models import hsmm_variants as hv

CPU = dict(device="cpu")
f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the twins run many small ops, which the
    default thread pool slows many-fold when test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_):
    pass


def _t(a, dtype=f64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _carry_mix(jm):
    """The JAX package's MixtureModelSet as the port's (copied arrays)."""
    return hv.mixture_from_numpy(
        jm.names, jm.means, jm.variances, jm.mix_logw, jm.msd_weights,
        jm.dur_mean, jm.dur_var,
        [(s.name, s.sl.start, s.sl.stop, s.msd, s.msd_flag_col, s.weight)
         for s in jm.streams])


def _close(got, want, rel):
    """Within `rel` of the array's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-300)


@pytest.fixture(scope="module")
def three_phones():
    """tests/test_hsmm.py's corpus (six utterances of four of a, b, c from
    `default_rng(1)`) and tests/test_hsmm_variants.py's `_fit_base`: init
    from phone spans, two Viterbi EM iterations (JAX)."""
    rng = np.random.default_rng(1)
    corpus = []
    for _ in range(6):
        seq = [th.names_all[i] for i in rng.integers(0, 3, 4)]
        frames, bounds = th._sample_utterance(rng, th.model_means, seq, 3)
        corpus.append((frames, seq, bounds))
    frames_by_model = {n: [] for n in th.names_all}
    for frames, seq, bounds in corpus:
        ends = bounds[2::3]
        starts = np.concatenate([[0], ends[:-1]])
        for i, n in enumerate(seq):
            frames_by_model[n].append(frames[starts[i]:ends[i]])
    ms = jhsmm.init_modelset(th.names_all, frames_by_model, th._tiny_streams(),
                             n_states=3)
    ms = jhsmm.embedded_reestimate(ms, [(f, s) for f, s, _ in corpus],
                                   n_iters=2, log=_quiet)
    return [(f, s) for f, s, _ in corpus], ms


def _bimodal_utts():
    """tests/test_hsmm_variants.py::test_upmix_em_separates_bimodal_data's
    corpus: one model of two states whose mgc emissions are bimodal."""
    rng = np.random.default_rng(5)
    centers = np.array([[2.0, -2.0, 1.0, 0.0], [-2.0, 2.0, -1.0, 0.5]])
    utts = []
    for _ in range(8):
        fr = []
        for s in range(2):
            d = 14 + int(rng.integers(0, 4))
            pick = rng.integers(0, 2, d)
            base = centers[pick] + (3.0 * s)
            f = np.zeros((d, 10))
            f[:, :4] = base + 0.2 * rng.standard_normal((d, 4))
            f[:, 4] = 1.0 + 0.1 * rng.standard_normal(d)
            f[:, 5] = 0.2 * rng.standard_normal(d)
            f[:, 6:8] = 0.2 * rng.standard_normal((d, 2))
            f[:, 8] = 1.0 + 0.1 * rng.standard_normal(d)
            f[:, 9] = 0.2 * rng.standard_normal(d)
            fr.append(f)
        utts.append((np.concatenate(fr), ["a"]))
    return utts


def _whitening_utts():
    """tests/test_hsmm_variants.py::test_semitied_whitens_and_improves's
    corpus: three states sharing one mixing matrix in the mgc stream."""
    rng = np.random.default_rng(11)
    L = np.eye(4) + 0.6 * rng.standard_normal((4, 4)) * (1 - np.eye(4))
    mus = rng.standard_normal((3, 4)) * 3.0
    utts = []
    for _ in range(6):
        fr = []
        for s in range(3):
            d = 20 + int(rng.integers(0, 6))
            scale = np.array([1.0, 0.5, 0.25, 0.75]) * (1 + 0.3 * s)
            z = rng.standard_normal((d, 4)) * scale
            f = np.zeros((d, 10))
            f[:, :4] = mus[s] + z @ L.T
            f[:, 4] = 1.0 + 0.1 * rng.standard_normal(d)
            f[:, 5] = 0.2 * rng.standard_normal(d)
            f[:, 6:8] = 0.2 * rng.standard_normal((d, 2))
            f[:, 8] = 1.0 + 0.1 * rng.standard_normal(d)
            f[:, 9] = 0.2 * rng.standard_normal(d)
            fr.append(f)
        utts.append((np.concatenate(fr), ["a"]))
    return utts


def _one_model(utts, S, n_iters):
    ms = jhsmm.init_modelset(["a"], {"a": [u[0] for u in utts]},
                             th._tiny_streams(), n_states=S)
    return jhsmm.embedded_reestimate(ms, utts, n_iters=n_iters, log=_quiet)


@pytest.mark.parametrize("perturb", [0.2, 0.0])
def test_upmix_bit_equal(three_phones, perturb):
    _, jms = three_phones
    want = jhv.upmix(jms, perturb)
    got = hv.upmix(_port(jms), perturb)
    assert got.names == want.names and got.n_comps == want.n_comps == 2
    for part in ("means", "variances", "mix_logw", "msd_weights"):
        for k, v in getattr(want, part).items():
            np.testing.assert_array_equal(getattr(got, part)[k], v)
    np.testing.assert_array_equal(got.dur_mean, want.dur_mean)
    np.testing.assert_array_equal(got.dur_var, want.dur_var)


def _random_mixture(rng, streams, S, C, floor_at=None):
    """Per stream (S, C, D_s) means and variances, (S, C) log-weights and
    (S,) MSD weights; `floor_at` puts one component's variance of the
    first column at 1e-8 (a variance floor), whose frames score ~-1e8."""
    out = []
    for st in streams:
        D = st.sl.stop - st.sl.start
        m = rng.standard_normal((S, C, D))
        v = rng.uniform(0.05, 3.0, (S, C, D))
        if floor_at is not None:
            v[floor_at, 1, 0] = 1e-8
        w = rng.uniform(0.1, 1.0, (S, C))
        out.append((m, v, np.log(w / w.sum(1, keepdims=True)),
                    rng.uniform(0.0, 1.0, S)))
    return [tuple(o[i] for o in out) for i in range(4)]


@pytest.mark.parametrize("streams,T,C", [
    ("tiny", 40, 2), ("tiny", 9, 3), ("world", 5, 2)])
def test_k33_chain_twin_matches_jax(streams, T, C):
    """K33's chain twin against JAX's `frame_loglik_mix` on frames with
    unvoiced lf0/vib rows and a component at the variance floor: within
    1e-12 * max(1, |ll|) (JAX sums each quadratic form in its own order)."""
    sts = th._tiny_streams() if streams == "tiny" else \
        jhsmm.world_streams()
    rng = np.random.default_rng(33)
    D = sts[-1].sl.stop
    S = 3
    fr = rng.standard_normal((T, D))
    for st in sts:
        if st.msd:
            fr[::3, st.sl] = 0.0
    means, vars_, logws, msd_w = _random_mixture(rng, sts, S, C, floor_at=1)
    sls = tuple((s.sl.start, s.sl.stop) for s in sts)
    flags = tuple(s.msd for s in sts)
    wts = tuple(s.weight for s in sts)
    want = np.asarray(jhv.frame_loglik_mix(
        jnp.asarray(fr), tuple(jnp.asarray(a) for a in means),
        tuple(jnp.asarray(a) for a in vars_),
        tuple(jnp.asarray(a) for a in logws),
        tuple(jnp.asarray(a) for a in msd_w), sls, flags, wts))
    kernels.reset_counts()
    got = hv.frame_loglik_mix(
        _t(fr), tuple(map(_t, means)), tuple(map(_t, vars_)),
        tuple(map(_t, logws)), tuple(map(_t, msd_w)), sls, flags,
        wts).numpy()
    assert not kernels.launches
    assert got.shape == want.shape == (T, S)
    assert (np.abs(got - want) <= 1e-12 * np.maximum(1, np.abs(want))).all()
    # the floored component scores ~-1e8 (the other one carries its state)
    a0 = sts[0].sl.start
    q = (fr[:, a0] - means[0][1, 1, 0]) ** 2 / vars_[0][1, 1, 0]
    assert q.max() > 1e6


def test_align_utterance_mix_matches_jax(three_phones):
    """Ends equal and log-likelihoods within 1e-12 relative, per utterance
    and in the padded batches of `align_corpus_mix` (the ERST5 E-step),
    which gives each utterance's per-utterance result; an utterance shorter
    than its chain raises (per utterance) or comes back as the ValueError
    (in a corpus)."""
    utts, jms = three_phones
    jm = jhv.upmix(jms)
    pm = hv.upmix(_port(jms))
    short = (utts[0][0][:8], utts[0][1])
    batched = hv.align_corpus_mix(pm, utts + [short], **CPU)
    for (frames, seq), res in zip(utts, batched):
        lj, ej = jhv.align_utterance_mix(jm, frames, seq)
        lp, ep = hv.align_utterance_mix(pm, frames, seq, **CPU)
        np.testing.assert_array_equal(ep, ej)
        assert abs(lp - lj) <= 1e-12 * abs(lj)
        np.testing.assert_array_equal(res[1], ep)
        assert abs(res[0] - lp) <= 1e-12 * abs(lp)
    assert isinstance(batched[-1], ValueError)
    with pytest.raises(ValueError, match="infeasible"):
        hv.align_utterance_mix(pm, *short, **CPU)


def test_identical_components_match_single_gaussian(three_phones):
    """JAX's test_identical_components_match_single_gaussian on the port:
    a mixture of two identical halves aligns as the single Gaussian (the
    port's own `hsmm.align_utterance`), ll within JAX's 1e-6."""
    utts, jms = three_phones
    pms = _port(jms)
    mms = hv.upmix(pms, perturb=0.0)
    frames, seq = utts[0]
    ll1, ends1 = hsmm.align_utterance(pms, frames, seq, **CPU)
    ll2, ends2 = hv.align_utterance_mix(mms, frames, seq, **CPU)
    assert abs(ll1 - ll2) < 1e-6
    np.testing.assert_array_equal(ends1, ends2)


def test_responsibilities_match_jax(three_phones):
    """K33's posterior twin against JAX's `_responsibilities`, segment by
    segment of one stream, within 1e-12: frames of three rows in one call,
    one of whose rows has a component at the variance floor, whose
    posterior is then exactly 0 and the other's exactly 1."""
    utts, jms = three_phones
    jm = jhv.upmix(jms)
    st = jm.streams[0]
    mu = jm.means[st.name].reshape(-1, 2, 4).copy()
    va = jm.variances[st.name].reshape(-1, 2, 4).copy()
    lw = jm.mix_logw[st.name].reshape(-1, 2)
    va[4, 1, 0] = 1e-8
    frames = np.concatenate([u[0] for u in utts])[:, st.sl]
    rows = np.repeat([1, 4, 7], [30, 25, 20])
    x = frames[:75]
    got = hv.responsibilities(_t(x), _t(rows, torch.long), _t(mu), _t(va),
                              _t(lw)).numpy()
    for r in (1, 4, 7):
        want = jhv._responsibilities(x[rows == r], mu[r], va[r], lw[r])
        assert np.abs(got[rows == r] - want).max() <= 1e-12
    assert (got[rows == 4, 1] == 0.0).all()
    assert (got[rows == 4, 0] == 1.0).all()


@pytest.fixture(scope="module")
def bimodal():
    """JAX's ERST5 on the bimodal corpus, one iteration a call (four),
    each iteration's total log-likelihood taken as its E-step sums it (the
    alignments under the mixtures before the M-step); starts from JAX's own
    `upmix`."""
    utts = _bimodal_utts()
    ms = _one_model(utts, 2, 2)
    jm = jhv.upmix(ms)
    start = copy.deepcopy(jm)
    lls, logs = [], []
    for _ in range(4):
        lls.append(sum(jhv.align_utterance_mix(jm, f, s)[0] for f, s in utts))
        jhv.embedded_reestimate_mix(jm, utts, n_iters=1, log=logs.append)
    return utts, start, jm, lls, logs


def test_embedded_reestimate_mix_matches_jax(bimodal):
    """Four ERST5 iterations from JAX's own upmixed model, carried across:
    means, variances, log-weights, MSD weights and durations within 1e-9 of
    each array's largest magnitude; each iteration's total log-likelihood
    within 1e-10 relative, and the log lines equal."""
    utts, start, jm, lls, logs = bimodal
    pm = _carry_mix(start)
    got_logs = []
    for it in range(4):
        ll = sum(hv.align_utterance_mix(pm, f, s, **CPU)[0] for f, s in utts)
        assert abs(ll - lls[it]) <= 1e-10 * abs(lls[it])
        hv.embedded_reestimate_mix(pm, utts, n_iters=1, log=got_logs.append,
                                   **CPU)
    assert got_logs == logs
    for part in ("means", "variances", "mix_logw", "msd_weights"):
        for k, v in getattr(jm, part).items():
            _close(getattr(pm, part)[k], v, 1e-9)
    _close(pm.dur_mean, jm.dur_mean, 1e-9)
    _close(pm.dur_var, jm.dur_var, 1e-9)
    # the separation JAX's test asserts holds on the port's result too
    w = np.exp(pm.mix_logw["mgc"][0, 0])
    assert w.min() > 0.2


def test_generate_from_models_mix_equal(bimodal):
    """HMGenS on the mixtures: equal to JAX's on the same model."""
    _, _, jm, _, _ = bimodal
    want = jhv.generate_from_models_mix(jm, ["a", "a"], 1.3)
    got = hv.generate_from_models_mix(_carry_mix(jm), ["a", "a"], 1.3)
    for g, w in zip(got[:2], want[:2]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("d,G,frames", [
    (1, 6, None), (2, 140, None), (25, 200, None), (50, 200, None),
    (25, 1, 26)])
def test_semitied_block_matches_jax(d, G, frames):
    """K34's twin against JAX's `semitied_block`, 20 iterations, on
    `chip_smoke.semitied_inputs`: A within 1e-9 of max|A|, sigmas 1e-8
    relative, aux 1e-12 relative.  The last case is near-singular: one
    Gaussian of d + 1 frames (the fewest a key may have), so G_r is that
    scatter scaled, condition number ~5e4."""
    betas, scat = chip_smoke.semitied_inputs(d, G, 7 + d, frames)
    A, sig, aux = (np.asarray(a) for a in jhv.semitied_block(
        jnp.asarray(betas), jnp.asarray(scat), n_iter=20))
    got = hv.semitied_block(_t(betas), _t(scat), 20)
    Ap, sp, ap = (a.numpy() for a in got)
    _close(Ap, A, 1e-9)
    assert (np.abs(sp - sig) <= 1e-8 * sig).all()
    assert (np.abs(ap - aux) <= 1e-12 * np.abs(aux)).all()
    assert np.all(np.diff(ap) >= -1e-6 * np.abs(ap[:-1]) - 1e-8)


@pytest.mark.parametrize("n_blocks", [None, {"mgc": 2, "lf0": 2}])
def test_estimate_semitied_matches_jax(n_blocks):
    """SEMIT on the whitening corpus (three states of one model), at the
    default blocks and with mgc and lf0 in two blocks each (two jobs of one
    K34 launch): transforms within 1e-9 of max|A|, logdets 1e-9 absolute,
    means within 1e-9 and variances 1e-8 of each array's largest magnitude;
    the SEMIT log lines equal."""
    utts = _whitening_utts()
    jms = _one_model(utts, 3, 3)
    pms = _port(jms)
    jlog, plog = [], []
    js = jhv.estimate_semitied(copy.deepcopy(jms), utts, n_blocks=n_blocks,
                               n_iter=20, log=jlog.append)
    ps = hv.estimate_semitied(copy.deepcopy(pms), utts, n_blocks=n_blocks,
                              n_iter=20, log=plog.append, **CPU)
    assert plog == jlog
    assert ps.transforms.keys() == js.transforms.keys()
    for k, A in js.transforms.items():
        _close(ps.transforms[k], A, 1e-9)
        assert abs(ps.logdets[k] - js.logdets[k]) <= 1e-9
    for k in js.base.means:
        _close(ps.base.means[k], js.base.means[k], 1e-9)
        _close(ps.base.variances[k], js.base.variances[k], 1e-8)
    # the transformed space's likelihood, as JAX's test computes it
    tms = ps.transformed_modelset()
    f0, sq0 = utts[0]
    ll, ends = hsmm.align_utterance(tms, ps.transform_frames(f0), sq0, **CPU)
    jtms = js.transformed_modelset()
    jll, jends = jhsmm.align_utterance(jtms, js.transform_frames(f0), sq0)
    np.testing.assert_array_equal(ends, jends)
    assert abs(ll - jll) <= 1e-9 * abs(jll)
    assert ps.loglik_constant(len(f0)) == pytest.approx(
        js.loglik_constant(len(f0)), rel=1e-9, abs=1e-9)
