"""The port's HSMM EM (models/hsmm.py, models/hsmm_batch.py) against the
JAX package, on the CPU, in float64.

The same numpy corpus and model set go through both packages: the JAX
`ModelSet` becomes the port's through `modelset_from_numpy`, and the
port's parameters come back through `ModelSet.to_numpy`.  The entry points
default to the card and raise without one; here they run with
`device="cpu"`, where each kernel (K17-K19) runs its plain twin.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_hsmm as th
from tests.test_hsmm_batch import _boot_modelset, _utts
from hts_train_world_tpu.features.compose import StreamLayout as JLayout
from hts_train_world_tpu.models import hsmm as jhsmm
from hts_train_world_tpu.models import hsmm_batch as jbatch
from hts_train_world_tpu_torch.features.compose import StreamLayout
from hts_train_world_tpu_torch.models import hsmm, hsmm_batch

CPU = dict(device="cpu")


def _quiet(_):
    pass


def _port(jms):
    """The JAX package's ModelSet as the port's (copied arrays)."""
    return hsmm.modelset_from_numpy(
        jms.names, jms.means, jms.variances, jms.msd_weights, jms.dur_mean,
        jms.dur_var, [(s.name, s.sl.start, s.sl.stop, s.msd, s.msd_flag_col,
                       s.weight) for s in jms.streams])


def _assert_same_params(jms, pms, tol=1e-8):
    names, means, variances, msd_w, dur_mean, dur_var, _ = pms.to_numpy()
    assert names == jms.names
    for n in jms.means:
        assert np.abs(jms.means[n] - means[n]).max() < tol
        assert np.abs(jms.variances[n] - variances[n]).max() < tol
    for n in jms.msd_weights:
        assert np.abs(jms.msd_weights[n] - msd_w[n]).max() < tol
    assert np.abs(jms.dur_mean - dur_mean).max() < tol
    assert np.abs(jms.dur_var - dur_var).max() < tol


@pytest.fixture(scope="module")
def corpus():
    utts = _utts(np.random.default_rng(1))
    return utts, _boot_modelset(utts)


def test_streams_and_layout_match_jax():
    assert StreamLayout().cmp_dim == JLayout().cmp_dim == 237
    assert StreamLayout().cmp_slices() == JLayout().cmp_slices()
    got = [(s.name, s.sl, s.msd, s.msd_flag_col, s.weight)
           for s in hsmm.world_streams()]
    want = [(s.name, s.sl, s.msd, s.msd_flag_col, s.weight)
            for s in jhsmm.world_streams()]
    assert got == want


def test_modelset_round_trips(corpus):
    _, jms = corpus
    pms = _port(jms)
    again = hsmm.modelset_from_numpy(*pms.to_numpy())
    _assert_same_params(jms, again, tol=1e-300)
    assert [(s.name, s.sl, s.msd, s.msd_flag_col, s.weight)
            for s in again.streams] == [
        (s.name, s.sl, s.msd, s.msd_flag_col, s.weight) for s in jms.streams]
    pms.means["mgc"][0, 0, 0] += 1.0          # copies, not views
    assert again.means["mgc"][0, 0, 0] == jms.means["mgc"][0, 0, 0]
    assert pms.n_states == jms.n_states and pms.index("b") == jms.index("b")


def test_init_modelset_matches_jax():
    rng = np.random.default_rng(4)
    utts = _utts(rng, n=4)
    fbm = {n: [] for n in th.names_all}
    for frames, seq in utts:
        for i, n in enumerate(seq):
            fbm[n].append(frames[i * 5:(i + 1) * 5 + 3])
    jms = jhsmm.init_modelset(th.names_all, fbm, th._tiny_streams(), 3)
    pms = hsmm.init_modelset(th.names_all, fbm, _port(jms).streams, 3)
    _assert_same_params(jms, pms, tol=1e-300)


def test_chain_loglik_and_occupancy_match_jax(corpus):
    utts, jms = corpus
    pms = _port(jms)
    frames, seq = utts[0]
    o, dm, dv = hsmm.chain_loglik(pms, frames, seq, **CPU)
    o0, dm0, dv0 = jhsmm.chain_loglik(jms, frames, seq)
    o0 = np.asarray(o0)
    assert np.abs(o.numpy() - o0).max() <= 1e-12 * np.abs(o0).max()
    assert np.array_equal(dm.numpy(), np.asarray(dm0))
    assert np.array_equal(dv.numpy(), np.asarray(dv0))
    for temper in (0.3, 1.0):
        ll, g, d = hsmm.occupancy_utterance(pms, frames, seq, 40, temper,
                                            **CPU)
        ll0, g0, d0 = jhsmm.occupancy_utterance(jms, frames, seq, 40, temper)
        assert abs(ll - ll0) <= 1e-10 * abs(ll0)
        assert np.abs(g - g0).max() <= 1e-10
        assert np.all(np.abs(d - d0) <= 1e-9 * np.abs(d0))


@pytest.mark.parametrize("i", [0, 3, 5])
def test_viterbi_and_align_match_jax(corpus, i):
    utts, jms = corpus
    frames, seq = utts[i]
    ll, ends = hsmm.align_utterance(_port(jms), frames, seq, **CPU)
    ll0, ends0 = jhsmm.align_utterance(jms, frames, seq)
    assert np.array_equal(ends, ends0)
    assert abs(ll - ll0) <= 1e-9 * abs(ll0)


def test_viterbi_segment_matches_jax():
    rng = np.random.default_rng(5)
    T, S = 50, 7
    obs = rng.standard_normal((T, S)) * 3.0
    dm, dv = rng.uniform(3, 9, S), rng.uniform(1, 5, S)
    ll, ends = hsmm.viterbi_segment(torch.as_tensor(obs), torch.as_tensor(dm),
                                    torch.as_tensor(dv), 20)
    ll0, ends0 = jhsmm.viterbi_segment(jnp.asarray(obs), jnp.asarray(dm),
                                       jnp.asarray(dv), 20)
    assert np.array_equal(ends.numpy(), np.asarray(ends0))
    assert abs(float(ll) - float(ll0)) <= 1e-9 * abs(float(ll0))


def test_align_rejects_infeasible_utterance(corpus):
    utts, jms = corpus
    frames, seq = utts[0]
    short = frames[:len(seq) * jms.n_states - 1]
    with pytest.raises(ValueError, match="infeasible"):
        hsmm.align_utterance(_port(jms), short, seq, **CPU)
    with pytest.raises(ValueError, match="infeasible"):
        jhsmm.align_utterance(jms, short, seq)


def _chained(jms, utts):
    S = jms.n_states
    out = []
    for f, seq in utts:
        r = jbatch.chain_rows_modelset(jms, seq)
        out.append((np.asarray(f, float), r))
    M = len(jms.names)
    return out, M * S


def test_bucketing_and_padding_match_jax(corpus):
    utts, jms = corpus
    for n in (1, 7, 8, 9, 50, 113, 1000):
        for align in (4, 8, 16):
            assert hsmm_batch._bucket(n, 1.26, align) == \
                jbatch._bucket(n, 1.26, align)
    for f, seq in utts:
        assert np.array_equal(hsmm_batch.chain_rows_modelset(_port(jms), seq),
                              jbatch.chain_rows_modelset(jms, seq))
    names = [st.name for st in jms.streams]
    grp_p = [hsmm_batch.ChainedUtterance(f, {n: r for n in names}, r)
             for f, r in _chained(jms, utts)[0][:3]]
    grp_j = [jbatch.ChainedUtterance(f, {n: r for n in names}, r)
             for f, r in _chained(jms, utts)[0][:3]]
    a = hsmm_batch._pad_group(grp_p, 96, 16, 10, names, batch_pad=4)
    b = jbatch._pad_group(grp_j, 96, 16, 10, names, batch_pad=4)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert all(np.array_equal(x[k], y[k]) for k in x)
        else:
            assert np.array_equal(x, y) and x.dtype == y.dtype


def _estep_pair(jms, utts, temper=1.0):
    names = [st.name for st in jms.streams]
    ch, R = _chained(jms, utts)
    n_rows = {n: R for n in names}
    acc_j = jbatch.corpus_estep(
        jbatch.tables_from_modelset(jms),
        [jbatch.ChainedUtterance(f, {n: r for n in names}, r)
         for f, r in ch], n_rows, R, 40, temper)
    pms = _port(jms)
    acc_p = hsmm_batch.corpus_estep(
        hsmm_batch.tables_from_modelset(pms),
        [hsmm_batch.ChainedUtterance(f, {n: r for n in names}, r)
         for f, r in ch], n_rows, R, 40, temper, **CPU)
    return acc_j, acc_p


@pytest.mark.parametrize("temper", [0.3, 1.0])
def test_corpus_estep_accumulators_match_jax(corpus, temper):
    utts, jms = corpus
    acc_j, acc_p = _estep_pair(jms, utts, temper)
    assert abs(acc_p.total_ll - acc_j.total_ll) <= 1e-9 * abs(acc_j.total_ll)
    assert acc_p.n_ok == acc_j.n_ok == len(utts)
    for sj, sp in zip(acc_j.streams, acc_p.streams):
        assert set(sj) == set(sp)
        for k in sj:
            want = np.asarray(sj[k])
            assert np.all(np.abs(sp[k] - want) <= 1e-9 * np.abs(want)
                          + 1e-12 * np.abs(want).max())
    dj = np.asarray(acc_j.dur)
    assert np.all(np.abs(acc_p.dur - dj) <= 1e-9 * np.abs(dj)
                  + 1e-12 * np.abs(dj).max())


def test_bucket_estep_matches_jax(corpus):
    """One padded batch (batch padding included) through both packages'
    `_bucket_estep`."""
    utts, jms = corpus
    names = [st.name for st in jms.streams]
    ch, R = _chained(jms, utts)
    grp = [jbatch.ChainedUtterance(f, {n: r for n in names}, r)
           for f, r in ch]
    Tb = jbatch._bucket(max(len(f) for f, _ in ch), 1.26, 16)
    Kb = jbatch._bucket(max(len(r) for _, r in ch), 1.26, 4)
    fr, rows, dr, tl, kl, w = jbatch._pad_group(grp, Tb, Kb, 10, names,
                                                batch_pad=8)
    tab = jbatch.tables_from_modelset(jms)
    sls, flags, wts = hsmm.stream_args(jms.streams)
    msd = [tab.msd_w[n] if f else np.zeros(1) for n, f in zip(names, flags)]
    ll0, ok0, out0, dur0 = jbatch._bucket_estep(
        jnp.asarray(fr), tuple(jnp.asarray(rows[n]) for n in names),
        jnp.asarray(dr), jnp.asarray(tl), jnp.asarray(kl), jnp.asarray(w),
        tuple(jnp.asarray(tab.means[n]) for n in names),
        tuple(jnp.asarray(tab.vars[n]) for n in names),
        tuple(map(jnp.asarray, msd)), jnp.asarray(tab.dur_mean),
        jnp.asarray(tab.dur_var), sls, flags, wts, 40, (R,) * 4, R)

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dt)
    ll, ok, out, dur = hsmm_batch._bucket_estep(
        t(fr), tuple(t(rows[n], torch.long) for n in names),
        t(dr, torch.long), t(tl, torch.long), t(kl, torch.long), t(w),
        tuple(t(tab.means[n]) for n in names),
        tuple(t(tab.vars[n]) for n in names), tuple(map(t, msd)),
        t(tab.dur_mean), t(tab.dur_var), sls, flags, wts, 40, (R,) * 4, R)
    assert float(ok) == float(ok0) == len(utts)
    assert abs(float(ll) - float(ll0)) <= 1e-9 * abs(float(ll0))
    for a, b in zip(out, out0):
        assert set(a) == set(b)
        for k in a:
            want = np.asarray(b[k])
            assert np.abs(a[k].numpy() - want).max() \
                <= 1e-9 * np.abs(want).max()
    assert np.abs(dur.numpy() - np.asarray(dur0)).max() \
        <= 1e-9 * np.abs(np.asarray(dur0)).max()


def test_infeasible_utterance_is_dropped_like_jax(corpus):
    utts, jms = corpus
    frames, seq = utts[0]
    bad = [(frames[:len(seq) * jms.n_states - 2], seq)]
    acc_j, acc_p = _estep_pair(jms, utts[1:4] + bad + utts[4:5])
    assert acc_p.n_ok == acc_j.n_ok == 4
    assert abs(acc_p.total_ll - acc_j.total_ll) <= 1e-9 * abs(acc_j.total_ll)


def test_mstep_modelset_matches_jax(corpus):
    utts, jms = corpus
    acc_j, acc_p = _estep_pair(jms, utts)
    floor = np.full(10, 1e-3)
    want = jbatch.mstep_modelset(copy.deepcopy(jms), acc_j, floor)
    got = hsmm_batch.mstep_modelset(_port(jms), acc_p, floor)
    _assert_same_params(want, got, tol=1e-10)


def test_reestimate_modelset_batched_matches_jax(corpus):
    utts, jms0 = corpus
    jms = copy.deepcopy(jms0)
    pms = _port(jms0)
    hist_j = jbatch.reestimate_modelset_batched(jms, utts, n_iters=2,
                                                log=_quiet)
    hist_p = hsmm_batch.reestimate_modelset_batched(pms, utts, n_iters=2,
                                                    log=_quiet, **CPU)
    _assert_same_params(jms, pms)
    assert np.allclose(hist_p, hist_j, rtol=1e-9, atol=0)


@pytest.mark.parametrize("mode", ["viterbi", "baum_welch"])
def test_embedded_reestimate_matches_jax(corpus, mode):
    utts, jms0 = corpus
    jms = copy.deepcopy(jms0)
    pms = _port(jms0)
    jhsmm.embedded_reestimate(jms, utts, n_iters=2, mode=mode, log=_quiet)
    hsmm.embedded_reestimate(pms, utts, n_iters=2, mode=mode, log=_quiet,
                             **CPU)
    _assert_same_params(jms, pms)


@pytest.mark.parametrize("batched", [False, True])
def test_daem_reestimate_matches_jax(corpus, batched):
    utts, jms0 = corpus
    jms = copy.deepcopy(jms0)
    pms = _port(jms0)
    jhsmm.daem_reestimate(jms, utts, n_outer=2, log=_quiet, batched=batched)
    hsmm.daem_reestimate(pms, utts, n_outer=2, log=_quiet, batched=batched,
                         **CPU)
    _assert_same_params(jms, pms)


def test_unknown_mode_raises(corpus):
    utts, jms = corpus
    with pytest.raises(ValueError, match="unknown mode"):
        hsmm.embedded_reestimate(_port(jms), utts, mode="hard", **CPU)


def test_entry_points_raise_without_cuda(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    utts, jms = corpus
    pms = _port(jms)
    frames, seq = utts[0]
    names = [st.name for st in pms.streams]
    calls = [
        lambda: hsmm_batch.reestimate_modelset_batched(pms, utts, 1,
                                                       log=_quiet),
        lambda: hsmm.embedded_reestimate(pms, utts, 1, log=_quiet),
        lambda: hsmm.daem_reestimate(pms, utts, 1, log=_quiet),
        lambda: hsmm.align_utterance(pms, frames, seq),
        lambda: hsmm.occupancy_utterance(pms, frames, seq),
        lambda: hsmm.chain_loglik(pms, frames, seq),
        lambda: hsmm_batch.corpus_estep(
            hsmm_batch.tables_from_modelset(pms),
            [hsmm_batch.ChainedUtterance(frames, {n: np.zeros(3, int)
                                                  for n in names},
                                         np.zeros(3, int))],
            {n: 9 for n in names}, 9),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
