"""The plain twins of the HSMM kernels (K17-K20) against the JAX package,
on the CPU, and the kernels' arithmetic written out in numpy.

On the CPU each kernel wrapper runs its plain PyTorch twin; these tests
hold the twins against `hsmm.frame_loglik`, `hsmm.forward_backward_segment`,
`jax.ops.segment_sum` and `hsmm.viterbi_segment` on the same numpy inputs,
with the JAX side in float64 as its own tests run it.
`tests/test_torch_cuda.py` holds each CUDA kernel against its twin on the
card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu.models import hsmm as jhsmm
from hts_train_world_tpu_torch.models import hsmm, hsmm_batch

LOG_2PI = float(np.log(2.0 * np.pi))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _streams(kind):
    if kind == "world":
        return hsmm.world_streams()
    return (hsmm.StreamDef("mgc", slice(0, 4), False, 0, 1.0),
            hsmm.StreamDef("lf0", slice(4, 6), True, 4, 1.0),
            hsmm.StreamDef("bap", slice(6, 8), False, 6, 0.0),
            hsmm.StreamDef("vib", slice(8, 10), True, 8, 1.0))


def _loglik_inputs(kind, B=2, T=23, K=9, R=14, seed=0):
    """Frames with unvoiced (zero) MSD frames, random tables and row ids."""
    rng = np.random.default_rng(seed)
    sts = _streams(kind)
    D = sts[-1].sl.stop
    fr = rng.standard_normal((B, T, D))
    for st in sts:
        if st.msd:
            fr[:, ::3, st.sl] = 0.0
    means = [rng.standard_normal((R, st.sl.stop - st.sl.start))
             for st in sts]
    vars_ = [rng.uniform(0.05, 3.0, (R, st.sl.stop - st.sl.start))
             for st in sts]
    msd_w = [rng.uniform(0.0, 1.0, R) for _ in sts]
    msd_w[0][:2] = (0.0, 1.0)                     # clipped to [1e-4, 1-1e-4]
    rows = [rng.integers(0, R, (B, K)) for _ in sts]
    return sts, fr, means, vars_, msd_w, rows


@pytest.mark.parametrize("kind", ["world", "tiny"])
def test_k17_twin_matches_jax_frame_loglik(kind):
    sts, fr, means, vars_, msd_w, rows = _loglik_inputs(kind)
    args = hsmm.stream_args(sts)
    got = hsmm.batch_frame_loglik(_t(fr), tuple(_t(r, torch.long)
                                               for r in rows),
                                  tuple(map(_t, means)), tuple(map(_t, vars_)),
                                  tuple(map(_t, msd_w)), *args).numpy()
    for b in range(fr.shape[0]):
        want = np.asarray(jhsmm.frame_loglik(
            jnp.asarray(fr[b]), tuple(jnp.asarray(m[r[b]])
                                      for m, r in zip(means, rows)),
            tuple(jnp.asarray(v[r[b]]) for v, r in zip(vars_, rows)),
            tuple(jnp.asarray(w[r[b]]) for w, r in zip(msd_w, rows)),
            *args))
        assert np.abs(got[b] - want).max() <= 1e-12 * np.abs(want).max()


def test_k17_one_utterance_frame_loglik_matches_jax():
    sts, fr, means, vars_, msd_w, _ = _loglik_inputs("tiny", R=5)
    args = hsmm.stream_args(sts)
    w = [x if st.msd else np.zeros(5) for x, st in zip(msd_w, sts)]
    got = hsmm.frame_loglik(_t(fr[0]), tuple(map(_t, means)),
                            tuple(map(_t, vars_)), tuple(map(_t, w)), *args)
    want = jhsmm.frame_loglik(jnp.asarray(fr[0]),
                              tuple(map(jnp.asarray, means)),
                              tuple(map(jnp.asarray, vars_)),
                              tuple(map(jnp.asarray, w)), *args)
    assert np.abs(got.numpy() - np.asarray(want)).max() \
        <= 1e-12 * np.abs(np.asarray(want)).max()


def _k17_numpy(fr, means, vars_, msd_w, rows, sls, flags, wts):
    """K17's arithmetic as one thread runs it: per (b, k) and stream, the
    columns in order with 1/v, sum log v alongside, then the MSD switch
    and the weighted total over every stream (weight 0 included)."""
    B, T, _ = fr.shape
    K = rows[0].shape[1]
    out = np.zeros((B, T, K))
    for b in range(B):
        for k in range(K):
            total = np.zeros(T)
            for i, ((a, e), f, wt) in enumerate(zip(sls, flags, wts)):
                r = rows[i][b, k]
                q = np.zeros(T)
                slv = 0.0
                for j in range(e - a):
                    iv = 1.0 / vars_[i][r, j]
                    slv += np.log(vars_[i][r, j])
                    d = fr[b, :, a + j] - means[i][r, j]
                    q += d * d * iv
                ll = -0.5 * ((q + slv) + (e - a) * LOG_2PI)
                if f:
                    w = min(max(msd_w[i][r], 1e-4), 1.0 - 1e-4)
                    ll = np.where(fr[b, :, a] != 0.0, np.log(w) + ll,
                                  np.log1p(-w))
                total = total + wt * ll
            out[b, :, k] = total
    return out


def test_k17_arithmetic_in_numpy_matches_twin():
    sts, fr, means, vars_, msd_w, rows = _loglik_inputs("world", T=11, K=5)
    args = hsmm.stream_args(sts)
    want = hsmm.batch_frame_loglik_plain(
        _t(fr), tuple(_t(r, torch.long) for r in rows),
        tuple(map(_t, means)), tuple(map(_t, vars_)), tuple(map(_t, msd_w)),
        *args).numpy()
    got = _k17_numpy(fr, means, vars_, msd_w, rows, *args)
    assert np.all(np.abs(got - want) <= 1e-12 * (1 + np.abs(want)))


@pytest.mark.parametrize("what", [np.nan, np.inf])
def test_k17_twin_scores_a_non_finite_bap_frame_as_jax(what):
    """The weight-0 bap stream is scored as `total + 0.0 * ll`: a NaN or
    inf in its columns makes that frame's log-likelihoods NaN, as in the
    JAX package, and leaves every other frame as it was."""
    sts, fr, means, vars_, msd_w, rows = _loglik_inputs("world", T=9, K=4)
    bap = next(st for st in sts if st.name == "bap")
    fr[1, 4, bap.sl.start + 3] = what
    args = hsmm.stream_args(sts)
    got = hsmm.batch_frame_loglik(
        _t(fr), tuple(_t(r, torch.long) for r in rows),
        tuple(map(_t, means)), tuple(map(_t, vars_)), tuple(map(_t, msd_w)),
        *args).numpy()
    want = np.asarray(jhsmm.frame_loglik(
        jnp.asarray(fr[1]), tuple(jnp.asarray(m[r[1]])
                                  for m, r in zip(means, rows)),
        tuple(jnp.asarray(v[r[1]]) for v, r in zip(vars_, rows)),
        tuple(jnp.asarray(w[r[1]]) for w, r in zip(msd_w, rows)), *args))
    assert np.isnan(want[4]).all() and np.isnan(got[1, 4]).all()
    assert np.array_equal(np.isfinite(got[1]), np.isfinite(want))
    ok = np.isfinite(want)
    assert np.abs(got[1][ok] - want[ok]).max() \
        <= 1e-12 * np.abs(want[ok]).max()
    assert np.isfinite(got[0]).all()


def _fb_inputs(seed, B=3, T=60, S=10, scale=3.0):
    """A padded batch: per utterance its own t_len <= T and k_len <= S,
    garbage in the padding."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, T, S)) * scale
    dm = rng.uniform(3, 8, (B, S))
    dv = rng.uniform(1, 4, (B, S))
    t_len = np.array([T, T - 17, T - 5])[:B]
    k_len = np.array([S, S - 3, S - 1])[:B]
    return obs, dm, dv, t_len, k_len


@pytest.mark.parametrize("temper", [0.3, 1.0])
def test_k18_twin_matches_jax_forward_backward(temper):
    obs, dm, dv, t_len, k_len = _fb_inputs(1)
    ll, g, d = hsmm.segment_fb(_t(obs), _t(dm), _t(dv), 20, temper,
                               _t(t_len, torch.long), _t(k_len, torch.long))
    for b in range(len(obs)):
        l0, g0, d0 = jhsmm.forward_backward_segment(
            jnp.asarray(obs[b]), jnp.asarray(dm[b]), jnp.asarray(dv[b]), 20,
            temper, int(t_len[b]), int(k_len[b]))
        l0, g0, d0 = float(l0), np.asarray(g0), np.asarray(d0)
        assert abs(float(ll[b]) - l0) <= 1e-10 * abs(l0)
        assert np.abs(g[b].numpy() - g0).max() <= 1e-10
        assert np.all(np.abs(d[b].numpy() - d0) <= 1e-9 * np.abs(d0))


def test_k18_twin_padded_equals_unpadded():
    """The bounds of tests/test_hsmm_batch.py:43-62, on the port's twin."""
    rng = np.random.default_rng(0)
    T, S = 37, 6
    obs = rng.standard_normal((T, S)) * 2.0
    dm = rng.uniform(3, 8, S)
    dv = rng.uniform(1, 4, S)
    ll0, g0, d0 = hsmm.forward_backward_segment(_t(obs), _t(dm), _t(dv), 20)
    obsp = rng.standard_normal((T + 13, S + 3))
    obsp[:T, :S] = obs
    dmp = np.concatenate([dm, np.full(3, 5.0)])
    dvp = np.concatenate([dv, np.ones(3)])
    ll1, g1, d1 = hsmm.forward_backward_segment(_t(obsp), _t(dmp), _t(dvp),
                                                20, t_len=T, k_len=S)
    assert abs(float(ll0) - float(ll1)) < 1e-10
    assert (g0 - g1[:T, :S]).abs().max() < 1e-12
    assert (d0 - d1[:S]).abs().max() < 1e-10
    assert g1[T:, :].abs().max() < 1e-12
    assert d1[S:].abs().max() < 1e-12


def test_k18_infeasible_chain_is_log_zero_in_both():
    obs, dm, dv = np.zeros((5, 8)), np.full(8, 3.0), np.ones(8)
    ll = hsmm.forward_backward_segment(_t(obs), _t(dm), _t(dv), 10)[0]
    ll0 = jhsmm.forward_backward_segment(jnp.asarray(obs), jnp.asarray(dm),
                                         jnp.asarray(dv), 10)[0]
    assert float(ll) <= hsmm.LOG_ZERO / 2 and float(ll0) <= hsmm.LOG_ZERO / 2
    assert abs(float(ll) - float(ll0)) <= 1e-10 * abs(float(ll0))


def _k18_numpy(obs, dm, dv, Dm, temper, T_len, K_len):
    """K18's pull form for one utterance, written out in numpy in the
    kernel's loop order: sequential prefix sums, each forward destination
    pulling its sources (max from LOG_ZERO, then the exp-sum), the
    backward log-sum-exp over all max_dur terms (invalid ones at LOG_ZERO),
    per-state start-minus-end differences and their prefix sums."""
    NEG = hsmm.LOG_ZERO
    T, K = obs.shape
    cs = np.zeros((T + 1, K))
    for t in range(T):
        cs[t + 1] = cs[t] + obs[t] * temper
    d = np.arange(1, Dm + 1, dtype=float)
    dl = [-0.5 * (((d - dm[k]) * (d - dm[k])) / dv[k] + np.log(dv[k])
                  + LOG_2PI) * temper for k in range(K)]
    f0 = np.full(T + 1, NEG)
    f0[0] = 0.0
    F, f = [], f0
    for s in range(K):
        if s < K_len:
            fn = np.full(T + 1, NEG)
            for te in range(1, T_len + 1):
                c = [f[te - dd]
                     + (dl[s][dd - 1] + (cs[te, s] - cs[te - dd, s]))
                     for dd in range(min(Dm, te), 0, -1)]
                m = max([NEG] + c)
                acc = sum(np.exp(x - m) for x in c)
                if acc > 0:
                    fn[te] = np.log(max(acc, 1e-300)) + m
            f = fn
        F.append(f)
    bS = np.full(T + 1, NEG)
    bS[T_len] = 0.0
    Bs, bn = [None] * K, bS
    for s in range(K - 1, -1, -1):
        if s < K_len:
            bc = np.empty(T + 1)
            for t0 in range(T + 1):
                c = [(dl[s][dd - 1] + (cs[t0 + dd, s] - cs[t0, s]))
                     + bn[t0 + dd] if t0 + dd <= T_len else NEG
                     for dd in range(1, Dm + 1)]
                m = max(c)
                bc[t0] = np.log(sum(np.exp(x - m) for x in c)) + m
            bn = bc
        Bs[s] = bn
    logZ = Bs[0][0]
    gamma = np.zeros((T, K))
    dst = np.zeros((K, 3))
    for s in range(min(K, K_len)):
        fin = f0 if s == 0 else F[s - 1]
        bout = bS if s == K - 1 else Bs[s + 1]

        def p(t0, dd):
            te = t0 + dd
            xi = ((fin[t0] + (dl[s][dd - 1] + (cs[te, s] - cs[t0, s])))
                  + bout[te]) - logZ
            return np.exp(min(xi, 0.0))
        diff = np.zeros(T + 1)
        for t in range(T + 1):
            ps = [p(t, dd) for dd in range(1, Dm + 1) if t + dd <= T_len]
            diff[t] = sum(ps)
            dst[s] += [sum(ps), sum(x * dd for x, dd in zip(ps, d)),
                       sum(x * dd * dd for x, dd in zip(ps, d))]
            if t <= T_len:
                diff[t] -= sum(p(t - dd, dd)
                               for dd in range(min(Dm, t), 0, -1))
        gamma[:, s] = np.cumsum(diff)[:T]
    return logZ, gamma, dst


@pytest.mark.parametrize("temper", [0.3, 1.0])
def test_k18_pull_form_in_numpy_matches_twin(temper):
    obs, dm, dv, t_len, k_len = _fb_inputs(2, B=3, T=30, S=6)
    ll, g, d = hsmm.segment_fb_plain(_t(obs), _t(dm), _t(dv), 12, temper,
                                     _t(t_len, torch.long),
                                     _t(k_len, torch.long))
    for b in range(3):
        l0, g0, d0 = _k18_numpy(obs[b], dm[b], dv[b], 12, temper,
                                int(t_len[b]), int(k_len[b]))
        assert abs(float(ll[b]) - l0) <= 1e-12 * abs(l0)
        assert np.abs(g[b].numpy() - g0).max() <= 1e-12
        assert np.all(np.abs(d[b].numpy() - d0) <= 1e-12 * np.abs(d0))


@pytest.mark.parametrize("C", [1, 3, 41])
def test_k19_twin_matches_jax_segment_sum(C):
    rng = np.random.default_rng(C)
    N, R = 240, 17
    vals = rng.standard_normal((N, C)) * 10.0 ** rng.uniform(-3, 3, (N, 1))
    ids = rng.integers(0, R - 2, N)                   # two rows left empty
    got = hsmm_batch.segment_sum(_t(vals), _t(ids, torch.long), R).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(ids), R))
    scale = np.abs(vals).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    assert np.all(got[R - 2:] == 0.0)


def test_k19_twin_adds_in_ascending_order():
    """K19's contract: each row is the sum of its members in ascending
    index order from 0.0, which the CPU twin must equal bit for bit."""
    rng = np.random.default_rng(7)
    N, C, R = 500, 7, 11
    vals = rng.standard_normal((N, C)) * 10.0 ** rng.uniform(-8, 8, (N, 1))
    ids = rng.integers(0, R, N)
    want = np.zeros((R, C))
    for i in range(N):
        want[ids[i]] = want[ids[i]] + vals[i]
    got = hsmm_batch.segment_sum_plain(_t(vals), _t(ids, torch.long), R)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("R", [11, 1250])
def test_k19_twin_at_the_untied_row_count_matches_jax(R):
    """At 1250 rows (the untied clone's table size: 250 contexts x 5
    states) as at 11, the twin adds each row's members in ascending index
    order from 0.0, empty rows 0.0, and agrees with JAX's segment_sum."""
    rng = np.random.default_rng(R)
    N, C = 3 * R, 5
    vals = rng.standard_normal((N, C)) * 10.0 ** rng.uniform(-8, 8, (N, 1))
    ids = rng.integers(0, R - 3, N)
    want = np.zeros((R, C))
    for i in range(N):
        want[ids[i]] = want[ids[i]] + vals[i]
    twin = hsmm_batch.segment_sum(_t(vals), _t(ids, torch.long), R).numpy()
    assert np.array_equal(twin, want)
    assert np.all(twin[R - 3:] == 0.0)
    jx = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                        R))
    assert np.all(np.abs(twin - jx) <= 1e-12 * np.abs(vals).max())


def _vit_inputs(seed, B=3, T=70, S=12):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, T, S)) * 3.0
    dm = rng.uniform(2, 7, (B, S))
    dv = rng.uniform(1, 4, (B, S))
    t_len = np.array([T, T - 19, T - 6])[:B]
    k_len = np.array([S, S - 4, S - 1])[:B]
    return obs, dm, dv, t_len, k_len


def test_k20_twin_matches_jax_viterbi_segment():
    obs, dm, dv, t_len, k_len = _vit_inputs(20)
    ll, ends = hsmm.viterbi_segment_batch(
        _t(obs), _t(dm), _t(dv), _t(t_len, torch.long),
        _t(k_len, torch.long), 15)
    for b in range(3):
        T, S = int(t_len[b]), int(k_len[b])
        ll0, e0 = jhsmm.viterbi_segment(jnp.asarray(obs[b, :T, :S]),
                                        jnp.asarray(dm[b, :S]),
                                        jnp.asarray(dv[b, :S]), 15)
        assert np.array_equal(ends[b, :S].numpy(), np.asarray(e0))
        assert np.all(ends[b, S:].numpy() == 0)
        assert abs(float(ll[b]) - float(ll0)) <= 1e-9 * abs(float(ll0))


def test_k20_twin_breaks_a_forced_tie_as_jax():
    """Zero log-likelihoods and duration means of 2.5: (2, 3) and (3, 2)
    score exactly alike, and both take the smaller d at the end."""
    obs = np.zeros((1, 5, 2))
    dm = np.full((1, 2), 2.5)
    dv = np.full((1, 2), 1.5)
    ll, ends = hsmm.viterbi_segment_batch(_t(obs), _t(dm), _t(dv),
                                          _t([5], torch.long),
                                          _t([2], torch.long), 4)
    ll0, e0 = jhsmm.viterbi_segment(jnp.asarray(obs[0]), jnp.asarray(dm[0]),
                                    jnp.asarray(dv[0]), 4)
    assert np.array_equal(np.asarray(e0), [3, 5])
    assert np.array_equal(ends[0].numpy(), [3, 5])
    assert float(ll[0]) == float(ll0)


def test_k20_twin_padded_equals_unpadded():
    obs, dm, dv, t_len, k_len = _vit_inputs(21)
    obs[1, t_len[1]:] = 1e6          # garbage in the padding
    obs[1, :, k_len[1]:] = -1e6
    dm[1, k_len[1]:] = 0.1
    ll, ends = hsmm.viterbi_segment_batch(
        _t(obs), _t(dm), _t(dv), _t(t_len, torch.long),
        _t(k_len, torch.long), 15)
    T, S = int(t_len[1]), int(k_len[1])
    l1, e1 = hsmm.viterbi_segment(_t(obs[1, :T, :S]), _t(dm[1, :S]),
                                  _t(dv[1, :S]), 15)
    assert float(l1) == float(ll[1])
    assert np.array_equal(e1.numpy(), ends[1, :S].numpy())


def _k20_numpy(obs, dm, dv, Dm):
    """K20's arithmetic as the kernel runs it: sequential prefix sums, per
    destination the d = 1..Dm terms in order with out-of-range ones
    exactly LOG_ZERO, a strict > for the max, one walk back."""
    T, S = obs.shape
    NEG = hsmm.LOG_ZERO
    cs = np.zeros((T + 1, S))
    for t in range(T):
        cs[t + 1] = cs[t] + obs[t]
    delta = np.full(T + 1, NEG)
    delta[0] = 0.0
    bp = np.zeros((S, T + 1), np.int64)
    for s in range(S):
        dl = [-0.5 * (((d - dm[s]) * (d - dm[s])) / dv[s] + np.log(dv[s])
                      + LOG_2PI) for d in range(1, Dm + 1)]
        nxt = np.empty(T + 1)
        for t in range(T + 1):
            best, arg = 0.0, 0
            for d in range(1, Dm + 1):
                c = ((delta[t - d] + dl[d - 1]) + (cs[t, s] - cs[t - d, s])
                     if t - d >= 0 else NEG)
                if d == 1 or c > best:
                    best, arg = c, d - 1
            nxt[t], bp[s, t] = best, arg
        delta = nxt
    ends, te = [], T
    for s in range(S - 1, -1, -1):
        ends.append(te)
        te -= bp[s, te] + 1
    return delta[T], ends[::-1]


def test_k20_arithmetic_in_numpy_matches_twin():
    obs, dm, dv, _, _ = _vit_inputs(22, B=1, T=40, S=6)
    ll, ends = hsmm.viterbi_segment(_t(obs[0]), _t(dm[0]), _t(dv[0]), 12)
    l0, e0 = _k20_numpy(obs[0], dm[0], dv[0], 12)
    assert list(ends.numpy()) == e0
    assert abs(float(ll) - l0) <= 1e-12 * abs(l0)
