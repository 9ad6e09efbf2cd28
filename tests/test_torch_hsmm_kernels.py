"""The plain twins of the HSMM kernels (K17-K19) against the JAX package,
on the CPU, and the kernels' arithmetic written out in numpy.

On the CPU each kernel wrapper runs its plain PyTorch twin; these tests
hold the twins against `hsmm.frame_loglik`, `hsmm.forward_backward_segment`
and `jax.ops.segment_sum` on the same numpy inputs, with the JAX side in
float64 as its own tests run it.  `tests/test_torch_cuda.py` holds each
CUDA kernel against its twin on the card.
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
    and the weighted total; weight-0 streams skipped."""
    B, T, _ = fr.shape
    K = rows[0].shape[1]
    out = np.zeros((B, T, K))
    for b in range(B):
        for k in range(K):
            total = np.zeros(T)
            for i, ((a, e), f, wt) in enumerate(zip(sls, flags, wts)):
                if wt == 0.0:
                    continue
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
