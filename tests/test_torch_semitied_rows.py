"""K34 at a full transform and K33's row tables, on the CPU, in float64,
against the JAX package.

- K34's twin at a 150 x 150 block (mgc's full transform, the reference's
  NMGCTRANSBLK = 1) against JAX's `semitied_block`, and
  `estimate_semitied(n_blocks={"mgc": 1})` against JAX's on a corpus whose
  mgc stream is 24 wide (three delta windows of 8), at the bounds of
  tests/test_torch_hsmm_variants.py: A within 1e-9 of max|A|, sigmas 1e-8
  relative, aux 1e-12 relative, logdets 1e-9;
- `semitied_gr_plain`, the plain form of K34's G_r stage (every row's G_r
  of an outer step in one product), against the twin's per-row einsum;
- K33's row prologue twin (`mix_rows_plain`) and the buffer the card's
  wrapper lays out (`_mix_row_tables`), put back into log-likelihoods in
  plain torch, against JAX's `frame_loglik_mix` within 1e-12 (1 + |ll|).
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
from hts_train_world_tpu_torch.models import hsmm
from hts_train_world_tpu_torch.models import hsmm_variants as hv

f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as tests/test_torch_hsmm_variants.py: the
    twins run many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=f64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-300)


def test_semitied_twin_matches_jax_at_a_full_mgc_block():
    """d = 150 (mgc's 50 coefficients with their deltas in one block), 48
    Gaussians, 3 iterations, on `chip_smoke.semitied_inputs`."""
    betas, scat = chip_smoke.semitied_inputs(150, 48, 157)
    A, sig, aux = (np.asarray(a) for a in jhv.semitied_block(
        jnp.asarray(betas), jnp.asarray(scat), n_iter=3))
    Ap, sp, ap = (a.numpy() for a in hv.semitied_block(_t(betas), _t(scat),
                                                        3))
    _close(Ap, A, 1e-9)
    assert (np.abs(sp - sig) <= 1e-8 * sig).all()
    assert (np.abs(ap - aux) <= 1e-12 * np.abs(aux)).all()


def _wide_streams(mod):
    """mgc 24 (three windows of 8) | lf0 3 (MSD) | bap 3 (weight 0)."""
    return (mod.StreamDef("mgc", slice(0, 24), False, 0, 1.0),
            mod.StreamDef("lf0", slice(24, 27), True, 24, 1.0),
            mod.StreamDef("bap", slice(27, 30), False, 27, 0.0))


def _wide_utts(seed: int = 24):
    """Eight utterances of one model's three states, each state's mgc
    drawn through one mixing matrix shared by the states, lf0 voiced on
    five frames of six."""
    rng = np.random.default_rng(seed)
    L = np.eye(24) + 0.3 * rng.standard_normal((24, 24))
    mus = rng.standard_normal((3, 24)) * 2.0
    utts = []
    for _ in range(8):
        fr = []
        for s in range(3):
            d = 14 + int(rng.integers(0, 5))
            z = rng.standard_normal((d, 24)) * rng.uniform(0.3, 2.0, 24)
            f = np.zeros((d, 30))
            f[:, :24] = mus[s] + z @ L.T
            f[:, 24:27] = 5.0 + 0.1 * rng.standard_normal((d, 3))
            f[::6, 24:27] = 0.0
            f[:, 27:30] = 0.2 * rng.standard_normal((d, 3))
            fr.append(f)
        utts.append((np.concatenate(fr), ["a"]))
    return utts


def test_estimate_semitied_full_mgc_matches_jax():
    """SEMIT with mgc in one block (`n_blocks={"mgc": 1}`, a 24 x 24
    transform) and the other streams at their defaults: transforms within
    1e-9 of max|A|, logdets 1e-9 absolute, means 1e-9 and variances 1e-8 of
    each array's largest magnitude, the SEMIT log lines equal."""
    utts = _wide_utts()
    jms = jhsmm.init_modelset(["a"], {"a": [u[0] for u in utts]},
                              _wide_streams(jhsmm), n_states=3)
    jms = jhsmm.embedded_reestimate(jms, utts, n_iters=2, log=lambda m: None)
    pms = _port(jms)
    jlog, plog = [], []
    js = jhv.estimate_semitied(copy.deepcopy(jms), utts,
                               n_blocks={"mgc": 1}, n_iter=20,
                               log=jlog.append)
    ps = hv.estimate_semitied(copy.deepcopy(pms), utts, n_blocks={"mgc": 1},
                              n_iter=20, log=plog.append, device="cpu")
    assert plog == jlog
    assert ps.transforms.keys() == js.transforms.keys()
    assert ps.transforms["mgc"].shape == (24, 24)
    assert np.abs(ps.transforms["mgc"][:8, 8:]).max() > 1e-3  # one block
    for k, A in js.transforms.items():
        _close(ps.transforms[k], A, 1e-9)
        assert abs(ps.logdets[k] - js.logdets[k]) <= 1e-9
    for k in js.base.means:
        _close(ps.base.means[k], js.base.means[k], 1e-9)
        _close(ps.base.variances[k], js.base.variances[k], 1e-8)


@pytest.mark.parametrize("J,G,d", [(3, 161, 12), (1, 7, 30), (2, 1, 1)])
def test_semitied_gr_plain_equals_the_twins_rows(J, G, d):
    """Every row's G_r in one product against the twin's einsum for that
    row alone, within 1e-13 of each G_r's largest magnitude (two BLAS
    orders of the same sum over g)."""
    rng = np.random.default_rng(d)
    betas = _t(rng.uniform(10.0, 500.0, G))
    scat = _t(np.stack([chip_smoke.semitied_inputs(d, G, 3 + j)[1]
                        for j in range(J)]))
    sig = _t(rng.uniform(0.1, 4.0, (J, G, d)))
    got = hv.semitied_gr_plain(betas, scat, sig)
    assert got.shape == (J, d, d, d)
    for j in range(J):
        for r in range(d):
            want = torch.einsum("g,gij->ij", betas / sig[j, :, r], scat[j])
            assert float((got[j, r] - want).abs().max()) <= \
                1e-13 * float(want.abs().max())


def _mixture(rng, streams, R, C):
    """Per stream (R, C, D_s) means and variances (row 1's second
    component at the variance floor 1e-8), (R, C) log-weights and (R,) MSD
    weights (row 2's outside [1e-4, 1 - 1e-4])."""
    out = []
    for st in streams:
        D = st.sl.stop - st.sl.start
        v = rng.uniform(0.05, 3.0, (R, C, D))
        v[1, min(1, C - 1), 0] = 1e-8
        w = rng.uniform(0.1, 1.0, (R, C))
        mw = rng.uniform(0.0, 1.0, R)
        mw[2] = 1.0
        out.append((rng.standard_normal((R, C, D)), v,
                    np.log(w / w.sum(1, keepdims=True)), mw))
    return [tuple(o[i] for o in out) for i in range(4)]


def _ll_from_rows(fr, rows, tabs, sls, flags, wts):
    """The chain log-likelihoods from the row prologue's tables, in plain
    torch: (T, D) frames against every row (R rows) -> (T, R)."""
    total = 0.0
    for (rv, slv, lw, ml, m1, mu, v), (a, e), f, wt in zip(tabs, sls, flags,
                                                           wts):
        x = fr[:, None, None, a:e]
        dd = (x - mu[rows][None]) ** 2
        q = torch.where(torch.isnan(rv[rows])[None], dd / v[rows][None],
                        dd * rv[rows][None]).sum(-1)
        z = lw[rows][None] + -0.5 * ((q + slv[rows][None]) + (e - a)
                                     * hsmm.LOG_2PI)
        ll = hv._logsumexp(z)
        if f:
            ll = torch.where((fr[:, a] != 0.0)[:, None], ml[rows][None] + ll,
                             m1[rows][None])
        total = total + wt * ll
    return total


@pytest.mark.parametrize("streams,C", [("world", 2), ("tiny", 3),
                                       ("tiny", 8)])
def test_k33_row_tables_match_jax(streams, C):
    """K33's row prologue twin, and the same tables read back from the
    buffer `_mix_row_tables` lays out (offsets from its meta, the (mu, v)
    pairs at even offsets), put back into log-likelihoods: within 1e-12
    (1 + |ll|) of JAX's `frame_loglik_mix`, with unvoiced MSD frames and a
    component at the variance floor."""
    jsts = th._tiny_streams() if streams == "tiny" else \
        jhsmm.world_streams()
    sts = hsmm.world_streams() if streams == "world" else tuple(
        hsmm.StreamDef(s.name, s.sl, s.msd, s.msd_flag_col, s.weight)
        for s in jsts)
    rng = np.random.default_rng(33 + C)
    D, R, T = sts[-1].sl.stop, 5, 11
    fr = rng.standard_normal((T, D))
    for st in sts:
        if st.msd:
            fr[::3, st.sl] = 0.0
    means, vars_, logws, msd_w = _mixture(rng, sts, R, C)
    sls, flags, wts = hsmm.stream_args(sts)
    want = np.asarray(jhv.frame_loglik_mix(
        jnp.asarray(fr), tuple(map(jnp.asarray, means)),
        tuple(map(jnp.asarray, vars_)), tuple(map(jnp.asarray, logws)),
        tuple(map(jnp.asarray, msd_w)), sls, flags, wts))
    m_t, v_t, lw_t, w_t = (tuple(map(_t, x))
                           for x in (means, vars_, logws, msd_w))
    plain = hv.mix_rows_plain(m_t, v_t, lw_t, w_t, flags)
    rows = torch.arange(R)
    lim = 1e-12 * (1.0 + np.abs(want))
    got = _ll_from_rows(_t(fr), rows, [p + (m, v) for p, m, v in
                                       zip(plain, m_t, v_t)], sls, flags,
                        wts).numpy()
    assert (np.abs(got - want) <= lim).all()
    # the card's buffer: the wrapper's layout, filled as the prologue does
    buf, meta, wts_c, entry = hv._mix_row_tables(m_t, v_t, lw_t, w_t, sls,
                                                 flags, wts)
    assert entry is not None and list(wts_c) == list(wts)
    meta = np.asarray(list(meta)).reshape(len(sts), 10)
    read = []
    for (a, e, f, Rs, o_mv, o_rv, o_slv, o_lw, o_ml, o_m1), p in zip(
            meta, plain):
        n = Rs * C * (e - a)
        assert o_mv % 2 == 0
        mv = buf[o_mv:o_mv + 2 * n].view(Rs, C, e - a, 2)
        buf[o_rv:o_rv + n] = p[0].reshape(-1)
        buf[o_slv:o_slv + Rs * C] = p[1].reshape(-1)
        if f:
            assert torch.equal(buf[o_ml:o_ml + Rs], w_t[len(read)])
            buf[o_ml:o_ml + Rs] = p[3]
            buf[o_m1:o_m1 + Rs] = p[4]
        read.append((buf[o_rv:o_rv + n].view(Rs, C, e - a),
                     buf[o_slv:o_slv + Rs * C].view(Rs, C),
                     buf[o_lw:o_lw + Rs * C].view(Rs, C),
                     buf[o_ml:o_ml + Rs], buf[o_m1:o_m1 + Rs],
                     mv[..., 0], mv[..., 1]))
    got_b = _ll_from_rows(_t(fr), rows, read, sls, flags, wts).numpy()
    np.testing.assert_array_equal(got_b, got)
