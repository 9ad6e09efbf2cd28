"""The plain twins of the feature path's kernels (K5-K8) against the JAX
package, on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch twin; these tests
hold the twins against the JAX functions on the same numpy inputs.
`tests/test_torch_cuda.py` holds each CUDA kernel against its twin on the
card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import cli as jcli
from hts_train_world_tpu.features import windows as jwin
from hts_train_world_tpu.ops import dio as jdio
from hts_train_world_tpu.ops import mlpg as jmlpg
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.features import encode, windows
from hts_train_world_tpu_torch.ops import dio, mlpg


# ---------------------------------------------------------------------------
# K5: DIO band candidates
# ---------------------------------------------------------------------------


def _band_rows(plan, B, seed):
    """Filtered-band rows (B, bands, fft_size): a clean tone at 3/4 of
    each band's boundary F0 (noise on a tone makes extra crossings of the
    diff streams near its peaks, whose interval jumps the f32 cumsum
    anchors of both formulations then carry in different summation
    orders); in utterance 1 wideband noise over the last 30%,
    whose crossings overrun every band cap; utterance 2 silent."""
    rng = np.random.default_rng(seed)
    L, fs = plan["y_length"], plan["actual_fs"]
    rows = np.zeros((B, len(plan["boundary_f0"]), plan["fft_size"]))
    t = np.arange(plan["fft_size"]) / fs
    for bi, (b, off, _) in enumerate(dio.band_layout(plan)):
        f = 0.75 * b * (1 + 0.02 * np.sin(2 * np.pi * 3 * t))
        rows[:2, bi] = np.sin(2 * np.pi * np.cumsum(f) / fs + rng.uniform(
            0, 6, (2, 1)))
        rows[1, bi, off + int(0.7 * L):] = rng.standard_normal(
            len(t) - off - int(0.7 * L))
    rows[2] = 0.0
    return rows.astype(np.float32)


def test_k5_plain_matches_jax_band_candidate():
    """band_candidates_plain against JAX _band_candidate (the f32
    scatter+cumsum path, fp_s > 0), band by band, with cap saturation and a
    silent utterance: n and t_limit identical per stream, candidates at
    rtol 1e-5, scores equal to the JAX score over (candidate + guard)."""
    fs, Lx = 16000, 8000
    plan = dio.dio_plan(Lx, fs)
    T, fp = plan["f0_length"], 0.005
    rows = _band_rows(plan, 3, 0)
    got_c, got_s, n, pos = (v.numpy() for v in dio.band_candidates_plain(
        torch.as_tensor(rows), plan, 71.0, 800.0, T, fp, crossings=True))
    tp = jnp.arange(T, dtype=jnp.float32) * np.float32(fp)
    L = plan["y_length"]
    saturated = 0
    for bi, (b, off, cap) in enumerate(dio.band_layout(plan)):
        streams = dio._four_streams(torch.as_tensor(rows[:, bi, off:off + L]))
        for u in range(3):
            filt = jnp.asarray(rows[u, bi, off:off + L])
            jc, js = jdio._band_candidate(filt, L, plan["actual_fs"], b, 71.0,
                                          800.0, tp, cap, fp)
            jc, js = np.asarray(jc), np.asarray(js)
            np.testing.assert_array_equal(got_c[u, bi] > 0, jc > 0)
            np.testing.assert_allclose(got_c[u, bi], jc, rtol=1e-5, atol=0)
            # a score is the spread of four interpolants over the candidate:
            # candidates within rtol 1e-5 bound its error by ~1e-5 absolute
            np.testing.assert_allclose(
                got_s[u, bi], js / (jc + np.float32(1e-12)), rtol=1e-5,
                atol=1e-6)
            for s, jz in enumerate(jdio._four_zero_crossings(
                    filt, L, plan["actual_fs"], cap)):
                _, _, pn, ptl, _ = dio.zero_crossings(
                    streams[u, s][None], plan["actual_fs"], cap)
                assert int(pn[0]) == int(jz[2]) == n[u, bi, s]
                assert np.float32(ptl[0]) == np.float32(jz[3])
                saturated += bool(np.float32(jz[3]) < 1e30)
    assert saturated >= 4 * len(plan["boundary_f0"]) // 2
    assert (got_c[0] > 0).mean() > 0.3 and (got_c[2] == 0).all()
    assert (pos <= L - 1).all() and (pos >= 0).all()


def test_k5_dio_goes_through_band_candidates(monkeypatch):
    """dio() takes its candidates from band_candidates (the K5 wrapper)."""
    calls = []
    real = dio.band_candidates

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(dio, "band_candidates", spy)
    x = np.sin(2 * np.pi * 150.0 * np.arange(1600) / 16000)
    dio.dio(torch.as_tensor(x, dtype=torch.float32)[None], 16000)
    assert len(calls) == 1 and calls[0][1] == 7


def test_k5_f64_oracle_matches_f32_twin():
    """crossing_candidates_f64 on the twin's own crossings lands within
    1e-4 of the twin's candidates where those are nonzero."""
    fs = 16000
    plan = dio.dio_plan(8000, fs)
    T = plan["f0_length"]
    rows = torch.as_tensor(_band_rows(plan, 3, 2))
    c, _, n, pos = dio.band_candidates_plain(rows, plan, 71.0, 800.0, T,
                                             0.005, crossings=True)
    ref = dio.crossing_candidates_f64(rows, plan, T, 0.005, n, pos)
    live = c > 0
    assert live.float().mean() > 0.1
    rel = ((c.double() - ref).abs() / ref.abs())[live]
    assert rel.max() < 1e-4


# ---------------------------------------------------------------------------
# K6: the mgc / bap encode
# ---------------------------------------------------------------------------


def _spectra(T, n, seed):
    """sp, ap log-uniform over 1e-8..1e2; exact zeros in sp; ap rows that
    put bap[0] just above 0 (snapped) and clearly off it."""
    rng = np.random.default_rng(seed)
    sp = 10.0 ** rng.uniform(-8, 2, (T, n))
    sp[rng.random((T, n)) < 0.05] = 0.0
    sp[3] = 0.0
    ap = 10.0 ** rng.uniform(-8, 2, (T, n))
    ap[0] = 1.0
    ap[1] = np.exp(5e-5)
    ap[2] = 0.5
    return sp.astype(np.float32), ap.astype(np.float32)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k6_plain_matches_jax_encode(fs):
    """encode_features against cli.encode_features at rtol 1e-5, atol
    1e-4, with the zero floor and the bap[0] snap exercised."""
    N = cfg.cheaptrick_fft_size(fs)
    B, T = 2, 12
    sps, aps = zip(*[_spectra(T, N // 2 + 1, s) for s in range(B)])
    f0 = np.where(np.random.default_rng(3).random((B, T)) < 0.3, 0.0,
                  np.random.default_rng(4).uniform(80, 400, (B, T)))
    f0 = f0.astype(np.float32)
    lf0, mgc, bap = (v.numpy() for v in encode.encode_features(
        torch.as_tensor(f0), torch.as_tensor(np.stack(sps)),
        torch.as_tensor(np.stack(aps)), fs, N))
    snapped = 0
    for u in range(B):
        jl, jm, jb = (np.asarray(v) for v in jcli.encode_features(
            jnp.asarray(f0[u]), jnp.asarray(sps[u]), jnp.asarray(aps[u]),
            fs, N))
        np.testing.assert_allclose(lf0[u], jl, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(mgc[u], jm, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(bap[u], jb, rtol=1e-5, atol=1e-4)
        snapped += int((jb[:2, 0] == 0.0).sum())
        assert jb[2, 0] < -0.5
    assert snapped >= 2
    assert mgc.shape == (B, T, 50) and bap.shape == (B, T, 25)
    assert (lf0 == 0).sum() == (f0 == 0).sum()


# ---------------------------------------------------------------------------
# K7: delta windows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 2, 40])
def test_k7_plain_bit_equal_to_jax(T):
    """expand bit-equal to the JAX expand in f32, with -1e10 frames at the
    edges and inside."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((3, T, 7)).astype(np.float32)
    x[0, 0, 2] = x[1, -1, :] = windows.MAGIC
    if T > 5:
        x[2, T // 2, 1:4] = windows.MAGIC
    got = windows.expand(torch.as_tensor(x)).numpy()
    for u in range(3):
        want = np.asarray(jwin.expand(jnp.asarray(x[u])))
        assert want.dtype == np.float32
        assert np.array_equal(got[u].view(np.int32), want.view(np.int32))
    assert (got == np.float32(windows.MAGIC)).sum() > 3


# ---------------------------------------------------------------------------
# K8: MLPG
# ---------------------------------------------------------------------------


def _mlpg_inputs(B, T, D, seed, n_win=3):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((B, T, n_win, D)).astype(np.float32)
    var = (0.2 + rng.random((B, T, n_win, D))).astype(np.float32)
    return mu, var


@pytest.mark.parametrize("T", [1, 2, 4, 37])
def test_k8_plain_matches_jax_and_dense(T):
    """mlpg against the JAX mlpg (f32) at rtol 1e-4, and both against the
    dense float64 solve within 1e-3 of the trajectory's range.  (The JAX
    banded solve needs T >= 2: its band shifts drop two frames.)"""
    mu, var = _mlpg_inputs(2, T, 5, T)
    got = mlpg.mlpg(torch.as_tensor(mu), torch.as_tensor(var)).numpy()
    for u in range(2):
        dense = jmlpg.mlpg_dense(mu[u].astype(np.float64),
                                 var[u].astype(np.float64))
        span = max(np.ptp(dense), 1e-3)
        assert np.abs(got[u] - dense).max() <= 1e-3 * span
        if T < 2:
            continue
        want = np.asarray(jmlpg.mlpg(jnp.asarray(mu[u]), jnp.asarray(var[u])))
        assert want.dtype == np.float32
        np.testing.assert_allclose(got[u], want, rtol=1e-4, atol=1e-6)
        assert np.abs(want - dense).max() <= 1e-3 * span


def test_k8_statics_only_closed_form():
    """Statics-only windows: the precision-weighted mean, as JAX."""
    mu, var = _mlpg_inputs(2, 9, 4, 7, n_win=2)
    wins = ((1.0,), (1.0,))
    got = mlpg.mlpg(torch.as_tensor(mu), torch.as_tensor(var), wins).numpy()
    for u in range(2):
        want = np.asarray(jmlpg.mlpg(jnp.asarray(mu[u]), jnp.asarray(var[u]),
                                     windows=wins))
        np.testing.assert_allclose(got[u], want, rtol=1e-6)
    assert sum(kernels.launches.values()) == 0


def test_k8_banded_normal_matches_jax():
    """build_banded_normal, batched, against the JAX bands of each
    (utterance, dimension), bit for bit."""
    mu, var = _mlpg_inputs(2, 11, 3, 1)
    prec = (1.0 / var).astype(np.float32)
    diags, rhs = mlpg.build_banded_normal(torch.as_tensor(mu),
                                          torch.as_tensor(prec),
                                          mlpg.DEFAULT_WINDOWS)
    for u in range(2):
        for d in range(3):
            jd, jr = jmlpg.build_banded_normal(
                jnp.asarray(mu[u, :, :, d]), jnp.asarray(prec[u, :, :, d]),
                jmlpg.DEFAULT_WINDOWS)
            assert np.array_equal(diags[u, :, :, d].numpy(), np.asarray(jd))
            assert np.array_equal(rhs[u, :, d].numpy(), np.asarray(jr))


def test_k8_matches_jax_under_vmap():
    """The batched solve equals the JAX per-utterance solve run under
    jax.vmap over utterances."""
    mu, var = _mlpg_inputs(3, 25, 6, 5)
    want = np.asarray(jax.vmap(jmlpg.mlpg)(jnp.asarray(mu), jnp.asarray(var)))
    got = mlpg.mlpg(torch.as_tensor(mu), torch.as_tensor(var)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
