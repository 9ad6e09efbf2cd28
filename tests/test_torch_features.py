"""The port's feature path against the JAX package, on the CPU: the carried
constants (coding tables, delta windows), the corpus bucketing, the
bucketed feature extraction as a whole, the feature lane, and device
handling."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import cli as jcli
from hts_train_world_tpu import config as jcfg
from hts_train_world_tpu.features import windows as jwin
from hts_train_world_tpu.ops import codec as jcodec
from hts_train_world_tpu.ops import mlpg as jmlpg
from hts_train_world_tpu.parallel import bucketing as jbucketing
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.features import encode, windows
from hts_train_world_tpu_torch.ops import codec, mlpg
from hts_train_world_tpu_torch.parallel import bucketing, features

FS = 16000


# ---------------------------------------------------------------------------
# carried constants
# ---------------------------------------------------------------------------


def test_codec_constants_equal():
    for name in ("K_M0", "K_F0", "K_FLOOR_FREQUENCY", "K_CEIL_FREQUENCY"):
        assert getattr(cfg, name) == getattr(jcfg, name)
    assert encode.LN_1E4 == jcli.LN_1E4


@pytest.mark.parametrize("fs", [16000, 48000])
@pytest.mark.parametrize("n_dims", [50, 25])
def test_coding_tables_bit_equal(fs, n_dims):
    N = cfg.cheaptrick_fft_size(fs)
    got = codec._coding_tables(fs, N, n_dims)
    want = jcodec._coding_tables(fs, N, n_dims)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_windows_bit_equal():
    assert windows.MAGIC == jwin.MAGIC
    assert len(windows.DEFAULT_WINDOWS) == len(jwin.DEFAULT_WINDOWS)
    for a, b in zip(windows.DEFAULT_WINDOWS, jwin.DEFAULT_WINDOWS):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(windows._support(a), jwin._support(b))
    for w in ([0.0, 1.0, 0.0], [0.0, -0.5, 0.0, 0.5, 0.0], [2.0]):
        assert np.array_equal(windows._support(np.array(w)),
                              jwin._support(np.array(w)))
    assert mlpg.DEFAULT_WINDOWS == jmlpg.DEFAULT_WINDOWS


def test_code_aperiodicity_matches_jax():
    rng = np.random.default_rng(0)
    N = cfg.cheaptrick_fft_size(48000)
    ap = (10.0 ** rng.uniform(-3, 0, (2, 5, N // 2 + 1))).astype(np.float32)
    got = codec.code_aperiodicity(torch.as_tensor(ap), 48000, N).numpy()
    for u in range(2):
        want = np.asarray(jcodec.code_aperiodicity(jnp.asarray(ap[u]), 48000,
                                                   N))
        np.testing.assert_allclose(got[u], want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("growth", [1.26, 1.7])
def test_bucket_plan_matches_jax(growth):
    lengths = np.random.default_rng(1).integers(100, 200_000, 200).tolist()
    for n in lengths:
        assert bucketing.bucket_length(n, growth) == \
            jbucketing.bucket_length(n, growth)
    assert bucketing.plan_buckets(lengths, growth) == \
        jbucketing.plan_buckets(lengths, growth)
    groups = bucketing.bucket_groups(lengths, growth, max_batch=16)
    assert sorted(i for _, g in groups for i in g) == list(range(200))
    assert all(1 <= len(g) <= 16 for _, g in groups)


def _utterances(lengths, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        t = np.arange(n) / FS
        f0 = rng.uniform(140, 260) * (1 + 0.02 * np.sin(2 * np.pi * 5.5 * t))
        ph = 2 * np.pi * np.cumsum(f0) / FS
        x = sum(a * np.sin((h + 1) * ph)
                for h, a in enumerate([0.5, 0.3, 0.15, 0.08]))
        x = 0.7 * x / np.abs(x).max() + 0.005 * rng.standard_normal(n)
        x[n // 2:n // 2 + n // 10] *= 0.01                       # a pause
        out.append(x)
    return out


# 0.30-0.50 s at 16 kHz: three buckets (6144, 8192, 10240 samples)
LENGTHS = [4800, 6000, 7000, 5000, 6400, 8000]


@pytest.fixture(scope="module")
def extracted():
    sigs = _utterances(LENGTHS)
    assert len(bucketing.plan_buckets(LENGTHS)) == 3
    kernels.reset_counts()
    port = bucketing.bucketed_extract(sigs, FS, device="cpu")
    jax_ = jbucketing.bucketed_extract(sigs, FS)
    return port, jax_


def test_bucketed_extract_shapes(extracted):
    port, _ = extracted
    for n, (lf0, mgc, bap) in zip(LENGTHS, port):
        T = cfg.samples_for_dio(FS, n, 5.0)
        assert lf0.shape == (T,) and mgc.shape == (T, 50) \
            and bap.shape == (T, 25)
        for v in (lf0, mgc, bap):
            assert v.dtype == np.float32 and np.isfinite(v).all()
    assert sum(kernels.launches.values()) == 0


def test_bucketed_extract_matches_jax(extracted):
    """lf0: V/UV agreement > 0.9 and median |dlf0| < 1e-3 on frames voiced
    in both; mgc and bap through the JAX decoder: median |dlog sp| < 0.1 on
    bins within 60 dB of each frame's peak, median |dap| < 0.01."""
    port, jax_ = extracted
    N = cfg.cheaptrick_fft_size(FS)
    for (lf0, mgc, bap), (jlf0, jmgc, jbap) in zip(port, jax_):
        assert lf0.shape == jlf0.shape and mgc.shape == jmgc.shape
        assert ((lf0 != 0) == (jlf0 != 0)).mean() > 0.9
        both = (lf0 != 0) & (jlf0 != 0)
        assert both.mean() > 0.5
        assert np.median(np.abs(lf0[both] - jlf0[both])) < 1e-3

        def dec(m, c0, dims):
            m = np.array(m, np.float64)
            m[:, 0] += c0
            return np.asarray(jcodec.decode_spectral_envelope(
                jnp.asarray(m), FS, N, dims)) / 1e4

        sp, jsp = dec(mgc, -12.0, 50), dec(jmgc, -12.0, 50)
        live = jsp > jsp.max(axis=1, keepdims=True) * 1e-6
        assert np.median(np.abs(np.log(sp[live]) - np.log(jsp[live]))) < 0.1
        ap, jap = (dec(b, jcli.LN_1E4, 25) for b in (bap, jbap))
        assert np.median(np.abs(ap - jap)) < 0.01


def test_bucketed_analyze_trims_to_true_frames():
    sigs = _utterances([3000, 5200])
    out = bucketing.bucketed_analyze(sigs, FS, device="cpu")
    for n, (t, f0, sp, ap) in zip([3000, 5200], out):
        T = cfg.samples_for_dio(FS, n, 5.0)
        assert t.shape == f0.shape == (T,) and sp.shape == ap.shape == (T,
                                                                        513)


def test_padding_rows_do_not_reach_real_rows():
    """One utterance gives the same features alone and in a group."""
    sigs = _utterances([5000, 5100, 4900], seed=4)
    alone = bucketing.bucketed_extract(sigs[:1], FS, device="cpu")[0]
    grouped = bucketing.bucketed_extract(sigs, FS, device="cpu")[0]
    for a, b in zip(alone, grouped):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the feature lane
# ---------------------------------------------------------------------------


def test_feature_lane_outputs():
    """(lf0, mgc, bap, traj) finite with the lane's shapes; the MLPG
    trajectory stays near the statics it was given."""
    sigs = np.stack(_utterances([4800, 4800], seed=2)).astype(np.float32)
    lf0, mgc, bap, traj = features.feature_lane(sigs, FS, device="cpu")
    T = cfg.samples_for_dio(FS, 4800, 5.0)
    assert lf0.shape == (2, T) and mgc.shape == (2, T, 50)
    assert bap.shape == (2, T, 25) and traj.shape == (2, T, 75)
    for v in (lf0, mgc, bap, traj):
        assert torch.isfinite(v).all()
    assert (lf0 != 0).float().mean() > 0.5
    statics = torch.cat([mgc, bap], dim=-1)
    assert ((traj - statics).abs().median()
            < 0.1 * statics.abs().median())


def test_feature_lane_matches_stagewise_jax():
    """The lane's expand and MLPG stages against JAX's expand + mlpg on
    the port's own encoded features (f32, rtol 1e-4)."""
    sigs = np.stack(_utterances([4000], seed=3)).astype(np.float32)
    lf0, mgc, bap, traj = features.feature_lane(sigs, FS, device="cpu")
    ffo = jwin.expand(jnp.asarray(torch.cat([mgc, bap], -1)[0].numpy()))
    means = ffo.reshape(ffo.shape[0], 3, -1)
    want = np.asarray(jmlpg.mlpg(means, 1.0 + 0.1 * jnp.abs(means)))
    np.testing.assert_allclose(traj[0].numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("call", ["bucketed_extract", "bucketed_analyze",
                                  "feature_lane"])
def test_feature_entry_points_default_to_the_card(call):
    """The feature path defaults to device='cuda' and raises without a
    card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = _utterances([1600])
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "feature_lane":
            features.feature_lane(np.stack(x), FS)
        else:
            getattr(bucketing, call)(x, FS)


def test_harvest_is_a_later_slice():
    """Harvest was ported after DIO: bucketed_extract takes it, and an
    unknown F0 algorithm is refused."""
    x = _utterances([1600, 2400])
    out = bucketing.bucketed_extract(x, FS, algorithm="harvest",
                                     device="cpu")
    assert [r[0].shape[0] for r in out] == [
        cfg.samples_for_dio(FS, len(v), 5.0) for v in x]
    assert all(np.isfinite(v).all() for r in out for v in r)
    with pytest.raises(ValueError, match="unknown f0 algorithm"):
        bucketing.bucketed_extract(x, FS, algorithm="yin", device="cpu")
