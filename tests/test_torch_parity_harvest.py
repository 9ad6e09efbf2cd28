"""The port's Harvest in float64 (the parity analysis with
algorithm="harvest") against the JAX package under x64, on the CPU.

Inputs are made from a seed with numpy: the `_signal` of
tests/test_torch_parity_analysis.py (two harmonics of a pitch gliding
150 -> 230 Hz, an unvoiced gap of noise) at 16 kHz (0.3 s, decimation
ratio 2) and at 44.1 kHz (0.2 s, ratio 6: fs8 = 7350, 7.35 samples a 1 ms
frame).  Every JAX result is computed once per module, jitted.

Per module the port is fed the JAX package's own intermediate results, so
each module's error is its own: K13's twin (the decimated, mean-removed
waveform) within 1e-12 of its peak; K14's twin with the same zero pattern
and rtol 1e-9 (and on an input dominated by a high tone, to show that the
per-octave crossing caps the port keeps in float64 are not reached);
K32's twin (detection and overlap) within 1e-12 relative; K15's twin at
rtol 1e-9; K16's twin within 1e-9 Hz; `frame_pick`'s positions float64
and equal.
The slice whole: `vocoder.analyze(algorithm="harvest")` at its default
(parity) with t equal, f0 at rel 1e-9, sp at rel 1.5e-8 and ap within
1e-9 (the parity DIO analysis' bounds), `estimate_f0` of a float64
waveform held the same way, and the `analysis --harvest` command at its
default against the JAX CLI, with the differing float32 words counted.
No kernel launches on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import cli as jcli
from hts_train_world_tpu import vocoder as jvocoder
from hts_train_world_tpu.ops import harvest as jhv
from hts_train_world_tpu.ops import harvest_fix as jhf
from hts_train_world_tpu_torch import cli, kernels, vocoder
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch.io import wavio
from hts_train_world_tpu_torch.ops import harvest as hv
from hts_train_world_tpu_torch.ops import harvest_fix as hf

FP = 5.0
CASES = {16000: 0.3, 44100: 0.2}
LO, HI = cfg.K_FLOOR_F0, cfg.K_CEIL_F0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the twins run many small ops, which the
    default thread pool slows many-fold when test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signal(fs, dur, seed=0):
    """Two harmonics of a pitch gliding 150 -> 230 Hz, an unvoiced gap of
    noise at 40-55 % of the duration, a little noise throughout."""
    rng = np.random.default_rng(seed)
    n = int(dur * fs)
    f = np.linspace(150.0, 230.0, n)
    ph = 2 * np.pi * np.cumsum(f) / fs
    x = 0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph) + 0.003 * rng.standard_normal(n)
    a, b = int(0.40 * n), int(0.55 * n)
    x[a:b] = 0.05 * rng.standard_normal(b - a)
    return x


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    den = np.where(want == 0.0, 1.0, np.abs(want))
    return float(np.max(np.where(got == want, 0.0, np.abs(got - want) / den)))


@jax.jit
def _jax_contour(refined, scores):
    """The JAX package's contour stack (harvest.py:_harvest_back_trace
    after the refinement)."""
    T = refined.shape[0]
    r, s = jhf.remove_unreliable(refined, scores)
    s4 = jhf.fix_contour(r, s, jhf.step3_section_cap(T))
    return jhf.smooth_contour(s4, jhf.smooth_section_cap(T))


def _raw(y, plan, T1):
    return np.asarray(jhv._raw_candidates(
        jnp.asarray(y), plan["actual_fs"], plan["fft_size"],
        plan["y_length"], T1, tuple(plan["boundaries"]), LO, HI, 1.0))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's float64 Harvest of each case, its intermediate
    results and its parity analysis."""
    out = {}
    for fs, dur in CASES.items():
        x = _signal(fs, dur)
        xj = jnp.asarray(x)
        L = len(x)
        plan = jhv.harvest_plan(L, fs, LO, HI)
        T1 = cfg.samples_for_dio(fs, L, 1.0)
        fs8 = plan["actual_fs"]
        y, cands, nc = jhv._harvest_front(xj, fs, LO, HI)
        raw = _raw(y, plan, T1)
        refined, scores = jhv.refine_all(
            y, jnp.arange(T1, dtype=jnp.float64) * 0.001, cands, fs8, LO, HI)
        t, f0 = jhv.harvest(xj, fs, FP)
        a = jvocoder.analyze(xj, fs, FP, algorithm="harvest")   # parity
        out[fs] = dict(
            x=x, plan=plan, T1=T1, y=np.asarray(y), raw=raw,
            cands=np.asarray(cands), nc=int(nc),
            refined=np.asarray(refined), scores=np.asarray(scores),
            f0_1ms=np.asarray(_jax_contour(refined, scores)),
            t=np.asarray(t), f0=np.asarray(f0), a_t=np.asarray(
                a.temporal_positions), a_f0=np.asarray(a.f0),
            sp=np.asarray(a.spectrogram), ap=np.asarray(a.aperiodicity),
            N=a.fft_size)
    return out


# ---------------------------------------------------------------------------
# per module, fed the JAX package's intermediate results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", list(CASES))
def test_k13_waveform_sub_float64_matches_jax(jax_runs, fs):
    """K13's twin with the held ends and the mean removal: the decimated
    waveform within 1e-12 of its peak, in float64."""
    r = jax_runs[fs]
    got = hv.waveform_sub(_t(r["x"])[None], r["plan"])[0]
    assert got.dtype == torch.float64 and got.shape == r["y"].shape
    assert np.abs(got.numpy() - r["y"]).max() <= 1e-12 * np.abs(r["y"]).max()


@pytest.mark.parametrize("fs", list(CASES))
def test_k14_raw_candidates_float64_match_jax(jax_runs, fs):
    """The FFT band filter and K14's twin on JAX's decimated waveform
    against JAX's f64 `_raw_candidates`: the same zero pattern, rtol
    1e-9."""
    r = jax_runs[fs]
    filt = hv.band_filter(_t(r["y"])[None], r["plan"])
    got = hv.raw_candidates(filt, r["plan"], LO, HI, r["T1"])[0].numpy()
    np.testing.assert_array_equal(got > 0, r["raw"] > 0)
    np.testing.assert_allclose(got, r["raw"], rtol=1e-9, atol=0)
    assert (got > 0).mean() > 0.05


def test_k14_caps_not_reached_on_a_high_tone():
    """The port keeps K14's per-octave crossing caps in float64 too (the
    JAX f64 path counts every crossing, to y_length/2 + 2).  A 200 Hz
    voice under a 3.7 kHz tone 25 times as loud (16 kHz, 0.3 s) saturates
    no stream's cap, and the raw candidates keep JAX's zero pattern at
    rtol 1e-9."""
    fs, n = 16000, 4800
    rng = np.random.default_rng(12)
    tt = np.arange(n) / fs
    x = (0.02 * np.sin(2 * np.pi * 200.0 * tt)
         + 0.5 * np.sin(2 * np.pi * 3700.0 * tt)
         + 0.001 * rng.standard_normal(n))
    plan = hv.harvest_plan(n, fs, LO, HI)
    T1 = cfg.samples_for_dio(fs, n, 1.0)
    y = hv.waveform_sub(_t(x)[None], plan)
    got, nint, _ = hv.raw_candidates_plain(hv.band_filter(y, plan), plan, LO,
                                           HI, T1, crossings=True)
    caps = torch.tensor([c for _, _, c in hv.channel_layout(plan)])
    assert (nint < caps[None, :, None] - 1).all()
    want = _raw(y[0].numpy(), plan, T1)
    np.testing.assert_array_equal(got[0].numpy() > 0, want > 0)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-9, atol=0)
    assert (want > 0).any()


@pytest.mark.parametrize("fs", list(CASES))
def test_k32_detect_overlap_float64_matches_jax(jax_runs, fs):
    """K32's twin on JAX's raw candidates: the spread candidates within
    1e-12 relative of JAX's detect + overlap (a run's mean is a
    difference of prefix sums: JAX's come from XLA's blocked scan, the
    twin's from a sequential sum, ~3e-15 apart), the same zero pattern
    and the same count."""
    r = jax_runs[fs]
    got, nc = hv.detect_overlap(_t(r["raw"])[None], r["plan"]["nc_pad"])
    assert got.dtype == torch.float64 and int(nc[0]) == r["nc"] > 0
    np.testing.assert_array_equal(got[0].numpy() > 0, r["cands"] > 0)
    np.testing.assert_allclose(got[0].numpy(), r["cands"], rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("fs", list(CASES))
def test_k15_refine_float64_matches_jax(jax_runs, fs):
    """K15's twin (the <= 6 bins by a direct DFT) on JAX's decimated
    waveform and candidates against JAX's `refine_all` (a full rfft at B
    of each clipped window): refined f0 and scores at rtol 1e-9."""
    r = jax_runs[fs]
    rf, sc = hv.refine(_t(r["y"])[None], _t(r["cands"])[None],
                       r["plan"]["actual_fs"], LO, HI)
    np.testing.assert_allclose(rf[0].numpy(), r["refined"], rtol=1e-9,
                               atol=0)
    np.testing.assert_allclose(sc[0].numpy(), r["scores"], rtol=1e-9, atol=0)
    assert (r["refined"] > 0).sum() > 50


@pytest.mark.parametrize("fs", list(CASES))
def test_k16_contour_float64_matches_jax(jax_runs, fs):
    """K16's twin on JAX's refined candidates and scores against JAX's
    contour stack: within 1e-9 Hz, the same voicing."""
    r = jax_runs[fs]
    got = hf.contour(_t(r["refined"])[None], _t(r["scores"])[None])[0]
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy() > 0, r["f0_1ms"] > 0)
    np.testing.assert_allclose(got.numpy(), r["f0_1ms"], rtol=0, atol=1e-9)
    assert (r["f0_1ms"] > 0).mean() > 0.3


@pytest.mark.parametrize("fs", list(CASES))
def test_frame_pick_positions_in_the_contours_dtype(jax_runs, fs):
    """The frame pick gives the temporal positions in the contour's
    dtype, as the JAX package gives them in x's: float64 at parity (equal
    to JAX's), float32 on the fast path."""
    r = jax_runs[fs]
    L = len(r["x"])
    t, f0 = hv.frame_pick(_t(r["f0_1ms"])[None], fs, L, FP)
    assert t.dtype == torch.float64 and f0.dtype == torch.float64
    np.testing.assert_array_equal(t.numpy(), r["t"])
    t32, _ = hv.frame_pick(_t(r["f0_1ms"]).float()[None], fs, L, FP)
    assert t32.dtype == torch.float32
    np.testing.assert_array_equal(t32.numpy(), r["t"].astype(np.float32))


# ---------------------------------------------------------------------------
# the slice whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", list(CASES))
def test_analyze_harvest_parity_matches_jax(jax_runs, fs):
    """`vocoder.analyze(algorithm="harvest")` at its default (parity,
    float64, Harvest then CheapTrick and D4C on the noise streams)
    against the JAX package's: t equal, f0 at rel 1e-9, sp at rel 1.5e-8,
    ap within 1e-9; no kernel launches."""
    r = jax_runs[fs]
    kernels.reset_counts()
    a = vocoder.analyze(r["x"], fs, FP, algorithm="harvest", device="cpu")
    assert sum(kernels.launches.values()) == 0
    assert a.f0.dtype == torch.float64 and a.fft_size == r["N"]
    assert a.temporal_positions.dtype == torch.float64
    np.testing.assert_array_equal(a.temporal_positions.numpy(), r["a_t"])
    assert _rel(a.f0.numpy(), r["a_f0"]) <= 1e-9
    assert _rel(a.spectrogram.numpy(), r["sp"]) <= 1.5e-8
    np.testing.assert_allclose(a.aperiodicity.numpy(), r["ap"], rtol=0,
                               atol=1e-9)
    assert (r["a_f0"] > 0).sum() > 10


@pytest.mark.parametrize("fs", list(CASES))
def test_estimate_f0_harvest_float64_matches_jax(jax_runs, fs):
    """`estimate_f0` of a float64 waveform with Harvest against the JAX
    package's `harvest`: positions equal and float64, f0 at rel 1e-9."""
    r = jax_runs[fs]
    t, f0 = vocoder.estimate_f0(r["x"], fs, FP, algorithm="harvest",
                                device="cpu")
    assert t.dtype == f0.dtype == torch.float64
    np.testing.assert_array_equal(t.numpy(), r["t"])
    assert _rel(f0.numpy(), r["f0"]) <= 1e-9


def _ulp_words(got, want, noise_at, noise: float = 1e-9):
    """The float32 words of `got` that differ from `want`'s by one ulp
    (float64 results that straddle a float32 rounding boundary); every
    other differing word must be a rounding-noise coefficient (|value| <=
    noise on both sides) where `noise_at` allows: the bap coefficients
    past c0 of the frames JAX marks unvoiced, whose flat aperiodicity
    codes to zero but for rounding."""
    gi = got.view(np.int32).astype(np.int64)
    wi = want.view(np.int32).astype(np.int64)
    differ = gi != wi
    noisy = (np.abs(got) <= noise) & (np.abs(want) <= noise)
    noisy &= noise_at if noise_at is not None else False
    ulp = differ & ~noisy
    assert (np.abs(gi - wi)[ulp] <= 1).all(), (got[ulp], want[ulp])
    return int(ulp.sum())


@pytest.mark.parametrize("mgc", [0, 50])
def test_cli_analysis_harvest_at_its_default_matches_jax(tmp_path, mgc):
    """`analysis --harvest` without --f32 (Harvest in float64, then K6 in
    float64 for mgc 50 / bap 25; float32 files) against the JAX CLI under
    x64, raw and encoded: every differing float32 word is one ulp from
    JAX's or a rounding-noise bap coefficient past c0 of an unvoiced
    frame, and the one-ulp words are at most 1 in 10^3 of all."""
    fs = 16000
    wav = str(tmp_path / "in.wav")
    wavio.wavwrite(_signal(fs, CASES[fs], seed=4), fs, wav)
    args = [FP, 0, mgc, 25] if mgc else [FP, 0, 0]
    outs = {}
    for who in ("port", "jax"):
        paths = [str(tmp_path / f"{who}.{k}") for k in ("lf0", "mgc", "bap")]
        argv = ["analysis", wav, *paths, *(str(a) for a in args), "--harvest"]
        if who == "port":
            cli.main(argv + ["--device", "cpu"])
        else:
            jcli.analysis_main(argv[1:])
        outs[who] = [np.fromfile(p, dtype=np.float32) for p in paths]
    words = ulps = 0
    unvoiced = outs["jax"][0] == 0.0
    assert (~unvoiced).sum() > 10
    for g, w, ext in zip(outs["port"], outs["jax"], ("lf0", "mgc", "bap")):
        assert g.shape == w.shape and np.isfinite(g).all()
        words += g.size
        at = ((unvoiced[:, None] & (np.arange(25) >= 1)).reshape(-1)
              if mgc and ext == "bap" else None)
        ulps += _ulp_words(g, w, at)
    assert ulps <= words // 1000, (ulps, words)
