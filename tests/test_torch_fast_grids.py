"""The port's float32 analysis at frame grids of no whole number of
samples (44.1 and 22.05 kHz at 5 ms: 220.5 and 110.25 samples a frame)
against the JAX package's float32 generic windows and StoneMask's float32
bucket path, on the CPU.

Inputs are made with numpy from a seed: two tonal utterances of 0.3 s
with a gliding pitch and an unvoiced gap.  The JAX package's
`batch_analyze` vmaps `_analyze_one`, which is `vocoder.analyze(parity=
False)`'s chain: DIO, then StoneMask (grid_step 0), CheapTrick and D4C
(generic frames), each jitted alone.  That chain after DIO, module by
module, is the reference, fed the port's DIO (held to the JAX package's
in tests/test_torch_modules.py; its compilation would double this file's
time).  The float64 reference is the JAX package's CheapTrick and D4C in
float64 on the same f0.

Gates (ROADMAP's North star, tests/test_fast_stress.py's): V/UV agreement
above 0.9, f0 median rel below 1e-3, median |dlog sp| below 0.1; and the
port's error against the JAX float64 path at most 1.25x the JAX float32
path's (as tests/test_torch_modules.py holds it).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import config as jcfg
from hts_train_world_tpu.ops import cheaptrick as jct
from hts_train_world_tpu.ops import d4c as jd4c
from hts_train_world_tpu.ops import stonemask as jsm
from hts_train_world_tpu_torch import cli, vocoder
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch.io import rawio, wavio
from hts_train_world_tpu_torch.ops import dio
from hts_train_world_tpu_torch.ops import stonemask as sm
from hts_train_world_tpu_torch.parallel import batch, bucketing, features

FP, DUR = 5.0, 0.3
RATES = (44100, 22050)


def _signal(fs, dur, seed, f0=180.0):
    L = int(fs * dur)
    t = np.arange(L) / fs
    rng = np.random.default_rng(seed)
    ph = np.cumsum(2 * np.pi * f0 * (1 + 0.03 * np.sin(2 * np.pi * 4 * t))
                   / fs)
    x = (0.6 * np.sin(ph) + 0.3 * np.sin(2 * ph) + 0.1 * np.sin(3 * ph)
         + 0.01 * rng.standard_normal(L))
    x[L // 3:L // 3 + L // 8] = 0.02 * rng.standard_normal(L // 8)
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(fs):
    """The two utterances, the port's DIO (t, f0), the JAX package's
    float32 chain after it (StoneMask's bucket path, CheapTrick and D4C at
    grid_step 0: f0, sp, ap stacked) and its CheapTrick and D4C in float64
    on the same f0."""
    xs = np.stack([_signal(fs, DUR, 0), _signal(fs, DUR, 1, 230.0)])
    tt, f0t, _, _ = dio.dio(torch.as_tensor(xs), fs, FP)
    t, dio_f0 = tt.numpy(), f0t.numpy()
    N = jcfg.cheaptrick_fft_size(fs)
    jt = jnp.asarray(t)
    f0 = np.stack([np.asarray(jsm.stonemask(jnp.asarray(x), fs, jt,
                                            jnp.asarray(f)))
                   for x, f in zip(xs, dio_f0)])
    sp = np.stack([np.asarray(jct.cheaptrick(jnp.asarray(x), fs, jt,
                                             jnp.asarray(f), N))
                   for x, f in zip(xs, f0)])
    ap = np.stack([np.asarray(jd4c.d4c(jnp.asarray(x), fs, jt,
                                       jnp.asarray(f), N, 0.0, None)[0])
                   for x, f in zip(xs, f0)])
    x64 = [jnp.asarray(x, jnp.float64) for x in xs]
    t64 = jnp.asarray(t, jnp.float64)
    sp64 = np.stack([np.asarray(jct.cheaptrick(x, fs, t64, jnp.asarray(
        f, jnp.float64), N)) for x, f in zip(x64, f0)])
    ap64 = np.stack([np.asarray(jd4c.d4c(x, fs, t64, jnp.asarray(
        f, jnp.float64), N, 0.0, None)[0]) for x, f in zip(x64, f0)])
    return xs, (t, dio_f0), (f0, sp, ap), (sp64, ap64)


def _hold_f0(got, want):
    """V/UV agreement and the f0 median rel on frames voiced in both."""
    assert ((got > 0) == (want > 0)).mean() > 0.9
    both = (got > 0) & (want > 0)
    assert both.mean() > 0.5
    assert np.median(np.abs(got[both] - want[both]) / want[both]) < 1e-3


def _hold_spectra(sp, ap, jax_sp, jax_ap, ref):
    """sp within the gate of JAX's, and sp and ap no farther from the
    JAX float64 path than 1.25x the JAX float32 path is."""
    sp64, ap64 = ref
    assert np.isfinite(sp).all() and (sp > 0).all()
    assert ((ap >= 0) & (ap <= 1)).all()
    assert np.median(np.abs(np.log(sp) - np.log(jax_sp))) < 0.1
    e_port = np.median(np.abs(np.log(sp) - np.log(sp64)))
    assert e_port <= 1.25 * np.median(np.abs(np.log(jax_sp)
                                             - np.log(sp64)))
    assert np.median(np.abs(ap - ap64)) <= 1.25 * np.median(
        np.abs(jax_ap - ap64))


@pytest.mark.parametrize("fs", RATES)
def test_batch_analyze_matches_jax_generic_path(fs):
    """`batch_analyze` at a frame grid of no whole number of samples
    (grid_step 0): DIO's time axis, the JAX bucket path's voiced frames,
    and f0, sp and ap within the gates of the JAX chain's."""
    xs, (t, _), (f0, sp, ap), ref = _jax(fs)
    gt, gf0, gsp, gap = (v.numpy() for v in batch.batch_analyze(
        xs, fs, FP, device="cpu"))
    assert gt.shape == (2, len(t)) and gsp.shape == sp.shape
    np.testing.assert_array_equal(gt[0], t)
    np.testing.assert_array_equal(gf0 > 0, f0 > 0)
    _hold_f0(gf0, f0)
    _hold_spectra(gsp, gap, sp, ap, ref)


@pytest.mark.parametrize("fs", RATES)
def test_estimate_f0_of_a_float32_wave_at_its_defaults_matches_jax(fs):
    """`estimate_f0` of a float32 waveform without `fast_grid` is
    StoneMask's float32 bucket path: DIO's time axis, and f0 on the same
    frames voiced as the JAX bucket path's and within the gates (its 16
    kHz case is in tests/test_torch_parity_analysis.py)."""
    xs, (t, _), (f0, _, _), _ = _jax(fs)
    for x, want in zip(xs, f0):
        tt, got = vocoder.estimate_f0(x, fs, FP, device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(tt.numpy(), t)
        np.testing.assert_array_equal(got.numpy() > 0, want > 0)
        _hold_f0(got.numpy(), want)


def test_analyze_fast_path_matches_jax():
    """`vocoder.analyze(parity=False)` of one utterance at 44.1 kHz
    against the JAX package's chain."""
    fs = 44100
    xs, (t, _), (f0, sp, ap), ref = _jax(fs)
    a = vocoder.analyze(xs[1], fs, FP, parity=False, device="cpu")
    assert a.fft_size == jcfg.cheaptrick_fft_size(fs)
    np.testing.assert_array_equal(a.temporal_positions.numpy(), t)
    _hold_f0(a.f0.numpy(), f0[1])
    _hold_spectra(a.spectrogram.numpy()[None], a.aperiodicity.numpy()[None],
                  sp[1:], ap[1:], (ref[0][1:], ref[1][1:]))


@pytest.mark.parametrize("fs", RATES)
def test_copy_synth_feature_lane_and_corpus_extract_run(fs):
    """`batch_copy_synth`, the feature lane and `bucketed_extract` at the
    new grids: DIO's frame count, finite outputs of the expected shapes,
    the lanes' analysis that of `batch_analyze`."""
    xs, (t, _), _, _ = _jax(fs)
    T = len(t)
    _, f0, sp, ap = batch.batch_analyze(xs, fs, FP, device="cpu")
    _, f0c, spc, apc, y = batch.batch_copy_synth(xs, fs, FP, seed=3,
                                                 device="cpu")
    assert torch.equal(f0c, f0) and torch.equal(spc, sp) \
        and torch.equal(apc, ap)
    assert y.shape == (2, cfg.y_length_for(T, FP, fs))
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) > 0.05
    lf0, mgc, bap, traj = features.feature_lane(xs, fs, FP, device="cpu")
    assert lf0.shape == (2, T) and mgc.shape == (2, T, 50) \
        and bap.shape == (2, T, 25) and traj.shape == (2, T, 75)
    assert all(bool(torch.isfinite(v).all()) for v in (lf0, mgc, bap, traj))
    assert ((lf0 != 0) == (f0 > 0)).all()
    sigs = [xs[0], xs[1][:len(xs[1]) * 2 // 3]]
    out = bucketing.bucketed_extract(sigs, fs, FP, device="cpu")
    for s, (l, m, b) in zip(sigs, out):
        n = cfg.samples_for_dio(fs, len(s), FP)
        assert l.shape == (n,) and m.shape == (n, 50) and b.shape == (n, 25)
        assert np.isfinite(m).all() and np.isfinite(b).all()
        assert (l != 0).mean() > 0.5


def test_frame_in_no_stonemask_bucket_stays_zero():
    """A frame whose DFT size 4 * 2^floor(log2(2h+1)) is no bucket's (f0
    below f0_floor, or above f0_ceil but under fs/12) stays 0 on the
    float32 bucket path, as in the JAX package; the others are refined as
    JAX refines them."""
    fs = 44100
    xs, (t, _), (f0, _, _), _ = _jax(fs)
    seed = f0.copy()
    seed[:, 5:9] = 60.0                     # a bucket past B_max
    seed[:, 12:16] = 1500.0                 # a bucket under the first
    assert (seed[:, 30:40] > 0).all()
    got = sm.stonemask(torch.tensor(xs), fs, torch.tensor(t),
                       torch.tensor(seed)).numpy()
    want = np.stack([np.asarray(jsm.stonemask(
        jnp.asarray(x), fs, jnp.asarray(t), jnp.asarray(s)))
        for x, s in zip(xs, seed)])
    assert (got[:, 5:9] == 0).all() and (got[:, 12:16] == 0).all()
    np.testing.assert_array_equal(got > 0, want > 0)
    v = want > 0
    assert np.median(np.abs(got[v] - want[v]) / want[v]) < 1e-4


def test_cli_analysis_f32_at_44k_matches_the_fast_path(tmp_path):
    """`analysis --f32` at 44.1 kHz writes the f0, sp and ap of
    `vocoder.analyze(parity=False)` of the wav it reads (raw, mgcdim 0),
    and they are held to the JAX chain on those samples."""
    fs = 44100
    xs, (t, _), _, _ = _jax(fs)
    wav = str(tmp_path / "in.wav")
    wavio.wavwrite(xs[0], fs, wav)
    p = {k: str(tmp_path / f"o.{k}") for k in ("lf0", "mgc", "bap")}
    cli.main(["analysis", wav, p["lf0"], p["mgc"], p["bap"], "5.0", "0",
              "0", "24", "--f32", "--device", "cpu"])
    x, _ = wavio.wavread(wav)
    a = vocoder.analyze(x, fs, FP, parity=False, device="cpu")
    H = a.fft_size // 2 + 1
    np.testing.assert_array_equal(rawio.read_f32(p["lf0"]), a.f0.numpy())
    np.testing.assert_array_equal(rawio.read_f32(p["mgc"], H),
                                  a.spectrogram.numpy())
    np.testing.assert_array_equal(rawio.read_f32(p["bap"], H),
                                  a.aperiodicity.numpy())
    f0_dio = dio.dio(torch.as_tensor(x, dtype=torch.float32)[None], fs,
                     FP)[1][0]
    jf0 = np.asarray(jsm.stonemask(jnp.asarray(np.asarray(x, np.float32)),
                                   fs, jnp.asarray(t),
                                   jnp.asarray(f0_dio.numpy())))
    _hold_f0(a.f0.numpy(), jf0)
