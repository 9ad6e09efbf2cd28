"""The PyTorch port's analysis and synthesis modules against the JAX
package, on the CPU (plain PyTorch twins of the kernels).

Inputs are made with numpy from a seed; every module is fed the same f0
as its JAX counterpart.  Where a float32 tolerance is looser than the
port's plan asked for, the test says why and adds a float64 check of the
same module that holds the algorithm to ~1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import config as jcfg
from hts_train_world_tpu.ops import cheaptrick as jct
from hts_train_world_tpu.ops import d4c as jd4c
from hts_train_world_tpu.ops import dio as jdio
from hts_train_world_tpu.ops import stonemask as jsm
from hts_train_world_tpu.ops import synthesis as jsyn
from hts_train_world_tpu_torch.ops import cheaptrick as ct
from hts_train_world_tpu_torch.ops import d4c as d4c_mod
from hts_train_world_tpu_torch.ops import dio as dio_mod
from hts_train_world_tpu_torch.ops import stonemask as sm
from hts_train_world_tpu_torch.ops import synthesis as syn

CASES = [(16000, 0.5), (48000, 0.25)]


def _signal(fs, dur, seed, f0=180.0):
    L = int(fs * dur)
    t = np.arange(L) / fs
    rng = np.random.default_rng(seed)
    ph = np.cumsum(2 * np.pi * f0 * (1 + 0.03 * np.sin(2 * np.pi * 4 * t)) / fs)
    x = (0.6 * np.sin(ph) + 0.3 * np.sin(2 * ph) + 0.1 * np.sin(3 * ph)
         + 0.01 * rng.standard_normal(L))
    x[L // 3:L // 3 + L // 8] = 0.02 * rng.standard_normal(L // 8)  # unvoiced
    return x.astype(np.float32)


_CACHE = {}


def _case(fs, dur):
    """Two utterances, the JAX DIO + StoneMask f0 of each (f32 fast
    path), and the shared time axis."""
    key = (fs, dur)
    if key not in _CACHE:
        xs = np.stack([_signal(fs, dur, 0), _signal(fs, dur, 1, 230.0)])
        gs = int(fs * 0.005)
        dio_out = [jdio.dio(jnp.asarray(x), fs, 5.0) for x in xs]
        t = np.asarray(dio_out[0][0])
        f0_dio = np.stack([np.asarray(o[1]) for o in dio_out])
        f0_sm = np.stack([np.asarray(jsm.stonemask(
            jnp.asarray(x), fs, jnp.asarray(t), jnp.asarray(f), grid_step=gs))
            for x, f in zip(xs, f0_dio)])
        _CACHE[key] = (xs, t, f0_dio, f0_sm, gs)
    return _CACHE[key]


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("fs,dur", CASES)
def test_dio_matches_jax(fs, dur):
    xs, t, f0_dio, _, _ = _case(fs, dur)
    tp, f0, _, _ = dio_mod.dio(_t(xs), fs, 5.0)
    np.testing.assert_array_equal(tp.numpy(), t)
    f0 = f0.numpy()
    assert ((f0 > 0) == (f0_dio > 0)).mean() >= 0.98
    both = (f0 > 0) & (f0_dio > 0)
    assert both.mean() > 0.4
    assert np.median(np.abs(f0[both] - f0_dio[both]) / f0_dio[both]) <= 1e-4


@pytest.mark.parametrize("fs,dur", CASES)
def test_stonemask_matches_jax(fs, dur):
    xs, t, f0_dio, f0_sm, gs = _case(fs, dur)
    got = sm.stonemask(_t(xs), fs, _t(t), _t(f0_dio), grid_step=gs).numpy()
    np.testing.assert_array_equal(got > 0, f0_sm > 0)
    v = f0_sm > 0
    assert np.median(np.abs(got[v] - f0_sm[v]) / f0_sm[v]) <= 1e-4


def _cheaptrick_f64_reference(xs, t, f0, fs):
    N = jcfg.cheaptrick_fft_size(fs)
    return np.stack([np.asarray(jct.cheaptrick(
        jnp.asarray(x, jnp.float64), fs, jnp.asarray(t, jnp.float64),
        jnp.asarray(f, jnp.float64), N)) for x, f in zip(xs, f0)])


@pytest.mark.parametrize("fs,dur", CASES)
def test_cheaptrick_matches_jax(fs, dur):
    """float64: the port's formulation vs the JAX f64 path, median
    |dlog sp| <= 1e-6.  float32: median |dlog sp| vs the JAX f32 path
    <= 0.03, not 1e-3: both sit on f32 DFT rounding in the low-level bins,
    which the cepstral lifter spreads over the whole envelope (the JAX f32
    path is itself ~0.014 / 0.028 from f64 here); the port's own f32
    error against f64 must be no larger than 1.25x the JAX path's."""
    xs, t, _, f0, gs = _case(fs, dur)
    N = jcfg.cheaptrick_fft_size(fs)
    ref = _cheaptrick_f64_reference(xs, t, f0, fs)
    got64 = ct.cheaptrick(_t(xs, torch.float64), fs, _t(t, torch.float64),
                          _t(f0, torch.float64), N, grid_step=gs).numpy()
    assert np.median(np.abs(np.log(got64) - np.log(ref))) <= 1e-6
    got = ct.cheaptrick(_t(xs), fs, _t(t), _t(f0), N, grid_step=gs).numpy()
    want = np.stack([np.asarray(jct.cheaptrick(
        jnp.asarray(x), fs, jnp.asarray(t), jnp.asarray(f), N, grid_step=gs))
        for x, f in zip(xs, f0)])
    assert np.isfinite(got).all() and (got > 0).all()
    assert np.median(np.abs(np.log(got) - np.log(want))) <= 0.03
    e_port = np.median(np.abs(np.log(got) - np.log(ref)))
    e_jax = np.median(np.abs(np.log(want) - np.log(ref)))
    assert e_port <= 1.25 * e_jax


@pytest.mark.parametrize("fs,dur", CASES)
def test_d4c_matches_jax(fs, dur):
    """float64: the port's formulation vs the JAX f64 path, median |d ap|
    <= 1e-6.  float32: median |d ap| vs the JAX f32 path <= 1e-3 at
    16 kHz; at 48 kHz both f32 paths are ~3e-3 from f64 (f32 DFT rounding
    under the group-delay ratio), so there the port's f32 error against
    f64 must be no larger than 1.25x the JAX path's."""
    xs, t, _, f0, gs = _case(fs, dur)
    N = jcfg.cheaptrick_fft_size(fs)
    ref = np.stack([np.asarray(jd4c.d4c(
        jnp.asarray(x, jnp.float64), fs, jnp.asarray(t, jnp.float64),
        jnp.asarray(f, jnp.float64), N, 0.0, None)[0])
        for x, f in zip(xs, f0)])
    got64, _ = d4c_mod.d4c(_t(xs, torch.float64), fs, _t(t, torch.float64),
                           _t(f0, torch.float64), N, 0.0, grid_step=gs)
    assert np.median(np.abs(got64.numpy() - ref)) <= 1e-6
    got, p0 = d4c_mod.d4c(_t(xs), fs, _t(t), _t(f0), N, 0.0, grid_step=gs)
    got = got.numpy()
    jout = [jd4c.d4c(jnp.asarray(x), fs, jnp.asarray(t), jnp.asarray(f), N,
                     0.0, None, grid_step=gs) for x, f in zip(xs, f0)]
    want = np.stack([np.asarray(o[0]) for o in jout])
    np.testing.assert_allclose(p0.numpy(),
                               np.stack([np.asarray(o[1]) for o in jout]),
                               atol=1e-5)
    assert ((got >= 0) & (got <= 1)).all()
    if fs == 16000:
        assert np.median(np.abs(got - want)) <= 1e-3
    e_port = np.median(np.abs(got - ref))
    e_jax = np.median(np.abs(want - ref))
    assert e_port <= 1.25 * e_jax


def _synth_inputs(fs, T, seed, unvoiced=True):
    rng = np.random.default_rng(seed)
    N = jcfg.cheaptrick_fft_size(fs)
    half = N // 2
    f0 = 150.0 + 60.0 * np.sin(np.arange(T) / 7.0)
    if unvoiced:
        f0[T // 3:T // 3 + 8] = 0.0
        f0[-5:] = 0.0
    freq = np.arange(half + 1) / N * fs
    sp = (np.exp(-freq[None, :] / 1500.0)
          * (1.0 + 0.5 * rng.random((T, 1))) + 1e-6)
    ap = np.clip(freq[None, :] / (fs / 2) + 0.1 * rng.random((T, 1)),
                 0.0, 1.0)
    return f0, sp, ap, N


@pytest.mark.parametrize("fs,unvoiced", [(16000, False), (48000, False),
                                         (16000, True), (48000, True)])
def test_synthesis_f64_matches_jax(fs, unvoiced):
    """Fast-path synthesis in float64 with injected f0 / sp / ap / noise.

    Voiced contours: vs JAX synthesis(..., exact_phase=False), abs <= 1e-9.
    Contours with unvoiced frames: their 500 Hz default puts phase wraps
    exactly on sample boundaries (500 * N / fs is integral), where the
    summation order of the phase cumsum decides whether a pulse fires.
    The port's cumsum (sequential on the CPU) then matches the JAX
    left-fold path (exact_phase=True), while the jitted JAX fast path
    fires other pulses; so these cases are held against exact_phase=True,
    abs <= 1e-6 (its FFTs and exact interpolation differ in rounding)."""
    T = 60 if fs == 16000 else 24
    yl = int((T - 1) * 5.0 / 1000.0 * fs) + 1
    ins = [_synth_inputs(fs, T, s, unvoiced) for s in (0, 1)]
    N = ins[0][3]
    noise = np.random.default_rng(9).standard_normal(
        (2, syn.synthesis_stream_len(yl)))
    want = np.stack([np.asarray(jsyn.synthesis(
        jnp.asarray(f0), jnp.asarray(sp), jnp.asarray(ap), N, 5.0, fs, yl,
        jnp.asarray(nz), exact_phase=unvoiced))
        for (f0, sp, ap, _), nz in zip(ins, noise)])
    got = syn.synthesis(*(_t(np.stack([i[k] for i in ins]), torch.float64)
                          for k in range(3)), N, 5.0, fs, yl,
                        _t(noise, torch.float64)).numpy()
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 if unvoiced else 1e-9)


def test_count_pulses_matches_jax():
    f0, _, _, N = _synth_inputs(16000, 60, 2)
    yl = int(59 * 5.0 / 1000.0 * 16000) + 1
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64,
                                                   jnp.float64)):
        got = syn.count_pulses(_t(f0[None], dt), 5.0, 16000, yl, N)
        want = jsyn.count_pulses(jnp.asarray(f0, jdt), 5.0, 16000, yl, N)
        assert abs(int(got[0]) - int(want)) <= (0 if dt == torch.float64
                                                else 2)
