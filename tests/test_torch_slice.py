"""The PyTorch port's main path as a whole: batched copy-synthesis against
the JAX package on the CPU, the vocoder API, device handling, and the
port's independence from JAX."""
import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import vocoder as jvocoder
from hts_train_world_tpu.parallel import batch as jbatch
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels, vocoder
from hts_train_world_tpu_torch.ops import postfilter
from hts_train_world_tpu_torch.ops import synthesis as syn
from hts_train_world_tpu_torch.parallel import batch
from hts_train_world_tpu_torch.runtime import pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 16000


def _corpus(B, L, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / FS
    xs = []
    for i in range(B):
        ph = np.cumsum(2 * np.pi * (170.0 + 30.0 * i)
                       * (1 + 0.02 * np.sin(2 * np.pi * 5 * t)) / FS)
        x = 0.6 * np.sin(ph) + 0.25 * np.sin(2 * ph) + 0.1 * np.sin(3 * ph)
        x[L // 2:L // 2 + L // 10] = 0.0                  # a pause
        xs.append(x + 0.01 * rng.standard_normal(L))
    return np.stack(xs).astype(np.float32)


@pytest.fixture(scope="module")
def copy_synth_pair():
    xs = _corpus(2, 8000)
    T = cfg.samples_for_dio(FS, xs.shape[1], 5.0)
    yl = cfg.y_length_for(T, 5.0, FS)
    noise = np.random.default_rng(5).standard_normal(
        (2, syn.synthesis_stream_len(yl))).astype(np.float32)
    j = [np.asarray(v) for v in jbatch.batch_copy_synth(
        jnp.asarray(xs), FS, noise=jnp.asarray(noise))]
    kernels.reset_counts()
    p = [v.numpy() for v in batch.batch_copy_synth(xs, FS, noise=noise,
                                                   device="cpu")]
    return j, p, yl


def test_copy_synth_outputs_valid(copy_synth_pair):
    """The fast-path gates of tests/test_fast_stress.py on the port's
    output."""
    _, (t, f0, sp, ap, y), yl = copy_synth_pair
    assert y.shape == (2, yl) and sp.shape == ap.shape == (2, f0.shape[1],
                                                         513)
    for v in (f0, sp, ap, y):
        assert np.isfinite(v).all()
    assert (sp > 0).all() and (ap >= 0).all() and (ap <= 1).all()
    assert 0.1 < np.abs(y).max() < 4.0


def test_copy_synth_matches_jax(copy_synth_pair):
    """V/UV agreement > 0.9, f0 median rel < 1e-3, median |dlog sp| < 0.1
    on bins within 60 dB of each frame's peak (test_fast_stress.py gates),
    per-utterance energy of y within 2%, pulse counts within +-2."""
    (jt, jf0, jsp, jap, jy), (t, f0, sp, ap, y), yl = copy_synth_pair
    np.testing.assert_allclose(t, jt)
    assert ((f0 > 0) == (jf0 > 0)).mean() > 0.9
    both = (f0 > 0) & (jf0 > 0)
    assert np.median(np.abs(f0[both] - jf0[both]) / jf0[both]) < 1e-3
    live = jsp > jsp.max(axis=2, keepdims=True) * 1e-6
    assert np.median(np.abs(np.log(sp[live]) - np.log(jsp[live]))) < 0.1
    assert np.median(np.abs(ap - jap)) < 0.01
    e, je = (y.astype(np.float64) ** 2).sum(1), (jy.astype(np.float64)
                                                 ** 2).sum(1)
    np.testing.assert_allclose(e, je, rtol=0.02)
    N = cfg.cheaptrick_fft_size(FS)
    n_port = syn.count_pulses(torch.as_tensor(f0), 5.0, FS, yl, N).numpy()
    n_jax = np.array([int(jbatch.syn.count_pulses(jnp.asarray(f), 5.0, FS,
                                                   yl, N)) for f in jf0])
    assert (np.abs(n_port - n_jax) <= 2).all()


def _hostile(name, L, seed=0):
    """tests/test_fast_stress.py's hostile inputs."""
    rng = np.random.default_rng(seed)
    t = np.arange(L) / FS
    ph = np.cumsum(2 * np.pi * 180 * (1 + 0.02 * np.sin(2 * np.pi * 4 * t))
                   / FS)
    harm = 0.8 * np.sin(ph) + 0.5 * np.sin(2 * ph) + 0.3 * np.sin(3 * ph)
    if name == "silence":
        return np.zeros(L)
    if name == "clicks":
        x = np.zeros(L)
        x[::FS // 50] = 0.9 * np.sign(rng.standard_normal(len(x[::FS // 50])))
        return x
    if name == "clipped":
        return np.clip(2.5 * harm, -1.0, 1.0)
    return 0.5 * rng.standard_normal(L)                      # noise


@pytest.mark.parametrize("name", ["silence", "clicks", "clipped", "noise"])
def test_analyze_hostile_inputs(name):
    """The port's fast path on silence, clicks, clipped harmonics and
    wideband noise: finite, in range, and V/UV agreement with the JAX f32
    fast path above test_fast_stress.py's bars (0.9 tonal, 0.7 else)."""
    x = _hostile(name, 4800).astype(np.float32)
    a = vocoder.analyze(x, FS, parity=False, device="cpu")
    j = jvocoder.analyze(jnp.asarray(x), FS, parity=False)
    sp, ap, f0 = (v.numpy() for v in (a.spectrogram, a.aperiodicity, a.f0))
    assert np.isfinite(sp).all() and np.isfinite(ap).all()
    assert np.isfinite(f0).all() and (sp > 0).all()
    assert (ap >= 0).all() and (ap <= 1).all()
    agree = ((f0 > 0) == (np.asarray(j.f0) > 0)).mean()
    assert agree > (0.9 if name == "clipped" else 0.7)
    y = vocoder.synthesize(a.f0, a.spectrogram, a.aperiodicity, FS,
                           parity=False, device="cpu")
    assert torch.isfinite(y).all() and y.abs().max() < 4.0


def test_cpu_path_launches_no_kernel(copy_synth_pair):
    assert sum(kernels.launches.values()) == 0
    assert kernels.record is None


def test_pulse_bucket():
    assert batch._pulse_bucket(1, 10_000) == 128
    assert batch._pulse_bucket(129, 10_000) == 256
    assert batch._pulse_bucket(5000, 700) == 700


@pytest.mark.parametrize("f0_scale,formant_ratio", [(1.0, 1.0), (1.2, 0.9),
                                                    (0.8, 1.1)])
def test_copy_synthesis_api_matches_jax_knobs(f0_scale, formant_ratio):
    """vocoder.copy_synthesis on the CPU; its F0 / formant knobs agree
    with the JAX modify_parameters on the same analysis."""
    x = _corpus(1, 6400)[0]
    a, y = vocoder.copy_synthesis(x, FS, parity=False, f0_scale=f0_scale,
                                  formant_ratio=formant_ratio, device="cpu")
    assert y.shape == (cfg.y_length_for(a.f0.shape[0], 5.0, FS),)
    assert torch.isfinite(y).all() and y.abs().max() > 0.05
    f0, sp = vocoder.modify_parameters(a.f0, a.spectrogram, FS, f0_scale,
                                       formant_ratio)
    jf0, jsp = jvocoder.modify_parameters(
        jnp.asarray(a.f0.numpy()), jnp.asarray(a.spectrogram.numpy()), FS,
        f0_scale, formant_ratio)
    np.testing.assert_allclose(f0.numpy(), np.asarray(jf0), rtol=1e-6)
    np.testing.assert_allclose(sp.numpy(), np.asarray(jsp), rtol=1e-4)


def test_analyze_options_match_jax():
    """vocoder.analyze with a non-default F0 range, q1 and fft size vs the
    JAX vocoder.analyze(parity=False) on the same float32 waveform."""
    x = _corpus(1, 6400, seed=2)[0]
    kw = dict(q1=-0.1, fft_size=2048, f0_floor=60.0, f0_ceil=600.0)
    a = vocoder.analyze(x, FS, parity=False, device="cpu", **kw)
    j = jvocoder.analyze(jnp.asarray(x), FS, parity=False, **kw)
    assert a.fft_size == j.fft_size == 2048
    jf0, f0 = np.asarray(j.f0), a.f0.numpy()
    assert ((f0 > 0) == (jf0 > 0)).mean() >= 0.98
    both = (f0 > 0) & (jf0 > 0)
    assert np.median(np.abs(f0[both] - jf0[both]) / jf0[both]) < 1e-4
    jsp = np.asarray(j.spectrogram)
    assert np.median(np.abs(np.log(a.spectrogram.numpy())
                            - np.log(jsp))) < 0.03
    assert np.median(np.abs(a.aperiodicity.numpy()
                            - np.asarray(j.aperiodicity))) < 1e-3


@pytest.mark.parametrize("call", ["analyze", "synthesize", "copy_synthesis"])
def test_parity_mode_is_a_later_slice(call):
    """Parity mode, each entry point at its default (parity=True; the
    name is kept from when analysis raised): vocoder.synthesize is the
    JAX package's on the reference's noise stream within 1e-10;
    vocoder.analyze's f0 the JAX package's within 1e-9, and
    copy_synthesis' waveform the JAX package's parity synthesis of the
    port's own analysis within 1e-10 (tests/test_torch_parity_analysis.py
    holds every part)."""
    if call == "synthesize":
        args = (np.full(11, 100.0), np.ones((11, 513)),
                np.full((11, 513), 0.5), FS)
        y = vocoder.synthesize(*args, device="cpu")
        want = np.asarray(jvocoder.synthesize(*(jnp.asarray(a)
                                                for a in args[:3]), FS))
        assert y.dtype == torch.float64 and np.abs(want).max() > 0.01
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-10)
        return
    t = np.arange(4000) / FS
    x = 0.5 * np.sin(2 * np.pi * 180.0 * t) + 0.2 * np.sin(
        2 * np.pi * 360.0 * t)
    if call == "analyze":
        got = vocoder.analyze(x, FS, device="cpu").f0.numpy()
        want = np.asarray(jvocoder.analyze(jnp.asarray(x), FS).f0)
        assert (want > 0).sum() > 5
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
        return
    a, y = vocoder.copy_synthesis(x, FS, device="cpu")
    want = jvocoder.synthesize(*(jnp.asarray(v.numpy()) for v in (
        a.f0, a.spectrogram, a.aperiodicity)), FS)
    assert y.dtype == torch.float64 and np.abs(want).max() > 0.05
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


ENTRY_POINTS = {
    "batch_analyze": lambda d: batch.batch_analyze(_corpus(1, 1600), FS),
    "batch_copy_synth": lambda d: batch.batch_copy_synth(_corpus(1, 1600),
                                                         FS),
    "SingingPipeline": lambda d: pipeline.SingingPipeline(
        pipeline.PipelineConfig(str(d))),
    "mspf_stats": lambda d: postfilter.mspf_stats([np.zeros((30, 2))]),
    "synthesize_parity": lambda d: vocoder.synthesize(
        np.full(11, 100.0), np.ones((11, 513)), np.ones((11, 513)), FS),
}


@pytest.mark.parametrize("call", list(ENTRY_POINTS))
def test_default_device_is_the_card(call, tmp_path):
    """Entry points default to device='cuda' and raise without a card
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert pipeline.PipelineConfig(str(tmp_path)).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[call](tmp_path)


def test_port_imports_nothing_of_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|hts_train_world_tpu)\b(?!_)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "hts_train_world_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for mod in ("features/encode.py", "features/windows.py", "ops/codec.py",
                "ops/mlpg.py", "parallel/bucketing.py",
                "parallel/features.py", "features/decode.py", "cli.py",
                "io/rawio.py", "io/wavio.py", "ops/synthesis.py",
                "features/labels.py", "features/lowess.py",
                "features/vibrato.py", "features/htk.py", "features/corpus.py",
                "features/labelgen.py", "io/loader.py", "runtime/native.py",
                "runtime/checkpoint.py", "runtime/pipeline.py",
                "ops/stonemask.py", "ops/cheaptrick.py", "ops/d4c.py",
                "ops/postfilter.py", "ops/rand.py", "ops/synthesis_rt.py",
                "io/worldparam.py"):
        assert os.path.join(REPO, "hts_train_world_tpu_torch", mod) in files
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device, and where it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=120, cwd=os.path.dirname(script))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
