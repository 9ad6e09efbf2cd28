"""The port's StreamingSynthesizer against the JAX package's, and against
the exact-path batch synthesis of both packages, on the CPU (the twins of
K9's chunk mode, K10, K30 and K11).

Inputs are made with numpy from seeds at 16 kHz, 0.4 s, N = 1024, fed a
few frames at a time; the noise is the reference's reseeded stream.  The
bound is tests/test_synthesis_rt.py's: 1e-10 abs on every emitted sample.

The JAX synthesizer is fed all frames before its first read (its jitted
`_chunk_pulses` compiles once per frame count).  As compiled by this JAX
(0.9.0, CPU), it carries a wrong phase out of a chunk in which an
unvoiced run turns voiced (the last phase of its own scan, evaluated
without jit, is right), and its stream then leaves its own batch
synthesis; so it is compared on contours that are voiced throughout or
turn unvoiced, and the contours with unvoiced runs are held to both
packages' batch synthesis (ROADMAP Queue C).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu.ops import rand as jrand
from hts_train_world_tpu.ops import synthesis as jsyn
from hts_train_world_tpu.ops.synthesis_rt import (
    StreamingSynthesizer as JaxStreaming)
from hts_train_world_tpu_torch.ops import rand
from hts_train_world_tpu_torch.ops import synthesis as syn
from hts_train_world_tpu_torch.ops.synthesis_rt import StreamingSynthesizer

FS, N, FP, T = 16000, 1024, 5.0, 81
YL = int((T - 1) * FP / 1000.0 * FS) + 1
SIZES = (64, 256, 2000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small ops, which the
    default thread pool slows many-fold when test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(kind, seed=0):
    rng = np.random.default_rng(seed)
    half = N // 2
    f0 = 150.0 + 60.0 * np.sin(np.arange(T) / 7.0 + seed)
    if kind == "unvoiced_runs":
        f0[10:35] = 0.0
        f0[55:70] = 0.0
    elif kind == "unvoiced_end":
        f0[50:] = 0.0
    freq = np.arange(half + 1) / N * FS
    sp = (np.exp(-freq[None, :] / 1500.0)
          * (1.0 + 0.5 * rng.random((T, 1))) + 1e-6)
    ap = np.clip(freq[None, :] / (FS / 2) + 0.1 * rng.random((T, 1)),
                 0.0, 1.0)
    return f0, sp, ap


def _drive(s, params, step=16):
    """Feed `step` frames whenever starved (all at once for step 0) and
    read until the frames run out."""
    f0, sp, ap = params
    out, fed, total = [], 0, len(f0)
    if not step:
        s.add_parameters(f0, sp, ap)
        fed = total
    while fed < total or not s.starved:
        if s.starved and fed < total:
            n = min(step, total - fed)
            s.add_parameters(f0[fed:fed + n], sp[fed:fed + n],
                             ap[fed:fed + n])
            fed += n
            continue
        chunk = s.read()
        if chunk is None:
            break
        out.append(np.asarray(chunk))
    return np.concatenate(out) if out else np.zeros(0)


_CACHE = {}


def _batch(kind):
    """(JAX exact batch, the port's exact batch) of one contour."""
    if kind not in _CACHE:
        f0, sp, ap = _params(kind)
        stream = jrand.randn_stream(jsyn.synthesis_stream_len(YL))
        want = np.asarray(jsyn.synthesis(
            jnp.asarray(f0), jnp.asarray(sp), jnp.asarray(ap), N, FP, FS, YL,
            jnp.asarray(stream), exact_phase=True))
        ours = syn.synthesis(*(torch.as_tensor(v)[None] for v in (f0, sp, ap)),
                             N, FP, FS, YL, rand.randn_stream(len(stream))[None],
                             exact=True)[0].numpy()
        _CACHE[kind] = (want, ours)
    return _CACHE[kind]


def _port(bs, params, step=16):
    s = StreamingSynthesizer(FS, FP, N, buffer_size=bs, device="cpu",
                             noise_stream=rand.randn_stream(
                                 jsyn.synthesis_stream_len(YL)))
    return _drive(s, params, step)


@pytest.mark.parametrize("bs", SIZES)
def test_streaming_matches_both_batches(bs):
    """Contours with unvoiced runs (500 Hz wraps on sample boundaries),
    fed 16 frames at a time: every emitted sample within 1e-10 of the
    port's and of JAX's exact batch synthesis."""
    want, ours = _batch("unvoiced_runs")
    y = _port(bs, _params("unvoiced_runs"))
    assert YL // 2 < len(y) <= YL
    np.testing.assert_allclose(y, ours[:len(y)], rtol=0, atol=1e-10)
    np.testing.assert_allclose(y, want[:len(y)], rtol=0, atol=1e-10)


@pytest.mark.parametrize("bs", SIZES)
@pytest.mark.parametrize("kind", ["voiced", "unvoiced_end"])
def test_streaming_matches_jax_streaming(kind, bs):
    """Against JAX's StreamingSynthesizer on the same stream (all frames
    before its first read): the same number of samples, within 1e-10."""
    params = _params(kind)
    j = JaxStreaming(FS, FP, N, buffer_size=bs,
                     noise_stream=jrand.randn_stream(
                         jsyn.synthesis_stream_len(YL)))
    want = _drive(j, params, step=0)
    got = _port(bs, params)
    assert len(got) == len(want) > YL // 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, _batch(kind)[1][:len(got)], rtol=0,
                               atol=1e-10)


def test_chunk_pulses_carry_the_state():
    """K9's chunk mode over consecutive chunks fires the batch time base's
    pulses (every pulse but the pending one), hands the pending pulse on,
    and its stream base is the batch's noise offset."""
    f0 = torch.as_tensor(_params("unvoiced_runs")[0])
    P = syn.default_max_pulses(YL, FS)
    pl = syn.time_base(f0[None], FP, FS, YL, N, P)
    want = pl.pidx[0, :int(pl.n[0])].tolist()
    sd, si = syn.chunk_state("cpu")
    got, chunk = [], 256
    for s0 in range(0, YL - chunk, chunk):
        c = syn.chunk_pulses(f0, s0, chunk, int(chunk * 1200 / FS) + 18, FP,
                             FS, N, sd, si)
        n_s = int(c.counts[1])
        got += c.pidx[0, :n_s].tolist()
        assert int(si[0]) == int(c.pidx[0, int(c.counts[0]) - 1])
        k = len(got)
        assert int(si[1]) == int(pl.noise_off[0, k])
    assert got == want[:len(got)] and len(got) > 0.8 * len(want)


def test_streaming_api():
    """starved until a chunk's frames are in, read() None then; reads
    return float64 tensors on the device, the first N samples of latency
    held back; refresh() starts over and gives the same stream."""
    params = _params("voiced")
    s = StreamingSynthesizer(FS, FP, N, buffer_size=256, device="cpu",
                             noise_stream=rand.randn_stream(YL + 16))
    assert s.starved and s.read() is None
    s.add_parameters(*(v[:20] for v in params))
    first = s.read()
    assert isinstance(first, torch.Tensor) and first.dtype == torch.float64
    assert first.device.type == "cpu" and first.numel() == 0  # latency N
    a = np.concatenate([first.numpy(), _drive(s, tuple(v[20:]
                                                       for v in params))])
    s.refresh()
    assert s.starved
    np.testing.assert_array_equal(a, _drive(s, params))


def test_streaming_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSynthesizer(FS)
