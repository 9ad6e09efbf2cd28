"""The port's parity synthesis (float64, the exact phase fold, FFT
responses, the reference's noise stream) against the JAX package's, on
the CPU (the plain PyTorch twins of K9-K12 and K30).

Inputs are made with numpy from seeds at 16 kHz, 0.4 s, N = 1024.  The
JAX exact synthesis of each input is computed once per module (one
compile, about 1.5 s on the CPU).  Bounds: pulse indices equal; the
waveform within 1e-10 abs of JAX's `synthesis(..., exact_phase=True)`
(ARCHITECTURE.md N9 holds JAX to the C++ at 1.7e-12; the port's FFTs and
sums round within ~1e-14 of JAX's here); decode within 1e-10 relative;
the synth command's int16 samples equal.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import cli as jcli
from hts_train_world_tpu import vocoder as jvocoder
from hts_train_world_tpu.io import wavio as jwavio
from hts_train_world_tpu.io import worldparam as jworldparam
from hts_train_world_tpu.ops import prims as jprims
from hts_train_world_tpu.ops import rand as jrand
from hts_train_world_tpu.ops import synthesis as jsyn
from hts_train_world_tpu_torch import cli, vocoder
from hts_train_world_tpu_torch.features import decode
from hts_train_world_tpu_torch.io import rawio, wavio, worldparam
from hts_train_world_tpu_torch.ops import prims, rand
from hts_train_world_tpu_torch.ops import synthesis as syn

FS, N, FP, T = 16000, 1024, 5.0, 81
YL = int((T - 1) * FP / 1000.0 * FS) + 1
KINDS = ("voiced", "unvoiced_runs", "all_unvoiced")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small ops, which the
    default thread pool slows many-fold when test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(kind, seed):
    """f0 / sp / ap (float64): unvoiced runs put the 500 Hz default's
    wraps exactly on sample boundaries (500 N / fs = 32); ap reaches its
    0.999999999999 clip near Nyquist."""
    rng = np.random.default_rng(seed)
    half = N // 2
    f0 = 150.0 + 60.0 * np.sin(np.arange(T) / 7.0 + seed)
    if kind == "unvoiced_runs":
        f0[10:35] = 0.0
        f0[55:70] = 0.0
    elif kind == "all_unvoiced":
        f0[:] = 0.0
    freq = np.arange(half + 1) / N * FS
    sp = (np.exp(-freq[None, :] / 1500.0)
          * (1.0 + 0.5 * rng.random((T, 1))) + 1e-6)
    ap = np.clip(freq[None, :] / (FS / 2) + 0.1 * rng.random((T, 1)),
                 0.0, 1.0)
    return f0, sp, ap


_JAX = {}


def _jax_exact(f0, sp, ap):
    key = (f0.tobytes(), sp.tobytes(), ap.tobytes())
    if key not in _JAX:
        stream = jrand.randn_stream(jsyn.synthesis_stream_len(YL))
        _JAX[key] = np.asarray(jsyn.synthesis(
            jnp.asarray(f0), jnp.asarray(sp), jnp.asarray(ap), N, FP, FS,
            YL, jnp.asarray(stream), exact_phase=True))
    return _JAX[key]


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_randn_stream_bit_equal_to_jax():
    """The first 1e5 draws equal the JAX package's stream bit for bit; a
    short request after a long one is a prefix view of the kept stream."""
    want = jrand.randn_stream(100000)
    got = rand.randn_stream(100000)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    short = rand.randn_stream(257)
    np.testing.assert_array_equal(short.numpy(), want[:257])
    assert short.data_ptr() == rand.randn_stream(100000).data_ptr()
    np.testing.assert_array_equal(rand.randn_stream_np(64), want[:64])


def test_fma_rounds_once():
    """prims.fma against the exact rational a b + c, rounded once, on the
    frame lerp's operands near the ap clip and on random ones."""
    rng = np.random.default_rng(7)
    f = rng.random(3000)
    a = np.concatenate([np.full(1500, 0.999999999999), rng.random(1500)])
    b = np.concatenate([0.999999999999 - 1e-3 * rng.random(1500),
                        rng.random(1500) * 1e4])
    c = a * (1.0 - f)
    got = prims.fma(_t(f), _t(b), _t(c)).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(f, b, c)]
    np.testing.assert_array_equal(got, want)


def test_minimum_phase_log_matches_jax():
    """exp(D / N) from prims.minimum_phase_log against the JAX package's
    minimum_phase_spectrum (both FFTs), rel <= 1e-13."""
    rng = np.random.default_rng(3)
    log_half = np.log(rng.random((4, N // 2 + 1)) + 1e-3) / 2.0
    re, im = prims.minimum_phase_log(_t(log_half), N)
    got = np.exp(re.numpy() + 1j * im.numpy())
    want = np.asarray(jprims.minimum_phase_spectrum(jnp.asarray(log_half),
                                                    N))
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


@pytest.mark.parametrize("kind", KINDS)
def test_exact_synthesis_matches_jax(kind):
    """Two utterances in one batched call (one view of the reseeded
    stream for both): the time base fires JAX's exact-path pulses, and
    each waveform is within 1e-10 abs of JAX's synthesis(...,
    exact_phase=True)."""
    ins = [_params(kind, s) for s in (0, 1)]
    stream = rand.randn_stream(syn.synthesis_stream_len(YL))
    f0, sp, ap = (_t(np.stack([i[k] for i in ins])) for k in range(3))
    P = syn.default_max_pulses(YL, FS)
    pl = syn.time_base(f0, FP, FS, YL, N, P)
    for u, (jf0, _, _) in enumerate(ins):
        jump = jsyn._time_base(jnp.asarray(jf0), FP, FS, YL, N, True)[3]
        n = int(jnp.sum(jump))
        want = np.asarray(jprims.compact_indices(jump, P, YL - 2))[:n]
        assert int(pl.n[u]) == n
        np.testing.assert_array_equal(pl.pidx[u, :n].numpy(), want)
    got = syn.synthesis(f0, sp, ap, N, FP, FS, YL,
                        stream[None].expand(2, -1), exact=True)
    for u, i in enumerate(ins):
        want = _jax_exact(*i)
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got[u].numpy(), want, rtol=0, atol=1e-10)


def test_exact_path_rounds_the_frame_lerp_as_jax_does():
    """Where ap sits at its 0.999999999999 clip, 1 - apr^2 magnifies the
    last bit of the frame lerp ~1e12-fold: the plain form (1 - f) a + f b
    leaves JAX's exact path by more than 1e-9, the fma form K10 and its
    twin take for the exact path stays within 1e-10."""
    f0, sp, ap = _params("unvoiced_runs", 0)
    stream = rand.randn_stream(syn.synthesis_stream_len(YL))[None]
    pl = syn.trim_pulses(syn.time_base(_t(f0)[None], FP, FS, YL, N,
                                       syn.default_max_pulses(YL, FS)))
    want = _jax_exact(f0, sp, ap)
    err = {}
    for fused in (False, True):
        lp, la, nz, unv = syn.pulse_spectra_plain(
            _t(sp)[None], _t(ap)[None], stream, pl.pulse_time, pl.vuv,
            pl.noise_size, pl.noise_off, FP, N, exact=fused)
        per, aper = syn.responses_exact(lp, la, nz, pl.time_shift, FS, N)
        y = syn.overlap_add_plain(per, aper, unv, pl.pidx, pl.noise_size,
                                  pl.n, YL)[0].numpy()
        err[fused] = np.abs(y - want).max()
    assert err[False] > 1e-9 and err[True] <= 1e-10, err


def test_vocoder_synthesize_parity_matches_jax():
    """vocoder.synthesize(parity=True, device='cpu') against the JAX
    vocoder.synthesize (parity=True) on the same parameters, 1e-10."""
    f0, sp, ap = _params("unvoiced_runs", 2)
    got = vocoder.synthesize(f0, sp, ap, FS, N, FP, parity=True,
                             device="cpu")
    want = np.asarray(jvocoder.synthesize(jnp.asarray(f0), jnp.asarray(sp),
                                          jnp.asarray(ap), FS, N, FP))
    assert got.dtype == torch.float64 and got.shape == (YL,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def _features(bap_dim, seed):
    """lf0 / mgc / bap of the size and scale the encoder writes, with
    unvoiced runs (float32, as the files hold them)."""
    rng = np.random.default_rng(seed)
    mgc = rng.standard_normal((T, 50)) / (1.0 + np.arange(50)) ** 1.2
    mgc[:, 0] += 13.0
    bap = 0.5 * rng.standard_normal((T, bap_dim)) / (1.0 + np.arange(bap_dim))
    bap[:, 0] -= 2.0
    lf0 = np.log(150.0 + 60.0 * np.sin(np.arange(T) / 7.0))
    lf0[12:30] = 0.0
    lf0[-6:] = 0.0
    return tuple(v.astype(np.float32) for v in (lf0, mgc, bap))


@pytest.mark.parametrize("bap_dim", [24, 25])
def test_decode_features_f64_matches_jax(bap_dim):
    """The synth CLI's decode of float32 features read into float64 (the
    parity path's input), against JAX cli.decode_features, rel <= 1e-10
    for even and odd bap dims."""
    feats = _features(bap_dim, bap_dim)
    got = decode.decode_features(*(_t(v) for v in feats), FS, N)
    want = jcli.decode_features(*(jnp.asarray(v.astype(np.float64))
                                  for v in feats), FS, N)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=0)


@pytest.mark.parametrize("mgc_dim", [50, 0])
def test_cli_synth_default_is_parity_and_matches_jax(mgc_dim, tmp_path):
    """`synth` without --f32 (the compressed lf0/mgc/bap files, or raw
    f0/sp/ap files with mgcdim 0) against the JAX CLI's synth_main under
    x64: the int16 samples are equal."""
    if mgc_dim:
        vals = _features(25, 4)
        dims = ["50", "25"]
    else:
        f0, sp, ap = _params("unvoiced_runs", 5)
        vals = tuple(v.astype(np.float32) for v in (f0, sp, ap))
        dims = ["0"]
    paths = [str(tmp_path / f"in.{k}") for k in ("lf0", "mgc", "bap")]
    for p, v in zip(paths, vals):
        rawio.write_f32(p, v)
    out, jout = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    args = [*paths, out, "5.0", str(N), str(FS), *dims]
    cli.main(["synth", *args, "--device", "cpu"])
    jcli.synth_main([*paths, jout, "5.0", str(N), str(FS), *dims])
    got, gfs = wavio.wavread(out)
    want, wfs = jwavio.wavread(jout)
    assert gfs == wfs == FS and len(got) == YL
    np.testing.assert_array_equal(wavio.float_to_int16(got),
                                  jwavio.float_to_int16(want))
    assert np.abs(got).max() > 0.05


def test_worldparam_files_are_byte_equal(tmp_path):
    """F0 / SPEC / AP written by both packages are byte-equal, and each
    package reads the other's."""
    f0, sp, ap = _params("voiced", 6)
    for name, (fn, jfn, data, extra) in {
            "f0": (worldparam.write_f0, jworldparam.write_f0, f0, ()),
            "sp": (worldparam.write_spectral_envelope,
                   jworldparam.write_spectral_envelope, sp, (N, FS)),
            "ap": (worldparam.write_aperiodicity,
                   jworldparam.write_aperiodicity, ap, (N, FS))}.items():
        a, b = str(tmp_path / f"port.{name}"), str(tmp_path / f"jax.{name}")
        fn(a, _t(data) if name != "f0" else data, FP, *extra)
        jfn(b, data, FP, *extra)
        assert open(a, "rb").read() == open(b, "rb").read()
    _, rf0, rfp = worldparam.read_f0(str(tmp_path / "jax.f0"))
    rsp, _, rfft, rfs = worldparam.read_spectral_envelope(
        str(tmp_path / "jax.sp"))
    np.testing.assert_array_equal(rf0, f0)
    np.testing.assert_array_equal(rsp, sp)
    assert (rfp, rfft, rfs) == (FP, N, FS)


def test_worldparam_round_trip_through_parity_synthesis(tmp_path):
    """Parameters written and read back by the port, synthesised by the
    parity path, against the JAX package's synthesis of the same
    parameters read by the JAX package: 1e-10."""
    f0, sp, ap = _params("unvoiced_runs", 8)
    p = {k: str(tmp_path / f"x.{k}") for k in ("f0", "sp", "ap")}
    worldparam.write_f0(p["f0"], f0, FP)
    worldparam.write_spectral_envelope(p["sp"], sp, FP, N, FS)
    worldparam.write_aperiodicity(p["ap"], ap, FP, N, FS)
    _, rf0, fp = worldparam.read_f0(p["f0"])
    rsp, _, fft, fs = worldparam.read_spectral_envelope(p["sp"])
    rap = worldparam.read_aperiodicity(p["ap"])[0]
    got = vocoder.synthesize(rf0, rsp, rap, fs, fft, fp, parity=True,
                             device="cpu")
    _, jf0, _ = jworldparam.read_f0(p["f0"])
    jsp = jworldparam.read_spectral_envelope(p["sp"])[0]
    jap = jworldparam.read_aperiodicity(p["ap"])[0]
    np.testing.assert_allclose(got.numpy(), _jax_exact(jf0, jsp, jap),
                               rtol=0, atol=1e-10)


def test_parity_analysis_and_cli_analysis_still_raise(tmp_path):
    """Parity analysis is ROADMAP Queue A 5's analysis half: analyze,
    copy_synthesis and `analysis` without --f32 raise, naming it."""
    x = np.zeros(1600, np.float32)
    for call in (vocoder.analyze, vocoder.copy_synthesis):
        with pytest.raises(NotImplementedError, match="analysis half"):
            call(x, FS, device="cpu")
    wav = str(tmp_path / "x.wav")
    wavio.wavwrite(x, FS, wav)
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        cli.main(["analysis", wav, *(str(tmp_path / f"o.{k}")
                                     for k in ("lf0", "mgc", "bap")),
                  "--device", "cpu"])
