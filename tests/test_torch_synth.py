"""The port's synth path against the JAX package, on the CPU: the codec's
decoding half, the feature decode, the synth lane (decode -> count ->
synthesis), `batch_synth`, the f32 round trip from a waveform and back,
the `analysis` / `synth` command lines and their file I/O, and device
handling."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import cli as jcli
from hts_train_world_tpu import vocoder as jvocoder
from hts_train_world_tpu.io import rawio as jrawio
from hts_train_world_tpu.io import wavio as jwavio
from hts_train_world_tpu.ops import codec as jcodec
from hts_train_world_tpu.ops import synthesis as jsyn
from hts_train_world_tpu_torch import cli, kernels, vocoder
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch.features import decode, encode
from hts_train_world_tpu_torch.io import rawio, wavio
from hts_train_world_tpu_torch.ops import codec
from hts_train_world_tpu_torch.ops import synthesis as syn
from hts_train_world_tpu_torch.parallel import batch, features

FP = 5.0


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# the codec's decoding half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", [16000, 48000])
@pytest.mark.parametrize("n_dims", [50, 25])
def test_decoding_tables_bit_equal(fs, n_dims):
    N = cfg.cheaptrick_fft_size(fs)
    got = codec._decoding_tables(fs, N, n_dims)
    want = jcodec._decoding_tables(fs, N, n_dims)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("m1,m2,a", [(24, 512, -0.55), (23, 1024, -0.55),
                                     (4, 9, 0.42), (0, 3, -0.55)])
def test_freqt_matrix_bit_equal(m1, m2, a):
    got, want = codec.freqt_matrix(m1, m2, a), jcodec.freqt_matrix(m1, m2, a)
    assert got.shape == (m1 + 1, m2 + 1) and np.array_equal(got, want)


def _coded(shape, n_dims, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(shape + (n_dims,)) / (1.0 + np.arange(n_dims))
    c[..., 0] += 1.5
    return c


def _numpy_decode(c, fs, N, n_dims):
    """DecodeSpectralEnvelope in float64 numpy from the port's decoding
    tables (bit-equal to the JAX package's): IDCT, boundary duplication,
    the Hz-axis lerp, exp(x / (N/2))."""
    k, s, Dinv = codec._decoding_tables(fs, N, n_dims)
    mel = c @ Dinv
    padded = np.concatenate([mel[..., :1], mel, mel[..., -1:]], axis=-1)
    v0 = padded[..., k - 1]
    v1 = padded[..., np.minimum(k, padded.shape[-1] - 1)]
    return np.exp((v0 + s * (v1 - v0)) / (N // 2))


@pytest.mark.parametrize("fs", [16000, 48000])
def test_decode_spectral_envelope_matches_jax(fs):
    """float64 rel <= 1e-10; float32 rel <= 1e-4 (exp of an IDCT row
    summed in f32, scaled by 1 / (N/2)).  The port and the JAX package are
    each held to a float64 numpy decode from the same tables first, so a
    failure says which side moved."""
    N = cfg.cheaptrick_fft_size(fs)
    c = _coded((2, 6), 50, 0)
    got = codec.decode_spectral_envelope(_t(c), fs, N, 50).numpy()
    got32 = codec.decode_spectral_envelope(_t(c, torch.float32), fs, N,
                                           50).numpy()
    ref = _numpy_decode(c, fs, N, 50)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0,
                               err_msg="the port against numpy")
    for u in range(2):
        want = np.asarray(jcodec.decode_spectral_envelope(jnp.asarray(c[u]),
                                                          fs, N, 50))
        np.testing.assert_allclose(want, ref[u], rtol=1e-10, atol=0,
                                   err_msg=f"the JAX package against "
                                   f"numpy, row {u}")
        np.testing.assert_allclose(got[u], want, rtol=1e-10, atol=0)
        np.testing.assert_allclose(got32[u], want, rtol=1e-4, atol=0)


def test_decode_tables_resist_in_place_writes():
    """The cached codec tables are read-only and the tensor caches hold
    copies: a write into a table a caller got back raises instead of
    reaching every later decode (before, `torch.as_tensor` shared the
    cached float64 arrays' memory with the tensors the decode reads), and
    the decode after the attempt still matches the JAX package at 1e-10."""
    fs = 16000
    N = cfg.cheaptrick_fft_size(fs)
    for tables in (codec._decoding_tables(fs, N, 50),
                   codec._coding_tables(fs, N, 50)):
        for t in tables:
            with pytest.raises(ValueError, match="read-only"):
                t[0] += 1
    s_t = codec.decoding_tensors(fs, N, 50, torch.float64,
                                 torch.device("cpu"))[1]
    assert not np.shares_memory(s_t.numpy(), codec._decoding_tables(
        fs, N, 50)[1])
    c = _coded((6,), 50, 3)
    got = codec.decode_spectral_envelope(_t(c), fs, N, 50).numpy()
    want = np.asarray(jcodec.decode_spectral_envelope(jnp.asarray(c), fs,
                                                      N, 50))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_decode_aperiodicity_matches_jax(fs):
    """WORLD's coarse-band decode (plain only) with the CheckVUV gate:
    frames with a mean above -0.5 dB decode to 1 - 1e-12.  float64 rel
    <= 1e-10, float32 rel <= 1e-5."""
    N = cfg.cheaptrick_fft_size(fs)
    n_ap = cfg.number_of_aperiodicities(fs)
    rng = np.random.default_rng(1)
    c = -40.0 * rng.random((2, 5, n_ap))
    c[0, 0] = -0.1                                 # the voiced gate
    got = codec.decode_aperiodicity(_t(c), fs, N).numpy()
    got32 = codec.decode_aperiodicity(_t(c, torch.float32), fs, N).numpy()
    assert (got[0, 0] == 1.0 - 1e-12).all()
    for u in range(2):
        want = np.asarray(jcodec.decode_aperiodicity(jnp.asarray(c[u]), fs,
                                                     N))
        np.testing.assert_allclose(got[u], want, rtol=1e-10, atol=0)
        np.testing.assert_allclose(got32[u], want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("fs", [16000, 48000])
@pytest.mark.parametrize("order", [23, 24])
def test_mgc2sp_real_matches_jax(fs, order):
    """float64 within 1e-10 of the values' scale; float32 within 1e-5."""
    N = cfg.cheaptrick_fft_size(fs)
    c = _coded((2, 4), order + 1, 2)
    got = codec.mgc2sp_real(_t(c), 0.55, N).numpy()
    got32 = codec.mgc2sp_real(_t(c, torch.float32), 0.55, N).numpy()
    for u in range(2):
        want = np.asarray(jcodec.mgc2sp_real(jnp.asarray(c[u]), 0.55, N))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[u], want, rtol=0, atol=1e-10 * scale)
        np.testing.assert_allclose(got32[u], want, rtol=0, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# the feature decode and the synth lane
# ---------------------------------------------------------------------------


def _features(T, bap_dim, seed, unvoiced):
    """lf0 / mgc / bap of the size and scale the encoder writes."""
    rng = np.random.default_rng(seed)
    mgc = rng.standard_normal((2, T, 50)) / (1.0 + np.arange(50)) ** 1.2
    mgc[..., 0] += 13.0
    bap = 0.5 * rng.standard_normal((2, T, bap_dim)) \
        / (1.0 + np.arange(bap_dim))
    bap[..., 0] -= 2.0
    lf0 = np.log(150.0 + 60.0 * np.sin(np.arange(T) / 7.0
                                       + rng.uniform(0, 3, (2, 1))))
    if unvoiced:
        lf0[:, T // 3:T // 3 + 8] = 0.0
        lf0[:, -5:] = 0.0
    return lf0, mgc, bap


@pytest.mark.parametrize("fs", [16000, 48000])
@pytest.mark.parametrize("bap_dim", [24, 25])
def test_decode_features_matches_jax(fs, bap_dim):
    """The port's decode_features against cli.decode_features, float64,
    rel <= 1e-10, with bap 24 and 25 (the odd-apl rule); float32 within
    the kernel check's limits of the float64 result."""
    N = cfg.cheaptrick_fft_size(fs)
    lf0, mgc, bap = _features(8, bap_dim, 3, unvoiced=True)
    got = cli.decode_features(_t(lf0), _t(mgc), _t(bap), fs, N)
    for u in range(2):
        want = jcli.decode_features(jnp.asarray(lf0[u]), jnp.asarray(mgc[u]),
                                    jnp.asarray(bap[u]), fs, N)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[u].numpy(), np.asarray(w),
                                       rtol=1e-10, atol=0)
    # float32 against float64 on the same (f32-rounded) features: f0 is
    # the f64 exp rounded, sp and ap within decode_limit
    f32 = [_t(v, torch.float32) for v in (lf0, mgc, bap)]
    g32 = decode.decode_features(*f32, fs, N)
    ref = decode.decode_features(*(v.double() for v in f32), fs, N)
    lim_sp, lim_ap = decode.decode_limit(*f32, fs, N)
    assert torch.equal(g32[0], ref[0].float())
    assert ((g32[1].double().log() - ref[1].log()).abs() <= lim_sp).all()
    apl = decode.ap_order(bap_dim)
    assert ((g32[2][..., :apl].double().log() - ref[2][..., :apl].log())
            .abs() <= lim_ap).all()
    assert (g32[2][..., apl:] == 0).all()


def _jax_synth(f0, sp, ap, fs, yl, noise, exact):
    N = cfg.cheaptrick_fft_size(fs)
    return np.stack([np.asarray(jsyn.synthesis(
        jnp.asarray(np.asarray(f)), jnp.asarray(np.asarray(s)),
        jnp.asarray(np.asarray(a)), N, FP, fs, yl, jnp.asarray(nz),
        exact_phase=exact)) for f, s, a, nz in zip(f0, sp, ap, noise)])


@pytest.mark.parametrize("fs,unvoiced", [(16000, False), (48000, False),
                                         (16000, True), (48000, True)])
def test_synth_lane_f64_matches_jax(fs, unvoiced):
    """The synth lane in float64 with injected noise against JAX
    decode_features + synthesis: voiced features within 1e-9 abs of the
    fast path (exact_phase=False); features with unvoiced frames within
    1e-6 of the exact path (exact_phase=True), whose pulses the port's
    sequential phase sum fires (ROADMAP.md Queue C)."""
    T = 50 if fs == 16000 else 20
    N = cfg.cheaptrick_fft_size(fs)
    yl = cfg.y_length_for(T, FP, fs)
    lf0, mgc, bap = _features(T, 25, 4, unvoiced)
    noise = np.random.default_rng(9).standard_normal(
        (2, syn.synthesis_stream_len(yl)))
    stages = dict(features.synth_lane_stages(_t(lf0), _t(mgc), _t(bap), fs,
                                             FP, noise=noise))
    assert list(stages) == ["decode", "count", "synthesis"]
    dec = [jcli.decode_features(jnp.asarray(lf0[u]), jnp.asarray(mgc[u]),
                                jnp.asarray(bap[u]), fs, N) for u in range(2)]
    want = _jax_synth(*zip(*dec), fs, yl, noise, exact=unvoiced)
    got = stages["synthesis"].numpy()
    assert got.shape == (2, yl) and np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 if unvoiced else 1e-9)


def test_synth_lane_f32_matches_jax_fast_path():
    """The lane in float32 (f32 inputs on the CPU) against JAX's f32 decode
    + fast-path synthesis on the same noise: per-utterance energy within
    2%, correlation above 0.99."""
    fs = 16000
    T = 50
    yl = cfg.y_length_for(T, FP, fs)
    N = cfg.cheaptrick_fft_size(fs)
    lf0, mgc, bap = (v.astype(np.float32)
                     for v in _features(T, 25, 5, unvoiced=False))
    noise = np.random.default_rng(3).standard_normal(
        (2, syn.synthesis_stream_len(yl))).astype(np.float32)
    got = features.synth_lane(lf0, mgc, bap, fs, noise=noise,
                              device="cpu").numpy().astype(np.float64)
    dec = [jcli.decode_features(jnp.asarray(lf0[u]), jnp.asarray(mgc[u]),
                                jnp.asarray(bap[u]), fs, N) for u in range(2)]
    want = _jax_synth(*zip(*dec), fs, yl, noise, exact=False)
    e, je = (got ** 2).sum(1), (want ** 2).sum(1)
    np.testing.assert_allclose(e, je, rtol=0.02)
    for g, w in zip(got, want):
        assert np.corrcoef(g, w)[0, 1] > 0.99


def _harmonic(fs, n, seed=0, f0=170.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    ph = np.cumsum(2 * np.pi * f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
                   / fs)
    x = 0.6 * np.sin(ph) + 0.25 * np.sin(2 * ph) + 0.1 * np.sin(3 * ph)
    x[n // 2:n // 2 + n // 10] = 0.0                      # a pause
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_f32_round_trip_meets_fast_gates(fs):
    """analysis -> encode -> decode -> synthesis in float32 on the CPU
    (the port) against the same chain in float64 (the JAX package's fast
    path, JAX CLI encode and decode), held to tests/test_fast_stress.py's
    fast-path gates: finite, decoded sp > 0 and ap >= 0 (a decoded ap may
    exceed 1 where the coded band overshoots; synthesis clamps it), V/UV
    agreement > 0.9, f0 median rel < 1e-3, median |dlog sp| < 0.1 on bins
    within 60 dB of each frame's peak; the waveform finite, below 4, above
    0.05, and its energy within 5% of the float64 chain's on the same
    noise."""
    n = int(0.3 * fs)
    xs = np.stack([_harmonic(fs, n, s, f) for s, f in ((0, 170.0),
                                                       (1, 220.0))])
    N = cfg.cheaptrick_fft_size(fs)
    _, f0, sp, ap = batch.batch_analyze(xs, fs, device="cpu")
    lf0, mgc, bap = encode.encode_features(f0, sp, ap, fs, N)
    df0, dsp, dap = decode.decode_features(lf0, mgc, bap, fs, N)
    for v in (df0, dsp, dap):
        assert torch.isfinite(v).all()
    assert (dsp > 0).all() and (dap >= 0).all()
    yl = cfg.y_length_for(f0.shape[1], FP, fs)
    noise = np.random.default_rng(8).standard_normal(
        (2, syn.synthesis_stream_len(yl)))
    y = features.synth_lane(lf0, mgc, bap, fs, noise=noise, device="cpu")
    assert y.shape == (2, yl)
    assert torch.isfinite(y).all() and 0.05 < float(y.abs().max()) < 4.0
    ref = []
    for x in xs:
        a = jvocoder.analyze(jnp.asarray(x, jnp.float64), fs, FP,
                             parity=False)
        ref.append(jcli.decode_features(*jcli.encode_features(
            a.f0, a.spectrogram, a.aperiodicity, fs, N), fs, N))
    rf0, rsp, rap = (np.stack([np.asarray(r[k]) for r in ref])
                     for k in range(3))
    df0, dsp = df0.numpy().astype(np.float64), dsp.numpy().astype(np.float64)
    assert ((rf0 > 0) == (df0 > 0)).mean() > 0.9
    both = (rf0 > 0) & (df0 > 0)
    assert np.median(np.abs(df0[both] - rf0[both]) / rf0[both]) < 1e-3
    live = rsp > rsp.max(axis=2, keepdims=True) * 1e-6
    assert np.median(np.abs(np.log(dsp[live]) - np.log(rsp[live]))) < 0.1
    ry = _jax_synth(rf0, rsp, rap, fs, yl, noise, exact=False)
    e, re = (y.numpy().astype(np.float64) ** 2).sum(1), (ry ** 2).sum(1)
    np.testing.assert_allclose(e, re, rtol=0.05)


def test_batch_synth_is_copy_synthesis_synthesis():
    """batch_synth on copy-synthesis's own analysis and noise gives its
    waveform bit for bit."""
    fs = 16000
    xs = np.stack([_harmonic(fs, 4800, s) for s in (0, 1)])
    T = cfg.samples_for_dio(fs, xs.shape[1], FP)
    yl = cfg.y_length_for(T, FP, fs)
    noise = np.random.default_rng(2).standard_normal(
        (2, syn.synthesis_stream_len(yl))).astype(np.float32)
    _, f0, sp, ap, y = batch.batch_copy_synth(xs, fs, noise=noise,
                                              device="cpu")
    y2 = batch.batch_synth(f0, sp, ap, fs, noise=noise, device="cpu")
    assert torch.equal(y, y2)
    assert dict(batch.copy_synth_stages(
        torch.as_tensor(xs), fs, noise=noise)).keys() == {
        "dio", "stonemask", "cheaptrick", "d4c", "count", "synthesis"}


def test_synth_lane_launches_nothing_on_cpu():
    lf0, mgc, bap = (v.astype(np.float32)
                     for v in _features(10, 25, 6, unvoiced=True))
    kernels.reset_counts()
    y = features.synth_lane(lf0, mgc, bap, 16000, device="cpu")
    assert sum(kernels.launches.values()) == 0 and y.dtype == torch.float32


# ---------------------------------------------------------------------------
# the command lines and their files
# ---------------------------------------------------------------------------


def test_rawio_wavio_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, 3)).astype(np.float32)
    rawio.write_f32(tmp_path / "a.f32", a)
    np.testing.assert_array_equal(jrawio.read_f32(tmp_path / "a.f32", 3), a)
    np.testing.assert_array_equal(rawio.read_f32(tmp_path / "a.f32", 3), a)
    x = np.clip(0.5 * rng.standard_normal(1000), -1.2, 1.2)
    wavio.wavwrite(x, 16000, tmp_path / "a.wav")
    jwavio.wavwrite(x, 16000, tmp_path / "b.wav")
    assert open(tmp_path / "a.wav", "rb").read() == \
        open(tmp_path / "b.wav", "rb").read()
    got, fs = wavio.wavread(tmp_path / "a.wav")
    want, jfs = jwavio.wavread(tmp_path / "a.wav")
    assert fs == jfs == 16000 and np.array_equal(got, want)
    np.testing.assert_array_equal(wavio.float_to_int16(x),
                                  jwavio.float_to_int16(x))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's analysis and synth commands (--f32 --device cpu) on a
    0.4 s wav at 16 kHz."""
    d = tmp_path_factory.mktemp("cli")
    fs = 16000
    x = _harmonic(fs, 6400, 7)
    wav = str(d / "in.wav")
    wavio.wavwrite(x, fs, wav)
    p = {k: str(d / f"out.{k}") for k in ("lf0", "mgc", "bap")}
    cli.main(["analysis", wav, p["lf0"], p["mgc"], p["bap"], "5.0", "0",
              "50", "25", "--f32", "--device", "cpu"])
    out = str(d / "out.wav")
    cli.main(["synth", p["lf0"], p["mgc"], p["bap"], out, "5.0", "1024",
              str(fs), "50", "25", "--f32", "--device=cpu"])
    return wav, p, out, fs


def test_cli_analysis_matches_jax(cli_run):
    """The files the port writes against the JAX CLI's encode of the JAX
    f32 fast-path analysis of the same wav: V/UV agreement > 0.9, median
    |dlf0| < 1e-3 on frames voiced in both; mgc and bap decoded by the JAX
    decoder: median |dlog sp| < 0.1 on bins within 60 dB of each frame's
    peak, median |dap| < 0.01 (tests/test_fast_stress.py's gates)."""
    wav, p, _, fs = cli_run
    x, _ = jwavio.wavread(wav)
    a = jvocoder.analyze(jnp.asarray(x, jnp.float32), fs, FP, parity=False)
    jl, jm, jb = (np.asarray(v) for v in jcli.encode_features(
        a.f0, a.spectrogram, a.aperiodicity, fs, a.fft_size, 50, 25))
    lf0 = rawio.read_f32(p["lf0"])
    mgc = rawio.read_f32(p["mgc"], 50)
    bap = rawio.read_f32(p["bap"], 25)
    assert lf0.shape == jl.shape and mgc.shape == jm.shape \
        and bap.shape == jb.shape
    assert ((lf0 != 0) == (jl != 0)).mean() > 0.9
    both = (lf0 != 0) & (jl != 0)
    assert both.mean() > 0.5
    assert np.median(np.abs(lf0[both] - jl[both])) < 1e-3
    dec = [[np.asarray(v) for v in jcli.decode_features(
        jnp.asarray(l, jnp.float64), jnp.asarray(m, jnp.float64),
        jnp.asarray(b, jnp.float64), fs, a.fft_size)]
        for l, m, b in ((lf0, mgc, bap), (jl, jm, jb))]
    sp, jsp = dec[0][1], dec[1][1]
    live = jsp > jsp.max(axis=1, keepdims=True) * 1e-6
    assert np.median(np.abs(np.log(sp[live]) - np.log(jsp[live]))) < 0.1
    assert np.median(np.abs(dec[0][2] - dec[1][2])) < 0.01


def test_cli_synth_wav_is_the_port_path(cli_run):
    """The wav the synth command writes equals the port's decode_features
    + vocoder.synthesize (seed 0) of the same files, sample for sample."""
    _, p, out, fs = cli_run
    lf0 = rawio.read_f32(p["lf0"])
    f0, sp, ap = decode.decode_features(
        _t(lf0, torch.float32), _t(rawio.read_f32(p["mgc"], 50),
                                   torch.float32),
        _t(rawio.read_f32(p["bap"], 25), torch.float32), fs, 1024)
    y = vocoder.synthesize(f0, sp, ap, fs, 1024, FP, parity=False,
                           device="cpu")
    got, gfs = wavio.wavread(out)
    assert gfs == fs and len(got) == cfg.y_length_for(len(lf0), FP, fs)
    np.testing.assert_array_equal(wavio.float_to_int16(y.numpy()),
                                  (got * 32768.0).astype(np.int16))
    assert np.abs(got).max() > 0.05


def test_cli_without_f32_or_with_harvest_raises(tmp_path):
    """`analysis` without `--f32` is the parity analysis, with DIO or with
    `--harvest` (Harvest in float64); both raised before the port had
    them, and the name is kept.  On silence each writes the encoded
    float32 files, every frame unvoiced."""
    wav = str(tmp_path / "x.wav")
    wavio.wavwrite(np.zeros(1600), 16000, wav)
    for extra in ([], ["--harvest"]):
        outs = [str(tmp_path / f"o{len(extra)}.{k}")
                for k in ("lf0", "mgc", "bap")]
        cli.main(["analysis", wav, *outs, "5.0", "0", "50", "25", *extra,
                  "--device", "cpu"])
        lf0, mgc, bap = (rawio.read_f32(o, d)
                         for o, d in zip(outs, (1, 50, 25)))
        assert len(lf0) == mgc.shape[0] == bap.shape[0] == 21
        assert (lf0 == 0).all() and np.isfinite(mgc).all()
        assert np.isfinite(bap).all()


@pytest.mark.parametrize("call", ["batch_synth", "synth_lane", "cli"])
def test_synth_entry_points_default_to_the_card(call, tmp_path):
    """batch_synth, synth_lane and the synth command default to the card
    and raise without one instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lf0, mgc, bap = (v.astype(np.float32)
                     for v in _features(6, 25, 0, unvoiced=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "batch_synth":
            batch.batch_synth(np.exp(lf0), np.ones((2, 6, 513)),
                              np.zeros((2, 6, 513)), 16000)
        elif call == "synth_lane":
            features.synth_lane(lf0, mgc, bap, 16000)
        else:
            p = [str(tmp_path / f"i.{k}") for k in ("lf0", "mgc", "bap")]
            for path, v in zip(p, (lf0[0], mgc[0], bap[0])):
                rawio.write_f32(path, v)
            cli.main(["synth", *p, str(tmp_path / "o.wav"), "5.0", "1024",
                      "16000", "50", "25", "--f32"])
