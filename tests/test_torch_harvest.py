"""The port's Harvest lane against the JAX package, on the CPU: the f32
analysis lane at 16 kHz (decimation ratio 2), the candidate width, one
call at 8 kHz (ratio 1), bucketed extraction, the `analysis --harvest`
command line, the vocoder and copy-synthesis entry points, and device
handling.  tests/test_torch_harvest_kernels.py holds the kernels' twins
and the whole float64 chain against JAX at 48 kHz (ratio 6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import cli as jcli
from hts_train_world_tpu.ops import codec as jcodec
from hts_train_world_tpu.ops import harvest as jhv
from hts_train_world_tpu.ops import prims as jprims
from hts_train_world_tpu.parallel import batch as jbatch
from hts_train_world_tpu.parallel import bucketing as jbucketing
from hts_train_world_tpu_torch import cli
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels, vocoder
from hts_train_world_tpu_torch.io import rawio, wavio
from hts_train_world_tpu_torch.ops import harvest as hv
from hts_train_world_tpu_torch.ops import harvest_fix as hf
from hts_train_world_tpu_torch.ops import prims
from hts_train_world_tpu_torch.parallel import batch, bucketing

FS, L = 16000, 6144              # one bucket of bucketing's grid
LENGTHS = (4700, 5100)           # both in the 6144-sample bucket


def _voices(n, fs=FS, seed=2, f0s=(170.0, 230.0)):
    """Harmonic utterances with a 2 % vibrato and 0.5 % noise, a pause in
    the first."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    xs = []
    for i, f in enumerate(f0s):
        vib = 1 + 0.02 * np.sin(2 * np.pi * 5.5 * t)
        ph = 2 * np.pi * np.cumsum(f * vib) / fs
        x = sum(a * np.sin((h + 1) * ph)
                for h, a in enumerate([0.5, 0.3, 0.15, 0.08]))
        x = 0.7 * x / np.abs(x).max() + 0.005 * rng.standard_normal(n)
        if i == 0:
            x[n // 2:n // 2 + n // 8] *= 0.01
        xs.append(x)
    return np.stack(xs)


def _wav_samples(x):
    """x as a 16-bit wav reads back."""
    return wavio.float_to_int16(x) / 32768.0


@pytest.fixture(scope="module")
def lanes():
    """The port's and the JAX package's f32 Harvest analysis of one batch:
    two utterances of LENGTHS as a wav holds them, zero-padded to their
    6144-sample bucket as bucketed_extract pads them."""
    raw = _voices(L)
    sigs = [_wav_samples(raw[i, :n]) for i, n in enumerate(LENGTHS)]
    xs = bucketing.pad_group(sigs, [0, 1], L)
    kernels.reset_counts()
    port = [v.numpy() for v in batch.batch_analyze(xs, FS, algorithm="harvest",
                                                   device="cpu")]
    want = [np.asarray(v) for v in jbatch.batch_analyze(
        jnp.asarray(xs, jnp.float32), FS, algorithm="harvest")]
    return xs, port, want, raw, sigs


def _agree(f0, jf0, sp=None, jsp=None):
    """test_harvest_device.py's and test_fast_stress.py's gates: V/UV
    agreement >= 0.95, f0 median relative difference < 1e-3 on frames
    voiced in both, sp median |dlog| < 0.1."""
    assert ((f0 > 0) == (jf0 > 0)).mean() >= 0.95
    both = (f0 > 0) & (jf0 > 0)
    assert both.mean() > 0.5
    assert np.median(np.abs(f0[both] - jf0[both]) / jf0[both]) < 1e-3
    if sp is not None:
        assert np.median(np.abs(np.log(sp) - np.log(jsp))) < 0.1


def test_lane_matches_jax_batch_analyze(lanes):
    """batch_analyze(algorithm="harvest") on the CPU against the JAX lane:
    same shapes and time axis, the gates above; no kernel launched."""
    _, (t, f0, sp, ap), (jt, jf0, jsp, jap), *_ = lanes
    assert f0.shape == jf0.shape and sp.shape == jsp.shape == ap.shape
    np.testing.assert_array_equal(t, jt)
    _agree(f0, jf0, sp, jsp)
    assert np.median(np.abs(ap - jap)) < 0.01
    assert sum(kernels.launches.values()) == 0


def test_lane_stages():
    """analyze_stages("harvest") runs Harvest's stages, then the frame
    pick, CheapTrick and D4C; no StoneMask."""
    xs = torch.as_tensor(_voices(3200), dtype=torch.float32)
    names = [s for s, _ in batch.analyze_stages(xs, FS, algorithm="harvest")]
    assert names == ["decimate", "band_filter", "candidates", "detect",
                     "refine", "contour", "harvest", "cheaptrick", "d4c"]


def test_decimate_ratio_2_matches_jax():
    """The ratio-2 decimation of the float64 twin within 1e-12 of the peak
    of JAX's f64 decimate (ratio 6: tests/test_torch_harvest_kernels.py)."""
    x = _voices(4800, seed=5)[0]
    d = prims.decimate_plain(torch.as_tensor(x[None]), 2)[0].numpy()
    jd = np.asarray(jprims.decimate(jnp.asarray(x), 2))
    assert np.abs(d - jd).max() <= 1e-12 * np.abs(jd).max()


def test_width_nc_pad_equals_bucketed_width():
    """The refinement at the plan's width nc_pad (zero columns skipped)
    gives the f0 it gives at the JAX package's bucketed width 7*ncb."""
    xs = torch.as_tensor(_voices(4800, seed=6), dtype=torch.float32)
    plan = hv.harvest_plan(4800, FS, cfg.K_FLOOR_F0, cfg.K_CEIL_F0)
    stages = dict(hv.harvest_f0_stages(xs, FS))
    _, nc = hv.detect_candidates(stages["candidates"], plan["nc_pad"])
    width = jhv._bucket_width(int(nc.max()), plan)
    assert width < plan["nc_pad"] == stages["detect"].shape[2]
    cands = stages["detect"][..., :width].contiguous()
    refined, scores = hv.refine(stages["decimate"], cands,
                                plan["actual_fs"], cfg.K_FLOOR_F0,
                                cfg.K_CEIL_F0)
    assert torch.equal(stages["contour"], hf.contour(refined, scores))


def test_ratio_one_at_8k():
    """At 8 kHz there is no decimation (ratio 1): the f0 tracks the
    synthetic contour within 2 % on voiced frames."""
    fs, n = 8000, 3200
    assert hv.harvest_plan(n, fs, 71.0, 800.0)["ratio"] == 1
    tt, f0 = hv.harvest(torch.as_tensor(_voices(n, fs), dtype=torch.float32),
                        fs)
    vib = 1 + 0.02 * np.sin(2 * np.pi * 5.5 * tt.numpy())
    for i, f in enumerate((170.0, 230.0)):
        v = f0[i].numpy() > 0
        assert v.mean() > 0.8
        assert np.median(np.abs(f0[i].numpy()[v] - f * vib[v])
                         / (f * vib[v])) < 0.02


def test_bucketed_extract_harvest_matches_jax(lanes):
    """bucketed_extract(algorithm="harvest") against the JAX one on two
    utterances of one bucket: lf0 V/UV agreement >= 0.95 and median |dlf0|
    < 1e-3 on frames voiced in both; mgc and bap through the JAX decoder:
    median |dlog sp| < 0.1 on bins within 60 dB of each frame's peak,
    median |dap| < 0.01.  The JAX side is its bucketed_extract's body: the
    one group's batch_analyze (the lanes fixture's, on the same padded
    batch) and cli.encode_features of each row, trimmed; calling it would
    spend ~20 s compiling its vmapped encoder."""
    sigs, (_, jf0, jsp, jap) = lanes[4], lanes[2]
    assert bucketing.bucket_groups(LENGTHS) == [(L, [0, 1])]
    assert jbucketing.plan_buckets(LENGTHS) == {L: [0, 1]}
    port = bucketing.bucketed_extract(sigs, FS, algorithm="harvest",
                                      device="cpu")
    N = cfg.cheaptrick_fft_size(FS)
    want = []
    for r, n in enumerate(LENGTHS):
        T = cfg.samples_for_dio(FS, n, 5.0)
        want.append([np.asarray(v)[:T] for v in jcli.encode_features(
            jnp.asarray(jf0[r]), jnp.asarray(jsp[r]), jnp.asarray(jap[r]),
            FS, N, 50, 25)])

    def dec(m, c0, dims):
        m = np.array(m, np.float64)
        m[:, 0] += c0
        return np.asarray(jcodec.decode_spectral_envelope(
            jnp.asarray(m), FS, N, dims)) / 1e4

    for n, (lf0, mgc, bap), (jlf0, jmgc, jbap) in zip(LENGTHS, port, want):
        assert lf0.shape == jlf0.shape == (cfg.samples_for_dio(FS, n, 5.0),)
        assert ((lf0 != 0) == (jlf0 != 0)).mean() >= 0.95
        both = (lf0 != 0) & (jlf0 != 0)
        assert both.mean() > 0.5
        assert np.median(np.abs(lf0[both] - jlf0[both])) < 1e-3
        sp, jsp = dec(mgc, -12.0, 50), dec(jmgc, -12.0, 50)
        live = jsp > jsp.max(axis=1, keepdims=True) * 1e-6
        assert np.median(np.abs(np.log(sp[live]) - np.log(jsp[live]))) < 0.1
        ap, jap = (dec(b, jcli.LN_1E4, 25) for b in (bap, jbap))
        assert np.median(np.abs(ap - jap)) < 0.01


def test_cli_analysis_harvest_matches_jax(lanes, tmp_path):
    """`analysis ... --harvest --f32 --device cpu` on a wav of the first
    (padded) utterance against the JAX CLI's encode of the JAX Harvest
    analysis of the same samples: the gates of test_torch_synth.py's DIO
    test."""
    xs, _, (_, jf0, jsp, jap), raw, _ = lanes
    wav = str(tmp_path / "in.wav")
    x0 = np.zeros(L)
    x0[:LENGTHS[0]] = raw[0, :LENGTHS[0]]
    wavio.wavwrite(x0, FS, wav)
    assert np.array_equal(wavio.wavread(wav)[0], xs[0])
    p = {k: str(tmp_path / f"out.{k}") for k in ("lf0", "mgc", "bap")}
    cli.main(["analysis", wav, p["lf0"], p["mgc"], p["bap"], "5.0", "0",
              "50", "25", "--harvest", "--f32", "--device", "cpu"])
    N = cfg.cheaptrick_fft_size(FS)
    jl, jm, jb = (np.asarray(v) for v in jcli.encode_features(
        jnp.asarray(jf0[0]), jnp.asarray(jsp[0]), jnp.asarray(jap[0]), FS, N,
        50, 25))
    lf0 = rawio.read_f32(p["lf0"])
    mgc = rawio.read_f32(p["mgc"], 50)
    bap = rawio.read_f32(p["bap"], 25)
    assert lf0.shape == jl.shape and mgc.shape == jm.shape
    assert ((lf0 != 0) == (jl != 0)).mean() >= 0.95
    both = (lf0 != 0) & (jl != 0)
    assert np.median(np.abs(lf0[both] - jl[both])) < 1e-3
    dec = [[np.asarray(v) for v in jcli.decode_features(
        jnp.asarray(a, jnp.float64), jnp.asarray(b, jnp.float64),
        jnp.asarray(c, jnp.float64), FS, N)]
        for a, b, c in ((lf0, mgc, bap), (jl, jm, jb))]
    sp, jsp2 = dec[0][1], dec[1][1]
    live = jsp2 > jsp2.max(axis=1, keepdims=True) * 1e-6
    assert np.median(np.abs(np.log(sp[live]) - np.log(jsp2[live]))) < 0.1
    assert np.median(np.abs(dec[0][2] - dec[1][2])) < 0.01


def test_vocoder_and_copy_synth_take_harvest(lanes):
    """vocoder.analyze(algorithm="harvest") of one utterance gives its row
    of the batch lane; batch_copy_synth(algorithm="harvest") returns a
    finite waveform of the synthesis length."""
    xs, (t, f0, sp, _), *_ = lanes
    a = vocoder.analyze(xs[0], FS, parity=False, algorithm="harvest",
                        device="cpu")
    np.testing.assert_allclose(a.f0.numpy(), f0[0], rtol=1e-6)
    np.testing.assert_allclose(a.temporal_positions.numpy(), t[0])
    np.testing.assert_allclose(a.spectrogram.numpy(), sp[0], rtol=1e-5)
    out = batch.batch_copy_synth(xs[:, :3200], FS, algorithm="harvest",
                                 seed=3, device="cpu")
    T = cfg.samples_for_dio(FS, 3200, 5.0)
    assert out[1].shape == (2, T)
    assert out[4].shape == (2, cfg.y_length_for(T, 5.0, FS))
    assert torch.isfinite(out[4]).all() and out[4].abs().max() > 0.05


@pytest.mark.parametrize("call", ["batch_analyze", "batch_copy_synth",
                                  "bucketed_analyze", "bucketed_extract",
                                  "analyze", "cli"])
def test_harvest_entry_points_default_to_the_card(call, tmp_path):
    """Without device="cpu" every Harvest entry point asks for the card,
    and here, without one, raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    x = _voices(1600)
    with pytest.raises(RuntimeError, match="CUDA"):
        if call in ("batch_analyze", "batch_copy_synth"):
            getattr(batch, call)(x, FS, algorithm="harvest")
        elif call == "analyze":
            vocoder.analyze(x[0], FS, parity=False, algorithm="harvest")
        elif call == "cli":
            wav = str(tmp_path / "x.wav")
            wavio.wavwrite(x[0], FS, wav)
            cli.main(["analysis", wav, *(str(tmp_path / f"o.{k}")
                                         for k in ("lf0", "mgc", "bap")),
                      "--harvest", "--f32"])
        else:
            getattr(bucketing, call)(list(x), FS, algorithm="harvest")
