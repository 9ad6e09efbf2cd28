"""The port's generation path (models/pgen.py, models/engine.py, the
MSPF and synthesis half of models/recipe.py, features/compose.py and
features/msd.py) against the JAX package, on the CPU, in float64.

One voice is built by the JAX package from tests/test_voice_build.py's
sung corpus (16 kHz, mgc 12, 3 states, GV, MSPF) and carried into the port
with `recipe.state_from_numpy`; both packages then generate from the same
voice.  Durations and V/UV must be equal; statics of every stream within
1e-9 of their own scale.  Waveforms cannot be compared across two RNGs:
the port's float32 features go through JAX's float32 decode and fast-path
synthesis with the same injected noise and are held to the synth lane's
float32 gates (tests/test_torch_synth.py: energy within 2%, correlation
above 0.99).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_context_clustered import _ll_close, _prefix_scale
from tests.test_torch_hsmm import _port
from tests.test_torch_synth import _jax_synth
from tests.test_voice_build import FP, FS, SHIFT, _ctx, built  # noqa: F401
from hts_train_world_tpu.features import compose as jcompose
from hts_train_world_tpu.features import msd as jmsd
from hts_train_world_tpu.models import engine as jengine
from hts_train_world_tpu.models import hsmm as jhsmm
from hts_train_world_tpu.models import pgen as jpgen
from hts_train_world_tpu.models import recipe as jrecipe
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch.features import compose, msd
from hts_train_world_tpu_torch.models import clustering, context_clustered
from hts_train_world_tpu_torch.models import engine, hsmm, pgen, recipe
from hts_train_world_tpu_torch.ops import synthesis as syn

CPU = dict(device="cpu")
UNSEEN = _ctx(["sil", "n2", "n0", "n1", "sil"], 1)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_statics(got, want, tol=1e-9):
    """Each stream within tol of its own largest |value| (MAGIC aside);
    MAGIC exactly where JAX has it."""
    assert set(got) == set(want)
    for n in want:
        g, w = _np(got[n]), np.asarray(want[n])
        assert g.shape == w.shape, n
        magic = w == jpgen.MAGIC
        np.testing.assert_array_equal(g == jpgen.MAGIC, magic, err_msg=n)
        scale = np.abs(w[~magic]).max() if (~magic).any() else 1.0
        assert np.abs(g - w)[~magic].max(initial=0.0) <= tol * scale, n


@pytest.fixture(scope="module")
def voices(built):  # noqa: F811
    """(JAX state, the port's state carried from it, cfg, corpus)."""
    st, jcfg, corpus = built
    nat, gen = st.mspf
    port = recipe.state_from_numpy(
        context_clustered.ClusteredModel.to_plain(st.clustered),
        {n: clustering.Tree.to_plain(t) for n, t in st.gv.trees.items()},
        ((nat.mean, nat.std), (gen.mean, gen.std)), st.alignments,
        st.gv.context_dependent)
    pcfg = recipe.RecipeConfig(**dataclasses.asdict(jcfg))
    return st, port, jcfg, pcfg, corpus


def test_state_from_numpy_carries_the_voice(voices):
    st, port, *_ = voices
    ctx = UNSEEN[1]
    for s in range(st.clustered.n_states):
        a, b = st.clustered.state_params(ctx, s), port.clustered.state_params(
            ctx, s)
        for n in a:
            for x, y in zip(a[n], b[n]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for n in st.gv.trees:
        for x, y in zip(st.gv.params(n, ctx), port.gv.params(n, ctx)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(port.mspf[1].std, st.mspf[1].std)
    assert set(port.alignments) == set(st.alignments)


def test_state_durations_and_rho_match_jax(voices):
    st, port, *_ = voices
    for rho in (-0.5, 0.0, 0.5):
        np.testing.assert_array_equal(
            pgen.state_durations(port.clustered, UNSEEN, rho),
            jpgen.state_durations(st.clustered, UNSEEN, rho))
    assert pgen.rho_for_total(port.clustered, UNSEEN, 300) == \
        jpgen.rho_for_total(st.clustered, UNSEEN, 300)


def test_frame_params_and_mlpg_streams_match_jax(voices):
    st, port, *_ = voices
    durs = jpgen.state_durations(st.clustered, UNSEEN)
    fp = pgen.frame_params(port.clustered, UNSEEN, durs, **CPU)
    jfp = jpgen.frame_params(st.clustered, UNSEEN, durs)
    for n in jfp.means:
        np.testing.assert_array_equal(_np(fp.means[n]), jfp.means[n])
        np.testing.assert_array_equal(_np(fp.vars[n]), jfp.vars[n])
    np.testing.assert_array_equal(_np(fp.vuv), jfp.vuv)
    np.testing.assert_array_equal(_np(fp.frame_state), jfp.frame_state)
    assert (~jfp.vuv).any() and jfp.vuv.any()
    _same_statics(pgen.mlpg_streams(fp, port.clustered.streams),
                  jpgen.mlpg_streams(jfp, st.clustered.streams))


@pytest.mark.parametrize("pgtype", [1, 2])
def test_generate_em_matches_jax(voices, pgtype):
    """Statics, V/UV, gamma and the evidence history of 3 EM iterations.
    Frames far from a chain state score ~-1e9 against its floored
    variances, so the segment sums' prefix sums reach ~1e11: the history
    is held to 1e-9 of itself plus 16 float64 ulps of the largest prefix
    sum behind it (tests/test_torch_context_clustered.py's allowance),
    taken over the first and the last iteration's observations."""
    st, port, *_ = voices
    labels = _ctx(["sil", "n0", "n2", "sil"], 1)
    s, v, g, h = pgen.generate_em(port.clustered, labels, n_iters=3,
                                  max_dur=80, pgtype=pgtype, **CPU)
    js, jv, jg, jh = jpgen.generate_em(st.clustered, labels, n_iters=3,
                                       max_dur=80, pgtype=pgtype)
    np.testing.assert_array_equal(_np(v), np.asarray(jv))
    _same_statics(s, js)
    assert np.abs(_np(g) - jg).max() <= 1e-9
    fp0 = jpgen.frame_params(st.clustered, labels,
                             jpgen.state_durations(st.clustered, labels))
    first = jpgen.mlpg_streams(fp0, st.clustered.streams)
    scale = max(_prefix_scale(st.clustered, [(jpgen._windowed_obs(
        x, st.clustered.streams, vu), labels)])
        for x, vu in ((first, fp0.vuv), (js, np.asarray(jv))))
    for a, b in zip(h, jh):
        assert _ll_close(a, b, scale), (a, b, scale)


@pytest.mark.parametrize("variant", ["gv", "mspf", "mcep", "plain"])
def test_generate_parameters_matches_jax(voices, variant):
    st, port, *_ = voices
    gcfg = dict(use_gv=variant == "gv", max_dur=80, n_win=3,
                postfilter_mcp=1.4 if variant == "mcep" else 0.0)
    mspf = variant == "mspf"
    s, v, d = pgen.generate_parameters(
        port.clustered, UNSEEN, pgen.GenConfig(**gcfg), port.gv,
        mspf=port.mspf if mspf else None, **CPU)
    js, jv, jd = jpgen.generate_parameters(
        st.clustered, UNSEEN, jpgen.GenConfig(**gcfg), st.gv,
        mspf=st.mspf if mspf else None)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(_np(v), np.asarray(jv))
    _same_statics(s, js)


def test_make_mspf_matches_jax(voices):
    st, port, jcfg, pcfg, corpus = voices
    nat, gen = recipe.make_mspf(port, corpus, pcfg, **CPU)
    jnat, jgen = st.mspf
    for a, b in ((nat, jnat), (gen, jgen)):
        np.testing.assert_allclose(a.mean, b.mean, rtol=1e-9)
        np.testing.assert_allclose(a.std, b.std, rtol=1e-9)


def _jax_waveform(statics, vuv, noise):
    """JAX's float32 decode and fast-path synthesis of the port's features
    (lf0 zeroed where MAGIC or unvoiced), with the same noise."""
    from hts_train_world_tpu import cli as jcli
    lf0 = _np(statics["lf0"])[:, 0]
    lf0 = np.where((lf0 == jpgen.MAGIC) | ~_np(vuv), 0.0, lf0)
    f32 = [np.asarray(a, np.float32) for a in
           (lf0, _np(statics["mgc"]), _np(statics["bap"]))]
    N = cfg.cheaptrick_fft_size(FS)
    f0, sp, ap = jcli.decode_features(*(jnp.asarray(a) for a in f32), FS, N)
    yl = cfg.y_length_for(len(lf0), FP, FS)
    return _jax_synth([f0], [sp], [ap], FS, yl, noise[None], exact=True)[0]


def _f32_gates(got, want):
    e, je = float((got ** 2).sum()), float((want ** 2).sum())
    assert abs(e / je - 1.0) < 0.02
    assert np.corrcoef(got, want)[0, 1] > 0.99


def test_synthesize_utterance_matches_jax(voices):
    """recipe.synthesize_utterance with GV and MSPF: durations, V/UV and
    statics against JAX's; the waveform against JAX's float32 decode and
    fast path on the same features and noise."""
    st, port, jcfg, pcfg, _ = voices
    d0 = jpgen.state_durations(st.clustered, UNSEEN)
    yl = cfg.y_length_for(int(d0.sum()), FP, FS)
    noise = np.random.default_rng(12).standard_normal(
        syn.synthesis_stream_len(yl)).astype(np.float32)
    y, s, v, d = recipe.synthesize_utterance(port, UNSEEN, pcfg, FS, FP,
                                             noise=noise, **CPU)
    gcfg = jpgen.GenConfig(pgtype=jcfg.pgtype, max_dur=jcfg.max_dur,
                           n_win=jcfg.n_win, use_gv=True,
                           postfilter_mcp=jcfg.postfilter_mcp,
                           alpha=jcfg.alpha)
    js, jv, jd = jpgen.generate_parameters(
        st.clustered, UNSEEN, gcfg, gv_model=st.gv, mspf=st.mspf,
        mspf_weight=jcfg.mspf_weight)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(_np(v), np.asarray(jv))
    _same_statics(s, js)
    y = _np(y).astype(np.float64)
    assert y.shape == (yl,) and np.isfinite(y).all()
    _f32_gates(y, _jax_waveform(s, v, noise))
    # generate_waveform alone, from the JAX statics: the same waveform
    y2 = pgen.generate_waveform({k: np.asarray(a) for k, a in js.items()},
                                np.asarray(jv), FS, 0, FP, noise=noise,
                                **CPU)
    assert np.abs(_np(y2) - y).max() <= 1e-5 * np.abs(y).max()


def test_engine_synthesizes_a_jax_exported_voice_as_jax(voices, tmp_path):
    """The .htsvoice the JAX package exports: the port's model_from_voice
    gives the same pdfs, and engine.synthesize the same durations, V/UV
    and statics as JAX's engine on that file; the port's file-driven
    synthesis matches its state-driven one to the container's f32
    quantization (tests/test_voice_build.py's gates)."""
    st, port, jcfg, pcfg, _ = voices
    path = str(tmp_path / "jax.htsvoice")
    jrecipe.export(st, path, FS, SHIFT, jcfg)
    model, gv, meta = engine.load_voice(path)
    jmodel, jgv, jmeta = jengine.load_voice(path)
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    ctx = UNSEEN[2]
    for s in range(model.n_states):
        a, b = model.state_params(ctx, s), jmodel.state_params(ctx, s)
        for n in a:
            for x, y in zip(a[n], b[n]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    labels = _ctx(["sil", "n0", "n2", "sil"], 1)
    d_ref = jpgen.state_durations(st.clustered, labels)
    yl = cfg.y_length_for(int(d_ref.sum()), FP, FS)
    noise = np.random.default_rng(13).standard_normal(
        syn.synthesis_stream_len(yl)).astype(np.float32)
    d_free = engine.synthesize(path, labels, **CPU)[3]
    np.testing.assert_array_equal(d_free,
                                  jpgen.state_durations(jmodel, labels))
    assert np.abs(d_free - d_ref).max() <= 1
    assert (d_free != d_ref).sum() <= 0.1 * len(d_ref)
    y_v, s_v, v_v, d_v = engine.synthesize(path, labels, durs=d_ref,
                                           noise=noise, **CPU)
    jgcfg = jpgen.GenConfig(pgtype=0, n_win=3, use_gv=True,
                            alpha=jmeta.alpha or 0.42)
    js, jv, _ = jpgen.generate_parameters(jmodel, labels, jgcfg,
                                          gv_model=jgv, durs=d_ref)
    np.testing.assert_array_equal(_np(v_v), np.asarray(jv))
    _same_statics(s_v, js)
    # file against state, both in the port (no MSPF: not in the container)
    nomspf = dataclasses.replace(pcfg, use_mspf=False)
    y_r, s_r, v_r, _ = recipe.synthesize_utterance(
        port, labels, nomspf, FS, FP, durs=d_ref, noise=noise, **CPU)
    np.testing.assert_array_equal(_np(v_v), _np(v_r))
    for n in s_r:
        np.testing.assert_allclose(_np(s_v[n]), _np(s_r[n]), rtol=2e-4,
                                   atol=2e-4)
    y_v, y_r = _np(y_v).astype(np.float64), _np(y_r).astype(np.float64)
    assert y_v.shape == y_r.shape
    assert np.sqrt(np.mean((y_v - y_r) ** 2)) < \
        0.01 * np.sqrt(np.mean(y_r ** 2))


def test_generate_from_models_matches_jax(voices):
    st, *_ = voices
    jms = st.monophone
    labels = ["sil", "n1", "n0", "n2", "sil"]
    for rate in (1.0, 1.3):
        got = hsmm.generate_from_models(_port(jms), labels, rate)
        want = jhsmm.generate_from_models(jms, labels, rate)
        for a, b in zip(got[:2], want[:2]):
            for n in b:
                np.testing.assert_array_equal(a[n], b[n])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])


def test_compose_and_msd_match_jax():
    rng = np.random.default_rng(21)
    T = 70
    lay = compose.StreamLayout(mgc_dim=6, lf0_dim=2, bap_dim=3, vib_dim=2)
    jlay = jcompose.StreamLayout(mgc_dim=6, lf0_dim=2, bap_dim=3, vib_dim=2)
    mgc = rng.standard_normal((T, 6))
    lf0 = np.log(rng.uniform(100, 300, (T, 2)))
    lf0[10:25] = 0.0
    lf0[:3] = 0.0
    bap = rng.standard_normal((T, 3))
    vib = rng.standard_normal((T, 2)) * 0.1
    args = (mgc, lf0, bap, vib)
    np.testing.assert_array_equal(compose.compose_cmp(*args, lay, **CPU),
                                  jcompose.compose_cmp(*args, jlay))
    ffos = [compose.compose_ffo(*args, lay, **CPU),
            compose.compose_ffo(mgc[:40], lf0[:40], bap[:40], vib[:40], lay,
                                **CPU)]
    jffos = [jcompose.compose_ffo(*args, jlay),
             jcompose.compose_ffo(mgc[:40], lf0[:40], bap[:40], vib[:40],
                                  jlay)]
    for a, b in zip(ffos, jffos):
        assert a.dtype == np.float32 and a.shape[1] == lay.ffo_dim
        np.testing.assert_array_equal(a, b)
    fv = compose.ffo_variance(ffos)
    np.testing.assert_array_equal(fv, jcompose.ffo_variance(jffos))
    np.testing.assert_array_equal(compose.gv_variance(ffos, lay),
                                  jcompose.gv_variance(jffos, jlay))
    for k, v in compose.stream_variances(fv, lay).items():
        np.testing.assert_array_equal(v, jcompose.stream_variances(fv,
                                                                   jlay)[k])
    x = np.where(lf0 == 0.0, msd.MAGIC, lf0)
    np.testing.assert_array_equal(msd.msd_flags(x), jmsd.msd_flags(x))
    np.testing.assert_array_equal(msd.interpolate_gaps(x),
                                  jmsd.interpolate_gaps(x))
    with pytest.raises(ValueError):
        msd.interpolate_gaps(np.full(5, msd.MAGIC))


def test_an_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        pgen.generate_waveform({"lf0": np.zeros((4, 1)),
                                "mgc": np.zeros((4, 12)),
                                "bap": np.zeros((4, 3))},
                               np.ones(4, bool), FS, engine="straight",
                               **CPU)


def test_entry_points_default_to_the_card(voices):
    st, port, jcfg, pcfg, corpus = voices
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = [
        lambda: recipe.synthesize_utterance(port, UNSEEN, pcfg, FS, FP),
        lambda: recipe.make_mspf(port, corpus, pcfg),
        lambda: pgen.generate_parameters(port.clustered, UNSEEN),
        lambda: pgen.generate_em(port.clustered, UNSEEN),
        lambda: engine.synthesize((port.clustered, port.gv, engine.VoiceMeta(
            FS, SHIFT, 3, ("mgc", "lf0", "bap", "vib"))), UNSEEN),
        lambda: compose.compose_cmp(np.zeros((5, 2)), np.zeros((5, 1)),
                                    np.zeros((5, 2)), np.zeros((5, 1))),
        lambda: pgen.generate_waveform({"lf0": np.zeros((4, 1)),
                                        "mgc": np.zeros((4, 12))},
                                       np.ones(4, bool), FS, engine="sptk")]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
