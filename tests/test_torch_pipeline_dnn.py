"""The port's corpus pipeline, DNN half (TRDNN -> TRJGV -> MSPFD -> PGEN
-> WGEN, and synthesize_unseen), against the JAX package's on the CPU.

Both pipelines start from the same ANALYZE / COMPOSE / STATS files (the
port's, on tests/test_torch_pipeline.py's 3-utterance 16 kHz corpus) and
run their own HALGN at hard counts (equal alignments and ffi, as
tests/test_torch_pipeline.py holds them), then the DNN half at hidden (32,
32) from the same initial parameters (the port's `init_params` patched to
the JAX package's draw for the same seed).  MSPF runs at weight 0.5: at
weight 1 the 3-utterance statistics lift c0 to ~30 in both packages, and
the float32 decode of that overflows.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import cli as jcli
from hts_train_world_tpu.models import acoustic as jac
from hts_train_world_tpu.models import recipe as jrecipe
from hts_train_world_tpu.models import training as jtraining
from hts_train_world_tpu.ops import synthesis as jsyn
from hts_train_world_tpu.runtime import pipeline as jpl
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels, vocoder
from hts_train_world_tpu_torch.features import decode
from hts_train_world_tpu_torch.io import rawio, wavio
from hts_train_world_tpu_torch.models import acoustic, recipe, training
from hts_train_world_tpu_torch.ops import generation
from hts_train_world_tpu_torch.ops import synthesis as syn
from hts_train_world_tpu_torch.runtime import pipeline as pl
from tests.test_torch_pipeline import FS, HALGN, make_corpus

HIDDEN = (32, 32)
TRAIN = dict(num_steps=200, batch_size=128, log_interval=100,
             save_interval=100, valid_fraction=0.0)
UNSEEN = ["x^x-sil+a=x/E:xx]", "x^sil-a+a=x/E:Bb3]", "x^a-a+sil=x/E:G3]",
          "x^a-sil+x=x/E:xx]"]


def _unseen_label(wd):
    d = int(0.7 * 1e7)
    ends = [d // 8, d // 2, d - d // 8, d]
    starts = [0] + ends[:-1]
    with open(os.path.join(wd, "labels", "full", "unseen.lab"), "w") as f:
        f.write("".join(f"{a} {b} {c}\n" for a, b, c in
                        zip(starts, ends, UNSEEN)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wt = str(tmp_path_factory.mktemp("port"))
    make_corpus(wt)
    _unseen_label(wt)
    common = dict(use_hmm_align=True, trajectory_steps=10, use_mspf=True,
                  mspf_weight=0.5)
    p = pl.SingingPipeline(pl.PipelineConfig(
        wt, fs=FS, hmm=recipe.RecipeConfig(**HALGN),
        train=training.TrainConfig(**TRAIN), device="cpu", **common))
    p.run(upto="STATS")
    wj = str(tmp_path_factory.mktemp("jax"))
    shutil.rmtree(wj)
    shutil.copytree(wt, wj)
    j = jpl.SingingPipeline(jpl.PipelineConfig(
        wj, fs=FS, hmm=jrecipe.RecipeConfig(**HALGN),
        train=jtraining.TrainConfig(**TRAIN), **common))
    j.cfg.model = jac.ModelConfig(n_in=8, n_out=238, hidden=HIDDEN)
    j.run()
    jwav = j.synthesize_unseen("unseen")

    def init(generator, mcfg):
        tree = jax.tree_util.tree_map(np.asarray, jac.init_params(
            jax.random.PRNGKey(generator.initial_seed()), j.cfg.model))
        return acoustic.params_from_numpy(tree, mcfg,
                                          device=generator.device)
    p.cfg.model = acoustic.ModelConfig(n_in=8, n_out=238, hidden=HIDDEN)
    kernels.reset_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(acoustic, "init_params", init)
        p.run()
    pwav = p.synthesize_unseen("unseen")
    return p, j, pwav, jwav


def _read(wd, sub, base, ext, dim):
    return rawio.read_f32(os.path.join(wd, sub, f"{base}.{ext}"), dim)


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


def test_halgn_and_mkdat_equal_jax(runs):
    p, j, _, _ = runs
    for u in range(3):
        for sub, ext in (("labels/align", "lab"), ("ffi", "ffi")):
            with open(os.path.join(p.wd, sub, f"utt{u}.{ext}"), "rb") as a, \
                    open(os.path.join(j.wd, sub, f"utt{u}.{ext}"), "rb") as b:
                assert a.read() == b.read()


def test_trdnn_and_trjgv_weights_match_jax(runs):
    """The frame-mode (200 steps) and trajectory-mode (10 more at batch 1,
    Adam warm-started) checkpoints against the JAX package's: every
    weight within 5e-6 of its array's largest magnitude (float32 over 210
    steps; measured 4.3e-7 and 4.8e-7)."""
    p, j, _, _ = runs
    for sub in ("model", "model_trj"):
        got = acoustic.params_to_numpy(p._restore_params(
            os.path.join(p.wd, sub)))
        want = jax.tree_util.tree_map(np.asarray, j._restore_params(
            os.path.join(j.wd, sub)))
        worst = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            _rel, got, want)))
        assert worst <= 5e-6, (sub, worst)
    assert sorted(os.listdir(os.path.join(p.wd, "model_trj"))) == [
        "100", "200", "210"]
    assert not os.path.exists(os.path.join(p.wd, "model_trj", "hmm.pkl"))


def test_trjgv_improves_trajectory_nll(runs):
    """As tests/test_pipeline_bridge.py:87-112 holds the JAX package: the
    trajectory NLL of the warm-started model below the frame model's."""
    p, _, _, _ = runs
    feature_dims, msd_flags, gv_var = p._traj_meta()
    pairs = p._pairs()

    def traj_cost(model):
        total = 0.0
        with torch.no_grad():
            for pr in pairs:
                pred, var = model(torch.as_tensor(pr.ffi),
                                  torch.zeros(len(pr.ffi), dtype=torch.long))
                c, _ = acoustic.trajectory_cost(
                    pred, torch.as_tensor(pr.ffo), var[0],
                    torch.as_tensor(gv_var, dtype=torch.float32),
                    feature_dims, msd_flags)
                total += float(c)
        return total
    assert traj_cost(p._restore_params(os.path.join(p.wd, "model_trj"))) \
        < traj_cost(p._restore_params(os.path.join(p.wd, "model")))


def test_mspfd_and_pgen_files_match_jax(runs):
    """MSPF statistics and PGEN's files (mgc with the MSPF applied, lf0
    with MAGIC, bap, vuv) against the JAX package's.  The natural
    statistics (identical trajectories) within 1e-9; the generated ones
    where the modulation spectrum has power: exp(gen_mean) within 3e-3 of
    its dimension's largest, gen_std within 2e-3 weighted by that power
    (a log of near-zero power is ill-conditioned; measured 7.3e-4 and
    4.1e-4).  V/UV and MAGIC equal; mgc (MSPF at weight 0.5 amplifies)
    within 2e-3 of its largest magnitude, lf0 and bap within 1e-5
    (measured 3.0e-4, 9.6e-8, 3.1e-7)."""
    p, j, _, _ = runs
    a, b = np.load(os.path.join(p.wd, "stats", "mspf.npz")), np.load(
        os.path.join(j.wd, "stats", "mspf.npz"))
    assert _rel(a["nat_mean"], b["nat_mean"]) <= 1e-9
    assert _rel(a["nat_std"], b["nat_std"]) <= 1e-9
    power = np.exp(b["gen_mean"])
    power = power / power.max(1, keepdims=True)
    assert (np.abs(np.exp(a["gen_mean"] - b["gen_mean"]) - 1.0)
            * power).max() <= 3e-3
    assert (np.abs(a["gen_std"] - b["gen_std"]) * power).max() <= 2e-3
    lay = p.cfg.layout
    for u in range(3):
        vuv = _read(p.wd, "gen", f"utt{u}", "vuv", 1)
        assert np.array_equal(vuv, _read(j.wd, "gen", f"utt{u}", "vuv", 1))
        assert vuv.mean() > 0.5
        for ext, dim, bound in (("mgc", lay.mgc_dim, 2e-3),
                                ("lf0", lay.lf0_dim, 1e-5),
                                ("bap", lay.bap_dim, 1e-5)):
            g = _read(p.wd, "gen", f"utt{u}", ext, dim)
            w = _read(j.wd, "gen", f"utt{u}", ext, dim)
            live = w > -1e9
            assert np.array_equal(g > -1e9, live) and np.isfinite(g).all()
            assert _rel(g[live], w[live]) <= bound, (u, ext)


def _jax_wave(wd, base, lay, noise):
    """The JAX package's float32 decode + fast-path synthesis of PGEN's
    files (the comparison of tests/test_torch_synth.py's float32 synth
    lane test)."""
    mgc, lf0, bap = (_read(wd, "gen", base, ext, d)
                     for ext, d in (("mgc", lay.mgc_dim),
                                    ("lf0", lay.lf0_dim),
                                    ("bap", lay.bap_dim)))
    lf0_1 = np.where(lf0[:, 0] == np.float32(-1e10), np.float32(0.0),
                     lf0[:, 0])
    N = cfg.cheaptrick_fft_size(FS)
    f0, sp, ap = jcli.decode_features(jnp.asarray(lf0_1), jnp.asarray(mgc),
                                      jnp.asarray(bap), FS, N)
    yl = cfg.y_length_for(len(lf0), 5.0, FS)
    return np.asarray(jsyn.synthesis(
        f0, sp, ap, N, 5.0, FS, yl, jnp.asarray(noise, jnp.float32),
        exact_phase=False)).astype(np.float64)


def test_wgen_matches_jax_on_injected_noise(runs):
    """WGEN's path (K12 decode + fast-mode synthesis in float32) on the
    port's PGEN files with injected noise against the JAX package's
    float32 decode + fast-path synthesis: energy within 2 %, correlation
    above 0.99 (tests/test_torch_synth.py's float32 gates; measured 1.5e-4
    and 0.999997); decoded f0 within 1e-6 relative.  The wav files WGEN
    wrote have the JAX run's lengths and RMS within 10 % of its (the noise
    differs: measured 1.6-2.5 %)."""
    p, j, _, _ = runs
    lay = p.cfg.layout
    N = cfg.cheaptrick_fft_size(FS)
    for u in range(3):
        base = f"utt{u}"
        mgc, lf0, bap = (_read(p.wd, "gen", base, ext, d) for ext, d in
                         (("mgc", lay.mgc_dim), ("lf0", lay.lf0_dim),
                          ("bap", lay.bap_dim)))
        yl = cfg.y_length_for(len(lf0), 5.0, FS)
        noise = np.random.default_rng(u).standard_normal(
            syn.synthesis_stream_len(yl))
        got = p._synthesize(mgc, lf0, bap, noise=noise[None]).numpy()
        want = _jax_wave(p.wd, base, lay, noise)
        got = got.astype(np.float64)
        assert got.shape == want.shape == (yl,)
        assert abs((got ** 2).sum() / (want ** 2).sum() - 1.0) <= 0.02
        assert np.corrcoef(got, want)[0, 1] > 0.99
        lf0_1 = np.where(lf0[:, 0] < -1e9, 0.0, lf0[:, 0]).astype(np.float32)
        f0 = decode.decode_features(torch.as_tensor(lf0_1),
                                    torch.as_tensor(mgc),
                                    torch.as_tensor(bap), FS, N)[0]
        jf0 = jcli.decode_features(jnp.asarray(lf0_1), jnp.asarray(mgc),
                                   jnp.asarray(bap), FS, N)[0]
        np.testing.assert_allclose(f0.numpy(), np.asarray(jf0), rtol=1e-6)
        y, fs = wavio.wavread(p._p("gen", base, "wav"))
        jy, _ = wavio.wavread(j._p("gen", base, "wav"))
        assert fs == FS and len(y) == len(jy) == yl and np.isfinite(y).all()
        assert abs(np.sqrt(np.mean(y ** 2)) / np.sqrt(np.mean(jy ** 2))
                   - 1.0) <= 0.1


def test_synthesize_unseen_matches_jax(runs):
    """PGEND/WGEND from each package's own HALGN (hard counts): the same
    predicted state durations (gen/unseen.lab equal), a finite wav of the
    JAX run's length and RMS within 10 % of its (measured 0.4 %)."""
    p, j, pwav, jwav = runs
    with open(p._p("gen", "unseen", "lab")) as a, \
            open(j._p("gen", "unseen", "lab")) as b:
        assert a.read() == b.read()
    y, _ = wavio.wavread(pwav)
    jy, _ = wavio.wavread(jwav)
    assert pwav == p._p("gen", "unseen", "wav") and len(y) == len(jy)
    assert np.isfinite(y).all()
    assert abs(np.sqrt(np.mean(y ** 2)) / np.sqrt(np.mean(jy ** 2))
               - 1.0) <= 0.1


def test_stages_timed_marked_and_run_on_the_plain_path(runs):
    p, _, _, _ = runs
    for s in pl.STAGES:
        assert p.manifest.done(s)
        assert s in p.stage_seconds
    assert sum(kernels.launches.values()) == 0
    # WGEN at parity=True: the float64 decode and the parity synthesis (it
    # raised before the port had parity analysis)
    mgc, lf0, bap = (rawio.read_f32(p._p("gen", "utt0", e), d) for e, d in
                     (("mgc", 50), ("lf0", 2), ("bap", 25)))
    y = pl.SingingPipeline(pl.PipelineConfig(
        p.wd + "_parity", fs=FS, parity=True, device="cpu"))._synthesize(
            mgc, lf0, bap)
    lf0_1 = np.where(lf0[:, 0] == generation.MAGIC, 0.0, lf0[:, 0])
    want = vocoder.synthesize(*decode.decode_features(
        *(torch.as_tensor(v, dtype=torch.float64) for v in
          (lf0_1, mgc, bap)), FS, cfg.cheaptrick_fft_size(FS)), FS,
        cfg.cheaptrick_fft_size(FS), parity=True, device="cpu")
    assert y.dtype == torch.float64 and torch.equal(y, want)
