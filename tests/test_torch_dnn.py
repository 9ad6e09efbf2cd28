"""The port's DNN (models/acoustic, dataio, training, runtime/checkpoint,
ops/trajectory, ops/generation) and K30's twin against the JAX package on
the CPU.

Weights cross with `acoustic.params_from_numpy` / `params_to_numpy`;
inputs come from numpy seeds.  The trajectory cost and its gradient
(`TrajectoryNLL` over the K28/K29 twins) match `jax.value_and_grad` of
`acoustic.trajectory_cost` within 1e-9 in float64; float32 within the
bounds stated at each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hts_train_world_tpu.features.compose import StreamLayout as JLayout
from hts_train_world_tpu.models import acoustic as jac
from hts_train_world_tpu.models import dataio as jdataio
from hts_train_world_tpu.models import training as jtraining
from hts_train_world_tpu.ops import fftmat as jfftmat
from hts_train_world_tpu.ops import generation as jgen
from hts_train_world_tpu.ops import mlpg as jmlpg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.features.compose import StreamLayout
from hts_train_world_tpu_torch.models import acoustic, dataio, training
from hts_train_world_tpu_torch.ops import fftmat, generation, trajectory
from hts_train_world_tpu_torch.ops import synthesis as syn
from hts_train_world_tpu_torch.runtime.checkpoint import Checkpointer


def jax_tree(cfg, seed=0):
    """The JAX package's initial parameters as numpy."""
    return jax.tree_util.tree_map(
        np.asarray, jac.init_params(jax.random.PRNGKey(seed), cfg))


def jcfg(cfg):
    return jac.ModelConfig(**{f: getattr(cfg, f) for f in (
        "n_in", "n_out", "hidden", "n_speakers", "hidden_activation",
        "output_activation", "mode", "dropout_keep", "dtype")})


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def tree_rel(port_tree, jax_tree_):
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        rel, port_tree, jax_tree_))
    return max(leaves)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

MODELS = [("SD", "sigmoid", "linear"), ("SD", "tanh", "linear"),
          ("SD", "relu", "linear"), ("SD", "linear", "tanh"),
          ("SAT", "sigmoid", "linear"), ("ADAPT", "tanh", "linear")]


@pytest.mark.parametrize("mode,act,out_act", MODELS)
def test_forward_cost_and_step_match_jax(mode, act, out_act):
    """forward, frame_cost and one Adam step (si / sd / variance groups)
    from the same parameters, float32 within 1e-5 relative."""
    cfg = acoustic.ModelConfig(n_in=12, n_out=7, hidden=(16, 24),
                               n_speakers=3, hidden_activation=act,
                               output_activation=out_act, mode=mode)
    tree = jax_tree(jcfg(cfg))
    model = acoustic.params_from_numpy(tree, cfg, device="cpu")
    assert tree_rel(acoustic.params_to_numpy(model), tree) == 0.0
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 12)).astype(np.float32)
    y = rng.standard_normal((64, 7)).astype(np.float32)
    spk = rng.integers(0, 3, 64).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jo, jv = jac.forward(jp, jnp.asarray(x), jnp.asarray(spk), jcfg(cfg))
    po, pv = model(torch.as_tensor(x), torch.as_tensor(spk))
    assert rel(po.detach(), jo) <= 1e-5 and rel(pv.detach(), jv) <= 1e-5
    assert abs(float(acoustic.frame_cost(po, torch.as_tensor(y), pv))
               - float(jac.frame_cost(jo, jnp.asarray(y), jv))) <= 1e-5
    jopt = jac.make_optimizer(1e-3, 5e-3 if mode == "ADAPT" else 0.0, 1e-4)
    jstep = jac.make_train_step(jcfg(cfg), jopt)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y),
             "spkr": jnp.asarray(spk)}
    jp2, _, jloss = jstep(jp, jopt.init(jp), batch)
    opt = acoustic.make_optimizer(model, 1e-3,
                                  5e-3 if mode == "ADAPT" else 0.0, 1e-4)
    pred, var = model(torch.as_tensor(x), torch.as_tensor(spk))
    loss = acoustic.frame_cost(pred, torch.as_tensor(y), var)
    loss.backward()
    opt.step()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert tree_rel(acoustic.params_to_numpy(model), jax.tree_util.tree_map(
        np.asarray, jp2)) <= 1e-5


def test_init_params_draws_from_the_generator():
    """Truncated normal / sqrt(fan_in) from a torch.Generator: the same
    seed gives the same weights, within [-2, 2] / sqrt(fan_in), with the
    standard deviation of a normal truncated at 2 (0.880)."""
    cfg = acoustic.ModelConfig(n_in=400, n_out=30, hidden=(300,),
                               n_speakers=2, mode="SAT")
    a = acoustic.init_params(torch.Generator().manual_seed(3), cfg)
    b = acoustic.init_params(torch.Generator().manual_seed(3), cfg)
    c = acoustic.init_params(torch.Generator().manual_seed(4), cfg)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                  b.parameters()))
    assert not torch.equal(a.layers[0].si_w, c.layers[0].si_w)
    w = a.layers[0].si_w.detach().double() * np.sqrt(400)
    assert float(w.abs().max()) <= 2.0
    assert abs(float(w.std()) - 0.8796) < 0.01
    assert a.layers[0].sd_w.shape == (2, 300)
    assert not hasattr(a.layers[1], "sd_w")
    assert torch.equal(a.log_var, torch.zeros(2, 30))


def test_dropout_draws_from_a_generator():
    cfg = acoustic.ModelConfig(n_in=5, n_out=3, hidden=(64,),
                               dropout_keep=0.5)
    model = acoustic.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(8, 5, generator=torch.Generator().manual_seed(1))
    spk = torch.zeros(8, dtype=torch.long)
    a, _ = model(x, spk, torch.Generator().manual_seed(2))
    b, _ = model(x, spk, torch.Generator().manual_seed(2))
    c, _ = model(x, spk)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# the trajectory cost (K28 / K29 twins)
# ---------------------------------------------------------------------------

FEATS = ((3, 1, 2), (0, 1, 0))


def _traj_inputs(T, dtype, seed=0):
    fd, mf = FEATS
    D = sum(fd)
    ncol = sum(mf) + 3 * D
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, ncol)).astype(dtype),
            rng.standard_normal((T, ncol)).astype(dtype),
            (0.3 * rng.standard_normal(ncol)).astype(dtype),
            np.exp(0.2 * rng.standard_normal(D)).astype(dtype))


def _both(pred, target, logv, gv, dtype):
    fd, mf = FEATS

    def jf(p, lv):
        return jac.trajectory_cost(p, jnp.asarray(target), jnp.exp(lv),
                                   jnp.asarray(gv), fd, mf)[0]
    jc, (jgp, jgl) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(logv))
    p = torch.tensor(pred, requires_grad=True)
    lv = torch.tensor(logv, requires_grad=True)
    cost, (c, _) = acoustic.trajectory_cost(
        p, torch.tensor(target), torch.exp(lv), torch.tensor(gv), fd, mf)
    cost.backward()
    return (float(cost.detach()), p.grad.numpy(), lv.grad.numpy(), c.detach()), \
        (float(jc), np.asarray(jgp), np.asarray(jgl))


@pytest.mark.parametrize("T", [2, 3, 5, 40])
def test_trajectory_cost_and_grad_match_jax_f64(T):
    """Cost, d/dpred and d/dlog_var against jax.value_and_grad of
    acoustic.trajectory_cost in float64 within 1e-9 (relative to each
    array's largest magnitude); T = 2-5 reach every band's edge (the JAX
    package's _ldlt_ds needs T >= 2; gradcheck below takes T = 1)."""
    (c, gp, gl, _), (jc, jgp, jgl) = _both(*_traj_inputs(T, np.float64),
                                           np.float64)
    assert abs(c - jc) <= 1e-9 * abs(jc)
    assert rel(gp, jgp) <= 1e-9 and rel(gl, jgl) <= 1e-9


def test_trajectory_cost_and_grad_match_jax_f32():
    """float32 on both sides (JAX trains in float32): the cost within
    1e-6 relative, the gradients within 1e-5 of each array's largest
    magnitude (the LDL^T recursions over 128 frames round differently in
    the two packages; measured on this input: the cost equal, the
    gradients 1.0e-7 and 1.9e-9)."""
    (c, gp, gl, _), (jc, jgp, jgl) = _both(*_traj_inputs(128, np.float32),
                                           np.float32)
    assert abs(c - jc) <= 1e-6 * abs(jc)
    assert rel(gp, jgp) <= 1e-5 and rel(gl, jgl) <= 1e-5


def test_trajectory_statics_match_dense_mlpg():
    """The generated statics against mlpg_dense (a dense solve of the same
    normal equations), as tests/test_model.py holds the JAX package."""
    pred, target, logv, gv = _traj_inputs(30, np.float64, seed=2)
    fd, mf = FEATS
    var = np.exp(logv)
    _, (c, _) = acoustic.trajectory_cost(
        torch.tensor(pred), torch.tensor(target), torch.tensor(var),
        torch.tensor(gv), fd, mf)
    _, mu = acoustic.split_streams(torch.tensor(pred), fd, mf)
    _, vs = acoustic.split_streams(torch.tensor(np.broadcast_to(
        var, pred.shape).copy()), fd, mf)
    want = jmlpg.mlpg_dense(mu.numpy(), vs.numpy())
    np.testing.assert_allclose(c.numpy(), want, atol=1e-8)


@pytest.mark.parametrize("T,windows", [
    (17, trajectory.DEFAULT_WINDOWS), (1, trajectory.DEFAULT_WINDOWS),
    (6, ((1.0,), (-0.5, 0.0, 0.5))),
    (2, ((1.0,), (-0.5, 0.0, 0.5), (1.0, -2.0, 1.0)))])
def test_trajectory_nll_gradcheck(T, windows):
    """torch.autograd.gradcheck of TrajectoryNLL over the twins in
    float64, every output's cotangent live, B = 2."""
    rng = np.random.default_rng(T)
    W, D = len(windows), 3
    mu = torch.tensor(rng.standard_normal((2, T, W, D)), requires_grad=True)
    prec = torch.tensor(np.exp(0.3 * rng.standard_normal((2, T, W, D))),
                        requires_grad=True)
    s = torch.tensor(rng.standard_normal((2, T, D)))
    assert torch.autograd.gradcheck(
        lambda m, p: trajectory.TrajectoryNLL.apply(m, p, s, windows),
        (mu, prec))


def test_trajectory_forward_plain_matches_the_parts():
    """The forward twin's saved factors and outputs against the JAX
    package's pieces: mlpg for c, the band of build_banded_normal, the d
    of _ldlt_ds for logdet; B = 3 in one call equals three calls."""
    rng = np.random.default_rng(5)
    mu = rng.standard_normal((3, 25, 3, 4))
    prec = np.exp(0.4 * rng.standard_normal((3, 25, 3, 4)))
    s = rng.standard_normal((3, 25, 4))
    c, q, ld, saved = trajectory.trajectory_forward_plain(
        torch.tensor(mu), torch.tensor(prec), torch.tensor(s))
    assert saved.shape == (6, 3, 25, 4)
    wins = tuple(tuple(w) for w in jmlpg.DEFAULT_WINDOWS)
    for b in range(3):
        np.testing.assert_allclose(c[b].numpy(), np.asarray(jmlpg.mlpg(
            jnp.asarray(mu[b]), jnp.asarray(1.0 / prec[b]), wins)),
            rtol=0, atol=1e-12)
        for d in range(4):
            diags, _ = jmlpg.build_banded_normal(
                jnp.asarray(mu[b, :, :, d]), jnp.asarray(prec[b, :, :, d]),
                wins)
            np.testing.assert_allclose(saved[3:, b, :, d].numpy(),
                                       np.asarray(diags), rtol=1e-14)
            _, ds, _, _ = jac._ldlt_ds(diags)
            assert abs(float(ld[b, d]) - float(jnp.sum(jnp.log(ds)))) \
                <= 1e-12 * abs(float(ld[b, d])) + 1e-12
            e = s[b, :, d] - c[b, :, d].numpy()
            A = np.diag(np.asarray(diags[0]))
            for k in (1, 2):
                A += np.diag(np.asarray(diags[k])[:-k], k) \
                    + np.diag(np.asarray(diags[k])[:-k], -k)
            assert abs(float(q[b, d]) - e @ A @ e) <= 1e-10 * abs(e @ A @ e)
        one = trajectory.trajectory_forward_plain(
            torch.tensor(mu[b:b + 1]), torch.tensor(prec[b:b + 1]),
            torch.tensor(s[b:b + 1]))
        assert torch.equal(one[0][0], c[b]) and torch.equal(one[1][0], q[b])


def test_trajectory_wrappers_launch_nothing_on_cpu():
    kernels.reset_counts()
    pred, target, logv, gv = _traj_inputs(8, np.float32)
    p = torch.tensor(pred, requires_grad=True)
    cost, _ = acoustic.trajectory_cost(p, torch.tensor(target),
                                       torch.exp(torch.tensor(logv)),
                                       torch.tensor(gv), *FEATS)
    cost.backward()
    assert sum(kernels.launches.values()) == 0
    with pytest.raises(ValueError, match="trajectory"):
        trajectory.trajectory_forward_plain(
            torch.zeros(1, 4, 2, 3), torch.ones(1, 4, 2, 3),
            torch.zeros(1, 4, 3), windows=((1.0,), (1.0, 0.0, 0.0, 1.0)))


# ---------------------------------------------------------------------------
# K30's twin: synthesis's mid-pass
# ---------------------------------------------------------------------------


def test_midpass_twin_matches_jax_products():
    """midpass_plain on the port's min-phase and noise DFT products
    against the JAX package's mid-pass expressions (ops/synthesis.py:
    195-209, 228-232) in float64 within 1e-12 of each array's peak, and
    `responses` against the JAX irfft of those products."""
    rng = np.random.default_rng(30)
    N, H = 256, 129
    log_p = rng.standard_normal((2, 5, H)) - 3.0
    log_a = rng.standard_normal((2, 5, H)) - 4.0
    noise = rng.standard_normal((2, 5, N))
    shift = rng.uniform(0, 1.0 / 16000, (2, 5))
    fs = 16000
    t = torch.as_tensor
    lpr, lpi = fftmat.minphase_log_matmul(t(log_p), N)
    lar, lai = fftmat.minphase_log_matmul(t(log_a), N)
    nre, nim = fftmat.rfft_matmul(t(noise), N)
    coef = t(2.0 * np.pi * shift * fs / N)
    got = syn.midpass_plain(lpr, lpi, lar, lai, nre, nim, coef)
    re, im = jfftmat.minphase_matmul(jnp.asarray(log_p), N)
    re2 = jnp.cos(jnp.asarray(2.0 * np.pi * shift * fs / N)[..., None]
                  * jnp.arange(H))
    im2 = jnp.sqrt(1.0 - re2 * re2)
    jnre, jnim = jfftmat.rfft_matmul(jnp.asarray(noise), N)
    are, aim = jfftmat.minphase_matmul(jnp.asarray(log_a), N)
    want = (re * re2 + im * im2, im * re2 - re * im2,
            are * jnre - aim * jnim, are * jnim + aim * jnre)
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-12
    per, aper = syn.responses(t(log_p), t(log_a), t(noise), t(shift), fs, N)
    np.testing.assert_allclose(
        per.numpy(), np.asarray(jfftmat.irfft_scaled_matmul(
            want[0], want[1], N)), rtol=0, atol=1e-12 * float(
                jnp.abs(want[0]).max() * N))
    np.testing.assert_allclose(
        aper.numpy(), np.asarray(jfftmat.irfft_scaled_matmul(
            want[2], want[3], N)), rtol=0, atol=1e-12 * float(
                jnp.abs(want[2]).max() * N))


def test_midpass_wrapper_is_its_twin_on_cpu():
    rng = np.random.default_rng(31)
    ins = [torch.tensor(rng.standard_normal((3, 4, 9)), dtype=torch.float32)
           for _ in range(6)]
    coef = torch.tensor(rng.uniform(0, 0.01, (3, 4)), dtype=torch.float32)
    kernels.reset_counts()
    got = syn.midpass(*ins, coef)
    want = syn.midpass_plain(*ins, coef)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sum(kernels.launches.values()) == 0


# ---------------------------------------------------------------------------
# optimizers and data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", acoustic.OPTIMIZERS)
def test_optimizer_two_steps_match_optax(name):
    """Two steps of every optimizer name against the JAX package's
    make_optimizer (optax multi_transform) from the same parameters and
    batch, float64 within 1e-10 relative; SAT with an adapt rate, so the
    si / sd / variance groups each step at their own rate."""
    cfg = acoustic.ModelConfig(n_in=6, n_out=4, hidden=(8,), n_speakers=2,
                               mode="SAT", dtype="float64")
    tree = jax_tree(jcfg(cfg), seed=1)
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal((32, 6)), rng.standard_normal((32, 4))
    spk = rng.integers(0, 2, 32).astype(np.int32)
    rates = (1e-2, 3e-2, 1e-3)
    jopt = jac.make_optimizer(*rates, optimizer=name)
    jstep = jac.make_train_step(jcfg(cfg), jopt)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    st = jopt.init(jp)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y),
             "spkr": jnp.asarray(spk)}
    model = acoustic.params_from_numpy(tree, cfg, device="cpu")
    opt = acoustic.make_optimizer(model, *rates, optimizer=name)
    for _ in range(2):
        jp, st, _ = jstep(jp, st, batch)
        opt.zero_grad()
        pred, var = model(torch.as_tensor(x), torch.as_tensor(spk))
        acoustic.frame_cost(pred, torch.as_tensor(y), var).backward()
        opt.step()
    assert tree_rel(acoustic.params_to_numpy(model), jax.tree_util.tree_map(
        np.asarray, jp)) <= 1e-10
    assert len(opt.param_groups) == 3
    with pytest.raises(ValueError, match="optimizer"):
        acoustic.make_optimizer(model, optimizer="lamb")
    assert optax.__version__ == "0.2.6"


def test_dataio_batches_equal_jax(tmp_path):
    """load_pair, train_valid_split, FrameDataset (random and epoch
    batches) and UtteranceDataset give the JAX package's arrays for the
    same seed."""
    rng = np.random.default_rng(4)
    pairs, jpairs = [], []
    for i, T in enumerate((37, 64, 90, 12)):
        fi, fo = str(tmp_path / f"u{i}.ffi"), str(tmp_path / f"u{i}.ffo")
        rng.standard_normal((T, 5)).astype("<f4").tofile(fi)
        rng.standard_normal((T + 3, 7)).astype("<f4").tofile(fo)
        pairs.append(dataio.load_pair(f"u{i}", fi, fo, 5, 7, speaker=i % 2))
        jpairs.append(jdataio.load_pair(f"u{i}", fi, fo, 5, 7,
                                        speaker=i % 2))
    tr, va = dataio.train_valid_split(pairs, 0.3, 9)
    jtr, jva = jdataio.train_valid_split(jpairs, 0.3, 9)
    assert [p.name for p in tr] == [p.name for p in jtr]
    assert [p.name for p in va] == [p.name for p in jva]
    for a, b in (
            (dataio.FrameDataset(pairs, 16, 3), jdataio.FrameDataset(
                jpairs, 16, 3)),):
        for ba, bb in zip([next(iter(a)) for _ in range(3)],
                          [next(iter(b)) for _ in range(3)]):
            assert all(np.array_equal(ba[k], bb[k]) for k in ba)
        for ba, bb in zip(a.epoch_batches(), b.epoch_batches()):
            assert all(np.array_equal(ba[k], bb[k]) for k in ba)
    ua, ub = iter(dataio.UtteranceDataset(pairs, seed=6)), iter(
        jdataio.UtteranceDataset(jpairs, seed=6))
    for _ in range(6):
        ba, bb = next(ua), next(ub)
        assert ba["x"].shape[0] % 64 == 0
        assert all(np.array_equal(ba[k], bb[k]) for k in ba)


# ---------------------------------------------------------------------------
# checkpoints and training
# ---------------------------------------------------------------------------


def test_checkpointer_round_trip_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore() is None
    for step in (1, 5, 9):
        ck.save(step, {"params": {"w": torch.full((2,), float(step))},
                       "opt_state": {"n": step}})
    assert ck.steps() == [5, 9] and ck.latest_step() == 9
    got = ck.restore()
    assert torch.equal(got["params"]["w"], torch.full((2,), 9.0))
    assert ck.restore(5)["opt_state"]["n"] == 5
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 9


@pytest.fixture
def carried(monkeypatch):
    """The port's init_params returns the JAX package's initial
    parameters for the same seed (no knob in the port)."""
    def init(generator, cfg):
        return acoustic.params_from_numpy(
            jax_tree(jcfg(cfg), seed=generator.initial_seed()), cfg,
            device=generator.device)
    monkeypatch.setattr(acoustic, "init_params", init)


def _pairs(n_in, n_out, seed=8):
    rng = np.random.default_rng(seed)
    return [dataio.UtterancePair(
        f"u{i}", rng.standard_normal((T, n_in)).astype(np.float32),
        (0.5 * rng.standard_normal((T, n_out))).astype(np.float32))
        for i, T in enumerate((50, 70, 33, 64))]


def _costs(lines):
    return [float(ln.split("cost=")[1].split()[0]) for ln in lines
            if ln.startswith("step ")]


def test_train_frame_mode_matches_jax(tmp_path, carried):
    """training.train in frame mode for 12 steps (logging every 4, saving
    every 8 and at the end, validation on the held-out utterance), then a
    resumed run to 16, against the JAX package's from the same initial
    parameters: the logged costs within 1e-4, the parameters within 1e-4
    relative, the same log lines but the rates."""
    cfg = acoustic.ModelConfig(n_in=9, n_out=6, hidden=(16, 16))
    tc = training.TrainConfig(num_steps=12, batch_size=32, log_interval=4,
                              save_interval=8, valid_fraction=0.25, seed=3)
    pairs = _pairs(9, 6)
    logs, jlogs = [], []
    model = training.train(cfg, tc, pairs, str(tmp_path / "p"),
                           log=logs.append, device="cpu")
    jp = jtraining.train(jcfg(cfg), tc, [jdataio.UtterancePair(
        p.name, p.ffi, p.ffo) for p in pairs], str(tmp_path / "j"),
        log=jlogs.append)
    assert np.allclose(_costs(logs), _costs(jlogs), rtol=0, atol=1e-4)
    assert tree_rel(acoustic.params_to_numpy(model), jax.tree_util.tree_map(
        np.asarray, jp)) <= 1e-4
    strip = [ln.split(" (")[0] if ln.startswith("step ") else
             ln.split("=")[0] for ln in logs]
    assert strip == [ln.split(" (")[0] if ln.startswith("step ") else
                     ln.split("=")[0] for ln in jlogs]
    assert Checkpointer(str(tmp_path / "p")).steps() == [8, 12]
    tc2 = training.TrainConfig(**{**tc.__dict__, "num_steps": 16})
    logs2 = []
    model2 = training.train(cfg, tc2, pairs, str(tmp_path / "p"),
                            log=logs2.append, device="cpu")
    assert logs2[0] == "restored checkpoint at step 12"
    jlogs2 = []
    jp2 = jtraining.train(jcfg(cfg), tc2, [jdataio.UtterancePair(
        p.name, p.ffi, p.ffo) for p in pairs], str(tmp_path / "j"),
        log=jlogs2.append)
    assert jlogs2[0] == logs2[0]
    assert tree_rel(acoustic.params_to_numpy(model2), jax.tree_util.tree_map(
        np.asarray, jp2)) <= 1e-4
    out = training.forward_corpus(model2, pairs[0].ffi)
    jout = jtraining.forward_corpus(jcfg(cfg), jp2, pairs[0].ffi)
    assert out.shape == (50, 6) and rel(out, jout) <= 1e-4


def test_train_trajectory_mode_matches_jax(tmp_path, carried):
    """training.train in trajectory mode (one padded utterance a step,
    MSD and GV terms) for 6 steps against the JAX package's: the logged
    costs within 1e-4 relative, the parameters within 1e-4."""
    fd, mf = (3, 1), (0, 1)
    ncol = sum(mf) + 3 * sum(fd)
    cfg = acoustic.ModelConfig(n_in=8, n_out=ncol, hidden=(16,))
    tc = training.TrainConfig(num_steps=6, batch_size=1, log_interval=2,
                              save_interval=6, trajectory=True,
                              valid_fraction=0.0, seed=4)
    pairs = _pairs(8, ncol, seed=9)
    gv = np.exp(0.1 * np.random.default_rng(3).standard_normal(4))
    logs, jlogs = [], []
    model = training.train(cfg, tc, pairs, str(tmp_path / "p"),
                           feature_dims=fd, msd_flags=mf, gv_variances=gv,
                           log=logs.append, device="cpu")
    jp = jtraining.train(jcfg(cfg), tc, [jdataio.UtterancePair(
        p.name, p.ffi, p.ffo) for p in pairs], str(tmp_path / "j"),
        feature_dims=fd, msd_flags=mf, gv_variances=gv, log=jlogs.append)
    c, jc = np.array(_costs(logs)), np.array(_costs(jlogs))
    assert len(c) == 3 and np.abs(c - jc).max() <= 1e-4 * np.abs(jc).max()
    assert tree_rel(acoustic.params_to_numpy(model), jax.tree_util.tree_map(
        np.asarray, jp)) <= 1e-4


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        training.train(acoustic.ModelConfig(n_in=2, n_out=2, hidden=(2,)),
                       training.TrainConfig(num_steps=1), _pairs(2, 2),
                       "/nonexistent-dir-never-created")


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


def test_generate_parameters_matches_jax_f64():
    """generate_parameters (one float64 MLPG over all streams) against the
    JAX package's per-stream MLPG in float64: statics within 1e-9 of each
    stream's largest magnitude, V/UV and MAGIC equal; lf0_to_f0 equal."""
    lay = StreamLayout()
    rng = np.random.default_rng(12)
    T = 60
    ffo = rng.standard_normal((T, lay.ffo_dim))
    ffo[:, 3 * lay.mgc_dim] = rng.uniform(0, 1, T)   # the lf0 MSD flag
    var = np.exp(rng.standard_normal(lay.ffo_dim))
    g = generation.generate_parameters(torch.tensor(ffo), torch.tensor(var),
                                       lay)
    j = jgen.generate_parameters(jnp.asarray(ffo), jnp.asarray(var),
                                 JLayout())
    assert np.array_equal(g.vuv.numpy(), np.asarray(j.vuv))
    for n in generation.STREAMS:
        a, b = getattr(g, n).numpy(), np.asarray(getattr(j, n))
        assert a.dtype == np.float64 and a.shape == b.shape
        live = b != jgen.MAGIC
        assert np.array_equal(a == generation.MAGIC, ~live)
        assert rel(a[live], b[live]) <= 1e-9
    np.testing.assert_allclose(
        generation.lf0_to_f0(g.lf0, g.vuv).numpy(),
        np.asarray(jgen.lf0_to_f0(j.lf0, j.vuv)), rtol=1e-12)
