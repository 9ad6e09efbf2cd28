"""The DNN acoustic model: the port's counterpart of
`hts_train_world_tpu/models/acoustic.py` (DNNDefine.py / DNNTraining.py,
SURVEY.md D1-D4), all but `shard_params` (ROADMAP Queue A 8).

- An MLP (default 3x2048 sigmoid, configure.ac:932-970) with per-speaker
  additive hidden biases `sd_w` for SAT/ADAPT (DNNDefine.py:143-155) and
  trainable per-speaker per-dim output variances (DNNDefine.py:177-189),
  as an `nn.Module` whose weights keep the JAX package's layout (x @ W).
- `frame_cost`: the frame Gaussian NLL (DNNDefine.py:231-237).
- `trajectory_cost`: MLPG in the graph + the MSD term + the GV penalty
  (DNNDefine.py:240-399); the banded solve, its log-det and quadratic form
  and their gradient are `ops.trajectory.TrajectoryNLL` (K28 forward, K29
  backward on the card).  The JAX package's quirks are kept: the MSD
  covdet carries an extra factor T, the GV is the population variance, and
  the cost runs over every frame it is given (padded ones too).
- `make_optimizer`: optax 0.2.6's adam / sgd / momentum / adagrad /
  adadelta / rmsprop update rules written out (`OptaxRule`), one param
  group each for the si, sd and variance learning rates (DNNDefine.py:
  194-228, the JAX package's multi_transform).

`params_from_numpy` / `params_to_numpy` carry weights across as the JAX
package's parameter tree of numpy arrays.  Initialisation and dropout draw
from explicit `torch.Generator`s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hts_train_world_tpu_torch.ops import mlpg as mlpg_mod
from hts_train_world_tpu_torch.ops import trajectory

LOG_2PI = float(np.log(2.0 * np.pi))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    n_in: int = 1186
    n_out: int = 238
    hidden: Tuple[int, ...] = (2048, 2048, 2048)
    n_speakers: int = 1
    hidden_activation: str = "sigmoid"
    output_activation: str = "linear"
    mode: str = "SD"  # SD | SAT | ADAPT (DNNTraining.py:102-108)
    dropout_keep: float = 1.0
    dtype: str = "float32"


_ACT = {"linear": lambda x: x, "sigmoid": torch.sigmoid,
        "tanh": torch.tanh, "relu": torch.relu}


def _truncated_normal(generator, shape, dtype):
    """Standard normal truncated to [-2, 2] by the inverse CDF (as
    jax.random.truncated_normal draws it), from `generator`."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=generator.device)
    x = math.sqrt(2.0) * torch.special.erfinv(lo + (hi - lo) * u)
    return torch.clamp(x, -2.0, 2.0).to(dtype)


class AcousticModel(nn.Module):
    """inference (DNNDefine.py:113-191): `forward(x, spkr_ids)` ->
    (outputs (N, n_out), variances (N, n_out))."""

    def __init__(self, cfg: ModelConfig, layers, log_var):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList()
        for layer in layers:
            m = nn.Module()
            for k, v in layer.items():
                setattr(m, k, nn.Parameter(v))
            self.layers.append(m)
        self.log_var = nn.Parameter(log_var)

    def forward(self, x, spkr_ids, dropout_generator=None):
        cfg = self.cfg
        act = _ACT[cfg.hidden_activation]
        out_act = _ACT[cfg.output_activation]
        onehot = nn.functional.one_hot(spkr_ids.long(),
                                       cfg.n_speakers).to(x.dtype)
        h = x
        n_hidden = len(cfg.hidden)
        for i, layer in enumerate(self.layers):
            z = h @ layer.si_w + layer.si_b
            if hasattr(layer, "sd_w"):
                z = z + onehot @ layer.sd_w
            if i < n_hidden:
                h = act(z)
                if dropout_generator is not None and cfg.dropout_keep < 1.0:
                    keep = torch.rand(h.shape, generator=dropout_generator,
                                      device=h.device) < cfg.dropout_keep
                    h = torch.where(keep, h / cfg.dropout_keep,
                                    torch.zeros_like(h))
            else:
                h = out_act(z)
        variances = onehot @ torch.exp(self.log_var)
        return h, variances


def init_params(generator: torch.Generator, cfg: ModelConfig
                ) -> AcousticModel:
    """Truncated-normal 1/sqrt(fan_in) init (DNNDefine.py:135-141) drawn
    from `generator`, on the generator's device."""
    dtype = getattr(torch, cfg.dtype)
    dev = generator.device
    dims = [cfg.n_in, *cfg.hidden, cfg.n_out]
    layers = []
    for i in range(len(dims) - 1):
        layer = {"si_w": _truncated_normal(generator, (dims[i], dims[i + 1]),
                                           dtype) / np.sqrt(dims[i]),
                 "si_b": torch.zeros(dims[i + 1], dtype=dtype, device=dev)}
        if cfg.mode in ("SAT", "ADAPT") and i < len(dims) - 2:
            layer["sd_w"] = _truncated_normal(
                generator, (cfg.n_speakers, dims[i + 1]), dtype) \
                / np.sqrt(cfg.n_speakers)
        layers.append(layer)
    return AcousticModel(cfg, layers, torch.zeros(
        (cfg.n_speakers, cfg.n_out), dtype=dtype, device=dev))


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"
                      ) -> AcousticModel:
    """The JAX package's parameter tree ({"layers": [{"si_w", "si_b",
    "sd_w"?}], "variance": {"log_var"}}, numpy) as the port's model on
    `device` (copies: the model never shares the arrays' memory)."""
    dtype = getattr(torch, cfg.dtype)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return AcousticModel(cfg, [{k: t(v) for k, v in layer.items()}
                               for layer in tree["layers"]],
                         t(tree["variance"]["log_var"]))


def from_state_dict(cfg: ModelConfig, state) -> AcousticModel:
    """The model whose `state_dict()` was `state` (a checkpoint's
    "params"), on the state's device."""
    layers = [{} for _ in range(len(cfg.hidden) + 1)]
    for key, v in state.items():
        if key.startswith("layers."):
            _, i, name = key.split(".")
            layers[int(i)][name] = v
    return AcousticModel(cfg, layers, state["log_var"])


def params_to_numpy(model: AcousticModel):
    """The model's weights as the JAX package's parameter tree (numpy)."""
    return {"layers": [{k: p.detach().cpu().numpy()
                        for k, p in layer.named_parameters()}
                       for layer in model.layers],
            "variance": {"log_var": model.log_var.detach().cpu().numpy()}}


def frame_cost(pred, target, variances):
    """Gaussian NLL per frame (DNNDefine.py:231-237)."""
    covdet = torch.mean(torch.log(variances))
    mahala = torch.mean((target - pred) ** 2 / variances)
    return 0.5 * (LOG_2PI + covdet + mahala)


def split_streams(mat, feature_dims: Sequence[int], msd_flags: Sequence[int],
                  n_win: int = 3):
    """(T, D_total) laid out [msd? | static | deltas...] per feature type
    -> (msd (T, msd_D), windows (T, n_win, D))."""
    msd_cols, per_win = [], [[] for _ in range(n_win)]
    off = 0
    for dim, flag in zip(feature_dims, msd_flags):
        if flag:
            msd_cols.append(mat[:, off:off + 1])
            off += 1
        for w in range(n_win):
            per_win[w].append(mat[:, off:off + dim])
            off += dim
    msd = (torch.cat(msd_cols, 1) if msd_cols
           else mat.new_zeros((mat.shape[0], 0)))
    return msd, torch.stack([torch.cat(c, 1) for c in per_win], 1)


def trajectory_cost(pred, target, variances, gv_variances,
                    feature_dims: Sequence[int], msd_flags: Sequence[int],
                    n_win: int = 3, windows=mlpg_mod.DEFAULT_WINDOWS,
                    msd_weight: float = 1.0, gv_weight: float = 1e-6):
    """Trajectory-training cost (DNNDefine.py:240-399).  pred/target: (T,
    D_total) laid out stream-wise as [msd? | static | deltas...] per
    feature type.  Returns (cost, (generated statics, msd_pred))."""
    T = pred.shape[0]
    D = int(sum(feature_dims))
    msd_D = int(sum(msd_flags))
    msd_pred, mu = split_streams(pred, feature_dims, msd_flags, n_win)
    msd_obs, obs_wins = split_streams(target, feature_dims, msd_flags, n_win)
    msd_var, var_wins = split_streams(torch.broadcast_to(variances,
                                                         pred.shape),
                                      feature_dims, msd_flags, n_win)
    static_obs = obs_wins[:, 0, :]
    prec = 1.0 / var_wins
    c, q, logdet = trajectory.TrajectoryNLL.apply(
        mu[None].contiguous(), prec[None].contiguous(),
        static_obs[None].contiguous(),
        tuple(tuple(w) for w in windows))
    c = c[0]
    # NLL of the statics under N(c, (W^T S W)^-1)
    trj_cost = (D * T * LOG_2PI - torch.sum(logdet) + torch.sum(q)) \
        / (2.0 * D * T)
    if msd_D:
        msd_prec = 1.0 / msd_var
        # literal DNNDefine.py:362-366, its extra factor T on the covdet
        msd_cost = (msd_D * T * LOG_2PI
                    - T * torch.sum(torch.log(msd_prec))
                    + torch.sum((msd_pred - msd_obs) ** 2 * msd_prec)) \
            / (2.0 * msd_D * T)
    else:
        msd_cost = 0.0
    # GV penalty (DNNDefine.py:368-383), population variances
    pv = torch.var(c, dim=0, correction=0)
    ov = torch.var(static_obs, dim=0, correction=0)
    gv_prec = 1.0 / gv_variances
    gv_cost = (D * LOG_2PI + torch.sum(torch.log(gv_variances))
               + torch.sum((pv - ov) ** 2 * gv_prec)) / (2.0 * D)
    cost = trj_cost + msd_weight * msd_cost + gv_weight * gv_cost
    return cost, (c, msd_pred)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

OPTIMIZERS = ("adam", "sgd", "momentum", "adagrad", "adadelta", "rmsprop")


class OptaxRule(torch.optim.Optimizer):
    """optax 0.2.6's update rules, one per param group (`rule`, `lr`):
    adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root), sgd,
    momentum (sgd with a 0.9 trace), adagrad (accumulator from 0.1, eps
    1e-7 inside the square root), adadelta (rho 0.9, eps 1e-6) and rmsprop
    (decay 0.9, eps 1e-8 inside the square root).  Each step is
    p + (-lr) * u in optax's order of operations; torch.optim's defaults
    differ for adagrad and rmsprop."""

    def __init__(self, groups):
        super().__init__(groups, {})

    @torch.no_grad()
    def step(self, closure=None):
        for g in self.param_groups:
            rule, lr = g["rule"], g["lr"]
            for p in g["params"]:
                if p.grad is None:
                    continue
                gr = p.grad
                st = self.state[p]
                if rule == "adam":
                    if not st:
                        st["count"] = 0
                        st["mu"] = torch.zeros_like(p)
                        st["nu"] = torch.zeros_like(p)
                    st["mu"] = (1 - 0.9) * gr + 0.9 * st["mu"]
                    st["nu"] = (1 - 0.999) * gr ** 2 + 0.999 * st["nu"]
                    st["count"] += 1
                    mh = st["mu"] / (1 - 0.9 ** st["count"])
                    nh = st["nu"] / (1 - 0.999 ** st["count"])
                    u = mh / (torch.sqrt(nh) + 1e-8)
                elif rule in ("sgd", "momentum"):
                    u = gr
                    if rule == "momentum":
                        if not st:
                            st["trace"] = torch.zeros_like(p)
                        st["trace"] = gr + 0.9 * st["trace"]
                        u = st["trace"]
                elif rule == "adagrad":
                    if not st:
                        st["sum_of_squares"] = torch.full_like(p, 0.1)
                    sos = gr * gr + st["sum_of_squares"]
                    st["sum_of_squares"] = sos
                    u = torch.where(sos > 0, torch.rsqrt(sos + 1e-7),
                                    torch.zeros_like(sos)) * gr
                elif rule == "adadelta":
                    if not st:
                        st["e_g"] = torch.zeros_like(p)
                        st["e_x"] = torch.zeros_like(p)
                    st["e_g"] = (1 - 0.9) * gr ** 2 + 0.9 * st["e_g"]
                    u = (torch.sqrt(st["e_x"] + 1e-6)
                         / torch.sqrt(st["e_g"] + 1e-6)) * gr
                    st["e_x"] = (1 - 0.9) * u ** 2 + 0.9 * st["e_x"]
                elif rule == "rmsprop":
                    if not st:
                        st["nu"] = torch.zeros_like(p)
                    st["nu"] = (1 - 0.9) * gr ** 2 + 0.9 * st["nu"]
                    u = torch.rsqrt(st["nu"] + 1e-8) * gr
                else:
                    raise ValueError(f"unknown optimizer {rule!r}")
                p.add_(u * -lr)


def make_optimizer(model: AcousticModel, learning_rate=1e-3,
                   adapt_learning_rate=0.0, variance_learning_rate=1e-5,
                   optimizer: str = "adam") -> OptaxRule:
    """Split si/sd/variance optimizers (DNNDefine.py:194-228): three param
    groups under one rule."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {OPTIMIZERS}")
    si, sd = [], []
    for layer in model.layers:
        for name, p in layer.named_parameters():
            (sd if name.startswith("sd_") else si).append(p)
    groups = [dict(params=si, lr=learning_rate, rule=optimizer),
              dict(params=[model.log_var], lr=variance_learning_rate,
                   rule=optimizer)]
    if sd:
        groups.insert(1, dict(params=sd,
                              lr=adapt_learning_rate or learning_rate,
                              rule=optimizer))
    return OptaxRule(groups)
