"""Acoustic-model training: the port's counterpart of
`hts_train_world_tpu/models/training.py` (DNNTraining.py, SURVEY.md D1).

Frame-mode Gaussian-NLL training and trajectory-mode fine-tuning with the
MLPG-in-the-graph cost (K28/K29 on the card), periodic checkpoints with
restore, the validation cost on save and the log line every
`log_interval` steps (the reference's log_interval / save_interval /
restore_ckpt semantics, DNNTraining.py:314-379), in the JAX package's
order: resume from the latest checkpoint (parameters, optimizer state and
step), save at `save_interval` and at the last step, validate on the first
8 validation batches.  Trajectory mode takes one padded utterance a step,
the first frame's variances, and its cost over all of its padded frames
(the `length` a batch carries is not read, as in the JAX package).

The running losses stay on the device and are read at the log interval
only; the log line is the JAX package's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.models import acoustic, dataio
from hts_train_world_tpu_torch.runtime.checkpoint import Checkpointer


@dataclasses.dataclass
class TrainConfig:
    """configure.ac:932-970 defaults: 3x2048 sigmoid, Adam 1e-3, batch 256."""
    num_steps: int = 10000
    batch_size: int = 256
    learning_rate: float = 1e-3
    variance_learning_rate: float = 1e-5
    adapt_learning_rate: float = 0.0
    optimizer: str = "adam"
    log_interval: int = 100
    save_interval: int = 1000
    max_to_keep: int = 5
    valid_fraction: float = 0.05
    seed: int = 12345
    # trajectory mode
    trajectory: bool = False
    msd_weight: float = 1.0
    gv_weight: float = 1e-6


def _batch_to(batch, dev):
    out = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if out["spkr"].dim() == 0:
        out["spkr"] = out["spkr"][None]
    return out


def train(model_cfg: acoustic.ModelConfig, train_cfg: TrainConfig,
          pairs: Sequence[dataio.UtterancePair], ckpt_dir: str,
          feature_dims=None, msd_flags=None, gv_variances=None,
          log: Callable[[str], None] = print, device="cuda"
          ) -> acoustic.AcousticModel:
    """Returns the trained model on `device`.  Resumes from the latest
    checkpoint in `ckpt_dir`.  The initial weights are drawn on the CPU
    from `train_cfg.seed`, so every device starts from the same ones."""
    dev = device_mod.resolve(device)
    model = acoustic.init_params(
        torch.Generator().manual_seed(train_cfg.seed), model_cfg).to(dev)
    opt = acoustic.make_optimizer(model, train_cfg.learning_rate,
                                  train_cfg.adapt_learning_rate,
                                  train_cfg.variance_learning_rate,
                                  train_cfg.optimizer)
    if train_cfg.trajectory:
        gv_var = torch.as_tensor(
            gv_variances if gv_variances is not None
            else np.ones(int(sum(feature_dims))), dtype=torch.float32,
            device=dev)

        def loss_fn(batch):
            pred, var = model(batch["x"], batch["spkr"])
            cost, _ = acoustic.trajectory_cost(
                pred, batch["y"], var[0], gv_var, tuple(feature_dims),
                tuple(msd_flags), msd_weight=train_cfg.msd_weight,
                gv_weight=train_cfg.gv_weight)
            return cost
        data = iter(dataio.UtteranceDataset(list(pairs),
                                            seed=train_cfg.seed))
        valid_batches = []
    else:
        def loss_fn(batch):
            pred, var = model(batch["x"], batch["spkr"])
            return acoustic.frame_cost(pred, batch["y"], var)
        tr, va = dataio.train_valid_split(list(pairs),
                                          train_cfg.valid_fraction,
                                          train_cfg.seed)
        data = iter(dataio.FrameDataset(tr, train_cfg.batch_size,
                                        train_cfg.seed))
        valid_batches = (list(dataio.FrameDataset(
            va, train_cfg.batch_size, 0).epoch_batches())[:8] if va else [])

    ckpt = Checkpointer(ckpt_dir, train_cfg.max_to_keep)
    start = ckpt.latest_step() or 0
    if start:
        restored = ckpt.restore(map_location=dev)
        if restored is not None:
            model.load_state_dict(restored["params"])
            opt.load_state_dict(restored["opt_state"])
            log(f"restored checkpoint at step {start}")

    @torch.no_grad()
    def valid_cost():
        if not valid_batches:
            return float("nan")
        costs = []
        for b in valid_batches:
            b = _batch_to(b, dev)
            pred, var = model(b["x"], b["spkr"])
            costs.append(float(acoustic.frame_cost(pred, b["y"], var)))
        return float(np.mean(costs))

    t0 = time.time()
    running = []
    for step in range(start + 1, train_cfg.num_steps + 1):
        batch = _batch_to(next(data), dev)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        opt.step()
        running.append(loss.detach())
        if step % train_cfg.log_interval == 0:
            dt = time.time() - t0
            mean = float(torch.stack(running).double().mean())
            log(f"step {step}: cost={mean:.5f} "
                f"({train_cfg.log_interval / max(dt, 1e-9):.1f} steps/s)")
            running = []
            t0 = time.time()
        if step % train_cfg.save_interval == 0 \
                or step == train_cfg.num_steps:
            ckpt.save(step, {"params": model.state_dict(),
                             "opt_state": opt.state_dict()})
            log(f"saved step {step}; valid cost={valid_cost():.5f}")
    return model


@torch.no_grad()
def forward_corpus(model: acoustic.AcousticModel, ffi,
                   speaker: int = 0) -> torch.Tensor:
    """DNNSynthesis.py equivalent: forward one utterance's inputs (T,
    n_in) on the model's device -> (T, n_out) float32."""
    dev = model.log_var.device
    x = torch.as_tensor(ffi, dtype=torch.float32, device=dev)
    pred, _ = model(x, torch.full((x.shape[0],), speaker, dtype=torch.long,
                                  device=dev))
    return pred
