"""The feature lane: a batch of utterances to training features and their
MLPG trajectory.

Counterpart of the JAX package's feature lane (`bench.py:211-225`,
`feature_pipeline_throughput`): batched analysis -> lf0/mgc/bap encode
(K6) -> delta windows over [mgc | bap] (K7) -> MLPG with variances
1 + 0.1 |means| (K8), whose trajectory recovers the statics.
"""
from __future__ import annotations

import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.features import encode, windows
from hts_train_world_tpu_torch.ops import mlpg as mlpg_mod
from hts_train_world_tpu_torch.parallel import batch as batch_mod


def feature_lane_stages(xs, fs: int, frame_period: float = 5.0,
                        mgc_dim: int = 50, bap_dim: int = 25):
    """The lane one stage at a time on xs's device, yielding (stage name,
    result): "analysis" (f0, sp, ap), "encode" (lf0, mgc, bap), "expand"
    the (B, T, 3 (mgc_dim + bap_dim)) windowed features, and "mlpg"
    (lf0, mgc, bap, traj)."""
    *_, (_, (_, f0, sp, ap)) = batch_mod.analyze_stages(xs, fs, frame_period)
    yield "analysis", (f0, sp, ap)
    lf0, mgc, bap = encode.encode_features(f0, sp, ap, fs,
                                           cfg.cheaptrick_fft_size(fs),
                                           mgc_dim, bap_dim)
    yield "encode", (lf0, mgc, bap)
    ffo = windows.expand(torch.cat([mgc, bap], dim=-1))
    yield "expand", ffo
    B, T, D3 = ffo.shape
    means = ffo.reshape(B, T, 3, D3 // 3)
    traj = mlpg_mod.mlpg(means, 1.0 + 0.1 * means.abs())
    yield "mlpg", (lf0, mgc, bap, traj)


def feature_lane(xs, fs: int, frame_period: float = 5.0, mgc_dim: int = 50,
                 bap_dim: int = 25, device="cuda"):
    """xs: (B, L) equal-length utterances -> (lf0 (B, T), mgc (B, T,
    mgc_dim), bap (B, T, bap_dim), traj (B, T, mgc_dim + bap_dim)) on
    `device`."""
    xs = device_mod.as_input(xs, device)
    *_, (_, out) = feature_lane_stages(xs, fs, frame_period, mgc_dim,
                                       bap_dim)
    return out
