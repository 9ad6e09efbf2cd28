"""The feature lane and the synth lane.

- The feature lane, a batch of utterances to training features and their
  MLPG trajectory: counterpart of the JAX package's feature lane
  (`bench.py:211-225`, `feature_pipeline_throughput`): batched analysis ->
  lf0/mgc/bap encode (K6) -> delta windows over [mgc | bap] (K7) -> MLPG
  with variances 1 + 0.1 |means| (K8), whose trajectory recovers the
  statics.
- The synth lane, HTS features to waveforms: the body of the JAX
  pipeline's WGEN stage (`runtime/pipeline.py:490-496`, the `synth` CLI
  and `models/pgen.generate_waveform`: `cli.decode_features` ->
  `vocoder.synthesize`), batched the way `parallel/batch.py:_batch_synth`
  batches synthesis: decode (K12) -> pulse count (K9) -> synthesis
  (K9-K11).
"""
from __future__ import annotations

import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.features import decode, encode, windows
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


def synth_lane_stages(lf0, mgc, bap, fs: int, frame_period: float = 5.0,
                      noise=None, seed: int = 0):
    """The synth lane one stage at a time on lf0's device, yielding (stage
    name, result): "decode" (f0, sp, ap), "count" (the pulse bucket) and
    "synthesis" (the waveforms (B, y_length))."""
    f0, sp, ap = decode.decode_features(lf0, mgc, bap, fs,
                                        cfg.cheaptrick_fft_size(fs))
    yield "decode", (f0, sp, ap)
    yield from batch_mod.synth_stages(f0, sp, ap, fs, frame_period, noise,
                                      seed)


def synth_lane(lf0, mgc, bap, fs: int, frame_period: float = 5.0,
               noise=None, seed: int = 0, device="cuda"):
    """lf0 (B, T), mgc (B, T, mgc_dim), bap (B, T, bap_dim), as
    `feature_lane` encodes them -> waveforms (B, (T-1) fp fs + 1) on
    `device`.  `noise` (B, y_length+16) is drawn from `seed` when not
    given."""
    lf0, mgc, bap = (device_mod.as_input(v, device) for v in (lf0, mgc, bap))
    *_, (_, y) = synth_lane_stages(lf0, mgc, bap, fs, frame_period, noise,
                                   seed)
    return y
