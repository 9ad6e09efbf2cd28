"""Length-bucketed batched analysis and feature extraction of a corpus.

Counterpart of `hts_train_world_tpu/parallel/bucketing.py`: utterance
lengths are quantised onto a geometric grid, each utterance is zero-padded
to its bucket, each bucket runs through the batched analyser in groups of
at most `max_batch`, and every result is trimmed to its utterance's true
frame count (cfg.samples_for_dio of the true length, the `features`
target's contract, data/Makefile.in:209-215).  Padded rows never reach a
real row, so a group of any size gives each utterance the same output.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.features import encode
from hts_train_world_tpu_torch.parallel import batch as batch_mod


def bucket_length(n: int, growth: float = 1.26, align: int = 2048,
                  min_len: int = 4096) -> int:
    """Smallest bucket >= n on a geometric grid (aligned to `align`)."""
    if n <= min_len:
        return min_len
    steps = math.ceil(math.log(n / min_len) / math.log(growth))
    b = min_len * growth ** steps
    return int(math.ceil(b / align) * align)


def plan_buckets(lengths: Sequence[int], growth: float = 1.26,
                 align: int = 2048, min_len: int = 4096):
    """-> {bucket_len: [utterance indices]} with deterministic order."""
    plan = {}
    for i, n in enumerate(lengths):
        plan.setdefault(bucket_length(n, growth, align, min_len), []).append(i)
    return dict(sorted(plan.items()))


def bucket_groups(lengths: Sequence[int], growth: float = 1.26,
                  max_batch: int = 16):
    """[(bucket_len, [utterance indices])], at most max_batch each."""
    return [(blen, idxs[at:at + max_batch])
            for blen, idxs in plan_buckets(lengths, growth).items()
            for at in range(0, len(idxs), max_batch)]


def pad_group(signals: Sequence[np.ndarray], grp: Sequence[int],
              blen: int) -> np.ndarray:
    """The group's utterances zero-padded to the bucket, (rows, blen)
    float32."""
    xs = np.zeros((len(grp), blen), np.float32)
    for r, i in enumerate(grp):
        xs[r, :len(signals[i])] = signals[i]
    return xs


def trim_group(arrays, lengths: Sequence[int], grp: Sequence[int], fs: int,
               frame_period: float):
    """Per utterance of the group, each (rows, T_bucket, ...) host array cut
    to the utterance's true frame count."""
    out = []
    for r, i in enumerate(grp):
        T = cfg.samples_for_dio(fs, lengths[i], frame_period)
        out.append(tuple(a[r, :T] for a in arrays))
    return out


def bucketed_analyze(signals: Sequence[np.ndarray], fs: int,
                     frame_period: float = 5.0, d4c_threshold: float = 0.0,
                     growth: float = 1.26, max_batch: int = 16,
                     algorithm: str = "dio", device="cuda") -> List[Tuple]:
    """signals: list of 1-D arrays of any lengths -> per utterance the
    numpy tuple (temporal_positions, f0, spectrogram, aperiodicity) of its
    true frame count, analysed on `device` (f32 fast mode) with the F0
    `algorithm` ("dio" or "harvest")."""
    batch_mod.check_algorithm(algorithm)
    dev = device_mod.resolve(device)
    lengths = [len(s) for s in signals]
    out: List[Tuple] = [None] * len(signals)
    for blen, grp in bucket_groups(lengths, growth, max_batch):
        res = batch_mod.batch_analyze(pad_group(signals, grp, blen), fs,
                                      frame_period, d4c_threshold,
                                      algorithm, device=dev)
        res = [v.cpu().numpy() for v in res]
        for i, r in zip(grp, trim_group(res, lengths, grp, fs,
                                        frame_period)):
            out[i] = r
    return out


def bucketed_extract(signals: Sequence[np.ndarray], fs: int,
                     frame_period: float = 5.0, d4c_threshold: float = 0.0,
                     growth: float = 1.26, max_batch: int = 16,
                     algorithm: str = "dio", mgc_dim: int = 50,
                     bap_dim: int = 25, device="cuda") -> List[Tuple]:
    """The corpus feature-extraction path: bucketed batched analysis and
    the feature encode on `device`, returning per utterance the numpy
    tuple (lf0, mgc, bap) of its true frame count, what the reference's
    `features` target writes (analysis.cpp:293-358).  Only the encoded
    features (mgc_dim + bap_dim + 1 floats a frame) come back to the
    host."""
    batch_mod.check_algorithm(algorithm)
    dev = device_mod.resolve(device)
    N = cfg.cheaptrick_fft_size(fs)
    lengths = [len(s) for s in signals]
    out: List[Tuple] = [None] * len(signals)
    for blen, grp in bucket_groups(lengths, growth, max_batch):
        _, f0, sp, ap = batch_mod.batch_analyze(
            pad_group(signals, grp, blen), fs, frame_period, d4c_threshold,
            algorithm, device=dev)
        feats = encode.encode_features(f0, sp, ap, fs, N, mgc_dim, bap_dim)
        feats = [v.cpu().numpy() for v in feats]
        for i, r in zip(grp, trim_group(feats, lengths, grp, fs,
                                        frame_period)):
            out[i] = r
    return out
