"""Training data I/O: the port's own copy of
`hts_train_world_tpu/models/dataio.py` (it imports no JAX; the port keeps
its copy so that it imports nothing of the JAX package).  It replaces the
TF1 queue readers (DNNDataIO.py, SURVEY.md D3): the corpus sits in host
memory and batches are drawn with a numpy RNG, in the JAX package's calls
and order, so one seed gives both packages the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class UtterancePair:
    name: str
    ffi: np.ndarray   # (T, n_in) float32
    ffo: np.ndarray   # (T, n_out) float32
    speaker: int = 0


def load_pair(name: str, ffi_path: str, ffo_path: str, n_in: int,
              n_out: int, speaker: int = 0) -> UtterancePair:
    ffi = np.fromfile(ffi_path, "<f4").reshape(-1, n_in)
    ffo = np.fromfile(ffo_path, "<f4").reshape(-1, n_out)
    T = min(len(ffi), len(ffo))  # DNNDataIO truncates to the shorter
    return UtterancePair(name, ffi[:T], ffo[:T], speaker)


class FrameDataset:
    """Frame-shuffled batches (the RandomShuffleQueue analogue)."""

    def __init__(self, pairs: Sequence[UtterancePair], batch_size: int,
                 seed: int = 0):
        self.x = np.concatenate([p.ffi for p in pairs])
        self.y = np.concatenate([p.ffo for p in pairs])
        self.spkr = np.concatenate(
            [np.full(len(p.ffi), p.speaker, np.int32) for p in pairs])
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self.n_frames = len(self.x)

    def __iter__(self) -> Iterator[dict]:
        while True:
            idx = self._rng.integers(0, self.n_frames, self.batch_size)
            yield {"x": self.x[idx], "y": self.y[idx],
                   "spkr": self.spkr[idx]}

    def epoch_batches(self) -> Iterator[dict]:
        order = self._rng.permutation(self.n_frames)
        for i in range(0, self.n_frames - self.batch_size + 1,
                       self.batch_size):
            idx = order[i:i + self.batch_size]
            yield {"x": self.x[idx], "y": self.y[idx],
                   "spkr": self.spkr[idx]}


class UtteranceDataset:
    """Whole-utterance batches for trajectory training (the
    PaddingFIFOQueue analogue); utterances are bucketed by length and
    padded so compiled shapes repeat."""

    def __init__(self, pairs: Sequence[UtterancePair], bucket: int = 64,
                 seed: int = 0):
        self.pairs = list(pairs)
        self.bucket = bucket
        self._rng = np.random.default_rng(seed)

    def padded(self, p: UtterancePair) -> Tuple[dict, int]:
        T = len(p.ffi)
        Tp = ((T + self.bucket - 1) // self.bucket) * self.bucket
        x = np.zeros((Tp, p.ffi.shape[1]), np.float32)
        y = np.zeros((Tp, p.ffo.shape[1]), np.float32)
        x[:T] = p.ffi
        y[:T] = p.ffo
        return {"x": x, "y": y, "spkr": np.int32(p.speaker),
                "length": np.int32(T)}, T

    def __iter__(self):
        while True:
            order = self._rng.permutation(len(self.pairs))
            for i in order:
                yield self.padded(self.pairs[i])[0]


def train_valid_split(pairs: List[UtterancePair], valid_fraction: float,
                      seed: int = 0):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    n_valid = max(1, int(len(pairs) * valid_fraction)) \
        if valid_fraction > 0 and len(pairs) > 1 else 0
    valid_idx = set(order[:n_valid].tolist())
    train = [p for i, p in enumerate(pairs) if i not in valid_idx]
    valid = [p for i, p in enumerate(pairs) if i in valid_idx]
    return train, valid
