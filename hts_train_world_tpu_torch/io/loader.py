"""Native prefetching corpus loader (ctypes over native/dataloader.cpp),
the port's own copy of `hts_train_world_tpu/io/loader.py`.

The replacement for the reference's per-file shell pipeline
(data/Makefile.in:125-241) and thread-pool runner (parallel.py:17-56): a
C++ worker pool reads and decodes utterance files concurrently with
device compute; iteration yields items in completion order with their
corpus index, so downstream bucketing (parallel/bucketing.py) can batch
as data arrives.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from hts_train_world_tpu_torch.runtime import native

RAW_INT16 = 0
WAV = 1
F32 = 2

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = native.load("dataloader", ["dataloader.cpp"])
        lib.dl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                ctypes.c_long, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int]
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_peek.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_long),
                                ctypes.POINTER(ctypes.c_int)]
        lib.dl_peek.restype = ctypes.c_long
        lib.dl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.c_long]
        lib.dl_next.restype = ctypes.c_long
        lib.dl_skip.argtypes = [ctypes.c_void_p]
        lib.dl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class CorpusLoader:
    """Iterate (index, samples, sample_rate) in completion order.

    mode: RAW_INT16 (HTS raw/*.raw, /32768), WAV (RIFF pcm16/pcm32/f32,
    audioio scaling), F32 (headerless float32 streams).  Decode failures
    yield (index, None, 0) so callers can drop utterances like the
    reference's NaN screening (data/Makefile.in:216-238).
    """

    def __init__(self, paths: Sequence[str], mode: int = WAV,
                 n_threads: int = 0, queue_cap: int = 8):
        self.paths = list(paths)
        lib = _get_lib()
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._h = lib.dl_open(arr, len(self.paths), mode, n_threads,
                              queue_cap)
        self._lib = lib
        self._open = True

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, int]]:
        lib = self._lib
        while True:
            idx = ctypes.c_long()
            sr = ctypes.c_int()
            n = lib.dl_peek(self._h, ctypes.byref(idx), ctypes.byref(sr))
            if n == -1:
                return
            if n == -2:
                lib.dl_skip(self._h)
                yield int(idx.value), None, 0
                continue
            out = np.empty(int(n), np.float64)
            got = lib.dl_next(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                n)
            yield int(idx.value), out[:got], int(sr.value)

    def close(self) -> None:
        if self._open:
            self._lib.dl_close(self._h)
            self._open = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def load_corpus(paths: Sequence[str], mode: int = WAV,
                n_threads: int = 0) -> List[np.ndarray]:
    """Eagerly load a corpus in original order (None for bad files)."""
    out: List[np.ndarray] = [None] * len(paths)
    with CorpusLoader(paths, mode, n_threads,
                      queue_cap=max(8, len(paths))) as dl:
        for i, x, _ in dl:
            out[i] = x
    return out
