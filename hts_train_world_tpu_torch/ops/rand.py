"""The WORLD reference's PRNG stream (xorshift128 'randn'), on a device.

Counterpart of `hts_train_world_tpu/ops/rand.py`
(externs/WORLD_v2/src/matlabfunctions.cpp:247-277).  The C++ calls
randn_reseed() at the top of CheapTrick, D4C and Synthesis, so every
stochastic stage reads a prefix of one fixed sequence.  The recurrence is
serial: the port's own copy of native/worldrand.c generates it on the
host (built by `runtime/native.py`; a build that fails raises, nothing
falls back to Python).

`randn_stream(n, device)` keeps the longest prefix asked for so far on
each device and returns a view of its first n draws; a longer request
extends it.  A batch of B utterances reads B views of one tensor.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from hts_train_world_tpu_torch.runtime import native

_lib = None
_lock = threading.Lock()
_streams: dict = {}     # device -> the longest float64 prefix made there


def _get_lib():
    global _lib
    if _lib is None:
        lib = native.load("worldrand", ["worldrand.c"])
        lib.worldrand_fill.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_long]
        lib.worldrand_fill.restype = None
        _lib = lib
    return _lib


def randn_stream_np(n: int) -> np.ndarray:
    """The first n randn() draws after randn_reseed() (float64 numpy)."""
    out = np.empty(int(n), dtype=np.float64)
    if n > 0:
        _get_lib().worldrand_fill(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), int(n))
    return out


def randn_stream(n: int, device="cpu") -> torch.Tensor:
    """The first n draws as a float64 view (n,) of the prefix kept on
    `device` (do not write into it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        have = _streams.get(dev)
        if have is None or have.shape[0] < n:
            # grow geometrically, so a run of slightly longer requests
            # regenerates the prefix only a few times
            m = max(int(n), 2 * (0 if have is None else have.shape[0]))
            have = torch.as_tensor(randn_stream_np(m), device=dev)
            _streams[dev] = have
    return have[:int(n)]
