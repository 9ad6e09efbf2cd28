"""Builds and loads the port's native (C++) runtime pieces.

The port's own counterpart of `hts_train_world_tpu/runtime/native.py`:
the sources live in `hts_train_world_tpu_torch/native/`, and each library
is built on first use with `g++ -O2 -shared -fPIC` into the gitignored
`<repo>/.torch_ext_build/native/<hash>/`, keyed by a hash of its sources
and flags, never beside the sources.  A build that fails raises: nothing
falls back to a Python reader.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".torch_ext_build", "native")
FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}


def _build(name: str, sources: list) -> str:
    srcs = [os.path.join(NATIVE_DIR, s) for s in sources]
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    d = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    so = os.path.join(d, f"lib{name}.so")
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native {name} library "
                           "builds with the system C++ compiler")
    os.makedirs(d, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, *FLAGS, "-o", tmp, *srcs, "-lpthread"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}:\n{r.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str, sources: list) -> ctypes.CDLL:
    """The library `name` built from `sources` (in native/), loaded once."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_build(name, sources))
        return _libs[name]
