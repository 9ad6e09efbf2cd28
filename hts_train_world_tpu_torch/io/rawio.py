"""Raw float32 parameter file I/O (the port's own copy of the JAX package's
`io/rawio.py`): the HTS pipeline's lf0/mgc/bap/cmp files are headerless
little-endian float32 (data/Makefile.in:209-239)."""
from __future__ import annotations

import numpy as np


def read_f32(path: str, width: int = 1) -> np.ndarray:
    data = np.fromfile(path, dtype="<f4")
    return data.reshape(-1, width) if width > 1 else data


def write_f32(path: str, arr) -> None:
    np.asarray(arr, dtype="<f4").tofile(path)
