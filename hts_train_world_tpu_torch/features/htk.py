"""HTK parameter file I/O — equivalent of data/scripts/addhtkheader.pl
(SURVEY.md F5): 12-byte header (nframes:int32, samp_period_100ns:int32,
bytes_per_frame:int16, type:int16) + float32 data, native endian.

The port's own copy of `hts_train_world_tpu/features/htk.py`."""
from __future__ import annotations

import struct

import numpy as np

HTK_USER = 9  # parameter kind USER


def write_htk(path: str, data: np.ndarray, sampfreq: int, frameshift: int,
              kind: int = HTK_USER) -> None:
    """frameshift in samples; period = 1e7 * shift / fs (addhtkheader.pl:69)."""
    data = np.asarray(data, dtype=np.float32)
    T, D = data.shape
    period = int(10000000 * frameshift / sampfreq)
    with open(path, "wb") as f:
        f.write(struct.pack("=iihh", T, period, 4 * D, kind))
        data.tofile(f)


def read_htk(path: str):
    with open(path, "rb") as f:
        T, period, nbytes, kind = struct.unpack("=iihh", f.read(12))
        data = np.fromfile(f, dtype=np.float32).reshape(T, nbytes // 4)
    return data, period, kind
