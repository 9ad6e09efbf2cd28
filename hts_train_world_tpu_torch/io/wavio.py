"""16-bit PCM RIFF wav I/O with the reference's scaling conventions (the
port's own copy of the JAX package's `io/wavio.py`): read -> sample /
2^(nbit-1) (test/audioio.cpp); write -> trunc(x * 32767) clamped to int16
(audioio.cpp:163-166)."""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def wavread(path: str):
    fs, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float64) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float64) / 2147483648.0
    elif data.dtype in (np.float32, np.float64):
        x = data.astype(np.float64)
    else:
        raise ValueError(f"unsupported wav dtype {data.dtype}")
    if x.ndim > 1:
        x = x[:, 0]
    return x, int(fs)


def float_to_int16(x) -> np.ndarray:
    """The exact wavwrite quantization, for waveform comparisons."""
    return np.clip(np.trunc(np.asarray(x) * 32767.0),
                   -32768, 32767).astype(np.int16)


def wavwrite(x, fs: int, path: str):
    wavfile.write(path, fs, float_to_int16(x))
