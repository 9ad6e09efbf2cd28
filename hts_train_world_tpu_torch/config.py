"""WORLD constants and derived sizes (the port's own copy).

Same values and formulas as the JAX package's `config.py`:
- WORLD constants:  externs/WORLD_v2/src/world/constantnumbers.h:13-43
- CheapTrick FFT:   externs/WORLD_v2/src/cheaptrick.cpp:191-198
- D4C FFT sizes:    externs/WORLD_v2/src/d4c.cpp:262-263,344-346
- codec mel scale:  externs/WORLD_v2/src/world/constantnumbers.h:39-43
"""
from __future__ import annotations

import math

K_MY_SAFE_GUARD_MINIMUM = 1e-12
K_FLOOR_F0 = 71.0
K_CEIL_F0 = 800.0
K_DEFAULT_F0 = 500.0
K_LOG2 = 0.69314718055994529
K_EPS = 2.220446049250313e-16
K_MAXIMUM_VALUE = 100000.0
K_FLOOR_F0_STONEMASK = 40.0
K_FREQUENCY_INTERVAL = 3000.0
K_UPPER_LIMIT = 15000.0
K_THRESHOLD = 0.85
K_FLOOR_F0_D4C = 47.0
# Codec mel scale (Stevens & Volkmann 1940)
K_M0 = 1127.01048
K_F0 = 700.0
K_FLOOR_FREQUENCY = 40.0
K_CEIL_FREQUENCY = 20000.0


def get_suitable_fft_size(sample: int) -> int:
    """2^(1+floor(log2(sample))) — common.cpp:51-54 (int-truncated log)."""
    return int(2 ** (int(math.log(sample) / K_LOG2) + 1))


def cheaptrick_fft_size(fs: int, f0_floor: float = K_FLOOR_F0) -> int:
    """cheaptrick.cpp:191-194."""
    return int(2 ** (1 + int(math.log(3.0 * fs / f0_floor + 1) / K_LOG2)))


def cheaptrick_f0_floor(fs: int, fft_size: int) -> float:
    """cheaptrick.cpp:196-198."""
    return 3.0 * fs / (fft_size - 3.0)


def d4c_love_train_fft_size(fs: int) -> int:
    """d4c.cpp:261-263 (lowest_f0 = 40)."""
    return int(2 ** (1 + int(math.log(3.0 * fs / 40.0 + 1) / K_LOG2)))


def d4c_fft_size(fs: int) -> int:
    """d4c.cpp:344-346."""
    return int(2 ** (1 + int(math.log(4.0 * fs / K_FLOOR_F0_D4C + 1) / K_LOG2)))


def number_of_aperiodicities(fs: int) -> int:
    """codec.cpp:212-215 / d4c.cpp:351-353."""
    return int(min(K_UPPER_LIMIT, fs / 2.0 - K_FREQUENCY_INTERVAL)
               / K_FREQUENCY_INTERVAL)


def samples_for_dio(fs: int, x_length: int, frame_period: float) -> int:
    """dio.cpp:638-640."""
    return int(1000.0 * x_length / fs / frame_period) + 1


def y_length_for(f0_length: int, frame_period: float, fs: int) -> int:
    """synth.cpp:259: output samples for a contour of f0_length frames."""
    return int((f0_length - 1) * frame_period / 1000.0 * fs) + 1


def grid_step(fs: int, frame_period: float) -> int:
    """Samples per frame when integral, else 0 (the regular frame grid
    the windowed-frame kernel relies on)."""
    gs = fs * frame_period / 1000.0
    return int(gs) if float(gs).is_integer() else 0


_FREQWARP_TABLE = {8000: 0.31, 10000: 0.35, 12000: 0.37, 16000: 0.42,
                   20000: 0.44, 22050: 0.45, 32000: 0.50, 44100: 0.53,
                   48000: 0.55}


def freqwarp_for_fs(fs: int) -> float:
    """configure.ac:556-569."""
    return _FREQWARP_TABLE.get(fs, 0.0)
