"""Note-relative lf0 stream + vibrato extraction — reimplementation of
data/scripts/Extract.py (SURVEY.md F2).  The port's own copy of
`hts_train_world_tpu/features/vibrato.py`: host numpy, the same loops.

Per label segment with a note pitch (equal temperament from the /E: field):
- lf0 becomes 2-dim [ln f0, ln(f0 - note + 500)] (delta clamped to 1e-8
  when <= 0 or when f0 < 55, Extract.py:185-196);
- voiced runs > 20 frames are LOWESS-detrended (it=20) and scanned for
  vibrato: zero-crossing segments of the detrended delta-F0 whose peak
  depth >= 5 Hz yield [depth, period-in-frames] (getVibrate,
  Extract.py:115-151).

Known reference bugs NOT reproduced (documented intent instead):
- getVibrate appends to a preallocated zero list, so the caller copies
  zeros and can index past the utterance (Extract.py:119,148-151,223-225);
- `period = end - start / 2` is missing parentheses (Extract.py:146).
Here the vibrato values are written over the segment frames directly and
the period is (end - start) frames of a half-cycle * 2.

The unvoiced-f0 convention follows soprExp/soprLog exactly: lf0==0 ->
f0=1.0 -> ln back to 0; values <= 0 stored as 1e-8 (Extract.py:83-105).
"""
from __future__ import annotations

from typing import List

import numpy as np

from hts_train_world_tpu_torch.features import lowess as lowess_mod
from hts_train_world_tpu_torch.features.labels import (LabelSegment,
                                                        segment_frames)

VOICING_FLOOR_HZ = 55.0
MIN_RUN = 20
MIN_DEPTH_HZ = 5.0


def _sopr_log(a: np.ndarray) -> np.ndarray:
    return np.where(a <= 0.0, 1e-8, np.log(np.maximum(a, 1e-300)))


def lf0_to_f0(lf0: np.ndarray) -> np.ndarray:
    """soprExp: exp, then values < 1 -> 0 (unvoiced 0 -> 1.0)."""
    f0 = np.exp(lf0.astype(np.float64))
    return np.where(f0 < 1.0, 0.0, f0)


def extract_vibrato_segment(df0: np.ndarray):
    """Zero-crossing vibrato scan of detrended delta-F0 (getVibrate).
    Returns (depth, period) arrays over the segment frames."""
    n = len(df0)
    depth = np.zeros(n)
    period = np.zeros(n)
    if n <= 2:
        return depth, period
    sign = df0 >= 0.0
    crossings = [i for i in range(1, n) if sign[i] != sign[i - 1]]
    last_peak, last_period = 0.0, 0.0
    for a, b in zip(crossings[:-1], crossings[1:]):
        seg = np.abs(df0[a:b])
        if not len(seg):
            continue
        peak = seg.max()
        if peak < MIN_DEPTH_HZ:
            continue
        last_peak = peak
        last_period = 2.0 * (b - a)  # half-cycle length * 2 = period
        depth[a:b] = peak
        period[a:b] = last_period
    if crossings:
        depth[crossings[-1]:] = last_peak
        period[crossings[-1]:] = last_period
    return depth, period


def extract(lf0_1d: np.ndarray, labels: List[LabelSegment],
            frame_period_ms: float):
    """Extract.py main body -> (lf0_2d, vib_2d) float arrays (pre-log the
    streams are [f0, dF0+500] and [depth, period]; outputs are soprLog'd)."""
    f0 = lf0_to_f0(np.asarray(lf0_1d))
    T = len(f0)
    df0 = np.zeros((T, 2))
    df0_rel = np.zeros(T)
    vib = np.zeros((T, 2))
    if not labels:
        # no note labels (the reference only ever runs Extract.py with
        # labels; without them it would zero the stream): keep the raw f0
        # in dim 0 so lf0 stays usable, note-relative dim + vib stay at
        # the soprLog floor
        df0[:, 0] = f0
        return (_sopr_log(df0).astype(np.float32),
                _sopr_log(vib).astype(np.float32))
    for seg in labels:
        start, end = segment_frames(seg, frame_period_ms, T)
        base = seg.note_hz()
        for j in range(start, end):
            t = f0[j] - base + 500.0
            df0[j, 0] = f0[j]
            if f0[j] < VOICING_FLOOR_HZ:
                df0[j, 1] = 0.0
                df0_rel[j] = 0.0
            else:
                df0[j, 1] = t if t > 0 else -1.0
                df0_rel[j] = f0[j] - base
        # voiced runs within the segment (Extract.py:199-225)
        j = start
        while j < end:
            while j < end and f0[j] < VOICING_FLOOR_HZ:
                j += 1
            ostart = j
            while j < end and f0[j] >= VOICING_FLOOR_HZ:
                j += 1
            oend = j
            if oend - ostart > MIN_RUN:
                pf0 = df0_rel[ostart:oend].copy()
                trend = lowess_mod.lowess(
                    pf0, np.arange(len(pf0), dtype=float), it=20)
                depth, period = extract_vibrato_segment(pf0 - trend)
                vib[ostart:oend, 0] = depth
                vib[ostart:oend, 1] = period
    return _sopr_log(df0).astype(np.float32), _sopr_log(vib).astype(np.float32)
