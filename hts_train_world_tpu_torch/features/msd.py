"""MSD magic-value handling — equivalents of data/scripts/interpolate.pl
(SURVEY.md F4) and the `sopr -magic` flag extraction used by the ffo
target (data/Makefile.in:383).

The port's own copy of `hts_train_world_tpu/features/msd.py` (host numpy,
the same lines)."""
from __future__ import annotations

import numpy as np

MAGIC = -1.0e10


def msd_flags(x: np.ndarray) -> np.ndarray:
    """sopr -magic -1e10 -m 0 -a 1 -MAGIC 0: 1 where valid, 0 at magic."""
    return np.where(x == MAGIC, 0.0, 1.0)


def interpolate_gaps(x: np.ndarray) -> np.ndarray:
    """interpolate.pl:68-105 per dimension: linear interpolation across
    magic gaps; a leading gap copies the first valid value, a trailing gap
    holds the last; all-magic raises."""
    x = np.array(x, dtype=np.float64, copy=True)
    if x.ndim == 1:
        x = x[:, None]
        squeeze = True
    else:
        squeeze = False
    T, D = x.shape
    for d in range(D):
        col = x[:, d]
        valid = col != MAGIC
        if not valid.any():
            raise ValueError("no valid value")
        idx = np.nonzero(valid)[0]
        t = 0
        while t < T:
            if valid[t]:
                t += 1
                continue
            nxt = idx[np.searchsorted(idx, t)] if t <= idx[-1] else None
            if nxt is None:  # trailing gap: hold last value
                col[t:] = col[idx[-1]]
                break
            if t == 0 or not valid[t - 1]:
                # leading gap: copy the next valid value
                col[t:nxt] = col[nxt]
            else:
                step = (col[nxt] - col[t - 1]) / (nxt - t + 1)
                col[t:nxt] = col[t - 1] + step * np.arange(1, nxt - t + 1)
            t = nxt
    return x[:, 0] if squeeze else x
