"""LOWESS smoother (Cleveland 1979) — numpy reimplementation of the
statsmodels.nonparametric.lowess call used by data/scripts/Extract.py:220
(frac=2/3 default, it=20, delta=0).  Used to detrend note-relative F0
before vibrato extraction.

The port's own copy of `hts_train_world_tpu/features/lowess.py`: host
numpy, the same loop and the same `argpartition` window.  On a regular x,
ties at the window edge carry weight 0, so the result does not depend on
which tied point is taken."""
from __future__ import annotations

import numpy as np


def lowess(y: np.ndarray, x: np.ndarray, frac: float = 2.0 / 3.0,
           it: int = 3) -> np.ndarray:
    """Returns the fitted values at x (assumed sorted ascending)."""
    n = len(y)
    if n < 2:
        return np.asarray(y, float).copy()
    k = max(2, int(np.ceil(frac * n)))
    k = min(k, n)
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    fitted = np.zeros(n)
    delta_w = np.ones(n)
    for _ in range(it + 1):
        for i in range(n):
            d = np.abs(x - x[i])
            idx = np.argpartition(d, k - 1)[:k]
            h = d[idx].max()
            if h <= 0:
                fitted[i] = np.average(y[idx], weights=delta_w[idx])
                continue
            w = (1.0 - np.clip(d[idx] / h, 0.0, 1.0) ** 3) ** 3
            w = w * delta_w[idx]
            sw = w.sum()
            if sw <= 0:
                fitted[i] = y[i]
                continue
            xw, yw = x[idx], y[idx]
            mx = (w * xw).sum() / sw
            my = (w * yw).sum() / sw
            cov = (w * (xw - mx) * (yw - my)).sum()
            var = (w * (xw - mx) ** 2).sum()
            b = cov / var if var > 1e-12 * (xw.max() - xw.min() + 1) ** 2 \
                else 0.0
            fitted[i] = my + b * (x[i] - mx)
        res = y - fitted
        s = np.median(np.abs(res))
        if s <= 0:
            break
        delta_w = np.clip(1.0 - (res / (6.0 * s)) ** 2, 0.0, 1.0) ** 2
    return fitted
