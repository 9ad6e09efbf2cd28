"""MLPG (maximum-likelihood parameter generation), batched.

Counterpart of `hts_train_world_tpu/ops/mlpg.py` (SPTK `mlpg`): solves
(W^T S W) c = W^T S mu for every (utterance, dimension), where W stacks
the delta windows over time and S is the diagonal precision.  For 3-tap
windows the normal matrix is pentadiagonal: a banded LDL^T, a forward
recursion over frames and a back substitution.  Window taps outside
[0, T) are dropped.

`mlpg` runs kernel K8 (csrc/mlpg_solve.cu) for CUDA tensors: one thread
per (utterance, dimension) builds the bands on the fly and runs both
recursions, in float32 (the feature lane) or float64 (generation, where
precisions span ~1e16), whichever its inputs hold.  `mlpg_plain` (`build_banded_normal` + `banded_ldlt_solve`) is
its plain twin, run for CPU tensors; it accumulates the bands in the JAX
package's order, and the kernel does the same operations.  Statics-only
windows have a closed form and launch nothing.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import prims

DEFAULT_WINDOWS = ((1.0,), (-0.5, 0.0, 0.5), (1.0, -2.0, 1.0))
MAX_WINDOWS = 4   # csrc/mlpg_solve.cu keeps this many windows in registers


def window_bandwidth(windows) -> int:
    return max((len(w) - 1) // 2 for w in windows)


def build_banded_normal(means, precisions, windows):
    """means, precisions (..., T, n_win, D) -> (diags (..., 2b+1, T, D)
    with diags[..., k, i, :] = A[i, i+k], rhs (..., T, D))."""
    T = means.shape[-3]
    b2 = 2 * window_bandwidth(windows)
    diags = torch.zeros(means.shape[:-3] + (b2 + 1, T, means.shape[-1]),
                        dtype=means.dtype, device=means.device)
    rhs = torch.zeros_like(means[..., 0, :])
    for w_idx, w in enumerate(windows):
        nlr = (len(w) - 1) // 2
        p = precisions[..., w_idx, :]
        mu = means[..., w_idx, :]
        for ki, wk in enumerate(w):
            k = ki - nlr
            if wk == 0.0:
                continue
            # frames t with t+k inside [0, T) add to row t+k
            t0, t1 = max(0, -k), min(T, T - k)
            rhs[..., t0 + k:t1 + k, :] += p[..., t0:t1, :] * mu[..., t0:t1, :] \
                * float(wk)
            for kj, wj in enumerate(w):
                j = kj - nlr
                if wj == 0.0 or j < k:
                    continue
                u0, u1 = max(t0, -j), min(t1, T - j)
                diags[..., j - k, u0 + k:u1 + k, :] += \
                    p[..., u0:u1, :] * float(wk) * float(wj)
    return diags, rhs


def ldlt_forward(diags, rhs):
    """The forward recursion of the unit-lower LDL^T of the SPD
    pentadiagonal A given as upper bands (..., 3, T, D), with the forward
    substitution of rhs (..., T, D) -> (z = D^-1 L^-1 rhs, L[i,i-1],
    L[i,i-2], d), each (..., T, D)."""
    if diags.shape[-3] != 3:
        raise ValueError("banded_ldlt_solve: 3-tap windows (bandwidth 1)")
    T = diags.shape[-2]
    zero = torch.zeros_like(rhs[..., 0, :])
    one = torch.ones_like(zero)
    d1, d2, y1, y2, lp = one, one, zero, zero, zero
    zs, l1s, l2s, ds = [], [], [], []
    for i in range(T):
        aii = diags[..., 0, i, :]
        ai1 = diags[..., 1, i - 1, :] if i >= 1 else zero
        ai2 = diags[..., 2, i - 2, :] if i >= 2 else zero
        l2 = ai2 / d2
        l1 = (ai1 - l2 * d2 * lp) / d1
        d_i = aii - l1 * l1 * d1 - l2 * l2 * d2
        y_i = rhs[..., i, :] - l1 * y1 - l2 * y2
        zs.append(y_i / d_i)
        l1s.append(l1)
        l2s.append(l2)
        ds.append(d_i)
        d1, d2, y1, y2, lp = d_i, d1, y_i, y1, l1
    return tuple(torch.stack(v, dim=-2) for v in (zs, l1s, l2s, ds))


def ldlt_back(z, l1, l2):
    """The back substitution L^T c = z over frames in reverse."""
    T = z.shape[-2]
    zero = torch.zeros_like(z[..., 0, :])
    cs = [None] * T
    c1, c2 = zero, zero
    for i in range(T - 1, -1, -1):
        ln1 = l1[..., i + 1, :] if i + 1 < T else zero
        ln2 = l2[..., i + 2, :] if i + 2 < T else zero
        c_i = z[..., i, :] - ln1 * c1 - ln2 * c2
        cs[i] = c_i
        c1, c2 = c_i, c1
    return torch.stack(cs, dim=-2)


def banded_ldlt_solve(diags, rhs):
    """Solve A c = rhs for SPD pentadiagonal A given as upper bands
    (..., 3, T, D): unit-lower LDL^T by a forward recursion over frames,
    then back substitution."""
    z, l1, l2, _ = ldlt_forward(diags, rhs)
    return ldlt_back(z, l1, l2)


def _statics_only(means, variances):
    """W = I per window: the precision-weighted mean."""
    prec = prims.rdiv(1.0, variances)
    return (means * prec).sum(dim=-2) / prec.sum(dim=-2)


def mlpg_plain(means, variances, windows=DEFAULT_WINDOWS):
    wins = tuple(tuple(w) for w in windows)
    if window_bandwidth(wins) == 0:
        return _statics_only(means, variances)
    diags, rhs = build_banded_normal(means, prims.rdiv(1.0, variances), wins)
    return banded_ldlt_solve(diags, rhs)


@functools.lru_cache(maxsize=None)
def _window_table(windows: tuple, dtype, device):
    """Window coefficients centred in 3 taps, (n_win, 3) of `dtype`."""
    coef = np.zeros((len(windows), 3))
    for i, w in enumerate(windows):
        o = 1 - (len(w) - 1) // 2
        coef[i, o:o + len(w)] = w
    return torch.as_tensor(coef, dtype=dtype, device=device)


def mlpg(means, variances, windows=DEFAULT_WINDOWS):
    """K8: means, variances (..., T, n_win, D) -> statics (..., T, D), in
    the inputs' dtype (float32 or float64 on the card)."""
    wins = tuple(tuple(float(v) for v in w) for w in windows)
    if window_bandwidth(wins) == 0:
        return _statics_only(means, variances)
    if not means.is_cuda:
        return mlpg_plain(means, variances, wins)
    *lead, T, n_win, D = means.shape
    dt = means.dtype
    if (dt not in (torch.float32, torch.float64)
            or variances.shape != means.shape or variances.dtype != dt
            or n_win != len(wins) or n_win > MAX_WINDOWS
            or window_bandwidth(wins) != 1
            or any(len(w) % 2 == 0 for w in wins)):
        raise ValueError("mlpg: f32 or f64 means/variances (..., T, n_win, "
                         f"D) of one dtype, at most {MAX_WINDOWS} odd "
                         "windows of <= 3 taps")
    mu = means.reshape(-1, T, n_win, D).contiguous()
    var = variances.reshape(-1, T, n_win, D).contiguous()
    coef = _window_table(wins, dt, means.device)
    kernels.check_cuda("mlpg", mu, var, coef)
    B = mu.shape[0]
    scratch = torch.empty((3, B, T, D), dtype=dt, device=means.device)
    out = torch.empty((B, T, D), dtype=dt, device=means.device)
    kernels.launch("mlpg_solve", [
        mu.data_ptr(), var.data_ptr(), B, T, n_win, D, coef.data_ptr(),
        int(dt == torch.float64), scratch.data_ptr(), out.data_ptr()],
        dict(means=means, variances=variances, windows=windows))
    return out.reshape(*lead, T, D)
