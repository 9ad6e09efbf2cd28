"""The trajectory cost's banded solve and its adjoint, batched.

Counterpart of the MLPG-in-the-graph of
`hts_train_world_tpu/models/acoustic.py:103-211` (`trajectory_cost`'s
in-graph MLPG, `quad_per_dim`, `_ldlt_ds`) over
`hts_train_world_tpu/ops/mlpg.py:29-103`.  For every (utterance, static
dimension), with A = sum_w W_w^T P_w W_w the pentadiagonal normal matrix of
the window means mu and precisions prec (..., T, W, D) and s (..., T, D)
the static targets:

    c = A^-1 sum_w W_w^T P_w mu_w,   q = (s - c)^T A (s - c),
    logdet = log det A.

`TrajectoryNLL` is the `torch.autograd.Function` over them.  On the card
its forward is K28 (csrc/trajectory_nll.cu) and its backward K29
(csrc/trajectory_adjoint.cu), one thread per (utterance, dimension) each;
for CPU tensors the plain twins below run (`trajectory_forward_plain`,
`trajectory_backward_plain`: the same recursions written out, vectorised
over utterances and dimensions).  Both take float32 (training) or float64.

The adjoint, for cotangents g_c, g_q, g_logdet (e = s - c):

    r = g_c - 2 g_q A e,  lambda = A^-1 r  (the saved LDL^T factors),
    G = g_q e e^T + g_logdet A^-1 - (lambda c^T + c lambda^T) / 2
        on A's band, A^-1's band by Takahashi's recursion from L and d,
    g_mu[t, w] = prec[t, w] (W_w lambda)[t],
    g_prec[t, w] = (W_w lambda)[t] mu[t, w]
                   + sum_{k, j} w_k w_j G[t + k, t + j].

Window taps outside [0, T) are dropped, as `build_banded_normal` drops
them; entries of lambda and G outside [0, T) are zeros.
"""
from __future__ import annotations

import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import mlpg as mlpg_mod

DEFAULT_WINDOWS = mlpg_mod.DEFAULT_WINDOWS


def _check_windows(windows):
    wins = tuple(tuple(float(v) for v in w) for w in windows)
    if (len(wins) > mlpg_mod.MAX_WINDOWS or mlpg_mod.window_bandwidth(wins)
            != 1 or any(len(w) % 2 == 0 for w in wins)):
        raise ValueError(f"trajectory: at most {mlpg_mod.MAX_WINDOWS} odd "
                         "windows of <= 3 taps, one of them 3 taps wide")
    return wins


def _shift(x, k: int):
    """y[..., t, :] = x[..., t + k, :], zero outside [0, T)."""
    if k == 0:
        return x
    T = x.shape[-2]
    y = torch.zeros_like(x)
    if abs(k) < T:
        if k > 0:
            y[..., :T - k, :] = x[..., k:, :]
        else:
            y[..., -k:, :] = x[..., :T + k, :]
    return y


def trajectory_forward_plain(mu, prec, s, windows=DEFAULT_WINDOWS):
    """K28's twin.  mu, prec (B, T, W, D), s (B, T, D) -> c (B, T, D), q
    (B, D), logdet (B, D) and the saved factors (6, B, T, D): d, L[i,i-1],
    L[i,i-2], A[i,i], A[i,i+1], A[i,i+2]."""
    wins = _check_windows(windows)
    diags, rhs = mlpg_mod.build_banded_normal(mu, prec, wins)
    z, l1, l2, d = mlpg_mod.ldlt_forward(diags, rhs)
    c = mlpg_mod.ldlt_back(z, l1, l2)
    e = s - c
    q = torch.sum(diags[:, 0] * e * e, dim=1)
    for k in (1, 2):
        q = q + 2.0 * torch.sum(diags[:, k, :-k] * e[:, :-k] * e[:, k:],
                                dim=1)
    logdet = torch.sum(torch.log(d), dim=1)
    saved = torch.stack([d, l1, l2, diags[:, 0], diags[:, 1], diags[:, 2]])
    return c, q, logdet, saved


def trajectory_backward_plain(mu, prec, s, c, saved, g_c, g_q, g_logdet,
                              windows=DEFAULT_WINDOWS):
    """K29's twin: the cotangents of (c, q, logdet) -> (g_mu, g_prec),
    each (B, T, W, D)."""
    wins = _check_windows(windows)
    d, l1, l2, a0, a1, a2 = saved
    T = c.shape[1]
    e = s - c
    ae = (a0 * e + a1 * _shift(e, 1) + _shift(a1, -1) * _shift(e, -1)
          + a2 * _shift(e, 2) + _shift(a2, -2) * _shift(e, -2))
    r = g_c - 2.0 * g_q[:, None, :] * ae
    # lambda = A^-1 r by the saved factors
    zero = torch.zeros_like(r[:, 0])
    y1, y2, zs = zero, zero, []
    for i in range(T):
        y_i = r[:, i] - l1[:, i] * y1 - l2[:, i] * y2
        zs.append(y_i / d[:, i])
        y1, y2 = y_i, y1
    # the reverse sweep: lambda and the band of A^-1 (Takahashi)
    lam1 = lam2 = s11 = s12 = s22 = zero
    lam, s00, s01, s02 = [None] * T, [None] * T, [None] * T, [None] * T
    for i in range(T - 1, -1, -1):
        l1n = l1[:, i + 1] if i + 1 < T else zero
        l2n = l2[:, i + 2] if i + 2 < T else zero
        lam[i] = zs[i] - l1n * lam1 - l2n * lam2
        s02[i] = -l1n * s12 - l2n * s22
        s01[i] = -l1n * s11 - l2n * s12
        s00[i] = 1.0 / d[:, i] - l1n * s01[i] - l2n * s02[i]
        lam1, lam2 = lam[i], lam1
        s11, s12, s22 = s00[i], s01[i], s11
    lam, s00, s01, s02 = (torch.stack(v, dim=1)
                          for v in (lam, s00, s01, s02))
    gq, gl = g_q[:, None, :], g_logdet[:, None, :]
    g0 = gq * e * e + gl * s00 - lam * c
    g1 = (gq * e * _shift(e, 1) + gl * s01
          - 0.5 * (lam * _shift(c, 1) + c * _shift(lam, 1)))
    g2 = (gq * e * _shift(e, 2) + gl * s02
          - 0.5 * (lam * _shift(c, 2) + c * _shift(lam, 2)))
    # frame t's window taps reach G's rows t-1 .. t+1
    lm, lp = _shift(lam, -1), _shift(lam, 1)
    gmm, gm0, gmp = _shift(g0, -1), _shift(g1, -1), _shift(g2, -1)
    g0p, gpp = g1, _shift(g0, 1)
    g_mu, g_prec = [], []
    taps = mlpg_mod._window_table(wins, torch.float64, "cpu").tolist()
    for w, (wm, w0, wp) in enumerate(taps):
        wl = wm * lm + w0 * lam + wp * lp
        quad = (wm * wm * gmm + w0 * w0 * g0 + wp * wp * gpp
                + 2.0 * (wm * w0 * gm0 + wm * wp * gmp + w0 * wp * g0p))
        g_mu.append(prec[:, :, w] * wl)
        g_prec.append(wl * mu[:, :, w] + quad)
    return torch.stack(g_mu, dim=2), torch.stack(g_prec, dim=2)


def _check(name, mu, prec, s, wins):
    B, T, W, D = mu.shape
    if (mu.dtype not in (torch.float32, torch.float64)
            or prec.dtype != mu.dtype or prec.shape != mu.shape
            or s.dtype != mu.dtype or s.shape != (B, T, D)
            or W != len(wins) or T < 1):
        raise ValueError(f"{name}: f32 or f64 mu, prec (B, T, W, D) and s "
                         "(B, T, D) of one dtype, W the window count")


def trajectory_forward(mu, prec, s, windows=DEFAULT_WINDOWS):
    """K28: `trajectory_forward_plain`'s contract."""
    if not mu.is_cuda:
        return trajectory_forward_plain(mu, prec, s, windows)
    wins = _check_windows(windows)
    _check("trajectory_forward", mu, prec, s, wins)
    mu, prec, s = mu.contiguous(), prec.contiguous(), s.contiguous()
    B, T, W, D = mu.shape
    coef = mlpg_mod._window_table(wins, mu.dtype, mu.device)
    kernels.check_cuda("trajectory_forward", mu, prec, s, coef)
    saved = torch.empty((6, B, T, D), dtype=mu.dtype, device=mu.device)
    c = torch.empty((B, T, D), dtype=mu.dtype, device=mu.device)
    q = torch.empty((B, D), dtype=mu.dtype, device=mu.device)
    logdet = torch.empty_like(q)
    kernels.launch("trajectory_nll", [
        mu.data_ptr(), prec.data_ptr(), s.data_ptr(), B, T, W, D,
        coef.data_ptr(), int(mu.dtype == torch.float64), saved.data_ptr(),
        c.data_ptr(), q.data_ptr(), logdet.data_ptr()],
        dict(mu=mu, prec=prec, s=s, windows=wins))
    return c, q, logdet, saved


def trajectory_backward(mu, prec, s, c, saved, g_c, g_q, g_logdet,
                        windows=DEFAULT_WINDOWS):
    """K29: `trajectory_backward_plain`'s contract."""
    if not mu.is_cuda:
        return trajectory_backward_plain(mu, prec, s, c, saved, g_c, g_q,
                                         g_logdet, windows)
    wins = _check_windows(windows)
    _check("trajectory_backward", mu, prec, s, wins)
    B, T, W, D = mu.shape
    if (c.shape != s.shape or g_c.shape != s.shape
            or saved.shape != (6, B, T, D) or g_q.shape != (B, D)
            or g_logdet.shape != (B, D)
            or any(t.dtype != mu.dtype for t in (c, saved, g_c, g_q,
                                                  g_logdet))):
        raise ValueError("trajectory_backward: c, g_c (B, T, D), saved (6, "
                         "B, T, D), g_q, g_logdet (B, D) of mu's dtype")
    ts = [t.contiguous() for t in (mu, prec, s, c, saved, g_c, g_q,
                                   g_logdet)]
    coef = mlpg_mod._window_table(wins, mu.dtype, mu.device)
    kernels.check_cuda("trajectory_backward", *ts, coef)
    z = torch.empty_like(s)
    g_mu = torch.empty_like(mu)
    g_prec = torch.empty_like(mu)
    kernels.launch("trajectory_adjoint", [
        *(t.data_ptr() for t in ts), B, T, W, D, coef.data_ptr(),
        int(mu.dtype == torch.float64), z.data_ptr(), g_mu.data_ptr(),
        g_prec.data_ptr()],
        dict(mu=mu, prec=prec, s=s, c=c, saved=saved, g_c=g_c, g_q=g_q,
             g_logdet=g_logdet, windows=wins))
    return g_mu, g_prec


class TrajectoryNLL(torch.autograd.Function):
    """(mu, prec, s) -> (c, q, logdet), differentiable in mu and prec (s
    is a target and gets no gradient)."""

    @staticmethod
    def forward(ctx, mu, prec, s, windows=DEFAULT_WINDOWS):
        c, q, logdet, saved = trajectory_forward(mu, prec, s, windows)
        ctx.save_for_backward(mu, prec, s, c, saved)
        ctx.windows = windows
        return c, q, logdet

    @staticmethod
    def backward(ctx, g_c, g_q, g_logdet):
        mu, prec, s, c, saved = ctx.saved_tensors
        g_c = torch.zeros_like(c) if g_c is None else g_c
        g_q = torch.zeros_like(c[:, 0]) if g_q is None else g_q
        g_logdet = (torch.zeros_like(c[:, 0]) if g_logdet is None
                    else g_logdet)
        g_mu, g_prec = trajectory_backward(mu, prec, s, c, saved, g_c, g_q,
                                           g_logdet, ctx.windows)
        return g_mu, g_prec, None, None
