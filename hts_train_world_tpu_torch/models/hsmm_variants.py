"""HSMM training variants: mixture upmixing (UPMIX/ERST5) and semi-tied
covariance transforms (SEMIT), in float64 on the card or the CPU.

Counterpart of `hts_train_world_tpu/models/hsmm_variants.py`, the
reference's final model-refinement stages (Training.pl:1017-1144):

- UPMIX: HHEd's `MU +1` doubles the components of every stream's state
  output (each Gaussian split at mean +/- 0.2 stddev, weights halved),
  then ERST5's embedded re-estimation: Viterbi state alignment under the
  mixtures, per-segment component posteriors, weighted moments.
- SEMIT: HERest's semi-tied transform, one block-diagonal A per stream
  (blocks of the delta windows by default) by Gales' row-wise cofactor
  update; Gaussians keep diagonal variances in the transformed space and
  the likelihood gains log|det A| per stream.

The model sets and the M-steps are host numpy, as in the JAX package; the
per-frame work runs in torch:

- `batch_frame_loglik_mix` (K33 chain mode, csrc/hsmm_mix_loglik.cu): the
  mixture analogue of K17, (B, T, K) over a padded batch of chains;
- `responsibilities` (K33 posterior mode): every segment's component
  posteriors of one stream in one launch;
- `semitied_blocks` (K34, csrc/semitied.cu): Gales' update for every
  (stream, block) job of a stream at once, any block size: per outer step
  the sigmas, every row's G_r and their LU factors over the whole card,
  then the rows in order, a block of threads a job;
- the alignments go through K20 (`hsmm.viterbi_segment_batch`) in padded
  batches, with K17 (SEMIT's E-step) or K33 (ERST5's) before it.

On a CUDA tensor each kernel wrapper launches its kernel (or raises); on a
CPU tensor it runs the plain twin beside it.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.models import hsmm
from hts_train_world_tpu_torch.models import hsmm_batch as hb
from hts_train_world_tpu_torch.models.hsmm import (
    LOG_2PI, ModelSet, StreamDef, global_stats)

# K33 holds a frame's component sums in registers: at most this many
# components
MAX_COMPONENTS = 8


# ---------------------------------------------------------------------------
# mixtures (UPMIX -> ERST5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MixtureModelSet:
    """Per-stream mixture-of-diagonal-Gaussians models, stacked
    (n_models, n_states, n_comps, dim); duration models stay single
    Gaussians (the reference copies the dur mmf unchanged,
    Training.pl:1082-1083)."""
    names: List[str]
    means: Dict[str, np.ndarray]       # (M, S, C, D)
    variances: Dict[str, np.ndarray]   # (M, S, C, D)
    mix_logw: Dict[str, np.ndarray]    # (M, S, C)
    msd_weights: Dict[str, np.ndarray]  # msd streams: (M, S)
    dur_mean: np.ndarray
    dur_var: np.ndarray
    streams: Tuple[StreamDef, ...]

    @property
    def n_states(self) -> int:
        return self.dur_mean.shape[1]

    @property
    def n_comps(self) -> int:
        return next(iter(self.mix_logw.values())).shape[2]

    def index(self, name: str) -> int:
        return self.names.index(name)


def mixture_from_numpy(names, means, variances, mix_logw, msd_weights,
                       dur_mean, dur_var, streams) -> MixtureModelSet:
    """A MixtureModelSet from plain arrays (copied to float64) and streams
    given as (name, start, stop, msd, msd_flag_col, weight) tuples."""
    base = hsmm.modelset_from_numpy(names, means, variances, msd_weights,
                                    dur_mean, dur_var, streams)
    return MixtureModelSet(
        base.names, base.means, base.variances,
        {k: np.array(v, dtype=np.float64) for k, v in mix_logw.items()},
        base.msd_weights, base.dur_mean, base.dur_var, base.streams)


def upmix(ms: ModelSet, perturb: float = 0.2) -> MixtureModelSet:
    """HHEd `MU +1` equivalent: 1 -> 2 components per stream, means split
    at +/- perturb * stddev, weights halved."""
    means, variances, logw = {}, {}, {}
    for st in ms.streams:
        mu = ms.means[st.name]           # (M, S, D)
        va = ms.variances[st.name]
        sd = np.sqrt(va)
        means[st.name] = np.stack([mu + perturb * sd, mu - perturb * sd], 2)
        variances[st.name] = np.stack([va, va], 2)
        M, S = mu.shape[:2]
        logw[st.name] = np.full((M, S, 2), np.log(0.5))
    return MixtureModelSet(list(ms.names), means, variances, logw,
                           {k: v.copy() for k, v in ms.msd_weights.items()},
                           ms.dur_mean.copy(), ms.dur_var.copy(),
                           ms.streams)


# ---------------------------------------------------------------------------
# mixture log-likelihoods and posteriors: K33
# ---------------------------------------------------------------------------


def _comp_ll(x, mu, va):
    """Per-component diagonal-Gaussian log densities in the JAX package's
    `_gauss_ll` order: x (..., D) against mu/va (..., C, D) -> (..., C)."""
    d2 = (x[..., None, :] - mu) ** 2 / va
    return -0.5 * (torch.sum(d2, -1) + torch.sum(torch.log(va), -1)
                   + x.shape[-1] * LOG_2PI)


def _logsumexp(z):
    """jax.scipy.special.logsumexp over the last axis: the max taken as 0
    where it is not finite."""
    m = torch.amax(z, -1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return torch.log(torch.sum(torch.exp(z - m), -1)) + m[..., 0]


def batch_frame_loglik_mix_plain(frames, rows, means, variances, logws,
                                 msd_w, stream_slices, msd_flags,
                                 weights_static):
    """The plain twin of K33's chain mode, one utterance at a time as the
    JAX package's `frame_loglik_mix`: per stream the components' ll, a
    logsumexp with the log-weights, the MSD presence term, and the
    weighted sum over every stream (weight-0 bap too: unchanged for a
    finite ll, NaN for a non-finite one)."""
    B, Tb, _ = frames.shape
    Kb = rows[0].shape[1]
    out = torch.empty((B, Tb, Kb), dtype=frames.dtype, device=frames.device)
    for b in range(B):
        x_all = frames[b]
        total = 0.0
        for i, ((a, e), is_msd, wt) in enumerate(
                zip(stream_slices, msd_flags, weights_static)):
            r = rows[i][b]
            ll_c = _comp_ll(x_all[:, None, a:e], means[i][r][None],
                            variances[i][r][None])        # (Tb, Kb, C)
            ll = _logsumexp(logws[i][r][None] + ll_c)
            if is_msd:
                present = (x_all[:, a] != 0.0)[:, None]
                w = torch.clamp(msd_w[i][r], 1e-4, 1.0 - 1e-4)[None]
                ll = torch.where(present, torch.log(w) + ll, torch.log1p(-w))
            total = total + wt * ll
        out[b] = total
    return out


def mix_rows_plain(means, variances, logws, msd_w, msd_flags):
    """The plain twin of K33's row prologue: per stream (1/v (R, C, D_s),
    sum log v (R, C), the log-weights (R, C), log w (R,), log1p(-w) (R,)),
    w the MSD weight clipped to [1e-4, 1 - 1e-4]; the last two are None for
    a non-MSD stream.  1/v is NaN where |v| is outside [2^-60, 2^60] or mu
    is neither 0 nor of magnitude in [2^-400, 2^479): the kernel divides
    those terms (its quotient corrections need no overflow or underflow).
    The kernel scores log w_c - 0.5 ((sum (x - mu)^2 / v + sum log v) +
    D_s log 2pi) from them, each quotient correctly rounded from 1/v and
    v."""
    out = []
    for m, v, lw, w, f in zip(means, variances, logws, msd_w, msd_flags):
        a, am = v.abs(), m.abs()
        ok = ((a >= 2.0 ** -60) & (a <= 2.0 ** 60)
              & ((am == 0) | ((am >= 2.0 ** -400) & (am < 2.0 ** 479))))
        rv = torch.where(ok, 1.0 / v, torch.full_like(v, float("nan")))
        ml = m1 = None
        if f:
            wc = torch.clamp(w, 1e-4, 1.0 - 1e-4)
            ml, m1 = torch.log(wc), torch.log1p(-wc)
        out.append((rv, torch.log(v).sum(-1), lw, ml, m1))
    return out


# K33's row tables on the card, per mixture set, as K17's
# (`hsmm._ROW_TABLES`): key -> (the tables the key names, kept alive so
# their addresses cannot be reused; the buffer the row prologue fills; the
# launcher's host meta and weights)
_MIX_ROW_TABLES: "collections.OrderedDict" = collections.OrderedDict()


def _mix_row_tables(means, variances, logws, msd_w, stream_slices,
                    msd_flags, weights_static):
    """(buffer, meta, weights, entry): K33's tables for this mixture set,
    cached on the tables' addresses, versions and shapes and the stream
    arguments; entry is None on a hit.  On a miss a new buffer holds per
    stream the (mu, v) pairs (R, C, D_s, 2) at an even offset, room for 1/v
    and sum log v, the log-weights and the MSD weights; the launch runs the
    row prologue over it first, and `entry` (key, tables) goes into the
    cache once the launch succeeds.  An in-place change of a table bumps
    its version and misses."""
    tabs_in = (*means, *variances, *logws, *msd_w)
    key, hit = hsmm.table_cache_lookup(_MIX_ROW_TABLES, tabs_in,
                                       stream_slices, msd_flags,
                                       weights_static)
    if hit is not None:
        return (*hit, None)
    meta, at, parts = [], 0, []
    for (a, e), m, f in zip(stream_slices, means, msd_flags):
        R, C, _ = m.shape
        n, rc = m.numel(), R * C
        offs = [at, at + 2 * n, at + 3 * n, at + 3 * n + rc,
                at + 3 * n + 2 * rc, at + 3 * n + 2 * rc + R]
        meta += [a, e, int(bool(f)), R] + offs
        parts.append(offs)
        at = offs[5] + R
        at += at % 2                       # the next pairs 16-byte aligned
    buf = torch.empty(at, dtype=torch.float64, device=means[0].device)
    for offs, m, v, lw, w, f in zip(parts, means, variances, logws, msd_w,
                                    msd_flags):
        n, rc, R = m.numel(), lw.numel(), m.shape[0]
        mv = buf[offs[0]:offs[0] + 2 * n].view(*m.shape, 2)
        mv[..., 0].copy_(m)
        mv[..., 1].copy_(v)
        buf[offs[3]:offs[3] + rc].copy_(lw.reshape(-1))
        if f:
            buf[offs[4]:offs[4] + R].copy_(w.reshape(-1))
    meta_c = (ctypes.c_longlong * len(meta))(*meta)
    wts_c = (ctypes.c_double * len(weights_static))(
        *map(float, weights_static))
    return buf, meta_c, wts_c, (key, tabs_in)


def batch_frame_loglik_mix(frames, rows, means, variances, logws, msd_w,
                           stream_slices, msd_flags, weights_static):
    """K33, chain mode: frames (B, Tb, D); per stream i, rows[i] (B, Kb)
    int64 ids into means[i] / variances[i] (R_i, C, D_i), logws[i] (R_i, C)
    and msd_w[i] (R_i,) (ignored for a non-MSD stream) -> (B, Tb, Kb), all
    float64.  Per (b, t, k): the sum over streams of weight * ll, where ll
    is the logsumexp over the C components of log w_c + [-0.5 (sum (x -
    mu)^2/v + sum log v + D_i log 2pi)] (the max shift taken as 0 where it
    is not finite), and an MSD stream scores log w + ll on frames whose
    first column is non-zero and log1p(-w) elsewhere (w clipped to [1e-4,
    1-1e-4]).  1 <= C <= MAX_COMPONENTS.  On the card the row prologue
    (1/v, sum log v, log w, log1p(-w)) runs once per mixture set: its
    buffer is cached on the tables (`_mix_row_tables`)."""
    if not frames.is_cuda:
        return batch_frame_loglik_mix_plain(
            frames, rows, means, variances, logws, msd_w, stream_slices,
            msd_flags, weights_static)
    n = len(stream_slices)
    B, Tb, D = frames.shape
    Kb = rows[0].shape[1]
    C = means[0].shape[1] if means[0].dim() == 3 else 0
    f64 = torch.float64
    if (frames.dtype != f64 or len(rows) != n or len(means) != n
            or len(variances) != n or len(logws) != n or len(msd_w) != n
            or n > 8 or not 1 <= C <= MAX_COMPONENTS
            or any(r.dtype != torch.long or r.shape != (B, Kb) for r in rows)
            or any(m.dtype != f64 or v.dtype != f64 or lw.dtype != f64
                   or m.dim() != 3 or m.shape != v.shape
                   or m.shape[1:] != (C, e - a)
                   or lw.shape != (m.shape[0], C)
                   for m, v, lw, (a, e) in zip(means, variances, logws,
                                               stream_slices))
            or any(f and (w.dtype != f64 or w.shape != (m.shape[0],))
                   for f, w, m in zip(msd_flags, msd_w, means))
            or any(not 0 <= a < e <= D for a, e in stream_slices)):
        raise ValueError(
            "batch_frame_loglik_mix: float64 frames (B, T, D), per stream "
            "int64 rows (B, K) and float64 tables (R, C, D_s), log-weights "
            f"(R, C) [+ msd weights (R,)], 1 <= C <= {MAX_COMPONENTS}, at "
            "most 8 streams")
    dev = frames.device
    frames = frames.contiguous()
    rows_c = [r.contiguous() for r in rows]
    kernels.check_cuda("batch_frame_loglik_mix", frames, *rows_c)
    if any(t.device != dev for t in (*means, *variances, *logws, *msd_w)):
        raise ValueError("batch_frame_loglik_mix: the tables must be on the "
                         "frames' device")
    buf, meta, wts, entry = _mix_row_tables(means, variances, logws, msd_w,
                                            stream_slices, msd_flags,
                                            weights_static)
    out = torch.empty((B, Tb, Kb), dtype=f64, device=dev)
    kernels.launch("hsmm_mix_loglik", [
        frames.data_ptr(), B, Tb, D, Kb, n, C, meta, wts,
        (ctypes.c_void_p * n)(*(r.data_ptr() for r in rows_c)),
        buf.data_ptr(), int(entry is not None), out.data_ptr()],
        dict(frames=frames, rows=tuple(rows), means=tuple(means),
             variances=tuple(variances), logws=tuple(logws),
             msd_w=tuple(msd_w), stream_slices=tuple(stream_slices),
             msd_flags=tuple(msd_flags),
             weights_static=tuple(weights_static)),
        fn="hsmm_mix_loglik_launch")
    if entry is not None:
        hsmm.table_cache_store(_MIX_ROW_TABLES, entry, (buf, meta, wts))
    return out


def mix_quotients(x, mu, v):
    """The terms K33's chain kernel adds, (x - mu)^2 / v elementwise
    (float64, one shape): on the card its arithmetic and its choice (1/v
    as the row prologue forms it, then two corrections to the correctly
    rounded quotient wherever the chain kernel's range tests on x, mu and
    v pass, the division elsewhere), so a check can hold both against the
    division bit for bit; on the CPU `(x - mu)^2 / v`."""
    if not x.is_cuda:
        dx = x - mu
        return dx * dx / v
    if (any(t.dtype != torch.float64 for t in (x, mu, v))
            or not x.shape == mu.shape == v.shape):
        raise ValueError("mix_quotients: float64 x, mu and v of one shape")
    x, mu, v = x.contiguous(), mu.contiguous(), v.contiguous()
    kernels.check_cuda("mix_quotients", x, mu, v)
    out = torch.empty_like(x)
    kernels.launch("hsmm_mix_loglik", [x.data_ptr(), mu.data_ptr(),
                                       v.data_ptr(), x.numel(),
                                       out.data_ptr()], None,
                   fn="hsmm_mix_quot_launch", variant="quot")
    return out


def frame_loglik_mix(frames, means, variances, logws, msd_w,
                     stream_slices, msd_flags, weights_static):
    """Mixture analogue of hsmm.frame_loglik: frames (T, D); means /
    variances per stream (S, C, D_s), logws (S, C), msd_w (S,); returns
    (T, S).  One utterance of `batch_frame_loglik_mix` (K33 on the
    card)."""
    S = means[0].shape[0]
    rows = tuple(torch.arange(S, device=frames.device)[None]
                 for _ in means)
    return batch_frame_loglik_mix(frames[None], rows, means, variances,
                                  logws, msd_w, stream_slices, msd_flags,
                                  weights_static)[0]


def responsibilities_plain(x, rows, means, variances, logw):
    """The plain twin of K33's posterior mode, the JAX package's
    `_responsibilities` for every frame at once: z = logw + ll, z - max,
    exp, divided by the row sum."""
    ll = _comp_ll(x, means[rows], variances[rows])           # (N, C)
    z = logw[rows] + ll
    z = z - torch.amax(z, 1, keepdim=True)
    r = torch.exp(z)
    return r / torch.sum(r, 1, keepdim=True)


def responsibilities(x, rows, means, variances, logw):
    """K33, posterior mode: one stream's frames x (N, D_s), each with its
    row id rows (N,) int64 into means / variances (R, C, D_s) and logw
    (R, C) -> the component posteriors (N, C), float64: per frame z_c =
    log w_c + ll_c (K33's ll_c), z - max_c z, exp, divided by the sum over
    c.  1 <= C <= MAX_COMPONENTS."""
    if not x.is_cuda:
        return responsibilities_plain(x, rows, means, variances, logw)
    f64 = torch.float64
    N = x.shape[0]
    if (x.dtype != f64 or x.dim() != 2 or rows.dtype != torch.long
            or rows.shape != (N,) or means.dtype != f64
            or variances.dtype != f64 or logw.dtype != f64
            or means.dim() != 3 or means.shape != variances.shape
            or means.shape[2] != x.shape[1]
            or logw.shape != means.shape[:2]
            or not 1 <= means.shape[1] <= MAX_COMPONENTS):
        raise ValueError(
            "responsibilities: float64 x (N, D), int64 rows (N,), float64 "
            f"means/variances (R, C, D) and logw (R, C), 1 <= C <= "
            f"{MAX_COMPONENTS}")
    x, rows, means, variances, logw = (
        t.contiguous() for t in (x, rows, means, variances, logw))
    kernels.check_cuda("responsibilities", x, rows, means, variances, logw)
    C = means.shape[1]
    out = torch.empty((N, C), dtype=f64, device=x.device)
    kernels.launch("hsmm_mix_loglik", [
        x.data_ptr(), N, x.shape[1], C, rows.data_ptr(), means.data_ptr(),
        variances.data_ptr(), logw.data_ptr(), out.data_ptr()],
        dict(x=x, rows=rows, means=means, variances=variances, logw=logw),
        fn="hsmm_mix_post_launch", variant="post")
    return out


def _mix_tables(mms: MixtureModelSet, dev):
    """The mixture set's stream tables as flat rows on `dev` (row (mi, s)
    -> mi*S + s): means / variances (M*S, C, D_s), log-weights (M*S, C),
    msd weights (M*S,), float64."""
    M, S = mms.dur_mean.shape
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=f64, device=dev)
    C = mms.n_comps
    means = tuple(t(mms.means[st.name].reshape(M * S, C, -1))
                  for st in mms.streams)
    vars_ = tuple(t(mms.variances[st.name].reshape(M * S, C, -1))
                  for st in mms.streams)
    logws = tuple(t(mms.mix_logw[st.name].reshape(M * S, C))
                  for st in mms.streams)
    msd_w = tuple(t(mms.msd_weights[st.name].reshape(M * S)) if st.msd
                  else torch.zeros(M * S, dtype=f64, device=dev)
                  for st in mms.streams)
    return means, vars_, logws, msd_w


# ---------------------------------------------------------------------------
# alignment: K17 or K33, then K20, over padded batches
# ---------------------------------------------------------------------------


def _align_corpus(model, utterances, score, max_dur: int, dev):
    """`hsmm_batch.align_corpus` over a monophone corpus of (frames,
    label_seq) under `model` (a ModelSet or a MixtureModelSet): chain
    state k of label li has row index(name)*S + s for every stream and
    the durations alike."""
    def chain(frames, seq):
        r = hb.chain_rows_modelset(model, seq)
        return hb.ChainedUtterance(np.asarray(frames, float),
                                   {st.name: r for st in model.streams}, r)
    return hb.align_corpus(utterances, model.n_states, chain, score,
                           model.dur_mean.reshape(-1),
                           model.dur_var.reshape(-1), max_dur, dev)


def _mix_scorer(mms: MixtureModelSet, dev):
    tabs = _mix_tables(mms, dev)
    args = hsmm.stream_args(mms.streams)
    return lambda fr, rows: batch_frame_loglik_mix(fr, rows, *tabs, *args)


def _single_scorer(ms: ModelSet, dev):
    tabs = hsmm._tables(ms, dev)
    args = hsmm.stream_args(ms.streams)
    return lambda fr, rows: hsmm.batch_frame_loglik(fr, rows, *tabs, *args)


def align_corpus_mix(mms: MixtureModelSet, utterances, max_dur: int = 40,
                     device="cuda"):
    """Viterbi alignment of a corpus under the mixture models: one K33 and
    one K20 launch a padded batch.  Returns per utterance, in order,
    (loglik, ends (numpy)) or the ValueError of an infeasible one."""
    dev = device_mod.resolve(device)
    return _align_corpus(mms, utterances, _mix_scorer(mms, dev), max_dur,
                         dev)


def align_utterance_mix(mms: MixtureModelSet, frames: np.ndarray,
                        label_seq: Sequence[str], max_dur: int = 40,
                        device="cuda"):
    """Viterbi alignment under the mixture models: (loglik, state ends
    (numpy)).  Raises ValueError on infeasible utterances (fewer frames
    than chain states), matching hsmm.align_utterance."""
    res = align_corpus_mix(mms, [(frames, label_seq)], max_dur, device)[0]
    if isinstance(res, ValueError):
        raise res
    return res


def _frame_rows(mms: MixtureModelSet, aligned, utterances):
    """Per aligned utterance, each frame's row id (index(name)*S + s of
    the chain state that holds it), and each chain state's (row,
    duration), in utterance order."""
    rows, durs = [], []
    for (frames, seq), res in zip(utterances, aligned):
        if isinstance(res, ValueError):
            continue
        d = np.diff(np.concatenate([[0], res[1]]))
        r = hb.chain_rows_modelset(mms, seq)
        rows.append(np.repeat(r, d))
        durs.append((r, d))
    return rows, durs


# ---------------------------------------------------------------------------
# ERST5: embedded re-estimation of the mixtures
# ---------------------------------------------------------------------------


def embedded_reestimate_mix(mms: MixtureModelSet, utterances,
                            n_iters: int = 3, var_floor_scale: float = 0.01,
                            max_dur: int = 40, log=print,
                            min_mix_w: float = 1e-3, device="cuda"):
    """ERST5 equivalent: embedded re-estimation of the upmixed models —
    Viterbi state alignment (K33 + K20 a padded batch), then per-segment
    mixture EM: component posteriors (K33's posterior mode, one launch a
    stream for every segment) and their weighted moments (K19, one launch
    a stream).  The M-step's rules are the JAX package's: durations' mean
    and variance + 1, MSD weights clipped to [1e-3, 1 - 1e-3], a stream
    skipped under 2 voiced frames, weights clip(occ / sum, min_mix_w, 1)
    renormalised, components with occ <= 1 left as they are, variances
    floored at gvar * var_floor_scale + 1e-8.  Infeasible utterances are
    dropped."""
    dev = device_mod.resolve(device)
    all_frames = np.concatenate([u[0] for u in utterances])
    _, gvar = global_stats(all_frames, mms.streams)
    floor = gvar * var_floor_scale + 1e-8
    M, S, C = len(mms.names), mms.n_states, mms.n_comps
    R = M * S

    for it in range(n_iters):
        aligned = align_corpus_mix(mms, utterances, max_dur, dev)
        total_ll = 0.0
        for res in aligned:
            if not isinstance(res, ValueError):
                total_ll += res[0]
        rows_u, durs_u = _frame_rows(mms, aligned, utterances)
        if not rows_u:
            log(f"mixture EM iter {it}: total loglik {total_ll:.1f}")
            continue
        frames = np.concatenate([np.asarray(f, float) for (f, _), res
                                 in zip(utterances, aligned)
                                 if not isinstance(res, ValueError)])
        rows = np.concatenate(rows_u)
        # durations per (model, state) in utterance order, as the JAX
        # package lists them
        dlist: Dict[int, list] = {}
        for r, d in durs_u:
            for ri, di in zip(r.tolist(), d.tolist()):
                dlist.setdefault(ri, []).append(di)
        for ri, dl in dlist.items():
            d = np.asarray(dl, float)
            mi, s = divmod(ri, S)
            mms.dur_mean[mi, s] = d.mean()
            mms.dur_var[mi, s] = d.var() + 1.0
        seen = np.zeros(R, bool)
        seen[list(dlist)] = True
        n_frames = np.bincount(rows, minlength=R)
        means, vars_, logws, _ = _mix_tables(mms, dev)
        for si, st in enumerate(mms.streams):
            block, r_f = frames[:, st.sl], rows
            live = seen.copy()
            if st.msd:
                present = frames[:, st.msd_flag_col] != 0.0
                n_pres = np.bincount(rows[present], minlength=R)
                for ri in np.flatnonzero(seen):
                    mms.msd_weights[st.name][divmod(ri, S)] = float(np.clip(
                        n_pres[ri] / n_frames[ri], 1e-3, 1 - 1e-3))
                live &= n_pres >= 2
                block, r_f = block[present], rows[present]
            keep_f = live[r_f]
            block, r_f = block[keep_f], r_f[keep_f]
            if not len(r_f):
                continue
            x = torch.as_tensor(np.ascontiguousarray(block),
                                dtype=torch.float64, device=dev)
            ids = torch.as_tensor(r_f, device=dev)
            r = responsibilities(x, ids, means[si], vars_[si], logws[si])
            cols = torch.cat([r, (r[:, :, None] * x[:, None]).reshape(
                len(r_f), -1), (r[:, :, None] * (x * x)[:, None]).reshape(
                len(r_f), -1)], 1)
            acc = hb.segment_sum(cols, ids, R, hb.member_lists(r_f, R)
                                 if x.is_cuda else None).cpu().numpy()
            Ds = block.shape[1]
            occ_all = acc[:, :C] + 1e-10
            mx_all = acc[:, C:C + C * Ds].reshape(R, C, Ds)
            mx2_all = acc[:, C + C * Ds:].reshape(R, C, Ds)
            fl = floor[st.sl][None]
            for ri in np.flatnonzero(live):
                mi, s = divmod(ri, S)
                occ = occ_all[ri]
                w = np.clip(occ / occ.sum(), min_mix_w, 1.0)
                mms.mix_logw[st.name][mi, s] = np.log(w / w.sum())
                mu = mx_all[ri] / occ[:, None]
                va = mx2_all[ri] / occ[:, None] - mu ** 2
                keep = occ > 1.0   # don't update starved components
                mms.means[st.name][mi, s][keep] = mu[keep]
                mms.variances[st.name][mi, s][keep] = np.maximum(
                    va[keep], fl)
        log(f"mixture EM iter {it}: total loglik {total_ll:.1f}")
    return mms


def generate_from_models_mix(mms: MixtureModelSet,
                             label_seq: Sequence[str],
                             speaking_rate: float = 1.0):
    """HMGenS on mixture models: per state/stream take the dominant
    component's Gaussian (the EM-based generation's fixed point for
    well-separated mixtures)."""
    S = mms.n_states
    means = {st.name: [] for st in mms.streams}
    vars_ = {st.name: [] for st in mms.streams}
    vuv, durs = [], []
    for name in label_seq:
        mi = mms.index(name)
        d = np.maximum(1, np.round(
            mms.dur_mean[mi] * speaking_rate)).astype(int)
        durs.append(d)
        for s in range(S):
            for st in mms.streams:
                c = int(np.argmax(mms.mix_logw[st.name][mi, s]))
                means[st.name].append(np.repeat(
                    mms.means[st.name][mi, s, c][None], d[s], 0))
                vars_[st.name].append(np.repeat(
                    mms.variances[st.name][mi, s, c][None], d[s], 0))
            w = (mms.msd_weights["lf0"][mi, s]
                 if "lf0" in mms.msd_weights else 1.0)
            vuv.append(np.full(d[s], w > 0.5))
    durs = np.concatenate(durs)
    return ({k: np.concatenate(v) for k, v in means.items()},
            {k: np.concatenate(v) for k, v in vars_.items()},
            np.concatenate(vuv), durs)


# ---------------------------------------------------------------------------
# semi-tied covariance (SEMIT): K34
# ---------------------------------------------------------------------------


def semitied_blocks_plain(betas, scatters, n_iter: int = 20):
    """The plain twin of K34: the JAX package's `semitied_block` on each
    job, in float64, row by row as it orders it: sigmas fixed for each
    outer step, rows updated in place, cofactor = det(A) * inv(A)[:, r],
    u = solve(G_r, cofactor), scale = sqrt(beta_tot / max(cof @ u,
    1e-300)), sigmas floored at 1e-10."""
    J, G, d, _ = scatters.shape
    beta_tot = torch.sum(betas)
    A_out = torch.empty((J, d, d), dtype=scatters.dtype,
                        device=scatters.device)
    sig_out = torch.empty((J, G, d), dtype=scatters.dtype,
                          device=scatters.device)
    aux_out = torch.empty((J, n_iter), dtype=scatters.dtype,
                          device=scatters.device)

    for j in range(J):
        W = scatters[j]

        def diag_sig(A):
            s = torch.diagonal(A @ W @ A.T, dim1=-2, dim2=-1)
            return torch.maximum(s, torch.full_like(s, 1e-10))

        A = torch.eye(d, dtype=scatters.dtype, device=scatters.device)
        for it in range(n_iter):
            sig = diag_sig(A)
            for r in range(d):
                Gr = torch.einsum("g,gij->ij", betas / sig[:, r], W)
                cof = torch.linalg.det(A) * torch.linalg.inv(A)[:, r]
                u = torch.linalg.solve(Gr, cof)
                scale = torch.sqrt(beta_tot / torch.clamp(cof @ u,
                                                          min=1e-300))
                A = A.clone()
                A[r] = u * scale
            sig2 = diag_sig(A)
            aux_out[j, it] = (beta_tot * torch.log(torch.abs(
                torch.linalg.det(A)))
                - 0.5 * torch.sum(betas[:, None] * torch.log(sig2)))
        A_out[j] = A
        sig_out[j] = diag_sig(A)
    return A_out, sig_out, aux_out


def semitied_gr_plain(betas, scatters, sigmas):
    """The plain form of K34's G_r stage: every row's G_r of every job at
    once, G[j, r] = sum_g (beta_g / sigmas[j, g, r]) scatters[j, g] -> (J,
    d, d, d), as one (d x G) by (G x d^2) product a job (the twin forms each
    row's by an einsum as it reaches the row; the sigmas are fixed for the
    whole outer step)."""
    J, G, d, _ = scatters.shape
    coef = betas[None, None, :] / sigmas.transpose(1, 2)          # (J, d, G)
    return torch.matmul(coef, scatters.reshape(J, G, d * d)).reshape(
        J, d, d, d)


def semitied_blocks(betas, scatters, n_iter: int = 20):
    """K34: Gales' semi-tied covariance estimation for J independent
    blocks that share their Gaussians' occupancies.  betas (G,) float64,
    scatters (J, G, d, d) float64 (per job and Gaussian, its scatter
    matrix) -> (A (J, d, d), sigmas (J, G, d), aux (J, n_iter)): per job,
    n_iter outer steps of {sigmas = max(diag(A W_g A^T), 1e-10); for each
    row r in turn: G_r = sum_g beta_g / sigma_gr W_g, the cofactor row
    det(A) inv(A)[:, r] by LU with partial pivoting, u = G_r^-1 cof, row r
    = u sqrt(beta_tot / max(cof.u, 1e-300))}, and aux = beta_tot log|det A|
    - 0.5 sum_g beta_g sum_j log sigma_gj after each step; the sigmas
    returned are those of the final A.  Any d on the card: the G_r stack
    (J d^3 doubles) lives in device memory."""
    if not scatters.is_cuda:
        return semitied_blocks_plain(betas, scatters, n_iter)
    f64 = torch.float64
    if (betas.dtype != f64 or scatters.dtype != f64 or scatters.dim() != 4
            or betas.shape != scatters.shape[1:2]
            or scatters.shape[2] != scatters.shape[3] or n_iter < 0
            or min(scatters.shape) < 1):
        raise ValueError("semitied_blocks: float64 betas (G,) and scatters "
                         "(J, G, d, d), n_iter >= 0")
    J, G, d, _ = scatters.shape
    betas, scatters = betas.contiguous(), scatters.contiguous()
    kernels.check_cuda("semitied_blocks", betas, scatters)
    dev = scatters.device
    A = torch.empty((J, d, d), dtype=f64, device=dev)
    sig = torch.empty((J, G, d), dtype=f64, device=dev)
    aux = torch.empty((J, max(n_iter, 1)), dtype=f64, device=dev)
    # csrc/semitied.cu's scratch: the G_r stack (J, d, d, d), inv(A) and
    # A's LU (J, d, d) each where they do not fit in shared memory, det A
    # (J,); G_r's row permutations (J, d, d)
    work = torch.empty(J * (d ** 3 + 2 * d * d + 1), dtype=f64, device=dev)
    iwork = torch.empty(J * d * d, dtype=torch.int32, device=dev)
    kernels.launch("semitied", [
        betas.data_ptr(), scatters.data_ptr(), J, G, d, int(n_iter),
        A.data_ptr(), sig.data_ptr(), aux.data_ptr(), work.data_ptr(),
        iwork.data_ptr()],
        dict(betas=betas, scatters=scatters, n_iter=int(n_iter)))
    return A, sig, aux[:, :n_iter]


def semitied_block(betas, scatters, n_iter: int = 20):
    """Gales' semi-tied covariance estimation for one block: betas (G,),
    scatters (G, d, d) -> (A (d, d), sigmas (G, d), aux (n_iter,)), aux the
    per-iteration auxiliary objective beta_tot*log|det A| - 0.5 * sum_g
    beta_g * sum_j log sigma_gj (monotone non-decreasing).  One job of
    `semitied_blocks` (K34 on the card)."""
    A, sig, aux = semitied_blocks(betas, scatters[None], n_iter)
    return A[0], sig[0], aux[0]


def _stream_blocks(st: StreamDef, n_blocks: int):
    """Split a stream's column span into n_blocks equal blocks (one per
    delta window by default, configure.ac:706-709)."""
    dim = st.sl.stop - st.sl.start
    assert dim % n_blocks == 0, (st.name, dim, n_blocks)
    b = dim // n_blocks
    return [(st.sl.start + i * b, st.sl.start + (i + 1) * b)
            for i in range(n_blocks)]


@dataclasses.dataclass
class SemiTiedModelSet:
    """A ModelSet plus one block-diagonal transform per (non-excluded)
    stream.  Likelihood of frame x: N(A x; A mu, sigma) + log|det A|
    per stream; sigma are the re-estimated diagonal variances in the
    transformed space."""
    base: ModelSet
    transforms: Dict[str, np.ndarray]   # stream -> (D, D) block-diagonal
    logdets: Dict[str, float]

    def transformed_modelset(self) -> ModelSet:
        """ModelSet in the transformed feature space (means A mu,
        variances already transformed): align/EM machinery from hsmm.py
        applies to transform_frames()'d observations."""
        ms = self.base
        means = {}
        for st in ms.streams:
            A = self.transforms.get(st.name)
            mu = ms.means[st.name]
            means[st.name] = mu if A is None else mu @ A.T
        return ModelSet(ms.names, means, ms.variances, ms.msd_weights,
                        ms.dur_mean, ms.dur_var, ms.streams)

    def transform_frames(self, frames: np.ndarray) -> np.ndarray:
        out = frames.copy()
        for st in self.base.streams:
            A = self.transforms.get(st.name)
            if A is not None:
                out[:, st.sl] = frames[:, st.sl] @ A.T
        return out

    def loglik_constant(self, n_frames: int) -> float:
        """Jacobian term: T * sum_streams wt * log|det A|."""
        return n_frames * sum(
            st.weight * self.logdets.get(st.name, 0.0)
            for st in self.base.streams)


def semitied_from_numpy(base, transforms, logdets) -> SemiTiedModelSet:
    """A SemiTiedModelSet from plain parts: `base` the arguments of
    `hsmm.modelset_from_numpy` (what `ModelSet.to_numpy()` gives),
    `transforms` {stream: (D, D)} and `logdets` {stream: float}."""
    return SemiTiedModelSet(
        hsmm.modelset_from_numpy(*base),
        {k: np.array(v, dtype=np.float64) for k, v in transforms.items()},
        {k: float(v) for k, v in logdets.items()})


def estimate_semitied(ms: ModelSet, utterances,
                      n_blocks: Dict[str, int] | None = None,
                      n_iter: int = 20, max_dur: int = 40,
                      var_floor_scale: float = 0.01, log=print,
                      device="cuda") -> SemiTiedModelSet:
    """SEMIT stage: Viterbi-align under the current models (K17 + K20 a
    padded batch), collect per-Gaussian scatter statistics per stream,
    estimate block-diagonal semi-tied transforms (one base class per
    stream — make_stc_base, Training.pl:1726-1779; K34, one launch a
    stream with its blocks as independent jobs), and replace variances
    with the transformed diagonals.  MSD streams use voiced frames only
    (the reference's base classes target mix[1], the voiced space); a
    Gaussian with fewer than the stream's width + 1 frames is left out.

    n_blocks defaults to one block per delta window (3) where a stream's
    width divides by 3, else 1; callers may override per stream.  `ms` is
    updated in place (means to the aligned sample means, variances to the
    transformed diagonals)."""
    dev = device_mod.resolve(device)
    S = ms.n_states
    if n_blocks is None:
        n_blocks = {}
        for st in ms.streams:
            dim = st.sl.stop - st.sl.start
            n_blocks[st.name] = 3 if dim % 3 == 0 else 1

    # E-step: hard-align, collect the segments per (model, state)
    aligned = _align_corpus(ms, utterances, _single_scorer(ms, dev),
                            max_dur, dev)
    stats: Dict = {}
    for (frames, label_seq), res in zip(utterances, aligned):
        if isinstance(res, ValueError):
            continue  # infeasible utterance: drop, like the other E-steps
        ends = res[1]
        starts = np.concatenate([[0], ends[:-1]])
        for li, name in enumerate(label_seq):
            for s in range(S):
                k = li * S + s
                seg = frames[starts[k]:ends[k]]
                if not len(seg):
                    continue
                stats.setdefault((name, s), []).append(seg)

    transforms, logdets = {}, {}
    all_frames = np.concatenate([u[0] for u in utterances])
    _, gvar = global_stats(all_frames, ms.streams)
    floor = gvar * var_floor_scale + 1e-8

    for st in ms.streams:
        dim = st.sl.stop - st.sl.start
        blocks = _stream_blocks(st, n_blocks.get(st.name, 1))
        keys, betas, segs_by_key = [], [], []
        for key, fl in stats.items():
            seg = np.concatenate(fl)
            if st.msd:
                seg = seg[seg[:, st.msd_flag_col] != 0.0]
            if len(seg) < dim + 1:
                continue
            keys.append(key)
            betas.append(float(len(seg)))
            segs_by_key.append(seg[:, st.sl])
        if not keys:
            continue
        # every block's statistics before any M-step write: the blocks are
        # independent jobs of one K34 launch
        scat = np.stack([np.stack([
            np.cov(seg[:, b0 - st.sl.start:b1 - st.sl.start].T,
                   bias=True).reshape(b1 - b0, b1 - b0)
            for seg in segs_by_key]) for b0, b1 in blocks])
        A_j, sig_j, aux_j = (t.cpu().numpy() for t in semitied_blocks(
            torch.as_tensor(np.asarray(betas), dtype=torch.float64,
                            device=dev),
            torch.as_tensor(scat, dtype=torch.float64, device=dev),
            n_iter))
        A_full = np.zeros((dim, dim))
        for bi, (b0, b1) in enumerate(blocks):
            lo, hi = b0 - st.sl.start, b1 - st.sl.start
            A_full[lo:hi, lo:hi] = A_j[bi]
            # M-step (HERest -u smvdmv): means to the aligned sample
            # means, variances to the transformed diagonals
            for ki, key in enumerate(keys):
                mi = ms.index(key[0])
                ms.means[st.name][mi, key[1], lo:hi] = \
                    segs_by_key[ki][:, lo:hi].mean(0)
                ms.variances[st.name][mi, key[1], lo:hi] = np.maximum(
                    sig_j[bi, ki], floor[b0:b1])
        transforms[st.name] = A_full
        logdets[st.name] = float(
            np.log(np.abs(np.linalg.det(A_full))))
        aux = aux_j.sum(0)
        assert np.all(np.diff(aux) >= -1e-6 * np.abs(aux[:-1]) - 1e-8), \
            "semi-tied auxiliary objective must be monotone"
        log(f"SEMIT {st.name}: logdet {logdets[st.name]:+.4f}, "
            f"aux {aux[0]:.1f} -> {aux[-1]:.1f}")
    return SemiTiedModelSet(ms, transforms, logdets)
