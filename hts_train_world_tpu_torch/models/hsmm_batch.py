"""Batched HSMM EM — the corpus-scale HERest E-step (Training.pl:433-446)
as a handful of launches per bucket batch instead of a per-utterance loop.

Counterpart of `hts_train_world_tpu/models/hsmm_batch.py` (without the
mesh).  Every trainable pdf row (a (model, state) for the monophone or
untied set; a (stream, state, leaf) for the tied model) lives in one global
table per stream; each utterance is a chain of K states carrying row ids
into those tables, per stream for the tied model.  Per padded batch:

  K17 (gathered MSD log-likelihoods) -> duration gather ->
  K18 (segmental forward-backward, true t_len/k_len) -> `ok` mask ->
  per stream gamma^T @ frames and gamma^T @ frames^2 (`torch.bmm`) ->
  K19 (one launch: every table's segment sums, in a fixed order, added
  into the E-step's running row tables; its member lists are built on the
  host as the batch is padded)

Utterances are grouped on the JAX package's bucket grid (T aligned to 16,
K to 4, growth 1.26), so groups, batches and every summation order over
them match its.  The accumulators stay on the device until the E-step
ends; the host reads them once.  All float64.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.models import hsmm

LOG_ZERO = hsmm.LOG_ZERO
GROWTH = 1.26      # the bucket grid's step (the JAX package's)
MAX_BATCH = 32     # utterances in one padded batch


# ---------------------------------------------------------------------------
# global row tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowTables:
    """Global pdf tables: per stream (R_s, D_s) mean/var (+ (R_s,) msd
    weight), plus flat (R_d,) duration mean/var."""
    means: Dict[str, np.ndarray]
    vars: Dict[str, np.ndarray]
    msd_w: Dict[str, np.ndarray]
    dur_mean: np.ndarray
    dur_var: np.ndarray
    streams: Sequence[hsmm.StreamDef]


def tables_from_modelset(ms: hsmm.ModelSet) -> RowTables:
    """Row (mi, s) -> mi*S + s."""
    M, S = ms.dur_mean.shape
    return RowTables(
        {st.name: ms.means[st.name].reshape(M * S, -1) for st in ms.streams},
        {st.name: ms.variances[st.name].reshape(M * S, -1)
         for st in ms.streams},
        {st.name: ms.msd_weights[st.name].reshape(M * S)
         for st in ms.streams if st.msd},
        ms.dur_mean.reshape(M * S), ms.dur_var.reshape(M * S), ms.streams)


def chain_rows_modelset(ms: hsmm.ModelSet, label_seq) -> np.ndarray:
    """(K,) row ids for an utterance chain under the monophone table."""
    S = ms.n_states
    idxs = np.asarray([ms.index(n) for n in label_seq])
    return (idxs[:, None] * S + np.arange(S)[None, :]).reshape(-1)


def tables_from_clustered(model) -> Tuple[RowTables, dict, int]:
    """Stack the tied model's leaves: stream row (s, leaf) -> offs[s]+leaf
    where offs accumulates leaves over states; duration row (dl, s) ->
    dl*S + s.  Returns (tables, {stream: offsets (S,)}, dur row count)."""
    S = model.n_states
    means, vars_, msd_w, offsets = {}, {}, {}, {}
    for st in model.streams:
        ms_, vs_, ws_ = [], [], []
        offs = np.zeros(S, np.int64)
        at = 0
        for s in range(S):
            tree = model.trees[st.name][s]
            offs[s] = at
            for leaf in range(tree.n_leaves):
                m, v = tree.leaf_params[leaf]
                ms_.append(np.asarray(m, float))
                vs_.append(np.asarray(v, float))
                if st.msd:
                    ws_.append(float(model.msd_weights[st.name][s][leaf]))
            at += tree.n_leaves
        means[st.name] = np.stack(ms_)
        vars_[st.name] = np.stack(vs_)
        if st.msd:
            msd_w[st.name] = np.asarray(ws_)
        offsets[st.name] = offs
    Ld = model.dur_tree.n_leaves
    dmean = np.zeros(Ld * S)
    dvar = np.zeros(Ld * S)
    for leaf in range(Ld):
        m, v = model.dur_tree.leaf_params[leaf]
        dmean[leaf * S:(leaf + 1) * S] = np.asarray(m, float)
        dvar[leaf * S:(leaf + 1) * S] = np.asarray(v, float)
    return (RowTables(means, vars_, msd_w, dmean, dvar, model.streams),
            offsets, Ld * S)


def chain_rows_clustered(model, ctx_seq, offsets):
    """Per-stream (K,) row ids + (K,) duration row ids for the tied model."""
    S = model.n_states
    K = len(ctx_seq) * S
    rows = {st.name: np.zeros(K, np.int64) for st in model.streams}
    dur_rows = np.zeros(K, np.int64)
    for li, ctx in enumerate(ctx_seq):
        dl = model.dur_tree.leaf_of(ctx)
        for s in range(S):
            k = li * S + s
            dur_rows[k] = dl * S + s
            for st in model.streams:
                leaf = model.trees[st.name][s].leaf_of(ctx)
                rows[st.name][k] = offsets[st.name][s] + leaf
    return rows, dur_rows


# ---------------------------------------------------------------------------
# bucketed batch assembly
# ---------------------------------------------------------------------------


def _bucket(n: int, growth: float = 1.26, align: int = 8) -> int:
    if n <= align:
        return align
    steps = math.ceil(math.log(n / align) / math.log(growth))
    b = align * growth ** steps
    return int(math.ceil(b / align) * align)


@dataclasses.dataclass
class ChainedUtterance:
    frames: np.ndarray                 # (T, D)
    rows: Dict[str, np.ndarray]        # per stream (K,)
    dur_rows: np.ndarray               # (K,)
    index: int = 0                     # position in its corpus


def _pad_group(group: List[ChainedUtterance], Tb: int, Kb: int, D: int,
               stream_names, batch_pad: int = 1):
    """Pad a same-bucket group to (B, Tb, D) / (B, Kb) arrays; weight 0
    marks batch-padding dummies (B rounded up to batch_pad)."""
    B = len(group)
    Bp = int(math.ceil(B / batch_pad) * batch_pad)
    frames = np.zeros((Bp, Tb, D))
    rows = {n: np.zeros((Bp, Kb), np.int64) for n in stream_names}
    dur_rows = np.zeros((Bp, Kb), np.int64)
    t_len = np.ones(Bp, np.int32)
    k_len = np.ones(Bp, np.int32)
    w = np.zeros(Bp)
    for i, u in enumerate(group):
        T, K = len(u.frames), len(u.dur_rows)
        frames[i, :T] = u.frames
        for n in stream_names:
            rows[n][i, :K] = u.rows[n]
        dur_rows[i, :K] = u.dur_rows
        t_len[i] = T
        k_len[i] = K
        w[i] = 1.0
    return frames, rows, dur_rows, t_len, k_len, w


def _groups(utts, growth: float = GROWTH):
    """{(Tb, Kb): [utterance, ...]} on the JAX package's bucket grid."""
    groups: Dict = {}
    for u in utts:
        key = (_bucket(len(u.frames), growth, 16),
               _bucket(len(u.dur_rows), growth, 4))
        groups.setdefault(key, []).append(u)
    return groups


def align_corpus(utterances, n_states: int, chain, score, dur_mean,
                 dur_var, max_dur: int, dev, max_batch: int = MAX_BATCH):
    """HSMMAlign (hard Viterbi) over a corpus of (frames, labels) in
    padded batches on the JAX package's bucket grid: per batch one
    `score(frames (B, Tb, D), rows)` launch for the chain log-likelihoods
    (K17 or K33; `rows` holds a (B, Kb) row-id tensor per stream, in the
    chain's stream order) and one K20 launch.  `chain(frames, labels)`
    gives an utterance's `ChainedUtterance`; `dur_mean` / `dur_var` are
    the flat duration tables its `dur_rows` index.  Padded frames and
    states are never read, so each utterance's result is its own alone.
    Returns per utterance, in order, (loglik, ends (numpy)) or the
    ValueError of a chain longer than its frames."""
    out: List = [None] * len(utterances)
    chained = []
    for ui, (frames, labels) in enumerate(utterances):
        K = len(labels) * n_states
        if len(frames) < K:
            out[ui] = ValueError(
                f"utterance has {len(frames)} frames but the chain needs "
                f">= {K} ({len(labels)} labels x {n_states} states); "
                f"alignment is infeasible")
            continue
        chained.append(dataclasses.replace(chain(frames, labels),
                                           index=ui))
    if not chained:
        return out

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    names = list(chained[0].rows)
    D = chained[0].frames.shape[1]
    dm_t, dv_t = t(dur_mean), t(dur_var)
    for (Tb, Kb), group in sorted(_groups(chained).items()):
        for at in range(0, len(group), max_batch):
            part = group[at:at + max_batch]
            frames, rows, dur_rows, t_len, k_len, _ = _pad_group(
                part, Tb, Kb, D, names)
            obs_ll = score(t(frames),
                           tuple(t(rows[n], torch.long) for n in names))
            dr = t(dur_rows, torch.long)
            ll, ends = hsmm.viterbi_segment_batch(
                obs_ll, dm_t[dr], dv_t[dr], t(t_len, torch.long),
                t(k_len, torch.long), max_dur)
            ll, ends = ll.cpu().numpy(), ends.cpu().numpy()
            for b, u in enumerate(part):
                out[u.index] = (float(ll[b]), ends[b, :k_len[b]].copy())
    return out


# ---------------------------------------------------------------------------
# segment sums into the row tables: K19
# ---------------------------------------------------------------------------


def segment_sum_plain(vals, ids, n_rows: int):
    """The plain twin of K19 for one table: `index_add_`, which on the
    CPU adds the rows of `vals` (N, C) in ascending order of N.  (On the
    card its float64 atomics add in another order on every run; it is
    K19's yardstick.)"""
    out = torch.zeros((n_rows, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, ids, vals)


def member_lists(ids, n_rows: int):
    """K19's member lists of one table's row ids (N,): the positions in a
    stable order by row id and each row's offsets into it, CSR form, both
    int32 numpy: row r's members are order[offsets[r]:offsets[r + 1]], in
    ascending position."""
    ids = np.asarray(ids).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= n_rows):
        raise ValueError(f"member_lists: row ids must lie in [0, {n_rows})")
    offsets = np.zeros(n_rows + 1, np.int32)
    np.cumsum(np.bincount(ids, minlength=n_rows), out=offsets[1:])
    return np.argsort(ids, kind="stable").astype(np.int32), offsets


def upload_members(lists, device):
    """Per table (order, offsets) numpy pairs (`member_lists`) uploaded in
    one copy: int32 views on `device`."""
    flat = torch.as_tensor(np.concatenate(
        [np.asarray(a, np.int32) for pair in lists for a in pair]),
        device=device)
    out, at = [], 0
    for order, offsets in lists:
        n1, n2 = len(order), len(offsets)
        out.append((flat[at:at + n1], flat[at + n1:at + n1 + n2]))
        at += n1 + n2
    return out


def segment_sums_plain(vals, ids, n_rows, acc, members=None):
    """The plain twin of K19's launch: for each table, the running table
    `acc` plus `segment_sum_plain` of its statistics (`members` is not
    needed)."""
    return tuple(a + segment_sum_plain(v, i, n)
                 for v, i, n, a in zip(vals, ids, n_rows, acc))


MAX_TABLES = 8      # tables one K19 launch takes


def segment_sums(vals, ids, n_rows, acc, members=None, out=None):
    """K19: for each table t of a batch (up to MAX_TABLES, one launch),
    out[t] = acc[t] + S, where S[r] is the sum of vals[t][i] (N, C) over
    the i with ids[t][i] == r, added in ascending i from 0.0 (the CPU's
    `index_add_` order, so the card's sums equal the CPU's bit for bit and
    do not vary between runs) and the add into acc is the same float64 add
    as a merge on the host.  ids (N,) int64 in [0, n_rows[t]); acc (n_rows,
    C); float64.  `members`: per table (order, offsets) from
    `member_lists`, numpy or int32 on the device (built from the ids when
    None); `out`: the tables written (acc itself adds in place), fresh
    when None.  Returns the tables written."""
    if not vals[0].is_cuda:
        res = segment_sums_plain(vals, ids, n_rows, acc)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out)
    n = len(vals)
    if not 1 <= n <= MAX_TABLES or not n == len(ids) == len(n_rows) \
            == len(acc) or (members is not None and len(members) != n):
        raise ValueError(f"segment_sums: 1 to {MAX_TABLES} tables, each "
                         f"with its vals, ids, n_rows and acc")
    dev = vals[0].device
    if members is None:
        members = [member_lists(i.cpu().numpy(), nr)
                   for i, nr in zip(ids, n_rows)]
    if isinstance(members[0][0], np.ndarray):
        members = upload_members(members, dev)
    vals = tuple(v.contiguous() for v in vals)
    out = tuple(torch.empty_like(a) for a in acc) if out is None \
        else tuple(out)
    f64, i32 = torch.float64, torch.int32
    flat, dims = [], []
    for v, i, nr, a, o, (order, offsets) in zip(vals, ids, n_rows, acc, out,
                                                members):
        if (v.dim() != 2 or i.dim() != 1 or nr < 1 or v.shape[1] < 1
                or v.dtype != f64
                or a.dtype != f64 or o.dtype != f64 or i.dtype != torch.long
                or order.dtype != i32 or offsets.dtype != i32
                or i.shape[0] != v.shape[0] or order.shape[0] != v.shape[0]
                or offsets.shape[0] != nr + 1
                or a.shape != (nr, v.shape[1]) or o.shape != a.shape):
            raise ValueError("segment_sums: float64 vals (N, C), int64 ids "
                             "(N,), n_rows >= 1, float64 acc and out (n_rows,"
                             " C), int32 members (N,), (n_rows + 1,)")
        flat += (v, order, offsets, a, o)
        dims += (v.shape[1], nr)
    kernels.check_cuda("segment_sums", *flat)
    inputs = dict(vals=vals, ids=tuple(ids), n_rows=tuple(n_rows),
                  acc=tuple(a.clone() if kernels.record is not None else a
                            for a in acc),
                  members=tuple(members))
    kernels.launch("hsmm_accumulate", [
        n, (ctypes.c_ulonglong * len(flat))(*(t.data_ptr() for t in flat)),
        (ctypes.c_int * len(dims))(*dims)], inputs)
    return out


def segment_sum(vals, ids, n_rows: int, members=None):
    """K19 on one table: out[r] = the sum of vals[i] (N, C) over i with
    ids[i] == r, added in ascending i from 0.0, as `segment_sums` into a
    table at +0.0.  ids (N,) int64 in [0, n_rows); float64; `members` as
    `segment_sums` takes them (the caller that holds the ids on the host
    builds them there)."""
    if not vals.is_cuda:
        return segment_sum_plain(vals, ids, n_rows)
    if (vals.dtype != torch.float64 or vals.dim() != 2
            or ids.dtype != torch.long or ids.shape != (vals.shape[0],)
            or n_rows < 1):
        raise ValueError("segment_sum: float64 vals (N, C), int64 ids (N,), "
                         "n_rows >= 1")
    acc = torch.zeros((n_rows, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return segment_sums((vals,), (ids,), (n_rows,), (acc,),
                        None if members is None else (members,),
                        out=(acc,))[0]


# ---------------------------------------------------------------------------
# the bucketed E-step
# ---------------------------------------------------------------------------


def _bucket_estep_stages(frames, rows, dur_rows, t_len, k_len, w,
                         means, vars_, msd_w, dur_mean, dur_var,
                         sls, flags, wts, max_dur: int, n_rows,
                         n_dur_rows: int, temper: float = 1.0,
                         members=None, into=None):
    """One padded batch -> accumulators, yielding after each stage:
    ("loglik", None), ("fb", None), ("moments", None) and
    ("accumulate", (total_ll, n_ok, per-stream dicts, dur (R_d, 3))), all
    tensors on the batch's device.

    frames (B,T,D); rows: tuple per stream (B,K); dur_rows (B,K);
    t_len/k_len (B,) int64; w (B,).  means/vars_/msd_w: tuples of
    (R_s, D_s)/(R_s,).  K19 adds the batch's sums of every stream and the
    durations, in one launch, into the running tables `into` (per stream
    (R_s, C_s), then (R_d, 3); fresh at +0.0 when None); `members` are
    the tables' `member_lists` (built from the row ids when None).  The
    dicts are views of those tables."""
    obs_ll = hsmm.batch_frame_loglik(frames, rows, means, vars_, msd_w,
                                     sls, flags, wts)
    yield "loglik", None
    ll, gamma, dstats = hsmm.segment_fb(obs_ll, dur_mean[dur_rows],
                                        dur_var[dur_rows], max_dur, temper,
                                        t_len, k_len)
    yield "fb", None

    # infeasible utterances (chain longer than frames / durations beyond
    # max_dur): posterior undefined -> drop, like the loop version
    ok = w * (ll > LOG_ZERO / 2)
    total_ll = torch.sum(torch.where(ok > 0, ll * w, 0.0))
    n_ok = torch.sum(ok)
    gamma = gamma * ok[:, None, None]
    dstats = dstats * ok[:, None, None]

    stats = []
    x2 = frames * frames
    for i, (a, b) in enumerate(sls):
        g = gamma
        if flags[i]:
            pm = (frames[:, :, a] != 0.0).to(frames.dtype)     # (B,T)
            g = gamma * pm[:, :, None]
        gt = g.transpose(1, 2)
        occ_k = g.sum(1)                                       # (B, K)
        x_k = torch.bmm(gt, frames[:, :, a:b])
        x2_k = torch.bmm(gt, x2[:, :, a:b])
        cols = [occ_k[..., None], x_k, x2_k]
        if flags[i]:
            cols += [occ_k[..., None], gamma.sum(1)[..., None]]  # p_occ/tot
        stats.append(torch.cat(cols, -1))
    yield "moments", None

    vals = [st.reshape(-1, st.shape[-1]) for st in stats] \
        + [dstats.reshape(-1, 3)]
    nr = tuple(n_rows) + (n_dur_rows,)
    if into is None:
        into = [torch.zeros((n, v.shape[1]), dtype=v.dtype, device=v.device)
                for n, v in zip(nr, vals)]
    tabs = segment_sums(vals, [r.reshape(-1) for r in rows]
                        + [dur_rows.reshape(-1)], nr, into, members,
                        out=into)
    yield "accumulate", (total_ll, n_ok, stream_parts(tabs[:-1], sls, flags),
                         tabs[-1])


def stream_parts(tabs, sls, flags):
    """Per stream, the named column views of its K19 table (R, C): occ, x,
    x2 (+ p_occ, p_tot for an MSD stream)."""
    out = []
    for acc, (a, b), msd in zip(tabs, sls, flags):
        d = b - a
        parts = {"occ": acc[:, 0], "x": acc[:, 1:1 + d],
                 "x2": acc[:, 1 + d:1 + 2 * d]}
        if msd:
            parts["p_occ"] = acc[:, 1 + 2 * d]
            parts["p_tot"] = acc[:, 2 + 2 * d]
        out.append(parts)
    return out


def _bucket_estep(*args, **kw):
    """`_bucket_estep_stages` run to its end: (total_ll, n_ok, per-stream
    accumulator dicts, dur (R_d, 3))."""
    for _, res in _bucket_estep_stages(*args, **kw):
        pass
    return res


@dataclasses.dataclass
class EStepAccumulators:
    total_ll: float
    n_ok: float
    streams: List[dict]        # per stream: occ/x/x2 (+ p_occ/p_tot)
    dur: np.ndarray            # (R_d, 3)


def corpus_estep_stages(tables: RowTables,
                        utts: Sequence[ChainedUtterance],
                        n_rows: Dict[str, int], n_dur_rows: int,
                        max_dur: int = 40, temper: float = 1.0,
                        growth: float = 1.26, max_batch: int = 32,
                        device="cuda"):
    """`corpus_estep`, yielding (stage, value) as it goes: ("pad", None)
    after each batch is padded and copied to the device, each batch's
    `_bucket_estep_stages`, and last ("done", EStepAccumulators)."""
    dev = device_mod.resolve(device)
    sts = tables.streams
    names = [st.name for st in sts]
    sls, flags, wts = hsmm.stream_args(sts)
    nr = tuple(n_rows[n] for n in names)
    D = utts[0].frames.shape[1]
    f64 = torch.float64

    def t(a, dtype=f64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    m_t = tuple(t(tables.means[n]) for n in names)
    v_t = tuple(t(tables.vars[n]) for n in names)
    w_t = tuple(t(tables.msd_w[n]) if f else torch.zeros(1, dtype=f64,
                                                         device=dev)
                for n, f in zip(names, flags))
    dm_t, dv_t = t(tables.dur_mean), t(tables.dur_var)

    # the E-step's running tables, per stream then the durations: K19
    # adds each batch's sums into them
    tabs = [torch.zeros((n, 1 + 2 * (b - a) + 2 * f), dtype=f64, device=dev)
            for n, (a, b), f in zip(nr, sls, flags)] \
        + [torch.zeros((n_dur_rows, 3), dtype=f64, device=dev)]
    total = None
    for (Tb, Kb), group in sorted(_groups(utts, growth).items()):
        for at in range(0, len(group), max_batch):
            frames, rows, dur_rows, t_len, k_len, w = _pad_group(
                group[at:at + max_batch], Tb, Kb, D, names)
            args = (t(frames), tuple(t(rows[n], torch.long) for n in names),
                    t(dur_rows, torch.long), t(t_len, torch.long),
                    t(k_len, torch.long), t(w))
            members = (upload_members(
                [member_lists(rows[n], r) for n, r in zip(names, nr)]
                + [member_lists(dur_rows, n_dur_rows)], dev)
                if dev.type == "cuda" else None)
            yield "pad", None
            for stage, res in _bucket_estep_stages(
                    *args, m_t, v_t, w_t, dm_t, dv_t, sls, flags, wts,
                    max_dur, nr, n_dur_rows, temper, members, tabs):
                yield stage, None
            ll, ok = res[:2]
            total = (ll, ok) if total is None else (total[0] + ll,
                                                    total[1] + ok)
    total_ll, n_ok = total
    host = [np.asarray(a.cpu().numpy()) for a in tabs]
    yield "done", EStepAccumulators(
        float(total_ll), float(n_ok),
        [{k: np.ascontiguousarray(v) for k, v in a.items()}
         for a in stream_parts(host[:-1], sls, flags)], host[-1])


def corpus_estep(tables: RowTables, utts: Sequence[ChainedUtterance],
                 n_rows: Dict[str, int], n_dur_rows: int, max_dur: int = 40,
                 temper: float = 1.0, growth: float = 1.26,
                 max_batch: int = 32, device="cuda") -> EStepAccumulators:
    """Full-corpus soft E-step: bucket -> pad -> _bucket_estep, whose K19
    adds each batch into the running tables on the device; the host reads
    them once at the end."""
    for _, res in corpus_estep_stages(tables, utts, n_rows, n_dur_rows,
                                      max_dur, temper, growth, max_batch,
                                      device):
        pass
    return res


# ---------------------------------------------------------------------------
# M-step (host numpy)
# ---------------------------------------------------------------------------


def mstep_modelset(ms: hsmm.ModelSet, acc: EStepAccumulators, floor,
                   min_occ: float = 1e-6):
    """Write the batched accumulators back into the (M, S, ...) model
    arrays — the same update _soft_reestimate_iter applies from dicts."""
    M, S = ms.dur_mean.shape
    mass = acc.dur[:, 0]
    upd = mass > min_occ
    dm = np.where(upd, acc.dur[:, 1] / np.maximum(mass, 1e-30),
                  ms.dur_mean.reshape(-1))
    dv = np.where(upd,
                  np.maximum(acc.dur[:, 2] / np.maximum(mass, 1e-30)
                             - dm * dm, 0.0) + 1.0,
                  ms.dur_var.reshape(-1))
    ms.dur_mean[:] = dm.reshape(M, S)
    ms.dur_var[:] = dv.reshape(M, S)
    for i, st in enumerate(ms.streams):
        a = acc.streams[i]
        if st.msd:
            tot = a["p_tot"]
            upd_w = tot > min_occ
            w = np.clip(a["p_occ"] / np.maximum(tot, 1e-30), 1e-3, 1 - 1e-3)
            flat_w = ms.msd_weights[st.name].reshape(-1)
            ms.msd_weights[st.name][:] = np.where(
                upd_w, w, flat_w).reshape(M, S)
            occ = a["occ"]
            upd_g = occ > 2.0
        else:
            occ = a["occ"]
            upd_g = occ > min_occ
        den = np.maximum(occ, 1e-30)[:, None]
        mu = a["x"] / den
        va = np.maximum(a["x2"] / den - mu * mu, floor[st.sl][None])
        mflat = ms.means[st.name].reshape(M * S, -1)
        vflat = ms.variances[st.name].reshape(M * S, -1)
        ms.means[st.name][:] = np.where(
            upd_g[:, None], mu, mflat).reshape(ms.means[st.name].shape)
        ms.variances[st.name][:] = np.where(
            upd_g[:, None], va, vflat).reshape(ms.variances[st.name].shape)
    return ms


def mstep_clustered(model, offsets, acc: EStepAccumulators, floors,
                    min_occ: float = 1e-6):
    """Write accumulators back into tree leaf params + msd weights +
    the joint duration tree."""
    S = model.n_states
    for i, st in enumerate(model.streams):
        a = acc.streams[i]
        for s in range(S):
            tree = model.trees[st.name][s]
            off = offsets[st.name][s]
            for leaf in range(tree.n_leaves):
                r = off + leaf
                occ = a["occ"][r]
                if st.msd:
                    tot = a["p_tot"][r]
                    if tot > min_occ:
                        model.msd_weights[st.name][s][leaf] = float(
                            np.clip(a["p_occ"][r] / tot, 1e-3, 1 - 1e-3))
                    if occ <= 2.0:
                        continue
                elif occ <= min_occ:
                    continue
                mu = a["x"][r] / occ
                va = np.maximum(a["x2"][r] / occ - mu * mu,
                                floors[st.name])
                tree.leaf_params[leaf] = (mu, va)
    Ld = model.dur_tree.n_leaves
    for leaf in range(Ld):
        rows = acc.dur[leaf * S:(leaf + 1) * S]
        mass = rows[:, 0]
        if (mass <= min_occ).any():
            continue
        dm = rows[:, 1] / mass
        dv = np.maximum(rows[:, 2] / mass - dm * dm, 0.0) + 1.0
        model.dur_tree.leaf_params[leaf] = (dm, dv)
    return model


# ---------------------------------------------------------------------------
# the EM loops
# ---------------------------------------------------------------------------


def chain_modelset(ms: hsmm.ModelSet, utterances):
    """(ChainedUtterance list, variance floor) for a monophone corpus of
    (frames (T, D), label_seq) pairs."""
    all_frames = np.concatenate([u[0] for u in utterances])
    _, gvar = hsmm.global_stats(all_frames, ms.streams)
    chained = []
    for f, seq in utterances:
        r = chain_rows_modelset(ms, seq)   # same rows for every stream
        chained.append(ChainedUtterance(
            np.asarray(f, float), {st.name: r for st in ms.streams}, r))
    return chained, gvar


def reestimate_modelset_batched(ms: hsmm.ModelSet, utterances,
                                n_iters: int = 3,
                                var_floor_scale: float = 0.01,
                                max_dur: int = 40, temper: float = 1.0,
                                max_batch: int = 32, log=print,
                                device="cuda"):
    """Batched HERest for the monophone modelset: device E-step + table
    M-step.  Same accumulators as
    hsmm.embedded_reestimate(mode="baum_welch"), corpus-scalable.
    Returns the total log-likelihood of each iteration."""
    device_mod.resolve(device)
    chained, gvar = chain_modelset(ms, utterances)
    floor = gvar * var_floor_scale + 1e-8
    M, S = ms.dur_mean.shape
    n_rows = {st.name: M * S for st in ms.streams}
    history = []
    for it in range(n_iters):
        tables = tables_from_modelset(ms)
        acc = corpus_estep(tables, chained, n_rows, M * S, max_dur,
                           temper, max_batch=max_batch, device=device)
        mstep_modelset(ms, acc, floor)
        log(f"batched BW iter {it}: total loglik {acc.total_ll:.1f} "
            f"({acc.n_ok:.0f} utts)")
        history.append(acc.total_ll)
    return history


def reestimate_clustered_batched(model, utterances, n_iters: int = 2,
                                 max_dur: int = 40,
                                 var_floor_scale: float = 0.01,
                                 max_batch: int = 32, log=print,
                                 device="cuda"):
    """Batched soft-count ERST2/ERST4: HERest on the tied mmf
    (Training.pl:538-551) — full Baum-Welch occupancies accumulated per
    tree leaf on the device (K17-K19, separate row ids per stream),
    replacing the hard Viterbi counts of
    context_clustered.reestimate_clustered.  Returns the total
    log-likelihood of each iteration."""
    device_mod.resolve(device)
    all_frames = np.concatenate([u[0] for u in utterances])
    _, gvar = hsmm.global_stats(all_frames, model.streams)
    floors = {st.name: gvar[st.sl] * var_floor_scale + 1e-8
              for st in model.streams}
    history = []
    for it in range(n_iters):
        tables, offsets, n_dur = tables_from_clustered(model)
        n_rows = {n: len(tables.means[n]) for n in tables.means}
        chained = []
        for f, ctx_seq in utterances:
            rows, dur_rows = chain_rows_clustered(model, ctx_seq, offsets)
            chained.append(ChainedUtterance(np.asarray(f, float), rows,
                                            dur_rows))
        acc = corpus_estep(tables, chained, n_rows, n_dur, max_dur,
                           max_batch=max_batch, device=device)
        mstep_clustered(model, offsets, acc, floors)
        log(f"batched tied BW iter {it}: total loglik {acc.total_ll:.1f} "
            f"({acc.n_ok:.0f} utts)")
        history.append(acc.total_ll)
    return history
