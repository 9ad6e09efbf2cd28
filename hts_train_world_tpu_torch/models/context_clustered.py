"""Context-dependent tied models — the HTS full-context flow
(Training.pl MN2FL/CXCL/ERST/FALGN/CONVM stages, SURVEY.md T3):
monophone bootstrap -> full-context statistics from alignments ->
per-(stream, state) MDL tree clustering -> tied parameter lookup ->
HMGenS-style generation and .htsvoice export.

Counterpart of `hts_train_world_tpu/models/context_clustered.py`.  The
statistics, trees and M-steps are host numpy, in the JAX package's order;
the alignments run on the card in padded batches (K17, then K20 through
`hsmm.viterbi_segment_batch`) and the soft counts through the batched
E-step of `models/hsmm_batch.py` (K17-K19).  Entry points take
`device="cuda"` (the default; raises without a card) or `device="cpu"`,
where the kernels run as their plain twins.  `ClusteredModel.to_plain` /
`clustered_from_plain` carry a model across as plain tuples and numpy.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence

import numpy as np
import torch

from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.models import clustering, hsmm, voice

_PHONE_RE = re.compile(r"-(.+?)\+")


def phone_of(context: str) -> str:
    m = _PHONE_RE.search(context)
    return m.group(1) if m else context


@dataclasses.dataclass
class ClusteredModel:
    streams: Sequence[hsmm.StreamDef]
    n_states: int
    trees: Dict[str, List[clustering.Tree]]       # stream -> per-state
    dur_tree: clustering.Tree                     # ONE tree, (S,)-dim leaves
    msd_weights: Dict[str, List[np.ndarray]]      # stream -> per-state/leaf

    def to_plain(self):
        """A dict of plain values: streams as (name, start, stop, msd,
        msd_flag_col, weight) tuples, n_states, per stream the per-state
        `Tree.to_plain` pairs, the duration tree's pair, and per MSD stream
        the per-state leaf weights (float64 copies).  Reads attributes
        only, so it also takes a JAX package model."""
        return dict(
            streams=tuple((st.name, st.sl.start, st.sl.stop, bool(st.msd),
                           int(st.msd_flag_col), float(st.weight))
                          for st in self.streams),
            n_states=int(self.n_states),
            trees={n: [clustering.Tree.to_plain(t) for t in ts]
                   for n, ts in self.trees.items()},
            dur_tree=clustering.Tree.to_plain(self.dur_tree),
            msd_weights={n: [np.array(w, dtype=np.float64) for w in ws]
                         for n, ws in self.msd_weights.items()})

    def state_params(self, context: str, state: int):
        out = {}
        for st in self.streams:
            tree = self.trees[st.name][state]
            leaf = tree.leaf_of(context)
            mean, var = tree.leaf_params[leaf]
            w = (self.msd_weights[st.name][state][leaf]
                 if st.msd else 1.0)
            out[st.name] = (mean, var, w)
        return out

    def duration(self, context: str, state: int):
        """The duration model is ONE tree whose leaves carry the
        n_states-dim duration Gaussian — the reference's dur mmf has one
        model of nState scalar streams clustered by a single TB command
        (Training.pl:496-532), which hts_engine loads as an
        (nState,)-vector pdf per leaf."""
        mean, var = self.dur_tree.leaf_params[self.dur_tree.leaf_of(context)]
        return float(mean[state]), float(var[state])

    def durations(self, context: str):
        """(S,) duration means/vars for one context."""
        mean, var = self.dur_tree.leaf_params[self.dur_tree.leaf_of(context)]
        return np.asarray(mean, float), np.asarray(var, float)

    def generate(self, label_seq: Sequence[str], speaking_rate: float = 1.0):
        """Frame-level means/vars per stream + V/UV, MLPG-ready."""
        means = {st.name: [] for st in self.streams}
        vars_ = {st.name: [] for st in self.streams}
        vuv = []
        durs = []
        for ctx in label_seq:
            for s in range(self.n_states):
                dm, _ = self.duration(ctx, s)
                d = max(1, int(round(dm * speaking_rate)))
                durs.append(d)
                params = self.state_params(ctx, s)
                for st in self.streams:
                    mean, var, w = params[st.name]
                    means[st.name].append(np.repeat(mean[None], d, 0))
                    vars_[st.name].append(np.repeat(var[None], d, 0))
                lw = params["lf0"][2] if "lf0" in means else 1.0
                vuv.append(np.full(d, lw > 0.5))
        return ({k: np.concatenate(v) for k, v in means.items()},
                {k: np.concatenate(v) for k, v in vars_.items()},
                np.concatenate(vuv), np.asarray(durs))


def clustered_from_plain(plain) -> ClusteredModel:
    """The port's ClusteredModel from `ClusteredModel.to_plain`'s dict."""
    streams = tuple(hsmm.StreamDef(str(n), slice(int(a), int(b)), bool(m),
                                   int(c), float(w))
                    for n, a, b, m, c, w in plain["streams"])
    return ClusteredModel(
        streams, int(plain["n_states"]),
        {n: [clustering.tree_from_plain(*t) for t in ts]
         for n, ts in plain["trees"].items()},
        clustering.tree_from_plain(*plain["dur_tree"]),
        {n: [np.array(w, dtype=np.float64) for w in ws]
         for n, ws in plain["msd_weights"].items()})


def collect_context_stats(modelset: hsmm.ModelSet, utterances,
                          max_dur: int = 40, device="cuda"):
    """Align with the (monophone) modelset and accumulate per-(context,
    state) sufficient statistics for every stream + durations.

    utterances: list of (frames, full_context_seq).  Returns
    {stream: [ {context: SuffStats} per state ]}, plus duration stats."""
    S = modelset.n_states
    stream_stats = {st.name: [dict() for _ in range(S)]
                    for st in modelset.streams}
    msd_stats = {st.name: [dict() for _ in range(S)]
                 for st in modelset.streams if st.msd}
    dur_stats: Dict[str, clustering.SuffStats] = {}
    device_mod.resolve(device)
    for frames, ctx_seq in utterances:
        mono = [phone_of(c) for c in ctx_seq]
        try:
            _, ends = hsmm.align_utterance(modelset, frames, mono, max_dur,
                                           device)
        except ValueError:
            # utterance shorter than its chain: unalignable, skip (the
            # reference's screening drops such utterances up front,
            # data/Makefile.in:216-238)
            continue
        starts = np.concatenate([[0], ends[:-1]])
        for li, ctx in enumerate(ctx_seq):
            dvec = (ends[li * S:(li + 1) * S]
                    - starts[li * S:(li + 1) * S]).astype(float)
            ds = clustering.SuffStats(1.0, dvec, dvec * dvec)
            dur_stats[ctx] = (dur_stats[ctx] + ds
                              if ctx in dur_stats else ds)
            for s in range(S):
                k = li * S + s
                seg = frames[starts[k]:ends[k]]
                for st in modelset.streams:
                    block = seg[:, st.sl]
                    if st.msd:
                        present = seg[:, st.msd_flag_col] != 0.0
                        pres = clustering.SuffStats(
                            float(len(seg)), np.array([present.sum()]),
                            np.array([float(present.sum())]))
                        m = msd_stats[st.name][s]
                        m[ctx] = m[ctx] + pres if ctx in m else pres
                        block = block[present]
                        if not len(block):
                            continue
                    ss = clustering.SuffStats.from_frames(block)
                    d_ = stream_stats[st.name][s]
                    d_[ctx] = d_[ctx] + ss if ctx in d_ else ss
    return stream_stats, msd_stats, dur_stats


def build_clustered_model(modelset: hsmm.ModelSet, stream_stats, msd_stats,
                          dur_stats, questions, mdl_factor: float = 1.0,
                          min_occupancy: float = 1.0) -> ClusteredModel:
    S = modelset.n_states
    trees = {}
    msd_weights = {}
    for st in modelset.streams:
        trees[st.name] = [clustering.cluster_states(
            stream_stats[st.name][s], questions, mdl_factor, min_occupancy,
            msd_by_context=(msd_stats[st.name][s] if st.msd else None),
            dim=st.sl.stop - st.sl.start)
            for s in range(S)]
        if st.msd:
            per_state = []
            for s in range(S):
                tree = trees[st.name][s]
                # voiced weight per leaf from the msd counts routed
                # through the same tree
                w = np.full(tree.n_leaves, 0.5)
                acc = [[0.0, 0.0] for _ in range(tree.n_leaves)]
                for ctx, ss in msd_stats[st.name][s].items():
                    leaf = tree.leaf_of(ctx)
                    acc[leaf][0] += float(ss.s1[0])
                    acc[leaf][1] += ss.gamma
                for li, (v, n) in enumerate(acc):
                    if n > 0:
                        w[li] = np.clip(v / n, 1e-3, 1 - 1e-3)
                per_state.append(w)
            msd_weights[st.name] = per_state
    dur_tree = clustering.cluster_states(dur_stats, questions,
                                         mdl_factor, min_occupancy)
    return ClusteredModel(modelset.streams, S, trees, dur_tree,
                          msd_weights)


def export_voice(model: ClusteredModel, path: str, fs: int,
                 frame_shift: int, static_dims: Dict[str, int],
                 gv_model=None, alpha: float = 0.0,
                 gv_off_context=()) -> None:
    """CONVM: package the tied model (+ optional MCDGV GV models) into
    one .htsvoice (Training.pl:761-797, 2303-2609).  gv_model: a
    models/gv_model.GVModel whose trees carry per-stream GV pdfs —
    exported as GV_PDF/GV_TREE sections (Training.pl:2496-2516)."""
    packs = []
    for st in model.streams:
        gv_tree = None
        if gv_model is not None and st.name in gv_model.trees:
            gv_tree = gv_model.trees[st.name]
        option = ""
        if st.name == "mgc" and alpha:
            # OPTION[MGC]:ALPHA=..,GAMMA=..,LN_GAIN=.. (Training.pl:2400)
            option = f"ALPHA={alpha},GAMMA=0,LN_GAIN=1"
        packs.append(voice.StreamPack(
            st.name, static_dims.get(st.name, 1), st.msd, 3,
            model.trees[st.name],
            msd_weights=model.msd_weights.get(st.name),
            use_gv=gv_tree is not None, option=option, gv_tree=gv_tree))
    dur = voice.StreamPack("dur", model.n_states, False, 1,
                           [model.dur_tree])
    voice.export_htsvoice(path, fs, frame_shift, model.n_states, packs, dur,
                          gv_off_context=gv_off_context)


# ---------------------------------------------------------------------------
# tied-model embedded re-estimation + reclustering (ERST2 / UNTIE->CXCL2 /
# ERST4, Training.pl:496-599)
# ---------------------------------------------------------------------------


def _chain_arrays(model: ClusteredModel, ctx_seq):
    """Stack the tied per-(context, state) params into chain-ordered
    arrays: per stream (K, D_s) mean/var (+ msd weight (K,)), duration
    (K,) mean/var, and per-stream leaf ids (K,) for stat accumulation."""
    S = model.n_states
    K = len(ctx_seq) * S
    means = {st.name: [] for st in model.streams}
    vars_ = {st.name: [] for st in model.streams}
    msd_w = {st.name: [] for st in model.streams}
    leaf_ids = {st.name: np.zeros(K, np.int64) for st in model.streams}
    dur_leaf = np.zeros(K, np.int64)
    dmean = np.zeros(K)
    dvar = np.zeros(K)
    for li, ctx in enumerate(ctx_seq):
        dl = model.dur_tree.leaf_of(ctx)
        dm, dv = model.dur_tree.leaf_params[dl]
        for s in range(S):
            k = li * S + s
            for st in model.streams:
                tree = model.trees[st.name][s]
                leaf = tree.leaf_of(ctx)
                leaf_ids[st.name][k] = leaf
                mean, var = tree.leaf_params[leaf]
                means[st.name].append(mean)
                vars_[st.name].append(var)
                msd_w[st.name].append(
                    model.msd_weights[st.name][s][leaf] if st.msd else 1.0)
            dur_leaf[k] = dl
            dmean[k] = dm[s]
            dvar[k] = dv[s]
    means = {n: np.stack(v) for n, v in means.items()}
    vars_ = {n: np.stack(v) for n, v in vars_.items()}
    msd_w = {n: np.asarray(v) for n, v in msd_w.items()}
    return means, vars_, msd_w, leaf_ids, dur_leaf, dmean, dvar


def align_corpus_with_clustered(model: ClusteredModel, utterances,
                                max_dur: int = 40, device="cuda",
                                max_batch: int = 32):
    """HSMMAlign on the clustered mmf over a corpus of (frames,
    ctx_seq), in padded batches (`hsmm_batch.align_corpus`): each batch
    one K17 launch over the tied model's row tables and one K20 launch.
    Returns per utterance, in order, (loglik, ends (numpy)) or the
    ValueError of a chain longer than its frames."""
    from hts_train_world_tpu_torch.models import hsmm_batch as hb
    dev = device_mod.resolve(device)
    tables, offsets, _ = hb.tables_from_clustered(model)
    names = [st.name for st in model.streams]
    args = hsmm.stream_args(model.streams)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=dev)
    m_t = tuple(t(tables.means[n]) for n in names)
    v_t = tuple(t(tables.vars[n]) for n in names)
    w_t = tuple(t(tables.msd_w[n]) if f else t(np.zeros(1))
                for n, f in zip(names, args[1]))

    def chain(frames, ctx_seq):
        return hb.ChainedUtterance(
            np.asarray(frames, float),
            *hb.chain_rows_clustered(model, ctx_seq, offsets))
    return hb.align_corpus(
        utterances, model.n_states, chain,
        lambda fr, rows: hsmm.batch_frame_loglik(fr, rows, m_t, v_t, w_t,
                                                 *args),
        tables.dur_mean, tables.dur_var, max_dur, dev, max_batch)


def align_with_clustered(model: ClusteredModel, frames, ctx_seq,
                         max_dur: int = 40, device="cuda"):
    """Viterbi state boundaries of one utterance under the TIED model
    (HSMMAlign on the clustered mmf): `align_corpus_with_clustered` on a
    corpus of one.  Returns (loglik, ends (numpy), chain arrays); raises
    ValueError when the chain is longer than the frames."""
    res = align_corpus_with_clustered(model, [(frames, ctx_seq)], max_dur,
                                      device)[0]
    if isinstance(res, ValueError):
        raise res
    return res[0], res[1], _chain_arrays(model, ctx_seq)


def reestimate_clustered(model: ClusteredModel, utterances,
                         n_iters: int = 2, max_dur: int = 40,
                         var_floor_scale: float = 0.01, log=print,
                         device="cuda"):
    """Embedded re-estimation of the TIED model (HERest on the clustered
    mmf, ERST2/ERST4): segmental E-step under the tied chain, M-step per
    tree leaf.  Updates model.trees[*].leaf_params and dur_trees in
    place; returns per-iteration total logliks."""
    device_mod.resolve(device)
    all_frames = np.concatenate([u[0] for u in utterances])
    _, gvar = hsmm.global_stats(all_frames, model.streams)
    floors = {st.name: gvar[st.sl] * var_floor_scale + 1e-8
              for st in model.streams}
    S = model.n_states
    history = []
    for it in range(n_iters):
        acc = {st.name: {} for st in model.streams}   # (state, leaf) -> mom
        msd_acc = {st.name: {} for st in model.streams if st.msd}
        dur_acc = {}
        total = 0.0
        aligned = align_corpus_with_clustered(model, utterances, max_dur,
                                              device)
        for (frames, ctx_seq), res in zip(utterances, aligned):
            if isinstance(res, ValueError):
                continue
            ll, ends = res
            total += ll
            _, _, _, leaf_ids, dur_leaf, _, _ = _chain_arrays(model, ctx_seq)
            starts = np.concatenate([[0], ends[:-1]])
            for li in range(len(ctx_seq)):
                dvec = (ends[li * S:(li + 1) * S]
                        - starts[li * S:(li + 1) * S]).astype(float)
                da = dur_acc.setdefault(int(dur_leaf[li * S]),
                                        [0.0, np.zeros(S), np.zeros(S)])
                da[0] += 1.0
                da[1] = da[1] + dvec
                da[2] = da[2] + dvec * dvec
                for s in range(S):
                    k = li * S + s
                    seg = frames[starts[k]:ends[k]]
                    for st in model.streams:
                        block = seg[:, st.sl]
                        if st.msd:
                            present = seg[:, st.msd_flag_col] != 0.0
                            ma = msd_acc[st.name].setdefault(
                                (s, leaf_ids[st.name][k]), [0.0, 0.0])
                            ma[0] += float(present.sum())
                            ma[1] += float(len(seg))
                            block = block[present]
                            if not len(block):
                                continue
                        a = acc[st.name].setdefault(
                            (s, leaf_ids[st.name][k]), [0.0, 0.0, 0.0])
                        a[0] += len(block)
                        a[1] = a[1] + block.sum(0)
                        a[2] = a[2] + (block * block).sum(0)
        # M-step
        for st in model.streams:
            for (s, leaf), (n, s1, s2) in acc[st.name].items():
                if n < 1:
                    continue
                mean = s1 / n
                var = np.maximum(s2 / n - mean * mean, floors[st.name])
                model.trees[st.name][s].leaf_params[leaf] = (mean, var)
            if st.msd:
                for (s, leaf), (v, n) in msd_acc[st.name].items():
                    if n > 0:
                        model.msd_weights[st.name][s][leaf] = float(
                            np.clip(v / n, 1e-3, 1 - 1e-3))
        for leaf, (n, d1, d2) in dur_acc.items():
            if n < 1:
                continue
            dm = d1 / n
            dv = np.maximum(d2 / n - dm * dm, 1.0)
            model.dur_tree.leaf_params[leaf] = (dm, dv)
        log(f"tied re-estimation iter {it}: total loglik {total:.1f}")
        history.append(total)
    return history


def clone_full_context(modelset: hsmm.ModelSet, contexts) -> hsmm.ModelSet:
    """MN2FL: one untied model per full context, cloned from its central
    phone's monophone (Training.pl:449-478)."""
    idx = [modelset.index(phone_of(c)) for c in contexts]
    return hsmm.ModelSet(
        list(contexts),
        {n: m[idx].copy() for n, m in modelset.means.items()},
        {n: v[idx].copy() for n, v in modelset.variances.items()},
        {n: w[idx].copy() for n, w in modelset.msd_weights.items()},
        modelset.dur_mean[idx].copy(), modelset.dur_var[idx].copy(),
        modelset.streams)


def clone_from_clustered(model: ClusteredModel, contexts) -> hsmm.ModelSet:
    """UNTIE: untied full-context models initialized from the TIED
    leaves (make_edfile_untie, Training.pl:553-566)."""
    S = model.n_states
    M = len(contexts)
    means, vars_, msd_w = {}, {}, {}
    for st in model.streams:
        D = st.sl.stop - st.sl.start
        means[st.name] = np.zeros((M, S, D))
        vars_[st.name] = np.ones((M, S, D))
        if st.msd:
            msd_w[st.name] = np.full((M, S), 0.5)
    dur_mean = np.zeros((M, S))
    dur_var = np.ones((M, S))
    for mi, ctx in enumerate(contexts):
        dm, dv = model.durations(ctx)
        dur_mean[mi] = dm
        dur_var[mi] = dv
        for s in range(S):
            params = model.state_params(ctx, s)
            for st in model.streams:
                mean, var, w = params[st.name]
                means[st.name][mi, s] = mean
                vars_[st.name][mi, s] = var
                if st.msd:
                    msd_w[st.name][mi, s] = w
    return hsmm.ModelSet(list(contexts), means, vars_, msd_w,
                         dur_mean, dur_var, model.streams)


def collect_context_stats_soft(full_ms: hsmm.ModelSet, utterances,
                               max_dur: int = 40, n_reest: int = 1,
                               var_floor_scale: float = 0.01,
                               max_batch: int = 32, log=lambda m: None,
                               device="cuda"):
    """Reference-true CXCL statistics flow (Training.pl:480-494): HERest
    re-estimates the UNTIED full-context models (ERST1), then the
    clustering statistics are that model's own soft occupancy counts
    (HERest -s) — not monophone-alignment hard counts.

    full_ms: the untied full-context set (clone_full_context for CXCL1,
    clone_from_clustered for the UNTIE->CXCL2 round).  Runs on the
    batched E-step (K17-K19 on the card)."""
    from hts_train_world_tpu_torch.models import hsmm_batch
    device_mod.resolve(device)
    if n_reest > 0:
        hsmm_batch.reestimate_modelset_batched(
            full_ms, utterances, n_iters=n_reest,
            var_floor_scale=var_floor_scale, max_dur=max_dur,
            max_batch=max_batch, log=log, device=device)
    # final soft E-step -> per-(context, state) sufficient statistics
    tables = hsmm_batch.tables_from_modelset(full_ms)
    chained = []
    for f, seq in utterances:
        r = hsmm_batch.chain_rows_modelset(full_ms, seq)
        chained.append(hsmm_batch.ChainedUtterance(
            np.asarray(f, float),
            {st.name: r for st in full_ms.streams}, r))
    M, S = full_ms.dur_mean.shape
    n_rows = {st.name: M * S for st in full_ms.streams}
    acc = hsmm_batch.corpus_estep(tables, chained, n_rows, M * S, max_dur,
                                  max_batch=max_batch, device=device)
    stream_stats = {st.name: [dict() for _ in range(S)]
                    for st in full_ms.streams}
    msd_stats = {st.name: [dict() for _ in range(S)]
                 for st in full_ms.streams if st.msd}
    dur_stats: Dict[str, clustering.SuffStats] = {}
    for mi, ctx in enumerate(full_ms.names):
        rows = slice(mi * S, (mi + 1) * S)
        mass = acc.dur[rows, 0]
        if mass.max() > 1e-8:
            dur_stats[ctx] = clustering.SuffStats(
                float(mass[0]), acc.dur[rows, 1].copy(),
                acc.dur[rows, 2].copy())
        for s in range(S):
            r = mi * S + s
            for si, st in enumerate(full_ms.streams):
                a = acc.streams[si]
                if st.msd and a["p_tot"][r] > 1e-8:
                    msd_stats[st.name][s][ctx] = clustering.SuffStats(
                        float(a["p_tot"][r]), np.array([a["p_occ"][r]]),
                        np.array([a["p_occ"][r]]))
                if a["occ"][r] > 1e-8:
                    stream_stats[st.name][s][ctx] = clustering.SuffStats(
                        float(a["occ"][r]), a["x"][r].copy(),
                        a["x2"][r].copy())
    return stream_stats, msd_stats, dur_stats


def collect_context_stats_tied(model: ClusteredModel, utterances,
                               max_dur: int = 40, device="cuda"):
    """UNTIE + stats: per-(context, state) statistics under alignments
    from the TIED model — the input to the second clustering round
    (CXCL2, Training.pl:553-577)."""
    S = model.n_states
    stream_stats = {st.name: [dict() for _ in range(S)]
                    for st in model.streams}
    msd_stats = {st.name: [dict() for _ in range(S)]
                 for st in model.streams if st.msd}
    dur_stats: Dict[str, clustering.SuffStats] = {}
    aligned = align_corpus_with_clustered(model, utterances, max_dur,
                                          device)
    for (frames, ctx_seq), res in zip(utterances, aligned):
        if isinstance(res, ValueError):
            continue
        ends = res[1]
        starts = np.concatenate([[0], ends[:-1]])
        for li, ctx in enumerate(ctx_seq):
            dvec = (ends[li * S:(li + 1) * S]
                    - starts[li * S:(li + 1) * S]).astype(float)
            ds = clustering.SuffStats(1.0, dvec, dvec * dvec)
            dur_stats[ctx] = (dur_stats[ctx] + ds
                              if ctx in dur_stats else ds)
            for s in range(S):
                k = li * S + s
                seg = frames[starts[k]:ends[k]]
                for st in model.streams:
                    block = seg[:, st.sl]
                    if st.msd:
                        present = seg[:, st.msd_flag_col] != 0.0
                        pres = clustering.SuffStats(
                            float(len(seg)), np.array([present.sum()]),
                            np.array([float(present.sum())]))
                        m = msd_stats[st.name][s]
                        m[ctx] = m[ctx] + pres if ctx in m else pres
                        block = block[present]
                        if not len(block):
                            continue
                    ss = clustering.SuffStats.from_frames(block)
                    d_ = stream_stats[st.name][s]
                    d_[ctx] = d_[ctx] + ss if ctx in d_ else ss
    return stream_stats, msd_stats, dur_stats
