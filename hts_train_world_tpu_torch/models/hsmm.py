"""MSD-HSMM acoustic models: observation log-likelihoods (K17), the
segmental forward-backward (K18), HSMMAlign's Viterbi (K20) and the
per-utterance embedded re-estimation, in float64 on the card or the CPU.

Counterpart of `hts_train_world_tpu/models/hsmm.py` (the HCompV / HInit /
HERest / HSMMAlign stages, Training.pl:264-741).  Left-to-right, no-skip
hidden semi-Markov chains, one model per label, `n_states` per model; per
stream diagonal Gaussians over the windowed cmp blocks, MSD streams with a
voiced-space weight (unvoiced frames score log(1-w)), and a Gaussian
duration model per state.

The model set lives in host numpy (`ModelSet`, `init_modelset`, the M-steps
are literal copies of the JAX package's); the E-step runs in torch:

- `batch_frame_loglik` (K17, csrc/hsmm_loglik.cu): (B, T, K) gathered MSD
  diagonal-Gaussian log-likelihoods; `frame_loglik` is one utterance of it;
- `segment_fb` (K18, csrc/hsmm_fb.cu): the padded segmental forward-backward
  with occupancies and duration statistics; `forward_backward_segment` is
  one utterance of it;
- `viterbi_segment_batch` (K20, csrc/hsmm_viterbi.cu): HSMMAlign's padded
  segmental Viterbi with the backtrack; `viterbi_segment` is one utterance
  of it.

Everything here is float64: segment sums are differences of a T-long
prefix sum of per-frame log-likelihoods of order 1e2-1e3 at D = 237, which
float32 cancels to ~0.1 nat.  On a CUDA tensor each kernel wrapper launches
its kernel (or raises); on a CPU tensor it runs the plain twin beside it.
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

LOG_2PI = float(np.log(2.0 * np.pi))
LOG_ZERO = -1.0e10
# K20's per-utterance rows (3 (T+1) + max_dur doubles) and K18's rows a
# block stay in shared memory up to this many bytes, in device memory past
# it
ROWS_SHARED_BYTES = 200 * 1024


def _rows_scratch(B: int, T: int, max_dur: int, dev):
    """(the kernels' `rows` pointer, the tensor that holds it): 0 when the
    rows fit the shared-memory budget, else B device rows."""
    n = 3 * (T + 1) + max_dur
    if 8 * n <= ROWS_SHARED_BYTES:
        return 0, None
    t = torch.empty(B * n, dtype=torch.float64, device=dev)
    return t.data_ptr(), t


@dataclasses.dataclass(frozen=True)
class StreamDef:
    name: str
    sl: slice            # columns in the cmp frame
    msd: bool = False
    msd_flag_col: int = -1   # column whose !=0 decides "present" (static)
    weight: float = 1.0      # stream weight (Config.pm.in:123-127)


def world_streams(layout=None) -> Tuple[StreamDef, ...]:
    """The WORLD cmp layout: mgc 150 | lf0 6 | bap 75 | vib 6 with
    stream weights mgc/lf0/vib=1, bap=0 (Config.pm.in:123-127)."""
    from hts_train_world_tpu_torch.features.compose import StreamLayout
    lay = layout or StreamLayout()
    w = lay.n_win
    o = 0
    out = []
    for name, dim, msd, wt in (("mgc", lay.mgc_dim, False, 1.0),
                               ("lf0", lay.lf0_dim, True, 1.0),
                               ("bap", lay.bap_dim, False, 0.0),
                               ("vib", lay.vib_dim, True, 1.0)):
        out.append(StreamDef(name, slice(o, o + w * dim), msd, o, wt))
        o += w * dim
    return tuple(out)


@dataclasses.dataclass
class ModelSet:
    """Parameters for all models, stacked: (n_models, n_states, ...)."""
    names: List[str]
    means: Dict[str, np.ndarray]      # per stream: (M, S, D)
    variances: Dict[str, np.ndarray]  # per stream: (M, S, D)
    msd_weights: Dict[str, np.ndarray]  # msd streams: (M, S)
    dur_mean: np.ndarray              # (M, S)
    dur_var: np.ndarray               # (M, S)
    streams: Tuple[StreamDef, ...]

    @property
    def n_states(self) -> int:
        return self.dur_mean.shape[1]

    def index(self, name: str) -> int:
        return self.names.index(name)

    def to_numpy(self):
        """(names, means, variances, msd_weights, dur_mean, dur_var,
        streams) with copied arrays and each stream as a plain
        (name, start, stop, msd, msd_flag_col, weight) tuple:
        `modelset_from_numpy`'s arguments."""
        return (list(self.names),
                {k: v.copy() for k, v in self.means.items()},
                {k: v.copy() for k, v in self.variances.items()},
                {k: v.copy() for k, v in self.msd_weights.items()},
                self.dur_mean.copy(), self.dur_var.copy(),
                tuple((st.name, st.sl.start, st.sl.stop, st.msd,
                       st.msd_flag_col, st.weight) for st in self.streams))


def modelset_from_numpy(names, means, variances, msd_weights, dur_mean,
                        dur_var, streams) -> ModelSet:
    """A ModelSet from plain arrays (copied to float64) and streams given as
    (name, start, stop, msd, msd_flag_col, weight) tuples."""
    def f64(d):
        return {k: np.array(v, dtype=np.float64) for k, v in d.items()}
    sts = tuple(StreamDef(str(n), slice(int(a), int(b)), bool(m), int(c),
                          float(w)) for n, a, b, m, c, w in streams)
    return ModelSet(list(names), f64(means), f64(variances),
                    f64(msd_weights), np.array(dur_mean, dtype=np.float64),
                    np.array(dur_var, dtype=np.float64), sts)


def global_stats(frames: np.ndarray, streams: Sequence[StreamDef]):
    """HCompV equivalent: global mean/variance (-> variance floors)."""
    mean = frames.mean(0)
    var = frames.var(0)
    return mean, var


def init_modelset(names: Sequence[str], frames_by_model, streams,
                  n_states: int = 5, var_floor_scale: float = 0.01):
    """HInit-style init: uniform segmentation of every occurrence, then
    per-state moments.  frames_by_model: {name: list of (T_i, D) arrays
    (one per occurrence)}."""
    all_frames = np.concatenate([f for fl in frames_by_model.values()
                                 for f in fl])
    gmean, gvar = global_stats(all_frames, streams)
    floor = gvar * var_floor_scale + 1e-8

    M = len(names)
    means = {s.name: np.zeros((M, n_states, s.sl.stop - s.sl.start))
             for s in streams}
    variances = {s.name: np.ones((M, n_states, s.sl.stop - s.sl.start))
                 for s in streams}
    msd_weights = {s.name: np.full((M, n_states), 0.5)
                   for s in streams if s.msd}
    dur_mean = np.full((M, n_states), 3.0)
    dur_var = np.full((M, n_states), 10.0)

    for mi, name in enumerate(names):
        occs = frames_by_model.get(name, [])
        per_state = [[] for _ in range(n_states)]
        for f in occs:
            T = len(f)
            bounds = np.linspace(0, T, n_states + 1).astype(int)
            for s in range(n_states):
                per_state[s].append(f[bounds[s]:bounds[s + 1]])
        for s in range(n_states):
            seg = (np.concatenate(per_state[s])
                   if per_state[s] and sum(len(p) for p in per_state[s])
                   else all_frames)
            durs = [max(1, len(p)) for p in per_state[s]] or [3]
            dur_mean[mi, s] = float(np.mean(durs))
            dur_var[mi, s] = float(np.var(durs)) + 1.0
            for st in streams:
                block = seg[:, st.sl]
                if st.msd:
                    present = seg[:, st.msd_flag_col] != 0.0
                    msd_weights[st.name][mi, s] = \
                        float(present.mean()) if len(present) else 0.5
                    block = block[present] if present.any() else block
                mu = block.mean(0) if len(block) else gmean[st.sl]
                va = block.var(0) if len(block) > 1 else gvar[st.sl]
                means[st.name][mi, s] = mu
                variances[st.name][mi, s] = np.maximum(va, floor[st.sl])
    return ModelSet(list(names), means, variances, msd_weights,
                    dur_mean, dur_var, tuple(streams))


def stream_args(streams: Sequence[StreamDef]):
    """The static (slices, msd flags, weights) `frame_loglik` takes."""
    return (tuple((st.sl.start, st.sl.stop) for st in streams),
            tuple(st.msd for st in streams),
            tuple(st.weight for st in streams))


# ---------------------------------------------------------------------------
# observation log-likelihood: K17
# ---------------------------------------------------------------------------


def _gauss_ll(x, mu, var):
    """Diag-Gaussian log density: x (T, D) vs mu/var (S, D) -> (T, S)."""
    d2 = (x[:, None, :] - mu[None]) ** 2 / var[None]
    return -0.5 * (torch.sum(d2, -1)
                   + torch.sum(torch.log(var), -1)[None]
                   + x.shape[-1] * LOG_2PI)


def batch_frame_loglik_plain(frames, rows, means, variances, msd_w,
                             stream_slices, msd_flags, weights_static):
    """The plain twin of K17, one utterance at a time as the JAX package's
    vmap of `frame_loglik` over gathered rows.  Every stream is scored, the
    weight-0 bap too (`total + 0.0 * ll`: unchanged for a finite ll, NaN
    for a non-finite one, as in the JAX package)."""
    B, Tb, _ = frames.shape
    Kb = rows[0].shape[1]
    out = torch.empty((B, Tb, Kb), dtype=frames.dtype, device=frames.device)
    for b in range(B):
        x_all = frames[b]
        total = 0.0
        for i, ((a, e), is_msd, wt) in enumerate(
                zip(stream_slices, msd_flags, weights_static)):
            r = rows[i][b]
            ll = _gauss_ll(x_all[:, a:e], means[i][r], variances[i][r])
            if is_msd:
                present = (x_all[:, a] != 0.0)[:, None]
                w = torch.clamp(msd_w[i][r], 1e-4, 1.0 - 1e-4)[None]
                ll = torch.where(present, torch.log(w) + ll, torch.log1p(-w))
            total = total + wt * ll
        out[b] = total
    return out


def loglik_rows_plain(means, variances, msd_w, msd_flags):
    """The plain twin of K17's row prologue: per stream (1/v (R, D_s),
    sum log v (R,), log w (R,), log1p(-w) (R,)), w clipped to [1e-4,
    1 - 1e-4]; the last two are None for a non-MSD stream.  The kernel
    scores -0.5 ((sum (x - mu)^2 (1/v) + sum log v) + D_s log 2pi) from
    them."""
    out = []
    for m, v, w, f in zip(means, variances, msd_w, msd_flags):
        lw = l1 = None
        if f:
            wc = torch.clamp(w, 1e-4, 1.0 - 1e-4)
            lw, l1 = torch.log(wc), torch.log1p(-wc)
        out.append((1.0 / v, torch.log(v).sum(-1), lw, l1))
    return out


# K17's row tables on the card, per model set: key -> (the tables the key
# names, kept alive so their addresses cannot be reused; the buffer the row
# prologue fills; the launcher's host meta and weights)
_ROW_TABLES: "collections.OrderedDict" = collections.OrderedDict()
_ROW_TABLES_KEPT = 4


def table_cache_lookup(cache, tabs_in, stream_slices, msd_flags,
                       weights_static):
    """(key, hit) of a row-table cache (K17's `_ROW_TABLES`, K33's): the
    key is the tables' addresses, versions, shapes and strides and the
    stream arguments, so an in-place change of a table bumps its version
    and misses; hit is the cached tuple after the tables, or None."""
    key = (tuple((t.data_ptr(), t._version, tuple(t.shape), t.stride())
                 for t in tabs_in),
           tuple(map(tuple, stream_slices)), tuple(map(bool, msd_flags)),
           tuple(map(float, weights_static)))
    hit = cache.get(key)
    if hit is None:
        return key, None
    cache.move_to_end(key)
    return key, hit[1:]


def table_cache_store(cache, entry, value, kept: int = _ROW_TABLES_KEPT):
    """File `value` (a tuple) under a miss's `entry` (key, tables) once its
    launch succeeded; the least recently used past `kept` go."""
    key, tabs_in = entry
    cache[key] = (tabs_in, *value)
    while len(cache) > kept:
        cache.popitem(last=False)


def _row_tables(means, variances, msd_w, stream_slices, msd_flags,
                weights_static):
    """(buffer, meta, weights, entry): K17's tables for this model set,
    cached on the tables' addresses, versions and shapes and the stream
    arguments; entry is None on a hit.  On a miss a new buffer holds the
    means, the variances and the MSD weights, the launch runs the row
    prologue over it first, and `entry` (key, tables) goes into the cache
    once the launch succeeds.  An in-place change of a table bumps its
    version and misses."""
    tabs_in = (*means, *variances, *msd_w)
    key, hit = table_cache_lookup(_ROW_TABLES, tabs_in, stream_slices,
                                  msd_flags, weights_static)
    if hit is not None:
        return (*hit, None)
    sizes = [(m.numel(), m.shape[0]) for m in means]
    buf = torch.empty(sum(2 * n + 3 * r for n, r in sizes),
                      dtype=torch.float64, device=means[0].device)
    meta, at = [], 0
    for (a, e), m, v, w, f in zip(stream_slices, means, variances, msd_w,
                                  msd_flags):
        n, r = m.numel(), m.shape[0]
        offs = [at, at + n, at + 2 * n, at + 2 * n + r, at + 2 * n + 2 * r]
        buf[offs[0]:offs[0] + n].copy_(m.reshape(-1))
        buf[offs[1]:offs[1] + n].copy_(v.reshape(-1))
        if f:
            buf[offs[3]:offs[3] + r].copy_(w.reshape(-1))
        meta += [a, e, int(bool(f)), r] + offs
        at += 2 * n + 3 * r
    meta_c = (ctypes.c_longlong * len(meta))(*meta)
    wts_c = (ctypes.c_double * len(weights_static))(
        *map(float, weights_static))
    return buf, meta_c, wts_c, (key, tabs_in)


def batch_frame_loglik(frames, rows, means, variances, msd_w,
                       stream_slices, msd_flags, weights_static):
    """K17: frames (B, Tb, D); per stream i, rows[i] (B, Kb) int64 ids into
    means[i] / variances[i] (R_i, D_i) and msd_w[i] (R_i,) (ignored for a
    non-MSD stream) -> obs_ll (B, Tb, Kb), all float64.  Per (b, t, k):
    the sum over streams of weight * [-0.5 (sum (x-mu)^2/v + sum log v +
    D_i log 2pi)], where an MSD stream scores log w + ll on frames whose
    first column is non-zero and log1p(-w) elsewhere (w clipped to
    [1e-4, 1-1e-4]).  On the card the row prologue (1/v, sum log v, log w,
    log1p(-w)) runs once per model set: its buffer is cached on the
    tables (`_row_tables`)."""
    if not frames.is_cuda:
        return batch_frame_loglik_plain(frames, rows, means, variances, msd_w,
                                        stream_slices, msd_flags,
                                        weights_static)
    n = len(stream_slices)
    B, Tb, D = frames.shape
    Kb = rows[0].shape[1]
    f64 = torch.float64
    if (frames.dtype != f64 or len(rows) != n or len(means) != n
            or len(variances) != n or len(msd_w) != n or n > 8
            or any(r.dtype != torch.long or r.shape != (B, Kb) for r in rows)
            or any(m.dtype != f64 or v.dtype != f64 or m.dim() != 2
                   or m.shape != v.shape or m.shape[1] != e - a
                   for m, v, (a, e) in zip(means, variances, stream_slices))
            or any(f and (w.dtype != f64 or w.shape != (m.shape[0],))
                   for f, w, m in zip(msd_flags, msd_w, means))
            or any(not 0 <= a < e <= D for a, e in stream_slices)):
        raise ValueError("batch_frame_loglik: float64 frames (B, T, D), per "
                         "stream int64 rows (B, K) and float64 tables "
                         "(R, D_s) [+ msd weights (R,)], at most 8 streams")
    dev = frames.device
    frames = frames.contiguous()
    rows_c = [r.contiguous() for r in rows]
    kernels.check_cuda("batch_frame_loglik", frames, *rows_c)
    if any(t.device != dev for t in (*means, *variances, *msd_w)):
        raise ValueError("batch_frame_loglik: the tables must be on the "
                         "frames' device")
    buf, meta, wts, entry = _row_tables(means, variances, msd_w,
                                        stream_slices, msd_flags,
                                        weights_static)
    out = torch.empty((B, Tb, Kb), dtype=f64, device=dev)
    kernels.launch("hsmm_loglik", [
        frames.data_ptr(), B, Tb, D, Kb, n, meta, wts,
        (ctypes.c_void_p * n)(*(r.data_ptr() for r in rows_c)),
        buf.data_ptr(), int(entry is not None), out.data_ptr()],
        dict(frames=frames, rows=tuple(rows), means=tuple(means),
             variances=tuple(variances), msd_w=tuple(msd_w),
             stream_slices=tuple(stream_slices),
             msd_flags=tuple(msd_flags),
             weights_static=tuple(weights_static)))
    if entry is not None:
        table_cache_store(_ROW_TABLES, entry, (buf, meta, wts))
    return out


def frame_loglik(frames, means, variances, msd_w, stream_slices,
                 msd_flags, weights_static):
    """frames (T, D); means/variances: stream-ordered tuples of (S, D_s);
    returns (T, S) total weighted log-likelihood (HTS stream weights).
    One utterance of `batch_frame_loglik` (K17 on the card)."""
    S = means[0].shape[0]
    rows = tuple(torch.arange(S, device=frames.device)[None]
                 for _ in means)
    return batch_frame_loglik(frames[None], rows, means, variances, msd_w,
                              stream_slices, msd_flags, weights_static)[0]


def _dur_ll(d, mean, var):
    """Gaussian duration log-prob of integer d (HTS dur models)."""
    return -0.5 * ((d - mean) ** 2 / var + torch.log(var) + LOG_2PI)


# ---------------------------------------------------------------------------
# segmental Viterbi over composed utterance chains: K20
# ---------------------------------------------------------------------------


def _backtrack(best_d, T: int, S: int):
    """Chain ends from the (S, T+1) argmaxes (d - 1), walking back from T;
    a negative frame wraps once and then clamps, as JAX's indexing does."""
    t_end = T
    ends = []
    for s in range(S - 1, -1, -1):
        i = t_end + T + 1 if t_end < 0 else t_end
        d = int(best_d[s, min(max(i, 0), T)]) + 1
        ends.append(t_end)
        t_end = t_end - d
    return ends[::-1]


def viterbi_segment_batch_plain(obs_ll, dur_mean, dur_var, t_len, k_len,
                                max_dur: int):
    """The plain twin of K20: the JAX package's `viterbi_segment` on each
    utterance's unpadded (t_len, k_len) block.  Ends past k_len are 0."""
    B, _, Kb = obs_ll.shape
    dt, dev = obs_ll.dtype, obs_ll.device
    best_ll = torch.empty(B, dtype=dt, device=dev)
    ends = torch.zeros((B, Kb), dtype=torch.long, device=dev)
    ds = torch.arange(1, max_dur + 1, dtype=dt, device=dev)
    for b in range(B):
        T, S = int(t_len[b]), int(k_len[b])
        obs = obs_ll[b, :T, :S]
        csum = torch.cat([torch.zeros((1, S), dtype=dt, device=dev),
                          torch.cumsum(obs, 0)], 0)           # (T+1, S)
        t = torch.arange(T + 1, device=dev)
        td = t[:, None] - ds.long()[None, :]                  # (T+1, Dmax)
        valid = td >= 0
        tdc = td.clamp(0, T)
        delta = torch.full((T + 1,), LOG_ZERO, dtype=dt, device=dev)
        delta[0] = 0.0
        best_ds = []
        for s in range(S):
            dll = _dur_ll(ds, dur_mean[b, s], dur_var[b, s])
            prev = delta[tdc]
            seg = csum[:, s][:, None] - csum[tdc, s]
            cand = torch.where(valid, prev + dll[None, :] + seg, LOG_ZERO)
            best_ds.append(torch.argmax(cand, dim=1))
            delta = torch.amax(cand, dim=1)
        best_ll[b] = delta[T]
        ends[b, :S] = torch.as_tensor(
            _backtrack(torch.stack(best_ds).cpu().numpy(), T, S))
    return best_ll, ends


def viterbi_segment_batch(obs_ll, dur_mean, dur_var, t_len, k_len,
                          max_dur: int):
    """K20: HSMMAlign's segmental Viterbi over a padded batch.  obs_ll
    (B, Tb, Kb) float64 chain-ordered state log-likelihoods, dur_mean/var
    (B, Kb) float64, t_len/k_len (B,) int64 (1 <= t_len <= Tb, 1 <= k_len
    <= Kb) -> (best_ll (B,) float64, ends (B, Kb) int64), ends[b, s] the
    exclusive end frame of chain state s (0 past k_len).  Left-to-right,
    no skip, every state visited, durations 1..max_dur."""
    if not obs_ll.is_cuda:
        return viterbi_segment_batch_plain(obs_ll, dur_mean, dur_var, t_len,
                                           k_len, max_dur)
    B, T, K = obs_ll.shape
    f64 = torch.float64
    if (obs_ll.dtype != f64 or dur_mean.dtype != f64
            or dur_var.dtype != f64 or dur_mean.shape != (B, K)
            or dur_var.shape != (B, K) or t_len.dtype != torch.long
            or k_len.dtype != torch.long or t_len.shape != (B,)
            or k_len.shape != (B,) or not 1 <= max_dur <= 32767 or T < 1):
        raise ValueError("viterbi_segment_batch: float64 obs_ll (B, T, K) "
                         "and dur mean/var (B, K), int64 t_len/k_len (B,), "
                         "1 <= max_dur <= 32767")
    obs_ll, dur_mean, dur_var, t_len, k_len = (
        x.contiguous() for x in (obs_ll, dur_mean, dur_var, t_len, k_len))
    dev = obs_ll.device
    kernels.check_cuda("viterbi_segment_batch", obs_ll, dur_mean, dur_var,
                       t_len, k_len)
    csum = torch.empty((B, T + 1, K), dtype=f64, device=dev)
    bp = torch.empty((B, K, T + 1), dtype=torch.int16, device=dev)
    best_ll = torch.empty(B, dtype=f64, device=dev)
    ends = torch.empty((B, K), dtype=torch.long, device=dev)
    rows_p, _rows = _rows_scratch(B, T, int(max_dur), dev)
    kernels.launch("hsmm_viterbi", [
        obs_ll.data_ptr(), dur_mean.data_ptr(), dur_var.data_ptr(),
        t_len.data_ptr(), k_len.data_ptr(), B, T, K, int(max_dur),
        csum.data_ptr(), bp.data_ptr(), best_ll.data_ptr(), ends.data_ptr(),
        rows_p],
        dict(obs_ll=obs_ll, dur_mean=dur_mean, dur_var=dur_var, t_len=t_len,
             k_len=k_len, max_dur=int(max_dur)))
    return best_ll, ends


def viterbi_segment(obs_ll, dur_mean, dur_var, max_dur: int = 40):
    """obs_ll: (T, S) state observation log-liks in chain order;
    dur_mean/var: (S,).  Left-to-right, no skip; every state visited.
    Returns (best_ll, end_times (S,)) where end_times[s] is the exclusive
    frame index where state s ends, as tensors on obs_ll's device.  One
    utterance of `viterbi_segment_batch` (K20 on the card)."""
    T, S = obs_ll.shape
    dev = obs_ll.device
    ll, ends = viterbi_segment_batch(
        obs_ll[None], dur_mean[None], dur_var[None],
        torch.tensor([T], device=dev), torch.tensor([S], device=dev),
        max_dur)
    return ll[0], ends[0]


def _tables(modelset: ModelSet, dev):
    """The model set's stream tables as flat (M*S, D_s) float64 rows on
    `dev` (row (mi, s) -> mi*S + s)."""
    M, S = modelset.dur_mean.shape
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=f64, device=dev)
    means = tuple(t(modelset.means[st.name].reshape(M * S, -1))
                  for st in modelset.streams)
    vars_ = tuple(t(modelset.variances[st.name].reshape(M * S, -1))
                  for st in modelset.streams)
    msd_w = tuple(t(modelset.msd_weights[st.name].reshape(M * S)) if st.msd
                  else torch.zeros(M * S, dtype=f64, device=dev)
                  for st in modelset.streams)
    return means, vars_, msd_w


def chain_loglik(modelset: ModelSet, frames: np.ndarray,
                 label_seq: Sequence[str], device="cuda"):
    """Per-frame observation log-likelihoods for the utterance's composed
    state chain: returns (obs_ll (T, n_labels*S), dur_mean, dur_var) as
    float64 tensors on `device`."""
    dev = device_mod.resolve(device)
    S = modelset.n_states
    idxs = np.asarray([modelset.index(n) for n in label_seq])
    r = torch.as_tensor((idxs[:, None] * S + np.arange(S)[None]).reshape(-1),
                        device=dev)
    means, vars_, msd_w = _tables(modelset, dev)
    x = torch.as_tensor(np.asarray(frames), dtype=torch.float64, device=dev)
    obs_ll = batch_frame_loglik(x[None], tuple(r[None] for _ in means),
                                means, vars_, msd_w,
                                *stream_args(modelset.streams))[0]
    dmean = torch.as_tensor(modelset.dur_mean[idxs].reshape(-1),
                            dtype=torch.float64, device=dev)
    dvar = torch.as_tensor(modelset.dur_var[idxs].reshape(-1),
                           dtype=torch.float64, device=dev)
    return obs_ll, dmean, dvar


def align_utterance(modelset: ModelSet, frames: np.ndarray,
                    label_seq: Sequence[str], max_dur: int = 40,
                    device="cuda"):
    """HSMMAlign equivalent: Viterbi state boundaries for the utterance's
    label sequence.  Returns (loglik, state_end_frames (n_labels*S,)).

    Raises ValueError when the utterance is shorter than its composed
    chain (every state needs >=1 frame) — the reference's HSMMAlign
    likewise fails on infeasible utterances rather than emitting
    garbage boundaries (Training.pl:601-618 drops them)."""
    n_chain = len(label_seq) * modelset.n_states
    if len(frames) < n_chain:
        raise ValueError(
            f"utterance has {len(frames)} frames but the label chain needs "
            f">= {n_chain} ({len(label_seq)} labels x {modelset.n_states} "
            f"states); alignment is infeasible")
    obs_ll, dmean, dvar = chain_loglik(modelset, frames, label_seq, device)
    ll, ends = viterbi_segment(obs_ll, dmean, dvar, max_dur)
    return float(ll), ends.cpu().numpy()


# ---------------------------------------------------------------------------
# segmental forward-backward: K18
# ---------------------------------------------------------------------------


def segment_fb_plain(obs_ll, dur_mean, dur_var, max_dur: int, temper,
                     t_len, k_len):
    """The plain twin of K18: the JAX package's `forward_backward_segment`
    over a padded batch, written out with its scatter-max / scatter-add
    forward.  obs_ll (B, T, S), dur_mean/var (B, S), t_len/k_len (B,)
    int64 -> (ll (B,), gamma (B, T, S), dstats (B, S, 3))."""
    B, T, S = obs_ll.shape
    dt, dev = obs_ll.dtype, obs_ll.device
    Dm = max_dur
    NEG = LOG_ZERO
    obs = obs_ll * temper
    csum = torch.cat([torch.zeros((B, 1, S), dtype=dt, device=dev),
                      torch.cumsum(obs, 1)], 1)              # (B, T+1, S)
    ds = torch.arange(1, Dm + 1, dtype=dt, device=dev)
    t = torch.arange(T + 1, device=dev)
    te = t[:, None] + ds.long()[None, :]                     # (T+1, Dm)
    valid = te[None] <= t_len[:, None, None]                 # (B, T+1, Dm)
    tec = te.clamp(0, T)
    flat = tec.reshape(1, -1).expand(B, -1)
    live = (torch.arange(S, device=dev)[None] < k_len[:, None])  # (B, S)

    def seg_term(s):
        dll = _dur_ll(ds[None], dur_mean[:, s, None],
                      dur_var[:, s, None]) * temper            # (B, Dm)
        c = csum[:, :, s]
        seg = c[:, tec] - c[:, :, None]
        return torch.where(valid, dll[:, None, :] + seg, NEG)

    f0 = torch.full((B, T + 1), NEG, dtype=dt, device=dev)
    f0[:, 0] = 0.0
    f, F = f0, []
    for s in range(S):
        cand = torch.where(valid, f[:, :, None] + seg_term(s), NEG)
        mdest = torch.full((B, T + Dm + 2), NEG, dtype=dt, device=dev) \
            .scatter_reduce(1, flat, cand.reshape(B, -1), "amax")
        p = torch.where(valid, torch.exp(
            cand - mdest.gather(1, flat).reshape(B, T + 1, Dm)), 0.0)
        acc = torch.zeros((B, T + Dm + 2), dtype=dt, device=dev) \
            .scatter_add(1, flat, p.reshape(B, -1))
        fn = torch.where(acc > 0, torch.log(acc.clamp(min=1e-300)) + mdest,
                         NEG)[:, :T + 1]
        f = torch.where(live[:, s, None], fn, f)
        F.append(f)

    bS = torch.full((B, T + 1), NEG, dtype=dt, device=dev)
    bS[torch.arange(B, device=dev), t_len] = 0.0
    b, Brev = bS, []
    for s in range(S - 1, -1, -1):
        cand = torch.where(valid, seg_term(s) + b[:, tec], NEG)
        m = torch.amax(cand, 2, keepdim=True)
        lse = torch.log(torch.exp(cand - m).sum(2)) + m[..., 0]
        b = torch.where(live[:, s, None], lse, b)
        Brev.append(b)
    Bst = torch.stack(Brev[::-1], 1)                         # (B, S, T+1)
    logZ = Bst[:, 0, 0]

    Fin = torch.cat([f0[:, None], torch.stack(F, 1)[:, :-1]], 1)
    Bout = torch.cat([Bst[:, 1:], bS[:, None]], 1)
    gamma = torch.zeros((B, T, S), dtype=dt, device=dev)
    dstats = torch.zeros((B, S, 3), dtype=dt, device=dev)
    for s in range(S):
        xi = (Fin[:, s, :, None] + seg_term(s) + Bout[:, s][:, tec]
              - logZ[:, None, None])
        p = torch.where(valid, torch.exp(torch.clamp(xi, max=0.0)), 0.0)
        p = torch.where(live[:, s, None, None], p, 0.0)
        starts = p.sum(2)
        ends = torch.zeros((B, T + Dm + 2), dtype=dt, device=dev) \
            .scatter_add(1, flat, p.reshape(B, -1))
        gamma[:, :, s] = torch.cumsum(starts - ends[:, :T + 1], 1)[:, :T]
        dstats[:, s, 0] = p.sum((1, 2))
        dstats[:, s, 1] = (p * ds).sum((1, 2))
        dstats[:, s, 2] = (p * ds ** 2).sum((1, 2))
    return logZ, gamma, dstats


def segment_fb(obs_ll, dur_mean, dur_var, max_dur: int, temper, t_len,
               k_len):
    """K18: the segmental forward-backward over a padded batch.  obs_ll
    (B, T, S) float64, dur_mean/var (B, S) float64, t_len/k_len (B,) int64
    (the true frame and chain-state counts; 1 <= t_len <= T, 1 <= k_len
    <= S) -> (log evidence (B,), gamma (B, T, S) frame occupancies,
    dstats (B, S, 3) = [segment mass, E[d] mass, E[d^2] mass]).

    As in the JAX package: obs_ll and the duration log-probs are scaled by
    `temper` (DAEM's k); segments may not cross t_len and the backward
    starts there; chain states >= k_len pass both recursions through."""
    if not obs_ll.is_cuda:
        return segment_fb_plain(obs_ll, dur_mean, dur_var, max_dur, temper,
                                t_len, k_len)
    B, T, S = obs_ll.shape
    f64 = torch.float64
    if (obs_ll.dtype != f64 or dur_mean.dtype != f64
            or dur_var.dtype != f64 or dur_mean.shape != (B, S)
            or dur_var.shape != (B, S) or t_len.dtype != torch.long
            or k_len.dtype != torch.long or t_len.shape != (B,)
            or k_len.shape != (B,) or max_dur < 1 or T < 1):
        raise ValueError("segment_fb: float64 obs_ll (B, T, S) and dur "
                         "mean/var (B, S), int64 t_len/k_len (B,), "
                         "max_dur >= 1")
    return _segment_fb_cuda(obs_ll, dur_mean, dur_var, int(max_dur),
                            float(temper), t_len, k_len)


def _segment_fb_cuda(obs_ll, dur_mean, dur_var, max_dur: int, temper: float,
                     t_len, k_len, cluster: int = 0):
    """K18's launch on checked inputs.  `cluster`: the CTAs of each
    utterance's chain clusters (0: the launcher's choice); the results do
    not depend on it, which the card tests hold bit for bit."""
    B, T, S = obs_ll.shape
    f64 = torch.float64
    obs_ll, dur_mean, dur_var, t_len, k_len = (
        x.contiguous() for x in (obs_ll, dur_mean, dur_var, t_len, k_len))
    dev = obs_ll.device
    kernels.check_cuda("segment_fb", obs_ll, dur_mean, dur_var, t_len, k_len)
    csum = torch.empty((B, S, T + 1), dtype=f64, device=dev)
    Fw = torch.empty((B, S + 1, T + 1), dtype=f64, device=dev)
    Bw = torch.empty((B, S + 1, T + 1), dtype=f64, device=dev)
    ll = torch.empty(B, dtype=f64, device=dev)
    gamma = torch.empty((B, T, S), dtype=f64, device=dev)
    dstats = torch.empty((B, S, 3), dtype=f64, device=dev)
    kernels.launch("hsmm_fb", [
        obs_ll.data_ptr(), dur_mean.data_ptr(), dur_var.data_ptr(),
        t_len.data_ptr(), k_len.data_ptr(), B, T, S, max_dur, temper,
        csum.data_ptr(), Fw.data_ptr(), Bw.data_ptr(), ll.data_ptr(),
        gamma.data_ptr(), dstats.data_ptr(), ROWS_SHARED_BYTES,
        int(cluster)],
        dict(obs_ll=obs_ll, dur_mean=dur_mean, dur_var=dur_var,
             max_dur=max_dur, temper=temper, t_len=t_len, k_len=k_len))
    return ll, gamma, dstats


def forward_backward_segment(obs_ll, dur_mean, dur_var, max_dur: int = 40,
                             temper: float = 1.0, t_len=None, k_len=None):
    """Soft-occupancy E-step over one composed left-to-right chain — the
    counterpart of HERest's full Baum-Welch; `temper` is DAEM's k (HERest
    -k).  obs_ll (T, S), dur_mean/var (S,) -> (log_evidence, gamma (T, S),
    dur_stats (S, 3)).  `t_len`/`k_len` are the true frame/state counts of
    a padded input (None: fully valid).  One utterance of `segment_fb`
    (K18 on the card)."""
    T, S = obs_ll.shape
    dev = obs_ll.device
    tl = torch.tensor([T if t_len is None else int(t_len)], device=dev)
    kl = torch.tensor([S if k_len is None else int(k_len)], device=dev)
    ll, gamma, dstats = segment_fb(obs_ll[None], dur_mean[None],
                                   dur_var[None], max_dur, temper, tl, kl)
    return ll[0], gamma[0], dstats[0]


def occupancy_utterance(modelset: ModelSet, frames: np.ndarray,
                        label_seq: Sequence[str], max_dur: int = 40,
                        temper: float = 1.0, device="cuda"):
    """Soft E-step for one utterance: (log_evidence, gamma (T, K),
    dur_stats (K, 3)) over the K = n_labels*S chain states, as numpy."""
    obs_ll, dmean, dvar = chain_loglik(modelset, frames, label_seq, device)
    ll, gamma, dstats = forward_backward_segment(
        obs_ll, dmean, dvar, max_dur, temper)
    return float(ll), gamma.cpu().numpy(), dstats.cpu().numpy()


# ---------------------------------------------------------------------------
# segmental EM (embedded re-estimation)
# ---------------------------------------------------------------------------


def _soft_reestimate_iter(modelset: ModelSet, utterances, floor,
                          max_dur: int, temper: float,
                          device="cuda") -> float:
    """One full-Baum-Welch iteration: soft occupancies from the HSMM
    forward-backward, closed-form M-step on the weighted moments."""
    S = modelset.n_states
    acc: Dict = {}
    total_ll = 0.0
    for frames, label_seq in utterances:
        ll, gamma, dstats = occupancy_utterance(
            modelset, frames, label_seq, max_dur, temper, device)
        if ll <= LOG_ZERO / 2:
            # infeasible chain: the posterior is undefined, so drop the
            # utterance from the counts
            continue
        total_ll += ll
        x2 = frames ** 2
        occ_x = gamma.T @ frames                  # (K, D)
        occ_x2 = gamma.T @ x2
        occ = gamma.sum(0)                        # (K,)
        masked = {}
        for st in modelset.streams:
            if st.msd:
                pm = (frames[:, st.msd_flag_col] != 0.0).astype(float)
                gm = gamma * pm[:, None]
                masked[st.name] = (gm.sum(0), gm.T @ frames[:, st.sl],
                                   gm.T @ x2[:, st.sl])
        for li, name in enumerate(label_seq):
            for s in range(S):
                k = li * S + s
                a = acc.setdefault((name, s), {
                    "occ": 0.0, "x": 0.0, "x2": 0.0, "dur": np.zeros(3)})
                a["occ"] += occ[k]
                a["x"] = a["x"] + occ_x[k]
                a["x2"] = a["x2"] + occ_x2[k]
                a["dur"] += dstats[k]
                for st in modelset.streams:
                    if st.msd:
                        mo, mx, mx2 = masked[st.name]
                        m = a.setdefault(st.name, [0.0, 0.0, 0.0])
                        m[0] += mo[k]
                        m[1] = m[1] + mx[k]
                        m[2] = m[2] + mx2[k]
    for (name, s), a in acc.items():
        mi = modelset.index(name)
        if a["occ"] < 1e-6:
            continue
        mass, ed, ed2 = a["dur"]
        if mass > 1e-6:
            dm = ed / mass
            modelset.dur_mean[mi, s] = dm
            modelset.dur_var[mi, s] = max(ed2 / mass - dm * dm, 0.0) + 1.0
        for st in modelset.streams:
            if st.msd:
                mo, mx, mx2 = a[st.name]
                modelset.msd_weights[st.name][mi, s] = float(
                    np.clip(mo / a["occ"], 1e-3, 1 - 1e-3))
                if mo < 2.0:
                    continue
                mu = mx / mo
                va = mx2 / mo - mu ** 2
            else:
                mu = a["x"][st.sl] / a["occ"]
                va = a["x2"][st.sl] / a["occ"] - mu ** 2
            modelset.means[st.name][mi, s] = mu
            modelset.variances[st.name][mi, s] = np.maximum(
                va, floor[st.sl])
    return total_ll


def embedded_reestimate(modelset: ModelSet, utterances, n_iters: int = 3,
                        var_floor_scale: float = 0.01, max_dur: int = 40,
                        log=print, mode: str = "viterbi",
                        temper: float = 1.0, device="cuda"):
    """HERest-style embedded training.  utterances: list of
    (frames (T, D), label_seq).

    mode="viterbi": segmental EM (hard alignment, HInit/HRest style).
    mode="baum_welch": full soft-occupancy HSMM EM (HERest,
    Training.pl:248-258, 433-440).  temper: DAEM temperature k."""
    device_mod.resolve(device)
    all_frames = np.concatenate([u[0] for u in utterances])
    _, gvar = global_stats(all_frames, modelset.streams)
    floor = gvar * var_floor_scale + 1e-8
    S = modelset.n_states

    if mode == "baum_welch":
        for it in range(n_iters):
            total_ll = _soft_reestimate_iter(
                modelset, utterances, floor, max_dur, temper, device)
            log(f"embedded BW iter {it}: total loglik {total_ll:.1f}")
        return modelset
    if mode != "viterbi":
        raise ValueError(f"unknown mode {mode!r}")

    for it in range(n_iters):
        seg_frames = {}   # (model, state) -> list of frame arrays
        seg_durs = {}
        total_ll = 0.0
        for frames, label_seq in utterances:
            try:
                ll, ends = align_utterance(modelset, frames, label_seq,
                                           max_dur, device)
            except ValueError:
                continue  # unalignable utterance: drop from the counts
            total_ll += ll
            starts = np.concatenate([[0], ends[:-1]])
            for li, name in enumerate(label_seq):
                for s in range(S):
                    k = li * S + s
                    key = (name, s)
                    seg = frames[starts[k]:ends[k]]
                    seg_frames.setdefault(key, []).append(seg)
                    seg_durs.setdefault(key, []).append(ends[k] - starts[k])
        # M-step
        for mi, name in enumerate(modelset.names):
            for s in range(S):
                segs = seg_frames.get((name, s))
                if not segs:
                    continue
                seg = np.concatenate(segs)
                if not len(seg):
                    continue
                durs = np.asarray(seg_durs[(name, s)], float)
                modelset.dur_mean[mi, s] = durs.mean()
                modelset.dur_var[mi, s] = durs.var() + 1.0
                for st in modelset.streams:
                    block = seg[:, st.sl]
                    if st.msd:
                        present = seg[:, st.msd_flag_col] != 0.0
                        modelset.msd_weights[st.name][mi, s] = float(
                            np.clip(present.mean(), 1e-3, 1 - 1e-3))
                        if present.sum() < 2:
                            continue
                        block = block[present]
                    modelset.means[st.name][mi, s] = block.mean(0)
                    modelset.variances[st.name][mi, s] = np.maximum(
                        block.var(0), floor[st.sl])
        log(f"embedded EM iter {it}: total loglik {total_ll:.1f}")
    return modelset


def daem_reestimate(modelset: ModelSet, utterances, n_outer: int = 10,
                    n_inner: int = 1, alpha: float = 1.0,
                    var_floor_scale: float = 0.01, max_dur: int = 40,
                    log=print, batched: bool = False, device="cuda"):
    """DAEM-annealed embedded training (Training.pl:421-431; DAEMNITER=10,
    DAEMALPHA=1.0): outer iteration i runs n_inner Baum-Welch sweeps at
    temperature k = (i / n_outer)**alpha — HERest's `-k` flag.

    batched=True runs each sweep on the batched corpus E-step
    (models/hsmm_batch)."""
    device_mod.resolve(device)
    for i in range(1, n_outer + 1):
        k = (i / n_outer) ** alpha
        log(f"DAEM outer {i}/{n_outer}: temperature k={k:.4f}")
        if batched:
            from hts_train_world_tpu_torch.models import hsmm_batch
            hsmm_batch.reestimate_modelset_batched(
                modelset, utterances, n_iters=n_inner,
                var_floor_scale=var_floor_scale, max_dur=max_dur,
                temper=k, log=log, device=device)
        else:
            embedded_reestimate(modelset, utterances, n_iters=n_inner,
                                var_floor_scale=var_floor_scale,
                                max_dur=max_dur, log=log,
                                mode="baum_welch", temper=k, device=device)
    return modelset


# ---------------------------------------------------------------------------
# parameter generation (HMGenS equivalent)
# ---------------------------------------------------------------------------


def generate_from_models(modelset: ModelSet, label_seq: Sequence[str],
                         speaking_rate: float = 1.0):
    """HMGenS pgtype-0 equivalent over monophones: state durations from the
    duration Gaussians (round(mean * rate), >= 1; np.round, half to even),
    then frame-level means/variances per stream ready for MLPG, the frame
    V/UV (lf0 weight > 0.5) and the durations, as host numpy."""
    S = modelset.n_states
    durs = []
    for name in label_seq:
        mi = modelset.index(name)
        d = np.maximum(1, np.round(
            modelset.dur_mean[mi] * speaking_rate)).astype(int)
        durs.append(d)
    durs = np.concatenate(durs)
    means = {st.name: [] for st in modelset.streams}
    vars_ = {st.name: [] for st in modelset.streams}
    vuv = []
    k = 0
    for name in label_seq:
        mi = modelset.index(name)
        for s in range(S):
            d = durs[k]
            k += 1
            for st in modelset.streams:
                means[st.name].append(
                    np.repeat(modelset.means[st.name][mi, s][None], d, 0))
                vars_[st.name].append(
                    np.repeat(modelset.variances[st.name][mi, s][None],
                              d, 0))
            w = (modelset.msd_weights["lf0"][mi, s]
                 if "lf0" in modelset.msd_weights else 1.0)
            vuv.append(np.full(d, w > 0.5))
    return ({k: np.concatenate(v) for k, v in means.items()},
            {k: np.concatenate(v) for k, v in vars_.items()},
            np.concatenate(vuv), durs)
