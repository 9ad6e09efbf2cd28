"""Harvest's contour stack, batched over utterances: kernel K16
(csrc/harvest_contour.cu) and its plain twin.

Counterpart of `hts_train_world_tpu/ops/harvest_fix.py` (harvest.cpp):

- RemoveUnreliableCandidates (:652-688): kill a candidate whose best
  relative match against every candidate of a neighbour frame exceeds 5 %;
- FixF0Contour (:693-1044): SearchF0Base, FixStep1 (jumps), FixStep2 (short
  runs), FixStep3 (Extend, ExtendSub, MakeSortedOrder, MergeF0), FixStep4
  (short gaps filled linearly);
- SmoothF0Contour (:1049-1113): each section's held-edge channel over a
  300-frame apron, through the zero-lag 2nd-order Butterworth twice.

The twin follows the JAX package's vectorised formulation (masked scans
over a capped section axis) and runs in the input's dtype, except that
ExtendSub's section sums and running mean, MergeF0's score sums and the
Butterworth run in float64 (the reference C's doubles), as K16 does.
The reference's quirks are kept: ExtendSub's mean is never reset, the
insertion sort compares the current order[i], MergeF0's base is slot 0,
boundary lists hold [start, end-1].
"""
from __future__ import annotations

import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import prims

BUTTER_B = (0.0078202080334971724, 0.015640416066994345)
BUTTER_A = (1.7347257688092754, -0.76600660094326412)
SMOOTH_LAG = 300
STEP3_RANGE = 0.18
THREADS_K16 = 256


# ---------------------------------------------------------------------------
# sections of a voicing mask (GetBoundaryList, harvest.cpp:727-743)
# ---------------------------------------------------------------------------


def forced_voicing(f0):
    """f0 > 0 with the first and last frame forced unvoiced (last axis)."""
    v = f0 > 0
    v[..., 0] = False
    v[..., -1] = False
    return v


def start_end_masks(v):
    """Run starts and inclusive run ends of a voicing mask (last axis)."""
    vprev = torch.nn.functional.pad(v[..., :-1], (1, 0))
    vnext = torch.nn.functional.pad(v[..., 1:], (0, 1))
    return v & ~vprev, v & ~vnext


def sections(v, cap: int):
    """(starts, inclusive ends) (..., cap) and the section count (...)."""
    st_m, ed_m = start_end_masks(v)
    return (prims.compact_indices(st_m, cap, 0),
            prims.compact_indices(ed_m, cap, 0), st_m.sum(-1))


def step3_section_cap(T: int) -> int:
    """FixStep2 output sections span >= 6 voiced frames + 1 gap."""
    return max((T + 6) // 7 + 1, 2)


def smooth_section_cap(T: int) -> int:
    """Post-FixStep4 gaps are >= 9 frames (shorter ones were filled)."""
    return max((T + 9) // 10 + 2, 2)


# ---------------------------------------------------------------------------
# RemoveUnreliableCandidates, FixStep1/2/4
# ---------------------------------------------------------------------------


def remove_unreliable(cands, scores, chunk: int = 256):
    """harvest.cpp:652-688 on (B, T, NC) fields, all frames judged against
    the input arrays (zeros count as error 1, capped)."""
    T = cands.shape[1]
    zero = torch.zeros((), dtype=cands.dtype, device=cands.device)
    nxt = torch.nn.functional.pad(cands[:, 1:], (0, 0, 0, 1))
    prv = torch.nn.functional.pad(cands[:, :-1], (0, 0, 1, 0))
    safe = torch.where(cands != 0, cands, torch.ones_like(cands))
    errs = []
    for at in range(0, T, chunk):
        c, s = cands[:, at:at + chunk], safe[:, at:at + chunk]
        e1 = ((c[..., None] - nxt[:, at:at + chunk, None, :]).abs()
              / s[..., None]).amin(-1)
        e2 = ((c[..., None] - prv[:, at:at + chunk, None, :]).abs()
              / s[..., None]).amin(-1)
        errs.append(torch.minimum(e1.clamp(max=1.0), e2.clamp(max=1.0)))
    tt = torch.arange(T, device=cands.device)[None, :, None]
    kill = ((cands != 0) & (torch.cat(errs, 1) > 0.05) & (tt >= 1)
            & (tt <= T - 2))
    return torch.where(kill, zero, cands), torch.where(kill, zero, scores)


def search_f0_base(cands, scores):
    """SearchF0Base (harvest.cpp:693-705): the first best score per frame;
    zero when every score is <= 0."""
    j = torch.argmax(scores, dim=-1, keepdim=True)
    best = torch.gather(scores, -1, j)[..., 0]
    f0 = torch.gather(cands, -1, j)[..., 0]
    return torch.where(best > 0, f0, torch.zeros_like(f0))


def fix_step1(base):
    """FixStep1 (harvest.cpp:710-722), allowed range 0.008; a zero divisor
    means the condition holds (inf > 0.008 in the C)."""
    T = base.shape[-1]
    b1 = torch.nn.functional.pad(base[..., :-1], (1, 0))
    b2 = torch.nn.functional.pad(base[..., :-2], (2, 0))
    one = torch.ones_like(base)
    ref = b1 * 2 - b2
    c1 = (ref == 0) | ((base - ref) / torch.where(ref == 0, one, ref)).abs() \
        .gt(0.008)
    c2 = (b1 == 0) | ((base - b1).abs() / torch.where(b1 == 0, one, b1)) \
        .gt(0.008)
    keep = (torch.arange(T, device=base.device) >= 2) & (base != 0) \
        & ~(c1 & c2)
    return torch.where(keep, base, torch.zeros_like(base))


def fix_step2(s1):
    """FixStep2 (harvest.cpp:748-762): zero voiced runs spanning < 7
    frames (end - start < 6 on the inclusive boundary list)."""
    T = s1.shape[-1]
    v = forced_voicing(s1)
    tt = torch.arange(T, device=s1.device).expand(s1.shape)
    st_m, ed_m = start_end_masks(v)
    first = torch.cummax(torch.where(st_m, tt, -1), -1).values
    last = torch.cummin(torch.where(ed_m, tt, T + 1).flip(-1),
                        -1).values.flip(-1)
    return torch.where(v & (last - first < 6), torch.zeros_like(s1), s1)


def fix_step4(s3):
    """FixStep4 (harvest.cpp:1000-1022): linear fill of the gaps between
    sections shorter than 9 frames."""
    T = s3.shape[-1]
    v = forced_voicing(s3)
    tt = torch.arange(T, device=s3.device).expand(s3.shape)
    prev_end = torch.cummax(torch.where(v, tt, -1), -1).values
    next_st = torch.cummin(torch.where(v, tt, T + 1).flip(-1),
                           -1).values.flip(-1)
    dist = next_st - prev_end - 1
    fill = ~v & (prev_end >= 0) & (next_st <= T - 1) & (dist < 9)
    tmp0 = torch.gather(s3, -1, prev_end.clamp(0, T - 1)) + 1.0
    tmp1 = torch.gather(s3, -1, next_st.clamp(0, T - 1)) - 1.0
    coef = (tmp1 - tmp0) / (dist + 1).to(s3.dtype)
    return torch.where(fill, tmp0 + coef * (tt - prev_end).to(s3.dtype), s3)


# ---------------------------------------------------------------------------
# FixStep3: Extend + ExtendSub + MakeSortedOrder + MergeF0
# ---------------------------------------------------------------------------


def select_best_f0(ref, rows, allowed_range: float):
    """SelectBestF0 (harvest.cpp:636-650) per row: the last candidate of
    least relative error, when that error is <= allowed_range, else 0."""
    e = (ref[..., None] - rows).abs() / ref[..., None]
    m = e.amin(-1, keepdim=True)
    n = rows.shape[-1]
    jstar = (n - 1) - torch.argmin(e.flip(-1), dim=-1, keepdim=True)
    best = torch.gather(rows, -1, jstar)
    return torch.where(m <= allowed_range, best,
                       torch.zeros_like(best))[..., 0]


def _extend(multi, origin, last, sign: int, cands, active):
    """ExtendF0 (harvest.cpp:791-820) on every section channel at once,
    a 101-step masked scan: multi (B, S, T), origin / last / active
    (B, S), cands (B, T, NC).  Writes origin+sign .. last+sign, stops after
    4 consecutive failed selections; returns the new boundaries."""
    T, NC = cands.shape[1], cands.shape[2]
    span = (last - origin).abs()
    tmp = torch.gather(multi, 2, origin.clamp(0, T - 1)[..., None])[..., 0]
    tmp = tmp.clamp(min=1e-30)
    count = torch.zeros_like(origin)
    shifted = origin.clone()
    done = ~active
    for i in range(101):
        act = active & ~done & (i <= span)
        idx = origin + sign * (i + 1)
        idxc = idx.clamp(0, T - 1)
        rows = torch.gather(cands, 1, idxc.reshape(idxc.shape[0], -1, 1)
                            .expand(-1, -1, NC)).reshape(idxc.shape + (NC,))
        best = select_best_f0(tmp, rows, STEP3_RANGE)
        cur = torch.gather(multi, 2, idxc[..., None])[..., 0]
        multi.scatter_(2, idxc[..., None],
                       torch.where(act, best, cur)[..., None])
        zero = best == 0.0
        count = torch.where(act, torch.where(zero, count + 1, 0), count)
        tmp = torch.where(act & ~zero, best, tmp)
        shifted = torch.where(act & ~zero, idx, shifted)
        done = done | (act & (count == 4))
    return shifted


def sorted_order(starts: list, n_keep: int) -> list:
    """MakeSortedOrder (harvest.cpp:883-896), the literal insertion sort:
    the comparison reads the current order[i], which swaps change."""
    order = list(range(n_keep))
    for i in range(1, n_keep):
        for j in range(i - 1, -1, -1):
            if starts[order[j]] > starts[order[i]]:
                order[i], order[j] = order[j], order[i]
            else:
                break
    return order


def _row_match_score(f0vec, cands, scores):
    """SearchScore (harvest.cpp:901-907) for every frame: the best score
    among the candidates equal to f0vec[t], 0 when none match."""
    eq = cands == f0vec[:, None]
    return torch.where(eq, scores, torch.zeros_like(scores)).amax(-1)


def _merge(multi, st, ed, order, cands, scores):
    """MergeF0 (harvest.cpp:937-963) of one utterance's kept sections in
    sorted order; the base contour is slot 0 (not order[0]) and the loop
    visits order[1..] (harvest.cpp:944-947)."""
    T = multi.shape[1]
    tt = torch.arange(T, device=multi.device)
    merged = multi[0].clone()
    bl0, bl1 = st[0], ed[0]
    for o in order[1:]:
        st2, ed2, ch = st[o], ed[o], multi[o]
        if st2 - bl1 > 0:                          # disjoint: append
            sel = (tt >= st2) & (tt <= ed2)
            merged = torch.where(sel, ch, merged)
            bl0, bl1 = st2, ed2
        elif bl0 <= st2 and bl1 >= ed2:            # contained
            continue
        else:                                      # overlap: by score
            rng = (tt >= st2) & (tt <= bl1)
            sc1 = _row_match_score(merged, cands, scores)[rng].sum(
                dtype=torch.float64)
            sc2 = _row_match_score(ch, cands, scores)[rng].sum(
                dtype=torch.float64)
            lo = bl1 if sc1 > sc2 else st2
            merged = torch.where((tt >= lo) & (tt <= ed2), ch, merged)
            bl1 = ed2
    return merged


def fix_step3(s2, cands, scores, cap: int):
    """FixStep3 (harvest.cpp:968-995) for s2 (B, T)."""
    B, T = s2.shape
    dev = s2.device
    st, ed, n_sec = sections(forced_voicing(s2), cap)
    valid = torch.arange(cap, device=dev)[None, :] < n_sec[:, None]
    tt = torch.arange(T, device=dev)
    in_sec = ((tt >= st[..., None]) & (tt <= ed[..., None])
              & valid[..., None])
    multi = torch.where(in_sec, s2[:, None, :], torch.zeros((), dtype=s2.dtype,
                                                            device=dev))
    # Extend (:861-878): forward from each end, then back from each start
    ed = _extend(multi, ed, (ed + 100).clamp(max=T - 2), 1, cands, valid)
    st = _extend(multi, st, (st - 100).clamp(min=1), -1, cands, valid)
    # ExtendSub (:840-856): the running mean is never reset
    span = (tt >= st[..., None]) & (tt < ed[..., None]) & valid[..., None]
    ssum = torch.where(span, multi, torch.zeros_like(multi)).sum(
        -1, dtype=torch.float64)
    mean = torch.zeros(B, dtype=torch.float64, device=dev)
    keep = torch.zeros((B, cap), dtype=torch.bool, device=dev)
    length = (ed - st).double()
    for i in range(cap):
        act = valid[:, i]
        new = (mean + ssum[:, i]) / length[:, i].clamp(min=1.0)
        mean = torch.where(act, new, mean)
        keep[:, i] = act & (prims.rdiv(2200.0, new) < length[:, i])
    out = s2.clone()
    n_keep = keep.sum(1).tolist()
    for b in range(B):
        if n_keep[b] == 0:
            continue
        sel = torch.nonzero(keep[b])[:, 0]
        stk, edk = st[b, sel].tolist(), ed[b, sel].tolist()
        out[b] = _merge(multi[b, sel], stk, edk, sorted_order(stk, n_keep[b]),
                        cands[b], scores[b])
    return out


def fix_contour_plain(cands, scores, cap: int):
    """FixF0Contour (harvest.cpp:1027-1044) for (B, T, NC) fields."""
    s2 = fix_step2(fix_step1(search_f0_base(cands, scores)))
    return fix_step4(fix_step3(s2, cands, scores, cap))


# ---------------------------------------------------------------------------
# SmoothF0Contour
# ---------------------------------------------------------------------------


def butter_pass(x):
    """FilteringF0's single pass (harvest.cpp:1055-1074) on float64 rows:
    the biquad forward, its output written back to front."""
    return prims.iir_filter_plain(BUTTER_A, (BUTTER_B[0], BUTTER_B[1],
                                             BUTTER_B[0]), x).flip(-1)


def smooth_contour_plain(f0, cap: int):
    """SmoothF0Contour (harvest.cpp:1049-1113) for f0 (B, T): per voiced
    section of the contour padded by 300 zero frames each side, the
    section's channel with held edges over the whole padded length, through
    the Butterworth pass twice (float64), read back on the section."""
    B, T = f0.shape
    L = T + 2 * SMOOTH_LAG
    ext = torch.nn.functional.pad(f0, (SMOOTH_LAG, SMOOTH_LAG))
    st, ed, n_sec = sections(forced_voicing(ext), cap)
    valid = torch.arange(cap, device=f0.device)[None, :] < n_sec[:, None]
    bi, si = torch.nonzero(valid, as_tuple=True)
    if bi.numel() == 0:
        return torch.zeros_like(f0)
    tt = torch.arange(L, device=f0.device)
    s0, e0 = st[bi, si][:, None], ed[bi, si][:, None]
    ch = torch.gather(ext[bi], 1, torch.minimum(torch.maximum(tt, s0), e0))
    sm = butter_pass(butter_pass(ch.double())).to(f0.dtype)
    sm = torch.where((tt >= s0) & (tt <= e0), sm, torch.zeros_like(sm))
    out = torch.zeros((B, L), dtype=f0.dtype, device=f0.device)
    out.index_add_(0, bi, sm)
    return out[:, SMOOTH_LAG:SMOOTH_LAG + T]


def contour_plain(refined, scores):
    """K16's twin: RemoveUnreliable -> FixF0Contour -> SmoothF0Contour of
    (B, T, NC) refined candidates and scores -> f0 (B, T)."""
    T = refined.shape[1]
    c, s = remove_unreliable(refined, scores)
    return smooth_contour_plain(fix_contour_plain(c, s, step3_section_cap(T)),
                                smooth_section_cap(T))


def contour(refined, scores):
    """K16: `contour_plain` in one launch, one block per utterance; f32
    or float64 fields."""
    if not refined.is_cuda:
        return contour_plain(refined, scores)
    B, T, NC = refined.shape
    dt = refined.dtype
    if (dt not in (torch.float32, torch.float64) or scores.dtype != dt
            or scores.shape != refined.shape or T < 3):
        raise ValueError("contour: f32 or f64 refined and scores (B, T >= 3, "
                         "NC) of one dtype")
    f64 = dt == torch.float64
    rc, sc = refined.contiguous(), scores.contiguous()
    kernels.check_cuda("contour", rc, sc)
    dev = rc.device
    cap3, cap_s = step3_section_cap(T), smooth_section_cap(T)
    rows_s = min(THREADS_K16, cap_s)
    runs = T // 2 + 2
    fields = torch.empty((B, 2, T, NC), dtype=dt, device=dev)
    conts = torch.empty((B, 4, T), dtype=dt, device=dev)
    multi = torch.empty((B, cap3, T), dtype=dt, device=dev)
    smooth = torch.empty((B, rows_s, T + 2 * SMOOTH_LAG), dtype=torch.float64,
                         device=dev)
    ints = torch.empty((B, 6, runs), dtype=torch.int32, device=dev)
    sums = torch.empty((B, cap3), dtype=torch.float64, device=dev)
    out = torch.empty((B, T), dtype=dt, device=dev)
    kernels.launch("harvest_contour", [
        rc.data_ptr(), sc.data_ptr(), B, T, NC, cap3, cap_s, rows_s, runs,
        int(f64), fields.data_ptr(), conts.data_ptr(), multi.data_ptr(),
        smooth.data_ptr(), ints.data_ptr(), sums.data_ptr(), out.data_ptr()],
        dict(refined=rc, scores=sc), variant="f64" if f64 else None)
    return out
