#!/usr/bin/env python3
"""Time the batched HSMM E-step, its K18 forward-backward and its K19
segment sums on one GPU.

Loads `hts_train_world_tpu_torch` from `--root` (default: this checkout),
so that two trees of the port can be timed in one call on the same card,
and runs the soft E-step (`models.hsmm_batch.corpus_estep`, max_dur 60,
max_batch 32) on two corpora made from chip_smoke.py's seeds:

- `hsmm_200`: the HSMM lane, 128 utterances over 40 models x 5 states,
  so 200 rows per table;
- `untied_1485`: the recipe lane's 128 utterances over their 297 full
  contexts, untied, 5 states each, so 1485 rows per table: the tables of
  the recipe's CXCL and CXCL2 E-steps.

For each: one warm E-step, then `--reps` E-steps each timed on the host
clock to a synchronize; one E-step with CUDA events between its stages
(pad + upload, gather + K17, duration gather + K18, bmm moments, K19);
and one under `torch.profiler` for the device time of each kernel (K19's
launches alone, without the host's share of their spans).  K18's
launches of an E-step are replayed from their recorded inputs: their
sum under CUDA events (each launch timed alone, after a warm one) and
under the profiler.  The HSMM lane's E-step runs again at DAEM's temper
0.3, and K18 once more on chip_smoke.py's 9000-frame utterance (K 200)
with its time.  Each E-step (and the long utterance) gets a sha256 of
every K18 output (ll, gamma, dstats of each batch in order), so that two
trees' K18 compare bit for bit.  Prints one JSON line with the card's
name and power limit.

    python3 estep_timing.py [--root DIR] [--reps N]
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """chip_smoke.py of this checkout, for its corpus builders (they take
    the package's hsmm module as an argument)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def untied_set(hsmm, cs):
    """The recipe lane's corpus with one model per full context, from a
    uniform per-label split: (model set, corpus of context sequences)."""
    utts, _ = cs.recipe_corpus(hsmm)
    ctxs = sorted({c for _, seq in utts for c in seq})
    fbm = {c: [] for c in ctxs}
    for fr, seq in utts:
        ends = np.linspace(0, len(fr), len(seq) + 1)[1:].astype(int)
        starts = np.concatenate([[0], ends[:-1]])
        for i, c in enumerate(seq):
            fbm[c].append(fr[starts[i]:ends[i]])
    ms = hsmm.init_modelset(ctxs, fbm, hsmm.world_streams(),
                            n_states=cs.HSMM_STATES)
    return ms, utts


# K18's kernels by name (the stages of this tree and the one kernel of
# earlier trees), K17's and K19's
KINDS = (("hsmm_loglik", "hsmm_loglik"), ("hsmm_fb", "hsmm_fb"),
         ("hsmm_csum", "hsmm_fb"), ("hsmm_chain", "hsmm_fb"),
         ("hsmm_post", "hsmm_fb"), ("hsmm_accumulate", "hsmm_accumulate"))


def device_by_kernel(torch, prof):
    """{kind: [device ms, launches]} of a profile, and K18's by kernel."""
    device, k18 = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        kind = next((k for s, k in KINDS if s in e.key), "other")
        ms_n = device.setdefault(kind, [0.0, 0])
        ms_n[0] += us / 1e3
        ms_n[1] += e.count
        if kind == "hsmm_fb":
            name = next(s for s, _ in KINDS if s in e.key)
            k18[name] = k18.get(name, 0.0) + us / 1e3
    return device, k18


class Digest:
    """Wraps `hsmm.segment_fb` while on: the sha256 of every output's
    bytes, in launch order."""

    def __init__(self, hsmm):
        self.hsmm, self.fn, self.h = hsmm, hsmm.segment_fb, None

    def __enter__(self):
        self.h = hashlib.sha256()

        def hooked(*a, **kw):
            out = self.fn(*a, **kw)
            for t in out:
                self.h.update(t.detach().cpu().contiguous().numpy()
                              .tobytes())
            return out
        self.hsmm.segment_fb = hooked
        return self

    def __exit__(self, *exc):
        self.hsmm.segment_fb = self.fn

    def hex(self):
        return self.h.hexdigest()[:16]


def k18_replays(torch, kernels, hsmm, launches):
    """K18's recorded launches again: the sum of each one's time under
    CUDA events (after a warm call), and the device sum under the
    profiler."""
    total = 0.0
    for inp in launches:
        hsmm.segment_fb(**inp)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        hsmm.segment_fb(**inp)
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for inp in launches:
            hsmm.segment_fb(**inp)
        torch.cuda.synchronize()
    device, k18 = device_by_kernel(torch, prof)
    return {"launches": len(launches), "events_ms": total,
            "profiler_ms": device.get("hsmm_fb", [0.0, 0])[0],
            "profiler_ms_by_kernel": k18}


def time_estep(torch, hb, hsmm, kernels, ms, utts, reps: int, max_dur: int,
               temper: float = 1.0, timed: bool = True):
    chained, _ = hb.chain_modelset(ms, utts)
    tables = hb.tables_from_modelset(ms)
    M, S = ms.dur_mean.shape
    n_rows = {st.name: M * S for st in ms.streams}

    def estep():
        return hb.corpus_estep(tables, chained, n_rows, M * S, max_dur,
                               temper=temper, max_batch=32)
    with Digest(hsmm) as dg:
        res = estep()                                          # warm
        torch.cuda.synchronize()
    out = {"rows": M * S, "utterances": len(utts), "temper": temper,
           "frames": int(sum(len(f) for f, _ in utts)),
           "k18_digest": dg.hex(), "total_ll": res.total_ll}
    kernels.record = []
    estep()
    torch.cuda.synchronize()
    rec, kernels.record = kernels.record, None
    out["k18"] = k18_replays(torch, kernels, hsmm,
                             [i for n, i in rec if n == "hsmm_fb"])
    if not timed:
        return out
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = estep()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    kernels.reset_counts()
    prev = torch.cuda.Event(enable_timing=True)
    prev.record()
    marks = []
    for stage, _ in hb.corpus_estep_stages(tables, chained, n_rows, M * S,
                                           max_dur, temper=temper,
                                           max_batch=32):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((stage, e))
    torch.cuda.synchronize()
    spans = {}
    for stage, e in marks:
        spans[stage] = spans.get(stage, 0.0) + prev.elapsed_time(e)
        prev = e
    k19_launches = kernels.launches["hsmm_accumulate"]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        estep()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device, k18 = device_by_kernel(torch, prof)
    busy = sum(v[0] for v in device.values())
    out.update({
        "batches": sum(s == "pad" for s, _ in marks),
        "estep_ms": walls, "estep_ms_min": min(walls),
        "frames_per_s": out["frames"] / (1e-3 * min(walls)),
        "spans_ms": spans, "device_ms_launches": device,
        "k18_device_ms_by_kernel": k18,
        "profiled_wall_ms": wall, "busy_ms": busy,
        "idle_share": 1.0 - busy / wall, "k19_launches": k19_launches})
    return out


def long_utterance(torch, hsmm, cs, reps: int = 3):
    """K18 on chip_smoke.py's 9000-frame, 200-state utterance: the digest
    of its outputs and its time under CUDA events (fastest of `reps`)."""
    inp = cs.k18_long_inputs("cuda")
    with Digest(hsmm) as dg:
        hsmm.segment_fb(**inp, temper=1.0)
        torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        hsmm.segment_fb(**inp, temper=1.0)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return {"k18_digest": dg.hex(), "events_ms": ms, "min_ms": min(ms)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("estep_timing: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from hts_train_world_tpu_torch import kernels
    from hts_train_world_tpu_torch.models import hsmm
    from hts_train_world_tpu_torch.models import hsmm_batch as hb
    if not os.path.abspath(kernels.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package did not load from {root}")
    cs = _chip_smoke()
    kernels.build()
    out = {"root": os.path.relpath(root, HERE)}
    ms, utts = cs.hsmm_corpus(hsmm)
    out["hsmm_200"] = time_estep(torch, hb, hsmm, kernels, ms, utts,
                                 args.reps, cs.HSMM_MAX_DUR)
    out["hsmm_200_t03"] = time_estep(torch, hb, hsmm, kernels, ms, utts,
                                     args.reps, cs.HSMM_MAX_DUR, temper=0.3,
                                     timed=False)
    ms, utts = untied_set(hsmm, cs)
    out["untied_1485"] = time_estep(torch, hb, hsmm, kernels, ms, utts,
                                    args.reps, cs.HSMM_MAX_DUR)
    out["long_9000"] = long_utterance(torch, hsmm, cs)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
