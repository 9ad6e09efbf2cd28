#!/usr/bin/env python3
"""Time the batched HSMM E-step and its K19 segment sums on one GPU.

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
launches alone, without the host's share of their spans).  Prints one
JSON line.

    python3 estep_timing.py [--root DIR] [--reps N]
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
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


def time_estep(torch, hb, kernels, ms, utts, reps: int, max_dur: int):
    chained, _ = hb.chain_modelset(ms, utts)
    tables = hb.tables_from_modelset(ms)
    M, S = ms.dur_mean.shape
    n_rows = {st.name: M * S for st in ms.streams}

    def estep():
        return hb.corpus_estep(tables, chained, n_rows, M * S, max_dur,
                               max_batch=32)
    estep()                                                    # warm
    torch.cuda.synchronize()
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
                                           max_dur, max_batch=32):
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
        estep()
        torch.cuda.synchronize()
    device = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        kind = next((k for k in ("hsmm_loglik", "hsmm_fb",
                                 "hsmm_accumulate") if k in e.key), "other")
        ms_n = device.setdefault(kind, [0.0, 0])
        ms_n[0] += us / 1e3
        ms_n[1] += e.count
    return {"rows": M * S, "utterances": len(utts),
            "frames": int(sum(len(f) for f, _ in utts)),
            "batches": sum(s == "pad" for s, _ in marks),
            "estep_ms": walls, "estep_ms_min": min(walls),
            "spans_ms": spans, "device_ms_launches": device,
            "k19_launches": k19_launches,
            "total_ll": res.total_ll}


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
    out["hsmm_200"] = time_estep(torch, hb, kernels, ms, utts, args.reps,
                                 cs.HSMM_MAX_DUR)
    ms, utts = untied_set(hsmm, cs)
    out["untied_1485"] = time_estep(torch, hb, kernels, ms, utts,
                                    args.reps, cs.HSMM_MAX_DUR)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
