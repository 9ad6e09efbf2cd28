#!/usr/bin/env python3
"""Time `train_voice`'s stages with and without SEMIT and UPMIX on one GPU.

Runs `models.recipe.train_voice` on chip_smoke.py's recipe corpus (phase
11: 128 utterances, `world_streams()`, 40 models x 5 states, the
`RecipeConfig()` defaults) several times in one process, in turns: no
flags, both flags, no flags, `semitied` alone, `upmix` alone, both flags
with `kernels.record` set as chip_smoke.py's phase 18 sets it, no
flags.  Every run must give the same clustered model, alignments and GV
trees.  For each run it prints one JSON line: the stage seconds, and for
each tree search (CXCL trees, CXCL2 trees) its wall seconds, the main
thread's CPU seconds, the process's CPU seconds, the busiest other threads
of the process (name, CPU seconds), and the cyclic garbage collector's
seconds and passes per generation; and the live Python objects.

    python3 recipe_timing.py [--root DIR] [--runs off,both,...]
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUNS = "off,both,off,semitied,upmix,both_recorded,off"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _threads():
    """{tid: (name, CPU seconds)} of this process's threads."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                st = f.read()
            with open(f"/proc/self/task/{tid}/comm") as f:
                name = f.read().strip()
        except OSError:
            continue
        fields = st[st.rindex(")") + 2:].split()
        out[tid] = (name, (int(fields[11]) + int(fields[12])) / tick)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--runs", default=RUNS)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    if not torch.cuda.is_available():
        print("recipe_timing: no CUDA device", file=sys.stderr)
        return 1
    from hts_train_world_tpu_torch import kernels
    from hts_train_world_tpu_torch.features import qconf
    from hts_train_world_tpu_torch.models import clustering, hsmm, recipe
    from hts_train_world_tpu_torch.models import context_clustered as cc
    cs = _chip_smoke()
    kernels.build()
    utts, names = cs.recipe_corpus(hsmm)
    qs = clustering.questions_from_config(
        qconf.parse_config(cs.recipe_questions(names)))

    spans = []
    build = cc.build_clustered_model

    def timed_build(*args, **kw):
        t0, th0, p0 = time.perf_counter(), time.thread_time(), \
            time.process_time()
        tr0 = _threads()
        with cs.UsageClock() as clock:
            out = build(*args, **kw)
        wall = time.perf_counter() - t0
        th, p = time.thread_time() - th0, time.process_time() - p0
        tr1 = _threads()
        main_tid = str(os.getpid())
        others = sorted(((n, round(c - tr0.get(t, (n, 0.0))[1], 2))
                         for t, (n, c) in tr1.items() if t != main_tid),
                        key=lambda x: -x[1])[:4]
        spans.append(dict(
            wall_s=round(wall, 3), main_thread_cpu_s=round(th, 3),
            process_cpu_s=round(p, 3), busiest_other_threads=others,
            gc_s=[round(x, 3) for x in clock.secs], gc_passes=clock.count,
            n_threads=len(tr1)))
        return out
    cc.build_clustered_model = timed_build

    ref = None
    for run in a.runs.split(","):
        flags = dict(off={}, both=dict(semitied=True, upmix=True),
                     both_recorded=dict(semitied=True, upmix=True),
                     semitied=dict(semitied=True),
                     upmix=dict(upmix=True))[run]
        spans.clear()
        kernels.record = (cs.KeepVariants() if run == "both_recorded"
                          else None)
        t0 = time.perf_counter()
        st = recipe.train_voice(utts, qs, recipe.RecipeConfig(**flags),
                                log=lambda m: None)
        wall = time.perf_counter() - t0
        kernels.record = None
        plain = (cc.ClusteredModel.to_plain(st.clustered), st.alignments,
                 {n: clustering.Tree.to_plain(t)
                  for n, t in st.gv.trees.items()})
        same = True if ref is None else cs.plain_equal(plain, ref)
        ref = ref or plain
        secs = {k: round(v, 3) for k, v in st.stage_seconds.items()}
        del st
        print(json.dumps(dict(
            run=run, wall_s=round(wall, 3), same_as_first=same,
            python_objects=len(gc.get_objects()),
            trees=dict(zip(("CXCL", "CXCL2"), spans[:2])),
            stage_seconds=secs)), flush=True)
        if not same:
            print(f"recipe_timing: run {run} changed a later stage",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
