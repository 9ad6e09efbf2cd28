#!/usr/bin/env python3
"""Time the f32 lanes' and the SPTK engine's audio-seconds per second on
one GPU.

Loads `hts_train_world_tpu_torch` from `--root` (default: this checkout),
so that two trees of the port can be timed in one call on the same card,
in turns, and runs chip_smoke.py's f32 lanes on its corpora:

- copy-synthesis (`parallel.batch.batch_copy_synth`), the feature lane
  (`parallel.features.feature_lane`) and the Harvest lane
  (`parallel.batch.batch_analyze(algorithm="harvest")`) on the headline
  batch, 16 x 2.0 s at 48 kHz: one warm batch, then `--reps` batches each
  timed on the host clock to a synchronize;
- corpus500 (`parallel.bucketing.bucketed_extract`, 500 utterances, 524.1
  s of audio): one warm run, then one timed run;
- the SPTK engine (`models.pgen.generate_waveform(engine="sptk")`,
  float64: K35-K37) on chip_smoke.py's `sptk_gens`, 16 phrases of 530
  frames at 48 kHz, alpha 0.55, each on its own seed: one warm run, then
  `--reps` runs of all 16 each timed on the host clock to a synchronize.

Prints one JSON line: audio-s/s (mean and median over the batches), a
digest of each lane's outputs on its warm-up batch (sha256 of every
output tensor's bytes, so two trees' outputs compare bit for bit), and
the card's name and power limit.

    python3 lane_timing.py [--root DIR] [--reps N]
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
    """chip_smoke.py of this checkout, for its corpora."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lane_timing: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from hts_train_world_tpu_torch import kernels
    from hts_train_world_tpu_torch.parallel import batch, bucketing, features
    if not os.path.abspath(kernels.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package did not load from {root}")
    cs = _chip_smoke()
    kernels.build()
    xs = torch.as_tensor(cs.corpus(cs.BATCH, int(cs.FS * cs.DUR)),
                         dtype=torch.float32, device="cuda")
    out = {"root": os.path.relpath(root, HERE), "digest": {}}

    def digest(result):
        h = hashlib.sha256()
        stack = [result]
        while stack:
            v = stack.pop(0)
            if isinstance(v, torch.Tensor):
                h.update(v.detach().cpu().contiguous().numpy().tobytes())
            elif isinstance(v, (tuple, list)):
                stack[:0] = list(v)
        return h.hexdigest()[:16]

    def lane(name, fn, audio=cs.BATCH * cs.DUR):
        out["digest"][name] = digest(fn(0))
        fn(0)
        torch.cuda.synchronize()
        dts = []
        for s in range(args.reps):
            t0 = time.perf_counter()
            fn(s)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        out[name] = {"mean": audio / float(np.mean(dts)),
                     "median": audio / float(np.median(dts))}

    lane("copy_synth", lambda s: batch.batch_copy_synth(xs, cs.FS,
                                                        seed=10 + s))
    lane("feature_lane", lambda s: features.feature_lane(xs, cs.FS))
    lane("harvest_lane", lambda s: batch.batch_analyze(
        xs, cs.FS, algorithm="harvest"))
    sigs = cs.corpus500()
    bucketing.bucketed_extract(sigs, cs.FS, max_batch=16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bucketing.bucketed_extract(sigs, cs.FS, max_batch=16)
    torch.cuda.synchronize()
    out["corpus500"] = sum(len(s) for s in sigs) / cs.FS / (
        time.perf_counter() - t0)
    from hts_train_world_tpu_torch.models import pgen
    gens = cs.sptk_gens()
    shift = int(cs.FS * cs.FRAME_PERIOD / 1000)
    lane("sptk_engine", lambda s: [
        pgen.generate_waveform(st, v, cs.FS, engine="sptk", alpha=0.55,
                               seed=i, device="cuda")
        for i, (st, v) in enumerate(gens)],
        audio=sum((len(st["lf0"]) - 1) * shift for st, _ in gens) / cs.FS)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
