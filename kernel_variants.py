#!/usr/bin/env python3
"""One kernel of the port against other builds of its source, on one card
in one process.

The builds: the committed source; other trees' sources of the same kernel
(`--other DIR[,DIR...]`, e.g. a parent commit unpacked with `git archive`
into `.archive/parent`); and text variants of the committed source
(`--sub VARIANT OLD NEW`: every occurrence of OLD replaced by NEW, OLD
must occur; several --sub with one VARIANT make one variant).  Each is
built with the port's nvcc flags into its own library, all at once, and
swapped in behind the kernel's wrapper, so every build runs the same
launches: those that one lane of chip_smoke.py's headline batch (16 x 2.0
s at 48 kHz, seed 0) gives the kernel, recorded once.  The lanes: `copy`,
the float32 copy-synthesis; `parity`, the float64 parity analysis, then
the float64 encode of its spectra.

Every build's outputs are held to the kernel's plain twin, as the worst
ratio of an error to its bound (`check`): the committed source and every
--other must come within 1, a text variant may be a probe that computes
something else and is only reported.  The builds run in turns (in order,
then in reverse), each launch timed on the device behind a sleep.  Prints
one JSON line: the kernel, the lane, the recorded launches' shapes, the
card's name and power limit, and for each build the batch's sum of each
turn (µs), each launch's best time, the worst ratio, and ptxas's
registers and spill stores for each of its kernels.

    python3 kernel_variants.py frame_window --lane parity \\
        --other .archive/parent
    python3 kernel_variants.py codec_encode --lane parity --sub fma_pipes \\
        'if constexpr (sizeof(T) == 8)' 'if constexpr (sizeof(T) == 0)'

Kernels: the keys of `twins()`; add a kernel's wrapper and twin there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def twins():
    """kernel -> (wrapper, plain twin)."""
    from hts_train_world_tpu_torch.features import encode
    from hts_train_world_tpu_torch.ops import frames, prims
    return {"frame_window": (frames.frame_windows,
                             frames.frame_windows_plain),
            "spectral_smooth": (prims.smooth_spectrum,
                                prims.smooth_spectrum_plain),
            "codec_encode": (encode.encode_spectra,
                             encode.encode_spectra_plain)}


def check(name, inp, got, want):
    """The worst |got - want| over its bound: the bounds of chip_smoke.py's
    phase 3 (K2's fast kernel `smooth_spectrum_limit`, K6 the encode's
    limit, 1e-7 of it in float64; else each row within 1e-5 (float32) or
    1e-12 (float64) of its largest value)."""
    import torch
    from hts_train_world_tpu_torch.features import encode
    from hts_train_world_tpu_torch.ops import prims
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    pairs = [(g, w) for g, w in zip(got, want) if w is not None]
    f64 = pairs[0][1].dtype == torch.float64
    if name == "spectral_smooth" and not inp.get("parity"):
        lim = prims.smooth_spectrum_limit(
            out=want[0], **{k: v for k, v in inp.items() if k != "parity"})
        return float(((got[0] - want[0]).abs() / lim.clamp(min=1e-300))
                     .max())
    if name == "codec_encode":
        lims = encode.encode_spectra_limit(*want)
        return max(float(((g - w).abs() / (l * (1e-7 if f64 else 1.0)))
                         .max()) for (g, w), l in zip(pairs, lims))
    rel = 1e-12 if f64 else 1e-5
    return max(float(((g - w).abs().amax(-1) / w.abs().amax(-1)
                      .clamp(min=1e-300)).max()) / rel for g, w in pairs)


def record(kernel: str, lane: str):
    """The (inputs) of every launch of `kernel` in one batch of `lane`."""
    import torch
    import chip_smoke as cs
    from hts_train_world_tpu_torch import kernels
    from hts_train_world_tpu_torch.features import encode
    from hts_train_world_tpu_torch.parallel import batch
    xs = cs.corpus(cs.BATCH, int(cs.FS * cs.DUR))
    if lane == "copy":
        x32 = torch.as_tensor(xs, dtype=torch.float32, device="cuda")

        def run():
            batch.batch_copy_synth(x32, cs.FS, seed=1)
    else:
        x64 = torch.as_tensor(xs, dtype=torch.float64, device="cuda")

        def run():
            *_, (_, (_, _, sp, ap)) = batch.parity_stages(
                x64, cs.FS, cs.FRAME_PERIOD)
            n = sp.shape[-1]
            encode.encode_spectra(sp.reshape(-1, n), ap.reshape(-1, n),
                                  cs.FS, 2 * (n - 1))
    run()
    kernels.record = []
    try:
        run()
        torch.cuda.synchronize()
        rec = kernels.record
    finally:
        kernels.record = None
    return [inp for key, inp in rec if kernels.base_name(key) == kernel]


def ptxas(log: str):
    """[kernel, registers, spill store bytes] of each entry in an nvcc -v
    log, the names demangled where cu++filt is found."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            spill = None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append([name, int(m.group(1)), spill])
            name = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if out and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(e[0] for e in out),
                               capture_output=True, text=True).stdout
        for e, d in zip(out, names.splitlines()):
            m = re.search(r"(\w+<[^()]*>)", d)
            e[0] = m.group(1) if m else d
    return out


def build(jobs, out_dir: str):
    """Compile each (key, source) of `jobs` with the port's flags, all at
    once; {key: (library, ptxas entries)}."""
    from hts_train_world_tpu_torch import kernels
    procs = []
    for key, src in jobs:
        path = os.path.join(out_dir, f"{key}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"lib{key}.so")
        procs.append((key, so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
             "-o", so, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    built = {}
    for key, so, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        built[key] = (ctypes.CDLL(so), ptxas(log))
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel")
    ap.add_argument("--lane", choices=("copy", "parity"), default="copy")
    ap.add_argument("--other", default=None)
    ap.add_argument("--sub", nargs=3, action="append", default=[],
                    metavar=("VARIANT", "OLD", "NEW"))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from hts_train_world_tpu_torch import kernels
    name = args.kernel
    kern, plain = twins()[name]
    src_file, launcher, argtypes = kernels.KERNELS[name]
    d = kernels.build()
    rec = record(name, args.lane)
    if not rec:
        raise RuntimeError(f"{name}: no launch in the {args.lane} lane")
    with open(os.path.join(kernels.CSRC, src_file)) as f:
        src = f.read()
    with open(os.path.join(d, f"{name}.log")) as f:
        libs = {"committed": (kernels._libs[name][0][launcher],
                              ptxas(f.read()))}
    jobs, checked = [], {"committed"}
    for other in (args.other.split(",") if args.other else []):
        with open(os.path.join(other, "hts_train_world_tpu_torch", "csrc",
                               src_file)) as f:
            key = f"other:{os.path.basename(os.path.normpath(other))}"
            jobs.append((key, f.read()))
            checked.add(key)
    subs: dict = {}
    for var, old, new in args.sub:
        subs.setdefault(var, []).append((old, new))
    for var, pairs in subs.items():
        s = src
        for old, new in pairs:
            if old not in s:
                raise RuntimeError(f"{var}: {old!r} is not in {src_file}")
            s = s.replace(old, new)
        jobs.append((var, s))
    tmp = tempfile.mkdtemp(dir=kernels.BUILD_ROOT)
    keys = {k: f"v{i}" for i, (k, _) in enumerate(jobs)}
    built = build([(keys[k], s) for k, s in jobs], tmp)
    for k, _ in jobs:
        lib, entries = built[keys[k]]
        fn = getattr(lib, launcher)
        fn.argtypes = argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[k] = (fn, entries)

    def device_us(fn):
        fn()
        torch.cuda.synchronize()
        cycles = 1 << 21
        for _ in range(6):
            s, a, b = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
            s.record()
            torch.cuda._sleep(cycles)
            a.record()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            host_ms = 1e3 * (time.perf_counter() - t0)
            b.record()
            b.synchronize()
            if s.elapsed_time(a) > 1.5 * host_ms:
                return 1e3 * a.elapsed_time(b) / args.reps
            cycles *= 4
        return float("nan")

    fns, err = kernels._libs[name]

    def run(key):
        """(each launch's µs, the worst error over its bound)."""
        kernels._libs[name] = ({**fns, launcher: libs[key][0]}, err)
        try:
            worst = max(check(name, inp, kern(**inp), plain(**inp))
                        for inp in rec)
            return [device_us(lambda: kern(**inp)) for inp in rec], worst
        finally:
            kernels._libs[name] = (fns, err)

    order = list(libs)
    turns = {k: [] for k in order}
    for k in order + order[::-1]:
        turns[k].append(run(k))
    out = {}
    for k, rs in turns.items():
        out[k] = dict(sum_us=[sum(t) for t, _ in rs],
                      launch_us=[min(t[i] for t, _ in rs)
                                 for i in range(len(rec))],
                      worst=max(w for _, w in rs), ptxas=libs[k][1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    shapes = [[list(v.shape) for v in inp.values()
               if isinstance(v, torch.Tensor) and v.dim() > 1]
              for inp in rec]
    print(json.dumps({"kernel": name, "lane": args.lane, "card": card,
                      "launches": shapes, "builds": out}))
    bad = [k for k in checked if not out[k]["worst"] <= 1.0]
    if bad:
        print(f"kernel_variants: {bad} disagree with the twin",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
