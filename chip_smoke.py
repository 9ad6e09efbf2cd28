#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one GPU.

Drives the port's main path, batched WORLD copy-synthesis in f32 fast mode
(`hts_train_world_tpu_torch.parallel.batch.batch_copy_synth`), at the
headline size: 48 kHz, 2.0 s utterances, batch 16, 5 ms frames, on a
harmonic corpus made from a seed.  Phases (any failure raises):

1. build every CUDA kernel from `hts_train_world_tpu_torch/csrc/`;
2. run the main path once with the launch counts set to 0, recording each
   kernel's inputs; fail if a kernel was not launched, or if the outputs
   are not finite, in range and plausible;
3. replay every recorded launch through the kernel and its plain PyTorch
   version on the same inputs and hold them, row by row or element by
   element, within the stated tolerance; time kernel, plain version,
   bound and (K2, K3) the library call;
4. compare the card's path with the CPU (plain) path on a small input;
5. time the stages (CUDA events between the stages of the one
   `copy_synth_stages` path that `batch_copy_synth` runs) and the
   audio-seconds per second over 5 batches.

Prints the per-stage times, the throughput, one line per kernel, the
card's name and power limit, a `kernels` JSON line, and as the last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
no CUDA device is present.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FS, DUR, BATCH, ITERS, FRAME_PERIOD = 48000, 2.0, 16, 5, 5.0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores
F64_OPS_PER_S = 34e12           # f64 outside the tensor cores

# kernel name -> (K number, TPU formulation it replaces)
REPLACES = {
    "frame_window": ("K1", "hts_train_world_tpu/ops/d4c.py:71"),
    "spectral_smooth": ("K2", "hts_train_world_tpu/ops/prims.py:413"),
    "topk_sum": ("K3", "hts_train_world_tpu/ops/prims.py:383"),
    "fix_f0": ("K4", "hts_train_world_tpu/ops/dio.py:137"),
}


def corpus(batch: int, n: int, seed: int = 0) -> np.ndarray:
    """bench.py's harmonic corpus: 4 harmonics of 160-235 Hz, 5 Hz
    amplitude wobble, 1% white noise, peak 0.7."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    xs = []
    for i in range(batch):
        f0 = 160.0 + 15.0 * (i % 6)
        x = sum(a * np.sin(2 * np.pi * f0 * (h + 1) * t + 0.1 * h)
                for h, a in enumerate([0.5, 0.3, 0.2, 0.1]))
        x = x * (1.0 + 0.02 * np.sin(2 * np.pi * 5.0 * t))
        x += 0.01 * rng.standard_normal(n)
        xs.append(0.7 * x / np.abs(x).max())
    return np.stack(xs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from hts_train_world_tpu_torch import config as cfg
    from hts_train_world_tpu_torch import kernels
    from hts_train_world_tpu_torch.ops import dio as dio_mod
    from hts_train_world_tpu_torch.ops import fftmat, frames, prims
    from hts_train_world_tpu_torch.ops import synthesis as syn
    from hts_train_world_tpu_torch.parallel import batch as batch_mod

    dev = torch.device("cuda")

    def sync():
        torch.cuda.synchronize()

    def cuda_ms(fn, reps: int, warm: int = 1) -> float:
        for _ in range(warm):
            fn()
        sync()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    # ---- 1. build ----
    t0 = time.perf_counter()
    bdir = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{os.path.relpath(bdir, REPO)}", flush=True)
    for name in kernels.KERNELS:
        with open(os.path.join(bdir, f"{name}.log")) as f:
            regs = [ln.strip() for ln in f if "registers" in ln
                    or "spill" in ln]
        if regs:
            print(f"  {name}: {regs[-1]}")

    # ---- 2. the main path, counted and recorded ----
    L = int(FS * DUR)
    xs = torch.as_tensor(corpus(BATCH, L), dtype=torch.float32, device=dev)
    batch_mod.batch_copy_synth(xs, FS, seed=1)      # warm-up (cuBLAS etc.)
    sync()
    kernels.reset_counts()
    kernels.record = []
    _, f0, sp, ap, y = batch_mod.batch_copy_synth(xs, FS, seed=1)
    sync()
    counts = dict(kernels.launches)
    recorded, kernels.record = kernels.record, None
    print("launches on the main path:", counts, flush=True)
    missing = [k for k in kernels.KERNELS if counts.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")

    T = cfg.samples_for_dio(FS, L, FRAME_PERIOD)
    yl = cfg.y_length_for(T, FRAME_PERIOD, FS)
    half = cfg.cheaptrick_fft_size(FS) // 2
    if f0.shape != (BATCH, T) or sp.shape != (BATCH, T, half + 1) \
            or ap.shape != sp.shape or y.shape != (BATCH, yl):
        raise RuntimeError("unexpected output shapes")
    for name, v in (("f0", f0), ("sp", sp), ("ap", ap), ("y", y)):
        if not torch.isfinite(v).all():
            raise RuntimeError(f"{name} is not finite")
    if not (sp > 0).all() or ap.min() < 0 or ap.max() > 1:
        raise RuntimeError("sp must be > 0 and ap within [0, 1]")
    voiced = (f0 > 0).float().mean().item()
    med_f0 = f0[f0 > 0].median().item()
    rms = y.pow(2).mean().sqrt().item()
    print(f"outputs: voiced rate {voiced:.3f}, median f0 {med_f0:.1f} Hz, "
          f"y rms {rms:.4f}")
    if not (0.8 <= voiced <= 1.0 and 150.0 <= med_f0 <= 250.0
            and 0.05 <= rms <= 1.0):
        raise RuntimeError("implausible V/UV rate, f0 or output level")

    # ---- 3. every kernel against its plain version on its inputs ----
    twins = {
        "frame_window": (frames.frame_windows, frames.frame_windows_plain),
        "spectral_smooth": (prims.smooth_spectrum,
                            prims.smooth_spectrum_plain),
        "topk_sum": (prims.top_k_threshold_sum,
                     prims.top_k_threshold_sum_plain),
        "fix_f0": (dio_mod.fix_f0_contour, dio_mod.fix_f0_contour_plain),
    }

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))

    def bound_of(name, inp, outs):
        """(bound ms, 'bytes' | 'operations') for one launch."""
        moved = nbytes(*inp.values(), *outs)
        t_o = 0.0
        if name == "frame_window":
            t_o = 12.0 * sum(o.numel() for o in outs
                             if o is not None) / F32_OPS_PER_S
        elif name == "spectral_smooth":     # scan, reads, divide in f64
            t_o = 8.0 * inp["ps"].numel() / F64_OPS_PER_S
        elif name == "topk_sum":
            t_o = 2.0 * inp["p"].numel() / F32_OPS_PER_S
        t_b = moved / HBM_BYTES_PER_S
        return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    def library(name, inp):
        """One PyTorch call for the same job, where there is one.  K2's is
        `torch.cumsum` of the mirrored rows alone (no DC fold, no reads,
        no division): the whole cumsum-based smoothing in library calls
        is the plain version."""
        if name == "topk_sum":
            return lambda: torch.topk(inp["p"], inp["k"], dim=1).values.sum(1)
        if name == "spectral_smooth" and inp["width"] is not None:
            b, ps = inp["b_max"], inp["ps"]
            n = ps.shape[1]
            mirror = torch.cat([ps[:, 1:b + 1].flip(1), ps,
                                ps[:, n - 1 - b:n - 1].flip(1)], dim=1)
            return lambda: torch.cumsum(mirror, dim=1)
        return None

    def row_rel(err, want):
        """Worst row's max |err| over its max |want|."""
        return float((err.amax(1) / want.abs().amax(1).clamp(min=1e-30))
                     .max())

    def check(name, inp, out_k, out_p):
        """(passed, max abs err against the reference, what was held and
        what was read)."""
        if name == "topk_sum":
            rel = float(((out_k[0] - out_p[0]).abs()
                         / out_p[0].abs().clamp(min=1e-30)).max())
            return (bool(torch.equal(out_k[1], out_p[1])) and rel <= 1e-5,
                    float((out_k[0] - out_p[0]).abs().max()),
                    f"threshold bit-equal, sum rel {rel:.2e} <= 1e-5")
        if name == "fix_f0":
            err = (out_k[0] - out_p[0]).abs()
            ok = bool(torch.equal(out_k[0] > 0, out_p[0] > 0)
                      and (err <= 1e-6 * out_p[0].abs()).all())
            return ok, float(err.max()), "V/UV equal, |err| <= 1e-6 |plain|"
        if name == "frame_window":
            pairs = [((k - p).abs(), p) for k, p in zip(out_k, out_p)
                     if p is not None]
            worst = max(row_rel(e, p) for e, p in pairs)
            return (worst <= 1e-5, max(float(e.max()) for e, _ in pairs),
                    f"per row |err| <= 1e-5 row max |plain|: worst row "
                    f"{worst:.2e}")
        # spectral_smooth: element by element within the rounding bound of
        # two float64 summation orders (prims.smooth_spectrum_limit); and,
        # for comparison, how far the JAX package's f32 sums land from it
        k, p = out_k[0], out_p[0]
        err = (k - p).abs()
        lim = prims.smooth_spectrum_limit(out=p, **inp)
        ok = bool((err <= lim).all())
        live = p != 0
        text = (f"|err| <= limit per element: worst err/limit "
                f"{float((err / lim.clamp(min=1e-300)).max()):.3f}, worst "
                f"row {row_rel(err, p):.2e}, bins whose limit exceeds 1e-6 "
                f"of the value "
                f"{float((lim > 1e-6 * p.abs()).double().mean()):.4f}")
        if inp["width"] is not None:
            f32 = prims.smooth_spectrum_plain(**inp, acc=torch.float32)
            rel = ((f32 - p).abs() / p.abs())[live]
            text += (f"; f32 sums (JAX's branch) vs these: rel err median "
                     f"{float(rel.median()):.1e}, max {float(rel.max()):.1e}"
                     f", share > 1% {float((rel > 0.01).double().mean()):.3f}")
        return ok, float(err.max()), text

    summary = {}
    for name, inp in recorded:
        kern, plain = twins[name]
        out_k = kern(**inp)
        out_p = plain(**inp)
        sync()
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        ok, err, tol = check(name, inp, out_k, out_p)
        heavy = name == "fix_f0"      # the plain twin loops over frames
        ms = cuda_ms(lambda: kern(**inp), reps=10, warm=2)
        plain_ms = cuda_ms(lambda: plain(**inp), reps=1 if heavy else 5)
        lib = library(name, inp)
        lib_ms = cuda_ms(lib, reps=10, warm=2) if lib else None
        bms, by = bound_of(name, inp, out_k)
        shape = "x".join(str(s) for s in out_k[0].shape)
        print(f"{REPLACES[name][0]} {name} out {shape}: max_abs_err "
              f"{err:.3e} ({tol}) {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by})"
              + (f", library {lib_ms:.4f} ms" if lib_ms is not None else ""),
              flush=True)
        if not ok:
            raise RuntimeError(f"{name}: kernel disagrees with its plain "
                               f"version (max abs err {err:.3e})")
        s = summary.setdefault(name, dict(err=0.0, ms=0.0, plain_ms=0.0,
                                          bound_ms=0.0, lib_ms=None,
                                          by={}))
        s["err"] = max(s["err"], err)
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["bound_ms"] += bms
        s["by"][by] = s["by"].get(by, 0.0) + bms
        if lib_ms is not None:
            s["lib_ms"] = (s["lib_ms"] or 0.0) + lib_ms
        del out_k, out_p
    del recorded
    torch.cuda.empty_cache()

    # the per-frame DFT route: matmul against the tables vs torch.fft
    fft_d = cfg.d4c_fft_size(FS)
    rows = torch.randn(BATCH * T, 2816, device=dev)
    mm_ms = cuda_ms(lambda: fftmat.rfft_power_matmul(rows, fft_d), reps=5)
    def fft_power():
        s = torch.fft.rfft(rows, n=fft_d, dim=1)
        return s.real * s.real + s.imag * s.imag

    fft_ms = cuda_ms(fft_power, reps=5)
    flops = 4.0 * rows.shape[0] * rows.shape[1] * (fft_d // 2 + 1)
    print(f"DFT route at {BATCH * T}x2816 -> {fft_d}: matmul power "
          f"{mm_ms:.3f} ms (bound {1e3 * flops / F32_OPS_PER_S:.3f} ms for "
          f"its {flops / 1e9:.1f} GFLOP), torch.fft power {fft_ms:.3f} ms")
    del rows

    # ---- 4. the card against the CPU (plain) path, small input ----
    xsm = corpus(2, int(FS * 0.5), seed=3)
    Tm = cfg.samples_for_dio(FS, xsm.shape[1], FRAME_PERIOD)
    ylm = cfg.y_length_for(Tm, FRAME_PERIOD, FS)
    nz = np.random.default_rng(4).standard_normal(
        (2, syn.synthesis_stream_len(ylm)))
    g = batch_mod.batch_copy_synth(xsm, FS, noise=nz, device="cuda")
    c = batch_mod.batch_copy_synth(xsm, FS, noise=nz, device="cpu")
    g = [v.cpu().double() for v in g]
    c = [v.double() for v in c]
    vuv = float(((g[1] > 0) == (c[1] > 0)).double().mean())
    both = (g[1] > 0) & (c[1] > 0)
    f0_rel = float(((g[1][both] - c[1][both]).abs() / c[1][both]).median())
    dlog = float((g[2].log() - c[2].log()).abs().median())
    dap = float((g[3] - c[3]).abs().median())
    e_rel = float(((g[4].pow(2).sum(1) / c[4].pow(2).sum(1)) - 1).abs().max())
    print(f"card vs CPU path (2 x 0.5 s): V/UV agreement {vuv:.4f}, f0 med "
          f"rel {f0_rel:.2e}, sp med |dlog| {dlog:.2e}, ap med |d| "
          f"{dap:.2e}, energy rel {e_rel:.2e}")
    if not (vuv >= 0.98 and f0_rel <= 1e-4 and dlog <= 0.05 and dap <= 0.01
            and e_rel <= 0.05):
        raise RuntimeError("the card's path disagrees with the CPU path")

    # ---- 5. stage times and throughput ----
    stages = {}
    for _ in range(3):
        prev = torch.cuda.Event(enable_timing=True)
        prev.record()
        marks = []
        for stage, _ in batch_mod.copy_synth_stages(xs, FS, FRAME_PERIOD,
                                                    seed=2):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((stage, e))
        marks[-1][1].synchronize()
        for stage, ev in marks:
            stages.setdefault(stage, []).append(prev.elapsed_time(ev))
            prev = ev
    stage_ms = {k: float(np.mean(v)) for k, v in stages.items()}
    print("stage ms (mean of 3, B=16 x 2.0 s @ 48 kHz): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_ms.items()))

    sync()
    per_batch = []
    for s in range(ITERS):
        t0 = time.perf_counter()
        out = batch_mod.batch_copy_synth(xs, FS, seed=10 + s)
        float(out[4].pow(2).sum())
        sync()
        per_batch.append(time.perf_counter() - t0)
    dt = float(np.mean(per_batch))
    print(f"throughput: {BATCH * DUR / dt:.2f} audio-s/s "
          f"({1e3 * dt:.1f} ms per batch of {BATCH} x {DUR} s, mean of "
          f"{ITERS}; median {1e3 * float(np.median(per_batch)):.1f}, min "
          f"{1e3 * min(per_batch):.1f}, max {1e3 * max(per_batch):.1f} ms)",
          flush=True)

    # ---- 6. where the device time goes: one batch under the profiler ----
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch_mod.batch_copy_synth(xs, FS, seed=20)
        sync()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (the aten:: host ops carry their kernels'
    # time as well)
    evs = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and dev_us(e) > 0), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in evs) / 1e6
    if busy > 0:
        groups = {g: [0.0, 0] for g in ("gemm (DFT matmuls)", "fft",
                                        "K1-K4", "other")}
        for e in evs:
            k = e.key.lower()
            g = ("gemm (DFT matmuls)" if "gemm" in k
                 else "fft" if "fft" in k
                 else "K1-K4" if any(n in k for n in kernels.KERNELS)
                 else "other")
            groups[g][0] += dev_us(e) / 1e3
            groups[g][1] += e.count
        print(f"profiler: one batch, wall {1e3 * wall:.1f} ms, device busy "
              f"{1e3 * busy:.1f} ms ({100 * busy / wall:.0f}%, idle "
              f"{100 - 100 * busy / wall:.0f}%); by kind: "
              + ", ".join(f"{g} {v:.2f} ms in {n} launches"
                          for g, (v, n) in groups.items()))
        for e in evs[:12]:
            print(f"  {dev_us(e) / 1e3:8.2f} ms  {e.count:5d} x  "
                  f"{e.key[:90]}")
    else:
        print("profiler: no device time recorded")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    src = "hts_train_world_tpu_torch/csrc/"
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": src + kernels.KERNELS[name][0],
         "replaces": REPLACES[name][1], "launches": counts[name],
         "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": max(s["by"], key=s["by"].get),
         "library_ms": s["lib_ms"]}
        for name, s in summary.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
