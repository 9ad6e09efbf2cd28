#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one GPU.

Drives the port's four paths at full size on a corpus made from a seed:

- copy-synthesis (`parallel.batch.batch_copy_synth`): 48 kHz, 2.0 s
  utterances, batch 16, 5 ms frames, f32 fast mode;
- the feature lane (`parallel.features.feature_lane`): the same batch
  through analysis, the lf0/mgc/bap encode (mgc 50, bap 25), the delta
  windows and MLPG;
- the synth lane (`parallel.features.synth_lane`, the synth CLI's and the
  pipeline's WGEN path): the feature lane's (lf0, mgc, bap) of that batch
  decoded, pulse-counted and synthesised;
- corpus extraction (`parallel.bucketing.bucketed_extract`): bench.py's
  corpus500 recipe in memory, 500 utterances of 0.7-1.4 s at 48 kHz.

Phases (any failure raises):

1. build every CUDA kernel from `hts_train_world_tpu_torch/csrc/`;
2. run each path once with the launch counts set to 0 just before it and
   read just after (copy-synthesis and the feature lane also record each
   kernel's inputs); fail if a kernel of the path was not launched, or if
   the outputs are not finite, in range and plausible;
3. replay every recorded launch through the kernel and its plain PyTorch
   version on the same inputs and hold them within the stated tolerance
   (K5 and K8 also against float64 references; K9 and K11 bit for bit
   against the plain version run on the CPU, K11 also across two
   launches); time kernel, plain version, bound and, where one exists,
   the library call;
4. compare the card's copy-synthesis, feature lane and synth lane with
   the CPU (plain) path on a small input (the synth lane must fire the
   same pulses);
5. time the copy-synthesis stages and its audio-seconds per second; DIO's
   stage time and the device idle share with K5 and with its plain twin,
   in turns, in this one run;
6. one copy-synthesis batch under the profiler;
7. the feature lane's and the synth lane's stage times and audio-seconds
   per second, and one synth-lane batch under the profiler;
8. corpus extraction: audio-seconds per second, buckets and batches, the
   device busy share for one bucket group, host time padding and
   trimming.

Prints each measurement, the card's name and power limit, a `kernels`
JSON line, and as the last line {"ok": true, "device": {...}}.  Exits
non-zero, printing no result, when no CUDA device is present.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
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
    "dio_candidates": ("K5", "hts_train_world_tpu/ops/dio.py:88"),
    "codec_encode": ("K6", "hts_train_world_tpu/ops/codec.py:113"),
    "delta_window": ("K7", "hts_train_world_tpu/features/windows.py:44"),
    "mlpg_solve": ("K8", "hts_train_world_tpu/ops/mlpg.py:62"),
    "synth_time_base": ("K9", "hts_train_world_tpu/ops/synthesis.py:44"),
    "synth_pulse_spectra": ("K10", "hts_train_world_tpu/ops/synthesis.py:154"),
    "synth_ola": ("K11", "hts_train_world_tpu/ops/synthesis.py:248"),
    "codec_decode": ("K12", "hts_train_world_tpu/ops/codec.py:121"),
}
ANALYSIS = ("frame_window", "spectral_smooth", "topk_sum", "fix_f0",
            "dio_candidates")
SYNTHESIS = ("synth_time_base", "synth_pulse_spectra", "synth_ola")
# the kernels each path must launch
PATHS = {
    "copy_synth": ANALYSIS + SYNTHESIS,
    "feature_lane": ANALYSIS + ("codec_encode", "delta_window",
                                "mlpg_solve"),
    "synth_lane": ("codec_decode",) + SYNTHESIS,
    "corpus500": ANALYSIS + ("codec_encode",),
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


def corpus500(seed: int = 7):
    """bench.py's corpus500 recipe, in memory: 500 utterances of 0.7-1.4 s
    at 48 kHz, vibrato F0 of 140-260 Hz with 4 harmonics, 0.5% noise,
    quantised to int16 as the wav files hold them (read back / 32768)."""
    rng = np.random.default_rng(seed)
    sigs = []
    for _ in range(500):
        n = int(FS * (0.7 + 0.7 * rng.random()))
        tt = np.arange(n) / FS
        f0 = (140.0 + 120.0 * rng.random()) \
            * (1.0 + 0.02 * np.sin(2 * np.pi * 5.5 * tt))
        ph = 2 * np.pi * np.cumsum(f0) / FS
        xw = sum(a * np.sin((h + 1) * ph)
                 for h, a in enumerate([0.5, 0.3, 0.15, 0.08]))
        xw = 0.7 * xw / np.abs(xw).max() + 0.005 * rng.standard_normal(n)
        sigs.append(np.round(xw * 30000).astype(np.int16) / 32768.0)
    return sigs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from hts_train_world_tpu_torch import config as cfg
    from hts_train_world_tpu_torch import kernels
    from hts_train_world_tpu_torch.features import decode, encode
    from hts_train_world_tpu_torch.features import windows as win_mod
    from hts_train_world_tpu_torch.ops import codec
    from hts_train_world_tpu_torch.ops import dio as dio_mod
    from hts_train_world_tpu_torch.ops import fftmat, frames
    from hts_train_world_tpu_torch.ops import mlpg as mlpg_mod
    from hts_train_world_tpu_torch.ops import prims
    from hts_train_world_tpu_torch.ops import synthesis as syn
    from hts_train_world_tpu_torch.parallel import batch as batch_mod
    from hts_train_world_tpu_torch.parallel import bucketing
    from hts_train_world_tpu_torch.parallel import features as feat_mod
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def profiled(fn):
        """(wall s, device busy s, device events by time) of one call."""
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
        # device-side events only (the aten:: host ops carry their
        # kernels' time as well)
        evs = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and dev_us(e) > 0), key=dev_us, reverse=True)
        return wall, sum(dev_us(e) for e in evs) / 1e6, evs

    def counted(path, fn, record=False):
        """Run fn with the launch counts set to 0 just before and read
        just after; fail if a kernel of the path was not launched."""
        sync()
        kernels.reset_counts()
        kernels.record = [] if record else None
        out = fn()
        sync()
        counts = dict(kernels.launches)
        recorded, kernels.record = kernels.record, None
        print(f"launches on {path}:", counts, flush=True)
        missing = [k for k in PATHS[path] if counts.get(k, 0) == 0]
        if missing:
            raise RuntimeError(f"kernels not launched on {path}: {missing}")
        return out, counts, recorded

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

    # ---- 2. each path, counted (and recorded) ----
    L = int(FS * DUR)
    xs = torch.as_tensor(corpus(BATCH, L), dtype=torch.float32, device=dev)
    batch_mod.batch_copy_synth(xs, FS, seed=1)      # warm-up (cuBLAS etc.)
    (_, f0, sp, ap, y), counts_cs, rec_cs = counted(
        "copy_synth", lambda: batch_mod.batch_copy_synth(xs, FS, seed=1),
        record=True)

    T = cfg.samples_for_dio(FS, L, FRAME_PERIOD)
    yl = cfg.y_length_for(T, FRAME_PERIOD, FS)
    N = cfg.cheaptrick_fft_size(FS)
    half = N // 2
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
    del f0, sp, ap, y

    feat_mod.feature_lane(xs, FS)                    # warm-up
    (lf0, mgc, bap, traj), counts_fl, rec_fl = counted(
        "feature_lane", lambda: feat_mod.feature_lane(xs, FS), record=True)
    rec_fl = [(n, i) for n, i in rec_fl if n not in PATHS["copy_synth"]]

    def check_features(lf0, mgc, bap, traj=None, label="features"):
        vs = float((lf0 != 0).float().mean())
        bad = [n for n, v in (("lf0", lf0), ("mgc", mgc), ("bap", bap),
                              ("traj", traj))
               if v is not None and not bool(torch.isfinite(v).all())]
        print(f"{label}: lf0 voiced share {vs:.3f}, mgc/bap/traj finite: "
              f"{not bad}", flush=True)
        if bad or vs <= 0.5:
            raise RuntimeError(f"{label}: non-finite {bad} or voiced share "
                               f"{vs:.3f} <= 0.5")

    if lf0.shape != (BATCH, T) or mgc.shape != (BATCH, T, 50) \
            or bap.shape != (BATCH, T, 25) or traj.shape != (BATCH, T, 75):
        raise RuntimeError("unexpected feature shapes")
    check_features(lf0, mgc, bap, traj, "feature lane outputs")
    feats = (lf0, mgc, bap)
    del lf0, mgc, bap, traj

    feat_mod.synth_lane(*feats, FS, seed=1)          # warm-up
    ys, counts_sl, rec_sl = counted(
        "synth_lane", lambda: feat_mod.synth_lane(*feats, FS, seed=1),
        record=True)
    if ys.shape != (BATCH, yl) or not torch.isfinite(ys).all():
        raise RuntimeError("synth lane: unexpected shape or non-finite "
                           "waveform")
    rms = ys.pow(2).mean().sqrt().item()
    print(f"synth lane outputs: y rms {rms:.4f}", flush=True)
    if not 0.01 <= rms <= 1.0:
        raise RuntimeError("synth lane: implausible output level")
    del ys

    # ---- 3. every kernel against its plain version on its inputs ----
    twins = {
        "frame_window": (frames.frame_windows, frames.frame_windows_plain),
        "spectral_smooth": (prims.smooth_spectrum,
                            prims.smooth_spectrum_plain),
        "topk_sum": (prims.top_k_threshold_sum,
                     prims.top_k_threshold_sum_plain),
        "fix_f0": (dio_mod.fix_f0_contour, dio_mod.fix_f0_contour_plain),
        "dio_candidates": (dio_mod.band_candidates,
                           dio_mod.band_candidates_plain),
        "codec_encode": (encode.encode_spectra, encode.encode_spectra_plain),
        "delta_window": (win_mod.expand, win_mod.expand_plain),
        "mlpg_solve": (mlpg_mod.mlpg, mlpg_mod.mlpg_plain),
        "synth_time_base": (syn.time_base, syn.time_base_plain),
        "synth_pulse_spectra": (syn.pulse_spectra, syn.pulse_spectra_plain),
        "synth_ola": (syn.overlap_add, syn.overlap_add_plain),
        "codec_decode": (decode.decode_features,
                         decode.decode_features_plain),
    }

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))

    def bound_of(name, inp, outs):
        """(bound ms, 'bytes' | 'operations') for one launch: each input
        the function needs read once, each output written once."""
        moved = nbytes(*inp.values(), *outs)
        t_o = 0.0
        if name == "frame_window":
            t_o = 12.0 * sum(o.numel() for o in outs
                             if o is not None) / F32_OPS_PER_S
        elif name == "spectral_smooth":     # scan, reads, divide in f64
            t_o = 8.0 * inp["ps"].numel() / F64_OPS_PER_S
        elif name == "topk_sum":
            t_o = 2.0 * inp["p"].numel() / F32_OPS_PER_S
        elif name == "dio_candidates":
            # the band rows it reads (not the whole filtered rows), the
            # four streams' crossing tests (12 operations a sample)
            fb = inp["filt_bands"]
            samples = fb.shape[0] * fb.shape[1] * inp["plan"]["y_length"]
            moved = 4 * samples + nbytes(*outs)
            t_o = 12.0 * samples / F32_OPS_PER_S
        elif name == "codec_encode":
            rows = inp["sp"].numel() // inp["sp"].shape[-1]
            dims = inp["mgc_dim"] + inp["bap_dim"]
            t_o = rows * (2.0 * half * dims + 2 * 5.0 * (half + 1)) \
                / F32_OPS_PER_S
        elif name == "delta_window":
            t_o = 2.0 * 3 * outs[0].numel() / F32_OPS_PER_S
        elif name == "mlpg_solve":
            t_o = 60.0 * outs[0].numel() / F32_OPS_PER_S
        elif name == "synth_time_base":
            # ~40 f32 operations a sample (search, lerp, increment, wrap,
            # jump) and one float64 add; the serial sum is not counted
            samples = inp["f0"].shape[0] * inp["y_length"]
            t_o = max(40.0 * samples / F32_OPS_PER_S,
                      samples / F64_OPS_PER_S)
        elif name == "synth_pulse_spectra":
            # per bin the lerps and two logs (~60), per noise sample 3
            pulses = inp["pulse_time"].numel()
            t_o = pulses * (60.0 * inp["sp"].shape[-1]
                            + 3.0 * inp["fft_size"]) / F32_OPS_PER_S
        elif name == "synth_ola":
            t_o = 8.0 * inp["per_raw"].numel() / F32_OPS_PER_S
        elif name == "codec_decode":
            rows = inp["lf0"].numel()
            H = inp["fft_size"] // 2 + 1
            db = inp["bap"].shape[-1]
            t_o = rows * (2.0 * inp["mgc"].shape[-1] * (H - 1) + 30.0 * H
                          + 2.0 * db * decode.ap_order(db)) / F32_OPS_PER_S
        t_b = moved / HBM_BYTES_PER_S
        return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    def library(name, inp):
        """One PyTorch call for the same job, where there is one.  K2's is
        `torch.cumsum` of the mirrored rows alone (no DC fold, no reads,
        no division): the whole cumsum-based smoothing in library calls
        is the plain version.  K6's is log + gather-lerp + matmul of the
        scaled spectra (no zero floor, no c0 fixes); K7's the shifted adds
        (no -1e10 propagation)."""
        if name == "topk_sum":
            return lambda: torch.topk(inp["p"], inp["k"], dim=1).values.sum(1)
        if name == "spectral_smooth" and inp["width"] is not None:
            b, ps = inp["b_max"], inp["ps"]
            n = ps.shape[1]
            mirror = torch.cat([ps[:, 1:b + 1].flip(1), ps,
                                ps[:, n - 1 - b:n - 1].flip(1)], dim=1)
            return lambda: torch.cumsum(mirror, dim=1)
        if name == "codec_encode":
            sp4, ap4 = inp["sp"] * 1e4, inp["ap"] * 1e4
            a = (inp["fs"], inp["fft_size"])
            return lambda: (
                codec.code_spectral_envelope(sp4, *a, inp["mgc_dim"]),
                codec.code_spectral_envelope(ap4, *a, inp["bap_dim"]))
        if name == "synth_time_base":
            inc = syn.phase_increments(inp["f0"], inp["frame_period"],
                                       inp["fs"], inp["y_length"],
                                       inp["fft_size"])
            return lambda: torch.cumsum(inc, dim=1)
        if name == "synth_ola":
            resp = syn.finish_responses(
                inp["per_raw"], inp["aper_raw"], inp["unvoiced"],
                inp["noise_size"], inp["n"]).reshape(-1)
            at, Lb = syn.ola_index(inp["pidx"], inp["per_raw"].shape[-1],
                                   inp["y_length"])
            B = inp["pidx"].shape[0]
            return lambda: torch.zeros(B * Lb, device=dev).index_add_(
                0, at, resp)
        if name == "codec_decode":
            m, b, fs_, N_ = inp["mgc"], inp["bap"], inp["fs"], inp["fft_size"]
            m0 = torch.cat([m[..., :1] - 12.0, m[..., 1:]], dim=-1)
            W = torch.as_tensor(decode._ap_matrix_np(b.shape[-1], N_),
                                dtype=torch.float32, device=dev)
            b0 = torch.cat([b[..., :1] + encode.LN_1E4, b[..., 1:]],
                           dim=-1)[..., :W.shape[0]]
            return lambda: (
                torch.exp(inp["lf0"]),
                codec.decode_spectral_envelope(m0, fs_, N_, m.shape[-1]),
                torch.exp(fftmat.matmul(b0, W)))
        if name == "delta_window":
            x = inp["x"]

            def shifted():
                xp = torch.cat([x[..., :1, :], x, x[..., -1:, :]], dim=-2)
                lo, hi = xp[..., :-2, :], xp[..., 2:, :]
                return torch.cat([x, 0.5 * (hi - lo), hi - 2.0 * x + lo],
                                 dim=-1)
            return shifted
        return None

    def row_rel(err, want):
        """Worst row's max |err| over its max |want|."""
        return float((err.amax(1) / want.abs().amax(1).clamp(min=1e-30))
                     .max())

    def check_k5(inp, out_k, out_p):
        same = bool(torch.equal(out_k[2], out_p[2])
                    and torch.equal(out_k[3], out_p[3]))
        ref = dio_mod.crossing_candidates_f64(
            inp["filt_bands"], inp["plan"], inp["T"], inp["fp_s"], out_p[2],
            out_p[3])
        ck, cp = out_k[0], out_p[0]
        both = (ck > 0) & (cp > 0)
        rel_k = float(((ck.double() - ref).abs() / ref)[both].max())
        rel_p = float(((cp.double() - ref).abs() / ref)[both].max())
        agree = float(((ck > 0) == (cp > 0)).double().mean())
        ok = same and rel_k <= rel_p + 1e-6 and agree >= 0.999
        both_err = (ck - cp).abs()[both]
        return (ok, float(both_err.max()),
                f"positions and n equal: {same}; vs f64 interp1 of the same "
                f"crossings: kernel rel {rel_k:.2e}, twin rel {rel_p:.2e} "
                f"(kernel <= twin + 1e-6); zero/nonzero agreement "
                f"{agree:.5f} >= 0.999")

    def check_k8(inp, out_k, out_p):
        k, p = out_k[0], out_p[0]
        scale = p.abs().amax(dim=-2, keepdim=True)
        err = (k - p).abs()
        ok_twin = bool((err <= 1e-5 * p.abs() + 1e-5 * scale).all())
        # both against a dense float64 solve of the same normal equations
        mu, var = inp["means"].double(), inp["variances"].double()
        diags, rhs = mlpg_mod.build_banded_normal(
            mu, prims.rdiv(1.0, var), mlpg_mod.DEFAULT_WINDOWS)
        B, _, Tn, D = diags.shape
        A = torch.diag_embed(diags[:, 0].permute(0, 2, 1))
        for off in (1, 2):
            band = torch.diag_embed(diags[:, off, :Tn - off].permute(0, 2, 1),
                                    offset=off)
            A = A + band + band.transpose(-1, -2)
        dense = torch.linalg.solve(A, rhs.permute(0, 2, 1)[..., None])
        dense = dense[..., 0].permute(0, 2, 1)
        span = (dense.amax(dim=-2) - dense.amin(dim=-2)).clamp(min=1e-3)
        rk = float(((k.double() - dense).abs().amax(dim=-2) / span).max())
        rp = float(((p.double() - dense).abs().amax(dim=-2) / span).max())
        ok = ok_twin and rk <= 1e-3 and rp <= 1e-3
        return (ok, float(err.max()),
                f"|err| <= 1e-5 (|plain| + column max |plain|): {ok_twin}; "
                f"vs dense f64 solve, worst column err / range: kernel "
                f"{rk:.2e}, twin {rp:.2e} (<= 1e-3)")

    def on_cpu(inp):
        return {k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in inp.items()}

    def bit_same(a, b):
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            return bool(((a == b) | (a.isnan() & b.isnan())).all())
        return torch.equal(a, b)

    def max_err(pairs):
        errs = [float((k.cpu().double() - p.cpu().double()).abs()
                      .nan_to_num(0.0).max()) for k, p in pairs
                if k.numel() and k.is_floating_point()]
        return max(errs, default=0.0)

    def check_k9(inp, out_k):
        """Bit-equal to the plain version run on the CPU."""
        out_c = syn.time_base_plain(**on_cpu(inp))
        bad = [f for f, k, c in zip(syn.Pulses._fields, out_k, out_c)
               if not bit_same(k, c)]
        return (not bad, max_err(zip(out_k, out_c)),
                f"bit-equal to the plain version on the CPU (count, pulse "
                f"indices, noise sizes and offsets, shifts, times, V/UV): "
                f"{not bad}{' ' + str(bad) if bad else ''}; "
                f"{int(out_k.n.max())} pulses at most")

    def check_k10(inp, out_k, out_p):
        lims = syn.pulse_spectra_limit(*out_p[:3], inp["stream"])
        worst = max(float(((k - p).abs() / lim).max())
                    for k, p, lim in zip(out_k, out_p, lims))
        same_unv = torch.equal(out_k[3], out_p[3])
        return (worst <= 1.0 and same_unv, max_err(zip(out_k[:3], out_p)),
                f"log spectra within 4 ulps (+4 ulps of 1), noise within "
                f"1e-5 of the stream's peak: worst err/limit {worst:.3f}; "
                f"unvoiced flags equal: {same_unv}")

    def check_k11(inp, out_k):
        out_c = syn.overlap_add_plain(**on_cpu(inp))
        again = syn.overlap_add(**inp)
        same, det = bit_same(out_k[0], out_c), torch.equal(again, out_k[0])
        return (same and det, max_err([(out_k[0], out_c)]),
                f"bit-equal to the plain version's index_add_ on the CPU: "
                f"{same}; two launches identical: {det}")

    def check_k12(inp, out_k, out_p):
        f0_c = decode.decode_features_plain(**on_cpu(inp))[0]
        lim_sp, lim_ap = decode.decode_limit(**inp)
        apl = decode.ap_order(inp["bap"].shape[-1])
        r_sp = float(((out_k[1].log() - out_p[1].log()).abs()
                      / lim_sp).max())
        r_ap = float(((out_k[2][..., :apl].log()
                       - out_p[2][..., :apl].log()).abs() / lim_ap).max())
        f0_same = bit_same(out_k[0], f0_c)
        tail = bool((out_k[2][..., apl:] == 0).all())
        return (f0_same and tail and max(r_sp, r_ap) <= 1.0,
                max_err(zip(out_k, out_p)),
                f"f0 bit-equal to the CPU: {f0_same}; |dlog| within "
                f"decode_limit, worst err/limit sp {r_sp:.3f}, ap "
                f"{r_ap:.3f}; ap zero past bin {apl}: {tail}")

    def check(name, inp, out_k, out_p):
        """(passed, max abs err against the reference, what was held and
        what was read)."""
        if name == "synth_time_base":
            return check_k9(inp, out_k)
        if name == "synth_pulse_spectra":
            return check_k10(inp, out_k, out_p)
        if name == "synth_ola":
            return check_k11(inp, out_k)
        if name == "codec_decode":
            return check_k12(inp, out_k, out_p)
        if name == "dio_candidates":
            return check_k5(inp, out_k, out_p)
        if name == "mlpg_solve":
            return check_k8(inp, out_k, out_p)
        if name == "delta_window":
            return (bool(torch.equal(out_k[0], out_p[0])),
                    float((out_k[0] - out_p[0]).abs().max()), "bit-equal")
        if name == "codec_encode":
            worst, ok, err = 0.0, True, 0.0
            for k, p, lim in zip(out_k, out_p,
                                 encode.encode_spectra_limit(*out_p)):
                e = (k - p).abs()
                ok = ok and bool((e <= lim).all())
                worst = max(worst, float((e / lim).max()))
                err = max(err, float(e.max()))
            return ok, err, (f"|err| <= 1e-5 |plain| + 1e-5 row max |plain| "
                             f"before the c0 offsets: worst err/limit "
                             f"{worst:.3f}")
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

    def primary(name):
        """The path whose launches a kernel's line reports: the first in
        PATHS that runs it."""
        return next(p for p in PATHS if name in PATHS[p])

    summary = {}
    heavy = ("fix_f0", "mlpg_solve", "dio_candidates")  # slow plain twins
    replays = ([("copy_synth", n, i) for n, i in rec_cs]
               + [("feature_lane", n, i) for n, i in rec_fl]
               + [("synth_lane", n, i) for n, i in rec_sl])
    for path, name, inp in replays:
        kern, plain = twins[name]
        debug = dict(crossings=True) if name == "dio_candidates" else {}
        out_k = kern(**inp, **debug)
        out_p = plain(**inp, **debug)
        sync()
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        ok, err, tol = check(name, inp, out_k, out_p)
        ms = cuda_ms(lambda: kern(**inp), reps=10, warm=2)
        plain_ms = cuda_ms(lambda: plain(**inp),
                           reps=1 if name in heavy else 5)
        lib = library(name, inp)
        lib_ms = cuda_ms(lib, reps=10, warm=2) if lib else None
        outs = out_k[:2] if name == "dio_candidates" else out_k
        bms, by = bound_of(name, inp, outs)
        shape = "x".join(str(s) for s in out_k[
            1 if name == "synth_time_base" else 0].shape)
        print(f"{REPLACES[name][0]} {name} ({path}) out {shape}: max_abs_err "
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
        if path != primary(name):
            continue
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["bound_ms"] += bms
        s["by"][by] = s["by"].get(by, 0.0) + bms
        if lib_ms is not None:
            s["lib_ms"] = (s["lib_ms"] or 0.0) + lib_ms
        del out_k, out_p
    del rec_cs, rec_fl, rec_sl, replays
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
    g = [v.cpu().double() for v in feat_mod.feature_lane(xsm, FS)]
    c = [v.double() for v in feat_mod.feature_lane(xsm, FS, device="cpu")]
    vuv = float(((g[0] != 0) == (c[0] != 0)).double().mean())
    both = (g[0] != 0) & (c[0] != 0)
    dlf0 = float((g[0][both] - c[0][both]).abs().median())
    dfeat = [float((a - b).abs().median()) for a, b in zip(g[1:], c[1:])]
    print(f"feature lane, card vs CPU path (2 x 0.5 s): lf0 V/UV agreement "
          f"{vuv:.4f}, med |dlf0| {dlf0:.2e}; med |d| mgc {dfeat[0]:.2e}, "
          f"bap {dfeat[1]:.2e}, traj {dfeat[2]:.2e}", flush=True)
    if not (vuv >= 0.98 and dlf0 <= 1e-3 and max(dfeat) <= 1e-2):
        raise RuntimeError("the card's feature lane disagrees with the CPU "
                           "path")
    # the synth lane on the CPU path's features, with injected noise: the
    # decoded f0 and the pulses must be the same on both
    lf0c, mgcc, bapc = (v.float() for v in c[:3])
    nz = np.random.default_rng(5).standard_normal(
        (2, syn.synthesis_stream_len(ylm)))
    yg = feat_mod.synth_lane(lf0c, mgcc, bapc, FS, noise=nz).cpu().double()
    yc = feat_mod.synth_lane(lf0c, mgcc, bapc, FS, noise=nz,
                             device="cpu").double()
    f0g = decode.decode_features(lf0c.to(dev), mgcc.to(dev), bapc.to(dev),
                                 FS, N)[0]
    f0c = decode.decode_features(lf0c, mgcc, bapc, FS, N)[0]
    Pm = syn.default_max_pulses(ylm, FS)
    pg = syn.time_base(f0g, FRAME_PERIOD, FS, ylm, N, Pm)
    pc = syn.time_base(f0c, FRAME_PERIOD, FS, ylm, N, Pm)
    f0_same = torch.equal(f0g.cpu(), f0c)
    pulses_same = torch.equal(pg.n.cpu(), pc.n) \
        and torch.equal(pg.pidx.cpu(), pc.pidx)
    d_peak = float((yg - yc).abs().max() / yc.abs().max())
    e_rel = float(((yg.pow(2).sum(1) / yc.pow(2).sum(1)) - 1).abs().max())
    print(f"synth lane, card vs CPU path (2 x 0.5 s, injected noise): f0 "
          f"bit-equal {f0_same}, pulses identical {pulses_same} "
          f"({pc.n.tolist()} pulses), max |dy| / peak {d_peak:.2e}, energy "
          f"rel {e_rel:.2e}", flush=True)
    if not (f0_same and pulses_same and d_peak <= 1e-3 and e_rel <= 1e-3):
        raise RuntimeError("the card's synth lane disagrees with the CPU "
                           "path")

    # ---- 5. copy-synthesis stage times and throughput; K5 vs its twin ----
    @contextlib.contextmanager
    def plain_k5():
        """DIO with the plain twin of K5, for the comparison below."""
        dio_mod.band_candidates = dio_mod.band_candidates_plain
        try:
            yield
        finally:
            dio_mod.band_candidates = twins["dio_candidates"][0]

    def stage_ms(stages_fn, runs=3):
        spans = {}
        for _ in range(runs):
            prev = torch.cuda.Event(enable_timing=True)
            prev.record()
            marks = []
            for stage, _ in stages_fn():
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append((stage, e))
            marks[-1][1].synchronize()
            for stage, ev in marks:
                spans.setdefault(stage, []).append(prev.elapsed_time(ev))
                prev = ev
        return {k: float(np.mean(v)) for k, v in spans.items()}

    def cs_stages():
        return batch_mod.copy_synth_stages(xs, FS, FRAME_PERIOD, seed=2)

    sm = stage_ms(cs_stages)
    print("stage ms (mean of 3, B=16 x 2.0 s @ 48 kHz): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sm.items()))

    def throughput(fn, label):
        sync()
        per_batch = []
        for s in range(ITERS):
            t0 = time.perf_counter()
            fn(s)
            sync()
            per_batch.append(time.perf_counter() - t0)
        dt = float(np.mean(per_batch))
        print(f"{label} throughput: {BATCH * DUR / dt:.2f} audio-s/s "
              f"({1e3 * dt:.1f} ms per batch of {BATCH} x {DUR} s, mean of "
              f"{ITERS}; median {1e3 * float(np.median(per_batch)):.1f}, min "
              f"{1e3 * min(per_batch):.1f}, max {1e3 * max(per_batch):.1f} "
              f"ms)", flush=True)

    throughput(lambda s: float(batch_mod.batch_copy_synth(
        xs, FS, seed=10 + s)[4].pow(2).sum()), "copy-synthesis")

    def one_batch():
        batch_mod.batch_copy_synth(xs, FS, seed=20)

    k5_runs = {"twin": [], "K5": []}
    for which in ("twin", "K5", "K5", "twin"):     # in turns
        with plain_k5() if which == "twin" else contextlib.nullcontext():
            dio_ms = stage_ms(cs_stages)["dio"]
            wall, busy, _ = profiled(one_batch)
        k5_runs[which].append((dio_ms, 1 - busy / wall))
        print(f"DIO with {which}: stage {dio_ms:.2f} ms, batch under the "
              f"profiler: wall {1e3 * wall:.1f} ms, device idle "
              f"{100 * (1 - busy / wall):.0f}%", flush=True)
    print("DIO stage ms / device idle share, twin -> K5 (means of 2): "
          + " -> ".join(f"{np.mean([r[0] for r in v]):.2f} ms / "
                        f"{100 * np.mean([r[1] for r in v]):.0f}%"
                        for v in k5_runs.values()))

    # ---- 6. where the device time goes: one batch under the profiler ----
    def report_profile(label, fn):
        wall, busy, evs = profiled(fn)
        if busy <= 0:
            print(f"profiler ({label}): no device time recorded")
            return
        groups = {g: [0.0, 0] for g in ("gemm (DFT matmuls)", "fft",
                                        "K1-K12", "other")}
        for e in evs:
            k = e.key.lower()
            g = ("gemm (DFT matmuls)" if "gemm" in k
                 else "fft" if "fft" in k
                 else "K1-K12" if any(n in k for n in kernels.KERNELS)
                 else "other")
            groups[g][0] += dev_us(e) / 1e3
            groups[g][1] += e.count
        print(f"profiler ({label}): one batch, wall {1e3 * wall:.1f} ms, "
              f"device busy {1e3 * busy:.1f} ms ({100 * busy / wall:.0f}%, "
              f"idle {100 - 100 * busy / wall:.0f}%); by kind: "
              + ", ".join(f"{g} {v:.2f} ms in {n} launches"
                          for g, (v, n) in groups.items()))
        for e in evs[:12]:
            print(f"  {dev_us(e) / 1e3:8.2f} ms  {e.count:5d} x  "
                  f"{e.key[:90]}")

    report_profile("copy-synthesis", one_batch)

    # ---- 7. the feature lane: stage times and throughput ----
    sm = stage_ms(lambda: feat_mod.feature_lane_stages(xs, FS, FRAME_PERIOD))
    print("feature lane stage ms (mean of 3, B=16 x 2.0 s @ 48 kHz): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sm.items()))
    throughput(lambda s: float(feat_mod.feature_lane(xs, FS)[3].sum()),
               "feature lane")
    del xs
    torch.cuda.empty_cache()
    # the synth lane on the feature lane's (lf0, mgc, bap) of the batch
    sm = stage_ms(lambda: feat_mod.synth_lane_stages(*feats, FS, FRAME_PERIOD,
                                                     seed=3))
    print("synth lane stage ms (mean of 3, B=16 x 2.0 s @ 48 kHz): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sm.items()))
    throughput(lambda s: float(feat_mod.synth_lane(
        *feats, FS, seed=30 + s).pow(2).sum()), "synth lane")
    report_profile("synth lane",
                   lambda: feat_mod.synth_lane(*feats, FS, seed=40))
    del feats
    torch.cuda.empty_cache()

    # ---- 8. corpus extraction (corpus500) ----
    sigs = corpus500()
    audio_s = sum(len(s) for s in sigs) / FS
    lengths = [len(s) for s in sigs]
    groups = bucketing.bucket_groups(lengths, max_batch=16)
    print(f"corpus500: {len(sigs)} utterances, {audio_s:.1f} s of audio, "
          f"{len(bucketing.plan_buckets(lengths))} buckets, {len(groups)} "
          f"batches", flush=True)
    bucketing.bucketed_extract(sigs, FS, max_batch=16)          # warm
    t0 = time.perf_counter()
    res, counts_cp, _ = counted(
        "corpus500", lambda: bucketing.bucketed_extract(sigs, FS,
                                                        max_batch=16))
    dt = time.perf_counter() - t0
    print(f"corpus500 throughput: {audio_s / dt:.2f} audio-s/s "
          f"({dt:.2f} s for {audio_s:.1f} s of audio, one timed run after "
          f"one warm run)", flush=True)
    if len(res) != len(sigs) or any(
            r[0].shape[0] != cfg.samples_for_dio(FS, n, FRAME_PERIOD)
            for r, n in zip(res, lengths)):
        raise RuntimeError("corpus500: unexpected frame counts")
    check_features(*(torch.as_tensor(np.concatenate([r[k] for r in res]))
                     for k in range(3)), label="corpus500 outputs")
    # host-side padding and trimming of the same groups, alone
    t_pad = t_trim = 0.0
    Tb = {blen: cfg.samples_for_dio(FS, blen, FRAME_PERIOD)
          for blen, _ in groups}
    for blen, grp in groups:
        t0 = time.perf_counter()
        bucketing.pad_group(sigs, grp, blen)
        t_pad += time.perf_counter() - t0
        fake = [np.zeros((len(grp), Tb[blen]), np.float32),
                np.zeros((len(grp), Tb[blen], 50), np.float32),
                np.zeros((len(grp), Tb[blen], 25), np.float32)]
        t0 = time.perf_counter()
        bucketing.trim_group(fake, lengths, grp, FS, FRAME_PERIOD)
        t_trim += time.perf_counter() - t0
    print(f"corpus500 host time: padding {1e3 * t_pad:.1f} ms, trimming "
          f"{1e3 * t_trim:.1f} ms over {len(groups)} batches")
    blen, grp = max(groups, key=lambda g: g[0] * len(g[1]))
    wall, busy, _ = profiled(lambda: bucketing.bucketed_extract(
        [sigs[i] for i in grp], FS, max_batch=16))
    print(f"corpus500 one bucket group ({len(grp)} x {blen} samples) under "
          f"the profiler: wall {1e3 * wall:.1f} ms, device busy "
          f"{1e3 * busy:.1f} ms ({100 * busy / wall:.0f}%)", flush=True)

    print(smi)
    src = "hts_train_world_tpu_torch/csrc/"
    by_path = {"copy_synth": counts_cs, "feature_lane": counts_fl,
               "synth_lane": counts_sl, "corpus500": counts_cp}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": src + kernels.KERNELS[name][0],
         "replaces": REPLACES[name][1],
         "launches": by_path[primary(name)][name],
         "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": max(s["by"], key=s["by"].get),
         "library_ms": s["lib_ms"],
         "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()}}
        for name, s in summary.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
