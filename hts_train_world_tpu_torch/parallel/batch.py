"""Batched WORLD analysis, synthesis and copy-synthesis on one device.

Counterpart of `hts_train_world_tpu/parallel/batch.py` (fast mode): a
batch of equal-length utterances runs through DIO -> StoneMask (or
Harvest, whose refinement is built in, so no StoneMask) -> CheapTrick ->
D4C as batched tensors, at any frame grid (on a grid of a whole number of
samples the JAX package's slab windows, on any other, such as 44.1 or
22.05 kHz at 5 ms, its generic float32 windows); synthesis reads the exact pulse count once on the
host (kernel K9, the arithmetic synthesis itself runs) and runs at a
128-aligned pulse bucket of that count plus slack.  `parity_stages` is
the float64 parity analysis of a batch (the JAX package's default), on
the reference's noise streams.
"""
from __future__ import annotations

import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.ops import cheaptrick as ct
from hts_train_world_tpu_torch.ops import d4c as d4c_mod
from hts_train_world_tpu_torch.ops import dio as dio_mod
from hts_train_world_tpu_torch.ops import harvest as hv
from hts_train_world_tpu_torch.ops import rand
from hts_train_world_tpu_torch.ops import stonemask as sm
from hts_train_world_tpu_torch.ops import synthesis as syn


def analyze_stages(xs, fs: int, frame_period: float = 5.0,
                   d4c_threshold: float = 0.0, algorithm: str = "dio"):
    """The analysis stages one after another, yielding (stage name,
    result); the last result is (t, f0, sp, ap).  DIO's stages are "dio"
    and "stonemask"; Harvest's are those of `harvest.harvest_f0_stages`,
    then "harvest", the 1 ms contour picked onto the frame grid in
    float64 on the host (harvest.cpp:1246-1251)."""
    check_algorithm(algorithm)
    gs = cfg.grid_step(fs, frame_period)    # 0: each frame at its position
    N = cfg.cheaptrick_fft_size(fs)
    if algorithm == "harvest":
        for stage, f0_1ms in hv.harvest_f0_stages(xs, fs):
            yield stage, f0_1ms
        t, f0 = hv.frame_pick(f0_1ms, fs, xs.shape[1], frame_period)
        yield "harvest", f0
    else:
        t, f0, _, _ = dio_mod.dio(xs, fs, frame_period)
        yield "dio", f0
        f0 = sm.stonemask(xs, fs, t, f0, grid_step=gs)
        yield "stonemask", f0
    sp = ct.cheaptrick(xs, fs, t, f0, N, grid_step=gs)
    yield "cheaptrick", sp
    ap, _ = d4c_mod.d4c(xs, fs, t, f0, N, d4c_threshold, grid_step=gs)
    yield "d4c", (t.expand(f0.shape), f0, sp, ap)


def parity_stages(xs, fs: int, frame_period: float = 5.0,
                  q1: float = -0.15, d4c_threshold: float = 0.0,
                  fft_size: int = 0, f0_floor: float = cfg.K_FLOOR_F0,
                  f0_ceil: float = cfg.K_CEIL_F0, algorithm: str = "dio"):
    """The parity analysis (the JAX package's vocoder.analyze at
    parity=True, in float64) of equal-length utterances xs (B, L), stage
    by stage, yielding (stage name, result): "dio" and "stonemask", or
    Harvest's stages (`harvest.harvest_f0_stages` in float64, then
    "harvest", the 1 ms contour picked onto the frame grid), then
    "cheaptrick", then "d4c" with (t (B, T), f0, sp, ap).  Each window
    sits at its own position, so any frame grid runs.  CheapTrick and D4C
    read the reference's reseeded noise stream, each utterance from its
    start: one float64 tensor on the device serves the batch."""
    check_algorithm(algorithm)
    if xs.dtype != torch.float64:
        raise ValueError("parity analysis takes float64 waveforms")
    dev = xs.device
    N = fft_size or cfg.cheaptrick_fft_size(fs)
    if algorithm == "harvest":
        for stage, f0_1ms in hv.harvest_f0_stages(xs, fs, f0_floor, f0_ceil):
            yield stage, f0_1ms
        t, f0 = hv.frame_pick(f0_1ms, fs, xs.shape[1], frame_period)
        yield "harvest", f0
    else:
        t, f0, _, _ = dio_mod.dio(xs, fs, frame_period, f0_floor, f0_ceil,
                                  parity=True)
        yield "dio", f0
        f0 = sm.stonemask(xs, fs, t, f0, f0_floor, f0_ceil, parity=True)
        yield "stonemask", f0
    T = f0.shape[1]
    sp = ct.cheaptrick_parity(
        xs, fs, t, f0, N, q1,
        rand.randn_stream(ct.cheaptrick_stream_len(T, N), dev))
    yield "cheaptrick", sp
    ap, _ = d4c_mod.d4c_parity(
        xs, fs, t, f0, N, d4c_threshold,
        rand.randn_stream(d4c_mod.d4c_stream_len(T, fs), dev))
    yield "d4c", (t.expand(f0.shape), f0, sp, ap)


def check_algorithm(algorithm: str) -> None:
    if algorithm not in ("dio", "harvest"):
        raise ValueError(f"unknown f0 algorithm {algorithm!r}")


def batch_analyze(xs, fs: int, frame_period: float = 5.0,
                  d4c_threshold: float = 0.0, algorithm: str = "dio",
                  device="cuda"):
    """xs: (B, L) equal-length utterances -> batched (t, f0, sp, ap) on
    `device` (f32 fast mode); `algorithm` "dio" or "harvest"."""
    xs = device_mod.as_input(xs, device)
    *_, (_, out) = analyze_stages(xs, fs, frame_period, d4c_threshold,
                                  algorithm)
    return out


def _pulse_bucket(n: int, cap: int) -> int:
    """Smallest 128-aligned bucket >= n (bounded by the worst case)."""
    return min(cap, -(-max(n, 1) // 128) * 128)


def pulse_bucket(f0, fs: int, frame_period: float, y_length: int) -> int:
    """The synthesis pulse cap for a batch: its exact largest pulse count
    (one host read of K9's count, the arithmetic synthesis runs) + 8
    slack, 128-aligned, as the JAX package sizes it."""
    N = cfg.cheaptrick_fft_size(fs)
    ncs = syn.count_pulses(f0, frame_period, fs, y_length, N)
    return _pulse_bucket(int(ncs.max().item()) + 8,
                         syn.default_max_pulses(y_length, fs))


def synthesis_noise_batch(generator: torch.Generator, batch: int,
                          y_length: int, dtype=torch.float32):
    """White noise for fast-mode synthesis, drawn on the generator's
    device."""
    return torch.randn((batch, syn.synthesis_stream_len(y_length)),
                       generator=generator, dtype=dtype,
                       device=generator.device)


def synth_stages(f0, sp, ap, fs: int, frame_period: float = 5.0,
                 noise=None, seed: int = 0):
    """Batched synthesis one stage at a time on f0's device, yielding
    (stage name, result): "count" (the pulse bucket) and "synthesis" (the
    waveform (B, y_length), y_length from the frame count as synth.cpp
    sizes it).  `noise` (B, y_length+16) is drawn from `seed` when not
    given."""
    B, T = f0.shape
    yl = cfg.y_length_for(T, frame_period, fs)
    bucket = pulse_bucket(f0, fs, frame_period, yl)
    yield "count", bucket
    if noise is None:
        gen = torch.Generator(device=f0.device).manual_seed(seed)
        noise = synthesis_noise_batch(gen, B, yl, sp.dtype)
    else:
        noise = torch.as_tensor(noise, dtype=sp.dtype, device=f0.device)
    yield "synthesis", syn.synthesis(f0, sp, ap, cfg.cheaptrick_fft_size(fs),
                                     frame_period, fs, yl, noise, bucket)


def batch_synth(f0, sp, ap, fs: int, frame_period: float = 5.0, noise=None,
                seed: int = 0, device="cuda"):
    """Batched synthesis of f0 (B, T), sp and ap (B, T, N/2+1) on
    `device` (f32 fast mode): ONE host read of the exact per-batch pulse
    count, then synthesis at the bucketed pulse cap -> (B, y_length)."""
    f0, sp, ap = (device_mod.as_input(v, device) for v in (f0, sp, ap))
    *_, (_, y) = synth_stages(f0, sp, ap, fs, frame_period, noise, seed)
    return y


def copy_synth_stages(xs, fs: int, frame_period: float = 5.0,
                      d4c_threshold: float = 0.0, noise=None, seed: int = 0,
                      algorithm: str = "dio"):
    """`batch_copy_synth` one stage at a time on xs's device, yielding
    (stage name, result): the analysis stages, then those of
    `synth_stages`, the last result being (t, f0, sp, ap, y)."""
    for stage, out in analyze_stages(xs, fs, frame_period, d4c_threshold,
                                     algorithm):
        yield stage, out
    t, f0, sp, ap = out
    for stage, res in synth_stages(f0, sp, ap, fs, frame_period, noise,
                                   seed):
        yield stage, ((t, f0, sp, ap, res) if stage == "synthesis" else res)


def batch_copy_synth(xs, fs: int, frame_period: float = 5.0,
                     d4c_threshold: float = 0.0, algorithm: str = "dio",
                     noise=None, seed: int = 0, device="cuda"):
    """Batched copy-synthesis: analysis, ONE host read of the exact
    per-batch pulse count, then synthesis at the bucketed pulse cap.
    `noise` (B, y_length+16) is drawn from `seed` when not given.
    Returns (t, f0, sp, ap, y)."""
    xs = device_mod.as_input(xs, device)
    *_, (_, out) = copy_synth_stages(xs, fs, frame_period, d4c_threshold,
                                     noise, seed, algorithm)
    return out
