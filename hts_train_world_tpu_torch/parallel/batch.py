"""Batched WORLD analysis, synthesis and copy-synthesis on one device.

Counterpart of `hts_train_world_tpu/parallel/batch.py` (algorithm="dio",
fast mode): a batch of equal-length utterances runs through DIO ->
StoneMask -> CheapTrick -> D4C as batched tensors; synthesis reads the
exact pulse count once on the host (kernel K9, the arithmetic synthesis
itself runs) and runs at a 128-aligned pulse bucket of that count plus
slack.
"""
from __future__ import annotations

import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.ops import cheaptrick as ct
from hts_train_world_tpu_torch.ops import d4c as d4c_mod
from hts_train_world_tpu_torch.ops import dio as dio_mod
from hts_train_world_tpu_torch.ops import stonemask as sm
from hts_train_world_tpu_torch.ops import synthesis as syn


def grid_step_for(fs: int, frame_period: float) -> int:
    """Samples per frame; the fast path needs an integral number."""
    gs = cfg.grid_step(fs, frame_period)
    if not gs:
        raise NotImplementedError(
            "the port's fast path needs an integral number of samples per "
            f"frame (fs={fs}, frame_period={frame_period})")
    return gs


def analyze_stages(xs, fs: int, frame_period: float = 5.0,
                   d4c_threshold: float = 0.0):
    """The four analysis stages one after another, yielding
    (stage name, result); the last result is (t, f0, sp, ap)."""
    gs = grid_step_for(fs, frame_period)
    N = cfg.cheaptrick_fft_size(fs)
    t, f0, _, _ = dio_mod.dio(xs, fs, frame_period)
    yield "dio", f0
    f0 = sm.stonemask(xs, fs, t, f0, grid_step=gs)
    yield "stonemask", f0
    sp = ct.cheaptrick(xs, fs, t, f0, N, grid_step=gs)
    yield "cheaptrick", sp
    ap, _ = d4c_mod.d4c(xs, fs, t, f0, N, d4c_threshold, grid_step=gs)
    yield "d4c", (t.expand(f0.shape), f0, sp, ap)


def check_algorithm(algorithm: str) -> None:
    if algorithm != "dio":
        raise NotImplementedError(
            f"f0 algorithm {algorithm!r}: the port has DIO only so far "
            "(Harvest is queued in ROADMAP.md)")


def batch_analyze(xs, fs: int, frame_period: float = 5.0,
                  d4c_threshold: float = 0.0, algorithm: str = "dio",
                  device="cuda"):
    """xs: (B, L) equal-length utterances -> batched (t, f0, sp, ap) on
    `device` (f32 fast mode)."""
    check_algorithm(algorithm)
    xs = device_mod.as_input(xs, device)
    *_, (_, out) = analyze_stages(xs, fs, frame_period, d4c_threshold)
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
                      d4c_threshold: float = 0.0, noise=None, seed: int = 0):
    """`batch_copy_synth` one stage at a time on xs's device, yielding
    (stage name, result): the analysis stages, then those of
    `synth_stages`, the last result being (t, f0, sp, ap, y)."""
    for stage, out in analyze_stages(xs, fs, frame_period, d4c_threshold):
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
    check_algorithm(algorithm)
    xs = device_mod.as_input(xs, device)
    *_, (_, out) = copy_synth_stages(xs, fs, frame_period, d4c_threshold,
                                     noise, seed)
    return out
