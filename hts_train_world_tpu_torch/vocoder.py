"""High-level WORLD vocoder API of the port.

Counterpart of `hts_train_world_tpu/vocoder.py`.  parity=False is the f32
fast path: noise-free analysis on the regular frame grid, cumsum phase and
`torch.Generator` noise in synthesis.  parity=True is the f64 path with
the reference's PRNG streams: `synthesize(parity=True)` runs the exact
path (the sequential phase fold, FFT responses, the reseeded stream)
through K9-K11 and K30 in float64; parity analysis (`analyze`,
`copy_synthesis`) is a later slice of the port and raises.
"""
from __future__ import annotations

import dataclasses

import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.ops import cheaptrick as ct
from hts_train_world_tpu_torch.ops import d4c as d4c_mod
from hts_train_world_tpu_torch.ops import dio as dio_mod
from hts_train_world_tpu_torch.ops import harvest as hv
from hts_train_world_tpu_torch.ops import prims, rand
from hts_train_world_tpu_torch.ops import stonemask as sm
from hts_train_world_tpu_torch.ops import synthesis as syn
from hts_train_world_tpu_torch.parallel import batch as batch_mod

_PARITY = ("parity=True analysis (the f64 path with the reference's PRNG "
           "streams in CheapTrick and D4C) is not ported yet; see "
           "ROADMAP.md, Queue A 5's analysis half.  Pass parity=False.")


@dataclasses.dataclass
class WorldAnalysis:
    temporal_positions: torch.Tensor
    f0: torch.Tensor            # refined (StoneMask or Harvest) F0, 0 = unvoiced
    spectrogram: torch.Tensor   # (T, fft/2+1) power-ish spectral envelope
    aperiodicity: torch.Tensor  # (T, fft/2+1) in [0, 1)
    fs: int
    fft_size: int
    frame_period: float


def analyze(x, fs: int, frame_period: float = 5.0, q1: float = -0.15,
            d4c_threshold: float = 0.0, parity: bool = True,
            fft_size: int = 0, algorithm: str = "dio",
            f0_floor: float = cfg.K_FLOOR_F0,
            f0_ceil: float = cfg.K_CEIL_F0,
            device="cuda") -> WorldAnalysis:
    """DIO + StoneMask, or Harvest (its refinement is built in, so no
    StoneMask; harvest.cpp:1223-1255), then CheapTrick + D4C of one
    waveform (float32)."""
    if parity:
        raise NotImplementedError(_PARITY)
    batch_mod.check_algorithm(algorithm)
    xs = device_mod.as_input(x, device)[None]
    gs = batch_mod.grid_step_for(fs, frame_period)
    N = fft_size or cfg.cheaptrick_fft_size(fs)
    if algorithm == "harvest":
        t, f0 = hv.harvest(xs, fs, frame_period, f0_floor, f0_ceil)
    else:
        t, f0, _, _ = dio_mod.dio(xs, fs, frame_period, f0_floor, f0_ceil)
        f0 = sm.stonemask(xs, fs, t, f0, f0_floor, f0_ceil, grid_step=gs)
    sp = ct.cheaptrick(xs, fs, t, f0, N, q1, grid_step=gs)
    ap, _ = d4c_mod.d4c(xs, fs, t, f0, N, d4c_threshold, f0_floor=f0_floor,
                        grid_step=gs)
    return WorldAnalysis(t, f0[0], sp[0], ap[0], fs, N, frame_period)


def synthesize(f0, spectrogram, aperiodicity, fs: int, fft_size: int = 0,
               frame_period: float = 5.0, y_length: int = 0,
               parity: bool = True, seed: int = 0, device="cuda"):
    """Synthesis (synth.cpp:97-108) of one utterance; y_length 0 ->
    (T-1)*fp*fs+1.  parity=True: float64, the exact path on the
    reference's reseeded noise stream; parity=False: the fast path in the
    input's dtype, the noise drawn from `seed` on the device."""
    dev = device_mod.resolve(device)
    sp = torch.as_tensor(spectrogram, device=dev,
                         dtype=torch.float64 if parity else None)
    f0 = torch.as_tensor(f0, dtype=sp.dtype, device=dev)
    ap = torch.as_tensor(aperiodicity, dtype=sp.dtype, device=dev)
    N = fft_size or cfg.cheaptrick_fft_size(fs)
    if not y_length:
        y_length = cfg.y_length_for(f0.shape[0], frame_period, fs)
    if parity:
        stream = rand.randn_stream(syn.synthesis_stream_len(y_length), dev)
        return syn.synthesis(f0[None], sp[None], ap[None], N, frame_period,
                             fs, y_length, stream[None], exact=True)[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    stream = batch_mod.synthesis_noise_batch(gen, 1, y_length, sp.dtype)
    return syn.synthesis(f0[None], sp[None], ap[None], N, frame_period, fs,
                         y_length, stream)[0]


def modify_parameters(f0, spectrogram, fs: int, f0_scale: float = 1.0,
                      formant_ratio: float = 1.0):
    """The test demo's voice-change knobs (test/test.cpp:200-237): F0
    scaling and spectral stretching by log-spectrum resampling along a
    scaled frequency axis; for ratio < 1 the tail above N/2*ratio holds
    the last stretched bin."""
    f0 = f0 * f0_scale
    if formant_ratio == 1.0:
        return f0, spectrogram
    sp = spectrogram
    half = sp.shape[1] - 1
    N = 2 * half
    i = torch.arange(half + 1, dtype=sp.dtype, device=sp.device)
    axis1 = prims.exact_div(formant_ratio * i, N) * fs
    axis2 = prims.exact_div(i, N) * fs
    out = torch.exp(prims.interp1(axis1, torch.log(sp), axis2))
    if formant_ratio < 1.0:
        cut = int(N / 2.0 * formant_ratio)
        out = torch.cat([out[:, :cut],
                         out[:, cut - 1:cut].expand(-1, half + 1 - cut)],
                        dim=1)
    return f0, out


def copy_synthesis(x, fs: int, frame_period: float = 5.0,
                   parity: bool = True, f0_scale: float = 1.0,
                   formant_ratio: float = 1.0, device="cuda"):
    """Analysis -> resynthesis round trip (test/test.cpp) with its
    optional F0 / formant knobs."""
    if parity:
        raise NotImplementedError(_PARITY)
    a = analyze(x, fs, frame_period, parity=False, device=device)
    f0, sp = modify_parameters(a.f0, a.spectrogram, fs, f0_scale,
                               formant_ratio)
    y = synthesize(f0, sp, a.aperiodicity, fs, a.fft_size, frame_period,
                   parity=False, device=a.f0.device)
    return a, y
