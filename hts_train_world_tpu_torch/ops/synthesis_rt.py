"""Streaming (real-time) WORLD synthesizer on a device.

Counterpart of `hts_train_world_tpu/ops/synthesis_rt.py`
(externs/WORLD_v2/src/synthesisrealtime.cpp) with its API and its
contract: the concatenated stream equals the exact-path batch synthesis
(`synthesis(..., exact=True)`) on the same noise stream.

- `add_parameters(f0, sp, ap)` appends frames (AddParameters) to
  device buffers that grow by doubling, so a longer utterance costs no
  new shapes per frame count;
- `read()` synthesises one chunk of `buffer_size` samples and returns the
  newly finished samples as a float64 tensor on the synthesizer's device
  (possibly empty), or None while `starved` (the IsLocked analogue);
- `refresh()` resets it (RefreshSynthesizer).

Per chunk, all on the device and with no host sync: K9's chunk mode
(the phase carried in and out, the pending pulse whose noise size needs
the next chunk, the stream base; `ops/synthesis.chunk_pulses`), K10, the
FFTs and K30 (`synthesis.responses_exact`), and K11 adding the responses
into an overlap-add window of not yet emitted samples.  Emission keeps
the JAX watermark: a later pulse writes no earlier than `processed -
fft_size`, so the latency is fft_size samples.
"""
from __future__ import annotations

import numpy as np
import torch

from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch.ops import synthesis as syn


class StreamingSynthesizer:
    """InitializeSynthesizer / AddParameters / Synthesis2 contract
    (synthesisrealtime.h:90-148) with exact batch equivalence."""

    def __init__(self, fs: int, frame_period: float = 5.0,
                 fft_size: int = 0, buffer_size: int = 1024,
                 noise_stream=None, device="cuda"):
        self.device = device_mod.resolve(device)
        self.fs = fs
        self.frame_period = frame_period
        self.fft_size = fft_size or cfg.cheaptrick_fft_size(fs)
        self.buffer_size = buffer_size
        if buffer_size < 2:
            raise ValueError("buffer_size must be at least 2 samples")
        self.noise_stream = torch.as_tensor(
            np.zeros(1) if noise_stream is None else noise_stream,
            dtype=torch.float64, device=self.device).reshape(-1)
        self.max_pulses = int(buffer_size * 1200.0 / fs) + 18
        self._reset_state()

    def _reset_state(self):
        dev = self.device
        self._T = 0
        self._f0 = torch.zeros(0, dtype=torch.float64, device=dev)
        self._sp = self._ap = None
        self._state_d, self._state_i = syn.chunk_state(dev)
        self._processed = 0     # samples whose pulses are detected
        # the overlap-add window: global samples [acc_base, acc_base + L),
        # L covering a chunk's responses past the last emitted sample
        self._acc_len = self.buffer_size + 2 * self.fft_size
        self._acc = torch.zeros((1, self._acc_len), dtype=torch.float64,
                                device=dev)
        self._acc_base = 0

    def _append(self, buf, rows):
        """rows appended after self._T rows of buf (capacity doubled)."""
        need = self._T + rows.shape[0]
        if buf is None or buf.shape[0] < need:
            cap = max(need, 2 * (0 if buf is None else buf.shape[0]), 64)
            new = torch.zeros((cap,) + tuple(rows.shape[1:]),
                              dtype=torch.float64, device=self.device)
            if buf is not None:
                new[:self._T] = buf[:self._T]
            buf = new
        buf[self._T:need] = rows
        return buf

    def add_parameters(self, f0, spectrogram, aperiodicity) -> None:
        dev = self.device
        f0 = torch.as_tensor(f0, dtype=torch.float64, device=dev).reshape(-1)
        sp = torch.as_tensor(spectrogram, dtype=torch.float64, device=dev)
        ap = torch.as_tensor(aperiodicity, dtype=torch.float64, device=dev)
        sp, ap = sp.reshape(-1, sp.shape[-1]), ap.reshape(-1, ap.shape[-1])
        self._f0 = self._append(self._f0, f0)
        self._sp = self._append(self._sp, sp)
        self._ap = self._append(self._ap, ap)
        self._T += f0.shape[0]

    @property
    def starved(self) -> bool:
        fp_samples = self.frame_period / 1000.0 * self.fs
        covered = (self._T - 1) * fp_samples
        return covered < self._processed + self.buffer_size

    def read(self):
        """Process one chunk and return the newly finished samples (a
        float64 tensor on the device, possibly empty); None while
        starved."""
        if self.starved:
            return None
        chunk, N, T = self.buffer_size, self.fft_size, self._T
        pl = syn.chunk_pulses(self._f0[:T], self._processed, chunk,
                              self.max_pulses, self.frame_period, self.fs,
                              N, self._state_d, self._state_i)
        log_p, log_a, noise, unvoiced = syn.pulse_spectra(
            self._sp[None, :T], self._ap[None, :T],
            self.noise_stream[None], pl.pulse_time, pl.vuv, pl.noise_size,
            pl.noise_off, self.frame_period, N, exact=True)
        per_raw, aper_raw = syn.responses_exact(
            log_p, log_a, noise, pl.time_shift, self.fs, N)
        syn.overlap_add(per_raw, aper_raw, unvoiced, pl.pidx, pl.noise_size,
                        pl.counts[1:], self._acc_len, self._acc_base,
                        self._acc)
        self._processed += chunk
        # emission watermark: any later pulse writes at >= processed - N
        emit_upto = max(self._processed - N, 0)
        d = emit_upto - self._acc_base
        out = self._acc[0, :d].clone()
        if d:
            acc = torch.zeros_like(self._acc)
            acc[:, :self._acc_len - d] = self._acc[:, d:]
            self._acc = acc
        self._acc_base = emit_upto
        return out

    def refresh(self) -> None:
        """RefreshSynthesizer (synthesisrealtime.h:114)."""
        self._reset_state()
