"""Device selection for the port's entry points.

Entry points run on the card (`device="cuda"`, the default) unless the
caller asks for the CPU, where every kernel runs as its plain PyTorch
version.  A missing card is an error, never a silent move to the CPU.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    return dev


def as_input(x, device="cuda") -> torch.Tensor:
    """A waveform (batch) as a float32 tensor on `device`."""
    return torch.as_tensor(x, dtype=torch.float32, device=resolve(device))
