"""WORLD parameter file formats (test/parameterio.cpp): tagged binary
files F0/SPEC/AP with 4-char field tags, the parity path's file format.

The port's own copy of `hts_train_world_tpu/io/worldparam.py` (numpy
only); both write the same bytes.

Layout (parameterio.cpp:72-226):
  F0  : "F0  " | "NOF " int32 | "FP  " float64 | f0 float64[NOF]
  SPEC: "SPEC" | "NOF " int32 | "FP  " float64 | "FFT " int32 |
        "NOD " int32 | "FS  " int32 | rows float64[NOF x dims]
  AP  : same as SPEC with tag "AP  "
"""
from __future__ import annotations

import struct

import numpy as np


def _f64(x) -> np.ndarray:
    """An array or a tensor (on any device) as float64 numpy."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)


def write_f0(path: str, f0, frame_period: float, text: bool = False,
             temporal_positions=None) -> None:
    f0 = _f64(f0)
    if text:
        t = (np.asarray(temporal_positions) if temporal_positions is not None
             else np.arange(len(f0)) * frame_period / 1000.0)
        with open(path, "w", newline="") as f:
            for ti, fi in zip(t, f0):
                f.write(f"{ti:.5f} {fi:.5f}\r\n")
        return
    with open(path, "wb") as f:
        f.write(b"F0  ")
        f.write(b"NOF " + struct.pack("<i", len(f0)))
        f.write(b"FP  " + struct.pack("<d", frame_period))
        f0.tofile(f)


def read_f0(path: str):
    with open(path, "rb") as f:
        assert f.read(4) == b"F0  "
        assert f.read(4) == b"NOF "
        (nof,) = struct.unpack("<i", f.read(4))
        assert f.read(4) == b"FP  "
        (fp,) = struct.unpack("<d", f.read(8))
        f0 = np.fromfile(f, np.float64, nof)
    t = np.arange(nof) * fp / 1000.0
    return t, f0, fp


def _write_matrix(path: str, tag: bytes, data, frame_period: float,
                  fft_size: int, fs: int, n_dims: int = 0) -> None:
    data = _f64(data)
    dims = n_dims or data.shape[1]
    with open(path, "wb") as f:
        f.write(tag)
        f.write(b"NOF " + struct.pack("<i", data.shape[0]))
        f.write(b"FP  " + struct.pack("<d", frame_period))
        f.write(b"FFT " + struct.pack("<i", fft_size))
        f.write(b"NOD " + struct.pack("<i", n_dims))
        f.write(b"FS  " + struct.pack("<i", fs))
        data[:, :dims].tofile(f)


def write_spectral_envelope(path, sp, frame_period, fft_size, fs,
                            n_dims: int = 0):
    _write_matrix(path, b"SPEC", sp, frame_period, fft_size, fs, n_dims)


def write_aperiodicity(path, ap, frame_period, fft_size, fs,
                       n_dims: int = 0):
    _write_matrix(path, b"AP  ", ap, frame_period, fft_size, fs, n_dims)


def _read_matrix(path: str, tag: bytes):
    with open(path, "rb") as f:
        assert f.read(4) == tag
        f.read(4)
        (nof,) = struct.unpack("<i", f.read(4))
        f.read(4)
        (fp,) = struct.unpack("<d", f.read(8))
        f.read(4)
        (fft,) = struct.unpack("<i", f.read(4))
        f.read(4)
        (nod,) = struct.unpack("<i", f.read(4))
        f.read(4)
        (fs,) = struct.unpack("<i", f.read(4))
        dims = nod if nod else fft // 2 + 1
        data = np.fromfile(f, np.float64).reshape(nof, dims)
    return data, fp, fft, fs


def read_spectral_envelope(path):
    return _read_matrix(path, b"SPEC")


def read_aperiodicity(path):
    return _read_matrix(path, b"AP  ")
