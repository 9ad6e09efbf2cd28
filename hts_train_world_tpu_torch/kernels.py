"""Build, load and launch the hand-written CUDA kernels.

Thirty kernels, K1-K30 (`KERNELS`).  Each source under `csrc/` is
compiled by `nvcc` for `sm_90a` into its own shared library with a plain
C interface, loaded with `ctypes`.  Nothing
happens at import time: the first launch builds every kernel (one `nvcc`
per source, all started together) into `<repo>/.torch_ext_build/<hash>/`,
keyed by a hash of the sources and flags, so an unchanged tree reuses the
libraries.

Every launcher returns the `cudaError_t` of `cudaGetLastError()` after the
launch; `launch` raises on anything but success.  `launches` counts each
kernel's launches (and nothing else), so a run can show that the main
path went through the kernels.  When `record` is a list, each launch also
appends `(name, inputs)` to it, so the inputs the main path gave a kernel
can be replayed through the kernel and its plain version.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".torch_ext_build")

NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong

# kernel name -> (source file, C launcher, argtypes), or (source file,
# {C launcher: argtypes}) for a kernel with a launcher for each stage
KERNELS = {
    "frame_window": ("frame_window.cu", "frame_window_launch",
                     [_P, _I, _I, _P, _P, _P, _P, _F, _F, _I, _I, _I, _P,
                      _P]),
    "spectral_smooth": ("spectral_smooth.cu", "spectral_smooth_launch",
                        [_P, _I, _I, _P, _P, _F, _F, _I, _I, _P]),
    "topk_sum": ("topk_sum.cu", "topk_sum_launch",
                 [_P, _I, _I, _I, _P, _P]),
    "fix_f0": ("fix_f0.cu", "fix_f0_launch",
               [_P, _P, _I, _I, _I, _I, _F, _P, _P]),
    "dio_candidates": ("dio_candidates.cu", "dio_candidates_launch",
                       [_P, _I, _I, _I, _I, _P, _P, _F, _F, _F, _I, _F, _I,
                        _P, _P, _P, _P, _P]),
    "codec_encode": ("codec_encode.cu", "codec_encode_launch",
                     [_P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P]),
    "delta_window": ("delta_window.cu", "delta_window_launch",
                     [_P, _I, _I, _I, _P, _P, _I, _I, _I, _P]),
    "mlpg_solve": ("mlpg_solve.cu", "mlpg_solve_launch",
                   [_P, _P, _I, _I, _I, _I, _P, _I, _P, _P]),
    "synth_time_base": ("synth_time_base.cu", {
        "synth_time_base_launch": [_P, _I, _I, _I, _I, _D, _D, _D, _I]
        + [_P] * 7,
        "synth_time_base_chunk_launch": [_P, _I, _L, _I, _I, _D, _D, _D]
        + [_P] * 9}),
    "synth_pulse_spectra": ("synth_pulse_spectra.cu",
                            "synth_pulse_spectra_launch",
                            [_P, _P, _I, _I, _I, _P, _I, _L, _P, _P, _P, _P,
                             _I, _I, _D, _D, _I, _I, _P, _P, _P, _P]),
    "synth_ola": ("synth_ola.cu", "synth_ola_launch",
                  [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _L, _I, _I,
                   _P, _P]),
    "codec_decode": ("codec_decode.cu", "codec_decode_launch",
                     [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                      _P, _P, _P]),
    "harvest_decimate": ("harvest_decimate.cu", "harvest_decimate_launch",
                         [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "harvest_candidates": ("harvest_candidates.cu",
                           "harvest_candidates_launch",
                           [_P, _I, _I, _I, _I, _P, _P, _F, _F, _F, _I, _F,
                            _I, _P, _P, _P, _P]),
    "harvest_refine": ("harvest_refine.cu", "harvest_refine_launch",
                       [_P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _F, _F, _P,
                        _P]),
    "harvest_contour": ("harvest_contour.cu", "harvest_contour_launch",
                        [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P, _P, _P]),
    "hsmm_loglik": ("hsmm_loglik.cu", "hsmm_loglik_launch",
                    [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "hsmm_fb": ("hsmm_fb.cu", "hsmm_fb_launch",
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _P, _P, _P, _P, _P,
                 _P, _P]),
    "hsmm_accumulate": ("hsmm_accumulate.cu", "hsmm_accumulate_launch",
                        [_P, _P, _I, _I, _I, _P]),
    "hsmm_viterbi": ("hsmm_viterbi.cu", "hsmm_viterbi_launch",
                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                      _P]),
    "mspf": ("mspf.cu", "mspf_launch",
             [_P, _I, _I, _I, _P, _P, _P, _P, _D, _I, _P, _P, _P, _P]),
    "mcep_postfilter": ("mcep_postfilter.cu", "mcep_postfilter_launch",
                        [_P, _I, _I, _P, _I, _D, _P]),
    "gv_scale": ("gv_scale.cu", "gv_scale_launch",
                 [_P, _I, _I, _P, _D, _P, _P]),
    "stonemask_if": ("stonemask_if.cu", "stonemask_if_launch",
                     [_P, _P, _P, _P, _I, _I, _P, _P, _P, _F, _I, _P]),
    "cheaptrick_lifter": ("cheaptrick_lifter.cu", "cheaptrick_lifter_launch",
                          [_I, _P, _P, _I, _I, _F, _I, _F, _F, _F, _P]),
    "d4c_group_delay": ("d4c_group_delay.cu", {
        "d4c_love_train_launch": [_P, _I, _I, _I, _I, _I, _P, _F, _F, _P, _P,
                                  _P],
        "d4c_centroid_launch": [_P] * 8 + [_I, _I, _P],
        "d4c_ratio_launch": [_P, _P, _I, _I, _P],
        "d4c_segments_launch": [_P, _P, _I, _I, _P, _I, _P, _I, _P]}),
    "d4c_aperiodicity": ("d4c_aperiodicity.cu", "d4c_aperiodicity_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _P, _P]),
    "trajectory_nll": ("trajectory_nll.cu", "trajectory_nll_launch",
                       [_P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P]),
    "trajectory_adjoint": ("trajectory_adjoint.cu",
                           "trajectory_adjoint_launch",
                           [_P] * 8 + [_I, _I, _I, _I, _P, _I, _P, _P, _P]),
    "synth_midpass": ("synth_midpass.cu", "synth_midpass_launch",
                      [_P] * 7 + [_L, _I, _I, _P, _P, _P, _P]),
}

launches: collections.Counter = collections.Counter()
record: list | None = None

_libs: dict = {}
_built: list = []          # the build directory, once every kernel is loaded
_lock = threading.Lock()


def reset_counts() -> None:
    launches.clear()


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> str:
    """Compile every kernel that is not yet built (in parallel) and load
    all of them.  Returns the build directory; raises on any failure."""
    if _built:
        return _built[0]
    with _lock:
        if _built:
            return _built[0]
        d = _build_dir()
        os.makedirs(d, exist_ok=True)
        procs = {}
        for name, (src, *_) in KERNELS.items():
            so = os.path.join(d, f"lib{name}.so")
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            log = open(os.path.join(d, f"{name}.log"), "w")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)],
                stdout=log, stderr=subprocess.STDOUT), tmp, so, log)
        failed = []
        for name, (p, tmp, so, log) in procs.items():
            rc = p.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, so)
            else:
                failed.append(name)
        if failed:
            msgs = [open(os.path.join(d, f"{n}.log")).read() for n in failed]
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + ":\n" + "\n".join(msgs))
        for name, (_, *spec) in KERNELS.items():
            lib = ctypes.CDLL(os.path.join(d, f"lib{name}.so"))
            fns = {}
            for fn, argtypes in (spec[0] if len(spec) == 1
                                 else {spec[0]: spec[1]}).items():
                f = fns[fn] = getattr(lib, fn)
                f.argtypes = argtypes + [ctypes.c_void_p]  # + cudaStream_t
                f.restype = ctypes.c_int
            err = lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = (fns, err)
        _built.append(d)
        return d


def launch(name: str, args: list, inputs: dict, fn: str | None = None,
           variant: str | None = None) -> None:
    """Launch kernel `name` on the current stream with C arguments
    `args`, through its launcher `fn` where it has one for each stage;
    `inputs` (the wrapper's tensors and scalars) is what `record` keeps
    for a replay.  A `variant` (the float64 instantiation of a kernel
    that also runs in float32, K9's chunk mode) is counted and recorded
    as `name[variant]`."""
    build()
    fns, err = _libs[name]
    stream = torch.cuda.current_stream().cuda_stream
    rc = fns[fn or KERNELS[name][1]](*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed: "
                           f"{err(rc).decode()} ({rc})")
    key = name if variant is None else f"{name}[{variant}]"
    launches[key] += 1
    if record is not None:
        record.append((key, inputs))


def base_name(key: str) -> str:
    """The kernel of a launch count's key (`name` or `name[variant]`)."""
    return key.split("[", 1)[0]


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The wrapper's checks: device, dtype and contiguity."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
