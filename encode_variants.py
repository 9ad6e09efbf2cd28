"""K6 (csrc/codec_encode.cu) as committed against the same source with its
float64 sums moved from the FP64 tensor cores to the FMA pipes (the
source's `if constexpr (sizeof(T) == 8)` branches switched off), on one
card in one process: both built with the port's nvcc flags, checked
against `encode_spectra_plain`, and timed under CUDA events at the parity
lane's (6416, 1025) spectra at 48 kHz and the `analysis` command's (121,
513) at 16 kHz.  A third build with the product's k loops emptied (its
outputs are not the encode's, and are not checked) times what the rest
of the kernel costs: the gathers, logs, lerps, table copies and
barriers.  The three run in turns: committed, FMA pipes, no product, no
product, FMA pipes, committed.  Prints the card's name and power limit,
then one JSON line.

    python3 encode_variants.py
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from hts_train_world_tpu_torch import kernels  # noqa: E402
from hts_train_world_tpu_torch.features import encode  # noqa: E402

SWITCH = ("if constexpr (sizeof(T) == 8)", "if constexpr (sizeof(T) == 0)")
NO_PRODUCT = (("for (int k0 = 0; k0 < KC; k0 += 4) {",
               "for (int k0 = 0; k0 < 0; k0 += 4) {"),
              ("for (int k = 0; k < KC; ++k) {",
               "for (int k = 0; k < 0; ++k) {"))
SHAPES = ((48000, 2048, 6416), (16000, 1024, 121))


def build(src: str, out_dir: str, name: str):
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
                    "-o", so, path], check=True, capture_output=True)
    fn = ctypes.CDLL(so).codec_encode_launch
    fn.argtypes = kernels.KERNELS["codec_encode"][2] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("encode_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    with open(os.path.join(kernels.CSRC, "codec_encode.cu")) as f:
        src = f.read()
    if src.count(SWITCH[0]) != 2 or any(src.count(a) != 1
                                        for a, _ in NO_PRODUCT):
        raise RuntimeError("codec_encode.cu: the float64 branches or the "
                           "product's loops moved")
    bare = src
    for a, b in NO_PRODUCT:
        bare = bare.replace(a, b)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"tensor_cores": build(src, tmp, "tc"),
               "fma_pipes": build(src.replace(*SWITCH), tmp, "fma"),
               "no_product": build(bare, tmp, "bare")}
        dev = torch.device("cuda")
        rng = np.random.default_rng(6)
        out = {"card": smi, "shapes": []}
        for fs, N, R in SHAPES:
            n = N // 2 + 1
            sp = torch.as_tensor(np.exp(rng.normal(size=(R, n)) * 3),
                                 dtype=torch.float64, device=dev)
            ap = torch.as_tensor(rng.uniform(1e-3, 1.0, (R, n)),
                                 dtype=torch.float64, device=dev)
            bins, iu, s, dm, db, nb_max = encode._kernel_tables(
                fs, N, 50, 25, torch.float64, dev)
            mgc = torch.empty((R, 50), dtype=torch.float64, device=dev)
            bap = torch.empty((R, 25), dtype=torch.float64, device=dev)
            want = encode.encode_spectra_plain(sp, ap, fs, N)
            row = {"fs": fs, "rows": R, "bins": n}

            def run(fn):
                rc = fn(sp.data_ptr(), ap.data_ptr(), R, n, bins.data_ptr(),
                        iu.data_ptr(), s.data_ptr(), N // 2,
                        encode.ENCODE_CHUNK, nb_max, dm.data_ptr(), 50,
                        dm.shape[1], db.data_ptr(), 25, db.shape[1], 1,
                        mgc.data_ptr(), bap.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"launch failed ({rc})")

            for name, fn in fns.items():
                if name == "no_product":
                    continue
                run(fn)
                torch.cuda.synchronize()
                err = 0.0
                for g, w, off in zip((mgc, bap), want, (12.0, -encode.LN_1E4)):
                    raw = torch.cat([w[..., :1] - off, w[..., 1:]], dim=-1)
                    scale = w.abs() + raw.abs().amax(-1, keepdim=True)
                    err = max(err, float(((g - w).abs() / scale).max()))
                row[f"{name}_rel_err"] = err
                if err > 1e-12:
                    raise RuntimeError(f"{name}: {err:.2e} from the twin")
            times = {k: [] for k in fns}
            for name in ("tensor_cores", "fma_pipes", "no_product",
                         "no_product", "fma_pipes", "tensor_cores"):
                fn = fns[name]
                run(fn)
                torch.cuda.synchronize()
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                for _ in range(20):
                    run(fn)
                b.record()
                b.synchronize()
                times[name].append(1e3 * a.elapsed_time(b) / 20)
            row.update({f"{k}_us": v for k, v in times.items()})
            out["shapes"].append(row)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
