"""The `analysis` and `synth` command lines of the port.

Counterpart of `hts_train_world_tpu/cli.py` (the reference binaries
test/analysis.cpp and test/synth.cpp) with the same argv and the same
scaling quirks of the compressed (lf0/mgc/bap) files; the encode is
`features.encode.encode_features`, the decode `decode_features`
(`features/decode.py`, re-exported here).

`synth` runs the parity path by default, as the JAX CLI does under x64:
the float32 files read into float64, decoded by K12 in float64 and
synthesised by `vocoder.synthesize(parity=True)` (the exact path on the
reference's noise stream); `--f32` picks the fast path.  `analysis` has
the fast path only: without `--f32` it raises (parity analysis is
ROADMAP Queue A 5's analysis half).  `--harvest` picks Harvest for F0
(the JAX CLI's extension), and `--device` (default `cuda`) picks the
device; a missing card is an error.

Run: python -m hts_train_world_tpu_torch.cli analysis in.wav out.lf0 \\
         out.mgc out.bap [fp fftlen mgcdim bapdim] [--harvest] --f32 \\
         [--device cpu]
     python -m hts_train_world_tpu_torch.cli synth in.lf0 in.mgc in.bap \\
         out.wav fp fftlen fs [mgcdim bapdim] [--f32] [--device cpu]
"""
from __future__ import annotations

import sys

import torch

from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch import vocoder
from hts_train_world_tpu_torch.features.decode import decode_features
from hts_train_world_tpu_torch.features.encode import encode_features
from hts_train_world_tpu_torch.io import rawio, wavio

__all__ = ["decode_features", "analysis_main", "synth_main", "main"]


def analysis_main(argv, device="cuda"):
    algorithm = "dio"
    if "--harvest" in argv:        # extension: Harvest F0 (harvest.cpp)
        argv = [a for a in argv if a != "--harvest"]
        algorithm = "harvest"
    wav, lf0_p, mgc_p, bap_p = argv[:4]
    fp = float(argv[4]) if len(argv) > 4 else 5.0
    fftlen = int(argv[5]) if len(argv) > 5 else 0
    mgc_dim = int(argv[6]) if len(argv) > 6 else 0
    bap_dim = int(argv[7]) if len(argv) > 7 else 24
    x, fs = wavio.wavread(wav)
    a = vocoder.analyze(x, fs, fp, parity=False, fft_size=fftlen,
                        algorithm=algorithm, device=device)
    if mgc_dim:
        outs = encode_features(a.f0, a.spectrogram, a.aperiodicity, fs,
                               a.fft_size, mgc_dim, bap_dim)
    else:
        outs = (a.f0, a.spectrogram, a.aperiodicity)
    for path, v in zip((lf0_p, mgc_p, bap_p), outs):
        rawio.write_f32(path, v.cpu().numpy())
    print(f"complete. frames={a.f0.shape[0]} fft={a.fft_size}")


def synth_main(argv, device="cuda", parity=True):
    lf0_p, mgc_p, bap_p, wav_out, fp, fftlen, fs = argv[:7]
    fp, fftlen, fs = float(fp), int(fftlen), int(fs)
    mgc_dim = int(argv[7]) if len(argv) > 7 else 0
    bap_dim = int(argv[8]) if len(argv) > 8 else 24
    dev = device_mod.resolve(device)
    dtype = torch.float64 if parity else torch.float32
    lf0 = rawio.read_f32(lf0_p)
    T = len(lf0)
    if mgc_dim:
        mgc = rawio.read_f32(mgc_p, mgc_dim)[:T]
        bap = rawio.read_f32(bap_p, bap_dim)[:T]
        f0, sp, ap = decode_features(
            *(torch.as_tensor(v, dtype=dtype, device=dev)
              for v in (lf0, mgc, bap)), fs, fftlen)
    else:
        half = fftlen // 2 + 1
        f0 = lf0
        sp = rawio.read_f32(mgc_p, half)[:T]
        ap = rawio.read_f32(bap_p, half)[:T]
    y = vocoder.synthesize(f0, sp, ap, fs, fftlen, fp, parity=parity,
                           device=device)
    wavio.wavwrite(y.cpu().numpy(), fs, wav_out)
    print(f"complete. samples={y.shape[0]}")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for i, a in enumerate(argv):
        if a == "--device":
            device = argv[i + 1]
            del argv[i:i + 2]
            break
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            del argv[i]
            break
    parity = "--f32" not in argv
    argv = [a for a in argv if a != "--f32"]
    cmd = argv[0]
    if cmd == "analysis":
        if parity:
            raise NotImplementedError(vocoder._PARITY)
        analysis_main(argv[1:], device)
    elif cmd == "synth":
        synth_main(argv[1:], device, parity)
    else:
        raise SystemExit(f"unknown command {cmd}")


if __name__ == "__main__":
    main()
