#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one GPU.

Drives the port's paths at full size on a corpus made from a seed:

- copy-synthesis (`parallel.batch.batch_copy_synth`): 48 kHz, 2.0 s
  utterances, batch 16, 5 ms frames, f32 fast mode;
- the feature lane (`parallel.features.feature_lane`): the same batch
  through analysis, the lf0/mgc/bap encode (mgc 50, bap 25), the delta
  windows and MLPG;
- the synth lane (`parallel.features.synth_lane`, the synth CLI's and the
  pipeline's WGEN path): the feature lane's (lf0, mgc, bap) of that batch
  decoded, pulse-counted and synthesised;
- corpus extraction (`parallel.bucketing.bucketed_extract`): bench.py's
  corpus500 recipe in memory, 500 utterances of 0.7-1.4 s at 48 kHz;
- the Harvest lane (`parallel.batch.batch_analyze(algorithm="harvest")`):
  the headline batch through Harvest's F0 (decimation, band filter, raw
  candidates, detection, refinement, contour), CheapTrick and D4C;
- corpus extraction with Harvest (`bucketed_extract(algorithm="harvest")`)
  on corpus500;
- the batched monophone HSMM Baum-Welch EM
  (`models.hsmm_batch.reestimate_modelset_batched`, float64): 128
  utterances of the WORLD cmp layout (D = 237), 40 models x 5 states,
  max_dur 60, one iteration; and bench.py's 14-dim hsmm_em recipe;
- the tied-model voice recipe (`models.recipe.train_voice` at
  `RecipeConfig()`'s defaults: IN_RE, ERST0, CXCL, ERST2, UNTIE/CXCL2,
  ERST4, FALGN, MCDGV; then `recipe.export`): 128 utterances of 16 phrase
  templates over the same 40 models at D = 237, full contexts with notes
  and positions, 143 questions;
- the voice-build lane, sung audio to a voice to a wav: 64 sung phrases
  at 48 kHz (16 templates of 6-12 notes over 12 pitches) through
  `bucketed_extract` (DIO, mgc 50, bap 25), `compose.compose_cmp` (D =
  231), `train_voice(RecipeConfig(use_mspf=True))`, `recipe.export` and
  `engine.synthesize` of 16 unseen phrases (PGEN: durations, MLPG, GV,
  MSPF; WGEN: decode and WORLD synthesis), plus the mcep postfilter and
  pgtype 1 through `recipe.synthesize_utterance`;
- the corpus pipeline's front half (`runtime.pipeline.SingingPipeline`,
  ANALYZE -> COMPOSE -> STATS -> HALGN -> MKDAT): 64 sung phrases at 48 kHz
  with vibrato on the long notes, as wav files and HTS labels with note
  names on disk, to lf0 (2) / mgc (50) / bap (25) / vib (2) streams, HTK
  cmp files (D = 237), statistics, state and phone alignments and ffi
  label features;
- the DNN lane: `models.training.train` at the reference's default recipe
  (n_in 1186, 3 x 2048 sigmoid, n_out 238, batch 256, Adam) in frame mode
  and in trajectory mode (one utterance of 512 frames, dims (50, 2, 25,
  2)), then the pipeline's DNN half on the pipeline lane's workdir
  (TRDNN -> TRJGV -> MSPFD -> PGEN -> WGEN, and `synthesize_unseen` of 4
  phrases outside the corpus);
- the parity lane, float64 synthesis on the reference's reseeded noise
  stream: the feature lane's features of the headline batch decoded and
  synthesised by the exact path (`ops/synthesis.synthesis(...,
  exact=True)`, vocoder.synthesize(parity=True)'s path), the synth CLI at
  its default (no --f32) and the `StreamingSynthesizer` on one 2.0 s
  utterance at buffer sizes 64, 256 and 1024.

Thirty kernels, K1-K30, are built, driven and held to their twins; K9-K12
and K30 also in float64, and K9 in its chunk mode (the streaming
synthesizer's), counted and reported as `name[f64]` and
`synth_time_base[chunk]`.

Phases (any failure raises):

1. build every CUDA kernel from `hts_train_world_tpu_torch/csrc/`;
2. run each path once with the launch counts set to 0 just before it and
   read just after (copy-synthesis, the feature lane, the synth lane and
   the Harvest lane also record each kernel's inputs); fail if a kernel of
   the path was not launched, or if the outputs are not finite, in range
   and plausible;
3. replay every recorded launch through the kernel and its plain PyTorch
   version on the same inputs and hold them within the stated tolerance
   (K5, K8 and K14 also against float64 references; K9 and K11 bit for
   bit against the plain version run on the CPU, K11 also across two
   launches); time kernel, plain version, bound and, where one exists,
   the library call; print the bounds of the plain-torch stages that have
   no kernel yet, from this run's shapes (K28 and K29 are replayed in
   phase 14, where their inputs are recorded);
4. compare the card's copy-synthesis, feature lane, synth lane and
   Harvest lane with the CPU (plain) path on a small input (the synth
   lane must fire the same pulses);
5. time the copy-synthesis stages and its audio-seconds per second; DIO's
   stage time and the device idle share with K5 and with its plain twin,
   in turns, in this one run;
6. one copy-synthesis batch under the profiler;
7. the feature lane's and the synth lane's stage times and audio-seconds
   per second, and one synth-lane batch under the profiler;
8. corpus extraction: audio-seconds per second, buckets and batches, the
   device busy share for one bucket group, host time padding and
   trimming;
9. the Harvest lane's stage times and audio-seconds per second on the
   headline batch, one batch under the profiler; corpus extraction with
   Harvest, one timed run after one warm run;
10. the HSMM lane: one EM iteration counted and recorded (K17-K19), its
   launches replayed against the twins (K18 also padded against unpadded,
   K19 bit for bit against the CPU and across launches), the card against
   the CPU path on a small corpus (accumulators, parameters after two
   iterations, Viterbi alignments), then frames per second, E-step stage
   times and one E-step under the profiler, for the lane and for bench.py's
   recipe;
11. the recipe lane: one `train_voice` counted (K17-K20) with its stage
   seconds (the host tree search apart from the card's E-steps), ERST2's
   frames per second, FALGN's utterances per second, leaves and untied
   rows, the exported voice's header, one tied BW iteration under the
   profiler; its K20 launches (FALGN's padded batches, each also against
   its shortest utterance alone) and its K19 launches on the untied
   clone's tables replayed against the twins, K18 and K20 on a 9000-frame
   utterance, K17 with a NaN in bap; and the card against the CPU path on
   tests/test_recipe.py's corpus (the same trees as partitions, where two
   trees name a split by different questions their gains within rounding
   of each other, parameters, alignments and GV trees);
12. the voice-build lane: every stage counted (analysis K1-K6, composition
   K7 in float64, training K17-K20 and MSPF's K8 and K21, generation K8,
   K21, K23, K12 and K9-K11; the mcep postfilter K22; pgtype 1 K7, K17,
   K18); the 16 unseen phrases synthesised as the recipe's settings say
   (GV on mgc and lf0, MSPF; their gates reported) and with GV on mgc
   alone and MSPF (held to tests/test_voice_build.py's audibility and
   note-F0 gates); stage seconds, utterances and audio-seconds per second,
   one synthesis under the profiler; K21, K22, K23 and K7/K8's float64
   launches replayed against their twins; and on
   tests/test_voice_build.py's small corpus (16 kHz, mgc 12) the voice
   trained on the card and on the CPU (the same voice), generation from
   it on both (statics within 1e-9), and the exported file against the
   state;
13. the pipeline lane: `run(upto="MKDAT")` counted stage by stage (ANALYZE
   K1-K6 and K24-K27, COMPOSE K7 in float64, HALGN K7 and K17-K20), ANALYZE
   under the profiler; the wall seconds of each stage, ANALYZE's loader,
   extraction, LOWESS/vibrato and file writes, its audio-seconds per
   second and device idle share, HALGN's `train_voice` stage seconds, the
   voiced runs and the vibrato found against the one sung; gates on every
   stage's files (frame counts, the cmp header, finite values, alignment
   ends, ffi width); and on tests/test_torch_pipeline.py's corpus (16 kHz)
   the front half on the card and on the CPU (streams within the CPU
   tests' tolerances; from the CPU's streams, cmp, alignments and ffi
   equal);
14. the DNN lane: (a) frame-mode frames/s and step ms over 220 steps
   after 20, the idle share over 20 more under the profiler; (b)
   trajectory-mode frames/s, K28 and K29 µs a launch, their launches
   replayed against the twins (phase 3) and a float64 gradcheck through
   both on the card; (c) the pipeline's DNN half on phase 13's workdir
   at 3 x 2048, counted stage by stage (TRJGV K28/K29, MSPFD and PGEN K8
   in float64 and K21, WGEN K12, K9-K11 and K30, `synthesize_unseen` all
   of them but K28/K29), WGEN under the profiler: stage seconds, PGEN
   utterances/s, WGEN audio-s/s and idle share; gates: the frame NLL
   falls, the warm-started model's trajectory NLL below the frame
   model's, the generated files finite, the unseen phrases audible (their
   note F0 error reported); and on tests/test_torch_pipeline.py's corpus
   the DNN half on the card and on the CPU at hidden (32, 32) (logged
   costs, weights and PGEN files within `DNN_TINY_MAX`);
15. the parity lane: (a) K12 and the exact path in float64 on the
   headline batch's features, counted and recorded: audio-s/s over five
   batches after one, the idle share of one under the profiler, every
   float64 launch replayed against its twin (K9 and K11 bit for bit
   against the twin on the CPU, K10 within 4 float64 ulps, K12 and K30
   within 1e-12) and timed; (a') vocoder.synthesize(parity=True) of a
   16 kHz utterance with long unvoiced runs on the card and on the CPU:
   the same pulses, the waveforms within 1e-10; (b) the synth command
   without --f32 on one utterance's mgc 50 / bap 25 files, the card's wav
   against --device cpu's; (c) the StreamingSynthesizer at buffer sizes
   64, 256 and 1024: ms per read() (median, p99), the real-time factor,
   the stream against the batch parity synthesis within 1e-10, K9's chunk
   mode replayed against its twin on the CPU chunk by chunk (and K11's
   accumulate mode once).

Prints each measurement, the card's name and power limit, a `kernels`
JSON line, and as the last line {"ok": true, "device": {...}}.  Exits
non-zero, printing no result, when no CUDA device is present.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import copy
import cProfile
import filecmp
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
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
    "harvest_decimate": ("K13", "hts_train_world_tpu/ops/prims.py:262"),
    "harvest_candidates": ("K14", "hts_train_world_tpu/ops/harvest.py:129"),
    "harvest_refine": ("K15", "hts_train_world_tpu/ops/harvest.py:320"),
    "harvest_contour": ("K16", "hts_train_world_tpu/ops/harvest_fix.py:121"),
    "hsmm_loglik": ("K17", "hts_train_world_tpu/models/hsmm.py:157"),
    "hsmm_fb": ("K18", "hts_train_world_tpu/models/hsmm.py:287"),
    "hsmm_accumulate": ("K19", "hts_train_world_tpu/models/hsmm_batch.py:227"),
    "hsmm_viterbi": ("K20", "hts_train_world_tpu/models/hsmm.py:183"),
    "mspf": ("K21", "hts_train_world_tpu/ops/postfilter.py:51"),
    "mcep_postfilter": ("K22", "hts_train_world_tpu/ops/postfilter.py:32"),
    "gv_scale": ("K23", "hts_train_world_tpu/ops/gv.py:22"),
    "stonemask_if": ("K24", "hts_train_world_tpu/ops/stonemask.py:117"),
    "cheaptrick_lifter": ("K25", "hts_train_world_tpu/ops/cheaptrick.py:163"),
    "d4c_group_delay": ("K26", "hts_train_world_tpu/ops/d4c.py:153"),
    "d4c_aperiodicity": ("K27", "hts_train_world_tpu/ops/d4c.py:196"),
    "trajectory_nll": ("K28", "hts_train_world_tpu/models/acoustic.py:137"),
    "trajectory_adjoint": ("K29",
                           "hts_train_world_tpu/models/acoustic.py:103"),
    "synth_midpass": ("K30", "hts_train_world_tpu/ops/synthesis.py:195"),
    # the float64 instantiations (the exact path) and K9's chunk mode
    "synth_time_base[f64]": ("K9 f64",
                             "hts_train_world_tpu/ops/synthesis.py:70"),
    "synth_pulse_spectra[f64]": ("K10 f64",
                                 "hts_train_world_tpu/ops/synthesis.py:180"),
    "synth_midpass[f64]": ("K30 f64",
                           "hts_train_world_tpu/ops/synthesis.py:195"),
    "synth_ola[f64]": ("K11 f64", "hts_train_world_tpu/ops/synthesis.py:268"),
    "codec_decode[f64]": ("K12 f64", "hts_train_world_tpu/cli.py:58"),
    "synth_time_base[chunk]": ("K9 chunk",
                               "hts_train_world_tpu/ops/synthesis_rt.py:38"),
}
BODY = ("cheaptrick_lifter", "d4c_group_delay", "d4c_aperiodicity")
ANALYSIS = ("frame_window", "spectral_smooth", "topk_sum", "fix_f0",
            "dio_candidates", "stonemask_if") + BODY
SYNTHESIS = ("synth_time_base", "synth_pulse_spectra", "synth_midpass",
             "synth_ola")
HARVEST = ("harvest_decimate", "harvest_candidates", "harvest_refine",
           "harvest_contour", "frame_window", "spectral_smooth",
           "topk_sum") + BODY
# the kernels each path must launch
PATHS = {
    "copy_synth": ANALYSIS + SYNTHESIS,
    "feature_lane": ANALYSIS + ("codec_encode", "delta_window",
                                "mlpg_solve"),
    "synth_lane": ("codec_decode",) + SYNTHESIS,
    "corpus500": ANALYSIS + ("codec_encode",),
    "harvest_lane": HARVEST,
    "corpus500_harvest": HARVEST + ("codec_encode",),
    "hsmm_em": ("hsmm_loglik", "hsmm_fb", "hsmm_accumulate"),
    "recipe": ("hsmm_loglik", "hsmm_fb", "hsmm_accumulate", "hsmm_viterbi"),
    # the voice-build lane, stage by stage: analysis, composition (K7 in
    # float64), synthesis of the unseen phrases and its variants through
    # synthesize_utterance, training with MSPF
    "voice_extract": ANALYSIS + ("codec_encode",),
    "voice_compose": ("delta_window",),
    "voice_synth": ("mlpg_solve", "mspf", "gv_scale", "codec_decode")
    + SYNTHESIS,
    "voice_synth_gated": ("mlpg_solve", "gv_scale", "mspf", "codec_decode")
    + SYNTHESIS,
    "voice_mcep": ("mlpg_solve", "mcep_postfilter", "gv_scale",
                   "codec_decode") + SYNTHESIS,
    "voice_pgtype1": ("delta_window", "hsmm_loglik", "hsmm_fb",
                      "mlpg_solve", "gv_scale", "mspf", "codec_decode")
    + SYNTHESIS,
    "voice_train": ("hsmm_loglik", "hsmm_fb", "hsmm_accumulate",
                    "hsmm_viterbi", "mlpg_solve", "mspf"),
    # the pipeline lane, stage by stage
    "pipeline_analyze": ANALYSIS + ("codec_encode",),
    "pipeline_compose": ("delta_window",),
    "pipeline_halgn": ("delta_window", "hsmm_loglik", "hsmm_fb",
                       "hsmm_accumulate", "hsmm_viterbi"),
    # the DNN lane: trajectory training, then the pipeline's DNN half
    "dnn_trajectory": ("trajectory_nll", "trajectory_adjoint"),
    "pipeline_trjgv": ("trajectory_nll", "trajectory_adjoint"),
    "pipeline_mspfd": ("mlpg_solve", "mspf"),
    "pipeline_pgen": ("mlpg_solve", "mspf"),
    "pipeline_wgen": ("codec_decode",) + SYNTHESIS,
    "pipeline_unseen": ("mlpg_solve", "mspf", "codec_decode") + SYNTHESIS,
    # the parity lane: decode and the exact path in float64, the synth
    # CLI at its default, the streaming synthesizer (K9's chunk mode)
    "parity_lane": ("codec_decode[f64]",) + tuple(f"{k}[f64]"
                                                  for k in SYNTHESIS),
    "parity_cli": ("codec_decode[f64]",) + tuple(f"{k}[f64]"
                                                 for k in SYNTHESIS),
    "streaming": ("synth_time_base[chunk]", "synth_pulse_spectra[f64]",
                  "synth_midpass[f64]", "synth_ola[f64]"),
}
# the HSMM lane: RecipeConfig's defaults (models/recipe.py:45-47)
HSMM_MODELS, HSMM_STATES, HSMM_MAX_DUR, HSMM_UTTS = 40, 5, 60, 128
# the recipe lane: train_voice at RecipeConfig's defaults
RECIPE_SEED, RECIPE_TEMPLATES, RECIPE_UTTS = 5, 16, 128
# the voice-build lane: sung phrases at 48 kHz, 12 pitches
VOICE_SEED, VOICE_TEMPLATES, VOICE_UTTS, VOICE_UNSEEN = 12, 16, 64, 16
VOICE_PITCH = {f"p{i:02d}": 220.0 * 2.0 ** (i / 12.0) for i in range(12)}
# the pipeline lane: phase 12's phrases with vibrato, notes by name
NOTE_NAMES = ["A3", "Bb3", "B3", "C4", "Db4", "D4", "Eb4", "E4", "F4", "Gb4",
              "G4", "Ab4"]
VIBRATO_HZ, VIBRATO_DEPTH, VIBRATO_MIN = 5.5, 0.03, 40
# the DNN lane (phase 14): the reference's default recipe (tools/
# bench_train.py:22-45, configure.ac:932-970), one utterance of 512 frames
# for trajectory mode, and the pipeline's DNN half on phase 13's workdir
DNN_SEED, DNN_FRAMES, DNN_T = 9, 16384, 512
DNN_DIMS, DNN_MSD = (50, 2, 25, 2), (0, 1, 0, 0)
DNN_FRAME_STEPS, DNN_TRAJ_STEPS = 300, 60
DNN_TRDNN_STEPS, DNN_TRJGV_STEPS, DNN_UNSEEN = 4000, 200, 4
# MSPF on the DNN's generations at half weight: their log modulation
# spectra sit up to ~7.5 nats below the natural ones at some bins (a
# frame-wise DNN over-smooths), so weight 1 scales those bins' swings
# ~1800-fold and the float32 decode overflows (rehearsal, 6 phrases)
DNN_MSPF_WEIGHT = 0.5


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


def hsmm_corpus(hsmm, seed: int = 3):
    """The HSMM lane's corpus at full width, in memory: `world_streams()`
    (D = 237), 40 monophone models x 5 states, 128 utterances of 8-24
    labels; per-state durations N(mu, 1) >= 1 with mu in [4, 14] per
    (model, state); frames the state's mean + 0.3 N(0, 1); about 30 % of
    the models unvoiced (zero lf0 and vib columns), voiced states with a
    non-zero first column.  The model set is bootstrapped with
    `init_modelset` from a uniform per-label split."""
    rng = np.random.default_rng(seed)
    sts = hsmm.world_streams()
    D = sts[-1].sl.stop
    M, S = HSMM_MODELS, HSMM_STATES
    names = [f"m{i:02d}" for i in range(M)]
    mu = rng.standard_normal((M, S, D))
    dur = rng.uniform(4.0, 14.0, (M, S))
    voiced = rng.random(M) >= 0.3
    msd_cols = [(st.sl, st.msd_flag_col) for st in sts if st.msd]
    utts, fbm = [], {n: [] for n in names}
    for _ in range(HSMM_UTTS):
        seq = rng.integers(0, M, int(rng.integers(8, 25)))
        fr = []
        for mi in seq:
            for s in range(S):
                d = max(1, int(rng.normal(dur[mi, s], 1.0)))
                f = mu[mi, s] + 0.3 * rng.standard_normal((d, D))
                for sl, col in msd_cols:
                    if voiced[mi]:
                        f[:, col] = np.abs(f[:, col]) + 0.5
                    else:
                        f[:, sl] = 0.0
                fr.append(f)
        fr = np.concatenate(fr)
        labels = [names[i] for i in seq]
        utts.append((fr, labels))
        ends = np.linspace(0, len(fr), len(labels) + 1)[1:].astype(int)
        starts = np.concatenate([[0], ends[:-1]])
        for i, n in enumerate(labels):
            fbm[n].append(fr[starts[i]:ends[i]])
    return hsmm.init_modelset(names, fbm, sts, n_states=S), utts


def hsmm_bench_corpus(hsmm):
    """bench.py:333-351's hsmm_em recipe: 14-dim frames (mgc 12, lf0 2
    MSD), 8 models x 5 states, 128 utterances of 90-130 frames and 6
    labels, seed 3."""
    rngh = np.random.default_rng(3)
    streams = (hsmm.StreamDef("mgc", slice(0, 12), False, 0, 1.0),
               hsmm.StreamDef("lf0", slice(12, 14), True, 12, 1.0))
    names = [f"p{i}" for i in range(8)]
    fbm = {n: [] for n in names}
    utts = []
    for _ in range(128):
        seq = [names[j] for j in rngh.integers(0, 8, 6)]
        Tn = int(rngh.integers(90, 130))
        fr = rngh.standard_normal((Tn, 14))
        fr[:, 12] = np.abs(fr[:, 12]) + 0.5
        utts.append((fr, seq))
        mid = Tn // 2
        fbm[seq[0]].append(fr[:mid])
        fbm[seq[1]].append(fr[mid:])
    return hsmm.init_modelset(names, fbm, streams, n_states=5), utts


def hsmm_tiny_corpus(hsmm, seed: int = 11):
    """8 utterances of 60-120 frames over the tiny 10-dim streams of
    tests/test_hsmm.py:10-15 (mgc 4 | lf0 2 MSD | bap 2 weight 0 | vib 2
    MSD), 4 models x 3 states."""
    rng = np.random.default_rng(seed)
    sts = (hsmm.StreamDef("mgc", slice(0, 4), False, 0, 1.0),
           hsmm.StreamDef("lf0", slice(4, 6), True, 4, 1.0),
           hsmm.StreamDef("bap", slice(6, 8), False, 6, 0.0),
           hsmm.StreamDef("vib", slice(8, 10), True, 8, 1.0))
    names = [f"p{i}" for i in range(4)]
    mu = 2.0 * rng.standard_normal((4, 3, 10))
    dur = rng.uniform(5.0, 8.0, (4, 3))
    voiced = rng.random((4, 3)) >= 0.3
    utts, fbm = [], {n: [] for n in names}
    while len(utts) < 8:
        seq = rng.integers(0, 4, int(rng.integers(4, 7)))
        fr = []
        for mi in seq:
            for s in range(3):
                d = max(1, int(rng.normal(dur[mi, s], 1.0)))
                f = mu[mi, s] + 0.3 * rng.standard_normal((d, 10))
                if voiced[mi, s]:
                    f[:, 4] = np.abs(f[:, 4]) + 0.5
                    f[:, 8] = np.abs(f[:, 8]) + 0.5
                else:
                    f[:, 4:6] = 0.0
                    f[:, 8:10] = 0.0
                fr.append(f)
        fr = np.concatenate(fr)
        if not 60 <= len(fr) <= 120:
            continue
        labels = [names[i] for i in seq]
        utts.append((fr, labels))
        ends = np.linspace(0, len(fr), len(labels) + 1)[1:].astype(int)
        starts = np.concatenate([[0], ends[:-1]])
        for i, n in enumerate(labels):
            fbm[n].append(fr[starts[i]:ends[i]])
    return hsmm.init_modelset(names, fbm, sts, n_states=3), utts


def recipe_corpus(hsmm, seed: int = RECIPE_SEED,
                  n_templates: int = RECIPE_TEMPLATES):
    """The recipe lane's corpus at full width, in memory: `world_streams()`
    (D = 237) and the HSMM lane's frame recipe over 40 models x 5 states
    (model 0 "sil", unvoiced; ~30 % of the others unvoiced; per-state
    durations N(mu, 1) >= 1, mu in [4, 14]; frames the state mean + 0.3
    N(0, 1)), with a note offset of 0.2 per semitone on the voiced lf0
    flag column so that the note questions carry signal.  `n_templates`
    phrase templates of 8-24 labels between a leading and a trailing "sil",
    each label with a note 0-11 and its position; 128 utterances, the
    templates in turn, each with fresh durations and frames.  Labels are
    full contexts {L}^{L}-{C}+{R}={R}@{pos}_x/E:{note}] ("x" past the
    ends).  Returns (corpus, model names)."""
    rng = np.random.default_rng(seed)
    sts = hsmm.world_streams()
    D = sts[-1].sl.stop
    M, S = HSMM_MODELS, HSMM_STATES
    names = ["sil"] + [f"m{i:02d}" for i in range(1, M)]
    mu = rng.standard_normal((M, S, D))
    dur = rng.uniform(4.0, 14.0, (M, S))
    voiced = rng.random(M) >= 0.3
    voiced[0] = False
    msd_cols = [(st.sl, st.msd_flag_col) for st in sts if st.msd]
    lf0_col = next(st.msd_flag_col for st in sts if st.name == "lf0")
    templates = []
    for _ in range(n_templates):
        n = int(rng.integers(8, 25))
        seq = [0] + [int(i) for i in rng.integers(1, M, n)] + [0]
        notes = [int(v) for v in rng.integers(0, 12, len(seq))]
        ph = ["x"] + [names[i] for i in seq] + ["x"]
        ctx = [f"{ph[i]}^{ph[i]}-{ph[i + 1]}+{ph[i + 2]}={ph[i + 2]}@"
               f"{i + 1}_x/E:{notes[i]}]" for i in range(len(seq))]
        templates.append((seq, notes, ctx))
    utts = []
    for u in range(RECIPE_UTTS):
        seq, notes, ctx = templates[u % n_templates]
        fr = []
        for mi, note in zip(seq, notes):
            for s in range(S):
                d = max(1, int(rng.normal(dur[mi, s], 1.0)))
                f = mu[mi, s] + 0.3 * rng.standard_normal((d, D))
                for sl, col in msd_cols:
                    if voiced[mi]:
                        f[:, col] = np.abs(f[:, col]) + 0.5
                    else:
                        f[:, sl] = 0.0
                if voiced[mi]:
                    f[:, lf0_col] += 0.2 * note
                fr.append(f)
        utts.append((np.concatenate(fr), list(ctx)))
    return utts, names


def recipe_questions(names):
    """The lane's question config (qconf format): L-, C- and R-Phone_* for
    every model and C-Note over 0-11, 3 x 40 + 23 = 143 questions."""
    return "\n".join(
        [f"L-Phone_{p} {{*^{p}-*}}" for p in names]
        + [f"C-Phone_{p} {{*-{p}+*}}" for p in names]
        + [f"R-Phone_{p} {{*+{p}=*}}" for p in names]
        + ["C-Note {*/E:%d]*} MIN=0 MAX=11"])


TINY_QUESTIONS = """C-Phone_a {*-a+*}
C-Phone_b {*-b+*}
C-Phone_c {*-c+*}
C-Note {*/E:%d]*} MIN=0 MAX=7"""
TINY_RECIPE = dict(n_states=3, n_iters=2, max_dur=40, mdl_factor=0.5,
                   min_occupancy=0.5)


def tiny_streams(hsmm):
    """tests/test_hsmm.py's tiny 10-dim streams: mgc 4 | lf0 2 MSD | bap 2
    weight 0 | vib 2 MSD."""
    return (hsmm.StreamDef("mgc", slice(0, 4), False, 0, 1.0),
            hsmm.StreamDef("lf0", slice(4, 6), True, 4, 1.0),
            hsmm.StreamDef("bap", slice(6, 8), False, 6, 0.0),
            hsmm.StreamDef("vib", slice(8, 10), True, 8, 1.0))


def tree_partition(tree, ctxs):
    """A tree as the partition it makes of `ctxs`: a leaf is the set of its
    contexts, a split the unordered pair of its children.  Two questions
    that split a node's contexts alike (two contexts that differ only in
    the note: C-Note==3, ==4 and <=3) have equal gains in exact arithmetic,
    and the last bits of the statistics pick one (`split_margins` measures
    by how much).  The partition is the model on these contexts; an unseen
    context (note 5) can take the other branch under the other question,
    so two such trees export voices that differ there."""
    def walk(n, cs):
        if n.question is None:
            return ("leaf", frozenset(cs))
        yes = [c for c in cs if n.question.matches(c)]
        no = [c for c in cs if not n.question.matches(c)]
        return ("split", frozenset([walk(n.yes, yes), walk(n.no, no)]))
    return walk(tree.root, list(ctxs))


ROUNDING_GAP = 1.0     # |gain difference| / `SplitGains.rounding`


@contextlib.contextmanager
def recording_trees(clustering):
    """While open, every tree that `clustering.cluster_states` returns is
    kept with the arguments that built it: {id(tree): (tree, args, kw)}
    (the module's other functions call it through the module, so this
    sees the recipe's trees)."""
    built, inner = {}, clustering.cluster_states

    def cluster_states(*args, **kw):
        tree = inner(*args, **kw)
        built[id(tree)] = (tree, args, kw)
        return tree
    clustering.cluster_states = cluster_states
    try:
        yield built
    finally:
        clustering.cluster_states = inner


def _tree_args(stats_by_context, questions, mdl_factor=1.0,
               min_occupancy=1.0, var_floor=1e-8, msd_by_context=None,
               dim=0):
    return stats_by_context, var_floor, msd_by_context, dim


class SplitGains:
    """The gains `cluster_states` computes at a tree's nodes, in its own
    arithmetic and order (the root sums its contexts; a node's yes-branch
    sums its yes-contexts in node order, its no-branch is the node minus
    the yes-branch), from the statistics that built the tree."""

    def __init__(self, clustering, args, kw):
        stats, self.floor, msd, dim = _tree_args(*args, **kw)
        S = self.S = clustering.SuffStats
        self.cl = clustering

        def conv(d):
            return {c: S(float(v.gamma), np.asarray(v.s1, float),
                         np.asarray(v.s2, float)) for c, v in d.items()}
        self.st = conv(stats)
        self.msd = conv(msd) if msd is not None else None
        ctxs = (sorted(set(self.st) | set(self.msd)) if msd is not None
                else list(self.st))
        some = next(iter(self.st.values()), None)
        D = len(some.s1) if some is not None else max(dim, 1)
        self.zero = S(0.0, np.zeros(D), np.zeros(D))
        self.mzero = S(0.0, np.zeros(1), np.zeros(1))
        total, mtotal = self.zero, self.mzero
        for c in ctxs:
            total = total + self.g(c)
            mtotal = mtotal + self.m(c)
        self.root = (ctxs, total, mtotal)

    def g(self, c):
        return self.st.get(c, self.zero)

    def m(self, c):
        return self.mzero if self.msd is None else self.msd.get(c,
                                                                self.mzero)

    def ll(self, s, m):
        v = self.cl._loglik(s, self.floor)
        if self.msd is not None:
            v += self.cl._bern_loglik(m)
        return v

    def rounding(self, node, parts):
        """An estimate of the rounding in a gain at `node` whose terms are
        `parts` ((stats, mstats) of the yes-branch, the no-branch and the
        node): a term's log-likelihood moves by 0.5 / var per unit of its
        second-moment sum and by |mean| / var per unit of its first, and
        each sum carries an error of eps x the node's sums, which the
        no-branch's subtraction and the variance's s2 / n - mean^2 leave
        in place (the Bernoulli terms' share is below it and not counted)."""
        _, stats, _ = node
        eps = float(np.finfo(np.float64).eps)
        s1, s2 = np.abs(stats.s1), np.abs(stats.s2)
        err = 0.0
        for st, _ in parts:
            if st.gamma <= 0:
                continue
            v = st.var(self.floor)
            err += float(np.sum((0.5 * s2 + np.abs(st.mean) * s1) / v))
        return eps * err

    def split(self, node, q):
        """(gain, the rounding estimate of `rounding`, yes node, no
        node)."""
        ctxs, stats, mstats = node
        yes = [c for c in ctxs if q.matches(c)]
        sy, my = self.zero, self.mzero
        for c in yes:
            sy = sy + self.g(c)
            my = my + self.m(c)
        S = self.S
        sn = S(stats.gamma - sy.gamma, stats.s1 - sy.s1, stats.s2 - sy.s2)
        mn = S(mstats.gamma - my.gamma, mstats.s1 - my.s1,
               mstats.s2 - my.s2)
        base, ly, ln = self.ll(stats, mstats), self.ll(sy, my), self.ll(sn,
                                                                        mn)
        yes_set = set(yes)
        return (ly + ln - base,
                self.rounding(node, ((sy, my), (sn, mn), (stats, mstats))),
                (yes, sy, my), ([c for c in ctxs if c not in yes_set], sn,
                                mn))


def split_margins(clustering, x, built_x, y, built_y):
    """Where trees x and y make the same partition but name a split by
    different questions: each such node's gains of both questions, under
    x's statistics and under y's, as `cluster_states` computes them;
    `gap`, the larger |gain difference| over the two gains' rounding
    estimates (`SplitGains.rounding`), and `gap_of_gain`, over the gain.
    Questions that split a node alike have equal gains in exact
    arithmetic, so their difference is rounding and `gap` <= 1; a node
    whose splits differ gets gap inf."""
    gx = SplitGains(clustering, *built_x[id(x)][1:])
    gy = SplitGains(clustering, *built_y[id(y)][1:])
    out = []

    def walk(nx, ny, cx, cy):
        if nx.question is None or ny.question is None:
            if (nx.question is None) != (ny.question is None):
                out.append(dict(node=len(cx[0]), gap=float("inf")))
            return
        qx, qy = nx.question, ny.question
        g_xx, e_xx, yes_x, no_x = gx.split(cx, qx)
        g_yy, e_yy, yes_y, no_y = gy.split(cy, qy)
        if qx.name != qy.name:
            (g_xy, e_xy), (g_yx, e_yx) = (gx.split(cx, qy)[:2],
                                          gy.split(cy, qx)[:2])
            out.append(dict(
                node=len(cx[0]), questions=(qx.name, qy.name),
                gains_x=(g_xx, g_xy), gains_y=(g_yx, g_yy),
                gap=max(abs(g_xx - g_xy) / (e_xx + e_xy),
                        abs(g_yx - g_yy) / (e_yx + e_yy)),
                gap_of_gain=max(abs(g_xx - g_xy), abs(g_yx - g_yy))
                / max(abs(g_xx), abs(g_yy))))
        if set(yes_x[0]) == set(yes_y[0]):
            walk(nx.yes, ny.yes, yes_x, yes_y)
            walk(nx.no, ny.no, no_x, no_y)
        elif set(yes_x[0]) == set(no_y[0]):
            walk(nx.yes, ny.no, yes_x, no_y)
            walk(nx.no, ny.yes, no_x, yes_y)
        else:
            out.append(dict(node=len(cx[0]), questions=(qx.name, qy.name),
                            gap=float("inf")))
    walk(x.root, y.root, gx.root, gy.root)
    return out


def occupancy_ties(built_x, built_y, tol: float):
    """Two recipe runs' trees in build order (`recording_trees`): the
    first pair that partitions its contexts differently, walked to the
    first node where the two differ.  There, each question that one of the
    trees splits the node by is a witness of a `min_occupancy` tie when it
    is admissible under one run's statistics and not under the other's
    (a branch's occupancy, the msd gamma of an MSD stream, on either side
    of the threshold) and that occupancy lies within tol x max(1, m) of
    the threshold m.  Returns (index of the pair or None, witnesses)."""
    def occ(args, kw):
        stats, m = args[0], (args[3] if len(args) > 3
                             else kw.get("min_occupancy", 1.0))
        msd = kw.get("msd_by_context")
        src = msd if msd is not None else stats
        ctxs = (sorted(set(stats) | set(msd)) if msd is not None
                else list(stats))
        return {c: float(src[c].gamma) if c in src else 0.0
                for c in ctxs}, float(m)

    for i, ((x, ax, kx), (y, ay, ky)) in enumerate(zip(built_x.values(),
                                                       built_y.values())):
        gx, m = occ(ax, kx)
        gy, _ = occ(ay, ky)
        if tree_partition(x, gx) == tree_partition(y, gx):
            continue
        nx, ny, cs = x.root, y.root, list(gx)
        while nx.question is not None and ny.question is not None:
            yx = [c for c in cs if nx.question.matches(c)]
            if yx != [c for c in cs if ny.question.matches(c)]:
                break
            if tree_partition(nx.yes, yx) != tree_partition(ny.yes, yx):
                nx, ny, cs = nx.yes, ny.yes, yx
            else:
                nx, ny, cs = nx.no, ny.no, [c for c in cs if c not in yx]
        out = []
        for q in {n.question.name: n.question for n in (nx, ny)
                  if n.question is not None}.values():
            sides = []
            for g in (gx, gy):
                yes = sum(g[c] for c in cs if q.matches(c))
                sides.append((yes, sum(g[c] for c in cs) - yes))
            adm = [min(s) >= m for s in sides]
            near = min(abs(o - m) for s in sides for o in s)
            if adm[0] != adm[1] and near <= tol * max(1.0, m):
                out.append(dict(question=q.name, contexts=len(cs),
                                occupancies=sides, threshold=m,
                                distance=near))
        return i, out
    return None, []


def compare_voices(a, b, corpus, clustering, built_a, built_b,
                   msd_floor: float = 1e-3):
    """Two RecipeStates of one corpus: (passed, text).  Every tree (stream,
    duration, GV) makes the same partition of its contexts, and where two
    trees name a split by different questions, the questions' gains differ
    by rounding alone (`split_margins` on the statistics that built each
    tree, from `recording_trees`: gap <= ROUNDING_GAP); per context and
    state the parameters agree within 1e-8 of max(1, |value|) (an MSD
    stream's voiced-space Gaussian only where its weight is above
    `msd_floor`: at the 1e-3 floor no voiced frame was fitted and its
    statistics are a subtraction residual), msd weights within 1e-8;
    alignments equal."""
    ctxs = sorted({c for _, seq in corpus for c in seq})
    firsts = sorted({seq[0] for _, seq in corpus})
    ma, mb = a.clustered, b.clustered
    pairs = [(ma.trees[st.name][s], mb.trees[st.name][s], ctxs)
             for st in ma.streams for s in range(ma.n_states)]
    pairs.append((ma.dur_tree, mb.dur_tree, ctxs))
    pairs += [(a.gv.trees[n], b.gv.trees[n], firsts) for n in a.gv.trees]
    same_trees = a.gv.trees.keys() == b.gv.trees.keys() and all(
        tree_partition(x, c) == tree_partition(y, c) for x, y, c in pairs)
    named = sum(x.to_plain()[0] != y.to_plain()[0] for x, y, _ in pairs)
    margins = [m for x, y, _ in pairs if x.to_plain()[0] != y.to_plain()[0]
               for m in split_margins(clustering, x, built_a, y, built_b)]
    gap = max((m["gap"] for m in margins), default=0.0)
    leaves = sum(x.n_leaves for x, _, _ in pairs)
    d_par = d_w = 0.0
    where = ""
    for c in ctxs:
        for s in range(ma.n_states):
            pa, pb = ma.state_params(c, s), mb.state_params(c, s)
            for n in pa:
                d_w = max(d_w, abs(float(pa[n][2]) - float(pb[n][2])))
                if float(pa[n][2]) <= msd_floor:
                    continue
                for i, (x, y) in enumerate(zip(pa[n][:2], pb[n][:2])):
                    d = float(np.abs(x - y).max() / max(1.0, np.abs(x).max()))
                    if d > d_par:
                        d_par = d
                        where = (f" ({n} state {s} {('mean', 'var')[i]}, "
                                 f"context {c}, weight {float(pa[n][2]):.3g},"
                                 f" values {np.round(x, 6).tolist()} / "
                                 f"{np.round(y, 6).tolist()})")
        for x, y in zip(ma.durations(c), mb.durations(c)):
            d_par = max(d_par, float(np.abs(x - y).max()
                                     / max(1.0, np.abs(x).max())))
    for c in firsts:
        for n in a.gv.trees:
            for x, y in zip(a.gv.params(n, c), b.gv.params(n, c)):
                if x.size:
                    d_par = max(d_par, float(np.abs(x - y).max()
                                             / max(1.0, np.abs(x).max())))
    same_align = a.alignments.keys() == b.alignments.keys() and all(
        np.array_equal(a.alignments[k], b.alignments[k])
        for k in a.alignments)
    ok = (same_trees and gap <= ROUNDING_GAP and d_par <= 1e-8
          and d_w <= 1e-8 and same_align)
    flips = "; ".join(
        f"{m['questions'][0]} / {m['questions'][1]} at {m['node']} contexts:"
        f" gains {m['gains_x'][0]!r}, {m['gains_x'][1]!r} (first's stats) "
        f"and {m['gains_y'][0]!r}, {m['gains_y'][1]!r} (second's), gap "
        f"{m['gap']:.2e} of the rounding estimate, "
        f"{m['gap_of_gain']:.2e} of the gain"
        if "gains_x" in m else f"a split at {m['node']} contexts differs"
        for m in margins)
    return ok, (f"trees (stream, duration, GV) make the same partitions: "
                f"{same_trees} ({len(pairs)} trees, {leaves} leaves; "
                f"{named} name a split by another question: {len(margins)} "
                f"nodes, largest gap {gap:.2e} of the rounding estimate "
                f"(<= {ROUNDING_GAP})"
                f"{': ' + flips if flips else ''}); parameters max |d| / "
                f"max(1, |value|) "
                f"{d_par:.2e}{where} (<= 1e-8), msd weights {d_w:.2e} (<= 1e-8); "
                f"alignments equal: {same_align} ({len(a.alignments)} "
                f"utterances)")


def _colmax(x, dims):
    """Each column's largest magnitude (float64, floored at 1e-300)."""
    return x.double().abs().amax(dim=dims, keepdim=True).clamp(min=1e-300)


def check_k28(inp, out_k, out_p):
    """K28 against its twin: c within `tol` of each (utterance, dimension)
    column's largest |c|, q within `tol` relative, logdet within `tol` of
    sum |log d| (1e-5 in float32, 1e-12 in float64; the row build and the
    recursion are the twin's order, the sums of q and logdet are not).
    Returns (ok, max abs err, text)."""
    import torch
    (ck, qk, lk, _), (cp, qp, lp, sp) = out_k, out_p
    tol = 1e-12 if cp.dtype == torch.float64 else 1e-5
    e_c = float(((ck - cp).double().abs() / _colmax(cp, 1)).max())
    e_q = float(((qk - qp).double().abs() / qp.double().abs().clamp(
        min=1e-300)).max())
    e_l = float(((lk - lp).double().abs() / sp[0].double().log().abs().sum(
        1).clamp(min=1e-300)).max())
    same = bool((ck == cp).all())
    err = max(float((ck - cp).abs().max()), float((qk - qp).abs().max()),
              float((lk - lp).abs().max()))
    return (max(e_c, e_q, e_l) <= tol, err,
            f"{str(cp.dtype)[6:]} c err / column max {e_c:.2e}, q rel "
            f"{e_q:.2e}, logdet err / sum|log d| {e_l:.2e} (<= {tol:.0e}); "
            f"c bit-equal {same}")


def check_k29(inp, out_k, out_p):
    """K29 against its twin: g_mu and g_prec within `tol` of each
    (utterance, window, dimension) column's largest magnitude (1e-5 in
    float32, 1e-12 in float64)."""
    import torch
    tol = 1e-12 if out_p[0].dtype == torch.float64 else 1e-5
    worst = max(float(((k - p).double().abs() / _colmax(p, 1)).max())
                for k, p in zip(out_k, out_p))
    err = max(float((k - p).abs().max()) for k, p in zip(out_k, out_p))
    same = all(bool((k == p).all()) for k, p in zip(out_k, out_p))
    return (worst <= tol, err,
            f"{str(out_p[0].dtype)[6:]} g_mu, g_prec err / column max "
            f"{worst:.2e} (<= {tol:.0e}); bit-equal {same}")


def check_k30(inp, out_k, out_p):
    """K30 against its twin, per element: (sre, sim) within 1e-5 exp(lpr),
    (pre, pim) within 1e-5 exp(lar) (|nre| + |nim|): a few float32 ulps of
    the spectra's magnitude (CUDA's expf / cosf / sinf / sqrtf are the card
    twin's functions; --fmad=false rounds each product as the twin's
    separate calls do)."""
    ms = inp["lpr"].exp()
    mp = inp["lar"].exp() * (inp["nre"].abs() + inp["nim"].abs())
    worst = max(float(((k - p).abs() / (1e-5 * m).clamp(min=1e-30)).max())
                for k, p, m in zip(out_k, out_p, (ms, ms, mp, mp)))
    err = max(float((k - p).abs().max()) for k, p in zip(out_k, out_p))
    same = sum(int((k == p).sum()) for k, p in zip(out_k, out_p))
    n = sum(p.numel() for p in out_p)
    return (worst <= 1.0, err,
            f"per element err / (1e-5 x magnitude) worst {worst:.3f}; "
            f"{same} of {n} elements bit-equal")


def k18_long_inputs(dev, T: int = 9000, K: int = 200, seed: int = 18):
    """One utterance past the shared-memory rows of K18 and K20 (3 (T+1) +
    max_dur > 25600 doubles): obs_ll (1, T, K) of -3 |N(0, 1)| - 1 per
    frame, duration means 35-55 (so that K states of at most max_dur 60
    frames can cover T: a feasible chain), max_dur 60 (the recipe's)."""
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)
    obs = -3.0 * np.abs(rng.standard_normal((1, T, K))) - 1.0
    return dict(obs_ll=t(obs), dur_mean=t(rng.uniform(35, 55, (1, K))),
                dur_var=t(rng.uniform(20, 80, (1, K))), max_dur=60,
                t_len=t([T], torch.long), k_len=t([K], torch.long))


def nan_bap_inputs(hsmm, dev, seed: int = 17):
    """K17's inputs at the WORLD width with a NaN in one frame's bap
    columns (the weight-0 stream): that frame's log-likelihoods must come
    out NaN, as in the JAX package."""
    import torch
    rng = np.random.default_rng(seed)
    sts = hsmm.world_streams()
    B, Tb, Kb, R, D = 2, 24, 9, 12, 237
    fr = rng.standard_normal((B, Tb, D))
    fr[:, ::3, 150:156] = 0.0
    bap = next(st for st in sts if st.name == "bap")
    fr[1, 5, bap.sl.start + 7] = np.nan
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)
    sls, flags, wts = hsmm.stream_args(sts)
    return dict(
        frames=t(fr),
        rows=tuple(t(rng.integers(0, R, (B, Kb)), torch.long) for _ in sts),
        means=tuple(t(rng.standard_normal((R, b - a))) for a, b in sls),
        variances=tuple(t(rng.uniform(0.05, 3.0, (R, b - a)))
                        for a, b in sls),
        msd_w=tuple(t(rng.uniform(0.0, 1.0, R)) for _ in sts),
        stream_slices=sls, msd_flags=flags, weights_static=wts)


def recipe_tiny_corpus(seed: int = 2):
    """tests/test_recipe.py's corpus in numpy alone (the generator of
    tests/test_hsmm.py:18-47): phones a, b, c over the tiny 10-dim streams,
    3 states each with means 3 N(0, 1) and durations 3-8 frames from seed
    0, b unvoiced and c's middle state unvoiced; six utterances of four
    labels x^x-{p}+x=x/E:{3 + i % 2}] from `seed`, and each utterance's
    phone end frames as bootstrap spans."""
    rng0 = np.random.default_rng(0)
    means = {i: rng0.standard_normal((3, 10)) * 3.0 for i in range(3)}
    durs = {i: rng0.integers(3, 9, 3).astype(float) for i in range(3)}
    voiced = {0: [True, True, True], 1: [False, False, False],
              2: [True, False, True]}
    names = ["a", "b", "c"]
    rng = np.random.default_rng(seed)
    utts, spans = [], {}
    for ui in range(6):
        seq = [names[i] for i in rng.integers(0, 3, 4)]
        fr, bounds, t = [], [], 0
        for name in seq:
            mi = names.index(name)
            for s in range(3):
                d = max(1, int(rng.normal(durs[mi][s], 1)))
                f = means[mi][s][None] + 0.3 * rng.standard_normal((d, 10))
                if voiced[mi][s]:
                    f[:, 4] = np.abs(f[:, 4]) + 0.5
                    f[:, 8] = np.abs(f[:, 8]) + 0.5
                else:
                    f[:, 4:6] = 0.0
                    f[:, 8:10] = 0.0
                fr.append(f)
                t += d
                bounds.append(t)
        utts.append((np.concatenate(fr),
                     [f"x^x-{p}+x=x/E:{3 + i % 2}]" for i, p in
                      enumerate(seq)]))
        spans[ui] = np.asarray(bounds)[2::3]
    return utts, spans


def sung_phrase(rng, phones, frames_per, fs, pitch, vibrato=False):
    """tests/test_voice_build.py:28-50's audio: per note four harmonics
    (0.55, 0.25, 0.12, 0.05, random phases) x 0.6 plus 5e-4 white noise,
    "sil" the noise alone; returns the audio and the phone end frames.
    `vibrato`: notes of VIBRATO_MIN frames or more sway by VIBRATO_DEPTH of
    their pitch at VIBRATO_HZ (the same random draws)."""
    shift = int(fs * FRAME_PERIOD / 1000.0)
    segs, ends, total = [], [], 0
    for p, nf in zip(phones, frames_per):
        n = nf * shift
        if p == "sil":
            seg = 0.0005 * rng.standard_normal(n)
        else:
            t = np.arange(n) / fs
            if vibrato and nf >= VIBRATO_MIN:
                ph = np.cumsum(2 * np.pi * pitch[p] / fs * (
                    1 + VIBRATO_DEPTH * np.sin(2 * np.pi * VIBRATO_HZ * t)))
                seg = 0.6 * sum(
                    a * np.sin(ph * (h + 1) + rng.uniform(0, 6.28))
                    for h, a in enumerate([0.55, 0.25, 0.12, 0.05]))
            else:
                seg = 0.6 * sum(
                    a * np.sin(2 * np.pi * pitch[p] * (h + 1) * t
                               + rng.uniform(0, 6.28))
                    for h, a in enumerate([0.55, 0.25, 0.12, 0.05]))
            seg = seg + 0.0005 * rng.standard_normal(n)
        segs.append(seg)
        total += nf
        ends.append(total)
    return np.concatenate(segs), np.asarray(ends)


def voice_labels(phones):
    """Full contexts {L}^{L}-{C}+{R}={R}@{pos}_x/E:{note}], the note the
    pitch index (x for sil and past the ends)."""
    ph = ["x"] + list(phones) + ["x"]
    notes = [int(p[1:]) if p in VOICE_PITCH else "x" for p in phones]
    return [f"{ph[i]}^{ph[i]}-{ph[i + 1]}+{ph[i + 2]}={ph[i + 2]}@{i + 1}_x"
            f"/E:{notes[i]}]" for i in range(len(phones))]


def voice_phrases(rng, n, avoid=()):
    """n phrases of 6-12 notes between two "sil", none in `avoid`."""
    out = []
    names = sorted(VOICE_PITCH)
    while len(out) < n:
        k = int(rng.integers(6, 13))
        ph = ("sil",) + tuple(names[i] for i in rng.integers(0, 12, k)) \
            + ("sil",)
        if ph not in avoid and ph not in out:
            out.append(ph)
    return out


def voice_corpus(seed: int = VOICE_SEED, fs: int = 48000, vibrato=False):
    """The voice-build lane's corpus in memory: VOICE_TEMPLATES phrase
    templates, VOICE_UTTS utterances taking them in turn with fresh note
    lengths (30-80 frames; sil 20), and VOICE_UNSEEN phrases of new note
    orders for synthesis.  Returns (signals, label sequences, phone end
    frames, templates, unseen phrases)."""
    rng = np.random.default_rng(seed)
    templates = voice_phrases(rng, VOICE_TEMPLATES)
    sigs, labels, spans = [], [], {}
    for u in range(VOICE_UTTS):
        ph = templates[u % VOICE_TEMPLATES]
        nf = [20] + [int(v) for v in rng.integers(30, 81, len(ph) - 2)] \
            + [20]
        x, ends = sung_phrase(rng, ph, nf, fs, VOICE_PITCH, vibrato)
        sigs.append(x.astype(np.float32))
        labels.append(voice_labels(ph))
        spans[u] = ends
    unseen = voice_phrases(rng, VOICE_UNSEEN, avoid=templates)
    return sigs, labels, spans, templates, unseen


def pipeline_corpus(wd, wavio, n_utts=VOICE_UTTS):
    """The pipeline lane's corpus on disk under `wd`: the voice-build
    lane's 64 phrases (seed 12, 48 kHz) with vibrato on every note of
    VIBRATO_MIN frames or more, as 16-bit wavs in raw/, full-context labels
    in 100 ns units in labels/full/ with the notes by name (/E:A3] ...
    /E:Ab4]), and qconf.conf (L/C/R-Phone of the 13 phones, C-Note by
    name, the frame position in the phone).  Returns per utterance the
    signal as written and its notes as (start, end, pitch, vibrato)
    frames."""
    sigs, _, spans, templates, unseen = voice_corpus(fs=48000, vibrato=True)
    names = dict(zip(sorted(VOICE_PITCH), NOTE_NAMES))
    for sub in ("raw", "labels/full", "labels/mono"):
        os.makedirs(os.path.join(wd, sub), exist_ok=True)
    shift_100ns = int(FRAME_PERIOD * 1e4)
    out = []
    for u, x in enumerate(sigs[:n_utts]):
        phones = templates[u % VOICE_TEMPLATES]
        base = f"phrase{u:03d}"
        wavio.wavwrite(x, 48000, os.path.join(wd, "raw", f"{base}.wav"))
        x, _ = wavio.wavread(os.path.join(wd, "raw", f"{base}.wav"))
        ph = ["x"] + list(phones) + ["x"]
        lines, notes, start = [], [], 0
        for i, end in enumerate(spans[u]):
            note = names.get(phones[i], "xx")
            lines.append(f"{start * shift_100ns} {end * shift_100ns} "
                         f"{ph[i]}^{ph[i]}-{ph[i + 1]}+{ph[i + 2]}="
                         f"{ph[i + 2]}@{i + 1}_x/E:{note}]")
            if phones[i] != "sil":
                notes.append((start, int(end), VOICE_PITCH[phones[i]],
                              end - start >= VIBRATO_MIN))
            start = int(end)
        with open(os.path.join(wd, "labels", "full", f"{base}.lab"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
        out.append((x, notes))
    # the unseen phrases: labels alone, 40 frames a phone (synthesize_unseen
    # reads the contexts; the durations come from HALGN's model)
    for k, phones in enumerate(unseen[:DNN_UNSEEN]):
        ph = ["x"] + list(phones) + ["x"]
        with open(os.path.join(wd, "labels", "full", f"unseen{k}.lab"),
                  "w") as f:
            f.write("".join(
                f"{40 * i * shift_100ns} {40 * (i + 1) * shift_100ns} "
                f"{ph[i]}^{ph[i]}-{ph[i + 1]}+{ph[i + 2]}={ph[i + 2]}"
                f"@{i + 1}_x/E:{names.get(p, 'xx')}]\n"
                for i, p in enumerate(phones)))
    names_all = sorted(VOICE_PITCH) + ["sil"]
    conf = ([f"L-Phone_{p} {{*^{p}-*}}" for p in names_all]
            + [f"C-Phone_{p} {{*-{p}+*}}" for p in names_all]
            + [f"R-Phone_{p} {{*+{p}=*}}" for p in names_all]
            + [f"C-Note_{n} {{*/E:{n}]*}}" for n in NOTE_NAMES]
            + ["Pos_C-Frame_in_Phone(Fw)  MIN=1 MAX=200",
               "Pos_C-Frame_in_Phone(Bw)  MIN=1 MAX=200"])
    with open(os.path.join(wd, "qconf.conf"), "w") as f:
        f.write("\n".join(conf) + "\n")
    return out, unseen[:DNN_UNSEEN]


# tests/test_torch_pipeline.py's corpus and HALGN recipe (hard counts: the
# soft counts put one of its note states on min_occupancy's threshold)
PIPELINE_TINY_NOTES = ["G3", "A3", "Bb3"]
PIPELINE_TINY_QCONF = """
C-Phone_a  {*-a+*}
C-Phone_i  {*-i+*}
C-Phone_sil {*-sil+*}
C-Note_G3 {*/E:G3]*}
C-Note_A3 {*/E:A3]*}
C-Note_Bb3 {*/E:Bb3]*}
Pos_C-Frame_in_Phone(Fw)  MIN=1 MAX=200
Pos_C-Frame_in_Phone(Bw)  MIN=1 MAX=200
"""
PIPELINE_TINY_HALGN = dict(n_states=5, n_iters=2, tied_iters=1,
                           recluster=False, use_gv=False, use_mspf=False,
                           soft_counts=False)
# phase 4's bounds on the card-vs-CPU |d| of every frame of the corpus's
# streams (lf0 and vib where both are voiced): about four times the largest
# read on an H100 (4.77e-07, 1.31e-06, 6.68e-06 and 3.81e-06)
PIPELINE_TINY_MAX = dict(lf0=2e-6, vib=5e-6, mgc=3e-5, bap=2e-5)


def pipeline_tiny_corpus(wd, wavio, fs=16000):
    """tests/test_torch_pipeline.py's make_corpus."""
    rng = np.random.default_rng(0)
    for sub in ("raw", "labels/full", "labels/mono"):
        os.makedirs(os.path.join(wd, sub), exist_ok=True)
    for u in range(3):
        dur = 0.6
        n = int(fs * dur)
        t = np.arange(n) / fs
        f0 = np.full(n, 200.0 + 20 * u)
        if u == 0:
            f0 *= 1.0 + 0.03 * np.sin(2 * np.pi * 5.5 * t)
        ph = np.cumsum(2 * np.pi * f0 / fs)
        x = (0.5 * np.sin(ph) + 0.25 * np.sin(2 * ph)
             + 0.01 * rng.standard_normal(n))
        edge = n // 8
        x[:edge] *= 0
        x[-edge:] *= 0
        x += 0.003 * rng.standard_normal(n)
        wavio.wavwrite(0.8 * x / np.abs(x).max(), fs,
                       os.path.join(wd, "raw", f"utt{u}.wav"))
        d = int(dur * 1e7)
        e1, e2 = d // 8, d - d // 8
        lines = [f"0 {e1} x^x-sil+a=x/E:xx]",
                 f"{e1} {e2} x^sil-a+sil=x/E:{PIPELINE_TINY_NOTES[u]}]",
                 f"{e2} {d} x^a-sil+x=x/E:xx]"]
        with open(os.path.join(wd, "labels", "full", f"utt{u}.lab"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(wd, "qconf.conf"), "w") as f:
        f.write(PIPELINE_TINY_QCONF)


def voice_questions():
    """L-, C- and R-Phone_* over the 12 sung phones and sil, and C-Note
    over 0-11 (qconf format)."""
    names = sorted(VOICE_PITCH) + ["sil"]
    return "\n".join(
        [f"L-Phone_{p} {{*^{p}-*}}" for p in names]
        + [f"C-Phone_{p} {{*-{p}+*}}" for p in names]
        + [f"R-Phone_{p} {{*+{p}=*}}" for p in names]
        + ["C-Note {*/E:%d]*} MIN=0 MAX=11"])


def note_gates(y, durs, phones, n_states, fs, f0):
    """tests/test_voice_build.py:112-145's gates on one generated phrase:
    the waveform finite, the sung region's RMS > 0.01 and the first sil's
    (2 frames in from each end) < 0.25 of it, and per note the median of
    the voiced F0 (`f0`, on the frame grid) 4 frames in from each end
    within 5% of its pitch.  Returns (ok, sung rms, sil rms, worst note
    error)."""
    shift = int(fs * FRAME_PERIOD / 1000.0)
    pe = np.cumsum(np.asarray(durs).reshape(-1, n_states).sum(1))
    ps = np.concatenate([[0], pe[:-1]])

    def rms(a, b):
        seg = y[a * shift:b * shift]
        return float(np.sqrt(np.mean(seg ** 2))) if len(seg) else 0.0
    sung = rms(ps[1], pe[-2])
    sil = rms(ps[0] + 2, pe[0] - 2)
    worst = 0.0
    ok = bool(np.isfinite(y).all()) and sung > 0.01 and sil < 0.25 * sung
    for i, p in enumerate(phones):
        if p == "sil":
            continue
        seg = f0[ps[i] + 4:min(pe[i] - 4, len(f0))]
        seg = seg[seg > 0]
        if len(seg) <= 5:
            return False, sung, sil, float("inf")
        err = abs(float(np.median(seg)) - VOICE_PITCH[p]) / VOICE_PITCH[p]
        worst = max(worst, err)
    return ok and worst < 0.05, sung, sil, worst


VOICE_TINY_PITCH = {"n0": 220.0, "n1": 277.2, "n2": 329.6}
VOICE_TINY_QUESTIONS = """C-Phone_sil {*-sil+*}
C-Phone_n0 {*-n0+*}
C-Phone_n1 {*-n1+*}
C-Phone_n2 {*-n2+*}
C-Note {*/E:%d]*} MIN=0 MAX=3"""
VOICE_TINY_RECIPE = dict(
    n_states=3, n_iters=2, max_dur=80, mdl_factor=0.4, min_occupancy=0.5,
    tied_iters=1, recluster=False, use_gv=True, cdgv=False, nosilgv=True,
    silence_phones=("sil",), use_mspf=True, alpha=0.42)


def voice_tiny_corpus(bucketing, compose, device, fs: int = 16000):
    """tests/test_voice_build.py's corpus through the port: its six
    phrases of three notes (seed 7), analysed and encoded by
    `bucketed_extract` (mgc 12, bap 3) and composed with vib 0 at D = 51
    on `device`.  Returns (corpus, bootstrap spans, layout)."""
    rng = np.random.default_rng(7)
    plans = [
        (["sil", "n0", "n1", "n2", "sil"], [14, 40, 44, 48, 14]),
        (["sil", "n1", "n0", "n2", "sil"], [14, 44, 40, 48, 14]),
        (["sil", "n2", "n1", "n0", "sil"], [14, 48, 44, 40, 14]),
        (["sil", "n0", "n2", "n1", "sil"], [14, 40, 48, 44, 14]),
        (["sil", "n1", "n2", "n0", "sil"], [14, 44, 48, 40, 14]),
        (["sil", "n2", "n0", "n1", "sil"], [14, 48, 40, 44, 14]),
    ]
    layout = compose.StreamLayout(mgc_dim=12, lf0_dim=1, bap_dim=3,
                                  vib_dim=1)
    sigs, ends = [], []
    for phones, nf in plans:
        x, e = sung_phrase(rng, phones, nf, fs, VOICE_TINY_PITCH)
        sigs.append(x)
        ends.append(e)
    feats = bucketing.bucketed_extract(sigs, fs, mgc_dim=12, bap_dim=3,
                                       device=device)
    corpus, spans = [], {}
    for ui, ((lf0, mgc, bap), (phones, _)) in enumerate(zip(feats, plans)):
        T = len(lf0)
        cmp_ = compose.compose_cmp(mgc, lf0[:, None], bap, np.zeros((T, 1)),
                                   layout, device=device)
        corpus.append((cmp_.astype(np.float64),
                       [f"x^x-{p}+x=x/E:{1 + ui % 2}]" for p in phones]))
        spans[ui] = np.minimum(ends[ui], T)
    return corpus, spans, layout


def pipeline_lane(counted, profiled, device="cuda", n_utts=VOICE_UTTS):
    """Phase 13: the front half on the pipeline lane's corpus, counted
    stage by stage, ANALYZE under the profiler; prints the stage seconds
    and what the vibrato scan found, holds every stage's files to their
    gates; returns the launch counts of ANALYZE, COMPOSE + STATS and
    HALGN + MKDAT, the pipeline (its workdir kept for phase 14), the
    corpus and the unseen phrases."""
    from hts_train_world_tpu_torch import config as cfg
    from hts_train_world_tpu_torch.features import htk, qconf
    from hts_train_world_tpu_torch.io import rawio, wavio
    from hts_train_world_tpu_torch.runtime import pipeline as pl
    wd_p = tempfile.mkdtemp()
    t0 = time.perf_counter()
    utts_p, unseen_p = pipeline_corpus(wd_p, wavio, n_utts)
    audio_p = sum(len(x) for x, _ in utts_p) / 48000
    print(f"pipeline lane: corpus written in {time.perf_counter() - t0:.2f} "
          f"s: {len(utts_p)} phrases, {audio_p:.1f} s at 48 kHz, "
          f"{sum(len(n) for _, n in utts_p)} notes, "
          f"{sum(v for _, n in utts_p for *_, v in n)} with vibrato",
          flush=True)
    pipe = pl.SingingPipeline(pl.PipelineConfig(wd_p, fs=48000,
                                                use_hmm_align=True,
                                                device=device))
    lay_p = pipe.cfg.layout
    (wall_a, busy_a, _), counts_pa, _ = counted(
        "pipeline_analyze", lambda: profiled(pipe.analyze))
    _, counts_pc, _ = counted("pipeline_compose", lambda: (
        pipe.compose_stage(), pipe.stats()))
    _, counts_ph, _ = counted("pipeline_halgn", lambda: (
        pipe.halgn(), pipe.mkdat()))
    pipe.run(upto="MKDAT")                      # every stage done: no-ops
    secs_p = pipe.stage_seconds
    print("pipeline lane: stage seconds: " + ", ".join(
        f"{k} {secs_p[k]:.3f}" for k in ("ANALYZE", "COMPOSE", "STATS",
                                         "HALGN", "MKDAT"))
          + "; ANALYZE (under the profiler) by part: " + ", ".join(
              f"{k.split()[1]} {v:.3f}" for k, v in secs_p.items()
              if k.startswith("ANALYZE "))
          + f"; ANALYZE {audio_p / secs_p['ANALYZE']:.2f} audio-s/s, "
          f"its extraction alone {audio_p / secs_p['ANALYZE extract']:.2f}; "
          f"LOWESS + vibrato scan "
          f"{100 * secs_p['ANALYZE vibrato'] / secs_p['ANALYZE']:.1f}% of "
          f"ANALYZE; device busy {busy_a:.3f} s of {wall_a:.3f} s, idle "
          f"{100 - 100 * busy_a / wall_a:.1f}%", flush=True)
    print("pipeline lane: HALGN's train_voice stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in pipe.halgn_seconds.items()), flush=True)

    # gates on every stage's files, and what the vibrato scan found
    n_in = qconf.num_features(qconf.parse_config(
        open(os.path.join(wd_p, "qconf.conf")).read()))
    bad, runs, found, depth_r, period = [], 0, 0, [], []
    for u, (x, notes) in enumerate(utts_p):
        b = f"phrase{u:03d}"
        Tp = cfg.samples_for_dio(48000, len(x), FRAME_PERIOD)
        st = {n: rawio.read_f32(pipe._p(n, b, n)) for n in ("lf0", "mgc",
                                                             "bap", "vib")}
        dims = dict(lf0=lay_p.lf0_dim, mgc=lay_p.mgc_dim, bap=lay_p.bap_dim,
                    vib=lay_p.vib_dim)
        for n, v in st.items():
            if v.size != Tp * dims[n] or not np.isfinite(v).all():
                bad.append(f"{b}.{n}")
        cmp_d, _, _ = htk.read_htk(pipe._p("cmp", b, "cmp"))
        with open(pipe._p("cmp", b, "cmp"), "rb") as f:
            head = np.frombuffer(f.read(8), "=i4").tolist() + \
                np.frombuffer(f.read(4), "=i2").tolist()
        if head != [Tp, 50000, 4 * lay_p.cmp_dim, 9] \
                or cmp_d.shape != (Tp, 237) or not np.isfinite(cmp_d).all():
            bad.append(f"{b}.cmp {head}")
        ffo = rawio.read_f32(pipe._p("ffo", b, "ffo"), lay_p.ffo_dim)
        ffi = rawio.read_f32(pipe._p("ffi", b, "ffi"), n_in)
        if ffo.shape != (Tp, 238) or not np.isfinite(ffo).all() \
                or ffi.shape != (Tp, n_in) or not np.isfinite(ffi).all():
            bad.append(f"{b}.ffo/ffi")
        for sub in ("align", "fal"):
            rows = [ln.split() for ln in open(os.path.join(
                wd_p, "labels", sub, f"{b}.lab")).read().splitlines()]
            ends = [int(r[1]) for r in rows]
            starts = [int(r[0]) for r in rows]
            if starts[0] != 0 or starts[1:] != ends[:-1] \
                    or any(e <= s0 for s0, e in zip(starts, ends)) \
                    or ends[-1] != Tp * 50000:
                bad.append(f"labels/{sub}/{b}")
        f0p = np.where(st["lf0"].reshape(Tp, 2)[:, 0] != 0,
                       np.exp(st["lf0"].reshape(Tp, 2)[:, 0]), 0.0)
        vib = st["vib"].reshape(Tp, 2)
        for s0, e, pitch, vibr in notes:
            v = f0p[s0:min(e, Tp)] >= 55.0
            edges = np.flatnonzero(np.diff(np.concatenate([[0], v, [0]])))
            runs += int(((edges[1::2] - edges[::2]) > 20).sum())
            on = vib[s0:e, 0] != np.float32(1e-8)
            if vibr and on.any():
                found += 1
                depth_r.append(float(np.median(np.exp(vib[s0:e, 0][on])))
                               / (VIBRATO_DEPTH * pitch))
                period.append(float(np.median(np.exp(vib[s0:e, 1][on]))))
    for name in ("ffo", "mgc", "lf0", "bap", "gv"):
        v = rawio.read_f32(os.path.join(wd_p, "stats", f"{name}.var"))
        if not v.size or not np.isfinite(v).all():
            bad.append(f"stats/{name}.var")
    n_vib = sum(v for _, n in utts_p for *_, v in n)
    print(f"pipeline lane: {runs} voiced runs of more than 20 frames in the "
          f"notes; vibrato found on {found} of {n_vib} vibrato notes, depth "
          f"/ sung depth median "
          f"{np.median(depth_r) if depth_r else float('nan'):.3f}, period "
          f"median {np.median(period) if period else float('nan'):.2f} "
          f"frames (sung {1000.0 / VIBRATO_HZ / FRAME_PERIOD:.2f}); files: "
          f"{'all pass' if not bad else bad[:8]}", flush=True)
    if bad:
        raise RuntimeError(f"pipeline lane: files fail their gates: "
                           f"{bad[:8]}")
    return counts_pa, counts_pc, counts_ph, pipe, utts_p, unseen_p


def pipeline_card_vs_cpu(devices=("cuda", "cpu")):
    """Phase 4 for the pipeline lane: tests/test_torch_pipeline.py's
    corpus through the front half on the card and on the CPU; the streams
    within the CPU tests' tolerances (medians) and within
    `PIPELINE_TINY_MAX` on every frame, then, from the CPU's streams, the
    cmp, ffo, alignments and ffi equal at hard counts.  HALGN again at the
    lane's own recipe (soft counts) from the same streams: the alignments
    equal and every tree alike, or else the first tree that differs does
    so at a `min_occupancy` tie (`occupancy_ties`, within 1e-8 of the
    threshold, the bound phase 4 holds the recipe's parameters to)."""
    from hts_train_world_tpu_torch.io import rawio, wavio
    from hts_train_world_tpu_torch.models import clustering, recipe
    from hts_train_world_tpu_torch.runtime import pipeline as pl
    wds = {d: tempfile.mkdtemp() for d in devices}
    pipes = {}
    for d, wd in wds.items():
        pipeline_tiny_corpus(wd, wavio)
        pipes[d] = pl.SingingPipeline(pl.PipelineConfig(
            wd, fs=16000, use_hmm_align=True,
            hmm=recipe.RecipeConfig(**PIPELINE_TINY_HALGN), device=d))
        pipes[d].run(upto="ANALYZE")
    lay_t = pipes[devices[1]].cfg.layout
    worst = {}
    ok_s = True
    for u in range(3):
        b = f"utt{u}"
        g = {n: rawio.read_f32(pipes[devices[0]]._p(n, b, n), w) for n, w in (
            ("lf0", 2), ("mgc", lay_t.mgc_dim), ("bap", lay_t.bap_dim),
            ("vib", 2))}
        c = {n: rawio.read_f32(pipes[devices[1]]._p(n, b, n), v.shape[1])
             for n, v in g.items()}
        for n in ("lf0", "vib"):
            for k in range(2):
                off = 0.0 if n == "lf0" else np.float32(1e-8)
                lg, lc = g[n][:, k] != off, c[n][:, k] != off
                agree = float((lg == lc).mean())
                both = lg & lc
                d = np.abs(g[n][both, k] - c[n][both, k])
                med, mx = ((float(np.median(d)), float(d.max()))
                           if both.any() else (0.0, 0.0))
                a0, m0, x0 = worst.get(f"{n}{k}", (1.0, 0.0, 0.0))
                worst[f"{n}{k}"] = (min(a0, agree), max(m0, med), max(x0, mx))
                ok_s &= (agree > 0.9 and med < 1e-3
                         and mx <= PIPELINE_TINY_MAX[n])
        for n in ("mgc", "bap"):
            d = np.abs(g[n] - c[n])
            _, m0, x0 = worst.get(n, (None, 0.0, 0.0))
            worst[n] = (None, max(m0, float(np.median(d))),
                        max(x0, float(d.max())))
            ok_s &= np.median(d) < 0.01 and d.max() <= PIPELINE_TINY_MAX[n]
    for n in ("lf0", "mgc", "bap", "vib"):
        for u in range(3):
            shutil.copy(pipes[devices[1]]._p(n, f"utt{u}", n),
                        pipes[devices[0]]._p(n, f"utt{u}", n))
    for d in wds:
        pipes[d].run(upto="MKDAT")

    def same_files(subs):
        return {sub: all(filecmp.cmp(
            os.path.join(wds[devices[0]], sub, f"utt{u}.{ext}"),
            os.path.join(wds[devices[1]], sub, f"utt{u}.{ext}"),
            shallow=False) for u in range(3)) for sub, ext in subs}
    labs = (("labels/align", "lab"), ("labels/fal", "lab"))
    same = same_files((("cmp", "cmp"), ("ffo", "ffo"), *labs,
                       ("ffi", "ffi")))
    built = {}
    for d in devices:
        pipes[d].cfg.hmm = None          # the lane's recipe: soft counts
        pipes[d].manifest.reset_from("HALGN", pl.STAGES)
        with recording_trees(clustering) as built[d]:
            pipes[d].halgn()
    soft = same_files(labs)
    at, ties = occupancy_ties(built[devices[0]], built[devices[1]], 1e-8)
    ok_soft = (at is None and all(soft.values())) or bool(ties)
    print(f"pipeline lane, card vs CPU path (tests/test_torch_pipeline.py's "
          f"corpus, 16 kHz): streams " + ", ".join(
              f"{k} " + (f"{v[0]:.3f} agree / " if v[0] is not None
                         else "") + f"med |d| {v[1]:.2e} / max |d| {v[2]:.2e}"
              for k, v in worst.items())
          + f" (V/UV > 0.9, med lf0/vib < 1e-3, mgc/bap < 1e-2; max "
          + ", ".join(f"{k} <= {v:.0e}" for k, v in PIPELINE_TINY_MAX.items())
          + f"); from the CPU's streams equal at hard counts: {same}; at "
          f"soft counts (the lane's recipe) equal: {soft}, "
          + ("every tree alike" if at is None else
             f"tree {at} of {len(built[devices[0]])} (build order) differs "
             f"first, min_occupancy ties: " + ("; ".join(
                 f"{t['question']} at {t['contexts']} contexts, branch "
                 f"occupancies {t['occupancies'][0]} (card) / "
                 f"{t['occupancies'][1]} (CPU), |occ - {t['threshold']}| "
                 f"{t['distance']:.2e}" for t in ties) or "none")),
          flush=True)
    if not (ok_s and all(same.values()) and ok_soft):
        raise RuntimeError("the card's pipeline disagrees with the CPU path")
    for wd in wds.values():
        shutil.rmtree(wd)


def _device_busy_s(prof):
    """Device time of a profile's CUDA events in seconds, and the three
    kernels that took most of it as (name, seconds).  User annotations
    on the device's timeline (the "Optimizer.step#..." range that
    torch.optim records) span kernels counted already and are left out."""
    import torch
    evs = sorted(((e.key, getattr(e, "self_device_time_total", getattr(
        e, "self_cuda_time_total", 0.0)) / 1e6) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith("Optimizer.")),
        key=lambda kv: -kv[1])
    return sum(t for _, t in evs), evs[:3]


def dnn_lanes(counted, device="cuda", frame_steps=DNN_FRAME_STEPS,
              traj_steps=DNN_TRAJ_STEPS, hidden=(2048, 2048, 2048)):
    """Phase 14 (a) and (b) through `training.train`: frame mode at the
    reference's default recipe (n_in 1186, 3 x 2048 sigmoid, n_out 238,
    batch 256, Adam 1e-3, variances 1e-5) on DNN_FRAMES frames from a
    seed (y a noisy linear map of x, so the NLL falls), frames/s and step
    ms over the steps from the 20th to the 240th (each log line syncs), 20
    more under the profiler for the idle share; then trajectory mode on
    32 utterances of DNN_T frames (dims DNN_DIMS, MSD DNN_MSD), counted
    and recorded (K28, K29), frames/s over the steps from the 10th.
    Returns (the trajectory run's counts, its first K28 and K29 launches'
    recorded inputs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hts_train_world_tpu_torch.models import acoustic, dataio, training
    rng = np.random.default_rng(DNN_SEED)
    ncol = sum(DNN_MSD) + 3 * sum(DNN_DIMS)
    W = (rng.standard_normal((1186, ncol)) / np.sqrt(1186)).astype(
        np.float32)
    T = DNN_T
    pairs = []
    for i in range(DNN_FRAMES // T):
        x = rng.standard_normal((T, 1186)).astype(np.float32)
        y = x @ W + 0.1 * rng.standard_normal((T, ncol)).astype(np.float32)
        pairs.append(dataio.UtterancePair(f"u{i}", x, y))
    cfg = acoustic.ModelConfig(n_in=1186, n_out=ncol, hidden=hidden)
    tmp = tempfile.mkdtemp()

    def run(tc, marks, window=None, **kw):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        busy = []

        def log(msg):
            if not msg.startswith("step "):
                return
            step = int(msg.split()[1][:-1])
            marks.append((step, time.perf_counter(),
                          float(msg.split("cost=")[1].split()[0])))
            if window and step == window[0]:
                prof.__enter__()
            elif window and step == window[1]:
                prof.__exit__(None, None, None)
                busy.append((*_device_busy_s(prof),
                             marks[-1][1] - marks[-2][1]))
        training.train(cfg, tc, pairs,
                       os.path.join(tmp, str(tc.trajectory)), log=log,
                       device=device, **kw)
        return busy

    def rate(marks, a, b, frames):
        (sa, ta, _), (sb, tb, _) = (next(m for m in marks if m[0] == s)
                                    for s in (a, b))
        return (sb - sa) * frames / (tb - ta), 1e3 * (tb - ta) / (sb - sa)

    fm = []
    busy = run(training.TrainConfig(
        num_steps=frame_steps, batch_size=256, log_interval=20,
        save_interval=10 ** 9, valid_fraction=0.0), fm,
        window=(frame_steps - 40, frame_steps - 20))
    fps, step_ms = rate(fm, 20, frame_steps - 60, 256)
    (b_s, top, w_s), = busy
    print(f"DNN lane (a), frame mode at 3 x {hidden[0]} sigmoid, n_in 1186, "
          f"n_out {ncol}, batch 256, Adam: {fps:.1f} frames/s, step "
          f"{step_ms:.3f} ms over steps 20-{frame_steps - 60}; cost "
          f"{fm[0][2]:.5f} at step {fm[0][0]} -> {fm[-1][2]:.5f} at step "
          f"{fm[-1][0]}; 20 steps under the profiler: device busy "
          f"{b_s:.4f} s of {w_s:.4f} s, idle {100 - 100 * b_s / w_s:.1f}%; "
          f"most device time: " + "; ".join(f"{k[:60]} {1e3 * t:.2f} ms"
                                             for k, t in top), flush=True)
    if not fm[-1][2] < fm[0][2] or not np.isfinite(fm[-1][2]):
        raise RuntimeError("DNN lane (a): the frame NLL did not fall")

    tm = []
    rec: list = []
    tc = training.TrainConfig(num_steps=traj_steps, batch_size=1,
                              log_interval=10, save_interval=10 ** 9,
                              trajectory=True, valid_fraction=0.0)
    _, counts, _ = counted("dnn_trajectory", lambda: run(
        tc, tm, feature_dims=DNN_DIMS, msd_flags=DNN_MSD), record=rec)
    tps, tstep = rate(tm, 10, traj_steps, T)
    firsts = {}
    for name, inp in rec:
        firsts.setdefault(name, inp)
    from hts_train_world_tpu_torch.ops import trajectory as tr
    us = {"trajectory_nll": float("nan"), "trajectory_adjoint": float("nan")}
    for name, inp in firsts.items():       # none on the CPU
        f = tr.trajectory_forward if name == "trajectory_nll" \
            else tr.trajectory_backward
        f(**inp)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(10):
            f(**inp)
        b.record()
        b.synchronize()
        us[name] = 1e3 * a.elapsed_time(b) / 10
    print(f"DNN lane (b), trajectory mode, one utterance of {T} frames, dims "
          f"{DNN_DIMS}, MSD {DNN_MSD}: {tps:.1f} frames/s, step {tstep:.3f} "
          f"ms over steps 10-{traj_steps}; cost {tm[0][2]:.5f} -> "
          f"{tm[-1][2]:.5f}; K28 {us['trajectory_nll']:.1f} us a launch, "
          f"K29 {us['trajectory_adjoint']:.1f} us a launch "
          f"({counts.get('trajectory_nll', 0)} and "
          f"{counts.get('trajectory_adjoint', 0)} launches)", flush=True)
    if not np.isfinite(tm[-1][2]):
        raise RuntimeError("DNN lane (b): the trajectory cost is not finite")
    shutil.rmtree(tmp)
    return counts, list(firsts.items())


def _traj_nll(pipe, model, bases):
    """The trajectory NLL of `model` summed over `bases`' ffi/ffo (the
    measure of tests/test_pipeline_bridge.py:87-112)."""
    import torch
    from hts_train_world_tpu_torch.models import acoustic, dataio
    fd, mf, gv = pipe._traj_meta()
    n_in = pipe._model_cfg().n_in
    total = 0.0
    with torch.no_grad():
        for b in bases:
            pr = dataio.load_pair(b, pipe._p("ffi", b, "ffi"),
                                  pipe._p("ffo", b, "ffo"), n_in,
                                  pipe.cfg.layout.ffo_dim)
            x = torch.as_tensor(pr.ffi, device=pipe.dev)
            pred, var = model(x, torch.zeros(len(x), dtype=torch.long,
                                             device=pipe.dev))
            c, _ = acoustic.trajectory_cost(
                pred, torch.as_tensor(pr.ffo, device=pipe.dev), var[0],
                torch.as_tensor(gv, dtype=torch.float32, device=pipe.dev),
                fd, mf)
            total += float(c)
    return total


def _frame_nll(pipe, model, bases):
    """The frame NLL (acoustic.frame_cost) of `model` over `bases`'
    frames."""
    import torch
    from hts_train_world_tpu_torch.models import acoustic, dataio
    n_in = pipe._model_cfg().n_in
    prs = [dataio.load_pair(b, pipe._p("ffi", b, "ffi"),
                            pipe._p("ffo", b, "ffo"), n_in,
                            pipe.cfg.layout.ffo_dim) for b in bases]
    x = torch.as_tensor(np.concatenate([p.ffi for p in prs]),
                        device=pipe.dev)
    y = torch.as_tensor(np.concatenate([p.ffo for p in prs]),
                        device=pipe.dev)
    with torch.no_grad():
        pred, var = model(x, torch.zeros(len(x), dtype=torch.long,
                                         device=pipe.dev))
        return float(acoustic.frame_cost(pred, y, var))


def _captured(fn):
    """Run fn with its stdout captured and echoed; returns the lines."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    out = buf.getvalue()
    print(out, end="", flush=True)
    return out.splitlines()


def _log_costs(lines):
    return [(int(ln.split()[1][:-1]), float(ln.split("cost=")[1].split()[0]))
            for ln in lines if ln.startswith("step ")]


def dnn_pipeline_lane(pipe, utts, unseen, counted, profiled,
                      steps=DNN_TRDNN_STEPS, traj_steps=DNN_TRJGV_STEPS,
                      hidden=(2048, 2048, 2048)):
    """Phase 14 (c): the pipeline's DNN half on phase 13's workdir (64
    phrases, D = 237, n_in from the lane's qconf) at hidden `hidden` and
    TrainConfig()'s defaults but num_steps: TRDNN, TRJGV, MSPFD (use_mspf),
    PGEN and WGEN counted stage by stage, WGEN under the profiler, then
    synthesize_unseen of the unseen phrases.  Gates: the frame NLL falls
    (over 8 phrases, from the initial model's by more than 0.1; and
    from the first logged mean to the last),
    the warm-started model's trajectory NLL below the frame model's, the
    generated files finite, the unseen wavs audible (note_gates' RMS
    gates); the unseen notes' F0 error is reported.  Returns the counts
    by stage."""
    import torch
    from hts_train_world_tpu_torch.features import decode, qconf
    from hts_train_world_tpu_torch.io import rawio, wavio
    from hts_train_world_tpu_torch.models import acoustic, training
    pipe.cfg.model = acoustic.ModelConfig(
        n_in=pipe._model_cfg().n_in, n_out=pipe.cfg.layout.ffo_dim,
        hidden=hidden)
    pipe.cfg.train = training.TrainConfig(num_steps=steps)
    pipe.cfg.trajectory_steps = traj_steps
    pipe.cfg.use_mspf = True
    pipe.cfg.mspf_weight = DNN_MSPF_WEIGHT
    counts = {}
    lines = _captured(pipe.train_dnn)
    costs = _log_costs(lines)
    lines_t = []
    _, counts["pipeline_trjgv"], _ = counted(
        "pipeline_trjgv", lambda: lines_t.extend(_captured(pipe.trjgv)))
    _, counts["pipeline_mspfd"], _ = counted("pipeline_mspfd", pipe.mspfd)
    _, counts["pipeline_pgen"], _ = counted("pipeline_pgen", pipe.generate)
    (wall_w, busy_w, _), counts["pipeline_wgen"], _ = counted(
        "pipeline_wgen", lambda: profiled(pipe.synthesize_stage))
    bases = pipe.utterances()
    t0 = time.perf_counter()
    wavs, counts["pipeline_unseen"], _ = counted(
        "pipeline_unseen", lambda: [pipe.synthesize_unseen(f"unseen{k}")
                                    for k in range(len(unseen))])
    t_unseen = time.perf_counter() - t0
    secs = pipe.stage_seconds
    audio = sum(len(x) for x, _ in utts) / 48000
    print(f"DNN lane (c), the pipeline's DNN half ({len(bases)} phrases, 3 x "
          f"{hidden[0]}): stage seconds " + ", ".join(
              f"{k} {secs[k]:.3f}" for k in ("TRDNN", "TRJGV", "MSPFD",
                                             "PGEN", "WGEN"))
          + f" (WGEN under the profiler); TRDNN "
          f"{steps * pipe.cfg.train.batch_size / secs['TRDNN']:.1f} "
          f"frames/s; PGEN {len(bases) / secs['PGEN']:.2f} utterances/s; "
          f"WGEN {audio / secs['WGEN']:.2f} audio-s/s, device busy "
          f"{busy_w:.3f} s of {wall_w:.3f} s, idle "
          f"{100 - 100 * busy_w / wall_w:.1f}%; synthesize_unseen "
          f"{t_unseen / len(unseen):.3f} s a phrase", flush=True)

    # gates
    init = acoustic.init_params(torch.Generator().manual_seed(
        pipe.cfg.train.seed), pipe.cfg.model).to(pipe.dev)
    frame_nll = (_frame_nll(pipe, init, bases[:8]),
                 _frame_nll(pipe, pipe._restore_params(os.path.join(
                     pipe.wd, "model")), bases[:8]))
    trj = _traj_nll(pipe, pipe._restore_params(os.path.join(
        pipe.wd, "model_trj")), bases[:8])
    frm = _traj_nll(pipe, pipe._restore_params(os.path.join(
        pipe.wd, "model")), bases[:8])
    lay = pipe.cfg.layout
    bad = []
    for b in bases:
        st = {ext: rawio.read_f32(pipe._p("gen", b, ext), d) for ext, d in (
            ("mgc", lay.mgc_dim), ("lf0", lay.lf0_dim), ("bap", lay.bap_dim),
            ("vuv", 1))}
        bad += [f"gen/{b}.{ext}" for ext, v in st.items()
                if not np.isfinite(v).all()]
        # the decode WGEN ran (an overflowing spectrum makes a NaN wave,
        # which the int16 file no longer shows)
        lf0_1 = np.where(st["lf0"][:, 0] < -1e9, 0.0, st["lf0"][:, 0])
        dec = decode.decode_features(
            *(torch.as_tensor(np.asarray(v, np.float32), device=pipe.dev)
              for v in (lf0_1, st["mgc"], st["bap"])), 48000,
            pipe.fft_size)
        if not all(bool(torch.isfinite(v).all()) for v in dec):
            bad.append(f"decode of gen/{b}")
        y, _ = wavio.wavread(pipe._p("gen", b, "wav"))
        if not np.abs(y).max() > 0:
            bad.append(f"gen/{b}.wav")
    # how well the generated pitch follows the sung one on the corpus:
    # PGEN's files (TRJGV's model) and the frame model's generation
    d_lf0 = {"trj": [], "frame": []}
    frame_model = pipe._restore_params(os.path.join(pipe.wd, "model"))
    var = pipe._ffo_var()
    for b in bases[:8]:
        nl = rawio.read_f32(pipe._p("lf0", b, "lf0"), lay.lf0_dim)[:, 0]
        _, gf = pipe._gen_one(rawio.read_f32(pipe._p("ffi", b, "ffi"),
                                             pipe.cfg.model.n_in),
                              frame_model, var, pipe._alpha(), None)
        for k, gl in (("trj", rawio.read_f32(pipe._p("gen", b, "lf0"),
                                             lay.lf0_dim)[:, 0]),
                      ("frame", gf.lf0[:, 0].cpu().numpy())):
            both = (gl > -1e9) & (nl != 0)
            d_lf0[k].append(np.abs(gl[both] - nl[both]))
    d_lf0 = {k: np.concatenate(v) for k, v in d_lf0.items()}
    feats = qconf.parse_config(open(os.path.join(pipe.wd,
                                                 "qconf.conf")).read())
    model = pipe._restore_params()
    shift_100ns = int(pipe.cfg.frame_period * 1e4)
    notes, audible = [], True
    for k, (phones, wav) in enumerate(zip(unseen, wavs)):
        lab = open(pipe._p("gen", f"unseen{k}", "lab")).read()
        rows = [ln.split() for ln in lab.splitlines()]
        durs = np.diff([0] + [int(r[1]) // shift_100ns for r in rows])
        ffi = qconf.encode_labels(feats, qconf.parse_aligned_labels(
            lab, shift_100ns))
        mgc, g = pipe._gen_one(np.asarray(ffi), model, var, pipe._alpha(),
                               pipe._load_mspf())
        lf0 = g.lf0[:, 0]
        lf0_1 = torch.where(lf0 > -1e9, lf0, torch.zeros_like(lf0))
        dec = decode.decode_features(lf0_1.float(), mgc.float(),
                                     g.bap.float(), 48000, pipe.fft_size)
        f0 = dec[0].cpu().numpy()
        y, _ = wavio.wavread(wav)
        ok, sung, sil, worst = note_gates(y, durs, list(phones), 5, 48000,
                                          f0)
        audible &= (all(bool(torch.isfinite(v).all()) for v in dec)
                    and sung > 0.01 and sil < 0.25 * sung)
        notes.append((sung, sil, worst))
    print(f"DNN lane (c) gates: frame NLL over 8 phrases, initial "
          f"{frame_nll[0]:.5f} -> trained {frame_nll[1]:.5f} (logged "
          f"{costs[0][1]:.5f} at step {costs[0][0]} -> {costs[-1][1]:.5f} "
          f"at step {costs[-1][0]}); "
          f"trajectory NLL over 8 phrases, frame model {frm:.4f} -> "
          f"warm-started {trj:.4f} (TRJGV: "
          + ", ".join(f"step {s} {c:.5f}" for s, c in _log_costs(lines_t))
          + f"); generated files finite: {not bad}; corpus lf0 |gen - "
          f"sung| where both voiced (8 phrases), median / 90th pct: PGEN "
          f"(TRJGV's model) {np.median(d_lf0['trj']):.4f} / "
          f"{np.percentile(d_lf0['trj'], 90):.4f} nats, the frame model "
          f"{np.median(d_lf0['frame']):.4f} / "
          f"{np.percentile(d_lf0['frame'], 90):.4f}; unseen phrases (sung "
          f"RMS, sil RMS, worst note F0 error): "
          + ", ".join(f"({a:.4f}, {b:.4f}, {100 * c:.1f}%)"
                      for a, b, c in notes)
          + f"; audible: {audible}", flush=True)
    if not (frame_nll[1] < frame_nll[0] - 0.1 and costs[-1][1] < costs[0][1]
            and trj < frm and not bad and audible):
        raise RuntimeError("DNN lane (c): a gate failed")
    return counts


# phase 4 for the DNN half: tests/test_torch_pipeline_dnn.py's recipe
DNN_TINY_TRAIN = dict(num_steps=100, batch_size=128, log_interval=50,
                      save_interval=50, valid_fraction=0.0)
# bounds on card vs CPU: the logged costs (absolute), the weights and
# PGEN's mgc relative to each array's largest magnitude, lf0 and bap
DNN_TINY_MAX = dict(cost=1e-4, weights=1e-4, mgc=2e-3, lf0=1e-5, bap=1e-5)


def dnn_card_vs_cpu(devices=("cuda", "cpu")):
    """Phase 4 for the DNN half: tests/test_torch_pipeline.py's corpus
    (16 kHz) through the front half on the CPU, then HALGN (hard counts)
    .. WGEN on the card and on the CPU from those files, hidden (32, 32),
    100 frame steps and 10 trajectory steps, MSPF at weight 0.5: the
    logged costs, the weights of both checkpoints and PGEN's files within
    `DNN_TINY_MAX`, V/UV equal."""
    from hts_train_world_tpu_torch.io import rawio, wavio
    from hts_train_world_tpu_torch.models import acoustic, recipe, training
    from hts_train_world_tpu_torch.runtime import pipeline as pl
    base = tempfile.mkdtemp()
    pipeline_tiny_corpus(base, wavio)
    pl.SingingPipeline(pl.PipelineConfig(base, fs=16000, device="cpu")).run(
        upto="STATS")
    pipes, logs = {}, {}
    for d in devices:
        wd = os.path.join(base, d.replace(":", "_"))
        shutil.copytree(base, wd, ignore=shutil.ignore_patterns(
            *(x.replace(":", "_") for x in devices)))
        p = pipes[d] = pl.SingingPipeline(pl.PipelineConfig(
            wd, fs=16000, use_hmm_align=True,
            hmm=recipe.RecipeConfig(**PIPELINE_TINY_HALGN),
            model=acoustic.ModelConfig(n_in=8, n_out=238, hidden=(32, 32)),
            train=training.TrainConfig(**DNN_TINY_TRAIN),
            trajectory_steps=10, use_mspf=True, mspf_weight=0.5, device=d))
        logs[d] = _log_costs(_captured(p.run))
    g, c = (pipes[d] for d in devices)
    e_cost = max(abs(a[1] - b[1]) for a, b in zip(logs[devices[0]],
                                                 logs[devices[1]]))
    e_w = 0.0
    for sub in ("model", "model_trj"):
        wg = acoustic.params_to_numpy(g._restore_params(os.path.join(
            g.wd, sub)))
        wc = acoustic.params_to_numpy(c._restore_params(os.path.join(
            c.wd, sub)))
        for lg, lc in zip(wg["layers"] + [wg["variance"]],
                          wc["layers"] + [wc["variance"]]):
            for k in lc:
                e_w = max(e_w, float(np.abs(lg[k] - lc[k]).max()
                                     / np.abs(lc[k]).max()))
    lay = c.cfg.layout
    e_f, vuv_same = {}, True
    for u in range(3):
        b = f"utt{u}"
        vuv_same &= np.array_equal(rawio.read_f32(g._p("gen", b, "vuv")),
                                   rawio.read_f32(c._p("gen", b, "vuv")))
        for ext, dim in (("mgc", lay.mgc_dim), ("lf0", lay.lf0_dim),
                         ("bap", lay.bap_dim)):
            x = rawio.read_f32(g._p("gen", b, ext), dim)
            w = rawio.read_f32(c._p("gen", b, ext), dim)
            live = w > -1e9
            vuv_same &= np.array_equal(x > -1e9, live)
            e_f[ext] = max(e_f.get(ext, 0.0), float(
                np.abs(x[live] - w[live]).max() / np.abs(w[live]).max()))
    print(f"DNN half, card vs CPU path (tests/test_torch_pipeline.py's "
          f"corpus, 16 kHz, hidden (32, 32)): logged costs max |d| "
          f"{e_cost:.2e}, weights (model/, model_trj/) worst |d| / max "
          f"{e_w:.2e}, PGEN " + ", ".join(f"{k} {v:.2e}" for k, v in
                                          e_f.items())
          + f", V/UV and MAGIC equal {vuv_same} (bounds "
          + ", ".join(f"{k} {v:.0e}" for k, v in DNN_TINY_MAX.items())
          + ")", flush=True)
    if not (e_cost <= DNN_TINY_MAX["cost"] and e_w <= DNN_TINY_MAX["weights"]
            and all(e_f[k] <= DNN_TINY_MAX[k] for k in e_f) and vuv_same):
        raise RuntimeError("the card's DNN half disagrees with the CPU path")
    shutil.rmtree(base)


# the parity lane (phase 15): the exact path in float64 on the reference's
# noise stream, the synth CLI at its default and the streaming synthesizer
STREAM_SIZES = (64, 256, 1024)
PARITY_CV_FS, PARITY_CV_T = 16000, 241


def parity_params(T: int, fs: int, seed: int = 15):
    """f0 / sp / ap (numpy float64) of one utterance with long unvoiced
    runs (at 16 kHz the 500 Hz default wraps on sample boundaries) and ap
    at its 0.999999999999 clip near Nyquist."""
    from hts_train_world_tpu_torch import config as cfg
    rng = np.random.default_rng(seed)
    N = cfg.cheaptrick_fft_size(fs)
    f0 = 150.0 + 60.0 * np.sin(np.arange(T) / 7.0)
    f0[T // 8:T // 8 + 40] = 0.0
    f0[T // 2:T // 2 + 30] = 0.0
    f0[-6:] = 0.0
    freq = np.arange(N // 2 + 1) / N * fs
    sp = (np.exp(-freq[None, :] / 1500.0)
          * (1.0 + 0.5 * rng.random((T, 1))) + 1e-6)
    ap = np.clip(freq[None, :] / (fs / 2) + 0.1 * rng.random((T, 1)),
                 0.0, 1.0)
    return f0, sp, ap


def parity_lane(counted, profiled, feats, device="cuda", timed=ITERS):
    """Phase 15 (a): the headline batch's features (the feature lane's
    lf0 / mgc / bap) read into float64, decoded by K12 and synthesised by
    the exact path (K9, K10, the min-phase FFTs, K30, irfft, K11) on one
    view of the reseeded stream: counted and recorded, then audio-s/s over
    `timed` batches after one warm batch and one batch under the profiler.
    Returns (counts, recorded launches, waveforms)."""
    import torch
    from hts_train_world_tpu_torch import config as cfg
    from hts_train_world_tpu_torch.features import decode
    from hts_train_world_tpu_torch.ops import rand
    from hts_train_world_tpu_torch.ops import synthesis as syn
    lf0, mgc, bap = (v.to(device=device, dtype=torch.float64) for v in feats)
    B, T = lf0.shape
    N = cfg.cheaptrick_fft_size(FS)
    yl = cfg.y_length_for(T, FRAME_PERIOD, FS)
    stream = rand.randn_stream(syn.synthesis_stream_len(yl),
                               device)[None].expand(B, -1)

    def lane():
        f0, sp, ap = decode.decode_features(lf0, mgc, bap, FS, N)
        return syn.synthesis(f0, sp, ap, N, FRAME_PERIOD, FS, yl, stream,
                             exact=True)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    lane()                                           # warm-up
    y, counts, rec = counted("parity_lane", lane, record=True)
    if y.shape != (B, yl) or y.dtype != torch.float64 \
            or not bool(torch.isfinite(y).all()):
        raise RuntimeError("parity lane: unexpected shape, dtype or "
                           "non-finite waveform")
    rms = float(y.pow(2).mean().sqrt())
    sync()
    t0 = time.perf_counter()
    for _ in range(timed):
        lane()
    sync()
    dt = time.perf_counter() - t0
    wall, busy, _ = profiled(lane)
    peak = 0.0
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        lane()
        sync()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    f0 = decode.decode_features(lf0, mgc, bap, FS, N)[0]
    pl = syn.time_base(f0, FRAME_PERIOD, FS, yl, N,
                       syn.default_max_pulses(yl, FS))
    print(f"parity lane ({B} x {yl / FS:.1f} s at {FS} Hz, float64, exact "
          f"path): {B * yl / FS * timed / dt:.2f} audio-s/s over {timed} "
          f"batches ({1e3 * dt / timed:.1f} ms a batch); under the profiler "
          f"{1e3 * wall:.1f} ms, device busy {1e3 * busy:.1f} ms, idle "
          f"{100 * (1 - busy / wall):.1f}%; peak device memory of a batch "
          f"{peak:.2f} GiB; pulses {pl.n.tolist()} (cap "
          f"{pl.pidx.shape[1]}); y rms {rms:.4f}", flush=True)
    if not 0.01 <= rms <= 1.0:
        raise RuntimeError("parity lane: implausible output level")
    return counts, rec, y


def parity_card_vs_cpu(devices=("cuda", "cpu")):
    """Phase 15 (a'): vocoder.synthesize(parity=True) of one 16 kHz
    utterance with long unvoiced runs on the card and on the CPU: the
    same pulses, the waveforms within 1e-10."""
    import torch
    from hts_train_world_tpu_torch import config as cfg
    from hts_train_world_tpu_torch import vocoder
    from hts_train_world_tpu_torch.ops import synthesis as syn
    fs, T = PARITY_CV_FS, PARITY_CV_T
    N = cfg.cheaptrick_fft_size(fs)
    yl = cfg.y_length_for(T, FRAME_PERIOD, fs)
    f0, sp, ap = parity_params(T, fs)
    ys, pulses = [], []
    for d in devices:
        ys.append(vocoder.synthesize(f0, sp, ap, fs, N, FRAME_PERIOD,
                                     device=d).cpu())
        pl = syn.time_base(torch.as_tensor(f0, device=d)[None], FRAME_PERIOD,
                           fs, yl, N, syn.default_max_pulses(yl, fs))
        pulses.append(pl.pidx[0, :int(pl.n[0])].cpu())
    same = torch.equal(*pulses)
    err = float((ys[0] - ys[1]).abs().max())
    print(f"parity synthesis, {devices[0]} vs {devices[1]} ({T} frames at "
          f"{fs} Hz, unvoiced runs): pulses equal {same} ({len(pulses[0])} "
          f"pulses), max |dy| {err:.3e} (<= 1e-10), peak "
          f"{float(ys[1].abs().max()):.3f}", flush=True)
    if not (same and err <= 1e-10):
        raise RuntimeError("parity synthesis: the card disagrees with the "
                           "CPU path")


def parity_cli(counted, feats, devices=("cuda", "cpu")):
    """Phase 15 (b): `synth` at its default (no --f32) on one utterance's
    compressed features (mgc 50, bap 25) written as float32 files, on the
    card (counted) and with --device cpu: the int16 samples of the two
    wavs.  Returns the card run's counts."""
    from hts_train_world_tpu_torch import cli
    from hts_train_world_tpu_torch import config as cfg
    from hts_train_world_tpu_torch.io import rawio, wavio
    d = tempfile.mkdtemp()
    try:
        paths = [os.path.join(d, f"in.{k}") for k in ("lf0", "mgc", "bap")]
        for path, v in zip(paths, feats):
            rawio.write_f32(path, v[0].cpu().numpy())
        N = cfg.cheaptrick_fft_size(FS)
        outs, counts = [], None
        for dev in devices:
            out = os.path.join(d, f"{dev}.wav")
            argv = ["synth", *paths, out, str(FRAME_PERIOD), str(N), str(FS),
                    "50", "25", "--device", dev]
            t0 = time.perf_counter()
            if counts is None:
                _, counts, _ = counted("parity_cli", lambda: cli.main(argv))
            else:
                cli.main(argv)
            secs = time.perf_counter() - t0
            outs.append((wavio.float_to_int16(wavio.wavread(out)[0]), secs))
        (a, ta), (b, tb) = outs
        diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
        print(f"synth CLI at its default (parity), {devices[0]} vs "
              f"{devices[1]}: {len(a)} samples, {int((diff > 0).sum())} "
              f"differ, max {int(diff.max())} LSB; {ta:.2f} s vs {tb:.2f} s "
              f"(a process's first call)", flush=True)
        if len(a) != len(b) or diff.max() > 1 or np.abs(a).max() < 1000:
            raise RuntimeError("synth CLI: the card's wav disagrees with the "
                               "CPU's or is silent")
        return counts
    finally:
        shutil.rmtree(d)


def streaming_lane(counted, profiled, params, device="cuda",
                   sizes=STREAM_SIZES):
    """Phase 15 (c): the StreamingSynthesizer on one 2.0 s utterance at
    48 kHz (float64 f0 / sp / ap on the device), all frames added, read
    chunk by chunk at each buffer size after three warm reads: ms per
    read() to a synchronize (median, p99), the real-time factor (chunk
    seconds over wall seconds) and the concatenated stream against the
    batch parity synthesis within 1e-10; 20 reads at the smallest size
    under the profiler; one more pass at the largest size counted and
    recorded.  Returns (counts, recorded launches)."""
    import torch
    from hts_train_world_tpu_torch import config as cfg
    from hts_train_world_tpu_torch.ops import rand
    from hts_train_world_tpu_torch.ops import synthesis as syn
    from hts_train_world_tpu_torch.ops.synthesis_rt import (
        StreamingSynthesizer)
    f0, sp, ap = params
    T = f0.shape[0]
    N = cfg.cheaptrick_fft_size(FS)
    yl = cfg.y_length_for(T, FRAME_PERIOD, FS)
    stream = rand.randn_stream(syn.synthesis_stream_len(yl), device)
    ref = syn.synthesis(f0[None], sp[None], ap[None], N, FRAME_PERIOD, FS,
                        yl, stream[None], exact=True)[0]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fresh(s):
        s.refresh()
        s.add_parameters(f0, sp, ap)
        return s

    def drain(s):
        out = []
        while not s.starved:
            out.append(s.read())
        return out

    counts, rec = None, []
    for bs in sizes:
        s = StreamingSynthesizer(FS, FRAME_PERIOD, N, buffer_size=bs,
                                 noise_stream=stream, device=device)
        fresh(s)
        for _ in range(3):                           # warm-up (FFT plans)
            s.read()
        fresh(s)
        times, out = [], []
        sync()
        while not s.starved:
            t0 = time.perf_counter()
            out.append(s.read())
            sync()
            times.append(time.perf_counter() - t0)
        y = torch.cat(out)
        err = float((y - ref[:len(y)]).abs().max())
        ms = 1e3 * np.asarray(times)
        rtf = len(times) * bs / FS / float(np.sum(times))
        print(f"streaming, buffer {bs}: {len(times)} reads, {len(y)} "
              f"samples emitted (latency {N}); ms per read median "
              f"{np.median(ms):.3f}, p99 {np.percentile(ms, 99):.3f}; "
              f"real-time factor {rtf:.2f}; vs batch parity max |dy| "
              f"{err:.3e} (<= 1e-10)", flush=True)
        if err > 1e-10 or len(y) < yl - N - bs:
            raise RuntimeError(f"streaming (buffer {bs}) disagrees with "
                               f"the batch parity synthesis")
        if bs == sizes[0]:
            fresh(s)
            wall, busy, evs = profiled(lambda: [s.read()
                                                for _ in range(20)])
            top = ", ".join(
                f"{e.key[:40]} " + "{:.1f} us".format(getattr(
                    e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)) / 20)
                for e in evs[:3])
            print(f"streaming, buffer {bs}, 20 reads under the profiler: "
                  f"{1e3 * wall / 20:.3f} ms a read, device busy "
                  f"{1e3 * busy / 20:.3f} ms, idle "
                  f"{100 * (1 - busy / wall):.1f}%; top a read: {top}",
                  flush=True)
        if bs == sizes[-1]:
            fresh(s)
            _, counts, _ = counted("streaming", lambda: drain(s), record=rec)
    return counts, rec


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
    from hts_train_world_tpu_torch.features import qconf
    from hts_train_world_tpu_torch.models import clustering, hsmm, hsmm_batch
    from hts_train_world_tpu_torch.models import context_clustered, recipe
    from hts_train_world_tpu_torch.models import voice
    from hts_train_world_tpu_torch.ops import cheaptrick as ct_mod
    from hts_train_world_tpu_torch.ops import codec
    from hts_train_world_tpu_torch.ops import d4c as d4c_mod
    from hts_train_world_tpu_torch.ops import stonemask as sm_mod
    from hts_train_world_tpu_torch.ops import dio as dio_mod
    from hts_train_world_tpu_torch.ops import fftmat, frames
    from hts_train_world_tpu_torch.ops import harvest as hv
    from hts_train_world_tpu_torch.ops import harvest_fix as hf
    from hts_train_world_tpu_torch.ops import mlpg as mlpg_mod
    from hts_train_world_tpu_torch.ops import prims
    from hts_train_world_tpu_torch.ops import synthesis as syn
    from hts_train_world_tpu_torch.parallel import batch as batch_mod
    from hts_train_world_tpu_torch.parallel import bucketing
    from hts_train_world_tpu_torch.parallel import features as feat_mod
    from hts_train_world_tpu_torch.features import compose
    from hts_train_world_tpu_torch.models import engine, pgen
    from hts_train_world_tpu_torch.ops import gv as gv_mod
    from hts_train_world_tpu_torch.ops import postfilter as pf_mod
    from hts_train_world_tpu_torch.ops import trajectory as traj_mod
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
        just after; fail if a kernel of the path was not launched.
        `record`: True keeps every launch's inputs, a list object keeps
        what its `append` keeps."""
        sync()
        kernels.reset_counts()
        kernels.record = (record if isinstance(record, list)
                          else [] if record else None)
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

    def harvest_lane():
        return batch_mod.batch_analyze(xs, FS, algorithm="harvest")

    harvest_lane()                                   # warm-up
    (_, f0, sp, ap), counts_hl, rec_hl = counted("harvest_lane", harvest_lane,
                                                 record=True)
    rec_hl = [(n, i) for n, i in rec_hl if n.startswith("harvest_")]
    if f0.shape != (BATCH, T) or sp.shape != (BATCH, T, half + 1) \
            or ap.shape != sp.shape:
        raise RuntimeError("Harvest lane: unexpected output shapes")
    if not all(bool(torch.isfinite(v).all()) for v in (f0, sp, ap)) \
            or not (sp > 0).all() or ap.min() < 0 or ap.max() > 1:
        raise RuntimeError("Harvest lane: non-finite or out-of-range output")
    voiced = (f0 > 0).float().mean().item()
    med_f0 = f0[f0 > 0].median().item()
    print(f"Harvest lane outputs: voiced rate {voiced:.3f}, median f0 "
          f"{med_f0:.1f} Hz", flush=True)
    if not (0.8 <= voiced <= 1.0 and 150.0 <= med_f0 <= 250.0):
        raise RuntimeError("Harvest lane: implausible V/UV rate or f0")
    del f0, sp, ap

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
        "harvest_decimate": (prims.decimate, prims.decimate_plain),
        "harvest_candidates": (hv.raw_candidates, hv.raw_candidates_plain),
        "harvest_refine": (hv.refine, hv.refine_plain),
        "harvest_contour": (hf.contour, hf.contour_plain),
        "hsmm_loglik": (hsmm.batch_frame_loglik,
                        hsmm.batch_frame_loglik_plain),
        "hsmm_fb": (hsmm.segment_fb, hsmm.segment_fb_plain),
        "hsmm_accumulate": (hsmm_batch.segment_sum,
                            hsmm_batch.segment_sum_plain),
        "hsmm_viterbi": (hsmm.viterbi_segment_batch,
                         hsmm.viterbi_segment_batch_plain),
        "mspf": (pf_mod.mspf, pf_mod.mspf_plain),
        "mcep_postfilter": (pf_mod.mcep_postfilter,
                            pf_mod.mcep_postfilter_plain),
        "gv_scale": (gv_mod.gv_scale, gv_mod.gv_scale_plain),
        "stonemask_if": (sm_mod.if_readout, sm_mod.if_readout_plain),
        "cheaptrick_lifter": (ct_mod.lifter, ct_mod.lifter_plain),
        "d4c_group_delay": (d4c_mod.group_delay, d4c_mod.group_delay_plain),
        "d4c_aperiodicity": (d4c_mod.aperiodicity,
                             d4c_mod.aperiodicity_plain),
        "trajectory_nll": (traj_mod.trajectory_forward,
                           traj_mod.trajectory_forward_plain),
        "trajectory_adjoint": (traj_mod.trajectory_backward,
                               traj_mod.trajectory_backward_plain),
        "synth_midpass": (syn.midpass, syn.midpass_plain),
    }

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))

    def rate(t):
        """The card's peak operation rate for t's type."""
        return F64_OPS_PER_S if t.dtype == torch.float64 else F32_OPS_PER_S

    def bound_of(name, inp, outs):
        """(bound ms, 'bytes' | 'operations') for one launch: each input
        the function needs read once, each output written once."""
        name = kernels.base_name(name)
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
            t_o = 2.0 * 3 * outs[0].numel() / (
                F64_OPS_PER_S if outs[0].dtype == torch.float64
                else F32_OPS_PER_S)
        elif name == "mlpg_solve":
            t_o = 60.0 * outs[0].numel() / (
                F64_OPS_PER_S if outs[0].dtype == torch.float64
                else F32_OPS_PER_S)
        elif name == "mspf":
            # per (frame, bin) 25 complex multiply-adds and ~40 operations
            # for log, atan2, exp, cos, sin; per (frame, sample) of the
            # inverse 31 of them; the statistics read once
            T_, D_ = inp["traj"].shape
            F_ = pf_mod.n_frames(T_)
            moved += sum(nbytes(t) for t in (inp["stats"] or ()))
            n_ops = D_ * F_ * pf_mod.MSPF_BINS * (4.0 * 25 + 40.0)
            if inp["stats"] is not None:
                n_ops += D_ * F_ * pf_mod.MSPF_FFTLEN * 4.0 * 31 + 6.0 * D_ * T_
            t_o = n_ops / F64_OPS_PER_S
        elif name == "mcep_postfilter":
            # per frame and bin two M-term dot products and two exps
            T_, M_ = inp["mgc"].shape
            H_ = inp["fft_size"] // 2 + 1
            t_o = T_ * H_ * (4.0 * M_ + 40.0) / F64_OPS_PER_S
        elif name == "gv_scale":
            t_o = 8.0 * inp["statics"].numel() / F64_OPS_PER_S
        elif name == "stonemask_if":
            # the 2 + 6 harmonic bins of four spectra a frame, its f0, h,
            # gate and result; ~30 operations a bin
            R_ = inp["f0s"].numel()
            moved = R_ * (8 * 4 * 4 + 4 + 4 + 1 + 4)
            t_o = 8 * 30.0 * R_ / F32_OPS_PER_S
        elif name == "cheaptrick_lifter":
            # a sin, a cos (~20 each) and ~10 more a bin in the lifter;
            # log or exp (~10) and a compare in the others
            t_o = (50.0 if inp["stage"] == ct_mod.LIFTER else 12.0) \
                * inp["x"].numel() / F32_OPS_PER_S
        elif name == "d4c_group_delay":
            st = inp["stage"]
            if st == d4c_mod.LOVE:      # the bins (b0, b2] of each row
                R_ = inp["p"].shape[0]
                moved = 4 * R_ * (inp["b2"] - inp["b0"]) + 4 * R_ * 4
                t_o = 2.0 * R_ * (inp["b2"] - inp["b0"]) / F64_OPS_PER_S
            elif st == d4c_mod.SEGMENTS:   # the band spans of a and b
                seg = outs[0].numel()
                moved = 3 * 4 * seg + nbytes(inp["window"])
                t_o = 2.0 * seg / F32_OPS_PER_S
            else:
                t_o = 4.0 * outs[0].numel() / F32_OPS_PER_S
        elif name == "d4c_aperiodicity":
            # per bin the segment search, the lerp and powf (~30)
            t_o = 30.0 * outs[0].numel() / F32_OPS_PER_S
        elif name == "synth_time_base":
            # ~40 operations a sample (search, lerp, increment, wrap,
            # jump) and one float64 add; the serial sum is not counted
            samples = inp["f0"].shape[0] * inp["y_length"]
            t_o = max(40.0 * samples / rate(inp["f0"]),
                      samples / F64_OPS_PER_S)
        elif name == "synth_pulse_spectra":
            # per bin the lerps and two logs (~60), per noise sample 3
            pulses = inp["pulse_time"].numel()
            t_o = pulses * (60.0 * inp["sp"].shape[-1]
                            + 3.0 * inp["fft_size"]) / rate(inp["sp"])
        elif name == "synth_ola":
            t_o = 8.0 * inp["per_raw"].numel() / rate(inp["per_raw"])
        elif name in ("trajectory_nll", "trajectory_adjoint"):
            # per (utterance, frame, dimension): the row build (~10 a
            # window) and the recursions (~15) forward; the two sweeps,
            # Takahashi, G's band and the window sums (~40 + 20 a window)
            # in the adjoint; the saved planes and outputs written once
            W_ = inp["mu"].shape[2]
            per = (10.0 * W_ + 15.0) if name == "trajectory_nll" \
                else (40.0 + 20.0 * W_)
            t_o = per * inp["s"].numel() / (
                F64_OPS_PER_S if inp["mu"].dtype == torch.float64
                else F32_OPS_PER_S)
        elif name == "synth_midpass":
            # 2 exp, 5 cos/sin, 1 sqrt (~15 each) and 12 products a bin
            t_o = 132.0 * inp["lpr"].numel() / rate(inp["lpr"])
        elif name == "codec_decode":
            rows = inp["lf0"].numel()
            H = inp["fft_size"] // 2 + 1
            db = inp["bap"].shape[-1]
            t_o = rows * (2.0 * inp["mgc"].shape[-1] * (H - 1) + 30.0 * H
                          + 2.0 * db * decode.ap_order(db)) / rate(inp["mgc"])
        elif name == "harvest_decimate":
            # the order-3 recurrence and its output taps, twice, in f64
            x = inp["x"]
            t_o = 2 * 13.0 * x.shape[0] * (x.shape[1] + 18) / F64_OPS_PER_S
        elif name == "harvest_candidates":
            # the channel rows it reads, the four streams' crossing tests
            fb = inp["filt"]
            samples = fb.shape[0] * fb.shape[1] * inp["plan"]["y_length"]
            moved = 4 * samples + nbytes(*outs)
            t_o = 12.0 * samples / F32_OPS_PER_S
        elif name == "harvest_refine":
            # per non-zero pair, 2h+1 samples x 6 bins x 2 windows x 2 (re,
            # im) multiply-adds: what this run's candidates need
            c = inp["cands"]
            ub, tt, cc = torch.nonzero(c > 0, as_tuple=True)
            _, B_dft = hv.refine_sizes(inp["fs8"], inp["f0_floor"])
            h = hv.pair_integers(c[ub, tt, cc], tt, inp["fs8"], B_dft)[0]
            t_o = 48.0 * float((2 * h + 1).sum()) / F32_OPS_PER_S
        elif name == "hsmm_loglik":
            # every stream (bap's weight 0 too): per (b, t, k, column) a
            # subtract, a square and a multiply-add; per stream ~8 more
            fr = inp["frames"]
            B_, Tb, _ = fr.shape
            Kb = inp["rows"][0].shape[1]
            n_s = len(inp["stream_slices"])
            cols = sum(b - a for a, b in inp["stream_slices"])
            moved = nbytes(fr, *outs) + sum(
                nbytes(inp["rows"][i], inp["means"][i], inp["variances"][i])
                + (nbytes(inp["msd_w"][i]) if inp["msd_flags"][i] else 0)
                for i in range(n_s))
            t_o = B_ * Tb * Kb * (3.0 * cols + 8.0 * n_s) / F64_OPS_PER_S
        elif name == "hsmm_fb":
            # ~20 float64 operations (three exp counted as one each) per
            # valid (state, t0, d) term of this run's t_len / k_len
            Dm = inp["max_dur"]
            terms = sum(k * (Dm * (t - Dm) + Dm * (Dm + 1) // 2 if t >= Dm
                             else t * (t + 1) // 2)
                        for t, k in zip(inp["t_len"].tolist(),
                                        inp["k_len"].tolist()))
            t_o = 20.0 * terms / F64_OPS_PER_S
        elif name == "hsmm_accumulate":
            t_o = float(inp["vals"].numel()) / F64_OPS_PER_S
        elif name == "hsmm_viterbi":
            # ~4 float64 operations per (state, t, d) term of this run's
            # t_len / k_len
            terms = sum(k * (t + 1) * inp["max_dur"] for t, k in zip(
                inp["t_len"].tolist(), inp["k_len"].tolist()))
            t_o = 4.0 * terms / F64_OPS_PER_S
        t_b = moved / HBM_BYTES_PER_S
        return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    def library(key, inp):
        """One PyTorch call for the same job, where there is one.  K2's is
        `torch.cumsum` of the mirrored rows alone (no DC fold, no reads,
        no division): the whole cumsum-based smoothing in library calls
        is the plain version.  K6's is log + gather-lerp + matmul of the
        scaled spectra (no zero floor, no c0 fixes); K7's the shifted adds
        (no -1e10 propagation)."""
        name = kernels.base_name(key)
        if name == "topk_sum":
            return lambda: torch.topk(inp["p"], inp["k"], dim=1).values.sum(1)
        if name == "d4c_group_delay" and inp["stage"] == d4c_mod.LOVE:
            # LoveTrain's band sums as the twin takes them: one cumsum
            return lambda: torch.cumsum(inp["p"], dim=1)
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
            return lambda: torch.zeros(B * Lb, dtype=resp.dtype,
                                       device=dev).index_add_(0, at, resp)
        if name == "codec_decode":
            m, b, fs_, N_ = inp["mgc"], inp["bap"], inp["fs"], inp["fft_size"]
            m0 = torch.cat([m[..., :1] - 12.0, m[..., 1:]], dim=-1)
            W = torch.as_tensor(decode._ap_matrix_np(b.shape[-1], N_),
                                dtype=m.dtype, device=dev)
            b0 = torch.cat([b[..., :1] + encode.LN_1E4, b[..., 1:]],
                           dim=-1)[..., :W.shape[0]]
            return lambda: (
                torch.exp(inp["lf0"]),
                codec.decode_spectral_envelope(m0, fs_, N_, m.shape[-1]),
                torch.exp(fftmat.matmul(b0, W)))
        if name == "harvest_refine":
            # torch.fft.rfft at the B-point size of every non-zero pair's
            # two windowed segments, and the six-bin gather
            c = inp["cands"]
            ub, tt, cc = torch.nonzero(c > 0, as_tuple=True)
            xm, xd, ints = hv.windowed_pairs(inp["y"], ub, tt, c[ub, tt, cc],
                                             inp["fs8"], inp["f0_floor"])
            _, B_dft = hv.refine_sizes(inp["fs8"], inp["f0_floor"])
            rows = torch.stack([xm, xd])
            bins = (ints[5] * (B_dft // ints[2])[:, None])[None].expand(
                2, -1, -1)
            return lambda: torch.gather(torch.fft.rfft(rows, n=B_dft, dim=-1),
                                        2, bins)
        if name == "hsmm_loglik":
            # one bmm of the expanded quadratic form [x^2, x, 1] . [1/v;
            # -2 mu/v; sum mu^2/v + sum log v] over every stream (no MSD
            # switch, no -0.5, no weights)
            live = range(len(inp["stream_slices"]))
            fr = inp["frames"]
            xs = torch.cat([fr[..., a:e] for i, (a, e)
                            in enumerate(inp["stream_slices"]) if i in live],
                           -1)
            A = torch.cat([xs * xs, xs, torch.ones_like(xs[..., :1])], -1)
            mu = [inp["means"][i][inp["rows"][i]] for i in live]
            iv = [1.0 / inp["variances"][i][inp["rows"][i]] for i in live]
            c = sum((m * m * v).sum(-1) - torch.log(v).sum(-1)
                    for m, v in zip(mu, iv))
            W = torch.cat(iv + [-2.0 * m * v for m, v in zip(mu, iv)]
                          + [c[..., None]], -1).transpose(1, 2).contiguous()
            return lambda: torch.bmm(A, W)
        if name == "hsmm_viterbi":
            # the twin's per-state max/argmax over the (T+1, max_dur)
            # candidates, as one torch.max over every state's slab of every
            # utterance of the batch (the slabs made here, not timed)
            n = int((inp["k_len"] * (inp["t_len"] + 1)).sum())
            cand = torch.randn((n, inp["max_dur"]), dtype=torch.float64,
                               device=dev)
            return lambda: torch.max(cand, dim=1)
        if name == "hsmm_accumulate":
            v, ids = inp["vals"], inp["ids"]
            return lambda: torch.zeros((inp["n_rows"], v.shape[1]),
                                       dtype=v.dtype, device=dev) \
                .index_add_(0, ids, v)
        if name == "mspf":
            # rfft at 64 of the prebuilt windowed frames, the log
            # magnitude, the map and the irfft (no framing, no OLA)
            x = inp["traj"]
            bart = pf_mod._bartlett(pf_mod.MSPF_LENGTH, x.dtype, dev)
            fr = pf_mod._frames((x - x.mean(0)).T, pf_mod.MSPF_LENGTH,
                                pf_mod.MSPF_SHIFT) * bart
            if inp["stats"] is None:
                return lambda: 0.5 * torch.log(torch.fft.rfft(
                    fr, n=64).abs() ** 2 + 1e-30)
            nm, ns, gm, gs = (t[:, None] for t in inp["stats"])
            w = inp["weight"]

            def mapped():
                X = torch.fft.rfft(fr, n=64)
                ms = 0.5 * torch.log(X.abs() ** 2 + 1e-30)
                ms2 = ms + w * (((ms - gm) / gs) * ns + nm - ms)
                return torch.fft.irfft(torch.polar(torch.exp(ms2),
                                                   X.angle()), n=64)
            return mapped
        if name == "mcep_postfilter":
            x = inp["mgc"]
            M_ = x.shape[1]
            G = pf_mod._folded_tensor(M_, inp["alpha"], inp["fft_size"], dev)
            wt = torch.ones(M_, dtype=x.dtype, device=dev)
            wt[2:] = inp["pf"]
            xw = torch.cat([x, x * wt])
            a = torch.full((G.shape[1],), 2.0, dtype=x.dtype, device=dev)
            a[0] = a[-1] = 1.0
            return lambda: (torch.exp(2.0 * (xw @ G)) * a).sum(-1)
        if name == "gv_scale":
            x = inp["statics"]
            x = x if inp["mask"] is None else x[inp["mask"]]
            return lambda: torch.var_mean(x, dim=0, correction=0)
        if name in ("trajectory_nll", "trajectory_adjoint"):
            # the dense route: each (utterance, dimension)'s (T, T) normal
            # matrix (built here, not timed), its Cholesky factor, the
            # solve and the log-det (for the adjoint the inverse too)
            mu, prec = inp["mu"].double(), inp["prec"].double()
            diags, rhs = mlpg_mod.build_banded_normal(
                mu, prec, mlpg_mod.DEFAULT_WINDOWS)
            Tn = diags.shape[2]
            A = torch.diag_embed(diags[:, 0].permute(0, 2, 1))
            for off in (1, 2):
                band = torch.diag_embed(
                    diags[:, off, :Tn - off].permute(0, 2, 1), offset=off)
                A = A + band + band.transpose(-1, -2)
            A = A.to(inp["mu"].dtype)
            b = rhs.permute(0, 2, 1)[..., None].to(inp["mu"].dtype)

            def dense():
                L, _ = torch.linalg.cholesky_ex(A)
                c = torch.cholesky_solve(b, L)
                ld = 2.0 * torch.log(torch.diagonal(L, dim1=-2,
                                                    dim2=-1)).sum(-1)
                if name == "trajectory_adjoint":
                    return c, ld, torch.cholesky_inverse(L)
                return c, ld
            return dense
        if name == "synth_midpass":
            # the same products in complex library calls (sin for the
            # delay's imaginary part, not synthesis.cpp's sqrt)
            k = torch.arange(inp["lpr"].shape[-1], device=dev,
                             dtype=inp["lpr"].dtype)
            return lambda: (
                torch.exp(torch.complex(inp["lpr"], inp["lpi"]))
                * torch.exp(torch.complex(torch.zeros_like(inp["lpr"]),
                                          -inp["coef"][..., None] * k)),
                torch.exp(torch.complex(inp["lar"], inp["lai"]))
                * torch.complex(inp["nre"], inp["nim"]))
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
        if k.dtype == torch.float64:
            # generation's float64 solve (precisions spread over ~1e16):
            # within 1e-9 of each column's largest |value|
            colmax = p.abs().amax(dim=-2, keepdim=True).clamp(min=1e-300)
            worst = float(((k - p).abs() / colmax).max())
            prec = 1.0 / inp["variances"]
            spread = float(prec.max() / prec.min())
            return (worst <= 1e-9, float((k - p).abs().max()),
                    f"float64: worst |err| / column max {worst:.2e} <= 1e-9 "
                    f"(bit-equal {torch.equal(k, p)}); precisions spread "
                    f"{spread:.1e}")
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

    def check_k14(inp, out_k, out_p):
        same = bool(torch.equal(out_k[1], out_p[1])
                    and torch.equal(out_k[2], out_p[2]))
        ref = hv.crossing_candidates_f64(inp["filt"], inp["plan"], inp["T"],
                                         out_p[1], out_p[2])
        ck, cp = out_k[0], out_p[0]
        both = (ck > 0) & (cp > 0)
        rel_k = float(((ck.double() - ref).abs() / ref)[both].max())
        rel_p = float(((cp.double() - ref).abs() / ref)[both].max())
        agree = float(((ck > 0) == (cp > 0)).double().mean())
        ok = same and rel_k <= rel_p + 1e-6 and agree >= 0.999
        return (ok, float((ck - cp).abs()[both].max()),
                f"positions and n equal: {same}; vs f64 interp1 of the same "
                f"crossings: kernel rel {rel_k:.2e}, twin rel {rel_p:.2e} "
                f"(kernel <= twin + 1e-6); zero/nonzero agreement "
                f"{agree:.5f} >= 0.999")

    def check_k15(inp, out_k, out_p):
        """Refined f0 against the twin; a score is 1 / (mean relative
        harmonic error), ill-conditioned at weak harmonics, so the scores
        are held through that error against the float64 twin."""
        (gr, gs), (wr, ws) = out_k, out_p
        both = (gr > 0) & (wr > 0)
        flips = int(((gr > 0) != (wr > 0)).sum())
        n = int((wr > 0).sum())
        rel = float(((gr - wr).abs() / wr)[both].max())
        ref = hv.refine_plain(inp["y"].double(), inp["cands"].double(),
                              inp["fs8"], inp["f0_floor"],
                              inp["f0_ceil"])[1]
        live = both & (ref > 0)
        e_k = (1.0 / gs[live].double() - 1.0 / ref[live]).abs()
        e_p = (1.0 / ws[live].double() - 1.0 / ref[live]).abs()
        qk = [float(e_k.quantile(q)) for q in (0.5, 0.99)]
        qp = [float(e_p.quantile(q)) for q in (0.5, 0.99)]
        ok = (flips <= 0.002 * n and rel <= 1e-5
              and all(a <= 1.5 * b + 1e-9 for a, b in zip(qk, qp)))
        return (ok, float((gr - wr).abs()[both].max()),
                f"refined f0 rel {rel:.2e} <= 1e-5 where both nonzero; "
                f"flips {flips} of {n} nonzero pairs <= 0.2 %; mean harmonic "
                f"error vs the f64 twin, median / 99th pct: kernel "
                f"{qk[0]:.2e} / {qk[1]:.2e}, f32 twin {qp[0]:.2e} / "
                f"{qp[1]:.2e} (kernel <= 1.5x twin)")

    def amax0(t):
        return float(t.abs().max()) if t.numel() else 0.0

    def check_k18(inp, out_k, out_p):
        """The twin's bounds, and padded against unpadded (the bounds of
        tests/test_hsmm_batch.py:43-62) on the batch's shortest
        utterance."""
        (lk, gk, dk), (lp, gp, dp) = out_k, out_p
        r_ll = float(((lk - lp).abs() / lp.abs()).max())
        e_g = float((gk - gp).abs().max())
        r_d = float(((dk - dp).abs() / dp.abs().clamp(min=1e-300)).max())
        tl, kl = inp["t_len"], inp["k_len"]
        b = int(torch.argmin(tl))
        T_, S_ = int(tl[b]), int(kl[b])
        l1, g1, d1 = hsmm.segment_fb(
            inp["obs_ll"][b:b + 1, :T_, :S_].contiguous(),
            inp["dur_mean"][b:b + 1, :S_].contiguous(),
            inp["dur_var"][b:b + 1, :S_].contiguous(), inp["max_dur"],
            inp["temper"], tl[b:b + 1], kl[b:b + 1])
        pad = [abs(float(l1[0]) - float(lk[b])),
               amax0(g1[0] - gk[b, :T_, :S_]), amax0(d1[0] - dk[b, :S_]),
               amax0(gk[b, T_:]), amax0(dk[b, S_:])]
        ok_pad = (pad[0] < 1e-10 and pad[1] < 1e-12 and pad[2] < 1e-10
                  and pad[3] < 1e-12 and pad[4] < 1e-12)
        ok = r_ll <= 1e-9 and e_g <= 1e-10 and r_d <= 1e-9 and ok_pad
        return (ok, max(float((lk - lp).abs().max()), e_g,
                        float((dk - dp).abs().max())),
                f"ll rel {r_ll:.2e} <= 1e-9, gamma |err| {e_g:.2e} <= 1e-10, "
                f"dstats rel {r_d:.2e} <= 1e-9; padded vs unpadded "
                f"(utterance {b}: T {T_}, K {S_} in {tuple(gk.shape[1:])}): "
                f"ll {pad[0]:.1e} < 1e-10, gamma {pad[1]:.1e} < 1e-12, "
                f"dstats {pad[2]:.1e} < 1e-10, padding {pad[3]:.1e} / "
                f"{pad[4]:.1e} < 1e-12")

    def check_k20(inp, out_k, out_p):
        """Against the twin on the CPU (its prefix sums in the kernel's
        sequential order; the card twin's torch.cumsum adds in another,
        which the ~1e11 prefix sums behind a variance-floored leaf feel):
        ends equal, best_ll within 1e-9 relative; padded against unpadded
        bit for bit on the batch's shortest utterance."""
        (lk, ek), (lp, ep) = out_k, out_p
        lc, ec = hsmm.viterbi_segment_batch_plain(**on_cpu(inp))
        same = torch.equal(ek.cpu(), ec)
        r_ll = float(((lk.cpu() - lc).abs() / lc.abs()).max())
        tl, kl = inp["t_len"], inp["k_len"]
        b = int(torch.argmin(tl))
        T_, S_ = int(tl[b]), int(kl[b])
        l1, e1 = hsmm.viterbi_segment(
            inp["obs_ll"][b, :T_, :S_].contiguous(),
            inp["dur_mean"][b, :S_].contiguous(),
            inp["dur_var"][b, :S_].contiguous(), inp["max_dur"])
        pad = bool(float(l1) == float(lk[b])
                   and torch.equal(e1, ek[b, :S_])
                   and not bool(ek[b, S_:].any()))
        card = (torch.equal(ek, ep),
                float(((lk - lp).abs() / lp.abs()).max()))
        return (same and r_ll <= 1e-9 and pad, float((lk.cpu() - lc).abs()
                                                     .max()),
                f"vs the CPU twin: ends equal {same}, best_ll rel "
                f"{r_ll:.2e} <= 1e-9; padded vs unpadded (utterance {b}: T "
                f"{T_}, K {S_} in {tuple(inp['obs_ll'].shape[1:])}) bit-"
                f"equal: {pad}; vs the card twin: ends equal {card[0]}, "
                f"best_ll rel {card[1]:.2e}")

    def check_f64(name, inp, out_k, out_p):
        """The float64 instantiations (the exact path) against their
        twins: K9 and K11 bit for bit against the twin on the CPU, K10's
        logs within 4 float64 ulps, the rest within 1e-12 relative."""
        base = kernels.base_name(name)
        eps = torch.finfo(torch.float64).eps
        if base == "synth_time_base":
            return check_k9(inp, out_k)
        if base == "synth_ola":
            return check_k11(inp, out_k)
        if base == "synth_pulse_spectra":
            worst = max(float(((k - p).abs() / (4 * eps * (p.abs() + 1.0)))
                              .max()) for k, p in zip(out_k[:2], out_p[:2]))
            e_n = float((out_k[2] - out_p[2]).abs().max())
            lim = 1e-12 * float(inp["stream"].abs().max())
            same_unv = torch.equal(out_k[3], out_p[3])
            return (worst <= 1.0 and e_n <= lim and same_unv,
                    max_err(zip(out_k[:3], out_p)),
                    f"float64, fma lerps: logs within 4 ulps (+4 ulps of "
                    f"1), worst err/limit {worst:.3f}; noise |err| "
                    f"{e_n:.1e} <= 1e-12 x stream peak; unvoiced flags "
                    f"equal: {same_unv}")
        if base == "synth_midpass":
            ms = inp["lpr"].exp()
            mp = inp["lar"].exp() * (inp["nre"].abs() + inp["nim"].abs())
            worst = max(float(((k - p).abs() / (1e-12 * m).clamp(
                min=1e-300)).max()) for k, p, m in zip(out_k, out_p,
                                                        (ms, ms, mp, mp)))
            return (worst <= 1.0, max_err(zip(out_k, out_p)),
                    f"float64: per element err / (1e-12 x magnitude) "
                    f"worst {worst:.3f}")
        # codec_decode
        f0_c = decode.decode_features_plain(**on_cpu(inp))[0]
        apl = decode.ap_order(inp["bap"].shape[-1])
        r_f0 = float(((out_k[0].cpu() - f0_c).abs()
                      / f0_c.abs().clamp(min=1e-300)).max())
        r_sp = float(((out_k[1] - out_p[1]).abs() / out_p[1].abs()).max())
        r_ap = float(((out_k[2][..., :apl] - out_p[2][..., :apl]).abs()
                      / out_p[2][..., :apl].abs()).max())
        tail = bool((out_k[2][..., apl:] == 0).all())
        return (r_f0 <= eps and tail and max(r_sp, r_ap) <= 1e-12,
                max_err(zip(out_k, out_p)),
                f"float64: f0 within an ulp of the CPU's (rel {r_f0:.1e}); "
                f"sp rel {r_sp:.1e}, ap rel {r_ap:.1e} (<= 1e-12); ap zero "
                f"past bin {apl}: {tail}")

    def check(name, inp, out_k, out_p):
        """(passed, max abs err against the reference, what was held and
        what was read)."""
        if name.endswith("[f64]"):
            return check_f64(name, inp, out_k, out_p)
        if name == "hsmm_loglik":
            # non-finite frames (a NaN in bap, weight 0) are NaN in both
            k, p = out_k[0], out_p[0]
            fin = torch.isfinite(p)
            same_nan = torch.equal(torch.isnan(k), torch.isnan(p))
            bad = ~torch.isfinite(inp["frames"]).all(-1)       # (B, T)
            nan_rows = bool(torch.isnan(k[bad]).all()) if bad.any() else True
            err = (k - p).abs()[fin]
            worst = float((err / (1.0 + p.abs()[fin])).max())
            return (worst <= 1e-12 and same_nan and nan_rows,
                    float(err.max()),
                    f"|err| <= 1e-12 (1 + |ll|): worst {worst:.2e}; NaN "
                    f"where the twin's: {same_nan}; {int(bad.sum())} "
                    f"frames with a non-finite column all NaN: {nan_rows}")
        if name == "mspf":
            k, p = out_k[0], out_p[0]
            if inp["stats"] is None:
                # magnitudes exp(ms) per trajectory: a bin whose power is
                # near 0 has an ill-conditioned log
                mk, mq = k.exp(), p.exp()
                worst = float(((mk - mq).abs().amax((1, 2))
                               / mq.amax((1, 2))).max())
                return (worst <= 1e-9, float((k - p).abs().max()),
                        f"analysis: worst |exp(ms) err| / trajectory max "
                        f"{worst:.2e} <= 1e-9")
            same_nan = torch.equal(torch.isnan(k), torch.isnan(p))
            fin = torch.isfinite(p)
            err = torch.where(fin, (k - p).abs(), torch.zeros_like(p))
            worst = float((err.amax(0) / p.abs().where(fin, torch.zeros_like(
                p)).amax(0).clamp(min=1e-300)).max())
            return (worst <= 1e-9 and same_nan, float(err.max()),
                    f"postfilter: worst |err| / column max {worst:.2e} <= "
                    f"1e-9; non-finite where the twin's: {same_nan}")
        if name == "mcep_postfilter":
            k, p = out_k[0], out_p[0]
            worst = float(((k - p).abs() / (1.0 + p.abs())).max())
            return (worst <= 1e-9, float((k - p).abs().max()),
                    f"|err| <= 1e-9 (1 + |plain|): worst {worst:.2e}; c0 "
                    f"moved by up to {float((p[:, 0] - inp['mgc'][:, 0]).abs().max()):.3f}")
        if name == "gv_scale":
            k, p = out_k[0], out_p[0]
            worst = float(((k - p).abs().amax(0)
                           / p.abs().amax(0).clamp(min=1e-300)).max())
            kept = (True if inp["mask"] is None else bool(torch.equal(
                k[~inp["mask"]], inp["statics"][~inp["mask"]])))
            return (worst <= 1e-9 and kept, float((k - p).abs().max()),
                    f"worst |err| / column max {worst:.2e} <= 1e-9; rows "
                    f"outside the mask unchanged: {kept}")
        if name == "stonemask_if":
            k, p = out_k[0], out_p[0]
            g = inp["gate"]
            return (bit_same(k, p), float((k - p).abs().max()),
                    f"bit-equal; {int(g.sum())} of {g.numel()} frames gated, "
                    f"{int(((k == inp['f0s']) & ~g).sum())} kept by the 20 % "
                    f"guard")
        if name == "cheaptrick_lifter":
            # per element within 2e-6 relative (the log stage: of the
            # row's largest |log|)
            k, p = out_k[0], out_p[0]
            scale = (p.abs().amax(1, keepdim=True)
                     if inp["stage"] == ct_mod.LOG else p.abs())
            worst = float(((k - p).abs() / scale.clamp(min=1e-30)).max())
            return (worst <= 2e-6, float((k - p).abs().max()),
                    f"stage {inp['stage']}: worst |err| / |plain| "
                    f"{worst:.2e} <= 2e-6")
        if name == "d4c_group_delay":
            if inp["stage"] == d4c_mod.LOVE:
                (ak, pk, ck), (ap, pp, cp) = out_k, out_p
                rel = float(((ak - ap).abs() / ap.abs().clamp(
                    min=1e-30)).max())
                same = bool(torch.equal(pk, pp) and torch.equal(ck, cp))
                return (rel <= 1e-6 and same, float((ak - ap).abs().max()),
                        f"LoveTrain: ap0 rel {rel:.2e} <= 1e-6 (float64 "
                        f"block sums vs the twin's float32 cumsum); process "
                        f"and cf0 equal: {same} ({int(pk.sum())} of "
                        f"{pk.numel()} processed)")
            k, p = out_k[0], out_p[0]
            return (bit_same(k, p), max_err([(k, p)]),
                    f"stage {inp['stage']}: bit-equal (NaN where the "
                    f"twin's: the windows of silent frames)")
        if name == "d4c_aperiodicity":
            (ak, ck), (ap, cp) = out_k, out_p
            rel = float(((ak - ap).abs() / ap.abs()).max())
            e_c = float((ck - cp).abs().max())
            return (rel <= 1e-6 and e_c <= 1e-4, float((ak - ap).abs().max()),
                    f"ap rel {rel:.2e} <= 1e-6, coarse |err| {e_c:.2e} dB "
                    f"<= 1e-4")
        if name == "trajectory_nll":
            return check_k28(inp, out_k, out_p)
        if name == "trajectory_adjoint":
            return check_k29(inp, out_k, out_p)
        if name == "synth_midpass":
            return check_k30(inp, out_k, out_p)
        if name == "hsmm_viterbi":
            return check_k20(inp, out_k, out_p)
        if name == "hsmm_fb":
            return check_k18(inp, out_k, out_p)
        if name == "hsmm_accumulate":
            out_c = hsmm_batch.segment_sum_plain(**on_cpu(inp))
            again = hsmm_batch.segment_sum(**inp)
            same, det = bit_same(out_k[0], out_c), torch.equal(again,
                                                               out_k[0])
            return (same and det, max_err([(out_k[0], out_c)]),
                    f"bit-equal to the plain version's index_add_ on the "
                    f"CPU: {same}; two launches identical: {det}")
        if name == "harvest_decimate":
            k, p = out_k[0], out_p[0]
            err = (k - p).abs()
            worst = float((err / p.abs().amax(1, keepdim=True)
                           .clamp(min=1e-30)).max())
            return (worst <= 1e-6, float(err.max()),
                    f"per row |err| <= 1e-6 row max |plain| (both float64 "
                    f"inside): worst row {worst:.2e}")
        if name == "harvest_candidates":
            return check_k14(inp, out_k, out_p)
        if name == "harvest_refine":
            return check_k15(inp, out_k, out_p)
        if name == "harvest_contour":
            k, p = out_k[0], out_p[0]
            err = (k - p).abs()
            ok = bool(torch.equal(k > 0, p > 0)
                      and (err <= 1e-5 * p.abs()).all())
            return (ok, float(err.max()), "V/UV equal, |err| <= 1e-5 |plain|")
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
    heavy = ("fix_f0", "mlpg_solve", "dio_candidates", "harvest_candidates",
             "harvest_refine", "harvest_contour", "hsmm_loglik",
             "hsmm_fb", "hsmm_viterbi", "trajectory_nll",
             "trajectory_adjoint")  # slow plain twins
    replays = ([("copy_synth", n, i) for n, i in rec_cs]
               + [("feature_lane", n, i) for n, i in rec_fl]
               + [("synth_lane", n, i) for n, i in rec_sl]
               + [("harvest_lane", n, i) for n, i in rec_hl])

    def replay(path, name, inp):
        """Hold one recorded launch against the plain version; time the
        kernel, the plain version, the bound and the library call."""
        kern, plain = twins[kernels.base_name(name)]
        debug = (dict(crossings=True)
                 if name in ("dio_candidates", "harvest_candidates") else {})
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
        outs = (out_k[:2] if name == "dio_candidates"
                else out_k[:1] if name == "harvest_candidates" else out_k)
        bms, by = bound_of(name, inp, outs)
        shape = "x".join(str(s) for s in out_k[
            1 if kernels.base_name(name) in ("synth_time_base", "hsmm_fb")
            else 0].shape)
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
            return
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["bound_ms"] += bms
        s["by"][by] = s["by"].get(by, 0.0) + bms
        if lib_ms is not None:
            s["lib_ms"] = (s["lib_ms"] or 0.0) + lib_ms

    def replay_chunks(rec):
        """K9's chunk mode: every launch the streaming lane recorded
        against the twin on the CPU from the same carried state, bit for
        bit (its outputs and the state it hands on); µs a launch on the
        middle chunk; and one accumulate-mode K11 launch against its twin
        on the CPU."""
        chunks = [i for n, i in rec if n == "synth_time_base[chunk]"]
        bad, err = 0, 0.0
        for inp in chunks:
            args = {k: v for k, v in inp.items() if not k.startswith("state")}
            sk = (inp["state_d"].clone(), inp["state_i"].clone())
            sc = (inp["state_d"].cpu(), inp["state_i"].cpu())
            out_k = syn.chunk_pulses(**args, state_d=sk[0], state_i=sk[1])
            out_c = syn.chunk_pulses_plain(**on_cpu(args), state_d=sc[0],
                                           state_i=sc[1])
            same = (all(bit_same(a, b) for a, b in zip(out_k, out_c))
                    and bit_same(sk[0], sc[0]) and bit_same(sk[1], sc[1]))
            bad += not same
            err = max(err, max_err(zip(out_k, out_c)))
        inp = chunks[len(chunks) // 2]
        args = {k: v for k, v in inp.items() if not k.startswith("state")}
        sd, si = inp["state_d"].clone(), inp["state_i"].clone()
        ms = cuda_ms(lambda: syn.chunk_pulses(**args, state_d=sd,
                                              state_i=si), reps=10, warm=2)
        pd, pi = inp["state_d"].clone(), inp["state_i"].clone()
        plain_ms = cuda_ms(lambda: syn.chunk_pulses_plain(
            **args, state_d=pd, state_i=pi), reps=3)
        s0, n = args["s0"], args["n"]
        inc = syn.phase_increments(args["f0"][None], args["frame_period"],
                                   args["fs"], s0 + n,
                                   args["fft_size"])[0, s0:].contiguous()
        lib_ms = cuda_ms(lambda: torch.cumsum(inc, 0), reps=10, warm=2)
        P = args["max_pulses"]
        moved = 8 * args["f0"].numel() + 8 * 7 * P + 8 * 4
        t_b, t_o = moved / HBM_BYTES_PER_S, 60.0 * n / F64_OPS_PER_S
        bms = 1e3 * max(t_b, t_o)
        by = "bytes" if t_b >= t_o else "operations"
        acc_recs = [i for nm, i in rec
                    if nm == "synth_ola[f64]" and i.get("acc") is not None]
        a_inp = acc_recs[len(acc_recs) // 2]
        a_k = syn.overlap_add(**{**a_inp, "acc": a_inp["acc"].clone()})
        a_c = syn.overlap_add_plain(**on_cpu(a_inp))
        acc_same = bit_same(a_k, a_c)
        print(f"K9 chunk synth_time_base[chunk] (streaming) {len(chunks)} "
              f"chunks of {n} samples, cap {P}: bit-equal to the plain "
              f"version on the CPU (pulses, per-pulse values, the carried "
              f"state): {len(chunks) - bad} of {len(chunks)}; "
              f"{ms:.4f} ms a launch, plain {plain_ms:.4f} ms, bound "
              f"{bms:.6f} ms ({by}), library cumsum {lib_ms:.4f} ms; K11 "
              f"f64 accumulate mode (window {a_inp['y_length']} at "
              f"{a_inp['y0']}) bit-equal to the CPU: {acc_same}",
              flush=True)
        if bad or not acc_same:
            raise RuntimeError("K9's chunk mode or K11's accumulate mode "
                               "disagrees with its plain version")
        summary["synth_time_base[chunk]"] = dict(
            err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, lib_ms=lib_ms,
            by={by: bms})

    for path, name, inp in replays:
        replay(path, name, inp)
    del rec_cs, rec_fl, rec_sl, rec_hl, replays
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

    # bounds of the plain-torch stages that have no kernel yet, at the
    # shapes this run gave them: each array that enters or leaves the
    # stage moved once (f32), the operations per element as counted here
    def stage_bound(moved, ops32=0.0, ops64=0.0):
        t_b, t_o = moved / HBM_BYTES_PER_S, (ops32 / F32_OPS_PER_S
                                             + ops64 / F64_OPS_PER_S)
        return (f"{1e3 * max(t_b, t_o):.4f} ms ("
                f"{'bytes' if t_b >= t_o else 'operations'})")

    plan_h = hv.harvest_plan(L, FS, cfg.K_FLOOR_F0, cfg.K_CEIL_F0)
    n_ch, nf, L8 = (len(hv.channel_layout(plan_h)), plan_h["fft_size"],
                    plan_h["y_length"])
    T1 = cfg.samples_for_dio(FS, L, 1.0)
    R, H = BATCH * T, half + 1
    n_ap = cfg.number_of_aperiodicities(FS)
    print("plain-stage bounds (B=16 x 2.0 s @ 48 kHz): "
          # y in, the 152 band spectra, the filtered rows out; a real FFT
          # at 2.5 n log2 n, the complex product at 6 a bin
          f"Harvest band filter ({BATCH}, {L8}) -> ({BATCH}, {n_ch}, {nf}) "
          + stage_bound(4 * BATCH * L8 + 8 * n_ch * (nf // 2 + 1)
                        + 4 * BATCH * n_ch * nf,
                        2.5 * nf * np.log2(nf) * BATCH * (1 + n_ch)
                        + 6.0 * BATCH * n_ch * (nf // 2 + 1))
          # raw candidates in, the overlapped candidates out; ~8 f32
          # operations and one f64 add (the run sums) a (frame, channel)
          + f"; Harvest detect/overlap ({BATCH}, {n_ch}, {T1}) -> "
          f"({BATCH}, {T1}, {plan_h['nc_pad']}) "
          + stage_bound(4 * BATCH * n_ch * T1
                        + 4 * BATCH * T1 * plan_h["nc_pad"],
                        8.0 * BATCH * n_ch * T1, 1.0 * BATCH * n_ch * T1)
          # WORLD's coarse-band bap decode (ops/codec.py:150-165): the
          # n_ap bands in, the (R, H) aperiodicity out; a gather-lerp and
          # 10 ** (x / 20) (~15 operations) a bin
          + f"; coarse-band bap decode ({R}, {n_ap}) -> ({R}, {H}) "
          + stage_bound(4 * R * n_ap + 4 * R * H, 15.0 * R * H),
          flush=True)

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
    g = [v.cpu().double() for v in batch_mod.batch_analyze(
        xsm, FS, algorithm="harvest")]
    c = [v.double() for v in batch_mod.batch_analyze(
        xsm, FS, algorithm="harvest", device="cpu")]
    vuv = float(((g[1] > 0) == (c[1] > 0)).double().mean())
    both = (g[1] > 0) & (c[1] > 0)
    f0_rel = float(((g[1][both] - c[1][both]).abs() / c[1][both]).median())
    dlog = float((g[2].log() - c[2].log()).abs().median())
    print(f"Harvest lane, card vs CPU path (2 x 0.5 s): V/UV agreement "
          f"{vuv:.4f}, f0 med rel {f0_rel:.2e}, sp med |dlog| {dlog:.2e}",
          flush=True)
    if not (vuv >= 0.95 and f0_rel < 1e-3 and dlog < 0.1):
        raise RuntimeError("the card's Harvest lane disagrees with the CPU "
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
                                        "K1-K16", "other")}
        for e in evs:
            k = e.key.lower()
            g = ("gemm (DFT matmuls)" if "gemm" in k
                 else "fft" if "fft" in k
                 else "K1-K16" if any(n in k for n in kernels.KERNELS)
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

    # ---- 9a. the Harvest lane: stage times, throughput, profile ----
    sm = stage_ms(lambda: batch_mod.analyze_stages(xs, FS, FRAME_PERIOD,
                                                   algorithm="harvest"))
    print("Harvest lane stage ms (mean of 3, B=16 x 2.0 s @ 48 kHz): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sm.items()))
    throughput(lambda s: float(harvest_lane()[1].sum()), "Harvest lane")
    report_profile("Harvest lane", harvest_lane)
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

    # ---- 9b. corpus extraction with Harvest ----
    def extract_harvest():
        return bucketing.bucketed_extract(sigs, FS, max_batch=16,
                                          algorithm="harvest")

    extract_harvest()                                              # warm
    t0 = time.perf_counter()
    res, counts_ch, _ = counted("corpus500_harvest", extract_harvest)
    dt = time.perf_counter() - t0
    print(f"corpus500 Harvest throughput: {audio_s / dt:.2f} audio-s/s "
          f"({dt:.2f} s for {audio_s:.1f} s of audio, one timed run after "
          f"one warm run)", flush=True)
    if len(res) != len(sigs) or any(
            r[0].shape[0] != cfg.samples_for_dio(FS, n, FRAME_PERIOD)
            for r, n in zip(res, lengths)):
        raise RuntimeError("corpus500 Harvest: unexpected frame counts")
    check_features(*(torch.as_tensor(np.concatenate([r[k] for r in res]))
                     for k in range(3)), label="corpus500 Harvest outputs")
    wall, busy, _ = profiled(lambda: bucketing.bucketed_extract(
        [sigs[i] for i in grp], FS, max_batch=16, algorithm="harvest"))
    print(f"corpus500 Harvest one bucket group ({len(grp)} x {blen} "
          f"samples) under the profiler: wall {1e3 * wall:.1f} ms, device "
          f"busy {1e3 * busy:.1f} ms ({100 * busy / wall:.0f}%)", flush=True)

    del sigs, res
    torch.cuda.empty_cache()

    # ---- 10. HSMM EM: the batched monophone HERest at full width ----
    ms0, utts_h = hsmm_corpus(hsmm)
    Ts = [len(f) for f, _ in utts_h]
    Ks = [len(q) * HSMM_STATES for _, q in utts_h]
    n_frames = sum(Ts)
    print(f"HSMM corpus: {len(utts_h)} utterances, {n_frames} frames (T "
          f"{min(Ts)}-{max(Ts)}), K {min(Ks)}-{max(Ks)}, D "
          f"{utts_h[0][0].shape[1]}, {HSMM_MODELS} models x {HSMM_STATES} "
          f"states, max_dur {HSMM_MAX_DUR}", flush=True)

    def em(ms_init, utts, max_dur, max_batch, device="cuda"):
        """One batched Baum-Welch iteration from a copy of `ms_init`."""
        ms = hsmm.modelset_from_numpy(*ms_init.to_numpy())
        logs = []
        hist = hsmm_batch.reestimate_modelset_batched(
            ms, utts, n_iters=1, max_dur=max_dur, max_batch=max_batch,
            log=logs.append, device=device)
        return ms, hist, logs

    def em_lane(label, ms_init, utts, max_dur, max_batch):
        """Warm run, timed run, stage times, one E-step under the
        profiler; returns the timed run's model set."""
        nf = sum(len(f) for f, _ in utts)
        em(ms_init, utts, max_dur, max_batch)                     # warm
        sync()
        t0 = time.perf_counter()
        ms, hist, logs = em(ms_init, utts, max_dur, max_batch)
        sync()
        dt = time.perf_counter() - t0
        chained, gvar = hsmm_batch.chain_modelset(ms_init, utts)
        tables = hsmm_batch.tables_from_modelset(ms_init)
        M_, S_ = ms_init.dur_mean.shape
        n_rows = {st.name: M_ * S_ for st in ms_init.streams}
        spans, host, n_batches = {}, {}, 0
        sync()
        prev = torch.cuda.Event(enable_timing=True)
        prev.record()
        marks = []
        t_prev = time.perf_counter()
        for stage, res in hsmm_batch.corpus_estep_stages(
                tables, chained, n_rows, M_ * S_, max_dur,
                max_batch=max_batch):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((stage, e))
            t_now = time.perf_counter()
            host[stage] = host.get(stage, 0.0) + 1e3 * (t_now - t_prev)
            t_prev = t_now
            n_batches += stage == "pad"
        sync()
        for stage, e in marks:
            spans[stage] = spans.get(stage, 0.0) + prev.elapsed_time(e)
            prev = e
        ms_m = hsmm.modelset_from_numpy(*ms_init.to_numpy())
        t1 = time.perf_counter()
        hsmm_batch.mstep_modelset(ms_m, res, gvar * 0.01 + 1e-8)
        mstep_ms = 1e3 * (time.perf_counter() - t1)
        names_ = {"pad": "host pad + upload", "loglik": "gather + K17",
                  "fb": "dur gather + K18", "moments": "ok mask + bmm",
                  "accumulate": "K19", "done": "read back"}
        wall, busy, evs = profiled(lambda: hsmm_batch.corpus_estep(
            tables, chained, n_rows, M_ * S_, max_dur, max_batch=max_batch))
        print(f"{label}: {nf / dt:.1f} frames/s ({1e3 * dt:.1f} ms for "
              f"{nf} frames, one iteration timed after one warm run; "
              f"{logs[-1]}); E-step in {n_batches} batches, stage ms (CUDA "
              f"events): " + ", ".join(f"{names_[k]} {v:.2f}"
                                       for k, v in spans.items())
              + "; host clock: " + ", ".join(
                  f"{names_[k]} {v:.2f}" for k, v in host.items())
              + f"; host M-step {mstep_ms:.2f} ms", flush=True)
        by_kind = {}
        for ev in evs:
            k = ev.key.lower()
            g = next((n for n in PATHS["hsmm_em"] if n in k),
                     "gemm" if "gemm" in k else "other")
            by_kind.setdefault(g, [0.0, 0])
            by_kind[g][0] += dev_us(ev) / 1e3
            by_kind[g][1] += ev.count
        print(f"{label}: one E-step under the profiler: wall "
              f"{1e3 * wall:.1f} ms, device busy {1e3 * busy:.1f} ms "
              f"({100 * busy / wall:.0f}%, idle {100 - 100 * busy / wall:.0f}"
              f"%); by kind: " + ", ".join(
                  f"{g} {v:.2f} ms in {n}" for g, (v, n) in by_kind.items())
              + f"; n_ok {res.n_ok:.0f} of {len(utts)}, total loglik "
              f"{res.total_ll:.6e}", flush=True)
        return ms, res

    em(ms0, utts_h, HSMM_MAX_DUR, 32)                             # warm
    (ms1, hist, logs), counts_hm, rec_hm = counted(
        "hsmm_em", lambda: em(ms0, utts_h, HSMM_MAX_DUR, 32), record=True)
    bad = [n for n, v in list(ms1.means.items()) + list(
        ms1.variances.items()) + list(ms1.msd_weights.items())
        + [("dur_mean", ms1.dur_mean), ("dur_var", ms1.dur_var)]
        if not np.isfinite(v).all()]
    print(f"HSMM lane: {logs[-1]}; non-finite parameters: {bad or 'none'}",
          flush=True)
    if bad or not np.isfinite(hist[-1]) or hist[-1] <= hsmm.LOG_ZERO / 2 \
            or f"({HSMM_UTTS} utts)" not in logs[-1]:
        raise RuntimeError("HSMM lane: non-finite parameters, infeasible "
                           "log-likelihood or dropped utterances")
    for name, inp in rec_hm:
        replay("hsmm_em", name, inp)
    del rec_hm
    torch.cuda.empty_cache()

    # the card against the CPU path on the tiny streams
    ms_t, utts_t = hsmm_tiny_corpus(hsmm)
    chained_t, _ = hsmm_batch.chain_modelset(ms_t, utts_t)
    M_, S_ = ms_t.dur_mean.shape
    n_rows_t = {st.name: M_ * S_ for st in ms_t.streams}
    tab_t = hsmm_batch.tables_from_modelset(ms_t)
    acc_g, acc_c = (hsmm_batch.corpus_estep(tab_t, chained_t, n_rows_t,
                                            M_ * S_, 40, device=d)
                    for d in ("cuda", "cpu"))
    worst = max(
        [float(np.abs(g[k] - c[k]).max() / max(np.abs(c[k]).max(), 1e-300))
         for g, c in zip(acc_g.streams, acc_c.streams) for k in c]
        + [float(np.abs(acc_g.dur - acc_c.dur).max()
                 / np.abs(acc_c.dur).max()),
           abs(acc_g.total_ll - acc_c.total_ll) / abs(acc_c.total_ll)])
    got, want = (hsmm.modelset_from_numpy(*ms_t.to_numpy())
                 for _ in range(2))
    for d, ms_d in (("cuda", got), ("cpu", want)):
        hsmm_batch.reestimate_modelset_batched(ms_d, utts_t, n_iters=2,
                                               log=lambda m: None, device=d)
    a_g, a_c = got.to_numpy(), want.to_numpy()
    d_par = max(float(np.abs(a_g[i][k] - a_c[i][k]).max())
                for i in (1, 2, 3) for k in a_c[i])
    d_par = max(d_par, float(np.abs(a_g[4] - a_c[4]).max()),
                float(np.abs(a_g[5] - a_c[5]).max()))
    ends_same = all(np.array_equal(
        hsmm.align_utterance(got, f, q)[1],
        hsmm.align_utterance(got, f, q, device="cpu")[1]) for f, q in utts_t)
    print(f"HSMM, card vs CPU path (8 utterances, T "
          f"{min(len(f) for f, _ in utts_t)}-"
          f"{max(len(f) for f, _ in utts_t)}, 10-dim streams): E-step "
          f"accumulators worst max|d| / max|CPU| {worst:.2e} (<= 1e-9), "
          f"n_ok {acc_g.n_ok:.0f} / {acc_c.n_ok:.0f}; parameters after 2 "
          f"iterations max |d| {d_par:.2e} (< 1e-8); align_utterance ends "
          f"equal: {ends_same}", flush=True)
    if not (worst <= 1e-9 and d_par < 1e-8 and ends_same
            and acc_g.n_ok == acc_c.n_ok):
        raise RuntimeError("the card's HSMM EM disagrees with the CPU path")

    # stage times, frames/s, device busy share: the lane and bench's recipe
    em_lane(f"HSMM lane (D 237, {HSMM_UTTS} utts, max_batch 32)", ms0,
            utts_h, HSMM_MAX_DUR, 32)
    ms_b, utts_b = hsmm_bench_corpus(hsmm)
    em_lane("HSMM bench.py recipe (D 14, 128 utts, max_dur 40, max_batch "
            "128)", ms_b, utts_b, 40, 128)

    # ---- 11. the tied-model voice recipe (train_voice) at full width ----
    utts_r, names_r = recipe_corpus(hsmm)
    questions_r = clustering.questions_from_config(
        qconf.parse_config(recipe_questions(names_r)))
    ctxs_r = sorted({c for _, seq in utts_r for c in seq})
    Ts = [len(f) for f, _ in utts_r]
    n_frames_r = sum(Ts)
    print(f"recipe corpus: {len(utts_r)} utterances from {RECIPE_TEMPLATES} "
          f"templates, {n_frames_r} frames (T {min(Ts)}-{max(Ts)}), "
          f"{min(len(q) for _, q in utts_r)}-{max(len(q) for _, q in utts_r)}"
          f" labels, {len(ctxs_r)} distinct contexts, {len(questions_r)} "
          f"questions, D {utts_r[0][0].shape[1]}; RecipeConfig() defaults",
          flush=True)

    class Keep(list):
        """The recipe's launches worth replaying: every K20 launch and the
        K19 launches on the untied clone's tables (>= 1000 rows)."""
        def append(self, item):
            name, inp = item
            if name == "hsmm_viterbi" or (name == "hsmm_accumulate"
                                          and inp["n_rows"] >= 1000
                                          and len(self) < 400):
                super().append(item)

    logs_r = []
    sync()
    kernels.reset_counts()
    kernels.record = Keep()
    t0 = time.perf_counter()
    st_r = recipe.train_voice(utts_r, questions_r, recipe.RecipeConfig(),
                              log=logs_r.append)
    sync()
    wall_r = time.perf_counter() - t0
    counts_rc = dict(kernels.launches)
    rec_rc, kernels.record = kernels.record, None
    print("launches on recipe:", counts_rc, flush=True)
    missing = [k for k in PATHS["recipe"] if counts_rc.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on recipe: {missing}")
    secs = st_r.stage_seconds
    trees_s = secs["CXCL trees"] + secs["CXCL2 trees"] + secs["MCDGV"]
    print(f"recipe: {wall_r:.2f} s wall; stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items())
        + f"; host tree search (CXCL, CXCL2, MCDGV) {trees_s:.2f} s = "
        f"{100 * trees_s / wall_r:.1f}% of the run", flush=True)
    cm = st_r.clustered
    n_aligned = len(st_r.alignments)
    erst2_fps = n_frames_r / secs["ERST2"]
    print(f"recipe: ERST2 (one tied BW iteration) {erst2_fps:.1f} frames/s; "
          f"FALGN {len(utts_r) / secs['FALGN']:.1f} "
          f"utterances/s; aligned {n_aligned} of {len(utts_r)}; untied rows "
          f"per stream {len(ctxs_r) * cm.n_states} ({len(ctxs_r)} contexts x "
          f"{cm.n_states}); leaves per stream and state: " + "; ".join(
              f"{st.name} {[t.n_leaves for t in cm.trees[st.name]]}"
              for st in cm.streams)
          + f"; duration {cm.dur_tree.n_leaves}; GV " + ", ".join(
              f"{n} {t.n_leaves}" for n, t in st_r.gv.trees.items())
          + "; " + "; ".join(m for m in logs_r if "BW iter" in m),
          flush=True)
    bad = [f"{st.name}/{s}" for st in cm.streams for s in range(cm.n_states)
           for m, v in cm.trees[st.name][s].leaf_params
           if not (np.isfinite(m).all() and np.isfinite(v).all()
                   and (v > 0).all())]
    ends_ok = all(e[-1] == len(utts_r[u][0]) and (np.diff(e) >= 1).all()
                  and e[0] >= 1 for u, e in st_r.alignments.items())
    with tempfile.TemporaryDirectory() as tmp:
        path_v = os.path.join(tmp, "lane.htsvoice")
        recipe.export(st_r, path_v, 48000, 240, recipe.RecipeConfig())
        hdr = voice.read_htsvoice_header(path_v)
        size_v = os.path.getsize(path_v)
    print(f"recipe: exported {size_v} bytes; header NUM_STATES "
          f"{hdr['NUM_STATES']}, STREAM_TYPE {hdr['STREAM_TYPE']}, USE_GV "
          + ",".join(hdr[f"USE_GV[{t}]"] for t in
                     hdr["STREAM_TYPE"].split(","))
          + f"; non-finite or non-positive leaves: {bad or 'none'}; "
          f"alignments monotone and ending at T: {ends_ok}", flush=True)
    if (bad or not ends_ok or n_aligned != len(utts_r)
            or hdr["NUM_STATES"] != "5" or hdr["STREAM_TYPE"]
            != "MGC,LF0,BAP,VIB" or "GV_PDF[MGC]" not in hdr):
        raise RuntimeError("recipe lane: bad leaves, alignments or voice")

    # where the host tree search's time goes: one mgc tree (state 0) from
    # hard counts under the final model's alignments, under cProfile
    stats_h = context_clustered.collect_context_stats_tied(cm, utts_r,
                                                           HSMM_MAX_DUR)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    tree_h = clustering.cluster_states(stats_h[0]["mgc"][0], questions_r)
    prof.disable()
    dt = time.perf_counter() - t0
    own = pstats.Stats(prof).stats            # (file, line, fn) -> times
    total = sum(v[2] for v in own.values())
    top = sorted(own.items(), key=lambda kv: kv[1][2], reverse=True)[:4]
    print(f"recipe: one mgc tree ({len(stats_h[0]['mgc'][0])} contexts, "
          f"{tree_h.n_leaves} leaves) under cProfile: {dt:.2f} s; own time "
          + ", ".join(f"{os.path.basename(k[0])}:{k[1]}({k[2]}) "
                      f"{100 * v[2] / total:.0f}%" for k, v in top),
          flush=True)
    del stats_h, prof, own

    # a tied BW iteration (ERST2's work) on a copy of the final model,
    # under the profiler: the device's busy share
    tied = copy.deepcopy(cm)
    wall, busy, evs = profiled(lambda: hsmm_batch.reestimate_clustered_batched(
        tied, utts_r, n_iters=1, max_dur=HSMM_MAX_DUR, log=lambda m: None))
    by_kind = {}
    for ev in evs:
        k = ev.key.lower()
        g = next((n for n in PATHS["recipe"] if n in k),
                 "gemm" if "gemm" in k else "other")
        by_kind.setdefault(g, [0.0, 0])
        by_kind[g][0] += dev_us(ev) / 1e3
        by_kind[g][1] += ev.count
    print(f"recipe: one tied BW iteration under the profiler: wall "
          f"{1e3 * wall:.1f} ms, device busy {1e3 * busy:.1f} ms "
          f"({100 * busy / wall:.0f}%, idle {100 - 100 * busy / wall:.0f}%);"
          f" by kind: " + ", ".join(f"{g} {v:.2f} ms in {n}"
                                    for g, (v, n) in by_kind.items()),
          flush=True)
    del tied

    # phase 3 for the recipe: K20's launches (FALGN's padded batches, each
    # also against its shortest utterance alone) and the untied K19's, K18
    # and K20 past the shared-memory rows (T 9000), K17 with a NaN in bap
    vit = [i for n, i in rec_rc if n == "hsmm_viterbi"]
    acc = [i for n, i in rec_rc if n == "hsmm_accumulate"]
    print(f"recipe replays: {len(vit)} K20 launches (batches of "
          f"{sorted(len(i['t_len']) for i in vit)} utterances), {len(acc)} "
          f"K19 launches at {sorted({i['n_rows'] for i in acc})} rows",
          flush=True)
    for inp in vit:
        replay("recipe", "hsmm_viterbi", inp)
    for inp in acc[:4]:
        replay("recipe", "hsmm_accumulate", inp)
    long18 = k18_long_inputs(dev)
    replay("recipe_long", "hsmm_fb", dict(long18, temper=1.0))
    long20 = dict(long18)
    long20.pop("max_dur")
    replay("recipe_long", "hsmm_viterbi", dict(long20, max_dur=HSMM_MAX_DUR))
    replay("recipe_nan", "hsmm_loglik", nan_bap_inputs(hsmm, dev))
    del rec_rc, vit, acc, long18, long20
    torch.cuda.empty_cache()

    # phase 4 for the recipe: the card against the CPU path on
    # tests/test_recipe.py's corpus
    utts_t, spans_t = recipe_tiny_corpus()
    qs_t = clustering.questions_from_config(qconf.parse_config(TINY_QUESTIONS))
    voices, built = [], []
    for d in ("cuda", "cpu"):
        with recording_trees(clustering) as trees_d:
            voices.append(recipe.train_voice(
                utts_t, qs_t, recipe.RecipeConfig(**TINY_RECIPE),
                streams=tiny_streams(hsmm), bootstrap_spans=spans_t,
                log=lambda m: None, device=d))
        built.append(trees_d)
    ok, text = compare_voices(*voices, utts_t, clustering, *built)
    print(f"recipe, card vs CPU path (tests/test_recipe.py's corpus, soft "
          f"counts): {text}", flush=True)
    if not ok:
        raise RuntimeError("the card's recipe disagrees with the CPU path")

    # ---- 12. the voice-build lane: sung audio -> voice -> wav ----
    VFS = 48000
    sigs_v, labels_v, spans_v, templates_v, unseen_v = voice_corpus()
    audio_v = sum(len(x) for x in sigs_v) / VFS
    print(f"voice corpus: {len(sigs_v)} sung phrases at {VFS} Hz from "
          f"{len(templates_v)} templates, {audio_v:.1f} s of audio, "
          f"{len({c for q in labels_v for c in q})} distinct contexts; "
          f"{len(unseen_v)} unseen phrases", flush=True)

    class KeepVoice(list):
        """The lane's launches worth replaying: the first of each kind of
        K21 (analysis, postfilter), K22, K23 (with and without the lf0
        mask) and K7/K8 in float64."""
        def __init__(self):
            super().__init__()
            self.kinds = set()

        def append(self, item):
            name, inp = item
            if name == "mspf":
                kind = inp["stats"] is None
            elif name == "gv_scale":
                kind = inp["mask"] is None
            elif name == "mcep_postfilter":
                kind = None
            elif name in ("delta_window", "mlpg_solve"):
                x = inp["x"] if name == "delta_window" else inp["means"]
                if x.dtype != torch.float64:
                    return
                kind = None
            else:
                return
            if (name, kind) not in self.kinds:
                self.kinds.add((name, kind))
                super().append(item)

    def counted_keep(path, fn, keep=False):
        """`counted`, timed: (result, counts, wall s, kept launches)."""
        t0 = time.perf_counter()
        out, counts, kept = counted(path, fn, keep)
        return out, counts, time.perf_counter() - t0, kept or []

    def extract_v():
        return bucketing.bucketed_extract(sigs_v, VFS, max_batch=16)

    extract_v()                                                   # warm
    feats_v, counts_vx, dt, _ = counted_keep("voice_extract", extract_v)
    print(f"voice lane: bucketed_extract {audio_v / dt:.2f} audio-s/s "
          f"({dt:.3f} s, one timed run after one warm run)", flush=True)
    lay_v = compose.StreamLayout(mgc_dim=50, lf0_dim=1, bap_dim=25,
                                 vib_dim=1)

    def compose_v():
        return [(compose.compose_cmp(m, l[:, None], b, np.zeros((len(l), 1)),
                                     lay_v).astype(np.float64), q)
                for (l, m, b), q in zip(feats_v, labels_v)]

    corpus_v, counts_vc, dt, kept_vc = counted_keep("voice_compose",
                                                    compose_v, KeepVoice())
    spans_v = {u: np.minimum(e, len(corpus_v[u][0]))
               for u, e in spans_v.items()}
    print(f"voice lane: compose_cmp {len(corpus_v)} utterances in {dt:.3f} "
          f"s, D {corpus_v[0][0].shape[1]}, T "
          f"{min(len(f) for f, _ in corpus_v)}-"
          f"{max(len(f) for f, _ in corpus_v)}", flush=True)
    cfg_v = recipe.RecipeConfig(use_mspf=True)
    qs_v = clustering.questions_from_config(
        qconf.parse_config(voice_questions()))
    logs_v = []
    st_v, counts_vt, wall_v, kept_vt = counted_keep(
        "voice_train", lambda: recipe.train_voice(
            corpus_v, qs_v, cfg_v, streams=hsmm.world_streams(lay_v),
            bootstrap_spans=spans_v, log=logs_v.append), KeepVoice())
    secs = st_v.stage_seconds
    trees_s = secs["CXCL trees"] + secs["CXCL2 trees"] + secs["MCDGV"]
    print(f"voice lane: train_voice {wall_v:.2f} s wall, {len(qs_v)} "
          f"questions; stage seconds: " + ", ".join(
              f"{k} {v:.3f}" for k, v in secs.items())
          + f"; host tree search {trees_s:.2f} s = "
          f"{100 * trees_s / wall_v:.1f}%; aligned {len(st_v.alignments)} "
          f"of {len(corpus_v)}", flush=True)
    if len(st_v.alignments) != len(corpus_v) or st_v.mspf is None \
            or st_v.mspf[0].mean.shape != (50, 33) or not all(
                np.isfinite(a).all() for m in st_v.mspf
                for a in (m.mean, m.std)):
        raise RuntimeError("voice lane: utterances dropped or MSPF "
                           "statistics missing or not finite")
    tmp_v = tempfile.mkdtemp()
    path_v = os.path.join(tmp_v, "voice.htsvoice")
    recipe.export(st_v, path_v, VFS, 240, cfg_v)
    t0 = time.perf_counter()
    voice_v = engine.load_voice(path_v)
    print(f"voice lane: exported {os.path.getsize(path_v)} bytes, loaded in "
          f"{time.perf_counter() - t0:.3f} s; leaves per stream and state: "
          + "; ".join(f"{st.name} {[t.n_leaves for t in st_v.clustered.trees[st.name]]}"
                      for st in st_v.clustered.streams), flush=True)

    # the unseen phrases twice: as the recipe's settings say (GV on mgc
    # and lf0, MSPF), and with GV on mgc alone, the setting the gates hold:
    # GV scaling rescales each phrase's lf0 to the GV model's variance,
    # which the training phrases' own pitch ranges set, and so moves a new
    # phrase's notes off their pitches (PERF.md)
    gated_cfg = pgen.GenConfig(use_gv=True, gv_streams=("mgc",),
                               alpha=voice_v[2].alpha or 0.42)
    settings = {"voice_synth": dict(use_mspf=st_v.mspf),
                "voice_synth_gated": dict(gen_cfg=gated_cfg,
                                          use_mspf=st_v.mspf)}

    def synth_v(i, ph, path="voice_synth"):
        return engine.synthesize(voice_v, voice_labels(ph), seed=100 + i,
                                 **settings[path])

    def gates(label, ph, y, durs):
        yn = y.detach().cpu().double().numpy()
        f0 = batch_mod.batch_analyze(y.float()[None], VFS)[1][0]
        ok, sung, sil, worst = note_gates(yn, durs, ph, 5, VFS,
                                          f0.cpu().double().numpy())
        return ok, f"{label}: sung rms {sung:.4f}, sil {sil:.5f}, worst " \
                   f"note f0 err {100 * worst:.2f}%"

    synth_v(0, unseen_v[0])                                       # warm
    counts_vg = {}
    for path in ("voice_synth", "voice_synth_gated"):
        outs_v, counts_p, dt, kept_p = counted_keep(path, lambda: [
            synth_v(i, ph, path) for i, ph in enumerate(unseen_v)],
            KeepVoice() if path == "voice_synth" else False)
        if path == "voice_synth":
            counts_vs, kept_vs = counts_p, kept_p
        else:
            counts_vg = counts_p
        gen_s = sum(len(o[0]) for o in outs_v) / VFS
        print(f"voice lane: engine.synthesize of {len(unseen_v)} unseen "
              f"phrases ({path}) in {dt:.3f} s: {len(unseen_v) / dt:.2f} "
              f"utterances/s, {gen_s / dt:.2f} audio-s/s ({gen_s:.1f} s "
              f"generated)", flush=True)
        failed = []
        for i, (ph, (y, _, _, d)) in enumerate(zip(unseen_v, outs_v)):
            if not torch.isfinite(y).all():
                raise RuntimeError(f"{path}: non-finite waveform")
            ok, text = gates(f"phrase {i} ({len(ph) - 2} notes)", ph, y, d)
            print(f"voice lane gates ({path}), {text}: "
                  f"{'pass' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append(i)
        print(f"voice lane ({path}): {len(unseen_v) - len(failed)} of "
              f"{len(unseen_v)} phrases pass the gates", flush=True)
        if failed and path == "voice_synth_gated":
            raise RuntimeError(f"voice lane: phrases {failed} fail the "
                               f"audibility or note-F0 gates")
        del outs_v

    # per generated utterance: the stages on the host clock, each ended by
    # a synchronize (the lane waits on its host)
    spans_g = {}
    for i, ph in enumerate(unseen_v):
        t_prev = time.perf_counter()
        labels = voice_labels(ph)
        gcfg = pgen.GenConfig(use_gv=True, alpha=voice_v[2].alpha or 0.42)
        for stage, res in pgen.parameter_stages(
                voice_v[0], labels, gcfg, voice_v[1], mspf=st_v.mspf):
            sync()
            t_now = time.perf_counter()
            spans_g[stage] = spans_g.get(stage, 0.0) + t_now - t_prev
            t_prev = t_now
        statics, vuv, durs = res
        for stage, res in pgen.waveform_stages(statics, vuv, VFS, seed=i):
            sync()
            t_now = time.perf_counter()
            spans_g[stage] = spans_g.get(stage, 0.0) + t_now - t_prev
            t_prev = t_now
    print("voice lane: ms per generated utterance (host clock, mean of "
          f"{len(unseen_v)}): " + ", ".join(
              f"{k} {1e3 * v / len(unseen_v):.2f}" for k, v in spans_g.items()),
          flush=True)
    wall, busy, evs = profiled(lambda: synth_v(1, unseen_v[1]))
    print(f"voice lane: one engine.synthesize under the profiler: wall "
          f"{1e3 * wall:.1f} ms, device busy {1e3 * busy:.2f} ms, idle "
          f"{100 - 100 * busy / wall:.1f}%; top: " + ", ".join(
              f"{e.key[:40]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
              for e in evs[:6]), flush=True)

    # the mcep postfilter (K22) and pgtype 1 (K7, K17, K18) through
    # synthesize_utterance
    import dataclasses as dc
    ph0 = unseen_v[2]
    variants = {}
    for path, vcfg in (("voice_mcep", dc.replace(cfg_v, use_mspf=False,
                                                 postfilter_mcp=1.4)),
                       ("voice_pgtype1", dc.replace(cfg_v, pgtype=1))):
        (y, _, _, d), counts_x, dt, kept_x = counted_keep(
            path, lambda: recipe.synthesize_utterance(
                st_v, voice_labels(ph0), vcfg, VFS, seed=7), KeepVoice())
        ok, text = gates(path, ph0, y, d)
        print(f"voice lane {text} in {1e3 * dt:.1f} ms (gates "
              f"{'pass' if ok else 'not met'}, informational)", flush=True)
        if not torch.isfinite(y).all():
            raise RuntimeError(f"{path}: non-finite waveform")
        variants[path] = (counts_x, kept_x)

    # phase 3 for the lane: K21, K22, K23 and K7/K8 in float64
    for path, kept in (("voice_compose", kept_vc), ("voice_train", kept_vt),
                       ("voice_synth", kept_vs),
                       ("voice_mcep", variants["voice_mcep"][1]),
                       ("voice_pgtype1", variants["voice_pgtype1"][1])):
        for name, inp in kept:
            replay(path, name, inp)
    torch.cuda.empty_cache()

    # phase 4 for the lane: tests/test_voice_build.py's corpus, the voice
    # trained on the card and on the CPU (the same voice, as the recipe
    # lane's phase 4 holds it), then generation from the card's voice on
    # the card and on the CPU, and from each device's own voice
    corpus_t, spans_t, lay_t = voice_tiny_corpus(bucketing, compose, "cpu")
    cfg_t = recipe.RecipeConfig(**VOICE_TINY_RECIPE)
    qs_t = clustering.questions_from_config(
        qconf.parse_config(VOICE_TINY_QUESTIONS))
    st_t, built_t = {}, []
    for d in ("cuda", "cpu"):
        with recording_trees(clustering) as trees_d:
            st_t[d] = recipe.train_voice(
                corpus_t, qs_t, cfg_t, streams=hsmm.world_streams(lay_t),
                bootstrap_spans=spans_t, log=lambda m: None, device=d)
        built_t.append(trees_d)
    # the voiced Gaussians of MSD leaves with weight <= 0.5 (leaves whose
    # frames generation makes unvoiced) are left out: the tied M-step keeps
    # an MSD leaf's previous parameters at a voiced occupancy <= 2.0 frames
    # (hsmm_batch.mstep_clustered), and this corpus's first sil state has a
    # voiced occupancy at 2.0 within rounding, so the two devices take the
    # two branches there (PERF.md)
    ok_v, text_v = compare_voices(st_t["cuda"], st_t["cpu"], corpus_t,
                                  clustering, *built_t, msd_floor=0.5)
    labels_t = [f"x^x-{p}+x=x/E:1]" for p in ("sil", "n2", "n0", "n1",
                                              "sil")]
    d_t = pgen.state_durations(st_t["cpu"].clustered, labels_t)
    yl_t = cfg.y_length_for(int(d_t.sum()), FRAME_PERIOD, 16000)
    nz_t = np.random.default_rng(14).standard_normal(
        syn.synthesis_stream_len(yl_t))
    got = {(v, d): recipe.synthesize_utterance(st_t[v], labels_t, cfg_t,
                                               16000, noise=nz_t, device=d)
           for v, d in (("cuda", "cuda"), ("cuda", "cpu"), ("cpu", "cpu"))}

    def rel_statics(a, b):
        """Per stream, the worst |difference| over its largest |value|
        (MAGIC where both have it; 0 for a stream that is MAGIC
        throughout)."""
        out = {}
        for n in b:
            x, w = a[n].cpu(), b[n].cpu()
            live = w != pgen.MAGIC
            if not torch.equal(x == pgen.MAGIC, ~live):
                out[n] = float("inf")
            elif live.any():
                out[n] = float((x - w).abs()[live].max()
                               / w.abs()[live].max().clamp(min=1e-300))
            else:
                out[n] = 0.0
        return out

    def agree(a, b):
        (ya, sa, va, da), (yb, sb, vb, db) = a, b
        same = bool(np.array_equal(da, db)) and bool(torch.equal(
            va.cpu(), vb.cpu()))
        rel = rel_statics(sa, sb) if same else {"durations": float("inf")}
        ya, yb = ya.cpu().double(), yb.cpu().double()
        wave = ((float((ya - yb).abs().max() / yb.abs().max()),
                 abs(float(ya.pow(2).sum() / yb.pow(2).sum()) - 1.0))
                if ya.shape == yb.shape else (float("inf"),) * 2)
        return same, rel, wave

    same_g, rel_g, wave_g = agree(got["cuda", "cuda"], got["cuda", "cpu"])
    same_x, rel_x, wave_x = agree(got["cuda", "cuda"], got["cpu", "cpu"])
    path_t = os.path.join(tmp_v, "tiny.htsvoice")
    recipe.export(st_t["cuda"], path_t, 16000, 80, cfg_t)
    dg = got["cuda", "cuda"][3]
    y_f, s_f, v_f, _ = engine.synthesize(path_t, labels_t, durs=dg,
                                         noise=nz_t)
    y_s, s_s, v_s, _ = recipe.synthesize_utterance(
        st_t["cuda"], labels_t, dc.replace(cfg_t, use_mspf=False), 16000,
        durs=dg, noise=nz_t)
    f_ok = bool(torch.equal(v_f, v_s)) and all(
        bool(torch.allclose(s_f[n], s_s[n], rtol=2e-4, atol=2e-4))
        for n in s_s)
    f_rms = float((y_f.double() - y_s.double()).pow(2).mean().sqrt()
                  / y_s.double().pow(2).mean().sqrt())

    def fmt(rel):
        return ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
    print(f"voice lane, card vs CPU path (tests/test_voice_build.py's "
          f"corpus, 16 kHz, mgc 12): the voices trained on each: {text_v}; "
          f"generation from the card's voice, card vs CPU: durations and "
          f"V/UV equal {same_g}, statics worst rel {fmt(rel_g)} (<= 1e-9), "
          f"waveform on injected noise max |dy| / peak {wave_g[0]:.2e}, "
          f"energy rel {wave_g[1]:.2e} (<= 1e-3); each from its own voice: "
          f"durations and V/UV equal {same_x}, statics worst rel "
          f"{fmt(rel_x)} (mgc and bap <= 1e-9; lf0 reads the sil leaf "
          f"through unvoiced frames), waveform {wave_x[0]:.2e} / "
          f"{wave_x[1]:.2e}; "
          f"exported file vs state (no MSPF, pinned durations): statics "
          f"within 2e-4 {f_ok}, waveform rel RMS {f_rms:.2e} (< 1e-2)",
          flush=True)
    if not (ok_v and same_g and max(rel_g.values()) <= 1e-9
            and wave_g[0] <= 1e-3 and wave_g[1] <= 1e-3 and same_x
            and max(rel_x["mgc"], rel_x["bap"]) <= 1e-9
            and f_ok and f_rms < 1e-2):
        raise RuntimeError("the card's voice lane disagrees with the CPU "
                           "path or the file with the state")
    shutil.rmtree(tmp_v)

    # ---- 13. the pipeline lane: the corpus pipeline's front half ----
    counts_pa, counts_pc, counts_ph, pipe_p, utts_p, unseen_p = \
        pipeline_lane(counted, profiled)
    pipeline_card_vs_cpu()

    # ---- 14. the DNN lane: training throughput, then the pipeline's DNN
    # half on phase 13's workdir ----
    counts_dt, rec_dt = dnn_lanes(counted)
    for name, inp in rec_dt:
        replay("dnn_trajectory", name, inp)
    # K28 and K29 in float64 on the card: gradcheck of TrajectoryNLL
    rng_g = np.random.default_rng(29)
    mu_g = torch.as_tensor(rng_g.standard_normal((2, 9, 3, 4)), device=dev
                           ).requires_grad_(True)
    prec_g = torch.as_tensor(np.exp(0.5 * rng_g.standard_normal(
        (2, 9, 3, 4))), device=dev).requires_grad_(True)
    s_g = torch.as_tensor(rng_g.standard_normal((2, 9, 4)), device=dev)
    ok_g = torch.autograd.gradcheck(
        lambda m, q: traj_mod.TrajectoryNLL.apply(m, q, s_g),
        (mu_g, prec_g), raise_exception=False)
    print(f"K28/K29 float64 gradcheck on the card (B 2, T 9, D 4): {ok_g}",
          flush=True)
    if not ok_g:
        raise RuntimeError("K28/K29: the float64 gradcheck failed")
    counts_dnn = dnn_pipeline_lane(pipe_p, utts_p, unseen_p, counted,
                                   profiled)
    shutil.rmtree(pipe_p.wd)
    dnn_card_vs_cpu()

    # ---- 15. the parity lane: float64 synthesis on the reference's noise
    # stream (the exact path, the synth CLI's default, streaming) ----
    t15 = time.perf_counter()
    counts_pl, rec_pl, _ = parity_lane(counted, profiled, feats)
    for name, inp in rec_pl:
        replay("parity_lane", name, inp)
    del rec_pl
    torch.cuda.empty_cache()
    parity_card_vs_cpu()
    counts_pc = parity_cli(counted, feats)
    params_s = decode.decode_features(*(v[0].double() for v in feats), FS, N)
    counts_st, rec_st = streaming_lane(counted, profiled, params_s)
    replay_chunks(rec_st)
    del rec_st, params_s
    print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)

    print(smi)
    src = "hts_train_world_tpu_torch/csrc/"
    by_path = {"copy_synth": counts_cs, "feature_lane": counts_fl,
               "synth_lane": counts_sl, "corpus500": counts_cp,
               "harvest_lane": counts_hl, "corpus500_harvest": counts_ch,
               "hsmm_em": counts_hm, "recipe": counts_rc,
               "voice_extract": counts_vx, "voice_compose": counts_vc,
               "voice_synth": counts_vs, "voice_synth_gated": counts_vg,
               "voice_mcep": variants["voice_mcep"][0],
               "voice_pgtype1": variants["voice_pgtype1"][0],
               "voice_train": counts_vt, "pipeline_analyze": counts_pa,
               "pipeline_compose": counts_pc, "pipeline_halgn": counts_ph,
               "dnn_trajectory": counts_dt, **counts_dnn,
               "parity_lane": counts_pl, "parity_cli": counts_pc,
               "streaming": counts_st}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": src + kernels.KERNELS[kernels.base_name(name)][0],
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
