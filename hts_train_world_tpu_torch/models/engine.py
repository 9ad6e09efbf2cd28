"""Synthesis from a LOADED .htsvoice — the hts_engine side of the voice
container contract.

Counterpart of `hts_train_world_tpu/models/engine.py`: rebuild a
generation-ready ClusteredModel (+ GV model) from `voice.load_htsvoice`
output and drive the standard PGEN/WGEN path (models/pgen.py: durations
-> MLPG -> GV -> postfilter -> WORLD) on `device` ("cuda", the default,
or "cpu").

Parameters in the container are float32 (Training.pl writes pdfs as
packed floats), so a voice-loaded synthesis matches the in-memory
RecipeState synthesis to f32 quantization of the model parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from hts_train_world_tpu_torch.models import context_clustered as cc
from hts_train_world_tpu_torch.models import hsmm, pgen, voice
from hts_train_world_tpu_torch.models.gv_model import GVModel

# stream weights are a training-time notion (Config.pm.in:123-127) not
# stored in the container; generation never consults them, but keep the
# WORLD convention so a reconstructed model can also drive alignment
_DEFAULT_WEIGHTS = {"bap": 0.0}


@dataclasses.dataclass
class VoiceMeta:
    fs: int
    frame_period_samples: int
    n_states: int
    stream_order: Tuple[str, ...]
    alpha: float = 0.0           # OPTION[MGC]:ALPHA=... if present
    n_win: Dict[str, int] = dataclasses.field(default_factory=dict)
    windows: Dict[str, tuple] = dataclasses.field(default_factory=dict)


def model_from_voice(loaded) -> Tuple[cc.ClusteredModel,
                                      Optional[GVModel], VoiceMeta]:
    """Rebuild (ClusteredModel, GVModel, VoiceMeta) from
    voice.load_htsvoice output.  Stream column slices follow the
    container's stream order with each stream spanning
    static_dim * n_windows columns (the cmp layout the trees were
    trained on, configure.ac:671-678)."""
    hdr = loaded["global"]
    order = tuple(
        {v: k for k, v in voice.STREAM_NAMES.items()}.get(t, t.lower())
        for t in hdr["STREAM_TYPE"].split(","))
    n_states = int(hdr["NUM_STATES"])

    streams = []
    trees: Dict[str, list] = {}
    msd_weights: Dict[str, list] = {}
    n_win: Dict[str, int] = {}
    windows: Dict[str, tuple] = {}
    o = 0
    for name in order:
        st = loaded["streams"][name]
        w = len(st["windows"]) or 1
        dim = st["static_dim"] * w
        streams.append(hsmm.StreamDef(
            name, slice(o, o + dim), st["is_msd"], o,
            _DEFAULT_WEIGHTS.get(name, 1.0)))
        trees[name] = st["trees"]
        msd_weights[name] = st["msd_weights"]
        n_win[name] = w
        windows[name] = tuple(st["windows"])
        o += dim

    model = cc.ClusteredModel(
        streams=tuple(streams), n_states=n_states, trees=trees,
        dur_tree=loaded["duration"][0], msd_weights=msd_weights)

    gv_trees = {name: loaded["streams"][name]["gv_tree"]
                for name in order
                if loaded["streams"][name].get("gv_tree") is not None}
    gv = GVModel(gv_trees) if gv_trees else None

    alpha = 0.0
    opt = hdr.get("OPTION[MGC]", "")
    for kv in opt.split(","):
        if kv.startswith("ALPHA="):
            alpha = float(kv[6:])

    meta = VoiceMeta(
        fs=int(hdr["SAMPLING_FREQUENCY"]),
        frame_period_samples=int(hdr["FRAME_PERIOD"]),
        n_states=n_states, stream_order=order, alpha=alpha,
        n_win=n_win, windows=windows)
    return model, gv, meta


def load_voice(path: str):
    """path -> (ClusteredModel, GVModel | None, VoiceMeta)."""
    return model_from_voice(voice.load_htsvoice(path))


def synthesize(path_or_model, label_seq: Sequence[str],
               gen_cfg: Optional[pgen.GenConfig] = None,
               use_gv: bool = True, use_mspf=None,
               mspf_weight: float = 1.0, rho: float = 0.0,
               durs: Optional[np.ndarray] = None,
               fft_size: int = 0, frame_period: float = 0.0,
               noise=None, seed: int = 0, device="cuda"):
    """Label sequence -> waveform, straight from a voice file.

    path_or_model: a .htsvoice path or the (model, gv, meta) triple from
    load_voice.  Mirrors recipe.synthesize_utterance but consumes only
    what the container stores (the MSPF statistics are not part of the
    .htsvoice format, so pass `use_mspf=(nat, gen)` explicitly if
    desired).  Returns (waveform, statics, vuv, durs) as
    `recipe.synthesize_utterance` does; `noise` replaces the draw from
    `seed`."""
    if isinstance(path_or_model, str):
        model, gv, meta = load_voice(path_or_model)
    else:
        model, gv, meta = path_or_model
    fs = meta.fs
    fp = frame_period or meta.frame_period_samples * 1000.0 / fs
    n_win = meta.n_win.get("mgc", 3)
    if gen_cfg is None:
        gen_cfg = pgen.GenConfig(pgtype=0, rho=rho, n_win=n_win,
                                 use_gv=use_gv and gv is not None,
                                 alpha=meta.alpha or 0.42)
    statics, vuv, durs = pgen.generate_parameters(
        model, label_seq, gen_cfg, gv_model=gv, durs=durs,
        mspf=use_mspf, mspf_weight=mspf_weight, device=device)
    y = pgen.generate_waveform(statics, vuv, fs, fft_size, fp, noise=noise,
                               seed=seed, device=device)
    return y, statics, vuv, durs
