"""Context-dependent GV (global variance) models — make_data_gv +
MCDGV clustering (Training.pl:1402-1491, 620-685).

Reference flow: per utterance, concatenate the non-silence frames of
each stream's statics (MSD streams additionally drop absent frames),
take the per-dimension variance (SPTK `vstat -d -o 2`) — ONE observation
vector per utterance per stream — label it with the utterance's FIRST
full-context label (Training.pl:1462-1469), then train context-dependent
single-state GV models clustered by the usual questions ($cdgv;
plain pooled 'gv' model otherwise).  The pdfs export into the voice's
GV section (models/voice.py use_gv) and drive generation-time GV
(ops/gv.gv_scale / gv_refine).

The port's own copy of `hts_train_world_tpu/models/gv_model.py` (host code
over the port's `clustering`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hts_train_world_tpu_torch.models import clustering


def utterance_gv(statics: np.ndarray, keep: Optional[np.ndarray] = None):
    """Per-dimension variance of one utterance's static features.

    statics: (T, D); keep: optional boolean (T,) mask (non-silence and,
    for MSD streams, present frames).  Returns (D,) or None when fewer
    than 2 frames survive (the reference's NaN screen drops those
    utterances, Training.pl:1455-1459)."""
    x = statics if keep is None else statics[keep]
    if len(x) < 2:
        return None
    return np.var(x, axis=0)


def collect_gv_stats(observations: Sequence[Tuple[str, np.ndarray]]):
    """{first_full_context: SuffStats over per-utterance GV vectors}."""
    out: Dict[str, clustering.SuffStats] = {}
    for ctx, v in observations:
        if v is None:
            continue
        ss = clustering.SuffStats(1.0, np.asarray(v, float),
                                  np.asarray(v, float) ** 2)
        out[ctx] = out[ctx] + ss if ctx in out else ss
    return out


@dataclasses.dataclass
class GVModel:
    """Per-stream context-dependent GV pdfs (single-state)."""
    trees: Dict[str, clustering.Tree]
    context_dependent: bool = True

    def params(self, stream: str, context: str = "gv"):
        tree = self.trees[stream]
        leaf = tree.leaf_of(context) if self.context_dependent else 0
        mean, var = tree.leaf_params[leaf]
        return mean, var


def build_gv_model(stats_by_stream: Dict[str, Dict[str, clustering.SuffStats]],
                   questions, mdl_factor: float = 1.0,
                   min_occupancy: float = 1.0,
                   context_dependent: bool = True) -> GVModel:
    """MCDGV: cluster per-utterance GV observations per stream ($cdgv);
    context_dependent=False pools everything into one leaf (the
    reference's `echo gv > lst` branch, Training.pl:1482-1484)."""
    trees = {}
    for name, stats in stats_by_stream.items():
        qs = questions if context_dependent else []
        trees[name] = clustering.cluster_states(
            stats, qs, mdl_factor, min_occupancy)
    return GVModel(trees, context_dependent)


def silence_keep_mask(phone_seq: Sequence[str], phone_ends: np.ndarray,
                      silence_phones: Sequence[str], n_frames: int):
    """Non-silence frame mask from a phone alignment ($nosilgv/@slnt,
    Training.pl:1422-1439): phone_ends are exclusive end frames."""
    keep = np.ones(n_frames, bool)
    sil = set(silence_phones)
    start = 0
    for p, e in zip(phone_seq, phone_ends):
        if p in sil:
            keep[start:e] = False
        start = e
    return keep


def gv_observations(utterances):
    """Builder: utterances is a list of (first_full_context,
    {stream: (T, D) statics}, {stream: (T,) keep mask or None}).
    Returns {stream: {context: SuffStats}} for build_gv_model."""
    obs: Dict[str, List] = {}
    for ctx, statics, keeps in utterances:
        for name, x in statics.items():
            keep = keeps.get(name) if keeps else None
            obs.setdefault(name, []).append((ctx, utterance_gv(x, keep)))
    return {name: collect_gv_stats(o) for name, o in obs.items()}
