"""Question-set config, HHEd question generation, and label-to-DNN-input
encoding — equivalents of data/scripts/makequestion.pl (SURVEY.md F9) and
data/scripts/makefeature.pl (F10).

A config line is one feature:
  name {patt}                      -> binary   (HTS wildcard pattern list)
  name {patt-with-%d} MIN=a MAX=b -> float    (numeric field, minmax-norm)
  <reserved name> MIN=a MAX=b     -> reserved (positional, frame-level)

Pattern semantics follow the perl exactly: '*'->'.*', '?'->'.?', and
+|^$[] are escaped (makefeature.pl:459-500); floats capture the first %d
as [+-]?[0-9]+.

The port's own copy of `hts_train_world_tpu/features/qconf.py` (host code).
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

import numpy as np

RESERVED = ("Pos_C-State_in_Phone(Fw)", "Pos_C-State_in_Phone(Bw)",
            "Pos_C-Frame_in_State(Fw)", "Pos_C-Frame_in_State(Bw)",
            "Pos_C-Frame_in_Phone(Fw)", "Pos_C-Frame_in_Phone(Bw)")


@dataclasses.dataclass
class Feature:
    name: str
    type: str                 # reserved | float | binary
    patt: str = ""
    min: Optional[int] = None
    max: Optional[int] = None


def _patt_to_regex(patt: str, capture_digit: bool = False) -> re.Pattern:
    p = patt
    p = p.replace("*", ".*").replace("?", ".?")
    for ch in "+|^$[]":
        p = p.replace(ch, "\\" + ch)
    if capture_digit:
        p = p.replace("%d", r"([+-]?[0-9]+)")
    return re.compile("^" + p + "$")


def parse_config(text: str) -> List[Feature]:
    """makefeature.pl:63-178 config parser."""
    feats = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        arr = line.split()
        name = arr[0]
        if name in RESERVED:
            ftype, patt = "reserved", ""
        elif len(arr) > 1 and "%d" in arr[1]:
            ftype = "float"
            patt = arr[1][1:-1]
        else:
            ftype = "binary"
            patt = arr[1][1:-1] if len(arr) > 1 else ""
        mn = mx = None
        for tok in arr[1:]:
            if tok.startswith("MIN="):
                mn = int(tok[4:])
            elif tok.startswith("MAX="):
                mx = int(tok[4:])
        feats.append(Feature(name, ftype, patt, mn, mx))
    return feats


def num_features(feats: List[Feature]) -> int:
    return len(feats)


# ---------------------------------------------------------------------------
# makequestion.pl — HHEd QS question emission
# ---------------------------------------------------------------------------


def _get_patt(start: int, end: int) -> List[str]:
    """Decimal wildcard covering of [start, end] (makequestion.pl:215-274)."""
    if start > end:
        raise ValueError("cannot make patterns")
    if start < 0 and end < 0:
        return ["-" + p for p in reversed(_get_patt(-end, -start))]
    if start < 0 <= end:
        neg = ["-" + p for p in reversed(_get_patt(0, -start)) if p != "0"]
        return neg + _get_patt(0, end)
    arr: List[str] = []
    remain: List[str] = []
    last_start = last_end = -1
    for i in range(start, end + 1):
        if i % 10 == 0:
            last_start, last_end = i, -1
        elif i % 10 == 9:
            last_end = i
        if last_start >= 0 and last_end >= 0:
            arr.append(str(i)[:-1] + "?")
            remain = []
            last_start = last_end = -1
        elif last_start >= 0:
            remain.append(str(i))
        else:
            arr.append(str(i))
    return arr + remain


def make_questions(feats: List[Feature]) -> List[str]:
    """makequestion.pl:173-210 — HHEd QS lines for tree clustering."""
    out = []
    for f in feats:
        if f.type == "reserved":
            continue
        if f.type == "binary":
            out.append(f'QS "{f.name}" {{{f.patt}}}')
        else:
            out.append(f'QS "{f.name}==xx" {{{f.patt.replace("%d", "xx")}}}')
            for j in range(f.min, f.max + 1):
                out.append(
                    f'QS "{f.name}=={j}" {{{f.patt.replace("%d", str(j))}}}')
            for j in range(f.min + 1, f.max):
                patt = ",".join(f.patt.replace("%d", p)
                                for p in _get_patt(f.min, j))
                out.append(f'QS "{f.name}<={j}" {{{patt}}}')
    return out


# ---------------------------------------------------------------------------
# makefeature.pl — label -> frame-level input features
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AlignedLabel:
    start: int          # frames
    end: int            # frames (exclusive)
    name: str           # context string without the state suffix
    state: int = 0      # 0 for phoneme-level


def parse_aligned_labels(text: str, frame_shift: float) -> List[AlignedLabel]:
    """makefeature.pl:194-289: '<start> <end> <context>[state]' lines with
    times in 100 ns; start/end = int(0.5 + t/frame_shift)."""
    out = []
    for line in text.splitlines():
        arr = line.split()
        if len(arr) < 3:
            continue
        start = int(0.5 + float(arr[0]) / frame_shift)
        end = int(0.5 + float(arr[1]) / frame_shift)
        s = arr[2]
        state = 0
        li, ri = s.rfind("["), s.rfind("]")
        if 0 < li < ri:
            try:
                st = int(s[li + 1:ri])
                if st >= 2:
                    state = st
                    s = s[:li]
            except ValueError:
                pass
        out.append(AlignedLabel(start, end, s, state))
    return out


def _norm(value: float, mn: float, mx: float) -> float:
    if value < mn:
        return 0.0
    if value > mx:
        return 1.0
    return (value - mn) / (mx - mn)


def encode_labels(feats: List[Feature],
                  labels: List[AlignedLabel]) -> np.ndarray:
    """makefeature.pl:322-441 -> (total_frames, n_features) float32."""
    state_level = any(lb.state for lb in labels)
    n = len(labels)
    # phoneme span per line (makefeature.pl:294-319)
    ph_start = list(range(n))
    ph_end = list(range(n))
    if state_level:
        for i in range(n):
            s = e = i
            while s != 0 and labels[s - 1].state < labels[s].state:
                s -= 1
            while e != n - 1 and labels[e].state < labels[e + 1].state:
                e += 1
            ph_start[i], ph_end[i] = s, e

    bin_res = [(_patt_to_regex(f.patt) if f.type == "binary" else
                _patt_to_regex(f.patt, True) if f.type == "float" else None)
               for f in feats]

    rows = []
    for i, lb in enumerate(labels):
        static = np.zeros(len(feats), np.float64)
        for k, f in enumerate(feats):
            if f.type == "binary":
                static[k] = float(any(
                    _patt_to_regex(p).match(lb.name)
                    for p in f.patt.split(",")))
            elif f.type == "float":
                m = bin_res[k].match(lb.name)
                static[k] = _norm(int(m.group(1)), f.min, f.max) if m else 0.0
        for j in range(lb.start, lb.end):
            row = static.copy()
            for k, f in enumerate(feats):
                if f.type != "reserved":
                    continue
                nm = f.name
                if nm == "Pos_C-State_in_Phone(Fw)":
                    v = lb.state if state_level else f.min
                elif nm == "Pos_C-State_in_Phone(Bw)":
                    v = (f.max - lb.state + f.min) if state_level else f.min
                elif nm == "Pos_C-Frame_in_State(Fw)":
                    v = (1 + j - lb.start) if state_level else f.min
                elif nm == "Pos_C-Frame_in_State(Bw)":
                    v = (lb.end - j) if state_level else f.min
                elif nm == "Pos_C-Frame_in_Phone(Fw)":
                    v = 1 + j - labels[ph_start[i]].start
                elif nm == "Pos_C-Frame_in_Phone(Bw)":
                    v = labels[ph_end[i]].end - j
                else:
                    raise ValueError(nm)
                row[k] = _norm(v, f.min, f.max)
            rows.append(row)
    return np.asarray(rows, np.float32) if rows else \
        np.zeros((0, len(feats)), np.float32)
