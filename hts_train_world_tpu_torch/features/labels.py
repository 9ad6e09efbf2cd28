"""HTS label file handling (mono + full-context) for the singing-synthesis
pipeline.  Times are in HTK 100 ns units on disk; Extract.py:76-77 converts
to ms (value / 1e4).

The port's own copy of `hts_train_world_tpu/features/labels.py`."""
from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Optional

_NOTE_RE = re.compile(r"/E:(\w+)\]")
_SCALE = ["C", "Db", "D", "Eb", "E", "F", "Gb", "G", "Ab", "A", "Bb", "B"]


@dataclasses.dataclass
class LabelSegment:
    start_ms: float
    end_ms: float
    phone: str
    context: str

    @property
    def note(self) -> Optional[str]:
        m = _NOTE_RE.search(self.context)
        if not m or m.group(1) == "xx":
            return None
        return m.group(1)

    def note_hz(self) -> float:
        """getNotePitch (Extract.py:108-113): equal temperament, A4=440.
        Unparseable note names yield 0 (the reference raises)."""
        note = self.note
        if note is None:
            return 0.0
        try:
            scale = _SCALE.index(note[:-1]) - 9
            octave = int(note[-1]) - 4
        except (ValueError, IndexError):
            return 0.0
        return 440.0 * (2.0 ** octave) * (2.0 ** (scale / 12.0))


def load_labels(mono_path: str, full_path: str) -> List[LabelSegment]:
    """loadLabel (Extract.py:60-81): parallel mono/full files, times/1e4."""
    with open(mono_path) as f:
        mono = [ln.split() for ln in f.read().splitlines() if ln]
    with open(full_path) as f:
        full = [ln.split() for ln in f.read().splitlines() if ln]
    if len(mono) != len(full):
        raise ValueError("mono label not equal with full label")
    out = []
    for m, fl in zip(mono, full):
        out.append(LabelSegment(float(m[0]) / 1e4, float(m[1]) / 1e4,
                                m[2], fl[2]))
    return out


def make_mono_from_full(full_path: str, mono_path: str,
                        phone_re=re.compile(r"-(.+?)\+")) -> None:
    """Derive a monophone label file from a full-context one."""
    with open(full_path) as f:
        lines = [ln.split() for ln in f.read().splitlines() if ln]
    with open(mono_path, "w") as f:
        for ln in lines:
            m = phone_re.search(ln[2])
            f.write(f"{ln[0]} {ln[1]} {m.group(1) if m else ln[2]}\n")


def segment_frames(seg: LabelSegment, frame_period_ms: float, n_frames: int):
    """Frame range [start, end) of a segment (Extract.py:177-178)."""
    start = max(math.floor(seg.start_ms / frame_period_ms), 0)
    end = min(math.floor(seg.end_ms / frame_period_ms), n_frames)
    return start, end


# ---------------------------------------------------------------------------
# state-level alignment labels — the HMM -> DNN bridge
# (convert_dur2lab / convert_state2phone, Training.pl:1604-1674)
# ---------------------------------------------------------------------------


def state_alignment_lines(ctx_seq, state_ends, n_states: int,
                          shift_100ns: int) -> str:
    """State-aligned full-context label text from FALGN boundaries (or
    generated durations): per chain state k of label i, a line

        <start> <end> <ctx>[<k+2>][ <ctx> on the first state]

    — the exact format convert_dur2lab writes (Training.pl:1637-1668;
    state indices are HTK-numbered 2..nState+1, and the bare model name
    rides on the first state's line).  state_ends: (n_labels*S,)
    exclusive frame ends."""
    lines = []
    start = 0
    for li, ctx in enumerate(ctx_seq):
        for s in range(n_states):
            end = int(state_ends[li * n_states + s])
            a, b = start * shift_100ns, end * shift_100ns
            tail = f" {ctx}" if s == 0 else ""
            lines.append(f"{a} {b} {ctx}[{s + 2}]{tail}")
            start = end
    return "\n".join(lines) + "\n"


def durations_to_state_lines(ctx_seq, durs, n_states: int,
                             shift_100ns: int) -> str:
    """convert_dur2lab from HMGenS durations: durs (n_labels*S,)."""
    import numpy as np
    return state_alignment_lines(ctx_seq, np.cumsum(np.asarray(durs)),
                                 n_states, shift_100ns)


def phone_alignment_lines(ctx_seq, state_ends, n_states: int,
                          shift_100ns: int,
                          phone_re=re.compile(r"^.+?-(.+?)\+")) -> str:
    """convert_state2phone (Training.pl:1604-1635): one line per label,
    '<start> <end> <phone>' spanning its first..last state."""
    lines = []
    start = 0
    for li, ctx in enumerate(ctx_seq):
        end = int(state_ends[(li + 1) * n_states - 1])
        m = phone_re.search(ctx)
        phone = m.group(1) if m else ctx
        lines.append(f"{start * shift_100ns} {end * shift_100ns} {phone}")
        start = end
    return "\n".join(lines) + "\n"
