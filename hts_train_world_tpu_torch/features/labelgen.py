"""Label-making front end — equivalents of the reference's `lab` target
chain (data/Makefile.in:461-494): normtext.pl text normalization and the
label-full.awk / label-mono.awk formatters that turn a dumpfeats .feats
table (one 66-field row per segment, scripts/label.feats) into HTS
full-context / monophone label files.

The Festival steps between them (text2utt + dumpfeats) are external
binaries the reference merely invokes; this module covers everything the
reference SHIPS — given a .feats table from any front end, the label
files are reproduced byte-for-byte (gated vs awk/perl in tests).

The port's own copy of `hts_train_world_tpu/features/labelgen.py`.
"""
from __future__ import annotations

import re
from typing import List, Sequence

_WORD_RE = re.compile(r"['0-9a-zA-Z]+")


def normalize_text(text: str) -> str:
    """normtext.pl: tokenize to alphabet/digit words, classify the
    separator to the LEFT of each word (hyphen/period/space/comma/
    question), and re-emit a normalized sentence ending in '?' or '.'."""
    words: List[str] = []
    types: List[str] = []
    lefts: List[str] = []
    rest = text
    while True:
        m = _WORD_RE.search(rest)
        if not m:
            break
        w = m.group(0)
        sep = rest[:m.start()]
        t = "unknown"
        if re.fullmatch(r"[a-zA-Z]+", w):
            t = "alphabet"
        elif re.fullmatch(r"[0-9]+", w):
            t = "digit"
        if sep == "-":
            left = "hyphen"
        else:
            s = re.sub(r"\s", "", sep)
            if s == ".":
                left = "period"
            elif s == "":
                left = "space"
            elif s == ",":
                left = "comma"
            elif s == "?":
                left = "question"
            else:
                left = "question" if "?" in s else "unknown"
        words.append(w)
        types.append(t)
        lefts.append(left)
        rest = rest[m.end():]
    if not words:
        return ""
    question = "?" in rest
    out = [words[0]]
    for i in range(1, len(words)):
        if (types[i - 1] == "digit" and types[i] == "digit"
                and lefts[i] == "period"):
            out.append("." + words[i])
        elif lefts[i] == "hyphen":
            out.append("-" + words[i])
        elif lefts[i] == "space":
            out.append(" " + words[i])
        else:
            out.append(", " + words[i])
    return "".join(out) + ("?\n" if question else ".\n")


def _xx(v: str) -> str:
    return "xx" if v == "0" else v


def _plus1(v: str) -> str:
    return str(int(v) + 1)


def full_label_line(f: Sequence[str]) -> str:
    """label-full.awk body for ONE .feats row.  f is 1-indexed like awk
    ($1..$66); pass a list with a dummy at index 0."""
    pau = f[2] == "pau"

    def pxx(v):                      # "xx" when pau, else the value
        return "xx" if pau else v

    def pz(norm, alt):               # pau ? (alt==0?xx:alt2) pattern
        return alt if pau else norm

    def z(v):                        # ==0 -> xx
        return "xx" if v == "0" else v

    o = [f"{float(f[65]) * 1e7:10.0f} {float(f[66]) * 1e7:10.0f} "]
    o += [_xx(f[63]), "^", _xx(f[1]), "-", f[2], "+", _xx(f[3]),
          "=", _xx(f[64])]
    o += ["@", pxx(_plus1(f[4])) if not pau else "xx",
          "_", pxx(str(int(f[12]) - int(f[4]))) if not pau else "xx"]
    o += ["/A:", pz(f[5] if f[11] != "0" else "xx",
                    f[49] if f[53] != "0" else "xx"),
          "_", pz(f[8] if f[11] != "0" else "xx",
                  f[51] if f[53] != "0" else "xx"),
          "_", pz(z(f[11]), z(f[53]))]
    o += ["/B:", pxx(f[6]), "-", pxx(f[9]), "-", pxx(f[12]),
          "@", pxx(_plus1(f[14])) if not pau else "xx",
          "-", pxx(str(int(f[30]) - int(f[14]))) if not pau else "xx",
          "&", pxx(_plus1(f[15])) if not pau else "xx",
          "-", pxx(_plus1(f[16])) if not pau else "xx",
          "#", pxx(f[17]), "-", pxx(f[18]),
          "$", pxx(f[19]), "-", pxx(f[20]),
          "!", pxx(z(f[21])), "-", pxx(z(f[22])),
          ";", pxx(z(f[23])), "-", pxx(z(f[24])),
          "|", pxx(f[25])]
    o += ["/C:", pz(f[7] if f[13] != "0" else "xx",
                    f[50] if f[54] != "0" else "xx"),
          "+", pz(f[10] if f[13] != "0" else "xx",
                  f[52] if f[54] != "0" else "xx"),
          "+", pz(z(f[13]), z(f[54]))]
    o += ["/D:", pz(f[26] if f[29] != "0" else "xx",
                    f[55] if f[57] != "0" else "xx"),
          "_", pz(z(f[29]), z(f[57]))]
    o += ["/E:", pxx(f[27]), "+", pxx(f[30]),
          "@", pxx(_plus1(f[32])) if not pau else "xx",
          "+", pxx(f[33]),
          "&", pxx(f[34]), "+", pxx(f[35]),
          "#", pxx(z(f[36])), "+", pxx(z(f[37]))]
    o += ["/F:", pz(f[28] if f[31] != "0" else "xx",
                    f[56] if f[58] != "0" else "xx"),
          "_", pz(z(f[31]), z(f[58]))]
    o += ["/G:", pz(z(f[38]), z(f[59])), "_", pz(z(f[41]), z(f[61]))]
    o += ["/H:", pxx(f[39]), "=", pxx(f[42]),
          "^", pxx(_plus1(f[44])) if not pau else "xx",
          "=", pxx(str(int(f[48]) - int(f[44]))) if not pau else "xx",
          "|", pxx(f[45])]
    o += ["/I:", pz(z(f[40]), z(f[60])), "=", pz(z(f[43]), z(f[62]))]
    o += ["/J:", f[46], "+", f[47], "-", f[48]]
    return "".join(o)


def mono_label_line(f: Sequence[str]) -> str:
    """label-mono.awk: '<start> <end> <phone>'."""
    return f"{float(f[65]) * 1e7:10.0f} {float(f[66]) * 1e7:10.0f} {f[2]}"


def _rows(feats_text: str) -> List[List[str]]:
    rows = []
    for ln in feats_text.splitlines():
        parts = ln.split()
        if parts:
            rows.append([""] + parts)   # 1-indexed like awk
    return rows


def full_labels(feats_text: str) -> str:
    return "".join(full_label_line(r) + "\n" for r in _rows(feats_text))


def mono_labels(feats_text: str) -> str:
    return "".join(mono_label_line(r) + "\n" for r in _rows(feats_text))
