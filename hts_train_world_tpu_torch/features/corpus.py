"""Corpus file lists — equivalents of the data/Makefile.in label targets
(`mlf`, `list`, `scp`, data/Makefile.in:496-551; SURVEY.md F8).
The port's own copy of `hts_train_world_tpu/features/corpus.py`."""
from __future__ import annotations

import glob
import os
import re
from typing import List


def write_scp(cmp_dir: str, out_path: str) -> List[str]:
    """train.scp: absolute cmp paths (data/Makefile.in:538-543)."""
    paths = sorted(glob.glob(os.path.join(cmp_dir, "*.cmp")))
    with open(out_path, "w") as f:
        for p in paths:
            f.write(os.path.abspath(p) + "\n")
    return paths


def write_mlf(label_dir: str, out_path: str, kind: str = "full") -> None:
    """Master label file (data/Makefile.in:496-510)."""
    with open(out_path, "w") as f:
        f.write("#!MLF!#\n")
        f.write(f'"*/*.lab" -> "{os.path.abspath(label_dir)}"\n')


_PHONE_RE = re.compile(r"-(.+?)\+")


def model_list(full_label_dir: str, out_path: str) -> List[str]:
    """Unique full-context model names over the corpus
    (data/Makefile.in:512-529)."""
    names = set()
    for lab in sorted(glob.glob(os.path.join(full_label_dir, "*.lab"))):
        with open(lab) as f:
            for line in f:
                arr = line.split()
                if len(arr) >= 3:
                    names.add(arr[2])
    out = sorted(names)
    with open(out_path, "w") as f:
        f.write("\n".join(out) + "\n")
    return out


def mono_list(mono_label_dir: str, out_path: str) -> List[str]:
    names = set()
    for lab in sorted(glob.glob(os.path.join(mono_label_dir, "*.lab"))):
        with open(lab) as f:
            for line in f:
                arr = line.split()
                if len(arr) >= 3:
                    names.add(arr[2])
    out = sorted(names)
    with open(out_path, "w") as f:
        f.write("\n".join(out) + "\n")
    return out
