"""Stage tracking of the corpus pipeline: the port's own copy of the
`StageManifest` of `hts_train_world_tpu/runtime/checkpoint.py`.

Pipeline stages persist a tiny JSON manifest so a killed run resumes at
the first unfinished stage (the Training.pl stage-switch analogue).  The
model checkpointer comes with the DNN stages (ROADMAP Queue A 4).
"""
from __future__ import annotations

import json
import os


class StageManifest:
    """Idempotent stage tracking (the Config.pm stage switches)."""

    def __init__(self, workdir: str):
        self.path = os.path.join(workdir, "stages.json")
        os.makedirs(workdir, exist_ok=True)
        self._data = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                self._data = json.load(f)

    def done(self, stage: str) -> bool:
        return self._data.get(stage, {}).get("done", False)

    def mark(self, stage: str, **info) -> None:
        self._data[stage] = {"done": True, **info}
        with open(self.path, "w") as f:
            json.dump(self._data, f, indent=1)

    def reset_from(self, stage: str, order) -> None:
        """Invalidate `stage` and everything after it."""
        idx = order.index(stage)
        for s in order[idx:]:
            self._data.pop(s, None)
        with open(self.path, "w") as f:
            json.dump(self._data, f, indent=1)
