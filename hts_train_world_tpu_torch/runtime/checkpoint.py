"""Checkpoint/resume and stage tracking: the port's counterpart of
`hts_train_world_tpu/runtime/checkpoint.py` (the tf.train.Saver +
stage-switch equivalent, DNNTraining.py:314-321, Config.pm.in:240-242,
SURVEY.md §5).

`Checkpointer` keeps train states as `torch.save` files under
`<dir>/<step>/state.pt` with max_to_keep retention; pipeline stages
persist a tiny JSON manifest (`StageManifest`, a copy of the JAX
package's) so a killed run resumes at the first unfinished stage.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch


class Checkpointer:
    """Train-state checkpoints, one directory a step (max_to_keep,
    save_interval).  The JAX package keeps its checkpoints with orbax; the
    two packages' checkpoints are not interchangeable, and weights cross
    between them only as numpy trees (`models.acoustic.params_from_numpy`
    / `params_to_numpy`)."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def steps(self):
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit()
                      and os.path.exists(os.path.join(self._dir, n,
                                                      "state.pt")))

    def save(self, step: int, state: Any) -> None:
        """Write `state` (tensors, dicts, numbers) for `step` and drop the
        oldest steps past max_to_keep."""
        d = os.path.join(self._dir, str(step))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, "state.pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(d, "state.pt"))
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The state saved at `step` (default the latest), or None when
        the directory holds no step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        if map_location is not None:        # torch.load knows "cpu" alone
            dev = torch.device(map_location)
            map_location = "cpu" if dev.type == "cpu" else dev
        return torch.load(os.path.join(self._dir, str(step), "state.pt"),
                          map_location=map_location, weights_only=True)


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
