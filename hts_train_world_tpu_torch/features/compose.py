"""The WORLD cmp layout (mgc-win | lf0-win | bap-win | vib-win).

Counterpart of the `StreamLayout` dataclass of
`hts_train_world_tpu/features/compose.py` (configure.ac:575-585,
data/Makefile.in:276-320): only the layout and its column slices, which
`models.hsmm.world_streams` needs; the cmp/ffo composition is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamLayout:
    mgc_dim: int = 50
    lf0_dim: int = 2
    bap_dim: int = 25
    vib_dim: int = 2
    n_win: int = 3

    @property
    def cmp_dim(self):
        return self.n_win * (self.mgc_dim + self.lf0_dim + self.bap_dim
                             + self.vib_dim)

    def cmp_slices(self):
        w = self.n_win
        sizes = [w * self.mgc_dim, w * self.lf0_dim, w * self.bap_dim,
                 w * self.vib_dim]
        offs = np.cumsum([0] + sizes)
        return {k: slice(offs[i], offs[i + 1])
                for i, k in enumerate(["mgc", "lf0", "bap", "vib"])}
