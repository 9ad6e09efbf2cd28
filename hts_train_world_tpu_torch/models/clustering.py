"""MDL decision-tree state clustering — the HHEd TB equivalent
(Training.pl:496-532, make_edfile_state :2065-2092; SURVEY.md T3).

Greedy top-down splitting of context-dependent state distributions by
question-set patterns, maximizing the tied-Gaussian log-likelihood gain,
stopping on the MDL criterion (HTS -C 1 semantics):

  L(S) = -0.5 * Gamma_S * (D*(1 + log 2pi) + sum_d log sigma^2_d(S))
  split accepted iff  gain > 0.5 * mdl_factor * D * log(Gamma_root)

Sufficient statistics (occupancy, sum, sum-of-squares per context state)
come from the HSMM aligner; the tree search is host work, exactly as HHEd
runs on one node.

The port's own copy of `hts_train_world_tpu/models/clustering.py`: every
sum is taken in the same order, so trees and leaf parameters equal the JAX
package's bit for bit on the same statistics.  Two differences change no
number: `Question.matches` remembers its answer per context (a pure
function of the context, and most of the search's time), and each split
builds its set of yes-contexts once.  `Tree.to_plain` / `tree_from_plain`
carry a tree across as plain tuples and numpy arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hts_train_world_tpu_torch.features import qconf as qconf_mod


@dataclasses.dataclass
class SuffStats:
    gamma: float
    s1: np.ndarray
    s2: np.ndarray

    def __add__(self, o: "SuffStats") -> "SuffStats":
        return SuffStats(self.gamma + o.gamma, self.s1 + o.s1,
                         self.s2 + o.s2)

    @staticmethod
    def from_frames(x: np.ndarray) -> "SuffStats":
        return SuffStats(float(len(x)), x.sum(0), (x * x).sum(0))

    @property
    def mean(self):
        return self.s1 / max(self.gamma, 1e-10)

    def var(self, floor):
        v = self.s2 / max(self.gamma, 1e-10) - self.mean ** 2
        return np.maximum(v, floor)


def _loglik(stats: SuffStats, floor) -> float:
    if stats.gamma <= 0:
        return 0.0
    D = len(stats.s1)
    return -0.5 * stats.gamma * (
        D * (1.0 + math.log(2.0 * math.pi))
        + float(np.sum(np.log(stats.var(floor)))))


@dataclasses.dataclass
class Question:
    name: str
    patterns: List[str]

    def __post_init__(self):
        self._res = [qconf_mod._patt_to_regex(p) for p in self.patterns]
        self._memo: Dict[str, bool] = {}

    def matches(self, context: str) -> bool:
        hit = self._memo.get(context)
        if hit is None:
            hit = self._memo[context] = any(r.match(context)
                                            for r in self._res)
        return hit


def questions_from_config(feats) -> List[Question]:
    """Build Question objects from the same config makequestion.pl uses."""
    out = []
    for line in qconf_mod.make_questions(feats):
        # QS "name" {p1,p2,...}
        name = line.split('"')[1]
        patts = line[line.index("{") + 1:line.rindex("}")].split(",")
        out.append(Question(name, patts))
    return out


@dataclasses.dataclass
class Node:
    question: Optional[Question] = None
    yes: Optional["Node"] = None
    no: Optional["Node"] = None
    leaf_id: int = -1


@dataclasses.dataclass
class Tree:
    root: Node
    leaf_params: List[Tuple[np.ndarray, np.ndarray]]  # (mean, var) per leaf

    def leaf_of(self, context: str) -> int:
        n = self.root
        while n.question is not None:
            n = n.yes if n.question.matches(context) else n.no
        return n.leaf_id

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_params)

    def to_plain(self):
        """(structure, leaf params): the structure a nested tuple of
        (question name, patterns, yes, no) or ("leaf", leaf_id), the leaf
        params a list of (mean, var) float64 numpy copies.  Reads only
        `root` and `leaf_params`, so it also takes a JAX package tree."""
        def walk(n):
            if n.question is None:
                return ("leaf", int(n.leaf_id))
            return (n.question.name, tuple(n.question.patterns),
                    walk(n.yes), walk(n.no))
        return walk(self.root), [(np.array(m, dtype=np.float64),
                                  np.array(v, dtype=np.float64))
                                 for m, v in self.leaf_params]


def tree_from_plain(structure, leaf_params) -> Tree:
    """The port's Tree from `Tree.to_plain`'s pair (one Question object
    per question name)."""
    qs: Dict[str, Question] = {}

    def build(n):
        if n[0] == "leaf" and len(n) == 2:
            return Node(leaf_id=int(n[1]))
        name, patts, yes, no = n
        q = qs.setdefault(name, Question(name, list(patts)))
        return Node(question=q, yes=build(yes), no=build(no))
    return Tree(build(structure), [(np.array(m, dtype=np.float64),
                                    np.array(v, dtype=np.float64))
                                   for m, v in leaf_params])


def _bern_loglik(m: SuffStats) -> float:
    """Bernoulli (MSD space-weight) log-likelihood of pooled V/UV counts:
    m.gamma = frames, m.s1[0] = voiced frames."""
    n = m.gamma
    if n <= 0:
        return 0.0
    v = float(np.clip(m.s1[0], 1e-3, n - 1e-3))
    p = v / n
    return v * math.log(p) + (n - v) * math.log(1.0 - p)


def cluster_states(stats_by_context: Dict[str, SuffStats],
                   questions: Sequence[Question],
                   mdl_factor: float = 1.0, min_occupancy: float = 1.0,
                   var_floor: float = 1e-8,
                   msd_by_context: Dict[str, SuffStats] = None,
                   dim: int = 0) -> Tree:
    """Build one tree for one (stream, state) position.

    For MSD streams pass `msd_by_context` (gamma = total frames,
    s1[0] = voiced frames per context): the split criterion then adds
    the Bernoulli space-weight likelihood — HTS's MSD MDL clusters on
    both the voiced Gaussian and the discrete V/UV weight, which is
    what separates voiced from unvoiced contexts whose voiced-frame
    Gaussians carry no signal — and the context set is the union (a
    fully-unvoiced context has no Gaussian stats but must still get its
    own leaf)."""
    if msd_by_context is not None:
        contexts = sorted(set(stats_by_context) | set(msd_by_context))
    else:
        contexts = list(stats_by_context)
    some = next(iter(stats_by_context.values()), None)
    # dim: the stream width, for streams with NO Gaussian stats at all
    # (e.g. an MSD stream that never saw a present frame) — the leaves
    # must still carry correctly-shaped pdfs
    D = len(some.s1) if some is not None else max(dim, 1)
    zero = SuffStats(0.0, np.zeros(D), np.zeros(D))
    mzero = SuffStats(0.0, np.zeros(1), np.zeros(1))

    def g(c):
        return stats_by_context.get(c, zero)

    def m(c):
        return msd_by_context.get(c, mzero) if msd_by_context is not None \
            else mzero

    total = zero
    mtotal = mzero
    for c in contexts:
        total = total + g(c)
        mtotal = mtotal + m(c)
    n_dims = D + (1 if msd_by_context is not None else 0)
    occ_total = mtotal.gamma if msd_by_context is not None else total.gamma
    threshold = 0.5 * mdl_factor * n_dims * math.log(max(occ_total, 2.0))

    leaf_params: List[Tuple[np.ndarray, np.ndarray]] = []

    def node_ll(stats, mstats):
        ll = _loglik(stats, var_floor)
        if msd_by_context is not None:
            ll += _bern_loglik(mstats)
        return ll

    def build(ctxs: List[str], stats: SuffStats, mstats: SuffStats) -> Node:
        base_ll = node_ll(stats, mstats)
        best = None
        for q in questions:
            yes = [c for c in ctxs if q.matches(c)]
            if not yes or len(yes) == len(ctxs):
                continue
            sy, my = zero, mzero
            for c in yes:
                sy = sy + g(c)
                my = my + m(c)
            sn = SuffStats(stats.gamma - sy.gamma, stats.s1 - sy.s1,
                           stats.s2 - sy.s2)
            mn = SuffStats(mstats.gamma - my.gamma, mstats.s1 - my.s1,
                           mstats.s2 - my.s2)
            occ_y = my.gamma if msd_by_context is not None else sy.gamma
            occ_n = mn.gamma if msd_by_context is not None else sn.gamma
            if occ_y < min_occupancy or occ_n < min_occupancy:
                continue
            gain = (node_ll(sy, my) + node_ll(sn, mn) - base_ll)
            if best is None or gain > best[0]:
                best = (gain, q, yes, sy, sn, my, mn)
        if best is None or best[0] <= threshold:
            node = Node(leaf_id=len(leaf_params))
            leaf_params.append((stats.mean, stats.var(var_floor)))
            return node
        gain, q, yes, sy, sn, my, mn = best
        yes_set = set(yes)
        no = [c for c in ctxs if c not in yes_set]
        return Node(question=q, yes=build(yes, sy, my),
                    no=build(no, sn, mn))

    root = build(contexts, total, mtotal)
    return Tree(root, leaf_params)


def tree_to_hts_text(tree: Tree, name: str, state: int) -> str:
    """Serialize in the HTS tree-*.inf style for voice export
    (make_edfile_convert / .htsvoice packaging, Training.pl:2194-2208)."""
    lines = []
    counter = [0]
    ids = {}

    def walk(n: Node) -> str:
        if n.question is None:
            return f'"{name}_s{state}_{n.leaf_id + 1}"'
        my = counter[0]
        counter[0] += 1
        ids[id(n)] = my
        yes_ref = walk(n.yes)
        no_ref = walk(n.no)
        lines.append(f' {-my} "{n.question.name}" {no_ref} {yes_ref}')
        return str(-my)

    if tree.root.question is None:
        return (f"{{*}}[{state + 2}]\n"
                f'   "{name}_s{state}_1"\n')
    root_ref = walk(tree.root)
    # HHEd prints nodes root-first; ours accumulated leaves-first
    body = "\n".join(reversed(lines))
    return f"{{*}}[{state + 2}] {{\n{body}\n}}\n"
