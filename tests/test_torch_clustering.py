"""The port's host modules of the tied-model recipe (features/qconf.py,
models/clustering.py, models/gv_model.py, models/voice.py) against the JAX
package's, on the CPU.

These are pure numpy / `re` / `struct` code that the port keeps its own
copy of; on the same inputs they must give the same strings, the same
trees (as `Tree.to_plain`), bit-equal leaf parameters and byte-equal
`.htsvoice` files.
"""
import numpy as np
import pytest

from hts_train_world_tpu.features import qconf as jqconf
from hts_train_world_tpu.models import clustering as jclustering
from hts_train_world_tpu.models import context_clustered as jcc
from hts_train_world_tpu.models import gv_model as jgv
from hts_train_world_tpu.models import hsmm as jhsmm
from hts_train_world_tpu.models import voice as jvoice
from hts_train_world_tpu_torch.features import qconf
from hts_train_world_tpu_torch.models import clustering, gv_model, voice
from hts_train_world_tpu_torch.models import context_clustered as cc

PHONES = ("sil", "a", "i", "k", "s", "n")

CONFIG = "\n".join(
    [f"L-Phone_{p} {{*^{p}-*}}" for p in PHONES]
    + [f"C-Phone_{p} {{*-{p}+*}}" for p in PHONES]
    + [f"R-Phone_{p} {{*+{p}=*}}" for p in PHONES]
    + ["C-Vowel {*-a+*,*-i+*}",
       "C-Note {*/E:%d]*} MIN=0 MAX=11",
       "C-Pos {*@%d_*} MIN=1 MAX=24",
       "Pos_C-State_in_Phone(Fw) MIN=2 MAX=6",
       "Pos_C-Frame_in_State(Fw) MIN=1 MAX=20",
       "Pos_C-Frame_in_Phone(Bw) MIN=1 MAX=100",
       "# a comment", ""])


def _context(rng):
    l, c, r = (PHONES[i] for i in rng.integers(0, len(PHONES), 3))
    return (f"{l}^{l}-{c}+{r}={r}@{int(rng.integers(1, 25))}_x/E:"
            f"{int(rng.integers(0, 12))}]")


def _contexts(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        c = _context(rng)
        if c not in out:
            out.append(c)
    return out


def _questions():
    return (jclustering.questions_from_config(jqconf.parse_config(CONFIG)),
            clustering.questions_from_config(qconf.parse_config(CONFIG)))


def _stats(kind, contexts, seed=1, D=5):
    """Per-context statistics whose means depend on the central phone and
    the note; for "msd" also voiced/total counts (some contexts fully
    unvoiced), for "dim" only the counts (no Gaussian statistics)."""
    rng = np.random.default_rng(seed)
    ss, ms = {}, {}
    for c in contexts:
        ph = c.split("-")[1].split("+")[0]
        note = int(c.split("/E:")[1][:-1])
        mu = 2.0 * PHONES.index(ph) + 0.3 * note
        n = int(rng.integers(3, 40))
        voiced = 0 if ph in ("k", "s") else int(rng.integers(1, n + 1))
        if kind == "plain" or (kind == "msd" and voiced):
            x = mu + rng.standard_normal((voiced if kind == "msd" else n, D))
            ss[c] = (float(len(x)), x.sum(0), (x * x).sum(0))
        ms[c] = (float(n), np.array([float(voiced)]),
                 np.array([float(voiced)]))
    return ss, (ms if kind != "plain" else None)


def _both(mod_pair, d):
    """{context: (gamma, s1, s2)} as each package's SuffStats."""
    if d is None:
        return None, None
    return tuple({c: m.SuffStats(g, s1.copy(), s2.copy())
                  for c, (g, s1, s2) in d.items()} for m in mod_pair)


def test_parse_config_and_questions_match_jax():
    jf, pf = jqconf.parse_config(CONFIG), qconf.parse_config(CONFIG)
    assert [vars(f) for f in jf] == [vars(f) for f in pf]
    assert qconf.num_features(pf) == jqconf.num_features(jf)
    assert qconf.make_questions(pf) == jqconf.make_questions(jf)
    jq, pq = _questions()
    assert [(q.name, q.patterns) for q in jq] == \
        [(q.name, q.patterns) for q in pq]
    for p in ("*-a+*", "*/E:1?]*", "a^b-*", "*|$[x]+?", "-1?", "*@%d_*"):
        assert qconf._patt_to_regex(p).pattern == \
            jqconf._patt_to_regex(p).pattern
        assert qconf._patt_to_regex(p, True).pattern == \
            jqconf._patt_to_regex(p, True).pattern


def test_question_matches_and_memo_agree_with_jax():
    jq, pq = _questions()
    ctxs = _contexts(60, seed=3)
    for a, b in zip(jq, pq):
        want = [a.matches(c) for c in ctxs]
        assert [b.matches(c) for c in ctxs] == want
        assert [b.matches(c) for c in ctxs] == want       # memoised


def test_aligned_labels_and_encode_match_jax():
    feats_j, feats_p = jqconf.parse_config(CONFIG), qconf.parse_config(CONFIG)
    ctxs = _contexts(5, seed=4)
    lines = []
    t = 0
    for c in ctxs:
        for st in range(2, 7):
            lines.append(f"{t * 50000} {(t + 3) * 50000} {c}[{st}]")
            t += 3
    text = "\n".join(lines)
    jl = jqconf.parse_aligned_labels(text, 50000.0)
    pl = qconf.parse_aligned_labels(text, 50000.0)
    assert [vars(x) for x in jl] == [vars(x) for x in pl]
    a = jqconf.encode_labels(feats_j, jl)
    b = qconf.encode_labels(feats_p, pl)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["plain", "msd", "dim"])
def test_cluster_states_gives_the_jax_tree(kind):
    ctxs = _contexts(70, seed=5)
    ss, ms = _stats(kind, ctxs)
    jq, pq = _questions()
    js, ps = _both((jclustering, clustering), ss)
    jm, pm = _both((jclustering, clustering), ms)
    kw = dict(mdl_factor=0.5, min_occupancy=1.0, dim=5)
    jt = jclustering.cluster_states(js, jq, msd_by_context=jm, **kw)
    pt = clustering.cluster_states(ps, pq, msd_by_context=pm, **kw)
    (j_struct, j_leaves), (p_struct, p_leaves) = (
        clustering.Tree.to_plain(jt), pt.to_plain())
    assert p_struct == j_struct
    assert pt.n_leaves == jt.n_leaves >= (1 if kind == "dim" else 3)
    for (jmu, jva), (pmu, pva) in zip(j_leaves, p_leaves):
        assert np.array_equal(jmu, pmu) and np.array_equal(jva, pva)
    for c in ctxs:
        assert pt.leaf_of(c) == jt.leaf_of(c)
    for s in range(3):
        assert clustering.tree_to_hts_text(pt, "mgc", s) == \
            jclustering.tree_to_hts_text(jt, "mgc", s)


def test_tree_plain_round_trip():
    ctxs = _contexts(40, seed=6)
    ss, _ = _stats("plain", ctxs)
    _, pq = _questions()
    pt = clustering.cluster_states(_both((jclustering, clustering), ss)[1],
                                   pq, mdl_factor=0.5)
    back = clustering.tree_from_plain(*pt.to_plain())
    assert back.to_plain()[0] == pt.to_plain()[0]
    assert [back.leaf_of(c) for c in ctxs] == [pt.leaf_of(c) for c in ctxs]
    assert clustering.tree_to_hts_text(back, "lf0", 1) == \
        clustering.tree_to_hts_text(pt, "lf0", 1)


@pytest.mark.parametrize("cdgv", [True, False])
def test_gv_model_gives_the_jax_trees(cdgv):
    rng = np.random.default_rng(7)
    ctxs = _contexts(30, seed=8)
    obs = []
    for i in range(90):
        c = ctxs[i % len(ctxs)]
        T = int(rng.integers(20, 60))
        stat = {"mgc": rng.standard_normal((T, 4)) * (1 + i % 3),
                "lf0": rng.standard_normal((T, 1))}
        keep = {"mgc": rng.random(T) > 0.2,
                "lf0": rng.random(T) > (0.99 if i % 11 == 0 else 0.4)}
        obs.append((c if cdgv else "gv", stat, keep))
    js, ps = jgv.gv_observations(obs), gv_model.gv_observations(obs)
    jq, pq = _questions()
    jm = jgv.build_gv_model(js, jq, 0.5, 1.0, context_dependent=cdgv)
    pm = gv_model.build_gv_model(ps, pq, 0.5, 1.0, context_dependent=cdgv)
    assert set(pm.trees) == set(jm.trees)
    for n in jm.trees:
        (a, al), (b, bl) = (clustering.Tree.to_plain(jm.trees[n]),
                            pm.trees[n].to_plain())
        assert a == b
        assert all(np.array_equal(x, y) for p, q in zip(al, bl)
                   for x, y in zip(p, q))
        for c in ctxs:
            for x, y in zip(jm.params(n, c), pm.params(n, c)):
                assert np.array_equal(x, y)
    ends = np.array([3, 9, 12])
    keep = gv_model.silence_keep_mask(["sil", "a", "sil"], ends, ("sil",), 12)
    assert np.array_equal(keep, jgv.silence_keep_mask(
        ["sil", "a", "sil"], ends, ("sil",), 12))


def _jax_model():
    """A JAX ClusteredModel from numpy statistics over the tiny streams
    (mgc 4 | lf0 2 MSD | bap 2 | vib 2 MSD), 3 states."""
    sts = (jhsmm.StreamDef("mgc", slice(0, 4), False, 0, 1.0),
           jhsmm.StreamDef("lf0", slice(4, 6), True, 4, 1.0),
           jhsmm.StreamDef("bap", slice(6, 8), False, 6, 0.0),
           jhsmm.StreamDef("vib", slice(8, 10), True, 8, 1.0))
    ms = jhsmm.ModelSet(["a"], {}, {}, {}, np.zeros((1, 3)),
                        np.zeros((1, 3)), sts)
    ctxs = _contexts(40, seed=9)
    S = 3
    stream_stats = {st.name: [] for st in sts}
    msd_stats = {st.name: [] for st in sts if st.msd}
    for st in sts:
        for s in range(S):
            kind = "msd" if st.msd else "plain"
            ss, m = _stats(kind, ctxs, seed=10 + s, D=st.sl.stop - st.sl.start)
            stream_stats[st.name].append(
                {c: jclustering.SuffStats(*v) for c, v in ss.items()})
            if st.msd:
                msd_stats[st.name].append(
                    {c: jclustering.SuffStats(*v) for c, v in m.items()})
    rng = np.random.default_rng(11)
    dur_stats = {}
    for c in ctxs:
        d = rng.uniform(2, 9, S) + (c.split("-")[1][0] == "a") * 3
        dur_stats[c] = jclustering.SuffStats(2.0, 2 * d, 2 * d * d + 1.0)
    jq, _ = _questions()
    return jcc.build_clustered_model(ms, stream_stats, msd_stats, dur_stats,
                                     jq, mdl_factor=0.5), ctxs


def test_export_htsvoice_is_byte_equal_and_round_trips(tmp_path):
    jm, ctxs = _jax_model()
    pm = cc.clustered_from_plain(cc.ClusteredModel.to_plain(jm))
    assert cc.ClusteredModel.to_plain(jm)["trees"].keys() == pm.trees.keys()
    gv_obs = [(ctxs[i % 7], {"mgc": np.random.default_rng(i).standard_normal(
        (30, 4)) * (1 + i % 2)}, {}) for i in range(28)]
    jq, pq = _questions()
    jg = jgv.build_gv_model(jgv.gv_observations(gv_obs), jq, 0.5)
    pg = gv_model.GVModel({n: clustering.tree_from_plain(
        *clustering.Tree.to_plain(t)) for n, t in jg.trees.items()})
    dims = {"mgc": 4, "lf0": 2, "bap": 2, "vib": 2}
    a, b = tmp_path / "jax.htsvoice", tmp_path / "port.htsvoice"
    kw = dict(alpha=0.42, gv_off_context=("sil",))
    jcc.export_voice(jm, str(a), 48000, 240, dims, gv_model=jg, **kw)
    cc.export_voice(pm, str(b), 48000, 240, dims, gv_model=pg, **kw)
    assert a.read_bytes() == b.read_bytes()
    assert voice.read_htsvoice_header(str(b)) == \
        jvoice.read_htsvoice_header(str(a))
    back = voice.load_htsvoice(str(b))
    for st in pm.streams:
        got = back["streams"][st.name]
        for s in range(pm.n_states):
            tree, t2 = pm.trees[st.name][s], got["trees"][s]
            assert t2.n_leaves == tree.n_leaves
            assert [t2.leaf_of(c) for c in ctxs] == \
                [tree.leaf_of(c) for c in ctxs]
            for (m1, v1), (m2, v2) in zip(tree.leaf_params, t2.leaf_params):
                assert np.allclose(m1, m2, rtol=1e-6, atol=1e-6)
                assert np.allclose(v1, v2, rtol=1e-6, atol=1e-6)
            if st.msd:
                assert np.allclose(got["msd_weights"][s],
                                   pm.msd_weights[st.name][s], atol=1e-6)
    assert back["streams"]["mgc"]["gv_tree"] is not None
    assert [back["duration"][0].leaf_of(c) for c in ctxs] == \
        [pm.dur_tree.leaf_of(c) for c in ctxs]
    for c in ctxs:
        for s in range(pm.n_states):
            jp, pp = jm.state_params(c, s), pm.state_params(c, s)
            for n in jp:
                assert all(np.array_equal(np.asarray(x), np.asarray(y))
                           for x, y in zip(jp[n], pp[n]))
        assert all(np.array_equal(x, y) for x, y in zip(jm.durations(c),
                                                        pm.durations(c)))


def test_recording_trees_keeps_each_tree_with_its_statistics():
    import chip_smoke
    contexts = _contexts(30, seed=3)
    ss, _ = _both((clustering, clustering), _stats("plain", contexts)[0])
    qs = _questions()[1]
    inner = clustering.cluster_states
    with chip_smoke.recording_trees(clustering) as built:
        tree = cc.clustering.cluster_states(ss, qs)
    assert clustering.cluster_states is inner
    assert built[id(tree)][0] is tree and built[id(tree)][1][0] is ss
    margins = chip_smoke.split_margins(clustering, tree, built, tree, built)
    assert margins == []


def test_split_margins_tells_a_rounding_tie_from_a_real_split():
    """Two notes of one phone: C-Note==3 and C-Note==4 split them alike,
    so their gains differ by rounding alone (the no-branch is the node
    minus the yes-branch); a root split by note instead of by phone has
    another gain, far past rounding, and makes another partition (gap
    inf)."""
    import chip_smoke
    ctxs = ["x^x-a+x=x/E:3]", "x^x-a+x=x/E:4]", "x^x-i+x=x/E:3]",
            "x^x-i+x=x/E:4]"]
    rng = np.random.default_rng(5)
    ss = {}
    for i, c in enumerate(ctxs):
        x = 5.0 + 0.5 * i + 0.3 * rng.standard_normal((40, 6))
        ss[c] = clustering.SuffStats(40.0, x.sum(0), (x * x).sum(0))
    q = {n: clustering.Question(n, [p]) for n, p in (
        ("C-Phone_a", "*-a+*"), ("C-Note==3", "*/E:3]*"),
        ("C-Note==4", "*/E:4]*"))}
    leaf = [(np.zeros(6), np.ones(6))] * 4

    def tree(root, below):
        return clustering.tree_from_plain(
            (root, tuple(q[root].patterns),
             (below, tuple(q[below].patterns), ("leaf", 0), ("leaf", 1)),
             (below, tuple(q[below].patterns), ("leaf", 2), ("leaf", 3))),
            leaf)
    x, y = tree("C-Phone_a", "C-Note==3"), tree("C-Phone_a", "C-Note==4")
    built = {id(t): (t, (ss, list(q.values())), {}) for t in (x, y)}
    margins = chip_smoke.split_margins(clustering, x, built, y, built)
    assert [m["questions"] for m in margins] == [("C-Note==3",
                                                  "C-Note==4")] * 2
    assert all(m["gap"] <= chip_smoke.ROUNDING_GAP for m in margins)
    assert all(m["gap_of_gain"] < 1e-12 for m in margins)
    z = tree("C-Note==3", "C-Phone_a")
    built[id(z)] = (z, (ss, list(q.values())), {})
    far = chip_smoke.split_margins(clustering, x, built, z, built)
    assert far[0]["gap"] > 1e6 * chip_smoke.ROUNDING_GAP
    assert far[-1]["gap"] == float("inf")
