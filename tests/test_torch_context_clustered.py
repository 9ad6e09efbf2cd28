"""The port's tied-model recipe (models/context_clustered.py, the tied
half of models/hsmm_batch.py, models/recipe.py) against the JAX package,
on the CPU, in float64.

The corpus is tests/test_recipe.py's (three phones, full contexts with a
note field, the tiny 10-dim streams).  JAX models come into the port
through `ClusteredModel.to_plain` / `clustered_from_plain` and
`hsmm.modelset_from_numpy`; the entry points run with `device="cpu"`,
where K17-K20 run as their plain twins.

Trees are compared as the partitions they make of their contexts: where
two questions split a node's contexts the same way (two contexts that
differ only in the note: C-Note==3, C-Note==4 and C-Note<=3), their gains
are equal in exact arithmetic, and which one wins is decided by the last
bits of the statistics, which the two packages sum in different orders.

Two more things are decided by rounding in both packages, and the
comparisons say so where they meet them:
- the voiced-space Gaussian of an MSD leaf whose voiced weight sits at its
  1e-3 floor is fitted to no voiced frames: its statistics are what is
  left of subtracting equal sums (a no-branch is its parent minus its
  yes-branch), so only its weight is compared;
- such a leaf's variance floor of 1e-8 gives voiced frames log-likelihoods
  near -3e9, so prefix sums of the chain's log-likelihoods reach ~1e11,
  and JAX's cumsum (a reduce_window on the CPU) rounds them in another
  order than the sequential one: a log-likelihood is held to 1e-9 of
  itself plus 16 float64 ulps of the largest prefix sum behind it.
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke
import tests.test_hsmm as th
from tests.test_recipe import _corpus, _questions
from tests.test_torch_hsmm import _port
from hts_train_world_tpu.models import clustering as jclustering
from hts_train_world_tpu.models import context_clustered as jcc
from hts_train_world_tpu.models import hsmm as jhsmm
from hts_train_world_tpu.models import hsmm_batch as jhb
from hts_train_world_tpu.models import recipe as jrecipe
from hts_train_world_tpu_torch.features import qconf
from hts_train_world_tpu_torch.models import clustering, hsmm, hsmm_batch
from hts_train_world_tpu_torch.models import context_clustered as cc
from hts_train_world_tpu_torch.models import recipe

CPU = dict(device="cpu")
CFG = dict(n_states=3, n_iters=2, max_dur=40, mdl_factor=0.5,
           min_occupancy=0.5)


def _quiet(_):
    pass


def _port_questions():
    return clustering.questions_from_config(qconf.parse_config("""
C-Phone_a {*-a+*}
C-Phone_b {*-b+*}
C-Phone_c {*-c+*}
C-Note {*/E:%d]*} MIN=0 MAX=7
"""))


def _port_streams():
    return tuple(hsmm.StreamDef(s.name, s.sl, s.msd, s.msd_flag_col,
                                s.weight) for s in th._tiny_streams())


def _carry(jmodel):
    return cc.clustered_from_plain(cc.ClusteredModel.to_plain(jmodel))


def _canon(tree, ctxs):
    """The tree as the partition it makes of `ctxs`: a leaf is the set of
    its contexts, a split the unordered pair of its children."""
    def walk(n, cs):
        if n.question is None:
            return ("leaf", frozenset(cs))
        yes = [c for c in cs if n.question.matches(c)]
        no = [c for c in cs if not n.question.matches(c)]
        return ("split", frozenset([walk(n.yes, yes), walk(n.no, no)]))
    return walk(tree.root, list(ctxs))


EPS = float(np.finfo(np.float64).eps)


def _prefix_scale(jmodel, utts):
    """The sum over utterances of the largest |prefix sum| of the chain's
    log-likelihoods under a JAX tied model (the scale of the rounding in
    the segment sums)."""
    total = 0.0
    sls = tuple((st.sl.start, st.sl.stop) for st in jmodel.streams)
    flags = tuple(st.msd for st in jmodel.streams)
    wts = tuple(st.weight for st in jmodel.streams)
    for frames, seq in utts:
        means, vars_, msd_w, *_ = jcc._chain_arrays(jmodel, seq)
        names = [st.name for st in jmodel.streams]
        obs = np.asarray(jhsmm.frame_loglik(
            frames, tuple(means[n] for n in names),
            tuple(vars_[n] for n in names), tuple(msd_w[n] for n in names),
            sls, flags, wts))
        total += float(np.abs(np.cumsum(obs, 0)).max())
    return total


def _ll_close(a, b, scale):
    return abs(a - b) <= 1e-9 * abs(a) + 16 * EPS * scale


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _assert_same_model(jm, pm, ctxs, tol=1e-8):
    """Same partitions in every tree; per context and state the same
    parameters (means, variances, msd weights; an MSD leaf at its weight
    floor only its weight) and durations."""
    for st in jm.streams:
        for s in range(jm.n_states):
            assert _canon(pm.trees[st.name][s], ctxs) == \
                _canon(jm.trees[st.name][s], ctxs), (st.name, s)
    assert _canon(pm.dur_tree, ctxs) == _canon(jm.dur_tree, ctxs)
    for c in ctxs:
        for s in range(jm.n_states):
            jp, pp = jm.state_params(c, s), pm.state_params(c, s)
            for n in jp:
                w0, w1 = float(jp[n][2]), float(pp[n][2])
                assert abs(w0 - w1) <= tol
                if w0 <= 1e-3:
                    continue       # no voiced frames: weight only
                for x, y in zip(jp[n][:2], pp[n][:2]):
                    assert np.abs(np.asarray(x) - np.asarray(y)).max() \
                        <= tol * max(1.0, np.abs(np.asarray(x)).max())
        for x, y in zip(jm.durations(c), pm.durations(c)):
            assert np.abs(x - y).max() <= tol * max(1.0, np.abs(x).max())


@pytest.fixture(scope="module")
def corpus():
    return _corpus(np.random.default_rng(2))


@pytest.fixture(scope="module")
def jax_run(corpus):
    """The JAX recipe on the corpus, soft and hard counts: {soft: (state,
    every tree it built with the statistics that built it)}."""
    utts, spans = corpus
    out = {}
    for soft in (True, False):
        with chip_smoke.recording_trees(jclustering) as built:
            out[soft] = (jrecipe.train_voice(
                utts, _questions(),
                jrecipe.RecipeConfig(**CFG, soft_counts=soft),
                streams=th._tiny_streams(), bootstrap_spans=spans,
                log=_quiet), built)
    return out


@pytest.fixture(scope="module")
def jax_voice(jax_run):
    return {soft: state for soft, (state, _) in jax_run.items()}


def _contexts(utts):
    return sorted({c for _, seq in utts for c in seq})


def _assert_stats_close(a, b, tol=1e-9):
    """(stream_stats, msd_stats, dur_stats) of the two packages."""
    for i in (0, 1):
        assert a[i].keys() == b[i].keys()
        for n in a[i]:
            for A, B in zip(a[i][n], b[i][n]):
                assert A.keys() == B.keys()
                for c in A:
                    assert abs(A[c].gamma - B[c].gamma) <= tol * A[c].gamma
                    # relative to the context's occupancy too: a voiced
                    # count of 0 in truth is 0 or ~1e-200 in either
                    for x, y in ((A[c].s1, B[c].s1), (A[c].s2, B[c].s2)):
                        assert np.abs(x - y).max() <= tol * max(
                            np.abs(x).max(), A[c].gamma)
    assert a[2].keys() == b[2].keys()
    for c in a[2]:
        assert abs(a[2][c].gamma - b[2][c].gamma) <= tol * a[2][c].gamma
        assert _rel(b[2][c].s1, a[2][c].s1) <= tol
        assert _rel(b[2][c].s2, a[2][c].s2) <= tol


def test_phone_of_and_plain_model_round_trip(jax_voice, corpus):
    for c in ("x^x-a+x=x/E:3]", "sil^sil-sil+a=a@1_x/E:0]", "mono"):
        assert cc.phone_of(c) == jcc.phone_of(c)
    jm = jax_voice[True].clustered
    pm = _carry(jm)
    again = cc.clustered_from_plain(pm.to_plain())
    plain = pm.to_plain()
    assert again.to_plain()["trees"].keys() == plain["trees"].keys()
    for n in plain["trees"]:
        assert [t[0] for t in again.to_plain()["trees"][n]] == \
            [t[0] for t in plain["trees"][n]]
    assert cc.ClusteredModel.to_plain(jm)["dur_tree"][0] == \
        plain["dur_tree"][0]
    _assert_same_model(jm, pm, _contexts(corpus[0]), tol=0.0)


@pytest.mark.parametrize("i", [0, 2, 5])
def test_align_with_clustered_matches_jax(jax_voice, corpus, i):
    jm = jax_voice[True].clustered
    frames, seq = corpus[0][i]
    ll0, ends0, ch0 = jcc.align_with_clustered(jm, frames, seq, 40)
    ll, ends, ch = cc.align_with_clustered(_carry(jm), frames, seq, 40,
                                           **CPU)
    assert np.array_equal(ends, ends0)
    assert _ll_close(ll0, ll, _prefix_scale(jm, [(frames, seq)]))
    for a, b in zip(ch0, ch):
        if isinstance(a, dict):
            assert all(np.array_equal(a[k], b[k]) for k in a)
        else:
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="alignment is infeasible"):
        cc.align_with_clustered(_carry(jm), frames[:5], seq, 40, **CPU)


def test_align_corpus_in_batches_equals_each_utterance_alone(jax_voice,
                                                            corpus):
    """FALGN's padded batches (K17 and K20 over several utterances) give
    each utterance the log-likelihood and ends it gets alone, and the
    JAX package's ends; an infeasible chain comes back as its ValueError
    in its place."""
    jm = jax_voice[True].clustered
    pm = _carry(jm)
    utts = list(corpus[0])
    utts.insert(2, (utts[0][0][:5], utts[0][1]))
    got = cc.align_corpus_with_clustered(pm, utts, 40, max_batch=4, **CPU)
    assert isinstance(got[2], ValueError)
    assert "alignment is infeasible" in str(got[2])
    for i, ((frames, seq), res) in enumerate(zip(utts, got)):
        if i == 2:
            continue
        ll, ends, _ = cc.align_with_clustered(pm, frames, seq, 40, **CPU)
        assert res[0] == ll and np.array_equal(res[1], ends)
        assert np.array_equal(ends, jcc.align_with_clustered(
            jm, frames, seq, 40)[1])


def test_collect_context_stats_hard_matches_jax(jax_voice, corpus):
    jms = jax_voice[True].monophone
    utts = corpus[0]
    a = jcc.collect_context_stats(jms, utts, 40)
    b = cc.collect_context_stats(_port(jms), utts, 40, **CPU)
    _assert_stats_close(a, b)


def test_collect_context_stats_soft_matches_jax(jax_voice, corpus):
    jms = jax_voice[True].monophone
    utts = corpus[0]
    ctxs = _contexts(utts)
    jfull = jcc.clone_full_context(jms, ctxs)
    pfull = cc.clone_full_context(_port(jms), ctxs)
    for n in jfull.means:
        assert np.array_equal(jfull.means[n], pfull.means[n])
    a = jcc.collect_context_stats_soft(jfull, utts, 40, n_reest=1)
    b = cc.collect_context_stats_soft(pfull, utts, 40, n_reest=1, **CPU)
    _assert_stats_close(a, b)


def test_collect_context_stats_tied_matches_jax(jax_voice, corpus):
    jm = jax_voice[True].clustered
    utts = corpus[0]
    a = jcc.collect_context_stats_tied(jm, utts, 40)
    b = cc.collect_context_stats_tied(_carry(jm), utts, 40, **CPU)
    _assert_stats_close(a, b)


def test_build_clustered_model_gives_the_jax_trees(jax_voice, corpus):
    """On the same statistics the trees are the JAX package's, question
    for question, with bit-equal leaf parameters and msd weights."""
    jms = jax_voice[True].monophone
    utts = corpus[0]
    stats = jcc.collect_context_stats_tied(jax_voice[True].clustered, utts,
                                           40)

    def port_stats(d):
        return {k: v if not isinstance(v, list) else
                [{c: clustering.SuffStats(x.gamma, x.s1, x.s2)
                  for c, x in e.items()} for e in v]
                for k, v in d.items()}
    pstats = (port_stats(stats[0]), port_stats(stats[1]),
              {c: clustering.SuffStats(x.gamma, x.s1, x.s2)
               for c, x in stats[2].items()})
    jm = jcc.build_clustered_model(jms, *stats, _questions(), 0.5, 0.5)
    pm = cc.build_clustered_model(_port(jms), *pstats, _port_questions(),
                                  0.5, 0.5)
    want, got = cc.ClusteredModel.to_plain(jm), pm.to_plain()
    for n in want["trees"]:
        for (ws, wl), (gs, gl) in zip(want["trees"][n], got["trees"][n]):
            assert gs == ws
            assert all(np.array_equal(x, y) for p, q in zip(wl, gl)
                       for x, y in zip(p, q))
        for w, g in zip(want["msd_weights"].get(n, []),
                        got["msd_weights"].get(n, [])):
            assert np.array_equal(w, g)
    assert got["dur_tree"][0] == want["dur_tree"][0]


def test_tied_tables_and_chain_rows_match_jax(jax_voice, corpus):
    jm = jax_voice[True].clustered
    pm = _carry(jm)
    jt, joff, jn = jhb.tables_from_clustered(jm)
    pt, poff, pn = hsmm_batch.tables_from_clustered(pm)
    assert pn == jn
    for d in ("means", "vars", "msd_w"):
        for n in getattr(jt, d):
            assert np.array_equal(getattr(jt, d)[n], getattr(pt, d)[n])
    assert np.array_equal(jt.dur_mean, pt.dur_mean)
    for n in joff:
        assert np.array_equal(joff[n], poff[n])
    for _, seq in corpus[0]:
        jr, jd = jhb.chain_rows_clustered(jm, seq, joff)
        pr, pd = hsmm_batch.chain_rows_clustered(pm, seq, poff)
        assert np.array_equal(jd, pd)
        assert all(np.array_equal(jr[n], pr[n]) for n in jr)


def test_clone_from_clustered_and_generate_match_jax(jax_voice, corpus):
    jm = jax_voice[True].clustered
    pm = _carry(jm)
    ctxs = _contexts(corpus[0])
    a = jcc.clone_from_clustered(jm, ctxs)
    b = cc.clone_from_clustered(pm, ctxs)
    assert a.names == b.names
    for d in ("means", "variances", "msd_weights"):
        for n in getattr(a, d):
            assert np.array_equal(getattr(a, d)[n], getattr(b, d)[n])
    assert np.array_equal(a.dur_mean, b.dur_mean)
    ga, gb = jm.generate(ctxs[:4], 1.1), pm.generate(ctxs[:4], 1.1)
    for x, y in zip(ga[:2], gb[:2]):
        assert all(np.array_equal(x[n], y[n]) for n in x)
    assert np.array_equal(ga[2], gb[2]) and np.array_equal(ga[3], gb[3])


def test_reestimate_clustered_matches_jax(jax_voice, corpus):
    jm = copy.deepcopy(jax_voice[True].clustered)
    pm = _carry(jm)
    utts = corpus[0]
    scale = _prefix_scale(jm, utts)
    h0 = jcc.reestimate_clustered(jm, utts, n_iters=2, max_dur=40,
                                  log=_quiet)
    h1 = cc.reestimate_clustered(pm, utts, n_iters=2, max_dur=40,
                                 log=_quiet, **CPU)
    scale = max(scale, _prefix_scale(jm, utts))
    assert all(_ll_close(a, b, scale) for a, b in zip(h0, h1))
    _assert_same_model(jm, pm, _contexts(utts))


def test_reestimate_clustered_batched_matches_jax(jax_voice, corpus):
    jm = copy.deepcopy(jax_voice[True].clustered)
    pm = _carry(jm)
    utts = corpus[0]
    scale = _prefix_scale(jm, utts)
    h0 = jhb.reestimate_clustered_batched(jm, utts, n_iters=2, max_dur=40,
                                          log=_quiet)
    h1 = hsmm_batch.reestimate_clustered_batched(pm, utts, n_iters=2,
                                                 max_dur=40, log=_quiet,
                                                 **CPU)
    scale = max(scale, _prefix_scale(jm, utts))
    assert all(_ll_close(a, b, scale) for a, b in zip(h0, h1))
    _assert_same_model(jm, pm, _contexts(utts))


def _assert_rounding_ties(js, ps, jbuilt, pbuilt):
    """Where a port tree names a split by another question than the JAX
    tree (same partition), both questions' gains, under either package's
    statistics, differ by rounding alone."""
    pairs = [(js.clustered.trees[st.name][s], ps.clustered.trees[st.name][s])
             for st in js.clustered.streams
             for s in range(js.clustered.n_states)]
    pairs += [(js.clustered.dur_tree, ps.clustered.dur_tree)]
    pairs += [(js.gv.trees[n], ps.gv.trees[n]) for n in js.gv.trees]
    for x, y in pairs:
        if clustering.Tree.to_plain(x)[0] != y.to_plain()[0]:
            for m in chip_smoke.split_margins(clustering, x, jbuilt, y,
                                              pbuilt):
                assert m["gap"] <= chip_smoke.ROUNDING_GAP, m


@pytest.mark.parametrize("soft", [True, False])
def test_train_voice_matches_jax(jax_run, corpus, soft):
    utts, spans = corpus
    js, jbuilt = jax_run[soft]
    with chip_smoke.recording_trees(clustering) as pbuilt:
        ps = recipe.train_voice(utts, _port_questions(),
                                recipe.RecipeConfig(**CFG, soft_counts=soft),
                                streams=_port_streams(),
                                bootstrap_spans=spans, log=_quiet, **CPU)
    ctxs = _contexts(utts)
    _assert_same_model(js.clustered, ps.clustered, ctxs)
    _assert_rounding_ties(js, ps, jbuilt, pbuilt)
    assert js.alignments.keys() == ps.alignments.keys()
    for k in js.alignments:
        assert np.array_equal(js.alignments[k], ps.alignments[k])
    firsts = sorted({seq[0] for _, seq in utts})
    assert js.gv.trees.keys() == ps.gv.trees.keys()
    for n in js.gv.trees:
        assert _canon(ps.gv.trees[n], firsts) == \
            _canon(js.gv.trees[n], firsts)
        for c in firsts:
            for x, y in zip(js.gv.params(n, c), ps.gv.params(n, c)):
                assert x.shape == y.shape       # (0,) where statics < 1
                assert np.all(np.abs(x - y) <= 1e-8 * max(
                    1.0, np.abs(x).max(initial=0.0)))
    want = [m.split(":")[0] for m in js.log_history]
    assert [m.split(":")[0] for m in ps.log_history] == want
    stages = {"IN_RE", "ERST0", "CXCL estep", "CXCL trees", "ERST2",
              "CXCL2 estep", "CXCL2 trees", "ERST4", "FALGN", "MCDGV"}
    assert set(ps.stage_seconds) == stages


def test_export_matches_jax(jax_voice, corpus, tmp_path):
    js = jax_voice[True]
    cfg = recipe.RecipeConfig(**CFG)
    ps = recipe.RecipeState(clustered=_carry(js.clustered))
    from hts_train_world_tpu_torch.models import gv_model
    ps.gv = gv_model.GVModel({n: clustering.tree_from_plain(
        *clustering.Tree.to_plain(t)) for n, t in js.gv.trees.items()})
    a, b = tmp_path / "jax.htsvoice", tmp_path / "port.htsvoice"
    jrecipe.export(js, str(a), 48000, 240, jrecipe.RecipeConfig(**CFG))
    recipe.export(ps, str(b), 48000, 240, cfg)
    assert a.read_bytes() == b.read_bytes()


@pytest.fixture
def one_thread():
    """One intra-op thread for a whole recipe of small ops, which the
    default thread pool slows many-fold when test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flag", ["semitied", "upmix", "use_mspf"])
def test_unported_options_raise(corpus, flag, one_thread):
    """The recipe's once-unported options all run now: SEMIT fills
    `state.semitied`, UPMIX a two-component `state.mixture`, MSPF
    `state.mspf` (statics-only windows: the tiny streams are not
    window-expanded), each with its stage's seconds.
    tests/test_torch_recipe_variants.py holds the first two against the
    JAX package.  The test keeps the name it had while SEMIT and UPMIX
    raised, by the project's rule that a test whose checks change with
    the code keeps its name, so that its record stays one test's."""
    utts, _ = corpus
    cfg = recipe.RecipeConfig(**CFG, **{flag: True})
    if flag == "use_mspf":
        cfg = recipe.RecipeConfig(**CFG, use_mspf=True, n_win=1)
    st = recipe.train_voice(utts, _port_questions(), cfg,
                            streams=_port_streams(), log=_quiet, **CPU)
    if flag == "use_mspf":
        assert "MSPF" in st.stage_seconds
        for stats in st.mspf:
            assert stats.mean.shape[1] == 33
            assert np.isfinite(stats.mean).all()
            assert np.isfinite(stats.std).all()
    elif flag == "semitied":
        assert "SEMIT" in st.stage_seconds and st.mixture is None
        assert st.semitied.transforms.keys() == {"mgc", "lf0", "bap", "vib"}
        for A in st.semitied.transforms.values():
            assert np.isfinite(A).all()
    else:
        assert "UPMIX" in st.stage_seconds and st.semitied is None
        assert st.mixture.n_comps == 2


def test_falgn_drops_infeasible_utterances(corpus):
    utts, spans = corpus
    short = list(utts) + [(utts[0][0][:8], utts[0][1])]
    st = recipe.train_voice(short, _port_questions(),
                            recipe.RecipeConfig(**CFG), log=_quiet,
                            streams=_port_streams(), bootstrap_spans=spans,
                            **CPU)
    assert sorted(st.alignments) == list(range(len(utts)))
    assert any(m.startswith(f"FALGN: dropping utt {len(utts)}: utterance "
                            "has 8 frames") for m in st.log_history)


def test_chip_smoke_tiny_recipe_corpus_is_test_recipes(corpus):
    utts, spans = corpus
    got, got_spans = chip_smoke.recipe_tiny_corpus()
    assert len(got) == len(utts) and got_spans.keys() == spans.keys()
    for (f0, s0), (f1, s1) in zip(utts, got):
        assert np.array_equal(f0, f1) and s0 == s1
    assert all(np.array_equal(spans[k], got_spans[k]) for k in spans)


def test_entry_points_raise_without_cuda(jax_voice, corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    utts, _ = corpus
    pm = _carry(jax_voice[True].clustered)
    pms = _port(jax_voice[True].monophone)
    frames, seq = utts[0]
    calls = [
        lambda: recipe.train_voice(utts, _port_questions(),
                                   recipe.RecipeConfig(**CFG),
                                   streams=_port_streams(), log=_quiet),
        lambda: cc.align_with_clustered(pm, frames, seq),
        lambda: cc.collect_context_stats(pms, utts),
        lambda: cc.collect_context_stats_soft(pms, utts),
        lambda: cc.collect_context_stats_tied(pm, utts),
        lambda: cc.reestimate_clustered(pm, utts, log=_quiet),
        lambda: hsmm_batch.reestimate_clustered_batched(pm, utts,
                                                        log=_quiet),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
