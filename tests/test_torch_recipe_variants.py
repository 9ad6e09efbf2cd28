"""The port's `train_voice` with SEMIT and UPMIX/ERST5 against the JAX
package, on the CPU, in float64.

tests/test_recipe.py::test_recipe_all_variants's corpus and config (DAEM,
`upmix_iters=1`, `semitied_iters=5`) through both packages' recipes; the
port's entry points run with `device="cpu"` (the kernels' plain twins).
`state.mixture` and `state.semitied` are held at
tests/test_torch_hsmm_variants.py's bounds: parameters within 1e-9 of each
array's largest magnitude (variances 1e-8), transforms within 1e-9 of
max|A|, logdets 1e-9 absolute.  Both stages are side products: the port's
run with both flags gives the clustered model, the alignments and the GV
model of its run with both flags off, bit for bit.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import tests.test_hsmm as th
from tests.test_recipe import _corpus, _questions
from tests.test_torch_context_clustered import (_port_questions,
                                                _port_streams)
from hts_train_world_tpu.models import recipe as jrecipe
from hts_train_world_tpu_torch.models import context_clustered as cc
from hts_train_world_tpu_torch.models import clustering, recipe

CFG = dict(n_states=3, n_iters=1, max_dur=40, daem=True, daem_n_iter=2,
           mdl_factor=0.5, min_occupancy=0.5)
VARIANTS = dict(upmix=True, upmix_iters=1, semitied=True, semitied_iters=5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the twins run many small ops, which the
    default thread pool slows many-fold when test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-300)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(4)
    utts, spans = _corpus(rng)
    js = jrecipe.train_voice(
        utts, _questions(), jrecipe.RecipeConfig(**CFG, **VARIANTS),
        streams=th._tiny_streams(), bootstrap_spans=spans,
        log=lambda m: None)
    ports = [recipe.train_voice(
        utts, _port_questions(), recipe.RecipeConfig(**CFG, **extra),
        streams=_port_streams(), bootstrap_spans=spans, log=lambda m: None,
        device="cpu") for extra in (VARIANTS, {})]
    return js, ports


def _assert_variants_match(js_mix, js_st, pm, pst):
    assert pm.names == js_mix.names and pm.n_comps == js_mix.n_comps == 2
    for part in ("means", "mix_logw", "msd_weights"):
        for k, v in getattr(js_mix, part).items():
            _close(getattr(pm, part)[k], v, 1e-9)
    for k, v in js_mix.variances.items():
        _close(pm.variances[k], v, 1e-8)
    _close(pm.dur_mean, js_mix.dur_mean, 1e-9)
    _close(pm.dur_var, js_mix.dur_var, 1e-9)
    assert pst.transforms.keys() == js_st.transforms.keys() != set()
    for k, A in js_st.transforms.items():
        _close(pst.transforms[k], A, 1e-9)
        assert abs(pst.logdets[k] - js_st.logdets[k]) <= 1e-9
    for k in js_st.base.means:
        _close(pst.base.means[k], js_st.base.means[k], 1e-9)
        _close(pst.base.variances[k], js_st.base.variances[k], 1e-8)


def test_train_voice_variants_match_jax(runs):
    """SEMIT and UPMIX/ERST5 run in the port's recipe and fill the state
    as the JAX recipe does; their log lines are the JAX package's."""
    js, (ps, _) = runs
    _assert_variants_match(js.mixture, js.semitied, ps.mixture, ps.semitied)
    assert {"SEMIT", "UPMIX"} <= set(ps.stage_seconds)
    keep = ("SEMIT", "mixture EM")
    assert [m for m in ps.log_history if m.startswith(keep)] == \
        [m for m in js.log_history if m.startswith(keep)]


def test_variants_leave_later_stages_unchanged(runs):
    """The clustered model, the alignments and the GV model of the run
    with both flags equal those of the run with both flags off."""
    _, (on, off) = runs
    assert off.mixture is None and off.semitied is None
    same = chip_smoke.plain_equal
    assert same(cc.ClusteredModel.to_plain(on.clustered),
                cc.ClusteredModel.to_plain(off.clustered))
    assert same(on.alignments, off.alignments)
    assert same(
        {n: clustering.Tree.to_plain(t) for n, t in on.gv.trees.items()},
        {n: clustering.Tree.to_plain(t) for n, t in off.gv.trees.items()})


def test_state_from_numpy_carries_the_variants(runs):
    """`recipe.state_from_numpy(..., mixture=, semitied=)` carries the JAX
    recipe's side products across bit for bit."""
    js, _ = runs
    m, s = js.mixture, js.semitied
    streams = [(st.name, st.sl.start, st.sl.stop, st.msd, st.msd_flag_col,
                st.weight) for st in m.streams]
    b = s.base
    st = recipe.state_from_numpy(
        cc.ClusteredModel.to_plain(js.clustered),
        mixture=(m.names, m.means, m.variances, m.mix_logw, m.msd_weights,
                 m.dur_mean, m.dur_var, streams),
        semitied=((b.names, b.means, b.variances, b.msd_weights, b.dur_mean,
                   b.dur_var, streams), s.transforms, s.logdets))
    same = chip_smoke.plain_equal
    for part in ("means", "variances", "mix_logw", "msd_weights"):
        assert same(getattr(st.mixture, part), getattr(m, part))
    assert same(st.mixture.dur_mean, m.dur_mean)
    assert same(st.semitied.base.means, b.means)
    assert same(st.semitied.base.variances, b.variances)
    assert same(st.semitied.transforms, s.transforms)
    assert st.semitied.logdets == s.logdets
