"""K19's batch form on the CPU: the multi-table twin, the member lists
the host builds for the kernel, and the E-step that adds every batch into
running tables.

On the CPU `segment_sums` runs its plain twin (`index_add_` a table into
+0.0, then the add into the running table); these tests hold it to the
per-table `segment_sum_plain` plus a merge on the host, bit for bit, and
to `jax.ops.segment_sum`.  `tests/test_torch_cuda.py` holds the kernel to
the twin on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hts_train_world_tpu_torch.models import hsmm, hsmm_batch


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _batch(rng, widths, n_rows):
    """One batch's tables: row ids with empty rows, one row that holds
    every member of a table, and ids at n_rows - 1."""
    vals, ids = [], []
    for i, (C, R) in enumerate(zip(widths, n_rows)):
        N = int(rng.integers(40, 90))
        if i == 1:
            r = np.full(N, R - 1)                       # one row, all members
        else:
            r = rng.integers(0, R - 3, N)               # three rows empty
            r[rng.integers(0, N, 3)] = R - 1
        vals.append(rng.standard_normal((N, C))
                    * 10.0 ** rng.uniform(-6, 6, (N, 1)))
        ids.append(r)
    return vals, ids


WIDTHS, ROWS = (13, 9, 5, 9, 3), (21, 7, 21, 16, 30)


def test_multi_table_twin_equals_per_table_sums_and_merge():
    """Three batches: the running tables from +0.0 through `segment_sums`
    (the plain twin, fresh and in place) equal each table's
    `segment_sum_plain` with the host merge `a + s` (the first batch
    taken as it is), bit for bit."""
    rng = np.random.default_rng(19)
    run = [torch.zeros((R, C), dtype=torch.float64)
           for C, R in zip(WIDTHS, ROWS)]
    inplace = [a.clone() for a in run]
    ref = None
    for _ in range(3):
        vals, ids = _batch(rng, WIDTHS, ROWS)
        v = [_t(a) for a in vals]
        i = [_t(a, torch.long) for a in ids]
        sums = [hsmm_batch.segment_sum_plain(a, b, R)
                for a, b, R in zip(v, i, ROWS)]
        ref = sums if ref is None else [a + s for a, s in zip(ref, sums)]
        run = hsmm_batch.segment_sums(v, i, ROWS, run)
        out = hsmm_batch.segment_sums(v, i, ROWS, inplace, out=inplace)
        assert all(o is a for o, a in zip(out, inplace))
    for a, b, c in zip(run, inplace, ref):
        assert torch.equal(a, c) and torch.equal(b, c)
        assert not torch.signbit(a[a == 0]).any()      # never -0.0


def test_each_table_matches_jax_segment_sum():
    """Each table's sums (into +0.0) against `jax.ops.segment_sum`, at
    tests/test_torch_hsmm_kernels.py's bound, empty rows exactly 0."""
    rng = np.random.default_rng(7)
    vals, ids = _batch(rng, WIDTHS, ROWS)
    zero = [torch.zeros((R, C), dtype=torch.float64)
            for C, R in zip(WIDTHS, ROWS)]
    got = hsmm_batch.segment_sums([_t(a) for a in vals],
                                  [_t(a, torch.long) for a in ids], ROWS,
                                  zero)
    for g, v, i, R in zip(got, vals, ids, ROWS):
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(v),
                                              jnp.asarray(i), R))
        assert np.abs(g.numpy() - want).max() <= 1e-12 * np.abs(v).max()
        empty = np.setdiff1d(np.arange(R), i)
        assert np.all(g.numpy()[empty] == 0.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_member_lists_are_stable_and_their_offsets_right(seed):
    rng = np.random.default_rng(seed)
    R = int(rng.integers(1, 40))
    ids = rng.integers(0, R, int(rng.integers(0, 300)))
    if seed == 2:
        ids[:] = R - 1
    order, offsets = hsmm_batch.member_lists(ids, R)
    assert order.dtype == offsets.dtype == np.int32
    assert np.array_equal(order, np.argsort(ids, kind="stable"))
    assert np.array_equal(offsets, np.concatenate(
        [[0], np.cumsum(np.bincount(ids, minlength=R))]))
    for r in range(R):
        m = order[offsets[r]:offsets[r + 1]]
        assert np.array_equal(m, np.flatnonzero(ids == r))   # ascending
    with pytest.raises(ValueError):
        hsmm_batch.member_lists(np.array([0, R]), R)
    with pytest.raises(ValueError):
        hsmm_batch.member_lists(np.array([-1]), R)


def test_corpus_estep_cpu_bits_as_before(monkeypatch):
    """`corpus_estep(device="cpu")` with K19's running tables gives the
    bits of the earlier flow, replayed here from the same batches'
    statistics: each table's `segment_sum_plain`, the first batch taken as
    it is, each later one merged on the host key by key (`a[k] + s[k]`)."""
    ms, utts = chip_smoke.hsmm_tiny_corpus(hsmm, seed=4)
    chained, _ = hsmm_batch.chain_modelset(ms, utts)
    M, S = ms.dur_mean.shape
    n_rows = {st.name: M * S for st in ms.streams}
    sls, flags, _ = hsmm.stream_args(ms.streams)
    seen = []
    real = hsmm_batch.segment_sums

    def spy(vals, ids, nr, acc, members=None, out=None):
        seen.append(([v.clone() for v in vals], [i.clone() for i in ids],
                     tuple(nr)))
        return real(vals, ids, nr, acc, members, out)

    monkeypatch.setattr(hsmm_batch, "segment_sums", spy)
    got = hsmm_batch.corpus_estep(
        hsmm_batch.tables_from_modelset(ms), chained, n_rows, M * S, 40,
        max_batch=3, device="cpu")
    assert len(seen) >= 3
    acc = None
    for vals, ids, nr in seen:
        sums = [hsmm_batch.segment_sum_plain(v, i, n)
                for v, i, n in zip(vals, ids, nr)]
        parts = hsmm_batch.stream_parts(sums[:-1], sls, flags)
        res = (parts, sums[-1])
        acc = res if acc is None else (
            [{k: a[k] + s[k] for k in a} for a, s in zip(acc[0], parts)],
            acc[1] + sums[-1])
    for g, w in zip(got.streams, acc[0]):
        assert set(g) == set(w)
        for k in w:
            assert np.array_equal(g[k], w[k].numpy())
            assert g[k].flags.c_contiguous
    assert np.array_equal(got.dur, acc[1].numpy())
