"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import dio, frames, prims
from hts_train_world_tpu_torch.parallel import batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _close_rows(got, want, rel):
    """Each row within `rel` of its own largest value."""
    assert ((got - want).abs().amax(1)
            <= rel * want.abs().amax(1)).all()


@pytest.mark.parametrize("mode,ratio", [
    (frames.MEAN, 4.0), (frames.MEAN_BLACKMAN, 3.0),
    (frames.CHEAPTRICK, 3.0), (frames.CENTROID, 4.0),
    (frames.STONEMASK, 0.0)])
def test_k1_kernel_matches_plain(cuda, mode, ratio):
    fs, T, step = 48000, 40, 240
    rng = np.random.default_rng(mode)
    x = torch.as_tensor(rng.standard_normal((2, T * step)),
                        dtype=torch.float32, device=cuda)
    f0 = torch.as_tensor(rng.uniform(72, 700, 2 * T), dtype=torch.float32,
                         device=cuda)
    origin = torch.arange(2 * T, device=cuda) % T * step + 3
    pos = origin.float() / fs
    h = prims.matlab_round_i(prims.rdiv(1.5 * fs, f0)).clamp(max=1020)
    got = frames.frame_windows(x, origin, h, f0, fs, ratio, 2048, mode,
                               pos)
    want = frames.frame_windows_plain(x, origin, h, f0, pos, fs, ratio,
                                      2048, mode)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            _close_rows(g, w, 1e-5)


def _k2_rows(kind, R, n, rng):
    """Flat chi-square rows, or four harmonic peaks on a noise floor six
    decades down; every other row a millionth of the level."""
    ps = rng.standard_normal((R, n)) ** 2
    if kind == "harmonic":
        j = np.arange(n)[None, :]
        c = rng.uniform(4.0, 20.0, (R, 1))
        ps = 1e-6 * ps + sum(a * np.exp(-((j - h * c) / 1.5) ** 2)
                             for h, a in enumerate([1.0, 0.4, 0.2, 0.05], 1))
    ps[::2] *= 1e-6
    return ps


@pytest.mark.parametrize("rows", ["flat", "harmonic"])
@pytest.mark.parametrize("dc,ls", [(True, False), (False, True),
                                   (True, True)])
def test_k2_kernel_matches_plain(cuda, dc, ls, rows):
    """Element by element within smooth_spectrum_limit."""
    fs, N = 48000, 4096
    rng = np.random.default_rng(2)
    ps = torch.as_tensor(_k2_rows(rows, 64, N // 2 + 1, rng),
                         dtype=torch.float32, device=cuda)
    f0 = torch.linspace(60.0, 3900.0, 64, device=cuda)
    args = dict(f0=f0 if dc else None, ul_max=344,
                width=f0 if ls else None, b_max=342)
    got = prims.smooth_spectrum(ps, fs, N, **args)
    want = prims.smooth_spectrum_plain(ps, fs, N, **args)
    limit = prims.smooth_spectrum_limit(ps, want, fs, N, **args)
    assert ((got - want).abs() <= limit).all()


@pytest.mark.parametrize("k", [1, 65, 2049])
def test_k3_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    p = torch.as_tensor(np.round(rng.standard_normal((300, 2049)) ** 2, 2),
                        dtype=torch.float32, device=cuda)   # with ties
    s, thr = prims.top_k_threshold_sum(p, k)
    s0, thr0 = prims.top_k_threshold_sum_plain(p, k)
    assert torch.equal(thr, thr0)
    assert ((s - s0).abs() / s0).max() <= 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_k4_kernel_matches_plain(cuda, seed):
    rng = np.random.default_rng(seed)
    B, bands, T = 4, 7, 200
    track = 150.0 + 40.0 * np.sin(np.arange(T) / 9.0)
    cands = track * rng.choice([0.5, 1.0, 2.0], (B, bands, 1)) \
        * (1.0 + 0.03 * rng.standard_normal((B, bands, T)))
    cands = np.where(rng.random((B, bands, T)) < 0.15, 0.0, cands)
    best = cands[:, 0].copy()
    best[:, 60:70] = 0.0
    best, cands = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                   for a in (best, cands))
    got = dio.fix_f0_contour(best, cands, 5.0, 71.0, 0.1)
    want = dio.fix_f0_contour_plain(best, cands, 5.0, 71.0, 0.1)
    assert (want > 0).float().mean() > 0.5
    assert torch.equal(got, want)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ps = torch.ones((4, 1025), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        prims.smooth_spectrum(ps, 48000, 2048, width=ps[:, 0], b_max=100)
    with pytest.raises(ValueError):
        prims.top_k_threshold_sum(ps.float(), 2000)


@pytest.mark.parametrize("name", ["silence", "clicks", "noise"])
def test_main_path_on_hostile_inputs(cuda, name):
    """Silence, click trains and wideband noise through the card's path:
    finite, sp > 0, ap within [0, 1]."""
    fs, L = 16000, 4800
    rng = np.random.default_rng(1)
    x = np.zeros(L)
    if name == "clicks":
        x[::fs // 50] = 0.9
    elif name == "noise":
        x = 0.5 * rng.standard_normal(L)
    _, f0, sp, ap, y = batch.batch_copy_synth(x[None], fs, seed=0)
    for v in (f0, sp, ap, y):
        assert torch.isfinite(v).all()
    assert (sp > 0).all() and (ap >= 0).all() and (ap <= 1).all()


def test_main_path_runs_the_kernels_and_matches_the_cpu_path(cuda):
    fs, L = 16000, 8000
    rng = np.random.default_rng(0)
    t = np.arange(L) / fs
    xs = np.stack([0.5 * np.sin(2 * np.pi * f * t)
                   + 0.2 * np.sin(4 * np.pi * f * t)
                   + 0.01 * rng.standard_normal(L) for f in (170.0, 220.0)])
    noise = rng.standard_normal((2, L + 17))
    kernels.reset_counts()
    g = batch.batch_copy_synth(xs, fs, noise=noise)
    torch.cuda.synchronize()
    assert all(kernels.launches[k] > 0 for k in kernels.KERNELS)
    c = batch.batch_copy_synth(xs, fs, noise=noise, device="cpu")
    f0g, f0c = g[1].cpu(), c[1]
    assert ((f0g > 0) == (f0c > 0)).float().mean() >= 0.98
    both = (f0g > 0) & (f0c > 0)
    assert ((f0g[both] - f0c[both]).abs() / f0c[both]).median() <= 1e-4
    assert (g[2].cpu().log() - c[2].log()).abs().median() <= 0.05
    eg, ec = g[4].cpu().double().pow(2).sum(1), c[4].double().pow(2).sum(1)
    assert ((eg / ec) - 1).abs().max() <= 0.05
