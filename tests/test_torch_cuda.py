"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.features import encode, windows
from hts_train_world_tpu_torch.ops import dio, frames, mlpg, prims
from hts_train_world_tpu_torch.parallel import batch, bucketing, features

pytestmark = pytest.mark.cuda

COPY_SYNTH_KERNELS = ("frame_window", "spectral_smooth", "topk_sum", "fix_f0",
                      "dio_candidates")


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


def _k5_rows(plan, B, rng):
    """Band rows: tones at 3/4 of each boundary; utterance 1 turns to
    wideband noise over its last 30% (overrunning every band cap);
    utterance 2 silent."""
    L, fs = plan["y_length"], plan["actual_fs"]
    rows = np.zeros((B, len(plan["boundary_f0"]), plan["fft_size"]))
    t = np.arange(plan["fft_size"]) / fs
    for bi, (b, off, _) in enumerate(dio.band_layout(plan)):
        rows[:2, bi] = np.sin(2 * np.pi * 0.75 * b * t
                              + rng.uniform(0, 6, (2, 1)))
        rows[1, bi, off + int(0.7 * L):] = rng.standard_normal(
            len(t) - off - int(0.7 * L))
    rows[2] = 0.0
    return rows


@pytest.mark.parametrize("fs,L", [(16000, 8000), (48000, 96000)])
def test_k5_kernel_matches_plain(cuda, fs, L):
    """Crossing positions and counts identical to the twin's; candidates
    no further from the f64 interp1 of those crossings than the twin's
    (+1e-6 relative); zero/nonzero pattern agreeing on >= 0.999 of the
    frames; silent rows all zero."""
    plan = dio.dio_plan(L, fs)
    T = plan["f0_length"]
    rows = torch.as_tensor(_k5_rows(plan, 3, np.random.default_rng(L)),
                           dtype=torch.float32, device=cuda)
    got = dio.band_candidates(rows, plan, 71.0, 800.0, T, 0.005,
                              crossings=True)
    want = dio.band_candidates_plain(rows, plan, 71.0, 800.0, T, 0.005,
                                     crossings=True)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert (got[0][2] == 0).all()
    ref = dio.crossing_candidates_f64(rows, plan, T, 0.005, want[2], want[3])
    both = (got[0] > 0) & (want[0] > 0)
    assert both.float().mean() > 0.1
    rel_k = ((got[0].double() - ref).abs() / ref)[both].max()
    rel_p = ((want[0].double() - ref).abs() / ref)[both].max()
    assert rel_k <= rel_p + 1e-6
    assert ((got[0] > 0) == (want[0] > 0)).float().mean() >= 0.999


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k6_kernel_matches_plain(cuda, fs):
    """Zero, tiny and huge sp and ap, and rows that exercise the bap[0]
    snap: elementwise within encode_spectra_limit (1e-5 |plain| + 1e-5
    row max |plain| before the c0 offsets)."""
    N = 1024 if fs == 16000 else 2048
    rng = np.random.default_rng(fs)
    sp = 10.0 ** rng.uniform(-8, 2, (3, 20, N // 2 + 1))
    sp[rng.random(sp.shape) < 0.05] = 0.0
    sp[0, 0] = 0.0
    sp[0, 1] = 1e-30
    ap = 10.0 ** rng.uniform(-8, 0, sp.shape)
    ap[:, 0] = 1.0
    sp, ap = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
              for a in (sp, ap))
    got = encode.encode_spectra(sp, ap, fs, N)
    want = encode.encode_spectra_plain(sp, ap, fs, N)
    for k, p, lim in zip(got, want, encode.encode_spectra_limit(*want)):
        assert ((k - p).abs() <= lim).all()


def test_k7_kernel_bit_equal(cuda):
    """All-magic columns, magic frames at the edges, T of 1 and 2."""
    rng = np.random.default_rng(7)
    for T in (1, 2, 401):
        x = rng.standard_normal((4, T, 75)).astype(np.float32)
        x[:, :, 3] = windows.MAGIC
        x[1, 0] = x[2, -1] = windows.MAGIC
        x = torch.as_tensor(x, device=cuda)
        got, want = windows.expand(x), windows.expand_plain(x)
        assert torch.equal(got, want)
        assert (got[..., 3] == windows.MAGIC).all()


@pytest.mark.parametrize("T", [1, 2, 4, 401])
def test_k8_kernel_matches_plain(cuda, T):
    """Within rel 1e-5 of the twin; the statics-only windows take the
    closed form and launch nothing."""
    rng = np.random.default_rng(T)
    mu = torch.as_tensor(rng.standard_normal((3, T, 3, 75)),
                         dtype=torch.float32, device=cuda)
    var = 1.0 + 0.1 * mu.abs()
    got = mlpg.mlpg(mu, var)
    want = mlpg.mlpg_plain(mu, var)
    assert ((got - want).abs() <= 1e-5 * want.abs().clamp(min=1e-3)).all()
    kernels.reset_counts()
    s = mlpg.mlpg(mu[:, :, :2], var[:, :, :2], ((1.0,), (1.0,)))
    assert kernels.launches["mlpg_solve"] == 0
    assert torch.allclose(s, mlpg.mlpg_plain(mu[:, :, :2], var[:, :, :2],
                                             ((1.0,), (1.0,))))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ps = torch.ones((4, 1025), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        prims.smooth_spectrum(ps, 48000, 2048, width=ps[:, 0], b_max=100)
    with pytest.raises(ValueError):
        prims.top_k_threshold_sum(ps.float(), 2000)
    with pytest.raises(ValueError):
        windows.expand(ps[None])
    with pytest.raises(ValueError):
        mlpg.mlpg(torch.ones((1, 5, 3, 2), device=cuda),
                  torch.ones((1, 5, 3, 2), device=cuda),
                  ((1.0,), (-0.5, 0.0, 0.5), (1.0, 0.0, 0.0, 0.0, 1.0)))


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
    assert all(kernels.launches[k] > 0 for k in COPY_SYNTH_KERNELS)
    c = batch.batch_copy_synth(xs, fs, noise=noise, device="cpu")
    f0g, f0c = g[1].cpu(), c[1]
    assert ((f0g > 0) == (f0c > 0)).float().mean() >= 0.98
    both = (f0g > 0) & (f0c > 0)
    assert ((f0g[both] - f0c[both]).abs() / f0c[both]).median() <= 1e-4
    assert (g[2].cpu().log() - c[2].log()).abs().median() <= 0.05
    eg, ec = g[4].cpu().double().pow(2).sum(1), c[4].double().pow(2).sum(1)
    assert ((eg / ec) - 1).abs().max() <= 0.05


def test_feature_lane_runs_every_kernel_and_matches_the_cpu_path(cuda):
    fs, L = 16000, 8000
    t = np.arange(L) / fs
    rng = np.random.default_rng(2)
    xs = np.stack([0.5 * np.sin(2 * np.pi * f * t)
                   + 0.2 * np.sin(4 * np.pi * f * t)
                   + 0.01 * rng.standard_normal(L) for f in (150.0, 210.0)])
    kernels.reset_counts()
    g = features.feature_lane(xs, fs)
    torch.cuda.synchronize()
    assert all(kernels.launches[k] > 0 for k in kernels.KERNELS)
    c = features.feature_lane(xs, fs, device="cpu")
    lf0g, lf0c = g[0].cpu(), c[0]
    assert ((lf0g != 0) == (lf0c != 0)).float().mean() >= 0.98
    both = (lf0g != 0) & (lf0c != 0)
    assert (lf0g[both] - lf0c[both]).abs().median() <= 1e-3
    for k in (1, 2, 3):
        assert torch.isfinite(g[k]).all()
        assert (g[k].cpu() - c[k]).abs().median() <= 1e-2
    kernels.reset_counts()
    out = bucketing.bucketed_extract(list(xs[:, :L - 700]) + [xs[0]], fs)
    assert len(out) == 3 and all(np.isfinite(v).all() for r in out for v in r)
    assert all(kernels.launches[k] > 0 for k in
               COPY_SYNTH_KERNELS + ("codec_encode",))
