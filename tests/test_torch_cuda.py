"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

import chip_smoke
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels, vocoder
from hts_train_world_tpu_torch.features import decode, encode, windows
from hts_train_world_tpu_torch.models import hsmm, hsmm_batch
from hts_train_world_tpu_torch.models import hsmm_variants as hvar
from hts_train_world_tpu_torch.ops import cheaptrick as ct
from hts_train_world_tpu_torch.ops import d4c as d4c_mod
from hts_train_world_tpu_torch.ops import dio, fftmat, frames, mlpg, prims
from hts_train_world_tpu_torch.ops import stonemask as sm
from hts_train_world_tpu_torch.ops import harvest as hv
from hts_train_world_tpu_torch.ops import harvest_fix as hf
from hts_train_world_tpu_torch.ops import synthesis as syn
from hts_train_world_tpu_torch.parallel import batch, bucketing, features

pytestmark = pytest.mark.cuda

FFT_KERNELS = ("fft_r2c", "fft_c2r")
SYNTH_KERNELS = ("synth_time_base", "synth_pulse_spectra",
                 "synth_ola") + FFT_KERNELS
BODY_KERNELS = ("cheaptrick_lifter", "d4c_group_delay",
                "d4c_aperiodicity") + FFT_KERNELS
DIO_KERNELS = ("frame_window", "spectral_smooth", "topk_sum", "fix_f0",
               "dio_candidates", "stonemask_if") + BODY_KERNELS
COPY_SYNTH_KERNELS = DIO_KERNELS + SYNTH_KERNELS
FEATURE_LANE_KERNELS = DIO_KERNELS + ("codec_encode", "delta_window",
                                      "mlpg_solve")
HARVEST_KERNELS = ("harvest_decimate", "harvest_candidates", "harvest_detect",
                   "harvest_refine", "harvest_contour")


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


# every width K1 takes on the float32 paths: 48 kHz (2048, 2816, 3712),
# 44.1 kHz (2048, 2560, 3328), 22.05 kHz (1024, 1280, 1664); and 4096,
# the float64 D4C's at 48 kHz
K1_WIDTHS = (1024, 1280, 1664, 2048, 2560, 2816, 3328, 3712, 4096)


@pytest.mark.parametrize("dtype,mode,ratio,parity", [
    (dt, mode, ratio, False) for dt in (torch.float32, torch.float64)
    for mode, ratio in ((frames.MEAN, 4.0), (frames.MEAN_BLACKMAN, 3.0),
                        (frames.CHEAPTRICK, 3.0), (frames.CENTROID, 4.0),
                        (frames.STONEMASK, 0.0))]
    + [(torch.float64, frames.STONEMASK, 0.0, True)])
def test_k1_every_width_mode_and_type(cuda, dtype, mode, ratio, parity):
    """At every main-path width: frames at both ends of an odd-length x
    (windows clamped to x[0] and x[L-1]) and inside it, windows from 3
    samples to the whole row, the rows in order and through `rowutt`
    (utterances out of order); the sum modes with a noise stream (rows
    with a negative offset take none), STONEMASK also with its per-sample
    rounding (float64).  Each row within 1e-5 (float32) or 1e-12
    (float64) of its largest value, the samples past the window 0."""
    fs, B = 48000, 2
    rng = np.random.default_rng(7 * mode + parity)
    L = 4 * 3712 + 1
    x = torch.as_tensor(rng.standard_normal((B, L)), dtype=dtype,
                        device=cuda)
    noise = torch.as_tensor(rng.standard_normal(40000), dtype=dtype,
                            device=cuda)
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    for width in K1_WIDTHS:
        hmax = (width - 1) // 2
        h = np.array([1, hmax, hmax // 2, 37, hmax - 1, 300, hmax, 2] * B)
        origin = np.array([0, L - 1, 1, L - 2, L // 2, hmax + 3, L - hmax,
                           hmax] * B)
        R = h.shape[0]
        f0 = rng.uniform(40.0, 800.0, R)
        pos = origin / fs + rng.uniform(-2e-5, 2e-5, R)
        noff = rng.integers(-1, 30000, R)
        t = {k: torch.as_tensor(v, device=cuda) for k, v in dict(
            h=h, origin=origin, noff=noff).items()}
        f0t, post = (torch.as_tensor(v, dtype=dtype, device=cuda)
                     for v in (f0, pos))
        for rowutt in (None, torch.as_tensor(rng.permutation(R) % B,
                                             device=cuda)):
            kw = dict(pos=post, rowutt=rowutt, parity=parity)
            if mode != frames.STONEMASK:
                kw.update(noise=noise, noff=t["noff"])
            got = frames.frame_windows(x, t["origin"], t["h"], f0t, fs,
                                       ratio, width, mode, **kw)
            want = frames.frame_windows_plain(
                x, t["origin"], t["h"], f0t, post, fs, ratio, width, mode,
                kw.get("noise"), kw.get("noff"), rowutt, parity=parity)
            past = (torch.arange(width, device=cuda)[None, :]
                    > 2 * t["h"][:, None])
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    assert g.dtype == dtype and g.shape == (R, width)
                    assert (g[past] == 0).all()
                    _close_rows(g, w, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_cuts_windows_wider_than_the_row(cuda, dtype):
    """Windows of 2h+1 samples past the row (h from half the width to
    1.5 times it) are cut at the row's end as the twin cuts them, the
    sums taken over the cut row; at a width of whole 16-byte chunks and
    at one that is not (1027), in every mode (STONEMASK also with its
    per-sample rounding in float64): each row within 1e-5 (float32) or
    1e-12 (float64) of its largest value, no row written past its end."""
    fs, B = 48000, 2
    rng = np.random.default_rng(11)
    L = 5 * 2048 + 1
    x = torch.as_tensor(rng.standard_normal((B, L)), dtype=dtype,
                        device=cuda)
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    modes = [(frames.MEAN, 4.0, False), (frames.MEAN_BLACKMAN, 3.0, False),
             (frames.CHEAPTRICK, 3.0, False), (frames.CENTROID, 4.0, False),
             (frames.STONEMASK, 0.0, False)]
    if dtype == torch.float64:
        modes.append((frames.STONEMASK, 0.0, True))
    for width in (2048, 1027):
        h = torch.as_tensor(np.array([width // 2, width - 1, width,
                                      3 * width // 2, 5, width // 2 + 1]
                                     * B), device=cuda)
        R = h.shape[0]
        origin = torch.as_tensor(rng.integers(0, L, R), device=cuda)
        f0 = torch.as_tensor(rng.uniform(40.0, 400.0, R), dtype=dtype,
                             device=cuda)
        pos = origin.to(dtype) / fs
        for mode, ratio, parity in modes:
            got = frames.frame_windows(x, origin, h, f0, fs, ratio, width,
                                       mode, pos=pos, parity=parity)
            want = frames.frame_windows_plain(x, origin, h, f0, pos, fs,
                                              ratio, width, mode,
                                              parity=parity)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    assert g.shape == (R, width)
                    _close_rows(g, w, rel)


def test_k1_k2_plans_are_the_kernels(cuda):
    """`frames.window_plan` and `prims.smooth_plan`, the CPU emulations'
    copies of the launchers' plans, give what the kernels' own plan
    functions (`frame_window_plan`, `spectral_smooth_plan`) give."""
    import ctypes
    import os
    d = kernels.build()
    fw = ctypes.CDLL(os.path.join(d, "libframe_window.so")).frame_window_plan
    ss = ctypes.CDLL(os.path.join(d, "libspectral_smooth.so")
                     ).spectral_smooth_plan
    a, b, c = (ctypes.c_int() for _ in range(3))
    for width in list(range(1, 12000, 7)) + [1024, 2048, 2049, 4096, 8192]:
        fw(width, ctypes.byref(a), ctypes.byref(b))
        assert frames.window_plan(width) == (a.value, b.value), width
    for N in (256, 512, 1024, 2048, 4096, 8192, 16384):
        for b_max in range(0, 1200, 5):
            ok = ss(N, b_max, ctypes.byref(a), ctypes.byref(b),
                    ctypes.byref(c))
            want = prims.smooth_plan(N, b_max)
            assert (want is None) == (not ok), (N, b_max)
            if ok:
                assert want == (a.value, b.value, c.value), (N, b_max)


@pytest.mark.parametrize("fs,N,ul_max,b_max", [(48000, 2048, 173, 114),
                                               (48000, 4096, 344, 342)])
def test_k2_rows_at_every_alignment(cuda, fs, N, ul_max, b_max):
    """n = 1025 and 2049 (CheapTrick's and D4C's rows at 48 kHz) starting
    0-3 floats past a 16-byte boundary (a view into a larger buffer), f0
    from 40 Hz past the ul_max and b_max edges, the fold alone, the
    smoothing alone and both: within `smooth_spectrum_limit` element by
    element, the fold alone bit for bit."""
    n, R = N // 2 + 1, 37
    rng = np.random.default_rng(N)
    fmax = (ul_max - 2) * fs / N
    f0 = np.concatenate([[40.0, fmax - 1.0, fmax, 1.004 * fmax,
                          2 * b_max * fs / N],
                         rng.uniform(60.0, fmax, R - 5)])
    ps = torch.as_tensor(_k2_rows("harmonic", R, n, rng),
                         dtype=torch.float32, device=cuda)
    f0 = torch.as_tensor(f0, dtype=torch.float32, device=cuda)
    width = f0 if N == 4096 else prims.exact_div(f0 * 2.0, 3.0)
    buf = torch.zeros(R * n + 4, dtype=torch.float32, device=cuda)
    for off in range(4):
        p = buf[off:off + R * n].view(R, n)
        p.copy_(ps)
        for dc, ls in ((True, False), (False, True), (True, True)):
            args = dict(f0=f0 if dc else None, ul_max=ul_max,
                        width=width if ls else None, b_max=b_max)
            got = prims.smooth_spectrum(p, fs, N, **args)
            want = prims.smooth_spectrum_plain(p, fs, N, **args)
            limit = prims.smooth_spectrum_limit(p, want, fs, N, **args)
            if not ls:
                assert torch.equal(got, want)
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


@pytest.mark.parametrize("n", [5, 300, 1025, 2049, 2052, 4097, 9000])
def test_k3_threshold_bit_equal_on_adversarial_rows(cuda, n):
    """`chip_smoke.topk_rows` (ties at the k-th value, zeros, denormals,
    +inf and NaN patterns, -0.0 and negatives) at each plan's sizes, k = 1,
    2, 65, n/3, n-1 and n, from a 16-byte aligned base and from one 4
    bytes past it: the threshold bit for bit the twin's, the sum within
    1e-5 relative where finite and the same inf or NaN where not."""
    rows = torch.as_tensor(chip_smoke.topk_rows(n))
    buf = torch.zeros(rows.numel() + 1, dtype=torch.float32, device=cuda)
    for off in (0, 1):
        p = buf[off:off + rows.numel()].view(rows.shape)
        p.copy_(rows)
        for k in sorted({1, 2, min(65, n), max(1, n // 3), max(1, n - 1),
                         n}):
            s, thr = prims.top_k_threshold_sum(p, k)
            s0, thr0 = prims.top_k_threshold_sum_plain(rows, k)
            assert torch.equal(thr.cpu().view(torch.int32),
                               thr0.view(torch.int32))
            s = s.cpu()
            fin = torch.isfinite(s0)
            assert torch.equal(torch.isfinite(s), fin)
            assert torch.equal(torch.isnan(s), torch.isnan(s0))
            assert torch.equal(s[torch.isinf(s0)], s0[torch.isinf(s0)])
            assert ((s[fin] - s0[fin]).abs()
                    <= 1e-5 * s0[fin].abs() + 1e-30).all()


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
    with pytest.raises(ValueError):         # the fast forms are float32's
        prims.smooth_spectrum(ps, 48000, 2048, width=ps[:, 0], b_max=100)
    with pytest.raises(ValueError):         # the parity forms float64's
        prims.smooth_spectrum(ps.float(), 48000, 2048, width=ps[:, 0],
                              b_max=100, parity=True)
    with pytest.raises(ValueError):
        prims.top_k_threshold_sum(ps.float(), 2000)
    with pytest.raises(ValueError):
        windows.expand(ps[None].half())
    with pytest.raises(ValueError):
        mlpg.mlpg(torch.ones((1, 5, 3, 2), device=cuda),
                  torch.ones((1, 5, 3, 2), dtype=torch.float64, device=cuda))
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
    fftmat.table_calls.clear()
    g = batch.batch_copy_synth(xs, fs, noise=noise)
    torch.cuda.synchronize()
    assert all(kernels.launches[k] > 0 for k in COPY_SYNTH_KERNELS)
    assert not fftmat.table_calls         # no table DFT on the card
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
    assert all(kernels.launches[k] > 0 for k in FEATURE_LANE_KERNELS)
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
               DIO_KERNELS + ("codec_encode",))


# ---------------------------------------------------------------------------
# the synth path: K9-K12
# ---------------------------------------------------------------------------


def _contour(T, seed, kind):
    """voiced; with unvoiced runs; or with 500 Hz frames beside unvoiced
    ones and frames below the lowest f0 (phase wraps on sample bounds)."""
    rng = np.random.default_rng(seed)
    f0 = 150.0 + 60.0 * np.sin(np.arange(T) / 7.0 + rng.uniform(0, 3))
    if kind in ("unvoiced", "boundary"):
        f0[T // 3:T // 3 + 8] = 0.0
        f0[-5:] = 0.0
    if kind == "boundary":
        f0[T // 3 - 4:T // 3] = 500.0
        f0[T // 2:T // 2 + 3] = 20.0
    return f0


def _same(a, b):
    """Bit-equal, NaN where NaN (the fill slots' shifts may be any value)."""
    a, b = a.cpu(), b.cpu()
    if a.is_floating_point():
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


@pytest.mark.parametrize("fs,T,B", [(16000, 60, 3), (48000, 30, 3),
                                    (48000, 401, 4)])
@pytest.mark.parametrize("kind", ["voiced", "unvoiced", "boundary"])
def test_k9_kernel_bit_equal_to_cpu_twin(cuda, fs, T, B, kind):
    """Counts, pulse indices, noise sizes and offsets, time shifts, times
    and V/UV flags equal to the twin run on the CPU, bit for bit; the
    count-only launch gives the same counts."""
    N = cfg.cheaptrick_fft_size(fs)
    yl = cfg.y_length_for(T, 5.0, fs)
    P = syn.default_max_pulses(yl, fs)
    f0 = torch.as_tensor(np.stack([_contour(T, s, kind) for s in range(B)]),
                         dtype=torch.float32)
    got = syn.time_base(f0.to(cuda), 5.0, fs, yl, N, P)
    want = syn.time_base_plain(f0, 5.0, fs, yl, N, P)
    for name, g, w in zip(syn.Pulses._fields, got, want):
        assert _same(g, w), name
    assert torch.equal(syn.count_pulses(f0.to(cuda), 5.0, fs, yl, N).cpu(),
                       want.n)
    small = syn.time_base(f0.to(cuda), 5.0, fs, yl, N, 8)   # cap < count
    for g, w in zip(small, syn.time_base_plain(f0, 5.0, fs, yl, N, 8)):
        assert _same(g, w)


def _k9_same_as_cpu(f0, fs, yl, caps):
    """time_base on the card against the twin on the CPU at each cap:
    every field bit for bit."""
    N = cfg.cheaptrick_fft_size(fs)
    for P in caps:
        got = syn.time_base(f0, 5.0, fs, yl, N, P)
        want = syn.time_base_plain(f0.cpu(), 5.0, fs, yl, N, P)
        for name, g, w in zip(syn.Pulses._fields, got, want):
            assert _same(g, w), (P, name)


@pytest.mark.parametrize("fs,yl", [(16000, 1000), (16000, 2048),
                                   (16000, 2049), (48000, 6145),
                                   (48000, 96001)])
def test_k9_tiles_bit_equal_to_cpu_twin(cuda, fs, yl):
    """float32 rows below one tile, at a tile's edge, one sample past it
    and across many tiles, all on the tiled route: every output bit for
    bit against the twin on the CPU at the default cap, a cap below the
    count and P = 0 (the count alone)."""
    T = -(-(yl - 1) * 200 // fs) + 1           # frames that cover yl
    f0 = torch.as_tensor(np.stack([_contour(T, s, k) for s, k in
                                   ((0, "unvoiced"), (1, "voiced"),
                                    (2, "boundary"))]),
                         dtype=torch.float32, device=cuda)
    inc = syn.phase_increments(f0.cpu(), 5.0, fs, yl,
                               cfg.cheaptrick_fft_size(fs))
    assert syn.phase_sum_exact(inc).all()
    _k9_same_as_cpu(f0, fs, yl, (syn.default_max_pulses(yl, fs), 5, 0))


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k9_pulse_on_a_tile_boundary(cuda, fs):
    """At 375 Hz (and 187.5 Hz after the middle) the phase wraps where a
    tile of 2048 samples starts: a pulse at the last sample of a tile,
    its jump read across the tiles' seam, bit for bit."""
    T = 60
    yl = cfg.y_length_for(T, 5.0, fs)
    f0 = torch.full((2, T), 375.0)
    f0[1, T // 2:] = 187.5
    want = syn.time_base_plain(f0, 5.0, fs, yl, cfg.cheaptrick_fft_size(fs),
                               syn.default_max_pulses(yl, fs))
    p = want.pidx[0, :int(want.n[0])]
    assert ((p + 1) % syn.K9_TILE == 0).any()
    _k9_same_as_cpu(f0.to(cuda), fs, yl,
                    (syn.default_max_pulses(yl, fs), 3, 0))


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k9_serial_route_where_tiles_would_not_be_exact(cuda, fs):
    """A frame past its end a contour falling from 119.998 to 40 Hz
    extrapolates through 0 Hz (0.001 Hz at a sample): tiny and negative
    increments fail `phase_sum_exact`, so that row is summed in sequence,
    in the same launch as a row on the tiled route; both bit for bit
    against the twin on the CPU."""
    T = 200
    yl = cfg.y_length_for(T, 5.0, fs) + fs // 200
    f0 = np.stack([_contour(T, 3, "voiced"), _contour(T, 4, "voiced")])
    f0[0, -2:] = (119.998, 40.0)
    f0 = torch.as_tensor(f0, dtype=torch.float32, device=cuda)
    inc = syn.phase_increments(f0.cpu(), 5.0, fs, yl,
                               cfg.cheaptrick_fft_size(fs))
    assert syn.phase_sum_exact(inc).tolist() == [False, True]
    _k9_same_as_cpu(f0, fs, yl, (syn.default_max_pulses(yl, fs), 7, 0))


def _synth_inputs(cuda, fs, T, seed):
    rng = np.random.default_rng(seed)
    N = cfg.cheaptrick_fft_size(fs)
    yl = cfg.y_length_for(T, 5.0, fs)
    P = syn.default_max_pulses(yl, fs)
    freq = np.arange(N // 2 + 1) / N * fs
    sp = np.exp(-freq / 1500.0)[None, None] * (1 + rng.random((2, T, 1)))
    ap = np.clip(freq / (fs / 2) + 0.1 * rng.random((2, T, 1)), 0, 1)
    ap[:, :T // 4, :3] = 0.9995
    f0 = np.stack([_contour(T, s, "unvoiced") for s in (seed, seed + 1)])
    noise = rng.standard_normal((2, syn.synthesis_stream_len(yl)))
    f32 = dict(dtype=torch.float32, device=cuda)
    return ([torch.as_tensor(v, **f32) for v in (f0, sp, ap, noise)], N, yl,
            P)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k10_kernel_matches_plain(cuda, fs):
    """log_p, log_a within 4 ulps (+4 ulps of 1), the noise within 1e-5 of
    the stream's scale, the unvoiced flags equal."""
    (f0, sp, ap, noise), N, yl, P = _synth_inputs(cuda, fs, 40, 1)
    pl = syn.time_base(f0, 5.0, fs, yl, N, P)
    args = (sp, ap, noise, pl.pulse_time, pl.vuv, pl.noise_size,
            pl.noise_off, 5.0, N)
    got = syn.pulse_spectra(*args)
    want = syn.pulse_spectra_plain(*args)
    for g, w, lim in zip(got, want, syn.pulse_spectra_limit(*want[:3],
                                                            noise)):
        assert ((g - w).abs() <= lim).all()
    assert torch.equal(got[3], want[3]) and got[3].any()


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k11_kernel_bit_equal_and_deterministic(cuda, fs):
    """The gather OLA equals the twin's index_add_ run on the CPU bit for
    bit, and two launches give the same waveform."""
    (f0, sp, ap, noise), N, yl, P = _synth_inputs(cuda, fs, 40, 2)
    pl = syn.time_base(f0, 5.0, fs, yl, N, P)
    lp, la, nz, unv = syn.pulse_spectra(sp, ap, noise, pl.pulse_time, pl.vuv,
                                        pl.noise_size, pl.noise_off, 5.0, N)
    per, aper = syn.responses(lp, la, nz, pl.time_shift, fs, N)
    args = (per, aper, unv, pl.pidx, pl.noise_size, pl.n, yl)
    a, b = syn.overlap_add(*args), syn.overlap_add(*args)
    want = syn.overlap_add_plain(*(v.cpu() if torch.is_tensor(v) else v
                                   for v in args))
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want) and want.abs().max() > 0.01


@pytest.mark.parametrize("bap_dim", [24, 25])
def test_k12_kernel_matches_plain(cuda, bap_dim):
    """f0 equal to the CPU twin's (exp in float64, rounded); sp and ap
    within decode_limit of the twin on the card; ap zero past apl."""
    fs = 48000
    N = cfg.cheaptrick_fft_size(fs)
    rng = np.random.default_rng(bap_dim)
    mgc = rng.standard_normal((3, 50, 50)) / (1.0 + np.arange(50)) ** 1.2
    mgc[..., 0] += 13.0
    bap = 0.5 * rng.standard_normal((3, 50, bap_dim)) \
        / (1.0 + np.arange(bap_dim))
    bap[..., 0] -= 2.0
    lf0 = np.log(100.0 + 200.0 * rng.random((3, 50)))
    lf0[:, 10:15] = 0.0
    ins = [torch.as_tensor(v, dtype=torch.float32, device=cuda)
           for v in (lf0, mgc, bap)]
    got = decode.decode_features(*ins, fs, N)
    want = decode.decode_features_plain(*ins, fs, N)
    lim_sp, lim_ap = decode.decode_limit(*ins, fs, N)
    assert torch.equal(got[0].cpu(), decode.decode_features_plain(
        *(v.cpu() for v in ins), fs, N)[0])
    assert ((got[1].log() - want[1].log()).abs() <= lim_sp).all()
    apl = decode.ap_order(bap_dim)
    assert ((got[2][..., :apl].log() - want[2][..., :apl].log()).abs()
            <= lim_ap).all()
    assert (got[2][..., apl:] == 0).all()


def test_synth_lane_and_batch_synth_match_the_cpu_path(cuda):
    """On injected noise: the card's decode gives the CPU's f0 bit for bit,
    both fire the same pulses, and the waveforms agree within 1e-3 of
    their peak; batch_synth on the decoded parameters gives the lane's
    waveform; the lane launches K9-K12."""
    fs, T = 48000, 60
    rng = np.random.default_rng(11)
    mgc = rng.standard_normal((2, T, 50)) / (1.0 + np.arange(50)) ** 1.2
    mgc[..., 0] += 13.0
    bap = 0.5 * rng.standard_normal((2, T, 25)) / (1.0 + np.arange(25))
    bap[..., 0] -= 2.0
    lf0 = np.log(np.stack([_contour(T, s, "voiced") for s in (0, 1)]))
    lf0[1, 20:30] = 0.0
    yl = cfg.y_length_for(T, 5.0, fs)
    noise = rng.standard_normal((2, syn.synthesis_stream_len(yl)))
    kernels.reset_counts()
    yg = features.synth_lane(lf0, mgc, bap, fs, noise=noise)
    torch.cuda.synchronize()
    assert all(kernels.launches[k] > 0
               for k in SYNTH_KERNELS + ("codec_decode",))
    yc = features.synth_lane(lf0, mgc, bap, fs, noise=noise, device="cpu")
    N = cfg.cheaptrick_fft_size(fs)
    fg = decode.decode_features(*(torch.as_tensor(
        v, dtype=torch.float32, device=cuda) for v in (lf0, mgc, bap)), fs,
        N)
    fc = decode.decode_features(*(torch.as_tensor(v, dtype=torch.float32)
                                  for v in (lf0, mgc, bap)), fs, N)
    assert torch.equal(fg[0].cpu(), fc[0])
    P = syn.default_max_pulses(yl, fs)
    pg = syn.time_base(fg[0], 5.0, fs, yl, N, P)
    pc = syn.time_base(fc[0], 5.0, fs, yl, N, P)
    assert torch.equal(pg.pidx.cpu(), pc.pidx) and torch.equal(pg.n.cpu(),
                                                               pc.n)
    assert ((yg.cpu() - yc).abs().max() <= 1e-3 * yc.abs().max())
    bg = batch.batch_synth(*fg, fs, noise=noise)
    bc = batch.batch_synth(*fc, fs, noise=noise, device="cpu")
    assert torch.equal(bc, yc)
    assert (bg - yg).abs().max() <= 1e-6 * yg.abs().max()


def test_synth_wrappers_reject_what_the_kernels_do_not_take(cuda):
    f0 = torch.full((2, 10), 150.0, device=cuda)
    with pytest.raises(ValueError):
        syn.time_base(f0.half(), 5.0, 16000, 800, 1024, 32)
    with pytest.raises(ValueError):
        syn.time_base(f0[:, :1], 5.0, 16000, 800, 1024, 32)
    pl = syn.time_base(f0, 5.0, 16000, 721, 1024, 32)
    sp = torch.ones((2, 10, 513), device=cuda)
    noise = torch.zeros((2, 737), device=cuda)
    with pytest.raises(ValueError):
        syn.pulse_spectra(sp, sp[..., :512], noise, pl.pulse_time, pl.vuv,
                          pl.noise_size, pl.noise_off, 5.0, 1024)
    with pytest.raises(ValueError):
        syn.pulse_spectra(sp, sp, noise, pl.pulse_time, pl.vuv,
                          pl.noise_size.int(), pl.noise_off, 5.0, 1024)
    with pytest.raises(ValueError):
        syn.pulse_spectra(sp, sp, noise.cpu(), pl.pulse_time, pl.vuv,
                          pl.noise_size, pl.noise_off, 5.0, 1024)
    with pytest.raises(ValueError):      # the exact path is float64
        syn.pulse_spectra(sp, sp, noise, pl.pulse_time, pl.vuv,
                          pl.noise_size, pl.noise_off, 5.0, 1024, exact=True)
    resp = torch.zeros((2, 32, 1024), device=cuda)
    unv = torch.zeros((2, 32), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        syn.overlap_add(resp, resp.double(), unv, pl.pidx, pl.noise_size,
                        pl.n, 721)
    with pytest.raises(ValueError):
        syn.overlap_add(resp, resp, unv.float(), pl.pidx, pl.noise_size,
                        pl.n, 721)
    lf0 = torch.zeros((2, 10), device=cuda)
    with pytest.raises(ValueError):
        decode.decode_features(lf0, torch.zeros((2, 9, 50), device=cuda),
                               torch.zeros((2, 10, 25), device=cuda), 16000,
                               1024)
    with pytest.raises(ValueError):
        decode.decode_features(lf0.double(), torch.zeros((2, 10, 50),
                                                         device=cuda),
                               torch.zeros((2, 10, 25), device=cuda), 16000,
                               1024)


# ---------------------------------------------------------------------------
# the parity path: K9-K12 and K30 in float64, K9's chunk mode
# ---------------------------------------------------------------------------


def _parity_inputs(cuda, fs, T, kind="unvoiced", B=2, seed=0):
    """float64 f0 / sp / ap on the card (ap at its clip near Nyquist) and
    the reseeded stream's prefix."""
    from hts_train_world_tpu_torch.ops import rand
    rng = np.random.default_rng(seed)
    N = cfg.cheaptrick_fft_size(fs)
    yl = cfg.y_length_for(T, 5.0, fs)
    freq = np.arange(N // 2 + 1) / N * fs
    sp = np.exp(-freq / 1500.0)[None, None] * (1 + rng.random((B, T, 1)))
    ap = np.clip(freq / (fs / 2) + 0.1 * rng.random((B, T, 1)), 0, 1)
    f0 = np.stack([_contour(T, seed + s, kind) for s in range(B)])
    f64 = dict(dtype=torch.float64, device=cuda)
    stream = rand.randn_stream(syn.synthesis_stream_len(yl), cuda)
    return ([torch.as_tensor(v, **f64) for v in (f0, sp, ap)], stream, N,
            yl)


@pytest.mark.parametrize("fs,T", [(16000, 60), (44100, 401), (48000, 401)])
@pytest.mark.parametrize("kind", ["voiced", "unvoiced", "boundary"])
def test_k9_float64_bit_equal_to_cpu_twin(cuda, fs, T, kind):
    """The float64 instantiation: counts, pulses and every per-pulse value
    equal to the twin run on the CPU (the JAX exact path's left fold)."""
    (f0, _, _), _, N, yl = _parity_inputs(cuda, fs, T, kind, B=3)
    P = syn.default_max_pulses(yl, fs)
    got = syn.time_base(f0, 5.0, fs, yl, N, P)
    want = syn.time_base_plain(f0.cpu(), 5.0, fs, yl, N, P)
    for name, g, w in zip(syn.Pulses._fields, got, want):
        assert _same(g, w), name


@pytest.mark.parametrize("fs,chunk", [(16000, 64), (16000, 2000),
                                      (48000, 1024)])
def test_k9_chunk_mode_matches_cpu_twin_over_an_utterance(cuda, fs, chunk):
    """Chunk by chunk over a whole utterance with unvoiced runs, the card
    and the CPU twin give the same pulses, per-pulse values and carried
    state, bit for bit."""
    (f0, _, _), _, N, yl = _parity_inputs(cuda, fs, 80, "boundary", B=1)
    P = int(chunk * 1200.0 / fs) + 18
    sk, sc = syn.chunk_state(cuda), syn.chunk_state("cpu")
    for s0 in range(0, yl - chunk, chunk):
        got = syn.chunk_pulses(f0[0], s0, chunk, P, 5.0, fs, N, *sk)
        want = syn.chunk_pulses_plain(f0[0].cpu(), s0, chunk, P, 5.0, fs, N,
                                      *sc)
        for name, g, w in zip(syn.ChunkPulses._fields, got, want):
            assert _same(g, w), (s0, name)
        assert _same(sk[0], sc[0]) and _same(sk[1], sc[1])


def test_parity_kernels_match_their_twins(cuda):
    """One exact-path synthesis at 48 kHz: K10 (float64, fma lerps)
    within 4 float64 ulps of the logs' magnitude (+4 ulps of 1), the
    noise within 1e-12 of the stream's scale, flags equal; K30 within
    1e-12 of the spectra's magnitude; K11 bit-equal to the twin's
    index_add_ on the CPU, and in accumulate mode over a window."""
    (f0, sp, ap), stream, N, yl = _parity_inputs(cuda, 48000, 60)
    B = f0.shape[0]
    pl = syn.trim_pulses(syn.time_base(f0, 5.0, 48000, yl, N,
                                       syn.default_max_pulses(yl, 48000)))
    args = (sp, ap, stream[None].expand(B, -1), pl.pulse_time, pl.vuv,
            pl.noise_size, pl.noise_off, 5.0, N, True)
    got = syn.pulse_spectra(*args)
    want = syn.pulse_spectra_plain(*args)
    eps = torch.finfo(torch.float64).eps
    for g, w in zip(got[:2], want[:2]):
        assert ((g - w).abs() <= 4 * eps * (w.abs() + 1.0)).all()
    assert ((got[2] - want[2]).abs() <= 1e-12 * 6.0).all()
    assert torch.equal(got[3], want[3])
    lp, la, nz, unv = want
    coef = prims.exact_div(2.0 * np.pi * pl.time_shift * 48000, N)
    lpr, lpi = prims.minimum_phase_log(lp, N)
    lar, lai = prims.minimum_phase_log(la, N)
    ns = torch.fft.rfft(nz, dim=-1)
    ins = (lpr, lpi, lar, lai, ns.real.contiguous(), ns.imag.contiguous(),
           coef)
    gk, gp = syn.midpass(*ins), syn.midpass_plain(*ins)
    ms = lpr.exp()
    mp = lar.exp() * (ins[4].abs() + ins[5].abs())
    for k, p, m in zip(gk, gp, (ms, ms, mp, mp)):
        assert ((k - p).abs() <= 1e-12 * m).all()
    per, aper = syn.responses_exact(lp, la, nz, pl.time_shift, 48000, N)
    oargs = (per, aper, unv, pl.pidx, pl.noise_size, pl.n, yl)
    a = syn.overlap_add(*oargs)
    cpu = [v.cpu() if torch.is_tensor(v) else v for v in oargs]
    assert torch.equal(a.cpu(), syn.overlap_add_plain(*cpu))
    acc = torch.randn((B, 3000), dtype=torch.float64, device=cuda)
    want_acc = syn.overlap_add_plain(*cpu[:6], 3000, 5000, acc.cpu().clone())
    syn.overlap_add(*oargs[:6], 3000, 5000, acc)
    assert torch.equal(acc.cpu(), want_acc)


@pytest.mark.parametrize("bap_dim", [24, 25])
def test_k12_float64_kernel_matches_plain(cuda, bap_dim):
    """The float64 decode: f0 within an ulp of the CPU twin's (CUDA's exp
    and the CPU's may part by one); sp and ap within 1e-12 relative of the
    twin (the composed W and the IDCT sums round in another order); ap
    zero past apl."""
    rng = np.random.default_rng(bap_dim)
    mgc = rng.standard_normal((3, 50, 50)) / (1.0 + np.arange(50)) ** 1.2
    mgc[..., 0] += 13.0
    bap = 0.5 * rng.standard_normal((3, 50, bap_dim)) \
        / (1.0 + np.arange(bap_dim))
    bap[..., 0] -= 2.0
    lf0 = np.log(100.0 + 200.0 * rng.random((3, 50)))
    lf0[:, 10:15] = 0.0
    ins = [torch.as_tensor(v, dtype=torch.float64, device=cuda)
           for v in (lf0, mgc, bap)]
    got = decode.decode_features(*ins, 48000, 2048)
    want = decode.decode_features_plain(*(v.cpu() for v in ins), 48000, 2048)
    eps = torch.finfo(torch.float64).eps
    assert ((got[0].cpu() - want[0]).abs() <= eps * want[0].abs()).all()
    apl = decode.ap_order(bap_dim)
    for g, w in ((got[1], want[1]), (got[2][..., :apl], want[2][..., :apl])):
        assert ((g.cpu() - w).abs() <= 1e-12 * w.abs()).all()
    assert (got[2][..., apl:] == 0).all()


def test_parity_synthesis_and_streaming_match_the_cpu_path(cuda):
    """vocoder.synthesize(parity=True) on the card fires the CPU path's
    pulses and its waveform is within 1e-10 of the CPU's; the streaming
    synthesizer's stream on the card is within 1e-10 of both."""
    from hts_train_world_tpu_torch import vocoder
    from hts_train_world_tpu_torch.ops import rand
    from hts_train_world_tpu_torch.ops.synthesis_rt import (
        StreamingSynthesizer)
    (f0, sp, ap), _, N, yl = _parity_inputs(cuda, 16000, 80, "boundary",
                                            B=1)
    kernels.reset_counts()
    y = vocoder.synthesize(f0[0], sp[0], ap[0], 16000, N, device="cuda")
    for k in ("synth_time_base[f64]", "synth_pulse_spectra[f64]",
              "synth_midpass[f64]", "synth_ola[f64]"):
        assert kernels.launches[k] == 1, k
    c = vocoder.synthesize(f0[0].cpu(), sp[0].cpu(), ap[0].cpu(), 16000, N,
                           device="cpu")
    assert float((y.cpu() - c).abs().max()) <= 1e-10
    s = StreamingSynthesizer(16000, 5.0, N, buffer_size=256, device=cuda,
                             noise_stream=rand.randn_stream(yl + 16, cuda))
    s.add_parameters(f0[0], sp[0], ap[0])
    out = []
    while not s.starved:
        out.append(s.read())
    st = torch.cat(out).cpu()
    assert len(st) > yl // 2
    assert float((st - c[:len(st)]).abs().max()) <= 1e-10


# ---------------------------------------------------------------------------
# the Harvest lane: K13-K16, K32; in float64 the parity analysis' Harvest
# ---------------------------------------------------------------------------


def _voices(fs, n, kinds=("voice", "voice", "noise", "silence"), seed=0):
    """Rows of harmonic voices (170 and 230 Hz, 2 % vibrato, a pause in the
    first), wideband noise, a click train or silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    rows = []
    for i, kind in enumerate(kinds):
        x = np.zeros(n)
        if kind == "voice":
            f = 170.0 + 60.0 * (i % 2)
            ph = 2 * np.pi * np.cumsum(
                f * (1 + 0.02 * np.sin(2 * np.pi * 5.5 * t))) / fs
            x = sum(a * np.sin((h + 1) * ph)
                    for h, a in enumerate([0.5, 0.3, 0.15, 0.08]))
            x = 0.7 * x / np.abs(x).max() + 0.005 * rng.standard_normal(n)
            if i == 0:
                x[n // 2:n // 2 + n // 8] *= 0.01
        elif kind == "noise":
            x = 0.5 * rng.standard_normal(n)
        elif kind == "clicks":
            x[::fs // 50] = 0.9
        rows.append(x)
    return np.stack(rows)


def _front(cuda, fs, n, kinds=("voice", "voice", "noise", "silence"),
           dtype=torch.float32):
    """The plain front on the card: decimated rows, filtered bands, raw
    candidates and the spread candidate field of each row, in `dtype`."""
    xs = torch.as_tensor(_voices(fs, n, kinds), dtype=dtype, device=cuda)
    plan = hv.harvest_plan(n, fs, 71.0, 800.0)
    T1 = cfg.samples_for_dio(fs, n, 1.0)
    lag = int(np.ceil(140.0 / plan["ratio"]) * plan["ratio"])
    ext = torch.cat([xs[:, :1].expand(-1, lag), xs,
                     xs[:, -1:].expand(-1, lag)], dim=1)
    y = prims.decimate_plain(ext, plan["ratio"])
    y = y[:, lag // plan["ratio"]:lag // plan["ratio"] + plan["y_length"]]
    y = y - y.mean(dim=1, keepdim=True)
    filt = hv.band_filter(y, plan)
    raw = hv.raw_candidates_plain(filt, plan, 71.0, 800.0, T1)
    cands, nc = hv.detect_candidates(raw, plan["nc_pad"])
    return dict(xs=xs, ext=ext, plan=plan, T1=T1, y=y.contiguous(),
                filt=filt, raw=raw, cands=hv.overlap_candidates(cands, nc),
                nc=nc)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k13_kernel_matches_plain(cuda, fs):
    """Voices, noise, clicks and silence: within 1e-6 of each row's peak
    (both run the recurrence in float64; the kernel's chunk scan reorders
    it); the C's output count."""
    n = fs // 2
    x = torch.as_tensor(_voices(fs, n, ("voice", "noise", "clicks",
                                        "silence")), dtype=torch.float32,
                        device=cuda)
    r = hv.harvest_plan(n, fs, 71.0, 800.0)["ratio"]
    got = prims.decimate(x, r)
    want = prims.decimate_plain(x, r)
    assert got.shape == want.shape == (4, prims.decimate_count(n, r))
    peak = want.abs().amax(1, keepdim=True)
    assert ((got - want).abs() <= 1e-6 * peak + 1e-30).all()
    assert (got[3] == 0).all()


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k14_kernel_matches_plain(cuda, fs):
    """Crossing positions and counts identical to the twin's; candidates
    no further from the float64 interp1 of those crossings than the twin's
    (+1e-6 relative); zero/nonzero agreement >= 0.999; the silent row all
    zero."""
    f = _front(cuda, fs, fs // 2)
    plan, T1 = f["plan"], f["T1"]
    got = hv.raw_candidates(f["filt"], plan, 71.0, 800.0, T1, crossings=True)
    want = hv.raw_candidates_plain(f["filt"], plan, 71.0, 800.0, T1,
                                   crossings=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert (got[0][3] == 0).all()
    ref = hv.crossing_candidates_f64(f["filt"], plan, T1, want[1], want[2])
    both = (got[0] > 0) & (want[0] > 0)
    assert both.float().mean() > 0.02
    rel_k = ((got[0].double() - ref).abs() / ref)[both].max()
    rel_p = ((want[0].double() - ref).abs() / ref)[both].max()
    assert rel_k <= rel_p + 1e-6
    assert ((got[0] > 0) == (want[0] > 0)).float().mean() >= 0.999


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k15_kernel_matches_plain(cuda, fs):
    """On a batch whose rows have different candidate counts: refined f0
    within 1e-5 relative where both are nonzero, flips under 0.2 % of the
    nonzero pairs.  A score is 1 / (mean relative harmonic error), whose
    weak harmonics read an ill-conditioned IF; against the float64 twin,
    the kernel's error in that mean is no worse than 1.5x the f32 twin's
    at the median and the 99th percentile."""
    f = _front(cuda, fs, fs // 2)
    assert len(set(f["nc"].tolist())) > 1
    args = (f["plan"]["actual_fs"], 71.0, 800.0)
    gr, gs = hv.refine(f["y"], f["cands"], *args)
    wr, ws = hv.refine_plain(f["y"], f["cands"], *args)
    both = (gr > 0) & (wr > 0)
    assert both.sum() > 100
    assert ((gr > 0) != (wr > 0)).sum() <= 0.002 * (wr > 0).sum()
    assert ((gr - wr).abs() <= 1e-5 * wr)[both].all()
    ref = hv.refine_plain(f["y"].double(), f["cands"].double(), *args)[1]
    live = both & (ref > 0)
    e_k = (1.0 / gs[live].double() - 1.0 / ref[live]).abs()
    e_p = (1.0 / ws[live].double() - 1.0 / ref[live]).abs()
    for q in (0.5, 0.99):
        assert e_k.quantile(q) <= 1.5 * e_p.quantile(q) + 1e-9


def _fields(cuda, B=4, T=300, NC=21, seed=0):
    """Candidate and score fields shaped like the refiner's output: voiced
    stretches near a base contour with dropouts and outliers, one
    utterance all zero."""
    rng = np.random.default_rng(seed)
    c = np.zeros((B, T, NC))
    s = np.zeros((B, T, NC))
    for b in range(B - 1):
        t0 = 0
        while t0 < T - 10:
            seg = int(rng.integers(5, 80))
            if rng.random() < 0.35:
                t0 += seg
                continue
            base = rng.uniform(80, 700)
            for t in range(t0, min(T, t0 + seg)):
                k = int(rng.integers(1, NC + 1))
                v = base * (1 + 0.01 * rng.standard_normal(k))
                if rng.random() < 0.1:
                    v[rng.integers(0, k)] *= rng.uniform(1.5, 3.0)
                c[b, t, :k] = np.abs(v)
                s[b, t, :k] = rng.uniform(2.5, 60.0, k)
                drop = rng.random(NC) < 0.2
                c[b, t, drop] = 0.0
                s[b, t, drop] = 0.0
            t0 += seg + int(rng.integers(1, 12))
    f32 = dict(dtype=torch.float32, device=cuda)
    return torch.as_tensor(c, **f32), torch.as_tensor(s, **f32)


@pytest.mark.parametrize("source", ["fields", "refined16", "refined48"])
def test_k16_kernel_matches_plain(cuda, source):
    """V/UV equal to the twin's, f0 within 1e-5 relative; the all-zero
    utterance (no section: FixStep3 returns its input) all zero."""
    if source == "fields":
        c, s = _fields(cuda)
    else:
        fs = 16000 if source == "refined16" else 48000
        f = _front(cuda, fs, fs // 2)
        c, s = hv.refine_plain(f["y"], f["cands"], f["plan"]["actual_fs"],
                               71.0, 800.0)
    got = hf.contour(c, s)
    want = hf.contour_plain(c, s)
    assert (want > 0).float().mean() > 0.05
    assert torch.equal(got > 0, want > 0)
    assert ((got - want).abs() <= 1e-5 * want.abs()).all()
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("name", ["silence", "clicks", "noise"])
def test_harvest_lane_on_hostile_inputs(cuda, name):
    """Silence, click trains and noise through the card's Harvest lane:
    finite, sp > 0, ap within [0, 1]."""
    fs, n = 16000, 4800
    x = _voices(fs, n, (name, "voice"))
    _, f0, sp, ap = batch.batch_analyze(x, fs, algorithm="harvest")
    for v in (f0, sp, ap):
        assert torch.isfinite(v).all()
    assert (sp > 0).all() and (ap >= 0).all() and (ap <= 1).all()
    if name == "silence":
        assert (f0[0] == 0).all()


def test_harvest_lane_runs_the_kernels_and_matches_the_cpu_path(cuda):
    """2 x 0.5 s at 48 kHz: K13-K16 launched; V/UV agreement >= 0.95, f0
    median relative difference < 1e-3, sp median |dlog| < 0.1 against the
    CPU path; bucketed_extract and batch_copy_synth take Harvest."""
    fs, n = 48000, 24000
    xs = _voices(fs, n, ("voice", "voice"))
    kernels.reset_counts()
    g = batch.batch_analyze(xs, fs, algorithm="harvest")
    torch.cuda.synchronize()
    assert all(kernels.launches[k] > 0 for k in HARVEST_KERNELS
               + BODY_KERNELS)
    assert kernels.launches["fix_f0"] == kernels.launches["stonemask_if"] == 0
    c = batch.batch_analyze(xs, fs, algorithm="harvest", device="cpu")
    f0g, f0c = g[1].cpu(), c[1]
    assert ((f0g > 0) == (f0c > 0)).float().mean() >= 0.95
    both = (f0g > 0) & (f0c > 0)
    assert ((f0g[both] - f0c[both]).abs() / f0c[both]).median() < 1e-3
    assert (g[2].cpu().log() - c[2].log()).abs().median() < 0.1
    out = bucketing.bucketed_extract([xs[0, :20000], xs[1]], fs,
                                     algorithm="harvest")
    assert all(np.isfinite(v).all() for r in out for v in r)
    y = batch.batch_copy_synth(xs, fs, algorithm="harvest", seed=1)[4]
    assert torch.isfinite(y).all()


def test_harvest_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """Float32 and float64 are taken; other dtypes, mixed dtypes, a ratio
    past 12, a plan's wrong channel count and T < 3 are refused."""
    x = torch.zeros((2, 4000), device=cuda)
    with pytest.raises(ValueError):
        prims.decimate(x.half(), 6)
    with pytest.raises(ValueError):
        prims.decimate(x, 13)
    plan = hv.harvest_plan(4000, 16000, 71.0, 800.0)
    with pytest.raises(ValueError):
        hv.raw_candidates(torch.zeros((2, 3, plan["fft_size"]), device=cuda),
                          plan, 71.0, 800.0, 251)
    with pytest.raises(ValueError):
        hv.raw_candidates(torch.zeros((2, plan["n_ch"], plan["fft_size"]),
                                      dtype=torch.float16, device=cuda),
                          plan, 71.0, 800.0, 251)
    with pytest.raises(ValueError):
        hv.detect_overlap(torch.zeros((2, 10, 7), dtype=torch.float16,
                                      device=cuda), 7)
    with pytest.raises(ValueError):
        hv.refine(x[:1], torch.zeros((2, 10, 7), device=cuda), 8000.0, 71.0,
                  800.0)
    with pytest.raises(ValueError):
        hv.refine(x.double(), torch.zeros((2, 10, 7), device=cuda), 8000.0,
                  71.0, 800.0)
    with pytest.raises(ValueError):
        hf.contour(torch.zeros((2, 2, 7), device=cuda),
                   torch.zeros((2, 2, 7), device=cuda))
    with pytest.raises(ValueError):
        hf.contour(torch.zeros((2, 9, 7), device=cuda),
                   torch.zeros((2, 9, 7), dtype=torch.float64, device=cuda))


def _raw_fields(cuda, dtype, B=3, n_ch=152, T=120, seed=32):
    """Random raw candidate fields (B, n_ch, T): a share of the channels
    voiced at random with clean runs of 11-40 channels injected, so the
    frames' candidate counts differ; the last utterance all zero."""
    rng = np.random.default_rng(seed)
    raw = np.where(rng.random((B, n_ch, T)) < 0.5,
                   rng.uniform(60, 800, (B, n_ch, T)), 0.0)
    for b in range(B - 1):
        for _ in range(6 + 3 * b):
            a = int(rng.integers(1, n_ch - 41))
            t0 = int(rng.integers(0, T - 20))
            raw[b, a:a + int(rng.integers(11, 41)), t0:t0 + 20] = \
                rng.uniform(100, 700)
    raw[-1] = 0.0
    return torch.as_tensor(raw, dtype=dtype, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("source", ["fields", "front16", "front48"])
def test_k32_kernel_matches_plain(cuda, dtype, source):
    """Detection and overlap: the counts equal the twin's; the spread field
    bit for bit the twin's on the CPU (both sum a run's channels in
    sequence), and on the card within 1e-12 relative of the twin (its
    cumsum is a parallel scan) in float64, one float32 rounding in
    float32; given the twin's detection, the overlap bit for bit."""
    if source == "fields":
        raw = _raw_fields(cuda, dtype)
    else:
        fs = 16000 if source == "front16" else 48000
        raw = _front(cuda, fs, fs // 2, dtype=dtype)["raw"]
    nc_pad = hv.harvest_plan(8000, 16000, 71.0, 800.0)["nc_pad"]
    got, nc = hv.detect_overlap(raw, nc_pad)
    want, nc_p = hv.detect_overlap_plain(raw, nc_pad)
    cpu, nc_c = hv.detect_overlap_plain(raw.cpu(), nc_pad)
    assert got.dtype == dtype and torch.equal(nc.cpu(), nc_p.cpu())
    assert torch.equal(nc.cpu(), nc_c) and len(set(nc.tolist())) > 1
    assert torch.equal(got.cpu(), cpu)
    assert torch.equal(got > 0, want > 0) and (got > 0).any()
    ulp = 1e-12 if dtype == torch.float64 else 2.0 ** -23
    assert ((got - want).abs() <= ulp * want.abs()).all()
    dets, _ = hv.detect_candidates(raw, nc_pad)
    assert torch.equal(hv.overlap_candidates(dets, nc_p),
                       hv.overlap_candidates(dets, nc))


@pytest.mark.parametrize("fs", [16000, 44100])
def test_k13_float64_kernel_matches_plain(cuda, fs):
    """Float64 rows of voices, noise, clicks and silence: within 1e-12 of
    each row's peak (the kernel's chunk scan reorders the twin's block
    recurrence), float64 out, the C's output count."""
    n = fs // 2
    x = torch.as_tensor(_voices(fs, n, ("voice", "noise", "clicks",
                                        "silence")), dtype=torch.float64,
                        device=cuda)
    r = hv.harvest_plan(n, fs, 71.0, 800.0)["ratio"]
    kernels.reset_counts()
    got = prims.decimate(x, r)
    assert kernels.launches["harvest_decimate[f64]"] == 1
    want = prims.decimate_plain(x, r)
    assert got.dtype == torch.float64
    assert got.shape == want.shape == (4, prims.decimate_count(n, r))
    peak = want.abs().amax(1, keepdim=True)
    assert ((got - want).abs() <= 1e-12 * peak + 1e-300).all()
    assert (got[3] == 0).all()


@pytest.mark.parametrize("fs", [16000, 44100])
def test_k14_float64_kernel_matches_plain(cuda, fs):
    """Float64 bands: crossing positions and counts identical to the
    twin's, the same zero pattern, candidates within 1e-12 relative (the
    same IEEE divisions and interpolation as the twin); the silent row
    all zero."""
    f = _front(cuda, fs, fs // 2, dtype=torch.float64)
    plan, T1 = f["plan"], f["T1"]
    got = hv.raw_candidates(f["filt"], plan, 71.0, 800.0, T1, crossings=True)
    want = hv.raw_candidates_plain(f["filt"], plan, 71.0, 800.0, T1,
                                   crossings=True)
    assert got[0].dtype == torch.float64
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(got[0] > 0, want[0] > 0) and (got[0] > 0).any()
    assert ((got[0] - want[0]).abs() <= 1e-12 * want[0].abs()).all()
    assert (got[0][3] == 0).all()


@pytest.mark.parametrize("fs", [16000, 44100])
def test_k15_float64_kernel_matches_plain(cuda, fs):
    """Float64, on a batch whose rows have different candidate counts:
    refined f0 within 1e-9 relative where both are nonzero, flips at most
    1 in 10^3 of the nonzero pairs, and the mean relative harmonic error
    (1 / score) within 1e-9 of the twin's (the bins' sums run in another
    order)."""
    f = _front(cuda, fs, fs // 2, dtype=torch.float64)
    assert len(set(f["nc"].tolist())) > 1
    args = (f["plan"]["actual_fs"], 71.0, 800.0)
    gr, gs = hv.refine(f["y"], f["cands"], *args)
    wr, ws = hv.refine_plain(f["y"], f["cands"], *args)
    assert gr.dtype == torch.float64
    both = (gr > 0) & (wr > 0)
    assert both.sum() > 100
    assert ((gr > 0) != (wr > 0)).sum() <= 0.001 * (wr > 0).sum()
    assert ((gr - wr).abs() <= 1e-9 * wr)[both].all()
    assert (1.0 / gs[both] - 1.0 / ws[both]).abs().max() <= 1e-9


@pytest.mark.parametrize("source", ["fields", "refined16", "refined44"])
def test_k16_float64_kernel_matches_plain(cuda, source):
    """Float64 fields: V/UV equal to the twin's, f0 within 1e-9 relative
    (the smoothing's recurrence runs in another order); the all-zero
    utterance all zero."""
    if source == "fields":
        c, s = (v.double() for v in _fields(cuda))
    else:
        fs = 16000 if source == "refined16" else 44100
        f = _front(cuda, fs, fs // 2, dtype=torch.float64)
        c, s = hv.refine_plain(f["y"], f["cands"], f["plan"]["actual_fs"],
                               71.0, 800.0)
    got = hf.contour(c, s)
    want = hf.contour_plain(c, s)
    assert got.dtype == torch.float64
    assert (want > 0).float().mean() > 0.05
    assert torch.equal(got > 0, want > 0)
    assert ((got - want).abs() <= 1e-9 * want.abs()).all()
    assert (got[-1] == 0).all()


PARITY_HARVEST = tuple(f"{k}[f64]" for k in HARVEST_KERNELS)


@pytest.mark.parametrize("name", ["silence", "clicks", "noise"])
def test_parity_harvest_on_hostile_inputs(cuda, name):
    """Silence, click trains and noise through the parity analysis with
    Harvest (float64, `parity_stages(algorithm="harvest")`): K13-K16 and
    K32 in float64 launched; finite, sp > 0, ap within [0, 1], float64
    positions; silence all unvoiced."""
    fs, n = 16000, 4800
    x = torch.as_tensor(_voices(fs, n, (name, "voice")), dtype=torch.float64,
                        device=cuda)
    kernels.reset_counts()
    *_, (_, (t, f0, sp, ap)) = batch.parity_stages(x, fs, algorithm="harvest")
    torch.cuda.synchronize()
    assert all(kernels.launches[k] > 0 for k in PARITY_HARVEST)
    assert t.dtype == f0.dtype == torch.float64
    for v in (f0, sp, ap):
        assert torch.isfinite(v).all()
    assert (sp > 0).all() and (ap >= 0).all() and (ap <= 1).all()
    if name == "silence":
        assert (f0[0] == 0).all()
    assert (f0[1] > 0).float().mean() > 0.5


@pytest.mark.parametrize("fs,dur", [(16000, 0.4), (44100, 0.2)])
def test_parity_harvest_analysis_card_matches_cpu(cuda, fs, dur):
    """`vocoder.analyze(algorithm="harvest")` at its default on the card
    and on the CPU: t equal, the same voicing, f0 within 1e-9 relative, sp
    within 1.5e-8 relative, ap within 1e-9 (the bounds the CPU tests hold
    against the JAX package)."""
    x = _voices(fs, int(fs * dur), ("voice",))[0]
    a = vocoder.analyze(x, fs, algorithm="harvest")
    b = vocoder.analyze(x, fs, algorithm="harvest", device="cpu")
    assert torch.equal(a.temporal_positions.cpu(), b.temporal_positions)
    assert torch.equal(a.f0.cpu() > 0, b.f0 > 0) and (b.f0 > 0).any()

    def rel(u, v):
        u = u.cpu()
        return ((u - v).abs() / v.abs().clamp(min=1e-300))[u != v]

    for got, want, tol in ((a.f0, b.f0, 1e-9),
                           (a.spectrogram, b.spectrogram, 1.5e-8)):
        r = rel(got, want)
        assert r.numel() == 0 or r.max() <= tol
    assert (a.aperiodicity.cpu() - b.aperiodicity).abs().max() <= 1e-9


# ---------------------------------------------------------------------------
# HSMM EM (K17-K19)
# ---------------------------------------------------------------------------


def _estep_batch(cuda, utts, ms):
    """One padded batch of the corpus on the card, as corpus_estep pads
    it, with the gathered inputs of K17 and K18."""
    chained, _ = hsmm_batch.chain_modelset(ms, utts)
    tables = hsmm_batch.tables_from_modelset(ms)
    names = [st.name for st in ms.streams]
    Tb = max(len(u.frames) for u in chained)
    Kb = max(len(u.dur_rows) for u in chained)
    fr, rows, dr, tl, kl, _ = hsmm_batch._pad_group(chained, Tb, Kb, 10,
                                                    names)

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=cuda)
    means = tuple(t(tables.means[n]) for n in names)
    vars_ = tuple(t(tables.vars[n]) for n in names)
    msd_w = tuple(t(tables.msd_w[n]) if st.msd else t(np.zeros(1))
                  for n, st in zip(names, ms.streams))
    dr = t(dr, torch.long)
    return dict(frames=t(fr), rows=tuple(t(rows[n], torch.long)
                                         for n in names),
                means=means, variances=vars_, msd_w=msd_w,
                args=hsmm.stream_args(ms.streams),
                dm=t(tables.dur_mean)[dr], dv=t(tables.dur_var)[dr],
                t_len=t(tl, torch.long), k_len=t(kl, torch.long))


def test_k17_kernel_matches_plain(cuda):
    rng = np.random.default_rng(17)
    sts = hsmm.world_streams()
    B, Tb, Kb, R, D = 3, 37, 21, 30, 237
    fr = rng.standard_normal((B, Tb, D))
    fr[:, ::3, 150:156] = 0.0            # unvoiced frames of lf0, vib
    fr[:, 1::4, 231:237] = 0.0
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt,
                                                    device=cuda)
    means = tuple(t(rng.standard_normal((R, st.sl.stop - st.sl.start)))
                  for st in sts)
    vars_ = tuple(t(rng.uniform(0.05, 3.0, (R, st.sl.stop - st.sl.start)))
                  for st in sts)
    msd_w = tuple(t(rng.uniform(0.0, 1.0, R)) for _ in sts)
    rows = tuple(t(rng.integers(0, R, (B, Kb)), torch.long) for _ in sts)
    args = hsmm.stream_args(sts)
    kernels.reset_counts()
    got = hsmm.batch_frame_loglik(t(fr), rows, means, vars_, msd_w, *args)
    assert kernels.launches["hsmm_loglik"] == 1
    want = hsmm.batch_frame_loglik_plain(t(fr), rows, means, vars_, msd_w,
                                         *args)
    assert ((got - want).abs() <= 1e-12 * (1 + want.abs())).all()


def _k17_inputs(cuda, Kb, B=3, Tb=301, R=150, seed=17):
    """World streams (D 237, lf0 and vib MSD with unvoiced frames), a NaN
    in one frame's bap columns, small and large variances, random rows."""
    rng = np.random.default_rng(seed + Kb)
    sts = hsmm.world_streams()
    fr = rng.standard_normal((B, Tb, 237)) * 1.5 + 0.5
    fr[:, ::3, 150:156] = 0.0
    fr[:, 1::4, 231:237] = 0.0
    fr[min(1, B - 1), 5, 160] = np.nan                   # bap, weight 0

    def t(a, dt=torch.float64):
        return torch.as_tensor(a, dtype=dt, device=cuda)
    w = [st.sl.stop - st.sl.start for st in sts]
    return dict(
        frames=t(fr),
        rows=tuple(t(rng.integers(0, R, (B, Kb)), torch.long) for _ in sts),
        means=tuple(t(rng.standard_normal((R, d)) + 1.0) for d in w),
        variances=tuple(t(10.0 ** rng.uniform(-3, 0.5, (R, d))) for d in w),
        msd_w=tuple(t(rng.uniform(0.0, 1.0, R)) for _ in sts),
        **dict(zip(("stream_slices", "msd_flags", "weights_static"),
                   hsmm.stream_args(sts))))


def _k17_close(got, want):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert ((got - want).abs()[fin] <= 1e-12 * (1 + want.abs()[fin])).all()


@pytest.mark.parametrize("Kb", [1, 128, 132, 133, 200])
def test_k17_tiles_match_plain_at_any_chain_length(cuda, Kb):
    """Chain lengths at, across and past the state tiles, 301 frames (not
    a multiple of a frame tile), D = 237 with MSD streams, a NaN bap frame
    NaN in every state: within 1e-12 (1 + |ll|) of the twin."""
    inp = _k17_inputs(cuda, Kb)
    got = hsmm.batch_frame_loglik(**inp)
    want = hsmm.batch_frame_loglik_plain(**inp)
    _k17_close(got, want)
    assert torch.isnan(got[1, 5]).all() and int(torch.isnan(got).sum()) == Kb


def test_k17_reuses_its_row_tables_across_launches(cuda):
    """The row prologue runs once per model set: a second launch on the
    same tables (other frames and rows) reuses the cached buffer, an
    in-place change of a table builds a new one; every launch matches the
    twin."""
    inp = _k17_inputs(cuda, 40, B=2, Tb=97)
    other = _k17_inputs(cuda, 40, B=2, Tb=97, seed=5)
    hsmm._ROW_TABLES.clear()
    kernels.reset_counts()
    for frames, rows in ((inp["frames"], inp["rows"]),
                         (other["frames"], other["rows"])):
        x = {**inp, "frames": frames, "rows": rows}
        _k17_close(hsmm.batch_frame_loglik(**x),
                   hsmm.batch_frame_loglik_plain(**x))
    assert len(hsmm._ROW_TABLES) == 1
    buf = next(iter(hsmm._ROW_TABLES.values()))[1]
    inp["means"][0].add_(0.25)
    _k17_close(hsmm.batch_frame_loglik(**inp),
               hsmm.batch_frame_loglik_plain(**inp))
    assert len(hsmm._ROW_TABLES) == 2
    assert next(iter(hsmm._ROW_TABLES.values()))[1] is buf
    assert kernels.launches["hsmm_loglik"] == 3


@pytest.mark.parametrize("temper", [0.3, 1.0])
def test_k18_kernel_matches_plain(cuda, temper):
    ms, utts = chip_smoke.hsmm_tiny_corpus(hsmm, seed=18)
    e = _estep_batch(cuda, utts, ms)
    obs = hsmm.batch_frame_loglik(e["frames"], e["rows"], e["means"],
                                  e["variances"], e["msd_w"], *e["args"])
    ins = (obs, e["dm"], e["dv"], 20, temper, e["t_len"], e["k_len"])
    kernels.reset_counts()
    ll, g, d = hsmm.segment_fb(*ins)
    assert kernels.launches["hsmm_fb"] == 1
    ll0, g0, d0 = hsmm.segment_fb_plain(*ins)
    assert ((ll - ll0).abs() <= 1e-9 * ll0.abs()).all()
    assert (g - g0).abs().max() <= 1e-10
    assert ((d - d0).abs() <= 1e-9 * d0.abs()).all()


@pytest.mark.parametrize("temper", [0.3, 1.0])
def test_k18_bit_equal_across_cluster_sizes(cuda, temper):
    """The chains' cluster size (forced through the launcher's argument)
    changes the schedule only: C = 1, 2, 8 and 16 give the launcher's own
    choice bit for bit on an E-step batch."""
    ms, utts = chip_smoke.hsmm_tiny_corpus(hsmm, seed=18)
    e = _estep_batch(cuda, utts, ms)
    obs = hsmm.batch_frame_loglik(e["frames"], e["rows"], e["means"],
                                  e["variances"], e["msd_w"], *e["args"])
    ins = (obs, e["dm"], e["dv"], 20, temper, e["t_len"], e["k_len"])
    ref = hsmm.segment_fb(*ins)
    for C in (1, 2, 8, 16):
        got = hsmm._segment_fb_cuda(*ins, cluster=C)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), C


def test_k18_padded_equals_unpadded(cuda):
    rng = np.random.default_rng(0)
    T, S = 37, 6
    obs = torch.as_tensor(rng.standard_normal((T, S)) * 2.0, device=cuda)
    dm = torch.as_tensor(rng.uniform(3, 8, S), device=cuda)
    dv = torch.as_tensor(rng.uniform(1, 4, S), device=cuda)
    ll0, g0, d0 = hsmm.forward_backward_segment(obs, dm, dv, 20)
    obsp = torch.as_tensor(rng.standard_normal((T + 13, S + 3)),
                           device=cuda)
    obsp[:T, :S] = obs
    dmp = torch.cat([dm, torch.full((3,), 5.0, device=cuda,
                                    dtype=torch.float64)])
    dvp = torch.cat([dv, torch.ones(3, device=cuda, dtype=torch.float64)])
    ll1, g1, d1 = hsmm.forward_backward_segment(obsp, dmp, dvp, 20,
                                                t_len=T, k_len=S)
    assert abs(float(ll0) - float(ll1)) < 1e-10
    assert (g0 - g1[:T, :S]).abs().max() < 1e-12
    assert (d0 - d1[:S]).abs().max() < 1e-10
    assert g1[T:, :].abs().max() < 1e-12
    assert d1[S:].abs().max() < 1e-12


def test_k18_infeasible_chain(cuda):
    """A chain longer than its frames has no path: both give LOG_ZERO-scale
    evidence and the E-step drops it."""
    rng = np.random.default_rng(1)
    obs = torch.as_tensor(rng.standard_normal((1, 5, 8)), device=cuda)
    dm = torch.full((1, 8), 3.0, dtype=torch.float64, device=cuda)
    dv = torch.ones((1, 8), dtype=torch.float64, device=cuda)
    n = torch.tensor([5], device=cuda)
    k = torch.tensor([8], device=cuda)
    ll = hsmm.segment_fb(obs, dm, dv, 10, 1.0, n, k)[0]
    ll0 = hsmm.segment_fb_plain(obs, dm, dv, 10, 1.0, n, k)[0]
    assert float(ll) <= hsmm.LOG_ZERO / 2 and float(ll0) <= hsmm.LOG_ZERO / 2


def test_k19_bit_equal_to_cpu_and_deterministic(cuda):
    rng = np.random.default_rng(19)
    N, C, R = 3000, 301, 57
    vals = torch.as_tensor(rng.standard_normal((N, C)) * 10.0 ** rng.uniform(
        -3, 3, (N, 1)), device=cuda)
    ids = torch.as_tensor(rng.integers(0, R, N), device=cuda)
    kernels.reset_counts()
    a = hsmm_batch.segment_sum(vals, ids, R)
    b = hsmm_batch.segment_sum(vals, ids, R)
    assert kernels.launches["hsmm_accumulate"] == 2
    c = hsmm_batch.segment_sum_plain(vals.cpu(), ids.cpu(), R)
    assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_hsmm_em_matches_the_cpu_path(cuda):
    ms, utts = chip_smoke.hsmm_tiny_corpus(hsmm, seed=5)
    names = [st.name for st in ms.streams]
    got, want = (hsmm.modelset_from_numpy(*ms.to_numpy()) for _ in range(2))
    kernels.reset_counts()
    hsmm_batch.reestimate_modelset_batched(got, utts, n_iters=2,
                                           log=lambda m: None)
    assert all(kernels.launches[k] > 0 for k in
               ("hsmm_loglik", "hsmm_fb", "hsmm_accumulate"))
    hsmm_batch.reestimate_modelset_batched(want, utts, n_iters=2,
                                           log=lambda m: None, device="cpu")
    for n in names:
        assert np.abs(got.means[n] - want.means[n]).max() < 1e-8
        assert np.abs(got.variances[n] - want.variances[n]).max() < 1e-8
    for n in got.msd_weights:
        assert np.abs(got.msd_weights[n] - want.msd_weights[n]).max() < 1e-8
    assert np.abs(got.dur_mean - want.dur_mean).max() < 1e-8
    assert np.abs(got.dur_var - want.dur_var).max() < 1e-8
    for fr, seq in utts[:3]:
        lg, eg = hsmm.align_utterance(got, fr, seq)
        lc, ec = hsmm.align_utterance(got, fr, seq, device="cpu")
        assert np.array_equal(eg, ec) and abs(lg - lc) <= 1e-9 * abs(lc)


def test_hsmm_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 5, 10), dtype=torch.float64, device=cuda)
    sts = chip_smoke.hsmm_tiny_corpus(hsmm)[0].streams
    tabs = tuple(torch.ones((4, st.sl.stop - st.sl.start),
                            dtype=torch.float64, device=cuda) for st in sts)
    w = tuple(torch.full((4,), 0.5, dtype=torch.float64, device=cuda)
              for _ in sts)
    rows = tuple(torch.zeros((2, 3), dtype=torch.long, device=cuda)
                 for _ in sts)
    args = hsmm.stream_args(sts)
    with pytest.raises(ValueError):
        hsmm.batch_frame_loglik(x.float(), rows, tabs, tabs, w, *args)
    with pytest.raises(ValueError):
        hsmm.batch_frame_loglik(x, tuple(r.int() for r in rows), tabs, tabs,
                                w, *args)
    dm = torch.ones((2, 3), dtype=torch.float64, device=cuda)
    n = torch.tensor([5, 5], device=cuda)
    with pytest.raises(ValueError):
        hsmm.segment_fb(x[..., :3].float(), dm, dm, 4, 1.0, n, n)
    with pytest.raises(ValueError):
        hsmm.segment_fb(x[..., :3], dm, dm, 4, 1.0, n.int(), n)
    with pytest.raises(ValueError):
        hsmm_batch.segment_sum(x[0].float(), n, 3)


def test_k20_kernel_matches_plain(cuda):
    """A padded batch against the twin run on the CPU (the kernel's
    sequential prefix sums), and padded against unpadded bit for bit."""
    rng = np.random.default_rng(20)
    B, T, K = 4, 300, 40
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt,
                                                    device=cuda)
    obs = t(-3.0 * np.abs(rng.standard_normal((B, T, K))))
    dm, dv = t(rng.uniform(2, 9, (B, K))), t(rng.uniform(1, 5, (B, K)))
    tl = t([T, 251, 180, 299], torch.long)
    kl = t([K, 33, 40, 25], torch.long)
    kernels.reset_counts()
    ll, ends = hsmm.viterbi_segment_batch(obs, dm, dv, tl, kl, 60)
    assert kernels.launches["hsmm_viterbi"] == 1
    ll0, e0 = hsmm.viterbi_segment_batch_plain(obs.cpu(), dm.cpu(), dv.cpu(),
                                               tl.cpu(), kl.cpu(), 60)
    assert torch.equal(ends.cpu(), e0)
    assert ((ll.cpu() - ll0).abs() <= 1e-9 * ll0.abs()).all()
    for b in range(B):
        T_, K_ = int(tl[b]), int(kl[b])
        l1, e1 = hsmm.viterbi_segment(obs[b, :T_, :K_].contiguous(),
                                      dm[b, :K_].contiguous(),
                                      dv[b, :K_].contiguous(), 60)
        assert float(l1) == float(ll[b]) and torch.equal(e1, ends[b, :K_])


def test_k20_breaks_a_forced_tie_as_the_twin(cuda):
    obs = torch.zeros((1, 5, 2), dtype=torch.float64, device=cuda)
    dm = torch.full((1, 2), 2.5, dtype=torch.float64, device=cuda)
    dv = torch.full((1, 2), 1.5, dtype=torch.float64, device=cuda)
    n = torch.tensor([5], device=cuda)
    k = torch.tensor([2], device=cuda)
    ll, ends = hsmm.viterbi_segment_batch(obs, dm, dv, n, k, 4)
    assert ends.cpu().tolist() == [[3, 5]]


@pytest.mark.parametrize("name", ["hsmm_fb", "hsmm_viterbi"])
def test_k18_and_k20_take_a_9000_frame_utterance(cuda, name):
    """Past the shared-memory rows (3 (T+1) + max_dur > 25600 doubles) the
    rows go to device memory: K18 against its twin at its tolerances, K20
    against its twin on the CPU."""
    inp = chip_smoke.k18_long_inputs(cuda)
    kernels.reset_counts()
    if name == "hsmm_fb":
        ll, g, d = hsmm.segment_fb(**inp, temper=1.0)
        ll0, g0, d0 = hsmm.segment_fb_plain(**inp, temper=1.0)
        assert ((ll - ll0).abs() <= 1e-9 * ll0.abs()).all()
        assert (g - g0).abs().max() <= 1e-10
        assert ((d - d0).abs() <= 1e-9 * d0.abs()).all()
        assert abs(float(g.sum()) - 9000.0) <= 1e-6
    else:
        ll, ends = hsmm.viterbi_segment_batch(**inp)
        cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
               for k, v in inp.items()}
        ll0, e0 = hsmm.viterbi_segment_batch_plain(**cpu)
        assert torch.equal(ends.cpu(), e0) and int(e0[0, -1]) == 9000
        assert abs(float(ll[0]) - float(ll0[0])) <= 1e-9 * abs(float(ll0[0]))
    assert kernels.launches[name] == 1


@pytest.mark.parametrize("C", [1, 3])
def test_k18_9000_frames_bit_equal_across_cluster_sizes(cuda, C):
    """At T 9000 one CTA a chain keeps its rows in device memory (past the
    shared-memory budget), three keep them in shared memory: both give
    the launcher's choice bit for bit."""
    inp = chip_smoke.k18_long_inputs(cuda)
    ref = hsmm.segment_fb(**inp, temper=1.0)
    got = hsmm._segment_fb_cuda(inp["obs_ll"], inp["dur_mean"],
                                inp["dur_var"], inp["max_dur"], 1.0,
                                inp["t_len"], inp["k_len"], cluster=C)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_k17_scores_a_nan_bap_frame_as_nan(cuda):
    inp = chip_smoke.nan_bap_inputs(hsmm, cuda)
    got = hsmm.batch_frame_loglik(**inp)
    want = hsmm.batch_frame_loglik_plain(**inp)
    assert torch.isnan(got[1, 5]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(torch.isnan(got).sum()) == got.shape[2]
    fin = torch.isfinite(want)
    assert ((got - want).abs()[fin] <= 1e-12 * (1 + want.abs()[fin])).all()


def test_k19_bit_equal_at_the_untied_row_count(cuda):
    """1250 rows (250 contexts x 5 states), ids as a bucket batch of
    chains gives them, some rows empty: bit-equal to the CPU's index_add_
    and across launches."""
    rng = np.random.default_rng(1250)
    R, C = 1250, 301
    ids = np.concatenate([rng.permutation(R - 50)[:120] for _ in range(26)])
    vals = torch.as_tensor(rng.standard_normal((len(ids), C)) * 10.0 ** (
        rng.uniform(-3, 3, (len(ids), 1))), device=cuda)
    ids = torch.as_tensor(ids, device=cuda)
    kernels.reset_counts()
    a = hsmm_batch.segment_sum(vals, ids, R)
    b = hsmm_batch.segment_sum(vals, ids, R)
    assert kernels.launches["hsmm_accumulate"] == 2
    c = hsmm_batch.segment_sum_plain(vals.cpu(), ids.cpu(), R)
    assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert not a[R - 50:].any()


@pytest.mark.parametrize("R", [200, 1485])
def test_k19_one_launch_for_a_batch_bit_equal_to_cpu(cuda, R):
    """A batch's five tables (an E-step's four streams at D = 237 and the
    durations) in one launch into non-zero running tables: bit-equal to
    the CPU twin, the same on a second launch and in place, empty rows
    left as they were."""
    rng = np.random.default_rng(R)
    widths = (301, 9, 151, 9, 3)
    N = 26 * 132
    ids = [rng.integers(0, R - 40, N) for _ in widths]
    ids[0][:50] = R - 1
    vals = [torch.as_tensor(rng.standard_normal((N, C)) * 10.0 ** (
        rng.uniform(-3, 3, (N, 1))), device=cuda) for C in widths]
    acc = [torch.as_tensor(rng.standard_normal((R, C)), device=cuda)
           for C in widths]
    ids_t = [torch.as_tensor(i, device=cuda) for i in ids]
    rows = (R,) * len(widths)
    members = [hsmm_batch.member_lists(i, R) for i in ids]
    kernels.reset_counts()
    a = hsmm_batch.segment_sums(vals, ids_t, rows, acc, members)
    b = hsmm_batch.segment_sums(vals, ids_t, rows, acc)
    assert kernels.launches["hsmm_accumulate"] == 2
    c = hsmm_batch.segment_sums_plain([v.cpu() for v in vals],
                                      [i.cpu() for i in ids_t], rows,
                                      [x.cpu() for x in acc])
    for x, y, z, w in zip(a, b, c, acc):
        assert torch.equal(x, y) and torch.equal(x.cpu(), z)
        assert torch.equal(x[R - 40:R - 1], w[R - 40:R - 1])
    inplace = [x.clone() for x in acc]
    hsmm_batch.segment_sums(vals, ids_t, rows, inplace, members,
                            out=inplace)
    assert all(torch.equal(x, y) for x, y in zip(inplace, a))


def test_estep_launches_k19_once_a_batch(cuda):
    """The E-step launches K19 once a padded batch (every table), and its
    accumulators agree with the CPU path's within 1e-9 of each array's
    largest value (K17, K18 and the moments round differently there)."""
    ms, utts = chip_smoke.hsmm_tiny_corpus(hsmm, seed=6)
    chained, _ = hsmm_batch.chain_modelset(ms, utts)
    M, S = ms.dur_mean.shape
    n_rows = {st.name: M * S for st in ms.streams}
    tab = hsmm_batch.tables_from_modelset(ms)
    kernels.reset_counts()
    got = hsmm_batch.corpus_estep(tab, chained, n_rows, M * S, 40,
                                  max_batch=3)
    n_batches = sum(-(-len(g) // 3)
                    for g in hsmm_batch._groups(chained).values())
    assert kernels.launches["hsmm_accumulate"] == n_batches
    want = hsmm_batch.corpus_estep(tab, chained, n_rows, M * S, 40,
                                   max_batch=3, device="cpu")
    for g, w in zip(got.streams, want.streams):
        assert all(np.abs(g[k] - w[k]).max() <= 1e-9 * np.abs(w[k]).max()
                   for k in w)
    assert np.abs(got.dur - want.dur).max() <= 1e-9 * np.abs(want.dur).max()


def test_recipe_matches_the_cpu_path(cuda):
    from hts_train_world_tpu_torch.features import qconf
    from hts_train_world_tpu_torch.models import clustering, recipe
    utts, spans = chip_smoke.recipe_tiny_corpus()
    qs = clustering.questions_from_config(
        qconf.parse_config(chip_smoke.TINY_QUESTIONS))
    kernels.reset_counts()
    voices, built = [], []
    for d in ("cuda", "cpu"):
        with chip_smoke.recording_trees(clustering) as trees_d:
            voices.append(recipe.train_voice(
                utts, qs, recipe.RecipeConfig(**chip_smoke.TINY_RECIPE),
                streams=chip_smoke.tiny_streams(hsmm), bootstrap_spans=spans,
                log=lambda m: None, device=d))
        built.append(trees_d)
    assert all(kernels.launches[k] > 0 for k in chip_smoke.PATHS["recipe"])
    ok, text = chip_smoke.compare_voices(*voices, utts, clustering, *built)
    assert ok, text


def test_k20_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    obs = torch.zeros((2, 5, 3), dtype=torch.float64, device=cuda)
    dm = torch.ones((2, 3), dtype=torch.float64, device=cuda)
    n = torch.tensor([5, 5], device=cuda)
    with pytest.raises(ValueError):
        hsmm.viterbi_segment_batch(obs.float(), dm, dm, n, n, 4)
    with pytest.raises(ValueError):
        hsmm.viterbi_segment_batch(obs, dm, dm, n.int(), n, 4)
    with pytest.raises(ValueError):
        hsmm.viterbi_segment_batch(obs, dm, dm, n, n, 40000)


# ---------------------------------------------------------------------------
# the generation lane: K21-K23, K7/K8 in float64, synthesize_utterance
# ---------------------------------------------------------------------------


def _gen_traj(T, D, seed, dev):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((T, D)) * 0.1, axis=0) \
        + rng.standard_normal(D)[None] * 2.0
    return torch.as_tensor(x, dtype=torch.float64, device=dev)


@pytest.mark.parametrize("T", [37, 400, 1100])
def test_k21_kernel_matches_plain(cuda, T):
    """Analysis (ms) and the postfilter against the twin on the card, D 50,
    statistics from trajectories (as make_mspf gathers them)."""
    from hts_train_world_tpu_torch.ops import postfilter as pf
    D = 50
    x = _gen_traj(T, D, T, cuda)
    nat = pf.mspf_stats([_gen_traj(n, D, n + 1, cuda) for n in (90, 211)],
                        cuda)
    gen = pf.mspf_stats([_gen_traj(n, D, n + 2, cuda) for n in (150, 301)],
                        cuda)
    kernels.reset_counts()
    ms = pf.mspf(x)
    ms_p = pf.mspf_plain(x)
    assert ms.shape == (D, pf.n_frames(T), 33)
    mk, mq = ms.exp(), ms_p.exp()
    assert ((mk - mq).abs().amax((1, 2)) <= 1e-9 * mq.amax((1, 2))).all()
    y = pf.apply_mspf(x, nat, gen, 0.8)
    stats = tuple(torch.as_tensor(a, device=cuda) for a in
                  (nat.mean, nat.std, gen.mean, gen.std))
    y_p = pf.mspf_plain(x, stats, 0.8)
    assert kernels.launches["mspf"] == 2
    assert ((y - y_p).abs().amax(0) <= 1e-9 * y_p.abs().amax(0)).all()
    # deterministic: the gather overlap-add adds in one order
    assert torch.equal(pf.apply_mspf(x, nat, gen, 0.8), y)


def test_k21_zero_gen_std_gives_the_twin_non_finite(cuda):
    from hts_train_world_tpu_torch.ops import postfilter as pf
    x = _gen_traj(60, 3, 5, cuda)
    st = pf.mspf_stats([_gen_traj(90, 3, 6, cuda)], cuda)
    st.std[1, ::3] = 0.0
    y = pf.apply_mspf(x, st, st, 1.0)
    y_p = pf.mspf_plain(x, tuple(torch.as_tensor(a, device=cuda) for a in
                                 (st.mean, st.std, st.mean, st.std)), 1.0)
    assert not torch.isfinite(y[:, 1]).any()
    assert torch.equal(torch.isfinite(y), torch.isfinite(y_p))


@pytest.mark.parametrize("fft_size", [1024, 4096])
def test_k22_kernel_matches_plain(cuda, fft_size):
    from hts_train_world_tpu_torch.ops import postfilter as pf
    rng = np.random.default_rng(fft_size)
    mgc = rng.standard_normal((300, 50)) * 0.3 / (1.0 + np.arange(50))
    mgc[:, 0] -= 2.0
    x = torch.as_tensor(mgc, device=cuda)
    kernels.reset_counts()
    got = pf.mcep_postfilter(x, 0.42, 1.4, fft_size)
    want = pf.mcep_postfilter_plain(x, 0.42, 1.4, fft_size)
    assert kernels.launches["mcep_postfilter"] == 1
    assert ((got - want).abs() <= 1e-9 * (1.0 + want.abs())).all()
    assert (got[:, 0] - x[:, 0]).abs().max() > 1e-3


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("weight", [1.0, 0.5])
def test_k23_kernel_matches_plain(cuda, masked, weight):
    from hts_train_world_tpu_torch.ops import gv
    rng = np.random.default_rng(int(masked))
    x = rng.standard_normal((900, 50)) * rng.uniform(0.1, 3.0, 50)
    x[:, 7] = 2.0
    mask = None
    if masked:
        x = x[:, :1]
        v = rng.random(900) > 0.4
        x[~v] = -1.0e10
        mask = torch.as_tensor(v, device=cuda)
    xt = torch.as_tensor(x, device=cuda)
    g = rng.uniform(0.2, 2.0, x.shape[1])
    kernels.reset_counts()
    got = gv.gv_scale(xt, g, weight, mask)
    want = gv.gv_scale_plain(xt, g, weight, mask)
    assert kernels.launches["gv_scale"] == 1
    assert ((got - want).abs().amax(0) <= 1e-9 * want.abs().amax(0)).all()
    if masked:
        assert torch.equal(got[~mask], xt[~mask])
        few = torch.zeros_like(mask)
        few[:2] = True
        assert torch.equal(gv.gv_scale(xt, g, weight, few), xt)


def test_k8_float64_kernel_matches_plain_at_a_1e16_spread(cuda):
    rng = np.random.default_rng(8)
    T, D = 700, 77
    mu = rng.standard_normal((T, 3, D))
    var = rng.uniform(0.05, 2.0, (T, 3, D))
    var[T // 4:T // 2] *= 1e8
    var[T // 2:T // 2 + 7] = 1e-8
    m, v = (torch.as_tensor(a, device=cuda) for a in (mu, var))
    kernels.reset_counts()
    got = mlpg.mlpg(m, v)
    assert got.dtype == torch.float64
    assert kernels.launches["mlpg_solve"] == 1
    want = mlpg.mlpg_plain(m, v)
    assert ((got - want).abs() <= 1e-9 * want.abs().amax(0)).all()


def test_k7_float64_kernel_bit_equal_to_plain(cuda):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 500, 25)) * 1e3
    x[0, 40:44, 3] = -1.0e10
    xt = torch.as_tensor(x, device=cuda)
    kernels.reset_counts()
    got = windows.expand(xt)
    assert got.dtype == torch.float64
    assert kernels.launches["delta_window"] == 1
    assert torch.equal(got, windows.expand_plain(xt))


def test_generation_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from hts_train_world_tpu_torch.ops import gv
    from hts_train_world_tpu_torch.ops import postfilter as pf
    x = torch.zeros((40, 5), device=cuda)
    with pytest.raises(ValueError):
        pf.mspf(x)
    with pytest.raises(ValueError):
        pf.mspf(x.double(), (x.double(),) * 4)
    with pytest.raises(ValueError):
        pf.mcep_postfilter(x, 0.42)
    with pytest.raises(ValueError):
        pf.mcep_postfilter(torch.zeros((4, 300), dtype=torch.float64,
                                       device=cuda), 0.42)
    with pytest.raises(ValueError):
        gv.gv_scale(x, np.ones(5))
    with pytest.raises(ValueError):
        gv.gv_scale(x.double(), np.ones(5), mask=torch.ones(
            40, dtype=torch.uint8, device=cuda))


def test_synthesize_utterance_matches_the_cpu_path(cuda):
    """tests/test_voice_build.py's corpus, its voice trained once on the
    card; generation on the card against the CPU path from that voice:
    the same durations and V/UV, statics within 1e-9, the waveform on
    injected noise within the synth lane's float32 bounds."""
    import dataclasses
    from hts_train_world_tpu_torch.features import compose, qconf
    from hts_train_world_tpu_torch.models import clustering, pgen, recipe
    corpus, spans, lay = chip_smoke.voice_tiny_corpus(bucketing, compose,
                                                      "cuda")
    cfg_t = recipe.RecipeConfig(**chip_smoke.VOICE_TINY_RECIPE)
    qs = clustering.questions_from_config(
        qconf.parse_config(chip_smoke.VOICE_TINY_QUESTIONS))
    st = recipe.train_voice(corpus, qs, cfg_t,
                            streams=hsmm.world_streams(lay),
                            bootstrap_spans=spans, log=lambda m: None)
    labels = [f"x^x-{p}+x=x/E:1]" for p in ("sil", "n2", "n0", "n1", "sil")]
    d = pgen.state_durations(st.clustered, labels)
    yl = cfg.y_length_for(int(d.sum()), 5.0, 16000)
    noise = np.random.default_rng(3).standard_normal(
        syn.synthesis_stream_len(yl))
    for variant in (cfg_t, dataclasses.replace(cfg_t, use_mspf=False,
                                               postfilter_mcp=1.4)):
        kernels.reset_counts()
        yg, sg, vg, dg = recipe.synthesize_utterance(st, labels, variant,
                                                     16000, noise=noise)
        assert kernels.launches["gv_scale"] == 2
        assert kernels.launches["mspf" if variant.use_mspf
                                else "mcep_postfilter"] == 1
        yc, sc, vc, dc = recipe.synthesize_utterance(
            st, labels, variant, 16000, noise=noise, device="cpu")
        assert np.array_equal(dg, dc) and torch.equal(vg.cpu(), vc)
        for n in sc:
            live = sc[n] != pgen.MAGIC
            assert torch.equal(sg[n].cpu() != pgen.MAGIC, live)
            assert ((sg[n].cpu() - sc[n]).abs()[live].max()
                    <= 1e-9 * sc[n].abs()[live].max())
        yg, yc = yg.cpu().double(), yc.double()
        assert (yg - yc).abs().max() <= 1e-3 * yc.abs().max()
        assert abs(float(yg.pow(2).sum() / yc.pow(2).sum()) - 1.0) <= 1e-3


# ---------------------------------------------------------------------------
# K24-K27: StoneMask's IF readout, CheapTrick's lifter, D4C's body
# ---------------------------------------------------------------------------


def _analysis_record(cuda, fs, seed=0, hostile=False):
    """The inputs every launch of K24-K27 got on batch_analyze of two
    harmonic utterances (with a pause), or of silence, clicks and noise."""
    L = fs // 2
    rng = np.random.default_rng(seed)
    t = np.arange(L) / fs
    if hostile:
        xs = np.stack([np.zeros(L), np.zeros(L), 0.5 * rng.standard_normal(L)])
        xs[1, ::fs // 50] = 0.9
    else:
        xs = np.stack([0.5 * np.sin(2 * np.pi * f * t * (1 + 0.02 * np.sin(
            2 * np.pi * 5 * t))) + 0.2 * np.sin(4 * np.pi * f * t)
            + 0.01 * rng.standard_normal(L) for f in (120.0, 310.0)])
        xs[:, L // 3:L // 2] = 1e-4 * rng.standard_normal(L // 2 - L // 3)
    kernels.record = []
    try:
        batch.batch_analyze(xs, fs)
        torch.cuda.synchronize()
        rec = kernels.record
    finally:
        kernels.record = None
    return {n: [i for k, i in rec if k == n] for n in (
        "stonemask_if", "cheaptrick_lifter", "d4c_group_delay",
        "d4c_aperiodicity")}


@pytest.mark.parametrize("fs,hostile", [(16000, False), (48000, False),
                                        (48000, True)])
def test_k24_kernel_bit_equal_to_plain(cuda, fs, hostile):
    (inp,) = _analysis_record(cuda, fs, hostile=hostile)["stonemask_if"]
    assert torch.equal(sm.if_readout(**inp), sm.if_readout_plain(**inp))


def test_k24_bit_equal_at_the_gate_and_the_guard(cuda):
    """Random spectra (zero-power bins too), f0 on both gate edges and
    spread over the range, and the lane's spectra with seeds moved 19-21 %
    off so the 20 % guard decides."""
    fs, b_max = 48000, 4096
    rng = np.random.default_rng(24)
    R, H = 2000, b_max // 2 + 1
    spec = [torch.as_tensor(rng.standard_normal((R, H)), dtype=torch.float32,
                            device=cuda) for _ in range(4)]
    spec[0][:, 64:80] = 0.0
    spec[1][:, 64:80] = 0.0
    f0 = torch.as_tensor(rng.uniform(30.0, 4200.0, R), dtype=torch.float32,
                         device=cuda)
    f32 = np.float32
    f0[:4] = torch.tensor([40.0, np.nextafter(f32(40.0), f32(50.0)),
                           fs / 12.0, np.nextafter(f32(fs / 12.0), f32(1e9))],
                          device=cuda)
    gate = (f0 <= 40.0) | (f0 > fs / 12.0)
    f0s = torch.where(gate, torch.full_like(f0, 100.0), f0)
    h = torch.clamp((1.5 * fs / f0s + 1.0).long(), max=(b_max // 2 - 1) // 2)
    args = (*spec, f0s, h, gate, fs, b_max)
    got, want = sm.if_readout(*args), sm.if_readout_plain(*args)
    assert torch.equal(got, want) and not bool(got[[0, 3]].any())
    assert bool((got[[1, 2]] != 0).all())
    (inp,) = _analysis_record(cuda, fs)["stonemask_if"]
    base = sm.if_readout_plain(**inp)
    live = base > 0
    scale = torch.as_tensor(rng.uniform(0.79, 0.81, live.numel()),
                            dtype=torch.float32, device=cuda)
    moved = dict(inp, f0s=torch.where(live, base * scale, inp["f0s"]))
    got, want = sm.if_readout(**moved), sm.if_readout_plain(**moved)
    assert torch.equal(got, want)
    assert bool((got == moved["f0s"])[live].any())        # guard kept f0


def _k25_chain(fn, ps, cf0, fs, N, q1=-0.15):
    from hts_train_world_tpu_torch.ops import fftmat
    c = fftmat.matmul(fn(ps, ct.LOG),
                      fftmat.sym_rfft_real_mat(N, ps.dtype, ps.device))
    A, _ = fftmat.irfft_half_mats(N, ps.dtype, ps.device)
    return fn(fftmat.matmul(fn(c, ct.LIFTER, cf0, fs, N, q1), A), ct.EXP)


@pytest.mark.parametrize("fs,hostile", [(16000, False), (48000, False),
                                        (48000, True)])
def test_k25_kernel_matches_plain(cuda, fs, hostile):
    """Each stage within 2e-6 relative (the log stage: absolute, of the
    row's largest |log|), and the chain's sp within 2e-6 relative."""
    recs = _analysis_record(cuda, fs, hostile=hostile)["cheaptrick_lifter"]
    assert [r["stage"] for r in recs] == [ct.LOG, ct.LIFTER, ct.EXP]
    for inp in recs:
        k, p = ct.lifter(**inp), ct.lifter_plain(**inp)
        scale = p.abs().amax(1, keepdim=True) if inp["stage"] == ct.LOG \
            else p.abs()
        assert bool(((k - p).abs() <= 2e-6 * scale + 1e-30).all())
    ps = recs[0]["x"]
    N, cf0 = recs[1]["fft_size"], recs[1]["cf0"]
    ps = torch.cat([ps, torch.zeros_like(ps[:2])])       # all-zero rows
    cf0 = torch.cat([cf0, torch.full_like(cf0[:2], 500.0)])
    k = _k25_chain(ct.lifter, ps, cf0, fs, N)
    p = _k25_chain(ct.lifter_plain, ps, cf0, fs, N)
    assert torch.isfinite(k).all() and (k > 0).all()
    assert bool(((k - p).abs() <= 2e-6 * p.abs()).all())


@pytest.mark.parametrize("fs,hostile", [(16000, False), (48000, False),
                                        (48000, True)])
def test_k26_k27_kernels_match_plain(cuda, fs, hostile):
    """K26: LoveTrain's ap0 within 1e-6 relative with process and cf0
    equal, the other stages bit for bit; K27: ap within 1e-6 relative,
    coarse dB within 1e-4."""
    rec = _analysis_record(cuda, fs, hostile=hostile)
    stages = [r["stage"] for r in rec["d4c_group_delay"]]
    assert stages == [d4c_mod.LOVE, d4c_mod.CENTROID, d4c_mod.RATIO,
                      d4c_mod.SEGMENTS]
    for inp in rec["d4c_group_delay"]:
        kw = {k: v for k, v in inp.items() if k != "stage"}
        fn = {d4c_mod.LOVE: "love_train_sums",
              d4c_mod.CENTROID: "centroid_sum",
              d4c_mod.RATIO: "group_delay_ratio",
              d4c_mod.SEGMENTS: "band_segments"}[inp["stage"]]
        k = getattr(d4c_mod, fn)(**kw)
        p = getattr(d4c_mod, fn + "_plain")(**kw)
        if inp["stage"] == d4c_mod.LOVE:
            assert bool(((k[0] - p[0]).abs() <= 1e-6 * p[0].abs()).all())
            assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
        else:
            assert bool(((k == p) | (k.isnan() & p.isnan())).all()), fn
    (inp,) = rec["d4c_aperiodicity"]
    (ak, ck), (ap, cp) = d4c_mod.aperiodicity(**inp), \
        d4c_mod.aperiodicity_plain(**inp)
    assert bool(((ak - ap).abs() <= 1e-6 * ap.abs()).all())
    assert float((ck - cp).abs().max()) <= 1e-4


def test_k26_hostile_rows(cuda):
    """f0 = 0 and at the floor, all-zero power rows, sps bins that are 0 or
    underflow: K26 as its twin."""
    rng = np.random.default_rng(5)
    R, H = 64, 2049
    p = torch.as_tensor(rng.standard_normal((R, H)) ** 2, dtype=torch.float32,
                        device=cuda)
    p[:8] = 0.0
    f0 = torch.as_tensor(rng.uniform(40.0, 600.0, R), dtype=torch.float32,
                         device=cuda)
    f0[8:12] = 0.0
    f0[12:16] = cfg.K_FLOOR_F0
    k = d4c_mod.love_train_sums(p, f0, 9, 342, 675, 0.0)
    q = d4c_mod.love_train_sums_plain(p, f0, 9, 342, 675, 0.0)
    assert bool(((k[0] - q[0]).abs() <= 1e-6 * q[0].abs()).all())
    assert torch.equal(k[1], q[1]) and torch.equal(k[2], q[2])
    sc = torch.as_tensor(rng.standard_normal((R, H)), dtype=torch.float32,
                         device=cuda)
    sps = p.clone()
    sps[16:20, :50] = 1e-45
    sps[20:24, :50] = 1e-40
    sc[20:24, :50] = 1e-42
    got = d4c_mod.group_delay_ratio(sc, sps)
    assert torch.equal(got, d4c_mod.group_delay_ratio_plain(sc, sps))
    assert bool((got[20:24, :50] != 0).all())       # denormals not flushed


def test_analysis_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.ones((4, 1025), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):         # the fast log is float32's
        ct.lifter(x, ct.LOG)
    with pytest.raises(ValueError):         # the parity log float64's
        ct.lifter(x.float(), ct.LOG, parity=True)
    with pytest.raises(ValueError):         # noise is the parity log's alone
        ct.lifter(x.float(), ct.LOG, noise=x[0],
                  noff=torch.zeros(4, dtype=torch.long, device=cuda))
    with pytest.raises(ValueError):
        ct.lifter(x.float(), 3)
    with pytest.raises(ValueError):
        d4c_mod.group_delay_ratio(x.float(), x.float()[:, :5])
    with pytest.raises(ValueError):
        d4c_mod.love_train_sums(x.float(), x[:, 0].float(), 9, 342, 2000,
                                0.0)
    with pytest.raises(ValueError):
        sm.if_readout(x.half(), x, x, x, x[:, 0], x[:, 0].long(),
                      x[:, 0] > 0, 48000, 2048)
    with pytest.raises(ValueError):         # K31 sorts float64 rows
        d4c_mod.band_sort_sums(x.float(), 100)


def test_d4c_at_8k_without_bands_matches_the_cpu_path(cuda):
    """fs <= 12 kHz: no coarse band; K26's band stage is skipped, K27
    interpolates between the two ends alone."""
    fs, L = 8000, 4000
    x = (np.sin(2 * np.pi * 200 * np.arange(L) / fs)
         + 0.01 * np.random.default_rng(0).standard_normal(L))[None]
    g = batch.batch_analyze(x, fs)
    c = batch.batch_analyze(x, fs, device="cpu")
    H = cfg.cheaptrick_fft_size(fs) // 2 + 1
    assert g[3].shape == c[3].shape == (1, c[1].shape[1], H)
    assert float((g[3].cpu() - c[3]).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# K28-K30: the trajectory cost's banded solve and its adjoint, synthesis's
# mid-pass
# ---------------------------------------------------------------------------


def _traj_case(B, T, D, dtype, dev, seed=28):
    rng = np.random.default_rng(seed)
    mu = torch.as_tensor(rng.standard_normal((B, T, 3, D)), dtype=dtype,
                         device=dev)
    prec = torch.as_tensor(np.exp(0.5 * rng.standard_normal((B, T, 3, D))),
                           dtype=dtype, device=dev)
    s = torch.as_tensor(rng.standard_normal((B, T, D)), dtype=dtype,
                        device=dev)
    g = [torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                         device=dev) for shape in ((B, T, D), (B, D),
                                                   (B, D))]
    return mu, prec, s, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,T,D", [(1, 512, 79), (3, 17, 5), (2, 1, 4),
                                   (1, 2, 3)])
def test_k28_k29_kernels_match_plain(cuda, dtype, B, T, D):
    """K28 and K29 against their twins on the card, at the trajectory
    lane's shape (1, 512, 79) and at band edges, within
    chip_smoke.check_k28 / check_k29's bounds (1e-5 of a column's largest
    magnitude in float32, 1e-12 in float64)."""
    from hts_train_world_tpu_torch.ops import trajectory as tr
    mu, prec, s, (gc, gq, gl) = _traj_case(B, T, D, dtype, cuda)
    kernels.reset_counts()
    fk = tr.trajectory_forward(mu, prec, s)
    fp = tr.trajectory_forward_plain(mu, prec, s)
    ok, err, text = chip_smoke.check_k28({}, fk, fp)
    assert ok, text
    bk = tr.trajectory_backward(mu, prec, s, fk[0], fk[3], gc, gq, gl)
    bp = tr.trajectory_backward_plain(mu, prec, s, fp[0], fp[3], gc, gq, gl)
    ok, err, text = chip_smoke.check_k29({}, bk, bp)
    assert ok, text
    assert kernels.launches["trajectory_nll"] == 1
    assert kernels.launches["trajectory_adjoint"] == 1


def test_k28_k29_float64_gradcheck_on_the_card(cuda):
    """torch.autograd.gradcheck of TrajectoryNLL through K28 and K29 in
    float64 on the card, every output's cotangent live."""
    from hts_train_world_tpu_torch.ops import trajectory as tr
    mu, prec, s, _ = _traj_case(2, 9, 3, torch.float64, cuda, seed=29)
    mu.requires_grad_(True)
    prec.requires_grad_(True)
    kernels.reset_counts()
    assert torch.autograd.gradcheck(
        lambda m, p: tr.TrajectoryNLL.apply(m, p, s), (mu, prec))
    assert kernels.launches["trajectory_nll"] > 0
    assert kernels.launches["trajectory_adjoint"] > 0


def test_trajectory_cost_matches_the_cpu_path(cuda):
    """acoustic.trajectory_cost and its gradient through K28/K29 on the
    card against the CPU twins, float32 at the lane's dims (50, 2, 25, 2)
    over 128 frames: cost within 1e-5 relative, gradients within 1e-4 of
    their largest magnitude."""
    from hts_train_world_tpu_torch.models import acoustic
    fd, mf = (50, 2, 25, 2), (0, 1, 0, 0)
    ncol = sum(mf) + 3 * sum(fd)
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((128, ncol)).astype(np.float32)
    target = rng.standard_normal((128, ncol)).astype(np.float32)
    logv = (0.3 * rng.standard_normal(ncol)).astype(np.float32)
    gv = np.exp(0.2 * rng.standard_normal(sum(fd))).astype(np.float32)
    out = {}
    for d in (cuda, torch.device("cpu")):
        p = torch.tensor(pred, device=d, requires_grad=True)
        lv = torch.tensor(logv, device=d, requires_grad=True)
        cost, _ = acoustic.trajectory_cost(
            p, torch.tensor(target, device=d), torch.exp(lv),
            torch.tensor(gv, device=d), fd, mf)
        cost.backward()
        out[d.type] = (float(cost.detach()), p.grad.cpu(), lv.grad.cpu())
    (c, gp, gl), (cc, gpc, glc) = out["cuda"], out["cpu"]
    assert abs(c - cc) <= 1e-5 * abs(cc)
    assert float((gp - gpc).abs().max()) <= 1e-4 * float(gpc.abs().max())
    assert float((gl - glc).abs().max()) <= 1e-4 * float(glc.abs().max())


def test_k30_kernel_matches_plain_on_the_headline_batch(cuda):
    """K30 on the inputs copy-synthesis of the headline batch (16 x 2.0 s
    at 48 kHz) gave it, against `midpass_plain` on the card within
    chip_smoke.check_k30's per-element bounds."""
    xs = torch.as_tensor(chip_smoke.corpus(16, 96000), dtype=torch.float32,
                         device=cuda)
    kernels.record = []
    try:
        batch.batch_copy_synth(xs, 48000, seed=1)
        recs = [i for n, i in kernels.record if n == "synth_midpass"]
    finally:
        kernels.record = None
    assert len(recs) == 1
    inp = recs[0]
    out_k = syn.midpass(**inp)
    out_p = syn.midpass_plain(**inp)
    ok, err, text = chip_smoke.check_k30(inp, out_k, out_p)
    assert ok, text


def test_trajectory_and_midpass_wrappers_reject_what_the_kernels_do_not_take(
        cuda):
    from hts_train_world_tpu_torch.ops import trajectory as tr
    mu, prec, s, _ = _traj_case(1, 6, 2, torch.float32, cuda)
    with pytest.raises(ValueError):
        tr.trajectory_forward(mu, prec.double(), s)
    with pytest.raises(ValueError):
        tr.trajectory_forward(mu, prec, s[:, :4])
    with pytest.raises(ValueError):
        tr.trajectory_forward(mu, prec, s, windows=((1.0,),) * 3)
    x = torch.zeros((2, 3, 9), device=cuda)
    with pytest.raises(ValueError):
        syn.midpass(x, x, x, x, x, x.double(), torch.zeros((2, 3),
                                                           device=cuda))
    with pytest.raises(ValueError):
        syn.midpass(x, x, x, x, x, x, torch.zeros((2, 4), device=cuda))


# ---------------------------------------------------------------------------
# the parity analysis: K1, K2, K4-K6 and K24-K27 in float64, and K31
# ---------------------------------------------------------------------------


def _parity_case(cuda, fs=48000, T=40, seed=11):
    """A float64 utterance pair with a gliding voiced contour and the
    reference's noise stream on the card."""
    from hts_train_world_tpu_torch.ops import rand
    rng = np.random.default_rng(seed)
    L = int(T * fs * 0.005)
    x = np.stack([0.5 * np.sin(2 * np.pi * np.cumsum(np.linspace(
        150 + 40 * b, 260, L)) / fs) + 0.01 * rng.standard_normal(L)
        for b in range(2)])
    stream = rand.randn_stream(d4c_mod.d4c_stream_len(T, fs), cuda)
    return torch.as_tensor(x, dtype=torch.float64, device=cuda), stream


@pytest.mark.parametrize("mode,ratio,width", [
    (frames.MEAN, 4.0, 4096), (frames.MEAN_BLACKMAN, 3.0, 4096),
    (frames.CHEAPTRICK, 3.0, 2048), (frames.CENTROID, 4.0, 4096),
    (frames.STONEMASK, 0.0, 1024)])
def test_k1_float64_matches_plain(cuda, mode, ratio, width):
    """The parity windows: any position, the stream's noise at each row's
    offset (none where it is negative), STONEMASK's per-sample rounding
    on compacted rows; within 1e-12 of each row's largest value (the
    kernel's block sums and torch.sum add in other orders)."""
    fs = 48000
    x, stream = _parity_case(cuda, fs)
    R = 60
    rng = np.random.default_rng(mode)
    f0 = torch.as_tensor(rng.uniform(60, 700, R), dtype=torch.float64,
                         device=cuda)
    pos = torch.as_tensor(rng.uniform(0.0, x.shape[1] / fs, R),
                          dtype=torch.float64, device=cuda)
    origin = prims.matlab_round_i(pos * fs + 0.001)
    h = prims.matlab_round_i(prims.rdiv(1.5 * fs, f0)).clamp(
        max=(width - 1) // 2)
    noff = torch.as_tensor(rng.integers(-1, 5000, R), device=cuda)
    rowutt = torch.as_tensor(rng.integers(0, 2, R), device=cuda)
    kw = dict(pos=pos, rowutt=rowutt, parity=True)
    if mode != frames.STONEMASK:
        kw.update(noise=stream, noff=noff)
    got = frames.frame_windows(x, origin, h, f0, fs, ratio, width, mode,
                               **kw)
    want = frames.frame_windows_plain(x, origin, h, f0, pos, fs, ratio,
                                      width, mode, kw.get("noise"),
                                      kw.get("noff"), rowutt, parity=True)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.float64
            _close_rows(g, w, 1e-12)


@pytest.mark.parametrize("fs,N", [(48000, 2048), (48000, 4096),
                                  (44100, 2048)])
def test_k2_parity_mode_matches_plain(cuda, fs, N):
    """K2's float64 mode (the mirror about each frame's own offset, XLA's
    blocked scan, fused lerps) against its twin run on the CPU: within
    1e-14 of each row's largest value."""
    rng = np.random.default_rng(2)
    ps = _k2_rows("harmonic", 64, N // 2 + 1, rng)
    f0 = rng.uniform(50, 800, 64)
    fmax = max(fs / 12.0, cfg.K_CEIL_F0)
    ul_max = 2 + int(fmax * N / fs) + 1
    b_max = int(fmax * N / fs) + 1
    args = [torch.as_tensor(v, dtype=torch.float64) for v in (ps, f0)]
    want = prims.smooth_spectrum(args[0], fs, N, f0=args[1], ul_max=ul_max,
                                 width=args[1] * 2.0 / 3.0, b_max=b_max,
                                 parity=True)
    got = prims.smooth_spectrum(args[0].to(cuda), fs, N,
                                f0=args[1].to(cuda), ul_max=ul_max,
                                width=args[1].to(cuda) * 2.0 / 3.0,
                                b_max=b_max, parity=True).cpu()
    _close_rows(got, want, 1e-14)


def test_k4_k5_float64_match_plain(cuda):
    """DIO's candidates at the worst-case cap (device scratch) and its
    contour fixing in float64 against their twins on the inputs DIO gave
    them (equal crossings, the rest within 1e-12 relative); and DIO on
    the card against DIO on the CPU, whose cuFFT and pocketfft band
    filters differ in the last bits: f0 within 1e-9."""
    fs = 48000
    x, _ = _parity_case(cuda, fs, T=100)
    kernels.record = []
    try:
        t, f0, cands, scores = dio.dio(x, fs, parity=True)
        rec = dict(kernels.record)
    finally:
        kernels.record = None
    inp = rec["dio_candidates[f64]"]
    got = dio.band_candidates(**inp, crossings=True)
    want = dio.band_candidates_plain(**inp, crossings=True)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for g, w in zip(got[:2], want[:2]):
        assert torch.allclose(g, w, rtol=1e-12, atol=0)
    inp = rec["fix_f0[f64]"]
    assert torch.allclose(dio.fix_f0_contour(**inp),
                          dio.fix_f0_contour_plain(**inp), rtol=1e-12,
                          atol=0)
    _, f0p, _, _ = dio.dio(x.cpu(), fs, parity=True)
    assert f0.dtype == torch.float64 and (f0p > 0).any()
    assert torch.allclose(f0.cpu(), f0p, rtol=1e-9, atol=0)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_k6_float64_matches_plain(cuda, fs):
    N = cfg.cheaptrick_fft_size(fs)
    rng = np.random.default_rng(6)
    sp = torch.as_tensor(np.exp(rng.normal(size=(2, 30, N // 2 + 1)) * 3),
                         dtype=torch.float64)
    ap = torch.as_tensor(rng.uniform(1e-3, 1.0, sp.shape),
                         dtype=torch.float64)
    sp[0, 3, :7] = 0.0
    want = encode.encode_spectra_plain(sp, ap, fs, N)
    got = encode.encode_spectra(sp.to(cuda), ap.to(cuda), fs, N)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert torch.allclose(g.cpu(), w, rtol=0, atol=1e-10)


@pytest.mark.parametrize("H", [5, 17, 1025, 2049, 3000])
def test_k31_bit_equal_to_cpu_twin(cuda, H):
    """K31 (a register sort of the first 2^k keys, the last merged by its
    rank, the blocked sum) bit for bit against its twin run on the CPU:
    H = 2^k + 1 and 3000 (padded to a power of two), R = 1 and 37 rows,
    NaN rows of either sign, a row of ties, signed zeros, a last key
    that ties, and i_num at 0, 15, 16 and H - 1."""
    rng = np.random.default_rng(H)
    for R in (1, 37):
        p = 10.0 ** rng.uniform(-6, 3, (R, H))
        if R > 1:
            p[1, H // 2] = np.nan
            p[2, 0] = -np.nan
            p[2, -1] = np.nan
            p[3] = 0.75
            p[4, ::2] = -0.0
            p[4, 1::4] = 0.0
            p[5, -1] = p[5, 0]
            p[6, :] = np.nan
        pt = torch.as_tensor(p)
        for i_num in sorted({0, 15 % H, 16 % H, H - 1}):
            got = d4c_mod.band_sort_sums(pt.to(cuda), i_num)
            want = d4c_mod.band_sort_sums_plain(pt, i_num)
            for g, w in zip(got, want):
                g = g.cpu()
                assert torch.equal(torch.isnan(g), torch.isnan(w))
                fin = ~torch.isnan(w)
                assert torch.equal(g[fin].view(torch.int64),
                                   w[fin].view(torch.int64)), (R, i_num)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fs", [16000, 22050, 44100, 48000])
def test_k6_tiled_matches_plain(cuda, fs, dtype):
    """K6's tiled product at R = 1, 7, 121 (the `analysis` command's
    frames) and 6416 (the parity lane's), sp with zero bins, at mgc 50 /
    bap 25 and, at R = 121, 70 / 5 (two coefficient blocks for mgc):
    float32 within encode_spectra_limit, float64 within 1e-10 of the
    twin."""
    N = cfg.cheaptrick_fft_size(fs)
    rng = np.random.default_rng(fs + 6)
    for R, dims in ((1, ()), (7, ()), (121, ()), (121, (70, 5)),
                    (6416, ())):
        sp = np.exp(rng.normal(size=(R, N // 2 + 1)) * 3)
        sp[rng.random(sp.shape) < 0.05] = 0.0
        sp[0, :9] = 0.0
        ap = rng.uniform(1e-3, 1.0, sp.shape)
        sp, ap = (torch.as_tensor(a, dtype=dtype, device=cuda)
                  for a in (sp, ap))
        got = encode.encode_spectra(sp, ap, fs, N, *dims)
        want = encode.encode_spectra_plain(sp, ap, fs, N, *dims)
        lims = (encode.encode_spectra_limit(*want) if dtype == torch.float32
                else (1e-10, 1e-10))
        for g, w, lim in zip(got, want, lims):
            assert g.dtype == dtype and g.shape == w.shape
            assert ((g - w).abs() <= lim).all(), (R, float((g - w).abs()
                                                          .max()))


def test_k24_to_k27_and_k31_float64_match_plain(cuda):
    """The parity body's float64 stages against their twins: K24 at
    stride 1, K25's noisy log with the absolute floor and its lifter and
    exp, K26's four stages, K27 in numerator mode and K31 (bit-equal to
    its twin run on the CPU: the same values sorted, the same blocked sum
    in jnp.cumsum's order; a row with a NaN too)."""
    rng = np.random.default_rng(24)
    f64 = dict(dtype=torch.float64, device=cuda)
    R, H = 50, 1025
    spec = [torch.as_tensor(rng.standard_normal((R, H)), **f64)
            for _ in range(4)]
    f0s = torch.as_tensor(rng.uniform(80, 400, R), **f64)
    h = torch.trunc(prims.rdiv(1.5 * 48000, f0s) + 1.0).long()
    gate = torch.zeros(R, dtype=torch.bool, device=cuda)
    b_c = 4 * 2 ** torch.floor(torch.log((2 * h + 1).double())
                               / cfg.K_LOG2).long()
    keep = b_c == 2048
    args = [v[keep] for v in (*spec, f0s, h, gate)]
    args[:4] = [a[:, :1025] for a in args[:4]]
    got = sm.if_readout(*args, 48000, 2048)
    want = sm.if_readout_plain(*args, 48000, 2048)
    assert torch.allclose(got, want, rtol=1e-13, atol=0)
    ps = spec[0].abs() * 1e-3
    ps[:5, :100] = 0.0
    from hts_train_world_tpu_torch.ops import rand
    stream = rand.randn_stream(R * H + 16, cuda)
    noff = torch.arange(R, device=cuda) * H
    for stage, kw in ((ct.LOG, dict(noise=stream, noff=noff, parity=True)),
                      (ct.LIFTER, dict(cf0=f0s, fs=48000, fft_size=2048,
                                       q1=-0.15)), (ct.EXP, {})):
        g = ct.lifter(ps, stage, **kw)
        w = ct.lifter_plain(ps, stage, **kw)
        assert g.dtype == torch.float64
        assert torch.allclose(g, w, rtol=1e-14, atol=1e-300)
    f0 = torch.where(f0s > 300, torch.zeros_like(f0s), f0s)
    for g, w in zip(d4c_mod.love_train_sums(ps, f0, 9, 342, 674, 0.0),
                    d4c_mod.love_train_sums_plain(ps, f0, 9, 342, 674,
                                                  0.0)):
        assert torch.allclose(g.double(), w.double(), rtol=1e-13, atol=0)
    assert torch.allclose(d4c_mod.centroid_sum(*spec, *spec),
                          d4c_mod.centroid_sum_plain(*spec, *spec),
                          rtol=0, atol=0)
    assert torch.equal(d4c_mod.group_delay_ratio(spec[0], ps),
                       d4c_mod.group_delay_ratio_plain(spec[0], ps))
    win = torch.as_tensor(prims.nuttall_window_np(257), **f64)
    assert torch.equal(d4c_mod.band_segments(spec[0], spec[1], (3, 300),
                                             win),
                       d4c_mod.band_segments_plain(spec[0], spec[1],
                                                   (3, 300), win))
    p = ps.clone()
    p[7, 11] = float("nan")
    num, den = d4c_mod.band_sort_sums(p, H - 40)
    numw, denw = d4c_mod.band_sort_sums_plain(p.cpu(), H - 40)
    assert torch.equal(num.cpu(), numw) and torch.equal(
        torch.nan_to_num(den.cpu()), torch.nan_to_num(denw))
    assert bool(torch.isnan(den[7])) and not bool(torch.isnan(num[7]))
    cf0 = torch.clamp(f0s, min=47.0)
    process = f0s < 300
    for g, w in zip(d4c_mod.aperiodicity(den[:, None], num[:, None], cf0,
                                         process, 48000, 2048, num=True),
                    d4c_mod.aperiodicity_plain(den[:, None], num[:, None],
                                               cf0, process, 48000, 2048,
                                               num=True)):
        assert torch.allclose(g, w, rtol=1e-13, atol=0, equal_nan=True)


@pytest.mark.parametrize("fs,dur", [(16000, 0.6), (44100, 0.3)])
def test_parity_analysis_matches_the_cpu_path(cuda, fs, dur):
    """`vocoder.analyze` at parity on the card against the same call on
    the CPU: every float64 kernel launched, no twin; f0 at rel 1e-9, sp
    at rel 1.5e-8, ap at 1e-9 (the CPU tests' bounds against the JAX
    package)."""
    rng = np.random.default_rng(16)
    n = int(dur * fs)
    x = 0.5 * np.sin(2 * np.pi * np.cumsum(np.linspace(140, 260, n)) / fs) \
        + 0.01 * rng.standard_normal(n)
    x[n // 3:n // 2] = 0.05 * rng.standard_normal(n // 2 - n // 3)
    kernels.reset_counts()
    a = vocoder.analyze(x, fs, device=cuda)
    for name in ("frame_window", "spectral_smooth", "fix_f0",
                 "dio_candidates", "stonemask_if", "cheaptrick_lifter",
                 "d4c_group_delay", "d4c_aperiodicity"):
        assert kernels.launches[f"{name}[f64]"] > 0, name
    assert kernels.launches["d4c_band_sort"] > 0
    b = vocoder.analyze(x, fs, device="cpu")
    assert torch.allclose(a.f0.cpu(), b.f0, rtol=1e-9, atol=0)
    assert torch.allclose(a.spectrogram.cpu(), b.spectrogram, rtol=1.5e-8,
                          atol=0)
    assert torch.allclose(a.aperiodicity.cpu(), b.aperiodicity, rtol=0,
                          atol=1e-9)


# ---------------------------------------------------------------------------
# the HSMM variants: K33 (chain and posterior modes) and K34
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [2, 3])
def test_k33_chain_kernel_matches_plain(cuda, C):
    """K33's chain mode at the WORLD width on hostile inputs (an utterance
    with unvoiced-only MSD frames, a NaN in a weight-0 bap column, a
    component at the variance floor, one at the weight floor), one launch,
    against its twin on the card: within 1e-13 max(1, |ll|) (the kernel
    sums each quadratic form in sequence, the twin in torch's reduction
    order), NaN exactly where the twin's."""
    inp = chip_smoke.mix_chain_inputs(hsmm, cuda, C=C)
    kernels.reset_counts()
    got = hvar.batch_frame_loglik_mix(**inp)
    assert dict(kernels.launches) == {"hsmm_mix_loglik": 1}
    want = hvar.batch_frame_loglik_mix_plain(**inp)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int((~fin).sum()) == got.shape[2]      # the NaN bap frame
    assert ((got - want).abs()[fin]
            <= 1e-13 * want.abs()[fin].clamp(min=1.0)).all()


def test_k33_posterior_kernel_matches_plain(cuda):
    """K33's posterior mode, one launch for 4000 frames of 40 rows,
    against its twin on the card within 1e-13; the frames of the row whose
    second component sits at the variance floor get (1, 0) exactly, as the
    twin and numpy give them."""
    inp = chip_smoke.mix_post_inputs(cuda)
    kernels.reset_counts()
    got = hvar.responsibilities(**inp)
    assert dict(kernels.launches) == {"hsmm_mix_loglik[post]": 1}
    want = hvar.responsibilities_plain(**inp)
    assert float((got - want).abs().max()) <= 1e-13
    floored = inp["rows"] == 3
    assert (got[floored, 0] == 1.0).all() and (got[floored, 1] == 0.0).all()
    assert torch.equal(got[floored], want[floored])


@pytest.mark.parametrize("d,G,frames", [
    (1, 6, None), (2, 140, None), (25, 200, None), (50, 200, None),
    (25, 1, 26), (150, 161, None), (150, 2, 160), (180, 64, None),
    (260, 8, None)])
def test_k34_kernel_matches_plain(cuda, d, G, frames):
    """K34, two jobs in one launch (the scatters and the same scatters
    doubled), against its twin on the CPU, 20 iterations (3 at d = 180,
    1 at d = 260):
    A within 1e-9 of each job's max|A|, sigmas 1e-8 relative (the CPU
    tests' bounds against the JAX package), aux within 1e-12 of the larger
    of |aux| and its sigma term 0.5 sum_g beta_g sum_j |log sigma_gj|
    (`chip_smoke.aux_scale`: aux is a difference of two such terms, and
    doubling the scatters moves it from 235 to 9.6 at (25, 1, 26) while the
    terms stay ~800).  (25, 1, 26): one Gaussian of d + 1 frames, a G_r
    near singular (condition ~5e4).  d = 150 is mgc's full transform: the
    sweep keeps inv(A) in shared memory and A, A's LU and G_r's factors in
    device memory, and each G_r is factorised in shared memory;
    (150, 2, 160): two Gaussians of 160 frames, scatters of condition
    ~1e7, for the rank-one updates' error over 150 rows on ill-conditioned
    data; d = 180 factorises every G_r in place in device memory and keeps
    inv(A) there too; d = 260 solves with the vector in shared memory
    rather than in registers."""
    n_iter = 20 if d <= 166 else 3 if d <= 256 else 1
    betas, scat = chip_smoke.semitied_inputs(d, G, 7 + d, frames)
    b = torch.as_tensor(betas, dtype=torch.float64)
    s = torch.as_tensor(np.stack([scat, 2.0 * scat]), dtype=torch.float64)
    kernels.reset_counts()
    got = hvar.semitied_blocks(b.to(cuda), s.to(cuda), n_iter)
    assert dict(kernels.launches) == {"semitied": 1}
    want = hvar.semitied_blocks_plain(b, s, n_iter)
    (ak, sk, xk), (ap, sp, xp) = [tuple(t.cpu() for t in o)
                                  for o in (got, want)]
    assert ((ak - ap).abs().amax((1, 2))
            <= 1e-9 * ap.abs().amax((1, 2))).all()
    assert ((sk - sp).abs() <= 1e-8 * sp).all()
    scale = chip_smoke.aux_scale(b, sp, xp)
    assert ((xk - xp).abs() <= 1e-12 * scale).all()


def test_estimate_semitied_full_mgc_matches_the_cpu_path(cuda):
    """`estimate_semitied(n_blocks={"mgc": 1})` on the HSMM lane's corpus
    (`chip_smoke.hsmm_corpus`, D = 237: mgc's transform is 150 x 150) on
    the card and on the CPU (`chip_smoke.semitied_full_card_vs_cpu`):
    transforms within 1e-9 of max|A|, logdets 1e-9; K34 launched once a
    stream, the mgc launch at d = 150."""
    ms, utts = chip_smoke.hsmm_corpus(hsmm)
    mono = [(f, list(seq)) for f, seq in utts]
    kernels.reset_counts()
    kernels.record = []
    try:
        chip_smoke.semitied_full_card_vs_cpu(ms, mono, (cuda, "cpu"))
        rec = kernels.record
    finally:
        kernels.record = None
    ds = [i["scatters"].shape[2] for n, i in rec if n == "semitied"]
    assert kernels.launches["semitied"] == len(ms.streams)
    assert 150 in ds


@pytest.mark.parametrize("C,Kb,Tb", [(1, 1, 37), (2, 84, 130), (3, 85, 129),
                                     (8, 132, 200), (2, 132, 256)])
def test_k33_chain_tiles_match_plain(cuda, C, Kb, Tb):
    """K33's chain mode at the WORLD width over state and frame counts
    that leave its tiles partly filled (Kb 1, 85, 132; T of 37, 129, 130
    and 200, not a multiple of its 64 frames, beside 256, which fills its
    tiles) and C = 1, 2, 3, 8 (each C's own tile): within 1e-13
    max(1, |ll|) of the twin, NaN where the twin's."""
    inp = chip_smoke.mix_chain_inputs(hsmm, cuda, C=C, B=2, Tb=Tb, Kb=Kb,
                                      seed=33 + Kb)
    kernels.reset_counts()
    got = hvar.batch_frame_loglik_mix(**inp)
    assert dict(kernels.launches) == {"hsmm_mix_loglik": 1}
    want = hvar.batch_frame_loglik_mix_plain(**inp)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert ((got - want).abs()[fin]
            <= 1e-13 * want.abs()[fin].clamp(min=1.0)).all()


def test_k33_reuses_its_row_tables_across_launches(cuda):
    """The row prologue's buffer is cached per mixture set: a second
    launch on the same tables hits (the same buffer, equal results); an
    in-place change of a variance table misses, and the result follows the
    change (equal to the twin on the changed tables)."""
    inp = chip_smoke.mix_chain_inputs(hsmm, cuda)
    hvar._MIX_ROW_TABLES.clear()
    first = hvar.batch_frame_loglik_mix(**inp)
    assert len(hvar._MIX_ROW_TABLES) == 1
    buf = next(iter(hvar._MIX_ROW_TABLES.values()))[1]
    again = hvar.batch_frame_loglik_mix(**inp)
    assert len(hvar._MIX_ROW_TABLES) == 1
    assert next(iter(hvar._MIX_ROW_TABLES.values()))[1] is buf
    assert torch.equal(torch.isnan(first), torch.isnan(again))
    assert torch.equal(torch.nan_to_num(first), torch.nan_to_num(again))
    inp["variances"][0].mul_(2.0)
    changed = hvar.batch_frame_loglik_mix(**inp)
    assert len(hvar._MIX_ROW_TABLES) == 2
    want = hvar.batch_frame_loglik_mix_plain(**inp)
    fin = torch.isfinite(want)
    assert ((changed - want).abs()[fin]
            <= 1e-13 * want.abs()[fin].clamp(min=1.0)).all()
    assert not torch.equal(torch.nan_to_num(changed),
                           torch.nan_to_num(first))


def test_k33_quotient_is_the_division(cuda):
    """The chain kernel's terms (1/v, then two corrections where its range
    tests on x, mu and v pass, else the division) against IEEE division
    bit for bit on 2e7 draws (`chip_smoke.quotient_check`: x, mu and v of
    the test batch, and x, mu over 2^+-530 and v over 2^+-70 with special
    values)."""
    inp = chip_smoke.mix_chain_inputs(hsmm, cuda)
    n, bad = chip_smoke.quotient_check(hvar, [inp])
    assert n == 2 * chip_smoke.QUOT_DRAWS and bad == 0


def test_variant_recipe_matches_the_cpu_path(cuda):
    """`train_voice` at TINY_RECIPE with SEMIT and UPMIX on the card and on
    the CPU (`chip_smoke.variants_card_vs_cpu`): the mixture and the
    semi-tied set within the CPU tests' bounds; K33's two launchers and
    K34 launched on the card."""
    kernels.reset_counts()
    chip_smoke.variants_card_vs_cpu((cuda, "cpu"))
    for name in ("hsmm_mix_loglik", "hsmm_mix_loglik[post]", "semitied",
                 "hsmm_viterbi", "hsmm_loglik"):
        assert kernels.launches[name] > 0, name


def test_variant_wrappers_reject_what_the_kernels_do_not_take(cuda):
    inp = chip_smoke.mix_chain_inputs(hsmm, cuda)
    with pytest.raises(ValueError):
        hvar.batch_frame_loglik_mix(**{**inp, "frames": inp["frames"].float()})
    with pytest.raises(ValueError):
        hvar.batch_frame_loglik_mix(**{**inp, "rows": tuple(
            r.int() for r in inp["rows"])})
    with pytest.raises(ValueError):                 # log-weights of C + 1
        hvar.batch_frame_loglik_mix(**{**inp, "logws": tuple(
            torch.cat([w, w[:, :1]], 1) for w in inp["logws"])})
    nine = tuple(m[:, :1].expand(-1, 9, -1).contiguous()
                 for m in inp["means"])
    with pytest.raises(ValueError):                 # C above the maximum
        hvar.batch_frame_loglik_mix(**{**inp, "means": nine, "variances": nine,
                                     "logws": tuple(w[:, :1].expand(-1, 9)
                                                    for w in inp["logws"])})
    post = chip_smoke.mix_post_inputs(cuda)
    with pytest.raises(ValueError):
        hvar.responsibilities(**{**post, "x": post["x"].float()})
    with pytest.raises(ValueError):
        hvar.responsibilities(**{**post, "rows": post["rows"][:-1]})
    with pytest.raises(ValueError):
        hvar.responsibilities(**{**post, "x": post["x"][:, :-1]})
    m9 = post["means"][:, :1].expand(-1, 9, -1).contiguous()
    with pytest.raises(ValueError):
        hvar.responsibilities(**{**post, "means": m9, "variances": m9,
                               "logw": post["logw"][:, :1].expand(-1, 9)})
    betas, scat = chip_smoke.semitied_inputs(4, 5, 0)
    b = torch.as_tensor(betas, device=cuda)
    s = torch.as_tensor(scat, device=cuda)[None]
    with pytest.raises(ValueError):
        hvar.semitied_blocks(b.float(), s.float(), 2)
    with pytest.raises(ValueError):
        hvar.semitied_blocks(b, s[0], 2)               # not (J, G, d, d)
    with pytest.raises(ValueError):
        hvar.semitied_blocks(b[:-1], s, 2)


def _sptk_pitch(T, fs, seed=35):
    """A per-frame period contour: 220 Hz with a 6 Hz vibrato, two unvoiced
    runs."""
    t = np.arange(T) * 0.005
    p = fs / (220.0 * 2.0 ** (0.5 / 12.0 * np.sin(2 * np.pi * 6.0 * t)))
    p[10:18] = 0.0
    p[T // 2:T // 2 + 5] = 0.0
    return p


@pytest.mark.parametrize("fs,shift,period", [
    (16000, 80, 80.0), (16000, 80, 100.0), (16000, 80, 120.0),
    (48000, 240, 240.0), (48000, 240, "contour")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k35_kernel_matches_the_cpu_twin_bit_for_bit(cuda, fs, shift, period,
                                                     dtype):
    """K35 against its twin run on the CPU, bit for bit (the pulses at
    periods that divide the frame are rounding ties), one launch."""
    from hts_train_world_tpu_torch.ops import excitation as ex
    T = 530 if fs == 48000 else 60
    p = (_sptk_pitch(T, fs) if period == "contour"
         else np.full(T, float(period)))
    if period != "contour":
        p[20:26] = 0.0
    n = (T - 1) * shift
    noise = torch.as_tensor(np.random.default_rng(1).standard_normal(n),
                            dtype=dtype)
    pitch = torch.as_tensor(p, dtype=dtype)
    kernels.reset_counts()
    y, v = ex.excite(pitch.to(cuda), shift, noise.to(cuda))
    assert dict(kernels.launches) == {"excite": 1}
    y_c, v_c = ex.excite_plain(pitch, shift, noise)
    assert torch.equal(v.cpu(), v_c) and torch.equal(y.cpu(), y_c)
    assert int((v_c & (y_c != 0)).sum()) >= 20


@pytest.mark.parametrize("fs,shift,T", [(16000, 80, 60), (48000, 240, 530)])
def test_k35_kernel_from_lf0_matches_the_cpu_twin_bit_for_bit(cuda, fs,
                                                              shift, T):
    """K35 given lf0 and the sampling rate: the period from XLA's exp on
    the card (the device's fma) and the pulses, bit for bit against the
    twin (`lf0_to_pitch`, `prims.xla_exp`) on the CPU, one launch."""
    from hts_train_world_tpu_torch.ops import excitation as ex
    p = _sptk_pitch(T, fs)
    lf0 = torch.as_tensor(np.where(p > 0, np.log(fs / np.maximum(p, 1.0)),
                                   ex.MAGIC))
    n = (T - 1) * shift
    noise = torch.as_tensor(np.random.default_rng(2).standard_normal(n))
    kernels.reset_counts()
    y, v = ex.excite(lf0.to(cuda), shift, noise.to(cuda), sr=fs)
    assert dict(kernels.launches) == {"excite": 1}
    y_c, v_c = ex.excite_plain(lf0, shift, noise, sr=fs)
    assert torch.equal(v.cpu(), v_c) and torch.equal(y.cpu(), y_c)
    assert int((v_c & (y_c != 0)).sum()) >= 20


def test_k36_kernel_matches_plain(cuda):
    """K36 on the 48 kHz excitations against its twin on the card, within
    1e-13 of max |y| (the same taps in the same order)."""
    from hts_train_world_tpu_torch.features import filters
    from hts_train_world_tpu_torch.ops import excitation as ex
    rng = np.random.default_rng(36)
    n = 529 * 240
    v = torch.as_tensor(rng.standard_normal(n), device=cuda)
    u = torch.as_tensor(rng.standard_normal(n), device=cuda)
    low, high = filters.band_split_filters(48000)
    kernels.reset_counts()
    got = ex.band_fir(v, u, low, high)
    assert dict(kernels.launches) == {"band_fir": 1}
    want = ex.band_fir_plain(v, u, low, high)
    assert float((got - want).abs().max()) <= 1e-13 * float(
        want.abs().max())


@pytest.mark.parametrize("fs,N", [(16000, 512), (16000, 1024),
                                  (16000, 1000), (48000, 2048),
                                  (96000, 4096)])
def test_k37_kernel_matches_plain(cuda, fs, N):
    """K37's two launchers against the twin (torch.fft, index_add_) on the
    card, within 1e-11 of max |y|: the frames on K39's FFT core (the dense
    plan at N 512, where L = 160 > N/4; the sparse plan at 1024, 2048 and
    4096), and the direct DFT at an N that is not a power of two."""
    from hts_train_world_tpu_torch.ops import excitation as ex
    rng = np.random.default_rng(37)
    shift, T, M = fs // 200, 80, 50
    mgc = rng.standard_normal((T, M)) * 0.1 / (1.0 + np.arange(M))
    mgc[:, 0] += 0.5
    exc = torch.as_tensor(rng.standard_normal((T - 1) * shift),
                          device=cuda)
    mgc = torch.as_tensor(mgc, device=cuda)
    kernels.reset_counts()
    got = ex.mglsa_synthesis(exc, mgc, 0.42, shift, N)
    assert dict(kernels.launches) == {"mglsa_filter": 2}
    want = ex.mglsa_synthesis_plain(exc, mgc, 0.42, shift, N)
    assert float((got - want).abs().max()) <= 1e-11 * float(
        want.abs().max())


def test_k37_takes_mgc_with_a_row_stride(cuda):
    """mgc as a column slice of a wider array (as the engine's statics
    may be): the kernel reads it in place, no copy, the same waveform as
    from its contiguous copy, bit for bit."""
    from hts_train_world_tpu_torch.ops import excitation as ex
    rng = np.random.default_rng(37)
    wide = rng.standard_normal((60, 75)) * 0.05 / (1.0 + np.arange(75))
    wide[:, 0] -= 2.0
    wide = torch.as_tensor(wide, device=cuda)
    exc = torch.as_tensor(rng.standard_normal(59 * 240), device=cuda)
    got = ex.mglsa_synthesis(exc, wide[:, :50], 0.55, 240, 2048)
    want = ex.mglsa_synthesis(exc, wide[:, :50].contiguous(), 0.55, 240,
                              2048)
    assert torch.equal(got, want)


def _smooth_logp(T, N, seed=38):
    """Log amplitude spectra (T, N/2+1) of a random 20-term cepstrum (a
    vowel-like envelope) with a 2 % ripple."""
    rng = np.random.default_rng(seed)
    k = np.arange(N // 2 + 1)
    c = rng.standard_normal((T, 20)) * 0.5 / (1.0 + np.arange(20))
    env = c @ np.cos(np.pi * np.outer(np.arange(20), k) / (N // 2))
    return env + 0.02 * rng.standard_normal((T, N // 2 + 1)) - 2.0


@pytest.mark.parametrize("N,order,alpha", [(1024, 24, 0.42),
                                           (2048, 49, 0.55)])
def test_k38_kernel_matches_plain(cuda, N, order, alpha):
    """K38 against its twin (FFT form, torch.linalg.solve) on the card,
    30 Newton steps, within 1e-9 of max |mc|."""
    from hts_train_world_tpu_torch.ops import sptk
    lp = torch.as_tensor(_smooth_logp(64, N), device=cuda)
    kernels.reset_counts()
    got = sptk.mcep(lp, order, alpha, N)
    assert dict(kernels.launches) == {"mcep_newton": 1}
    want = sptk.mcep_plain(lp, order, alpha, N)
    assert torch.isfinite(want).all()
    assert float((got - want).abs().max()) <= 1e-9 * float(
        want.abs().max())


def test_sptk_engine_matches_the_cpu_path(cuda):
    """`generate_waveform(engine="sptk")` at 48 kHz with mgc 50 on the
    card and on the CPU with the same injected noise, within 1e-10 of max
    |y|; K35-K37 launched (`chip_smoke.sptk_card_vs_cpu`)."""
    rng = np.random.default_rng(39)
    T = 200
    lf0 = np.log(48000.0 / _sptk_pitch(T, 48000).clip(min=1.0))[:, None]
    lf0[_sptk_pitch(T, 48000) == 0.0] = -1e10
    mgc = rng.standard_normal((T, 50)) * 0.05 / (1.0 + np.arange(50))
    mgc[:, 0] -= 2.0
    statics = {"lf0": torch.as_tensor(lf0), "mgc": torch.as_tensor(mgc)}
    kernels.reset_counts()
    chip_smoke.sptk_card_vs_cpu((statics, torch.ones(T, dtype=torch.bool)),
                                48000, 0.55, (cuda, "cpu"))
    for name in ("excite", "band_fir", "mglsa_filter"):
        assert kernels.launches[name] > 0, name


def test_sptk_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from hts_train_world_tpu_torch.ops import excitation as ex
    from hts_train_world_tpu_torch.ops import sptk
    p = torch.full((10,), 100.0, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):                 # noise of another type
        ex.excite(p, 80, torch.zeros(720, device=cuda))
    with pytest.raises(ValueError):                 # noise of another length
        ex.excite(p, 80, torch.zeros(700, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):                 # lf0 in float32
        ex.excite(p.float(), 80, torch.zeros(720, device=cuda), sr=16000)
    x = torch.zeros(720, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):                 # 65 taps
        ex.band_fir(x, x, np.ones(65), np.ones(65))
    with pytest.raises(ValueError):                 # N below 4 shift
        ex.mglsa_synthesis(x, torch.zeros(10, 5, dtype=torch.float64,
                                          device=cuda), 0.42, 80, 256)
    with pytest.raises(ValueError):                 # mgc of another type
        ex.mglsa_synthesis(x, torch.zeros(10, 5, device=cuda), 0.42, 80,
                           1024)
    with pytest.raises(ValueError):                 # float32 (K37: float64)
        ex.mglsa_synthesis(x.float(), torch.zeros(10, 5, device=cuda), 0.42,
                           80, 1024)
    with pytest.raises(ValueError):                 # bins for another N
        sptk.mcep(torch.zeros(4, 100, dtype=torch.float64, device=cuda), 24,
                  0.42, 1024)
    with pytest.raises(ValueError):                 # order above 127
        sptk.mcep(torch.zeros(4, 513, dtype=torch.float64, device=cuda), 128,
                  0.42, 1024)


# ---------------------------------------------------------------------------
# K39 / K40: the DFTs
# ---------------------------------------------------------------------------

FFT_SIZES = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _fft_rows(R, L, seed, dtype, device):
    """Random rows, with row 1 zeros and row 2 a single impulse."""
    x = np.random.default_rng(seed).standard_normal((R, L))
    x[1] = 0.0
    x[2] = 0.0
    x[2, (3 * L) // 4] = 1.0
    return torch.as_tensor(x, dtype=dtype, device=device)


def _fft_worst(got, want, scale):
    """The worst |got - want| / scale, element by element."""
    return max(float(((g.double() - w).abs() / scale.clamp(min=1e-300))
                     .max()) for g, w in zip(got, want))


# Error scales, element by element: a DFT is off by a few roundings of
# its row's RMS (for K39 the input's 2-norm, for K40 sqrt(sum_k w_k
# |X_k|^2)) plus the rounding of the element itself, so the scale is that
# RMS plus the element's magnitude; a power bin's error is 2 |X| times its
# bin's.  K39/K40 transform in float64 and round once to the rows' type:
# within FFT_TOL (float32: a few roundings at 2^-24; float64: at 2^-52),
# and no farther from the float64 DFT than the table twin on the card, or
# than ONE_ROUNDING where both are that close.
FFT_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
ONE_ROUNDING = {torch.float32: 2.0 ** -23, torch.float64: 2.0 ** -52}


def _r2c_scales(x, ref):
    nrm = x.pow(2).sum(-1, keepdim=True).sqrt()
    mag = ref.abs()
    return nrm + mag, (nrm + mag) * (2.0 * mag + nrm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", FFT_SIZES)
def test_k39_kernel_matches_the_twin_and_a_float64_dft(cuda, N, dtype):
    """Each mode on rows of 1, N/3 and N samples (5 rows: fewer than a
    block's worth of anything), zeros and an impulse among them: within
    FFT_TOL of a float64 torch.fft on its error scale, and no farther from
    it than the table twin on the card."""
    for L in (1, N // 3, N):
        x = _fft_rows(5, L, N + L, dtype, cuda)
        ref = torch.fft.rfft(x.double(), n=N)
        sc, sc_p = _r2c_scales(x.double(), ref)
        re, im = fftmat.r2c(x, N, fftmat.REIM)
        tre, tim = fftmat.r2c_plain(x, N, fftmat.REIM)
        e_k = _fft_worst((re, im), (ref.real, ref.imag), sc)
        e_t = _fft_worst((tre, tim), (ref.real, ref.imag), sc)
        assert re.dtype == dtype and re.shape == (5, N // 2 + 1)
        assert e_k <= FFT_TOL[dtype] and e_k <= max(e_t, ONE_ROUNDING[dtype])
        p = fftmat.r2c(x, N, fftmat.POWER)
        assert _fft_worst((p,), (ref.abs() ** 2,), sc_p) <= FFT_TOL[dtype]
        assert torch.equal(re[1], torch.zeros_like(re[1]))
    c = _fft_rows(3, N // 2 + 1, N, dtype, cuda)
    folded = c.double() * fftmat.fold_weights(N, torch.float64, cuda)
    ref = torch.fft.rfft(folded, n=N)
    re, im = fftmat.r2c(c, N, fftmat.FOLD)
    assert _fft_worst((re, im), (ref.real, ref.imag),
                      _r2c_scales(folded, ref)[0]) <= FFT_TOL[dtype]


# (N, L, mode): a copy-synthesis batch's K39 launches (StoneMask,
# CheapTrick, D4C's LoveTrain, centroid, MEAN and bands, synthesis' noise
# and fold), then the edges of L at their two sizes
K39_LAUNCHES = tuple(dict.fromkeys((
    (4096, 2048, 0), (2048, 2048, 1), (4096, 3712, 1), (4096, 2816, 0),
    (4096, 2816, 1), (4096, 513, 1), (2048, 2048, 0), (2048, 1025, 2))
    + tuple((N, L, m) for N in (2048, 4096)
            for L in (1, N // 4, N // 4 + 1, N // 2, N // 2 + 1, N)
            for m in (0, 1, 2) if m != 2 or L <= N // 2 + 1)))


@pytest.mark.parametrize("N,L,mode", K39_LAUNCHES)
def test_k39_at_the_batch_launches_by_check_fft_rule(cuda, N, L, mode):
    """K39 at the shapes a copy-synthesis batch gives it, and at the edges
    of L, on 70 rows (harmonic rows, whose peak bins are ~20x their norm,
    among random ones, zeros and an impulse): within 1e-6 of a float64
    torch.fft on the element scale and no farther from it than the table
    twin, as chip_smoke.py's `check_fft` holds each replayed launch."""
    x = _fft_rows(70, L, N + L + mode, torch.float32, cuda)
    n = torch.arange(L, device=cuda, dtype=torch.float64)
    for r in range(3, 20):
        f0 = 80.0 + 20.0 * r
        x[r] = sum(torch.cos(2 * np.pi * h * f0 * n / 48000.0 + h)
                   for h in range(1, 12)).float()
    x64 = x.double()
    if mode == fftmat.FOLD:
        x64 = x64 * fftmat.fold_weights(N, torch.float64, cuda)[:L]
    ref = torch.fft.rfft(x64, n=N)
    sc, sc_p = _r2c_scales(x64, ref)
    got = fftmat.r2c(x, N, mode)
    twin = fftmat.r2c_plain(x, N, mode)
    if mode == fftmat.POWER:
        want, scale = (ref.abs() ** 2,), sc_p
        got, twin = (got,), (twin,)
    else:
        want, scale = (ref.real, ref.imag), sc
    e_k = _fft_worst(got, want, scale)
    assert e_k <= 1e-6 and e_k <= _fft_worst(twin, want, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", FFT_SIZES)
def test_k40_kernel_matches_the_twin_and_a_float64_dft(cuda, N, dtype):
    """Both output lengths, with and without Im, on 70 rows (zeros and
    an impulse among them; more than a block's rows at every N): within
    FFT_TOL of a float64 irfft * N on its error scale, and no farther from
    it than the table twin."""
    H = N // 2 + 1
    re = _fft_rows(70, H, N + 1, dtype, cuda)
    im = _fft_rows(70, H, N + 2, dtype, cuda)
    w = torch.full((H,), 2.0, dtype=torch.float64, device=cuda)
    w[0] = w[-1] = 1.0
    for imag in (im, None):
        i64 = (torch.zeros_like(re.double()) if imag is None
               else imag.double().clone())
        i64[:, 0] = i64[:, -1] = 0.0
        ref = torch.fft.irfft(torch.complex(re.double(), i64), n=N) * N
        rms = (w * (re.double() ** 2 + i64 ** 2)).sum(-1, keepdim=True).sqrt()
        for n_out in (N, H):
            got = fftmat.c2r(re, imag, N, n_out)
            twin = fftmat.c2r_plain(re, imag, N, n_out)
            assert got.dtype == dtype and got.shape == (70, n_out)
            want = ref[:, :n_out]
            e_k = _fft_worst((got,), (want,), rms + want.abs())
            e_t = _fft_worst((twin,), (want,), rms + want.abs())
            assert e_k <= FFT_TOL[dtype]
            assert e_k <= max(e_t, ONE_ROUNDING[dtype])


def test_fft_public_functions_launch_the_kernels(cuda):
    """On CUDA tensors the six functions launch K39/K40 (minphase_log
    once each) and run no table product."""
    N = 2048
    x = _fft_rows(4, 1500, 1, torch.float32, cuda)
    h = _fft_rows(4, N // 2 + 1, 2, torch.float32, cuda)
    kernels.reset_counts()
    fftmat.table_calls.clear()
    fftmat.rfft(x, N)
    fftmat.rfft_power(x, N)
    fftmat.irfft_scaled(h, h, N)
    fftmat.minphase_log(h, N)
    fftmat.sym_rfft_real(h, N)
    fftmat.irfft_half(h, N)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {"fft_r2c": 3, "fft_c2r": 4}
    assert not fftmat.table_calls
    got = fftmat.minphase_log(h, N)
    want = fftmat.minphase_log_matmul(h, N)
    assert all(float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
               for g, w in zip(got, want))


def test_fft_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((3, 100), device=cuda)
    h = torch.zeros((3, 513), device=cuda)
    with pytest.raises(ValueError):
        fftmat.rfft(x, 1000)                    # not a power of two
    with pytest.raises(ValueError):
        fftmat.rfft(x, 32)                      # below 64, and L > N
    with pytest.raises(ValueError):
        fftmat.rfft(torch.zeros((3, 300), device=cuda), 256)   # L > N
    with pytest.raises(ValueError):
        fftmat.rfft(x.int(), 1024)              # an integer dtype
    with pytest.raises(ValueError):
        fftmat.rfft_power(x, 16384)             # past 8192
    with pytest.raises(ValueError):
        fftmat.irfft_scaled(h, h.double(), 1024)
    with pytest.raises(ValueError):
        fftmat.irfft_half(h, 2048)              # not N/2+1 bins
    with pytest.raises(ValueError):
        fftmat.minphase_log(h.int(), 1024)
