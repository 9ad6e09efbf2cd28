"""The PyTorch port's kernels (K1-K4) and constant tables against the JAX
package.

On the CPU each kernel wrapper runs its plain PyTorch twin; these tests
hold the twins against the JAX functions on the same numpy inputs.
`tests/test_torch_cuda.py` holds each CUDA kernel against its twin on the
card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu.ops import d4c as jd4c
from hts_train_world_tpu.ops import dio as jdio
from hts_train_world_tpu.ops import fftmat as jfm
from hts_train_world_tpu.ops import prims as jprims
from hts_train_world_tpu.ops import synthesis as jsyn
from hts_train_world_tpu_torch.ops import dio, fftmat, frames, prims
from hts_train_world_tpu_torch.ops import synthesis


# ---------------------------------------------------------------------------
# constant tables: bit-equal to the JAX package's numpy arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N", [1024, 2048])
@pytest.mark.parametrize("name", ["_rfft_mats_np", "_irfft_mats_np",
                                  "_minphase_mats_np",
                                  "_sym_rfft_real_mat_np",
                                  "_irfft_half_mats_np"])
def test_fftmat_tables_bit_equal(name, N):
    a = getattr(fftmat, name)(N)
    b = getattr(jfm, name)(N)
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and np.array_equal(u, v)


def test_fftmat_full_precision_is_scoped():
    """The DFT matmuls run with TF32 off and leave the caller's matmul
    settings as they were."""
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with fftmat.full_precision():
            inside = (torch.get_float32_matmul_precision(),
                      torch.backends.cuda.matmul.allow_tf32)
        assert inside == ("highest", False)
        assert torch.get_float32_matmul_precision() == "high"
        x = np.random.default_rng(0).standard_normal((3, 10))
        re, im = fftmat.rfft_matmul(torch.as_tensor(x), 16)
        assert torch.get_float32_matmul_precision() == "high"
        np.testing.assert_allclose((re + 1j * im).numpy(),
                                   np.fft.rfft(x, 16), atol=1e-12)
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("fs,L", [(16000, 8000), (48000, 96000)])
def test_dio_band_filter_specs_bit_equal(fs, L):
    plan = dio.dio_plan(L, fs)
    assert plan == jdio.dio_plan(L, fs)
    args = (plan["fft_size"], int(plan["actual_fs"] / 50.0 + 0.5),
            tuple(plan["boundary_f0"]), plan["actual_fs"])
    assert np.array_equal(dio._band_filter_specs_np(*args),
                          jdio._band_filter_specs_np(*args))


@pytest.mark.parametrize("N", [1024, 2048])
def test_dc_remover_bit_equal(N):
    assert np.array_equal(synthesis._dc_remover_np(N),
                          np.asarray(jsyn._dc_remover(N, jnp.float64)))


@pytest.mark.parametrize("n", [171, 513])
def test_nuttall_window_bit_equal(n):
    assert np.array_equal(prims.nuttall_window_np(n),
                          np.asarray(jprims.nuttall_window(n, jnp.float64)))


# ---------------------------------------------------------------------------
# K2: dc_correction / linear_smoothing
# ---------------------------------------------------------------------------


def _spectra(R, n, seed, signed=False):
    rng = np.random.default_rng(seed)
    env = np.exp(-np.linspace(0, 8, n))[None, :]
    if signed:
        return (rng.standard_normal((R, n)) * env).astype(np.float32)
    return (rng.standard_normal((R, n)) ** 2 * env + 1e-6).astype(np.float32)


@pytest.mark.parametrize("fs,N,fmax_ratio", [(16000, 1024, 2.0 / 3.0),
                                             (48000, 4096, 1.0)])
@pytest.mark.parametrize("mode", ["dc", "ls", "both", "ls_signed"])
def test_k2_plain_matches_jax(fs, N, fmax_ratio, mode):
    """Plain K2 vs prims.dc_correction / linear_smoothing (f32 branches);
    atol 1e-5 x the row's max."""
    R, half = 24, N // 2
    fmax = max(fs / 12.0, 800.0)
    ul_max = 2 + int(fmax * N / fs) + 1
    b_max = int(fmax * fmax_ratio * N / fs) + 1
    rng = np.random.default_rng(7)
    f0 = rng.uniform(60.0, fmax, R).astype(np.float32)
    width = (f0 * fmax_ratio).astype(np.float32)
    ps = _spectra(R, half + 1, 1, signed=mode == "ls_signed")

    def jax_row(p, f, w):
        if mode in ("dc", "both"):
            p = jprims.dc_correction(p, f, fs, N, ul_max)
        if mode != "dc":
            p = jprims.linear_smoothing(p, w, fs, N, b_max)
        return p

    want = np.asarray(jax.vmap(jax_row)(jnp.asarray(ps), jnp.asarray(f0),
                                        jnp.asarray(width)))
    got = prims.smooth_spectrum(
        torch.as_tensor(ps), fs, N,
        f0=torch.as_tensor(f0) if mode in ("dc", "both") else None,
        ul_max=ul_max,
        width=torch.as_tensor(width) if mode != "dc" else None,
        b_max=b_max).numpy()
    tol = 1e-5 * np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= tol).all()


def _harmonic_rows(R, n, seed):
    """Power-spectrum-like rows: four harmonic peaks on a noise floor six
    decades down, the rows' levels spread over twelve decades."""
    rng = np.random.default_rng(seed)
    j = np.arange(n)[None, :]
    c = rng.uniform(4.0, 20.0, (R, 1))
    peaks = sum(a * np.exp(-((j - h * c) / 1.5) ** 2)
                for h, a in enumerate([1.0, 0.4, 0.2, 0.05], 1))
    floor = 1e-6 * rng.standard_normal((R, n)) ** 2
    return ((peaks + floor) * 10.0 ** rng.uniform(-6, 6, (R, 1))
            ).astype(np.float32)


def test_k2_smoothing_resolves_every_bin():
    """The twin sums in float64: with read positions exact in f32, every
    bin equals the float64 smoothing of the same rows to f32 rounding (of
    rows * fs/N and of the result), down to the noise floor six decades
    under the peaks.  The JAX package's f32 sums (acc=float32) lose those
    bins to cancellation."""
    fs, N, R, b_max = 16000, 1024, 16, 40
    rng = np.random.default_rng(5)
    ps = torch.as_tensor(_harmonic_rows(R, N // 2 + 1, 6))
    # width * N / fs / 2 = m + 0.5 exactly
    width = torch.as_tensor((31.25 * (rng.integers(1, 30, R) + 0.5))
                            .astype(np.float32))
    want = prims.smooth_spectrum_plain(ps.double(), fs, N,
                                       width=width.double(), b_max=b_max)
    local = prims.smooth_spectrum_plain(ps.double().abs(), fs, N,
                                        width=width.double(), b_max=b_max)
    eps = np.finfo(np.float32).eps
    tol = 2 * eps * local + eps * want.abs()

    got = prims.smooth_spectrum_plain(ps, fs, N, width=width, b_max=b_max)
    assert got.dtype == torch.float32
    assert ((got.double() - want).abs() <= tol).all()
    f32_sums = prims.smooth_spectrum_plain(ps, fs, N, width=width,
                                           b_max=b_max, acc=torch.float32)
    assert ((f32_sums.double() - want).abs() > tol).double().mean() > 0.5


def test_k2_f32_sums_are_the_jax_branch():
    """acc=float32 is the JAX package's f32 linear_smoothing (the
    formulation chip_smoke.py reports beside the kernel's): atol 1e-5 x
    the row's max, as test_k2_plain_matches_jax."""
    fs, N, R, b_max = 48000, 2048, 12, 114
    rng = np.random.default_rng(9)
    ps = _harmonic_rows(R, N // 2 + 1, 2)
    width = rng.uniform(50.0, 500.0, R).astype(np.float32)
    want = np.asarray(jax.vmap(lambda p, w: jprims.linear_smoothing(
        p, w, fs, N, b_max))(jnp.asarray(ps), jnp.asarray(width)))
    got = prims.smooth_spectrum_plain(
        torch.as_tensor(ps), fs, N, width=torch.as_tensor(width),
        b_max=b_max, acc=torch.float32).numpy()
    tol = 1e-5 * np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= tol).all()


# ---------------------------------------------------------------------------
# K3: exact top-k sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 65, 300])
def test_k3_plain_matches_jax(k):
    """Threshold bit-equal to the k-th largest value (the JAX bisection's
    invariant); sum within rtol 1e-6 of prims.sum_top_k and of the exact
    f64 sum."""
    rng = np.random.default_rng(k)
    p = (rng.standard_normal((40, 2049)) ** 2).astype(np.float32)
    p[::3, ::7] = np.round(p[::3, ::7], 1)      # ties
    p[5] = 0.0
    s, thr = prims.top_k_threshold_sum(torch.as_tensor(p), k)
    kth = -np.sort(-p, axis=1)[:, k - 1]
    assert np.array_equal(thr.numpy().view(np.int32), kth.view(np.int32))
    want = np.asarray(jax.vmap(lambda r: jprims.sum_top_k(r, k))(
        jnp.asarray(p)))
    exact = np.sort(p.astype(np.float64), axis=1)[:, -k:].sum(axis=1)
    np.testing.assert_allclose(s.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(s.numpy(), exact, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# K4: fix_f0_contour
# ---------------------------------------------------------------------------


def _contour_inputs(B, bands, T, seed):
    rng = np.random.default_rng(seed)
    track = 150.0 + 40.0 * np.sin(np.arange(T) / 9.0 + rng.uniform(0, 6))
    cands = track[None, None, :] * rng.choice(
        [0.5, 1.0, 1.0, 2.0], size=(B, bands, 1)) \
        * (1.0 + 0.03 * rng.standard_normal((B, bands, T)))
    cands = np.where(rng.random((B, bands, T)) < 0.15, 0.0, cands)
    best = np.take_along_axis(
        cands, rng.integers(0, bands, (B, 1, T)), axis=1)[:, 0]
    # unvoiced runs; a zero within +-3 frames kills a frame (FixStep2)
    for b in range(B):
        for start in rng.integers(10, T - 20, 3):
            best[b, start:start + rng.integers(3, 12)] = 0.0
    return best.astype(np.float32), cands.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k4_plain_matches_jax(seed):
    """Identical V/UV decisions and values within rel 1e-6."""
    best, cands = _contour_inputs(3, 7, 160, seed)
    want = np.asarray(jax.vmap(lambda b, c: jdio.fix_f0_contour(
        b, c, 5.0, 71.0, 0.1))(jnp.asarray(best), jnp.asarray(cands)))
    got = dio.fix_f0_contour(torch.as_tensor(best), torch.as_tensor(cands),
                             5.0, 71.0, 0.1).numpy()
    assert np.array_equal(got > 0, want > 0)
    assert (want > 0).mean() > 0.15
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# K1: windowed frames, through the power spectrum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", [16000, 48000])
@pytest.mark.parametrize("window,ratio,mode", [
    ("hanning", 4.0, frames.MEAN), ("blackman", 3.0, frames.MEAN),
    ("blackman", 4.0, frames.CENTROID)])
def test_k1_plain_matches_jax_slab(fs, window, ratio, mode):
    """Compact windows vs the JAX slab windows (d4c._slab_frames +
    _slab_window): equal power spectra (and centroid cross-products),
    rtol 1e-4 on bins within 60 dB of each row's peak.  Both DFTs are
    taken in f64 so the comparison sees the windows only."""
    T, step = 12, fs // 200
    L = T * step
    rng = np.random.default_rng(3)
    x = (np.sin(2 * np.pi * 210.0 * np.arange(L) / fs)
         + 0.1 * rng.standard_normal(L)).astype(np.float32)
    f0 = rng.uniform(75.0, 400.0, T).astype(np.float32)
    s = rng.integers(-2, 3, T)
    h_cap = int(ratio * fs / 71.0 / 2.0 + 1.0)
    pad = h_cap + 4
    width = -(-(2 * h_cap + 1 + 8) // 128) * 128
    N = 2 * width
    slab = jd4c._slab_frames(jnp.asarray(x), T, step, pad, width,
                             jnp.float32)
    jw, jramp = jax.vmap(lambda r, f, si: jd4c._slab_window(
        r, fs, f, si, window, ratio, pad, width, jnp.float32, h_cap))(
        slab, jnp.asarray(f0), jnp.asarray(s))
    jw = np.asarray(jw, np.float64)
    h = prims.matlab_round_i(prims.exact_div(
        prims.rdiv(ratio * fs, torch.as_tensor(f0)), 2.0)).clamp(max=h_cap)
    origin = torch.arange(T) * step + torch.as_tensor(s)
    if (window, mode) == ("blackman", frames.MEAN):
        mode = frames.MEAN_BLACKMAN         # the port's mode fixes the window
    w1, w2 = frames.frame_windows(torch.as_tensor(x)[None], origin, h,
                                  torch.as_tensor(f0), fs, ratio, width,
                                  mode)
    if mode == frames.CENTROID:
        jw = jw / np.sqrt((jw ** 2).sum(axis=1, keepdims=True))
        js1 = np.fft.rfft(jw, N)
        js2 = np.fft.rfft(jw * np.asarray(jramp, np.float64), N)
        want = js2.real * js1.real + js1.imag * js2.imag
        s1 = np.fft.rfft(w1.double().numpy(), N)
        s2 = np.fft.rfft(w2.double().numpy(), N)
        got = s2.real * s1.real + s1.imag * s2.imag
    else:
        want = np.abs(np.fft.rfft(jw, N)) ** 2
        got = np.abs(np.fft.rfft(w1.double().numpy(), N)) ** 2
    peak = np.abs(want).max(axis=1, keepdims=True)
    live = np.abs(want) > 1e-6 * peak
    assert live.mean() > 0.2
    # rtol 1e-4 plus 1e-7 of the row's peak: XLA's and PyTorch's f32
    # cosines differ by an ulp on some window samples, which moves a bin
    # near -60 dB by ~1e-7 of the peak (one bin in ~10^4)
    err = np.abs(got - want)
    assert (err[live] <= (1e-4 * np.abs(want) + 1e-7 * peak)[live]).all()
