"""The port's DFTs (`ops/fftmat.py`: K39 `r2c`, K40 `c2r` on the card,
the table products on the CPU) against the JAX package and numpy.

On the CPU each of the six public functions is its table twin, bit for
bit; these tests hold the twins to the JAX package's table products on
the same numpy inputs, pin the identities the card's two kernels rest on
(every table product is a forward or an inverse real DFT), and drive the
minimum-phase composition the card runs (a half c2r, then a folded r2c)
on torch.fft.  `tests/test_torch_cuda.py` holds K39/K40 to the twins and
to a float64 DFT on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu.ops import fftmat as jfm
from hts_train_world_tpu_torch.ops import fftmat

SIZES = (256, 1024, 4096)


def _rows(N, L, dtype, seed, R=5):
    x = np.random.default_rng(seed).standard_normal((R, L))
    return x.astype(dtype)


def _half(N, dtype, seed, R=5):
    return _rows(N, N // 2 + 1, dtype, seed, R)


def _w(N):
    w = np.full(N // 2 + 1, 2.0)
    w[0] = w[-1] = 1.0
    return w


def _scale(kind, inp):
    """Each row's scale for an error: the input row's 2-norm for a
    forward DFT (the RMS of its bins), its square for a power, and for an
    inverse the RMS of the output row, sqrt(sum_k w_k |X_k|^2)."""
    inp = [np.asarray(t, np.float64) for t in inp]
    if kind == "forward":
        return np.sqrt((inp[0] ** 2).sum(-1))
    if kind == "power":
        return (inp[0] ** 2).sum(-1)
    N = 2 * (inp[0].shape[-1] - 1)
    return np.sqrt((_w(N) * sum(t ** 2 for t in inp)).sum(-1))


def _worst(got, want, scale):
    """The worst row's max |got - want| over its scale."""
    err = np.max([np.abs(np.asarray(g, np.float64)
                         - np.asarray(w, np.float64)).max(-1)
                  for g, w in zip(got, want)], axis=0)
    return float((err / scale).max())


def _port_cases(N, dtype, seed):
    """(name, port function, its table twin, the JAX counterpart, the
    numpy inputs, scale kind) for each of the six functions."""
    L = N - N // 3                           # L < N: the zero padding
    x = _rows(N, L, dtype, seed)
    re, im = _half(N, dtype, seed + 1), _half(N, dtype, seed + 2)
    lh = _half(N, dtype, seed + 3)
    jt = jnp.float64 if dtype == np.float64 else jnp.float32
    return [
        ("rfft", lambda t: fftmat.rfft(t, N),
         lambda t: fftmat.rfft_matmul(t, N),
         lambda a: jfm.rfft_matmul(jnp.asarray(a), N), (x,), "forward"),
        ("rfft_power", lambda t: fftmat.rfft_power(t, N),
         lambda t: fftmat.rfft_power_matmul(t, N),
         lambda a: jfm.rfft_power_matmul(jnp.asarray(a), N), (x,), "power"),
        ("irfft_scaled", lambda a, b: fftmat.irfft_scaled(a, b, N),
         lambda a, b: fftmat.irfft_scaled_matmul(a, b, N),
         lambda a, b: jfm.irfft_scaled_matmul(jnp.asarray(a),
                                              jnp.asarray(b), N),
         (re, im), "inverse"),
        ("minphase_log", lambda t: fftmat.minphase_log(t, N),
         lambda t: fftmat.minphase_log_matmul(t, N),
         lambda a: tuple(jfm.mm(jnp.asarray(a), m)
                         for m in jfm.minphase_mats(N, jt)),
         (lh,), "inverse"),
        ("sym_rfft_real", lambda t: fftmat.sym_rfft_real(t, N),
         lambda t: fftmat.sym_rfft_real_matmul(t, N),
         lambda a: jfm.mm(jnp.asarray(a), jfm.sym_rfft_real_mat(N, jt)),
         (lh,), "inverse"),
        ("irfft_half", lambda t: fftmat.irfft_half(t, N),
         lambda t: fftmat.irfft_half_matmul(t, N),
         lambda a: jfm.mm(jnp.asarray(a), jfm.irfft_half_mats(N, jt)[0]),
         (lh,), "inverse"),
    ]


NAMES = ("rfft", "rfft_power", "irfft_scaled", "minphase_log",
         "sym_rfft_real", "irfft_half")


def _tuple(v):
    return v if isinstance(v, tuple) else (v,)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_cpu_function_is_its_table_twin_bit_for_bit(name, N):
    """On a CPU tensor each public function is the table product it
    replaces on the card: every CPU result of the port is unchanged."""
    case = next(c for c in _port_cases(N, np.float32, 18) if c[0] == name)
    _, fn, twin, _, inp, _ = case
    ts = [torch.as_tensor(a) for a in inp]
    before = dict(fftmat.table_calls)
    for g, w in zip(_tuple(fn(*ts)), _tuple(twin(*ts))):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)
    assert dict(fftmat.table_calls) == before     # CPU tensors: not counted


# float32: XLA's and torch's CPU matmuls sum the L or N/2+1 products in
# other orders; within 5e-5 of the row's scale, about four times the
# largest read (1.1e-5, the power at 4096; the others up to 2.3e-6).
# float64: 1e-12 (read: up to 1.2e-14).
@pytest.mark.parametrize("dtype,tol", [(np.float32, 5e-5),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_function_matches_the_jax_package(name, N, dtype, tol):
    case = next(c for c in _port_cases(N, dtype, 7) if c[0] == name)
    _, fn, _, jfn, inp, kind = case
    got = _tuple(fn(*[torch.as_tensor(a) for a in inp]))
    want = _tuple(jfn(*inp))
    assert all(g.shape == w.shape for g, w in zip(got, want))
    assert _worst([g.numpy() for g in got], [np.asarray(w) for w in want],
                  _scale(kind, inp)) <= tol


@pytest.mark.parametrize("N", SIZES)
def test_identities_the_kernels_rest_on(N):
    """In float64 numpy at 1e-12: the CheapTrick tables are the first
    N/2+1 samples of irfft(x) * N, and the minimum-phase table is rfft
    of that half cepstrum folded by w_k / N."""
    x = _half(N, np.float64, 3)
    half = np.fft.irfft(x + 0j, N)[:, :N // 2 + 1] * N
    scale = _scale("inverse", (x,))[:, None]
    sym = x @ fftmat._sym_rfft_real_mat_np(N)
    A, _ = fftmat._irfft_half_mats_np(N)
    assert (np.abs(sym - half) / scale).max() <= 1e-12
    assert (np.abs(x @ A - half) / scale).max() <= 1e-12
    R, I = fftmat._minphase_mats_np(N)
    folded = np.fft.rfft(half * _w(N) / N, N)
    assert (np.abs(x @ R - folded.real) / scale).max() <= 1e-12
    assert (np.abs(x @ I - folded.imag) / scale).max() <= 1e-12


@pytest.mark.parametrize("N", SIZES)
def test_minphase_composition_on_torch_fft(N):
    """The card's route for `minphase_log` (a half c2r, then r2c of the
    folded cepstrum), driven by float64 torch.fft primitives, equals the
    table product within 1e-12 of each row's scale."""
    lh = torch.as_tensor(_half(N, np.float64, 5))

    def c2r_half(x, n):
        return torch.fft.irfft(torch.complex(x, torch.zeros_like(x)),
                               n)[..., :n // 2 + 1] * n

    def r2c_fold(c, n):
        s = torch.fft.rfft(c * fftmat.fold_weights(n, c.dtype, c.device), n)
        return s.real, s.imag

    got = fftmat.minphase_log_composed(lh, N, c2r_half, r2c_fold)
    want = fftmat.minphase_log_matmul(lh, N)
    assert _worst([g.numpy() for g in got], [w.numpy() for w in want],
                  _scale("inverse", (lh.numpy(),))) <= 1e-12


# the tables' angles 2 pi n k / N reach ~pi N / 2 rad, so a float64 entry
# is off by up to ~pi N eps / 2 (4.5e-13 at N = 2048; the power twice it)
TWIN_F64 = 1e-11


@pytest.mark.parametrize("N", (64, 256, 2048))
def test_kernel_twins_are_real_dfts(N):
    """K39's and K40's plain twins (what the card's launches are held to)
    in every mode and output length, in float64 against numpy's FFT within
    TWIN_F64 of each row's scale; rows of 1, L < N and N samples, rows of
    zeros and of an impulse."""
    rng = np.random.default_rng(N)
    for L in (1, N // 3, N):
        x = rng.standard_normal((4, L))
        x[1] = 0.0
        x[2] = 0.0
        x[2, L // 2] = 1.0
        t = torch.as_tensor(x)
        ref = np.fft.rfft(x, N)
        s = np.maximum(_scale("forward", (x,)), 1e-300)
        re, im = fftmat.r2c_plain(t, N, fftmat.REIM)
        assert _worst([re.numpy(), im.numpy()], [ref.real, ref.imag],
                      s) <= TWIN_F64
        p = fftmat.r2c_plain(t, N, fftmat.POWER)
        assert _worst([p.numpy()], [np.abs(ref) ** 2],
                      np.maximum(s * s, 1e-300)) <= TWIN_F64
    c = rng.standard_normal((3, N // 2 + 1))
    fold = np.fft.rfft(c * _w(N) / N, N)
    re, im = fftmat.r2c_plain(torch.as_tensor(c), N, fftmat.FOLD)
    assert _worst([re.numpy(), im.numpy()], [fold.real, fold.imag],
                  _scale("forward", (c * _w(N) / N,))) <= TWIN_F64
    X = rng.standard_normal((3, N // 2 + 1)) \
        + 1j * rng.standard_normal((3, N // 2 + 1))
    X[:, 0] = X[:, 0].real                   # Im X_0, Im X_N/2: 0 in K40
    X[:, -1] = X[:, -1].real
    y = np.fft.irfft(X, N) * N
    s = _scale("inverse", (X.real, X.imag))
    for n_out in (N, N // 2 + 1):
        got = fftmat.c2r_plain(torch.as_tensor(X.real),
                               torch.as_tensor(X.imag), N, n_out)
        assert _worst([got.numpy()], [y[:, :n_out]], s) <= TWIN_F64
        got = fftmat.c2r_plain(torch.as_tensor(X.real), None, N, n_out)
        yr = np.fft.irfft(X.real + 0j, N)[:, :n_out] * N
        assert _worst([got.numpy()], [yr],
                      _scale("inverse", (X.real,))) <= TWIN_F64


@pytest.mark.parametrize("N", (64, 8192))
def test_twiddle_table(N):
    """K40's table is K39's dense table at N (`fftmat.r2c_table_np(N,
    False)`): its split entries W_N^k = (cos, -sin)(2 pi k / N), k <=
    N/4, in float64 (both kernels transform in float64), within 2 ulps of
    1 of the exact values, and W_N^(N/4) exactly -i, where the inverse
    split's W_N^-k turns from conj W_N^k to -W_N^(N/2-k)."""
    t = fftmat._r2c_table(N, False, torch.device("cpu")).numpy()
    ang = 2.0 * np.pi * np.arange(N // 4 + 1) / N
    assert t.shape[1] == 2 and t.dtype == np.float64
    assert np.abs(t[:N // 4 + 1] - np.stack([np.cos(ang), -np.sin(ang)], 1)
                  ).max() <= 4.5e-16
    assert np.abs(t[N // 4, 0]) <= 1e-15 and t[N // 4, 1] == -1.0
