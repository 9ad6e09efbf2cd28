"""K39's and K40's pass plans and the tables their launchers build on the
host, on the CPU: float64 numpy emulations of the kernels' passes with
those tables (`r2c_emulate` against `np.fft.rfft`; `c2r_emulate`, the
inverse split, the forward passes on its conjugate and the stores from
the last pass's registers, against `np.fft.irfft * N`), the tables'
values and layout, and the shared-memory indices of every exchange.

The kernels (`csrc/fft_r2c.cu`, `csrc/fft_c2r.cu` on
`csrc/fft_r2c_core.cuh`) run only on the card; `tests/test_torch_cuda.py`
holds them to a float64 DFT there.
"""
import numpy as np
import pytest
import torch

from hts_train_world_tpu_torch.ops import fftmat

# (N, L): a copy-synthesis batch's launches (StoneMask, CheapTrick, D4C's
# LoveTrain, centroid and MEAN, the bands, synthesis' noise and fold)
LAUNCHES = ((4096, 2048), (2048, 2048), (4096, 3712), (4096, 2816),
            (4096, 513), (2048, 1025))
SIZES = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
CASES = sorted(set(LAUNCHES) | {(N, L) for N in SIZES
                                for L in (1, N // 2, N // 2 + 1, N,
                                          N // 4, N // 4 + 1, N // 4 + 2)})


def _passes(d, plan, w, M: int):
    """The kernels' passes on d (rows, M): per pass of radix R, butterfly
    j takes d[j + r M/R], turns input r by the pass's table entry at
    [(r-1) Ns + j mod Ns], runs the R-point DFT (a plain DFT here) and
    writes output r to [(j - j mod Ns) R + j mod Ns + r Ns]."""
    off = M // 2 + 1
    for R, ns in plan:
        j = np.arange(M // R)
        k = j & (ns - 1)
        v = d[:, j[None, :] + (np.arange(R) * (M // R))[:, None]]
        if ns > 1:
            v[:, 1:] *= w[off + (np.arange(1, R)[:, None] - 1) * ns + k]
            off += (R - 1) * ns
        out = np.einsum("sr,brj->bsj", fftmat._w(np.outer(np.arange(R),
                                                   np.arange(R)), R), v)
        d = np.empty_like(d)
        d[:, ((j - k) * R + k)[None, :] + (np.arange(R) * ns)[:, None]] = out
    return d


def r2c_emulate(x, N: int, mode: int = fftmat.REIM):
    """K39's pass plan in float64 numpy, with its tables, on rows x (R,
    L): the loads and the pruned (or folded) first pass, each pass's
    table twiddles, R-point DFTs and Stockham writes, and the split that
    reads each pair (k, M-k) once.  Returns (Re, Im) (R, N/2+1), or the
    power.  The codelets' arithmetic is a plain DFT here."""
    x = np.asarray(x, np.float64)
    rows, L = x.shape
    M = N // 2
    sparse, plan = fftmat.r2c_plan(N, L)
    tab = fftmat.r2c_table_np(N, sparse)
    w = tab[:, 0] + 1j * tab[:, 1]
    Lz = (L + 1) // 2
    xp = np.zeros((rows, 2 * Lz))
    xp[:, :L] = x
    if mode == fftmat.FOLD:
        n = np.arange(2 * Lz)
        xp = xp * np.where((n == 0) | (n == M), 1.0 / N, 2.0 / N)
    z = np.zeros((rows, M), complex)
    z[:, :Lz] = xp[:, 0::2] + 1j * xp[:, 1::2]
    if sparse:
        i = np.arange(M)
        j1 = i >> 3
        live = j1 + M // 8 < Lz
        d = z[:, j1] + np.where(live, z[:, np.minimum(j1 + M // 8, M - 1)]
                                * fftmat._w(i & 7, 8), 0.0)
    else:
        d = z
    d = _passes(d, plan, w, M)
    k = np.arange(M // 2 + 1)
    A, B = d[:, k], d[:, (M - k) & (M - 1)]
    E = ((A.real + B.real) * 0.5) + 1j * ((A.imag - B.imag) * 0.5)
    O = ((A.imag + B.imag) * 0.5) - 1j * ((A.real - B.real) * 0.5)
    p = O * w[k]
    X = np.empty((rows, M + 1), complex)
    X[:, k] = E + p
    X[:, M - k] = np.conj(E - p)
    if mode == fftmat.POWER:
        return X.real ** 2 + X.imag ** 2
    return X.real, X.imag


def c2r_emulate(re, im, N: int, n_out: int):
    """K40 in float64 numpy on half spectra (rows, N/2+1), Im None for
    zero: thread t's loads of X_k and X_(M-k) for k = t + i M/16, the
    inverse split with W_N^-k from the dense table's split entries (-W_N^
    (M-k) past M/2), the dense plan's passes on its conjugate, and the
    stores from the last pass's registers, butterfly j = t + b T's output
    r as the samples 2m, 2m+1 (m = j + r M/R) below n_out."""
    re = np.asarray(re, np.float64)
    rows = re.shape[0]
    M = N // 2
    T = M // 16
    im = np.zeros_like(re) if im is None else np.asarray(im, np.float64)
    w = fftmat.r2c_table_np(N, False)
    w = w[:, 0] + 1j * w[:, 1]
    k = (np.arange(T)[:, None] + np.arange(16)[None, :] * T).reshape(-1)
    assert np.array_equal(np.sort(k), np.arange(M))
    a = re[:, k] + 1j * np.where(k > 0, im[:, k], 0.0)
    b = re[:, M - k] - 1j * np.where(k > 0, im[:, M - k], 0.0)
    wk = np.where(k <= M // 2, np.conj(w[np.minimum(k, M - k)]),
                  -w[np.minimum(k, M - k)])
    z = np.empty((rows, M), complex)
    z[:, k] = (a + b) + 1j * (wk * (a - b))
    plan = fftmat.c2r_plan(N)
    d = _passes(np.conj(z), plan, w, M)
    RL = plan[-1][0]
    t, bb, r = np.meshgrid(np.arange(T), np.arange(16 // RL), np.arange(RL),
                           indexing="ij")
    m = (t + bb * T + r * (M // RL)).reshape(-1)
    assert np.array_equal(np.sort(m), np.arange(M))
    y = np.full((rows, N), np.nan)
    y[:, 2 * m] = d[:, m].real
    y[:, 2 * m + 1] = -d[:, m].imag
    return y[:, :n_out]


def _err(got, ref, x):
    """The worst |got - ref| over each row's 2-norm."""
    nrm = np.sqrt((x * x).sum(1, keepdims=True)).clip(1e-300)
    return max(float((np.abs(g - r) / nrm).max()) for g, r in zip(got, ref))


@pytest.mark.parametrize("N", SIZES)
def test_emulated_passes_match_numpy_rfft(N):
    """At every (N, L) of the batch's launches and the edges L = 1, N/2,
    N/2+1, N (and around the sparse plan's N/8 limit on z), all three
    modes, rows with zeros and an impulse: within 1e-12 of each row's norm
    (the power: of its square)."""
    rng = np.random.default_rng(N)
    for n, L in CASES:
        if n != N:
            continue
        x = rng.standard_normal((3, L))
        x[1] = 0.0
        x[2] = 0.0
        x[2, (3 * L) // 4] = 1.0
        ref = np.fft.rfft(x, N)
        re, im = r2c_emulate(x, N, fftmat.REIM)
        assert re.shape == (3, N // 2 + 1)
        assert _err((re, im), (ref.real, ref.imag), x) <= 1e-12
        p = r2c_emulate(x, N, fftmat.POWER)
        assert _err((p,), (np.abs(ref) ** 2,), x * x) <= 1e-12 * \
            max(1.0, float((x * x).sum(1).max()))
        if L <= N // 2 + 1:
            w = fftmat.fold_weights(N, torch.float64, "cpu").numpy()[:L]
            ref = np.fft.rfft(x * w, N)
            got = r2c_emulate(x, N, fftmat.FOLD)
            assert _err(got, (ref.real, ref.imag), x * w) <= 1e-12


@pytest.mark.parametrize("N", SIZES)
def test_emulated_inverse_matches_numpy_irfft(N):
    """K40's schedule at every size, n_out N and N/2+1, with and without
    Im (Im X_0 and Im X_N/2 dropped, as the kernel drops them), on rows
    with zeros and an impulse spectrum: within 1e-12 of each row's scale
    (its weighted 2-norm) against irfft(X) * N."""
    rng = np.random.default_rng(N + 1)
    H = N // 2 + 1
    re = rng.standard_normal((3, H))
    im = rng.standard_normal((3, H))
    re[1] = im[1] = 0.0
    re[2], im[2] = 1.0, 0.0
    wts = np.where((np.arange(H) == 0) | (np.arange(H) == H - 1), 1.0, 2.0)
    for imag in (im, None):
        i0 = np.zeros_like(re) if imag is None else imag.copy()
        i0[:, 0] = i0[:, -1] = 0.0
        ref = np.fft.irfft(re + 1j * i0, N) * N
        scale = np.sqrt((wts * (re ** 2 + i0 ** 2)).sum(1, keepdims=True)
                        * N).clip(1e-300)
        for n_out in (N, H):
            got = c2r_emulate(re, imag, N, n_out)
            assert got.shape == (3, n_out)
            assert (np.abs(got - ref[:, :n_out]) / scale).max() <= 1e-12


def test_plan():
    """Each plan's radices multiply to N/2 (N/16 after the sparse plan's
    folded radix 8), Ns runs through their products, the sparse plan is
    taken exactly where z is zero past N/8 at the sizes where it saves a
    pass, and a copy-synthesis batch's launches get the plans the kernel
    was designed for."""
    for N in SIZES:
        M = N // 2
        for L in range(1, N + 1, max(1, N // 64)):
            sparse, plan = fftmat.r2c_plan(N, L)
            assert sparse == ((L + 1) // 2 <= M // 4
                              and M in fftmat.R2C_SPARSE_M)
            ns = 8 if sparse else 1
            for R, n in plan:
                assert n == ns and R in (2, 4, 8, 16)
                ns *= R
            assert ns == M
            assert all(R == 16 for R, _ in plan[:-1])
    assert fftmat.r2c_plan(4096, 2048) == (False, [(16, 1), (16, 16),
                                                   (8, 256)])
    assert fftmat.r2c_plan(4096, 513) == (True, [(16, 8), (16, 128)])
    assert fftmat.r2c_plan(2048, 1025) == (False, [(16, 1), (16, 16),
                                                   (4, 256)])
    # K40: the dense plan at every size, at CheapTrick's N 2048 too
    for N in SIZES:
        assert fftmat.c2r_plan(N) == fftmat.r2c_plan(N, N)[1]
    assert fftmat.c2r_plan(2048) == [(16, 1), (16, 16), (4, 256)]


@pytest.mark.parametrize("N,sparse", [(64, False), (256, True),
                                      (4096, False), (4096, True),
                                      (8192, False)])
def test_table_values_and_layout(N, sparse):
    """W_N^k for the split (k <= N/4), then per pass with Ns > 1 the
    values W_{R Ns}^(r k) at [(r-1) Ns + k], within 2 ulps of 1 of the
    exact values; nothing past the last pass's table."""
    t = fftmat.r2c_table_np(N, sparse)
    w = t[:, 0] + 1j * t[:, 1]
    M = N // 2
    k = np.arange(M // 2 + 1)
    assert np.abs(w[:M // 2 + 1] - np.exp(-2j * np.pi * k / N)).max() \
        <= 4.5e-16
    off = M // 2 + 1
    for R, ns in fftmat.r2c_plan(N, 1 if sparse else N)[1]:
        if ns == 1:
            continue
        r, kk = np.meshgrid(np.arange(1, R), np.arange(ns), indexing="ij")
        got = w[off + (r - 1) * ns + kk]
        exact = np.exp(-2j * np.pi * ((r * kk) % (R * ns)) / (R * ns))
        assert np.abs(got - exact).max() <= 4.5e-16
        off += (R - 1) * ns
    assert len(w) == off


def _banks(idx):
    """The largest number of a half-warp's 8-byte words that share a bank
    (16 banks of 8 bytes a 128-byte wavefront)."""
    return max(int(np.bincount(np.asarray(h) % 16).max()) for h in idx)


def _last_j(t, b, M, R, T):
    """The last pass's butterfly of slot b of thread t where the kernel
    splits in registers (`last_j` in csrc/fft_r2c_core.cuh): j < Ns/2 and
    its partner Ns - j (0 with Ns/2), in one thread, or in lanes l and
    l + 16."""
    ns = M // R
    if 16 // R >= 2:
        j, first = t + (b >> 1) * T, (b & 1) == 0
    else:
        j, first = 16 * (t >> 5) + (t & 15), (t & 16) == 0
    return np.where(first, j, np.where(j == 0, ns // 2, ns - j))


@pytest.mark.parametrize("N,L", [(8192, 8192), (4096, 2048), (4096, 513),
                                 (2048, 2048), (2048, 1025), (1024, 1024),
                                 (512, 512)])
def test_exchanges_are_conflict_free(N, L):
    """Every pass's writes and the next pass's reads, as the kernel forms
    their padded indices (i + i/16), fall in 16 distinct banks for each
    half-warp of a row's threads; the last pass's reads in the kernel's
    pairing (each pair of butterflies whose outputs the split joins, held
    by one thread or two lanes) at most two to a bank; where a plan keeps
    the split in shared memory (M/16 < 32 threads a row, one butterfly
    each), its reads of Z_k too, and of Z_(M-k) at most two."""
    _check_exchanges(N, fftmat.r2c_plan(N, L)[1])


@pytest.mark.parametrize("N", (8192, 4096, 2048, 1024, 512))
def test_inverse_exchanges_are_conflict_free(N):
    """K40's exchanges, its dense plan with no pairing: every pass's
    writes but the last's (whose outputs it stores from registers) and
    every next pass's reads in 16 distinct banks a half-warp."""
    _check_exchanges(N, fftmat.c2r_plan(N), inverse=True)


def _check_exchanges(N, plan, inverse=False):
    M = N // 2
    T = M // 16
    pad = lambda i: i + (i >> 4)
    R_last = plan[-1][0]
    paired = not inverse and len(plan) >= 2 and (16 // R_last >= 2
                                                 or T >= 32)
    halves = [np.arange(h, h + 16) for h in range(0, T, 16)]
    for p, (R, ns) in enumerate(plan):
        if p + 1 == len(plan) and (paired or inverse):
            break
        for b in range(16 // R):
            for r in range(R):
                write = []
                for t in halves:
                    j = t + b * T
                    k = j & (ns - 1)
                    write.append(pad((j - k) * R + k + r * ns))
                assert _banks(write) == 1
        if p + 1 < len(plan):
            R2 = plan[p + 1][0]
            last = p + 2 == len(plan) and paired
            for b in range(16 // R2):
                for r in range(R2):
                    js = [(_last_j(t, b, M, R2, T) if last else t + b * T)
                          for t in halves]
                    assert _banks([pad(j + r * (M // R2))
                                   for j in js]) <= (2 if last else 1)
    if not paired and not inverse:
        for i in range(8):
            k = [t + i * T for t in halves]
            assert _banks([pad(kk) for kk in k]) == 1
            assert _banks([pad((M - kk) & (M - 1)) for kk in k]) <= 2
