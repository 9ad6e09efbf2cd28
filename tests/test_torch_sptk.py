"""The port's SPTK engine (ops/excitation.py, ops/sptk.py, the LSP half of
ops/postfilter.py, features/filters.py, `pgen.generate_waveform(engine=
"sptk")`) against the JAX package, on the CPU, in float64: 16 kHz, shift
80, N 1024, T 61, order 24.  Both sides get the same numpy inputs and
the same noise.

The kernels' arithmetic (K35's scan levels, K37's gather and overlap-add
and its direct DFT, K38's folded tables and LU) is written out in numpy
and held to the twins, since the kernels run only on the card
(tests/test_torch_cuda.py holds them to the twins there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu.features import filters as jfilters
from hts_train_world_tpu.models import pgen as jpgen
from hts_train_world_tpu.ops import excitation as jex
from hts_train_world_tpu.ops import postfilter as jpf
from hts_train_world_tpu.ops import sptk as jsptk
from hts_train_world_tpu_torch import vocoder
from hts_train_world_tpu_torch.features import filters
from hts_train_world_tpu_torch.models import pgen
from hts_train_world_tpu_torch.ops import excitation as ex
from hts_train_world_tpu_torch.ops import postfilter as pf
from hts_train_world_tpu_torch.ops import prims, sptk

FS, SHIFT, N, T, ORDER, ALPHA = 16000, 80, 1024, 61, 24, 0.42


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _contour(seed=0):
    """lf0 (T,) at 220 Hz with a 6 Hz vibrato of half a semitone and two
    unvoiced gaps (MAGIC)."""
    t = np.arange(T) * SHIFT / FS
    lf0 = np.log(220.0 * 2.0 ** (0.5 / 12.0 * np.sin(2 * np.pi * 6.0 * t)))
    lf0[10:18] = jex.MAGIC
    lf0[41:44] = jex.MAGIC
    return lf0


def _noise(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", [8000, 16000, 22050, 32000, 44100, 48000])
def test_band_split_filters_bit_equal(fs):
    for a, b in zip(filters.band_split_filters(fs),
                    jfilters.band_split_filters(fs)):
        assert a.shape == (31,) and np.array_equal(a, b)


@pytest.mark.parametrize("m1,m2,a", [(512, 48, ALPHA), (40, 9, -0.3),
                                     (0, 4, 0.55)])
def test_frqtr_matrix_bit_equal(m1, m2, a):
    got = sptk.frqtr_matrix(m1, m2, a)
    assert got.shape == (m1 + 1, m2 + 1)
    assert np.array_equal(got, jsptk.frqtr_matrix(m1, m2, a))


def test_xla_exp_is_jax_exp_bit_for_bit():
    """The port's lf0 -> pitch takes XLA's exp: torch.exp rounds otherwise
    in about one case in six, and a period one ulp off moves pulses."""
    rng = np.random.default_rng(4)
    x = np.concatenate([np.log(rng.uniform(50.0, 1000.0, 20000)),
                        rng.uniform(-700.0, 705.0, 20000),
                        [0.0, -0.0, 709.78, 710.0, -708.39, -745.0, -800.0,
                         np.inf, -np.inf, np.log(200.0)]])
    got = prims.xla_exp(_t(x)).numpy()
    assert np.array_equal(got, np.asarray(jnp.exp(x)))


# ---------------------------------------------------------------------------
# excitation (K35, K36)
# ---------------------------------------------------------------------------


def test_lf0_to_pitch_and_per_sample_pitch_equal():
    lf0 = np.concatenate([_contour(), [np.log(200.0), np.log(160.0)]])
    pj = np.asarray(jex.lf0_to_pitch(lf0, FS))
    pt = ex.lf0_to_pitch(_t(lf0), FS).numpy()
    assert np.array_equal(pt, pj)
    np.testing.assert_array_equal(
        ex._per_sample_pitch(_t(pj), SHIFT).numpy(),
        np.asarray(jex._per_sample_pitch(pj, SHIFT)))


@pytest.mark.parametrize("period", [80.0, 100.0, 120.0, "contour"])
def test_excite_matches_jax(period):
    """Pulse positions equal (at constant periods every wrap is a rounding
    tie), values within 1e-12, the injected noise where unvoiced."""
    if period == "contour":
        pitch = np.asarray(jex.lf0_to_pitch(_contour(), FS))
    else:
        pitch = np.full(T, period)
        pitch[20:26] = 0.0
    n = (T - 1) * SHIFT
    noise = _noise(n, 1)
    ej, vj = jex.excite(pitch, SHIFT, noise=noise)
    et, vt = ex.excite(_t(pitch), SHIFT, noise=_t(noise))
    ej, vj, et, vt = np.asarray(ej), np.asarray(vj), et.numpy(), vt.numpy()
    np.testing.assert_array_equal(vt, vj)
    pos_j = np.nonzero(vj & (ej != 0))[0]
    np.testing.assert_array_equal(np.nonzero(vt & (et != 0))[0], pos_j)
    assert len(pos_j) >= 30
    assert np.abs(et - ej).max() <= 1e-12 * np.abs(ej).max()
    np.testing.assert_array_equal(et[~vt], noise[~vt])


@pytest.mark.parametrize("period", [120.0, 240.0])
def test_excite_ties_at_48k(period):
    """48 kHz, shift 240 (the engine's full width; 21 frames, the 16 kHz
    tests' 4800 samples): pulse trains equal at periods that divide the
    frame."""
    T48, shift = 21, 240
    pitch = np.full(T48, period)
    noise = _noise((T48 - 1) * shift, 2)
    ej, _ = jex.excite(pitch, shift, noise=noise)
    et, _ = ex.excite(_t(pitch), shift, noise=_t(noise))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


@pytest.mark.parametrize("fs,shift", [(16000, 80), (48000, 240)])
def test_excite_from_lf0_matches_jax(fs, shift):
    """`excite(lf0, sr=fs)` (K35 with lf0 -> period in the same launch) is
    JAX's excite of JAX's lf0_to_pitch: voicing and pulse positions
    equal, values within 1e-12, the noise where unvoiced."""
    lf0 = _contour()
    n = (T - 1) * shift
    noise = _noise(n, 12)
    ej, vj = jex.excite(jex.lf0_to_pitch(lf0, fs), shift, noise=noise)
    et, vt = ex.excite(_t(lf0), shift, noise=_t(noise), sr=fs)
    ej, vj, et, vt = np.asarray(ej), np.asarray(vj), et.numpy(), vt.numpy()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(np.nonzero(vt & (et != 0))[0],
                                  np.nonzero(vj & (ej != 0))[0])
    assert np.abs(et - ej).max() <= 1e-12 * np.abs(ej).max()
    np.testing.assert_array_equal(et[~vt], noise[~vt])
    same = ex.excite(ex.lf0_to_pitch(_t(lf0), fs), shift, noise=_t(noise))
    assert torch.equal(same[0], torch.from_numpy(et))


def test_excite_at_pitch_zero_is_its_noise():
    """JAX's second EXCITE run (pitch 0 everywhere) returns its noise, so
    the port passes the noise through without it."""
    n = (T - 1) * SHIFT
    noise = _noise(n, 3)
    ej, vj = jex.excite(np.zeros(T), SHIFT, noise=noise)
    assert not np.asarray(vj).any()
    np.testing.assert_array_equal(np.asarray(ej), noise)
    et, _ = ex.excite(torch.zeros(T, dtype=torch.float64), SHIFT,
                      noise=_t(noise))
    np.testing.assert_array_equal(et.numpy(), noise)


def test_fir_and_mixed_excitation_match_jax():
    low, high = filters.band_split_filters(FS)
    n = (T - 1) * SHIFT
    x = _noise(n, 4)
    assert _rel(ex.fir(_t(x), low), jex.fir(x, low)) <= 1e-12
    assert _rel(ex.fir(_t(x[:20]), high), jex.fir(x[:20], high)) <= 1e-12
    pitch = np.asarray(jex.lf0_to_pitch(_contour(), FS))
    noise = (_noise(n, 5), _noise(n, 6))
    mj, vj = jex.mixed_excitation(pitch, SHIFT, low, high, noise=noise)
    mt, vt = ex.mixed_excitation(_t(pitch), SHIFT, low, high,
                                 noise=tuple(_t(a) for a in noise))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert _rel(mt, mj) <= 1e-12


def test_excitation_draws_from_the_generator():
    """Without noise the draws come from the generator: the same seed, the
    same excitation; another seed, another."""
    pitch = ex.lf0_to_pitch(_t(_contour()), FS)
    low, high = filters.band_split_filters(FS)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return ex.mixed_excitation(pitch, SHIFT, low, high, generator=g)[0]
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


# ---------------------------------------------------------------------------
# the MGLSA filter (K37)
# ---------------------------------------------------------------------------


def _mgc(seed=7, M=ORDER + 1):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((T, M)) * 0.1 / (1.0 + np.arange(M))
    c[:, 0] += 0.8
    return c


@pytest.mark.parametrize("fft_size", [1024, 1000])
def test_mglsa_synthesis_matches_jax(fft_size):
    exc = _noise((T - 1) * SHIFT, 8)
    mgc = _mgc()
    yj = jex.mglsa_synthesis(exc, mgc, ALPHA, SHIFT, fft_size)
    yt = ex.mglsa_synthesis(_t(exc), _t(mgc), ALPHA, SHIFT, fft_size)
    assert yt.shape == (len(exc),) and _rel(yt, yj) <= 1e-10


def test_mglsa_refuses_an_fft_shorter_than_its_taps():
    with pytest.raises(ValueError, match="fft_size"):
        ex.mglsa_synthesis(torch.zeros(400, dtype=torch.float64),
                           torch.zeros(6, 5, dtype=torch.float64), ALPHA,
                           80, 256)


def _k37_numpy(exc, mgc, shift, fft_size):
    """K37's two launchers in numpy: a frame's H from the folded table,
    the Hann segment (zeros outside [0, n)), its spectrum times H (a
    power-of-two N by the FFT, any other by the direct DFT at the N/2+1
    bins and the L+2K outputs), the taps [-K, L+K), then the gather over
    the frames that cover each output sample, in frame order."""
    Tn, M = mgc.shape
    n = len(exc)
    L = K = 2 * shift
    W = L + 2 * K
    F = fft_size // 2 + 1
    H = np.exp(mgc @ ex.mglsa_table(M - 1, ALPHA, fft_size))
    win = np.hanning(L + 1)[:L]
    p = np.arange(Tn)[:, None] * shift - shift + np.arange(L)[None, :]
    seg = np.where((p >= 0) & (p < n), exc[np.clip(p, 0, n - 1)], 0.0) * win
    nn = np.where(np.arange(W) < K, fft_size - K + np.arange(W),
                  np.arange(W) - K)
    if fft_size & (fft_size - 1) == 0:
        k = np.arange(fft_size)
        h = H[:, np.minimum(k, fft_size - k)]
        y = np.fft.ifft(np.fft.fft(seg, fft_size) * h).real
        taps = y[:, nn]
    else:
        jk = np.outer(np.arange(L), np.arange(F)) % fft_size
        ang = 2.0 * np.pi * jk / fft_size
        yr = (seg @ np.cos(ang)) * H
        yi = -(seg @ np.sin(ang)) * H
        kn = np.outer(np.arange(1, F), nn) % fft_size
        c, s = np.cos(2 * np.pi * kn / fft_size), np.sin(
            2 * np.pi * kn / fft_size)
        w = np.where(2 * np.arange(1, F) == fft_size, 1.0, 2.0)[:, None]
        nyq = (2 * np.arange(1, F) == fft_size)[:, None]
        terms = np.where(nyq, yr[:, 1:, None] * c,
                         w * (yr[:, 1:, None] * c - yi[:, 1:, None] * s))
        taps = (yr[:, :1] + terms.sum(1)) / fft_size
    out = np.zeros(n)
    for q in range(n):
        pos = q + W // 2
        t_hi = min(Tn - 1, pos // shift)
        lo = pos - W + 1
        t_lo = 0 if lo <= 0 else (lo + shift - 1) // shift
        acc = 0.0
        for t in range(t_lo, t_hi + 1):
            acc = acc + taps[t, pos - t * shift]
        out[q] = acc
    return out


@pytest.mark.parametrize("fft_size", [1024, 1000])
def test_k37_arithmetic_in_numpy_matches_the_twin(fft_size):
    exc = _noise((T - 1) * SHIFT, 9)
    mgc = _mgc(10)
    want = ex.mglsa_synthesis_plain(_t(exc), _t(mgc), ALPHA, SHIFT,
                                    fft_size)
    assert _rel(_k37_numpy(exc, mgc, SHIFT, fft_size), want) <= 1e-12


def _k35_numpy(pitch, shift, noise):
    """K35 in numpy: the per-sample period, the blocked scan level by level
    (a block of 16 summed in sequence, the totals one level up, the
    previous blocks' total added on the way down), the running max of the
    onset bases, the pulses."""
    Tn = len(pitch)
    n = (Tn - 1) * shift
    pos = np.arange(n) / shift
    i0 = np.clip(np.floor(pos).astype(int), 0, Tn - 2)
    p0, p1 = pitch[i0], pitch[i0 + 1]
    p = np.where((p0 > 0) & (p1 > 0), p0 + (p1 - p0) * (pos - i0), p0)
    v = p > 0
    f = np.where(v, 1.0 / np.maximum(p, 1e-6), 0.0)
    levels = [f.copy()]
    while len(levels[-1]) > 16:
        cur = levels[-1]
        nb = -(-len(cur) // 16)
        up = np.empty(nb)
        for b in range(nb):
            blk = cur[b * 16:(b + 1) * 16]
            for j in range(1, len(blk)):
                blk[j] = blk[j - 1] + blk[j]
            up[b] = blk[-1]
        levels.append(up)
    top = levels[-1]
    for j in range(1, len(top)):
        top[j] = top[j - 1] + top[j]
    for cur, up in zip(levels[-2::-1], levels[:0:-1]):
        cur[16:] = cur[16:] + up[np.arange(16, len(cur)) // 16 - 1]
    raw = levels[0]
    onset = v & ~np.concatenate([[False], v[:-1]])
    base = np.maximum.accumulate(np.where(onset, raw - f, 0.0))
    ph = raw - base
    fired = np.floor(ph) > np.floor(np.concatenate([[0.0], ph[:-1]]))
    return np.where(v, np.where(fired, np.sqrt(np.maximum(p, 1e-6)), 0.0),
                    noise)


@pytest.mark.parametrize("period", [120.0, "contour"])
def test_k35_arithmetic_in_numpy_matches_the_twin(period):
    pitch = (np.asarray(jex.lf0_to_pitch(_contour(), FS))
             if period == "contour" else np.full(T, period))
    noise = _noise((T - 1) * SHIFT, 11)
    want = ex.excite_plain(_t(pitch), SHIFT, _t(noise))[0].numpy()
    np.testing.assert_array_equal(_k35_numpy(pitch, SHIFT, noise), want)


# ---------------------------------------------------------------------------
# mel-cepstral analysis (K38) and the rest of sptk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vowel_logp():
    """Log amplitude spectra (T, 513) of a 190 Hz vowel from the parity
    analysis (16 kHz, 5 ms; the port's, held to the JAX package's in
    tests/test_torch_parity_analysis.py)."""
    rng = np.random.default_rng(1)
    n = (T - 1) * SHIFT
    t = np.arange(n) / FS
    x = sum(a * np.sin(2 * np.pi * 190.0 * (h + 1) * t)
            for h, a in enumerate([0.5, 0.3, 0.15, 0.08, 0.04]))
    x = 0.6 * x + 0.003 * rng.standard_normal(n)
    a = vocoder.analyze(x, FS, 5.0, device="cpu")
    assert a.fft_size == N and a.spectrogram.shape == (T, N // 2 + 1)
    return np.log(np.maximum(a.spectrogram.numpy(), 1e-12)) / 2.0


@pytest.fixture(scope="module")
def jax_mcep(vowel_logp):
    return np.asarray(jsptk.mcep(jnp.asarray(vowel_logp), ORDER, ALPHA, N))


def test_mcep_matches_jax(vowel_logp, jax_mcep):
    """1e-9 of max |mc| (measured here: 2.0e-16)."""
    want = jax_mcep
    got = sptk.mcep(_t(vowel_logp), ORDER, ALPHA, N)
    assert got.shape == want.shape == (vowel_logp.shape[0], ORDER + 1)
    assert _rel(got, want) <= 1e-9


def _lu_solve(A, b):
    """K38's solve in numpy: LU with partial pivoting (the first largest
    |pivot|), the right side carried along, then back substitution a
    column at a time."""
    A, b = A.copy(), b.copy()
    n = len(b)
    for k in range(n):
        p = k + int(np.argmax(np.abs(A[k:, k])))
        A[[k, p]], b[[k, p]] = A[[p, k]], b[[p, k]]
        A[k + 1:, k] /= A[k, k]
        A[k + 1:, k + 1:] -= np.outer(A[k + 1:, k], A[k, k + 1:])
        b[k + 1:] -= A[k + 1:, k] * b[k]
    for i in range(n - 1, -1, -1):
        b[i] /= A[i, i]
        b[:i] -= A[:i, i] * b[i]
    return b


def test_k38_arithmetic_in_numpy_matches_the_twin(vowel_logp):
    """K38's folded tables and solve in numpy against the twin (FFT form,
    torch.linalg.solve) at 1e-9 of max |mc|."""
    lp = vowel_logp[::8]
    A0, Tb, Tr = sptk.mcep_tables(ORDER, ALPHA, N)
    al = (-ALPHA) ** np.arange(ORDER + 1)
    xh = np.exp(lp)
    mc = lp @ A0.T
    for _ in range(sptk.MCEP_ITERS):
        r = (xh / np.exp(2.0 * (mc @ Tb))) @ Tr.T
        t, y, b = (a.numpy() for a in sptk._newton_terms(_t(r), _t(al),
                                                         ORDER))
        idx = np.arange(ORDER + 1)
        A = t[:, np.abs(idx[:, None] - idx)] + y[:, idx[:, None] + idx]
        mc = mc + np.stack([_lu_solve(A[f], b[f]) for f in range(len(b))])
    assert _rel(mc, sptk.mcep_plain(_t(lp), ORDER, ALPHA, N)) <= 1e-9


def test_theq_gnorm_ignorm_match_jax():
    rng = np.random.default_rng(12)
    t = rng.standard_normal((4, 6))
    t[:, 0] += 10.0
    h = rng.standard_normal((4, 11)) * 0.1
    b = rng.standard_normal((4, 6))
    assert _rel(sptk.theq_dense(_t(t), _t(h), _t(b)),
                jsptk.theq_dense(t, h, b)) <= 1e-12
    c = rng.standard_normal((7, 13)) * 0.2
    pos = np.abs(c) + 0.5
    for g in (0.0, -0.5, -1.0 / 3.0):
        assert _rel(sptk.gnorm(_t(c), g), jsptk.gnorm(jnp.asarray(c), g)) \
            <= 1e-12
        assert _rel(sptk.ignorm(_t(pos), g),
                    jsptk.ignorm(jnp.asarray(pos), g)) <= 1e-12


@pytest.mark.parametrize("g1,m2,g2", [(0.0, 15, -0.25), (-0.5, 10, 0.0),
                                      (-1.0 / 3.0, 20, -0.5)])
def test_gc2gc_matches_jax(g1, m2, g2):
    c = np.random.default_rng(13).standard_normal((7, 13)) * 0.2
    assert _rel(sptk.gc2gc(_t(c), g1, m2, g2),
                jsptk.gc2gc(jnp.asarray(c), g1, m2, g2)) <= 1e-12


@pytest.mark.parametrize("args", [(0.0, 0.0, 15, ALPHA, -0.5),
                                  (0.1, -0.5, 10, ALPHA, -0.25),
                                  (ALPHA, 0.0, 12, ALPHA, 0.0),
                                  (0.0, -0.5, 8, 0.0, -0.5),
                                  (0.0, -0.5, 20, 0.0, 0.0)])
def test_mgc2mgc_matches_jax(args):
    c = np.random.default_rng(14).standard_normal((7, 13)) * 0.2
    c[:, 0] = np.abs(c[:, 0]) + 0.5
    want = np.asarray(jsptk.mgc2mgc(jnp.asarray(c), *args))
    assert np.isfinite(want).all()
    assert _rel(sptk.mgc2mgc(_t(c), *args), want) <= 1e-12


# ---------------------------------------------------------------------------
# the LSP postfilter and the gm > 0 preamble
# ---------------------------------------------------------------------------


def _lsp_frames(m=12, seed=15):
    """(T, 1 + m) frames of [gain, LSPs]: spread ascending LSPs in (0, pi),
    two frames with a crossed and a doubled pair for lspcheck."""
    rng = np.random.default_rng(seed)
    lsp = np.linspace(0.15, 2.95, m)[None, :] + rng.uniform(
        -0.08, 0.08, (T, m))
    lsp[3, 4], lsp[3, 5] = lsp[3, 5], lsp[3, 4]
    lsp[7, 6] = lsp[7, 7]
    return np.concatenate([rng.standard_normal((T, 1)), lsp], axis=1)


def test_lsp_to_lpc_at_an_odd_order_matches_jax():
    lsp = _lsp_frames(11)[:, 1:]
    assert _rel(pf.lsp_to_lpc(_t(lsp)), jpf.lsp_to_lpc(jnp.asarray(lsp))) \
        <= 1e-12


def test_lsp_functions_match_jax():
    fr = _lsp_frames(12)
    gain, lsp = fr[:, 0], fr[:, 1:]
    for name in ("lsp_sharpen", "lsp_check", "lsp_to_lpc"):
        assert _rel(getattr(pf, name)(_t(lsp)),
                    getattr(jpf, name)(jnp.asarray(lsp))) <= 1e-12, name
    assert _rel(pf.lsp_spectrum_energy(_t(gain), _t(lsp)),
                jpf.lsp_spectrum_energy(jnp.asarray(gain),
                                        jnp.asarray(lsp))) <= 1e-12
    for em in (False, True):
        assert _rel(pf.lsp_postfilter(_t(fr), 0.7, em),
                    jpf.lsp_postfilter(jnp.asarray(fr), 0.7, em)) <= 1e-12


@pytest.mark.parametrize("gamma_stages,pf_,log_gain", [(1, 0.0, True),
                                                       (3, 0.7, True),
                                                       (2, 1.3, False)])
def test_lsp_branch_to_mgc_matches_jax(gamma_stages, pf_, log_gain):
    fr = _lsp_frames()
    if not log_gain:
        fr[:, 0] = np.abs(fr[:, 0]) + 0.1
    want = jex.lsp_branch_to_mgc(jnp.asarray(fr), ALPHA, gamma_stages, pf_,
                                 log_gain)
    got = ex.lsp_branch_to_mgc(_t(fr), ALPHA, gamma_stages, pf_, log_gain)
    assert _rel(got, want) <= 1e-12


# ---------------------------------------------------------------------------
# the engine end to end
# ---------------------------------------------------------------------------


def _jax_noise(n):
    """The JAX package's own draws for `synthesize_sptk`'s default key."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return tuple(np.asarray(jax.random.normal(k, (n,), jnp.float64))
                 for k in (k1, k2))


def test_generate_waveform_sptk_matches_jax():
    """1e-10 of max |y| with JAX's noise injected: the contour with gaps
    and vibrato, V/UV off over a run the lf0 leaves voiced."""
    rng = np.random.default_rng(16)
    statics = {"lf0": _contour()[:, None], "mgc": _mgc(17),
               "bap": rng.standard_normal((T, 1))}
    vuv = np.ones(T, bool)
    vuv[30:36] = False
    want = np.asarray(jpgen.generate_waveform(statics, vuv, FS,
                                              engine="sptk"))
    got = pgen.generate_waveform(statics, vuv, FS, engine="sptk",
                                 noise=_jax_noise((T - 1) * SHIFT),
                                 device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got, want) <= 1e-10
    stages = [s for s, _ in pgen.waveform_stages(
        statics, vuv, FS, engine="sptk", device="cpu")]
    assert stages == ["excitation", "filter"]


def test_synthesize_sptk_copy_synthesis_matches_jax(vowel_logp, jax_mcep):
    """The engine's analysis half into its synthesis: mcep of the vowel,
    then mixed excitation and MGLSA at the same alpha, against JAX's."""
    mgc = jax_mcep
    Tv = mgc.shape[0]
    lf0 = np.full(Tv, np.log(190.0))
    lf0[:4] = jex.MAGIC
    low, high = filters.band_split_filters(FS)
    want = jex.synthesize_sptk(lf0, mgc, FS, SHIFT, ALPHA, low, high, N)
    got = ex.synthesize_sptk(_t(lf0), sptk.mcep(_t(vowel_logp), ORDER,
                                                ALPHA, N), FS, SHIFT, ALPHA,
                             low, high, N, noise=_jax_noise((Tv - 1) * SHIFT))
    assert _rel(got, want) <= 1e-10
