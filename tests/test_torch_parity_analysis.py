"""The port's parity analysis (float64 on the reference's noise streams)
against the JAX package under x64, on the CPU.

Every JAX call is jit-compiled (the package's own jitted DIO, StoneMask,
CheapTrick and D4C; `jax.jit` around the rest), and the JAX results are
computed once per module.  Inputs are made from a seed with numpy: a
tonal utterance with a gliding pitch and an unvoiced gap, at 16 kHz
(0.3 s) and at 44.1 kHz (0.2 s, a frame grid of 220.5 samples).

Per module the port is fed the JAX package's own intermediate results,
so each module's error is its own: DIO (candidates, scores, f0) at rel
1e-9, StoneMask's bucket path at rel 1e-9, the smoothing's parity forms
at 1e-12 of each row's largest value, CheapTrick on its stream at rel
1.5e-8, D4C on its stream at 1e-9, the sorted band ratio (K31's twin) at
1e-12, and the float64 encode at 1e-10.  The slice whole: `analyze` and
`copy_synthesis` at their default (parity) against the JAX package's,
the `analysis` command's float32 files, and the pipeline at parity=True.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import cli as jcli
from hts_train_world_tpu import vocoder as jvocoder
from hts_train_world_tpu.ops import cheaptrick as jct
from hts_train_world_tpu.ops import d4c as jd4c
from hts_train_world_tpu.ops import dio as jdio
from hts_train_world_tpu.ops import prims as jprims
from hts_train_world_tpu.ops import rand as jrand
from hts_train_world_tpu.ops import stonemask as jsm
from hts_train_world_tpu_torch import cli, kernels, vocoder
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch.features import encode, vibrato
from hts_train_world_tpu_torch.io import rawio, wavio
from hts_train_world_tpu_torch.ops import cheaptrick as ct
from hts_train_world_tpu_torch.ops import d4c
from hts_train_world_tpu_torch.ops import dio
from hts_train_world_tpu_torch.ops import prims, rand
from hts_train_world_tpu_torch.ops import stonemask as sm
from hts_train_world_tpu_torch.runtime import pipeline as pl

FP = 5.0
CASES = {16000: 0.3, 44100: 0.2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the twins run many small ops, which the
    default thread pool slows many-fold when test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signal(fs, dur, seed=0):
    """Two harmonics of a pitch gliding 150 -> 230 Hz, an unvoiced gap of
    noise at 40-55 % of the duration, a little noise throughout."""
    rng = np.random.default_rng(seed)
    n = int(dur * fs)
    f = np.linspace(150.0, 230.0, n)
    ph = 2 * np.pi * np.cumsum(f) / fs
    x = 0.5 * np.sin(ph) + 0.2 * np.sin(2 * ph) + 0.003 * rng.standard_normal(n)
    a, b = int(0.40 * n), int(0.55 * n)
    x[a:b] = 0.05 * rng.standard_normal(b - a)
    return x


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    den = np.where(want == 0.0, 1.0, np.abs(want))
    return float(np.max(np.where(got == want, 0.0, np.abs(got - want) / den)))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's parity analysis of each case and its parts."""
    out = {}
    for fs, dur in CASES.items():
        x = _signal(fs, dur)
        xj = jnp.asarray(x)
        t, f0_dio, cands, scores = jdio.dio(xj, fs, FP)
        a = jvocoder.analyze(xj, fs, FP)            # parity=True
        N = a.fft_size
        T = int(a.f0.shape[0])
        nw, ns = jct.cheaptrick_noise(a.f0, fs, N, jnp.asarray(
            jrand.randn_stream(jct.cheaptrick_stream_len(T, N))))
        ap, ap0 = jd4c.d4c(xj, fs, t, a.f0, N, 0.0, jnp.asarray(
            jrand.randn_stream(jd4c.d4c_stream_len(T, fs))))
        y = jvocoder.synthesize(a.f0, a.spectrogram, a.aperiodicity, fs, N,
                                FP)
        out[fs] = dict(x=x, t=np.asarray(t), f0_dio=np.asarray(f0_dio),
                       cands=np.asarray(cands), scores=np.asarray(scores),
                       f0=np.asarray(a.f0), sp=np.asarray(a.spectrogram),
                       ap=np.asarray(a.aperiodicity), ap_d4c=np.asarray(ap),
                       ap0=np.asarray(ap0), N=N, T=T, y=np.asarray(y))
    return out


# ---------------------------------------------------------------------------
# per module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", list(CASES))
def test_dio_float64_matches_jax(jax_runs, fs):
    """The reference's band filtering in complex128, the worst-case cap
    and interp1 at arange(T) * fp: candidates, scores and f0 at rel
    1e-9; the frame times equal."""
    r = jax_runs[fs]
    t, f0, cands, scores = dio.dio(_t(r["x"])[None], fs, FP, parity=True)
    assert t.dtype == torch.float64 and np.array_equal(t.numpy(), r["t"])
    assert _rel(cands[0].numpy(), r["cands"]) <= 1e-9
    assert _rel(scores[0].numpy(), r["scores"]) <= 1e-9
    assert _rel(f0[0].numpy(), r["f0_dio"]) <= 1e-9
    assert (r["f0_dio"] > 0).sum() > 10 and (r["f0_dio"] == 0).sum() >= 3


@pytest.mark.parametrize("fs", list(CASES))
def test_stonemask_bucket_path_matches_jax(jax_runs, fs):
    """The bucket path (per-sample rounded indices, each bucket's own DFT
    size, the two-pass readout) against `stonemask(grid_step=0)`, fed
    JAX's DIO contour: rel 1e-9; the gated frames stay 0."""
    r = jax_runs[fs]
    got = sm.stonemask(_t(r["x"])[None], fs, _t(r["t"]),
                       _t(r["f0_dio"])[None], parity=True)[0].numpy()
    want = np.asarray(jsm.stonemask(jnp.asarray(r["x"]), fs,
                                    jnp.asarray(r["t"]),
                                    jnp.asarray(r["f0_dio"]), grid_step=0))
    assert _rel(got, want) <= 1e-9
    assert np.array_equal(got == 0, r["f0_dio"] == 0)


def _harmonic_rows(rng, n_rows, N, fs):
    """Power spectra of harmonic rows: a comb at a random f0 over a floor
    4-6 decades below the peak."""
    k = np.arange(N // 2 + 1) * fs / N
    f0 = rng.uniform(90.0, 400.0, n_rows)
    rows = np.full((n_rows, N // 2 + 1), 1e-5)
    for h in range(1, 40):
        rows += np.exp(-0.5 * ((k[None] - h * f0[:, None]) / 12.0) ** 2) \
            / h ** 2
    return rows * rng.uniform(0.5, 2.0, rows.shape), f0


@pytest.mark.parametrize("fs,N", [(16000, 1024), (16000, 2048),
                                  (44100, 2048)])
def test_smoothing_parity_forms_match_jax(fs, N):
    """dc_correction's generic branch and linear_smoothing's mirror
    branch (K2's parity mode) against `jprims`, at CheapTrick's and D4C's
    widths.  The port sums the mirrored row in sequence, as the reference
    does; the JAX package's jnp.cumsum on the CPU reassociates it, so
    bins far below a row's peak differ by cancellation, not by the
    order: held at 1e-12 of each row's largest value."""
    rng = np.random.default_rng(1)
    ps, f0 = _harmonic_rows(rng, 12, N, fs)
    fmax = max(fs / 12.0, cfg.K_CEIL_F0)
    ul_max = 2 + int(fmax * N / fs) + 1
    b_max = int(fmax * N / fs) + 1
    dc = jax.jit(jax.vmap(lambda p, f: jprims.dc_correction(
        p, f, fs, N, ul_max)))
    ls = jax.jit(jax.vmap(lambda p, w: jprims.linear_smoothing(
        p, w, fs, N, b_max)))
    want_dc = np.asarray(dc(jnp.asarray(ps), jnp.asarray(f0)))
    got_dc = prims.dc_correction(_t(ps), _t(f0), fs, N, ul_max,
                                 parity=True).numpy()
    np.testing.assert_allclose(got_dc, want_dc, rtol=1e-12, atol=0)
    for width in (f0 * 2.0 / 3.0, f0, f0 / 2.0):
        want = np.asarray(ls(jnp.asarray(want_dc), jnp.asarray(width)))
        got = prims.linear_smoothing(_t(want_dc), _t(width), fs, N,
                                     b_max, parity=True).numpy()
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-12 * scale)


@pytest.mark.parametrize("fs", list(CASES))
def test_cheaptrick_parity_matches_jax(jax_runs, fs):
    """Windows at any position with the stream's noise, the absolute
    floor, the FFT lifter: rel 1.5e-8 (the reference's tolerance for
    CheapTrick, ARCHITECTURE.md), fed JAX's f0."""
    r = jax_runs[fs]
    stream = rand.randn_stream(ct.cheaptrick_stream_len(r["T"], r["N"]))
    got = ct.cheaptrick_parity(_t(r["x"])[None], fs, _t(r["t"]),
                               _t(r["f0"])[None], r["N"], -0.15, stream)
    assert got.dtype == torch.float64
    assert _rel(got[0].numpy(), r["sp"]) <= 1.5e-8


def test_noise_offsets_are_the_streams_slices(jax_runs):
    """CheapTrick's window and spectral draws start where the JAX
    package's `cheaptrick_noise` slices them."""
    r = jax_runs[16000]
    N, T = r["N"], r["T"]
    stream = rand.randn_stream(ct.cheaptrick_stream_len(T, N))
    win, spec = ct.noise_offsets(_t(r["f0"])[None], 16000, N)
    nw, ns = jct.cheaptrick_noise(jnp.asarray(r["f0"]), 16000, N,
                                  jnp.asarray(stream.numpy()))
    np.testing.assert_array_equal(stream[spec].numpy(), np.asarray(ns)[:, 0])
    np.testing.assert_array_equal(stream[win].numpy(), np.asarray(nw)[:, 0])


@pytest.mark.parametrize("fs", list(CASES))
def test_d4c_parity_matches_jax(jax_runs, fs):
    """LoveTrain and the body on their blocks of the stream, the sorted
    band ratio: ap and ap0 at 1e-9 (absolute: ap and ap0 lie in
    [0, 1]), fed JAX's f0."""
    r = jax_runs[fs]
    stream = rand.randn_stream(d4c.d4c_stream_len(r["T"], fs))
    ap, ap0 = d4c.d4c_parity(_t(r["x"])[None], fs, _t(r["t"]),
                             _t(r["f0"])[None], r["N"], 0.0, stream)
    np.testing.assert_allclose(ap[0].numpy(), r["ap_d4c"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(ap0[0].numpy(), r["ap0"], rtol=0, atol=1e-9)
    assert (r["ap_d4c"] < 0.5).any() and (r["ap0"] > 0).any()


@pytest.mark.parametrize("fs", [16000, 48000])
def test_band_sort_sums_match_jax_coarse_aperiodicity(fs):
    """K31's twin: each band's power sorted ascending (IEEE totalOrder)
    and summed in jnp.cumsum's blocked order; the coarse dB from its two
    sums against
    `_coarse_aperiodicity` on the same group-delay rows at 1e-12."""
    rng = np.random.default_rng(2)
    fft_d = cfg.d4c_fft_size(fs)
    n_ap = cfg.number_of_aperiodicities(fs)
    wl, starts, boundary = d4c.band_layout(fs, fft_d, n_ap)
    window = prims.nuttall_window_np(wl)
    sgd = rng.standard_normal((5, fft_d // 2 + 1)).cumsum(axis=1) * 1e-3
    want = np.asarray(jax.jit(jax.vmap(lambda s: jd4c._coarse_aperiodicity(
        s, fs, fft_d, n_ap, jnp.asarray(window), wl)))(jnp.asarray(sgd)))
    segs = d4c.band_segments_plain(_t(sgd), torch.zeros(sgd.shape,
                                                        dtype=torch.float64),
                                   starts, _t(window))
    spec = torch.fft.rfft(segs, n=fft_d, dim=2).reshape(-1, fft_d // 2 + 1)
    num, den = d4c.band_sort_sums_plain(spec.real ** 2 + spec.imag ** 2,
                                        fft_d // 2 - boundary - 1)
    got = (10.0 * torch.log10(num / den)).reshape(5, n_ap).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_band_sort_sums_nan_and_order_as_jax():
    """A NaN of either sign sorts last (den is NaN, num is not); signed
    zeros and ties sum alike: the same as jnp.sort + jnp.cumsum.  Rows of
    5 values lie inside one of XLA's scan blocks of 16, where the blocked
    order is the sequential one (the tests below take longer rows)."""
    rows = np.array([[3.0, np.nan, 1.0, 2.0, 0.5],
                     [3.0, -np.nan, 1.0, 2.0, 0.5],
                     [0.0, -0.0, 2.0, 2.0, 1.0]])
    num, den = d4c.band_sort_sums_plain(_t(rows), 2)
    c = np.asarray(jnp.cumsum(jnp.sort(jnp.asarray(rows), axis=1), axis=1))
    np.testing.assert_array_equal(num.numpy(), c[:, 2])
    np.testing.assert_array_equal(den.numpy(), c[:, -1])
    assert np.isnan(den[:2]).all() and not np.isnan(num[:2]).any()


# K31's entries: the first and last of a scan block, the next block's
# first, a block's middle, half - boundary - 1 of 16 and 48 kHz, H - 1
BAND_SORT_ENTRIES = {"0": 0, "15": 15, "16": 16, "mid": 16 * 7 + 8,
                     "16k": 1002, "48k": 1983, "last": -1}


@functools.lru_cache(maxsize=None)
def _band_rows(H: int):
    """Seeded power rows of width H over nine decades (sums whose order
    shows in the last bits), then a row with a NaN, one with a -NaN, one
    of signed zeros and ties, one all ties; and JAX's jitted
    jnp.cumsum(jnp.sort(p)) of them."""
    rng = np.random.default_rng(H)
    rows = 10.0 ** rng.uniform(-6, 3, (40, H))
    rows[0, 7] = np.nan
    rows[1, H // 3] = -np.nan
    rows[2, ::3] = -0.0
    rows[2, 1::3] = 0.0
    rows[2, 2::6] = 2.5
    rows[3] = 0.125
    c = np.asarray(jax.jit(lambda p: jnp.cumsum(jnp.sort(p, axis=1),
                                                axis=1))(jnp.asarray(rows)))
    return rows, c


def _kernel_reading_sums(p, i_num: int):
    """K31's reading of a row of H = 2^k + 1 values, written out on the
    CPU: the first 2^k keys sorted, the last key placed at its rank (the
    count of sorted keys at or below it), the merged sequence read by
    index arithmetic (sorted[j] below the rank, sorted[j - 1] above it),
    and c[i] as the kernel takes it: the sequential prefix of i's block
    of 16, plus the blocked scan of the block totals before it (+0.0 in
    block 0)."""
    R, H = p.shape
    keys = d4c._sort_keys(p)
    head, _ = torch.sort(keys[:, :H - 1], dim=1)
    last = keys[:, H - 1:]
    rank = (head <= last).sum(1, keepdim=True)
    j = torch.arange(H)[None, :]
    src = torch.where(j < rank, j, j - 1).clamp(0, H - 2)
    merged = torch.where(j == rank, last, torch.gather(head, 1, src))
    vals = torch.where(merged < 0, merged ^ 0x7FFFFFFFFFFFFFFF,
                       merged).view(torch.float64)
    nb = -(-H // 16)
    local = torch.cumsum(torch.nn.functional.pad(vals, (0, 16 * nb - H))
                         .reshape(R, nb, 16), dim=-1)
    totals = prims.xla_cumsum(local[..., -1])

    def at(i):
        b = i // 16
        return local[:, b, i % 16] + (totals[:, b - 1] if b else 0.0)
    return at(i_num), at(H - 1)


@pytest.mark.parametrize("entry", list(BAND_SORT_ENTRIES))
@pytest.mark.parametrize("H", [1025, 2049])
def test_band_sort_sums_bit_equal_to_jax_blocked_order(H, entry):
    """K31's twin against JAX's jitted jnp.cumsum(jnp.sort(p)) bit for bit
    at i_num and at H - 1, on rows longer than XLA's scan block (where a
    sequential sum parts from it in the last bits), NaN rows of either
    sign, signed zeros and ties included (NaN where JAX's is)."""
    rows, c = _band_rows(H)
    i_num = BAND_SORT_ENTRIES[entry] % H
    num, den = d4c.band_sort_sums_plain(_t(rows), i_num)
    np.testing.assert_array_equal(num.numpy(), c[:, i_num])
    np.testing.assert_array_equal(den.numpy(), c[:, -1])
    assert np.isnan(den[:2].numpy()).all()
    assert not np.isnan(den[2:].numpy()).any()


@pytest.mark.parametrize("H", [17, 1025, 2049])
def test_band_sort_kernel_reading_matches_twin(H):
    """The kernel's merged-sequence reading and blocked sum, written out
    (`_kernel_reading_sums`), equal the twin bit for bit at every entry
    of BAND_SORT_ENTRIES, NaN rows, signed zeros and ties included."""
    rows = _t(_band_rows(1025)[0][:, :H] if H <= 1025
              else _band_rows(H)[0])
    rows[4, -1] = rows[4, 0]          # the last key ties a sorted one
    rows[5, -1] = float("nan")        # the last key is a NaN
    rows[6, -1] = -0.0
    for i_num in sorted({v % H for v in BAND_SORT_ENTRIES.values()}):
        for got, want in zip(_kernel_reading_sums(rows, i_num),
                             d4c.band_sort_sums_plain(rows, i_num)):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            fin = ~torch.isnan(want)
            assert torch.equal(got[fin].view(torch.int64),
                               want[fin].view(torch.int64))


def _raw_scale(coded, c0_offset):
    """Each row's largest coefficient before the c0 offset (the DCT sums
    round at that scale; the offset is added after them)."""
    raw = np.abs(np.concatenate([coded[:, :1] - c0_offset, coded[:, 1:]],
                                axis=1))
    return raw.max(axis=1, keepdims=True)


def _ulp_words(got, want, noise_at=None, noise: float = 1e-9):
    """The float32 words of `got` that differ from `want`'s by one ulp
    (float64 results that straddle a float32 rounding boundary).  Every
    other differing word must be a rounding-noise coefficient: |value| <=
    noise on both sides, at a place `noise_at` (bool, got's shape) allows.
    Those are the bap coefficients past c0 of the frames the reference
    marks unvoiced: their flat aperiodicity codes to zero in exact
    arithmetic and comes out as either package's rounding residue."""
    gi = got.view(np.int32).astype(np.int64)
    wi = want.view(np.int32).astype(np.int64)
    differ = gi != wi
    noisy = (np.abs(got) <= noise) & (np.abs(want) <= noise)
    noisy &= noise_at if noise_at is not None else False
    ulp = differ & ~noisy
    assert (np.abs(gi - wi)[ulp] <= 1).all(), (got[ulp], want[ulp])
    return int(ulp.sum())


def _bap_noise_at(unvoiced, bap_dim: int):
    """Where `_ulp_words` lets a bap file's words be rounding noise: the
    coefficients past c0 of the unvoiced frames, flattened."""
    return (unvoiced[:, None] & (np.arange(bap_dim) >= 1)).reshape(-1)


@pytest.mark.parametrize("fs", list(CASES))
def test_encode_features_float64_matches_jax(jax_runs, fs):
    """K6's twin in float64 against the JAX CLI's encode under x64 (the
    sp * 1e4 zero rule, +12 on c0, bap0 - LN_1E4 with its snap, lf0): at
    1e-10 of each row's largest raw coefficient (c0 before its offset)."""
    r = jax_runs[fs]
    enc = jax.jit(jcli.encode_features, static_argnums=(3, 4, 5, 6))
    sp = r["sp"].copy()
    sp[3, :5] = 0.0                         # the zero rule
    want = enc(jnp.asarray(r["f0"]), jnp.asarray(sp), jnp.asarray(r["ap"]),
               fs, r["N"], 50, 25)
    got = encode.encode_features(_t(r["f0"]), _t(sp), _t(r["ap"]), fs,
                                 r["N"], 50, 25)
    for g, w, off in zip(got, want, (None, 12.0, -encode.LN_1E4)):
        w = np.asarray(w)
        assert g.dtype == torch.float64
        scale = np.abs(w).max() if off is None else _raw_scale(w, off)
        assert np.all(np.abs(g.numpy() - w) <= 1e-10 * scale)


# ---------------------------------------------------------------------------
# the slice whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """The port's `copy_synthesis` at its default (parity) on the CPU."""
    out = {}
    for fs, r in jax_runs.items():
        kernels.reset_counts()
        a, y = vocoder.copy_synthesis(r["x"], fs, FP, device="cpu")
        assert sum(kernels.launches.values()) == 0
        out[fs] = (a, y)
    return out


@pytest.mark.parametrize("fs", list(CASES))
def test_analyze_parity_matches_jax(jax_runs, port_runs, fs):
    """`vocoder.analyze` at parity against the JAX package's: f0 at rel
    1e-9, sp at rel 1.5e-8, ap at 1e-9; float64 throughout, at 44.1 kHz
    on its non-integral frame grid too."""
    r = jax_runs[fs]
    a, _ = port_runs[fs]
    assert a.f0.dtype == torch.float64 and a.fft_size == r["N"]
    assert np.array_equal(a.temporal_positions.numpy(), r["t"])
    assert _rel(a.f0.numpy(), r["f0"]) <= 1e-9
    assert _rel(a.spectrogram.numpy(), r["sp"]) <= 1.5e-8
    np.testing.assert_allclose(a.aperiodicity.numpy(), r["ap"], rtol=0,
                               atol=1e-9)
    assert (r["f0"] > 0).sum() > 10 and (r["f0"] == 0).sum() >= 3


@pytest.mark.parametrize("fs", list(CASES))
def test_copy_synthesis_parity_matches_jax(jax_runs, port_runs, fs):
    """The round trip at parity: its synthesis half against the JAX
    package's parity synthesis of the port's own analysis within 1e-10,
    the bound of the parity synthesis tests; and the whole against the
    JAX package's round trip within 1e-8 (the analyses' differences, sp
    within 1.5e-8 and ap within 1e-9, carried into the waveform, where
    ap near its clip magnifies them through sqrt(1 - ap^2))."""
    r = jax_runs[fs]
    a, y = port_runs[fs]
    assert y.dtype == torch.float64 and y.shape == r["y"].shape
    assert np.abs(r["y"]).max() > 0.1
    half = jvocoder.synthesize(*(jnp.asarray(v.numpy()) for v in (
        a.f0, a.spectrogram, a.aperiodicity)), fs, r["N"], FP)
    np.testing.assert_allclose(y.numpy(), np.asarray(half), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(y.numpy(), r["y"], rtol=0, atol=1e-8)


def test_estimate_f0_matches_jax(jax_runs):
    """`estimate_f0` as the JAX package's: a float64 waveform takes DIO's
    parity path and StoneMask's bucket path (rel 1e-9); a float32 one
    with `fast_grid` on the integral frame grid takes the slab path, held
    to JAX's `estimate_f0(fast_grid=True)` of the same float32 waveform at
    the float32 module tests' bounds (V/UV agreement >= 0.98, median rel
    <= 1e-4, tests/test_torch_modules.py)."""
    r = jax_runs[16000]
    t, f0 = vocoder.estimate_f0(r["x"], 16000, FP, device="cpu")
    assert f0.dtype == torch.float64 and np.array_equal(t.numpy(), r["t"])
    assert _rel(f0.numpy(), r["f0"]) <= 1e-9
    x32 = r["x"].astype(np.float32)
    est = jax.jit(jvocoder.estimate_f0,
                  static_argnames=("fs", "frame_period", "fast_grid"))
    tj, fj = est(jnp.asarray(x32), fs=16000, frame_period=FP,
                 fast_grid=True)
    fj = np.asarray(fj)
    assert fj.dtype == np.float32
    t32, f32 = vocoder.estimate_f0(x32, 16000, FP, fast_grid=True,
                                   device="cpu")
    assert f32.dtype == torch.float32 and f32.shape == fj.shape
    np.testing.assert_array_equal(t32.numpy(), np.asarray(tj))
    f32 = f32.numpy()
    assert ((f32 > 0) == (fj > 0)).mean() >= 0.98
    both = (f32 > 0) & (fj > 0)
    assert both.mean() > 0.5
    assert np.median(np.abs(f32[both] / fj[both] - 1)) <= 1e-4


def test_estimate_f0_float32_bucket_path_raises(jax_runs):
    """A float32 waveform without `fast_grid`, or with it at a frame grid
    of no whole number of samples (5.03 ms at 16 kHz), is StoneMask's
    float32 bucket path, as in the JAX package: it no longer raises, and
    its f0 has the voiced frames of JAX's bucket path on the same DIO
    contour (the port's float32 DIO, held to JAX's in
    tests/test_torch_modules.py) and lies within 1e-4 median rel of it.
    refine=False is DIO's contour itself."""
    x32 = jax_runs[16000]["x"].astype(np.float32)
    for fp, fast_grid in ((FP, False), (5.03, True)):
        t, f0 = vocoder.estimate_f0(x32, 16000, fp, fast_grid=fast_grid,
                                    device="cpu")
        td, f0_dio = vocoder.estimate_f0(x32, 16000, fp, refine=False,
                                         device="cpu")
        assert f0.dtype == torch.float32 and torch.equal(t, td)
        want = np.asarray(jsm.stonemask(jnp.asarray(x32), 16000,
                                        jnp.asarray(t.numpy()),
                                        jnp.asarray(f0_dio.numpy())))
        got = f0.numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        v = want > 0
        assert v.sum() > 10
        assert np.median(np.abs(got[v] - want[v]) / want[v]) <= 1e-4


def _write_wav(path, x, fs):
    wavio.wavwrite(x, fs, path)
    return wavio.wavread(path)[0]


@pytest.mark.parametrize("mgc", [0, 50])
def test_cli_analysis_at_its_default_matches_jax(tmp_path, mgc):
    """`analysis` without --f32 (float64 parity, float32 files) against
    the JAX CLI under x64, raw (mgcdim 0) and encoded (mgc 50 / bap 25).
    The float32 words that differ are counted: each is one ulp from JAX's
    (float64 results within the analysis bounds straddle a float32
    rounding boundary) or a rounding-noise coefficient below 1e-9, and
    those only among the bap coefficients past c0 of the frames JAX's lf0
    marks unvoiced (their flat aperiodicity codes to zero but for
    rounding); the one-ulp words are at most 1 in 10^3 of all."""
    fs = 16000
    wav = str(tmp_path / "in.wav")
    _write_wav(wav, _signal(fs, CASES[fs], seed=4), fs)   # JAX's shapes
    args = [FP, 0, mgc, 25] if mgc else [FP, 0, 0]
    outs = {}
    for who in ("port", "jax"):
        paths = [str(tmp_path / f"{who}.{k}") for k in ("lf0", "mgc", "bap")]
        argv = ["analysis", wav, *paths, *(str(a) for a in args)]
        if who == "port":
            cli.main(argv + ["--device", "cpu"])
        else:
            jcli.analysis_main(argv[1:])
        outs[who] = [np.fromfile(p, dtype=np.float32) for p in paths]
    words = ulps = 0
    unvoiced = outs["jax"][0] == 0.0            # lf0 (or f0) 0: unvoiced
    for g, w, ext in zip(outs["port"], outs["jax"], ("lf0", "mgc", "bap")):
        assert g.shape == w.shape and np.isfinite(g).all()
        words += g.size
        ulps += _ulp_words(g, w, _bap_noise_at(unvoiced, 25)
                           if mgc and ext == "bap" else None)
    assert ulps <= words // 1000, (ulps, words)


def test_pipeline_at_parity_matches_jax(tmp_path):
    """`SingingPipeline(parity=True)`: ANALYZE's lf0/mgc/bap files against
    the JAX package's `analyze` + `encode_features` of the same wav (the
    float32 words held as the CLI's are), and WGEN's synthesis of those
    features against the JAX decode + `synthesize(parity=True)` within
    1e-10, the bound of the parity synthesis tests."""
    fs = 16000
    wd = str(tmp_path / "wd")
    os.makedirs(os.path.join(wd, "raw"))
    os.makedirs(os.path.join(wd, "labels", "mono"))
    xs = {}
    for u in range(2):
        path = os.path.join(wd, "raw", f"utt{u}.wav")
        xs[f"utt{u}"] = _write_wav(path, _signal(fs, CASES[fs],
                                                 seed=10 + u), fs)
    p = pl.SingingPipeline(pl.PipelineConfig(wd, fs=fs, parity=True,
                                             device="cpu"))
    p.analyze()
    lay = p.cfg.layout
    enc = jax.jit(jcli.encode_features, static_argnums=(3, 4, 5, 6))
    words = ulps = 0
    for base, x in xs.items():
        a = jvocoder.analyze(jnp.asarray(x), fs, FP)
        lf0, mgc, bap = (np.asarray(v) for v in enc(
            a.f0, a.spectrogram, a.aperiodicity, fs, a.fft_size,
            lay.mgc_dim, lay.bap_dim))
        lf0_2d, _ = vibrato.extract(lf0, [], FP)
        for ext, want in (("lf0", lf0_2d), ("mgc", mgc), ("bap", bap)):
            got = rawio.read_f32(p._p(ext, base, ext), want.shape[-1]
                                 if want.ndim > 1 else 1)
            w = np.asarray(want, np.float32).reshape(got.shape)
            words += got.size
            at = (_bap_noise_at(np.asarray(a.f0) == 0.0, lay.bap_dim)
                  .reshape(got.shape) if ext == "bap" else None)
            ulps += _ulp_words(got, w, at)
    assert ulps <= words // 1000, (ulps, words)
    # WGEN: the decode in float64 and the exact path on the stream
    base = "utt0"
    feats = [rawio.read_f32(p._p(e, base, e), d) for e, d in
             (("mgc", lay.mgc_dim), ("lf0", lay.lf0_dim),
              ("bap", lay.bap_dim))]
    y = p._synthesize(*feats).numpy()
    lf0_1 = feats[1][:, 0].astype(np.float64)
    f0, sp, ap = jcli.decode_features(
        jnp.asarray(lf0_1), jnp.asarray(feats[0].astype(np.float64)),
        jnp.asarray(feats[2].astype(np.float64)), fs,
        cfg.cheaptrick_fft_size(fs))
    want = np.asarray(jvocoder.synthesize(f0, sp, ap, fs,
                                          cfg.cheaptrick_fft_size(fs), FP))
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-10)
