"""K24-K27 (StoneMask's IF readout, CheapTrick's lifter, D4C's group
delay body and aperiodicity) on the CPU: each wrapper runs its plain twin
for CPU tensors; the twins, inside the port's StoneMask, CheapTrick and
D4C fed the JAX functions' inputs, match the JAX package at the
tolerances of tests/test_torch_modules.py; and each kernel's arithmetic,
written out in numpy float32 scalars in the CUDA source's order, against
its twin (K26's elementwise stages bit for bit; K24 but for torch's CPU
square root, K25's and K27's transcendentals within a few ulps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hts_train_world_tpu import config as jcfg
from hts_train_world_tpu.ops import cheaptrick as jct
from hts_train_world_tpu.ops import d4c as jd4c
from hts_train_world_tpu.ops import stonemask as jsm
from hts_train_world_tpu_torch import config as cfg
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import cheaptrick as ct
from hts_train_world_tpu_torch.ops import d4c as d4c_mod
from hts_train_world_tpu_torch.ops import dio as dio_mod
from hts_train_world_tpu_torch.ops import prims
from hts_train_world_tpu_torch.ops import stonemask as sm

F32 = np.float32


def _signal(fs, dur, seed, f0=180.0):
    L = int(fs * dur)
    t = np.arange(L) / fs
    rng = np.random.default_rng(seed)
    ph = np.cumsum(2 * np.pi * f0 * (1 + 0.03 * np.sin(2 * np.pi * 4 * t)) / fs)
    x = (0.6 * np.sin(ph) + 0.3 * np.sin(2 * ph) + 0.1 * np.sin(3 * ph)
         + 0.01 * rng.standard_normal(L))
    x[L // 3:L // 3 + L // 8] = 0.02 * rng.standard_normal(L // 8)
    return x.astype(np.float32)


_CACHE = {}


def _case(fs):
    """Two utterances, their DIO f0 (the port's, fed to both packages)
    and the JAX StoneMask f0 of each."""
    if fs not in _CACHE:
        xs = np.stack([_signal(fs, 0.3, 0), _signal(fs, 0.3, 1, 230.0)])
        gs = int(fs * 0.005)
        tt, f0d, _, _ = dio_mod.dio(torch.as_tensor(xs), fs, 5.0)
        t, f0_dio = tt.numpy(), f0d.numpy()
        f0_sm = np.stack([np.asarray(jsm.stonemask(
            jnp.asarray(x), fs, jnp.asarray(t), jnp.asarray(f),
            grid_step=gs)) for x, f in zip(xs, f0_dio)])
        _CACHE[fs] = (xs, t, f0_dio, f0_sm, gs)
    return _CACHE[fs]


@pytest.fixture
def captured(monkeypatch):
    """Every call of the four wrappers, with its arguments and result,
    while the port's modules run on the CPU."""
    calls = []

    def spy(mod, name):
        inner = getattr(mod, name)

        def f(*a, **kw):
            out = inner(*a, **kw)
            calls.append((name, a, kw, out))
            return out
        monkeypatch.setattr(mod, name, f)

    spy(sm, "if_readout")
    spy(ct, "lifter")
    for n in ("love_train_sums", "centroid_sum", "group_delay_ratio",
              "band_segments", "aperiodicity"):
        spy(d4c_mod, n)
    kernels.reset_counts()
    return calls


PLAIN = {"if_readout": sm.if_readout_plain, "lifter": ct.lifter_plain,
         "love_train_sums": d4c_mod.love_train_sums_plain,
         "centroid_sum": d4c_mod.centroid_sum_plain,
         "group_delay_ratio": d4c_mod.group_delay_ratio_plain,
         "band_segments": d4c_mod.band_segments_plain,
         "aperiodicity": d4c_mod.aperiodicity_plain}


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_stonemask_runs_the_twin_and_matches_jax(captured, fs):
    xs, t, f0_dio, f0_sm, gs = _case(fs)
    got = sm.stonemask(_t(xs), fs, _t(t), _t(f0_dio), grid_step=gs).numpy()
    assert [c[0] for c in captured] == ["if_readout"]
    _, a, kw, out = captured[0]
    assert _same(out, PLAIN["if_readout"](*a, **kw))
    assert sum(kernels.launches.values()) == 0
    np.testing.assert_array_equal(got > 0, f0_sm > 0)
    v = f0_sm > 0
    assert np.median(np.abs(got[v] - f0_sm[v]) / f0_sm[v]) <= 1e-4


@pytest.mark.parametrize("fs", [16000, 48000])
def test_cheaptrick_runs_the_twin_and_matches_jax(captured, fs):
    """Median |dlog sp| vs the JAX f32 path <= 0.03 (the module test's
    bound and reason)."""
    xs, t, _, f0, gs = _case(fs)
    N = jcfg.cheaptrick_fft_size(fs)
    got = ct.cheaptrick(_t(xs), fs, _t(t), _t(f0), N, grid_step=gs).numpy()
    assert [c[1][1] for c in captured] == [ct.LOG, ct.LIFTER, ct.EXP]
    for _, a, kw, out in captured:
        assert _same(out, PLAIN["lifter"](*a, **kw))
    want = np.stack([np.asarray(jct.cheaptrick(
        jnp.asarray(x), fs, jnp.asarray(t), jnp.asarray(f), N,
        grid_step=gs)) for x, f in zip(xs, f0)])
    assert np.isfinite(got).all() and (got > 0).all()
    assert np.median(np.abs(np.log(got) - np.log(want))) <= 0.03


@pytest.mark.parametrize("fs", [16000, 48000])
def test_d4c_runs_the_twins_and_matches_jax(captured, fs):
    """ap0 within 1e-5 and median |d ap| within 1e-3 (16 kHz) of the JAX
    f32 path, or the port's error against the JAX f64 path within 1.25x
    the JAX f32 path's (48 kHz), as tests/test_torch_modules.py holds."""
    xs, t, _, f0, gs = _case(fs)
    N = jcfg.cheaptrick_fft_size(fs)
    got, p0 = d4c_mod.d4c(_t(xs), fs, _t(t), _t(f0), N, 0.0, grid_step=gs)
    assert [c[0] for c in captured] == [
        "love_train_sums", "centroid_sum", "group_delay_ratio",
        "band_segments", "aperiodicity"]
    for name, a, kw, out in captured:
        assert _same(out, PLAIN[name](*a, **kw)), name
    jout = [jd4c.d4c(jnp.asarray(x), fs, jnp.asarray(tt), jnp.asarray(f),
                     N, 0.0, None, grid_step=gs)
            for x, tt, f in zip(xs, (t, t), f0)]
    want = np.stack([np.asarray(o[0]) for o in jout])
    np.testing.assert_allclose(p0.numpy(), np.stack(
        [np.asarray(o[1]) for o in jout]), atol=1e-5)
    got = got.numpy()
    assert ((got >= 0) & (got <= 1)).all()
    if fs == 16000:
        assert np.median(np.abs(got - want)) <= 1e-3
    else:
        ref = np.stack([np.asarray(jd4c.d4c(
            jnp.asarray(x, jnp.float64), fs, jnp.asarray(t, jnp.float64),
            jnp.asarray(f, jnp.float64), N, 0.0, None)[0])
            for x, f in zip(xs, f0)])
        assert np.median(np.abs(got - ref)) <= 1.25 * np.median(
            np.abs(want - ref))


# ---------------------------------------------------------------------------
# the kernels' arithmetic in numpy float32, in the CUDA sources' order
# ---------------------------------------------------------------------------


def _k24_numpy(smr, smi, sdr, sdi, f0s, h, gate, fs, b_max):
    out = np.zeros(len(f0s), F32)
    fsf = F32(fs)
    for i in range(len(f0s)):
        if gate[i]:
            continue
        e = int(2 * h[i] + 1).bit_length() - 1
        bc = 4 << e
        r = (b_max // 4) // (bc // 4)
        bcf = F32(bc)

        def fix(seed, nh):
            q = (seed * bcf) / fsf
            num = den = F32(0)
            for j, k in enumerate(sm.SUM_ORDER):
                kf = F32(k + 1)
                x = q * kf
                ic = int(np.trunc(x + F32(0.5) if x > 0 else x - F32(0.5)))
                ic = min(max(ic, 0), bc // 2)
                a, b, c, d = (v[i, ic * r] for v in (smr, smi, sdr, sdi))
                p = a * a + b * b
                n = a * d - b * c
                inst = F32(0) if p == 0 else \
                    (F32(ic) * fsf) / bcf + ((n / p) * fsf) / F32(2 * np.pi)
                m = F32(1) if k < nh else F32(0)
                tn, td = np.sqrt(p) * inst * m, np.sqrt(p) * kf * m
                num, den = (tn, td) if j == 0 else (num + tn, den + td)
            return num / (den + F32(1e-12))
        f0 = f0s[i]
        t1 = fix(f0, 2)
        ok1 = (t1 > 0) and (t1 <= f0 * F32(2))
        t2 = fix(t1, 6)
        mean = t2 if ok1 else F32(0)
        out[i] = f0 if np.abs(mean - f0) / f0 > F32(0.2) else mean
    return out


def test_k24_arithmetic_bit_equal_to_twin():
    """Random spectra, f0 over the whole range (gated ones too), bins
    with zero power: the numpy float32 K24 against the twin, both adding
    the six-term sums in SUM_ORDER."""
    fs, b_max = 48000, 4096
    rng = np.random.default_rng(24)
    R, H = 300, b_max // 2 + 1
    spec = [rng.standard_normal((R, H)).astype(F32) for _ in range(4)]
    spec[0][:, 64:80] = 0.0
    spec[1][:, 64:80] = 0.0
    f0 = rng.uniform(30.0, 4200.0, R).astype(F32)
    gate = (f0 <= 40.0) | (f0 > fs / 12.0)
    f0s = np.where(gate, F32(100.0), f0).astype(F32)
    h = np.minimum((1.5 * fs / f0s + 1.0).astype(np.int64),
                   (b_max // 2 - 1) // 2)
    want = _k24_numpy(*spec, f0s, h, gate, fs, b_max)
    got = sm.if_readout(*(torch.as_tensor(s) for s in spec),
                        torch.as_tensor(f0s), torch.as_tensor(h),
                        torch.as_tensor(gate), fs, b_max).numpy()
    # torch's float32 sqrt on the CPU is not always correctly rounded (a
    # few inputs here land 1 ulp off the IEEE square root that numpy and
    # CUDA's sqrtf give), so a few frames move by an ulp or so; K24 and its
    # twin on the card both take CUDA's sqrtf and are held bit for bit in
    # tests/test_torch_cuda.py
    assert (got == want).mean() >= 0.99
    np.testing.assert_array_max_ulp(got, want, maxulp=8)
    assert (got[gate] == 0).all() and (got[~gate] != 0).any()


def test_k25_arithmetic_matches_twin():
    """Per stage: the floor and log, the lifter from the frame's f0, the
    exp, in numpy float32 in the source's order; within 4 ulps (CUDA's and
    the CPU's sinf / cosf / logf / expf differ by a few)."""
    fs, N = 48000, 2048
    H = N // 2 + 1
    rng = np.random.default_rng(25)
    ps = (rng.standard_normal((6, H)) ** 2).astype(F32)
    ps[1] = 0.0
    ps[2, :100] = 1e-30
    cf0 = rng.uniform(71.0, 800.0, 6).astype(F32)
    tiny = F32(prims.tiny_floor(torch.float32))
    floor = np.maximum(ps.max(1, keepdims=True) * F32(1e-7), tiny)
    want = [np.log(np.maximum(ps, floor))]
    c = rng.standard_normal((6, H)).astype(F32)
    q = np.arange(H, dtype=F32) / F32(fs)
    qf = (F32(np.pi) * cf0)[:, None] * q
    with np.errstate(invalid="ignore", divide="ignore"):
        sl = np.where(np.arange(H) == 0, F32(1), np.sin(qf) / qf)
    cl = F32(1.0 - 2.0 * -0.15) + F32(2.0 * -0.15) * np.cos(
        (F32(2 * np.pi) * q) * cf0[:, None])
    want.append(((c * sl) * cl) / F32(N))
    want.append(np.exp(c))
    got = [ct.lifter(torch.as_tensor(ps), ct.LOG),
           ct.lifter(torch.as_tensor(c), ct.LIFTER, torch.as_tensor(cf0),
                     fs, N, -0.15),
           ct.lifter(torch.as_tensor(c), ct.EXP)]
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.dtype == np.float32
        np.testing.assert_array_max_ulp(g, w.astype(F32), maxulp=4)


def test_k26_stages_match_their_definitions():
    """LoveTrain: the twin's float32 cumsum within 1e-6 relative of the
    float64 band sums (the kernel's), process and cf0 from them; the
    centroid sum, the ratio's non-finite guard (0/0, x/0, an underflowed
    sps) and the band segments bit for bit in numpy float32."""
    rng = np.random.default_rng(26)
    R, H = 40, 2049
    p = (rng.standard_normal((R, H)) ** 2).astype(F32)
    f0 = rng.uniform(60.0, 500.0, R).astype(F32)
    f0[:3] = 0.0
    p[5, :700] = 0.0                       # no power up to 7.9 kHz
    b0, b1, b2 = 9, 342, 675
    ap0, process, cf0 = d4c_mod.love_train_sums(
        torch.as_tensor(p), torch.as_tensor(f0), b0, b1, b2, 0.0)
    s1 = p[:, b0 + 1:b1 + 1].astype(np.float64).sum(1)
    s2 = p[:, b0 + 1:b2 + 1].astype(np.float64).sum(1)
    ref = np.where(f0 == 0, 0.0, s1 / np.maximum(s2, float(
        prims.tiny_floor(torch.float32))))
    np.testing.assert_allclose(ap0.numpy(), ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(process.numpy(), (f0 != 0) & (ref > 0))
    np.testing.assert_array_equal(
        cf0.numpy(), np.where(process.numpy(), np.maximum(f0, F32(47)),
                              F32(100)))
    sp = [rng.standard_normal((R, H)).astype(F32) for _ in range(8)]
    want = (sp[2] * sp[0] + sp[1] * sp[3]) + (sp[6] * sp[4] + sp[5] * sp[7])
    np.testing.assert_array_equal(
        d4c_mod.centroid_sum(*map(torch.as_tensor, sp)).numpy(), want)
    sc, sps = sp[0].copy(), np.abs(sp[1])
    sc[0, :3], sps[0, :3] = 0.0, 0.0               # 0/0, then x/0
    sc[1, 0], sps[1, 0] = 1.0, 1e-45               # denormal: overflow
    sc[2, 0], sps[2, 0] = 1e-40, 1e-44             # denormal, finite
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        r = sc / sps
    want = np.where(np.isfinite(r), r, F32(0))
    got = d4c_mod.group_delay_ratio(torch.as_tensor(sc),
                                    torch.as_tensor(sps)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2, 0] != 0
    wl, starts, _ = d4c_mod.band_layout(48000, 4096, 5)
    w = prims.nuttall_window_np(wl).astype(F32)
    a, b = sp[2], sp[3]
    want = np.stack([(a - b)[:, s:s + wl] for s in starts], 1) * w
    got = d4c_mod.band_segments(torch.as_tensor(a), torch.as_tensor(b),
                                starts, torch.as_tensor(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k27_arithmetic_matches_twin():
    """The coarse dB (within 1e-5 dB: log10's ulps before the f0 term
    cancels), the interpolation's segment
    and lerp in the source's order, 10^(x/20) (powf within 4 ulps), the
    mask; top-k sums that leave nothing (num = 0) and empty bands too."""
    fs, N, n_ap = 48000, 2048, 5
    H = N // 2 + 1
    rng = np.random.default_rng(27)
    R = 30
    den = rng.uniform(0.5, 50.0, (R, n_ap)).astype(F32)
    topk = (den * rng.uniform(0.2, 1.0, (R, n_ap))).astype(F32)
    topk[0] = den[0]
    den[1] = 0.0
    topk[1] = 0.0
    cf0 = rng.uniform(47.0, 600.0, R).astype(F32)
    process = rng.random(R) > 0.2
    ap, coarse = d4c_mod.aperiodicity(*map(torch.as_tensor, (
        den, topk, cf0, process)), fs, N)
    tiny = F32(prims.tiny_floor(torch.float32))
    ca = F32(10) * np.log10(np.maximum(den - topk, tiny)
                            / np.maximum(den, tiny))
    c = np.minimum(ca + ((cf0 - F32(100)) / F32(50))[:, None], F32(0))
    np.testing.assert_allclose(coarse.numpy(), c, rtol=1e-6, atol=1e-5)
    axis = np.concatenate([np.arange(n_ap + 1, dtype=F32) * F32(3000),
                           [F32(fs / 2)]]).astype(F32)
    c = coarse.numpy()
    vals = np.concatenate([np.full((R, 1), -60, F32), c,
                           np.full((R, 1), F32(-1e-12))], 1)
    xi = (np.arange(H, dtype=F32) * F32(fs)) / F32(N)
    k = np.clip((axis[None, :] <= xi[:, None]).sum(1), 1, n_ap + 1)
    s = (xi - axis[k - 1]) / (axis[k] - axis[k - 1])
    v = vals[:, k - 1] + s * (vals[:, k] - vals[:, k - 1])
    want = np.where(process[:, None], np.power(F32(10), v / F32(20)),
                    F32(1.0 - 1e-12))
    np.testing.assert_array_max_ulp(ap.numpy(), want.astype(F32), maxulp=4)
    assert (ap.numpy()[~process] == 1.0).all()


def test_wrappers_keep_cpu_tensors_on_the_twin():
    """No kernel is launched or recorded for CPU tensors."""
    kernels.reset_counts()
    x = torch.rand(4, 1025)
    ct.lifter(x, ct.LOG)
    d4c_mod.group_delay_ratio(x, x + 1)
    assert sum(kernels.launches.values()) == 0 and kernels.record is None
    assert cfg.d4c_love_train_fft_size(8000) == 1024     # b2 clipped there


def test_d4c_at_8k_has_no_bands_and_matches_jax():
    """At fs <= 12 kHz D4C has no coarse band (d4c.cpp:212-215): the
    aperiodicity interpolates between the -60 dB and the
    -kMySafeGuardMinimum ends alone, as the JAX package's does, and
    LoveTrain's band edges past the 1024-point spectrum take its last bin
    (JAX clamps the index)."""
    fs = 8000
    x = (np.sin(2 * np.pi * 200 * np.arange(4000) / fs)
         + 0.01 * np.random.default_rng(0).standard_normal(4000)
         ).astype(np.float32)
    tt, f0d, _, _ = dio_mod.dio(torch.as_tensor(x)[None], fs, 5.0)
    t, f0 = tt.numpy(), f0d[0].numpy()
    got, p0 = d4c_mod.d4c(_t(x)[None], fs, _t(t), _t(f0)[None], 1024, 0.0,
                          grid_step=40)
    want, jp0 = jd4c.d4c(jnp.asarray(x), fs, jnp.asarray(t, jnp.float32),
                         jnp.asarray(f0, jnp.float32), 1024, 0.0, None,
                         grid_step=40)
    assert cfg.number_of_aperiodicities(fs) == 0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(p0[0].numpy(), np.asarray(jp0), atol=1e-6)
