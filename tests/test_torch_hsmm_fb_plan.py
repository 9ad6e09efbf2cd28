"""K18's cluster schedule and K37's frame data flow, emulated in numpy on
the CPU.

K18 (`csrc/hsmm_fb.cu`) runs each utterance's forward and backward on a
cluster of C CTAs that split t in [0, t_len] into slices of at least
max_dur frames and read a halo of max_dur frames from one neighbour's
double-buffered rows a state, then the posteriors a block per
(utterance, state).  `cluster_fb` does the same in float64 numpy, CTA by
CTA: split it is bit for bit the unsplit schedule (C = 1), and it holds
`hsmm.segment_fb_plain`'s bounds.

K37 (`csrc/mglsa_filter.cu`) filters each frame on K39's FFT passes: the
segment into registers (the sparse plan where `fftmat.r2c_plan` takes
it), the split, the product with H and the inverse split in place, the
dense passes on the conjugate, the W taps with the negative times
wrapped.  `mglsa_emulate` does the same with K39's tables and holds
`excitation.mglsa_synthesis_plain` to 1e-12 of max |y|.

The kernels run only on the card; `tests/test_torch_cuda.py` holds them
to their twins there.
"""
import numpy as np
import pytest
import torch

from hts_train_world_tpu_torch.models import hsmm
from hts_train_world_tpu_torch.ops import excitation as ex
from hts_train_world_tpu_torch.ops import fftmat

NEG = hsmm.LOG_ZERO
LOG_2PI = 1.8378770664093453
THREADS = 512


def slice_of(r, C, n, Dm):
    """CTA r's frames [lo, hi) of n = t_len + 1 and the nominal slice."""
    ca = max(1, min(C, n // Dm))
    sl = -(-n // ca)
    lo = min(n, r * sl)
    return lo, min(n, lo + sl), sl


def row_words(T, C, Dm):
    """A CTA's row buffer: the longest slice and its halo."""
    return max(-(-(T + 1) // C), 2 * Dm) + Dm


def _dur(dm, dv, Dm, temper):
    x = np.arange(1, Dm + 1, dtype=np.float64) - dm
    return -0.5 * ((x * x) / dv + np.log(dv) + LOG_2PI) * temper


def _forward_slice(fp, cs, dl, tes, Dm):
    """F after the state at destinations `tes` (fp, cs index frames)."""
    m = np.full(len(tes), NEG)
    cand = []
    for d in range(Dm, 0, -1):
        ok = d <= tes
        t0 = np.where(ok, tes - d, 0)
        c = fp(t0) + (dl[d - 1] + (cs(tes) - cs(t0)))
        m = np.where(ok, np.fmax(m, c), m)
        cand.append((ok, c))
    acc = np.zeros(len(tes))
    for ok, c in cand:
        acc = np.where(ok, acc + np.exp(np.where(ok, c - m, 0.0)), acc)
    return np.where(acc > 0.0, np.log(np.fmax(acc, 1e-300)) + m, NEG)


def _backward_slice(bn, cs, dl, t0s, Dm, t_len):
    terms = []
    for d in range(1, Dm + 1):
        te = t0s + d
        ok = te <= t_len
        tc = np.where(ok, te, t0s)
        terms.append(np.where(ok, (dl[d - 1] + (cs(tc) - cs(t0s))) + bn(tc),
                              NEG))
    m = np.full(len(t0s), -np.inf)
    for c in terms:
        m = np.fmax(m, c)
    acc = np.zeros(len(t0s))
    for c in terms:
        acc = acc + np.exp(c - m)
    return np.log(acc) + m


def _block_sum(parts):
    """block_sum3's tree over 512 threads' partial sums: xor shuffles in
    each warp, then the warps' sums through warp 0."""
    def warp(v):
        v = v.copy()
        for o in (16, 8, 4, 2, 1):
            v = v + v[np.arange(32) ^ o]
        return v
    lanes = np.stack([warp(w) for w in parts.reshape(-1, 32)])
    first = np.zeros(32)
    first[:len(lanes)] = lanes[:, 0]
    return warp(first)[0]


def cluster_fb(obs, dm, dv, Dm, temper, t_len, k_len, C):
    """One utterance through K18's three stages with C CTAs a chain:
    (ll, gamma (T, K), dstats (K, 3)).  Each CTA keeps its own buffers
    (two row buffers of `row_words` frames; the halo copied in from the
    neighbour's buffer of the state); F[s] / B[s+1] rows as the device
    scratch holds them."""
    T, K = obs.shape
    n = t_len + 1
    cs = np.zeros((K, T + 1))
    c = np.zeros(K)
    for t in range(T):
        c = c + obs[t] * temper
        cs[:, t + 1] = c
    W = row_words(T, C, Dm)
    sl = [slice_of(r, C, n, Dm) for r in range(C)]
    assert all(hi - lo >= Dm for lo, hi, _ in sl[:-1] if hi < n)
    rows = {}
    for fwd in (True, False):
        R = np.full((K + 1, T + 1), np.nan)
        base = [(lo - Dm) if fwd else lo for lo, _, _ in sl]
        buf = [[np.full(W, np.nan), np.full(W, np.nan)] for _ in range(C)]
        start = 0 if fwd else k_len
        for r, (lo, hi, _) in enumerate(sl):
            t = np.arange(lo, hi)
            v = np.where(t == (0 if fwd else t_len), 0.0, NEG)
            R[start, lo:hi] = v
            buf[r][0][t - base[r]] = v
        for i in range(k_len):
            p, s = i & 1, (i if fwd else k_len - 1 - i)
            dl = _dur(dm[s], dv[s], Dm, temper)
            # the halo from one neighbour only, read from its own frames
            for r, (lo, hi, _) in enumerate(sl):
                if lo >= hi:
                    continue
                if fwd and r > 0:
                    ts = np.arange(max(0, lo - Dm), lo)
                    nlo, nhi, _ = sl[r - 1]
                    assert nlo <= ts.min() and ts.max() < nhi
                    buf[r][p][ts - base[r]] = buf[r - 1][p][ts - base[r - 1]]
                elif not fwd and hi < n:
                    ts = np.arange(hi, min(n, hi + Dm))
                    nlo, nhi, _ = sl[r + 1]
                    assert nlo <= ts.min() and ts.max() < nhi
                    buf[r][p][ts - base[r]] = buf[r + 1][p][ts - base[r + 1]]
            for r, (lo, hi, _) in enumerate(sl):
                if lo >= hi:
                    continue
                b0 = base[r]
                own = buf[r][p]
                lo_b = max(0, lo - Dm) if fwd else lo
                hi_b = hi if fwd else min(n, hi + Dm)

                def rp(t):
                    assert ((t >= lo_b) & (t < hi_b)).all()
                    return own[t - b0]

                def csr(t, s=s):
                    assert ((t >= lo_b) & (t < hi_b)).all()
                    return cs[s, t]
                ts = np.arange(lo, hi)
                v = (_forward_slice(rp, csr, dl, ts, Dm) if fwd else
                     _backward_slice(rp, csr, dl, ts, Dm, t_len))
                buf[r][p ^ 1][ts - b0] = v
                R[(i + 1) if fwd else s, lo:hi] = v
        rows[fwd] = R
    Fr, Br = rows[True], rows[False]
    logZ = Br[0, 0]
    gamma = np.zeros((T, K))
    dst = np.zeros((K, 3))
    for s in range(k_len):
        ra, rb, c_s = Fr[s], Br[s + 1], cs[s]
        dl = _dur(dm[s], dv[s], Dm, temper)
        diff = np.zeros(T + 1)
        part = np.zeros((3, THREADS))
        for tid in range(THREADS):
            for t in range(tid, T + 1, THREADS):
                starts = ends = 0.0
                for d in range(1, Dm + 1):
                    te = t + d
                    if te > t_len:
                        break
                    xi = ((ra[t] + (dl[d - 1] + (c_s[te] - c_s[t])))
                          + rb[te]) - logZ
                    pr = np.exp(min(xi, 0.0))
                    starts += pr
                    part[:, tid] += (pr, pr * d, pr * (d * d))
                if t <= t_len:
                    for d in range(min(Dm, t), 0, -1):
                        t0 = t - d
                        xi = ((ra[t0] + (dl[d - 1] + (c_s[t] - c_s[t0])))
                              + rb[t]) - logZ
                        ends += np.exp(min(xi, 0.0))
                diff[t] = starts - ends
        dst[s] = [_block_sum(part[j]) for j in range(3)]
        acc = 0.0
        for t in range(T):
            acc = acc + diff[t]
            gamma[t, s] = acc
    return logZ, gamma, dst


def _inputs(seed, B, T, S, t_len, k_len, scale=2.0):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, T, S)) * scale
    dm = rng.uniform(3, 9, (B, S))
    dv = rng.uniform(1, 5, (B, S))
    return obs, dm, dv, np.asarray(t_len), np.asarray(k_len)


def _t(a, dt=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dt)


# (name, inputs, max_dur, temper, cluster sizes)
CASES = [
    ("short_row", _inputs(1, 1, 30, 5, [30], [5]), 20, 1.0, (1, 2, 8)),
    ("t_len_below_T", _inputs(2, 2, 90, 6, [90, 61], [6, 6]), 12, 1.0,
     (1, 3, 7, 16)),
    ("k_len_below_K", _inputs(3, 2, 80, 8, [80, 75], [8, 5]), 15, 1.0,
     (1, 2, 5)),
    ("daem_temper", _inputs(4, 2, 70, 6, [70, 48], [6, 4]), 10, 0.3,
     (1, 4, 7)),
    ("max_dur_one", _inputs(5, 1, 20, 3, [20], [3]), 1, 1.0, (1, 16)),
]


@pytest.mark.parametrize("name,inp,Dm,temper,Cs", CASES,
                         ids=[c[0] for c in CASES])
def test_cluster_schedule_is_the_unsplit_one_and_the_twins(name, inp, Dm,
                                                           temper, Cs):
    """Every cluster size gives the unsplit schedule's ll, gamma and
    dstats bit for bit, and those hold the card tests' bounds of the
    plain twin (ll 1e-9 rel, gamma 1e-10, dstats 1e-9 rel)."""
    obs, dm, dv, t_len, k_len = inp
    ll0, g0, d0 = hsmm.segment_fb_plain(_t(obs), _t(dm), _t(dv), Dm, temper,
                                        _t(t_len, torch.long),
                                        _t(k_len, torch.long))
    for b in range(len(obs)):
        ref = cluster_fb(obs[b], dm[b], dv[b], Dm, temper, int(t_len[b]),
                         int(k_len[b]), 1)
        for C in Cs:
            got = cluster_fb(obs[b], dm[b], dv[b], Dm, temper,
                             int(t_len[b]), int(k_len[b]), C)
            assert got[0] == ref[0]
            assert np.array_equal(got[1], ref[1])
            assert np.array_equal(got[2], ref[2])
        ll, g, d = ref
        assert abs(ll - float(ll0[b])) <= 1e-9 * abs(float(ll0[b]))
        assert np.abs(g - g0[b].numpy()).max() <= 1e-10
        dp = d0[b].numpy()
        assert np.all(np.abs(d - dp) <= 1e-9 * np.abs(dp))


def test_cluster_schedule_infeasible_chain():
    """A chain longer than its frames: LOG_ZERO-scale evidence in the
    schedule and the twin alike, at every cluster size."""
    obs, dm, dv = np.zeros((5, 8)), np.full(8, 3.0), np.ones(8)
    ll0 = hsmm.segment_fb_plain(_t(obs[None]), _t(dm[None]), _t(dv[None]),
                                10, 1.0, _t([5], torch.long),
                                _t([8], torch.long))[0]
    for C in (1, 2):
        ll = cluster_fb(obs, dm, dv, 10, 1.0, 5, 8, C)[0]
        assert ll <= hsmm.LOG_ZERO / 2 and float(ll0[0]) <= hsmm.LOG_ZERO / 2


@pytest.mark.parametrize("T,Dm", [(1296, 60), (9000, 60), (100, 60),
                                  (59, 60), (9000, 1), (200, 7)])
def test_slices_cover_the_row_with_one_neighbour_halos(T, Dm):
    """For every t_len <= T (a stride of them) and C up to 16: the active
    slices tile [0, t_len] in order, each but the last at least max_dur
    long (so a halo lies in one neighbour), at most (t_len+1)/max_dur of
    them (one for rows shorter than 2 max_dur), inside the row buffer."""
    for C in (1, 2, 8, 16):
        for t_len in range(1, T + 1, max(1, T // 97)):
            n = t_len + 1
            sl = [slice_of(r, C, n, Dm) for r in range(C)]
            live = [(lo, hi) for lo, hi, _ in sl if lo < hi]
            assert live[0][0] == 0 and live[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(live, live[1:]))
            assert len(live) <= max(1, n // Dm)
            assert all(hi - lo >= Dm for lo, hi in live[:-1])
            assert max(hi - lo for lo, hi in live) + Dm <= row_words(T, C, Dm)


# ---- K37 ----


def _passes(d, N, sparse, tab):
    """K39's passes on d (rows, M) complex, natural order out."""
    M = N // 2
    _, plan = fftmat.r2c_plan(N, N // 4 if sparse else N)
    w = tab[:, 0] + 1j * tab[:, 1]
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


def mglsa_emulate(exc, mgc, alpha, shift, N):
    """K37's two launchers in numpy: H = exp(mgc G), each frame's segment
    through the forward passes (sparse where the plan takes it), the
    split, x H and the inverse split in place, the dense passes on the
    conjugate, the W taps [-K, L+K) from y = conj / N, then the
    overlap-add gather in frame order."""
    T, M1 = mgc.shape
    n = len(exc)
    M = N // 2
    L = K = 2 * shift
    W = L + 2 * K
    H = np.exp(mgc @ ex.mglsa_table(M1 - 1, alpha, N))
    win = np.hanning(L + 1)[:L]
    sparse, _ = fftmat.r2c_plan(N, L)
    tab_f = fftmat.r2c_table_np(N, sparse)
    tab_i = fftmat.r2c_table_np(N, False)
    p = np.arange(T)[:, None] * shift - shift + np.arange(L)[None]
    x = np.where((p >= 0) & (p < n), exc[p.clip(0, n - 1)], 0.0) * win
    Lz = L // 2
    z = np.zeros((T, M), complex)
    z[:, :Lz] = x[:, 0::2] + 1j * x[:, 1::2]
    if sparse:
        i = np.arange(M)
        j1 = i >> 3
        live = j1 + M // 8 < Lz
        z = z[:, j1] + np.where(live, z[:, np.minimum(j1 + M // 8, M - 1)]
                                * fftmat._w(i & 7, 8), 0.0)
    Z = _passes(z, N, sparse, tab_f)
    w = tab_f[:, 0] + 1j * tab_f[:, 1]
    k = np.arange(M // 2 + 1)
    A, B = Z[:, k], Z[:, (M - k) & (M - 1)]
    E = ((A.real + B.real) * 0.5) + 1j * ((A.imag - B.imag) * 0.5)
    O = ((A.imag + B.imag) * 0.5) - 1j * ((A.real - B.real) * 0.5)
    P = O * w[k]
    Y0 = (E + P) * H[:, k]                    # Y_k
    Y1 = np.conj(E - P) * H[:, M - k]         # Y_(M-k)

    def inv(u, c, f):
        return (u + np.conj(c)) + 1j * f * (u - np.conj(c))
    Zi = np.empty((T, M), complex)
    Zi[:, k] = inv(Y0, Y1, np.conj(w[k]))
    kk = k[(k > 0) & (2 * k < M)]
    Zi[:, M - kk] = inv(Y1[:, kk], Y0[:, kk], -w[kk])
    wv = _passes(np.conj(Zi), N, False, tab_i)
    y = np.empty((T, N))
    y[:, 0::2] = wv.real / N
    y[:, 1::2] = -wv.imag / N
    u = np.arange(W)
    taps = y[:, np.where(u < K, N - K + u, u - K)]
    out = np.zeros(n)
    for q in range(n):
        pp = q + W // 2
        t_hi = min(pp // shift, T - 1)
        lo = pp - W + 1
        t_lo = 0 if lo <= 0 else -(-lo // shift)
        acc = 0.0
        for t in range(t_lo, t_hi + 1):
            acc = acc + taps[t, pp - t * shift]
        out[q] = acc
    return out, sparse


@pytest.mark.parametrize("fs,N,sparse", [(16000, 512, False),
                                         (16000, 1024, True),
                                         (48000, 2048, True),
                                         (96000, 4096, True)])
def test_mglsa_frame_flow_matches_the_twin(fs, N, sparse):
    """The plan K37's wrapper picks (dense at N 512: L = 160 > N/4), and
    the emulated frames against `mglsa_synthesis_plain` within 1e-12 of
    max |y|, at the card test's shapes."""
    rng = np.random.default_rng(37)
    shift, T, M = fs // 200, 40, 50
    mgc = rng.standard_normal((T, M)) * 0.1 / (1.0 + np.arange(M))
    mgc[:, 0] += 0.5
    exc = rng.standard_normal((T - 1) * shift)
    got, sp = mglsa_emulate(exc, mgc, 0.42, shift, N)
    assert sp == sparse
    want = ex.mglsa_synthesis_plain(_t(exc), _t(mgc), 0.42, shift, N).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
