"""L0 math primitives of the fast path, batched over leading axes.

Counterpart of `hts_train_world_tpu/ops/prims.py` (main-path subset, f32
fast branches).  Three kernels live here, each with its plain PyTorch twin:

- K2 `smooth_spectrum`: `dc_correction` and/or `linear_smoothing` of
  spectral rows (csrc/spectral_smooth.cu);
- K3 `top_k_threshold_sum`: the exact sum of the k largest entries of
  non-negative f32 rows (csrc/topk_sum.cu);
- K13 `decimate`: Harvest's forward-backward order-3 IIR decimation
  (csrc/harvest_decimate.cu), whose twin runs the recurrence as a float64
  block formulation (`iir_first_state`, shared with the Butterworth
  smoothing of ops/harvest_fix.py).

A wrapper launches its kernel for CUDA tensors and runs the plain twin
only for CPU tensors.

Division by a Python scalar goes through `exact_div`: PyTorch's CUDA
division by a host scalar multiplies by its reciprocal (1 ulp off a true
division), which would let the card's plain twins drift from the kernels
and the CPU path on decisions that hang on the last ulp.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hts_train_world_tpu_torch import kernels

# ---------------------------------------------------------------------------
# rounding / arithmetic helpers
# ---------------------------------------------------------------------------


def tiny_floor(dtype) -> float:
    """Positivity floor for log/divide guards (8x the smallest normal)."""
    return torch.finfo(dtype).tiny * 8.0


def exact_div(x, divisor: float):
    """IEEE division of a tensor by a scalar on every device."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def fma(a, b, c):
    """a * b + c rounded once, in float64 tensors without a fused
    instruction: Dekker's exact product (Veltkamp's split) and Knuth's
    exact sum, then one rounding of the three parts.  That is CUDA's
    `fma` and what XLA's CPU compiler makes of `x * y + z`; this form
    rounds the same but for inputs within ~2^-50 of a rounding boundary
    (none in 2e5 random draws against an exact rational result)."""
    p = a * b

    def split(x):
        t = x * 134217729.0                 # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl    # a b = p + e
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)                        # p + c = s + t
    return s + (t + e)


def _f64(bits: int) -> float:
    return float(np.array(bits, np.uint64).view(np.float64))


# XLA's CPU exp for float64: a Pade form on the reduced argument
_EXP_LO, _EXP_HI = _f64(0xC086232BDD7ABCD2), _f64(0x40862E42FEFA39EF)
_LOG2E = _f64(0x3FF71547652B82FE)
_LN2_HI, _LN2_LO = _f64(0x3FE62E4000000000), _f64(0x3EB7F7D1CF79ABCA)
_EXP_P = (_f64(0x3F2089CDD5E44BE8), _f64(0x3F9F06D10CCA2C7E))
_EXP_Q = (_f64(0x3EC92EB6BC365FA0), _f64(0x3F64AE39B508B6C0),
          _f64(0x3FCD17099887E074))


def xla_exp(x):
    """exp of a float64 tensor as XLA's CPU compiler emits it for the JAX
    package's `jnp.exp` (within 1.5 ulps; torch.exp and numpy round
    otherwise in about one case in six): n = floor(x log2 e + 1/2), g = x -
    n ln2 in two parts, e^g = 1 + 2 p / (q - p), scaled by 2^n in four
    exact factors, with the fused multiply-adds XLA contracts (`fma`).
    Basic operations only, so the card gives the same bits."""
    xc = x.clamp(_EXP_LO, _EXP_HI)

    def c(v):
        return torch.full_like(x, v)
    n = torch.floor(fma(xc, c(_LOG2E), c(0.5)))
    g = fma(-n, c(_LN2_LO), fma(-n, c(_LN2_HI), xc))
    gg = g * g
    p = fma(fma(gg, c(_EXP_P[0]), c(_EXP_P[1])), gg, c(1.0)) * g
    q = fma(fma(fma(gg, c(_EXP_Q[0]), c(_EXP_Q[1])), gg, c(_EXP_Q[2])),
            gg, c(2.0))
    e = (p / (q - p)) * 2.0 + 1.0
    ni = n.clamp(-2099, 2099)
    b = torch.floor(ni / 4.0)
    one = torch.ones_like(x)
    s = torch.ldexp(one, b)
    y = e * s * s * s * torch.ldexp(one, ni - 3.0 * b)
    y = torch.where(x < _EXP_LO, torch.zeros_like(y), y)
    return torch.where(x > _EXP_HI, torch.full_like(y, float("inf")), y)


def ieee_sqrt(x):
    """sqrt rounded once, on every device: the card's and numpy's are;
    torch's on the CPU (SLEEF) is an ulp off in about one float64 case in
    150 and one float32 case in 300."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.numpy()))


def rdiv(numerator: float, x):
    """IEEE division of a scalar by a tensor (`numerator / x` in PyTorch
    multiplies by the reciprocal)."""
    return torch.full_like(x, numerator) / x


def matlab_round(x):
    """matlabfunctions.cpp:212-214: round half away from zero via trunc
    (not torch.round, which rounds half to even)."""
    return torch.trunc(torch.where(x > 0, x + 0.5, x - 0.5))


def matlab_round_i(x):
    return matlab_round(x).long()


def compact_indices(mask, cap: int, fill_value: int):
    """Positions of True entries along the last axis in ascending order,
    padded to `cap` with fill_value (jnp.nonzero(size=cap) per row).
    A rank cumsum + scatter: no host sync."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask, dim=-1) - 1
    slot = torch.where(mask & (rank < cap), rank, cap)  # slot cap: discarded
    idx = torch.arange(n, device=mask.device).expand(mask.shape)
    out = torch.full(mask.shape[:-1] + (cap + 1,), fill_value,
                     dtype=torch.long, device=mask.device)
    out.scatter_(-1, slot, idx)
    return out[..., :cap]


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------


def interp1(x, y, xi):
    """MATLAB-style linear interpolation with end extrapolation
    (matlabfunctions.cpp:157-182) for ascending 1-D `x` and `xi` and
    rows `y` (..., len(x))."""
    n = x.shape[-1]
    k = torch.searchsorted(x, xi, right=True).clamp(1, n - 1)
    x0, x1 = x[k - 1], x[k]
    y0, y1 = y[..., k - 1], y[..., k]
    s = (xi - x0) / (x1 - x0)
    return y0 + s * (y1 - y0)


def interp1_rows(x, y, n_valid, xi):
    """interp1 of rows (x, y) (..., n), each ascending on its valid
    prefix n_valid (...), at the ascending points xi (T,) -> (..., T):
    segment k = clip(#(x <= xi), 1, max(n_valid-1, 1)), y0 + s*(y1 - y0)
    (matlabfunctions.cpp:157-182, a binary search per point)."""
    nn = n_valid.long()[..., None]
    valid = torch.arange(x.shape[-1], device=x.device) < nn
    xm = torch.where(valid, x, torch.full_like(x, float("inf")))
    k = torch.searchsorted(xm.contiguous(),
                           xi.expand(x.shape[:-1] + xi.shape).contiguous(),
                           right=True)
    k = torch.minimum(k.clamp(min=1), (nn - 1).clamp(min=1))
    x0, x1 = torch.gather(x, -1, k - 1), torch.gather(x, -1, k)
    y0, y1 = torch.gather(y, -1, k - 1), torch.gather(y, -1, k)
    return y0 + (xi - x0) / (x1 - x0) * (y1 - y0)


def interp1_regular_grid(x, y, T: int, fp: float, n_valid):
    """Rows of interp1(x, y, arange(T)*fp) for ascending x (R, n) with
    valid prefix n_valid (R,): per-segment slope and local anchor as
    cumulative sums of deltas scattered at each x's first covered query
    (the JAX fast-path formulation)."""
    dtype, dev = x.dtype, x.device
    R, n = x.shape
    kmax = torch.clamp(n_valid - 1, min=1)[:, None]
    valid = torch.arange(n, device=dev)[None, :] < n_valid[:, None]
    fpv = torch.full((), fp, dtype=dtype, device=dev)

    q0 = torch.floor(x / fpv)
    q0 = torch.nan_to_num(q0, nan=0.0, posinf=T, neginf=0.0)
    q0 = q0.clamp(0, T).long()
    qlo = torch.where(x <= q0.to(dtype) * fpv, q0, q0 + 1)
    qlo = torch.where(x <= 0.0, 0, qlo)
    qlo = torch.where(valid, qlo, T + 1)

    zero = torch.zeros((), dtype=dtype, device=dev)
    m = (y[:, 1:] - y[:, :-1]) / (x[:, 1:] - x[:, :-1])
    seg_ok = torch.arange(1, n, device=dev)[None, :] <= kmax
    m = torch.where(seg_ok, m, zero)
    ok_t = seg_ok[:, 1:]
    dm = torch.where(ok_t, m[:, 1:] - m[:, :-1], zero)
    dxa = torch.where(ok_t, x[:, 1:-1] - x[:, :-2], zero)
    dya = torch.where(ok_t, y[:, 1:-1] - y[:, :-2], zero)
    pos = qlo[:, 1:-1]

    def scan(delta):  # positions >= T are dropped
        buf = torch.zeros((R, T + 2), dtype=dtype, device=dev)
        buf.scatter_add_(1, pos, delta)
        return torch.cumsum(buf[:, :T], dim=1)

    Mq = m[:, :1] + scan(dm)
    X0 = x[:, :1] + scan(dxa)
    Y0 = y[:, :1] + scan(dya)
    t = torch.arange(T, dtype=dtype, device=dev) * fpv
    return Y0 + Mq * (t - X0)


# ---------------------------------------------------------------------------
# windows / misc
# ---------------------------------------------------------------------------


def fftshift(x):
    """matlabfunctions.cpp:129-134 (even length, last axis)."""
    h = x.shape[-1] // 2
    return torch.cat([x[..., h:], x[..., :h]], dim=-1)


@functools.lru_cache(maxsize=None)
def _cepstrum_fold(fft_size: int, dtype, device):
    """1 at the DC and Nyquist quefrencies, 2 between (the fold of the
    conjugate-symmetric cepstrum onto its causal half)."""
    half = fft_size // 2
    w = torch.full((half + 1,), 2.0, dtype=dtype, device=device)
    w[0] = w[half] = 1.0
    return w


def minimum_phase_log(log_half, fft_size: int):
    """common.cpp:182-220 up to the exponential, by `torch.fft` as the JAX
    package's parity path takes `jnp.fft` (prims.py:512-532): the log half
    spectrum (..., N/2+1) mirrored, forward-rfft'd and conjugated, the
    interior cepstrum bins doubled, the anticausal half zeroed (the c2c
    forward's zero padding to N), c2c forward -> (Re, Im) of D / N, the
    log of the min-phase spectrum (exp(D / N) is the spectrum; K30 takes
    the exponential)."""
    n = fft_size
    half = n // 2
    ls = torch.cat([log_half, log_half[..., 1:half].flip(-1)], dim=-1)
    C = torch.conj(torch.fft.rfft(ls, dim=-1))
    D = torch.fft.fft(C * _cepstrum_fold(n, log_half.dtype, log_half.device),
                      n=n, dim=-1)[..., :half + 1]
    return exact_div(D.real, n), exact_div(D.imag, n)


def nuttall_window_np(n: int) -> np.ndarray:
    """common.cpp:113-121, built in float64 numpy."""
    t = np.arange(n, dtype=np.float64) / (n - 1.0)
    return (0.355768 - 0.487396 * np.cos(2 * np.pi * t)
            + 0.144232 * np.cos(4 * np.pi * t)
            - 0.012604 * np.cos(6 * np.pi * t))


# ---------------------------------------------------------------------------
# K2: DC correction + linear smoothing of spectral rows
# ---------------------------------------------------------------------------


def _dc_correction_plain(ps, f0, fs: int, fft_size: int, ul_max: int):
    """common.cpp:56-75, f32 fast form: the taps f0*N/fs - i descend one
    bin per tap with a constant fraction, so the replica is a reversed
    run of the row itself.  ps (R, N/2+1), f0 (R,)."""
    c = exact_div(f0 * fft_size, fs)
    tc = torch.trunc(c)
    ic = tc.long()[:, None]
    frac = (c - tc)[:, None]
    i = torch.arange(ul_max, device=ps.device)[None, :]
    y0 = torch.gather(ps, 1, (ic - i).clamp(min=0))
    y1 = torch.gather(ps, 1, (ic + 1 - i).clamp(min=0))
    replica = y0 + (y1 - y0) * frac
    add = torch.where(i <= ic, replica, torch.zeros((), dtype=ps.dtype,
                                                    device=ps.device))
    return torch.cat([ps[:, :ul_max] + add, ps[:, ul_max:]], dim=1)


def _linear_smoothing_plain(ps, width, fs: int, fft_size: int, b_max: int,
                            acc=torch.float64):
    """common.cpp:77-111, fast form: the mirror uses the static b_max
    extent (the per-frame offset cancels in the cumsum difference) and the
    two interp1Q reads become shifted lerps of the cumsum.  The cumsum,
    the reads and their difference run in `acc`: float64 (the kernel's),
    or float32 for the JAX package's f32 branch, whose difference of two
    f32 prefix sums loses the bins far below the row's peak.  The read
    positions stay in ps's dtype; the result is cast back to it."""
    half = fft_size // 2
    P = half + 2 * b_max + 1
    mirror = torch.cat([torch.flip(ps[:, 1:b_max + 1], [1]), ps,
                        torch.flip(ps[:, half - b_max:half], [1])], dim=1)
    seg = torch.cumsum(mirror * (fs / fft_size), dim=1, dtype=acc)
    wb = exact_div(exact_div(width * fft_size, fs), 2.0)
    j = torch.arange(half + 2, device=ps.device)[None, :]

    def q(s):
        ts = torch.trunc(s)
        frac = (s - ts)[:, None]
        win = torch.gather(seg, 1, ts.long().clamp(0, P - half - 2)[:, None]
                           + j)
        return win[:, :-1] + frac * (win[:, 1:] - win[:, :-1])

    return ((q((b_max - 0.5) + wb) - q((b_max - 0.5) - wb))
            / width[:, None]).to(ps.dtype)


# XLA's CPU compiler rewrites a cumulative reduce-window (jnp.cumsum) as a
# blocked scan: sequential prefixes within blocks of this many elements,
# the block totals scanned the same way, then added back.
XLA_SCAN_BLOCK = 16


def xla_cumsum(x):
    """The cumulative sum along the last axis in the order of the JAX
    package's jnp.cumsum on the CPU (XLA's blocked scan, XLA_SCAN_BLOCK):
    equal to it bit for bit where the additions within a block run in
    sequence, as torch.cumsum's do on the CPU."""
    n = x.shape[-1]
    B = XLA_SCAN_BLOCK
    if n <= B:
        return torch.cumsum(x, dim=-1)
    m = -(-n // B) * B
    local = torch.cumsum(torch.nn.functional.pad(x, (0, m - n)).reshape(
        x.shape[:-1] + (m // B, B)), dim=-1)
    pref = xla_cumsum(local[..., -1])
    excl = torch.cat([torch.zeros_like(pref[..., :1]), pref[..., :-1]],
                     dim=-1)
    return (local + excl[..., None]).reshape(x.shape[:-1] + (m,))[..., :n]


def _dc_correction_parity_plain(ps, f0, fs: int, fft_size: int,
                                ul_max: int):
    """common.cpp:56-75 in the reference's order (the JAX package's
    generic branch, prims.py:437-446): tap i reads the row at f0*N/fs - i
    by interp1Q, with the last tap's step zeroed and no tap at or past
    upper_limit - 1.  ps (R, N/2+1) float64, f0 (R,).  /fs is a product
    with 1/fs and the lerp a fused multiply-add, as XLA compiles the JAX
    package's f64 branch."""
    half = fft_size // 2
    zero = torch.zeros((), dtype=ps.dtype, device=ps.device)
    c = ((f0 * fft_size) * (1.0 / fs))[:, None]
    upper = 2 + torch.trunc(c).long()
    i = torch.arange(ul_max, device=ps.device)[None, :]
    pos = c - i.to(ps.dtype)
    basec = torch.trunc(pos).long().clamp(0, half)
    y0 = torch.gather(ps, 1, basec)
    y1 = torch.gather(ps, 1, (basec + 1).clamp(max=half))
    dy = torch.where(basec < upper, y1 - y0, zero)
    add = torch.where(i < upper - 1, fma(dy, pos - torch.trunc(pos), y0),
                      zero)
    return torch.cat([ps[:, :ul_max] + add, ps[:, ul_max:]], dim=1)


def _linear_smoothing_parity_plain(ps, width, fs: int, fft_size: int,
                                   b_max: int):
    """common.cpp:77-111 in the JAX package's f64 order (its mirror
    branch, prims.py:487-509): the row mirrored about the frame's own
    offset b = int(width*N/fs) + 1, o = half - |half - |p - b||, its
    cumulative sum in jnp.cumsum's order on the CPU (`xla_cumsum`), and
    two interp1Q reads with valid_last = half + 2b.  The reads' lerps are
    fused multiply-adds and the divisions by fs and by fs/N products with
    their reciprocals, as XLA compiles that branch: the two reads cancel,
    so their last bits are the result's.  ps (R, N/2+1) float64, width
    (R,)."""
    half = fft_size // 2
    P = half + 2 * b_max + 1
    dev, dtype = ps.device, ps.dtype
    zero = torch.zeros((), dtype=dtype, device=dev)
    delta = fs / fft_size
    b = (torch.trunc((width * fft_size) * (1.0 / fs)).long() + 1)[:, None]
    p = torch.arange(P, device=dev)[None, :]
    o = half - torch.abs(half - torch.abs(p - b))
    seg = xla_cumsum(torch.gather(ps, 1, o.clamp(0, half)) * delta)
    origin = exact_div(-(b.to(dtype) - 0.5) * fs, fft_size)
    valid_last = half + 2 * b
    freq = (exact_div(torch.arange(half + 1, dtype=dtype, device=dev) * fs,
                      fft_size)[None, :] - exact_div(width, 2.0)[:, None])

    def q(xi):
        pos = (xi - origin) * (1.0 / delta)
        base = torch.trunc(pos)
        basec = base.long().clamp(0, P - 1)
        y0 = torch.gather(seg, 1, basec)
        y1 = torch.gather(seg, 1, (basec + 1).clamp(max=P - 1))
        dy = torch.where(basec < valid_last, y1 - y0, zero)
        return fma(dy, pos - base, y0)

    return (q(freq + width[:, None]) - q(freq)) / width[:, None]


def smooth_spectrum_plain(ps, fs: int, fft_size: int, f0=None,
                          ul_max: int = 0, width=None, b_max: int = 0,
                          acc=torch.float64, parity: bool = False):
    """K2's twin: the fast forms above, or with `parity` the parity forms
    (the reference's order), in the rows' dtype."""
    if f0 is not None:
        ps = (_dc_correction_parity_plain if parity
              else _dc_correction_plain)(ps, f0, fs, fft_size, ul_max)
    if width is not None:
        ps = (_linear_smoothing_parity_plain(ps, width, fs, fft_size, b_max)
              if parity else _linear_smoothing_plain(ps, width, fs,
                                                     fft_size, b_max, acc))
    return ps


def smooth_spectrum_limit(ps, out, fs: int, fft_size: int, f0=None,
                          ul_max: int = 0, width=None, b_max: int = 0):
    """Per-element limit on |K2 - plain| for f32 rows ps whose plain
    result is `out`.

    The DC fold is the same f32 operations in both, so it is held
    bit-equal.  The smoothing sums in float64 in both, in different
    orders: two orders of a sum of P terms differ by at most 2P eps64
    times S, the sum of |mirrored row| * fs/N, and the reads and their
    difference add 16 more.  That over the width, plus two f32 ulps where
    the two float64 results round to neighbouring floats.
    """
    if width is None:
        return torch.zeros_like(out, dtype=torch.float64)
    if f0 is not None:
        ps = smooth_spectrum_plain(ps, fs, fft_size, f0, ul_max)
    mag = ps.abs().double()
    half = fft_size // 2
    S = (mag.sum(1) + mag[:, 1:b_max + 1].sum(1)
         + mag[:, half - b_max:half].sum(1)) * (fs / fft_size)
    terms = half + 2 * b_max + 1
    spread = (2 * terms + 16) * torch.finfo(torch.float64).eps * S
    return ((spread / width.double())[:, None]
            + 2 * torch.finfo(torch.float32).eps * out.abs().double())


SMOOTH_RUN_MAX = 23     # K2's mirrored values a thread, at most (odd)


def smooth_plan(fft_size: int, b_max: int):
    """K2's plan for float32 rows of fft_size/2+1 bins (csrc/
    spectral_smooth.cu's launcher): (TPR, R, RPB), TPR threads a row
    (32-256), R mirrored values a thread (odd, <= SMOOTH_RUN_MAX; the
    runs cover the mirrored row of half + 2 b_max + 1 values, or the row
    itself when b_max is 0), RPB rows a block (128 threads a block, or one
    row of 256).  None where no plan holds the row.  A copy of the
    kernel's `spectral_smooth_plan` for the CPU's emulation; the card
    tests hold the two alike."""
    n = fft_size // 2 + 1
    need = max(fft_size // 2 + 2 * b_max + 1 if b_max > 0 else 0, n)
    for tpr in (32, 64, 128, 256):
        run = -(-need // tpr) | 1
        if run <= SMOOTH_RUN_MAX:
            return tpr, run, max(1, 128 // tpr)
    return None


def smooth_spectrum(ps, fs: int, fft_size: int, f0=None, ul_max: int = 0,
                    width=None, b_max: int = 0, parity: bool = False):
    """K2: rows ps (R, N/2+1) -> linear_smoothing(dc_correction(ps, f0),
    width); either step is skipped when its per-row parameter is None.
    ul_max / b_max are the static bounds of the JAX functions.  The fast
    forms (the smoothing's sums in float64) take float32 rows; `parity`,
    the reference's order (its own mirror offset per frame, XLA's blocked
    cumulative sum), takes float64 rows."""
    if not ps.is_cuda:
        return smooth_spectrum_plain(ps, fs, fft_size, f0, ul_max, width,
                                     b_max, parity=parity)
    R, n = ps.shape
    dt = ps.dtype
    f64 = dt == torch.float64
    if n != fft_size // 2 + 1 or dt != (torch.float64 if parity
                                        else torch.float32):
        raise ValueError("smooth_spectrum: rows (R, N/2+1), float32 for "
                         "the fast forms, float64 for the parity forms")
    ps = ps.contiguous()
    f0c = f0.to(dt).contiguous() if f0 is not None else None
    wc = width.to(dt).contiguous() if width is not None else None
    kernels.check_cuda("smooth_spectrum", ps,
                       *[t for t in (f0c, wc) if t is not None])
    out = torch.empty_like(ps)
    kernels.launch("spectral_smooth", [
        ps.data_ptr(), R, fft_size,
        f0c.data_ptr() if f0c is not None else None,
        wc.data_ptr() if wc is not None else None,
        float(fs), fs / fft_size if f64 else float(np.float32(fs / fft_size)),
        ul_max if f0c is not None else 0, b_max if wc is not None else 0,
        int(parity), out.data_ptr()],
        dict(ps=ps, fs=fs, fft_size=fft_size, f0=f0c, ul_max=ul_max,
             width=wc, b_max=b_max, parity=parity),
        variant="f64" if f64 else None)
    return out


def dc_correction(ps, f0, fs: int, fft_size: int, ul_max: int,
                  parity: bool = False):
    return smooth_spectrum(ps, fs, fft_size, f0=f0, ul_max=ul_max,
                           parity=parity)


def linear_smoothing(ps, width, fs: int, fft_size: int, b_max: int,
                     parity: bool = False):
    return smooth_spectrum(ps, fs, fft_size, width=width, b_max=b_max,
                           parity=parity)


# ---------------------------------------------------------------------------
# K3: exact top-k sum
# ---------------------------------------------------------------------------


def top_k_threshold_sum_plain(p, k: int):
    """Bisection on the integer bit pattern (monotone for non-negative
    floats; 32 steps for f32, 64 for f64): the threshold is the k-th
    largest value of each row, exactly; the sum is the masked sum above
    it plus the ties."""
    itype, steps, top = ((torch.int32, 32, 0x7f7fffff)
                         if p.dtype == torch.float32
                         else (torch.int64, 64, 0x7fefffffffffffff))
    b = p.contiguous().view(itype)
    R = p.shape[0]
    lo = torch.full((R,), -1, dtype=itype, device=p.device)
    hi = torch.full((R,), top, dtype=itype, device=p.device)
    for _ in range(steps):
        mid = lo + (hi - lo) // 2
        gt = (b > mid[:, None]).sum(dim=1) >= k
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    gt_mask = b > hi[:, None]
    n_gt = gt_mask.sum(dim=1)
    s_gt = torch.where(gt_mask, p, torch.zeros((), dtype=p.dtype,
                                               device=p.device)).sum(dim=1)
    tie = hi.view(p.dtype)
    return s_gt + (k - n_gt).to(p.dtype) * tie, tie


TOPK_MAX_N = 16384


def topk_plan(n: int):
    """K3's plan for rows of n floats (csrc/topk_sum.cu's launcher): (CH,
    W), CH float4 slots a thread on W warps a row, the least that hold a
    row (at most n/4 whole float4 past its first 16-byte boundary, and 3 +
    3 single floats around them)."""
    if not 1 <= n <= TOPK_MAX_N:
        raise ValueError(f"topk_plan: 1 <= n <= {TOPK_MAX_N}")
    for ch, w in ((2, 1), (4, 1), (8, 1), (16, 1), (16, 2), (16, 4)):
        if n <= 128 * ch * w + 3:
            return ch, w
    return 16, 8


def top_k_threshold_sum(p, k: int):
    """K3: rows p (R, n) of non-negative f32 -> (sum of the k largest,
    the k-th largest value), both exact selections: a radix select of
    the k-th largest pattern, a warp (or `topk_plan`'s W warps) a row."""
    if not p.is_cuda:
        return top_k_threshold_sum_plain(p, k)
    R, n = p.shape
    if p.dtype != torch.float32 or not 1 <= k <= n or n > TOPK_MAX_N:
        raise ValueError(f"top_k_threshold_sum: f32 rows and 1 <= k <= n "
                         f"<= {TOPK_MAX_N}")
    p = p.contiguous()
    kernels.check_cuda("top_k_threshold_sum", p)
    s = torch.empty(R, dtype=torch.float32, device=p.device)
    thr = torch.empty(R, dtype=torch.float32, device=p.device)
    kernels.launch("topk_sum", [p.data_ptr(), R, n, k, s.data_ptr(),
                                thr.data_ptr()], dict(p=p, k=k))
    return s, thr


def sum_top_k(p, k: int):
    return top_k_threshold_sum(p, k)[0]


# ---------------------------------------------------------------------------
# IIR filters as a block formulation (float64), and K13: decimation
# ---------------------------------------------------------------------------

DECIMATE_COEF = {
    # r: (a0, a1, a2, b0, b1)  -- matlabfunctions.cpp:27-113
    11: (2.450743295230728, -2.06794904601978, 0.59574774438332101,
         0.0026822508007163792, 0.0080467524021491377),
    12: (2.4981398605924205, -2.1368928194784025, 0.62187513816221485,
         0.0021097275904709001, 0.0063291827714127002),
    10: (2.3936475118069387, -1.9873904075111861, 0.5658879979027055,
         0.0034818622251927556, 0.010445586675578267),
    9: (2.3236003491759578, -1.8921545617463598, 0.53148928133729068,
        0.0046331164041389372, 0.013899349212416812),
    8: (2.2357462340187593, -1.7780899984041358, 0.49152555365968692,
        0.0063522763407111993, 0.019056829022133598),
    7: (2.1225239019534703, -1.6395144861046302, 0.44469707800587366,
        0.0090366882681608418, 0.027110064804482525),
    6: (1.9715352749512141, -1.4686795689225347, 0.3893908434965701,
        0.013469181309343825, 0.040407543928031475),
    5: (1.7610939654280557, -1.2554914843859768, 0.3237186507788215,
        0.021334858522387423, 0.06400457556716227),
    4: (1.4499664446880227, -0.98943497080950582, 0.24578252340690215,
        0.036710750339322612, 0.11013225101796784),
    3: (0.95039378983237421, -0.67429146741526791, 0.15412211621346475,
        0.071221945171178636, 0.21366583551353591),
    2: (0.041156734567757189, -0.42599112459189636, 0.041037215479961225,
        0.16797464681802227, 0.50392394045406674),
}

IIR_BLOCK = 256
DECIMATE_PAD = 9


def companion(coefs: tuple) -> np.ndarray:
    """A of s_t = A s_{t-1} + x_t e0: s_t[0] = sum_k coefs[k] s_{t-1}[k]
    + x_t, the rest shift down."""
    d = len(coefs)
    A = np.zeros((d, d))
    A[0, :] = coefs
    A[1:, :-1] = np.eye(d - 1)
    return A


@functools.lru_cache(maxsize=None)
def affine_kernel(coefs: tuple, block: int):
    """Host-precomputed float64 operators of the block evaluation of the
    recurrence above (the JAX package's `_affine_kernel`, for an input on
    component 0 only): F[k] = A^k for k = 1..block, the impulse matrix
    K[j, i, :] = A^(i-j) e0 for j <= i, and A^block."""
    d = len(coefs)
    A = companion(coefs)
    F = np.empty((block + 1, d, d))
    F[0] = np.eye(d)
    for k in range(block):
        F[k + 1] = A @ F[k]
    K = np.zeros((block, block, d))
    for j in range(block):
        K[j, j:, :] = F[:block - j, :, 0]
    return F[1:], K.reshape(block, block * d), F[block]


def iir_first_state(coefs: tuple, x):
    """w_t = x_t + sum_k coefs[k] w_{t-1-k} (zero initial state) for rows
    x (R, L) in float64, by blocks: within a block of IIR_BLOCK steps the
    zero-start states are one product with the impulse matrix; the block
    starts follow a carry over blocks; w = F_{i+1}[0] . start + q_i."""
    block = IIR_BLOCK
    d = len(coefs)
    R, L = x.shape
    Fj, Km, Fb = (torch.as_tensor(a, dtype=torch.float64, device=x.device)
                  for a in affine_kernel(tuple(float(c) for c in coefs),
                                         block))
    pad = (-L) % block
    xb = torch.nn.functional.pad(x.double(), (0, pad)).reshape(R, -1, block)
    q = (xb @ Km).reshape(R, -1, block, d)            # zero-start states
    starts = [torch.zeros((R, d), dtype=torch.float64, device=x.device)]
    for b in range(q.shape[1] - 1):
        starts.append(starts[-1] @ Fb.T + q[:, b, -1])
    s0 = torch.stack(starts, dim=1)                   # (R, nb, d)
    w = torch.einsum("kj,rbj->rbk", Fj[:, 0, :], s0) + q[..., 0]
    return w.reshape(R, -1)[:, :L]


def iir_filter_plain(coefs: tuple, taps: tuple, x):
    """The order-len(coefs) IIR y_t = sum_m taps[m] w_{t-m} over the
    states above, float64 (matlabfunctions.cpp:115-124's filter for the
    decimation, harvest.cpp:1055-1074's biquad for the smoothing)."""
    w = iir_first_state(coefs, x)
    y = taps[0] * w
    for m, b in enumerate(taps[1:], 1):
        y = y + b * torch.nn.functional.pad(w[:, :-m], (m, 0))
    return y


def decimate_count(n: int, r: int) -> int:
    """Values the C loop (matlabfunctions.cpp:204-206) emits: it runs i in
    [nbeg, n+9) step r, up to 2 more than MATLAB's nout."""
    nout = (n - 1) // r + 1
    nbeg = r - r * nout + n
    return (n + DECIMATE_PAD - 1 - nbeg) // r + 1


def decimate_plain(x, r: int):
    """matlabfunctions.cpp:184-210 for rows x (B, n): reflect-pad by 9,
    filter, reverse, filter, reverse, strided pick; float64 throughout
    (the block formulation above), cast back to x's dtype."""
    a0, a1, a2, b0, b1 = DECIMATE_COEF[r]
    n = x.shape[1]
    xd = x.double()
    k = torch.arange(DECIMATE_PAD, device=x.device)
    head = 2 * xd[:, :1] - xd[:, DECIMATE_PAD - k]
    tail = 2 * xd[:, -1:] - xd[:, n - 2 - k]
    tmp = torch.cat([head, xd, tail], dim=1)
    for _ in range(2):
        tmp = iir_filter_plain((a0, a1, a2), (b0, b1, b1, b0), tmp).flip(1)
    nout = (n - 1) // r + 1
    nbeg = r - r * nout + n
    idx = nbeg + torch.arange(decimate_count(n, r), device=x.device) * r \
        + DECIMATE_PAD - 1
    return tmp[:, idx].to(x.dtype)


THREADS_K13 = 1024


@functools.lru_cache(maxsize=None)
def _decimate_table(r: int, chunk: int, device):
    """K13's float64 constants: a0 a1 a2 b0 b1, then P^0..P^32, P^64,
    P^128, P^256, P^512 (3x3 each, row-major) for P = A^chunk."""
    a0, a1, a2, b0, b1 = DECIMATE_COEF[r]
    P = np.linalg.matrix_power(companion((a0, a1, a2)), chunk)
    pows = [np.linalg.matrix_power(P, e) for e in range(33)]
    pows += [np.linalg.matrix_power(P, e) for e in (64, 128, 256, 512)]
    flat = np.concatenate([[a0, a1, a2, b0, b1]]
                          + [p.reshape(-1) for p in pows])
    return torch.as_tensor(flat, dtype=torch.float64, device=device)


def decimate(x, r: int):
    """K13: `decimate_plain` of f32 or float64 rows x (B, n) in one
    launch, one block per row; the recurrence runs in float64 chunks whose
    start states come from a scan of the chunks' zero-start end states."""
    if not x.is_cuda:
        return decimate_plain(x, r)
    B, n = x.shape
    f64 = x.dtype == torch.float64
    if x.dtype not in (torch.float32, torch.float64) \
            or r not in DECIMATE_COEF or n < DECIMATE_PAD + 2:
        raise ValueError("decimate: f32 or f64 rows longer than 10 samples, "
                         "a ratio of 2-12")
    x = x.contiguous()
    kernels.check_cuda("decimate", x)
    M = n + 2 * DECIMATE_PAD
    chunk = -(-M // THREADS_K13)
    table = _decimate_table(r, chunk, x.device)
    count = decimate_count(n, r)
    nout = (n - 1) // r + 1
    nbeg = r - r * nout + n
    scratch = torch.empty((B, M), dtype=torch.float64, device=x.device)
    out = torch.empty((B, count), dtype=x.dtype, device=x.device)
    kernels.launch("harvest_decimate", [
        x.data_ptr(), B, n, r, chunk, nbeg, count, int(f64),
        table.data_ptr(), scratch.data_ptr(), out.data_ptr()],
        dict(x=x, r=r), variant="f64" if f64 else None)
    return out
