"""Spectral postfilters — the mel-cepstral postfilter (postfiltering_mcp,
Training.pl:2642-2687) and the modulation-spectrum postfilter
(postfiltering_mspf / msmp2seq / make_mspf, Training.pl:2950-3038,
3133-3221).

Counterpart of `hts_train_world_tpu/ops/postfilter.py`; the LSP
postfilter (`:152-267`, the SPTK engine's gm > 0 preamble) is plain
PyTorch: `lsp_sharpen`, `lsp_check` (a running max), `lsp_to_lpc`,
`lsp_spectrum_energy`, `lsp_postfilter`.

- `mcep_postfilter` (kernel K22, csrc/mcep_postfilter.cu): scale
  coefficients 2.. by pf, then move c0 by 0.5 ln(r0/r0'), r0 the lag-0
  autocorrelation of the dewarped (co = 2047) cepstrum through an rfft at
  `fft_size` (which crops the 2048-term cepstrum when fft_size < 2048).
  The kernel reads one float64 table that folds freqt and the cropped
  cosine transform; `mcep_postfilter_plain` is the JAX formulation
  (freqt, c2acr, mc2b, b2mc) in torch.
- `apply_mspf` / `mspf_stats` (kernel K21, csrc/mspf.cu): each
  trajectory's modulation log-spectrum over centred 25-frame Bartlett
  windows at hop 12 (64-point DFT) is mapped toward the natural
  statistics, ms' = ms + w (((ms - gen_mean)/gen_std) nat_std + nat_mean
  - ms), and the trajectory rebuilt from (ms', its own phase) by
  overlap-add.  `mspf_plain` is the twin (`seq2msmp` / `msmp2seq`:
  torch.fft and index_add_).

Wrappers run the kernels for CUDA tensors (float64 only; anything else
raises) and the twins for CPU tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from hts_train_world_tpu_torch import device as device_mod
from hts_train_world_tpu_torch import kernels
from hts_train_world_tpu_torch.ops import prims, sptk
from hts_train_world_tpu_torch.ops.codec import freqt_matrix

CO = 2047          # cepstrum order for energy matching (Config.pm.in:188)
MSPF_LENGTH = 25
MSPF_FFTLEN = 64
MSPF_SHIFT = (MSPF_LENGTH - 1) // 2
MSPF_BINS = MSPF_FFTLEN // 2 + 1


# ---------------------------------------------------------------------------
# mel-cepstral postfilter: K22
# ---------------------------------------------------------------------------


def mcep_postfilter_plain(mgc, alpha: float, pf: float = 1.4,
                          fft_size: int = 4096):
    """postfiltering_mcp (Training.pl:2642-2687). mgc: (T, M)."""
    M = mgc.shape[-1]
    weight = torch.ones(M, dtype=mgc.dtype, device=mgc.device)
    weight[2:] = pf
    weighted = mgc * weight
    r0 = sptk.c2acr(sptk.freqt(mgc, CO, -alpha), 0, fft_size)[..., 0]
    p_r0 = sptk.c2acr(sptk.freqt(weighted, CO, -alpha), 0,
                      fft_size)[..., 0]
    b = sptk.mc2b(weighted, alpha)
    b0 = b[..., 0] + torch.log(r0 / p_r0) / 2.0
    b = torch.cat([b0[..., None], b[..., 1:]], dim=-1)
    return sptk.b2mc(b, alpha)


@functools.lru_cache(maxsize=None)
def folded_table(M: int, alpha: float, fft_size: int) -> np.ndarray:
    """(M, fft_size/2+1) float64: freqt(., CO, -alpha) followed by the real
    part of an rfft at fft_size, cropped as the rfft crops, as one matrix:
    G[m, k] = sum_{j < min(fft_size, CO+1)} freqt[m, j] cos(2 pi j k / N)."""
    C = cosine_table(fft_size)
    return freqt_matrix(M - 1, CO, -alpha)[:, :C.shape[0]] @ C


def cosine_table(fft_size: int) -> np.ndarray:
    """(min(fft_size, CO+1), fft_size/2+1) float64: s[:n] @ table is the
    real part of `rfft(s, fft_size)` for a (CO+1)-term s, cropped or
    zero-padded to fft_size as the rfft does."""
    n = min(fft_size, CO + 1)
    j = np.arange(n)[:, None]
    k = np.arange(fft_size // 2 + 1)[None, :]
    return np.cos(2.0 * np.pi * ((j * k) % fft_size) / fft_size)


@functools.lru_cache(maxsize=8)
def _folded_tensor(M: int, alpha: float, fft_size: int, device):
    return torch.as_tensor(folded_table(M, alpha, fft_size),
                           dtype=torch.float64, device=device)


def mcep_postfilter(mgc, alpha: float, pf: float = 1.4,
                    fft_size: int = 4096):
    """K22: mgc (T, M) float64 -> the postfiltered mgc (T, M)."""
    if not mgc.is_cuda:
        return mcep_postfilter_plain(mgc, alpha, pf, fft_size)
    if (mgc.dtype != torch.float64 or mgc.dim() != 2
            or not 1 <= mgc.shape[1] <= 256 or fft_size < 2
            or fft_size % 2):
        raise ValueError("mcep_postfilter: float64 mgc (T, M), M <= 256, "
                         "even fft_size")
    x = mgc.contiguous()
    T, M = x.shape
    G = _folded_tensor(M, float(alpha), int(fft_size), x.device)
    kernels.check_cuda("mcep_postfilter", x, G)
    out = torch.empty_like(x)
    kernels.launch("mcep_postfilter", [
        x.data_ptr(), T, M, G.data_ptr(), G.shape[1], float(pf),
        out.data_ptr()],
        dict(mgc=mgc, alpha=float(alpha), pf=float(pf),
             fft_size=int(fft_size)))
    return out


# ---------------------------------------------------------------------------
# modulation-spectrum postfilter: K21
# ---------------------------------------------------------------------------


def n_frames(T: int) -> int:
    """ceil((T + shift) / shift): the sequence zero-padded by `shift`
    (WINDOW -l T -L T+shift, Training.pl:3071) gives one extra tail
    frame for exact Bartlett overlap-add coverage."""
    return int(math.ceil((T + MSPF_SHIFT) / MSPF_SHIFT))


def _frames(x, length: int, shift: int):
    """SPTK frame (centered), batched over leading dims: x (..., T) ->
    (..., n_frames, length), frame k = x[k*shift - (l-1)/2 ...] with zeros
    outside [0, T)."""
    T = x.shape[-1]
    nf = int(math.ceil((T + shift) / shift))
    half = (length - 1) // 2
    idx = (torch.arange(nf, device=x.device)[:, None] * shift
           + torch.arange(length, device=x.device)[None, :] - half)
    valid = (idx >= 0) & (idx < T)
    taken = x[..., idx.clamp(0, T - 1)]
    return torch.where(valid, taken, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


def _bartlett(n: int, dtype, device):
    i = np.arange(n)
    w = 1.0 - np.abs((i - (n - 1) / 2.0) / ((n - 1) / 2.0))
    return torch.as_tensor(w, dtype=dtype, device=device)


def seq2msmp(traj):
    """Trajectories (..., T) -> (log modulation magnitude, phase/pi), each
    (..., n_frames, FFTLEN/2+1) (get_cmd_seq2ms/mp, Training.pl:3063-3096)."""
    frames = _frames(traj, MSPF_LENGTH, MSPF_SHIFT) * _bartlett(
        MSPF_LENGTH, traj.dtype, traj.device)
    X = torch.fft.rfft(frames, n=MSPF_FFTLEN, dim=-1)
    power = X.real ** 2 + X.imag ** 2
    ms = 0.5 * torch.log(power + 1e-30)
    mp = torch.atan2(X.imag, X.real) / math.pi
    return ms, mp


def msmp2seq(ms, mp, T: int):
    """(ms, phase) (..., n_frames, bins) -> trajectories (..., T) via
    overlap-add (msmp2seq, Training.pl:3003-3038): one flat index_add_,
    frame k landing at k*shift."""
    X = torch.exp(ms) * torch.exp(1j * math.pi * mp)
    w = torch.fft.irfft(X, n=MSPF_FFTLEN, dim=-1)
    nf = ms.shape[-2]
    out_len = MSPF_SHIFT * (nf - 1) + MSPF_FFTLEN
    idx = (torch.arange(nf, device=ms.device)[:, None] * MSPF_SHIFT
           + torch.arange(MSPF_FFTLEN, device=ms.device)[None, :]).reshape(-1)
    seq = torch.zeros(ms.shape[:-2] + (out_len,), dtype=w.dtype,
                      device=ms.device)
    seq.index_add_(-1, idx, w.reshape(ms.shape[:-2] + (-1,)))
    return seq[..., MSPF_SHIFT:T + MSPF_SHIFT]


@dataclasses.dataclass
class MspfStats:
    """Per-dimension modulation-spectrum mean/std, (D, FFTLEN/2+1) numpy
    float64."""
    mean: np.ndarray
    std: np.ndarray


def mspf_plain(traj, stats=None, weight: float = 1.0):
    """K21's twin.  traj (T, D).  stats None: the analysis, ms of the
    mean-subtracted trajectories (D, n_frames, 33).  Otherwise stats =
    (nat_mean, nat_std, gen_mean, gen_std), each (D, 33) on traj's device:
    the postfiltered trajectories (T, D)."""
    T = traj.shape[0]
    mean = torch.mean(traj, dim=0)
    ms, mp = seq2msmp((traj - mean).T)
    if stats is None:
        return ms
    nm, ns, gm, gs = stats
    conv = ((ms - gm[:, None]) / gs[:, None]) * ns[:, None] + nm[:, None]
    ms2 = ms + weight * (conv - ms)
    return msmp2seq(ms2, mp, T).T + mean


def mspf(traj, stats=None, weight: float = 1.0):
    """K21: `mspf_plain`'s contract; float64 on the card."""
    if not traj.is_cuda:
        return mspf_plain(traj, stats, weight)
    if (traj.dtype != torch.float64 or traj.dim() != 2
            or traj.shape[0] < 1 or traj.shape[1] < 1
            or (stats is not None and (
                len(stats) != 4 or any(
                    s.dtype != torch.float64
                    or s.shape != (traj.shape[1], MSPF_BINS)
                    for s in stats)))):
        raise ValueError("mspf: float64 trajectories (T, D) and four "
                         "float64 (D, 33) statistics or None")
    x = traj.contiguous()
    T, D = x.shape
    F = n_frames(T)
    dev = x.device
    analysis = stats is None
    st = (tuple(s.contiguous() for s in stats) if not analysis
          else (x,) * 4)
    kernels.check_cuda("mspf", x, *st)
    if analysis:
        ms = torch.empty((D, F, MSPF_BINS), dtype=torch.float64, device=dev)
        ptrs = [ms.data_ptr(), 0, 0, 0]
    else:
        spec = torch.empty((D, F, MSPF_BINS, 2), dtype=torch.float64,
                           device=dev)
        frames = torch.empty((D, F, MSPF_FFTLEN), dtype=torch.float64,
                             device=dev)
        out = torch.empty_like(x)
        ptrs = [0, spec.data_ptr(), frames.data_ptr(), out.data_ptr()]
    kernels.launch("mspf", [
        x.data_ptr(), T, D, F, *(s.data_ptr() for s in st), float(weight),
        int(analysis), *ptrs],
        dict(traj=traj, stats=stats, weight=float(weight)))
    return ms if analysis else out


def mspf_stats(trajs, device="cuda") -> MspfStats:
    """make_mspf statistics over a corpus: trajs = list of (T, D)
    parameter sequences (numpy or tensors), each mean-subtracted and
    analysed in one K21 launch on `device` (the card unless the caller
    asks for the CPU); ms and ms^2 summed in float64 there, read back
    once."""
    dev = device_mod.resolve(device)
    s1 = s2 = None
    n = 0
    for t in trajs:
        x = torch.as_tensor(t, dtype=torch.float64, device=dev)
        ms = mspf(x)                                   # (D, F, 33)
        a, b = ms.sum(1), (ms * ms).sum(1)
        s1, s2 = (a, b) if s1 is None else (s1 + a, s2 + b)
        n += ms.shape[1]
    mean = s1 / n
    var = s2 / n - mean * mean
    return MspfStats(mean.cpu().numpy(),
                     torch.sqrt(torch.clamp(var, min=0.0)).cpu().numpy())


def apply_mspf(traj, nat: MspfStats, gen: MspfStats, weight: float = 1.0):
    """postfiltering_mspf (Training.pl:2950-3000). traj: (T, D) tensor;
    every dimension in one K21 launch on its device."""
    stats = tuple(torch.as_tensor(a, dtype=torch.float64, device=traj.device)
                  for a in (nat.mean, nat.std, gen.mean, gen.std))
    return mspf(traj, stats, weight)


# ---------------------------------------------------------------------------
# LSP postfilter (postfiltering_lsp, Training.pl:2690-2752): plain PyTorch
# ---------------------------------------------------------------------------


def lsp_sharpen(lsp, pf: float = 0.7):
    """The reference's per-frame LSP spacing sharpener
    (Training.pl:2723-2731): for interior indices 1 < i < m-1,

        d1 = pf*(w[i+1]-w[i]);  d2 = pf*(w[i]-w[i-1])
        w'[i] = w[i-1] + d2 + d2^2*((w[i+1]-w[i-1]) - (d1+d2))
                               / (d2^2 + d1^2)

    first and last LSPs pass through.  lsp: (..., m-1) frequencies (gain
    excluded)."""
    prev, cur, nxt = lsp[..., :-2], lsp[..., 1:-1], lsp[..., 2:]
    d1 = pf * (nxt - cur)
    d2 = pf * (cur - prev)
    den = d2 * d2 + d1 * d1
    new = prev + d2 + d2 * d2 * ((nxt - prev) - (d1 + d2)) \
        / torch.where(den == 0.0, torch.ones_like(den), den)
    new = torch.where(den == 0.0, cur, new)
    return torch.cat([lsp[..., :1], new, lsp[..., -1:]], dim=-1)


def lsp_check(lsp, min_gap: float = 1e-3):
    """lspcheck -c -r: each frame's LSPs projected onto the stable region,
    ascending in (0, pi) with a minimal gap, as a running max of w[i] -
    i*gap (a monotone envelope) instead of the C's pairwise swap loop."""
    m = lsp.shape[-1]
    lo = lsp.clamp(min_gap, math.pi - min_gap)
    steps = torch.arange(1, m + 1, dtype=lsp.dtype,
                         device=lsp.device) * min_gap
    env = torch.cummax(lo - steps, dim=-1).values
    return (env + steps).clamp(min_gap, math.pi - min_gap)


def _times_1_plus(c, sign: float, lag: int):
    """c(z) * (1 + sign z^-lag), the same padded length."""
    return c + sign * torch.cat([torch.zeros_like(c[..., :lag]),
                                 c[..., :-lag]], dim=-1)


def _lsp_poly(cos_w, deg_out: int):
    """prod over the roots of (1 - 2c z^-1 + z^-2), coefficients padded to
    deg_out+1, one root at a time."""
    c = torch.zeros(cos_w.shape[:-1] + (deg_out + 1,), dtype=cos_w.dtype,
                    device=cos_w.device)
    c[..., 0] = 1.0
    for r in range(cos_w.shape[-1]):
        s1 = torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)
        s2 = torch.cat([torch.zeros_like(c[..., :2]), c[..., :-2]], dim=-1)
        # c - 2 cos(w) s1 fused, as XLA compiles the JAX package's scan body
        c = prims.fma(-2.0 * cos_w[..., r, None].expand_as(s1), s1, c) + s2
    return c


def lsp_to_lpc(lsp):
    """LSP frequencies (..., m) -> LPC coefficients a[1..m] (SPTK lsp2lpc).
    Sorted LSPs alternate P/Q starting with P: even m: A = ((1+z^-1) P~ +
    (1-z^-1) Q~) / 2; odd m: A = (P~ + (1-z^-2) Q~) / 2, X~ the product of
    (1 - 2 cos(w) z^-1 + z^-2) over that set's roots."""
    m = lsp.shape[-1]
    cos_w = torch.cos(lsp)
    P = _lsp_poly(cos_w[..., 0::2], m + 1)
    Q = _lsp_poly(cos_w[..., 1::2], m + 1)
    if m % 2 == 0:
        P = _times_1_plus(P, +1.0, 1)
        Q = _times_1_plus(Q, -1.0, 1)
    else:
        Q = _times_1_plus(Q, -1.0, 2)
    return (0.5 * (P + Q))[..., 1:m + 1]


def lsp_spectrum_energy(gain, lsp, n_fft: int = 512):
    """0.5 ln sum |H|^2 of the all-pole filter exp(gain)/A(z): the energy
    the reference's ene1/ene2 pipeline measures (Training.pl:2705-2706)."""
    a = lsp_to_lpc(lsp)
    A = torch.cat([torch.ones_like(a[..., :1]), a], dim=-1)
    Af = torch.fft.rfft(A, n=n_fft, dim=-1)
    mag2 = Af.real ** 2 + Af.imag ** 2
    h2 = torch.exp(2.0 * gain)[..., None] / mag2.clamp(min=1e-20)
    return 0.5 * torch.log(h2.sum(-1))


def lsp_postfilter(mgc_lsp, pf: float = 0.7, energy_match: bool = False):
    """postfiltering_lsp (Training.pl:2690-2752) on (T, m) frames of [gain,
    lsp_1..lsp_{m-1}].  energy_match=False is the reference as written
    (its gain correction divides ene2 by itself, so the gain passes
    through); True moves the gain by the all-pole log energy lost to the
    sharpening, gain + (ene1 - ene2)."""
    gain = mgc_lsp[..., 0]
    lsp = mgc_lsp[..., 1:]
    plsp = lsp_check(lsp_sharpen(lsp, pf))
    if energy_match:
        gain = gain + (lsp_spectrum_energy(gain, lsp_check(lsp))
                       - lsp_spectrum_energy(gain, plsp))
    return torch.cat([gain[..., None], plsp], dim=-1)
