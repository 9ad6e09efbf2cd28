"""K3's schedule on the CPU: a numpy emulation of the kernel's selection
(`topk_emulate`: the rows' register layout by `prims.topk_plan`, the
radix select's four passes over the keys (each pattern clamped into [-1,
0x7f7fffff], plus 1) with the warp's scan of each histogram, and the sum
in the kernel's float32 order) against the twin's 32-step bisection
(`prims.top_k_threshold_sum_plain`), threshold bit for bit, on
adversarial rows.

The kernel (`csrc/topk_sum.cu`) runs only on the card;
`tests/test_torch_cuda.py` holds it to the twin there on the same rows.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from hts_train_world_tpu_torch.ops import prims

TOP = 0x7F7FFFFF
NEG0 = np.int32(-2 ** 31)          # -0.0's pattern: the kernel's empty slot
PASSES = ((23, 0xFF), (15, 0xFF), (7, 0xFF), (0, 0x7F))


def _slots(bits, r: int):
    """Row r's patterns as the kernel's threads hold them, (32 W, 4 CH +
    1): thread t's CH float4 of the 16-byte aligned body from t*CH, then
    its extra slot (the floats before the first boundary for t < 3, after
    the last one for t in 4-6), -0 where a slot is past the row.  The
    tensor's base is 16-byte aligned, so the row starts 4 r n bytes in."""
    n = bits.shape[0]
    ch, w = prims.topk_plan(n)
    head = min(((16 - (4 * r * n) % 16) % 16) // 4, n)
    nv = (n - head) // 4
    tail0 = head + 4 * nv
    T = 32 * w
    out = np.full((T, 4 * ch + 1), NEG0, np.int32)
    for t in range(T):
        for i in range(ch):
            c = t * ch + i
            if c < nv:
                out[t, 4 * i:4 * i + 4] = bits[head + 4 * c:head + 4 * c + 4]
        if t < head:
            out[t, -1] = bits[t]
        elif 4 <= t < 4 + n - tail0:
            out[t, -1] = bits[tail0 + t - 4]
    return out


def _select(keys, k: int):
    """The radix select of the kernel: per pass the histogram of the keys
    that match the digits chosen so far, lane l summing digits [8l, 8l+8),
    the lanes' suffix sums, and the lane and digit holding the kk-th."""
    prefix, mask, kk = 0, 0, k
    for shift, dm in PASSES:
        live = (keys & mask) == prefix
        hist = np.bincount((keys[live] >> shift) & dm, minlength=256)
        tl = hist.reshape(32, 8).sum(1)
        incl = np.cumsum(tl[::-1])[::-1]           # bins of lanes >= l
        above = incl - tl
        lane = int(np.nonzero((above < kk) & (kk <= incl))[0][0])
        a = int(above[lane])
        for b in range(7, -1, -1):
            h = int(hist[8 * lane + b])
            if a + h >= kk:
                digit, kk = 8 * lane + b, kk - a
                break
            a += h
        prefix |= digit << shift
        mask |= dm << shift
    return prefix


def topk_emulate(p, k: int):
    """(sum, threshold) of each float32 row of p (R, n) as K3 computes
    them."""
    p = np.ascontiguousarray(p, np.float32)
    bits = p.view(np.int32)
    sums, thrs = [], []
    for r in range(p.shape[0]):
        slots = _slots(bits[r], r)
        flat = np.sort(slots.reshape(-1))
        real = np.sort(bits[r])
        # every float of the row in exactly one slot, the rest empty
        pad = flat.size - real.size
        assert pad >= 0 and np.array_equal(
            np.sort(np.concatenate([real, np.full(pad, NEG0, np.int32)])),
            flat)
        keys = (np.clip(slots.reshape(-1).astype(np.int64), -1, TOP)
                + 1).astype(np.uint32)
        th = _select(keys, k) - 1
        above = slots > th
        vals = np.where(above, slots, 0).view(np.float32)
        ng = int(above.sum())
        tie = np.int32(th).view(np.float32)
        with np.errstate(invalid="ignore", over="ignore"):  # inf, NaN rows
            s = np.zeros(slots.shape[0], np.float32)
            for j in range(slots.shape[1]):          # each thread in order
                s = (s + vals[:, j]).astype(np.float32)
            s = s.reshape(-1, 32)
            for o in (16, 8, 4, 2, 1):               # warp_sum's butterfly
                s = (s + s[:, np.arange(32) ^ o]).astype(np.float32)
            tot = np.float32(0.0)
            for w in range(s.shape[0]):              # the warps in order
                tot = np.float32(tot + s[w, 0])
            sums.append(np.float32(tot + np.float32(np.float32(k - ng)
                                                    * tie)))
        thrs.append(tie)
    return np.array(sums, np.float32), np.array(thrs, np.float32)


def _ks(n: int):
    return sorted({1, 2, min(65, n), max(1, n // 3), n - 1 or 1, n})


@pytest.mark.parametrize("n", (1, 5, 300, 1025, 2049, 2052, 4097, 9000))
def test_emulated_selection_matches_the_bisection(n):
    """At each plan's sizes (one warp at CH 2-16, two to eight warps),
    k = 1, 2, 65, n/3, n-1 and n: the threshold bit for bit the twin's on
    every adversarial row (`chip_smoke.topk_rows`); the sum within 1e-5 of the twin's where
    finite, the same inf or NaN where not."""
    p = chip_smoke.topk_rows(n)
    for k in _ks(n):
        s, thr = topk_emulate(p, k)
        s0, thr0 = (v.numpy() for v in prims.top_k_threshold_sum_plain(
            torch.as_tensor(p), k))
        np.testing.assert_array_equal(thr.view(np.int32),
                                      thr0.view(np.int32))
        fin = np.isfinite(s0)
        np.testing.assert_array_equal(np.isfinite(s), fin)
        np.testing.assert_array_equal(np.isnan(s), np.isnan(s0))
        np.testing.assert_array_equal(s[np.isinf(s0)], s0[np.isinf(s0)])
        assert (np.abs(s[fin] - s0[fin])
                <= 1e-5 * np.abs(s0[fin]) + 1e-30).all()


def test_plan_covers_each_row():
    """`topk_plan`'s slots hold a row's whole float4 (at most n/4) at
    any 16-byte offset; one warp a row up to n = 2051 (D4C's bands at
    44.1 and 48 kHz), CH 8 at n = 1025 (at 16 and 22.05 kHz)."""
    for n in list(range(1, 600)) + [1024, 1025, 1027, 1028, 2048, 2049,
                                    2051, 2052, 4099, 4100, 8195, 8196,
                                    16384]:
        ch, w = prims.topk_plan(n)
        assert 32 * w * ch >= n // 4
        assert (w == 1) == (n <= 2051)
    assert prims.topk_plan(1025) == (8, 1)
    assert prims.topk_plan(2049) == (16, 1)
    with pytest.raises(ValueError):
        prims.topk_plan(16385)
