"""K2-i8's arithmetic on the CPU, in numpy float32: the reduction order and
the byte cast of csrc/gather_rescore.cu's int8 kernel, against the first
port's.

The first port gave each 16-byte chunk of a row its own lane and summed
the 32 lane sums with a butterfly (xor 16, 8, 4, 2, 1), each round adding
the partner's sum to the lane's own; lanes past the row's last chunk held
+0.0. The redesigned kernel gives a row of d <= 256 only p lanes (the
power of two >= d/16), holds several rows a lane, adds +0.0 once and runs
the rounds xor p/2 ... 1 as a reduce-scatter; wider rows keep all five
rounds, 16 rows a lane at a time. Both are modelled here lane by lane, on random
sums with signed zeros mixed in, and must agree bit for bit. The byte cast
(one PRMT into 2^23's mantissa, one FADD) must give float(x) exactly for
every byte, and the high product that stands in for pair / kk must give
the query of every pair.
"""

import re
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parents[1] / "frankensearch_tpu_torch" / "ops" / "csrc"
F32 = np.float32
LANES = np.arange(32)


def lane_sums(rng, n_vec: int) -> np.ndarray:
    """(32 rows, 32 lanes) per-lane sums of a warp's rows: lane c holds
    chunk c's sum, +0.0 past the row's last chunk. Magnitudes spread over
    six decades so the order of the adds shows in the bits; signed zeros
    and all-(-0.0) rows mixed in."""
    s = (rng.standard_normal((32, 32)) * 10.0 ** rng.uniform(-3, 3, (32, 32))).astype(F32)
    s[rng.random((32, 32)) < 0.1] = F32(-0.0)
    s[rng.random((32, 32)) < 0.1] = F32(0.0)
    s[3] = F32(-0.0)
    s[4, ::2] = F32(-0.0)
    s[:, n_vec:] = F32(0.0)
    return s


def first_port(s: np.ndarray) -> np.ndarray:
    """The first port's butterfly: every lane of a row adds its partner's
    sum in each round; all lanes end with the same bits."""
    for m in (16, 8, 4, 2, 1):
        s = s + s[:, LANES ^ m]
    assert all(np.array_equal(s[:, 0].view(np.int32), s[:, lane].view(np.int32)) for lane in range(32))
    return s[:, 0]


def sum_round(s: np.ndarray, w: int, m: int) -> np.ndarray:
    """The kernel's ``sum_round<w>`` over lanes ``m`` apart: s is (32
    lanes, rows a lane holds). With w >= 2 sums a lane keeps half (the
    upper half where its bit m is set) and adds what its partner sends for
    that half; with one it adds the partner's."""
    s = s.copy()
    if w >= 2:
        up = ((LANES & m) != 0)[:, None]
        lo, hi = s[:, : w // 2], s[:, w // 2 : w]
        send = np.where(up, lo, hi)
        s[:, : w // 2] = np.where(up, hi, lo) + send[LANES ^ m]
    else:
        s[:, 0] = s[:, 0] + s[LANES ^ m, 0]
    return s


def kernel_constant(name: str) -> int:
    """A ``constexpr int`` of the kernel's source."""
    src = (CSRC / "gather_rescore.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def redesign(sums: np.ndarray, n_vec: int) -> np.ndarray:
    """The redesigned kernel's reduction of the same lane sums: the 32 row
    results in row order. A row takes p lanes (p = 32 past 16 chunks); a
    lane holds h rows at a time (p up to kMaxRowsI8 where p < 32, else 16
    for d <= 512), rows r0 + (l // p) * h + i of lane l."""
    p = 1 << (n_vec - 1).bit_length() if n_vec <= 16 else 32
    h = min(p, kernel_constant("kMaxRowsI8")) if p < 32 else 16
    share = p // h  # lanes that end with the same row
    out = np.full(32, np.nan, dtype=F32)
    for r0 in range(0, 32, h * (32 // p)):
        held = np.array([[sums[r0 + (lane // p) * h + i, lane % p] for i in range(h)] for lane in LANES], dtype=F32)
        if p < 32:
            held = held + F32(0.0)  # the first port's rounds xor 16 ... p over empty lanes
        w, m = h, p // 2
        while m >= 1:
            held = sum_round(held, w, m)
            w, m = max(w // 2, 1), m // 2
        rows = r0 + (LANES // p) * h + (LANES % p) // share
        out[rows[::share]] = held[::share, 0]  # the lanes that store
        assert np.array_equal(held[:, 0].view(np.int32), out[rows].view(np.int32))
    return out


@pytest.mark.parametrize("d", range(16, 513, 16))
def test_reduction_bits_equal_the_first_port(d):
    n_vec = d // 16
    rng = np.random.default_rng(d)
    for _ in range(4):
        sums = lane_sums(rng, n_vec)
        want, got = first_port(sums), redesign(sums, n_vec)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), d
        assert got[3].view(np.int32) == (0 if n_vec < 32 else np.float32(-0.0).view(np.int32))
    if n_vec >= 3:  # the data tells add orders apart: a left-to-right sum differs
        seq = np.zeros(32, dtype=F32)
        for c in range(32):
            seq = seq + sums[:, c]
        assert not np.array_equal(seq.view(np.int32), want.view(np.int32))


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's ``__byte_perm(x, y, s)``: result byte i is byte s's nibble i
    of the eight bytes y:x (x bytes 0-3, y bytes 4-7)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


@pytest.mark.parametrize("k", range(4))
def test_byte_cast_is_exact_for_every_byte(k):
    """``i8_to_f32<k>``: byte k of w ^ 0x80808080 into the low mantissa
    byte of 2^23 (0x4B000000), less 2^23 + 128, is float(int8) exactly,
    for all 256 bytes in position k beside random neighbours."""
    rng = np.random.default_rng(k)
    for x in range(256):
        others = int(rng.integers(0, 1 << 32)) & ~(0xFF << (8 * k))
        w = others | (x << (8 * k))
        bits = np.array([byte_perm(w ^ 0x80808080, 0x4B000000, 0x7540 | k)], dtype=np.uint32)
        got = bits.view(F32) - F32(8388736.0)
        want = np.array([x], dtype=np.uint8).view(np.int8).astype(F32)
        assert got.view(np.int32)[0] == want.view(np.int32)[0], (k, x)


@pytest.mark.parametrize("kk", [2, 3, 7, 30, 60, 64, 65, 127, 7872, (1 << 31) - 1])
def test_pair_division_by_high_product(kk):
    """The kernel's query index: pair / kk as the high 64 bits of pair *
    (floor((2^64 - 1) / kk) + 1), exact for every pair below 2^31."""
    magic = (2**64 - 1) // kk + 1
    rng = np.random.default_rng(kk)
    pairs = [0, 1, kk - 1, kk, kk + 1, (1 << 31) - 1] + [int(x) for x in rng.integers(0, 1 << 31, 1000)]
    pairs += [m * kk + r for m in (1, 1000, ((1 << 31) - 1) // kk) for r in (-1, 0, kk - 1) if 0 <= m * kk + r < 1 << 31]
    for pair in pairs:
        assert (pair * magic) >> 64 == pair // kk, (kk, pair)
