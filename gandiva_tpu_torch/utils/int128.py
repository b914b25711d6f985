"""Vectorized int128 arithmetic as (hi: int64, lo: uint64 bits in int64) limbs.

The torch counterpart of gandiva_tpu.utils.int128, the foundation of the
decimal128 registry (the reference's decimal_ir.cc / decimal_ops.cc work on
__int128, SURVEY.md §2a#12). Torch has no 128-bit type, so a signed value
v = hi * 2^64 + lo is carried as two int64 tensors: ``hi`` two's complement,
``lo`` the bits of the unsigned low word. Every function is elementwise over
tensors (0-d literals broadcast) and returns the reference's bits.

Torch has few uint64 kernels, so the unsigned word operations are done on
int64: unsigned compares flip the sign bit, logical right shifts mask off
the copies of the sign bit (``_shr``), and sums and products wrap mod 2^64.
The 64×64→128 product still takes 32-bit halves (``mul_u64``).

Products and divisions by powers of ten take direct routes where those give
the same bits as the reference's generic ones: ``mul_pow10`` multiplies mod
2^128 once (the reference shifts and adds k times), and ``div_pow10_round``
divides by 10^9 at a time on 32-bit limbs (the reference runs
``divmod128``). ``divmod128`` itself is the reference's 128-step restoring
division, kept for decimal divide and mod.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFF_FFFF
_SIGN = -(1 << 63)
_U64 = (1 << 64) - 1


def _wrap64(v: int) -> int:
    """A Python int's low 64 bits as a signed int64 value."""
    v &= _U64
    return v - (1 << 64) if v >= 1 << 63 else v


def _ult(a, b):
    """Unsigned a < b on the int64 bits."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _shr(x, k: int):
    """Logical right shift by a static 1..63."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def from_int64(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 → int128 (sign-extended)."""
    return x >> 63, x


def to_int64(hi, lo):
    """Truncating: low 64 bits reinterpreted signed."""
    return lo


def is_neg(hi, lo):
    return hi < 0


def neg128(hi, lo):
    """Two's complement negate: (~hi + carry, -lo); carry iff lo == 0."""
    return ~hi + (lo == 0).to(torch.int64), -lo


def abs128(hi, lo):
    n = is_neg(hi, lo)
    ahi, alo = neg128(hi, lo)
    return torch.where(n, ahi, hi), torch.where(n, alo, lo)


def add128(ahi, alo, bhi, blo):
    lo = alo + blo
    return ahi + bhi + _ult(lo, alo).to(torch.int64), lo


def sub128(ahi, alo, bhi, blo):
    nh, nl = neg128(bhi, blo)
    return add128(ahi, alo, nh, nl)


def cmp128(ahi, alo, bhi, blo):
    """-1 / 0 / +1 signed comparison (int32)."""
    lo_lt = _ult(alo, blo)
    lo_gt = _ult(blo, alo)
    lo_c = lo_gt.to(torch.int32) - lo_lt.to(torch.int32)
    return torch.where(ahi < bhi, -1, torch.where(ahi > bhi, 1, lo_c)
                       ).to(torch.int32)


def mul_u64(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned 64×64 → 128 via 32-bit halves."""
    a0, a1 = a & _M32, _shr(a, 32)
    b0, b1 = b & _M32, _shr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = _shr(p00, 32) + (p01 & _M32) + (p10 & _M32)
    lo = (p00 & _M32) | (mid << 32)
    hi = p11 + _shr(p01, 32) + _shr(p10, 32) + _shr(mid, 32)
    return hi, lo


def mul128_i64(hi, lo, m):
    """int128 × int64 → int128 (truncating at 128 bits)."""
    sign = torch.logical_xor(is_neg(hi, lo), m < 0)
    ahi, alo = abs128(hi, lo)
    am = torch.abs(m)
    phi, plo = mul_u64(alo, am)
    phi = phi + ahi * am  # ahi*am adds into the high limb
    nh, nl = neg128(phi, plo)
    return torch.where(sign, nh, phi), torch.where(sign, nl, plo)


def mul_i64(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed 64×64 → 128."""
    sign = torch.logical_xor(a < 0, b < 0)
    hi, lo = mul_u64(torch.abs(a), torch.abs(b))
    nh, nl = neg128(hi, lo)
    return torch.where(sign, nh, hi), torch.where(sign, nl, lo)


def shl128(hi, lo, k: int):
    """Left shift by a static 0..63 amount."""
    if k == 0:
        return hi, lo
    return (hi << k) | _shr(lo, 64 - k), lo << k


def shr128u(hi, lo, k: int):
    """Logical right shift by a static 0..63 amount."""
    if k == 0:
        return hi, lo
    return _shr(hi, k), _shr(lo, k) | (hi << (64 - k))


def divmod128(ahi, alo, bhi, blo):
    """Signed int128 ÷ int128 → (q_hi, q_lo, r_hi, r_lo); C semantics
    (truncation toward zero, remainder sign = dividend sign).

    Bitwise restoring division on a 128-bit remainder, 128 steps (the
    reference's ``lax.fori_loop``, unrolled: each step's bit position is a
    Python int). A divisor of 0 gives a quotient of all ones and the
    dividend's magnitude as remainder, as the reference's loop does."""
    qsign = torch.logical_xor(is_neg(ahi, alo), is_neg(bhi, blo))
    rsign = is_neg(ahi, alo)
    uhi, ulo = abs128(ahi, alo)
    dhi, dlo = abs128(bhi, blo)
    uhi, ulo, dhi, dlo = torch.broadcast_tensors(uhi, ulo, dhi, dlo)
    z = torch.zeros_like(ulo)
    qhi, qlo, rhi, rlo = z, z, z, z
    for bit_idx in range(127, -1, -1):
        src = uhi if bit_idx >= 64 else ulo
        bit = (src >> (bit_idx % 64)) & 1
        # r = (r << 1) | bit
        rhi2 = (rhi << 1) | _shr(rlo, 63)
        rlo2 = (rlo << 1) | bit
        # ge = r >= d (unsigned 128)
        ge = _ult(dhi, rhi2) | ((rhi2 == dhi) & ~_ult(rlo2, dlo))
        # r -= d where ge
        borrow = _ult(rlo2, dlo).to(torch.int64)
        rhi = torch.where(ge, rhi2 - dhi - borrow, rhi2)
        rlo = torch.where(ge, rlo2 - dlo, rlo2)
        if bit_idx >= 64:
            qhi = qhi | (ge.to(torch.int64) << (bit_idx - 64))
        else:
            qlo = qlo | (ge.to(torch.int64) << bit_idx)
    nqh, nql = neg128(qhi, qlo)
    nrh, nrl = neg128(rhi, rlo)
    return (torch.where(qsign, nqh, qhi), torch.where(qsign, nql, qlo),
            torch.where(rsign, nrh, rhi), torch.where(rsign, nrl, rlo))


# powers of ten up to 10^38 as (hi, lo) int64 pairs (host-computed)
POW10_HI = tuple((10 ** i) >> 64 for i in range(39))
POW10_LO = tuple(_wrap64(10 ** i) for i in range(39))


def pow10_128(k: int) -> Tuple[int, int]:
    """(hi, lo) python ints (lo already wrapped to signed) for 10^k."""
    return POW10_HI[k], POW10_LO[k]


def mul_pow10(hi, lo, k: int):
    """int128 × 10^k for static k (k ≤ 38), truncating at 128 bits: one
    product mod 2^128, the same bits as the reference's k steps of ×10."""
    if k == 0:
        return hi, lo
    c_hi, c_lo = pow10_128(k)
    phi, plo = mul_u64(lo, torch.full_like(lo, c_lo))
    return phi + hi * c_lo + lo * c_hi, plo


def _divmod_pow10_u(hi, lo, k: int):
    """Nonnegative (hi, lo) (unsigned 128) ÷ 10^k → (q_hi, q_lo, r_hi, r_lo),
    exact: long division over 32-bit limbs by 10^9 at a time (every step's
    ``(r << 32) | limb`` stays below 2^62), the remainder as x − q·10^k."""
    limbs = [lo & _M32, _shr(lo, 32), hi & _M32, _shr(hi, 32)]
    left = k
    while left > 0:
        step = min(left, 9)
        left -= step
        d = 10 ** step
        r = torch.zeros_like(limbs[0])
        for idx in range(3, -1, -1):
            t = (r << 32) | limbs[idx]
            limbs[idx] = t // d
            r = t % d
    qlo = limbs[0] | (limbs[1] << 32)
    qhi = limbs[2] | (limbs[3] << 32)
    ph, pl = mul_pow10(qhi, qlo, k)
    rh, rl = sub128(hi, lo, ph, pl)
    return qhi, qlo, rh, rl


def divmod_pow10(hi, lo, k: int):
    """Signed int128 ÷ 10^k for static k (1..38) → (q_hi, q_lo, r_hi, r_lo)
    with ``divmod128``'s C semantics and bits (``divmod128`` by 10^k)."""
    sign = is_neg(hi, lo)
    ahi, alo = abs128(hi, lo)
    qhi, qlo, rhi, rlo = _divmod_pow10_u(ahi, alo, k)
    nqh, nql = neg128(qhi, qlo)
    nrh, nrl = neg128(rhi, rlo)
    return (torch.where(sign, nqh, qhi), torch.where(sign, nql, qlo),
            torch.where(sign, nrh, rhi), torch.where(sign, nrl, rlo))


def div_pow10_round(hi, lo, k: int):
    """int128 ÷ 10^k with round-half-away-from-zero (Java/Gandiva scale
    reduction semantics), for static k."""
    if k == 0:
        return hi, lo
    sign = is_neg(hi, lo)
    ahi, alo = abs128(hi, lo)
    # signed, as the reference divides: the magnitude of -2^127 reads
    # negative again
    qhi, qlo, rhi, rlo = divmod_pow10(ahi, alo, k)
    # round: r*2 >= 10^k ?
    r2h, r2l = shl128(rhi, rlo, 1)
    ph, pl = pow10_128(k)
    ge = cmp128(r2h, r2l, torch.full_like(r2h, ph),
                torch.full_like(r2l, pl)) >= 0
    qhi, qlo = add128(qhi, qlo, torch.zeros_like(qhi), ge.to(torch.int64))
    nh, nl = neg128(qhi, qlo)
    return torch.where(sign, nh, qhi), torch.where(sign, nl, qlo)


def mul256_div_pow10(ahi, alo, bhi, blo, k: int):
    """(a × b) ÷ 10^k with round-half-away-from-zero, via a full 256-bit
    intermediate product — the reference's ``decimal_xlarge`` path
    (decimal_xlarge.cc, SURVEY.md §2a#12), used when BOTH multiply operands
    exceed 18 digits. The quotient truncates to 128 bits.

    Schoolbook 4×4 product of 32-bit limbs into 8 columns, one carry sweep,
    then round(x/10^k) = floor((x + 5·10^(k-1)) / 10^k) on the magnitude,
    dividing by ≤10^9 at a time so every long-division step fits."""
    sign = torch.logical_xor(is_neg(ahi, alo), is_neg(bhi, blo))
    Ah, Al = abs128(ahi, alo)
    Bh, Bl = abs128(bhi, blo)

    def split32(hi_, lo_):
        return [lo_ & _M32, _shr(lo_, 32), hi_ & _M32, _shr(hi_, 32)]

    a = split32(Ah, Al)
    b = split32(Bh, Bl)
    col = [0] * 8
    for i in range(4):
        for j in range(4):
            p = a[i] * b[j]                       # < 2^64 - 2^33 (wraps)
            col[i + j] = col[i + j] + (p & _M32)
            if i + j + 1 < 8:
                col[i + j + 1] = col[i + j + 1] + _shr(p, 32)
    limbs = []
    carry = 0
    for c in col:                                 # ≤ 8 sub-2^32 terms + carry
        t = c + carry
        limbs.append(t & _M32)
        carry = t >> 32
    if k > 0:
        half = 5 * 10 ** (k - 1)                  # 10^k / 2, exact
        carry = 0
        for idx in range(8):
            t = limbs[idx] + ((half >> (32 * idx)) & _M32) + carry
            limbs[idx] = t & _M32
            carry = t >> 32
        left = k
        while left > 0:
            step = min(left, 9)
            left -= step
            d = 10 ** step
            r = torch.zeros_like(limbs[0])
            for idx in range(7, -1, -1):
                t = (r << 32) | limbs[idx]
                limbs[idx] = t // d
                r = t % d
    lo = limbs[0] | (limbs[1] << 32)
    hi = limbs[2] | (limbs[3] << 32)
    nh, nl = neg128(hi, lo)
    return torch.where(sign, nh, hi), torch.where(sign, nl, lo)


def _u64_to_f64(x):
    """uint64 bits → float64 with one rounding: values ≥ 2^63 halve with a
    sticky bit, convert, then double (float64 keeps far fewer than 63 bits)."""
    half = _shr(x, 1) | (x & 1)
    return torch.where(x < 0, half.to(torch.float64) * 2, x.to(torch.float64))


def to_float64(hi, lo):
    """int128 → float64 (approximate, for casts), as the reference rounds."""
    sign = is_neg(hi, lo)
    ahi, alo = abs128(hi, lo)
    f = _u64_to_f64(ahi) * 2.0 ** 64 + _u64_to_f64(alo)
    return torch.where(sign, -f, f)
