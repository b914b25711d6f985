// The helpers every generated plan kernel uses (compiler/codegen.py pastes
// this file at the head of each generated source).
//
// A generated source builds two ways: with nvcc for sm_90a (the card's
// route; --fmad=false, IEEE division and square root) and with g++
// -ffp-contract=off for the host (the tests' route). The per-row body is
// a __host__ __device__ function, so both builds run the same arithmetic.
//
// Each helper repeats, operation for operation, what the eager torch route
// of the registry computes (registry/numeric.py, cast.py, decimal_ops.py,
// utils/int128.py), so the two routes give the same bits:
//   - integer arithmetic wraps, done in unsigned types (no signed overflow);
//   - x / 0 and x % 0 give 0; MIN / -1 gives MIN and MIN % -1 gives 0;
//   - shifts by an amount outside [0, width) shift every bit out;
//   - float -> integer conversions truncate, saturate, and send NaN to 0;
//   - a decimal is one __int128 in registers, from and to the (hi, lo)
//     int64 limbs the columns hold; its products, rescales and divisions
//     keep the limb route's wraparound and rounding.
#pragma once
#include <stdint.h>
#include <string.h>
#include <math.h>
#include <type_traits>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define GT_HD __host__ __device__ __forceinline__
#else
#define GT_HD inline
#endif

typedef __int128 gt_i128;
typedef unsigned __int128 gt_u128;

// -- literals by their bits ---------------------------------------------
GT_HD double gt_f64_bits(uint64_t b) { double d; memcpy(&d, &b, 8); return d; }
GT_HD float gt_f32_bits(uint32_t b) { float f; memcpy(&f, &b, 4); return f; }
GT_HD gt_i128 gt_i128_of(uint64_t hi, uint64_t lo) {
  return (gt_i128)(((gt_u128)hi << 64) | (gt_u128)lo);
}
GT_HD void gt_i128_write(int64_t* hi, int64_t* lo, int64_t i, gt_i128 x) {
  hi[i] = (int64_t)(uint64_t)((gt_u128)x >> 64);
  lo[i] = (int64_t)(uint64_t)(gt_u128)x;
}

// -- wrapping integer arithmetic ------------------------------------------
// the unsigned type arithmetic of T is done in: at least 32 bits, so no
// operand is promoted to a signed int
template <class T>
using gt_uw = typename std::conditional<
    (sizeof(T) < 4), uint32_t, typename std::make_unsigned<T>::type>::type;

template <class T> GT_HD T gt_add(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) return a + b;
  else return (T)((gt_uw<T>)a + (gt_uw<T>)b);
}
template <class T> GT_HD T gt_sub(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) return a - b;
  else return (T)((gt_uw<T>)a - (gt_uw<T>)b);
}
template <class T> GT_HD T gt_mul(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) return a * b;
  else return (T)((gt_uw<T>)a * (gt_uw<T>)b);
}
template <class T> GT_HD T gt_neg(T a) {
  if constexpr (std::is_floating_point<T>::value) return -a;
  else return (T)((gt_uw<T>)0 - (gt_uw<T>)a);
}
template <class T> GT_HD T gt_abs(T a) {
  if constexpr (std::is_same<T, float>::value) return fabsf(a);
  else if constexpr (std::is_same<T, double>::value) return fabs(a);
  else if constexpr (std::is_signed<T>::value) return a < 0 ? gt_neg(a) : a;
  else return a;
}
// truncating division and remainder; a zero divisor gives 0
template <class T> GT_HD T gt_div(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    return a / b;
  } else {
    if (b == 0) return 0;
    if constexpr (std::is_signed<T>::value) {
      if (b == (T)-1) return gt_neg(a);
    }
    return (T)(a / b);
  }
}
template <class T> GT_HD T gt_mod(T a, T b) {
  if constexpr (std::is_same<T, float>::value) {
    return fmodf(a, b);
  } else if constexpr (std::is_same<T, double>::value) {
    return fmod(a, b);
  } else {
    if (b == 0) return 0;
    if constexpr (std::is_signed<T>::value) {
      if (b == (T)-1) return 0;
    }
    return (T)(a % b);
  }
}
// shifts: an amount outside [0, width) (a negative one reads as huge)
// shifts every bit out: 0, or the sign for an arithmetic right shift
template <class T> GT_HD bool gt_shift_oob(T b) {
  const int w = (int)sizeof(T) * 8;
  if constexpr (std::is_signed<T>::value) return b < 0 || b >= (T)w;
  else return b >= (T)w;
}
template <class T> GT_HD T gt_shl(T a, T b) {
  if (gt_shift_oob(b)) return 0;
  return (T)((gt_uw<T>)a << (int)b);
}
template <class T> GT_HD T gt_shr(T a, T b) {
  const int w = (int)sizeof(T) * 8;
  if (gt_shift_oob(b)) {
    if constexpr (std::is_signed<T>::value) return (T)(a >> (w - 1));
    else return 0;
  }
  return (T)(a >> (int)b);
}

// -- conversions ------------------------------------------------------------
// numeric (or bool) -> float F with one rounding; uint64 halves with a
// sticky bit, converts and doubles, as the eager route does
template <class F, class T> GT_HD F gt_to_float(T x) {
  if constexpr (std::is_same<T, uint64_t>::value) {
    const int64_t s = (int64_t)x;
    if (s < 0) return (F)(int64_t)((x >> 1) | (x & 1)) * (F)2;
    return (F)s;
  } else {
    return (F)x;
  }
}
template <class F> GT_HD F gt_floor(F x) {
  if constexpr (std::is_same<F, float>::value) return floorf(x);
  else return floor(x);
}
// round half away from zero in x's own type: sign(x) * floor(|x| + 0.5),
// with ±0 and NaN keeping themselves as their sign
template <class F> GT_HD F gt_round_half_away(F x) {
  const F s = (x == 0 || x != x) ? x : (x > 0 ? (F)1 : (F)-1);
  return s * gt_floor(gt_abs(x) + (F)0.5);
}
// float -> integer T: truncate toward zero, saturate, NaN -> 0
template <class T, class F> GT_HD T gt_float_to_int(F x) {
  const double xf = trunc((double)x);
  const int w = (int)sizeof(T) * 8;
  double lo, hi1;
  if constexpr (std::is_signed<T>::value) {
    lo = -ldexp(1.0, w - 1);
    hi1 = ldexp(1.0, w - 1);
  } else {
    lo = 0.0;
    hi1 = ldexp(1.0, w);
  }
  if (xf != xf) return 0;
  if (xf >= hi1) {
    if constexpr (std::is_signed<T>::value)
      return (T)(((uint64_t)1 << (w - 1)) - 1);
    else
      return (T)~(T)0;
  }
  if (xf < lo) {
    if constexpr (std::is_signed<T>::value) return (T)(-(int64_t)((uint64_t)1 << (w - 1)));
    else return 0;
  }
  if constexpr (std::is_same<T, uint64_t>::value) return (uint64_t)xf;
  else return (T)(int64_t)xf;
}

// -- decimal128 --------------------------------------------------------------
GT_HD gt_i128 gt_i128_neg(gt_i128 x) { return (gt_i128)((gt_u128)0 - (gt_u128)x); }
GT_HD gt_i128 gt_i128_abs(gt_i128 x) { return x < 0 ? gt_i128_neg(x) : x; }
GT_HD gt_i128 gt_i128_add(gt_i128 a, gt_i128 b) {
  return (gt_i128)((gt_u128)a + (gt_u128)b);
}
GT_HD gt_i128 gt_i128_sub(gt_i128 a, gt_i128 b) {
  return (gt_i128)((gt_u128)a - (gt_u128)b);
}
// |x| as its unsigned bits (the magnitude of -2^127 is 2^127)
GT_HD gt_u128 gt_u128_mag(gt_i128 x) {
  return x < 0 ? (gt_u128)0 - (gt_u128)x : (gt_u128)x;
}
GT_HD int gt_clz128(gt_u128 x) {
  const uint64_t hi = (uint64_t)(x >> 64), lo = (uint64_t)x;
#ifdef __CUDA_ARCH__
  return hi ? __clzll((long long)hi) : 64 + (lo ? __clzll((long long)lo) : 64);
#else
  return hi ? __builtin_clzll(hi) : 64 + (lo ? __builtin_clzll(lo) : 64);
#endif
}
// unsigned a / b and a % b for b != 0: one 64-bit division when both fit,
// else shift and subtract over the quotient's bits
GT_HD gt_u128 gt_udivmod128(gt_u128 a, gt_u128 b, gt_u128* rem) {
  if (((a | b) >> 64) == 0) {
    const uint64_t q = (uint64_t)a / (uint64_t)b;
    *rem = (uint64_t)a - q * (uint64_t)b;
    return q;
  }
  const int shift = gt_clz128(b) - gt_clz128(a);
  if (shift < 0) {
    *rem = a;
    return 0;
  }
  b <<= shift;
  gt_u128 q = 0;
  for (int k = 0; k <= shift; ++k) {
    q <<= 1;
    if (a >= b) {
      a -= b;
      q |= 1;
    }
    b >>= 1;
  }
  *rem = a;
  return q;
}
// signed division with C semantics (the quotient truncates, the remainder
// takes the dividend's sign) on the magnitudes' bits, as utils/int128's
// divmod128 restores them; b != 0
GT_HD void gt_divmod128(gt_i128 a, gt_i128 b, gt_i128* q, gt_i128* r) {
  gt_u128 ur;
  const gt_u128 uq = gt_udivmod128(gt_u128_mag(a), gt_u128_mag(b), &ur);
  *q = ((a < 0) != (b < 0)) ? gt_i128_neg((gt_i128)uq) : (gt_i128)uq;
  *r = (a < 0) ? gt_i128_neg((gt_i128)ur) : (gt_i128)ur;
}
// x * 10^k mod 2^128 (p = 10^k)
GT_HD gt_i128 gt_mul_pow10(gt_i128 x, gt_u128 p) {
  return (gt_i128)((gt_u128)x * p);
}
// round(x / 10^k) half away from zero, as utils/int128.div_pow10_round:
// the magnitude (signed: -2^127 stays negative) is divided as a signed
// value, its remainder doubled and held against 10^k
GT_HD gt_i128 gt_div_pow10_round(gt_i128 x, gt_u128 p) {
  const bool sign = x < 0;
  const gt_i128 a = gt_i128_abs(x);
  gt_i128 q, r;
  gt_divmod128(a, (gt_i128)p, &q, &r);
  const gt_i128 r2 = (gt_i128)((gt_u128)r << 1);
  q = gt_i128_add(q, r2 >= (gt_i128)p ? 1 : 0);
  return sign ? gt_i128_neg(q) : q;
}
// int64 x int64 -> int128 (exact), as int128.mul_i64
GT_HD gt_i128 gt_mul_i64(int64_t a, int64_t b) {
  const uint64_t ua = a < 0 ? (uint64_t)0 - (uint64_t)a : (uint64_t)a;
  const uint64_t ub = b < 0 ? (uint64_t)0 - (uint64_t)b : (uint64_t)b;
  const gt_u128 p = (gt_u128)ua * ub;
  return ((a < 0) != (b < 0)) ? (gt_i128)((gt_u128)0 - p) : (gt_i128)p;
}
// int128 x int64 -> int128 mod 2^128, as int128.mul128_i64
GT_HD gt_i128 gt_mul128_i64(gt_i128 a, int64_t m) {
  const uint64_t um = m < 0 ? (uint64_t)0 - (uint64_t)m : (uint64_t)m;
  const gt_u128 p = gt_u128_mag(a) * (gt_u128)um;
  return ((a < 0) != (m < 0)) ? (gt_i128)((gt_u128)0 - p) : (gt_i128)p;
}
// decimal divide: x is the dividend already scaled, a and b the operands
// as given (their signs pick the rounding direction); quotient rounded
// half away from zero, 0 for a zero divisor
GT_HD gt_i128 gt_dec_divide(gt_i128 x, gt_i128 a, gt_i128 b) {
  if (b == 0) return 0;
  gt_i128 q, r;
  gt_divmod128(x, b, &q, &r);
  const gt_i128 r2 = (gt_i128)((gt_u128)gt_i128_abs(r) << 1);
  if (r2 >= gt_i128_abs(b)) {
    q = ((a < 0) != (b < 0)) ? gt_i128_sub(q, 1) : gt_i128_add(q, 1);
  }
  return q;
}
GT_HD gt_i128 gt_dec_mod(gt_i128 a, gt_i128 b) {
  if (b == 0) return 0;
  gt_i128 q, r;
  gt_divmod128(a, b, &q, &r);
  return r;
}

// -- runtime errors ------------------------------------------------------------
GT_HD void gt_flag(unsigned int* flags, int site) {
#ifdef __CUDA_ARCH__
  atomicOr(flags + (site >> 5), 1u << (site & 31));
#else
  flags[site >> 5] |= 1u << (site & 31);
#endif
}
