// The helpers every generated plan kernel uses (compiler/codegen.py pastes
// this file at the head of each generated source).
//
// A generated source builds two ways: with nvcc for sm_90a (the card's
// route; nvcc's defaults, as torch's own kernels are built: IEEE division
// and square root, and contraction into FMAs allowed, so a CUDA math
// function compiles as in torch's kernel) and with g++ -ffp-contract=off
// for the host (the tests' route). The per-row body is a __host__
// __device__ function, so both builds run the same arithmetic. Every float
// product and sum of the body goes through gt_fmul / gt_fadd / gt_fsub,
// which nvcc never contracts: each rounds by itself, as the eager route's
// separate torch kernels round them.
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

// a dictionary code clamped into a host table of n >= 1 entries, as the
// eager route's gather_by_code clamps it
GT_HD int64_t gt_code(int64_t c, int64_t n) {
  return c < 0 ? 0 : c >= n ? n - 1 : c;
}

// -- wrapping integer arithmetic ------------------------------------------
// the unsigned type arithmetic of T is done in: at least 32 bits, so no
// operand is promoted to a signed int
template <class T>
using gt_uw = typename std::conditional<
    (sizeof(T) < 4), uint32_t, typename std::make_unsigned<T>::type>::type;

// float product, sum and difference rounded each by itself (the device's
// _rn intrinsics are never merged into an FMA)
template <class F> GT_HD F gt_fmul(F a, F b) {
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same<F, float>::value) return __fmul_rn(a, b);
  else return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
template <class F> GT_HD F gt_fadd(F a, F b) {
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same<F, float>::value) return __fadd_rn(a, b);
  else return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
template <class F> GT_HD F gt_fsub(F a, F b) {
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same<F, float>::value) return __fsub_rn(a, b);
  else return __dsub_rn(a, b);
#else
  return a - b;
#endif
}

// a * b + c rounded once (the eager route's fma_f64 emulates it)
GT_HD double gt_fma(double a, double b, double c) {
#ifdef __CUDA_ARCH__
  return __fma_rn(a, b, c);
#else
  return fma(a, b, c);
#endif
}

template <class T> GT_HD T gt_add(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) return gt_fadd(a, b);
  else return (T)((gt_uw<T>)a + (gt_uw<T>)b);
}
template <class T> GT_HD T gt_sub(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) return gt_fsub(a, b);
  else return (T)((gt_uw<T>)a - (gt_uw<T>)b);
}
template <class T> GT_HD T gt_mul(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) return gt_fmul(a, b);
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
    if (s < 0) return gt_fmul((F)(int64_t)((x >> 1) | (x & 1)), (F)2);
    return (F)s;
  } else {
    return (F)x;
  }
}
template <class F> GT_HD F gt_floor(F x) {
  if constexpr (std::is_same<F, float>::value) return floorf(x);
  else return floor(x);
}
template <class F> GT_HD F gt_ceil(F x) {
  if constexpr (std::is_same<F, float>::value) return ceilf(x);
  else return ceil(x);
}
template <class F> GT_HD F gt_trunc(F x) {
  if constexpr (std::is_same<F, float>::value) return truncf(x);
  else return trunc(x);
}
// the sign of a float, with ±0 and NaN mapped to themselves
template <class F> GT_HD F gt_fsign(F x) {
  return (x == 0 || x != x) ? x : (x > 0 ? (F)1 : (F)-1);
}
// round half away from zero in x's own type: sign(x) * floor(|x| + 0.5)
template <class F> GT_HD F gt_round_half_away(F x) {
  return gt_fmul(gt_fsign(x), gt_floor(gt_fadd(gt_abs(x), (F)0.5)));
}
// NaN or ±inf
GT_HD bool gt_nonfinite(double x) {
  return !(fabs(x) <= 1.7976931348623157e308);
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
// round(a * b / 10^k) half away from zero through the full 256-bit
// product, the quotient truncated to 128 bits, as int128.mul256_div_pow10
// (both operands over 18 digits): the magnitudes' product (|-2^127| is
// 2^127) in four 64-bit words, plus half = 5 * 10^(k-1) (its words h0..h3,
// low first; 0 when k = 0), divided by 10^k at most 10^19 at a time
GT_HD gt_i128 gt_mul256_div_pow10(gt_i128 a, gt_i128 b, int k, uint64_t h0,
                                  uint64_t h1, uint64_t h2, uint64_t h3) {
  const gt_u128 x = gt_u128_mag(a), y = gt_u128_mag(b);
  const uint64_t x0 = (uint64_t)x, x1 = (uint64_t)(x >> 64);
  const uint64_t y0 = (uint64_t)y, y1 = (uint64_t)(y >> 64);
  const gt_u128 p00 = (gt_u128)x0 * y0, p01 = (gt_u128)x0 * y1;
  const gt_u128 p10 = (gt_u128)x1 * y0, p11 = (gt_u128)x1 * y1;
  uint64_t w[4];
  w[0] = (uint64_t)p00;
  const gt_u128 mid = (p00 >> 64) + (uint64_t)p01 + (uint64_t)p10;
  w[1] = (uint64_t)mid;
  const gt_u128 top = (mid >> 64) + (p01 >> 64) + (p10 >> 64) + (uint64_t)p11;
  w[2] = (uint64_t)top;
  w[3] = (uint64_t)(top >> 64) + (uint64_t)(p11 >> 64);
  const uint64_t h[4] = {h0, h1, h2, h3};
  gt_u128 carry = 0;
  for (int j = 0; j < 4; ++j) {
    const gt_u128 t = (gt_u128)w[j] + h[j] + carry;
    w[j] = (uint64_t)t;
    carry = t >> 64;
  }
  for (int left = k; left > 0;) {
    const int step = left < 19 ? left : 19;
    left -= step;
    uint64_t d = 1;
    for (int j = 0; j < step; ++j) d *= 10;
    gt_u128 r = 0;
    for (int j = 3; j >= 0; --j) {          // r < d: each quotient fits
      const gt_u128 t = (r << 64) | w[j];
      w[j] = (uint64_t)gt_udivmod128(t, d, &r);
    }
  }
  const gt_u128 q = ((gt_u128)w[1] << 64) | w[0];
  return (a < 0) != (b < 0) ? (gt_i128)((gt_u128)0 - q) : (gt_i128)q;
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

// x's magnitude below 10^k (p = 10^k) as a signed compare: -2^127, whose
// magnitude reads negative, passes, as the limb route's cmp128 lets it
GT_HD bool gt_dec_fits(gt_i128 x, gt_u128 p) {
  return gt_i128_abs(x) < (gt_i128)p;
}
// int128 -> float64 as utils/int128.to_float64: the magnitude's words
// (hi, lo), each as an unsigned value with one rounding, hi * 2^64 + lo
GT_HD double gt_dec_to_f64(gt_i128 x) {
  const gt_u128 a = (gt_u128)gt_i128_abs(x);
  const double f = gt_fadd(
      gt_fmul(gt_to_float<double, uint64_t>((uint64_t)(a >> 64)),
              18446744073709551616.0),
      gt_to_float<double, uint64_t>((uint64_t)a));
  return x < 0 ? -f : f;
}
// the decimal round family to k fewer digits (p = 10^k, k > 0), as
// decimal_ops._round_family: kind 0 round (half away from zero), 1
// truncate, 2 ceiling, 3 floor
GT_HD gt_i128 gt_dec_round(gt_i128 x, gt_u128 p, int kind) {
  if (kind == 0) return gt_div_pow10_round(x, p);
  gt_i128 q, r;
  gt_divmod128(x, (gt_i128)p, &q, &r);
  if (kind == 2 && r != 0 && !(x < 0)) return gt_i128_add(q, 1);
  if (kind == 3 && r != 0 && x < 0) return gt_i128_sub(q, 1);
  return q;
}

// -- floor division: torch's // and % on integer tensors -------------------
// a // b and a % b rounding toward -inf (the remainder takes b's sign);
// b != 0, and MIN // -1 wraps as torch does
GT_HD int64_t gt_floordiv_i64(int64_t a, int64_t b) {
  if (b == -1) return gt_neg(a);
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
GT_HD int64_t gt_floormod_i64(int64_t a, int64_t b) {
  if (b == -1) return 0;
  const int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// -- the civil calendar (registry/datetime_ops.py) ---------------------------
// Howard Hinnant's days <-> (year, month, day), in int64 with torch's
// floor division and wrapping add, subtract and multiply, operation for
// operation as the eager route runs them on whole columns
#define GT_MS_PER_DAY ((int64_t)86400000)
GT_HD void gt_civil_from_days(int64_t days, int64_t* year, int64_t* month,
                              int64_t* day) {
  const int64_t z = gt_add<int64_t>(days, 719468);
  const int64_t era = gt_floordiv_i64(z, 146097);
  const int64_t doe = gt_sub<int64_t>(z, gt_mul<int64_t>(era, 146097));
  const int64_t yoe = gt_floordiv_i64(
      doe - gt_floordiv_i64(doe, 1460) + gt_floordiv_i64(doe, 36524) -
          gt_floordiv_i64(doe, 146096), 365);
  const int64_t y = gt_add<int64_t>(yoe, gt_mul<int64_t>(era, 400));
  const int64_t doy = doe - (365 * yoe + gt_floordiv_i64(yoe, 4) -
                             gt_floordiv_i64(yoe, 100));
  const int64_t mp = gt_floordiv_i64(5 * doy + 2, 153);
  *day = doy - gt_floordiv_i64(153 * mp + 2, 5) + 1;
  *month = mp < 10 ? mp + 3 : mp - 9;
  *year = gt_add<int64_t>(y, *month <= 2 ? 1 : 0);
}
// one part of the civil date: 0 the year, 1 the month, 2 the day
GT_HD int64_t gt_civil(int64_t days, int part) {
  int64_t y, m, d;
  gt_civil_from_days(days, &y, &m, &d);
  return part == 0 ? y : part == 1 ? m : d;
}
GT_HD int64_t gt_year_of(int64_t days) { return gt_civil(days, 0); }
GT_HD int64_t gt_days_from_civil(int64_t year, int64_t m, int64_t d) {
  const int64_t y = gt_sub<int64_t>(year, m <= 2 ? 1 : 0);
  const int64_t era = gt_floordiv_i64(y, 400);
  const int64_t yoe = gt_sub<int64_t>(y, gt_mul<int64_t>(era, 400));
  const int64_t mp = m > 2 ? m - 3 : m + 9;
  const int64_t doy = gt_floordiv_i64(153 * mp + 2, 5) + d - 1;
  const int64_t doe = gt_add<int64_t>(
      gt_sub<int64_t>(gt_add<int64_t>(gt_mul<int64_t>(yoe, 365),
                                      gt_floordiv_i64(yoe, 4)),
                      gt_floordiv_i64(yoe, 100)), doy);
  return gt_sub<int64_t>(gt_add<int64_t>(gt_mul<int64_t>(era, 146097), doe),
                         719468);
}
GT_HD bool gt_is_leap(int64_t y) {
  return gt_floormod_i64(y, 4) == 0 &&
         (gt_floormod_i64(y, 100) != 0 || gt_floormod_i64(y, 400) == 0);
}
// the non-leap month lengths as two bits a month of one constant, plus
// February's leap day; m in 1..12
GT_HD int64_t gt_days_in_month(int64_t y, int64_t m) {
  const int64_t d = 28 + ((0x3BBEECC >> (2 * m)) & 3);
  return (m == 2 && gt_is_leap(y)) ? 29 : d;
}
// SQL's day of week, 1 = Sunday (1970-01-01 was a Thursday), and ISO's,
// 1 = Monday
GT_HD int64_t gt_dow(int64_t days) {
  return gt_floormod_i64(gt_add<int64_t>(days, 4), 7) + 1;
}
GT_HD int64_t gt_iso_dow(int64_t days) {
  return gt_floormod_i64(gt_add<int64_t>(days, 3), 7) + 1;
}
GT_HD int64_t gt_doy(int64_t days) {
  const int64_t first = gt_days_from_civil(gt_year_of(days), 1, 1);
  return gt_add<int64_t>(gt_sub<int64_t>(days, first), 1);
}
GT_HD int64_t gt_weeks_in_iso_year(int64_t y) {
  const int64_t p = gt_floormod_i64(
      y + gt_floordiv_i64(y, 4) - gt_floordiv_i64(y, 100) +
          gt_floordiv_i64(y, 400), 7);
  const int64_t py = y - 1;
  const int64_t pp = gt_floormod_i64(
      py + gt_floordiv_i64(py, 4) - gt_floordiv_i64(py, 100) +
          gt_floordiv_i64(py, 400), 7);
  return 52 + ((p == 4 || pp == 3) ? 1 : 0);
}
// ISO-8601 week number
GT_HD int64_t gt_iso_week(int64_t days) {
  const int64_t y = gt_year_of(days);
  const int64_t w0 = gt_floordiv_i64(gt_doy(days) - gt_iso_dow(days) + 10, 7);
  if (w0 < 1) return gt_weeks_in_iso_year(y - 1);
  return w0 > gt_weeks_in_iso_year(y) ? 1 : w0;
}
// date_trunc to a unit of days: 0 year, 1 quarter, 2 month, 3 week (to
// Monday), 4 decade, 5 century, 6 millennium
GT_HD int64_t gt_trunc_days(int64_t days, int unit) {
  int64_t y, m, d;
  gt_civil_from_days(days, &y, &m, &d);
  switch (unit) {
    case 0: return gt_days_from_civil(y, 1, 1);
    case 1: return gt_days_from_civil(y, gt_floordiv_i64(m - 1, 3) * 3 + 1, 1);
    case 2: return gt_days_from_civil(y, m, 1);
    case 3: return gt_sub<int64_t>(days, gt_iso_dow(days) - 1);
    case 4: return gt_days_from_civil(gt_floordiv_i64(y, 10) * 10, 1, 1);
    case 5:
      return gt_days_from_civil(gt_floordiv_i64(y + 99, 100) * 100 - 99, 1, 1);
    default:
      return gt_days_from_civil(gt_floordiv_i64(y + 999, 1000) * 1000 - 999,
                                1, 1);
  }
}
// the date `months` months on, its day clamped to the month's last
GT_HD int64_t gt_add_months_days(int64_t days, int64_t months) {
  int64_t y, m, d;
  gt_civil_from_days(days, &y, &m, &d);
  const int64_t tot = gt_add<int64_t>(
      gt_add<int64_t>(gt_mul<int64_t>(y, 12), m - 1), months);
  const int64_t ny = gt_floordiv_i64(tot, 12);
  const int64_t nm = gt_floormod_i64(tot, 12) + 1;
  const int64_t dim = gt_days_in_month(ny, nm);
  return gt_days_from_civil(ny, nm, d < dim ? d : dim);
}
GT_HD int64_t gt_ts_plus_months(int64_t ms, int64_t months) {
  const int64_t day = gt_floordiv_i64(ms, GT_MS_PER_DAY);
  const int64_t time = gt_sub<int64_t>(ms, gt_mul<int64_t>(day, GT_MS_PER_DAY));
  return gt_add<int64_t>(
      gt_mul<int64_t>(gt_add_months_days(day, months), GT_MS_PER_DAY), time);
}
// months_between(ms1, ms2): r1 = 1 / 86,400,000 and r31 = 1 / 31, the
// reciprocals the eager route multiplies by; (t1 - t2) * r1 + (dd1 - dd2)
// is one fused multiply-add, as the reference's compiled program fuses it
GT_HD double gt_months_between(int64_t ms1, int64_t ms2, double r1,
                               double r31) {
  const int64_t d1 = gt_floordiv_i64(ms1, GT_MS_PER_DAY);
  const int64_t d2 = gt_floordiv_i64(ms2, GT_MS_PER_DAY);
  int64_t y1, m1, dd1, y2, m2, dd2;
  gt_civil_from_days(d1, &y1, &m1, &dd1);
  gt_civil_from_days(d2, &y2, &m2, &dd2);
  const double months = (double)gt_add<int64_t>(
      gt_mul<int64_t>(gt_sub<int64_t>(y1, y2), 12), m1 - m2);
  if (dd1 == gt_days_in_month(y1, m1) && dd2 == gt_days_in_month(y2, m2))
    return months;
  const int64_t t1 = gt_sub<int64_t>(ms1, gt_mul<int64_t>(d1, GT_MS_PER_DAY));
  const int64_t t2 = gt_sub<int64_t>(ms2, gt_mul<int64_t>(d2, GT_MS_PER_DAY));
  const double frac = gt_fmul(
      gt_fma((double)gt_sub<int64_t>(t1, t2), r1, (double)(dd1 - dd2)), r31);
  return gt_fadd(months, frac);
}
// timestampdiff in months, truncated toward zero on a partial month, then
// floor-divided by `per` (1, 3 or 12)
GT_HD int64_t gt_timestampdiff_months(int64_t t1, int64_t t2, int64_t per) {
  const int64_t d1 = gt_floordiv_i64(t1, GT_MS_PER_DAY);
  const int64_t d2 = gt_floordiv_i64(t2, GT_MS_PER_DAY);
  int64_t y1, m1, dd1, y2, m2, dd2;
  gt_civil_from_days(d1, &y1, &m1, &dd1);
  gt_civil_from_days(d2, &y2, &m2, &dd2);
  const int64_t months = gt_add<int64_t>(
      gt_mul<int64_t>(gt_sub<int64_t>(y2, y1), 12), m2 - m1);
  const int64_t p1 = gt_add<int64_t>(
      dd1 * GT_MS_PER_DAY,
      gt_sub<int64_t>(t1, gt_mul<int64_t>(d1, GT_MS_PER_DAY)));
  const int64_t p2 = gt_add<int64_t>(
      dd2 * GT_MS_PER_DAY,
      gt_sub<int64_t>(t2, gt_mul<int64_t>(d2, GT_MS_PER_DAY)));
  const int64_t adj = (months > 0 && p2 < p1) ? -1
                      : (months < 0 && p2 > p1) ? 1 : 0;
  return gt_floordiv_i64(gt_add<int64_t>(months, adj), per);
}
// timestampdiff in a unit of `unit` ms: sign(t2 - t1) * (|t2 - t1| // unit)
GT_HD int64_t gt_timestampdiff_fixed(int64_t t1, int64_t t2, int64_t unit) {
  const int64_t diff = gt_sub<int64_t>(t2, t1);
  const int64_t s = (diff > 0) - (diff < 0);
  return gt_mul<int64_t>(s, gt_floordiv_i64(gt_abs(diff), unit));
}
GT_HD int64_t gt_last_day_days(int64_t days) {
  int64_t y, m, d;
  gt_civil_from_days(days, &y, &m, &d);
  return gt_days_from_civil(y, m, gt_days_in_month(y, m));
}
// an interval_day ((days << 32) | millis) as milliseconds
GT_HD int64_t gt_interval_day_ms(int64_t v) {
  return gt_add<int64_t>(gt_mul<int64_t>(v >> 32, GT_MS_PER_DAY),
                         v & (int64_t)0xFFFFFFFF);
}
GT_HD int64_t gt_interval_day_of_ms(int64_t ms) {
  const int64_t days = gt_floordiv_i64(ms, GT_MS_PER_DAY);
  return (int64_t)((uint64_t)days << 32) |
         gt_sub<int64_t>(ms, gt_mul<int64_t>(days, GT_MS_PER_DAY));
}

// -- hashes (utils/hashing.py) -------------------------------------------------
// the murmur3 fmix32 finalizer and a boost-style chainable combine, in
// uint32 arithmetic (the eager route's int64 lanes masked to 32 bits)
GT_HD uint32_t gt_fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}
GT_HD uint32_t gt_combine(uint32_t seed, uint32_t v) {
  return seed ^ (gt_fmix32(v) + 0x9E3779B9u + (seed << 6) + (seed >> 2));
}
// a value as the 32-bit lanes the hash chains: one lane of 32 bits or
// fewer (signed types sign-extend, unsigned ones and bool zero-extend), a
// 64-bit value as (lo, hi); floats by their bits with -0.0 taken as +0.0
// (NaN keeps its bits)
template <class T> GT_HD uint32_t gt_hash32(T x, uint32_t seed) {
  if constexpr (std::is_floating_point<T>::value) {
    if (x == 0) x = 0;
  }
  if constexpr (sizeof(T) == 8) {
    uint64_t b;
    memcpy(&b, &x, 8);
    return gt_combine(gt_combine(seed, (uint32_t)b), (uint32_t)(b >> 32));
  } else if constexpr (std::is_same<T, float>::value) {
    uint32_t b;
    memcpy(&b, &x, 4);
    return gt_combine(seed, b);
  } else {
    return gt_combine(seed, (uint32_t)x);
  }
}
// two independent 32-bit chains: the seed's low word, and its high word
// xor 0xDEADBEEF
template <class T> GT_HD uint64_t gt_hash64(T x, uint64_t seed) {
  const uint32_t lo = gt_hash32(x, (uint32_t)seed);
  const uint32_t hi = gt_hash32(x, (uint32_t)(seed >> 32) ^ 0xDEADBEEFu);
  return ((uint64_t)hi << 32) | lo;
}

// -- runtime errors ------------------------------------------------------------
GT_HD void gt_flag(unsigned int* flags, int site) {
#ifdef __CUDA_ARCH__
  atomicOr(flags + (site >> 5), 1u << (site & 31));
#else
  flags[site >> 5] |= 1u << (site & 31);
#endif
}
