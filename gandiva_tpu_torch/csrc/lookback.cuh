// Decoupled look-back for single-pass scans over tiles, shared by K2's
// prefix sum (compaction_fragnet.cu) and the join build's two scans
// (join_build.cu).
//
// Each tile publishes one 64-bit descriptor in ``status[tile]``: its state
// in the top two bits (0 while nothing is published, kStatusAggregate for
// the tile's own value, kStatusPrefix for its inclusive prefix) and a value
// in [0, 2^62) in the rest. One atomic store publishes it, so no fence is
// needed before it (a __threadfence here, on the look-back's critical path,
// was measurably slower for K2: PERF.md). The caller zeroes ``status``
// before each launch, and each CTA takes its tile from an atomic ticket in
// the scan's order, so a tile waits only on tiles taken before it, by CTAs
// that are running, and the look-back always makes progress.
//
// The scan's operator ``Op`` gives:
//   kIdentity     the value that changes nothing, in [0, 2^62);
//   kFromRight    the scan runs from the last tile down (else from tile 0 up);
//   kNearestEnds  the nearest tile whose value is not kIdentity holds the
//                 answer by itself, so it ends the look-back as a prefix
//                 does (true of a min over positions, scanned from the right);
//   combine(a, b) the associative operator.
#pragma once

#include <cuda_runtime.h>

namespace gt_lookback {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kValueBits = 62;
constexpr unsigned long long kValueMask = (1ull << kValueBits) - 1;
constexpr unsigned long long kStatusAggregate = 1ull;
constexpr unsigned long long kStatusPrefix = 2ull;

__device__ __forceinline__ unsigned long long descriptor(
    unsigned long long status, long long value) {
  return (status << kValueBits) | static_cast<unsigned long long>(value);
}

__device__ __forceinline__ unsigned long long status_of(unsigned long long d) {
  return d >> kValueBits;
}

__device__ __forceinline__ long long value_of(unsigned long long d) {
  return static_cast<long long>(d & kValueMask);
}

__device__ __forceinline__ unsigned long long read_descriptor(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long desc) {
  atomicExch(p, desc);
}

template <class Op>
__device__ __forceinline__ long long warp_reduce(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = Op::combine(v, __shfl_xor_sync(kFull, v, d));
  }
  return v;
}

// Called by warp 0 of the CTA that holds ``tile`` of ``tiles``, with the
// tile's own value in every lane: publishes it, reads the 32 tiles before it
// in the scan's order at once, one a lane (spinning with __nanosleep
// back-off while any is still empty), combines them up to the nearest that
// ends the look-back (or all 32, and moves 32 tiles further), publishes the
// tile's inclusive prefix and returns the exclusive one to every lane. The
// scan's first tile publishes its prefix at once and returns kIdentity.
template <class Op>
__device__ __forceinline__ long long look_back(unsigned long long* status,
                                               long long tile,
                                               long long tiles,
                                               long long value) {
  const int lane = threadIdx.x & 31;
  if (tile == (Op::kFromRight ? tiles - 1 : 0)) {
    if (lane == 0) publish(&status[tile], descriptor(kStatusPrefix, value));
    return Op::kIdentity;
  }
  if (lane == 0) publish(&status[tile], descriptor(kStatusAggregate, value));
  long long exclusive = Op::kIdentity;
  for (long long k = 1;; k += 32) {
    // lane 0 reads the nearest tile; past the scan's first tile lies a
    // prefix of kIdentity
    const long long i = Op::kFromRight ? tile + k + lane : tile - k - lane;
    const bool inside = Op::kFromRight ? i < tiles : i >= 0;
    unsigned long long d = inside ? read_descriptor(&status[i])
                                  : descriptor(kStatusPrefix, Op::kIdentity);
    unsigned sleep_ns = 32;
    while (__any_sync(kFull, status_of(d) == 0)) {
      if (status_of(d) == 0) {
        __nanosleep(sleep_ns);
        d = read_descriptor(&status[i]);
      }
      if (sleep_ns < 1024) sleep_ns <<= 1;
    }
    const unsigned ends = __ballot_sync(
        kFull, status_of(d) == kStatusPrefix ||
                   (Op::kNearestEnds && value_of(d) != Op::kIdentity));
    // lanes up to the nearest that ends the look-back count, all 32 if none
    const int last = ends ? __ffs(ends) - 1 : 31;
    exclusive = Op::combine(exclusive, warp_reduce<Op>(
        lane <= last ? value_of(d) : Op::kIdentity));
    if (ends) break;
  }
  if (lane == 0) {
    publish(&status[tile],
            descriptor(kStatusPrefix, Op::combine(exclusive, value)));
  }
  return exclusive;
}

}  // namespace gt_lookback
