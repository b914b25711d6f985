// The tile code shared by the two stream compactions, K1 (compaction.cu)
// and K2 (compaction_fragnet.cu), for Hopper, sm_90a.
//
// A tile is kTile = kThreads * kIters rows, one CTA. Both kernels take the
// tile's ballots (one 32-bit word per 32-row slot) and rank each survivor
// inside the tile by an exclusive scan of the slot counts. K1 learns a
// tile's offset from a separate count pass and a scan on the host side and
// moves its row index and every payload to tile_offset + rank from
// registers (scatter_tile); K2 learns it by a decoupled look-back among the
// tiles and moves the payloads through shared memory (its own code).
// ``scatter_kernel`` is the offsets-given scatter: K1's second pass, and
// K2's launch for payload groups after the first.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 16;
constexpr int kTile = kThreads * kIters;  // rows per CTA
constexpr int kSlots = kIters * kWarps;   // 32-row groups per tile
constexpr int kMaxPayloads = 8;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSlots == 4 * 32, "the shared-memory scan gives each lane 4 slots");

struct Payloads {
  const void* in[kMaxPayloads];
  void* out[kMaxPayloads];
  int width[kMaxPayloads];  // bytes per element: 1, 2, 4 or 8
  int count;
};

inline unsigned num_tiles(long long n) {
  return static_cast<unsigned>((n + kTile - 1) / kTile);
}

// Fills ``p`` from the caller's arrays; false if it takes more than
// kMaxPayloads columns.
inline bool make_payloads(int num_payloads, const void* const* ins,
                          void* const* outs, const int* widths, Payloads* p) {
  if (num_payloads < 0 || num_payloads > kMaxPayloads) return false;
  *p = Payloads{};
  p->count = num_payloads;
  for (int k = 0; k < num_payloads; ++k) {
    p->in[k] = ins[k];
    p->out[k] = outs[k];
    p->width[k] = widths[k];
  }
  return true;
}

// This thread's ballots over the tile at ``base``: ballot[j] covers rows
// base + j * kThreads + 32 * warp + (0..31). Lane 0 of each warp writes the
// survivor count of slot s = j * kWarps + warp, so slot order is row order.
__device__ __forceinline__ void tile_ballots(const uint8_t* __restrict__ mask,
                                             long long n, long long base,
                                             unsigned (&ballot)[kIters],
                                             int* slot_offset) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const long long row = base + j * kThreads + threadIdx.x;
    const bool keep = row < n && mask[row] != 0;
    ballot[j] = __ballot_sync(kFull, keep);
    if (lane == 0) slot_offset[j * kWarps + warp] = __popc(ballot[j]);
  }
}

// Called by warp 0 alone: replaces the kSlots counts by their exclusive
// scan, 4 slots per lane, and returns the tile's survivor count to every
// lane.
__device__ __forceinline__ int scan_slots(int* slot_offset) {
  const int lane = threadIdx.x & 31;
  int v[4];
  int local = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = slot_offset[lane * 4 + k];
    local += v[k];
  }
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  int run = incl - local;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    slot_offset[lane * 4 + k] = run;
    run += v[k];
  }
  return __shfl_sync(kFull, incl, 31);
}

// Moves one payload column's survivors of this thread: all kIters loads are
// started before any store, so each thread keeps them in flight together
// (copying element by element through untyped pointers serialises them).
template <typename T>
__device__ __forceinline__ void move_column(const void* in_, void* out_,
                                            const unsigned (&ballot)[kIters],
                                            const int (&dst)[kIters],
                                            long long base, int lane) {
  const T* __restrict__ in = static_cast<const T*>(in_);
  T* __restrict__ out = static_cast<T*>(out_);
  T v[kIters];
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    if ((ballot[j] >> lane) & 1u) v[j] = in[base + j * kThreads + threadIdx.x];
  }
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    if ((ballot[j] >> lane) & 1u) out[dst[j]] = v[j];
  }
}

// Every survivor of this thread writes its row index (unless ``idx_out`` is
// null) and each payload to tile_offset + slot_offset[slot] + its rank in
// the slot. Survivors of one warp-step land on consecutive output slots, so
// the stores coalesce. n < 2^31, so every destination fits an int.
__device__ __forceinline__ void scatter_tile(int tile_offset,
                                             const unsigned (&ballot)[kIters],
                                             const int* slot_offset,
                                             long long base,
                                             int32_t* __restrict__ idx_out,
                                             const Payloads& p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int dst[kIters];
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    dst[j] = tile_offset + slot_offset[j * kWarps + warp] +
             __popc(ballot[j] & below);
    if (idx_out != nullptr && ((ballot[j] >> lane) & 1u)) {
      idx_out[dst[j]] = static_cast<int32_t>(base + j * kThreads + threadIdx.x);
    }
  }
  for (int k = 0; k < p.count; ++k) {
    switch (p.width[k]) {
      case 8: move_column<uint64_t>(p.in[k], p.out[k], ballot, dst, base, lane); break;
      case 4: move_column<uint32_t>(p.in[k], p.out[k], ballot, dst, base, lane); break;
      case 2: move_column<uint16_t>(p.in[k], p.out[k], ballot, dst, base, lane); break;
      default: move_column<uint8_t>(p.in[k], p.out[k], ballot, dst, base, lane); break;
    }
  }
}

// The offsets-given scatter: tile blockIdx.x moves its survivors to
// block_offsets[blockIdx.x] + rank.
//
// At most 128 registers, so two CTAs share an SM: uncapped, the kIters
// loads held in flight per thread take 149 registers and one CTA per SM
// (0.68 ms at the flagship shape on an H100 SXM, against 0.48 ms capped;
// a cap of three CTAs spills and takes 0.80 ms — PERF.md).
__global__ void __launch_bounds__(kThreads, 2)
scatter_kernel(const uint8_t* __restrict__ mask, long long n,
               const int32_t* __restrict__ block_offsets,
               int32_t* __restrict__ idx_out, Payloads p) {
  __shared__ int slot_offset[kSlots];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  unsigned ballot[kIters];
  tile_ballots(mask, n, base, ballot, slot_offset);
  __syncthreads();
  if ((threadIdx.x >> 5) == 0) scan_slots(slot_offset);
  __syncthreads();
  scatter_tile(block_offsets[blockIdx.x], ballot, slot_offset, base, idx_out,
               p);
}

}  // namespace
