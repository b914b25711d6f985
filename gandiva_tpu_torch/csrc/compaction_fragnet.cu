// Single-pass stable stream compaction with decoupled look-back (kernel K2)
// for Hopper, sm_90a.
//
// Replaces gandiva_tpu/ops/kernels/compaction_pallas.py::_kernel_fragnet
// (driven by compact_pallas_u32_fragnet there). That kernel computes K1's
// function through a TPU placement: a lane butterfly, a log-roll scan of
// per-chunk counts and a fragment shift-merge network over (8, 128) vector
// tiles, on a grid that runs in order on one core. None of that carries
// over. The contract is K1's: a bool mask of n rows and any number of
// payload columns of 1, 2, 4 or 8 bytes go in; the survivors come out packed
// to the front in row order with their int32 row indices, every output of n
// rows and meaningful on [:count]; ``count`` is written by the kernel, so the
// caller never syncs the host.
//
// Bound: bytes. Per row it must read the mask byte and each payload element;
// per survivor it must write a 4-byte index and each payload element. K1
// reads the mask twice (a count pass, then the scatter); K2 reads it once,
// which is what a single pass buys.
//
// Design: one CTA per tile of kTile = 4096 rows (K1's tile,
// compaction_tile.cuh), in one launch.
//   1. Tile order: thread 0 takes the CTA's tile id from an atomic counter
//      (the last word of ``status``), not from blockIdx. A CTA only ever
//      waits on tiles with smaller ids, which belong to CTAs that started
//      before it and are running, so the look-back always makes progress,
//      however many tiles there are and in whatever order Hopper schedules
//      the CTAs.
//   2. Local count: the CTA reads its mask tile once, keeps one ballot word
//      per 32-row slot in registers and scans the slot counts in shared
//      memory (compaction_tile.cuh); the scan also gives the tile's total.
//   3. Publish: warp 0 writes the tile's aggregate as one 64-bit descriptor
//      (status in the high word, value in the low word) with atomicExch
//      after a __threadfence(). Status and value travel in one word, so a
//      reader can never see a status without its value. Tile 0 publishes
//      its inclusive prefix at once.
//   4. Look back: warp 0 reads the 32 descriptors before its tile at once,
//      one per lane, spinning with __nanosleep back-off while any is still
//      empty; it sums the aggregates up to the nearest inclusive prefix, or
//      all 32 and moves 32 tiles further back. It then publishes its own
//      inclusive prefix.
//   5. Scatter: every survivor writes its index and payloads to
//      prefix + rank, as K1's scatter does (the same code).
//   6. The tile with the last id writes ``count``.
// The caller zeroes ``status`` (one word per tile plus the counter) before
// every launch, so no state survives from one call to the next.
// With more than kMaxPayloads payloads, the first launch also records each
// tile's exclusive prefix in ``tile_offsets``; the later groups use the
// offsets-given scatter of compaction_tile.cuh over them, with no second
// look-back.

#include <cstdint>
#include <cuda_runtime.h>

#include "compaction_tile.cuh"

namespace {

constexpr unsigned long long kStatusAggregate = 1ull;
constexpr unsigned long long kStatusPrefix = 2ull;

__device__ __forceinline__ unsigned long long descriptor(
    unsigned long long status, int value) {
  return (status << 32) | static_cast<unsigned>(value);
}

__device__ __forceinline__ unsigned long long read_descriptor(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long desc) {
  __threadfence();
  atomicExch(p, desc);
}

// Called by warp 0 with the tile's total in every lane: publishes the
// aggregate, looks back to the tile's exclusive prefix, publishes the
// inclusive prefix and returns the exclusive one to every lane.
__device__ __forceinline__ int look_back(unsigned long long* status,
                                         long long tile, int total) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) publish(&status[0], descriptor(kStatusPrefix, total));
    return 0;
  }
  if (lane == 0) publish(&status[tile], descriptor(kStatusAggregate, total));
  int exclusive = 0;
  for (long long end = tile;; end -= 32) {
    // lane 0 reads the nearest predecessor; before tile 0 lies a prefix of 0
    const long long i = end - 1 - lane;
    unsigned long long d = i >= 0 ? read_descriptor(&status[i])
                                  : descriptor(kStatusPrefix, 0);
    unsigned sleep_ns = 32;
    while (__any_sync(kFull, (d >> 32) == 0)) {
      if ((d >> 32) == 0) {
        __nanosleep(sleep_ns);
        d = read_descriptor(&status[i]);
      }
      if (sleep_ns < 1024) sleep_ns <<= 1;
    }
    const unsigned prefixes = __ballot_sync(kFull, (d >> 32) == kStatusPrefix);
    // lanes up to the nearest inclusive prefix count, all 32 if there is none
    const int last = prefixes ? __ffs(prefixes) - 1 : 31;
    int v = lane <= last ? static_cast<int>(d & 0xffffffffull) : 0;
#pragma unroll
    for (int d2 = 16; d2 > 0; d2 >>= 1) v += __shfl_xor_sync(kFull, v, d2);
    exclusive += v;
    if (prefixes) break;
  }
  if (lane == 0) {
    publish(&status[tile], descriptor(kStatusPrefix, exclusive + total));
  }
  return exclusive;
}

// The ballots and the moves are K1's, so the same register cap applies.
__global__ void __launch_bounds__(kThreads, 2)
lookback_kernel(const uint8_t* __restrict__ mask, long long n,
                unsigned long long* __restrict__ status, long long tiles,
                int32_t* __restrict__ tile_offsets,
                int32_t* __restrict__ count, int32_t* __restrict__ idx_out,
                Payloads p) {
  __shared__ int slot_offset[kSlots];
  __shared__ long long s_tile;
  __shared__ int s_offset;
  if (threadIdx.x == 0) {
    s_tile = static_cast<long long>(atomicAdd(&status[tiles], 1ull));
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kTile;
  unsigned ballot[kIters];
  tile_ballots(mask, n, base, ballot, slot_offset);
  __syncthreads();
  if ((threadIdx.x >> 5) == 0) {
    const int total = scan_slots(slot_offset);
    const int offset = look_back(status, tile, total);
    if (threadIdx.x == 0) {
      s_offset = offset;
      if (tile_offsets != nullptr) tile_offsets[tile] = offset;
      if (tile == tiles - 1) *count = offset + total;
    }
  }
  __syncthreads();
  scatter_tile(s_offset, ballot, slot_offset, base, idx_out, p);
}

}  // namespace

extern "C" {

int gt_fragnet_tile_rows() { return kTile; }

int gt_fragnet_max_payloads() { return kMaxPayloads; }

const char* gt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The single pass: ``status`` holds ceil(n / tile) + 1 zeroed 64-bit words
// (the descriptors, then the tile counter); ``tile_offsets`` (may be null)
// receives each tile's exclusive prefix; ``count`` (one int32) the number
// of survivors. ``ins``/``outs`` hold num_payloads device pointers,
// ``widths`` their element sizes.
int gt_fragnet_compact(const void* mask, long long n, void* status,
                       void* tile_offsets, void* count, void* idx_out,
                       int num_payloads, const void* const* ins,
                       void* const* outs, const int* widths, void* stream) {
  if (n <= 0) return 0;
  Payloads p;
  if (!make_payloads(num_payloads, ins, outs, widths, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned tiles = num_tiles(n);
  lookback_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), n,
      static_cast<unsigned long long*>(status), tiles,
      static_cast<int32_t*>(tile_offsets), static_cast<int32_t*>(count),
      static_cast<int32_t*>(idx_out), p);
  return static_cast<int>(cudaGetLastError());
}

// A later group of payloads over the offsets the single pass recorded.
int gt_fragnet_scatter(const void* mask, long long n, const void* tile_offsets,
                       int num_payloads, const void* const* ins,
                       void* const* outs, const int* widths, void* stream) {
  if (n <= 0) return 0;
  Payloads p;
  if (!make_payloads(num_payloads, ins, outs, widths, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scatter_kernel<<<num_tiles(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), n,
      static_cast<const int32_t*>(tile_offsets), nullptr, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
