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
// Design: one CTA per tile of kTile = 4096 rows, 256 threads, in one launch:
// thread t of warp w holds rows j * 256 + t of the tile, j < 16, as one
// ballot word a 32-row slot. The
// look-back is a wait, so the tile's payload reads are put in flight
// before it:
//   1. Tile order: thread 0 takes the CTA's tile id from an atomic counter
//      (the last word of ``status``), not from blockIdx. A CTA only ever
//      waits on tiles with smaller ids, which belong to CTAs that started
//      before it and are running, so the look-back always makes progress,
//      however many tiles there are and in whatever order Hopper schedules
//      the CTAs.
//   2. Ballots: the CTA reads its mask tile once (coalesced byte loads) and
//      keeps one ballot word per slot in registers.
//   3. Staging: at once, before the scan, every thread issues asynchronous
//      copies (cp.async) of its rows' payload elements into shared memory,
//      at their tile positions: for a 4- or 8-byte column one copy per
//      survivor, so a dropped row costs no payload bytes and a warp's copies
//      of one slot cover 32 consecutive rows; for a 1- or 2-byte column the
//      whole tile in 16-byte copies (a 32-byte sector holds 32 or 16 of its
//      rows, so at any but the lowest densities every sector is read
//      anyway), in 4-byte copies where the column is only 4-B aligned, and
//      survivor by survivor where the tile is ragged or the column less
//      aligned. Nothing waits on these copies until step 6, and they hold
//      no registers.
//   4. Local scan: warp 0 scans the slot counts in shared memory, which
//      also gives the tile's total.
//   5. Look back (lookback.cuh): warp 0 publishes the tile's aggregate as
//      one 64-bit descriptor (status in the top two bits, value below)
//      with atomicExch; it reads the 32 descriptors
//      before its tile at once, one per lane, spinning with __nanosleep
//      back-off while any is still empty, sums the aggregates up to the
//      nearest inclusive prefix (or all 32, and moves 32 tiles further
//      back) and publishes its own inclusive prefix. Tile 0 publishes its
//      prefix at once. Meanwhile the copies run and the other warps write
//      each survivor's tile position to shared memory at its rank.
//   6. Write: every thread waits for its copies, and after a barrier the
//      CTA writes the tile's survivors as one contiguous run
//      [prefix, prefix + total): thread i writes the i-th, the i+256-th ...
//      survivor's index and payloads, read from shared memory, so the
//      stores coalesce.
//   7. The tile with the last id writes ``count``.
// Shared memory holds the staged tiles of one group of payload columns,
// each group at most kStageRowBytes a row (plan_stages groups consecutive
// columns from their widths), and a 2-byte position a row. The first
// group's copies are in flight during the look-back; each later group is
// copied and written after the one before. At most 64 registers, so four CTAs share an SM where
// their shared memory fits (a tile of one 8-byte column takes 40 KB).
// The caller zeroes ``status`` (one word per tile plus the counter) before
// every launch, so no state survives from one call to the next.
// With more than kMaxPayloads payloads, the first launch also records each
// tile's survivor count in ``tile_counts``; the later groups use the
// offsets-given scatter of compaction_tile.cuh (K1's second pass) over
// them, with no second look-back.

#include <cstdint>
#include <cuda_runtime.h>

#include "compaction_tile.cuh"
#include "lookback.cuh"

namespace {

// Staged payload bytes a row of a tile, at most, per group: 4096 x (16 + 2)
// B = 72 KB. One group holds the two flagship columns (8 + 1 B) or an int64
// key with a 4-byte slot.
constexpr int kStageRowBytes = 16;
static_assert(kStageRowBytes >= 8 && kStageRowBytes <= 48,
              "a group must hold one 8-byte column and fit a block's shared "
              "memory");
constexpr int kMaxShared = kTile * (kStageRowBytes + 2);


constexpr int kSlots = kIters * kWarps;  // 32-row groups per tile
static_assert(kSlots == 4 * 32,
              "the shared-memory scan gives each lane 4 slots");

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

// The look-back's operator: a sum of survivor counts, from tile 0 up.
struct Sum {
  static constexpr long long kIdentity = 0;
  static constexpr bool kFromRight = false;
  static constexpr bool kNearestEnds = false;
  __device__ static long long combine(long long a, long long b) {
    return a + b;
  }
};

// A 4- or 8-byte column: one copy per survivor of this thread, row
// base + j * kThreads + threadIdx.x to tile position j * kThreads +
// threadIdx.x, so a warp's copies of one j cover 32 consecutive rows.
template <int kWidth>
__device__ __forceinline__ void stage_survivors(const void* in,
                                                unsigned char* stage,
                                                long long base,
                                                const unsigned (&ballot)[kIters],
                                                int lane) {
  const unsigned char* src = static_cast<const unsigned char*>(in);
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    if ((ballot[j] >> lane) & 1u) {
      const int pos = j * kThreads + threadIdx.x;
      copy_async<kWidth>(stage + pos * kWidth, src + (base + pos) * kWidth);
    }
  }
}

// A 1- or 2-byte column: the whole tile, in 16-byte copies (4-byte ones if
// the column is only 4-B aligned), thread t taking chunks t, t + kThreads,
// ...; a ragged tile or a column that is not 4-B aligned copies its
// survivors element by element.
template <typename T>
__device__ __forceinline__ void stage_tile(const void* in, unsigned char* stage,
                                           long long base, long long n,
                                           const unsigned (&ballot)[kIters],
                                           int lane) {
  const T* src = static_cast<const T*>(in) + base;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  constexpr int kTileBytes = kTile * sizeof(T);
  if (base + kTile <= n && (a & 15) == 0) {
#pragma unroll
    for (int b = threadIdx.x * 16; b < kTileBytes; b += kThreads * 16) {
      copy_async<16>(stage + b, reinterpret_cast<const unsigned char*>(src) + b);
    }
  } else if (base + kTile <= n && (a & 3) == 0) {
#pragma unroll 4
    for (int b = threadIdx.x * 4; b < kTileBytes; b += kThreads * 4) {
      copy_async<4>(stage + b, reinterpret_cast<const unsigned char*>(src) + b);
    }
  } else {
    T* dst = reinterpret_cast<T*>(stage);
#pragma unroll
    for (int j = 0; j < kIters; ++j) {
      const int pos = j * kThreads + threadIdx.x;
      if ((ballot[j] >> lane) & 1u) dst[pos] = src[pos];
    }
  }
}

// Issues the copies of columns [first, last) of the tile.
__device__ __forceinline__ void stage_group(const Payloads& p,
                                            const StagePlan& plan, int first,
                                            int last, unsigned char* stage,
                                            long long base, long long n,
                                            const unsigned (&ballot)[kIters],
                                            int lane) {
  for (int k = first; k < last; ++k) {
    unsigned char* s = stage + plan.offset[k];
    switch (p.width[k]) {
      case 8: stage_survivors<8>(p.in[k], s, base, ballot, lane); break;
      case 4: stage_survivors<4>(p.in[k], s, base, ballot, lane); break;
      case 2: stage_tile<uint16_t>(p.in[k], s, base, n, ballot, lane); break;
      default: stage_tile<uint8_t>(p.in[k], s, base, n, ballot, lane); break;
    }
  }
  commit_copies();
}

// Writes columns [first, last) of the tile's survivors to their run.
__device__ __forceinline__ void write_group(const Payloads& p,
                                            const StagePlan& plan, int first,
                                            int last,
                                            const unsigned char* stage,
                                            int offset, int total,
                                            const uint16_t* s_pos) {
  const Positions pos{s_pos, false};
  const int tid = threadIdx.x;
  for (int k = first; k < last; ++k) {
    const unsigned char* s = stage + plan.offset[k];
    void* out = p.out[k];
    switch (p.width[k]) {
      case 8: write_column<uint64_t>(s, out, offset, total, pos, tid); break;
      case 4: write_column<uint32_t>(s, out, offset, total, pos, tid); break;
      case 2: write_column<uint16_t>(s, out, offset, total, pos, tid); break;
      default: write_column<uint8_t>(s, out, offset, total, pos, tid); break;
    }
  }
}

// At most 64 registers, so four CTAs share an SM where their shared memory
// fits.
__global__ void __launch_bounds__(kThreads, 4)
lookback_kernel(const uint8_t* __restrict__ mask, long long n,
                unsigned long long* __restrict__ status, long long tiles,
                int32_t* __restrict__ tile_counts,
                int32_t* __restrict__ count, int32_t* __restrict__ idx_out,
                Payloads p, StagePlan plan) {
  // dynamic shared memory: the staged payload tiles, then the survivors'
  // tile positions by rank
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;
  uint16_t* s_pos = reinterpret_cast<uint16_t*>(smem + plan.stage_bytes);
  __shared__ int slot_offset[kSlots];
  __shared__ long long s_tile;
  __shared__ int s_offset, s_total;
  if (threadIdx.x == 0) {
    s_tile = static_cast<long long>(atomicAdd(&status[tiles], 1ull));
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned ballot[kIters];
  tile_ballots(mask, n, base, ballot, slot_offset);
  const int first_end = plan.groups > 0 ? plan.end[0] : 0;
  stage_group(p, plan, 0, first_end, stage, base, n, ballot, lane);
  __syncthreads();
  if (warp == 0) {
    const int total = scan_slots(slot_offset);
    if (lane == 0) s_total = total;
  }
  __syncthreads();
  const int total = s_total;
  if (warp == 0) {
    const int offset = static_cast<int>(
        gt_lookback::look_back<Sum>(status, tile, tiles, total));
    if (threadIdx.x == 0) {
      s_offset = offset;
      if (tile_counts != nullptr) tile_counts[tile] = total;
      if (tile == tiles - 1) *count = offset + total;
    }
  }
  // each survivor's tile position at its rank
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    if ((ballot[j] >> lane) & 1u) {
      s_pos[slot_offset[j * kWarps + warp] + __popc(ballot[j] & below)] =
          static_cast<uint16_t>(j * kThreads + threadIdx.x);
    }
  }
  wait_copies();
  __syncthreads();
  const int offset = s_offset;
  if (idx_out != nullptr) {
    for (int j = threadIdx.x; j < total; j += kThreads) {
      idx_out[offset + j] = static_cast<int32_t>(base + s_pos[j]);
    }
  }
  write_group(p, plan, 0, first_end, stage, offset, total, s_pos);
  for (int g = 1; g < plan.groups; ++g) {
    __syncthreads();  // the group before has been read
    stage_group(p, plan, plan.end[g - 1], plan.end[g], stage, base, n, ballot,
                lane);
    wait_copies();
    __syncthreads();
    write_group(p, plan, plan.end[g - 1], plan.end[g], stage, offset, total,
                s_pos);
  }
}

// Whether lookback_kernel's shared-memory limit is raised on a device yet:
// once per device, not on every call.
bool g_shared_set[64] = {};

}  // namespace

extern "C" {

int gt_fragnet_tile_rows() { return kTile; }

int gt_fragnet_max_payloads() { return kMaxPayloads; }

const char* gt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The single pass: ``status`` holds ceil(n / tile) + 1 zeroed 64-bit words
// (the descriptors, then the tile counter); ``tile_counts`` (may be null)
// receives each tile's survivor count; ``count`` (one int32) the number
// of survivors. ``ins``/``outs`` hold num_payloads device pointers,
// ``widths`` their element sizes (1, 2, 4 or 8).
int gt_fragnet_compact(const void* mask, long long n, void* status,
                       void* tile_counts, void* count, void* idx_out,
                       int num_payloads, const void* const* ins,
                       void* const* outs, const int* widths, void* stream) {
  if (n <= 0) return 0;
  Payloads p;
  if (!make_payloads(num_payloads, ins, outs, widths, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StagePlan plan = plan_stages(p, kStageRowBytes);
  const int smem = plan.stage_bytes + kTile * static_cast<int>(sizeof(uint16_t));
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_shared_set[device]) {
    err = cudaFuncSetAttribute(lookback_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_shared_set[device] = true;
  }
  const unsigned tiles = num_tiles(n);
  lookback_kernel<<<tiles, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), n,
      static_cast<unsigned long long*>(status), tiles,
      static_cast<int32_t*>(tile_counts), static_cast<int32_t*>(count),
      static_cast<int32_t*>(idx_out), p, plan);
  return static_cast<int>(cudaGetLastError());
}

// A later group of payloads over the tile counts the single pass recorded:
// the offsets-given scatter of compaction_tile.cuh.
int gt_fragnet_scatter(const void* mask, long long n, const void* tile_counts,
                       int num_payloads, const void* const* ins,
                       void* const* outs, const int* widths, void* stream) {
  Payloads p;
  if (!make_payloads(num_payloads, ins, outs, widths, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_scatter(
      static_cast<const uint8_t*>(mask), n,
      static_cast<const int32_t*>(tile_counts), nullptr, nullptr, p,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
