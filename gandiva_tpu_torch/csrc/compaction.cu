// Stable stream compaction (kernel K1) for Hopper, sm_90a.
//
// Replaces gandiva_tpu/ops/kernels/compaction_pallas.py::compact_pallas_u32
// (:417, its body _kernel :45; driven by compact_columns there). Same
// contract: a bool mask of n < 2^31 rows and any number of contiguous
// payload columns of 1, 2, 4 or 8 bytes go in; the surviving rows come out
// packed to the front in row order, with their int32 row indices; every
// output has n rows and is meaningful on [:count]; ``count`` is written by
// the scatter and stays on the device. One scatter launch moves up to
// kMaxPayloads columns: the caller launches one per group of columns over
// the same tile counts, and only the first writes the row indices and
// ``count``.
//
// Bound: bytes. Each row's 1-byte mask is read once, and each survivor's
// payload elements are read once and written once with its 4-byte index
// (chip_smoke.py::compaction_bytes: at the flagship shape, 64Mi rows at
// density 0.474 with an f64 and a bool payload, 0.767 GB, 0.2289 ms at
// 3.35 TB/s). The card reads 32-byte sectors, so no stable compaction reads
// fewer bytes than the sectors its survivors touch: there, 92% of the f64
// column's sectors and every sector of the 1-byte columns, about 1.04 GB
// with the writes (0.311 ms; chip_smoke.py::sector_bytes), and 0.331 ms
// with the count pass's second read of the mask.
//
// Design: two passes over tiles of kTile = 4096 rows, each step against
// that floor:
//   1. gt_compact_count reads only the mask, at the rate of a stream: one
//      warp a tile, 16-byte vector loads (16 rows a load, 8 loads a lane in
//      flight), the non-zero bytes counted with bit tricks and __popc, one
//      count a tile. A view that is not 16-B aligned, or the ragged last
//      tile, counts byte by byte.
//   2. gt_compact_scatter is compaction_tile.cuh's offsets-given scatter.
//      Its producer warp sums the counts before each tile (from L2), so no
//      scan launch sits between the passes. Because every tile's count is
//      known before its payloads are read, the producer loads what a tile's
//      survivors need and no more, stages ahead of the consumers: a dense
//      tile's mask and columns whole, in bulk copies that cost the SM no
//      instructions or registers; no mask for a tile that keeps every row;
//      nothing for an empty one; the survivors' elements alone, copied by
//      the consumers, for a column where they touch few sectors. The
//      consumers rank the survivors from the mask in shared memory and
//      write each tile's survivors as one contiguous run of coalesced
//      stores (left in L2 for the operator that reads them next), with no
//      payload held in registers.
// 64-bit payloads move as 64-bit words; the TPU kernel's 32-bit limb
// splitting, butterfly routing and aligned windows have no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

#include "compaction_tile.cuh"

namespace {

constexpr int kCountLoads = kTile / (32 * 16);  // 16-byte loads a lane

// One warp a tile: counts[t] <- the non-zero mask bytes of tile t.
__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, long long n, long long tiles,
             int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (t >= tiles) return;
  const long long base = t * kTile;
  int total = 0;
  if (base + kTile <= n && aligned16(mask)) {
    const uint4* v = reinterpret_cast<const uint4*>(mask + base);
    uint4 x[kCountLoads];
#pragma unroll
    for (int i = 0; i < kCountLoads; ++i) x[i] = v[lane + 32 * i];
#pragma unroll
    for (int i = 0; i < kCountLoads; ++i) total += __popc(nonzero_bits(x[i]));
  } else {
    for (int j = lane; j < kTile; j += 32) {
      total += base + j < n && mask[base + j] != 0;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) total += __shfl_xor_sync(kFull, total, d);
  if (lane == 0) counts[t] = total;
}

}  // namespace

extern "C" {

int gt_compact_tile_rows() { return kTile; }

int gt_compact_max_payloads() { return kMaxPayloads; }

const char* gt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pass 1: counts[ceil(n / tile)] <- survivors per tile.
int gt_compact_count(const void* mask, long long n, void* counts,
                     void* stream) {
  if (n <= 0) return 0;
  const long long tiles = num_tiles(n);
  const unsigned blocks = static_cast<unsigned>((tiles + kWarps - 1) / kWarps);
  count_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), n, tiles,
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: each tile's survivors to the run after all earlier tiles'
// survivors, and their total to ``count`` (an int32; null skips it).
// ``ins``/``outs`` hold num_payloads device pointers, ``widths`` their
// element sizes; a null ``idx_out`` skips the row indices (a later group of
// payload columns).
int gt_compact_scatter(const void* mask, long long n, const void* counts,
                       void* idx_out, void* count, int num_payloads,
                       const void* const* ins, void* const* outs,
                       const int* widths, void* stream) {
  Payloads p;
  if (!make_payloads(num_payloads, ins, outs, widths, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_scatter(
      static_cast<const uint8_t*>(mask), n,
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(idx_out),
      static_cast<int32_t*>(count), p, static_cast<cudaStream_t>(stream)));
}

// The scatter's launch for these widths on the current device: shape[0]
// <- its grid (SMs x CTAs an SM, before it is cut to the work items),
// shape[1] <- its stages, shape[2] <- its dynamic shared memory in bytes.
int gt_compact_scatter_shape(int num_payloads, const int* widths,
                             int* shape) {
  Payloads p{};
  p.count = num_payloads < kMaxPayloads ? num_payloads : kMaxPayloads;
  for (int k = 0; k < p.count; ++k) p.width[k] = widths[k];
  ScatterShape s;
  const cudaError_t err = scatter_shape(plan_stages(p, kScatterRowBytes), &s);
  shape[0] = s.blocks;
  shape[1] = s.stages;
  shape[2] = s.smem;
  return static_cast<int>(err);
}

}  // extern "C"
