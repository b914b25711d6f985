// Stable stream compaction (kernel K1) for Hopper, sm_90a.
//
// Replaces gandiva_tpu/ops/kernels/compaction_pallas.py::_kernel (driven by
// compact_pallas_u32 and compact_columns there). Same contract: a bool mask
// of n rows and any number of payload columns go in; the surviving rows come
// out packed to the front in row order, with their row indices; the survivor
// count is computed from the per-tile counts by the caller. One scatter
// launch moves up to kMaxPayloads columns: the caller launches it once per
// group of columns over the same tile offsets, and only the first launch
// writes the row indices.
//
// Bound: bytes. Per row it must read the mask byte and each payload element,
// and write, per survivor, a 4-byte index plus each payload element. No
// arithmetic is worth counting, so the design keeps every global access
// coalesced, reads payloads only for survivors, and pays one extra mask read
// (1 byte per row) for its two passes.
//
// Design: two passes over tiles of kTile = kThreads * kIters rows.
//   1. gt_compact_count: one CTA per tile; for each group of 32 consecutive
//      rows a warp takes __ballot_sync of the mask and __popc of it, and the
//      CTA writes its tile's survivor count to block_counts[tile].
//   2. The caller takes the exclusive scan of block_counts (a few thousand
//      ints) as each tile's output offset. Tiles are independent: Hopper
//      runs CTAs in parallel and in no order, so there is no carried state.
//   3. gt_compact_scatter: each CTA recomputes its ballots, scans the
//      per-(iteration, warp) counts in shared memory in row order, and each
//      survivor writes its row index and every payload to
//      tile_offset + rank. Survivors of one warp-step land on consecutive
//      output slots, so the stores coalesce. The ballots, the scan and the
//      moves are compaction_tile.cuh's, shared with K2.
// 64-bit payloads move as 64-bit words; the TPU kernel's 32-bit limb
// splitting, butterfly routing and aligned windows have no counterpart here.
// The ragged tail is masked by the row < n guard.

#include <cstdint>
#include <cuda_runtime.h>

#include "compaction_tile.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, long long n,
             int32_t* __restrict__ block_counts) {
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int total = 0;
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const long long row = base + j * kThreads + threadIdx.x;
    const bool keep = row < n && mask[row] != 0;
    total += __popc(__ballot_sync(kFull, keep));
  }
  if (lane == 0) warp_total[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_total[w];
    block_counts[blockIdx.x] = sum;
  }
}

}  // namespace

extern "C" {

int gt_compact_tile_rows() { return kTile; }

int gt_compact_max_payloads() { return kMaxPayloads; }

const char* gt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pass 1: block_counts[ceil(n / tile)] ← survivors per tile.
int gt_compact_count(const void* mask, long long n, void* block_counts,
                     void* stream) {
  if (n <= 0) return 0;
  count_kernel<<<num_tiles(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), n,
      static_cast<int32_t*>(block_counts));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: scatter survivors to block_offsets[tile] + rank. ``ins``/``outs``
// hold num_payloads device pointers, ``widths`` their element sizes; a null
// ``idx_out`` skips the row indices (a later group of payload columns).
int gt_compact_scatter(const void* mask, long long n,
                       const void* block_offsets, void* idx_out,
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
      static_cast<const int32_t*>(block_offsets),
      static_cast<int32_t*>(idx_out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
