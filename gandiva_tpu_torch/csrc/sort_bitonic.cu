// Block sort (kernel K4) for Hopper, sm_90a.
//
// Replaces gandiva_tpu/ops/kernels/sort_bitonic.py::_block_kernel in the use
// the merge sort makes of it (_run_block_stages with local_dirs=True, the
// leaf of merge_sort_u32 at merge_path.py:376): every W-row tile of the
// input comes out sorted ascending. Rows compare by their k 64-bit words as
// unsigned integers, most significant first, then by row index, so the
// result is stable. The kernel makes the row index from the position and
// writes it out as int32 beside the sorted words. The file keeps its name;
// the design is no longer a bitonic network.
//
// Layout: words [k][n] (word w of row i at w * n + i), the same in and out;
// idx_out [n] int32. The last tile may be ragged: its missing rows are
// padded in shared memory with all-ones words behind every real row of the
// tile, and are not written out.
//
// Bound: bytes. It must read 8k B a row and write 8k + 4 B a row (at BASELINE
// configs[2], one word: 20 B a row, 2 GB at 100,000,000 rows, about 0.60 ms
// at an H100 SXM's 3.35 TB/s). Each row is read from and written to device
// memory once, coalesced. What bounds the kernel in practice is shared
// memory and barriers: a bitonic network would pass over the whole tile
// log2(W) (log2(W) + 1) / 2 times, a barrier each (66 passes, about 1.6 KB
// of shared-memory traffic a row, at W = 2048); a merge sort passes
// log2(W / kItems) times.
//
// Design: a merge sort inside the tile, rows in registers (CUB's block
// merge sort, written here). One CTA per tile of W = kItems * threads rows.
//   1. The CTA loads the tile coalesced into shared memory: word 0 into the
//      merge buffer, words 1 .. k-1 into `rest`, where they stay.
//   2. Thread t takes rows [t kItems, (t + 1) kItems) into registers as
//      Rows (word 0, position) and sorts them by an odd-even transposition
//      network, which swaps only neighbours that are strictly out of order,
//      so equal rows keep their order.
//   3. log2(W / kItems) levels: every thread writes its Rows back to the
//      merge buffer, then finds its diagonal in the merged pair of runs its
//      rows fall in (merge_path) and merges kItems outputs into registers
//      (serial_merge, merge_tile.cuh). Runs are contiguous position ranges,
//      and A wins ties, so the order stays stable with no index compares.
//   4. The CTA writes the tile coalesced: word 0 from the merge buffer, the
//      other words from `rest` by position, the index as tile start +
//      position.
// Shared-memory traffic is about 2 x 12 B a row a level (9 levels at
// W = 2^13), and a barrier comes every half level: a warp's own at the
// first five, while a pair of runs lies within one warp, then the block's.
// The merge buffer has one pad slot after every kItems rows, so a thread's
// kItems consecutive rows fall in distinct banks when all threads write or
// read them at once. Sixteen rows a thread under a 64-register cap (two
// CTAs an SM at W = 2^13) spill a little (chip_smoke.py prints ptxas's
// count); a 128-register cap, one CTA an SM, ran slower.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_tile.cuh"

namespace {

constexpr int kItems = 16;  // rows a thread holds in registers
constexpr int kLogItems = 4;
constexpr int kMaxThreads = 1024;
constexpr int kMinLog2 = 6;
constexpr int kMaxLog2 = 14;  // kItems * kMaxThreads rows
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

static_assert(kItems == 1 << kLogItems, "kItems is 2^kLogItems");
static_assert(kItems << (kMaxLog2 - kLogItems) == kItems * kMaxThreads,
              "the largest tile takes kMaxThreads threads");

// The merge-buffer slot of tile position i >= 0: one pad slot every kItems.
__device__ __forceinline__ int pad(int i) { return i + (i >> kLogItems); }

// Merge-buffer slots: every position, its pad, and the slack row at W.
__host__ __device__ inline long long buffer_slots(int w_rows) {
  return w_rows + (w_rows >> kLogItems) + 1;
}

// Shared memory of a tile: words 1 .. k-1 (8 B a row), and the merge
// buffer's word 0 and position (12 B a slot).
inline long long smem_bytes(int k, int w_log2) {
  const long long w_rows = 1LL << w_log2;
  return 8LL * (k - 1) * w_rows + 12LL * buffer_slots(static_cast<int>(w_rows));
}

struct SortTile {
  const u64* key;
  const int32_t* pos;

  __device__ __forceinline__ Row load(int i) const {
    const int s = pad(i);
    return Row{key[s], pos[s]};
  }
};

// One merge level: every thread writes its Rows to its own slots, then
// merges kItems outputs of the pair of runs of `run` rows its slots lie in.
// Sync is the barrier that keeps each read behind the writes before it and
// each write behind the reads before it.
template <int K, class Sync>
__device__ __forceinline__ void merge_level(const SortTile& tile,
                                            const Order<K>& ord, u64* s_key,
                                            int32_t* s_pos, int first,
                                            int run, Row (&r)[kItems],
                                            Sync sync) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    s_key[pad(first + i)] = r[i].key;
    s_pos[pad(first + i)] = r[i].pos;
  }
  sync();
  const int a0 = first & ~(2 * run - 1);
  const int b0 = a0 + run;
  const int diag = first - a0;
  const int m = merge_path(tile, ord, a0, run, b0, run, diag);
  serial_merge<kItems>(tile, ord, a0 + m, b0, b0 + diag - m, b0 + run, r);
  sync();
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
block_sort_kernel(const u64* __restrict__ in, long long n, int k, int w_log2,
                  u64* __restrict__ out, int32_t* __restrict__ idx_out) {
  extern __shared__ u64 smem[];
  const int words = K > 0 ? K : k;
  const int w_rows = 1 << w_log2;
  const int slots = static_cast<int>(buffer_slots(w_rows));
  u64* s_rest = smem;                                          // [k - 1][W]
  u64* s_key = s_rest + static_cast<size_t>(words - 1) * w_rows;  // [slots]
  int32_t* s_pos = reinterpret_cast<int32_t*>(s_key + slots);     // [slots]
  const long long base = static_cast<long long>(blockIdx.x) * w_rows;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;

  // 1. the tile, coalesced; pad rows are all ones
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * threads + tid;
    const long long row = base + i;
    const bool real = row < n;
    s_key[pad(i)] = real ? in[row] : ~0ull;
    for (int w = 1; w < words; ++w) {
      s_rest[(w - 1) * w_rows + i] = real ? in[w * n + row] : ~0ull;
    }
  }
  __syncthreads();

  const Order<K> ord{s_rest, w_rows, k};
  const SortTile tile{s_key, s_pos};
  const int first = tid * kItems;

  // 2. this thread's rows, sorted in registers
  Row r[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) r[i] = Row{s_key[pad(first + i)], first + i};
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
#pragma unroll
    for (int i = s & 1; i + 1 < kItems; i += 2) {
      const bool swap = ord.after(r[i], r[i + 1]);
      const Row lo = swap ? r[i + 1] : r[i];
      const Row hi = swap ? r[i] : r[i + 1];
      r[i] = lo;
      r[i + 1] = hi;
    }
  }

  // 3. merge levels. A thread's own slots are written only by it. While a
  // pair of runs lies within one warp's slots (a tile of whole warps), a
  // warp barrier does; the levels after it take the block's.
  int run = kItems;
  if (threads >= 32) {
    for (; run < w_rows && 2 * run <= 32 * kItems; run <<= 1) {
      merge_level(tile, ord, s_key, s_pos, first, run, r,
                  [] { __syncwarp(); });
    }
    __syncthreads();
  }
  for (; run < w_rows; run <<= 1) {
    merge_level(tile, ord, s_key, s_pos, first, run, r,
                [] { __syncthreads(); });
  }

  // 4. the sorted tile, coalesced
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    s_key[pad(first + i)] = r[i].key;
    s_pos[pad(first + i)] = r[i].pos;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * threads + tid;
    const long long row = base + i;
    if (row < n) {
      const int src = s_pos[pad(i)];
      out[row] = s_key[pad(i)];
      idx_out[row] = static_cast<int32_t>(base + src);
      for (int w = 1; w < words; ++w) {
        out[w * n + row] = s_rest[(w - 1) * w_rows + src];
      }
    }
  }
}

template <int K>
cudaError_t launch(const u64* in, long long n, int k, int w_log2, u64* out,
                   int32_t* idx_out, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes(k, w_log2));
  // set on every launch: the default 48 KB also counts static shared memory
  const cudaError_t err = cudaFuncSetAttribute(
      block_sort_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int threads = (1 << w_log2) / kItems;
  const long long tiles = (n + (1LL << w_log2) - 1) >> w_log2;
  block_sort_kernel<K><<<static_cast<unsigned>(tiles), threads, smem, stream>>>(
      in, n, k, w_log2, out, idx_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gt_block_sort_smem_limit() { return kSmemLimit; }

int gt_block_sort_items() { return kItems; }

const char* gt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sort every 2^w_log2-row tile of words [k][n] ascending by (words, row
// index): out [k][n] gets the sorted words, idx_out [n] the row indices.
int gt_block_sort(const void* words, long long n, int k, int w_log2,
                  void* out, void* idx_out, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || w_log2 < kMinLog2 || w_log2 > kMaxLog2 ||
      smem_bytes(k, w_log2) > kSmemLimit ||
      n + (1LL << w_log2) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const u64* in = static_cast<const u64*>(words);
  u64* o = static_cast<u64*>(out);
  int32_t* idx = static_cast<int32_t*>(idx_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 1: err = launch<1>(in, n, k, w_log2, o, idx, s); break;
    case 2: err = launch<2>(in, n, k, w_log2, o, idx, s); break;
    default: err = launch<0>(in, n, k, w_log2, o, idx, s); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
