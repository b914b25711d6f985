// Block sort (kernel K4) for Hopper, sm_90a.
//
// Replaces gandiva_tpu/ops/kernels/sort_bitonic.py::_block_kernel in the use
// the merge sort makes of it (_run_block_stages with local_dirs=True, the
// leaf of merge_sort_u32 at merge_path.py:376): every W-row tile of the
// input comes out sorted ascending. Rows compare by their k 64-bit words as
// unsigned integers, most significant first, then by row index. The index
// makes the order total, so every compare-exchange is decided and the
// result is stable. The kernel makes the row index from the position and
// writes it out as int32 beside the sorted words.
//
// Layout: words [k][n] (word w of row i at w * n + i), the same in and out;
// idx_out [n] int32. The last tile may be ragged: its missing rows are
// padded in shared memory with all-ones words and an index >= n, so they
// sort behind every real row of the tile, and are not written out.
//
// Bound: bytes. It must read 8k B a row and write 8k + 4 B a row (at BASELINE
// configs[2], one word: 20 B a row, 2 GB at 100,000,000 rows, about 0.60 ms
// at an H100 SXM's 3.35 TB/s). Each row is read from and written to device
// memory once, coalesced; all log2(W) (log2(W) + 1) / 2 stages of the
// bitonic network run in shared memory, so device traffic stays at that
// bound. What this simple design pays instead is shared-memory traffic and
// a __syncthreads() per stage; keeping the first strides in registers
// (warp shuffles) is the step that would cut it.
//
// Design: one CTA per tile; the tile's words and indices in dynamic shared
// memory (W * (8k + 4) bytes, above 48 KB by the MaxDynamicSharedMemorySize
// attribute; the caller halves W until it fits 227 KB); min(1024, W / 2)
// threads, each taking W / 2 / threads compare-exchange pairs per stage.
// The TPU kernel's roll/select formulation over (8, 128) vregs, its int32
// limbs and bias flip have no counterpart: words compare as 64-bit unsigned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// Row a of the tile orders after row b: words (unsigned, most significant
// first), then the row index.
template <int K>
__device__ __forceinline__ bool after(const u64* __restrict__ s_words,
                                      const int32_t* __restrict__ s_idx,
                                      int k, int w_rows, int a, int b) {
  const int words = K > 0 ? K : k;
#pragma unroll
  for (int w = 0; w < words; ++w) {
    const u64 x = s_words[w * w_rows + a];
    const u64 y = s_words[w * w_rows + b];
    if (x != y) return x > y;
  }
  return s_idx[a] > s_idx[b];
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
block_sort_kernel(const u64* __restrict__ in, long long n, int k, int w_log2,
                  u64* __restrict__ out, int32_t* __restrict__ idx_out) {
  extern __shared__ u64 smem[];
  const int words = K > 0 ? K : k;
  const int w_rows = 1 << w_log2;
  u64* s_words = smem;                                        // [k][W]
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem + static_cast<size_t>(words) * w_rows);
  const long long base = static_cast<long long>(blockIdx.x) * w_rows;

  for (int i = threadIdx.x; i < w_rows; i += blockDim.x) {
    const long long row = base + i;
    const bool real = row < n;
    for (int w = 0; w < words; ++w) {
      s_words[w * w_rows + i] = real ? in[w * n + row] : ~0ull;
    }
    s_idx[i] = static_cast<int32_t>(row);  // >= n for a pad row
  }
  __syncthreads();

  // bitonic network: merges of size 2, 4, .., W; within each, strides
  // size/2 .. 1. Pair p of a stage is (lo, lo + stride) with lo's stride bit
  // clear; the run of `size` it lies in sorts ascending when lo's size bit
  // is clear (always for size == W, so the tile ends ascending).
  const int pairs = w_rows >> 1;
  for (int size = 2; size <= w_rows; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int lo = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        if (after<K>(s_words, s_idx, k, w_rows, lo, hi) == ascending) {
          for (int w = 0; w < words; ++w) {
            const u64 t = s_words[w * w_rows + lo];
            s_words[w * w_rows + lo] = s_words[w * w_rows + hi];
            s_words[w * w_rows + hi] = t;
          }
          const int32_t t = s_idx[lo];
          s_idx[lo] = s_idx[hi];
          s_idx[hi] = t;
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < w_rows; i += blockDim.x) {
    const long long row = base + i;
    if (row < n) {
      for (int w = 0; w < words; ++w) out[w * n + row] = s_words[w * w_rows + i];
      idx_out[row] = s_idx[i];
    }
  }
}

template <int K>
cudaError_t launch(const u64* in, long long n, int k, int w_log2, u64* out,
                   int32_t* idx_out, cudaStream_t stream) {
  const int w_rows = 1 << w_log2;
  const size_t smem = static_cast<size_t>(w_rows) * (8 * k + 4);
  // set on every launch: the default 48 KB also counts static shared memory
  const cudaError_t err = cudaFuncSetAttribute(
      block_sort_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = w_rows / 2 < kMaxThreads ? w_rows / 2 : kMaxThreads;
  const long long tiles = (n + w_rows - 1) / w_rows;
  block_sort_kernel<K><<<static_cast<unsigned>(tiles), threads, smem, stream>>>(
      in, n, k, w_log2, out, idx_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gt_block_sort_smem_limit() { return kSmemLimit; }

const char* gt_block_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sort every 2^w_log2-row tile of words [k][n] ascending by (words, row
// index): out [k][n] gets the sorted words, idx_out [n] the row indices.
int gt_block_sort(const void* words, long long n, int k, int w_log2,
                  void* out, void* idx_out, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || w_log2 < 6 || w_log2 > 16 ||
      static_cast<long long>(1 << w_log2) * (8 * k + 4) > kSmemLimit ||
      n + (1 << w_log2) > 0x7fffffffLL) {
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
