// One merge-path round (kernel K3) for Hopper, sm_90a.
//
// Replaces gandiva_tpu/ops/kernels/merge_path.py::_merge_kernel (reached
// through _merge_round there), and the split search the reference runs
// outside that kernel between rounds (_diag_search, _round_meta). One round
// merges adjacent sorted runs of `run` rows into sorted runs of 2 * run rows:
// runs A = [2p * run, (2p + 1) * run) and B = [(2p + 1) * run, (2p + 2) * run)
// of the input, cut at n, so the last pair may be short and a last run with
// no partner is copied through. Rows compare by their k 64-bit words as
// unsigned integers, most significant first; A wins ties. The runs hold
// contiguous ranges of the original rows (the block sort's tiles, then their
// merges), so every row of A has a smaller index than every row of B, and A
// winning ties is the (words, row index) order: the sort stays stable. The
// int32 row index travels with the words.
//
// Layout: words [k][n] (word w of row i at w * n + i), in and out; idx [n].
//
// Bound: bytes. A round must read and write every row once: 8k + 4 B each
// way (at BASELINE configs[2], one word: 24 B a row, 2.4 GB at 100,000,000
// rows, about 0.72 ms at an H100 SXM's 3.35 TB/s). The design reads each row
// once, coalesced, into shared memory and writes it once, coalesced, from
// there; the only other device reads are the two split searches per CTA
// (about 2 k log32(run) words).
//
// Design: CTA b produces the T = 2^tile_log2 outputs [b T, (b + 1) T) of the
// merge (T divides 2 * run, so they lie in one pair).
//   1. Warps 0 and 1 find where this CTA's first output and the next CTA's
//      first output lie on the merge path: the number of A rows among the
//      first d outputs, by a search on the diagonal d (each step, the 32
//      lanes probe 32 points of the range; A wins ties, as at the
//      reference's merge_path.py:270-279).
//   2. The CTA loads the A segment and the B segment those splits bound
//      (together T rows) into shared memory.
//   3. Each thread searches the shared segments for its own diagonal, then
//      merges T / threads outputs, recording which shared row each takes.
//   4. The CTA writes its outputs in order from shared memory.
// The TPU kernel's 1024-aligned windows, flat rotations, Batcher odd-even
// network, int32 limbs and "carry" payload limbs have no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kMaxThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;

// Row a orders strictly after row b (device memory, words only).
template <int K>
__device__ __forceinline__ bool after_global(const u64* __restrict__ in,
                                             long long n, int k, long long a,
                                             long long b) {
  const int words = K > 0 ? K : k;
#pragma unroll
  for (int w = 0; w < words; ++w) {
    const u64 x = in[w * n + a];
    const u64 y = in[w * n + b];
    if (x != y) return x > y;
  }
  return false;
}

// Row a orders strictly after row b (shared memory, words only).
template <int K>
__device__ __forceinline__ bool after_shared(const u64* __restrict__ s_words,
                                             int k, int t_rows, int a, int b) {
  const int words = K > 0 ? K : k;
#pragma unroll
  for (int w = 0; w < words; ++w) {
    const u64 x = s_words[w * t_rows + a];
    const u64 y = s_words[w * t_rows + b];
    if (x != y) return x > y;
  }
  return false;
}

// The number of A rows among the first d outputs of merging A (la rows at
// a_start) with B (lb rows at b_start): the least m in [max(0, d - lb),
// min(d, la)] with A[m] after B[d - 1 - m], or the upper end if there is
// none. The predicate is monotone in m. The whole warp calls it and gets the
// same answer: each step probes lo + l * step for the 32 lanes l.
template <int K>
__device__ long long path_split(const u64* __restrict__ in, long long n,
                                int k, long long a_start, long long la,
                                long long b_start, long long lb, long long d,
                                int lane) {
  long long lo = d - lb > 0 ? d - lb : 0;
  long long hi = d < la ? d : la;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long m = lo + lane * step;
    // probes at or past hi count as true: the answer is at most hi
    const bool found = m >= hi ||
        after_global<K>(in, n, k, a_start + m, b_start + d - 1 - m);
    const unsigned ballot = __ballot_sync(kFull, found);
    if (ballot == 0) {
      lo += 31 * step + 1;            // every probe false: past the last one
    } else {
      const int f = __ffs(ballot) - 1;
      const long long at = lo + f * step;
      if (f > 0) lo += (f - 1) * step + 1;
      hi = at < hi ? at : hi;
    }
  }
  return lo;
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
merge_round_kernel(const u64* __restrict__ in,
                   const int32_t* __restrict__ idx_in, long long n, int k,
                   long long run, int tile_log2, u64* __restrict__ out,
                   int32_t* __restrict__ idx_out) {
  extern __shared__ u64 smem[];
  __shared__ long long s_split[2];
  const int words = K > 0 ? K : k;
  const int t_rows = 1 << tile_log2;
  u64* s_words = smem;                                        // [k][T]
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem + static_cast<size_t>(words) * t_rows);
  int32_t* s_slot = s_idx + t_rows;                           // [T]

  const long long out_start = static_cast<long long>(blockIdx.x) * t_rows;
  const long long pair_start = out_start / (2 * run) * (2 * run);
  const long long b_start = pair_start + run;
  const long long la = b_start < n ? run : n - pair_start;
  const long long lb = b_start >= n ? 0 : (n - b_start < run ? n - b_start : run);
  const long long d0 = out_start - pair_start;
  const long long d1 = d0 + t_rows < la + lb ? d0 + t_rows : la + lb;
  const int count = static_cast<int>(d1 - d0);

  if (lb == 0) {  // a run with no partner: copied through
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      for (int w = 0; w < words; ++w) out[w * n + out_start + i] = in[w * n + out_start + i];
      idx_out[out_start + i] = idx_in[out_start + i];
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {
    const long long a0 = path_split<K>(in, n, k, pair_start, la, b_start, lb,
                                       warp == 0 ? d0 : d1, lane);
    if (lane == 0) s_split[warp] = a0;
  }
  __syncthreads();
  const long long a0 = s_split[0];
  const long long b0 = d0 - a0;
  const int las = static_cast<int>(s_split[1] - a0);
  const int lbs = count - las;

  // the A segment at [0, las), the B segment at [las, count)
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const long long src = i < las ? pair_start + a0 + i : b_start + b0 + (i - las);
    for (int w = 0; w < words; ++w) s_words[w * t_rows + i] = in[w * n + src];
    s_idx[i] = idx_in[src];
  }
  __syncthreads();

  const int items = t_rows / blockDim.x;
  const int diag = threadIdx.x * items < count ? threadIdx.x * items : count;
  int lo = diag - lbs > 0 ? diag - lbs : 0;
  int hi = diag < las ? diag : las;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (after_shared<K>(s_words, k, t_rows, m, las + diag - 1 - m)) {
      hi = m;
    } else {
      lo = m + 1;
    }
  }
  int ia = lo;
  int ib = diag - lo;
  const int end = diag + items < count ? diag + items : count;
  for (int pos = diag; pos < end; ++pos) {
    const bool take_a = ib >= lbs ||
        (ia < las && !after_shared<K>(s_words, k, t_rows, ia, las + ib));
    s_slot[pos] = take_a ? ia++ : las + ib++;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int s = s_slot[i];
    for (int w = 0; w < words; ++w) out[w * n + out_start + i] = s_words[w * t_rows + s];
    idx_out[out_start + i] = s_idx[s];
  }
}

template <int K>
cudaError_t launch(const u64* in, const int32_t* idx_in, long long n, int k,
                   long long run, int tile_log2, u64* out, int32_t* idx_out,
                   cudaStream_t stream) {
  const int t_rows = 1 << tile_log2;
  const size_t smem = static_cast<size_t>(t_rows) * (8 * k + 8);
  // set on every launch: the default 48 KB also counts static shared memory
  const cudaError_t err = cudaFuncSetAttribute(
      merge_round_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = t_rows < kMaxThreads ? t_rows : kMaxThreads;
  const long long tiles = (n + t_rows - 1) / t_rows;
  merge_round_kernel<K><<<static_cast<unsigned>(tiles), threads, smem, stream>>>(
      in, idx_in, n, k, run, tile_log2, out, idx_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gt_merge_path_smem_limit() { return kSmemLimit; }

const char* gt_merge_path_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One round over words [k][n] and idx [n] whose runs of `run` rows are
// sorted: out / idx_out get runs of 2 * run rows, merged. `run` is a multiple
// of the 2^tile_log2 outputs each CTA produces.
int gt_merge_round(const void* words, const void* idx, long long n, int k,
                   long long run, int tile_log2, void* out, void* idx_out,
                   void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || tile_log2 < 6 || tile_log2 > 16 || run <= 0 ||
      run % (1LL << tile_log2) != 0 ||
      // strictly below: s_split's 16 static bytes share the limit
      static_cast<long long>(1 << tile_log2) * (8 * k + 8) >= kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const u64* in = static_cast<const u64*>(words);
  const int32_t* ii = static_cast<const int32_t*>(idx);
  u64* o = static_cast<u64*>(out);
  int32_t* io = static_cast<int32_t*>(idx_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 1: err = launch<1>(in, ii, n, k, run, tile_log2, o, io, s); break;
    case 2: err = launch<2>(in, ii, n, k, run, tile_log2, o, io, s); break;
    default: err = launch<0>(in, ii, n, k, run, tile_log2, o, io, s); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
