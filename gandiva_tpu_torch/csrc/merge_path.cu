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
// there; the only other device reads are the partition pass's searches
// (about 2k log2(run) words per tile of T rows).
//
// Design: two launches a round. A merge CTA that searched its own split in
// device memory would have no loads in flight for log(run) dependent round
// trips, so the searches come first, all at once:
//   1. partition_kernel: one thread per tile of T = 2^tile_log2 outputs
//      finds the number of A rows among the pair's outputs before the tile
//      by binary search on the diagonal (A wins ties, as at the
//      reference's merge_path.py:270-279) and writes it to `splits`, an
//      int32 per tile the wrapper allocates. (A 32-lane search per tile
//      touched 64 sectors a step and cost several times as much.)
//   2. merge_kernel: CTA b reads its two splits and at once issues
//      asynchronous copies (cp.async, 8 B a word and 4 B an index: the
//      segments start at any row, so 16-B alignment is not given) of the A
//      and B segments they bound, T rows together, into shared memory.
//      Each thread then finds its diagonal (merge_path) and merges kItems
//      outputs into registers (serial_merge, merge_tile.cuh), records
//      which shared row each output takes, and the CTA writes its outputs
//      in order, coalesced. Several CTAs share an SM (three at T = 4096,
//      one word, 512 threads each), so one CTA's copies are in flight while
//      another merges; a persistent CTA with a two-stage ring of copies ran
//      no faster at T = 2048 and slower at T = 4096, where one CTA fills an
//      SM. Eight outputs a thread, not sixteen, halve each CTA's merge.
// The TPU kernel's 1024-aligned windows, flat rotations, Batcher odd-even
// network, int32 limbs and "carry" payload limbs have no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_tile.cuh"

namespace {

constexpr int kItems = 8;  // outputs a thread merges
constexpr int kLogItems = 3;
constexpr int kMaxThreads = 1024;
constexpr int kMinLog2 = 6;
constexpr int kMaxLog2 = 13;  // kItems * kMaxThreads outputs
constexpr int kPartitionThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// The slot of output position i >= 0 in the output map: one pad slot every
// kItems, so a thread's kItems consecutive outputs fall in distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> kLogItems); }

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

// Where tile `tile` of the round lies: its pair, the pair's run lengths,
// and its first output's diagonal in the pair.
struct TilePlace {
  long long out_start, pair_start, b_start, la, lb, d0;

  __device__ TilePlace(long long tile, int tile_log2, long long n,
                       long long run) {
    out_start = tile << tile_log2;
    pair_start = out_start / (2 * run) * (2 * run);
    b_start = pair_start + run;
    la = b_start < n ? run : n - pair_start;
    lb = b_start >= n ? 0 : (n - b_start < run ? n - b_start : run);
    d0 = out_start - pair_start;
  }
};

// One thread per tile: the number of A rows among the pair's first d0
// outputs, the least m in [max(0, d0 - lb), min(d0, la)] with A[m] after
// B[d0 - 1 - m], by binary search in device memory (A wins ties, as at the
// reference's merge_path.py:270-279). A run with no partner gets d0.
template <int K>
__global__ void __launch_bounds__(kPartitionThreads)
partition_kernel(const u64* __restrict__ in, long long n, int k,
                 long long run, int tile_log2, long long tiles,
                 int32_t* __restrict__ splits) {
  const long long tile =
      static_cast<long long>(blockIdx.x) * kPartitionThreads + threadIdx.x;
  if (tile >= tiles) return;
  const TilePlace p(tile, tile_log2, n, run);
  long long lo = p.d0 > p.lb ? p.d0 - p.lb : 0;
  long long hi = p.d0 < p.la ? p.d0 : p.la;
  while (lo < hi) {
    const long long m = (lo + hi) >> 1;
    if (after_global<K>(in, n, k, p.pair_start + m,
                        p.b_start + p.d0 - 1 - m)) {
      hi = m;
    } else {
      lo = m + 1;
    }
  }
  splits[tile] = static_cast<int32_t>(lo);
}

__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
  }
}

// A tile's input: its A segment's and B segment's first rows (B's as if it
// started at slot 0), A's length and the tile's output count.
struct Segments {
  long long out_start, a_src, b_src;
  int las, count;
};

// The segments of the tile at `p`, from its split a0 and the next tile's
// split a1 (used only when the tile does not end its pair).
__device__ __forceinline__ Segments segments(const TilePlace& p, int t_rows,
                                             long long a0, long long a1) {
  const long long total = p.la + p.lb;
  const long long d1 = p.d0 + t_rows < total ? p.d0 + t_rows : total;
  Segments g;
  g.out_start = p.out_start;
  g.count = static_cast<int>(d1 - p.d0);
  g.las = static_cast<int>((d1 == total ? p.la : a1) - a0);
  g.a_src = p.pair_start + a0;
  g.b_src = p.b_start + (p.d0 - a0) - g.las;
  return g;
}

// K3's tile in shared memory: word 0 of each loaded row (the A segment at
// slots [0, las), then B), words 1 .. k-1, and the row indices.
struct Stage {
  u64* key;
  u64* rest;
  int32_t* idx;

  __device__ Stage(u64* base, int words, int t_rows)
      : key(base),
        rest(base + t_rows + 1),
        idx(reinterpret_cast<int32_t*>(base + t_rows + 1 +
                                       static_cast<size_t>(words - 1) * t_rows)) {}

  // u64s a stage takes: word 0 (T rows and a slack row), the other words,
  // the indices
  __host__ __device__ static long long size(int words, int t_rows) {
    return t_rows + 1 + static_cast<long long>(words - 1) * t_rows + t_rows / 2;
  }

  __device__ __forceinline__ Row load(int i) const { return Row{key[i], i}; }
};

// Issue the asynchronous copies of a tile's segments into `st`, as one
// group.
__device__ __forceinline__ void copy_segments(const Segments& g,
                                              const u64* in,
                                              const int32_t* idx_in,
                                              long long n, int words,
                                              int t_rows, const Stage& st) {
  for (int i = threadIdx.x; i < g.count; i += blockDim.x) {
    const long long src = i < g.las ? g.a_src + i : g.b_src + i;
    copy_async(st.key + i, in + src, 8);
    for (int w = 1; w < words; ++w) {
      copy_async(st.rest + (w - 1) * t_rows + i, in + w * n + src, 8);
    }
    copy_async(st.idx + i, idx_in + src, 4);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Each thread merges kItems outputs of the loaded tile and records, at each
// output's padded slot of `slot`, which loaded row it takes.
template <int K>
__device__ __forceinline__ void merge_segments(const Segments& g, int k,
                                               int t_rows, const Stage& st,
                                               int32_t* slot) {
  const Order<K> ord{st.rest, t_rows, k};
  const int first = threadIdx.x * kItems;
  const int diag = first < g.count ? first : g.count;
  Row r[kItems];
  const int m = merge_path(st, ord, 0, g.las, g.las, g.count - g.las, diag);
  serial_merge<kItems>(st, ord, m, g.las, g.las + diag - m, g.count, r);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + i < g.count) slot[pad(first + i)] = r[i].pos;
  }
}

// The tile's outputs in order, coalesced, through the slot map.
__device__ __forceinline__ void write_tile(const Segments& g, long long n,
                                           int words, int t_rows,
                                           const Stage& st,
                                           const int32_t* slot,
                                           u64* __restrict__ out,
                                           int32_t* __restrict__ idx_out) {
  for (int i = threadIdx.x; i < g.count; i += blockDim.x) {
    const int s = slot[pad(i)];
    const long long o = g.out_start + i;
    out[o] = st.key[s];
    for (int w = 1; w < words; ++w) out[w * n + o] = st.rest[(w - 1) * t_rows + s];
    idx_out[o] = st.idx[s];
  }
}

// One tile a CTA: its segments' copies, then the merge, then the writes;
// several CTAs on an SM overlap one's copies with another's merge.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
merge_kernel(const u64* __restrict__ in, const int32_t* __restrict__ idx_in,
             long long n, int k, long long run, int tile_log2,
             long long tiles, const int32_t* __restrict__ splits,
             u64* __restrict__ out, int32_t* __restrict__ idx_out) {
  extern __shared__ u64 smem[];
  const int words = K > 0 ? K : k;
  const int t_rows = 1 << tile_log2;
  const Stage st(smem, words, t_rows);
  int32_t* slot = reinterpret_cast<int32_t*>(smem + Stage::size(words, t_rows));
  const long long b = blockIdx.x;
  const Segments g = segments(TilePlace(b, tile_log2, n, run), t_rows,
                              splits[b], splits[b + 1 < tiles ? b + 1 : b]);
  copy_segments(g, in, idx_in, n, words, t_rows, st);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  merge_segments<K>(g, k, t_rows, st, slot);
  __syncthreads();
  write_tile(g, n, words, t_rows, st, slot, out, idx_out);
}

// Shared memory of a tile of T rows: its Stage and the padded output map.
long long merge_smem(int words, int tile_log2) {
  const int t = 1 << tile_log2;
  return 8 * Stage::size(words, t) + 4LL * (t + (t >> kLogItems) + 1);
}

template <int K>
cudaError_t launch(const u64* in, const int32_t* idx_in, long long n, int k,
                   long long run, int tile_log2, int32_t* splits, u64* out,
                   int32_t* idx_out, cudaStream_t stream) {
  const long long tiles = (n + (1LL << tile_log2) - 1) >> tile_log2;
  const long long part_blocks = (tiles + kPartitionThreads - 1) / kPartitionThreads;
  partition_kernel<K><<<static_cast<unsigned>(part_blocks), kPartitionThreads, 0,
                        stream>>>(in, n, k, run, tile_log2, tiles, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return err;
  const int smem = static_cast<int>(merge_smem(k, tile_log2));
  // set on every launch: the default 48 KB also counts static shared memory
  err = cudaFuncSetAttribute(merge_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  merge_kernel<K><<<static_cast<unsigned>(tiles), (1 << tile_log2) / kItems,
                    smem, stream>>>(in, idx_in, n, k, run, tile_log2, tiles,
                                    splits, out, idx_out);
  return cudaGetLastError();
}

int checked(const void* words, long long n, int k, long long run,
            int tile_log2) {
  if (words == nullptr || k < 1 || tile_log2 < kMinLog2 ||
      tile_log2 > kMaxLog2 || run <= 0 || run % (1LL << tile_log2) != 0 ||
      merge_smem(k, tile_log2) > kSmemLimit || n >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

cudaError_t dispatch(const void* words, const void* idx, long long n, int k,
                     long long run, int tile_log2, void* splits, void* out,
                     void* idx_out, void* stream) {
  const u64* in = static_cast<const u64*>(words);
  const int32_t* ii = static_cast<const int32_t*>(idx);
  int32_t* sp = static_cast<int32_t*>(splits);
  u64* o = static_cast<u64*>(out);
  int32_t* io = static_cast<int32_t*>(idx_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(in, ii, n, k, run, tile_log2, sp, o, io, s);
    case 2: return launch<2>(in, ii, n, k, run, tile_log2, sp, o, io, s);
    default: return launch<0>(in, ii, n, k, run, tile_log2, sp, o, io, s);
  }
}

}  // namespace

extern "C" {

int gt_merge_path_smem_limit() { return kSmemLimit; }

int gt_merge_path_items() { return kItems; }

const char* gt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The partition pass alone: splits [tiles] int32 gets, for each tile of
// 2^tile_log2 outputs, the number of A rows of its pair before it.
int gt_merge_partition(const void* words, long long n, int k, long long run,
                       int tile_log2, void* splits, void* stream) {
  if (n <= 0) return 0;
  const int bad = checked(words, n, k, run, tile_log2);
  if (bad) return bad;
  return static_cast<int>(dispatch(words, nullptr, n, k, run, tile_log2,
                                   splits, nullptr, nullptr, stream));
}

// One round over words [k][n] and idx [n] whose runs of `run` rows are
// sorted: out / idx_out get runs of 2 * run rows, merged. `run` is a multiple
// of the 2^tile_log2 outputs each CTA produces; splits is scratch of one
// int32 per tile.
int gt_merge_round(const void* words, const void* idx, long long n, int k,
                   long long run, int tile_log2, void* splits, void* out,
                   void* idx_out, void* stream) {
  if (n <= 0) return 0;
  const int bad = checked(words, n, k, run, tile_log2);
  if (bad) return bad;
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(words, idx, n, k, run, tile_log2, splits,
                                   out, idx_out, stream));
}

}  // extern "C"
