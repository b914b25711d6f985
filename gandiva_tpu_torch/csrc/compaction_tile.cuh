// The tile code shared by the two stream compactions, K1 (compaction.cu)
// and K2 (compaction_fragnet.cu), for Hopper, sm_90a.
//
// A tile is kTile = 4096 rows. Both compactions learn each tile's survivor
// count before they move its payloads: K1 from its count pass, K2 from its
// single pass, which records them when it has more payloads than one
// launch takes. ``scatter_kernel`` is the one offsets-given scatter: given
// every tile's count, it moves each tile's row indices and payloads to one
// contiguous run of the output, after the runs of the tiles before it. It
// is K1's second pass, and K2's launch for the payload groups past its
// first kMaxPayloads columns.
//
// The scatter (``launch_scatter``) runs persistent CTAs, as many an SM as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor allows for their shared
// memory (one at the flagship's widths). A CTA walks the work items
// blockIdx.x, + gridDim.x, ...; an item is one tile and one group of
// payload columns (plan_stages, at most kScatterRowBytes staged bytes a
// row). One producer warp and two groups of eight consumer warps, which
// take every other item, share a ring of stages in shared memory, as many
// as it holds (up to kMaxStages):
//   - Producer warp: sums the counts of the tiles before the item's tile
//     (its offset; each CTA reads the counts once, from L2, so no scan
//     runs between the passes), and its first lane issues the stage's
//     loads, as many items ahead of the consumers as the ring has stages.
//     The mask and every column in which the survivors touch about half
//     the 32-byte sectors or more (kBulkMin8) are loaded whole, with 1-D
//     bulk copies (cp.async.bulk, no tensor map) that complete on the
//     stage's mbarrier. An empty tile loads nothing; a tile whose rows all
//     survive loads no mask.
//   - Consumers: take each row's flag from the mask in shared memory, 16
//     rows a thread in one 16-byte load, rank the survivors by a block scan
//     and write each survivor's tile position at its rank (a 2-byte
//     position list). Columns too sparse to load whole, and every column of
//     a ragged tile or a view that is not 16-B aligned, are copied survivor
//     by survivor into the stage (cp.async for 4 and 8 bytes). Then
//     thread i of the group writes survivors i, i + 256, ...: index and
//     payloads, read from the stage through the position list, as one
//     contiguous run; 1- and 2-byte columns leave in 4-byte words where
//     the run allows. The two groups take turns to
//     write, in item order, so one group ranks and copies while the other
//     writes. No payload element waits in registers, and the group
//     releases the stage on its empty mbarrier.

#pragma once

#include <cstdint>
#include <mutex>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 16;
constexpr int kTile = kThreads * kIters;  // rows per tile
constexpr int kMaxPayloads = 8;
constexpr unsigned kFull = 0xffffffffu;

// The scatter: staged payload bytes a row per group (4096 x 16 B = 64 KB);
// two groups of eight consumer warps, then the producer warp; at most
// kMaxStages stages in the ring, fewer where the shared memory a block may
// take holds fewer (3 at the flagship's 9 bytes a row: 140 KB, one CTA an
// SM; two CTAs with no payload). Two groups and three stages were the
// fastest of the builds timed at the flagship shape and at density 0.97
// (PERF.md, K1's findings).
constexpr int kScatterRowBytes = 16;
constexpr int kConsumerGroups = 2;
constexpr int kScatterThreads = kConsumerGroups * kThreads + 32;
constexpr int kMaxStages = 3;
// A column of w bytes is loaded whole when the tile has at least
// kBulkMin8 * w / 8 survivors: at 704 an 8-byte column's survivors
// (density 0.17) touch 1 - 0.83^4 = 53% of its sectors, and a 1-byte
// column's 88 (density 0.021) 1 - 0.979^32 = 49%.
constexpr int kBulkMin8 = 704;
constexpr int kMaskBulk = 1 << kMaxPayloads;  // flag: the mask is loaded whole

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
// kMaxPayloads columns, a width other than 1, 2, 4 or 8, or a column not
// aligned to its width.
inline bool make_payloads(int num_payloads, const void* const* ins,
                          void* const* outs, const int* widths, Payloads* p) {
  if (num_payloads < 0 || num_payloads > kMaxPayloads) return false;
  *p = Payloads{};
  p->count = num_payloads;
  for (int k = 0; k < num_payloads; ++k) {
    const int w = widths[k];
    if (w != 1 && w != 2 && w != 4 && w != 8) return false;
    if (reinterpret_cast<uintptr_t>(ins[k]) % w != 0 ||
        reinterpret_cast<uintptr_t>(outs[k]) % w != 0) {
      return false;
    }
    p->in[k] = ins[k];
    p->out[k] = outs[k];
    p->width[k] = w;
  }
  return true;
}

// Which payload columns are staged together: group g holds columns
// [end[g - 1], end[g]), each column's tile at ``offset[k]`` bytes into the
// group's staging buffer.
struct StagePlan {
  int groups;
  int stage_bytes;  // the widest group's tiles
  int end[kMaxPayloads];
  int offset[kMaxPayloads];
};

// Consecutive columns, each tile aligned to its element width (so to 16 B),
// at most ``row_bytes`` a row per group; any one column fits a group alone.
inline StagePlan plan_stages(const Payloads& p, int row_bytes) {
  StagePlan plan{};
  int used = 0;
  for (int k = 0; k < p.count; ++k) {
    const int w = p.width[k];
    int at = (used + w - 1) / w * w;
    if (k > 0 && at + w > row_bytes) {
      plan.end[plan.groups++] = k;
      at = 0;
    }
    plan.offset[k] = at * kTile;
    used = at + w;
    if (used * kTile > plan.stage_bytes) plan.stage_bytes = used * kTile;
  }
  if (p.count > 0) plan.end[plan.groups++] = p.count;
  return plan;
}

// -- asynchronous copies ---------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(smem)),
                 "l"(gmem), "n"(kBytes));
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for all of this thread's copies, committed or not.
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 1-D bulk copy of ``bytes`` (a multiple of 16, both ends 16-B aligned)
// that completes on ``bar``.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The write turn between the two consumer groups: group 0 passes it to
// group 1 on barrier 3, group 1 back on barrier 4 (all 512 consumers).
__device__ __forceinline__ void wait_turn(int group) {
  if (group == 0) {
    asm volatile("bar.sync 4, %0;\n" ::"n"(2 * kThreads) : "memory");
  } else {
    asm volatile("bar.sync 3, %0;\n" ::"n"(2 * kThreads) : "memory");
  }
}

__device__ __forceinline__ void pass_turn(int group) {
  if (group == 0) {
    asm volatile("bar.arrive 3, %0;\n" ::"n"(2 * kThreads) : "memory");
  } else {
    asm volatile("bar.arrive 4, %0;\n" ::"n"(2 * kThreads) : "memory");
  }
}

// The barrier of one group of eight consumer warps (barrier 0 is
// __syncthreads).
__device__ __forceinline__ void consumer_sync(int group) {
  // immediate barrier ids: a register id makes ptxas reserve all 16
  if (group == 0) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  } else {
    asm volatile("bar.sync 2, %0;\n" ::"n"(kThreads) : "memory");
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Bit r of the result is set when byte r of ``v`` is not zero.
__device__ __forceinline__ unsigned nonzero_bits(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned f = w[k] | (w[k] >> 4);
    f |= f >> 2;
    f |= f >> 1;
    f &= 0x01010101u;
    // bytes 0..3 of f hold bit 0 each: gather them into bits 28..31
    bits |= ((f * 0x10204080u) >> 28) << (4 * k);
  }
  return bits;
}

// -- the offsets-given scatter ---------------------------------------------

// A tile's survivor j sits at tile position pos(j): its entry of the
// position list, or j itself when every row of the tile survives.
struct Positions {
  const uint16_t* s_pos;
  bool identity;
  __device__ __forceinline__ int operator()(int j) const {
    return identity ? j : s_pos[j];
  }
};

// A column of W bytes that was not loaded whole: its survivors' elements,
// each to its tile position in the stage.
template <int W>
__device__ __forceinline__ void stage_elements(const void* in,
                                               unsigned char* stage,
                                               long long base, int count,
                                               Positions pos, int tid) {
  const unsigned char* src = static_cast<const unsigned char*>(in) + base * W;
  for (int j = tid; j < count; j += kThreads) {
    const int p = pos(j);
    if constexpr (W >= 4) {
      copy_async<W>(stage + p * W, src + p * W);
    } else {
      using T = typename std::conditional<W == 2, uint16_t, uint8_t>::type;
      reinterpret_cast<T*>(stage)[p] = reinterpret_cast<const T*>(src)[p];
    }
  }
}

// Survivors [0, count) of a staged column to out[offset ...]; ``tid`` is
// the thread's place among the kThreads that share the work.
template <typename T>
__device__ __forceinline__ void write_column(const unsigned char* stage,
                                             void* out_, int offset,
                                             int count, Positions pos,
                                             int tid) {
  const T* s = reinterpret_cast<const T*>(stage);
  T* out = static_cast<T*>(out_) + offset;
  if constexpr (sizeof(T) >= 4) {
#pragma unroll 4
    for (int j = tid; j < count; j += kThreads) out[j] = s[pos(j)];
  } else {
    // a head up to the first 4-B aligned element, then 4-byte words of
    // kPer elements each, then the tail
    constexpr int kPer = 4 / sizeof(T);
    const int head = min(
        count, static_cast<int>((-(reinterpret_cast<uintptr_t>(out) /
                                   sizeof(T))) & (kPer - 1)));
    const int words = (count - head) / kPer;
    if (tid < head) out[tid] = s[pos(tid)];
    uint32_t* ow = reinterpret_cast<uint32_t*>(out + head);
#pragma unroll 2
    for (int w = tid; w < words; w += kThreads) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        word |= static_cast<uint32_t>(s[pos(head + w * kPer + e)])
                << (8 * sizeof(T) * e);
      }
      ow[w] = word;
    }
    for (int j = head + words * kPer + tid; j < count; j += kThreads) {
      out[j] = s[pos(j)];
    }
  }
}

// At most 56 registers (no spill), so two CTAs fit an SM where their shared
// memory does (with no payload); at 64 the 544 threads left one.
__global__ void __launch_bounds__(kScatterThreads, 2)
scatter_kernel(const uint8_t* __restrict__ mask, long long n,
               const int32_t* __restrict__ tile_counts, long long tiles,
               int32_t* __restrict__ idx_out, int32_t* __restrict__ count_out,
               Payloads p, StagePlan plan, int stages) {
  // dynamic shared memory: ``stages`` stages of (mask tile, payload tiles
  // of one group), then each consumer group's position list
  extern __shared__ __align__(128) unsigned char smem[];
  const int stride = kTile + plan.stage_bytes;
  __shared__ __align__(8) unsigned long long full[kMaxStages];
  __shared__ __align__(8) unsigned long long empty[kMaxStages];
  __shared__ int4 s_item[kMaxStages];  // tile, offset, count, flags
  __shared__ int s_warp[kConsumerGroups][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long items = tiles * (plan.groups > 0 ? plan.groups : 1);

  if (warp == kConsumerGroups * kWarps) {
    // the producer warp: all lanes sum the counts before the item's tile
    // (each CTA reads the counts once a group, from L2), lane 0 loads
    const bool mask_aligned = aligned16(mask);
    long long k = 0, done = 0;  // done: tiles whose counts are in ``start``
    int start = 0;
    for (long long item = blockIdx.x; item < items;
         item += gridDim.x, ++k) {
      const int g = static_cast<int>(item / tiles);
      const long long t = item - g * tiles;
      if (t < done) done = start = 0;  // a new group starts at tile 0
      int sum = 0;
      for (long long i = done + lane; i < t; i += 32) sum += tile_counts[i];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
      start += sum;
      done = t;
      if (lane != 0) continue;
      const int count = tile_counts[t];
      if (count_out != nullptr && g == 0 && t == tiles - 1) {
        *count_out = start + count;
      }
      const int s = static_cast<int>(k % stages);
      mbar_wait(&empty[s], static_cast<unsigned>(k / stages & 1) ^ 1u);
      const long long base = t * kTile;
      const bool whole = base + kTile <= n;
      unsigned char* stage = smem + s * stride;
      int flags = 0;
      unsigned bytes = 0;
      if (count > 0 && count < kTile && whole && mask_aligned) {
        flags |= kMaskBulk;
        bytes += kTile;
      }
      const int first = g > 0 ? plan.end[g - 1] : 0;
      const int last = plan.groups > 0 ? plan.end[g] : 0;
      for (int c = first; c < last; ++c) {
        const int w = p.width[c];
        if (count > 0 && whole && count * 8 >= kBulkMin8 * w &&
            aligned16(p.in[c])) {
          flags |= 1 << c;
          bytes += kTile * w;
        }
      }
      s_item[s] = make_int4(static_cast<int>(t), start, count, flags);
      if (bytes == 0) {
        mbar_arrive(&full[s]);
        continue;
      }
      mbar_arrive_expect(&full[s], bytes);
      if (flags & kMaskBulk) bulk_load(stage, mask + base, kTile, &full[s]);
      for (int c = first; c < last; ++c) {
        if (flags & (1 << c)) {
          const int w = p.width[c];
          bulk_load(stage + kTile + plan.offset[c],
                    static_cast<const unsigned char*>(p.in[c]) + base * w,
                    kTile * w, &full[s]);
        }
      }
    }
    return;
  }

  // the consumers: group ``group`` takes every other item, with its own
  // position list and barrier
  const int group = warp / kWarps;
  const int tid = threadIdx.x - group * kThreads;
  const int gwarp = warp - group * kWarps;
  uint16_t* s_pos = reinterpret_cast<uint16_t*>(smem + stages * stride) +
                    group * kTile;
  for (long long k = group, item = blockIdx.x + k * gridDim.x; item < items;
       k += kConsumerGroups, item += kConsumerGroups * gridDim.x) {
    const int s = static_cast<int>(k % stages);
    mbar_wait(&full[s], static_cast<unsigned>(k / stages & 1));
    const int4 it = s_item[s];
    const long long base = static_cast<long long>(it.x) * kTile;
    const int offset = it.y, count = it.z, flags = it.w;
    const int rows = static_cast<int>(n - base < kTile ? n - base : kTile);
    unsigned char* stage = smem + s * stride;
    const int g = static_cast<int>(item / tiles);
    const int first = g > 0 ? plan.end[g - 1] : 0;
    const int last = plan.groups > 0 ? plan.end[g] : 0;
    const Positions pos{s_pos, count == rows};
    bool wrote = false;  // generic writes to the stage
    if (count > 0 && !pos.identity) {
      if (!(flags & kMaskBulk)) {
        wrote = true;
        for (int j = tid; j < kTile; j += kThreads) {
          stage[j] = j < rows ? mask[base + j] : 0;
        }
        consumer_sync(group);
      }
      // rows 16 tid .. 16 tid + 15 of the tile: flags, then ranks by a scan
      unsigned bits = nonzero_bits(reinterpret_cast<const uint4*>(stage)[tid]);
      const int mine = __popc(bits);
      int incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      if (lane == 31) s_warp[group][gwarp] = incl;
      consumer_sync(group);
      int rank = incl - mine;
      for (int w = 0; w < gwarp; ++w) rank += s_warp[group][w];
      while (bits) {
        const int r = __ffs(bits) - 1;
        s_pos[rank++] = static_cast<uint16_t>(tid * 16 + r);
        bits &= bits - 1;
      }
      consumer_sync(group);
    }
    bool staged = false;
    for (int c = first; c < last && count > 0; ++c) {
      if (flags & (1 << c)) continue;
      unsigned char* col = stage + kTile + plan.offset[c];
      switch (p.width[c]) {
        case 8: stage_elements<8>(p.in[c], col, base, count, pos, tid); break;
        case 4: stage_elements<4>(p.in[c], col, base, count, pos, tid); break;
        case 2: stage_elements<2>(p.in[c], col, base, count, pos, tid); break;
        default: stage_elements<1>(p.in[c], col, base, count, pos, tid); break;
      }
      staged = true;
    }
    if (staged) {
      wait_copies();
      consumer_sync(group);
      wrote = true;
    }
    // the groups write one at a time, in item order: one group's ranks and
    // copies overlap the other's writes
    if (k > 0) wait_turn(group);
    if (count > 0 && g == 0 && idx_out != nullptr) {
#pragma unroll 4
      for (int j = tid; j < count; j += kThreads) {
        idx_out[offset + j] = static_cast<int32_t>(base + pos(j));
      }
    }
    for (int c = first; c < last && count > 0; ++c) {
      const unsigned char* col = stage + kTile + plan.offset[c];
      void* out = p.out[c];
      switch (p.width[c]) {
        case 8: write_column<uint64_t>(col, out, offset, count, pos, tid); break;
        case 4: write_column<uint32_t>(col, out, offset, count, pos, tid); break;
        case 2: write_column<uint16_t>(col, out, offset, count, pos, tid); break;
        default: write_column<uint8_t>(col, out, offset, count, pos, tid); break;
      }
    }
    if (item + gridDim.x < items) pass_turn(group);
    // this thread's generic writes to the stage come before the next bulk
    // copy into it
    if (wrote) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// The scatter's launch on one device for one stage size: its stages, its
// dynamic shared memory and its grid (SMs x resident CTAs an SM), worked
// out once and kept; the lock keeps two host threads from filling the
// cache at once.
struct ScatterShape {
  int device;
  int stride;  // bytes a stage
  int stages;
  int smem;
  int blocks;
};
ScatterShape g_scatter_shapes[64];
int g_num_scatter_shapes = 0;
std::mutex g_scatter_shapes_lock;

constexpr int kPosBytes =
    kConsumerGroups * kTile * static_cast<int>(sizeof(uint16_t));

inline cudaError_t scatter_shape(const StagePlan& plan, ScatterShape* shape) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int stride = kTile + plan.stage_bytes;
  const std::lock_guard<std::mutex> hold(g_scatter_shapes_lock);
  for (int i = 0; i < g_num_scatter_shapes; ++i) {
    const ScatterShape& s = g_scatter_shapes[i];
    if (s.device == device && s.stride == stride) {
      *shape = s;
      return cudaSuccess;
    }
  }
  // as many stages as a block's shared memory holds, beside the static
  // shared memory and the position lists
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, scatter_kernel);
  if (err != cudaSuccess) return err;
  optin -= static_cast<int>(attr.sharedSizeBytes);
  int stages = (optin - kPosBytes) / stride;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 2) return cudaErrorInvalidValue;
  const int smem = stages * stride + kPosBytes;
  // the most any launch takes, so no launch is refused for another's
  // setting
  err = cudaFuncSetAttribute(scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scatter_kernel, kScatterThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *shape = ScatterShape{device, stride, stages, smem, sms * per_sm};
  if (g_num_scatter_shapes < 64) {
    g_scatter_shapes[g_num_scatter_shapes++] = *shape;
  }
  return cudaSuccess;
}

// Moves the survivors of ``p``'s columns (and their row indices, unless
// ``idx_out`` is null) to the runs that ``tile_counts`` gives, and writes
// the survivor count to ``count_out`` unless it is null: one launch.
inline cudaError_t launch_scatter(const uint8_t* mask, long long n,
                                  const int32_t* tile_counts,
                                  int32_t* idx_out, int32_t* count_out,
                                  const Payloads& p, cudaStream_t stream) {
  if (n <= 0 || (idx_out == nullptr && p.count == 0)) return cudaSuccess;
  const StagePlan plan = plan_stages(p, kScatterRowBytes);
  ScatterShape shape;
  cudaError_t err = scatter_shape(plan, &shape);
  if (err != cudaSuccess) return err;
  const long long tiles = num_tiles(n);
  const long long items = tiles * (plan.groups > 0 ? plan.groups : 1);
  const int grid = static_cast<int>(items < shape.blocks ? items
                                                         : shape.blocks);
  scatter_kernel<<<grid, kScatterThreads, shape.smem, stream>>>(
      mask, n, tile_counts, tiles, idx_out, count_out, p, plan, shape.stages);
  return cudaGetLastError();
}

}  // namespace
