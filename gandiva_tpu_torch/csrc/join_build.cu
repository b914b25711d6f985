// The join build's run detection and first-fit placement for Hopper, sm_90a:
// the duplicate-run hash table of ops/hash_join.py::_build_ranges_table.
//
// Replaces no Pallas kernel. The reference computes the table with array
// operations (gandiva_tpu/ops/hash_join.py::_build_ranges_table: a reversed
// lax.cummin over the run starts, then the placement's lax.cummax), which
// XLA fuses on a TPU. The port's plain version runs the same chain as about
// thirty torch operations, whose two scans (torch.cummin, torch.cummax) run
// over a 1-D tensor as one row, in one thread block: over a build of 4.5M
// rows on an H100 they took 12.0 and 14.0 ms, where the bytes take tens of
// microseconds.
//
// Bound: bytes. Detection reads each sorted key once (8 B; its left
// neighbour comes from the same sectors) and, at a run of one row, its
// perm entry (4 B); it writes each row's home word (8 B) and each run start's
// 16-byte row. Placement reads each run start's sorted home word, its order
// entry and, through it, its row (8 + 4 + 16 B), and writes the row into the
// table (16 B); rows that start no run are not touched there.
//
// Both kernels are single-pass scans with the decoupled look-back of
// lookback.cuh, which K2's prefix sum (compaction_fragnet.cu) also takes,
// over 62-bit values: one CTA per tile of kTile = 4096 rows,
// 256 threads, each warp a run of 512 consecutive rows in 16 slots of 32; a
// CTA takes its tile from an atomic ticket, so it waits only on tiles taken
// before it, by CTAs that are running.
//
// gt_join_detect (run detection, a suffix-min scan from the right): tiles
// are taken from the last one down. Per row i < nb, with nv = n_valid: a run
// starts at i if i < nv and (i == 0 or key[i] != key[i - 1]); the next start
// is the least start position after i (kNone if none), found from the ballots
// of the slots after i, the warps after it, and the tiles after it (the
// look-back); the run's length is min(next, nv) - i, so a valid max-key run
// that runs on into the pinned tail of invalid rows is cut back to the valid
// prefix. At a start the kernel writes the row (key lo, key hi, start, len),
// start being perm[i] for a run of one row when perm is given, else i; at
// every row the home word, (hash32(key) % T at a start, T_tot elsewhere;
// plan_prelude.h's gt_hash32, the hash32 of utils/hashing.py)
// with the sign bit flipped: the unsigned-order norm that the sort (K4, K3)
// takes. all_unique (no run longer than one row, and perm given) is reduced
// by the last CTA to finish. The look-back of a min over positions may stop
// at the nearest tile that holds any start: every tile beyond it holds only
// later ones.
//
// gt_join_place (placement, a max-scan from the left over the runs sorted
// by home): pos_i = i + max over j <= i of (home_j - j), first-fit linear
// probing in closed form, scanned as home_j - j + nb >= 1 so that every
// value is one the look-back holds and 0 lies below them all. Homes,
// positions and the scan are 64-bit: a table of T + nb slots may pass
// 2^31, as the plain version's int64 indices allow; only nb, whose
// positions the rows hold in int32, stays below 2^31. The row of sorted
// position i is rows[order[i]],
// written to table[pos_i]. The run starts sort first (home < T) and the
// other rows after them (home T_tot), so a tile whose first row starts no
// run holds none and leaves at once, and no tile that holds a start ever
// waits on one that holds none.
//
// The caller zeroes ``status`` before each build (2 * tiles + 4 64-bit
// words: detection's descriptors, its ticket, its finished-CTA counter and
// its duplicate flag, then placement's descriptors and ticket) and the
// table; nothing survives from one call to the next. Nothing syncs the host:
// n_valid is read on the device.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "plan_prelude.h"

namespace {

using gt_lookback::kFull;
using gt_lookback::look_back;
using gt_lookback::warp_reduce;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 16;                  // 32-row slots of a warp's run
constexpr int kWarpRows = 32 * kSlots;
constexpr int kTile = kWarps * kWarpRows;   // 4096 rows
constexpr unsigned long long kSign = 1ull << 63;
// no run start: the identity of detection's min, above every position
constexpr long long kNone = static_cast<long long>(gt_lookback::kValueMask);

// Detection's operator: the least run start, over the tiles after this one.
struct NextStart {
  static constexpr long long kIdentity = kNone;
  static constexpr bool kFromRight = true;
  // the nearest tile that holds a start ends the look-back: every tile
  // beyond it holds only later ones
  static constexpr bool kNearestEnds = true;
  __device__ static long long combine(long long a, long long b) {
    return min(a, b);
  }
};

// Placement's operator: the greatest home - row + nb (at least 1), over the
// tiles before this one.
struct Greatest {
  static constexpr long long kIdentity = 0;
  static constexpr bool kFromRight = false;
  static constexpr bool kNearestEnds = false;
  __device__ static long long combine(long long a, long long b) {
    return max(a, b);
  }
};

__global__ void __launch_bounds__(kThreads)
detect_kernel(const long long* __restrict__ keys, long long nb,
              const int32_t* __restrict__ n_valid_ptr, long long n_valid_value,
              const int32_t* __restrict__ perm,
              unsigned long long table_slots, long long dump,
              unsigned long long* __restrict__ status, long long tiles,
              int4* __restrict__ rows, unsigned long long* __restrict__ homes,
              uint8_t* __restrict__ all_unique) {
  __shared__ long long s_tile;
  __shared__ long long s_first[kWarps];
  __shared__ long long s_after;
  __shared__ int s_dup;
  if (threadIdx.x == 0) {
    s_tile = tiles - 1 -
             static_cast<long long>(atomicAdd(&status[tiles], 1ull));
    s_dup = 0;
  }
  __syncthreads();
  const long long tile = s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long run = tile * kTile + static_cast<long long>(warp) * kWarpRows;
  const long long nv =
      n_valid_ptr != nullptr ? *n_valid_ptr : n_valid_value;

  // run starts as one ballot a slot; home words; the warp's first start
  long long key[kSlots];
  unsigned starts[kSlots];
  long long first = kNone;
  bool dup = false;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const long long i = run + j * 32 + lane;
    const bool in = i < nb;
    const long long k = in ? keys[i] : 0;
    long long prev = __shfl_up_sync(kFull, k, 1);
    if (lane == 0 && in && i > 0) prev = keys[i - 1];
    const bool valid = in && i < nv;
    const bool differs = i == 0 || prev != k;
    const bool start = valid && differs;
    dup |= valid && !differs;
    starts[j] = __ballot_sync(kFull, start);
    key[j] = k;
    if (in) {
      const unsigned long long home =
          start ? gt_hash32<long long>(k, 0u) % table_slots
                : static_cast<unsigned long long>(dump);
      homes[i] = home ^ kSign;
    }
    if (first == kNone && starts[j] != 0) {
      first = run + j * 32 + __ffs(starts[j]) - 1;
    }
  }
  if (lane == 0) s_first[warp] = first;
  if (__any_sync(kFull, dup) && lane == 0) s_dup = 1;
  __syncthreads();
  if (warp == 0) {
    const long long tile_first =
        warp_reduce<NextStart>(lane < kWarps ? s_first[lane] : kNone);
    const long long after =
        look_back<NextStart>(status, tile, tiles, tile_first);
    if (lane == 0) s_after = after;
  }
  __syncthreads();

  // each start's run: from its slot's later lanes, later slots and warps,
  // and the tiles after this one (kNone if none: then the run ends at nv)
  long long next = s_after;
  for (int w = kWarps - 1; w > warp; --w) next = min(next, s_first[w]);
  const unsigned later = ~((2u << lane) - 1u);  // lanes above this one
#pragma unroll
  for (int j = kSlots - 1; j >= 0; --j) {
    const unsigned s = starts[j];
    const long long slot = run + j * 32;
    if ((s >> lane) & 1u) {
      const long long i = slot + lane;
      const unsigned above = s & later;
      const long long nxt = above ? slot + __ffs(above) - 1 : next;
      const int len = static_cast<int>(min(nxt, nv) - i);
      const int field = perm != nullptr && len == 1
                            ? perm[i]
                            : static_cast<int>(i);
      const unsigned long long u = static_cast<unsigned long long>(key[j]);
      rows[i] = make_int4(static_cast<int>(static_cast<unsigned>(u)),
                          static_cast<int>(static_cast<unsigned>(u >> 32)),
                          field, len);
    }
    if (s != 0) next = slot + __ffs(s) - 1;
  }

  // all_unique: the last CTA to finish reads every CTA's duplicate flag
  if (threadIdx.x == 0) {
    if (s_dup) atomicOr(&status[tiles + 2], 1ull);
    __threadfence();
    const unsigned long long done = atomicAdd(&status[tiles + 1], 1ull);
    if (done == static_cast<unsigned long long>(tiles - 1)) {
      __threadfence();
      const bool any_dup =
          gt_lookback::read_descriptor(&status[tiles + 2]) != 0;
      *all_unique = perm != nullptr && !any_dup;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
place_kernel(const unsigned long long* __restrict__ homes_sorted,
             const int32_t* __restrict__ order, long long nb, long long dump,
             const int4* __restrict__ rows, int4* __restrict__ table,
             unsigned long long* __restrict__ status, long long tiles) {
  __shared__ long long s_tile;
  __shared__ long long s_top[kWarps];
  __shared__ long long s_before;
  if (threadIdx.x == 0) {
    s_tile = static_cast<long long>(atomicAdd(&status[tiles], 1ull));
  }
  __syncthreads();
  const long long tile = s_tile;
  // the starts sort first: a tile that does not begin with one holds none
  if (static_cast<long long>(homes_sorted[tile * kTile] ^ kSign) == dump) {
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long run = tile * kTile + static_cast<long long>(warp) * kWarpRows;

  // home - row + nb (at least 1), the scanned value; 0 past the last row
  long long v[kSlots];
  unsigned starts[kSlots];
  long long top = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const long long i = run + j * 32 + lane;
    const long long h =
        i < nb ? static_cast<long long>(homes_sorted[i] ^ kSign) : dump;
    v[j] = i < nb ? h - i + nb : 0;
    starts[j] = __ballot_sync(kFull, h != dump);
    top = max(top, v[j]);
  }
  top = warp_reduce<Greatest>(top);
  if (lane == 0) s_top[warp] = top;
  __syncthreads();
  if (warp == 0) {
    const long long tile_top =
        warp_reduce<Greatest>(lane < kWarps ? s_top[lane] : 0);
    const long long before =
        look_back<Greatest>(status, tile, tiles, tile_top);
    if (lane == 0) s_before = before;
  }
  __syncthreads();

  long long carry = s_before;
  for (int w = 0; w < warp; ++w) carry = max(carry, s_top[w]);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (starts[j] == 0) continue;  // the starts are a prefix: none follow
    long long m = v[j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long up = __shfl_up_sync(kFull, m, d);
      if (lane >= d) m = max(m, up);
    }
    m = max(m, carry);
    if ((starts[j] >> lane) & 1u) {
      const long long i = run + j * 32 + lane;
      table[i + m - nb] = rows[order[i]];
    }
    carry = __shfl_sync(kFull, m, 31);
  }
}

}  // namespace

extern "C" {

int gt_join_build_tile_rows() { return kTile; }

const char* gt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Run detection over ``nb`` sorted int64 keys: ``n_valid`` from the int32
// at ``n_valid_ptr``, or ``n_valid_value`` where that is null; ``perm``
// (int32, may be null) the original row of each sorted one; ``table_slots``
// T and ``dump`` T_tot = T + nb. Writes ``rows`` (int32 [nb, 4], at run
// starts only), ``homes`` (int64 [nb]) and ``all_unique`` (one bool).
int gt_join_detect(const void* keys, long long nb, const void* n_valid_ptr,
                   long long n_valid_value, const void* perm,
                   long long table_slots, long long dump, void* status,
                   void* rows, void* homes, void* all_unique, void* stream) {
  if (nb <= 0) return 0;
  if (table_slots <= 0 || nb > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (nb + kTile - 1) / kTile;
  detect_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), nb,
      static_cast<const int32_t*>(n_valid_ptr), n_valid_value,
      static_cast<const int32_t*>(perm),
      static_cast<unsigned long long>(table_slots),
      dump, static_cast<unsigned long long*>(status), tiles,
      static_cast<int4*>(rows), static_cast<unsigned long long*>(homes),
      static_cast<uint8_t*>(all_unique));
  return static_cast<int>(cudaGetLastError());
}

// Placement: ``homes_sorted`` the home words in ascending order, ``order``
// (int32) the sorted position's row of ``rows``; each run start's row goes
// to table[pos] of ``table`` (int32 [T_tot, 4], zeroed). ``status`` is
// detection's, whose placement part starts after its first tiles + 3 words.
int gt_join_place(const void* homes_sorted, const void* order, long long nb,
                  long long dump, const void* rows, void* table, void* status,
                  void* stream) {
  if (nb <= 0) return 0;
  if (nb > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (nb + kTile - 1) / kTile;
  place_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(homes_sorted),
      static_cast<const int32_t*>(order), nb, dump,
      static_cast<const int4*>(rows), static_cast<int4*>(table),
      static_cast<unsigned long long*>(status) + tiles + 3, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
