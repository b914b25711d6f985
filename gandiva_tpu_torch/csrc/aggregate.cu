// One-pass GROUP BY over at most 1024 distinct int64 keys (kernel K5) for
// Hopper, sm_90a.
//
// Replaces gandiva_tpu/ops/kernels/agg_pallas.py::_kernel (driven by
// aggregate_pallas there, decoded by ops/hash_aggregate.py). Same contract,
// on native 64-bit types: per row an int64 key and a code (0 not in the
// table, 1 valid key, 2 null key; no code array means every row is 1), and
// up to kMaxValues value columns, each int64, uint64 or float64 with an
// optional validity mask. Per group it computes count_all and, per value
// column, count_valid, the sum (mod 2^64 for integers, f64 for floats), min
// and max. Groups come out in ascending key order, the null-key group in
// row gcap; more than gcap distinct keys sets the overflow flag and leaves
// the rest unspecified.
//
// Bound: bytes. Each row is read once (8 B key, 8 B per value column, 1 B
// per code or validity mask); the outputs are a few KB. The design keeps
// that one read coalesced and in flight, and keeps the per-row work off
// contended shared-memory atomics (every 64-bit shared atomic on sm_90 is a
// compare-and-swap loop, ATOMS.CAST.SPIN.64 in the SASS):
//   1. init_kernel sets the global scratch (group table, accumulators) to
//      its identities.
//   2. accumulate_kernel: every CTA owns a shared-memory hash table (a key
//      and a separate state word per slot, so no key value is a sentinel:
//      0 empty, -1 being claimed, -2 dead, idx + 1 ready; up to
//      kTableFactor slots a group) that maps a key to a dense CTA-local
//      index. A warp takes 32 x kRowsPerLane rows a step (rows lane,
//      lane + 32, ...: each load coalesced) and issues every load of the
//      next step (keys, codes, values, validity) before this step's first
//      probe, so two steps of loads are in flight. A probe
//      that finds its key reads the slot's state with an acquire load and
//      takes no fence; only an insert fences. The accumulators live in
//      copies in shared memory, one per warp where 16 fit (the private
//      variant), else as many as fit, each shared by a group of warps (the
//      shared variant). Both aggregate over the warp first:
//      __match_any_sync on the resolved group id gives each distinct group
//      of a warp-step one leader, which adds the popcounts of its peers
//      (and of the validity ballot) to count_all and count_valid. Sums and
//      min/max order keys follow in rounds, round k taking the peers of
//      rank k, so no two lanes of a round touch one word; when a group
//      repeats more than kMaxRounds times in the step, the peers reduce by
//      pointer jumping (5 shuffle steps) and the leader writes once. The
//      private variant writes its warp's copy with plain loads and stores;
//      the shared one with shared atomics, which then collide only across
//      warps. CTAs walk the rows with a grid stride; blocks run in no order,
//      so nothing carries over between them. At its end each CTA sums its
//      copies and merges its groups into one global table of the same form
//      with global atomics.
//   3. finish_kernel (one CTA): each group's rank is the number of smaller
//      keys; it writes the groups at their ranks, then the null-key row and
//      identity rows.
// The TPU kernel's sequential-grid discovery, 16-bit limb sums and f32
// planes have no counterpart here. configs[1]'s 64 groups and one column
// take the private variant (43 KB of copies); 1024 groups and 4 columns
// take the shared one with one 139 KB copy.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 1024;
constexpr int kMaxValues = 4;
constexpr int kMaxGroups = 1024;
constexpr int kMaxRounds = 4;
constexpr int kTableFactor = 8;  // a CTA table's slots a group, at most
constexpr int kSharedBudget = 232448;  // the most a block may have on sm_90
constexpr int kKindUint64 = 1;
constexpr int kKindFloat64 = 2;
constexpr int kWantSum = 1;
constexpr int kWantMinMax = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kI64Max = 0x7fffffffffffffffLL;
constexpr long long kI64Min = -kI64Max - 1;
constexpr long long kNanMinKey = 0x7ff8000000000000LL;  // above +inf
constexpr long long kNanMaxKey = kI64Min + 1;           // below -inf
// Accumulator rows per value column, each of gcap + 2 group rows.
constexpr int kRowCountValid = 0;
constexpr int kRowSum = 1;
constexpr int kRowMin = 2;
constexpr int kRowMax = 3;
constexpr int kAccRows = 4;

// Rows a lane takes a warp-step: 2 with no value column, 1 with any; with
// the next step's loads in flight as well, that is 4 or 2 rows a lane. More
// rows in registers cost warps an SM and were slower (PERF.md).
template <int NV>
constexpr int kRowsPerLane = NV == 0 ? 2 : 1;

struct Values {
  const void* data[kMaxValues];
  const uint8_t* valid[kMaxValues];
  int kind[kMaxValues];
  int flags[kMaxValues];
  int count;
};

// Global scratch, carved from one buffer by the host (scratch_layout).
struct Scratch {
  long long* table_keys;           // [slots]
  int* table_state;                // [slots]
  long long* dense_keys;           // [gcap]
  int* counters;                   // [2]: dense count, overflow
  unsigned long long* count_all;   // [gcap + 2]
  long long* acc;                  // [nv][kAccRows][gcap + 2]
};

__device__ __forceinline__ unsigned mix(long long key, int mask) {
  unsigned long long z = static_cast<unsigned long long>(key);
  z = (z ^ (z >> 33)) * 0xff51afd7ed558ccdULL;
  z = (z ^ (z >> 33)) * 0xc4ceb9fe1a85ec53ULL;
  return static_cast<unsigned>(z ^ (z >> 33)) & static_cast<unsigned>(mask);
}

// The CTA tables' hash: 32-bit arithmetic only, as it runs once a row; the
// top bits of a multiplicative hash, after folding the high bits down.
__device__ __forceinline__ unsigned mix_cta(long long key, int shift) {
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned hi = static_cast<unsigned>(static_cast<unsigned long long>(key) >> 32);
  unsigned h = lo ^ (hi * 0x85ebca6bu);
  h ^= h >> 16;
  return (h * 0x9e3779b1u) >> shift;
}

// Signed order of a float64's bits: -0.0 < +0.0, negative values below.
__device__ __forceinline__ long long float_order(long long bits) {
  return bits >= 0 ? bits : bits ^ kI64Max;
}

// Order keys for min and max. NaN is ignored unless a group holds nothing
// else (pyarrow's rule): above +inf for min, below -inf for max. uint64
// takes the bias flip into signed order.
__device__ __forceinline__ void order_keys(long long v, int kind,
                                           long long* kmin, long long* kmax) {
  if (kind == kKindFloat64) {
    const double d = __longlong_as_double(v);
    const bool nan = d != d;
    *kmin = nan ? kNanMinKey : float_order(v);
    *kmax = nan ? kNanMaxKey : float_order(v);
  } else if (kind == kKindUint64) {
    *kmin = *kmax = v ^ kI64Min;
  } else {
    *kmin = *kmax = v;
  }
}

__device__ __forceinline__ long long add_sum(long long a, long long b,
                                             int kind) {
  if (kind == kKindFloat64) {
    return __double_as_longlong(__longlong_as_double(a) +
                                __longlong_as_double(b));
  }
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ long long load_volatile(const long long* p) {
  return *reinterpret_cast<const volatile long long*>(p);
}

// An acquire load at block scope: the key written before the state's
// release is visible after it, with no fence on the reader's side.
__device__ __forceinline__ int load_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Find ``key`` in the global open-addressing table, inserting it if absent,
// and return its dense index, or -1 when the table already holds ``limit``
// keys (or no free slot is left on the probe path): the caller's overflow.
// Linear probing without deletion: every thread looking for a key walks the
// same slots and waits at a slot being claimed, so a key is inserted once.
__device__ int find_or_insert_global(long long key, long long* keys,
                                     int* state, int mask, int* dense_count,
                                     int limit, long long* dense_keys) {
  unsigned s = mix(key, mask);
  for (int probe = 0; probe <= mask; ++probe) {
    int st = load_volatile(&state[s]);
    if (st == 0) {
      st = atomicCAS(&state[s], 0, -1);
      if (st == 0) {
        const int idx = atomicAdd(dense_count, 1);
        if (idx >= limit) {
          atomicExch(&state[s], -2);
          return -1;
        }
        keys[s] = key;
        dense_keys[idx] = key;
        __threadfence();
        atomicExch(&state[s], idx + 1);
        return idx;
      }
    }
    while (st == -1) st = load_volatile(&state[s]);
    if (st > 0) {
      __threadfence();
      if (load_volatile(&keys[s]) == key) return st - 1;
    }
    s = (s + 1) & static_cast<unsigned>(mask);
  }
  return -1;
}

// The same over a CTA's shared table: the hit path is one acquire load of
// the state and one load of the key; the insert path claims the slot with a
// CAS, writes the key, fences and publishes the state. A lane whose CAS
// loses reads the state again with an acquire load before the key.
__device__ __forceinline__ int find_or_insert_cta(long long key,
                                                  long long* keys, int* state,
                                                  int mask, int shift,
                                                  int* dense_count,
                                                  int limit) {
  unsigned s = mix_cta(key, shift);
  for (int probe = 0; probe <= mask; ++probe) {
    int st = load_acquire_cta(&state[s]);
    if (st > 0) {
      if (keys[s] == key) return st - 1;
    } else if (st == 0 || st == -1) {
      if (st == 0) {
        if (atomicCAS(&state[s], 0, -1) == 0) {
          const int idx = atomicAdd(dense_count, 1);
          if (idx >= limit) {
            atomicExch(&state[s], -2);
            return -1;
          }
          keys[s] = key;
          __threadfence_block();
          atomicExch(&state[s], idx + 1);
          return idx;
        }
        // another lane claimed the slot: its key is read only after an
        // acquire load of the state it publishes
        st = -1;
      }
      while (st == -1) st = load_acquire_cta(&state[s]);
      if (st > 0 && keys[s] == key) return st - 1;
    }
    s = (s + 1) & static_cast<unsigned>(mask);
  }
  return -1;
}

// One copy of the accumulators: count_all[g1], then per column its
// kAccRows rows of g1 words. Accumulator-major, so the leaders of distinct
// groups touch neighbouring 8-byte words, not one bank pair.
__host__ __device__ __forceinline__ int copy_words(int g1, int nv) {
  return g1 * (1 + nv * kAccRows);
}

__device__ __forceinline__ long long acc_identity(int i, int g1) {
  const int r = (i / g1 - 1) % kAccRows;  // i / g1 == 0 is count_all
  return i < g1 ? 0 : r == kRowMin ? kI64Max : r == kRowMax ? kI64Min : 0;
}

__global__ void init_kernel(Scratch sc, int slots, int gcap, int nv) {
  const int rows = gcap + 2;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;
       i < slots || i < nv * kAccRows * rows; i += stride) {
    if (i < slots) sc.table_state[i] = 0;
    if (i < rows) sc.count_all[i] = 0;
    if (i < 2) sc.counters[i] = 0;
    if (i < nv * kAccRows * rows) {
      const int r = (i / rows) % kAccRows;
      sc.acc[i] = r == kRowMin ? kI64Max : r == kRowMax ? kI64Min : 0;
    }
  }
}

// Accumulator updates: plain read-modify-write on a warp's own copy, shared
// atomics on a copy that several warps update.
template <bool kAtomic>
__device__ __forceinline__ void acc_count(long long* p, unsigned long long v) {
  if (kAtomic) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p), v);
  } else {
    *p = static_cast<long long>(static_cast<unsigned long long>(*p) + v);
  }
}

template <bool kAtomic>
__device__ __forceinline__ void acc_sum(long long* p, long long v, int kind) {
  if (!kAtomic) {
    *p = add_sum(*p, v, kind);
  } else if (kind == kKindFloat64) {
    atomicAdd(reinterpret_cast<double*>(p), __longlong_as_double(v));
  } else {
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(v));
  }
}

template <bool kAtomic>
__device__ __forceinline__ void acc_minmax(long long* acc, int g1, int g,
                                           long long lo, long long hi) {
  if (kAtomic) {
    atomicMin(&acc[kRowMin * g1 + g], lo);
    atomicMax(&acc[kRowMax * g1 + g], hi);
  } else {
    acc[kRowMin * g1 + g] = min(acc[kRowMin * g1 + g], lo);
    acc[kRowMax * g1 + g] = max(acc[kRowMax * g1 + g], hi);
  }
}

// One warp-step's rows of one lane: rows row0, row0 + 32, ..., each read
// once; rows past n read nothing and hold code 0.
template <int NV, int R>
struct Rows {
  long long key[R];
  int c[R];
  long long x[NV > 0 ? NV : 1][R];
  bool ok[NV > 0 ? NV : 1][R];
};

template <int NV, int R>
__device__ __forceinline__ void load_rows(Rows<NV, R>& t, long long row0,
                                          long long n,
                                          const long long* __restrict__ keys,
                                          const uint8_t* __restrict__ code,
                                          const Values& vals) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + 32LL * r;
    const bool in = row < n;
    t.key[r] = in ? keys[row] : 0;
    t.c[r] = !in ? 0 : code == nullptr ? 1 : code[row];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      t.x[v][r] = in ? static_cast<const long long*>(vals.data[v])[row] : 0;
      t.ok[v][r] = in && (vals.valid[v] == nullptr || vals.valid[v][row] != 0);
    }
  }
}

template <int NV, bool kPrivate>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const long long* __restrict__ keys,
                  const uint8_t* __restrict__ code, long long n, Values vals,
                  int gcap, int slots, int shift, int gslots, int copies,
                  Scratch sc) {
  constexpr int R = kRowsPerLane<NV>;
  constexpr bool kAtomic = !kPrivate;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g1 = gcap + 1;  // groups and the null-key row
  const int words = copy_words(g1, NV);
  long long* s_keys = reinterpret_cast<long long*>(smem);
  long long* s_copies = s_keys + slots;
  int* s_state = reinterpret_cast<int*>(s_copies + copies * words);
  int* s_meta = s_state + slots;  // dense count, overflow
  const int mask = slots - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < slots; i += kThreads) s_state[i] = 0;
  for (int i = threadIdx.x; i < copies * words; i += kThreads) {
    s_copies[i] = acc_identity(i % words, g1);
  }
  if (threadIdx.x < 2) s_meta[threadIdx.x] = 0;
  __syncthreads();

  long long* mine = s_copies + (warp % copies) * words;
  const unsigned below = (1u << lane) - 1u;
  const unsigned above = ~((2u << lane) - 1u);  // lane 31: 2u << 31 == 0
  const long long step_rows = 32LL * R;
  const long long warps_total = static_cast<long long>(gridDim.x) * kWarps;
  // the next step's loads are issued before this step's probes
  long long chunk = static_cast<long long>(blockIdx.x) * kWarps + warp;
  Rows<NV, R> cur;
  load_rows(cur, chunk * step_rows + lane, n, keys, code, vals);
  for (; chunk * step_rows < n; chunk += warps_total) {
    Rows<NV, R> nxt;
    load_rows(nxt, (chunk + warps_total) * step_rows + lane, n, keys, code,
              vals);
    const long long (&key)[R] = cur.key;
    const int (&c)[R] = cur.c;
    const long long (&x)[NV > 0 ? NV : 1][R] = cur.x;
    const bool (&ok)[NV > 0 ? NV : 1][R] = cur.ok;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int g = -1;
      if (c[r] == 1) {
        g = find_or_insert_cta(key[r], s_keys, s_state, mask, shift,
                               &s_meta[0], gcap);
        if (g < 0) s_meta[1] = 1;
      } else if (c[r] == 2) {
        g = gcap;
      }
      // one leader per distinct group of the warp-step; count_all and
      // count_valid are popcounts of its peers
      const unsigned peers = __match_any_sync(kFull, g);
      const int mult = g >= 0 ? __popc(peers) : 0;
      const int most = __reduce_max_sync(kFull, static_cast<unsigned>(mult));
      if (most == 0) continue;
      const bool leader = g >= 0 && (peers & below) == 0;
      if (leader) acc_count<kAtomic>(&mine[g], mult);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const unsigned vb = __ballot_sync(kFull, ok[v][r]);
        if (leader && vals.valid[v] != nullptr) {
          acc_count<kAtomic>(&mine[g1 * (1 + v * kAccRows + kRowCountValid) + g],
                             __popc(peers & vb));
        }
      }
      if (NV > 0 && most <= kMaxRounds) {
        // round k: the peers of rank k, one a group, so no two lanes of a
        // round write one word
        const int rank = __popc(peers & below);
        for (int k = 0; k < most; ++k) {
          if (g >= 0 && rank == k) {
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              if (!ok[v][r]) continue;
              long long* acc = mine + g1 * (1 + v * kAccRows);
              if (vals.flags[v] & kWantSum) {
                acc_sum<kAtomic>(&acc[kRowSum * g1 + g], x[v][r],
                                 vals.kind[v]);
              }
              if (vals.flags[v] & kWantMinMax) {
                long long kmin, kmax;
                order_keys(x[v][r], vals.kind[v], &kmin, &kmax);
                acc_minmax<kAtomic>(acc, g1, g, kmin, kmax);
              }
            }
          }
          if (kPrivate) __syncwarp();
        }
      } else if (NV > 0) {
        // a group repeats more than kMaxRounds times: reduce over the peers
        // by pointer jumping; after 5 steps each lane holds its own and
        // every later peer's values, and the leader writes them
        long long sum[NV > 0 ? NV : 1], lo[NV > 0 ? NV : 1],
            hi[NV > 0 ? NV : 1];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          order_keys(x[v][r], vals.kind[v], &lo[v], &hi[v]);
          sum[v] = ok[v][r] ? x[v][r] : 0;  // 0 is +0.0's bits
          if (!ok[v][r]) {
            lo[v] = kI64Max;
            hi[v] = kI64Min;
          }
        }
        int next = (peers & above) ? __ffs(peers & above) - 1 : 32;
#pragma unroll
        for (int step = 0; step < 5; ++step) {
          const int src = next & 31;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const long long os = __shfl_sync(kFull, sum[v], src);
            const long long ol = __shfl_sync(kFull, lo[v], src);
            const long long oh = __shfl_sync(kFull, hi[v], src);
            if (next < 32) {
              sum[v] = add_sum(sum[v], os, vals.kind[v]);
              lo[v] = min(lo[v], ol);
              hi[v] = max(hi[v], oh);
            }
          }
          const int nn = __shfl_sync(kFull, next, src);
          if (next < 32) next = nn;
        }
        if (leader) {
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            long long* acc = mine + g1 * (1 + v * kAccRows);
            if (vals.flags[v] & kWantSum) {
              acc_sum<kAtomic>(&acc[kRowSum * g1 + g], sum[v], vals.kind[v]);
            }
            if (vals.flags[v] & kWantMinMax) {
              acc_minmax<kAtomic>(acc, g1, g, lo[v], hi[v]);
            }
          }
        }
      }
      if (kPrivate) __syncwarp();  // this step's stores before the next's
    }
    cur = nxt;
  }
  __syncthreads();

  // sum the copies, then merge this CTA's groups into the global table
  if (threadIdx.x == 0 && s_meta[1] != 0) atomicExch(&sc.counters[1], 1);
  const int rows = gcap + 2;
  for (int s = threadIdx.x; s <= slots; s += kThreads) {
    int b, g;
    if (s == slots) {  // the null-key row
      b = g = gcap;
      unsigned long long any = 0;
      for (int k = 0; k < copies; ++k) any |= s_copies[k * words + gcap];
      if (any == 0) continue;
    } else {
      const int st = s_state[s];
      if (st <= 0) continue;
      b = st - 1;
      g = find_or_insert_global(s_keys[s], sc.table_keys, sc.table_state,
                                gslots - 1, &sc.counters[0], gcap,
                                sc.dense_keys);
      if (g < 0) {
        atomicExch(&sc.counters[1], 1);
        continue;
      }
    }
    unsigned long long all = 0;
    for (int k = 0; k < copies; ++k) {
      all += static_cast<unsigned long long>(s_copies[k * words + b]);
    }
    atomicAdd(&sc.count_all[g], all);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      long long cv = 0, sum = 0;
      long long lo = kI64Max, hi = kI64Min;
      for (int k = 0; k < copies; ++k) {
        const long long* acc = s_copies + k * words + g1 * (1 + v * kAccRows);
        cv += acc[kRowCountValid * g1 + b];
        sum = add_sum(sum, acc[kRowSum * g1 + b], vals.kind[v]);
        lo = min(lo, acc[kRowMin * g1 + b]);
        hi = max(hi, acc[kRowMax * g1 + b]);
      }
      long long* gacc = sc.acc + v * kAccRows * rows;
      if (vals.valid[v] != nullptr) {
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      &gacc[kRowCountValid * rows + g]),
                  static_cast<unsigned long long>(cv));
      }
      if (vals.flags[v] & kWantSum) {
        if (vals.kind[v] == kKindFloat64) {
          atomicAdd(reinterpret_cast<double*>(&gacc[kRowSum * rows + g]),
                    __longlong_as_double(sum));
        } else {
          atomicAdd(reinterpret_cast<unsigned long long*>(
                        &gacc[kRowSum * rows + g]),
                    static_cast<unsigned long long>(sum));
        }
      }
      if (vals.flags[v] & kWantMinMax) {
        atomicMin(&gacc[kRowMin * rows + g], lo);
        atomicMax(&gacc[kRowMax * rows + g], hi);
      }
    }
  }
}

// Row ``dst`` of the outputs from scratch row ``src``, or the identities
// when ``src`` < 0.
__device__ void write_row(const Scratch& sc, const Values& vals, int rows,
                          int src, int dst, long long* out_count_all,
                          long long* out_acc) {
  const long long all =
      src < 0 ? 0 : static_cast<long long>(sc.count_all[src]);
  out_count_all[dst] = all;
#pragma unroll
  for (int v = 0; v < kMaxValues; ++v) {
    if (v >= vals.count) break;
    const long long* acc = sc.acc + v * kAccRows * rows;
    long long* out = out_acc + v * kAccRows * rows;
    if (src < 0) {
      out[kRowCountValid * rows + dst] = 0;
      out[kRowSum * rows + dst] = 0;
      out[kRowMin * rows + dst] = kI64Max;
      out[kRowMax * rows + dst] = kI64Min;
      continue;
    }
    out[kRowCountValid * rows + dst] =
        vals.valid[v] != nullptr ? acc[kRowCountValid * rows + src] : all;
    out[kRowSum * rows + dst] = acc[kRowSum * rows + src];
    out[kRowMin * rows + dst] = acc[kRowMin * rows + src];
    out[kRowMax * rows + dst] = acc[kRowMax * rows + src];
  }
}

__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(Scratch sc, Values vals, int gcap, long long* out_keys,
              long long* out_meta, long long* out_count_all,
              long long* out_acc) {
  __shared__ long long s_k[kMaxGroups];
  const int rows = gcap + 2;
  const int cnt = min(sc.counters[0], gcap);
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) s_k[i] = sc.dense_keys[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    out_meta[0] = cnt;
    out_meta[1] = sc.counters[1] != 0 || sc.counters[0] > gcap;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    if (i < cnt) {
      const long long k = s_k[i];
      int rank = 0;
      for (int j = 0; j < cnt; ++j) rank += s_k[j] < k;
      out_keys[rank] = k;
      write_row(sc, vals, rows, i, rank, out_count_all, out_acc);
    } else if (i < gcap) {
      out_keys[i] = 0;
      write_row(sc, vals, rows, -1, i, out_count_all, out_acc);
    } else {  // the null-key row, then the identity row
      write_row(sc, vals, rows, i == gcap ? gcap : -1, i, out_count_all,
                out_acc);
    }
  }
}

int table_slots(int gcap) {
  int s = 16;
  while (s < 2 * gcap) s <<= 1;
  return s;
}

size_t align8(size_t b) { return (b + 7) & ~static_cast<size_t>(7); }

// Byte offsets of the scratch arrays; returns the total.
size_t scratch_layout(int gcap, int nv, size_t off[6]) {
  const int slots = table_slots(gcap);
  const size_t rows = static_cast<size_t>(gcap) + 2;
  size_t b = 0;
  off[0] = b; b += align8(sizeof(long long) * slots);
  off[1] = b; b += align8(sizeof(int) * slots);
  off[2] = b; b += align8(sizeof(long long) * gcap);
  off[3] = b; b += align8(sizeof(int) * 2);
  off[4] = b; b += align8(sizeof(unsigned long long) * rows);
  off[5] = b; b += sizeof(long long) * kAccRows * rows * (nv > 0 ? nv : 1);
  return b;
}

// Shared bytes of accumulate_kernel with a CTA table of ``slots`` and
// ``copies`` accumulator copies.
size_t shared_bytes(int gcap, int nv, int copies, int slots) {
  return static_cast<size_t>(slots) * (sizeof(long long) + sizeof(int)) +
         static_cast<size_t>(copies) * copy_words(gcap + 1, nv) *
             sizeof(long long) +
         2 * sizeof(int);
}

// A CTA's table: kTableFactor slots a group, so a probe seldom walks,
// halved (down to the global table's 2 a group) until it fits beside the
// copies.
int cta_slots(int gcap, int nv, int copies) {
  int slots = 16;
  while (slots < kTableFactor * gcap) slots <<= 1;
  while (slots > table_slots(gcap) &&
         shared_bytes(gcap, nv, copies, slots) >
             static_cast<size_t>(kSharedBudget)) {
    slots >>= 1;
  }
  return slots;
}

// One copy per warp where they fit the budget beside the smallest table
// (the private variant), else as many as fit, shared by groups of warps.
int copies_for(int gcap, int nv) {
  int copies = kWarps;
  while (copies > 1 && shared_bytes(gcap, nv, copies, table_slots(gcap)) >
                           static_cast<size_t>(kSharedBudget)) {
    --copies;
  }
  return copies;
}

using KernelFn = void (*)(const long long*, const uint8_t*, long long, Values,
                          int, int, int, int, int, Scratch);

template <int NV>
KernelFn pick(bool priv) {
  return priv ? accumulate_kernel<NV, true> : accumulate_kernel<NV, false>;
}

KernelFn kernel_for(int nv, bool priv) {
  switch (nv) {
    case 0: return pick<0>(priv);
    case 1: return pick<1>(priv);
    case 2: return pick<2>(priv);
    case 3: return pick<3>(priv);
    default: return pick<4>(priv);
  }
}

int rows_per_lane_of(int nv) {
  return nv == 0 ? kRowsPerLane<0> : kRowsPerLane<1>;
}

// The launch shape of one (device, kernel, shared bytes): the SM count
// times the resident CTAs an SM, queried once and kept, with the kernel's
// shared-memory limit raised at the same time; the lock keeps two host
// threads from filling the cache at once.
struct LaunchShape {
  int device;
  KernelFn fn;
  size_t smem;
  int blocks;  // SMs x CTAs an SM
};
LaunchShape g_shapes[64];
int g_num_shapes = 0;
std::mutex g_shapes_lock;

cudaError_t launch_shape(KernelFn fn, size_t smem, int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> hold(g_shapes_lock);
  for (int i = 0; i < g_num_shapes; ++i) {
    const LaunchShape& s = g_shapes[i];
    if (s.device == device && s.fn == fn && s.smem == smem) {
      *blocks = s.blocks;
      return cudaSuccess;
    }
  }
  // the largest size any launch of ``fn`` takes, so no entry's launch is
  // refused for another entry's setting
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSharedBudget);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (g_num_shapes < 64) {
    g_shapes[g_num_shapes++] = LaunchShape{device, fn, smem, *blocks};
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int gt_aggregate_max_values() { return kMaxValues; }

int gt_aggregate_max_groups() { return kMaxGroups; }

const char* gt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

long long gt_aggregate_scratch_bytes(int gcap, int num_values) {
  size_t off[6];
  return static_cast<long long>(scratch_layout(gcap, num_values, off));
}

// A CTA's warps: as many accumulator copies mean the private variant.
int gt_aggregate_warps() { return kWarps; }

// The accumulator copies a CTA keeps for (gcap, num_values): kWarps means
// the private variant, fewer the shared one.
int gt_aggregate_copies(int gcap, int num_values) {
  if (gcap < 1 || gcap > kMaxGroups || num_values < 0 ||
      num_values > kMaxValues) {
    return -1;
  }
  return copies_for(gcap, num_values);
}

// One aggregate over ``num_values`` (≤ kMaxValues) columns. ``code`` may be
// null (every row is in the table); ``valids[v]`` may be null (no nulls).
// ``kinds[v]``: 0 int64, 1 uint64, 2 float64; ``flags[v]``: 1 sum, 2 min
// and max. Outputs: out_keys [gcap], out_meta [2]
// (count, overflow), out_count_all [gcap + 2], out_acc
// [num_values][4][gcap + 2] (count_valid, sum bits, min key, max key).
int gt_aggregate(const void* keys, const void* code, long long n,
                 int num_values, const void* const* values,
                 const void* const* valids, const int* kinds,
                 const int* flags, int gcap, void* scratch,
                 long long scratch_bytes, void* out_keys, void* out_meta,
                 void* out_count_all, void* out_acc, void* stream_) {
  if (num_values < 0 || num_values > kMaxValues || gcap < 1 ||
      gcap > kMaxGroups || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int copies = copies_for(gcap, num_values);
  const int cslots = cta_slots(gcap, num_values, copies);
  const size_t smem = shared_bytes(gcap, num_values, copies, cslots);
  if (smem > static_cast<size_t>(kSharedBudget)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t off[6];
  if (static_cast<long long>(scratch_layout(gcap, num_values, off)) >
      scratch_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  Values vals{};
  vals.count = num_values;
  for (int v = 0; v < num_values; ++v) {
    vals.data[v] = values[v];
    vals.valid[v] = static_cast<const uint8_t*>(valids[v]);
    vals.kind[v] = kinds[v];
    vals.flags[v] = flags[v];
  }
  unsigned char* base = static_cast<unsigned char*>(scratch);
  Scratch sc;
  sc.table_keys = reinterpret_cast<long long*>(base + off[0]);
  sc.table_state = reinterpret_cast<int*>(base + off[1]);
  sc.dense_keys = reinterpret_cast<long long*>(base + off[2]);
  sc.counters = reinterpret_cast<int*>(base + off[3]);
  sc.count_all = reinterpret_cast<unsigned long long*>(base + off[4]);
  sc.acc = reinterpret_cast<long long*>(base + off[5]);
  const int slots = table_slots(gcap);

  const int init_items = slots > num_values * kAccRows * (gcap + 2)
                             ? slots : num_values * kAccRows * (gcap + 2);
  init_kernel<<<(init_items + 255) / 256, 256, 0, stream>>>(sc, slots, gcap,
                                                            num_values);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (n > 0) {
    const KernelFn fn = kernel_for(num_values, copies == kWarps);
    int full = 0;
    if ((err = launch_shape(fn, smem, &full)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    const long long rows_per_cta =
        static_cast<long long>(kThreads) *
        rows_per_lane_of(num_values);
    const long long needed = (n + rows_per_cta - 1) / rows_per_cta;
    const int blocks = static_cast<int>(needed < full ? needed : full);
    fn<<<blocks, kThreads, smem, stream>>>(
        static_cast<const long long*>(keys),
        static_cast<const uint8_t*>(code), n, vals, gcap, cslots,
        32 - __builtin_ctz(static_cast<unsigned>(cslots)), slots, copies, sc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  finish_kernel<<<1, kFinishThreads, 0, stream>>>(
      sc, vals, gcap, static_cast<long long*>(out_keys),
      static_cast<long long*>(out_meta),
      static_cast<long long*>(out_count_all),
      static_cast<long long*>(out_acc));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
