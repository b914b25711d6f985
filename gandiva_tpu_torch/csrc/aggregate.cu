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
// that one read coalesced and moves the per-row work into shared memory:
//   1. init_kernel sets the global scratch (group table, accumulators) to
//      its identities.
//   2. accumulate_kernel: every CTA owns a shared-memory hash table (a key
//      and a separate state word per slot, so no key value is a sentinel:
//      0 empty, -1 being claimed, -2 dead, idx + 1 ready) that maps a key to
//      a dense CTA-local index, and accumulators per index, updated with
//      shared-memory atomics (64-bit add for counts and integer sums, f64
//      add for float sums, signed 64-bit min/max of an order-preserving key
//      for min/max). CTAs walk the rows with a grid stride; blocks run in
//      no order, so nothing carries over between them. At its end each CTA
//      merges its groups into one global table of the same form with
//      global atomics.
//   3. finish_kernel (one CTA): each group's rank is the number of smaller
//      keys; it writes the groups at their ranks, then the null-key row and
//      identity rows.
// The TPU kernel's sequential-grid discovery, 16-bit limb sums and f32
// planes have no counterpart here. Contention on few groups (every warp
// updates the same few slots) is what keeps this version from its bound;
// warp-aggregated updates are the known remedy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kFinishThreads = 1024;
constexpr int kMaxValues = 4;
constexpr int kMaxGroups = 1024;
constexpr int kKindInt64 = 0;
constexpr int kKindUint64 = 1;
constexpr int kKindFloat64 = 2;
constexpr int kWantSum = 1;
constexpr int kWantMinMax = 2;
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

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ long long load_volatile(const long long* p) {
  return *reinterpret_cast<const volatile long long*>(p);
}

// Find ``key`` in an open-addressing table, inserting it if absent, and
// return its dense index, or -1 when the table already holds ``limit``
// keys (or no free slot is left on the probe path): the caller's overflow.
// ``global`` selects the fence scope. Linear probing without deletion:
// every thread looking for a key walks the same slots and waits at a slot
// being claimed, so a key is inserted once.
template <bool kGlobal>
__device__ int find_or_insert(long long key, long long* keys, int* state,
                              int mask, int* dense_count, int limit,
                              long long* dense_keys) {
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
        if (dense_keys != nullptr) dense_keys[idx] = key;
        if (kGlobal) __threadfence(); else __threadfence_block();
        atomicExch(&state[s], idx + 1);
        return idx;
      }
    }
    while (st == -1) st = load_volatile(&state[s]);
    if (st > 0) {
      if (kGlobal) __threadfence(); else __threadfence_block();
      if (load_volatile(&keys[s]) == key) return st - 1;
    }
    s = (s + 1) & static_cast<unsigned>(mask);
  }
  return -1;
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

__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const long long* __restrict__ keys,
                  const uint8_t* __restrict__ code, long long n, Values vals,
                  int gcap, int slots, Scratch sc) {
  // shared layout: 8-byte arrays first
  extern __shared__ __align__(16) unsigned char smem[];
  const int g1 = gcap + 1;  // groups and the null-key row
  const int nv = vals.count;
  long long* s_keys = reinterpret_cast<long long*>(smem);
  unsigned long long* s_count_all =
      reinterpret_cast<unsigned long long*>(s_keys + slots);
  long long* s_acc = reinterpret_cast<long long*>(s_count_all + g1);
  int* s_state = reinterpret_cast<int*>(s_acc + nv * kAccRows * g1);
  int* s_meta = s_state + slots;  // dense count, overflow
  const int mask = slots - 1;

  for (int i = threadIdx.x; i < slots; i += blockDim.x) s_state[i] = 0;
  for (int i = threadIdx.x; i < g1; i += blockDim.x) s_count_all[i] = 0;
  for (int i = threadIdx.x; i < nv * kAccRows * g1; i += blockDim.x) {
    const int r = (i / g1) % kAccRows;
    s_acc[i] = r == kRowMin ? kI64Max : r == kRowMax ? kI64Min : 0;
  }
  if (threadIdx.x < 2) s_meta[threadIdx.x] = 0;
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       row < n; row += stride) {
    const int c = code == nullptr ? 1 : code[row];
    if (c == 0) continue;
    int g = gcap;
    if (c == 1) {
      g = find_or_insert<false>(keys[row], s_keys, s_state, mask, &s_meta[0],
                                gcap, nullptr);
      if (g < 0) {
        s_meta[1] = 1;
        continue;
      }
    }
    atomicAdd(&s_count_all[g], 1ULL);
    // unrolled, so the parameter arrays are indexed by constants
#pragma unroll
    for (int v = 0; v < kMaxValues; ++v) {
      if (v >= nv) break;
      if (vals.valid[v] != nullptr && vals.valid[v][row] == 0) continue;
      long long* acc = s_acc + v * kAccRows * g1;
      const long long x = static_cast<const long long*>(vals.data[v])[row];
      if (vals.valid[v] != nullptr) {
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      &acc[kRowCountValid * g1 + g]), 1ULL);
      }
      if (vals.flags[v] & kWantSum) {
        if (vals.kind[v] == kKindFloat64) {
          atomicAdd(reinterpret_cast<double*>(&acc[kRowSum * g1 + g]),
                    __longlong_as_double(x));
        } else {
          atomicAdd(reinterpret_cast<unsigned long long*>(
                        &acc[kRowSum * g1 + g]),
                    static_cast<unsigned long long>(x));
        }
      }
      if (vals.flags[v] & kWantMinMax) {
        long long kmin, kmax;
        order_keys(x, vals.kind[v], &kmin, &kmax);
        atomicMin(&acc[kRowMin * g1 + g], kmin);
        atomicMax(&acc[kRowMax * g1 + g], kmax);
      }
    }
  }
  __syncthreads();

  // merge this CTA's groups into the global table
  if (threadIdx.x == 0 && s_meta[1] != 0) atomicExch(&sc.counters[1], 1);
  const int rows = gcap + 2;
  for (int s = threadIdx.x; s <= slots; s += blockDim.x) {
    int b, g;
    if (s == slots) {  // the null-key row
      if (s_count_all[gcap] == 0) continue;
      b = g = gcap;
    } else {
      const int st = s_state[s];
      if (st <= 0) continue;
      b = st - 1;
      g = find_or_insert<true>(s_keys[s], sc.table_keys, sc.table_state,
                               slots - 1, &sc.counters[0], gcap,
                               sc.dense_keys);
      if (g < 0) {
        atomicExch(&sc.counters[1], 1);
        continue;
      }
    }
    atomicAdd(&sc.count_all[g], s_count_all[b]);
#pragma unroll
    for (int v = 0; v < kMaxValues; ++v) {
      if (v >= nv) break;
      const long long* acc = s_acc + v * kAccRows * g1;
      long long* gacc = sc.acc + v * kAccRows * rows;
      if (vals.valid[v] != nullptr) {
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      &gacc[kRowCountValid * rows + g]),
                  static_cast<unsigned long long>(acc[kRowCountValid * g1 + b]));
      }
      if (vals.flags[v] & kWantSum) {
        if (vals.kind[v] == kKindFloat64) {
          atomicAdd(reinterpret_cast<double*>(&gacc[kRowSum * rows + g]),
                    __longlong_as_double(acc[kRowSum * g1 + b]));
        } else {
          atomicAdd(reinterpret_cast<unsigned long long*>(
                        &gacc[kRowSum * rows + g]),
                    static_cast<unsigned long long>(acc[kRowSum * g1 + b]));
        }
      }
      if (vals.flags[v] & kWantMinMax) {
        atomicMin(&gacc[kRowMin * rows + g], acc[kRowMin * g1 + b]);
        atomicMax(&gacc[kRowMax * rows + g], acc[kRowMax * g1 + b]);
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

size_t shared_bytes(int gcap, int nv) {
  const size_t g1 = static_cast<size_t>(gcap) + 1;
  const size_t slots = table_slots(gcap);
  return slots * sizeof(long long) + g1 * sizeof(unsigned long long) +
         static_cast<size_t>(nv) * kAccRows * g1 * sizeof(long long) +
         slots * sizeof(int) + 2 * sizeof(int);
}

}  // namespace

extern "C" {

int gt_aggregate_max_values() { return kMaxValues; }

int gt_aggregate_max_groups() { return kMaxGroups; }

const char* gt_aggregate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

long long gt_aggregate_scratch_bytes(int gcap, int num_values) {
  size_t off[6];
  return static_cast<long long>(scratch_layout(gcap, num_values, off));
}

// One aggregate over ``num_values`` (≤ kMaxValues) columns. ``code`` may be
// null (every row is in the table); ``valids[v]`` may be null (no nulls).
// ``kinds[v]``: 0 int64, 1 uint64, 2 float64; ``flags[v]``: 1 sum, 2 min
// and max. Outputs: out_keys [gcap], out_meta [2] (count, overflow),
// out_count_all [gcap + 2], out_acc [num_values][4][gcap + 2] (count_valid,
// sum bits, min key, max key).
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
    const size_t smem = shared_bytes(gcap, num_values);
    err = cudaFuncSetAttribute(accumulate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, accumulate_kernel, kThreads, smem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long needed = (n + kThreads - 1) / kThreads;
    const long long full = static_cast<long long>(sms) * per_sm;
    const int blocks = static_cast<int>(needed < full ? needed : full);
    accumulate_kernel<<<blocks, kThreads, smem, stream>>>(
        static_cast<const long long*>(keys),
        static_cast<const uint8_t*>(code), n, vals, gcap, slots, sc);
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
