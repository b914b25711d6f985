// Membership of int64 keys in a small key table, for Hopper, sm_90a: one
// pass over the keys with the table in shared memory.
//
// Replaces no Pallas kernel. The reference tests each key against every
// entry of the skew join's hot-key table (gandiva_tpu/parallel/ops.py::
// _is_in_table), which XLA fuses. The port ran torch.isin, whose brute route
// below 10·n^0.145 entries (64 hot keys at every size the benchmark runs)
// writes an [n, 64] bool compare and reduces it with any, and it read the
// table on the host first to mask its invalid entries. Here each block puts
// the table's valid entries into an open-addressed set in shared memory, and
// each key costs one or two shared-memory probes; the table is never read on
// the host.
//
// Bound: bytes. A key reads its 8 B and writes its 1-B flag once. A thread
// takes kKeys consecutive keys an iteration, loaded as 16-byte vectors where
// the keys start on a 16-byte boundary (8-byte loads otherwise: a view at an
// odd element offset), and writes their flags as one 8-byte store; the last
// n % kKeys keys are read and written one at a time. The grid holds
// kBlocksPerSm blocks a multiprocessor, each striding over the keys, so a
// block builds its set once for many keys.
//
// The set: 2^log2_slots slots of int64 keys and an occupancy bit a slot, at
// least kMinSlots and 4 slots an entry (rounded up to a power of two), so
// the set is at most a quarter full and a probe that finds an unused slot
// proves the key absent. A valid entry's home is the top log2_slots bits of
// key · 2^64/φ; it claims the first unused slot from its home on, with an
// atomicOr on the occupancy word, wrapping. Invalid entries are never
// inserted; an entry twice in the table takes two slots, which adds no
// member. The work is the same whatever the entries are: every key is read
// and probed.
//
// out[r] = any_j(table_valid[j] && keys[r] == table[j]) for r < n, as one
// byte, 0 or 1. One launch, no allocation, no host sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 8;              // keys a thread an iteration
constexpr int kBlocksPerSm = 8;
constexpr int kMaxEntries = 1024;     // 4,096 slots: 32 KiB + 512 B shared
constexpr int kMinSlots = 256;

__device__ __forceinline__ uint32_t home_of(long long key, int shift) {
  return static_cast<uint32_t>(
      (static_cast<unsigned long long>(key) * 0x9E3779B97F4A7C15ull) >> shift);
}

__device__ __forceinline__ bool used(const uint32_t* occupancy, uint32_t s) {
  return (occupancy[s >> 5] >> (s & 31)) & 1u;
}

__device__ __forceinline__ uint8_t member(long long key, const long long* set,
                                          const uint32_t* occupancy,
                                          uint32_t mask, int shift) {
  uint32_t s = home_of(key, shift);
  while (used(occupancy, s)) {
    if (set[s] == key) return 1;
    s = (s + 1) & mask;
  }
  return 0;
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
key_table_kernel(const long long* __restrict__ keys, long long n,
                 const long long* __restrict__ table,
                 const uint8_t* __restrict__ table_valid, int entries,
                 int log2_slots, uint8_t* __restrict__ out) {
  extern __shared__ unsigned long long shared[];
  const uint32_t slots = 1u << log2_slots;
  const uint32_t mask = slots - 1;
  const int shift = 64 - log2_slots;
  long long* set = reinterpret_cast<long long*>(shared);
  uint32_t* occupancy = reinterpret_cast<uint32_t*>(set + slots);
  for (uint32_t w = threadIdx.x; w < slots / 32; w += kThreads) {
    occupancy[w] = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < entries; j += kThreads) {
    if (!table_valid[j]) continue;
    const long long key = table[j];
    uint32_t s = home_of(key, shift);
    while (atomicOr(occupancy + (s >> 5), 1u << (s & 31)) &
           (1u << (s & 31))) {
      s = (s + 1) & mask;
    }
    set[s] = key;
  }
  __syncthreads();

  const long long groups = n / kKeys;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < groups; g += stride) {
    long long k[kKeys];
    if constexpr (kVector) {
      const longlong2* p = reinterpret_cast<const longlong2*>(keys) +
                           g * (kKeys / 2);
#pragma unroll
      for (int v = 0; v < kKeys / 2; ++v) {
        const longlong2 x = __ldg(p + v);
        k[2 * v] = x.x;
        k[2 * v + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int v = 0; v < kKeys; ++v) k[v] = __ldg(keys + g * kKeys + v);
    }
    unsigned long long flags = 0;
#pragma unroll
    for (int v = 0; v < kKeys; ++v) {
      flags |= static_cast<unsigned long long>(
                   member(k[v], set, occupancy, mask, shift))
               << (8 * v);
    }
    reinterpret_cast<unsigned long long*>(out)[g] = flags;
  }
  if (blockIdx.x == gridDim.x - 1) {
    const long long r = groups * kKeys + threadIdx.x;
    if (r < n) out[r] = member(__ldg(keys + r), set, occupancy, mask, shift);
  }
}

}  // namespace

extern "C" {

const char* gt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The most entries a table may hold (the wrapper checks its own copy).
int gt_key_table_max_entries() { return kMaxEntries; }

// Write ``out[r]`` (one byte a key) for the ``n`` int64 ``keys``: 1 where
// the key equals an entry of ``table`` (int64 [entries]) whose
// ``table_valid`` byte is nonzero, else 0. ``out`` starts on an 8-byte
// boundary.
int gt_key_table(const void* keys, long long n, const void* table,
                 const void* table_valid, long long entries, void* out,
                 void* stream) {
  if (entries < 0 || entries > kMaxEntries ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(keys) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  int log2_slots = 0;
  while ((1ll << log2_slots) < kMinSlots ||
         (1ll << log2_slots) < 4 * entries) {
    ++log2_slots;
  }
  const size_t smem = (sizeof(long long) << log2_slots) +
                      sizeof(uint32_t) * ((1u << log2_slots) / 32);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = n / kKeys;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm) {
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  }
  if (blocks < 1) blocks = 1;
  const bool vector = reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  auto kernel = vector ? key_table_kernel<true> : key_table_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n,
      static_cast<const long long*>(table),
      static_cast<const uint8_t*>(table_valid), static_cast<int>(entries),
      log2_slots, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
