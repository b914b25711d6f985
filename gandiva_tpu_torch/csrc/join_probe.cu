// The join probe for Hopper, sm_90a: each probe row resolves its duplicate
// run (start, len) against the linear-probed table of join_build.cu.
//
// Replaces no Pallas kernel. The reference probes with array operations
// (gandiva_tpu/ops/hash_join.py::_probe_ranges_dense and _probe_ranges_hot:
// a full-width round-1 gather of the home slots, compactions of the rows
// left over, chain walks of one gather a round, and for large probes a
// sampled hot-key tier in front), which XLA fuses on a TPU and which kept
// its wide gathers few. The port ran the same chain as torch operations:
// one host sync and one full-width 16-byte gather a round of its walks, in
// which every row already resolved read slot 0, all of them one address of
// one L2 slice. Here one thread walks each row's own chain, in one launch
// with no host sync.
//
// Bound: bytes. A row reads its int64 key (8 B) and its validity (1 B) and
// writes start and len (8 B), all coalesced; a valid row reads its home slot
// and one more slot a step of its chain (16 B each, one int4, read-only
// through ld.global.nc). The slot reads are random: each waits on the
// device's latency, so the speed is set by the loads in flight, not by
// instructions. A thread takes kRows rows a block's width apart and starts
// their home-slot loads together before it resolves any; the chains' later
// steps follow one row at a time (the benchmark's probes read 1.01 slots a
// row on one card, 1.33 on each of four, whose homes are all one residue
// mod 4). Keys that many rows share (Zipf) need no tier of their own:
// their slots stay in L2.
//
// Per row i < n: a row outside probe_kv writes (0, 0) and reads no slot.
// A valid row reads slots from its home, gt_hash32(key, 0) % T (the
// build's home, join_build.cu; plan_prelude.h's gt_hash32 is the hash32 of
// utils/hashing.py), onward, not wrapping, while below T_tot: a slot whose
// len is 0 or less is empty and proves the key absent, (0, 0); a slot whose
// (key lo, key hi) equals the key's gives its (start, len). The build leaves
// slot T_tot - 1 empty (its placement overhangs T by less than nb), so every
// chain ends inside the table. (start, len) equal _probe_ranges_dense's bit
// for bit. The kernel allocates nothing and reads nothing back to the host.

#include <cstdint>
#include <cuda_runtime.h>

#include "plan_prelude.h"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                       // rows a thread, in flight
constexpr int kBlockRows = kThreads * kRows;

// hash32 % T: a 32-bit remainder wherever T fits in 32 bits (the hash
// does; from 2^32 on the remainder is the hash itself)
__device__ __forceinline__ long long home_slot(long long key,
                                               unsigned long long T) {
  const uint32_t h = gt_hash32<long long>(key, 0u);
  return T > 0xFFFFFFFFull ? static_cast<long long>(h)
                           : static_cast<long long>(h %
                                                    static_cast<uint32_t>(T));
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const long long* __restrict__ keys,
             const uint8_t* __restrict__ probe_kv, long long n,
             const int4* __restrict__ table, unsigned long long T,
             long long T_tot, int32_t* __restrict__ start_out,
             int32_t* __restrict__ len_out) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kBlockRows + threadIdx.x;
  long long key[kRows];
  long long pos[kRows];
  bool live[kRows];
  int4 slot[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = first + static_cast<long long>(r) * kThreads;
    live[r] = i < n && probe_kv[i] != 0;
    key[r] = live[r] ? keys[i] : 0;
    pos[r] = live[r] ? home_slot(key[r], T) : 0;
  }
  // every home-slot load in flight before any is used
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    slot[r] = live[r] ? __ldg(table + pos[r]) : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = first + static_cast<long long>(r) * kThreads;
    if (i >= n) continue;
    const int lo = static_cast<int>(static_cast<uint32_t>(key[r]));
    const int hi = static_cast<int>(
        static_cast<uint32_t>(static_cast<unsigned long long>(key[r]) >> 32));
    int4 g = slot[r];
    long long p = pos[r];
    int start = 0;
    int len = 0;
    // an empty slot (len <= 0) ends the chain: the key is absent
    while (live[r] && g.w > 0) {
      if (g.x == lo && g.y == hi) {
        start = g.z;
        len = g.w;
        break;
      }
      if (++p >= T_tot) break;
      g = __ldg(table + p);
    }
    start_out[i] = start;
    len_out[i] = len;
  }
}

}  // namespace

extern "C" {

const char* gt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Resolve ``n`` probe rows: ``keys`` (int64, the widened norms) and
// ``probe_kv`` (one byte a row, nonzero where the row probes) against
// ``table`` (int32 [T_tot, 4], one int4 a slot) of ``table_slots`` T home
// slots; writes ``start`` and ``len`` (int32 [n]).
int gt_join_probe(const void* keys, const void* probe_kv, long long n,
                  const void* table, long long table_slots, long long T_tot,
                  void* start, void* len, void* stream) {
  if (n <= 0) return 0;
  if (table_slots <= 0 || T_tot < table_slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n + kBlockRows - 1) / kBlockRows;
  probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys),
      static_cast<const uint8_t*>(probe_kv), n,
      static_cast<const int4*>(table),
      static_cast<unsigned long long>(table_slots), T_tot,
      static_cast<int32_t*>(start), static_cast<int32_t*>(len));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
