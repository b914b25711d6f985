// The merge-path code shared by the block sort (K4, sort_bitonic.cu) and
// the merge round (K3, merge_path.cu), for Hopper, sm_90a.
//
// Both kernels merge sorted runs of rows that lie in shared memory. A row
// travels through registers as a `Row`: its first comparator word and its
// position in the kernel's shared-memory tile, where its other words (and,
// in K3, its row index) stay until the output is written. Rows compare by
// their words as unsigned integers, most significant first; a merge takes
// A's row on a tie, so merging runs of contiguous original rows, A before
// B, keeps the sort stable without comparing row indices.
//
// `merge_path` finds a thread's diagonal by binary search, `serial_merge`
// then emits ITEMS consecutive outputs of that merge into registers, one
// shared-memory read per output. A kernel gives both a `Tile` whose
// `load(i)` returns the Row at logical slot i of the tile: a slot may be
// read one past the last row of B (the kernel keeps one slack row there),
// and that Row is never compared.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

struct Row {
  u64 key;  // word 0
  int pos;  // where words 1 .. k-1 are in shared memory
};

// Row order by K words (K = 0: k words, known at run time). Word 0 is the
// Row's key; word w >= 1 of the row at position p is rest[(w - 1) * stride
// + p].
template <int K>
struct Order {
  const u64* rest;
  int stride;
  int k;

  __device__ __forceinline__ bool after(const Row& a, const Row& b) const {
    if (a.key != b.key) return a.key > b.key;
    const int words = K > 0 ? K : k;
#pragma unroll
    for (int w = 1; w < words; ++w) {
      const u64 x = rest[(w - 1) * stride + a.pos];
      const u64 y = rest[(w - 1) * stride + b.pos];
      if (x != y) return x > y;
    }
    return false;
  }
};

// The number of A rows among the first `diag` outputs of the stable merge
// of A = slots [a0, a0 + la) and B = slots [b0, b0 + lb): the least m with
// A[m] after B[diag - 1 - m], or min(diag, la) if there is none. The
// predicate is monotone in m.
template <class Tile, class Ord>
__device__ __forceinline__ int merge_path(const Tile& tile, const Ord& ord,
                                          int a0, int la, int b0, int lb,
                                          int diag) {
  int lo = diag > lb ? diag - lb : 0;
  int hi = diag < la ? diag : la;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (ord.after(tile.load(a0 + m), tile.load(b0 + diag - 1 - m))) {
      hi = m;
    } else {
      lo = m + 1;
    }
  }
  return lo;
}

// ITEMS outputs of the merge of A = slots [ia, a_end) and B = [ib, b_end)
// into out[0 .. ITEMS), A winning ties. Once both runs are spent the rest
// of out is filler: reads stay at slot b_end, the slack row.
template <int ITEMS, class Tile, class Ord>
__device__ __forceinline__ void serial_merge(const Tile& tile, const Ord& ord,
                                             int ia, int a_end, int ib,
                                             int b_end, Row (&out)[ITEMS]) {
  Row a = tile.load(ia < b_end ? ia : b_end);
  Row b = tile.load(ib);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool take_a = ib >= b_end || (ia < a_end && !ord.after(a, b));
    out[i] = take_a ? a : b;
    const int next = take_a ? ++ia : ++ib;
    const Row r = tile.load(next < b_end ? next : b_end);
    if (take_a) {
      a = r;
    } else {
      b = r;
    }
  }
}

}  // namespace
