// K4: per-pair sorted-row intersection count of triangle counting's
// rotate path (its wide classes), on Hopper.
//
// Replaces gardenia_tpu/solvers/tc.py::_merge_count_pallas, whose body is
// _bitonic_intersect (tc.py:271-327; its loop is _make_merge_run, 330-348).
// For chunk pair p, with a = table[cu[p]] and b = table[cv[p]] (128 int32
// lanes each, ascending ids, -1 pads trailing), and the pair's width class
// W:
//
//   out[p] = |set(a[:W]) & set(b)|   over the lanes >= 0
//
// which is |set(a) & set(b)| because the prep (_pair_streams) puts the row
// with the smaller fill, at most W, in cu.  The TPU kernel got it from a
// 7-stage bitonic merge of a against a lane-reversed b, with pads remapped
// to keys >= 2^28: fixed-stride compare-exchange stages because the VPU
// has no data-dependent lanes.  None of that is needed here: no
// lane-reversed table, no pad keys, and so no 2^28 ceiling on vertex ids
// (pads are neither stored in the staged table nor looked up).
//
// What bounds it on this card: the lookups of a's ids in the staged row,
// the instructions they issue and the shared-memory loads among them;
// then the gathers of row cu, 4 W bytes a pair from a table of C x 512 B
// (348 MB at R-MAT-20, seven times the 50 MB L2).  Timed on an H100
// without its lookups the kernel ran 1.7-1.9 times as fast at W64 and
// W128, and with every cu the same cached row no faster.  The first design (one warp per pair)
// gathered both 512 B rows whole for every pair: 18.4 GB a solve at
// R-MAT-20, most of it pads of a and rows b it had just read.
//
// Design: each warp takes a contiguous block of BLOCK pairs.  It loads
// the block's indices 32 at a time, one pair per lane, and takes the
// pairs in order, broadcasting each pair's (cu, cv) by shuffles.  Per
// pair:
//  - row cv is staged in the warp's shared memory only when cv differs
//    from the previous pair's (a warp-uniform test), so a stream ordered
//    by cv (solvers/tc.tc_data) stages each shared row once per run in a
//    block.  A staging builds an open-addressing hash table of the row's
//    ids, 4 or 8 slots per id (hash_bits), with shared-memory CAS;
//  - only a's first W lanes are gathered, lane l taking lanes l, l+32, ..
//    (one coalesced 128-byte load per 32 lanes), so every lane looks up
//    and a's pads beyond W are never read;
//  - each valid id is looked up in the table, a lane's R = W / 32
//    lookups one after another, probing linearly: one or two loads a
//    lookup, though the warp waits for its longest probe.  On an H100 it
//    beat a branchless 7-step search of the row (stored breadth-first)
//    at W64 and W128, where most of the pairs are, and lost by 10% at
//    W32 (PERF.md);
//  - a warp reduce gives the pair's count, which the lane of that pair
//    keeps; the warp writes its 32 counts in one store.
// Nothing depends on the stream's order: a stream whose cv changes at
// every pair stages at every pair and counts the same.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int QUADS = LANES / 4;     // int4 per row: one per lane of a warp
constexpr int WARPS = 8;             // warps per CTA
constexpr int BLOCK = 128;           // consecutive pairs per warp
constexpr int EMPTY = -1;            // a free hash slot (ids are >= 0)
constexpr long long MAX_BLOCKS = 1LL << 20;
constexpr unsigned FULL = 0xffffffffu;

// log2 of the hash table's slots: 8 per id of a full row where R = 4, 4
// otherwise.  The larger table shortens the probes, which pays at W128;
// the narrower classes stage more often for fewer lookups, and there its
// 4 KB cleared per staging and 32 KB of shared memory per CTA cost more
// (timed on an H100: 1024 slots took W8-W32 1-10% longer, 512 slots
// W128 26% longer).
__host__ __device__ constexpr int hash_bits(int R) { return R > 2 ? 10 : 9; }

template <int BITS>
__device__ __forceinline__ unsigned hash_slot(int x) {
  return (static_cast<unsigned>(x) * 2654435761u) >> (32 - BITS);
}

// Build the hash table of one row's ids (lane l holds ids 4l..4l+3) in
// row[]: 1 << BITS slots, pads left out.
template <int BITS>
__device__ __forceinline__ void stage(int* row, int4 b, int lane) {
  constexpr int SLOTS = 1 << BITS;
#pragma unroll
  for (int q = 0; q < SLOTS / 128; ++q)
    reinterpret_cast<int4*>(row)[32 * q + lane] =
        make_int4(EMPTY, EMPTY, EMPTY, EMPTY);
  __syncwarp();
  const int v[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (v[k] < 0) continue;
    unsigned h = hash_slot<BITS>(v[k]);
    while (atomicCAS(row + h, EMPTY, v[k]) != EMPTY) h = (h + 1) & (SLOTS - 1);
  }
}

// The number of x[r] (>= 0) in the staged row; pads (-1) are not looked up.
template <int R>
__device__ __forceinline__ int count_members(const int* row,
                                             const int (&x)[R]) {
  constexpr int BITS = hash_bits(R);
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (x[r] < 0) continue;
    unsigned h = hash_slot<BITS>(x[r]);
    for (;;) {
      const int y = row[h];
      if (y == x[r]) { ++cnt; break; }
      if (y == EMPTY) break;
      h = (h + 1) & ((1 << BITS) - 1);
    }
  }
  return cnt;
}

// R = ceil(W / 32): the W-prefix's ids per lane.
template <int R>
__global__ void __launch_bounds__(WARPS * 32)
merge_count_kernel(const int* __restrict__ table, const int* __restrict__ cu,
                   const int* __restrict__ cv, int* __restrict__ out,
                   long long n, int W) {
  __shared__ __align__(16) int rows[WARPS][1 << hash_bits(R)];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* row = rows[warp];
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long wb = static_cast<long long>(blockIdx.x) * WARPS + warp;
       wb * BLOCK < n; wb += stride) {
    const long long first = wb * BLOCK;
    const int len = static_cast<int>(n - first < BLOCK ? n - first : BLOCK);
    int staged = -1;                   // no row is staged yet
    for (int j0 = 0; j0 < len; j0 += 32) {
      const int m = len - j0 < 32 ? len - j0 : 32;
      int my_u = 0, my_v = 0;          // pair j0 + lane's indices
      if (lane < m) {
        my_u = __ldg(cu + first + j0 + lane);
        my_v = __ldg(cv + first + j0 + lane);
      }
      int mine = 0;
      for (int j = 0; j < m; ++j) {
        const int u = __shfl_sync(FULL, my_u, j);
        const int v = __shfl_sync(FULL, my_v, j);
        // lane l's ids of a's W-prefix: lanes l, l + 32, .. (-1 past W)
        const int* a = table + static_cast<long long>(u) * LANES;
        int x[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int k = lane + 32 * r;
          x[r] = k < W ? __ldg(a + k) : -1;
        }
        if (v != staged) {             // warp-uniform
          const int4 b = __ldg(reinterpret_cast<const int4*>(table) +
                               static_cast<long long>(v) * QUADS + lane);
          __syncwarp();                // the previous pair's searches done
          stage<hash_bits(R)>(row, b, lane);
          __syncwarp();
          staged = v;
        }
        const int cnt = __reduce_add_sync(FULL, count_members<R>(row, x));
        if (lane == j) mine = cnt;
      }
      if (lane < m) out[first + j0 + lane] = mine;
    }
  }
}

using Kernel = void (*)(const int*, const int*, const int*, int*, long long,
                        int);

Kernel pick(int W) {
  return W <= 32 ? merge_count_kernel<1>
                 : W <= 64 ? merge_count_kernel<2> : merge_count_kernel<4>;
}

}  // namespace

extern "C" {

// table (C, 128) int32, 16-byte aligned; cu, cv int32[n]; out int32[n];
// W in [1, 128].  Returns cudaGetLastError() after the launch (0 on
// success); the launch is asynchronous on `stream`.
int gdn_tc_merge_count(const void* table, const void* cu, const void* cv,
                       void* out, long long n, int W, void* stream) {
  if (W < 1 || W > LANES) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  long long blocks = (n + WARPS * BLOCK - 1) / (WARPS * BLOCK);
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  pick(W)<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(cu),
      static_cast<const int*>(cv), static_cast<int*>(out), n, W);
  return static_cast<int>(cudaGetLastError());
}

// Consecutive pairs a warp takes: a run of equal cv is staged once within
// each such block.
int gdn_tc_merge_block() { return BLOCK; }

}  // extern "C"
