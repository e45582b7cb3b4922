// K4: per-pair sorted-row intersection count of triangle counting's
// rotate path (its wide classes), on Hopper.
//
// Replaces gardenia_tpu/solvers/tc.py::_merge_count_pallas, whose body is
// _bitonic_intersect (tc.py:271-327; its loop is _make_merge_run, 330-348).
// For chunk pair p, with a = table[cu[p]] and b = table[cv[p]] (128 int32
// lanes each, ascending ids, -1 pads trailing):
//
//   out[p] = |set(a) & set(b)|   over the lanes >= 0
//
// The TPU kernel got it from a 7-stage bitonic merge of a against a
// lane-reversed b, with pads remapped to keys >= 2^28: fixed-stride
// compare-exchange stages because the VPU has no data-dependent lanes.
// None of that is needed here: no lane-reversed table (one ~348 MB copy
// of the table less at R-MAT-20), no pad keys, and so no 2^28 ceiling on
// vertex ids (b's pads become INT_MAX, which no int32 id reaches).
//
// What bounds it on this card: the two 512 B row gathers per pair from a
// table seven times the L2, against device-memory bandwidth; then 28
// shared-memory reads per lane (4 searches of 7 steps).
//
// Design: one warp per pair, grid-stride over a 64-bit pair index.  Each
// lane loads 16 B of both rows; the warp stages b in its 512 B of shared
// memory, pads as INT_MAX so the row stays sorted; each lane finds each
// of its 4 values of a in b by a 7-step branchless lower bound, skipping
// a's pads; a warp reduce gives the count, which lane 0 writes.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int QUADS = LANES / 4;     // int4 per row: one per lane of a warp
constexpr int WARPS = 8;             // warps (pairs in flight) per CTA
constexpr long long MAX_BLOCKS = 1LL << 20;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pad_max(int x) { return x < 0 ? INT_MAX : x; }

// 1 if x (>= 0) is in the ascending 128-entry row, else 0.  pos ends as
// the number of entries < x (at most 127, where row[127] < x means x is
// absent).
__device__ __forceinline__ int member(const int* row, int x) {
  if (x < 0) return 0;
  int pos = 0;
#pragma unroll
  for (int s = LANES / 2; s > 0; s >>= 1)
    if (row[pos + s - 1] < x) pos += s;
  return row[pos] == x;
}

__global__ void __launch_bounds__(WARPS * 32)
merge_count_kernel(const int4* __restrict__ table, const int* __restrict__ cu,
                   const int* __restrict__ cv, int* __restrict__ out,
                   long long n) {
  __shared__ int4 rows[WARPS][QUADS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* row = reinterpret_cast<const int*>(rows[warp]);
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long p = static_cast<long long>(blockIdx.x) * WARPS + warp;
       p < n; p += stride) {
    const int4 a =
        __ldg(table + static_cast<long long>(__ldg(cu + p)) * QUADS + lane);
    int4 b =
        __ldg(table + static_cast<long long>(__ldg(cv + p)) * QUADS + lane);
    b = make_int4(pad_max(b.x), pad_max(b.y), pad_max(b.z), pad_max(b.w));
    __syncwarp();                       // the previous pair's searches done
    rows[warp][lane] = b;
    __syncwarp();
    int cnt = member(row, a.x) + member(row, a.y) + member(row, a.z) +
              member(row, a.w);
    cnt = __reduce_add_sync(FULL, cnt);
    if (lane == 0) out[p] = cnt;
  }
}

}  // namespace

extern "C" {

// table (C, 128) int32, 16-byte aligned; cu, cv int32[n]; out int32[n].
// Returns cudaGetLastError() after the launch (0 on success); the launch
// is asynchronous on `stream`.
int gdn_tc_merge_count(const void* table, const void* cu, const void* cv,
                       void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  merge_count_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), static_cast<const int*>(cu),
      static_cast<const int*>(cv), static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
