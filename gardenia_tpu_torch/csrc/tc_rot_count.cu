// K3: per-pair rotation count of triangle counting's rotate path, on
// Hopper.
//
// Replaces gardenia_tpu/solvers/tc.py::_rot_count_pallas (with the operand
// build of _make_rot_run, tc.py:237-259).  For chunk pair p, with
// a = table[cu[p]] and b = table[cv[p]] (128 int32 lanes each, ascending
// ids, -1 pads):
//
//   out[p] = #{(j, k) : j < W, k < 128, a_j >= 0, a_j == b_k}
//
// which is what the TPU kernel's sum over W lane rotations of a's tiled
// W-prefix against b computes: every (j, k) pair meets exactly once.  The
// prep (_pair_streams) puts the row with the smaller fill, at most W, in
// cu, so a's first W lanes hold all its ids and out[p] = |a & b|.
//
// What bounds it on this card: the two row gathers, 512 + 4 W bytes per
// pair from a table of C x 512 B (348 MB at R-MAT-20, seven times the
// 50 MB L2), against device-memory bandwidth; the compares are 4 W per
// lane.  The rotations were a VPU device that kept every op full-width,
// and the tiled copy of a fed them; here a's W values are broadcast by
// warp shuffles instead, so neither is made, and the kernel gathers the
// rows itself from the pair stream.
//
// Design: one warp per pair, grid-stride over a 64-bit pair index.  Lane l
// loads 16 B of row cv (lanes 4l..4l+3) and, for 4l < W, 16 B of row cu.
// For each j < W, a_j is broadcast from lane j/4 and compared with the
// lane's 4 values of b; a pad a_j (-1, which would match b's pads) is
// skipped.  A warp reduce gives the count, which lane 0 writes.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int QUADS = LANES / 4;     // int4 per row: one per lane of a warp
constexpr int WARPS = 8;             // warps (pairs in flight) per CTA
constexpr long long MAX_BLOCKS = 1LL << 20;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int matches(int a, int4 b) {
  return a < 0 ? 0 : (b.x == a) + (b.y == a) + (b.z == a) + (b.w == a);
}

__global__ void __launch_bounds__(WARPS * 32)
rot_count_kernel(const int4* __restrict__ table, const int* __restrict__ cu,
                 const int* __restrict__ cv, int* __restrict__ out,
                 long long n, int W) {
  const int lane = threadIdx.x & 31;
  const int aq = W / 4;                 // int4 of a's W-prefix
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long p = static_cast<long long>(blockIdx.x) * WARPS +
                     (threadIdx.x >> 5);
       p < n; p += stride) {
    const int4 b =
        __ldg(table + static_cast<long long>(__ldg(cv + p)) * QUADS + lane);
    int4 a = make_int4(-1, -1, -1, -1);
    if (lane < aq)
      a = __ldg(table + static_cast<long long>(__ldg(cu + p)) * QUADS + lane);
    int cnt = 0;
    for (int q = 0; q < aq; ++q) {      // aq is warp-uniform
      cnt += matches(__shfl_sync(FULL, a.x, q), b);
      cnt += matches(__shfl_sync(FULL, a.y, q), b);
      cnt += matches(__shfl_sync(FULL, a.z, q), b);
      cnt += matches(__shfl_sync(FULL, a.w, q), b);
    }
    cnt = __reduce_add_sync(FULL, cnt);
    if (lane == 0) out[p] = cnt;
  }
}

}  // namespace

extern "C" {

// table (C, 128) int32, 16-byte aligned; cu, cv int32[n]; out int32[n].
// W: a multiple of 4 in [4, 128].  Returns cudaGetLastError() after the
// launch (0 on success); the launch is asynchronous on `stream`.
int gdn_tc_rot_count(const void* table, const void* cu, const void* cv,
                     void* out, long long n, int W, void* stream) {
  if (W < 4 || W > LANES || W % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  long long blocks = (n + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  rot_count_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), static_cast<const int*>(cu),
      static_cast<const int*>(cv), static_cast<int*>(out), n, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
