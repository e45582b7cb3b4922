// K3: per-pair count of triangle counting's rotate path (its narrow width
// classes), on Hopper.
//
// Replaces gardenia_tpu/solvers/tc.py::_rot_count_pallas (with the operand
// build of _make_rot_run, tc.py:237-259).  For chunk pair p, with
// a = table[cu[p]] and b = table[cv[p]] (128 int32 lanes each, distinct
// ascending ids, -1 pads trailing):
//
//   out[p] = #{(j, k) : j < W, k < 128, a_j >= 0, a_j == b_k}
//
// which is what the TPU kernel's sum over W lane rotations of a's tiled
// W-prefix against b computes: every (j, k) pair meets exactly once.  The
// rows hold distinct ids, so this is the number of valid ids among a's
// first W lanes that occur in b; the prep (_pair_streams) puts the row
// with the smaller fill, at most W, in cu, so out[p] = |a & b|.  The
// rotations were a VPU device that kept every op full-width: W x 128
// compares a pair, whatever the rows hold.  The first kernel here kept
// that count (one warp a pair, a's ids broadcast by shuffles, four
// compares a lane each) and was bound by those compares: on an NVIDIA
// H100 80GB HBM3 at 700.00 W a copy without them ran W16 of R-MAT-20
// twice as fast, a copy without the shuffles no faster.
//
// What bounds it on this card now is not shown.  Per pair it reads 4 W
// bytes of row cu from a table of C x 512 B (348 MB at R-MAT-20, seven
// times the 50 MB L2), and 512 B of row cv per staging; at R-MAT-20 that
// is 0.256 GB at W8 and 0.391 GB at W16, taken in 0.117 and 0.175 ms on
// the card above (one run of chip_smoke.py [6]): 2.2 TB/s of 32- and
// 64-byte segments, partly served by L2, against 3.35 TB/s of device
// memory, and 2.3 and 3.8 times the time that the distinct rows and the
// index pairs of those classes would take at that rate (0.050 and 0.045
// ms).  Either the row gathers or the eight dependent shared-memory
// loads of each search may be what it waits for: no probe has told them
// apart (gathering the next pair's ids one ahead changed nothing).  At
// W64 and W128, with two and four ids a lane, K4's hash table (one or two
// loads an id) is ahead: 0.903 and 1.798 ms against K3's 0.931 and 2.048
// in the same run.
//
// Design: lanes work in groups of G = min(W, 32), so a warp takes 32 / G
// pairs at a time (four at W8, two at W16, one from W32 up, then with
// W / 32 ids a lane) and every lane holds an id slot of a.  Each group
// takes BLOCK consecutive pairs of the stream, a warp 32 / G such parts
// side by side.  A group loads its indices G at a time, one pair per
// lane, and takes the pairs in order.  Per pair:
//  - lane l of the group gathers id l (+ 32 r) of a's W-prefix: one 32-
//    or 64-byte segment a pair at W8 and W16;
//  - row cv is staged in the group's 512 bytes of shared memory only when
//    cv differs from the previous pair's (a group-uniform test), as it
//    is, sorted, with its pads turned into INT_MAX so that the row stays
//    ascending: no table is built, nothing is cleared.  A stream ordered
//    by cv (solvers/tc.tc_data) restages once per run in a part;
//  - each lane finds its id by a branch-free lower-bound search of 7
//    steps over the staged row and one compare.  A pad of a (-1) is below
//    every staged word and never matches.  The groups' rows lie 4 words
//    apart in the banks, so that their upper search levels do not
//    collide; on the card that beat both a skewed and a breadth-first
//    order of the row, whose index arithmetic cost more than the
//    conflicts they avoid;
//  - a shuffle reduction within the group gives the pair's count, which
//    the lane of that pair keeps; the group writes its G counts at once.
// The loops are warp-uniform (a part shorter than its neighbour's idles
// its group), so the warp reconverges at each pair.  Nothing depends on
// the stream's order: a stream whose cv changes at every pair restages at
// every pair and counts the same.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int QUADS = LANES / 4;     // int4 per row
constexpr int WARPS = 8;             // warps per CTA
constexpr int BLOCK = 16;            // consecutive pairs per lane group
constexpr int ROW = LANES + 4;       // a group's staged row and its bank skew
constexpr int PAD = 0x7fffffff;      // a staged pad: above every id
constexpr long long MAX_BLOCKS = 1LL << 20;
constexpr unsigned FULL = 0xffffffffu;

// 1 if x is in the staged row (ascending, pads PAD), else 0; x = -1 is not.
__device__ __forceinline__ int find(const int* row, int x) {
  int pos = 0;
#pragma unroll
  for (int s = LANES / 2; s >= 1; s >>= 1) pos += row[pos + s - 1] < x ? s : 0;
  return row[pos] == x;
}

// G lanes a pair, R ids a lane: W = G * R.
template <int G, int R>
__global__ void __launch_bounds__(WARPS * 32)
rot_count_kernel(const int* __restrict__ table, const int* __restrict__ cu,
                 const int* __restrict__ cv, int* __restrict__ out,
                 long long n) {
  constexpr int NG = 32 / G;         // groups of a warp; int4 a lane stages
  __shared__ int rows[WARPS][NG][ROW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G;
  const int gl = lane % G;
  const unsigned gmask =
      G == 32 ? FULL : ((1u << (G & 31)) - 1u) << (grp * G);
  int* row = rows[warp][grp];
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long wb = static_cast<long long>(blockIdx.x) * WARPS + warp;
       wb * (BLOCK * NG) < n; wb += stride) {
    const long long wfirst = wb * (BLOCK * NG);
    // group 0's part is the longest: the warp's trip count
    const int len0 = static_cast<int>(n - wfirst < BLOCK ? n - wfirst : BLOCK);
    const long long first = wfirst + grp * BLOCK;
    const long long left = n - first;
    const int glen =
        static_cast<int>(left < 0 ? 0 : left < BLOCK ? left : BLOCK);
    int staged = -1;                   // no row is staged yet
    for (int j0 = 0; j0 < len0; j0 += G) {
      const int m = len0 - j0 < G ? len0 - j0 : G;
      int my_u = 0, my_v = 0;          // pair j0 + gl's indices
      if (j0 + gl < glen) {
        my_u = __ldg(cu + first + j0 + gl);
        my_v = __ldg(cv + first + j0 + gl);
      }
      int mine = 0;
      for (int j = 0; j < m; ++j) {
        const bool active = j0 + j < glen;      // group-uniform
        const int u = __shfl_sync(FULL, my_u, j, G);
        const int v = __shfl_sync(FULL, my_v, j, G);
        const int* a = table + static_cast<long long>(u) * LANES;
        int x[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          x[r] = active ? __ldg(a + gl + 32 * r) : -1;
        if (active && v != staged) {            // group-uniform
          const int4* b = reinterpret_cast<const int4*>(table) +
                          static_cast<long long>(v) * QUADS;
          int4 q[NG];
#pragma unroll
          for (int t = 0; t < NG; ++t) q[t] = __ldg(b + gl + G * t);
          __syncwarp(gmask);           // the previous pair's searches done
#pragma unroll
          for (int t = 0; t < NG; ++t) {
            int* dst = row + 4 * (gl + G * t);
            dst[0] = q[t].x & PAD;     // -1 & PAD == PAD
            dst[1] = q[t].y & PAD;
            dst[2] = q[t].z & PAD;
            dst[3] = q[t].w & PAD;
          }
          staged = v;
        }
        __syncwarp();
        int cnt = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) cnt += find(row, x[r]);
#pragma unroll
        for (int s = G / 2; s > 0; s >>= 1)
          cnt += __shfl_xor_sync(FULL, cnt, s);
        if (gl == j) mine = cnt;
      }
      if (j0 + gl < glen) out[first + j0 + gl] = mine;
    }
  }
}

using Kernel = void (*)(const int*, const int*, const int*, int*, long long);

Kernel pick(int W) {
  switch (W) {
    case 8: return rot_count_kernel<8, 1>;
    case 16: return rot_count_kernel<16, 1>;
    case 32: return rot_count_kernel<32, 1>;
    case 64: return rot_count_kernel<32, 2>;
    case 128: return rot_count_kernel<32, 4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// table (C, 128) int32, 16-byte aligned, rows of distinct ascending ids
// with -1 pads trailing; cu, cv int32[n]; out int32[n].  W: 8, 16, 32, 64
// or 128.  Returns cudaGetLastError() after the launch (0 on success);
// the launch is asynchronous on `stream`.
int gdn_tc_rot_count(const void* table, const void* cu, const void* cv,
                     void* out, long long n, int W, void* stream) {
  const Kernel kernel = pick(W);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const long long per =
      static_cast<long long>(WARPS) * BLOCK * (W < 32 ? 32 / W : 1);
  long long blocks = (n + per - 1) / per;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(cu),
      static_cast<const int*>(cv), static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Consecutive pairs a lane group takes: a run of equal cv is staged once
// within each such part.
int gdn_tc_rot_block() { return BLOCK; }

}  // extern "C"
