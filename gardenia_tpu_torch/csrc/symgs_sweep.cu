// GS1: the sweep of one SymGS colour block (solvers/symgs.symgs_solver) on
// Hopper, in one launch.
//
// Replaces no Pallas kernel: the JAX package runs SymGS as 2 x colours
// masked slab SpMVs in XLA (gardenia_tpu/solvers/symgs.py, its `sweep`),
// and the port's plain version (ops/symgs_sweep.sweep_block_plain) takes
// about seven torch launches a block: the gather x[col], the product,
// torch.segment_reduce (cub's segmented reduce) over the block's row
// offsets and the row update.
// For every row i in r0 .. r0 + rows - 1 of the colour-ordered CSR:
//
//   x[i] = update[i] ? (b[i] - sum_{k in row i} val[k] * x[col[k]]) / diag[i]
//                    : x[i]
//
// in place.  The row's arcs are e0 + offsets[i - r0] .. e0 + offsets[i - r0
// + 1]; col int32 (positions in the ordered x), val f32, offsets int64
// [rows + 1] (relative to e0), b, diag and x f32, update bool.  In place is
// race-free: the colouring is proper, so no two rows of a block are joined
// by an arc and a row's sum reads only x of other colours (a self-arc reads
// the row's own x before its group writes it).  The products are rounded to
// float32 and summed in float32 (no contraction into an FMA), as the plain
// version computes them; only the order of a row's sum differs.
//
// What bounds it: the arc stream, each arc's column id and value (8 B)
// read once, contiguously, and each row's offsets, update, b, diag and x
// (25 B); x itself (4 MB at 2^20 rows) stays in the 50 MB L2, so the
// gathers x[col] are L2 hits.  The arcs are streamed with evict-first
// loads, so that they do not push x out of L2.  A block of a few rows is
// bound by the launch's latency instead.
//
// Design: a group of L lanes a row (L = 8, 16 or 32, a template parameter
// the wrapper chooses from the block's widest row, which it knows from the
// build), so a row of HPCG's 27-point stencil (7-26 arcs) is one warp that
// reads its col and val coalesced; a row wider than L loops over its arcs
// in strides of L.  A row alone is a chain of dependent loads (its offsets,
// then its arcs, then the gathers of x), which leaves too few bytes in
// flight to reach the card's bandwidth (one row a group ran at 27% of the
// bound on hpcg20); so a group takes ROWS consecutive rows and starts the
// loads of each one's first L arcs before it uses any of them, and only
// the rows wider than L go on in a loop.  Lane j loads row j's update, b
// and diag first, so those loads overlap the arc stream.  The group sums
// each row's lane parts with xor shuffles of width L, after which every
// lane holds the sums, and lane j writes row j.  Nothing is read back and
// no atomic is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;       // rows a group, their first arcs in flight

template <int L>
__global__ void __launch_bounds__(THREADS) symgs_sweep_kernel(
    const long long* __restrict__ offsets, const int* __restrict__ col,
    const float* __restrict__ val, const float* __restrict__ b,
    const float* __restrict__ diag, const unsigned char* __restrict__ update,
    float* x, long long r0, long long rows) {
  static_assert(ROWS <= L, "lane j writes row j of its group");
  const long long first =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / L *
      ROWS;
  const int lane = threadIdx.x & (L - 1);
  // the writer's row: its update, b and diag, loaded before the arcs
  const long long mine = first + lane;
  const bool writes = lane < ROWS && mine < rows;
  bool up = false;
  float bi = 0.0f, di = 1.0f;
  if (writes) {
    up = update[r0 + mine] != 0;
    bi = b[r0 + mine];
    di = diag[r0 + mine];
  }
  long long beg[ROWS], end[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const bool live = first + j < rows;
    beg[j] = live ? offsets[first + j] + lane : 0;
    end[j] = live ? offsets[first + j + 1] : 0;
  }
  // each row's first stride of arcs: every load started before any use
  int c[ROWS] = {};
  float v[ROWS] = {};
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    if (beg[j] < end[j]) {
      c[j] = __ldcs(col + beg[j]);
      v[j] = __ldcs(val + beg[j]);
    }
  }
  float sum[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
    sum[j] = beg[j] < end[j] ? __fmul_rn(v[j], x[c[j]]) : 0.0f;
  // the rest of the rows wider than L
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
    for (long long k = beg[j] + L; k < end[j]; k += L)
      sum[j] = __fadd_rn(sum[j], __fmul_rn(__ldcs(val + k),
                                           x[__ldcs(col + k)]));
  // every lane of the warp takes part, rows past the block with 0
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      sum[j] = __fadd_rn(sum[j], __shfl_xor_sync(0xffffffffu, sum[j], off));
    if (lane == j) total = sum[j];
  }
  if (writes && up) x[r0 + mine] = __fdiv_rn(__fsub_rn(bi, total), di);
}

template <int L>
void launch(unsigned ctas, cudaStream_t stream, const long long* offsets,
            const int* col, const float* val, const float* b,
            const float* diag, const unsigned char* update, float* x,
            long long r0, long long rows) {
  symgs_sweep_kernel<L><<<ctas, THREADS, 0, stream>>>(
      offsets, col, val, b, diag, update, x, r0, rows);
}

}  // namespace

extern "C" {

// One colour block: rows r0 .. r0 + rows - 1 over arcs e0 .. (offsets as
// above), lanes L a row (8, 16 or 32).  Returns cudaGetLastError() after
// the launch (0 on success); the launch is asynchronous on `stream`.
int gdn_symgs_sweep(const void* offsets, const void* col, const void* val,
                    const void* b, const void* diag, const void* update,
                    void* x, long long r0, long long rows, long long e0,
                    int lanes, void* stream) {
  if (rows <= 0) return 0;
  if (lanes != 8 && lanes != 16 && lanes != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (rows + ROWS - 1) / ROWS;
  const long long ctas = (groups * lanes + THREADS - 1) / THREADS;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* o = static_cast<const long long*>(offsets);
  const int* c = static_cast<const int*>(col) + e0;
  const float* v = static_cast<const float*>(val) + e0;
  const auto* bb = static_cast<const float*>(b);
  const auto* d = static_cast<const float*>(diag);
  const auto* u = static_cast<const unsigned char*>(update);
  auto* xx = static_cast<float*>(x);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto n = static_cast<unsigned>(ctas);
  if (lanes == 8)
    launch<8>(n, s, o, c, v, bb, d, u, xx, r0, rows);
  else if (lanes == 16)
    launch<16>(n, s, o, c, v, bb, d, u, xx, r0, rows);
  else
    launch<32>(n, s, o, c, v, bb, d, u, xx, r0, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
