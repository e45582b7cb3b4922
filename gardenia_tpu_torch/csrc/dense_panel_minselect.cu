// K2: dense-panel min-select for the hybrid block-sparse layout, on Hopper.
//
// Replaces gardenia_tpu/ops/pallas_bsr.py::dense_panel_minselect.  For
// each row slot r of one width bucket:
//
//   out[r, i] = min over j < W*128 with panel[r, i, j] != 0 of
//               x2d[src[r, j / 128], j % 128]
//
// and `sentinel` where row i of the slot has no nonzero cell.  panel
// (R, 128, W*128) int8 | bf16 | f32 (zero = no edge; -0.0 counts as zero,
// as `panel != 0` does), src (R, W) int32 label block ids, x2d (qx, 128)
// int32 labels, out (R, 128) int32.  This is the min-select semiring of
// connected components' label propagation.  The TPU kernel took labels
// pre-gathered through src, because Mosaic could not gather inside a
// kernel; here each CTA gathers its slot's W*128 labels itself.
//
// What bounds it: one compare per panel cell, and one min per nonzero
// cell, against one panel byte (int8) per cell, so the kernel is bound by
// the panel stream, R*128*W*128 bytes per call, against device-memory
// bandwidth.  The design reads each panel byte exactly once, with 16-byte
// streaming loads on neighbouring addresses; a chunk whose 16 bytes are
// all zero (most of them: a dense block needs only 16 of its 16,384
// cells) costs one test, and labels are read from shared memory only for
// nonzero cells.
//
// Design: one CTA of 256 threads per slot.  The slot's labels (W*128
// int32, at most 16 KB at W = 32) are staged in shared memory.  The 128
// rows are split among groups of g lanes, g = 8, 16 or 32 (the largest
// that the row's 16-byte chunks fill); a group walks its rows, each lane taking every g-th chunk of the
// row and keeping its min in a register, and the group reduces with warp
// shuffles.  A row is whole in one group, so every output element has
// one writer and no atomics are needed.  Rows that repeat across slots
// (split rows) are combined by the caller's amin scatter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int MAX_W = 32;
constexpr unsigned FULL = 0xffffffffu;

struct bf16_tag {};

// bit k set <=> element k of the 16 bytes is nonzero
__device__ __forceinline__ unsigned nonzero_mask(const int4 v, int8_t) {
  const unsigned w[4] = {static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                         static_cast<unsigned>(v.z), static_cast<unsigned>(v.w)};
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      m |= static_cast<unsigned>(((w[q] >> (8 * b)) & 0xffu) != 0)
           << (4 * q + b);
  return m;
}

__device__ __forceinline__ unsigned nonzero_mask(const int4 v, bf16_tag) {
  const unsigned w[4] = {static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                         static_cast<unsigned>(v.z), static_cast<unsigned>(v.w)};
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    m |= static_cast<unsigned>((w[q] & 0x7fffu) != 0) << (2 * q);  // low half
    m |= static_cast<unsigned>((w[q] & 0x7fff0000u) != 0) << (2 * q + 1);
  }
  return m;
}

__device__ __forceinline__ unsigned nonzero_mask(const int4 v, float) {
  return static_cast<unsigned>((v.x & 0x7fffffff) != 0) |
         static_cast<unsigned>((v.y & 0x7fffffff) != 0) << 1 |
         static_cast<unsigned>((v.z & 0x7fffffff) != 0) << 2 |
         static_cast<unsigned>((v.w & 0x7fffffff) != 0) << 3;
}

template <typename T> struct Elem { static constexpr int bytes = sizeof(T); };
template <> struct Elem<bf16_tag> { static constexpr int bytes = 2; };

template <typename T>
__global__ void __launch_bounds__(THREADS)
minselect_kernel(const int4* __restrict__ panel, const int* __restrict__ src,
                 const int* __restrict__ x2d, int* __restrict__ out, int W,
                 int sentinel) {
  constexpr int E = 16 / Elem<T>::bytes;     // panel elements per 16 bytes
  // label of column col = c*E + k sits at xs[k*row_chunks + c], so the
  // lanes of a group, reading chunks c, c+1, ..., hit neighbouring banks
  __shared__ int xs[MAX_W * LANES];

  const int r = blockIdx.x;
  const int row_chunks = W * LANES / E;      // 16-byte chunks per row, >= 8
  // lanes per row group: a power of two, so groups tile each warp
  const int g = row_chunks >= 32 ? 32 : (row_chunks >= 16 ? 16 : 8);
  const int groups = THREADS / g;
  const int tid = threadIdx.x;
  const int grp = tid / g;
  const int lane = tid % g;

  const int* blocks = src + static_cast<size_t>(r) * W;
  for (int col = tid; col < W * LANES; col += THREADS) {
    const size_t blk = static_cast<size_t>(blocks[col / LANES]);
    xs[(col % E) * row_chunks + col / E] = x2d[blk * LANES + col % LANES];
  }
  __syncthreads();

  const int4* slot = panel + static_cast<size_t>(r) * LANES * row_chunks;
  // every group runs LANES / groups rows, so the shuffles below see all
  // 32 lanes of each warp
  for (int row = grp; row < LANES; row += groups) {
    const int4* p = slot + static_cast<size_t>(row) * row_chunks;
    int acc = sentinel;
    for (int c = lane; c < row_chunks; c += g) {
      unsigned m = nonzero_mask(__ldcs(p + c), T());
      while (m) {
        const int k = __ffs(m) - 1;
        m &= m - 1;
        acc = min(acc, xs[k * row_chunks + c]);
      }
    }
    for (int off = g / 2; off > 0; off >>= 1)
      acc = min(acc, __shfl_xor_sync(FULL, acc, off));
    if (lane == 0) out[static_cast<size_t>(r) * LANES + row] = acc;
  }
}

template <typename T>
void launch(const void* panel, const int* src, const int* x2d, int* out,
            long long R, int W, int sentinel, cudaStream_t stream) {
  minselect_kernel<T><<<static_cast<unsigned>(R), THREADS, 0, stream>>>(
      static_cast<const int4*>(panel), src, x2d, out, W, sentinel);
}

}  // namespace

extern "C" {

// dtype: 0 int8, 1 bfloat16, 2 float32; 1 <= W <= 32.  Returns
// cudaGetLastError() after the launch (0 on success); the launch is
// asynchronous on `stream`.
int gdn_dense_panel_minselect(const void* panel, int dtype, const void* src,
                              const void* x2d, void* out, long long R, int W,
                              int sentinel, void* stream) {
  if (R <= 0) return 0;
  if (W < 1 || W > MAX_W) return static_cast<int>(cudaErrorInvalidValue);
  const int* s = static_cast<const int*>(src);
  const int* x = static_cast<const int*>(x2d);
  int* y = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<int8_t>(panel, s, x, y, R, W, sentinel, st); break;
    case 1: launch<bf16_tag>(panel, s, x, y, R, W, sentinel, st); break;
    case 2: launch<float>(panel, s, x, y, R, W, sentinel, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
