// K1: dense panel matmul for the hybrid block-sparse layout, on Hopper.
//
// Replaces gardenia_tpu/ops/pallas_bsr.py::dense_panel_matmul.  For each
// row slot r of one width bucket:
//
//   out[r, i, s] = sum_{w < W, j < 128} panel[r, i, w*128 + j]
//                                       * x3d[src[r, w], j, s]
//
// panel (R, 128, W*128) int8 | bf16 | f32, src (R, W) int32 operand block
// ids, x3d (qx, 128, S) f32, out (R, 128, S) f32; f32 accumulation.  The
// operand-block gather x3d[src] is fused in: the TPU kernel took a
// pregathered (R, W*128, K) operand because Mosaic could not gather inside
// a kernel; here each CTA reads its slot's W operand blocks itself.  There
// is no hi/lo bf16 operand split (an MXU workaround): the operand stays
// f32 and the panel is upcast in registers.
//
// What bounds it: at S=1 (PageRank, SpMV) every panel byte is used for one
// multiply-add, so the kernel is bound by the panel stream,
// R*128*W*128 bytes per call for int8, against the card's device-memory
// bandwidth.  The design reads each panel byte exactly once (S <= 8), with
// 16-byte streaming loads on neighbouring addresses, and keeps the
// operand (W*128*S floats, <= 32 KB) in shared memory.
//
// Design: one CTA of 256 threads per slot (x) and per chunk of SC operand
// columns (y).  The slot's 128 rows are split among groups of g lanes,
// g = min(32, 16-byte chunks per row); a group walks its rows, each lane
// taking every g-th 16-byte chunk of the row, and the group sums its
// lanes with warp shuffles.  Rows are whole in a group, so every output
// element has one writer and no atomics are needed.  Rows that repeat
// across slots (split rows) are summed by the caller's index_add_.
// S > 8 re-streams the panel once per 8 columns: int8 and bf16 panels go to
// the tensor-core kernel there (dense_panel_matmul_tc.cu, routed by
// ops/panel.py), and only f32 panels, which must stay f32-exact, take this
// kernel at any S.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;

// 16 bytes of panel -> floats
__device__ __forceinline__ void unpack(const int4 v, float* a, int8_t) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      a[4 * q + b] = static_cast<float>(static_cast<int8_t>(w[q] >> (8 * b)));
}

struct bf16_tag {};

__device__ __forceinline__ void unpack(const int4 v, float* a, bf16_tag) {
  const unsigned w[4] = {static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                         static_cast<unsigned>(v.z), static_cast<unsigned>(v.w)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[2 * q] = __uint_as_float(w[q] << 16);            // low half first
    a[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const int4 v, float* a, float) {
  a[0] = __int_as_float(v.x);
  a[1] = __int_as_float(v.y);
  a[2] = __int_as_float(v.z);
  a[3] = __int_as_float(v.w);
}

template <typename T> struct Elem { static constexpr int bytes = sizeof(T); };
template <> struct Elem<bf16_tag> { static constexpr int bytes = 2; };

// SC: operand columns per CTA; XS: shared operand floats per width tile
template <typename T, int SC, int XS>
__global__ void __launch_bounds__(THREADS)
panel_matmul_kernel(const int4* __restrict__ panel, const int* __restrict__ src,
                    const float* __restrict__ x3d, float* __restrict__ out,
                    int W, int S) {
  constexpr int E = 16 / Elem<T>::bytes;     // panel elements per 16 bytes
  constexpr int WT = XS / (LANES * SC);      // operand blocks per width tile
  constexpr int CH = WT * LANES / E;         // 16-byte chunks per tile row
  // operand column col = c*E + k of the tile sits at xs[(k*CH + c)*SC + s],
  // so the lanes of a group, reading chunks c, c+1, ..., hit neighbouring
  // banks (a chunk-major layout would put them 16 floats apart)
  __shared__ float xs[XS];
  __shared__ float ys[LANES * SC];           // the slot's output rows

  const int r = blockIdx.x;
  const int s0 = blockIdx.y * SC;
  const int sc = min(SC, S - s0);
  const int row_chunks = W * LANES / E;      // 16-byte chunks per row, >= 8
  const int g = min(32, row_chunks);         // lanes per row group
  const int groups = THREADS / g;
  const int tid = threadIdx.x;
  const int grp = tid / g;
  const int lane = tid % g;

  const int4* slot = panel + static_cast<size_t>(r) * LANES * row_chunks;
  const int* blocks = src + static_cast<size_t>(r) * W;

  for (int i = tid; i < LANES * SC; i += THREADS) ys[i] = 0.f;

  for (int w0 = 0; w0 < W; w0 += WT) {
    const int wn = min(WT, W - w0);
    __syncthreads();                         // previous tile consumed
    for (int i = tid; i < wn * LANES * SC; i += THREADS) {
      const int s = i % SC;
      const int col = i / SC;
      float v = 0.f;
      if (s < sc) {
        const size_t blk = static_cast<size_t>(blocks[w0 + col / LANES]);
        v = x3d[(blk * LANES + col % LANES) * S + s0 + s];
      }
      xs[((col % E) * CH + col / E) * SC + s] = v;
    }
    __syncthreads();

    const int tile_chunks = wn * LANES / E;
    const int tile_off = w0 * LANES / E;
    // every group runs LANES / groups rows, so the shuffles below see all
    // 32 lanes of each warp
    for (int row = grp; row < LANES; row += groups) {
      const int4* p = slot + static_cast<size_t>(row) * row_chunks + tile_off;
      float acc[SC];
#pragma unroll
      for (int s = 0; s < SC; ++s) acc[s] = 0.f;
      for (int c = lane; c < tile_chunks; c += g) {
        float a[E];
        unpack(__ldcs(p + c), a, T());
        const float* xv = xs + c * SC;
#pragma unroll
        for (int k = 0; k < E; ++k)
#pragma unroll
          for (int s = 0; s < SC; ++s)
            acc[s] = fmaf(a[k], xv[k * CH * SC + s], acc[s]);
      }
#pragma unroll
      for (int s = 0; s < SC; ++s) {
        float v = acc[s];
        for (int off = g / 2; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[s] = v;
      }
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < SC; ++s) ys[row * SC + s] += acc[s];
      }
    }
  }
  __syncthreads();
  float* o = out + static_cast<size_t>(r) * LANES * S + s0;
  for (int i = tid; i < LANES * sc; i += THREADS) {
    const int row = i / sc;
    const int s = i % sc;
    o[static_cast<size_t>(row) * S + s] = ys[row * SC + s];
  }
}

template <typename T>
void launch(const void* panel, const int* src, const float* x3d, float* out,
            long long R, int W, int S, cudaStream_t stream) {
  const int4* p = static_cast<const int4*>(panel);
  if (S == 1) {
    dim3 grid(static_cast<unsigned>(R), 1);
    panel_matmul_kernel<T, 1, 4096><<<grid, THREADS, 0, stream>>>(
        p, src, x3d, out, W, S);
  } else {
    dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>((S + 7) / 8));
    panel_matmul_kernel<T, 8, 8192><<<grid, THREADS, 0, stream>>>(
        p, src, x3d, out, W, S);
  }
}

}  // namespace

extern "C" {

// dtype: 0 int8, 1 bfloat16, 2 float32.  Returns cudaGetLastError() after
// the launch (0 on success); the launch is asynchronous on `stream`.
int gdn_dense_panel_matmul(const void* panel, int dtype, const void* src,
                           const void* x3d, void* out, long long R, int W,
                           int S, void* stream) {
  if (R <= 0) return 0;
  const int* s = static_cast<const int*>(src);
  const float* x = static_cast<const float*>(x3d);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<int8_t>(panel, s, x, y, R, W, S, st); break;
    case 1: launch<bf16_tag>(panel, s, x, y, R, W, S, st); break;
    case 2: launch<float>(panel, s, x, y, R, W, S, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gdn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
