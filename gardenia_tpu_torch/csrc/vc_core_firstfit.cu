// V1: the sequential first-fit of vertex colouring's core pass, on Hopper.
//
// Replaces no Pallas kernel: the XLA fori_loop `step` of
// gardenia_tpu/solvers/vc.py:268-286 (make_core).  Once at most
// VC_CORE_CAP vertices stay active, the solver orders them largest degree
// first and colours them one after another, exactly, in K dependent steps:
//
//   for i in 0 .. K-1:
//     c_i = the first zero of forb[i, :]
//     if the row has no zero: chosen[i] = -1 (saturated), nothing changes
//     else: chosen[i] = c_i and forb[j, c_i] = 1 for every core neighbour
//           j > i of i
//
// forb (K, C) int8, 0 = free and 1 = forbidden, is updated in place (the
// wrapper hands the kernel a copy); the core-core adjacency is a CSR of
// its upper part (rowptr int64[K+1], col int32, every col[e] > its row):
// only the rows after i are read after step i, so the lower part would be
// dead weight.  A CSR and not the reference's dense (K, K) byte matrix:
// a step then reads its row's neighbours and no more, K*K bytes (4 GB at
// K = 65,536) are never built, and the updated table (K * C bytes, 16 MB
// at C = 256) stays in L2.
//
// What bounds it: the K steps are dependent (step i + 1 reads what step i
// wrote), so the time is K times one step's latency (an L2 read of the
// row, a warp reduction, the neighbour stores and two block barriers),
// not the bytes.  The bytes its inputs need, K * C + 12 K + 4 * edges,
// take microseconds at the card's memory rate; `gdn_vc_core_steps` runs
// the same loop with no loads or stores, which measures the floor that
// the barriers set.
//
// Design, simple first: one CTA of 512 threads walks the steps.  Warp 0
// finds the row's first zero (16-byte L2 reads, a lane's first zero byte
// by the has-zero-byte bit trick, then a warp min) and lane 0 writes
// chosen[i]; after a barrier every thread takes a share of the row's
// neighbours and sets their byte of column c_i; a second barrier makes the
// stores visible to the next step's search.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NONE = INT_MAX;

// index of the first zero byte of the 16 bytes (little-endian), or 16
__device__ __forceinline__ int first_zero16(const int4 v) {
  const unsigned w[4] = {static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                         static_cast<unsigned>(v.z), static_cast<unsigned>(v.w)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // the lowest flagged byte is the lowest zero byte: a nonzero byte
    // below it borrows nothing and has no flag
    const unsigned t = (w[q] - 0x01010101u) & ~w[q] & 0x80808080u;
    if (t) return 4 * q + ((__ffs(t) - 1) >> 3);
  }
  return 16;
}

// first zero of a row of C bytes, searched by one warp (NONE: no zero)
__device__ __forceinline__ int first_zero(const int8_t* row, int C, int lane) {
  int best = NONE;
  if ((C & 15) == 0) {
    const int4* r4 = reinterpret_cast<const int4*>(row);
    for (int k = lane; k < C / 16; k += 32) {
      const int z = first_zero16(__ldcg(r4 + k));
      if (z < 16) {
        best = 16 * k + z;
        break;
      }
    }
  } else {
    for (int k = lane; k < C; k += 32)
      if (__ldcg(reinterpret_cast<const signed char*>(row) + k) == 0) {
        best = k;
        break;
      }
  }
  // lanes take interleaved chunks, so the least lane-first is the first
  return __reduce_min_sync(FULL, best);
}

template <bool kWork>
__global__ void __launch_bounds__(THREADS, 1)
    vc_core_kernel(int8_t* forb, const long long* __restrict__ rowptr,
                   const int* __restrict__ col, int* __restrict__ chosen,
                   int K, int C) {
  __shared__ int s_c;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = 0; i < K; ++i) {
    if (tid < 32) {
      const int c = kWork ? first_zero(forb + static_cast<size_t>(i) * C, C,
                                       lane)
                          : i;
      if (lane == 0) {
        if (kWork) chosen[i] = c == NONE ? -1 : c;
        s_c = c;
      }
    }
    __syncthreads();
    const int c = s_c;
    if (kWork && c != NONE) {
      const long long e1 = rowptr[i + 1];
      for (long long e = rowptr[i] + tid; e < e1; e += THREADS)
        forb[static_cast<size_t>(col[e]) * C + c] = 1;
    }
    // the stores are seen by the next search; s_c is read before it
    // changes
    __syncthreads();
    if (!kWork && tid == 0 && c < 0) chosen[0] = c;  // keeps the loop
  }
}

}  // namespace

extern "C" {

// forb (K, C) int8 in place, rowptr int64[K+1], col int32, chosen
// int32[K]; K >= 0, C >= 1.  Returns cudaGetLastError() after the launch
// (0 on success); the launch is asynchronous on `stream`.
int gdn_vc_core_firstfit(void* forb, const void* rowptr, const void* col,
                         void* chosen, int K, int C, void* stream) {
  if (K <= 0) return 0;
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  vc_core_kernel<true><<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(forb), static_cast<const long long*>(rowptr),
      static_cast<const int*>(col), static_cast<int*>(chosen), K, C);
  return static_cast<int>(cudaGetLastError());
}

// The same kernel's K steps with no search and no stores: its barriers
// and shared-memory hand-over alone (the floor of the K dependent steps).
// sink int32[1] is never written (no step index is negative).
int gdn_vc_core_steps(int K, void* sink, void* stream) {
  if (K <= 0) return 0;
  vc_core_kernel<false><<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      nullptr, nullptr, nullptr, static_cast<int*>(sink), K, 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
