// V1: the sequential first-fit of vertex colouring's core pass, on Hopper,
// computed along the dependency DAG of its order.
//
// Replaces no Pallas kernel: the XLA fori_loop `step` of
// gardenia_tpu/solvers/vc.py:268-286 (make_core).  Once at most
// VC_CORE_CAP vertices stay active, the solver orders them largest degree
// first and colours them one after another, exactly:
//
//   for j in 0 .. K-1:
//     row = forb[j, :] with 1 at chosen[i] for every core neighbour i < j
//           of j that has a colour (chosen[i] >= 0)
//     chosen[j] = the first zero of row, or -1 if it has none (saturated)
//
// The reference pushes (step i forbids its colour in every later
// neighbour's row); pulling from the earlier neighbours makes the same
// rows.  forb (K, C) int8, 0 = free and 1 = forbidden by non-core
// neighbours, is only read.  The core-core adjacency is the CSR of its
// lower part: rowptr int64[K+1], col int32, every col[e] < its row.
//
// What bounds it: position j waits only on its earlier neighbours, so the
// chain of dependent work is the longest path D of the order's DAG (1,447
// levels at the VC bench's R-MAT-20 core, K = 57,282), not K.  The kernel
// costs about D hand-overs (a poll's L2 round trip, a search of a bitmap
// in shared memory, a store) plus its bytes, K*C + 12 K + 4 * edges, which
// take microseconds at the card's memory rate.
//
// Design: a persistent grid of WARPS_PER_SM warps an SM (never more
// than K), WARPS_PER_BLOCK a block.  A warp claims the next position j
// by atomicAdd on a counter, so positions are claimed in increasing order
// whatever the order in which blocks run.  At claim time, before it waits
// on anything, the warp turns row j of forb into a bitmap of C bits in
// shared memory (set bits past C), loads row j's neighbours in batches of
// 32 x BATCH and their colours, and ORs in every colour that is final.
// Only on the neighbours still pending (-2) do its lanes spin, with
// relaxed device-scope loads (ld.relaxed.gpu: served by L2, never hoisted
// out of the loop, never a stale L1 line).  When the last one is in, the
// warp takes the first zero bit and publishes chosen[j] with a relaxed
// device-scope store.  The value itself is the message, so no fence is
// needed.  A neighbour's colour is final once it is not -2; -1
// (saturated) forbids nothing.
//
// Why it cannot deadlock: a warp holds one position at a time and waits
// only on positions i < j, which were claimed before j by warps that were
// running when they claimed them.  The lowest unfinished claimed position
// has every earlier position finished, so it can always go on; blocks not
// yet resident have claimed nothing.  No cooperative launch is needed.  A
// column that is not below its row would break that argument, so it is
// ignored; and a wait longer than SPIN_LIMIT polls traps (a launch error)
// instead of hanging.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NONE = INT_MAX;
constexpr int PENDING = -2;          // chosen[j] before j is coloured
constexpr int BATCH = 8;             // neighbours a lane has in flight
constexpr int MAX_C = 16384;         // the solver's palette cap
// The grid, the fastest of scripts/probe_v1.py's sweep at the VC bench's
// core (2-16 warps an SM, with and without a backoff between polls):
// more warps only poll, far ahead of the lowest pending position.
constexpr int WARPS_PER_BLOCK = 4;
constexpr int WARPS_PER_SM = 4;
constexpr long long SPIN_LIMIT = 1ll << 24;

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// bit k set where byte k of w is nonzero (k = 0 .. 3)
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  // bit 7 of a byte: its low seven bits carry into it, or it was set
  const unsigned t = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) |
         ((t >> 28) & 8u);
}

// bit k set where byte k of the 16 bytes is nonzero (k = 0 .. 15)
__device__ __forceinline__ unsigned nonzero16(const int4 v) {
  return nonzero4(static_cast<unsigned>(v.x)) |
         (nonzero4(static_cast<unsigned>(v.y)) << 4) |
         (nonzero4(static_cast<unsigned>(v.z)) << 8) |
         (nonzero4(static_cast<unsigned>(v.w)) << 12);
}

__global__ void vc_core_kernel(const int8_t* __restrict__ forb,
                               const long long* __restrict__ rowptr,
                               const int* __restrict__ col, int* chosen,
                               int* counter, int K, int C, bool vec) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int nw = (C + 31) >> 5;          // bitmap words a warp
  unsigned* bm = smem + (threadIdx.x >> 5) * nw;
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(counter, 1);
    j = __shfl_sync(FULL, j, 0);
    if (j >= K) return;

    // the row's non-core forbidden colours as bits; bits past C are set
    const int8_t* row = forb + static_cast<size_t>(j) * C;
    if (vec) {                           // C % 32 == 0, 16-byte rows
      const int4* r4 = reinterpret_cast<const int4*>(row);
      for (int w = lane; w < nw; w += 32)
        bm[w] = nonzero16(__ldg(r4 + 2 * w)) |
                (nonzero16(__ldg(r4 + 2 * w + 1)) << 16);
    } else {
      for (int w = lane; w < nw; w += 32) {
        unsigned bits = 0;
        for (int k = 0; k < 32; ++k) {
          const int c = 32 * w + k;
          if (c >= C || __ldg(row + c) != 0) bits |= 1u << k;
        }
        bm[w] = bits;
      }
    }
    __syncwarp();

    // pull the earlier neighbours' colours: start a batch's loads, then
    // wait only on those still pending
    const long long e1 = rowptr[j + 1];
    for (long long base = rowptr[j]; base < e1; base += 32 * BATCH) {
      int nb[BATCH], c[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const long long e = base + 32 * b + lane;
        const int i = e < e1 ? __ldg(col + e) : -1;
        nb[b] = (i >= 0 && i < j) ? i : -1;
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        c[b] = nb[b] >= 0 ? ld_relaxed(chosen + nb[b]) : -1;
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        long long spins = 0;
        while (c[b] == PENDING) {
          if (++spins > SPIN_LIMIT) __trap();
          c[b] = ld_relaxed(chosen + nb[b]);
        }
        if (c[b] >= 0) atomicOr(bm + (c[b] >> 5), 1u << (c[b] & 31));
      }
    }
    __syncwarp();

    // the first zero bit: lanes take interleaved words, so the least
    // lane-first is the first
    int best = NONE;
    for (int w = lane; w < nw; w += 32) {
      const unsigned free_bits = ~bm[w];
      if (free_bits) {
        best = 32 * w + __ffs(free_bits) - 1;
        break;
      }
    }
    best = __reduce_min_sync(FULL, best);
    if (lane == 0) st_relaxed(chosen + j, best == NONE ? -1 : best);
    __syncwarp();                        // bm is read before it is reset
  }
}

}  // namespace

extern "C" {

// forb (K, C) int8 (read only), rowptr int64[K+1], col int32 (the lower
// CSR), chosen int32[K] filled with -2 and counter int32[1] zeroed by the
// caller, on the current device.  K >= 0, 1 <= C <= 16384.  Returns
// cudaGetLastError() after the launch (0 on success); the launch is
// asynchronous on `stream`.
int gdn_vc_core_firstfit(const void* forb, const void* rowptr,
                         const void* col, void* chosen, void* counter, int K,
                         int C, void* stream) {
  if (K <= 0) return 0;
  if (C < 1 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int full = (sms * WARPS_PER_SM + WARPS_PER_BLOCK - 1) /
                   WARPS_PER_BLOCK;
  const int needed = (K - 1) / WARPS_PER_BLOCK + 1;
  const int blocks = full < needed ? full : needed;
  const bool vec =
      (C & 31) == 0 && (reinterpret_cast<uintptr_t>(forb) & 15) == 0;
  const size_t shared =
      static_cast<size_t>(WARPS_PER_BLOCK) * ((C + 31) >> 5) * 4;
  vc_core_kernel<<<blocks, 32 * WARPS_PER_BLOCK, shared,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(forb), static_cast<const long long*>(rowptr),
      static_cast<const int*>(col), static_cast<int*>(chosen),
      static_cast<int*>(counter), K, C, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
