// H1: per-pair hub-bitmap intersection count of triangle counting's rotate
// path, on Hopper.
//
// Has no Pallas counterpart: the JAX package runs this pass in XLA
// (gardenia_tpu/solvers/tc.py:351-361, _make_bm_run).  For hub pair p:
//
//   out[p] = popcount(bmp[hu[p]] & bmp[hv[p]])   over the row's wpad words
//
// bmp (H+1, wpad) uint32 holds each hub's out-neighbours as bits of the
// small id prefix that degree relabelling gathers them in (3 KB rows at
// R-MAT-20, 5.25M hub pairs).
//
// What bounds it on this card: the two row reads, 8 wpad bytes per pair
// (32 GB at R-MAT-20 over a 66 MB bitmap, so much of it hits in the 50 MB
// L2), against L2 and device-memory bandwidth.  An elementwise version
// would write the gathered and AND-ed rows back to memory and run the
// popcount as ~10 passes over them; here they stay in registers.
//
// Design: one warp per pair, grid-stride over a 64-bit pair index.  The
// lanes walk the two rows in 16-byte loads on neighbouring addresses,
// __popc the AND of each word, and a warp reduce gives the count, which
// lane 0 writes.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;             // warps (pairs in flight) per CTA
constexpr long long MAX_BLOCKS = 1LL << 20;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
bitmap_count_kernel(const uint4* __restrict__ bmp, const int* __restrict__ hu,
                    const int* __restrict__ hv, int* __restrict__ out,
                    long long n, int wq) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long p = static_cast<long long>(blockIdx.x) * WARPS +
                     (threadIdx.x >> 5);
       p < n; p += stride) {
    const uint4* ra = bmp + static_cast<long long>(__ldg(hu + p)) * wq;
    const uint4* rb = bmp + static_cast<long long>(__ldg(hv + p)) * wq;
    int cnt = 0;
    for (int c = lane; c < wq; c += 32) {
      const uint4 x = __ldg(ra + c);
      const uint4 y = __ldg(rb + c);
      cnt += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
             __popc(x.w & y.w);
    }
    cnt = __reduce_add_sync(FULL, cnt);
    if (lane == 0) out[p] = cnt;
  }
}

}  // namespace

extern "C" {

// bmp (H+1, wpad) 32-bit words, 16-byte aligned, wpad a positive multiple
// of 4; hu, hv int32[n]; out int32[n].  Returns cudaGetLastError() after
// the launch (0 on success); the launch is asynchronous on `stream`.
int gdn_tc_bitmap_count(const void* bmp, const void* hu, const void* hv,
                        void* out, long long n, int wpad, void* stream) {
  if (wpad <= 0 || wpad % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  long long blocks = (n + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  bitmap_count_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(bmp), static_cast<const int*>(hu),
      static_cast<const int*>(hv), static_cast<int*>(out), n, wpad / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
