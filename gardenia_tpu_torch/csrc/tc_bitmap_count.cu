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
// What bounds it on this card: the reads of row hv, against L2 and
// device-memory bandwidth.  The first design (one warp per pair) read both
// rows whole, 8 wpad bytes a pair (32 GB at R-MAT-20 over a 66 MB
// bitmap).  But the rows are sparse (at R-MAT-20 30% of a row's 16-byte
// quads are nonzero on average), an AND with a zero word is zero, and the
// stream is in hu order (each hu row serves ~243 consecutive pairs).
//
// Design: each CTA takes a contiguous block of BLOCK hub pairs and walks
// its runs of equal hu.  For each run, tile by tile (TILE_Q quads, 16 KB,
// so any wpad works), the CTA loads bmp[hu]'s tile once, and a block scan
// compacts its nonzero quads, values and positions, into shared memory.
// Then each warp takes two pairs of the run at a time, gathers only those
// quads of both rows bmp[hv] (16-byte loads, both pairs' in flight
// together), ANDs, __popc's and warp-reduces, and adds the tile's counts
// to the pairs' in shared memory.  A tile without a nonzero
// quad costs no read of any hv row.  The counts are written once per
// block.  Nothing depends on the stream's order: a run of length 1 is one
// pair, which then pays for its own hu tiles.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK = 256;           // hub pairs per CTA
constexpr int TILE_Q = 1024;         // 16-byte quads of the hu row per tile
constexpr int QPT = TILE_Q / THREADS;
constexpr long long MAX_BLOCKS = 1LL << 20;
constexpr unsigned FULL = 0xffffffffu;
static_assert(BLOCK <= THREADS, "one pass of the CTA finds a run's end");

__device__ __forceinline__ int popc4(uint4 x, uint4 y) {
  return __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
         __popc(x.w & y.w);
}

__global__ void __launch_bounds__(THREADS)
bitmap_count_kernel(const uint4* __restrict__ bmp, const int* __restrict__ hu,
                    const int* __restrict__ hv, int* __restrict__ out,
                    long long n, int wq) {
  __shared__ uint4 val[TILE_Q];      // the tile's nonzero quads of bmp[hu]
  __shared__ int pos[TILE_Q];        // and their quad index in the row
  __shared__ int su[BLOCK], sv[BLOCK], acc[BLOCK];
  __shared__ int warp_nz[WARPS];
  __shared__ int run_end;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (long long b = blockIdx.x; b * BLOCK < n; b += gridDim.x) {
    const long long first = b * BLOCK;
    const int len = static_cast<int>(n - first < BLOCK ? n - first : BLOCK);
    for (int j = tid; j < len; j += THREADS) {
      su[j] = __ldg(hu + first + j);
      sv[j] = __ldg(hv + first + j);
      acc[j] = 0;
    }
    __syncthreads();
    for (int start = 0; start < len;) {
      const int u = su[start];
      if (tid == 0) run_end = len;
      __syncthreads();
      const int j = start + 1 + tid;
      if (j < len && su[j] != u) atomicMin(&run_end, j);
      __syncthreads();
      const int end = run_end;
      const uint4* ru = bmp + static_cast<long long>(u) * wq;
      for (int t0 = 0; t0 < wq; t0 += TILE_Q) {
        // this thread's quads of the tile, and how many are nonzero
        uint4 q[QPT];
        int nz = 0;
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          const int qi = t0 + tid + k * THREADS;
          q[k] = qi < wq ? __ldg(ru + qi) : make_uint4(0, 0, 0, 0);
          nz += (q[k].x | q[k].y | q[k].z | q[k].w) != 0;
        }
        // block scan of nz: the offset of this thread's nonzero quads
        int incl = nz;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, s);
          if (lane >= s) incl += y;
        }
        if (lane == 31) warp_nz[warp] = incl;
        __syncthreads();
        int off = incl - nz, total = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          off += w < warp ? warp_nz[w] : 0;
          total += warp_nz[w];
        }
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          if (q[k].x | q[k].y | q[k].z | q[k].w) {
            val[off] = q[k];
            pos[off] = t0 + tid + k * THREADS;
            ++off;
          }
        }
        __syncthreads();
        if (total) {
          // two pairs a warp at a time, so their gathers overlap
          for (int p = start + warp; p < end; p += 2 * WARPS) {
            const int p2 = p + WARPS < end ? p + WARPS : p;   // warp-uniform
            const uint4* rv = bmp + static_cast<long long>(sv[p]) * wq;
            const uint4* rw = bmp + static_cast<long long>(sv[p2]) * wq;
            int c1 = 0, c2 = 0;
#pragma unroll 2
            for (int k = lane; k < total; k += 32) {
              const uint4 a = val[k];
              const int qi = pos[k];
              c1 += popc4(a, __ldg(rv + qi));
              if (p2 != p) c2 += popc4(a, __ldg(rw + qi));
            }
            c1 = __reduce_add_sync(FULL, c1);
            c2 = __reduce_add_sync(FULL, c2);
            if (lane == 0) {
              acc[p] += c1;
              if (p2 != p) acc[p2] += c2;
            }
          }
        }
        __syncthreads();               // before val, pos, run_end are reused
      }
      start = end;
    }
    for (int j = tid; j < len; j += THREADS) out[first + j] = acc[j];
    __syncthreads();                   // before su, sv, acc are reused
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
  long long blocks = (n + BLOCK - 1) / BLOCK;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  bitmap_count_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(bmp), static_cast<const int*>(hu),
      static_cast<const int*>(hv), static_cast<int*>(out), n, wpad / 4);
  return static_cast<int>(cudaGetLastError());
}

// Consecutive hub pairs a CTA takes (a run of equal hu is staged once
// within each such block), and the words of the hu row per shared tile.
int gdn_tc_bitmap_block() { return BLOCK; }
int gdn_tc_bitmap_tile_words() { return 4 * TILE_Q; }

}  // extern "C"
