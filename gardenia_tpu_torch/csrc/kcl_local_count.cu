// Q1: k-cliques per vertex, each counted in its first vertex's local
// bitmap graph, on Hopper.
//
// Replaces no Pallas kernel: the XLA expansion, candidate-mask and
// rotation passes of gardenia_tpu/mining/kcl.py:175-790 (_kcl_device and
// its helpers), which count k-cliques by expanding embeddings level by
// level.  This is GARDENIA's own GPU design instead (mining/kcl_dfs,
// include/cmap.h): every k-clique of the degree-ordered DAG has one first
// vertex u, and its other k-1 vertices are a (k-1)-clique of the DAG
// induced on N+(u).  So, per vertex u with out-degree d:
//
//   1. stage N+(u) (sorted ids) in shared memory;
//   2. build the local graph A, W = ceil(d / 32) words a row: bit j of
//      A[i] is set iff N+(u)[j] is in N+(N+(u)[i]) -- for each id of that
//      neighbour's row, one binary search in the staged N+(u);
//   3. count k-2 levels of ANDs: k = 3 is sum_i popcount(A[i]); k = 4 is
//      sum_i sum_{j in A[i]} popcount(A[i] & A[j]); deeper k walk the set
//      bits of each level's candidate set, one level deeper each.  A is a
//      DAG, so every clique is found once.
//
// cnt[u] (unsigned 64-bit, zeroed by the caller) gets u's count.  Launch
// shapes, one launch per degree class of the vertex list `verts`:
//   d <= WARP_DEGREE: a warp a vertex, A one word a row in the warp's
//     shared memory; a lane walks its own root row;
//   WARP_DEGREE < d <= MAX_DEGREE: a CTA a vertex with dynamic shared
//     memory sized to the class (4 dmax + 4 dmax ceil(dmax / 32) bytes,
//     135,168 at 1024); warps build rows and then take roots, lane l
//     holding word l of a candidate set, the next set bit found by a
//     ballot.
//
// What bounds it: the membership tests of step 2 (one a neighbour's id,
// about sum over arcs of the target's out-degree) and the word ANDs of
// step 3 (about W a (k-1)-clique); the CSR is read from L2 more than once
// but its bytes are small.  A simple shape that is right: no balancing
// across hub vertices, no persistent grid.
//
// Rows must be sorted ascending (ops/kcl_count.prepare checks), and every
// vertex of `verts` must have k - 1 <= d <= dmax.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MIN_K = 3;
constexpr int MAX_K = 8;
constexpr int WARP_DEGREE = 32;
constexpr int MAX_DEGREE = 1024;     // W <= 32 words: one a lane
constexpr int WARPS_SMALL = 8;       // warp class: vertices a block
constexpr int CTA_THREADS = 256;     // CTA class
constexpr int CTA_WARPS = CTA_THREADS / 32;

// position of id in the ascending s[0..d), or -1
__device__ __forceinline__ int find(const int* s, int d, int id) {
  int lo = 0, hi = d;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < id) lo = mid + 1;
    else hi = mid;
  }
  return (lo < d && s[lo] == id) ? lo : -1;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// cliques of D more vertices in `cand` (one word: d <= 32), this lane alone
template <int D>
__device__ unsigned long long count_word(unsigned cand, const unsigned* A) {
  if constexpr (D == 1) {
    return __popc(cand);
  } else {
    unsigned long long t = 0;
    for (unsigned rest = cand; rest; rest &= rest - 1u) {
      const unsigned nxt = cand & A[__ffs(rest) - 1];
      if (__popc(nxt) >= D - 1) t += count_word<D - 1>(nxt, A);
    }
    return t;
  }
}

// the same over W-word sets, lane l holding word l (0 past W); the whole
// warp calls it and gets its lane's part of the count
template <int D>
__device__ unsigned long long count_words(unsigned cand, const unsigned* A,
                                          int W, int lane) {
  if constexpr (D == 1) {
    return __popc(cand);
  } else {
    unsigned long long t = 0;
    unsigned rest = cand;
    for (;;) {
      const unsigned nz = __ballot_sync(FULL, rest != 0u);
      if (nz == 0u) break;
      const int src = __ffs(nz) - 1;
      const unsigned word = __shfl_sync(FULL, rest, src);
      const int j = 32 * src + __ffs(word) - 1;
      if (lane == src) rest &= rest - 1u;
      const unsigned nxt = lane < W ? cand & A[j * W + lane] : 0u;
      if (D == 2 || __reduce_add_sync(FULL, __popc(nxt)) >= D - 1)
        t += count_words<D - 1>(nxt, A, W, lane);
    }
    return t;
  }
}

template <int K>
__global__ void __launch_bounds__(32 * WARPS_SMALL)
kcl_warp_kernel(const long long* __restrict__ rowptr,
                const int* __restrict__ colidx, const int* __restrict__ verts,
                long long nverts, unsigned long long* __restrict__ cnt) {
  __shared__ int ids_s[WARPS_SMALL][WARP_DEGREE];
  __shared__ unsigned A_s[WARPS_SMALL][WARP_DEGREE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* ids = ids_s[warp];
  unsigned* A = A_s[warp];
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS_SMALL + warp;
       t < nverts; t += static_cast<long long>(gridDim.x) * WARPS_SMALL) {
    const int u = verts[t];
    const long long b = rowptr[u];
    const int d = static_cast<int>(rowptr[u + 1] - b);
    if (lane < d) ids[lane] = __ldg(colidx + b + lane);
    __syncwarp();
    const int lo_id = ids[0], hi_id = ids[d - 1];
    for (int r = 0; r < d; ++r) {
      const int w = ids[r];
      const long long we = rowptr[w + 1];
      unsigned bits = 0;
      for (long long e = rowptr[w] + lane; e < we; e += 32) {
        const int y = __ldg(colidx + e);
        if (y < lo_id || y > hi_id) continue;
        const int j = find(ids, d, y);
        if (j >= 0) bits |= 1u << j;
      }
      bits = __reduce_or_sync(FULL, bits);
      if (lane == 0) A[r] = bits;
    }
    __syncwarp();
    unsigned long long s = lane < d ? count_word<K - 2>(A[lane], A) : 0ull;
    s = warp_sum(s);
    if (lane == 0) cnt[u] = s;
    __syncwarp();                      // ids and A are read before reuse
  }
}

template <int K>
__global__ void __launch_bounds__(CTA_THREADS)
kcl_cta_kernel(const long long* __restrict__ rowptr,
               const int* __restrict__ colidx, const int* __restrict__ verts,
               long long nverts, unsigned long long* __restrict__ cnt,
               int dmax) {
  extern __shared__ unsigned smem[];
  __shared__ unsigned long long part[CTA_WARPS];
  int* ids = reinterpret_cast<int*>(smem);
  unsigned* A = smem + dmax;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long t = blockIdx.x; t < nverts; t += gridDim.x) {
    const int u = verts[t];
    const long long b = rowptr[u];
    const int d = static_cast<int>(rowptr[u + 1] - b);
    const int W = (d + 31) >> 5;
    for (int i = threadIdx.x; i < d; i += CTA_THREADS)
      ids[i] = __ldg(colidx + b + i);
    for (int i = threadIdx.x; i < d * W; i += CTA_THREADS) A[i] = 0u;
    __syncthreads();
    const int lo_id = ids[0], hi_id = ids[d - 1];
    for (int r = warp; r < d; r += CTA_WARPS) {
      const int w = ids[r];
      const long long we = rowptr[w + 1];
      for (long long e = rowptr[w] + lane; e < we; e += 32) {
        const int y = __ldg(colidx + e);
        if (y < lo_id || y > hi_id) continue;
        const int j = find(ids, d, y);
        if (j >= 0) atomicOr(A + r * W + (j >> 5), 1u << (j & 31));
      }
    }
    __syncthreads();
    unsigned long long s = 0;
    for (int r = warp; r < d; r += CTA_WARPS) {
      const unsigned cand = lane < W ? A[r * W + lane] : 0u;
      s += count_words<K - 2>(cand, A, W, lane);
    }
    s = warp_sum(s);
    if (lane == 0) part[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long total = 0;
      for (int i = 0; i < CTA_WARPS; ++i) total += part[i];
      cnt[u] = total;
    }
    __syncthreads();                   // ids, A and part are reused
  }
}

template <int K>
int launch(const long long* rowptr, const int* colidx, const int* verts,
           long long nverts, unsigned long long* cnt, int dmax,
           cudaStream_t stream) {
  constexpr long long MAX_BLOCKS = 1ll << 30;
  if (dmax <= WARP_DEGREE) {
    long long blocks = (nverts + WARPS_SMALL - 1) / WARPS_SMALL;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    kcl_warp_kernel<K><<<static_cast<unsigned>(blocks), 32 * WARPS_SMALL, 0,
                         stream>>>(rowptr, colidx, verts, nverts, cnt);
  } else {
    const size_t shared = 4ull * dmax + 4ull * dmax * ((dmax + 31) / 32);
    // above 48 KB a launch is refused unless the kernel is allowed more
    const cudaError_t err = cudaFuncSetAttribute(
        kcl_cta_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = nverts < MAX_BLOCKS ? nverts : MAX_BLOCKS;
    kcl_cta_kernel<K><<<static_cast<unsigned>(blocks), CTA_THREADS, shared,
                        stream>>>(rowptr, colidx, verts, nverts, cnt, dmax);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rowptr int64[m+1], colidx int32 (rows ascending), verts int32[nverts]
// (vertices with k - 1 <= d <= dmax), cnt uint64[m] zeroed by the caller,
// on the current device; MIN_K <= k <= MAX_K, 1 <= dmax <= MAX_DEGREE.
// dmax picks the launch shape and the shared memory.  Returns
// cudaGetLastError() after the launch (0 on success); the launch is
// asynchronous on `stream`.
int gdn_kcl_local_count(const void* rowptr, const void* colidx,
                        const void* verts, long long nverts, void* cnt, int k,
                        int dmax, void* stream) {
  if (nverts <= 0) return 0;
  if (k < MIN_K || k > MAX_K || dmax < 1 || dmax > MAX_DEGREE)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const long long*>(rowptr);
  const auto* ci = static_cast<const int*>(colidx);
  const auto* vs = static_cast<const int*>(verts);
  auto* out = static_cast<unsigned long long*>(cnt);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return launch<3>(rp, ci, vs, nverts, out, dmax, s);
    case 4: return launch<4>(rp, ci, vs, nverts, out, dmax, s);
    case 5: return launch<5>(rp, ci, vs, nverts, out, dmax, s);
    case 6: return launch<6>(rp, ci, vs, nverts, out, dmax, s);
    case 7: return launch<7>(rp, ci, vs, nverts, out, dmax, s);
    default: return launch<8>(rp, ci, vs, nverts, out, dmax, s);
  }
}

int gdn_kcl_min_k() { return MIN_K; }
int gdn_kcl_max_k() { return MAX_K; }
int gdn_kcl_warp_degree() { return WARP_DEGREE; }
int gdn_kcl_max_degree() { return MAX_DEGREE; }

}  // extern "C"
