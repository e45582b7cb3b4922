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
//   1. stage N+(u) (sorted ids) in shared memory and index it: a table of
//      P slots (P the least power of two >= 2 d) holding positions by
//      linear probing from a multiplicative hash, the id checked against
//      the staged row, and a filter of 128 bits a slot under a second
//      hash;
//   2. build the local graph A, W = ceil(d / 32) words a row: bit j of
//      A[i] is set iff N+(u)[j] is in N+(N+(u)[i]) -- a warp streams that
//      neighbour's row, SCAN_UNROLL ids a lane in flight, and tests all of
//      them in the window [N+(u)[0], N+(u)[d-1]] and the filter (one
//      shared read: at most about 1/256 of the ids not in N+(u) pass)
//      before any probes the table, so the warp's divergent probe rounds
//      are mostly the hits';
//   3. count k-2 levels of ANDs: k = 3 is sum_i popcount(A[i]); k = 4 is
//      sum over local edges (i, j) of popcount(A[i] & A[j]); deeper k walk
//      the set bits of each level's candidate set, one level deeper each.
//      A is a DAG, so every clique is found once.
//
// cnt[u] (unsigned 64-bit) gets u's count.  Two launch shapes, chosen by
// dmax, the widest out-degree of the launched vertex list `verts`:
//   dmax <= WARP_DEGREE: a warp a vertex, a row of A one word (d <= 32) or
//     two (d <= 64) in the warp's static shared memory; lane r stages row
//     r's CSR bounds, a row's bits are ORed across the warp once, and lane
//     i walks root i's cliques alone (count_word);
//   WARP_DEGREE < dmax <= MAX_DEGREE: a persistent grid of as many
//     CTA_THREADS CTAs as fit on the card; each CTA takes its next vertex
//     from `counter`, so with `verts` in descending out-degree the widest
//     start first and the narrow fill the tail.  Dynamic shared memory is
//     sized to dmax (shared_bytes: A, the staged ids, the table and the
//     filter).  Hits set A's bits by shared atomicOr.  At k = 4 rows of
//     W < MMA_MIN_WORDS words give each root a group of G lanes (G the
//     least power of two >= W, lane q holding word q of A[i]) that walks
//     A[i]'s bits in step from shared memory, four rows read at once;
//     wider rows go to the tensor cores: C = A A^T by mma.sync m16n8k256
//     on single bits (AND, popcount), a warp a 16 x 8 tile, and since C
//     is symmetric and A has no 2-cycle the count is the sum over r < j of
//     (A[r][j] | A[j][r]) C[r][j], so only tiles above the diagonal whose
//     mask has a bit are multiplied.  k >= 5 keep a warp a root, its
//     candidate sets walked by ballot.
//
// What bounds it: the stream of neighbour rows and the membership tests of
// step 2 (one a neighbour's id: about sum over arcs of the target's
// out-degree, 4.35 G at R-MAT-20, each a 4-byte read from L2 and a
// filter read, a probe for the hits, about one in ten), then the count's
// word ANDs (W a local edge at k = 4).  scripts/probe_q1.py splits the
// time into the stream, the build and the count by degree class.  The
// bound counts only the smaller side of each arc; the scan reads both.
// Rows must be sorted ascending (ops/kcl_count.prepare checks), and every
// vertex of `verts` must have k - 1 <= d <= dmax.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MIN_K = 3;
constexpr int MAX_K = 8;
constexpr int WARP_DEGREE = 64;      // a warp a vertex, 1 or 2 words a row
constexpr int MAX_DEGREE = 1024;     // W <= 32 words: one a lane
constexpr int WARPS_SMALL = 8;       // warp shape: vertices a block
constexpr int CTA_THREADS = 512;     // CTA shape
constexpr int CTA_WARPS = CTA_THREADS / 32;
constexpr int SCAN_UNROLL = 4;       // ids a lane has in flight
constexpr int FILTER_SHIFT = 7;      // filter bits = 128 x table slots
constexpr int MMA_MIN_WORDS = 9;     // k = 4: tensor cores from W = 9 up
constexpr int EMPTY = -1;            // a free slot
constexpr unsigned HASH_MUL = 2654435769u;     // 2^32 / golden ratio
constexpr unsigned FILTER_MUL = 2246822519u;   // another odd multiplier

// log2 of the table's slots for out-degree d: the least b with 2^b >= 2d
__host__ __device__ constexpr int hash_bits(int d) {
  int b = 1;
  while ((1 << b) < 2 * d) ++b;
  return b;
}

__host__ __device__ constexpr unsigned hash_slot(int id, int bits) {
  return (static_cast<unsigned>(id) * HASH_MUL) >> (32 - bits);
}

__host__ __device__ constexpr unsigned filter_bit(int id, int fbits) {
  return (static_cast<unsigned>(id) * FILTER_MUL) >> (32 - fbits);
}

__host__ __device__ constexpr int words(int d) { return (d + 31) >> 5; }

// lanes a root at k = 4: the least power of two >= W
__host__ __device__ constexpr int group_lanes(int W) {
  int g = 1;
  while (g < W) g <<= 1;
  return g;
}

// dynamic shared memory of the CTA shape for out-degrees <= dmax: A
// (4 dmax W bytes), ids (4 dmax), the table (4 P) and the filter
// (2^FILTER_SHIFT P bits)
__host__ __device__ constexpr long long shared_bytes(int dmax) {
  const long long slots = 1ll << hash_bits(dmax);
  return 4ll * dmax * words(dmax) + 4ll * dmax + 4 * slots +
         (slots << FILTER_SHIFT >> 3);
}

// ids[at] into the table (its position, by linear probing; ids distinct)
// and the filter (one bit)
__device__ __forceinline__ void insert(int* table, unsigned* filter,
                                       int bits, int id, int at) {
  const unsigned mask = (1u << bits) - 1u;
  unsigned s = hash_slot(id, bits);
  while (atomicCAS(table + s, EMPTY, at) != EMPTY) s = (s + 1u) & mask;
  const unsigned f = filter_bit(id, bits + FILTER_SHIFT);
  atomicOr(filter + (f >> 5), 1u << (f & 31));
}

// false for all but about 1/256 or fewer of the ids not in the row (one
// read)
__device__ __forceinline__ bool in_filter(const unsigned* filter, int fbits,
                                          int id) {
  const unsigned f = filter_bit(id, fbits);
  return (filter[f >> 5] >> (f & 31)) & 1u;
}

// position of id in the staged row, or -1; the table is never full
__device__ __forceinline__ int probe(const int* table, const int* ids,
                                     int bits, int id) {
  const unsigned mask = (1u << bits) - 1u;
  for (unsigned s = hash_slot(id, bits);; s = (s + 1u) & mask) {
    const int at = table[s];
    if (at == EMPTY) return -1;
    if (ids[at] == id) return at;
  }
}

// the staged row's bits in one chunk of a neighbour's row: SCAN_UNROLL ids
// a lane, from e on in steps of 32, before e1; every id is read and its
// filter bit tested before any is probed, so the reads overlap
template <typename Hit>
__device__ __forceinline__ void scan_chunk(
    const int* __restrict__ colidx, long long e, long long e1, int lo_id,
    int hi_id, const unsigned* filter, int bits, const int* table,
    const int* ids, Hit hit) {
  const int fbits = bits + FILTER_SHIFT;
  int y[SCAN_UNROLL];
#pragma unroll
  for (int i = 0; i < SCAN_UNROLL; ++i)
    y[i] = e + 32 * i < e1 ? __ldg(colidx + e + 32 * i) : -1;
  unsigned maybe = 0;
#pragma unroll
  for (int i = 0; i < SCAN_UNROLL; ++i)
    if (y[i] >= lo_id && y[i] <= hi_id && in_filter(filter, fbits, y[i]))
      maybe |= 1u << i;
#pragma unroll
  for (int i = 0; i < SCAN_UNROLL; ++i) {
    if (!((maybe >> i) & 1u)) continue;
    const int j = probe(table, ids, bits, y[i]);
    if (j >= 0) hit(j);
  }
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ int popcnt(unsigned x) { return __popc(x); }
__device__ __forceinline__ int popcnt(unsigned long long x) {
  return __popcll(x);
}
__device__ __forceinline__ int lowest(unsigned x) { return __ffs(x); }
__device__ __forceinline__ int lowest(unsigned long long x) {
  return __ffsll(x);
}

// cliques of D more vertices in `cand` (one row: d <= 64), this lane alone
template <int D, typename Row>
__device__ unsigned long long count_word(Row cand, const Row* A) {
  if constexpr (D == 1) {
    return popcnt(cand);
  } else {
    unsigned long long t = 0;
    for (Row rest = cand; rest; rest &= rest - 1) {
      const Row nxt = cand & A[lowest(rest) - 1];
      if (popcnt(nxt) >= D - 1) t += count_word<D - 1>(nxt, A);
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

// word w of local row r, 0 past the rows or the words
__device__ __forceinline__ unsigned row_word(const unsigned* A, int d, int W,
                                            int r, int w) {
  return r < d && w < W ? A[r * W + w] : 0u;
}

// C += A B^T over 256 bits a step, one bit a value: C[i][j] counts the
// bits that row i of A and row j of B share (a 16 x 8 tile, s32)
__device__ __forceinline__ void mma_and_popc(int (&c)[4], unsigned a0,
                                             unsigned a1, unsigned a2,
                                             unsigned a3, unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// this thread's part of the count of A (d rows of W words); every thread
// of the CTA calls it
template <int K>
__device__ unsigned long long count_local(const unsigned* A, int d, int W) {
  unsigned long long s = 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (K == 3) {
    for (int i = threadIdx.x; i < d * W; i += CTA_THREADS) s += __popc(A[i]);
  } else if constexpr (K == 4) {
    // sum over local edges (r, j) of |A[r] & A[j]|
    if (W < MMA_MIN_WORDS) {
      // G lanes a root, lane q holding word q of A[r]; the group walks
      // A[r]'s bits in step (a broadcast read), four rows read at once
      const int G = group_lanes(W);
      const int q = threadIdx.x & (G - 1);
      const unsigned* col = A + (q < W ? q : W - 1);
      for (int r = threadIdx.x / G; r < d; r += CTA_THREADS / G) {
        const unsigned* Ar = A + r * W;
        const unsigned c = q < W ? Ar[q] : 0u;
        unsigned n = 0;                // < 32 d: fits
        for (int w = 0; w < W; ++w) {
          for (unsigned bits = Ar[w]; bits;) {
            unsigned v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              v[i] = 0u;
              if (bits) {
                v[i] = col[((w << 5) + __ffs(bits) - 1) * W];
                bits &= bits - 1u;
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) n += __popc(c & v[i]);
          }
        }
        s += n;
      }
      return s;
    }
    // wider rows: C = A A^T on the tensor cores, a warp a 16 x 8 tile.  C
    // is symmetric and A has no 2-cycle, so the count is the sum over
    // r < j of (A[r][j] | A[j][r]) C[r][j]: only tiles reaching above the
    // diagonal are multiplied, and those where that mask is empty are
    // skipped
    const int g = lane >> 2, t = lane & 3;
    const int cols = (d + 7) >> 3, tiles = ((d + 15) >> 4) * cols;
    for (int tile = warp; tile < tiles; tile += CTA_WARPS) {
      const int r0 = tile / cols * 16, j0 = tile % cols * 8;
      if (j0 + 8 <= r0) continue;      // below the diagonal
      const int ra = r0 + g, rb = ra + 8, ja = j0 + 2 * t, jb = ja + 1;
      const int sj = (j0 & 31) + 2 * t, sr = (r0 & 31) + g;
      // A[r][j] for (ra | rb) x (ja, jb), and A[j][r] for the same pairs
      const unsigned m0 = row_word(A, d, W, ra, j0 >> 5) >> sj;
      const unsigned m1 = row_word(A, d, W, rb, j0 >> 5) >> sj;
      const unsigned n0 = row_word(A, d, W, ja, r0 >> 5) >> sr;
      const unsigned n1 = row_word(A, d, W, jb, r0 >> 5) >> sr;
      const unsigned e0 = ra < ja && ((m0 | n0) & 1u);
      const unsigned e1 = ra < jb && (((m0 >> 1) | n1) & 1u);
      const unsigned e2 = rb < ja && ((m1 | (n0 >> 8)) & 1u);
      const unsigned e3 = rb < jb && (((m1 >> 1) | (n1 >> 8)) & 1u);
      if (!__any_sync(FULL, (e0 | e1 | e2 | e3) != 0u)) continue;
      int c[4] = {0, 0, 0, 0};
      for (int w = t; w < W + t; w += 8) {   // the same steps in every lane
        mma_and_popc(c, row_word(A, d, W, ra, w), row_word(A, d, W, rb, w),
                     row_word(A, d, W, ra, w + 4),
                     row_word(A, d, W, rb, w + 4),
                     row_word(A, d, W, j0 + g, w),
                     row_word(A, d, W, j0 + g, w + 4));
      }
      s += e0 * c[0] + e1 * c[1] + e2 * c[2] + e3 * c[3];
    }
  } else {
    for (int r = warp; r < d; r += CTA_WARPS) {
      const unsigned cand = lane < W ? A[r * W + lane] : 0u;
      s += count_words<K - 2>(cand, A, W, lane);
    }
  }
  return s;
}

// Row: unsigned for out-degrees <= 32, unsigned long long up to 64
template <int K, typename Row>
__global__ void __launch_bounds__(32 * WARPS_SMALL)
kcl_warp_kernel(const long long* __restrict__ rowptr,
                const int* __restrict__ colidx, const int* __restrict__ verts,
                int nverts, unsigned long long* __restrict__ cnt) {
  constexpr int ROWS = 8 * static_cast<int>(sizeof(Row));   // 32 or 64
  constexpr int HALVES = ROWS / 32;
  constexpr int SLOTS = 1 << hash_bits(ROWS);
  constexpr int FILTER_WORDS = SLOTS << FILTER_SHIFT >> 5;
  __shared__ int ids_s[WARPS_SMALL][ROWS];
  __shared__ Row A_s[WARPS_SMALL][ROWS];
  __shared__ int table_s[WARPS_SMALL][SLOTS];
  __shared__ unsigned filter_s[WARPS_SMALL][FILTER_WORDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* ids = ids_s[warp];
  Row* A = A_s[warp];
  int* table = table_s[warp];
  unsigned* filter = filter_s[warp];
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS_SMALL + warp;
       t < nverts; t += static_cast<long long>(gridDim.x) * WARPS_SMALL) {
    const int u = verts[t];
    const long long b = rowptr[u];
    const int d = static_cast<int>(rowptr[u + 1] - b);
    const int bits = hash_bits(d);
    for (int i = lane; i < SLOTS; i += 32) table[i] = EMPTY;
    for (int i = lane; i < FILTER_WORDS; i += 32) filter[i] = 0u;
    int me[HALVES] = {};
    long long rb[HALVES] = {}, re[HALVES] = {};   // lane r: rows r (, r + 32)
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      if (lane + 32 * h < d) {
        me[h] = __ldg(colidx + b + lane + 32 * h);
        ids[lane + 32 * h] = me[h];
        rb[h] = __ldg(rowptr + me[h]);
        re[h] = __ldg(rowptr + me[h] + 1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
      if (lane + 32 * h < d) insert(table, filter, bits, me[h], lane + 32 * h);
    __syncwarp();
    const int lo_id = ids[0], hi_id = ids[d - 1];
    for (int r = 0; r < d; ++r) {
      const int h = r < 32 ? 0 : HALVES - 1;
      const long long e0 = __shfl_sync(FULL, h ? rb[HALVES - 1] : rb[0], r);
      const long long e1 = __shfl_sync(FULL, h ? re[HALVES - 1] : re[0], r);
      Row row = 0;
      for (long long e = e0 + lane; e < e1; e += 32 * SCAN_UNROLL)
        scan_chunk(colidx, e, e1, lo_id, hi_id, filter, bits, table, ids,
                   [&](int j) { row |= Row(1) << j; });
      Row all = __reduce_or_sync(FULL, static_cast<unsigned>(row));
      if constexpr (HALVES == 2)
        all |= Row(__reduce_or_sync(FULL, static_cast<unsigned>(row >> 32)))
               << 32;
      if (lane == 0) A[r] = all;
    }
    __syncwarp();
    unsigned long long s = 0;          // lane i walks roots i (, i + 32)
    for (int i = lane; i < d; i += 32) s += count_word<K - 2>(A[i], A);
    const unsigned long long total = warp_sum(s);
    if (lane == 0) cnt[u] = total;
    __syncwarp();                      // ids, A and the table are reused
  }
}

template <int K>
__global__ void __launch_bounds__(CTA_THREADS)
kcl_cta_kernel(const long long* __restrict__ rowptr,
               const int* __restrict__ colidx, const int* __restrict__ verts,
               int nverts, unsigned long long* __restrict__ cnt,
               int* __restrict__ counter, int dmax) {
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ int item;
  __shared__ unsigned long long part[CTA_WARPS];
  unsigned* A = smem;
  int* ids = reinterpret_cast<int*>(A + dmax * words(dmax));
  int* table = ids + dmax;
  unsigned* filter =
      reinterpret_cast<unsigned*>(table + (1 << hash_bits(dmax)));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(counter, 1);
    __syncthreads();
    const int t = item;
    if (t >= nverts) break;
    const int u = verts[t];
    const long long b = rowptr[u];
    const int d = static_cast<int>(rowptr[u + 1] - b);
    const int W = words(d), bits = hash_bits(d);
    for (int i = threadIdx.x; i < d; i += CTA_THREADS)
      ids[i] = __ldg(colidx + b + i);
    for (int i = threadIdx.x; i < (1 << bits); i += CTA_THREADS)
      table[i] = EMPTY;
    for (int i = threadIdx.x; i < (1 << bits << FILTER_SHIFT >> 5);
         i += CTA_THREADS)
      filter[i] = 0u;
    for (int i = threadIdx.x; i < d * W; i += CTA_THREADS) A[i] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < d; i += CTA_THREADS)
      insert(table, filter, bits, ids[i], i);
    __syncthreads();
    // a warp a row; the next row's bounds are read while this one streams
    const int lo_id = ids[0], hi_id = ids[d - 1];
    int r = warp;
    long long nb = 0, ne = 0;
    if (r < d) {
      nb = __ldg(rowptr + ids[r]);
      ne = __ldg(rowptr + ids[r] + 1);
    }
    while (r < d) {
      const long long e0 = nb, e1 = ne;
      unsigned* Ar = A + r * W;
      r += CTA_WARPS;
      if (r < d) {
        nb = __ldg(rowptr + ids[r]);
        ne = __ldg(rowptr + ids[r] + 1);
      }
      for (long long e = e0 + lane; e < e1; e += 32 * SCAN_UNROLL)
        scan_chunk(colidx, e, e1, lo_id, hi_id, filter, bits, table, ids,
                   [&](int j) { atomicOr(Ar + (j >> 5), 1u << (j & 31)); });
    }
    __syncthreads();
    const unsigned long long s = count_local<K>(A, d, W);
    const unsigned long long total = warp_sum(s);
    if (lane == 0) part[warp] = total;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long sum = 0;
      for (int i = 0; i < CTA_WARPS; ++i) sum += part[i];
      cnt[u] = sum;
    }
    // the next vertex's staging waits at the barrier after `item`
  }
}

// the CTA shape's registers a thread and CTAs an SM at dmax, for k = K
template <int K>
int cta_info(int dmax, int* regs, int* per_sm) {
  const int shared = static_cast<int>(shared_bytes(dmax));
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(
      kcl_cta_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kcl_cta_kernel<K>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kcl_cta_kernel<K>, CTA_THREADS, shared);
  if (err == cudaSuccess) *regs = attr.numRegs;
  return static_cast<int>(err);
}

template <int K>
int launch(const long long* rowptr, const int* colidx, const int* verts,
           int nverts, unsigned long long* cnt, int* counter, int dmax,
           cudaStream_t stream) {
  if (dmax <= WARP_DEGREE) {
    constexpr long long MAX_BLOCKS = 1ll << 30;
    long long blocks = (nverts + WARPS_SMALL - 1) / WARPS_SMALL;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    if (dmax <= 32)
      kcl_warp_kernel<K, unsigned>
          <<<static_cast<unsigned>(blocks), 32 * WARPS_SMALL, 0, stream>>>(
              rowptr, colidx, verts, nverts, cnt);
    else
      kcl_warp_kernel<K, unsigned long long>
          <<<static_cast<unsigned>(blocks), 32 * WARPS_SMALL, 0, stream>>>(
              rowptr, colidx, verts, nverts, cnt);
    return static_cast<int>(cudaGetLastError());
  }
  const int shared = static_cast<int>(shared_bytes(dmax));
  // above 48 KB a launch is refused unless the kernel is allowed more
  cudaError_t err = cudaFuncSetAttribute(
      kcl_cta_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kcl_cta_kernel<K>, CTA_THREADS, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = nverts < sms * per_sm ? nverts : sms * per_sm;
  kcl_cta_kernel<K><<<blocks, CTA_THREADS, shared, stream>>>(
      rowptr, colidx, verts, nverts, cnt, counter, dmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rowptr int64[m+1], colidx int32 (rows ascending), verts int32[nverts]
// (vertices with k - 1 <= d <= dmax, in descending out-degree for the CTA
// shape's largest-first order; any order is exact), cnt uint64[m] and
// counter int32[1] zeroed by the caller (the CTA shape's work counter),
// on the current device; MIN_K <= k <= MAX_K, 1 <= dmax <= MAX_DEGREE.
// dmax picks the launch shape and the shared memory.  Returns
// cudaGetLastError() after the launch (0 on success); the launch is
// asynchronous on `stream`.
int gdn_kcl_local_count(const void* rowptr, const void* colidx,
                        const void* verts, long long nverts, void* cnt,
                        void* counter, int k, int dmax, void* stream) {
  if (nverts <= 0) return 0;
  if (k < MIN_K || k > MAX_K || dmax < 1 || dmax > MAX_DEGREE ||
      nverts > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const long long*>(rowptr);
  const auto* ci = static_cast<const int*>(colidx);
  const auto* vs = static_cast<const int*>(verts);
  auto* out = static_cast<unsigned long long*>(cnt);
  auto* ctr = static_cast<int*>(counter);
  const int n = static_cast<int>(nverts);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return launch<3>(rp, ci, vs, n, out, ctr, dmax, s);
    case 4: return launch<4>(rp, ci, vs, n, out, ctr, dmax, s);
    case 5: return launch<5>(rp, ci, vs, n, out, ctr, dmax, s);
    case 6: return launch<6>(rp, ci, vs, n, out, ctr, dmax, s);
    case 7: return launch<7>(rp, ci, vs, n, out, ctr, dmax, s);
    default: return launch<8>(rp, ci, vs, n, out, ctr, dmax, s);
  }
}

int gdn_kcl_min_k() { return MIN_K; }
int gdn_kcl_max_k() { return MAX_K; }
int gdn_kcl_warp_degree() { return WARP_DEGREE; }
int gdn_kcl_max_degree() { return MAX_DEGREE; }
int gdn_kcl_cta_threads() { return CTA_THREADS; }
// the host's copies of the design's sizes are held to these
long long gdn_kcl_shared_bytes(int dmax) { return shared_bytes(dmax); }
int gdn_kcl_hash_bits(int d) { return hash_bits(d); }
unsigned gdn_kcl_hash_slot(int id, int bits) { return hash_slot(id, bits); }
unsigned gdn_kcl_filter_bit(int id, int fbits) {
  return filter_bit(id, fbits);
}
int gdn_kcl_filter_shift() { return FILTER_SHIFT; }
int gdn_kcl_group_lanes(int W) { return group_lanes(W); }
// the CTA shape at k = 4 and dmax: registers a thread, CTAs an SM
int gdn_kcl_cta_info(int dmax, int* regs, int* per_sm) {
  return cta_info<4>(dmax, regs, per_sm);
}

}  // extern "C"
