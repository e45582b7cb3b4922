// F1: the sparse relax of SSSP's bucket rounds (solvers/sssp.Relaxer.sparse)
// on Hopper, in three launches.
//
// Replaces no Pallas kernel: the JAX package leaves this round to XLA
// (gardenia_tpu/solvers/sssp.py::sparse, a compaction, the frontier
// expansion, two gathers and a scatter-min), and the port's plain version
// (ops/relax.sparse_relax_plain) takes about forty torch launches a round,
// a torch.cummax over the round's edge slots among them.  For every vertex
// v:
//
//   new[v] = min(dist[v], min over out-edges (u -> v, w) of active u of
//                dist[u] + w)
//
// with dist read as it stood before the round (Jacobi: new is a copy that
// the candidates lower; dist is only read), int32 throughout.  A min of
// integers is the same in any order, so new is the plain version's bit for
// bit.  active bool[m], deg int32[m] (rowptr's differences), rowptr
// int64[m + 1], colidx and w int32[nnz].  No overflow: an active vertex's
// distance is at most 1e9 (the unreached sentinel) and a weight is below
// 2^31 - 1e9.
//
// What bounds it: the round's bytes, the mask (1 B a vertex), deg and the
// copy of dist (12 B a vertex), and 8 B an edge slot (its column id and
// weight); the candidates' reads and atomics on new (4 MB at 2^20
// vertices) stay in the 50 MB L2.  A narrow round is bound by launch
// latency instead.
//
// Design.  (1) tile_totals: each CTA takes a tile of vertices, 16 a thread
// read as one 16-byte load of the mask and four of deg, counts its active
// vertices of non-zero degree and sums their degrees, and copies its part
// of dist into new.  (2) compact: each CTA sums the totals of the tiles
// before its own (at most MAX_TILES of them: the tiles widen with m), then
// scans its tile in steps of THREADS x 16 vertices and writes the active
// vertices' ids and the exclusive prefix of their degrees (offs) in order;
// the last CTA writes the count K and offs[K].  Vertices of degree 0 are
// left out, so every owner holds at least one edge slot.  (3) relax: the
// round's scout edge slots are cut into chunks of CHUNK = THREADS x SLOTS,
// one a CTA, balanced by edges and not by vertices, so a hub's row is
// split across CTAs.  A CTA finds the owners of its first and last slot by
// a THREADS-ary search of offs (each probe a thread, the interval by
// __syncthreads_count: three rounds of loads for 2^20 owners), stages its
// owners' offsets, edge bases and distances in shared memory, and walks
// its slots with neighbouring threads on neighbouring slots, so colidx and
// w are read coalesced (streamed, evict-first, to keep new in L2).  A
// thread finds a slot's owner by a binary search of the staged offsets
// from its previous slot's owner, reads new[v] from L2 and calls atomicMin
// only where the candidate is smaller: most candidates lose.  A stale read
// of new[v] is never below the current value (it only falls), so the skip
// is exact.  Nothing of the plain version's capacity-sized arrays (src,
// dst, valid, eid, the cummax marks) is made.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VPT = 16;                     // vertices a thread a step
constexpr long long TILE = THREADS * VPT;   // vertices a CTA a step
constexpr long long MAX_TILES = 1024;       // CTAs of the scan passes
constexpr int SLOTS = 8;                    // edge slots a thread
constexpr int CHUNK = THREADS * SLOTS;      // edge slots a CTA

// Scratch laid out in one buffer (bytes, 8-aligned parts): offs int64
// [m + 1], tile_edges int64[tiles], ids int32[m], tile_cnt int32[tiles],
// count int32[1].
struct Scratch {
  long long* offs;
  long long* tile_edges;
  int* ids;
  int* tile_cnt;
  int* count;
};

long long scan_steps(long long m) {         // TILE steps a CTA
  const long long tiles = (m + TILE - 1) / TILE;
  return tiles <= MAX_TILES ? 1 : (tiles + MAX_TILES - 1) / MAX_TILES;
}

long long scan_ctas(long long m) {
  const long long span = scan_steps(m) * TILE;
  return (m + span - 1) / span;
}

long long scratch_bytes(long long m) {
  const long long t = scan_ctas(m);
  const long long b = 8 * (m + 1 + t) + 4 * (m + t + 1);
  return (b + 7) / 8 * 8;
}

Scratch carve(void* base, long long m) {
  const long long t = scan_ctas(m);
  char* p = static_cast<char*>(base);
  Scratch s;
  s.offs = reinterpret_cast<long long*>(p);
  s.tile_edges = s.offs + (m + 1);
  s.ids = reinterpret_cast<int*>(s.tile_edges + t);
  s.tile_cnt = s.ids + m;
  s.count = s.tile_cnt + t;
  return s;
}

// The VPT flags and degrees of the thread's vertices v0 .. v0 + VPT - 1
// (zeros past m): one 16-byte load of the mask and four of deg where the
// pointers allow it.
__device__ __forceinline__ void load_vertices(
    const unsigned char* __restrict__ active, const int* __restrict__ deg,
    long long v0, long long m, bool vec, unsigned char (&a)[VPT],
    int (&d)[VPT]) {
  if (vec && v0 + VPT <= m) {
    const uint4 am = __ldg(reinterpret_cast<const uint4*>(active + v0));
    const unsigned words[4] = {am.x, am.y, am.z, am.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 dq = __ldg(reinterpret_cast<const int4*>(deg + v0) + q);
      const int ds[4] = {dq.x, dq.y, dq.z, dq.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[4 * q + r] = (words[q] >> (8 * r)) & 0xff;
        d[4 * q + r] = ds[r];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const bool in = v0 + i < m;
      a[i] = in ? __ldg(active + v0 + i) : 0;
      d[i] = in ? __ldg(deg + v0 + i) : 0;
    }
  }
}

// Block-wide sum of (count, edges); every thread gets it.
__device__ __forceinline__ void block_sum(int& c, long long& e) {
  __shared__ int sc[WARPS];
  __shared__ long long se[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    c += __shfl_down_sync(0xffffffffu, c, o);
    e += __shfl_down_sync(0xffffffffu, e, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sc[warp] = c;
    se[warp] = e;
  }
  __syncthreads();
  c = 0;
  e = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    c += sc[i];
    e += se[i];
  }
  __syncthreads();                // sc, se free for the next call
}

// Block-wide exclusive scan of (count, edges) in thread order; the totals
// of the block come back in tc, te.
__device__ __forceinline__ void block_scan(int& c, long long& e, int& tc,
                                           long long& te) {
  __shared__ int sc[WARPS];
  __shared__ long long se[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int ic = c;
  long long ie = e;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int yc = __shfl_up_sync(0xffffffffu, ic, o);
    const long long ye = __shfl_up_sync(0xffffffffu, ie, o);
    if (lane >= o) {
      ic += yc;
      ie += ye;
    }
  }
  if (lane == 31) {
    sc[warp] = ic;
    se[warp] = ie;
  }
  __syncthreads();
  int wc = 0;
  long long we = 0;
  tc = 0;
  te = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    if (i < warp) {
      wc += sc[i];
      we += se[i];
    }
    tc += sc[i];
    te += se[i];
  }
  c = wc + ic - c;
  e = we + ie - e;
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
tile_totals_kernel(const unsigned char* __restrict__ active,
                   const int* __restrict__ deg,
                   const int* __restrict__ dist, int* __restrict__ newd,
                   long long m, long long steps, bool vec, Scratch s) {
  int c = 0;
  long long e = 0;
  const long long first = static_cast<long long>(blockIdx.x) * steps * TILE;
  for (long long k = 0; k < steps; ++k) {
    const long long v0 = first + k * TILE + threadIdx.x * VPT;
    if (v0 >= m) break;
    unsigned char a[VPT];
    int d[VPT];
    load_vertices(active, deg, v0, m, vec, a, d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const bool own = a[i] && d[i] > 0;
      c += own;
      e += own ? d[i] : 0;
    }
    if (vec && v0 + VPT <= m) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        reinterpret_cast<int4*>(newd + v0)[q] =
            __ldg(reinterpret_cast<const int4*>(dist + v0) + q);
    } else {
      for (long long v = v0; v < v0 + VPT && v < m; ++v)
        newd[v] = __ldg(dist + v);
    }
  }
  block_sum(c, e);
  if (threadIdx.x == 0) {
    s.tile_cnt[blockIdx.x] = c;
    s.tile_edges[blockIdx.x] = e;
  }
}

__global__ void __launch_bounds__(THREADS)
compact_kernel(const unsigned char* __restrict__ active,
               const int* __restrict__ deg, long long m, long long steps,
               bool vec, Scratch s) {
  // the owners and edge slots of the tiles before this one
  int bc = 0;
  long long be = 0;
  for (int i = threadIdx.x; i < static_cast<int>(blockIdx.x); i += THREADS) {
    bc += s.tile_cnt[i];
    be += s.tile_edges[i];
  }
  block_sum(bc, be);
  const long long first = static_cast<long long>(blockIdx.x) * steps * TILE;
  for (long long k = 0; k < steps; ++k) {
    const long long step0 = first + k * TILE;
    if (step0 >= m) break;                   // the same for the whole CTA
    const long long v0 = step0 + threadIdx.x * VPT;
    unsigned char a[VPT];
    int d[VPT];
    load_vertices(active, deg, v0, m, vec, a, d);
    int c = 0;
    long long e = 0;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const bool own = a[i] && d[i] > 0;
      c += own;
      e += own ? d[i] : 0;
    }
    int tc;
    long long te;
    block_scan(c, e, tc, te);
    int pos = bc + c;
    long long off = be + e;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (a[i] && d[i] > 0) {
        s.ids[pos] = static_cast<int>(v0 + i);
        s.offs[pos] = off;
        ++pos;
        off += d[i];
      }
    }
    bc += tc;
    be += te;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    *s.count = bc;
    s.offs[bc] = be;
  }
}

// The last p in [lo, hi) with offs[p] <= target, given offs[lo] <= target
// and offs ascending: each round probes THREADS evenly spaced entries, one
// a thread, and keeps the interval after the last probe at or below the
// target.  Called by the whole CTA; the result is the same in every thread.
__device__ __forceinline__ long long find_owner(
    const long long* __restrict__ offs, long long lo, long long hi,
    long long target) {
  while (hi - lo > 1) {
    const long long step = (hi - lo + THREADS - 1) / THREADS;
    const long long probe = lo + threadIdx.x * step;
    const int le = probe < hi && __ldg(offs + probe) <= target;
    const int n = __syncthreads_count(le);   // the probes at or below: a prefix
    lo += (n - 1) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
relax_kernel(const long long* __restrict__ rowptr,
             const int* __restrict__ colidx, const int* __restrict__ w,
             const int* __restrict__ dist, int* __restrict__ newd,
             long long scout, Scratch s) {
  __shared__ int s_rel[CHUNK];          // owner's first slot - c0, from 0
  __shared__ long long s_base[CHUNK];   // owner's CSR start - its offset
  __shared__ int s_du[CHUNK];           // owner's distance
  const int K = __ldg(s.count);
  const long long total = __ldg(s.offs + K);
  const long long c0 = static_cast<long long>(blockIdx.x) * CHUNK;
  const long long c1 = min(min(c0 + CHUNK, scout), total);
  if (c0 >= c1) return;                 // the same for the whole CTA
  const long long p0 = find_owner(s.offs, 0, K, c0);
  const long long p1 = find_owner(s.offs, p0, min(p0 + CHUNK, (long long)K),
                                  c1 - 1);
  const int P = static_cast<int>(p1 - p0 + 1);   // every owner has a slot
  for (int k = threadIdx.x; k < P; k += THREADS) {
    const long long o = __ldg(s.offs + p0 + k);
    const int u = __ldg(s.ids + p0 + k);
    s_rel[k] = static_cast<int>(max(o - c0, 0LL));
    s_base[k] = __ldg(rowptr + u) - o;
    s_du[k] = __ldg(dist + u);
  }
  __syncthreads();
  int k = 0;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int l = threadIdx.x + i * THREADS;
    if (c0 + l >= c1) break;
    int hi = P;                           // the last k with s_rel[k] <= l
    while (hi - k > 1) {
      const int mid = (k + hi) >> 1;
      if (s_rel[mid] <= l) k = mid; else hi = mid;
    }
    const long long e = s_base[k] + c0 + l;
    const int v = __ldcs(colidx + e);
    const int nd = s_du[k] + __ldcs(w + e);
    if (nd < __ldcg(newd + v)) atomicMin(newd + v, nd);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// new = min(dist, the active vertices' out-edges relaxed), three launches
// on `stream`, asynchronous.  scratch: gdn_frontier_relax_scratch(m) bytes
// on the device.  scout: the active vertices' out-degree sum (the relax's
// grid; slots past the device's own count are not read).  Returns
// cudaGetLastError() after the launches (0 on success).
int gdn_frontier_relax(const void* active, const void* deg,
                       const void* rowptr, const void* colidx, const void* w,
                       const void* dist, void* newd, long long m,
                       long long scout, void* scratch, void* stream) {
  const long long chunks = (scout + CHUNK - 1) / CHUNK;
  if (m <= 0) return 0;
  if (m > 0x7fffffffLL || scout < 0 || chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, m);
  const long long steps = scan_steps(m);
  const unsigned ctas = static_cast<unsigned>(scan_ctas(m));
  const bool vec = aligned16(active) && aligned16(deg) && aligned16(dist) &&
                   aligned16(newd);
  const unsigned char* a = static_cast<const unsigned char*>(active);
  const int* d = static_cast<const int*>(deg);
  tile_totals_kernel<<<ctas, THREADS, 0, st>>>(
      a, d, static_cast<const int*>(dist), static_cast<int*>(newd), m, steps,
      vec, s);
  compact_kernel<<<ctas, THREADS, 0, st>>>(a, d, m, steps, vec, s);
  if (chunks > 0)
    relax_kernel<<<static_cast<unsigned>(chunks), THREADS, 0, st>>>(
        static_cast<const long long*>(rowptr), static_cast<const int*>(colidx),
        static_cast<const int*>(w), static_cast<const int*>(dist),
        static_cast<int*>(newd), scout, s);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch gdn_frontier_relax needs for m vertices.
long long gdn_frontier_relax_scratch(long long m) {
  return m <= 0 ? 0 : scratch_bytes(m);
}

// The relax's threads a CTA and edge slots a thread, which ops/relax's
// host copy of the owner search uses.
int gdn_frontier_relax_threads() { return THREADS; }
int gdn_frontier_relax_slots() { return SLOTS; }

}  // extern "C"
