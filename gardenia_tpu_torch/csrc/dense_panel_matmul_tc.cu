// K1 at the batched shape: the dense panel matmul of the hybrid layout on
// Hopper's tensor cores, for many operand columns (S > 8; S = 128 in
// multi-source BFS and batched Brandes BC).
//
// Replaces gardenia_tpu/ops/pallas_bsr.py::dense_panel_matmul at the shape
// the JAX package launches it at (spmv_hybrid_batched).  For each row slot r
// of one width bucket:
//
//   out[r, i, s] = sum_{w < W, j < 128} panel[r, i, w*128 + j]
//                                       * x3d[src[r, w], j, s]
//
// panel (R, 128, W*128) int8 | bf16, src (R, W) int32 operand block ids,
// x3d (qx, 128, S) bf16 | f32, out (R, 128, S) f32; f32 accumulation in
// mma.sync.m16n8k16 (bf16 x bf16 -> f32).  f32 panels do not come here: they
// stay f32-exact on the CUDA cores (dense_panel_matmul.cu).
//
// Precision is the operand's dtype.  A bf16 operand takes one product per
// tile, summed in the mma's own accumulator (a 0/1 frontier mask is exact).
// An f32 operand is split in shared memory into three bf16 terms, x = hi +
// mid + lo with each residual exact in f32, which carry f32's 24 mantissa
// bits.  Panel cells are small integers, exact in bf16.
//
// Accumulation of the f32 route: a tensor core adds its 16 products to the
// accumulator with truncation, not rounding to nearest, so a running sum
// kept in the mma's own accumulator over a slot's up to 256 tiles x 3 terms
// drifts by up to ~1e-5 relative on the densest rows (measured on the card
// against the f32 plain version at W = 32).  Each tile's three terms
// therefore start from zero and join the running sum by an f32 add on the
// CUDA cores: four adds a thread for each tile.
//
// What bounds it: at S = 128 a slot's operand blocks (32 KB bf16, 64 KB f32
// a block) outweigh its panel block (16 KB int8), and at 0.59% density many
// 32 x 16 panel tiles are zero.  So the design
//  (a) reads each panel byte from device memory once a sweep: one CTA owns a
//      slot and all of up to 128 operand columns, and keeps the 128 x 128
//      output in registers across the slot's W blocks;
//  (b) stages one operand block and one panel block at a time in shared
//      memory, never the whole slot's, by cp.async (no registers, every
//      copy of the block in flight at once); with a bf16 operand in two
//      stages, so that block w + 1 arrives while block w is multiplied;
//      with an f32 operand in one stage (96 KB of terms and the panel block
//      let two CTAs share an SM's 227 KB), the raw f32 rows arriving first
//      and each warp splitting whole rows in place;
//  (c) skips, by a warp vote on the loaded panel words, every 16-row x 16-k
//      tile of a warp's 32 rows that holds no edge, which takes its mma
//      work and, where both are empty, the shared-memory loads away.
//
// Layout of the work: 256 threads, 8 warps as 4 (rows) x 2 (columns); a warp
// owns 32 rows (two m16 tiles) and 64 columns (eight n8 tiles): 64 f32
// accumulators a thread.  A thread reads 16 consecutive k of one panel row
// with one 16-byte load; four such loads give it both m tiles' rows for a
// chunk of 64 k (int8) or 32 k (bf16).  The A fragment of mma wants k = 2t,
// 2t+1, 2t+8, 2t+9 of a 16-k tile in lane t: instead of shuffling bytes
// between lanes, the kernel permutes k.  The tile q of a chunk takes the
// thread's bytes 4q..4q+3, so its logical k index kk maps to the chunk's
//   k = KCH*(kk%8/2) + 4q + 2*(kk/8) + kk%2      (KCH = k per 16 bytes),
// and the B fragment is read from those same operand rows: ldmatrix takes
// one row address a lane, in any order.  A staged operand row is 128 bf16
// columns, 256 bytes; its 16-byte segments are XORed with ((k/KCH)%4)*2 +
// k%2, which spreads the eight rows of every ldmatrix 8 x 8 matrix over all
// 32 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int THREADS = 256;
constexpr int NCOL = 128;                    // operand columns a CTA takes
constexpr int ROW_BYTES = NCOL * 2;          // a staged operand row, bf16
constexpr int TILE_BYTES = LANES * ROW_BYTES;  // one term of one block

struct bf16_tag {};
template <typename T> struct Elem { static constexpr int bytes = sizeof(T); };
template <> struct Elem<bf16_tag> { static constexpr int bytes = 2; };

__device__ __forceinline__ uint32_t word(const int4& v, int i) {
  return static_cast<uint32_t>(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// the raw panel words of tile q that hold a row's low and high k pairs
template <typename P>
__device__ __forceinline__ void tile_words(const int4& a, int q, uint32_t& lo,
                                           uint32_t& hi);
template <>
__device__ __forceinline__ void tile_words<int8_t>(const int4& a, int q,
                                                   uint32_t& lo, uint32_t& hi) {
  lo = word(a, q);          // four int8: two low-k cells, two high-k cells
  hi = 0;
}
template <>
__device__ __forceinline__ void tile_words<bf16_tag>(const int4& a, int q,
                                                     uint32_t& lo,
                                                     uint32_t& hi) {
  lo = word(a, 2 * q);
  hi = word(a, 2 * q + 1);
}

// A-fragment registers (low-k pair, high-k pair) of one row from those words
template <typename P>
__device__ __forceinline__ void to_frag(uint32_t lo, uint32_t hi, uint32_t& f_lo,
                                        uint32_t& f_hi);
template <>
__device__ __forceinline__ void to_frag<int8_t>(uint32_t lo, uint32_t,
                                                uint32_t& f_lo, uint32_t& f_hi) {
  const float b0 = static_cast<float>(static_cast<int8_t>(lo));
  const float b1 = static_cast<float>(static_cast<int8_t>(lo >> 8));
  const float b2 = static_cast<float>(static_cast<int8_t>(lo >> 16));
  const float b3 = static_cast<float>(static_cast<int8_t>(lo >> 24));
  f_lo = pack_bf16(b0, b1);
  f_hi = pack_bf16(b2, b3);
}
template <>
__device__ __forceinline__ void to_frag<bf16_tag>(uint32_t lo, uint32_t hi,
                                                  uint32_t& f_lo,
                                                  uint32_t& f_hi) {
  f_lo = lo;
  f_hi = hi;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int KCH>
__device__ __forceinline__ int swizzle(int k) {
  return (((k / KCH) & 3) << 1) | (k & 1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* gsrc) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gsrc));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory layout of one staged operand block.  bf16 operand: one
// tile.  f32 operand: the raw f32 rows (512 bytes each) arrive first; each
// row is then split in place, its hi and mid terms into the row's own two
// halves and its lo term into a third tile behind the raw ones.
template <typename XT> struct XLayout;
template <> struct XLayout<__nv_bfloat16> {
  static constexpr int terms = 1;
  static constexpr int bytes = TILE_BYTES;
  __device__ static __forceinline__ int row(int k, int) { return k * ROW_BYTES; }
};
template <> struct XLayout<float> {
  static constexpr int terms = 3;
  static constexpr int bytes = 3 * TILE_BYTES;
  __device__ static __forceinline__ int row(int k, int term) {
    return term < 2 ? k * 2 * ROW_BYTES + term * ROW_BYTES
                    : 2 * TILE_BYTES + k * ROW_BYTES;
  }
};

// Copy one f32 operand block (128 rows x ncol columns from xb, row stride
// S) into shared memory as it is, 16 bytes a copy, zero past ncol;
// asynchronously where the 16 bytes are whole and aligned.
template <int KCH>
__device__ __forceinline__ void stage(unsigned char* xs, const float* xb, int S,
                                      int ncol, int, bool vec, int tid) {
  for (int id = tid; id < LANES * 32; id += THREADS) {
    const int k = id >> 5;
    const int c0 = (id & 31) * 4;
    const float* p = xb + static_cast<size_t>(k) * S + c0;
    unsigned char* dst = xs + k * 2 * ROW_BYTES + c0 * 4;
    if (vec && c0 + 4 <= ncol) {
      cp_async16(dst, p);
    } else {
      float4 v;
      v.x = c0 < ncol ? __ldg(p) : 0.f;
      v.y = c0 + 1 < ncol ? __ldg(p + 1) : 0.f;
      v.z = c0 + 2 < ncol ? __ldg(p + 2) : 0.f;
      v.w = c0 + 3 < ncol ? __ldg(p + 3) : 0.f;
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
}

// Split the raw f32 rows into three bf16 terms.  A warp takes whole rows:
// every lane reads its four values, the warp synchronises, and the terms go
// back into the same row (hi, mid) and into the lo tile, swizzled.
template <int KCH>
__device__ __forceinline__ void split_rows(unsigned char* xs, int warp, int lane) {
  for (int k = warp; k < LANES; k += THREADS / 32) {
    unsigned char* row = xs + k * 2 * ROW_BYTES;
    const float4 u = *reinterpret_cast<const float4*>(row + lane * 16);
    float v[4] = {u.x, u.y, u.z, u.w};
    uint2 w[3];
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(v[2], v[3]);
      w[term] = make_uint2(*reinterpret_cast<const uint32_t*>(&p0),
                           *reinterpret_cast<const uint32_t*>(&p1));
      // the residual of a rounding to fewer bits is exact in f32
      v[0] -= __low2float(p0);
      v[1] -= __high2float(p0);
      v[2] -= __low2float(p1);
      v[3] -= __high2float(p1);
    }
    __syncwarp();
    // lane's columns 4 lane .. 4 lane + 3: half of the 16-byte segment lane / 2
    const int off = (((lane >> 1) ^ swizzle<KCH>(k)) << 4) + (lane & 1) * 8;
#pragma unroll
    for (int term = 0; term < 3; ++term)
      *reinterpret_cast<uint2*>(xs + XLayout<float>::row(k, term) + off) = w[term];
  }
}

// the same for a bf16 operand: one term, copied as it is, asynchronously
// where its 16-byte segments are whole and aligned
template <int KCH>
__device__ __forceinline__ void stage(unsigned char* xs, const __nv_bfloat16* xb,
                                      int S, int ncol, int nseg, bool vec,
                                      int tid) {
  const unsigned short* x16 = reinterpret_cast<const unsigned short*>(xb);
  for (int id = tid; id < LANES * nseg; id += THREADS) {
    const int k = id / nseg;
    const int seg = id - k * nseg;
    const int c0 = seg * 8;
    const unsigned short* p = x16 + static_cast<size_t>(k) * S + c0;
    unsigned char* dst = xs + k * ROW_BYTES + ((seg ^ swizzle<KCH>(k)) << 4);
    if (vec && c0 + 8 <= ncol) {
      cp_async16(dst, p);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = c0 + 2 * j < ncol ? __ldg(p + 2 * j) : 0u;
        const uint32_t hi = c0 + 2 * j + 1 < ncol ? __ldg(p + 2 * j + 1) : 0u;
        w[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Copy one 128 x 128 panel block into shared memory, asynchronously: row i
// keeps its 16-byte segments, XORed with 4 on odd rows so that the two rows
// a quarter warp reads lie in different banks.
template <int ASEG>
__device__ __forceinline__ void stage_panel(unsigned char* as, const int4* blk,
                                            int row_chunks, int tid) {
  for (int id = tid; id < LANES * ASEG; id += THREADS) {
    const int i = id / ASEG, sg = id % ASEG;
    cp_async16(as + (i * ASEG + (sg ^ ((i & 1) << 2))) * 16,
               blk + static_cast<size_t>(i) * row_chunks + sg);
  }
}

// P: panel cell type; XT: operand type; NSTAGE: shared-memory stages (2: the
// next block is copied while this one is multiplied)
template <typename P, typename XT, int NSTAGE>
__global__ void __launch_bounds__(THREADS, 2)
panel_matmul_tc_kernel(const int4* __restrict__ panel,
                       const int* __restrict__ src, const XT* __restrict__ x3d,
                       float* __restrict__ out, int W, int S, int vec) {
  constexpr int KCH = 16 / Elem<P>::bytes;   // k per 16-byte load: 16 or 8
  constexpr int CHK = 4 * KCH;               // k per chunk of four lanes
  constexpr int NCHK = LANES / CHK;          // chunks per block: 2 or 4
  constexpr int KT = KCH / 4;                // 16-k tiles per chunk: 4 or 2
  constexpr int ASEG = LANES / KCH;          // 16-byte segments a panel row
  constexpr int TERMS = XLayout<XT>::terms;  // bf16 terms of an operand value
  constexpr int X_BYTES = XLayout<XT>::bytes;
  constexpr int STAGE_BYTES = X_BYTES + LANES * ASEG * 16;
  extern __shared__ __align__(128) unsigned char smem[];

  const int r = blockIdx.x;
  const int s0 = blockIdx.y * NCOL;
  const int ncol = min(NCOL, S - s0);
  // 16-byte segments staged a row: whole pairs of n8 tiles, zero past ncol
  const int nseg = ((ncol + 15) >> 4) << 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mg = warp & 3, ng = warp >> 2;
  // pairs of n8 tiles this warp computes among its columns [64 ng, 64 ng + 64)
  const int npair = max(0, min(4, (ncol - 64 * ng + 15) >> 4));

  // this lane's row of every ldmatrix: matrix lj (0, 1: first n tile of the
  // pair, low and high k; 2, 3: second n tile), row li = logical k % 8
  const int lj = lane >> 3, li = lane & 7;
  const int lk0 = KCH * (li >> 1) + 2 * (lj & 1) + (li & 1);
  const int lnt = 8 * ng + (lj >> 1);
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int row_chunks = W * ASEG;           // 16-byte chunks per panel row
  const int4* slot = panel + static_cast<size_t>(r) * LANES * row_chunks;
  const int* blocks = src + static_cast<size_t>(r) * W;

  // copy block w's operand and panel cells into stage `st`
  auto fetch = [&](int w, int st) {
    unsigned char* base = smem + st * STAGE_BYTES;
    stage_panel<ASEG>(base + X_BYTES, slot + w * ASEG, row_chunks, tid);
    const XT* xb = x3d + static_cast<size_t>(blocks[w]) * LANES * S + s0;
    stage<KCH>(base, xb, S, ncol, nseg, vec != 0, tid);
    cp_async_commit();
  };

  if (NSTAGE == 2) fetch(0, 0);
  for (int w = 0; w < W; ++w) {
    const int st = NSTAGE == 2 ? (w & 1) : 0;
    if (NSTAGE == 2) {
      // stage st ^ 1 was consumed before the barrier that ended block w - 1
      if (w + 1 < W) {
        fetch(w + 1, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      fetch(w, 0);
      cp_async_wait<0>();
    }
    __syncthreads();
    if (TERMS == 3) {
      split_rows<KCH>(smem + st * STAGE_BYTES, warp, lane);
      __syncthreads();
    }
    if (npair > 0) {
      const unsigned char* as = smem + st * STAGE_BYTES + X_BYTES;
      const uint32_t xs_base = smem_base + st * STAGE_BYTES;
#pragma unroll 1
      for (int c = 0; c < NCHK; ++c) {
        int4 a[4];                           // rows g, g+8, g+16, g+24
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 32 * mg + 8 * i + g;
          a[i] = *reinterpret_cast<const int4*>(
              as + (row * ASEG + ((4 * c + t) ^ ((row & 1) << 2))) * 16);
        }
#pragma unroll
        for (int q = 0; q < KT; ++q) {
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) tile_words<P>(a[i], q, lo[i], hi[i]);
          const bool nz0 =
              __any_sync(0xffffffffu, (lo[0] | hi[0] | lo[1] | hi[1]) != 0);
          const bool nz1 =
              __any_sync(0xffffffffu, (lo[2] | hi[2] | lo[3] | hi[3]) != 0);
          if (!nz0 && !nz1) continue;        // no edge in these 32 x 16 cells
          uint32_t fa[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            to_frag<P>(lo[2 * mt], hi[2 * mt], fa[mt][0], fa[mt][2]);
            to_frag<P>(lo[2 * mt + 1], hi[2 * mt + 1], fa[mt][1], fa[mt][3]);
          }
          const int k = c * CHK + 4 * q + lk0;
          uint32_t row_addr[TERMS];
#pragma unroll
          for (int term = 0; term < TERMS; ++term)
            row_addr[term] = xs_base + XLayout<XT>::row(k, term);
          const int sw = swizzle<KCH>(k);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (p < npair) {
              const int seg = ((lnt + 2 * p) ^ sw) << 4;
              if (TERMS == 1) {
                // one term: the products join the running sum in the mma
                uint32_t b[4];
                ldmatrix_x4_trans(b, row_addr[0] + seg);
                if (nz0) {
                  mma_bf16(acc[0][2 * p], fa[0], b[0], b[1]);
                  mma_bf16(acc[0][2 * p + 1], fa[0], b[2], b[3]);
                }
                if (nz1) {
                  mma_bf16(acc[1][2 * p], fa[1], b[0], b[1]);
                  mma_bf16(acc[1][2 * p + 1], fa[1], b[2], b[3]);
                }
              } else {
                // the tile's three terms start from zero and join the
                // running sum by an f32 add: see the note on accumulation
                float tmp[2][2][4];
#pragma unroll
                for (int i = 0; i < 16; ++i) (&tmp[0][0][0])[i] = 0.f;
#pragma unroll
                for (int term = 0; term < TERMS; ++term) {
                  uint32_t b[4];
                  ldmatrix_x4_trans(b, row_addr[term] + seg);
                  if (nz0) {
                    mma_bf16(tmp[0][0], fa[0], b[0], b[1]);
                    mma_bf16(tmp[0][1], fa[0], b[2], b[3]);
                  }
                  if (nz1) {
                    mma_bf16(tmp[1][0], fa[1], b[0], b[1]);
                    mma_bf16(tmp[1][1], fa[1], b[2], b[3]);
                  }
                }
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                  for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                      acc[mt][2 * p + h][e] += tmp[mt][h][e];
              }
            }
          }
        }
      }
    }
    __syncthreads();                         // this stage is consumed
  }

  // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8
  float* o = out + (static_cast<size_t>(r) * LANES + 32 * mg) * S + s0;
  const bool pair_ok = (S & 1) == 0;         // 8-byte stores stay aligned
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 64 * ng + 8 * nt + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = o + static_cast<size_t>(16 * mt + 8 * h + g) * S + col;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pair_ok && col + 1 < ncol) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          if (col < ncol) p[0] = v0;
          if (col + 1 < ncol) p[1] = v1;
        }
      }
    }
}

template <typename P, typename XT, int NSTAGE>
cudaError_t launch(const void* panel, const int* src, const void* x3d,
                   float* out, long long R, int W, int S, cudaStream_t stream) {
  auto kernel = panel_matmul_tc_kernel<P, XT, NSTAGE>;
  constexpr int smem =
      NSTAGE * (XLayout<XT>::bytes + LANES * LANES * Elem<P>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // 16-byte operand loads need every row's first column aligned
  const int per16 = 16 / static_cast<int>(sizeof(XT));
  const int vec = S % per16 == 0 &&
                  reinterpret_cast<uintptr_t>(x3d) % 16 == 0;
  dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>((S + NCOL - 1) / NCOL));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const int4*>(panel), src, static_cast<const XT*>(x3d), out, W,
      S, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// panel_dtype: 0 int8, 1 bfloat16.  x_dtype: 1 bfloat16 (one term), 2
// float32 (three bf16 terms).  Returns the CUDA error of the launch (0 on
// success); the launch is asynchronous on `stream`.
int gdn_dense_panel_matmul_tc(const void* panel, int panel_dtype,
                              const void* src, const void* x3d, int x_dtype,
                              void* out, long long R, int W, int S,
                              void* stream) {
  if (R <= 0) return 0;
  const int* s = static_cast<const int*>(src);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (panel_dtype == 0 && x_dtype == 1)
    err = launch<int8_t, __nv_bfloat16, 2>(panel, s, x3d, y, R, W, S, st);
  else if (panel_dtype == 0 && x_dtype == 2)
    err = launch<int8_t, float, 1>(panel, s, x3d, y, R, W, S, st);
  else if (panel_dtype == 1 && x_dtype == 1)
    err = launch<bf16_tag, __nv_bfloat16, 2>(panel, s, x3d, y, R, W, S, st);
  else if (panel_dtype == 1 && x_dtype == 2)
    err = launch<bf16_tag, float, 1>(panel, s, x3d, y, R, W, S, st);
  return static_cast<int>(err);
}

}  // extern "C"
