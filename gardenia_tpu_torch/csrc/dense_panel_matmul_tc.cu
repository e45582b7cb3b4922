// K1 at the batched shape: the dense panel matmul of the hybrid layout on
// Hopper's tensor cores, for many operand columns (S > 8; S = 128 in
// multi-source BFS and batched Brandes BC), by wgmma on TMA-staged tiles.
//
// Replaces gardenia_tpu/ops/pallas_bsr.py::dense_panel_matmul at the shape
// the JAX package launches it at (spmv_hybrid_batched).  For each row slot r
// of one width bucket:
//
//   out[r, i, s] = sum_{w < W, j < 128} panel[r, i, w*128 + j]
//                                       * xt[src[r, w], j, s]
//
// panel (R, 128, W*128) int8 | bf16, src (R, W) int32 operand block ids, xt
// (TERMS, qx, 128, Sp) bf16 operand terms, out (R, 128, Sp) f32.  Sp is a
// multiple of 8 (TMA's 16-byte row stride); the wrapper pads S up to it.
// f32 panels do not come here: they stay f32-exact on the CUDA cores
// (dense_panel_matmul.cu).
//
// Precision is the operand's dtype.  A bf16 operand is one term, summed
// over the whole slot in wgmma's own accumulator (a 0/1 frontier mask is
// exact).  An f32 operand arrives as three bf16 terms x = hi + mid + lo,
// written once an apply by gdn_split_bf16x3 below, which carry f32's 24
// mantissa bits.  Panel cells are small integers, exact in bf16.  The
// tensor core truncates when it adds into its accumulator, so on the f32
// route the sum over a slot's blocks is promoted: each block's 8 k16 steps
// x 3 terms (at most 24 chained wgmma adds) start from zero and then join an
// f32 running sum in registers by one add a value.
//
// What bounds it: at S = 128 a slot's operand blocks (32 KB a term a block)
// outweigh its panel block (16 KB int8), and the products the data needs are
// a few percent of a dense product; the earlier mma.sync version of this
// kernel was held by instruction issue, not by bytes or tensor work.  So
// the design
//  (a) reads each panel byte from device memory once a sweep: one CTA owns a
//      slot and up to 128 operand columns, and keeps the 128 x 128 output
//      in registers across the slot's W blocks;
//  (b) moves every tile by TMA (cp.async.bulk.tensor, 128-byte swizzle):
//      one producer warp (registers lowered by setmaxnreg) keeps a ring of
//      stages full, each stage one block's panel tile and operand tile(s)
//      under a full/empty mbarrier pair, so no consumer instruction moves a
//      staged byte;
//  (c) multiplies with wgmma.mma_async m64n128k16 (bf16 x bf16 -> f32): two
//      consumer warpgroups of 64 rows each (registers raised by setmaxnreg),
//      A from registers, B the staged operand tile read by descriptor as it
//      lies (k rows, columns contiguous: MN-major, transpose bit set).  Each
//      consumer thread converts its own A fragment cells from int8 to bf16
//      once, and one A fragment serves the f32 route's three terms;
//  (d) multiplies every k16 step: 83% of the 64 x 16 steps hold an edge at
//      R-MAT-20, and a skip of the others (a vote across the warpgroup's
//      four warps through shared memory and a named barrier, each wgmma
//      under a guard predicate) made an R-MAT-20 sweep at S = 128 slower on
//      an H100: 7.55 against 6.20 ms (f32 operand, split included) and 3.33
//      against 2.94 (bf16).

#include <cuda.h>            // CUtensorMap and its enums (no -lcuda: the
#include <cuda_bf16.h>       // encoder is reached by cudaGetDriverEntryPoint)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int NCOL = 128;                     // operand columns a CTA takes
constexpr int CONSUMERS = 256;                // two warpgroups
constexpr int THREADS = CONSUMERS + 128;      // + the producer warpgroup
constexpr int X_TILE = LANES * NCOL * 2;      // one term of one block, bf16
constexpr int X_HALF = X_TILE / 2;            // a 64-column TMA box
constexpr int BOX_BYTES = LANES * 128;        // a 128-row, 128-byte box
constexpr int SMEM_LIMIT = 232448;            // a block's dynamic maximum
constexpr int SMEM_STATIC = 256;              // the mbarriers
// 128 x 56 + 256 x 224 registers = the 384 x 168 of the launch
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;

template <typename P, int TERMS> struct Cfg {
  static constexpr int p_tile = LANES * LANES * static_cast<int>(sizeof(P));
  static constexpr int stage = TERMS * X_TILE + p_tile;
  static constexpr int fit = (SMEM_LIMIT - SMEM_STATIC - 1024) / stage;
  static constexpr int stages = fit < 4 ? fit : 4;
  static constexpr int smem = stages * stage + 1024;   // + 1 KB to align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that never
// ends (a parity slip) traps after ~2^22 tries, so that it fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Descriptor of a 16-row x 128-column bf16 B tile that starts at `addr`
// (1024-byte aligned rows of 128 bytes: TMA's 128-byte swizzle), MN-major:
// the 64-column halves lie X_HALF apart (leading byte offset), the groups
// of 8 k rows 1024 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(X_HALF >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 f32, this warpgroup's) += a (64 x 16 bf16, registers) x B;
// scale_d = 0 starts the sum from zero
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// keeps the compiler from reusing (or moving) registers that an
// asynchronous wgmma still reads or writes
__device__ __forceinline__ void hold(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void hold(uint32_t& v) {
  asm volatile("" : "+r"(v)::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// panel cells (row, k) and (row, k + 1) of a staged panel tile as a bf16
// pair, k even.  The tile is TMA's 128-byte swizzle of 128-byte rows: the
// 16-byte chunk c of row i lies at chunk c ^ (i % 8).
template <typename P>
__device__ __forceinline__ uint32_t cell_pair(const unsigned char* tile, int row,
                                              int k);
template <>
__device__ __forceinline__ uint32_t cell_pair<int8_t>(const unsigned char* tile,
                                                      int row, int k) {
  const uint32_t v = *reinterpret_cast<const uint16_t*>(
      tile + row * 128 + (((k >> 4) ^ (row & 7)) << 4) + (k & 15));
  return pack_bf16(static_cast<float>(static_cast<int8_t>(v)),
                   static_cast<float>(static_cast<int8_t>(v >> 8)));
}
template <>
__device__ __forceinline__ uint32_t cell_pair<__nv_bfloat16>(
    const unsigned char* tile, int row, int k) {
  const int byte = (k & 63) * 2;              // two 64-cell boxes a row
  return *reinterpret_cast<const uint32_t*>(
      tile + (k >> 6) * BOX_BYTES + row * 128 + (((byte >> 4) ^ (row & 7)) << 4) +
      (byte & 15));
}

// P: panel cell type; TERMS: bf16 terms of an operand value (1 or 3)
template <typename P, int TERMS>
__global__ void __launch_bounds__(THREADS, 1)
panel_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap pmap,
                          const __grid_constant__ CUtensorMap xmap,
                          const int* __restrict__ src, float* __restrict__ out,
                          int W, int Sp, int term_rows) {
  using C = Cfg<P, TERMS>;
  constexpr int NST = C::stages;
  constexpr int X_BYTES = TERMS * X_TILE;
  constexpr int P_BOXES = C::p_tile / BOX_BYTES;   // 1 int8, 2 bf16
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int r = blockIdx.x;
  const int s0 = blockIdx.y * NCOL;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], 1);                   // the producer's expect_tx
      mbar_init(&empty[st], CONSUMERS / 32);     // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- producer warpgroup: one thread issues every copy ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      const int* blocks = src + static_cast<size_t>(r) * W;
      for (int w = 0; w < W; ++w) {
        const int st = w % NST;
        mbar_wait(&empty[st], ((w / NST) & 1) ^ 1);
        unsigned char* base = smem + st * C::stage;
        mbar_expect_tx(&full[st], C::stage);
        const int b = __ldg(blocks + w);
#pragma unroll 1
        for (int t = 0; t < TERMS; ++t)
          for (int h = 0; h < 2; ++h)
            tma_load(base + t * X_TILE + h * X_HALF, &xmap, &full[st],
                     s0 + 64 * h, t * term_rows + b * LANES);
        for (int h = 0; h < P_BOXES; ++h)
          tma_load(base + X_BYTES + h * BOX_BYTES, &pmap, &full[st],
                   w * LANES + h * (LANES / P_BOXES), r * LANES);
      }
    }
  } else {
    // ---- two consumer warpgroups: rows [64 wg, 64 wg + 64) ---------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row = 64 * wg + 16 * wq + g;       // and row + 8
    // acc: the wgmma sums; tot: the f32 route's running sum of them
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;

    for (int w = 0; w < W; ++w) {
      const int st = w % NST;
      mbar_wait(&full[st], (w / NST) & 1);
      const unsigned char* base = smem + st * C::stage;
      const unsigned char* ptile = base + X_BYTES;
      // this thread's A fragments of the block's 8 k16 steps: rows row,
      // row + 8 at k = 2t, 2t + 1 and 2t + 8, 2t + 9 of each step
      uint32_t a[8][4];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        a[s][0] = cell_pair<P>(ptile, row, 16 * s + 2 * t);
        a[s][1] = cell_pair<P>(ptile, row + 8, 16 * s + 2 * t);
        a[s][2] = cell_pair<P>(ptile, row, 16 * s + 8 + 2 * t);
        a[s][3] = cell_pair<P>(ptile, row + 8, 16 * s + 8 + 2 * t);
      }
      const uint32_t xs = smem_u32(base);
#pragma unroll
      for (int i = 0; i < 64; ++i) hold(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // the f32 route starts each block's sum from zero
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int term = 0; term < TERMS; ++term)
          wgmma_rs(acc, a[s], b_desc(xs + term * X_TILE + s * 16 * 128),
                   TERMS == 1 || s + term > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) hold(acc[i]);
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) hold(a[s][e]);
      if (lane == 0) mbar_arrive(&empty[st]);    // this stage is consumed
      if (TERMS == 3) {
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] += acc[i];
      }
    }

    // d[4j + e]: row (e < 2 ? row : row + 8), column 8j + 2t + (e & 1)
    const int ncol = min(NCOL, Sp - s0);
    float* o = out + (static_cast<size_t>(r) * LANES + row) * Sp + s0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < ncol) {
        const float* d = TERMS == 3 ? tot : acc;
        *reinterpret_cast<float2*>(o + col) = make_float2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<float2*>(o + 8 * static_cast<size_t>(Sp) + col) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
    }
  }
}

// x (rows, S) f32 -> xt (3, rows, Sp) bf16: hi, mid, lo with x = hi + mid +
// lo exactly (each residual of a rounding to fewer bits is exact in f32);
// columns S..Sp-1 zero.  A thread takes four columns of one row.
__global__ void split_bf16x3_kernel(const float* __restrict__ x,
                                    uint2* __restrict__ xt, long long rows,
                                    int S, int Sp) {
  const int quads = Sp >> 2;
  const long long n = rows * quads;
  const long long plane = rows * quads;         // uint2 a term plane
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / quads;
    const int c = static_cast<int>(i - row * quads) * 4;
    const float* p = x + row * S + c;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = c + e < S ? __ldg(p + e) : 0.f;
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(v[2], v[3]);
      xt[term * plane + i] = make_uint2(*reinterpret_cast<const uint32_t*>(&p0),
                                        *reinterpret_cast<const uint32_t*>(&p1));
      v[0] -= __low2float(p0);
      v[1] -= __high2float(p0);
      v[2] -= __low2float(p1);
      v[3] -= __high2float(p1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a 2-D row-major map (cols contiguous) with 128-row boxes of 128 bytes,
// 128-byte swizzle; zero fill past the columns
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int esize,
               const void* base, uint64_t cols, uint64_t rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esize), LANES};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename P, int TERMS>
cudaError_t launch(const void* panel, const int* src, const void* xt, float* out,
                   long long R, int W, int Sp, long long term_rows,
                   cudaStream_t stream) {
  auto kernel = panel_matmul_wgmma_kernel<P, TERMS>;
  constexpr int smem = Cfg<P, TERMS>::smem;
  CUtensorMap pmap, xmap;
  const int pes = static_cast<int>(sizeof(P));
  if (!encode_2d(&pmap,
                 pes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 pes, panel, static_cast<uint64_t>(W) * LANES,
                 static_cast<uint64_t>(R) * LANES) ||
      !encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xt,
                 static_cast<uint64_t>(Sp),
                 static_cast<uint64_t>(TERMS) * term_rows))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>((Sp + NCOL - 1) / NCOL));
  kernel<<<grid, THREADS, smem, stream>>>(pmap, xmap, src, out, W, Sp,
                                          static_cast<int>(term_rows));
  return cudaGetLastError();
}

template <typename P, int TERMS>
cudaError_t info(int* regs, int* local_bytes, int* smem, int* stages, int* ctas) {
  auto kernel = panel_matmul_wgmma_kernel<P, TERMS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<P, TERMS>::smem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, THREADS,
                                                        Cfg<P, TERMS>::smem);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem = Cfg<P, TERMS>::smem + static_cast<int>(a.sharedSizeBytes);
  *stages = Cfg<P, TERMS>::stages;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// panel_dtype: 0 int8, 1 bfloat16.  terms: 1 (a bf16 operand) or 3 (an f32
// operand split by gdn_split_bf16x3).  xt: (terms, term_rows, Sp) bf16 with
// term_rows = qx * 128, Sp a multiple of 8, 16-byte aligned; out (R, 128,
// Sp) f32.  Returns the CUDA error of the launch (0 on success); the launch
// is asynchronous on `stream`.
int gdn_dense_panel_matmul_tc(const void* panel, int panel_dtype,
                              const void* src, const void* xt, int terms,
                              void* out, long long R, int W, int Sp,
                              long long term_rows, void* stream) {
  if (R <= 0) return 0;
  if (Sp % 8 != 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* s = static_cast<const int*>(src);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (panel_dtype == 0 && terms == 1)
    err = launch<int8_t, 1>(panel, s, xt, y, R, W, Sp, term_rows, st);
  else if (panel_dtype == 0 && terms == 3)
    err = launch<int8_t, 3>(panel, s, xt, y, R, W, Sp, term_rows, st);
  else if (panel_dtype == 1 && terms == 1)
    err = launch<__nv_bfloat16, 1>(panel, s, xt, y, R, W, Sp, term_rows, st);
  else if (panel_dtype == 1 && terms == 3)
    err = launch<__nv_bfloat16, 3>(panel, s, xt, y, R, W, Sp, term_rows, st);
  return static_cast<int>(err);
}

// x (rows, S) f32 -> xt (3, rows, Sp) bf16 terms, zero past S; Sp % 8 == 0
int gdn_split_bf16x3(const void* x, void* xt, long long rows, int S, int Sp,
                     void* stream) {
  if (rows <= 0) return 0;
  if (Sp % 8 != 0 || S > Sp) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * (Sp / 4);
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  split_bf16x3_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint2*>(xt), rows, S, Sp);
  return static_cast<int>(cudaGetLastError());
}

// Resources of the wgmma kernel for (panel_dtype, terms): registers a
// thread at launch (setmaxnreg moves them between the warpgroups), local
// memory a thread (spills), shared memory a CTA, stages, CTAs an SM.
int gdn_dense_panel_matmul_tc_info(int panel_dtype, int terms, int* regs,
                                   int* local_bytes, int* smem, int* stages,
                                   int* ctas) {
  cudaError_t err = cudaErrorInvalidValue;
  if (panel_dtype == 0 && terms == 1)
    err = info<int8_t, 1>(regs, local_bytes, smem, stages, ctas);
  else if (panel_dtype == 0 && terms == 3)
    err = info<int8_t, 3>(regs, local_bytes, smem, stages, ctas);
  else if (panel_dtype == 1 && terms == 1)
    err = info<__nv_bfloat16, 1>(regs, local_bytes, smem, stages, ctas);
  else if (panel_dtype == 1 && terms == 3)
    err = info<__nv_bfloat16, 3>(regs, local_bytes, smem, stages, ctas);
  return static_cast<int>(err);
}

}  // extern "C"
