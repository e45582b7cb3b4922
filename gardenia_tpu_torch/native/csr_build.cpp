// Native CSR construction fast path.
//
// TPU-native counterpart of the reference's graph-build hot loop
// (include/csr_graph.h:104-168 fill_data: self-loop removal,
// symmetrization, per-row sort, dedup, prefix-sum rowptr; also
// tools/converter.cc:61-101).  Edges are packed into 64-bit (src,dst)
// keys, sorted once with a 3-pass radix sort (parallelizable, stable),
// deduplicated in the same sweep that counts per-row degrees, and the
// rowptr is a single prefix sum.  Weights ride along through the sort
// permutation.  Arrays are returned malloc'd; Python adopts them
// zero-copy via ctypes (gt_free releases).
//
// Build: g++ -O3 -shared -fPIC csr_build.cpp -o libgtbuild.so

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>

namespace {

// stable LSD radix sort of 64-bit keys (optionally carrying a payload
// index for weight permutation), 16 bits per pass over the used bits;
// returns false on allocation failure (caller aborts -> Python fallback)
bool radix_sort(uint64_t* keys, int64_t* idx, int64_t n, int key_bits) {
  const int RAD = 16;
  const int64_t BUCKETS = 1 << RAD;
  uint64_t* tmp_k = static_cast<uint64_t*>(std::malloc(n * 8));
  int64_t* tmp_i = idx ? static_cast<int64_t*>(std::malloc(n * 8))
                       : nullptr;
  int64_t* count = static_cast<int64_t*>(std::malloc(BUCKETS * 8));
  if (!tmp_k || (idx && !tmp_i) || !count) {
    std::free(tmp_k);
    std::free(tmp_i);
    std::free(count);
    return false;
  }
  int passes = (key_bits + RAD - 1) / RAD;
  // ping-pong between the caller's buffers and the temporaries; copy
  // back only if an odd number of passes ran
  uint64_t *ka = keys, *kb = tmp_k;
  int64_t *ia = idx, *ib = tmp_i;
  for (int p = 0; p < passes; ++p) {
    int shift = p * RAD;
    std::memset(count, 0, BUCKETS * 8);
    for (int64_t i = 0; i < n; ++i)
      ++count[(ka[i] >> shift) & (BUCKETS - 1)];
    int64_t sum = 0;
    for (int64_t b = 0; b < BUCKETS; ++b) {
      int64_t c = count[b];
      count[b] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      int64_t pos = count[(ka[i] >> shift) & (BUCKETS - 1)]++;
      kb[pos] = ka[i];
      if (idx) ib[pos] = ia[i];
    }
    std::swap(ka, kb);
    std::swap(ia, ib);
  }
  if (ka != keys) {
    std::memcpy(keys, ka, n * 8);
    if (idx) std::memcpy(idx, ia, n * 8);
  }
  std::free(tmp_k);
  std::free(tmp_i);
  std::free(count);
  return true;
}

int key_bits_for(int64_t m) {
  int bits = 1;
  while ((int64_t(1) << bits) < m) ++bits;
  return bits;
}

}  // namespace

extern "C" {

// Build a clean CSR from a COO edge list.
//  m: vertex count; nnz: input edge count
//  src/dst: int32[nnz] (0-indexed); wt: double[nnz] or null
//  flags: 1 = remove self loops, 2 = dedup, 4 = symmetrize
// Outputs (malloc'd, caller frees via gt_free):
//  rowptr int64[m+1], colidx int32[out_nnz], wt_out double[out_nnz]|null
// Returns 0 on success.
int gt_build_csr(int64_t m, int64_t nnz, const int32_t* src,
                 const int32_t* dst, const double* wt, int flags,
                 int64_t* out_nnz, int64_t** rowptr_out,
                 int32_t** colidx_out, double** wt_out) {
  const bool drop_loops = flags & 1;
  const bool dedup = flags & 2;
  const bool sym = flags & 4;
  int64_t cap = sym ? nnz * 2 : nnz;
  uint64_t* keys = static_cast<uint64_t*>(std::malloc(cap * 8));
  int64_t* perm = wt ? static_cast<int64_t*>(std::malloc(cap * 8))
                     : nullptr;
  if (!keys || (wt && !perm)) {
    std::free(keys);
    std::free(perm);
    return 1;
  }
  int bits = key_bits_for(m);
  int64_t n = 0;
  // originals first, reversed copies after — dedup (stable sort, keep
  // first) must prefer the original edge's weight over a reversed
  // duplicate, matching core/build.clean_edges (csr_graph.h:104-117)
  for (int64_t e = 0; e < nnz; ++e) {
    int64_t s = src[e], d = dst[e];
    if (s < 0 || s >= m || d < 0 || d >= m) continue;
    if (drop_loops && s == d) continue;
    keys[n] = (uint64_t(s) << bits) | uint64_t(d);
    if (perm) perm[n] = e;
    ++n;
  }
  if (sym) {
    for (int64_t e = 0; e < nnz; ++e) {
      int64_t s = src[e], d = dst[e];
      if (s < 0 || s >= m || d < 0 || d >= m) continue;
      if (s == d) continue;  // never duplicate a kept self loop
      keys[n] = (uint64_t(d) << bits) | uint64_t(s);
      if (perm) perm[n] = e;
      ++n;
    }
  }
  if (!radix_sort(keys, perm, n, 2 * bits)) {
    std::free(keys);
    std::free(perm);
    return 1;
  }

  int64_t* rowptr = static_cast<int64_t*>(std::malloc((m + 1) * 8));
  int32_t* colidx = static_cast<int32_t*>(std::malloc(
      (n ? n : 1) * 4));
  double* wout = wt ? static_cast<double*>(std::malloc(
                          (n ? n : 1) * 8))
                    : nullptr;
  if (!rowptr || !colidx || (wt && !wout)) {
    std::free(keys);
    std::free(perm);
    std::free(rowptr);
    std::free(colidx);
    std::free(wout);
    return 1;
  }
  std::memset(rowptr, 0, (m + 1) * 8);
  uint64_t dmask = (uint64_t(1) << bits) - 1;
  int64_t out = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (dedup && i > 0 && keys[i] == keys[i - 1]) {
      // symmetrize combines duplicate weights with min so the weight
      // matrix stays symmetric (core/build.clean_edges semantics)
      if (wout && sym) {
        double w = wt[perm[i]];
        if (w < wout[out - 1]) wout[out - 1] = w;
      }
      continue;
    }
    int64_t s = int64_t(keys[i] >> bits);
    colidx[out] = static_cast<int32_t>(keys[i] & dmask);
    if (wout) wout[out] = wt[perm[i]];
    ++rowptr[s + 1];
    ++out;
  }
  for (int64_t v = 0; v < m; ++v) rowptr[v + 1] += rowptr[v];
  std::free(keys);
  std::free(perm);
  *out_nnz = out;
  *rowptr_out = rowptr;
  *colidx_out = colidx;
  *wt_out = wout;
  return 0;
}

void gt_free(void* p) { std::free(p); }

}  // extern "C"
