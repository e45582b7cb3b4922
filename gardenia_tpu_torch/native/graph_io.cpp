// Native graph-text parsing fast path.
//
// TPU-native counterpart of the reference's offline converter hot loop
// (reference tools/converter.cc:61-101 CountDegrees/PrefixSum and the
// istringstream parsers in include/graph_io.h) — but as a single-pass
// byte scanner instead of per-line stream extraction: the whole file is
// read once, integers are parsed with a hand-rolled loop, and edges land
// directly in flat int32 arrays that numpy adopts zero-copy via ctypes.
//
// Formats (same surface as gardenia_tpu_torch/core/io.py):
//   0 = .mtx  MatrixMarket coordinate, '%' comments, 1-indexed
//   1 = .el   "m nnz" header then "src dst [wt]"
//   2 = .gr   DIMACS-9: 'c' comments, "p sp m nnz", "a src dst [wt]"
//   3 = .graph Metis adjacency (line i = neighbors of vertex i)
//
// Build: g++ -O3 -march=native -shared -fPIC graph_io.cpp -o libgtio.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

struct Scanner {
  const char* p;
  const char* end;

  bool skip_ws() {                       // returns false at EOF
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' ||
                       *p == '\n'))
      ++p;
    return p < end;
  }
  void skip_line() {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  bool at_line_start_comment(char c) {
    return p < end && *p == c;
  }
  // parse signed decimal (weights may carry a sign or decimal point;
  // fractional digits are folded into a double)
  bool next_double(double* out) {
    if (!skip_ws()) return false;
    bool neg = false;
    if (*p == '+' || *p == '-') { neg = *p == '-'; ++p; }
    double v = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10 + (*p - '0');
      ++p;
      any = true;
    }
    if (p < end && *p == '.') {
      ++p;
      double scale = 0.1;
      while (p < end && *p >= '0' && *p <= '9') {
        v += (*p - '0') * scale;
        scale *= 0.1;
        ++p;
        any = true;
      }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {   // scientific notation
      ++p;
      bool eneg = false;
      if (p < end && (*p == '+' || *p == '-')) { eneg = *p == '-'; ++p; }
      int ev = 0;
      while (p < end && *p >= '0' && *p <= '9') {
        ev = ev * 10 + (*p - '0');
        ++p;
      }
      double mul = 1;
      for (int i = 0; i < ev; ++i) mul *= 10;
      v = eneg ? v / mul : v * mul;
    }
    if (!any) return false;
    *out = neg ? -v : v;
    return true;
  }
  bool next_i64(int64_t* out) {
    double d;
    if (!next_double(&d)) return false;
    *out = static_cast<int64_t>(d);
    return true;
  }
  int fields_on_line() {                 // count numbers until newline
    const char* save = p;
    int n = 0;
    while (p < end && *p != '\n') {
      double d;
      const char* before = p;
      // inline bounded skip of spaces (not newline)
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      if (p >= end || *p == '\n') break;
      if (!next_double(&d)) { p = before; break; }
      ++n;
    }
    p = save;
    return n;
  }
};

char* read_file(const char* path, size_t* len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(sz + 1));
  if (buf && std::fread(buf, 1, sz, f) != static_cast<size_t>(sz)) {
    std::free(buf);
    buf = nullptr;
  }
  std::fclose(f);
  if (buf) {
    buf[sz] = '\0';
    *len = sz;
  }
  return buf;
}

}  // namespace

extern "C" {

// Parse result ownership passes to the caller (free with gt_free).
// Returns 0 on success. wt_out is null when the file has no values.
int gt_parse_edges(const char* path, int fmt,
                   int64_t* m_out, int64_t* n_out, int64_t* nnz_out,
                   int32_t** src_out, int32_t** dst_out,
                   double** wt_out) {
  size_t len = 0;
  char* buf = read_file(path, &len);
  if (!buf) return 1;
  Scanner s{buf, buf + len};
  int64_t m = 0, n = 0, nnz = 0;
  *wt_out = nullptr;

  if (fmt == 0) {                                   // mtx
    while (s.skip_ws() && s.at_line_start_comment('%')) s.skip_line();
    if (!s.next_i64(&m) || !s.next_i64(&n) || !s.next_i64(&nnz)) {
      std::free(buf);
      return 2;
    }
  } else if (fmt == 1 || fmt == 3) {                // el / graph
    if (!s.next_i64(&m) || !s.next_i64(&nnz)) {
      std::free(buf);
      return 2;
    }
    n = m;
    s.skip_line();
  } else if (fmt == 2) {                            // gr
    for (;;) {
      if (!s.skip_ws()) { std::free(buf); return 2; }
      if (*s.p == 'c') { s.skip_line(); continue; }
      if (*s.p == 'p') {
        ++s.p;
        // skip the problem tag token ("sp")
        while (s.p < s.end && *s.p == ' ') ++s.p;
        while (s.p < s.end && *s.p != ' ' && *s.p != '\n') ++s.p;
        if (!s.next_i64(&m) || !s.next_i64(&nnz)) {
          std::free(buf);
          return 2;
        }
        n = m;
        s.skip_line();
        break;
      }
      s.skip_line();
    }
  } else {
    std::free(buf);
    return 3;
  }

  // Metis .graph headers count undirected edges; lines carry both
  // directions, so reserve 2x (reference graph2csr reads every token)
  int64_t cap = (fmt == 3) ? nnz * 2 + 16 : nnz;
  int32_t* src = static_cast<int32_t*>(std::malloc(cap * 4));
  int32_t* dst = static_cast<int32_t*>(std::malloc(cap * 4));
  double* wt = nullptr;
  if (!src || !dst) {
    std::free(buf);
    std::free(src);
    std::free(dst);
    return 4;
  }
  int64_t count = 0;

  if (fmt == 3) {                                   // metis adjacency
    for (int64_t v = 0; v < m && s.p < s.end; ++v) {
      while (s.p < s.end && *s.p != '\n') {
        while (s.p < s.end &&
               (*s.p == ' ' || *s.p == '\t' || *s.p == '\r'))
          ++s.p;
        if (s.p >= s.end || *s.p == '\n') break;
        int64_t d = 0;
        bool any = false;
        while (s.p < s.end && *s.p >= '0' && *s.p <= '9') {
          d = d * 10 + (*s.p - '0');
          ++s.p;
          any = true;
        }
        if (!any) { ++s.p; continue; }
        if (count < cap) {
          src[count] = static_cast<int32_t>(v);
          dst[count] = static_cast<int32_t>(d - 1);
          ++count;
        }
      }
      if (s.p < s.end) ++s.p;                      // consume newline
    }
  } else {
    bool has_wt = false;
    bool probed = false;
    for (int64_t i = 0; i < nnz; ++i) {
      if (fmt == 2) {                              // skip 'a' tag
        if (!s.skip_ws()) break;
        while (s.p < s.end && (*s.p == 'c' || *s.p == 'a')) {
          if (*s.p == 'c') { s.skip_line(); s.skip_ws(); continue; }
          ++s.p;
          break;
        }
      }
      if (!probed && fmt != 2) {
        s.skip_ws();
        int nf = s.fields_on_line();
        has_wt = nf >= 3;
        probed = true;
        if (has_wt) *wt_out = wt =
            static_cast<double*>(std::malloc(nnz * 8));
      } else if (!probed) {
        probed = true;
        // gr: detect weight on first data line
        const char* save = s.p;
        int64_t t;
        double d;
        if (s.next_i64(&t) && s.next_i64(&t)) {
          const char* after2 = s.p;
          has_wt = false;
          // peek one more number before newline
          const char* q = after2;
          while (q < s.end && (*q == ' ' || *q == '\t' || *q == '\r'))
            ++q;
          if (q < s.end && *q != '\n' && (( *q >= '0' && *q <= '9') ||
                                          *q == '-' || *q == '+'))
            has_wt = true;
          (void)d;
        }
        s.p = save;
        if (has_wt) *wt_out = wt =
            static_cast<double*>(std::malloc(nnz * 8));
      }
      int64_t a, b;
      if (!s.next_i64(&a) || !s.next_i64(&b)) break;
      src[count] = static_cast<int32_t>(a - 1);
      dst[count] = static_cast<int32_t>(b - 1);
      if (wt) {
        double w = 1;
        s.next_double(&w);
        wt[count] = w;
      }
      // line-oriented formats: drop any extra per-line fields (e.g.
      // MatrixMarket 'complex' carries real+imag) so a 4th number is
      // never consumed as the next edge's src (advisor finding r1;
      // matches the NumPy fallback's per-line parse in core/io.py)
      s.skip_line();
      ++count;
    }
  }

  std::free(buf);
  *m_out = m;
  *n_out = n;
  *nnz_out = count;
  *src_out = src;
  *dst_out = dst;
  return 0;
}

void gt_free(void* p) { std::free(p); }

}  // extern "C"
