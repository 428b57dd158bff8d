// spmv_tpu native host runtime: fast Matrix Market parsing, COO->CSR
// conversion, and the SpGEMM symbolic phase.
//
// Equivalent of the reference's native host layer (ref:
// include/load.hpp — banner parse, coordinate read, symmetric
// expansion, counting-sort CSR conversion). This is NOT a
// translation: the parser is a single-pass pointer scanner over a
// fully buffered file (no fscanf), and the CSR conversion is a stable
// counting sort over memory the caller owns.
//
// Exposed as a plain C ABI for ctypes; all buffers are allocated by
// the caller (NumPy) except the parse result, which the library
// allocates and the caller releases with spmv_free().

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <new>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Error reporting: thread-local message buffer.
// ---------------------------------------------------------------------------
static thread_local char g_err[256];

const char* spmv_last_error() { return g_err; }

static int fail(const char* msg) {
  std::snprintf(g_err, sizeof(g_err), "%s", msg);
  return -1;
}

void spmv_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Matrix Market parser.
//
// Header semantics follow the reference loader (banner validation,
// 1-based indices, pattern => value 1.0, symmetric/skew off-diagonal
// expansion; ref: load.hpp:163-408) but the implementation is a
// buffered scanner: the file is read once into memory and integers /
// floats are decoded with tight hand loops.
// ---------------------------------------------------------------------------

enum MMField { FIELD_REAL = 0, FIELD_INTEGER = 1, FIELD_PATTERN = 2 };
enum MMSym { SYM_GENERAL = 0, SYM_SYMMETRIC = 1, SYM_SKEW = 2 };

struct MMResult {
  int64_t n_rows;
  int64_t n_cols;
  int64_t nnz;      // entries AFTER symmetric expansion
  int32_t* rows;    // 0-based
  int32_t* cols;    // 0-based
  double* vals;
  int32_t field;
  int32_t symmetry;
};

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

static inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

static inline const char* parse_i64(const char* p, const char* end, int64_t* out,
                                    bool* ok) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  if (p >= end || *p < '0' || *p > '9') { *ok = false; return p; }
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  *ok = true;
  return p;
}

// Fast decimal float parse: mantissa as int64 + power-of-ten exponent.
// Falls back to strtod only for pathological lengths.
static inline const char* parse_f64(const char* p, const char* end, double* out,
                                    bool* ok) {
  p = skip_ws(p, end);
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  int64_t mant = 0;
  int digits = 0, exp10 = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    if (digits < 18) { mant = mant * 10 + (*p - '0'); ++digits; }
    else ++exp10;
    ++p; any = true;
  }
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      if (digits < 18) { mant = mant * 10 + (*p - '0'); ++digits; --exp10; }
      ++p; any = true;
    }
  }
  if (!any) { *ok = false; return p; }
  if (p < end && (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D')) {
    ++p;
    int64_t e = 0; bool eok = false;
    p = parse_i64(p, end, &e, &eok);
    if (!eok) { *ok = false; return p; }
    exp10 += (int)e;
  }
  double v;
  if (exp10 >= -308 && exp10 <= 308) {
    // exact for |exp10| <= 22 with pow10 table; good to 1 ulp otherwise
    static const double pow10_pos[23] = {1e0,1e1,1e2,1e3,1e4,1e5,1e6,1e7,1e8,
      1e9,1e10,1e11,1e12,1e13,1e14,1e15,1e16,1e17,1e18,1e19,1e20,1e21,1e22};
    double m = (double)mant;
    int e = exp10;
    if (e >= 0) {
      v = (e <= 22) ? m * pow10_pos[e] : m * std::pow(10.0, e);
    } else {
      v = (-e <= 22) ? m / pow10_pos[-e] : m * std::pow(10.0, e);
    }
  } else {
    char buf[64];
    size_t n = (size_t)(p - start) < sizeof(buf) - 1 ? (size_t)(p - start)
                                                     : sizeof(buf) - 1;
    std::memcpy(buf, start, n);
    buf[n] = 0;
    v = std::strtod(buf, nullptr);
  }
  *out = neg ? -v : v;
  *ok = true;
  return p;
}

static int str_ieq(const char* p, const char* end, const char* kw) {
  size_t n = std::strlen(kw);
  if ((size_t)(end - p) < n) return 0;
  for (size_t i = 0; i < n; ++i) {
    char c = p[i];
    if (c >= 'A' && c <= 'Z') c += 32;
    if (c != kw[i]) return 0;
  }
  // must end at token boundary
  char nxt = (p + n < end) ? p[n] : ' ';
  return nxt == ' ' || nxt == '\t' || nxt == '\r' || nxt == '\n';
}

// Parse a .mtx coordinate file. Returns 0 on success; fills *res.
int spmv_mm_read(const char* path, MMResult* res) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return fail("cannot open file");
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize <= 0) { std::fclose(f); return fail("empty file"); }
  char* buf = (char*)std::malloc((size_t)fsize + 1);
  if (!buf) { std::fclose(f); return fail("out of memory (file buffer)"); }
  if (std::fread(buf, 1, (size_t)fsize, f) != (size_t)fsize) {
    std::free(buf); std::fclose(f); return fail("short read");
  }
  std::fclose(f);
  buf[fsize] = '\n';
  const char* p = buf;
  const char* end = buf + fsize;

  // --- banner ---
  if (!str_ieq(p, end, "%%matrixmarket")) {
    std::free(buf); return fail("bad MatrixMarket banner");
  }
  const char* line_end = p;
  while (line_end < end && *line_end != '\n') ++line_end;
  // tokens: %%MatrixMarket matrix coordinate field symmetry
  const char* q = p + 14;
  q = skip_ws(q, line_end);
  if (!str_ieq(q, line_end, "matrix")) { std::free(buf); return fail("banner: only 'matrix' objects supported"); }
  q = skip_ws(q + 6, line_end);
  if (!str_ieq(q, line_end, "coordinate")) { std::free(buf); return fail("banner: only 'coordinate' format supported natively"); }
  q = skip_ws(q + 10, line_end);
  int field;
  if (str_ieq(q, line_end, "real")) { field = FIELD_REAL; q += 4; }
  else if (str_ieq(q, line_end, "integer")) { field = FIELD_INTEGER; q += 7; }
  else if (str_ieq(q, line_end, "pattern")) { field = FIELD_PATTERN; q += 7; }
  else { std::free(buf); return fail("banner: unsupported field (real/integer/pattern)"); }
  q = skip_ws(q, line_end);
  int sym;
  if (str_ieq(q, line_end, "general")) sym = SYM_GENERAL;
  else if (str_ieq(q, line_end, "symmetric")) sym = SYM_SYMMETRIC;
  else if (str_ieq(q, line_end, "skew-symmetric")) sym = SYM_SKEW;
  else { std::free(buf); return fail("banner: unsupported symmetry"); }

  p = next_line(p, end);
  // --- comments / blank lines ---
  while (p < end) {
    const char* s = skip_ws(p, end);
    if (s < end && *s == '%') { p = next_line(p, end); continue; }
    if (s < end && *s == '\n') { p = s + 1; continue; }
    break;
  }
  // --- size line ---
  int64_t nr = 0, nc = 0, nz = 0;
  bool ok = false;
  p = parse_i64(p, end, &nr, &ok);
  if (ok) p = parse_i64(p, end, &nc, &ok);
  if (ok) p = parse_i64(p, end, &nz, &ok);
  if (!ok || nr < 0 || nc < 0 || nz < 0) { std::free(buf); return fail("bad size line"); }
  p = next_line(p, end);

  // Allocate with headroom for symmetric expansion (worst case 2x).
  int64_t cap = (sym == SYM_GENERAL) ? nz : 2 * nz;
  if (cap == 0) cap = 1;
  int32_t* rows = (int32_t*)std::malloc(sizeof(int32_t) * (size_t)cap);
  int32_t* cols = (int32_t*)std::malloc(sizeof(int32_t) * (size_t)cap);
  double* vals = (double*)std::malloc(sizeof(double) * (size_t)cap);
  if (!rows || !cols || !vals) {
    std::free(rows); std::free(cols); std::free(vals); std::free(buf);
    return fail("out of memory (entry buffers)");
  }

  int64_t m = 0;  // entries written (including expansion)
  for (int64_t k = 0; k < nz; ++k) {
    int64_t r = 0, c = 0;
    double v = 1.0;
    p = parse_i64(p, end, &r, &ok);
    if (ok) p = parse_i64(p, end, &c, &ok);
    if (!ok) {
      std::free(rows); std::free(cols); std::free(vals); std::free(buf);
      return fail("truncated entry line");
    }
    if (field != FIELD_PATTERN) {
      p = parse_f64(p, end, &v, &ok);
      if (!ok) {
        std::free(rows); std::free(cols); std::free(vals); std::free(buf);
        return fail("entry line missing value");
      }
    }
    p = next_line(p, end);
    if (r < 1 || c < 1 || r > nr || c > nc) {
      std::free(rows); std::free(cols); std::free(vals); std::free(buf);
      return fail("entry index out of bounds (file must be 1-based)");
    }
    rows[m] = (int32_t)(r - 1);
    cols[m] = (int32_t)(c - 1);
    vals[m] = v;
    ++m;
    if (sym != SYM_GENERAL && r != c) {  // off-diagonal mirror
      rows[m] = (int32_t)(c - 1);
      cols[m] = (int32_t)(r - 1);
      vals[m] = (sym == SYM_SKEW) ? -v : v;
      ++m;
    }
  }
  std::free(buf);
  res->n_rows = nr;
  res->n_cols = nc;
  res->nnz = m;
  res->rows = rows;
  res->cols = cols;
  res->vals = vals;
  res->field = field;
  res->symmetry = sym;
  return 0;
}

// ---------------------------------------------------------------------------
// COO -> CSR stable counting sort (ref semantics: load.hpp:420-474 —
// per-row input order preserved, duplicates kept).
// Caller provides all buffers: Ap (n_rows+1 int64 workspace), out_Aj,
// out_perm (the permutation so the caller can apply it to any value
// dtype without this library knowing about dtypes).
// ---------------------------------------------------------------------------
int spmv_coo_to_csr(int64_t n_rows, int64_t nnz, const int32_t* rows,
                    const int32_t* cols, int64_t* Ap, int32_t* out_Aj,
                    int64_t* out_perm) {
  std::memset(Ap, 0, sizeof(int64_t) * (size_t)(n_rows + 1));
  for (int64_t k = 0; k < nnz; ++k) {
    int32_t r = rows[k];
    if (r < 0 || r >= n_rows) return fail("row index out of range");
    ++Ap[r + 1];
  }
  for (int64_t i = 0; i < n_rows; ++i) Ap[i + 1] += Ap[i];
  // stable placement using a moving cursor per row
  int64_t* cursor = (int64_t*)std::malloc(sizeof(int64_t) * (size_t)n_rows);
  if (!cursor && n_rows > 0) return fail("out of memory (cursor)");
  std::memcpy(cursor, Ap, sizeof(int64_t) * (size_t)n_rows);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t dst = cursor[rows[k]]++;
    out_Aj[dst] = cols[k];
    out_perm[dst] = k;
  }
  std::free(cursor);
  return 0;
}

// ---------------------------------------------------------------------------
// SpGEMM symbolic phase: Gustavson row-merge with a sparse accumulator.
//
// Two passes over the intermediate triples (i,k,j) = A row i entry k
// crossed with B row k entry j:
//   pass 1: per output row, SPA-count occurrences of each distinct j,
//           sort the distinct set -> Cp / Cj / per-nonzero group sizes.
//   pass 2: SPA maps j -> group id; emit each triple's (A-entry, B-pos)
//           into its group's slice of srcA/srcB (counting-sort order).
// Replaces the NumPy lexsort-over-all-triples symbolic (O(t log t) and
// ~20x slower at 10M triples); the value-dependent numeric phase stays
// on device (kernels/spgemm.py).
// ---------------------------------------------------------------------------
int spmv_spgemm_symbolic(
    int64_t n_rows, int64_t n_cols_b,
    const int64_t* Ap, const int64_t* Aj,
    const int64_t* Bp, const int64_t* Bj,
    int64_t* Cp,                 // (n_rows+1) out
    int32_t** Cj_out, int64_t* nnzC_out,
    int64_t** v_ap_out,          // (nnzC+1) out
    int64_t** srcA_out, int64_t** srcB_out,  // (total) out
    int64_t* total_out) {
  if (n_cols_b > (int64_t)1 << 31)
    return fail("spgemm_symbolic: n_cols too large for int32 Cj");
  int64_t* stamp = (int64_t*)std::malloc(n_cols_b * sizeof(int64_t));
  int64_t* cnt = (int64_t*)std::malloc(n_cols_b * sizeof(int64_t));
  int64_t* gid = (int64_t*)std::malloc(n_cols_b * sizeof(int64_t));
  if (!stamp || !cnt || !gid) {
    std::free(stamp); std::free(cnt); std::free(gid);
    return fail("spgemm_symbolic: out of memory (SPA)");
  }
  for (int64_t j = 0; j < n_cols_b; ++j) stamp[j] = -1;

  // pass 1: C pattern + group sizes (vector growth can throw
  // bad_alloc; convert to the error-return used everywhere else
  // rather than unwinding through the C ABI)
  std::vector<int32_t> Cj;
  std::vector<int64_t> gsz;
  std::vector<int32_t> distinct;
  int64_t total = 0;
  Cp[0] = 0;
  try {
    for (int64_t i = 0; i < n_rows; ++i) {
      distinct.clear();
      for (int64_t e = Ap[i]; e < Ap[i + 1]; ++e) {
        int64_t k = Aj[e];
        for (int64_t p = Bp[k]; p < Bp[k + 1]; ++p) {
          int64_t j = Bj[p];
          if (stamp[j] != i) { stamp[j] = i; cnt[j] = 0;
                               distinct.push_back((int32_t)j); }
          ++cnt[j];
          ++total;
        }
      }
      std::sort(distinct.begin(), distinct.end());
      for (int32_t j : distinct) { Cj.push_back(j); gsz.push_back(cnt[j]); }
      Cp[i + 1] = (int64_t)Cj.size();
    }
  } catch (const std::bad_alloc&) {
    std::free(stamp); std::free(cnt); std::free(gid);
    return fail("spgemm_symbolic: out of memory (pattern)");
  }
  int64_t nnzC = (int64_t)Cj.size();

  int64_t* v_ap = (int64_t*)std::malloc((nnzC + 1) * sizeof(int64_t));
  int64_t* srcA = (int64_t*)std::malloc(
      std::max<int64_t>(total, 1) * sizeof(int64_t));
  int64_t* srcB = (int64_t*)std::malloc(
      std::max<int64_t>(total, 1) * sizeof(int64_t));
  int32_t* CjA = (int32_t*)std::malloc(
      std::max<int64_t>(nnzC, 1) * sizeof(int32_t));
  int64_t* cur = (int64_t*)std::malloc(
      std::max<int64_t>(nnzC, 1) * sizeof(int64_t));
  if (!v_ap || !srcA || !srcB || !CjA || !cur) {
    std::free(stamp); std::free(cnt); std::free(gid);
    std::free(v_ap); std::free(srcA); std::free(srcB);
    std::free(CjA); std::free(cur);
    return fail("spgemm_symbolic: out of memory (outputs)");
  }
  v_ap[0] = 0;
  for (int64_t g = 0; g < nnzC; ++g) {
    v_ap[g + 1] = v_ap[g] + gsz[g];
    cur[g] = v_ap[g];
    CjA[g] = Cj[g];
  }

  // pass 2: emit triples grouped by output nonzero (every j a row's
  // triples touch is in that row's pattern, so gid is always fresh)
  for (int64_t i = 0; i < n_rows; ++i) {
    for (int64_t g = Cp[i]; g < Cp[i + 1]; ++g) gid[CjA[g]] = g;
    for (int64_t e = Ap[i]; e < Ap[i + 1]; ++e) {
      int64_t k = Aj[e];
      for (int64_t p = Bp[k]; p < Bp[k + 1]; ++p) {
        int64_t g = gid[Bj[p]];
        int64_t slot = cur[g]++;
        srcA[slot] = e;
        srcB[slot] = p;
      }
    }
  }
  std::free(stamp); std::free(cnt); std::free(gid); std::free(cur);
  *Cj_out = CjA;
  *nnzC_out = nnzC;
  *v_ap_out = v_ap;
  *srcA_out = srcA;
  *srcB_out = srcB;
  *total_out = total;
  return 0;
}

}  // extern "C"
