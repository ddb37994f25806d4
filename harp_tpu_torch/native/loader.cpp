// Fast parallel text loader: the port's own copy of harp_tpu's native
// loader (dense CSV, libsvm/CSR, rating triples, streaming CSV).
//
// Harp's HarpDAALDataSource loaded HDFS CSV shards through JNI with the
// parse done natively.  Here the same role is a small C++ library driven
// through ctypes (plain C ABI): it splits a file across std::thread
// workers, each parses its byte range with a branch-light float scanner,
// and rows land in one contiguous float32 buffer.  Built with g++ by
// harp_tpu_torch/native/build.py into harp_tpu_torch/_build/.
//
// Exposed C ABI:
//   harp_count_rows(path, n_threads, *rows, *cols)      -> 0 on success
//   harp_load_csv_f32(path, n_threads, buf, rows, cols) -> 0 on success
//   harp_count_libsvm(path, n_threads, *rows, *nnz, *max_index) -> 0
//   harp_load_libsvm(path, n_threads, labels, indptr, indices, values,
//                    rows, nnz) -> 0
//   harp_load_triples(path, n_threads, u_buf, i_buf, v_buf, n) -> 0
//   harp_csv_count_stream / harp_csv_stream_* (below)
// Caller (Python) allocates the numpy buffers after harp_count_rows.


#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Mapped {
  char* data = nullptr;
  size_t size = 0;
  bool ok = false;
};

Mapped read_file(const char* path) {
  Mapped m;
  FILE* f = std::fopen(path, "rb");
  if (!f) return m;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz < 0) { std::fclose(f); return m; }
  m.data = static_cast<char*>(std::malloc(sz + 1));
  if (!m.data) { std::fclose(f); return m; }
  m.size = std::fread(m.data, 1, sz, f);
  m.data[m.size] = '\0';
  std::fclose(f);
  m.ok = true;
  return m;
}

// Hand-rolled float scanner: [-+]?digits[.digits][eE[-+]digits].
// ~4× strtof (no locale, no errno); falls back to strtof for anything
// unusual (inf/nan/hex). Exact powers of ten up to |exp| 38 via table.
static const double kPow10[] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22, 1e23,
    1e24, 1e25, 1e26, 1e27, 1e28, 1e29, 1e30, 1e31, 1e32, 1e33, 1e34, 1e35,
    1e36, 1e37, 1e38};

inline float parse_float(const char*& p) {
  const char* s = p;
  bool neg = false;
  if (*s == '-') { neg = true; ++s; }
  else if (*s == '+') { ++s; }
  if (!((*s >= '0' && *s <= '9') || *s == '.')) {
    // inf/nan/garbage: strtof, but ALWAYS advance past the token so the
    // caller's column loop can't spin forever on e.g. a header row
    char* endp = nullptr;
    float v = std::strtof(p, &endp);
    if (endp == p) {  // no conversion: skip the non-numeric token
      const char* q = p;
      while (*q && *q != ',' && *q != ' ' && *q != '\t' && *q != '\r' &&
             *q != '\n') ++q;
      p = (q == p) ? p + 1 : q;
      return 0.0f;
    }
    p = endp;
    return v;
  }
  uint64_t mant = 0;
  int frac_digits = 0;
  int ndig = 0;
  while (*s >= '0' && *s <= '9') {
    if (ndig < 19) { mant = mant * 10 + (*s - '0'); ++ndig; }
    else { --frac_digits; }  // skipped integer digit ⇒ scale up by 10
    ++s;
  }
  if (*s == '.') {
    ++s;
    while (*s >= '0' && *s <= '9') {
      if (ndig < 19) { mant = mant * 10 + (*s - '0'); ++ndig; ++frac_digits; }
      ++s;
    }
  }
  int exp10 = -frac_digits;
  if (*s == 'e' || *s == 'E') {
    ++s;
    bool eneg = false;
    if (*s == '-') { eneg = true; ++s; }
    else if (*s == '+') { ++s; }
    int e = 0;
    while (*s >= '0' && *s <= '9') {
      if (e < 100000) e = e * 10 + (*s - '0');  // clamp: no int overflow
      ++s;
    }
    exp10 += eneg ? -e : e;
  }
  // Clamp to double's decimal range BEFORE the stepped loops: a corrupt
  // "1e2000000000" token must parse in O(1) (to inf/0, like strtof), not
  // spin |exp10|/38 iterations, and a clamped exponent can never index
  // kPow10 out of bounds.
  if (exp10 > 700) exp10 = 700;
  else if (exp10 < -700) exp10 = -700;
  double v = static_cast<double>(mant);
  // Apply the decimal exponent in <=38 steps: a LONG mantissa plus a small
  // value can push the combined exponent past the table (e.g.
  // "9.9999999999999991e-31" has exp10 = -47) — the old 1e308 clamp
  // misparsed such values to 0/inf even though they are ordinary floats.
  int e = exp10;
  while (e > 0) { int step = e > 38 ? 38 : e; v *= kPow10[step]; e -= step; }
  while (e < 0) { int step = -e > 38 ? 38 : -e; v /= kPow10[step]; e += step; }
  p = s;
  return static_cast<float>(neg ? -v : v);
}

inline void skip_seps(const char*& p, const char* end) {
  while (p < end && (*p == ',' || *p == ' ' || *p == '\t' || *p == '\r')) ++p;
}

// Align a byte offset to the start of the next line.
size_t align_to_line(const char* data, size_t off, size_t size) {
  if (off == 0) return 0;
  while (off < size && data[off - 1] != '\n') ++off;
  return off;
}

// Truncate a line at '#' (numpy.loadtxt's default comment marker — the
// Python fallback inherits it, so the native parser must agree).
inline const char* strip_comment(const char* p, const char* line_end) {
  const char* hash = static_cast<const char*>(memchr(p, '#', line_end - p));
  return hash ? hash : line_end;
}

// A line is blank if it holds only separators (or was all comment).
inline bool blank_line(const char* p, const char* line_end) {
  skip_seps(p, line_end);
  return p >= line_end;
}

void count_range(const char* data, size_t begin, size_t end_, int64_t* rows,
                 int64_t* cols) {
  int64_t r = 0, c = 0;
  const char* p = data + begin;
  const char* end = data + end_;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = strip_comment(p, nl ? nl : end);
    if (line_end > p && !blank_line(p, line_end)) {
      ++r;
      if (c == 0) {
        const char* q = p;
        while (q < line_end) {
          skip_seps(q, line_end);
          if (q >= line_end) break;
          parse_float(q);
          ++c;
        }
      }
    }
    p = nl ? nl + 1 : end;
  }
  *rows = r;
  *cols = c;
}

}  // namespace

extern "C" {

// First pass: rows and columns (cols from the first non-empty line).
int harp_count_rows(const char* path, int n_threads, int64_t* rows,
                    int64_t* cols) {
  Mapped m = read_file(path);
  if (!m.ok) return 1;
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<int64_t> r(nt, 0), c(nt, 0);
  std::vector<std::thread> ts;
  size_t chunk = m.size / nt + 1;
  for (int t = 0; t < nt; ++t) {
    size_t b = align_to_line(m.data, t * chunk, m.size);
    size_t e = align_to_line(m.data, (t + 1) * chunk, m.size);
    if (e > m.size) e = m.size;
    ts.emplace_back(count_range, m.data, b, e, &r[t], &c[t]);
  }
  for (auto& t : ts) t.join();
  *rows = 0;
  *cols = 0;
  for (int t = 0; t < nt; ++t) {
    *rows += r[t];
    if (*cols == 0) *cols = c[t];
  }
  std::free(m.data);
  return 0;
}

// Second pass: parse into the caller-allocated [rows, cols] f32 buffer.
int harp_load_csv_f32(const char* path, int n_threads, float* buf,
                      int64_t rows, int64_t cols) {
  Mapped m = read_file(path);
  if (!m.ok) return 1;
  int nt = n_threads > 0 ? n_threads : 1;

  // per-thread row offsets need a prefix count first
  std::vector<size_t> begins(nt), ends(nt);
  std::vector<int64_t> r(nt, 0), c(nt, 0);
  size_t chunk = m.size / nt + 1;
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t) {
      begins[t] = align_to_line(m.data, t * chunk, m.size);
      ends[t] = align_to_line(m.data, (t + 1) * chunk, m.size);
      if (ends[t] > m.size) ends[t] = m.size;
      ts.emplace_back(count_range, m.data, begins[t], ends[t], &r[t], &c[t]);
    }
    for (auto& t : ts) t.join();
  }
  std::vector<int64_t> row0(nt, 0);
  for (int t = 1; t < nt; ++t) row0[t] = row0[t - 1] + r[t - 1];
  if (row0[nt - 1] + r[nt - 1] != rows) { std::free(m.data); return 2; }

  auto parse_range = [&](int t) {
    const char* p = m.data + begins[t];
    const char* end = m.data + ends[t];
    float* out = buf + row0[t] * cols;
    while (p < end) {
      const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
      const char* line_end = strip_comment(p, nl ? nl : end);
      if (line_end > p && !blank_line(p, line_end)) {
        const char* q = p;
        for (int64_t j = 0; j < cols; ++j) {
          skip_seps(q, line_end);
          *out++ = (q < line_end) ? parse_float(q) : 0.0f;
        }
      }
      p = nl ? nl + 1 : end;
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) ts.emplace_back(parse_range, t);
  for (auto& t : ts) t.join();
  std::free(m.data);
  return 0;
}

// libsvm / CSR sparse: "label idx:val idx:val ..." lines (HarpDAALDataSource's
// CSR input).  Two-phase like the dense loader: count (rows, nnz, max index),
// then parse into caller-allocated CSR buffers.

namespace {

void count_libsvm_range(const char* data, size_t begin, size_t end_,
                        int64_t* rows, int64_t* nnz, int64_t* max_idx) {
  int64_t r = 0, z = 0, mi = -1;
  const char* p = data + begin;
  const char* end = data + end_;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    // '#' starts a comment anywhere on the line (parity with the Python
    // fallback's split('#', 1))
    const char* hash =
        static_cast<const char*>(memchr(p, '#', line_end - p));
    if (hash) line_end = hash;
    if (line_end > p) {
      const char* q = p;
      skip_seps(q, line_end);
      if (q < line_end) {
        ++r;
        parse_float(q);  // label: numeric prefix of the first token...
        // ...and any trailing garbage in that token is dropped whole, so
        // '3:1.5' is a label-only line, never a phantom (0, 1.5) pair
        while (q < line_end && *q != ' ' && *q != '\t' && *q != ',') ++q;
        while (q < line_end) {
          skip_seps(q, line_end);
          if (q >= line_end) break;
          long idx = std::strtol(q, const_cast<char**>(&q), 10);
          // a value exists only if something non-blank follows the ':' on
          // THIS line — "3:\n" must not let strtof's whitespace skip eat
          // the next line's label as the value
          if (q < line_end && *q == ':' && q + 1 < line_end &&
              q[1] != ' ' && q[1] != '\t' && q[1] != '\r' && q[1] != '\n') {
            ++q;
            parse_float(q);
            ++z;
            if (idx > mi) mi = idx;
          } else {
            // not an idx:val pair — skip the stray token
            while (q < line_end && *q != ' ' && *q != '\t' && *q != ',') ++q;
          }
        }
      }
    }
    p = nl ? nl + 1 : end;
  }
  *rows = r;
  *nnz = z;
  *max_idx = mi;
}

}  // namespace

int harp_count_libsvm(const char* path, int n_threads, int64_t* rows,
                      int64_t* nnz, int64_t* max_index) {
  Mapped m = read_file(path);
  if (!m.ok) return 1;
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<int64_t> r(nt, 0), z(nt, 0), mi(nt, -1);
  std::vector<std::thread> ts;
  size_t chunk = m.size / nt + 1;
  for (int t = 0; t < nt; ++t) {
    size_t b = align_to_line(m.data, t * chunk, m.size);
    size_t e = align_to_line(m.data, (t + 1) * chunk, m.size);
    if (e > m.size) e = m.size;
    ts.emplace_back(count_libsvm_range, m.data, b, e, &r[t], &z[t], &mi[t]);
  }
  for (auto& t : ts) t.join();
  *rows = 0; *nnz = 0; *max_index = -1;
  for (int t = 0; t < nt; ++t) {
    *rows += r[t];
    *nnz += z[t];
    if (mi[t] > *max_index) *max_index = mi[t];
  }
  std::free(m.data);
  return 0;
}

int harp_load_libsvm(const char* path, int n_threads, float* labels,
                     int64_t* indptr, int32_t* indices, float* values,
                     int64_t rows, int64_t nnz) {
  Mapped m = read_file(path);
  if (!m.ok) return 1;
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<size_t> begins(nt), ends(nt);
  std::vector<int64_t> r(nt, 0), z(nt, 0), mi(nt, -1);
  size_t chunk = m.size / nt + 1;
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t) {
      begins[t] = align_to_line(m.data, t * chunk, m.size);
      ends[t] = align_to_line(m.data, (t + 1) * chunk, m.size);
      if (ends[t] > m.size) ends[t] = m.size;
      ts.emplace_back(count_libsvm_range, m.data, begins[t], ends[t],
                      &r[t], &z[t], &mi[t]);
    }
    for (auto& t : ts) t.join();
  }
  std::vector<int64_t> row0(nt, 0), nnz0(nt, 0);
  for (int t = 1; t < nt; ++t) {
    row0[t] = row0[t - 1] + r[t - 1];
    nnz0[t] = nnz0[t - 1] + z[t - 1];
  }
  if (row0[nt - 1] + r[nt - 1] != rows ||
      nnz0[nt - 1] + z[nt - 1] != nnz) { std::free(m.data); return 2; }

  auto parse_range = [&](int t) {
    const char* p = m.data + begins[t];
    const char* end = m.data + ends[t];
    int64_t row = row0[t], k = nnz0[t];
    while (p < end) {
      const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
      const char* line_end = nl ? nl : end;
      const char* hash =
          static_cast<const char*>(memchr(p, '#', line_end - p));
      if (hash) line_end = hash;
      if (line_end > p) {
        const char* q = p;
        skip_seps(q, line_end);
        if (q < line_end) {
          indptr[row] = k;
          labels[row] = parse_float(q);
          // drop the label token's trailing garbage (mirror the count pass)
          while (q < line_end && *q != ' ' && *q != '\t' && *q != ',') ++q;
          while (q < line_end) {
            skip_seps(q, line_end);
            if (q >= line_end) break;
            long idx = std::strtol(q, const_cast<char**>(&q), 10);
            // mirror count_libsvm_range's has-value guard exactly — the
            // prefix offsets depend on both passes agreeing
            if (q < line_end && *q == ':' && q + 1 < line_end &&
                q[1] != ' ' && q[1] != '\t' && q[1] != '\r' && q[1] != '\n') {
              ++q;
              values[k] = parse_float(q);
              indices[k] = static_cast<int32_t>(idx);
              ++k;
            } else {
              while (q < line_end && *q != ' ' && *q != '\t' && *q != ',') ++q;
            }
          }
          ++row;
        }
      }
      p = nl ? nl + 1 : end;
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) ts.emplace_back(parse_range, t);
  for (auto& t : ts) t.join();
  indptr[rows] = nnz;
  std::free(m.data);
  return 0;
}

// Rating/token triples "u i v" → int32/int32/float32 columns (MF-SGD, LDA).
int harp_load_triples(const char* path, int n_threads, int32_t* u_buf,
                      int32_t* i_buf, float* v_buf, int64_t n) {
  Mapped m = read_file(path);
  if (!m.ok) return 1;
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<size_t> begins(nt), ends(nt);
  std::vector<int64_t> r(nt, 0), c(nt, 0);
  size_t chunk = m.size / nt + 1;
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t) {
      begins[t] = align_to_line(m.data, t * chunk, m.size);
      ends[t] = align_to_line(m.data, (t + 1) * chunk, m.size);
      if (ends[t] > m.size) ends[t] = m.size;
      ts.emplace_back(count_range, m.data, begins[t], ends[t], &r[t], &c[t]);
    }
    for (auto& t : ts) t.join();
  }
  std::vector<int64_t> row0(nt, 0);
  for (int t = 1; t < nt; ++t) row0[t] = row0[t - 1] + r[t - 1];
  if (row0[nt - 1] + r[nt - 1] != n) { std::free(m.data); return 2; }

  auto parse_range = [&](int t) {
    const char* p = m.data + begins[t];
    const char* end = m.data + ends[t];
    int64_t row = row0[t];
    while (p < end) {
      const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
      const char* line_end = strip_comment(p, nl ? nl : end);
      if (line_end > p && !blank_line(p, line_end)) {
        const char* q = p;
        skip_seps(q, line_end);
        u_buf[row] = static_cast<int32_t>(std::strtol(q, const_cast<char**>(&q), 10));
        skip_seps(q, line_end);
        i_buf[row] = static_cast<int32_t>(std::strtol(q, const_cast<char**>(&q), 10));
        skip_seps(q, line_end);
        v_buf[row] = (q < line_end) ? parse_float(q) : 0.0f;
        ++row;
      }
      p = nl ? nl + 1 : end;
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) ts.emplace_back(parse_range, t);
  for (auto& t : ts) t.join();
  std::free(m.data);
  return 0;
}

// ---------------------------------------------------------------------------
// Streaming CSV reader — the native ingest path for beyond-RAM text
// corpora (feeds harp_tpu_torch.models.kmeans_stream.fit_streaming).  A single
// background thread reads + parses the NEXT chunk while the caller
// consumes the current one (two parsed slots, classic double buffer), so
// disk+parse overlaps device compute.  Bounded memory: two slots of
// [chunk_rows, cols] floats plus one byte block.
//
//   harp_csv_stream_open(path, chunk_rows)        -> handle (NULL = error)
//   harp_csv_stream_cols(h)                       -> cols (-1 error/empty)
//   harp_csv_stream_next(h, buf, buf_rows)        -> rows written
//                                                    (0 = EOF, -1 = error)
//   harp_csv_stream_close(h)
// ---------------------------------------------------------------------------

namespace {

// Parse up to max_rows non-blank lines of [begin, end) into out[cols].
// Missing trailing columns parse as 0 (matches the dense loader).
int64_t parse_block_rows(const char* p, const char* end, int64_t cols,
                         float* out, int64_t max_rows) {
  int64_t r = 0;
  while (p < end && r < max_rows) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* le = strip_comment(p, nl ? nl : end);
    if (le > p && !blank_line(p, le)) {
      const char* q = p;
      for (int64_t c = 0; c < cols; ++c) {
        skip_seps(q, le);
        out[r * cols + c] = (q < le) ? parse_float(q) : 0.0f;
      }
      ++r;
    }
    p = nl ? nl + 1 : end;
  }
  return r;
}

// Columns of the first non-blank line in [p, end); 0 if none.
int64_t first_line_cols(const char* p, const char* end) {
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* le = strip_comment(p, nl ? nl : end);
    if (le > p && !blank_line(p, le)) {
      int64_t c = 0;
      const char* q = p;
      while (q < le) {
        skip_seps(q, le);
        if (q >= le) break;
        parse_float(q);
        ++c;
      }
      return c;
    }
    p = nl ? nl + 1 : end;
  }
  return 0;
}

struct CsvStream {
  std::FILE* f = nullptr;
  int64_t chunk_rows = 0;
  int64_t cols = -1;          // -1 until the first block is seen
  std::string carry;          // bytes after the last complete line
  bool read_eof = false;
  bool io_error = false;      // fread failed (ferror), not clean EOF

  // two parsed slots (producer fills, consumer drains)
  std::vector<float> slot[2];
  int64_t slot_rows[2] = {0, 0};
  bool full[2] = {false, false};
  int prod = 0, cons = 0;
  bool finished = false;      // producer delivered EOF
  bool error = false;
  bool closing = false;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
};

// Gather bytes holding ~chunk_rows lines; the remainder goes to carry.
// Returns false when nothing is left (true EOF).
bool stream_build_block(CsvStream* s, std::string& block) {
  block.clear();
  block.swap(s->carry);
  int64_t nl = std::count(block.begin(), block.end(), '\n');
  std::vector<char> tmp(1 << 20);
  while (nl < s->chunk_rows && !s->read_eof) {
    size_t got = std::fread(tmp.data(), 1, tmp.size(), s->f);
    if (got == 0) {
      s->read_eof = true;
      if (std::ferror(s->f)) s->io_error = true;  // NOT a clean EOF
      break;
    }
    nl += std::count(tmp.data(), tmp.data() + got, '\n');
    block.append(tmp.data(), got);
  }
  // Split after the chunk_rows-th newline.  >= (not >): with EXACTLY
  // chunk_rows newlines plus trailing partial-line bytes, those bytes
  // must go to carry — leaving them in the block would drop them (the
  // parse caps at chunk_rows rows) and the next block would start
  // mid-number.
  if (nl >= s->chunk_rows) {
    int64_t seen = 0;
    size_t pos = 0;
    while (seen < s->chunk_rows) {
      pos = block.find('\n', pos) + 1;
      ++seen;
    }
    s->carry.assign(block, pos, std::string::npos);
    block.resize(pos);
  }
  return !block.empty();
}

void stream_worker(CsvStream* s) {
  std::string block;
  while (true) {
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv.wait(lk, [s] { return s->closing || !s->full[s->prod]; });
      if (s->closing) return;
    }
    // A block can parse to ZERO data rows (all comments/blank lines —
    // including the very first block, before cols is known).  That must
    // not look like EOF: keep pulling blocks until data rows appear or
    // the file truly ends.
    int64_t rows = 0;
    bool got = false;
    do {
      got = stream_build_block(s, block);  // only this thread reads f
      if (!got) break;
      if (s->cols < 0) {
        int64_t c = first_line_cols(block.data(), block.data() + block.size());
        if (c > 0) {
          std::lock_guard<std::mutex> lk(s->mu);
          s->cols = c;
          s->cv.notify_all();
        }
      }
      if (s->cols > 0) {
        auto& sl = s->slot[s->prod];
        sl.resize(s->chunk_rows * s->cols);
        rows = parse_block_rows(block.data(), block.data() + block.size(),
                                s->cols, sl.data(), s->chunk_rows);
      }
    } while (rows == 0);
    {
      std::lock_guard<std::mutex> lk(s->mu);
      if (s->io_error) {
        s->error = true;
        s->cv.notify_all();
        return;
      }
      if (!got) {  // clean EOF (cols stays 0 for an all-blank file)
        if (s->cols < 0) s->cols = 0;
        s->finished = true;
        s->cv.notify_all();
        return;
      }
      s->slot_rows[s->prod] = rows;
      s->full[s->prod] = true;
      s->prod ^= 1;
      s->cv.notify_all();
    }
  }
}

}  // namespace

// Streaming row/column count: bounded memory (one 4 MB block + a line
// carry), unlike harp_count_rows whose read_file() malloc's the whole
// file — CSVPoints' shape pass on a beyond-RAM corpus must not OOM.
int harp_csv_count_stream(const char* path, int64_t* rows, int64_t* cols) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::vector<char> buf(4 << 20);
  std::string carry;
  int64_t r = 0, c = 0;
  while (true) {
    size_t got = std::fread(buf.data(), 1, buf.size(), f);
    if (got == 0) {
      if (std::ferror(f)) { std::fclose(f); return 1; }
      break;
    }
    carry.append(buf.data(), got);
    size_t last_nl = carry.rfind('\n');
    if (last_nl == std::string::npos) continue;  // no complete line yet
    int64_t br = 0, bc = 0;
    count_range(carry.data(), 0, last_nl + 1, &br, &bc);
    r += br;
    if (c == 0) c = bc;
    carry.erase(0, last_nl + 1);
  }
  if (!carry.empty()) {  // final line without trailing newline
    int64_t br = 0, bc = 0;
    count_range(carry.data(), 0, carry.size(), &br, &bc);
    r += br;
    if (c == 0) c = bc;
  }
  std::fclose(f);
  *rows = r;
  *cols = c;
  return 0;
}

void* harp_csv_stream_open(const char* path, int64_t chunk_rows) {
  if (chunk_rows < 1) return nullptr;
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  CsvStream* s = new CsvStream();
  s->f = f;
  s->chunk_rows = chunk_rows;
  s->worker = std::thread(stream_worker, s);
  return s;
}

int64_t harp_csv_stream_cols(void* h) {
  CsvStream* s = static_cast<CsvStream*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv.wait(lk, [s] { return s->cols >= 0 || s->finished || s->error; });
  return s->error ? -1 : s->cols;
}

int64_t harp_csv_stream_next(void* h, float* buf, int64_t buf_rows) {
  CsvStream* s = static_cast<CsvStream*>(h);
  int64_t rows;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv.wait(lk, [s] { return s->full[s->cons] || s->finished || s->error; });
    if (s->error) return -1;
    if (!s->full[s->cons]) return 0;  // finished, queue drained
    rows = s->slot_rows[s->cons];
    if (rows > buf_rows) return -1;   // caller buffer too small
  }
  std::memcpy(buf, s->slot[s->cons].data(),
              static_cast<size_t>(rows) * s->cols * sizeof(float));
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->full[s->cons] = false;
    s->cons ^= 1;
    s->cv.notify_all();
  }
  return rows;
}

void harp_csv_stream_close(void* h) {
  CsvStream* s = static_cast<CsvStream*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closing = true;
    s->cv.notify_all();
  }
  if (s->worker.joinable()) s->worker.join();
  std::fclose(s->f);
  delete s;
}

}  // extern "C"
