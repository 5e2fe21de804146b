// Fast delimited-text parser — the native data-loader component.
//
// A copy of the sniff-and-parse half of lightgbm_tpu/native/fastparse.cpp
// (LightGBM's CSVParser/TSVParser, src/io/parser.cpp, and its text
// reader): one OpenMP pass over the file's bytes, line ranges split per
// thread, std::from_chars for float decoding.
// Exposed through plain C symbols consumed via ctypes
// (lightgbm_tpu_torch/utils/native.py) — no pybind11 dependency.
//
// Layout contract: the caller allocates out[n_rows * n_cols] float64;
// unparseable / empty cells become NaN (the reference's missing-value
// convention for dense text loads).

#include <algorithm>
#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <limits>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Count data rows and detect the column count + delimiter.
// Returns 0 on success. delim_out: ',', '\t' or ' '.
int ltpu_sniff(const char* buf, int64_t len, int skip_header,
               int64_t* rows_out, int64_t* cols_out, char* delim_out) {
  int64_t pos = 0;
  if (skip_header) {
    while (pos < len && buf[pos] != '\n') pos++;
    if (pos < len) pos++;
  }
  // find first non-empty line for delimiter + column sniffing
  int64_t line_start = pos;
  while (line_start < len) {
    int64_t line_end = line_start;
    while (line_end < len && buf[line_end] != '\n') line_end++;
    if (line_end > line_start + 1) break;
    line_start = line_end + 1;
  }
  if (line_start >= len) return 1;
  int64_t line_end = line_start;
  char delim = ' ';
  while (line_end < len && buf[line_end] != '\n') {
    if (buf[line_end] == '\t') delim = '\t';
    else if (buf[line_end] == ',' && delim != '\t') delim = ',';
    line_end++;
  }
  int64_t cols = 1;
  for (int64_t i = line_start; i < line_end; ++i) {
    if (delim == ' ' ? (buf[i] == ' ' || buf[i] == '\t')
                     : buf[i] == delim) {
      cols++;
      if (delim == ' ')  // collapse runs of whitespace
        while (i + 1 < line_end &&
               (buf[i + 1] == ' ' || buf[i + 1] == '\t')) i++;
    }
  }
  int64_t rows = 0;
  for (int64_t i = pos; i < len; ++i)
    if (buf[i] == '\n' && i > pos && buf[i - 1] != '\n') rows++;
  if (len > pos && buf[len - 1] != '\n') rows++;  // unterminated last line
  *rows_out = rows;
  *cols_out = cols;
  *delim_out = delim;
  return 0;
}

static inline double parse_cell(const char* s, const char* e) {
  while (s < e && (*s == ' ' || *s == '\t')) s++;
  while (e > s && (*(e - 1) == ' ' || *(e - 1) == '\r')) e--;
  if (s >= e) return std::numeric_limits<double>::quiet_NaN();
  double v;
  auto res = std::from_chars(s, e, v);
  if (res.ec != std::errc()) {
    // from_chars rejects leading '+' and inf/nan spellings; fall back
    if ((e - s) >= 3 && (s[0] == 'n' || s[0] == 'N'))
      return std::numeric_limits<double>::quiet_NaN();
    char tmp[64];
    size_t m = static_cast<size_t>(e - s);
    if (m >= sizeof(tmp)) m = sizeof(tmp) - 1;
    std::memcpy(tmp, s, m);
    tmp[m] = 0;
    char* endp = nullptr;
    v = std::strtod(tmp, &endp);
    if (endp == tmp) return std::numeric_limits<double>::quiet_NaN();
  }
  return v;
}

// Parse the whole buffer into out[rows * cols] (row-major). Rows with
// fewer cells get NaN tails; extra cells are ignored.
// Returns the number of parsed rows.
int64_t ltpu_parse_dense(const char* buf, int64_t len, int skip_header,
                         char delim, int64_t rows, int64_t cols,
                         double* out) {
  int64_t pos = 0;
  if (skip_header) {
    while (pos < len && buf[pos] != '\n') pos++;
    if (pos < len) pos++;
  }
  // collect line offsets (serial, cheap) then parse cells in parallel
  std::vector<int64_t> starts;
  starts.reserve(static_cast<size_t>(rows) + 1);
  int64_t i = pos;
  while (i < len && static_cast<int64_t>(starts.size()) < rows) {
    int64_t le = i;
    while (le < len && buf[le] != '\n') le++;
    if (le > i) starts.push_back(i);
    i = le + 1;
  }
  const int64_t n = static_cast<int64_t>(starts.size());
  const bool ws = (delim == ' ');
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < n; ++r) {
    int64_t s = starts[static_cast<size_t>(r)];
    int64_t e = s;
    while (e < len && buf[e] != '\n') e++;
    double* row = out + r * cols;
    int64_t c = 0;
    int64_t cs = s;
    for (int64_t k = s; k <= e && c < cols; ++k) {
      bool is_delim = (k == e) ||
          (ws ? (buf[k] == ' ' || buf[k] == '\t') : buf[k] == delim);
      if (!is_delim) continue;
      row[c++] = parse_cell(buf + cs, buf + k);
      if (ws)  // collapse whitespace runs
        while (k + 1 <= e && k + 1 < len &&
               (buf[k + 1] == ' ' || buf[k + 1] == '\t')) k++;
      cs = k + 1;
    }
    for (; c < cols; ++c)
      row[c] = std::numeric_limits<double>::quiet_NaN();
  }
  return n;
}

}  // extern "C"
