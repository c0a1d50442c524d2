// Native presolve scan kernels.
//
// The reference implements its presolve entirely in C++ (PresolveData.C ~4k
// LoC + pass files); the hot inner scans of our presolve (row support
// analysis, tiny-entry dropping, exact parallel-row detection) are
// implemented here natively and called through ctypes, with pure-Python
// fallbacks kept for environments without a compiler.
//
// Build: pips_ipmpp_tpu_torch/native.py (g++ -O3 -shared -fPIC -fopenmp)

#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Per-row stats over a dense row-major [rows x cols] matrix:
//   nnz_out[r]      = number of entries with |a| > tol
//   single_col[r]   = column of the single nonzero if nnz==1 else -1
//   absmax_out[r]   = max |a| in the row
void row_support_stats(const double* M, int64_t rows, int64_t cols,
                       double tol, int32_t* nnz_out, int64_t* single_col,
                       double* absmax_out) {
  for (int64_t r = 0; r < rows; ++r) {
    const double* row = M + r * cols;
    int32_t nnz = 0;
    int64_t last = -1;
    double mx = 0.0;
    for (int64_t c = 0; c < cols; ++c) {
      double a = std::fabs(row[c]);
      if (a > tol) {
        ++nnz;
        last = c;
      }
      if (a > mx) mx = a;
    }
    nnz_out[r] = nnz;
    single_col[r] = (nnz == 1) ? last : -1;
    absmax_out[r] = mx;
  }
}

// In-place tiny-entry removal: zero entries with |a| < abs_tol or
// |a| < rel_tol * rowmax. Returns the number of entries dropped.
int64_t drop_tiny_entries(double* M, int64_t rows, int64_t cols,
                          double abs_tol, double rel_tol) {
  int64_t dropped = 0;
  for (int64_t r = 0; r < rows; ++r) {
    double* row = M + r * cols;
    double mx = 0.0;
    for (int64_t c = 0; c < cols; ++c) {
      double a = std::fabs(row[c]);
      if (a > mx) mx = a;
    }
    double thr = std::fmax(abs_tol, rel_tol * mx);
    for (int64_t c = 0; c < cols; ++c) {
      double a = std::fabs(row[c]);
      if (a > 0.0 && a < thr) {
        row[c] = 0.0;
        ++dropped;
      }
    }
  }
  return dropped;
}

namespace {
// FNV-1a over the quantized normalized pattern of a row.
uint64_t row_hash(const double* row, int64_t cols, double scale) {
  uint64_t h = 1469598103934665603ull;
  for (int64_t c = 0; c < cols; ++c) {
    if (row[c] == 0.0) continue;
    double v = row[c] * scale;
    // quantize to 12 significant digits to tolerate fp noise
    double q = std::round(v * 1e12) / 1e12;
    uint64_t bits;
    std::memcpy(&bits, &q, 8);
    h = (h ^ (uint64_t)c) * 1099511628211ull;
    h = (h ^ bits) * 1099511628211ull;
  }
  return h;
}

double first_nonzero(const double* row, int64_t cols) {
  for (int64_t c = 0; c < cols; ++c)
    if (row[c] != 0.0) return row[c];
  return 0.0;
}
}  // namespace

// Exact parallel-row detection over a dense [rows x cols] matrix.
// Rows are normalized by their first nonzero, hashed, and hash groups are
// verified entry-by-entry. Outputs up to max_pairs (kept, dup, factor)
// triples with row_dup = factor * row_kept. Returns the pair count.
int64_t detect_parallel_rows(const double* M, int64_t rows, int64_t cols,
                             double tol, int64_t* kept_out, int64_t* dup_out,
                             double* factor_out, int64_t max_pairs) {
  std::unordered_map<uint64_t, std::vector<int64_t>> groups;
  groups.reserve((size_t)rows * 2);
  std::vector<double> lead(rows);
  for (int64_t r = 0; r < rows; ++r) {
    const double* row = M + r * cols;
    double f = first_nonzero(row, cols);
    lead[r] = f;
    if (f == 0.0) continue;  // empty rows handled elsewhere
    groups[row_hash(row, cols, 1.0 / f)].push_back(r);
  }
  int64_t np = 0;
  std::vector<char> consumed(rows, 0);
  for (auto& kv : groups) {
    auto& g = kv.second;
    if (g.size() < 2) continue;
    for (size_t i = 0; i < g.size(); ++i) {
      int64_t rk = g[i];
      if (consumed[rk]) continue;
      const double* rowk = M + rk * cols;
      for (size_t j = i + 1; j < g.size(); ++j) {
        int64_t rd = g[j];
        if (consumed[rd]) continue;
        const double* rowd = M + rd * cols;
        // verify rowd == k * rowk with k = lead_d / lead_k
        double k = lead[rd] / lead[rk];
        bool ok = true;
        for (int64_t c = 0; c < cols; ++c) {
          double diff = rowd[c] - k * rowk[c];
          if (std::fabs(diff) >
              tol * std::fmax(1.0, std::fabs(rowd[c]))) {
            ok = false;
            break;
          }
        }
        if (ok && np < max_pairs) {
          kept_out[np] = rk;
          dup_out[np] = rd;
          factor_out[np] = k;
          consumed[rd] = 1;
          ++np;
        }
      }
    }
  }
  return np;
}

// Activity bounds per row: given row coefficients and per-variable bounds
// (with +-inf), compute min/max activity. inf-aware.
void row_activity_bounds(const double* M, int64_t rows, int64_t cols,
                         const double* lo, const double* up,
                         double* minact, double* maxact) {
  for (int64_t r = 0; r < rows; ++r) {
    const double* row = M + r * cols;
    double mn = 0.0, mx = 0.0;
    for (int64_t c = 0; c < cols; ++c) {
      double a = row[c];
      if (a == 0.0) continue;
      double cmin = a > 0 ? a * lo[c] : a * up[c];
      double cmax = a > 0 ? a * up[c] : a * lo[c];
      mn += cmin;  // inf propagates correctly through IEEE arithmetic
      mx += cmax;
    }
    minact[r] = mn;
    maxact[r] = mx;
  }
}

// Impact-aware tiny-entry removal (one fused pass; the python
// formulation made ~6 full passes over each [N, m, n] block array,
// ~30 s at the 102k-var energy instance).  Zeroes entries that are
// (a) tiny in absolute or row-relative terms AND (b) of negligible
// impact |a| * bound_range(col) < feastol — a tiny coefficient on an
// unbounded variable must stay (reference MODEL_CLEANUP impact rule).
// `range` is [cols] shared across the batch (range_batched == 0) or
// [batch, cols] per-batch.  Non-finite ranges never drop.
int64_t drop_tiny_impact(double* M, int64_t batch, int64_t rows,
                         int64_t cols, const double* range,
                         int64_t range_batched, double feastol,
                         double abs_tol, double rel_tol) {
  int64_t dropped = 0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : dropped) schedule(static)
#endif
  for (int64_t br = 0; br < batch * rows; ++br) {
    const int64_t b = br / rows;
    const double* cr = range + (range_batched ? b * cols : 0);
    double* row = M + br * cols;
    double mx = 0.0;
    for (int64_t c = 0; c < cols; ++c) {
      double a = std::fabs(row[c]);
      if (a > mx) mx = a;
    }
    const double thr = std::fmax(abs_tol, rel_tol * mx);
    for (int64_t c = 0; c < cols; ++c) {
      double a = std::fabs(row[c]);
      if (a > 0.0 && a < thr) {
        double rg = cr[c];
        if (std::isfinite(rg) && a * rg < feastol) {
          row[c] = 0.0;
          ++dropped;
        }
      }
    }
  }
  return dropped;
}

// 3: the MPS reader (mps_reader.cpp) joined the library
int32_t pips_native_abi_version() { return 3; }

}  // extern "C"
