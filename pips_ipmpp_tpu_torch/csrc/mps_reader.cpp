// Native MPS reader core.
//
// Counterpart of the JAX package's native/src/mps_reader.cpp (the same
// source).  The reference's MpsReader is ~2.8k LoC of C++
// (Core/Readers/MpsReader.C) doing tokenization, name interning, and
// section assembly natively; this is the equivalent hot path for the
// port's reader: it parses an MPS file into interned row/column indices +
// COO triplets + rhs/ranges/bounds arrays.  The Python layer (io/mps.py)
// keeps full semantic parity (`read_mps(native=False)`) and the tests hold
// the two parsers equal bit for bit.
//
// Build: pips_ipmpp_tpu_torch/native.py, into one library with
// presolve_kernels.cpp.
//
// Supports: free and fixed format, NAME/OBJSENSE/ROWS/COLUMNS/RHS/RANGES/
// BOUNDS/ENDATA, integer MARKERs (ignored: LP relaxation), later N rows
// as dropped free rows, RHS on the objective row (negated objective
// constant), Fortran 'D' exponents, BOUNDS with or without a set name.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Bound {
  double lo = 0.0;
  double up = kInf;
  bool has_lo = false;   // explicitly set
};

struct MpsData {
  std::string name;
  std::string error;
  bool maximize = false;
  double obj_constant = 0.0;        // already negated per MPS convention
  std::vector<std::string> row_names;   // constraint rows, declaration order
  std::vector<char> row_types;          // 'E', 'L', 'G'
  std::vector<std::string> col_names;
  std::vector<int64_t> coo_r, coo_c;
  std::vector<double> coo_v;
  std::vector<double> obj;              // per column
  std::vector<double> rhs;              // per row
  std::vector<uint8_t> has_rng;
  std::vector<double> rng;
  std::vector<Bound> bounds;            // per column
  std::vector<std::string> free_row_names;   // N rows beyond the first
  int64_t n_bad_ranges = 0;   // RANGES entries on free/objective rows
};

double parse_num(const std::string& tok, bool* ok) {
  std::string t = tok;
  for (auto& ch : t) {
    if (ch == 'D' || ch == 'd') ch = 'E';
  }
  char* end = nullptr;
  double v = std::strtod(t.c_str(), &end);
  *ok = (end && *end == '\0');
  return v;
}

// fixed-format field column ranges, 0-based half-open (matches io/mps.py)
constexpr int kFixed[6][2] = {{1, 3}, {4, 12}, {14, 22},
                              {24, 36}, {39, 47}, {49, 61}};

void split_fixed(const std::string& line, std::vector<std::string>* out) {
  out->clear();
  int len = static_cast<int>(line.size());
  for (auto& f : kFixed) {
    int lo = f[0], hi = std::min(f[1], len);
    if (lo >= len) break;
    std::string s = line.substr(lo, hi - lo);
    size_t b = s.find_first_not_of(" \t");
    if (b == std::string::npos) continue;
    size_t e = s.find_last_not_of(" \t");
    out->push_back(s.substr(b, e - b + 1));
  }
}

void split_free(const std::string& line, std::vector<std::string>* out) {
  out->clear();
  size_t i = 0;
  while (i < line.size()) {
    while (i < line.size() && std::isspace(static_cast<unsigned char>(line[i]))) ++i;
    size_t j = i;
    while (j < line.size() && !std::isspace(static_cast<unsigned char>(line[j]))) ++j;
    if (j > i) out->push_back(line.substr(i, j - i));
    i = j;
  }
}

std::string upper(std::string s) {
  for (auto& c : s) c = std::toupper(static_cast<unsigned char>(c));
  return s;
}

bool parse_file(const char* path, bool fixed, MpsData* d) {
  FILE* fh = std::fopen(path, "r");
  if (!fh) {
    d->error = "cannot open file";
    return false;
  }
  std::unordered_map<std::string, int64_t> row_idx;  // constraint rows
  std::unordered_map<std::string, int64_t> col_idx;
  std::unordered_map<std::string, char> free_rows;
  std::string obj_row;
  bool have_obj_row = false;
  std::string section;
  std::vector<std::string> parts;
  char buf[8192];

  auto get_col = [&](const std::string& cn) -> int64_t {
    auto it = col_idx.find(cn);
    if (it != col_idx.end()) return it->second;
    int64_t j = static_cast<int64_t>(d->col_names.size());
    col_idx.emplace(cn, j);
    d->col_names.push_back(cn);
    d->obj.push_back(0.0);
    d->bounds.emplace_back();
    return j;
  };

  while (std::fgets(buf, sizeof(buf), fh)) {
    std::string line(buf);
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    size_t first_ns = line.find_first_not_of(" \t");
    if (first_ns == std::string::npos || line[first_ns] == '*') continue;
    if (first_ns == 0) {  // section header
      split_free(line, &parts);
      section = upper(parts[0]);
      if (section == "NAME" && parts.size() > 1) d->name = parts[1];
      if (section == "OBJSENSE" && parts.size() > 1) {
        std::string s = upper(parts[1]);
        d->maximize = (s == "MAX" || s == "MAXIMIZE");
      }
      if (section == "ENDATA") break;
      continue;
    }
    if (fixed) split_fixed(line, &parts);
    else split_free(line, &parts);
    if (parts.empty()) continue;

    if (section == "OBJSENSE") {
      std::string s = upper(parts[0]);
      d->maximize = (s == "MAX" || s == "MAXIMIZE");
    } else if (section == "ROWS") {
      if (parts.size() < 2) continue;
      std::string typ = upper(parts[0]);
      const std::string& nm = parts[1];
      if (typ == "N") {
        if (!have_obj_row) {
          obj_row = nm;
          have_obj_row = true;
        } else {
          free_rows.emplace(nm, 'N');
          d->free_row_names.push_back(nm);
        }
      } else {
        // any non-N type letter is stored (parity with the Python
        // parser, which records unknown types and treats them as
        // ranged-E at assembly)
        row_idx.emplace(nm, static_cast<int64_t>(d->row_names.size()));
        d->row_names.push_back(nm);
        d->row_types.push_back(typ.empty() ? 'E' : typ[0]);
        d->rhs.push_back(0.0);
        d->has_rng.push_back(0);
        d->rng.push_back(0.0);
      }
    } else if (section == "COLUMNS") {
      if (parts.size() >= 3 && upper(parts[1]) == "'MARKER'") continue;
      int64_t j = get_col(parts[0]);
      for (size_t k = 1; k + 1 < parts.size(); k += 2) {
        bool ok = false;
        double v = parse_num(parts[k + 1], &ok);
        if (!ok) {
          d->error = "bad number in COLUMNS: " + parts[k + 1];
          std::fclose(fh);
          return false;
        }
        const std::string& rn = parts[k];
        if (have_obj_row && rn == obj_row) {
          d->obj[j] += v;
        } else {
          auto it = row_idx.find(rn);
          if (it != row_idx.end()) {
            d->coo_r.push_back(it->second);
            d->coo_c.push_back(j);
            d->coo_v.push_back(v);
          }
          // undeclared/free rows: silently dropped (parity with io/mps.py
          // which warns; the Python wrapper re-checks names when needed)
        }
      }
    } else if (section == "RHS" || section == "RANGES") {
      size_t start = (parts.size() % 2 == 1) ? 1 : 0;
      for (size_t k = start; k + 1 < parts.size(); k += 2) {
        bool ok = false;
        double v = parse_num(parts[k + 1], &ok);
        if (!ok) {
          // malformed values must ERROR, not silently zero the entry
          // (the Python parser raises ValueError here)
          d->error = "bad number in " + section + ": " + parts[k + 1];
          std::fclose(fh);
          return false;
        }
        auto it = row_idx.find(parts[k]);
        if (it != row_idx.end()) {
          if (section == "RHS") {
            d->rhs[it->second] = v;
          } else {
            d->has_rng[it->second] = 1;
            d->rng[it->second] = v;
          }
        } else if (section == "RHS" && have_obj_row && parts[k] == obj_row) {
          d->obj_constant = -v;
        } else if (section == "RANGES" &&
                   ((have_obj_row && parts[k] == obj_row) ||
                    free_rows.count(parts[k]))) {
          ++d->n_bad_ranges;   // invalid: surfaced as a Python warning
        }
      }
    } else if (section == "BOUNDS") {
      std::string typ = upper(parts[0]);
      bool needs_val = (typ == "LO" || typ == "UP" || typ == "FX" ||
                        typ == "LI" || typ == "UI");
      std::string cn;
      double val = 0.0;
      if (needs_val) {
        bool ok = false;
        if (parts.size() >= 4) {
          cn = parts[2];
          val = parse_num(parts[3], &ok);
        } else if (parts.size() >= 3) {
          cn = parts[1];
          val = parse_num(parts[2], &ok);
        }
        if (!ok) {
          d->error = "bad number in BOUNDS: "
                     + (parts.size() >= 3 ? parts.back() : line);
          std::fclose(fh);
          return false;
        }
      } else {
        if (parts.size() >= 3) cn = parts[2];
        else if (parts.size() >= 2) cn = parts[1];
        else continue;
      }
      auto it = col_idx.find(cn);
      if (it == col_idx.end()) continue;
      Bound& b = d->bounds[it->second];
      if (typ == "LO" || typ == "LI") {
        b.lo = val;
        b.has_lo = true;
      } else if (typ == "UP" || typ == "UI") {
        b.up = val;
        if (val < 0 && !b.has_lo) b.lo = -kInf;
      } else if (typ == "FX") {
        b.lo = b.up = val;
        b.has_lo = true;
      } else if (typ == "FR" || typ == "MI") {
        b.lo = -kInf;
        b.has_lo = true;
      } else if (typ == "PL") {
        b.up = kInf;
      } else if (typ == "BV") {
        b.lo = 0.0;
        b.up = 1.0;
        b.has_lo = true;
      }
    }
  }
  std::fclose(fh);
  if (!have_obj_row) {
    d->error = "no objective (N) row";
    return false;
  }
  d->error.clear();
  // the objective row's name rides as the LAST row_names entry (the name
  // accessor documents index n_rows as the objective row)
  d->row_names.push_back(obj_row);
  return true;
}

}  // namespace

extern "C" {

void* mps_open(const char* path, int32_t fixed_format) {
  auto* d = new MpsData();
  if (!parse_file(path, fixed_format != 0, d)) {
    // keep handle alive so the error is readable; sizes report -1
    return d;
  }
  return d;
}

const char* mps_error(void* h) {
  auto* d = static_cast<MpsData*>(h);
  return d->error.c_str();
}

int64_t mps_n_rows(void* h) {
  auto* d = static_cast<MpsData*>(h);
  if (!d->error.empty()) return -1;
  return static_cast<int64_t>(d->row_types.size());
}

int64_t mps_n_cols(void* h) {
  auto* d = static_cast<MpsData*>(h);
  if (!d->error.empty()) return -1;
  return static_cast<int64_t>(d->col_names.size());
}

int64_t mps_nnz(void* h) {
  auto* d = static_cast<MpsData*>(h);
  if (!d->error.empty()) return -1;
  return static_cast<int64_t>(d->coo_v.size());
}

int32_t mps_maximize(void* h) {
  return static_cast<MpsData*>(h)->maximize ? 1 : 0;
}

double mps_obj_constant(void* h) {
  return static_cast<MpsData*>(h)->obj_constant;
}

// Fills caller-allocated arrays:
//   row_types [n_rows] int8 ('E','L','G'), rhs [n_rows], has_rng/rng,
//   coo_r/coo_c/coo_v [nnz], obj [n_cols], lo/up [n_cols]
void mps_fill(void* h, int8_t* row_types, double* rhs, uint8_t* has_rng,
              double* rng, int64_t* coo_r, int64_t* coo_c, double* coo_v,
              double* obj, double* lo, double* up) {
  auto* d = static_cast<MpsData*>(h);
  int64_t m = static_cast<int64_t>(d->row_types.size());
  for (int64_t r = 0; r < m; ++r) {
    row_types[r] = static_cast<int8_t>(d->row_types[r]);
    rhs[r] = d->rhs[r];
    has_rng[r] = d->has_rng[r];
    rng[r] = d->rng[r];
  }
  int64_t nnz = static_cast<int64_t>(d->coo_v.size());
  std::memcpy(coo_r, d->coo_r.data(), nnz * sizeof(int64_t));
  std::memcpy(coo_c, d->coo_c.data(), nnz * sizeof(int64_t));
  std::memcpy(coo_v, d->coo_v.data(), nnz * sizeof(double));
  int64_t n = static_cast<int64_t>(d->col_names.size());
  for (int64_t j = 0; j < n; ++j) {
    obj[j] = d->obj[j];
    lo[j] = d->bounds[j].lo;
    up[j] = d->bounds[j].up;
  }
}

// name accessors: i in [0, n_rows) = constraint rows; i == n_rows = the
// objective row's name (parse_file appends it)
const char* mps_row_name(void* h, int64_t i) {
  auto* d = static_cast<MpsData*>(h);
  if (i < 0 || i >= static_cast<int64_t>(d->row_names.size())) return "";
  return d->row_names[i].c_str();
}

const char* mps_col_name(void* h, int64_t j) {
  auto* d = static_cast<MpsData*>(h);
  if (j < 0 || j >= static_cast<int64_t>(d->col_names.size())) return "";
  return d->col_names[j].c_str();
}

int64_t mps_n_bad_ranges(void* h) {
  return static_cast<MpsData*>(h)->n_bad_ranges;
}

int64_t mps_n_free_rows(void* h) {
  return static_cast<int64_t>(
      static_cast<MpsData*>(h)->free_row_names.size());
}

const char* mps_free_row_name(void* h, int64_t i) {
  auto* d = static_cast<MpsData*>(h);
  if (i < 0 || i >= static_cast<int64_t>(d->free_row_names.size()))
    return "";
  return d->free_row_names[i].c_str();
}

const char* mps_problem_name(void* h) {
  return static_cast<MpsData*>(h)->name.c_str();
}

void mps_close(void* h) { delete static_cast<MpsData*>(h); }

}  // extern "C"
