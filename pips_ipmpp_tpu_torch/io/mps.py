"""MPS-format reader producing a DenseLP (the serial path; reference
Core/Readers/MpsReader.C).  Counterpart of `pips_ipmpp_tpu/io/mps.py`:
the same parsers and the same assembly, so both packages read a file into
the same arrays bit for bit.  The LP is dense and built on the host
(`device="cpu"` by default, like `io/blockfile.read_blocks`): an f64 LP
on the CPU shares the assembled numpy arrays without a copy.

Supports both FREE format (whitespace-separated) and FIXED format
(column-position fields, names may contain embedded blanks): NAME, ROWS
(N/E/L/G), COLUMNS (incl. integrality MARKERs, ignored: LP relaxation),
RHS (incl. an entry on the objective row = negated objective constant),
RANGES (L/G/E semantics; RANGES on N rows is invalid and ignored with a
warning), BOUNDS (LO/UP/FX/FR/MI/PL/BV/LI/UI, with or without a bound-set
name), OBJSENSE, ENDATA.  Later N rows beyond the first are free rows and
are dropped per the MPS spec (their COLUMNS entries are ignored).
Fortran 'D' exponents (1.5D+02) are accepted.  Default variable bounds:
x >= 0.

`native=True` (the default) parses with the C++ tokenizer of
`csrc/mps_reader.cpp` (`native.mps_parse`) and raises when that library
cannot be built; `native=False` runs the Python parser."""
from __future__ import annotations

import warnings
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.lp import DenseLP

# fixed-format field column ranges (1-based inclusive per the MPS spec;
# stored 0-based half-open): field 1 cols 2-3, 2: 5-12, 3: 15-22,
# 4: 25-36, 5: 40-47, 6: 50-61
_FIXED_FIELDS = ((1, 3), (4, 12), (14, 22), (24, 36), (39, 47), (49, 61))


@dataclass
class MpsInfo:
    """Side-channel metadata from a parse (names allow solution write-back;
    the objective constant keeps getObjective exact for files using an RHS
    entry on the N row)."""
    name: str = ""
    objective_row: str = ""
    objective_constant: float = 0.0
    maximize: bool = False
    row_names: list = field(default_factory=list)   # constraint rows, order
    col_names: list = field(default_factory=list)
    free_rows: list = field(default_factory=list)   # N rows beyond the first


def _num(tok: str) -> float:
    """MPS numeric literal; accepts Fortran D exponents."""
    try:
        return float(tok)
    except ValueError:
        return float(tok.upper().replace("D", "E"))


def _split_fixed(line: str):
    """Field extraction at the fixed-format column positions."""
    out = []
    for lo, hi in _FIXED_FIELDS:
        f = line[lo:hi].strip()
        if f:
            out.append(f)
    return out


def read_mps(path: str, dtype=torch.float64, format: str = "free",
             native: bool = True, device="cpu") -> DenseLP:
    lp, _ = read_mps_with_info(path, dtype=dtype, format=format,
                               native=native, device=device)
    return lp


def _assemble_lp(eq_rows, iq_rows, row_type, rhs_of, rng_of, coo, obj,
                 bounds_lo, bounds_up, dtype, device):
    """Shared LP assembly from parsed row/column data.

    `coo` = (r_idx, c_idx, values) with row indices into the declaration
    order; duplicate entries sum (MPS semantics)."""
    n = len(obj)
    mE, mI = len(eq_rows), len(iq_rows)
    A = np.zeros((mE, n))
    C = np.zeros((mI, n))
    b = np.zeros(mE)
    iclow = np.zeros(mI)
    clow = np.zeros(mI)
    icupp = np.zeros(mI)
    cupp = np.zeros(mI)

    # declaration-order row -> (is_eq, position)
    pos = np.full(len(row_type), -1, np.int64)
    is_eq = np.zeros(len(row_type), bool)
    for i, r in enumerate(eq_rows):
        pos[r] = i
        is_eq[r] = True
    for i, r in enumerate(iq_rows):
        pos[r] = i
    cr, cc, cv = coo
    eqm = is_eq[cr]
    np.add.at(A, (pos[cr[eqm]], cc[eqm]), cv[eqm])
    np.add.at(C, (pos[cr[~eqm]], cc[~eqm]), cv[~eqm])

    for r in eq_rows:
        b[pos[r]] = rhs_of(r)
    for r in iq_rows:
        i = pos[r]
        t = row_type[r]
        rv = rhs_of(r)
        rng = rng_of(r)
        if t == "L":
            icupp[i], cupp[i] = 1.0, rv
            if rng is not None:
                iclow[i], clow[i] = 1.0, rv - abs(rng)
        elif t == "G":
            iclow[i], clow[i] = 1.0, rv
            if rng is not None:
                icupp[i], cupp[i] = 1.0, rv + abs(rng)
        else:  # ranged E row
            if rng is None:
                rng = 0.0
            lo, up = ((rv, rv + rng) if rng >= 0 else (rv + rng, rv))
            iclow[i], clow[i] = 1.0, lo
            icupp[i], cupp[i] = 1.0, up

    ixlow = np.isfinite(bounds_lo).astype(float)
    xlow = np.where(ixlow > 0, bounds_lo, 0.0)
    ixupp = np.isfinite(bounds_up).astype(float)
    xupp = np.where(ixupp > 0, bounds_up, 0.0)

    def f(v):
        # an f64 CPU tensor shares the numpy array: no second copy of A, C
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    return DenseLP(c=f(obj), A=f(A), b=f(b), C=f(C),
                   iclow=f(iclow), clow=f(clow), icupp=f(icupp),
                   cupp=f(cupp), ixlow=f(ixlow), xlow=f(xlow),
                   ixupp=f(ixupp), xupp=f(xupp))


def _read_mps_native(path, dtype, fixed, device):
    """DenseLP via the native C++ tokenizer (csrc/mps_reader.cpp, the
    role of the reference's C++ MpsReader.C); raises when the library
    cannot be built."""
    from pips_ipmpp_tpu_torch import native
    parsed = native.mps_parse(path, fixed=fixed)
    if parsed["n_bad_ranges"]:
        warnings.warn("MPS: RANGES entry on free/objective row is "
                      "invalid; ignored")
    rt = parsed["row_types"]
    types = np.array([chr(t) for t in rt])
    has_rng = parsed["has_rng"]
    m = len(rt)
    eq_rows = [r for r in range(m) if types[r] == "E" and not has_rng[r]]
    iq_rows = [r for r in range(m) if types[r] != "E" or has_rng[r]]
    obj = parsed["obj"].copy()
    if parsed["maximize"]:
        obj = -obj
    lp = _assemble_lp(
        eq_rows, iq_rows, types,
        rhs_of=lambda r: float(parsed["rhs"][r]),
        rng_of=lambda r: (float(parsed["rng"][r]) if has_rng[r] else None),
        coo=(parsed["coo_r"], parsed["coo_c"], parsed["coo_v"]),
        obj=obj, bounds_lo=parsed["lo"], bounds_up=parsed["up"],
        dtype=dtype, device=device)
    info = MpsInfo(
        name=parsed["name"], objective_row=parsed["objective_row"],
        objective_constant=parsed["obj_constant"],
        maximize=parsed["maximize"],
        row_names=[parsed["row_names"][r] for r in eq_rows + iq_rows],
        col_names=list(parsed["col_names"]),
        free_rows=list(parsed["free_rows"]))
    return lp, info


def read_mps_with_info(path: str, dtype=torch.float64, format: str = "free",
                       native: bool = True,
                       device="cpu") -> tuple[DenseLP, MpsInfo]:
    if format not in ("free", "fixed"):
        raise ValueError(f"format must be 'free' or 'fixed', got {format!r}")
    if native:
        return _read_mps_native(path, dtype, format == "fixed", device)
    split = _split_fixed if format == "fixed" else str.split

    info = MpsInfo()
    obj_row = None
    rows = OrderedDict()      # name -> type in {E, L, G}
    cols = OrderedDict()      # name -> {row: val}
    obj = {}
    rhs = {}
    ranges = {}
    bounds = {}               # col -> dict(lo=, up=, ...)
    maximize = False
    free_rows = set()

    section = None
    with open(path) as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("*"):
                continue
            if not line[0].isspace():
                parts = line.split()
                section = parts[0].upper()
                if section == "NAME" and len(parts) > 1:
                    info.name = parts[1]
                if section == "OBJSENSE" and len(parts) > 1:
                    maximize = parts[1].upper() in ("MAX", "MAXIMIZE")
                continue
            parts = split(line)
            if section == "OBJSENSE":
                maximize = parts[0].upper() in ("MAX", "MAXIMIZE")
            elif section == "ROWS":
                typ, name = parts[0].upper(), parts[1]
                if typ == "N":
                    if obj_row is None:
                        obj_row = name
                    else:
                        # later N rows are free rows: recorded, then dropped
                        # (reference MpsReader skips them the same way)
                        free_rows.add(name)
                else:
                    rows[name] = typ
            elif section == "COLUMNS":
                if len(parts) >= 3 and parts[1].upper() == "'MARKER'":
                    continue  # integer markers ignored (LP relaxation)
                col = parts[0]
                cols.setdefault(col, {})
                for k in range(1, len(parts) - 1, 2):
                    rname, val = parts[k], _num(parts[k + 1])
                    if rname == obj_row:
                        obj[col] = obj.get(col, 0.0) + val
                    elif rname in rows:
                        cols[col][rname] = cols[col].get(rname, 0.0) + val
                    elif rname not in free_rows:
                        warnings.warn(
                            f"MPS: COLUMNS entry for undeclared row "
                            f"{rname!r} ignored")
            elif section == "RHS":
                start = 1 if len(parts) % 2 == 1 else 0
                for k in range(start, len(parts) - 1, 2):
                    if parts[k] in rows:
                        rhs[parts[k]] = _num(parts[k + 1])
                    elif parts[k] == obj_row:
                        # RHS on the objective row: NEGATED objective
                        # constant (MPS convention)
                        info.objective_constant = -_num(parts[k + 1])
            elif section == "RANGES":
                start = 1 if len(parts) % 2 == 1 else 0
                for k in range(start, len(parts) - 1, 2):
                    if parts[k] in rows:
                        ranges[parts[k]] = _num(parts[k + 1])
                    elif parts[k] == obj_row or parts[k] in free_rows:
                        warnings.warn(
                            f"MPS: RANGES entry on free/objective row "
                            f"{parts[k]!r} is invalid; ignored")
            elif section == "BOUNDS":
                typ = parts[0].upper()
                needs_val = typ in ("LO", "UP", "FX", "LI", "UI")
                # the bound-set name (field 2) is optional: a value-bearing
                # line has 4 fields with it, 3 without; a valueless line
                # (FR/MI/PL/BV) has 3 with it, 2 without
                if needs_val:
                    col, val = (parts[2], _num(parts[3])) if len(parts) >= 4 \
                        else (parts[1], _num(parts[2]))
                else:
                    col = parts[2] if len(parts) >= 3 else parts[1]
                    val = 0.0
                b = bounds.setdefault(col, {})
                if typ in ("LO", "LI"):
                    b["lo"] = val
                elif typ in ("UP", "UI"):
                    b["up"] = val
                    if val < 0 and "lo" not in b:
                        b["lo"] = -np.inf
                elif typ == "FX":
                    b["lo"] = b["up"] = val
                elif typ in ("FR", "MI"):
                    b["lo"] = -np.inf
                elif typ == "PL":
                    b["up"] = np.inf
                elif typ == "BV":
                    b["lo"], b["up"] = 0.0, 1.0
            elif section == "ENDATA":
                break

    col_names = list(cols.keys())
    col_idx = {cn: j for j, cn in enumerate(col_names)}
    n = len(col_names)

    row_list = list(rows.keys())           # declaration order
    row_pos = {rn: i for i, rn in enumerate(row_list)}
    types = np.array([rows[rn] for rn in row_list]) if row_list else \
        np.zeros(0, dtype="<U1")
    eq_rows = [row_pos[r] for r, t in rows.items()
               if t == "E" and r not in ranges]
    iq_rows = [row_pos[r] for r, t in rows.items()
               if t != "E" or r in ranges]

    coo_r, coo_c, coo_v = [], [], []
    for cn, entries in cols.items():
        j = col_idx[cn]
        for rn, val in entries.items():
            coo_r.append(row_pos[rn])
            coo_c.append(j)
            coo_v.append(val)

    lo_arr = np.zeros(n)
    up_arr = np.full(n, np.inf)
    for cn, bset in bounds.items():
        if cn not in col_idx:
            continue
        j = col_idx[cn]
        lo_arr[j] = bset.get("lo", 0.0)
        up_arr[j] = bset.get("up", np.inf)

    c = np.array([obj.get(cn, 0.0) for cn in col_names])
    if maximize:
        c = -c

    lp = _assemble_lp(
        eq_rows, iq_rows, types,
        rhs_of=lambda r: rhs.get(row_list[r], 0.0),
        rng_of=lambda r: ranges.get(row_list[r]),
        coo=(np.asarray(coo_r, np.int64), np.asarray(coo_c, np.int64),
             np.asarray(coo_v, np.float64)),
        obj=c, bounds_lo=lo_arr, bounds_up=up_arr, dtype=dtype,
        device=device)

    info.objective_row = obj_row or ""
    info.maximize = maximize
    info.row_names = [row_list[r] for r in eq_rows + iq_rows]
    info.col_names = col_names
    info.free_rows = sorted(free_rows)
    return lp, info
