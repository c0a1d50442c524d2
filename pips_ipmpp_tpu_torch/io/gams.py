"""Mini-parser for the reference's GAMSsmall instance format.

The reference validates itself against tiny hand-written GAMS LPs
(Drivers/gams/simple/GAMSsmall/*.gms) whose recorded objectives and
iteration counts live in Test/IntegrationTests/gamssmall_instance_data.txt.
Those files use a very small, uniform subset of GAMS:

    Set i rows / i1*iN /  [ii ineqrows / ii1*iiK /]  j columns / j1*jM /;
    parameter g(j) .. / j1 2, ... /  b(i) .. / i1 -2, ... /  cupp(i) / ... /
    Table A(i,j) <column-aligned table> ;
    [Positive] Variables x(j) [/ j1.lo 1, j3.up 1, ... /];
    e(i)..  sum(j, A(i,j)*x(j)) =e= b(i);
    le(i).. sum(j, C(i,j)*x(j)) =l= cupp(i);
    x.stage('j3') = 2;  e.stage('i4') = 2;   (PIPS block annotations)

This module parses that subset (and only it) so the instances can be
converted into ArrowheadLP fixtures for golden regression tests — the
role of the reference's gmspips GDX reader for these tests
(Test/Drivers/t_gmspips_reader.cpp, gmspips_reader.hpp:19-30), without
GAMS or GDX.  Counterpart of `pips_ipmpp_tpu/io/gams.py`: the same parser
and assembly, so both packages turn a file into the same arrays bit for
bit.  The stage convention matches gmspips with `numBlocks`
files: variable stage 1 -> first stage (block 0), stage s in 2..numBlocks
-> block s-1; equation stage s <= numBlocks -> rows of block s-1,
stage numBlocks+1 -> linking rows.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_NUM = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"


@dataclass
class GmsModel:
    sets: dict                  # prefix -> size ("i": 16, "ii": 19, "j": 14)
    params: dict                # name -> {label: value}
    tables: dict                # name -> (rowset, {(rowlabel, collabel): v})
    var_positive: bool
    var_bounds: dict            # label -> {"lo": v, "up": v}
    eq_defs: list               # (family, rowset, matname, sense, rhsname)
    stages: dict                # (symbol, label) -> stage (symbol "x"/family)
    starred_bounds: bool = False  # bounds list was preceded by a bare '*'


def _decomment(text: str) -> str:
    """Drop '*'-in-column-1 comment lines and $-directive lines."""
    out = []
    for line in text.splitlines():
        if line.startswith("*") or line.lstrip().startswith("$"):
            continue
        out.append(line)
    return "\n".join(out)


def parse_gms(text: str) -> GmsModel:
    # stage annotations live inside the $ifthen PIPS block; grab them from
    # the raw text before stripping directives
    stages = {}
    for sym, lab, st in re.findall(
            r"(\w+)\.stage\(\s*'(\w+)'\s*\)\s*=\s*(\d+)", text):
        stages[(sym, lab)] = int(st)

    body = _decomment(text)

    # ---- sets: every "p1*pN" range defines set with prefix p, size N ----
    sets = {}
    for pre, lo, pre2, hi in re.findall(r"\b([a-zA-Z]+)(\d+)\s*\*\s*"
                                        r"([a-zA-Z]+)(\d+)", body):
        if pre == pre2 and int(lo) == 1:
            sets[pre] = max(sets.get(pre, 0), int(hi))

    # ---- tables (parse before masking regions) ----
    tables = {}
    lines = body.splitlines()
    i = 0
    while i < len(lines):
        m = re.match(r"\s*Table\s+(\w+)\s*\(\s*(\w+)\s*,\s*j\s*\)",
                     lines[i], re.IGNORECASE)
        if not m:
            i += 1
            continue
        name, rowset = m.group(1), m.group(2)
        i += 1
        # first non-empty line = column header
        while i < len(lines) and not lines[i].strip():
            i += 1
        header = lines[i]
        cols = [(mm.group(0), mm.start(), mm.end())
                for mm in re.finditer(r"\S+", header)]
        i += 1
        entries = {}
        while i < len(lines):
            line = lines[i]
            if line.strip().startswith(";"):
                break
            if line.strip():
                toks = list(re.finditer(r"\S+", line))
                rowlab = toks[0].group(0)
                for tk in toks[1:]:
                    v = tk.group(0).rstrip(";")
                    if not v:
                        continue
                    # assign to the header column with maximal span overlap
                    best, bestov = None, 0
                    for lab, s, e in cols:
                        ov = min(e, tk.end()) - max(s, tk.start())
                        if ov > bestov:
                            best, bestov = lab, ov
                    if best is None:
                        raise ValueError(
                            f"table {name}: value {v!r} in row {rowlab} "
                            f"not under any column header")
                    entries[(rowlab, best)] = float(v)
                if line.rstrip().endswith(";"):
                    break
            i += 1
        tables[name] = (rowset, entries)
        i += 1

    # mask out table bodies so their numbers don't confuse later regexes
    body_nt = re.sub(r"Table\s+\w+\s*\([^)]*\).*?(?:\n\s*;|;\s*\n)", "\n",
                     body, flags=re.DOTALL | re.IGNORECASE)

    # ---- variables declaration (+ optional bounds data list) ----
    var_positive = False
    var_bounds: dict = {}
    starred = False
    vm = re.search(r"(Positive\s+)?Variables?\s+x\s*\(\s*j\s*\)([^;]*)",
                   body_nt, re.IGNORECASE)
    if vm:
        var_positive = bool(vm.group(1))
        rest = vm.group(2)
        # stop at the next declaration keyword (files often omit the ';')
        stop = re.search(r"\b(Variable|Equation|Table|parameter|Set|Model)\b",
                         rest, re.IGNORECASE)
        if stop:
            rest = rest[:stop.start()]
        bm = re.search(r"(\*?)\s*/(.*?)/", rest, re.DOTALL)
        if bm:
            starred = bm.group(1) == "*"
            for lab, attr, val in re.findall(
                    rf"(\w+)\.(lo|up|fx)\s+({_NUM})", bm.group(2)):
                b = var_bounds.setdefault(lab, {})
                if attr == "fx":
                    b["lo"] = b["up"] = float(val)
                else:
                    b[attr] = float(val)

    # ---- parameter data lists (between 'parameter' and the vars/tables) ---
    params: dict = {}
    pm = re.search(r"\bparameters?\b", body_nt, re.IGNORECASE)
    if pm:
        pend = re.search(r"\b(Table|Variables?|Equations?)\b",
                         body_nt[pm.end():], re.IGNORECASE)
        region = body_nt[pm.end():pm.end() + pend.start()] if pend \
            else body_nt[pm.end():]
        for name, _sym, entries in re.findall(
                r"(\w+)\s*\(\s*(\w+)\s*\)[^/]*?/\s*([^/]*?)\s*/",
                region, re.DOTALL):
            d = {}
            for lab, val in re.findall(rf"(\w+)\s+({_NUM})", entries):
                d[lab] = float(val)
            params[name] = d

    # ---- equation definitions ----
    eq_defs = []
    for fam, rowset, mat, sense, rhs in re.findall(
            r"(\w+)\s*\(\s*(\w+)\s*\)\s*\.\.\s*sum\s*\(\s*j\s*,\s*(\w+)\s*"
            r"\(\s*\w+\s*,\s*j\s*\)\s*\*\s*x\s*\(\s*j\s*\)\s*\)\s*"
            r"=([elg])=\s*(\w+)\s*\(\s*\w+\s*\)", body_nt):
        eq_defs.append((fam, rowset, mat, sense, rhs))

    return GmsModel(sets=sets, params=params, tables=tables,
                    var_positive=var_positive, var_bounds=var_bounds,
                    eq_defs=eq_defs, stages=stages,
                    starred_bounds=starred)


def gms_to_block_data(model: GmsModel, num_blocks: int,
                      starred_bounds_active: bool = True):
    """Assemble parsed GAMS data into (blocks, first_stage, linking_eq,
    linking_ineq) dicts for `make_arrowhead_lp`.

    `num_blocks` is the gmspips file count (N+1 including block 0) from the
    instance table.  `starred_bounds_active` controls whether a bounds list
    written as `x(j) * / ... /` is honored (GAMS reads the bare '*' as
    explanatory text, so the list is active; flag kept for experiments).
    """
    K = num_blocks
    nj = model.sets["j"]
    jlabels = [f"j{k + 1}" for k in range(nj)]

    # variable -> block
    vstage = {lab: model.stages.get(("x", lab), 1) for lab in jlabels}
    for lab, s in vstage.items():
        if not 1 <= s <= K:
            raise ValueError(f"var {lab} stage {s} out of range 1..{K}")
    block_vars = [[lab for lab in jlabels if vstage[lab] == s + 1]
                  for s in range(K)]  # block_vars[0] = first stage
    vcol = {lab: (vstage[lab] - 1, block_vars[vstage[lab] - 1].index(lab))
            for lab in jlabels}

    g = model.params.get("g", {})

    def bounds_for(labs):
        n = len(labs)
        ixlow = np.zeros(n); xlow = np.zeros(n)
        ixupp = np.zeros(n); xupp = np.zeros(n)
        for k, lab in enumerate(labs):
            lo = up = None
            if model.var_positive:
                lo = 0.0
            b = model.var_bounds.get(lab)
            if b is not None and (not model.starred_bounds
                                  or starred_bounds_active):
                lo = b.get("lo", lo)
                up = b.get("up", up)
            if lo is not None:
                ixlow[k] = 1.0; xlow[k] = lo
            if up is not None:
                ixupp[k] = 1.0; xupp[k] = up
        return ixlow, xlow, ixupp, xupp

    # rows, classified per (block, kind) with kind in {eq, ineq}
    # each entry: (coeff dict col-label -> v, rhs value, sense)
    rows = {(b, kind): [] for b in range(K + 1) for kind in ("eq", "ineq")}
    # b == K means linking rows
    for fam, rowset, mat, sense, rhsname in model.eq_defs:
        nrows = model.sets[rowset]
        _rs, entries = model.tables[mat]
        rhs = model.params.get(rhsname, {})
        for r in range(nrows):
            rlab = f"{rowset}{r + 1}"
            s = max(model.stages.get((fam, rlab), 1), 1)
            if s > K + 1:
                raise ValueError(f"row {fam}({rlab}) stage {s} "
                                 f"out of range 1..{K + 1}")
            coeffs = {jl: entries[(rlab, jl)] for jl in jlabels
                      if (rlab, jl) in entries}
            # rows whose coefficients span several blocks (or a block other
            # than the annotated one) can only live in the linking strip;
            # promote them there (LP-equivalent — some GAMSsmall stress
            # instances like example_breakSingletonRows annotate such rows
            # into a block).
            touched = {vcol[jl][0] for jl in coeffs} - {0}
            if s <= K and (len(touched) > 1
                           or (touched and touched != {s - 1})):
                s = K + 1
            kind = "eq" if sense == "e" else "ineq"
            rows[(s - 1, kind)].append((coeffs, rhs.get(rlab, 0.0), sense))

    n0 = len(block_vars[0])

    def build_matrix(rowlist, labs_border, labs_diag, blk):
        mE = len(rowlist)
        A = np.zeros((mE, len(labs_border)))
        B = np.zeros((mE, len(labs_diag)))
        for r, (coeffs, _rhs, _s) in enumerate(rowlist):
            for jl, v in coeffs.items():
                bidx, col = vcol[jl]
                if bidx == 0:
                    A[r, col] = v
                elif bidx == blk:
                    B[r, col] = v
                else:
                    raise ValueError(
                        f"coefficient on {jl} (block {bidx}) appears in a "
                        f"block-{blk} row — not arrowhead")
        return A, B

    def ineq_sides(rowlist):
        mI = len(rowlist)
        iclow = np.zeros(mI); clow = np.zeros(mI)
        icupp = np.zeros(mI); cupp = np.zeros(mI)
        for r, (_c, rhs, s) in enumerate(rowlist):
            if s == "l":
                icupp[r] = 1.0; cupp[r] = rhs
            elif s == "g":
                iclow[r] = 1.0; clow[r] = rhs
        return iclow, clow, icupp, cupp

    # first stage
    eq0 = rows[(0, "eq")]
    iq0 = rows[(0, "ineq")]
    A0, _ = build_matrix(eq0, block_vars[0], [], 0)
    C0, _ = build_matrix(iq0, block_vars[0], [], 0)
    iclow0, clow0, icupp0, cupp0 = ineq_sides(iq0)
    ixlow0, xlow0, ixupp0, xupp0 = bounds_for(block_vars[0])
    eql = rows[(K, "eq")]
    iql = rows[(K, "ineq")]
    F0, _ = build_matrix(
        [({jl: v for jl, v in c.items() if vcol[jl][0] == 0}, r, s)
         for c, r, s in eql], block_vars[0], [], 0)
    G0, _ = build_matrix(
        [({jl: v for jl, v in c.items() if vcol[jl][0] == 0}, r, s)
         for c, r, s in iql], block_vars[0], [], 0)

    first = dict(c=np.array([g.get(l, 0.0) for l in block_vars[0]]),
                 A=A0, b=np.array([r for _c, r, _s in eq0]),
                 C=C0, iclow=iclow0, clow=clow0, icupp=icupp0, cupp=cupp0,
                 ixlow=ixlow0, xlow=xlow0, ixupp=ixupp0, xupp=xupp0,
                 F0=F0, G0=G0)

    blocks = []
    for blk in range(1, K):
        labs = block_vars[blk]
        eqb = rows[(blk, "eq")]
        iqb = rows[(blk, "ineq")]
        A, B = build_matrix(eqb, block_vars[0], labs, blk)
        C, D = build_matrix(iqb, block_vars[0], labs, blk)
        iclow, clow, icupp, cupp = ineq_sides(iqb)
        ixlow, xlow, ixupp, xupp = bounds_for(labs)
        Fl = np.zeros((len(eql), len(labs)))
        for r, (coeffs, _rhs, _s) in enumerate(eql):
            for jl, v in coeffs.items():
                bidx, col = vcol[jl]
                if bidx == blk:
                    Fl[r, col] = v
        Gl = np.zeros((len(iql), len(labs)))
        for r, (coeffs, _rhs, _s) in enumerate(iql):
            for jl, v in coeffs.items():
                bidx, col = vcol[jl]
                if bidx == blk:
                    Gl[r, col] = v
        blocks.append(dict(
            c=np.array([g.get(l, 0.0) for l in labs]),
            A=A, B=B, b=np.array([r for _c, r, _s in eqb]),
            C=C, D=D, iclow=iclow, clow=clow, icupp=icupp, cupp=cupp,
            ixlow=ixlow, xlow=xlow, ixupp=ixupp, xupp=xupp, F=Fl, G=Gl))

    linking_eq = {"b": np.array([r for _c, r, _s in eql])}
    li_iclow, li_clow, li_icupp, li_cupp = ineq_sides(iql)
    linking_ineq = {"iclow": li_iclow, "clow": li_clow,
                    "icupp": li_icupp, "cupp": li_cupp}
    return blocks, first, linking_eq, linking_ineq


def read_gms(path: str, num_blocks: int, dtype=None,
             starred_bounds_active: bool = True, device="cpu"):
    """Parse a GAMSsmall .gms file into an ArrowheadLP on `device`."""
    import torch

    from pips_ipmpp_tpu_torch.core.lp import make_arrowhead_lp
    with open(path) as f:
        model = parse_gms(f.read())
    blocks, first, le, li = gms_to_block_data(
        model, num_blocks, starred_bounds_active=starred_bounds_active)
    return make_arrowhead_lp(blocks, first, linking_eq=le, linking_ineq=li,
                             dtype=dtype or torch.float64, device=device)
