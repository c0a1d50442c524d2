"""Synthetic arrowhead LP generators (benchmarks, smoke runs, tests).

Counterparts of `random_arrowhead_lp`, `random_hier_arrowhead_lp` (with
`refit_feasible`), `random_sparse_arrowhead_lp`, `banded_arrowhead_lp`
and `klink_arrowhead_lp` in
`pips_ipmpp_tpu/io/synthetic.py`: the same `np.random.default_rng(seed)`
draws in the same order and the same host arithmetic, so one seed gives
bit-identical LP data in both packages.
"""
import dataclasses

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP, make_arrowhead_lp


def random_arrowhead_lp(seed, N=4, n=6, mE=3, mI=4, n0=3, m0E=2, m0I=2,
                        mEl=2, mIl=2, dtype=torch.float64, device="cpu",
                        heterogeneous=False) -> ArrowheadLP:
    """Feasible-by-construction random arrowhead LP: pick interior x*, build
    rhs/bounds around it. All variables bounded (lower always, upper 70%)."""
    rng = np.random.default_rng(seed)

    x0s = rng.normal(size=n0) * 0.5

    def bounds_for(xs, nloc):
        ixlow = np.ones(nloc)
        xlow = xs - 0.5 - rng.random(nloc)
        ixupp = (rng.random(nloc) < 0.7).astype(float)
        xupp = np.where(ixupp > 0, xs + 0.5 + rng.random(nloc), 0.0)
        return ixlow, xlow, ixupp, xupp

    def ineq_bounds(Cx, m):
        iclow = (rng.random(m) < 0.7).astype(float)
        icupp = np.where(iclow > 0, (rng.random(m) < 0.5).astype(float), 1.0)
        clow = np.where(iclow > 0, Cx - 0.3 - rng.random(m), 0.0)
        cupp = np.where(icupp > 0, Cx + 0.3 + rng.random(m), 0.0)
        return iclow, clow, icupp, cupp

    blocks = []
    xis = []
    for i in range(N):
        ni = n - (i % 2) if heterogeneous else n
        mEi = max(1, mE - (i % 2)) if heterogeneous else mE
        mIi = max(1, mI - (i % 3)) if heterogeneous else mI
        xi = rng.normal(size=ni) * 0.5
        xis.append(xi)
        A = rng.normal(size=(mEi, n0)) * 0.3
        B = rng.normal(size=(mEi, ni)) + np.eye(mEi, ni)
        b = A @ x0s + B @ xi
        C = rng.normal(size=(mIi, n0)) * 0.3
        D = rng.normal(size=(mIi, ni))
        Cx = C @ x0s + D @ xi
        iclow, clow, icupp, cupp = ineq_bounds(Cx, mIi)
        ixlow, xlow, ixupp, xupp = bounds_for(xi, ni)
        F = rng.normal(size=(mEl, ni)) * 0.2
        G = rng.normal(size=(mIl, ni)) * 0.2
        blocks.append(dict(c=rng.normal(size=ni), A=A, B=B, b=b, C=C, D=D,
                           iclow=iclow, clow=clow, icupp=icupp, cupp=cupp,
                           ixlow=ixlow, xlow=xlow, ixupp=ixupp, xupp=xupp,
                           F=F, G=G))

    A0 = rng.normal(size=(m0E, n0)) + np.eye(m0E, n0)
    b0 = A0 @ x0s
    C0 = rng.normal(size=(m0I, n0))
    iclow0, clow0, icupp0, cupp0 = ineq_bounds(C0 @ x0s, m0I)
    ixlow0, xlow0, ixupp0, xupp0 = bounds_for(x0s, n0)
    F0 = rng.normal(size=(mEl, n0)) * 0.2
    G0 = rng.normal(size=(mIl, n0)) * 0.2
    first = dict(c=rng.normal(size=n0), A=A0, b=b0, C=C0,
                 iclow=iclow0, clow=clow0, icupp=icupp0, cupp=cupp0,
                 ixlow=ixlow0, xlow=xlow0, ixupp=ixupp0, xupp=xupp0,
                 F0=F0, G0=G0)

    bl = F0 @ x0s + sum(blk["F"] @ xi for blk, xi in zip(blocks, xis))
    Gx = G0 @ x0s + sum(blk["G"] @ xi for blk, xi in zip(blocks, xis))
    iclowl, clowl, icuppl, cuppl = ineq_bounds(Gx, mIl)

    return make_arrowhead_lp(
        blocks, first, linking_eq={"b": bl},
        linking_ineq={"iclow": iclowl, "clow": clowl,
                      "icupp": icuppl, "cupp": cuppl},
        dtype=dtype, device=device)


def random_hier_arrowhead_lp(seed, N=8, n_groups=2, n=5, mE=2, mI=3,
                             n0=2, m0E=1, m0I=2, loc_eq=2, loc_iq=1,
                             glob_eq=1, glob_iq=1, dtype=torch.float64,
                             device="cpu") -> ArrowheadLP:
    """Arrowhead LP with group-LOCAL linking-row structure (the reference's
    2-link/k-link pattern, DistributedProblem::activateLinkStructure
    Exploitation): each group of N/n_groups blocks owns `loc_eq`/`loc_iq`
    linking rows supported only on its blocks, plus a few global rows.
    Rows are interleaved (shuffled) to exercise locality detection."""
    rng = np.random.default_rng(seed)
    gs = N // n_groups
    mEl = n_groups * loc_eq + glob_eq
    mIl = n_groups * loc_iq + glob_iq

    # owners: group id per row or -1 for global, then shuffle
    ownE = np.concatenate([np.repeat(np.arange(n_groups), loc_eq),
                           np.full(glob_eq, -1)])
    ownI = np.concatenate([np.repeat(np.arange(n_groups), loc_iq),
                           np.full(glob_iq, -1)])
    rng.shuffle(ownE)
    rng.shuffle(ownI)

    base = random_arrowhead_lp(seed + 1, N=N, n=n, mE=mE, mI=mI, n0=n0,
                               m0E=m0E, m0I=m0I, mEl=mEl, mIl=mIl,
                               dtype=dtype)
    # rebuild F/G with locality masks and consistent rhs/bounds
    F = base.F.numpy().copy()
    Gm = base.G.numpy().copy()
    for r, g in enumerate(ownE):
        if g >= 0:
            mask = np.ones(N, bool)
            mask[g * gs:(g + 1) * gs] = False
            F[mask, r, :] = 0.0
    for r, g in enumerate(ownI):
        if g >= 0:
            mask = np.ones(N, bool)
            mask[g * gs:(g + 1) * gs] = False
            Gm[mask, r, :] = 0.0

    return refit_feasible(base, F, Gm, rng, dtype).to(device)


def refit_feasible(base: ArrowheadLP, F, Gm, rng, dtype=torch.float64
                   ) -> ArrowheadLP:
    """Rebuild rhs/bounds of `base` (on the CPU) so the LP with REPLACED
    linking strips F/Gm (numpy) is feasible at a random interior point:
    used after masking linking rows to craft locality structure."""
    N, n = base.N, base.n
    n0 = base.n0
    x0 = rng.normal(size=n0) * 0.3
    xi = rng.normal(size=(N, n)) * 0.3
    host = {name: getattr(base, name).numpy()
            for name in ("A", "B", "A0", "F0", "C0", "C", "D", "G0")}
    # block eqs must stay consistent: recompute bN as well
    bN = (np.einsum("imk,k->im", host["A"], x0)
          + np.einsum("imn,in->im", host["B"], xi))
    b0 = host["A0"] @ x0
    bl = host["F0"] @ x0 + np.einsum("iln,in->l", F, xi)
    Cx0 = host["C0"] @ x0
    CxN = (np.einsum("imk,k->im", host["C"], x0)
           + np.einsum("imn,in->im", host["D"], xi))
    Gx = host["G0"] @ x0 + np.einsum("iln,in->l", Gm, xi)

    def box(v, width=1.0):
        lo = v - width * (0.5 + rng.random(np.shape(v)))
        up = v + width * (0.5 + rng.random(np.shape(v)))
        return lo, up

    cl0, cu0 = box(Cx0)
    clN, cuN = box(CxN)
    cll, cul = box(Gx)
    xl0, xu0 = box(x0)
    xlN, xuN = box(xi)

    def arr(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype)

    def ones(v):
        return torch.ones(np.shape(v), dtype=dtype)

    return dataclasses.replace(
        base,
        F=arr(F), G=arr(Gm), b0=arr(b0), bN=arr(bN), bl=arr(bl),
        iclow0=ones(cl0), clow0=arr(cl0), icupp0=ones(cu0), cupp0=arr(cu0),
        iclowN=ones(clN), clowN=arr(clN), icuppN=ones(cuN), cuppN=arr(cuN),
        iclowl=ones(cll), clowl=arr(cll), icuppl=ones(cul), cuppl=arr(cul),
        ixlow0=ones(xl0), xlow0=arr(xl0), ixupp0=ones(xu0), xupp0=arr(xu0),
        ixlowN=ones(xlN), xlowN=arr(xlN), ixuppN=ones(xuN), xuppN=arr(xuN),
    )


def random_sparse_arrowhead_lp(seed, N=4, n=4096, mE=2048, mI=2048,
                               nnz_per_row=8, n0=32, m0E=8, m0I=8,
                               mEl=8, mIl=8, dtype=torch.float64,
                               device="cpu"):
    """Feasible-by-construction sparse arrowhead LP, built directly in ELL
    form: the dense [N, m, n] blocks are never materialized, so this
    scales to the reference's block sizes (10^4+ rows at ~10 nnz/row).

    B gets a unit-ish "diagonal" (col r % n) for full row rank plus random
    off-diagonal entries; D is fully random.  Same draws, in the same
    order, as the JAX package's `random_sparse_arrowhead_lp`."""
    from pips_ipmpp_tpu_torch.core.sparse import (Ell, SparseArrowheadLP,
                                                  ell_transpose)
    rng = np.random.default_rng(seed)
    K = nnz_per_row

    def rand_ell(m, diag: bool):
        # distinct column ids per row (slot k draws from its own stripe
        # of [0, n)): ell_sq_diag and products assume no duplicate slots
        stripe = n // K
        base = (np.arange(K) * stripe)[None, None, :]
        col = (base + rng.integers(0, stripe, size=(N, m, K))
               ).astype(np.int32)
        val = rng.normal(size=(N, m, K)) * (0.4 / np.sqrt(K))
        if diag:
            # put the strong diagonal id into the slot whose stripe
            # contains it (one slot per stripe keeps ids unique)
            d = (np.arange(m) % n).astype(np.int32)
            owner = np.minimum(d // stripe, K - 1)
            ridx = np.arange(m)
            col[:, ridx, owner] = d[None, :]
            val[:, ridx, owner] = 1.0 + 0.1 * rng.random((N, m))
        return Ell(torch.from_numpy(val), torch.from_numpy(col))

    B = rand_ell(mE, diag=True)
    D = rand_ell(mI, diag=False)
    Bt = ell_transpose(B, n)
    Dt = ell_transpose(D, n)

    def ell_mv_np(e, x):  # host-side matvec for the rhs construction
        v = e.val.numpy()
        c = e.col.numpy()
        return np.einsum("imk,imk->im",
                         v, np.take_along_axis(x, c.reshape(N, -1),
                                               axis=1).reshape(v.shape))

    x0 = rng.normal(size=n0) * 0.5
    xi = rng.normal(size=(N, n)) * 0.5
    A = rng.normal(size=(N, mE, n0)) * 0.3
    C = rng.normal(size=(N, mI, n0)) * 0.3
    F = rng.normal(size=(N, mEl, n)) * (0.2 / np.sqrt(n))
    G = rng.normal(size=(N, mIl, n)) * (0.2 / np.sqrt(n))
    A0 = rng.normal(size=(m0E, n0)) + np.eye(m0E, n0)
    C0 = rng.normal(size=(m0I, n0))
    F0 = rng.normal(size=(mEl, n0)) * 0.2
    G0 = rng.normal(size=(mIl, n0)) * 0.2

    bN = np.einsum("imk,k->im", A, x0) + ell_mv_np(B, xi)
    CxN = np.einsum("imk,k->im", C, x0) + ell_mv_np(D, xi)
    b0 = A0 @ x0
    Cx0 = C0 @ x0
    bl = F0 @ x0 + np.einsum("iln,in->l", F, xi)
    Gx = G0 @ x0 + np.einsum("iln,in->l", G, xi)

    def box(v, width=1.0):
        lo = v - width * (0.5 + rng.random(np.shape(v)))
        up = v + width * (0.5 + rng.random(np.shape(v)))
        return lo, up

    cl0, cu0 = box(Cx0)
    clN, cuN = box(CxN)
    cll, cul = box(Gx)
    xl0, xu0 = box(x0)
    xlN, xuN = box(xi)

    def arr(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    def ones(v):
        return torch.ones(np.shape(v), dtype=dtype, device=device)

    def cast(e):
        return Ell(arr(e.val), e.col.to(device))

    return SparseArrowheadLP(
        c0=arr(rng.normal(size=n0)), A0=arr(A0), b0=arr(b0), C0=arr(C0),
        iclow0=ones(cl0), clow0=arr(cl0), icupp0=ones(cu0), cupp0=arr(cu0),
        ixlow0=ones(xl0), xlow0=arr(xl0), ixupp0=ones(xu0), xupp0=arr(xu0),
        cN=arr(rng.normal(size=(N, n))), A=arr(A), B=cast(B), Bt=cast(Bt),
        bN=arr(bN), C=arr(C), D=cast(D), Dt=cast(Dt),
        iclowN=ones(clN), clowN=arr(clN), icuppN=ones(cuN), cuppN=arr(cuN),
        ixlowN=ones(xlN), xlowN=arr(xlN), ixuppN=ones(xuN), xuppN=arr(xuN),
        F0=arr(F0), F=arr(F), bl=arr(bl), G0=arr(G0), G=arr(G),
        iclowl=ones(cll), clowl=arr(cll), icuppl=ones(cul), cuppl=arr(cul))


def banded_arrowhead_lp(seed, N=4, n=512, mE=256, mI=256, window=8,
                        n0=8, m0E=4, m0I=4, mEl=4, mIl=4,
                        dtype=torch.float64, device="cpu") -> ArrowheadLP:
    """Arrowhead LP whose block rows have LOCAL variable support (a
    time-coupled dispatch structure): equality row r touches variables in a
    `window`-wide window around position r*n/mE, inequalities likewise.
    The condensed normal equations M M' are then sparse/banded — the
    regime of the reference's sparse leaf solver (SparseStorage.C,
    PardisoSchurSolver.C) — but rows of B and D interleave, so a
    fill-reducing (RCM) ordering is required to expose the band.
    Feasible by construction (rhs/bounds built around an interior x*)."""
    rng = np.random.default_rng(seed)

    def local_rows(m, nloc, w):
        M = np.zeros((m, nloc))
        for r in range(m):
            c0 = int(round(r * (nloc - w) / max(m - 1, 1)))
            M[r, c0:c0 + w] = rng.normal(size=w)
            M[r, c0 + (r % w)] += 2.0      # well-conditioned diagonal-ish
        return M

    x0s = rng.normal(size=n0) * 0.5

    def bounds_for(xs, nloc):
        ixlow = np.ones(nloc)
        xlow = xs - 0.5 - rng.random(nloc)
        ixupp = (rng.random(nloc) < 0.7).astype(float)
        xupp = np.where(ixupp > 0, xs + 0.5 + rng.random(nloc), 0.0)
        return ixlow, xlow, ixupp, xupp

    def ineq_bounds(Cx, m):
        iclow = (rng.random(m) < 0.7).astype(float)
        icupp = np.where(iclow > 0, (rng.random(m) < 0.5).astype(float), 1.0)
        clow = np.where(iclow > 0, Cx - 0.3 - rng.random(m), 0.0)
        cupp = np.where(icupp > 0, Cx + 0.3 + rng.random(m), 0.0)
        return iclow, clow, icupp, cupp

    blocks = []
    xis = []
    for i in range(N):
        xi = rng.normal(size=n) * 0.5
        xis.append(xi)
        # sparse first-stage border: each row touches a couple of x0 vars
        A = np.zeros((mE, n0))
        A[np.arange(mE), rng.integers(0, n0, mE)] = rng.normal(size=mE) * 0.3
        B = local_rows(mE, n, window)
        b = A @ x0s + B @ xi
        C = np.zeros((mI, n0))
        C[np.arange(mI), rng.integers(0, n0, mI)] = rng.normal(size=mI) * 0.3
        D = local_rows(mI, n, window)
        Cx = C @ x0s + D @ xi
        iclow, clow, icupp, cupp = ineq_bounds(Cx, mI)
        ixlow, xlow, ixupp, xupp = bounds_for(xi, n)
        F = rng.normal(size=(mEl, n)) * 0.05
        G = rng.normal(size=(mIl, n)) * 0.05
        blocks.append(dict(c=rng.normal(size=n), A=A, B=B, b=b, C=C, D=D,
                           iclow=iclow, clow=clow, icupp=icupp, cupp=cupp,
                           ixlow=ixlow, xlow=xlow, ixupp=ixupp, xupp=xupp,
                           F=F, G=G))

    A0 = rng.normal(size=(m0E, n0)) + np.eye(m0E, n0)
    b0 = A0 @ x0s
    C0 = rng.normal(size=(m0I, n0))
    iclow0, clow0, icupp0, cupp0 = ineq_bounds(C0 @ x0s, m0I)
    ixlow0, xlow0, ixupp0, xupp0 = bounds_for(x0s, n0)
    F0 = rng.normal(size=(mEl, n0)) * 0.2
    G0 = rng.normal(size=(mIl, n0)) * 0.2
    first = dict(c=rng.normal(size=n0), A=A0, b=b0, C=C0,
                 iclow=iclow0, clow=clow0, icupp=icupp0, cupp=cupp0,
                 ixlow=ixlow0, xlow=xlow0, ixupp=ixupp0, xupp=xupp0,
                 F0=F0, G0=G0)

    bl = F0 @ x0s + sum(blk["F"] @ xi for blk, xi in zip(blocks, xis))
    Gx = G0 @ x0s + sum(blk["G"] @ xi for blk, xi in zip(blocks, xis))
    iclowl, clowl, icuppl, cuppl = ineq_bounds(Gx, mIl)

    return make_arrowhead_lp(
        blocks, first, linking_eq={"b": bl},
        linking_ineq={"iclow": iclowl, "clow": clowl,
                      "icupp": icuppl, "cupp": cuppl},
        dtype=dtype, device=device)


def klink_arrowhead_lp(seed, N=8, n=24, mE=8, mI=8, links_per_block=2,
                       klink=2, n_global=0, n0=6, m0E=3, m0I=3,
                       dtype=torch.float64, device="cpu") -> ArrowheadLP:
    """Arrowhead LP whose linking rows have k-link structure: each row is
    supported on `klink` CONSECUTIVE blocks (the reference's 2-link rows,
    DistributedProblem.hpp:66-77), plus `n_global` all-block rows.  Split
    evenly into eq/ineq linking rows.  Feasible by construction."""
    rng = np.random.default_rng(seed)
    owners = []          # (first_block, is_global)
    for i in range(N):
        owners += [(i, False)] * links_per_block
    owners += [(0, True)] * n_global
    nlink = len(owners)
    mEl = nlink // 2
    mIl = nlink - mEl
    # interleave eq/ineq (exactly mEl eq rows) to exercise the planner
    typemask = np.zeros(nlink, bool)
    typemask[np.arange(nlink)[::2][:mEl]] = True
    typemask[np.arange(nlink)[1::2][:mEl - typemask.sum()]] = True

    x0s = rng.normal(size=n0) * 0.5

    def bounds_for(xs, nloc):
        ixlow = np.ones(nloc)
        xlow = xs - 0.5 - rng.random(nloc)
        ixupp = (rng.random(nloc) < 0.7).astype(float)
        xupp = np.where(ixupp > 0, xs + 0.5 + rng.random(nloc), 0.0)
        return ixlow, xlow, ixupp, xupp

    def ineq_bounds(Cx, m):
        iclow = (rng.random(m) < 0.7).astype(float)
        icupp = np.where(iclow > 0, (rng.random(m) < 0.5).astype(float), 1.0)
        clow = np.where(iclow > 0, Cx - 0.3 - rng.random(m), 0.0)
        cupp = np.where(icupp > 0, Cx + 0.3 + rng.random(m), 0.0)
        return iclow, clow, icupp, cupp

    # linking coefficient strips: eq rows then ineq rows, per block
    Fs = [np.zeros((mEl, n)) for _ in range(N)]
    Gs = [np.zeros((mIl, n)) for _ in range(N)]
    ei = ii = 0
    for (blk0, is_glob), is_eq in zip(owners, typemask):
        tgt, r = (Fs, ei) if is_eq else (Gs, ii)
        span = range(N) if is_glob else range(
            blk0, min(blk0 + klink, N))
        for i in span:
            tgt[i][r] = rng.normal(size=n) * 0.2
        if is_eq:
            ei += 1
        else:
            ii += 1

    blocks, xis = [], []
    for i in range(N):
        xi = rng.normal(size=n) * 0.5
        xis.append(xi)
        A = rng.normal(size=(mE, n0)) * 0.3
        B = rng.normal(size=(mE, n)) + np.eye(mE, n)
        C = rng.normal(size=(mI, n0)) * 0.3
        D = rng.normal(size=(mI, n))
        Cx = C @ x0s + D @ xi
        iclow, clow, icupp, cupp = ineq_bounds(Cx, mI)
        ixlow, xlow, ixupp, xupp = bounds_for(xi, n)
        blocks.append(dict(c=rng.normal(size=n), A=A, B=B,
                           b=A @ x0s + B @ xi, C=C, D=D,
                           iclow=iclow, clow=clow, icupp=icupp, cupp=cupp,
                           ixlow=ixlow, xlow=xlow, ixupp=ixupp, xupp=xupp,
                           F=Fs[i], G=Gs[i]))

    A0 = rng.normal(size=(m0E, n0)) + np.eye(m0E, n0)
    C0 = rng.normal(size=(m0I, n0))
    iclow0, clow0, icupp0, cupp0 = ineq_bounds(C0 @ x0s, m0I)
    ixlow0, xlow0, ixupp0, xupp0 = bounds_for(x0s, n0)
    F0 = rng.normal(size=(mEl, n0)) * 0.1
    G0 = rng.normal(size=(mIl, n0)) * 0.1
    first = dict(c=rng.normal(size=n0), A=A0, b=A0 @ x0s, C=C0,
                 iclow=iclow0, clow=clow0, icupp=icupp0, cupp=cupp0,
                 ixlow=ixlow0, xlow=xlow0, ixupp=ixupp0, xupp=xupp0,
                 F0=F0, G0=G0)

    bl = F0 @ x0s + sum(F @ xi for F, xi in zip(Fs, xis))
    Gx = G0 @ x0s + sum(G @ xi for G, xi in zip(Gs, xis))
    iclowl, clowl, icuppl, cuppl = ineq_bounds(Gx, mIl)
    return make_arrowhead_lp(
        blocks, first, linking_eq={"b": bl},
        linking_ineq={"iclow": iclowl, "clow": clowl,
                      "icupp": icuppl, "cupp": cuppl},
        dtype=dtype, device=device)
