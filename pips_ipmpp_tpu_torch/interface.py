"""Public facade — counterpart of `pips_ipmpp_tpu/interface.py`
(reference PIPSIPMppInterface, Core/Interface/PIPSIPMppInterface.hpp:32-128):
construct from problem data + options; run() -> TerminationStatus;
getObjective(); the gather* accessors.

The facade takes a DenseLP, an ArrowheadLP, a SparseArrowheadLP or a
BucketedArrowheadLP.  `run()` presolves an ArrowheadLP when asked (host
numpy, `presolve/`), applies the chosen scaler, and solves: a DenseLP
with `DenseBackend`, an ArrowheadLP with the Schur-complement
`ArrowBackend` (with `Options.banded_leaf` the banded leaf,
`BandArrowBackend`, with `Options.banded_root` the banded root, both
planned from the LP as given; with `Options.hierarchical`, last, the
hierarchical layout and `HierArrowBackend`), a sparse LP whose dense twin
does not fit `Options.sparse_densify_max_mb` with the CG-leaf
`SparseArrowBackend`, and a bucketed LP with `BucketedArrowBackend`.
The gathers report the original problem's space: they undo the scaling
and, after presolve, postsolve the iterate; the linking rows come back in
the user's order, a bucketed LP's blocks in its bucket layout ([first |
bucket 0's blocks | bucket 1's | ...]), as in the JAX package.
The facade runs on the CUDA card unless the caller passes `device="cpu"`;
the gathers read one host copy of the LP and one of the iterate.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from functools import partial
from typing import Optional

import numpy as np
import torch

from pips_ipmpp_tpu_torch.core.bucketed import BucketedArrowheadLP
from pips_ipmpp_tpu_torch.core.lp import ArrowheadLP, DenseLP
from pips_ipmpp_tpu_torch.core.sparse import (Ell, SparseArrowheadLP,
                                              dense_bytes, dense_from_sparse)
from pips_ipmpp_tpu_torch.core.options import (Options, PresolverType,
                                               ScalerType)
from pips_ipmpp_tpu_torch.core.spaces import tmap
from pips_ipmpp_tpu_torch.core.status import TerminationStatus

# the largest complementarity product (inf-norm of v*gamma, w*phi, t*lambda,
# u*pi) a postsolved solution is expected to keep, the bound that
# tests/test_interface.py holds the facade's small LPs to
COMPLEMENTARITY_BOUND = 1e-3


def resolve_factor_dtype(opts: Options, device) -> torch.dtype:
    """Factor precision: f32 on CUDA (the LDL kernel's path), f64 on CPU,
    unless `opts.factor_dtype` names one.  Iterates, residuals and
    refinement run in f64 whatever the factors' dtype
    (`ipm/solver.py::WORKING_DTYPE`)."""
    if opts.factor_dtype == "float32":
        return torch.float32
    if opts.factor_dtype == "float64":
        return torch.float64
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


# The widest root (n0 + m0E + m0I + mEl + mIl) that f32 factors leave to
# the LDL kernel, its widest width under test before the dissected LPs.
# A wider root is factored in f64 by the two-level Cholesky (potf2 on the
# card) while the leaves stay f32: unpivoted f32 LDL of the dissected
# energy LP's root (3,379 wide at 6 periods, 13,065 at 24) stalls the IPM
# or not with its rounding order (ROADMAP.md §3, R2)
ROOT_F32_MAX = 2048


def root_factor_dtype(lp, fd: torch.dtype) -> torch.dtype:
    """The root's factor dtype for leaves factored in `fd`: f64 for an f32
    root wider than ROOT_F32_MAX, else `fd` (an ArrowheadLP or a
    BucketedArrowheadLP, whose buckets share one root)."""
    if isinstance(lp, BucketedArrowheadLP):
        lp = lp.buckets[0]
    ns = lp.n0 + lp.m0E + lp.m0I + lp.mEl + lp.mIl
    return torch.float64 if fd == torch.float32 and ns > ROOT_F32_MAX \
        else fd


def _auto_groups(N: int) -> int:
    """Largest divisor of N not exceeding sqrt(N) (reference
    mapChildrenToNSubTrees picks ~sqrt(N) sub-roots, DistributedTree.h:166)."""
    best = 1
    for g in range(1, math.isqrt(N) + 1):
        if N % g == 0:
            best = g
    return best


def _solve_modes(opts: Options) -> list[str]:
    """The options of the solve modes that are set (the reference's
    OUTER_SOLVE=2, SC_COMPUTE_BLOCKWISE and PRECONDITION_SPARSE)."""
    return [name for name, on in (
        ("outer_bicgstab", opts.outer_bicgstab),
        ("sc_blockwise", opts.sc_blockwise > 0),
        ("iterative_root_panel", opts.iterative_root_panel > 0)) if on]


def _numpy(tree):
    """A tree of tensors (an Ell included) as numpy arrays, one
    device->host copy each."""
    return tmap(lambda t: t.detach().cpu().numpy(), tree)


def _blocks_op(blocks, factors, op):
    """Elementwise op between a blocks part and matching scale factors:
    both tuples (bucketed) or both batched arrays."""
    if isinstance(blocks, (tuple, list)):
        return tuple(op(np.asarray(b, np.float64), f)
                     for b, f in zip(blocks, factors))
    return op(np.asarray(blocks, np.float64), factors)


def _ell_mv(ell: Ell, x: np.ndarray) -> np.ndarray:
    """y[i, r] = sum_k val[i, r, k] * x[i, col[i, r, k]] on numpy arrays."""
    N = ell.val.shape[0]
    gathered = x[np.arange(N)[:, None, None], ell.col]
    return np.einsum("irk,irk->ir", np.asarray(ell.val, np.float64),
                     gathered)


class PIPSIPMppTorchInterface:
    """Facade wiring presolve -> scaler -> solver -> postsolve (ctor order
    mirrors PIPSIPMppInterface.cpp:20-130)."""

    def __init__(self, lp, options: Optional[Options] = None, *,
                 device="cuda"):
        if not isinstance(lp, (DenseLP, ArrowheadLP, SparseArrowheadLP,
                               BucketedArrowheadLP)):
            raise TypeError(f"unsupported problem type {type(lp)}: this "
                            f"package solves DenseLP, ArrowheadLP, "
                            f"SparseArrowheadLP and BucketedArrowheadLP")
        self.options = options or Options()
        o = self.options
        banded = o.banded_leaf or o.banded_root
        if isinstance(lp, ArrowheadLP) and o.hierarchical and banded:
            raise ValueError("banded_leaf/banded_root are exclusive "
                             "with hierarchical mode")
        if isinstance(lp, BucketedArrowheadLP) and (banded
                                                   or o.hierarchical):
            raise ValueError("banded/hierarchical modes are not "
                             "supported with bucketed blocks")
        if isinstance(lp, DenseLP) and banded:
            warnings.warn("banded_leaf/banded_root apply to ArrowheadLP "
                          "only; ignored for DenseLP")
        self.device = torch.device(device)
        self.lp = lp.to(self.device)
        self.result = None
        self.phase_times: dict[str, float] = {}
        self._scaler = None
        self._presolve_log = None
        self._gather_cache: dict = {}
        self._host: Optional[dict] = None
        self._hier_meta = None
        self._orig_link_dims = None

        from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
        from pips_ipmpp_tpu_torch.linalg.arrow_backend import ArrowBackend

        fd = resolve_factor_dtype(self.options, self.device)
        kw = dict(factor_dtype=fd)
        if isinstance(lp, DenseLP):
            from pips_ipmpp_tpu_torch.linalg.dense_backend import \
                DenseBackend
            be_cls = DenseBackend
        elif isinstance(lp, BucketedArrowheadLP):
            from pips_ipmpp_tpu_torch.linalg.bucket_backend import \
                BucketedArrowBackend
            be_cls = BucketedArrowBackend
            kw.update(root_factor_dtype=root_factor_dtype(lp, fd))
        else:
            be_cls = ArrowBackend
        if isinstance(lp, ArrowheadLP):
            # the solve modes' backend options, as the JAX facade passes
            # them (a DenseLP and a densified sparse LP take none)
            kw.update(blockwise_sc=o.sc_blockwise,
                      iterative_root=o.iterative_root_panel,
                      sc_diag_dom_bound=o.sc_diag_dom_bound,
                      it_root_tol=o.it_root_tol,
                      it_root_maxiter=o.it_root_maxiter,
                      root_factor_dtype=root_factor_dtype(lp, fd))
            # the banded modes' plans, host work on the LP as given
            # (before presolve), as in the JAX facade
            if o.banded_leaf:
                from pips_ipmpp_tpu_torch.linalg.band_backend import (
                    BandArrowBackend, plan_banded)
                be_cls = BandArrowBackend
                kw["plan"] = plan_banded(lp)
            if o.banded_root:
                from pips_ipmpp_tpu_torch.linalg.band_root import \
                    plan_banded_root
                kw["band_root_plan"] = plan_banded_root(lp)
        if isinstance(lp, SparseArrowheadLP):
            budget = self.options.sparse_densify_max_mb * 1024 * 1024
            if budget > 0 and dense_bytes(lp) <= budget:
                # the dense twin fits: batched dense factorization
                self.lp = dense_from_sparse(self.lp)
            else:
                modes = _solve_modes(self.options)
                if modes:
                    raise NotImplementedError(
                        f"Options {', '.join(modes)} over the sparse "
                        f"backend are not ported yet (ROADMAP.md §1: the "
                        f"sparse backend under the solve modes)")
                from pips_ipmpp_tpu_torch.linalg.sparse_backend import \
                    SparseArrowBackend
                be_cls = SparseArrowBackend
        self.backend_class = be_cls
        self._solver = IPMSolver(partial(be_cls, **kw), self.options,
                                 device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> TerminationStatus:
        """Presolve -> scale -> (hierarchical layout) -> solve.  Per-phase
        wall times land in `phase_times` (seconds)."""
        self.phase_times = {}
        self.result = None
        self._presolve_log = None
        self._scaler = None
        self._gather_cache = {}
        # the dual transfer's final dual-violation score, once the dual
        # gathers have run the whole postsolve
        self.postsolve_dual_violation = None
        lp = self.lp
        # presolve (ArrowheadLP only; the reference presolves before
        # scaling, PIPSIPMppInterface.cpp:39-57,101-119): host numpy on one
        # host copy of the LP, the presolved LP back on the facade's device
        # in the LP's dtype
        if (self.options.presolve == PresolverType.PRESOLVE
                and isinstance(lp, ArrowheadLP)):
            from pips_ipmpp_tpu_torch.presolve import Presolver
            t0 = time.perf_counter()
            pres = Presolver(max_rounds=self.options.presolve_max_rounds)
            self._presolve_log = pres.presolve(lp)
            self._sync()
            self.phase_times["presolve"] = time.perf_counter() - t0
            if self._presolve_log.infeasible:
                return TerminationStatus.INFEASIBLE
            lp = self._presolve_log.lp
        if self.options.scaler != ScalerType.NONE:
            from pips_ipmpp_tpu_torch.scale import make_scaler
            t0 = time.perf_counter()
            self._scaler = make_scaler(self.options.scaler)
            lp = self._scaler.scale(lp)
            self._sync()
            self.phase_times["scale"] = time.perf_counter() - t0
        self._hier_meta = self._orig_link_dims = None
        if self.options.hierarchical and isinstance(lp, ArrowheadLP):
            t0 = time.perf_counter()
            lp = self._to_hierarchical(lp)
            self._sync()
            self.phase_times["hierarchical"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.result = self._solver.solve(lp)
        self._sync()
        self.phase_times["solve"] = time.perf_counter() - t0
        return self.result.status

    def _to_hierarchical(self, lp: ArrowheadLP) -> ArrowheadLP:
        """The hierarchical k-layer Schur (reference
        switchToHierarchicalData, PIPSIPMppInterface.cpp:81-89): the
        linking rows permuted into the hierarchical layout, last, so every
        other stage sees the flat layout, and the solver rebuilt on
        `HierArrowBackend`.  Layers = 2 + the coarse chain: each coarser
        level groups the previous one (divisor near its sqrt), and the
        chain stops early where a level would hold every group."""
        from pips_ipmpp_tpu_torch.ipm.solver import IPMSolver
        from pips_ipmpp_tpu_torch.linalg.hier_backend import (
            HierArrowBackend, build_hierarchical_lp)

        o = self.options
        if o.hierarchical_layers < 2:
            raise ValueError(
                f"hierarchical_layers={o.hierarchical_layers}: must be >= 2")
        ng = o.hierarchical_num_groups or _auto_groups(lp.N)
        chain = []
        c = ng
        for _ in range(o.hierarchical_layers - 2):
            c = _auto_groups(c)
            if c <= 1:
                break
            chain.append(c)
        self._orig_link_dims = (lp.mEl, lp.mIl)
        lp, self._hier_meta = build_hierarchical_lp(
            lp, ng, coarse_levels=tuple(chain))
        # as in the JAX package, the hierarchy takes the factor dtype
        # alone: the solve modes' backend options (sc_blockwise,
        # iterative_root_panel and its settings) are ArrowBackend's, and
        # are ignored here; outer_bicgstab runs in HierArrowBackend's
        # state layout
        self.backend_class = HierArrowBackend
        self._solver = IPMSolver(
            partial(HierArrowBackend, meta=self._hier_meta,
                    factor_dtype=resolve_factor_dtype(o, self.device)),
            o, device=self.device)
        return lp

    # ------------------------------------------------------------------
    def _require_result(self):
        if self.result is None:
            raise RuntimeError("call run() first")

    def _cached(self, key, fn):
        """Per-run memo for derived quantities (the host iterate, x, Cx,
        the reduced cost): the gathers share them instead of re-deriving
        the original-space pipeline each call."""
        if key not in self._gather_cache:
            self._gather_cache[key] = fn()
        return self._gather_cache[key]

    def _np(self, name: str):
        """Field `name` of the (unpresolved, unscaled) LP as numpy f64 (an
        Ell field as an Ell of numpy arrays), from one host copy; of a
        bucketed LP, the tuple of its buckets' fields."""
        if self._host is None:
            lps = (self.lp.buckets if isinstance(self.lp, BucketedArrowheadLP)
                   else (self.lp,))
            self._host = [_numpy({f.name: getattr(b, f.name)
                                  for f in dataclasses.fields(b)})
                          for b in lps]

        def f64(v):
            return v if isinstance(v, Ell) else np.asarray(v, np.float64)

        if isinstance(self.lp, BucketedArrowheadLP):
            return tuple(f64(h[name]) for h in self._host)
        return f64(self._host[0][name])

    def _np0(self, name: str) -> np.ndarray:
        """A first-stage or linking field, which a bucketed LP's buckets
        share: bucket 0's copy."""
        v = self._np(name)
        return v[0] if isinstance(self.lp, BucketedArrowheadLP) else v

    def _iterate(self):
        """One device->host copy of the solver's iterate, as numpy."""
        return self._cached("iterate", lambda: _numpy(self.result.iterate))

    def _factors(self):
        """The scaler's (s, rE, rC) as numpy, or None without scaling."""
        if self._scaler is None:
            return None
        sc = self._scaler
        return self._cached("factors", lambda: _numpy((sc.s, sc.rE, sc.rC)))

    def _unscaled_x(self):
        x = self._iterate().x
        f = self._factors()
        return x if f is None else tmap(np.multiply, f[0], x)

    def _postsolve(self, primal_only=False):
        """Reconstruct the original-space solution if presolve ran
        (reference postsolveComputedSolution, PIPSIPMppInterface.cpp:531).
        `primal_only` replays the primal reductions alone: the same x as
        the full postsolve, whose dual passes the primal gathers do not
        need."""
        if self._presolve_log is None:
            return None
        if primal_only and "postsolved" not in self._gather_cache:
            return self._cached("postsolved_primal",
                                lambda: self._postsolve_impl(True))
        if "postsolved" in self._gather_cache:
            return self._gather_cache["postsolved"]
        out = self._cached("postsolved", self._postsolve_impl)
        self._check_dual_postsolve()
        return out

    def _check_dual_postsolve(self):
        """Warn when the postsolved duals are not complementary: the dual
        transfer passes stop after a fixed number of rounds, and where
        they stop short the dual gathers would otherwise come back
        without a sign of it."""
        norms = self.complementarityResiduals()
        worst = max(norms.values(), default=0.0)
        if worst > COMPLEMENTARITY_BOUND:
            warnings.warn(
                f"postsolve: complementarity products up to {worst:.3e} "
                f"(bound {COMPLEMENTARITY_BOUND:g}; the dual transfer left "
                f"a dual-violation score of "
                f"{self.postsolve_dual_violation:.3e}): the dual gathers "
                f"are not complementary", RuntimeWarning, stacklevel=3)

    def _postsolve_impl(self, primal_only=False):
        from pips_ipmpp_tpu_torch.presolve.postsolve import (Postsolver,
                                                             Solution)
        it = self._iterate()
        x = self._unscaled_x()
        f = self._factors()

        def parts(vec, which, factors):
            # np.array (copy): postsolve mutates these in place
            first = np.array(vec.first, np.float64)
            blocks = np.array(vec.blocks, np.float64)
            link = self._unpermute_link(np.array(vec.link, np.float64),
                                        which)
            if factors is not None:
                first = first * factors.first
                blocks = blocks * factors.blocks
                link = link * factors.link
            return first, blocks, link

        y0, yN, yl = parts(it.y, "E", f[1] if f else None)
        z0, zN, zl = parts(it.z, "I", f[2] if f else None)
        sol = Solution(
            x0=np.array(x.first, np.float64),
            xN=np.array(x.blocks, np.float64),
            y0=y0, yN=yN, yl=yl, z0=z0, zN=zN, zl=zl)
        host_lp = ArrowheadLP(**{
            fld.name: torch.from_numpy(self._np(fld.name))
            for fld in dataclasses.fields(self.lp)})
        t0 = time.perf_counter()
        ps = Postsolver(host_lp)
        if primal_only:
            out = ps.postsolve_primal(self._presolve_log.events, sol)
            self.phase_times["postsolve_primal"] = time.perf_counter() - t0
        else:
            out = ps.postsolve(self._presolve_log.events, sol)
            self.phase_times["postsolve"] = time.perf_counter() - t0
            self.postsolve_dual_violation = ps.dual_violation
        return out

    @property
    def n_iterations(self) -> int:
        self._require_result()
        return self.result.iterations

    def getObjective(self) -> float:
        """Objective of the original (unpresolved, unscaled) problem at the
        gathered solution (reference PIPSIPMppInterface::getObjective
        :193-211)."""
        self._require_result()
        if isinstance(self.lp, BucketedArrowheadLP):
            # the pow2 scaling leaves the objective's value as it is, so
            # the solver's objective is the original one
            return float(self.result.objective)
        x = self.gatherPrimalSolution()
        if isinstance(self.lp, DenseLP):
            return float(np.dot(self._np("c"), x))
        lp = self.lp
        return float(np.dot(self._np("c0"), x[:lp.n0])
                     + np.dot(self._np("cN").reshape(-1), x[lp.n0:]))

    def gatherPrimalSolution(self) -> np.ndarray:
        """x in the original variables: [x0 | x_1 | ... | x_N]."""
        self._require_result()
        return self._cached("x", self._gather_primal)

    def _gather_primal(self) -> np.ndarray:
        ps = self._postsolve(primal_only=True)
        if ps is not None:
            return np.concatenate([ps.x0, ps.xN.reshape(-1)])
        x = self._unscaled_x()
        if isinstance(self.lp, DenseLP):
            return np.asarray(x, np.float64)
        return self._flatcat(x.first, x.blocks)

    # ------------------------------------------------------------------
    # original-space matvecs (numpy, off the hot path: the cons-value and
    # residual gathers combine the solution with the problem data, as the
    # reference does, PIPSIPMppInterface.cpp:337-384)
    @staticmethod
    def _flatcat(first, blocks, link=None) -> np.ndarray:
        """[first | blocks.flat | link], `blocks` one batched array or a
        tuple of per-bucket arrays."""
        blocks = blocks if isinstance(blocks, (tuple, list)) else (blocks,)
        parts = [np.asarray(first, np.float64).reshape(-1)] + [
            np.asarray(b, np.float64).reshape(-1) for b in blocks]
        if link is not None:
            parts.append(np.asarray(link, np.float64).reshape(-1))
        return np.concatenate(parts)

    def _split_x(self, xflat: np.ndarray):
        lp = self.lp
        if isinstance(lp, BucketedArrowheadLP):
            xN, off = [], lp.n0
            for b in lp.buckets:
                xN.append(xflat[off:off + b.N * b.n].reshape(b.N, b.n))
                off += b.N * b.n
            return xflat[:lp.n0], xN
        return xflat[:lp.n0], xflat[lp.n0:].reshape(lp.N, lp.n)

    @staticmethod
    def _bd_mv(mat, x) -> np.ndarray:
        """Diagonal-block matvec over dense [N, m, n] or Ell."""
        if isinstance(mat, Ell):
            return _ell_mv(mat, x)
        return np.einsum("nij,nj->ni", mat, x)

    def _bucketed_mv(self, M0, Mb, Db, Ml0, Mlb, x0, xN) -> np.ndarray:
        """[M0 x0 | Mb x0 + Db x_i per bucket | Ml0 x0 + sum Mlb x_i] of a
        bucketed LP."""
        g = self._np
        rl = self._np0(Ml0) @ x0
        rN = []
        for A, B, F, xb in zip(g(Mb), g(Db), g(Mlb), xN):
            rN.append(A @ x0 + np.einsum("nij,nj->ni", B, xb))
            rl = rl + np.einsum("nij,nj->i", F, xb)
        return self._flatcat(self._np0(M0) @ x0, rN, rl)

    def _arrow_Ax(self, x0, xN) -> np.ndarray:
        if isinstance(self.lp, BucketedArrowheadLP):
            return self._bucketed_mv("A0", "A", "B", "F0", "F", x0, xN)
        g = self._np
        r0 = g("A0") @ x0
        rN = g("A") @ x0 + self._bd_mv(g("B"), xN)
        rl = g("F0") @ x0 + np.einsum("nij,nj->i", g("F"), xN)
        return np.concatenate([r0, rN.reshape(-1), rl])

    def _arrow_Cx(self, x0, xN) -> np.ndarray:
        if isinstance(self.lp, BucketedArrowheadLP):
            return self._bucketed_mv("C0", "C", "D", "G0", "G", x0, xN)
        g = self._np
        r0 = g("C0") @ x0
        rN = g("C") @ x0 + self._bd_mv(g("D"), xN)
        rl = g("G0") @ x0 + np.einsum("nij,nj->i", g("G"), xN)
        return np.concatenate([r0, rN.reshape(-1), rl])

    def gatherEqualityConsValues(self) -> np.ndarray:
        """Values A x of the equality rows in the ORIGINAL space (reference
        gatherEqualityConsValues = gathered eq residuals + rhs,
        PIPSIPMppInterface.cpp:337-357)."""
        self._require_result()
        x = self.gatherPrimalSolution()
        if isinstance(self.lp, DenseLP):
            return self._np("A") @ x
        return self._arrow_Ax(*self._split_x(x))

    def gatherInequalityConsValues(self) -> np.ndarray:
        """Values C x of the inequality rows in the ORIGINAL space
        (reference :360-384, gathered ineq residuals + slacks)."""
        self._require_result()
        return self._cached("Cx", self._gather_ineq_values)

    def _gather_ineq_values(self) -> np.ndarray:
        x = self.gatherPrimalSolution()
        if isinstance(self.lp, DenseLP):
            return self._np("C") @ x
        return self._arrow_Cx(*self._split_x(x))

    def _unpermute_link(self, vec: np.ndarray, which: str) -> np.ndarray:
        """Map hierarchical-layout link vectors back to user row order."""
        if self._hier_meta is None:
            return vec
        from pips_ipmpp_tpu_torch.linalg.hier_backend import \
            unpermute_link_one
        size = (self._orig_link_dims[0] if which == "E"
                else self._orig_link_dims[1])
        return unpermute_link_one(self._hier_meta, vec, which, size)

    def _gather_row_dual(self, vec, which: str, factors) -> np.ndarray:
        """Unpermute, then unscale, then flatten."""
        first = np.asarray(vec.first, np.float64)
        blocks = vec.blocks
        link = self._unpermute_link(np.asarray(vec.link, np.float64), which)
        if factors is not None:
            first = first * factors.first
            blocks = _blocks_op(blocks, factors.blocks, np.multiply)
            link = link * factors.link
        return self._flatcat(first, blocks, link)

    def gatherDualSolutionEq(self) -> np.ndarray:
        self._require_result()
        ps = self._postsolve()
        if ps is not None:
            return np.concatenate([ps.y0, ps.yN.reshape(-1), ps.yl])
        y = self._iterate().y
        f = self._factors()
        if isinstance(self.lp, DenseLP):
            return np.asarray(y * f[1] if f else y, np.float64)
        return self._gather_row_dual(y, "E", f[1] if f else None)

    def gatherDualSolutionIneq(self) -> np.ndarray:
        self._require_result()
        ps = self._postsolve()
        if ps is not None:
            return np.concatenate([ps.z0, ps.zN.reshape(-1), ps.zl])
        z = self._iterate().z
        f = self._factors()
        if isinstance(self.lp, DenseLP):
            return np.asarray(z * f[2] if f else z, np.float64)
        return self._gather_row_dual(z, "I", f[2] if f else None)

    # ------------------------------------------------------------------
    # slack / bound-gap gathers (reference gatherSlacks*,
    # PIPSIPMppInterface.cpp:386-400).  Without presolve these return the
    # iterate's gap vectors unscaled; with presolve the gaps are
    # reconstructed in the original space from the postsolved solution
    # (exact at convergence: the rv/rw/rt/ru residuals are ~0, reference
    # Residuals.h:84-87).
    def _gather_x_gap(self, vec) -> np.ndarray:
        """x-space gap (v or w): unscale = multiply by the column factors
        (x' = x/s => gaps scale like x)."""
        f = self._factors()
        if isinstance(self.lp, DenseLP):
            v = np.asarray(vec, np.float64)
            return v * f[0] if f else v
        first = np.asarray(vec.first, np.float64)
        blocks = vec.blocks
        if f is not None:
            first = first * f[0].first
            blocks = _blocks_op(blocks, f[0].blocks, np.multiply)
        return self._flatcat(first, blocks)

    def _gather_row_gap(self, vec, which: str) -> np.ndarray:
        """ineq-row-space gap (t or u): unscale = divide by the row factors
        (slack' = rC * slack)."""
        f = self._factors()
        if isinstance(self.lp, DenseLP):
            v = np.asarray(vec, np.float64)
            return v / f[2] if f else v
        first = np.asarray(vec.first, np.float64)
        blocks = vec.blocks
        link = self._unpermute_link(np.asarray(vec.link, np.float64), which)
        if f is not None:
            rc = f[2]
            first = first / rc.first
            blocks = _blocks_op(blocks, rc.blocks, np.divide)
            link = link / np.asarray(rc.link, np.float64)
        return self._flatcat(first, blocks, link)

    def _gather_bound_dual(self, vec) -> np.ndarray:
        """x-space bound dual (gamma or phi): unscale = divide by the
        column factors."""
        f = self._factors()
        if isinstance(self.lp, DenseLP):
            v = np.asarray(vec, np.float64)
            return v / f[0] if f else v
        first = np.asarray(vec.first, np.float64)
        blocks = vec.blocks
        if f is not None:
            first = first / f[0].first
            blocks = _blocks_op(blocks, f[0].blocks, np.divide)
        return self._flatcat(first, blocks)

    def _orig_var_bounds(self):
        """(ixlow, xlow, ixupp, xupp) flattened in the original space."""
        g = self._np
        if isinstance(self.lp, DenseLP):
            return g("ixlow"), g("xlow"), g("ixupp"), g("xupp")
        if isinstance(self.lp, BucketedArrowheadLP):
            return tuple(self._flatcat(self._np0(a), g(b)) for a, b in
                         (("ixlow0", "ixlowN"), ("xlow0", "xlowN"),
                          ("ixupp0", "ixuppN"), ("xupp0", "xuppN")))
        return tuple(self._flatcat(g(a), g(b)) for a, b in
                     (("ixlow0", "ixlowN"), ("xlow0", "xlowN"),
                      ("ixupp0", "ixuppN"), ("xupp0", "xuppN")))

    def _orig_row_bounds(self):
        """(iclow, clow, icupp, cupp) of the ineq rows, flattened."""
        g = self._np
        if isinstance(self.lp, DenseLP):
            return g("iclow"), g("clow"), g("icupp"), g("cupp")
        if isinstance(self.lp, BucketedArrowheadLP):
            return tuple(self._flatcat(self._np0(k + "0"), g(k + "N"),
                                       self._np0(k + "l"))
                         for k in ("iclow", "clow", "icupp", "cupp"))
        return tuple(self._flatcat(g(k + "0"), g(k + "N"), g(k + "l"))
                     for k in ("iclow", "clow", "icupp", "cupp"))

    def gatherSlacksVarsLow(self) -> np.ndarray:
        """v = x - xlow on lower-bounded variables (reference :398)."""
        self._require_result()
        if self._presolve_log is not None:
            x = self.gatherPrimalSolution()
            il, lo, _, _ = self._orig_var_bounds()
            return il * (x - lo)
        return self._gather_x_gap(self._iterate().v)

    def gatherSlacksVarsUp(self) -> np.ndarray:
        """w = xupp - x on upper-bounded variables (reference :394)."""
        self._require_result()
        if self._presolve_log is not None:
            x = self.gatherPrimalSolution()
            _, _, iu, up = self._orig_var_bounds()
            return iu * (up - x)
        return self._gather_x_gap(self._iterate().w)

    def gatherSlacksInequalityLow(self) -> np.ndarray:
        """t = s - clow on lower-bounded ineq rows (reference :390)."""
        self._require_result()
        if self._presolve_log is not None:
            cx = self.gatherInequalityConsValues()
            il, lo, _, _ = self._orig_row_bounds()
            return il * (cx - lo)
        return self._gather_row_gap(self._iterate().t, "I")

    def gatherSlacksInequalityUp(self) -> np.ndarray:
        """u = cupp - s on upper-bounded ineq rows (reference :386)."""
        self._require_result()
        if self._presolve_log is not None:
            cx = self.gatherInequalityConsValues()
            _, _, iu, up = self._orig_row_bounds()
            return iu * (up - cx)
        return self._gather_row_gap(self._iterate().u, "I")

    # ------------------------------------------------------------------
    # bound-dual gathers (reference gatherDualSolutionVarBounds*/IneqUpp/
    # IneqLow, :302-335).  With presolve, bound duals are recovered from
    # the sign-split reduced costs / ineq duals (standard LP dual
    # recovery; exact at complementarity).
    def _reduced_cost(self) -> np.ndarray:
        """c - A'y - C'z in the original space (= gamma - phi at KKT)."""
        return self._cached("red", self._reduced_cost_impl)

    def _reduced_cost_impl(self) -> np.ndarray:
        y = self.gatherDualSolutionEq()
        z = self.gatherDualSolutionIneq()
        lp, g = self.lp, self._np
        if isinstance(lp, DenseLP):
            return g("c") - g("A").T @ y - g("C").T @ z
        if isinstance(lp, BucketedArrowheadLP):
            return self._bucketed_reduced_cost(y, z)
        y0, yN, yl = (y[:lp.m0E], y[lp.m0E:lp.m0E + lp.N * lp.mE]
                      .reshape(lp.N, lp.mE), y[lp.m0E + lp.N * lp.mE:])
        z0, zN, zl = (z[:lp.m0I], z[lp.m0I:lp.m0I + lp.N * lp.mI]
                      .reshape(lp.N, lp.mI), z[lp.m0I + lp.N * lp.mI:])
        g0 = (g("A0").T @ y0 + np.einsum("nij,ni->j", g("A"), yN)
              + g("F0").T @ yl + g("C0").T @ z0
              + np.einsum("nij,ni->j", g("C"), zN) + g("G0").T @ zl)
        # B'y / D'z through the stored transposes when the diagonal blocks
        # are ELL (sparse problems that were not densified)
        if isinstance(lp, SparseArrowheadLP):
            BtY = self._bd_mv(g("Bt"), yN)
            DtZ = self._bd_mv(g("Dt"), zN)
        else:
            BtY = np.einsum("nij,ni->nj", g("B"), yN)
            DtZ = np.einsum("nij,ni->nj", g("D"), zN)
        gN = (BtY + np.einsum("nij,i->nj", g("F"), yl)
              + DtZ + np.einsum("nij,i->nj", g("G"), zl))
        c = np.concatenate([g("c0"), g("cN").reshape(-1)])
        return c - np.concatenate([g0, gN.reshape(-1)])

    def _bucketed_reduced_cost(self, y, z) -> np.ndarray:
        """c - A'y - C'z of a bucketed LP from the gathered (unscaled)
        duals.  The JAX package reads the solver's iterate here, which
        differs from the gathered duals under a scaler (ROADMAP.md §3, F7);
        without one the two agree."""
        lp, g, g0 = self.lp, self._np, self._np0
        m0E, m0I = lp.buckets[0].m0E, lp.buckets[0].m0I
        y0, yl = y[:m0E], y[len(y) - lp.buckets[0].mEl:]
        z0, zl = z[:m0I], z[len(z) - lp.buckets[0].mIl:]
        gf = (g0("A0").T @ y0 + g0("F0").T @ yl + g0("C0").T @ z0
              + g0("G0").T @ zl)
        gN, oy, oz = [], m0E, m0I
        for b, A, B, C, D, F, G in zip(lp.buckets, g("A"), g("B"), g("C"),
                                       g("D"), g("F"), g("G")):
            yb = y[oy:oy + b.N * b.mE].reshape(b.N, b.mE)
            zb = z[oz:oz + b.N * b.mI].reshape(b.N, b.mI)
            oy, oz = oy + b.N * b.mE, oz + b.N * b.mI
            gf = gf + (np.einsum("nij,ni->j", A, yb)
                       + np.einsum("nij,ni->j", C, zb))
            gN.append(np.einsum("nij,ni->nj", B, yb)
                      + np.einsum("nij,i->nj", F, yl)
                      + np.einsum("nij,ni->nj", D, zb)
                      + np.einsum("nij,i->nj", G, zl))
        c = self._flatcat(g0("c0"), g("cN"))
        return c - self._flatcat(gf, gN)

    def gatherDualSolutionVarBoundsLow(self) -> np.ndarray:
        """gamma (dual of x >= xlow), reference :333."""
        self._require_result()
        if self._presolve_log is not None:
            rc = self._reduced_cost()
            il, _, _, _ = self._orig_var_bounds()
            return il * np.maximum(rc, 0.0)
        return self._gather_bound_dual(self._iterate().gamma)

    def gatherDualSolutionVarBoundsUpp(self) -> np.ndarray:
        """phi (dual of x <= xupp), reference :328."""
        self._require_result()
        if self._presolve_log is not None:
            rc = self._reduced_cost()
            _, _, iu, _ = self._orig_var_bounds()
            return iu * np.maximum(-rc, 0.0)
        return self._gather_bound_dual(self._iterate().phi)

    def gatherDualSolutionVarBounds(self) -> np.ndarray:
        """gamma - phi (low minus upp, reference :312-324)."""
        return (self.gatherDualSolutionVarBoundsLow()
                - self.gatherDualSolutionVarBoundsUpp())

    def _gather_ineq_bound_dual(self, vec) -> np.ndarray:
        """lambda or pi: a row-space dual, unscaled like z (multiply by
        the row factors)."""
        f = self._factors()
        if isinstance(self.lp, DenseLP):
            v = np.asarray(vec, np.float64)
            return v * f[2] if f else v
        return self._gather_row_dual(vec, "I", f[2] if f else None)

    def gatherDualSolutionIneqLow(self) -> np.ndarray:
        """lambda (dual of C x >= clow), reference :307."""
        self._require_result()
        if self._presolve_log is not None:
            z = self.gatherDualSolutionIneq()
            il, _, _, _ = self._orig_row_bounds()
            return il * np.maximum(z, 0.0)
        return self._gather_ineq_bound_dual(self._iterate().lam)

    def gatherDualSolutionIneqUpp(self) -> np.ndarray:
        """pi (dual of C x <= cupp), reference :302."""
        self._require_result()
        if self._presolve_log is not None:
            z = self.gatherDualSolutionIneq()
            _, _, iu, _ = self._orig_row_bounds()
            return iu * np.maximum(-z, 0.0)
        return self._gather_ineq_bound_dual(self._iterate().pi)

    # ------------------------------------------------------------------
    # residual gathers (reference gatherPrimalResids*/gatherDualResids,
    # :403-417), evaluated in the ORIGINAL space from the gathered
    # solution, so they are meaningful after presolve and scaling too.
    def gatherPrimalResidsEQ(self) -> np.ndarray:
        """rA = A x - b (reference :403)."""
        self._require_result()
        ax = self.gatherEqualityConsValues()
        g = self._np
        if isinstance(self.lp, DenseLP):
            return ax - g("b")
        if isinstance(self.lp, BucketedArrowheadLP):
            return ax - self._flatcat(self._np0("b0"), g("bN"),
                                      self._np0("bl"))
        return ax - self._flatcat(g("b0"), g("bN"), g("bl"))

    def gatherPrimalResidsIneqLow(self) -> np.ndarray:
        """rt = min(C x - clow, 0) violation on lower-bounded rows
        (reference rt, :411)."""
        self._require_result()
        cx = self.gatherInequalityConsValues()
        il, lo, _, _ = self._orig_row_bounds()
        return il * np.minimum(cx - lo, 0.0)

    def gatherPrimalResidsIneqUp(self) -> np.ndarray:
        """ru = max(C x - cupp, 0) violation on upper-bounded rows
        (reference ru, :407)."""
        self._require_result()
        cx = self.gatherInequalityConsValues()
        _, _, iu, up = self._orig_row_bounds()
        return iu * np.maximum(cx - up, 0.0)

    def gatherDualResids(self) -> np.ndarray:
        """Lagrangian gradient c - A'y - C'z - gamma + phi (reference
        :415)."""
        self._require_result()
        return (self._reduced_cost()
                - self.gatherDualSolutionVarBoundsLow()
                + self.gatherDualSolutionVarBoundsUpp())

    # ------------------------------------------------------------------
    def getFirstStageObjective(self) -> float:
        """c0' x0 in the original space (reference :213-218)."""
        self._require_result()
        x = self.gatherPrimalSolution()
        if isinstance(self.lp, DenseLP):
            return float(np.dot(self._np("c"), x))
        return float(np.dot(self._np0("c0"), x[:self.lp.n0]))

    def getFirstStagePrimalColSolution(self) -> np.ndarray:
        """x0 (reference :419-422)."""
        self._require_result()
        x = self.gatherPrimalSolution()
        return x if isinstance(self.lp, DenseLP) else x[:self.lp.n0]

    def getSecondStagePrimalColSolution(self, scen: int) -> np.ndarray:
        """x_scen (reference :424-430)."""
        self._require_result()
        lp = self.lp
        if isinstance(lp, DenseLP):
            raise TypeError("second-stage solution requires ArrowheadLP")
        x = self.gatherPrimalSolution()
        if isinstance(lp, BucketedArrowheadLP):
            bi, pos = lp.placement[scen]
            off = lp.n0 + sum(b.N * b.n for b in lp.buckets[:bi])
            nb = lp.buckets[bi].n
            return x[off + pos * nb: off + (pos + 1) * nb]
        return x[lp.n0 + scen * lp.n: lp.n0 + (scen + 1) * lp.n]

    def allgatherBlocksizes(self) -> tuple:
        """Per-block (column, equality-row, inequality-row) lengths of the
        ORIGINAL problem, as three uint32 arrays:

        - cols:  [n0, n_1, ..., n_N]                       (N+1 entries)
        - eq:    [m0E, mE_1, ..., mE_N, mEl]               (N+2 entries)
        - ineq:  [m0I, mI_1, ..., mI_N, mIl]               (N+2 entries)

        Reference PIPSIPMppInterface::allgatherBlocksizes
        (PIPSIPMppInterface.hpp:84, .cpp:432-497): ranks sum their local
        child lengths; here one device holds every block, so the
        "allgather" is a direct read."""
        lp = self.lp
        if isinstance(lp, DenseLP):
            raise TypeError("allgatherBlocksizes requires a block problem")
        u32 = np.uint32
        if isinstance(lp, BucketedArrowheadLP):
            b0 = lp.buckets[0]
            cols = [lp.n0] + [lp.buckets[bi].n for bi, _ in lp.placement]
            eq = ([b0.m0E] + [lp.buckets[bi].mE for bi, _ in lp.placement]
                  + [b0.mEl])
            ineq = ([b0.m0I] + [lp.buckets[bi].mI for bi, _ in lp.placement]
                    + [b0.mIl])
            return (np.array(cols, u32), np.array(eq, u32),
                    np.array(ineq, u32))
        cols = np.full(lp.N + 1, lp.n, u32)
        cols[0] = lp.n0
        eq = np.full(lp.N + 2, lp.mE, u32)
        eq[0], eq[-1] = lp.m0E, lp.mEl
        ineq = np.full(lp.N + 2, lp.mI, u32)
        ineq[0], ineq[-1] = lp.m0I, lp.mIl
        return cols, eq, ineq

    def printComplementarityResiduals(self) -> dict:
        """inf-norms of the complementarity products v*gamma, w*phi,
        t*lambda, u*pi (reference printComplementarityResiduals,
        :497-528).  Returns the norms and prints them."""
        norms = self.complementarityResiduals()
        for name, v in norms.items():
            print(f"complementarity {name}: {v:.3e}")
        return norms

    def complementarityResiduals(self) -> dict:
        """The norms `printComplementarityResiduals` prints."""
        self._require_result()
        pairs = {
            "vars_low (v*gamma)": (self.gatherSlacksVarsLow(),
                                   self.gatherDualSolutionVarBoundsLow()),
            "vars_upp (w*phi)": (self.gatherSlacksVarsUp(),
                                 self.gatherDualSolutionVarBoundsUpp()),
            "ineq_low (t*lambda)": (self.gatherSlacksInequalityLow(),
                                    self.gatherDualSolutionIneqLow()),
            "ineq_upp (u*pi)": (self.gatherSlacksInequalityUp(),
                                self.gatherDualSolutionIneqUpp()),
        }
        return {name: float(np.max(np.abs(a * b))) if a.size else 0.0
                for name, (a, b) in pairs.items()}
