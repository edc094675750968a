"""The CG route's λ operators and preconditioners.

Counterpart of the iterative branch of ``networks_fenicsx_tpu/solver.py``:
``_mg2d_feasible`` (``:1303-1312``) and ``_plan_mg`` (``:1441-1479``) as host
NumPy, ``np.array_equal`` to the reference's; the preconditioner choice of
``_finish`` (``:4168-4232``, :func:`choose_preconditioner`); the 2-D
aggregation V-cycle ``_mg2d_preconditioner`` (``:1315-1438``,
:class:`Mg2dPreconditioner`, on K19c) and the 1-D pairing V-cycle
``_mg_preconditioner`` (``:1482-1558``, :class:`Mg1dPreconditioner`, on
K19d's fused cycle; its plain loop on K18's matvecs and steps); and the λ
operators the CG loop and the
smoothers apply: :class:`ShiftOperator` (K18, a graph with a shift plan) and
:class:`GatherOperator` (K19b, ``_matvec_from_plan``, any other graph).

A hierarchy is built once per solve, outside the CG loop, from that
solve's class weights (which follow the runtime R); its shapes, and the 1-D
plan's parity mapping tables, once per executor.  ``plain=True`` runs every
piece on its kernel's plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kernels import gather_matvec, krylov, mg1d, mg2d, shift_matvec
from .ops.krylov import chebyshev_coefficients, chebyshev_preconditioner

__all__ = [
    "_mg2d_feasible", "_plan_mg", "choose_preconditioner", "mg2d_plan", "device_mg1d_plan",
    "Mg2dPlan", "Mg1dLevel", "Mg1dPlan", "Mg2dPreconditioner", "Mg1dPreconditioner",
    "ShiftOperator", "GatherOperator",
]

SMOOTH_DEGREE = 3  # the V-cycles' Chebyshev smoothers: degree 3 on [λmax/4, λmax]
SMOOTH_RATIO = 4.0


# ------------------------------------------------------------ host plans


def _mg2d_feasible(B: int, stride: int, max_coarsest: int = 4096) -> bool:
    """Host check that 2×2 coarsening reaches a small coarsest grid."""
    ny, nx = B // stride, stride
    while min(ny, nx) > 4 and ny * nx > 256:
        ny, nx = (ny + 1) // 2, (nx + 1) // 2
    return ny * nx <= max_coarsest


def _plan_mg(deltas, B: int, coarsest: int = 512, max_classes: int = 16):
    """Host plan of the shift-preserving pairwise-aggregation multigrid:
    ``(levels, coarsest_m, coarsest_classes)`` or None; each level is
    ``(m, classes, mapping, mc)`` with ``mapping`` a tuple of
    ``(Δ, ((class_index, parity), ...))``, ``Δ = (p + δ) // 2 ≠ 0``."""
    levels = []
    classes = tuple(sorted(int(d) for d in deltas))
    m = B
    while m > coarsest:
        mc = (m + 1) // 2
        mapping: dict[int, list] = {}
        for ci, d in enumerate(classes):
            for p in (0, 1):
                D = (p + d) // 2
                if D != 0:
                    mapping.setdefault(D, []).append((ci, p))
        if len(mapping) > max_classes:
            break
        levels.append(
            (m, classes, tuple(sorted((k, tuple(v)) for k, v in mapping.items())), mc)
        )
        classes = tuple(sorted(mapping.keys()))
        m = mc
    if not levels:
        return None
    return levels, m, classes


def choose_preconditioner(opts, shift_plan, B: int):
    """The reference's preconditioner choice (``:4168-4232``):
    ``("2d", stride)``, ``("1d", plan)``, ``("chebyshev", degree)`` or
    ``("jacobi", None)``; its ``ValueError``s for an unknown ``cg_precond``
    and for ``"mg"`` on a graph that does not qualify."""
    if opts.cg_precond not in ("auto", "mg", "chebyshev", "jacobi"):
        raise ValueError(
            f"unknown cg_precond {opts.cg_precond!r}; expected "
            "'auto', 'mg', 'chebyshev' or 'jacobi'"
        )
    mg_kind = None
    deltas = [c[0] for c in shift_plan] if shift_plan else []
    if shift_plan is not None and opts.cg_precond in ("auto", "mg"):
        # auto: multigrid above 32,768 multipliers
        if opts.cg_precond == "mg" or B > 32768:
            strides = sorted({abs(d) for d in deltas} - {1})
            row_ok = True
            for d, rows, _ in shift_plan:
                # ±1 couplings must not cross 2-D row boundaries
                if strides and d == 1:
                    row_ok &= bool(np.all(rows % strides[0] != strides[0] - 1))
                if strides and d == -1:
                    row_ok &= bool(np.all(rows % strides[0] != 0))
            if (
                len(strides) == 1
                and strides[0] > 2
                and B % strides[0] == 0
                and row_ok
                and _mg2d_feasible(B, strides[0])
            ):
                mg_kind = ("2d", strides[0])
            else:
                plan1d = _plan_mg(deltas, B)
                if plan1d is not None:
                    mg_kind = ("1d", plan1d)
    if mg_kind is None and opts.cg_precond == "mg":
        raise ValueError(
            "cg_precond='mg' requires a few-shift-class topology "
            "(lattice-like multiplier graph); this network does "
            "not qualify — use 'auto' or 'chebyshev'"
        )
    if mg_kind is not None:
        return mg_kind
    if opts.cheb_degree > 1 and opts.cg_precond != "jacobi":
        return ("chebyshev", opts.cheb_degree)
    return ("jacobi", None)


@dataclasses.dataclass(frozen=True)
class Mg2dPlan:
    """The 2-D hierarchy's shapes: the ``(ny, nx)`` of each smoothed level,
    the coarsest grid, and the class index of each direction E, W, S, N in
    the shift plan (−1 when absent)."""

    shapes: tuple
    bottom: tuple
    dirs: tuple

    @property
    def bottom_offsets(self) -> np.ndarray:
        nxb = self.bottom[1]
        return np.asarray([1, -1, nxb, -nxb], dtype=np.int32)


def mg2d_plan(offsets, B: int, stride: int) -> Mg2dPlan:
    """The level shapes of the reference's coarsening loop (``:1360``)."""
    shape, shapes = (B // stride, stride), []
    while min(shape) > 4 and shape[0] * shape[1] > 256:
        shapes.append(shape)
        shape = ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    at = {int(d): c for c, d in enumerate(np.asarray(offsets).tolist())}
    dirs = tuple(at.get(d, -1) for d in (1, -1, stride, -stride))
    return Mg2dPlan(tuple(shapes), shape, dirs)


@dataclasses.dataclass(frozen=True)
class Mg1dLevel:
    """One level of :func:`_plan_mg` on a device: its size, class offsets,
    host mapping, the mapping as int32 tables (per coarse class a run of
    ``(class index, parity)`` pairs: ``map_ptr`` offsets, ``map_ci``,
    ``map_p``) and K18's :class:`.kernels.shift_matvec.ShiftPlan` of its
    classes."""

    m: int
    mc: int
    offsets: np.ndarray
    mapping: tuple
    map_ptr: torch.Tensor
    map_ci: torch.Tensor
    map_p: torch.Tensor
    shift: shift_matvec.ShiftPlan  # K18's plan of the level's matvec and smoother


@dataclasses.dataclass(frozen=True)
class Mg1dPlan:
    levels: tuple
    m_bottom: int
    bottom_offsets: np.ndarray


def device_mg1d_plan(plan, device) -> Mg1dPlan:
    """Upload :func:`_plan_mg`'s mapping tables (once per executor)."""

    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    levels_host, m_bot, classes_bot = plan
    levels = []
    for m, classes, mapping, mc in levels_host:
        runs = [contribs for _, contribs in mapping]
        levels.append(Mg1dLevel(
            m=m, mc=mc, offsets=np.asarray(classes, dtype=np.int32), mapping=mapping,
            map_ptr=i32(np.concatenate([[0], np.cumsum([len(c) for c in runs])])),
            map_ci=i32([ci for c in runs for ci, _ in c]),
            map_p=i32([p for c in runs for _, p in c]),
            shift=shift_matvec.ShiftPlan(classes, m, device),
        ))
    return Mg1dPlan(tuple(levels), m_bot, np.asarray(classes_bot, dtype=np.int32))


# ------------------------------------------------------------- operators


class ShiftOperator:
    """The λ operator by shift classes (K18): ``plan`` a
    :class:`.kernels.shift_matvec.ShiftPlan` made once for the classes,
    ``cw`` ``(C, m)``, ``diag`` ``(m,)``."""

    def __init__(self, plan, cw, diag, plain: bool = False):
        self.offsets, self.cw, self.diag, self.plain = plan.offsets, cw, diag, plain
        # the plain versions take the host offsets, the kernels the plan
        self._key = plan.offsets if plain else plan
        self._apply = shift_matvec.shift_matvec_plain if plain else shift_matvec.shift_matvec
        self._cheb = shift_matvec.shift_cheb_plain if plain else shift_matvec.shift_cheb

    def apply(self, x):
        return self._apply(self._key, self.cw, self.diag, x)

    def residual(self, b, x, norm: bool = False):
        return self._apply(self._key, self.cw, self.diag, x, b, norm)

    def step(self, s, rs, dvec, x_in, x_out, c1, c2, z=None, base=None):
        self._cheb(self._key, self.cw, self.diag, s, rs, dvec, x_in, x_out, c1, c2, z, base)

    def chebyshev(self, degree: int):
        """The Chebyshev-Jacobi preconditioner of ``degree`` on this operator's steps."""
        return chebyshev_preconditioner(self.step, self.diag, degree=degree, plain=self.plain)


class GatherOperator:
    """A solve's λ operator by gather and fold (K19b): ``plan`` a
    :class:`.kernels.gather_matvec.GatherPlan` made once for the executor's
    tables, ``w = 1/W`` per edge, ``diag``.

    The kernels read the solve's value table ``−w[mv_edge]``, gathered here
    (one launch); :meth:`chebyshev` makes a whole Chebyshev-Jacobi
    application one host call (:class:`.kernels.gather_matvec.ChebApply`).
    ``plain=True`` runs the plain versions on the plan's tables, the
    Chebyshev application as the composed plain steps (:meth:`step`)."""

    def __init__(self, plan, w, diag, plain: bool = False):
        self.plan, self.w, self.diag, self.plain = plan, w, diag, plain
        self.tables = (plan.mv_edge, plan.mv_other)
        self.vals = None if plain else gather_matvec.gather_values(plan, w)

    def apply(self, x):
        if self.plain:
            return gather_matvec.gather_matvec_plain(*self.tables, self.w, self.diag, x)
        return gather_matvec.gather_matvec(self.plan, self.vals, self.diag, x)

    def residual(self, b, x, norm: bool = False):
        if self.plain:
            return gather_matvec.gather_matvec_plain(*self.tables, self.w, self.diag, x, b, norm)
        return gather_matvec.gather_matvec(self.plan, self.vals, self.diag, x, b, norm)

    def step(self, s, rs, dvec, x_in, x_out, c1, c2, z=None, base=None):
        """One step of the composed application (the plain path's: on the
        card an application runs whole, :meth:`chebyshev`)."""
        if not self.plain and x_in.is_cuda:
            raise ValueError("GatherOperator: on CUDA a Chebyshev application runs whole (chebyshev)")
        gather_matvec.gather_cheb_plain(*self.tables, self.w, self.diag, s, rs, dvec, x_in, x_out, c1, c2, z,
                                        base)

    def chebyshev(self, degree: int):
        """The Chebyshev-Jacobi preconditioner of ``degree``: one
        :class:`.kernels.gather_matvec.ChebApply`, or with ``plain`` the
        composed plain steps."""
        if self.plain:
            return chebyshev_preconditioner(self.step, self.diag, degree=degree, plain=True)
        theta, coeffs = chebyshev_coefficients(degree)
        return gather_matvec.ChebApply(self.plan, self.vals, self.diag, krylov.inv_sqrt(self.diag), theta,
                                       coeffs)


# ----------------------------------------------------------- V-cycles


class _Mg2d:
    """K19c's wrappers, or their plain versions; the level loop's smoother
    step and transfers are plain versions always (on CUDA the kernels run
    them fused, in :class:`.kernels.mg2d.Cycle`)."""

    def __init__(self, plain: bool):
        for name in ("level0", "coarsen", "stencil", "coarse_factor", "coarse_solve"):
            setattr(self, name, getattr(mg2d, name + "_plain" if plain else name))
        self.cheb, self.restrict, self.prolong = mg2d.cheb_plain, mg2d.restrict_plain, mg2d.prolong_plain


class Mg2dPreconditioner:
    """The symmetric 2-D aggregation V-cycle for ``{±1, ±stride}`` classes
    (reference ``:1315-1438``): per level a degree-3 Chebyshev smoother, the
    restricted residual, the over-corrected coarse correction and a
    post-smoothing; the coarsest banded system by Cholesky.

    On a CUDA device the smoothed levels run as one :class:`.kernels.mg2d.Cycle`
    (checked once here): 6 launches a level — the smoother's start folded
    into its first step, its second step, the residual and restriction in
    one, the prolongation and the next residual in one, the post-smoother's
    two — issued in two host calls around the coarsest solve (a hierarchy
    without smoothed levels is the coarsest solve alone).  ``plain=True`` or
    CPU tensors run the composed plain versions level by level."""

    def __init__(self, plan: Mg2dPlan, cw, diag, overcorrect: float = 1.8, plain: bool = False):
        self.plan, self.overcorrect = plan, float(overcorrect)
        self.k = k = _Mg2d(plain)
        levels = [k.level0(cw, plan.dirs, diag)]
        for f, c in zip(plan.shapes, plan.shapes[1:] + (plan.bottom,)):
            levels.append(k.coarsen(levels[-1], f, c))
        self.levels, self.bottom = levels[:-1], levels[-1]
        self.factor = k.coarse_factor(plan.bottom_offsets, self.bottom[:4], self.bottom[mg2d.FD])
        self.cycle, self.smoothers = None, []
        if not plain and diag.is_cuda:  # the kernels: a Cycle, or the coarsest solve alone
            if self.levels:
                theta, coeffs = chebyshev_coefficients(SMOOTH_DEGREE, ratio=SMOOTH_RATIO)
                self.cycle = mg2d.Cycle(self.levels, plan.shapes, plan.bottom, theta, coeffs,
                                        self.overcorrect)
            return
        self.smoothers = [
            chebyshev_preconditioner(self._step(lev, shape), degree=SMOOTH_DEGREE, ratio=SMOOTH_RATIO,
                                     plain=plain, d_isqrt=lev[mg2d.FI])
            for lev, shape in zip(self.levels, plan.shapes)
        ]

    def _step(self, lev, shape):
        cheb = self.k.cheb

        def step(s, rs, dvec, x_in, x_out, c1, c2, z=None, base=None):
            del s  # the level's own scaling field
            cheb(lev, shape, rs, dvec, x_in, x_out, c1, c2, z, base)

        return step

    def __call__(self, r):
        if self.cycle is None:
            return self._vcycle(0, r)
        rb = self.cycle.down(r)
        return self.cycle.up(r, self.k.coarse_solve(self.factor, rb))

    def _vcycle(self, lvl: int, r):
        k = self.k
        if lvl == len(self.levels):
            return k.coarse_solve(self.factor, r)
        lev, sm = self.levels[lvl], self.smoothers[lvl]
        shape = self.plan.shapes[lvl]
        shape_c = (self.plan.shapes + (self.plan.bottom,))[lvl + 1]
        x = sm(r)
        rc = k.restrict(k.stencil(lev, shape, x, r), shape, shape_c)
        k.prolong(x, shape, shape_c, self._vcycle(lvl + 1, rc), self.overcorrect)
        sm(k.stencil(lev, shape, x, r), out=x, base=x)
        return x


class _Mg1d:
    """K19d's hierarchy wrappers (and K19c's coarsest solve), or their plain
    versions; the level loop's transfers are plain versions always (on CUDA
    the kernels run them fused, in :class:`.kernels.mg1d.Cycle`)."""

    def __init__(self, plain: bool):
        for name in ("level0", "coarsen"):
            setattr(self, name, getattr(mg1d, name + "_plain" if plain else name))
        for name in ("coarse_factor", "coarse_solve"):
            setattr(self, name, getattr(mg2d, name + "_plain" if plain else name))
        self.restrict, self.prolong = mg1d.restrict_plain, mg1d.prolong_plain


class Mg1dPreconditioner:
    """The symmetric V-cycle over the shift-class hierarchy of
    :func:`_plan_mg` (reference ``:1482-1558``): per level a degree-3
    Chebyshev smoother, pair-sum restriction, the over-corrected repeat
    prolongation; the coarsest banded system by Cholesky.

    On a CUDA device the smoothed levels (:class:`.kernels.mg1d.Level`: each
    level's ``ShiftPlan`` offsets, class weights, diagonal and scaling) run
    as one :class:`.kernels.mg1d.Cycle` (checked once here): 6 launches a
    level — the smoother's start folded into its first step, its second
    step, the residual and restriction in one, the prolongation and the next
    residual in one, the post-smoother's two — issued in two host calls
    around the coarsest solve, so a cycle is 3 host calls.  ``plain=True``
    or CPU tensors run the composed plain versions level by level (K19a's
    start, K18's steps and residuals, the pair sums and the repeat)."""

    def __init__(self, plan: Mg1dPlan, offsets, cw, diag, overcorrect: float = 1.8,
                 plain: bool = False):
        del offsets  # each level carries its own classes
        self.plan, self.overcorrect = plan, float(overcorrect)
        self.k = k = _Mg1d(plain)
        extra, dis = k.level0(cw, diag)
        self.levels = []
        for lvl in plan.levels:
            self.levels.append(mg1d.Level(lvl.shift.offsets, cw, diag, dis))
            cw, extra, diag, dis = k.coarsen(lvl, cw, extra)
        self.factor = k.coarse_factor(plan.bottom_offsets, cw, diag)
        self.cycle, self.ops, self.smoothers = None, [], []
        if not plain and diag.is_cuda:  # the kernels: a Cycle, or the coarsest solve alone
            if self.levels:
                theta, coeffs = chebyshev_coefficients(SMOOTH_DEGREE, ratio=SMOOTH_RATIO)
                self.cycle = mg1d.Cycle(self.levels, theta, coeffs, self.overcorrect)
            return
        for lvl, lev in zip(plan.levels, self.levels):
            op = ShiftOperator(lvl.shift, lev.cw, lev.diag, plain)
            self.ops.append(op)
            self.smoothers.append(chebyshev_preconditioner(
                op.step, degree=SMOOTH_DEGREE, ratio=SMOOTH_RATIO, plain=plain, d_isqrt=lev.dis))

    def __call__(self, r):
        if self.cycle is None:
            return self._vcycle(0, r)
        rb = self.cycle.down(r)
        return self.cycle.up(r, self.k.coarse_solve(self.factor, rb))

    def _vcycle(self, lvl: int, r):
        k = self.k
        if lvl == len(self.ops):
            return k.coarse_solve(self.factor, r)
        op, sm = self.ops[lvl], self.smoothers[lvl]
        x = sm(r)
        rc = k.restrict(op.residual(r, x), self.plan.levels[lvl].mc)
        k.prolong(x, self._vcycle(lvl + 1, rc), self.overcorrect)
        sm(op.residual(r, x), out=x, base=x)
        return x
