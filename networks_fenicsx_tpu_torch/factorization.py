"""Factor reuse: one resistance-side factorization, many right-hand sides.

Counterpart of ``networks_fenicsx_tpu/solver.py``'s
:class:`BlockedFactorization`, :class:`GridFactorization` and
:class:`TreeFactorization` (``:2996-3631``), what ``Solver.factorize()``
serves from (the reference's KSP keeps its factorization across solves).
Each class takes the assembler, the options and an explicit device (as the
executors: ``"cuda"`` raises without CUDA, ``"cpu"`` runs the plain
versions of the kernels) and raises the reference's ``ValueError`` outside
its envelope.  :meth:`factor` takes the public-order ``R_data`` and keeps
on the device what depends on R alone; :meth:`solve` (or
:meth:`prepare_rhs` once and :meth:`solve_prepared` many times) runs the
right-hand side against it, and :meth:`solution_vector` maps the blocks to
the global layout.

* :class:`BlockedFactorization` — uniformly-K-ary forests: the factor is K1
  (:mod:`.kernels.condense`) and K2 (``tree_sweep_factor``: the folded
  diagonal, the in-edge conductances and the factors); the solve is K1 whole
  on the resident R (the factor's ``W, w`` bits again, with the new ``g``,
  ``Ftot`` and ``const``), K3–K4 (``tree_sweep_apply``) and K5
  (:mod:`.kernels.expand`).  Returns ``(q_T, p_T, λ, ‖rhs‖, finite)``.
* :class:`GridFactorization` — uniform scalar-R lattices: the factor is K1
  and K16's factor (``dct_factor``: the eigenvalue inverse, the stub columns
  and the bordered inverse); the solve is K1, K17's assembly, K16's passes on
  the stored factor (``dct_apply``) with K17's stencil, the residual norm and
  K5.  Returns ``(q_T, p_T, λ, ‖L λ − rhs‖, ‖rhs‖, finite)``.
* :class:`TreeFactorization` — any topology, in public edge order, on the
  tree plan with forced peel rounds: the factor is K1 (on a public-order
  plan), the bifurcation diagonal (the prepare kernel and K6), the pair
  conductances (K6), K9's ``d`` channel (``peel_factor``) and the core's
  factor — the multifrontal K13–K14 (``mf_factor``) for an ``MFPlan`` core,
  K12a's rounds with K11's factor and gate on the dense tail or K12b's
  fronts' factor (``core_factor``) for a min-degree ``CoreElimPlan`` core,
  K11's factor and gate (``dense_factor``, ``dense_gate``) without a core
  plan.  The solve is K1, the bifurcation rhs, K9's ``r`` channel
  (``peel_apply``) around the core's apply (K15 ``mf_apply``, K12a's
  ``core_apply`` with K11's solve or K12b's sweeps, K11's ``dense_solve``)
  and K5.  Returns ``(q_T, p_T, λ, ‖rhs‖, finite)``.

The solves are exact eliminations: ``Solver`` gates them on finiteness, and
only the lattice's reports its λ residual (``solve_has_residual``).
:meth:`solve_batch` runs many right-hand sides against one factor: the
reference's leading scenario axis over :meth:`solve`'s layouts, each row
:meth:`solve`'s bits.  The blocked class runs all rows in one launch of K1,
K3–K4 and K5 (their scenario axis), the lattice class in one launch of K1,
K17's assembly, K16's six a pass (on the stored factor, read at stride 0)
with K17's stencil and K5 (their scenario axis), the tree class with a
multifrontal or dense core (or none) in one launch of K1, the bifurcation
rhs and its norm, K9's ``r`` channel (``peel_apply_scenarios``) around the
core's apply over S (K15's, or K11's solves, on the stored factor read at
stride 0) and K5; a min-degree core's tree class a row at a time (K12a and
K12b have no scenario axis yet, ROADMAP A9b).
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .blocked import (
    _permute_coefficient, _permute_coefficient_batch, _plan_blocked, device_plan, ends_plan,
)
from .kernels import condense, core_elim, dct_lattice, dense_core, expand, grid_core, mf_apply
from .kernels import mf_factor
from .kernels import peel, segsum, tree_sweep
from .lattice import _plan_dct_lattice, _plan_grid_layout, _plan_shift_matvec, device_grid_plan
from .levels import _build_lambda_plan, _cached_tree_plan, attach_core_plan
from .ops.core_elim import CoreElimPlan
from .ops.multifrontal import MFPlan
from .solver import _flatten_blocks_host, resolve_device
from .tree import core_apply_scenarios, device_tree_plan
from .utils.config import SolverOptions

__all__ = [
    "BlockedFactorization", "GridFactorization", "TreeFactorization",
    "build_blocked_factorization", "build_grid_factorization", "build_tree_factorization",
]

_DIRECT_MODES = ("scalar", "edge", "cell")


def _check_options(opts: SolverOptions | None) -> SolverOptions:
    opts = opts or SolverOptions()
    if opts.dtype != "float64":
        raise NotImplementedError("ROADMAP A4: float32 solves and outputs are not ported yet")
    return opts


class BlockedState(typing.NamedTuple):
    """A blocked factorization's device state."""

    R: torch.Tensor  # the resident R rows, internal layout
    W: torch.Tensor  # (E,) edge resistances 1ᵀM1
    w: torch.Tensor  # (E,) conductances 1/W
    d: torch.Tensor  # (B,) folded diagonal
    wn: torch.Tensor  # (B,) in-edge conductances
    factor: torch.Tensor  # (B,) wn / d


class GridState(typing.NamedTuple):
    """A lattice factorization's device state."""

    R: torch.Tensor
    W: torch.Tensor
    w: torch.Tensor
    dct: dct_lattice.DctState


class TreeState(typing.NamedTuple):
    """A tree factorization's device state."""

    R: torch.Tensor
    W: torch.Tensor
    w: torch.Tensor
    w_pairs: torch.Tensor  # (P,) pair conductances
    peeled: peel.PeelFactor  # K9's d channel
    core: typing.Any  # MFState, CoreFactor, or K11's (Lc, s, C, ok); None without a core


class _Factorization:
    """What the three classes share: the device, the uploads, the rhs
    preparation in the layout's edge order and the flattening."""

    solve_has_residual = False
    edge_order = None
    bif_order = None

    def _setup(self, asm, opts, device, R_mode: str, f_mode: str) -> None:
        self._opts = _check_options(opts)
        self._device = resolve_device(device)
        self._asm = asm
        self._R_mode, self._f_mode = R_mode, f_mode
        mesh = asm.network
        self._N, self._E, self._k = mesh.N, mesh.num_edges, asm.flux_degree
        shape = {"scalar": (1,), "edge": (self._E,), "cell": (self._N, self._E)}[f_mode]
        # the factor's K1 input besides R: no source and no boundary pressure
        # (W and w depend on R alone)
        self._zero_f = torch.zeros(shape, dtype=torch.float64, device=self._device)
        self._zero_e = torch.zeros(self._E, dtype=torch.float64, device=self._device)

    def _upload(self, a) -> torch.Tensor:
        # a read-only array (an immutable R) is copied: a tensor needs writeable memory
        return torch.as_tensor(np.require(a, np.float64, "CW"), device=self._device)

    def _permute(self, arr, mode: str):
        return _permute_coefficient(arr, mode, self._N, self.edge_order)

    def _condense(self, plan, R, f, sp, ep):
        return condense.condense(plan, self._N, self._k, self._h_e, R, f, self._R_mode,
                                 self._f_mode, sp, ep)

    def _condense_R(self, plan, R_data):
        """The resident R rows and K1's ``(W, w)`` of them."""
        R = self._upload(self._permute(R_data, self._R_mode))
        W, w, *_ = self._condense(plan, R, self._zero_f, self._zero_e, self._zero_e)
        return R, W, w

    def prepare_rhs(self, f_data, start_pbc, end_pbc):
        """Device-resident rhs arguments in the layout's edge order, for
        :meth:`solve_prepared`: permute and upload once, solve many times."""
        eo = self.edge_order
        sp, ep = np.asarray(start_pbc), np.asarray(end_pbc)
        return (
            self._upload(self._permute(f_data, self._f_mode)),
            self._upload(sp if eo is None else sp[eo]),
            self._upload(ep if eo is None else ep[eo]),
        )

    def solve(self, state, f_data, start_pbc, end_pbc):
        """Solve against a stored factor for one rhs (f, boundary p), public
        order."""
        return self.solve_prepared(state, self.prepare_rhs(f_data, start_pbc, end_pbc))

    @staticmethod
    def _batch_rows(f_batch, start_pbc_batch, end_pbc_batch):
        f_rows = np.asarray(f_batch)
        sp_rows, ep_rows = np.asarray(start_pbc_batch), np.asarray(end_pbc_batch)
        if not 0 < f_rows.shape[0] == sp_rows.shape[0] == ep_rows.shape[0]:
            raise ValueError("solve_batch: f, start_pbc and end_pbc need one leading scenario axis "
                             "of at least one row")
        return f_rows, sp_rows, ep_rows

    def solve_batch(self, state, f_batch, start_pbc_batch, end_pbc_batch):
        """Many right-hand sides against one factor: the arguments carry a
        leading scenario axis over :meth:`solve`'s per-rhs layouts; returns
        :meth:`solve`'s tuple with each entry stacked along that axis (row
        ``i`` is :meth:`solve` of row ``i`` to the bit: the rows run one at
        a time into the preallocated outputs)."""
        f_rows, sp_rows, ep_rows = self._batch_rows(f_batch, start_pbc_batch, end_pbc_batch)
        outs = None
        for i in range(f_rows.shape[0]):
            row = self.solve_prepared(state, self.prepare_rhs(f_rows[i], sp_rows[i], ep_rows[i]))
            if outs is None:
                outs = tuple(torch.empty((f_rows.shape[0],) + tuple(t.shape), dtype=t.dtype,
                                         device=t.device) for t in row)
            for out, t in zip(outs, row):
                out[i].copy_(t)
        return outs

    def solution_vector(self, out) -> np.ndarray:
        """Global flat block vector from a :meth:`solve` result."""
        return _flatten_blocks_host(
            out[0].cpu().numpy(), out[1].cpu().numpy(), out[2].cpu().numpy(),
            self._asm.network.edge_color, edge_order=self.edge_order, bif_order=self.bif_order,
        )


class BlockedFactorization(_Factorization):
    """Factor reuse on the blocked forest route (see the module docs).

    Attributes:
        device_plan: the blocked plan on the device (K1, K2–K4, K5 read it).
    """

    def __init__(self, asm, opts: SolverOptions | None = None,
                 device: torch.device | str = "cuda"):
        plan = _plan_blocked(asm)
        if plan is None:
            raise ValueError(
                "BlockedFactorization requires a blocked-eligible topology "
                "(uniformly-K-ary forest; see _plan_blocked)"
            )
        R_mode, f_mode, _ = asm.coefficient_modes()
        if R_mode not in _DIRECT_MODES or f_mode not in _DIRECT_MODES:
            raise ValueError(
                "BlockedFactorization requires scalar/per-edge/per-cell "
                "coefficients (quad-mode callables stay on the fused path)"
            )
        self._setup(asm, opts, device, R_mode, f_mode)
        self._plan = plan
        self.edge_order, self.bif_order = plan.edge_order, plan.bif_order
        self.device_plan = device_plan(plan, self._device)
        mesh = asm.network
        self._h_e = self._upload(np.asarray(mesh.edge_length)[plan.edge_order] / mesh.N)

    def factor(self, R_data) -> BlockedState:
        """The resistance side: K1, then K2 (two launches)."""
        dp = self.device_plan
        R, W, w = self._condense_R(dp, R_data)
        d, wn, fac = tree_sweep.tree_sweep_factor(dp, w)
        return BlockedState(R, W, w, d, wn, fac)

    def solve_prepared(self, state: BlockedState, rhs_args):
        """K1 whole on the resident R, K3–K4 on the stored factor, K5:
        ``(q_T, p_T, λ, ‖rhs‖, finite)``, internal order."""
        dp, (f, sp, ep) = self.device_plan, rhs_args
        W, w, g, Ftot, const = self._condense(dp, state.R, f, sp, ep)
        lam, rhs_norm, _ = tree_sweep.tree_sweep_apply(dp, state.d, state.wn, state.factor,
                                                        const, Ftot)
        q_T, p_T, finite = expand.expand(dp, self._N, self._k, lam, sp, ep, W, w, g, Ftot,
                                         self._h_e, state.R, f, self._R_mode, self._f_mode)
        return q_T, p_T, lam, rhs_norm, finite

    def solve_batch(self, state: BlockedState, f_batch, start_pbc_batch, end_pbc_batch):
        """:meth:`solve` of S right-hand sides in one launch each of K1 (on
        the resident R, read once for all rows), K3–K4 (on the stored
        factor) and K5: the tuple with a leading ``S`` on each entry, row
        ``i`` :meth:`solve` of row ``i`` to the bit."""
        f_rows, sp_rows, ep_rows = self._batch_rows(f_batch, start_pbc_batch, end_pbc_batch)
        eo, dp, N, k = self.edge_order, self.device_plan, self._N, self._k
        f = self._upload(_permute_coefficient_batch(f_rows, self._f_mode, eo))
        sp, ep = self._upload(sp_rows[:, eo]), self._upload(ep_rows[:, eo])
        W, w, g, Ftot, const = condense.condense_scenarios(
            dp, N, k, self._h_e, state.R, f, self._R_mode, self._f_mode, sp, ep)
        lam, rhs_norm, _ = tree_sweep.tree_sweep_apply_scenarios(dp, state.d, state.wn,
                                                                  state.factor, const, Ftot)
        q_T, p_T, finite = expand.expand_scenarios(dp, N, k, lam, sp, ep, W, w, g, Ftot, self._h_e,
                                                   state.R, f, self._R_mode, self._f_mode)
        return q_T, p_T, lam, rhs_norm, finite


class GridFactorization(_Factorization):
    """Factor reuse on the lattice grid route (see the module docs).

    Attributes:
        device_plan: the grid plan on the device (K1, K17, K5 read it).
        operator: K16's operator.
    """

    solve_has_residual = True

    def __init__(self, asm, opts: SolverOptions | None = None,
                 device: torch.device | str = "cuda"):
        R_mode, f_mode, _ = asm.coefficient_modes()
        if R_mode != "scalar":
            raise ValueError(
                "GridFactorization requires scalar resistance (the separable-DCT envelope)"
            )
        if f_mode not in _DIRECT_MODES:
            raise ValueError("GridFactorization requires scalar/per-edge/per-cell f")
        shift_plan = _plan_shift_matvec(asm) if asm.network.num_multipliers else None
        dct = _plan_dct_lattice(asm, shift_plan) if shift_plan else None
        plan = _plan_grid_layout(asm, dct) if dct is not None else None
        if plan is None:
            raise ValueError(
                "GridFactorization requires a uniform rectangular-lattice "
                "multiplier graph (make_grid family)"
            )
        self._setup(asm, opts, device, R_mode, f_mode)
        self._plan = plan
        self.edge_order = plan.edge_order
        self.device_plan = device_grid_plan(plan, self._device)
        n_stub = plan.stub_rows_e.size
        self.operator = dct_lattice.dct_operator(
            plan.dct, self._device, stub_edge=plan.Ex + plan.Ey + np.arange(n_stub),
            stub_group=plan.stub_group, rep_x=0, rep_y=plan.Ex,
        )
        self._h_e = self._upload(plan.h_e)
        self._edge_order_dev = torch.as_tensor(plan.edge_order, dtype=torch.int64,
                                               device=self._device)

    def factor(self, R_data) -> GridState:
        """The conductance side: K1, then K16's factor (two launches)."""
        R, W, w = self._condense_R(self.device_plan, R_data)
        return GridState(R, W, w, dct_lattice.dct_factor(self.operator, w))

    def solve_prepared(self, state: GridState, rhs_args):
        """K1 whole on the resident R, K17's assembly, K16's passes on the
        stored factor with K17's stencil, the residual, K5: ``(q_T, p_T, λ,
        ‖L λ − rhs‖, ‖rhs‖, finite)``, internal edge order, λ in node order."""
        gdp, (f, sp, ep) = self.device_plan, rhs_args
        W, w, g, Ftot, const = self._condense(gdp, state.R, f, sp, ep)
        rhs, diag, rhs_norm = grid_core.grid_core(gdp, w, const, Ftot)
        lam = dct_lattice.dct_apply(
            self.operator, state.dct, rhs,
            lambda lam: grid_core.grid_residual(gdp, w, diag, lam, rhs))
        _, res_norm = grid_core.grid_residual(gdp, w, diag, lam, rhs, norm=True)
        q_T, p_T, finite = expand.expand(gdp, self._N, self._k, lam, sp, ep, W, w, g, Ftot,
                                         self._h_e, state.R, f, self._R_mode, self._f_mode)
        return q_T, p_T, lam, res_norm, rhs_norm, finite

    def solve_batch(self, state: GridState, f_batch, start_pbc_batch, end_pbc_batch):
        """:meth:`solve` of S right-hand sides in one launch each of K1 (on
        the resident R, read once for all rows), K17's assembly, K16's passes
        (on the stored factor, read at stride 0) with K17's stencil, the
        residual with its norms and K5: the tuple with a leading ``S`` on
        each entry, row ``i`` :meth:`solve` of row ``i`` to the bit."""
        f_rows, sp_rows, ep_rows = self._batch_rows(f_batch, start_pbc_batch, end_pbc_batch)
        eo, gdp, N, k = self.edge_order, self.device_plan, self._N, self._k
        if self._f_mode == "scalar":  # a scalar row is its first entry, as solve() reads it
            f_rows = f_rows.reshape(f_rows.shape[0], -1)[:, :1]
        f = self._upload(_permute_coefficient_batch(f_rows, self._f_mode, eo))
        # the boundary rows uploaded as given and put in the edge order on the
        # device: one gather there, where the host's column gather of (S, E)
        # rows costs more than the solve
        sp, ep = (self._upload(a).index_select(1, self._edge_order_dev) for a in (sp_rows, ep_rows))
        W, w, g, Ftot, const = condense.condense_scenarios(
            gdp, N, k, self._h_e, state.R, f, self._R_mode, self._f_mode, sp, ep)
        w0 = w[0]  # the resident R's conductances, every row's bits
        rhs, diag, rhs_norm = grid_core.grid_core_scenarios(gdp, w0, const, Ftot)
        lam = dct_lattice.dct_apply_scenarios(
            self.operator, state.dct, rhs,
            lambda lam: grid_core.grid_residual_scenarios(gdp, w0, diag, lam, rhs))
        _, res_norm = grid_core.grid_residual_scenarios(gdp, w0, diag, lam, rhs, norm=True)
        q_T, p_T, finite = expand.expand_scenarios(gdp, N, k, lam, sp, ep, W, w, g, Ftot, self._h_e,
                                                   state.R, f, self._R_mode, self._f_mode)
        return q_T, p_T, lam, res_norm, rhs_norm, finite


class TreeFactorization(_Factorization):
    """Factor reuse on any topology by the peel rounds and the core (see the
    module docs); ``_tree_plan`` replaces the cached plan (tests force a
    core engine with it, as the reference's).  Its :meth:`solve_batch` runs
    the rows in one launch of each scenario wrapper for a multifrontal or
    dense core and for a plan without a core, and one row at a time for a
    min-degree core (K12a and K12b have no scenario axis yet: ROADMAP A9b).

    Attributes:
        device_tree_plan: the tree plan on the device (K9, K6 and the core
            engines read it).
        ends: the public-order edge ends (K1 and K5 read them).
    """

    def __init__(self, asm, opts: SolverOptions | None = None,
                 device: torch.device | str = "cuda", _tree_plan=None):
        R_mode, f_mode, _ = asm.coefficient_modes()
        if R_mode not in _DIRECT_MODES or f_mode not in _DIRECT_MODES:
            raise ValueError(
                "TreeFactorization requires scalar/per-edge/per-cell "
                "coefficients (quad-mode callables stay on the fused path)"
            )
        B = asm.network.num_multipliers
        if B == 0:
            raise ValueError("TreeFactorization requires multipliers (B > 0)")
        # force_rounds: a forest's plan otherwise has no rounds (the level
        # route supersedes them), and this class runs the rounds
        plan = _tree_plan if _tree_plan is not None else _cached_tree_plan(asm, force_rounds=True)
        if plan.core_size == 0 and len(plan.rounds) == 0:
            raise ValueError(
                "TreeFactorization got an empty elimination plan for a "
                "graph with multipliers — this is a bug, please report"
            )
        if plan.core_size > 512:
            plan = (_cached_tree_plan(asm, force_rounds=True, attach=True) if _tree_plan is None
                    else attach_core_plan(plan))
        if plan.core_size > 4096 and plan.core_plan is None:
            raise ValueError(
                "cycle core too large for the tree factorization (the "
                "sparse-elimination fill budget was exceeded; the fused "
                "dense/CG path keeps serving it)"
            )
        if plan.core_plan is not None and not isinstance(plan.core_plan, (MFPlan, CoreElimPlan)):
            raise ValueError(f"TreeFactorization: unknown core plan {type(plan.core_plan).__name__}")
        self._setup(asm, opts, device, R_mode, f_mode)
        self._plan = plan
        self.device_tree_plan = device_tree_plan(plan, _build_lambda_plan(asm), asm, self._device)
        self.ends = ends_plan(asm._edge_start_bif, asm._edge_end_bif, B, self._device)
        mesh = asm.network
        self._h_e = self._upload(np.asarray(mesh.edge_length) / mesh.N)

    def factor(self, R_data) -> TreeState:
        """The resistance side: K1, the bifurcation diagonal, the pair
        conductances, K9's ``d`` channel and the core's factor (K13–K14,
        K12a's with K11's or K12b's, or K11's)."""
        dtp = self.device_tree_plan
        R, W, w = self._condense_R(self.ends, R_data)
        dr, w_edges, _ = peel.bifurcation_system(dtp, W)  # the diagonal alone
        if dtp.num_pairs:
            w_pairs = segsum.segsum_plan(dtp.pair_sums, w_edges)[0]
        else:
            w_pairs = torch.zeros(0, dtype=torch.float64, device=self._device)
        pf = peel.peel_factor(dtp, dr, w_pairs)
        core = None
        if dtp.core_size:
            if dtp.mf is not None:
                core = mf_factor.mf_factor(dtp.mf, pf.dc, w_pairs)
            elif dtp.ce is not None:
                core = core_elim.core_factor(dtp.ce, pf.dc, w_pairs)
            else:
                Lc, s, C = dense_core.dense_factor(dtp.core_ci, dtp.core_cj, dtp.core_pid, pf.dc,
                                                   w_pairs)
                core = (Lc, s, C, dense_core.dense_gate(C))
        return TreeState(R, W, w, w_pairs, pf, core)

    def _core_apply(self, state: TreeState):
        dtp = self.device_tree_plan
        if dtp.mf is not None:
            return lambda rc: mf_apply.mf_apply(dtp.mf, state.core, rc)
        if dtp.ce is not None:
            return lambda rc: core_elim.core_apply(dtp.ce, state.core, rc)
        return lambda rc: dense_core.dense_solve(*state.core, rc)

    def solve_prepared(self, state: TreeState, rhs_args):
        """K1 whole on the resident R, the bifurcation rhs, K9's ``r`` channel
        around the core's apply, K5 in public order: ``(q_T, p_T, λ, ‖rhs‖,
        finite)``."""
        dtp, ends, (f, sp, ep) = self.device_tree_plan, self.ends, rhs_args
        W, w, g, Ftot, _ = self._condense(ends, state.R, f, sp, ep)
        dr, _, rhs_norm = peel.bifurcation_system(dtp, W, g, Ftot, sp, ep)
        lam = peel.peel_apply(dtp, state.peeled, dr, self._core_apply(state))
        q_T, p_T, finite = expand.expand(ends, self._N, self._k, lam, sp, ep, W, w, g, Ftot,
                                         self._h_e, state.R, f, self._R_mode, self._f_mode)
        return q_T, p_T, lam, rhs_norm, finite

    def solve_batch(self, state: TreeState, f_batch, start_pbc_batch, end_pbc_batch):
        """:meth:`solve` of S right-hand sides: for a multifrontal or dense
        core (or none) in one launch of K1 (on the resident R), the
        bifurcation rhs and its norm (the prepare kernel, K6, the norm over
        S), K9's ``r`` channel (``peel_apply_scenarios``, the stored
        :class:`.kernels.peel.PeelFactor` read at stride 0) around the core's
        apply over S (K15's, or K11's solves, on the stored core factor) and
        K5; for a min-degree core one row at a time (the inherited loop: K12a
        and K12b have no scenario axis yet).  Returns the tuple with a
        leading ``S`` on each entry, row ``i`` :meth:`solve` of row ``i`` to
        the bit."""
        dtp, ends, N, k = self.device_tree_plan, self.ends, self._N, self._k
        if dtp.ce is not None:
            return super().solve_batch(state, f_batch, start_pbc_batch, end_pbc_batch)
        f_rows, sp_rows, ep_rows = self._batch_rows(f_batch, start_pbc_batch, end_pbc_batch)
        S = f_rows.shape[0]
        if self._f_mode == "scalar":  # a scalar row is its first entry, as solve() reads it
            f_rows = f_rows.reshape(S, -1)[:, :1]
        f = self._upload(f_rows)
        if self._f_mode == "cell":  # public (S, C) rows to j-major (S, N, E) blocks, on the device
            f = f.view(S, self._E, self._N).transpose(1, 2).contiguous()
        sp, ep = self._upload(sp_rows), self._upload(ep_rows)
        W, w, g, Ftot, _ = condense.condense_scenarios(ends, N, k, self._h_e, state.R, f,
                                                       self._R_mode, self._f_mode, sp, ep)
        dr, _, rhs_norm = peel.bifurcation_system_scenarios(dtp, W, g, Ftot, sp, ep, norm=True)
        apply = core_apply_scenarios(dtp, state.core) if dtp.core_size else None
        lam = peel.peel_apply_scenarios(dtp, state.peeled, dr, apply)
        q_T, p_T, finite = expand.expand_scenarios(ends, N, k, lam, sp, ep, W, w, g, Ftot,
                                                   self._h_e, state.R, f, self._R_mode,
                                                   self._f_mode)
        return q_T, p_T, lam, rhs_norm, finite


def build_blocked_factorization(asm, opts: SolverOptions | None = None,
                                device: torch.device | str = "cuda") -> BlockedFactorization:
    """Factor/solve pair for fixed-resistance serving (see
    :class:`BlockedFactorization`)."""
    return BlockedFactorization(asm, opts, device)


def build_grid_factorization(asm, opts: SolverOptions | None = None,
                             device: torch.device | str = "cuda") -> GridFactorization:
    """Factor/solve pair for fixed-conductance lattice serving (see
    :class:`GridFactorization`)."""
    return GridFactorization(asm, opts, device)


def build_tree_factorization(asm, opts: SolverOptions | None = None,
                             device: torch.device | str = "cuda",
                             _tree_plan=None) -> TreeFactorization:
    """Factor/solve pair for fixed-resistance serving on any topology (see
    :class:`TreeFactorization`)."""
    return TreeFactorization(asm, opts, device, _tree_plan=_tree_plan)
