"""Solver for the hydraulic network saddle-point system.

Counterpart of ``networks_fenicsx_tpu/solver.py``: :class:`Solver`
(``__init__``, ``assemble``, ``solve``, ``_scatter_functions``,
``solution_vector``), :func:`build_schur_executor` with the forest,
peel-then-core and lattice routes, ``_BlockedExecutor`` and its
``prepare_args``, the general executors (the reference's generic ``core`` +
``_finish`` on a level plan, on a tree plan with a cycle core, or on the
DCT lattice plan), ``_schur_solve`` with the same convergence gate, and
``_flatten_blocks_host``.

With discontinuous (degree-0) pressure the system decouples into per-edge
chains tied together only by the bifurcation multipliers λ; eliminating
flux and pressure edge by edge reduces it to an SPD weighted graph
Laplacian on the bifurcations, which a forest eliminates exactly level by
level; flux and pressure then follow from λ edge by edge.  The routes:

* blocked — uniformly-K-ary forests with cellwise coefficients: K1
  (:mod:`.kernels.condense`), K2–K4 (:mod:`.kernels.tree_sweep`), K5
  (:mod:`.kernels.expand`);
* level — every other forest, and callable (quad-mode) R or f: K8a
  (:mod:`.kernels.edge_data`), K7 with its K6 sums
  (:mod:`.kernels.level_eliminate`, :mod:`.kernels.segsum`), K8b
  (:mod:`.kernels.backsub`);
* tree — a bifurcation graph with cycles: K8a, the bifurcation system and
  the peel rounds with their folds (K9, K10 on K6), the cycle core by the
  tree multifrontal engine (K13–K15), by the min-degree rounds (K12a) with
  a dense tail (K11) or supernodal fronts (K12b), or densely (K11, up to
  8,192 nodes), the reversed rounds, K8b (:mod:`.tree`);
* lattice — a uniform rectangular lattice with scalar R
  (``schur_method="dct"``, or ``auto`` above a 4,096-node core): the exact
  separable-DCT λ solve (K16, :mod:`.kernels.dct_lattice`), on the grid
  route (K1, K17 :mod:`.kernels.grid_core`, K16, K5) when the lattice
  layout applies and f is not quad-mode, otherwise on the general route in
  public order (K8a, K9's bifurcation system, K6 class weights, K16 with
  K18 :mod:`.kernels.shift_matvec`, K8b).

The device is explicit: ``Solver(asm, device="cuda")`` (the default) runs the
CUDA kernels and raises when CUDA is absent; ``device="cpu"`` runs their
plain PyTorch versions.  Everything outside these routes — the CG route
(``schur_method="cg"``, or a core above 4,096 nodes that no sparse planner
takes: A7b), other methods (A8) — raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from . import assembly as _assembly
from .blocked import _permute_coefficient, _plan_blocked, device_plan
from .edge_data import edge_layout
from .function import NetworkFunction
from .kernels import (
    backsub, condense, dct_lattice, edge_data, expand, grid_core, level_eliminate, peel, segsum,
    shift_matvec, tree_sweep,
)
from .lattice import (
    _DctPlan,
    _plan_grid_layout,
    _shift_class_weights,
    device_grid_plan,
    device_lattice_plan,
    lattice_dct_plan,
)
from .levels import (
    _build_lambda_plan,
    _cached_tree_plan,
    _plan_level_elimination,
    attach_core_plan,
    device_level_plan,
)
from .tree import device_tree_plan, tree_schur_solve
from .utils.config import SolverOptions
from .utils.timing import timed

__all__ = ["Solver", "SolveInfo", "build_schur_executor", "resolve_device"]

# ROADMAP items of the schur_method variants the port does not run yet
_SCHUR_METHOD_ITEM = {
    "dense": "A8",
    "dense_f64": "A8",
    "cg": "A7b",
    "tree_dist": "A10",
}


class SolveInfo(typing.NamedTuple):
    method: str
    iterations: int
    residual: float
    converged: bool


def resolve_device(device: torch.device | str) -> torch.device:
    """The solve's device: ``cuda`` requires CUDA, ``cpu`` runs the plain
    versions of the kernels; nothing falls back from one to the other."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (expected 'cuda' or 'cpu')")
    return dev


class Solver:
    """Solver for the network problem (reference API).

    Args:
        assembler: The hydraulic network assembler.
        petsc_options_prefix: Accepted for reference API parity; unused.
        petsc_options: Reference-style options dict; ``ksp_monitor`` and
            ``ksp_error_if_not_converged`` map onto :class:`SolverOptions`.
        kind: Explicit matrix layout — not ported (ROADMAP A8); must be None.
        options: :class:`SolverOptions` or dict.
        device: ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
    """

    def __init__(
        self,
        assembler: _assembly.HydraulicNetworkAssembler,
        petsc_options_prefix: str = "NetworkSolver_",
        petsc_options: dict | None = None,
        kind: str | None = None,
        options: SolverOptions | dict | None = None,
        device: torch.device | str = "cuda",
    ):
        del petsc_options_prefix
        self._assembler = assembler
        if isinstance(options, dict):
            options = SolverOptions.from_dict(options)
        self._options = options or SolverOptions()
        if petsc_options:
            if "ksp_monitor" in petsc_options:
                self._options.monitor = True
            if "ksp_error_if_not_converged" in petsc_options:
                self._options.error_if_not_converged = bool(
                    petsc_options["ksp_error_if_not_converged"]
                )
        self._kind = kind
        self._device = resolve_device(device)
        self._x: np.ndarray | None = None
        self._info: SolveInfo | None = None
        self._executor = None
        self._executor_key = None

    # ------------------------------------------------------------ properties
    @property
    def assembler(self) -> _assembly.HydraulicNetworkAssembler:
        return self._assembler

    @property
    def info(self) -> SolveInfo | None:
        """Diagnostics of the last solve."""
        return self._info

    def factorize(self) -> None:
        """Factor reuse across rhs-only solves — not ported."""
        raise NotImplementedError("ROADMAP A3: factorize() is not ported yet")

    def _method(self) -> str:
        m = self._options.method
        if m == "auto":
            m = "schur" if self._assembler.pressure_degree == 0 else "schur_p"
        if m != "schur":
            raise NotImplementedError(
                f"ROADMAP A8: method {m!r} is not ported yet (the port runs 'schur')"
            )
        return m

    # -------------------------------------------------------------- assemble
    def assemble(self, lhs: bool = True, rhs: bool = True) -> None:
        """Prepare the solve: the Schur path materialises nothing, so this
        only checks that the forms exist."""
        del lhs, rhs
        self._method()
        if self._kind is not None:
            raise NotImplementedError("ROADMAP A8: explicit matrix kinds are not ported yet")
        self._assembler._require_forms()

    # ----------------------------------------------------------------- solve
    @timed("nxfx:Solver:solve", block=True)
    def solve(self, functions: list[NetworkFunction] | None = None) -> list[NetworkFunction]:
        """Solve and scatter into solution functions.

        Returns the reference's function list contract
        ``[flux_color_0, ..., flux_color_{M-1}, pressure, global_flux]``
        where ``global_flux`` holds the multiplier values.
        """
        self._method()
        if self._kind is not None:
            raise NotImplementedError("ROADMAP A8: explicit matrix kinds are not ported yet")
        if self._assembler.network.has_floating_component():
            raise RuntimeError(
                "Solver did not converge: network has a component with no "
                "boundary node — the system is singular (pressure level "
                "undetermined)"
            )
        key = self._assembler.coefficient_modes()
        if self._executor is None or self._executor_key != key:
            self._executor = build_schur_executor(
                self._assembler, self._options, device=self._device
            )
            self._executor_key = key
        x, info = _schur_solve(self._assembler, self._options, self._executor)
        self._x = x
        self._info = info
        if self._options.monitor:
            print(
                f"[nxfx] method={info.method} iters={info.iterations} "
                f"residual={info.residual:.3e} converged={info.converged}"
            )
        if self._options.error_if_not_converged and not info.converged:
            raise RuntimeError(
                f"Solver did not converge: method={info.method}, "
                f"residual={info.residual:.3e}"
            )
        return self._scatter_functions(functions, x)

    def _scatter_functions(
        self, functions: list[NetworkFunction] | None, x_np: np.ndarray
    ) -> list[NetworkFunction]:
        asm = self._assembler
        if functions is None:
            functions = [
                NetworkFunction(sp, name=f"flux_color_{i}")
                for i, sp in enumerate(asm.flux_spaces)
            ]
            functions.append(NetworkFunction(asm.pressure_space, name="pressure"))
            functions.append(NetworkFunction(asm.lm_space, name="global_flux"))
        offs = asm.block_offsets
        for i, fn in enumerate(functions):
            fn.values[...] = x_np[offs[i] : offs[i + 1]]
        return functions

    def solution_vector(self) -> np.ndarray | None:
        """The raw solution in global block layout (host)."""
        return self._x


# ======================================================================
# Executors (blocked, level, tree and lattice routes)
# ======================================================================


class _Executor:
    """What the executors share: the upload of the host arguments and the
    kernel / plain entry points around the subclass's ``_run``.  By default
    edges and bifurcations stay in public order (``edge_order`` and
    ``bif_order`` None) and ``prepare_args`` passes the assembler's compact
    arguments through."""

    blocks_out = True
    edge_order = None
    bif_order = None

    def prepare_args(self, R_data, f_data, start_pbc, end_pbc):
        return R_data, f_data, start_pbc, end_pbc

    def upload(self, *arrays) -> list[torch.Tensor]:
        """Host arrays -> contiguous float64 tensors on the executor's device."""
        return [
            torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=self._device)
            for a in arrays
        ]

    def __call__(self, R_data, f_data, start_pbc, end_pbc):
        return self._run(R_data, f_data, start_pbc, end_pbc, plain=False)

    def plain(self, R_data, f_data, start_pbc, end_pbc):
        """The same solve through the kernels' plain PyTorch versions, on the
        executor's device — what the kernels are checked against."""
        return self._run(R_data, f_data, start_pbc, end_pbc, plain=True)


class _BlockedExecutor(_Executor):
    """The blocked forest solve on one device.

    Holds the host plan, its index tensors and the internal-order cell
    widths (uploaded once).  ``prepare_args`` permutes the public-order
    coefficient arrays into the internal layout on the host;
    ``__call__`` uploads them and runs K1 → K2–K4 → K5 (``plain`` runs
    their plain versions instead), returning the
    reference's 7-tuple blocks contract
    ``(q_T, p_T, lam, iters, residual, rhs_norm, finite)`` in internal order
    (``edge_order``/``bif_order`` map it back to the public layout)."""

    def __init__(
        self, asm, plan, R_mode: str, f_mode: str, device: torch.device,
        make_device_plan=device_plan,
    ):
        mesh = asm.network
        self.blocked_plan = plan
        self.edge_order = plan.edge_order
        self.bif_order = plan.bif_order
        self._R_mode = R_mode
        self._f_mode = f_mode
        self._N = mesh.N
        self._k = asm.flux_degree
        self._device = device
        self.device_plan = make_device_plan(plan, device)
        (self._h_e,) = self.upload(
            np.asarray(mesh.edge_length, dtype=np.float64)[plan.edge_order] / mesh.N
        )

    def _permute(self, arr, mode):
        return _permute_coefficient(arr, mode, self._N, self.edge_order)

    def prepare_args(self, R_data, f_data, start_pbc, end_pbc):
        eo = self.edge_order
        return (
            self._permute(R_data, self._R_mode),
            self._permute(f_data, self._f_mode),
            np.asarray(start_pbc)[eo],
            np.asarray(end_pbc)[eo],
        )

    def _run(self, R_data, f_data, start_pbc, end_pbc, plain: bool):
        R, f, sp, ep = self.upload(R_data, f_data, start_pbc, end_pbc)
        dp, N, k = self.device_plan, self._N, self._k
        if plain:
            plan = dp.plan
            run_condense, run_sweep, run_expand = (
                condense.condense_plain, tree_sweep.tree_sweep_plain, expand.expand_plain
            )
        else:
            plan = dp
            run_condense, run_sweep, run_expand = (
                condense.condense, tree_sweep.tree_sweep, expand.expand
            )
        W, w, g, Ftot, const = run_condense(
            plan, N, k, self._h_e, R, f, self._R_mode, self._f_mode, sp, ep
        )
        lam, rhs_norm, _, _, _ = run_sweep(plan, w, const, Ftot)
        q_T, p_T, finite = run_expand(
            plan, N, k, lam, sp, ep, W, w, g, Ftot, self._h_e, R, f, self._R_mode, self._f_mode
        )
        iters = torch.zeros((), dtype=torch.int32, device=self._device)
        residual = torch.zeros((), dtype=torch.float64, device=self._device)
        return q_T, p_T, lam, iters, residual, rhs_norm, finite


class _LevelExecutor(_Executor):
    """The general forest solve on one device (the reference's generic
    ``core`` and ``_finish`` on a level plan).

    Holds the host tree and level plans, the level plan's index tensors
    and the per-edge cell widths (uploaded once).  Edges and bifurcations
    stay in public order: ``prepare_args`` passes the assembler's compact
    arguments through, ``__call__`` uploads them and runs K8a → K6 + K7 →
    K8b (``plain`` runs their plain versions instead), returning the
    reference's 7-tuple blocks contract
    ``(q_T, p_T, lam, iters, residual, rhs_norm, finite)``; ``edge_order``
    and ``bif_order`` are None."""

    def __init__(self, asm, tree_plan, level_plan, R_mode, f_mode, f_is_zero, device):
        mesh = asm.network
        self.tree_plan = tree_plan
        self.level_plan = level_plan
        self._N = mesh.N
        self._k = asm.flux_degree
        self._R_mode = R_mode
        self._f_mode = f_mode
        self._f_is_zero = bool(f_is_zero)
        self.layout = edge_layout(self._k, R_mode, f_mode)
        self._device = device
        self.device_plan = device_level_plan(level_plan, tree_plan, device)
        self._h_e = torch.as_tensor(
            np.asarray(mesh.edge_length, dtype=np.float64) / mesh.N, device=device
        )
        self._quad_w, self._quad_phi = self.upload(asm._quad_weights, asm._quad_phi)

    def _run(self, R_data, f_data, start_pbc, end_pbc, plain: bool):
        R, f, sp, ep = self.upload(R_data, f_data, start_pbc, end_pbc)
        if plain:
            make, eliminate, expand_lam = (
                edge_data.edge_data_plain,
                level_eliminate.level_eliminate_plain,
                backsub.backsub_plain,
            )
        else:
            make, eliminate, expand_lam = (
                edge_data.edge_data, level_eliminate.level_eliminate, backsub.backsub
            )
        dlp, N, k = self.device_plan, self._N, self._k
        ed = make(
            dlp, N, k, self._h_e, self._quad_w, self._quad_phi, R, f,
            self._R_mode, self._f_mode, self._f_is_zero, sp, ep,
        )
        lam, rhs_norm = eliminate(dlp, ed)
        q_T, p_T, finite = expand_lam(ed, lam, N, k)
        iters = torch.zeros((), dtype=torch.int32, device=self._device)
        residual = torch.zeros((), dtype=torch.float64, device=self._device)
        return q_T, p_T, lam, iters, residual, rhs_norm, finite


class _TreeExecutor(_Executor):
    """The peel-then-core solve of a cyclic bifurcation graph on one device
    (the reference's generic ``core`` and the cyclic branch of ``_finish``,
    ``:4112-4118`` and ``:4249-4264``).

    Holds the host tree plan (with its attached core plan) and λ-system
    plan, their index tensors and the multifrontal payload (uploaded once,
    kept for the executor's lifetime), and the per-edge cell widths.
    ``__call__`` runs K8a in the layout dispatch, the bifurcation system,
    the peel rounds and the core (K9, K10, K11 or K13–K15), and K8b with
    the finiteness flag over ``q_T``, ``p_T`` and ``λ``; ``plain`` runs
    their plain versions.  Returns the 7-tuple blocks contract in public
    order (``edge_order``/``bif_order`` None)."""

    def __init__(self, asm, tree_plan, R_mode, f_mode, f_is_zero, device):
        mesh = asm.network
        self.tree_plan = tree_plan
        self.lambda_plan = _build_lambda_plan(asm)
        self._N = mesh.N
        self._k = asm.flux_degree
        self._R_mode = R_mode
        self._f_mode = f_mode
        self._f_is_zero = bool(f_is_zero)
        self.layout = edge_layout(self._k, R_mode, f_mode)
        self._device = device
        self.device_plan = device_tree_plan(tree_plan, self.lambda_plan, asm, device)
        self._h_e = torch.as_tensor(
            np.asarray(mesh.edge_length, dtype=np.float64) / mesh.N, device=device
        )
        self._quad_w, self._quad_phi = self.upload(asm._quad_weights, asm._quad_phi)

    def _run(self, R_data, f_data, start_pbc, end_pbc, plain: bool):
        R, f, sp, ep = self.upload(R_data, f_data, start_pbc, end_pbc)
        make, expand_lam = (
            (edge_data.edge_data_plain, backsub.backsub_plain) if plain
            else (edge_data.edge_data, backsub.backsub)
        )
        dtp, N, k = self.device_plan, self._N, self._k
        ed = make(
            dtp, N, k, self._h_e, self._quad_w, self._quad_phi, R, f,
            self._R_mode, self._f_mode, self._f_is_zero, sp, ep,
        )
        lam, rhs_norm = tree_schur_solve(dtp, ed, plain)
        q_T, p_T, finite = expand_lam(ed, lam, N, k)
        iters = torch.zeros((), dtype=torch.int32, device=self._device)
        residual = torch.zeros((), dtype=torch.float64, device=self._device)
        return q_T, p_T, lam, iters, residual, rhs_norm, finite


class _GridExecutor(_BlockedExecutor):
    """The lattice grid route on one device (the reference's
    ``_grid_blocked_core`` behind ``_BlockedExecutor``, ``:4030-4054``).

    Holds the grid plan (``blocked_plan``, a :class:`.lattice._GridPlan`),
    its endpoint and stub tables, the internal-order cell widths and K16's
    operator (DCT matrices, eigenvalues, stub columns), all uploaded once.
    ``prepare_args`` permutes the coefficients into the internal edge order
    (x-edges, y-edges, stubs); ``__call__`` runs K1 → K17 assembly → K16
    (one direct and two refinement passes on K17's stencil) → K17 residual
    → K5, returning the 7-tuple blocks contract in internal edge order
    (``bif_order`` None: λ stays in node order) with the residual norm and
    ``iters = 0``."""

    def __init__(self, asm, plan, R_mode: str, f_mode: str, device: torch.device):
        super().__init__(asm, plan, R_mode, f_mode, device, make_device_plan=device_grid_plan)
        n_stub = plan.stub_rows_e.size
        tail = plan.Ex + plan.Ey
        self.operator = dct_lattice.dct_operator(
            plan.dct, device, stub_edge=tail + np.arange(n_stub), stub_group=plan.stub_group,
            rep_x=0, rep_y=plan.Ex,
        )
        # conditioning hint of the λ-residual convergence gate (reference :4049-4053)
        self.kappa_hint = float(max(plan.dct.s, plan.dct.ny)) ** 2

    def _run(self, R_data, f_data, start_pbc, end_pbc, plain: bool):
        R, f, sp, ep = self.upload(R_data, f_data, start_pbc, end_pbc)
        gdp, N, k = self.device_plan, self._N, self._k
        if plain:
            plan = gdp.plan
            run_condense, assemble, residual, solve, run_expand = (
                condense.condense_plain, grid_core.grid_core_plain,
                grid_core.grid_residual_plain, dct_lattice.dct_lattice_plain,
                expand.expand_plain,
            )
        else:
            plan = gdp
            run_condense, assemble, residual, solve, run_expand = (
                condense.condense, grid_core.grid_core, grid_core.grid_residual,
                dct_lattice.dct_lattice, expand.expand,
            )
        W, w, g, Ftot, const = run_condense(
            plan, N, k, self._h_e, R, f, self._R_mode, self._f_mode, sp, ep
        )
        rhs, diag, rhs_norm = assemble(gdp, w, const, Ftot)
        lam = solve(self.operator, w, rhs, lambda lam: residual(gdp, w, diag, lam, rhs))
        _, res_norm = residual(gdp, w, diag, lam, rhs, norm=True)
        q_T, p_T, finite = run_expand(
            plan, N, k, lam, sp, ep, W, w, g, Ftot, self._h_e, R, f, self._R_mode, self._f_mode
        )
        iters = torch.zeros((), dtype=torch.int32, device=self._device)
        return q_T, p_T, lam, iters, res_norm, rhs_norm, finite


class _DctExecutor(_Executor):
    """The general DCT lattice route on one device (the reference's generic
    ``core`` and the DCT branch of ``_finish``, ``:4121-4142``, ``:4242-4264``).

    Holds the device tables (:func:`.lattice.device_lattice_plan`) and K16's
    operator, uploaded once.  Edges and bifurcations stay in public order.
    ``__call__`` runs K8a, the bifurcation system (K9's ``lambda_system``),
    the class weights (K6), K16 with K18 as its refinement matvec, K18's
    final residual and K8b, and returns the 7-tuple blocks contract with
    the residual norm and ``iters = 0``; ``plain`` runs their plain
    versions."""

    def __init__(self, asm, dct: _DctPlan, R_mode, f_mode, f_is_zero, device):
        mesh = asm.network
        self._N = mesh.N
        self._k = asm.flux_degree
        self._R_mode = R_mode
        self._f_mode = f_mode
        self._f_is_zero = bool(f_is_zero)
        self._device = device
        self.device_plan = device_lattice_plan(asm, _build_lambda_plan(asm), device)
        self.operator = dct_lattice.dct_operator(dct, device)
        self._h_e = torch.as_tensor(
            np.asarray(mesh.edge_length, dtype=np.float64) / mesh.N, device=device
        )
        self._quad_w, self._quad_phi = self.upload(asm._quad_weights, asm._quad_phi)
        # conditioning hint of the λ-residual convergence gate (reference :4350-4352)
        self.kappa_hint = float(max(dct.s, dct.ny)) ** 2

    def _run(self, R_data, f_data, start_pbc, end_pbc, plain: bool):
        R, f, sp, ep = self.upload(R_data, f_data, start_pbc, end_pbc)
        if plain:
            make, lam_sys, sums, matvec, solve, expand_lam = (
                edge_data.edge_data_plain, peel.lambda_system_plain, segsum.segsum_plain,
                shift_matvec.shift_matvec_plain, dct_lattice.dct_lattice_plain,
                backsub.backsub_plain,
            )
        else:
            make, lam_sys, sums, matvec, solve, expand_lam = (
                edge_data.edge_data, peel.lambda_system, segsum.segsum,
                shift_matvec.shift_matvec, dct_lattice.dct_lattice, backsub.backsub,
            )
        dlp, N, k = self.device_plan, self._N, self._k
        ed = make(
            dlp, N, k, self._h_e, self._quad_w, self._quad_phi, R, f,
            self._R_mode, self._f_mode, self._f_is_zero, sp, ep,
        )
        dr, w_edges, rhs_norm = lam_sys(dlp, ed)
        cw = _shift_class_weights(w_edges, dlp.class_idx, dlp.offsets.size, sums)
        rhs = dr[:, 1].contiguous()
        lam = solve(self.operator, w_edges, rhs, lambda lam: matvec(dlp.offsets, cw, dr, lam))
        _, res_norm = matvec(dlp.offsets, cw, dr, lam, norm=True)
        q_T, p_T, finite = expand_lam(ed, lam, N, k)
        iters = torch.zeros((), dtype=torch.int32, device=self._device)
        return q_T, p_T, lam, iters, res_norm, rhs_norm, finite


def _dct_executor(asm, dct: _DctPlan, R_mode, f_mode, f_zero, device):
    """The grid route when the lattice layout applies and f is not
    quad-mode, the general DCT route otherwise (reference ``:4030-4054``)."""
    if f_mode in ("scalar", "edge", "cell"):
        grid = _plan_grid_layout(asm, dct)
        if grid is not None:
            return _GridExecutor(asm, grid, R_mode, f_mode, device)
    return _DctExecutor(asm, dct, R_mode, f_mode, f_zero, device)


def _resolve_core(asm, opts: SolverOptions, tree_plan, override: bool, R_mode: str):
    """The tree plan the cyclic route runs, with its core plan, or raise.

    The reference's routing (``:3928-3966``): a core of at most 512 nodes
    is dense (or runs the core plan a caller attached).  Under ``auto`` a
    larger core gets a sparse core plan attached unless the graph is a
    scalar-R lattice; it runs with a core plan or, without one, densely up
    to 4,096 nodes; above, the reference falls to CG (ROADMAP A7b; the
    lattices among these the caller has sent to the DCT solve already).  An
    explicit ``"tree"`` attaches a plan the same way and raises the
    reference's ``ValueError`` without one above 4,096 nodes."""
    if tree_plan.core_size <= 512:
        return tree_plan
    if opts.schur_method == "auto":
        is_lattice = R_mode == "scalar" and lattice_dct_plan(asm, R_mode) is not None
        if not is_lattice:
            tree_plan = (attach_core_plan(tree_plan) if override
                         else _cached_tree_plan(asm, attach=True))
        if tree_plan.core_plan is not None or tree_plan.core_size <= 4096:
            return tree_plan
        raise NotImplementedError(
            f"ROADMAP A7b: a cycle core of {tree_plan.core_size} nodes without a sparse core "
            "plan takes the reference's CG route, which is not ported yet"
        )
    tree_plan = attach_core_plan(tree_plan) if override else _cached_tree_plan(asm, attach=True)
    if tree_plan.core_plan is None and tree_plan.core_size > 4096:
        raise ValueError(
            f"schur_method='tree' on a graph whose cycle core has {tree_plan.core_size} "
            "nodes: the sparse core elimination could not be planned and a dense core "
            "factor would need O(core²) memory"
        )
    return tree_plan


def build_schur_executor(
    asm: _assembly.HydraulicNetworkAssembler,
    opts: SolverOptions,
    device: torch.device | str = "cuda",
    _tree_plan=None,
) -> _BlockedExecutor | _LevelExecutor | _TreeExecutor | _DctExecutor:
    """Build the executor, or raise ``NotImplementedError`` (naming the
    ROADMAP item) outside the ported routes.

    Routes as the reference's
    ``build_schur_executor(outputs="blocks", internal_layout=True)``:
    ``schur_method="dct"`` takes the DCT lattice solve or raises the
    reference's ``ValueError`` without a DCT plan; otherwise the tree plan;
    on a forest the level plan, then the blocked executor when
    ``_plan_blocked`` succeeds and neither coefficient is quad-mode, the
    level executor otherwise; with a cycle core, under ``auto`` a scalar-R
    lattice whose core exceeds 4,096 nodes takes the DCT solve, anything
    else the tree executor (see :func:`_resolve_core`).  The DCT solve runs
    on the grid executor or the general DCT executor (:func:`_dct_executor`).
    ``_tree_plan`` overrides the cached tree plan (tests use it to force
    the multifrontal engine on a small core).  ``level_scan="on"`` runs the
    same kernels (the two reference variants are pinned equal)."""
    if opts.dtype != "float64" or opts.output_dtype not in ("same", "float64"):
        raise NotImplementedError("ROADMAP A4: float32 solves and outputs are not ported yet")
    if opts.schur_method not in ("auto", "tree", "dct"):
        item = _SCHUR_METHOD_ITEM[opts.schur_method]
        raise NotImplementedError(
            f"ROADMAP {item}: schur_method={opts.schur_method!r} is not ported yet"
        )
    if asm.pressure_degree != 0:
        raise ValueError("schur method requires discontinuous (degree-0) pressure")
    device = resolve_device(device)
    if asm.network.num_multipliers == 0:
        raise NotImplementedError(
            "ROADMAP A8: a network without bifurcations takes the reference's dense "
            "route, which is not ported yet"
        )
    R_mode, f_mode, f_zero = asm.coefficient_modes()
    if opts.schur_method == "dct":
        dct = lattice_dct_plan(asm, R_mode)
        if dct is None:
            raise ValueError(
                "schur_method='dct' requires a uniform rectangular-lattice "
                "multiplier graph (make_grid family) with scalar resistance"
            )
        return _dct_executor(asm, dct, R_mode, f_mode, f_zero, device)
    tree_plan = _tree_plan if _tree_plan is not None else _cached_tree_plan(asm)
    if tree_plan.core_size > 0:
        if opts.schur_method == "auto" and tree_plan.core_size > 4096:
            dct = lattice_dct_plan(asm, R_mode)
            if dct is not None:
                return _dct_executor(asm, dct, R_mode, f_mode, f_zero, device)
        tree_plan = _resolve_core(asm, opts, tree_plan, _tree_plan is not None, R_mode)
        return _TreeExecutor(asm, tree_plan, R_mode, f_mode, f_zero, device)
    if "quad" not in (R_mode, f_mode):
        plan = _plan_blocked(asm)
        if plan is not None:
            return _BlockedExecutor(asm, plan, R_mode, f_mode, device)
    level_plan = _plan_level_elimination(asm, tree_plan)
    return _LevelExecutor(asm, tree_plan, level_plan, R_mode, f_mode, f_zero, device)


def _schur_solve(
    asm: _assembly.HydraulicNetworkAssembler,
    opts: SolverOptions,
    executor: _BlockedExecutor | _LevelExecutor | _TreeExecutor | _DctExecutor,
) -> tuple[np.ndarray, SolveInfo]:
    args = executor.prepare_args(*asm.schur_arguments(device=False))
    q_T, p_T, lam, iters, residual, rhs_norm, finite = executor(*args)
    x = _flatten_blocks_host(
        q_T.cpu().numpy(),
        p_T.cpu().numpy(),
        lam.cpu().numpy(),
        asm.network.edge_color,
        edge_order=getattr(executor, "edge_order", None),
        bif_order=getattr(executor, "bif_order", None),
    )
    residual = float(residual)
    rhs_norm = float(rhs_norm)
    # Direct-solve convergence gate of the reference (:4405-4414): a
    # κ-conditioned system's float64 residual cannot land below ~κ·ε·‖rhs‖
    # for any backward-stable direct method; the DCT executors carry κ ≈ n²
    # of an n-wide lattice, the tree-family eliminations report residual 0
    # and no hint, so for them it holds exactly when the solution is finite.
    kappa = float(getattr(executor, "kappa_hint", 0.0))
    floor = 64.0 * float(np.finfo(np.float64).eps) * kappa * rhs_norm
    converged = (
        residual <= max(opts.rtol * rhs_norm * 10, opts.atol, 1e-9, floor)
        and bool(finite)
    )
    return x, SolveInfo("schur", int(iters), residual, converged)


def _flatten_blocks_host(
    q_T: np.ndarray,
    p_T: np.ndarray,
    lam: np.ndarray,
    edge_color: np.ndarray | None = None,
    edge_order: np.ndarray | None = None,
    bif_order: np.ndarray | None = None,
) -> np.ndarray:
    """Host-side global block vector from j-major blocks.

    ``edge_color``: flux columns are re-ordered into the color-sorted
    global dof layout.  ``edge_order``/``bif_order``: the executor's
    internal→public maps, composed into the same fancy-index.  An optional
    leading batch axis is carried through."""
    q = np.swapaxes(np.asarray(q_T), -1, -2)  # (..., E, m), executor order
    p = np.swapaxes(np.asarray(p_T), -1, -2)
    lam_np = np.asarray(lam)
    E = q.shape[-2]
    if edge_order is not None:
        inv = np.argsort(edge_order)  # public edge id -> executor row
        p = np.take(p, inv, axis=-2)
    else:
        inv = None
    if edge_color is not None:
        perm = np.lexsort((np.arange(E), np.asarray(edge_color)))
        qidx = perm if inv is None else inv[perm]
        if not np.array_equal(qidx, np.arange(E)):
            q = np.take(q, qidx, axis=-2)
    elif inv is not None:
        q = np.take(q, inv, axis=-2)
    if bif_order is not None:
        lam_pub = np.empty_like(lam_np)
        lam_pub[..., np.asarray(bif_order)] = lam_np
        lam_np = lam_pub
    batch = q.shape[:-2]
    return np.concatenate(
        [q.reshape(*batch, -1), p.reshape(*batch, -1), lam_np], axis=-1
    )
