"""Solver for the hydraulic network saddle-point system.

Counterpart of ``networks_fenicsx_tpu/solver.py``: :class:`Solver`
(``__init__``, ``assemble``, ``solve``, ``_scatter_functions``,
``solution_vector``), :func:`build_schur_executor` with the forest,
peel-then-core and lattice routes, ``_BlockedExecutor`` and its
``prepare_args``, the general executors (the reference's generic ``core`` +
``_finish`` on a level plan, on a tree plan with a cycle core, or on the
DCT lattice plan), ``_schur_solve`` with the same convergence gate, and
``_flatten_blocks_host``, and the CG route (``_CgExecutor``).

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
  K18 :mod:`.kernels.shift_matvec`, K8b);
* CG — ``schur_method="cg"`` (or ``"tree_dist"``, which the reference's
  serial solver resolves nowhere, so that it reaches the same branch) on any
  network, or under ``auto`` a cycle
  core above 4,096 nodes that no sparse planner takes and that is not a
  scalar-R lattice: K8a, K9's bifurcation system, preconditioned conjugate
  gradients (K19a :mod:`.kernels.krylov`) on the K18 shift-class matvec or
  the K19b gather-fold matvec (:mod:`.kernels.gather_matvec`), with the 2-D
  or 1-D aggregation multigrid (K19c :mod:`.kernels.mg2d`, K19d
  :mod:`.kernels.mg1d`), Chebyshev-Jacobi or Jacobi as the reference picks
  them (:mod:`.multigrid`), then K8b.

* dense — ``schur_method="dense"`` or ``"dense_f64"``: K8a, K9's
  bifurcation system, the whole B×B Laplacian on K11 (its scaled factor
  with the pivot gate and three refinement passes, or the factor alone and
  one solve on K21b's triangular solves with the reference's unscaled
  pivot gate), the residual on K18 or K19b, K8b;
* no multiplier — a network without bifurcations: K8a and K8b, λ empty.

A sweep (:mod:`.batch`) runs S scenarios in the launches of one solve on
the blocked, level, tree (a dense or multifrontal core), dense, lattice and
no-multiplier routes (``has_scenario_axis``; each executor's
``scenarios``); the others (a min-degree core, ``dense_f64``, CG,
``schur_p``) run a row a call.

Besides ``"schur"``: ``"schur_p"`` (``auto`` with continuous pressure), the
reduced solve of :func:`_continuous_pressure_solve` — the per-edge flux
blocks factored and applied by K21a (:mod:`.kernels.schur_p`), ``J = [B;
G]`` and ``Jᵀ`` as CSR matrices (K20 fold, K20b products,
:mod:`.kernels.csr`), CG (K19a) on ``J A⁻¹ Jᵀ``; and the generic methods on
the assembled matrix (:func:`_generic_solve`): ``"dense"`` (K21b
:mod:`.kernels.dense_lu`), ``"minres"`` (K19e on K20b) and ``"host_lu"``
(SciPy on the host, as the reference).

The device is explicit: ``Solver(asm, device="cuda")`` (the default) runs the
CUDA kernels and raises when CUDA is absent; ``device="cpu"`` runs their
plain PyTorch versions.  :meth:`Solver.factorize` keeps a resistance-side
factorization for rhs-only re-solves (:mod:`.factorization`: the blocked,
lattice and peel-then-core classes, every core engine: multifrontal,
min-degree rounds with a dense tail or fronts, dense); float32 (A4) raises
naming its item; the sharded solves are :mod:`.parallel`.

:func:`build_schur_executor` returns the blocks contract by default and,
with ``outputs="flat"``, the reference's default contract on the device
(:class:`_FlatExecutor`).  The blocked route is differentiable
(:mod:`.adjoint`); every other executor raises for an input that requires
grad (``has_adjoint``).
"""

from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from . import adjoint
from . import assembly as _assembly
from . import tree as _tree
from .blocked import _permute_coefficient, _plan_blocked, device_plan
from .edge_data import edge_layout
from .function import NetworkFunction
from .kernels import (
    backsub, condense, csr, dct_lattice, dense_core, dense_lu, edge_data, expand, gather_matvec,
    grid_core, krylov, level_eliminate, peel, schur_p, segsum, shift_matvec, tree_sweep,
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
    segsum_matrix,
)
from .multigrid import (
    GatherOperator,
    Mg1dPreconditioner,
    Mg2dPreconditioner,
    ShiftOperator,
    choose_preconditioner,
    device_mg1d_plan,
    mg2d_plan,
)
from .ops.csr_assembly import build_csr_pattern, make_csr_assembler
from .ops.krylov import cg, minres
from .ops.sparse import CSRMatrix
from .tree import device_tree_plan, tree_schur_solve
from .utils.config import SolverOptions
from .utils.timing import timed

__all__ = ["Solver", "SolveInfo", "build_schur_executor", "resolve_device"]

class SolveInfo(typing.NamedTuple):
    method: str
    iterations: int
    residual: float
    converged: bool


def _symmetrize_signs(offsets: np.ndarray, M: int, n: int) -> np.ndarray:
    """Diagonal ±1 making the block system symmetric: the pressure rows
    carry +div while the flux rows carry −divᵀ; negating the pressure rows
    restores symmetry (reference ``solver.py:79-85``)."""
    s = np.ones(n)
    s[offsets[M] : offsets[M + 1]] = -1.0
    return s


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
        kind: Matrix layout of :meth:`assemble` for the generic methods
            ("bcoo"/"mpi"/"dense"/"nest"/"csr"); the Schur paths never
            materialise the global matrix, and solve by Schur whatever it is.
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
        self._factorization = None  # (fac, state, R digest, modes, R generation) of factorize()
        self._A = None
        self._b = None

    # ------------------------------------------------------------ properties
    @property
    def assembler(self) -> _assembly.HydraulicNetworkAssembler:
        return self._assembler

    @property
    def A(self):
        """The assembled matrix of the last :meth:`assemble` (None before)."""
        return self._A

    @property
    def b(self):
        """The assembled right-hand side of the last :meth:`assemble`."""
        return self._b

    @property
    def info(self) -> SolveInfo | None:
        """Diagnostics of the last solve."""
        return self._info

    def set_executor(self, executor) -> None:
        """Install a pre-built fused Schur executor, keyed to the assembler's
        current coefficient kinds."""
        self._executor = executor
        self._executor_key = self._assembler.coefficient_modes()

    def factorize(self) -> None:
        """Keep a resistance-side factorization for rhs-only re-solves
        (reference ``solver.py:153-206``).

        The classes of :mod:`.factorization` are tried in order (blocked,
        lattice, peel-then-core); the first that takes the problem factors
        ``R`` on the solver's device.  Later :meth:`solve` calls whose R is
        unchanged (only ``f`` and ``p_bc`` differ between ``compute_forms``
        calls) run the rhs half against it; a changed R, or a changed
        coefficient kind, drops it and the solve falls through to the fused
        path.  The factorized solve is the same exact elimination, gated on
        finiteness (``SolveInfo.residual`` is the λ residual on the lattice,
        0 elsewhere).  Raises ``ValueError`` outside every envelope."""
        import hashlib

        from .factorization import BlockedFactorization, GridFactorization, TreeFactorization

        if self._method() != "schur":
            raise ValueError("factorize() applies to the schur method only")
        asm = self._assembler
        R_data = asm.schur_arguments(device=False)[0]
        digest = hashlib.sha1(np.ascontiguousarray(R_data).tobytes()).digest()
        fac = None
        for cls in (BlockedFactorization, GridFactorization, TreeFactorization):
            try:
                fac = cls(asm, self._options, device=self._device)
                break
            except ValueError:
                continue
        if fac is None:
            raise ValueError(
                "factorize() requires scalar/per-edge/per-cell coefficients "
                "and a topology the direct paths serve (uniformly-K-ary "
                "forest, uniform lattice, or the general peel-then-core "
                "plan — quad-mode callables and fill-budget-breaching "
                "cores stay on the fused path)"
            )
        self._factorization = (
            fac, fac.factor(R_data), digest, asm.coefficient_modes(),
            getattr(asm, "_R_generation", 0),
        )

    def _factorized_solve(self):
        """``(x, info)`` from the stored factorization, or None when it is
        stale (dropped: R or a coefficient kind changed).  The staleness
        check is O(1) while the assembler's R generation is unchanged; after
        a bump the R bytes are hashed once and, on a match, the generation
        re-armed (reference ``:237-302``).  The ``f_zero`` flag is not
        compared: the factorized solve always processes f."""
        import hashlib

        fac, state, digest, modes, gen = self._factorization
        asm = self._assembler
        args = asm.schur_arguments(device=False)
        gen_now = getattr(asm, "_R_generation", 0)
        fresh = gen_now == gen
        if not fresh:
            now = hashlib.sha1(np.ascontiguousarray(args[0]).tobytes()).digest()
            if now == digest:
                fresh = True
                self._factorization = (fac, state, digest, modes, gen_now)
        if not (fresh and modes[:2] == asm.coefficient_modes()[:2]):
            self._factorization = None
            return None
        out = fac.solve(state, args[1], args[2], args[3])
        x = fac.solution_vector(out)
        finite = bool(out[-1])
        residual = float(out[-3]) if fac.solve_has_residual else 0.0
        return x, SolveInfo("schur_factorized", 0, residual, finite)

    def _method(self) -> str:
        m = self._options.method
        if m != "auto":
            return m
        return "schur" if self._assembler.pressure_degree == 0 else "schur_p"

    # -------------------------------------------------------------- assemble
    def assemble(self, lhs: bool = True, rhs: bool = True) -> None:
        """Assemble the system (reference ``solver.py:217-233``): nothing for
        the Schur method, the global matrix and vector on the solver's
        device for the other methods or an explicit ``kind``."""
        method = self._method()
        if method == "schur":
            self._assembler._require_forms()
        if method != "schur" or self._kind is not None:
            kind = self._kind or ("dense" if method == "dense" else "bcoo")
            self._A, self._b = self._assembler.assemble(
                assemble_lhs=lhs, assemble_rhs=rhs, kind=kind, device=self._device
            )

    # ----------------------------------------------------------------- solve
    @timed("nxfx:Solver:solve", block=True)
    def solve(self, functions: list[NetworkFunction] | None = None) -> list[NetworkFunction]:
        """Solve and scatter into solution functions.

        Returns the reference's function list contract
        ``[flux_color_0, ..., flux_color_{M-1}, pressure, global_flux]``
        where ``global_flux`` holds the multiplier values.
        """
        method = self._method()
        asm = self._assembler
        if method in ("schur", "schur_p") and asm.network.has_floating_component():
            raise RuntimeError(
                "Solver did not converge: network has a component with no "
                "boundary node — the system is singular (pressure level "
                "undetermined)"
            )
        factored = None
        if method == "schur" and self._factorization is not None:
            factored = self._factorized_solve()
        if factored is not None:
            x, info = factored
        elif method == "schur":
            key = asm.coefficient_modes()
            if self._executor is None or self._executor_key != key:
                self._executor = build_schur_executor(asm, self._options, device=self._device)
                self._executor_key = key
            x, info = _schur_solve(asm, self._options, self._executor)
        elif method == "schur_p":
            asm._require_forms()
            if not isinstance(self._executor, _SchurPExecutor):
                self._executor = _SchurPExecutor(asm, self._options, self._device)
                self._executor_key = None
            x, info = _continuous_pressure_solve(self._executor)
        else:
            if self._A is None or self._b is None:
                self.assemble()
            x, info = _generic_solve(self._A, self._b, asm, method, self._options)
        self._x = x
        self._info = info
        if self._options.monitor:
            print(
                f"[nxfx] method={info.method} iters={info.iterations} "
                f"residual={info.residual:.3e} converged={info.converged}"
            )
        if self._options.error_if_not_converged and not info.converged:
            if factored is not None:
                raise RuntimeError(
                    "Solver did not converge: factorized solve produced non-finite values"
                )
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
    # whether :meth:`scenarios` runs S scenarios in one launch of each kernel
    has_scenario_axis = False
    # whether a call differentiates (:mod:`.adjoint`); without it an input
    # that requires grad raises, naming ROADMAP A9c
    has_adjoint = False
    # whether the reference's program ignores its f argument (a zero scalar
    # source elided at build time): its gradient is then zero
    f_elided = False

    def prepare_args(self, R_data, f_data, start_pbc, end_pbc):
        return R_data, f_data, start_pbc, end_pbc

    def upload(self, *arrays) -> list[torch.Tensor]:
        """Host arrays or tensors -> contiguous float64 tensors on the
        executor's device.  A float64 tensor already there is passed as it is
        (its autograd graph kept); a host array is copied (a read-only array,
        an immutable R, too: a tensor needs writeable memory)."""
        return [a.to(self._device, torch.float64).contiguous() if isinstance(a, torch.Tensor)
                else torch.as_tensor(np.require(a, np.float64, "CW"), device=self._device)
                for a in arrays]

    def __call__(self, R_data, f_data, start_pbc, end_pbc):
        if not self.has_adjoint:
            adjoint.refuse_grad(type(self).__name__, R_data, f_data, start_pbc, end_pbc)
        return self._run(R_data, f_data, start_pbc, end_pbc, plain=False)

    def plain(self, R_data, f_data, start_pbc, end_pbc):
        """The same solve through the kernels' plain PyTorch versions, on the
        executor's device — what the kernels are checked against."""
        if not self.has_adjoint:
            adjoint.refuse_grad(type(self).__name__, R_data, f_data, start_pbc, end_pbc)
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
    (``edge_order``/``bif_order`` map it back to the public layout).
    :meth:`scenarios` runs S scenarios in the launches of one solve.

    Differentiable (``has_adjoint``): when grad mode is on and an input
    requires grad, ``__call__`` runs :class:`.adjoint.BlockedSolve` (K1, K2's
    factor, K3–K4's apply, K5; its backward the hand-written transpose), and
    ``plain`` the plain versions under PyTorch's own autograd; otherwise the
    launches and bits are the no-grad solve's."""

    has_scenario_axis = True
    has_adjoint = True

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
        if adjoint.wants_grad(R, f, sp, ep):
            if not plain:
                return self._zeros_after(adjoint.BlockedSolve.apply(self, R, f, sp, ep))
            if self.f_elided:
                f = f.detach()
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
        return self._zeros_after((q_T, p_T, lam, rhs_norm, finite))

    def _zeros_after(self, out):
        """``(q_T, p_T, lam, rhs_norm, finite)`` as the 7-tuple contract: a
        direct elimination reports ``iters = 0`` and residual 0."""
        q_T, p_T, lam, rhs_norm, finite = out
        iters = torch.zeros((), dtype=torch.int32, device=self._device)
        residual = torch.zeros((), dtype=torch.float64, device=self._device)
        return q_T, p_T, lam, iters, residual, rhs_norm, finite

    def scenarios(self, R, f, start_pbc, end_pbc):
        """S scenarios on the executor's device, internal layout: each
        argument a tensor there, batched (a leading ``S``) or shared by every
        scenario.  K1 once; K2–K4 once over the S rows when R is batched,
        else K2's factor once on the shared R and K3–K4 once over the S
        right-hand sides; K5 once.  Returns ``(q_T, p_T, lam, rhs_norm,
        finite)``, each with a leading ``S``; row ``i`` is the executor's
        call on row ``i`` bit for bit."""
        adjoint.refuse_grad("a sweep's scenario axis", R, f, start_pbc, end_pbc)
        dp, N, k, h = self.device_plan, self._N, self._k, self._h_e
        Rm, fm = self._R_mode, self._f_mode
        W, w, g, Ftot, const = condense.condense_scenarios(dp, N, k, h, R, f, Rm, fm, start_pbc,
                                                           end_pbc)
        if R.dim() > (2 if Rm == "cell" else 1):  # R batched: one factor a scenario
            lam, rhs_norm, *_ = tree_sweep.tree_sweep_scenarios(dp, w, const, Ftot)
        else:
            # one R for every scenario: its factor once, the rows' rhs on it
            factor = tree_sweep.tree_sweep_factor(dp, w[0])
            lam, rhs_norm, _ = tree_sweep.tree_sweep_apply_scenarios(dp, *factor, const, Ftot)
        q_T, p_T, finite = expand.expand_scenarios(dp, N, k, lam, start_pbc, end_pbc, W, w, g,
                                                   Ftot, h, R, f, Rm, fm)
        return q_T, p_T, lam, rhs_norm, finite


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
    and ``bif_order`` are None.  :meth:`scenarios` runs S scenarios in the
    launches of one solve."""

    has_scenario_axis = True

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

    def scenarios(self, R, f, start_pbc, end_pbc):
        """S scenarios on the executor's device, public order: each argument
        a tensor there, batched (a leading ``S``) or shared by every
        scenario.  K8a over S, K7 with its K6 sums over S (both channels for
        every scenario), K8b over S: one solve's launches whatever S.
        Returns ``(q_T, p_T, lam, rhs_norm, finite)``, each with a leading
        ``S``; row ``i`` is the executor's call on row ``i`` bit for bit."""
        dlp, N, k = self.device_plan, self._N, self._k
        ed = edge_data.edge_data_scenarios(
            dlp, N, k, self._h_e, self._quad_w, self._quad_phi, R, f, self._R_mode, self._f_mode,
            self._f_is_zero, start_pbc, end_pbc,
        )
        lam, rhs_norm = level_eliminate.level_eliminate_scenarios(dlp, ed)
        q_T, p_T, finite = backsub.backsub_scenarios(ed, lam, N, k)
        return q_T, p_T, lam, rhs_norm, finite


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
    order (``edge_order``/``bif_order`` None).  :meth:`scenarios` runs S
    scenarios in the launches of one solve unless the core is a min-degree
    one (``has_scenario_axis``)."""

    # the core factors a sweep chunk holds, in bytes (tree.core_chunk)
    scenario_budget = dense_core.SCENARIO_BUDGET

    @property
    def has_scenario_axis(self) -> bool:
        return _tree.has_scenario_axis(self.device_plan)

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

    def scenarios(self, R, f, start_pbc, end_pbc):
        """S scenarios on the executor's device, public order: each argument
        a tensor there, batched (a leading ``S``) or shared by every
        scenario.  K8a over S, the bifurcation systems over S (the prepare
        kernel and K6), then :func:`.tree.tree_solve_scenarios` — with R
        batched the pair sums and K9's rounds over S around S core factors
        and solves (K13–K15 or K11 over S, in chunks of
        :func:`.tree.core_chunk` at :attr:`scenario_budget`), with one R the
        pair sums, K9's ``d`` channel and the core's factor once and K9's
        ``r`` channel with the core's apply over S — then K8b over S.  The
        sweep drops ``‖rhs‖`` (as :meth:`_DenseExecutor.scenarios`).  Returns
        ``(q_T, p_T, lam, None, finite)``, each with a leading ``S``; row
        ``i`` is the executor's call on row ``i`` bit for bit.  Raises for a
        min-degree core."""
        if not self.has_scenario_axis:
            raise ValueError("a min-degree core has no scenario axis (ROADMAP A9b)")
        dtp, N, k = self.device_plan, self._N, self._k
        ed = edge_data.edge_data_scenarios(
            dtp, N, k, self._h_e, self._quad_w, self._quad_phi, R, f, self._R_mode, self._f_mode,
            self._f_is_zero, start_pbc, end_pbc,
        )
        dr, w_edges = peel.bifurcation_system_scenarios(dtp, ed.W, ed.g, ed.cumF[:, -1],
                                                        ed.start_pbc, ed.end_pbc)
        R_batched = R.dim() > (2 if self._R_mode == "quad" else 1)
        lam = _tree.tree_solve_scenarios(dtp, dr, w_edges, R_batched, self.scenario_budget)
        q_T, p_T, finite = backsub.backsub_scenarios(ed, lam, N, k)
        return q_T, p_T, lam, None, finite


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
    ``iters = 0``.  :meth:`scenarios` runs S scenarios in the launches of
    one solve.  No adjoint: K16's λ solve has no transpose yet (ROADMAP
    A9c-3), so an input that requires grad raises."""

    has_adjoint = False

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

    def scenarios(self, R, f, start_pbc, end_pbc):
        """S scenarios on the executor's device, internal layout: each
        argument a tensor there, batched (a leading ``S``; R ``(S, 1)``) or
        shared.  K1 once over S; K17's assembly once (on the shared
        conductances when R is shared); K16's factors once over the S rows
        when R is batched, else its factor once on the shared R; K16's
        passes once over S with K17's stencil over S as their residual; K5
        once.  The sweep drops ``‖rhs‖`` and the final residual (the
        reference's vmapped solve returns only ``q_T``, ``p_T``, λ).  Returns
        ``(q_T, p_T, lam, None, finite)``, each with a leading ``S``; row
        ``i`` is the executor's call on row ``i`` bit for bit."""
        gdp, N, k, h, op = self.device_plan, self._N, self._k, self._h_e, self.operator
        Rm, fm = self._R_mode, self._f_mode
        W, w, g, Ftot, const = condense.condense_scenarios(gdp, N, k, h, R, f, Rm, fm, start_pbc,
                                                           end_pbc)
        R_batched = R.dim() > 1  # scalar R: (1,) shared, (S, 1) batched
        w_s = w if R_batched else w[0]  # one R: its conductances, read at stride 0
        rhs, diag, _ = grid_core.grid_core_scenarios(gdp, w_s, const, Ftot, norm=False)
        state = (dct_lattice.dct_factor_scenarios(op, w) if R_batched
                 else dct_lattice.dct_factor(op, w[0]))
        lam = dct_lattice.dct_apply_scenarios(
            op, state, rhs, lambda lam: grid_core.grid_residual_scenarios(gdp, w_s, diag, lam, rhs))
        q_T, p_T, finite = expand.expand_scenarios(gdp, N, k, lam, start_pbc, end_pbc, W, w, g,
                                                   Ftot, h, R, f, Rm, fm)
        return q_T, p_T, lam, None, finite


class _DctExecutor(_Executor):
    """The general DCT lattice route on one device (the reference's generic
    ``core`` and the DCT branch of ``_finish``, ``:4121-4142``, ``:4242-4264``).

    Holds the device tables (:func:`.lattice.device_lattice_plan`) and K16's
    operator, uploaded once.  Edges and bifurcations stay in public order.
    ``__call__`` runs K8a, the bifurcation system (K9's ``lambda_system``),
    the class weights (K6), K16 with K18 as its refinement matvec, K18's
    final residual and K8b, and returns the 7-tuple blocks contract with
    the residual norm and ``iters = 0``; ``plain`` runs their plain
    versions.  :meth:`scenarios` runs S scenarios in the launches of one
    solve."""

    has_scenario_axis = True

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
            make, lam_sys, matvec, solve, expand_lam = (
                edge_data.edge_data_plain, peel.lambda_system_plain,
                shift_matvec.shift_matvec_plain, dct_lattice.dct_lattice_plain,
                backsub.backsub_plain,
            )
        else:
            make, lam_sys, matvec, solve, expand_lam = (
                edge_data.edge_data, peel.lambda_system, shift_matvec.shift_matvec,
                dct_lattice.dct_lattice, backsub.backsub,
            )
        dlp, N, k = self.device_plan, self._N, self._k
        ed = make(
            dlp, N, k, self._h_e, self._quad_w, self._quad_phi, R, f,
            self._R_mode, self._f_mode, self._f_is_zero, sp, ep,
        )
        dr, w_edges, rhs_norm = lam_sys(dlp, ed)
        cw = _class_weights(dlp, w_edges, plain)
        diag, rhs = dr[:, 0], dr[:, 1]
        classes = dlp.offsets if plain else dlp.shift  # the plain version takes the offsets
        lam = solve(self.operator, w_edges, rhs.contiguous(),
                    lambda lam: matvec(classes, cw, diag, lam, rhs))
        _, res_norm = matvec(classes, cw, diag, lam, rhs, norm=True)
        q_T, p_T, finite = expand_lam(ed, lam, N, k)
        iters = torch.zeros((), dtype=torch.int32, device=self._device)
        return q_T, p_T, lam, iters, res_norm, rhs_norm, finite

    def scenarios(self, R, f, start_pbc, end_pbc):
        """S scenarios on the executor's device, public order: each argument
        a tensor there, batched (a leading ``S``) or shared.  K8a over S, the
        bifurcation systems over S (the prepare kernel and K6); with R
        batched the class weights (K6) and K16's factors over S, with one R
        both once on row 0 (read at stride 0); K16's passes over S with K18
        over S as their residual; K8b over S.  The sweep drops ``‖rhs‖`` and
        the final residual.  Returns ``(q_T, p_T, lam, None, finite)``, each
        with a leading ``S``; row ``i`` is the executor's call on row ``i``
        bit for bit."""
        dlp, N, k, op = self.device_plan, self._N, self._k, self.operator
        ed = edge_data.edge_data_scenarios(
            dlp, N, k, self._h_e, self._quad_w, self._quad_phi, R, f, self._R_mode, self._f_mode,
            self._f_is_zero, start_pbc, end_pbc,
        )
        dr, w_edges = peel.bifurcation_system_scenarios(dlp, ed.W, ed.g, ed.cumF[:, -1],
                                                        ed.start_pbc, ed.end_pbc)
        S, C = dr.shape[0], dlp.offsets.size
        if R.dim() > 1:  # scalar R batched, (S, 1): S factors
            cw = segsum.segsum_plan_scenarios(dlp.class_sums, w_edges)[0].view(S, C, -1)
            state = dct_lattice.dct_factor_scenarios(op, w_edges)
        else:  # one R: its class weights and factor once
            cw = _class_weights(dlp, w_edges[0], plain=False)
            state = dct_lattice.dct_factor(op, w_edges[0])
        diag, rhs = dr[:, :, 0], dr[:, :, 1]  # stride-2 columns, as K18's plan reads them
        lam = dct_lattice.dct_apply_scenarios(
            op, state, rhs.contiguous(),
            lambda lam: shift_matvec.shift_matvec_scenarios(dlp.shift, cw, diag, lam, rhs))
        q_T, p_T, finite = backsub.backsub_scenarios(ed, lam, N, k)
        return q_T, p_T, lam, None, finite


def _class_weights(dlp, w_edges, plain: bool) -> torch.Tensor:
    """The ``(C, B)`` class weights of a solve: K6 on the device plan's
    ``class_sums``, or its plain version."""
    if plain:
        return _shift_class_weights(w_edges, dlp.class_idx, dlp.offsets.size, segsum.segsum_plain)
    return segsum.segsum_plan(dlp.class_sums, w_edges)[0].view(dlp.offsets.size, -1)


class _CgExecutor(_Executor):
    """The iterative λ solve on one device (the reference's generic ``core``
    and the CG branch of ``_finish``, ``:4122-4133``, ``:4167-4243``).

    Holds the device tables (:func:`.lattice.device_lattice_plan`: the shift
    classes, or else the gather-fold tables), the preconditioner's kind
    (:func:`.multigrid.choose_preconditioner`, which raises the reference's
    ``ValueError`` for ``cg_precond="mg"`` on a graph that does not qualify)
    and its host plan, all made once.  Edges and bifurcations stay in public
    order.  ``__call__`` runs K8a, the bifurcation system (K9's
    ``lambda_system``), the class weights (K6) on a shift plan, the
    preconditioner's hierarchy (K19c or K19d, once per solve), CG (K19a
    around the K18 or K19b matvec and the preconditioner), the residual
    ``‖Lλ − rhs‖`` (K18 or K19b) and K8b, and returns the 7-tuple blocks
    contract with the iteration count and that residual (no conditioning
    hint: CG's own gate); ``plain`` runs their plain versions."""

    def __init__(self, asm, opts: SolverOptions, R_mode, f_mode, f_is_zero, device):
        mesh = asm.network
        self._N = mesh.N
        self._k = asm.flux_degree
        self._R_mode = R_mode
        self._f_mode = f_mode
        self._f_is_zero = bool(f_is_zero)
        self._device = device
        self._opts = opts
        self.device_plan = dlp = device_lattice_plan(asm, _build_lambda_plan(asm), device)
        # K18's plan of the λ operator (contiguous diag and rhs), or K19b's
        self.shift_plan = None if dlp.classes is None else shift_matvec.ShiftPlan(
            dlp.offsets, dlp.num_bifurcations, device)
        self.gather_plan = None if dlp.classes is not None else gather_matvec.GatherPlan(
            dlp.mv_edge, dlp.mv_other, dlp.num_edges)
        self._h_e = torch.as_tensor(
            np.asarray(mesh.edge_length, dtype=np.float64) / mesh.N, device=device
        )
        self._quad_w, self._quad_phi = self.upload(asm._quad_weights, asm._quad_phi)
        self._plan_lambda_solve(asm)

    def _plan_lambda_solve(self, asm) -> None:
        """The preconditioner's kind and host plan."""
        B, dlp = asm.network.num_multipliers, self.device_plan
        self.precond_kind = kind = choose_preconditioner(self._opts, dlp.classes, B)
        if kind[0] == "2d":
            self.precond_plan = mg2d_plan(dlp.offsets, B, kind[1])
        elif kind[0] == "1d":
            self.precond_plan = device_mg1d_plan(kind[1], self._device)
        else:
            self.precond_plan = None

    def _operator(self, dr, w_edges, plain: bool):
        """``(operator, class weights or None)`` of this solve's λ system."""
        dlp = self.device_plan
        diag = dr[:, 0].contiguous()
        if dlp.classes is None:
            return GatherOperator(self.gather_plan, w_edges, diag, plain), None
        cw = _class_weights(dlp, w_edges, plain)
        return ShiftOperator(self.shift_plan, cw, diag, plain), cw

    def _preconditioner(self, op, cw, plain: bool):
        kind, opts = self.precond_kind[0], self._opts
        if kind == "2d":
            return Mg2dPreconditioner(self.precond_plan, cw, op.diag, opts.mg_overcorrect, plain)
        if kind == "1d":
            return Mg1dPreconditioner(self.precond_plan, op.offsets, cw, op.diag,
                                      opts.mg_overcorrect, plain)
        if kind == "chebyshev":
            return op.chebyshev(self.precond_kind[1])
        return krylov.Jacobi(op.diag)

    def _run(self, R_data, f_data, start_pbc, end_pbc, plain: bool):
        R, f, sp, ep = self.upload(R_data, f_data, start_pbc, end_pbc)
        if plain:
            make, lam_sys, expand_lam = (
                edge_data.edge_data_plain, peel.lambda_system_plain, backsub.backsub_plain,
            )
        else:
            make, lam_sys, expand_lam = edge_data.edge_data, peel.lambda_system, backsub.backsub
        dlp, N, k, opts = self.device_plan, self._N, self._k, self._opts
        ed = make(
            dlp, N, k, self._h_e, self._quad_w, self._quad_phi, R, f,
            self._R_mode, self._f_mode, self._f_is_zero, sp, ep,
        )
        dr, w_edges, rhs_norm = lam_sys(dlp, ed)
        op, cw = self._operator(dr, w_edges, plain)
        rhs = dr[:, 1].contiguous()
        lam, iters = self._solve_lambda(op, cw, w_edges, rhs, plain)
        _, res_norm = op.residual(rhs, lam, norm=True)
        q_T, p_T, finite = expand_lam(ed, lam, N, k)
        return q_T, p_T, lam, torch.tensor(iters, dtype=torch.int32), res_norm, rhs_norm, finite

    def _solve_lambda(self, op, cw, w_edges, rhs, plain: bool):
        """``(λ, iterations)``: preconditioned CG."""
        opts = self._opts
        result = cg(op.apply, rhs, precond=self._preconditioner(op, cw, plain), rtol=opts.rtol,
                    atol=opts.atol, maxiter=opts.maxiter, plain=plain)
        return result.x, result.iters


class _DenseExecutor(_CgExecutor):
    """The λ solve on the whole B×B bifurcation Laplacian (the reference's
    ``schur_method="dense"`` and ``"dense_f64"`` branch of ``_finish``,
    ``:4143-4166``), on one device.

    As :class:`_CgExecutor` — K8a, K9's bifurcation system, the residual
    ``‖Lλ − rhs‖`` on K18 or K19b, K8b — with the pair conductances (K6) and,
    in place of CG, ``"dense"``: K11 on the whole Laplacian (Jacobi-scaled
    factor, the pivot gate ``min > 1e-7·max``, three refinement passes);
    ``"dense_f64"``: K11's factor alone and one solve on K21b's triangular
    solves, λ NaN unless every unscaled pivot ``s_i·C_ii`` (the reference's
    ``diag(cholesky(L))``) is finite and ``min > 1e-7·max``.

    ``"dense"`` has a scenario axis (:meth:`scenarios`); ``"dense_f64"``
    keeps its rows (:meth:`_solve_lambda_f64`)."""

    # scenarios' K11 arrays a chunk holds, in bytes (dense_core.scenario_chunk)
    scenario_budget = dense_core.SCENARIO_BUDGET

    @property
    def has_scenario_axis(self) -> bool:
        return self._opts.schur_method == "dense"

    def _plan_lambda_solve(self, asm) -> None:
        """The pairs of the Laplacian (pair nodes, ids) and the K6 gather
        matrix of their conductances."""
        mesh = asm.network
        if mesh.num_multipliers > dense_core.MAX_CORE:
            raise ValueError(
                f"schur_method={self._opts.schur_method!r} factors the B×B Laplacian densely: at "
                f"most {dense_core.MAX_CORE} bifurcations, got {mesh.num_multipliers}"
            )
        tree_plan = _cached_tree_plan(asm)
        pairs, ep = tree_plan.pair_nodes, tree_plan.edge_pair
        sel = np.flatnonzero(ep >= 0)
        order = np.argsort(ep[sel], kind="stable")

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=self._device)

        self._pair_idx = i32(segsum_matrix(ep[sel][order], pairs.shape[0], mesh.num_edges,
                                           sel=sel[order]))
        self._pair_sums = segsum.SumPlan(((self._pair_idx, None),), (1,))
        self._ci, self._cj = i32(pairs[:, 0]), i32(pairs[:, 1])
        self._pid = i32(np.arange(pairs.shape[0]))

    def _solve_lambda(self, op, cw, w_edges, rhs, plain: bool):
        if self._pid.shape[0]:
            w_pairs = (segsum.segsum_plain(self._pair_idx, w_edges) if plain
                       else segsum.segsum_plan(self._pair_sums, w_edges)[0])
        else:
            w_pairs = torch.zeros(0, dtype=torch.float64, device=rhs.device)
        pairs = (self._ci, self._cj, self._pid)
        if self._opts.schur_method == "dense":
            solve = dense_core.dense_core_plain if plain else dense_core.dense_core
            return solve(*pairs, op.diag, rhs, w_pairs), 0
        return self._solve_lambda_f64(pairs, op.diag, rhs, w_pairs, plain), 0

    def _solve_lambda_f64(self, pairs, diag, rhs, w_pairs, plain: bool):
        """``schur_method="dense_f64"``: K11's factor, one solve on K21b's
        ``trsv`` and the unscaled pivot gate.  A sweep runs it a row a call
        (``has_scenario_axis`` False): ``auto`` never picks it, and K21b's
        ``trsv`` has no scenario axis yet (ROADMAP A9b)."""
        factor = dense_core.dense_factor_plain if plain else dense_core.dense_factor
        tri = dense_lu.trsv_plain if plain else dense_lu.trsv
        _, s, C = factor(*pairs, diag, w_pairs)
        y = tri(C, (rhs / s).contiguous(), lower=True)
        lam = tri(C, y, lower=True, trans=True) / s
        piv = s * torch.diagonal(C)
        ok = torch.all(torch.isfinite(piv)) & (piv.min() > dense_core.PIVOT_RTOL * piv.max())
        return torch.where(ok, lam, torch.nan)

    def scenarios(self, R, f, start_pbc, end_pbc):
        """S scenarios of ``schur_method="dense"`` on the executor's device,
        public order: each argument a tensor there, batched (a leading ``S``)
        or shared by every scenario.  K8a over S, the bifurcation systems over
        S (the prepare kernel and K6); with R batched the pair sums (K6),
        K11's factors, gates and solves over S, in chunks of
        :func:`.kernels.dense_core.scenario_chunk` at :attr:`scenario_budget`
        (each chunk one factor's launches); with one R the pair sums, factor
        and gate once on row 0 and the solves over S; then K8b over S.  The
        sweep drops ``‖rhs‖`` and the residual (the reference's vmapped solve
        returns only ``q_T``, ``p_T``, λ), so neither the norm kernel nor the
        K18/K19b operator runs.  Returns ``(q_T, p_T, lam, None, finite)``,
        each with a leading ``S``; row ``i`` is the executor's call on row
        ``i`` bit for bit."""
        if not self.has_scenario_axis:
            raise ValueError(f"schur_method={self._opts.schur_method!r} has no scenario axis")
        dlp, N, k = self.device_plan, self._N, self._k
        ed = edge_data.edge_data_scenarios(
            dlp, N, k, self._h_e, self._quad_w, self._quad_phi, R, f, self._R_mode, self._f_mode,
            self._f_is_zero, start_pbc, end_pbc,
        )
        dr, w_edges = peel.bifurcation_system_scenarios(dlp, ed.W, ed.g, ed.cumF[:, -1],
                                                        ed.start_pbc, ed.end_pbc)
        diag, rhs = dr[:, :, 0].contiguous(), dr[:, :, 1].contiguous()
        R_batched = R.dim() > (2 if self._R_mode == "quad" else 1)
        lam = self._lambda_scenarios(diag, rhs, w_edges, R_batched)
        q_T, p_T, finite = backsub.backsub_scenarios(ed, lam, N, k)
        return q_T, p_T, lam, None, finite

    def _lambda_scenarios(self, diag, rhs, w_edges, R_batched: bool):
        """λ ``(S, B)`` of S systems: S factors (R batched) or one (shared)."""
        S, B = rhs.shape
        pairs = (self._ci, self._cj, self._pid)
        P = self._pid.shape[0]
        chunk = dense_core.scenario_chunk(B, R_batched, self.scenario_budget)
        parts = []
        if R_batched:
            w_pairs = (segsum.segsum_plan_scenarios(self._pair_sums, w_edges)[0] if P
                       else w_edges.new_zeros((S, 0)))
            for i0 in range(0, S, chunk):
                rows = slice(i0, i0 + chunk)
                Lc, s, C = dense_core.dense_factor_scenarios(*pairs, diag[rows], w_pairs[rows])
                ok = dense_core.dense_gate_scenarios(C)
                parts.append(dense_core.dense_solve_scenarios(Lc, s, C, ok, rhs[rows]))
        else:  # one R: its factor once, as the reference's vmap batches only the rhs
            w_pairs = (segsum.segsum_plan(self._pair_sums, w_edges[0])[0] if P
                       else w_edges.new_zeros(0))
            Lc, s, C = dense_core.dense_factor(*pairs, diag[0], w_pairs)
            ok = dense_core.dense_gate(C)
            for i0 in range(0, S, chunk):
                parts.append(dense_core.dense_solve_scenarios(Lc, s, C, ok, rhs[i0: i0 + chunk]))
        return parts[0] if len(parts) == 1 else torch.cat(parts)


@dataclasses.dataclass(frozen=True)
class _EdgePlan:
    """The bifurcation at each edge end (-1 at a boundary node) on the
    device: what the edge-data and back-substitution kernels read."""

    start_bif: torch.Tensor
    end_bif: torch.Tensor

    @property
    def num_edges(self) -> int:
        return int(self.start_bif.shape[0])


class _EdgeExecutor(_Executor):
    """A network without bifurcations (the reference's ``B = 0`` branch of
    ``_finish``, ``:4244-4248``): K8a and K8b with an empty λ, in public
    order; iterations 0, residual 0 and ``‖rhs‖ = 0``.  :meth:`scenarios`
    runs S scenarios in one launch each of K8a and K8b."""

    has_scenario_axis = True

    def __init__(self, asm, R_mode, f_mode, f_is_zero, device):
        mesh = asm.network
        self._N = mesh.N
        self._k = asm.flux_degree
        self._R_mode = R_mode
        self._f_mode = f_mode
        self._f_is_zero = bool(f_is_zero)
        self._device = device

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

        self.device_plan = _EdgePlan(i32(asm._edge_start_bif), i32(asm._edge_end_bif))
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
        ed = make(
            self.device_plan, self._N, self._k, self._h_e, self._quad_w, self._quad_phi, R, f,
            self._R_mode, self._f_mode, self._f_is_zero, sp, ep,
        )
        lam = torch.zeros(0, dtype=torch.float64, device=self._device)
        q_T, p_T, finite = expand_lam(ed, lam, self._N, self._k)
        zero = torch.zeros((), dtype=torch.float64, device=self._device)
        iters = torch.zeros((), dtype=torch.int32, device=self._device)
        return q_T, p_T, lam, iters, zero, zero, finite

    def scenarios(self, R, f, start_pbc, end_pbc):
        """S scenarios on the executor's device (each argument batched or
        shared): K8a and K8b over S, λ ``(S, 0)``.  Returns ``(q_T, p_T, lam,
        None, finite)``, row ``i`` the executor's call on row ``i`` bit for
        bit."""
        ed = edge_data.edge_data_scenarios(
            self.device_plan, self._N, self._k, self._h_e, self._quad_w, self._quad_phi, R, f,
            self._R_mode, self._f_mode, self._f_is_zero, start_pbc, end_pbc,
        )
        lam = torch.zeros((ed.W.shape[0], 0), dtype=torch.float64, device=self._device)
        q_T, p_T, finite = backsub.backsub_scenarios(ed, lam, self._N, self._k)
        return q_T, p_T, lam, None, finite


def _dct_executor(asm, dct: _DctPlan, R_mode, f_mode, f_zero, device):
    """The grid route when the lattice layout applies and f is not
    quad-mode, the general DCT route otherwise (reference ``:4030-4054``)."""
    if f_mode in ("scalar", "edge", "cell"):
        grid = _plan_grid_layout(asm, dct)
        if grid is not None:
            return _GridExecutor(asm, grid, R_mode, f_mode, device)
    return _DctExecutor(asm, dct, R_mode, f_mode, f_zero, device)


def _resolve_core(asm, opts: SolverOptions, tree_plan, override: bool, R_mode: str):
    """The tree plan the cyclic route runs, with its core plan; None for
    the CG route; or raise.

    The reference's routing (``:3928-3966``): a core of at most 512 nodes
    is dense (or runs the core plan a caller attached).  Under ``auto`` a
    larger core gets a sparse core plan attached unless the graph is a
    scalar-R lattice; it runs with a core plan or, without one, densely up
    to 4,096 nodes; above, the reference falls to CG (None here; the
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
        return None
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
    elide_zero_f: bool = True,
    outputs: str = "blocks",
):
    """Build the executor, or raise ``NotImplementedError`` (naming the
    ROADMAP item) for float32.

    ``outputs="blocks"``, the port's default (every caller in the port reads
    the blocks): the reference's ``outputs="blocks", internal_layout=True``
    contract, ``(q_T, p_T, lam, iters, residual, rhs_norm, finite)`` in the
    executor's internal order from arguments in that order
    (``prepare_args``).  ``outputs="flat"``: the reference's default
    contract, ``(x, iters, residual, rhs_norm, finite)`` with ``x`` the
    global vector on the device, from public-order arguments
    (:class:`_FlatExecutor`).  The blocked route is differentiable either
    way (:mod:`.adjoint`); every other route raises ``NotImplementedError``
    (ROADMAP A9c) for an input that requires grad.  Under ``"flat"`` a zero
    scalar f is elided as the reference's flat program elides it (its
    gradient zero), except at flux degree 1 with scalar or per-edge R and f,
    whose program reads it; the reference's blocked program never elides."""
    if outputs not in ("blocks", "flat"):
        raise ValueError(f"outputs must be 'blocks' or 'flat', got {outputs!r}")
    ex = _route_executor(asm, opts, device, _tree_plan, elide_zero_f)
    if outputs == "blocks":
        return ex
    R_mode, f_mode, f_zero = asm.coefficient_modes()
    uniform = asm.flux_degree == 1 and {R_mode, f_mode} <= {"scalar", "edge"}
    ex.f_elided = bool(f_zero and elide_zero_f and not uniform)
    return _FlatExecutor(ex, asm)


def _route_executor(asm, opts: SolverOptions, device, _tree_plan,
                    elide_zero_f: bool) -> _Executor:
    """The blocks executor of :func:`build_schur_executor`.

    Routes as the reference's
    ``build_schur_executor(outputs="blocks", internal_layout=True)``:
    ``schur_method="dct"`` takes the DCT lattice solve or raises the
    reference's ``ValueError`` without a DCT plan; any other method on a
    network without bifurcations the edge executor (λ empty);
    ``"dense"``/``"dense_f64"`` the dense executor; ``"cg"`` and
    ``"tree_dist"`` the CG executor (never the DCT solve); otherwise the
    tree plan;
    on a forest the level plan, then the blocked executor when
    ``_plan_blocked`` succeeds and neither coefficient is quad-mode, the
    level executor otherwise; with a cycle core, under ``auto`` a scalar-R
    lattice whose core exceeds 4,096 nodes takes the DCT solve, anything
    else the tree executor or, a core above 4,096 nodes without a sparse
    plan, the CG executor (see :func:`_resolve_core`).  The DCT solve runs
    on the grid executor or the general DCT executor (:func:`_dct_executor`).
    ``_tree_plan`` overrides the cached tree plan (tests use it to force
    the multifrontal engine on a small core).  ``level_scan="on"`` runs the
    same kernels (the two reference variants are pinned equal).
    ``elide_zero_f=False`` keeps the source's terms when the assembler's f
    is the scalar zero (a sweep whose f varies by scenario)."""
    if opts.dtype != "float64" or opts.output_dtype not in ("same", "float64"):
        raise NotImplementedError("ROADMAP A4: float32 solves and outputs are not ported yet")
    if asm.pressure_degree != 0:
        raise ValueError("schur method requires discontinuous (degree-0) pressure")
    device = resolve_device(device)
    R_mode, f_mode, f_zero = asm.coefficient_modes()
    f_zero = f_zero and elide_zero_f
    if asm.network.num_multipliers == 0 and opts.schur_method != "dct":
        return _EdgeExecutor(asm, R_mode, f_mode, f_zero, device)
    if opts.schur_method in ("dense", "dense_f64"):
        return _DenseExecutor(asm, opts, R_mode, f_mode, f_zero, device)
    if opts.schur_method == "dct":
        dct = lattice_dct_plan(asm, R_mode)
        if dct is None:
            raise ValueError(
                "schur_method='dct' requires a uniform rectangular-lattice "
                "multiplier graph (make_grid family) with scalar resistance"
            )
        return _dct_executor(asm, dct, R_mode, f_mode, f_zero, device)
    # never the DCT solve (reference :3985-3996); "tree_dist" is resolved
    # nowhere in the reference's serial solver and falls to its CG branch
    if opts.schur_method in ("cg", "tree_dist"):
        return _CgExecutor(asm, opts, R_mode, f_mode, f_zero, device)
    tree_plan = _tree_plan if _tree_plan is not None else _cached_tree_plan(asm)
    if tree_plan.core_size > 0:
        if opts.schur_method == "auto" and tree_plan.core_size > 4096:
            dct = lattice_dct_plan(asm, R_mode)
            if dct is not None:
                return _dct_executor(asm, dct, R_mode, f_mode, f_zero, device)
        tree_plan = _resolve_core(asm, opts, tree_plan, _tree_plan is not None, R_mode)
        if tree_plan is None:
            return _CgExecutor(asm, opts, R_mode, f_mode, f_zero, device)
        return _TreeExecutor(asm, tree_plan, R_mode, f_mode, f_zero, device)
    if "quad" not in (R_mode, f_mode):
        plan = _plan_blocked(asm)
        if plan is not None:
            return _BlockedExecutor(asm, plan, R_mode, f_mode, device)
    level_plan = _plan_level_elimination(asm, tree_plan)
    return _LevelExecutor(asm, tree_plan, level_plan, R_mode, f_mode, f_zero, device)


class _FlatExecutor:
    """The reference's ``outputs="flat"`` contract around a blocks executor.

    Takes the public-order arguments of ``asm.schur_arguments()`` (host
    arrays or tensors; a ``"cell"`` coefficient ``(C,)``) and permutes them
    into the inner executor's layout on the device (``"cell"`` to its ``(N,
    E)`` blocks); returns ``(x, iters, residual, rhs_norm, finite)`` with
    ``x`` the global vector ``[q_0..q_{M-1}, p, λ]`` on the device: one
    gather of the blocks by an index built once (at the first call, from the
    blocks' shapes), the composition of ``argsort(edge_order)``, the
    ``edge_color`` order and ``bif_order`` that :func:`_flatten_blocks_host`
    applies on the host, so ``x`` is its result bit for bit.  Both relayouts
    are PyTorch gathers, differentiable: gradients reach the public-order
    inputs where the inner executor has an adjoint.  Other attributes are
    the inner executor's."""

    blocks_out = False

    def __init__(self, inner: _Executor, asm):
        self.inner = inner
        self._edge_color = asm.network.edge_color
        self._out_index = None
        eo = inner.edge_order
        if eo is not None:  # public edge rows (and cells) in the inner executor's order
            N = inner._N
            self._edge_index = torch.as_tensor(np.asarray(eo, np.int64), device=inner._device)
            self._cell_index = torch.as_tensor((eo[None, :] * N + np.arange(N)[:, None]).ravel(),
                                               device=inner._device)

    def __getattr__(self, name):
        return getattr(self.__dict__["inner"], name)

    def __call__(self, R_data, f_data, start_pbc, end_pbc):
        return self._run(R_data, f_data, start_pbc, end_pbc, plain=False)

    def plain(self, R_data, f_data, start_pbc, end_pbc):
        """The same through the inner executor's plain versions."""
        return self._run(R_data, f_data, start_pbc, end_pbc, plain=True)

    def _internal(self, R, f, sp, ep):
        """Public-order arguments to the inner executor's layout, on the device."""
        inner = self.inner
        if inner.edge_order is None:
            return R, f, sp, ep

        def permute(a, mode):
            if mode == "cell":
                return a.index_select(0, self._cell_index).view(inner._N, -1)
            return a if mode == "scalar" else a.index_select(0, self._edge_index)

        return (permute(R, inner._R_mode), permute(f, inner._f_mode), permute(sp, "edge"),
                permute(ep, "edge"))

    def _run(self, R_data, f_data, start_pbc, end_pbc, plain: bool):
        inner = self.inner  # refuses inputs that require grad where it has no adjoint
        args = self._internal(*inner.upload(R_data, f_data, start_pbc, end_pbc))
        q_T, p_T, lam, iters, residual, rhs_norm, finite = (
            inner.plain if plain else inner)(*args)
        if self._out_index is None:
            sizes = np.cumsum([0, q_T.numel(), p_T.numel()])
            idx = _flatten_blocks_host(
                np.arange(q_T.numel()).reshape(q_T.shape),
                sizes[1] + np.arange(p_T.numel()).reshape(p_T.shape),
                sizes[2] + np.arange(lam.numel()), self._edge_color,
                edge_order=inner.edge_order, bif_order=inner.bif_order)
            self._out_index = torch.as_tensor(idx, device=inner._device)
        blocks = torch.cat([q_T.reshape(-1), p_T.reshape(-1), lam])
        return blocks.index_select(0, self._out_index), iters, residual, rhs_norm, finite


def _schur_solve(
    asm: _assembly.HydraulicNetworkAssembler, opts: SolverOptions, executor: _Executor
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
    # Convergence gate of the reference (:4405-4414): a κ-conditioned
    # system's float64 residual cannot land below ~κ·ε·‖rhs‖ for any
    # backward-stable direct method; the DCT executors carry κ ≈ n² of an
    # n-wide lattice, the tree-family eliminations report residual 0 and no
    # hint, so for them it holds exactly when the solution is finite; CG and
    # the dense executor report the true residual ‖Lλ − rhs‖ and no hint.
    kappa = float(getattr(executor, "kappa_hint", 0.0))
    floor = 64.0 * float(np.finfo(np.float64).eps) * kappa * rhs_norm
    converged = (
        residual <= max(opts.rtol * rhs_norm * 10, opts.atol, 1e-9, floor)
        and bool(finite)
    )
    return x, SolveInfo("schur", int(iters), residual, converged)


# ======================================================================
# Continuous pressure: the reduced (p, λ) solve
# ======================================================================


class _SchurPExecutor:
    """The continuous-pressure reduced solve on one device (reference
    ``_continuous_pressure_solve``, ``:4644-4747``).

    Holds what is static per assembler, built once (its time in
    ``planning_s``): ``J = [B; G]`` — the reduced rows' flux columns of the
    COO stream — and ``Jᵀ`` as two :class:`.ops.sparse.CSRMatrix` whose
    values the K20 fold writes, K21a's flux-ordered tile plan
    (:func:`.kernels.schur_p.flux_tiles`, which checks the flux layout), the
    ``(p, −λ)`` sign vector.  ``__call__`` solves from the assembler's
    current cell masses and right-hand side; ``plain`` runs the kernels'
    plain versions.  Returns ``(x (n,) on the device, iterations, CG
    residual, converged)``."""

    def __init__(self, asm, opts: SolverOptions, device: torch.device):
        t0 = time.perf_counter()
        mesh = asm.network
        self._asm, self._opts, self._device = asm, opts, device
        self._N, self._k = mesh.N, asm.flux_degree
        M = mesh.num_edge_colors
        n_flux = int(asm.block_offsets[M])
        n_red = asm.num_dofs - n_flux
        self.n_flux = n_flux
        nm = mesh.num_cells * (self._k + 1) ** 2  # the mass block: flux rows only
        rows, cols = asm._all_rows[nm:], asm._all_cols[nm:]
        sel = np.flatnonzero((rows >= n_flux) & (cols < n_flux))
        jr, jc = rows[sel] - n_flux, cols[sel]
        self.j_raw = int(sel.size)
        vals = torch.as_tensor(asm._static_vals[sel], device=device)

        def folded(r, c, shape) -> CSRMatrix:
            pattern = build_csr_pattern(r, c, shape)
            return CSRMatrix(make_csr_assembler(pattern)(vals), pattern.indices, pattern.indptr,
                             shape)

        self.J = folded(jr, jc, (n_red, n_flux))
        self.JT = folded(jc, jr, (n_flux, n_red))
        self.tiles = schur_p.flux_tiles(asm._edge_flux_base, mesh.edge_color, self._N, self._k,
                                        device)
        B = mesh.num_multipliers
        self.sign = torch.cat([torch.ones(n_red - B, dtype=torch.float64, device=device),
                               -torch.ones(B, dtype=torch.float64, device=device)])
        self.planning_s = time.perf_counter() - t0

    def __call__(self):
        return self._run(plain=False)

    def plain(self):
        return self._run(plain=True)

    def _run(self, plain: bool):
        asm, opts = self._asm, self._opts
        if plain:
            factor, solve, tdiag = (schur_p.schur_p_factor_plain, schur_p.schur_p_solve_plain,
                                    csr.csr_tdiag_plain)
            spmv = csr.csr_spmv_plain
        else:
            factor, solve, tdiag = schur_p.schur_p_factor, schur_p.schur_p_solve, csr.csr_tdiag
            spmv = csr.csr_spmv
        J, JT = self.J.device_arrays, self.JT.device_arrays
        Lb, A_diag = factor(asm._cell_mass_on(self._device), self.tiles)

        def A_inv(v):
            return solve(Lb, self.tiles, v)

        Tdiag = tdiag(*J, A_diag)
        b = torch.as_tensor(asm._b_host, device=self._device)
        b_q, b_red = b[: self.n_flux], b[self.n_flux :]
        rhs = b_red - spmv(*J, A_inv(b_q))
        # T = J A⁻¹ Jᵀ on z = (p, −λ): SPD for inf-sup stable pairings
        result = cg(lambda z: spmv(*J, A_inv(spmv(*JT, z))), rhs,
                    precond=krylov.Jacobi(Tdiag), rtol=opts.rtol if opts.rtol > 0 else 1e-12,
                    atol=opts.atol, maxiter=opts.maxiter, plain=plain)
        z = result.x
        q = A_inv(b_q + spmv(*JT, z))
        return torch.cat([q, self.sign * z]), result.iters, result.residual, result.converged


def _continuous_pressure_solve(executor: _SchurPExecutor) -> tuple[np.ndarray, SolveInfo]:
    """Structure-exploiting solve for continuous pressure (degree >= 1): q
    eliminated edge by edge, Jacobi-preconditioned CG on the SPD reduced
    operator ``T = J A⁻¹ Jᵀ`` for ``z = (p, −λ)``, then ``q = A⁻¹(b_q +
    Jᵀz)`` (reference ``:4644-4747``)."""
    x, iters, residual, converged = executor()
    return x.cpu().numpy(), SolveInfo("schur_p", int(iters), float(residual), bool(converged))


# ======================================================================
# Generic paths: dense / minres / host LU on the assembled system
# ======================================================================


def _to_dense(A) -> torch.Tensor:
    """The assembled matrix as a dense tensor (its unique entries written)."""
    if isinstance(A, CSRMatrix):
        return A.todense()
    if isinstance(A, torch.Tensor) and A.is_sparse:
        out = torch.zeros(A.shape, dtype=A.dtype, device=A.device)
        idx = A.indices()
        out[idx[0], idx[1]] = A.values()
        return out
    if isinstance(A, torch.Tensor):
        return A
    raise TypeError(f"the generic methods take one assembled matrix, not {type(A).__name__}")


def _as_csr(A) -> CSRMatrix:
    """The assembled matrix as a :class:`.ops.sparse.CSRMatrix` (values on
    its device, structure on the host)."""
    if isinstance(A, CSRMatrix):
        return A
    if isinstance(A, torch.Tensor) and not A.is_sparse:
        A = A.to_sparse()
    if not (isinstance(A, torch.Tensor) and A.is_sparse):
        raise TypeError(f"the generic methods take one assembled matrix, not {type(A).__name__}")
    idx = A.indices().cpu().numpy()
    indptr = np.zeros(A.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(idx[0], minlength=A.shape[0]), out=indptr[1:])
    return CSRMatrix(A.values(), idx[1].astype(np.int32), indptr, tuple(A.shape))


def _to_scipy(A):
    import scipy.sparse as sp

    if isinstance(A, CSRMatrix):
        return A.to_scipy().tocsc()
    if isinstance(A, torch.Tensor) and A.is_sparse:
        idx = A.indices().cpu().numpy()
        return sp.csc_matrix((A.values().cpu().numpy(), (idx[0], idx[1])), shape=tuple(A.shape))
    return sp.csc_matrix(_to_dense(A).cpu().numpy())


def _extract_diagonal(A, plain: bool = False) -> torch.Tensor:
    """The diagonal of the assembled matrix (K20b's row reduction)."""
    return (csr.csr_diagonal_plain if plain else csr.csr_diagonal)(*_as_csr(A).device_arrays)


def _generic_solve(A, b: torch.Tensor, asm: _assembly.HydraulicNetworkAssembler, method: str,
                   opts: SolverOptions, plain: bool = False) -> tuple[np.ndarray, SolveInfo]:
    """``"dense"`` (K21b: LU with partial pivoting, the residual gate
    ``‖Ax − b‖ ≤ max(100·rtol·‖b‖, 1e-8)``), ``"host_lu"`` (SciPy ``splu``
    on the host, gate 1e-6) or ``"minres"`` (K19e on ``signs ⊙ (A·v)``
    through K20b, Jacobi on ``|diag|`` with 1 where it is 0) on the
    assembled system (reference ``:4781-4839``); ``plain`` runs the
    kernels' plain versions."""
    n = asm.num_dofs
    M = asm.network.num_edge_colors
    if method == "dense":
        Ad = _to_dense(A)
        factor, solve = ((dense_lu.lu_factor_plain, dense_lu.lu_solve_plain) if plain
                         else (dense_lu.lu_factor, dense_lu.lu_solve))
        x = solve(*factor(Ad), b)
        res = float(torch.linalg.norm(Ad @ x - b))
        ok = res <= max(opts.rtol * float(torch.linalg.norm(b)) * 100, 1e-8)
        finite = bool(torch.all(torch.isfinite(x)))
        return x.cpu().numpy(), SolveInfo("dense", 0, res, ok and finite)

    if method == "host_lu":
        import scipy.sparse.linalg as spla

        As = _to_scipy(A)
        b_np = b.cpu().numpy()
        x = spla.splu(As.tocsc()).solve(b_np)
        res = float(np.linalg.norm(As @ x - b_np))
        return x, SolveInfo("host_lu", 0, res, res <= 1e-6)

    if method == "minres":
        csr_A = _as_csr(A)
        dev = csr_A.data.device
        signs = torch.as_tensor(_symmetrize_signs(asm.block_offsets, M, n), device=dev)
        arrays = csr_A.device_arrays
        spmv = csr.csr_spmv_plain if plain else csr.csr_spmv
        # Jacobi on |diag| of the symmetrized operator, 1 where it vanishes
        # (the p and λ rows)
        d = _extract_diagonal(csr_A, plain).abs()
        d = torch.where(d > 0, d, 1.0)
        result = minres(lambda v: spmv(*arrays, v, signs), signs * b.to(dev),
                        precond=krylov.Jacobi(d), rtol=opts.rtol, atol=opts.atol,
                        maxiter=opts.maxiter, plain=plain)
        return result.x.cpu().numpy(), SolveInfo(
            "minres", int(result.iters), float(result.residual), bool(result.converged)
        )

    raise ValueError(f"unknown solver method {method!r}")


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
