"""Solver for the hydraulic network saddle-point system (blocked forest path).

Counterpart of ``networks_fenicsx_tpu/solver.py``: :class:`Solver`
(``__init__``, ``assemble``, ``solve``, ``_scatter_functions``,
``solution_vector``), :func:`build_schur_executor` with the blocked route,
``_BlockedExecutor`` and its ``prepare_args``, ``_schur_solve`` with the
same convergence gate, and ``_flatten_blocks_host``.

With discontinuous (degree-0) pressure the system decouples into per-edge
chains tied together only by the bifurcation multipliers λ; eliminating
flux and pressure edge by edge (K1, :mod:`.kernels.condense`) reduces it to
an SPD weighted graph Laplacian on the bifurcations, which a uniformly-K-ary
forest eliminates exactly level by level (K2–K4, :mod:`.kernels.tree_sweep`);
flux and pressure then follow from λ in closed form (K5,
:mod:`.kernels.expand`).

The device is explicit: ``Solver(asm, device="cuda")`` (the default) runs the
CUDA kernels and raises when CUDA is absent; ``device="cpu"`` runs their
plain PyTorch versions.  Everything outside the blocked envelope raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from . import assembly as _assembly
from .blocked import _permute_coefficient, _plan_blocked, device_plan
from .function import NetworkFunction
from .kernels import condense, expand, tree_sweep
from .utils.config import SolverOptions
from .utils.timing import timed

__all__ = ["Solver", "SolveInfo", "build_schur_executor", "resolve_device"]

# ROADMAP items of the schur_method variants the port does not run yet
_SCHUR_METHOD_ITEM = {
    "dense": "A6",
    "dense_f64": "A6",
    "cg": "A7",
    "dct": "A7",
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
# Blocked forest executor
# ======================================================================


class _BlockedExecutor:
    """The blocked forest solve on one device.

    Holds the host plan, its index tensors and the internal-order cell
    widths (uploaded once).  ``prepare_args`` permutes the public-order
    coefficient arrays into the internal layout on the host;
    ``__call__`` uploads them and runs K1 → K2–K4 → K5 (``plain`` runs
    their plain versions instead), returning the
    reference's 7-tuple blocks contract
    ``(q_T, p_T, lam, iters, residual, rhs_norm, finite)`` in internal order
    (``edge_order``/``bif_order`` map it back to the public layout)."""

    blocks_out = True

    def __init__(self, asm, plan, R_mode: str, f_mode: str, device: torch.device):
        mesh = asm.network
        self.blocked_plan = plan
        self.edge_order = plan.edge_order
        self.bif_order = plan.bif_order
        self._R_mode = R_mode
        self._f_mode = f_mode
        self._N = mesh.N
        self._k = asm.flux_degree
        self._device = device
        self.device_plan = device_plan(plan, device)
        self._h_e = (
            torch.as_tensor(
                np.asarray(mesh.edge_length, dtype=np.float64)[plan.edge_order], device=device
            )
            / mesh.N
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


def build_schur_executor(
    asm: _assembly.HydraulicNetworkAssembler,
    opts: SolverOptions,
    device: torch.device | str = "cuda",
) -> _BlockedExecutor:
    """Build the blocked forest executor, or raise ``NotImplementedError``
    (naming the ROADMAP item) outside its envelope.

    The reference routes ``Solver`` through
    ``build_schur_executor(outputs="blocks", internal_layout=True)`` to the
    blocked-sibling plan on uniformly-K-ary forests; that route is the one
    the port has.  ``level_scan="on"`` runs the same kernels (the two
    reference variants are pinned equal)."""
    if opts.dtype != "float64" or opts.output_dtype not in ("same", "float64"):
        raise NotImplementedError("ROADMAP A4: float32 solves and outputs are not ported yet")
    if opts.schur_method not in ("auto", "tree"):
        item = _SCHUR_METHOD_ITEM[opts.schur_method]
        raise NotImplementedError(
            f"ROADMAP {item}: schur_method={opts.schur_method!r} is not ported yet"
        )
    if asm.pressure_degree != 0:
        raise ValueError("schur method requires discontinuous (degree-0) pressure")
    R_mode, f_mode, _ = asm.coefficient_modes()
    if "quad" in (R_mode, f_mode):
        raise NotImplementedError(
            "ROADMAP A5: callable (quadrature-mode) R or f is not ported yet"
        )
    plan = _plan_blocked(asm)
    if plan is None:
        raise NotImplementedError(
            "the network is not a uniformly-K-ary forest: general forests are "
            "ROADMAP A5, cyclic cores A6 and lattices A7"
        )
    return _BlockedExecutor(asm, plan, R_mode, f_mode, resolve_device(device))


def _schur_solve(
    asm: _assembly.HydraulicNetworkAssembler,
    opts: SolverOptions,
    executor: _BlockedExecutor,
) -> tuple[np.ndarray, SolveInfo]:
    args = executor.prepare_args(*asm.schur_arguments(device=False))
    q_T, p_T, lam, iters, residual, rhs_norm, finite = executor(*args)
    x = _flatten_blocks_host(
        q_T.cpu().numpy(),
        p_T.cpu().numpy(),
        lam.cpu().numpy(),
        asm.network.edge_color,
        edge_order=executor.edge_order,
        bif_order=executor.bif_order,
    )
    residual = float(residual)
    rhs_norm = float(rhs_norm)
    # Direct-solve convergence gate of the reference: the blocked
    # elimination reports residual 0 and no conditioning hint, so it holds
    # exactly when every precursor of the solution is finite.
    kappa = 0.0
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
