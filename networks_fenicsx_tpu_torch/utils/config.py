"""Typed configuration objects.

Counterpart of ``networks_fenicsx_tpu/utils/config.py``, carried over as is
so that option dictionaries mean the same in both packages.  The port
serves a subset: :class:`networks_fenicsx_tpu_torch.Solver` raises
``NotImplementedError`` for the options it does not run yet.

The reference has no config system — options flow through constructor kwargs
(``NetworkMesh(N, color_strategy, comm, graph_rank)`` reference ``mesh.py:84-91``),
pass-through dicts (``jit_options``/``form_compiler_options`` reference
``assembly.py:172-173``; ``petsc_options`` reference ``solver.py:35-37``), and the
``kind`` matrix-layout selector (reference ``assembly.py:335``).  Here the same
surface is provided as small dataclasses; every public class also still accepts
plain kwargs for drop-in familiarity.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["SolverOptions", "ShardingOptions"]


@dataclasses.dataclass
class SolverOptions:
    """Options controlling :class:`networks_fenicsx_tpu_torch.Solver`.

    Replaces the reference's PETSc options dict (reference ``solver.py:58-65``:
    ``{"ksp_type": "preonly", "pc_type": "lu", "pc_factor_mat_solver_type":
    "mumps", "ksp_error_if_not_converged": True}``).

    Attributes:
        method: Solve strategy.
            ``"schur"`` — per-edge static condensation to the bifurcation
            Schur complement (exact; the TPU-native replacement for MUMPS LU);
            ``"dense"`` — assemble the full block matrix densely and solve
            (small systems / verification);
            ``"minres"`` — MINRES on the symmetrized block system with a
            block-diagonal preconditioner (iterative; large / generic);
            ``"auto"`` — schur when applicable, else dense/minres by size.
        schur_method: How the bifurcation Schur complement is solved:
            ``"auto"``, ``"dense"`` (Cholesky) or ``"cg"`` (matrix-free
            conjugate gradients on the bifurcation graph Laplacian).
            ``"dct"`` forces the exact separable-DCT direct solve (uniform
            rectangular lattices with scalar resistance; auto-engaged on
            the cg path when the structure admits it).
        rtol: Relative residual tolerance for iterative paths.
        atol: Absolute residual tolerance for iterative paths.
        maxiter: Iteration cap for iterative paths (None = dimension-based).
        error_if_not_converged: Raise if the final residual check fails,
            mirroring PETSc's ``ksp_error_if_not_converged``
            (reference ``solver.py:64``).
        monitor: Print residual progress, mirroring ``ksp_monitor``
            (reference ``solver.py:63``).
        dtype: Arithmetic dtype of the solve ("float64" or "float32").
        output_dtype: Dtype of the solution arrays the fused schur
            executor returns — ``"same"`` (default: follow ``dtype``),
            ``"float32"`` or ``"float64"``.  ``dtype="float64"`` +
            ``output_dtype="float32"`` is the mixed serving contract:
            the solve runs in full f64 (so the *values* carry f64-solve
            accuracy, only rounded on output) while the large solution
            blocks leave the program in f32 — on TPU, where f64 is
            emulated as split f32 pairs, this removes the X64 output
            recombination passes and halves output bandwidth, which
            dominate the device program at serving depth.  Convergence
            diagnostics (residual, rhs_norm) always stay in ``dtype``.
        cheb_degree: Degree of the Chebyshev-Jacobi polynomial
            preconditioner used by the CG path (1 = plain Jacobi).  Each
            preconditioner application runs this many dot-free matvecs,
            cutting the outer iteration count ~degree× and amortizing
            CG's sequential per-iteration overhead on TPU.
        cg_precond: CG preconditioner choice — ``"auto"`` (aggregation
            multigrid on large lattice-like multiplier graphs, Chebyshev
            otherwise), ``"mg"`` (force multigrid; raises if the topology
            does not qualify), ``"chebyshev"``, or ``"jacobi"``.
        mg_overcorrect: Coarse-grid correction scaling of the aggregation
            multigrid V-cycle.  Piecewise-constant (plain-aggregation)
            Galerkin coarse operators are systematically too stiff on
            Poisson-like problems, making the plain correction too weak;
            the standard remedy is to over-relax it.  The default 1.8 was
            tuned on capillary-mesh lattices (grid-independent ~13–16 PCG
            iterations at 128²–512²; see ``tests/test_krylov.py``) and
            keeps the preconditioner symmetric.  1.0 disables it.
        level_scan: ``"on"`` runs the blocked forest λ elimination's
            SHALLOW levels (the launch-bound tail: levels 0..t with ≤ 1024
            multipliers each, ~1–2k elements total) as three ``lax.scan``
            loops over a padded uniform layout instead of per-level
            unrolled kernels — fewer, fatter device launches at the cost
            of touching the pad width every step.  Numerically identical
            (pinned by tests); ``"off"`` (default) keeps the unrolled
            program.  A perf experiment toggle: flip after profiling on
            the target chip.
    """

    method: str = "auto"
    schur_method: str = "auto"
    rtol: float = 1e-12
    atol: float = 0.0
    maxiter: int | None = None
    cheb_degree: int = 8
    cg_precond: str = "auto"
    mg_overcorrect: float = 1.8
    error_if_not_converged: bool = True
    monitor: bool = False
    dtype: str = "float64"
    output_dtype: str = "same"
    level_scan: str = "off"

    def __post_init__(self) -> None:
        # Validate eagerly: several of these only steer rarely-traced
        # branches (e.g. cg_precond is consulted only when the CG fallback
        # is reached), so a typo would otherwise be silently accepted.
        _check(self.method, "method", ("auto", "schur", "schur_p", "dense", "minres", "host_lu"))
        _check(
            self.schur_method,
            "schur_method",
            ("auto", "tree", "tree_dist", "dense", "dense_f64", "cg", "dct"),
        )
        _check(self.cg_precond, "cg_precond", ("auto", "mg", "chebyshev", "jacobi"))
        _check(self.dtype, "dtype", ("float64", "float32"))
        _check(self.output_dtype, "output_dtype", ("same", "float64", "float32"))
        _check(self.level_scan, "level_scan", ("off", "on"))
        if self.cheb_degree < 1:
            raise ValueError(f"cheb_degree must be >= 1, got {self.cheb_degree}")
        if self.mg_overcorrect <= 0:
            raise ValueError(
                f"mg_overcorrect must be positive, got {self.mg_overcorrect}"
            )

    @classmethod
    def from_dict(cls, options: dict[str, Any] | None) -> "SolverOptions":
        if options is None:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in options.items() if k in fields})


def _check(value: str, name: str, allowed: tuple[str, ...]) -> None:
    if value not in allowed:
        raise ValueError(
            f"unknown SolverOptions.{name} {value!r}; expected one of {allowed}"
        )


@dataclasses.dataclass
class ShardingOptions:
    """Options for edge-partitioned multi-device execution.

    The TPU-native analog of the reference's MPI domain decomposition
    (``mesh.create_cell_partitioner(GhostMode.shared_facet)``, reference
    ``mesh.py:331-341``): edges are partitioned across the device mesh and the
    shared bifurcation (multiplier) rows are reduced with ``psum`` over ICI
    instead of ghost updates.

    Attributes:
        axis_name: Mesh axis name used by ``shard_map`` collectives.
        devices: Explicit device list (None = all available devices).
    """

    axis_name: str = "edges"
    devices: Any = None
