"""Hand-written CUDA kernels of the port.

Each module holds one kernel's wrapper beside its plain PyTorch version.
The blocked forest solve (uniformly-K-ary forests):

* :mod:`.condense` — K1, per-edge static condensation, every shard of a
  device in one launch (a :class:`.condense.Batch` a plan or group);
* :mod:`.tree_sweep` — K2 + K3 + K4, the level sweep (fold and back-substitution),
  three launches cut by the device plan's :class:`..blocked.SweepPlan`;
* :mod:`.expand` — K5, λ to the solution blocks.

The general forest solve (any forest, any coefficient mode):

* :mod:`.edge_data` — K8a, element formation and condensation in four layouts;
* :mod:`.segsum` — K6, exact sorted-segment sums, a route's sums in one
  launch through a :class:`.segsum.SumPlan`;
* :mod:`.level_eliminate` — K7, the level-ordered elimination (through K6):
  each run of levels no wider than 128 walked by one block in one launch
  each way, a wider level one grid launch each way (:class:`.level_eliminate.LevelWalk`);
* :mod:`.backsub` — K8b, λ to the solution blocks.

The cyclic solve (peel rounds, then the cycle core), after K8a and before K8b:

* :mod:`.peel` — K9, the bifurcation system and the peel rounds
  (``lambda_system``, ``peel``);
* :mod:`.fold` — K10, the multi-level gather-fold sums, one launch a fold
  (``nxfx_fold`` in K6's source) through a :class:`.fold.FoldPlan`;
* :mod:`.dense_core` — K11, the dense core or dense tail (a tiled
  multi-block factor, up to 8,192 nodes);
* :mod:`.core_elim` — K12a, the min-degree rounds of a sparse core plan, two
  launches a solve on its packed :class:`..ops.core_elim.RoundTable`, the folds
  inside (a factor's one and an apply's two under factor reuse);
* :mod:`.core_fronts` — K12b, its supernodal fronts;
* :mod:`.mf_factor` — K13 + K14, the multifrontal factor;
* :mod:`.mf_apply` — K15, the multifrontal apply with its refinement.

The uniform-lattice solve (the separable-DCT λ solve on its two routes):

* :mod:`.dct_lattice` — K16, the DCT capacitance solve with its refinement;
* :mod:`.grid_core` — K17, the grid route's assembly, stencil and norms
  (between K1 and K5);
* :mod:`.shift_matvec` — K18, the general route's shift-class matvec (with
  K8a, K9's ``lambda_system``, K6 and K8b), one launch a call on a
  :class:`.shift_matvec.ShiftPlan`.

The iterative λ solve (CG, after K8a, K9's ``lambda_system`` and K6, before
K8b; its matvec on K18 or K19b):

* :mod:`.krylov` — K19a, the CG steps (3 fused launches an iteration with
  the :class:`.krylov.Jacobi` preconditioner, on a :class:`.krylov.CgSteps`
  packed once a solve), the Chebyshev start, Jacobi;
* :mod:`.gather_matvec` — K19b, the gather-fold matvec of graphs without a
  shift plan on a :class:`.gather_matvec.GatherPlan` checked once and a
  solve's value table, with its Chebyshev step and a whole Chebyshev
  application from one host call (:class:`.gather_matvec.ChebApply`);
* :mod:`.mg2d` — K19c, the 2-D aggregation V-cycle's pieces, its fused
  launch path (:class:`.mg2d.Cycle`) and the coarsest dense solve;
* :mod:`.mg1d` — K19d, the 1-D pairing V-cycle: its hierarchy, and its
  smoothed levels as one fused :class:`.mg1d.Cycle` (6 launches a level,
  3 host calls a cycle).

The assembled-matrix and continuous-pressure routes:

* :mod:`.csr` — K20, the CSR duplicate fold of explicit assembly, and
  K20b, the CSR matvec with the diagonal and Jacobi row reductions;
* :mod:`.schur_p` — K21a, the per-edge flux blocks' band Cholesky factor
  and solves of the continuous-pressure reduced solve, over the flux-ordered
  tiles of a :class:`.schur_p.FluxTiles` plan;
* :mod:`.dense_lu` — K21b, the float64 LU with partial pivoting (blocked,
  in the unblocked loop's order: a cluster panel factor with lookahead),
  its solve and the tiled triangular solves;
* :mod:`.krylov` also holds K19e, the MINRES steps (one launch an
  iteration with Jacobi up to 8,192 unknowns, :class:`.krylov.MinresSteps`).

The sharded solves (:mod:`..parallel`), per shard and across the shards:

* :mod:`.shard_top` — K22-reduce, the shards' partials summed in shard
  order (also placed as strip windows, and the finiteness min), and the T
  solve of the top forest;
* :mod:`.shard_blocked` — K22a, the blocked shard's T partials and λ around
  its K1, K2–K4 (split at level 0: ``tree_sweep_forward``/``_backward``) and K5;
* :mod:`.shard_grid` — K22b, the lattice strips' windows and stub groups
  (every strip of a device in one launch), and the replicated per-edge
  conductances, around K1, K16, K17 and K5;
* :mod:`.dist_tree` — K22c, the distributed tree shards' folds and level
  walks around K8a and K8b, every shard of a device in one launch each;
* :mod:`.shard_general` — K22d, the general shard's λ-system partials and
  its part of the CG matvec, on the kernels of K9, K6 and K19b.

Factor reuse (:mod:`..factorization`) splits six of them into a factor
and an apply: K2 from K3–K4 (``tree_sweep_factor``, ``tree_sweep_apply``),
K9's channels (``peel_factor``, ``peel_apply``, after the bifurcation
system of ``bifurcation_system``), K11's solve on a stored factor
(``dense_gate``, ``dense_solve``), K16's passes on a stored factor
(``dct_factor``, ``dct_apply``), K12a's rounds (``core_factor``,
``core_apply``) and K12b's fronts (``core_fronts_factor``,
``core_fronts_apply``): the ``FACTORED`` wrappers.

A sweep (:mod:`..batch`) gives the blocked route a scenario axis: K1
(``condense_scenarios``), K2–K4 (``tree_sweep_scenarios``, the full sweep
of S resistance rows; ``tree_sweep_apply_scenarios``, S right-hand sides on
one stored factor) and K5 (``expand_scenarios``) take S scenarios in the
launches of one solve; so do the dense route's kernels: K8a
(``edge_data_scenarios``), the bifurcation system (K9's
``bifurcation_system_scenarios`` on K6's ``segsum_plan_scenarios``, which
also sums the pair conductances), K11 (``dense_factor_scenarios``,
``dense_gate_scenarios``, ``dense_solve_scenarios`` on S factors or on one)
and K8b (``backsub_scenarios``); and so do the lattice route's: K16's
factors and passes (``dct_factor_scenarios``, ``dct_apply_scenarios`` on S
factors or on one), K17's assembly and stencil (``grid_core_scenarios``,
``grid_residual_scenarios``) and K18 (``shift_matvec_scenarios``); the level
route's K7 (``level_eliminate_scenarios``), and the tree route's K9 rounds
(``peel_scenarios``, both channels; ``peel_apply_scenarios``, S right-hand
sides on one stored factor), K10 (``fold_apply_scenarios``, the
multifrontal refinement's folds) and K13–K15 (``mf_factor_scenarios``,
``mf_apply_scenarios`` on S factors or on one): the ``SCENARIO`` wrappers.

The blocked route's adjoint (:mod:`..adjoint`) transposes K1 and K5 by
hand: ``expand_vjp`` (K5ᵀ, a thread an edge), ``expand_vjp_fold`` (its
endpoint cotangents gathered into the bifurcations) and ``condense_vjp``
(K1ᵀ back to R, f and the boundary data); the adjoint λ solve runs K3–K4's
apply on K2's stored factor (``tree_sweep.tree_sweep_solve``): the
``ADJOINT`` wrappers.

A wrapper launches its kernel for CUDA tensors (building the library from
``csrc/`` at first use, see :mod:`.build`) and runs the plain version for
CPU tensors.  Each wrapper counts its launches in a plain integer attribute
``launches``; a kernel with several wrappers counts them in one
:class:`.build.Counter` named like it.
"""

from . import (
    backsub, condense, core_elim, core_fronts, csr, dct_lattice, dense_core, dense_lu, edge_data,
    dist_tree, expand, fold, gather_matvec, grid_core, krylov, level_eliminate, mf_apply, mf_factor,
    mg1d, mg2d, peel, schur_p, segsum, shard_blocked, shard_general, shard_grid, shard_top,
    shift_matvec, tree_sweep,
)

__all__ = [
    "backsub", "condense", "core_elim", "core_fronts", "csr", "dct_lattice", "dense_core", "dense_lu",
    "edge_data", "expand", "fold", "gather_matvec", "grid_core", "krylov", "level_eliminate",
    "mf_apply", "mf_factor", "mg1d", "mg2d", "peel", "schur_p", "segsum", "shift_matvec",
    "tree_sweep", "dist_tree", "shard_blocked", "shard_general", "shard_grid", "shard_top",
    "WRAPPERS", "BLOCKED", "GENERAL", "CYCLIC", "LATTICE", "ITERATIVE", "ASSEMBLED", "SHARDED",
    "FACTORED", "SCENARIO", "ADJOINT",
    "reset_launches", "launches",
]

BLOCKED = (condense.condense, tree_sweep.tree_sweep, expand.expand)
GENERAL = (segsum.LAUNCHES, edge_data.edge_data, level_eliminate.LAUNCHES, backsub.backsub)
CYCLIC = (
    fold.fold_apply, peel.lambda_system, peel.peel, dense_core.dense_core,
    mf_factor.mf_factor, mf_apply.mf_apply, core_elim.core_elim, core_fronts.core_fronts,
)
LATTICE = (dct_lattice.dct_lattice, grid_core.grid_core, shift_matvec.shift_matvec)
ITERATIVE = (krylov.LAUNCHES, gather_matvec.LAUNCHES, mg2d.LAUNCHES, mg1d.LAUNCHES)
ASSEMBLED = (csr.FOLD, csr.SPMV, schur_p.FACTOR, schur_p.SOLVE, dense_lu.LAUNCHES, krylov.MINRES)
SHARDED = (shard_top.REDUCE, shard_top.T_SOLVE, shard_blocked.LAUNCHES, shard_grid.LAUNCHES,
           dist_tree.LAUNCHES, shard_general.LAUNCHES)
FACTORED = (tree_sweep.tree_sweep_factor, tree_sweep.tree_sweep_apply, peel.bifurcation_system,
            peel.peel_factor, peel.peel_apply, dense_core.dense_gate, dense_core.dense_solve,
            dct_lattice.dct_factor, dct_lattice.dct_apply, core_elim.core_factor,
            core_elim.core_apply, core_fronts.core_fronts_factor, core_fronts.core_fronts_apply)
SCENARIO = (condense.condense_scenarios, tree_sweep.tree_sweep_scenarios,
            tree_sweep.tree_sweep_apply_scenarios, expand.expand_scenarios,
            edge_data.edge_data_scenarios, peel.bifurcation_system_scenarios,
            segsum.segsum_plan_scenarios, dense_core.dense_factor_scenarios,
            dense_core.dense_gate_scenarios, dense_core.dense_solve_scenarios,
            backsub.backsub_scenarios, dct_lattice.dct_factor_scenarios,
            dct_lattice.dct_apply_scenarios, grid_core.grid_core_scenarios,
            grid_core.grid_residual_scenarios, shift_matvec.shift_matvec_scenarios,
            level_eliminate.level_eliminate_scenarios, peel.peel_scenarios,
            peel.peel_apply_scenarios, fold.fold_apply_scenarios, mf_factor.mf_factor_scenarios,
            mf_apply.mf_apply_scenarios)
ADJOINT = (condense.condense_vjp, expand.expand_vjp, expand.expand_vjp_fold)
WRAPPERS = (BLOCKED + GENERAL + CYCLIC + LATTICE + ITERATIVE + ASSEMBLED + SHARDED + FACTORED
            + SCENARIO + ADJOINT)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict[str, int]:
    """``{wrapper name: launches}``."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}
