"""Hand-written CUDA kernels of the port.

Each module holds one kernel's wrapper beside its plain PyTorch version.
The blocked forest solve (uniformly-K-ary forests):

* :mod:`.condense` — K1, per-edge static condensation;
* :mod:`.tree_sweep` — K2 + K3 + K4, the level sweep (fold and back-substitution);
* :mod:`.expand` — K5, λ to the solution blocks.

The general forest solve (any forest, any coefficient mode):

* :mod:`.edge_data` — K8a, element formation and condensation in four layouts;
* :mod:`.segsum` — K6, exact sorted-segment sums;
* :mod:`.level_eliminate` — K7, the level-ordered elimination (through K6);
* :mod:`.backsub` — K8b, λ to the solution blocks.

The cyclic solve (peel rounds, then the cycle core), after K8a and before K8b:

* :mod:`.peel` — K9, the bifurcation system and the peel rounds
  (``lambda_system``, ``peel``);
* :mod:`.fold` — K10, the multi-level gather-fold sums, on K6's kernel;
* :mod:`.dense_core` — K11, the dense core or dense tail (a tiled
  multi-block factor, up to 8,192 nodes);
* :mod:`.core_elim` — K12a, the min-degree rounds of a sparse core plan;
* :mod:`.core_fronts` — K12b, its supernodal fronts;
* :mod:`.mf_factor` — K13 + K14, the multifrontal factor;
* :mod:`.mf_apply` — K15, the multifrontal apply with its refinement.

The uniform-lattice solve (the separable-DCT λ solve on its two routes):

* :mod:`.dct_lattice` — K16, the DCT capacitance solve with its refinement;
* :mod:`.grid_core` — K17, the grid route's assembly, stencil and norms
  (between K1 and K5);
* :mod:`.shift_matvec` — K18, the general route's shift-class matvec (with
  K8a, K9's ``lambda_system``, K6 and K8b).

The iterative λ solve (CG, after K8a, K9's ``lambda_system`` and K6, before
K8b; its matvec on K18 or K19b):

* :mod:`.krylov` — K19a, the CG steps, the Chebyshev start, Jacobi;
* :mod:`.gather_matvec` — K19b, the gather-fold matvec of graphs without a
  shift plan, with its Chebyshev step;
* :mod:`.mg2d` — K19c, the 2-D aggregation V-cycle's pieces and the
  coarsest dense solve;
* :mod:`.mg1d` — K19d, the 1-D pairing V-cycle's hierarchy and transfers.

The assembled-matrix and continuous-pressure routes:

* :mod:`.csr` — K20, the CSR duplicate fold of explicit assembly, and
  K20b, the CSR matvec with the diagonal and Jacobi row reductions;
* :mod:`.schur_p` — K21a, the per-edge flux blocks' band Cholesky factor
  and solves of the continuous-pressure reduced solve;
* :mod:`.dense_lu` — K21b, the float64 LU with partial pivoting, its solve
  and the triangular solves;
* :mod:`.krylov` also holds K19e, the MINRES steps.

A wrapper launches its kernel for CUDA tensors (building the library from
``csrc/`` at first use, see :mod:`.build`) and runs the plain version for
CPU tensors.  Each wrapper counts its launches in a plain integer attribute
``launches``; a kernel with several wrappers counts them in one
:class:`.build.Counter` named like it.
"""

from . import (
    backsub, condense, core_elim, core_fronts, csr, dct_lattice, dense_core, dense_lu, edge_data,
    expand, fold, gather_matvec, grid_core, krylov, level_eliminate, mf_apply, mf_factor, mg1d,
    mg2d, peel, schur_p, segsum, shift_matvec, tree_sweep,
)

__all__ = [
    "backsub", "condense", "core_elim", "core_fronts", "csr", "dct_lattice", "dense_core", "dense_lu",
    "edge_data", "expand", "fold", "gather_matvec", "grid_core", "krylov", "level_eliminate",
    "mf_apply", "mf_factor", "mg1d", "mg2d", "peel", "schur_p", "segsum", "shift_matvec",
    "tree_sweep", "WRAPPERS", "BLOCKED", "GENERAL", "CYCLIC", "LATTICE", "ITERATIVE", "ASSEMBLED",
    "reset_launches", "launches",
]

BLOCKED = (condense.condense, tree_sweep.tree_sweep, expand.expand)
GENERAL = (segsum.segsum, edge_data.edge_data, level_eliminate.level_eliminate, backsub.backsub)
CYCLIC = (
    fold.fold_apply, peel.lambda_system, peel.peel, dense_core.dense_core,
    mf_factor.mf_factor, mf_apply.mf_apply, core_elim.core_elim, core_fronts.core_fronts,
)
LATTICE = (dct_lattice.dct_lattice, grid_core.grid_core, shift_matvec.shift_matvec)
ITERATIVE = (krylov.LAUNCHES, gather_matvec.gather_matvec, mg2d.LAUNCHES, mg1d.LAUNCHES)
ASSEMBLED = (csr.FOLD, csr.SPMV, schur_p.FACTOR, schur_p.SOLVE, dense_lu.LAUNCHES, krylov.MINRES)
WRAPPERS = BLOCKED + GENERAL + CYCLIC + LATTICE + ITERATIVE + ASSEMBLED


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict[str, int]:
    """``{wrapper name: launches}``."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}
