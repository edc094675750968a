"""Smoke run of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from ``networks_fenicsx_tpu_torch/kernels/csrc``,
checks each against its plain PyTorch version on the card, drives the main
paths through the public API, checks each solution and times it:

* the blocked forest Schur solve of the 16-generation arterial tree at
  N = 40 (5,341,102 dofs; kernels K1–K5);
* the general forest solve of the same tree with callable R and f
  (5,341,102 dofs) and of a 100,001-vessel irregular forest, the spanning
  tree of a 100,000-site Delaunay web, at N = 8 and flux degree 2
  (2,563,442 dofs; kernels K6–K8);
* the cyclic (peel-then-core) solve of the same web keeping 5 % of its
  other edges — a web with anastomoses: 18 peel rounds and a 52,571-node
  multifrontal core, 2,817,749 dofs — and of the perfusion bed
  ``make_vascular_bed(5, 96, 64)`` (67,476 dofs, a 6,206-node multifrontal
  core); kernels K6, K8 and K9–K15;
* the cyclic solve of the web at 1,000 sites (11 peel rounds, a 455-node
  dense core: K11);
* the separable-DCT λ solve of the reference benchmark's 512² capillary
  lattice ``make_grid(512, 512)`` (1,831,942 dofs) under
  ``schur_method="dct"`` and ``auto`` on the grid route (K1, K17, K16, K5),
  and with a callable source on the general DCT route (K8a, K9's
  bifurcation system, K6, K16 with K18, K8b); kernels K16–K18;
* the mid-size cycle cores: the reference's 2k-junction web (16,367 dofs,
  a 1,994-node core: 7 min-degree rounds and a 628-node dense tail; K12a
  with K10 and K11) and its 64² lattice under ``auto`` (28,294 dofs, a
  4,096-node dense core, K11), and the 128² per-edge-R lattice with the
  reference's nested-dissection plan and forced supernodal fronts (K12b;
  also the 40² lattice's fronts of 37 pivots), through the tree executor
  the reference's own tests force plans into, then K11 alone from 455 to
  8,192 nodes with its guards (an indefinite core all NaN, repeat calls
  bit for bit, its launches within budget);
* the iterative λ solve under ``schur_method="cg"``: the 512² lattice with
  per-edge R (1,831,942 dofs; conjugate gradients with the 2-D aggregation
  multigrid, K19a + K18 + K19c) and the 100k-site web (2,817,749 dofs;
  Chebyshev-Jacobi on the gather-fold matvec, K19a + K19b), then the
  3×2000 lattice's 1-D multigrid (K19d) and the 128² lattice under
  Chebyshev and Jacobi;
* the assembled-matrix routes: the 16-generation tree with P2/P1
  continuous pressure under ``schur_p`` (K20, K21a, K20b), the float64 LU
  (K21b), MINRES (K19e) and the dense Schur variants;
* the sharded solves on one card (``parallel.ShardedNetworkSolver`` with
  ``devices=["cuda:0"] * D``): the 16-generation tree over 8 shards
  (blocked: K1 of all shards in one launch, K2–K4 split at level 0, K22a,
  K22-reduce, the T solve, K5) and over 1, the 100,001-vessel forest over 8
  (``auto`` → tree_dist: K8a, K22c, K8b), the 512² lattice in 8 strips (K1
  and K22b's windows of all strips in one launch each, K16, K17, K5), the
  web over 4 (the general route's replicated peel + multifrontal solve:
  K8a, K22d, K9–K15, K8b) and the 64² lattice under CG over 8 (K22d's
  matvec part), each against the serial solve of the same assembler, every
  K22-reduce call bit for bit; K1 and K22b, one shard and batched, bit for
  bit against their plain versions, and the sharded tree's and lattice's
  λ, q and p by SHA-256 against the parent design's;
* factor reuse (``Solver.factorize()``, then rhs-only ``compute_forms`` +
  ``solve()`` against the fused solve): the headline tree, the 512²
  lattice, the 100k forest, the 100k web, web1000, web2k (K12a's factor
  and apply in one block with K11's factor and solve on the dense tail) and
  the 128² lattice on its forced fronts plan through
  ``build_tree_factorization`` (K12a's as a cooperative grid, K12b's factor
  and sweeps), each split entry against its plain version, the factor's
  and the apply's launches against the plans', and the fused λ_core of
  web2k and of the 128² fronts by SHA-256 against the design's before the
  split;
* the sweeps (``solve_sweep``): the headline tree's 16 per-edge R and 16
  p_bc scenarios on the blocked route's scenario axis (K1, K2–K4 and K5 in
  one solve's launches, counted by the profiler), rows 0, 7 and 15 against
  ``Solver.solve()`` bit for bit, the sweep against 16 ``compute_forms`` +
  ``solve()`` with ``.x`` timed apart, each scenario kernel against the
  one-scenario kernel a row and its plain version (S ∈ {1, 16}, k = 1 and
  2, every coefficient mode), a 32² lattice (now on the grid route's
  scenario axis) and a route that runs a sweep's rows (the 100k forest),
  the demo tree on the batched dense route beside
  its batched blocked route, and ``devices=["cuda:0"] * 2``;
* the dense route's scenario axis (``solve_sweep`` under ``auto`` for 0 <
  B ≤ 4,096): the 13-generation arterial tree at N = 10 (B = 4,095; 16 per-edge
  R scenarios in two chunks of K11 factors, 16 p_bc scenarios on one factor,
  against the batched blocked route at 1e-11·scale) and web2k (B = 1,994; R
  and p_bc), rows 0, 7 and 15 against ``Solver(schur_method="dense")`` bit
  for bit, the launches at S = 1 and 16 by the profiler, each dense scenario
  kernel (K8a, the bifurcation system, K6, K11's factor, gate and solve,
  K8b) against the one-scenario kernel a row and its plain version (n ∈ {31,
  455, 4,095}, S ∈ {1, 16}, k = 1 and 2, a row that trips the pivot gate, a
  sweep in chunks), and one edge without bifurcations on K8a and K8b over S;
* the lattice route's scenario axis (``solve_sweep`` on a uniform scalar-R
  lattice): the 512² lattice under ``auto`` on the grid route (16 scalar-R
  and 16 p_bc scenarios: K1, K17, K16's factors or one factor and its
  passes, K5 over S) and with a callable source on the general route (K8a,
  the system, K6, K16 with K18, K8b over S), rows 0, 7 and 15 against
  ``Solver(schur_method="dct")`` bit for bit, each sweep against the same
  sweep a row at a time and the R sweep against 16 ``compute_forms`` +
  ``solve()``, the launches at S = 1 and 16 by the profiler (25 on the grid
  route, 27 on the general one, at both), the 64² lattice (B = 4,096, the
  sweep's own DCT band), ``GridFactorization.solve_batch`` of 16 rows
  against ``solve()`` bit for bit, and K16's, K17's and K18's scenario
  kernels against the one-scenario kernels a row and their plain versions,
  timed beside their bounds and batched ``torch.matmul`` or a CSR
  ``torch.sparse.mm``, with K16 over S on two streams at once;
* the gradients through the blocked solve (``adjoint.BlockedSolve``):
  ``Σ q_T[0]²`` of the headline tree with respect to R, f and both boundary
  arrays (the forward's K1, K2's factor, K3–K4's apply and K5, the
  backward's K5ᵀ ``expand_vjp``, its fold ``expand_vjp_fold``, the adjoint
  apply and K1ᵀ ``condense_vjp``, counted), the no-grad outputs against
  the grad-mode outputs bit for bit, the gradient against autograd of the
  plain path and against a central difference, forward-with-grad and
  backward timed with device µs by kernel, each adjoint kernel against its
  plain version, and the demo tree's five most sensitive vessels through
  ``outputs="flat"`` against the CPU plain path's.

The lattice sets also hold K17 on two streams at once, on repeated calls
and in a replayed CUDA graph bit for bit, two K16 solves on two streams bit
for bit with the solves alone, and K16's product kernel on ragged shapes
against ``torch.matmul``.  The multifrontal sets hold the kernels'
assembled fronts (K14's extend-add through ``rel``) bit for bit against the
gather through ``lminv``.  Last, the Krylov steps' device launches an
iteration (K19a, K19e), the web's multifrontal factor and apply (K13–K15,
on the level schedule) and the others' launches a call or a solve (K1,
K22b among them) as their wrappers report them are held against
``torch.profiler``'s count.

Each kernel is held against its plain version on the card, timed per call
beside its bound (the bytes it must move over the memory rate or its
float64 operations over the peak rate, whichever is larger) and, where one
PyTorch call computes the same function, that call's time.

Run from the repository root::

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero, printing no result, without
one.  The last line of its output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the card's name and power limit, and the one
before that the per-kernel record.  Every phase raises on failure.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import torch

GENERATIONS = 16
N_CELLS = 40
DOFS = 5_341_102
TOL = 1e-12  # kernel vs plain and port vs plain, times max(1, max |plain|)
SWEEP_LAUNCHES = 3  # K2–K4 on the headline tree: subtree blocks, the top, subtree blocks (were 31)
EDGE_LAUNCHES = 1  # K8a a call: one launch of edge tiles
SHARD_BLOCKED_LAUNCHES = 2  # K22a a sharded-tree solve on one card: the partials, the λ (were 16)
SHARD_GRID_LAUNCHES = 2  # K22b a sharded-lattice solve on one card: the windows, the fill (were 17)
CONDENSE_LAUNCHES = 1  # K1 a sharded solve on one card, every shard in one launch (were 8)
CORE_LAUNCHES = 2  # K12a's own a core solve: the rounds forward, the rounds back (web2k: were 36 + 31 K10)
# K12a's own under factor reuse: a factor's one launch, an apply's forward and back
CORE_SPLIT_LAUNCHES = {"factor": 1, "apply": 2}
# SHA-256 of the fused λ_core (core_elim) on compare_core_kernels' inputs of web2k (set (f)) and
# the 128² forced fronts (set (i)) in the design before K12a's rounds were split into a factor and
# an apply (the factor buffer apart from the scratch)
CORE_LAMBDA_BEFORE = {"web2k": "7a5df519c3cb0c6dedd62644167f06d6e0aa1cd6f7e6e92ab4481db8b9956c6a",
                      "fronts128": "1b11f8bbefc02f6b3c7e4b3645a58dd7b1e8c6e6f4569e81590fadb226e9afd4"}
# K9's a solve (tree.cuda_launches' peel term): the 100k web's 4 rounds of >= 1,024 nodes a grid
# launch each way and its 14 narrower in one block each way; web1000's 11 in one block each way
# (were 4 a round and the core's gather and scatter: 74 and 46)
PEEL_LAUNCHES = {"web": 10, "web1000": 2}
STAR_LEAVES = 100  # the star's leaves peeled into its hub in one round: a fold of two levels
REPS = 20  # timed launches per kernel
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP64_FLOPS = 34e12  # H100 SXM float64 peak outside the tensor cores: element-wise, matvec work
FP64_MATRIX_FLOPS = 67e12  # H100 SXM float64 tensor-core (DMMA) peak: matrix products, factors

FOREST_SITES = 100_000  # make_random_network(FOREST_SITES, keep=0.0, seed=7)
FOREST_N = 8
FOREST_K = 2
FOREST_SIZES = {"edges": 100_001, "bifurcations": 63_417, "levels": 1_240, "dofs": 2_563_442}

WEB_KEEP = 0.05  # make_random_network(FOREST_SITES, keep=WEB_KEEP, seed=7): a web with loops
WEB_SIZES = {"edges": 109_873, "bifurcations": 70_924, "rounds": 18, "core": 52_571,
             "groups": 94, "dofs": 2_817_749}
BED_SIZES = {"edges": 12_254, "bifurcations": 6_206, "rounds": 0, "core": 6_206,
             "dofs": 67_476}
CYCLIC_TOL = 1e-10  # refined core solves (K11, K15) and the cyclic paths, times the scale
WEB1000_SIZES = {"edges": 1_100, "bifurcations": 706, "rounds": 11, "core": 455, "groups": None,
                 "dofs": 28_206}  # make_random_network(1000, keep=WEB_KEEP, seed=7): a dense core

LATTICE_N = 512  # make_grid(512, 512): the reference benchmark's lattice stage (bench.py:597-657)
LATTICE_SIZES = {"edges": 523_266, "bifurcations": 262_144, "dofs": 1_831_942}
LATTICE_TOL = 1e-10  # refined lattice solves and the lattice paths, times the scale

WEB2K_SIZES = {"edges": 4_791, "bifurcations": 1_994, "rounds": 0, "core": 1_994,
               "core_rounds": 7, "dense_tail": 628, "fronts": 0, "dofs": 16_367}
LATTICE64_SIZES = {"edges": 8_066, "bifurcations": 4_096, "rounds": 0, "core": 4_096,
                   "core_rounds": None, "dofs": 28_294}
BED4_SIZES = {"core": 670, "core_rounds": 1, "dense_tail": 360, "fronts": 0}
GRID128_ND_SIZES = {"core": 16_384, "core_rounds": 5, "dense_tail": 7_583, "fronts": 0}
GRID128_FRONTS_SIZES = {"core": 16_384, "core_rounds": 28, "dense_tail": 0,
                        "fronts": ((1024, 216), (942, 0))}
# the reference's nested-dissection plan of a large core (solver.py:1789-1801)
ND_KWARGS = dict(dense_cutoff=8192, kcap=64, tail_stop=True, dense_cap=8192, supernodal_tail=True)
# the same order with a forced supernodal tail (fronts of at most 1,024 pivots)
FRONTS_KWARGS = dict(kcap=64, tail_stop=False, dense_cap=16, supernodal_tail=True, front_max=1024)
# the reference's forced fronts of 37 pivots on a 40² lattice (test_core_elim.py:346)
FRONTS_40_KWARGS = dict(dense_cutoff=64, kcap=24, dense_cap=16, supernodal_tail=True, front_max=37,
                        tail_stop=False)
K11_SIZES = (455, 628, 2_048, 4_096, 8_192)  # K11 alone, set (j)
K11_TIMED = 4_096  # the kernels line's K11 shape: the 64² lattice's dense core
EPS = float(np.finfo(np.float64).eps)

# the iterative λ solve: the 512² lattice with per-edge R under schur_method="cg"
# (tests/test_krylov.py:214-223 at 512²) takes the 2-D multigrid (B > 32,768)
CG512_SIZES = {"edges": 523_266, "bifurcations": 262_144, "dofs": 1_831_942,
               "precond": "2d", "levels": 5, "bottom": (16, 16)}
CG512_MAX_ITERS = 20  # the reference's own bound (tests/test_krylov.py:240-245)
CG512_ITERS = 17  # the kernel path's iterations (and the plain path's)
# the 512² V-cycle before its fused launch path (PERF.md §6: wrapper ms, chip_smoke.py on an
# H100 80GB HBM3 at 700 W), and its wrapper launches: 8 K19c and 2 K19a a smoothed level, 1 coarsest
VCYCLE_BEFORE = {"ms": 1.5350, "mg2d_launches": 41, "krylov_launches": 10}
# the 3×2000 1-D V-cycle before its fused launch path (PERF.md §6: CUDA events,
# profile_torch_main_path.py --select mg1d on an H100 80GB HBM3 at 700 W), and its wrapper
# launches: 2 K19d, 6 K18 and 2 K19a a smoothed level, 1 coarsest
MG1D_BEFORE = {"ms": 1.0026, "mg1d_launches": 8, "shift_matvec_launches": 24, "krylov_launches": 8}
# a degree-8 Chebyshev application on the gather-fold operator before its one-call form
# (K19a's start, then 7 K19b steps, each from its own Python call)
CHEB_BEFORE = {"host_calls": 8, "k19b_launches": 7, "krylov_launches": 1}
WEB_CG_SIZES = {"edges": 109_873, "bifurcations": 70_924, "dofs": 2_817_749,
                "precond": "chebyshev"}
SKINNY_SIZES = {"bifurcations": 6_000, "precond": "1d", "levels": 4, "bottom": 375}
CG_TOL = 1e-9  # whole CG solves, kernel path vs plain path, times the scale (the reference's bar)

# continuous pressure: the 16-generation tree at N = 40 with the stable P2/P1 pairing
P1TREE_SIZES = {"edges": 65_535, "bifurcations": 32_767, "dofs": 7_962_503, "flux": 5_308_335,
                "reduced": 2_654_168, "J_raw": 15_826_701, "J_nnz": 13_270_836}
CSR_SIZES = {"raw": 55_246_002, "nnz": 47_578_407, "max_dup": 2}  # its whole assembled matrix
SCHUR_P_TOL = 1e-9  # whole schur_p solves, kernel path vs plain path, times the scale
LU_N = 4_096  # K21b alone, set (q)
DENSE_DOFS = 8_033  # method="dense": make_arterial_tree(8), N = 10, k = 2, kp = 1
MINRES_DOFS = 2_422  # method="minres": make_arterial_tree(8), N = 4, k = 1
MINRES_TOL = 1e-7  # MINRES against host_lu, times the scale (tests/test_solver.py:91)
# the Krylov steps before their fused launches (PERF.md §5-§6: the profiler's device launches per
# solve on an H100 80GB HBM3 at 700 W): p1tree's krylov.cu, 8 an iteration; minres's K19e, 6 an
# iteration besides the Jacobi apply
P1TREE_KRYLOV_BEFORE = {"device_launches": 24_197, "an_iteration": 8, "iterations": 3_022}
MINRES_BEFORE = {"device_launches": 23_404, "an_iteration": 6, "iterations": 3_898}

KERNEL_RECORD = {
    "condense": ("networks_fenicsx_tpu_torch/kernels/csrc/condense.cu",
                 "networks_fenicsx_tpu/solver.py:2776"),
    "tree_sweep": ("networks_fenicsx_tpu_torch/kernels/csrc/tree_sweep.cu",
                   "networks_fenicsx_tpu/solver.py:2420"),
    "expand": ("networks_fenicsx_tpu_torch/kernels/csrc/expand.cu",
               "networks_fenicsx_tpu/solver.py:2743"),
    "segsum": ("networks_fenicsx_tpu_torch/kernels/csrc/segsum.cu",
               "networks_fenicsx_tpu/solver.py:2058"),
    "edge_data": ("networks_fenicsx_tpu_torch/kernels/csrc/edge_data.cu",
                  "networks_fenicsx_tpu/solver.py:569"),
    "level_eliminate": ("networks_fenicsx_tpu_torch/kernels/csrc/level_eliminate.cu",
                        "networks_fenicsx_tpu/solver.py:2131"),
    "backsub": ("networks_fenicsx_tpu_torch/kernels/csrc/backsub.cu",
                "networks_fenicsx_tpu/solver.py:4418"),
    "lambda_system": ("networks_fenicsx_tpu_torch/kernels/csrc/peel.cu",
                      "networks_fenicsx_tpu/solver.py:700"),
    "fold_apply": ("networks_fenicsx_tpu_torch/kernels/csrc/segsum.cu",
                   "networks_fenicsx_tpu/ops/core_elim.py:394"),
    "peel": ("networks_fenicsx_tpu_torch/kernels/csrc/peel.cu",
             "networks_fenicsx_tpu/solver.py:3678"),
    "dense_core": ("networks_fenicsx_tpu_torch/kernels/csrc/dense_core.cu",
                   "networks_fenicsx_tpu/ops/mixed_precision.py:34"),
    "mf_factor": ("networks_fenicsx_tpu_torch/kernels/csrc/mf_factor.cu",
                  "networks_fenicsx_tpu/ops/multifrontal.py:679"),
    "mf_apply": ("networks_fenicsx_tpu_torch/kernels/csrc/mf_apply.cu",
                 "networks_fenicsx_tpu/ops/multifrontal.py:744"),
    "dct_lattice": ("networks_fenicsx_tpu_torch/kernels/csrc/dct_lattice.cu",
                    "networks_fenicsx_tpu/solver.py:941"),
    "grid_core": ("networks_fenicsx_tpu_torch/kernels/csrc/grid_core.cu",
                  "networks_fenicsx_tpu/solver.py:1184"),
    "shift_matvec": ("networks_fenicsx_tpu_torch/kernels/csrc/shift_matvec.cu",
                     "networks_fenicsx_tpu/solver.py:806"),
    "core_elim": ("networks_fenicsx_tpu_torch/kernels/csrc/core_elim.cu",
                  "networks_fenicsx_tpu/ops/core_elim.py:879"),
    "core_fronts": ("networks_fenicsx_tpu_torch/kernels/csrc/core_fronts.cu",
                    "networks_fenicsx_tpu/ops/core_elim.py:934"),
    "krylov": ("networks_fenicsx_tpu_torch/kernels/csrc/krylov.cu",
               "networks_fenicsx_tpu/ops/krylov.py:78"),
    "gather_matvec": ("networks_fenicsx_tpu_torch/kernels/csrc/gather_matvec.cu",
                      "networks_fenicsx_tpu/solver.py:1561"),
    "mg2d": ("networks_fenicsx_tpu_torch/kernels/csrc/mg2d.cu",
             "networks_fenicsx_tpu/solver.py:1315"),
    "mg1d": ("networks_fenicsx_tpu_torch/kernels/csrc/mg1d.cu",
             "networks_fenicsx_tpu/solver.py:1482"),
    "csr_fold": ("networks_fenicsx_tpu_torch/kernels/csrc/csr.cu",
                 "networks_fenicsx_tpu/ops/csr_assembly.py:76"),
    "csr_spmv": ("networks_fenicsx_tpu_torch/kernels/csrc/csr.cu",
                 "networks_fenicsx_tpu/ops/sparse.py:40"),
    "schur_p_factor": ("networks_fenicsx_tpu_torch/kernels/csrc/schur_p.cu",
                       "networks_fenicsx_tpu/solver.py:4670"),
    "schur_p_solve": ("networks_fenicsx_tpu_torch/kernels/csrc/schur_p.cu",
                      "networks_fenicsx_tpu/solver.py:4682"),
    "dense_lu": ("networks_fenicsx_tpu_torch/kernels/csrc/dense_lu.cu",
                 "networks_fenicsx_tpu/solver.py:4763"),
    "minres": ("networks_fenicsx_tpu_torch/kernels/csrc/krylov.cu",
               "networks_fenicsx_tpu/ops/krylov.py:120"),
    "shard_reduce": ("networks_fenicsx_tpu_torch/kernels/csrc/shard_top.cu",
                     "networks_fenicsx_tpu/parallel/blocked_sharded.py:358"),
    "t_solve": ("networks_fenicsx_tpu_torch/kernels/csrc/shard_top.cu",
                "networks_fenicsx_tpu/parallel/blocked_sharded.py:361"),
    "shard_blocked": ("networks_fenicsx_tpu_torch/kernels/csrc/shard_blocked.cu",
                      "networks_fenicsx_tpu/parallel/blocked_sharded.py:304"),
    "shard_grid": ("networks_fenicsx_tpu_torch/kernels/csrc/shard_grid.cu",
                   "networks_fenicsx_tpu/parallel/grid_sharded.py:247"),
    "dist_tree": ("networks_fenicsx_tpu_torch/kernels/csrc/dist_tree.cu",
                  "networks_fenicsx_tpu/parallel/distributed_tree.py:396"),
    "shard_general": ("networks_fenicsx_tpu_torch/kernels/shard_general.py",
                      "networks_fenicsx_tpu/parallel/sharding.py:248"),
    # factor reuse: the split kernels' factor and apply entries
    "tree_sweep_factor": ("networks_fenicsx_tpu_torch/kernels/csrc/tree_sweep.cu",
                          "networks_fenicsx_tpu/solver.py:2420"),
    "tree_sweep_apply": ("networks_fenicsx_tpu_torch/kernels/csrc/tree_sweep.cu",
                         "networks_fenicsx_tpu/solver.py:2453"),
    "bifurcation_system": ("networks_fenicsx_tpu_torch/kernels/csrc/peel.cu",
                           "networks_fenicsx_tpu/solver.py:3509"),
    "peel_factor": ("networks_fenicsx_tpu_torch/kernels/csrc/peel.cu",
                    "networks_fenicsx_tpu/solver.py:3678"),
    "peel_apply": ("networks_fenicsx_tpu_torch/kernels/csrc/peel.cu",
                   "networks_fenicsx_tpu/solver.py:3747"),
    "dense_gate": ("networks_fenicsx_tpu_torch/kernels/csrc/dense_core.cu",
                   "networks_fenicsx_tpu/ops/mixed_precision.py:34"),
    "dense_solve": ("networks_fenicsx_tpu_torch/kernels/csrc/dense_core.cu",
                    "networks_fenicsx_tpu/ops/mixed_precision.py:49"),
    "dct_factor": ("networks_fenicsx_tpu_torch/kernels/csrc/dct_lattice.cu",
                   "networks_fenicsx_tpu/solver.py:941"),
    "dct_apply": ("networks_fenicsx_tpu_torch/kernels/csrc/dct_lattice.cu",
                  "networks_fenicsx_tpu/solver.py:1002"),
    "core_factor": ("networks_fenicsx_tpu_torch/kernels/csrc/core_elim.cu",
                    "networks_fenicsx_tpu/ops/core_elim.py:879"),
    "core_apply": ("networks_fenicsx_tpu_torch/kernels/csrc/core_elim.cu",
                   "networks_fenicsx_tpu/ops/core_elim.py:995"),
    "core_fronts_factor": ("networks_fenicsx_tpu_torch/kernels/csrc/core_fronts.cu",
                           "networks_fenicsx_tpu/ops/core_elim.py:934"),
    "core_fronts_apply": ("networks_fenicsx_tpu_torch/kernels/csrc/core_fronts.cu",
                          "networks_fenicsx_tpu/ops/core_elim.py:1016"),
    # sweeps: the blocked route's kernels over a scenario axis
    "condense_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/condense.cu",
                           "networks_fenicsx_tpu/solver.py:2776"),
    "tree_sweep_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/tree_sweep.cu",
                             "networks_fenicsx_tpu/solver.py:2420"),
    "tree_sweep_apply_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/tree_sweep.cu",
                                   "networks_fenicsx_tpu/solver.py:2453"),
    "expand_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/expand.cu",
                         "networks_fenicsx_tpu/solver.py:2743"),
    # sweeps: the dense route's kernels over a scenario axis
    "edge_data_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/edge_data.cu",
                            "networks_fenicsx_tpu/solver.py:569"),
    "bifurcation_system_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/peel.cu",
                                     "networks_fenicsx_tpu/solver.py:700"),
    "segsum_plan_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/segsum.cu",
                              "networks_fenicsx_tpu/solver.py:2058"),
    "dense_factor_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/dense_core.cu",
                               "networks_fenicsx_tpu/ops/mixed_precision.py:34"),
    "dense_gate_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/dense_core.cu",
                             "networks_fenicsx_tpu/ops/mixed_precision.py:34"),
    "dense_solve_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/dense_core.cu",
                              "networks_fenicsx_tpu/ops/mixed_precision.py:49"),
    "backsub_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/backsub.cu",
                          "networks_fenicsx_tpu/solver.py:4418"),
    # sweeps: the lattice route's kernels over a scenario axis
    "dct_factor_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/dct_lattice.cu",
                             "networks_fenicsx_tpu/solver.py:941"),
    "dct_apply_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/dct_lattice.cu",
                            "networks_fenicsx_tpu/solver.py:1002"),
    "grid_core_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/grid_core.cu",
                            "networks_fenicsx_tpu/solver.py:1184"),
    "grid_residual_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/grid_core.cu",
                                "networks_fenicsx_tpu/solver.py:1184"),
    "shift_matvec_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/shift_matvec.cu",
                               "networks_fenicsx_tpu/solver.py:806"),
    # sweeps: the level and tree routes' kernels over a scenario axis
    "level_eliminate_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/level_eliminate.cu",
                                  "networks_fenicsx_tpu/solver.py:2131"),
    "peel_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/peel.cu",
                       "networks_fenicsx_tpu/solver.py:3678"),
    "peel_apply_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/peel.cu",
                             "networks_fenicsx_tpu/solver.py:3747"),
    "fold_apply_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/segsum.cu",
                             "networks_fenicsx_tpu/ops/core_elim.py:394"),
    "mf_factor_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/mf_factor.cu",
                            "networks_fenicsx_tpu/ops/multifrontal.py:679"),
    "mf_apply_scenarios": ("networks_fenicsx_tpu_torch/kernels/csrc/mf_apply.cu",
                           "networks_fenicsx_tpu/ops/multifrontal.py:744"),
    # gradients: the blocked route's transposes of K1 and K5 (what jax.grad makes of them)
    "condense_vjp": ("networks_fenicsx_tpu_torch/kernels/csrc/condense.cu",
                     "networks_fenicsx_tpu/solver.py:2776"),
    "expand_vjp": ("networks_fenicsx_tpu_torch/kernels/csrc/expand.cu",
                   "networks_fenicsx_tpu/solver.py:2743"),
    "expand_vjp_fold": ("networks_fenicsx_tpu_torch/kernels/csrc/expand.cu",
                        "networks_fenicsx_tpu/solver.py:2743"),
}
# the factor-reuse wrappers: the configurations whose checks hold each, and the one timed
FACTOR_CHECKS = {
    "tree_sweep_factor": (("headline",), "headline"),
    "tree_sweep_apply": (("headline",), "headline"),
    "bifurcation_system": (("forest", "web", "web1000"), "web"),
    "peel_factor": (("forest", "web", "web1000"), "web"),
    "peel_apply": (("forest", "web", "web1000"), "web"),
    "dense_gate": (("web1000",), "web1000"),
    "dense_solve": (("web1000", "web1000:dense_solve_unrefined"), "web1000"),
    "dct_factor": (("lattice",), "lattice"),
    "dct_apply": (("lattice", "lattice:dct_apply_unrefined"), "lattice"),
    "core_factor": (("web2k", "fronts128"), "web2k"),
    "core_apply": (("web2k", "fronts128", "web2k:core_apply_whole", "fronts128:core_apply_whole"),
                   "web2k"),
    "core_fronts_factor": (("fronts128",), "fronts128"),
    "core_fronts_apply": (("fronts128",), "fronts128"),
}
# the checks of each iterative wrapper in the kernels-cg sets (k)-(m), and the
# set whose record times it
CG_CHECKS = {
    "krylov": ("k", ("krylov_cg_step", "krylov_cg_jacobi_step", "krylov_chebyshev")),
    "gather_matvec": ("k", ("gather_matvec", "gather_matvec_residual", "gather_cheb_apply")),
    "mg2d": ("l", ("mg2d_hierarchy", "mg2d_stencil", "mg2d_cheb_first", "mg2d_residual_restrict", "mg2d_prolong_residual",
                   "mg2d_coarse_factor", "mg2d_coarse_solve", "mg2d")),
    "mg1d": ("m", ("mg1d_hierarchy", "mg1d_cheb_first", "mg1d_residual_restrict",
                   "mg1d_prolong_residual", "mg1d_cycle", "mg1d")),
}
# the kernels-lattice sets: (a) 512², (b) 9×4 at k = 3, (c) 512² callable f (the
# general route), (d) 5000×3 and (d2) 3×4200 (a device-generated DCT matrix)
LATTICE_SETS = ("a", "b", "c", "d", "d2")
# the checks of each lattice wrapper in the kernels-lattice sets
LATTICE_CHECKS = {
    "dct_lattice": ("dct_factor", "dct_forward", "dct_inverse", "dct_lplus",
                    "dct_lattice_unrefined", "dct_lattice", "dct_matrix", "dct_product"),
    "grid_core": ("grid_core", "grid_core_stencil"),
    "shift_matvec": ("shift_matvec",),
}
# the checks of each assembled-matrix wrapper in the generic sets (o)-(r),
# and the set and check whose record times it
GENERIC_CHECKS = {
    "csr_fold": (("p", "csr_fold"),),
    "csr_spmv": (("o", "csr_spmv"), ("o", "csr_spmv_T"), ("o", "csr_tdiag")),
    "schur_p_factor": (("o", "schur_p_factor"),),
    "schur_p_solve": (("o", "schur_p_solve"),),
    "dense_lu": (("q", "dense_lu"), ("q", "dense_lu_saddle"), ("q", "dense_lu_trsv")),
    "minres": (("r", "minres"), ("r", "minres_jacobi")),
}
# the wrappers the cyclic executor may launch, besides the CYCLIC group
CYCLIC_SHARED = ("segsum", "edge_data", "backsub")


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def float_tensors(x) -> list:
    """The float64 tensors of a tensor or a (nested) tuple, in order."""
    if isinstance(x, torch.Tensor):
        return [x] if x.dtype == torch.float64 else []
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in float_tensors(item)]
    return []


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max(1, max |want|)) over matching float tensors."""
    err, scale = 0.0, 1.0
    got, want = float_tensors(got), float_tensors(want)
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        assert a.shape == b.shape, (a.shape, b.shape)
        if b.numel() == 0:
            continue
        err = max(err, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    return err, scale


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def panel_launches(fn) -> dict:
    """The tiled Cholesky's panel and trailing launches of one ``fn()`` call
    (``torch.profiler``, after one warm-up call): their count, device µs and
    longest panel; None ("not measured") where the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"panels": 0, "panel_us": 0.0, "panel_us_max": 0.0, "trailing": 0, "trailing_us": 0.0}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        if "tc_panel_kernel" in ev.name:
            out["panels"] += 1
            out["panel_us"] += us
            out["panel_us_max"] = max(out["panel_us_max"], us)
        elif "tc_trailing_kernel" in ev.name:
            out["trailing"] += 1
            out["trailing_us"] += us
    return out if out["panels"] else None


def tensor_bytes(*objs) -> int:
    """Bytes of the tensors in ``objs`` (tensors, or nested tuples/lists of them)."""
    total = 0
    for x in objs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += tensor_bytes(*x)
        elif hasattr(x, "levels"):  # a K10 FoldPlan
            total += tensor_bytes(*x.levels)
    return total


def plan_bytes(plan) -> int:
    """Bytes of the index tensors a device-plan dataclass holds."""
    return tensor_bytes(*(getattr(plan, f.name) for f in dataclasses.fields(plan)))


def valid_entries(idx: torch.Tensor, n: int) -> int:
    """Entries of a K6/K10 gather matrix that name a value (not the pad slot n)."""
    return int(((idx >= 0) & (idx < n)).sum())


def bound(nbytes: int, flops: float, matrix_flops: float = 0.0) -> dict:
    """The least time the card could take for the work: the bytes it must move
    (each input read once, each output written once) over the memory rate, or
    its float64 operations over the peak rate for their kind, whichever is
    larger.  ``matrix_flops`` (matrix products and dense factors, which the
    float64 tensor cores can run) count at 67 TFLOP/s, whatever the kernel
    uses; the other ``flops`` at 34 TFLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP64_FLOPS + matrix_flops / FP64_MATRIX_FLOPS) * 1e3
    return {"bytes": int(nbytes), "flops": float(flops), "matrix_flops": float(matrix_flops),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def arterial_assembler(P, gens: int, N: int, k: int = 1, per_cell: bool = False, seed: int = 0):
    """The benchmark configuration (Poiseuille R = 1/r⁴, p_bc = y), or with
    per-cell R and f from ``seed``."""
    net = P.network_generation.make_arterial_tree(gens, direction=[0.1, 1, 0], arrays=True)
    mesh = P.NetworkMesh(net, N=N, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=0)
    if per_cell:
        rng = np.random.default_rng(seed)
        R = np.repeat(1.0 / mesh.edge_radius**4, N) * rng.uniform(0.5, 2.0, mesh.num_cells)
        f = rng.uniform(-1.0, 1.0, mesh.num_cells)
        asm.compute_forms(p_bc_ex=lambda x: x[1], R=R, f=f)
    else:
        asm.compute_forms(p_bc_ex=lambda x: x[1], R=1.0 / mesh.edge_radius**4)
    return asm


def callable_forms(asm) -> None:
    """Spatially varying resistance and a distributed source (quad mode)."""
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=lambda x: 1 + 0.5 * x[1] ** 2,
                      f=lambda x: 0.1 * x[0])


def callable_assembler(P, gens: int = GENERATIONS, N: int = N_CELLS, k: int = 1):
    """The arterial tree with callable R and f (general layout)."""
    net = P.network_generation.make_arterial_tree(gens, direction=[0.1, 1, 0], arrays=True)
    mesh = P.NetworkMesh(net, N=N, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=0)
    callable_forms(asm)
    return asm


def forest_mesh(P, sites: int = FOREST_SITES, N: int = FOREST_N):
    """The irregular forest: spanning tree of a ``sites``-site Delaunay web."""
    net = P.network_generation.make_random_network(sites, keep=0.0, seed=7, arrays=True)
    return P.NetworkMesh(net, N=N, color_strategy="fast")


def forest_forms(asm, f_kind: str = "cell", R=None, f=None, s: float = 1.0) -> None:
    """Per-edge R and per-cell (or scalar) f from ``default_rng(0)``, p_bc = x
    (a sweep row: ``R``, ``f`` in their place, p_bc = s·x)."""
    mesh = asm.network
    rng = np.random.default_rng(0)
    R0 = rng.uniform(0.5, 2.0, mesh.num_edges)
    f0 = rng.uniform(-1.0, 1.0, mesh.num_cells) if f_kind == "cell" else 0.3
    asm.compute_forms(p_bc_ex=lambda x: s * x[0], R=R0 if R is None else R,
                      f=f0 if f is None else f)


def forest_assembler(P, mesh, k: int = FOREST_K, f_kind: str = "cell"):
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=0)
    forest_forms(asm, f_kind)
    return asm


def y_bifurcation(P, device) -> None:
    net = P.network_generation.make_tree(2, 1, 3, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=4))
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    sol = P.Solver(asm, device=device).solve()
    lam_exact = -1.0 / (np.sqrt(2.5) + 1.0)
    q_root = 2.0 / (np.sqrt(2.5) + 1.0)
    lam = sol[-1].values
    flux = P.post_processing.extract_global_flux(asm.network, sol).values
    assert abs(lam[0] - lam_exact) <= TOL, lam
    mesh = asm.network
    k1 = 2  # P1 cell dofs
    per_cell = flux.reshape(mesh.num_cells, k1)
    for e in range(mesh.num_edges):
        want = q_root if mesh.edges[e, 0] == 0 else q_root / 2
        got = per_cell[e * mesh.N : (e + 1) * mesh.N]
        assert np.all(np.abs(got - want) <= TOL), (e, got, want)
    log(f"phase y-bifurcation: lam {lam[0]:.15f} (exact {lam_exact:.15f}), "
        f"root flux {q_root:.15f}, branches half: ok")


def compare_kernels(P, asm, device, timed: bool) -> dict:
    """Each kernel against its plain version on the same inputs on the card."""
    from networks_fenicsx_tpu_torch.kernels import condense, expand, tree_sweep
    from networks_fenicsx_tpu_torch.solver import build_schur_executor

    ex = build_schur_executor(asm, P.SolverOptions(), device=device)
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    dp, plan = ex.device_plan, ex.device_plan.plan
    N, k, h = asm.network.N, asm.flux_degree, ex._h_e
    Rm, fm, _ = asm.coefficient_modes()

    c_args = (N, k, h, R, f, Rm, fm, sp, ep)
    c_plain = condense.condense_plain(plan, *c_args)
    W, w, g, Ftot, const = c_plain
    s_args = (w, const, Ftot)
    s_plain = tree_sweep.tree_sweep_plain(plan, *s_args)
    lam = s_plain[0]
    x_args = (N, k, lam, sp, ep, W, w, g, Ftot, h, R, f, Rm, fm)
    x_plain = expand.expand_plain(plan, *x_args)

    runs = {
        "condense": (lambda: condense.condense(dp, *c_args),
                     lambda: condense.condense_plain(plan, *c_args), c_plain),
        "tree_sweep": (lambda: tree_sweep.tree_sweep(dp, *s_args),
                       lambda: tree_sweep.tree_sweep_plain(plan, *s_args), s_plain),
        "expand": (lambda: expand.expand(dp, *x_args),
                   lambda: expand.expand_plain(plan, *x_args), x_plain),
    }
    E, B = dp.num_edges, dp.num_bifurcations
    ends = (dp.edge_src, dp.edge_tgt)
    cell = 1 if "cell" not in (Rm, fm) else N
    work = {
        "condense": (tensor_bytes(h, R, f, sp, ep, ends, c_plain), 12 * E * cell),
        "tree_sweep": (tensor_bytes(w, const, Ftot, dp.bif_in, dp.bif_out, dp.bif_parent,
                                    dp.sweep.levels, s_plain), 16 * B + 4 * dp.bif_out.numel()),
        "expand": (tensor_bytes(lam, sp, ep, W, w, g, Ftot, h, R, f, ends, x_plain),
                   10 * (k * N + 1) * E),
    }
    # K1's closed forms (no per-cell sum) are the plain version's bits
    exact = {"condense": "cell" not in (Rm, fm)}
    record = {}
    for name, (kernel, plain, want) in runs.items():
        got = kernel()
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        assert err <= TOL * scale, (name, err, scale)
        record[name] = {"max_abs_err": err, "scale": scale}
        if exact.get(name):
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (name, "not bit for bit")
            record[name]["equal"] = True
        if timed:
            record[name]["ms"] = cuda_ms(kernel)
            record[name]["plain_ms"] = cuda_ms(plain)
            record[name].update(bound(*work[name]))
    # K2–K4's three launches are the blocked plain version's order: λ, d, r,
    # wn and the norm bit for bit (λ, d, r, wn also the level-by-level plain's)
    got = tree_sweep.tree_sweep(dp, *s_args)
    blocked = tree_sweep.tree_sweep_blocked_plain(dp, *s_args)
    digests = [sha256(t) for t in got]
    assert digests == [sha256(t) for t in blocked], "tree_sweep: not the blocked plain version's bits"
    assert all(sha256(got[i]) == sha256(s_plain[i]) for i in (0, 2, 3, 4)), "tree_sweep vs plain"
    sw = dp.sweep
    record["_case"] = (dp, s_args)  # for the launch-count phase
    record["tree_sweep"].update({
        "bit_for_bit": True, "lambda_sha256": digests[0], "cuda_launches": tree_sweep.cuda_launches(dp),
        "sweep_plan": {"cut": sw.cut, "top_nodes": sw.top_nodes, "blocks": sw.blocks,
                       "block_nodes": sw.block_nodes}})
    return record


def sha256(*tensors) -> str:
    """SHA-256 of the tensors' float64 values, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float64).tobytes())
    return h.hexdigest()


def conservation(asm, x: np.ndarray) -> float:
    """max over bifurcations of |Σ q_in − Σ q_out| and max |q|."""
    mesh = asm.network
    base = asm._edge_flux_base
    q_start = x[base]
    q_end = x[base + asm._dofs_per_edge - 1]
    in_e, in_off = mesh.bif_in_csr
    out_e, out_off = mesh.bif_out_csr
    B = mesh.num_multipliers
    q_in = np.bincount(np.repeat(np.arange(B), np.diff(in_off)), q_end[in_e], minlength=B)
    q_out = np.bincount(np.repeat(np.arange(B), np.diff(out_off)), q_start[out_e], minlength=B)
    flux = x[: asm.block_offsets[mesh.num_edge_colors]]
    return float(np.abs(q_in - q_out).max()), float(np.abs(flux).max())


def main_path(P, device) -> dict:
    """The benchmark solve through the public API, counted and checked."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.solver import _flatten_blocks_host

    t0 = time.perf_counter()
    asm = arterial_assembler(P, GENERATIONS, N_CELLS)
    assert asm.num_dofs == DOFS, asm.num_dofs
    solver = P.Solver(asm, device=device)
    log(f"phase main-path: set-up {time.perf_counter() - t0:.3f} s, "
        f"{asm.network.num_edges} edges, {asm.network.num_multipliers} bifurcations, "
        f"{asm.num_dofs} dofs")

    kernels.reset_launches()
    sol = solver.solve()
    torch.cuda.synchronize()
    launches = kernels.launches()
    assert all(fn.launches >= 1 for fn in kernels.BLOCKED), launches
    assert all(fn.launches == 0 for fn in kernels.GENERAL + kernels.CYCLIC), launches

    info = solver.info
    x = solver.solution_vector()
    assert info.converged, info
    assert x.shape == (DOFS,) and np.all(np.isfinite(x))
    assert sum(fn.values.size for fn in sol) == DOFS
    imbalance, qmax = conservation(asm, x)
    assert imbalance <= 1e-10 * qmax, (imbalance, qmax)

    ex = solver._executor
    out = ex.plain(*ex.prepare_args(*asm.schur_arguments()))
    x_plain = _flatten_blocks_host(
        out[0].cpu().numpy(), out[1].cpu().numpy(), out[2].cpu().numpy(),
        asm.network.edge_color, edge_order=ex.edge_order, bif_order=ex.bif_order,
    )
    err = float(np.abs(x - x_plain).max())
    scale = max(1.0, float(np.abs(x_plain).max()))
    assert err <= TOL * scale, (err, scale)
    log(f"phase main-path: converged, finite, conservation {imbalance:.3e} "
        f"(max |q| {qmax:.3e}), vs plain path {err:.3e} (scale {scale:.3e}), "
        f"launches {launches}")
    return {"asm": asm, "solver": solver, "launches": launches}


def timing(P, state: dict, name_power: str) -> dict:
    """Host-clock compute_forms + solve, best of 5, CUDA-synchronised."""
    asm, solver = state["asm"], state["solver"]
    R = 1.0 / asm.network.edge_radius**4
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)
        solver.solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ex = solver._executor
    args = ex.prepare_args(*asm.schur_arguments())
    dev_ms = cuda_ms(lambda: ex(*args), reps=10)
    plain_ms = cuda_ms(lambda: ex.plain(*args), reps=10)
    from networks_fenicsx_tpu_torch.kernels import tree_sweep

    sweep = tree_sweep.cuda_launches(ex.device_plan)
    assert sweep == SWEEP_LAUNCHES, sweep
    log(f"phase timing: compute_forms+solve best {min(times):.3f} ms "
        f"(all {[round(t, 3) for t in times]}); device per solve (upload + kernels) "
        f"{dev_ms:.3f} ms, plain versions {plain_ms:.3f} ms; CUDA launches per solve "
        f"{2 + sweep} (K1, K2–K4 {sweep}, K5); card {name_power}")
    return {"best_ms": min(times), "device_ms": dev_ms, "plain_ms": plain_ms,
            "cuda_launches": 2 + sweep}


def compare_level_kernels(P, asm, device, timed: bool, keep_case: bool = False) -> dict:
    """Each general-forest kernel against its plain version on the inputs
    the level executor gives it, on the card (K8a bit for bit where its
    arithmetic is the plain version's: k = 1 and the scalar layouts);
    ``keep_case``: K8a's arguments under ``_edge_case``, for
    :func:`edge_shard_launch_counts`."""
    from networks_fenicsx_tpu_torch.kernels import backsub, edge_data, level_eliminate, segsum
    from networks_fenicsx_tpu_torch.kernels.level_eliminate import _prepare_plain
    from networks_fenicsx_tpu_torch.solver import _LevelExecutor, build_schur_executor

    ex = build_schur_executor(asm, P.SolverOptions(), device=device)
    assert isinstance(ex, _LevelExecutor), type(ex)
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    dlp, N, k = ex.device_plan, asm.network.N, asm.flux_degree
    Rm, fm, f_zero = asm.coefficient_modes()
    e_args = (dlp, N, k, ex._h_e, ex._quad_w, ex._quad_phi, R, f, Rm, fm, f_zero, sp, ep)
    ed = edge_data.edge_data_plain(*e_args)
    w, vt, vs = _prepare_plain(ed)
    lam, rhs_norm = level_eliminate.level_eliminate_plain(dlp, ed)

    def sums(fn):  # K6's one launch for the route's three sums
        return lambda: fn(dlp.sums, w, vt, vs)

    runs = {
        "edge_data": (lambda: edge_data.edge_data(*e_args),
                      lambda: edge_data.edge_data_plain(*e_args)),
        "segsum": (sums(segsum.segsum_plan), sums(segsum.segsum_plan_plain)),
        "level_eliminate": (lambda: level_eliminate.level_eliminate(dlp, ed),
                            lambda: level_eliminate.level_eliminate_plain(dlp, ed)),
        "backsub": (lambda: backsub.backsub(ed, lam, N, k),
                    lambda: backsub.backsub_plain(ed, lam, N, k)),
    }
    E, B, C, nq = dlp.num_edges, dlp.num_bifurcations, asm.network.num_cells, k + 1
    ed_arrays = [t for t in (ed.mt, ed.cumF, ed.W, ed.g, ed.rh, ed.ua, ed.uF) if t is not None]
    ed_arrays += list(ed.interior)
    sums_in = ((dlp.p_idx, w), (dlp.t_idx, vt), (dlp.s_idx, vs))
    q_T, p_T, _ = backsub.backsub_plain(ed, lam, N, k)
    work = {
        "edge_data": (tensor_bytes(ex._h_e, ex._quad_w, ex._quad_phi, R, f, sp, ep, dlp.start_bif,
                                   dlp.end_bif, ed_arrays),
                      (3 * nq * (k + 1) ** 2 + 2 * nq + 10) * C),
        "segsum": (sum(tensor_bytes(i, v) + i.shape[0] * v[0].numel() * 8 for i, v in sums_in),
                   sum(valid_entries(i, v.shape[0]) * v[0].numel() for i, v in sums_in)),
        "level_eliminate": (tensor_bytes(ed.W, ed.g, ed.cumF[-1], sp, ep, lam, rhs_norm)
                            + plan_bytes(dlp), 8 * E + 12 * B),
        "backsub": (tensor_bytes(lam, ed_arrays, sp, ep, dlp.start_bif, dlp.end_bif, q_T, p_T),
                    10 * (k * N + 1) * E),
    }
    # K6's yardstick: index_add_ of the same gathered values into the same segments
    adds = []
    for i, v in sums_in:
        ok = (i >= 0) & (i < v.shape[0])
        seg = torch.arange(i.shape[0], device=i.device)[:, None].expand_as(i)[ok]
        adds.append((torch.zeros((i.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype,
                                 device=v.device), seg, v[i[ok].long()]))
    library = {"segsum": lambda: [out.index_add_(0, seg, src) for out, seg, src in adds]}
    record = {"layout": ex.layout, "levels": dlp.num_levels}
    # K8a's arithmetic is the plain version's but for the library Cholesky of k >= 2
    exact = {"edge_data": k == 1 or ex.layout != "general"}
    for name, (kernel, plain) in runs.items():
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        assert err <= TOL * scale, (name, err, scale)
        record[name] = {"max_abs_err": err, "scale": scale}
        if exact.get(name):
            assert all(torch.equal(a, b) for a, b in zip(float_tensors(got), float_tensors(want))), name
            record[name]["equal"] = True
        if timed:
            record[name]["ms"] = cuda_ms(kernel)
            record[name]["plain_ms"] = cuda_ms(plain, reps=5)
            record[name].update(bound(*work[name]))
            if name in library:
                record[name]["library_ms"] = cuda_ms(library[name])
    before = segsum.LAUNCHES.launches
    got = sums(segsum.segsum_plan)()
    assert segsum.LAUNCHES.launches == before + 1, "K6: one launch a plan"
    assert all(torch.equal(a, b) for a, b in zip(got, sums(segsum.segsum_plan_plain)())), "K6 bits"
    record["segsum"]["equal"] = True
    # K7's walks and grid levels against the plain version in the walk's
    # grouping (the norm in the kernel's order), bit for bit, from the edge
    # data and from the assembled public-order system
    dr_perm, w_pairs = level_eliminate._pair_sums_plain(dlp, ed)
    want = level_eliminate.level_walk_plain(dlp, dr_perm, w_pairs)
    got = level_eliminate.level_eliminate(dlp, ed)
    dr_pub = dr_perm[dlp.perm.long()].contiguous()
    got_sys = level_eliminate.level_eliminate_system(dlp, dr_pub, w_pairs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got + got_sys, want + want)), "K7 walk bits"
    walk = dlp.walk
    record["level_eliminate"].update({
        "walk_equal": True, "schedule": {"forward": walk.fwd.tolist(), "back": walk.back.tolist()},
        "cuda_launches": level_eliminate.cuda_launches(dlp)})
    q_T, p_T, finite = backsub.backsub(ed, lam, N, k)
    assert bool(finite), "backsub: non-finite solution"
    if keep_case:
        record["_edge_case"] = e_args
    return record


def level_main_path(P, device, label: str, build, expect: dict) -> dict:
    """A general forest solve through the public API, counted and checked:
    the level executor, K6–K8 only, converged, finite, conserving mass and
    equal to the plain path on the card."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.solver import _LevelExecutor, _flatten_blocks_host

    t0 = time.perf_counter()
    asm = build()
    mesh = asm.network
    solver = P.Solver(asm, device=device)
    sizes = {"edges": mesh.num_edges, "bifurcations": mesh.num_multipliers, "dofs": asm.num_dofs}
    log(f"phase {label}: set-up {time.perf_counter() - t0:.3f} s, {sizes['edges']} edges, "
        f"{sizes['bifurcations']} bifurcations, {sizes['dofs']} dofs")

    kernels.reset_launches()
    sol = solver.solve()
    torch.cuda.synchronize()
    launches = kernels.launches()
    ex = solver._executor
    assert isinstance(ex, _LevelExecutor), type(ex)
    assert ex.edge_order is None and ex.bif_order is None
    sizes["levels"] = ex.device_plan.num_levels
    for key, want in expect.items():
        assert sizes[key] == want, (key, sizes[key], want)
    assert all(fn.launches >= 1 for fn in kernels.GENERAL), launches
    assert all(fn.launches == 0 for fn in kernels.BLOCKED + kernels.CYCLIC), launches
    assert launches["segsum"] == 1, launches  # the three sums in one planned launch

    info = solver.info
    x = solver.solution_vector()
    assert info.converged, info
    assert x.shape == (asm.num_dofs,) and np.all(np.isfinite(x))
    assert sum(fn.values.size for fn in sol) == asm.num_dofs
    imbalance, qmax = conservation(asm, x)
    assert imbalance <= 1e-10 * qmax, (imbalance, qmax)

    out = ex.plain(*ex.prepare_args(*asm.schur_arguments()))
    x_plain = _flatten_blocks_host(
        out[0].cpu().numpy(), out[1].cpu().numpy(), out[2].cpu().numpy(), mesh.edge_color,
    )
    err = float(np.abs(x - x_plain).max())
    scale = max(1.0, float(np.abs(x_plain).max()))
    assert err <= TOL * scale, (err, scale)
    log(f"phase {label}: {ex.layout} layout, {sizes['levels']} levels, converged, finite, "
        f"conservation {imbalance:.3e} (max |q| {qmax:.3e}), vs plain path {err:.3e} "
        f"(scale {scale:.3e}), launches {launches}")
    return {"asm": asm, "solver": solver, "launches": launches, "sizes": sizes}


def level_timing(P, state: dict, forms, label: str, name_power: str) -> dict:
    """compute_forms + solve best of 5 on the host clock, CUDA-synchronised;
    device time per solve for the kernels and the plain versions; launches."""
    from networks_fenicsx_tpu_torch.kernels import level_eliminate

    asm, solver = state["asm"], state["solver"]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forms(asm)
        solver.solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ex = solver._executor
    args = ex.prepare_args(*asm.schur_arguments())
    dev_ms = cuda_ms(lambda: ex(*args), reps=10)
    plain_ms = cuda_ms(lambda: ex.plain(*args), reps=5)
    wrapper_launches = sum(state["launches"].values())
    k7 = level_eliminate.cuda_launches(ex.device_plan)
    k7_before = level_before(ex.device_plan.num_levels)
    cuda_launches = 2 + k7
    log(f"phase timing {label}: compute_forms+solve best {min(times):.3f} ms "
        f"(all {[round(t, 3) for t in times]}); device per solve (upload + kernels) "
        f"{dev_ms:.3f} ms, plain versions {plain_ms:.3f} ms; launches per solve "
        f"{wrapper_launches} wrapper calls, {cuda_launches} CUDA kernels (K7 {k7} with K6 and the "
        f"prepare pass, before its level walks {k7_before}); card {name_power}")
    return {"best_ms": min(times), "device_ms": dev_ms, "plain_ms": plain_ms,
            "cuda_launches": cuda_launches, "k7_launches": k7, "k7_launches_before": k7_before}


def level_before(L: int) -> int:
    """K7's CUDA launches a call on ``L`` levels before its level walks (a
    launch a level: prepare, K6, assemble, norm, a fold launch a level below
    the roots, a back-substitution launch a level, the un-permute)."""
    return 1 + 1 + 2 + (L - 1) + L + 1


def web_assembler(P, sites: int = FOREST_SITES, N: int = FOREST_N, k: int = FOREST_K):
    """The web with anastomoses: a Delaunay web keeping its spanning tree and
    ``WEB_KEEP`` of its other edges."""
    net = P.network_generation.make_random_network(sites, keep=WEB_KEEP, seed=7, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=N, color_strategy="fast"),
                                      flux_degree=k, pressure_degree=0)
    forest_forms(asm)
    return asm


def bed_forms(asm) -> None:
    """The reference benchmark's bed: Poiseuille R = 1/r⁴, f = 0, p_bc = y."""
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=1.0 / asm.network.edge_radius**4)


def bed_assembler(P, gens: int = 5, nx: int = 96, ny: int = 64, N: int = 2):
    """The perfusion bed ``make_vascular_bed(gens, nx, ny)`` at N cells a vessel, k = 1."""
    net = P.network_generation.make_vascular_bed(gens, nx, ny, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=N, color_strategy="fast"),
                                      flux_degree=1, pressure_degree=0)
    bed_forms(asm)
    return asm


def golden_web48(P):
    """The web48 golden's network (``tests/goldens/web48.json``) at N = 2 with
    per-edge R and per-cell f from a seed."""
    net = P.network_generation.make_random_network(48, keep=0.6, num_boundary=3, seed=5,
                                                   arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=2, color_strategy="fast"))
    forest_forms(asm)
    return asm


def compare_cyclic_kernels(P, asm, device, timed: bool, force_mf_leaf: int | None = None,
                           keep_case: bool = False) -> dict:
    """Each cyclic kernel against its plain version on the inputs the tree
    executor gives it, on the card: the bifurcation system (K9 with K6),
    the round folds (K10), the peel rounds around one plain core solve (K9,
    bit for bit with ``peel_plain`` and ``peel_table_plain``),
    the dense core (K11) where the core has at most 512 nodes, and the
    multifrontal factor and apply (K13–K15) where there is a multifrontal
    plan (``force_mf_leaf`` forces one on a small core, as ``_tree_plan=``
    does).  The refined core solutions are held at ``CYCLIC_TOL``, the rest
    at ``TOL``; so are the unrefined ones (``*_unrefined``: no refinement
    pass, which would hide an error of the factor or the sweeps), K15's on
    the kernel's own factor, so that only the sweeps differ.  ``keep_case``
    adds ``_peel_case``, K9's ``(plan, dr, w_pairs)``, for its launch counts."""
    from networks_fenicsx_tpu_torch import levels
    from networks_fenicsx_tpu_torch.kernels import (
        dense_core, edge_data, fold, mf_apply, mf_factor, peel, segsum,
    )
    from networks_fenicsx_tpu_torch.kernels.level_eliminate import _prepare_plain
    from networks_fenicsx_tpu_torch.ops.multifrontal import device_mf_plan, plan_multifrontal
    from networks_fenicsx_tpu_torch.solver import _TreeExecutor, build_schur_executor

    override = None
    if force_mf_leaf is not None:
        plan = levels._plan_tree_elimination(asm)
        override = plan._replace(core_plan=plan_multifrontal(
            np.asarray(plan.core_pairs), plan.core_size, leaf=force_mf_leaf))
    ex = build_schur_executor(asm, P.SolverOptions(), device=device, _tree_plan=override)
    assert isinstance(ex, _TreeExecutor), type(ex)
    dtp = ex.device_plan
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    Rm, fm, f_zero = asm.coefficient_modes()
    ed = edge_data.edge_data_plain(dtp, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi, R, f,
                                   Rm, fm, f_zero, sp, ep)
    dr, w_edges, _ = peel.lambda_system_plain(dtp, ed)
    w_pairs = segsum.segsum_plain(dtp.pair_idx, w_edges)
    _, vt, vs = _prepare_plain(ed)
    core_in = {}

    def plain_core(dc, rc):
        core_in["dc"], core_in["rc"] = dc, rc
        if dtp.mf is not None:
            return mf_apply.mf_apply_plain(dtp.mf, mf_factor.mf_factor_plain(dtp.mf, dc, w_pairs), rc)
        return dense_core.dense_core_plain(dtp.core_ci, dtp.core_cj, dtp.core_pid, dc, rc, w_pairs)

    def jacobi_core(dc, rc):
        return rc / dc

    peel.peel_plain(dtp, dr, w_pairs, plain_core)
    dc, rc = core_in["dc"], core_in["rc"]
    gen = torch.Generator(device=device).manual_seed(0)
    folds = [(rd.fold, torch.randn((rd.size, 2), generator=gen, dtype=torch.float64,
                                   device=device)) for rd in dtp.rounds if rd.fold]

    checked = folds + [three_level_fold(device)]

    def fold_all(fn, pairs):
        return lambda: [fn(v, lv) for lv, v in pairs]

    runs = {
        "lambda_system": (lambda: peel.lambda_system(dtp, ed),
                          lambda: peel.lambda_system_plain(dtp, ed), TOL),
        # K6's planned launches, bit for bit (tolerance 0): the two sides
        # written once into dr, the pairs
        "segsum_lambda": (lambda: segsum.segsum_plan(dtp.lambda_sums, vt, vs),
                          lambda: segsum.segsum_plan_plain(dtp.lambda_sums, vt, vs), 0.0),
        "segsum_pairs": (lambda: segsum.segsum_plan(dtp.pair_sums, w_edges),
                         lambda: segsum.segsum_plan_plain(dtp.pair_sums, w_edges), 0.0),
        # bit for bit (tolerance 0), one launch a fold
        "fold_apply": (counted_folds(fold_all(fold.fold_apply, checked), len(checked)),
                       fold_all(fold.fold_apply_plain, checked), 0.0),
        # bit for bit (tolerance 0) on the same core solution
        "peel": (lambda: peel.peel(dtp, dr, w_pairs, plain_core),
                 lambda: peel.peel_plain(dtp, dr, w_pairs, plain_core), 0.0),
    }
    # K9 is timed around a trivial core solve, so that the time is the rounds';
    # K10 on the peel rounds' folds alone
    timed_runs = {"peel": (lambda: peel.peel(dtp, dr, w_pairs, jacobi_core),
                           lambda: peel.peel_plain(dtp, dr, w_pairs, jacobi_core)),
                  "fold_apply": (fold_all(fold.fold_apply, folds),
                                 fold_all(fold.fold_apply_plain, folds))}
    core_pairs = (dtp.core_ci, dtp.core_cj, dtp.core_pid)
    if dtp.core_size <= 512:
        runs["dense_core"] = (lambda: dense_core.dense_core(*core_pairs, dc, rc, w_pairs),
                              lambda: dense_core.dense_core_plain(*core_pairs, dc, rc, w_pairs),
                              CYCLIC_TOL)
        runs["dense_core_unrefined"] = (
            lambda: dense_core.dense_core(*core_pairs, dc, rc, w_pairs, n_refine=0),
            lambda: dense_core.dense_core_plain(*core_pairs, dc, rc, w_pairs, n_refine=0), TOL)
    dmf = dtp.mf
    if dmf is None and dtp.core_size:  # the small core through the multifrontal engine too
        dmf = device_mf_plan(plan_multifrontal(np.asarray(dtp.plan.core_pairs), dtp.core_size,
                                               leaf=4), device)
    if dmf is not None:
        st_plain = mf_factor.mf_factor_plain(dmf, dc, w_pairs)
        st = mf_factor.mf_factor(dmf, dc, w_pairs)
        runs["mf_factor"] = (lambda: mf_factor.mf_factor(dmf, dc, w_pairs)[:3],
                             lambda: mf_factor.mf_factor_plain(dmf, dc, w_pairs)[:3], TOL)
        runs["mf_apply"] = (lambda: mf_apply.mf_apply(dmf, st, rc),
                            lambda: mf_apply.mf_apply_plain(dmf, st_plain, rc), CYCLIC_TOL)
        dmf0 = dataclasses.replace(dmf, plan=dmf.plan._replace(n_refine=0))
        runs["mf_apply_unrefined"] = (lambda: mf_apply.mf_apply(dmf0, st, rc),
                                      lambda: mf_apply.mf_apply_plain(dmf0, st, rc), TOL)
    work, library = cyclic_work(dtp, ed, dr, w_edges, w_pairs, dc, rc, folds, dmf,
                                st if dmf is not None else None)
    record = {"rounds": len(dtp.rounds), "core": dtp.core_size,
              "groups": None if dmf is None else len(dmf.plan.groups),
              "peel_fold_levels": max((len(rd.fold) for rd in dtp.rounds), default=0),
              "peel_launches": peel.cuda_launches(dtp)}
    if dmf is not None:
        # the kernels' fronts before the factor (the extend-add through rel)
        # are the gather through lminv's bit for bit, on the kernel's pools
        assembled = mf_factor.assemble_fronts(dmf, dc, w_pairs, st.pools)
        assert torch.equal(assembled, mf_factor.assemble_fronts_plain(dmf, dc, w_pairs, st.pools))
        record["mf_assembled_equal"] = True
        record["mf_levels"] = dmf.schedule.n_levels
    for name, (kernel, plain, tol) in runs.items():
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        assert err <= tol * scale, (name, err, scale)
        record[name] = {"max_abs_err": err, "scale": scale}
        if timed and not name.endswith("_unrefined"):
            kernel, plain = timed_runs.get(name, (kernel, plain))
            record[name]["ms"] = cuda_ms(kernel, reps=5)
            record[name]["plain_ms"] = cuda_ms(plain, reps=3)
            record[name].update(bound(*work[name]))
            if name in library:
                record[name]["library_ms"] = cuda_ms(library[name], reps=5)
    # K9 against the plain version in the kernels' order, and its depth (dependent rounds)
    assert torch.equal(peel.peel(dtp, dr, w_pairs, plain_core),
                       peel.peel_table_plain(dtp, dr, w_pairs, plain_core))
    record["peel"].update({"table_plain_equal": True, "depth": 2 * len(dtp.rounds)})
    if keep_case:
        record["_peel_case"] = (dtp, dr, w_pairs)
    return record


def star_assembler(P, leaves: int = STAR_LEAVES):
    """A hub on a triangle of bifurcations with ``leaves`` leaf bifurcations,
    each with a boundary stub, at N = 2 with :func:`forest_forms`: one peel
    round takes every leaf into the hub, whose fold row of ``leaves`` terms
    has two levels; the triangle is a 3-node dense core."""
    ang = np.linspace(0.0, 2 * np.pi, leaves, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], 1)
    leaf = 3 + np.arange(leaves)
    net = P.mesh.ArrayNetwork(
        pos=np.concatenate([[[0.0, 0.0], [0.3, 0.1], [0.1, 0.3]], 2 * ring, 3 * ring]),
        edges=np.concatenate([[[0, 1], [1, 2], [2, 0]],
                              np.stack([np.zeros(leaves, np.int64), leaf], 1),
                              np.stack([leaf, leaf + leaves], 1)]).astype(np.int64))
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=2, color_strategy="fast"))
    forest_forms(asm)
    return asm


def three_level_fold(device) -> tuple:
    """``(FoldPlan, values)``: a seeded fold whose segments are wider than 64
    twice over (5,000, 300, ...: three levels), two channels."""
    from networks_fenicsx_tpu_torch.kernels import fold
    from networks_fenicsx_tpu_torch.ops.core_elim import _plan_fold

    rng = np.random.default_rng(9)
    widths = np.concatenate([[0, 5000, 300, 1], rng.integers(1, 70, 40)])
    seg = np.repeat(np.arange(widths.size), widths)
    rng.shuffle(seg)
    plan = fold.FoldPlan(torch.as_tensor(lv.astype(np.int32), device=device)
                         for lv in _plan_fold(seg, widths.size, np.arange(seg.size), seg.size))
    assert len(plan) == 3
    return plan, torch.as_tensor(rng.standard_normal((seg.size, 2)), device=device)


def counted_folds(run, n_folds: int):
    """``run`` (K10 over ``n_folds`` folds), asserting one launch a fold."""
    from networks_fenicsx_tpu_torch.kernels import fold

    def counted():
        before = fold.fold_apply.launches
        out = run()
        assert fold.fold_apply.launches - before == n_folds, (fold.fold_apply.launches - before,
                                                              n_folds)
        return out
    return counted


def core_folds(dcp, device) -> list:
    """``(FoldPlan, values)`` of every K10 fold of a min-degree core plan,
    on seeded values of its source's length: per round the prior-update
    reads (the update stream), the diagonal fold (S·K terms) and the update
    fold (M2 contributions); the dense tail's and the fronts' reads."""
    gen = torch.Generator(device=device).manual_seed(12)
    out = []
    for plan, n in ([(rd.u_read, dcp.mu_all) for rd in dcp.rounds]
                    + [(rd.d_fold, rd.S * rd.K) for rd in dcp.rounds]
                    + [(rd.u_fold, rd.M2) for rd in dcp.rounds]
                    + [(dcp.dp_fold, dcp.mu_all)] + [(fr.f_fold, dcp.mu_all) for fr in dcp.fronts]):
        if len(plan) and plan[-1].shape[0]:
            out.append((plan, torch.randn(n, generator=gen, dtype=torch.float64, device=device)))
    return out


def fold_work(levels, n: int, C: int) -> tuple[int, int]:
    """(index bytes, additions) of one K10 fold of an ``(n, C)`` input."""
    nbytes = adds = 0
    for lv in levels:
        adds += valid_entries(lv, n) * C
        nbytes += tensor_bytes(lv)
        n = lv.shape[0]
    return nbytes, adds


def cyclic_work(dtp, ed, dr, w_edges, w_pairs, dc, rc, folds, dmf, st):
    """``({name: (bytes, float64 operations[, matrix operations])}, {name:
    library call})`` of the cyclic kernels' timed calls (peel with its
    Jacobi core), on these inputs.  Operations: the λ system ~8 per edge; a
    fold one per summed entry and channel; a peel round ~6 per node plus its
    fold; the dense core n³/3 matrix operations for the factor and 4n² + 2P₀
    per solve and refinement pass; the multifrontal factor w³/3 + w²b + wb²
    matrix operations and each sweep 2w² + 4wb per front of pivot width w and
    boundary b, with 4P₀ per refinement matvec."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    E, B = dtp.num_edges, dtp.num_bifurcations
    n_c, P0 = dtp.core_size, int(dtp.core_ci.shape[0])
    lam_plan = (dtp.t_idx, dtp.t_bins, dtp.s_idx, dtp.s_bins, dtp.start_bif, dtp.end_bif)
    t_adds = valid_entries(dtp.t_idx, E) + valid_entries(dtp.s_idx, E)
    folded = [fold_work(lv, v.shape[0], 2) for lv, v in folds]
    rounds = [(rd.elim, rd.parents, rd.pair_ids, rd.upar, rd.fold) for rd in dtp.rounds]
    round_folds = [fold_work(rd.fold, rd.size, 2)[1] for rd in dtp.rounds if rd.fold]
    n_peeled = sum(rd.size for rd in dtp.rounds)
    work = {
        "lambda_system": (tensor_bytes(ed.W, ed.g, ed.cumF[-1], ed.start_pbc, ed.end_pbc,
                                       lam_plan, dr, w_edges) + 8, 8 * E + 2 * t_adds + 2 * B),
        # the tables and the (E, 2) values read, dr written; one add an entry and channel
        "segsum_lambda": (tensor_bytes(lam_plan[:4], dr) + 2 * 16 * E, 2 * t_adds),
        "segsum_pairs": (tensor_bytes(dtp.pair_idx, w_edges, w_pairs),
                         valid_entries(dtp.pair_idx, E)),
        "fold_apply": (sum(b for b, _ in folded) + sum(tensor_bytes(v) + 16 * lv[-1].shape[0]
                                                       for lv, v in folds),
                       sum(a for _, a in folded)),
        "peel": (tensor_bytes(dr, w_pairs, rounds) + 8 * B, 6 * n_peeled + sum(round_folds)
                 + 2 * n_c),
    }
    if n_c and n_c <= 512:
        nr = dense_core.N_REFINE
        work["dense_core"] = (tensor_bytes(dtp.core_ci, dtp.core_cj, dtp.core_pid, dc, rc,
                                           w_pairs) + 8 * n_c,
                              (1 + nr) * (4 * n_c**2 + 2 * P0), n_c**3 / 3)
    library = {}
    if dmf is not None:
        groups = dmf.plan.groups
        fac_ops = sum(g.k * (g.w**3 / 3 + g.w**2 * g.b + g.w * g.b**2) for g in groups)
        nr = dmf.plan.n_refine
        sweep_ops = sum(g.k * (2 * g.w**2 + 4 * g.w * g.b) for g in groups)
        mf_index = tensor_bytes(dmf.init_slot, dmf.nodes_all, dmf.cval_all, dmf.ccol_all,
                                dmf.cidx_all, dmf.lminv_all) + dmf.consume.nbytes  # a host table
        work["mf_factor"] = (mf_index + tensor_bytes(dc, w_pairs, st.fac, st.vals, st.ok),
                             0.0, fac_ops)
        work["mf_apply"] = (tensor_bytes(dmf.bndpos_all, dmf.lam_pos, dmf.pci, dmf.pcj,
                                         dmf.mv_inv_i, dmf.mv_inv_j, st.fac, st.vals, dc, rc)
                            + 8 * n_c,
                            (1 + nr) * sweep_ops + nr * 4 * P0)
    # K10's yardstick: index_add_ of each round's terms into its parents
    adds = []
    for rd, (lv, v) in zip([rd for rd in dtp.rounds if rd.fold], folds):
        ok = rd.parents >= 0
        seg = torch.searchsorted(rd.upar, rd.parents[ok])
        adds.append((torch.zeros((rd.upar.shape[0], 2), dtype=v.dtype, device=v.device),
                     seg, v[ok]))
    library["fold_apply"] = lambda: [out.index_add_(0, seg, src) for out, seg, src in adds]
    if n_c and n_c <= 512:
        Lc = dense_core.assemble_core(dtp.core_ci, dtp.core_cj, dtp.core_pid, dc, w_pairs)
        library["dense_core"] = lambda: torch.cholesky_solve(
            rc[:, None], torch.linalg.cholesky(Lc))
    return work, library


def core_sizes(dtp) -> dict:
    """The core engine's sizes: min-degree rounds, dense tail, fronts (w, b)."""
    ce = dtp.ce
    if ce is None:
        return {"core_rounds": None, "dense_tail": None, "fronts": None}
    fronts = tuple((fr.w, fr.b) for fr in ce.fronts)
    return {"core_rounds": len(ce.rounds), "dense_tail": int(ce.dense_nodes.shape[0]),
            "fronts": fronts or 0}


def core_engine(dtp) -> tuple[tuple, tuple]:
    """(wrappers the core solve of ``dtp`` launches, cyclic core wrappers it
    must not launch)."""
    ce = dtp.ce
    if dtp.mf is not None:
        used = ("mf_factor", "mf_apply")
    elif ce is not None:
        tail = bool(ce.dense_nodes.shape[0])
        used = ((("core_elim",) if ce.rounds or tail else ())
                + (("fold_apply",) if any(len(fr.f_fold) for fr in ce.fronts) else ())
                + (("core_fronts",) if ce.fronts else ()) + (("dense_core",) if tail else ()))
    else:
        used = ("dense_core",)
    core = ("mf_factor", "mf_apply", "dense_core", "core_elim", "core_fronts")
    return used, tuple(name for name in core if name not in used)


def core_text(dtp) -> str:
    if dtp.mf is not None:
        mf = dtp.mf.plan.stats
        return (f"multifrontal: {mf['mf_groups']} groups, {mf['mf_fronts']} fronts, "
                f"front_max {mf['front_max']}; factor {dtp.mf.device_bytes / 2**20:.1f} MiB")
    if dtp.ce is not None:
        return f"min-degree: {dtp.ce.plan.stats}"
    return "dense"


def cyclic_main_path(P, device, label: str, build, expect: dict, attach: bool = True) -> dict:
    """A cyclic solve through the public API, counted and checked: the tree
    executor, only the cyclic wrappers and K6/K8 with the core engine its
    plan names, converged, finite, conserving mass and equal to the plain
    path on the card.  ``attach``: the host planning timed is the tree plan
    with its sparse core plan (False: without, as ``auto`` plans a scalar-R
    lattice's dense core)."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.levels import _cached_tree_plan
    from networks_fenicsx_tpu_torch.solver import _TreeExecutor, _flatten_blocks_host

    t0 = time.perf_counter()
    asm = build()
    t1 = time.perf_counter()
    _cached_tree_plan(asm, attach=attach)  # the host planning, paid once per assembler
    t2 = time.perf_counter()
    mesh = asm.network
    solver = P.Solver(asm, device=device)
    sizes = {"edges": mesh.num_edges, "bifurcations": mesh.num_multipliers, "dofs": asm.num_dofs}
    log(f"phase {label}: set-up {t1 - t0:.3f} s, host planning {t2 - t1:.3f} s, "
        f"{sizes['edges']} edges, {sizes['bifurcations']} bifurcations, {sizes['dofs']} dofs")

    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    sol = solver.solve()
    torch.cuda.synchronize()
    launches = kernels.launches()
    peak_mb = torch.cuda.max_memory_allocated(device) / 2**20
    ex = solver._executor
    assert isinstance(ex, _TreeExecutor), type(ex)
    assert ex.edge_order is None and ex.bif_order is None
    dtp = ex.device_plan
    sizes["rounds"], sizes["core"] = len(dtp.rounds), dtp.core_size
    sizes["groups"] = None if dtp.mf is None else len(dtp.mf.plan.groups)
    sizes.update(core_sizes(dtp))
    for key, want in expect.items():
        assert sizes[key] == want, (key, sizes[key], want)
    allowed = {fn.__name__ for fn in kernels.CYCLIC} | set(CYCLIC_SHARED)
    assert all(n == 0 for name, n in launches.items() if name not in allowed), launches
    used, unused = core_engine(dtp)
    for name in ("lambda_system", "peel", *used, *CYCLIC_SHARED):
        assert launches[name] >= 1, (name, launches)
    assert all(launches[name] == 0 for name in unused), launches
    # K10 runs in the core engines only (the multifrontal refinement, K12b's fronts): K9 sums
    # its own folds
    folds = (dtp.mf is not None and dtp.mf.plan.n_refine > 0) or "fold_apply" in used
    assert (launches["fold_apply"] >= 1) == folds, launches

    info = solver.info
    x = solver.solution_vector()
    assert info.converged, info
    assert x.shape == (asm.num_dofs,) and np.all(np.isfinite(x))
    assert sum(fn.values.size for fn in sol) == asm.num_dofs
    imbalance, qmax = conservation(asm, x)
    assert imbalance <= 1e-10 * qmax, (imbalance, qmax)

    out = ex.plain(*ex.prepare_args(*asm.schur_arguments()))
    x_plain = _flatten_blocks_host(
        out[0].cpu().numpy(), out[1].cpu().numpy(), out[2].cpu().numpy(), mesh.edge_color,
    )
    err = float(np.abs(x - x_plain).max())
    scale = max(1.0, float(np.abs(x_plain).max()))
    assert err <= CYCLIC_TOL * scale, (err, scale)
    log(f"phase {label}: {len(dtp.rounds)} peel rounds, core {dtp.core_size} "
        f"({core_text(dtp)}), converged, finite, "
        f"conservation {imbalance:.3e} (max |q| {qmax:.3e}), vs plain path {err:.3e} "
        f"(scale {scale:.3e}), peak device memory {peak_mb:.1f} MiB, launches {launches}")
    return {"asm": asm, "solver": solver, "launches": launches, "sizes": sizes,
            "planning_s": t2 - t1}


def cyclic_timing(P, state: dict, forms, label: str, name_power: str) -> dict:
    """compute_forms + solve best of 5 on the host clock, CUDA-synchronised;
    the host planning time; device time per solve for the kernels and the
    plain versions; launches per solve."""
    from networks_fenicsx_tpu_torch import tree

    asm, solver = state["asm"], state["solver"]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forms(asm)
        solver.solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ex = solver._executor
    args = ex.prepare_args(*asm.schur_arguments())
    dev_ms = cuda_ms(lambda: ex(*args), reps=5)
    plain_ms = cuda_ms(lambda: ex.plain(*args), reps=3)
    wrapper_launches = sum(state["launches"].values())
    cuda_launches = 2 + tree.cuda_launches(ex.device_plan)
    log(f"phase timing {label}: compute_forms+solve best {min(times):.3f} ms "
        f"(all {[round(t, 3) for t in times]}); host planning {state['planning_s'] * 1e3:.1f} ms "
        f"once per assembler; device per solve (upload + kernels) {dev_ms:.3f} ms, plain "
        f"versions {plain_ms:.3f} ms; launches per solve {wrapper_launches} wrapper calls, "
        f"{cuda_launches} CUDA kernels; card {name_power}")
    return {"best_ms": min(times), "device_ms": dev_ms, "plain_ms": plain_ms,
            "cuda_launches": cuda_launches}


def web2k_forms(asm) -> None:
    """The reference's mid-size web stage (``__graft_entry__.py:244-252``):
    R from ``default_rng(7)`` per edge, f = 0, p_bc = x."""
    R = np.random.default_rng(7).uniform(0.5, 2.0, asm.network.num_edges)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)


def web2k_assembler(P):
    """``make_random_network(2000, keep=0.7, num_boundary=8, seed=5)`` at N = 1, k = 1."""
    net = P.network_generation.make_random_network(2000, keep=0.7, num_boundary=8, seed=5,
                                                   arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=1, color_strategy="fast"))
    web2k_forms(asm)
    return asm


def grid128_forms(asm) -> None:
    """Per-edge R from ``default_rng(128)``, f = 0, p_bc = x."""
    R = np.random.default_rng(128).uniform(0.5, 2.0, asm.network.num_edges)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)


def grid_assembler(P, side: int):
    """The side² lattice at N = 1 with :func:`grid128_forms`."""
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(
        P.network_generation.make_grid(side, side, arrays=True), N=1, color_strategy="fast"))
    grid128_forms(asm)
    return asm


def grid128_assembler(P):
    """The 128² lattice at N = 1 with :func:`grid128_forms`."""
    return grid_assembler(P, 128)


def nd_tree_plan(P, asm, **kwargs):
    """The tree plan of ``asm`` with a min-degree core plan on the reference's
    nested-dissection order (leaf 8) and ``kwargs``."""
    from networks_fenicsx_tpu_torch.levels import _plan_tree_elimination
    from networks_fenicsx_tpu_torch.ops.core_elim import (
        nested_dissection_order, plan_core_elimination,
    )

    plan = _plan_tree_elimination(asm)
    pairs = np.asarray(plan.core_pairs)
    nd = nested_dissection_order(pairs, plan.core_size, leaf=8)
    cp = plan_core_elimination(pairs, plan.core_size, order=nd, **kwargs)
    assert cp is not None, kwargs
    return plan._replace(core_plan=cp)


def forced_plans_web48(P, asm) -> dict:
    """The reference's forced plans of the web48 golden (``tests/test_golden.py:148,
    183``): the sparse rounds (``dense_cutoff=4``, no tail stop) and tiny
    supernodal fronts."""
    from networks_fenicsx_tpu_torch.levels import _plan_tree_elimination, attach_core_plan
    from networks_fenicsx_tpu_torch.ops.core_elim import (
        nested_dissection_order, plan_core_elimination,
    )

    plan = _plan_tree_elimination(asm)
    pairs = np.asarray(plan.core_pairs)
    nd = nested_dissection_order(pairs, plan.core_size, leaf=4)
    fronts = plan_core_elimination(pairs, plan.core_size, dense_cutoff=8, kcap=16, order=nd,
                                   dense_cap=4, supernodal_tail=True, front_max=7, front_cap=64,
                                   tail_stop=False)
    return {"sparse": attach_core_plan(plan, dense_cutoff=4, tail_stop=False),
            "supernodal": plan._replace(core_plan=fronts)}


def spd_laplacian(n: int, device, seed: int = 0) -> tuple:
    """A seeded SPD lattice-like Laplacian of order n as K11's arguments
    ``(ci, cj, pid, dc, rc, w_pairs)``: a chain and a stride-√n coupling,
    conductances in [0.5, 2], a diagonal excess in [0.01, 0.1]."""
    rng = np.random.default_rng(seed)
    side, i = int(np.sqrt(n)), np.arange(n)
    ci = np.concatenate([i[:-1], i[:-side]])
    cj = np.concatenate([i[1:], i[side:]])
    w = rng.uniform(0.5, 2.0, ci.size)
    dc = rng.uniform(0.01, 0.1, n)
    np.add.at(dc, ci, w)
    np.add.at(dc, cj, w)
    rc = rng.standard_normal(n)

    def up(a, dt=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return (up(ci, torch.int32), up(cj, torch.int32), up(np.arange(ci.size), torch.int32), up(dc),
            up(rc), up(w))


def factor_backward_error(args) -> tuple[float, float]:
    """(max |Ls − C Cᵀ| of K11's factor on the card, its bar 8·n·ε)."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    ci, cj, pid, dc, _, w = args
    Lc, s, C = dense_core.dense_factor(ci, cj, pid, dc, w)
    Ls = (Lc / s[:, None]) / s[None, :]
    L = torch.tril(C)
    err = float((Ls - L @ L.T).abs().max())
    return err, 8 * dc.shape[0] * EPS


def compare_dense_sizes(device, timed: bool) -> dict:
    """Set (j): K11 alone at each of ``K11_SIZES`` on a seeded SPD Laplacian
    against its plain version (the refined solve and one unrefined pass:
    1e-12·scale up to 628 nodes, 1e-10·scale above, where the two factors'
    summation orders differ by about κ·ε), the factor's backward error from
    2,048 nodes (≤ 8·n·ε), and the time of ``torch.linalg.cholesky`` +
    ``cholesky_solve`` at the same n."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    record = {}
    for n in K11_SIZES:
        args = spd_laplacian(n, device, seed=n)
        tol = TOL if n <= 628 else CYCLIC_TOL
        rec = {}
        for key, nr in (("refined", dense_core.N_REFINE), ("unrefined", 0)):
            got = dense_core.dense_core(*args, n_refine=nr)
            want = dense_core.dense_core_plain(*args, n_refine=nr)
            torch.cuda.synchronize()
            err, scale = max_err(got, want)
            assert err <= tol * scale, (n, key, err, scale)
            rec[key] = {"max_abs_err": err, "scale": scale}
        if n >= 2048:
            berr, bar = factor_backward_error(args)
            assert berr <= bar, (n, berr, bar)
            rec["backward_error"], rec["backward_bar"] = berr, bar
        rec["max_abs_err"] = max(rec["refined"]["max_abs_err"], rec["unrefined"]["max_abs_err"])
        if timed:
            ci, cj, pid, dc, rc, w = args
            Lc = dense_core.assemble_core(ci, cj, pid, dc, w)
            rec["ms"] = cuda_ms(lambda: dense_core.dense_core(*args), reps=3)
            rec["plain_ms"] = cuda_ms(lambda: dense_core.dense_core_plain(*args), reps=3)
            rec["library_ms"] = cuda_ms(
                lambda: torch.cholesky_solve(rc[:, None], torch.linalg.cholesky(Lc)), reps=3)
            nr, P0 = dense_core.N_REFINE, int(ci.shape[0])
            rec.update(bound(tensor_bytes(*args) + 8 * n, (1 + nr) * (4 * n**2 + 2 * P0), n**3 / 3))
        record[n] = rec
    return record


def core_inputs(P, asm, device, tree_plan=None) -> dict:
    """What the tree executor hands the min-degree core on ``asm`` (with
    ``tree_plan`` forced, as the reference's tests force one), from the plain
    versions: the plans ``dtp`` and ``dcp``, the core's ``dc``, ``rc`` and
    ``w_pairs``, and after the rounds the factor state ``st`` and the
    forward-swept rhs ``r_fw``, the inputs of the fronts and of the tail."""
    from networks_fenicsx_tpu_torch.kernels import core_elim, edge_data, peel, segsum
    from networks_fenicsx_tpu_torch.solver import _TreeExecutor, build_schur_executor

    opts = P.SolverOptions(schur_method="tree") if tree_plan is not None else P.SolverOptions()
    ex = build_schur_executor(asm, opts, device=device, _tree_plan=tree_plan)
    assert isinstance(ex, _TreeExecutor), type(ex)
    dtp = ex.device_plan
    dcp = dtp.ce
    assert dcp is not None, "no min-degree core plan"
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    Rm, fm, f_zero = asm.coefficient_modes()
    ed = edge_data.edge_data_plain(dtp, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi, R, f,
                                   Rm, fm, f_zero, sp, ep)
    dr, w_edges, _ = peel.lambda_system_plain(dtp, ed)
    w_pairs = segsum.segsum_plain(dtp.pair_idx, w_edges)
    core_in = {}

    def capture(dc, rc):
        core_in["dc"], core_in["rc"] = dc, rc
        return core_elim.core_elim_plain(dcp, dc, w_pairs, rc)

    peel.peel_plain(dtp, dr, w_pairs, capture)
    dc, rc = core_in["dc"], core_in["rc"]
    factor = core_elim.core_factor_plain(dcp, dc, w_pairs)
    zero = torch.zeros(1, dtype=torch.float64, device=device)
    st = types.SimpleNamespace(  # the rounds' half of the factor: the inputs of the fronts and tail
        d=factor.d, ustream=torch.cat([core_elim.factor_stream(dcp, factor.fac), zero]),
        rounds=core_elim.factor_rounds(dcp, factor.fac))
    r_fw = core_elim.apply_forward_plain(dcp, factor.fac, rc)[0]
    return {"dtp": dtp, "dcp": dcp, "dc": dc, "rc": rc, "w_pairs": w_pairs, "st": st, "r_fw": r_fw}


def compare_core_kernels(P, asm, device, timed: bool, tree_plan=None, expect=None,
                         before: str | None = None) -> dict:
    """K12a (:mod:`core_elim`), K12b (:mod:`core_fronts`) and K11 on a dense
    tail against their plain versions on the inputs the tree executor gives
    the core (``tree_plan`` forces a plan, as the reference's tests do): the
    whole core solve, refined and with one unrefined tail pass, at 1e-12·scale
    where the tail has at most 628 nodes and there are no fronts, at
    1e-10·scale otherwise; the fronts alone and the dense tail alone on
    their own inputs; the tail's factor backward error from 2,048 nodes.
    Every fold of the plan through K10 bit for bit, one launch a fold (K12a
    sums them inside its own launches).  K12a's rounds alone
    bit for bit with the packed table's plain order.  Timed: K12a on the
    rounds alone (the tail and fronts left out), K12b on the fronts alone,
    K11 on the tail.  ``before``: the whole core's λ held by SHA-256 to
    :data:`CORE_LAMBDA_BEFORE`'s (the design before the split)."""
    from networks_fenicsx_tpu_torch.kernels import core_elim, core_fronts, dense_core, fold

    inp = core_inputs(P, asm, device, tree_plan)
    dtp, dcp, dc, rc, w_pairs, st, r_fw = (inp[k] for k in ("dtp", "dcp", "dc", "rc", "w_pairs",
                                                           "st", "r_fw"))
    sizes = {"core": dtp.core_size, **core_sizes(dtp)}
    for key, want in (expect or {}).items():
        assert sizes[key] == want, (key, sizes[key], want)
    n_tail = int(dcp.dense_nodes.shape[0])
    tol = TOL if n_tail <= 628 and not dcp.fronts else CYCLIC_TOL
    folds = core_folds(dcp, device)
    runs = {
        "core_elim": (lambda: core_elim.core_elim(dcp, dc, w_pairs, rc),
                      lambda: core_elim.core_elim_plain(dcp, dc, w_pairs, rc), tol),
        # the plan's folds through K10, bit for bit (tolerance 0), one launch a fold
        "fold_apply": (counted_folds(lambda: [fold.fold_apply(v, lv) for lv, v in folds], len(folds)),
                       lambda: [fold.fold_apply_plain(v, lv) for lv, v in folds], 0.0),
    }
    if n_tail:
        runs["core_elim_unrefined"] = (
            lambda: core_elim.core_elim(dcp, dc, w_pairs, rc, n_refine=0),
            lambda: core_elim.core_elim_plain(dcp, dc, w_pairs, rc, n_refine=0), tol)
    timed_runs, work = {}, {}
    if dcp.fronts:
        runs["core_fronts"] = (
            lambda: core_fronts.core_fronts(dcp, st.d, st.ustream[:-1], w_pairs, r_fw.clone()),
            lambda: core_fronts.core_fronts_plain(dcp, st.d, st.ustream, w_pairs, r_fw),
            CYCLIC_TOL)
        fl = sum(fr.w**3 / 3 + fr.w**2 * fr.b + fr.w * fr.b**2 for fr in dcp.fronts)
        front_tables = [(fr.nodes, fr.bnd, fr.slot_i, fr.slot_j, fr.f_init, fr.f_fold, fr.lminv)
                        for fr in dcp.fronts]
        work["core_fronts"] = (tensor_bytes(front_tables, st.d, r_fw) + 16 * dcp.n_core,
                               sum(2 * fr.w**2 + 4 * fr.w * fr.b for fr in dcp.fronts), fl)
    tail_args = None
    if n_tail:
        dn = dcp.dense_nodes.long()
        ov = core_elim.init_values_plain(dcp, w_pairs)[dcp.dp_init.long()]
        if dcp.dp_fold:
            ov = ov - fold.fold_apply_plain(st.ustream, dcp.dp_fold)
        tail_args = (dcp.dense_di, dcp.dense_dj, dcp.dense_pid, st.d[dn].contiguous(),
                     r_fw[dn].contiguous(), (-ov).contiguous())
        runs["dense_core"] = (lambda: dense_core.dense_core(*tail_args),
                              lambda: dense_core.dense_core_plain(*tail_args),
                              TOL if n_tail <= 628 else CYCLIC_TOL)
        nr, Pd = dense_core.N_REFINE, int(dcp.dense_di.shape[0])
        work["dense_core"] = (tensor_bytes(*tail_args) + 8 * n_tail,
                              (1 + nr) * (4 * n_tail**2 + 2 * Pd), n_tail**3 / 3)
    # K12a timed on its rounds alone: the tail and the fronts left out
    rounds_only = dataclasses.replace(
        dcp, fronts=(), dense_nodes=dcp.dense_nodes[:0], dp_init=dcp.dp_init[:0])
    timed_runs["core_elim"] = (lambda: core_elim.core_elim(rounds_only, dc, w_pairs, rc),
                               lambda: core_elim.core_elim_plain(rounds_only, dc, w_pairs, rc))
    round_tables = [(rd.elim, rd.nbr_node, rd.init_idx, rd.u_read, rd.d_fold, rd.d_inv,
                     rd.u_src_i, rd.u_src_j, rd.u_fold, rd.e_inv) for rd in dcp.rounds]
    used_pairs = sum(int((rd.init_idx < dcp.n_pairs).sum()) for rd in dcp.rounds)
    work["core_elim"] = (
        tensor_bytes(round_tables, dcp.init_slot, dc, rc) + 8 * (used_pairs + dcp.n_core)
        + 8 * dcp.mu_all,
        sum(4 * rd.S * rd.K + 3 * rd.M2 for rd in dcp.rounds)
        + sum(fold_work(rd.d_fold, rd.S * rd.K, 1)[1] * 2 for rd in dcp.rounds)
        + dcp.mu_all)
    record = dict(sizes)
    for name, (kernel, plain, tol_) in runs.items():
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        assert err <= tol_ * scale, (name, err, scale, tol_)
        record[name] = {"max_abs_err": err, "scale": scale, "tol": tol_}
        if timed and name in work:
            kernel, plain = timed_runs.get(name, (kernel, plain))
            record[name]["ms"] = cuda_ms(kernel, reps=5)
            record[name]["plain_ms"] = cuda_ms(plain, reps=3)
            record[name].update(bound(*work[name]))
            record[name]["library_ms"] = None
    if tail_args is not None and n_tail >= 2048:
        berr, bar = factor_backward_error(tail_args)
        assert berr <= bar, (berr, bar)
        record["dense_core"]["backward_error"], record["dense_core"]["backward_bar"] = berr, bar
    if tail_args is not None and timed:
        Lc = dense_core.assemble_core(*tail_args[:3], tail_args[3], tail_args[5])
        r_t = tail_args[4]
        record["dense_core"]["library_ms"] = cuda_ms(
            lambda: torch.cholesky_solve(r_t[:, None], torch.linalg.cholesky(Lc)), reps=5)
    # K12a's rounds alone (no tail, no fronts) are the packed table's plain
    # order to the bit; the whole core's λ by SHA-256 and its launches
    lam_r = core_elim.core_elim(rounds_only, dc, w_pairs, rc)
    want_r = core_elim.core_elim_table_plain(rounds_only, dc, w_pairs, rc)
    assert sha256(lam_r) == sha256(want_r), "core_elim: the rounds are not the table plain version's bits"
    record["core_elim"].update({
        "rounds_bit_for_bit": True, "rounds_lambda_sha256": sha256(lam_r),
        "lambda_sha256": sha256(core_elim.core_elim(dcp, dc, w_pairs, rc)),
        "cuda_launches": core_elim.cuda_launches(dcp),
        "launch_grid": core_elim.launch_grid(dcp, device.index or 0)})
    if before is not None:
        got = record["core_elim"]["lambda_sha256"]
        assert got == CORE_LAMBDA_BEFORE[before], (before, got, CORE_LAMBDA_BEFORE[before])
        record["core_elim"]["lambda_sha256_before"] = CORE_LAMBDA_BEFORE[before]
    record["_case"] = (dcp, dc, w_pairs, rc)
    return record


def forced_core_path(P, device, label: str, asm, tree_plan, expect: dict, name_power: str) -> dict:
    """A solve through the tree executor with a forced core plan (the hook
    the reference's own tests use: ``build_schur_executor(_tree_plan=...)``
    then ``_schur_solve``), counted and checked like a main path: converged,
    finite, conserving mass, equal to the plain path on the card and to the
    default route's solve; device time per solve against the plain
    versions."""
    from networks_fenicsx_tpu_torch import kernels, tree
    from networks_fenicsx_tpu_torch.solver import (
        _flatten_blocks_host, _schur_solve, build_schur_executor,
    )

    opts = P.SolverOptions(schur_method="tree")
    ex = build_schur_executor(asm, opts, device=device, _tree_plan=tree_plan)
    _schur_solve(asm, opts, ex)  # first call: allocation warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    x, info = _schur_solve(asm, opts, ex)
    torch.cuda.synchronize()
    launches = kernels.launches()
    dtp = ex.device_plan
    sizes = {"core": dtp.core_size, **core_sizes(dtp)}
    for key, want in expect.items():
        assert sizes[key] == want, (key, sizes[key], want)
    used, unused = core_engine(dtp)
    for name in ("lambda_system", "peel", *used, *CYCLIC_SHARED):
        assert launches[name] >= 1, (name, launches)
    assert all(launches[name] == 0 for name in unused), launches
    assert info.converged and np.all(np.isfinite(x)), info
    imbalance, qmax = conservation(asm, x)
    assert imbalance <= 1e-10 * qmax, (imbalance, qmax)
    out = ex.plain(*ex.prepare_args(*asm.schur_arguments()))
    x_plain = _flatten_blocks_host(out[0].cpu().numpy(), out[1].cpu().numpy(),
                                   out[2].cpu().numpy(), asm.network.edge_color)
    err = float(np.abs(x - x_plain).max())
    scale = max(1.0, float(np.abs(x_plain).max()))
    assert err <= CYCLIC_TOL * scale, (err, scale)
    ref = P.Solver(asm, device=device)
    ref.solve()
    err_ref = float(np.abs(x - ref.solution_vector()).max())
    assert err_ref <= CYCLIC_TOL * scale, (err_ref, scale)
    args = ex.prepare_args(*asm.schur_arguments())
    dev_ms = cuda_ms(lambda: ex(*args), reps=5)
    plain_ms = cuda_ms(lambda: ex.plain(*args), reps=3)
    log(f"phase {label}: core {dtp.core_size} ({core_text(dtp)}), converged, finite, "
        f"conservation {imbalance:.3e} (max |q| {qmax:.3e}), vs plain path {err:.3e}, vs the "
        f"default route ({type(ref._executor).__name__}) {err_ref:.3e} (scale {scale:.3e}); "
        f"device per solve (upload + kernels) {dev_ms:.3f} ms, plain versions {plain_ms:.3f} ms, "
        f"{sum(launches.values())} wrapper calls, {2 + tree.cuda_launches(dtp)} CUDA kernels; "
        f"launches {launches}; card {name_power}")
    return {"launches": launches, "sizes": sizes, "device_ms": dev_ms, "plain_ms": plain_ms}


def lattice_forms(asm) -> None:
    """The reference benchmark's lattice stage: R = 1, f = 0, p_bc = y."""
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=1.0)


def lattice_source(x):
    return x[0] + 0.3 * x[1]


def lattice_callable_forms(asm) -> None:
    """The same lattice with a distributed source f = x + 0.3·y (quad mode)."""
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=1.0, f=lattice_source)


def lattice_assembler(P, nx: int = LATTICE_N, ny: int = LATTICE_N, N: int = 1, k: int = 1,
                      forms=lattice_forms):
    """``make_grid(nx, ny)``, the capillary lattice, at N cells per vessel."""
    net = P.network_generation.make_grid(nx, ny, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=N, color_strategy="fast"),
                                      flux_degree=k, pressure_degree=0)
    forms(asm)
    return asm


def lattice_small(P):
    """``make_grid(9, 4)`` at N = 2, k = 3, per-cell f from a seed, R = 2.5,
    p_bc = x + 0.2·y: the grid route at flux degree 3."""
    def forms(asm):
        f = np.random.default_rng(4).uniform(-1.0, 1.0, asm.network.num_cells)
        asm.compute_forms(p_bc_ex=lambda x: x[0] + 0.2 * x[1], f=f, R=2.5)
    return lattice_assembler(P, 9, 4, N=2, k=3, forms=forms)


def lattice_wide(P, nx: int = 5000, ny: int = 3):
    """``make_grid(nx, ny)`` (5000 × 3 or 3 × 4200) at N = 1, f = 0.3,
    R = 1.7: a side above 4,096, whose DCT-II matrix is generated on the
    device."""
    def forms(asm):
        asm.compute_forms(p_bc_ex=lambda x: x[0] + 0.2 * x[1], f=0.3, R=1.7)
    return lattice_assembler(P, nx, ny, forms=forms)


def compare_lattice_kernels(P, asm, device, timed: bool, tol_solve: float = LATTICE_TOL) -> dict:
    """K16–K18 (and the kernels their routes share) against their plain
    versions on the inputs the DCT executor gives them, on the card.

    Grid route: K1, K17's assembly and stencil, K5; general route: K8a, K9's
    bifurcation system, K6's class weights, K18, K8b.  Then K16: the factor,
    the forward and inverse transforms, one transform solve, one unrefined
    direct pass (no refinement pass, which would hide an error) — all at
    ``TOL`` — and the refined solve at ``tol_solve``, each times the scale."""
    from networks_fenicsx_tpu_torch import lattice
    from networks_fenicsx_tpu_torch.kernels import (
        backsub, condense, dct_lattice as K16, edge_data, expand, grid_core, peel, segsum,
        shift_matvec,
    )
    from networks_fenicsx_tpu_torch.solver import _GridExecutor, build_schur_executor

    ex = build_schur_executor(asm, P.SolverOptions(schur_method="dct"), device=device)
    grid = isinstance(ex, _GridExecutor)
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    Rm, fm, f_zero = asm.coefficient_modes()
    N, k, h = ex._N, ex._k, ex._h_e
    gen = torch.Generator(device=device).manual_seed(1)
    runs, timed_runs, library = {}, {}, {}
    if grid:
        gdp, op = ex.device_plan, ex.operator
        c_args = (N, k, h, R, f, Rm, fm, sp, ep)
        W, w, g, Ftot, const = condense.condense_plain(gdp.plan, *c_args)
        rhs, diag, _ = grid_core.grid_core_plain(gdp, w, const, Ftot)
        lam_any = torch.randn(op.B, generator=gen, dtype=torch.float64, device=device)

        def res_kernel(lam):
            return grid_core.grid_residual(gdp, w, diag, lam, rhs)

        def res_plain(lam):
            return grid_core.grid_residual_plain(gdp, w, diag, lam, rhs)

        runs["condense"] = (lambda: condense.condense(gdp, *c_args),
                            lambda: condense.condense_plain(gdp.plan, *c_args), TOL)
        runs["grid_core"] = (lambda: grid_core.grid_core(gdp, w, const, Ftot),
                             lambda: grid_core.grid_core_plain(gdp, w, const, Ftot), TOL)
        runs["grid_core_stencil"] = (
            lambda: grid_core.grid_residual(gdp, w, diag, lam_any, rhs, norm=True),
            lambda: grid_core.grid_residual_plain(gdp, w, diag, lam_any, rhs, norm=True), TOL)
        w_edges = w
    else:
        dlp, op = ex.device_plan, ex.operator
        e_args = (dlp, N, k, h, ex._quad_w, ex._quad_phi, R, f, Rm, fm, f_zero, sp, ep)
        ed = edge_data.edge_data_plain(*e_args)
        dr, w_edges, _ = peel.lambda_system_plain(dlp, ed)
        n_cls = dlp.offsets.size
        cw = lattice._shift_class_weights(w_edges, dlp.class_idx, n_cls, segsum.segsum_plain)
        rhs = dr[:, 1].contiguous()
        lam_any = torch.randn(op.B, generator=gen, dtype=torch.float64, device=device)
        diag_v, rhs_v = dr[:, 0], dr[:, 1]  # strided views, as the DCT route passes them

        def res_kernel(lam):
            return shift_matvec.shift_matvec(dlp.shift, cw, diag_v, lam, rhs_v)

        def res_plain(lam):
            return shift_matvec.shift_matvec_plain(dlp.offsets, cw, diag_v, lam, rhs_v)

        runs["edge_data"] = (lambda: edge_data.edge_data(*e_args),
                             lambda: edge_data.edge_data_plain(*e_args), TOL)
        if k == 1 or edge_data.edge_layout(k, Rm, fm) != "general":  # K8a: the plain arithmetic
            got = edge_data.edge_data(*e_args)
            assert all(torch.equal(a, b) for a, b in zip(float_tensors(got), float_tensors(
                edge_data.edge_data_plain(*e_args)))), "K8a bits"
        runs["lambda_system"] = (lambda: peel.lambda_system(dlp, ed),
                                 lambda: peel.lambda_system_plain(dlp, ed), TOL)
        runs["segsum"] = (  # the class weights' planned launch, as the executor issues it
            lambda: segsum.segsum_plan(dlp.class_sums, w_edges)[0].view(n_cls, -1),
            lambda: lattice._shift_class_weights(w_edges, dlp.class_idx, n_cls,
                                                 segsum.segsum_plain), TOL)
        runs["shift_matvec"] = (  # one launch, as the route's final residual
            lambda: shift_matvec.shift_matvec(dlp.shift, cw, diag_v, lam_any, rhs_v, norm=True),
            lambda: shift_matvec.shift_matvec_plain(dlp.offsets, cw, diag_v, lam_any, rhs_v,
                                                    norm=True), TOL)
        # the library yardstick: one CSR product with the same Laplacian
        L = lattice_csr(dlp.offsets, cw, dr[:, 0])
        library["shift_matvec"] = lambda: torch.mv(L, lam_any)
    st = K16.factor_plain(op, w_edges)
    spec = K16.transform_plain(op, rhs)
    runs["dct_factor"] = (lambda: K16._factor(op, w_edges), lambda: K16.factor_plain(op, w_edges),
                          TOL)
    runs["dct_forward"] = (lambda: K16.transform(op, rhs), lambda: K16.transform_plain(op, rhs),
                           TOL)
    runs["dct_inverse"] = (lambda: K16.transform(op, spec, inverse=True),
                           lambda: K16.transform_plain(op, spec, inverse=True), TOL)
    runs["dct_lplus"] = (lambda: K16._lplus(op, st, rhs), lambda: K16.lplus_plain(op, st, rhs), TOL)
    runs["dct_lattice_unrefined"] = (
        lambda: K16.dct_lattice(op, w_edges, rhs, res_kernel, n_refine=0),
        lambda: K16.dct_lattice_plain(op, w_edges, rhs, res_plain, n_refine=0), TOL)
    runs["dct_lattice"] = (lambda: K16.dct_lattice(op, w_edges, rhs, res_kernel),
                           lambda: K16.dct_lattice_plain(op, w_edges, rhs, res_plain), tol_solve)
    lam = K16.dct_lattice_plain(op, w_edges, rhs, res_plain)
    if grid:
        x_args = (N, k, lam, sp, ep, W, w, g, Ftot, h, R, f, Rm, fm)
        runs["expand"] = (lambda: expand.expand(gdp, *x_args),
                          lambda: expand.expand_plain(gdp.plan, *x_args), TOL)
        # K17 is timed on its assembly; the stencil's time is recorded beside it
        timed_runs["grid_core_stencil"] = (
            lambda: grid_core.grid_residual(gdp, w, diag, lam_any, rhs),
            lambda: grid_core.grid_residual_plain(gdp, w, diag, lam_any, rhs))
        L = lattice_csr_grid(gdp, w, diag)
        library["grid_core_stencil"] = lambda: torch.mv(L, lam_any)
    else:
        runs["backsub"] = (lambda: backsub.backsub(ed, lam, N, k),
                           lambda: backsub.backsub_plain(ed, lam, N, k), TOL)
    # K16 is timed alone: its refinement residuals are fixed tensors here
    fixed = res_plain(lam)
    timed_runs["dct_lattice"] = (lambda: K16.dct_lattice(op, w_edges, rhs, lambda _: fixed),
                                 lambda: K16.dct_lattice_plain(op, w_edges, rhs, lambda _: fixed))
    library["dct_lattice"] = lambda: [K16.lplus_plain(op, st, rhs) for _ in range(1 + K16.N_REFINE)]

    # bytes and float64 operations of the timed calls: K16 reads the DCT
    # matrices, eigenvalues, stub columns, rhs and the two refinement
    # residuals and writes λ; its four products per pass are 4·ny·s·(ny + s)
    # matrix operations, the stub correction (2r + 3)·B; K17's assembly reads
    # three (E,) vectors and writes two grids (~12 operations a node), its
    # stencil ~10 a node; K18 (2 + 2C) a row
    B, n_pass = op.B, 1 + K16.N_REFINE
    stub_tables = (op.stub_rows, op.stub_edge, op.stub_group)
    work = {
        "dct_lattice": (tensor_bytes(op.Dx, op.Dy, op.lamx, op.lamy, op.g_geo, stub_tables)
                        + 8 * (2 + op.stub_edge.numel()) + 8 * B * (2 + K16.N_REFINE),
                        n_pass * (2 * op.r + 3) * B + 5 * B + op.r * B,
                        n_pass * 4 * op.ny * op.s * (op.ny + op.s)),
    }
    if grid:
        work["grid_core"] = (tensor_bytes(w, const, Ftot, gdp.stub_rows, gdp.stub_s_bif)
                             + 16 * B + 8, 12 * B)
        work["grid_core_stencil"] = (tensor_bytes(w, diag, lam_any, rhs) + 8 * B, 10 * B)
    else:
        work["shift_matvec"] = (tensor_bytes(cw, dr, lam_any) + 8 * B + 4 * n_cls,
                                (2 + 2 * n_cls) * B)
    record = {"route": "grid" if grid else "general", "s": op.s, "ny": op.ny, "r": op.r}
    if grid:
        record["streams"] = lattice_stream_checks(gdp, op, w, diag, rhs, lam_any, device)
    else:
        record["streams"] = shift_stream_checks(dlp.shift, cw, diag_v, rhs_v, lam_any)
    for name, (kernel, plain, tol) in runs.items():
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        assert err <= tol * scale, (name, err, scale, tol)
        record[name] = {"max_abs_err": err, "scale": scale}
        if timed and name in work:
            kernel, plain = timed_runs.get(name, (kernel, plain))
            record[name]["ms"] = cuda_ms(kernel, reps=10)
            record[name]["plain_ms"] = cuda_ms(plain, reps=5)
            record[name].update(bound(*work[name]))
            if name in library:
                record[name]["library_ms"] = cuda_ms(library[name], reps=10)
    if timed and not grid:  # the refinement residual, K18 without its norm
        record["shift_matvec"]["residual_ms"] = cuda_ms(lambda: res_kernel(lam_any), reps=10)
    return record


def shift_stream_checks(plan, cw, diag, rhs, lam_any) -> dict:
    """K18 with its norm: one launch a call; two calls back to back give
    equal bits, calls on two streams at once the bits of the calls alone
    (each stream has its own partials and ticket), and a call captured into
    a CUDA graph replays to the same bits (the ticket is reset inside the
    launch).  Raises on any difference."""
    from networks_fenicsx_tpu_torch.kernels import shift_matvec

    lams = (lam_any, torch.flip(lam_any, (0,)).contiguous())
    before = shift_matvec.shift_matvec.launches
    want = [shift_matvec.shift_matvec(plan, cw, diag, lam, rhs, norm=True) for lam in lams]
    assert shift_matvec.shift_matvec.launches == before + 2, "shift_matvec: one launch a call"
    again = shift_matvec.shift_matvec(plan, cw, diag, lams[0], rhs, norm=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, want[0])), "shift_matvec: repeat calls differ"
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    for order in (streams, streams[::-1]):
        got = []
        for st, lam in zip(order, lams):
            with torch.cuda.stream(st):
                got.append([shift_matvec.shift_matvec(plan, cw, diag, lam, rhs, norm=True)
                            for _ in range(3)])
        torch.cuda.synchronize()
        for runs, ref in zip(got, want):
            assert all(torch.equal(a, b) for run in runs for a, b in zip(run, ref)), \
                "shift_matvec: two streams differ from the calls alone"
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = shift_matvec.shift_matvec(plan, cw, diag, lams[1], rhs, norm=True)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, want[1])), \
            "shift_matvec: a graph replay differs"
    del graph
    return {"shift_matvec_streams": "bit for bit", "shift_matvec_repeat": "bit for bit",
            "shift_matvec_graph_replays": 3, "shift_matvec_launches_a_normed_call": 1}


def lattice_stream_checks(gdp, op, w, diag, rhs, lam_any, device) -> dict:
    """K17 and K16 on two streams at once and repeated: each stream has its
    own scratch (K17's partials and ticket, K16's transform grids and border
    partials), so the calls keep the bits of the same calls alone; two K17
    calls back to back give equal bits, and a K17 call captured into a CUDA
    graph replays to the same bits (its ticket is reset inside the launch).
    Raises on any difference."""
    from networks_fenicsx_tpu_torch.kernels import dct_lattice as K16, grid_core

    lams = (lam_any, torch.flip(lam_any, (0,)).contiguous())
    want = [grid_core.grid_residual(gdp, w, diag, lam, rhs, norm=True) for lam in lams]
    again = grid_core.grid_residual(gdp, w, diag, lams[0], rhs, norm=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, want[0])), "grid_core: repeat calls differ"

    def solve(b):
        return K16.dct_lattice(op, w, b, lambda lam: grid_core.grid_residual(gdp, w, diag, lam, b))

    rhs2 = (rhs, (rhs + lam_any).contiguous())
    want_solve = [solve(b) for b in rhs2]
    torch.cuda.synchronize()
    streams = torch.cuda.Stream(device), torch.cuda.Stream(device)
    for order in (streams, streams[::-1]):
        got, got_solve = [], []
        for st, lam, b in zip(order, lams, rhs2):
            with torch.cuda.stream(st):
                got.append([grid_core.grid_residual(gdp, w, diag, lam, rhs, norm=True)
                            for _ in range(3)])
                got_solve.append(solve(b))
        torch.cuda.synchronize()
        for runs, ref in zip(got, want):
            assert all(torch.equal(a, b) for run in runs for a, b in zip(run, ref)), \
                "grid_core: two streams differ from the calls alone"
        for x, ref in zip(got_solve, want_solve):
            assert torch.equal(x, ref), "dct_lattice: two streams differ from the solves alone"
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = grid_core.grid_residual(gdp, w, diag, lams[1], rhs, norm=True)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, want[1])), \
            "grid_core: a graph replay differs"
    del graph
    return {"grid_core_streams": "bit for bit", "grid_core_repeat": "bit for bit",
            "grid_core_graph_replays": 3, "dct_lattice_streams": "bit for bit"}


def product_ragged_checks(device) -> dict:
    """K16's product kernel against ``torch.matmul`` at ``TOL``·scale on
    ragged shapes, plain and transposed, scaled and not (the 5000² product
    against a 5000 × 3 input is the wide lattice's)."""
    from networks_fenicsx_tpu_torch.kernels import dct_lattice as K16

    gen = torch.Generator(device=device).manual_seed(16)
    rec = {}
    for M, N, K in ((3, 3, 3), (66, 66, 66), (517, 300, 300), (300, 517, 517), (3, 5000, 5000)):
        for tA, tB in ((False, False), (True, False), (False, True), (True, True)):
            A = torch.randn((K, M) if tA else (M, K), generator=gen, dtype=torch.float64,
                            device=device)
            B = torch.randn((N, K) if tB else (K, N), generator=gen, dtype=torch.float64,
                            device=device)
            S = torch.randn((M, N), generator=gen, dtype=torch.float64, device=device)
            for scaled in (False, True):
                got = K16.product(A, B, tA, tB, S if scaled else None)
                want = K16.product_plain(A, B, tA, tB, S if scaled else None)
                torch.cuda.synchronize()
                err, scale = max_err(got, want)
                assert err <= TOL * scale, ("dct_product", (M, N, K, tA, tB, scaled), err, scale)
                key = f"{M}x{N}x{K}"
                prev = rec.get(key, {"max_abs_err": 0.0, "scale": 1.0})
                rec[key] = {"max_abs_err": max(prev["max_abs_err"], err),
                            "scale": max(prev["scale"], scale),
                            "split": K16.gemm_plan(M, N, K, torch.cuda.get_device_properties(
                                device).multi_processor_count)}
    return {"max_abs_err": max(r["max_abs_err"] for r in rec.values()),
            "scale": max(r["scale"] for r in rec.values()), "shapes": rec}


def lattice_csr(offsets, cw, diag):
    """The bifurcation Laplacian of the shift classes as a CSR tensor: the
    sparse-product yardstick of K17's stencil and K18."""
    B = diag.shape[0]
    i = torch.arange(B, device=diag.device)
    rows, cols, vals = [i], [i], [diag]
    for c, d in enumerate(np.asarray(offsets).tolist()):
        j = i + int(d)
        keep = (j >= 0) & (j < B)
        rows.append(i[keep])
        cols.append(j[keep])
        vals.append(-cw[c][keep])
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    with warnings.catch_warnings():  # sparse CSR is "beta" in PyTorch
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(idx, torch.cat(vals), (B, B), check_invariants=True)
        return coo.coalesce().to_sparse_csr()


def lattice_csr_grid(gdp, w, diag):
    """The grid route's Laplacian as a CSR tensor (see :func:`lattice_csr`)."""
    nx, ny = gdp.nx, gdp.ny
    Ex, Ey = ny * (nx - 1), (ny - 1) * nx
    B = nx * ny
    cw = torch.zeros((4, B), dtype=torch.float64, device=w.device)
    wx = w[:Ex].reshape(ny, nx - 1)
    wy = w[Ex:Ex + Ey].reshape(ny - 1, nx)
    cw[0].view(ny, nx)[1:, :] = wy  # offset -nx
    cw[1].view(ny, nx)[:, 1:] = wx  # offset -1
    cw[2].view(ny, nx)[:, :-1] = wx  # offset +1
    cw[3].view(ny, nx)[:-1, :] = wy  # offset +nx
    return lattice_csr(np.array([-nx, -1, 1, nx]), cw, diag)


def inlet_outlet(asm, x: np.ndarray, source=None) -> float:
    """|q out of the outlet stub − q into the inlet stub − ∫f|: zero by mass
    balance.  ∫f over the network of a ``source`` linear in x is exact as
    the edge lengths times f at the edge midpoints."""
    mesh = asm.network
    base = asm._edge_flux_base
    q_start = x[base]
    q_end = x[base + asm._dofs_per_edge - 1]
    edges = np.asarray(mesh.edges)
    B = mesh.num_multipliers
    inlet = int(np.flatnonzero(edges[:, 0] == B)[0])
    outlet = int(np.flatnonzero(edges[:, 1] == B + 1)[0])
    src = 0.0
    if source is not None:
        mid = 0.5 * (mesh.vertices[edges[:, 0]] + mesh.vertices[edges[:, 1]])
        src = float(np.sum(np.asarray(mesh.edge_length) * source(mid.T)))
    return float(abs(q_end[outlet] - q_start[inlet] - src))


def lattice_main_path(P, device, label: str, build, options, route: str, source=None) -> dict:
    """A lattice solve through the public API, counted and checked: the
    grid or general DCT executor, only its kernels launched, the sizes of
    the reference's 512² stage, relative λ residual ≤ 1e-10, converged,
    mass conserved at every junction and between inlet and outlet, equal to
    the plain path on the card at ``LATTICE_TOL``."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.lattice import _GridPlan
    from networks_fenicsx_tpu_torch.solver import _DctExecutor, _GridExecutor, _flatten_blocks_host

    t0 = time.perf_counter()
    asm = build()
    mesh = asm.network
    solver = P.Solver(asm, options=options, device=device)
    sizes = {"edges": mesh.num_edges, "bifurcations": mesh.num_multipliers, "dofs": asm.num_dofs}
    for key, want in LATTICE_SIZES.items():
        assert sizes[key] == want, (key, sizes[key], want)
    log(f"phase {label}: set-up {time.perf_counter() - t0:.3f} s, {sizes['edges']} edges, "
        f"{sizes['bifurcations']} bifurcations, {sizes['dofs']} dofs")

    torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    kernels.reset_launches()
    sol = solver.solve()
    torch.cuda.synchronize()
    launches = kernels.launches()
    first_s = time.perf_counter() - t1
    peak_mb = torch.cuda.max_memory_allocated(device) / 2**20
    ex = solver._executor
    if route == "grid":
        assert isinstance(ex, _GridExecutor) and isinstance(ex.blocked_plan, _GridPlan), type(ex)
        used = ("condense", "grid_core", "dct_lattice", "expand")
    else:
        assert isinstance(ex, _DctExecutor), type(ex)
        used = ("edge_data", "lambda_system", "segsum", "dct_lattice", "shift_matvec", "backsub")
    assert all(launches[name] >= 1 for name in used), launches
    assert all(n == 0 for name, n in launches.items() if name not in used), launches

    info = solver.info
    x = solver.solution_vector()
    assert info.converged and info.iterations == 0, info
    rel_res = info.residual / float(ex(*ex.prepare_args(*asm.schur_arguments()))[5])
    assert rel_res <= 1e-10, rel_res
    assert x.shape == (asm.num_dofs,) and np.all(np.isfinite(x))
    assert sum(fn.values.size for fn in sol) == asm.num_dofs
    imbalance, qmax = conservation(asm, x)
    assert imbalance <= 1e-10 * qmax, (imbalance, qmax)
    # the inlet-outlet balance is the sum of all B junction imbalances, so its
    # float64 floor sits above the per-junction one: 1.3e-10·max |q| at 512²
    # on the card; 1e-9 leaves a margin of about 7 and no more
    io_bar = 1e-9
    through = inlet_outlet(asm, x, source)
    assert through <= io_bar * qmax, (through, qmax, io_bar)

    out = ex.plain(*ex.prepare_args(*asm.schur_arguments()))
    x_plain = _flatten_blocks_host(
        out[0].cpu().numpy(), out[1].cpu().numpy(), out[2].cpu().numpy(), mesh.edge_color,
        edge_order=ex.edge_order, bif_order=ex.bif_order,
    )
    err = float(np.abs(x - x_plain).max())
    scale = max(1.0, float(np.abs(x_plain).max()))
    assert err <= LATTICE_TOL * scale, (err, scale)
    log(f"phase {label}: {route} route, {type(ex).__name__}, first solve (executor build + "
        f"solve) {first_s:.3f} s, relative λ residual {rel_res:.3e}, converged, finite, "
        f"conservation {imbalance:.3e}, inlet-outlet balance {through:.3e} "
        f"({through / qmax:.3e} of max |q| {qmax:.3e}, bar {io_bar:.3e}), "
        f"vs plain path {err:.3e} (scale {scale:.3e}), peak device memory {peak_mb:.1f} MiB, "
        f"launches {launches}")
    return {"asm": asm, "solver": solver, "launches": launches, "sizes": sizes,
            "rel_res": rel_res}


def lattice_timing(P, state: dict, forms, label: str, name_power: str) -> dict:
    """compute_forms + solve best of 5 on the host clock, CUDA-synchronised;
    device time per solve for the kernels and the plain versions; wrapper
    calls per solve (the CUDA kernels per solve are counted by the profiler
    of ``scripts/profile_torch_main_path.py``)."""
    asm, solver = state["asm"], state["solver"]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forms(asm)
        solver.solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ex = solver._executor
    args = ex.prepare_args(*asm.schur_arguments())
    dev_ms = cuda_ms(lambda: ex(*args), reps=5)
    plain_ms = cuda_ms(lambda: ex.plain(*args), reps=3)
    wrapper_launches = sum(state["launches"].values())
    log(f"phase timing {label}: compute_forms+solve best {min(times):.3f} ms "
        f"(all {[round(t, 3) for t in times]}); device per solve (upload + kernels) "
        f"{dev_ms:.3f} ms, plain versions {plain_ms:.3f} ms; launches per solve "
        f"{wrapper_launches} wrapper calls; card {name_power}")
    return {"best_ms": min(times), "device_ms": dev_ms, "plain_ms": plain_ms}


def lattice_phases(P, device, name_power: str) -> dict:
    """The lattice slice: kernels-lattice sets (a)–(d2), then the 512² main
    paths under ``schur_method="dct"`` and ``auto`` (grid route) and with a
    callable source (general DCT route)."""
    lat = {}
    lat["a"] = compare_lattice_kernels(P, lattice_assembler(P), device, timed=True)
    log("phase kernels-lattice (a) 512^2 lattice, N=1, k=1, R=1, f=0, grid route: "
        + json.dumps(lat["a"]))
    lat["b"] = compare_lattice_kernels(P, lattice_small(P), device, timed=False)
    log("phase kernels-lattice (b) 9x4 lattice, N=2, k=3, cell f, R=2.5, grid route: "
        + json.dumps(lat["b"]))
    lat["c"] = compare_lattice_kernels(
        P, lattice_assembler(P, forms=lattice_callable_forms), device, timed=True)
    log("phase kernels-lattice (c) 512^2 lattice, callable f = x + 0.3y, general route: "
        + json.dumps(lat["c"]))
    from networks_fenicsx_tpu_torch.kernels import dct_lattice
    from networks_fenicsx_tpu_torch.lattice import _dct2_matrix_device

    wide = lattice_wide(P)
    n_long = 5000
    bar = max(1e-10, 256 * n_long**2 * float(np.finfo(np.float64).eps))
    lat["d"] = compare_lattice_kernels(P, wide, device, timed=False, tol_solve=bar)
    D, D_plain = dct_lattice.dct_matrix(n_long, device), _dct2_matrix_device(n_long, device)
    torch.cuda.synchronize()
    err, scale = max_err(D, D_plain)
    assert err <= TOL * scale, ("dct_matrix", err, scale)
    lat["d"]["dct_matrix"] = {"max_abs_err": err, "scale": scale}
    log(f"phase kernels-lattice (d) 5000x3 lattice, f=0.3, R=1.7, device DCT matrices "
        f"(bar {bar:.3e}): " + json.dumps(lat["d"]))
    lat["d"]["dct_product"] = product_ragged_checks(device)
    log("phase kernels-lattice (d') K16's product kernel on ragged shapes vs torch.matmul: "
        + json.dumps(lat["d"]["dct_product"]))
    del wide, D, D_plain
    n_long = 4200
    bar = max(1e-10, 256 * n_long**2 * float(np.finfo(np.float64).eps))
    lat["d2"] = compare_lattice_kernels(P, lattice_wide(P, 3, n_long), device, timed=False,
                                        tol_solve=bar)
    log(f"phase kernels-lattice (d2) 3x4200 lattice, f=0.3, R=1.7, device DCT matrix of the "
        f"long side (bar {bar:.3e}): " + json.dumps(lat["d2"]))
    routes = [lat[c]["route"] for c in LATTICE_SETS]
    assert routes == ["grid", "grid", "general", "grid", "grid"], lat

    paths = {}
    paths["dct"] = lattice_main_path(P, device, "lattice main path (schur_method='dct')",
                                     lambda: lattice_assembler(P),
                                     P.SolverOptions(schur_method="dct"), "grid")
    lattice_timing(P, paths["dct"], lattice_forms, "lattice (dct)", name_power)
    del paths["dct"]["asm"], paths["dct"]["solver"]
    paths["auto"] = lattice_main_path(P, device, "lattice main path (auto)",
                                      lambda: lattice_assembler(P), P.SolverOptions(), "grid")
    lattice_timing(P, paths["auto"], lattice_forms, "lattice (auto)", name_power)
    auto = (paths["auto"].pop("asm"), paths["auto"].pop("solver").solution_vector())

    paths["general"] = lattice_main_path(
        P, device, "lattice general-route main path",
        lambda: lattice_assembler(P, forms=lattice_callable_forms), P.SolverOptions(), "general",
        source=lattice_source)
    lattice_timing(P, paths["general"], lattice_callable_forms, "lattice (general)", name_power)
    del paths["general"]["asm"], paths["general"]["solver"]
    return {"sets": lat, "paths": paths, "auto": auto}


def dense_core_guards(device) -> dict:
    """What the dataflow solves and the panel launches of K11's factor
    need beside set (j): a core that is not positive definite (the seeded
    Laplacian without its diagonal excess, less 0.1 % of its diagonal:
    singular and then indefinite, so that a pivot's square root is NaN and
    the gate trips whatever the roundoff) at 455 and 4,096 nodes, kernel
    and plain version both all NaN and the solves finishing; calls of one
    stream back to back and of different n in turn giving identical bits
    (the solves' epoch flags, the panels' atomic count), and so calls on two
    streams at once (each stream's solve state); a call under CUDA-graph
    capture refused; the launches of a
    call (``cuda_launches``) within the budget, 40 at 455 and 160 at 4,096."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    record = {}
    for n in (455, K11_TIMED):
        ci, cj, pid, dc, rc, w = spd_laplacian(n, device, seed=n)
        ds = torch.zeros_like(dc).index_add_(0, ci.long(), w).index_add_(0, cj.long(), w)
        ds = ds - 1e-3 * ds
        got = dense_core.dense_core(ci, cj, pid, ds, rc, w)
        torch.cuda.synchronize()
        want = dense_core.dense_core_plain(ci, cj, pid, ds, rc, w)
        assert bool(torch.isnan(got).all()) and bool(torch.isnan(want).all()), n
        record[f"indefinite_{n}_all_nan"] = True
    runs = {n: spd_laplacian(n, device, seed=n) for n in (455, K11_TIMED)}
    first = {n: dense_core.dense_core(*args) for n, args in runs.items()}
    again = [dense_core.dense_core(*runs[n]) for n in (455, K11_TIMED, 455, 455, K11_TIMED)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, first[n]) for x, n in zip(again, (455, K11_TIMED, 455, 455, K11_TIMED)))
    record["back_to_back_equal"] = True
    record["two_streams_equal"] = two_stream_dense_cores(runs, first)
    record["capture_refused"] = capture_refused(runs[455])
    for n, budget in ((455, 40), (K11_TIMED, 160)):
        record[f"cuda_launches_{n}"] = dense_core.cuda_launches(n, int(runs[n][0].shape[0]))
        assert record[f"cuda_launches_{n}"] <= budget, (n, record[f"cuda_launches_{n}"])
    return record


def two_stream_dense_cores(runs: dict, first: dict) -> bool:
    """K11 calls on two streams at once, a 4,096-node call on one beside
    455-node calls on the other, in both orders: each stream's solves keep
    their own ticket counter and flags, so every result has the bits of the
    same call alone."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    streams = torch.cuda.Stream(), torch.cuda.Stream()
    for big, small in (streams, streams[::-1]):
        torch.cuda.synchronize()
        with torch.cuda.stream(big):
            a = dense_core.dense_core(*runs[K11_TIMED])
        with torch.cuda.stream(small):
            b = [dense_core.dense_core(*runs[455]) for _ in range(3)]
        torch.cuda.synchronize()
        assert torch.equal(a, first[K11_TIMED]) and all(torch.equal(x, first[455]) for x in b)
    return True


def capture_refused(args) -> bool:
    """K11 under CUDA-graph capture raises (cudaErrorStreamCaptureUnsupported,
    900) instead of capturing solves whose replays would reuse their epoch."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            dense_core.dense_core(*args)
    except RuntimeError as err:
        assert "CUDA error 900" in str(err), err
    else:
        raise AssertionError("dense_core was captured into a CUDA graph")
    del graph
    torch.cuda.synchronize()
    return True


def core_phases(P, device, name_power: str) -> dict:
    """The mid-size cycle-core slice: kernels-core sets (f)–(i) and the
    web48 golden's forced plans, set (j) K11 alone, the web2k and 64²
    lattice main paths, and the forced paths that run K12b and the forced
    web48 plans end to end."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    core = {}
    core["f"] = compare_core_kernels(P, web2k_assembler(P), device, timed=True,
                                     expect={k: WEB2K_SIZES[k] for k in BED4_SIZES}, before="web2k")
    web2k_case = core["f"].pop("_case")
    k12a = core["f"]["core_elim"]
    assert k12a["launch_grid"] == 0, k12a  # one block
    assert k12a["cuda_launches"] == CORE_LAUNCHES + dense_core.cuda_launches(
        WEB2K_SIZES["dense_tail"], int(web2k_case[0].dp_init.shape[0])), k12a
    log("phase kernels-core (f) web2k, N=1, edge R, min-degree rounds + dense tail 628: "
        + json.dumps(core["f"]))
    core["g"] = compare_core_kernels(P, bed_assembler(P, 4, 32, 20, N=1), device, timed=False,
                                     expect=BED4_SIZES)
    core["g"].pop("_case")
    log("phase kernels-core (g) bed (4, 32, 20), N=1, R=1/r^4: " + json.dumps(core["g"]))
    grid = grid128_assembler(P)
    t0 = time.perf_counter()
    plan_h = nd_tree_plan(P, grid, **ND_KWARGS)
    t_h = time.perf_counter() - t0
    core["h"] = compare_core_kernels(P, grid, device, timed=True, tree_plan=plan_h,
                                     expect=GRID128_ND_SIZES)
    core["h"].pop("_case")
    log(f"phase kernels-core (h) 128^2 edge-R lattice, ND plan (host planning {t_h:.3f} s), "
        "dense tail 7,583: " + json.dumps(core["h"]))
    t0 = time.perf_counter()
    plan_i = nd_tree_plan(P, grid, **FRONTS_KWARGS)
    t_i = time.perf_counter() - t0
    core["i"] = compare_core_kernels(P, grid, device, timed=True, tree_plan=plan_i,
                                     expect=GRID128_FRONTS_SIZES, before="fronts128")
    fronts_case = core["i"].pop("_case")
    assert core["i"]["core_elim"]["launch_grid"] > 0, core["i"]["core_elim"]  # a cooperative grid
    log(f"phase kernels-core (i) 128^2 edge-R lattice, forced fronts (host planning {t_i:.3f} s): "
        + json.dumps(core["i"]))
    grid40 = grid_assembler(P, 40)
    core["grid40-fronts"] = compare_core_kernels(
        P, grid40, device, timed=False, tree_plan=nd_tree_plan(P, grid40, **FRONTS_40_KWARGS))
    core["grid40-fronts"].pop("_case")
    log("phase kernels-core 40^2 edge-R lattice, forced fronts of 37 pivots (a w < m front whose "
        "panel ends inside its first tile): " + json.dumps(core["grid40-fronts"]))
    web48 = golden_web48(P)
    for key, plan in forced_plans_web48(P, web48).items():
        core["web48-" + key] = compare_core_kernels(P, web48, device, timed=False, tree_plan=plan)
        core["web48-" + key].pop("_case")
        log(f"phase kernels-core web48 golden, forced {key} plan: " + json.dumps(core["web48-" + key]))

    k11 = compare_dense_sizes(device, timed=True)
    log("phase kernels-dense (j) K11 alone on seeded SPD Laplacians: "
        + json.dumps({str(n): rec for n, rec in k11.items()}))
    guards = dense_core_guards(device)
    log("phase kernels-dense (j) K11's gate, repeat bits and launch budget: " + json.dumps(guards))

    paths = {}
    paths["web2k"] = cyclic_main_path(P, device, "web2k main path", lambda: web2k_assembler(P),
                                      WEB2K_SIZES)
    cyclic_timing(P, paths["web2k"], web2k_forms, "web2k", name_power)
    del paths["web2k"]["asm"], paths["web2k"]["solver"]
    paths["lattice64"] = cyclic_main_path(P, device, "lattice64 main path",
                                          lambda: lattice_assembler(P, 64, 64), LATTICE64_SIZES,
                                          attach=False)
    cyclic_timing(P, paths["lattice64"], lattice_forms, "lattice64", name_power)
    del paths["lattice64"]["asm"], paths["lattice64"]["solver"]
    paths["fronts"] = forced_core_path(P, device, "128^2 forced-fronts path", grid, plan_i,
                                       GRID128_FRONTS_SIZES, name_power)
    for key, plan in forced_plans_web48(P, web48).items():
        paths["web48-" + key] = forced_core_path(P, device, f"web48 forced {key} path", web48, plan,
                                                 {}, name_power)
    return {"sets": core, "k11": k11, "k11_guards": guards, "paths": paths,
            "launch_cases": {"web2k": web2k_case, "fronts128": fronts_case},
            "fronts128": (grid, plan_i)}


def cg512_forms(asm) -> None:
    """Per-edge R from ``default_rng(7)``, f = 0, p_bc = x
    (``tests/test_krylov.py:214-223``)."""
    R = np.random.default_rng(7).uniform(0.5, 2.0, asm.network.num_edges)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)


def skinny_forms(asm) -> None:
    """Per-edge R from ``default_rng(4)``, f = 0, p_bc = y (``tests/test_krylov.py:185-189``)."""
    R = np.random.default_rng(4).uniform(0.5, 2.0, asm.network.num_edges)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)


def cg_used(ex) -> set:
    """The wrappers a CG executor launches: its λ system (K9 on K6's sums) and
    back-substitution, K19a, the matvec (K18 or K19b) and the
    preconditioner's kernels."""
    used = {"edge_data", "lambda_system", "segsum", "backsub", "krylov"}
    used |= {"gather_matvec"} if ex.device_plan.classes is None else {"shift_matvec"}
    used |= {"2d": {"mg2d"}, "1d": {"mg1d", "mg2d"}}.get(ex.precond_kind[0], set())
    return used


def cg_sizes(ex, asm) -> dict:
    mesh, plan = asm.network, ex.precond_plan
    sizes = {"edges": mesh.num_edges, "bifurcations": mesh.num_multipliers, "dofs": asm.num_dofs,
             "precond": ex.precond_kind[0]}
    if ex.precond_kind[0] == "2d":
        sizes["levels"], sizes["bottom"] = len(plan.shapes), tuple(plan.bottom)
    elif ex.precond_kind[0] == "1d":
        sizes["levels"], sizes["bottom"] = len(plan.levels), plan.m_bottom
    return sizes


def cg_path(P, device, label: str, build, options, expect: dict, lattice: bool = False,
            max_iters: int | None = None) -> dict:
    """A CG solve through the public API, counted and checked: the CG
    executor, only its kernels launched, the expected sizes and
    preconditioner, converged, kernel-path iterations within 1 of the plain
    path's and the solution at ``CG_TOL``·scale of it, mass conserved at
    every junction to the bound the λ residual implies (a junction's
    imbalance is its row of Lλ − rhs) and, on a lattice, between inlet and
    outlet at 1e-9·max|q|; the host reads of the done flag per solve."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.ops import krylov as cg_loop
    from networks_fenicsx_tpu_torch.solver import _CgExecutor, _flatten_blocks_host

    t0 = time.perf_counter()
    asm = build()
    solver = P.Solver(asm, options=options, device=device)
    log(f"phase {label}: set-up {time.perf_counter() - t0:.3f} s, {asm.network.num_edges} edges, "
        f"{asm.network.num_multipliers} bifurcations, {asm.num_dofs} dofs")
    torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    kernels.reset_launches()
    cg_loop.cg.flag_reads = 0
    sol = solver.solve()
    torch.cuda.synchronize()
    launches = kernels.launches()
    reads = cg_loop.cg.flag_reads
    first_s = time.perf_counter() - t1
    peak_mb = torch.cuda.max_memory_allocated(device) / 2**20
    ex = solver._executor
    assert isinstance(ex, _CgExecutor), type(ex)
    sizes = cg_sizes(ex, asm)
    for key, want in expect.items():
        assert sizes[key] == want, (key, sizes[key], want)
    used = cg_used(ex)
    assert all(launches[name] >= 1 for name in used), launches
    assert all(n == 0 for name, n in launches.items() if name not in used), launches

    info = solver.info
    x = solver.solution_vector()
    assert info.converged and info.iterations > 0, info
    assert max_iters is None or info.iterations <= max_iters, (info.iterations, max_iters)
    assert x.shape == (asm.num_dofs,) and np.all(np.isfinite(x))
    assert sum(fn.values.size for fn in sol) == asm.num_dofs
    out = ex.plain(*ex.prepare_args(*asm.schur_arguments()))
    it_plain = int(out[3])
    assert abs(info.iterations - it_plain) <= 1, (info.iterations, it_plain)
    x_plain = _flatten_blocks_host(out[0].cpu().numpy(), out[1].cpu().numpy(), out[2].cpu().numpy(),
                                   asm.network.edge_color)
    err = float(np.abs(x - x_plain).max())
    scale = max(1.0, float(np.abs(x_plain).max()))
    assert err <= CG_TOL * scale, (err, scale)
    rhs_norm = float(out[5])
    res_bar = 10 * options.rtol * rhs_norm
    imbalance, qmax = conservation(asm, x)
    assert imbalance <= info.residual + 1e-10 * qmax, (imbalance, info.residual, qmax)
    through = inlet_outlet(asm, x) if lattice else None
    assert through is None or through <= 1e-9 * qmax, (through, qmax)
    io_text = "" if through is None else f", inlet-outlet balance {through / qmax:.3e} of max |q|"
    log(f"phase {label}: {sizes}, {info.iterations} iterations (plain path {it_plain}), first solve "
        f"(executor build + solve) {first_s:.3f} s, λ residual {info.residual:.3e} against "
        f"10·rtol·‖rhs‖ {res_bar:.3e} (gate max(that, 1e-9)), converged, finite, conservation "
        f"{imbalance:.3e} (max |q| {qmax:.3e}){io_text}, vs plain path {err:.3e} (scale "
        f"{scale:.3e}), host flag reads {reads}, peak device memory {peak_mb:.1f} MiB, "
        f"launches {launches}")
    return {"asm": asm, "solver": solver, "launches": launches, "sizes": sizes,
            "iters": info.iterations, "reads": reads, "residual": info.residual,
            "res_bar": res_bar, "imbalance": imbalance, "qmax": qmax, "through": through}


def cg_timing(P, state: dict, forms, label: str, name_power: str) -> dict:
    """compute_forms + solve best of 5 on the host clock, CUDA-synchronised;
    device time per solve for the kernels and the plain versions; wrapper
    launches and host flag reads per solve."""
    asm, solver = state["asm"], state["solver"]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forms(asm)
        solver.solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ex = solver._executor
    args = ex.prepare_args(*asm.schur_arguments())
    dev_ms = cuda_ms(lambda: ex(*args), reps=5)
    plain_ms = cuda_ms(lambda: ex.plain(*args), reps=3)
    log(f"phase timing {label}: compute_forms+solve best {min(times):.3f} ms "
        f"(all {[round(t, 3) for t in times]}); executor per solve (upload + kernels) "
        f"{dev_ms:.3f} ms, plain versions {plain_ms:.3f} ms; {state['iters']} iterations, "
        f"{sum(state['launches'].values())} wrapper calls and {state['reads']} host flag reads "
        f"per solve (chunk {state['chunk']}); card {name_power}")
    return {"best_ms": min(times), "device_ms": dev_ms, "plain_ms": plain_ms}


def cg_system(P, asm, device, options):
    """``(executor, diag, rhs, w_edges, class weights or None)`` of the CG
    executor's λ system, from the plain versions on the card."""
    from networks_fenicsx_tpu_torch.kernels import edge_data, peel, segsum
    from networks_fenicsx_tpu_torch.lattice import _shift_class_weights
    from networks_fenicsx_tpu_torch.solver import _CgExecutor, build_schur_executor

    ex = build_schur_executor(asm, options, device=device)
    assert isinstance(ex, _CgExecutor), type(ex)
    dlp = ex.device_plan
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    Rm, fm, f_zero = asm.coefficient_modes()
    ed = edge_data.edge_data_plain(dlp, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi, R, f, Rm,
                                   fm, f_zero, sp, ep)
    dr, w_edges, _ = peel.lambda_system_plain(dlp, ed)
    cw = None
    if dlp.classes is not None:
        cw = _shift_class_weights(w_edges, dlp.class_idx, dlp.offsets.size, segsum.segsum_plain)
    return ex, dr[:, 0].contiguous(), dr[:, 1].contiguous(), w_edges, cw


def run_checks(runs: dict, record: dict, timed: dict, work: dict, library: dict) -> None:
    """Each ``(kernel, plain, tol)`` of ``runs`` against the other, every
    tensor of a result at ``tol`` times its own scale (a CG state's γ and
    the vectors it updates differ by orders of magnitude); the ``timed``
    ones timed with their bound and library call."""
    for name, (kernel, plain, tol) in runs.items():
        got = float_tensors(kernel())
        want = float_tensors(plain())
        torch.cuda.synchronize()
        assert len(got) == len(want), (name, len(got), len(want))
        parts = [max_err(a, b) for a, b in zip(got, want)]
        for i, (err, scale) in enumerate(parts):
            assert err <= tol * scale, (name, i, err, scale, tol)
        record[name] = {"max_abs_err": max(e for e, _ in parts), "errs": [e for e, _ in parts],
                        "scales": [sc for _, sc in parts], "tol": tol}
    for name, (kernel, plain) in timed.items():
        record[name]["ms"] = cuda_ms(kernel, reps=10)
        record[name]["plain_ms"] = cuda_ms(plain, reps=3)
        record[name].update(bound(*work[name]))
        record[name]["library_ms"] = cuda_ms(library[name], reps=10) if name in library else None


def gather_csr(dlp, w_edges, diag):
    """The gather-fold Laplacian as a CSR tensor: K19b's sparse-product yardstick."""
    B = diag.shape[0]
    i = torch.arange(B, device=diag.device)
    ok = dlp.mv_edge >= 0
    rows = torch.cat([i, i[None, :].expand_as(dlp.mv_edge)[ok]])
    cols = torch.cat([i, dlp.mv_other[ok].long()])
    vals = torch.cat([diag, -w_edges[dlp.mv_edge[ok].long()]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (B, B), check_invariants=True)
        return coo.coalesce().to_sparse_csr()


def cg_jacobi_step(rhs, diag, Ap, plain: bool, maxiter: int = 100, rtol: float = 1e-12):
    """K19a's Jacobi CG iteration (its 3 fused launches; the plain steps with
    ``plain``) on ``Ap`` fixed, from a fresh start on ``rhs``: a closure
    returning the state and the vectors it updates."""
    from networks_fenicsx_tpu_torch.kernels import krylov

    st, part = krylov.new_state(rhs.device), krylov.partials(rhs.shape[0], rhs.device)
    x, r = torch.zeros_like(rhs), rhs.clone()
    p = r / diag
    (krylov.cg_start_plain if plain else krylov.cg_start)(st, rhs, r, p, part, rtol, 0.0, maxiter)
    steps = krylov.CgSteps(st, part, x, r, p, diag, plain=plain)

    def iteration():
        steps.step(Ap)
        steps.direction()
        return st[[0, 1, 2, 3, 5, 6, 7]], x, r, p

    iteration.st = st
    return iteration


def round_robin(make, count: int):
    """Call ``count`` closures ``make()`` in turn, so that each timed call
    takes an early iteration of a state of its own: on a fixed ``Ap``, no
    operator CG can run on, one state grows without bound within tens of
    iterations and then stops (``done``).  ``call.fresh()`` is True while
    none has stopped."""
    closures = [make() for _ in range(count)]
    turn = iter(range(10**12))

    def call():
        return closures[next(turn) % count]()

    call.fresh = lambda: all(bool(c.st[2] == 0) for c in closures)
    return call


def device_launches(counter, fn) -> int:
    """The device kernel launches of one ``fn()`` call, as the launchers
    report them (:func:`krylov_launch_counts` holds these against the
    profiler)."""
    before = counter.device
    fn()
    return counter.device - before


PAD_KERNELS = 8  # padding kernels at each edge of a launch-count window
PAD_PAUSE_S = 0.005  # the pause between the two halves of a window's start padding


def start_padding(op) -> None:
    """A launch-count window's start padding: :data:`PAD_KERNELS` calls of
    ``op`` (a kernel each), a synchronised pause of :data:`PAD_PAUSE_S`,
    and as many calls again.  Where the card's profiler loses records of a
    window it loses the first ones, on some machines all of a first eight
    window after window (PERF.md §7); the second half, after the pause,
    keeps the window able to show it holds its run."""
    for _ in range(2):
        for _ in range(PAD_KERNELS):
            op()
        torch.cuda.synchronize()
        time.sleep(PAD_PAUSE_S)


def counted_window(run, pattern: str, device) -> dict:
    """One ``torch.profiler`` window around ``run()``, with
    padding kernels at each edge (:func:`start_padding`'s ``add_`` before
    it, :data:`PAD_KERNELS` ``mul_`` after it, on a vector of their own):
    ``reported``, what
    ``run()`` returns (its launches as the wrappers report them);
    ``profiled``, the device kernels whose name matches ``pattern``, and
    ``us``, their device µs; ``pad_start`` and ``pad_end``, the padding
    kernels recorded; ``other``, the rest of the device events."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(64, dtype=torch.float64, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start_padding(lambda: pad.add_(1.0))
        reported = run()
        torch.cuda.synchronize()
        for _ in range(PAD_KERNELS):
            pad.mul_(1.0)
        torch.cuda.synchronize()
    out = {"reported": reported, "profiled": 0, "pad_start": 0, "pad_end": 0, "other": 0,
           "us": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("profiled" if re.search(pattern, ev.key)
                else "pad_start" if re.search(r"(?i)add", ev.key)
                else "pad_end" if re.search(r"(?i)mul", ev.key) else "other")
        out[kind] += ev.count
        if kind == "profiled":
            out["us"] += getattr(ev, "device_time_total", 0.0) or 0.0
    return out


def holds_its_run(window: dict) -> bool:
    """Whether ``window`` (:func:`counted_window`) recorded every kernel
    of its run.  Where the card's profiler left records out of a window, it
    left out the window's first ones, from one to all (PERF.md §6), so
    a window holds its run when its end padding is all there and at least
    one kernel of its start padding: what was lost, if anything, ended
    inside the start padding."""
    return window["pad_start"] >= 1 and window["pad_end"] == PAD_KERNELS


def launch_count_windows(run, pattern: str, device, attempts: int = 6) -> list[dict]:
    """Windows (:func:`counted_window`) of ``run``, at most ``attempts``,
    until one holds its run (:func:`holds_its_run`): such a window stands,
    whatever its counts; one that does not shows, by padding kernels that
    ran and were not recorded, that the profiler lost records past the
    start padding, and is taken again.  Returns every window taken; the
    caller's check stands on the last."""
    windows = []
    for _ in range(attempts):
        windows.append(counted_window(run, pattern, device))
        if holds_its_run(windows[-1]):
            break
    return windows


def check_launch_windows(key, windows: list[dict], want: float, per: int = 1) -> dict:
    """Fails unless the last of ``windows`` holds its run and its reported
    and profiled counts, each over ``per``, equal ``want``; returns the
    record of the case (every window's counts)."""
    last = windows[-1]
    reported, seen = last["reported"] / per, last["profiled"] / per
    assert holds_its_run(last), (key, "no window held its run", windows)
    assert reported == seen == want, (key, reported, seen, want, windows)
    return {"reported": reported, "profiler": seen, "windows": windows}


KRYLOV_LAUNCHES = {("cg", 70_924, True): 3, ("cg", 70_924, False): 4,
                   ("minres", 2_422, True): 1, ("minres", 2_422, False): 2,
                   ("minres", 8_193, True): 3, ("minres", 8_193, False): 4}
KRYLOV_PATTERN = r"\b(cg|minres)_\w+_kernel\b"
KRYLOV_CALLS = 8  # iterations of a launch-count window


def krylov_launch_cases(device) -> dict:
    """``{key: (run, want)}`` for each case of :data:`KRYLOV_LAUNCHES`
    (solver, n, Jacobi): ``run()`` takes :data:`KRYLOV_CALLS` iterations on
    random vectors (the values do not change the count) and returns the
    device launches the launchers reported for them; ``want`` is an
    iteration's.  One warm-up iteration is taken here."""
    import itertools

    from networks_fenicsx_tpu_torch.kernels import krylov

    gen = torch.Generator(device=device).manual_seed(23)
    calls = KRYLOV_CALLS

    def vectors(n, count):
        return [torch.rand(n, generator=gen, dtype=torch.float64, device=device) + 1.0
                for _ in range(count)]

    def cg(n, jacobi):
        st, part = krylov.new_state(device), krylov.partials(n, device)
        b, x, r, p, z, ap, d = vectors(n, 7)
        krylov.cg_start(st, b, r, z, part, 0.0, 0.0, 10**9)
        steps = krylov.CgSteps(st, part, x, r, p, d if jacobi else None)

        def iteration():
            steps.step(ap)
            steps.direction(*(() if jacobi else (z,)))

        return krylov.LAUNCHES, iteration

    def minres(n, jacobi):
        ms, part = krylov.minres_state(device), krylov.partials(n, device)
        b, r, y, v, x, d = vectors(n, 6)
        krylov.minres_start(ms, b, r, y, v, part, 0.0, 0.0, 10**9)
        steps = krylov.MinresSteps(ms, part, v, x, r, d if jacobi else None)
        yvs = itertools.cycle(vectors(n, calls + 1))

        def iteration():
            steps.step(next(yvs))
            if not jacobi:
                steps.finish(y)

        return krylov.MINRES, iteration

    out = {}
    for (solver, n, jacobi), want in KRYLOV_LAUNCHES.items():
        counter, iteration = (cg if solver == "cg" else minres)(n, jacobi)
        iteration()
        torch.cuda.synchronize()

        def run(counter=counter, iteration=iteration):
            before = counter.device
            for _ in range(calls):
                iteration()
            return counter.device - before

        out[f"{solver}_n{n}_{'jacobi' if jacobi else 'generic'}"] = (run, want)
    return out


def krylov_launch_counts(device) -> dict:
    """K19a's and K19e's device launches an iteration, as the launchers
    report them and as ``torch.profiler`` sees them in the same window
    (:func:`launch_count_windows`), for each case of
    :func:`krylov_launch_cases`; the profiler counts ``krylov.cu``'s
    kernels by name.  Fails unless both equal the expected count.  MINRES
    runs one cluster launch at n = 2,422 and ticket-finished launches at
    8,193.  Run after the timed phases: the profiler's tracing may slow
    later launches."""
    counted_window(lambda: 0, KRYLOV_PATTERN, device)  # the first session of a process starts the tracer
    out = {}
    for key, (run, want) in krylov_launch_cases(device).items():
        windows = launch_count_windows(run, KRYLOV_PATTERN, device)
        out[key] = check_launch_windows(key, windows, want, per=KRYLOV_CALLS)
    return out


MF_LAUNCHES = {"factor": 18, "apply": 129}  # the 100k web: 14 levels, 3 split (were 95, 769)
MF_PATTERNS = {"factor": r"\bmf_(values|front|wide)_kernel\b",
               "apply": r"\b(mf_(forward|backward|gather|terms|residual|gate)_kernel|fold_kernel"
                        r"|segsum_kernel)\b"}  # K10's folds: a one-level fold is a segment sum


def mf_core_inputs(P, asm) -> tuple:
    """``(solver, dmf, dc, w_pairs, rc)``: a CUDA solve of ``asm`` and the
    inputs its tree executor gives the multifrontal factor and apply
    (captured by wrapping the two for the one solve)."""
    from networks_fenicsx_tpu_torch.kernels import mf_apply, mf_factor

    factor0, apply0 = mf_factor.mf_factor, mf_apply.mf_apply
    seen = {}

    def factor(dmf, dc, w):
        seen.update(dmf=dmf, dc=dc, w=w)
        return factor0(dmf, dc, w)

    def apply(dmf, st, rc):
        seen["rc"] = rc
        return apply0(dmf, st, rc)

    factor.launches = apply.launches = 0  # the wrappers count on their module's name
    mf_factor.mf_factor, mf_apply.mf_apply = factor, apply
    try:
        solver = P.Solver(asm, device="cuda")
        solver.solve()
    finally:
        mf_factor.mf_factor, mf_apply.mf_apply = factor0, apply0
    return solver, seen["dmf"], seen["dc"], seen["w"], seen["rc"]


def mf_launch_cases(P, asm) -> tuple:
    """``(dmf, {key: run})`` on the web's core (:func:`mf_core_inputs`):
    ``run()`` makes one factor or one apply and returns its launches as
    the wrappers' formulas give them (:func:`mf_factor.cuda_launches`,
    :func:`mf_apply.cuda_launches`).  One of each is made here first."""
    from networks_fenicsx_tpu_torch.kernels import mf_apply, mf_factor

    _, dmf, dc, w, rc = mf_core_inputs(P, asm)
    st = mf_factor.mf_factor(dmf, dc, w)
    mf_apply.mf_apply(dmf, st, rc)
    torch.cuda.synchronize()
    return dmf, {"factor": lambda: (mf_factor.mf_factor(dmf, dc, w), mf_factor.cuda_launches(dmf))[1],
                 "apply": lambda: (mf_apply.mf_apply(dmf, st, rc), mf_apply.cuda_launches(dmf))[1]}


def mf_launch_counts(P, asm) -> dict:
    """K13–K14's and K15's device launches of one factor and one apply on
    the web's core (:func:`mf_launch_cases`), as the wrappers' formulas
    give them and as ``torch.profiler`` counts the kernels of
    ``mf_factor.cu`` and of ``mf_apply.cu`` with K10's folds in the same
    window (:func:`launch_count_windows`).  Fails unless both equal
    :data:`MF_LAUNCHES`.  Run after the timed phases."""
    dmf, runs = mf_launch_cases(P, asm)
    device = dmf.fronts.device
    counted_window(lambda: 0, MF_PATTERNS["factor"], device)  # the first session starts the tracer
    out = {"levels": dmf.schedule.n_levels}
    for key, run in runs.items():
        windows = launch_count_windows(run, MF_PATTERNS[key], device)
        out[key] = check_launch_windows(key, windows, MF_LAUNCHES[key])
    return out


MG1D_CALLS = 4  # V-cycles of a launch-count window
# the kernels of a 1-D V-cycle: K19d's and K19c's coarsest solve (its copy and its two
# dataflow triangular solves)
MG1D_PATTERN = r"\b(mg1d_\w+_kernel|mg_copy_kernel|ts_(lower|upper)_kernel)\b"
DIST_PATTERN = r"\bdist_(folds|forward|back)_kernel\b"
DIST_LAUNCHES = 3  # a sharded-forest solve's K22c launches on one card (were 24: 3 a shard)


def mg1d_launch_counts(P, device) -> dict:
    """K19d's device launches of a 1-D V-cycle on the 3×2000 lattice's λ
    system (4 smoothed levels): as the wrappers report them (``LAUNCHES`` of
    K19d, and :data:`mg2d.COARSE_SOLVE_LAUNCHES` a coarsest solve) and as
    ``torch.profiler`` counts ``mg1d.cu``'s kernels and the coarsest solve's
    in the same window (:func:`launch_count_windows`).  Fails unless both
    equal 6 a smoothed level plus the coarsest solve's.  Run after the
    timed phases."""
    from networks_fenicsx_tpu_torch.kernels import mg1d, mg2d
    from networks_fenicsx_tpu_torch.multigrid import Mg1dPreconditioner

    opts = P.SolverOptions(schur_method="cg", cg_precond="mg")
    ex, diag, _, _, cw = cg_system(P, lattice_assembler(P, 3, 2000, forms=skinny_forms), device, opts)
    plan = ex.precond_plan
    pre = Mg1dPreconditioner(plan, ex.device_plan.offsets, cw, diag, opts.mg_overcorrect)
    r = torch.randn(diag.shape[0], generator=torch.Generator(device=device).manual_seed(16),
                    dtype=torch.float64, device=device)
    pre(r)
    torch.cuda.synchronize()

    def run():
        before = (mg1d.LAUNCHES.launches, mg2d.LAUNCHES.launches)
        for _ in range(MG1D_CALLS):
            pre(r)
        return (mg1d.LAUNCHES.launches - before[0]
                + mg2d.COARSE_SOLVE_LAUNCHES * (mg2d.LAUNCHES.launches - before[1]))

    counted_window(lambda: 0, MG1D_PATTERN, device)  # the first session of a process starts the tracer
    L = len(plan.levels)
    want = 6 * L + mg2d.COARSE_SOLVE_LAUNCHES
    windows = launch_count_windows(run, MG1D_PATTERN, device)
    return {"levels": L, "vcycle": check_launch_windows("mg1d_vcycle", windows, want,
                                                        per=MG1D_CALLS)}


def dist_launch_counts(case, device) -> dict:
    """K22c's device launches of a sharded-forest solve (the folds, the
    level walks and the back walks of the card's 8 shards, on a solve's
    inputs): as the wrappers report them (``dist_tree.LAUNCHES``) and as
    ``torch.profiler`` counts ``dist_tree.cu``'s kernels in the same window.
    Fails unless both equal :data:`DIST_LAUNCHES` (3,
    :func:`dist_tree.cuda_launches`)."""
    from networks_fenicsx_tpu_torch.kernels import dist_tree

    tab, eds, lam_T = case
    assert dist_tree.cuda_launches(tab) == DIST_LAUNCHES, tab.S

    def run():
        before = dist_tree.LAUNCHES.launches
        d_, r_, wn, part = dist_tree.folds(tab, eds)
        dist_tree.forward(tab, d_, r_, wn, part)
        dist_tree.back(tab, d_, r_, wn, lam_T)
        return dist_tree.LAUNCHES.launches - before

    run()
    torch.cuda.synchronize()
    counted_window(lambda: 0, DIST_PATTERN, device)  # the first session of a process starts the tracer
    windows = launch_count_windows(run, DIST_PATTERN, device)
    return {"shards": tab.S, "solve": check_launch_windows("dist_tree_solve", windows, DIST_LAUNCHES)}


EDGE_PATTERN = r"\bedge_(tile|direct|uniform)_kernel\b"  # K8a's
SHARD_BLOCKED_PATTERN = r"\bshard_(partials|lambda)_kernel\b"  # K22a's


def edge_shard_launch_counts(edge_case, blocked_case, device) -> dict:
    """K8a's device launches of one call on the callable tree (set (a)'s
    inputs) and K22a's of one sharded-tree solve on the card's 8 shards:
    as the wrappers report them (``edge_data.launches``,
    ``shard_blocked.LAUNCHES``) and as ``torch.profiler`` counts the
    kernels in the same window (:func:`launch_count_windows`; K22a's two
    stages replayed on a solve's inputs, since a window holds no other
    elementwise kernel than its padding); and K22a's count over the
    executor's whole call, reported.  Fails unless they equal
    :data:`EDGE_LAUNCHES` and :data:`SHARD_BLOCKED_LAUNCHES`
    (``shard_blocked.cuda_launches``)."""
    from networks_fenicsx_tpu_torch.kernels import edge_data, shard_blocked, shard_top

    ex, args = blocked_case
    assert shard_blocked.cuda_launches(ex.groups[0]["tables"]) == SHARD_BLOCKED_LAUNCHES
    before = shard_blocked.LAUNCHES.launches
    ex(args)
    solve = shard_blocked.LAUNCHES.launches - before
    assert solve == SHARD_BLOCKED_LAUNCHES, solve
    fws = [ex.forward(i, *a) for i, a in enumerate(args)]
    rows = ex.partials(0, fws)
    tot = shard_top.reduce(rows)
    Tn = ex.plan.Tn
    lam_T = shard_top.t_solve(ex.t_forest[device], tot[:Tn], tot[Tn : 2 * Tn], tot[2 * Tn : 3 * Tn],
                              tot[3 * Tn])[0]

    def edge_run():
        before = edge_data.edge_data.launches
        edge_data.edge_data(*edge_case)
        return edge_data.edge_data.launches - before

    def shard_run():
        before = shard_blocked.LAUNCHES.launches
        ex.partials(0, fws)
        ex.lam(0, fws, lam_T)
        return shard_blocked.LAUNCHES.launches - before

    out = {}
    for key, run, pattern, want, before in (
            ("k8a_callable_tree", edge_run, EDGE_PATTERN, EDGE_LAUNCHES, 1),
            ("k22a_sharded_tree", shard_run, SHARD_BLOCKED_PATTERN, SHARD_BLOCKED_LAUNCHES,
             2 * ex.plan.D)):
        run()
        torch.cuda.synchronize()
        counted_window(lambda: 0, pattern, device)  # the first session of a process starts the tracer
        out[key] = check_launch_windows(key, launch_count_windows(run, pattern, device), want)
        out[key]["before"] = before
    out["k22a_sharded_tree"]["executor_reported"] = solve
    return out


GRID_PATTERN = r"\bgrid_(window|fill)_kernel\b"  # K22b's
CONDENSE_PATTERN = r"\bcondense_kernel\b"  # K1's


def strip_condense_launch_counts(blocked_case, lattice_case, device) -> dict:
    """K22b's device launches of one sharded-lattice solve and K1's of one
    sharded-tree and one sharded-lattice solve on the card's 8 shards: as
    the wrappers report them (``shard_grid.LAUNCHES``, ``condense.launches``)
    over the executors' whole calls and over the stages replayed on a
    solve's inputs, and as ``torch.profiler`` counts the kernels in the
    same window (:func:`launch_count_windows`).  Fails unless they equal
    :data:`SHARD_GRID_LAUNCHES` (``shard_grid.cuda_launches``) and
    :data:`CONDENSE_LAUNCHES` (``condense.cuda_launches``)."""
    from networks_fenicsx_tpu_torch.kernels import condense, shard_grid, shard_top

    bex, bargs = blocked_case
    gex, gargs = lattice_case
    assert shard_grid.cuda_launches(gex.groups[0]["tables"]) == SHARD_GRID_LAUNCHES
    assert all(condense.cuda_launches(ex.groups[0]["k1"]) == CONDENSE_LAUNCHES for ex in (bex, gex))
    executor = {}
    for key, ex, args in (("sharded_tree", bex, bargs), ("sharded_lattice", gex, gargs)):
        before = (condense.condense.launches, shard_grid.LAUNCHES.launches)
        ex(args)
        executor[key] = {"k1": condense.condense.launches - before[0],
                         "k22b": shard_grid.LAUNCHES.launches - before[1]}
    assert executor == {"sharded_tree": {"k1": CONDENSE_LAUNCHES, "k22b": 0},
                        "sharded_lattice": {"k1": CONDENSE_LAUNCHES, "k22b": SHARD_GRID_LAUNCHES}
                        }, executor
    p = gex.plan
    r = int(p.dct.stub_rows.size)
    k1 = gex.condense(0, gargs)
    tail = shard_top.reduce(gex.window(0, k1), 2 + r, 2 * (p.h + 1) * p.nx)
    Ex, Ey, E = p.ny * (p.nx - 1), (p.ny - 1) * p.nx, gex.grid[device].num_edges

    def k22b_run():
        before = shard_grid.LAUNCHES.launches
        gex.window(0, k1)
        shard_grid.fill(Ex, Ey, E, tail)
        return shard_grid.LAUNCHES.launches - before

    def k1_run(ex, args):
        def run():
            before = condense.condense.launches
            ex.condense(0, args)
            return condense.condense.launches - before
        return run

    out = {}
    for key, run, pattern, want, before in (
            ("k22b_sharded_lattice", k22b_run, GRID_PATTERN, SHARD_GRID_LAUNCHES, 2 * p.D + 1),
            ("k1_sharded_tree", k1_run(bex, bargs), CONDENSE_PATTERN, CONDENSE_LAUNCHES, bex.plan.D),
            ("k1_sharded_lattice", k1_run(gex, gargs), CONDENSE_PATTERN, CONDENSE_LAUNCHES, p.D)):
        run()
        torch.cuda.synchronize()
        counted_window(lambda: 0, pattern, device)  # the first session of a process starts the tracer
        out[key] = check_launch_windows(key, launch_count_windows(run, pattern, device), want)
        out[key]["before"] = before
    out["executor_reported"] = executor
    return out


LEVEL_PATTERN = r"\b(level_\w+_kernel|segsum_plan_kernel)\b"  # K7's kernels and K6's one
GATHER_PATTERN = r"\b(cheb_apply_kernel|plan_apply_kernel)\b"  # a K19b application and matvec
LEVEL_LAUNCHES = 6  # a 100k-forest elimination: prepare, K6, assemble, norm, 2 walks (were 2,484)
GATHER_LAUNCHES = 2  # web-cg's Chebyshev application and matvec (were 7 K19b steps and the matvec)


def level_gather_launch_counts(P, forest_asm, web_asm, device) -> dict:
    """K7's device launches of one elimination of the 100k forest (the
    prepare pass, K6's sums, the assembly, the norm and the plan's walks)
    and K19b's of one Chebyshev application and one CG matvec on web-cg's λ
    system, made by the executor's own operator and preconditioner
    (``_operator``, ``_preconditioner``): as the launchers report them (the
    change in K7's and K19b's ``LAUNCHES.device`` and in K6's launches) and
    as ``torch.profiler`` counts the kernels in the same window
    (:func:`launch_count_windows`).  Fails unless both equal
    :data:`LEVEL_LAUNCHES` (:func:`level_eliminate.cuda_launches`) and
    :data:`GATHER_LAUNCHES`.  The counts before this design are recorded
    beside them."""
    from networks_fenicsx_tpu_torch.kernels import edge_data, gather_matvec, level_eliminate, segsum
    from networks_fenicsx_tpu_torch.solver import _LevelExecutor, build_schur_executor

    ex = build_schur_executor(forest_asm, P.SolverOptions(), device=device)
    assert isinstance(ex, _LevelExecutor), type(ex)
    dlp = ex.device_plan
    R, f, sp, ep = ex.upload(*ex.prepare_args(*forest_asm.schur_arguments()))
    Rm, fm, f_zero = forest_asm.coefficient_modes()
    ed = edge_data.edge_data(dlp, forest_asm.network.N, forest_asm.flux_degree, ex._h_e, ex._quad_w,
                             ex._quad_phi, R, f, Rm, fm, f_zero, sp, ep)
    k7 = level_eliminate.cuda_launches(dlp)
    assert k7 == LEVEL_LAUNCHES, (k7, dlp.walk.fwd, dlp.walk.back)

    def level_run():
        before = (level_eliminate.LAUNCHES.device, segsum.LAUNCHES.launches)
        level_eliminate.level_eliminate(dlp, ed)
        return level_eliminate.LAUNCHES.device - before[0] + segsum.LAUNCHES.launches - before[1]

    cg_ex, diag, rhs, w, _ = cg_system(P, web_asm, device, P.SolverOptions(schur_method="cg"))
    op, cw = cg_ex._operator(torch.stack([diag, rhs], dim=1), w, False)
    pre = cg_ex._preconditioner(op, cw, False)

    def gather_run():
        before = gather_matvec.LAUNCHES.device
        pre(rhs)
        op.apply(rhs)
        return gather_matvec.LAUNCHES.device - before

    calls = gather_matvec.LAUNCHES.launches
    gather_run()
    calls = gather_matvec.LAUNCHES.launches - calls
    out = {}
    for key, run, pattern, want, before in (
            ("k7_forest", level_run, LEVEL_PATTERN, LEVEL_LAUNCHES, level_before(dlp.num_levels)),
            ("k19b_chebyshev_and_matvec", gather_run, GATHER_PATTERN, GATHER_LAUNCHES,
             CHEB_BEFORE["k19b_launches"] + 1)):
        run()
        torch.cuda.synchronize()
        counted_window(lambda: 0, pattern, device)  # the first session of a process starts the tracer
        out[key] = check_launch_windows(key, launch_count_windows(run, pattern, device), want)
        out[key]["before"] = before
    out["k19b_chebyshev_and_matvec"].update({"host_calls": calls,
                                             "host_calls_before": CHEB_BEFORE["host_calls"] + 1})
    return out


SWEEP_PATTERN = r"\b(subtree_forward_kernel|top_kernel|subtree_back_kernel)\b"  # K2–K4's kernels
CORE_PATTERN = r"\bcore_(rounds|back)_kernel\b"  # K12a's (the rounds' forward, factor, apply; back)


def sweep_core_launch_counts(sweep_case, core_cases, device) -> dict:
    """K2–K4's device launches of one headline sweep and K12a's of one core
    solve, one factor and one apply (web2k in one block, fronts128 in a
    cooperative grid; K11's and K12b's launches between them are theirs):
    as the launchers report them (``tree_sweep.device``, ``core_elim.device``,
    ``core_factor.device``, ``core_apply.device``) and as ``torch.profiler``
    counts the kernels in the same window (:func:`launch_count_windows`).
    Fails unless both equal :data:`SWEEP_LAUNCHES`
    (:func:`tree_sweep.cuda_launches`), :data:`CORE_LAUNCHES` and
    :data:`CORE_SPLIT_LAUNCHES`."""
    from networks_fenicsx_tpu_torch.kernels import core_elim, tree_sweep

    dp, s_args = sweep_case
    assert tree_sweep.cuda_launches(dp) == SWEEP_LAUNCHES

    def sweep_run():
        before = tree_sweep.tree_sweep.device
        tree_sweep.tree_sweep(dp, *s_args)
        return tree_sweep.tree_sweep.device - before

    # before: assemble, norm, a fold launch a parent level, a back launch a level
    runs = [("k2_k4_headline", sweep_run, SWEEP_PATTERN, SWEEP_LAUNCHES, 2 * dp.sweep.num_levels + 1)]
    for name, (dcp, dc, w_pairs, rc) in core_cases.items():
        def core_run(dcp=dcp, dc=dc, w_pairs=w_pairs, rc=rc):
            before = core_elim.core_elim.device
            core_elim.core_elim(dcp, dc, w_pairs, rc)
            return core_elim.core_elim.device - before

        runs.append((f"k12a_{name}", core_run, CORE_PATTERN, CORE_LAUNCHES, None))
        factor = core_elim.core_factor(dcp, dc, w_pairs)

        def factor_run(dcp=dcp, dc=dc, w_pairs=w_pairs):
            before = core_elim.core_factor.device
            core_elim.core_factor(dcp, dc, w_pairs)
            return core_elim.core_factor.device - before

        def apply_run(dcp=dcp, factor=factor, rc=rc):
            before = core_elim.core_apply.device
            core_elim.core_apply(dcp, factor, rc)
            return core_elim.core_apply.device - before

        runs.append((f"k12a_factor_{name}", factor_run, CORE_PATTERN, CORE_SPLIT_LAUNCHES["factor"],
                     None))
        runs.append((f"k12a_apply_{name}", apply_run, CORE_PATTERN, CORE_SPLIT_LAUNCHES["apply"], None))
    out = {}
    for key, run, pattern, want, before in runs:
        run()
        torch.cuda.synchronize()
        counted_window(lambda: 0, pattern, device)  # the first session of a process starts the tracer
        out[key] = check_launch_windows(key, launch_count_windows(run, pattern, device), want)
        if before is not None:
            out[key]["before"] = before
    return out


PEEL_PATTERN = r"\bpeel_(grid|block)_(forward|back)_kernel\b"  # K9's


def peel_launch_counts(cases: dict, device) -> dict:
    """K9's device launches of one peel solve (around a Jacobi core, whose
    division is PyTorch's) on the 100k web and web1000: as the launchers
    report them (``peel.device``) and as ``torch.profiler`` counts the
    kernels in the same window (:func:`launch_count_windows`).  Fails unless
    both equal :data:`PEEL_LAUNCHES` and ``peel.cuda_launches``."""
    from networks_fenicsx_tpu_torch.kernels import peel

    out = {}
    for key, (dtp, dr, w_pairs) in cases.items():
        assert peel.cuda_launches(dtp) == PEEL_LAUNCHES[key], (key, peel.cuda_launches(dtp))

        def run(dtp=dtp, dr=dr, w_pairs=w_pairs):
            before = peel.peel.device
            peel.peel(dtp, dr, w_pairs, lambda dc, rc: rc / dc)
            return peel.peel.device - before

        run()
        torch.cuda.synchronize()
        counted_window(lambda: 0, PEEL_PATTERN, device)  # a process's first starts the tracer
        windows = launch_count_windows(run, PEEL_PATTERN, device)
        out[f"k9_{key}"] = check_launch_windows(f"k9_{key}", windows, PEEL_LAUNCHES[key])
        # before: 4 a round, the core's gather and scatter
        out[f"k9_{key}"]["before"] = 4 * len(dtp.rounds) + 2
    return out


def compare_krylov_kernels(P, asm, device) -> dict:
    """Set (k): K19a and K19b against their plain versions on the web's λ
    system: one K19b matvec and residual, K19a's Chebyshev start, the
    executor's Chebyshev-Jacobi application (degree 8: K19b's
    :class:`ChebApply`, one launch) against its plain version bit for bit
    and the composed plain steps, one CG step pair from the same state; the
    others at ``TOL``·scale.  Timed: the K19b matvec (CSR ``torch.mv``
    beside it), the application, and the CG step pair's K19a launches on
    fixed vectors (tol 0, so that no update stops), the generic iteration
    (4 device launches) and the Jacobi one (3: Jacobi inside the steps, on
    the λ system's diagonal)."""
    from networks_fenicsx_tpu_torch.kernels import gather_matvec, krylov
    from networks_fenicsx_tpu_torch.multigrid import GatherOperator
    from networks_fenicsx_tpu_torch.ops.krylov import chebyshev_coefficients, chebyshev_preconditioner

    ex, diag, rhs, w, _ = cg_system(P, asm, device, P.SolverOptions(schur_method="cg"))
    dlp = ex.device_plan
    assert dlp.classes is None and ex.precond_kind == ("chebyshev", 8), ex.precond_kind
    B = diag.shape[0]
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randn(B, generator=gen, dtype=torch.float64, device=device)
    plan = ex.gather_plan
    tables = (plan.mv_edge, plan.mv_other)
    ops = {plain: GatherOperator(plan, w, diag, plain) for plain in (False, True)}
    vals = ops[False].vals
    s = krylov.inv_sqrt(diag)
    theta, coeffs = chebyshev_coefficients(8)
    fused = ex._preconditioner(ops[False], None, False)  # the executor's: one host call, one launch
    assert isinstance(fused, gather_matvec.ChebApply), type(fused)
    composed = chebyshev_preconditioner(ops[True].step, diag, degree=8, plain=True, d_isqrt=s)
    z0 = composed(rhs)
    Ap0 = ops[True].apply(z0)

    def cheb_start(start):
        """K19a's Chebyshev start (``rs``, ``dvec``, ``x``, ``z`` plus x)."""
        bufs = tuple(torch.empty_like(rhs) for _ in range(4))
        start(s, rhs, theta, *bufs, x)
        return bufs

    def step_pair(plain: bool, maxiter: int = 100, rtol: float = 1e-12):
        """The generic iteration (z = M r given): its 4 fused launches, or the
        plain steps."""
        st, part = krylov.new_state(device), krylov.partials(B, device)
        xx, r, p = torch.zeros_like(rhs), rhs.clone(), z0.clone()
        (krylov.cg_start_plain if plain else krylov.cg_start)(st, rhs, r, z0, part, rtol, 0.0, maxiter)
        steps = krylov.CgSteps(st, part, xx, r, p, plain=plain)

        def pair():
            steps.step(Ap0)
            steps.direction(z0)
            return st[[0, 1, 2, 3, 5, 6, 7]], xx, r, p

        pair.st = st
        return pair

    runs = {
        "gather_matvec": (lambda: gather_matvec.gather_matvec(plan, vals, diag, x),
                          lambda: gather_matvec.gather_matvec_plain(*tables, w, diag, x), TOL),
        "gather_matvec_residual": (
            lambda: gather_matvec.gather_matvec(plan, vals, diag, x, rhs, norm=True),
            lambda: gather_matvec.gather_matvec_plain(*tables, w, diag, x, rhs, norm=True), TOL),
        # bit for bit: the executor's application against its plain version
        "gather_cheb_apply": (lambda: fused(rhs),
                              lambda: gather_matvec.cheb_apply_plain(*tables, w, diag, s, rhs, theta, coeffs),
                              0.0),
        "krylov_chebyshev": (lambda: cheb_start(krylov.cheb_start), lambda: cheb_start(krylov.cheb_start_plain),
                             TOL),
        "krylov_cg_step": (lambda: step_pair(False)(), lambda: step_pair(True)(), TOL),
        "krylov_cg_jacobi_step": (lambda: cg_jacobi_step(rhs, diag, Ap0, False)(),
                                  lambda: cg_jacobi_step(rhs, diag, Ap0, True)(), TOL),
    }
    iteration_launches = {"generic": device_launches(krylov.LAUNCHES, step_pair(False)),
                          "jacobi": device_launches(krylov.LAUNCHES,
                                                    cg_jacobi_step(rhs, diag, Ap0, False))}
    assert iteration_launches == {"generic": 4, "jacobi": 3}, iteration_launches
    K, E = dlp.mv_edge.shape[0], w.shape[0]
    valid = valid_entries(dlp.mv_edge, E)
    work = {
        # the tables, w, diag and x read, L x written; 2 operations an entry, 2 a row
        "gather_matvec": (tensor_bytes(dlp.mv_edge, dlp.mv_other, w, diag, x) + 8 * B,
                          2 * valid + 2 * B),
        # the tables, w, diag, s and r read, z written; the start 3 a row, each of
        # the 7 steps 2 an entry and 12 a row (the scalings, the update, z)
        "gather_cheb_apply": (tensor_bytes(dlp.mv_edge, dlp.mv_other, w, diag, s, rhs) + 8 * B,
                              3 * B + len(coeffs) * (2 * valid + 12 * B)),
        # the pair reads p, Ap, x, r and z once and writes x, r and p once (the
        # second kernel's reads of r and p are the first's outputs), and the state
        "krylov_cg_step": (8 * 8 * B + 8 * 8, 12 * B),
        # p, Ap, x, r and diag read, x, r and p written once, and the state;
        # 2 operations an entry for each of 5 products and updates, 1 a division
        "krylov_cg_jacobi_step": (8 * 8 * B + 8 * 8, 13 * B),
    }
    L = gather_csr(dlp, w, diag)
    library = {"gather_matvec": lambda: torch.mv(L, x)}
    one_state = step_pair(False, 10**9, 0.0)
    timed = {"gather_matvec": runs["gather_matvec"][:2],
             "gather_cheb_apply": runs["gather_cheb_apply"][:2],
             "krylov_cg_step": (one_state, step_pair(True, 10**9, 0.0)),
             "krylov_cg_jacobi_step": tuple(
                 round_robin(lambda plain=plain: cg_jacobi_step(rhs, diag, Ap0, plain, 10**9, 0.0), 16)
                 for plain in (False, True))}
    record = {"B": B, "K": K, "device_launches_an_iteration": iteration_launches}
    run_checks(runs, record, timed, work, library)
    z = fused(rhs)
    assert torch.equal(z, gather_matvec.cheb_apply_plain(*tables, w, diag, s, rhs, theta, coeffs)), "K19b plain"
    # the composed plain steps divide by θ as PyTorch does on the card (by
    # its reciprocal), cheb_apply_plain and the kernel elementwise: TOL
    err, scale = max_err(z, composed(rhs))
    assert err <= TOL * scale, ("K19b against the composed plain steps", err, scale)
    calls = gather_matvec.LAUNCHES.launches
    record["gather_cheb_apply"].update({"equal_plain": True, "composed_plain_err": err,
                                        "device_launches": device_launches(gather_matvec.LAUNCHES, lambda: fused(rhs)),
                                        "host_calls": gather_matvec.LAUNCHES.launches - calls,
                                        "before": CHEB_BEFORE})
    # the kernels line's krylov entry times one state's iterations on the
    # fixed Ap; the same steps on fresh states of their own, beside them
    fresh = tuple(round_robin(lambda plain=plain: step_pair(plain, 10**9, 0.0), 16)
                  for plain in (False, True))
    record["krylov_cg_step"].update({
        "timed_state_stopped": bool(one_state.st[krylov.DONE] != 0),
        "fresh_ms": cuda_ms(fresh[0], reps=10), "fresh_plain_ms": cuda_ms(fresh[1], reps=3)})
    for fns in (fresh, timed["krylov_cg_jacobi_step"]):
        assert all(fn.fresh() for fn in fns), "a timed fresh iteration stopped early"
    return record


def mg2d_levels(mod, cw, dirs, diag, plan) -> list:
    """The 2-D hierarchy of ``plan`` built with ``mod``'s wrappers (or plain versions)."""
    levels = [mod.level0(cw, dirs, diag)]
    for f, c in zip(plan.shapes, plan.shapes[1:] + (plan.bottom,)):
        levels.append(mod.coarsen(levels[-1], f, c))
    return levels


def compare_mg2d_kernels(P, asm, device) -> dict:
    """Set (l): K19c against its plain versions on the 512² per-edge-R
    lattice's λ system: the hierarchy, the level-0 stencil, the V-cycle's
    fused pieces (the smoother's start folded
    into its first step, residual and restriction, prolongation and
    residual; also bit for bit), the coarsest factor (its lower triangle)
    and solve, one V-cycle application; all at ``TOL``·scale.  The V-cycle's
    launches (``LAUNCHES`` of K19c and K19a over one application) beside
    those of the unfused level loop (``VCYCLE_BEFORE``), and two V-cycles
    on two streams bit for bit with one on the default stream.  Timed: the
    V-cycle (no one PyTorch call computes it; beside ``VCYCLE_BEFORE``'s
    ms), the stencil beside a CSR ``torch.mv``, the
    coarsest factor and solve beside ``cholesky`` + ``cholesky_solve``."""
    from networks_fenicsx_tpu_torch.kernels import krylov, mg2d
    from networks_fenicsx_tpu_torch.multigrid import SMOOTH_DEGREE, SMOOTH_RATIO, Mg2dPreconditioner
    from networks_fenicsx_tpu_torch.ops.krylov import chebyshev_coefficients

    opts = P.SolverOptions(schur_method="cg")
    ex, diag, rhs, w, cw = cg_system(P, asm, device, opts)
    plan = ex.precond_plan
    assert ex.precond_kind[0] == "2d" and (len(plan.shapes), plan.bottom) == (5, (16, 16)), plan
    B = diag.shape[0]
    gen = torch.Generator(device=device).manual_seed(3)
    r = torch.randn(B, generator=gen, dtype=torch.float64, device=device)
    pre = {plain: Mg2dPreconditioner(plan, cw, diag, opts.mg_overcorrect, plain)
           for plain in (False, True)}
    lev, shape, shape_c = pre[True].levels[0], plan.shapes[0], plan.shapes[1]
    bottom = pre[True].bottom
    rc = torch.randn(shape_c[0] * shape_c[1], generator=gen, dtype=torch.float64, device=device)
    rb = torch.randn(bottom.shape[1], generator=gen, dtype=torch.float64, device=device)
    Lc = mg2d._banded(plan.bottom_offsets, bottom[:4], bottom[mg2d.FD])
    factor_p = pre[True].factor

    coarse = (plan.bottom_offsets, bottom[:4], bottom[mg2d.FD])
    theta, coeffs = chebyshev_coefficients(SMOOTH_DEGREE, ratio=SMOOTH_RATIO)
    oc = opts.mg_overcorrect

    def first(fn):  # the start and first step, its result added to a base
        def run():
            out = [torch.empty_like(r) for _ in range(4)]
            fn(lev, shape, r, theta, *out[:3], *coeffs[0], out[3], rhs)
            return out
        return run

    fused = {
        "mg2d_cheb_first": (first(mg2d.cheb_first), first(mg2d.cheb_first_plain)),
        "mg2d_residual_restrict": (lambda: mg2d.residual_restrict(lev, shape, shape_c, r, rhs),
                                   lambda: mg2d.residual_restrict_plain(lev, shape, shape_c, r, rhs)),
        "mg2d_prolong_residual": (
            lambda: mg2d.prolong_residual(lev, shape, shape_c, r, rc, oc, rhs),
            lambda: mg2d.prolong_residual_plain(lev, shape, shape_c, r, rc, oc, rhs)),
    }
    runs = {
        "mg2d_hierarchy": (lambda: mg2d_levels(mg2d, cw, plan.dirs, diag, plan),
                           lambda: mg2d_levels(pre[True].k, cw, plan.dirs, diag, plan), TOL),
        "mg2d_stencil": (lambda: mg2d.stencil(lev, shape, r, rhs),
                         lambda: mg2d.stencil_plain(lev, shape, r, rhs), TOL),
        "mg2d_coarse_factor": (lambda: torch.tril(mg2d.coarse_factor(*coarse)),
                               lambda: mg2d.coarse_factor_plain(*coarse), TOL),
        "mg2d_coarse_solve": (lambda: mg2d.coarse_solve(pre[False].factor, rb),
                              lambda: mg2d.coarse_solve_plain(factor_p, rb), TOL),
        "mg2d": (lambda: pre[False](r), lambda: pre[True](r), TOL),
    }
    runs.update({name: (kernel, plain, TOL) for name, (kernel, plain) in fused.items()})
    sizes = [s[0] * s[1] for s in plan.shapes]
    mb = bottom.shape[1]
    tri = mb * (mb + 1) // 2  # the factor's lower triangle, all that the solves read
    work = {
        # r, the six fields a smoothed level's smoothers and stencils read (not
        # ``extra``, which only the hierarchy build reads) and the factor's
        # lower triangle read once, z written; ~90 operations a cell a cycle
        # (two smoothers, two stencils, the transfers) and 2 mb² for the
        # coarsest solves
        "mg2d": (8 * (2 * B + 6 * sum(sizes) + tri), 90 * sum(sizes) + 2 * mb * mb),
        "mg2d_stencil": (8 * (8 * B), 10 * B),
        "mg2d_coarse_factor": (8 * (5 * mb + tri), 0.0, mb**3 / 3),
        "mg2d_coarse_solve": (8 * (tri + 2 * mb), 2 * mb * mb),
    }
    L = lattice_csr(np.array([1, -1, shape[1], -shape[1]]), lev[:4], lev[mg2d.FD])
    library = {
        "mg2d_stencil": lambda: torch.mv(L, r),
        "mg2d_coarse_factor": lambda: torch.linalg.cholesky(Lc),
        "mg2d_coarse_solve": lambda: torch.cholesky_solve(rb[:, None], factor_p),
    }
    timed = {name: runs[name][:2] for name in work}
    timed["mg2d_coarse_factor"] = (lambda: mg2d.coarse_factor(*coarse),
                                   lambda: mg2d.coarse_factor_plain(*coarse))
    record = {"shapes": [list(s) for s in plan.shapes], "bottom": list(plan.bottom)}
    run_checks(runs, record, timed, work, library)
    for name, (kernel, plain) in fused.items():
        assert all(torch.equal(a, b) for a, b in zip(float_tensors(kernel()),
                                                     float_tensors(plain()))), name
        record[name]["equal"] = True
    before = (mg2d.LAUNCHES.launches, krylov.LAUNCHES.launches)
    z = pre[False](r)
    cycle = {"mg2d_launches": mg2d.LAUNCHES.launches - before[0],
             "krylov_launches": krylov.LAUNCHES.launches - before[1],
             "smoothed_levels": len(plan.shapes), "ms": record["mg2d"]["ms"],
             "before": VCYCLE_BEFORE}
    assert (cycle["mg2d_launches"], cycle["krylov_launches"]) == (6 * len(plan.shapes) + 1, 0), cycle
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    outs = []
    torch.cuda.synchronize()
    for st in streams:
        with torch.cuda.stream(st):
            outs.append(pre[False](r))
    torch.cuda.synchronize()
    assert all(torch.equal(o, z) for o in outs), "two V-cycles on two streams"
    cycle["streams_equal"] = True
    record["vcycle"] = cycle
    log(f"phase kernels-cg (l) V-cycle: {cycle['mg2d_launches']} K19c + {cycle['krylov_launches']} "
        f"K19a wrapper launches a cycle ({len(plan.shapes)} smoothed levels), "
        f"{cycle['ms']:.4f} ms; before the fused path {VCYCLE_BEFORE['mg2d_launches']} + "
        f"{VCYCLE_BEFORE['krylov_launches']}, {VCYCLE_BEFORE['ms']:.4f} ms (PERF.md); "
        f"two streams bit for bit")
    return record


def compare_mg1d_kernels(P, asm, device) -> dict:
    """Set (m): K19d against its plain versions on the 3×2000 lattice's λ
    system under ``cg_precond="mg"``: the hierarchy, the V-cycle's fused
    pieces on level 0 (the smoother's start folded into its first step,
    residual and restriction, prolongation and residual) and one V-cycle,
    all at ``TOL``·scale; the fused pieces, and the cycle against the plain
    pieces composed around the same coarsest solve, also bit for bit.  The V-cycle's wrapper launches (K19d's ``LAUNCHES`` and K19c's
    coarsest solve over one application) beside those of the unfused level
    loop (``MG1D_BEFORE``), and two V-cycles on two streams bit for bit with
    one on the default stream.  Timed: the V-cycle (no one PyTorch call
    computes it; beside ``MG1D_BEFORE``'s ms)."""
    from networks_fenicsx_tpu_torch.kernels import krylov, mg1d, mg2d, shift_matvec
    from networks_fenicsx_tpu_torch.multigrid import SMOOTH_DEGREE, SMOOTH_RATIO, Mg1dPreconditioner
    from networks_fenicsx_tpu_torch.ops.krylov import chebyshev_coefficients

    opts = P.SolverOptions(schur_method="cg", cg_precond="mg")
    ex, diag, rhs, w, cw = cg_system(P, asm, device, opts)
    plan, offsets = ex.precond_plan, ex.device_plan.offsets
    assert ex.precond_kind[0] == "1d" and (len(plan.levels), plan.m_bottom) == (4, 375), plan
    B = diag.shape[0]
    gen = torch.Generator(device=device).manual_seed(4)
    r = torch.randn(B, generator=gen, dtype=torch.float64, device=device)
    ec = torch.randn((B + 1) // 2, generator=gen, dtype=torch.float64, device=device)
    pre = {plain: Mg1dPreconditioner(plan, offsets, cw, diag, opts.mg_overcorrect, plain)
           for plain in (False, True)}
    lev = pre[True].levels[0]
    theta, coeffs = chebyshev_coefficients(SMOOTH_DEGREE, ratio=SMOOTH_RATIO)
    oc = opts.mg_overcorrect

    def hierarchy(mod):
        def run():
            extra, dis = mod.level0(cw, diag)
            out, c, e = [extra, dis], cw, extra
            for lvl in plan.levels:
                c, e, d, s = mod.coarsen(lvl, c, e)
                out += [c, e, d, s]
            return out
        return run

    def first(fn):  # the start and first step, its result added to a base
        def run():
            out = [torch.empty_like(r) for _ in range(4)]
            fn(lev, r, theta, *out[:3], *coeffs[0], out[3], rhs)
            return out
        return run

    fused = {
        "mg1d_cheb_first": (first(mg1d.cheb_first), first(mg1d.cheb_first_plain)),
        "mg1d_residual_restrict": (lambda: mg1d.residual_restrict(lev, r, rhs),
                                   lambda: mg1d.residual_restrict_plain(lev, r, rhs)),
        "mg1d_prolong_residual": (lambda: mg1d.prolong_residual(lev, r, ec, oc, rhs),
                                  lambda: mg1d.prolong_residual_plain(lev, r, ec, oc, rhs)),
        # the cycle against the plain pieces composed around the same coarsest solve
        "mg1d_cycle": (lambda: pre[False](r), lambda: mg1d.cycle_plain(
            pre[False].levels, theta, coeffs, oc, lambda rb: mg2d.coarse_solve(pre[False].factor, rb),
            r)),
    }
    runs = {"mg1d_hierarchy": (hierarchy(mg1d), hierarchy(pre[True].k), TOL),
            "mg1d": (lambda: pre[False](r), lambda: pre[True](r), TOL)}
    runs.update({name: (kernel, plain, TOL) for name, (kernel, plain) in fused.items()})
    sizes = [lvl.m for lvl in plan.levels]
    ncls = [lvl.offsets.size for lvl in plan.levels]
    mb = plan.m_bottom
    work = {
        # r, every level's class weights, diagonal and scaling, the factor's
        # lower triangle read once, z written; ~(20 C + 60) operations a row a
        # cycle, 2 mb² coarsest
        "mg1d": (8 * (2 * B + sum((c + 2) * m for c, m in zip(ncls, sizes)) + mb * (mb + 1) // 2),
                 sum((20 * c + 60) * m for c, m in zip(ncls, sizes)) + 2 * mb * mb),
    }
    record = {"levels": len(plan.levels), "bottom": mb}
    run_checks(runs, record, {"mg1d": runs["mg1d"][:2]}, work, {})
    for name, (kernel, plain) in fused.items():
        assert all(torch.equal(a, b) for a, b in zip(float_tensors(kernel()),
                                                     float_tensors(plain()))), name
        record[name]["equal"] = True
    before = (mg1d.LAUNCHES.launches, mg2d.LAUNCHES.launches, krylov.LAUNCHES.launches,
              shift_matvec.shift_matvec.launches)
    z = pre[False](r)
    cycle = {"mg1d_launches": mg1d.LAUNCHES.launches - before[0],
             "mg2d_launches": mg2d.LAUNCHES.launches - before[1],
             "krylov_launches": krylov.LAUNCHES.launches - before[2],
             "shift_matvec_launches": shift_matvec.shift_matvec.launches - before[3],
             "smoothed_levels": len(plan.levels), "ms": record["mg1d"]["ms"], "before": MG1D_BEFORE}
    L = len(plan.levels)
    assert (cycle["mg1d_launches"], cycle["mg2d_launches"], cycle["krylov_launches"],
            cycle["shift_matvec_launches"]) == (6 * L, 1, 0, 0), cycle
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    outs = []
    torch.cuda.synchronize()
    for st in streams:
        with torch.cuda.stream(st):
            outs.append(pre[False](r))
    torch.cuda.synchronize()
    assert all(torch.equal(o, z) for o in outs), "two V-cycles on two streams"
    cycle["streams_equal"] = True
    record["vcycle"] = cycle
    log(f"phase kernels-cg (m) V-cycle: {cycle['mg1d_launches']} K19d + {cycle['mg2d_launches']} "
        f"K19c wrapper launches a cycle ({L} smoothed levels), {cycle['ms']:.4f} ms, bit for bit "
        f"with the composed plain cycle; before the fused path {MG1D_BEFORE['mg1d_launches']} "
        f"K19d + {MG1D_BEFORE['shift_matvec_launches']} K18 + {MG1D_BEFORE['krylov_launches']} "
        f"K19a + 1 K19c, {MG1D_BEFORE['ms']:.4f} ms (PERF.md); two streams bit for bit")
    return record


def cg_phases(P, device, name_power: str) -> dict:
    """The iterative λ solve: kernels-cg sets (k) the web, (l) the 512²
    lattice, (m) the 3×2000 lattice; the cg512 and web-cg main paths with
    their timings; the skinny lattice's 1-D multigrid solve and the 128²
    lattice under Chebyshev and Jacobi, each through ``Solver.solve()``."""
    from networks_fenicsx_tpu_torch.ops.krylov import CHUNK

    sets = {}
    sets["k"] = compare_krylov_kernels(P, web_assembler(P), device)
    log("phase kernels-cg (k) 100k web with anastomoses, N=8, k=2, gather-fold λ system: "
        + json.dumps(sets["k"]))
    cg512 = lambda: lattice_assembler(P, forms=cg512_forms)  # noqa: E731
    sets["l"] = compare_mg2d_kernels(P, cg512(), device)
    log("phase kernels-cg (l) 512^2 lattice, edge R, 2-D multigrid: " + json.dumps(sets["l"]))
    skinny = lambda: lattice_assembler(P, 3, 2000, forms=skinny_forms)  # noqa: E731
    sets["m"] = compare_mg1d_kernels(P, skinny(), device)
    log("phase kernels-cg (m) 3x2000 lattice, edge R, 1-D multigrid: " + json.dumps(sets["m"]))

    paths = {}
    paths["cg512"] = cg_path(P, device, "cg512 main path", cg512, P.SolverOptions(schur_method="cg"),
                             CG512_SIZES, lattice=True, max_iters=CG512_MAX_ITERS)
    assert paths["cg512"]["iters"] == CG512_ITERS, paths["cg512"]["iters"]
    paths["web-cg"] = cg_path(P, device, "web-cg main path", lambda: web_assembler(P),
                              P.SolverOptions(schur_method="cg"), WEB_CG_SIZES)
    for key, forms in (("cg512", cg512_forms), ("web-cg", forest_forms)):
        paths[key]["chunk"] = CHUNK
        paths[key]["timing"] = cg_timing(P, paths[key], forms, key, name_power)
        del paths[key]["asm"], paths[key]["solver"]
    paths["skinny-mg"] = cg_path(P, device, "(m) 3x2000 lattice, cg_precond='mg'", skinny,
                                 P.SolverOptions(schur_method="cg", cg_precond="mg"), SKINNY_SIZES,
                                 lattice=True)
    for precond in ("chebyshev", "jacobi"):
        paths["grid128-" + precond] = cg_path(
            P, device, f"(n) 128^2 edge-R lattice, cg_precond='{precond}'",
            lambda: grid128_assembler(P), P.SolverOptions(schur_method="cg", cg_precond=precond),
            {"bifurcations": 16_384, "precond": precond}, lattice=True)
    for path in paths.values():
        path.pop("asm", None), path.pop("solver", None)
    return {"sets": sets, "paths": paths}


def p1tree_forms(asm) -> None:
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=1.0 / asm.network.edge_radius**4)


def p1tree_assembler(P, gens: int = GENERATIONS, N: int = N_CELLS, k: int = 2, kp: int = 1):
    """The benchmark tree with continuous pressure, the stable Pk/P(k-1)
    pairing (Poiseuille R = 1/r⁴, p_bc = y)."""
    net = P.network_generation.make_arterial_tree(gens, direction=[0.1, 1, 0], arrays=True)
    mesh = P.NetworkMesh(net, N=N, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=kp)
    p1tree_forms(asm)
    return asm


def nonzero(launches: dict) -> dict:
    """The wrappers a run launched, with their counts."""
    return {name: n for name, n in launches.items() if n}


def csr_bytes(M, n_in: int) -> int:
    """Bytes a CSR matvec must move: the structure, the values, the vector
    once and the result once."""
    indptr, indices, data = M.device_arrays
    return tensor_bytes(indptr, indices, data) + 8 * (n_in + M.shape[0])


def p1tree_path(P, device, name_power: str) -> dict:
    """The continuous-pressure main path through the public API, counted and
    checked: ``auto`` picks ``schur_p``, only its kernels launched (K20 and
    K20b, K21a, K19a), the expected sizes, converged, the kernel path's
    iterations within 2 of the plain path's and its solution at
    ``SCHUR_P_TOL``·scale of it, mass conserved at every junction to the
    bound the CG residual implies (a junction's imbalance is its λ row of
    ``T z − rhs``); then compute_forms + solve best of 3."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.kernels import krylov
    from networks_fenicsx_tpu_torch.ops import krylov as loop
    from networks_fenicsx_tpu_torch.solver import _SchurPExecutor

    t0 = time.perf_counter()
    asm = p1tree_assembler(P)
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    asm._build_static_structure()
    coo_s = time.perf_counter() - t1
    solver = P.Solver(asm, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    loop.cg.flag_reads = 0
    steps_before = krylov.LAUNCHES.device
    t2 = time.perf_counter()
    sol = solver.solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t2
    launches = kernels.launches()
    reads = loop.cg.flag_reads
    step_launches = krylov.LAUNCHES.device - steps_before
    # 3 device launches a launched iteration (whole chunks between flag reads)
    assert step_launches == 3 * loop.CHUNK * (reads - 1), (step_launches, reads)
    tol = loop.cg.last_tol
    peak_mb = torch.cuda.max_memory_allocated(device) / 2**20
    ex = solver._executor
    assert isinstance(ex, _SchurPExecutor), type(ex)
    used = {"csr_fold", "csr_spmv", "schur_p_factor", "schur_p_solve", "krylov"}
    assert all(launches[name] >= 1 for name in used), launches
    assert all(n == 0 for name, n in launches.items() if name not in used), launches
    mesh = asm.network
    sizes = {"edges": mesh.num_edges, "bifurcations": mesh.num_multipliers, "dofs": asm.num_dofs,
             "flux": ex.n_flux, "reduced": asm.num_dofs - ex.n_flux, "J_raw": ex.j_raw,
             "J_nnz": ex.J.nnz}
    assert sizes == P1TREE_SIZES, sizes
    info = solver.info
    x = solver.solution_vector()
    assert info.method == "schur_p" and info.converged and info.iterations > 0, info
    assert x.shape == (asm.num_dofs,) and np.all(np.isfinite(x))
    assert sum(fn.values.size for fn in sol) == asm.num_dofs

    t3 = time.perf_counter()
    xp, it_plain, _, ok_plain = ex.plain()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t3
    xp = xp.cpu().numpy()
    assert ok_plain and abs(info.iterations - it_plain) <= 2, (info.iterations, it_plain)
    err = float(np.abs(x - xp).max())
    scale = max(1.0, float(np.abs(xp).max()))
    assert err <= SCHUR_P_TOL * scale, (err, scale)
    imbalance, qmax = conservation(asm, x)
    assert imbalance <= info.residual + 1e-10 * qmax, (imbalance, info.residual, qmax)
    log(f"phase p1tree main path: set-up {setup_s:.3f} s, host planning: COO stream "
        f"{coo_s:.3f} s, J/Jᵀ patterns and folds {ex.planning_s:.3f} s; {sizes}; "
        f"{info.iterations} iterations (plain path {it_plain}), first solve (planning + solve) "
        f"{first_s:.3f} s, CG residual {info.residual:.3e} against its tolerance {tol:.3e}, "
        f"converged, finite, conservation {imbalance:.3e} (max |q| {qmax:.3e}), vs plain path "
        f"{err:.3e} (scale {scale:.3e}), plain whole solve {plain_s:.3f} s, host flag reads "
        f"{reads}, peak device memory {peak_mb:.1f} MiB, wrapper calls {nonzero(launches)}")
    before = P1TREE_KRYLOV_BEFORE
    log(f"phase p1tree K19a: {step_launches} device launches of the CG steps per solve, "
        f"{step_launches / (loop.CHUNK * (reads - 1)):.0f} a launched iteration, {info.iterations} "
        f"iterations; before the fused steps (PERF.md) {before['device_launches']} krylov.cu "
        f"launches, {before['an_iteration']} an iteration, {before['iterations']} iterations")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p1tree_forms(asm)
        solver.solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ex_ms = cuda_ms(lambda: ex(), reps=3)
    log(f"phase timing p1tree: compute_forms+solve best {min(times):.3f} ms (all "
        f"{[round(t, 3) for t in times]}); executor per solve (factor, b upload, CG, back "
        f"substitution) {ex_ms:.3f} ms, plain versions {plain_s * 1e3:.3f} ms (one solve); "
        f"{info.iterations} iterations, {reads} host flag reads, "
        f"{sum(launches.values())} wrapper calls per solve (chunk {loop.CHUNK}); card {name_power}")
    return {"asm": asm, "solver": solver, "launches": launches, "sizes": sizes,
            "iters": info.iterations, "iters_plain": it_plain, "reads": reads,
            "k19a_device_launches": step_launches,
            "residual": info.residual, "tol": tol, "imbalance": imbalance, "qmax": qmax,
            "err": err, "best_ms": min(times), "executor_ms": ex_ms, "plain_ms": plain_s * 1e3}


def compare_schur_p_kernels(asm, ex, device) -> dict:
    """Set (o): K21a and K20b against their plain versions on the p1tree's
    own data at full width — the band factor (and the flux diagonal) and one
    A⁻¹ apply at ``TOL``·scale, each one launch, J·v and Jᵀ·z at
    ``TOL``·scale, the Jacobi diagonal Σ J² / A_diag at 1e-14 relative;
    timed beside ``cholesky`` and ``cholesky_solve`` on the dense (E, m, m)
    blocks and CSR ``torch.mv``.  Then K21a on ragged tiles
    (:func:`schur_p_ragged_checks`)."""
    from networks_fenicsx_tpu_torch.kernels import csr, krylov, schur_p

    tiles, n_flux = ex.tiles, ex.n_flux
    N, k, E, m = tiles.N, tiles.k, tiles.E, tiles.m
    cm = asm._cell_mass_on(device)
    J, JT = ex.J.device_arrays, ex.JT.device_arrays
    n_red = ex.J.shape[0]
    gen = torch.Generator(device=device).manual_seed(5)
    v = torch.randn(n_flux, generator=gen, dtype=torch.float64, device=device)
    z = torch.randn(n_red, generator=gen, dtype=torch.float64, device=device)
    Lb, adiag = schur_p.schur_p_factor_plain(cm, tiles)
    launches = {}
    for name, counter, call in (("factor", schur_p.FACTOR, lambda: schur_p.schur_p_factor(cm, tiles)),
                                ("solve", schur_p.SOLVE, lambda: schur_p.schur_p_solve(Lb, tiles, v))):
        before = counter.launches
        call()
        launches[name] = counter.launches - before
    assert launches == {"factor": 1, "solve": 1}, launches
    runs = {
        "schur_p_factor": (lambda: schur_p.schur_p_factor(cm, tiles),
                           lambda: schur_p.schur_p_factor_plain(cm, tiles), TOL),
        "schur_p_solve": (lambda: schur_p.schur_p_solve(Lb, tiles, v),
                          lambda: schur_p.schur_p_solve_plain(Lb, tiles, v), TOL),
        "csr_spmv": (lambda: csr.csr_spmv(*J, v), lambda: csr.csr_spmv_plain(*J, v), TOL),
        "csr_spmv_T": (lambda: csr.csr_spmv(*JT, z), lambda: csr.csr_spmv_plain(*JT, z), TOL),
    }
    record = {"tiles": tiles.tiles, "tile": schur_p.TILE, "wrapper_launches": launches}
    td, td_plain = csr.csr_tdiag(*J, adiag), csr.csr_tdiag_plain(*J, adiag)
    # K19a's Jacobi CG iteration at the reduced system's width on T's
    # diagonal, its vectors scaled by it (z₀ = rhs / diag and the scalars O(1))
    rz, Az = z * td, torch.randn(n_red, generator=gen, dtype=torch.float64, device=device) * td
    runs["krylov_cg_jacobi_step"] = (lambda: cg_jacobi_step(rz, td, Az, False)(),
                                     lambda: cg_jacobi_step(rz, td, Az, True)(), TOL)
    record["krylov_device_launches_an_iteration"] = device_launches(
        krylov.LAUNCHES, cg_jacobi_step(rz, td, Az, False))
    assert record["krylov_device_launches_an_iteration"] == 3, record
    rel = float(((td - td_plain).abs() / td_plain.abs()).max())
    assert rel <= 1e-14, rel
    record["csr_tdiag"] = {"max_abs_err": float((td - td_plain).abs().max()), "max_rel_err": rel,
                           "tol": 1e-14}
    # the library yardsticks on the same matrices: the dense blocks (in flux
    # order) and their dense factor, and J as a CSR tensor
    dense = torch.zeros((E, m, m), dtype=torch.float64, device=device)
    li = k * torch.arange(N, device=device)[:, None] + torch.arange(k + 1, device=device)[None, :]
    cmv = cm.reshape(E, N, k + 1, k + 1)[tiles.perm.long()]
    for j in range(N):
        dense[:, li[j][:, None], li[j][None, :]] += cmv[:, j]
    L_dense = torch.linalg.cholesky(dense)
    v_e = v.reshape(E, m)[:, :, None]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        J_csr = torch.sparse_csr_tensor(J[0], J[1].long(), J[2], size=ex.J.shape)
        library = {
            "schur_p_factor": lambda: torch.linalg.cholesky(dense),
            "schur_p_solve": lambda: torch.cholesky_solve(v_e, L_dense),
            "csr_spmv": lambda: torch.mv(J_csr, v),
        }
        work = {
            "schur_p_factor": (tensor_bytes(cm, tiles.perm, Lb, adiag), E * m * (k + 1) * (k + 2)),
            "schur_p_solve": (tensor_bytes(Lb) + 16 * n_flux, E * m * (4 * k + 2)),
            "csr_spmv": (csr_bytes(ex.J, n_flux), 2 * ex.J.nnz),
            "krylov_cg_jacobi_step": (8 * 8 * n_red + 8 * 8, 13 * n_red),
        }
        timed = {name: runs[name][:2] for name in library}
        timed["krylov_cg_jacobi_step"] = tuple(
            round_robin(lambda plain=plain: cg_jacobi_step(rz, td, Az, plain, 10**9, 0.0), 16)
            for plain in (False, True))
        run_checks(runs, record, timed, work, library)
    assert all(fn.fresh() for fn in timed["krylov_cg_jacobi_step"]), "a timed iteration stopped early"
    del dense, L_dense
    record["ragged"] = schur_p_ragged_checks(device)
    return record


def schur_p_ragged_checks(device) -> dict:
    """K21a against its plain versions at ``TOL``·scale on a 63-edge tree
    (a ragged last tile of 31 edges): at k = 2 (the staged solve, its window
    in registers), k = 5 (the window read back from shared memory) and k = 2
    with N = 150 (a tile too large for shared memory, solved in device
    memory); a vector at an 8-byte offset (moved without bulk copies) solves
    to the same bits."""
    import networks_fenicsx_tpu_torch as P
    from networks_fenicsx_tpu_torch.kernels import schur_p

    out = {}
    net = P.network_generation.make_arterial_tree(6, direction=[0.1, 1, 0], arrays=True)
    for k, N in ((2, 6), (5, 4), (2, 150)):
        mesh = P.NetworkMesh(net, N=N, color_strategy="fast")
        asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=k - 1)
        asm.compute_forms(p_bc_ex=lambda x: x[1], R=1.0 / mesh.edge_radius**4)
        tiles = schur_p.flux_tiles(asm._edge_flux_base, mesh.edge_color, N, k, device)
        assert tiles.E % schur_p.TILE, tiles.E
        cm = asm._cell_mass_on(device)
        got, want = schur_p.schur_p_factor(cm, tiles), schur_p.schur_p_factor_plain(cm, tiles)
        gen = torch.Generator(device=device).manual_seed(k + N)
        buf = torch.randn(tiles.n_flux + 1, generator=gen, dtype=torch.float64, device=device)
        v = buf[:-1].clone()
        x = schur_p.schur_p_solve(got[0], tiles, v)
        x_plain = schur_p.schur_p_solve_plain(want[0], tiles, v)
        buf[1:] = v
        shifted = schur_p.schur_p_solve(got[0], tiles, buf[1:])
        torch.cuda.synchronize()
        errs = [max_err(a, b) for a, b in ((got[0], want[0]), (got[1], want[1]), (x, x_plain))]
        assert all(err <= TOL * scale for err, scale in errs), (k, N, errs)
        assert torch.equal(shifted, x), (k, N, "an unaligned vector solves to other bits")
        out[f"k{k}_N{N}"] = {"edges": tiles.E, "m": tiles.m, "errs": [e for e, _ in errs],
                             "unaligned_equal": True}
    return out


def compare_csr_assembly(P, asm, device) -> dict:
    """Set (p): the p1tree's whole matrix through ``assemble(kind="csr")``
    (counted), its host pattern timed once, K20's fold against its plain
    version bit for bit; timed beside ``sparse_coo_tensor(...).coalesce()``."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.kernels import csr

    t0 = time.perf_counter()
    pattern, fold = asm._csr_plan()
    host_s = time.perf_counter() - t0
    vals = asm._values(device)
    perm, table = fold.tables(device)
    sizes = {"raw": pattern.nraw, "nnz": pattern.nnz, "max_dup": int(table.shape[1])}
    assert sizes == CSR_SIZES, sizes
    kernels.reset_launches()
    A, b = asm.assemble(kind="csr", device=device)
    torch.cuda.synchronize()
    launches = kernels.launches()
    assert launches["csr_fold"] == 1 and sum(launches.values()) == 1, launches
    got, want = csr.csr_fold(perm, table, vals), csr.csr_fold_plain(perm, table, vals)
    assert torch.equal(got, want) and torch.equal(A.data, got)
    assert b.shape == (asm.num_dofs,)
    idx = torch.stack([torch.as_tensor(asm._all_rows, device=device).long(),
                       torch.as_tensor(asm._all_cols, device=device).long()])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(idx, vals, pattern.shape, check_invariants=False)
        record = {"csr_fold": {"max_abs_err": 0.0, "tol": 0.0, "host_pattern_s": host_s, **sizes,
                               "ms": cuda_ms(lambda: csr.csr_fold(perm, table, vals), reps=10),
                               "plain_ms": cuda_ms(lambda: csr.csr_fold_plain(perm, table, vals),
                                                   reps=3),
                               "library_ms": cuda_ms(lambda: coo.coalesce(), reps=3)}}
    record["csr_fold"].update(bound(tensor_bytes(perm, table, vals) + 8 * pattern.nnz,
                                    pattern.nnz * (table.shape[1] - 1)))
    record["launches"] = launches
    log(f"phase (p) assemble(kind='csr') at full width: host pattern {host_s:.3f} s, {sizes}, "
        f"wrapper calls {nonzero(launches)}")
    del coo, idx
    return record


def lu_residual(A, LU, piv) -> float:
    """max |P A − L U| with the swaps of ``piv`` applied to A's rows."""
    n = A.shape[0]
    order = list(range(n))
    for k_, p_ in enumerate(piv.tolist()):
        order[k_], order[p_] = order[p_], order[k_]
    L = torch.tril(LU, -1) + torch.eye(n, dtype=LU.dtype, device=LU.device)
    U = torch.triu(LU)
    return float((A[torch.as_tensor(order, device=A.device)] - L @ U).abs().max())


def lu_timed(A, b) -> dict:
    """K21b's factor and solve of ``A`` timed apart, beside
    ``torch.linalg.lu_factor`` and ``lu_solve`` on the same inputs, and the
    device launches of one factor."""
    from networks_fenicsx_tpu_torch.kernels import dense_lu

    before = dense_lu.LAUNCHES.device
    LU, piv = dense_lu.lu_factor(A)
    launches = dense_lu.LAUNCHES.device - before
    LU_l, piv_l = torch.linalg.lu_factor(A)
    return {
        "factor_ms": cuda_ms(lambda: dense_lu.lu_factor(A), reps=3),
        "solve_ms": cuda_ms(lambda: dense_lu.lu_solve(LU, piv, b)),
        "library_factor_ms": cuda_ms(lambda: torch.linalg.lu_factor(A), reps=3),
        "library_solve_ms": cuda_ms(lambda: torch.linalg.lu_solve(LU_l, piv_l, b[:, None])),
        "device_launches_per_factor": launches,
        "launch_budget": 10 * -(-A.shape[0] // dense_lu.NB),
    }


def compare_dense_lu(P, device) -> dict:
    """Set (q): K21b on a random diagonally dominant matrix of order
    ``LU_N`` and on the 8,033-dof saddle matrix of ``method="dense"``: the
    pivots and the factor equal to the plain version's bit for bit
    (``torch.equal``), max |PA − LU| ≤ 8·n·ε·max |A|, the solve at
    ``TOL``·scale; the factor and the solve timed apart beside
    ``lu_factor`` and ``lu_solve``, with the device launches of a factor
    (at most 10 per 64-column panel); and K21b's triangular solves on K11's
    Cholesky factor of a 4,096-node Laplacian (``schur_method="dense_f64"``),
    equal to the plain version, timed beside ``solve_triangular``."""
    from networks_fenicsx_tpu_torch.kernels import dense_core, dense_lu

    record = {}
    gen = torch.Generator(device=device).manual_seed(4)
    n = LU_N
    A = torch.randn((n, n), generator=gen, dtype=torch.float64, device=device)
    A += n * torch.eye(n, dtype=torch.float64, device=device)
    b = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
    LU, piv = dense_lu.lu_factor(A)
    LU_p, piv_p = dense_lu.lu_factor_plain(A)
    assert torch.equal(piv, piv_p) and torch.equal(LU, LU_p)
    back = lu_residual(A, LU, piv)
    a_max = float(A.abs().max())
    assert back <= 8 * n * EPS * a_max, (back, a_max)
    x, x_p = dense_lu.lu_solve(LU, piv, b), dense_lu.lu_solve_plain(LU_p, piv_p, b)
    err_x, scale_x = max_err(x, x_p)
    assert err_x <= TOL * scale_x, (err_x, scale_x)
    rec = {"max_abs_err": err_x, "factor_equal": True, "errs": [0.0, err_x], "scale": scale_x,
           "backward_error": back, "backward_bound": 8 * n * EPS * a_max, "tol": TOL, "n": n}
    rec.update(lu_timed(A, b))
    assert rec["device_launches_per_factor"] <= rec["launch_budget"], rec
    rec["ms"] = cuda_ms(lambda: dense_lu.lu_solve(*dense_lu.lu_factor(A), b), reps=3)
    rec["plain_ms"] = cuda_ms(lambda: dense_lu.lu_solve_plain(*dense_lu.lu_factor_plain(A), b), reps=1,
                              warmup=1)
    rec["library_ms"] = cuda_ms(
        lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor(A), b[:, None]), reps=3)
    rec.update(bound(3 * 8 * n * n + 4 * n + 16 * n, 2 * n, 2 * n**3 / 3 + 2 * n * n))
    record["dense_lu"] = rec

    asm = p1tree_assembler(P, 8, 10)
    assert asm.num_dofs == DENSE_DOFS, asm.num_dofs
    S, bs = asm.assemble(kind="dense", device=device)
    LU, piv = dense_lu.lu_factor(S)
    LU_p, piv_p = dense_lu.lu_factor_plain(S)
    assert torch.equal(piv, piv_p) and torch.equal(LU, LU_p)
    xs, xs_p = dense_lu.lu_solve(LU, piv, bs), dense_lu.lu_solve_plain(LU_p, piv_p, bs)
    err, scale = max_err(xs, xs_p)
    assert err <= TOL * scale, (err, scale)
    rec = {"max_abs_err": err, "factor_equal": True, "scale": scale, "tol": TOL, "n": DENSE_DOFS,
           "pivots_moved": int((piv != torch.arange(DENSE_DOFS, device=device)).sum())}
    rec.update(lu_timed(S, bs))
    assert rec["device_launches_per_factor"] <= rec["launch_budget"], rec
    record["dense_lu_saddle"] = rec
    del S, LU, LU_p

    ci, cj, pid, dc, rc, w = spd_laplacian(K11_TIMED, device, seed=K11_TIMED)
    _, s_, C = dense_core.dense_factor(ci, cj, pid, dc, w)
    y = (rc / s_).contiguous()
    got = dense_lu.trsv(C, dense_lu.trsv(C, y, lower=True), lower=True, trans=True)
    want = dense_lu.trsv_plain(C, dense_lu.trsv_plain(C, y, lower=True), lower=True, trans=True)
    assert torch.equal(got, want)
    Cl = torch.tril(C)
    record["dense_lu_trsv"] = {
        "max_abs_err": 0.0, "equal": True, "n": K11_TIMED,
        "ms": cuda_ms(lambda: dense_lu.trsv(C, y, lower=True)),
        "plain_ms": cuda_ms(lambda: dense_lu.trsv_plain(C, y, lower=True), reps=1, warmup=1),
        "library_ms": cuda_ms(lambda: torch.linalg.solve_triangular(Cl, y[:, None], upper=False)),
        **bound(8 * K11_TIMED * (K11_TIMED + 1) // 2 + 16 * K11_TIMED, K11_TIMED**2),
    }
    return record


def dense_path(P, device) -> dict:
    """``method="dense"`` on the 8,033-dof P2/P1 tree through the public API,
    counted: assemble (K20) and solve (K21b); against ``host_lu`` at
    1e-10·scale, with the residual gate."""
    from networks_fenicsx_tpu_torch import kernels

    asm = p1tree_assembler(P, 8, 10)
    solver = P.Solver(asm, options=P.SolverOptions(method="dense"), device=device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    solver.assemble()
    solver.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = kernels.launches()
    assert launches["csr_fold"] == 1 and launches["dense_lu"] == 2, launches
    info, x = solver.info, solver.solution_vector()
    ref = P.Solver(asm, options=P.SolverOptions(method="host_lu"), device=device)
    ref.assemble()
    ref.solve()
    x_ref = ref.solution_vector()
    err = float(np.abs(x - x_ref).max())
    scale = max(1.0, float(np.abs(x_ref).max()))
    gate = max(100 * solver._options.rtol * float(np.linalg.norm(asm._b_host)), 1e-8)
    assert info.method == "dense" and info.converged and info.residual <= gate, (info, gate)
    assert err <= CYCLIC_TOL * scale, (err, scale)
    log(f"phase dense path (q) make_arterial_tree(8), N=10, k=2, kp=1, {asm.num_dofs} dofs: "
        f"assemble + solve {solve_s:.3f} s, residual {info.residual:.3e} against the gate "
        f"{gate:.3e}, vs host_lu {err:.3e} (scale {scale:.3e}), host_lu residual "
        f"{ref.info.residual:.3e}, wrapper calls {nonzero(launches)}")
    return {"launches": launches, "residual": info.residual, "err": err, "solve_s": solve_s}


def minres_assembler(P, gens: int = 8, N: int = 4):
    net = P.network_generation.make_arterial_tree(gens, direction=[0.1, 1, 0], arrays=True)
    mesh = P.NetworkMesh(net, N=N, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=1, pressure_degree=0)
    p1tree_forms(asm)
    return asm


def minres_path(P, device, name_power: str) -> dict:
    """Set (r), ``method="minres"`` (rtol 1e-12) through the public API,
    counted: assemble (K20) and solve (K19e on K20b, K19a's Jacobi);
    converged, against ``host_lu`` at ``MINRES_TOL``·scale, kernel and plain
    iterations within 1 %; a MINRES step pair on fixed vectors timed."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.kernels import krylov
    from networks_fenicsx_tpu_torch.ops import krylov as loop
    from networks_fenicsx_tpu_torch.solver import _generic_solve

    asm = minres_assembler(P)
    assert asm.num_dofs == MINRES_DOFS, asm.num_dofs
    opts = P.SolverOptions(method="minres", rtol=1e-12)
    solver = P.Solver(asm, options=opts, device=device)
    kernels.reset_launches()
    loop.minres.flag_reads = 0
    steps_before = krylov.MINRES.device
    t0 = time.perf_counter()
    solver.assemble()
    solver.solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernels.launches()
    reads, tol = loop.minres.flag_reads, loop.minres.last_tol
    step_launches = krylov.MINRES.device - steps_before
    # one cluster launch a launched iteration besides the matvec
    assert step_launches == loop.CHUNK * (reads - 1), (step_launches, reads)
    used = {"csr_fold", "csr_spmv", "krylov", "minres"}
    assert all(launches[name] >= 1 for name in used), launches
    assert all(n == 0 for name, n in launches.items() if name not in used), launches
    info, x = solver.info, solver.solution_vector()
    assert info.method == "minres" and info.converged, info
    t1 = time.perf_counter()
    x_plain, info_plain = _generic_solve(solver.A, solver.b, asm, "minres", opts, plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    reads_plain = loop.minres.flag_reads - reads
    assert info_plain.converged
    assert abs(info.iterations - info_plain.iterations) <= 0.01 * info_plain.iterations, (
        info.iterations, info_plain.iterations)
    ref = P.Solver(asm, options=P.SolverOptions(method="host_lu"), device=device)
    ref.assemble()
    ref.solve()
    x_ref = ref.solution_vector()
    scale = max(1.0, float(np.abs(x_ref).max()))
    err, err_plain = float(np.abs(x - x_ref).max()), float(np.abs(x_plain - x_ref).max())
    assert err <= MINRES_TOL * scale and err_plain <= MINRES_TOL * scale, (err, err_plain, scale)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p1tree_forms(asm)
        solver.assemble()
        solver.solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ex_ms = cuda_ms(lambda: _generic_solve(solver.A, solver.b, asm, "minres", opts), reps=3)
    log(f"phase minres path (r) make_arterial_tree(8), N=4, k=1, {asm.num_dofs} dofs: "
        f"{info.iterations} iterations (plain path {info_plain.iterations}), host flag reads "
        f"{reads} (plain {reads_plain}), residual |φ̄| {info.residual:.3e} against its tolerance "
        f"{tol:.3e}, vs host_lu {err:.3e} (plain path {err_plain:.3e}, scale {scale:.3e}); first "
        f"assemble + solve {first_s:.3f} s; compute_forms + assemble + solve best "
        f"{min(times):.3f} ms (all {[round(t, 3) for t in times]}); solve per call "
        f"{ex_ms:.3f} ms, plain versions {plain_s * 1e3:.3f} ms; {sum(launches.values())} wrapper "
        f"calls per assemble + solve {nonzero(launches)}; card {name_power}")
    log(f"phase minres K19e: {step_launches} device launches of the MINRES steps per solve, "
        f"{step_launches / (loop.CHUNK * (reads - 1)):.0f} a launched iteration besides the matvec, "
        f"{info.iterations} iterations; before the fused step (PERF.md) "
        f"{MINRES_BEFORE['device_launches']} K19e launches, {MINRES_BEFORE['an_iteration']} an "
        f"iteration besides the matvec and the Jacobi apply, {MINRES_BEFORE['iterations']} iterations")

    # one MINRES iteration (K19e) on the system's own vectors after a start,
    # timed: the Jacobi one (one launch) and the generic step pair
    n = asm.num_dofs
    gen = torch.Generator(device=device).manual_seed(6)
    vecs = [torch.randn(n, generator=gen, dtype=torch.float64, device=device) for _ in range(8)]
    b0 = vecs[0]
    d = vecs[7].abs() + 1.0

    def start_and(plain: bool, jacobi: bool):
        start = krylov.minres_start_plain if plain else krylov.minres_start
        ms, part = krylov.minres_state(device), krylov.partials(n, device)
        v, yv, r2, y, x_ = (t.clone() for t in vecs[1:6])
        start(ms, b0, r2, r2, v, part, 0.0, 0.0, 100)
        steps = krylov.MinresSteps(ms, part, v, x_, r2, d if jacobi else None, plain=plain)

        def iteration():
            steps.step(yv)
            if not jacobi:
                steps.finish(y)

        return ms, v, yv, steps, x_, iteration

    def once(plain: bool, jacobi: bool):
        ms, v, yv, steps, x_, iteration = start_and(plain, jacobi)
        iteration()
        return ms, v, yv, steps.w2, x_

    record = {}
    runs = {"minres": (lambda: once(False, False), lambda: once(True, False), TOL),
            "minres_jacobi": (lambda: once(False, True), lambda: once(True, True), TOL)}
    run_checks(runs, record, {}, {}, {})
    an_iteration = {key: device_launches(krylov.MINRES, start_and(False, jac)[-1])
                    for key, jac in (("jacobi", True), ("generic", False))}
    assert an_iteration == {"jacobi": 1, "generic": 2}, an_iteration
    notes = {"minres": "a start, the Lanczos step and the finish on a given y (2 cluster "
                       "launches), n = 2,422",
             "minres_jacobi": "a start and one Jacobi iteration (one cluster launch), n = 2,422"}
    for key, jac in (("minres", False), ("minres_jacobi", True)):
        record[key].update({"ms": cuda_ms(lambda: once(False, jac), reps=10),
                            "plain_ms": cuda_ms(lambda: once(True, jac), reps=10),
                            "library_ms": None, "note": notes[key]})
        # the start reads b, r, y and writes v; the iteration reads v, yv, r1,
        # r2, d (or y), w, w2, x and writes yv, v, w, x
        record[key].update(bound(8 * n * 16, 30 * n))
    record["device_launches_an_iteration"] = an_iteration
    return {"launches": launches, "iters": info.iterations, "iters_plain": info_plain.iterations,
            "k19e_device_launches": step_launches,
            "reads": reads, "residual": info.residual, "tol": tol, "err": err,
            "best_ms": min(times), "solve_ms": ex_ms, "plain_ms": plain_s * 1e3, "record": record}


def rest_phases(P, device) -> dict:
    """Set (s): ``schur_method="dense"`` and ``"dense_f64"`` on lattice64
    (B = 4,096) against its tree route at ``CYCLIC_TOL``·scale; B = 0
    (``make_tree(1)``, N = 8, f = 0.5) against the plain path at
    ``TOL``·scale; ``kind="nest"`` with the default method."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.solver import _DenseExecutor, _EdgeExecutor, _flatten_blocks_host

    out = {"launches": []}
    asm = lattice_assembler(P, 64, 64)
    tree = P.Solver(asm, device=device)
    tree.solve()
    x_tree = tree.solution_vector()
    for method in ("dense", "dense_f64"):
        solver = P.Solver(asm, options=P.SolverOptions(schur_method=method), device=device)
        kernels.reset_launches()
        solver.solve()
        torch.cuda.synchronize()
        launches = kernels.launches()
        assert isinstance(solver._executor, _DenseExecutor) and launches["dense_core"] >= 1
        assert (launches["dense_lu"] == 2) == (method == "dense_f64"), launches
        info, x = solver.info, solver.solution_vector()
        err = float(np.abs(x - x_tree).max())
        scale = max(1.0, float(np.abs(x_tree).max()))
        assert info.converged and err <= CYCLIC_TOL * scale, (info, err, scale)
        out[method] = {"err": err, "residual": info.residual, "launches": launches}
        out["launches"].append(launches)
        log(f"phase (s) lattice64 schur_method={method!r}: vs tree route {err:.3e} (scale "
            f"{scale:.3e}), λ residual {info.residual:.3e}, wrapper calls {nonzero(launches)}")

    net = P.network_generation.make_tree(1, 1, 3, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=8))
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=0.5)
    solver = P.Solver(asm, device=device)
    kernels.reset_launches()
    solver.solve()
    torch.cuda.synchronize()
    launches = kernels.launches()
    ex = solver._executor
    assert isinstance(ex, _EdgeExecutor) and launches["edge_data"] == launches["backsub"] == 1
    q_T, p_T, lam = ex.plain(*ex.prepare_args(*asm.schur_arguments()))[:3]
    x_plain = _flatten_blocks_host(q_T.cpu().numpy(), p_T.cpu().numpy(), lam.cpu().numpy(),
                                   asm.network.edge_color)
    err, scale = float(np.abs(solver.solution_vector() - x_plain).max()), max(
        1.0, float(np.abs(x_plain).max()))
    assert solver.info.converged and err <= TOL * scale, (err, scale)
    out["b0"] = {"err": err, "launches": launches}
    out["launches"].append(launches)

    asm = p1tree_assembler(P, 6, 4, k=1, kp=0)
    plain_solve = P.Solver(asm, device=device)
    plain_solve.solve()
    nest = P.Solver(asm, kind="nest", device=device)
    nest.assemble()
    nest.solve()
    assert isinstance(nest.A, dict) and nest.info.method == "schur" and nest.info.converged
    assert np.array_equal(nest.solution_vector(), plain_solve.solution_vector())
    log(f"phase (s) B = 0 (make_tree(1), N=8, f=0.5): vs plain path {err:.3e}, wrapper calls "
        f"{nonzero(launches)}; kind='nest' with the default method: {len(nest.A)} blocks, solved "
        "by Schur")
    return out


def generic_phases(P, device, name_power: str) -> dict:
    """Continuous pressure and the assembled-matrix routes: the p1tree main
    path and its timing, sets (o) its schur_p pieces and (p) its CSR
    assembly at full width, (q) K21b and the dense path, (r) the MINRES
    path, (s) the dense Schur variants, B = 0 and ``kind="nest"``."""
    sets, paths = {}, {}
    paths["p1tree"] = p1tree_path(P, device, name_power)
    asm, ex = paths["p1tree"]["asm"], paths["p1tree"]["solver"]._executor
    sets["o"] = compare_schur_p_kernels(asm, ex, device)
    log("phase kernels-generic (o) p1tree schur_p pieces at full width: " + json.dumps(sets["o"]))
    sets["p"] = compare_csr_assembly(P, asm, device)
    csr_launches = sets["p"].pop("launches")
    log("phase kernels-generic (p) p1tree CSR assembly at full width: " + json.dumps(sets["p"]))
    del paths["p1tree"]["asm"], paths["p1tree"]["solver"], asm, ex
    sets["q"] = compare_dense_lu(P, device)
    log("phase kernels-generic (q) dense LU: " + json.dumps(sets["q"]))
    paths["dense"] = dense_path(P, device)
    paths["minres"] = minres_path(P, device, name_power)
    sets["r"] = paths["minres"].pop("record")
    log("phase kernels-generic (r) MINRES: " + json.dumps(sets["r"]))
    rest = rest_phases(P, device)
    runs = [paths[key]["launches"] for key in ("p1tree", "dense", "minres")]
    runs += [csr_launches] + rest["launches"]
    return {"sets": sets, "paths": paths, "rest": rest, "runs": runs}



# ======================================================================
# The sharded solves (K22): D shards of one card
# ======================================================================

SHARDED_TOL = 1e-10  # sharded vs the port's serial solve, times the scale
SHARD_TREE = {"D": 8, "Tn": 7, "E_loc": 8_192, "E_sub": 8_191, "B_sub": 4_095, "c": 1}
SHARD_FOREST = {"D": 8, "B_loc": 16_831, "Tn": 1_128}
SHARD_LATTICE = {"D": 8, "h": 64}
SHARD_WEB = {"D": 4}
SHARD_CG = {"D": 8, "n": 64}  # schur_method="cg" on make_grid(64, 64): K22d's CG branch
# wrapper -> (the phases' kernel-check sets and checks it is held on, the
# set and check whose record times it)
SHARDED_CHECKS = {
    "shard_reduce": ((("tree", "shard_reduce"), ("forest", "shard_reduce"),
                      ("lattice", "shard_reduce_placed"), ("lattice", "shard_reduce_tail"),
                      ("web", "shard_reduce"), ("cg", "shard_reduce")), ("web", "shard_reduce")),
    "t_solve": ((("tree", "t_solve"), ("forest", "t_solve")), ("forest", "t_solve")),
    "shard_blocked": ((("tree", "shard_blocked_partials"), ("tree", "shard_blocked_lambda"),
                       ("tree", "shard_blocked"), ("tree", "shard_blocked_one")),
                      ("tree", "shard_blocked")),
    "shard_grid": ((("lattice", "shard_grid_window"), ("lattice", "shard_grid_batch"),
                    ("lattice", "shard_grid_fill"), ("lattice", "shard_grid")), ("lattice", "shard_grid")),
    "dist_tree": ((("forest", "dist_tree_folds"), ("forest", "dist_tree_forward"),
                   ("forest", "dist_tree_back"), ("forest", "dist_tree")), ("forest", "dist_tree")),
    "shard_general": ((("web", "shard_general_partials"), ("cg", "shard_general_offdiag")),
                      ("web", "shard_general_partials")),
}


# K1's batched checks on the sharded paths, beside its serial ones
SHARDED_CONDENSE = (("tree", "condense_batch"), ("lattice", "condense_batch"))
# SHA-256 of λ, q and p of the sharded executors' call (executor_digests) in
# the design before K1 and K22b took every shard of a device in one launch,
# on the same inputs
SHARD_DIGESTS_BEFORE = {
    "tree": {"lambda": "83459e895355d34f6ed7dfcacb11976b76a9f370014f7a2cfeb47ee8b8971b8c",
             "flux": "c7976d5c757ab1e9077e51343ef2ce5f3e8968d42703ec3eaf05cfd425df477a",
             "pressure": "f7db7eb13476746ba774d320bd43d4e5d8474447b349ec07404c4808dfbf2f6a"},
    "lattice": {"lambda": "1c11a951381dc7c09c9d33f71a086ce4d39027f9d28d83a10e8604ef9d080b74",
                "flux": "85280ef8a6d9c353a48ebe110796d51eac4ce1b68bd53d344e928bcf92f04e6e",
                "pressure": "f0f40f7238bc4d3b94d354ba4b62460df775b02fe8b77e81db691318dd0bef52"},
}


def executor_digests(ex, args) -> dict:
    """SHA-256 of a sharded executor call's λ (the blocked executor's shards'
    λ_loc, then λ_T), fluxes q and pressures p, each over the shards in
    order."""
    out = ex(args)
    lam = (*out[2], out[3]) if isinstance(out[2], list) else (out[2],)
    return {"lambda": sha256(*lam), "flux": sha256(*out[0]), "pressure": sha256(*out[1])}


def held_digests(key: str, ex, args) -> dict:
    """:func:`executor_digests` of ``ex``, held equal to
    :data:`SHARD_DIGESTS_BEFORE`: λ, q and p bit for bit those of the
    design before."""
    got, before = executor_digests(ex, args), SHARD_DIGESTS_BEFORE[key]
    assert got == before, (key, got, before)
    return {"digests": got, "before": before, "equal_before": True}


def condense_work(ex, args) -> tuple:
    """K1's work on a sharded executor's group 0: bytes (each shard's h_e,
    R, f, boundary data and row ends read once, the five planes written
    once) and operations (12 an edge and cell, as the serial check counts)."""
    grp = ex.groups[0]
    batch = grp["k1"]
    ins = [(ex.shards[i]["h_e"], *args[i]) for i in grp["members"]]
    ends = [(p.edge_src, p.edge_tgt) for p in batch.plans]
    cell = batch.N if "cell" in (batch.R_mode, batch.f_mode) else 1
    return (tensor_bytes(ins, ends) + 8 * 5 * batch.S * batch.E, 12 * batch.E * batch.S * cell)


def device_share(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device's busy time (kernels and copies), idle share and launches; the
    device numbers are None ("not measured") when the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_us, launches = 0.0, 0
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            if us and ev.device_type == torch.autograd.DeviceType.CUDA:
                busy_us += us
                launches += ev.count
    except Exception as exc:  # the sandbox's tracer may refuse
        log(f"phase profiler: not measured ({type(exc).__name__}: {exc})")
        return {"wall_ms": None, "busy_ms": None, "idle_share": None, "device_launches": None}
    if not busy_us:
        return {"wall_ms": wall_ms, "busy_ms": None, "idle_share": None, "device_launches": None}
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms, "device_launches": launches}


def check_pair(kernel, plain, work: tuple | None = None, library=None, tol: float = TOL,
               exact: bool = False) -> dict:
    """A wrapper against its plain version on the same inputs (fresh calls:
    the inputs are not modified), held at ``tol``·scale (``exact``: also bit
    for bit); timed with its bound (and the library call's time) when
    ``work`` is given."""
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err, scale = max_err(got, want)
    assert err <= tol * scale, (err, scale)
    rec = {"max_abs_err": err, "scale": scale}
    if exact:
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(float_tensors(got), float_tensors(want))), "not bit for bit"
        rec["equal"] = True
    if work is not None:
        rec["ms"] = cuda_ms(kernel)
        rec["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
        rec.update(bound(*work))
        rec["library_ms"] = cuda_ms(library) if library is not None else None
    return rec


def table_entries(*tables) -> int:
    """Non-pad entries of ``-1``-padded int tables."""
    return int(sum(int((t >= 0).sum()) for t in tables))


def sharded_path(P, device, label: str, asm, forms, D: int, method: str, want_method: str,
                 used: tuple, x_ser=None, tol: float = SHARDED_TOL,
                 io_bar: float | None = None, also: tuple = ()) -> dict:
    """A sharded solve through the public API on D shards of the card,
    counted and checked against the port's serial solve of the same
    assembler (``x_ser``, the serial phase's, or solved here): the route,
    its kernels ``used`` launched and none but them and ``also``, finite,
    mass conserved
    at every junction (and between inlet and outlet on a lattice); then its
    timing, host planning and the device's idle share."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

    mesh = asm.network
    if x_ser is None:
        serial = P.Solver(asm, device=device)
        serial.solve()
        x_ser = serial.solution_vector()
        del serial
    sh = ShardedNetworkSolver(asm, devices=[device] * D, schur_method=method)
    sh.assemble()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sol = sh.solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernels.launches()
    assert sh.info.method == want_method and sh.info.converged, sh.info
    assert all(launches[name] >= 1 for name in used), (label, launches)
    assert all(n == 0 for name, n in launches.items() if name not in used + also), (label,
                                                                                      launches)
    x = np.concatenate([np.asarray(fn.values).ravel() for fn in sol])
    assert x.shape == (asm.num_dofs,) and np.all(np.isfinite(x))
    err = float(np.abs(x - x_ser).max())
    scale = max(1.0, float(np.abs(x_ser).max()))
    assert err <= tol * scale, (label, err, scale)
    imbalance, qmax = conservation(asm, x)
    assert imbalance <= 1e-10 * qmax, (label, imbalance, qmax)
    through = None
    if io_bar is not None:
        through = inlet_outlet(asm, x)
        assert through <= io_bar * qmax, (label, through, qmax)

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        forms(asm)
        sh.assemble()
        sh.solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    share = device_share(sh.solve)
    wrapper_calls = sum(launches.values())
    log(f"phase {label}: {mesh.num_edges} edges, {mesh.num_multipliers} bifurcations, "
        f"{asm.num_dofs} dofs, D = {D} shards on {device}, {sh.info.method}; first solve "
        f"(plan + tables + solve) {first_s:.3f} s; vs the serial solve {err:.3e} (scale "
        f"{scale:.3e}, bar {tol:.0e}), conservation {imbalance:.3e} (max |q| {qmax:.3e})"
        + ("" if through is None else f", inlet-outlet balance {through:.3e}")
        + f"; launches {nonzero(launches)}")
    log(f"phase timing {label}: compute_forms+assemble+solve best {min(times):.3f} ms "
        f"(all {[round(t, 3) for t in times]}); one profiled solve {share['wall_ms']} ms, device "
        f"busy {share['busy_ms']} ms, idle share {share['idle_share']}, device launches "
        f"{share['device_launches']}; wrapper calls per solve {wrapper_calls}")
    return {"asm": asm, "solver": sh, "launches": launches, "err": err, "scale": scale,
            "best_ms": min(times), "share": share, "first_s": first_s}


def sharded_tree_checks(state: dict, device) -> dict:
    """K22a, K22-reduce and the T solve on the sharded tree's inputs, and the
    K2–K4 split against its plain version.  K22a as the executor issues
    it: every shard's partials in one launch, every shard's λ in another,
    each bit for bit against the batched plain version, and both together
    (a solve's K22a) timed against their bound; the one-shard wrappers bit
    for bit too."""
    from networks_fenicsx_tpu_torch.kernels import condense, shard_blocked, shard_top, tree_sweep

    ex = state["solver"]._blocked_exec
    plan = ex.plan
    args = ex.prepare_args(*state["solver"]._coeff_args)
    assert len(ex.groups) == 1 and ex.groups[0]["members"] == tuple(range(plan.D)), ex.groups
    rec = {}
    # K1 of the 8 shards in one launch, the batched plain version's bits
    rec["condense_batch"] = check_pair(lambda: ex.condense(0, args),
                                       lambda: ex.condense(0, args, plain=True), exact=True,
                                       work=condense_work(ex, args))
    rec["condense_batch"]["cuda_launches"] = condense.cuda_launches(ex.groups[0]["k1"])
    k1 = ex.condense(0, args)
    fws = [ex.forward(i, *a, k1=k1[:, i].unbind(0)) for i, a in enumerate(args)]
    fw, lp = fws[0], ex.local[device]
    bt, S, Tn, c = ex.groups[0]["tables"], plan.D, plan.Tn, plan.c
    rec["tree_sweep_forward"] = check_pair(
        lambda: tree_sweep.tree_sweep_forward(lp, fw.w, fw.const, fw.Ftot),
        lambda: tree_sweep.tree_sweep_forward_plain(lp.plan, fw.w, fw.const, fw.Ftot))
    n_rows = table_entries(bt.tfold, bt.sfold, bt.pfold)
    # bytes: the tables, the rows' values they name, level 0's d, r, wn, the rows written
    work_p = (tensor_bytes(bt.tfold, bt.sfold, bt.pfold, bt.rfold) + 8 * 3 * n_rows
              + 8 * 3 * c * S + 8 * S * (3 * Tn + 1), 3 * n_rows + 5 * c * S)
    rec["shard_blocked_partials"] = check_pair(
        lambda: ex.partials(0, fws), lambda: ex.partials(0, fws, plain=True), exact=True,
        work=work_p)
    rows = ex.partials(0, fws)  # the (S, 3 Tn + 1) rows K22-reduce reads as they are
    n = rows.shape[1]
    rec["shard_reduce"] = check_pair(
        lambda: shard_top.reduce(rows), lambda: shard_top.reduce_plain(rows), exact=True,
        work=(tensor_bytes(rows) + 8 * n, (plan.D - 1) * n),
        library=lambda: torch.sum(rows, dim=0))
    tot = shard_top.reduce(rows)
    tf = ex.t_forest[device]
    tparts = (tot[:Tn], tot[Tn : 2 * Tn], tot[2 * Tn : 3 * Tn], tot[3 * Tn])
    rec["t_solve"] = t_solve_check(tf, plan.T_parent, *tparts)
    lam_T = shard_top.t_solve(tf, *tparts)[0]
    # bytes: root_T, level 0's d, r, wn, λ_T, the rows [λ0 | 0 | λ_T] written
    work_l = (tensor_bytes(bt.root_T, lam_T) + 8 * 3 * c * S + 8 * S * (plan.B_sub + Tn), 3 * c * S)
    rec["shard_blocked_lambda"] = check_pair(
        lambda: ex.lam(0, fws, lam_T), lambda: ex.lam(0, fws, lam_T, plain=True), exact=True,
        work=work_l)
    rec["shard_blocked"] = check_pair(  # a solve's K22a: 2 launches for the 8 shards
        lambda: (ex.partials(0, fws), ex.lam(0, fws, lam_T)),
        lambda: (ex.partials(0, fws, plain=True), ex.lam(0, fws, lam_T, plain=True)), exact=True,
        work=(work_p[0] + work_l[0], work_p[1] + work_l[1]))
    rec["shard_blocked"]["cuda_launches"] = shard_blocked.cuda_launches(bt)
    sh = ex.shards[S - 1]
    pa = (fws[S - 1].w, fws[S - 1].const, fws[S - 1].Ftot, fws[S - 1].d, fws[S - 1].r, fws[S - 1].wn,
          fws[S - 1].rhs_sq)
    rec["shard_blocked_one"] = check_pair(  # the one-shard wrappers, on the last shard
        lambda: (shard_blocked.partials(sh["tables"], *pa),
                 shard_blocked.lam_ext(sh["tables"], *pa[3:6], lam_T)),
        lambda: (shard_blocked.partials_plain(sh["tables"], *pa),
                 shard_blocked.lam_ext_plain(sh["tables"], *pa[3:6], lam_T)), exact=True)
    lams = ex.lam(0, fws, lam_T)
    rec["tree_sweep_backward"] = check_pair(
        lambda: tree_sweep.tree_sweep_backward(lp, fw.d, fw.r, fw.wn, lams[0].clone()),
        lambda: tree_sweep.tree_sweep_backward_plain(lp.plan, fw.d, fw.r, fw.wn, lams[0].clone()))
    # every shard's halves: the blocked plain order's bits (Σ r² too), λ, d, r,
    # wn the level-by-level plain version's
    digests = []
    for i, f_ in enumerate(fws):
        got = tree_sweep.tree_sweep_forward(lp, f_.w, f_.const, f_.Ftot)
        assert [sha256(t) for t in got] == [sha256(t) for t in tree_sweep.tree_sweep_forward_blocked_plain(
            lp, f_.w, f_.const, f_.Ftot)], ("tree_sweep_forward", i)
        plain = tree_sweep.tree_sweep_forward_plain(lp.plan, f_.w, f_.const, f_.Ftot)
        assert all(torch.equal(a, b) for a, b in zip(got[:3], plain[:3])), ("tree_sweep_forward", i)
        lam = tree_sweep.tree_sweep_backward(lp, *got[:3], lams[i].clone())
        assert torch.equal(lam, tree_sweep.tree_sweep_backward_plain(lp.plan, *got[:3], lams[i].clone())), i
        digests.append(sha256(lam))
    rec["tree_sweep_shards"] = {"bit_for_bit": True, "shards": len(digests),
                                "lambda_sha256": digests,
                                "launches": [tree_sweep.cuda_launches(lp, m)
                                             for m in (tree_sweep.FORWARD, tree_sweep.BACKWARD)]}
    rec["solution"] = held_digests("tree", ex, args)
    rec["launch_case"] = (ex, args)
    return rec


def t_solve_check(tf, T_parent, dT, rT, wT, sq=None) -> dict:
    """The T solve against its plain version (in its order: ``equal`` says
    whether to the bit), against a dense Cholesky solve of the same T
    Laplacian (the reference's, and the library call timed beside it) and
    against the kernel on T's own levels (no compression round: the level
    walk of the parent design), all at ``TOL``·scale; its launches a call
    (the wrapper's count) and the plan's shape.  The call is one kernel, so
    its CUDA-event time is its device time."""
    from networks_fenicsx_tpu_torch.kernels import shard_top

    Tn = tf.Tn
    par = torch.as_tensor(np.asarray(T_parent), device=dT.device)
    has = par >= 0
    LT = torch.diag(dT)
    kids = torch.nonzero(has).reshape(-1)
    LT[kids, par[kids]] -= wT[kids]
    LT[par[kids], kids] -= wT[kids]
    dense = torch.cholesky_solve(rT[:, None], torch.linalg.cholesky(LT))[:, 0]
    before = shard_top.T_SOLVE.launches
    lam = shard_top.t_solve(tf, dT, rT, wT, sq)[0]
    launches = shard_top.T_SOLVE.launches - before
    err_dense = float((lam - dense).abs().max())
    scale = max(1.0, float(dense.abs().max()))
    assert err_dense <= TOL * scale, (err_dense, scale)
    walk = shard_top.t_forest(T_parent, dT.device, rounds=0)
    lam_walk = shard_top.t_solve(walk, dT, rT, wT, sq)[0]
    err_walk = float((lam - lam_walk).abs().max())
    assert err_walk <= TOL * scale, (err_walk, scale)
    rec = check_pair(
        lambda: shard_top.t_solve(tf, dT, rT, wT, sq), lambda: shard_top.t_solve_plain(tf, dT, rT, wT, sq),
        work=(tensor_bytes(dT, rT, wT, tf.table) + 8 * Tn, 12 * Tn),
        library=lambda: torch.cholesky_solve(rT[:, None], torch.linalg.cholesky(LT)))
    got, want = shard_top.t_solve(tf, dT, rT, wT, sq), shard_top.t_solve_plain(tf, dT, rT, wT, sq)
    rec["equal"] = all(torch.equal(a, b) for a, b in zip(float_tensors(got), float_tensors(want)))
    rec["vs_dense_cholesky"] = err_dense
    rec["vs_level_walk"] = err_walk
    rec["level_walk_ms"] = cuda_ms(lambda: shard_top.t_solve(walk, dT, rT, wT, sq))
    rec["launches_a_call"] = launches
    rec["plan"] = {"Tn": Tn, "levels": tf.depth, "rounds": [int(rd.segs.shape[0]) for rd in tf.rounds],
                   "left": int(tf.rows.shape[0]), "left_levels": tf.n_lvl}
    return rec


def sharded_forest_checks(state: dict, device) -> dict:
    """K22c (the folds, the level walks and the back walks of the card's 8
    shards, one launch each), K22-reduce and the T solve on the sharded
    forest's inputs; each K22c launch bit for bit with its plain version
    (the per-shard plain version in a loop over the shards).  Keeps the
    tables, the edge data and λ_T (``launch_case``) for the launch count."""
    from networks_fenicsx_tpu_torch.kernels import dist_tree, shard_top

    ex = state["solver"]._dist_exec
    plan = ex.plan
    args = ex.prepare_args(*state["solver"]._coeff_args)
    assert len(ex.groups) == 1 and ex.groups[0]["tables"].S == plan.D, ex.groups
    tab = ex.groups[0]["tables"]
    fw = ex.forward(0, args)
    eds = fw.eds
    rec = {"dist_tree_folds": check_pair(lambda: dist_tree.folds(tab, eds),
                                         lambda: dist_tree.folds_plain(tab, eds), exact=True)}
    base = dist_tree.folds_plain(tab, eds)

    def walked(fn):
        d_, r_, wn, part = (t.clone() for t in base)
        fn(tab, d_, r_, wn, part)
        return d_, r_, part

    rec["dist_tree_forward"] = check_pair(lambda: walked(dist_tree.forward),
                                          lambda: walked(dist_tree.forward_plain), exact=True)
    stacked = ex.mesh.stack(list(fw.part))
    n = stacked.shape[1]
    rec["shard_reduce"] = check_pair(
        lambda: shard_top.reduce(stacked), lambda: shard_top.reduce_plain(stacked), exact=True,
        work=(tensor_bytes(stacked) + 8 * n, (plan.D - 1) * n),
        library=lambda: torch.sum(stacked, dim=0))
    tot = shard_top.reduce(stacked)
    Tn = plan.Tn
    tf = ex.t_forest[device]
    rec["t_solve"] = t_solve_check(tf, plan.T_parent, tot[:Tn], tot[Tn : 2 * Tn],
                                   tot[2 * Tn : 3 * Tn])
    lam_T = shard_top.t_solve(tf, tot[:Tn], tot[Tn : 2 * Tn], tot[2 * Tn : 3 * Tn])[0]
    rec["dist_tree_back"] = check_pair(lambda: dist_tree.back(tab, fw.d, fw.r, fw.wn, lam_T),
                                       lambda: dist_tree.back_plain(tab, fw.d, fw.r, fw.wn, lam_T),
                                       exact=True)

    def k22c(folds, forward, back):
        def run():
            d_, r_, wn, part = folds(tab, eds)
            forward(tab, d_, r_, wn, part)
            return back(tab, d_, r_, wn, lam_T), part
        return run

    entries = table_entries(tab.t_edge, tab.s_edge, tab.w_edge, tab.tT_edge, tab.sT_edge,
                            tab.wT_edge)
    B_loc, S = plan.B_loc, tab.S
    E_loc = sum(ed.W.shape[0] for ed in eds)
    edge_bytes = sum(tensor_bytes(ed.W, ed.g, ed.cumF[-1], ed.start_pbc, ed.end_pbc, ed.start_bif,
                                  ed.end_bif) for ed in eds)
    # every shard's edge data, tables and lam_T read once, d, r, wn, the partials and
    # [lam | lam_T] written once; the folds' 8 operations an entry, the walks' 10 a node
    rec["dist_tree"] = check_pair(
        k22c(dist_tree.folds, dist_tree.forward, dist_tree.back),
        k22c(dist_tree.folds_plain, dist_tree.forward_plain, dist_tree.back_plain), exact=True,
        work=(edge_bytes + tensor_bytes(tab.t_edge, tab.s_edge, tab.w_edge, tab.tT_edge,
                                        tab.sT_edge, tab.wT_edge, tab.levels, tab.kids,
                                        tab.parent_pos, tab.root_T, tab.rfold, lam_T)
              + 8 * S * (4 * B_loc + 4 * Tn),
              8 * entries + 10 * S * B_loc + 2 * E_loc))
    rec["shards"] = S
    rec["launch_case"] = (tab, eds, lam_T)
    return rec


def sharded_lattice_checks(state: dict, device) -> dict:
    """K1 and K22b as the executor issues them on the sharded lattice's
    inputs: every strip's K1 in one launch, every strip's window in one
    more, each bit for bit against the batched plain version, one strip's
    window alone bit for bit against ``window_plain``, and a solve's K22b
    (the windows and the fill) timed against its bound; the placed
    K22-reduce on the windows' rows as they are; the solution's digests."""
    from networks_fenicsx_tpu_torch.kernels import condense, shard_grid, shard_top

    ex = state["solver"]._blocked_exec
    plan = ex.plan
    args = ex.prepare_args(*state["solver"]._coeff_args)
    assert len(ex.groups) == 1 and ex.groups[0]["members"] == tuple(range(plan.D)), ex.groups
    bt, S = ex.groups[0]["tables"], plan.D
    h, nx, ny = plan.h, plan.nx, plan.ny
    r = int(plan.dct.stub_rows.size)
    length = shard_grid.row_length(h, nx, r)
    rec = {"condense_batch": check_pair(lambda: ex.condense(0, args),
                                        lambda: ex.condense(0, args, plain=True), exact=True,
                                        work=condense_work(ex, args))}
    rec["condense_batch"]["cuda_launches"] = condense.cuda_launches(ex.groups[0]["k1"])
    k1 = ex.condense(0, args)
    w, const, Ftot = k1[1], k1[4], k1[3]
    tab = ex.shards[0]["tables"]
    # bytes: the strip's w, const, Ftot and tables read once (its cell -> stub
    # map included), its row written once; 12 operations a window cell
    rec["shard_grid_window"] = check_pair(
        lambda: shard_grid.window(tab, w[0], const[0], Ftot[0]),
        lambda: shard_grid.window_plain(tab, w[0], const[0], Ftot[0]), exact=True,
        work=(tensor_bytes(w[0], const[0], Ftot[0], tab.valid, tab.cell_map, tab.st_fold,
                           tab.grp_fold, tab.st_sb) + 8 * length, 12 * (h + 1) * nx))
    work_w = (tensor_bytes(w, const, Ftot, bt.valid, bt.cell_map, bt.st_fold, bt.grp_fold, bt.st_sb)
              + 8 * S * length, 12 * (h + 1) * nx * S)
    rec["shard_grid_batch"] = check_pair(  # every strip's window: one launch
        lambda: ex.window(0, k1), lambda: ex.window(0, k1, plain=True), exact=True, work=work_w)
    rows = ex.window(0, k1)  # the (S, row) rows the placed reduce reads as they are
    rec["shard_reduce_placed"] = check_pair(
        lambda: shard_top.reduce_placed(rows, 0, 2, h, nx, ny),
        lambda: shard_top.reduce_placed_plain(rows, 0, 2, h, nx, ny), exact=True)
    tail = shard_top.reduce(rows, 2 + r, 2 * (h + 1) * nx)
    rec["shard_reduce_tail"] = check_pair(
        lambda: shard_top.reduce(rows, 2 + r, 2 * (h + 1) * nx),
        lambda: shard_top.reduce_plain(rows, 2 + r, 2 * (h + 1) * nx), exact=True)
    gdp = ex.grid[device]
    Ex, Ey, E = ny * (nx - 1), (ny - 1) * nx, gdp.num_edges
    rec["shard_grid_fill"] = check_pair(lambda: shard_grid.fill(Ex, Ey, E, tail),
                                        lambda: shard_grid.fill_plain(Ex, Ey, E, tail), exact=True)
    # a solve's K22b: the windows, then the fill (the placed tail read, the
    # conductances written)
    rec["shard_grid"] = check_pair(
        lambda: (ex.window(0, k1), shard_grid.fill(Ex, Ey, E, tail)),
        lambda: (ex.window(0, k1, plain=True), shard_grid.fill_plain(Ex, Ey, E, tail)),
        exact=True, work=(work_w[0] + tensor_bytes(tail) + 8 * E, work_w[1]))
    rec["shard_grid"].update(cuda_launches=shard_grid.cuda_launches(bt), strips=S)
    rec["solution"] = held_digests("lattice", ex, args)
    rec["launch_case"] = (ex, args)
    return rec


def sharded_web_checks(state: dict, device) -> dict:
    """K22d's partials (and their K6 sums alone, bit for bit) and K22-reduce
    on the sharded web's inputs."""
    from networks_fenicsx_tpu_torch.kernels import segsum, shard_general, shard_top
    from networks_fenicsx_tpu_torch.kernels.level_eliminate import _prepare_plain

    ex = state["solver"]._pipeline
    args = ex.prepare_args(*state["solver"]._coeff_args)
    fws = [ex.forward(i, a) for i, a in enumerate(args)]
    ed, tab = fws[0][0], ex.shards[0]["tables"]
    E_s = ed.W.shape[0]
    n_out = 2 * tab.B + tab.P
    rec = {"shard_general_partials": check_pair(
        lambda: shard_general.partials(tab, ed), lambda: shard_general.partials_plain(tab, ed),
        work=(tensor_bytes(ed.W, ed.g, ed.cumF[-1], ed.start_pbc, ed.end_pbc, tab.start_bif,
                           tab.end_bif, tab.t_idx, tab.t_bins, tab.s_idx, tab.s_bins, tab.pair_idx)
              + 8 * (n_out + 5 * E_s), 8 * E_s + 2 * n_out))}
    # the partials' K6 sums alone (both sides written once into dr, then the
    # pairs: one launch), bit for bit on the plain prepared values
    w, vt, vs = _prepare_plain(ed)
    vals = (vt, vs) + ((w,) if tab.P else ())
    rec["shard_general_sums"] = check_pair(
        lambda: torch.cat([o.reshape(-1) for o in segsum.launch_plan(tab.sums, vals)]),
        lambda: torch.cat([o.reshape(-1) for o in segsum.segsum_plan_plain(tab.sums, *vals)]),
        exact=True)
    stacked = ex.mesh.stack([f[1] for f in fws])
    n = stacked.shape[1]
    rec["shard_reduce"] = check_pair(
        lambda: shard_top.reduce(stacked), lambda: shard_top.reduce_plain(stacked), exact=True,
        work=(tensor_bytes(stacked) + 8 * n, (stacked.shape[0] - 1) * n),
        library=lambda: torch.sum(stacked, dim=0))
    return rec


def sharded_cg_checks(state: dict, device) -> dict:
    """K22d's matvec part and K22-reduce on the sharded CG solve's inputs."""
    from networks_fenicsx_tpu_torch.kernels import shard_general, shard_top

    ex = state["solver"]._pipeline
    assert ex.schur_method == "cg"
    args = ex.prepare_args(*state["solver"]._coeff_args)
    fws = [ex.forward(i, a) for i, a in enumerate(args)]
    tab, w = ex.shards[1]["tables"], fws[1][2]
    B = ex.B
    x = torch.as_tensor(np.random.default_rng(5).uniform(-1, 1, B), device=device)
    diag = torch.as_tensor(np.random.default_rng(6).uniform(1, 2, B), device=device)
    rec = {"shard_general_offdiag": check_pair(
        lambda: shard_general.offdiag(tab, w, diag, x),
        lambda: shard_general.offdiag_plain(tab, w, diag, x))}
    stacked = ex.mesh.stack([f[1] for f in fws])
    rec["shard_reduce"] = check_pair(lambda: shard_top.reduce(stacked),
                                     lambda: shard_top.reduce_plain(stacked), exact=True)
    flags = (torch.arange(9, dtype=torch.int32, device=device) + 3) % 5
    rec["shard_all_finite"] = check_pair(lambda: shard_top.all_finite(flags),
                                         lambda: shard_top.all_finite_plain(flags), exact=True)
    return rec


def sharded_phases(P, device, name_power: str, serial: dict) -> dict:
    """The sharded slice: the 16-generation tree over 8 shards (blocked,
    K22a), the 100k forest (tree_dist by auto, K22c), the 512² lattice in 8
    strips (K22b) and the 100k web over 4 shards (the general route's tree
    solve, K22d), then the 64² lattice under CG over 8 shards (K22d's CG
    branch) and the tree on one shard; each against the port's serial solve
    and its kernels against their plain versions.  ``serial`` holds the
    serial main paths' ``(assembler, solution)`` of the tree, the forest,
    the lattice and the web, reused (same forms) rather than rebuilt."""
    from networks_fenicsx_tpu_torch.levels import _cached_tree_plan
    from networks_fenicsx_tpu_torch.ops.multifrontal import MFPlan
    from networks_fenicsx_tpu_torch.parallel.blocked_sharded import plan_sharded_blocked
    from networks_fenicsx_tpu_torch.parallel.distributed_tree import plan_distributed_tree
    from networks_fenicsx_tpu_torch.parallel.grid_sharded import plan_sharded_grid

    paths, sets = {}, {}

    def tree_forms(a):
        a.compute_forms(p_bc_ex=lambda x: x[1], R=1.0 / a.network.edge_radius**4)

    asm, x = serial.pop("tree")
    assert asm.num_dofs == DOFS
    t0 = time.perf_counter()
    plan = plan_sharded_blocked(asm, SHARD_TREE["D"])
    plan_s = time.perf_counter() - t0
    got = {k: getattr(plan, k) for k in SHARD_TREE}
    assert got == SHARD_TREE, got
    log(f"phase sharded-tree: host planning (plan_sharded_blocked) {plan_s:.3f} s, {got}")
    used = ("condense", "tree_sweep", "expand", "shard_blocked", "shard_reduce", "t_solve")
    paths["tree"] = sharded_path(P, device, "sharded-tree main path", asm, tree_forms, 8, "auto",
                                 "schur_sharded_blocked", used, x_ser=x)
    sets["tree"] = sharded_tree_checks(paths["tree"], device)
    blocked_case = sets["tree"].pop("launch_case")
    log("phase kernels-sharded (tree): " + json.dumps(sets["tree"]))
    one = sharded_path(P, device, "sharded-tree D=1", asm, tree_forms, 1, "auto",
                       "schur_sharded_blocked", used, x_ser=x)
    del paths["tree"]["asm"], paths["tree"]["solver"], one, asm

    asm, x = serial.pop("forest")
    assert asm.num_dofs == FOREST_SIZES["dofs"]
    t0 = time.perf_counter()
    dplan = plan_distributed_tree(asm, _cached_tree_plan(asm), SHARD_FOREST["D"])
    plan_s = time.perf_counter() - t0
    got = {"D": dplan.D, "B_loc": dplan.B_loc, "Tn": dplan.Tn}
    assert got == SHARD_FOREST, got
    log(f"phase sharded-forest: host planning (plan_distributed_tree) {plan_s:.3f} s, {got}, "
        f"{len(dplan.level_offsets) - 1} local levels")
    used = ("edge_data", "dist_tree", "shard_reduce", "t_solve", "backsub")
    paths["forest"] = sharded_path(P, device, "sharded-forest main path", asm, forest_forms, 8,
                                   "auto", "schur_sharded_dist", used, x_ser=x)
    sets["forest"] = sharded_forest_checks(paths["forest"], device)
    dist_case = sets["forest"].pop("launch_case")
    log("phase kernels-sharded (forest): " + json.dumps(sets["forest"]))
    del paths["forest"]["asm"], paths["forest"]["solver"], asm

    asm, x = serial.pop("lattice")
    t0 = time.perf_counter()
    gplan = plan_sharded_grid(asm, SHARD_LATTICE["D"])
    plan_s = time.perf_counter() - t0
    assert (gplan.D, gplan.h) == (SHARD_LATTICE["D"], SHARD_LATTICE["h"]), (gplan.D, gplan.h)
    log(f"phase sharded-lattice: host planning (plan_sharded_grid) {plan_s:.3f} s, D = {gplan.D} "
        f"strips of {gplan.h} rows, E_loc {gplan.E_loc}")
    used = ("condense", "shard_grid", "shard_reduce", "dct_lattice", "grid_core", "expand")
    paths["lattice"] = sharded_path(P, device, "sharded-lattice main path", asm, lattice_forms, 8,
                                    "auto", "schur_sharded_grid", used, x_ser=x, io_bar=1e-9)
    sets["lattice"] = sharded_lattice_checks(paths["lattice"], device)
    lattice_case = sets["lattice"].pop("launch_case")
    log("phase kernels-sharded (lattice): " + json.dumps(sets["lattice"]))
    del paths["lattice"]["asm"], paths["lattice"]["solver"], asm

    asm, x = serial.pop("web")
    tp = _cached_tree_plan(asm, attach=True)  # planned once by the web main path
    assert plan_distributed_tree(asm, _cached_tree_plan(asm), SHARD_WEB["D"]) is None
    log(f"phase sharded-web: the web main path's tree plan (core {tp.core_size}, multifrontal); "
        "plan_distributed_tree declines the cyclic graph")
    assert isinstance(tp.core_plan, MFPlan), type(tp.core_plan)
    used = ("edge_data", "shard_general", "shard_reduce", "peel", "fold_apply", "mf_factor",
            "mf_apply", "backsub")
    paths["web"] = sharded_path(P, device, "sharded-web main path", asm, forest_forms, 4, "auto",
                                "schur_sharded", used, x_ser=x)
    sets["web"] = sharded_web_checks(paths["web"], device)
    log("phase kernels-sharded (web): " + json.dumps(sets["web"]))
    del paths["web"]["asm"], paths["web"]["solver"], asm

    n = SHARD_CG["n"]
    asm = lattice_assembler(P, n, n)
    used = ("edge_data", "shard_general", "shard_reduce", "krylov", "backsub")
    # CG stops at ‖r‖ ≤ 1e-13·‖b‖ on a κ ≈ n² system: held at the CG bar
    paths["cg"] = sharded_path(P, device, f"sharded-cg{n} main path", asm, lattice_forms,
                               SHARD_CG["D"], "cg", "schur_sharded", used, tol=CG_TOL)
    sets["cg"] = sharded_cg_checks(paths["cg"], device)
    log(f"phase kernels-sharded (cg{n}): " + json.dumps(sets["cg"]))
    del paths["cg"]["asm"], paths["cg"]["solver"], asm
    log(f"phase sharded: card {name_power}")
    return {"paths": paths, "sets": sets, "dist_case": dist_case, "blocked_case": blocked_case,
            "lattice_case": lattice_case}


# ---------------------------------------------------------------- factor reuse

FACTOR_SOLVES = 3  # rhs-only solves a configuration, each with fresh f and p_bc
# a factorized solve against the fused one, times the scale.  The forest's fused route is the
# level elimination (1,240 levels) and its factorization the peel rounds (1,019): two orders,
# 1.70e-12 apart relative with the plain versions on the CPU and 2.6e-12 on the card, so it is
# held at 1e-11 there and at TOL against the same factorization's plain versions
# (FACTOR_SAME_ORDER)
FACTOR_TOL = {"headline": TOL, "lattice": LATTICE_TOL, "forest": 1e-11, "web": CYCLIC_TOL,
              "web1000": CYCLIC_TOL, "web2k": CYCLIC_TOL, "fronts128": CYCLIC_TOL}
FACTOR_SAME_ORDER = {"forest": TOL}  # card against the CPU's plain versions, same factorization
FACTOR_CLASS = {"headline": "BlockedFactorization", "lattice": "GridFactorization",
                "forest": "TreeFactorization", "web": "TreeFactorization",
                "web1000": "TreeFactorization", "web2k": "TreeFactorization",
                "fronts128": "TreeFactorization"}
# the wrappers a factor and an apply launch, by route (besides the core engine's on the tree route)
FACTOR_USED = {
    "BlockedFactorization": (("condense", "tree_sweep_factor"),
                             ("condense", "tree_sweep_apply", "expand")),
    "GridFactorization": (("condense", "dct_factor"),
                          ("condense", "grid_core", "dct_apply", "expand")),
    "TreeFactorization": (("condense", "bifurcation_system", "segsum", "peel_factor"),
                          ("condense", "bifurcation_system", "segsum", "peel_apply", "expand")),
}
# the port's own kernels in a profiler window: neither PyTorch's nor a copy
FACTOR_PATTERN = r"^(?!.*(at::|Memcpy|Memset))"


def factor_rhs_forms(kind: str, fresh_R: bool = False):
    """``forms(asm, s)``: the configuration's R (its main path's values) with
    the ``s``-th fresh f and p_bc, same kinds.  The R array is made once,
    read-only, and passed to every call (the serving pattern: the
    factorized solve's staleness check is O(1)); with ``fresh_R`` it is made
    anew, writeable, each call, so that each factorized solve hashes it.
    The lattice's scalar R is compared by value either way."""
    held = {}

    def resistance(asm):
        mesh = asm.network
        if fresh_R or held.get("asm") is not asm:
            R = (1.0 / mesh.edge_radius**4 if kind == "poiseuille"
                 else np.random.default_rng(0).uniform(0.5, 2.0, mesh.num_edges))
            R.flags.writeable = fresh_R
            held.update(asm=asm, R=R)
        return held["R"]

    def forms(asm, s: int) -> None:
        mesh = asm.network
        pbc = (lambda x, s=s: (1.0 + 0.1 * s) * x[1] + 0.05 * s * x[0])
        if kind == "poiseuille":  # the headline tree: R = 1/r⁴, scalar f
            asm.compute_forms(p_bc_ex=pbc, R=resistance(asm), f=0.1 * s)
        elif kind == "lattice":  # R = 1, scalar f
            asm.compute_forms(p_bc_ex=pbc, R=1.0, f=0.1 * s)
        else:  # forest_forms' R, a fresh per-cell f
            f = np.random.default_rng(100 + s).uniform(-1.0, 1.0, mesh.num_cells)
            asm.compute_forms(p_bc_ex=(lambda x, s=s: x[0] + 0.1 * s * x[1]), R=resistance(asm),
                              f=f)
    return forms


def factor_host_split(solver, asm, rhs_forms, reps: int = 5) -> dict:
    """Where an rhs-only factorized ``compute_forms`` + ``Solver.solve()``
    spends its time on the host: each step as ``Solver._factorized_solve``
    and ``Solver.solve`` run it, best of ``reps`` in ms, the card
    synchronised at each step's ends — the forms; the staleness check (the
    arguments, the R generation and the kinds; O(1) on ``rhs_forms``'s one
    read-only R); the SHA-1 of R's bytes, which a new R array costs a solve
    instead; the rhs permute and upload; the device apply; the copies to
    the host (q, p, λ, the finite flag and the lattice's residual); the
    flatten into the global vector; the scatter into the solution
    functions — and the whole call, forms included."""
    import hashlib

    from networks_fenicsx_tpu_torch.solver import _flatten_blocks_host

    rhs_forms(asm, 1)
    solver.solve()  # re-arms the factor's R generation after another R array
    fac, state, _, modes, gen = solver._factorization
    names = ("compute_forms", "check", "sha1_R", "prepare_rhs", "apply", "to_host", "flatten",
             "scatter", "whole")
    best = dict.fromkeys(names, float("inf"))

    def clock() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    for i in range(reps):
        s = 1 + i % FACTOR_SOLVES
        t = [clock()]
        rhs_forms(asm, s)
        t.append(clock())
        args = asm.schur_arguments(device=False)
        assert asm._R_generation == gen and modes[:2] == asm.coefficient_modes()[:2]
        t.append(clock())
        hashlib.sha1(np.ascontiguousarray(args[0]).tobytes()).digest()
        t.append(clock())
        rhs = fac.prepare_rhs(*args[1:])
        t.append(clock())
        out = fac.solve_prepared(state, rhs)
        t.append(clock())
        host = [o.cpu().numpy() for o in out[:3]]
        assert bool(out[-1]) and (not fac.solve_has_residual or np.isfinite(float(out[-3])))
        t.append(clock())
        x = _flatten_blocks_host(*host, asm.network.edge_color, edge_order=fac.edge_order,
                                 bif_order=fac.bif_order)
        t.append(clock())
        solver._scatter_functions(None, x)
        t.append(clock())
        for name, a, b in zip(names, t, t[1:]):
            best[name] = min(best[name], (b - a) * 1e3)
        t0 = clock()
        rhs_forms(asm, s)
        solver.solve()
        best["whole"] = min(best["whole"], (clock() - t0) * 1e3)
        assert solver.info.method == "schur_factorized", solver.info
    return best


def factor_launches_want(fac) -> dict:
    """The device launches of one factor and one apply, from the plans."""
    from networks_fenicsx_tpu_torch import factorization as F
    from networks_fenicsx_tpu_torch.kernels import (
        core_elim, dct_lattice, dense_core, grid_core, mf_apply, mf_factor, peel, tree_sweep,
    )

    if isinstance(fac, F.BlockedFactorization):
        dp = fac.device_plan
        return {"factor": 1 + tree_sweep.cuda_launches(dp, tree_sweep.FACTOR),
                "apply": 2 + tree_sweep.cuda_launches(dp, tree_sweep.APPLY)}
    if isinstance(fac, F.GridFactorization):
        # K1, K16's factor; K1, K17's assembly, K16's passes, K17's two refinement
        # residuals and the final one, K5
        return {"factor": 1 + 2,
                "apply": 2 + dct_lattice.apply_launches() + grid_core.cuda_launches()}
    dtp = fac.device_tree_plan
    # K1; the diagonal (prepare, K6), the pair sums (K6), K9's d channel
    factor = 1 + 2 + int(dtp.num_pairs > 0) + peel.factor_launches(dtp)
    apply = 1 + 3 + peel.cuda_launches(dtp) + 1
    if dtp.core_size:
        if dtp.mf is not None:
            factor += mf_factor.cuda_launches(dtp.mf)
            apply += mf_apply.cuda_launches(dtp.mf)
        elif dtp.ce is not None:
            factor += core_elim.factor_launches(dtp.ce)
            apply += core_elim.apply_launches(dtp.ce)
        else:
            n, P0 = dtp.core_size, int(dtp.core_ci.shape[0])
            factor += 1 + (P0 > 0) + dense_core.tiled_factor_launches(n, n) + 1
            apply += dense_core.solve_launches(n)
    return {"factor": factor, "apply": apply}


def blocked_factor_checks(fac, state, rhs_args) -> dict:
    """K2 and K3–K4 on the factorization's inputs: each against its plain
    version in the kernels' order bit for bit (the norm too) and in the
    reference's (d, wn, factor, λ and r bit for bit); the apply's λ and norm
    the full sweep's bits; K1 whole on the resident R gives the factor's
    W and w bits."""
    from networks_fenicsx_tpu_torch.kernels import tree_sweep

    dp, (f, sp, ep) = fac.device_plan, rhs_args
    plan = dp.plan
    W, w, g, Ftot, const = fac._condense(dp, state.R, f, sp, ep)
    assert torch.equal(W, state.W) and torch.equal(w, state.w), "K1: the factor's W, w bits"
    B = dp.num_bifurcations
    tables = (dp.bif_in, dp.bif_out, dp.sweep.levels)  # both halves assemble from these
    kout = dp.bif_out.numel()
    # the apply reads bif_parent at the subtree roots alone (the top's roots solve r / d), and
    # the factor and wn of the nodes with a parent alone (not the roots of level 0)
    sw = dp.sweep
    roots_cut = int(sw.host_levels[sw.cut, 1]) if sw.blocks else 0
    n_child = B - int(sw.host_levels[0, 1])
    rec = {"w_equal": True}
    d, wn, fc = tree_sweep.tree_sweep_factor(dp, w)
    rec["tree_sweep_factor"] = check_pair(
        lambda: tree_sweep.tree_sweep_factor(dp, w),
        lambda: tree_sweep.tree_sweep_factor_blocked_plain(dp, w),
        (tensor_bytes(w, tables) + 24 * B, 5 * B + kout), exact=True)
    ref = tree_sweep.tree_sweep_factor_plain(plan, w)
    assert all(torch.equal(a, b) for a, b in zip((d, wn, fc), ref)), "K2 vs the reference's order"
    got = tree_sweep.tree_sweep_apply(dp, d, wn, fc, const, Ftot)
    rec["tree_sweep_apply"] = check_pair(
        lambda: tree_sweep.tree_sweep_apply(dp, d, wn, fc, const, Ftot),
        lambda: tree_sweep.tree_sweep_apply_blocked_plain(dp, d, wn, fc, const, Ftot),
        (tensor_bytes(d, const, Ftot, tables) + 4 * roots_cut + 16 * n_child + 16 * B + 8,
         8 * B + 2 * kout), exact=True)
    ref = tree_sweep.tree_sweep_apply_plain(plan, d, wn, fc, const, Ftot)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2]), "K3–K4 vs the reference's"
    fused = tree_sweep.tree_sweep(dp, w, const, Ftot)
    assert torch.equal(got[0], fused[0]) and torch.equal(got[1], fused[1]), "apply vs full sweep"
    assert torch.equal(d, fused[2]) and torch.equal(wn, fused[4]), "factor vs full sweep"
    rec["tree_sweep_apply"]["lambda_equal_full_sweep"] = True
    rec["fused_sweep_ms"] = cuda_ms(lambda: tree_sweep.tree_sweep(dp, w, const, Ftot))
    return rec


def grid_factor_checks(fac, state, rhs_args) -> dict:
    """K16's factor and its passes on a stored factor on the lattice
    factorization's inputs: the factor at ``TOL``, the passes against their
    plain version on the same state (``LATTICE_TOL`` refined, ``TOL``
    unrefined) and the fused solve's bits on the same ``w``."""
    from networks_fenicsx_tpu_torch.kernels import dct_lattice as K16, grid_core

    gdp, op, (f, sp, ep) = fac.device_plan, fac.operator, rhs_args
    W, w, g, Ftot, const = fac._condense(gdp, state.R, f, sp, ep)
    assert torch.equal(W, state.W) and torch.equal(w, state.w), "K1: the factor's W, w bits"
    rhs, diag, _ = grid_core.grid_core(gdp, w, const, Ftot)
    st = state.dct

    def res_kernel(lam):
        return grid_core.grid_residual(gdp, w, diag, lam, rhs)

    def res_plain(lam):
        return grid_core.grid_residual_plain(gdp, w, diag, lam, rhs)

    lam = K16.dct_apply(op, st, rhs, res_kernel)
    assert torch.equal(lam, K16.dct_lattice(op, w, rhs, res_kernel)), "dct_apply vs the fused solve"
    fixed = res_plain(lam)
    B, n_pass = op.B, 1 + K16.N_REFINE
    stub_tables = (op.stub_rows, op.stub_edge, op.stub_group)
    rec = {"w_equal": True, "lambda_equal_fused": True}
    rec["dct_factor"] = check_pair(
        lambda: K16.dct_factor(op, w), lambda: K16.factor_plain(op, w),
        (tensor_bytes(op.lamx, op.lamy, op.g_geo, stub_tables, st) + 8 * (2 + op.stub_edge.numel()),
         3 * B + 2 * op.r * B, 0.0))
    rec["dct_apply"] = check_pair(lambda: K16.dct_apply(op, st, rhs, res_kernel),
                                  lambda: K16.dct_apply_plain(op, st, rhs, res_plain),
                                  tol=LATTICE_TOL)
    rec["dct_apply_unrefined"] = check_pair(
        lambda: K16.dct_apply(op, st, rhs, res_kernel, n_refine=0),
        lambda: K16.dct_apply_plain(op, st, rhs, res_plain, n_refine=0))
    # timed alone: its refinement residuals are fixed tensors here, as K16's record
    timed = check_pair(
        lambda: K16.dct_apply(op, st, rhs, lambda _: fixed),
        lambda: K16.dct_apply_plain(op, st, rhs, lambda _: fixed),
        (tensor_bytes(op.Dx, op.Dy, st, stub_tables) + 8 * B * (2 + K16.N_REFINE),
         n_pass * (2 * op.r + 3) * B, n_pass * 4 * op.ny * op.s * (op.ny + op.s)),
        library=lambda: [K16.lplus_plain(op, st, rhs) for _ in range(n_pass)], tol=LATTICE_TOL)
    rec["dct_apply"].update({key: timed[key] for key in timed if key not in rec["dct_apply"]})
    rec["fused_dct_ms"] = cuda_ms(lambda: K16.dct_lattice(op, w, rhs, lambda _: fixed), reps=10)
    return rec


def peel_children(dtp) -> int:
    """The peeled nodes with a parent (a pair and a factor each)."""
    from networks_fenicsx_tpu_torch.ops import peel_table as T

    words = dtp.peel_table.host
    return sum(int((T.round_arrays(words, k)["parents"] >= 0).sum())
               for k in range(int(words[T.H_ROUNDS])))


def peel_table_words(dtp, chan: str) -> int:
    """The int32 words of K9's packed table that one call of a channel reads
    on the card, each word once: ``"d"`` :func:`peel_factor`'s forward
    launches, ``"r"`` :func:`peel_apply`'s forward and back launches.  A
    grid entry reads its round's sources for its fold level (level 0:
    ``esrc`` and the children's ``fsrc``, the d channel their ``parents``,
    ``pair_ids`` and ``fpid`` besides; a later level its rows; the last
    level ``upar``, ``usrc`` and ``ucore``); back, ``bpar`` and ``elim``. A
    block entry reads its round rows, its staged words, ``ssrc``, ``slots``
    and ``bsrc`` (the d channel ``wsrc`` besides; back: its round rows,
    staged words, ``bsrc`` and the slots it eliminates).  The duty reads its
    gather (``early``, the core's nodes it names) or scatter (``core``).
    The launch lists are read on the host and a grid round's row is a
    kernel parameter."""
    from networks_fenicsx_tpu_torch.ops import peel_table as T

    words = np.asarray(dtp.peel_table.host, np.int64)
    read = np.zeros(words.size, bool)
    d = chan == "d"

    def mark(off: int, n: int) -> None:
        if off >= 0 and n > 0:
            read[off: off + n] = True

    def field(k: int, f: int) -> int:
        return int(words[T.HEAD_WORDS + k * T.ROUND_WORDS + f])

    def level(k: int, l: int) -> tuple:  # (offset, rows, width) of fold level l
        at = T.HEAD_WORDS + k * T.ROUND_WORDS + T.R_FOLD + 1 + 4 * l
        return int(words[at]), int(words[at + 1]), int(words[at + 2])

    def staged(e) -> None:  # a block entry's round rows and staged words
        first, last = int(e[T.E_FIRST]), int(e[T.E_LAST])
        mark(T.HEAD_WORDS + first * T.ROUND_WORDS, (last - first) * T.ROUND_WORDS)
        mark(int(e[T.E_LO]), int(e[T.E_HI]) - int(e[T.E_LO]))

    core, n_core = int(words[T.H_CORE]), int(words[T.H_NCORE])
    early, n_early = int(words[T.H_EARLY]), int(words[T.H_NEARLY])
    fwd, back = T.entries(words)
    for e in fwd:
        kind, k, l = int(e[T.E_KIND]), int(e[T.E_FIRST]), int(e[T.E_LEVEL])
        if int(e[T.E_DUTY]):
            mark(early, n_early)
            read[core + words[early: early + n_early]] = True
        if kind == T.GRID:
            n, L = field(k, T.R_N), field(k, T.R_FOLD)
            if l == 0:
                mark(field(k, T.R_ESRC), n)
                if d:
                    mark(field(k, T.R_PAR), n)
                    mark(field(k, T.R_PID), n)
                if L:
                    _, rows, K = level(k, 0)
                    mark(field(k, T.R_FSRC), rows * K)
                    if d:
                        mark(field(k, T.R_FPID), rows * K)
            else:
                off, rows, K = level(k, l)
                mark(off, rows * K)
            if L and l == L - 1:
                rows = level(k, l)[1]
                for f in (T.R_UPAR, T.R_USRC, T.R_UCORE):
                    mark(field(k, f), rows)
        elif kind == T.BLOCK:
            S = int(e[T.E_S])
            staged(e)
            for f in (T.E_SSRC, T.E_SLOTS, T.E_BSRC):
                mark(int(e[f]), S)
            if d:
                mark(int(e[T.E_WSRC]), sum(field(j, T.R_N) for j in range(k, int(e[T.E_LAST]))))
    if not d:
        for e in back:
            kind, k = int(e[T.E_KIND]), int(e[T.E_FIRST])
            if int(e[T.E_DUTY]):
                mark(core, n_core)
            if kind == T.GRID:
                mark(field(k, T.R_BPAR), field(k, T.R_N))
                mark(field(k, T.R_ELIM), field(k, T.R_N))
            elif kind == T.BLOCK:
                S, bsrc, slots = int(e[T.E_S]), int(e[T.E_BSRC]), int(e[T.E_SLOTS])
                staged(e)
                mark(bsrc, S)
                read[slots + np.flatnonzero(words[bsrc: bsrc + S] == -1)] = True
    return int(read.sum())


def core_round_words(dcp, part: str) -> tuple[int, int]:
    """``(words, fold terms)``: the int32 table words K12a's ``part``
    (``"factor"``: the terms with their stream reads, the diagonal update,
    the fill products and their fold, the tail's gathers; ``"apply"``: the
    swept rhs, the diagonal fold, the back-substitution's neighbours, the
    tail's nodes) reads, the header and round rows included, and the terms
    its folds add."""
    from networks_fenicsx_tpu_torch.ops import core_elim as W

    words = dcp.rt.host.astype(np.int64)
    n, adds = dcp.rt.head_words, 0

    def levels(lvs) -> int:
        return sum(idx.size for idx, _ in lvs)

    for k in range(dcp.rt.rounds):
        rd = W._round_arrays(words, k)
        S, SK, U1, M2 = rd["S"], rd["S"] * rd["K"], rd["U1"], rd["M2"]
        if part == "factor":
            fl = levels(rd["u_read"]) + levels(rd["d_fold"]) + levels(rd["u_fold"])
            n += S + SK + U1 + 2 * M2 + fl
        else:
            fl = levels(rd["d_fold"])
            n += S + U1 + SK + fl
        adds += fl
    Bd, Pd = int(dcp.dense_nodes.shape[0]), int(dcp.dp_init.shape[0])
    if Bd and not dcp.fronts:
        if part == "factor":
            fl = levels(W._fold_levels(words, W.G_DPFOLD))
            n, adds = n + Bd + Pd + fl, adds + fl
        else:
            n += Bd
    return n, adds


def front_blocks(dcp, ff) -> list:
    """Each front's ``L`` (w, w) and ``Yᵀ`` (b, w) of a K12b factor: the
    kernel's front buffer blocks, or the plain version's pairs."""
    out = []
    for fr, i in zip(dcp.fronts, range(len(dcp.fronts))):
        w, m = fr.w, fr.w + fr.b
        if isinstance(ff.fronts, torch.Tensor):
            F = ff.fronts[fr.f_off: fr.f_off + m * m].view(m, m)
            out += [torch.tril(F[:w, :w]), F[w:, :w]]
        else:
            L, Y = ff.fronts[i]
            out += [L, Y.T if Y is not None else L.new_zeros((0, w))]
    return out


def two_stream_applies(apply, rhs: tuple) -> list:
    """``apply(r)`` of each rhs on a stream of its own, side by side."""
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in rhs]
    outs = []
    for stream, r in zip(streams, rhs):
        with torch.cuda.stream(stream):
            outs.append(apply(r))
    torch.cuda.synchronize()
    return outs


def core_split_checks(dcp, dc, w_pairs, rc, stored, timed: bool = True) -> dict:
    """Factor reuse's K12a (and on fronts K12b) on a tree factorization's
    core inputs (the peeled diagonal ``dc``, ``w_pairs`` and the apply's
    ``rc``) and its stored factor ``stored``.  K12a's factor launch and its
    apply's two on the rounds alone, bit for bit with their plain versions
    in the kernels' order (and the factor with the reference's order's);
    the whole split core's λ_core within 1e-12·scale of the fused
    ``core_elim``'s and within the fused bar of its plain version; two
    applies on two streams against one factor, each its own bits, the
    factor's bytes unchanged.  On fronts, K12b's factor (every front's ``L``
    and ``Yᵀ``) and sweeps against their plain versions at ``CYCLIC_TOL``,
    the two in a row ``core_fronts``'s bits.  ``timed``: each entry with
    its bound (the rounds alone for K12a, as ``core_elim``'s record), and
    the whole wrappers' and the fused core's times."""
    import dataclasses as dc_

    from networks_fenicsx_tpu_torch.kernels import core_elim, core_fronts

    n, rt = dcp.n_core, dcp.rt
    idx = dc.device.index or 0
    n_tail = int(dcp.dense_nodes.shape[0])
    rec = {"core_plan": {"core": n, "rounds": len(dcp.rounds), "dense_tail": n_tail,
                         "fronts": len(dcp.fronts)},
           "launch_grid": {"factor": core_elim.launch_grid(dcp, idx, (core_elim.FACTOR,)),
                           "apply": core_elim.launch_grid(dcp, idx, (core_elim.APPLY,)),
                           "back": core_elim.launch_grid(dcp, idx, (core_elim.BACK,))}}
    f = core_elim.core_factor(dcp, dc, w_pairs)
    ft = core_elim.core_factor_table_plain(dcp, dc, w_pairs)
    fr = core_elim.core_factor_plain(dcp, dc, w_pairs)
    assert torch.equal(f.fac, ft.fac) and torch.equal(f.d, ft.d), "core_factor vs table order"
    assert torch.equal(ft.fac, fr.fac) and torch.equal(ft.d, fr.d), "core_factor: the two orders"
    assert torch.equal(f.fac, stored.fac), "core_factor: the factorization's factor, repeat bits"
    rounds_only = dc_.replace(dcp, fronts=(), dense_nodes=dcp.dense_nodes[:0], dp_init=dcp.dp_init[:0])
    f_r = core_elim.core_factor(rounds_only, dc, w_pairs)
    w_f, adds_f = core_round_words(rounds_only, "factor")
    w_a, adds_a = core_round_words(rounds_only, "apply")
    SK = sum(rd.S * rd.K for rd in dcp.rounds)
    S_all = sum(rd.S for rd in dcp.rounds)
    M2 = sum(rd.M2 for rd in dcp.rounds)
    used_pairs = sum(int((rd.init_idx < dcp.n_pairs).sum()) for rd in dcp.rounds)
    # reads: the table words, the used pair conductances, dc; writes: the factor buffer, d
    rec["core_factor"] = check_pair(
        lambda: core_elim.core_factor(rounds_only, dc, w_pairs)[:2],
        lambda: core_elim.core_factor_table_plain(rounds_only, dc, w_pairs)[:2],
        (4 * w_f + 8 * (used_pairs + n) + 8 * (rt.fac_len + n), 3 * SK + S_all + 3 * M2 + adds_f)
        if timed else None, exact=True)
    # reads: the table words, a and inv, rc; writes: λ (the forward's r and rv are the back's)
    rec["core_apply"] = check_pair(
        lambda: core_elim.core_apply(rounds_only, f_r, rc),
        lambda: core_elim.core_apply_table_plain(rounds_only, f_r, rc),
        (4 * w_a + 8 * (dcp.a_len + dcp.s_len + n) + 8 * (n + 1), 4 * SK + 2 * S_all + adds_a)
        if timed else None, exact=True)
    lam = core_elim.core_apply(dcp, f, rc)
    fused = core_elim.core_elim(dcp, dc, w_pairs, rc)
    err, scale = max_err(lam, fused)
    assert err <= TOL * scale, ("split core vs fused core_elim", err, scale)
    tol = TOL if n_tail <= 628 and not dcp.fronts else CYCLIC_TOL
    rec["core_apply_whole"] = check_pair(lambda: core_elim.core_apply(dcp, f, rc),
                                         lambda: core_elim.core_apply_table_plain(dcp, ft, rc), tol=tol)
    rec["core_apply_whole"].update({"vs_fused_core_elim": err, "scale": scale, "tol": tol})
    kept = sha256(f.fac)
    rc2 = rc.flip(0).contiguous()
    outs = two_stream_applies(lambda r: core_elim.core_apply(dcp, f, r), (rc, rc2))
    assert torch.equal(outs[0], lam) and torch.equal(outs[1], core_elim.core_apply(dcp, f, rc2))
    assert sha256(f.fac) == kept, "core_apply wrote the factor"
    rec["core_apply"]["two_streams_equal"] = rec["core_apply"]["factor_unchanged"] = True
    if timed:
        rec["core_factor"]["whole_ms"] = cuda_ms(lambda: core_elim.core_factor(dcp, dc, w_pairs),
                                                 reps=5)
        rec["core_apply"]["whole_ms"] = cuda_ms(lambda: core_elim.core_apply(dcp, f, rc), reps=10)
        rec["core_apply"]["fused_core_elim_ms"] = cuda_ms(
            lambda: core_elim.core_elim(dcp, dc, w_pairs, rc), reps=10)
    if dcp.fronts:
        zero = torch.zeros(1, dtype=torch.float64, device=dc.device)
        d, us = f.d, core_elim.factor_stream(dcp, f.fac)
        r = core_elim.apply_forward_plain(dcp, f.fac, rc)[0]
        ff = core_fronts.core_fronts_factor(dcp, d, us, w_pairs)
        fp = core_fronts.core_fronts_factor_plain(dcp, d, torch.cat([us, zero]), w_pairs)
        assert int(ff.ok) == int(fp.ok) == 1, "K12b's gate"
        fl = sum(fr_.w**3 / 3 + fr_.w**2 * fr_.b + fr_.w * fr_.b**2 for fr_ in dcp.fronts)
        tables = [(fr_.nodes, fr_.slot_i, fr_.slot_j, fr_.f_init, fr_.f_fold, fr_.lminv)
                  for fr_ in dcp.fronts]
        n_slots = sum(int(fr_.slot_i.shape[0]) for fr_ in dcp.fronts)
        # reads: the front tables, d at the pivots, the stream's folded slots; writes: the buffer
        rec["core_fronts_factor"] = check_pair(
            lambda: front_blocks(dcp, core_fronts.core_fronts_factor(dcp, d, us, w_pairs)),
            lambda: front_blocks(dcp, core_fronts.core_fronts_factor_plain(
                dcp, d, torch.cat([us, zero]), w_pairs)),
            None, tol=CYCLIC_TOL)
        if timed:
            rec["core_fronts_factor"].update({
                "ms": cuda_ms(lambda: core_fronts.core_fronts_factor(dcp, d, us, w_pairs), reps=5),
                "plain_ms": cuda_ms(lambda: core_fronts.core_fronts_factor_plain(
                    dcp, d, torch.cat([us, zero]), w_pairs), reps=3, warmup=1),
                **bound(tensor_bytes(tables) + 8 * (sum(fr_.w for fr_ in dcp.fronts) + n_slots)
                        + 8 * dcp.f_len, 2 * sum((fr_.w + fr_.b) ** 2 for fr_ in dcp.fronts), fl),
                "library_ms": None})
        kept_f = sha256(ff.fronts)
        # reads: each front's L and Yᵀ once (the back sweep's second read stays in L2, as
        # K12a's apply counts a and inv once), nodes, boundary, r; writes: λ
        lf = sum(fr_.w * (fr_.w + 1) // 2 + fr_.w * fr_.b for fr_ in dcp.fronts)
        rec["core_fronts_apply"] = check_pair(
            lambda: core_fronts.core_fronts_apply(dcp, ff, r.clone()),
            lambda: core_fronts.core_fronts_apply_plain(dcp, fp, r),
            (8 * lf + tensor_bytes([(fr_.nodes, fr_.bnd) for fr_ in dcp.fronts]) + 8 * n
             + 8 * (n + 1), sum(4 * fr_.w**2 + 8 * fr_.w * fr_.b for fr_ in dcp.fronts))
            if timed else None, tol=CYCLIC_TOL)
        assert torch.equal(core_fronts.core_fronts_apply(dcp, ff, r.clone()),
                           core_fronts.core_fronts(dcp, d, us, w_pairs, r.clone())), "K12b split bits"
        outs = two_stream_applies(lambda v: core_fronts.core_fronts_apply(dcp, ff, v.clone()),
                                  (r, r.flip(0).contiguous()))
        assert torch.equal(outs[0], core_fronts.core_fronts_apply(dcp, ff, r.clone()))
        assert sha256(ff.fronts) == kept_f, "core_fronts_apply wrote the factor"
        rec["core_fronts_apply"].update({"equal_core_fronts": True, "factor_unchanged": True})
        if timed:
            rec["core_fronts_apply"]["fused_core_fronts_ms"] = cuda_ms(
                lambda: core_fronts.core_fronts(dcp, d, us, w_pairs, r.clone()), reps=5)
    return rec


def tree_factor_checks(fac, state, rhs_args, timed: bool = True) -> dict:
    """The tree factorization's new entries on its inputs: the bifurcation
    system; K9's d channel and r channel against their plain versions in the
    table's order bit for bit (and the reference's order), the apply's λ the
    two-channel pass's bits on the same core solution (its dc and rc too);
    on a dense core K11's gate and its solve on the stored factor (refined at
    ``CYCLIC_TOL``, unrefined at ``TOL``, and ``dense_core``'s bits); on a
    min-degree core the split K12a and K12b (:func:`core_split_checks`).
    ``timed``: each entry also timed with its bound (the kernels line's
    records are the web's and web1000's)."""
    from networks_fenicsx_tpu_torch.kernels import dense_core, peel

    dtp, ends, (f, sp, ep) = fac.device_tree_plan, fac.ends, rhs_args
    W, w, g, Ftot, _ = fac._condense(ends, state.R, f, sp, ep)
    assert torch.equal(W, state.W) and torch.equal(w, state.w), "K1: the factor's W, w bits"
    B, E, n_p, n_c = dtp.num_bifurcations, dtp.num_edges, dtp.n_peeled, dtp.core_size
    n_fac = peel_children(dtp)  # the peeled nodes with a parent: a factor and a pair each
    rec = {"w_equal": True, "rounds": len(dtp.rounds), "core": n_c,
           "peel_entries": [dtp.peel_table.n_forward, dtp.peel_table.n_back]}
    sums = (dtp.t_idx, dtp.s_idx, dtp.t_bins, dtp.s_bins, dtp.start_bif, dtp.end_bif)
    rec["bifurcation_system"] = check_pair(
        lambda: peel.bifurcation_system(dtp, W, g, Ftot, sp, ep),
        lambda: peel.bifurcation_system_plain(dtp, W, g, Ftot, sp, ep),
        (tensor_bytes(W, g, Ftot, sp, ep, sums) + 8 * (2 * B + E + 1), 10 * E + 2 * B) if timed
        else None)
    dr_f = peel.bifurcation_system(dtp, W)[0]  # the factor's: the diagonal alone
    dr = peel.bifurcation_system(dtp, W, g, Ftot, sp, ep)[0]
    assert torch.equal(dr_f, peel.bifurcation_system_plain(dtp, W)[0]), "the diagonal alone"
    assert torch.equal(dr_f[:, 0], dr[:, 0]) and not dr_f[:, 1].any(), "the diagonal's bits"
    wp = state.w_pairs
    pf = peel.peel_factor(dtp, dr_f, wp)
    # reads: the d channel's table words, each child's pair, the diagonal; writes: the saved
    # w and db, each child's factor (the rest of the factor is a fill before the launch), dc
    rec["peel_factor"] = check_pair(
        lambda: peel.peel_factor(dtp, dr_f, wp), lambda: peel.peel_factor_table_plain(dtp, dr_f, wp),
        (4 * peel_table_words(dtp, "d") + 8 * n_fac + 8 * B + 8 * (2 * n_p + n_fac + n_c),
         4 * n_p) if timed else None, exact=True)
    assert all(torch.equal(a, b) for a, b in zip(pf, peel.peel_factor_plain(dtp, dr_f, wp)))
    assert all(torch.equal(a, b) for a, b in zip(pf, state.peeled)), "peel_factor: repeat bits"
    cap = {}

    def core(rc):
        cap["rc"] = rc
        cap["x"] = fac._core_apply(state)(rc)
        return cap["x"]

    lam = peel.peel_apply(dtp, pf, dr, core)
    x = cap.get("x")

    def fixed(rc):
        return x

    # reads: the r channel's table words, each child's factor, the saved w and db, the rhs and
    # the core's solution; writes: rc and λ
    rec["peel_apply"] = check_pair(
        lambda: peel.peel_apply(dtp, pf, dr, fixed),
        lambda: peel.peel_apply_table_plain(dtp, pf, dr, fixed),
        (4 * peel_table_words(dtp, "r") + 8 * (n_fac + 2 * n_p) + 8 * B + 8 * (B + 2 * n_c),
         5 * n_p) if timed else None, exact=True)
    assert torch.equal(lam, peel.peel_apply_plain(dtp, pf, dr, fixed)), "K9 apply vs reference order"
    # the two-channel pass on the same system and core solution: λ, dc and rc bit for bit
    both = torch.stack([dr_f[:, 0], dr[:, 1]], dim=-1).contiguous()
    seen = {}

    def fused_core(dc, rc):
        seen["dc"], seen["rc"] = dc, rc
        return x

    assert torch.equal(lam, peel.peel(dtp, both, wp, fused_core)), "peel_apply vs peel"
    if n_c:
        assert torch.equal(seen["dc"], pf.dc) and torch.equal(seen["rc"], cap["rc"])
    rec["peel_apply"]["lambda_equal_fused_peel"] = True
    if timed:
        rec["fused_peel_ms"] = cuda_ms(lambda: peel.peel(dtp, both, wp, lambda dc, rc: x), reps=5)
    if dtp.ce is not None:
        rec.update(core_split_checks(dtp.ce, pf.dc, wp, cap["rc"], state.core, timed))
    elif n_c and dtp.mf is None:
        Lc, s, C, ok = state.core
        rc = cap["rc"]
        gate = dense_core.dense_gate(C)
        assert int(gate) == int(ok) == int(dense_core.dense_gate_plain(torch.tril(C))), "K11 gate"
        rec["dense_gate"] = check_pair(
            lambda: dense_core.dense_gate(C).double(),
            lambda: dense_core.dense_gate_plain(torch.tril(C)).double(),
            (8 * n_c + 4, 3 * n_c), exact=True)
        rec["dense_gate"]["ok"] = int(ok)
        n = n_c
        chol = torch.tril(C)
        rec["dense_solve"] = check_pair(
            lambda: dense_core.dense_solve(Lc, s, C, ok, rc),
            lambda: dense_core.dense_solve_plain(Lc, s, chol, ok, rc),
            (8 * (n * n + n * (n + 1) // 2 + 3 * n) + 4,
             (1 + dense_core.N_REFINE) * 2 * n * n + dense_core.N_REFINE * 2 * n * n),
            library=lambda: torch.cholesky_solve(((rc / s))[:, None], chol)[:, 0] / s,
            tol=CYCLIC_TOL)
        rec["dense_solve_unrefined"] = check_pair(
            lambda: dense_core.dense_solve(Lc, s, C, ok, rc, n_refine=0),
            lambda: dense_core.dense_solve_plain(Lc, s, chol, ok, rc, n_refine=0))
        ci, cj, pid = dtp.core_ci, dtp.core_cj, dtp.core_pid
        assert torch.equal(dense_core.dense_solve(Lc, s, C, ok, rc),
                           dense_core.dense_core(ci, cj, pid, pf.dc, rc, wp)), "dense_solve bits"
        rec["dense_solve"]["equal_dense_core"] = True
        rec["fused_dense_core_ms"] = cuda_ms(
            lambda: dense_core.dense_core(ci, cj, pid, pf.dc, rc, wp), reps=10)
    return rec


def core_engine_used(fac) -> tuple[tuple, tuple]:
    """The core engine's wrappers a factor and an apply launch on the tree
    route (none on the others)."""
    dtp = getattr(fac, "device_tree_plan", None)
    if dtp is None or not dtp.core_size:
        return (), ()
    if dtp.mf is not None:  # K10's folds in the multifrontal refinement
        return ("mf_factor",), ("mf_apply",) + (("fold_apply",) if dtp.mf.plan.n_refine > 0 else ())
    ce = dtp.ce
    if ce is None:
        return ("dense_core", "dense_gate"), ("dense_solve",)
    k12a = bool(ce.rounds or ce.dense_nodes.shape[0])
    f, a = (("core_factor",), ("core_apply",)) if k12a else ((), ())
    if ce.fronts:  # K12b, with K10's slot folds in its factor
        f += ("core_fronts_factor",) + (("fold_apply",) if any(fr.f_fold for fr in ce.fronts) else ())
        a += ("core_fronts_apply",)
    elif ce.dense_nodes.shape[0]:  # K11's factor (counted as dense_core's) and gate; its solve
        f += ("dense_core", "dense_gate")
        a += ("dense_solve",)
    assert k12a or ce.fronts
    return f, a


def factor_path(P, device, label: str, asm, kind: str, name_power: str,
                tree_plan=None) -> dict:
    """Factor reuse on one configuration, on :func:`factor_rhs_forms`'s
    ``kind``: the factor once (counted), then :data:`FACTOR_SOLVES` rhs-only
    solves with fresh f and p_bc (each counted, ``schur_factorized``, finite,
    conserving mass and equal to the fused solve of the same forms at the
    configuration's bar); then the new entries against their plain versions,
    the device launches of a factor and of an apply against the plans'
    (``torch.profiler``), and the factor's, the apply's and the fused
    executor's device time.  Through the public API (``tree_plan`` None):
    ``Solver.factorize()`` and ``Solver.solve()``, then the rhs-only
    ``compute_forms`` + ``solve()`` loop factorized (one read-only R, and a
    new R array a call) and fused, and the factorized call's host split
    (:func:`factor_host_split`).  On a forced core plan (``tree_plan``, the
    hook the reference's own tests force supernodal fronts with):
    ``build_tree_factorization(_tree_plan=...)`` against the fused tree
    executor on the same plan at ``CYCLIC_TOL``, and a ``solve_batch`` of
    the solves' rhs (each row ``solve()``'s bits)."""
    from networks_fenicsx_tpu_torch import factorization as F, kernels
    from networks_fenicsx_tpu_torch.solver import _schur_solve, build_schur_executor

    key = label.split()[0]
    mesh = asm.network
    rhs_forms = factor_rhs_forms(kind)
    rhs_forms(asm, 0)
    if tree_plan is None:
        tol = FACTOR_TOL[key]
        solver, fused = P.Solver(asm, device=device), P.Solver(asm, device=device)

        def factor():
            solver.factorize()
            return solver._factorization[:2]

        def solve(state):
            sol = solver.solve()
            assert solver.info.method == "schur_factorized" and solver.info.converged, solver.info
            return np.concatenate([np.asarray(fn.values).ravel() for fn in sol])

        def solve_fused():
            fused.solve()
            assert fused.info.method == "schur" and fused.info.converged, fused.info
            return fused.solution_vector()
    else:
        tol, opts = CYCLIC_TOL, P.SolverOptions(schur_method="tree")
        ex = build_schur_executor(asm, opts, device=device, _tree_plan=tree_plan)
        forced = F.build_tree_factorization(asm, opts, device=device, _tree_plan=tree_plan)
        rows = []

        def factor():
            return forced, forced.factor(asm.schur_arguments(device=False)[0])

        def solve(state):
            rows.append(asm.schur_arguments(device=False)[1:])
            out = forced.solve(state, *rows[-1])
            assert bool(out[-1]), label
            return forced.solution_vector(out)

        def solve_fused():
            x_fused, info = _schur_solve(asm, opts, ex)
            assert info.converged, info
            return x_fused
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fac, state = factor()
    torch.cuda.synchronize()
    factor_s = time.perf_counter() - t0
    factor_run = kernels.launches()
    assert type(fac).__name__ == FACTOR_CLASS[key], type(fac)
    used_f, used_a = FACTOR_USED[type(fac).__name__]
    core_f, core_a = core_engine_used(fac)
    assert all(factor_run[n] >= 1 for n in used_f + core_f), (label, factor_run)
    assert all(n == 0 for name, n in factor_run.items() if name not in used_f + core_f), factor_run
    runs, errs = [factor_run], []
    for s in range(1, FACTOR_SOLVES + 1):
        rhs_forms(asm, s)
        torch.cuda.synchronize()
        kernels.reset_launches()
        x = solve(state)
        torch.cuda.synchronize()
        run = kernels.launches()
        assert all(run[n] >= 1 for n in used_a + core_a), (label, run)
        assert all(n == 0 for name, n in run.items() if name not in used_a + core_a), (label, run)
        runs.append(run)
        assert x.shape == (asm.num_dofs,) and np.all(np.isfinite(x))
        imbalance, qmax = conservation(asm, x)
        assert imbalance <= 1e-10 * qmax, (label, imbalance, qmax)
        x_fused = solve_fused()
        err = float(np.abs(x - x_fused).max())
        scale = max(1.0, float(np.abs(x_fused).max()))
        assert err <= tol * scale, (label, s, err, scale, tol)
        errs.append(err / scale)
    same_order = None
    if key in FACTOR_SAME_ORDER:  # the same factorization on the plain versions (the CPU)
        cpu = P.Solver(asm, device="cpu")
        cpu.factorize()
        cpu.solve()
        assert cpu.info.method == "schur_factorized", cpu.info
        x_cpu = cpu.solution_vector()
        scale = max(1.0, float(np.abs(x_cpu).max()))
        same_order = float(np.abs(x - x_cpu).max()) / scale
        assert same_order <= FACTOR_SAME_ORDER[key], (label, same_order)
        del cpu
    if tree_plan is not None:
        batch = fac.solve_batch(state, *(np.stack(col) for col in zip(*rows)))
        for i, row in enumerate(rows):
            assert all(torch.equal(a, b) for a, b in zip((t[i] for t in batch),
                                                         fac.solve(state, *row))), (label, i)
    args = asm.schur_arguments()
    rhs_args = fac.prepare_rhs(*args[1:])
    if key == "headline":
        checks = blocked_factor_checks(fac, state, rhs_args)
    elif key == "lattice":
        checks = grid_factor_checks(fac, state, rhs_args)
    else:  # the forest's are not the kernels line's records: checked, not timed
        checks = tree_factor_checks(fac, state, rhs_args, timed=key != "forest")
    # device launches of one factor and one apply: the port's kernels in a profiler window
    want = factor_launches_want(fac)
    R_data = args[0]
    counted_window(lambda: 0, FACTOR_PATTERN, device)  # a process's first starts the tracer
    launch_rec = {}
    for part, run_part in (("factor", lambda: fac.factor(R_data)),
                           ("apply", lambda: fac.solve_prepared(state, rhs_args))):
        windows = launch_count_windows(lambda: (run_part(), want[part])[1], FACTOR_PATTERN, device)
        launch_rec[part] = check_launch_windows(f"{key}_{part}", windows, want[part])
        launch_rec[part].pop("windows")
    if tree_plan is None:
        ex = fused._executor
    ex_args = ex.prepare_args(*args)
    timing_rec = {
        "factor_ms": cuda_ms(lambda: fac.factor(R_data), reps=5),
        "apply_ms": cuda_ms(lambda: fac.solve_prepared(state, rhs_args), reps=10),
        "solve_ms": cuda_ms(lambda: fac.solve(state, *args[1:]), reps=10),
        "fused_ms": cuda_ms(lambda: ex(*ex_args), reps=10),
        "factor_share": device_share(lambda: fac.factor(R_data)),
        "apply_share": device_share(lambda: fac.solve_prepared(state, rhs_args)),
        "fused_share": device_share(lambda: ex(*ex_args)),
    }
    log(f"phase factor {label}: {type(fac).__name__}"
        + ("" if tree_plan is None else " on a forced plan")
        + f", {mesh.num_edges} edges, {mesh.num_multipliers} bifurcations, {asm.num_dofs} dofs; "
        f"factor {factor_s:.3f} s; {FACTOR_SOLVES} rhs-only solves vs the fused solve max "
        f"{max(errs):.3e} of scale (bar {tol:.0e})"
        + ("" if same_order is None else f", vs its plain versions (CPU) "
           f"{same_order:.3e} (bar {FACTOR_SAME_ORDER[key]:.0e})")
        + ("" if tree_plan is None else ", solve_batch rows bit for bit")
        + f"; launches factor {nonzero(factor_run)}, a solve {nonzero(runs[-1])}; "
        f"device launches {json.dumps(launch_rec)}")
    log(f"phase timing factor {label}: CUDA events: factor {timing_rec['factor_ms']:.4f} ms, "
        f"apply (rhs resident) {timing_rec['apply_ms']:.4f} ms, solve (rhs uploaded) "
        f"{timing_rec['solve_ms']:.4f} ms, fused executor {timing_rec['fused_ms']:.4f} ms; "
        f"profiled device busy: factor {timing_rec['factor_share']['busy_ms']} ms, apply "
        f"{timing_rec['apply_share']['busy_ms']} ms, fused {timing_rec['fused_share']['busy_ms']} "
        f"ms; card {name_power}")
    log(f"phase kernels-factor ({key}): " + json.dumps(checks))
    summed = {name: sum(r[name] for r in runs) for name in runs[0]}
    rec = {"launches": summed, "checks": checks, "errs": errs, "device_launches": launch_rec,
           "timing": timing_rec, "same_order": same_order}
    if tree_plan is None:
        rec["loops_ms"] = loops = {}  # compute_forms + solve, ms
        for name, s_forms, s_solver in (("factorized", rhs_forms, solver),
                                        ("factorized_new_R", factor_rhs_forms(kind, fresh_R=True),
                                         solver),
                                        ("fused", rhs_forms, fused)):
            loops[name] = []
            for s in range(FACTOR_SOLVES):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                s_forms(asm, s + 1)
                s_solver.solve()
                torch.cuda.synchronize()
                loops[name].append((time.perf_counter() - t1) * 1e3)
            want_method = "schur" if s_solver is fused else "schur_factorized"
            assert s_solver.info.method == want_method, (name, s_solver.info)
        rec["host_ms"] = host = factor_host_split(solver, asm, rhs_forms)
        log(f"phase loops factor {label}: compute_forms+solve ms, factorized on one read-only R "
            f"{loops['factorized']}, on a new R array a call {loops['factorized_new_R']}, fused "
            f"{loops['fused']}; best ms of a factorized compute_forms + solve by step "
            f"{json.dumps(host)}; card {name_power}")
    return rec


def factor_phases(P, device, name_power: str, serial: dict, fronts128: tuple) -> dict:
    """The factor-reuse slice on seven configurations at full width: the
    headline tree (blocked), the 512² lattice (grid), the 100k forest and
    the 100k web (peel rounds, then the multifrontal core), web1000 (a
    455-node dense core) and web2k (a 1,994-node core: min-degree rounds
    and a 628-node dense tail) — the serial phases' assemblers, their forms
    put back after — each through :func:`factor_path`, and the 128²
    lattice on its forced supernodal-fronts plan (``fronts128``: the
    assembler and the plan; rounds in a cooperative grid, then K12b)."""
    paths = {}
    plan = (("headline tree", "tree", "poiseuille", bed_forms),
            ("lattice 512^2", "lattice", "lattice", lattice_forms),
            ("forest 100k", "forest", "forest", forest_forms),
            ("web 100k", "web", "forest", forest_forms))
    for label, key, kind, restore in plan:
        asm = serial[key][0]
        paths[label.split()[0]] = factor_path(P, device, label, asm, kind, name_power)
        restore(asm)
    paths["web1000"] = factor_path(P, device, "web1000 (455-node dense core)",
                                   web_assembler(P, sites=1_000), "forest", name_power)
    paths["web2k"] = factor_path(P, device, "web2k (min-degree rounds + 628-node dense tail)",
                                 web2k_assembler(P), "forest", name_power)
    grid, plan = fronts128
    paths["fronts128"] = factor_path(P, device, "fronts128 (128^2 forced supernodal fronts)",
                                     grid, "forest", name_power, tree_plan=plan)
    grid128_forms(grid)
    return paths


def panel_launch_phase(P, device) -> dict:
    """The tiled Cholesky's panel and trailing launches (``panel_launches``)
    in one call of K12b on the 128² lattice's forced fronts (set (i)'s
    inputs), K11 at 455 and 4,096 nodes (set (j)'s) and K19c's coarsest
    factor on the 512² lattice's bottom level (set (l)'s).  Run after the
    launch-count phases: each profiler session before them makes the
    profiler lose more of a later window's first records."""
    from networks_fenicsx_tpu_torch.kernels import core_fronts, dense_core, mg2d
    from networks_fenicsx_tpu_torch.multigrid import Mg2dPreconditioner

    grid = grid128_assembler(P)
    inp = core_inputs(P, grid, device, nd_tree_plan(P, grid, **FRONTS_KWARGS))
    dcp, st, w_pairs, r_fw = inp["dcp"], inp["st"], inp["w_pairs"], inp["r_fw"]
    out = {"core_fronts (fronts128)": panel_launches(
        lambda: core_fronts.core_fronts(dcp, st.d, st.ustream[:-1], w_pairs, r_fw.clone()))}
    for n in (455, K11_TIMED):
        args = spd_laplacian(n, device, seed=n)
        out[f"dense_core ({n})"] = panel_launches(lambda: dense_core.dense_core(*args))
    opts = P.SolverOptions(schur_method="cg")
    ex, diag, _, _, cw = cg_system(P, lattice_assembler(P, forms=cg512_forms), device, opts)
    plan = ex.precond_plan
    pre = Mg2dPreconditioner(plan, cw, diag, plain=True)
    coarse = (plan.bottom_offsets, pre.bottom[:4], pre.bottom[mg2d.FD])
    out["mg2d coarse_factor (512^2)"] = panel_launches(lambda: mg2d.coarse_factor(*coarse))
    return out


# ---------------------------------------------------------------- sweeps

SWEEP_S = 16  # scenarios of a full-width sweep
SWEEP_SCALES = np.linspace(0.5, 2.0, SWEEP_S)  # the scales of demos/demo_sweep.py
SWEEP_ROWS = (0, 7, 15)  # rows held against Solver.solve() bit for bit
SWEEP_REPS = 3  # timed sweeps (best of)
# the kernels of a sweep's launches: K1's scenario kernel, K2–K4's, K5's
SCENARIO_PATTERNS = {"condense": r"\bcondense_scen_kernel\b", "tree_sweep": SWEEP_PATTERN,
                     "expand": r"\bexpand_kernel\b"}
# the scenario wrappers: the kernel-check cases that hold each, and the one timed
SCENARIO_CHECKS = {
    "condense_scenarios": "headline_R16",
    "tree_sweep_scenarios": "headline_R16",
    "tree_sweep_apply_scenarios": "headline_pbc16",
    "expand_scenarios": "headline_R16",
}


def sweep_launch_counts(key: str, run_sweep, want: dict, device) -> dict:
    """A sweep's launches of each blocked kernel (``want``: kernel ->
    launches) as its wrappers report them and as ``torch.profiler`` counts
    them in the same window (:func:`launch_count_windows`), with their
    device µs; fails unless both equal ``want``."""
    from networks_fenicsx_tpu_torch.kernels import condense, expand, tree_sweep

    counters = {"condense": lambda: condense.condense_scenarios.launches,
                "tree_sweep": lambda: (tree_sweep.tree_sweep_scenarios.device
                                       + tree_sweep.tree_sweep_apply_scenarios.device
                                       + tree_sweep.tree_sweep_factor.device),
                "expand": lambda: expand.expand_scenarios.launches}
    out = {}
    for kernel, n in want.items():
        def run(count=counters[kernel]):
            before = count()
            run_sweep()
            return count() - before

        run()
        torch.cuda.synchronize()
        counted_window(lambda: 0, SCENARIO_PATTERNS[kernel], device)  # starts the tracer
        windows = launch_count_windows(run, SCENARIO_PATTERNS[kernel], device)
        rec = check_launch_windows(f"{key}:{kernel}", windows, n)
        out[kernel] = {"launches": rec["profiler"], "device_us": windows[-1]["us"] or None,
                       "windows": len(windows)}
    return out


def best_ms(fn, reps: int = SWEEP_REPS) -> float:
    """Best of ``reps`` CUDA-synchronised host-clock milliseconds of ``fn()``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def headline_sweep(P, device, asm, label: str, batch: dict, forms_of_row, R0) -> dict:
    """One full-width sweep through ``solve_sweep`` on the card, counted:
    every wrapper's launches set to 0 just before it and read just after
    (the blocked scenario kernels must all have launched, nothing else of
    the route); rows :data:`SWEEP_ROWS` against ``Solver.solve()`` of that
    row, the blocks by ``torch.equal`` and ``x`` by ``np.array_equal``; the
    profiler's kernel counts against the wrappers'."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.kernels import tree_sweep

    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0)
    P.solve_sweep(asm, device=device, **batch)  # the executor, built once and cached
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = P.solve_sweep(asm, device=device, **batch)
    torch.cuda.synchronize()
    launches = kernels.launches()
    r_batch = "R" in batch
    used = ["condense_scenarios", "expand_scenarios",
            "tree_sweep_scenarios" if r_batch else "tree_sweep_apply_scenarios"]
    if not r_batch:
        used.append("tree_sweep_factor")
    assert all(launches[n] == 1 for n in used), (label, launches)
    assert all(v == 0 for n, v in launches.items() if n not in used), (label, launches)
    ex = list(asm._sweep_cache.values())[-1][1]
    assert type(ex).__name__ == "_BlockedExecutor" and ex.has_scenario_axis, type(ex)
    dp = ex.device_plan

    sweep_ms = best_ms(lambda: P.solve_sweep(asm, device=device, **batch))
    share = device_share(lambda: P.solve_sweep(asm, device=device, **batch))
    res = P.solve_sweep(asm, device=device, **batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = res.x
    flatten_ms = (time.perf_counter() - t0) * 1e3
    assert x.shape == (SWEEP_S, DOFS) and np.all(np.isfinite(x)), x.shape

    solver = P.Solver(asm, device=device)
    rows = {}
    for i in SWEEP_ROWS:
        forms_of_row(i)
        solver.solve()
        assert solver.info.converged and solver.info.method == "schur", solver.info
        same_x = np.array_equal(solver.solution_vector(), x[i])
        sx = solver._executor
        one = sx(*sx.prepare_args(*asm.schur_arguments()))
        same_blocks = all(torch.equal(res.blocks[j][i], one[j]) for j in range(3))
        assert same_x and same_blocks, (label, i, same_x, same_blocks)
        rows[i] = True

    want_k24 = (tree_sweep.cuda_launches(dp, tree_sweep.FULL) if r_batch
                else tree_sweep.cuda_launches(dp, tree_sweep.FACTOR)
                + tree_sweep.cuda_launches(dp, tree_sweep.APPLY))
    counts = sweep_launch_counts(label, lambda: P.solve_sweep(asm, device=device, **batch),
                                 {"condense": 1, "tree_sweep": want_k24, "expand": 1}, device)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0)
    return {"res": res, "launches": launches, "sweep_ms": sweep_ms, "flatten_ms": flatten_ms,
            "device": share, "rows_bit_for_bit": sorted(rows), "counts": counts}


def scenario_inputs(dp, N: int, R_mode: str, f_mode: str, S: int, shared, seed: int, device):
    """Random inputs of the scenario kernels on ``dp`` (internal layout): each
    of R, f, sp, ep batched ``(S, ...)`` unless named in ``shared``; the
    boundary data zero where an end is a bifurcation."""
    E = dp.num_edges
    rng = np.random.default_rng(seed)
    shapes = {"scalar": (1,), "edge": (E,), "cell": (N, E)}
    plan = dp.plan

    def t(name, shape, lo, hi, mask=None):
        full = shape if name in shared else (S,) + shape
        a = rng.uniform(lo, hi, full)
        if mask is not None:
            a = a * ~mask
        return torch.as_tensor(a, device=device)

    return (t("R", shapes[R_mode], 0.5, 2.0), t("f", shapes[f_mode], -1.0, 1.0),
            t("sp", (E,), -1.0, 1.0, plan.s_is_bif), t("ep", (E,), -1.0, 1.0, plan.t_is_bif))


def compare_scenario_kernels(dp, N: int, k: int, h, ins, R_mode: str, f_mode: str,
                             timed: bool) -> dict:
    """Each scenario wrapper on the card against the one-scenario wrapper a
    row (``torch.equal``: the same per-scenario body) and against its plain
    version (the one-scenario plain version a row, stacked) at
    :data:`TOL`·scale — ``torch.equal`` for K1 without a per-cell sum and
    for K2–K4 in the kernels' (blocked) order; timed with its bound."""
    from networks_fenicsx_tpu_torch.kernels import condense, expand, tree_sweep

    R, f, sp, ep = ins
    r_dims = 1 if R_mode != "cell" else 2
    f_dims = 1 if f_mode != "cell" else 2
    S = next(t.shape[0] for t, n in zip(ins, (r_dims, f_dims, 1, 1)) if t.dim() > n)

    def row(t, dims, i):
        return t[i] if t.dim() > dims else t

    rec = {}
    E, B = dp.num_edges, dp.num_bifurcations
    cell = "cell" in (R_mode, f_mode)

    def hold(name, got, ones, plain, exact, work, kernel, plain_fn):
        torch.cuda.synchronize()
        ft = float_tensors(got)
        assert all(torch.equal(a, b) for a, b in zip(ft, float_tensors(ones))), (name, "rows")
        err, scale = max_err(got, plain)
        assert err <= TOL * scale, (name, err, scale)
        equal = all(torch.equal(a, b) for a, b in zip(ft, float_tensors(plain)))
        if exact:
            assert equal, (name, "not bit for bit against the plain version")
        r = {"max_abs_err": err, "scale": scale, "rows_equal": True, "equal": equal, "S": S}
        if timed:
            r["ms"] = cuda_ms(kernel)
            r["plain_ms"] = cuda_ms(plain_fn, reps=3, warmup=1)
            r.update(bound(*work))
            r["library_ms"] = None
        rec[name] = r

    c_args = (dp, N, k, h, R, f, R_mode, f_mode, sp, ep)
    k1 = lambda: condense.condense_scenarios(*c_args)  # noqa: E731
    k1_plain = lambda: condense.condense_scenarios_plain(*c_args)  # noqa: E731
    out = k1()
    ones = torch.stack([torch.stack(condense.condense(dp, N, k, h, row(R, r_dims, i),
                                                      row(f, f_dims, i), R_mode, f_mode,
                                                      row(sp, 1, i), row(ep, 1, i)))
                        for i in range(S)], dim=1)
    hold("condense_scenarios", out, ones, k1_plain(), not cell,
         (tensor_bytes(h, R, f, sp, ep, dp.edge_src, dp.edge_tgt, out), 12 * E * S * (N if cell else 1)),
         k1, k1_plain)
    W, w, g, Ftot, const = out
    plan_b = tensor_bytes(dp.bif_in, dp.bif_out, dp.bif_parent, dp.sweep.levels)
    if R.dim() > r_dims:
        s_args = (dp, w, const, Ftot)
        k2 = lambda: tree_sweep.tree_sweep_scenarios(*s_args)  # noqa: E731
        k2_plain = lambda: tree_sweep.tree_sweep_scenarios_plain(*s_args)  # noqa: E731
        got = k2()
        ones = [torch.stack(col) for col in zip(*(tree_sweep.tree_sweep(dp, w[i], const[i], Ftot[i])
                                                 for i in range(S)))]
        blk = tree_sweep.tree_sweep_scenarios_plain(*s_args, blocked=True)
        assert all(torch.equal(a, b) for a, b in zip(got, blk)), "tree_sweep_scenarios vs blocked"
        hold("tree_sweep_scenarios", got, ones, k2_plain(), False,
             (tensor_bytes(w, const, Ftot, got) + plan_b, (16 * B + 4 * dp.bif_out.numel()) * S),
             k2, k2_plain)
        rec["tree_sweep_scenarios"]["blocked_equal"] = True
        lam = got[0]
    else:
        fac = tree_sweep.tree_sweep_factor(dp, w[0])
        a_args = (dp, *fac, const, Ftot)
        k3 = lambda: tree_sweep.tree_sweep_apply_scenarios(*a_args)  # noqa: E731
        k3_plain = lambda: tree_sweep.tree_sweep_apply_scenarios_plain(*a_args)  # noqa: E731
        got = k3()
        ones = [torch.stack(col) for col in zip(*(tree_sweep.tree_sweep_apply(dp, *fac, const[i],
                                                                              Ftot[i])
                                                 for i in range(S)))]
        blk = tree_sweep.tree_sweep_apply_scenarios_plain(*a_args, blocked=True)
        assert all(torch.equal(a, b) for a, b in zip(got, blk)), "apply_scenarios vs blocked"
        hold("tree_sweep_apply_scenarios", got, ones, k3_plain(), False,
             (tensor_bytes(fac, const, Ftot, got) + plan_b, 8 * B * S + 4 * dp.bif_out.numel() * S),
             k3, k3_plain)
        rec["tree_sweep_apply_scenarios"]["blocked_equal"] = True
        lam = got[0]
    x_args = (dp, N, k, lam, sp, ep, W, w, g, Ftot, h, R, f, R_mode, f_mode)
    k5 = lambda: expand.expand_scenarios(*x_args)  # noqa: E731
    k5_plain = lambda: expand.expand_scenarios_plain(*x_args)  # noqa: E731
    got = k5()
    ones = [torch.stack(col) for col in zip(*(expand.expand(
        dp, N, k, lam[i], row(sp, 1, i), row(ep, 1, i), W[i], w[i], g[i], Ftot[i], h,
        row(R, r_dims, i), row(f, f_dims, i), R_mode, f_mode) for i in range(S)))]
    assert torch.equal(got[2], ones[2]), "expand_scenarios: finite flags"
    hold("expand_scenarios", got, ones, k5_plain(), False,
         (tensor_bytes(lam, sp, ep, W, w, g, Ftot, h, R, f, dp.edge_src, dp.edge_tgt, got[:2]),
          10 * (k * N + 1) * E * S), k5, k5_plain)
    return rec


def scenario_kernel_sets(P, device, asm) -> dict:
    """The scenario kernels on the card, S ∈ {1, 16}, batched and shared
    inputs mixed: the headline tree (k = 1, per-edge R; an R batch, a p_bc
    batch, S = 1) timed, and a 10-generation tree at N = 8 in every mode at
    k = 1 and 2."""
    from networks_fenicsx_tpu_torch.solver import build_schur_executor

    out = {}
    ex = build_schur_executor(asm, P.SolverOptions(), device=device)
    dp, N, h = ex.device_plan, asm.network.N, ex._h_e
    R0 = torch.as_tensor(ex.prepare_args(*asm.schur_arguments())[0], device=device)
    scales = torch.as_tensor(SWEEP_SCALES, device=device)
    zero_f = torch.zeros(1, dtype=torch.float64, device=device)
    sp, ep = scenario_inputs(dp, N, "edge", "scalar", SWEEP_S, (), 1, device)[2:]
    cases = {
        "headline_R16": ((R0[None] * scales[:, None]).contiguous(), zero_f, sp[0], ep[0]),
        "headline_pbc16": (R0, zero_f, sp, ep),
        "headline_S1": (R0[None].contiguous(), zero_f, sp[:1].contiguous(), ep[0]),
        "headline_pbc1": (R0, zero_f, sp[:1].contiguous(), ep[:1].contiguous()),
    }
    for name, ins in cases.items():
        out[name] = compare_scenario_kernels(dp, N, 1, h, ins, "edge", "scalar",
                                             timed=name in ("headline_R16", "headline_pbc16"))
    small = arterial_assembler(P, 10, 8, k=2, per_cell=True, seed=3)
    for k in (1, 2):
        a = P.HydraulicNetworkAssembler(small.network, flux_degree=k, pressure_degree=0)
        a.compute_forms(p_bc_ex=lambda x: x[1])
        sx = build_schur_executor(a, P.SolverOptions(), device=device)
        for j, (Rm, fm) in enumerate((R_, f_) for R_ in ("scalar", "edge", "cell")
                                     for f_ in ("scalar", "edge", "cell")):
            for S, shared in ((SWEEP_S, ("f", "ep")), (SWEEP_S, ("R",)), (1, ("sp",))):
                ins = scenario_inputs(sx.device_plan, 8, Rm, fm, S, shared, 10 * k + j, device)
                key = f"small_k{k}_{Rm}_{fm}_S{S}_{'Rshared' if 'R' in shared else 'Rbatched'}"
                out[key] = compare_scenario_kernels(sx.device_plan, 8, k, sx._h_e, ins, Rm, fm,
                                                    timed=False)
    return out


def row_route_sweeps(P, device) -> dict:
    """A sweep on a route that runs its rows (web2k under
    ``schur_method="tree"``: its min-degree core has no scenario axis yet)
    and on a 32² lattice (under ``auto`` the
    grid route, which now takes the scenario axis), each row against the
    row's ``Solver.solve()``: bit for bit on the same route, at the
    reference's tolerances against ``Solver``'s own route under ``auto``;
    and the small demo tree on the batched dense route (``auto``) beside the
    batched blocked route (``schur_method="tree"``), timed."""
    out = {}
    # demos/demo_sweep.py: make_arterial_tree(6), N = 10, per-edge R, S = 16
    small = arterial_assembler(P, 6, 10)
    R0 = 1.0 / small.network.edge_radius**4
    Rb = R0[None] * SWEEP_SCALES[:, None]
    tree = P.SolverOptions(schur_method="tree")
    dense = P.solve_sweep(small, R=Rb, device=device)
    ex = list(small._sweep_cache.values())[-1][1]
    assert type(ex).__name__ == "_DenseExecutor" and ex.has_scenario_axis, type(ex)
    blocked = P.solve_sweep(small, R=Rb, options=tree, device=device)
    assert list(small._sweep_cache.values())[-1][1].has_scenario_axis
    xd, xb = dense.x, blocked.x
    scale = max(1.0, float(np.abs(xb).max()))
    err = float(np.abs(xd - xb).max())
    assert err <= 1e-11 * scale, (err, scale)
    for i in SWEEP_ROWS:
        small.compute_forms(p_bc_ex=lambda x: x[1], R=Rb[i])
        s = P.Solver(small, options=P.SolverOptions(schur_method="dense"), device=device)
        s.solve()
        assert np.array_equal(s.solution_vector(), xd[i]), ("dense sweep rows", i)
    small.compute_forms(p_bc_ex=lambda x: x[1], R=R0)
    out["demo_tree"] = {
        "edges": small.network.num_edges, "bifurcations": small.network.num_multipliers,
        "dofs": small.num_dofs, "S": SWEEP_S, "dense_vs_blocked": err, "scale": scale,
        "dense_ms": best_ms(lambda: P.solve_sweep(small, R=Rb, device=device)),
        "blocked_ms": best_ms(lambda: P.solve_sweep(small, R=Rb, options=tree, device=device)),
        "dense_device": device_share(lambda: P.solve_sweep(small, R=Rb, device=device)),
        "blocked_device": device_share(lambda: P.solve_sweep(small, R=Rb, options=tree,
                                                             device=device)),
    }

    # a lattice under auto: the DCT solve on the grid route's scenario axis
    lat = lattice_assembler(P, 32, 32, N=2)
    lat.compute_forms(p_bc_ex=lambda x: x[0], f=0.3, R=1.0)
    fb = np.random.default_rng(11).uniform(-1.0, 1.0, (4, 1))
    res = P.solve_sweep(lat, f=fb, device=device)
    ex = list(lat._sweep_cache.values())[-1][1]
    assert type(ex).__name__ == "_GridExecutor" and ex.has_scenario_axis, type(ex)
    errs = []
    for i in range(4):
        lat.compute_forms(p_bc_ex=lambda x: x[0], f=float(fb[i, 0]), R=1.0)
        s = P.Solver(lat, options=P.SolverOptions(schur_method="dct"), device=device)
        s.solve()
        assert np.array_equal(s.solution_vector(), res.x[i]), ("lattice rows", i)
        a = P.Solver(lat, device=device)
        a.solve()
        ref = a.solution_vector()
        errs.append(float(np.abs(res.x[i] - ref).max()) / max(1.0, float(np.abs(ref).max())))
        assert errs[-1] <= LATTICE_TOL, errs
    out["lattice32"] = {"dofs": lat.num_dofs, "S": 4, "vs_auto_solve": max(errs)}

    # web2k under schur_method="tree": a min-degree core (K12a), a row at a time
    web = web2k_assembler(P)
    Rw = web.schur_arguments()[0]
    Rwb = Rw[None] * np.array([[1.0], [1.5]])
    opts = P.SolverOptions(schur_method="tree")
    t0 = time.perf_counter()
    res = P.solve_sweep(web, R=Rwb, options=opts, device=device)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    ex = list(web._sweep_cache.values())[-1][1]
    assert type(ex).__name__ == "_TreeExecutor" and not ex.has_scenario_axis, type(ex)
    assert ex.device_plan.ce is not None and ex.device_plan.mf is None
    x = res.x
    for i in range(2):
        web.compute_forms(p_bc_ex=lambda x: x[0], R=Rwb[i])
        s = P.Solver(web, options=opts, device=device)
        s.solve()
        assert np.array_equal(s.solution_vector(), x[i]), ("web2k rows", i)
    out["web2k_tree"] = {"dofs": web.num_dofs, "S": 2, "first_sweep_ms": first_ms,
                         "core_rounds": len(ex.device_plan.ce.rounds), "rows_bit_for_bit": True}
    return out


# ---------------------------------------------------------------- dense sweeps

DENSE_GENERATIONS = 13  # make_arterial_tree(13): 4,095 bifurcations, the top of auto's dense band
DENSE_N = 10
WEB455 = 456  # make_random_network(456, keep=0.7, num_boundary=8, seed=5): 455 bifurcations
DENSE_TRIP_ROW = 5  # the R row of a kernel set that trips the pivot gate
EDGE_CELLS = 4_096  # the network without bifurcations: one edge of 4,096 cells
# the dense route's scenario wrappers, and the kernel-check case that times each
DENSE_SCENARIO_CHECKS = {
    "edge_data_scenarios": "dense_tree13_R16",
    "bifurcation_system_scenarios": "dense_tree13_R16",
    "segsum_plan_scenarios": "dense_tree13_R16",
    "dense_factor_scenarios": "dense_tree13_R16",
    "dense_gate_scenarios": "dense_tree13_R16",
    "dense_solve_scenarios": "dense_tree13_R16",
    "backsub_scenarios": "dense_tree13_R16",
}


def dense_calls(ex, S: int, r_batch: bool) -> dict:
    """The wrapper counts a dense sweep of S scenarios must show: each
    scenario wrapper once, K11's a chunk (an R batch) or the factor and gate
    once on the shared R (``dense_core`` counts ``dense_factor``; ``segsum``
    the pair sums of one R)."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    B = ex.device_plan.num_bifurcations
    chunks = -(-S // dense_core.scenario_chunk(B, r_batch, ex.scenario_budget))
    want = {"edge_data_scenarios": 1, "bifurcation_system_scenarios": 1, "backsub_scenarios": 1,
            "dense_solve_scenarios": chunks}
    if r_batch:
        want.update(segsum_plan_scenarios=2, dense_factor_scenarios=chunks,
                    dense_gate_scenarios=chunks)
    else:
        want.update(segsum_plan_scenarios=1, segsum=1, dense_core=1, dense_gate=1)
    return want


def route_sweep_path(P, device, asm, label: str, batch: dict, row_forms, base_forms,
                     method: str, executor: str, calls, families: dict, blocked: bool = False,
                     solves: bool = False, sweep_method: str = "auto") -> dict:
    """One sweep through ``solve_sweep`` under ``schur_method=sweep_method``
    (``auto`` by default) on the card, on the route of ``executor``
    (``schur_method=method`` for one solve), counted
    (every wrapper's launches set to 0 just before it and read just after:
    the scenario wrappers as ``calls(ex, S, R batched)`` says, nothing
    else); rows :data:`SWEEP_ROWS` against ``Solver(schur_method=method)``
    of that row, ``x`` by ``np.array_equal`` and the blocks by
    ``torch.equal``; the whole sweep against the same sweep a row at a time
    (``batch._run_rows``, the route before its scenario axis) bit for bit;
    ``blocked``: against the batched blocked route's at 1e-11·scale; its
    time without ``.x`` (and a row at a time, and with ``solves`` as S
    ``compute_forms`` + ``solve()``), the device's busy time, idle share and
    launches, and its device time by kernel family (``families``)."""
    from networks_fenicsx_tpu_torch import batch as PB
    from networks_fenicsx_tpu_torch import kernels

    if sweep_method != "auto":
        batch = {**batch, "options": P.SolverOptions(schur_method=sweep_method)}
    base_forms()
    P.solve_sweep(asm, device=device, **batch)  # the executor, built once and cached
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = P.solve_sweep(asm, device=device, **batch)
    torch.cuda.synchronize()
    launches = kernels.launches()
    ex = list(asm._sweep_cache.values())[-1][1]
    assert type(ex).__name__ == executor and ex.has_scenario_axis, (label, type(ex))
    S = next(int(np.shape(v)[0]) for k, v in batch.items() if k != "options")
    want = calls(ex, S, "R" in batch)
    got = {n: v for n, v in launches.items() if v}
    assert got == want, (label, got, want)
    sweep_ms = best_ms(lambda: P.solve_sweep(asm, device=device, **batch))
    share = device_share(lambda: P.solve_sweep(asm, device=device, **batch))
    x = res.x
    assert x.shape == (S, asm.num_dofs) and np.all(np.isfinite(x)), (label, x.shape)
    key = next(k for k, e in asm._sweep_cache.items() if e[1] is ex)
    entry = asm._sweep_cache[key]
    asm._sweep_cache[key] = (PB._run_rows, *entry[1:])  # the same executor, a row a call
    try:
        assert np.array_equal(P.solve_sweep(asm, device=device, **batch).x, x), (label, "rows")
        rows_ms = best_ms(lambda: P.solve_sweep(asm, device=device, **batch))
    finally:
        asm._sweep_cache[key] = entry
    solver = P.Solver(asm, options=P.SolverOptions(schur_method=method), device=device)
    for i in SWEEP_ROWS:
        row_forms(i)
        solver.solve()
        assert solver.info.converged, (label, i, solver.info)
        sx = solver._executor
        one = sx(*sx.prepare_args(*asm.schur_arguments()))
        same_x = np.array_equal(solver.solution_vector(), x[i])
        same_blocks = all(torch.equal(res.blocks[j][i], one[j]) for j in range(3))
        assert same_x and same_blocks, (label, i, same_x, same_blocks)
    base_forms()
    rec = {"S": S, "B": asm.network.num_multipliers, "dofs": asm.num_dofs, "sweep_ms": sweep_ms,
           "rows_ms": rows_ms, "device": share, "wrapper_calls": want,
           "rows_bit_for_bit": list(SWEEP_ROWS),
           "device_split": device_split(lambda: P.solve_sweep(asm, device=device, **batch),
                                        families)}
    if solves:
        def loop():
            for i in range(S):
                row_forms(i)
                solver.solve()

        loop()
        rec["solves_ms"] = best_ms(loop, reps=2)
        rec["solves_device"] = device_share(loop)
        base_forms()
    if blocked:
        tree = P.SolverOptions(schur_method="tree")
        xb = P.solve_sweep(asm, options=tree, device=device,
                           **{k: v for k, v in batch.items() if k != "options"}).x
        assert list(asm._sweep_cache.values())[-1][1].has_scenario_axis
        scale = max(1.0, float(np.abs(xb).max()))
        err = float(np.abs(x - xb).max())
        assert err <= 1e-11 * scale, (label, err, scale)
        rec.update(dense_vs_blocked=err, scale=scale,
                   blocked_ms=best_ms(lambda: P.solve_sweep(
                       asm, options=tree, device=device,
                       **{k: v for k, v in batch.items() if k != "options"})))
    return {"rec": rec, "launches": launches}


def dense_sweep_path(P, device, asm, label: str, batch: dict, row_forms, base_forms,
                     blocked: bool = False) -> dict:
    """:func:`route_sweep_path` on the dense route: the wrapper calls of
    :func:`dense_calls`, rows against ``Solver(schur_method="dense")``."""
    return route_sweep_path(P, device, asm, label, batch, row_forms, base_forms, "dense",
                            "_DenseExecutor", dense_calls, DENSE_FAMILIES, blocked=blocked)


K11_KERNELS = r"\b(tiled_\w+|tc_\w+|ts_\w+)_kernel\b"  # K11's kernels (dense_core.cu's and the header's)
# a dense sweep's kernels by family, for its device split
DENSE_FAMILIES = {"K8a": r"\bedge_\w+_kernel\b", "system": r"\blambda_prepare_scen_kernel\b",
                  "K6": r"\bsegsum_plan_kernel\b", "K11": K11_KERNELS,
                  "K8b": r"\bbacksub_blocks_kernel\b"}


def device_split(run, families: dict) -> dict | None:
    """One ``run()`` under ``torch.profiler``: device µs and launches of each
    family of ``families`` and of the rest (copies and PyTorch's kernels);
    None where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {name: {"us": 0.0, "launches": 0} for name in (*families, "other")}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((n for n, pat in families.items() if re.search(pat, ev.key)), "other")
        out[name]["us"] += getattr(ev, "device_time_total", 0.0) or 0.0
        out[name]["launches"] += ev.count
    return out if any(v["us"] for v in out.values()) else None


def padded_split(run, families: dict, device, setup=lambda: None, attempts: int = 6) -> dict:
    """:func:`device_split` of ``run(setup())`` in a padded window (``setup``
    outside it): :func:`start_padding`'s ``neg_`` kernels before the run and
    :data:`PAD_KERNELS` ``abs_`` after it on a vector of their own (a gradient's own kernels
    include ``add`` and ``mul``), left out of the families and the rest;
    taken again, at most ``attempts`` times, until it holds its run
    (:func:`holds_its_run`).  ``windows`` counts the windows taken, ``holds``
    says whether the last held its run."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.ones(64, dtype=torch.float64, device=device)
    run(setup())
    torch.cuda.synchronize()
    for taken in range(1, attempts + 1):
        state = setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start_padding(pad.neg_)
            run(state)
            torch.cuda.synchronize()
            for _ in range(PAD_KERNELS):
                pad.abs_()
            torch.cuda.synchronize()
        out = {name: {"us": 0.0, "launches": 0} for name in (*families, "other")}
        window = {"pad_start": 0, "pad_end": 0}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if re.search(r"(?i)neg", ev.key):
                window["pad_start"] += ev.count
                continue
            if re.search(r"(?i)abs", ev.key):
                window["pad_end"] += ev.count
                continue
            name = next((n for n, pat in families.items() if re.search(pat, ev.key)), "other")
            out[name]["us"] += getattr(ev, "device_time_total", 0.0) or 0.0
            out[name]["launches"] += ev.count
        if holds_its_run(window):
            break
    return {**out, "windows": taken, "holds": holds_its_run(window)}


def kernel_counts(run, device) -> dict:
    """``{kernel or copy name: count}`` of the device events of one
    ``torch.profiler`` window around ``run()``, padded as
    :func:`counted_window` pads (the padding left out); None when the
    window does not hold its run (:func:`holds_its_run`)."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(64, dtype=torch.float64, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start_padding(lambda: pad.add_(1.0))
        run()
        torch.cuda.synchronize()
        for _ in range(PAD_KERNELS):
            pad.mul_(1.0)
        torch.cuda.synchronize()
    counts, pads = {}, {"pad_start": 0, "pad_end": 0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if re.search(r"(?i)add", ev.key):
            pads["pad_start"] += ev.count
        elif re.search(r"(?i)mul", ev.key):
            pads["pad_end"] += ev.count
        else:
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return counts if holds_its_run(pads) else None


def dense_launches_vs_S(P, device, asm, make_batch, label: str) -> dict:
    """A dense sweep's device events as the profiler counts them (kernels
    and copies, by name) at S = 1 and S = 16: equal, but for one more
    chunk's K11 launches a chunk past the first, and the copy that joins
    the chunks' λ."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    counts = {}
    for S in (SWEEP_S, 1, SWEEP_S):
        batch = make_batch(S)
        P.solve_sweep(asm, device=device, **batch)  # warm: the cache, the solve states
        for _ in range(6):
            got = kernel_counts(lambda: P.solve_sweep(asm, device=device, **batch), device)
            if got is not None:
                break
        assert got is not None, (label, S, "no window held its run")
        counts[S] = got
    ex = next(e[1] for e in asm._sweep_cache.values() if type(e[1]).__name__ == "_DenseExecutor")
    r_batch = "R" in make_batch(1)
    B, P0 = ex.device_plan.num_bifurcations, int(ex._pid.shape[0])
    chunks = -(-SWEEP_S // dense_core.scenario_chunk(B, r_batch, ex.scenario_budget))
    per_chunk = dense_core.cuda_launches(B, P0) if r_batch else dense_core.solve_launches(B)
    c1, c16 = counts[1], counts[SWEEP_S]
    diff = {k: c16.get(k, 0) - c1.get(k, 0) for k in set(c1) | set(c16)}
    diff = {k: v for k, v in diff.items() if v}
    k11 = sum(v for k, v in diff.items() if re.search(K11_KERNELS, k))
    other = {k: v for k, v in diff.items() if not re.search(K11_KERNELS, k)}
    assert k11 == (chunks - 1) * per_chunk, (label, k11, chunks, per_chunk, diff)
    assert sum(other.values()) == (chunks > 1), (label, other)  # the one cat
    return {"S1": sum(c1.values()), "S16": sum(c16.values()), "chunks": chunks,
            "k11_launches_a_chunk": per_chunk, "k11_more": k11, "other_more": other}


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``torch.equal`` with NaN equal to NaN (a tripped gate's rows)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def nan_close(name, got, want, tol) -> tuple[float, float]:
    """``max_err`` where ``want`` is not NaN, after checking that ``got`` is
    NaN exactly where ``want`` is."""
    g, w = float_tensors(got), float_tensors(want)
    assert len(g) == len(w), name
    err, scale = 0.0, 1.0
    for a, b in zip(g, w):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), (name, "NaN pattern")
        m = ~torch.isnan(b)
        if m.any():
            err = max(err, float((a[m] - b[m]).abs().max()))
            scale = max(scale, float(b[m].abs().max()))
    assert err <= tol * scale, (name, err, scale)
    return err, scale


def compare_dense_scenario_kernels(ex, ins, timed: bool) -> dict:
    """Each dense scenario wrapper on the card against the one-scenario
    wrapper a row (``torch.equal``) and against its plain version (the
    one-scenario plain version a row, stacked): K8a at :data:`TOL`·scale
    (bit for bit but the library Cholesky of its general layout at k ≥ 2),
    the system and the pair sums bit for bit, K11's assembly bit for bit and
    its factor by its backward error (≤ 8·n·ε, each scenario), the gate's
    flags equal, the refined solve at :data:`CYCLIC_TOL`·scale (and one
    unrefined pass at :data:`TOL`·scale up to 628 nodes, CYCLIC_TOL above),
    K8b at TOL·scale; NaN rows (a tripped gate) NaN in both.  An R batch
    runs S factors, one R (``ins[0]`` unbatched) one factor and the solves
    over S.  ``timed``: each wrapper's time beside its plain version's, its
    bound and the library call."""
    from networks_fenicsx_tpu_torch.edge_data import scenario_row
    from networks_fenicsx_tpu_torch.kernels import backsub, dense_core, edge_data, peel, segsum

    R, f, sp, ep = ins
    dlp, N, k = ex.device_plan, ex._N, ex._k
    modes = (ex._R_mode, ex._f_mode, ex._f_is_zero)
    r_dims = 2 if ex._R_mode == "quad" else 1
    r_batch = R.dim() > r_dims
    mk = (dlp, N, k, ex._h_e, ex._quad_w, ex._quad_phi)
    S = next(t.shape[0] for t, d in zip(ins, (r_dims, 1, 1, 1)) if t.dim() > d)
    E, B, C = dlp.num_edges, dlp.num_bifurcations, dlp.num_edges * N
    nq = k + 1
    rec = {}

    def row(t, dims, i):
        return t[i] if t.dim() > dims else t

    def fields(ed):
        out = [t for t in (ed.mt, ed.cumF, ed.W, ed.g, ed.rh, ed.ua, ed.uF) if t is not None]
        return out + [t for t in ed.interior if t.dim() > 2]

    def hold(name, got, ones, plain, tol, exact, work=None, kernel=None, plain_fn=None,
             library=None):
        torch.cuda.synchronize()
        ft = float_tensors(got)
        assert all(same(a, b) for a, b in zip(ft, float_tensors(ones))), (name, "rows")
        err, scale = nan_close(name, got, plain, tol)
        equal = all(same(a, b) for a, b in zip(ft, float_tensors(plain)))
        if exact:
            assert equal, (name, "not bit for bit against the plain version")
        r = {"max_abs_err": err, "scale": scale, "rows_equal": True, "equal": equal, "S": S}
        if timed and kernel is not None:
            r["ms"] = cuda_ms(kernel, reps=10)
            r["plain_ms"] = cuda_ms(plain_fn, reps=2, warmup=1)
            r.update(bound(*work))
            r["library_ms"] = cuda_ms(library, reps=5) if library is not None else None
        rec[name] = r
        return r

    # K8a
    e_args = (*mk, R, f, *modes, sp, ep)
    ed = edge_data.edge_data_scenarios(*e_args)
    ones = [edge_data.edge_data(*mk, row(R, r_dims, i), row(f, 1, i), *modes, row(sp, 1, i),
                                row(ep, 1, i)) for i in range(S)]
    ones = [torch.stack(col) for col in zip(*(fields(o) for o in ones))]
    general = ed.mt is not None
    hold("edge_data_scenarios", fields(ed), ones,
         fields(edge_data.edge_data_scenarios_plain(*e_args)), TOL, k == 1 or not general,
         (tensor_bytes(ex._h_e, ex._quad_w, ex._quad_phi, R, f, sp, ep, dlp.start_bif,
                       dlp.end_bif, fields(ed)), (3 * nq * (k + 1) ** 2 + 2 * nq + 10) * C * S),
         lambda: edge_data.edge_data_scenarios(*e_args),
         lambda: edge_data.edge_data_scenarios_plain(*e_args))
    del ones
    # the bifurcation systems
    s_args = (dlp, ed.W, ed.g, ed.cumF[:, -1], ed.start_pbc, ed.end_pbc)
    dr, w = peel.bifurcation_system_scenarios(*s_args)
    ones = [torch.stack(col) for col in zip(*(
        peel.bifurcation_system(dlp, ed.W[i], ed.g[i], ed.cumF[i, -1], row(sp, 1, i),
                                row(ep, 1, i))[:2] for i in range(S)))]
    sys_tables = tensor_bytes(dlp.t_idx, dlp.s_idx, dlp.t_bins, dlp.s_bins)
    hold("bifurcation_system_scenarios", (dr, w), ones,
         peel.bifurcation_system_scenarios_plain(*s_args), TOL, True,
         (tensor_bytes(ed.W, ed.g, sp, ep, dlp.start_bif, dlp.end_bif, dr, w) + 8 * E * S
          + sys_tables, 14 * E * S),
         lambda: peel.bifurcation_system_scenarios(*s_args),
         lambda: peel.bifurcation_system_scenarios_plain(*s_args))
    # the pair sums
    idx = ex._pair_idx
    (wp,) = segsum.segsum_plan_scenarios(ex._pair_sums, w)
    ones = torch.stack([segsum.segsum_plan(ex._pair_sums, w[i])[0] for i in range(S)])
    okx = (idx >= 0) & (idx < E)
    seg = torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(idx)[okx]
    src = w[:, idx[okx].long()].contiguous()
    hold("segsum_plan_scenarios", wp, ones,
         segsum.segsum_plan_scenarios_plain(ex._pair_sums, w)[0], TOL, True,
         (tensor_bytes(idx, w, wp), int(okx.sum()) * S),
         lambda: segsum.segsum_plan_scenarios(ex._pair_sums, w),
         lambda: segsum.segsum_plan_scenarios_plain(ex._pair_sums, w),
         lambda: torch.zeros((S, idx.shape[0]), dtype=torch.float64,
                             device=w.device).index_add_(1, seg, src))
    del ones
    # K11
    pairs = (ex._ci, ex._cj, ex._pid)
    P0 = int(ex._pid.shape[0])
    diag, rhs = dr[:, :, 0].contiguous(), dr[:, :, 1].contiguous()
    nr = dense_core.N_REFINE
    if r_batch:
        Lc, s, Cf = dense_core.dense_factor_scenarios(*pairs, diag, wp)
        torch.cuda.synchronize()
        Lp, sp_, Cp = dense_core.dense_factor_scenarios_plain(*pairs, diag, wp)
        assert same(Lc, Lp) and same(s, sp_), "K11 assembly bits"
        berr, fin = 0.0, []
        for i in range(S):
            one = dense_core.dense_factor(*pairs, diag[i], wp[i])
            assert all(same(a[i], b) for a, b in zip((Lc, s, Cf), one)), ("factor", i)
            L = torch.tril(Cf[i])
            fin.append(bool(torch.isfinite(L).all()))
            if fin[-1]:
                Ls = (Lc[i] / s[i][:, None]) / s[i][None, :]
                berr = max(berr, float((Ls - L @ L.T).abs().max()))
        del one, L
        assert berr <= 8 * B * EPS, ("factor backward error", berr, 8 * B * EPS)
        r = {"max_abs_err": berr, "backward_bar": 8 * B * EPS, "rows_equal": True,
             "assembly_equal": True, "S": S, "finite": fin}
        if timed:
            chol = torch.tril(Cf)
            Ls_all = (Lc / s[:, :, None]) / s[:, None, :]
            r["ms"] = cuda_ms(lambda: dense_core.dense_factor_scenarios(*pairs, diag, wp), reps=3)
            r["plain_ms"] = cuda_ms(lambda: dense_core.dense_factor_scenarios_plain(
                *pairs, diag, wp), reps=2, warmup=1)
            r.update(bound(tensor_bytes(diag, wp, *pairs) + 8 * S * (2 * B * B + B), 0.0,
                           S * B**3 / 3))
            r["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky_ex(Ls_all), reps=3)
            del Ls_all
        rec["dense_factor_scenarios"] = r
        del Lp, sp_, Cp
        ok = dense_core.dense_gate_scenarios(Cf)
        ones = torch.stack([dense_core.dense_gate(Cf[i]) for i in range(S)])
        assert torch.equal(ok, ones), "gate rows"
        okp = dense_core.dense_gate_scenarios_plain(torch.tril(Cf))
        assert torch.equal(ok.bool(), okp), "gate vs plain"
        r = {"max_abs_err": 0.0, "equal": True, "rows_equal": True, "S": S,
             "ok": ok.tolist()}
        if timed:
            r["ms"] = cuda_ms(lambda: dense_core.dense_gate_scenarios(Cf))
            r["plain_ms"] = cuda_ms(lambda: dense_core.dense_gate_scenarios_plain(Cf), reps=3)
            r.update(bound(8 * B * S + 4 * S, 3 * B * S))
            r["library_ms"] = None
        rec["dense_gate_scenarios"] = r
        fac = (Lc, s, Cf, ok)
        ones_fac = lambda i: (Lc[i], s[i], Cf[i], ok[i])  # noqa: E731
        solve_bytes = 8 * S * (B * B + B * (B + 1) // 2 + B)
    else:
        one = dense_core.dense_factor(*pairs, diag[0], wp[0])
        fac = (*one, dense_core.dense_gate(one[2]))
        ones_fac = lambda i: fac  # noqa: E731
        solve_bytes = 8 * (B * B + B * (B + 1) // 2 + B)
    solve_name = "dense_solve_scenarios" if r_batch else "dense_solve_scenarios_shared"
    chol_of = torch.tril(fac[2])
    lam = dense_core.dense_solve_scenarios(*fac, rhs)
    ones = torch.stack([dense_core.dense_solve(*ones_fac(i), rhs[i]) for i in range(S)])
    lib_rhs = ((rhs / fac[1]) if fac[1].dim() == 2 else (rhs / fac[1][None]))[..., None]
    lib_chol = chol_of if chol_of.dim() == 3 else chol_of[None].expand(S, B, B)
    hold(solve_name, lam, ones,
         dense_core.dense_solve_scenarios_plain(fac[0], fac[1], chol_of, fac[3], rhs),
         CYCLIC_TOL, False,
         (solve_bytes + 16 * S * B, S * ((1 + nr) * 2 * B * B + nr * 2 * B * B)),
         lambda: dense_core.dense_solve_scenarios(*fac, rhs),
         lambda: dense_core.dense_solve_scenarios_plain(fac[0], fac[1], chol_of, fac[3], rhs),
         lambda: torch.cholesky_solve(lib_rhs, lib_chol))
    lam0 = dense_core.dense_solve_scenarios(*fac, rhs, n_refine=0)
    ones0 = torch.stack([dense_core.dense_solve(*ones_fac(i), rhs[i], n_refine=0)
                         for i in range(S)])
    assert same(lam0, ones0), "unrefined rows"
    err0, _ = nan_close("unrefined", lam0, dense_core.dense_solve_scenarios_plain(
        fac[0], fac[1], chol_of, fac[3], rhs, n_refine=0), TOL if B <= 628 else CYCLIC_TOL)
    rec[solve_name]["unrefined_err"] = err0
    if r_batch:  # the fused one-scenario K11 on each row: the same bits
        for i in range(S):
            assert same(lam[i], dense_core.dense_core(*pairs, diag[i], rhs[i], wp[i])), i
    del fac, chol_of, lib_chol, ones, ones0
    # K8b
    q_T, p_T, fin = backsub.backsub_scenarios(ed, lam, N, k)
    ones = [backsub.backsub(scenario_row(ed, i), lam[i], N, k) for i in range(S)]
    assert torch.equal(fin, torch.stack([o[2] for o in ones])), "finite flags"
    ones = [torch.stack([o[j] for o in ones]) for j in range(2)]
    plain = backsub.backsub_scenarios_plain(ed, lam, N, k)
    assert torch.equal(fin, plain[2]), "finite flags vs plain"
    hold("backsub_scenarios", (q_T, p_T), ones, plain[:2], TOL, False,
         (tensor_bytes(lam, fields(ed), sp, ep, dlp.start_bif, dlp.end_bif, q_T, p_T),
          10 * (k * N + 1) * E * S),
         lambda: backsub.backsub_scenarios(ed, lam, N, k),
         lambda: backsub.backsub_scenarios_plain(ed, lam, N, k))
    rec["finite"] = fin.tolist()
    return rec


def dense_case(P, device, asm, S: int, kind: str, seed: int, trip: int | None = None):
    """A dense executor on ``asm`` (its executor for ``schur_method="dense"``
    on the card, f kept) and inputs in its public order: ``kind`` "R" an R
    batch of S at :data:`SWEEP_SCALES` (S = 16) or random scales, "pbc" a
    boundary-pressure batch on the shared R, "f" a source batch; ``trip``:
    that R row's every third edge negated and scaled by 4 (an indefinite
    Laplacian: the pivot gate trips)."""
    from networks_fenicsx_tpu_torch.solver import build_schur_executor

    ex = build_schur_executor(asm, P.SolverOptions(schur_method="dense"), device=device,
                              elide_zero_f=False)
    R0, f0, sp0, ep0 = ex.upload(*asm.schur_arguments())
    rng = np.random.default_rng(seed)
    dlp = ex.device_plan
    if kind == "R":
        scales = SWEEP_SCALES if S == SWEEP_S else rng.uniform(0.5, 2.0, S)
        R = R0[None] * torch.as_tensor(scales, device=device)[:, None]
        if trip is not None:
            R[trip, ::3] *= -4.0
        return ex, (R.contiguous(), f0, sp0, ep0)
    if kind == "f":
        f = torch.as_tensor(rng.uniform(-1.0, 1.0, (S,) + tuple(f0.shape)), device=device)
        return ex, (R0, f, sp0, ep0)
    mask_s = (dlp.start_bif < 0).double()
    mask_e = (dlp.end_bif < 0).double()
    sp = torch.as_tensor(rng.uniform(-1.0, 1.0, (S, dlp.num_edges)), device=device) * mask_s
    ep = torch.as_tensor(rng.uniform(-1.0, 1.0, (S, dlp.num_edges)), device=device) * mask_e
    return ex, (R0, f0, sp.contiguous(), ep.contiguous())


def dense_kernel_sets(P, device, tree13) -> dict:
    """The dense route's scenario kernels on the card, S ∈ {1, 16}, n ∈ {31,
    455, 4,095}, k = 1 and 2, R batches (S factors) and boundary-pressure or
    source batches (one factor): the 13-generation tree's R batch timed (the
    kernels line) and its p_bc batch (the solves on one factor) timed; a
    455-node web's R row that trips the pivot gate (NaN alone); the web's R
    sweep in chunks of 5 against its one-chunk sweep bit for bit."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    out = {}
    for kind in ("R", "pbc"):
        ex, ins = dense_case(P, device, tree13, SWEEP_S, kind, seed=1)
        out[f"dense_tree13_{kind}16"] = compare_dense_scenario_kernels(ex, ins, timed=True)
        del ex, ins
    ex, ins = dense_case(P, device, tree13, 1, "R", seed=2)
    out["dense_tree13_R1"] = compare_dense_scenario_kernels(ex, ins, timed=False)
    web = web455_assembler(P)
    for k in (1, 2):
        demo = arterial_assembler(P, 6, 10, k=k, per_cell=True, seed=4)
        w = web if k == 1 else web455_assembler(P, k=k)
        for name, asm in (("demo", demo), ("web455", w)):
            for S, kind in ((SWEEP_S, "R"), (SWEEP_S, "pbc"), (SWEEP_S, "f"), (1, "R")):
                ex, ins = dense_case(P, device, asm, S, kind, seed=10 * k + S)
                out[f"dense_{name}_k{k}_{kind}{S}"] = compare_dense_scenario_kernels(
                    ex, ins, timed=False)
    # a row that trips the gate: NaN alone, in the kernels and through the sweep
    ex, ins = dense_case(P, device, web, SWEEP_S, "R", seed=5, trip=DENSE_TRIP_ROW)
    rec = compare_dense_scenario_kernels(ex, ins, timed=False)
    assert rec["dense_gate_scenarios"]["ok"] == [int(i != DENSE_TRIP_ROW) for i in range(SWEEP_S)]
    assert rec["finite"] == [i != DENSE_TRIP_ROW for i in range(SWEEP_S)], rec["finite"]
    out["dense_web455_trip"] = rec
    R0 = web.schur_arguments()[0]
    Rb = R0[None] * SWEEP_SCALES[:, None]
    Rb[DENSE_TRIP_ROW, ::3] *= -4.0
    x = P.solve_sweep(web, R=Rb, device=device).x
    keep = [i for i in range(SWEEP_S) if i != DENSE_TRIP_ROW]
    assert np.isnan(x[DENSE_TRIP_ROW]).any() and not np.isnan(x[keep]).any()
    assert np.array_equal(P.solve_sweep(web, R=Rb[keep], device=device).x, x[keep]), "trip rows"
    # an R sweep in chunks of 5 scenarios: the one-chunk sweep's bits, a factor call a chunk
    Rb = R0[None] * SWEEP_SCALES[:, None]
    whole = P.solve_sweep(web, R=Rb, device=device).x
    ex = list(web._sweep_cache.values())[-1][1]
    B = web.network.num_multipliers
    ex.scenario_budget = 5 * 16 * B * B
    before = dense_core.dense_factor_scenarios.launches
    chunked = P.solve_sweep(web, R=Rb, device=device).x
    calls = dense_core.dense_factor_scenarios.launches - before
    ex.scenario_budget = dense_core.SCENARIO_BUDGET
    assert calls == 4 and np.array_equal(chunked, whole), (calls, "chunks")
    out["dense_web455_chunks"] = {"chunk": 5, "factor_calls": calls, "bit_for_bit": True}
    return out


def web455_assembler(P, k: int = 1):
    """``make_random_network(456, keep=0.7, num_boundary=8, seed=5)`` (455
    bifurcations) at N = 2, per-edge R from ``default_rng(456)``, per-cell f,
    p_bc = x."""
    net = P.network_generation.make_random_network(WEB455, keep=0.7, num_boundary=8, seed=5,
                                                   arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=2, color_strategy="fast"),
                                      flux_degree=k, pressure_degree=0)
    rng = np.random.default_rng(WEB455)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=rng.uniform(0.5, 2.0, asm.network.num_edges),
                      f=rng.uniform(-1.0, 1.0, asm.network.num_cells))
    assert asm.network.num_multipliers == 455, asm.network.num_multipliers
    return asm


def edge_only_sweep(P, device) -> dict:
    """A network without bifurcations (one edge of :data:`EDGE_CELLS` cells,
    k = 2) on ``_EdgeExecutor.scenarios``: an R and a source sweep of 16,
    K8a and K8b over S once each and nothing else, rows against
    ``Solver.solve()`` bit for bit."""
    import networkx as nx

    from networks_fenicsx_tpu_torch import kernels

    G = nx.DiGraph()
    G.add_node(0, pos=np.array([0.0, 0.0, 0.0]))
    G.add_node(1, pos=np.array([0.0, 1.0, 0.0]))
    G.add_edge(0, 1)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(G, N=EDGE_CELLS), flux_degree=2)
    rng = np.random.default_rng(12)
    R0, f0 = rng.uniform(0.5, 2.0, 1), rng.uniform(-1.0, 1.0, EDGE_CELLS)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0, f=f0)
    out, runs = {}, []
    for name, batch in (("R", {"R": R0[None] * SWEEP_SCALES[:, None]}),
                        ("f", {"f": rng.uniform(-1.0, 1.0, (SWEEP_S, EDGE_CELLS))})):
        P.solve_sweep(asm, device=device, **batch)
        torch.cuda.synchronize()
        kernels.reset_launches()
        res = P.solve_sweep(asm, device=device, **batch)
        torch.cuda.synchronize()
        launches = kernels.launches()
        got = {n: v for n, v in launches.items() if v}
        assert got == {"edge_data_scenarios": 1, "backsub_scenarios": 1}, (name, got)
        ex = list(asm._sweep_cache.values())[-1][1]
        assert type(ex).__name__ == "_EdgeExecutor" and ex.has_scenario_axis, type(ex)
        x = res.x
        for i in SWEEP_ROWS:
            forms = {"R": batch["R"][i] if "R" in batch else R0,
                     "f": batch["f"][i] if "f" in batch else f0}
            asm.compute_forms(p_bc_ex=lambda x: x[1], **forms)
            s = P.Solver(asm, device=device)
            s.solve()
            assert np.array_equal(s.solution_vector(), x[i]), (name, i)
        asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0, f=f0)
        out[name] = {"S": SWEEP_S, "dofs": asm.num_dofs, "rows_bit_for_bit": list(SWEEP_ROWS),
                     "sweep_ms": best_ms(lambda: P.solve_sweep(asm, device=device, **batch))}
        runs.append(launches)
    return {"rec": out, "runs": runs}


def dense_sweeps(P, device, name_power: str) -> dict:
    """The dense route's scenario axis on the card: the 13-generation
    arterial tree (B = 4,095, the top of ``auto``'s dense band; an R batch of
    16 in two chunks and a p_bc batch of 16 on one factor, against the
    batched blocked route), web2k (B = 1,994, cyclic; R and p_bc batches),
    the launches at S = 1 and 16, the kernel sets and the network without
    bifurcations."""
    t0 = time.perf_counter()
    tree13 = arterial_assembler(P, DENSE_GENERATIONS, DENSE_N)
    mesh = tree13.network
    assert mesh.num_multipliers == 4_095, mesh.num_multipliers
    R0 = 1.0 / mesh.edge_radius**4
    pb = mesh.vertices[: mesh.num_graph_nodes][:, 1]
    paths, runs = {}, []

    def tree_forms(R=R0, s=1.0):
        tree13.compute_forms(p_bc_ex=lambda x: s * x[1], R=R)

    Rb = R0[None] * SWEEP_SCALES[:, None]
    paths["tree13_R16"] = dense_sweep_path(
        P, device, tree13, "dense tree13 R", {"R": Rb}, lambda i: tree_forms(R=Rb[i]),
        tree_forms, blocked=True)
    paths["tree13_pbc16"] = dense_sweep_path(
        P, device, tree13, "dense tree13 p_bc", {"p_bc_node_values": SWEEP_SCALES[:, None] * pb},
        lambda i: tree_forms(s=SWEEP_SCALES[i]), tree_forms, blocked=True)
    web = web2k_assembler(P)
    assert web.network.num_multipliers == 1_994, web.network.num_multipliers
    Rw = web.schur_arguments()[0]
    Rwb = Rw[None] * SWEEP_SCALES[:, None]
    px = web.network.vertices[: web.network.num_graph_nodes][:, 0]
    paths["web2k_R16"] = dense_sweep_path(
        P, device, web, "dense web2k R", {"R": Rwb},
        lambda i: web.compute_forms(p_bc_ex=lambda x: x[0], R=Rwb[i]), lambda: web2k_forms(web))
    paths["web2k_pbc16"] = dense_sweep_path(
        P, device, web, "dense web2k p_bc", {"p_bc_node_values": SWEEP_SCALES[:, None] * px},
        lambda i: web.compute_forms(p_bc_ex=lambda x, s=SWEEP_SCALES[i]: s * x[0], R=Rw),
        lambda: web2k_forms(web))
    for key, path in paths.items():
        runs.append(path["launches"])
        log(f"phase sweep dense {key} ({name_power}): " + json.dumps(path["rec"]))
    counts = {
        "tree13_R": dense_launches_vs_S(
            P, device, tree13, lambda S: {"R": R0[None] * np.linspace(0.5, 2.0, S)[:, None]},
            "tree13 R"),
        "tree13_pbc": dense_launches_vs_S(
            P, device, tree13,
            lambda S: {"p_bc_node_values": np.linspace(0.5, 2.0, S)[:, None] * pb}, "tree13 p_bc"),
        "web2k_R": dense_launches_vs_S(
            P, device, web, lambda S: {"R": Rw[None] * np.linspace(0.5, 2.0, S)[:, None]},
            "web2k R"),
    }
    log("phase sweep dense launches (profiled, S = 1 and 16; a chunk past the first adds its "
        "K11 launches and one cat): " + json.dumps(counts))
    del web
    sets = dense_kernel_sets(P, device, tree13)
    for name in ("dense_tree13_R16", "dense_tree13_pbc16"):
        log(f"phase kernels-sweep {name}: " + json.dumps(sets[name]))
    log(f"phase kernels-sweep dense: {len(sets)} cases (n in {{31, 455, 4,095}}, S in {{1, 16}}, "
        "k = 1 and 2, R batches on S factors, p_bc and f batches on one, a row that trips the "
        "gate, a sweep in chunks), each wrapper against the one-scenario wrapper a row bit for "
        "bit and against its plain version: "
        + json.dumps({n: sorted(k for k in rec if isinstance(rec[k], dict))
                      for n, rec in sets.items() if n.startswith("dense_tree13")}))
    edge = edge_only_sweep(P, device)
    runs += edge["runs"]
    log("phase sweep without bifurcations (one edge, 4,096 cells, k = 2): "
        + json.dumps(edge["rec"]))
    log(f"phase wall: the dense sweep phases {time.perf_counter() - t0:.1f} s")
    return {"sets": sets, "runs": runs}

# ---------------------------------------------------------------- lattice sweeps

LATTICE64 = 64  # make_grid(64, 64): B = 4,096, the top of the sweep's DCT band under auto
# a lattice sweep's wrapper calls: K17's stencil once a refinement pass
LATTICE_SWEEP_CALLS = {
    ("grid", True): {"condense_scenarios": 1, "grid_core_scenarios": 1, "dct_factor_scenarios": 1,
                     "dct_apply_scenarios": 1, "grid_residual_scenarios": 2,
                     "expand_scenarios": 1},
    ("grid", False): {"condense_scenarios": 1, "grid_core_scenarios": 1, "dct_factor": 1,
                      "dct_apply_scenarios": 1, "grid_residual_scenarios": 2,
                      "expand_scenarios": 1},
    ("general", True): {"edge_data_scenarios": 1, "bifurcation_system_scenarios": 1,
                        "segsum_plan_scenarios": 2, "dct_factor_scenarios": 1,
                        "dct_apply_scenarios": 1, "shift_matvec_scenarios": 2,
                        "backsub_scenarios": 1},
    ("general", False): {"edge_data_scenarios": 1, "bifurcation_system_scenarios": 1,
                         "segsum_plan_scenarios": 1, "segsum": 1, "dct_factor": 1,
                         "dct_apply_scenarios": 1, "shift_matvec_scenarios": 2,
                         "backsub_scenarios": 1},
}
# a lattice sweep's kernel launches, whatever S: the grid route K1 1, K17 3, K16 20, K5 1; the
# general route K8a 1, the system 2, the class weights 1, K16 20, K18 2, K8b 1
LATTICE_SWEEP_LAUNCHES = {"grid": 25, "general": 27}
LATTICE_KERNELS = (r"\b(condense_scen_kernel|grid_(assemble|residual)_kernel|dct_\w+_kernel|"
                   r"expand_kernel|edge_\w+_kernel|lambda_prepare_scen_kernel|segsum_plan_kernel|"
                   r"shift_apply_kernel|backsub_blocks_kernel)\b")
# a lattice sweep's kernels by family, for its device split
LATTICE_FAMILIES = {"K1": r"\bcondense_scen_kernel\b", "K17": r"\bgrid_(assemble|residual)_kernel\b",
                    "K16": r"\bdct_\w+_kernel\b", "K5": r"\bexpand_kernel\b",
                    "K8a": r"\bedge_\w+_kernel\b", "system": r"\blambda_prepare_scen_kernel\b",
                    "K6": r"\bsegsum_plan_kernel\b", "K18": r"\bshift_apply_kernel\b",
                    "K8b": r"\bbacksub_blocks_kernel\b"}
# the lattice route's scenario wrappers, and the kernel-check case that times each
LATTICE_SCENARIO_CHECKS = {
    "dct_factor_scenarios": "lattice512_R16",
    "dct_apply_scenarios": "lattice512_R16",
    "grid_core_scenarios": "lattice512_R16",
    "grid_residual_scenarios": "lattice512_pbc16",
    "shift_matvec_scenarios": "lattice512_callable_pbc16",
}


def lattice_sweep_path(P, device, asm, label: str, batch: dict, row_forms, base_forms,
                       route: str, solves: bool = False) -> dict:
    """:func:`route_sweep_path` on a lattice route (``route``: the grid or
    the general one): the wrapper calls of :data:`LATTICE_SWEEP_CALLS`, rows
    against ``Solver(schur_method="dct")``."""
    return route_sweep_path(
        P, device, asm, label, batch, row_forms, base_forms, "dct",
        "_GridExecutor" if route == "grid" else "_DctExecutor",
        lambda ex, S, r_batch: LATTICE_SWEEP_CALLS[(route, r_batch)], LATTICE_FAMILIES,
        solves=solves)


def lattice_launches_vs_S(P, device, asm, make_batch, label: str, route: str) -> dict:
    """A lattice sweep's device events as the profiler counts them at S = 1
    and S = 16 (kernels and copies, by name): equal, and the route's own
    kernels :data:`LATTICE_SWEEP_LAUNCHES` at both."""
    counts = {}
    for S in (SWEEP_S, 1):
        batch = make_batch(S)
        P.solve_sweep(asm, device=device, **batch)  # warm: the cache, the scratch
        for _ in range(6):
            got = kernel_counts(lambda: P.solve_sweep(asm, device=device, **batch), device)
            if got is not None:
                break
        assert got is not None, (label, S, "no window held its run")
        counts[S] = got
    c1, c16 = counts[1], counts[SWEEP_S]
    ours = {S: sum(v for k, v in c.items() if re.search(LATTICE_KERNELS, k))
            for S, c in counts.items()}
    assert c1 == c16, (label, c1, c16)
    assert ours[1] == ours[SWEEP_S] == LATTICE_SWEEP_LAUNCHES[route], (label, ours)
    return {"S1": sum(c1.values()), "S16": sum(c16.values()), "kernels": ours[1],
            "by_name": {k: v for k, v in c16.items()}}


def compare_lattice_scenario_kernels(P, device, asm, batch: str, timed: bool) -> dict:
    """The lattice route's scenario wrappers on the card on the inputs a
    512² sweep of 16 gives them (``batch``: an R or a p_bc batch; the grid
    route, or the general one for a callable source), each against the
    one-scenario wrapper a row (``torch.equal``) and against its plain
    version (the one-scenario plain version a row, stacked) at
    :data:`TOL`·scale (K16's refined passes at :data:`LATTICE_TOL`); timed
    beside its bound and, where one exists, one PyTorch call computing the
    same; and K16 over S on two streams at once, bit for bit with each
    alone."""
    from networks_fenicsx_tpu_torch.kernels import (
        condense, dct_lattice as K16, edge_data, grid_core, peel, segsum, shift_matvec,
    )
    from networks_fenicsx_tpu_torch.solver import build_schur_executor

    ex = build_schur_executor(asm, P.SolverOptions(schur_method="dct"), device=device)
    grid = type(ex).__name__ == "_GridExecutor"
    R0, f0, sp0, ep0 = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    scales = torch.as_tensor(SWEEP_SCALES, device=device)
    r_batch = batch == "R"
    if r_batch:
        R = (R0[None] * scales[:, None]).contiguous()
        sp, ep = sp0, ep0
    else:
        R = R0
        sp, ep = (sp0[None] * scales[:, None]).contiguous(), (ep0[None] * scales[:, None]).contiguous()
    S, op, N, k, h = SWEEP_S, ex.operator, ex._N, ex._k, ex._h_e
    rec, B = {}, op.B

    def hold(name, got, ones, plain, tol, work, kernel, plain_fn, library=None):
        torch.cuda.synchronize()
        ft = float_tensors(got)
        assert all(torch.equal(a, b) for a, b in zip(ft, float_tensors(ones))), (name, "rows")
        err, scale = max_err(got, plain)
        assert err <= tol * scale, (name, err, scale)
        r = {"max_abs_err": err, "scale": scale, "rows_equal": True, "S": S}
        if timed:
            r["ms"] = cuda_ms(kernel)
            r["plain_ms"] = cuda_ms(plain_fn, reps=3, warmup=1)
            r.update(bound(*work))
            r["library_ms"] = None if library is None else cuda_ms(library)
        rec[name] = r

    def stack(rows):
        return [torch.stack(col) for col in zip(*rows)]

    if grid:
        gdp = ex.device_plan
        Rm, fm = ex._R_mode, ex._f_mode
        W, w, g, Ftot, const = condense.condense_scenarios(gdp, N, k, h, R, f0, Rm, fm, sp, ep)
        ws = w if r_batch else w[0]
        args = (gdp, ws, const, Ftot)
        got = grid_core.grid_core_scenarios(*args)
        rhs, diag, _ = got

        def row_w(i):
            return ws[i] if r_batch else ws

        ones = stack([grid_core.grid_core(gdp, row_w(i), const[i], Ftot[i]) for i in range(S)])
        if not r_batch:  # one diag for every row
            assert all(torch.equal(diag, d) for d in ones[1]), "grid_core_scenarios: shared diag"
            ones[1] = ones[1][0]
        hold("grid_core_scenarios", got, ones, grid_core.grid_core_scenarios_plain(*args), TOL,
             (tensor_bytes(ws, const, Ftot, got, gdp.stub_rows, gdp.stub_s_bif), 12 * B * S),
             lambda: grid_core.grid_core_scenarios(*args),
             lambda: grid_core.grid_core_scenarios_plain(*args))
        gen = torch.Generator(device=device).manual_seed(28)
        lam_any = torch.randn((S, B), generator=gen, dtype=torch.float64, device=device)
        r_args = (gdp, ws, diag, lam_any, rhs)
        got = grid_core.grid_residual_scenarios(*r_args, norm=True)
        ones = stack([grid_core.grid_residual(gdp, row_w(i), diag[i] if r_batch else diag,
                                              lam_any[i], rhs[i], norm=True) for i in range(S)])
        library = None
        if not r_batch:  # one Laplacian: the yardstick is one sparse product on (B, S)
            L = lattice_csr_grid(gdp, ws, diag)
            lam_t = lam_any.T.contiguous()
            library = lambda: torch.sparse.mm(L, lam_t)  # noqa: E731
        hold("grid_residual_scenarios", got, ones,
             grid_core.grid_residual_scenarios_plain(*r_args, norm=True), TOL,
             (tensor_bytes(ws, diag, lam_any, rhs, got), 10 * B * S),
             lambda: grid_core.grid_residual_scenarios(*r_args),
             lambda: grid_core.grid_residual_scenarios_plain(*r_args), library)
        w_edges = w

        def resid(x):
            return grid_core.grid_residual_scenarios(gdp, ws, diag, x, rhs)

        def resid_one(i):
            return lambda x: grid_core.grid_residual(gdp, row_w(i), diag[i] if r_batch else diag,
                                                     x, rhs[i])
    else:
        dlp = ex.device_plan
        ed = edge_data.edge_data_scenarios(dlp, N, k, h, ex._quad_w, ex._quad_phi, R, f0,
                                           ex._R_mode, ex._f_mode, ex._f_is_zero, sp, ep)
        dr, w_edges = peel.bifurcation_system_scenarios(dlp, ed.W, ed.g, ed.cumF[:, -1],
                                                        ed.start_pbc, ed.end_pbc)
        C = dlp.offsets.size
        cw = (segsum.segsum_plan_scenarios(dlp.class_sums, w_edges)[0].view(S, C, -1) if r_batch
              else segsum.segsum_plan(dlp.class_sums, w_edges[0])[0].view(C, -1))
        diag_v, rhs_v = dr[:, :, 0], dr[:, :, 1]
        rhs = rhs_v.contiguous()
        gen = torch.Generator(device=device).manual_seed(28)
        lam_any = torch.randn((S, B), generator=gen, dtype=torch.float64, device=device)
        s_args = (dlp.shift, cw, diag_v, lam_any, rhs_v)
        got = shift_matvec.shift_matvec_scenarios(*s_args, norm=True)
        ones = stack([shift_matvec.shift_matvec(dlp.shift, cw[i] if r_batch else cw, diag_v[i],
                                                lam_any[i], rhs_v[i], norm=True)
                      for i in range(S)])
        library = None
        if not r_batch:  # one Laplacian's diagonal would be row 0's: the product alone
            L = lattice_csr(dlp.offsets, cw, dr[0, :, 0])
            lam_t = lam_any.T.contiguous()
            library = lambda: torch.sparse.mm(L, lam_t)  # noqa: E731
        hold("shift_matvec_scenarios", got, ones,
             shift_matvec.shift_matvec_scenarios_plain(*s_args, norm=True), TOL,
             (tensor_bytes(cw, dr, lam_any, got) + 4 * C, (2 + 2 * C) * B * S),
             lambda: shift_matvec.shift_matvec_scenarios(*s_args),
             lambda: shift_matvec.shift_matvec_scenarios_plain(*s_args), library)

        def resid(x):
            return shift_matvec.shift_matvec_scenarios(dlp.shift, cw, diag_v, x, rhs_v)

        def resid_one(i):
            return lambda x: shift_matvec.shift_matvec(dlp.shift, cw[i] if r_batch else cw,
                                                       diag_v[i], x, rhs_v[i])

    stub_tables = (op.stub_rows, op.stub_edge, op.stub_group)
    if r_batch:
        got = K16.dct_factor_scenarios(op, w_edges)
        ones = stack([K16.dct_factor(op, w_edges[i]) for i in range(S)])
        hold("dct_factor_scenarios", got, ones, K16.dct_factor_scenarios_plain(op, w_edges), TOL,
             (tensor_bytes(op.lamx, op.lamy, op.g_geo, stub_tables, got) + 8 * S * (2 + op.r),
              S * (B * 3 + op.r * B + 4 * (op.r + 1) ** 3)),
             lambda: K16.dct_factor_scenarios(op, w_edges),
             lambda: K16.dct_factor_scenarios_plain(op, w_edges))
        state = got
    else:
        state = K16.dct_factor(op, w_edges[0])
    lam = K16.dct_apply_scenarios(op, state, rhs, resid)
    fixed = K16.dct_apply_scenarios_plain(op, state, rhs, resid)  # the refinement residuals, fixed
    res_fixed = resid(fixed)
    ones = torch.stack([K16.dct_apply(op, state if not r_batch else K16.DctState(
        *(t[i] for t in state)), rhs[i], resid_one(i)) for i in range(S)])
    unref = K16.dct_apply_scenarios(op, state, rhs, resid, n_refine=0)
    err0, scale0 = max_err(unref, K16.dct_apply_scenarios_plain(op, state, rhs, resid, n_refine=0))
    assert err0 <= TOL * scale0, ("dct_apply_scenarios unrefined", err0, scale0)
    n_pass = 1 + K16.N_REFINE
    # the library yardstick: the four products of each pass as batched torch.matmul (12 calls)
    Dy, Dx = op.Dy, op.Dx
    inv3 = state.inv

    def library():
        b3 = rhs.view(S, op.ny, op.s)
        for _ in range(n_pass):
            c = torch.matmul(torch.matmul(Dy, b3), Dx.T) * inv3
            torch.matmul(torch.matmul(Dy.T, c), Dx)

    hold("dct_apply_scenarios", lam, ones, fixed, LATTICE_TOL,
         (tensor_bytes(op.Dx, op.Dy, state, stub_tables) + 8 * B * S * (2 + K16.N_REFINE),
          S * (n_pass * (2 * op.r + 3) * B),
          S * n_pass * 4 * op.ny * op.s * (op.ny + op.s)),
         lambda: K16.dct_apply_scenarios(op, state, rhs, lambda _: res_fixed),
         lambda: K16.dct_apply_scenarios_plain(op, state, rhs, lambda _: res_fixed), library)
    rec["dct_apply_scenarios"]["unrefined_err"] = err0
    rec["dct_apply_scenarios"]["shared_factor"] = not r_batch
    # K16 over S on two streams at once: each stream's scenario scratch, the bits of each alone
    rhs2 = (rhs, (rhs + lam_any).contiguous())
    alone = [K16.dct_apply_scenarios(op, state, b, lambda _: res_fixed) for b in rhs2]
    torch.cuda.synchronize()
    streams = torch.cuda.Stream(device), torch.cuda.Stream(device)
    for order in (streams, streams[::-1]):
        got2 = []
        for st, b in zip(order, rhs2):
            with torch.cuda.stream(st):
                got2.append(K16.dct_apply_scenarios(op, state, b, lambda _: res_fixed))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got2, alone)), "K16 over S: two streams"
    rec["dct_apply_scenarios"]["two_streams"] = "bit for bit"
    rec["route"] = "grid" if grid else "general"
    return rec


def lattice_sweeps(P, device, name_power: str) -> dict:
    """The lattice route's scenario axis on the card: the 512² lattice under
    ``auto`` (the grid route; 16 R and 16 p_bc scenarios, against the same
    sweeps a row at a time and 16 ``compute_forms`` + ``solve()``), with a
    callable source (the general route; R and p_bc), the 64² lattice (B =
    4,096, the sweep's own DCT band), the launches at S = 1 and 16,
    ``GridFactorization.solve_batch`` of 16 rows against ``solve()``, and
    the scenario kernels against the one-scenario kernels and their plain
    versions."""
    from networks_fenicsx_tpu_torch import factorization as PF
    from networks_fenicsx_tpu_torch import kernels

    t0 = time.perf_counter()
    lat = lattice_assembler(P)
    mesh = lat.network
    y = mesh.vertices[: mesh.num_graph_nodes][:, 1]
    Rb = SWEEP_SCALES[:, None].copy()
    pbb = SWEEP_SCALES[:, None] * y[None]
    paths, runs = {}, []

    def forms(R=1.0, s=1.0, source=None):
        lat.compute_forms(p_bc_ex=lambda x: s * x[1], R=R, f=source)

    paths["lattice512_R16"] = lattice_sweep_path(
        P, device, lat, "lattice512 R", {"R": Rb}, lambda i: forms(R=float(Rb[i, 0])), forms,
        "grid", solves=True)
    paths["lattice512_pbc16"] = lattice_sweep_path(
        P, device, lat, "lattice512 p_bc", {"p_bc_node_values": pbb},
        lambda i: forms(s=SWEEP_SCALES[i]), forms, "grid")
    counts = {"grid_R": lattice_launches_vs_S(
        P, device, lat, lambda S: {"R": np.linspace(0.5, 2.0, S)[:, None]}, "lattice512 R", "grid")}
    sets = {"lattice512_R16": compare_lattice_scenario_kernels(P, device, lat, "R", timed=True),
            "lattice512_pbc16": compare_lattice_scenario_kernels(P, device, lat, "p_bc",
                                                                 timed=True)}

    # factor reuse: 16 right-hand sides on one stored factor
    fac = PF.build_grid_factorization(lat, device=device)
    R0, _, sp0, ep0 = lat.schur_arguments(device=False)
    state = fac.factor(R0)
    f_b = SWEEP_SCALES[:, None] * 0.25
    sp_b, ep_b = SWEEP_SCALES[:, None] * np.asarray(sp0)[None], SWEEP_SCALES[:, None] * np.asarray(ep0)[None]
    fac.solve_batch(state, f_b, sp_b, ep_b)
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = fac.solve_batch(state, f_b, sp_b, ep_b)
    torch.cuda.synchronize()
    fl = kernels.launches()
    want = {"condense_scenarios": 1, "grid_core_scenarios": 1, "dct_apply_scenarios": 1,
            "grid_residual_scenarios": 3, "expand_scenarios": 1}
    assert {n: v for n, v in fl.items() if v} == want, fl
    runs.append(fl)
    for i in range(SWEEP_S):
        one = fac.solve(state, f_b[i], sp_b[i], ep_b[i])
        assert all(torch.equal(a[i], b) for a, b in zip(outs, one)), ("solve_batch", i)
    assert bool(torch.all(outs[5])), "solve_batch: finite"
    rel = float((outs[3] / outs[4]).max())
    assert rel <= 1e-10, ("solve_batch residual", rel)

    def solves():
        for i in range(SWEEP_S):
            fac.solve(state, f_b[i], sp_b[i], ep_b[i])

    batch_rec = {"S": SWEEP_S, "rows_bit_for_bit": SWEEP_S, "wrapper_calls": want,
                 "max_rel_residual": rel,
                 "solve_batch_ms": best_ms(lambda: fac.solve_batch(state, f_b, sp_b, ep_b)),
                 "solves_ms": best_ms(solves),
                 "device": device_share(lambda: fac.solve_batch(state, f_b, sp_b, ep_b))}
    log(f"phase sweep lattice solve_batch (512^2, GridFactorization, {name_power}): "
        + json.dumps(batch_rec))
    del fac, state, outs

    # the general route: a callable source
    src = lattice_source
    forms(source=src)
    paths["lattice512_callable_R16"] = lattice_sweep_path(
        P, device, lat, "lattice512 callable R", {"R": Rb},
        lambda i: forms(R=float(Rb[i, 0]), source=src), lambda: forms(source=src), "general")
    paths["lattice512_callable_pbc16"] = lattice_sweep_path(
        P, device, lat, "lattice512 callable p_bc", {"p_bc_node_values": pbb},
        lambda i: forms(s=SWEEP_SCALES[i], source=src), lambda: forms(source=src), "general")
    forms(source=src)
    counts["general_pbc"] = lattice_launches_vs_S(
        P, device, lat, lambda S: {"p_bc_node_values": np.linspace(0.5, 2.0, S)[:, None] * y[None]},
        "lattice512 callable p_bc", "general")
    sets["lattice512_callable_pbc16"] = compare_lattice_scenario_kernels(P, device, lat, "p_bc",
                                                                         timed=True)
    sets["lattice512_callable_R16"] = compare_lattice_scenario_kernels(P, device, lat, "R",
                                                                       timed=False)
    forms()
    del lat

    # the 64² lattice under auto: B = 4,096, the sweep's own DCT band
    small = lattice_assembler(P, LATTICE64, LATTICE64)
    assert small.network.num_multipliers == 4_096, small.network.num_multipliers
    Rs = SWEEP_SCALES[:, None].copy()
    paths["lattice64_R16"] = lattice_sweep_path(
        P, device, small, "lattice64 R", {"R": Rs},
        lambda i: small.compute_forms(p_bc_ex=lambda x: x[1], R=float(Rs[i, 0])),
        lambda: lattice_forms(small), "grid")
    del small

    for key, path in paths.items():
        runs.append(path["launches"])
        log(f"phase sweep lattice {key} ({name_power}): " + json.dumps(path["rec"]))
    log("phase sweep lattice launches (profiled, S = 1 and 16): " + json.dumps(counts))
    for name in ("lattice512_R16", "lattice512_pbc16", "lattice512_callable_pbc16"):
        log(f"phase kernels-sweep {name}: " + json.dumps(sets[name]))
    log(f"phase wall: the lattice sweep phases {time.perf_counter() - t0:.1f} s")
    return {"sets": sets, "runs": runs}


# ---------------------------------------------------------------- level and tree sweeps

LEVEL_FAMILIES = {"K8a": r"\bedge_\w+_kernel\b", "K7": r"\blevel_\w+_kernel\b",
                  "K6": r"\bsegsum_plan_kernel\b", "K8b": r"\bbacksub_blocks_kernel\b"}
TREE_FAMILIES = {"K8a": r"\bedge_\w+_kernel\b",
                 "system": r"\b(lambda_prepare_scen|rhs_norm)_kernel\b",
                 "K6": r"\bsegsum_plan_kernel\b", "K9": r"\bpeel_\w+_kernel\b",
                 "K13-K14": r"\bmf_(values|front|wide)_kernel\b",
                 "K15": r"\bmf_(forward|backward|gather|terms|residual|gate)_kernel\b",
                 "K10": r"\b(fold|segsum)_kernel\b", "K11": K11_KERNELS,
                 "K8b": r"\bbacksub_blocks_kernel\b"}
# the level and tree routes' scenario wrappers, and the kernel-check case that times each
TREE_SCENARIO_CHECKS = {
    "level_eliminate_scenarios": "level_forest_R16",
    "peel_scenarios": "tree_web_R16",
    "peel_apply_scenarios": "tree_web_pbc16",
    "fold_apply_scenarios": "tree_web_R16",
    "mf_factor_scenarios": "tree_web_R16",
    "mf_apply_scenarios": "tree_web_R16",
}
MF_TRIP_ROW = 5  # the row of the web's kernel set whose diagonal trips the multifrontal gate


def level_calls(ex, S: int, r_batch: bool) -> dict:
    """The wrapper counts of a level sweep: each scenario wrapper once (K7
    over S makes K6's three sums over S), whatever S and batch."""
    return {"edge_data_scenarios": 1, "level_eliminate_scenarios": 1, "segsum_plan_scenarios": 1,
            "backsub_scenarios": 1}


def tree_calls(ex, S: int, r_batch: bool) -> dict:
    """The wrapper counts of a tree sweep: K8a, the systems and K8b over S
    once; with an R batch the pair sums and K9 over S once and the core's
    factor and solve over S a chunk (the multifrontal refinement's two folds
    a pass), with one R the pair sums, K9's ``d`` channel and the core's
    factor once (``segsum``, ``peel_factor``, ``mf_factor`` or K11's
    ``dense_core`` and ``dense_gate``) and K9's ``r`` channel and the core's
    apply over S."""
    from networks_fenicsx_tpu_torch import tree as PT

    dtp = ex.device_plan
    pairs = dtp.num_pairs > 0
    want = {"edge_data_scenarios": 1, "bifurcation_system_scenarios": 1, "backsub_scenarios": 1}
    dmf = dtp.mf
    folds = 0 if dmf is None else dmf.plan.n_refine * sum(
        1 for plan in (dmf.mv_fold_i, dmf.mv_fold_j) if plan.rows)
    if r_batch:
        chunks = -(-S // PT.core_chunk(dtp, True, ex.scenario_budget))
        want.update(segsum_plan_scenarios=1 + int(pairs), peel_scenarios=1)
        if dmf is not None:
            want.update(mf_factor_scenarios=chunks, mf_apply_scenarios=chunks)
            if folds:
                want["fold_apply_scenarios"] = folds * chunks
        elif dtp.core_size:
            want.update(dense_factor_scenarios=chunks, dense_gate_scenarios=chunks,
                        dense_solve_scenarios=chunks)
        return want
    want.update(segsum_plan_scenarios=1, peel_factor=1, peel_apply_scenarios=1)
    if pairs:
        want["segsum"] = 1
    if dmf is not None:
        want.update(mf_factor=1, mf_apply_scenarios=1)
        if folds:
            want["fold_apply_scenarios"] = folds
    elif dtp.core_size:
        want.update(dense_core=1, dense_gate=1,
                    dense_solve_scenarios=-(-S // PT.core_chunk(dtp, False, ex.scenario_budget)))
    return want


def route_launches_vs_S(P, device, asm, make_batch, label: str, executor: str,
                        sweep_method: str = "auto") -> dict:
    """A sweep's device events as the profiler counts them (kernels and
    copies, by name) at S = 16, 1 and 16: equal, one chunk of the core's
    factors holding 16 scenarios."""
    opts = P.SolverOptions(schur_method=sweep_method)
    counts = {}
    for S in (SWEEP_S, 1, SWEEP_S):
        batch = make_batch(S)
        P.solve_sweep(asm, options=opts, device=device, **batch)  # warm: the cache
        for _ in range(6):
            got = kernel_counts(lambda: P.solve_sweep(asm, options=opts, device=device, **batch),
                                device)
            if got is not None:
                break
        assert got is not None, (label, S, "no window held its run")
        counts[S] = got
    ex = next(e[1] for e in asm._sweep_cache.values() if type(e[1]).__name__ == executor)
    if executor == "_TreeExecutor":
        from networks_fenicsx_tpu_torch import tree as PT

        assert PT.core_chunk(ex.device_plan, True, ex.scenario_budget) >= SWEEP_S, label
    c1, c16 = counts[1], counts[SWEEP_S]
    assert c1 == c16, (label, {k: (c1.get(k), c16.get(k)) for k in set(c1) | set(c16)
                               if c1.get(k) != c16.get(k)})
    return {"S1": sum(c1.values()), "S16": sum(c16.values()), "kernels": len(c16)}


def timed_call(fn) -> tuple:
    """``(fn(), its device ms)`` of one call, by CUDA events (a plain version
    timed on the call whose result is checked)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def hold_scenario(rec: dict, name: str, got, ones, plain, tol: float, exact: bool,
                  kernel=None, plain_ms: float | None = None, work=None, library=None) -> dict:
    """A scenario wrapper's result ``got`` against the one-scenario wrapper a
    row (``ones``, stacked: bit for bit, NaN where NaN) and against its plain
    version within ``tol``·scale (``exact``: bit for bit too); with
    ``kernel``, its CUDA-event ms beside its plain version's (``plain_ms``),
    its bound (``work``) and the ``library`` call's ms."""
    torch.cuda.synchronize()
    ft = float_tensors(got)
    assert all(same(a, b) for a, b in zip(ft, float_tensors(ones))), (name, "rows")
    err, scale = nan_close(name, got, plain, tol)
    equal = all(same(a, b) for a, b in zip(ft, float_tensors(plain)))
    if exact:
        assert equal, (name, "not bit for bit against the plain version")
    r = {"max_abs_err": err, "scale": scale, "rows_equal": True, "equal": equal}
    if kernel is not None:
        r["ms"] = cuda_ms(kernel, reps=5)
        r["plain_ms"] = plain_ms
        r.update(bound(*work))
        r["library_ms"] = cuda_ms(library, reps=5) if library is not None else None
    rec[name] = r
    return r


def level_tree_kernel_sets(P, device, forest_asm, web_asm) -> dict:
    """The level and tree routes' scenario kernels on the card, S = 16, each
    against the one-scenario wrapper a row (``torch.equal``) and its plain
    version, timed beside its bound: K7 over S on the 100k forest's R batch
    (at 1e-12·scale); on the 100k web's R batch K9 over S (both channels,
    around a diagonal core solve ``r / d``: the rounds alone), K13–K14 over S
    on the rows' folded diagonals with row :data:`MF_TRIP_ROW` negated (its
    gate trips: its λ NaN alone), K15 over S on those 16 factors (1e-10·scale)
    and K10 over S on the refinement's pair terms (beside batched
    ``index_add_``); on its p_bc batch K9's ``r`` channel and K15 on one
    shared factor."""
    from networks_fenicsx_tpu_torch import edge_data as PE
    from networks_fenicsx_tpu_torch import solver as PS
    from networks_fenicsx_tpu_torch.kernels import (
        edge_data, fold, level_eliminate, mf_apply, mf_factor, peel, segsum,
    )

    S = SWEEP_S
    scales = torch.as_tensor(SWEEP_SCALES, device=device)
    out = {}

    def sweep_data(ex, R, f, sp, ep):
        return edge_data.edge_data_scenarios(ex.device_plan, ex._N, ex._k, ex._h_e, ex._quad_w,
                                             ex._quad_phi, R, f, ex._R_mode, ex._f_mode,
                                             ex._f_is_zero, sp, ep)

    # K7 over S: the 100k forest's R batch
    ex = PS.build_schur_executor(forest_asm, P.SolverOptions(), device=device, elide_zero_f=False)
    assert type(ex).__name__ == "_LevelExecutor", type(ex)
    R0, f0, sp0, ep0 = ex.upload(*forest_asm.schur_arguments())
    dlp = ex.device_plan
    ed = sweep_data(ex, (R0[None] * scales[:, None]).contiguous(), f0, sp0, ep0)
    rec = {"S": S}
    lam, norm = level_eliminate.level_eliminate_scenarios(dlp, ed)
    ones = [level_eliminate.level_eliminate(dlp, PE.scenario_row(ed, i)) for i in range(S)]
    E, B = dlp.num_edges, dlp.num_bifurcations
    tables = tensor_bytes(dlp.sums.groups, dlp.levels, dlp.parent_pos, dlp.parent_pair,
                          dlp.child_ptr, dlp.kids, dlp.inv_perm, dlp.start_bif, dlp.end_bif)
    adds = sum(valid_entries(idx, E) for idx, _ in dlp.sums.groups)
    plain, plain_ms = timed_call(lambda: level_eliminate.level_eliminate_scenarios_plain(dlp, ed))
    hold_scenario(rec, "level_eliminate_scenarios", (lam, norm),
                  [torch.stack([o[j] for o in ones]) for j in range(2)], plain, TOL, False,
                  lambda: level_eliminate.level_eliminate_scenarios(dlp, ed), plain_ms,
                  (tables + tensor_bytes(ed.W, ed.g, sp0, ep0, lam, norm) + 8 * S * E,
                   S * (10 * E + 3 * adds + 8 * B)))
    rec["level_eliminate_scenarios"]["one_ms"] = cuda_ms(
        lambda: [level_eliminate.level_eliminate(dlp, PE.scenario_row(ed, i)) for i in range(S)],
        reps=2)
    out["level_forest_R16"] = rec
    del ex, ed, ones, lam

    # the 100k web (its multifrontal core): R batch, then a p_bc batch on one R
    ex = PS.build_schur_executor(web_asm, P.SolverOptions(), device=device, elide_zero_f=False)
    dtp, dmf = ex.device_plan, ex.device_plan.mf
    assert dmf is not None, "the web's core is multifrontal"
    R0, f0, sp0, ep0 = ex.upload(*web_asm.schur_arguments())
    ed = sweep_data(ex, (R0[None] * scales[:, None]).contiguous(), f0, sp0, ep0)
    dr, w = peel.bifurcation_system_scenarios(dtp, ed.W, ed.g, ed.cumF[:, -1], sp0, ep0)
    wp = segsum.segsum_plan_scenarios(dtp.pair_sums, w)[0]
    E, B, P_ = dtp.num_edges, dtp.num_bifurcations, dtp.num_pairs
    n_c, n_p = dtp.core_size, dtp.n_peeled
    rec = {"S": S}
    diag = lambda d, r: r / d  # noqa: E731 (a core "solve" that leaves the rounds alone)
    lam = peel.peel_scenarios(dtp, dr, wp, diag)
    ones = torch.stack([peel.peel(dtp, dr[i], wp[i], diag) for i in range(S)])
    folds = sum(int((rd.parents >= 0).sum()) for rd in dtp.rounds)  # a term a child
    peel_bytes = tensor_bytes(dtp.peel_table.table)
    plain, plain_ms = timed_call(lambda: peel.peel_scenarios_plain(dtp, dr, wp, diag))
    hold_scenario(rec, "peel_scenarios", lam, ones, plain, TOL, True,
                  lambda: peel.peel_scenarios(dtp, dr, wp, diag), plain_ms,
                  (peel_bytes + tensor_bytes(dr, wp, lam) + 16 * S * n_c,
                   S * (6 * n_p + 2 * folds + n_c)))
    # K13–K14 over S on the rows' folded diagonals, one row tripping the gate
    dc = torch.stack([peel.peel_factor(dtp, dr[i], wp[i]).dc for i in range(S)])
    dc[MF_TRIP_ROW] = -dc[MF_TRIP_ROW]
    fac = mf_factor.mf_factor_scenarios(dmf, dc, wp)
    assert fac.ok.tolist() == [int(i != MF_TRIP_ROW) for i in range(S)], fac.ok.tolist()
    one_fac = [mf_factor.mf_factor(dmf, dc[i], wp[i]) for i in range(S)]
    keep = [i for i in range(S) if i != MF_TRIP_ROW]
    plain_fac, plain_ms = timed_call(lambda: mf_factor.mf_factor_scenarios_plain(dmf, dc, wp))
    groups = dmf.plan.groups
    fac_ops = sum(g.k * (g.w**3 / 3 + g.w**2 * g.b + g.w * g.b**2) for g in groups)
    mf_index = tensor_bytes(dmf.init_slot, dmf.nodes_all, dmf.cval_all, dmf.ccol_all, dmf.rel_all,
                            dmf.xadd_ptr, dmf.xadd, dmf.fronts, dmf.groups_dev)
    hold_scenario(rec, "mf_factor_scenarios", [t[keep] for t in fac[:3]],
                  [torch.stack([one_fac[i][j] for i in keep]) for j in range(3)],
                  [t[keep] for t in plain_fac[:3]], TOL, False,
                  lambda: mf_factor.mf_factor_scenarios(dmf, dc, wp), plain_ms,
                  (mf_index + tensor_bytes(dc, wp, fac.fac, fac.pools, fac.vals, fac.ok),
                   0.0, S * fac_ops))
    assert same(fac.fac[MF_TRIP_ROW], one_fac[MF_TRIP_ROW].fac), "the tripped row's factor"
    # K15 over S on the 16 factors: the tripped row NaN alone
    rc = (torch.linspace(-1.0, 1.0, n_c, dtype=torch.float64, device=device)[None]
          * scales[:, None]).contiguous()
    x = mf_apply.mf_apply_scenarios(dmf, fac, rc)
    assert torch.isnan(x[MF_TRIP_ROW]).all() and not torch.isnan(x[keep]).any(), "the gate"
    nr = dmf.plan.n_refine
    sweep_ops = sum(g.k * (2 * g.w**2 + 4 * g.w * g.b) for g in groups)
    apply_index = tensor_bytes(dmf.nodes_all, dmf.bndpos_all, dmf.xadd_ptr, dmf.xadd, dmf.fronts,
                               dmf.lam_pos, dmf.pci, dmf.pcj, dmf.mv_inv_i, dmf.mv_inv_j,
                               dmf.mv_fold_i, dmf.mv_fold_j)
    plain, plain_ms = timed_call(lambda: mf_apply.mf_apply_scenarios_plain(dmf, plain_fac, rc))
    hold_scenario(rec, "mf_apply_scenarios", x,
                  torch.stack([mf_apply.mf_apply(dmf, one_fac[i], rc[i]) for i in range(S)]),
                  plain, CYCLIC_TOL, False, lambda: mf_apply.mf_apply_scenarios(dmf, fac, rc),
                  plain_ms, (apply_index + tensor_bytes(fac.fac, fac.vals, fac.ok, dc, rc, x),
                             S * ((1 + nr) * sweep_ops + nr * 4 * dmf.plan.n_pairs)))
    del plain_fac, one_fac
    # K10 over S: the refinement's fold of the pair terms into their rows
    P0 = dmf.plan.n_pairs
    ti = (torch.linspace(-1.0, 1.0, P0, dtype=torch.float64, device=device)[None]
          * scales[:, None]).contiguous()
    plan = dmf.mv_fold_i
    seg = torch.unique(dmf.pci.long(), return_inverse=True)[1]
    plain, plain_ms = timed_call(lambda: fold.fold_apply_scenarios_plain(ti, plan))
    hold_scenario(rec, "fold_apply_scenarios", fold.fold_apply_scenarios(ti, plan),
                  torch.stack([fold.fold_apply(ti[i].contiguous(), plan) for i in range(S)]),
                  plain, 0.0, True, lambda: fold.fold_apply_scenarios(ti, plan), plain_ms,
                  (tensor_bytes(plan, ti) + 8 * S * plan.rows, S * P0),
                  lambda: torch.zeros((S, plan.rows), dtype=torch.float64,
                                      device=device).index_add_(1, seg, ti))
    out["tree_web_R16"] = rec

    # the p_bc batch on one R: K9's r channel and K15 on one shared factor
    mask_s, mask_e = (dtp.start_bif < 0).double(), (dtp.end_bif < 0).double()
    spb = (sp0[None] * scales[:, None] + mask_s[None] * scales[:, None]).contiguous()
    epb = (ep0[None] * scales[:, None] - mask_e[None] * scales[:, None]).contiguous()
    ed = sweep_data(ex, R0, f0, spb, epb)
    dr, w = peel.bifurcation_system_scenarios(dtp, ed.W, ed.g, ed.cumF[:, -1], spb, epb)
    wp0 = segsum.segsum_plan(dtp.pair_sums, w[0])[0]
    pf = peel.peel_factor(dtp, dr[0], wp0)
    rec = {"S": S}
    scale_core = lambda r: r / pf.dc  # noqa: E731
    lam = peel.peel_apply_scenarios(dtp, pf, dr, scale_core)
    plain, plain_ms = timed_call(lambda: peel.peel_apply_scenarios_plain(dtp, pf, dr, scale_core))
    hold_scenario(rec, "peel_apply_scenarios", lam,
                  torch.stack([peel.peel_apply(dtp, pf, dr[i], scale_core) for i in range(S)]),
                  plain, TOL, True, lambda: peel.peel_apply_scenarios(dtp, pf, dr, scale_core),
                  plain_ms, (peel_bytes + tensor_bytes(dr[:, :, 1], pf.w, pf.db, pf.factor, lam)
                   + 16 * S * n_c, S * (3 * n_p + folds + n_c)))
    st = mf_factor.mf_factor(dmf, pf.dc, wp0)
    rc = (torch.linspace(-1.0, 1.0, n_c, dtype=torch.float64, device=device)[None]
          * scales[:, None]).contiguous()
    x = mf_apply.mf_apply_scenarios(dmf, st, rc)
    st_plain = mf_factor.mf_factor_plain(dmf, pf.dc, wp0)
    plain, plain_ms = timed_call(lambda: mf_apply.mf_apply_scenarios_plain(dmf, st_plain, rc))
    hold_scenario(rec, "mf_apply_scenarios", x,
                  torch.stack([mf_apply.mf_apply(dmf, st, rc[i]) for i in range(S)]),
                  plain, CYCLIC_TOL, False, lambda: mf_apply.mf_apply_scenarios(dmf, st, rc),
                  plain_ms, (apply_index + tensor_bytes(st.fac, st.vals, st.ok, pf.dc, rc, x),
                   S * ((1 + nr) * sweep_ops + nr * 4 * P0)))
    out["tree_web_pbc16"] = rec
    return out


def tree_solve_batches(P, device, cases: dict, name_power: str) -> list:
    """``TreeFactorization.solve_batch`` of 16 right-hand sides (f and the
    boundary pressures scaled by :data:`SWEEP_SCALES`) on each case's stored
    factor: one call of each scenario wrapper (counted), every row
    ``solve()`` of that row bit for bit, its ms beside 16 ``solve()`` calls',
    the device's busy time and idle share.  Returns the counted launches."""
    from networks_fenicsx_tpu_torch import factorization as PF
    from networks_fenicsx_tpu_torch import kernels

    runs = []
    for label, (asm, base_forms) in cases.items():
        base_forms()
        fac = PF.build_tree_factorization(asm, device=device)
        dtp = fac.device_tree_plan
        R0, f0, sp0, ep0 = (np.asarray(a) for a in asm.schur_arguments())
        state = fac.factor(R0)
        f_b = SWEEP_SCALES[:, None] * f0.reshape(-1)[None]
        sp_b, ep_b = SWEEP_SCALES[:, None] * sp0[None], SWEEP_SCALES[:, None] * ep0[None]
        fac.solve_batch(state, f_b, sp_b, ep_b)
        torch.cuda.synchronize()
        kernels.reset_launches()
        outs = fac.solve_batch(state, f_b, sp_b, ep_b)
        torch.cuda.synchronize()
        fl = kernels.launches()
        want = {"condense_scenarios": 1, "bifurcation_system_scenarios": 1,
                "segsum_plan_scenarios": 1, "peel_apply_scenarios": 1, "expand_scenarios": 1}
        if dtp.mf is not None:
            want["mf_apply_scenarios"] = 1
            n_folds = sum(1 for plan in (dtp.mf.mv_fold_i, dtp.mf.mv_fold_j) if plan.rows)
            if n_folds * dtp.mf.plan.n_refine:
                want["fold_apply_scenarios"] = n_folds * dtp.mf.plan.n_refine
        elif dtp.core_size:
            want["dense_solve_scenarios"] = 1
        got = {n: v for n, v in fl.items() if v}
        assert got == want, (label, got, want)
        runs.append(fl)
        for i in range(SWEEP_S):
            one = fac.solve(state, f_b[i], sp_b[i], ep_b[i])
            assert all(torch.equal(a[i], b) for a, b in zip(outs, one)), (label, "row", i)
        assert bool(torch.all(outs[4])), (label, "finite")

        def solves():
            for i in range(SWEEP_S):
                fac.solve(state, f_b[i], sp_b[i], ep_b[i])

        rec = {"S": SWEEP_S, "rows_bit_for_bit": SWEEP_S, "wrapper_calls": want,
               "rounds": len(dtp.rounds), "core": dtp.core_size,
               "core_engine": "multifrontal" if dtp.mf is not None else (
                   "dense" if dtp.core_size else "none"),
               "solve_batch_ms": best_ms(lambda: fac.solve_batch(state, f_b, sp_b, ep_b)),
               "solves_ms": best_ms(solves, reps=2),
               "device": device_share(lambda: fac.solve_batch(state, f_b, sp_b, ep_b))}
        log(f"phase sweep tree solve_batch {label} (TreeFactorization, {name_power}): "
            + json.dumps(rec))
        del fac, state, outs
    return runs


def level_tree_sweeps(P, device, name_power: str, serial: dict) -> dict:
    """The level and tree routes' scenario axis on the card: the 100k forest
    (R and f batches of 16, the level route), the 100k web (R and p_bc, the
    tree route with its multifrontal core; the R batch one chunk), the
    perfusion bed (R), web1000 under ``schur_method="tree"`` (R and p_bc, its
    dense core), each against ``Solver.solve()`` and the same sweep a row at
    a time bit for bit with its launches at S = 1 and 16;
    ``TreeFactorization.solve_batch`` of 16 on the web, web1000 and the 100k
    forest (its forced rounds); the scenario kernels against the
    one-scenario kernels and their plain versions."""
    t0 = time.perf_counter()
    forest, web = serial["forest"][0], serial["web"][0]
    paths, runs, counts = {}, [], {}

    def cyc_forms(asm):
        return lambda **row: forest_forms(asm, **row)

    # the 100k forest: the level route
    ff = cyc_forms(forest)
    R0f, f0f = forest.schur_arguments()[:2]
    Rfb = np.asarray(R0f)[None] * SWEEP_SCALES[:, None]
    ffb = np.asarray(f0f)[None] * SWEEP_SCALES[:, None]
    paths["forest_R16"] = route_sweep_path(
        P, device, forest, "level forest R", {"R": Rfb}, lambda i: ff(R=Rfb[i]), ff, "auto",
        "_LevelExecutor", level_calls, LEVEL_FAMILIES)
    paths["forest_f16"] = route_sweep_path(
        P, device, forest, "level forest f", {"f": ffb}, lambda i: ff(f=ffb[i]), ff, "auto",
        "_LevelExecutor", level_calls, LEVEL_FAMILIES)
    counts["forest_R"] = route_launches_vs_S(
        P, device, forest, lambda S: {"R": np.asarray(R0f)[None] * np.linspace(0.5, 2.0, S)[:, None]},
        "forest R", "_LevelExecutor")
    ff()

    # the 100k web: the tree route, its multifrontal core
    wf = cyc_forms(web)
    R0w = np.asarray(web.schur_arguments()[0])
    Rwb = R0w[None] * SWEEP_SCALES[:, None]
    xw = web.network.vertices[: web.network.num_graph_nodes][:, 0]
    paths["web_R16"] = route_sweep_path(
        P, device, web, "tree web R", {"R": Rwb}, lambda i: wf(R=Rwb[i]), wf, "auto",
        "_TreeExecutor", tree_calls, TREE_FAMILIES, solves=True)
    paths["web_pbc16"] = route_sweep_path(
        P, device, web, "tree web p_bc", {"p_bc_node_values": SWEEP_SCALES[:, None] * xw[None]},
        lambda i: wf(s=SWEEP_SCALES[i]), wf, "auto", "_TreeExecutor", tree_calls, TREE_FAMILIES)
    counts["web_R"] = route_launches_vs_S(
        P, device, web, lambda S: {"R": R0w[None] * np.linspace(0.5, 2.0, S)[:, None]}, "web R",
        "_TreeExecutor")
    counts["web_pbc"] = route_launches_vs_S(
        P, device, web,
        lambda S: {"p_bc_node_values": np.linspace(0.5, 2.0, S)[:, None] * xw[None]}, "web p_bc",
        "_TreeExecutor")
    wf()

    # the perfusion bed: the tree route, its multifrontal core (no rounds)
    bed = bed_assembler(P)
    R0b = 1.0 / bed.network.edge_radius**4
    Rbb = R0b[None] * SWEEP_SCALES[:, None]
    paths["bed_R16"] = route_sweep_path(
        P, device, bed, "tree bed R", {"R": Rbb},
        lambda i: bed.compute_forms(p_bc_ex=lambda x: x[1], R=Rbb[i]), lambda: bed_forms(bed),
        "auto", "_TreeExecutor", tree_calls, TREE_FAMILIES)
    counts["bed_R"] = route_launches_vs_S(
        P, device, bed, lambda S: {"R": R0b[None] * np.linspace(0.5, 2.0, S)[:, None]}, "bed R",
        "_TreeExecutor")
    del bed

    # web1000 under schur_method="tree": its dense core (455 nodes)
    w1k = web_assembler(P, sites=1_000)
    kf = cyc_forms(w1k)
    R0k = np.asarray(w1k.schur_arguments()[0])
    Rkb = R0k[None] * SWEEP_SCALES[:, None]
    xk = w1k.network.vertices[: w1k.network.num_graph_nodes][:, 0]
    paths["web1000_R16"] = route_sweep_path(
        P, device, w1k, "tree web1000 R", {"R": Rkb}, lambda i: kf(R=Rkb[i]), kf, "tree",
        "_TreeExecutor", tree_calls, TREE_FAMILIES, sweep_method="tree")
    paths["web1000_pbc16"] = route_sweep_path(
        P, device, w1k, "tree web1000 p_bc", {"p_bc_node_values": SWEEP_SCALES[:, None] * xk[None]},
        lambda i: kf(s=SWEEP_SCALES[i]), kf, "tree", "_TreeExecutor", tree_calls, TREE_FAMILIES,
        sweep_method="tree")
    counts["web1000_R"] = route_launches_vs_S(
        P, device, w1k, lambda S: {"R": R0k[None] * np.linspace(0.5, 2.0, S)[:, None]},
        "web1000 R", "_TreeExecutor", sweep_method="tree")
    kf()
    for key, path in paths.items():
        runs.append(path["launches"])
        log(f"phase sweep level/tree {key} ({name_power}): " + json.dumps(path["rec"]))
    log("phase sweep level/tree launches (profiled, S = 1 and 16): " + json.dumps(counts))

    runs += tree_solve_batches(P, device, {"web": (web, wf), "web1000": (w1k, kf),
                                           "forest": (forest, ff)}, name_power)
    del w1k
    sets = level_tree_kernel_sets(P, device, forest, web)
    ff()
    wf()
    for name, rec in sets.items():
        log(f"phase kernels-sweep {name}: " + json.dumps(rec))
    log(f"phase wall: the level and tree sweep phases {time.perf_counter() - t0:.1f} s")
    return {"sets": sets, "runs": runs}


def sweep_phases(P, device, name_power: str, serial: dict) -> dict:
    """The sweeps: the headline tree's R and p_bc sweeps of 16 scenarios on
    the batched blocked route (the main path of the scenario kernels), the
    sweep against 16 ``compute_forms`` + ``solve()`` calls, the scenario
    kernels against their plain versions, the row routes and ``devices=``."""
    t_start = time.perf_counter()
    asm = serial["tree"][0]
    R0 = 1.0 / asm.network.edge_radius**4
    Rb = R0[None] * SWEEP_SCALES[:, None]
    pb = asm.network.vertices[: asm.network.num_graph_nodes][:, 1]
    pbb = SWEEP_SCALES[:, None] * pb[None]
    paths = {}
    paths["R"] = headline_sweep(
        P, device, asm, "sweep-R", {"R": Rb},
        lambda i: asm.compute_forms(p_bc_ex=lambda x: x[1], R=Rb[i]), R0)
    paths["p_bc"] = headline_sweep(
        P, device, asm, "sweep-p_bc", {"p_bc_node_values": pbb},
        lambda i: asm.compute_forms(p_bc_ex=lambda x, s=SWEEP_SCALES[i]: s * x[1], R=R0), R0)

    # physics: q ∝ 1/R (f = 0), x linear in p_bc
    offs = asm.block_offsets
    M = asm.network.num_edge_colors
    xr = paths["R"]["res"].x
    q = xr[:, : offs[M]] * SWEEP_SCALES[:, None]
    np.testing.assert_allclose(q[:, 0], q[0, 0], rtol=1e-10)
    q_err = float(np.abs(q - q[:1]).max()) / float(np.abs(q[0]).max())
    assert q_err <= 1e-10, q_err
    xp = paths["p_bc"]["res"].x
    lin = xp[0][None] * (SWEEP_SCALES / SWEEP_SCALES[0])[:, None]
    p_scale = max(1.0, float(np.abs(lin).max()))
    p_err = float(np.abs(xp - lin).max())
    assert p_err <= 1e-11 * p_scale, (p_err, p_scale)
    log(f"phase sweep physics: q·s relative spread {q_err:.3e} (rtol 1e-10), p_bc linearity "
        f"{p_err:.3e} (scale {p_scale:.3e}, 1e-11·scale)")

    # the sweep against 16 compute_forms + solve() calls
    solver = P.Solver(asm, device=device)

    def solves():
        for i in range(SWEEP_S):
            asm.compute_forms(p_bc_ex=lambda x: x[1], R=Rb[i])
            solver.solve()

    solves()
    loop_ms = best_ms(solves, reps=2)
    loop_dev = device_share(solves)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0)
    for key, path in paths.items():
        rec = {k: path[k] for k in ("sweep_ms", "flatten_ms", "device", "rows_bit_for_bit",
                                    "counts")}
        log(f"phase sweep {key} (16 gen, N=40, S={SWEEP_S}): " + json.dumps(rec))
    log("phase sweep timing (16 gen, N=40, S=16 per-edge R; " + name_power + "): " + json.dumps({
        "sweep_ms": paths["R"]["sweep_ms"], "flatten_ms": paths["R"]["flatten_ms"],
        "sweep_device": paths["R"]["device"], "solves_ms": loop_ms, "solves_device": loop_dev}))

    # devices=["cuda:0"] * 2 on the R sweep: the one-device sweep's bits
    two = P.solve_sweep(asm, R=Rb, devices=[device] * 2)
    assert all(torch.equal(a, b) for a, b in zip(two.blocks, paths["R"]["res"].blocks)), "devices"
    log("phase sweep devices=['cuda:0'] * 2: the one-device sweep's blocks bit for bit")
    runs = [paths["R"]["launches"], paths["p_bc"]["launches"]]
    del two
    for path in paths.values():
        del path["res"]

    sets = scenario_kernel_sets(P, device, asm)
    for name in ("headline_R16", "headline_pbc16"):
        log(f"phase kernels-sweep {name}: " + json.dumps(sets[name]))
    exact = {n: f"{sum(rec[n]['equal'] for rec in sets.values() if n in rec)} of "
                f"{sum(n in rec for rec in sets.values())}" for n in SCENARIO_CHECKS}
    log(f"phase kernels-sweep: {len(sets)} cases (S in {{1, 16}}, k = 1 and 2, every mode, "
        "batched and shared inputs), each against the one-scenario wrapper a row bit for bit "
        "(K2–K4 also against the plain version in the kernels' order) and against the plain "
        "version at TOL·scale; the cases bit for bit against the plain version: "
        + json.dumps(exact))
    rows = row_route_sweeps(P, device)
    log("phase sweep row routes: " + json.dumps(rows))
    dense = dense_sweeps(P, device, name_power)
    sets.update(dense["sets"])
    runs += dense["runs"]
    lattice = lattice_sweeps(P, device, name_power)
    sets.update(lattice["sets"])
    runs += lattice["runs"]
    level_tree = level_tree_sweeps(P, device, name_power, serial)
    sets.update(level_tree["sets"])
    runs += level_tree["runs"]
    log(f"phase wall: the sweep phases {time.perf_counter() - t_start:.1f} s")
    return {"sets": sets, "runs": runs}


# ---------------------------------------------------------------- gradients

ADJOINT_SEED = 30  # the seeded cotangents and central-difference direction
ADJOINT_CD_EPS = 1e-6  # the central difference's step, times each input's scale
ADJOINT_CD_RTOL = 1e-6  # its bar (tests/test_transforms.py:107)
ADJOINT_REPS = 5  # forward-with-grad and backward timings, best of
ADJOINT_DEMO_TOP = 5  # the demo's most sensitive vessels (demos/demo_sweep.py:55)
# the adjoint wrappers, checked and timed on the headline's kernel set
ADJOINT_CHECKS = ("condense_vjp", "expand_vjp", "expand_vjp_fold")
# a gradient's kernels by family: the forward (K1, K2's factor and K3–K4's apply, K5) and the
# backward (K5ᵀ, the fold, K3–K4's apply, K1ᵀ)
ADJOINT_FAMILIES = {"condense": r"\bcondense_kernel", "tree_sweep": SWEEP_PATTERN,
                    "expand": r"\bexpand_kernel\b", "expand_vjp": r"\bexpand_vjp_kernel\b",
                    "expand_vjp_fold": r"\bexpand_vjp_fold_kernel\b",
                    "condense_vjp": r"\bcondense_vjp_(kernel|finish)\b"}
# a gradient's wrapper calls on the blocked route: the forward, then the backward
ADJOINT_LAUNCHES = {"condense": 1, "tree_sweep_factor": 1, "tree_sweep_apply": 2, "expand": 1,
                    "expand_vjp": 1, "expand_vjp_fold": 1, "condense_vjp": 1}


def adjoint_kernel_checks(ex, base: list, device) -> dict:
    """``expand_vjp``, ``expand_vjp_fold`` and ``condense_vjp`` on the card
    against their plain versions on the same inputs (the forward's saved
    tensors on ``base`` and seeded cotangents of the blocks and λ), at
    TOL·scale, each timed beside its bound (no PyTorch call computes
    them)."""
    from networks_fenicsx_tpu_torch.kernels import condense, expand, tree_sweep

    dp, N, k, h, Rm, fm = ex.device_plan, ex._N, ex._k, ex._h_e, ex._R_mode, ex._f_mode
    plan, E, B = dp.plan, dp.num_edges, dp.num_bifurcations
    R, f, sp, ep = base
    W, w, g, Ftot, const = condense.condense(dp, N, k, h, R, f, Rm, fm, sp, ep)
    d, wn, fac = tree_sweep.tree_sweep_factor(dp, w)
    lam = tree_sweep.tree_sweep_apply(dp, d, wn, fac, const, Ftot)[0]
    rng = np.random.default_rng(ADJOINT_SEED)
    q_bar, p_bar, lam_bar = (torch.as_tensor(rng.standard_normal(shape), device=device)
                             for shape in ((k * N + 1, E), (N, E), (B,)))
    ends = (dp.edge_src, dp.edge_tgt)
    rec = {}
    parts = 8 * ((N * E if Rm == "cell" else E) + (N * E if fm == "cell" else E))
    # K5ᵀ: the cotangents read once, λ, the boundary data, w, g, h, R, f and the row ends; bars
    # and the two parts written
    rec["expand_vjp"] = check_pair(
        lambda: expand.expand_vjp(dp, N, k, lam, sp, ep, w, g, h, R, f, Rm, fm, q_bar, p_bar),
        lambda: expand.expand_vjp_plain(plan, N, k, lam, sp, ep, w, g, h, R, f, Rm, fm, q_bar,
                                        p_bar),
        work=(tensor_bytes(q_bar, p_bar, lam, sp, ep, w, g, h, R, f, ends) + 8 * 3 * E + parts,
              (30 + 4 * (k - 1)) * N * E))
    bars, R_part, f_part = expand.expand_vjp(dp, N, k, lam, sp, ep, w, g, h, R, f, Rm, fm, q_bar,
                                             p_bar)
    # the fold: λ̄, each bifurcation's in-edge and out-edges (and their r̄N, r̄0), the edges'
    # targets; rho and Ftot_adj written
    outs = table_entries(dp.bif_out)
    rec["expand_vjp_fold"] = check_pair(
        lambda: expand.expand_vjp_fold(dp, lam_bar, bars),
        lambda: expand.expand_vjp_fold_plain(dp, lam_bar, bars),
        work=(tensor_bytes(lam_bar, dp.bif_in, dp.bif_out, dp.edge_tgt) + 8 * (2 * B + outs + E),
              B + outs))
    rho, rhs_edges = expand.expand_vjp_fold(dp, lam_bar, bars)
    rec["expand_vjp_fold"]["equal"] = bool(torch.equal(
        rho, expand.expand_vjp_fold_plain(dp, lam_bar, bars)[0]))
    z = tree_sweep.tree_sweep_solve(dp, d, wn, fac, rhs_edges)
    # K1ᵀ: the per-edge inputs, λ and z once each, bars, the parts and the row ends read; the
    # boundary cotangents and R's and f's written
    args = (dp, N, k, h, R, f, Rm, fm, sp, ep, w, g, lam, z, bars)
    rec["condense_vjp"] = check_pair(
        lambda: condense.condense_vjp(*args, R_part.clone(), f_part.clone()),
        lambda: condense.condense_vjp_plain(plan, *args[1:], R_part, f_part))
    scratch = (R_part.clone(), f_part.clone())  # written over by the timed calls
    rec["condense_vjp"]["ms"] = cuda_ms(lambda: condense.condense_vjp(*args, *scratch))
    rec["condense_vjp"]["plain_ms"] = cuda_ms(
        lambda: condense.condense_vjp_plain(plan, *args[1:], R_part, f_part), reps=3, warmup=1)
    rec["condense_vjp"].update(bound(
        tensor_bytes(h, R, f, sp, ep, w, g, lam, z, bars, R_part, f_part, ends) + 8 * 2 * E
        + 8 * (R.numel() if Rm != "scalar" else 1) + 8 * (f.numel() if fm != "scalar" else 1),
        40 * E * (N if "cell" in (Rm, fm) else 1)))
    rec["condense_vjp"]["library_ms"] = None
    return rec


def adjoint_headline(P, device, asm, name_power: str) -> dict:
    """Gradients of ``Σ q_T[0]²`` with respect to R, f and both boundary
    arrays through the headline's blocked solve (5,341,102 dofs), counted
    (every wrapper's launches set to 0 just before the gradient and read
    just after: the forward's K1, K2's factor, K3–K4's apply, K5 and the
    backward's K5ᵀ, fold, apply, K1ᵀ, nothing else); the no-grad outputs
    against the grad-mode outputs bit for bit; the gradient against
    PyTorch's autograd of the plain path at TOL·scale a input and against a
    central difference along a seeded direction; forward-with-grad and
    backward ms, synchronised, best of :data:`ADJOINT_REPS`; device µs by
    kernel family."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.solver import build_schur_executor

    ex = build_schur_executor(asm, P.SolverOptions(), device=device)
    assert type(ex).__name__ == "_BlockedExecutor" and ex.has_adjoint, type(ex)
    base = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    names = ("R", "f", "start_pbc", "end_pbc")

    def leaves():
        return [t.clone().requires_grad_(True) for t in base]

    def gradient(run):
        xs = leaves()
        loss = torch.sum(run(*xs)[0][0] ** 2)
        return loss, torch.autograd.grad(loss, xs)

    gradient(ex)
    torch.cuda.synchronize()
    kernels.reset_launches()
    loss, grads = gradient(ex)
    torch.cuda.synchronize()
    launches = kernels.launches()
    assert all(launches[n] == v for n, v in ADJOINT_LAUNCHES.items()), launches
    assert all(v == 0 for n, v in launches.items() if n not in ADJOINT_LAUNCHES), launches

    with torch.no_grad():
        plain_out = ex(*base)
    grad_out = ex(*leaves())
    same = all(torch.equal(a, b) for a, b in zip(plain_out[:3], grad_out[:3]))
    assert same, "the grad-mode outputs differ from the no-grad solve's"

    loss_p, grads_p = gradient(ex.plain)
    vs_plain = {}
    for name, a, b in zip(names, grads, grads_p):
        err, scale = max_err(a, b)
        vs_plain[name] = {"max_abs_err": err, "scale": scale}
    log("phase adjoint headline: gradient vs autograd of the plain path " + json.dumps(vs_plain))
    assert all(v["max_abs_err"] <= TOL * v["scale"] for v in vs_plain.values()), vs_plain

    rng = np.random.default_rng(ADJOINT_SEED)
    dirs = [torch.as_tensor(rng.standard_normal(tuple(t.shape)), device=device)
            * torch.clamp(t.abs(), min=1.0) for t in base]
    ad = float(sum(torch.sum(a * d) for a, d in zip(grads, dirs)))

    def loss_at(step: float) -> float:
        with torch.no_grad():
            q_T = ex(*(t + step * d for t, d in zip(base, dirs)))[0]
        return float(torch.sum(q_T[0] ** 2))

    lp, lm = loss_at(ADJOINT_CD_EPS), loss_at(-ADJOINT_CD_EPS)
    fd = (lp - lm) / (2 * ADJOINT_CD_EPS)
    cd = {"directional": ad, "central_difference": fd, "rel_err": abs(ad - fd) / abs(fd)}
    assert cd["rel_err"] <= ADJOINT_CD_RTOL, cd

    def forward_ms():
        times = []
        for _ in range(ADJOINT_REPS):
            xs = leaves()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.sum(ex(*xs)[0][0] ** 2)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    def backward_ms():
        times = []
        for _ in range(ADJOINT_REPS):
            xs = leaves()
            loss = torch.sum(ex(*xs)[0][0] ** 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.autograd.grad(loss, xs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    def graph():
        xs = leaves()
        return xs, torch.sum(ex(*xs)[0][0] ** 2)

    with torch.no_grad():
        nograd_ms = best_ms(lambda: ex(*base), reps=ADJOINT_REPS)
    timing = {"forward_with_grad_ms": forward_ms(), "backward_ms": backward_ms(),
              "no_grad_solve_ms": nograd_ms, "device": {
                  "forward": padded_split(lambda xs: torch.sum(ex(*xs)[0][0] ** 2),
                                          ADJOINT_FAMILIES, device, setup=leaves),
                  "backward": padded_split(lambda g: torch.autograd.grad(g[1], g[0]),
                                           ADJOINT_FAMILIES, device, setup=graph)}}
    log("phase adjoint headline (16 gen, N=40, per-edge R, Σ q_T[0]², d/dR, f, p_s, p_t; "
        + name_power + "): " + json.dumps({"launches": {n: launches[n] for n in ADJOINT_LAUNCHES},
                                           "no_grad_bit_for_bit": same, "central": cd, **timing}))
    sets = adjoint_kernel_checks(ex, base, device)
    log("phase kernels-adjoint (16 gen, N=40, per-edge R, scalar f, k=1): " + json.dumps(sets))
    return {"launches": launches, "set": sets}


def adjoint_demo(P, device) -> dict:
    """The demo's adjoint (demos/demo_sweep.py:46-58): d(root flux)/dR_e of
    ``make_arterial_tree(6)`` at N = 10 through ``outputs="flat"``, its
    :data:`ADJOINT_DEMO_TOP` most sensitive vessels on the card equal the
    CPU plain path's, the gradients at TOL·scale."""
    from networks_fenicsx_tpu_torch.solver import build_schur_executor

    net = P.network_generation.make_arterial_tree(6, direction=[0.1, 1.0, 0.0], arrays=True)
    mesh = P.NetworkMesh(net, N=10, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh)
    R0 = 1.0 / mesh.edge_radius**4
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0)
    _, f_arg, sp, ep = asm.schur_arguments(device=False)

    def sensitivity(dev, plain: bool) -> np.ndarray:
        ex = build_schur_executor(asm, P.SolverOptions(), device=dev, outputs="flat")
        R = torch.tensor(R0, device=dev, requires_grad=True)
        x = (ex.plain if plain else ex)(R, f_arg, sp, ep)[0]
        return torch.autograd.grad(x[0], R)[0].cpu().numpy()

    g_card, g_cpu = sensitivity(device, False), sensitivity("cpu", True)
    top_card, top_cpu = (np.argsort(np.abs(g))[::-1][:ADJOINT_DEMO_TOP] for g in (g_card, g_cpu))
    err, scale = float(np.abs(g_card - g_cpu).max()), max(1.0, float(np.abs(g_cpu).max()))
    rec = {"top": top_card.tolist(), "cpu_top": top_cpu.tolist(), "max_abs_err": err,
           "scale": scale}
    assert np.array_equal(top_card, top_cpu) and err <= TOL * scale, rec
    return rec


def adjoint_phases(P, device, name_power: str, serial: dict) -> dict:
    """The blocked route's gradients: the headline (the adjoint kernels'
    main path) and the demo tree."""
    t_start = time.perf_counter()
    head = adjoint_headline(P, device, serial["tree"][0], name_power)
    demo = adjoint_demo(P, device)
    log("phase adjoint demo (make_arterial_tree(6), N=10, outputs='flat', d x[0] / dR): "
        + json.dumps(demo))
    log(f"phase wall: the adjoint phases {time.perf_counter() - t_start:.1f} s")
    return {"sets": {"headline": head["set"]}, "runs": [head["launches"]]}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import networks_fenicsx_tpu_torch as P
    from networks_fenicsx_tpu_torch.kernels import build

    name_power = card()
    log(f"phase device: {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    build.library()
    log(f"phase build: kernels built and loaded in {time.perf_counter() - t0:.3f} s "
        f"({build.source_digest()})")

    y_bifurcation(P, device)

    full = compare_kernels(P, arterial_assembler(P, GENERATIONS, N_CELLS), device, timed=True)
    sweep_case = full.pop("_case")
    assert full["tree_sweep"]["cuda_launches"] == SWEEP_LAUNCHES, full["tree_sweep"]
    log("phase kernels (16 gen, N=40, edge R, zero f, k=1): " + json.dumps(full))
    small = compare_kernels(
        P, arterial_assembler(P, 10, 8, k=2, per_cell=True, seed=3), device, timed=False
    )
    small.pop("_case")
    log("phase kernels (10 gen, N=8, cell R, cell f, k=2): " + json.dumps(small))

    log(f"phase wall: the build and the kernels' phases {time.perf_counter() - t_start:.1f} s")
    state = main_path(P, device)
    timing(P, state, name_power)
    # the serial main paths' assemblers and solutions, for the sharded phases
    serial = {"tree": (state["asm"], state["solver"].solution_vector())}
    del state["solver"]

    sets = {}
    sets["a"] = compare_level_kernels(P, callable_assembler(P), device, timed=True, keep_case=True)
    edge_case = sets["a"].pop("_edge_case")
    log("phase kernels-level (a) 16 gen, N=40, callable R and f, k=1: " + json.dumps(sets["a"]))
    big = forest_mesh(P)
    sets["b"] = compare_level_kernels(P, forest_assembler(P, big), device, timed=True)
    log("phase kernels-level (b) 100k forest, N=8, edge R, cell f, k=2: " + json.dumps(sets["b"]))
    small_forest = forest_mesh(P, sites=2_000)
    asm_c = P.HydraulicNetworkAssembler(small_forest, flux_degree=3, pressure_degree=0)
    callable_forms(asm_c)
    sets["c"] = compare_level_kernels(P, asm_c, device, timed=False)
    log("phase kernels-level (c) 2k forest, N=8, callable R and f, k=3: " + json.dumps(sets["c"]))
    sets["d"] = compare_level_kernels(P, forest_assembler(P, big, k=1, f_kind="scalar"), device,
                                      timed=False)
    log("phase kernels-level (d) 100k forest, N=8, edge R, scalar f, k=1: " + json.dumps(sets["d"]))
    assert [sets[c]["layout"] for c in "abcd"] == ["general", "scalar_k", "general", "uniform"]
    del big, small_forest, asm_c

    tree = level_main_path(P, device, "general-forest main path", lambda: callable_assembler(P),
                           {"edges": 65_535, "bifurcations": 32_767, "dofs": DOFS})
    level_timing(P, tree, callable_forms, "general-forest", name_power)
    del tree["asm"], tree["solver"]
    forest = level_main_path(P, device, "irregular-forest main path",
                             lambda: forest_assembler(P, forest_mesh(P)), FOREST_SIZES)
    level_timing(P, forest, forest_forms, "irregular-forest", name_power)
    serial["forest"] = (forest.pop("asm"), forest.pop("solver").solution_vector())
    forest_asm = serial["forest"][0]  # for K7's launch counts at the end

    log(f"phase wall: the main path and the level phases {time.perf_counter() - t_start:.1f} s")
    cyc = {}
    web = web_assembler(P)
    cyc["a"] = compare_cyclic_kernels(P, web, device, timed=True, keep_case=True)
    peel_cases = {"web": cyc["a"].pop("_peel_case")}
    log("phase kernels-cyclic (a) 100k web with anastomoses, N=8, edge R, cell f, k=2: "
        + json.dumps(cyc["a"]))
    del web
    cyc["b"] = compare_cyclic_kernels(P, bed_assembler(P), device, timed=False)
    log("phase kernels-cyclic (b) perfusion bed (5, 96, 64), N=2, R=1/r^4: " + json.dumps(cyc["b"]))
    cyc["c"] = compare_cyclic_kernels(P, bed_assembler(P, 3, 12, 8), device, timed=True)
    log("phase kernels-cyclic (c) perfusion bed (3, 12, 8), N=2, R=1/r^4, dense core: "
        + json.dumps(cyc["c"]))
    cyc["d"] = compare_cyclic_kernels(P, golden_web48(P), device, timed=False, force_mf_leaf=4)
    log("phase kernels-cyclic (d) web48 golden, N=2, multifrontal forced (leaf 4): "
        + json.dumps(cyc["d"]))
    cyc["e"] = compare_cyclic_kernels(P, web_assembler(P, sites=1_000), device, timed=True,
                                      keep_case=True)
    peel_cases["web1000"] = cyc["e"].pop("_peel_case")
    log("phase kernels-cyclic (e) 1k web with anastomoses, N=8, edge R, cell f, k=2, dense core: "
        + json.dumps(cyc["e"]))
    cyc["f"] = compare_cyclic_kernels(P, star_assembler(P), device, timed=False)
    log(f"phase kernels-cyclic (f) a star of {STAR_LEAVES} leaves on a triangle, N=2, edge R, "
        "cell f, k=1, K9's fold of two levels: " + json.dumps(cyc["f"]))
    assert (cyc["a"]["rounds"], cyc["a"]["core"], cyc["b"]["core"], cyc["c"]["core"]) == (
        18, 52_571, 6_206, 110)
    assert (cyc["e"]["rounds"], cyc["e"]["core"]) == (11, 455), cyc["e"]
    star = (cyc["f"]["rounds"], cyc["f"]["core"], cyc["f"]["peel_fold_levels"])
    assert star == (1, 3, 2), cyc["f"]

    web = cyclic_main_path(P, device, "web main path", lambda: web_assembler(P), WEB_SIZES)
    cyclic_timing(P, web, forest_forms, "web", name_power)
    serial["web"] = (web.pop("asm"), web.pop("solver").solution_vector())
    web_asm = serial["web"][0]  # for the multifrontal launch counts at the end
    bed = cyclic_main_path(P, device, "bed main path", lambda: bed_assembler(P), BED_SIZES)
    cyclic_timing(P, bed, bed_forms, "bed", name_power)

    web1000 = cyclic_main_path(P, device, "web1000 main path",
                               lambda: web_assembler(P, sites=1_000), WEB1000_SIZES)
    cyclic_timing(P, web1000, forest_forms, "web1000", name_power)

    del web1000["asm"], web1000["solver"]

    log(f"phase wall: the cyclic phases {time.perf_counter() - t_start:.1f} s")
    lattice = lattice_phases(P, device, name_power)
    lat = lattice["sets"]
    serial["lattice"] = lattice.pop("auto")

    mid = core_phases(P, device, name_power)
    core, k11 = mid["sets"], mid["k11"]

    iterative = cg_phases(P, device, name_power)
    cgs = iterative["sets"]

    generic = generic_phases(P, device, name_power)
    gen_sets = generic["sets"]

    t_factor = time.perf_counter()
    factor = factor_phases(P, device, name_power, serial, mid.pop("fronts128"))
    log(f"phase wall: the factor-reuse phases {time.perf_counter() - t_factor:.1f} s")

    sweeps = sweep_phases(P, device, name_power, serial)
    sweep_sets = sweeps["sets"]
    adjoint = adjoint_phases(P, device, name_power, serial)

    t_sharded = time.perf_counter()
    log(f"phase wall: before the sharded phases {t_sharded - t_start:.1f} s")
    sharded = sharded_phases(P, device, name_power, serial)
    log(f"phase wall: the sharded phases {time.perf_counter() - t_sharded:.1f} s")
    shard_sets = sharded["sets"]
    log("phase krylov launches (an iteration, reported and profiled): "
        + json.dumps(krylov_launch_counts(device)))
    log("phase multifrontal launches (a web factor and apply, reported and profiled): "
        + json.dumps(mf_launch_counts(P, web_asm)))
    log("phase 1-D V-cycle launches (a cycle, reported and profiled): "
        + json.dumps(mg1d_launch_counts(P, device)))
    log("phase sharded-forest K22c launches (a solve on 8 shards, reported and profiled): "
        + json.dumps(dist_launch_counts(sharded.pop("dist_case"), device)))
    log("phase K8a and K22a launches (a callable-tree K8a call; a sharded-tree solve's K22a on 8 "
        "shards; reported and profiled, the counts before beside them): "
        + json.dumps(edge_shard_launch_counts(edge_case, sharded["blocked_case"], device)))
    del edge_case
    log("phase K22b and K1 launches (a sharded-lattice solve's K22b; a sharded-tree and a "
        "sharded-lattice solve's K1 on 8 shards; reported over the executor and over the stages, "
        "and profiled, the counts before beside them): "
        + json.dumps(strip_condense_launch_counts(sharded.pop("blocked_case"),
                                                  sharded.pop("lattice_case"), device)))
    log("phase K7 and K19b launches (a forest elimination; a web-cg Chebyshev application and "
        "matvec; reported and profiled, the counts before beside them): "
        + json.dumps(level_gather_launch_counts(P, forest_asm, web_asm, device)))
    log("phase K2–K4 and K12a launches (a headline sweep; a web2k and a fronts128 core solve's "
        "rounds; reported and profiled): "
        + json.dumps(sweep_core_launch_counts(sweep_case, mid.pop("launch_cases"), device)))
    log("phase K9 launches (a peel solve on the 100k web and on web1000; reported and profiled, "
        "the counts before beside them): " + json.dumps(peel_launch_counts(peel_cases, device)))
    del peel_cases
    log("phase panel launches (the tiled Cholesky's panels and trailing updates in one call, "
        "device µs by the profiler, None where it recorded none): "
        + json.dumps(panel_launch_phase(P, device)))

    runs = (state["launches"], tree["launches"], forest["launches"], web["launches"],
            bed["launches"], web1000["launches"],
            *(path["launches"] for path in lattice["paths"].values()),
            *(path["launches"] for path in mid["paths"].values()),
            *(path["launches"] for path in iterative["paths"].values()), *generic["runs"],
            *(path["launches"] for path in sharded["paths"].values()),
            *(path["launches"] for path in factor.values()), *sweeps["runs"], *adjoint["runs"])
    timed_cyclic = {"dense_core": k11[K11_TIMED], "core_elim": core["f"]["core_elim"],
                    "core_fronts": core["i"]["core_fronts"]}
    timed_lattice = {"dct_lattice": lat["a"], "grid_core": lat["a"], "shift_matvec": lat["c"]}
    log(f"phase wall: the script so far {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNEL_RECORD.items():
        lattice_errs = tuple(lat[c][name]["max_abs_err"] for c in LATTICE_SETS if name in lat[c])
        if name in full:
            errs = (full[name]["max_abs_err"], small[name]["max_abs_err"]) + lattice_errs
            if name == "condense":
                errs += tuple(shard_sets[on][key]["max_abs_err"] for on, key in SHARDED_CONDENSE)
            timed_on = full[name]
        elif name in sets["a"]:
            errs = tuple(sets[c][name]["max_abs_err"] for c in "abcd") + lattice_errs
            timed_on = sets["a"][name]
        elif name in LATTICE_CHECKS:
            errs = tuple(lat[c][key]["max_abs_err"] for c in LATTICE_SETS
                         for key in LATTICE_CHECKS[name] if key in lat[c])
            timed_on = timed_lattice[name][name]
        elif name in CG_CHECKS:
            on, keys = CG_CHECKS[name]
            errs = tuple(cgs[on][key]["max_abs_err"] for key in keys)
            timed_on = cgs[on]["krylov_cg_step" if name == "krylov" else name]
        elif name in SHARDED_CHECKS:
            checks, (on, key) = SHARDED_CHECKS[name]
            errs = tuple(shard_sets[s][k]["max_abs_err"] for s, k in checks)
            timed_on = shard_sets[on][key]
        elif name in FACTOR_CHECKS:
            checks, on = FACTOR_CHECKS[name]
            errs = tuple(factor[c.split(":")[0]]["checks"][c.split(":")[1] if ":" in c else name]
                         ["max_abs_err"] for c in checks)
            timed_on = factor[on]["checks"][name]
        elif name in {**SCENARIO_CHECKS, **DENSE_SCENARIO_CHECKS, **LATTICE_SCENARIO_CHECKS,
                      **TREE_SCENARIO_CHECKS}:
            errs = tuple(rec[name]["max_abs_err"] for rec in sweep_sets.values() if name in rec)
            timed_on = sweep_sets[{**SCENARIO_CHECKS, **DENSE_SCENARIO_CHECKS,
                                   **LATTICE_SCENARIO_CHECKS, **TREE_SCENARIO_CHECKS}[name]][name]
        elif name in ADJOINT_CHECKS:
            errs = tuple(rec[name]["max_abs_err"] for rec in adjoint["sets"].values())
            timed_on = adjoint["sets"]["headline"][name]
        elif name in GENERIC_CHECKS:
            checks = GENERIC_CHECKS[name]
            errs = tuple(gen_sets[on][key]["max_abs_err"] for on, key in checks)
            timed_on = gen_sets[checks[0][0]][checks[0][1]]
        else:
            errs = tuple(cyc[c][key]["max_abs_err"] for c in "abcdef"
                         for key in (name, name + "_unrefined") if key in cyc[c]) + lattice_errs
            errs += tuple(rec[key]["max_abs_err"] for rec in core.values()
                          for key in (name, name + "_unrefined") if key in rec)
            if name == "dense_core":
                errs += tuple(rec["max_abs_err"] for rec in k11.values())
            timed_on = timed_cyclic[name] if name in timed_cyclic else cyc["a"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(r[name] for r in runs),
            "max_abs_err": max(errs),
            "ms": timed_on["ms"], "plain_ms": timed_on["plain_ms"],
            "bound_ms": timed_on["bound_ms"], "bound_by": timed_on["bound_by"],
            "library_ms": timed_on.get("library_ms"),
        })
    assert len(kernels) == 72 and all(kr["launches"] > 0 for kr in kernels), kernels
    print(json.dumps({"kernels": kernels}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
