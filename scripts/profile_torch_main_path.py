"""Where the time of the port's main paths goes, on one GPU.

Builds one configuration of ``chip_smoke.py`` (``--path``):

* ``blocked`` — the benchmark configuration (16-generation arterial tree,
  N = 40, Poiseuille R, p_bc = y; 5,341,102 dofs), blocked route;
* ``callable`` — the same tree with callable R and f (5,341,102 dofs),
  general level route;
* ``forest`` — the 100,001-vessel irregular forest, N = 8, flux degree 2
  (2,563,442 dofs), general level route;
* ``web`` — the 100,000-site web with anastomoses, N = 8, flux degree 2
  (2,817,749 dofs), cyclic route: 18 peel rounds, multifrontal core;
* ``web1000`` — the same web at 1,000 sites, cyclic route: 11 peel rounds
  and a 455-node dense core (K11);
* ``bed`` — the perfusion bed ``make_vascular_bed(5, 96, 64)``, N = 2
  (67,476 dofs), cyclic route: multifrontal core;
* ``lattice`` — the 512² capillary lattice ``make_grid(512, 512)``, N = 1,
  R = 1, f = 0, p_bc = y (1,831,942 dofs), the separable-DCT solve on the
  grid route;
* ``lattice-callable`` — the same lattice with f = x + 0.3·y, the general
  DCT route;
* ``web2k`` — the reference's mid-size web ``make_random_network(2000,
  keep=0.7, num_boundary=8, seed=5)``, N = 1, per-edge R (16,367 dofs),
  cyclic route: a 1,994-node core in 7 min-degree rounds (K12a) and a
  628-node dense tail (K11);
* ``lattice64`` — ``make_grid(64, 64)``, N = 1, R = 1, f = 0, p_bc = y
  (28,294 dofs), cyclic route under ``auto``: a 4,096-node dense core (K11);
* ``fronts128`` — the 128² lattice with per-edge R under the reference's
  nested-dissection plan with forced supernodal fronts (1,024 + 216 and 942
  wide), the tree executor the reference's tests force plans into: K12b;
* ``cg512`` — the 512² lattice with per-edge R (1,831,942 dofs) under
  ``schur_method="cg"``: CG with the 2-D aggregation multigrid (K19a, K18,
  K19c);
* ``web-cg`` — the 100,000-site web (2,817,749 dofs) under
  ``schur_method="cg"``: Chebyshev-Jacobi CG on the gather-fold matvec
  (K19a, K19b);
* ``skinny-mg`` — ``make_grid(3, 2000)``, N = 1, per-edge R from seed 4,
  p_bc = y (35,997 dofs) under ``cg_precond="mg"``: CG with the 1-D pairing
  multigrid (K19a, K18, K19d, K19c's coarsest solve);
* ``p1tree`` — the benchmark tree with continuous pressure (flux degree 2,
  pressure degree 1; 7,962,503 dofs): the reduced ``schur_p`` solve (K21a,
  K20b, K19a; K20 once, building J and Jᵀ);
* ``minres`` — ``make_arterial_tree(8)``, N = 4, flux degree 1 (2,422
  dofs) under ``method="minres"``, rtol 1e-12: assemble (K20) and MINRES
  (K19e on K20b, K19a's Jacobi);
* ``dense`` — ``make_arterial_tree(8)``, N = 10, flux degree 2, pressure
  degree 1 (8,033 dofs) under ``method="dense"``: assemble (K20), the
  dense matrix, K21b's factor and solve, the residual gate;
* ``sharded-tree``, ``sharded-forest``, ``sharded-lattice``, ``sharded-web``
  — the ``blocked``, ``forest``, ``lattice`` and ``web`` configurations
  through ``parallel.ShardedNetworkSolver`` on 8, 8, 8 and 4 shards of the
  card: the blocked route (K1, K2–K4 split, K22a, K22-reduce, the T solve,
  K5), the distributed tree elimination (K8a, K22c, K8b), the lattice
  strips (K1, K22b, K16, K17, K5) and the general route's replicated tree
  solve (K8a, K22d, K9–K15, K8b);
* ``factor-headline``, ``factor-lattice``, ``factor-forest``, ``factor-web``,
  ``factor-web1000``, ``factor-web2k``, ``factor-fronts128`` — factor reuse
  on the ``blocked``, ``lattice``, ``forest``, ``web``, ``web1000``,
  ``web2k`` (a min-degree core: K12a's factor and apply, K11's on its
  dense tail) and ``fronts128`` (the forced fronts plan through
  ``build_tree_factorization``: K12a as a cooperative grid, K12b; its
  rhs-only loop the class's solve and flatten) configurations
  (:func:`factor_profile`):
  ``Solver.factorize()``, then the factor, the apply (its rhs resident), a
  rhs-only solve (its rhs uploaded) and the fused executor on the same forms,
  each with its device µs and launches by kernel name and by CUDA source
  (``torch.profiler``) and its best host ms, and the rhs-only
  ``compute_forms`` + ``Solver.solve()`` loop factorized (one read-only R,
  and a new R array a call) and fused;

or, with ``--kernels``, times the redesigned kernels against their
library calls on the same inputs: K21b's factor and solve at n = 4,096
(``lu_factor``, ``lu_solve``) and on the ``dense`` saddle matrix, its
triangular solve on K11's factor of a 4,096-node Laplacian
(``solve_triangular``); K10 over the 100k web's 18 peel-round folds (18
``index_add_``); K12a's rounds on web2k; the executors of web2k, the 64²
lattice and the 1k web; K11 at 455 and 4,096 nodes, whole, its factor
(``dense_factor``) and the refined solve as their difference, with the
device time and launches of one call by kernel name (``torch.profiler``),
beside ``cholesky`` and ``cholesky_solve``; K12b on the 128² lattice's
forced fronts; K19c's coarsest factor and solve beside ``cholesky`` and
``cholesky_solve``; K22-reduce on 4 × 222,643 partials beside
``torch.sum``, bit-equality with its plain version, the host µs of a
synchronised call and of a call issued back to back (dispatch); and on the
512² lattice's grid route K16's solve (its refinement residuals fixed) and
one pass's four products beside 12 ``torch.matmul``, and K17's stencil
without and with its norm and its assembly beside CSR ``torch.mv``, each
with its device µs and launches by kernel name and its host and dispatch
µs (``--select lattice``: these alone); ``--select redesign`` times K6,
K19c, K21a, K18, K19a and K19e alone as their executors issue them
(:func:`redesign_times`; ``--select krylov``: K19a and K19e alone,
:func:`krylov_times`): the forest's three level sums and the web's
bifurcation system beside ``index_add_``, the 512² lattice's V-cycle with
its wrapper launches and its stencil beside CSR ``torch.mv``, the p1tree's
K21a solve and factor with their bounds and its executor, K18's normed and
plain residual on the 512² general route beside CSR ``torch.mv``, a
skinny-mg Chebyshev step and residual and its executor, 40 Jacobi CG
iterations of the p1tree (K19a's device µs and launches an iteration by
kernel name) and the minres solve (K19e's per solve, and its executor);
``--select mf`` times K13–K15 on the 100k web's multifrontal core
(:func:`mf_times`: the factor, the apply and the executor, split by level
or by group, the apply's error against SciPy's ``splu``, and the kernel
and plain paths' core and web solutions; ``--diff A.npz B.npz`` compares
two such runs, :func:`vector_diffs`); ``--select windows`` takes
``chip_smoke.py``'s launch-count cases in 20 profiler windows each
(:func:`window_probe`); ``--select mg1d`` times K19d's V-cycle and the
skinny-mg executor (:func:`mg1d_times`), ``--select dist`` K22c in the
sharded forest's executor (:func:`dist_times`), ``--select level`` K7 on
the forest and callable paths (:func:`level_times`) and ``--select gather``
K19b on web-cg (:func:`gather_times`), each with the λ for ``--diff``;
``--select fronts`` times the kernels on the tiled Cholesky header (K12b
on fronts128, K11 at 455 and 4,096 nodes, K19c's coarsest factor) split by
launch kind with each panel launch's µs (:func:`fronts_times`), and
``--select tsolve`` the T solve on the sharded forest's T and on a 7-node
one (:func:`tsolve_times`); ``--select blocked`` K2–K4 on the headline tree
and on each shard of the sharded tree (:func:`blocked_times`) and
``--select core`` K12a on web2k, fronts128 and web48's forced plans
(:func:`core_times`), each with the SHA-256 of λ; ``--select peel`` K9
on the 100k web, web1000 and the star (:func:`peel_times`: launch by
launch and, on a port with a peel table, at other cut widths, each with
the SHA-256 of λ); ``--select edge`` K8a on the callable tree, set (c)'s
k = 3 forest, set (b)'s 100k forest and the 512² lattice with callable f
(:func:`edge_times`: device µs, bound, the SHA-256 of the outputs and the
tile plan) and
``--select shards`` K22a on the sharded tree (:func:`shard_times`: a
solve's partials and λ alone with their launches, the executor, the
SHA-256 of the rows, λ, q and p); ``--select strips`` K22b and K1 on the
sharded lattice and its executor (:func:`strip_times`) and ``--select
condense`` K1 on the headline, the sharded tree's 8 shards and the sharded
lattice's 8 strips (:func:`condense_times`), each with its launches and
the SHA-256 of its outputs (and of λ, q, p).
``--root``
imports the port from another checkout (e.g. the parent commit unpacked
with ``git archive``), so that two versions are compared in one call.
Otherwise the script

1. times each phase of ``compute_forms`` + ``Solver.solve`` on the host
   clock, CUDA-synchronised at every phase boundary (best of ``--reps``);
2. traces ``--reps`` solves with ``torch.profiler`` and sums device time by
   kernel and copy, giving the device's busy and idle share of the solve
   and the device launches (kernels and copies) per solve, also summed by
   the CUDA source that defines each kernel.

Run from the repository root on a machine with a CUDA device::

    python3 scripts/profile_torch_main_path.py [--path blocked] [--generations 16] [--reps 5]
    python3 scripts/profile_torch_main_path.py --path factor-headline|factor-lattice|factor-forest|factor-web|factor-web1000|factor-web2k|factor-fronts128 [--out x.json]
    python3 scripts/profile_torch_main_path.py --kernels [--select lattice|redesign|krylov|mf|windows|mg1d|dist|level|gather|fronts|tsolve|blocked|core|peel|edge|shards|strips|condense] [--root DIR] [--out kernels.json]
    python3 scripts/profile_torch_main_path.py --diff parent.npz change.npz

(``--generations`` sets the depth of ``blocked``, ``callable`` and ``p1tree``.)

Prints one JSON object; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the port of this checkout, or with --root of another one; chip_smoke's
# configurations always from this checkout
sys.path.insert(0, str(pathlib.Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
                       if "--root" in sys.argv else ROOT))
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
sys.modules["chip_smoke"] = chip_smoke
_spec.loader.exec_module(chip_smoke)

import networks_fenicsx_tpu_torch as P  # noqa: E402
from networks_fenicsx_tpu_torch.ops import krylov as cg_loop  # noqa: E402
from networks_fenicsx_tpu_torch.solver import (  # noqa: E402
    _CgExecutor, _flatten_blocks_host, _generic_solve, _to_dense, build_schur_executor,
)

GENERIC_PATHS = ("p1tree", "minres", "dense")
SHARDED_PATHS = {"sharded-tree": 8, "sharded-forest": 8, "sharded-lattice": 8, "sharded-web": 4}
# factor reuse: the configuration each path factors, and chip_smoke's rhs-only forms for it
FACTOR_PATHS = {"factor-headline": ("blocked", "poiseuille"), "factor-lattice": ("lattice", "lattice"),
                "factor-forest": ("forest", "forest"), "factor-web": ("web", "forest"),
                "factor-web1000": ("web1000", "forest"), "factor-web2k": ("web2k", "forest"),
                "factor-fronts128": ("fronts128", "forest")}


def kernel_sources() -> dict[str, str]:
    """Each ``__global__`` kernel's name -> the ``kernels/csrc`` file that
    defines it (a header's kernels under the header's name: its includers
    share them; a name two files define under both, joined by " + ")."""
    csrc = pathlib.Path(P.__file__).resolve().parent / "kernels" / "csrc"
    out: dict[str, list[str]] = {}
    for path in sorted(csrc.glob("*.cu*")):
        for m in re.finditer(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s+)*(\w+)\s*\(",
                             path.read_text()):
            out.setdefault(m.group(1), []).append(path.name)
    return {name: " + ".join(files) for name, files in out.items()}


def sync_clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def configure(path: str, generations: int):
    """``(assembler, forms, options, tree plan or None)`` of a main path;
    ``forms(asm)`` recomputes its coefficient data, as a user changing them
    between solves would."""
    options, tree_plan = P.SolverOptions(), None
    if path in ("blocked", "sharded-tree"):
        net = P.network_generation.make_arterial_tree(generations, direction=[0.1, 1, 0],
                                                      arrays=True)
        mesh = P.NetworkMesh(net, N=40, color_strategy="fast")
        asm = P.HydraulicNetworkAssembler(mesh)
        R = 1.0 / mesh.edge_radius**4

        def forms(a):
            a.compute_forms(p_bc_ex=lambda x: x[1], R=R)
    elif path == "callable":
        asm = chip_smoke.callable_assembler(P, generations)
        forms = chip_smoke.callable_forms
    elif path in ("forest", "sharded-forest"):
        asm = chip_smoke.forest_assembler(P, chip_smoke.forest_mesh(P))
        forms = chip_smoke.forest_forms
    elif path in ("web", "sharded-web"):
        asm, forms = chip_smoke.web_assembler(P), chip_smoke.forest_forms
    elif path == "web1000":
        asm, forms = chip_smoke.web_assembler(P, sites=1_000), chip_smoke.forest_forms
    elif path in ("lattice", "sharded-lattice"):
        asm, forms = chip_smoke.lattice_assembler(P), chip_smoke.lattice_forms
    elif path == "lattice-callable":
        forms = chip_smoke.lattice_callable_forms
        asm = chip_smoke.lattice_assembler(P, forms=forms)
    elif path == "web2k":
        asm, forms = chip_smoke.web2k_assembler(P), chip_smoke.web2k_forms
    elif path == "lattice64":
        asm, forms = chip_smoke.lattice_assembler(P, 64, 64), chip_smoke.lattice_forms
    elif path == "fronts128":
        asm, forms = chip_smoke.grid128_assembler(P), chip_smoke.grid128_forms
        options = P.SolverOptions(schur_method="tree")
        tree_plan = chip_smoke.nd_tree_plan(P, asm, **chip_smoke.FRONTS_KWARGS)
    elif path == "cg512":
        forms = chip_smoke.cg512_forms
        asm, options = chip_smoke.lattice_assembler(P, forms=forms), P.SolverOptions(schur_method="cg")
    elif path == "web-cg":
        asm, forms = chip_smoke.web_assembler(P), chip_smoke.forest_forms
        options = P.SolverOptions(schur_method="cg")
    elif path == "p1tree":
        asm, forms = chip_smoke.p1tree_assembler(P, generations), chip_smoke.p1tree_forms
    elif path == "minres":
        asm, forms = chip_smoke.minres_assembler(P), chip_smoke.p1tree_forms
        options = P.SolverOptions(method="minres", rtol=1e-12)
    elif path == "dense":
        asm, forms = chip_smoke.p1tree_assembler(P, 8, 10), chip_smoke.p1tree_forms
        options = P.SolverOptions(method="dense")
    elif path == "skinny-mg":
        forms = chip_smoke.skinny_forms
        asm = chip_smoke.lattice_assembler(P, 3, 2000, forms=forms)
        options = P.SolverOptions(schur_method="cg", cg_precond="mg")
    else:
        asm, forms = chip_smoke.bed_assembler(P), chip_smoke.bed_forms
    forms(asm)
    return asm, forms, options, tree_plan


def phases(asm, solver, forms) -> dict[str, float]:
    """One compute_forms + solve, split at its phase boundaries (ms)."""
    ex = solver._executor
    t = [sync_clock()]
    forms(asm)
    t.append(sync_clock())
    args = ex.prepare_args(*asm.schur_arguments())
    t.append(sync_clock())
    uploaded = ex.upload(*args)
    t.append(sync_clock())
    out = ex(*args)  # uploads again: the executor's own call
    t.append(sync_clock())
    host = [out[0].cpu().numpy(), out[1].cpu().numpy(), out[2].cpu().numpy()]
    t.append(sync_clock())
    x = _flatten_blocks_host(*host, asm.network.edge_color,
                             edge_order=getattr(ex, "edge_order", None),
                             bif_order=getattr(ex, "bif_order", None))
    t.append(sync_clock())
    solver._scatter_functions(None, x)
    t.append(sync_clock())
    del uploaded
    names = ["compute_forms", "prepare_args", "upload", "executor (upload + kernels)",
             "device_to_host", "flatten", "scatter"]
    return {n: (b - a) * 1e3 for n, a, b in zip(names, t[:-1], t[1:])}


def dense_phases(asm, solver, forms) -> dict[str, float]:
    """One compute_forms + solve of ``dense`` (``_generic_solve``'s dense
    branch step by step), split at its phase boundaries (ms)."""
    from networks_fenicsx_tpu_torch.kernels import dense_lu

    t = [sync_clock()]
    forms(asm)
    t.append(sync_clock())
    solver.assemble()
    t.append(sync_clock())
    Ad = _to_dense(solver.A)
    t.append(sync_clock())
    LU, piv = dense_lu.lu_factor(Ad)
    t.append(sync_clock())
    x = dense_lu.lu_solve(LU, piv, solver.b)
    t.append(sync_clock())
    float(torch.linalg.norm(Ad @ x - solver.b))
    x = x.cpu().numpy()
    t.append(sync_clock())
    solver._scatter_functions(None, x)
    t.append(sync_clock())
    names = ["compute_forms", "assemble (values upload, K20 fold, b)", "dense matrix",
             "K21b factor", "K21b solve", "residual gate + copy to host", "scatter"]
    return {n: (b - a) * 1e3 for n, a, b in zip(names, t[:-1], t[1:])}


def generic_phases(asm, solver, forms, path: str) -> dict[str, float]:
    """One compute_forms + solve of ``p1tree``, ``minres`` or ``dense``,
    split at its phase boundaries (ms)."""
    if path == "dense":
        return dense_phases(asm, solver, forms)
    t = [sync_clock()]
    forms(asm)
    t.append(sync_clock())
    if path == "p1tree":
        x = solver._executor()[0]
        t.append(sync_clock())
        x = x.cpu().numpy()
        names = ["compute_forms", "executor (factor, b upload, CG, flux)", "device_to_host"]
    else:
        solver.assemble()
        t.append(sync_clock())
        x, _ = _generic_solve(solver.A, solver.b, asm, "minres", solver._options)
        names = ["compute_forms", "assemble (values upload, K20 fold, b)",
                 "minres (with the copy to the host)"]
    t.append(sync_clock())
    solver._scatter_functions(None, x)
    t.append(sync_clock())
    names.append("scatter")
    return {n: (b - a) * 1e3 for n, a, b in zip(names, t[:-1], t[1:])}


def sharded_split(asm, solver, forms) -> dict[str, float]:
    """One compute_forms + assemble + solve of a sharded path, split at its
    phase boundaries (ms); the host's share of the solve (the shards'
    rows back to the public layout, the scatter) is the whole solve less
    the argument layout and the executor."""
    ex = solver._blocked_exec or solver._dist_exec or solver._pipeline
    t = [sync_clock()]
    forms(asm)
    t.append(sync_clock())
    solver.assemble()
    t.append(sync_clock())
    args = ex.prepare_args(*solver._coeff_args)
    t.append(sync_clock())
    ex(args)
    t.append(sync_clock())
    solver.solve()
    t.append(sync_clock())
    names = ["compute_forms", "assemble (snapshot)", "prepare_args (per-shard rows, upload)",
             "executor (shards, reduce, replicated solve)", "solve (whole)"]
    out = {n: (b - a) * 1e3 for n, a, b in zip(names, t[:-1], t[1:])}
    out["host rest of the solve"] = out["solve (whole)"] - out[names[2]] - out[names[3]]
    return out


def solve_once(solver, path: str) -> None:
    """What a user runs after compute_forms: the generic methods assemble again."""
    if path in ("minres", "dense"):
        solver.assemble()
    solver.solve()


def best_ms(fn, reps: int = 20) -> float:
    """Best host-clock ms of ``fn`` over ``reps`` CUDA-synchronised calls."""
    fn()
    times = []
    for _ in range(reps):
        t0 = sync_clock()
        fn()
        times.append((sync_clock() - t0) * 1e3)
    return min(times)


def dispatch_us(fn, calls: int = 500, reps: int = 5) -> float:
    """Best host-clock µs a call of ``fn`` over ``calls`` calls issued back to
    back without a synchronisation (the host's dispatch cost, once the
    device keeps up), of ``reps`` runs."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def kernel_times(card: str) -> dict:
    """``--kernels``: K21b, K10, K12a, the three executors, K11, K12b, K19c's
    coarsest level and K22-reduce beside their library calls (see the
    module docstring), on the port that ``sys.path`` finds first."""
    from networks_fenicsx_tpu_torch.kernels import dense_core, dense_lu, fold

    dev = torch.device("cuda", 0)
    ms = chip_smoke.cuda_ms
    out = {"card": card, "port": str(pathlib.Path(P.__file__).resolve().parent)}

    def lu(A, b, reps_f: int = 5):
        LU, piv = dense_lu.lu_factor(A)
        LU_l, piv_l = torch.linalg.lu_factor(A)
        return {"n": A.shape[0], "factor_ms": ms(lambda: dense_lu.lu_factor(A), reps=reps_f),
                "solve_ms": ms(lambda: dense_lu.lu_solve(LU, piv, b)),
                "library_factor_ms": ms(lambda: torch.linalg.lu_factor(A), reps=reps_f),
                "library_solve_ms": ms(lambda: torch.linalg.lu_solve(LU_l, piv_l, b[:, None]))}

    gen = torch.Generator(device=dev).manual_seed(4)
    n = chip_smoke.LU_N
    A = torch.randn((n, n), generator=gen, dtype=torch.float64, device=dev)
    A += n * torch.eye(n, dtype=torch.float64, device=dev)
    b = torch.randn(n, generator=gen, dtype=torch.float64, device=dev)
    out["k21b_random"] = lu(A, b, reps_f=3)
    S, bs = chip_smoke.p1tree_assembler(P, 8, 10).assemble(kind="dense", device=dev)
    out["k21b_saddle"] = lu(S, bs, reps_f=2)
    del A, S
    ci, cj, pid, dc, rc, w = chip_smoke.spd_laplacian(chip_smoke.K11_TIMED, dev,
                                                      seed=chip_smoke.K11_TIMED)
    _, s_, C = dense_core.dense_factor(ci, cj, pid, dc, w)
    y, Cl = (rc / s_).contiguous(), torch.tril(C)
    out["k21b_trsv"] = {"n": chip_smoke.K11_TIMED, "ms": ms(lambda: dense_lu.trsv(C, y, lower=True)),
                        "library_ms": ms(lambda: torch.linalg.solve_triangular(Cl, y[:, None],
                                                                               upper=False))}

    asm = chip_smoke.web_assembler(P)
    ex = build_schur_executor(asm, P.SolverOptions(), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    folds, adds = [], []
    for rd in ex.device_plan.rounds:
        if not rd.fold:
            continue
        v = torch.randn((rd.size, 2), generator=gen, dtype=torch.float64, device=dev)
        folds.append((rd.fold, v))
        ok = rd.parents >= 0
        adds.append((torch.zeros((rd.upar.shape[0], 2), dtype=torch.float64, device=dev),
                     torch.searchsorted(rd.upar, rd.parents[ok]), v[ok]))
    before = fold.fold_apply.launches
    got = [fold.fold_apply(v, lv) for lv, v in folds]
    want = [fold.fold_apply_plain(v, lv) for lv, v in folds]
    out["k10_web"] = {
        "folds": len(folds), "launches": fold.fold_apply.launches - before,
        "equal": all(torch.equal(a, b_) for a, b_ in zip(got, want)),
        "ms": ms(lambda: [fold.fold_apply(v, lv) for lv, v in folds]),
        "library_ms": ms(lambda: [o.index_add_(0, seg, src) for o, seg, src in adds]),
        "wrapper_us_per_fold": best_ms(lambda: [fold.fold_apply(v, lv) for lv, v in folds])
        * 1e3 / len(folds)}
    del asm, ex, folds, adds, got, want

    asm = chip_smoke.web2k_assembler(P)
    core = chip_smoke.compare_core_kernels(P, asm, dev, timed=True)["core_elim"]
    out["k12a_web2k"] = {"ms": core["ms"], "plain_ms": core["plain_ms"]}
    for key, asm in (("web2k", asm), ("lattice64", chip_smoke.lattice_assembler(P, 64, 64)),
                     ("web1000", chip_smoke.web_assembler(P, sites=1_000))):
        solver = P.Solver(asm, device="cuda")
        solver.solve()
        ex = solver._executor
        args = ex.prepare_args(*asm.schur_arguments())
        out[f"{key}_executor_ms"] = best_ms(lambda: ex(*args))
    del asm, solver, ex, args

    for n in (455, chip_smoke.K11_TIMED):
        out[f"k11_{n}"] = k11_times(n, dev)
    grid = chip_smoke.grid128_assembler(P)
    plan_i = chip_smoke.nd_tree_plan(P, grid, **chip_smoke.FRONTS_KWARGS)
    fronts = chip_smoke.compare_core_kernels(P, grid, dev, timed=True, tree_plan=plan_i,
                                             expect=chip_smoke.GRID128_FRONTS_SIZES)["core_fronts"]
    out["k12b_fronts128"] = {k: fronts[k] for k in ("ms", "plain_ms", "bound_ms")}
    del grid, plan_i
    out.update(coarsest_times(dev))
    out["k22_reduce"] = reduce_times(dev)
    out.update(lattice_times(dev))
    return out


def timed_call(fn, reps: int = 20) -> dict:
    """``fn``'s ms (CUDA events), host µs of a synchronised call and of a call
    issued back to back (dispatch), device µs and launches of one call by
    kernel name (the profiler)."""
    split = device_split(fn)
    return {"ms": chip_smoke.cuda_ms(fn, reps=reps), "wrapper_us": best_ms(fn) * 1e3,
            "dispatch_us": dispatch_us(fn, calls=100 if reps < 20 else 500),
            "device_us": sum(us for us, _ in split.values()),
            "device_launches": sum(c for _, c in split.values()),
            "device_us_by_kernel": split}


def cg512_system(dev):
    """The 512² per-edge-R lattice's λ system under ``schur_method="cg"``
    (chip_smoke's set (l)): ``(mg2d plan, class weights, diag, rhs)``."""
    asm = chip_smoke.lattice_assembler(P, forms=chip_smoke.cg512_forms)
    ex, diag, rhs, _, cw = chip_smoke.cg_system(P, asm, dev, P.SolverOptions(schur_method="cg"))
    return ex.precond_plan, cw, diag, rhs


def coarsest_times(dev) -> dict:
    """K19c's coarsest factor and solve on the 512² lattice's 16² bottom
    level beside ``cholesky`` and ``cholesky_solve``."""
    from networks_fenicsx_tpu_torch.kernels import mg2d
    from networks_fenicsx_tpu_torch.multigrid import Mg2dPreconditioner

    plan, cw, diag, _ = cg512_system(dev)
    pre = Mg2dPreconditioner(plan, cw, diag, plain=True)
    coarse = (plan.bottom_offsets, pre.bottom[:4], pre.bottom[mg2d.FD])
    Lc, factor = mg2d._banded(*coarse), pre.factor
    gen = torch.Generator(device=dev).manual_seed(3)
    rb = torch.randn(pre.bottom.shape[1], generator=gen, dtype=torch.float64, device=dev)
    A = mg2d.coarse_factor(*coarse)
    ms = chip_smoke.cuda_ms
    return {"k19c_coarse_factor": {"ms": ms(lambda: mg2d.coarse_factor(*coarse)),
                                   "plain_ms": ms(lambda: mg2d.coarse_factor_plain(*coarse), reps=3),
                                   "library_ms": ms(lambda: torch.linalg.cholesky(Lc))},
            "k19c_coarse_solve": {"ms": ms(lambda: mg2d.coarse_solve(A, rb)),
                                  "plain_ms": ms(lambda: mg2d.coarse_solve_plain(factor, rb), reps=3),
                                  "library_ms": ms(lambda: torch.cholesky_solve(rb[:, None], factor))}}


def redesign_times(dev) -> dict:
    """``--select redesign``: the redesigned kernels as their executors
    issue them, on the port that ``sys.path`` finds first (this checkout's,
    or ``--root``'s):

    * K6 — the level route's three sums on the 100k forest (one
      ``segsum_plan``) beside 3 ``index_add_``, and the bifurcation system's
      two sides on the 100k web (one launch into ``dr``) beside 2
      ``index_add_``;
    * K19c — one V-cycle application of the 512² lattice's preconditioner
      with its K19c and K19a wrapper launches, and the level-0 stencil
      beside CSR ``torch.mv``;
    * K21a — :func:`k21a_times`; K18 — :func:`k18_times`;

    each with :func:`timed_call`'s figures."""
    from networks_fenicsx_tpu_torch.kernels import krylov, mg2d, segsum
    from networks_fenicsx_tpu_torch.multigrid import Mg2dPreconditioner

    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}

    def index_adds(pairs):
        adds = []
        for i, v, bins, rows in pairs:
            ok = (i >= 0) & (i < v.shape[0])
            seg = torch.arange(i.shape[0], device=dev)[:, None].expand_as(i)[ok]
            if bins is not None:
                seg = bins.long()[seg]
            adds.append((torch.zeros((rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev),
                         seg, v[i[ok].long()]))
        return lambda: [o.index_add_(0, sg, src) for o, sg, src in adds]

    forest = P.Solver(chip_smoke.forest_assembler(P, chip_smoke.forest_mesh(P)), device="cuda")
    forest.solve()
    dlp = forest._executor.device_plan
    E = dlp.num_edges
    w = torch.rand(E, generator=gen, dtype=torch.float64, device=dev)
    vt, vs = (torch.rand((E, 2), generator=gen, dtype=torch.float64, device=dev) for _ in range(2))
    out["k6_level_forest"] = timed_call(lambda: segsum.segsum_plan(dlp.sums, w, vt, vs))
    out["k6_level_forest"]["library_3_index_add"] = timed_call(index_adds(
        [(dlp.p_idx, w, None, dlp.p_idx.shape[0]), (dlp.t_idx, vt, None, dlp.t_idx.shape[0]),
         (dlp.s_idx, vs, None, dlp.s_idx.shape[0])]))
    del forest

    web = P.Solver(chip_smoke.web_assembler(P), device="cuda")
    web.solve()
    dtp = web._executor.device_plan
    Ew, B = dtp.num_edges, dtp.num_bifurcations
    ut, us_ = (torch.rand((Ew, 2), generator=gen, dtype=torch.float64, device=dev) for _ in range(2))
    out["k6_lambda_web"] = timed_call(lambda: segsum.segsum_plan(dtp.lambda_sums, ut, us_))
    out["k6_lambda_web"]["library_2_index_add"] = timed_call(index_adds(
        [(dtp.t_idx, ut, dtp.t_bins, B), (dtp.s_idx, us_, dtp.s_bins, B)]))
    del web, dtp

    plan, cw, diag, rhs = cg512_system(dev)
    pre = Mg2dPreconditioner(plan, cw, diag)
    r = torch.randn(diag.shape[0], generator=gen, dtype=torch.float64, device=dev)
    before = (mg2d.LAUNCHES.launches, krylov.LAUNCHES.launches)
    pre(r)
    launches = {"mg2d": mg2d.LAUNCHES.launches - before[0],
                "krylov": krylov.LAUNCHES.launches - before[1]}  # of one application
    vcycle = timed_call(lambda: pre(r), reps=10)
    vcycle["wrapper_launches"] = launches
    out["k19c_vcycle_cg512"] = vcycle
    lev, shape = pre.levels[0], plan.shapes[0]
    L = chip_smoke.lattice_csr(np.array([1, -1, shape[1], -shape[1]]), lev[:4], lev[mg2d.FD])
    out["k19c_stencil_cg512"] = timed_call(lambda: mg2d.stencil(lev, shape, r, rhs))
    out["k19c_stencil_cg512"]["library_csr_mv"] = timed_call(lambda: torch.mv(L, r))
    del pre, L
    out.update(k21a_times(dev))
    out.update(k18_times(dev))
    out.update(krylov_times(dev))
    return out


def launch_list(fn) -> list:
    """``[(kernel name, device µs), ...]``: each device launch of one ``fn()``
    call in issue order (``torch.profiler``, after one warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            out.append((ev.time_range.start, (name.split("::")[-1].split() or [""])[-1],
                        ev.time_range.elapsed_us()))
    return [(name, us) for _, name, us in sorted(out)]


def group_classes(plan) -> list:
    """Each multifrontal group's class: ``wide`` (a front wider than 160),
    else ``leaf`` (it consumes no group), ``few`` (1–3 fronts) or ``other``;
    and its dependency level (0 for a leaf group, else 1 + the highest level
    it consumes)."""
    level, out = [], []
    for g in plan.groups:
        level.append(1 + max((level[cg] for cg, _, _ in g.consume), default=-1))
        cls = ("wide" if g.w + g.b > 160 else "leaf" if not g.consume
               else "few" if g.k <= 3 else "other")
        out.append((cls, level[-1]))
    return out


def per_group_split(events: list, names: tuple, G: int, order) -> dict | None:
    """Device µs of the launches named ``names`` keyed by group, the
    ``i``-th such launch being group ``order(i)``; None unless their count
    is a multiple of G (a launch per group and pass)."""
    mine = [us for name, us in events if name in names]
    if not mine or len(mine) % G:
        return None
    acc = [0.0] * G
    for i, us in enumerate(mine):
        acc[order(i)] += us
    return acc


def level_split(what: str, events: list, schedule) -> dict:
    """Device µs and launches of a level-scheduled factor or apply by level:
    the factor's front launches are, level by level, one of the wide fronts
    and one of the rest where the level has them; the
    apply's i-th forward launch is level i mod L, its i-th backward launch
    level L − 1 − i mod L."""
    L = schedule.n_levels
    out = {}

    def add(key, us):
        acc = out.setdefault(key, [0.0, 0])
        acc[0] += us
        acc[1] += 1

    if what == "factor":
        labels = [f"L{lv}:{kind}" for lv, row in enumerate(schedule.levels)
                  for kind, n in (("wide", row[1]), ("narrow", row[2] - row[1])) if n]
        mine = [(name, us) for name, us in events if name in ("mf_front_kernel", "mf_wide_kernel")]
        for label, (_, us) in zip(labels, mine):
            add(label, us)
    else:
        for name, order in (("mf_forward_kernel", lambda i: i % L),
                            ("mf_backward_kernel", lambda i: L - 1 - i % L)):
            mine = [us for n, us in events if n == name]
            for i, us in enumerate(mine):
                add(f"L{order(i)}:{name.split('_')[1]}", us)
    return out


FRONT_KINDS = {"tc_panel_kernel": "panel", "tc_trailing_kernel": "trailing",
               "tc_invert_kernel": "inverse", "ts_lower_kernel": "solve", "ts_upper_kernel": "solve",
               "front_init_kernel": "assembly", "front_slots_kernel": "assembly",
               "front_consume_kernel": "assembly", "fold_kernel": "slots (K10)",
               "front_push_kernel": "sweeps", "front_pull_kernel": "sweeps",
               "tc_gather_kernel": "sweeps", "tc_scatter_kernel": "sweeps",
               "tc_gate_kernel": "gate", "nan_gate_kernel": "gate",
               "tiled_init_kernel": "assembly", "tiled_pairs_kernel": "assembly",
               "tiled_residual_kernel": "refinement", "tiled_update_kernel": "refinement"}


def launch_spans(fn) -> dict:
    """One ``fn()`` call's device launches (``torch.profiler``, after one
    warm-up call): device µs and launches by kind (:data:`FRONT_KINDS`, a
    kernel of another name under its own name), the µs of each panel launch
    in issue order and the gaps between them, the span from the first
    launch's start to the last one's end, and the union of the launches'
    intervals (the launches of two streams overlap, so their sum may exceed
    it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.name.startswith("Memcpy"):
            name = ev.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            evs.append((ev.time_range.start, ev.time_range.end,
                        (name.split("::")[-1].split() or [""])[-1]))
    evs.sort()
    kinds = {}
    for t0, t1, name in evs:
        acc = kinds.setdefault(FRONT_KINDS.get(name, name), [0.0, 0])
        acc[0] += t1 - t0
        acc[1] += 1
    panels = [(t0, t1) for t0, t1, name in evs if name == "tc_panel_kernel"]
    busy, end = 0.0, None  # the union of the launches' intervals
    for t0, t1, _ in evs:
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return {"span_us": (max(e[1] for e in evs) - evs[0][0]) if evs else 0.0,
            "sum_us": sum(e[1] - e[0] for e in evs), "busy_us": busy, "launches": len(evs),
            "by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1][0])),
            "panel_us": [t1 - t0 for t0, t1 in panels],
            "panel_gap_us": [b0 - a1 for (_, a1), (b0, _) in zip(panels, panels[1:])],
            "trailing_us": [t1 - t0 for t0, t1, name in evs if name == "tc_trailing_kernel"]}


def fronts_times(dev) -> dict:
    """``--select fronts``: the kernels on ``tiled_cholesky.cuh``, on the
    port that ``sys.path`` finds first (either port's interface): K12b on the
    128² lattice's forced fronts (1,024 + 216 and 942 wide; chip_smoke's set
    (i)) as the tree executor hands them their inputs, K11 at 455 and 4,096
    nodes and K19c's coarsest factor on the 512² lattice's bottom level, each
    with CUDA events' ms, its plain version's, the device µs by launch kind
    and each panel launch's µs (:func:`launch_spans`), and K12b's and K11's
    results against their plain versions."""
    from networks_fenicsx_tpu_torch.kernels import core_fronts, dense_core, mg2d
    from networks_fenicsx_tpu_torch.multigrid import Mg2dPreconditioner

    ms = chip_smoke.cuda_ms
    out = {}
    grid = chip_smoke.grid128_assembler(P)
    plan_i = chip_smoke.nd_tree_plan(P, grid, **chip_smoke.FRONTS_KWARGS)
    inp = chip_smoke.core_inputs(P, grid, dev, plan_i)
    dcp, d, ustream, w_pairs, r_fw = (inp["dcp"], inp["st"].d, inp["st"].ustream, inp["w_pairs"],
                                      inp["r_fw"])

    def k12b():
        return core_fronts.core_fronts(dcp, d, ustream[:-1], w_pairs, r_fw.clone())

    lam, want = k12b(), core_fronts.core_fronts_plain(dcp, d, ustream, w_pairs, r_fw)
    rec = {"fronts": [(fr.w, fr.b) for fr in dcp.fronts], "ms": ms(k12b, reps=10),
           "plain_ms": ms(lambda: core_fronts.core_fronts_plain(dcp, d, ustream, w_pairs, r_fw), reps=3),
           "cuda_launches": core_fronts.cuda_launches(dcp),
           "vs_plain": float((lam - want).abs().max()) / max(1.0, float(want.abs().max())),
           "lambda_sha256": _digest(lam)}
    rec.update(launch_spans(k12b))
    out["k12b_fronts128"] = rec
    del grid, plan_i, inp
    for n in (455, chip_smoke.K11_TIMED):
        args = chip_smoke.spd_laplacian(n, dev, seed=n)
        x, xp = dense_core.dense_core(*args), dense_core.dense_core_plain(*args)
        rec = {"ms": ms(lambda: dense_core.dense_core(*args), reps=10),
               "factor_ms": ms(lambda: dense_core.dense_factor(*args[:4], args[5]), reps=10),
               "cuda_launches": dense_core.cuda_launches(n, int(args[0].shape[0])),
               "vs_plain": float((x - xp).abs().max()) / max(1.0, float(xp.abs().max())),
               "backward_error": chip_smoke.factor_backward_error(args)}
        rec.update(launch_spans(lambda: dense_core.dense_core(*args)))
        rec["factor"] = launch_spans(lambda: dense_core.dense_factor(*args[:4], args[5]))
        out[f"k11_{n}"] = rec
    plan, cw, diag, _ = cg512_system(dev)
    pre = Mg2dPreconditioner(plan, cw, diag, plain=True)
    coarse = (plan.bottom_offsets, pre.bottom[:4], pre.bottom[mg2d.FD])
    Lc = mg2d._banded(*coarse)
    rec = {"n": int(Lc.shape[0]), "ms": ms(lambda: mg2d.coarse_factor(*coarse)),
           "plain_ms": ms(lambda: mg2d.coarse_factor_plain(*coarse), reps=3),
           "library_ms": ms(lambda: torch.linalg.cholesky(Lc))}
    rec.update(launch_spans(lambda: mg2d.coarse_factor(*coarse)))
    out["k19c_coarse_factor"] = rec
    return out


def tsolve_times(dev) -> dict:
    """``--select tsolve``: the T solve on the port that ``sys.path`` finds
    first (either port's interface): on the sharded forest's T (the 100k
    forest over 8 shards of the card, Tn = 1,128; the inputs its executor
    reduces) and on a 7-node binary T (the sharded tree's shape, Tn = 7,
    with the norm), each with :func:`timed_call`'s figures, λ_T's SHA-256
    and its error against a dense Cholesky solve (relative to max |λ|);
    where the port's ``t_forest`` takes ``rounds``, also on T's own levels
    (no compression round)."""
    import inspect

    from networks_fenicsx_tpu_torch.kernels import shard_top
    from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

    asm = chip_smoke.forest_assembler(P, chip_smoke.forest_mesh(P))
    solver = ShardedNetworkSolver(asm, devices=[dev] * chip_smoke.SHARD_FOREST["D"])
    solver.assemble()
    solver.solve()
    ex = solver._dist_exec
    args = ex.prepare_args(*solver._coeff_args)
    fw = ex.forward(0, args)
    tot = shard_top.reduce(ex.mesh.stack(list(fw.part)))
    Tn = ex.plan.Tn
    cases = {"forest": (ex.plan.T_parent, (tot[:Tn], tot[Tn : 2 * Tn], tot[2 * Tn : 3 * Tn]))}
    binary = np.array([-1, 0, 0, 1, 1, 2, 2])
    gen = torch.Generator(device=dev).manual_seed(7)
    wT = torch.rand(7, generator=gen, dtype=torch.float64, device=dev) + 0.5
    wT[0] = 0.0
    dT = wT + 1.0
    dT.index_add_(0, torch.as_tensor(binary[1:], device=dev), wT[1:])
    cases["tree7"] = (binary, (dT, torch.rand(7, generator=gen, dtype=torch.float64, device=dev) - 0.5,
                               wT, torch.tensor(0.25, dtype=torch.float64, device=dev)))
    takes_rounds = "rounds" in inspect.signature(shard_top.t_forest).parameters
    out = {}
    for name, (T_parent, targs) in cases.items():
        par = np.asarray(T_parent)
        LT = torch.diag(targs[0])
        kids = torch.as_tensor(np.flatnonzero(par >= 0), device=dev)
        pk = torch.as_tensor(par[par >= 0], device=dev)
        LT[kids, pk] -= targs[2][kids]
        LT[pk, kids] -= targs[2][kids]
        dense = torch.cholesky_solve(targs[1][:, None], torch.linalg.cholesky(LT))[:, 0]
        scale = max(1.0, float(dense.abs().max()))
        forests = {"plan": shard_top.t_forest(par, dev)}
        if takes_rounds:
            forests["levels"] = shard_top.t_forest(par, dev, rounds=0)
        for label, tf in forests.items():
            lam = shard_top.t_solve(tf, *targs)[0]
            rec = timed_call(lambda tf=tf: shard_top.t_solve(tf, *targs), reps=20)
            rec.update({"vs_dense": float((lam - dense).abs().max()) / scale,
                        "lambda_sha256": _digest(lam), "Tn": int(par.size),
                        "plain_ms": chip_smoke.cuda_ms(
                            lambda tf=tf: shard_top.t_solve_plain(tf, *targs), reps=3, warmup=1),
                        "library_ms": chip_smoke.cuda_ms(
                            lambda: torch.cholesky_solve(targs[1][:, None], torch.linalg.cholesky(LT)))})
            if hasattr(tf, "rounds"):
                rec["plan"] = {"levels": tf.depth, "rounds": [int(rd.segs.shape[0]) for rd in tf.rounds],
                               "left_levels": tf.n_lvl}
            out[f"{name}_{label}"] = rec
    return out


def _float_hex(t) -> str:
    return float(t).hex()


def blocked_times(dev) -> dict:
    """``--select blocked``: K2–K4 on the port that ``sys.path`` finds first
    (either port's interface), on the inputs their executors give them: the
    headline tree's sweep (16 generations, N = 40) and the sharded tree's
    halves on each of its 8 shards, each with :func:`timed_call`'s figures
    (the shards' summed), the SHA-256 of λ, d, r, wn, the norm (or Σ r²) as
    a hex float, and the sweep plan where the port has one."""
    from networks_fenicsx_tpu_torch.kernels import condense, shard_blocked, tree_sweep
    from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver
    from networks_fenicsx_tpu_torch.solver import build_schur_executor

    asm = chip_smoke.arterial_assembler(P, chip_smoke.GENERATIONS, chip_smoke.N_CELLS)
    ex = build_schur_executor(asm, P.SolverOptions(), device=dev)
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    dp, plan = ex.device_plan, ex.device_plan.plan
    Rm, fm, _ = asm.coefficient_modes()
    _, w, _, Ftot, const = condense.condense_plain(plan, asm.network.N, asm.flux_degree, ex._h_e, R, f,
                                                   Rm, fm, sp, ep)
    out = {}
    rec = timed_call(lambda: tree_sweep.tree_sweep(dp, w, const, Ftot), reps=50)
    lam, norm, d, r, wn = tree_sweep.tree_sweep(dp, w, const, Ftot)
    rec.update({"lambda_sha256": _digest(lam), "d_r_wn_sha256": _digest(d, r, wn),
                "rhs_norm": _float_hex(norm),
                "plain_ms": chip_smoke.cuda_ms(lambda: tree_sweep.tree_sweep_plain(plan, w, const, Ftot),
                                               reps=5)})
    if hasattr(dp, "sweep"):
        sw = dp.sweep
        rec["sweep_plan"] = {"cut": sw.cut, "top_nodes": sw.top_nodes, "blocks": sw.blocks,
                             "group": sw.group, "threads": sw.threads, "block_nodes": sw.block_nodes,
                             "cuda_launches": tree_sweep.cuda_launches(dp)}
    out["headline"] = rec

    solver = ShardedNetworkSolver(asm, devices=[dev] * chip_smoke.SHARD_TREE["D"])
    solver.assemble()
    solver.solve()
    bex = solver._blocked_exec
    lp = bex.local[dev]
    fws = [bex.forward(i, *a) for i, a in enumerate(bex.prepare_args(*solver._coeff_args))]
    ins = [(fw.w, fw.const, fw.Ftot) for fw in fws]
    lam_T = torch.full((bex.plan.Tn,), 0.25, dtype=torch.float64, device=dev)  # any λ_T: both ports
    lam0s = [shard_blocked.lam_ext(sh["tables"], fw.d, fw.r, fw.wn, lam_T) for sh, fw in zip(bex.shards, fws)]

    def forward_all():
        return [tree_sweep.tree_sweep_forward(lp, *a) for a in ins]

    def backward_all():
        return [tree_sweep.tree_sweep_backward(lp, fw.d, fw.r, fw.wn, l0.clone())
                for fw, l0 in zip(fws, lam0s)]

    halves = {}
    for key, fn in (("forward", forward_all), ("backward", backward_all)):
        rec = timed_call(fn, reps=20)
        res = fn()
        if key == "forward":
            rec["d_r_wn_sha256"] = _digest(*(t for d_, r_, wn_, _ in res for t in (d_, r_, wn_)))
            rec["rhs_sq"] = [_float_hex(q) for *_, q in res]
        else:
            rec["lambda_sha256"] = _digest(*res)
        halves[key] = rec
    if hasattr(lp, "sweep"):
        halves["sweep_plan"] = {"cut": lp.sweep.cut, "blocks": lp.sweep.blocks,
                                "launches_forward": tree_sweep.cuda_launches(lp, tree_sweep.FORWARD),
                                "launches_backward": tree_sweep.cuda_launches(lp, tree_sweep.BACKWARD)}
    out["sharded_tree_8_shards"] = halves
    return out


def core_times(dev) -> dict:
    """``--select core``: K12a on the port that ``sys.path`` finds first
    (either port's interface), on the inputs the tree executor gives the
    core: web2k (7 rounds, a 628-node tail), the 128² lattice's forced
    fronts (fronts128: 28 rounds) and the web48 golden's forced plans; on
    each the rounds alone (the tail and fronts left out) and the whole core
    solve with :func:`timed_call`'s figures, and the SHA-256 of λ_core; web2k's
    executor with its device µs by source."""
    import dataclasses

    from networks_fenicsx_tpu_torch.kernels import core_elim

    cases = {"web2k": (chip_smoke.web2k_assembler(P), None)}
    grid = chip_smoke.grid128_assembler(P)
    cases["fronts128"] = (grid, chip_smoke.nd_tree_plan(P, grid, **chip_smoke.FRONTS_KWARGS))
    web48 = chip_smoke.golden_web48(P)
    for key, plan in chip_smoke.forced_plans_web48(P, web48).items():
        cases[f"web48-{key}"] = (web48, plan)
    out = {}
    for name, (asm, tree_plan) in cases.items():
        inp = chip_smoke.core_inputs(P, asm, dev, tree_plan)
        dcp, dc, rc, w = inp["dcp"], inp["dc"], inp["rc"], inp["w_pairs"]
        rounds_only = dataclasses.replace(dcp, fronts=(), dense_nodes=dcp.dense_nodes[:0],
                                          dp_init=dcp.dp_init[:0])
        rec = {"rounds": len(dcp.rounds), "n_core": dcp.n_core,
               "tail": int(dcp.dense_nodes.shape[0]), "fronts": len(dcp.fronts)}
        timed = name in ("web2k", "fronts128")
        for key, plan_ in (("rounds", rounds_only), ("whole", dcp)):
            lam = core_elim.core_elim(plan_, dc, w, rc)
            part = {"lambda_sha256": _digest(lam)}
            if timed:
                part.update(timed_call(lambda plan_=plan_: core_elim.core_elim(plan_, dc, w, rc), reps=10))
            rec[key] = part
        if hasattr(core_elim, "launch_grid"):
            rec["launch_grid"] = core_elim.launch_grid(dcp, dev.index or 0)
        rec["cuda_launches"] = core_elim.cuda_launches(dcp)
        out[name] = rec
        if name == "web2k":
            solver = P.Solver(asm, device=dev)
            solver.solve()
            ex = solver._executor
            out["web2k_executor"] = _executor_record(ex, ex.prepare_args(*asm.schur_arguments()))
    return out


def peel_times(dev) -> dict:
    """``--select peel``: K9 on the port that ``sys.path`` finds first
    (either port's interface), on the inputs the tree executor gives it:
    the 100k web (18 rounds), web1000 (11) and the star of chip_smoke's set
    (f) (a fold of two levels).  Per case K9 around a Jacobi core (the
    ``chip_smoke.py`` timed call) with :func:`timed_call`'s figures, each
    launch's µs in issue order and the SHA-256 of λ; on a port with a peel table
    (``DeviceTreePlan.peel_table``) the same at cut widths 2,048 and 4,096
    (plans made anew)."""
    from networks_fenicsx_tpu_torch import tree
    from networks_fenicsx_tpu_torch.kernels import edge_data, peel, segsum

    cases = {"web": chip_smoke.web_assembler(P),
             "web1000": chip_smoke.web_assembler(P, sites=1_000)}
    if hasattr(chip_smoke, "star_assembler"):
        cases["star"] = chip_smoke.star_assembler(P)
    out = {}
    for name, asm in cases.items():
        ex = build_schur_executor(asm, P.SolverOptions(), device=dev)
        dtp = ex.device_plan
        R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
        Rm, fm, f_zero = asm.coefficient_modes()
        ed = edge_data.edge_data_plain(dtp, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi, R, f,
                                       Rm, fm, f_zero, sp, ep)
        dr, w_edges, _ = peel.lambda_system_plain(dtp, ed)
        w_pairs = segsum.segsum_plain(dtp.pair_idx, w_edges)
        rec = {"rounds": [rd.size for rd in dtp.rounds], "core": dtp.core_size}

        def jacobi(dc, rc):
            return rc / dc

        shapes = {"default": dtp}
        if hasattr(dtp, "peel_table"):
            for cut in (2048, 4096):
                saved, peel.CUT = peel.CUT, cut
                try:
                    shapes[f"cut{cut}"] = tree.device_tree_plan(dtp.plan, ex.lambda_plan, asm, dev)
                finally:
                    peel.CUT = saved
        for key, plan in shapes.items():
            def call(plan=plan):
                return peel.peel(plan, dr, w_pairs, jacobi)
            part = timed_call(call, reps=50)
            part["launch_list"] = launch_list(call)
            part["lambda_sha256"] = _digest(call())
            if hasattr(peel, "cuda_launches"):
                part["cuda_launches"] = peel.cuda_launches(plan)
            rec[key] = part
        out[name] = rec
    return out


def edge_times(dev) -> dict:
    """``--select edge``: K8a on the port that ``sys.path`` finds first
    (either port's interface), on the inputs each executor gives it: the
    callable tree (16 generations, N = 40, callable R and f, k = 1: the
    general layout), chip_smoke's set (c) (the 2k-site forest, N = 8,
    callable R and f, k = 3), set (b) (the 100k forest, N = 8, edge R, cell
    f, k = 2: the scalar_k layout) and the 512² lattice with callable f
    (N = 1, the scalar layout).  Per case :func:`timed_call`'s figures, the
    plain version's ms, the bytes bound, whether the outputs equal the
    plain version's (``torch.equal``), the SHA-256 of the outputs and the
    tile plan where the port has one; on the callable tree also the SHA-256
    of the solution of one solve."""
    from networks_fenicsx_tpu_torch.kernels import edge_data

    def set_c():
        asm = P.HydraulicNetworkAssembler(chip_smoke.forest_mesh(P, sites=2_000), flux_degree=3,
                                          pressure_degree=0)
        chip_smoke.callable_forms(asm)
        return asm

    cases = {"callable_tree": lambda: chip_smoke.callable_assembler(P),
             "set_c_k3": set_c,
             "forest_b_k2": lambda: chip_smoke.forest_assembler(P, chip_smoke.forest_mesh(P)),
             "lattice_callable": lambda: chip_smoke.lattice_assembler(
                 P, forms=chip_smoke.lattice_callable_forms)}
    out = {}
    for name, build in cases.items():
        asm = build()
        solver = P.Solver(asm, device="cuda")
        solver.solve()
        ex = solver._executor
        R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
        Rm, fm, f_zero = asm.coefficient_modes()
        e_args = (ex.device_plan, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi, R, f, Rm, fm,
                  f_zero, sp, ep)
        rec = timed_call(lambda: edge_data.edge_data(*e_args), reps=50)
        rec["plain_ms"] = chip_smoke.cuda_ms(lambda: edge_data.edge_data_plain(*e_args), reps=3)
        got, want = edge_data.edge_data(*e_args), edge_data.edge_data_plain(*e_args)
        arrays = [t for t in (got.mt, got.cumF, got.W, got.g, got.rh, got.ua, got.uF) if t is not None]
        arrays += list(got.interior)
        plain = [t for t in (want.mt, want.cumF, want.W, want.g, want.rh, want.ua, want.uF)
                 if t is not None] + list(want.interior)
        rec["equal_plain"] = all(torch.equal(a, b) for a, b in zip(arrays, plain))
        rec["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(arrays, plain))
        rec["outputs_sha256"] = _digest(*arrays)
        nq, C = ex._k + 1, asm.network.num_cells  # chip_smoke's count of K8a's work
        rec.update(chip_smoke.bound(chip_smoke.tensor_bytes(ex._h_e, ex._quad_w, ex._quad_phi, R, f,
                                                            sp, ep, arrays),
                                    (3 * nq * (ex._k + 1) ** 2 + 2 * nq + 10) * C))
        rec["sizes"] = {"edges": asm.network.num_edges, "N": ex._N, "k": ex._k, "modes": [Rm, fm]}
        if hasattr(edge_data, "edge_tile"):
            t = edge_data.edge_tile(asm.network.num_edges, ex._N, ex._k, ex._k + 1, (Rm, fm),
                                    edge_data.elides_source(edge_data.edge_layout(ex._k, Rm, fm),
                                                            f_zero))
            rec["tile"] = {"direct": t.rows == 0, "cells": t.cells, "rows": t.rows, "blocks": t.blocks,
                           "widths": t.widths, "smem": t.smem, "scratch": t.scratch}
        if name == "callable_tree":
            rec["solution_sha256"] = _digest(torch.as_tensor(solver.solution_vector()))
        out[name] = rec
        del asm, solver, ex, e_args, got, want
    return out


def host_split(fn, calls: int = 5, top: int = 25) -> list:
    """Host µs a call of ``fn`` by function (``cProfile``, cumulative, the
    ``top`` largest, over ``calls`` calls after a warm-up one)."""
    import cProfile
    import pstats

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][3])[:top]
    return [{"function": f"{pathlib.Path(file).name}:{line}({name})", "calls": nc / calls,
             "cum_us": ct / calls * 1e6} for (file, line, name), (_, nc, _, ct, _) in rows]


def shard_times(dev) -> dict:
    """``--select shards``: K22a on the sharded tree (the 16-generation tree,
    N = 40, over 8 shards of the card), on the port that ``sys.path`` finds
    first (either port's interface): a solve's K22a work alone (the
    partials and λ of the 8 shards: one launch each for every shard on a
    port with per-device groups, a launch each a shard otherwise) with
    :func:`timed_call`'s figures and the SHA-256 of the rows and λ; the
    executor's call with its device µs by source, its device launches, its
    host µs by function (:func:`host_split`) and the SHA-256 of λ, q and p; and compute_forms + assemble + solve (host
    clock, best of 5)."""
    from networks_fenicsx_tpu_torch.kernels import shard_blocked
    from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

    asm, forms, _, _ = configure("sharded-tree", chip_smoke.GENERATIONS)
    solver = ShardedNetworkSolver(asm, devices=[dev] * chip_smoke.SHARD_TREE["D"])
    solver.assemble()
    solver.solve()
    ex = solver._blocked_exec
    args = ex.prepare_args(*solver._coeff_args)
    fws = [ex.forward(i, *a) for i, a in enumerate(args)]
    lam_T = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, ex.plan.Tn), device=dev)
    if hasattr(ex, "groups"):
        def k22a():
            return [ex.partials(0, fws)], [ex.lam(0, fws, lam_T)]
    else:
        def k22a():
            return ([shard_blocked.partials(sh["tables"], fw.w, fw.const, fw.Ftot, fw.d, fw.r, fw.wn,
                                            fw.rhs_sq) for sh, fw in zip(ex.shards, fws)],
                    [shard_blocked.lam_ext(sh["tables"], fw.d, fw.r, fw.wn, lam_T)
                     for sh, fw in zip(ex.shards, fws)])
    rec = timed_call(k22a, reps=50)
    rows, lams = k22a()
    rec["rows_sha256"] = _digest(*(r.reshape(-1) for r in rows))
    rec["lambda_sha256"] = _digest(*(x.reshape(-1) for x in lams))
    if hasattr(shard_blocked, "cuda_launches"):
        rec["cuda_launches"] = shard_blocked.cuda_launches(ex.groups[0]["tables"])
    out = {"k22a": rec, "plan": {k: getattr(ex.plan, k) for k in chip_smoke.SHARD_TREE}}
    exe = timed_call(lambda: ex(args), reps=10)
    exe["device_by_source"] = by_source(exe["device_us_by_kernel"])
    exe["host_split"] = host_split(lambda: ex(args))
    q_T, p_T, lam_loc, lam_T_, _, _ = ex(args)
    exe["lambda_sha256"] = _digest(*lam_loc, lam_T_)
    exe["flux_sha256"] = _digest(*q_T)
    exe["pressure_sha256"] = _digest(*p_T)
    out["executor"] = exe

    def whole():
        forms(asm)
        solver.assemble()
        solver.solve()

    out["solve_ms"] = best_ms(whole, reps=5)
    out["solution_sha256"] = _digest(*(torch.as_tensor(np.asarray(fn.values)) for fn in solver.solve()))
    return out


def _sharded(asm, dev, D: int = 8):
    """The sharded solver of ``asm`` on D shards of the card, solved once,
    its executor and the executor's per-shard arguments."""
    from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

    solver = ShardedNetworkSolver(asm, devices=[dev] * D)
    solver.assemble()
    solver.solve()
    ex = solver._blocked_exec
    return solver, ex, ex.prepare_args(*solver._coeff_args)


def _k1_shards(ex, args):
    """K1 of a sharded executor's shards as the port issues it: the group's
    one launch where the executor has K1 stages (``condense``), a launch a
    shard otherwise; returns ``(run, outputs)``, ``outputs()`` each shard's
    ``(W, w, g, Ftot, const)`` in shard order."""
    from networks_fenicsx_tpu_torch.kernels import condense

    if hasattr(ex, "condense"):
        def run():
            return ex.condense(0, args)

        def outputs():
            k1 = run()
            return [tuple(k1[:, j].unbind(0)) for j in range(k1.shape[1])]
    else:
        def run():
            return [condense.condense(sh["ends"], ex._N, ex._k, sh["h_e"], R, f, *ex._modes, sp, ep)
                    for sh, (R, f, sp, ep) in zip(ex.shards, args)]

        outputs = run
    return run, outputs


# K22b's kernels on either port (the per-strip design's window and stubs kernels too)
K22B_PATTERN = r"\bgrid_(window|stubs|fill)_kernel\b"


def _launches_of(split: dict, pattern: str) -> float:
    """Launches a call of the kernels of :func:`device_split` whose name
    matches ``pattern``."""
    return sum(n for key, (_, n) in split.items() if re.search(pattern, key))


def _executor_digests(ex, args) -> dict:
    """The executor call's :func:`timed_call` figures, its device µs and
    launches by source and those of K1 and K22b, its host µs by function
    and ``chip_smoke.executor_digests`` (λ, q, p)."""
    exe = timed_call(lambda: ex(args), reps=10)
    exe["device_by_source"] = by_source(exe["device_us_by_kernel"])
    exe["k1_launches"] = _launches_of(exe["device_us_by_kernel"], chip_smoke.CONDENSE_PATTERN)
    exe["k22b_launches"] = _launches_of(exe["device_us_by_kernel"], K22B_PATTERN)
    exe["host_split"] = host_split(lambda: ex(args))
    exe["sha256"] = chip_smoke.executor_digests(ex, args)
    return exe


def condense_times(dev) -> dict:
    """``--select condense``: K1 on the port that ``sys.path`` finds first
    (either port's interface), on the inputs its executors give it: the
    headline tree (16 generations, N = 40, edge R, zero f; one launch), the
    sharded tree's 8 shards and the sharded lattice's 8 strips (one launch
    for every shard where the executor has K1 stages, a launch a shard
    otherwise), each with :func:`timed_call`'s figures (``dispatch_us``:
    the wrapper's host µs a call), its K1 launches a call, whether it
    equals the plain version and the SHA-256 of the outputs (shard by
    shard, ``W, w, g, Ftot, const``); on the sharded routes also the
    executor's λ, q, p (``chip_smoke.executor_digests``)."""
    from networks_fenicsx_tpu_torch.kernels import condense
    from networks_fenicsx_tpu_torch.solver import build_schur_executor

    asm = chip_smoke.arterial_assembler(P, chip_smoke.GENERATIONS, chip_smoke.N_CELLS)
    ex = build_schur_executor(asm, P.SolverOptions(), device=dev)
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    dp = ex.device_plan
    Rm, fm, _ = asm.coefficient_modes()
    c_args = (asm.network.N, asm.flux_degree, ex._h_e, R, f, Rm, fm, sp, ep)
    rec = timed_call(lambda: condense.condense(dp, *c_args), reps=50)
    got = condense.condense(dp, *c_args)
    rec["equal_plain"] = all(torch.equal(a, b) for a, b in
                             zip(got, condense.condense_plain(dp.plan, *c_args)))
    rec["outputs_sha256"] = _digest(*got)
    rec["k1_launches"] = _launches_of(rec["device_us_by_kernel"], chip_smoke.CONDENSE_PATTERN)
    rec["sizes"] = {"edges": dp.num_edges, "modes": [Rm, fm]}
    out = {"headline": rec}
    del ex, got
    for key, asm_ in (("sharded_tree", asm), ("sharded_lattice", chip_smoke.lattice_assembler(P))):
        _, sex, sargs = _sharded(asm_, dev)
        run, outputs = _k1_shards(sex, sargs)
        rec = timed_call(run, reps=50)
        res = outputs()
        plain = [condense.condense_plain(sh["ends"].plan, sex._N, sex._k, sh["h_e"], R_, f_,
                                         *sex._modes, sp_, ep_)
                 for sh, (R_, f_, sp_, ep_) in zip(sex.shards, sargs)]
        rec["equal_plain"] = all(torch.equal(a, b) for o, q in zip(res, plain) for a, b in zip(o, q))
        rec["outputs_sha256"] = _digest(*(t for o in res for t in o))
        rec["k1_launches"] = _launches_of(rec["device_us_by_kernel"], chip_smoke.CONDENSE_PATTERN)
        rec["shards"], rec["E_loc"] = len(sex.shards), sex.plan.E_loc
        rec["executor_sha256"] = chip_smoke.executor_digests(sex, sargs)
        if hasattr(sex, "condense"):
            rec["bound"] = chip_smoke.bound(*chip_smoke.condense_work(sex, sargs))
        out[key] = rec
        del sex, sargs, res, plain
    return out


def strip_times(dev) -> dict:
    """``--select strips``: K22b and K1 on the sharded lattice (the 512²
    lattice in 8 strips of the card), on the port that ``sys.path`` finds
    first (either port's interface): a solve's K22b work alone (every
    strip's window and the fill: one window launch for every strip on a
    port with stacked strip tables, two a strip otherwise) and K1's (as
    :func:`_k1_shards`), each with :func:`timed_call`'s figures, its
    launches and the SHA-256 of its outputs; the executor's call
    (:func:`_executor_digests`); and compute_forms + assemble + solve (host
    clock, best of 5)."""
    from networks_fenicsx_tpu_torch.kernels import shard_grid, shard_top

    asm, forms = chip_smoke.lattice_assembler(P), chip_smoke.lattice_forms
    solver, ex, args = _sharded(asm, dev)
    p = ex.plan
    r = int(p.dct.stub_rows.size)
    Ex, Ey = p.ny * (p.nx - 1), (p.ny - 1) * p.nx
    E = ex.grid[dev].num_edges
    if hasattr(ex, "window"):
        k1 = ex.condense(0, args)

        def windows():
            return ex.window(0, k1)
    else:
        fws = [ex.forward(i, *a) for i, a in enumerate(args)]

        def windows():
            return [shard_grid.window(sh["tables"], fw.w, fw.const, fw.Ftot)
                    for sh, fw in zip(ex.shards, fws)]
    rows = windows()
    rows = rows if isinstance(rows, torch.Tensor) else torch.stack(rows)
    tail = shard_top.reduce(rows, 2 + r, 2 * (p.h + 1) * p.nx)

    def k22b():
        return windows(), shard_grid.fill(Ex, Ey, E, tail)

    rec = timed_call(k22b, reps=50)
    rec["rows_sha256"] = _digest(rows)
    rec["fill_sha256"] = _digest(shard_grid.fill(Ex, Ey, E, tail))
    rec["k22b_launches"] = _launches_of(rec["device_us_by_kernel"], K22B_PATTERN)
    if hasattr(shard_grid, "cuda_launches"):
        bt = ex.groups[0]["tables"]
        rec["cuda_launches"] = shard_grid.cuda_launches(bt)
        rec["equal_plain"] = torch.equal(rows, ex.window(0, k1, plain=True))
        work = (chip_smoke.tensor_bytes(k1[1], k1[4], k1[3], bt.valid, bt.cell_map, bt.st_fold,
                                        bt.grp_fold, bt.st_sb)
                + 8 * rows.numel() + chip_smoke.tensor_bytes(tail) + 8 * E,
                12 * (p.h + 1) * p.nx * p.D)
        rec["bound"] = chip_smoke.bound(*work)
    out = {"k22b": rec, "plan": {"D": p.D, "h": p.h, "nx": p.nx, "E_loc": p.E_loc}}
    run, outputs = _k1_shards(ex, args)
    k1rec = timed_call(run, reps=50)
    k1rec["outputs_sha256"] = _digest(*(t for o in outputs() for t in o))
    k1rec["k1_launches"] = _launches_of(k1rec["device_us_by_kernel"], chip_smoke.CONDENSE_PATTERN)
    out["k1"] = k1rec
    out["executor"] = _executor_digests(ex, args)

    def whole():
        forms(asm)
        solver.assemble()
        solver.solve()

    out["solve_ms"] = best_ms(whole, reps=5)
    out["solution_sha256"] = _digest(*(torch.as_tensor(np.asarray(fn.values)) for fn in solver.solve()))
    return out


def mf_times(dev) -> dict:
    """``--select mf``: K13–K14 and K15 on the 100k web's multifrontal core
    as its executor gives them (``dc``, ``w_pairs``, ``rc`` captured from a
    solve), on the port that ``sys.path`` finds first:

    * the factor, the apply and the web's executor (CUDA events), each with
      :func:`timed_call`'s figures for the two kernels;
    * every device launch of one factor and one apply in issue order (name,
      µs), summed by kernel name and, where a launch is one group (the
      one-launch-per-group design), by group key ``k,w,b,n_cons`` and by
      class (:func:`group_classes`: the leaf groups, the 1–3-front groups,
      the wide top fronts); where the port has a level schedule
      (``dmf.schedule``), by level;
    * the apply's error against SciPy's ``splu`` on the same core, relative
      to max |x|, for 0, 1 and 3 refinement passes;
    * the SHA-256 of the apply's result and of the solution;
    * the same two on the plain versions (``mf_factor_plain`` and
      ``mf_apply_plain`` on the same inputs, and a solve whose core runs
      them): ``apply_plain`` and ``solution_plain``.

    With ``--out``, the four vectors are also written beside it (``.npz``;
    :func:`vector_diffs` compares two runs')."""
    import dataclasses
    import hashlib

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from networks_fenicsx_tpu_torch.kernels import mf_apply, mf_factor

    factor0, apply0 = mf_factor.mf_factor, mf_apply.mf_apply
    asm = chip_smoke.web_assembler(P)
    solver, dmf, dc, w, rc = chip_smoke.mf_core_inputs(P, asm)
    plan = dmf.plan
    G = len(plan.groups)
    st = factor0(dmf, dc, w)
    x = apply0(dmf, st, rc)
    out = {"core": plan.n_core, "groups": G, "fronts": sum(g.k for g in plan.groups),
           "factor": timed_call(lambda: factor0(dmf, dc, w), reps=10),
           "apply": timed_call(lambda: apply0(dmf, st, rc), reps=10)}
    ex = solver._executor
    args = ex.prepare_args(*asm.schur_arguments())
    out["executor_ms"] = chip_smoke.cuda_ms(lambda: ex(*args), reps=5)

    classes = group_classes(plan)
    keys = [f"{g.k},{g.w},{g.b},{len(g.consume)}" for g in plan.groups]
    for what, fn, split in (
        ("factor", lambda: factor0(dmf, dc, w),
         ((("mf_factor_group_kernel",), lambda i: i),)),
        ("apply", lambda: apply0(dmf, st, rc),
         ((("mf_forward_kernel",), lambda i: i % G),
          (("mf_backward_kernel",), lambda i: G - 1 - i % G))),
    ):
        events = launch_list(fn)
        rec = {"launches": len(events), "device_us": sum(us for _, us in events),
               "by_kernel": {}, "events": events}
        for name, us in events:
            acc = rec["by_kernel"].setdefault(name, [0.0, 0])
            acc[0] += us
            acc[1] += 1
        by_group = [0.0] * G
        grouped = False
        for names, order in split:
            acc = per_group_split(events, names, G, order)
            if acc is not None:
                grouped = True
                by_group = [a + b for a, b in zip(by_group, acc)]
        if grouped:
            rec["by_group"] = {f"{gi}:{keys[gi]}:L{classes[gi][1]}": us
                               for gi, us in enumerate(by_group)}
            by_class = {}
            for (cls, _), us in zip(classes, by_group):
                acc = by_class.setdefault(cls, [0.0, 0])
                acc[0] += us
                acc[1] += 1
            rec["by_class"] = by_class
        schedule = getattr(dmf, "schedule", None)
        if schedule is not None:
            rec["by_level"] = level_split(what, events, schedule)
        out[what + "_split"] = rec

    if hasattr(mf_factor, "assemble_fronts"):  # the factor's launches stopped after assembly
        events = launch_list(lambda: mf_factor.assemble_fronts(dmf, dc, w, st.pools))
        out["assemble_split"] = {"device_us": sum(us for _, us in events),
                                 "by_level": level_split("factor", events, dmf.schedule)}

    # the refinement question: the apply against SciPy's splu on this core
    n = plan.n_core
    pci, pcj = plan.pci.astype(np.int64), plan.pcj.astype(np.int64)
    wv = w.cpu().numpy()[plan.init_slot.astype(np.int64)]
    A = sp.csc_matrix((np.concatenate([dc.cpu().numpy(), -wv, -wv]),
                       (np.concatenate([np.arange(n), pci, pcj]),
                        np.concatenate([np.arange(n), pcj, pci]))), shape=(n, n))
    exact = spla.splu(A).solve(rc.cpu().numpy())
    scale = float(np.max(np.abs(exact)))
    out["refinement_vs_splu"] = {"scale": scale}
    for n_refine in (0, 1, 3):
        dmf_r = dataclasses.replace(dmf, plan=plan._replace(n_refine=n_refine))
        got = apply0(dmf_r, st, rc).cpu().numpy()
        out["refinement_vs_splu"][str(n_refine)] = float(np.max(np.abs(got - exact))) / scale

    def digest(v) -> str:
        return hashlib.sha256(np.ascontiguousarray(v, dtype=np.float64).tobytes()).hexdigest()

    sol = np.asarray(solver.solution_vector())
    x_plain = mf_apply.mf_apply_plain(dmf, mf_factor.mf_factor_plain(dmf, dc, w), rc).cpu().numpy()
    mf_factor.mf_factor, mf_apply.mf_apply = mf_factor.mf_factor_plain, mf_apply.mf_apply_plain
    try:
        plain_solver = P.Solver(asm, device="cuda")
        plain_solver.solve()
    finally:
        mf_factor.mf_factor, mf_apply.mf_apply = factor0, apply0
    sol_plain = np.asarray(plain_solver.solution_vector())
    out["apply_sha256"], out["solution_sha256"] = digest(x.cpu().numpy()), digest(sol)
    out["apply_plain_sha256"], out["solution_plain_sha256"] = digest(x_plain), digest(sol_plain)
    out["fac_sha256"] = digest(st.fac.cpu().numpy())
    out["_vectors"] = {"apply": x.cpu().numpy(), "solution": sol, "apply_plain": x_plain,
                       "solution_plain": sol_plain}
    return out


def vector_diffs(a_path: pathlib.Path, b_path: pathlib.Path) -> dict:
    """``--diff A B``: the vectors of two ``--select mf --out`` runs
    (``.npz``, e.g. the parent's and the change's): for each key both hold,
    max |A − B| and the scale max(1, max |A|); and within each run, its
    kernel path against its plain path (``apply`` against ``apply_plain``,
    ``solution`` against ``solution_plain``)."""
    runs = {"A": np.load(a_path), "B": np.load(b_path)}
    A, B = runs["A"], runs["B"]
    out = {"A": str(a_path), "B": str(b_path)}

    def diff(u, v) -> dict:
        return {"max_abs": float(np.max(np.abs(u - v))),
                "scale": max(1.0, float(np.max(np.abs(u)))),
                "equal": bool(np.array_equal(u, v))}

    for key in sorted(set(A.files) & set(B.files)):
        out[f"A-B {key}"] = diff(A[key], B[key])
    for name, z in runs.items():
        for key in ("apply", "solution"):
            if key in z.files and key + "_plain" in z.files:
                out[f"{name} {key}-{key}_plain"] = diff(z[key], z[key + "_plain"])
    return out


def window_probe(dev, windows: int = 20) -> dict:
    """``--select windows``: each case of ``chip_smoke.py``'s two
    launch-count phases (K19a's and K19e's six, K13–K15's factor and apply
    on the web's core) in ``windows`` profiler windows of
    :func:`chip_smoke.counted_window`, every window's counts (reported,
    profiled, the padding kernels at each edge; ``whole``: every padding
    kernel recorded, ``held``: :func:`chip_smoke.holds_its_run`): how often
    and where the profiler leaves records out.  On this checkout's port
    only."""
    cases = {key: (run, want * chip_smoke.KRYLOV_CALLS, chip_smoke.KRYLOV_PATTERN)
             for key, (run, want) in chip_smoke.krylov_launch_cases(dev).items()}
    _, runs = chip_smoke.mf_launch_cases(P, chip_smoke.web_assembler(P))
    cases.update({key: (run, chip_smoke.MF_LAUNCHES[key], chip_smoke.MF_PATTERNS[key])
                  for key, run in runs.items()})
    first = chip_smoke.counted_window(lambda: 0, chip_smoke.KRYLOV_PATTERN, dev)
    out = {"first_window": first, "pad_kernels": chip_smoke.PAD_KERNELS}
    for key, (run, want, pattern) in cases.items():
        ws = [chip_smoke.counted_window(run, pattern, dev) for _ in range(windows)]
        whole = [w["pad_start"] == w["pad_end"] == chip_smoke.PAD_KERNELS for w in ws]
        held = [chip_smoke.holds_its_run(w) for w in ws]
        agree = [w["reported"] == w["profiled"] == want for w in ws]
        out[key] = {"want": want, "whole": sum(whole), "held": sum(held), "agree": sum(agree),
                    "held_but_disagree": sum(h and not a for h, a in zip(held, agree)),
                    "windows": ws}
    return out


KRYLOV_ITERS = 40  # CG iterations of the p1tree timed (a whole number of chunks)


def krylov_split(fn, iterations: int) -> dict:
    """``fn``'s device µs and launches over ``iterations`` by kernel name
    (:func:`device_split`), the ``kernels/csrc/krylov.cu`` kernels' total,
    and both per iteration."""
    sources = kernel_sources()
    split = device_split(fn, reps=2)
    ours = {name: v for name, v in split.items()
            if sources.get(name.split()[-1]) == "krylov.cu"}
    us = sum(v[0] for v in ours.values())
    launches = sum(v[1] for v in ours.values())
    return {"krylov_cu_us": us, "krylov_cu_launches": launches,
            "krylov_cu_us_an_iteration": us / iterations,
            "krylov_cu_launches_an_iteration": launches / iterations,
            "device_us": sum(v[0] for v in split.values()), "device_us_by_kernel": split}


def _digest(*tensors) -> str:
    """SHA-256 of the tensors' float64 values, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float64).tobytes())
    return h.hexdigest()


def by_source(split: dict) -> dict:
    """:func:`device_split`'s kernels summed by the CUDA source that defines
    them (``PyTorch`` for the rest): ``{source: [µs, launches]}``."""
    sources, out = kernel_sources(), {}
    for key, (us, n) in split.items():
        name = (key.split("::")[-1].split() or [""])[-1]
        acc = out.setdefault(sources.get(name, "PyTorch"), [0.0, 0.0])
        acc[0] += us
        acc[1] += n
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def mg1d_times(dev) -> dict:
    """``--select mg1d``: K19d on the 3×2000 lattice's λ system under
    ``cg_precond="mg"`` (chip_smoke's set (m)), on the port that ``sys.path``
    finds first (either port's interface):

    * one V-cycle application, :func:`timed_call`'s figures, its wrapper
      launches by counter, its device µs by source, and its result against
      the composed plain cycle's on the same inputs (max |diff|, equal);
    * the skinny-mg executor (CUDA events, a solve), its iterations and one
      call's device µs and launches by source.

    With ``--out``, the V-cycle's result and the solution are also written
    beside it (``.npz``; ``--diff`` compares two runs')."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.multigrid import Mg1dPreconditioner

    opts = P.SolverOptions(schur_method="cg", cg_precond="mg")
    skinny = chip_smoke.lattice_assembler(P, 3, 2000, forms=chip_smoke.skinny_forms)
    cg_ex, diag, _, _, cw = chip_smoke.cg_system(P, skinny, dev, opts)
    plan, offsets = cg_ex.precond_plan, cg_ex.device_plan.offsets
    pre = Mg1dPreconditioner(plan, offsets, cw, diag, opts.mg_overcorrect)
    plain = Mg1dPreconditioner(plan, offsets, cw, diag, opts.mg_overcorrect, plain=True)
    r = torch.randn(diag.shape[0], generator=torch.Generator(device=dev).manual_seed(19),
                    dtype=torch.float64, device=dev)
    pre(r)
    torch.cuda.synchronize()
    kernels.reset_launches()
    pre(r)
    wrapper = {name: n for name, n in kernels.launches().items() if n}
    rec = timed_call(lambda: pre(r))
    rec["wrapper_launches"] = wrapper
    rec["device_by_source"] = by_source(rec["device_us_by_kernel"])
    z, zp = pre(r), plain(r)
    rec["vs_plain"] = {"max_abs": float((z - zp).abs().max()), "equal": bool(torch.equal(z, zp)),
                       "sha256": _digest(z), "plain_sha256": _digest(zp)}
    rec["levels"] = [lvl.m for lvl in plan.levels] + [plan.m_bottom]
    out = {"k19d_vcycle_skinny": rec}
    solver = P.Solver(skinny, options=opts, device="cuda")
    solver.solve()
    ex = solver._executor
    args = ex.prepare_args(*skinny.schur_arguments())
    split = device_split(lambda: ex(*args), reps=1)
    out["skinny_executor"] = {
        "ms": chip_smoke.cuda_ms(lambda: ex(*args), reps=5, warmup=1),
        "iterations": solver.info.iterations,
        "device_us": sum(v[0] for v in split.values()),
        "device_launches": sum(v[1] for v in split.values()),
        "device_by_source": by_source(split),
        "solution_sha256": _digest(torch.as_tensor(np.asarray(solver.solution_vector())))}
    out["_vectors"] = {"skinny_solution": np.asarray(solver.solution_vector()),
                       "vcycle": z.cpu().numpy()}
    return out


def dist_times(dev) -> dict:
    """``--select dist``: K22c on the sharded forest (the 100k forest over 8
    shards of the card, ``tree_dist``; chip_smoke's sharded-forest), on the
    port that ``sys.path`` finds first (either port's interface): the host
    plan's level widths and fold widths; the executor (:func:`timed_call`'s
    figures on one call), its device µs by source and ``dist_tree.cu``'s
    by kernel with their launches; the SHA-256 of its λ; and
    compute_forms + assemble + solve (host clock, best of 5)."""
    from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

    asm = chip_smoke.forest_assembler(P, chip_smoke.forest_mesh(P))
    solver = ShardedNetworkSolver(asm, devices=[dev] * chip_smoke.SHARD_FOREST["D"])
    solver.assemble()
    solver.solve()
    ex, plan = solver._dist_exec, solver._dist_plan
    widths = np.diff(plan.level_offsets)
    out = {"plan": {"D": plan.D, "B_loc": plan.B_loc, "Tn": plan.Tn, "levels": int(widths.size),
                    "widest": int(widths.max()), "median_width": float(np.median(widths)),
                    "fold_widths": sorted({int(f.shape[2]) for f in plan.level_folds})}}
    args = ex.prepare_args(*solver._coeff_args)
    rec = timed_call(lambda: ex(args), reps=10)
    rec["device_by_source"] = by_source(rec["device_us_by_kernel"])
    sources = kernel_sources()
    rec["dist_tree_by_kernel"] = {
        key: v for key, v in rec["device_us_by_kernel"].items()
        if sources.get((key.split("::")[-1].split() or [""])[-1]) == "dist_tree.cu"}
    q_T, p_T, lam_loc, lam_T, _ = ex(args)
    rec["lambda_sha256"] = _digest(*lam_loc, lam_T)
    rec["flux_sha256"] = _digest(*q_T)
    out["executor"] = rec

    def whole():
        chip_smoke.forest_forms(asm)
        solver.assemble()
        solver.solve()

    out["solve_ms"] = best_ms(whole, reps=5)
    return out


def _executor_record(ex, args, reps: int = 10) -> dict:
    """An executor call's :func:`timed_call` figures, its device µs by
    source, and the SHA-256 of its λ (out[2]) and fluxes (out[0])."""
    rec = timed_call(lambda: ex(*args), reps=reps)
    rec["device_by_source"] = by_source(rec["device_us_by_kernel"])
    out = ex(*args)
    rec["lambda_sha256"] = _digest(out[2])
    rec["flux_sha256"] = _digest(out[0])
    return rec


def level_times(dev) -> dict:
    """``--select level``: K7 on the forest (the 100k-site forest, N = 8,
    k = 2) and callable (the 16-generation tree with callable R and f, the
    general layout) main paths, on the port that ``sys.path`` finds first
    (either port's interface): each level executor's call (:func:`timed_call`,
    device µs by source, the λ and flux SHA-256), its plan's levels and
    widest level, K7 alone (its wrapper on the executor's edge data) and
    compute_forms + solve (host clock, best of 5).  With ``--out`` the λ are
    written beside it (``--diff``)."""
    from networks_fenicsx_tpu_torch.kernels import edge_data, level_eliminate

    out, vectors = {}, {}
    cases = {"forest": (lambda: chip_smoke.forest_assembler(P, chip_smoke.forest_mesh(P)),
                        chip_smoke.forest_forms),
             "callable": (lambda: chip_smoke.callable_assembler(P), chip_smoke.callable_forms)}
    for name, (build, forms) in cases.items():
        asm = build()
        solver = P.Solver(asm, device="cuda")
        solver.solve()
        ex = solver._executor
        args = ex.prepare_args(*asm.schur_arguments())
        rec = _executor_record(ex, args)
        dlp = ex.device_plan
        widths = np.diff(np.asarray(dlp.level_offsets))
        rec["plan"] = {"levels": int(widths.size), "widest": int(widths.max()),
                       "wider_than_128": int(np.sum(widths > 128))}
        R, f, sp, ep = ex.upload(*args)
        Rm, fm, f_zero = asm.coefficient_modes()
        ed = edge_data.edge_data(dlp, asm.network.N, asm.flux_degree, ex._h_e, ex._quad_w, ex._quad_phi,
                                 R, f, Rm, fm, f_zero, sp, ep)
        k7 = timed_call(lambda: level_eliminate.level_eliminate(dlp, ed), reps=10)
        k7["by_source"] = by_source(k7["device_us_by_kernel"])
        k7["cuda_launches_formula"] = level_eliminate.cuda_launches(dlp)
        rec["k7"] = k7

        def whole(asm=asm, solver=solver, forms=forms):
            forms(asm)
            solver.solve()

        rec["solve_ms"] = best_ms(whole, reps=5)
        out[name] = rec
        vectors[f"{name}_lambda"] = ex(*args)[2].cpu().numpy()  # the fluxes by their digest only
        del asm, solver, ex, ed
    out["_vectors"] = vectors
    return out


def gather_times(dev) -> dict:
    """``--select gather``: K19b on the web-cg main path (the 100k-site web
    under ``schur_method="cg"``, Chebyshev degree 8), on the port that
    ``sys.path`` finds first (either port's interface): the executor's call
    (:func:`timed_call`, device µs by source, the λ and flux SHA-256), its
    iterations, the λ system's matvec alone and one Chebyshev application
    as the executor issues it (a plan's ``ChebApply``, or the composed
    steps), and compute_forms + solve (host clock, best of 5).  With
    ``--out`` the λ and the application are written beside it (``--diff``)."""
    from networks_fenicsx_tpu_torch.kernels import gather_matvec
    from networks_fenicsx_tpu_torch.multigrid import GatherOperator
    from networks_fenicsx_tpu_torch.ops.krylov import chebyshev_preconditioner

    opts = P.SolverOptions(schur_method="cg")
    asm = chip_smoke.web_assembler(P)
    solver = P.Solver(asm, options=opts, device="cuda")
    solver.solve()
    ex = solver._executor
    args = ex.prepare_args(*asm.schur_arguments())
    rec = _executor_record(ex, args, reps=5)
    rec["iterations"] = solver.info.iterations
    _, diag, rhs, w, _ = chip_smoke.cg_system(P, asm, dev, opts)
    if hasattr(gather_matvec, "GatherPlan"):
        op = GatherOperator(ex.gather_plan, w, diag)
        applies = {"fused": ex._preconditioner(op, None, False)}
    else:
        op = GatherOperator(ex.device_plan.mv_edge, ex.device_plan.mv_other, w, diag)
        applies = {"composed": chebyshev_preconditioner(op.step, diag, degree=8)}
    x = torch.randn(diag.shape[0], generator=torch.Generator(device=dev).manual_seed(17),
                    dtype=torch.float64, device=dev)
    rec["matvec"] = timed_call(lambda: op.apply(x), reps=20)
    z = {}
    for key, apply in applies.items():
        rec[f"chebyshev_{key}"] = timed_call(lambda apply=apply: apply(rhs), reps=20)
        z[key] = apply(rhs)
    rec["chebyshev_sha256"] = {key: _digest(v) for key, v in z.items()}

    def whole():
        chip_smoke.forest_forms(asm)
        solver.solve()

    rec["solve_ms"] = best_ms(whole, reps=5)
    res = ex(*args)
    out = {"web_cg": rec,
           "_vectors": {"web_cg_lambda": res[2].cpu().numpy(),
                        "chebyshev": next(iter(z.values())).cpu().numpy()}}
    return out


def krylov_times(dev) -> dict:
    """K19a and K19e as their solves issue them, on the port that
    ``sys.path`` finds first (either interface: the ``Jacobi``
    preconditioner, or a lambda on ``jacobi``):

    * K19a — :data:`KRYLOV_ITERS` Jacobi CG iterations on the p1tree's
      reduced operator ``T = J A⁻¹ Jᵀ`` (tol 0, so that none stops): CUDA
      events over the loop, and the ``krylov.cu`` kernels' device µs and
      launches an iteration by kernel name (the profiler, beside K20b and
      K21a); the bound of an iteration, 13 vectors of the reduced system;
      and the p1tree's executor (CUDA events, a solve);
    * K19e — the minres path's solve (``_generic_solve``, 2,422 dofs): CUDA
      events, its iterations, and the ``krylov.cu`` kernels' device µs and
      launches per solve and per iteration; the one-launch and ticketed
      MINRES steps at three sizes (:func:`minres_paths`);
    * the solutions' digests (:func:`solution_digests`)."""
    from networks_fenicsx_tpu_torch.kernels import csr, krylov, schur_p
    from networks_fenicsx_tpu_torch.ops import krylov as loop
    from networks_fenicsx_tpu_torch.solver import _SchurPExecutor

    def jacobi(diag):
        if hasattr(krylov, "Jacobi"):
            return krylov.Jacobi(diag)
        return lambda v: krylov.jacobi(v, diag)

    out = {}
    asm = chip_smoke.p1tree_assembler(P)
    ex = _SchurPExecutor(asm, P.SolverOptions(), dev)
    cm = asm._cell_mass_on(dev)
    if hasattr(schur_p, "flux_tiles"):
        f_args = s_args = (ex.tiles,)
    else:
        f_args, s_args = (ex.base, ex._N, ex._k, ex.n_flux), (ex.base, ex._N, ex._k)
    Lb, adiag = schur_p.schur_p_factor(cm, *f_args)
    J, JT = ex.J.device_arrays, ex.JT.device_arrays
    n_red = ex.J.shape[0]
    rhs = torch.randn(n_red, generator=torch.Generator(device=dev).manual_seed(19),
                      dtype=torch.float64, device=dev)
    M = jacobi(csr.csr_tdiag(*J, adiag))

    def matvec(z):
        return csr.csr_spmv(*J, schur_p.schur_p_solve(Lb, *s_args, csr.csr_spmv(*JT, z)))

    def run():
        res = loop.cg(matvec, rhs, precond=M, rtol=0.0, atol=0.0, maxiter=KRYLOV_ITERS)
        assert res.iters == KRYLOV_ITERS, res.iters

    rec = {"iterations": KRYLOV_ITERS, "n": n_red,
           "loop_ms_an_iteration": chip_smoke.cuda_ms(run, reps=3, warmup=1) / KRYLOV_ITERS}
    rec.update(krylov_split(run, KRYLOV_ITERS))
    rec["bound_ms_an_iteration"] = 13 * 8 * n_red / chip_smoke.HBM_BYTES_PER_S * 1e3
    out["k19a_p1tree_iteration"] = rec
    ex()
    out["p1tree_executor"] = {"ms": chip_smoke.cuda_ms(lambda: ex(), reps=3, warmup=1),
                              "iterations": int(ex()[1])}
    del ex, Lb, cm, J, JT

    masm = chip_smoke.minres_assembler(P)
    opts = P.SolverOptions(method="minres", rtol=1e-12)
    solver = P.Solver(masm, options=opts, device="cuda")
    solver.assemble()
    solver.solve()
    iters = solver.info.iterations

    def solve():
        _generic_solve(solver.A, solver.b, masm, "minres", opts)

    rec = {"iterations": iters, "n": masm.num_dofs,
           "executor_ms": chip_smoke.cuda_ms(solve, reps=3, warmup=1)}
    rec.update(krylov_split(solve, iters))
    out["k19e_minres"] = rec
    if hasattr(krylov, "MinresSteps"):
        out["k19e_one_launch_or_many"] = minres_paths(dev)
    out["solution_sha256"] = solution_digests(dev, solver, masm, opts)
    return out


def solution_digests(dev, minres_solver, masm, opts) -> dict:
    """SHA-256 of the float64 solutions of the Krylov routes, so that two
    ports compare bit for bit in one call: the p1tree (``schur_p``, Jacobi
    CG), the minres path (Jacobi MINRES), cg512 (2-D multigrid CG) and
    web-cg (Chebyshev CG)."""
    import hashlib

    def digest(x) -> str:
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return hashlib.sha256(np.ascontiguousarray(x, dtype=np.float64).tobytes()).hexdigest()

    out = {"minres": digest(_generic_solve(minres_solver.A, minres_solver.b, masm, "minres", opts)[0])}
    for key, build in (("p1tree", lambda: chip_smoke.p1tree_assembler(P)),
                       ("cg512", lambda: chip_smoke.lattice_assembler(P, forms=chip_smoke.cg512_forms)),
                       ("web-cg", lambda: chip_smoke.web_assembler(P))):
        options = P.SolverOptions() if key == "p1tree" else P.SolverOptions(schur_method="cg")
        solver = P.Solver(build(), options=options, device="cuda")
        solver.solve()
        out[key] = {"sha256": digest(solver.solution_vector()), "iterations": solver.info.iterations}
        del solver
    return out


MINRES_ITERS = 200


def minres_paths(dev) -> dict:
    """K19e's Jacobi iteration in one cluster launch against its three
    ticket-finished launches, at n = 2,422 (the minres path's size) and at
    the cluster's largest (8,192) and smallest above (8,193): the
    ``krylov.cu`` device µs an iteration over :data:`MINRES_ITERS`
    iterations of a seeded tridiagonal SPD operator (the matvec's time
    apart, by kernel name)."""
    from networks_fenicsx_tpu_torch.kernels import krylov

    out = {}
    for n in (2_422, 8_192, 8_193):
        gen = torch.Generator(device=dev).manual_seed(n)
        d = torch.rand(n, generator=gen, dtype=torch.float64, device=dev) + 3.0
        off = torch.rand(n - 1, generator=gen, dtype=torch.float64, device=dev)
        b = torch.randn(n, generator=gen, dtype=torch.float64, device=dev)

        def mv(v):
            out_ = d * v
            out_[:-1] += off * v[1:]
            out_[1:] += off * v[:-1]
            return out_

        for one in (True, False):
            if one and n > krylov.CLUSTER_CHUNKS * 256:
                continue

            def run(one=one):
                ms, part, v = krylov.minres_state(dev), krylov.partials(n, dev), torch.empty_like(b)
                x, r = torch.zeros_like(b), b.clone()
                krylov.minres_start(ms, b, r, krylov.jacobi(r, d), v, part, 0.0, 0.0, 10**9)
                cluster_chunks = krylov.CLUSTER_CHUNKS
                krylov.CLUSTER_CHUNKS = cluster_chunks if one else 0  # 0: the ticketed launches
                try:
                    steps = krylov.MinresSteps(ms, part, v, x, r, d)
                finally:
                    krylov.CLUSTER_CHUNKS = cluster_chunks
                for _ in range(MINRES_ITERS):
                    steps.step(mv(v))

            out[f"n{n}_{'one_launch' if one else 'tickets'}"] = krylov_split(run, MINRES_ITERS)
    return out


def k21a_times(dev) -> dict:
    """K21a on the p1tree (16 generations, N = 40, P2/P1: 65,535 edges of
    m = 81 flux dofs): the solve on its own factor and the factor, each with
    :func:`timed_call`'s figures and its bound (bytes: the band, ``v`` and
    ``out`` once; the cell masses, the band and the diagonal once), and the
    executor's whole solve (factor, CG, back substitution; CUDA events, 3
    solves).  DRAM bytes are not measured (the profiler gives none).  Takes
    either port's interface: the tile plan, or the first flux dofs."""
    from networks_fenicsx_tpu_torch.kernels import schur_p
    from networks_fenicsx_tpu_torch.solver import _SchurPExecutor

    asm = chip_smoke.p1tree_assembler(P)
    ex = _SchurPExecutor(asm, P.SolverOptions(), dev)
    cm = asm._cell_mass_on(dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    v = torch.randn(ex.n_flux, generator=gen, dtype=torch.float64, device=dev)
    tiled = hasattr(schur_p, "flux_tiles")
    if tiled:
        f_args = s_args = (ex.tiles,)
    else:  # the first flux dofs
        f_args, s_args = (ex.base, ex._N, ex._k, ex.n_flux), (ex.base, ex._N, ex._k)

    def factor():
        return schur_p.schur_p_factor(cm, *f_args)

    Lb, _ = factor()
    E, k = asm.network.num_edges, ex._k
    band = ex.n_flux * (k + 1) * 8  # the band's bytes without the ragged tile's padding
    solve = timed_call(lambda: schur_p.schur_p_solve(Lb, *s_args, v))
    solve.update(chip_smoke.bound(band + 16 * ex.n_flux, ex.n_flux * (4 * k + 2)))
    fac = timed_call(factor, reps=5)
    fac.update(chip_smoke.bound(chip_smoke.tensor_bytes(cm) + band + 8 * ex.n_flux + 4 * E,
                                ex.n_flux * (k + 1) * (k + 2)))
    _, iters, _, ok = ex()
    return {"k21a_solve_p1tree": solve, "k21a_factor_p1tree": fac,
            "p1tree_executor": {"ms": chip_smoke.cuda_ms(lambda: ex(), reps=3, warmup=1),
                                "iterations": int(iters), "converged": bool(ok),
                                "tiled": tiled}}


def k18_times(dev) -> dict:
    """K18 as its routes issue it: on the 512² lattice's general DCT route
    (f callable) the residual with its norm (the route's final residual) and
    without (a refinement residual), from the route's own strided views of
    the interleaved system, beside CSR ``torch.mv`` on the same Laplacian;
    on the 3×2000 lattice's 1-D multigrid, one Chebyshev step and the normed
    residual of level 0, and the executor (CUDA events, a solve); each with
    :func:`timed_call`'s figures.  Takes either port's interface: a
    ``ShiftPlan``, or the host offsets."""
    from networks_fenicsx_tpu_torch import lattice
    from networks_fenicsx_tpu_torch.kernels import edge_data, peel, segsum, shift_matvec
    from networks_fenicsx_tpu_torch.multigrid import ShiftOperator

    out = {}
    asm = chip_smoke.lattice_assembler(P, forms=chip_smoke.lattice_callable_forms)
    ex = build_schur_executor(asm, P.SolverOptions(schur_method="dct"), device=dev)
    dlp = ex.device_plan
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    Rm, fm, f_zero = asm.coefficient_modes()
    ed = edge_data.edge_data_plain(dlp, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi, R, f, Rm,
                                   fm, f_zero, sp, ep)
    dr, w_edges, _ = peel.lambda_system_plain(dlp, ed)
    n_cls = dlp.offsets.size
    cw = lattice._shift_class_weights(w_edges, dlp.class_idx, n_cls, segsum.segsum_plain)
    diag, rhs = dr[:, 0], dr[:, 1]
    B = diag.shape[0]
    lam = torch.randn(B, generator=torch.Generator(device=dev).manual_seed(18), dtype=torch.float64,
                      device=dev)
    classes = getattr(dlp, "shift", None) or dlp.offsets
    L = chip_smoke.lattice_csr(dlp.offsets, cw, diag)
    nbytes = chip_smoke.tensor_bytes(cw, dr, lam) + 8 * B + 4 * n_cls
    normed = timed_call(lambda: shift_matvec.shift_matvec(classes, cw, diag, lam, rhs, norm=True))
    normed.update(chip_smoke.bound(nbytes, (2 + 2 * n_cls) * B))
    out["k18_normed_lattice512"] = normed
    out["k18_residual_lattice512"] = timed_call(
        lambda: shift_matvec.shift_matvec(classes, cw, diag, lam, rhs))
    out["k18_library_csr_mv_lattice512"] = timed_call(lambda: torch.mv(L, lam))
    del ex, L

    opts = P.SolverOptions(schur_method="cg", cg_precond="mg")
    skinny = chip_smoke.lattice_assembler(P, 3, 2000, forms=chip_smoke.skinny_forms)
    cg_ex, d1, rhs1, _, cw1 = chip_smoke.cg_system(P, skinny, dev, opts)
    op = ShiftOperator(cg_ex.precond_plan.levels[0].shift, cw1, d1)  # level 0's smoother step
    s = 1.0 / torch.sqrt(d1)
    x_in, x_out, dvec = lam[: d1.shape[0]].clone(), torch.empty_like(d1), torch.ones_like(d1)
    out["k18_cheb_step_skinny"] = timed_call(
        lambda: op.step(s, rhs1, dvec, x_in, x_out, 0.7, 0.3))
    out["k18_normed_skinny"] = timed_call(lambda: op.residual(rhs1, x_in, norm=True))
    solver = P.Solver(skinny, options=opts, device="cuda")
    solver.solve()
    args = solver._executor.prepare_args(*skinny.schur_arguments())
    out["skinny_executor"] = {"ms": chip_smoke.cuda_ms(lambda: solver._executor(*args), reps=3,
                                                        warmup=1),
                              "iterations": solver.info.iterations}
    return out


def lattice_times(dev) -> dict:
    """K16 and K17 on the 512² lattice's grid route (chip_smoke's inputs):

    * K16 — the solve as ``chip_smoke.py`` times it (the refinement
      residuals a fixed tensor), and one pass's four products alone, each
      with its device µs and launches by kernel name (one call, the
      profiler), the host µs of a synchronised call and of a call issued
      back to back (dispatch), and the host count of launches where the
      port gives one (``dct_lattice.cuda_launches``); beside three
      ``lplus_plain`` calls (12 ``torch.matmul``);
    * K17 — the stencil without and with its norm and the assembly, the
      same figures, beside CSR ``torch.mv`` on the same Laplacian
      (``chip_smoke.lattice_csr_grid``)."""
    from networks_fenicsx_tpu_torch.kernels import condense, dct_lattice, grid_core

    asm = chip_smoke.lattice_assembler(P)
    ex = build_schur_executor(asm, P.SolverOptions(schur_method="dct"), device=dev)
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    Rm, fm, _ = asm.coefficient_modes()
    gdp, op = ex.device_plan, ex.operator
    W, w, g, Ftot, const = condense.condense_plain(gdp.plan, ex._N, ex._k, ex._h_e, R, f, Rm, fm,
                                                   sp, ep)
    rhs, diag, _ = grid_core.grid_core_plain(gdp, w, const, Ftot)
    gen = torch.Generator(device=dev).manual_seed(1)
    lam_any = torch.randn(op.B, generator=gen, dtype=torch.float64, device=dev)
    fixed = grid_core.grid_residual_plain(gdp, w, diag, lam_any, rhs)
    state = dct_lattice.factor_plain(op, w)
    L = chip_smoke.lattice_csr_grid(gdp, w, diag)

    timed = timed_call
    count = getattr(dct_lattice, "cuda_launches", None)
    k16 = {"solve": timed(lambda: dct_lattice.dct_lattice(op, w, rhs, lambda _: fixed), reps=10),
           "one_pass_products": timed(lambda: dct_lattice._lplus(op, state, rhs)),
           "library_12_matmul": timed(
               lambda: [dct_lattice.lplus_plain(op, state, rhs) for _ in range(3)], reps=10),
           "cuda_launches": None if count is None else count(op)}
    k17 = {"stencil": timed(lambda: grid_core.grid_residual(gdp, w, diag, lam_any, rhs)),
           "stencil_norm": timed(lambda: grid_core.grid_residual(gdp, w, diag, lam_any, rhs,
                                                                 norm=True)),
           "assembly": timed(lambda: grid_core.grid_core(gdp, w, const, Ftot)),
           "library_csr_mv": timed(lambda: torch.mv(L, lam_any)),
           "cuda_launches": getattr(grid_core, "cuda_launches", lambda: None)()}
    return {"k16_lattice512": k16, "k17_lattice512": k17}


def device_split(fn, reps: int = 3) -> dict:
    """Device µs and launches of one ``fn()`` call by kernel name
    (``torch.profiler``, the mean of ``reps`` calls after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            acc = split.setdefault(name, [0.0, 0.0])  # a template's instances under one name
            acc[0] += us / reps
            acc[1] += ev.count / reps
    return dict(sorted(split.items(), key=lambda kv: -kv[1][0]))


def factor_profile(path: str, generations: int, reps: int, card: str) -> dict:
    """``--path factor-*``: ``Solver.factorize()`` on the configuration (on a
    forced core plan, ``build_tree_factorization`` and its factor), then
    its factor, apply, rhs-only solve and the fused executor on the same
    forms, each by :func:`device_split` (device µs and launches by kernel,
    summed by source) and its best host ms; the rhs-only ``compute_forms``
    + ``Solver.solve()`` loop, factorized (on one read-only R, and on a new
    R array a call, which each solve hashes) and fused."""
    base, kind = FACTOR_PATHS[path]
    asm, _, options, tree_plan = configure(base, generations)
    rhs_forms = chip_smoke.factor_rhs_forms(kind)
    rhs_forms(asm, 0)
    if tree_plan is not None:  # a forced core plan: the factorization class and the executor
        from networks_fenicsx_tpu_torch.factorization import build_tree_factorization

        t0 = sync_clock()
        fac = build_tree_factorization(asm, options, device="cuda", _tree_plan=tree_plan)
        state = fac.factor(asm.schur_arguments(device=False)[0])
        factorize_ms = (sync_clock() - t0) * 1e3
        ex = build_schur_executor(asm, options, device="cuda", _tree_plan=tree_plan)
        rhs_forms(asm, 1)
    else:
        solver = P.Solver(asm, device="cuda")
        fused = P.Solver(asm, device="cuda")
        t0 = sync_clock()
        solver.factorize()
        factorize_ms = (sync_clock() - t0) * 1e3
        fac, state = solver._factorization[:2]
        rhs_forms(asm, 1)
        solver.solve()
        fused.solve()
        assert solver.info.method == "schur_factorized", solver.info
        ex = fused._executor
    args = asm.schur_arguments()
    rhs_args = fac.prepare_rhs(*args[1:])
    ex_args = ex.prepare_args(*args)
    rec = {"card": card, "path": path, "factorization": type(fac).__name__,
           "executor": type(ex).__name__, "dofs": asm.num_dofs, "factorize_ms": factorize_ms}
    for name, fn in (("factor", lambda: fac.factor(args[0])),
                     ("apply", lambda: fac.solve_prepared(state, rhs_args)),
                     ("solve", lambda: fac.solve(state, *args[1:])),
                     ("fused", lambda: ex(*ex_args))):
        split = device_split(fn, reps)
        rec[name] = {"device_us": sum(us for us, _ in split.values()),
                     "launches": sum(n for _, n in split.values()),
                     "best_ms": best_ms(fn, reps=10), "by_source": by_source(split),
                     "by_kernel": split}
    if tree_plan is not None:  # no Solver on a forced plan: the rhs-only loop is the class's
        times = []
        for i in range(reps):
            t0 = sync_clock()
            rhs_forms(asm, 2 + i)
            fac.solution_vector(fac.solve(state, *asm.schur_arguments(device=False)[1:]))
            times.append((sync_clock() - t0) * 1e3)
        rec["rhs_only_factorized_ms"] = times
        return rec
    new_R = chip_smoke.factor_rhs_forms(kind, fresh_R=True)
    for name, forms, s in (("rhs_only_factorized_ms", rhs_forms, solver),
                           ("rhs_only_factorized_new_R_ms", new_R, solver),
                           ("rhs_only_fused_ms", rhs_forms, fused)):
        times = []
        for i in range(reps):
            t0 = sync_clock()
            forms(asm, 2 + i)
            s.solve()
            times.append((sync_clock() - t0) * 1e3)
        rec[name] = times
    assert solver.info.method == "schur_factorized", solver.info
    return rec


def k11_times(n: int, dev) -> dict:
    """K11 at ``n`` nodes (chip_smoke's seeded Laplacian): the whole call,
    its assembly and factor alone (``dense_factor``), the refined solve as
    their difference, the device split by kernel name, beside
    ``torch.linalg.cholesky`` and ``cholesky_solve`` on the same matrix."""
    from networks_fenicsx_tpu_torch.kernels import dense_core

    ms = chip_smoke.cuda_ms
    args = chip_smoke.spd_laplacian(n, dev, seed=n)
    ci, cj, pid, dc, rc, w = args
    Lc = dense_core.assemble_core(ci, cj, pid, dc, w)
    Lf = torch.linalg.cholesky(Lc)
    rec = {"ms": ms(lambda: dense_core.dense_core(*args), reps=10),
           "factor_ms": ms(lambda: dense_core.dense_factor(ci, cj, pid, dc, w), reps=10),
           "library_factor_ms": ms(lambda: torch.linalg.cholesky(Lc), reps=10),
           "library_solve_ms": ms(lambda: torch.cholesky_solve(rc[:, None], Lf), reps=10)}
    rec["refined_solve_ms"] = rec["ms"] - rec["factor_ms"]
    rec["library_ms"] = rec["library_factor_ms"] + rec["library_solve_ms"]
    split = device_split(lambda: dense_core.dense_core(*args))
    rec["device_us_by_kernel"] = split
    rec["device_us"] = sum(us for us, _ in split.values())
    rec["device_launches"] = sum(c for _, c in split.values())
    rec["cuda_launches"] = dense_core.cuda_launches(n, int(ci.shape[0]))
    return rec


def reduce_times(dev) -> dict:
    """K22-reduce on the sharded web's shape (4 × 222,643 partials) beside
    ``torch.sum(dim=0)``: its time, its host µs a synchronised call and a
    call issued back to back (dispatch), bit-equality."""
    from networks_fenicsx_tpu_torch.kernels import shard_top

    gen = torch.Generator(device=dev).manual_seed(22)
    parts = torch.randn((4, 222_643), generator=gen, dtype=torch.float64, device=dev)
    return {"equal": bool(torch.equal(shard_top.reduce(parts), shard_top.reduce_plain(parts))),
            "ms": chip_smoke.cuda_ms(lambda: shard_top.reduce(parts)),
            "library_ms": chip_smoke.cuda_ms(lambda: torch.sum(parts, dim=0)),
            "wrapper_us": best_ms(lambda: shard_top.reduce(parts)) * 1e3,
            "library_us": best_ms(lambda: torch.sum(parts, dim=0)) * 1e3,
            "dispatch_us": dispatch_us(lambda: shard_top.reduce(parts)),
            "library_dispatch_us": dispatch_us(lambda: torch.sum(parts, dim=0))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("blocked", "callable", "forest", "web", "web1000", "bed",
                                       "lattice", "lattice-callable", "web2k", "lattice64",
                                       "fronts128", "cg512", "web-cg", "skinny-mg",
                                       *GENERIC_PATHS, *SHARDED_PATHS, *FACTOR_PATHS),
                    default="blocked")
    ap.add_argument("--generations", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--kernels", action="store_true",
                    help="time the redesigned kernels (K21b, K10, K12a, K11, K12b, K19c's coarsest "
                         "level, K22-reduce, K16, K17) beside their library calls instead of a path")
    ap.add_argument("--select", choices=("all", "lattice", "redesign", "krylov", "mf", "windows",
                                         "mg1d", "dist", "level", "gather", "fronts", "tsolve",
                                         "blocked", "core", "peel", "edge", "shards", "strips",
                                         "condense"),
                    default="all",
                    help="with --kernels: every entry, K16 and K17 alone, K6, K19c, K21a, K18, "
                         "K19a and K19e alone, K19a and K19e alone, K13-K15 on the web, "
                         "chip_smoke's launch-count cases in 20 profiler windows each, K19d on "
                         "skinny-mg, K22c on the sharded forest, K7 on the forest and callable "
                         "paths, K19b on web-cg, the tiled Cholesky's kernels (K12b on fronts128, "
                         "K11 at 455 and 4,096, K19c's coarsest factor) by launch kind, the T "
                         "solve on the sharded forest's and a 7-node T, K2-K4 on the headline and "
                         "the sharded tree's shards, K12a on web2k, fronts128 and web48's forced "
                         "plans, K9 on the 100k web, web1000 and the star, K8a on the callable "
                         "tree, set (c)'s k = 3 forest and the callable-f lattice, K22a on the "
                         "sharded tree, K22b and K1 on the sharded lattice, or K1 on the headline, "
                         "the sharded tree and the sharded lattice")
    ap.add_argument("--diff", type=pathlib.Path, nargs=2, default=None, metavar=("A", "B"),
                    help="compare the vectors of two --select mf, mg1d, level or gather --out runs (.npz) "
                         "and exit")
    ap.add_argument("--root", type=pathlib.Path, default=None,
                    help="import the port from this checkout instead of this one")
    args = ap.parse_args()
    if args.diff is not None:
        print(json.dumps(vector_diffs(*args.diff), indent=1))
        return 0
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if args.kernels:
        if args.select != "all":
            times = {"lattice": lattice_times, "redesign": redesign_times,
                     "krylov": krylov_times, "mf": mf_times, "windows": window_probe,
                     "mg1d": mg1d_times, "dist": dist_times, "level": level_times,
                     "gather": gather_times, "fronts": fronts_times,
                     "tsolve": tsolve_times, "blocked": blocked_times,
                     "core": core_times, "peel": peel_times, "edge": edge_times,
                     "shards": shard_times, "strips": strip_times,
                     "condense": condense_times}[args.select]
            rec = {"card": card, "port": str(pathlib.Path(P.__file__).resolve().parent),
                   **times(torch.device("cuda", 0))}
        else:
            rec = kernel_times(card)
        vectors = rec.pop("_vectors", None)
        if vectors is not None and args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            np.savez(args.out.with_suffix(".npz"), **vectors)
        text = json.dumps(rec, indent=1)
        print(text)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(text)
        return 0

    if args.path in FACTOR_PATHS:
        text = json.dumps(factor_profile(args.path, args.generations, args.reps, card), indent=1)
        print(text)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(text)
        return 0
    asm, forms, options, tree_plan = configure(args.path, args.generations)
    if args.path in SHARDED_PATHS:
        from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

        solver = ShardedNetworkSolver(asm, devices=["cuda:0"] * SHARDED_PATHS[args.path])
        solver.assemble()
    else:
        solver = P.Solver(asm, options=options, device="cuda")
    if tree_plan is not None:  # the forced plan's executor, as the reference's tests build it
        solver._executor = build_schur_executor(asm, options, device="cuda", _tree_plan=tree_plan)
        solver._executor_key = asm.coefficient_modes()
    t0 = sync_clock()
    solve_once(solver, args.path)  # builds the kernels and the executor
    first_ms = (sync_clock() - t0) * 1e3

    if args.path in GENERIC_PATHS:
        runs = [generic_phases(asm, solver, forms, args.path) for _ in range(args.reps)]
    elif args.path in SHARDED_PATHS:
        runs = [sharded_split(asm, solver, forms) for _ in range(args.reps)]
    else:
        runs = [phases(asm, solver, forms) for _ in range(args.reps)]
    best = {k: min(r[k] for r in runs) for k in runs[0]}

    cg_loop.cg.flag_reads = 0
    cg_loop.minres.flag_reads = 0
    solve_ms = []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            t0 = sync_clock()
            solve_once(solver, args.path)
            solve_ms.append((sync_clock() - t0) * 1e3)
    device_us: dict[str, float] = {}
    launches: dict[str, float] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            device_us[ev.key] = us / args.reps
            launches[ev.key] = ev.count / args.reps
    busy_ms = sum(device_us.values()) / 1e3
    mean_solve = float(np.mean(solve_ms))
    by_source: dict[str, list[float]] = {}
    sources = kernel_sources()
    for key, us in device_us.items():
        name = key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
        # a template's key starts with its return type
        name = (name.split("::")[-1].split() or [""])[-1]
        src = "copies" if key.startswith("Memcpy") else sources.get(name, "PyTorch")
        acc = by_source.setdefault(src, [0.0, 0.0])
        acc[0] += us
        acc[1] += launches[key]
    result = {
        "card": card,
        "path": args.path,
        "executor": (type(solver._executor).__name__ if args.path not in SHARDED_PATHS
                     else f"{solver.info.method} on {solver.device_mesh.D} shards"),
        "dofs": asm.num_dofs,
        "first_solve_ms": first_ms,
        "phase_best_ms": best,
        "solve_ms_profiled": solve_ms,
        "device_us_per_solve": dict(sorted(device_us.items(), key=lambda kv: -kv[1])),
        "device_launches_per_solve": launches,
        "device_launches_total_per_solve": sum(launches.values()),
        "device_us_and_launches_per_source": dict(
            sorted(by_source.items(), key=lambda kv: -kv[1][0])),
        "device_busy_ms_per_solve": busy_ms,
        "device_idle_share": 1.0 - busy_ms / mean_solve if mean_solve else None,
    }
    if args.path in ("p1tree", "minres"):
        loop = cg_loop.cg if args.path == "p1tree" else cg_loop.minres
        result["iterative"] = {"method": solver.info.method, "iterations": solver.info.iterations,
                               "chunk": cg_loop.CHUNK,
                               "flag_reads_per_solve": loop.flag_reads / args.reps,
                               "residual": solver.info.residual, "tolerance": loop.last_tol}
    if isinstance(getattr(solver, "_executor", None), _CgExecutor):
        result["cg"] = {"iterations": solver.info.iterations, "chunk": cg_loop.CHUNK,
                        "flag_reads_per_solve": cg_loop.cg.flag_reads / args.reps,
                        "preconditioner": solver._executor.precond_kind[0]}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
