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
  reference's nested-dissection plan and forced supernodal fronts (K12b),
  through the tree executor the reference's own tests force plans into;
* the iterative λ solve under ``schur_method="cg"``: the 512² lattice with
  per-edge R (1,831,942 dofs; conjugate gradients with the 2-D aggregation
  multigrid, K19a + K18 + K19c) and the 100k-site web (2,817,749 dofs;
  Chebyshev-Jacobi on the gather-fold matvec, K19a + K19b), then the
  3×2000 lattice's 1-D multigrid (K19d) and the 128² lattice under
  Chebyshev and Jacobi.

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
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

GENERATIONS = 16
N_CELLS = 40
DOFS = 5_341_102
TOL = 1e-12  # kernel vs plain and port vs plain, times max(1, max |plain|)
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
K11_SIZES = (455, 628, 2_048, 4_096, 8_192)  # K11 alone, set (j)
K11_TIMED = 4_096  # the kernels line's K11 shape: the 64² lattice's dense core
EPS = float(np.finfo(np.float64).eps)

# the iterative λ solve: the 512² lattice with per-edge R under schur_method="cg"
# (tests/test_krylov.py:214-223 at 512²) takes the 2-D multigrid (B > 32,768)
CG512_SIZES = {"edges": 523_266, "bifurcations": 262_144, "dofs": 1_831_942,
               "precond": "2d", "levels": 5, "bottom": (16, 16)}
CG512_MAX_ITERS = 20  # the reference's own bound (tests/test_krylov.py:240-245)
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
}
# the checks of each iterative wrapper in the kernels-cg sets (k)-(m), and the
# set whose record times it
CG_CHECKS = {
    "krylov": ("k", ("krylov_cg_step", "krylov_chebyshev")),
    "gather_matvec": ("k", ("gather_matvec", "gather_matvec_residual")),
    "mg2d": ("l", ("mg2d_hierarchy", "mg2d_stencil", "mg2d_restrict", "mg2d_prolong",
                   "mg2d_coarse_factor", "mg2d_coarse_solve", "mg2d")),
    "mg1d": ("m", ("mg1d_hierarchy", "mg1d_restrict", "mg1d_prolong", "mg1d")),
}
# the checks of each lattice wrapper in the kernels-lattice sets
LATTICE_CHECKS = {
    "dct_lattice": ("dct_factor", "dct_forward", "dct_inverse", "dct_lplus",
                    "dct_lattice_unrefined", "dct_lattice", "dct_matrix"),
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
    "dense_lu": (("q", "dense_lu"), ("q", "dense_lu_saddle")),
    "minres": (("r", "minres"),),
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


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(3):
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


def tensor_bytes(*objs) -> int:
    """Bytes of the tensors in ``objs`` (tensors, or nested tuples/lists of them)."""
    total = 0
    for x in objs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += tensor_bytes(*x)
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


def forest_forms(asm, f_kind: str = "cell") -> None:
    """Per-edge R and per-cell (or scalar) f from ``default_rng(0)``, p_bc = x."""
    mesh = asm.network
    rng = np.random.default_rng(0)
    R = rng.uniform(0.5, 2.0, mesh.num_edges)
    f = rng.uniform(-1.0, 1.0, mesh.num_cells) if f_kind == "cell" else 0.3
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R, f=f)


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
        "tree_sweep": (tensor_bytes(w, const, Ftot, dp.bif_in, dp.bif_out, dp.bif_child,
                                    dp.bif_parent, s_plain), 16 * B + 4 * dp.bif_out.numel()),
        "expand": (tensor_bytes(lam, sp, ep, W, w, g, Ftot, h, R, f, ends, x_plain),
                   10 * (k * N + 1) * E),
    }
    record = {}
    for name, (kernel, plain, want) in runs.items():
        got = kernel()
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        assert err <= TOL * scale, (name, err, scale)
        record[name] = {"max_abs_err": err, "scale": scale}
        if timed:
            record[name]["ms"] = cuda_ms(kernel)
            record[name]["plain_ms"] = cuda_ms(plain)
            record[name].update(bound(*work[name]))
    return record


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
    log(f"phase timing: compute_forms+solve best {min(times):.3f} ms "
        f"(all {[round(t, 3) for t in times]}); device per solve (upload + kernels) "
        f"{dev_ms:.3f} ms, plain versions {plain_ms:.3f} ms; card {name_power}")
    return {"best_ms": min(times), "device_ms": dev_ms, "plain_ms": plain_ms}


def compare_level_kernels(P, asm, device, timed: bool) -> dict:
    """Each general-forest kernel against its plain version on the inputs
    the level executor gives it, on the card."""
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

    def sums(fn):
        return lambda: (fn(dlp.p_idx, w), fn(dlp.t_idx, vt), fn(dlp.s_idx, vs))

    runs = {
        "edge_data": (lambda: edge_data.edge_data(*e_args),
                      lambda: edge_data.edge_data_plain(*e_args)),
        "segsum": (sums(segsum.segsum), sums(segsum.segsum_plain)),
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
    for name, (kernel, plain) in runs.items():
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        assert err <= TOL * scale, (name, err, scale)
        record[name] = {"max_abs_err": err, "scale": scale}
        if timed:
            record[name]["ms"] = cuda_ms(kernel)
            record[name]["plain_ms"] = cuda_ms(plain, reps=5)
            record[name].update(bound(*work[name]))
            if name in library:
                record[name]["library_ms"] = cuda_ms(library[name])
    q_T, p_T, finite = backsub.backsub(ed, lam, N, k)
    assert bool(finite), "backsub: non-finite solution"
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
    cuda_launches = 2 + level_eliminate.cuda_launches(ex.device_plan)
    log(f"phase timing {label}: compute_forms+solve best {min(times):.3f} ms "
        f"(all {[round(t, 3) for t in times]}); device per solve (upload + kernels) "
        f"{dev_ms:.3f} ms, plain versions {plain_ms:.3f} ms; launches per solve "
        f"{wrapper_launches} wrapper calls, {cuda_launches} CUDA kernels; card {name_power}")
    return {"best_ms": min(times), "device_ms": dev_ms, "plain_ms": plain_ms,
            "cuda_launches": cuda_launches}


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


def compare_cyclic_kernels(P, asm, device, timed: bool, force_mf_leaf: int | None = None) -> dict:
    """Each cyclic kernel against its plain version on the inputs the tree
    executor gives it, on the card: the bifurcation system (K9 with K6),
    the round folds (K10), the peel rounds around one plain core solve (K9),
    the dense core (K11) where the core has at most 512 nodes, and the
    multifrontal factor and apply (K13–K15) where there is a multifrontal
    plan (``force_mf_leaf`` forces one on a small core, as ``_tree_plan=``
    does).  The refined core solutions are held at ``CYCLIC_TOL``, the rest
    at ``TOL``; so are the unrefined ones (``*_unrefined``: no refinement
    pass, which would hide an error of the factor or the sweeps), K15's on
    the kernel's own factor, so that only the sweeps differ."""
    from networks_fenicsx_tpu_torch import levels
    from networks_fenicsx_tpu_torch.kernels import (
        dense_core, edge_data, fold, mf_apply, mf_factor, peel, segsum,
    )
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

    def fold_all(fn):
        return lambda: [fn(v, lv) for lv, v in folds]

    runs = {
        "lambda_system": (lambda: peel.lambda_system(dtp, ed),
                          lambda: peel.lambda_system_plain(dtp, ed), TOL),
        "fold_apply": (fold_all(fold.fold_apply), fold_all(fold.fold_apply_plain), TOL),
        "peel": (lambda: peel.peel(dtp, dr, w_pairs, plain_core),
                 lambda: peel.peel_plain(dtp, dr, w_pairs, plain_core), TOL),
    }
    # K9 is timed around a trivial core solve, so that the time is the rounds'
    timed_runs = {"peel": (lambda: peel.peel(dtp, dr, w_pairs, jacobi_core),
                           lambda: peel.peel_plain(dtp, dr, w_pairs, jacobi_core))}
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
              "groups": None if dmf is None else len(dmf.plan.groups)}
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
    return record


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
                                dmf.cidx_all, dmf.lminv_all, dmf.consume)
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
                + (("fold_apply",) if ce.rounds else ())
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
    assert launches["fold_apply"] >= 1 or not dtp.rounds, launches

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


def grid128_assembler(P):
    """The 128² lattice at N = 1 with :func:`grid128_forms`."""
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(
        P.network_generation.make_grid(128, 128, arrays=True), N=1, color_strategy="fast"))
    grid128_forms(asm)
    return asm


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


def compare_core_kernels(P, asm, device, timed: bool, tree_plan=None, expect=None) -> dict:
    """K12a (:mod:`core_elim`), K12b (:mod:`core_fronts`) and K11 on a dense
    tail against their plain versions on the inputs the tree executor gives
    the core (``tree_plan`` forces a plan, as the reference's tests do): the
    whole core solve, refined and with one unrefined tail pass, at 1e-12·scale
    where the tail has at most 628 nodes and there are no fronts, at
    1e-10·scale otherwise; the fronts alone and the dense tail alone on
    their own inputs; the tail's factor backward error from 2,048 nodes.
    Timed: K12a on the rounds alone (with their K10 folds, the tail left
    out), K12b on the fronts alone, K11 on the tail."""
    from networks_fenicsx_tpu_torch.kernels import (
        core_elim, core_fronts, dense_core, edge_data, fold, peel, segsum,
    )
    from networks_fenicsx_tpu_torch.solver import _TreeExecutor, build_schur_executor

    opts = P.SolverOptions(schur_method="tree") if tree_plan is not None else P.SolverOptions()
    ex = build_schur_executor(asm, opts, device=device, _tree_plan=tree_plan)
    assert isinstance(ex, _TreeExecutor), type(ex)
    dtp = ex.device_plan
    dcp = dtp.ce
    assert dcp is not None, "no min-degree core plan"
    sizes = {"core": dtp.core_size, **core_sizes(dtp)}
    for key, want in (expect or {}).items():
        assert sizes[key] == want, (key, sizes[key], want)
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
    n_tail = int(dcp.dense_nodes.shape[0])
    tol = TOL if n_tail <= 628 and not dcp.fronts else CYCLIC_TOL
    runs = {
        "core_elim": (lambda: core_elim.core_elim(dcp, dc, w_pairs, rc),
                      lambda: core_elim.core_elim_plain(dcp, dc, w_pairs, rc), tol),
    }
    if n_tail:
        runs["core_elim_unrefined"] = (
            lambda: core_elim.core_elim(dcp, dc, w_pairs, rc, n_refine=0),
            lambda: core_elim.core_elim_plain(dcp, dc, w_pairs, rc, n_refine=0), tol)
    # the rounds' outputs (plain), the inputs of the fronts and of the tail
    st = core_elim.core_factor_plain(dcp, dc, w_pairs)
    r_fw = rc.clone()
    zero = torch.zeros(1, dtype=torch.float64, device=device)
    for rd, (a, inv) in zip(dcp.rounds, st.rounds):
        rv = r_fw[rd.elim.long()]
        s_ = fold.fold_apply_plain(((a * inv[:, None]) * rv[:, None]).reshape(-1), rd.d_fold)
        r_fw = r_fw - torch.cat([s_, zero])[rd.d_inv.long()]
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


def lattice_wide(P):
    """``make_grid(5000, 3)`` at N = 1, f = 0.3, R = 1.7: a side above 4,096,
    whose DCT-II matrix is generated on the device."""
    def forms(asm):
        asm.compute_forms(p_bc_ex=lambda x: x[0] + 0.2 * x[1], f=0.3, R=1.7)
    return lattice_assembler(P, 5000, 3, forms=forms)


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
            return shift_matvec.shift_matvec(dlp.offsets, cw, diag_v, lam, rhs_v)

        def res_plain(lam):
            return shift_matvec.shift_matvec_plain(dlp.offsets, cw, diag_v, lam, rhs_v)

        runs["edge_data"] = (lambda: edge_data.edge_data(*e_args),
                             lambda: edge_data.edge_data_plain(*e_args), TOL)
        runs["lambda_system"] = (lambda: peel.lambda_system(dlp, ed),
                                 lambda: peel.lambda_system_plain(dlp, ed), TOL)
        runs["segsum"] = (
            lambda: lattice._shift_class_weights(w_edges, dlp.class_idx, n_cls, segsum.segsum),
            lambda: lattice._shift_class_weights(w_edges, dlp.class_idx, n_cls,
                                                 segsum.segsum_plain), TOL)
        runs["shift_matvec"] = (
            lambda: shift_matvec.shift_matvec(dlp.offsets, cw, diag_v, lam_any, rhs_v, norm=True),
            lambda: shift_matvec.shift_matvec_plain(dlp.offsets, cw, diag_v, lam_any, rhs_v,
                                                    norm=True), TOL)
        # the library yardstick: one CSR product with the same Laplacian
        L = lattice_csr(dlp.offsets, cw, dr[:, 0])
        library["shift_matvec"] = lambda: torch.mv(L, lam_any)
        timed_runs["shift_matvec"] = (lambda: res_kernel(lam_any), lambda: res_plain(lam_any))
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
    return record


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
    """The lattice slice: kernels-lattice sets (a)–(d), then the 512² main
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
    assert [lat[c]["route"] for c in "abcd"] == ["grid", "grid", "general", "grid"], lat
    del wide, D, D_plain

    paths = {}
    paths["dct"] = lattice_main_path(P, device, "lattice main path (schur_method='dct')",
                                     lambda: lattice_assembler(P),
                                     P.SolverOptions(schur_method="dct"), "grid")
    lattice_timing(P, paths["dct"], lattice_forms, "lattice (dct)", name_power)
    del paths["dct"]["asm"], paths["dct"]["solver"]
    paths["auto"] = lattice_main_path(P, device, "lattice main path (auto)",
                                      lambda: lattice_assembler(P), P.SolverOptions(), "grid")
    lattice_timing(P, paths["auto"], lattice_forms, "lattice (auto)", name_power)
    del paths["auto"]["asm"], paths["auto"]["solver"]

    paths["general"] = lattice_main_path(
        P, device, "lattice general-route main path",
        lambda: lattice_assembler(P, forms=lattice_callable_forms), P.SolverOptions(), "general",
        source=lattice_source)
    lattice_timing(P, paths["general"], lattice_callable_forms, "lattice (general)", name_power)
    del paths["general"]["asm"], paths["general"]["solver"]
    return {"sets": lat, "paths": paths}


def core_phases(P, device, name_power: str) -> dict:
    """The mid-size cycle-core slice: kernels-core sets (f)–(i) and the
    web48 golden's forced plans, set (j) K11 alone, the web2k and 64²
    lattice main paths, and the forced paths that run K12b and the forced
    web48 plans end to end."""
    core = {}
    core["f"] = compare_core_kernels(P, web2k_assembler(P), device, timed=True,
                                     expect={k: WEB2K_SIZES[k] for k in BED4_SIZES})
    log("phase kernels-core (f) web2k, N=1, edge R, min-degree rounds + dense tail 628: "
        + json.dumps(core["f"]))
    core["g"] = compare_core_kernels(P, bed_assembler(P, 4, 32, 20, N=1), device, timed=False,
                                     expect=BED4_SIZES)
    log("phase kernels-core (g) bed (4, 32, 20), N=1, R=1/r^4: " + json.dumps(core["g"]))
    grid = grid128_assembler(P)
    t0 = time.perf_counter()
    plan_h = nd_tree_plan(P, grid, **ND_KWARGS)
    t_h = time.perf_counter() - t0
    core["h"] = compare_core_kernels(P, grid, device, timed=True, tree_plan=plan_h,
                                     expect=GRID128_ND_SIZES)
    log(f"phase kernels-core (h) 128^2 edge-R lattice, ND plan (host planning {t_h:.3f} s), "
        "dense tail 7,583: " + json.dumps(core["h"]))
    t0 = time.perf_counter()
    plan_i = nd_tree_plan(P, grid, **FRONTS_KWARGS)
    t_i = time.perf_counter() - t0
    core["i"] = compare_core_kernels(P, grid, device, timed=True, tree_plan=plan_i,
                                     expect=GRID128_FRONTS_SIZES)
    log(f"phase kernels-core (i) 128^2 edge-R lattice, forced fronts (host planning {t_i:.3f} s): "
        + json.dumps(core["i"]))
    web48 = golden_web48(P)
    for key, plan in forced_plans_web48(P, web48).items():
        core["web48-" + key] = compare_core_kernels(P, web48, device, timed=False, tree_plan=plan)
        log(f"phase kernels-core web48 golden, forced {key} plan: " + json.dumps(core["web48-" + key]))

    k11 = compare_dense_sizes(device, timed=True)
    log("phase kernels-dense (j) K11 alone on seeded SPD Laplacians: "
        + json.dumps({str(n): rec for n, rec in k11.items()}))

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
    return {"sets": core, "k11": k11, "paths": paths}


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


def compare_krylov_kernels(P, asm, device) -> dict:
    """Set (k): K19a and K19b against their plain versions on the web's λ
    system: one K19b matvec and residual, one Chebyshev-Jacobi application
    (degree 8) on it, one CG step pair from the same state; all at
    ``TOL``·scale.  Timed: the K19b matvec (CSR ``torch.mv`` beside it) and
    the CG step pair's K19a launches on fixed vectors (tol 0, so that no
    update stops)."""
    from networks_fenicsx_tpu_torch.kernels import gather_matvec, krylov
    from networks_fenicsx_tpu_torch.multigrid import GatherOperator
    from networks_fenicsx_tpu_torch.ops.krylov import chebyshev_preconditioner

    ex, diag, rhs, w, _ = cg_system(P, asm, device, P.SolverOptions(schur_method="cg"))
    dlp = ex.device_plan
    assert dlp.classes is None and ex.precond_kind == ("chebyshev", 8), ex.precond_kind
    B = diag.shape[0]
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randn(B, generator=gen, dtype=torch.float64, device=device)
    tables = (dlp.mv_edge, dlp.mv_other)
    ops = {plain: GatherOperator(*tables, w, diag, plain) for plain in (False, True)}
    cheb = {plain: chebyshev_preconditioner(ops[plain].step, diag, degree=8, plain=plain)
            for plain in (False, True)}
    z0 = cheb[True](rhs)
    Ap0 = ops[True].apply(z0)

    def step_pair(plain: bool, maxiter: int = 100, rtol: float = 1e-12):
        start, ux, up = ((krylov.cg_start_plain, krylov.cg_update_x_plain, krylov.cg_update_p_plain)
                         if plain else (krylov.cg_start, krylov.cg_update_x, krylov.cg_update_p))
        st, part = krylov.new_state(device), krylov.partials(B, device)
        xx, r, p = torch.zeros_like(rhs), rhs.clone(), z0.clone()
        start(st, rhs, r, z0, part, rtol, 0.0, maxiter)

        def pair():
            ux(st, p, Ap0, xx, r, part)
            up(st, r, z0, p, part)
            return st[[0, 1, 2, 3, 5, 6, 7]], xx, r, p

        return pair

    runs = {
        "gather_matvec": (lambda: gather_matvec.gather_matvec(*tables, w, diag, x),
                          lambda: gather_matvec.gather_matvec_plain(*tables, w, diag, x), TOL),
        "gather_matvec_residual": (
            lambda: gather_matvec.gather_matvec(*tables, w, diag, x, rhs, norm=True),
            lambda: gather_matvec.gather_matvec_plain(*tables, w, diag, x, rhs, norm=True), TOL),
        "krylov_chebyshev": (lambda: cheb[False](rhs), lambda: cheb[True](rhs), TOL),
        "krylov_cg_step": (lambda: step_pair(False)(), lambda: step_pair(True)(), TOL),
    }
    K, E = dlp.mv_edge.shape[0], w.shape[0]
    valid = valid_entries(dlp.mv_edge, E)
    work = {
        # the tables, w, diag and x read, L x written; 2 operations an entry, 2 a row
        "gather_matvec": (tensor_bytes(dlp.mv_edge, dlp.mv_other, w, diag, x) + 8 * B,
                          2 * valid + 2 * B),
        # the pair reads p, Ap, x, r and z once and writes x, r and p once (the
        # second kernel's reads of r and p are the first's outputs), and the state
        "krylov_cg_step": (8 * 8 * B + 8 * 8, 12 * B),
    }
    L = gather_csr(dlp, w, diag)
    library = {"gather_matvec": lambda: torch.mv(L, x)}
    timed = {"gather_matvec": runs["gather_matvec"][:2],
             "krylov_cg_step": (step_pair(False, 10**9, 0.0), step_pair(True, 10**9, 0.0))}
    record = {"B": B, "K": K}
    run_checks(runs, record, timed, work, library)
    return record


def mg2d_levels(mod, cw, dirs, diag, plan) -> list:
    """The 2-D hierarchy of ``plan`` built with ``mod``'s wrappers (or plain versions)."""
    levels = [mod.level0(cw, dirs, diag)]
    for f, c in zip(plan.shapes, plan.shapes[1:] + (plan.bottom,)):
        levels.append(mod.coarsen(levels[-1], f, c))
    return levels


def compare_mg2d_kernels(P, asm, device) -> dict:
    """Set (l): K19c against its plain versions on the 512² per-edge-R
    lattice's λ system: the hierarchy, the level-0 stencil, a restriction, a
    prolongation, the coarsest factor (its lower triangle) and solve, one
    V-cycle application; all at ``TOL``·scale.  Timed: the V-cycle (no one
    PyTorch call computes it), the stencil beside a CSR ``torch.mv``, the
    coarsest factor and solve beside ``cholesky`` + ``cholesky_solve``."""
    from networks_fenicsx_tpu_torch.kernels import mg2d
    from networks_fenicsx_tpu_torch.multigrid import Mg2dPreconditioner

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

    def prolonged(fn):
        def run():
            xx = r.clone()
            fn(xx, shape, shape_c, rc, opts.mg_overcorrect)
            return xx
        return run

    coarse = (plan.bottom_offsets, bottom[:4], bottom[mg2d.FD])
    runs = {
        "mg2d_hierarchy": (lambda: mg2d_levels(mg2d, cw, plan.dirs, diag, plan),
                           lambda: mg2d_levels(pre[True].k, cw, plan.dirs, diag, plan), TOL),
        "mg2d_stencil": (lambda: mg2d.stencil(lev, shape, r, rhs),
                         lambda: mg2d.stencil_plain(lev, shape, r, rhs), TOL),
        "mg2d_restrict": (lambda: mg2d.restrict(r, shape, shape_c),
                          lambda: mg2d.restrict_plain(r, shape, shape_c), TOL),
        "mg2d_prolong": (prolonged(mg2d.prolong), prolonged(mg2d.prolong_plain), TOL),
        "mg2d_coarse_factor": (lambda: torch.tril(mg2d.coarse_factor(*coarse)),
                               lambda: mg2d.coarse_factor_plain(*coarse), TOL),
        "mg2d_coarse_solve": (lambda: mg2d.coarse_solve(pre[False].factor, rb),
                              lambda: mg2d.coarse_solve_plain(factor_p, rb), TOL),
        "mg2d": (lambda: pre[False](r), lambda: pre[True](r), TOL),
    }
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
    return record


def compare_mg1d_kernels(P, asm, device) -> dict:
    """Set (m): K19d against its plain versions on the 3×2000 lattice's λ
    system under ``cg_precond="mg"``: the hierarchy, a restriction and a
    prolongation and one V-cycle, all at ``TOL``·scale.  Timed: the V-cycle."""
    from networks_fenicsx_tpu_torch.kernels import mg1d
    from networks_fenicsx_tpu_torch.multigrid import Mg1dPreconditioner

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

    def hierarchy(mod):
        def run():
            extra, dis = mod.level0(cw, diag)
            out, c, e = [extra, dis], cw, extra
            for lvl in plan.levels:
                c, e, d, s = mod.coarsen(lvl, c, e)
                out += [c, e, d, s]
            return out
        return run

    def prolonged(fn):
        def run():
            xx = r.clone()
            fn(xx, ec, opts.mg_overcorrect)
            return xx
        return run

    runs = {
        "mg1d_hierarchy": (hierarchy(mg1d), hierarchy(pre[True].k), TOL),
        "mg1d_restrict": (lambda: mg1d.restrict(r, (B + 1) // 2),
                          lambda: mg1d.restrict_plain(r, (B + 1) // 2), TOL),
        "mg1d_prolong": (prolonged(mg1d.prolong), prolonged(mg1d.prolong_plain), TOL),
        "mg1d": (lambda: pre[False](r), lambda: pre[True](r), TOL),
    }
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
    t2 = time.perf_counter()
    sol = solver.solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t2
    launches = kernels.launches()
    reads = loop.cg.flag_reads
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
            "residual": info.residual, "tol": tol, "imbalance": imbalance, "qmax": qmax,
            "err": err, "best_ms": min(times), "executor_ms": ex_ms, "plain_ms": plain_s * 1e3}


def compare_schur_p_kernels(asm, ex, device) -> dict:
    """Set (o): K21a and K20b against their plain versions on the p1tree's
    own data at full width — the band factor (and the flux diagonal) and one
    A⁻¹ apply at ``TOL``·scale, J·v and Jᵀ·z at ``TOL``·scale, the Jacobi
    diagonal Σ J² / A_diag at 1e-14 relative; timed beside ``cholesky`` and
    ``cholesky_solve`` on the dense (E, m, m) blocks and CSR ``torch.mv``."""
    from networks_fenicsx_tpu_torch.kernels import csr, schur_p

    N, k, base, n_flux = ex._N, ex._k, ex.base, ex.n_flux
    E, m = base.shape[0], k * N + 1
    cm = asm._cell_mass_on(device)
    J, JT = ex.J.device_arrays, ex.JT.device_arrays
    n_red = ex.J.shape[0]
    gen = torch.Generator(device=device).manual_seed(5)
    v = torch.randn(n_flux, generator=gen, dtype=torch.float64, device=device)
    z = torch.randn(n_red, generator=gen, dtype=torch.float64, device=device)
    Lb, adiag = schur_p.schur_p_factor_plain(cm, base, N, k, n_flux)
    runs = {
        "schur_p_factor": (lambda: schur_p.schur_p_factor(cm, base, N, k, n_flux),
                           lambda: schur_p.schur_p_factor_plain(cm, base, N, k, n_flux), TOL),
        "schur_p_solve": (lambda: schur_p.schur_p_solve(Lb, base, N, k, v),
                          lambda: schur_p.schur_p_solve_plain(Lb, base, N, k, v), TOL),
        "csr_spmv": (lambda: csr.csr_spmv(*J, v), lambda: csr.csr_spmv_plain(*J, v), TOL),
        "csr_spmv_T": (lambda: csr.csr_spmv(*JT, z), lambda: csr.csr_spmv_plain(*JT, z), TOL),
    }
    record = {}
    td, td_plain = csr.csr_tdiag(*J, adiag), csr.csr_tdiag_plain(*J, adiag)
    rel = float(((td - td_plain).abs() / td_plain.abs()).max())
    assert rel <= 1e-14, rel
    record["csr_tdiag"] = {"max_abs_err": float((td - td_plain).abs().max()), "max_rel_err": rel,
                           "tol": 1e-14}
    # the library yardsticks on the same matrices: the dense blocks and their
    # dense factor, and J as a CSR tensor
    dofs = base.long()[:, None] + torch.arange(m, device=device)[None, :]
    dense = torch.zeros((E, m, m), dtype=torch.float64, device=device)
    li = k * torch.arange(N, device=device)[:, None] + torch.arange(k + 1, device=device)[None, :]
    cmv = cm.reshape(E, N, k + 1, k + 1)
    for j in range(N):
        dense[:, li[j][:, None], li[j][None, :]] += cmv[:, j]
    L_dense = torch.linalg.cholesky(dense)
    v_e = v[dofs][:, :, None]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        J_csr = torch.sparse_csr_tensor(J[0], J[1].long(), J[2], size=ex.J.shape)
        library = {
            "schur_p_factor": lambda: torch.linalg.cholesky(dense),
            "schur_p_solve": lambda: torch.cholesky_solve(v_e, L_dense),
            "csr_spmv": lambda: torch.mv(J_csr, v),
        }
        work = {
            "schur_p_factor": (tensor_bytes(cm, base, Lb, adiag), E * m * (k + 1) * (k + 2)),
            "schur_p_solve": (tensor_bytes(Lb, base) + 16 * n_flux, E * m * (4 * k + 2)),
            "csr_spmv": (csr_bytes(ex.J, n_flux), 2 * ex.J.nnz),
        }
        timed = {name: runs[name][:2] for name in library}
        run_checks(runs, record, timed, work, library)
    del dense, L_dense
    return record


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


def compare_dense_lu(P, device) -> dict:
    """Set (q): K21b on a random diagonally dominant matrix of order
    ``LU_N`` — pivots equal to the plain version's, factors at
    ``TOL``·scale, max |PA − LU| ≤ 8·n·ε·max |A| — and on the 8,033-dof
    saddle matrix of ``method="dense"`` (pivots equal, solve at
    ``TOL``·scale); timed beside ``lu_factor`` + ``lu_solve``."""
    from networks_fenicsx_tpu_torch.kernels import dense_lu

    record = {}
    gen = torch.Generator(device=device).manual_seed(4)
    n = LU_N
    A = torch.randn((n, n), generator=gen, dtype=torch.float64, device=device)
    A += n * torch.eye(n, dtype=torch.float64, device=device)
    b = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
    LU, piv = dense_lu.lu_factor(A)
    LU_p, piv_p = dense_lu.lu_factor_plain(A)
    assert torch.equal(piv, piv_p)
    err_f, scale_f = max_err(LU, LU_p)
    assert err_f <= TOL * scale_f, (err_f, scale_f)
    back = lu_residual(A, LU, piv)
    a_max = float(A.abs().max())
    assert back <= 8 * n * EPS * a_max, (back, a_max)
    x, x_p = dense_lu.lu_solve(LU, piv, b), dense_lu.lu_solve_plain(LU_p, piv_p, b)
    err_x, scale_x = max_err(x, x_p)
    assert err_x <= TOL * scale_x, (err_x, scale_x)
    record["dense_lu"] = {"max_abs_err": max(err_f, err_x), "errs": [err_f, err_x],
                          "scales": [scale_f, scale_x], "backward_error": back,
                          "backward_bound": 8 * n * EPS * a_max, "tol": TOL, "n": n}
    record["dense_lu"]["ms"] = cuda_ms(lambda: dense_lu.lu_solve(*dense_lu.lu_factor(A), b), reps=3)
    record["dense_lu"]["plain_ms"] = cuda_ms(
        lambda: dense_lu.lu_solve_plain(*dense_lu.lu_factor_plain(A), b), reps=1)
    record["dense_lu"]["library_ms"] = cuda_ms(
        lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor(A), b[:, None]), reps=3)
    record["dense_lu"].update(bound(3 * 8 * n * n + 4 * n + 16 * n, 2 * n, 2 * n**3 / 3 + 2 * n * n))

    asm = p1tree_assembler(P, 8, 10)
    assert asm.num_dofs == DENSE_DOFS, asm.num_dofs
    S, bs = asm.assemble(kind="dense", device=device)
    LU, piv = dense_lu.lu_factor(S)
    LU_p, piv_p = dense_lu.lu_factor_plain(S)
    assert torch.equal(piv, piv_p)
    xs, xs_p = dense_lu.lu_solve(LU, piv, bs), dense_lu.lu_solve_plain(LU_p, piv_p, bs)
    parts = [max_err(LU, LU_p), max_err(xs, xs_p)]
    for err, scale in parts:
        assert err <= TOL * scale, (err, scale)
    record["dense_lu_saddle"] = {"max_abs_err": max(e for e, _ in parts),
                                 "errs": [e for e, _ in parts], "scales": [sc for _, sc in parts],
                                 "tol": TOL, "n": DENSE_DOFS, "pivots_moved": int(
                                     (piv != torch.arange(DENSE_DOFS, device=device)).sum())}
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
    t0 = time.perf_counter()
    solver.assemble()
    solver.solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernels.launches()
    reads, tol = loop.minres.flag_reads, loop.minres.last_tol
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

    # one MINRES step pair (K19e) on the system's own vectors, timed
    n = asm.num_dofs
    gen = torch.Generator(device=device).manual_seed(6)
    vecs = [torch.randn(n, generator=gen, dtype=torch.float64, device=device) for _ in range(8)]
    b0 = vecs[0]

    def step_pair(plain: bool):
        alpha, update = ((krylov.minres_alpha_plain, krylov.minres_update_plain) if plain
                         else (krylov.minres_alpha, krylov.minres_update))
        start = krylov.minres_start_plain if plain else krylov.minres_start
        ms, part = krylov.minres_state(device), krylov.partials(n, device)
        v, yv, r1, r2, y, w, w2, x_ = (t.clone() for t in vecs)
        start(ms, b0, r2, r2, v, part, 0.0, 0.0, 100)
        alpha(ms, v, yv, r1, r2, part)
        update(ms, yv, y, v, w, w2, x_, part)
        return ms, v, yv, w, x_

    record = {}
    runs = {"minres": (lambda: step_pair(False), lambda: step_pair(True), TOL)}
    run_checks(runs, record, {}, {}, {})
    ms_k, ms_p = (cuda_ms(lambda: step_pair(plain), reps=10) for plain in (False, True))
    record["minres"].update({"ms": ms_k, "plain_ms": ms_p, "library_ms": None,
                             "note": "a start and one step pair (alpha, update), n = 2,422"})
    # the start reads b, r, y and writes v; the pair reads v, yv, r1, r2, y, w,
    # w2, x and writes yv, v, w, x
    record["minres"].update(bound(8 * n * 16, 30 * n))
    return {"launches": launches, "iters": info.iterations, "iters_plain": info_plain.iterations,
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
    log("phase kernels (16 gen, N=40, edge R, zero f, k=1): " + json.dumps(full))
    small = compare_kernels(
        P, arterial_assembler(P, 10, 8, k=2, per_cell=True, seed=3), device, timed=False
    )
    log("phase kernels (10 gen, N=8, cell R, cell f, k=2): " + json.dumps(small))

    state = main_path(P, device)
    timing(P, state, name_power)

    sets = {}
    sets["a"] = compare_level_kernels(P, callable_assembler(P), device, timed=True)
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

    del forest["asm"], forest["solver"]

    cyc = {}
    web = web_assembler(P)
    cyc["a"] = compare_cyclic_kernels(P, web, device, timed=True)
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
    cyc["e"] = compare_cyclic_kernels(P, web_assembler(P, sites=1_000), device, timed=True)
    log("phase kernels-cyclic (e) 1k web with anastomoses, N=8, edge R, cell f, k=2, dense core: "
        + json.dumps(cyc["e"]))
    assert (cyc["a"]["rounds"], cyc["a"]["core"], cyc["b"]["core"], cyc["c"]["core"]) == (
        18, 52_571, 6_206, 110)
    assert (cyc["e"]["rounds"], cyc["e"]["core"]) == (11, 455), cyc["e"]

    web = cyclic_main_path(P, device, "web main path", lambda: web_assembler(P), WEB_SIZES)
    cyclic_timing(P, web, forest_forms, "web", name_power)
    del web["asm"], web["solver"]
    bed = cyclic_main_path(P, device, "bed main path", lambda: bed_assembler(P), BED_SIZES)
    cyclic_timing(P, bed, bed_forms, "bed", name_power)

    web1000 = cyclic_main_path(P, device, "web1000 main path",
                               lambda: web_assembler(P, sites=1_000), WEB1000_SIZES)
    cyclic_timing(P, web1000, forest_forms, "web1000", name_power)

    del web1000["asm"], web1000["solver"]

    lattice = lattice_phases(P, device, name_power)
    lat = lattice["sets"]

    mid = core_phases(P, device, name_power)
    core, k11 = mid["sets"], mid["k11"]

    iterative = cg_phases(P, device, name_power)
    cgs = iterative["sets"]

    generic = generic_phases(P, device, name_power)
    gen_sets = generic["sets"]

    runs = (state["launches"], tree["launches"], forest["launches"], web["launches"],
            bed["launches"], web1000["launches"],
            *(path["launches"] for path in lattice["paths"].values()),
            *(path["launches"] for path in mid["paths"].values()),
            *(path["launches"] for path in iterative["paths"].values()), *generic["runs"])
    timed_cyclic = {"dense_core": k11[K11_TIMED], "core_elim": core["f"]["core_elim"],
                    "core_fronts": core["i"]["core_fronts"]}
    timed_lattice = {"dct_lattice": lat["a"], "grid_core": lat["a"], "shift_matvec": lat["c"]}
    log(f"phase wall: the script so far {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNEL_RECORD.items():
        lattice_errs = tuple(lat[c][name]["max_abs_err"] for c in "abcd" if name in lat[c])
        if name in full:
            errs = (full[name]["max_abs_err"], small[name]["max_abs_err"]) + lattice_errs
            timed_on = full[name]
        elif name in sets["a"]:
            errs = tuple(sets[c][name]["max_abs_err"] for c in "abcd") + lattice_errs
            timed_on = sets["a"][name]
        elif name in LATTICE_CHECKS:
            errs = tuple(lat[c][key]["max_abs_err"] for c in "abcd"
                         for key in LATTICE_CHECKS[name] if key in lat[c])
            timed_on = timed_lattice[name][name]
        elif name in CG_CHECKS:
            on, keys = CG_CHECKS[name]
            errs = tuple(cgs[on][key]["max_abs_err"] for key in keys)
            timed_on = cgs[on]["krylov_cg_step" if name == "krylov" else name]
        elif name in GENERIC_CHECKS:
            checks = GENERIC_CHECKS[name]
            errs = tuple(gen_sets[on][key]["max_abs_err"] for on, key in checks)
            timed_on = gen_sets[checks[0][0]][checks[0][1]]
        else:
            errs = tuple(cyc[c][key]["max_abs_err"] for c in "abcde"
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
    assert len(kernels) == 28 and all(kr["launches"] > 0 for kr in kernels), kernels
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
