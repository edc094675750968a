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
  dense core: K11).

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

import numpy as np
import torch

GENERATIONS = 16
N_CELLS = 40
DOFS = 5_341_102
TOL = 1e-12  # kernel vs plain and port vs plain, times max(1, max |plain|)
REPS = 20  # timed launches per kernel

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


def bed_assembler(P, gens: int = 5, nx: int = 96, ny: int = 64):
    """The perfusion bed ``make_vascular_bed(gens, nx, ny)`` at N = 2, k = 1."""
    net = P.network_generation.make_vascular_bed(gens, nx, ny, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=2, color_strategy="fast"),
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
    return record


def cyclic_main_path(P, device, label: str, build, expect: dict) -> dict:
    """A cyclic solve through the public API, counted and checked: the tree
    executor, only the cyclic wrappers and K6/K8, converged, finite,
    conserving mass and equal to the plain path on the card."""
    from networks_fenicsx_tpu_torch import kernels
    from networks_fenicsx_tpu_torch.levels import _cached_tree_plan
    from networks_fenicsx_tpu_torch.solver import _TreeExecutor, _flatten_blocks_host

    t0 = time.perf_counter()
    asm = build()
    t1 = time.perf_counter()
    _cached_tree_plan(asm, attach=True)  # the host planning, paid once per assembler
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
    for key, want in expect.items():
        assert sizes[key] == want, (key, sizes[key], want)
    allowed = {fn.__name__ for fn in kernels.CYCLIC} | set(CYCLIC_SHARED)
    assert all(n == 0 for name, n in launches.items() if name not in allowed), launches
    core = ("mf_factor", "mf_apply") if dtp.mf is not None else ("dense_core",)
    for name in ("lambda_system", "peel", *core, *CYCLIC_SHARED):
        assert launches[name] >= 1, launches
    unused = ("dense_core",) if dtp.mf is not None else ("mf_factor", "mf_apply")
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
    if dtp.mf is None:
        core_text = "dense"
    else:
        mf = dtp.mf.plan.stats
        core_text = (f"multifrontal: {mf['mf_groups']} groups, {mf['mf_fronts']} fronts, "
                     f"front_max {mf['front_max']}; factor {dtp.mf.device_bytes / 2**20:.1f} MiB")
    log(f"phase {label}: {len(dtp.rounds)} peel rounds, core {dtp.core_size} "
        f"({core_text}), converged, finite, "
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


def main() -> int:
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

    runs = (state["launches"], tree["launches"], forest["launches"], web["launches"],
            bed["launches"], web1000["launches"])
    timed_cyclic = {"dense_core": cyc["e"]}
    kernels = []
    for name, (source, replaces) in KERNEL_RECORD.items():
        if name in full:
            errs = (full[name]["max_abs_err"], small[name]["max_abs_err"])
            timed_on = full[name]
        elif name in sets["a"]:
            errs = tuple(sets[c][name]["max_abs_err"] for c in "abcd")
            timed_on = sets["a"][name]
        else:
            errs = tuple(cyc[c][key]["max_abs_err"] for c in "abcde"
                         for key in (name, name + "_unrefined") if key in cyc[c])
            timed_on = timed_cyclic.get(name, cyc["a"])[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(r[name] for r in runs),
            "max_abs_err": max(errs),
            "ms": timed_on["ms"], "plain_ms": timed_on["plain_ms"],
        })
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
