"""Smoke run of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from ``networks_fenicsx_tpu_torch/kernels/csrc``,
checks each against its plain PyTorch version on the card, drives the main
path — the blocked forest Schur solve of the 16-generation arterial tree at
N = 40 (5,341,102 dofs) — through the public API, checks the solution, and
times it.  Run from the repository root::

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero, printing no result, without
one.  The last line of its output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the card's name and power limit, and the one
before that the per-kernel record.  Every phase raises on failure.
"""

from __future__ import annotations

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

KERNEL_RECORD = {
    "condense": ("networks_fenicsx_tpu_torch/kernels/csrc/condense.cu",
                 "networks_fenicsx_tpu/solver.py:2776"),
    "tree_sweep": ("networks_fenicsx_tpu_torch/kernels/csrc/tree_sweep.cu",
                   "networks_fenicsx_tpu/solver.py:2420"),
    "expand": ("networks_fenicsx_tpu_torch/kernels/csrc/expand.cu",
               "networks_fenicsx_tpu/solver.py:2743"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max(1, max |want|)) over matching tensors."""
    err, scale = 0.0, 1.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
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
    assert all(n >= 1 for n in launches.values()), launches

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

    kernels = []
    for name, (source, replaces) in KERNEL_RECORD.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": state["launches"][name],
            "max_abs_err": max(full[name]["max_abs_err"], small[name]["max_abs_err"]),
            "ms": full[name]["ms"], "plain_ms": full[name]["plain_ms"],
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
