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

then

1. times each phase of ``compute_forms`` + ``Solver.solve`` on the host
   clock, CUDA-synchronised at every phase boundary (best of ``--reps``);
2. traces ``--reps`` solves with ``torch.profiler`` and sums device time by
   kernel and copy, giving the device's busy and idle share of the solve
   and the device launches (kernels and copies) per solve, also summed by
   the CUDA source that defines each kernel.

Run from the repository root on a machine with a CUDA device::

    python3 scripts/profile_torch_main_path.py [--path blocked] [--generations 16] [--reps 5]

(``--generations`` sets the depth of ``blocked``, ``callable`` and ``p1tree``.)

Prints one JSON object; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import networks_fenicsx_tpu_torch as P  # noqa: E402
from networks_fenicsx_tpu_torch.ops import krylov as cg_loop  # noqa: E402
from networks_fenicsx_tpu_torch.solver import (  # noqa: E402
    _CgExecutor, _flatten_blocks_host, _generic_solve, build_schur_executor,
)

GENERIC_PATHS = ("p1tree", "minres")


def kernel_sources() -> dict[str, str]:
    """Each ``__global__`` kernel's name -> the ``kernels/csrc`` file that
    defines it (a header's kernels under the header's name: its includers
    share them; a name two files define under both, joined by " + ")."""
    csrc = pathlib.Path(P.__file__).resolve().parent / "kernels" / "csrc"
    out: dict[str, list[str]] = {}
    for path in sorted(csrc.glob("*.cu*")):
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
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
    if path == "blocked":
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
    elif path == "forest":
        asm = chip_smoke.forest_assembler(P, chip_smoke.forest_mesh(P))
        forms = chip_smoke.forest_forms
    elif path == "web":
        asm, forms = chip_smoke.web_assembler(P), chip_smoke.forest_forms
    elif path == "web1000":
        asm, forms = chip_smoke.web_assembler(P, sites=1_000), chip_smoke.forest_forms
    elif path == "lattice":
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


def generic_phases(asm, solver, forms, path: str) -> dict[str, float]:
    """One compute_forms + solve of ``p1tree`` or ``minres``, split at its
    phase boundaries (ms)."""
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


def solve_once(solver, path: str) -> None:
    """What a user runs after compute_forms: the generic methods assemble again."""
    if path == "minres":
        solver.assemble()
    solver.solve()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("blocked", "callable", "forest", "web", "web1000", "bed",
                                       "lattice", "lattice-callable", "web2k", "lattice64",
                                       "fronts128", "cg512", "web-cg", "skinny-mg",
                                       *GENERIC_PATHS),
                    default="blocked")
    ap.add_argument("--generations", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()

    asm, forms, options, tree_plan = configure(args.path, args.generations)
    solver = P.Solver(asm, options=options, device="cuda")
    if tree_plan is not None:  # the forced plan's executor, as the reference's tests build it
        solver._executor = build_schur_executor(asm, options, device="cuda", _tree_plan=tree_plan)
        solver._executor_key = asm.coefficient_modes()
    t0 = sync_clock()
    solve_once(solver, args.path)  # builds the kernels and the executor
    first_ms = (sync_clock() - t0) * 1e3

    if args.path in GENERIC_PATHS:
        runs = [generic_phases(asm, solver, forms, args.path) for _ in range(args.reps)]
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
        "executor": type(solver._executor).__name__,
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
    if args.path in GENERIC_PATHS:
        loop = cg_loop.cg if args.path == "p1tree" else cg_loop.minres
        result["iterative"] = {"method": solver.info.method, "iterations": solver.info.iterations,
                               "chunk": cg_loop.CHUNK,
                               "flag_reads_per_solve": loop.flag_reads / args.reps,
                               "residual": solver.info.residual, "tolerance": loop.last_tol}
    if isinstance(solver._executor, _CgExecutor):
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
