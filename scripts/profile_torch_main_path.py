"""Where the time of the port's main path goes, on one GPU.

Builds the benchmark configuration (16-generation arterial tree, N = 40,
Poiseuille R, p_bc = y; 5,341,102 dofs), then

1. times each phase of ``compute_forms`` + ``Solver.solve`` on the host
   clock, CUDA-synchronised at every phase boundary (best of ``--reps``);
2. traces ``--reps`` solves with ``torch.profiler`` and sums device time by
   kernel and copy, giving the device's busy and idle share of the solve.

Run from the repository root on a machine with a CUDA device::

    python3 scripts/profile_torch_main_path.py [--generations 16] [--reps 5]

Prints one JSON object; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import networks_fenicsx_tpu_torch as P  # noqa: E402
from networks_fenicsx_tpu_torch.solver import _flatten_blocks_host  # noqa: E402


def sync_clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def phases(asm, solver, R) -> dict[str, float]:
    """One compute_forms + solve, split at its phase boundaries (ms)."""
    ex = solver._executor
    t = [sync_clock()]
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)
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
                             edge_order=ex.edge_order, bif_order=ex.bif_order)
    t.append(sync_clock())
    solver._scatter_functions(None, x)
    t.append(sync_clock())
    del uploaded
    names = ["compute_forms", "prepare_args", "upload", "executor (upload + kernels)",
             "device_to_host", "flatten", "scatter"]
    return {n: (b - a) * 1e3 for n, a, b in zip(names, t[:-1], t[1:])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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

    net = P.network_generation.make_arterial_tree(args.generations, direction=[0.1, 1, 0],
                                                  arrays=True)
    mesh = P.NetworkMesh(net, N=40, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh)
    R = 1.0 / mesh.edge_radius**4
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)
    solver = P.Solver(asm, device="cuda")
    solver.solve()  # builds the kernels and the executor

    runs = [phases(asm, solver, R) for _ in range(args.reps)]
    best = {k: min(r[k] for r in runs) for k in runs[0]}

    solve_ms = []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            t0 = sync_clock()
            solver.solve()
            solve_ms.append((sync_clock() - t0) * 1e3)
    device_us: dict[str, float] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            device_us[ev.key] = us / args.reps
    busy_ms = sum(device_us.values()) / 1e3
    mean_solve = float(np.mean(solve_ms))
    result = {
        "card": card,
        "dofs": asm.num_dofs,
        "phase_best_ms": best,
        "solve_ms_profiled": solve_ms,
        "device_us_per_solve": dict(sorted(device_us.items(), key=lambda kv: -kv[1])),
        "device_busy_ms_per_solve": busy_ms,
        "device_idle_share": 1.0 - busy_ms / mean_solve if mean_solve else None,
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
