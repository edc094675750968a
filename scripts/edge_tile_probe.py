"""K8a's tile plan on the card: device µs of one call under other plans.

Builds chip_smoke.py's K8a inputs (the callable tree: 16 generations,
N = 40, callable R and f, k = 1; set (c)'s 2k-site forest at k = 3; set
(b)'s 100k forest, edge R, cell f, k = 2; the 512² lattice with callable
f, N = 1) and times the kernel with the plan
``kernels/edge_data.py:edge_tile`` picks and with others: the chunk's
cells, the warps a tile (rows) and a thread an edge (direct).
Each plan's outputs are held to the plain version (bit for bit at k = 1 and
in the scalar layout, 1e-12·scale at k = 3) before it is timed.  Device µs
are the profiler's mean over 20 calls (None where it recorded none),
beside CUDA events' mean ms over 50 calls (host dispatch included); the
card's name and power limit are printed with them.

    python3 scripts/edge_tile_probe.py [--out edge_tile_probe.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

import networks_fenicsx_tpu_torch as P  # noqa: E402
from networks_fenicsx_tpu_torch.kernels import edge_data as K  # noqa: E402

# (cells, rows) a case; None: the plan edge_tile picks; "direct": a thread
# an edge
VARIANTS = {
    "callable_tree": [None, (8, 8), (24, 8), (40, 8), (16, 4), "direct"],
    "set_c_k3": [None, (16, 8), (8, 4)],
    "forest_b_k2": [None, (8, 8), (8, 4)],
    "lattice_callable": [None, (1, 1)],
}


def variant(base: K.EdgeTile, E: int, N: int, k: int, modes: tuple, v):
    """``base`` with another chunk and warps, or a thread an edge."""
    if v == "direct":
        return dataclasses.replace(base, cells=N, rows=0, widths=(0, 0), pitches=(0, 0),
                                   scratch="none", smem=0, blocks=-(-E // K.UNIFORM_THREADS))
    cells, rows = v
    width = {"cell": 1, "quad": k + 1}
    widths = tuple(width.get(m, 0) for m in modes)
    pitches = tuple(K._odd(w * cells) for w in widths)
    scratch = "shared" if base.layout == "general" and k >= 2 else "none"
    return dataclasses.replace(base, cells=cells, rows=rows, widths=widths, pitches=pitches,
                               scratch=scratch, blocks=-(-E // 32),
                               smem=K._tile_bytes(k, cells, rows, pitches, scratch == "shared"))


def device_us(fn, calls: int = 20) -> float:
    """The profiler's mean device µs of K8a's kernel over ``calls`` calls,
    the window padded at both ends (the profiler may lose a window's first
    records)."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(64, dtype=torch.float64, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            pad.add_(1.0)
        for _ in range(calls):
            fn()
        for _ in range(8):
            pad.mul_(1.0)
        torch.cuda.synchronize()
    names = ("edge_tile_kernel", "edge_direct_kernel", "edge_data_kernel")
    evs = [ev for ev in prof.key_averages() if any(name in ev.key for name in names)]
    n = sum(ev.count for ev in evs)
    return sum(ev.device_time_total for ev in evs) / n if n else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("edge_tile_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()

    def set_c():
        asm = P.HydraulicNetworkAssembler(chip_smoke.forest_mesh(P, sites=2_000), flux_degree=3,
                                          pressure_degree=0)
        chip_smoke.callable_forms(asm)
        return asm

    builds = {"callable_tree": lambda: chip_smoke.callable_assembler(P), "set_c_k3": set_c,
              "forest_b_k2": lambda: chip_smoke.forest_assembler(P, chip_smoke.forest_mesh(P)),
              "lattice_callable": lambda: chip_smoke.lattice_assembler(
                  P, forms=chip_smoke.lattice_callable_forms)}
    out = {"card": card}
    pick = K.edge_tile
    for name, build in builds.items():
        asm = build()
        solver = P.Solver(asm, device="cuda")
        solver.solve()
        ex = solver._executor
        R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
        Rm, fm, f_zero = asm.coefficient_modes()
        e_args = (ex.device_plan, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi, R, f, Rm, fm,
                  f_zero, sp, ep)
        E, k = asm.network.num_edges, ex._k
        exact = k == 1 or K.edge_layout(k, Rm, fm) != "general"
        want = K.edge_data_plain(*e_args)
        base = pick(E, ex._N, k, k + 1, (Rm, fm), K.elides_source(K.edge_layout(k, Rm, fm), f_zero))
        rows = []
        for v in VARIANTS[name]:
            plan = base if v is None else variant(base, E, ex._N, k, (Rm, fm), v)
            K.edge_tile = lambda *a, plan=plan: plan
            try:
                got = K.edge_data(*e_args)
                chip_smoke.check_pair(lambda: K.edge_data(*e_args), lambda: want, exact=exact)
                us = device_us(lambda: K.edge_data(*e_args))
                ms = chip_smoke.cuda_ms(lambda: K.edge_data(*e_args), reps=50)
            finally:
                K.edge_tile = pick
            del got
            rows.append({"plan": "edge_tile" if v is None else "variant", "direct": plan.direct,
                         "cells": plan.cells,
                         "rows": plan.rows, "smem": plan.smem, "device_us": us, "events_ms": ms})
            print(name, rows[-1], flush=True)
        out[name] = rows
        del asm, solver, ex, e_args, want
    text = json.dumps(out, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
