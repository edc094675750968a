"""Batched parameter sweep + adjoint sensitivities on the PyTorch/CUDA port.

The port's counterpart of ``demo_sweep.py``: a resistance sweep over an
arterial tree solves S scenarios in the launches of one solve
(``solve_sweep``), and the adjoint of the blocked solve gives the
sensitivity of the root flux to every vessel resistance at the cost of
about one extra solve (``build_schur_executor(..., outputs="flat")`` and
``torch.autograd.grad``).

Run from anywhere (``--device cpu`` runs the kernels' plain versions)::

    python3 demos/demo_sweep_torch.py [--device cuda] [--out DIR]
"""

import argparse
import sys
from pathlib import Path

_repo_root = str(Path(__file__).resolve().parent.parent)
if _repo_root not in sys.path:
    sys.path.insert(0, _repo_root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import networks_fenicsx_tpu_torch as P  # noqa: E402
from networks_fenicsx_tpu_torch.solver import build_schur_executor  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--out", default=str(Path(__file__).parent / "results_sweep_torch"),
                        help="directory of sweep.npz")
    args = parser.parse_args(argv)

    net = P.network_generation.make_arterial_tree(6, direction=[0.1, 1.0, 0.0], arrays=True)
    mesh = P.NetworkMesh(net, N=10, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh)
    R0 = 1.0 / mesh.edge_radius**4
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0)

    # --- sweep: 16 global stiffness scalings in one solve's launches
    S = 16
    scales = np.linspace(0.5, 2.0, S)
    res = P.solve_sweep(asm, R=R0[None, :] * scales[:, None], device=args.device)
    root_flux = res.x[:, 0]
    print("scale -> root flux (q ∝ 1/R for uniform scaling):")
    for s, q in zip(scales[::5], root_flux[::5]):
        print(f"  {s:5.2f} -> {q:9.5f}")

    # --- adjoint: d(root flux)/dR_e for every vessel, one backward pass
    executor = build_schur_executor(asm, P.SolverOptions(), device=args.device, outputs="flat")
    _, f_arg, sp, ep = asm.schur_arguments(device=False)
    R = torch.tensor(R0, device=args.device, requires_grad=True)
    x = executor(R, f_arg, sp, ep)[0]
    (grad,) = torch.autograd.grad(x[0], R)
    g = grad.cpu().numpy()
    top = np.argsort(np.abs(g))[::-1][:5]
    print("most sensitive vessels (d q_root / d R_e):")
    for e in top:
        print(f"  edge {e:3d} (radius {mesh.edge_radius[e]:.3f}): {g[e]: .3e}")

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    np.savez(outdir / "sweep.npz", scales=scales, root_flux=root_flux, sensitivity=g)
    print(f"saved {outdir / 'sweep.npz'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
