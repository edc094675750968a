"""The port's demos, run as their users run them.

``demos/demo_sweep_torch.py --device cpu`` runs as a subprocess: its
printed five most sensitive vessels and its saved sensitivities are held
against ``jax.grad`` of the reference demo's functional
(``demos/demo_sweep.py:46-58``: the root flux of
``make_arterial_tree(6)`` at N = 10 with respect to every vessel's R),
and its sweep's root fluxes against the reference's ``solve_sweep``.  The
JAX package is imported only inside the test.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np

DEMO = Path(__file__).resolve().parent.parent / "demos" / "demo_sweep_torch.py"


def test_demo_sweep_torch_matches_reference(tmp_path):
    import jax

    import networks_fenicsx_tpu as J
    from networks_fenicsx_tpu.solver import build_schur_executor

    source = DEMO.read_text()
    assert "jax" not in source and "networks_fenicsx_tpu." not in source
    run = subprocess.run([sys.executable, str(DEMO), "--device", "cpu", "--out", str(tmp_path)],
                         capture_output=True, text=True, timeout=600, check=True)
    printed = [(int(m.group(1)), float(m.group(2)))
               for m in re.finditer(r"edge\s+(\d+) \(radius [\d.]+\):\s+(\S+)", run.stdout)]
    saved = np.load(tmp_path / "sweep.npz")

    G = J.network_generation.make_arterial_tree(N=6, direction=np.array([0.1, 1.0, 0.0]))
    mesh = J.NetworkMesh(G, N=10, color_strategy="fast")
    asm = J.HydraulicNetworkAssembler(mesh)
    R0 = 1.0 / mesh.edge_radius**4
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0)
    executor = build_schur_executor(asm, J.SolverOptions(), jit=False)
    _, f_arg, sp, ep = asm.schur_arguments()
    g = np.asarray(jax.grad(lambda R: executor(R, f_arg, sp, ep)[0][0])(jax.numpy.asarray(R0)))
    top = np.argsort(np.abs(g))[::-1][:5]

    assert [e for e, _ in printed] == top.tolist(), (printed, top)
    np.testing.assert_allclose([v for _, v in printed], g[top], rtol=5e-3)
    scale = max(1.0, float(np.abs(g).max()))
    np.testing.assert_allclose(saved["sensitivity"], g, rtol=0, atol=1e-11 * scale)

    scales = np.linspace(0.5, 2.0, 16)
    xj = np.asarray(J.solve_sweep(asm, R=R0[None, :] * scales[:, None]).x)
    np.testing.assert_allclose(saved["root_flux"], xj[:, 0], rtol=0,
                               atol=1e-12 * max(1.0, float(np.abs(xj[:, 0]).max())))
