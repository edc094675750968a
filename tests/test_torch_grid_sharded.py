"""The port's strip-sharded lattice solve (``parallel/grid_sharded.py``)
against the JAX package's on the CPU.

The non-sweep cases of ``tests/test_grid_sharded.py``: the port on
``devices=["cpu"] * D``, the reference on ``jax.devices()[:D]``; both agree
at 1e-10·scale, and the port equals its serial solve (the DCT grid route or
SciPy's LU, ``method="host_lu"``) at 1e-10·scale.  The sweeps are ROADMAP A9
and raise.
"""

import numpy as np
import pytest
import torch

import jax

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu.parallel import ShardedNetworkSolver as JSharded
from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver as PSharded

torch.set_num_threads(1)

TOL = 1e-10


def _assembler(pkg, dims, N, fd, R, f, p_bc):
    mesh = pkg.NetworkMesh(pkg.network_generation.make_grid(*dims, arrays=True), N=N)
    asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=fd)
    forms = {} if f is None else {"f": f(mesh) if callable(f) else f}
    asm.compute_forms(p_bc_ex=p_bc, R=R(mesh) if callable(R) else R, **forms)
    return asm


def _x(sol):
    return np.concatenate([np.asarray(fn.values).ravel() for fn in sol])


def _close(got, want, tol=TOL):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _both(dims, N, fd, R, f, nd, p_bc=lambda x: x[0] + 0.2 * x[1], serial=None):
    """Port and reference sharded solves, the port's serial solve; returns
    the port's solver."""
    ap = _assembler(P, dims, N, fd, R, f, p_bc)
    sp = PSharded(ap, devices=["cpu"] * nd)
    sp.assemble()
    got = _x(sp.solve())
    aj = _assembler(J, dims, N, fd, R, f, p_bc)
    sj = JSharded(aj, devices=jax.devices()[:nd])
    sj.assemble()
    _close(got, _x(sj.solve()))
    assert sp.info.method == sj.info.method, (sp.info, sj.info)
    options = serial or P.SolverOptions(method="host_lu")
    ser = P.Solver(_assembler(P, dims, N, fd, R, f, p_bc), device="cpu", options=options)
    _close(got, _x(ser.solve()))
    return sp


@pytest.mark.parametrize(
    "dims,N,fd,fkind,nd",
    [
        ((6, 5), 2, 1, "scalar", 8),
        ((9, 16), 1, 1, "edge", 8),
        ((5, 7), 3, 2, "cell", 4),
        ((4, 9), 2, 1, "zero", 2),
        ((7, 3), 1, 1, "edge", 8),  # ny < D: ragged strips, inert shards
        ((5, 5), 2, 3, "scalar", 4),
    ],
)
def test_sharded_grid_matches_host_lu(dims, N, fd, fkind, nd):
    rng_seed = dims[0] * 31 + dims[1]

    def f(mesh):
        rng = np.random.default_rng(rng_seed)
        return {"scalar": 0.7, "edge": rng.uniform(0.5, 1.5, mesh.num_edges),
                "cell": rng.uniform(-1.0, 1.0, mesh.num_cells)}[fkind]

    sp = _both(dims, N, fd, 1.8, None if fkind == "zero" else f, nd)
    assert sp.info.method == "schur_sharded_grid"


def test_sharded_grid_matches_serial_grid_executor():
    sp = _both((8, 6), 2, 1, 2.0, 0.3, 4, p_bc=lambda x: x[0],
               serial=P.SolverOptions(method="schur", schur_method="dct"))
    assert sp.info.method == "schur_sharded_grid"


def test_sharded_grid_fallback_outside_envelope():
    """Per-edge R disqualifies the DCT plan: the general route."""
    R = lambda mesh: np.random.default_rng(11).uniform(0.5, 2.0, mesh.num_edges)  # noqa: E731
    sp = _both((6, 5), 2, 1, R, None, 4, p_bc=lambda x: x[0])
    assert sp.info.method != "schur_sharded_grid"


def test_sharded_grid_surfaces_lambda_residual():
    sp = _both((6, 5), 1, 1, 1.5, 0.2, 4, p_bc=lambda x: x[0] + 0.3 * x[1])
    assert sp.info.method == "schur_sharded_grid"
    assert 0.0 < sp.info.residual < 1e-10


def test_sharded_grid_strip_tables():
    """Each strip's slot ends name the λ nodes its edges join: the ends of
    every real slot are its public edge's bifurcations."""
    from networks_fenicsx_tpu_torch.parallel.grid_sharded import plan_sharded_grid, strip_ends

    asm = _assembler(P, (7, 6), 2, 1, 1.5, 0.2, lambda x: x[0])
    plan = plan_sharded_grid(asm, 4)
    sb, eb = np.asarray(asm._edge_start_bif), np.asarray(asm._edge_end_bif)
    for d in range(4):
        src, tgt = strip_ends(plan, d)
        rows = plan.edge_rows[d]
        ok = rows >= 0
        assert np.array_equal(src[ok], sb[rows[ok]]) and np.array_equal(tgt[ok], eb[rows[ok]])
        assert np.all(src[~ok] == -1) and np.all(tgt[~ok] == -1)


@pytest.mark.parametrize("R", ["scalar", "matrix"])
def test_sharded_grid_sweeps_are_left(R):
    from networks_fenicsx_tpu_torch.parallel.sweep import sharded_sweep

    asm = _assembler(P, (5, 4), 1, 1, 2.0, None, lambda x: x[0])
    scen = np.array([1.0, 2.0]) if R == "scalar" else np.ones((3, asm.network.num_edges))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        sharded_sweep(asm, scen, devices=["cpu"] * 2)
