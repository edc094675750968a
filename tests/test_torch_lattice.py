"""The uniform-lattice (separable-DCT) path of the PyTorch port against the JAX reference.

Host planners — ``_plan_shift_matvec``, ``_plan_dct_lattice`` and
``_plan_grid_layout`` — must give ``np.array_equal`` plans on the same
graphs, and None on the same non-grids.  The plain PyTorch versions of the
lattice kernels must equal the reference's JAX functions on the same inputs
made from a seed, at 1e-12·scale (scale = max(1, max |reference|)):

* K16 (:mod:`~networks_fenicsx_tpu_torch.kernels.dct_lattice`) against
  ``_dct_capacitance_solve`` with the same conductances, rhs and matvec;
* K17 (:mod:`~networks_fenicsx_tpu_torch.kernels.grid_core`) against
  ``_lambda_system_sorted`` (assembly) and ``_shift_matvec`` (stencil);
* K18 (:mod:`~networks_fenicsx_tpu_torch.kernels.shift_matvec`) against
  ``_shift_class_weights`` and ``_shift_matvec``.

``Solver.solve()`` on both DCT routes equals the JAX package's
``schur_method="dct"`` solve at 1e-12·scale, the grid5x4 golden at 1e-10,
and the > 4,096-wide lattices its host LU at the reference's conditioning
bar.  The reference inverts its bordered matrix in float32 and polishes it
with Newton steps; the port inverts in float64; both land at roundoff.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu_torch import lattice as PLat
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch.kernels import dct_lattice, grid_core, segsum, shift_matvec

from test_torch_solver import _check_golden, _golden_problem

torch.set_num_threads(1)

GOLDEN_DIR = Path(__file__).parent / "goldens"


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _grid(pkg, nx, ny):
    return pkg.network_generation.make_grid(nx, ny, arrays=True)


def _reversed(pkg):
    """make_grid(6, 5) with one lattice edge pointing left."""
    G = _grid(pkg, 6, 5)
    edges = np.asarray(G.edges).copy()
    edges[3] = edges[3, ::-1]
    return pkg.ArrayNetwork(pos=np.asarray(G.pos), edges=edges)


def _transposed(pkg):
    """A 6 × 5 lattice numbered column-major: ±1 runs up the columns."""
    G = _grid(pkg, 5, 6)
    pos = np.asarray(G.pos)[:, ::-1].copy()
    return pkg.ArrayNetwork(pos=pos, edges=np.asarray(G.edges))


def _stretched(pkg):
    """make_grid(6, 5) with its top row moved up: no uniform y length."""
    G = _grid(pkg, 6, 5)
    pos = np.asarray(G.pos).copy()
    pos[24:30, 1] += 0.3
    return pkg.ArrayNetwork(pos=pos, edges=np.asarray(G.edges))


def _two_stubs(pkg):
    """make_grid(6, 5) with a second inlet and an outlet on its inlet
    corner: three stub edges on one λ row (one leaving it), one on another."""
    G = _grid(pkg, 6, 5)
    pos = np.asarray(G.pos)
    V = pos.shape[0]
    pos = np.concatenate([pos, [[-0.2, -0.3], [0.1, -0.4]]])
    edges = np.concatenate([np.asarray(G.edges), [[V, 0], [0, V + 1]]])
    return pkg.ArrayNetwork(pos=pos, edges=edges)


class PerMesh:
    """A coefficient made from the mesh (per edge or per cell, from a seed)."""

    def __init__(self, kind: str, seed: int):
        self.kind, self.seed = kind, seed

    def __call__(self, mesh):
        rng = np.random.default_rng(self.seed)
        if self.kind == "edge":
            return rng.uniform(0.5, 1.5, mesh.num_edges)
        return rng.uniform(-1.0, 1.0, mesh.num_cells)


def _assembler(pkg, graph, N=2, k=1, R=2.5, f=None, p_bc=lambda x: x[0] + 0.2 * x[1]):
    mesh = pkg.NetworkMesh(graph(pkg), N=N, color_strategy="fast")
    asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k)
    asm.compute_forms(p_bc_ex=p_bc, R=R, f=f(mesh) if isinstance(f, PerMesh) else f)
    return asm


GRIDS = {
    "6x5": lambda pkg: _grid(pkg, 6, 5),
    "9x4": lambda pkg: _grid(pkg, 9, 4),
    "66x66": lambda pkg: _grid(pkg, 66, 66),
    "transposed": _transposed,
    "two_stubs": _two_stubs,
}
NON_GRIDS = {
    "reversed": (_reversed, ("grid",)),
    "stretched": (_stretched, ("dct", "grid")),
    "forest": (lambda pkg: pkg.network_generation.make_tree(3, 1.0, 2.0, arrays=True),
               ("dct", "grid")),
    "web": (lambda pkg: pkg.network_generation.make_random_network(200, keep=0.3, seed=2,
                                                                   arrays=True),
            ("shift", "dct", "grid")),
}


def _plans(mod, asm):
    shift = mod._plan_shift_matvec(asm)
    dct = mod._plan_dct_lattice(asm, shift)
    grid = None if dct is None else mod._plan_grid_layout(asm, dct)
    return {"shift": shift, "dct": dct, "grid": grid}


def _assert_plans_equal(pj, pp):
    for name in ("shift", "dct", "grid"):
        a, b = pj[name], pp[name]
        assert (a is None) == (b is None), name
    for (dj, rj, ej), (dp, rp, ep) in zip(pj["shift"], pp["shift"]):
        assert dj == dp and np.array_equal(rj, rp) and np.array_equal(ej, ep)
        assert rj.dtype == rp.dtype
    for plan in ("dct", "grid"):
        if pj[plan] is None:
            continue
        for field in pj[plan]._fields:
            a, b = getattr(pj[plan], field), getattr(pp[plan], field)
            if field == "dct":
                continue
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b) and a.dtype == b.dtype, (plan, field)
            else:
                assert a == b, (plan, field)


# ------------------------------------------------------------------ host planners


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_lattice_plans_equal(name):
    pj = _plans(JS, _assembler(J, GRIDS[name], N=1))
    pp = _plans(PLat, _assembler(P, GRIDS[name], N=1))
    assert pp["grid"] is not None
    _assert_plans_equal(pj, pp)
    src, tgt = PLat.grid_edge_ends(pp["grid"])
    asm = _assembler(P, GRIDS[name], N=1)
    eo = pp["grid"].edge_order
    assert np.array_equal(src, asm._edge_start_bif[eo])
    assert np.array_equal(tgt, asm._edge_end_bif[eo])


@pytest.mark.parametrize("name", sorted(NON_GRIDS))
def test_lattice_plans_none_on_non_grids(name):
    graph, missing = NON_GRIDS[name]
    pj = _plans(JS, _assembler(J, graph, N=1))
    pp = _plans(PLat, _assembler(P, graph, N=1))
    for plan in missing:
        assert pj[plan] is None and pp[plan] is None, plan
    if pj["shift"] is not None:
        _assert_plans_equal(pj, pp)


def test_shift_class_matrix_matches_segsum_sorted():
    """K6's class weights: one (C·B, K) gather for all four classes equals
    the reference's per-class ``_segsum_sorted``."""
    aj, ap = _assembler(J, _two_stubs, N=1), _assembler(P, _two_stubs, N=1)
    classes = PLat._plan_shift_matvec(ap)
    B, E = ap.network.num_multipliers, ap.network.num_edges
    W = np.random.default_rng(3).uniform(0.5, 2.0, E)
    idx = PLat.shift_class_matrix(classes, B, E)
    got = PLat._shift_class_weights(_t(1.0 / W), _t(idx, torch.int32), len(classes),
                                    segsum.segsum_plain)
    ed = _edge_data_j(aj, W, np.zeros(E), np.zeros((E, 2)))
    want = JS._shift_class_weights(ed, JS._plan_shift_matvec(aj), B)
    assert [d for d, _ in want] == [d for d, _, _ in classes]
    for c, (_, wv) in enumerate(want):
        _close(got[c], wv, 1e-12)


def test_dct_matrices_match_reference():
    """The host constant (≤ 4,096) and the device generator's plain version
    (above), whose cosine argument is formed in float64."""
    for n in (5, 64, 512):
        np.testing.assert_array_equal(
            PLat._dct2_matrix(n), np.asarray(dct_lattice.dct_matrix(n, "cpu")))
    n = 4200
    want = np.asarray(JS._dct2_matrix_device(n, jnp.float64))
    got = dct_lattice.dct_matrix(n, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    D = got @ got.T
    np.testing.assert_allclose(D, np.eye(n), rtol=0, atol=1e-10)


# ------------------------------------------------------------------ kernels (plain)


def _edge_data_j(asm, W, g, cumF, sp=None, ep=None):
    E = W.size
    sp = np.zeros(E) if sp is None else sp
    ep = np.zeros(E) if ep is None else ep
    return JS._EdgeData(None, jnp.asarray(cumF), jnp.asarray(W), jnp.asarray(g),
                        jnp.asarray(asm._edge_start_bif), jnp.asarray(asm._edge_end_bif),
                        jnp.asarray(sp), jnp.asarray(ep), ())


def _lattice_system(graph, seed=0):
    """Both assemblers and a scalar-R lattice system from a seed: W uniform
    per axis (the DCT plan's premise) with random stub conductances, random
    g, Ftot and boundary pressures."""
    aj, ap = _assembler(J, graph, N=1), _assembler(P, graph, N=1)
    dct = PLat._plan_dct_lattice(ap, PLat._plan_shift_matvec(ap))
    rng = np.random.default_rng(seed)
    E = ap.network.num_edges
    sb, eb = ap._edge_start_bif, ap._edge_end_bif
    both = (sb >= 0) & (eb >= 0)
    W = np.where(both, 0.0, rng.uniform(0.5, 2.0, E))
    L = np.asarray(ap.network.edge_length)
    W[both] = L[both] * 1.3  # scalar R: W ∝ length, uniform per axis
    g = rng.standard_normal(E)
    Ftot = rng.standard_normal(E)
    sp = np.where(sb < 0, rng.standard_normal(E), 0.0)
    ep = np.where(eb < 0, rng.standard_normal(E), 0.0)
    return aj, ap, dct, W, g, Ftot, sp, ep


def _reference_system(aj, W, g, Ftot, sp, ep):
    cumF = np.stack([np.zeros_like(Ftot), Ftot], axis=1)
    ed = _edge_data_j(aj, W, g, cumF, sp, ep)
    B = aj.network.num_multipliers
    diag, rhs = JS._lambda_system_sorted(ed, B, JS._build_lambda_plan(aj))
    classes = JS._plan_shift_matvec(aj)
    return ed, diag, rhs, JS._shift_class_weights(ed, classes, B)


@pytest.mark.parametrize("graph", ["6x5", "two_stubs", "66x66"])
def test_grid_core_plain_matches_reference(graph):
    """K17's assembly against ``_lambda_system_sorted`` and its stencil
    against ``_shift_matvec`` on the same system (λ in node order, edges in
    the grid plan's internal order)."""
    aj, ap, dct, W, g, Ftot, sp, ep = _lattice_system(GRIDS[graph])
    _, diag_j, rhs_j, class_w = _reference_system(aj, W, g, Ftot, sp, ep)
    plan = PLat._plan_grid_layout(ap, dct)
    gdp = PLat.device_grid_plan(plan, "cpu")
    eo = plan.edge_order
    sb, eb = ap._edge_start_bif[eo], ap._edge_end_bif[eo]
    w = 1.0 / W[eo]
    const = (-sp[eo] * (sb < 0) + ep[eo] * (eb < 0) - g[eo]) * w
    rhs, diag, norm = grid_core.grid_core(gdp, _t(w), _t(const), _t(Ftot[eo]))
    _close(rhs, rhs_j, 1e-12)
    _close(diag, diag_j, 1e-12)
    _close(norm, jnp.linalg.norm(rhs_j), 1e-12)
    lam = np.random.default_rng(9).standard_normal(ap.network.num_multipliers)
    want = rhs_j - JS._shift_matvec(class_w, diag_j, lam.size)(jnp.asarray(lam))
    res, res_norm = grid_core.grid_residual(gdp, _t(w), diag, _t(lam), rhs, norm=True)
    _close(res, want, 1e-12)
    _close(res_norm, jnp.linalg.norm(want), 1e-12)


@pytest.mark.parametrize("graph", ["6x5", "two_stubs", "transposed"])
def test_shift_matvec_plain_matches_reference(graph):
    aj, ap, _, W, g, Ftot, sp, ep = _lattice_system(GRIDS[graph], seed=1)
    _, diag_j, rhs_j, class_w = _reference_system(aj, W, g, Ftot, sp, ep)
    classes = PLat._plan_shift_matvec(ap)
    offsets = np.asarray([d for d, _, _ in classes], np.int32)
    B, E = ap.network.num_multipliers, ap.network.num_edges
    cw = PLat._shift_class_weights(_t(1.0 / W), _t(PLat.shift_class_matrix(classes, B, E),
                                                    torch.int32), len(classes), segsum.segsum_plain)
    dr = _t(np.stack([np.asarray(diag_j), np.asarray(rhs_j)], axis=1))
    lam = np.random.default_rng(5).standard_normal(B)
    want = rhs_j - JS._shift_matvec(class_w, diag_j, B)(jnp.asarray(lam))
    plan = shift_matvec.ShiftPlan(offsets, B, "cpu", stride=2)
    got, norm = shift_matvec.shift_matvec(plan, cw, dr[:, 0], _t(lam), dr[:, 1], norm=True)
    _close(got, want, 1e-12)
    _close(norm, jnp.linalg.norm(want), 1e-12)


@pytest.mark.parametrize("graph", sorted(GRIDS))
def test_shift_plan_apply_equals_plain(graph):
    """A :class:`ShiftPlan` holds the host plan's offsets in ascending order;
    its apply, residual, norm and Chebyshev step on the CPU are today's
    plain versions to the bit, on every offset set of this file's lattices."""
    ap = _assembler(P, GRIDS[graph], N=1)
    classes = PLat._plan_shift_matvec(ap)
    offsets = np.asarray([d for d, _, _ in classes], np.int32)
    B = ap.network.num_multipliers
    plan = shift_matvec.ShiftPlan(offsets, B, "cpu", stride=2)
    assert np.array_equal(plan.offsets, offsets) and plan.C == offsets.size and plan.B == B
    assert plan.index == -1 and plan.blocks == -(-B // shift_matvec.THREADS)
    rng = np.random.default_rng(11)
    cw = _t(rng.uniform(0.5, 2.0, (offsets.size, B)))
    dr = _t(np.stack([rng.uniform(4.0, 8.0, B), rng.standard_normal(B)], axis=1))
    lam = _t(rng.standard_normal(B))
    assert torch.equal(shift_matvec.shift_matvec(plan, cw, dr[:, 0], lam),
                       shift_matvec.shift_matvec_plain(offsets, cw, dr[:, 0], lam))
    for a, b in zip(shift_matvec.shift_matvec(plan, cw, dr[:, 0], lam, dr[:, 1], norm=True),
                    shift_matvec.shift_matvec_plain(offsets, cw, dr[:, 0], lam, dr[:, 1], norm=True)):
        assert torch.equal(a, b)
    flat = shift_matvec.ShiftPlan(offsets, B, "cpu")
    diag = dr[:, 0].contiguous()
    s, rs = 1.0 / torch.sqrt(diag), _t(rng.standard_normal(B))
    outs = []
    for fn, key in ((shift_matvec.shift_cheb, flat), (shift_matvec.shift_cheb_plain, offsets)):
        dvec, x_out, z = _t(np.ones(B)), torch.empty(B, dtype=torch.float64), torch.empty(B, dtype=torch.float64)
        fn(key, cw, diag, s, rs, dvec, lam, x_out, 0.7, 0.3, z, lam)
        outs.append((dvec, x_out, z))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_shift_plan_raises_on_what_the_kernel_does_not_take():
    for offsets in ([1, -1], [2, 2], list(range(1, 18))):
        with pytest.raises(ValueError, match="ascending"):
            shift_matvec.ShiftPlan(np.asarray(offsets, np.int32), 10, "cpu")
    with pytest.raises(ValueError, match="stride"):
        shift_matvec.ShiftPlan(np.asarray([-1, 1], np.int32), 10, "cpu", stride=3)
    with pytest.raises(ValueError, match="meta"):
        shift_matvec.ShiftPlan(np.asarray([-1, 1], np.int32), 10, "meta")


@pytest.mark.parametrize("graph", ["6x5", "9x4", "two_stubs", "66x66"])
def test_dct_lattice_plain_matches_capacitance_solve(graph):
    """K16 against ``_dct_capacitance_solve`` with the same wx, wy, w_r,
    rhs and matvec, at 1e-12·scale or the conditioning floor 4·n²·ε where
    that is larger; and one unrefined pass equals the exact solve of the
    system to roundoff (the bordered correction is exact)."""
    aj, ap, dct, W, g, Ftot, sp, ep = _lattice_system(GRIDS[graph], seed=2)
    _, diag_j, rhs_j, class_w = _reference_system(aj, W, g, Ftot, sp, ep)
    B = ap.network.num_multipliers
    matvec = JS._shift_matvec(class_w, diag_j, B)
    w = 1.0 / W
    w_r = np.zeros(dct.stub_rows.size)
    np.add.at(w_r, dct.stub_edge_group, w[dct.stub_edge_idx])
    want = JS._dct_capacitance_solve(JS._plan_dct_lattice(aj, JS._plan_shift_matvec(aj)),
                                     w[dct.rep_x], w[dct.rep_y], jnp.asarray(w_r), rhs_j, matvec)
    op = dct_lattice.dct_operator(dct, "cpu")
    dr = _t(np.stack([np.asarray(diag_j), np.asarray(rhs_j)], axis=1))
    classes = PLat._plan_shift_matvec(ap)
    offsets = np.asarray([d for d, _, _ in classes], np.int32)
    cw = _t(np.stack([np.asarray(v) for _, v in class_w]))

    plan = shift_matvec.ShiftPlan(offsets, B, "cpu", stride=2)

    def residual(lam):
        return shift_matvec.shift_matvec(plan, cw, dr[:, 0], lam, dr[:, 1])

    got = dct_lattice.dct_lattice(op, _t(w), dr[:, 1].contiguous(), residual)
    # two refined float64 solves meet at the conditioning floor, ~κ·ε relative
    # with κ ≈ n² (1.4e-12 measured at 66²); below 1e-12 on the small lattices
    kappa = float(max(dct.s, dct.ny)) ** 2
    _close(got, want, max(1e-12, 4 * kappa * np.finfo(np.float64).eps))
    if B > 1000:
        return
    Ld = np.diag(np.asarray(diag_j))
    for (d, wv) in class_w:
        Ld -= np.diag(np.asarray(wv)[max(0, -d): B - max(0, d)], k=d)
    exact = np.linalg.solve(Ld, np.asarray(rhs_j))
    one = dct_lattice.dct_lattice(op, _t(w), dr[:, 1].contiguous(), residual, n_refine=0)
    _close(one, exact, 1e-11)
    _close(got, exact, 1e-11)


# ------------------------------------------------------------------ solver


def _solve_both(graph, options, N=2, k=1, R=2.5, f=None, p_bc=lambda x: x[0] + 0.2 * x[1]):
    xs = []
    for pkg in (J, P):
        asm = _assembler(pkg, graph, N=N, k=k, R=R, f=f, p_bc=p_bc)
        kw = {"device": "cpu"} if pkg is P else {}
        s = pkg.Solver(asm, options=pkg.SolverOptions(**options), **kw)
        s.assemble()
        sol = s.solve()
        assert s.info.converged
        xs.append(np.concatenate([np.ravel(fn.values) for fn in sol]))
    return xs[0], xs[1], s


# test_grid_blocked_matches_host_lu's five cases: (dims, N, flux degree, f)
GRID_CASES = {
    "6x5_cell": ((6, 5), 3, 1, PerMesh("cell", 605)),
    "4x7_zero": ((4, 7), 2, 1, 0.0),
    "5x5_scalar_k2": ((5, 5), 2, 2, 1.7),
    "3x8_edge": ((3, 8), 1, 1, PerMesh("edge", 308)),
    "9x4_cell_k3": ((9, 4), 2, 3, PerMesh("cell", 904)),
}


@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_grid_route_matches_reference(name):
    (nx, ny), N, k, f = GRID_CASES[name]
    x_ref, x_port, s = _solve_both(lambda pkg: _grid(pkg, nx, ny), {"schur_method": "dct"},
                                   N=N, k=k, f=f)
    ex = s._executor
    assert isinstance(ex, PS._GridExecutor) and isinstance(ex.blocked_plan, PLat._GridPlan)
    assert ex.bif_order is None and s.info.iterations == 0
    assert ex.kappa_hint == float(max(nx, ny)) ** 2
    _close(x_port, x_ref, 1e-12)


def test_general_dct_route_matches_reference():
    """The quad-f case of ``test_grid_blocked_fallback_outside_envelope``:
    the general DCT route in public order."""
    x_ref, x_port, s = _solve_both(lambda pkg: _grid(pkg, 6, 5), {"schur_method": "dct"}, N=2,
                                   f=lambda x: x[0] + 0.3 * x[1], p_bc=lambda x: x[0])
    ex = s._executor
    assert isinstance(ex, PS._DctExecutor) and getattr(ex, "blocked_plan", None) is None
    assert ex.edge_order is None and ex.bif_order is None and s.info.iterations == 0
    _close(x_port, x_ref, 1e-12)


def test_reversed_edge_takes_the_general_route():
    x_ref, x_port, s = _solve_both(_reversed, {"schur_method": "dct"}, N=2, f=0.4)
    assert isinstance(s._executor, PS._DctExecutor)
    _close(x_port, x_ref, 1e-12)


@pytest.mark.parametrize("options", [{"schur_method": "dct"}, {}])
def test_two_stubs_on_one_row(options):
    """Four stub edges, three sharing a λ row: their conductances add into
    one border row.  ``auto`` keeps this 30-node core dense."""
    x_ref, x_port, s = _solve_both(_two_stubs, options, N=2, f=PerMesh("cell", 7))
    if options:
        assert isinstance(s._executor, PS._GridExecutor)
        assert s._executor.operator.r == 2 and s._executor.operator.stub_edge.numel() == 4
    _close(x_port, x_ref, 1e-12 if options else 1e-10)


def test_auto_takes_the_grid_route_above_4096():
    """make_grid(66, 66) has a 4,356-node core: ``auto`` resolves to the DCT
    solve and the grid layout rides along (``test_grid_blocked_engages_on_auto``)."""
    x_ref, x_port, s = _solve_both(lambda pkg: _grid(pkg, 66, 66), {}, N=1, R=1.0, f=None,
                                   p_bc=lambda x: x[0])
    assert isinstance(s._executor.blocked_plan, PLat._GridPlan)
    assert s.info.iterations == 0
    _close(x_port, x_ref, 1e-12)


def test_new_resistance_on_one_executor():
    """The DCT operator is built once per executor and holds no conductance:
    a new scalar R on the same solver gives the reference's new solution."""
    mesh = P.NetworkMesh(_grid(P, 7, 6), N=2, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh)
    s = P.Solver(asm, options=P.SolverOptions(schur_method="dct"), device="cpu")
    executors = []
    for R in (1.0, 3.5):
        asm.compute_forms(p_bc_ex=lambda x: x[0] + 0.2 * x[1], R=R, f=0.4)
        x_port = np.concatenate([np.ravel(fn.values) for fn in s.solve()])
        executors.append(s._executor)
        x_ref, _, _ = _solve_both(lambda pkg: _grid(pkg, 7, 6), {"schur_method": "dct"}, R=R, f=0.4)
        _close(x_port, x_ref, 1e-12)
    assert executors[0] is executors[1]


def test_dct_on_a_576_node_core():
    """make_grid(24, 24): under ``auto`` a dense core of 576 (the tree
    route), under ``"dct"`` the grid route."""
    x_ref, x_port, s = _solve_both(lambda pkg: _grid(pkg, 24, 24), {"schur_method": "dct"}, N=1,
                                   R=None, f=0.2, p_bc=lambda x: x[0])
    assert isinstance(s._executor, PS._GridExecutor)
    _close(x_port, x_ref, 1e-12)


def test_grid5x4_golden_on_the_dct_route():
    golden = json.loads((GOLDEN_DIR / "grid5x4.json").read_text())
    mesh, asm = _golden_problem(P, golden)
    s = P.Solver(asm, options=P.SolverOptions(schur_method="dct"), device="cpu")
    sol = s.solve()
    assert s.info.converged and isinstance(s._executor, PS._GridExecutor)
    _check_golden(golden, mesh, asm, sol, tol=1e-10)


@pytest.mark.parametrize("dims", [(5000, 3), (3, 4200)])
def test_wide_lattice_at_the_conditioning_bar(dims):
    """``test_wide_grid_exact_transform``: a side above 4,096 generates its
    DCT matrix on the device; the solve equals the reference's host LU at
    max(1e-10, 256·n²·ε) and converges (the κ hint of the gate)."""
    nx, ny = dims
    n_long = max(nx, ny)
    xs, infos = [], []
    for pkg, opts in ((J, dict(method="host_lu")), (P, dict(schur_method="dct"))):
        asm = _assembler(pkg, lambda pk: _grid(pk, nx, ny), N=1, R=1.7, f=0.3)
        kw = {"device": "cpu"} if pkg is P else {}
        s = pkg.Solver(asm, options=pkg.SolverOptions(**opts), **kw)
        s.solve()
        xs.append(np.asarray(s.solution_vector()))
        infos.append(s.info)
    assert infos[1].converged, infos[1]
    assert isinstance(s._executor, PS._GridExecutor)
    assert s._executor.kappa_hint == float(n_long) ** 2
    err = np.max(np.abs(xs[1] - xs[0])) / max(1.0, np.abs(xs[0]).max())
    assert err < max(1e-10, 256 * n_long**2 * np.finfo(np.float64).eps), err


def _web(pkg):
    return pkg.network_generation.make_random_network(200, keep=0.3, seed=2, arrays=True)


@pytest.mark.parametrize("graph,R", [(_web, 1.0), (GRIDS["6x5"], PerMesh("edge", 3)),
                                     (NON_GRIDS["stretched"][0], 1.0)])
def test_dct_without_a_dct_plan_is_a_value_error(graph, R):
    """A web, a lattice with per-edge R, a non-uniform lattice."""
    mesh = P.NetworkMesh(graph(P), N=1, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R(mesh) if isinstance(R, PerMesh) else R)
    s = P.Solver(asm, options=P.SolverOptions(schur_method="dct"), device="cpu")
    with pytest.raises(ValueError, match="uniform rectangular-lattice"):
        s.solve()


def test_lattice_wrappers_never_fall_back_off_the_cpu():
    """CPU tensors run the plain versions without counting a launch; any
    other device goes to the kernel path, which validates and raises."""
    from networks_fenicsx_tpu_torch import kernels

    kernels.reset_launches()
    ap = _assembler(P, GRIDS["6x5"], N=1)
    dct = PLat._plan_dct_lattice(ap, PLat._plan_shift_matvec(ap))
    plan = PLat._plan_grid_layout(ap, dct)
    gdp = PLat.device_grid_plan(plan, "cpu")
    op = dct_lattice.dct_operator(dct, "cpu")
    E, B = gdp.num_edges, gdp.num_bifurcations
    w = _t(np.full(E, 2.0))
    rhs, diag, _ = grid_core.grid_core(gdp, w, _t(np.ones(E)), _t(np.zeros(E)))
    dct_lattice.dct_lattice(op, w, rhs, lambda lam: grid_core.grid_residual(gdp, w, diag, lam, rhs))
    plan = shift_matvec.ShiftPlan(np.array([-1, 1], np.int32), B, "cpu")
    shift_matvec.shift_matvec(plan, _t(np.ones((2, B))), _t(np.ones(B)), _t(np.ones(B)),
                              _t(np.ones(B)), norm=True)
    shift_matvec.shift_cheb(plan, _t(np.ones((2, B))), _t(np.ones(B)), _t(np.ones(B)),
                            _t(np.ones(B)), _t(np.ones(B)), _t(np.ones(B)), _t(np.ones(B)), 1.0, 1.0)
    assert all(n == 0 for n in kernels.launches().values())
    meta = torch.ones(B, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        grid_core.grid_core(gdp, meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        grid_core.grid_residual(gdp, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        dct_lattice.dct_lattice(op, meta, meta, None)
    with pytest.raises(ValueError, match="CUDA"):
        shift_matvec.shift_matvec(plan, meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        shift_matvec.shift_matvec(plan, meta, meta, meta, meta, norm=True)
    with pytest.raises(ValueError, match="CUDA"):
        shift_matvec.shift_cheb(plan, meta, meta, meta, meta, meta, meta, meta.clone(), 1.0, 1.0)
    assert all(n == 0 for n in kernels.launches().values())


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_lattice_kernels_match_plain_on_card():
    """On a CUDA device: K16 (factor, transforms, one unrefined pass and the
    refined solve), K17 and K18 each equal their plain versions on the same
    inputs (``pytest -m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    aj, ap, dct, W, g, Ftot, sp, ep = _lattice_system(GRIDS["two_stubs"], seed=4)
    _, diag_j, rhs_j, class_w = _reference_system(aj, W, g, Ftot, sp, ep)
    plan = PLat._plan_grid_layout(ap, dct)
    gdp = PLat.device_grid_plan(plan, dev)
    eo = plan.edge_order
    sb, eb = ap._edge_start_bif[eo], ap._edge_end_bif[eo]
    w = 1.0 / W[eo]
    const = (-sp[eo] * (sb < 0) + ep[eo] * (eb < 0) - g[eo]) * w
    w, const, Ftot_i = (_t(a).to(dev) for a in (w, const, Ftot[eo]))
    got = grid_core.grid_core(gdp, w, const, Ftot_i)
    want = grid_core.grid_core_plain(gdp, w, const, Ftot_i)
    for a, b in zip(got, want):
        _close(a.cpu(), b.cpu().numpy(), 1e-12)
    rhs, diag = want[0], want[1]
    lam = torch.randn(gdp.num_bifurcations, dtype=torch.float64, device=dev)
    for a, b in zip(grid_core.grid_residual(gdp, w, diag, lam, rhs, norm=True),
                    grid_core.grid_residual_plain(gdp, w, diag, lam, rhs, norm=True)):
        _close(a.cpu(), b.cpu().numpy(), 1e-12)
    tail = plan.Ex + plan.Ey + np.arange(plan.stub_rows_e.size)
    op = dct_lattice.dct_operator(dct, dev, stub_edge=tail, stub_group=plan.stub_group, rep_x=0,
                                  rep_y=plan.Ex)

    def res_k(x):
        return grid_core.grid_residual(gdp, w, diag, x, rhs)

    def res_p(x):
        return grid_core.grid_residual_plain(gdp, w, diag, x, rhs)

    for a, b in zip(dct_lattice._factor(op, w), dct_lattice.factor_plain(op, w)):
        _close(a.cpu(), b.cpu().numpy(), 1e-12)
    _close(dct_lattice.transform(op, rhs).cpu(), dct_lattice.transform_plain(op, rhs).cpu().numpy(),
           1e-12)
    _close(dct_lattice.dct_lattice(op, w, rhs, res_k, n_refine=0).cpu(),
           dct_lattice.dct_lattice_plain(op, w, rhs, res_p, n_refine=0).cpu().numpy(), 1e-12)
    _close(dct_lattice.dct_lattice(op, w, rhs, res_k).cpu(),
           dct_lattice.dct_lattice_plain(op, w, rhs, res_p).cpu().numpy(), 1e-12)
    _close(dct_lattice.dct_matrix(4100, dev).cpu(),
           PLat._dct2_matrix_device(4100, dev).cpu().numpy(), 1e-12)
    classes = PLat._plan_shift_matvec(ap)
    offsets = np.asarray([d for d, _, _ in classes], np.int32)
    cw = _t(np.stack([np.asarray(v) for _, v in class_w])).to(dev)
    dr = _t(np.stack([np.asarray(diag_j), np.asarray(rhs_j)], axis=1)).to(dev)
    splan = shift_matvec.ShiftPlan(offsets, gdp.num_bifurcations, dev, stride=2)
    for a, b in zip(shift_matvec.shift_matvec(splan, cw, dr[:, 0], lam, dr[:, 1], norm=True),
                    shift_matvec.shift_matvec_plain(offsets, cw, dr[:, 0], lam, dr[:, 1], norm=True)):
        _close(a.cpu(), b.cpu().numpy(), 1e-12)
    torch.cuda.synchronize()


# ------------------------------------------------------------------ launch counts, plans


def _synthetic_dct_plan(s, ny, r, seed=0):
    """A DCT plan of an s × ny lattice with r stub rows, from a seed: enough
    for the operator's construction and its launch count (no solve)."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(s * ny, size=r, replace=False))
    return PLat._DctPlan(
        s=s, ny=ny, len_x=1.0, lamx=rng.uniform(0, 4, s), lamy=rng.uniform(0, 4, ny),
        g_geo=rng.standard_normal((r, s * ny)), stub_rows=rows, stub_edge_idx=np.arange(r) + 2,
        stub_edge_group=np.arange(r), rep_x=0, rep_y=1,
    )


@pytest.mark.parametrize("dims,r", [((512, 512), 2), ((5000, 3), 2), ((3, 4200), 2), ((6, 5), 1),
                                    ((6, 5), 16)])
def test_dct_lattice_cuda_launches(dims, r):
    """K16's launches a solve are the factor's two and six a pass, whatever
    the shape or the stub rows (no split-K reduce launch): 20 at the
    reference's two refinement passes, within the budget of 20."""
    s, ny = dims
    op = dct_lattice.dct_operator(_synthetic_dct_plan(s, ny, r), "cpu")
    assert op.r == r and op.B == s * ny
    assert dct_lattice.cuda_launches(op) == dct_lattice.cuda_launches(op, dct_lattice.N_REFINE) == 20
    assert [dct_lattice.cuda_launches(op, n) for n in range(4)] == [8, 14, 20, 26]


def test_grid_route_solve_makes_the_counted_calls(monkeypatch):
    """One grid-route solve makes K17's four calls (one launch each on the
    card: the assembly, two refinement stencils and the final residual with
    its norm) and K16's three passes, as ``grid_core.cuda_launches`` and
    ``dct_lattice.cuda_launches`` count them."""
    calls = {"assembly": 0, "stencil": 0, "pass": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(grid_core, "grid_core_plain", counted("assembly", grid_core.grid_core_plain))
    monkeypatch.setattr(grid_core, "grid_residual_plain",
                        counted("stencil", grid_core.grid_residual_plain))
    monkeypatch.setattr(dct_lattice, "direct_plain", counted("pass", dct_lattice.direct_plain))
    asm = _assembler(P, GRIDS["9x4"], N=1, f=0.3)
    s = P.Solver(asm, options=P.SolverOptions(schur_method="dct"), device="cpu")
    s.solve()
    assert isinstance(s._executor, PS._GridExecutor) and s.info.converged
    assert calls["assembly"] + calls["stencil"] == grid_core.cuda_launches() == 4
    assert calls["assembly"] == 1
    assert calls["pass"] == 1 + dct_lattice.N_REFINE
    assert dct_lattice.cuda_launches(s._executor.operator) == 2 + 6 * calls["pass"]


@pytest.mark.parametrize("M,N,K", [(3, 3, 3), (66, 66, 66), (517, 300, 300), (517, 300, 517),
                                   (3, 5000, 5000), (5000, 3, 5000), (512, 512, 512), (4200, 3, 4200),
                                   (1, 1, 1), (64, 64, 64)])
@pytest.mark.parametrize("sms", [132, 8])
def test_gemm_plan_on_ragged_shapes(M, N, K, sms):
    """The product's k split: 1 to 8 blocks a tile (one cluster), a power of
    two before the 32-deep slab rounding, no more blocks than fill the SMs
    once (or one a tile), each slice at least 64 deep when split, and the
    kernel's own count of slices (ceil(K / kchunk)) equal to it."""
    split = dct_lattice.gemm_plan(M, N, K, sms)
    tm, tn = dct_lattice.TILE
    tiles = -(-M // tm) * -(-N // tn)
    assert 1 <= split <= dct_lattice.MAX_SPLIT
    assert split == 1 or split * tiles <= sms
    assert split == 1 or K // split >= 64 - dct_lattice.SLAB_K
    kchunk = -(-(-(-K // split)) // dct_lattice.SLAB_K) * dct_lattice.SLAB_K
    assert -(-K // kchunk) == split
    if (M, N, K, sms) == (512, 512, 512, 132):
        assert split == min(dct_lattice.MAX_SPLIT, 132 // tiles)


@pytest.mark.parametrize("transA,transB,scaled", [(0, 0, 0), (1, 0, 1), (0, 1, 0), (1, 1, 1)])
def test_product_plain_is_matmul(transA, transB, scaled):
    """The product's plain version: ``op(A) op(B)`` (``∘ S``) in
    ``torch.matmul``, the yardstick the card holds the kernel to."""
    rng = np.random.default_rng(11)
    M, N, K = 7, 5, 9
    A = _t(rng.standard_normal((K, M) if transA else (M, K)))
    B = _t(rng.standard_normal((N, K) if transB else (K, N)))
    S = _t(rng.standard_normal((M, N))) if scaled else None
    want = (A.numpy().T if transA else A.numpy()) @ (B.numpy().T if transB else B.numpy())
    if scaled:
        want = want * S.numpy()
    got = dct_lattice.product(A, B, bool(transA), bool(transB), S)
    _close(got, want, 1e-14)


def _cpu_plan_and_operator():
    ap = _assembler(P, GRIDS["two_stubs"], N=1)
    dct = PLat._plan_dct_lattice(ap, PLat._plan_shift_matvec(ap))
    plan = PLat._plan_grid_layout(ap, dct)
    return plan, PLat.device_grid_plan(plan, "cpu"), dct_lattice.dct_operator(dct, "cpu")


@pytest.mark.parametrize("field", ["edge_src", "edge_tgt", "stub_rows", "stub_s_bif"])
@pytest.mark.parametrize("fault", ["int64", "meta", "short", "strided"])
def test_grid_device_plan_validates_once(field, fault):
    """K17's plan is validated where it is built: each table a contiguous
    int32 tensor of the host plan's length, with data, on the device of the
    others; an int64 table, a table on another device, a short or a strided
    one raise at construction (so a call checks only its float64 tensors)."""
    plan, gdp, _ = _cpu_plan_and_operator()
    assert gdp.index == -1 and gdp.blocks == -(-gdp.num_bifurcations // PLat.GRID_THREADS)
    t = getattr(gdp, field)
    bad = {"int64": lambda: t.long(), "meta": lambda: t.to("meta"), "short": lambda: t[:-1],
           "strided": lambda: torch.stack([t, t], 1)[:, 0]}[fault]()
    with pytest.raises(ValueError, match="GridDevicePlan"):
        dataclasses.replace(gdp, **{field: bad})


@pytest.mark.parametrize("field", ["Dx", "Dy", "lamx", "lamy", "g_geo", "stub_rows", "stub_edge",
                                   "stub_group"])
@pytest.mark.parametrize("fault", ["dtype", "meta", "shape"])
def test_dct_operator_validates_once(field, fault):
    """K16's operator is validated at construction: float64 matrices,
    eigenvalues and columns and int32 tables, contiguous, of the plan's
    shapes, on one device with data; an int64 table (or a float32 matrix),
    a tensor on another device or a wrong shape raise there."""
    _, _, op = _cpu_plan_and_operator()
    assert op.index == -1 and op.plans == () and op.n_edges == int(op.stub_edge.max()) + 1
    t = getattr(op, field)
    other = torch.int64 if t.dtype == torch.int32 else torch.float32
    bad = {"dtype": lambda: t.to(other), "meta": lambda: t.to("meta"),
           "shape": lambda: t.reshape(1, -1) if t.dim() == 1 else t.reshape(-1)}[fault]()
    with pytest.raises(ValueError, match="DctOperator"):
        dataclasses.replace(op, **{field: bad})


def test_dct_operator_keeps_no_scratch_on_the_cpu():
    """The plain path neither plans products nor holds per-stream scratch."""
    _, gdp, op = _cpu_plan_and_operator()
    w = _t(np.full(gdp.num_edges, 2.0))
    rhs, diag, _ = grid_core.grid_core(gdp, w, _t(np.ones(gdp.num_edges)), _t(np.zeros(gdp.num_edges)))
    dct_lattice.dct_lattice(op, w, rhs, lambda lam: grid_core.grid_residual(gdp, w, diag, lam, rhs))
    assert op._scratch == {} and gdp._scratch == {}


@pytest.mark.cuda
def test_grid_core_streams_repeats_and_capture_on_card():
    """On a CUDA device: K17 with its norm on two streams at once gives the
    bits of the calls alone (each stream has its own partials and ticket),
    two back-to-back calls give equal bits, and a call captured into a CUDA
    graph replays to the same bits (the ticket is reset inside the launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    ap = _assembler(P, lambda pkg: _grid(pkg, 96, 80), N=1)
    dct = PLat._plan_dct_lattice(ap, PLat._plan_shift_matvec(ap))
    gdp = PLat.device_grid_plan(PLat._plan_grid_layout(ap, dct), dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    E, B = gdp.num_edges, gdp.num_bifurcations
    w = torch.rand(E, generator=gen, dtype=torch.float64, device=dev) + 0.5
    diag = torch.rand(B, generator=gen, dtype=torch.float64, device=dev) + 4.0
    rhs = torch.randn(B, generator=gen, dtype=torch.float64, device=dev)
    lams = [torch.randn(B, generator=gen, dtype=torch.float64, device=dev) for _ in range(2)]
    want = [grid_core.grid_residual(gdp, w, diag, lam, rhs, norm=True) for lam in lams]
    again = grid_core.grid_residual(gdp, w, diag, lams[0], rhs, norm=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, want[0]))
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = []
    for st, lam in zip(streams, lams):
        with torch.cuda.stream(st):
            got.append([grid_core.grid_residual(gdp, w, diag, lam, rhs, norm=True) for _ in range(4)])
    torch.cuda.synchronize()
    for runs, ref in zip(got, want):
        assert all(torch.equal(a, b) for run in runs for a, b in zip(run, ref))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = grid_core.grid_residual(gdp, w, diag, lams[1], rhs, norm=True)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, want[1]))


@pytest.mark.cuda
def test_shift_matvec_streams_repeats_and_capture_on_card():
    """On a CUDA device: K18's residual with its norm is one launch a call,
    its apply the plain version's to the bit; on two streams at once the
    calls give the bits of the calls alone, two back-to-back calls give equal
    bits, and a call captured into a CUDA graph replays to the same bits (the
    ticket is reset inside the launch); the Chebyshev step holds its plain
    version at 1e-12·scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    ap = _assembler(P, lambda pkg: _grid(pkg, 96, 80), N=1)
    classes = PLat._plan_shift_matvec(ap)
    offsets = np.asarray([d for d, _, _ in classes], np.int32)
    B = ap.network.num_multipliers
    plan = shift_matvec.ShiftPlan(offsets, B, dev, stride=2)
    gen = torch.Generator(device=dev).manual_seed(7)
    cw = torch.rand((offsets.size, B), generator=gen, dtype=torch.float64, device=dev) + 0.5
    dr = torch.randn((B, 2), generator=gen, dtype=torch.float64, device=dev)
    dr[:, 0] += 8.0
    diag, rhs = dr[:, 0], dr[:, 1]
    lams = [torch.randn(B, generator=gen, dtype=torch.float64, device=dev) for _ in range(2)]
    before = shift_matvec.shift_matvec.launches
    want = [shift_matvec.shift_matvec(plan, cw, diag, lam, rhs, norm=True) for lam in lams]
    assert shift_matvec.shift_matvec.launches == before + 2
    plain = shift_matvec.shift_matvec_plain(offsets, cw, diag, lams[0], rhs, norm=True)
    assert torch.equal(want[0][0], plain[0])
    _close(want[0][1].cpu(), plain[1].cpu().numpy(), 1e-12)
    assert torch.equal(shift_matvec.shift_matvec(plan, cw, diag, lams[0]),
                       shift_matvec.shift_matvec_plain(offsets, cw, diag, lams[0]))
    again = shift_matvec.shift_matvec(plan, cw, diag, lams[0], rhs, norm=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, want[0]))
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = []
    for st, lam in zip(streams, lams):
        with torch.cuda.stream(st):
            got.append([shift_matvec.shift_matvec(plan, cw, diag, lam, rhs, norm=True) for _ in range(4)])
    torch.cuda.synchronize()
    for runs, ref in zip(got, want):
        assert all(torch.equal(a, b) for run in runs for a, b in zip(run, ref))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = shift_matvec.shift_matvec(plan, cw, diag, lams[1], rhs, norm=True)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, want[1]))
    flat = shift_matvec.ShiftPlan(offsets, B, dev)
    d = diag.contiguous()
    s = 1.0 / torch.sqrt(d)
    outs = []
    for fn, key in ((shift_matvec.shift_cheb, flat), (shift_matvec.shift_cheb_plain, offsets)):
        dvec, x_out, z = torch.ones_like(d), torch.empty_like(d), torch.empty_like(d)
        fn(key, cw, d, s, rhs.contiguous(), dvec, lams[0], x_out, 0.7, 0.3, z, lams[1])
        outs.append((dvec, x_out, z))
    for a, b in zip(*outs):
        _close(a.cpu(), b.cpu().numpy(), 1e-12)


@pytest.mark.cuda
def test_dct_lattice_streams_and_ragged_products_on_card():
    """On a CUDA device: two K16 solves on two streams at once equal the
    solves alone (each stream has its own scratch), and the product kernel
    holds ``torch.matmul`` at 1e-12·scale on ragged shapes, transposed or
    not, scaled or not, at every k split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    ap = _assembler(P, lambda pkg: _grid(pkg, 70, 45), N=1)
    dct = PLat._plan_dct_lattice(ap, PLat._plan_shift_matvec(ap))
    plan = PLat._plan_grid_layout(ap, dct)
    gdp = PLat.device_grid_plan(plan, dev)
    tail = plan.Ex + plan.Ey + np.arange(plan.stub_rows_e.size)
    op = dct_lattice.dct_operator(dct, dev, stub_edge=tail, stub_group=plan.stub_group, rep_x=0,
                                  rep_y=plan.Ex)
    gen = torch.Generator(device=dev).manual_seed(6)
    E, B = gdp.num_edges, gdp.num_bifurcations
    w = torch.full((E,), 0.7, dtype=torch.float64, device=dev)
    rhs = [torch.randn(B, generator=gen, dtype=torch.float64, device=dev) for _ in range(2)]
    _, diag, _ = grid_core.grid_core(gdp, w, torch.zeros(E, dtype=torch.float64, device=dev),
                                     torch.zeros(E, dtype=torch.float64, device=dev))

    def solve(b):
        return dct_lattice.dct_lattice(op, w, b, lambda lam: grid_core.grid_residual(gdp, w, diag, lam, b))

    want = [solve(b) for b in rhs]
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got = []
    for st, b in zip(streams, rhs):
        with torch.cuda.stream(st):
            got.append([solve(b) for _ in range(3)])
    torch.cuda.synchronize()
    for runs, ref in zip(got, want):
        assert all(torch.equal(x, ref) for x in runs)
    for M, N, K in [(3, 3, 3), (66, 66, 66), (517, 300, 300), (300, 517, 517), (130, 70, 1000)]:
        for tA, tB in [(0, 0), (1, 0), (0, 1), (1, 1)]:
            A = torch.randn((K, M) if tA else (M, K), generator=gen, dtype=torch.float64, device=dev)
            Bm = torch.randn((N, K) if tB else (K, N), generator=gen, dtype=torch.float64, device=dev)
            S = torch.randn((M, N), generator=gen, dtype=torch.float64, device=dev)
            want_p = dct_lattice.product_plain(A, Bm, bool(tA), bool(tB), S)
            for split in range(1, dct_lattice.MAX_SPLIT + 1):
                got_p = dct_lattice.product(A, Bm, bool(tA), bool(tB), S, split=split)
                _close(got_p.cpu(), want_p.cpu().numpy(), 1e-12)
