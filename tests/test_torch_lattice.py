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
                                    segsum.segsum)
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
                                                    torch.int32), len(classes), segsum.segsum)
    dr = _t(np.stack([np.asarray(diag_j), np.asarray(rhs_j)], axis=1))
    lam = np.random.default_rng(5).standard_normal(B)
    want = rhs_j - JS._shift_matvec(class_w, diag_j, B)(jnp.asarray(lam))
    got, norm = shift_matvec.shift_matvec(offsets, cw, dr, _t(lam), norm=True)
    _close(got, want, 1e-12)
    _close(norm, jnp.linalg.norm(want), 1e-12)


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

    def residual(lam):
        return shift_matvec.shift_matvec(offsets, cw, dr, lam)

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
    shift_matvec.shift_matvec(np.array([-1, 1], np.int32), _t(np.ones((2, B))),
                              _t(np.ones((B, 2))), _t(np.ones(B)))
    assert all(n == 0 for n in kernels.launches().values())
    meta = torch.ones(B, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        grid_core.grid_core(gdp, meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        grid_core.grid_residual(gdp, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        dct_lattice.dct_lattice(op, meta, meta, None)
    with pytest.raises(ValueError, match="CUDA"):
        shift_matvec.shift_matvec(np.array([-1, 1], np.int32), meta, meta, meta)
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
    for a, b in zip(shift_matvec.shift_matvec(offsets, cw, dr, lam, norm=True),
                    shift_matvec.shift_matvec_plain(offsets, cw, dr, lam, norm=True)):
        _close(a.cpu(), b.cpu().numpy(), 1e-12)
    torch.cuda.synchronize()
