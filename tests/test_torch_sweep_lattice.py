"""Scenario sweeps on the lattice route (the separable-DCT λ solve).

``solve_sweep`` sends a uniform scalar-R lattice to the DCT solve, under
``auto`` (0 < B ≤ 4,096 by the sweep's own probe, above it through the
executor's routing) and under ``schur_method="dct"``; there the port runs
the S scenarios in the launches of one solve: on the grid route
(``_GridExecutor.scenarios``) K1, K17's assembly, K16's factors (S of them
for an R batch, one for a shared R) and passes with K17's stencil over S as
their residual, and K5; on the general route (``_DctExecutor.scenarios``,
a callable source) K8a, the bifurcation system, K6's class weights, K16
with K18 over S, and K8b.  ``GridFactorization.solve_batch`` runs its rows
on the same scenario kernels.

Held here, on the CPU (the kernels' plain versions): the sweeps against the
JAX package's ``solve_sweep`` at 1e-10·scale (scale = max(1, max |x|)) on
``make_grid(8, 6)`` at N = 2 and on a lattice with four stub edges, for R,
per-edge f, per-cell f, p_bc and R + p_bc batches at k = 1 and 2 under both
methods; the general route with R and p_bc batches; the mirror of the
reference's ``test_grid_sweep_vmaps_dct_path`` against host LU at
1e-9·scale; every row equal to ``Solver(schur_method="dct").solve()`` of
that row bit for bit, also above 4,096 bifurcations; each scenario plain
version equal to its one-scenario plain version row by row
(``torch.equal``) with batched and shared inputs, and their shape refusals;
each scenario wrapper called once a sweep whatever S (the stencil once a
refinement pass), and one factor for a shared R; ``solve_batch`` against
the JAX package's at 1e-10·scale and ``solve()``'s bits.  The
``cuda``-marked test holds the scenario kernels on the card against the
one-scenario kernels bit for bit and against the plain versions, a sweep on
two streams, a replayed graph of K17's scenario stencil and 70,000
scenarios (past the grid's y limit).  The JAX package is imported only
inside the tests that compare with it.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import batch as PB
from networks_fenicsx_tpu_torch import factorization as PF
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch.kernels import (
    condense, dct_lattice, expand, grid_core, segsum, shift_matvec,
)

torch.set_num_threads(1)

CPU = {"device": "cpu"}
DCT = {"schur_method": "dct"}
TOL_JAX = 1e-10  # the lattice's bar against the JAX package (tests/test_torch_sweep.py)
TOL_LU = 1e-9  # tests/test_grid_blocked.py:120 against host LU


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _two_stubs(pkg):
    """make_grid(6, 5) with a second inlet and an outlet on its inlet
    corner: four stub edges, three of them on one λ row."""
    G = pkg.network_generation.make_grid(6, 5, arrays=True)
    pos = np.asarray(G.pos)
    V = pos.shape[0]
    pos = np.concatenate([pos, [[-0.2, -0.3], [0.1, -0.4]]])
    edges = np.concatenate([np.asarray(G.edges), [[V, 0], [0, V + 1]]])
    return pkg.ArrayNetwork(pos=pos, edges=edges)


GRAPHS = {
    "8x6": lambda pkg: pkg.network_generation.make_grid(8, 6, arrays=True),
    "two_stubs": _two_stubs,
}
# the base source of each batch: its kind (and so the grid route's f layout)
BASE_F = {"R": "cell", "f_edge": "edge", "f_cell": "cell", "p_bc": "scalar", "R+p_bc": "edge"}


def _source(kind, mesh, seed):
    rng = np.random.default_rng(seed)
    if kind == "scalar":
        return 0.3
    if kind == "edge":
        return rng.uniform(-1.0, 1.0, mesh.num_edges)
    if kind == "cell":
        return rng.uniform(-1.0, 1.0, mesh.num_cells)
    return lambda x: x[0] + 0.3 * x[1]  # a callable: the general DCT route


def _assembler(pkg, graph, k, f_kind, R=1.7, seed=0):
    mesh = pkg.NetworkMesh(GRAPHS[graph](pkg), N=2, color_strategy="fast")
    asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k)
    asm.compute_forms(p_bc_ex=lambda x: x[0] + 0.2 * x[1], R=R, f=_source(f_kind, mesh, seed))
    return asm


def _batches(mesh, batch, S, seed):
    """Scenario batches over the compact kinds: R ``(S, 1)``, f ``(S, E)`` or
    ``(S, cells)``, p_bc ``(S, graph nodes)`` (row ``i`` is ``a_i·x +
    c_i·y`` at the graph's nodes; ``_pbc`` holds ``(a, c)``)."""
    rng = np.random.default_rng(seed)
    out = {}
    if "R" in batch:
        out["R"] = rng.uniform(0.5, 2.5, (S, 1))
    if batch == "f_edge":
        out["f"] = rng.uniform(-1.0, 1.0, (S, mesh.num_edges))
    if batch == "f_cell":
        out["f"] = rng.uniform(-1.0, 1.0, (S, mesh.num_cells))
    if "p_bc" in batch:
        xy = mesh.vertices[: mesh.num_graph_nodes]
        a, c = rng.uniform(-2.0, 2.0, S), rng.uniform(-1.0, 1.0, S)
        out["p_bc_node_values"] = a[:, None] * xy[:, 0][None] + c[:, None] * xy[:, 1][None]
        out["_pbc"] = (a, c)
    return out


def _sweep(asm, options, batches):
    return P.solve_sweep(asm, options=options, **CPU,
                         **{k: v for k, v in batches.items() if k != "_pbc"})


def _executor(asm):
    return list(asm._sweep_cache.values())[-1][1]


# ------------------------------------------------------- the port against the JAX package


@pytest.mark.parametrize("method", ["auto", "dct"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("batch", list(BASE_F))
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_grid_sweep_matches_jax(graph, batch, k, method):
    """The grid route's sweep (``_GridExecutor.scenarios``) against the JAX
    package's vmapped one at 1e-10·scale."""
    import networks_fenicsx_tpu as J

    aj, ap = (_assembler(pkg, graph, k, BASE_F[batch], seed=k) for pkg in (J, P))
    batches = _batches(ap.network, batch, 3, seed=10 * k + len(batch))
    batches.pop("_pbc", None)
    xj = np.asarray(J.solve_sweep(aj, options=J.SolverOptions(schur_method=method), **batches).x)
    xp = P.solve_sweep(ap, options=P.SolverOptions(schur_method=method), **CPU, **batches).x
    ex = _executor(ap)
    assert type(ex) is PS._GridExecutor and ex.has_scenario_axis
    _close(xp, xj, TOL_JAX)


@pytest.mark.parametrize("method", ["auto", "dct"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("batch", ["R", "p_bc", "R+p_bc"])
def test_general_dct_sweep_matches_jax(batch, k, method):
    """A lattice with a callable source takes the general DCT route
    (``_DctExecutor.scenarios``: K8a, the system, K6, K16 with K18, K8b over
    S); against the JAX package's sweep at 1e-10·scale."""
    import networks_fenicsx_tpu as J

    graph = "two_stubs" if k == 2 else "8x6"
    aj, ap = (_assembler(pkg, graph, k, "callable") for pkg in (J, P))
    batches = _batches(ap.network, batch, 3, seed=k)
    batches.pop("_pbc", None)
    xj = np.asarray(J.solve_sweep(aj, options=J.SolverOptions(schur_method=method), **batches).x)
    xp = P.solve_sweep(ap, options=P.SolverOptions(schur_method=method), **CPU, **batches).x
    ex = _executor(ap)
    assert type(ex) is PS._DctExecutor and ex.has_scenario_axis
    _close(xp, xj, TOL_JAX)


def test_grid_sweep_vmaps_dct_path():
    """tests/test_grid_blocked.py:120: ``solve_sweep`` on a lattice engages
    the DCT/grid executor (no per-scenario dense Cholesky), now on its
    scenario axis, and matches per-scenario host LU for per-edge and
    per-cell source batches at 1e-9·scale."""
    rng = np.random.default_rng(5)
    mesh = P.NetworkMesh(P.network_generation.make_grid(8, 6, arrays=True), N=2)
    for kind in ("edge", "cell"):
        n = mesh.num_edges * (1 if kind == "edge" else mesh.N)
        asm = P.HydraulicNetworkAssembler(mesh)
        asm.compute_forms(p_bc_ex=lambda x: x[0], f=rng.uniform(0.5, 1.5, n), R=1.0)
        fb = rng.uniform(-1.0, 1.0, (3, n))
        res = P.solve_sweep(asm, f=fb, **CPU)
        ex = list(asm._sweep_cache.values())[0][1]
        assert isinstance(ex, PS._GridExecutor) and ex.has_scenario_axis
        X = res.x
        for i in range(3):
            asm2 = P.HydraulicNetworkAssembler(mesh)
            asm2.compute_forms(p_bc_ex=lambda x: x[0], f=fb[i], R=1.0)
            s = P.Solver(asm2, options=P.SolverOptions(method="host_lu"), **CPU)
            s.solve()
            ref = s.solution_vector()
            np.testing.assert_allclose(X[i], ref, atol=TOL_LU * max(1.0, np.abs(ref).max()))


# ------------------------------------------------------- rows equal solves


def _rows_equal_solve(asm, base_f, batches, options, rows=range(3)):
    """A sweep's rows against ``Solver(schur_method="dct").solve()`` of each
    row's forms, ``np.array_equal``."""
    res = _sweep(asm, options, batches)
    assert _executor(asm).has_scenario_axis
    solver = P.Solver(asm, options=P.SolverOptions(**DCT), **CPU)
    for i in rows:
        p_bc = lambda x: x[0] + 0.2 * x[1]  # noqa: E731
        if "_pbc" in batches:
            a, c = (float(t[i]) for t in batches["_pbc"])
            p_bc = lambda x, a=a, c=c: a * x[0] + c * x[1]  # noqa: E731
        asm.compute_forms(p_bc_ex=p_bc, R=float(batches["R"][i, 0]) if "R" in batches else 1.7,
                          f=batches["f"][i] if "f" in batches else base_f)
        solver.solve()
        assert np.array_equal(res.x[i], solver.solution_vector()), i
    return res


@pytest.mark.parametrize("batch", ["R", "f_edge", "f_cell", "p_bc", "R+p_bc"])
def test_grid_sweep_rows_equal_solve(batch):
    """Each row of a grid-route sweep is ``Solver(schur_method="dct")`` of
    that row bit for bit (a p_bc row: the executor's call on that row's
    boundary values)."""
    asm = _assembler(P, "two_stubs", 1, BASE_F[batch], seed=3)
    base_f = _source(BASE_F[batch], asm.network, 3)
    batches = _batches(asm.network, batch, 3, seed=4)
    _rows_equal_solve(asm, base_f, batches, P.SolverOptions())
    assert type(_executor(asm)) is PS._GridExecutor


@pytest.mark.parametrize("batch", ["R", "p_bc"])
def test_general_dct_sweep_rows_equal_solve(batch):
    """Each row of a general-route sweep (a callable source) is the row's
    ``Solver(schur_method="dct")`` bit for bit."""
    asm = _assembler(P, "8x6", 2, "callable")
    base_f = _source("callable", asm.network, 0)
    batches = _batches(asm.network, batch, 3, seed=6)
    _rows_equal_solve(asm, base_f, batches, P.SolverOptions(schur_method="dct"))
    assert type(_executor(asm)) is PS._DctExecutor


def test_large_lattice_auto_sweep():
    """Above 4,096 bifurcations ``auto`` keeps its own routing, which takes
    the DCT solve in the executor: a 66 × 66 lattice's R sweep runs on the
    grid route's scenario axis, its rows ``solve()``'s bits."""
    mesh = P.NetworkMesh(P.network_generation.make_grid(66, 66, arrays=True), N=1,
                         color_strategy="fast")
    assert mesh.num_multipliers > 4096
    asm = P.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0] + 0.2 * x[1], R=1.7, f=0.3)
    batches = {"R": np.array([[0.8], [2.2]])}
    _rows_equal_solve(asm, 0.3, batches, P.SolverOptions(), rows=range(2))
    assert type(_executor(asm)) is PS._GridExecutor


# ------------------------------------------------------- plain versions, launches


def _grid_inputs(S, seed, R_shared=False, graph="two_stubs", k=1):
    """A grid executor on the CPU and K1's scenario outputs of random inputs:
    R ``(S, 1)`` (or shared), per-cell f and boundary data ``(S, E)``."""
    asm = _assembler(P, graph, k, "cell")
    ex = PS.build_schur_executor(asm, P.SolverOptions(**DCT), device="cpu")
    assert type(ex) is PS._GridExecutor
    gdp, N = ex.device_plan, ex._N
    E = gdp.num_edges
    rng = np.random.default_rng(seed)
    R = torch.as_tensor(rng.uniform(0.5, 2.5, (1,) if R_shared else (S, 1)))
    f = torch.as_tensor(rng.uniform(-1.0, 1.0, (S, N, E)))
    plan = gdp.plan
    sp = torch.as_tensor(rng.uniform(-1.0, 1.0, (S, E)) * ~np.asarray(plan.s_is_bif))
    ep = torch.as_tensor(rng.uniform(-1.0, 1.0, (S, E)) * ~np.asarray(plan.t_is_bif))
    out = condense.condense_scenarios(gdp, N, k, ex._h_e, R, f, "scalar", "cell", sp, ep)
    return ex, out


def _state_row(state, i):
    return dct_lattice.DctState(*(t[i] for t in state))


@pytest.mark.parametrize("R_shared", [False, True])
@pytest.mark.parametrize("S", [1, 5])
def test_grid_scenario_plain_equals_rows(S, R_shared):
    """K17's and K16's scenario plain versions are their one-scenario plain
    versions row by row (``torch.equal``): the assembly with batched or
    shared conductances (one ``diag`` then), the stencil with and without
    its norm, the factors, and the passes on S factors or on one."""
    ex, (W, w, g, Ftot, const) = _grid_inputs(S, seed=S + 7 * R_shared, R_shared=R_shared)
    gdp, op = ex.device_plan, ex.operator
    ws = w[0] if R_shared else w
    rhs, diag, nrm = grid_core.grid_core_scenarios(gdp, ws, const, Ftot)
    assert diag.shape == ((gdp.num_bifurcations,) if R_shared else (S, gdp.num_bifurcations))
    assert grid_core.grid_core_scenarios(gdp, ws, const, Ftot, norm=False)[2] is None
    lam_any = torch.as_tensor(np.random.default_rng(S).standard_normal((S, op.B)))
    res, rn = grid_core.grid_residual_scenarios(gdp, ws, diag, lam_any, rhs, norm=True)
    res0 = grid_core.grid_residual_scenarios(gdp, ws, diag, lam_any, rhs)
    for i in range(S):
        wi, di = (ws, diag) if R_shared else (w[i], diag[i])
        one = grid_core.grid_core_plain(gdp, wi, const[i], Ftot[i])
        assert torch.equal(rhs[i], one[0]) and torch.equal(di, one[1]) and torch.equal(nrm[i], one[2])
        r1, n1 = grid_core.grid_residual_plain(gdp, wi, di, lam_any[i], rhs[i], norm=True)
        assert torch.equal(res[i], r1) and torch.equal(rn[i], n1) and torch.equal(res0[i], r1)
    states = {"batched": dct_lattice.dct_factor_scenarios(op, w)}
    states["shared"] = dct_lattice.factor_plain(op, w[0])
    for i in range(S):
        one = dct_lattice.factor_plain(op, w[i])
        assert all(torch.equal(a, b) for a, b in zip(_state_row(states["batched"], i), one))
    for kind, state in states.items():
        for n_refine in (0, 2):
            lam = dct_lattice.dct_apply_scenarios(
                op, state, rhs,
                lambda x: grid_core.grid_residual_scenarios(gdp, ws, diag, x, rhs), n_refine)
            for i in range(S):
                wi, di = (ws, diag) if R_shared else (w[i], diag[i])
                st = state if kind == "shared" else _state_row(state, i)
                one = dct_lattice.dct_apply_plain(
                    op, st, rhs[i].clone(),
                    lambda x: grid_core.grid_residual_plain(gdp, wi, di, x, rhs[i]), n_refine)
                assert torch.equal(lam[i], one), (kind, n_refine, i)
                if kind == "batched" and n_refine == 2:  # the one-solve path: factor and passes
                    solve = dct_lattice.dct_lattice_plain(
                        op, w[i], rhs[i].clone(),
                        lambda x: grid_core.grid_residual_plain(gdp, wi, di, x, rhs[i]))
                    assert torch.equal(lam[i], solve), i


def _general_inputs(S, seed):
    asm = _assembler(P, "two_stubs", 1, "callable")
    ex = PS.build_schur_executor(asm, P.SolverOptions(**DCT), device="cpu")
    assert type(ex) is PS._DctExecutor
    dlp = ex.device_plan
    B, C = dlp.num_bifurcations, dlp.offsets.size
    rng = np.random.default_rng(seed)
    w_edges = torch.as_tensor(rng.uniform(0.5, 2.0, (S, dlp.num_edges)))
    dr = torch.as_tensor(rng.uniform(1.0, 3.0, (S, B, 2)))
    x = torch.as_tensor(rng.standard_normal((S, B)))
    return ex, dlp, w_edges, dr, x, C


@pytest.mark.parametrize("cw_shared", [False, True])
@pytest.mark.parametrize("S", [1, 5])
def test_shift_scenario_plain_equals_rows(S, cw_shared):
    """K18's scenario plain version is its one-scenario plain version row by
    row (``torch.equal``): ``diag`` and ``b`` the stride-2 columns of the
    ``(S, B, 2)`` systems (or one shared column), class weights batched from
    K6 over S or shared; with and without ``b`` and the norm."""
    ex, dlp, w_edges, dr, x, C = _general_inputs(S, seed=S + 3 * cw_shared)
    plan = dlp.shift
    if cw_shared:
        cw = segsum.segsum_plan(dlp.class_sums, w_edges[0])[0].view(C, -1)
    else:
        cw = segsum.segsum_plan_scenarios(dlp.class_sums, w_edges)[0].view(S, C, -1)
    diag, b = dr[:, :, 0], dr[:, :, 1]
    diag_s = dr[0, :, 0]
    out = shift_matvec.shift_matvec_scenarios(plan, cw, diag, x)
    res, nrm = shift_matvec.shift_matvec_scenarios(plan, cw, diag_s, x, b, norm=True)
    for i in range(S):
        cwi = cw if cw_shared else cw[i]
        assert torch.equal(out[i], shift_matvec.shift_matvec_plain(plan.offsets, cwi, diag[i], x[i]))
        r1, n1 = shift_matvec.shift_matvec_plain(plan.offsets, cwi, diag_s, x[i], b[i], norm=True)
        assert torch.equal(res[i], r1) and torch.equal(nrm[i], n1)


def test_lattice_scenario_shapes_raise():
    """The new wrappers refuse what their kernels do not take."""
    ex, (W, w, g, Ftot, const) = _grid_inputs(3, seed=1)
    gdp, op = ex.device_plan, ex.operator
    with pytest.raises(ValueError, match="scenarios"):
        grid_core.grid_core_scenarios(gdp, w, const[:2], Ftot)
    with pytest.raises(ValueError, match="expected"):
        grid_core.grid_core_scenarios(gdp, w[:, :-1], const, Ftot)
    rhs, diag, _ = grid_core.grid_core_scenarios(gdp, w, const, Ftot)
    with pytest.raises(ValueError, match="scenarios"):
        grid_core.grid_residual_scenarios(gdp, w, diag, rhs[:2], rhs)
    with pytest.raises(ValueError, match="w must be"):
        dct_lattice.dct_factor_scenarios(op, w[0])
    with pytest.raises(ValueError, match="w must be"):
        dct_lattice.dct_factor_scenarios(op, w[:, :2])
    state = dct_lattice.dct_factor_scenarios(op, w)
    with pytest.raises(ValueError, match="the state must be"):
        dct_lattice.dct_apply_scenarios(op, state, rhs[:2], lambda x: x)
    with pytest.raises(ValueError, match="rhs must be"):
        dct_lattice.dct_apply_scenarios(op, state, rhs[0], lambda x: x)
    _, dlp, w_edges, dr, x, C = _general_inputs(3, seed=2)
    cw = segsum.segsum_plan_scenarios(dlp.class_sums, w_edges)[0].view(3, C, -1)
    with pytest.raises(ValueError, match="cw must be"):
        shift_matvec.shift_matvec_scenarios(dlp.shift, cw[:2], dr[:, :, 0], x)
    with pytest.raises(ValueError, match="x must be"):
        shift_matvec.shift_matvec_scenarios(dlp.shift, cw, dr[:, :, 0], x[0])
    with pytest.raises(ValueError, match="stride"):
        shift_matvec.shift_matvec_scenarios(dlp.shift, cw, dr[:, :, 0].contiguous(), x)


LATTICE_WRAPPERS = (
    (condense, "condense_scenarios"), (grid_core, "grid_core_scenarios"),
    (grid_core, "grid_residual_scenarios"), (dct_lattice, "dct_factor_scenarios"),
    (dct_lattice, "dct_factor"), (dct_lattice, "dct_apply_scenarios"),
    (expand, "expand_scenarios"),
)


def _count_calls(monkeypatch, wrappers):
    calls = {}
    for mod, name in wrappers:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("S", [1, 4, 9])
def test_lattice_sweep_launches_independent_of_S(monkeypatch, S):
    """A grid-route sweep calls each scenario wrapper once whatever S (K17's
    stencil once a refinement pass); a p_bc batch calls ``dct_factor`` once
    and ``dct_factor_scenarios`` never.  On the card each call is the
    launches of one solve's (``dct_lattice.cuda_launches``: 20 for K16)."""
    asm = _assembler(P, "8x6", 1, "edge")
    mesh = asm.network
    calls = _count_calls(monkeypatch, LATTICE_WRAPPERS)
    P.solve_sweep(asm, R=np.linspace(0.5, 2.0, S)[:, None], **CPU)
    n_ref = dct_lattice.N_REFINE
    assert calls == {"condense_scenarios": 1, "grid_core_scenarios": 1,
                     "dct_factor_scenarios": 1, "dct_apply_scenarios": 1,
                     "grid_residual_scenarios": n_ref, "expand_scenarios": 1}
    calls.clear()
    pb = mesh.vertices[: mesh.num_graph_nodes][:, 0]
    P.solve_sweep(asm, p_bc_node_values=pb[None] * np.linspace(1, 2, S)[:, None], **CPU)
    assert calls == {"condense_scenarios": 1, "grid_core_scenarios": 1, "dct_factor": 1,
                     "dct_apply_scenarios": 1, "grid_residual_scenarios": n_ref,
                     "expand_scenarios": 1}
    assert dct_lattice.cuda_launches(_executor(asm).operator) == 20
    assert dct_lattice.apply_launches() == 18


@pytest.mark.parametrize("S", [1, 4])
def test_general_dct_sweep_launches_independent_of_S(monkeypatch, S):
    """A general-route sweep calls K16's and K18's scenario wrappers once a
    sweep (K18 once a refinement pass), whatever S."""
    from networks_fenicsx_tpu_torch.kernels import backsub, edge_data, peel

    asm = _assembler(P, "8x6", 1, "callable")
    calls = _count_calls(monkeypatch, (
        (edge_data, "edge_data_scenarios"), (peel, "bifurcation_system_scenarios"),
        (segsum, "segsum_plan_scenarios"), (segsum, "segsum_plan"),
        (dct_lattice, "dct_factor_scenarios"), (dct_lattice, "dct_factor"),
        (dct_lattice, "dct_apply_scenarios"), (shift_matvec, "shift_matvec_scenarios"),
        (backsub, "backsub_scenarios")))
    P.solve_sweep(asm, R=np.linspace(0.5, 2.0, S)[:, None], **CPU)
    n_ref = dct_lattice.N_REFINE
    # segsum_plan_scenarios: the system's sums and the class weights
    assert calls == {"edge_data_scenarios": 1, "bifurcation_system_scenarios": 1,
                     "segsum_plan_scenarios": 1, "dct_factor_scenarios": 1,
                     "dct_apply_scenarios": 1, "shift_matvec_scenarios": n_ref,
                     "backsub_scenarios": 1}
    calls.clear()
    pb = asm.network.vertices[: asm.network.num_graph_nodes][:, 1]
    P.solve_sweep(asm, p_bc_node_values=pb[None] * np.linspace(1, 2, S)[:, None], **CPU)
    assert calls == {"edge_data_scenarios": 1, "bifurcation_system_scenarios": 1,
                     "segsum_plan": 1, "dct_factor": 1, "dct_apply_scenarios": 1,
                     "shift_matvec_scenarios": n_ref, "backsub_scenarios": 1}


def test_sweep_rows_path_still_equal():
    """The same executor a row a call (``batch._run_rows``, the route before
    its scenario axis) gives the scenario sweep's bits."""
    asm = _assembler(P, "two_stubs", 2, "cell")
    batches = _batches(asm.network, "R+p_bc", 4, seed=9)
    res = _sweep(asm, None, batches)
    key = next(iter(asm._sweep_cache))
    entry = asm._sweep_cache[key]
    asm._sweep_cache[key] = (PB._run_rows, *entry[1:])
    rows = _sweep(asm, None, batches)
    assert all(torch.equal(a, b) for a, b in zip(res.blocks, rows.blocks))


# ------------------------------------------------------- factor reuse


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("f_kind", ["edge", "cell"])
def test_grid_solve_batch_matches_jax(monkeypatch, f_kind, k):
    """``GridFactorization.solve_batch`` against the JAX package's
    (``solver.py:3321``) at 1e-10·scale; each row ``solve()``'s bits; K1,
    K17's assembly, K16's passes and K5 called once for all rows, K17's
    stencil once a refinement pass and once for the residual."""
    import networks_fenicsx_tpu as J
    from networks_fenicsx_tpu import solver as JS

    aj, ap = (_assembler(pkg, "two_stubs", k, f_kind, seed=k) for pkg in (J, P))
    fj, fp = JS.build_grid_factorization(aj), PF.build_grid_factorization(ap, **CPU)
    R = ap.schur_arguments()[0]
    stj, stp = fj.factor(R), fp.factor(R)
    S = 4
    rng = np.random.default_rng(k)
    n = ap.network.num_edges if f_kind == "edge" else ap.network.num_cells
    fb = rng.uniform(-1.0, 1.0, (S, n))
    _, _, spbc, epbc = ap.schur_arguments(device=False)
    sp_b = np.asarray(spbc)[None] * rng.uniform(0.5, 2.0, (S, 1))
    ep_b = np.asarray(epbc)[None] * rng.uniform(0.5, 2.0, (S, 1))
    calls = _count_calls(monkeypatch, LATTICE_WRAPPERS)
    outs = fp.solve_batch(stp, fb, sp_b, ep_b)
    assert calls == {"condense_scenarios": 1, "grid_core_scenarios": 1, "dct_apply_scenarios": 1,
                     "grid_residual_scenarios": dct_lattice.N_REFINE + 1, "expand_scenarios": 1}
    assert len(outs) == 6 and all(o.shape[0] == S for o in outs)
    outs_j = fj.solve_batch(stj, fb, sp_b, ep_b)
    for i in range(S):
        single = fp.solve(stp, fb[i], sp_b[i], ep_b[i])
        assert all(torch.equal(a[i], b) for a, b in zip(outs, single)), i
        _close(fp.solution_vector([o[i] for o in outs]),
               fj.solution_vector([o[i] for o in outs_j]), TOL_JAX)


# ------------------------------------------------------------------- card


def _rows_equal(batched, ones):
    return all(torch.equal(a, b) for a, b in zip(batched, ones))


@pytest.mark.cuda
def test_lattice_scenario_kernels_on_card():
    """On a CUDA device: K16's, K17's and K18's scenario kernels against the
    one-scenario kernels row by row (``torch.equal``) and against their plain
    versions (1e-12·scale; K16's refined passes 1e-10·scale), on a 150 × 140
    lattice (K16's products split their k range) with batched and shared
    conductances; a sweep on two streams at once bit for bit with the sweep
    alone; K17's scenario stencil captured in a CUDA graph and replayed; and
    a sweep of 70,000 scenarios past the grid's y limit, its rows the
    executor's calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    mesh = P.NetworkMesh(P.network_generation.make_grid(150, 140, arrays=True), N=1,
                         color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh)
    rng = np.random.default_rng(0)
    asm.compute_forms(p_bc_ex=lambda x: x[0] + 0.2 * x[1], R=1.3,
                      f=rng.uniform(-1.0, 1.0, mesh.num_edges))
    ex = PS.build_schur_executor(asm, P.SolverOptions(**DCT), device=dev)
    assert type(ex) is PS._GridExecutor
    gdp, op, N, h = ex.device_plan, ex.operator, ex._N, ex._h_e
    assert max(op.plans) > 1, op.plans
    S = 5
    R0, f0, sp0, ep0 = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    Rb = torch.as_tensor(rng.uniform(0.5, 2.5, (S, 1)), device=dev)
    scales = torch.as_tensor(rng.uniform(0.5, 1.5, S), device=dev)
    fb = (f0[None] * scales.view((S,) + (1,) * f0.dim())).contiguous()
    W, w, g, Ftot, const = condense.condense_scenarios(gdp, N, 1, h, Rb, fb, "scalar", ex._f_mode,
                                                       sp0, ep0)

    def close(got, want, tol=1e-12):
        err = float((got - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max())), err

    for shared in (False, True):
        ws = w[0] if shared else w
        rhs, diag, nrm = grid_core.grid_core_scenarios(gdp, ws, const, Ftot)
        plain = grid_core.grid_core_scenarios_plain(gdp, ws, const, Ftot)
        for a, b in zip((rhs, diag, nrm), plain):
            close(a, b)
        lam_any = torch.randn((S, op.B), dtype=torch.float64, device=dev)
        res, rn = grid_core.grid_residual_scenarios(gdp, ws, diag, lam_any, rhs, norm=True)
        for a, b in zip((res, rn), grid_core.grid_residual_scenarios_plain(
                gdp, ws, diag, lam_any, rhs, norm=True)):
            close(a, b)
        state = (dct_lattice.dct_factor(op, w[0]) if shared
                 else dct_lattice.dct_factor_scenarios(op, w))
        if not shared:
            for a, b in zip(state, dct_lattice.dct_factor_scenarios_plain(op, w)):
                close(a, b)

        def resid(x, ws=ws, diag=diag, rhs=rhs):
            return grid_core.grid_residual_scenarios(gdp, ws, diag, x, rhs)

        lam = dct_lattice.dct_apply_scenarios(op, state, rhs, resid)
        unref = dct_lattice.dct_apply_scenarios(op, state, rhs, resid, n_refine=0)
        close(unref, dct_lattice.dct_apply_scenarios_plain(op, state, rhs, resid, n_refine=0))
        close(lam, dct_lattice.dct_apply_scenarios_plain(op, state, rhs, resid), 1e-10)
        for i in range(S):
            wi, di = (ws, diag) if shared else (w[i], diag[i])
            one = grid_core.grid_core(gdp, wi, const[i], Ftot[i])
            assert torch.equal(rhs[i], one[0]) and torch.equal(di, one[1])
            assert torch.equal(nrm[i], one[2])
            assert _rows_equal((res[i], rn[i]), grid_core.grid_residual(
                gdp, wi, di, lam_any[i], rhs[i], norm=True))
            st = state if shared else _state_row(state, i)
            if not shared:
                assert _rows_equal(st, dct_lattice.dct_factor(op, w[i]))
            one_lam = dct_lattice.dct_apply(
                op, st, rhs[i], lambda x: grid_core.grid_residual(gdp, wi, di, x, rhs[i]))
            assert torch.equal(lam[i], one_lam), (shared, i)
            solve = dct_lattice.dct_lattice(
                op, wi, rhs[i], lambda x: grid_core.grid_residual(gdp, wi, di, x, rhs[i]))
            assert torch.equal(lam[i], solve), (shared, i)

    # K18 over S on the general route's inputs (a callable source)
    asm_c = P.HydraulicNetworkAssembler(mesh)
    asm_c.compute_forms(p_bc_ex=lambda x: x[1], R=1.3, f=lambda x: x[0] + 0.3 * x[1])
    exc = PS.build_schur_executor(asm_c, P.SolverOptions(**DCT), device=dev)
    assert type(exc) is PS._DctExecutor
    dlp = exc.device_plan
    C, B = dlp.offsets.size, dlp.num_bifurcations
    w_e = torch.as_tensor(rng.uniform(0.5, 2.0, (S, dlp.num_edges)), device=dev)
    dr = torch.as_tensor(rng.uniform(1.0, 3.0, (S, B, 2)), device=dev)
    x = torch.randn((S, B), dtype=torch.float64, device=dev)
    cws = segsum.segsum_plan_scenarios(dlp.class_sums, w_e)[0].view(S, C, -1)
    cw1 = segsum.segsum_plan(dlp.class_sums, w_e[0])[0].view(C, -1)
    for cw in (cws, cw1):
        got = shift_matvec.shift_matvec_scenarios(dlp.shift, cw, dr[:, :, 0], x, dr[:, :, 1],
                                                  norm=True)
        want = shift_matvec.shift_matvec_scenarios_plain(dlp.shift, cw, dr[:, :, 0], x,
                                                         dr[:, :, 1], norm=True)
        for a, b in zip(got, want):
            close(a, b)
        for i in range(S):
            one = shift_matvec.shift_matvec(dlp.shift, cw if cw.dim() == 2 else cw[i],
                                            dr[i, :, 0], x[i], dr[i, :, 1], norm=True)
            assert _rows_equal((got[0][i], got[1][i]), one), i

    # a sweep on two streams at once: the bits of the sweep alone
    batches = ({"R": rng.uniform(0.5, 2.5, (S, 1))},
               {"p_bc_node_values": mesh.vertices[: mesh.num_graph_nodes][:, 0][None]
                * np.linspace(0.5, 2.0, S)[:, None]})
    alone = [P.solve_sweep(asm, device=dev, **b).blocks for b in batches]
    torch.cuda.synchronize()
    streams = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    for order in (streams, streams[::-1]):
        got = []
        for st, b in zip(order, batches):
            with torch.cuda.stream(st):
                got.append(P.solve_sweep(asm, device=dev, **b).blocks)
        torch.cuda.synchronize()
        for blocks, ref in zip(got, alone):
            assert _rows_equal(blocks, ref), "two streams"

    # K17's scenario stencil in a CUDA graph
    want = grid_core.grid_residual_scenarios(gdp, w, diag, lam, rhs, norm=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = grid_core.grid_residual_scenarios(gdp, w, diag, lam, rhs, norm=True)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert _rows_equal(captured, want), "graph replay"
    del graph

    # past the grid's y limit: 70,000 scenarios of a 3 × 3 lattice
    small = P.HydraulicNetworkAssembler(P.NetworkMesh(
        P.network_generation.make_grid(3, 3, arrays=True), N=1))
    small.compute_forms(p_bc_ex=lambda x: x[0], R=1.0, f=0.2)
    S = 70_000
    Rb = np.linspace(0.5, 2.0, S)[:, None]
    res = P.solve_sweep(small, R=Rb, options=P.SolverOptions(**DCT), device=dev)
    ex = _executor(small)
    for i in (0, 65_534, 65_535, S - 1):
        q_T, p_T, lam, *_ = ex(*ex.prepare_args(Rb[i], *small.schur_arguments()[1:]))
        assert torch.equal(res.blocks[0][i], q_T) and torch.equal(res.blocks[2][i], lam), i
