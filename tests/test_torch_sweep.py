"""Scenario sweeps: ``solve_sweep``, ``SweepResult`` and the blocked route's
scenario axis (K1, K2–K4, K5 over S scenarios in the launches of one solve).

The mirrors of ``tests/test_transforms.py`` run the port at the reference's
sizes and tolerances: R and p_bc linearity and ``functions()`` against a
direct solve (``:73``), the coefficient-kind raise (``:150``), a per-cell f
batch and a p_bc batch on the blocked forest (``:169``, ``:205``), the
scenario axis on two devices (``:233``) and the cache keyed on every option
field (``:271``; the float32 sweep raises naming ROADMAP A4 and leaves no
entry).  The port's sweeps are held against the JAX package's
``solve_sweep`` on the same seeded inputs: a small tree under ``auto``
(the batched dense route), the same tree under ``schur_method="tree"`` (the batched
blocked route) with R, per-cell f and p_bc batches, and a small lattice
(DCT rows).  Every row of a sweep is the port's own ``Solver.solve()`` of
that row bit for bit; each batched plain version is its unbatched plain
version row by row, ``torch.equal``; a sweep calls each scenario wrapper
once whatever S.  The ``cuda``-marked test holds the scenario kernels on the
card against the one-scenario kernels bit for bit and against the plain
versions.  The JAX package is imported only inside the tests that compare
with it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import blocked as PB
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch.kernels import condense, expand, tree_sweep

torch.set_num_threads(1)

CPU = {"device": "cpu"}


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _setup(pkg, n=3, N=3):
    """tests/test_transforms.py:21: make_tree(n), per-edge R = 1, p_bc = y."""
    mesh = pkg.NetworkMesh(pkg.network_generation.make_tree(n, 1.0, 2.0), N=N)
    asm = pkg.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.ones(mesh.num_edges))
    return mesh, asm


def _executor(asm):
    """The executor of the last sweep's cache entry (index 1, as the
    reference's tests read it)."""
    return list(asm._sweep_cache.values())[-1][1]


def _row_solve(asm, options=None, **forms):
    s = P.Solver(asm, options=options, **CPU)
    asm.compute_forms(**forms)
    s.solve()
    return s.solution_vector()


# ------------------------------------------------------- mirrors of test_transforms.py


def test_solve_sweep_api():
    """tests/test_transforms.py:73: R and boundary-pressure batches."""
    mesh, asm = _setup(P)
    R_q = asm.schur_arguments()[0]
    S = 5
    scales = np.linspace(1.0, 3.0, S)
    R_batch = np.asarray(R_q)[None, :] * scales[:, None]
    res = P.solve_sweep(asm, R=R_batch, **CPU)
    assert res.x.shape == (S, asm.num_dofs) and res.num_scenarios == S
    q0 = res.x[:, 0]
    np.testing.assert_allclose(q0 * scales, q0[0] * scales[0], rtol=1e-10)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R_batch[2][: mesh.num_edges])
    direct = P.Solver(asm, options=P.SolverOptions(method="schur"), **CPU).solve()
    fns = res.functions(2)
    assert [fn.name for fn in fns] == [fn.name for fn in direct]
    for a, b in zip(fns, direct):
        np.testing.assert_allclose(a.values, b.values, atol=1e-11)
    offs = asm.block_offsets
    M = mesh.num_edge_colors
    assert np.array_equal(res.pressures(), res.x[:, offs[M] : offs[M + 1]])
    assert np.array_equal(res.multipliers(), res.x[:, offs[M + 1] :])

    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.ones(mesh.num_edges))
    pb = np.asarray(mesh.vertices[: mesh.num_graph_nodes][:, 1])
    res2 = P.solve_sweep(asm, p_bc_node_values=pb[None, :] * np.array([1.0, 2.0, -1.0])[:, None],
                         **CPU)
    x0, x1, x2 = (res2.x[i] for i in range(3))
    np.testing.assert_allclose(x1, 2 * x0, atol=1e-11)
    np.testing.assert_allclose(x2, -x0, atol=1e-11)


def test_solve_sweep_kind_mismatch_raises():
    """tests/test_transforms.py:150, and the reference's other checks."""
    mesh = P.NetworkMesh(P.network_generation.make_tree(3, 1.0, 2.0), N=2)
    asm = P.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], f=0.2)  # scalar-kind f
    with pytest.raises(ValueError, match="coefficient kind"):
        P.solve_sweep(asm, f=np.ones((3, mesh.num_edges)), **CPU)
    with pytest.raises(ValueError, match="at least one batched coefficient"):
        P.solve_sweep(asm, **CPU)
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        P.solve_sweep(asm, f=np.ones((3, 1)), R=np.ones((2, 1)), **CPU)
    import networkx as nx

    G = nx.DiGraph()  # a triangle: a component without a boundary node
    for i, pos in enumerate([(0, 0), (1, 0), (0.5, 1)]):
        G.add_node(i, pos=np.array(pos, dtype=float))
    G.add_edges_from([(0, 1), (1, 2), (2, 0)])
    asm_f = P.HydraulicNetworkAssembler(P.NetworkMesh(G, N=1))
    asm_f.compute_forms(p_bc_ex=lambda x: x[1])
    with pytest.raises(RuntimeError, match="no boundary node"):
        P.solve_sweep(asm_f, f=np.ones((2, 1)), **CPU)


def test_solve_sweep_per_cell_blocked_forest():
    """tests/test_transforms.py:169: per-cell f batches permute into the
    blocked executor's (S, N, E) j-major layout (B = 8,191 > 4,096 keeps the
    blocked route); rows against host LU at 1e-9·scale."""
    rng = np.random.default_rng(9)
    mesh = P.NetworkMesh(P.network_generation.make_tree(14, 1.0, 2.0, arrays=True), N=2,
                         color_strategy="fast")
    C = mesh.num_edges * mesh.N
    asm = P.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], f=rng.uniform(0.5, 1.5, C))
    fb = rng.uniform(-1.0, 1.0, (2, C))
    res = P.solve_sweep(asm, f=fb, **CPU)
    executor = _executor(asm)
    assert isinstance(executor.blocked_plan, PB._BlockedPlan) and executor.has_scenario_axis
    for i in range(2):
        asm2 = P.HydraulicNetworkAssembler(mesh)
        asm2.compute_forms(p_bc_ex=lambda x: x[0], f=fb[i])
        s = P.Solver(asm2, options=P.SolverOptions(method="host_lu"), **CPU)
        s.solve()
        ref = s.solution_vector()
        np.testing.assert_allclose(res.x[i], ref, atol=1e-9 * np.abs(ref).max())


def test_solve_sweep_p_bc_blocked_forest():
    """tests/test_transforms.py:205: p_bc batches in the blocked executor's
    internal edge order, linear at 1e-11·scale."""
    mesh = P.NetworkMesh(P.network_generation.make_tree(14, 1.0, 2.0, arrays=True), N=1,
                         color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    pb = np.asarray(mesh.vertices[: mesh.num_graph_nodes][:, 1])
    res = P.solve_sweep(asm, p_bc_node_values=pb[None, :] * np.array([1.0, 2.0, -0.5])[:, None],
                        **CPU)
    assert isinstance(_executor(asm).blocked_plan, PB._BlockedPlan)
    x0, x1, x2 = (res.x[i] for i in range(3))
    scale = max(1.0, np.abs(x0).max())
    np.testing.assert_allclose(x1, 2.0 * x0, atol=1e-11 * scale)
    np.testing.assert_allclose(x2, -0.5 * x0, atol=1e-11 * scale)


def test_solve_sweep_scenario_sharding():
    """tests/test_transforms.py:233: ``devices=`` chunks the scenario axis
    and matches the one-device sweep (1e-12; here bit for bit), and a batch
    the device count does not divide raises."""
    rng = np.random.default_rng(1)
    devices = ["cpu"] * 2
    S = 4
    mesh = P.NetworkMesh(P.network_generation.make_grid(8, 6, arrays=True), N=2)
    rep = rng.uniform(0.5, 1.5, mesh.num_edges)
    fb = rng.uniform(-1.0, 1.0, (S, mesh.num_edges))
    asm = P.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], f=rep, R=1.0)
    res_dp = P.solve_sweep(asm, f=fb, devices=devices)
    asm2 = P.HydraulicNetworkAssembler(mesh)
    asm2.compute_forms(p_bc_ex=lambda x: x[0], f=rep, R=1.0)
    res = P.solve_sweep(asm2, f=fb, **CPU)
    np.testing.assert_allclose(res_dp.x, res.x, atol=1e-12)
    assert np.array_equal(res_dp.x, res.x)
    with pytest.raises(ValueError, match="divisible"):
        P.solve_sweep(asm, f=fb[: S - 1], devices=devices)


def test_solve_sweep_blocked_devices():
    """``devices=`` on the batched blocked route: each chunk through its
    device's executor, equal to the one-device sweep bit for bit."""
    rng = np.random.default_rng(2)
    mesh = P.NetworkMesh(P.network_generation.make_tree(5, 1.0, 2.0, arrays=True), N=3)
    asm = P.HydraulicNetworkAssembler(mesh)
    R0 = rng.uniform(0.5, 2.0, mesh.num_edges)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0)
    Rb = R0[None] * rng.uniform(0.5, 2.0, (6, 1))
    opts = P.SolverOptions(schur_method="tree")
    one = P.solve_sweep(asm, R=Rb, options=opts, **CPU).x
    two = P.solve_sweep(asm, R=Rb, options=opts, devices=["cpu"] * 3).x
    assert np.array_equal(one, two)
    (entry,) = asm._sweep_cache.values()
    assert set(entry[2]) == {"cpu"}  # one executor a device


def test_solve_sweep_cache_keys_on_all_options():
    """tests/test_transforms.py:271: the f32 sweep raises naming ROADMAP A4
    (float32 is A4b) and leaves no cache entry; the f64 sweep that follows
    builds its own executor and matches a direct f64 solve at 1e-11·scale."""
    mesh, asm = _setup(P)
    R_q = asm.schur_arguments()[0]
    E = mesh.num_edges
    R_batch = np.asarray(R_q)[None, :E] * np.array([1.0, 2.0])[:, None]
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        P.solve_sweep(asm, R=R_batch, options=P.SolverOptions(dtype="float32"), **CPU)
    assert not getattr(asm, "_sweep_cache", {})
    res64 = P.solve_sweep(asm, R=R_batch, **CPU)
    ref = _row_solve(asm, p_bc_ex=lambda x: x[1], R=R_batch[1])
    err64 = np.max(np.abs(res64.x[1] - ref))
    assert err64 < 1e-11 * max(1.0, np.abs(ref).max()), err64


ALTERNATES = {"method": "schur", "schur_method": "tree", "rtol": 1e-10, "atol": 1e-14,
              "maxiter": 50, "cheb_degree": 4, "cg_precond": "jacobi", "mg_overcorrect": 1.5,
              "error_if_not_converged": False, "monitor": True, "dtype": "float32",
              "output_dtype": "float32", "level_scan": "on"}


def test_sweep_cache_keys_on_every_field():
    """A sweep with any one option field changed gets an entry of its own
    (the key holds ``dataclasses.astuple`` of the options and the
    coefficient kinds); the float32 fields raise and add none."""
    fields = [f.name for f in dataclasses.fields(P.SolverOptions)]
    assert set(fields) == set(ALTERNATES)
    mesh, asm = _setup(P, n=3, N=2)
    Rb = np.ones((2, mesh.num_edges)) * np.array([[1.0], [2.0]])
    P.solve_sweep(asm, R=Rb, **CPU)
    keys = set(asm._sweep_cache)
    for name in fields:
        opts = dataclasses.replace(P.SolverOptions(), **{name: ALTERNATES[name]})
        if name in ("dtype", "output_dtype"):
            with pytest.raises(NotImplementedError, match="ROADMAP A4"):
                P.solve_sweep(asm, R=Rb, options=opts, **CPU)
            assert set(asm._sweep_cache) == keys
            continue
        P.solve_sweep(asm, R=Rb, options=opts, **CPU)
        new = set(asm._sweep_cache) - keys
        assert len(new) == 1, name
        (key,) = new
        assert key[0] == (0, None, None, None) and key[2] == asm.coefficient_modes()
        keys |= new
    # and the kinds: a per-cell R is a new entry
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.ones(mesh.num_cells))
    P.solve_sweep(asm, R=np.ones((2, mesh.num_cells)), **CPU)
    assert len(set(asm._sweep_cache) - keys) == 1


def test_exports():
    """``batch``, ``solve_sweep`` and ``SweepResult`` are exported: the first
    two as the reference exports them, ``SweepResult`` from ``batch`` there."""
    import networks_fenicsx_tpu as J

    for name in ("batch", "solve_sweep", "SweepResult"):
        assert name in P.__all__ and hasattr(P, name)
        assert name in J.__all__ or name in J.batch.__all__
    assert P.batch.__all__ == J.batch.__all__
    assert P.solve_sweep is P.batch.solve_sweep and P.SweepResult is P.batch.SweepResult


# ------------------------------------------------------- the port against the JAX package


def _pair_tree(n, N, k=1, seed=0, f_cell=False):
    import networks_fenicsx_tpu as J

    rng = np.random.default_rng(seed)
    out = []
    R0 = f0 = None
    for pkg in (J, P):
        mesh = pkg.NetworkMesh(pkg.network_generation.make_tree(n, 1.0, 2.0, arrays=True), N=N,
                               color_strategy="fast")
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k)
        if R0 is None:
            R0 = rng.uniform(0.5, 2.0, mesh.num_edges)
            f0 = rng.uniform(-1.0, 1.0, mesh.num_cells if f_cell else mesh.num_edges)
        asm.compute_forms(p_bc_ex=lambda x: x[1], R=R0, f=f0)
        out.append(asm)
    return out, R0, f0


def _both_sweeps(aj, ap, options_j=None, options_p=None, **batches):
    import networks_fenicsx_tpu as J

    xj = np.asarray(J.solve_sweep(aj, options=options_j, **batches).x)
    xp = P.solve_sweep(ap, options=options_p, **CPU, **batches).x
    return xj, xp


def test_sweep_matches_jax_dense_rows():
    """make_tree(4) under auto: both packages route to the dense Schur solve."""
    (aj, ap), R0, _ = _pair_tree(4, 3, seed=3)
    Rb = R0[None] * np.random.default_rng(4).uniform(0.5, 2.0, (4, 1))
    xj, xp = _both_sweeps(aj, ap, R=Rb)
    assert type(_executor(ap)).__name__ == "_DenseExecutor"
    _close(xp, xj, 1e-12)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("batch", ["R", "f_cell", "p_bc", "R+p_bc"])
def test_sweep_matches_jax_blocked(batch, k):
    """make_tree(4) under schur_method="tree": the batched blocked route,
    R, per-cell f and p_bc batches, at 1e-12·max(1, |x|)."""
    import networks_fenicsx_tpu as J

    (aj, ap), R0, f0 = _pair_tree(4, 3, k=k, seed=5, f_cell=True)
    rng = np.random.default_rng(6)
    S = 3
    batches = {}
    if "R" in batch:
        batches["R"] = R0[None] * rng.uniform(0.5, 2.0, (S, 1))
    if batch == "f_cell":
        batches["f"] = rng.uniform(-1.0, 1.0, (S, f0.size))
    if "p_bc" in batch:
        pb = ap.network.vertices[: ap.network.num_graph_nodes][:, 1]
        batches["p_bc_node_values"] = pb[None] * rng.uniform(-2.0, 2.0, (S, 1))
    xj, xp = _both_sweeps(aj, ap, J.SolverOptions(schur_method="tree"),
                          P.SolverOptions(schur_method="tree"), **batches)
    assert _executor(ap).has_scenario_axis
    _close(xp, xj, 1e-12)


def test_sweep_matches_jax_lattice_rows():
    """A small lattice under auto: both packages route to the DCT solve
    (the port's grid executor, a row at a time), at 1e-10·scale."""
    import networks_fenicsx_tpu as J

    rng = np.random.default_rng(8)
    asms = []
    for pkg in (J, P):
        mesh = pkg.NetworkMesh(pkg.network_generation.make_grid(6, 5, arrays=True), N=2)
        asm = pkg.HydraulicNetworkAssembler(mesh)
        asm.compute_forms(p_bc_ex=lambda x: x[0], f=0.3, R=1.7)
        asms.append(asm)
    fb = rng.uniform(-1.0, 1.0, (3, 1))
    xj, xp = _both_sweeps(*asms, f=fb)
    assert isinstance(_executor(asms[1]), PS._GridExecutor)
    _close(xp, xj, 1e-10)


# ------------------------------------------------------- rows, plain versions, launches


@pytest.mark.parametrize("route", ["blocked", "dense", "lattice", "level", "tree"])
@pytest.mark.parametrize("batch", ["R", "f", "p_bc"])
def test_sweep_rows_equal_solve(route, batch):
    """Every row of a sweep is the port's own ``Solver.solve()`` of that row
    (on the same route) bit for bit; ``"level"`` an irregular forest and
    ``"tree"`` a cyclic web (its dense core) under ``schur_method="tree"``."""
    rng = np.random.default_rng(10)
    if route == "lattice":
        mesh = P.NetworkMesh(P.network_generation.make_grid(5, 4, arrays=True), N=2)
        R0, f0 = (np.array([1.3]), 1.3), rng.uniform(-1.0, 1.0, mesh.num_edges)
        opts = P.SolverOptions(schur_method="dct")
        p_bc = lambda s: (lambda x: s * x[0])
    elif route in ("level", "tree"):
        keep = 0.0 if route == "level" else 0.3
        G = P.network_generation.make_random_network(60, keep=keep, seed=2, arrays=True)
        mesh = P.NetworkMesh(G, N=3)
        R_e = rng.uniform(0.5, 2.0, mesh.num_edges)
        R0, f0 = (R_e, R_e), rng.uniform(-1.0, 1.0, mesh.num_cells)
        opts = P.SolverOptions(schur_method="tree")
        p_bc = lambda s: (lambda x: s * x[1])
    else:
        mesh = P.NetworkMesh(P.network_generation.make_tree(5, 1.0, 2.0, arrays=True), N=3)
        R_e = rng.uniform(0.5, 2.0, mesh.num_edges)
        R0, f0 = (R_e, R_e), rng.uniform(-1.0, 1.0, mesh.num_cells)
        opts = P.SolverOptions(schur_method="tree" if route == "blocked" else "dense")
        p_bc = lambda s: (lambda x: s * x[1])
    asm = P.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=p_bc(1.0), R=R0[1], f=f0)
    scales = np.array([0.5, 1.25, 2.0])
    if batch == "R":
        rows = [dict(R=R0[1] * s, f=f0, p_bc_ex=p_bc(1.0)) for s in scales]
        res = P.solve_sweep(asm, R=R0[0][None] * scales[:, None], options=opts, **CPU)
    elif batch == "f":
        fb = f0[None] * scales[:, None]
        rows = [dict(R=R0[1], f=fb[i], p_bc_ex=p_bc(1.0)) for i in range(3)]
        res = P.solve_sweep(asm, f=fb, options=opts, **CPU)
    else:
        coord = 0 if route == "lattice" else 1
        pb = mesh.vertices[: mesh.num_graph_nodes][:, coord]
        rows = [dict(R=R0[1], f=f0, p_bc_ex=p_bc(s)) for s in scales]
        res = P.solve_sweep(asm, p_bc_node_values=scales[:, None] * pb[None], options=opts, **CPU)
    assert _executor(asm).has_scenario_axis  # every route here alike
    want = {"level": PS._LevelExecutor, "tree": PS._TreeExecutor}.get(route)
    assert want is None or isinstance(_executor(asm), want)
    for i, forms in enumerate(rows):
        assert np.array_equal(res.x[i], _row_solve(asm, opts, **forms)), (route, batch, i)


MODES = [(R, f) for R in ("scalar", "edge", "cell") for f in ("scalar", "edge", "cell")]


def _scenario_case(R_mode, f_mode, k, S, seed, shared=()):
    """A blocked tree's device plan and random scenario inputs: every input
    batched (``(S, ...)``) but those named in ``shared``."""
    mesh = P.NetworkMesh(P.network_generation.make_tree(5, 1.0, 2.0, arrays=True), N=3)
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k)
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    ex = PS.build_schur_executor(asm, P.SolverOptions(), device="cpu")
    dp, N = ex.device_plan, mesh.N
    E = dp.num_edges
    rng = np.random.default_rng(seed)
    shapes = {"scalar": (1,), "edge": (E,), "cell": (N, E)}
    plan = dp.plan

    def t(name, shape, lo, hi):
        full = shape if name in shared else (S,) + shape
        return torch.as_tensor(rng.uniform(lo, hi, full))

    sp = t("sp", (E,), -1.0, 1.0) * torch.as_tensor(~plan.s_is_bif)
    ep = t("ep", (E,), -1.0, 1.0) * torch.as_tensor(~plan.t_is_bif)
    return (dp, N, ex._h_e, t("R", shapes[R_mode], 0.5, 2.0), t("f", shapes[f_mode], -1.0, 1.0),
            sp, ep)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("shared", [(), ("R",), ("f", "sp", "ep"), ("R", "sp")])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("R_mode,f_mode", MODES)
def test_scenario_plain_equals_rows(R_mode, f_mode, k, shared, S):
    """Each batched plain version is its unbatched plain version row by row
    (``torch.equal``), with shared inputs read as one row."""
    dp, N, h, R, f, sp, ep = _scenario_case(R_mode, f_mode, k, S, seed=k + 7 * S, shared=shared)
    plan = dp.plan
    E = dp.num_edges
    base = {"R": {"scalar": (1,), "edge": (E,), "cell": (N, E)}[R_mode],
            "f": {"scalar": (1,), "edge": (E,), "cell": (N, E)}[f_mode]}

    def row(t, b, i):
        return t[i] if t.dim() == len(b) + 1 else t

    out = condense.condense_scenarios(dp, N, k, h, R, f, R_mode, f_mode, sp, ep)
    assert out.shape == (5, S, E)
    W, w, g, Ftot, const = out
    lam_s, norm_s, d_s, r_s, wn_s = tree_sweep.tree_sweep_scenarios(dp, w, const, Ftot)
    d, wn, fac = tree_sweep.tree_sweep_factor_plain(plan, w[0])
    lam_a, norm_a, r_a = tree_sweep.tree_sweep_apply_scenarios(dp, d, wn, fac, const, Ftot)
    q_T, p_T, finite = expand.expand_scenarios(dp, N, k, lam_s, sp, ep, W, w, g, Ftot, h, R, f,
                                               R_mode, f_mode)
    assert q_T.shape == (S, k * N + 1, E) and p_T.shape == (S, N, E) and finite.shape == (S,)
    for i in range(S):
        Ri, fi = row(R, base["R"], i), row(f, base["f"], i)
        spi, epi = row(sp, (E,), i), row(ep, (E,), i)
        one = condense.condense_plain(plan, N, k, h, Ri, fi, R_mode, f_mode, spi, epi)
        assert all(torch.equal(a, b) for a, b in zip(out[:, i], one))
        full = tree_sweep.tree_sweep_plain(plan, w[i], const[i], Ftot[i])
        assert all(torch.equal(a, b) for a, b in zip((lam_s[i], norm_s[i], d_s[i], r_s[i],
                                                      wn_s[i]), full))
        if "R" in shared:  # one factor: the apply is the full sweep's λ
            assert torch.equal(lam_a[i], full[0]) and torch.equal(norm_a[i], full[1])
        app = tree_sweep.tree_sweep_apply_plain(plan, d, wn, fac, const[i], Ftot[i])
        assert all(torch.equal(a, b) for a, b in zip((lam_a[i], norm_a[i], r_a[i]), app))
        xq, xp, xf = expand.expand_plain(plan, N, k, lam_s[i], spi, epi, W[i], w[i], g[i], Ftot[i],
                                         h, Ri, fi, R_mode, f_mode)
        assert torch.equal(q_T[i], xq) and torch.equal(p_T[i], xp) and bool(finite[i]) == bool(xf)
    # the blocked-order plain versions are the same stack in the kernels' order
    blk = tree_sweep.tree_sweep_scenarios_plain(dp, w, const, Ftot, blocked=True)
    assert torch.equal(blk[0], lam_s)


def test_scenario_shapes_raise():
    dp, N, h, R, f, sp, ep = _scenario_case("edge", "edge", 1, 3, seed=0)
    with pytest.raises(ValueError, match="scenarios"):
        condense.condense_scenarios(dp, N, 1, h, R, f[:2], "edge", "edge", sp, ep)
    with pytest.raises(ValueError, match="no input carries a scenario axis"):
        condense.condense_scenarios(dp, N, 1, h, R[0], f[0], "edge", "edge", sp[0], ep[0])
    with pytest.raises(ValueError, match="expected"):
        condense.condense_scenarios(dp, N, 1, h, R[:, :-1], f, "edge", "edge", sp, ep)


@pytest.mark.parametrize("S", [1, 4, 9])
def test_sweep_launches_independent_of_S(monkeypatch, S):
    """A blocked sweep calls each scenario wrapper once, whatever S (and on
    a p_bc batch K2's factor once); each call's kernel launches are
    ``tree_sweep.cuda_launches`` of the plan alone (no S in it)."""
    # 4,095 bifurcations: more than the top holds, so the sweep has subtree blocks
    mesh = P.NetworkMesh(P.network_generation.make_tree(13, 1.0, 2.0, arrays=True), N=1,
                         color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.ones(mesh.num_edges))
    calls = {}
    names = ("condense_scenarios", "tree_sweep_scenarios", "tree_sweep_apply_scenarios",
             "tree_sweep_factor", "expand_scenarios")
    for mod in (condense, tree_sweep, expand):
        for name in names:
            if hasattr(mod, name):
                fn = getattr(mod, name)

                def counted(*a, _fn=fn, _name=name, **kw):
                    calls[_name] = calls.get(_name, 0) + 1
                    return _fn(*a, **kw)

                monkeypatch.setattr(mod, name, counted)
    opts = P.SolverOptions(schur_method="tree")
    P.solve_sweep(asm, R=np.ones((S, mesh.num_edges)) * np.linspace(1, 2, S)[:, None],
                  options=opts, **CPU)
    assert calls == {"condense_scenarios": 1, "tree_sweep_scenarios": 1, "expand_scenarios": 1}
    calls.clear()
    pb = mesh.vertices[: mesh.num_graph_nodes][:, 1]
    P.solve_sweep(asm, p_bc_node_values=pb[None] * np.linspace(1, 2, S)[:, None], options=opts,
                  **CPU)
    assert calls == {"condense_scenarios": 1, "tree_sweep_factor": 1,
                     "tree_sweep_apply_scenarios": 1, "expand_scenarios": 1}
    dp = _executor(asm).device_plan
    assert tree_sweep.cuda_launches(dp, tree_sweep.FULL) == 3
    assert tree_sweep.cuda_launches(dp, tree_sweep.APPLY) == 3
    assert tree_sweep.cuda_launches(dp, tree_sweep.FACTOR) == 2


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_scenario_kernels_on_card():
    """On a CUDA device: the scenario kernels against the one-scenario
    kernels row by row, ``torch.equal``, in every mode at k = 1 and 2 with
    batched and shared inputs mixed, and against the plain versions
    (``torch.equal`` where the one-scenario kernel is its plain version's
    bits: K1 without a per-cell sum, K2–K4 in the kernels' order; else
    1e-12·scale); and beyond 65,535 scenarios (the grid's y limit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for k in (1, 2):
        for R_mode, f_mode in MODES:
            for shared in ((), ("R",), ("f", "sp", "ep")):
                case = _scenario_case(R_mode, f_mode, k, 3, seed=k, shared=shared)
                dp_cpu, N, *ins = case
                ex_mesh = P.NetworkMesh(P.network_generation.make_tree(5, 1.0, 2.0, arrays=True),
                                        N=3)
                asm = P.HydraulicNetworkAssembler(ex_mesh, flux_degree=k)
                asm.compute_forms(p_bc_ex=lambda x: x[1])
                dp = PS.build_schur_executor(asm, P.SolverOptions(), device=dev).device_plan
                h, R, f, sp, ep = (t.to(dev) for t in ins)
                out = condense.condense_scenarios(dp, N, k, h, R, f, R_mode, f_mode, sp, ep)
                W, w, g, Ftot, const = out
                lam, norm, *_ = tree_sweep.tree_sweep_scenarios(dp, w, const, Ftot)
                q_T, p_T, fin = expand.expand_scenarios(dp, N, k, lam, sp, ep, W, w, g, Ftot, h,
                                                        R, f, R_mode, f_mode)
                cell = "cell" in (R_mode, f_mode)
                want = condense.condense_scenarios_plain(dp, N, k, h, R, f, R_mode, f_mode, sp,
                                                         ep)
                if cell:
                    assert float((out - want).abs().max()) <= 1e-12 * max(
                        1.0, float(want.abs().max()))
                else:
                    assert torch.equal(out, want)
                blk = tree_sweep.tree_sweep_scenarios_plain(dp, w, const, Ftot, blocked=True)
                assert torch.equal(lam, blk[0]) and torch.equal(norm, blk[1])
                for i in range(3):
                    row = lambda t, n: t[i] if t.dim() > n else t  # noqa: E731
                    one = condense.condense(dp, N, k, h, row(R, 1 if R_mode != "cell" else 2),
                                            row(f, 1 if f_mode != "cell" else 2), R_mode, f_mode,
                                            row(sp, 1), row(ep, 1))
                    assert all(torch.equal(a, b) for a, b in zip(out[:, i], one))
                    l1 = tree_sweep.tree_sweep(dp, w[i], const[i], Ftot[i])
                    assert torch.equal(lam[i], l1[0]) and torch.equal(norm[i], l1[1])
                    x1 = expand.expand(dp, N, k, lam[i], row(sp, 1), row(ep, 1), W[i], w[i],
                                       g[i], Ftot[i], h, row(R, 1 if R_mode != "cell" else 2),
                                       row(f, 1 if f_mode != "cell" else 2), R_mode, f_mode)
                    assert torch.equal(q_T[i], x1[0]) and torch.equal(p_T[i], x1[1])
    # beyond the grid's y limit: 70,000 scenarios of a small tree
    mesh = P.NetworkMesh(P.network_generation.make_tree(3, 1.0, 2.0, arrays=True), N=2)
    asm = P.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.ones(mesh.num_edges))
    S = 70_000
    Rb = np.ones((S, mesh.num_edges)) * np.linspace(0.5, 2.0, S)[:, None]
    res = P.solve_sweep(asm, R=Rb, options=P.SolverOptions(schur_method="tree"), device=dev)
    ex = _executor(asm)
    for i in (0, 65_534, 65_535, S - 1):
        q_T, p_T, lam, *_ = ex(*ex.prepare_args(Rb[i], *asm.schur_arguments()[1:]))
        assert torch.equal(res.blocks[0][i], q_T) and torch.equal(res.blocks[2][i], lam)
