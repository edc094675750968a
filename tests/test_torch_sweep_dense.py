"""Scenario sweeps on the dense route and without multipliers.

``solve_sweep`` under ``auto`` sends every network with 0 < B ≤ 4,096 that
is not a scalar-R lattice to ``schur_method="dense"``; there the port runs
the S scenarios in the launches of one solve: K8a, the bifurcation system
(K9's prepare kernel, K6), K11 (S factors for an R batch, in chunks, or one
factor and S right-hand sides) and K8b over S (``_DenseExecutor.scenarios``).
A network without bifurcations runs K8a and K8b over S
(``_EdgeExecutor.scenarios``).

Held here: the port's dense sweep against the JAX package's ``solve_sweep``
at 1e-12·scale on a small tree and a small cyclic web, for R, per-cell f,
p_bc and R + p_bc batches at k = 1 and 2; every row equal to the row's
``Solver(schur_method="dense").solve()`` bit for bit; each scenario plain
version equal to its one-scenario plain version row by row (``torch.equal``)
with batched and shared inputs; one call of each scenario wrapper a sweep
whatever S (one factor for a shared R), one more factor call a chunk; a row
whose R trips the pivot gate NaN alone, in the JAX package's NaN pattern;
``dense_f64`` on rows; B = 0; the new wrappers' shape refusals.  The
``cuda``-marked test holds the scenario kernels on the card against the
one-scenario kernels bit for bit and against the plain versions.  The JAX
package is imported only inside the tests that compare with it.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import edge_data as PE
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch.kernels import backsub, dense_core, edge_data, peel, segsum

torch.set_num_threads(1)

CPU = {"device": "cpu"}
DENSE = {"schur_method": "dense"}


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = max(1.0, float(np.abs(want[ok]).max())) if ok.any() else 1.0
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol * scale)


def _graph(pkg, net):
    gen = pkg.network_generation
    if net == "tree":
        return gen.make_tree(4, 1.0, 2.0, arrays=True), 3
    if net == "web":
        return gen.make_random_network(24, keep=0.6, num_boundary=3, seed=5, arrays=True), 2
    import networkx as nx  # two separate edges: no bifurcation

    G = nx.DiGraph()
    for i, pos in enumerate([(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.5, 1.0)]):
        G.add_node(i, pos=np.array(pos))
    G.add_edges_from([(0, 1), (2, 3)])
    return G, 4


def _assemblers(net, k=1, seed=0, pkgs=None):
    """The same network and seeded coefficients (per-edge R, per-cell f) in
    each package."""
    import networks_fenicsx_tpu as J

    rng = np.random.default_rng(seed)
    out, R0, f0 = [], None, None
    for pkg in pkgs or (J, P):
        G, N = _graph(pkg, net)
        mesh = pkg.NetworkMesh(G, N=N)
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k)
        if R0 is None:
            R0 = rng.uniform(0.5, 2.0, mesh.num_edges)
            f0 = rng.uniform(-1.0, 1.0, mesh.num_cells)
        asm.compute_forms(p_bc_ex=lambda x: x[1] - 0.5 * x[0], R=R0, f=f0)
        out.append(asm)
    return out, R0, f0


def _port_assembler(net, k=1, seed=0):
    rng = np.random.default_rng(seed)
    G, N = _graph(P, net)
    mesh = P.NetworkMesh(G, N=N)
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k)
    R0 = rng.uniform(0.5, 2.0, mesh.num_edges)
    f0 = rng.uniform(-1.0, 1.0, mesh.num_cells)
    asm.compute_forms(p_bc_ex=lambda x: x[1] - 0.5 * x[0], R=R0, f=f0)
    return asm, R0, f0


def _batches(asm, R0, f0, batch, S, seed):
    """Scenario batches, and each row's ``compute_forms`` arguments: a p_bc
    row ``y·a_i + c_i`` is the boundary function ``x ↦ x[1]·a_i + c_i`` at the
    graph's nodes, the same products."""
    rng = np.random.default_rng(seed)
    out = {}
    rows = [{"R": R0, "f": f0, "p_bc_ex": lambda x: x[1] - 0.5 * x[0]} for _ in range(S)]
    if "R" in batch:
        out["R"] = R0[None] * rng.uniform(0.5, 2.0, (S, 1))
        for i in range(S):
            rows[i]["R"] = out["R"][i]
    if "f" in batch:
        out["f"] = rng.uniform(-1.0, 1.0, (S, f0.size))
        for i in range(S):
            rows[i]["f"] = out["f"][i]
    if "p_bc" in batch:
        mesh = asm.network
        y = mesh.vertices[: mesh.num_graph_nodes][:, 1]
        a, c = rng.uniform(-2.0, 2.0, S), rng.uniform(-1.0, 1.0, S)
        out["p_bc_node_values"] = y[None] * a[:, None] + c[:, None]
        for i in range(S):
            rows[i]["p_bc_ex"] = (lambda ai, ci: (lambda x: x[1] * ai + ci))(a[i], c[i])
    return out, rows


def _executor(asm):
    return list(asm._sweep_cache.values())[-1][1]


def _row_solve(asm, options, forms):
    asm.compute_forms(**forms)
    s = P.Solver(asm, options=options, **CPU)
    s.solve()
    return s.solution_vector()


NETS = ["tree", "web"]
BATCHES = ["R", "f", "p_bc", "R+p_bc"]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("net", NETS)
def test_dense_sweep_matches_jax(net, batch, k):
    """Under ``auto`` both packages route to the dense Schur solve; the
    port's batched sweep matches the JAX package's vmapped one at
    1e-12·max(1, |x|)."""
    import networks_fenicsx_tpu as J

    (aj, ap), R0, f0 = _assemblers(net, k=k, seed=3)
    batches, _ = _batches(ap, R0, f0, batch, 3, seed=4)
    xj = np.asarray(J.solve_sweep(aj, **batches).x)
    xp = P.solve_sweep(ap, **CPU, **batches).x
    ex = _executor(ap)
    assert isinstance(ex, PS._DenseExecutor) and ex.has_scenario_axis
    _close(xp, xj, 1e-12)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("net", NETS)
def test_dense_sweep_rows_equal_solve(net, batch, k):
    """Every row of a dense sweep is ``Solver(schur_method="dense").solve()``
    of that row bit for bit (``auto`` and ``"dense"`` sweeps alike)."""
    asm, R0, f0 = _port_assembler(net, k=k, seed=11)
    batches, rows = _batches(asm, R0, f0, batch, 3, seed=12)
    x_auto = P.solve_sweep(asm, **CPU, **batches).x
    opts = P.SolverOptions(**DENSE)
    x_dense = P.solve_sweep(asm, options=opts, **CPU, **batches).x
    assert np.array_equal(x_auto, x_dense)
    for i, forms in enumerate(rows):
        assert np.array_equal(x_dense[i], _row_solve(asm, opts, forms)), (net, batch, k, i)


# ------------------------------------------------------- plain versions, row by row

PLAIN_MODES = [("edge", "scalar"), ("cell", "cell"), ("quad", "edge")]


def _scenario_case(net, R_mode, f_mode, k, S, seed, shared=(), device="cpu"):
    """A dense executor on ``net`` with coefficients of the given kinds, and
    random scenario inputs: every input batched (``(S, ...)``) but those
    named in ``shared``."""
    G, N = _graph(P, net)
    mesh = P.NetworkMesh(G, N=N)
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k)
    kinds = {"edge": np.ones(mesh.num_edges), "cell": np.ones(mesh.num_cells),
             "scalar": 1.0, "quad": lambda x: 1.0 + 0.5 * x[0] ** 2}
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=kinds[R_mode], f=kinds[f_mode])
    ex = PS.build_schur_executor(asm, P.SolverOptions(**DENSE), device=device, elide_zero_f=False)
    base = [np.shape(a) for a in asm.schur_arguments()]
    rng = np.random.default_rng(seed)

    def t(name, shape, lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, shape if name in shared else (S,) + shape))

    sb = torch.as_tensor(np.asarray(asm._edge_start_bif) < 0)
    eb = torch.as_tensor(np.asarray(asm._edge_end_bif) < 0)
    ins = (t("R", base[0], 0.5, 2.0), t("f", base[1], -1.0, 1.0),
           t("sp", base[2], -1.0, 1.0) * sb, t("ep", base[3], -1.0, 1.0) * eb)
    return ex, ins


def _row(t, base_dim, i):
    return t[i] if t.dim() > base_dim else t


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("shared", [(), ("R",), ("f", "sp", "ep")])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("R_mode,f_mode", PLAIN_MODES)
@pytest.mark.parametrize("net", NETS)
def test_dense_scenario_plain_equals_rows(net, R_mode, f_mode, k, shared, S):
    """Each scenario plain version is its one-scenario plain version row by
    row (``torch.equal``), shared inputs read as one row: K8a, the system's
    prepare and K6 sums, the pair sums, K11's factor, gate and solve (on S
    factors and on one), K8b."""
    ex, (R, f, sp, ep) = _scenario_case(net, R_mode, f_mode, k, S, seed=k + 5 * S, shared=shared)
    dlp, N = ex.device_plan, ex._N
    rdim = 2 if R_mode == "quad" else 1
    mk = (dlp, N, k, ex._h_e, ex._quad_w, ex._quad_phi)
    modes = (ex._R_mode, ex._f_mode, ex._f_is_zero)
    ed = edge_data.edge_data_scenarios(*mk, R, f, modes[0], modes[1], modes[2], sp, ep)
    ed_plain = edge_data.edge_data_scenarios_plain(*mk, R, f, modes[0], modes[1], modes[2], sp, ep)
    dr, w = peel.bifurcation_system_scenarios(dlp, ed.W, ed.g, ed.cumF[:, -1], ed.start_pbc,
                                              ed.end_pbc)
    (w_pairs,) = segsum.segsum_plan_scenarios(ex._pair_sums, w)
    pairs = (ex._ci, ex._cj, ex._pid)
    diag, rhs = dr[:, :, 0].contiguous(), dr[:, :, 1].contiguous()
    Lc, s, C = dense_core.dense_factor_scenarios(*pairs, diag, w_pairs)
    ok = dense_core.dense_gate_scenarios(C)
    lam = dense_core.dense_solve_scenarios(Lc, s, C, ok, rhs)
    one = dense_core.dense_factor_plain(*pairs, diag[0], w_pairs[0])
    ok0 = dense_core.dense_gate_plain(one[2])
    lam_shared = dense_core.dense_solve_scenarios(one[0], one[1], one[2], ok0, rhs)
    q_T, p_T, finite = backsub.backsub_scenarios(ed, lam, N, k)
    B, E = rhs.shape[1], dlp.num_edges
    assert dr.shape == (S, B, 2) and w.shape == (S, E) and lam.shape == (S, B)
    assert q_T.shape == (S, k * N + 1, E) and p_T.shape == (S, N, E) and finite.shape == (S,)
    for i in range(S):
        row = edge_data.edge_data_plain(*mk, _row(R, rdim, i), _row(f, 1, i), *modes,
                                        _row(sp, 1, i), _row(ep, 1, i))
        got = PE.scenario_row(ed, i)
        for name in ("mt", "cumF", "W", "g", "rh", "ua", "uF", "start_pbc", "end_pbc"):
            a, b = getattr(got, name), getattr(row, name)
            assert (a is None and b is None) or torch.equal(a, b), name
        assert all(torch.equal(a, b) for a, b in zip(got.interior, row.interior))
        assert all(torch.equal(a, b) for a, b in zip(PE.scenario_row(ed_plain, i), got)
                   if isinstance(a, torch.Tensor))
        d1, w1, _ = peel.bifurcation_system_plain(dlp, row.W, row.g, row.cumF[-1], row.start_pbc,
                                                  row.end_pbc)
        assert torch.equal(dr[i], d1) and torch.equal(w[i], w1)
        assert torch.equal(w_pairs[i], segsum.segsum_plan_plain(ex._pair_sums, w1)[0])
        f1 = dense_core.dense_factor_plain(*pairs, diag[i], w_pairs[i])
        assert all(torch.equal(a[i], b) for a, b in zip((Lc, s, C), f1))
        assert bool(ok[i]) == bool(dense_core.dense_gate_plain(f1[2]))
        l1 = dense_core.dense_solve_plain(*f1, dense_core.dense_gate_plain(f1[2]), rhs[i])
        assert torch.equal(lam[i], l1)
        ls = dense_core.dense_solve_plain(one[0], one[1], one[2], ok0, rhs[i])
        assert torch.equal(lam_shared[i], ls)
        if "R" in shared:  # one R: the shared factor's solve is the row's own
            assert torch.equal(lam_shared[i], l1)
        b1 = backsub.backsub_plain(row, lam[i], N, k)
        assert torch.equal(q_T[i], b1[0]) and torch.equal(p_T[i], b1[1])
        assert bool(finite[i]) == bool(b1[2])


# ------------------------------------------------------- launches, chunks, the gate

SCENARIO_CALLS = {
    edge_data: ("edge_data_scenarios",),
    peel: ("bifurcation_system_scenarios",),
    segsum: ("segsum_plan_scenarios", "segsum_plan"),
    dense_core: ("dense_factor_scenarios", "dense_gate_scenarios", "dense_solve_scenarios",
                 "dense_factor", "dense_gate", "dense_core"),
    backsub: ("backsub_scenarios",),
}


def _count_calls(monkeypatch):
    calls = {}
    for mod, names in SCENARIO_CALLS.items():
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, name, counted)
    return calls


# K6 over S: the pair sums (the system's two sides are inside the system's
# plain version on the CPU; on the card a second call)
R_BATCH_CALLS = {"edge_data_scenarios": 1, "bifurcation_system_scenarios": 1,
                 "segsum_plan_scenarios": 1, "dense_factor_scenarios": 1,
                 "dense_gate_scenarios": 1, "dense_solve_scenarios": 1, "backsub_scenarios": 1}
SHARED_R_CALLS = {"edge_data_scenarios": 1, "bifurcation_system_scenarios": 1,
                  "segsum_plan": 1, "dense_factor": 1, "dense_gate": 1,
                  "dense_solve_scenarios": 1, "backsub_scenarios": 1}


@pytest.mark.parametrize("S", [1, 4, 9])
def test_dense_sweep_launches_independent_of_S(monkeypatch, S):
    """A dense sweep calls each scenario wrapper once whatever S; with one R
    (an f or p_bc batch)
    it factors and gates once, with ``dense_factor`` and ``dense_gate``.  K11's
    kernel launches a chunk are one factor's and one solve's at that n."""
    asm, R0, f0 = _port_assembler("web", seed=2)
    calls = _count_calls(monkeypatch)
    rng = np.random.default_rng(S)
    P.solve_sweep(asm, R=R0[None] * rng.uniform(0.5, 2.0, (S, 1)), **CPU)
    assert calls == R_BATCH_CALLS
    calls.clear()
    P.solve_sweep(asm, f=rng.uniform(-1.0, 1.0, (S, f0.size)), **CPU)
    assert calls == SHARED_R_CALLS
    calls.clear()
    y = asm.network.vertices[: asm.network.num_graph_nodes][:, 1]
    P.solve_sweep(asm, p_bc_node_values=y[None] * rng.uniform(1.0, 2.0, (S, 1)), **CPU)
    assert calls == SHARED_R_CALLS
    B = asm.network.num_multipliers
    assert dense_core.cuda_launches(B, 1) == (
        2 + dense_core.tiled_factor_launches(B, B) + 1 + dense_core.solve_launches(B))


def test_dense_sweep_chunks(monkeypatch):
    """An R batch past the chunk's budget runs a factor call a chunk and gives
    the one-chunk sweep's bits; the chunk is what the budget holds."""
    asm, R0, _ = _port_assembler("tree", seed=6)
    Rb = R0[None] * np.random.default_rng(7).uniform(0.5, 2.0, (5, 1))
    whole = P.solve_sweep(asm, R=Rb, **CPU).x
    ex = _executor(asm)
    B = asm.network.num_multipliers
    assert dense_core.scenario_chunk(B, True, ex.scenario_budget) >= 5
    ex.scenario_budget = 2 * 16 * B * B  # two scenarios' Lc and C
    assert dense_core.scenario_chunk(B, True, ex.scenario_budget) == 2
    assert dense_core.scenario_chunk(B, False, ex.scenario_budget) == 2 * B
    calls = _count_calls(monkeypatch)
    chunked = P.solve_sweep(asm, R=Rb, **CPU).x
    assert np.array_equal(chunked, whole)
    assert calls["dense_factor_scenarios"] == 3 and calls["dense_solve_scenarios"] == 3
    assert dense_core.scenario_chunk(4095, True) == 8  # the 2 GiB budget at 4,095 nodes
    assert dense_core.scenario_chunk(1, True, 1) == 1
    assert dense_core.scenario_chunk(31, False) == dense_core.MAX_SCENARIOS


@pytest.mark.parametrize("net", NETS)
def test_dense_sweep_gate_row_nan(net):
    """A row whose R makes the Laplacian indefinite trips the pivot gate: that
    row is NaN where the JAX package's vmapped ``jnp.where(ok, …)`` leaves
    it NaN, and the other rows keep their bits."""
    import networks_fenicsx_tpu as J

    (aj, ap), R0, _ = _assemblers(net, seed=8)
    Rb = R0[None] * np.array([[1.0], [1.5], [0.75]])
    Rb[1, ::3] *= -4.0  # negative conductances: an indefinite system
    xj = np.asarray(J.solve_sweep(aj, R=Rb).x)
    xp = P.solve_sweep(ap, R=Rb, **CPU).x
    assert np.isnan(xp[1]).any() and not np.isnan(xp[[0, 2]]).any()
    _close(xp, xj, 1e-12)
    good = P.solve_sweep(ap, R=Rb[[0, 2]], **CPU).x
    assert np.array_equal(good, xp[[0, 2]])


def test_dense_f64_sweep_keeps_rows():
    """``schur_method="dense_f64"`` has no scenario axis: its sweep runs a row
    a call, each row ``Solver(schur_method="dense_f64").solve()`` bit for
    bit; its executor refuses ``scenarios``."""
    asm, R0, f0 = _port_assembler("web", seed=9)
    batches, rows = _batches(asm, R0, f0, "R+p_bc", 3, seed=10)
    opts = P.SolverOptions(schur_method="dense_f64")
    x = P.solve_sweep(asm, options=opts, **CPU, **batches).x
    ex = _executor(asm)
    assert isinstance(ex, PS._DenseExecutor) and not ex.has_scenario_axis
    with pytest.raises(ValueError, match="no scenario axis"):
        ex.scenarios(*ex.upload(*asm.schur_arguments()))
    for i, forms in enumerate(rows):
        assert np.array_equal(x[i], _row_solve(asm, opts, forms))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("batch", BATCHES)
def test_edge_sweep_without_multipliers(batch, k):
    """B = 0 (two separate edges) on ``_EdgeExecutor.scenarios``: rows equal
    ``Solver.solve()`` bit for bit, and the JAX package's sweep at
    1e-12·scale."""
    import networks_fenicsx_tpu as J

    (aj, ap), R0, f0 = _assemblers("edges", k=k, seed=13)
    batches, rows = _batches(ap, R0, f0, batch, 3, seed=14)
    xj = np.asarray(J.solve_sweep(aj, **batches).x)
    xp = P.solve_sweep(ap, **CPU, **batches).x
    ex = _executor(ap)
    assert isinstance(ex, PS._EdgeExecutor) and ex.has_scenario_axis
    _close(xp, xj, 1e-12)
    for i, forms in enumerate(rows):
        assert np.array_equal(xp[i], _row_solve(ap, None, forms))


def test_dense_scenario_shapes_raise():
    """The new wrappers refuse inconsistent scenario shapes (their plain
    versions check the same shapes)."""
    ex, (R, f, sp, ep) = _scenario_case("tree", "edge", "cell", 1, 3, seed=0)
    dlp, N = ex.device_plan, ex._N
    mk = (dlp, N, 1, ex._h_e, ex._quad_w, ex._quad_phi)
    modes = (ex._R_mode, ex._f_mode, ex._f_is_zero)
    with pytest.raises(ValueError, match="scenarios"):
        edge_data.edge_data_scenarios(*mk, R, f[:2], *modes, sp, ep)
    with pytest.raises(ValueError, match="no input carries a scenario axis"):
        edge_data.edge_data_scenarios(*mk, R[0], f[0], *modes, sp[0], ep[0])
    ed = edge_data.edge_data_scenarios(*mk, R, f, *modes, sp, ep)
    with pytest.raises(ValueError, match="W must be"):
        peel.bifurcation_system_scenarios(dlp, ed.W[0], ed.g, ed.cumF[:, -1], sp, ep)
    with pytest.raises(ValueError, match="scenarios"):
        peel.bifurcation_system_scenarios(dlp, ed.W, ed.g, ed.cumF[:, -1], sp[:2], ep)
    dr, w = peel.bifurcation_system_scenarios(dlp, ed.W, ed.g, ed.cumF[:, -1], sp, ep)
    with pytest.raises(ValueError, match="value tensors"):
        segsum.segsum_plan_scenarios(ex._pair_sums, w, w)
    with pytest.raises(ValueError, match="expected contiguous"):
        segsum.segsum_plan_scenarios(ex._pair_sums, w[0])
    (wp,) = segsum.segsum_plan_scenarios(ex._pair_sums, w)
    pairs = (ex._ci, ex._cj, ex._pid)
    diag, rhs = dr[:, :, 0].contiguous(), dr[:, :, 1].contiguous()
    with pytest.raises(ValueError, match="dc must be"):
        dense_core.dense_factor_scenarios(*pairs, diag[0], wp)
    with pytest.raises(ValueError, match="dc must be"):
        dense_core.dense_factor_scenarios(*pairs, diag, wp[:2])
    Lc, s, C = dense_core.dense_factor_scenarios(*pairs, diag, wp)
    with pytest.raises(ValueError, match="C must be"):
        dense_core.dense_gate_scenarios(C[0])
    ok = dense_core.dense_gate_scenarios(C)
    with pytest.raises(ValueError, match="leading S"):
        dense_core.dense_solve_scenarios(Lc[:2], s, C, ok, rhs)
    with pytest.raises(ValueError, match="rc must be"):
        dense_core.dense_solve_scenarios(Lc, s, C, ok, rhs[0])
    lam = dense_core.dense_solve_scenarios(Lc, s, C, ok, rhs)
    with pytest.raises(ValueError, match="lam must be"):
        backsub.backsub_scenarios(ed, lam[0], N, 1)
    with pytest.raises(ValueError, match="W, g"):
        backsub.backsub_scenarios(ed, lam[:2], N, 1)


# ---------------------------------------------------------------- card


def _card_case(dev, net, R_mode, f_mode, k, shared, close):
    """One kernel set on the card (see the test below)."""
    ex, ins = _scenario_case(net, R_mode, f_mode, k, 4, seed=k, shared=shared, device=dev)
    R, f, sp, ep = (t.to(dev) for t in ins)
    dlp, N = ex.device_plan, ex._N
    rdim = 2 if R_mode == "quad" else 1
    mk = (dlp, N, k, ex._h_e, ex._quad_w, ex._quad_phi)
    modes = (ex._R_mode, ex._f_mode, ex._f_is_zero)
    ed = edge_data.edge_data_scenarios(*mk, R, f, *modes, sp, ep)
    ed_p = edge_data.edge_data_scenarios_plain(*mk, R, f, *modes, sp, ep)
    Ftot = ed.cumF[:, -1]
    dr, w = peel.bifurcation_system_scenarios(dlp, ed.W, ed.g, Ftot, ed.start_pbc, ed.end_pbc)
    dr_p, w_p = peel.bifurcation_system_scenarios_plain(dlp, ed.W, ed.g, Ftot, ed.start_pbc,
                                                        ed.end_pbc)
    (wp,) = segsum.segsum_plan_scenarios(ex._pair_sums, w)
    pairs = (ex._ci, ex._cj, ex._pid)
    diag, rhs = dr[:, :, 0].contiguous(), dr[:, :, 1].contiguous()
    Lc, s, C = dense_core.dense_factor_scenarios(*pairs, diag, wp)
    ok = dense_core.dense_gate_scenarios(C)
    lam = dense_core.dense_solve_scenarios(Lc, s, C, ok, rhs)
    lam0 = dense_core.dense_solve_scenarios(Lc, s, C, ok, rhs, n_refine=0)
    one = dense_core.dense_factor(*pairs, diag[0], wp[0])
    ok1 = dense_core.dense_gate(one[2])
    lam_sh = dense_core.dense_solve_scenarios(*one, ok1, rhs)
    q_T, p_T, fin = backsub.backsub_scenarios(ed, lam, N, k)
    # against the plain versions
    for name in ("mt", "cumF", "W", "g", "rh", "ua", "uF"):
        a, b = getattr(ed, name), getattr(ed_p, name)
        assert (a is None) == (b is None) and (a is None or close(a, b, 1e-12) is None), name
    close(dr, dr_p, 1e-12)
    assert torch.equal(w, w_p)
    assert torch.equal(wp, segsum.segsum_plan_scenarios_plain(ex._pair_sums, w)[0])
    Lc_p, s_p, C_p = dense_core.dense_factor_scenarios_plain(*pairs, diag, wp)
    assert torch.equal(Lc, Lc_p) and torch.equal(s, s_p)
    close(torch.tril(C), C_p, 1e-12)
    assert torch.equal(ok.bool().cpu(), dense_core.dense_gate_scenarios_plain(C).cpu())
    close(lam0, dense_core.dense_solve_scenarios_plain(Lc, s, C, ok, rhs, n_refine=0), 1e-12)
    close(lam, dense_core.dense_solve_scenarios_plain(Lc, s, C, ok, rhs), 1e-10)
    qp, pp, fp = backsub.backsub_scenarios_plain(ed, lam, N, k)
    close(q_T, qp, 1e-12)
    close(p_T, pp, 1e-12)
    assert torch.equal(fin.cpu(), fp.cpu())
    # against the one-scenario kernels, row by row
    for i in range(4):
        row = edge_data.edge_data(*mk, _row(R, rdim, i), _row(f, 1, i), *modes, _row(sp, 1, i),
                                  _row(ep, 1, i))
        got = PE.scenario_row(ed, i)
        for name in ("mt", "cumF", "W", "g", "rh", "ua", "uF"):
            a, b = getattr(got, name), getattr(row, name)
            assert (a is None and b is None) or torch.equal(a, b), name
        assert all(torch.equal(a, b) for a, b in zip(got.interior, row.interior))
        d1, w1, _ = peel.bifurcation_system(dlp, row.W, row.g, row.cumF[-1], row.start_pbc,
                                            row.end_pbc)
        assert torch.equal(dr[i], d1) and torch.equal(w[i], w1)
        assert torch.equal(wp[i], segsum.segsum_plan(ex._pair_sums, w1)[0])
        f1 = dense_core.dense_factor(*pairs, diag[i], wp[i])
        assert all(torch.equal(a[i], b) for a, b in zip((Lc, s, C), f1))
        g1 = dense_core.dense_gate(f1[2])
        assert int(ok[i]) == int(g1)
        assert torch.equal(lam[i], dense_core.dense_solve(*f1, g1, rhs[i]))
        assert torch.equal(lam[i], dense_core.dense_core(*pairs, diag[i], rhs[i], wp[i]))
        assert torch.equal(lam_sh[i], dense_core.dense_solve(*one, ok1, rhs[i]))
        b1 = backsub.backsub(row, lam[i], N, k)
        assert torch.equal(q_T[i], b1[0]) and torch.equal(p_T[i], b1[1])
        assert bool(fin[i]) == bool(b1[2])


@pytest.mark.cuda
def test_dense_scenario_kernels_on_card():
    """On a CUDA device: each scenario kernel against its one-scenario
    kernel row by row, ``torch.equal`` (K8a, the system, the pair sums, K11's
    factor, gate and solve on S factors and on one, K8b), and against its
    plain version (``torch.equal`` for K6, the prepare kernel and K11's
    assembly; 1e-12·scale for K8a, K8b, the factor and one unrefined K11
    solve; 1e-10·scale refined); a sweep row that trips the gate NaN alone;
    S past the grid's y limit on one factor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)

    def close(a, b, tol):
        a, b = a.cpu(), b.cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        m = ~torch.isnan(b)
        scale = max(1.0, float(b[m].abs().max())) if m.any() else 1.0
        assert float((a[m] - b[m]).abs().max()) <= tol * scale if m.any() else True

    for net in NETS:
        for k in (1, 2):
            for R_mode, f_mode in PLAIN_MODES:
                for shared in ((), ("R",), ("f", "sp", "ep")):
                    _card_case(dev, net, R_mode, f_mode, k, shared, close)
    # a row that trips the gate: NaN alone, the others their rows' bits
    asm, R0, f0 = _port_assembler("web", seed=8)
    Rb = R0[None] * np.array([[1.0], [1.5], [0.75]])
    Rb[1, ::3] *= -4.0
    res = P.solve_sweep(asm, R=Rb, device=dev)
    x = res.x
    assert np.isnan(x[1]).any() and not np.isnan(x[[0, 2]]).any()
    assert np.array_equal(P.solve_sweep(asm, R=Rb[[0, 2]], device=dev).x, x[[0, 2]])
    # S past the grid's y limit on one shared factor
    asm, R0, f0 = _port_assembler("tree", seed=1)
    S = 70_000
    fb = np.random.default_rng(2).uniform(-1.0, 1.0, (S, f0.size))
    res = P.solve_sweep(asm, f=fb, device=dev)
    ex = _executor(asm)
    base = asm.schur_arguments()
    for i in (0, 65_534, 65_535, S - 1):
        q_T, p_T, lam, *_ = ex(*ex.prepare_args(base[0], fb[i], base[2], base[3]))
        assert torch.equal(res.blocks[0][i], q_T) and torch.equal(res.blocks[2][i], lam)
