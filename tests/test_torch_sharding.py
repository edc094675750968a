"""The port's sharded solves (``networks_fenicsx_tpu_torch.parallel``) against
the JAX package's ``ShardedNetworkSolver`` on the CPU.

Every case of ``tests/test_sharding.py`` but its sweeps and its n = 16 and
n = 18 scale cases (those run on the card, ``chip_smoke.py``): the port on
``devices=["cpu"] * D`` (the kernels' plain versions, D shards in one
process), the reference on ``jax.devices()[:D]`` (the 8 virtual CPU devices
of ``conftest.py``).  Both solutions must agree at 1e-10·scale (scale =
max(1, max |x|); the psum orders differ), and the port's sharded solve must
equal its serial solve at 1e-10·scale.  Also: the three sharded planners
equal the reference's field by field, the T-forest solve equals a dense
Cholesky solve at 1e-12·scale, the split level sweep equals the whole one
bit for bit, and what is left raises.
"""

import numpy as np
import pytest
import torch

import jax

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu.parallel import ShardedNetworkSolver as JSharded
from networks_fenicsx_tpu.parallel import blocked_sharded as JB
from networks_fenicsx_tpu.parallel import distributed_tree as JD
from networks_fenicsx_tpu.parallel import grid_sharded as JG
from networks_fenicsx_tpu.parallel import sharding as JSH
from networks_fenicsx_tpu.solver import _plan_tree_elimination as j_tree_plan
from networks_fenicsx_tpu_torch import kernels
from networks_fenicsx_tpu_torch.kernels import shard_top, tree_sweep
from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver as PSharded
from networks_fenicsx_tpu_torch.parallel import blocked_sharded as PB
from networks_fenicsx_tpu_torch.parallel import distributed_tree as PD
from networks_fenicsx_tpu_torch.parallel import grid_sharded as PG
from networks_fenicsx_tpu_torch.parallel import sharding as PSH
from networks_fenicsx_tpu_torch.levels import _plan_tree_elimination as p_tree_plan

from _torch_cases import assert_plans_equal, kary

torch.set_num_threads(1)

TOL = 1e-10


def p_bc_y(x):
    return x[1]


def _tree(n, H=1.0, W=2.0):
    return lambda pkg: pkg.network_generation.make_tree(n, H, W, arrays=True)


def _arterial(gens):
    return lambda pkg: pkg.network_generation.make_arterial_tree(
        gens, direction=np.array([0.1, 1.0, 0.0]), arrays=True)


def _grid(nx_, ny):
    return lambda pkg: pkg.network_generation.make_grid(nx_, ny, arrays=True)


def _net(pos, edges):
    pos = np.asarray(pos, float)
    edges = np.asarray(edges, np.int64)
    return lambda pkg: pkg.ArrayNetwork(pos=pos, edges=edges)


def _no_top_tree():
    """8 boundary-fed components: boundary -> root -> {leaf, leaf}."""
    pos, edges = [], []
    for k in range(8):
        x0 = 3.0 * k
        base = len(pos)
        pos += [[x0, 0.0], [x0, 1.0], [x0 - 1.0, 2.0], [x0 + 1.0, 2.0]]
        edges += [[base, base + 1], [base + 1, base + 2], [base + 1, base + 3]]
    return _net(pos, edges)


def _chain(n_nodes=40):
    pos = [[float(i), 0.0] for i in range(n_nodes)]
    return _net(pos, [[i, i + 1] for i in range(n_nodes - 1)])


def _diamond():
    """A cycle: 0 -> 1 -> {2, 3} -> 4 -> 5."""
    pos = [(0, 0, 0), (1, 0, 0), (2, 1, 0), (2, -1, 0), (3, 0, 0), (4, 0, 0)]
    return _net(pos, [[0, 1], [1, 2], [1, 3], [2, 4], [3, 4], [4, 5]])


def _two_trees():
    """The disjoint union of make_tree(4, 1, 2) and make_tree(3, 2, 1)."""
    def build(pkg):
        a = pkg.network_generation.make_tree(4, 1.0, 2.0, arrays=True)
        b = pkg.network_generation.make_tree(3, 2.0, 1.0, arrays=True)
        pos_a, pos_b = np.asarray(a.pos), np.asarray(b.pos)
        edges = np.concatenate([np.asarray(a.edges), np.asarray(b.edges) + pos_a.shape[0]])
        return pkg.ArrayNetwork(pos=np.concatenate([pos_a, pos_b]), edges=edges)

    return build


def _assembler(pkg, graph_fn, N, k=1, R=None, f=None, p_bc=p_bc_y, strategy="fast"):
    mesh = pkg.NetworkMesh(graph_fn(pkg), N=N, color_strategy=strategy)
    asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k)
    forms = {}
    if R is not None:
        forms["R"] = R(mesh) if callable(R) else R
    if f is not None:
        forms["f"] = f(mesh) if callable(f) else f
    asm.compute_forms(p_bc_ex=p_bc, **forms)
    return asm


def _x(sol):
    return np.concatenate([np.asarray(fn.values).ravel() for fn in sol])


def _close(got, want, tol=TOL):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _sharded_both(graph_fn, D, N=2, k=1, R=None, f=None, method="auto", p_bc=p_bc_y,
                  strategy="fast"):
    """The port's and the reference's sharded solves and the port's serial
    one: ``(x_port, x_jax, x_serial, port solver, jax solver)``."""
    ap = _assembler(P, graph_fn, N, k, R, f, p_bc, strategy)
    sp = PSharded(ap, devices=["cpu"] * D, schur_method=method)
    sp.assemble()
    x_port = _x(sp.solve())
    aj = _assembler(J, graph_fn, N, k, R, f, p_bc, strategy)
    sj = JSharded(aj, devices=jax.devices()[:D], schur_method=method)
    sj.assemble()
    x_jax = _x(sj.solve())
    ser = P.Solver(_assembler(P, graph_fn, N, k, R, f, p_bc, strategy), device="cpu")
    x_ser = _x(ser.solve())
    assert sp.info.method == sj.info.method, (sp.info, sj.info)
    _close(x_port, x_jax)
    _close(x_port, x_ser)
    return x_port, x_jax, x_ser, sp, sj


def _rand(lo, hi, seed, per="edge"):
    def make(mesh):
        n = mesh.num_edges if per == "edge" else mesh.num_cells
        return np.random.default_rng(seed).uniform(lo, hi, n)

    return make


# ---------------------------------------------------------------- the solves


@pytest.mark.parametrize("n_devices", [1, 2, 8])
@pytest.mark.parametrize("n", [3, 5])
def test_sharded_matches_serial(n, n_devices):
    _sharded_both(_tree(n), n_devices, N=3, strategy="largest_first")


def test_sharded_edge_count_not_divisible():
    """7 segments over 8 shards: padding, the general route."""
    *_, sp, _ = _sharded_both(_tree(3), 8, N=2)
    assert sp.info.method == "schur_sharded"


def test_sharded_cg_matches_dense():
    _sharded_both(_tree(5), 4, N=1, method="cg", strategy="smallest_last")


def test_sharded_dense_branch():
    """``schur_method="dense"``: K11 on the reduced diagonal and pairs."""
    *_, sp, _ = _sharded_both(_diamond(), 3, N=3, R=_rand(0.5, 2.0, 1), method="dense")
    assert sp._pipeline.schur_method == "dense"


def test_sharded_higher_degree_and_source():
    _sharded_both(_tree(4), 4, N=2, k=2, f=1.5, strategy="smallest_last")


def test_sharded_deeper_tree_with_radii():
    _sharded_both(_arterial(8), 8, N=2, R=lambda m: 1.0 / m.edge_radius**4)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_tree_dist_matches_serial(n_dev):
    *_, sp, _ = _sharded_both(_arterial(6), n_dev, N=3, R=lambda m: 1.0 / m.edge_radius**4,
                              method="tree_dist")
    assert sp.info.method == "schur_sharded_dist"


def test_tree_dist_forest_source_and_degree():
    _sharded_both(_two_trees(), 8, N=2, k=2, f=0.7, method="tree_dist")


def test_tree_dist_chain_fallback():
    """A path graph degenerates the subtree partition: the planner declines
    (as the reference's does) and ``auto`` solves it on the general route."""
    aj = _assembler(J, _chain(), 1, p_bc=lambda x: x[0])
    ap = _assembler(P, _chain(), 1, p_bc=lambda x: x[0])
    assert JD.plan_distributed_tree(aj, j_tree_plan(aj), D=4, max_T=8) is None
    assert PD.plan_distributed_tree(ap, p_tree_plan(ap), D=4, max_T=8) is None
    _sharded_both(_chain(), 8, N=1, p_bc=lambda x: x[0])


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_sharded_blocked_matches_serial(n_devices):
    *_, sp, _ = _sharded_both(_tree(6), n_devices, N=4, R=_rand(0.5, 2.0, 17),
                              f=lambda m: np.random.default_rng(18).uniform(-1, 1, m.num_edges))
    assert sp.info.method == "schur_sharded_blocked"


def test_sharded_blocked_arterial_poiseuille():
    *_, sp, _ = _sharded_both(_arterial(6), 8, N=3, R=lambda m: 1.0 / m.edge_radius**4)
    assert sp.info.method == "schur_sharded_blocked"


def test_sharded_blocked_forced_raises_when_infeasible():
    asm = _assembler(P, _tree(3), 2)  # level widths 1, 2, 4
    solver = PSharded(asm, devices=["cpu"] * 8, schur_method="blocked")
    solver.assemble()
    with pytest.raises(ValueError, match="blocked"):
        solver.solve()


def test_sharded_blocked_fallback_general():
    """A per-edge-R lattice is outside the blocked and grid envelopes."""
    *_, sp, _ = _sharded_both(_grid(4, 4), 8, N=2, R=_rand(0.5, 2.0, 2))
    assert sp.info.method in ("schur_sharded", "schur_sharded_dist")


def test_sharded_blocked_kary_three_devices():
    *_, sp, _ = _sharded_both(lambda pkg: kary(pkg, 3, 2), 3, N=2, R=_rand(0.5, 2.0, 23))
    assert sp.info.method == "schur_sharded_blocked"
    assert sp._blocked_exec.plan.D == 3


def test_sharded_blocked_indivisible_device_count_falls_back():
    *_, sp, _ = _sharded_both(_tree(5), 6, N=2)
    assert sp.info.method in ("schur_sharded", "schur_sharded_dist")


def test_sharded_blocked_no_top_tree():
    *_, sp, _ = _sharded_both(_no_top_tree(), 8, N=3, R=_rand(0.5, 2.0, 31))
    assert sp.info.method == "schur_sharded_blocked"
    assert sp._blocked_exec.plan.Tn == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_blocked_fuzz_uniform_forests(seed):
    rng = np.random.default_rng(100 + seed)
    K = int(rng.integers(2, 4))
    depth = int(rng.integers(1, 3))
    N = int(rng.integers(1, 5))
    G = lambda pkg: kary(pkg, K, depth)  # noqa: E731
    n_edges = P.NetworkMesh(G(P), N=N).num_edges
    R = rng.uniform(0.2, 5.0, n_edges)
    f = rng.uniform(-2.0, 2.0, n_edges)
    n_dev = int(rng.choice([1, 2, 4, 8]))
    _sharded_both(G, n_dev, N=N, R=R, f=f)


def test_sharded_blocked_recompute_forms_changes_modes():
    """Per-edge R -> scalar R between solves rebuilds the executor."""
    asm = _assembler(P, _tree(5), 2, R=lambda m: np.linspace(0.5, 2.0, m.num_edges))
    solver = PSharded(asm, devices=["cpu"] * 8)
    solver.assemble()
    solver.solve()
    assert solver.info.method == "schur_sharded_blocked"
    asm.compute_forms(p_bc_ex=p_bc_y, R=3.0)
    solver.assemble()
    got = _x(solver.solve())
    ref = P.Solver(_assembler(P, _tree(5), 2, R=3.0), device="cpu")
    _close(got, _x(ref.solve()))


def test_sharded_forced_blocked_raises_every_solve():
    asm = _assembler(P, _tree(3), 2)
    solver = PSharded(asm, devices=["cpu"] * 8, schur_method="blocked")
    solver.assemble()
    for _ in range(2):
        with pytest.raises(ValueError, match="blocked"):
            solver.solve()


@pytest.mark.parametrize("topology", ["tree", "grid"])
def test_sharded_coefficients_snapshot_at_assemble(topology):
    """solve() uses the coefficients captured at assemble()."""
    G = _tree(4) if topology == "tree" else _grid(3, 3)
    asm = _assembler(P, G, 2, R=lambda m: np.linspace(0.5, 2.0, m.num_edges))
    R1 = np.linspace(0.5, 2.0, asm.network.num_edges)
    solver = PSharded(asm, devices=["cpu"] * 8)
    solver.assemble()
    x1 = _x(solver.solve())
    asm.compute_forms(p_bc_ex=p_bc_y, R=3.0 * R1)  # not followed by assemble()
    np.testing.assert_allclose(_x(solver.solve()), x1, rtol=0, atol=1e-14)
    solver.assemble()
    x2 = _x(solver.solve())
    ref = P.Solver(_assembler(P, G, 2, R=3.0 * R1), device="cpu")
    _close(x2, _x(ref.solve()))


@pytest.mark.parametrize("flux_degree", [2, 3])
def test_sharded_blocked_high_degree(flux_degree):
    *_, sp, _ = _sharded_both(_tree(6), 8, N=4, k=flux_degree, R=_rand(0.5, 2.0, 17),
                              f=_rand(-1.0, 1.0, 18))
    assert sp.info.method == "schur_sharded_blocked"


@pytest.mark.parametrize("flux_degree", [2, 3])
def test_sharded_general_path_high_degree_cyclic(flux_degree):
    """A cycle at flux degree >= 2 takes the general route."""
    *_, sp, _ = _sharded_both(_diamond(), 8, N=3, k=flux_degree, R=_rand(0.5, 2.0, 1),
                              f=_rand(-1.0, 1.0, 2), p_bc=lambda x: x[0])
    assert sp.info.method == "schur_sharded"
    ed = sp._pipeline.shards[0]["edges"]
    assert ed.eids.size == 1 and sp._pipeline.E_loc == 1


@pytest.mark.parametrize("flux_degree", [1, 2])
def test_sharded_blocked_per_cell_coefficients(flux_degree):
    *_, sp, _ = _sharded_both(_tree(6), 8, N=4, k=flux_degree, R=_rand(0.5, 2.0, 21, "cell"),
                              f=_rand(-1.0, 1.0, 22, "cell"))
    assert sp.info.method == "schur_sharded_blocked"


def test_sharded_assemble_time_coefficient_kinds():
    """A kind change after assemble() waits for the next assemble()."""
    R_edge = lambda m: np.linspace(1.0, 2.5, m.num_edges)  # noqa: E731
    asm = _assembler(P, _tree(4), 2, R=R_edge, strategy="largest_first")
    sh = PSharded(asm, devices=["cpu"] * 2)
    sh.assemble()
    asm.compute_forms(p_bc_ex=p_bc_y, R=2.0)
    got = _x(sh.solve())
    ref = P.Solver(_assembler(P, _tree(4), 2, R=R_edge, strategy="largest_first"), device="cpu")
    _close(got, _x(ref.solve()), 1e-11)
    sh.assemble()
    got2 = _x(sh.solve())
    ref2 = P.Solver(_assembler(P, _tree(4), 2, R=2.0, strategy="largest_first"), device="cpu")
    _close(got2, _x(ref2.solve()), 1e-11)


@pytest.mark.parametrize("method", ["auto", "tree_dist"])
def test_sharded_no_bifurcation(method):
    """B = 0: only K8a and K8b run, λ is empty."""
    net = _net([[0.0, 0.0], [1.0, 0.5], [2.0, 0.0], [3.0, 1.0]], [[0, 1], [2, 3]])
    *_, sp, _ = _sharded_both(net, 4, N=3, R=_rand(0.5, 2.0, 4), method=method)
    assert sp.info.method == "schur_sharded"


# ---------------------------------------------------------------- the pieces


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
def test_planners_equal_reference(D):
    """plan_sharded_blocked, plan_distributed_tree and plan_sharded_grid
    give the reference's plans field for field (arrays and dtypes)."""
    for G, N in ((_arterial(6), 3), (lambda pkg: kary(pkg, 3, 2), 2), (_no_top_tree(), 2)):
        aj, ap = _assembler(J, G, N), _assembler(P, G, N)
        jb, pb = JB.plan_sharded_blocked(aj, D), PB.plan_sharded_blocked(ap, D)
        assert (jb is None) == (pb is None)
        if jb is not None:
            assert_plans_equal(pb, jb)
        jd = JD.plan_distributed_tree(aj, j_tree_plan(aj), D)
        pd = PD.plan_distributed_tree(ap, p_tree_plan(ap), D)
        assert (jd is None) == (pd is None)
        if jd is not None:
            assert_plans_equal(pd, jd)
            rows_j = {k: np.asarray(v) for k, v in JD.plan_rows(jd).items()}
            rows_p = PD.plan_rows(pd)
            assert rows_j.keys() == rows_p.keys()
            for key in rows_j:
                assert np.array_equal(rows_j[key], rows_p[key]), key
    for dims in ((7, 6), (9, 16), (7, 3)):
        aj = _assembler(J, _grid(*dims), 2, R=1.8, f=0.7)
        ap = _assembler(P, _grid(*dims), 2, R=1.8, f=0.7)
        assert_plans_equal(PG.plan_sharded_grid(ap, D), JG.plan_sharded_grid(aj, D))


def test_forest_planner_equals_reference_on_an_irregular_forest():
    G = lambda pkg: pkg.network_generation.make_random_network(  # noqa: E731
        400, keep=0.0, seed=7, arrays=True)
    aj, ap = _assembler(J, G, 2), _assembler(P, G, 2)
    for D in (2, 8):
        jd = JD.plan_distributed_tree(aj, j_tree_plan(aj), D)
        assert jd is not None
        assert_plans_equal(PD.plan_distributed_tree(ap, p_tree_plan(ap), D), jd)
    _sharded_both(G, 8, N=2, R=_rand(0.5, 2.0, 3), method="tree_dist")


@pytest.mark.parametrize("seed,D,rounds", [(1, 8, 2), (7, 2, 1)])
def test_tree_dist_through_t_rounds_matches_reference(seed, D, rounds):
    """An irregular forest whose T has runs of one-child nodes (62 nodes in
    36 levels at D = 8, 9 in 9 at D = 2): tree_dist through the
    chain-compressed T solve equals the reference's sharded solve and the
    serial one at 1e-10·scale."""
    G = lambda pkg: pkg.network_generation.make_random_network(  # noqa: E731
        400, keep=0.0, seed=seed, arrays=True)
    *_, sp, _ = _sharded_both(G, D, N=2, k=2, R=_rand(0.5, 2.0, 5), f=_rand(-1.0, 1.0, 6, "cell"),
                              method="tree_dist")
    tf = next(iter(sp._dist_exec.t_forest.values()))
    assert len(tf.rounds) == rounds and tf.n_lvl < tf.depth


def _random_forest(n, seed):
    rng = np.random.default_rng(seed)
    parent = np.full(n, -1, np.int64)
    for i in range(1, n):
        if rng.uniform() < 0.9:
            parent[i] = rng.integers(0, i)
    return parent


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 1), (60, 2), (300, 3)])
def test_t_solve_equals_dense_cholesky(n, seed):
    """The T-forest elimination solves the T Laplacian exactly: it equals a
    dense Cholesky solve at 1e-12·scale."""
    parent = _random_forest(n, seed)
    rng = np.random.default_rng(seed + 10)
    wT = torch.as_tensor(np.where(parent >= 0, rng.uniform(0.5, 2.0, n), 0.0))
    dT = torch.as_tensor(rng.uniform(0.1, 1.0, n)) + wT
    np.add.at(dT.numpy(), np.maximum(parent, 0), np.where(parent >= 0, wT.numpy(), 0.0))
    rT = torch.as_tensor(rng.uniform(-1.0, 1.0, n))
    L = torch.diag(dT)
    for c in np.flatnonzero(parent >= 0):
        L[c, parent[c]] -= wT[c]
        L[parent[c], c] -= wT[c]
    want = torch.cholesky_solve(rT[:, None], torch.linalg.cholesky(L))[:, 0]
    lam, norm = shard_top.t_solve(shard_top.t_forest(parent, "cpu"), dT, rT, wT,
                                  torch.tensor(0.25, dtype=torch.float64))
    scale = max(1.0, float(want.abs().max()))
    assert float((lam - want).abs().max()) <= 1e-12 * scale
    assert abs(float(norm) - float(torch.sqrt(0.25 + (rT * rT).sum()))) <= 1e-14


def test_split_level_sweep_equals_whole():
    """tree_sweep_forward + the root λ + tree_sweep_backward give
    tree_sweep's λ bit for bit."""
    from networks_fenicsx_tpu_torch.blocked import _plan_blocked, device_plan

    asm = _assembler(P, _arterial(7), 3, R=lambda m: 1.0 / m.edge_radius**4, f=0.3)
    plan = _plan_blocked(asm)
    rng = np.random.default_rng(0)
    E = plan.edge_order.size
    w, const, Ftot = (torch.as_tensor(rng.uniform(0.5, 2.0, E)) for _ in range(3))
    dp = device_plan(plan, "cpu")
    lam, rhs_norm, *_ = tree_sweep.tree_sweep(dp, w, const, Ftot)
    d, r, wn, rhs_sq = tree_sweep.tree_sweep_forward(dp, w, const, Ftot)
    n0 = plan.levels[0].m
    lam2 = torch.zeros_like(lam)
    lam2[:n0] = r[:n0] / d[:n0]
    tree_sweep.tree_sweep_backward(dp, d, r, wn, lam2)
    assert torch.equal(lam, lam2)
    assert float(rhs_norm) == float(torch.sqrt(rhs_sq))


def test_reduce_orders_and_placement():
    parts = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (3, 2 * 3 * 4 + 5)))
    got = shard_top.reduce(parts, 5, 2 * 3 * 4)
    want = (parts[0, -5:] + parts[1, -5:]) + parts[2, -5:]
    assert torch.equal(got, want)
    placed = shard_top.reduce_placed(parts, 0, 2, 2, 4, 5)  # h = 2, nx = 4, ny = 5
    full = torch.zeros((2, 7, 4), dtype=torch.float64)
    for d in range(3):
        full[:, 2 * d : 2 * d + 3] += parts[d, :24].reshape(2, 3, 4)
    assert torch.allclose(placed, full[:, :5], rtol=0, atol=1e-15)


def test_pad_edge_data_matches_reference():
    """Padding rows carry the reference's per-layout identities."""
    from networks_fenicsx_tpu.solver import _prepare_edge_data
    from networks_fenicsx_tpu_torch.kernels import edge_data
    from networks_fenicsx_tpu_torch.solver import _EdgePlan

    for k, R, f in ((1, 2.0, 0.5), (1, _rand(0.5, 2, 1, "cell"), None), (2, 1.5, 0.2)):
        aj = _assembler(J, _tree(3), 3, k=k, R=R, f=f)
        ap = _assembler(P, _tree(3), 3, k=k, R=R, f=f)
        ej = JSH._pad_edge_data(_prepare_edge_data(aj), 2, n_cells=3)
        Rm, fm, fz = ap.coefficient_modes()
        net = ap.network

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32))

        ep = edge_data.edge_data_plain(
            _EdgePlan(i32(ap._edge_start_bif), i32(ap._edge_end_bif)), net.N, k,
            torch.as_tensor(np.asarray(net.edge_length) / net.N),
            torch.as_tensor(ap._quad_weights), torch.as_tensor(ap._quad_phi),
            *(torch.as_tensor(np.asarray(a, np.float64)) for a in ap.schur_arguments()[:2]),
            Rm, fm, fz, *(torch.as_tensor(np.asarray(a, np.float64))
                          for a in ap.schur_arguments()[2:]),
        )
        ep = PSH._pad_edge_data(ep, 2, n_cells=3)
        for name in ("W", "g", "start_bif", "end_bif", "start_pbc", "end_pbc"):
            np.testing.assert_allclose(getattr(ep, name).numpy(), np.asarray(getattr(ej, name)),
                                       rtol=0, atol=1e-12)
        np.testing.assert_allclose(ep.cumF.numpy(), np.asarray(ej.cumF).T, rtol=0, atol=1e-12)
        if ej.rh is not None:
            np.testing.assert_allclose(ep.rh.numpy(), np.asarray(ej.rh).T, rtol=0, atol=1e-12)


def test_default_devices_need_cuda_and_sweeps_are_left():
    asm = _assembler(P, _tree(3), 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PSharded(asm)
        with pytest.raises(RuntimeError, match="CUDA"):
            P.parallel.shard_solve(asm)
    from networks_fenicsx_tpu_torch.parallel import sharded_sweep

    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        sharded_sweep(asm, np.ones((2, asm.network.num_edges)))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        PB.sharded_blocked_sweep(asm)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        PG.sharded_grid_sweep(asm)


def test_sharded_wrappers_never_fall_back_off_the_cpu():
    """On a non-CPU tensor each K22 wrapper launches its kernel or raises;
    none runs its plain version (meta tensors stand in for the card)."""
    from networks_fenicsx_tpu_torch.edge_data import _EdgeData
    from networks_fenicsx_tpu_torch.kernels import dist_tree, shard_blocked, shard_general
    from networks_fenicsx_tpu_torch.kernels import shard_grid

    meta = torch.ones(4, dtype=torch.float64, device="meta")
    imeta = torch.ones(4, dtype=torch.int32, device="meta")
    ed = _EdgeData(mt=None, cumF=meta[None], W=meta, g=meta, start_bif=imeta, end_bif=imeta,
                   start_pbc=meta, end_pbc=meta, interior=())
    with pytest.raises(ValueError, match="CUDA"):
        shard_top.reduce(meta.reshape(2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        shard_top.reduce_placed(meta.reshape(1, 4), 0, 1, 1, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        shard_top.all_finite(imeta)
    tf = shard_top.t_forest(np.array([-1, 0, 0, 1]), "meta")
    with pytest.raises(ValueError, match="CUDA"):
        shard_top.t_solve(tf, meta, meta, meta)
    tab = shard_blocked.shard_tables(np.zeros(4), np.zeros(4), np.zeros(4), np.zeros(1), 1, 1,
                                     "meta")
    with pytest.raises(ValueError, match="CUDA"):
        shard_blocked.partials(tab, meta, meta, meta, meta, meta, meta, meta[0])
    with pytest.raises(ValueError, match="CUDA"):
        shard_grid.fill(1, 1, 4, meta[:2])
    ap = _assembler(P, _arterial(5), 2)
    plan = PD.plan_distributed_tree(ap, p_tree_plan(ap), 2)
    with pytest.raises(ValueError, match="CUDA"):
        dist_tree.folds(dist_tree.dist_shard_tables(plan, 0, "meta"), [ed])
    lt = shard_general.shard_lambda_tables(np.zeros(4), np.ones(4), -np.ones(4), 2, 0, "meta",
                                           matvec=True)
    with pytest.raises(ValueError, match="CUDA"):
        shard_general.partials(lt, ed)
    with pytest.raises(ValueError, match="CUDA"):
        shard_general.offdiag(lt, meta, meta[:2], meta[:2])
    assert all(fn.launches == 0 for fn in kernels.SHARDED)


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_sharded_tree_on_the_card_equals_serial():
    """On CUDA shards of one card, the blocked, forest, lattice and web
    routes equal the port's serial solve at 1e-10·scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for G, N, R, method in ((_arterial(7), 3, lambda m: 1.0 / m.edge_radius**4, "auto"),
                            (_arterial(7), 3, lambda m: 1.0 / m.edge_radius**4, "tree_dist"),
                            (_grid(33, 17), 2, 1.5, "auto"),
                            (_diamond(), 3, 2.0, "cg")):
        ap = _assembler(P, G, N, R=R)
        sp = PSharded(ap, devices=["cuda:0"] * 4, schur_method=method)
        sp.assemble()
        ser = P.Solver(_assembler(P, G, N, R=R), device="cuda")
        _close(_x(sp.solve()), _x(ser.solve()))
