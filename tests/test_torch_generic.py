"""The continuous-pressure and assembled-matrix routes of the PyTorch port
against the JAX reference.

Mirrors ``tests/test_solver.py``, ``tests/test_golden.py``,
``tests/test_krylov.py`` and ``tests/test_fuzz.py`` on ``device="cpu"``
(the kernels' plain versions):

* ``method="schur_p"`` (``auto`` for pressure degree ≥ 1) at 1e-9·scale
  (scale = max(1, max |x|)), iterations within 1; its pieces — ``J``, ``A⁻¹``
  (K21a), ``T = J A⁻¹ Jᵀ`` and its Jacobi diagonal — against the reference's
  construction at 1e-12·scale (``Tdiag`` 1e-14 relative);
* ``method="dense"`` (K21b), ``"host_lu"`` and ``"minres"`` (K19e on K20b):
  the Y-bifurcation's closed form, the goldens (1e-10; MINRES 1e-7, the
  reference's own bar), equality with the reference;
* ``schur_method="dense"``/``"dense_f64"`` and networks without
  bifurcations (λ empty) at 1e-10·scale;
* ``ops.krylov.minres`` on seeded symmetric indefinite systems, and the
  plain LU's pivots against ``scipy.linalg.lu_factor``.

The card tests (``pytest -m cuda``) hold K21a, K21b and K19e against their
plain versions.
"""

import json

import networkx as nx
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu.ops import krylov as JK
from networks_fenicsx_tpu_torch import kernels
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch.kernels import csr, dense_lu, krylov, schur_p
from networks_fenicsx_tpu_torch.ops import krylov as PK

from test_fuzz import _random_coefficients, random_network
from test_torch_solver import GOLDEN_DIR, GOLDEN_NAMES, _check_golden, _golden_problem

torch.set_num_threads(1)


def _close(got, want, tol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _tree(n=3, a=1, b=2):
    return lambda pkg: pkg.network_generation.make_tree(n, a, b, arrays=True)


def _grid(nx_, ny):
    return lambda pkg: pkg.network_generation.make_grid(nx_, ny, arrays=True)


def _solve_both(graph, N=3, k=1, kp=0, options=None, R=None, f=None, p_bc=lambda x: x[1],
                kind=None, assemble=True):
    """Solve with both packages: ``[(x, info, solver), ...]`` (reference
    first; ``kind`` is the port's)."""
    out = []
    for pkg in (J, P):
        G = graph(pkg) if callable(graph) else graph
        mesh = pkg.NetworkMesh(G, N=N)
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=kp)
        asm.compute_forms(p_bc_ex=p_bc, R=R(mesh) if callable(R) else R, f=f)
        kw = {"device": "cpu", "kind": kind} if pkg is P else {}
        s = pkg.Solver(asm, options=pkg.SolverOptions(**(options or {})), **kw)
        if assemble:
            s.assemble()
        s.solve()
        out.append((np.asarray(s.solution_vector()), s.info, s))
    return out


# ------------------------------------------------------- continuous pressure


SCHUR_P_CASES = {
    "tree-p2p1-edge-R": dict(graph=_tree(), k=2, kp=1,
                             R=lambda mesh: np.random.default_rng(3).uniform(0.5, 2.0, mesh.num_edges)),
    "tree-p3p2": dict(graph=_tree(), k=3, kp=2),
    "y-source": dict(graph=_tree(2, 1, 3), k=2, kp=1, f=0.75),
    "grid-p2p1": dict(graph=_grid(4, 3), k=2, kp=1, N=2),
}


@pytest.mark.parametrize("name", sorted(SCHUR_P_CASES))
def test_schur_p_matches_reference(name):
    (xj, ij, _), (xp, ip, sp_) = _solve_both(options={"rtol": 1e-13}, assemble=False,
                                             **SCHUR_P_CASES[name])
    assert ip.method == ij.method == "schur_p" and ip.converged
    assert isinstance(sp_._executor, PS._SchurPExecutor)
    assert abs(ip.iterations - ij.iterations) <= 1, (ip, ij)
    _close(xp, xj, 1e-9)


def _reference_pieces(aj):
    """``(J, JT, A⁻¹, Tdiag)`` as the reference's ``_continuous_pressure_solve``
    builds them, from its assembler (NumPy and SciPy)."""
    mesh = aj.network
    k, N, E = aj.flux_degree, mesh.N, mesh.num_edges
    m = k * N + 1
    n_flux = int(aj.block_offsets[mesh.num_edge_colors])
    n_red = aj.num_dofs - n_flux
    cell_mass = np.asarray(aj._cell_mass).reshape(E, N, k + 1, k + 1)
    li = k * np.arange(N)[:, None] + np.arange(k + 1)[None, :]
    blocks = np.zeros((E, m, m))
    for j in range(N):
        blocks[:, li[j][:, None], li[j][None, :]] += cell_mass[:, j]
    chol = np.linalg.cholesky(blocks)
    perm = np.lexsort((np.arange(E), np.asarray(mesh.edge_color)))
    inv_perm = np.argsort(perm)

    def A_inv(v):
        ve = v.reshape(E, m)[inv_perm]
        ue = np.stack([sla.cho_solve((c, True), b) for c, b in zip(chol, ve)])
        return ue[perm].reshape(-1)

    r, c = aj._all_rows, aj._all_cols
    vals = np.concatenate([np.asarray(aj._cell_mass).ravel(), aj._static_vals])
    sel = (r >= n_flux) & (c < n_flux)
    Jm = sp.csr_matrix((vals[sel], (r[sel] - n_flux, c[sel])), shape=(n_red, n_flux))
    Jm.sum_duplicates()
    A_diag = np.zeros(n_flux)
    np.add.at(A_diag, aj._cell_flux_dofs.ravel(),
              np.asarray(aj._cell_mass)[:, np.arange(k + 1), np.arange(k + 1)].ravel())
    Tdiag = np.asarray(Jm.multiply(Jm) @ (1.0 / A_diag)).ravel()
    return Jm, A_inv, A_diag, np.where(Tdiag > 0, Tdiag, 1.0)


@pytest.mark.parametrize("k,kp", [(2, 1), (3, 2)])
def test_schur_p_pieces_match_reference(k, kp):
    """J and Jᵀ (K20 folds), A⁻¹ (K21a), T = J A⁻¹ Jᵀ and Tdiag."""
    asms = []
    for pkg in (J, P):
        mesh = pkg.NetworkMesh(_tree()(pkg), N=3)
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=kp)
        asm.compute_forms(p_bc_ex=lambda x: x[1],
                          R=np.random.default_rng(k).uniform(0.5, 2.0, mesh.num_edges))
        asms.append(asm)
    aj, ap = asms
    Jm, A_inv, A_diag, Tdiag = _reference_pieces(aj)
    ex = PS._SchurPExecutor(ap, P.SolverOptions(), torch.device("cpu"))
    _close(ex.J.to_scipy().toarray(), Jm.toarray(), 1e-13)
    _close(ex.JT.to_scipy().toarray(), Jm.T.toarray(), 1e-13)
    Lb, adiag = schur_p.schur_p_factor(ap._cell_mass_on(torch.device("cpu")), ex.tiles)
    assert np.array_equal(adiag.numpy(), A_diag)
    rng = np.random.default_rng(7)
    v = rng.standard_normal(ex.n_flux)
    _close(schur_p.schur_p_solve(Lb, ex.tiles, torch.as_tensor(v)), A_inv(v), 1e-12)
    z = rng.standard_normal(Jm.shape[0])
    Jz = ex.JT @ torch.as_tensor(z)
    T = ex.J @ schur_p.schur_p_solve(Lb, ex.tiles, Jz)
    _close(T, Jm @ A_inv(Jm.T @ z), 1e-12)
    td = csr.csr_tdiag(*ex.J.device_arrays, adiag).numpy()
    np.testing.assert_allclose(td, Tdiag, rtol=1e-14, atol=0)


def _pair(graph, k, kp, N=2):
    """The reference's and the port's assemblers of ``graph`` (per-edge R)."""
    asms = []
    for pkg in (J, P):
        mesh = pkg.NetworkMesh(graph(pkg), N=N)
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=kp)
        asm.compute_forms(p_bc_ex=lambda x: x[1],
                          R=np.random.default_rng(k).uniform(0.5, 2.0, mesh.num_edges))
        asms.append(asm)
    return asms


# edge counts against K21a's 32-edge tiles: below one tile, one tile and one
# edge, and a ragged last tile of a longer run
TILE_GRAPHS = {
    "below-a-tile": _tree(),  # 7 edges
    "tile-plus-one": lambda pkg: random_network(np.random.default_rng(0), 32, 0),  # 33
    "ragged": lambda pkg: random_network(np.random.default_rng(1), 60, 0),  # 61
}


@pytest.mark.parametrize("k,kp", [(2, 1), (3, 2), (5, 4)])
@pytest.mark.parametrize("graph", sorted(TILE_GRAPHS))
def test_schur_p_tiles_match_reference(graph, k, kp):
    """K21a's tile plan is the reference's flux permutation ``lexsort((arange(E),
    edge_color))`` with the sorted bases at ``s·m``; the plain factor and solve
    in the tiled layout equal the reference's pieces (``A_diag`` bit for bit,
    ``A⁻¹`` at 1e-12·scale), ghost slots of a ragged tile holding the identity."""
    aj, ap = _pair(TILE_GRAPHS[graph], k, kp)
    mesh = aj.network
    E, N = mesh.num_edges, mesh.N
    m = k * N + 1
    tiles = schur_p.flux_tiles(ap._edge_flux_base, ap.network.edge_color, N, k, "cpu")
    perm = np.lexsort((np.arange(E), np.asarray(mesh.edge_color)))
    assert np.array_equal(tiles.perm.numpy(), perm)
    assert np.array_equal(np.asarray(ap._edge_flux_base)[perm], np.arange(E) * m)
    assert tiles.tiles == -(-E // schur_p.TILE) and tiles.n_flux == E * m
    _, A_inv, A_diag, _ = _reference_pieces(aj)
    Lb, adiag = schur_p.schur_p_factor(ap._cell_mass_on(torch.device("cpu")), tiles)
    assert tuple(Lb.shape) == (tiles.tiles, m, k + 1, schur_p.TILE)
    assert np.array_equal(adiag.numpy(), A_diag)
    ghost = Lb.permute(1, 2, 0, 3).reshape(m, k + 1, -1)[:, :, E:]
    assert bool((ghost[:, 0] == 1).all()) and bool((ghost[:, 1:] == 0).all())
    v = np.random.default_rng(9).standard_normal(E * m)
    _close(schur_p.schur_p_solve(Lb, tiles, torch.as_tensor(v)), A_inv(v), 1e-12)


def test_schur_p_tile_plan_raises_on_another_layout():
    """The tile plan takes only the reference's flux layout."""
    ap = _pair(_tree(), 2, 1)[1]
    base, color = np.asarray(ap._edge_flux_base), ap.network.edge_color
    N = ap.network.N
    schur_p.flux_tiles(base, color, N, 2, "cpu")
    for bad in (base[::-1].copy(), base + 1, base * 2):
        with pytest.raises(ValueError, match="flux dofs"):
            schur_p.flux_tiles(bad, color, N, 2, "cpu")
    with pytest.raises(ValueError, match="k in 1"):
        schur_p.FluxTiles(torch.zeros(3, dtype=torch.int32), N, schur_p.MAX_K + 1)


def test_schur_p_floating_component_raises():
    G = nx.DiGraph()
    for i, pos in enumerate([(0, 0), (1, 0), (0.5, 1)]):
        G.add_node(i, pos=np.array(pos, dtype=float))
    G.add_edges_from([(0, 1), (1, 2), (2, 0)])
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(G, N=1), flux_degree=2, pressure_degree=1)
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    with pytest.raises(RuntimeError, match="no boundary node"):
        P.Solver(asm, device="cpu").solve()


# ---------------------------------------------------------- generic methods


def _analytic_y():
    s = np.sqrt(2.5)
    return -1.0 / (s + 1.0), 2.0 / (s + 1.0), 1.0 / (s + 1.0)


@pytest.mark.parametrize("method", ["dense", "minres", "host_lu"])
@pytest.mark.parametrize("N", [1, 4])
def test_y_bifurcation_analytic(method, N):
    (xj, ij, _), (xp, ip, s) = _solve_both(
        lambda pkg: pkg.network_generation.make_tree(2, 1, 3), N=N,
        options={"method": method, "rtol": 1e-13})
    assert ip.method == method and ip.converged
    lam, q_root, q_branch = _analytic_y()
    np.testing.assert_allclose(xp[-1:], [lam], atol=1e-9)
    mesh = s.assembler.network
    flux = {}
    for fn in s.solve()[:-2]:
        view = mesh.submeshes[fn.space.color]
        for i, e in enumerate(view.edge_ids):
            flux[int(e)] = fn.values.reshape(view.edge_ids.size, -1)[i]
    np.testing.assert_allclose(flux[0], q_root, atol=1e-9)
    np.testing.assert_allclose(flux[1], q_branch, atol=1e-9)
    np.testing.assert_allclose(flux[2], q_branch, atol=1e-9)
    if method == "minres":
        assert abs(ip.iterations - ij.iterations) <= 1, (ip, ij)
        _close(xp, xj, 1e-7)
    else:
        _close(xp, xj, 1e-10)


# plain LU on the CPU is O(n³) in eager steps: the arterial goldens (2,526
# dofs) and tree_N256 (1,540) run under host_lu only
DENSE_GOLDENS = [n for n in GOLDEN_NAMES if n not in ("arterial", "arterial_poiseuille", "tree_N256")]


@pytest.mark.parametrize("method,name", [("dense", n) for n in DENSE_GOLDENS]
                         + [("host_lu", n) for n in GOLDEN_NAMES]
                         + [("minres", n) for n in ("y_bifurcation", "tree4")])
def test_goldens_generic(method, name):
    golden = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    mesh, asm = _golden_problem(P, golden)
    opts = {"method": method} if method != "minres" else {"method": method, "rtol": 1e-13}
    solver = P.Solver(asm, device="cpu", options=P.SolverOptions(**opts))
    solver.assemble()
    sol = solver.solve()
    assert solver.info.converged and solver.info.method == method
    _check_golden(golden, mesh, asm, sol, tol=1e-7 if method == "minres" else 1e-10)


@pytest.mark.parametrize("schur_method", ["dense", "dense_f64"])
@pytest.mark.parametrize("name", ["y_bifurcation", "arterial_poiseuille", "web48"])
def test_goldens_dense_schur_variants(name, schur_method):
    golden = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    mesh, asm = _golden_problem(P, golden)
    solver = P.Solver(asm, device="cpu", options=P.SolverOptions(schur_method=schur_method))
    sol = solver.solve()
    assert isinstance(solver._executor, PS._DenseExecutor) and solver.info.converged
    _check_golden(golden, mesh, asm, sol, tol=1e-10)


@pytest.mark.parametrize("schur_method", ["dense", "dense_f64"])
@pytest.mark.parametrize("graph", ["grid", "tree"])
def test_dense_schur_variants_match_reference(graph, schur_method):
    g = _grid(5, 4) if graph == "grid" else _tree(4, 1, 2)
    (xj, ij, _), (xp, ip, _) = _solve_both(
        g, N=2, k=2, options={"schur_method": schur_method},
        R=lambda mesh: np.random.default_rng(2).uniform(0.5, 2.0, mesh.num_edges))
    assert ip.converged and ip.method == "schur" and ip.residual <= 1e-9
    _close(xp, xj, 1e-10)


def _floating_triangle(pkg):
    G = nx.DiGraph()
    for i, pos in enumerate([(0, 0), (1, 0), (0.5, 1)]):
        G.add_node(i, pos=np.array(pos, dtype=float))
    G.add_edges_from([(0, 1), (1, 2), (2, 0)])
    return G


@pytest.mark.parametrize("schur_method", ["dense", "dense_f64"])
def test_dense_gates_trip_on_a_floating_component(schur_method):
    """The singular Laplacian of a component without a boundary node: the
    pivot gate sets λ to NaN and the solve reports ``converged=False``."""
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(_floating_triangle(P), N=1))
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    opts = P.SolverOptions(schur_method=schur_method)
    ex = PS.build_schur_executor(asm, opts, device="cpu")
    x, info = PS._schur_solve(asm, opts, ex)
    assert not info.converged and np.isnan(x[-3:]).all()


def _vessels(pkg):
    """Three disjoint vessels: no bifurcation anywhere."""
    pos = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.5, 1.0], [2.0, 0.0], [2.0, 2.0]])
    return pkg.ArrayNetwork(pos=pos, edges=np.array([[0, 1], [2, 3], [4, 5]]))


@pytest.mark.parametrize("case", ["single", "three-k2"])
@pytest.mark.parametrize("schur_method", ["auto", "tree", "cg", "dense_f64"])
def test_no_bifurcation_matches_reference(case, schur_method):
    if case == "single":
        kw = dict(graph=_tree(1, 1, 3), N=8, f=0.5)
    else:
        kw = dict(graph=_vessels, N=4, k=2, f=lambda x: x[0] + 1.0)
    (xj, ij, _), (xp, ip, s) = _solve_both(options={"schur_method": schur_method}, **kw)
    assert isinstance(s._executor, PS._EdgeExecutor)
    assert ip == ij == PS.SolveInfo("schur", 0, 0.0, True)
    _close(xp, xj, 1e-10)


@pytest.mark.parametrize("kind", ["nest", "mpi", "csr"])
def test_explicit_kind_still_solves_by_schur(kind):
    (xj, ij, _), (xp, ip, s) = _solve_both(_tree(), kind=kind)
    assert ip.method == "schur" and ip.converged
    assert s.A is not None and s.b is not None
    _close(xp, xj, 1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_cross_method_and_conservation(seed):
    """``tests/test_fuzz.py``'s cross-method case on the port: schur ==
    host_lu on random cyclic networks, mass conserved at every junction,
    and the solution satisfies the independently assembled system."""
    rng = np.random.default_rng(100 + seed)
    G = random_network(rng, n_core=int(rng.integers(5, 20)), n_extra=int(rng.integers(0, 5)))
    mesh = P.NetworkMesh(G, N=int(rng.integers(1, 5)))
    p_bc, f, R = _random_coefficients(rng, mesh)
    xs = {}
    for method in ("schur", "host_lu"):
        asm = P.HydraulicNetworkAssembler(mesh)
        asm.compute_forms(p_bc_ex=p_bc, f=f, R=R)
        s = P.Solver(asm, device="cpu", options=P.SolverOptions(method=method))
        s.assemble()
        s.solve()
        xs[method] = s.solution_vector()
    _close(xs["schur"], xs["host_lu"], 1e-9)
    A, b = asm.assemble(kind="dense", device="cpu")
    res = A.numpy() @ xs["schur"] - b.numpy()
    assert np.abs(res).max() < 1e-9 * max(1.0, float(np.abs(b.numpy()).max()))
    offs = asm.block_offsets
    q_end = {}
    q_start = {}
    for e in range(mesh.num_edges):
        base = int(asm._edge_flux_base[e])
        q_start[e] = xs["schur"][base]
        q_end[e] = xs["schur"][base + asm._dofs_per_edge - 1]
    for b_idx in range(mesh.num_multipliers):
        qin = sum(q_end[int(e)] for e in mesh.in_edge_ids(b_idx))
        qout = sum(q_start[int(e)] for e in mesh.out_edge_ids(b_idx))
        assert abs(qin - qout) < 1e-9
    del offs


# ------------------------------------------------------------ MINRES and LU


def _indefinite(n, seed):
    """Symmetric indefinite ``A = Q diag(±[1, 1.05]) Qᵀ``: MINRES converges
    in well under n iterations, so the counts are the recurrence's, not
    roundoff's."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.concatenate([np.linspace(1, 1.05, n // 2), -np.linspace(1, 1.05, n - n // 2)])
    A = (Q * eig) @ Q.T
    return A, A @ rng.standard_normal(n)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("n", [20, 60])
def test_minres_matches_reference(n, precond):
    A, b = _indefinite(n, seed=n)
    d = np.random.default_rng(n + 1).uniform(1.0, 1.01, n)  # keeps the two clusters
    ref = JK.minres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), rtol=1e-12,
                    precond=(lambda v: v / jnp.asarray(d)) if precond else None)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    reads = PK.minres.flag_reads
    got = PK.minres(lambda v: At @ v, torch.as_tensor(b), rtol=1e-12,
                    precond=(lambda v: krylov.jacobi(v, dt)) if precond else None)
    assert got.converged and bool(ref.converged)
    assert int(ref.iters) < n and abs(got.iters - int(ref.iters)) <= 1, (got.iters, int(ref.iters))
    assert PK.minres.flag_reads - reads == -(-got.iters // PK.CHUNK) + 1
    _close(got.x, np.asarray(ref.x), 1e-12)
    _close(got.x, np.linalg.solve(A, b), 1e-9)


@pytest.mark.parametrize("chunk", [1, 3, 4, 7])
def test_minres_chunk_does_not_change_the_result(chunk):
    A, b = _indefinite(40, seed=1)
    At = torch.as_tensor(A)
    one = PK.minres(lambda v: At @ v, torch.as_tensor(b), chunk=1)
    got = PK.minres(lambda v: At @ v, torch.as_tensor(b), chunk=chunk)
    assert got.iters == one.iters and torch.equal(got.x, one.x)


def test_plain_lu_pivots_equal_lapack_on_the_saddle_matrix():
    """The Y-bifurcation's saddle matrix (zero diagonals, equal ±1 entries):
    the plain LU picks LAPACK's pivots (lowest row on ties) and its factors."""
    for N, k, kp in ((4, 1, 0), (3, 2, 1)):
        mesh = P.NetworkMesh(P.network_generation.make_tree(2, 1, 3), N=N)
        asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=kp)
        asm.compute_forms(p_bc_ex=lambda x: x[1])
        A, b = asm.assemble(kind="dense", device="cpu")
        LU, piv = dense_lu.lu_factor(A)
        lu_ref, piv_ref = sla.lu_factor(A.numpy())
        assert np.array_equal(piv.numpy(), piv_ref)
        _close(LU, lu_ref, 1e-13)
        _close(dense_lu.lu_solve(LU, piv, b), np.linalg.solve(A.numpy(), b.numpy()), 1e-12)


def _unblocked_lu(A):
    """The unblocked right-looking loop, step by step: the oracle of the
    blocked schedule."""
    LU = A.clone()
    n = LU.shape[0]
    piv = torch.empty(n, dtype=torch.int32)
    for k in range(n):
        p = k + int(torch.argmax(LU[k:, k].abs()))
        piv[k] = p
        LU[[k, p]] = LU[[p, k]]
        if k + 1 < n:
            r = 1.0 / LU[k, k]
            LU[k + 1:, k] = LU[k + 1:, k] * r
            LU[k + 1:, k + 1:] = LU[k + 1:, k + 1:] - torch.outer(LU[k + 1:, k], LU[k, k + 1:])
    return LU, piv


def _column_trsv(A, x, lower, trans, unit):
    """The column loop: x[c] final, then every later row subtracts a(i, c) x[c]."""
    x = x.clone()
    n = x.shape[0]
    forward = lower != trans
    for s_ in range(n):
        c = s_ if forward else n - 1 - s_
        if not unit:
            x[c] = x[c] / A[c, c]
        col = A[c, :] if trans else A[:, c]
        if forward:
            x[c + 1:] = x[c + 1:] - col[c + 1:] * x[c]
        else:
            x[:c] = x[:c] - col[:c] * x[c]
    return x


def _saddle(graph, N, k, kp):
    mesh = P.NetworkMesh(graph(P), N=N)
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=kp)
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    return asm.assemble(kind="dense", device="cpu")[0]


LU_MATRICES = {
    "y_bifurcation": lambda: _saddle(_tree(2, 1, 3), 4, 2, 1),
    "tree4_p2p1": lambda: _saddle(_tree(4), 3, 2, 1),
    "random_101": lambda: torch.as_tensor(np.random.default_rng(5).standard_normal((101, 101))),
}


@pytest.mark.parametrize("name", sorted(LU_MATRICES))
def test_blocked_plain_lu_equals_the_unblocked_loop(name):
    """K21b's schedule keeps the unblocked order: for panel widths 1, 2, 7,
    32 and 64 (none dividing n = 101; the saddle matrices' ties, zero
    diagonals and ±1 entries) the pivots and the factor are the unblocked
    loop's to the last bit.  The pivots are SciPy's on the Y-bifurcation and
    the random matrix.  On ``make_tree(4)``'s P2/P1 matrix (n = 158) LAPACK's
    recursive ``dgetrf`` breaks 14 near-ties (candidates equal in exact
    arithmetic, 1–3 ulp apart in either order) the other way; there the
    factor is held to a backward error of 8·n·ε·max |A|."""
    A = LU_MATRICES[name]()
    want_lu, want_piv = _unblocked_lu(A)
    n = A.shape[0]
    if name == "tree4_p2p1":
        order = list(range(n))
        for k, p in enumerate(want_piv.tolist()):
            order[k], order[p] = order[p], order[k]
        L = torch.tril(want_lu, -1) + torch.eye(n, dtype=A.dtype)
        back = float((A[order] - L @ torch.triu(want_lu)).abs().max())
        assert back <= 8 * n * np.finfo(float).eps * float(A.abs().max()), back
    else:
        assert np.array_equal(want_piv.numpy(), sla.lu_factor(A.numpy())[1])
    for nb in (1, 2, 7, 32, 64):
        LU, piv = dense_lu.lu_factor_plain(A, nb=nb)
        assert torch.equal(piv, want_piv), nb
        assert torch.equal(LU, want_lu), nb
    assert name != "random_101" or int((want_piv != torch.arange(101)).sum()) > 50


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("lower,trans", [(True, False), (True, True), (False, False), (False, True)])
def test_tiled_plain_trsv_equals_the_column_loop(lower, trans, unit):
    """The tiled triangular solve (64-row tiles, and 7) is the column loop to
    the last bit in all four (lower, trans) cases, unit or stored diagonal,
    at n = 150 (not a multiple of the tile)."""
    rng = np.random.default_rng(11)
    n = 150
    A = torch.as_tensor(rng.standard_normal((n, n)) + 4 * np.eye(n))
    x = torch.as_tensor(rng.standard_normal(n))
    want = _column_trsv(A, x, lower, trans, unit)
    for tile in (dense_lu.TILE, 7, 1):
        assert torch.equal(dense_lu.trsv_plain(A, x, lower, trans, unit, tile=tile), want), tile


def test_wrappers_never_fall_back_off_the_cpu():
    """CPU tensors run the plain versions without counting a launch; a
    tensor on any other device goes to the kernel path, which validates it
    and raises."""
    kernels.reset_launches()
    for k, kp, method in ((2, 1, "auto"), (1, 0, "minres"), (1, 0, "dense")):
        asm = P.HydraulicNetworkAssembler(P.NetworkMesh(_tree()(P), N=2), k, kp)
        asm.compute_forms(p_bc_ex=lambda x: x[1])
        P.Solver(asm, device="cpu", options=P.SolverOptions(method=method)).solve()
    assert all(n == 0 for n in kernels.launches().values())
    assert {"csr_fold", "csr_spmv", "schur_p_factor", "schur_p_solve", "dense_lu",
            "minres"} <= set(kernels.launches())
    meta = torch.ones(4, dtype=torch.float64, device="meta")
    imeta = torch.ones(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        csr.csr_fold(imeta, imeta[None], meta)
    with pytest.raises(ValueError, match="CUDA"):
        csr.csr_spmv(imeta.long(), imeta[:3], meta[:3], meta)
    tiles = schur_p.FluxTiles(torch.zeros(2, dtype=torch.int32), 1, 1)  # E = 2, m = 2
    with pytest.raises(ValueError, match="CUDA"):
        schur_p.schur_p_solve(meta.reshape(1, 2, 2, 1).expand(1, 2, 2, 32), tiles, meta)
    with pytest.raises(ValueError, match="CUDA"):
        schur_p.schur_p_factor(meta[:2].reshape(2, 1, 1).expand(2, 2, 2).contiguous(), tiles)
    with pytest.raises(ValueError, match="meta"):
        schur_p.FluxTiles(imeta, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        dense_lu.lu_factor(meta.reshape(2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        krylov.MinresSteps(krylov.minres_state("meta"), meta, meta, meta, meta)


def test_items_left_still_raise():
    """``factorize()`` (A3a) gives the reference's factorized solve at
    1e-12·scale, float32 (A4) raises naming its ROADMAP item; serial
    ``"tree_dist"`` runs the reference's CG branch and equals the JAX
    package (method, iterations within 1, values at 1e-9·scale)."""
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(_tree()(P), N=2))
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    factored = []
    for pkg, a in ((J, None), (P, asm)):
        if a is None:
            a = J.HydraulicNetworkAssembler(J.NetworkMesh(_tree()(J), N=2))
            a.compute_forms(p_bc_ex=lambda x: x[1])
        s = pkg.Solver(a, **({"device": "cpu"} if pkg is P else {}))
        s.factorize()
        s.solve()
        assert s.info.method == "schur_factorized"
        factored.append(np.asarray(s.solution_vector()))
    _close(factored[1], factored[0], 1e-12)
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        P.Solver(asm, device="cpu", options=P.SolverOptions(dtype="float32")).solve()
    xs, infos = [], []
    for pkg in (J, P):
        a = pkg.HydraulicNetworkAssembler(pkg.NetworkMesh(_tree()(pkg), N=2))
        a.compute_forms(p_bc_ex=lambda x: x[1])
        kw = {"device": "cpu"} if pkg is P else {}
        s = pkg.Solver(a, options=pkg.SolverOptions(schur_method="tree_dist"), **kw)
        s.solve()
        xs.append(np.asarray(s.solution_vector()))
        infos.append(s.info)
    assert infos[0].method == infos[1].method == "schur" and infos[1].converged
    assert abs(infos[0].iterations - infos[1].iterations) <= 1, infos
    _close(xs[1], xs[0], 1e-9)


# ------------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_schur_p_kernels_match_plain_on_card():
    """K21a: the band factor (and A_diag) and one A⁻¹ apply at 1e-12·scale;
    whole schur_p solves within 2 iterations and at 1e-9·scale."""
    dev = _card()
    mesh = P.NetworkMesh(P.network_generation.make_arterial_tree(6, direction=[0.1, 1, 0],
                                                                  arrays=True), N=6)
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=2, pressure_degree=1)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=1.0 / mesh.edge_radius**4)
    ex = PS._SchurPExecutor(asm, P.SolverOptions(), dev)
    cm = asm._cell_mass_on(dev)
    got = schur_p.schur_p_factor(cm, ex.tiles)
    want = schur_p.schur_p_factor_plain(cm, ex.tiles)
    for a, b in zip(got, want):
        _close(a, b, 1e-12)
    v = torch.randn(ex.n_flux, dtype=torch.float64, device=dev)
    _close(schur_p.schur_p_solve(got[0], ex.tiles, v),
           schur_p.schur_p_solve_plain(want[0], ex.tiles, v), 1e-12)
    x, iters, _, ok = ex()
    xp, iters_p, _, ok_p = ex.plain()
    assert ok and ok_p and abs(iters - iters_p) <= 2
    _close(x, xp, 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("k,N", [(2, 3), (5, 4), (2, 150)])
def test_schur_p_ragged_tiles_on_card(k, N):
    """K21a on 61 edges (a ragged last tile) at k = 2 and k = 5 — the staged
    solve with its window in registers and read back from shared memory —
    and at N = 150 (a tile too large for shared memory, solved in device
    memory): factor and solve against the plain versions at 1e-12·scale,
    one launch each, a vector at an 8-byte offset (moved without bulk
    copies) to the same values."""
    dev = _card()
    ap = _pair(TILE_GRAPHS["ragged"], k, k - 1, N=N)[1]
    tiles = schur_p.flux_tiles(ap._edge_flux_base, ap.network.edge_color, N, k, dev)
    cm = ap._cell_mass_on(dev)
    kernels.reset_launches()
    got = schur_p.schur_p_factor(cm, tiles)
    want = schur_p.schur_p_factor_plain(cm, tiles)
    for a, b in zip(got, want):
        _close(a, b, 1e-12)
    buf = torch.randn(tiles.n_flux + 1, dtype=torch.float64, device=dev)
    v = buf[:-1].clone()
    x = schur_p.schur_p_solve(got[0], tiles, v)
    _close(x, schur_p.schur_p_solve_plain(want[0], tiles, v), 1e-12)
    assert schur_p.FACTOR.launches == 1 and schur_p.SOLVE.launches == 1
    buf[1:] = v
    assert torch.equal(schur_p.schur_p_solve(got[0], tiles, buf[1:]), x)


@pytest.mark.cuda
def test_dense_lu_kernel_matches_plain_on_card():
    """K21b on random diagonally dominant matrices of order 301 and 4,096
    and on the Y-bifurcation's saddle matrix: pivots and factor equal to the
    plain version bit for bit, solves equal too; the triangular solves on a
    Cholesky factor, all four (lower, trans) cases, equal."""
    dev = _card()
    rng = np.random.default_rng(0)
    mesh = P.NetworkMesh(P.network_generation.make_tree(2, 1, 3), N=4)
    asm = P.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    S, _ = asm.assemble(kind="dense", device=dev)
    for n in (301, 4096):
        A = torch.as_tensor(rng.standard_normal((n, n)) + n * np.eye(n), device=dev)
        for M in (A, S):
            b = torch.randn(M.shape[0], dtype=torch.float64, device=dev)
            LU, piv = dense_lu.lu_factor(M)
            LU_p, piv_p = dense_lu.lu_factor_plain(M)
            assert torch.equal(piv, piv_p)
            assert torch.equal(LU, LU_p)
            assert torch.equal(dense_lu.lu_solve(LU, piv, b), dense_lu.lu_solve_plain(LU_p, piv_p, b))
    n = 301
    A = torch.as_tensor(rng.standard_normal((n, n)) + n * np.eye(n), device=dev)
    C = torch.linalg.cholesky(A @ A.T).contiguous()
    b = torch.randn(n, dtype=torch.float64, device=dev)
    for lower, trans in ((True, False), (True, True), (False, False), (False, True)):
        for unit in (False, True):
            assert torch.equal(dense_lu.trsv(C, b, lower, trans, unit),
                               dense_lu.trsv_plain(C, b, lower, trans, unit))


@pytest.mark.cuda
def test_minres_kernels_match_plain_on_card():
    """K19e: whole MINRES runs on a seeded indefinite system, kernel and
    plain, the same iterations and x at 1e-12·scale."""
    dev = _card()
    A, b = _indefinite(200, seed=2)
    At, bt = torch.as_tensor(A, device=dev), torch.as_tensor(b, device=dev)
    d = torch.as_tensor(np.random.default_rng(3).uniform(1.0, 1.01, 200), device=dev)
    got = PK.minres(lambda v: At @ v, bt, precond=lambda v: krylov.jacobi(v, d))
    want = PK.minres(lambda v: At @ v, bt, precond=lambda v: krylov.jacobi_plain(v, d), plain=True)
    assert got.converged and abs(got.iters - want.iters) <= 1
    _close(got.x, want.x, 1e-12)
