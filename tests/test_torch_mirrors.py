"""Reference test families mirrored on the PyTorch port, on ``device="cpu"``
(the kernels' plain versions), each case against the JAX package:

* ``tests/test_multicomponent.py``: a two-component forest against its
  components solved alone (1e-11), and the components' agreement across
  methods (``"tree"``, ``"host_lu"`` and ``"dense"``, K21b's route; 1e-10);
* ``tests/test_convergence.py``: the P1-flux / DG0-pressure rates on a unit
  edge with ``f = sin(πs)`` and λ's Richardson decay on the Y-bifurcation;
* ``tests/test_orientation.py``: the tangent integral on chains of mixed
  edge directions, the stored-flip pattern, the recovered edge direction;
* ``tests/test_fuzz.py::test_fuzz_lattice_dct_vs_host_lu``: random lattices
  through the DCT grid route against host LU (1e-9·scale).

The reference's tolerances and seeds are kept; the port additionally equals
the JAX package's solution at 1e-10·scale (scale = max(1, max |x|)).
"""

import networkx as nx
import numpy as np
import pytest
import torch

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import lattice as PL

from test_convergence import _unit_edge_graph
from test_multicomponent import _shifted_tree
from test_orientation import CASES, _assembled_tangent_integral, _chain

torch.set_num_threads(1)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _solve(pkg, G, N=3, p_bc=lambda x: x[1], k=1, options=None, **forms):
    """``(mesh, functions, solver)`` of one package's solve on ``G``."""
    mesh = pkg.NetworkMesh(G, N=N)
    asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k)
    asm.compute_forms(p_bc_ex=p_bc, **forms)
    kw = {"device": "cpu"} if pkg is P else {}
    s = pkg.Solver(asm, options=pkg.SolverOptions(**(options or {})), **kw)
    s.assemble()
    return mesh, s.solve(), s


def _same_solution(sol_p, sol_j, tol=1e-10):
    assert len(sol_p) == len(sol_j)
    for fp, fj in zip(sol_p, sol_j):
        _close(fp.values, fj.values, tol)


# ------------------------------------------------------- multicomponent


def _combined(G1, G2):
    combined = nx.DiGraph()
    offset = G1.number_of_nodes()
    for i in G1.nodes():
        combined.add_node(i, pos=G1.nodes[i]["pos"])
    for i in G2.nodes():
        combined.add_node(offset + i, pos=G2.nodes[i]["pos"])
    combined.add_edges_from(G1.edges())
    combined.add_edges_from((offset + u, offset + v) for u, v in G2.edges())
    return combined


def test_two_components_match_individual_solves():
    """``test_multicomponent.py:38``: λ is the union of the components'
    multipliers, the pressures the first component's cells then the
    second's (1e-11); the combined solve equals the JAX package's."""
    G1, G2 = _shifted_tree(2, 0.0), _shifted_tree(3, 10.0)
    mesh_c, sol_c, _ = _solve(P, _combined(G1, G2))
    mesh_1, sol_1, _ = _solve(P, G1)
    _, sol_2, _ = _solve(P, G2)
    lam_expected = np.concatenate([sol_1[-1].values, sol_2[-1].values])
    np.testing.assert_allclose(np.sort(sol_c[-1].values), np.sort(lam_expected), atol=1e-11)
    n1 = mesh_1.num_cells
    np.testing.assert_allclose(sol_c[-2].values[:n1], sol_1[-2].values, atol=1e-11)
    np.testing.assert_allclose(sol_c[-2].values[n1:], sol_2[-2].values, atol=1e-11)
    _same_solution(sol_c, _solve(J, _combined(G1, G2))[1])


def test_components_match_across_methods():
    """``test_multicomponent.py:65``: the tree Schur solve, host LU and the
    dense LU (K21b's plain version) agree at 1e-10, and with the JAX
    package's host LU."""
    combined = nx.disjoint_union(_shifted_tree(2, 0.0), _shifted_tree(2, 5.0))
    _, sol_t, _ = _solve(P, combined, options=dict(method="schur", schur_method="tree"))
    _, sol_h, _ = _solve(P, combined, options=dict(method="host_lu"))
    _, sol_d, s_d = _solve(P, combined, options=dict(method="dense"))
    assert s_d.info.method == "dense"
    for a, b, c in zip(sol_t, sol_h, sol_d):
        np.testing.assert_allclose(a.values, b.values, atol=1e-10)
        np.testing.assert_allclose(c.values, b.values, atol=1e-10)
    _same_solution(sol_d, _solve(J, combined, options=dict(method="host_lu"))[1])


# ---------------------------------------------------------- convergence


def _edge_errors(N):
    """``test_convergence.py:50``'s L2 errors of the port's solve, and its
    solution against the JAX package's."""
    f = lambda x: np.sin(np.pi * x[0])  # noqa: E731
    _, sol, _ = _solve(P, _unit_edge_graph(), N=N, p_bc=0.0, f=f)
    _same_solution(sol, _solve(J, _unit_edge_graph(), N=N, p_bc=0.0, f=f)[1])
    q, p = sol[0].values, sol[1].values
    s_nodes = np.linspace(0, 1, N + 1)
    s_mid = (np.arange(N) + 0.5) / N
    h = 1.0 / N
    eq = np.sqrt(np.sum((q + np.cos(np.pi * s_nodes) / np.pi) ** 2) * h)
    ep = np.sqrt(np.sum((p - np.sin(np.pi * s_mid) / np.pi**2) ** 2) * h)
    return eq, ep


def test_convergence_rates_single_edge():
    """P1 flux at second order, DG0 pressure at first order at least."""
    Ns = [8, 16, 32, 64, 128]
    eqs, eps_ = zip(*(_edge_errors(N) for N in Ns))
    rate_q = np.polyfit(np.log(Ns), np.log(eqs), 1)[0]
    rate_p = np.polyfit(np.log(Ns), np.log(eps_), 1)[0]
    assert rate_q < -1.8, f"flux rate {rate_q}"
    assert rate_p < -0.9, f"pressure rate {rate_p}"


def test_convergence_on_y_network():
    """λ on the Y-bifurcation with ``f = cos(y)``: successive differences
    shrink by more than 3 from N = 8 to 16 to 32."""
    G = P.network_generation.make_tree(2, 1, 3)
    f = lambda x: np.cos(x[1])  # noqa: E731
    lam = {}
    for N in (8, 16, 32):
        _, sol, _ = _solve(P, G, N=N, f=f)
        _same_solution(sol, _solve(J, J.network_generation.make_tree(2, 1, 3), N=N, f=f)[1])
        lam[N] = float(sol[-1].values[0])
    d1, d2 = abs(lam[16] - lam[8]), abs(lam[32] - lam[16])
    assert d2 < d1 / 3.0, (d1, d2)


# ---------------------------------------------------------- orientation


@pytest.mark.parametrize("refinement", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_orientation_integral(case, refinement):
    """The closed-form tangent integral, and the port's orientation and
    tangents equal to the JAX package's."""
    E = 29
    mask_fn, expected_fn = CASES[case]
    G = _chain(E + 1, mask_fn(E))
    mesh = P.NetworkMesh(G, N=refinement)
    assert np.isclose(_assembled_tangent_integral(mesh), expected_fn(E))
    ref = J.NetworkMesh(G, N=refinement)
    assert np.array_equal(mesh.orientation, ref.orientation)
    np.testing.assert_allclose(mesh.cell_tangent, ref.cell_tangent, rtol=0, atol=1e-15)


@pytest.mark.parametrize("N", [1, 3])
def test_orientation_values(N):
    """N ≥ 2 stores each edge's last cell flipped; N = 1 stores in order."""
    mesh = P.NetworkMesh(_chain(4, np.ones(3, bool)), N=N)
    orient = mesh.orientation.reshape(mesh.num_edges, N)
    if N == 1:
        assert np.all(orient == 1.0)
    else:
        assert np.all(orient[:, :-1] == 1.0)
        assert np.all(orient[:, -1] == -1.0)


def test_orientation_consistent_with_edge_direction():
    """orientation × stored tangent is the graph edge's direction."""
    rng = np.random.default_rng(7)
    mesh = P.NetworkMesh(_chain(12, rng.random(11) < 0.5), N=3)
    edge_dir = mesh.vertices[mesh.edges[:, 1]] - mesh.vertices[mesh.edges[:, 0]]
    edge_dir /= np.linalg.norm(edge_dir, axis=1, keepdims=True)
    recovered = mesh.cell_tangent * mesh.orientation[:, None]
    np.testing.assert_allclose(recovered, edge_dir[mesh.cell_edge], atol=1e-12)


# ----------------------------------------------------------------- fuzz


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_lattice_dct_vs_host_lu(seed):
    """Random lattice sizes, refinements, flux degrees and source kinds on
    the grid route (``schur_method="dct"``) against host LU at 1e-9·scale,
    with the reference's draws (seed 900 + seed)."""
    rng = np.random.default_rng(900 + seed)
    nx_, ny_ = int(rng.integers(3, 11)), int(rng.integers(2, 11))
    N = int(rng.integers(1, 4))
    G = P.network_generation.make_grid(nx_, ny_, arrays=True)
    mesh = P.NetworkMesh(G, N=N)
    E, C = mesh.num_edges, mesh.num_edges * N
    fkind = rng.choice(["scalar", "edge", "cell", "zero"])
    f = {"zero": None, "scalar": float(rng.uniform(-1, 1)), "edge": rng.uniform(-1.0, 1.0, E),
         "cell": rng.uniform(-1.0, 1.0, C)}[fkind]
    R = float(rng.uniform(0.5, 3.0))
    k = int(rng.integers(1, 4))
    forms = dict(R=R, **({} if f is None else {"f": f}))
    p_bc = lambda x: x[0] - 0.3 * x[1]  # noqa: E731
    sols = {}
    for method, opts in (("dct", dict(method="schur", schur_method="dct")),
                         ("host_lu", dict(method="host_lu"))):
        _, sols[method], s = _solve(P, G, N=N, p_bc=p_bc, k=k, options=opts, **forms)
        if method == "dct":
            assert isinstance(getattr(s._executor, "blocked_plan", None), PL._GridPlan), \
                (nx_, ny_, N, fkind, k)
    for fs, fl in zip(sols["dct"], sols["host_lu"]):
        scale = max(1.0, float(np.max(np.abs(fl.values))))
        np.testing.assert_allclose(fs.values, fl.values, atol=1e-9 * scale)
    G_j = J.network_generation.make_grid(nx_, ny_, arrays=True)
    _same_solution(sols["dct"], _solve(J, G_j, N=N, p_bc=p_bc, k=k,
                                       options=dict(method="schur", schur_method="dct"), **forms)[1])
