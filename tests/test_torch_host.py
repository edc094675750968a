"""Host layer of the PyTorch port against the JAX reference.

Graph generation, mesh, coloring, dof maps, coefficient preparation, the
blocked planner and the reference-state carry-over are NumPy in both
packages; on the same inputs they must give ``np.array_equal`` arrays.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu_torch import blocked as PB
from networks_fenicsx_tpu_torch import interop
from networks_fenicsx_tpu_torch.kernels import tree_sweep

from _torch_cases import arterial, asymmetric, chain, kary

torch.set_num_threads(1)


TOPOLOGIES = {
    "binary": lambda pkg: pkg.network_generation.make_tree(4, 1.0, 2.0, arrays=True),
    "arterial": lambda pkg: arterial(pkg, 6),
    "k3": lambda pkg: kary(pkg, 3, 2),
    "k4": lambda pkg: kary(pkg, 4, 1),
    "asymmetric": asymmetric,
    "chain": chain,
}


def _graph_arrays(G):
    if isinstance(G, (J.ArrayNetwork, P.ArrayNetwork)):
        return np.asarray(G.pos), np.asarray(G.edges), G.radius
    pos = np.asarray([np.asarray(G.nodes[i]["pos"], float) for i in range(G.number_of_nodes())])
    edges = np.asarray(list(G.edges()), dtype=np.int64).reshape(-1, 2)
    radius = [d.get("radius") for _, _, d in G.edges(data=True)]
    return pos, edges, None if radius and radius[0] is None else np.asarray(radius)


def _assert_graphs_equal(Gj, Gp):
    for a, b in zip(_graph_arrays(Gj), _graph_arrays(Gp)):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert np.array_equal(a, b)


@pytest.mark.parametrize("arrays", [False, True])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_make_tree_equal(n, arrays):
    _assert_graphs_equal(
        J.network_generation.make_tree(n, 1.3, 2.1, arrays=arrays),
        P.network_generation.make_tree(n, 1.3, 2.1, arrays=arrays),
    )


@pytest.mark.parametrize("arrays", [False, True])
def test_make_arterial_tree_equal(arrays):
    kw = dict(N=6, direction=[0.1, 1, 0], arrays=arrays)
    _assert_graphs_equal(
        J.network_generation.make_arterial_tree(**kw),
        P.network_generation.make_arterial_tree(**kw),
    )


def test_make_arterial_tree_random_equal():
    kw = dict(N=4, random=True, seed=3)
    _assert_graphs_equal(
        J.network_generation.make_arterial_tree(**kw),
        P.network_generation.make_arterial_tree(**kw),
    )


@pytest.mark.parametrize("name", ["grid", "random", "bed"])
def test_other_generators_equal(name):
    def make(pkg):
        g = pkg.network_generation
        if name == "grid":
            return g.make_grid(4, 3, arrays=True)
        if name == "random":
            return g.make_random_network(20, keep=0.6, seed=4, arrays=True)
        return g.make_vascular_bed(2, 5, 4, arrays=True)

    _assert_graphs_equal(make(J), make(P))


MESH_ATTRS = [
    "edges", "edge_color", "edge_length", "vertices", "cells", "cell_edge",
    "cell_color", "orientation", "cell_h", "vertex_markers",
    "bifurcation_values", "boundary_values", "boundary_in_nodes",
    "boundary_out_nodes", "lm_vertices",
]


def _assert_meshes_equal(mj, mp):
    for attr in MESH_ATTRS:
        assert np.array_equal(getattr(mj, attr), getattr(mp, attr)), attr
    for csr in ("bif_in_csr", "bif_out_csr"):
        for a, b in zip(getattr(mj, csr), getattr(mp, csr)):
            assert np.array_equal(a, b), csr
    assert mj.num_edge_colors == mp.num_edge_colors
    assert mj.has_floating_component() == mp.has_floating_component()
    for vj, vp in zip(mj.submeshes, mp.submeshes):
        assert np.array_equal(vj.cell_indices, vp.cell_indices)
        assert np.array_equal(vj.cells, vp.cells)
        assert np.array_equal(vj.facet_markers.values, vp.facet_markers.values)


@pytest.mark.parametrize(
    "maker,strategy",
    [
        (lambda g: g.make_tree(3, 1.0, 2.0), None),
        (lambda g: g.make_tree(3, 1.0, 2.0), "largest_first"),
        (lambda g: g.make_arterial_tree(5, direction=[0.1, 1, 0], arrays=True), "fast"),
        (lambda g: g.make_grid(4, 3, arrays=True), "fast"),
    ],
)
def test_network_mesh_equal(maker, strategy):
    mj = J.NetworkMesh(maker(J.network_generation), N=3, color_strategy=strategy)
    mp = P.NetworkMesh(maker(P.network_generation), N=3, color_strategy=strategy)
    _assert_meshes_equal(mj, mp)


def test_fast_coloring_equals_reference_native():
    """The port always runs the Python bitmask sweep; the reference takes
    its native C++ sweep when it builds — both colorings are equal."""
    from networks_fenicsx_tpu import _native
    from networks_fenicsx_tpu_torch.mesh import _greedy_color_edge_array

    net = J.network_generation.make_arterial_tree(9, arrays=True)
    edges = np.asarray(net.edges)
    V = net.number_of_nodes()
    ported = _greedy_color_edge_array(edges)
    native = _native.color_edges(edges, V)
    reference = native if native is not None else J.mesh._greedy_color_edge_array(edges)
    assert np.array_equal(ported, reference)
    assert np.array_equal(
        J.NetworkMesh(net, N=2, color_strategy="fast").edge_color,
        P.NetworkMesh(P.ArrayNetwork(net.pos, net.edges, net.radius), N=2,
                      color_strategy="fast").edge_color,
    )


DOF_ATTRS = [
    "_block_sizes", "_block_offsets", "_edge_flux_base", "_cell_flux_dofs",
    "_cell_p_dofs", "_edge_start_bif", "_edge_end_bif", "_edges_per_color",
]


@pytest.mark.parametrize("k,kp", [(1, 0), (2, 0), (3, 0), (1, 1), (2, 2)])
def test_dof_maps_equal(k, kp):
    G = J.network_generation.make_tree(3, 1.0, 2.0, arrays=True)
    aj = J.HydraulicNetworkAssembler(J.NetworkMesh(G, N=3), flux_degree=k, pressure_degree=kp)
    ap = P.HydraulicNetworkAssembler(
        P.NetworkMesh(P.ArrayNetwork(G.pos, G.edges), N=3), flux_degree=k, pressure_degree=kp
    )
    for attr in DOF_ATTRS:
        assert np.array_equal(getattr(aj, attr), getattr(ap, attr)), attr
    assert aj.num_dofs == ap.num_dofs
    assert (aj.in_idx, aj.out_idx) == (ap.in_idx, ap.out_idx)
    assert [s.size for s in aj.function_spaces] == [s.size for s in ap.function_spaces]


def _coefficient(rng, kind, E, C):
    return {
        "none": None,
        "scalar": 1.7,
        "edge": rng.uniform(0.5, 2.0, E),
        "cell": rng.uniform(0.5, 2.0, C),
    }[kind]


@pytest.mark.parametrize("R_kind,f_kind", [
    ("none", "none"), ("scalar", "scalar"), ("edge", "edge"), ("cell", "cell"), ("edge", "cell"),
])
def test_schur_arguments_equal(R_kind, f_kind):
    rng = np.random.default_rng(2)
    G = J.network_generation.make_arterial_tree(4, arrays=True)
    mj, mp = J.NetworkMesh(G, N=3), P.NetworkMesh(P.ArrayNetwork(G.pos, G.edges, G.radius), N=3)
    R = _coefficient(rng, R_kind, mj.num_edges, mj.num_cells)
    f = _coefficient(rng, f_kind, mj.num_edges, mj.num_cells)
    aj, ap = J.HydraulicNetworkAssembler(mj), P.HydraulicNetworkAssembler(mp)
    for a in (aj, ap):
        a.compute_forms(p_bc_ex=lambda x: x[0] - 0.4 * x[1], R=R, f=f)
    assert aj.coefficient_modes() == ap.coefficient_modes()
    for a, b in zip(aj.schur_arguments(device=False), ap.schur_arguments()):
        assert np.array_equal(a, b)


def test_r_generation_counter_equal():
    G = J.network_generation.make_tree(3, 1.0, 2.0, arrays=True)
    aj = J.HydraulicNetworkAssembler(J.NetworkMesh(G, N=2))
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(P.ArrayNetwork(G.pos, G.edges), N=2))
    frozen = np.linspace(1.0, 2.0, 7)
    frozen.flags.writeable = False
    writeable = np.linspace(1.0, 2.0, 7)
    for R in (None, None, 2.0, 2.0, frozen, frozen, writeable, writeable, 3.0):
        for a in (aj, ap):
            a.compute_forms(p_bc_ex=0.5, R=R)
        assert aj._R_generation == ap._R_generation


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_plan_blocked_equal(name):
    Gj, Gp = TOPOLOGIES[name](J), TOPOLOGIES[name](P)
    aj = J.HydraulicNetworkAssembler(J.NetworkMesh(Gj, N=2))
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(Gp, N=2))
    for a in (aj, ap):
        a.compute_forms(p_bc_ex=lambda x: x[1])
    pj, pp = JS._plan_blocked(aj), PB._plan_blocked(ap)
    assert pj is not None and pp is not None
    for field in ("bif_order", "edge_order", "bif_offsets", "s_is_bif", "t_is_bif"):
        assert np.array_equal(getattr(pj, field), getattr(pp, field)), field
    assert pj.n_roots == pp.n_roots
    assert [tuple(lv) for lv in pj.levels] == [tuple(lv) for lv in pp.levels]
    if name == "chain":
        assert all(len(lv.outs) == 1 for lv in pp.levels)
    if name == "asymmetric":
        assert any(0 < lv.n_bif_outs < len(lv.outs) for lv in pp.levels)


def test_plan_blocked_none_on_grid():
    G = P.network_generation.make_grid(4, 3, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(G, N=2))
    asm.compute_forms(p_bc_ex=lambda x: x[0])
    assert PB._plan_blocked(asm) is None


def _sweep_through_indices(host, offsets, w, const, Ftot):
    """The kernels' index walk (assemble, per-level fold, per-level
    back-substitution), emulated in NumPy over the flattened plan."""
    B = host["bif_in"].size
    d, r, wn, lam = np.empty(B), np.empty(B), np.empty(B), np.empty(B)
    for b in range(B):
        ie = host["bif_in"][b]
        d[b], r[b], wn[b] = w[ie], const[ie] + Ftot[ie], w[ie]
        for oe in host["bif_out"][b]:
            if oe < 0:
                break
            d[b] = d[b] + w[oe]
            r[b] = r[b] - const[oe]
    rhs_norm = np.sqrt(np.sum(r * r))
    for l in range(len(offsets) - 3, -1, -1):
        for b in range(offsets[l], offsets[l + 1]):
            kids = [c for c in host["bif_child"][b] if c >= 0]
            if not kids:
                continue
            terms = [(-wn[c] * (wn[c] / d[c]), (wn[c] / d[c]) * r[c]) for c in kids]
            ud, ur = terms[0]
            for td, tr in terms[1:]:
                ud, ur = ud + td, ur + tr
            d[b], r[b] = d[b] + ud, r[b] + ur
    for l in range(len(offsets) - 1):
        for b in range(offsets[l], offsets[l + 1]):
            p = host["bif_parent"][b]
            lam[b] = r[b] / d[b] if p < 0 else (r[b] + wn[b] * lam[p]) / d[b]
    return lam, rhs_norm, d, r, wn


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_device_plan_reproduces_plain_sweep(name):
    """The flattened index tensors the kernels read describe the same
    elimination as the plan's level slices."""
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(TOPOLOGIES[name](P), N=2))
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    plan = PB._plan_blocked(asm)
    host = PB.flatten_plan(plan)
    assert np.array_equal(host["edge_src"] >= 0, plan.s_is_bif)
    assert np.array_equal(host["edge_tgt"] >= 0, plan.t_is_bif)
    dp = PB.device_plan(plan, "cpu")
    assert all(t.dtype == torch.int32 for t in (dp.bif_in, dp.bif_out, dp.edge_src))
    rng = np.random.default_rng(8)
    E = plan.edge_order.size
    w, const, Ftot = rng.uniform(0.5, 2.0, E), rng.uniform(-1, 1, E), rng.uniform(-1, 1, E)
    got = _sweep_through_indices(host, dp.level_offsets, w, const, Ftot)
    want = tree_sweep.tree_sweep_plain(plan, *(torch.as_tensor(a) for a in (w, const, Ftot)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("mode", ["scalar", "edge", "cell"])
def test_permute_coefficient_equal(mode):
    rng = np.random.default_rng(1)
    N, E = 3, 7
    arr = {"scalar": np.array([2.0]), "edge": rng.random(E), "cell": rng.random(E * N)}[mode]
    order = rng.permutation(E)
    for eo in (None, order):
        assert np.array_equal(
            JS._permute_coefficient(arr, mode, N, eo), PB._permute_coefficient(arr, mode, N, eo)
        )


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_condensed_constants_equal(k):
    for a, b in zip(JS._condensed_scalar_constants(k), PB._condensed_scalar_constants(k)):
        assert np.array_equal(a, b)


def reference_state(asm) -> dict:
    """The port's interop state, read off a reference assembler."""
    mesh = asm.network
    R_mode, f_mode, _ = asm.coefficient_modes()
    R, f, sp, ep = asm.schur_arguments(device=False)
    return {
        "pos": mesh.vertices[: mesh.num_graph_nodes],
        "edges": mesh.edges,
        "radius": mesh.edge_radius,
        "N": mesh.N,
        "flux_degree": asm.flux_degree,
        "pressure_degree": asm.pressure_degree,
        "R_mode": R_mode,
        "R_data": R,
        "f_mode": f_mode,
        "f_data": f,
        "edge_start_pbc": sp,
        "edge_end_pbc": ep,
        "edge_color": mesh.edge_color,
    }


def test_interop_state_equals_compute_forms():
    rng = np.random.default_rng(6)
    G = J.network_generation.make_arterial_tree(5, direction=[0.1, 1, 0], arrays=True)
    mj = J.NetworkMesh(G, N=3, color_strategy="fast")
    R = 1.0 / mj.edge_radius**4
    f = rng.uniform(-1, 1, mj.num_cells)
    aj = J.HydraulicNetworkAssembler(mj, flux_degree=2)
    aj.compute_forms(p_bc_ex=lambda x: x[1], R=R, f=f)
    carried = interop.assembler_from_reference_state(reference_state(aj), color_strategy="fast")

    mp = P.NetworkMesh(P.ArrayNetwork(G.pos, G.edges, G.radius), N=3, color_strategy="fast")
    ap = P.HydraulicNetworkAssembler(mp, flux_degree=2)
    ap.compute_forms(p_bc_ex=lambda x: x[1], R=R, f=f)
    assert carried.coefficient_modes() == ap.coefficient_modes()
    for a, b in zip(carried.schur_arguments(), ap.schur_arguments()):
        assert np.array_equal(a, b)
    for attr in DOF_ATTRS:
        assert np.array_equal(getattr(carried, attr), getattr(ap, attr)), attr
    _assert_meshes_equal(mj, carried.network)
    x_carried = np.concatenate([fn.values for fn in P.Solver(carried, device="cpu").solve()])
    x_port = np.concatenate([fn.values for fn in P.Solver(ap, device="cpu").solve()])
    assert np.array_equal(x_carried, x_port)


def test_interop_rejects_bad_state():
    G = J.network_generation.make_tree(3, 1.0, 2.0, arrays=True)
    aj = J.HydraulicNetworkAssembler(J.NetworkMesh(G, N=2))
    aj.compute_forms(p_bc_ex=lambda x: x[1])
    state = reference_state(aj)
    with pytest.raises(ValueError, match="coloring"):
        interop.assembler_from_reference_state(state, color_strategy="fast")
    with pytest.raises(KeyError):
        interop.assembler_from_reference_state({k: state[k] for k in list(state)[:-3]})
    with pytest.raises(ValueError, match="entries"):
        interop.assembler_from_reference_state({**state, "R_mode": "edge"})


def test_timing_registry():
    from networks_fenicsx_tpu_torch.utils import timing

    timing.reset_timings()
    G = P.network_generation.make_tree(3, 1.0, 2.0, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(G, N=2))
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    P.Solver(asm, device="cpu").solve()
    for key in ("nxfx:make_tree", "nxfx:HydraulicNetworkAssembler:compute_forms",
                "nxfx:Solver:solve"):
        count, total = timing.timing(key)
        assert count == 1 and total.total_seconds() >= 0.0
    with timing.Timer("nxfx:test"):
        pass
    assert timing.list_timings()["nxfx:test"][0] == 1
