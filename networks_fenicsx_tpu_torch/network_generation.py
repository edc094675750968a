"""Generators for directed network graphs (:class:`networkx.DiGraph` or
:class:`ArrayNetwork`).

Counterpart of ``networks_fenicsx_tpu/network_generation.py``, host NumPy
with identical numbering and geometry.  ``networkx`` is imported only where
a DiGraph is built, so ``arrays=True`` needs neither networkx nor JAX.

Capability match for the reference generators
(``src/networks_fenicsx/network_generation.py``):

* :func:`make_tree` — symmetric binary tree rooted at the origin
  (reference ``network_generation.py:42-100``), byte-identical node layout.
* :func:`make_arterial_tree` — Murray's-law arterial tree with
  radius-dependent daughter diameters, minimum-energy bifurcation angles and
  Rodrigues-rotation geometry (reference ``network_generation.py:158-283``).

Graphs carry a ``pos`` attribute per node (2D or 3D coordinates) and, for
arterial trees, a ``radius`` attribute per edge.  All geometry is computed
with vectorized NumPy on the host; the graphs feed
:class:`networks_fenicsx_tpu_torch.NetworkMesh`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import numpy.typing as npt

from .mesh import ArrayNetwork
from .utils.timing import timed

__all__ = [
    "ArrayNetwork",
    "make_tree",
    "make_arterial_tree",
    "make_grid",
    "make_random_network",
    "make_vascular_bed",
]


def _binary_tree_edges(num_nodes: int) -> np.ndarray:
    """Edge list of the rooted binary tree in BFS numbering.

    Node 0 is a stem node with the single child 1; node 1 is the first
    branching node.  For ``i >= 2`` the parent of node ``i`` is ``i // 2``
    (heap numbering), which reproduces the reference's BFS generator
    (``network_generation.py:18-37``) for branching ratio 2.
    """
    if num_nodes < 2:
        return np.empty((0, 2), dtype=np.int64)
    child = np.arange(2, num_nodes, dtype=np.int64)
    edges = np.concatenate(
        [np.array([[0, 1]], dtype=np.int64), np.stack([child // 2, child], axis=1)]
    )
    return edges


@timed("nxfx:make_tree")
def make_tree(
    n: int, H: float, W: float, dim: int = 3, arrays: bool = False
) -> nx.DiGraph | ArrayNetwork:
    """Generate a symmetric binary tree rooted at the origin.

    Layout matches the reference (``network_generation.py:42-100``): the root
    edge runs from ``(0, 0)`` to ``(0, H/n)``; generation ``g`` (1-based) sits
    at height ``(g + 1) * H / n`` with ``2**g`` nodes placed symmetrically
    about ``x = 0`` at a pitch determined by ``W``.

    Args:
        n: Number of generations of branches (``n >= 1``).
        H: Height of the tree.
        W: Width of the tree at its largest extent.
        dim: Geometric dimension of the node coordinates (2 or 3).
        arrays: Return an :class:`ArrayNetwork` instead of a DiGraph —
            identical numbering/geometry, no Python-object cost (a 2^20-edge
            DiGraph costs ~35 s to build; the arrays are free).
    """
    if n < 1:
        raise ValueError("Number of generations must be at least 1")
    if dim not in (2, 3):
        raise ValueError("dim must be 2 or 3")

    num_nodes = 2**n  # 1 + sum_{g<n} 2**g
    num_leaves = 2 ** (n - 1)
    y_pitch = H / n

    coords = np.zeros((num_nodes, dim), dtype=np.float64)
    coords[1, 1] = y_pitch

    if n > 1:
        x_pitch = W / (2 * (num_leaves - 1))
        node = 2
        for gen in range(1, n):
            spread = x_pitch * 2 ** (n - gen)
            half = 2 ** (gen - 1)
            xs = spread * (np.arange(half) + 0.5)
            xs = np.sort(np.concatenate([-xs, xs]))
            count = xs.size
            coords[node : node + count, 0] = xs
            coords[node : node + count, 1] = y_pitch * (gen + 1)
            node += count

    if arrays:
        return ArrayNetwork(pos=coords, edges=_binary_tree_edges(num_nodes))
    import networkx as nx

    G = nx.DiGraph()
    G.add_nodes_from(range(num_nodes))
    for i in range(num_nodes):
        G.nodes[i]["pos"] = coords[i].tolist() if dim == 2 else list(coords[i])
    G.add_edges_from(map(tuple, _binary_tree_edges(num_nodes)))
    return G


def _lattice_edges(nx_cells: int, ny_cells: int) -> np.ndarray:
    """Interior lattice edges (right then up per node, row-major order).

    The single shared implementation of the rectangular-lattice edge
    contract — node numbering parity between ``make_grid`` and
    ``make_vascular_bed`` (and their DiGraph twins) lives HERE."""
    k = np.arange(nx_cells * ny_cells, dtype=np.int64)
    i, j = k % nx_cells, k // nx_cells
    cand = np.stack(
        [np.stack([k, k + 1], axis=1), np.stack([k, k + nx_cells], axis=1)],
        axis=1,
    ).reshape(-1, 2)
    valid = np.stack([i + 1 < nx_cells, j + 1 < ny_cells], axis=1).reshape(-1)
    return cand[valid]


@timed("nxfx:make_grid")
def make_grid(
    nx_cells: int, ny_cells: int, W: float = 1.0, H: float = 1.0, arrays: bool = False
) -> nx.DiGraph | ArrayNetwork:
    """Rectangular lattice network with one inlet and one outlet stub.

    A fully cyclic topology (capillary-mesh style) complementing the
    reference's tree generators: every interior node is a junction with
    loops, exercising the cycle-core direct solver and iterative paths.
    Edges are directed rightward and upward; an inlet stub feeds the
    bottom-left corner and an outlet stub drains the top-right one.

    Args:
        nx_cells, ny_cells: Lattice dimensions (number of nodes per side).
        W, H: Physical extent.
    """
    if nx_cells < 2 or ny_cells < 2:
        raise ValueError("grid needs at least 2 nodes per side")
    dx = W / (nx_cells - 1)
    dy = H / (ny_cells - 1)

    if arrays:
        # Identical node numbering (row-major) and edge order (per node in
        # row-major order: right edge then up edge) as the DiGraph path.
        grid_edges = _lattice_edges(nx_cells, ny_cells)
        k = np.arange(nx_cells * ny_cells, dtype=np.int64)
        i, j = k % nx_cells, k // nx_cells
        inlet = nx_cells * ny_cells
        outlet = inlet + 1
        # DiGraph.edges() iterates grouped by source-node id: the outlet
        # stub (source = last core node) precedes the inlet stub.
        edges = np.concatenate(
            [
                grid_edges,
                np.array(
                    [[nx_cells * ny_cells - 1, outlet], [inlet, 0]], dtype=np.int64
                ),
            ]
        )
        pos = np.concatenate(
            [
                np.stack([i * dx, j * dy], axis=1),
                np.array([[-dx, 0.0], [W + dx, H]]),
            ]
        )
        return ArrayNetwork(pos=pos, edges=edges)

    import networkx as nx

    G = nx.DiGraph()

    def nid(i: int, j: int) -> int:
        return j * nx_cells + i

    for j in range(ny_cells):
        for i in range(nx_cells):
            G.add_node(nid(i, j), pos=np.array([i * dx, j * dy]))
    for j in range(ny_cells):
        for i in range(nx_cells):
            if i + 1 < nx_cells:
                G.add_edge(nid(i, j), nid(i + 1, j))
            if j + 1 < ny_cells:
                G.add_edge(nid(i, j), nid(i, j + 1))
    inlet = nx_cells * ny_cells
    outlet = inlet + 1
    G.add_node(inlet, pos=np.array([-dx, 0.0]))
    G.add_node(outlet, pos=np.array([W + dx, H]))
    G.add_edge(inlet, nid(0, 0))
    G.add_edge(nid(nx_cells - 1, ny_cells - 1), outlet)
    return G


def _default_normal(x: npt.NDArray[np.floating]) -> npt.NDArray[np.floating]:
    """Plane normal field for the xy-plane (constant z-hat)."""
    out = np.zeros_like(x)
    out[2] = 1.0
    return out


def _rodrigues(vec: np.ndarray, axis: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate ``vec`` about ``axis`` by ``angle_deg`` degrees (Rodrigues formula)."""
    theta = np.radians(angle_deg)
    k = axis / np.linalg.norm(axis)
    cross = np.cross(k, vec)
    return (
        vec * np.cos(theta)
        + cross * np.sin(theta)
        + k * np.dot(k, vec) * (1.0 - np.cos(theta))
    )


def _branch_endpoint(
    parent_start: np.ndarray,
    parent_end: np.ndarray,
    plane_normal: np.ndarray,
    angle_deg: float,
    length: float,
) -> np.ndarray:
    """Endpoint of a daughter vessel branching off ``parent_end``.

    The parent direction is projected into the plane with normal
    ``plane_normal``, rotated in-plane by ``angle_deg`` and scaled to
    ``length`` (reference ``network_generation.py:110-154``).
    """
    direction = parent_end - parent_start
    n_unit = plane_normal / np.linalg.norm(plane_normal)
    in_plane = direction - np.dot(direction, n_unit) * n_unit
    rotated = _rodrigues(in_plane, plane_normal, angle_deg)
    return parent_end + length * rotated / np.linalg.norm(rotated)


def _make_arterial_tree_vectorized(
    N: int,
    p0: np.ndarray,
    direction: np.ndarray,
    D0: float,
    lmbda: float,
    gamma: float,
    arrays: bool = False,
) -> nx.DiGraph | ArrayNetwork:
    """Generation-batched arterial tree for the default (deterministic,
    xy-plane-normal) configuration: the per-vessel Python loop becomes a
    handful of array ops per generation (65k-vessel trees build in well
    under a second instead of ~15 s)."""
    z = np.array([0.0, 0.0, 1.0])
    p1 = p0 + D0 * lmbda * direction / np.linalg.norm(direction)

    pos_chunks = [np.stack([p0, p1])]
    edge_chunks = [np.array([[0, 1]], dtype=np.int64)]
    radii_chunks = [np.array([D0 / 2])]

    starts = p0[None, :]
    ends = p1[None, :]
    Dp = np.array([D0])
    parent_tip = np.array([1])  # node id of each frontier vessel's end
    next_node = 2
    for _ in range(1, N):
        D2 = Dp * (gamma**3 + 1.0) ** (-1.0 / 3.0)
        D1 = gamma * D2

        def _angle(Dd):
            cos_a = (Dp**4 + Dd**4 - (Dp**3 - Dd**3) ** (4.0 / 3.0)) / (
                2.0 * Dp**2 * Dd**2
            )
            return np.degrees(np.arccos(cos_a))

        angle1, angle2 = _angle(D1), _angle(D2)
        vec = ends - starts
        in_plane = vec - vec[:, 2:3] * z[None, :]  # project onto z-normal plane

        def _rot(v, deg):
            th = np.radians(deg)[:, None]
            cross = np.cross(np.broadcast_to(z, v.shape), v)
            kdotv = v[:, 2:3]  # (k·v) with k = z
            return v * np.cos(th) + cross * np.sin(th) + z[None, :] * kdotv * (
                1.0 - np.cos(th)
            )

        M = Dp.shape[0]
        tips = []
        for sign, angle, Dd in ((+1, angle1, D1), (-1, angle2, D2)):
            newdir = _rot(in_plane, sign * angle)
            newdir /= np.linalg.norm(newdir, axis=1, keepdims=True)
            tips.append(ends + (lmbda * Dd)[:, None] * newdir)

        # interleave children in reference order: per parent, daughter1 then
        # daughter2 — all array ops (the per-parent Python loop was itself a
        # scaling bottleneck at deep generations)
        child_nodes = next_node + np.arange(2 * M, dtype=np.int64)
        new_pos = np.stack([tips[0], tips[1]], axis=1).reshape(2 * M, 3)
        pos_chunks.append(new_pos)
        edge_chunks.append(
            np.stack([np.repeat(parent_tip, 2), child_nodes], axis=1)
        )
        radii_chunks.append(np.stack([D1, D2], axis=1).reshape(2 * M) / 2.0)
        starts = np.repeat(ends, 2, axis=0)
        ends = new_pos
        Dp = np.stack([D1, D2], axis=1).reshape(2 * M)
        parent_tip = child_nodes
        next_node += 2 * M

    pos = np.concatenate(pos_chunks)
    edges = np.concatenate(edge_chunks)
    radii = np.concatenate(radii_chunks)
    if arrays:
        return ArrayNetwork(pos=pos, edges=edges, radius=radii)
    import networkx as nx

    G = nx.DiGraph()
    G.add_nodes_from((i, {"pos": p}) for i, p in enumerate(pos))
    G.add_edges_from(
        (int(u), int(v), {"radius": float(r)}) for (u, v), r in zip(edges, radii)
    )
    return G


@timed("nxfx:make_arterial_tree")
def make_arterial_tree(
    N: int,
    p0: npt.NDArray[np.floating] | None = None,
    direction: npt.NDArray[np.floating] | None = None,
    D0: float = 2.0,
    lmbda: float = 8.0,
    gamma: float = 0.8,
    normal: Callable[[npt.NDArray[np.floating]], npt.NDArray[np.floating]] = _default_normal,
    random: bool = False,
    seed: int | None = None,
    arrays: bool = False,
) -> nx.DiGraph | ArrayNetwork:
    """Create an arterial tree following Murray's law.

    Daughter diameters satisfy ``D0**3 = D1**3 + D2**3`` with ratio
    ``D1/D2 = gamma``, giving ``D2 = D0 * (gamma**3 + 1)**(-1/3)`` and
    ``D1 = gamma * D2``.  Segment length is proportional to diameter,
    ``L = lmbda * d``.  Bifurcation angles follow the minimum-energy
    hypothesis: ``cos(a_i) = (D0^4 + Di^4 - (D0^3 - Di^3)^(4/3)) /
    (2 D0^2 Di^2)``.  Geometry matches the reference
    (``network_generation.py:158-283``, itself derived from A. Vallet's
    NetworkGen).

    Args:
        N: Number of generations of vessels.
        p0: Origin location (default: zeros(3)).
        direction: Initial vessel direction (default: +y).
        D0: Root vessel diameter.
        lmbda: Length/diameter ratio for every vessel.
        gamma: Daughter diameter ratio (``<= 1``).
        normal: Callable giving the local branching-plane normal at a point.
        random: If True, randomly choose which daughter branches left/right;
            if False the larger daughter always takes the second slot.
        seed: Optional RNG seed used when ``random=True`` (extension over the
            reference for reproducible trees).
        arrays: Return an :class:`ArrayNetwork` instead of a DiGraph
            (deterministic default-normal configuration only) — identical
            numbering/geometry with no Python-object cost.
    """
    if gamma > 1:
        raise ValueError("Please choose a gamma lower or equal to 1")
    p0 = np.zeros(3, dtype=np.float64) if p0 is None else np.asarray(p0, dtype=np.float64)
    if direction is None:
        direction = np.array([0.0, 1.0, 0.0])
    direction = np.asarray(direction, dtype=np.float64)
    rng = np.random.default_rng(seed) if seed is not None else None

    if not random and normal is _default_normal:
        return _make_arterial_tree_vectorized(
            N, p0, direction, D0, lmbda, gamma, arrays=arrays
        )
    if arrays:
        raise ValueError(
            "arrays=True requires the deterministic default-normal "
            "configuration (random=False, normal=_default_normal)"
        )
    import networkx as nx

    G = nx.DiGraph()
    root_len = D0 * lmbda
    p1 = p0 + root_len * direction / np.linalg.norm(direction)
    G.add_node(0, pos=p0)
    G.add_node(1, pos=p1)
    G.add_edge(0, 1, radius=D0 / 2)

    frontier = [(0, 1)]
    next_node = 2
    for _ in range(1, N):
        new_frontier = []
        for (u, v) in frontier:
            start = np.asarray(G.nodes[u]["pos"], dtype=np.float64)
            end = np.asarray(G.nodes[v]["pos"], dtype=np.float64)
            Dp = 2.0 * G.edges[u, v]["radius"]

            D2 = Dp * (gamma**3 + 1.0) ** (-1.0 / 3.0)
            D1 = gamma * D2
            L1, L2 = lmbda * D1, lmbda * D2

            def _angle(Dd: float) -> float:
                cos_a = (Dp**4 + Dd**4 - (Dp**3 - Dd**3) ** (4.0 / 3.0)) / (
                    2.0 * Dp**2 * Dd**2
                )
                return float(np.degrees(np.arccos(cos_a)))

            angle1, angle2 = _angle(D1), _angle(D2)
            if random:
                sign1 = (
                    int(rng.choice([-1, 1])) if rng is not None else int(np.random.choice([-1, 1]))
                )
            else:
                sign1 = 1
            plane_n = normal(end)

            for angle, length, diameter in (
                (sign1 * angle1, L1, D1),
                (-sign1 * angle2, L2, D2),
            ):
                tip = _branch_endpoint(start, end, plane_n, angle, length)
                G.add_node(next_node, pos=tip)
                G.add_edge(v, next_node, radius=diameter / 2)
                new_frontier.append((v, next_node))
                next_node += 1
        frontier = new_frontier
    return G


def make_random_network(
    num_nodes: int,
    keep: float = 0.7,
    W: float = 1.0,
    H: float = 1.0,
    num_boundary: int = 2,
    seed: int | None = None,
    arrays: bool = False,
) -> "nx.DiGraph | ArrayNetwork":
    """Random unstructured capillary web (Delaunay mesh of random points).

    An irregular fully-cyclic topology class the reference's generators
    cannot produce (its trees are the only family,
    the reference's ``network_generation.py:42,158``):
    random sites are triangulated, a random fraction of edges beyond a
    connectivity-preserving spanning tree is kept, and ``num_boundary``
    stubs are attached to the hull so the system is well-posed.  This is
    the adversarial test family for the sparse cycle-core elimination
    (``ops/core_elim.py``) — junction degrees are irregular, cycles are
    everywhere, and no lattice/forest structure exists.

    Args:
        num_nodes: Number of interior junction sites.
        keep: Fraction of non-spanning-tree edges to keep (1.0 = full
            triangulation; lower values thin the web while staying
            connected).
        W, H: Physical extent of the site rectangle.
        num_boundary: Number of boundary stubs attached to hull nodes
            (alternating inlet/outlet pressure roles is up to ``p_bc``).
        seed: RNG seed.
        arrays: Return an :class:`ArrayNetwork` instead of a DiGraph.
    """
    if num_nodes < 4:
        raise ValueError("random network needs at least 4 sites")
    if not 0.0 <= keep <= 1.0:
        raise ValueError("keep must be in [0, 1]")
    import scipy.sparse as _sp
    from scipy.sparse.csgraph import minimum_spanning_tree as _mst
    from scipy.spatial import Delaunay as _Delaunay

    rng = np.random.default_rng(seed)
    pts = np.column_stack(
        [rng.uniform(0.0, W, num_nodes), rng.uniform(0.0, H, num_nodes)]
    )
    tri = _Delaunay(pts)
    s = tri.simplices
    cand = np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [0, 2]]])
    cand = np.unique(np.sort(cand, axis=1), axis=0)

    # spanning tree keeps the web connected; a random subset of the rest
    wts = rng.uniform(0.1, 1.0, cand.shape[0])
    mst = _mst(
        _sp.coo_matrix(
            (wts, (cand[:, 0], cand[:, 1])), shape=(num_nodes, num_nodes)
        )
    ).tocoo()
    in_tree = set(zip(mst.row.tolist(), mst.col.tolist()))
    in_tree |= {(b, a) for a, b in in_tree}
    sel = np.array(
        [
            (int(u), int(v)) in in_tree or rng.random() < keep
            for u, v in cand
        ]
    )
    edges = cand[sel]

    # boundary stubs on hull nodes, spread around the hull
    hull = np.unique(tri.convex_hull.reshape(-1))
    nb = max(1, min(num_boundary, hull.size))
    picks = hull[np.linspace(0, hull.size - 1, nb).astype(np.int64)]
    centre = pts.mean(axis=0)
    stub_pos = []
    stub_edges = []
    for t, hn in enumerate(picks):
        out = pts[hn] - centre
        nrm = np.linalg.norm(out)
        out = out / nrm if nrm > 0 else np.array([1.0, 0.0])
        stub_id = num_nodes + t
        stub_pos.append(pts[hn] + out * 0.1 * max(W, H))
        # alternate orientation so both inlet- and outlet-style stubs exist
        stub_edges.append(
            (stub_id, int(hn)) if t % 2 == 0 else (int(hn), stub_id)
        )
    all_pos = np.concatenate([pts, np.asarray(stub_pos)], axis=0)
    all_edges = np.concatenate(
        [edges, np.asarray(stub_edges, dtype=np.int64)], axis=0
    )

    if arrays:
        return ArrayNetwork(pos=all_pos, edges=all_edges.astype(np.int64))
    import networkx as nx

    G = nx.DiGraph()
    for i in range(all_pos.shape[0]):
        G.add_node(i, pos=all_pos[i])
    for u, v in all_edges:
        G.add_edge(int(u), int(v))
    return G


def make_vascular_bed(
    n_gen: int,
    nx_cells: int,
    ny_cells: int,
    W: float = 1.0,
    H: float = 1.0,
    tree_height: float | None = None,
    r_capillary: float = 0.05,
    r_terminal: float | None = None,
    arrays: bool = False,
) -> "nx.DiGraph | ArrayNetwork":
    """Arterio-venous perfusion unit: supply tree → capillary bed → drain.

    The physiological flagship composite the reference cannot generate
    (its generators are tree-only,
    the reference's ``network_generation.py:42,158``):
    a binary arterial tree with Murray's-law radii feeds ``2**n_gen``
    evenly-spaced columns of the top row of an ``nx_cells × ny_cells``
    capillary lattice; a mirrored venous tree drains the bottom row.  The
    single arterial inlet and venous outlet are the only boundary nodes —
    every multiplier sits on a cycle through the bed, so the solve
    exercises the peel-then-core machinery end-to-end (the min-degree
    sparse core elimination absorbs tree and lattice jointly).

    Murray's law at every (symmetric) bifurcation: the parent edge radius
    is ``(r₁³ + r₂³)^{1/3} = 2^{1/3} r`` — the same deposition law as
    :func:`make_arterial_tree` (reference ``network_generation.py:236-238``).
    Every edge carries a ``radius`` attribute so Poiseuille resistance
    ``R ∝ 1/r⁴`` applies uniformly.

    Args:
        n_gen: Arterial generations; the tree ends in ``2**n_gen``
            terminal arterioles (must not exceed ``nx_cells``).
        nx_cells, ny_cells: Capillary lattice dimensions (nodes per side).
        W, H: Physical extent of the lattice.
        tree_height: Vertical extent of each tree (default ``H / 2``).
        r_capillary: Capillary edge radius.
        r_terminal: Terminal arteriole/venule radius (default
            ``1.5 * r_capillary``).
        arrays: Return an :class:`ArrayNetwork` (identical numbering).
    """
    if n_gen < 1:
        raise ValueError("n_gen must be >= 1")
    if nx_cells < 2 or ny_cells < 2:
        raise ValueError("capillary bed needs at least 2 nodes per side")
    L = 2**n_gen
    if L > nx_cells:
        raise ValueError(
            f"2**n_gen = {L} terminal vessels exceed nx_cells = {nx_cells}"
        )
    # L <= nx_cells means the linspace spacing is >= 1, so rounding keeps
    # the attachment columns strictly increasing (always distinct).
    cols = np.round(np.linspace(0, nx_cells - 1, L)).astype(np.int64)
    dx = W / (nx_cells - 1)
    dy = H / (ny_cells - 1)
    dz = (tree_height if tree_height is not None else H / 2.0) / (n_gen + 1)
    r_term = 1.5 * r_capillary if r_terminal is None else r_terminal

    # --- capillary lattice (row-major numbering, right/up edges) --------
    nG = nx_cells * ny_cells
    k = np.arange(nG, dtype=np.int64)
    gi, gj = k % nx_cells, k // nx_cells
    grid_edges = _lattice_edges(nx_cells, ny_cells)
    grid_pos = np.stack([gi * dx, gj * dy], axis=1)

    # --- tree node x-positions, bottom-up (level n_gen-1 .. 0) ----------
    # level k holds 2**k internal nodes; leaf EDGES (no leaf nodes) land
    # directly on the lattice columns.
    x_levels: list[np.ndarray] = [None] * n_gen  # type: ignore[list-item]
    child_x = cols * dx
    for lvl in range(n_gen - 1, -1, -1):
        child_x = 0.5 * (child_x[0::2] + child_x[1::2])
        x_levels[lvl] = child_x

    def level_base(base: int, lvl: int) -> int:
        return base + (2**lvl - 1)

    art_base = nG
    inlet = art_base + (L - 1)
    ven_base = inlet + 1
    outlet = ven_base + (L - 1)

    pos_parts = [grid_pos]
    for lvl in range(n_gen):  # arterial internal nodes, root-first
        y = H + (n_gen + 1 - lvl) * dz
        pos_parts.append(np.stack([x_levels[lvl], np.full(2**lvl, y)], axis=1))
    pos_parts.append(np.array([[x_levels[0][0], H + (n_gen + 2) * dz]]))  # inlet
    for lvl in range(n_gen):  # venous (mirror: y -> -(y - H))
        y = -(n_gen + 1 - lvl) * dz
        pos_parts.append(np.stack([x_levels[lvl], np.full(2**lvl, y)], axis=1))
    pos_parts.append(np.array([[x_levels[0][0], -(n_gen + 2) * dz]]))  # outlet
    pos = np.concatenate(pos_parts, axis=0)

    def murray(lvl: int) -> float:
        # radius of an edge ENTERING a level-``lvl`` node (lvl = n_gen
        # means a terminal edge into the lattice)
        return r_term * 2.0 ** ((n_gen - lvl) / 3.0)

    edges: list[tuple[int, int]] = [tuple(e) for e in grid_edges]
    radii: list[float] = [r_capillary] * len(edges)

    # arterial: inlet trunk, internal parent->child, terminal edges
    edges.append((inlet, level_base(art_base, 0)))
    radii.append(murray(0))
    for lvl in range(1, n_gen):
        pb, cb = level_base(art_base, lvl - 1), level_base(art_base, lvl)
        for i in range(2**lvl):
            edges.append((pb + i // 2, cb + i))
            radii.append(murray(lvl))
    top_row = (ny_cells - 1) * nx_cells + cols
    lb = level_base(art_base, n_gen - 1)
    for i in range(L):
        edges.append((lb + i // 2, int(top_row[i])))
        radii.append(murray(n_gen))

    # venous: terminal edges (bottom row -> venule), child->parent, outlet
    vb = level_base(ven_base, n_gen - 1)
    for i in range(L):
        edges.append((int(cols[i]), vb + i // 2))
        radii.append(murray(n_gen))
    for lvl in range(n_gen - 1, 0, -1):
        pb, cb = level_base(ven_base, lvl - 1), level_base(ven_base, lvl)
        for i in range(2**lvl):
            edges.append((cb + i, pb + i // 2))
            radii.append(murray(lvl))
    edges.append((level_base(ven_base, 0), outlet))
    radii.append(murray(0))

    # Stable-sort by source node: nx.DiGraph.edges() iterates grouped by
    # node insertion order, so this makes the ``arrays=True`` edge order
    # IDENTICAL to the DiGraph path (the venous terminal edges — sourced
    # at bottom-row lattice nodes — interleave with that node's lattice
    # edges under both representations).
    e_arr = np.asarray(edges, dtype=np.int64)
    r_arr = np.asarray(radii, dtype=np.float64)
    order = np.argsort(e_arr[:, 0], kind="stable")
    net = ArrayNetwork(pos=pos, edges=e_arr[order], radius=r_arr[order])
    return net if arrays else net.to_networkx()
