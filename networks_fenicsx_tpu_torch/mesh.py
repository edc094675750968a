"""Graph → array-native network mesh (host NumPy).

Counterpart of ``networks_fenicsx_tpu/mesh.py``; the arrays it builds are
identical, so both packages solve from the same mesh.  Differences: edge
coloring with ``color_strategy="fast"`` always runs the Python bitmask sweep
(the reference takes its native C++ build when one exists — the two give
equal colorings), and ``networkx`` is imported only inside the DiGraph
branches, so ``ArrayNetwork`` inputs need neither networkx nor JAX.

Replacement for the reference mesh layer
(``src/networks_fenicsx/mesh.py``): where the reference converts a
:class:`networkx.DiGraph` into a distributed DOLFINx mesh with per-color
C++ submesh objects, entity maps and MeshTags (reference ``mesh.py:45-538``),
this module builds one flat set of NumPy integer and float arrays:

* ``vertices``        — ``(Vm, gdim)`` float64 coordinates,
* ``cells``           — ``(C, 2)`` int32 vertex pairs (sorted ascending),
* ``cell_color``      — ``(C,)`` int32 edge-color per cell
  (replaces the subdomain MeshTags, reference ``mesh.py:354-363``),
* ``orientation``     — ``(C,)`` float64 ``±1`` relating stored cell order to
  the directed-graph edge direction (replaces the DG-0 orientation Function
  and its post-partition sign correction, reference ``mesh.py:321-322,374-400``),
* ``vertex_markers``  — graph-node ids with boundary in/out sentinels
  (replaces the facet MeshTags, reference ``mesh.py:402-420``),
* per-bifurcation in/out edge/color CSR adjacency
  (reference ``mesh.py:189-209,258-263``).

"Submeshes" are index-set views (:class:`SubmeshView`), not separate mesh
objects.

The ``comm``/``graph_rank`` arguments are retained for API familiarity but
ignored: one process builds the (small) graph metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import numpy.typing as npt

from .utils.timing import timed

__all__ = [
    "ArrayNetwork",
    "NetworkMesh",
    "color_graph",
    "fast_greedy_edge_coloring",
    "SubmeshView",
    "MeshTags",
]


@dataclasses.dataclass(frozen=True)
class ArrayNetwork:
    """Array-native network description accepted by :class:`NetworkMesh`.

    The array-native alternative to ``networkx.DiGraph`` for large generated
    networks: building a 1M-edge DiGraph costs ~35 s of Python object
    overhead (per-node attribute dicts, per-edge tuples) while the mesh
    layer immediately converts everything back to flat arrays.  Generators
    produce this directly with ``arrays=True``.

    Attributes:
        pos: ``(V, gdim)`` float64 node coordinates; node ids are the row
            indices (contiguous by construction).
        edges: ``(E, 2)`` integer directed edges ``(u, v)``.
        radius: Optional ``(E,)`` per-edge radius (arterial trees).
    """

    pos: npt.NDArray[np.float64]
    edges: npt.NDArray[np.int64]
    radius: npt.NDArray[np.float64] | None = None

    def number_of_nodes(self) -> int:
        return int(np.asarray(self.pos).shape[0])

    def number_of_edges(self) -> int:
        return int(np.asarray(self.edges).shape[0])

    def to_networkx(self) -> nx.DiGraph:
        """Materialise the equivalent ``networkx.DiGraph`` (slow at scale)."""
        import networkx as nx

        G = nx.DiGraph()
        pos = np.asarray(self.pos, dtype=np.float64)
        G.add_nodes_from((i, {"pos": pos[i].tolist()}) for i in range(pos.shape[0]))
        if self.radius is not None:
            G.add_edges_from(
                (int(u), int(v), {"radius": float(r)})
                for (u, v), r in zip(np.asarray(self.edges), np.asarray(self.radius))
            )
        else:
            G.add_edges_from((int(u), int(v)) for u, v in np.asarray(self.edges))
        return G


@dataclasses.dataclass(frozen=True)
class MeshTags:
    """Minimal (indices, values) tag pair mirroring ``dolfinx.mesh.MeshTags``."""

    indices: npt.NDArray[np.int32]
    values: npt.NDArray[np.int32]
    name: str = ""


def _greedy_color_edge_array(edges: np.ndarray) -> np.ndarray:
    """Bitmask greedy sweep over an (E, 2) edge array: each edge gets the
    smallest color absent at both endpoints (single shared implementation
    for the DiGraph and ArrayNetwork paths)."""
    used: dict[int, int] = {}
    out = np.empty(edges.shape[0], dtype=np.int32)
    for i in range(edges.shape[0]):
        u, v = int(edges[i, 0]), int(edges[i, 1])
        mask = used.get(u, 0) | used.get(v, 0)
        # Lowest unset bit of the combined mask.
        color = (~mask & (mask + 1)).bit_length() - 1
        bit = 1 << color
        used[u] = used.get(u, 0) | bit
        used[v] = used.get(v, 0) | bit
        out[i] = color
    return out


def fast_greedy_edge_coloring(graph: nx.DiGraph, order: np.ndarray | None = None) -> dict:
    """Greedy proper edge coloring without materializing the line graph.

    The reference colors edges via ``nx.line_graph`` + ``greedy_color``
    (reference ``mesh.py:29-42``), which builds an explicit line graph — a
    scaling bottleneck of the BuildMesh phase at ~65k edges.  Adjacent
    edges (sharing a node) never share a color, which is the property the
    assembler relies on (see :func:`_greedy_color_edge_array`).
    """
    edges = np.asarray(list(graph.edges()), dtype=np.int64).reshape(-1, 2)
    idx = np.arange(edges.shape[0]) if order is None else np.asarray(list(order))
    colors = _greedy_color_edge_array(edges[idx])
    return {
        (int(edges[i, 0]), int(edges[i, 1])): int(colors[j])
        for j, i in enumerate(idx)
    }


@timed("nxfx:color_graph")
def color_graph(
    graph: nx.DiGraph,
    strategy: str | Callable[[nx.Graph, dict], Iterable[int]] | None,
) -> dict:
    """Color the edges of a directed graph.

    Mirrors the reference (``mesh.py:29-42``): ``strategy=None`` assigns one
    color per edge ("no coloring", not recommended — it makes one flux block
    per edge); a networkx greedy strategy name/callable colors the line graph
    so that edges sharing a node get different colors.  The extra strategy
    ``"fast"`` selects :func:`fast_greedy_edge_coloring`, which produces a
    valid coloring orders of magnitude faster on large networks.
    """
    if strategy is None:
        return {edge: i for i, edge in enumerate(graph.edges)}
    if strategy == "fast":
        return fast_greedy_edge_coloring(graph)
    import networkx as nx

    line = nx.line_graph(graph.to_undirected())
    return nx.coloring.greedy_color(line, strategy=strategy)


@dataclasses.dataclass(frozen=True)
class SubmeshView:
    """Index-set view of one edge-color class of the network mesh.

    Replaces the reference's per-color ``dolfinx.mesh.create_submesh`` objects
    and EntityMaps (reference ``mesh.py:425-460``): ``cell_indices`` maps
    submesh cell i → parent cell (the entity map), ``vertex_indices`` maps
    submesh vertex → parent vertex, and ``facet_markers`` carries the
    inherited vertex markers (reference ``mesh.py:447-459``).
    """

    color: int
    cell_indices: npt.NDArray[np.int32]  # sub cell -> parent cell
    vertex_indices: npt.NDArray[np.int32]  # sub vertex -> parent vertex
    cells: npt.NDArray[np.int32]  # (Csub, 2) in submesh vertex numbering
    facet_markers: MeshTags  # inherited vertex markers (sub vertex indices)
    edge_ids: npt.NDArray[np.int32]  # graph edges composing this color

    @property
    def num_cells(self) -> int:
        return int(self.cell_indices.size)

    @property
    def num_vertices(self) -> int:
        return int(self.vertex_indices.size)

    def sub_to_parent_cells(self, entities: npt.NDArray[np.int32]) -> npt.NDArray[np.int32]:
        """EntityMap.sub_topology_to_topology equivalent (cells)."""
        return self.cell_indices[entities]


class NetworkMesh:
    """Array-native representation of a directed network as a 1D FE mesh.

    Public surface mirrors the reference class (``mesh.py:45-538``):
    ``bifurcation_values``, ``boundary_values``, ``in_edges``/``out_edges``,
    ``num_edge_colors``, ``in_marker``/``out_marker``, ``orientation``,
    ``subdomains``, ``boundaries``, ``submeshes``.

    Construction is fully vectorized host NumPy (the reference's pure-Python
    per-edge subdivision loop, ``mesh.py:275-316``, is the BuildMesh hot
    spot); every per-edge quantity is laid out edge-major with a uniform
    ``N`` cells per edge, so the assembler can reshape to ``(E, N)`` blocks
    and the solver can shard the edge axis across devices.

    Args:
        graph: Directed graph with per-node ``pos`` attributes (node ids must
            be ``0..V-1``) and optional per-edge ``radius`` attributes.
        N: Number of elements (cells) per edge segment.
        color_strategy: ``None`` (one color per edge), a networkx greedy
            strategy name/callable, or ``"fast"``.
        comm, graph_rank: Accepted for API parity with the MPI reference;
            ignored.
    """

    def __init__(
        self,
        graph: nx.DiGraph,
        N: int,
        color_strategy: str | Callable | None = None,
        comm: Any = None,
        graph_rank: int = 0,
    ):
        del comm, graph_rank  # one process: no MPI metadata broadcast
        if N < 1:
            raise ValueError("N (elements per segment) must be >= 1")
        self._N = int(N)
        self._build_mesh(graph, color_strategy)
        self._build_network_submeshes()
        self._create_lm_view()

    # ------------------------------------------------------------------ build
    @staticmethod
    def _color_edge_array(
        graph, edges: np.ndarray, V: int, color_strategy
    ) -> np.ndarray:
        """Edge colors as an (E,) array from array inputs.

        ``"fast"`` runs the Python bitmask sweep
        (:func:`_greedy_color_edge_array`); ``None`` is one color per edge
        (reference semantics);
        networkx strategies fall back to the line-graph path (materialising
        a DiGraph first for :class:`ArrayNetwork` inputs — slow at scale).
        """
        E = edges.shape[0]
        if color_strategy is None:
            return np.arange(E, dtype=np.int32)
        if color_strategy == "fast":
            return _greedy_color_edge_array(edges)
        if isinstance(graph, ArrayNetwork):
            graph = graph.to_networkx()
        coloring = color_graph(graph, color_strategy)
        return np.asarray(
            [
                coloring.get((int(u), int(v)), coloring.get((int(v), int(u))))
                for u, v in edges
            ],
            dtype=np.int32,
        )

    @timed("nxfx:NetworkMesh:build_mesh")
    def _build_mesh(self, graph, color_strategy) -> None:
        N = self._N
        if isinstance(graph, ArrayNetwork):
            node_coords = np.asarray(graph.pos, dtype=np.float64)
            edges = np.asarray(graph.edges, dtype=np.int64)
            if node_coords.ndim != 2:
                raise ValueError("ArrayNetwork.pos must have shape (V, gdim)")
            if edges.ndim != 2 or edges.shape[1] != 2:
                raise ValueError("ArrayNetwork.edges must have shape (E, 2)")
            V, E = node_coords.shape[0], edges.shape[0]
            if E == 0:
                raise ValueError("graph has no edges")
            if edges.size and (edges.min() < 0 or edges.max() >= V):
                raise ValueError("edge endpoint out of range 0..V-1")
            gdim = node_coords.shape[1]
            radii = (
                np.asarray(graph.radius, dtype=np.float64)
                if graph.radius is not None
                else None
            )
            if radii is not None and radii.shape != (E,):
                raise ValueError("ArrayNetwork.radius must have shape (E,)")
            edge_color = self._color_edge_array(graph, edges, V, color_strategy)
        else:
            import networkx as nx

            if not isinstance(graph, nx.DiGraph):
                raise TypeError("graph must be a networkx.DiGraph or ArrayNetwork")
            V = graph.number_of_nodes()
            E = graph.number_of_edges()
            if E == 0:
                raise ValueError("graph has no edges")
            if set(graph.nodes()) != set(range(V)):
                raise ValueError(
                    "graph node ids must be contiguous integers 0..V-1 "
                    "(use networkx.convert_node_labels_to_integers first)"
                )
            pos0 = np.asarray(graph.nodes[0]["pos"], dtype=np.float64)
            gdim = pos0.shape[0]
            node_coords = np.empty((V, gdim), dtype=np.float64)
            for v in graph.nodes():
                node_coords[v] = graph.nodes[v]["pos"]

            edges = np.asarray(list(graph.edges()), dtype=np.int64).reshape(E, 2)
            if color_strategy == "fast":
                edge_color = self._color_edge_array(graph, edges, V, "fast")
            else:
                coloring = color_graph(graph, color_strategy)
                # Undirected line-graph coloring may key edges in either
                # orientation.
                edge_color = np.asarray(
                    [
                        coloring.get((int(u), int(v)), coloring.get((int(v), int(u))))
                        for u, v in edges
                    ],
                    dtype=np.int32,
                )

            # Optional per-edge radius attribute (arterial trees).
            try:
                radii = np.asarray(
                    [graph.edges[int(u), int(v)]["radius"] for u, v in edges],
                    dtype=np.float64,
                )
            except KeyError:
                radii = None
        num_colors = int(edge_color.max()) + 1

        # Degree-based node classification (reference mesh.py:182-187).
        degree = np.zeros(V, dtype=np.int64)
        np.add.at(degree, edges[:, 0], 1)
        np.add.at(degree, edges[:, 1], 1)
        bifurcation_values = np.flatnonzero(degree > 1).astype(np.int32)
        boundary_values = np.flatnonzero(degree == 1).astype(np.int32)
        self._max_connections = int(degree.max())

        # Per-bifurcation in/out edge CSR (reference mesh.py:189-209).
        bif_index = np.full(V, -1, dtype=np.int64)
        bif_index[bifurcation_values] = np.arange(bifurcation_values.size)
        B = bifurcation_values.size

        def _incidence_csr(endpoint: np.ndarray):
            """CSR of edge ids grouped by the bifurcation at ``endpoint``."""
            at_bif = bif_index[endpoint] >= 0
            eids = np.flatnonzero(at_bif).astype(np.int32)
            groups = bif_index[endpoint[at_bif]]
            order = np.argsort(groups, kind="stable")
            data = eids[order]
            counts = np.bincount(groups, minlength=B)
            offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
            return data, offsets

        # in-edges of a node terminate there (endpoint = edge target).
        self._bif_in_edges, self._bif_in_offsets = _incidence_csr(edges[:, 1])
        self._bif_out_edges, self._bif_out_offsets = _incidence_csr(edges[:, 0])

        # Boundary inlet/outlet classification (reference mesh.py:211-225):
        # a degree-1 node with an in-edge is marked "in", with an out-edge "out".
        is_boundary = degree == 1
        has_in = np.zeros(V, dtype=bool)
        has_in[edges[:, 1]] = True
        boundary_in_nodes = np.flatnonzero(is_boundary & has_in).astype(np.int32)
        boundary_out_nodes = np.flatnonzero(is_boundary & ~has_in).astype(np.int32)

        # --- vertex table: graph nodes first, then per-edge interior points,
        # edge-major (reference mesh.py:270-316, vectorized).
        n_interior = N - 1
        edge_vec = node_coords[edges[:, 1]] - node_coords[edges[:, 0]]  # (E, gdim)
        vertices = np.empty((V + E * n_interior, gdim), dtype=np.float64)
        vertices[:V] = node_coords
        if n_interior > 0:
            # Interior points start + w*vec, computed in an (E*gdim, N-1)
            # layout: the straightforward (E, N-1, gdim) broadcast iterates
            # E*(N-1) blocks of gdim(=2,3) elements and is loop-overhead
            # bound (measured ~4x slower on 65k-edge/N=40 meshes).
            w = np.linspace(0.0, 1.0, N, endpoint=False)[1:]  # (N-1,)
            tmp = edge_vec.reshape(E * gdim, 1) * w[None, :]  # inner axis N-1
            tmp += node_coords[edges[:, 0]].reshape(E * gdim, 1)
            vertices[V:] = (
                tmp.reshape(E, gdim, n_interior)
                .transpose(0, 2, 1)
                .reshape(E * n_interior, gdim)
            )

        # --- cells, edge-major, N per edge, in along-edge chain order.
        # chain for edge e: [u, first_interior .. last_interior, v]
        chain = np.empty((E, N + 1), dtype=np.int64)
        chain[:, 0] = edges[:, 0]
        chain[:, -1] = edges[:, 1]
        if n_interior > 0:
            interior_ids = V + np.arange(E * n_interior, dtype=np.int64).reshape(E, n_interior)
            chain[:, 1:-1] = interior_ids
        # Store cells with ascending vertex ids; orientation = +1 where the
        # stored order coincides with the edge direction (the reference keeps
        # the analogous ±1 DG0 field and corrects it after the partitioner
        # reorders cells, mesh.py:321-322,374-400 — here the sort is the only
        # reordering and the sign is tracked exactly).
        a_end, b_end = chain[:, :-1], chain[:, 1:]
        cells = np.empty((E * N, 2), dtype=np.int64)
        cv = cells.reshape(E, N, 2)
        np.minimum(a_end, b_end, out=cv[..., 0])
        np.maximum(a_end, b_end, out=cv[..., 1])
        orientation = np.where(a_end < b_end, 1.0, -1.0).reshape(E * N)

        cell_edge = np.repeat(np.arange(E, dtype=np.int32), N)
        cell_color = edge_color[cell_edge]

        # Geometry helpers — edge-level closed forms: every cell of edge e
        # is a straight 1/N slice of it, so cell_h = |edge|/N uniformly and
        # the stored-order unit tangent is ±(edge direction) with the sign
        # already tracked in `orientation`.  (cell_tangent is materialised
        # lazily — only orientation diagnostics read the (C, gdim) field.)
        edge_length = np.sqrt(np.einsum("ij,ij->i", edge_vec, edge_vec))
        if np.any(edge_length <= 0.0):
            raise ValueError("degenerate (zero-length) cell in network mesh")
        cell_h = np.repeat(edge_length / N, N)

        # Vertex markers (reference mesh.py:402-420): original node id per
        # graph vertex, with boundary inlets/outlets overwritten by sentinels.
        self._in_marker = 3 * V
        self._out_marker = 5 * V
        vertex_markers = np.arange(V, dtype=np.int32)
        vertex_markers[boundary_in_nodes] = self._in_marker
        vertex_markers[boundary_out_nodes] = self._out_marker

        # Commit arrays.
        self._gdim = int(gdim)
        self._num_graph_nodes = V
        self._num_edges = E
        self._vertices = vertices
        self._cells = cells
        self._cell_edge = cell_edge
        self._cell_color = cell_color
        self._orientation = orientation
        self._cell_h = cell_h
        self._cell_tangent_cache: npt.NDArray[np.float64] | None = None
        self._edge_unit_vec = edge_vec / edge_length[:, None]
        self._edges = edges
        self._edge_color = edge_color
        self._edge_radius = radii
        self._edge_length = edge_length
        self._num_edge_colors = num_colors
        self._bifurcation_values = bifurcation_values
        self._boundary_values = boundary_values
        self._boundary_in_nodes = boundary_in_nodes
        self._boundary_out_nodes = boundary_out_nodes
        self._vertex_markers = vertex_markers
        self._node_coords = node_coords

    @timed("nxfx:NetworkMesh:build_network_submeshes")
    def _build_network_submeshes(self) -> None:
        """Build per-color index views (reference ``mesh.py:425-460``).

        Exploits the edge-major layout instead of sorting cells: a color's
        cells are the N-blocks of its edges (ascending), and its vertex set
        is [sorted unique edge endpoints (< V)] ++ [per-edge interior
        ranges (ascending)] — already globally sorted, so the previous
        ``np.unique(return_inverse=True)`` over 2·C_sub entries (the
        dominant submesh-build cost at millions of cells) reduces to an
        E-sized unique plus one scatter/gather through a reused lookup
        buffer."""
        self._submesh_views: list[SubmeshView] = []
        N = self._N
        V = self._num_graph_nodes
        n_int = N - 1
        arN = np.arange(N, dtype=np.int64)
        lut = np.empty(self._vertices.shape[0], dtype=np.int32)  # scratch
        for c in range(self._num_edge_colors):
            eids = np.flatnonzero(self._edge_color == c)
            cell_idx = (eids[:, None] * N + arN).ravel().astype(np.int32)
            ep = np.unique(self._edges[eids].ravel())
            if n_int > 0:
                interior = (
                    V + eids[:, None] * n_int + arN[:n_int]
                ).ravel()
                vtx = np.concatenate([ep, interior])
            else:
                vtx = ep
            lut[vtx] = np.arange(vtx.size, dtype=np.int32)
            sub_cells = lut[self._cells[cell_idx]]
            # Inherit vertex markers onto submesh vertices
            # (reference mesh.py:447-459).
            marks = np.full(vtx.size, -1, dtype=np.int32)
            graph_vtx = vtx < V
            marks[graph_vtx] = self._vertex_markers[vtx[graph_vtx]]
            tagged = np.flatnonzero(marks >= 0).astype(np.int32)
            fm = MeshTags(indices=tagged, values=marks[tagged])
            self._submesh_views.append(
                SubmeshView(
                    color=c,
                    cell_indices=cell_idx,
                    vertex_indices=vtx.astype(np.int32),
                    cells=sub_cells,
                    facet_markers=fm,
                    edge_ids=eids.astype(np.int32),
                )
            )

    @timed("nxfx:NetworkMesh:create_lm_submesh")
    def _create_lm_view(self) -> None:
        """Lagrange-multiplier point cloud: one point per bifurcation
        (reference ``mesh.py:117-136``).  The multiplier dof for bifurcation
        ``b`` is its index in the sorted ``bifurcation_values``."""
        self._lm_vertices = self._bifurcation_values.copy()

    # ------------------------------------------------------------- accessors
    @property
    def geometric_dim(self) -> int:
        return self._gdim

    @property
    def topological_dim(self) -> int:
        return 1

    @property
    def N(self) -> int:
        """Elements per edge segment."""
        return self._N

    @property
    def num_cells(self) -> int:
        return int(self._cells.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self._vertices.shape[0])

    @property
    def num_edges(self) -> int:
        return self._num_edges

    @property
    def num_graph_nodes(self) -> int:
        return self._num_graph_nodes

    @property
    def vertices(self) -> npt.NDArray[np.float64]:
        """(Vm, gdim) vertex coordinates; the first ``num_graph_nodes`` rows
        are the original graph nodes."""
        return self._vertices

    @property
    def cells(self) -> npt.NDArray[np.int64]:
        """(C, 2) cell→vertex connectivity, each row ascending."""
        return self._cells

    @property
    def cell_color(self) -> npt.NDArray[np.int32]:
        return self._cell_color

    @property
    def cell_edge(self) -> npt.NDArray[np.int32]:
        """(C,) graph-edge id owning each cell (cells are edge-major:
        cell ``e * N + j`` is the j-th segment of edge ``e``)."""
        return self._cell_edge

    @property
    def cell_h(self) -> npt.NDArray[np.float64]:
        return self._cell_h

    @property
    def cell_tangent(self) -> npt.NDArray[np.float64]:
        """(C, gdim) unit direction of each cell in stored vertex order;
        multiply by :attr:`orientation` to get the graph-edge direction
        (the reference computes this as ``orientation * J[:,0]/|J[:,0]|``,
        assembly.py:238-242).  Built lazily: edges are straight, so this
        is ±(per-edge unit vector) expanded to cells."""
        if self._cell_tangent_cache is None:
            self._cell_tangent_cache = (
                self._edge_unit_vec[self._cell_edge] * self._orientation[:, None]
            )
        return self._cell_tangent_cache

    @property
    def orientation(self) -> npt.NDArray[np.float64]:
        """(C,) ``±1``: +1 where the stored cell order matches the directed
        edge (reference DG-0 orientation field, ``mesh.py:374-400``)."""
        return self._orientation

    @property
    def edges(self) -> npt.NDArray[np.int64]:
        """(E, 2) original directed edges (u → v)."""
        return self._edges

    @property
    def edge_color(self) -> npt.NDArray[np.int32]:
        return self._edge_color

    @property
    def edge_length(self) -> npt.NDArray[np.float64]:
        return self._edge_length

    @property
    def edge_radius(self) -> npt.NDArray[np.float64] | None:
        """Per-edge radius attribute if the graph carried one, else None."""
        return self._edge_radius

    @property
    def subdomains(self) -> MeshTags:
        """Cell tags: cell index → edge color (reference ``mesh.py:354-363``)."""
        return MeshTags(
            indices=np.arange(self.num_cells, dtype=np.int32),
            values=self._cell_color.copy(),
            name="subdomains",
        )

    @property
    def boundaries(self) -> MeshTags:
        """Vertex tags on graph nodes (reference ``mesh.py:402-420``)."""
        return MeshTags(
            indices=np.arange(self._num_graph_nodes, dtype=np.int32),
            values=self._vertex_markers.copy(),
            name="bifurcations",
        )

    @property
    def vertex_markers(self) -> npt.NDArray[np.int32]:
        return self._vertex_markers

    @property
    def submeshes(self) -> list[SubmeshView]:
        return self._submesh_views

    @property
    def entity_maps(self) -> list[npt.NDArray[np.int32]]:
        """Per-color sub-cell → parent-cell index arrays (EntityMap analog)."""
        return [view.cell_indices for view in self._submesh_views]

    @property
    def submesh_facet_markers(self) -> list[MeshTags]:
        return [view.facet_markers for view in self._submesh_views]

    @property
    def lm_vertices(self) -> npt.NDArray[np.int32]:
        """Vertex (graph-node) id of each multiplier point, sorted."""
        return self._lm_vertices

    @property
    def num_multipliers(self) -> int:
        return int(self._lm_vertices.size)

    @property
    def bifurcation_values(self) -> npt.NDArray[np.int32]:
        return self._bifurcation_values

    @property
    def boundary_values(self) -> npt.NDArray[np.int32]:
        return self._boundary_values

    @property
    def boundary_in_nodes(self) -> npt.NDArray[np.int32]:
        return self._boundary_in_nodes

    @property
    def boundary_out_nodes(self) -> npt.NDArray[np.int32]:
        return self._boundary_out_nodes

    def in_edges(self, bifurcation_idx: int) -> npt.NDArray[np.int32]:
        """Colors of the edges flowing INTO the given bifurcation (by index
        into :attr:`bifurcation_values`), mirroring reference ``mesh.py:515-519``."""
        eids = self.in_edge_ids(bifurcation_idx)
        return self._edge_color[eids]

    def out_edges(self, bifurcation_idx: int) -> npt.NDArray[np.int32]:
        """Colors of the edges flowing OUT of the given bifurcation
        (reference ``mesh.py:521-525``)."""
        eids = self.out_edge_ids(bifurcation_idx)
        return self._edge_color[eids]

    def in_edge_ids(self, bifurcation_idx: int) -> npt.NDArray[np.int32]:
        """Graph-edge ids terminating at the given bifurcation."""
        assert bifurcation_idx < len(self._bifurcation_values)
        lo = self._bif_in_offsets[bifurcation_idx]
        hi = self._bif_in_offsets[bifurcation_idx + 1]
        return self._bif_in_edges[lo:hi]

    def out_edge_ids(self, bifurcation_idx: int) -> npt.NDArray[np.int32]:
        """Graph-edge ids originating at the given bifurcation."""
        assert bifurcation_idx < len(self._bifurcation_values)
        lo = self._bif_out_offsets[bifurcation_idx]
        hi = self._bif_out_offsets[bifurcation_idx + 1]
        return self._bif_out_edges[lo:hi]

    @property
    def bif_in_csr(self) -> tuple[npt.NDArray[np.int32], npt.NDArray[np.int32]]:
        """CSR (data=edge ids, offsets) of in-edges per bifurcation."""
        return self._bif_in_edges, self._bif_in_offsets

    @property
    def bif_out_csr(self) -> tuple[npt.NDArray[np.int32], npt.NDArray[np.int32]]:
        return self._bif_out_edges, self._bif_out_offsets

    @property
    def num_edge_colors(self) -> int:
        return self._num_edge_colors

    @property
    def in_marker(self) -> int:
        return self._in_marker

    @property
    def out_marker(self) -> int:
        return self._out_marker

    def has_floating_component(self) -> bool:
        """True if some connected component of the network touches no
        boundary node — the pressure level there is undetermined and the
        saddle system is singular (the reference would hit a MUMPS zero
        pivot, ``solver.py:64``)."""
        if getattr(self, "_floating_cache", None) is None:
            import scipy.sparse as sp
            from scipy.sparse.csgraph import connected_components

            V = self._num_graph_nodes
            ones = np.ones(self._edges.shape[0])
            adjacency = sp.coo_matrix(
                (ones, (self._edges[:, 0], self._edges[:, 1])), shape=(V, V)
            )
            _, labels = connected_components(adjacency, directed=False)
            with_boundary = np.zeros(labels.max() + 1, dtype=bool)
            with_boundary[labels[self._boundary_values]] = True
            touched = np.unique(labels[self._edges[:, 0]])
            self._floating_cache = bool(np.any(~with_boundary[touched]))
        return self._floating_cache

    @property
    def max_connections(self) -> int:
        """Maximum node degree (reference passes this to the partitioner as
        ``max_facet_to_cell_links``, ``mesh.py:331-339``)."""
        return self._max_connections

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"NetworkMesh(edges={self.num_edges}, N={self._N}, "
            f"cells={self.num_cells}, vertices={self.num_vertices}, "
            f"colors={self.num_edge_colors}, bifurcations={self.num_multipliers})"
        )
