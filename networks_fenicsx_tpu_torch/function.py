"""Lightweight function spaces and functions on a network mesh.

Counterpart of ``networks_fenicsx_tpu/function.py`` (host NumPy, unchanged).

Replaces the DOLFINx ``FunctionSpace``/``Function`` objects the reference
builds per color submesh (reference ``assembly.py:127-150``,
``solver.py:120-125``).  A space is a description (kind, degree, block
size); a function is a space plus a flat dof-value array.  Dof layouts:

* flux space of color ``c`` — edge-major over that color's edges (ascending
  edge id), each edge carrying ``degree * N + 1`` dofs in along-edge order
  (dof 0 at the edge's source node, the last dof at its target node);
* pressure space — degree 0: one dof per cell (edge-major);
  degree >= 1: mesh-vertex dofs first (shared at junctions → continuous),
  then ``degree - 1`` interior dofs per cell;
* multiplier space — one dof per bifurcation, ordered by sorted graph-node
  id (matching the reference's sorted ``bifurcation_values``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import numpy.typing as npt

from .mesh import NetworkMesh
from .ops import elements

__all__ = ["FunctionSpace", "NetworkFunction"]


@dataclasses.dataclass(frozen=True)
class FunctionSpace:
    """Descriptor of one solution block on the network.

    Attributes:
        mesh: The underlying :class:`NetworkMesh`.
        kind: ``"flux"``, ``"pressure"`` or ``"lm"``.
        degree: Polynomial degree (0 allowed for pressure/lm).
        color: Edge color for flux spaces, else None.
        size: Number of dofs.
    """

    mesh: NetworkMesh
    kind: str
    degree: int
    color: int | None
    size: int

    def dof_coordinates(self) -> npt.NDArray[np.float64]:
        """Physical coordinates of every dof (for IO / interpolation)."""
        mesh = self.mesh
        if self.kind == "lm":
            return mesh.vertices[mesh.lm_vertices]
        if self.kind == "flux":
            assert self.color is not None
            view = mesh.submeshes[self.color]
            return _edge_major_dof_coords(mesh, view.edge_ids, self.degree)
        if self.kind == "pressure":
            if self.degree == 0:
                # cell midpoints
                v0 = mesh.vertices[mesh.cells[:, 0]]
                v1 = mesh.vertices[mesh.cells[:, 1]]
                return 0.5 * (v0 + v1)
            interior = _cell_interior_coords(mesh, self.degree)
            return np.vstack([mesh.vertices, interior])
        if self.kind == "dg":
            # per-cell along-edge nodes (discontinuous parent-mesh field)
            xi = elements.equispaced_nodes(self.degree)[None, :, None]
            asc = mesh.orientation > 0
            start = np.where(
                asc[:, None], mesh.vertices[mesh.cells[:, 0]], mesh.vertices[mesh.cells[:, 1]]
            )
            end = np.where(
                asc[:, None], mesh.vertices[mesh.cells[:, 1]], mesh.vertices[mesh.cells[:, 0]]
            )
            return (start[:, None, :] * (1 - xi) + end[:, None, :] * xi).reshape(
                -1, mesh.geometric_dim
            )
        raise ValueError(f"unknown space kind {self.kind!r}")


def _edge_major_dof_coords(
    mesh: NetworkMesh, edge_ids: npt.NDArray[np.int32], degree: int
) -> npt.NDArray[np.float64]:
    """Coordinates of along-edge equispaced dofs for the given edges."""
    N = mesh.N
    n_dofs = degree * N + 1
    t = np.linspace(0.0, 1.0, n_dofs)[None, :, None]  # parametric along edge
    starts = mesh.vertices[mesh.edges[edge_ids, 0]][:, None, :]
    ends = mesh.vertices[mesh.edges[edge_ids, 1]][:, None, :]
    return (starts * (1 - t) + ends * t).reshape(-1, mesh.geometric_dim)


def _cell_interior_coords(mesh: NetworkMesh, degree: int) -> npt.NDArray[np.float64]:
    """Along-edge interior node coordinates for continuous degree >= 2."""
    if degree < 2:
        return np.empty((0, mesh.geometric_dim))
    xi = elements.equispaced_nodes(degree)[1:-1][None, :, None]
    asc = mesh.orientation > 0
    start = np.where(asc[:, None], mesh.vertices[mesh.cells[:, 0]], mesh.vertices[mesh.cells[:, 1]])
    end = np.where(asc[:, None], mesh.vertices[mesh.cells[:, 1]], mesh.vertices[mesh.cells[:, 0]])
    return (start[:, None, :] * (1 - xi) + end[:, None, :] * xi).reshape(
        -1, mesh.geometric_dim
    )


class NetworkFunction:
    """A finite-element function: a space plus flat dof values.

    Mirrors ``dolfinx.fem.Function`` as used by the reference solver
    (``solver.py:120-125``): named, and carrying a mutable value array
    (``.values``, analogous to ``Function.x.array``).
    """

    def __init__(
        self,
        space: FunctionSpace,
        values: npt.NDArray[np.float64] | None = None,
        name: str = "",
    ):
        self.space = space
        self.name = name
        if values is None:
            values = np.zeros(space.size, dtype=np.float64)
        self.values = np.asarray(values, dtype=np.float64).reshape(space.size)

    @property
    def function_space(self) -> FunctionSpace:
        return self.space

    @property
    def x(self) -> "NetworkFunction":
        """dolfinx-style ``function.x.array`` access."""
        return self

    @property
    def array(self) -> npt.NDArray[np.float64]:
        return self.values

    def cell_dof_values(self) -> npt.NDArray[np.float64]:
        """Values organised per cell, shape (num_cells, degree + 1).

        For a flux space the rows cover the cells of this color's submesh in
        along-edge local order; for degree-0 pressure the single column is
        the cell value.
        """
        sp = self.space
        mesh = sp.mesh
        k = max(sp.degree, 0)
        if sp.kind == "flux":
            view = mesh.submeshes[sp.color]
            N = mesh.N
            per_edge = self.values.reshape(view.edge_ids.size, k * N + 1)
            idx = k * np.arange(N)[:, None] + np.arange(k + 1)[None, :]  # (N, k+1)
            return per_edge[:, idx].reshape(-1, k + 1)
        if sp.kind == "pressure" and sp.degree == 0:
            return self.values.reshape(-1, 1)
        raise NotImplementedError(f"cell_dof_values for {sp.kind}, degree {sp.degree}")

    def __repr__(self) -> str:  # pragma: no cover
        return f"NetworkFunction(name={self.name!r}, kind={self.space.kind}, size={self.space.size})"
