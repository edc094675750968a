"""Coefficient and dof-layout preparation of the dual-mixed hydraulic system.

Counterpart of ``networks_fenicsx_tpu/assembly.py`` (host NumPy).  The port
carries what the Schur path reads: the dof maps (``_build_dof_maps``), the
coefficient classification of :meth:`HydraulicNetworkAssembler.compute_forms`
(including the R-generation counter the factor-reuse path keys on), the
quadrature rule that quad-mode (callable) coefficients are sampled on, the
per-edge boundary data and :meth:`~HydraulicNetworkAssembler.schur_arguments`.
Explicit matrix assembly (kinds bcoo/dense/nest/csr) is ROADMAP A8.

The discrete system (block order ``[q_0 .. q_{M-1}, p, λ]``) is the
reference's: flux mass ``∫ R q v``, divergence coupling ``±∫ φ (∇q · τ)``,
multiplier incidence ±1 at edge endpoints, boundary pressure on the flux
rows and the source ``∫ f φ`` on the pressure rows.  Defaults ``f = 0`` and
``R = 1`` follow the reference.
"""

from __future__ import annotations

import typing

import numpy as np
import numpy.typing as npt

from .function import FunctionSpace
from .mesh import NetworkMesh
from .ops import elements
from .utils.timing import timed

# Sentinel distinguishing "no previous R input" from R=None (which means
# the default R=1 and must compare equal to a later R=None).
_UNSET = object()

__all__ = ["HydraulicNetworkAssembler"]


def _as_padded_coords(x: npt.NDArray[np.float64]) -> npt.NDArray[np.float64]:
    """(n, gdim) -> (3, n), zero-padded, matching DOLFINx callable convention."""
    out = np.zeros((3, x.shape[0]), dtype=np.float64)
    out[: x.shape[1]] = x.T
    return out


def _immutable(x) -> bool:
    """True when identity of ``x`` proves its bytes unchanged: Python
    scalars, None, and ndarrays read-only along their whole base chain (a
    read-only view of a writeable base still changes when the base does)."""
    if x is None or isinstance(x, (int, float)):
        return True
    if isinstance(x, np.ndarray):
        while isinstance(x, np.ndarray):
            if x.flags.writeable:
                return False
            x = x.base
        return x is None
    return False


class HydraulicNetworkAssembler:
    """Assembler for the hydraulic network model

    .. math::
        R q + \\frac{d p}{d s} = 0, \\qquad \\frac{d q}{d s} = f

    on the network graph, with ``Σ q_in = Σ q_out`` enforced at
    bifurcations by Lagrange multipliers.

    Args:
        mesh: The network mesh.
        flux_degree: Degree of the per-color flux spaces (equispaced Lagrange).
        pressure_degree: 0 (default) is discontinuous per-cell pressure,
            >= 1 continuous.
    """

    @timed("nxfx:HydraulicNetworkAssembler:__init__")
    def __init__(self, mesh: NetworkMesh, flux_degree: int = 1, pressure_degree: int = 0):
        if flux_degree < 1:
            raise ValueError("flux_degree must be >= 1")
        if pressure_degree < 0:
            raise ValueError("pressure_degree must be >= 0")
        self._network_mesh = mesh
        self._k = int(flux_degree)
        self._kp = int(pressure_degree)
        self._build_dof_maps()
        self._in_idx = max(mesh.in_marker, mesh.out_marker) + 1
        self._out_idx = self._in_idx + mesh.num_edge_colors

    # ----------------------------------------------------------- dof layout
    def _build_dof_maps(self) -> None:
        mesh = self._network_mesh
        k, kp, N = self._k, self._kp, mesh.N
        E, C, M = mesh.num_edges, mesh.num_cells, mesh.num_edge_colors
        B = mesh.num_multipliers

        # Edge ranks within each color (ascending edge id per color).
        order = np.lexsort((np.arange(E), mesh.edge_color))
        rank = np.empty(E, dtype=np.int64)
        counts = np.bincount(mesh.edge_color, minlength=M)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for c in range(M):
            rank[order[starts[c] : starts[c + 1]]] = np.arange(counts[c])
        self._edges_per_color = counts.astype(np.int64)

        dofs_per_edge = k * N + 1
        flux_sizes = counts * dofs_per_edge
        if kp == 0:
            p_size = C
        else:
            p_size = mesh.num_vertices + C * (kp - 1)
        sizes = np.concatenate([flux_sizes, [p_size, B]])
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        self._block_sizes = sizes.astype(np.int64)
        self._block_offsets = offsets.astype(np.int64)
        self._num_dofs = int(offsets[-1])

        # Absolute first-dof index of each edge's flux chain.
        self._edge_flux_base = (
            offsets[mesh.edge_color] + rank * dofs_per_edge
        ).astype(np.int64)
        self._dofs_per_edge = dofs_per_edge

        # Per-cell flux dofs (C, k+1), along-edge local order.
        cell_pos = np.arange(C, dtype=np.int64) % N
        self._cell_flux_dofs = (
            self._edge_flux_base[mesh.cell_edge][:, None]
            + k * cell_pos[:, None]
            + np.arange(k + 1)[None, :]
        )

        # Per-cell pressure dofs (C, npdofs), along-edge local order.
        p_off = offsets[M]
        if kp == 0:
            self._cell_p_dofs = p_off + np.arange(C, dtype=np.int64)[:, None]
        else:
            asc = mesh.orientation > 0
            start_v = np.where(asc, mesh.cells[:, 0], mesh.cells[:, 1])
            end_v = np.where(asc, mesh.cells[:, 1], mesh.cells[:, 0])
            pd = np.empty((C, kp + 1), dtype=np.int64)
            pd[:, 0] = p_off + start_v
            pd[:, kp] = p_off + end_v
            if kp > 1:
                interior0 = p_off + mesh.num_vertices
                pd[:, 1:kp] = (
                    interior0
                    + (kp - 1) * np.arange(C, dtype=np.int64)[:, None]
                    + np.arange(kp - 1)[None, :]
                )
            self._cell_p_dofs = pd

        self._lm_offset = int(offsets[M + 1])

        # Edge endpoint classification for boundary terms and multipliers.
        bif_index = np.full(mesh.num_graph_nodes, -1, dtype=np.int64)
        bif_index[mesh.bifurcation_values] = np.arange(B)
        self._edge_start_bif = bif_index[mesh.edges[:, 0]]
        self._edge_end_bif = bif_index[mesh.edges[:, 1]]

        self._flux_spaces = [
            FunctionSpace(mesh, "flux", k, c, int(flux_sizes[c])) for c in range(M)
        ]
        self._pressure_space = FunctionSpace(mesh, "pressure", kp, None, int(p_size))
        self._lm_space = FunctionSpace(mesh, "lm", 0, None, B)

    # --------------------------------------------------------------- forms
    @timed("nxfx:HydraulicNetworkAssembler:compute_forms")
    def compute_forms(
        self,
        p_bc_ex: typing.Callable | float,
        f: typing.Callable | float | npt.NDArray[np.floating] | None = None,
        R: typing.Callable | float | npt.NDArray[np.floating] | None = None,
        jit_options: dict | None = None,
        form_compiler_options: dict | None = None,
    ) -> None:
        """Evaluate coefficient data for the variational forms.

        Args:
            p_bc_ex: Boundary pressure — a callable on ``(3, n)`` coordinate
                arrays (DOLFINx convention) or a constant.
            f: Source term — None (0), a constant, a per-cell array ``(C,)``
                or a coordinate callable.
            R: Resistance — None (1), a constant, a per-edge ``(E,)`` or
                per-cell ``(C,)`` array, or a coordinate callable.
            jit_options, form_compiler_options: Accepted for reference API
                parity; unused.
        """
        del jit_options, form_compiler_options
        mesh = self._network_mesh
        k = self._k
        C = mesh.num_cells

        # Quadrature in along-edge parametrisation (callable coefficients).
        nq = k + 1
        xi, w = elements.gauss_legendre(nq)
        self._set_quadrature()

        points: list[np.ndarray] = []  # Gauss points of every cell, built once

        def _quad_coords() -> np.ndarray:
            """(C·nq, gdim) Gauss points in along-edge order; each callable
            gets its own padded (3, C·nq) copy of them."""
            if not points:
                asc = mesh.orientation > 0
                first = np.where(asc, mesh.cells[:, 0], mesh.cells[:, 1])
                second = np.where(asc, mesh.cells[:, 1], mesh.cells[:, 0])
                v_start, v_end = mesh.vertices[first], mesh.vertices[second]
                pts = (
                    v_start[:, None, :] * (1 - xi)[None, :, None]
                    + v_end[:, None, :] * xi[None, :, None]
                )  # (C, nq, gdim)
                points.append(pts.reshape(-1, mesh.geometric_dim))
            return points[0]

        def _classify(coeff, default: float) -> tuple[str, np.ndarray]:
            """Classify a coefficient and keep it in its most compact form."""
            if coeff is None:
                return "scalar", np.array([default])
            if callable(coeff):
                vals = coeff(_as_padded_coords(_quad_coords()))
                return "quad", np.asarray(vals, dtype=np.float64).reshape(C, nq)
            arr = np.asarray(coeff, dtype=np.float64)
            if arr.ndim == 0:
                return "scalar", arr.reshape(1)
            if arr.shape[0] == mesh.num_edges and mesh.num_edges != C:
                return "edge", arr
            if arr.shape[0] == C:
                return "cell", arr
            raise ValueError(
                f"coefficient array must have {C} (per-cell) or "
                f"{mesh.num_edges} (per-edge) entries, got {arr.shape}"
            )

        self._R_mode, self._R_data = _classify(R, 1.0)
        self._f_mode, self._f_data = _classify(f, 0.0)
        # R-staleness signal for factor reuse: bump a generation counter
        # unless R is provably the same immutable input as last time (the
        # snapshot records whether it was immutable THEN, so a buffer
        # mutated while writeable and frozen afterwards still bumps).
        prev = getattr(self, "_R_src", _UNSET)
        if (R is prev and getattr(self, "_R_src_immutable", False) and _immutable(R)) or (
            isinstance(R, (int, float))
            and isinstance(prev, (int, float))
            and float(R) == float(prev)
        ):
            pass
        else:
            self._R_generation = getattr(self, "_R_generation", 0) + 1
        self._R_src = R
        self._R_src_immutable = _immutable(R)

        # Boundary pressure values at graph nodes (only boundary nodes used).
        if callable(p_bc_ex):
            node_pbc = np.asarray(
                p_bc_ex(_as_padded_coords(mesh.vertices[: mesh.num_graph_nodes])),
                dtype=np.float64,
            ).reshape(mesh.num_graph_nodes)
        else:
            node_pbc = np.full(mesh.num_graph_nodes, float(p_bc_ex))
        self._node_pbc = node_pbc
        edges = mesh.edges

        # Per-edge effective endpoint data for the Schur solver.
        self._edge_start_pbc = np.where(
            self._edge_start_bif < 0, node_pbc[edges[:, 0]], 0.0
        )
        self._edge_end_pbc = np.where(self._edge_end_bif < 0, node_pbc[edges[:, 1]], 0.0)
        self._forms_computed = True

    def _set_quadrature(self) -> None:
        """Keep the Gauss rule of the quad-mode coefficients on the
        assembler: weights ``(nq,)`` and basis ``φ (nq, k+1)`` at its points
        (reference ``assembly.py:348-352, 432-433``)."""
        xi, w = elements.gauss_legendre(self._k + 1)
        self._quad_weights = w
        self._quad_phi = elements.tabulate(self._k, xi)

    def _expand_quad_host(self, mode: str, data: np.ndarray) -> np.ndarray | None:
        """Expand a compact coefficient to (C, nq), or None if exactly 0
        (reference ``assembly.py:708-722``)."""
        C = self._network_mesh.num_cells
        nq = self._quad_weights.shape[0]
        if mode == "scalar":
            if data[0] == 0.0:
                return None
            return np.broadcast_to(data.reshape(1, 1), (C, nq))
        if mode == "edge":
            return np.broadcast_to(data[self._network_mesh.cell_edge][:, None], (C, nq))
        if mode == "cell":
            return np.broadcast_to(data[:, None], (C, nq))
        return data

    def assemble(self, *args, **kwargs):
        """Explicit matrix assembly (kinds bcoo/dense/nest/csr) — not ported."""
        raise NotImplementedError("ROADMAP A8: explicit matrix assembly is not ported yet")

    def _require_forms(self) -> None:
        if not getattr(self, "_forms_computed", False):
            raise RuntimeError("Forms haven't been computed. Call compute_forms() first.")

    # ------------------------------------------------------------ accessors
    @property
    def lm_space(self) -> FunctionSpace:
        return self._lm_space

    @property
    def pressure_space(self) -> FunctionSpace:
        return self._pressure_space

    @property
    def flux_spaces(self) -> list[FunctionSpace]:
        return self._flux_spaces

    @property
    def function_spaces(self) -> list[FunctionSpace]:
        """All spaces in block order ``[flux..., pressure, lm]``."""
        return [*self._flux_spaces, self._pressure_space, self._lm_space]

    @property
    def network(self) -> NetworkMesh:
        return self._network_mesh

    @property
    def flux_degree(self) -> int:
        return self._k

    @property
    def pressure_degree(self) -> int:
        return self._kp

    @property
    def num_dofs(self) -> int:
        return self._num_dofs

    @property
    def block_sizes(self) -> npt.NDArray[np.int64]:
        return self._block_sizes

    @property
    def block_offsets(self) -> npt.NDArray[np.int64]:
        return self._block_offsets

    @property
    def forms_computed(self) -> bool:
        return getattr(self, "_forms_computed", False)

    @property
    def in_idx(self) -> int:
        return self._in_idx

    @property
    def out_idx(self) -> int:
        return self._out_idx

    def coefficient_modes(self) -> tuple[str, str, bool]:
        """The (R, f) kinds ('scalar' | 'edge' | 'cell' | 'quad') plus
        whether the source is the scalar zero; executor caches key on it."""
        self._require_forms()
        f_zero = self._f_mode == "scalar" and float(self._f_data[0]) == 0.0
        return self._R_mode, self._f_mode, f_zero

    def schur_arguments(self, device: bool = False):
        """Compact host arguments of the Schur executor:
        ``(R_data, f_data, edge_start_pbc, edge_end_pbc)`` as NumPy arrays;
        a quad-mode coefficient is its ``(C, nq)`` quadrature values.

        The executor permutes them into its internal edge order on the host
        and uploads them itself, so only ``device=False`` exists here."""
        if device:
            raise ValueError("schur_arguments() returns host arrays only (device=False)")
        self._require_forms()
        return (
            self._R_data,
            self._f_data,
            self._edge_start_pbc,
            self._edge_end_pbc,
        )
