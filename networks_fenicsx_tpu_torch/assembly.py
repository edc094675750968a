"""Coefficient and dof-layout preparation of the dual-mixed hydraulic system.

Counterpart of ``networks_fenicsx_tpu/assembly.py``.  Host NumPy: the dof
maps (``_build_dof_maps``), the coefficient classification of
:meth:`HydraulicNetworkAssembler.compute_forms` (including the R-generation
counter the factor-reuse path keys on), the quadrature rule that quad-mode
(callable) coefficients are sampled on, the per-edge boundary data and
:meth:`~HydraulicNetworkAssembler.schur_arguments`, and — built lazily, so
the Schur routes never pay for them — the static COO stream
(``_build_static_structure``), the cell masses, the per-cell source load and
the global right-hand side ``_b_host``.

Explicit assembly (:meth:`~HydraulicNetworkAssembler.assemble`, kinds
bcoo/mpi/dense/nest/blocks/csr, and the block forms) folds the value stream
into the unique slots of the host CSR pattern with K20
(:mod:`.ops.csr_assembly`) on the requested device and returns PyTorch
tensors: a dense ``(n, n)`` tensor, a coalesced ``sparse_coo_tensor``, a
dict of them per block, or a :class:`.ops.sparse.CSRMatrix`.

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
import torch

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
        # the COO stream is built on first use: only explicit assembly and
        # the assembled-matrix and continuous-pressure solves read it
        self._static_built = False
        self._csr = None  # (pattern, fold) of the whole stream, once per assembler
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

    # ----------------------------------------------- static sparsity pattern
    def _build_static_structure(self) -> None:
        """COO rows/cols for every block; only the mass values are dynamic.

        Entry order (the CSR pattern and ``values = [cell_mass,
        static_vals]`` rely on it): mass block first, then [+div | −divᵀ |
        λ-rows | λ-cols], filled into preallocated arrays as the
        reference's ``_build_static_structure``; int32 indices below
        2³¹ dofs."""
        if self._static_built:
            return
        mesh = self._network_mesh
        k, kp = self._k, self._kp
        C = mesh.num_cells
        fd = self._cell_flux_dofs  # (C, k+1)
        pd = self._cell_p_dofs  # (C, np)

        Dhat = elements.div_matrix(kp, k)  # (np, k+1)
        npd = Dhat.shape[0]
        end_dof = self._edge_flux_base + self._dofs_per_edge - 1
        start_dof = self._edge_flux_base
        in_e = self._edge_end_bif >= 0
        out_e = self._edge_start_bif >= 0
        n_in, n_out = int(in_e.sum()), int(out_e.sum())

        nm = C * (k + 1) * (k + 1)  # flux mass block (dynamic values)
        nd = C * npd * (k + 1)  # one divergence block
        n_static = 2 * nd + 2 * (n_in + n_out)
        idx_dt = np.int32 if self._num_dofs < np.iinfo(np.int32).max else np.int64
        rows = np.empty(nm + n_static, dtype=idx_dt)
        cols = np.empty(nm + n_static, dtype=idx_dt)
        static_vals = np.empty(n_static, dtype=np.float64)

        rows[:nm].reshape(C, k + 1, k + 1)[:] = fd[:, :, None]
        cols[:nm].reshape(C, k + 1, k + 1)[:] = fd[:, None, :]

        # a[M][i] = +div ; a[i][M] = -div^T
        s0, s1 = nm, nm + nd
        rows[s0:s1].reshape(C, npd, k + 1)[:] = pd[:, :, None]
        cols[s0:s1].reshape(C, npd, k + 1)[:] = fd[:, None, :]
        rows[s1 : s1 + nd].reshape(C, npd, k + 1)[:] = fd[:, None, :]
        cols[s1 : s1 + nd].reshape(C, npd, k + 1)[:] = pd[:, :, None]
        static_vals[:nd].reshape(C, npd * (k + 1))[:] = Dhat.ravel()[None]
        static_vals[nd : 2 * nd].reshape(C, npd * (k + 1))[:] = -Dhat.ravel()[None]

        # multiplier incidence: in-edge of bifurcation b +q(edge end),
        # out-edge −q(edge start), and the symmetric a[c][M+1]
        lr = np.concatenate(
            [self._lm_offset + self._edge_end_bif[in_e],
             self._lm_offset + self._edge_start_bif[out_e]]
        )
        lc = np.concatenate([end_dof[in_e], start_dof[out_e]])
        lv = np.concatenate([np.ones(n_in), -np.ones(n_out)])
        o0 = nm + 2 * nd
        nlm = n_in + n_out
        rows[o0 : o0 + nlm] = lr
        cols[o0 : o0 + nlm] = lc
        rows[o0 + nlm :] = lc
        cols[o0 + nlm :] = lr
        static_vals[2 * nd : 2 * nd + nlm] = lv
        static_vals[2 * nd + nlm :] = lv

        self._all_rows_arr = rows
        self._all_cols_arr = cols
        self._static_vals_arr = static_vals
        self._static_built = True

    @property
    def _all_rows(self) -> np.ndarray:
        self._build_static_structure()
        return self._all_rows_arr

    @property
    def _all_cols(self) -> np.ndarray:
        self._build_static_structure()
        return self._all_cols_arr

    @property
    def _static_vals(self) -> np.ndarray:
        self._build_static_structure()
        return self._static_vals_arr

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
        self._set_source_load()

        # Boundary pressure values at graph nodes (only boundary nodes used).
        if callable(p_bc_ex):
            node_pbc = np.asarray(
                p_bc_ex(_as_padded_coords(mesh.vertices[: mesh.num_graph_nodes])),
                dtype=np.float64,
            ).reshape(mesh.num_graph_nodes)
        else:
            node_pbc = np.full(mesh.num_graph_nodes, float(p_bc_ex))
        self._node_pbc = node_pbc
        self._b_host_cache = None
        edges = mesh.edges

        # Per-edge effective endpoint data for the Schur solver.
        self._edge_start_pbc = np.where(
            self._edge_start_bif < 0, node_pbc[edges[:, 0]], 0.0
        )
        self._edge_end_pbc = np.where(self._edge_end_bif < 0, node_pbc[edges[:, 1]], 0.0)
        self._forms_computed = True

    def _set_source_load(self) -> None:
        """The per-cell pressure load ``∫ f ψ_m`` (None for f = 0) and source
        integrals from the classified f, and the lazy caches of the generic
        paths reset (reference ``assembly.py:435-449``)."""
        mesh = self._network_mesh
        xi, w = elements.gauss_legendre(self._k + 1)
        self._cell_mass_cache = None
        self._cell_mass_dev = None
        f_q = self._f_quad_host()
        if f_q is None:
            self._cell_f_load = None
            self._cell_f_int_cache = None  # lazy zeros(C): generic paths only
        else:
            kp = self._kp
            psi = elements.tabulate(kp, xi) if kp > 0 else np.ones((xi.size, 1))
            self._cell_f_load = np.einsum("cq,q,qm->cm", f_q, w, psi) * mesh.cell_h[:, None]
            self._cell_f_int_cache = np.einsum("cq,q->c", f_q, w) * mesh.cell_h

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

    def _f_quad_host(self) -> np.ndarray | None:
        return self._expand_quad_host(self._f_mode, self._f_data)

    @property
    def _R_quad(self) -> np.ndarray:
        """Resistance at quadrature points, (C, nq)."""
        self._require_forms()
        out = self._expand_quad_host(self._R_mode, self._R_data)
        if out is None:
            out = np.zeros((self._network_mesh.num_cells, self._quad_weights.shape[0]))
        return out

    @property
    def _f_quad(self) -> np.ndarray:
        """Source at quadrature points, (C, nq)."""
        self._require_forms()
        out = self._f_quad_host()
        if out is None:
            out = np.zeros((self._network_mesh.num_cells, self._quad_weights.shape[0]))
        return out

    @property
    def _cell_mass(self) -> np.ndarray:
        """Per-cell flux mass matrices ``M_c = h_c Σ_q w_q R(x_q) φ_i φ_j``,
        (C, k+1, k+1) on the host (lazy, reference ``assembly.py:778-804``)."""
        self._require_forms()
        if self._cell_mass_cache is None:
            mesh = self._network_mesh
            if self._R_mode == "quad":
                self._cell_mass_cache = np.einsum(
                    "cq,q,qi,qj->cij", self._R_data, self._quad_weights, self._quad_phi,
                    self._quad_phi,
                ) * mesh.cell_h[:, None, None]
            else:
                Mhat = elements.mass_matrix(self._k)
                if self._R_mode == "scalar":
                    R_cells = np.full(mesh.num_cells, self._R_data[0])
                elif self._R_mode == "edge":
                    R_cells = self._R_data[mesh.cell_edge]
                else:
                    R_cells = self._R_data
                self._cell_mass_cache = (R_cells * mesh.cell_h)[:, None, None] * Mhat[None]
        return self._cell_mass_cache

    def _cell_mass_on(self, device: torch.device) -> torch.Tensor:
        """The cell masses on ``device``, uploaded once per ``compute_forms``."""
        cached = self._cell_mass_dev
        if cached is None or cached.device != device:
            cached = torch.as_tensor(np.ascontiguousarray(self._cell_mass), device=device)
            self._cell_mass_dev = cached
        return cached

    @property
    def _b_host(self) -> np.ndarray:
        """Global RHS vector (lazy; reference ``assembly.py:475-499``)."""
        self._require_forms()
        if self._b_host_cache is None:
            mesh = self._network_mesh
            node_pbc = self._node_pbc
            b = np.zeros(self._num_dofs, dtype=np.float64)
            end_dof = self._edge_flux_base + self._dofs_per_edge - 1
            start_dof = self._edge_flux_base
            bin_nodes = mesh.boundary_in_nodes
            bout_nodes = mesh.boundary_out_nodes
            # in-boundary node = terminus of its unique in-edge
            edges = mesh.edges
            in_edge_of_node = np.full(mesh.num_graph_nodes, -1, dtype=np.int64)
            in_edge_of_node[edges[:, 1]] = np.arange(mesh.num_edges)
            out_edge_of_node = np.full(mesh.num_graph_nodes, -1, dtype=np.int64)
            out_edge_of_node[edges[:, 0]] = np.arange(mesh.num_edges)
            b[end_dof[in_edge_of_node[bin_nodes]]] += node_pbc[bin_nodes]
            b[start_dof[out_edge_of_node[bout_nodes]]] -= node_pbc[bout_nodes]
            if self._cell_f_load is not None:  # L[M] += ∫ f φ dx
                np.add.at(b, self._cell_p_dofs.ravel(), self._cell_f_load.ravel())
            self._b_host_cache = b
        return self._b_host_cache

    @property
    def _cell_f_int(self) -> np.ndarray:
        """Per-cell source integrals (lazy zeros for f == 0)."""
        self._require_forms()
        if self._cell_f_int_cache is None:
            self._cell_f_int_cache = np.zeros(self._network_mesh.num_cells)
        return self._cell_f_int_cache

    # ------------------------------------------------------------- assemble
    def _csr_plan(self):
        """``(pattern, fold)`` of the whole COO stream, built once."""
        if self._csr is None:
            from .ops.csr_assembly import build_csr_pattern, make_csr_assembler

            n = self._num_dofs
            pattern = build_csr_pattern(self._all_rows, self._all_cols, (n, n))
            self._csr = (pattern, make_csr_assembler(pattern))
        return self._csr

    def _values(self, device: torch.device) -> torch.Tensor:
        """The raw value stream ``[cell masses, static values]`` on ``device``."""
        return torch.cat([
            self._cell_mass_on(device).reshape(-1),
            torch.as_tensor(self._static_vals, device=device),
        ])

    def _assemble_csr(self, device: torch.device):
        """The system matrix as a :class:`.ops.sparse.CSRMatrix` on
        ``device``: the value stream folded by K20 into the host pattern."""
        from .ops.sparse import CSRMatrix

        pattern, fold = self._csr_plan()
        return CSRMatrix(data=fold(self._values(device)), indices=pattern.indices,
                         indptr=pattern.indptr, shape=pattern.shape)

    @timed("nxfx:HydraulicNetworkAssembler:assemble")
    def assemble(
        self,
        A=None,
        b=None,
        assemble_lhs: bool = True,
        assemble_rhs: bool = True,
        kind: str | None = None,
        device: torch.device | str = "cuda",
    ):
        """Assemble the system matrix and RHS vector on ``device`` (``"cuda"``
        by default; ``"cpu"`` runs K20's plain version).

        Args:
            A, b: Ignored placeholders for reference API parity (fresh
                tensors are returned).
            assemble_lhs / assemble_rhs: Which parts to build.
            kind: ``None``/"bcoo"/"mpi" → a coalesced ``sparse_coo_tensor``;
                ``"dense"`` → an ``(n, n)`` tensor; ``"nest"``/"blocks" →
                dict ``(i, j) →`` coalesced sparse block; ``"csr"`` →
                :class:`.ops.sparse.CSRMatrix`.  Every kind sums duplicates
                through the K20 fold and then writes unique slots.
        """
        from .solver import resolve_device

        self._require_forms()
        device = resolve_device(device)
        kind = kind or "bcoo"
        if kind not in ("dense", "bcoo", "mpi", "nest", "blocks", "csr"):
            raise ValueError(f"unknown matrix kind {kind!r}")
        A_out, b_out = A, b
        if assemble_lhs:
            csr = self._assemble_csr(device)
            if kind == "dense":
                A_out = csr.todense()
            elif kind in ("bcoo", "mpi"):
                A_out = _coalesced(csr.row_ids(), csr.device_arrays[1].long(), csr.data, csr.shape)
            elif kind in ("nest", "blocks"):
                A_out = self._assemble_blocks(csr)
            else:
                A_out = csr
        if assemble_rhs:
            b_out = torch.as_tensor(self._b_host, device=device)
        return A_out, b_out

    def _assemble_blocks(self, csr) -> dict:
        """Per-block coalesced sparse matrices (the MatNest analog)."""
        offs = torch.as_tensor(self._block_offsets, device=csr.data.device)
        rows, cols = csr.row_ids(), csr.device_arrays[1].long()
        row_blk = torch.searchsorted(offs, rows, right=True) - 1
        col_blk = torch.searchsorted(offs, cols, right=True) - 1
        nblocks = len(self._block_sizes)
        key = (row_blk * nblocks + col_blk).cpu().numpy()
        blocks = {}
        for i in range(nblocks):
            for j in range(nblocks):
                sel = np.flatnonzero(key == i * nblocks + j)
                if not sel.size:
                    continue
                s = torch.as_tensor(sel, device=csr.data.device)
                blocks[(i, j)] = _coalesced(
                    rows[s] - int(self._block_offsets[i]), cols[s] - int(self._block_offsets[j]),
                    csr.data[s], (int(self._block_sizes[i]), int(self._block_sizes[j])),
                )
        return blocks

    def bilinear_form(self, i: int, j: int, device: torch.device | str = "cuda") -> torch.Tensor:
        """Block (i, j) of the assembled matrix as a dense tensor: the folded
        CSR slots of the block (O(block) memory, not O(dofs²))."""
        from .solver import resolve_device

        self._require_forms()
        device = resolve_device(device)
        offs = self._block_offsets
        ni, nj = int(offs[i + 1] - offs[i]), int(offs[j + 1] - offs[j])
        pattern, _ = self._csr_plan()
        r0, r1 = int(pattern.indptr[offs[i]]), int(pattern.indptr[offs[i + 1]])
        cols = pattern.indices[r0:r1]
        rows = np.repeat(np.arange(offs[i], offs[i + 1]), np.diff(pattern.indptr[offs[i]:offs[i + 1] + 1]))
        sel = np.flatnonzero((cols >= offs[j]) & (cols < offs[j + 1]))
        data = self._assemble_csr(device).data[r0:r1]
        out = torch.zeros((ni, nj), dtype=torch.float64, device=device)
        if sel.size:
            s = torch.as_tensor(sel, device=device)
            out[torch.as_tensor(rows[sel] - offs[i], device=device),
                torch.as_tensor(cols[sel] - offs[j], device=device)] = data[s]
        return out

    def linear_form(self, i: int, device: torch.device | str = "cuda") -> torch.Tensor:
        """Block i of the RHS."""
        from .solver import resolve_device

        self._require_forms()
        offs = self._block_offsets
        return torch.as_tensor(self._b_host[offs[i] : offs[i + 1]], device=resolve_device(device))

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


def _coalesced(rows: torch.Tensor, cols: torch.Tensor, values: torch.Tensor, shape) -> torch.Tensor:
    """A ``sparse_coo_tensor`` from unique entries already in (row, col) order."""
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), values, tuple(shape),
                                   is_coalesced=True, check_invariants=False)
