"""Lattice planners of the bifurcation graph (host NumPy + SciPy).

Counterpart of ``networks_fenicsx_tpu/solver.py``: ``_directed_half_edges``
(``:740-749``), ``_build_matvec_plan`` (``:752-762``), ``_plan_shift_matvec``
(``:765-796``),
``_shift_class_weights`` (``:799-803``), ``_DctPlan`` and
``_plan_dct_lattice`` (``:829-924``), the orthonormal DCT-II matrix
providers (``:985-999``, ``:1043-1059``), ``_GridPlan`` and
``_plan_grid_layout`` (``:1105-1181``) and ``lattice_solve_applicable``
(``:3853-3870``).  The same inputs give ``np.array_equal`` plans.

The plans feed the exact separable-DCT λ solve of uniform scalar-R lattices
(K16, :mod:`.kernels.dct_lattice`) on its two routes: the gather-free grid
route (K17, :mod:`.kernels.grid_core`) and the general route in public edge
order (K18, :mod:`.kernels.shift_matvec`).  The shift plan, or else the
gather-fold tables of the matvec plan (K19b, :mod:`.kernels.gather_matvec`),
also carry the CG route's λ matvec.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import numpy as np
import torch

from .levels import segsum_matrix

__all__ = [
    "lattice_solve_applicable", "lattice_dct_plan", "shift_class_matrix", "gather_matvec_tables",
    "grid_edge_ends",
    "GridDevicePlan", "device_grid_plan", "DeviceLatticePlan", "device_lattice_plan",
]

# widest side whose DCT-II matrix is a host constant; wider ones are generated
# on the device (the reference's two providers, ``:1043-1059``)
HOST_DCT_MAX = 4096


def _directed_half_edges(asm):
    """The two directed half-edges of every interior (bif-bif) edge:
    ``(own, other, edge_id)`` arrays."""
    s = np.asarray(asm._edge_start_bif)
    t = np.asarray(asm._edge_end_bif)
    e = np.flatnonzero((s >= 0) & (t >= 0))
    own = np.concatenate([t[e], s[e]])
    other = np.concatenate([s[e], t[e]])
    edge = np.concatenate([e, e])
    return own, other, edge


def _build_matvec_plan(asm):
    """Host incidence plan of the gather-fold matvec: the directed
    half-edges sorted by their owning node, ``(edge_sel, other_sel,
    own_sorted)`` int32 (reference ``:752-762``)."""
    own, other, edge = _directed_half_edges(asm)
    order = np.argsort(own, kind="stable")
    return (
        edge[order].astype(np.int32),
        other[order].astype(np.int32),
        own[order].astype(np.int32),
    )


def gather_matvec_tables(plan, B: int) -> tuple[np.ndarray, np.ndarray]:
    """``(edge_idx, other_idx)``, each ``(K, B)``: column ``k`` of row ``i``
    names the edge and the neighbour of row ``i``'s ``k``-th half-edge in
    the fold order of the reference's ``_segsum_sorted`` (its K6 gather
    matrix :func:`.levels.segsum_matrix` with the plan composed in), ``-1``
    past the row's last half-edge."""
    edge_sel, other_sel, own_sorted = plan
    H = own_sorted.size
    idx = segsum_matrix(own_sorted, B, H)  # (B, K), pad slot H
    valid = idx < H
    at = np.minimum(idx, max(H - 1, 0))  # empty when H = 0
    edge_idx = np.where(valid, edge_sel[at], -1)
    other_idx = np.where(valid, other_sel[at], -1)
    return edge_idx.T.astype(np.int32), other_idx.T.astype(np.int32)


def _plan_shift_matvec(asm, max_classes: int = 16):
    """Shift-class decomposition of the λ-graph matvec, or None.

    Groups the directed off-diagonal contributions ``row i ← col j`` by
    the constant index offset ``δ = j − i``; None beyond ``max_classes``
    distinct offsets.  Returns a list of ``(delta, rows_sorted, edge_sel)``.
    """
    own, other, eidx = _directed_half_edges(asm)
    if eidx.size == 0:
        return None
    i, j = own, other  # row pulls from column: out[i] -= w * lam[j]
    delta = j - i
    deltas = np.unique(delta)
    if deltas.size > max_classes:
        return None
    classes = []
    for d in deltas:
        m = delta == d
        rows = i[m]
        order = np.argsort(rows, kind="stable")
        classes.append((int(d), rows[order].astype(np.int32), eidx[m][order]))
    return classes


class _DctPlan(typing.NamedTuple):
    """Host plan of the separable-DCT direct λ solve."""

    s: int  # row stride (lattice width nx)
    ny: int
    rep_x: int  # representative x-edge id (runtime w_x = 1/W)
    rep_y: int
    len_x: float  # geometric x-edge length
    stub_rows: np.ndarray  # (r,) λ rows carrying boundary-stub coupling
    stub_edge_idx: np.ndarray  # stub edge ids (runtime w_r = Σ 1/W)
    stub_edge_group: np.ndarray  # group index (into stub_rows) per stub edge
    g_geo: np.ndarray  # (r, B) geometric L⁺ columns at the stub rows
    lamx: np.ndarray  # (s,) Neumann path eigenvalues 2−2cos(πk/s)
    lamy: np.ndarray


def _plan_dct_lattice(asm, shift_plan):
    """Exact direct λ solve plan for uniform rectangular lattices, or None.

    The structure checks of the reference: four shift classes {±1, ±s}
    with the exact grid row patterns, uniform edge length per class, and
    at most 16 boundary-stub edges."""
    if shift_plan is None:
        return None
    deltas = sorted(c[0] for c in shift_plan)
    if len(deltas) != 4:
        return None
    s = deltas[3]
    if deltas != [-s, -1, 1, s] or s <= 2:
        return None
    mesh = asm.network
    B = mesh.num_multipliers
    if B % s != 0:
        return None
    ny = B // s
    if ny < 2:
        return None
    idx = np.arange(B)
    want = {
        1: idx[idx % s != s - 1],
        -1: idx[idx % s != 0],
        s: idx[: B - s],
        -s: idx[s:],
    }
    L_all = np.asarray(mesh.edge_length)
    lens: dict[int, float] = {}
    rep: dict[int, int] = {}
    for d, rows, esel in shift_plan:
        if not np.array_equal(np.sort(rows), want[d]):
            return None
        Ld = L_all[esel]
        if Ld.size == 0 or not np.allclose(Ld, Ld[0], rtol=1e-12, atol=0.0):
            return None
        prev = lens.get(abs(d))
        if prev is not None and not np.isclose(prev, Ld[0], rtol=1e-12):
            return None
        lens[abs(d)] = float(Ld[0])
        rep[d] = int(esel[0])
    # boundary stubs: edges with exactly one multiplier endpoint
    sb = np.asarray(asm._edge_start_bif)
    eb = np.asarray(asm._edge_end_bif)
    one = (sb >= 0) ^ (eb >= 0)
    stub_e = np.nonzero(one)[0]
    if stub_e.size == 0 or stub_e.size > 16:
        return None
    stub_row = np.where(sb[stub_e] >= 0, sb[stub_e], eb[stub_e])
    rows_u, group = np.unique(stub_row, return_inverse=True)

    import scipy.fft as _sfft

    lamx = 2.0 - 2.0 * np.cos(np.pi * np.arange(s) / s)
    lamy = 2.0 - 2.0 * np.cos(np.pi * np.arange(ny) / ny)
    sym = (1.0 / lens[1]) * lamx[None, :] + (1.0 / lens[s]) * lamy[:, None]
    sym[0, 0] = np.inf
    g = np.empty((rows_u.size, B))
    for t, row in enumerate(rows_u):
        e = np.zeros(B)
        e[int(row)] = 1.0
        c = _sfft.dctn(e.reshape(ny, s), type=2, norm="ortho") / sym
        g[t] = _sfft.idctn(c, type=2, norm="ortho").reshape(-1)
    return _DctPlan(
        s, ny, rep[1], rep[s], lens[1],
        rows_u.astype(np.int64), stub_e.astype(np.int64),
        group.astype(np.int64), g, lamx, lamy,
    )


def shift_class_matrix(classes, B: int, E: int) -> np.ndarray:
    """The K6 gather matrix of ``_shift_class_weights`` for all classes at once.

    Row ``c·B + i`` lists the edges whose conductance class ``c`` pulls into
    row ``i`` (each class's ``segsum_matrix(rows, B, E, sel=edge_sel)``),
    padded with the zero slot ``E`` to the widest row: one K6 launch gives
    the ``(C, B)`` class weights of a solve."""
    mats = [segsum_matrix(rows, B, E, sel=esel) for _, rows, esel in classes]
    K = max(m.shape[1] for m in mats)
    return np.concatenate(
        [np.pad(m, ((0, 0), (0, K - m.shape[1])), constant_values=E) for m in mats]
    )


def _shift_class_weights(w_edges: torch.Tensor, class_idx: torch.Tensor, n_classes: int, sums):
    """Per-class ``(C, B)`` off-diagonal weights from the runtime
    conductances ``w_edges = 1/W`` (once per solve, reference ``:799-803``);
    ``sums`` is K6's plain version (:func:`.kernels.segsum.segsum_plain`)."""
    return sums(class_idx, w_edges).view(n_classes, -1)


def _dct2_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, the host constant of sides up to
    :data:`HOST_DCT_MAX` (``c = D @ b``, ``b = D.T @ c``; reference
    ``:1046-1053``)."""
    j = np.arange(n)
    D = np.cos(np.pi * (j[None, :] + 0.5) * j[:, None] / n)
    D *= np.sqrt(2.0 / n)
    D[0] *= np.sqrt(0.5)
    return D


def _dct2_matrix_device(n: int, device: torch.device | str) -> torch.Tensor:
    """Orthonormal DCT-II matrix generated on ``device`` for sides above
    :data:`HOST_DCT_MAX` (reference ``:985-999``): the plain version of
    K16's generator.  The cosine argument ``π (j + ½) k / n`` reaches
    ~n²/2, so it is formed in float64."""
    j = torch.arange(n, dtype=torch.float64, device=device)
    D = torch.cos(math.pi * ((j[None, :] + 0.5) * j[:, None] / n))
    D = D * math.sqrt(2.0 / n)
    D[0] *= math.sqrt(0.5)
    return D


class _GridPlan(typing.NamedTuple):
    """Host plan of the lattice-internal edge layout (see
    :func:`_plan_grid_layout`)."""

    nx: int
    ny: int
    edge_order: np.ndarray  # (E,) internal position -> public edge id
    Ex: int  # x-edges: rows 0..Ex, (ny, nx-1) row-major
    Ey: int  # y-edges: rows Ex..Ex+Ey, (ny-1, nx) row-major
    s_is_bif: np.ndarray  # (E,) internal-order endpoint masks
    t_is_bif: np.ndarray
    stub_rows_e: np.ndarray  # (n_stub,) λ row of each stub edge (tail order)
    stub_s_bif: np.ndarray  # (n_stub,) True when the bif end is the START
    stub_group: np.ndarray  # (n_stub,) index into dct.stub_rows
    h_e: np.ndarray  # (E,) internal-order cell lengths (L/N)
    dct: _DctPlan
    bif_order: None = None  # λ stays in node order (flatten no-op)


def _plan_grid_layout(asm, dct: _DctPlan):
    """Lattice-internal edge order, or None (reference ``:1124-1181``).

    Companion of :func:`_plan_dct_lattice`, which proves the multiplier
    graph a uniform nx × ny grid: edges are reordered into [x-edges (ny,
    nx−1) row-major | y-edges (ny−1, nx) row-major | boundary stubs], so
    that the Schur rhs assembly, the refinement stencil and the λ → edge
    expansion follow from index arithmetic on the λ grid."""
    nx, ny = dct.s, dct.ny
    mesh = asm.network
    E = mesh.num_edges
    Ex, Ey = ny * (nx - 1), (ny - 1) * nx
    sb = np.asarray(asm._edge_start_bif)
    eb = np.asarray(asm._edge_end_bif)
    both = (sb >= 0) & (eb >= 0)
    d = np.where(both, eb - sb, 0)
    is_x = both & (d == 1)
    is_y = both & (d == nx)
    if np.any(both & ~is_x & ~is_y):
        return None  # reversed or non-grid edge: layout inapplicable
    slots = np.full(Ex + Ey, -1, dtype=np.int64)
    sx = sb[is_x]
    slots[(sx // nx) * (nx - 1) + sx % nx] = np.nonzero(is_x)[0]
    slots[Ex + sb[is_y]] = np.nonzero(is_y)[0]
    if np.any(slots < 0):
        return None
    stubs = np.nonzero(~both)[0]
    if np.any((sb[stubs] < 0) & (eb[stubs] < 0)):
        return None  # fully-boundary edge: not a lattice stub
    edge_order = np.concatenate([slots, stubs])
    if edge_order.size != E:
        return None
    stub_rows_e = np.where(sb[stubs] >= 0, sb[stubs], eb[stubs])
    pos = {int(r): i for i, r in enumerate(dct.stub_rows)}
    if any(int(r) not in pos for r in stub_rows_e):
        return None
    stub_group = np.array([pos[int(r)] for r in stub_rows_e], dtype=np.int64)
    return _GridPlan(
        nx=nx,
        ny=ny,
        edge_order=edge_order,
        Ex=Ex,
        Ey=Ey,
        s_is_bif=(sb[edge_order] >= 0),
        t_is_bif=(eb[edge_order] >= 0),
        stub_rows_e=stub_rows_e.astype(np.int64),
        stub_s_bif=(sb[stubs] >= 0),
        stub_group=stub_group,
        h_e=np.asarray(mesh.edge_length)[edge_order] / mesh.N,
        dct=dct,
    )


def grid_edge_ends(plan: _GridPlan) -> tuple[np.ndarray, np.ndarray]:
    """``(edge_src, edge_tgt)``: the λ row at each end of every internal-order
    edge, ``-1`` at a boundary end — the endpoint table K1 and K5 read.  An
    x-edge (i, j) joins nodes i·nx + j and i·nx + j + 1, a y-edge (i, j) node
    i·nx + j and the one above it."""
    nx, ny = plan.nx, plan.ny
    node = np.arange(nx * ny).reshape(ny, nx)
    rows = np.asarray(plan.stub_rows_e)
    s_bif = np.asarray(plan.stub_s_bif, dtype=bool)
    src = np.concatenate([node[:, :-1].ravel(), node[:-1, :].ravel(), np.where(s_bif, rows, -1)])
    tgt = np.concatenate([node[:, 1:].ravel(), node[1:, :].ravel(), np.where(s_bif, -1, rows)])
    return src.astype(np.int64), tgt.astype(np.int64)


GRID_THREADS = 256  # K17's block size (csrc/grid_core.cu THREADS): one partial sum a block


@dataclasses.dataclass(frozen=True)
class GridDevicePlan:
    """A :class:`_GridPlan` on one device, uploaded once per executor: the
    endpoint table of K1 and K5 and the stub table of K17 (int32).

    Validated once, at construction: the four tables contiguous 1-D int32
    tensors with data on one device, ``(E,)`` and ``(n_stub,)`` as the host
    plan says, and the lattice within K17's int32 indexing; a ``ValueError``
    otherwise.  K17's wrappers then check only their float64 arguments.

    Attributes:
        plan: The host plan (the plain versions read it).
        edge_src, edge_tgt: ``(E,)`` λ row at each end, ``-1`` at a boundary
            (:func:`grid_edge_ends`).
        stub_rows: ``(n_stub,)`` λ row of each stub, in internal order.
        stub_s_bif: ``(n_stub,)`` 1 where the stub's start is the junction.
        index: The tables' CUDA device index (-1 off CUDA).
        blocks: K17's blocks a launch, one partial sum of squares each.
    """

    plan: _GridPlan
    edge_src: torch.Tensor
    edge_tgt: torch.Tensor
    stub_rows: torch.Tensor
    stub_s_bif: torch.Tensor
    index: int = dataclasses.field(init=False, compare=False)
    blocks: int = dataclasses.field(init=False, compare=False)
    # K17's scratch of each calling stream, {raw stream handle: scratch},
    # made by :mod:`.kernels.grid_core` at the stream's first call
    _scratch: dict = dataclasses.field(init=False, compare=False, repr=False)

    def __post_init__(self):
        nx, ny = int(self.plan.nx), int(self.plan.ny)
        n_stub = int(np.asarray(self.plan.stub_rows_e).size)
        E = int(self.plan.Ex) + int(self.plan.Ey) + n_stub
        tables = {"edge_src": (self.edge_src, E), "edge_tgt": (self.edge_tgt, E),
                  "stub_rows": (self.stub_rows, n_stub), "stub_s_bif": (self.stub_s_bif, n_stub)}
        dev = self.edge_src.device
        if dev.type == "meta":
            raise ValueError("GridDevicePlan: tables must hold data (a meta tensor has none)")
        for name, (t, n) in tables.items():
            if t.device != dev:
                raise ValueError("GridDevicePlan: tables must share one device")
            if t.dtype != torch.int32 or tuple(t.shape) != (n,) or not t.is_contiguous():
                raise ValueError(f"GridDevicePlan: {name} must be a contiguous ({n},) int32 tensor, "
                                 f"got {t.dtype} {tuple(t.shape)}")
        if nx < 1 or ny < 1 or nx * ny >= 2**31 - GRID_THREADS:
            raise ValueError(f"GridDevicePlan: a {nx} x {ny} lattice is out of K17's range")
        object.__setattr__(self, "index", dev.index if dev.type == "cuda" else -1)
        object.__setattr__(self, "blocks", -(-nx * ny // GRID_THREADS))
        object.__setattr__(self, "_scratch", {})

    @property
    def nx(self) -> int:
        return self.plan.nx

    @property
    def ny(self) -> int:
        return self.plan.ny

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def num_bifurcations(self) -> int:
        return self.plan.nx * self.plan.ny

def device_grid_plan(plan: _GridPlan, device: torch.device | str) -> GridDevicePlan:
    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    src, tgt = grid_edge_ends(plan)
    return GridDevicePlan(plan=plan, edge_src=i32(src), edge_tgt=i32(tgt),
                          stub_rows=i32(plan.stub_rows_e), stub_s_bif=i32(plan.stub_s_bif))


@dataclasses.dataclass(frozen=True)
class DeviceLatticePlan:
    """The tables of the general DCT route and of the CG route on one device
    (public edge order), uploaded once per executor: what K8a and K9's
    ``lambda_system`` read (``start_bif``, ``end_bif``, the λ-system sum
    matrices and bins); with a shift plan, K6's class-weight gather matrix
    ``class_idx`` ``(C·B, K)`` and the host class ``offsets`` (int32,
    ascending, as the reference orders them); without one, the gather-fold
    matvec's ``mv_edge`` and ``mv_other`` ``(K, B)``
    (:func:`gather_matvec_tables`)."""

    start_bif: torch.Tensor
    end_bif: torch.Tensor
    t_idx: torch.Tensor
    t_bins: torch.Tensor
    s_idx: torch.Tensor
    s_bins: torch.Tensor
    class_idx: torch.Tensor | None
    offsets: np.ndarray | None
    num_bifurcations: int
    classes: list | None = None  # the host shift plan
    mv_edge: torch.Tensor | None = None
    mv_other: torch.Tensor | None = None
    # K6's plans (validated here, at upload): the bifurcation system's two
    # sides, and the class weights when there is a shift plan; K18's plan of
    # the general DCT route, which reads diag and rhs as the stride-2
    # columns of the interleaved (B, 2) system dr
    lambda_sums: typing.Any = dataclasses.field(init=False, compare=False, repr=False)
    class_sums: typing.Any = dataclasses.field(init=False, compare=False, repr=False)
    shift: typing.Any = dataclasses.field(init=False, compare=False, repr=False)

    def __post_init__(self):
        from .kernels.peel import lambda_sums
        from .kernels.segsum import SumPlan
        from .kernels.shift_matvec import ShiftPlan

        object.__setattr__(self, "lambda_sums", lambda_sums(self))
        object.__setattr__(self, "class_sums", None if self.class_idx is None
                           else SumPlan(((self.class_idx, None),), (1,)))
        object.__setattr__(self, "shift", None if self.offsets is None else ShiftPlan(
            self.offsets, self.num_bifurcations, self.start_bif.device, stride=2))

    @property
    def num_edges(self) -> int:
        return int(self.start_bif.shape[0])


def device_lattice_plan(asm, lam_plan, device: torch.device | str) -> DeviceLatticePlan:
    """Upload the tables; ``lam_plan`` is the assembler's
    :class:`.levels._LambdaPlan`.  The class tables when the graph has a
    shift plan, the gather-fold tables otherwise."""

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    mesh = asm.network
    B, E = mesh.num_multipliers, mesh.num_edges
    classes = _plan_shift_matvec(asm)
    lp = lam_plan
    mv = {}
    if classes is None:
        edge_idx, other_idx = gather_matvec_tables(_build_matvec_plan(asm), B)
        mv = {"mv_edge": i32(edge_idx), "mv_other": i32(other_idx)}
    return DeviceLatticePlan(
        start_bif=i32(asm._edge_start_bif),
        end_bif=i32(asm._edge_end_bif),
        t_idx=i32(segsum_matrix(lp.t_seg, lp.t_bins.size, E, sel=lp.t_sel)),
        t_bins=i32(lp.t_bins),
        s_idx=i32(segsum_matrix(lp.s_seg, lp.s_bins.size, E, sel=lp.s_sel)),
        s_bins=i32(lp.s_bins),
        class_idx=None if classes is None else i32(shift_class_matrix(classes, B, E)),
        offsets=None if classes is None else np.asarray([d for d, _, _ in classes], np.int32),
        num_bifurcations=B,
        classes=classes,
        **mv,
    )


def lattice_dct_plan(asm, R_mode: str | None = None) -> _DctPlan | None:
    """The DCT plan when the reference's exact separable-DCT lattice solve
    applies (a uniform rectangular lattice with scalar R), else None."""
    if asm.network.num_multipliers == 0:
        return None
    if R_mode is None:
        R_mode = asm.coefficient_modes()[0]
    if R_mode != "scalar":
        return None
    shift_plan = _plan_shift_matvec(asm)
    if shift_plan is None:
        return None
    return _plan_dct_lattice(asm, shift_plan)


def lattice_solve_applicable(asm) -> bool:
    """Would the reference's exact separable-DCT lattice solve engage?

    True when the multiplier graph is a uniform rectangular lattice
    (``make_grid`` family) and the resistance coefficient is scalar."""
    return lattice_dct_plan(asm) is not None
