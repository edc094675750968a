"""K8a: element formation and condensation, four layouts (``csrc/edge_data.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_make_edge_data_uniform``
(``:394-436``), ``_make_edge_data_scalar`` / ``_make_edge_data_scalar_k``
(``:467-566``), ``_make_edge_data`` (``:569-619``) and the quadrature
einsums of the generic ``core`` (``:4289-4313``).

Inputs are the assembler's compact coefficients in public order (``R``,
``f``: ``(1,)`` scalar, ``(E,)`` per edge, ``(C,)`` per cell edge-major,
``(C, nq)`` quad) and ``h_e = |e| / N``; the layout follows from the
degree and the modes (:func:`..edge_data.edge_layout`); the output is an
:class:`..edge_data._EdgeData` with j-major per-cell arrays.

The kernel works on tiles of :data:`TILE_EDGES` consecutive edges, their
per-cell inputs staged in chunks of cells through shared memory;
:func:`edge_tile` picks the chunk, the warps and the shared bytes of a
launch on the host.  :func:`edge_data` launches the kernel for CUDA
tensors (one launch a call) and runs :func:`edge_data_plain`, an eager
transcription of the reference, for CPU tensors.

A sweep (:func:`..batch.solve_sweep` on the dense route and without
multipliers) forms S scenarios in one launch, :func:`edge_data_scenarios`:
each of ``R``, ``f``, ``start_pbc`` and ``end_pbc`` batched (a leading S) or
shared (read at stride 0), the plan :func:`edge_tile`'s for one scenario,
the outputs an :class:`..edge_data._EdgeData` whose per-scenario fields
carry a leading S (the fixed recovery matrix of the ``scalar_k`` layout and
the bifurcation tables stay shared).  Row ``i`` is :func:`edge_data` of row
``i`` bit for bit; :func:`edge_data_scenarios_plain` stacks
:func:`edge_data_plain`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..blocked import _condensed_scalar_constants
from ..edge_data import LAYOUTS, _EdgeData, edge_layout, elides_source
from ..levels import DeviceLevelPlan
from . import build

__all__ = ["edge_data", "edge_data_plain", "edge_tile", "EdgeTile", "COEFF_MODES", "TILE_EDGES",
           "SMEM_MAX", "edge_data_scenarios", "edge_data_scenarios_plain", "MAX_GRID_Y"]

COEFF_MODES = {"scalar": 0, "edge": 1, "cell": 2, "quad": 3}
TILE_EDGES = 32  # edges of a tile: a warp's lanes (csrc: TILE)
MAX_ROWS = 8  # warps of a block (csrc: MAX_ROWS)
STAGES = 3  # chunks in flight, the ring's slots (csrc: STAGES)
CHAIN = 3  # doubles a cell and edge left for the chain (csrc: CHAIN)
SMEM_MAX = 232_448  # the shared bytes a block may use on the H100 (227 KB)
SMEM_TARGET = 100 * 1024  # a tile plan's bytes, at most, with its scratch in shared memory
UNIFORM_THREADS = 128  # the uniform layout and short edges: a thread an edge (csrc: THREADS)
CHUNK_DOUBLES = 64  # a chunk's staged doubles an edge, about
DIRECT_DOUBLES = 16  # an edge's inputs, at most, read by a thread an edge (no Cholesky)
MAX_GRID_Y = 65_535  # rows of blocks over the scenarios, at most (the grid's y limit)


@dataclasses.dataclass(frozen=True)
class EdgeTile:
    """A K8a launch: ``blocks`` tiles of ``edges`` edges (the last one
    partial), each a block of ``rows`` warps; a tile's per-cell inputs
    staged ``cells`` cells a chunk, ``widths`` doubles a cell of R and of f
    (0: read from device memory), each edge's row ``pitches`` doubles
    apart; the interior factor's scratch ``"shared"``, ``"global"`` or
    ``"none"``; ``smem`` the dynamic shared bytes of a block.  The uniform
    layout and short edges are a thread an edge (``rows`` 0, no shared
    memory: :attr:`direct`)."""

    layout: str
    edges: int
    cells: int
    rows: int
    blocks: int
    widths: tuple
    pitches: tuple
    scratch: str
    smem: int

    @property
    def direct(self) -> bool:
        return self.rows == 0

    @property
    def threads(self) -> int:
        """Threads a block."""
        return UNIFORM_THREADS if self.direct else self.edges * self.rows


def _odd(n: int) -> int:
    """``n`` doubles rounded up to an odd count (0 stays 0): rows an odd
    number of doubles apart put 32 lanes on 32 banks."""
    return n | 1 if n else 0


def _tile_bytes(k: int, cells: int, rows: int, pitches: tuple, shared_scratch: bool) -> int:
    n = k - 1
    doubles = (STAGES * TILE_EDGES * sum(pitches) + CHAIN * cells * TILE_EDGES
               + (n * n * TILE_EDGES * rows if shared_scratch else 0))
    return 8 * doubles


@functools.lru_cache(maxsize=256)
def edge_tile(E: int, N: int, k: int, nq: int, modes: tuple, elide: bool = False) -> EdgeTile:
    """The launch of K8a on ``E`` edges of ``N`` cells at degree ``k`` with
    ``nq`` quadrature points and ``modes = (R_mode, f_mode)`` (``elide``:
    the source is not read).  The uniform layout, and edges whose inputs
    are at most :data:`DIRECT_DOUBLES` without an interior Cholesky, are a
    thread an edge.  Otherwise R and f in cell or quad mode are staged; a
    chunk holds at least a cell a warp and about :data:`CHUNK_DOUBLES`
    doubles an edge, so the bytes do not grow with N.  Warps are taken away
    (8, 4, 2, 1; never more than the chunk's cells) until the bytes with
    the interior factor in shared memory are within :data:`SMEM_TARGET`;
    past that the factor goes to device scratch, the chunk shrinks, and
    past a chunk of one cell the inputs are read from device memory.  Every
    N and k has a plan; it raises only if the bytes exceed
    :data:`SMEM_MAX`, which these rules do not reach."""
    if E < 0 or N < 1 or k < 1 or nq < 1:
        raise ValueError(f"edge_tile: N, k, nq must be positive and E not negative, got {(E, N, k, nq)}")
    R_mode, f_mode = modes
    layout = edge_layout(k, R_mode, f_mode)
    width = {"cell": 1, "quad": nq}
    widths = (width.get(R_mode, 0), 0 if elide else width.get(f_mode, 0))
    w = sum(widths)
    scratch = "shared" if layout == "general" and k >= 2 else "none"
    if layout == "uniform" or (scratch == "none" and N * w <= DIRECT_DOUBLES):
        return EdgeTile(layout, 1, N, 0, -(-E // UNIFORM_THREADS), (0, 0), (0, 0), "none", 0)

    def plan(rows, cells, ws, where):
        pitches = tuple(_odd(x * cells) for x in ws)
        return EdgeTile(layout, TILE_EDGES, cells, rows, -(-E // TILE_EDGES), ws, pitches, where,
                        _tile_bytes(k, cells, rows, pitches, where == "shared"))

    def chunk(rows):
        return min(N, max(rows, -(-CHUNK_DOUBLES // w))) if w else min(N, 32)

    for rows in (8, 4, 2, 1):
        rows = min(rows, chunk(rows))
        t = plan(rows, chunk(rows), widths, scratch)
        if t.smem <= SMEM_TARGET:
            return t
    if scratch == "shared":
        scratch = "global"
    cells = chunk(MAX_ROWS)
    while True:
        t = plan(min(MAX_ROWS, cells), cells, widths, scratch)
        if t.smem <= SMEM_TARGET or cells == 1:
            break
        cells = max(1, cells // 2)
    if t.smem > SMEM_TARGET:
        t = plan(min(MAX_ROWS, chunk(MAX_ROWS)), min(N, 32), (0, 0), scratch)
    if t.smem > SMEM_MAX:
        raise ValueError(f"edge_tile: {t.smem} shared bytes a block exceed the card's {SMEM_MAX}")
    return t


def _fold(terms):
    """Left-to-right sum of a sequence of tensors (the kernels' order)."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def quad_table(quad_w: torch.Tensor, quad_phi: torch.Tensor) -> torch.Tensor:
    """``w_q φ_qi φ_qj``, ``(nq, k+1, k+1)``: the element-mass integrand."""
    return (quad_w[:, None, None] * quad_phi[:, :, None] * quad_phi[:, None, :]).contiguous()


def edge_data_plain(
    dlp: DeviceLevelPlan,
    N: int,
    k: int,
    h_e: torch.Tensor,
    quad_w: torch.Tensor,
    quad_phi: torch.Tensor,
    R: torch.Tensor,
    f: torch.Tensor,
    R_mode: str,
    f_mode: str,
    f_is_zero: bool,
    start_pbc: torch.Tensor,
    end_pbc: torch.Tensor,
) -> _EdgeData:
    """Eager version: the reference's layout functions, outputs j-major.

    Every sum over quadrature points and along an edge's cells is taken
    left to right, as the kernel takes it, instead of by ``einsum``,
    ``sum`` or ``cumsum`` in the backend's order; the values are the
    reference's up to that order."""
    layout = edge_layout(k, R_mode, f_mode)
    dt, dev = torch.float64, h_e.device
    E = h_e.shape[0]
    nq = k + 1
    bifs = dict(start_bif=dlp.start_bif, end_bif=dlp.end_bif, start_pbc=start_pbc, end_pbc=end_pbc)
    if layout == "uniform":
        R_e = R[0] * torch.ones(E, dtype=dt, device=dev) if R_mode == "scalar" else R
        f_e = f[0] * torch.ones(E, dtype=dt, device=dev) if f_mode == "scalar" else f
        a = R_e * h_e
        F = f_e * h_e
        W = a * N
        Ftot = F * N
        g = a * F * (N * N / 2.0)
        return _EdgeData(mt=None, cumF=Ftot[None, :], W=W, g=g, interior=(), ua=a, uF=F, **bifs)

    h = h_e.repeat_interleave(N)  # cell_h, public cell order
    C = h.shape[0]
    if f_mode == "quad":
        cell_f_int = _fold([f[:, q] * quad_w[q] for q in range(nq)]) * h
    elif f_mode == "scalar":
        cell_f_int = f[0] * h
    elif f_mode == "edge":
        cell_f_int = f.repeat_interleave(N) * h
    else:
        cell_f_int = f * h

    def chain(F2):  # (E, N) cell integrals -> [cumF_0 .. cumF_N], each (E,)
        cum = [torch.zeros(E, dtype=dt, device=dev)]
        for c in range(N):
            cum.append(cum[-1] + F2[:, c])
        return cum

    if layout == "general":
        wphi = quad_table(quad_w, quad_phi)
        cell_mass = _fold([R[:, q, None, None] * wphi[q] for q in range(nq)]) * h[:, None, None]
        if k == 1:
            mt = cell_mass
            interior: tuple = ()
        else:
            ends = torch.tensor([0, k], device=dev)
            ints = torch.arange(1, k, device=dev)
            M_EE = cell_mass[:, ends][:, :, ends]
            M_EI = cell_mass[:, ends][:, :, ints]
            M_IE = cell_mass[:, ints][:, :, ends]
            M_II = cell_mass[:, ints][:, :, ints]
            L = torch.linalg.cholesky(M_II)
            Minv_IE = torch.cholesky_solve(M_IE, L)
            mt = M_EE - _fold([M_EI[:, :, i, None] * Minv_IE[:, None, i, :] for i in range(k - 1)])
            interior = (Minv_IE.reshape(E, N, k - 1, 2).permute(1, 2, 3, 0).contiguous(),)
        mt = mt.reshape(E, N, 2, 2)
        cum = chain(cell_f_int.reshape(E, N))
        col0 = mt[:, :, 0, 0] + mt[:, :, 1, 0]  # column sums of each cell's mt
        col1 = mt[:, :, 0, 1] + mt[:, :, 1, 1]
        W = _fold([col0[:, c] + col1[:, c] for c in range(N)])
        g = _fold([col0[:, c] * cum[c] + col1[:, c] * cum[c + 1] for c in range(N)])
        return _EdgeData(
            mt=mt.permute(1, 2, 3, 0).contiguous(), cumF=torch.stack(cum), W=W, g=g,
            interior=interior, **bifs,
        )

    if R_mode == "scalar":
        R_cells = R[0] * torch.ones(C, dtype=dt, device=dev)
    elif R_mode == "edge":
        R_cells = R.repeat_interleave(N)
    else:
        R_cells = R
    a = (R_cells * h).reshape(E, N)
    if layout == "scalar":
        W = _fold([a[:, c] for c in range(N)])
        interior = ()
    else:
        _, csum, wt, Minv = _condensed_scalar_constants(k)
        W = wt * _fold([a[:, c] for c in range(N)])
        interior = (torch.as_tensor(np.asarray(Minv, dtype=np.float64), device=dev),)
    if elides_source(layout, f_is_zero):
        cumF = torch.zeros((N + 1, E), dtype=dt, device=dev)
        g = torch.zeros(E, dtype=dt, device=dev)
    else:
        cum = chain(cell_f_int.reshape(E, N))
        cumF = torch.stack(cum)
        if layout == "scalar":
            g = 0.5 * _fold([a[:, c] * (cum[c] + cum[c + 1]) for c in range(N)])
        else:
            c0, c1 = float(csum[0]), float(csum[1])
            g = _fold([a[:, c] * (c0 * cum[c] + c1 * cum[c + 1]) for c in range(N)])
    return _EdgeData(
        mt=None, cumF=cumF, W=W, g=g, interior=interior, rh=a.T.contiguous(), **bifs,
    )


@functools.lru_cache(maxsize=None)
def _fixed_recovery(k: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(
        np.ascontiguousarray(_condensed_scalar_constants(k)[3], dtype=np.float64), device=device
    )


def edge_data(
    dlp: DeviceLevelPlan,
    N: int,
    k: int,
    h_e: torch.Tensor,
    quad_w: torch.Tensor,
    quad_phi: torch.Tensor,
    R: torch.Tensor,
    f: torch.Tensor,
    R_mode: str,
    f_mode: str,
    f_is_zero: bool,
    start_pbc: torch.Tensor,
    end_pbc: torch.Tensor,
) -> _EdgeData:
    """K8a on ``h_e``'s device, one launch (:func:`edge_tile`'s plan).
    ``quad_w (nq,)`` and ``quad_phi (nq, k+1)`` are the assembler's Gauss
    rule; the kernel forms ``w_q φ_qi φ_qj`` as :func:`quad_table` rounds
    it."""
    if h_e.device.type == "cpu":
        return edge_data_plain(
            dlp, N, k, h_e, quad_w, quad_phi, R, f, R_mode, f_mode, f_is_zero, start_pbc, end_pbc
        )
    build.require_cuda("edge_data", h_e, R, f, start_pbc, end_pbc)
    E = dlp.num_edges
    expect = _input_shapes(E, N, k, R_mode, f_mode)
    for label, t, mode in (("R", R, R_mode), ("f", f, f_mode)):
        if tuple(t.shape) != expect[label]:
            raise ValueError(f"edge_data: {label} of mode {mode!r} has shape {tuple(t.shape)}")
    if any(tuple(t.shape) != (E,) for t in (h_e, start_pbc, end_pbc)):
        raise ValueError("edge_data: h_e and the boundary data must be (E,)")
    ed = _launch(dlp, N, k, h_e, quad_w, quad_phi, R, f, R_mode, f_mode, f_is_zero, start_pbc,
                 end_pbc, None)
    edge_data.launches += 1
    return ed


edge_data.launches = 0


def _input_shapes(E: int, N: int, k: int, R_mode: str, f_mode: str) -> dict:
    """A scenario's shapes of the inputs (what each is when shared)."""
    C = E * N
    expect = {"scalar": (1,), "edge": (E,), "cell": (C,), "quad": (C, k + 1)}
    return {"R": expect[R_mode], "f": expect[f_mode], "sp": (E,), "ep": (E,)}


def _launch(dlp, N, k, h_e, quad_w, quad_phi, R, f, R_mode, f_mode, f_is_zero, start_pbc,
            end_pbc, S):
    """K8a's launch on checked inputs: one scenario (``S`` None) or ``S``
    scenarios (R and f batched or shared; outputs with a leading S)."""
    layout = edge_layout(k, R_mode, f_mode)
    build.require_cuda("edge_data", dlp.start_bif, dlp.end_bif, dtype=torch.int32)
    E = dlp.num_edges
    nq = k + 1
    lead = () if S is None else (S,)
    dev = h_e.device
    dt = torch.float64
    build.require_cuda("edge_data", quad_w, quad_phi)
    if tuple(quad_w.shape) != (nq,) or tuple(quad_phi.shape) != (nq, k + 1):
        raise ValueError("edge_data: quad_w must be (k+1,) and quad_phi (k+1, k+1)")
    wt, cs0, cs1 = 1.0, 0.5, 0.5
    if layout == "scalar_k":
        _, csum, wt, _ = _condensed_scalar_constants(k)
        cs0, cs1 = float(csum[0]), float(csum[1])
    elide = elides_source(layout, f_is_zero)
    tile = edge_tile(E, N, k, nq, (R_mode, f_mode), elide)
    # rows of blocks over the scenarios (each walks y, y + gy, ...); device
    # scratch of the interior factor holds a set a row, so it takes few
    gy = 1 if S is None else min(S, MAX_GRID_Y if tile.scratch != "global" else 8)
    empty = torch.empty(0, dtype=dt, device=dev)
    W = torch.empty(lead + (E,), dtype=dt, device=dev)
    g = torch.empty(lead + (E,), dtype=dt, device=dev)
    mt = minv = work = rh = ua = uF = empty
    interior: tuple = ()
    if layout == "uniform":
        cumF = torch.empty(lead + (1, E), dtype=dt, device=dev)
        ua = torch.empty(lead + (E,), dtype=dt, device=dev)
        uF = torch.empty(lead + (E,), dtype=dt, device=dev)
    else:
        cumF = torch.empty(lead + (N + 1, E), dtype=dt, device=dev)
    if layout == "general":
        mt = torch.empty(lead + (N, 2, 2, E), dtype=dt, device=dev)
        if k > 1:
            minv = torch.empty(lead + (N, k - 1, 2, E), dtype=dt, device=dev)
            if tile.scratch == "global":
                work = torch.empty((k - 1) ** 2 * tile.blocks * tile.threads * gy, dtype=dt,
                                   device=dev)
            interior = (minv,)
    elif layout in ("scalar", "scalar_k"):
        rh = torch.empty(lead + (N, E), dtype=dt, device=dev)
        if layout == "scalar_k":
            interior = (_fixed_recovery(k, dev),)
    args = (
        LAYOUTS.index(layout), E, N, k, nq, tile.cells, tile.rows, tile.widths[0],
        tile.pitches[0], tile.widths[1], tile.pitches[1], int(tile.scratch == "shared"),
        h_e.data_ptr(), R.data_ptr(), COEFF_MODES[R_mode],
        f.data_ptr(), COEFF_MODES[f_mode], int(elide),
        quad_w.data_ptr(), quad_phi.data_ptr(), float(wt), cs0, cs1,
        mt.data_ptr(), minv.data_ptr(), work.data_ptr() if work.numel() else None,
        cumF.data_ptr(),
        W.data_ptr(), g.data_ptr(), rh.data_ptr(), ua.data_ptr(), uF.data_ptr(),
    )
    shapes = _input_shapes(E, N, k, R_mode, f_mode)
    with torch.cuda.device(dev):
        if S is None:
            code = build.library().nxfx_edge_data(*args, build.stream_handle(dev))
        else:
            code = build.library().nxfx_edge_data_scen(
                *args, S, gy, build.scenario_stride(R, shapes["R"]),
                build.scenario_stride(f, shapes["f"]), build.stream_handle(dev))
    build.check(code, "edge_data" if S is None else "edge_data_scenarios")
    return _EdgeData(
        mt=mt if layout == "general" else None,
        cumF=cumF, W=W, g=g,
        start_bif=dlp.start_bif, end_bif=dlp.end_bif, start_pbc=start_pbc, end_pbc=end_pbc,
        interior=interior,
        rh=rh if layout in ("scalar", "scalar_k") else None,
        ua=ua if layout == "uniform" else None,
        uF=uF if layout == "uniform" else None,
    )


def edge_data_scenarios_plain(dlp, N, k, h_e, quad_w, quad_phi, R, f, R_mode, f_mode, f_is_zero,
                              start_pbc, end_pbc) -> _EdgeData:
    """Eager version of :func:`edge_data_scenarios`: :func:`edge_data_plain` a
    scenario, its per-scenario fields stacked."""
    shapes = _input_shapes(dlp.num_edges, N, k, R_mode, f_mode)
    ins = {"R": R, "f": f, "sp": start_pbc, "ep": end_pbc}
    S = build.scenarios("edge_data_scenarios", *((t, shapes[n]) for n, t in ins.items()))
    rows = []
    for i in range(S):
        r = {n: build.scenario_row(t, shapes[n], i) for n, t in ins.items()}
        rows.append(edge_data_plain(dlp, N, k, h_e, quad_w, quad_phi, r["R"], r["f"], R_mode,
                                    f_mode, f_is_zero, r["sp"], r["ep"]))
    return _stack_rows(rows, start_pbc, end_pbc)


def _stack_rows(rows, start_pbc, end_pbc) -> _EdgeData:
    first = rows[0]

    def stack(name):
        v = getattr(first, name)
        return None if v is None else torch.stack([getattr(r, name) for r in rows])

    per_cell = bool(first.interior) and first.interior[0].dim() == 4
    interior = ((torch.stack([r.interior[0] for r in rows]),) if per_cell else first.interior)
    return _EdgeData(mt=stack("mt"), cumF=stack("cumF"), W=stack("W"), g=stack("g"),
                     start_bif=first.start_bif, end_bif=first.end_bif, start_pbc=start_pbc,
                     end_pbc=end_pbc, interior=interior, rh=stack("rh"), ua=stack("ua"),
                     uF=stack("uF"))


def edge_data_scenarios(dlp, N, k, h_e, quad_w, quad_phi, R, f, R_mode, f_mode, f_is_zero,
                        start_pbc, end_pbc) -> _EdgeData:
    """K8a of S scenarios on ``h_e``'s device in one launch: each of ``R``,
    ``f``, ``start_pbc``, ``end_pbc`` batched, ``(S,) +`` its one-scenario
    shape, or shared.  Returns an :class:`_EdgeData` whose per-scenario
    fields carry a leading S (``start_pbc``, ``end_pbc`` as given); row ``i``
    is :func:`edge_data` of row ``i`` bit for bit."""
    if h_e.device.type == "cpu":
        return edge_data_scenarios_plain(dlp, N, k, h_e, quad_w, quad_phi, R, f, R_mode, f_mode,
                                         f_is_zero, start_pbc, end_pbc)
    E = dlp.num_edges
    shapes = _input_shapes(E, N, k, R_mode, f_mode)
    ins = {"R": R, "f": f, "sp": start_pbc, "ep": end_pbc}
    S = build.scenarios("edge_data_scenarios", *((t, shapes[n]) for n, t in ins.items()))
    build.require_cuda("edge_data_scenarios", h_e, R, f, start_pbc, end_pbc)
    if tuple(h_e.shape) != (E,):
        raise ValueError("edge_data_scenarios: h_e must be (E,)")
    ed = _launch(dlp, N, k, h_e, quad_w, quad_phi, R, f, R_mode, f_mode, f_is_zero, start_pbc,
                 end_pbc, S)
    edge_data_scenarios.launches += 1
    return ed


edge_data_scenarios.launches = 0
