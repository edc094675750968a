"""K17: the Schur system of the lattice grid route (``csrc/grid_core.cu``).

Replaces the per-solve body of ``networks_fenicsx_tpu/solver.py:
_grid_blocked_core`` (``:1208-1298``) between K1's condensation and K5's
expansion, in the grid plan's internal edge order
(:func:`..lattice._plan_grid_layout`: x-edges, y-edges, stubs):

* :func:`grid_core` — the 2-D assembly of ``rhs`` and ``diag`` (ny·nx,)
  from K1's ``(w, const, Ftot)`` plus the stub adds, and ``‖rhs‖``;
* :func:`grid_residual` — the 5-point stencil ``res = rhs − L λ`` that the
  refinement passes and the final residual use, optionally with ``‖res‖``.

Both launch the kernels for CUDA tensors and run their plain versions,
eager transcriptions of the reference's slice adds, for CPU tensors.  On
CUDA each call is one launch, its norm finished inside it, on a lean path:
the plan (a :class:`..lattice.GridDevicePlan`) was validated once where it
was uploaded, so a call checks only its float64 tensors (device, dtype,
shape, contiguity, in one pass), reads the raw stream, enters the device
only when it is not already current, and takes its partial sums and ticket
from the plan's scratch of the calling stream.  Outputs are fresh tensors.
Both count on ``grid_core.launches``: :func:`cuda_launches` a grid-route
solve (one assembly and three stencils).

Over a scenario axis (a lattice sweep, ``GridFactorization.solve_batch``),
:func:`grid_core_scenarios` and :func:`grid_residual_scenarios` take S
scenarios in one launch each, every input batched (a leading ``S``) or
shared (the conductances and the diagonal of one R), each scenario's norm
with its own partials and ticket (:func:`.build.norm_scratch`); row ``i``
is the one-scenario call's bits on row ``i``.  Each counts its own calls.
"""

from __future__ import annotations

import ctypes

import torch

from ..lattice import GridDevicePlan
from . import build

__all__ = [
    "grid_core", "grid_core_plain", "grid_residual", "grid_residual_plain", "cuda_launches",
    "grid_core_scenarios", "grid_core_scenarios_plain", "grid_residual_scenarios",
    "grid_residual_scenarios_plain",
]


def _views(gdp: GridDevicePlan):
    nx, ny = gdp.nx, gdp.ny
    Ex, Ey = ny * (nx - 1), (ny - 1) * nx

    def x2d(v):
        return v[:Ex].reshape(ny, nx - 1)

    def y2d(v):
        return v[Ex : Ex + Ey].reshape(ny - 1, nx)

    return x2d, y2d, Ex + Ey


def grid_core_plain(gdp: GridDevicePlan, w: torch.Tensor, const: torch.Tensor, Ftot: torch.Tensor):
    """Eager version: ``(rhs (B,), diag (B,), ‖rhs‖)``."""
    nx, ny = gdp.nx, gdp.ny
    x2d, y2d, tail = _views(gdp)
    cF = const + Ftot
    rhs2 = torch.zeros((ny, nx), dtype=torch.float64, device=w.device)
    rhs2[:, 1:] += x2d(cF)
    rhs2[:, : nx - 1] += -x2d(const)
    rhs2[1:, :] += y2d(cF)
    rhs2[: ny - 1, :] += -y2d(const)
    wx2, wy2 = x2d(w), y2d(w)
    diag2 = torch.zeros((ny, nx), dtype=torch.float64, device=w.device)
    diag2[:, : nx - 1] += wx2
    diag2[:, 1:] += wx2
    diag2[: ny - 1, :] += wy2
    diag2[1:, :] += wy2
    rhs, diag = rhs2.reshape(-1), diag2.reshape(-1)
    rows = gdp.plan.stub_rows_e.tolist()
    s_bif = gdp.plan.stub_s_bif.tolist()
    for t, (row, s) in enumerate(zip(rows, s_bif)):
        rhs[row] += -const[tail + t] if s else cF[tail + t]
    for t, row in enumerate(rows):
        diag[row] += w[tail + t]
    return rhs, diag, torch.linalg.norm(rhs)


def grid_residual_plain(
    gdp: GridDevicePlan, w: torch.Tensor, diag: torch.Tensor, lam: torch.Tensor,
    rhs: torch.Tensor, norm: bool = False,
):
    """Eager version: ``res = rhs − L λ`` (and ``‖res‖`` with ``norm``)."""
    nx, ny = gdp.nx, gdp.ny
    x2d, y2d, _ = _views(gdp)
    wx2, wy2 = x2d(w), y2d(w)
    l2 = lam.reshape(ny, nx)
    out = diag.reshape(ny, nx) * l2
    out[:, : nx - 1] += -wx2 * l2[:, 1:]
    out[:, 1:] += -wx2 * l2[:, : nx - 1]
    out[: ny - 1, :] += -wy2 * l2[1:, :]
    out[1:, :] += -wy2 * l2[: ny - 1, :]
    res = rhs - out.reshape(-1)
    return (res, torch.linalg.norm(res)) if norm else res


def cuda_launches(n_refine: int = 2) -> int:
    """K17's launches in one grid-route solve with ``n_refine`` refinement
    passes: the assembly, a stencil a refinement pass and the final
    residual with its norm (one launch a call)."""
    return 2 + n_refine


class _GridArgs(ctypes.Structure):
    """``GridArgs`` of ``csrc/grid_core.cu``: a plan's lattice and one calling
    stream's scratch."""

    _fields_ = [("nx", ctypes.c_int), ("ny", ctypes.c_int), ("n_stub", ctypes.c_int),
                ("stub_rows", ctypes.c_void_p), ("stub_s_bif", ctypes.c_void_p),
                ("partial", ctypes.c_void_p), ("ticket", ctypes.c_void_p)]


def _args(gdp: GridDevicePlan, stream: int) -> int:
    """The address of the plan's :class:`_GridArgs` on CUDA stream
    ``stream``, made at the stream's first call: the scratch (``blocks``
    float64 partial sums of squares, then the ticket word) zeroed on that
    stream.  The kernels leave the ticket at 0, so it is never cleared again."""
    entry = gdp._scratch.get(stream)
    if entry is None:
        buf = torch.zeros(gdp.blocks + 1, dtype=torch.float64, device=gdp.stub_rows.device)
        args = _GridArgs(gdp.nx, gdp.ny, int(gdp.stub_rows.shape[0]), gdp.stub_rows.data_ptr(),
                         gdp.stub_s_bif.data_ptr(), buf.data_ptr(), buf.data_ptr() + 8 * gdp.blocks)
        entry = gdp._scratch[stream] = (ctypes.addressof(args), args, buf)
    return entry[0]


def _launch(index: int, fn, *args) -> None:
    """``fn(*args)`` on device ``index``, counted."""
    code = build.on_device(index, fn, *args)
    if code:
        build.check(code, "grid_core")
    grid_core.launches += 1


def grid_core(gdp: GridDevicePlan, w: torch.Tensor, const: torch.Tensor, Ftot: torch.Tensor):
    """K17's assembly on ``w``'s device: ``(rhs (B,), diag (B,), ‖rhs‖)``
    from the internal-order ``(E,)`` conductances, constants and sources."""
    if w.device.type == "cpu":
        return grid_core_plain(gdp, w, const, Ftot)
    index, E, B = gdp.index, gdp.num_edges, gdp.num_bifurcations
    build.require_vectors("grid_core", index, (w, E), (const, E), (Ftot, E))
    rhs, diag, rhs_norm = w.new_empty(B), w.new_empty(B), w.new_empty(())
    stream = build.raw_stream(index)
    _launch(index, build.library().nxfx_grid_assemble, _args(gdp, stream), w.data_ptr(),
            const.data_ptr(), Ftot.data_ptr(), rhs.data_ptr(), diag.data_ptr(), rhs_norm.data_ptr(),
            stream)
    return rhs, diag, rhs_norm


grid_core.launches = 0


def grid_residual(
    gdp: GridDevicePlan, w: torch.Tensor, diag: torch.Tensor, lam: torch.Tensor,
    rhs: torch.Tensor, norm: bool = False,
):
    """K17's stencil on ``lam``'s device: ``res = rhs − L λ`` (B,), and with
    ``norm`` also ``‖res‖``; counted on ``grid_core.launches``."""
    if lam.device.type == "cpu":
        return grid_residual_plain(gdp, w, diag, lam, rhs, norm)
    index, B = gdp.index, gdp.num_bifurcations
    build.require_vectors("grid_residual", index, (w, gdp.num_edges), (diag, B), (lam, B), (rhs, B))
    res = lam.new_empty(B)
    out = lam.new_empty(()) if norm else None
    stream = build.raw_stream(index)
    _launch(index, build.library().nxfx_grid_residual, _args(gdp, stream), w.data_ptr(),
            diag.data_ptr(), lam.data_ptr(), rhs.data_ptr(), res.data_ptr(),
            out.data_ptr() if norm else None, stream)
    return (res, out) if norm else res


# ------------------------------------------------------------------ scenarios


class _GridStrides(ctypes.Structure):
    """``GridStrides`` of ``csrc/grid_core.cu``: elements between two
    scenarios' rows of each input (0: shared)."""

    _fields_ = [(n, ctypes.c_longlong) for n in ("w", "cst", "F", "diag", "lam", "rhs")]


def _rows(gdp: GridDevicePlan):
    return (gdp.num_edges,), (gdp.num_bifurcations,)


def grid_core_scenarios_plain(gdp: GridDevicePlan, w, const, Ftot, norm: bool = True):
    """Eager version of :func:`grid_core_scenarios`: :func:`grid_core_plain`
    a scenario, stacked (``diag`` of the first row when ``w`` is shared)."""
    e, _ = _rows(gdp)
    S = build.scenarios("grid_core_scenarios", (w, e), (const, e), (Ftot, e))
    rows = [grid_core_plain(gdp, *(build.scenario_row(t, e, i) for t in (w, const, Ftot)))
            for i in range(S)]
    rhs, diag, nrm = (torch.stack(t) for t in zip(*rows))
    return rhs, diag if build.batched(w, e) else diag[0], nrm if norm else None


def grid_core_scenarios(gdp: GridDevicePlan, w, const, Ftot, norm: bool = True):
    """K17's assembly of S scenarios on ``w``'s device, one launch: ``w``,
    ``const``, ``Ftot`` each ``(S, E)`` or shared ``(E,)``; returns ``rhs (S,
    B)``, ``diag`` (``(S, B)``, or ``(B,)`` for a shared ``w``) and, with
    ``norm``, ``‖rhs‖ (S,)`` (else None)."""
    if w.device.type == "cpu":
        return grid_core_scenarios_plain(gdp, w, const, Ftot, norm)
    name, (e, b) = "grid_core_scenarios", _rows(gdp)
    S = build.scenarios(name, (w, e), (const, e), (Ftot, e))
    index, B = gdp.index, b[0]
    build.require_cuda(name, w, const, Ftot)
    if w.get_device() != index:
        raise ValueError(f"{name}: tensors must be on CUDA device {index}")
    w_rows = build.batched(w, e)
    rhs = w.new_empty((S, B))
    diag = w.new_empty((S, B) if w_rows else (B,))
    nrm = w.new_empty(S) if norm else None
    st = _GridStrides(w=build.scenario_stride(w, e), cst=build.scenario_stride(const, e),
                      F=build.scenario_stride(Ftot, e), diag=B if w_rows else 0)
    stream = build.raw_stream(index)
    partial, tickets = build.norm_scratch(gdp._scratch, stream, index, S, gdp.blocks)
    code = build.on_device(index, build.library().nxfx_grid_assemble_scen, _args(gdp, stream), S,
                           ctypes.addressof(st), w.data_ptr(), const.data_ptr(), Ftot.data_ptr(),
                           rhs.data_ptr(), diag.data_ptr(), None if nrm is None else nrm.data_ptr(),
                           partial, tickets, stream)
    if code:
        build.check(code, name)
    grid_core_scenarios.launches += 1
    return rhs, diag, nrm


grid_core_scenarios.launches = 0


def grid_residual_scenarios_plain(gdp: GridDevicePlan, w, diag, lam, rhs, norm: bool = False):
    """Eager version of :func:`grid_residual_scenarios`:
    :func:`grid_residual_plain` a scenario, stacked."""
    e, b = _rows(gdp)
    ins = ((w, e), (diag, b), (lam, b), (rhs, b))
    S = build.scenarios("grid_residual_scenarios", *ins)
    rows = [grid_residual_plain(gdp, *(build.scenario_row(t, base, i) for t, base in ins), norm)
            for i in range(S)]
    if not norm:
        return torch.stack(rows)
    res, nrm = (torch.stack(t) for t in zip(*rows))
    return res, nrm


def grid_residual_scenarios(gdp: GridDevicePlan, w, diag, lam, rhs, norm: bool = False):
    """K17's stencil over S scenarios on ``lam``'s device, one launch: ``res
    (S, B) = rhs − L λ`` (and with ``norm`` also ``‖res‖ (S,)``); ``w`` ``(S,
    E)`` or shared ``(E,)``, ``diag``, ``lam``, ``rhs`` ``(S, B)`` or shared
    ``(B,)``."""
    if lam.device.type == "cpu":
        return grid_residual_scenarios_plain(gdp, w, diag, lam, rhs, norm)
    name, (e, b) = "grid_residual_scenarios", _rows(gdp)
    ins = ((w, e), (diag, b), (lam, b), (rhs, b))
    S = build.scenarios(name, *ins)
    index, B = gdp.index, b[0]
    build.require_cuda(name, w, diag, lam, rhs)
    if lam.get_device() != index:
        raise ValueError(f"{name}: tensors must be on CUDA device {index}")
    res = lam.new_empty((S, B))
    nrm = lam.new_empty(S) if norm else None
    sw, sd, sl, sr = (build.scenario_stride(t, base) for t, base in ins)
    st = _GridStrides(w=sw, diag=sd, lam=sl, rhs=sr)
    stream = build.raw_stream(index)
    partial, tickets = build.norm_scratch(gdp._scratch, stream, index, S, gdp.blocks)
    code = build.on_device(index, build.library().nxfx_grid_residual_scen, _args(gdp, stream), S,
                           ctypes.addressof(st), w.data_ptr(), diag.data_ptr(), lam.data_ptr(),
                           rhs.data_ptr(), res.data_ptr(), None if nrm is None else nrm.data_ptr(),
                           partial, tickets, stream)
    if code:
        build.check(code, name)
    grid_residual_scenarios.launches += 1
    return (res, nrm) if norm else res


grid_residual_scenarios.launches = 0
