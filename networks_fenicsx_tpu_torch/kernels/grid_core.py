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
eager transcriptions of the reference's slice adds, for CPU tensors; both
count on ``grid_core.launches`` (K17's calls: one assembly and three
stencils a solve).
"""

from __future__ import annotations

import torch

from ..lattice import GridDevicePlan
from . import build

__all__ = ["grid_core", "grid_core_plain", "grid_residual", "grid_residual_plain"]

THREADS = 256  # the kernels' block size: one partial sum per block


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


def _check(gdp: GridDevicePlan, *tensors) -> None:
    build.require_cuda("grid_core", *tensors)
    build.require_cuda("grid_core", gdp.stub_rows, gdp.stub_s_bif, dtype=torch.int32)


def grid_core(gdp: GridDevicePlan, w: torch.Tensor, const: torch.Tensor, Ftot: torch.Tensor):
    """K17's assembly on ``w``'s device: ``(rhs (B,), diag (B,), ‖rhs‖)``
    from the internal-order ``(E,)`` conductances, constants and sources."""
    if w.device.type == "cpu":
        return grid_core_plain(gdp, w, const, Ftot)
    _check(gdp, w, const, Ftot)
    E, B = gdp.num_edges, gdp.num_bifurcations
    if any(tuple(t.shape) != (E,) for t in (w, const, Ftot)):
        raise ValueError("grid_core: w, const and Ftot must be (E,)")
    dev, dt = w.device, torch.float64
    rhs = torch.empty(B, dtype=dt, device=dev)
    diag = torch.empty(B, dtype=dt, device=dev)
    partial = torch.empty((B + THREADS - 1) // THREADS, dtype=dt, device=dev)
    rhs_norm = torch.empty((), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_grid_assemble(
            gdp.nx, gdp.ny, int(gdp.stub_rows.shape[0]),
            w.data_ptr(), const.data_ptr(), Ftot.data_ptr(),
            gdp.stub_rows.data_ptr(), gdp.stub_s_bif.data_ptr(),
            rhs.data_ptr(), diag.data_ptr(), partial.data_ptr(), rhs_norm.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "grid_core")
    grid_core.launches += 1
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
    _check(gdp, w, diag, lam, rhs)
    B = gdp.num_bifurcations
    if tuple(w.shape) != (gdp.num_edges,) or any(tuple(t.shape) != (B,) for t in (diag, lam, rhs)):
        raise ValueError("grid_residual: w must be (E,) and diag, lam, rhs (B,)")
    dev, dt = lam.device, torch.float64
    res = torch.empty(B, dtype=dt, device=dev)
    partial = torch.empty((B + THREADS - 1) // THREADS, dtype=dt, device=dev) if norm else None
    out = torch.empty((), dtype=dt, device=dev) if norm else None
    with torch.cuda.device(dev):
        code = build.library().nxfx_grid_residual(
            gdp.nx, gdp.ny, w.data_ptr(), diag.data_ptr(), lam.data_ptr(), rhs.data_ptr(),
            res.data_ptr(), None if partial is None else partial.data_ptr(),
            None if out is None else out.data_ptr(), build.stream_handle(dev),
        )
    build.check(code, "grid_residual")
    grid_core.launches += 1
    return (res, out) if norm else res
