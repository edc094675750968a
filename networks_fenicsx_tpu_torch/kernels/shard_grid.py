"""K22b: the per-strip body of the strip-sharded lattice solve (``csrc/shard_grid.cu``).

Replaces ``networks_fenicsx_tpu/parallel/grid_sharded.py:_make_grid_local_body``
(``:247-391``) between the strip's K1 and K5:

* :func:`window` — the strip's row of the reduce: its ``(h+1, nx)`` rhs and
  diag windows by index arithmetic on its x- and y-edge slots, its stubs
  added per window cell, then ``wx, wy`` (shard 0's representative
  conductances, 0 on the other strips) and the stub groups' ``w_r (r,)``
  (``:279-335``): ``[rhs | diag | wx, wy | w_r]``;
* :func:`fill` — after the reduce, the lattice's uniform per-edge
  conductances (``wx`` on the x-edges, ``wy`` on the y-edges, 0 at the
  stubs), which K17's stencil takes as the matvec of the replicated DCT
  solve (``:337-346``).

The λ window and the λ → edge ends (``:348-360``) are index arithmetic that
K5 reads from the strip's end tables.  Each wrapper launches its kernel for
CUDA tensors and runs its plain version, which adds in the kernel's order,
for CPU tensors; both count on ``LAUNCHES``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build
from .shard_blocked import fold_table

__all__ = ["LAUNCHES", "StripTables", "strip_tables", "window", "window_plain", "fill",
           "fill_plain", "row_length"]

LAUNCHES = build.Counter("shard_grid")


@dataclasses.dataclass(frozen=True)
class StripTables:
    """One strip's tables on its device (int32, ``-1`` padded).

    Attributes:
        h, nx, r_dct: strip rows, lattice width, stub groups.
        first: whether this is shard 0 (it writes ``wx``, ``wy``).
        valid: ``(E_loc,)`` 1 at a real slot.
        st_cell: ``(U,)`` the window cells that hold stubs (ascending).
        st_fold: ``(U, K)`` their stub slots, ascending.
        grp_fold: ``(r, K)`` each stub group's stub slots.
        st_sb: ``(st_cap,)`` 1 where the stub's bifurcation is its source.
    """

    h: int
    nx: int
    r_dct: int
    first: bool
    valid: torch.Tensor
    st_cell: torch.Tensor
    st_fold: torch.Tensor
    grp_fold: torch.Tensor
    st_sb: torch.Tensor


def row_length(h: int, nx: int, r_dct: int) -> int:
    """A strip's row of the reduce: two windows, ``wx, wy``, ``w_r``."""
    return 2 * (h + 1) * nx + 2 + r_dct


def strip_tables(plan, d: int, device) -> StripTables:
    """Strip ``d``'s tables from a ``ShardedGridPlan``."""

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    ok = np.asarray(plan.stub_valid[d], bool)
    rel = np.where(ok, plan.stub_rel[d], -1)
    cells = np.unique(rel[ok])
    cell_of = np.full(ok.size, -1, np.int64)
    cell_of[ok] = np.searchsorted(cells, rel[ok])
    grp = np.where(ok, plan.stub_grp[d], -1)
    r_dct = int(plan.dct.stub_rows.size)
    return StripTables(
        h=int(plan.h), nx=int(plan.nx), r_dct=r_dct, first=d == 0,
        valid=i32(plan.valid[d]), st_cell=i32(cells),
        st_fold=i32(fold_table(cell_of, cells.size)), grp_fold=i32(fold_table(grp, r_dct)),
        st_sb=i32(plan.stub_s_bif[d] if plan.st_cap else np.zeros(1)),
    )


def _table_sum(vals, table):
    """Row sums through a ``-1``-padded table, columns in order (0 if empty)."""
    n = table.shape[0]
    if table.shape[1] == 0:
        return torch.zeros(n, dtype=vals.dtype, device=vals.device)
    vp = torch.cat([vals, torch.zeros(1, dtype=vals.dtype, device=vals.device)])
    idx = torch.where(table >= 0, table, vals.shape[0]).long()
    acc = vp[idx[:, 0]]
    for k in range(1, table.shape[1]):
        acc = acc + vp[idx[:, k]]
    return acc


def window_plain(tab: StripTables, w, const, Ftot) -> torch.Tensor:
    """Eager version: ``[rhs (h+1, nx) | diag (h+1, nx) | wx, wy | w_r]``."""
    h, nx = tab.h, tab.nx
    dt, dev = torch.float64, w.device
    ok = tab.valid.bool()
    wm = torch.where(ok, w, 0.0)
    cm = torch.where(ok, const, 0.0)
    cF = cm + Ftot
    Ex, Ey = h * (nx - 1), h * nx

    def xs(v):
        return v[:Ex].reshape(h, nx - 1)

    def ys(v):
        return v[Ex : Ex + Ey].reshape(h, nx)

    R = torch.zeros((h + 1, nx), dtype=dt, device=dev)
    R[:h, 1:] += xs(cF)
    R[:h, : nx - 1] += -xs(cm)
    R[1:, :] += ys(cF)
    R[:h, :] += -ys(cm)
    Dg = torch.zeros((h + 1, nx), dtype=dt, device=dev)
    Dg[:h, : nx - 1] += xs(wm)
    Dg[:h, 1:] += xs(wm)
    Dg[:h, :] += ys(wm)
    Dg[1:, :] += ys(wm)
    R, Dg = R.reshape(-1), Dg.reshape(-1)
    st_w, st_cF, st_cm = wm[Ex + Ey :], cF[Ex + Ey :], cm[Ex + Ey :]
    cells = tab.st_cell.long()
    if cells.shape[0]:
        rhs_st = torch.where(tab.st_sb.bool()[: st_w.shape[0]], -st_cm, st_cF)
        R[cells] = R[cells] + _table_sum(rhs_st, tab.st_fold)
        Dg[cells] = Dg[cells] + _table_sum(st_w, tab.st_fold)
    w_r = _table_sum(st_w, tab.grp_fold)
    wxy = torch.stack([wm[0], wm[Ex]]) if tab.first else torch.zeros(2, dtype=dt, device=dev)
    return torch.cat([R, Dg, wxy, w_r])


def window(tab: StripTables, w, const, Ftot) -> torch.Tensor:
    """K22b's window on ``w``'s device: the strip's row of the reduce."""
    if w.device.type == "cpu":
        return window_plain(tab, w, const, Ftot)
    build.require_cuda("shard_grid", w, const, Ftot)
    build.require_cuda("shard_grid", tab.valid, tab.st_cell, tab.st_fold, tab.grp_fold, tab.st_sb,
                       dtype=torch.int32)
    if any(tuple(t.shape) != tuple(tab.valid.shape) for t in (w, const, Ftot)):
        raise ValueError("shard_grid: w, const and Ftot must be (E_loc,)")
    part = torch.empty(row_length(tab.h, tab.nx, tab.r_dct), dtype=torch.float64,
                       device=w.device)
    with torch.cuda.device(w.device):
        code = build.library().nxfx_shard_grid_window(
            tab.h, tab.nx, int(tab.st_cell.shape[0]), int(tab.st_fold.shape[1]), tab.r_dct,
            int(tab.grp_fold.shape[1]), int(tab.first), w.data_ptr(), const.data_ptr(),
            Ftot.data_ptr(), tab.valid.data_ptr(), tab.st_cell.data_ptr(),
            tab.st_fold.data_ptr(), tab.grp_fold.data_ptr(), tab.st_sb.data_ptr(),
            part.data_ptr(), build.stream_handle(w.device),
        )
    build.check(code, "shard_grid")
    LAUNCHES.launches += 1
    return part


def fill_plain(Ex: int, Ey: int, E: int, wxy: torch.Tensor) -> torch.Tensor:
    """Eager version: ``[wx]·Ex + [wy]·Ey + [0]·(E − Ex − Ey)``."""
    dt, dev = torch.float64, wxy.device
    return torch.cat([wxy[0].expand(Ex), wxy[1].expand(Ey),
                      torch.zeros(E - Ex - Ey, dtype=dt, device=dev)])


def fill(Ex: int, Ey: int, E: int, wxy: torch.Tensor) -> torch.Tensor:
    """K22b's fill on ``wxy``'s device: the per-edge conductances ``(E,)``."""
    if wxy.device.type == "cpu":
        return fill_plain(Ex, Ey, E, wxy)
    build.require_cuda("shard_grid", wxy)
    out = torch.empty(E, dtype=torch.float64, device=wxy.device)
    with torch.cuda.device(wxy.device):
        code = build.library().nxfx_shard_grid_fill(
            Ex, Ey, E, wxy.data_ptr(), out.data_ptr(), build.stream_handle(wxy.device))
    build.check(code, "shard_grid")
    LAUNCHES.launches += 1
    return out
