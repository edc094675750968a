"""K22b: the per-strip body of the strip-sharded lattice solve (``csrc/shard_grid.cu``).

Replaces ``networks_fenicsx_tpu/parallel/grid_sharded.py:_make_grid_local_body``
(``:247-391``) between the strips' K1 and K5:

* :func:`window_batch` — every strip of a device in one launch, each
  strip's row of the reduce: its ``(h+1, nx)`` rhs and diag windows by
  index arithmetic on its x- and y-edge slots, its stubs added per window
  cell (found through the strip's cell → stub map), then ``wx, wy``
  (strip 0's representative conductances, 0 on the other strips) and the
  stub groups' ``w_r (r,)`` (``:279-335``): ``[rhs | diag | wx, wy |
  w_r]``, a row a strip of the ``(S, row_length)`` tensor the placed
  reduce reads.  The strips' tables are stacked once
  (:func:`batch_strips`, :class:`StripBatchTables`) and their ``w``,
  ``const``, ``Ftot`` are the rows of K1's ``(S, E_loc)`` planes;
  :func:`window` launches the same kernel on one strip's tables;
* :func:`fill` — after the reduce, the lattice's uniform per-edge
  conductances (``wx`` on the x-edges, ``wy`` on the y-edges, 0 at the
  stubs), which K17's stencil takes as the matvec of the replicated DCT
  solve (``:337-346``).

So a device makes 2 launches a solve (:func:`cuda_launches`).  The λ window
and the λ → edge ends (``:348-360``) are index arithmetic that K5 reads from
the strip's end tables.  Each wrapper launches its kernel for CUDA tensors
and runs its plain version, which adds in the kernel's order, for CPU
tensors (the batched one: :func:`window_plain` a strip, stacked); all count
on ``LAUNCHES``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build
from .shard_blocked import fold_table

__all__ = ["LAUNCHES", "StripTables", "StripBatchTables", "strip_tables", "batch_strips",
           "cuda_launches", "window", "window_plain", "window_batch", "window_batch_plain", "fill",
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
        cell_map: ``((h+1)·nx,)`` each window cell's row of ``st_fold``,
            ``-1`` where the cell holds no stub.
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
    cell_map: torch.Tensor


def row_length(h: int, nx: int, r_dct: int) -> int:
    """A strip's row of the reduce: two windows, ``wx, wy``, ``w_r``."""
    return 2 * (h + 1) * nx + 2 + r_dct


def cell_map(st_cell: np.ndarray, cells: int) -> np.ndarray:
    """``(cells,)``: the position of each cell in the ascending ``st_cell``,
    ``-1`` for a cell not in it."""
    out = np.full(cells, -1, np.int64)
    out[np.asarray(st_cell, np.int64)] = np.arange(np.asarray(st_cell).size)
    return out


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
        cell_map=i32(cell_map(cells, (int(plan.h) + 1) * int(plan.nx))),
    )


@dataclasses.dataclass(frozen=True)
class StripBatchTables:
    """The :class:`StripTables` of S strips on one device, stacked on a
    leading strip axis: ``valid (S, E_loc)``, ``st_cell (S, U)``,
    ``st_fold (S, U, Kc)``, ``grp_fold (S, r, Kg)``, ``st_sb (S,
    st_len)``, ``cell_map (S, (h+1)·nx)`` (each ``U``, ``Kc``, ``Kg`` the
    widest strip's, ``-1`` padded); ``first`` the strip that writes ``wx,
    wy`` (``-1`` for none); ``widths[j]`` strip ``j``'s own ``(U, Kc,
    Kg)``."""

    h: int
    nx: int
    r_dct: int
    first: int
    valid: torch.Tensor
    st_cell: torch.Tensor
    st_fold: torch.Tensor
    grp_fold: torch.Tensor
    st_sb: torch.Tensor
    cell_map: torch.Tensor
    widths: tuple

    @property
    def S(self) -> int:
        return int(self.valid.shape[0])

    @property
    def E_loc(self) -> int:
        return int(self.valid.shape[1])

    def strip(self, j: int) -> StripTables:
        """Strip ``j``'s :class:`StripTables` (views, its own widths)."""
        U, Kc, Kg = self.widths[j]
        return StripTables(h=self.h, nx=self.nx, r_dct=self.r_dct, first=j == self.first,
                           valid=self.valid[j], st_cell=self.st_cell[j, :U],
                           st_fold=self.st_fold[j, :U, :Kc], grp_fold=self.grp_fold[j, :, :Kg],
                           st_sb=self.st_sb[j], cell_map=self.cell_map[j])


def batch_strips(tabs) -> StripBatchTables:
    """The strips' :class:`StripTables` (one device, one plan) stacked."""
    tabs = list(tabs)
    if not tabs:
        raise ValueError("shard_grid: tables of at least one strip")
    t0 = tabs[0]
    key = (t0.h, t0.nx, t0.r_dct, tuple(t0.valid.shape), tuple(t0.st_sb.shape), t0.valid.device)
    if any((t.h, t.nx, t.r_dct, tuple(t.valid.shape), tuple(t.st_sb.shape), t.valid.device) != key
           for t in tabs):
        raise ValueError("shard_grid: the strips' tables must share h, nx, r, E_loc and a device")
    widths = tuple((int(t.st_fold.shape[0]), int(t.st_fold.shape[1]), int(t.grp_fold.shape[1]))
                   for t in tabs)
    U, Kc, Kg = (max(w[f] for w in widths) for f in range(3))
    dev, S = t0.valid.device, len(tabs)

    def pad(shape):
        return torch.full((S, *shape), -1, dtype=torch.int32, device=dev)

    st_cell, st_fold, grp_fold = pad((U,)), pad((U, Kc)), pad((t0.r_dct, Kg))
    for j, (t, (u, kc, kg)) in enumerate(zip(tabs, widths)):
        st_cell[j, :u] = t.st_cell
        st_fold[j, :u, :kc] = t.st_fold
        grp_fold[j, :, :kg] = t.grp_fold
    first = [j for j, t in enumerate(tabs) if t.first]
    return StripBatchTables(
        h=t0.h, nx=t0.nx, r_dct=t0.r_dct, first=first[0] if first else -1,
        valid=torch.stack([t.valid for t in tabs]).contiguous(), st_cell=st_cell,
        st_fold=st_fold, grp_fold=grp_fold,
        st_sb=torch.stack([t.st_sb for t in tabs]).contiguous(),
        cell_map=torch.stack([t.cell_map for t in tabs]).contiguous(), widths=widths)


def cuda_launches(bt: StripBatchTables) -> int:
    """K22b's launches a solve on ``bt``'s device: every strip's window in
    one launch, then the fill."""
    return 2


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


def window_batch_plain(bt: StripBatchTables, w, const, Ftot) -> torch.Tensor:
    """Eager version of :func:`window_batch`: :func:`window_plain` a strip,
    stacked ``(S, row_length)``."""
    return torch.stack([window_plain(bt.strip(j), w[j], const[j], Ftot[j]) for j in range(bt.S)])


def _launch_window(S, dims, first, tables, w, const, Ftot, part) -> None:
    """One launch of the window kernel on S strips' ``tables`` (``valid,
    cell_map, st_fold, grp_fold, st_sb``, stacked or one strip's) and
    their ``w, const, Ftot`` (``(S, E_loc)`` or ``(E_loc,)``) into
    ``part``: the lean path (one check pass, the raw stream)."""
    index = tables[0].get_device()
    for t in (w, const, Ftot):
        if not t.is_cuda or t.get_device() != index or t.dtype != torch.float64 \
                or not t.is_contiguous():
            raise ValueError(f"shard_grid: w, const, Ftot must be contiguous float64 tensors on "
                             f"CUDA device {index}")
    if not (w.shape == const.shape == Ftot.shape == tables[0].shape):
        raise ValueError(f"shard_grid: w, const and Ftot must be {tuple(tables[0].shape)}, got "
                         f"{tuple(w.shape)}, {tuple(const.shape)}, {tuple(Ftot.shape)}")
    code = build.on_device(index, build.library().nxfx_shard_grid_window, S, *dims, first,
                           w.data_ptr(), const.data_ptr(), Ftot.data_ptr(),
                           *(t.data_ptr() for t in tables), part.data_ptr(),
                           build.raw_stream(index))
    build.check(code, "shard_grid")
    LAUNCHES.launches += 1


def _check_tables(*tables) -> None:
    dev = tables[0].device
    if dev.type != "cuda":
        raise ValueError("shard_grid: the tables must be on a CUDA device")
    for t in tables:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"shard_grid: the tables must be contiguous int32 tensors on {dev}")


def window(tab: StripTables, w, const, Ftot) -> torch.Tensor:
    """K22b's window on ``w``'s device: the strip's row of the reduce (the
    batched kernel on one strip)."""
    if w.device.type == "cpu":
        return window_plain(tab, w, const, Ftot)
    tables = (tab.valid, tab.cell_map, tab.st_fold, tab.grp_fold, tab.st_sb)
    _check_tables(*tables)
    U, Kc = (int(n) for n in tab.st_fold.shape)
    dims = (tab.h, tab.nx, U, Kc, tab.r_dct, int(tab.grp_fold.shape[1]), int(tab.valid.shape[0]),
            int(tab.st_sb.shape[0]))
    part = torch.empty(row_length(tab.h, tab.nx, tab.r_dct), dtype=torch.float64,
                       device=w.device)
    _launch_window(1, dims, 0 if tab.first else -1, tables, w, const, Ftot, part)
    return part


def window_batch(bt: StripBatchTables, w, const, Ftot) -> torch.Tensor:
    """K22b's windows of every strip of ``bt`` (``w``, ``const``, ``Ftot``
    ``(S, E_loc)``: rows of K1's planes, in the tables' order) on their
    device: the ``(S, row_length)`` rows the placed reduce reads, one
    launch."""
    if w.device.type == "cpu":
        return window_batch_plain(bt, w, const, Ftot)
    tables = (bt.valid, bt.cell_map, bt.st_fold, bt.grp_fold, bt.st_sb)
    _check_tables(*tables)
    dims = (bt.h, bt.nx, int(bt.st_fold.shape[1]), int(bt.st_fold.shape[2]), bt.r_dct,
            int(bt.grp_fold.shape[2]), bt.E_loc, int(bt.st_sb.shape[1]))
    part = torch.empty((bt.S, row_length(bt.h, bt.nx, bt.r_dct)), dtype=torch.float64,
                       device=w.device)
    _launch_window(bt.S, dims, bt.first, tables, w, const, Ftot, part)
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
    if not wxy.is_cuda:
        raise ValueError("shard_grid: tensors must be on a CUDA device")
    index = wxy.get_device()
    build.require_vectors("shard_grid", index, (wxy, -2))
    out = torch.empty(E, dtype=torch.float64, device=wxy.device)
    code = build.on_device(index, build.library().nxfx_shard_grid_fill, Ex, Ey, E,
                           wxy.data_ptr(), out.data_ptr(), build.raw_stream(index))
    build.check(code, "shard_grid")
    LAUNCHES.launches += 1
    return out
