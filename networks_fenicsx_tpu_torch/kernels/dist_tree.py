"""K22c: the per-shard body of the distributed tree elimination (``csrc/dist_tree.cu``).

Replaces ``networks_fenicsx_tpu/parallel/distributed_tree.py:local_eliminate``
(``:396-515``) around the psum and the T solve (:mod:`.shard_top`):

* :func:`folds` — the six pull-style reductions from the shard's K8a edge
  data: its local ``d`` (1 at padding slots), ``r``, ``wn`` (B_loc,) and its
  T partials ``[dT | rT | wT]`` (3·Tn,) (``:413-446``);
* :func:`forward` — the local levels deepest first, each parent gathering
  its children through the plan's level folds, then the chunk roots into
  their T parents' partials (``:450-483``); in place;
* :func:`back` — after the T solve, level 0 from the T parents and the
  levels root down: ``[λ (B_loc) | λ_T (Tn)]``, what K8b reads through the
  plan's remapped edge ends (``:507-515``).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version, which adds in the kernel's order, for CPU tensors; all count on
``LAUNCHES``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..edge_data import _EdgeData
from . import build
from .shard_blocked import fold_table

__all__ = ["LAUNCHES", "DistShardTables", "dist_shard_tables", "folds", "folds_plain", "forward",
           "forward_plain", "back", "back_plain"]

LAUNCHES = build.Counter("dist_tree")


@dataclasses.dataclass(frozen=True)
class DistShardTables:
    """One shard's tables on its device (int32; ``-1`` pads a row).

    Attributes:
        t_edge, s_edge, w_edge: ``(B_loc, K)`` the shard's local edges whose
            target, source or pair child is local node ``i`` (the plan's
            ``t_sel``/``t_fold`` composed), in the plan's order.
        tT_edge, sT_edge, wT_edge: ``(Tn, K)`` the same for the T nodes.
        offs: ``(L+1,)`` level bounds (``level_offsets``).
        lf, lf_off, lf_K: the level folds (``lvlfold_i``, ``(npar, K)`` each,
            ``n`` the pad) flattened, their offsets and widths.
        parent_pos, root_T: the plan's rows.
        rfold: ``(Tn, K)`` the level-0 positions whose T parent is ``t``.
    """

    t_edge: torch.Tensor
    s_edge: torch.Tensor
    w_edge: torch.Tensor
    tT_edge: torch.Tensor
    sT_edge: torch.Tensor
    wT_edge: torch.Tensor
    offs: torch.Tensor
    lf: torch.Tensor
    lf_off: torch.Tensor
    lf_K: torch.Tensor
    parent_pos: torch.Tensor
    root_T: torch.Tensor
    rfold: torch.Tensor
    host_offs: np.ndarray
    host_folds: tuple

    @property
    def B_loc(self) -> int:
        return int(self.parent_pos.shape[0])

    @property
    def Tn(self) -> int:
        return int(self.tT_edge.shape[0])

    @property
    def L(self) -> int:
        return int(self.host_offs.size) - 1


def _composed(sel: np.ndarray, fold: np.ndarray) -> np.ndarray:
    """The fold ``(width, K)`` into the sel stream, with sel composed in:
    local edge indices, ``-1`` at the pad slot."""
    S = sel.shape[0]
    fold = np.asarray(fold)
    return np.where(fold < S, np.asarray(sel)[np.minimum(fold, S - 1)], -1)


def dist_shard_tables(plan, d: int, device) -> DistShardTables:
    """Shard ``d``'s tables from a ``DistTreePlan``."""

    def i32(a):
        a = np.ascontiguousarray(a, dtype=np.int32)
        return torch.as_tensor(a if a.size else np.zeros(a.shape, np.int32), device=device)

    comp = {f: _composed(getattr(plan, f"{f}_sel")[d], getattr(plan, f"{f}_fold")[d])
            for f in ("t", "s", "w", "tT", "sT", "wT")}
    offs = np.asarray(plan.level_offsets, np.int64)
    folds_d = tuple(np.asarray(f[d]) for f in plan.level_folds)
    sizes = [f.size for f in folds_d]
    lf = np.concatenate([f.reshape(-1) for f in folds_d]) if folds_d else np.zeros(0, np.int64)
    return DistShardTables(
        **{f"{k}_edge": i32(v) for k, v in comp.items()},
        offs=i32(offs), lf=i32(lf if lf.size else np.zeros(1)),
        lf_off=i32(np.concatenate([[0], np.cumsum(sizes)])[:-1] if sizes else np.zeros(1)),
        lf_K=i32([f.shape[1] for f in folds_d] if folds_d else np.zeros(1)),
        parent_pos=i32(plan.parent_pos[d]), root_T=i32(plan.root_T_idx[d]),
        rfold=i32(fold_table(plan.root_T_idx[d], plan.Tn)),
        host_offs=offs, host_folds=folds_d,
    )


def _edge_values(ed: _EdgeData):
    """``(w, const + Ftot, -const)`` per edge (reference ``:413-417``)."""
    w = 1.0 / ed.W
    not_s = (ed.start_bif < 0).to(torch.float64)
    not_t = (ed.end_bif < 0).to(torch.float64)
    const = (-ed.start_pbc * not_s + ed.end_pbc * not_t - ed.g) / ed.W
    return w, const + ed.cumF[-1], -const


def _pull(vals: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Row sums of ``vals`` through a ``-1``-padded table, columns in order."""
    n = table.shape[0]
    if table.shape[1] == 0:
        return torch.zeros(n, dtype=vals.dtype, device=vals.device)
    vp = torch.cat([vals, torch.zeros(1, dtype=vals.dtype, device=vals.device)])
    idx = torch.where(table >= 0, table, vals.shape[0]).long()
    acc = vp[idx[:, 0]]
    for k in range(1, table.shape[1]):
        acc = acc + vp[idx[:, k]]
    return acc


def folds_plain(tab: DistShardTables, ed: _EdgeData):
    """Eager version: ``(d, r, wn, part)``."""
    w, vt, vs = _edge_values(ed)
    d = _pull(w, tab.t_edge) + _pull(w, tab.s_edge)
    d = torch.where(d == 0.0, 1.0, d)
    r = _pull(vt, tab.t_edge) + _pull(vs, tab.s_edge)
    wn = _pull(w, tab.w_edge)
    part = torch.cat([
        _pull(w, tab.tT_edge) + _pull(w, tab.sT_edge),
        _pull(vt, tab.tT_edge) + _pull(vs, tab.sT_edge),
        _pull(w, tab.wT_edge),
    ])
    return d, r, wn, part


def _check(tab: DistShardTables, *vecs):
    build.require_cuda("dist_tree", *vecs)
    build.require_cuda(
        "dist_tree", tab.t_edge, tab.s_edge, tab.w_edge, tab.tT_edge, tab.sT_edge, tab.wT_edge,
        tab.offs, tab.lf, tab.lf_off, tab.lf_K, tab.parent_pos, tab.root_T, tab.rfold,
        dtype=torch.int32,
    )


def folds(tab: DistShardTables, ed: _EdgeData):
    """K22c's folds on the edge data's device: ``(d, r, wn, part)``."""
    if ed.W.device.type == "cpu":
        return folds_plain(tab, ed)
    Ftot = ed.cumF[-1]
    _check(tab, ed.W, ed.g, Ftot, ed.start_pbc, ed.end_pbc)
    build.require_cuda("dist_tree", ed.start_bif, ed.end_bif, dtype=torch.int32)
    dev, dt = ed.W.device, torch.float64
    B_loc, Tn = tab.B_loc, tab.Tn
    d, r, wn = (torch.empty(B_loc, dtype=dt, device=dev) for _ in range(3))
    part = torch.empty(3 * Tn, dtype=dt, device=dev)
    tables = []
    for t in (tab.t_edge, tab.s_edge, tab.w_edge, tab.tT_edge, tab.sT_edge, tab.wT_edge):
        tables += [t.data_ptr(), t.shape[1]]
    with torch.cuda.device(dev):
        code = build.library().nxfx_dist_folds(
            B_loc, Tn, ed.W.data_ptr(), ed.g.data_ptr(), Ftot.data_ptr(),
            ed.start_pbc.data_ptr(), ed.end_pbc.data_ptr(), ed.start_bif.data_ptr(),
            ed.end_bif.data_ptr(), *tables, d.data_ptr(), r.data_ptr(), wn.data_ptr(),
            part.data_ptr(), build.stream_handle(dev),
        )
    build.check(code, "dist_tree")
    LAUNCHES.launches += 1
    return d, r, wn, part


def forward_plain(tab: DistShardTables, d, r, wn, part) -> None:
    """Eager version of :func:`forward` (in place)."""
    offs, Tn = tab.host_offs, tab.Tn
    dev = d.device
    zero = torch.zeros(1, dtype=torch.float64, device=dev)
    for lev in range(tab.L - 1, 0, -1):
        o, o1, op = int(offs[lev]), int(offs[lev + 1]), int(offs[lev - 1])
        fold = tab.host_folds[lev - 1]
        if fold.shape[1] == 0:
            continue
        factor = wn[o:o1] / d[o:o1]
        cd = torch.cat([-wn[o:o1] * factor, zero])
        cr = torch.cat([factor * r[o:o1], zero])
        idx = torch.as_tensor(fold, device=dev).long()  # pad n names the appended zero
        ud, ur = cd[idx[:, 0]], cr[idx[:, 0]]
        for k in range(1, fold.shape[1]):
            ud = ud + cd[idx[:, k]]
            ur = ur + cr[idx[:, k]]
        d[op:o] = d[op:o] + ud
        r[op:o] = r[op:o] + ur
    W0 = int(offs[1])
    factor0 = wn[:W0] / d[:W0]
    part[:Tn] = part[:Tn] + _pull(-wn[:W0] * factor0, tab.rfold)
    part[Tn : 2 * Tn] = part[Tn : 2 * Tn] + _pull(factor0 * r[:W0], tab.rfold)


def forward(tab: DistShardTables, d, r, wn, part) -> None:
    """K22c's level walk on ``d``'s device, in place on ``d``, ``r``, ``part``."""
    if d.device.type == "cpu":
        return forward_plain(tab, d, r, wn, part)
    _check(tab, d, r, wn, part)
    with torch.cuda.device(d.device):
        code = build.library().nxfx_dist_forward(
            tab.L, tab.Tn, tab.offs.data_ptr(), tab.lf_off.data_ptr(), tab.lf_K.data_ptr(),
            tab.lf.data_ptr(), tab.rfold.data_ptr(), tab.rfold.shape[1], wn.data_ptr(),
            d.data_ptr(), r.data_ptr(), part.data_ptr(), build.stream_handle(d.device),
        )
    build.check(code, "dist_tree")
    LAUNCHES.launches += 1
    return None


def back_plain(tab: DistShardTables, d, r, wn, lam_T) -> torch.Tensor:
    """Eager version: ``[λ (B_loc) | λ_T (Tn)]``."""
    offs, B_loc = tab.host_offs, tab.B_loc
    lam = torch.zeros(B_loc + tab.Tn, dtype=torch.float64, device=d.device)
    lam_pad = torch.cat([lam_T, torch.zeros(1, dtype=torch.float64, device=d.device)])
    W0 = int(offs[1])
    lam[:W0] = (r[:W0] + wn[:W0] * lam_pad[tab.root_T.long()]) / d[:W0]
    par = tab.parent_pos.long()
    for lev in range(1, tab.L):
        o, o1 = int(offs[lev]), int(offs[lev + 1])
        lam[o:o1] = (r[o:o1] + wn[o:o1] * lam[par[o:o1]]) / d[o:o1]
    lam[B_loc:] = lam_T
    return lam


def back(tab: DistShardTables, d, r, wn, lam_T) -> torch.Tensor:
    """K22c's back-substitution on ``d``'s device: ``[λ | λ_T]``."""
    if d.device.type == "cpu":
        return back_plain(tab, d, r, wn, lam_T)
    _check(tab, d, r, wn, lam_T)
    lam = torch.empty(tab.B_loc + tab.Tn, dtype=torch.float64, device=d.device)
    with torch.cuda.device(d.device):
        code = build.library().nxfx_dist_back(
            tab.L, tab.B_loc, tab.Tn, tab.offs.data_ptr(), tab.parent_pos.data_ptr(),
            tab.root_T.data_ptr(), d.data_ptr(), r.data_ptr(), wn.data_ptr(), lam_T.data_ptr(),
            lam.data_ptr(), build.stream_handle(d.device),
        )
    build.check(code, "dist_tree")
    LAUNCHES.launches += 1
    return lam
