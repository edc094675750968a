"""K22c: the per-shard body of the distributed tree elimination, for every
shard of one device at once (``csrc/dist_tree.cu``).

Replaces ``networks_fenicsx_tpu/parallel/distributed_tree.py:local_eliminate``
(``:396-515``) around the psum and the T solve (:mod:`.shard_top`).  The
plan's tables are uniform across shards (a leading ``D`` axis, padded), so
the shards a device holds share one :class:`DistShardTables`, stacked on a
leading shard axis ``S``, and each wrapper takes all of them:

* :func:`folds` — the six pull-style reductions from each shard's K8a edge
  data: its local ``d`` (1 at padding slots), ``r``, ``wn`` ``(S, B_loc)``
  and its T partials ``[dT | rT | wT]`` ``(S, 3·Tn)`` (``:413-446``); one
  grid, each shard's edge data reached through a per-stream struct of
  pointers;
* :func:`forward` — the local levels deepest first, each parent gathering
  its children through the plan's level folds, then the chunk roots into
  their T parents' partials (``:450-483``); in place, one block a shard;
* :func:`back` — after the T solve, level 0 from the T parents and the
  levels root down: ``[λ (B_loc) | λ_T (Tn)]`` a shard, what K8b reads
  through the plan's remapped edge ends (``:507-515``); one block a shard.

So a device makes 3 launches a solve whatever its number of shards
(:func:`cuda_launches`).  The walks are bound by their depth, not their
bytes: ``csrc/dist_tree.cu`` keeps a level's chain to a barrier, shared
reads and one division.  Each wrapper launches its kernel for CUDA tensors
and runs its plain version for CPU tensors: the per-shard plain version,
which adds in the kernel's order, in a loop over the shards.  All count on
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..edge_data import _EdgeData
from . import build
from .shard_blocked import fold_table

__all__ = ["LAUNCHES", "MAX_SHARDS", "DistShardTables", "dist_shard_tables", "cuda_launches",
           "folds", "folds_plain", "forward", "forward_plain", "back", "back_plain"]

LAUNCHES = build.Counter("dist_tree")
MAX_SHARDS = 32  # DIST_MAX_SHARDS in csrc/dist_tree.cu: the shards of one folds launch
BUF_SMEM = 512  # the widest level whose walk buffers sit in shared memory (csrc: BUF_SMEM)


@dataclasses.dataclass(frozen=True)
class DistShardTables:
    """The tables of shards ``shards`` of a plan on one device (int32; ``-1``
    pads a row), stacked on a leading shard axis ``S``.

    Attributes:
        t_edge, s_edge, w_edge: ``(S, B_loc, K)`` the shard's local edges
            whose target, source or pair child is local node ``i`` (the
            plan's ``t_sel``/``t_fold`` composed), in the plan's order.
        tT_edge, sT_edge, wT_edge: ``(S, Tn, K)`` the same for the T nodes.
        levels: ``(L, 2)`` per level its bounds ``(offs[l], offs[l+1])``.
        kids: ``(S, B_loc, 2)`` per node its run of children in the level
            below, ``(first, count)``: the plan's level folds
            (``lvlfold_i``), which name each parent's children as a run.
        parent_pos, root_T: ``(S, B_loc)``, ``(S, W0)`` the plan's rows.
        rfold: ``(S, Tn, Kr)`` the level-0 positions whose T parent is ``t``.
        width: the widest level.
    """

    shards: tuple
    t_edge: torch.Tensor
    s_edge: torch.Tensor
    w_edge: torch.Tensor
    tT_edge: torch.Tensor
    sT_edge: torch.Tensor
    wT_edge: torch.Tensor
    levels: torch.Tensor
    kids: torch.Tensor
    parent_pos: torch.Tensor
    root_T: torch.Tensor
    rfold: torch.Tensor
    host_offs: np.ndarray
    host_folds: tuple
    width: int
    _scratch: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def S(self) -> int:
        return len(self.shards)

    @property
    def B_loc(self) -> int:
        return int(self.parent_pos.shape[1])

    @property
    def Tn(self) -> int:
        return int(self.tT_edge.shape[1])

    @property
    def L(self) -> int:
        return int(self.host_offs.size) - 1

    def _fold_args(self, stream: int, chunk: int):
        """The :class:`_FoldArgs` of chunk ``chunk`` of the shards on CUDA
        stream ``stream``, made at the stream's first call."""
        key = (stream, chunk)
        args = self._scratch.get(key)
        if args is None:
            args = self._scratch[key] = _FoldArgs()
        return args


def _composed(sel: np.ndarray, fold: np.ndarray) -> np.ndarray:
    """The fold ``(width, K)`` into the sel stream, with sel composed in:
    local edge indices, ``-1`` at the pad slot."""
    S = sel.shape[0]
    fold = np.asarray(fold)
    return np.where(fold < S, np.asarray(sel)[np.minimum(fold, S - 1)], -1)


def dist_shard_tables(plan, shards, device) -> DistShardTables:
    """The tables of the plan's shards ``shards`` (a shard index or a
    sequence of them) stacked on ``device``.  Raises ``ValueError`` for a
    level fold that names a child outside its level or does not name a
    parent's children as a run, or a parent outside the level above (the
    walks read them from a level buffer, a parent's children as a run)."""
    shards = (int(shards),) if np.ndim(shards) == 0 else tuple(int(d) for d in shards)
    if not shards:
        raise ValueError("dist_tree: tables of at least one shard")
    sel = np.asarray(shards)

    def i32(a):
        a = np.ascontiguousarray(a, dtype=np.int32)
        return torch.as_tensor(a if a.size else np.zeros(a.shape, np.int32), device=device)

    comp = {f: np.stack([_composed(getattr(plan, f"{f}_sel")[d], getattr(plan, f"{f}_fold")[d])
                         for d in shards]) for f in ("t", "s", "w", "tT", "sT", "wT")}
    offs = np.asarray(plan.level_offsets, np.int64)
    L = offs.size - 1
    widths = np.diff(offs)
    folds_d = tuple(np.asarray(f)[sel] for f in plan.level_folds)  # (S, npar, K) each
    kids = np.zeros((len(shards), int(offs[-1]), 2), np.int64)
    for lev, fold in enumerate(folds_d, start=1):
        n, K = int(widths[lev]), fold.shape[2]
        if fold.size and (fold.min() < 0 or fold.max() > n):
            raise ValueError(f"dist_tree: level {lev}'s fold names a child outside its {n} nodes")
        count = (fold < n).sum(axis=2)
        first = fold[..., 0]
        run = np.where(np.arange(K) < count[..., None], first[..., None] + np.arange(K), n)
        if not np.array_equal(run, fold):
            raise ValueError(f"dist_tree: level {lev}'s fold does not name a parent's children as a run")
        kids[:, offs[lev - 1]:offs[lev], 0] = np.where(count > 0, first, 0)
        kids[:, offs[lev - 1]:offs[lev], 1] = count
    parent_pos = np.asarray(plan.parent_pos)[sel]
    for lev in range(1, L):
        par = parent_pos[:, offs[lev]:offs[lev + 1]]
        if par.size and (par.min() < offs[lev - 1] or par.max() >= offs[lev]):
            raise ValueError(f"dist_tree: a parent of level {lev} lies outside level {lev - 1}")
    root_T = np.asarray(plan.root_T_idx)[sel]
    rfolds = [fold_table(np.asarray(plan.root_T_idx[d]), plan.Tn) for d in shards]
    Kr = max(f.shape[1] for f in rfolds)
    rfold = np.full((len(shards), plan.Tn, Kr), -1, np.int64)
    for j, f in enumerate(rfolds):
        rfold[j, :, : f.shape[1]] = f
    return DistShardTables(
        shards=shards, **{f"{k}_edge": i32(v) for k, v in comp.items()},
        levels=i32(np.stack([offs[:-1], offs[1:]], axis=1)), kids=i32(kids),
        parent_pos=i32(parent_pos), root_T=i32(root_T), rfold=i32(rfold),
        host_offs=offs, host_folds=folds_d, width=int(widths.max()),
    )


def cuda_launches(tab: DistShardTables) -> int:
    """K22c's launches a solve on ``tab``'s device: the folds
    (one a :data:`MAX_SHARDS` shards), a forward and a back walk."""
    return -(-tab.S // MAX_SHARDS) + 2


# ------------------------------------------------------------------ plain


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


def _folds_shard(tab: DistShardTables, j: int, ed: _EdgeData):
    w, vt, vs = _edge_values(ed)
    d = _pull(w, tab.t_edge[j]) + _pull(w, tab.s_edge[j])
    d = torch.where(d == 0.0, 1.0, d)
    r = _pull(vt, tab.t_edge[j]) + _pull(vs, tab.s_edge[j])
    wn = _pull(w, tab.w_edge[j])
    part = torch.cat([
        _pull(w, tab.tT_edge[j]) + _pull(w, tab.sT_edge[j]),
        _pull(vt, tab.tT_edge[j]) + _pull(vs, tab.sT_edge[j]),
        _pull(w, tab.wT_edge[j]),
    ])
    return d, r, wn, part


def folds_plain(tab: DistShardTables, eds):
    """Eager version: ``(d, r, wn, part)``, each stacked over the shards."""
    outs = [_folds_shard(tab, j, ed) for j, ed in enumerate(eds)]
    return tuple(torch.stack(v) for v in zip(*outs))


def _forward_shard(tab: DistShardTables, j: int, d, r, wn, part) -> None:
    offs, Tn = tab.host_offs, tab.Tn
    dev = d.device
    zero = torch.zeros(1, dtype=torch.float64, device=dev)
    for lev in range(tab.L - 1, 0, -1):
        o, o1, op = int(offs[lev]), int(offs[lev + 1]), int(offs[lev - 1])
        fold = tab.host_folds[lev - 1][j]
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
    part[:Tn] = part[:Tn] + _pull(-wn[:W0] * factor0, tab.rfold[j])
    part[Tn : 2 * Tn] = part[Tn : 2 * Tn] + _pull(factor0 * r[:W0], tab.rfold[j])


def forward_plain(tab: DistShardTables, d, r, wn, part) -> None:
    """Eager version of :func:`forward` (in place), shard by shard."""
    for j in range(tab.S):
        _forward_shard(tab, j, d[j], r[j], wn[j], part[j])


def _back_shard(tab: DistShardTables, j: int, d, r, wn, lam_T) -> torch.Tensor:
    offs, B_loc = tab.host_offs, tab.B_loc
    lam = torch.zeros(B_loc + tab.Tn, dtype=torch.float64, device=d.device)
    lam_pad = torch.cat([lam_T, torch.zeros(1, dtype=torch.float64, device=d.device)])
    W0 = int(offs[1])
    lam[:W0] = (r[:W0] + wn[:W0] * lam_pad[tab.root_T[j].long()]) / d[:W0]
    par = tab.parent_pos[j].long()
    for lev in range(1, tab.L):
        o, o1 = int(offs[lev]), int(offs[lev + 1])
        lam[o:o1] = (r[o:o1] + wn[o:o1] * lam[par[o:o1]]) / d[o:o1]
    lam[B_loc:] = lam_T
    return lam


def back_plain(tab: DistShardTables, d, r, wn, lam_T) -> torch.Tensor:
    """Eager version: ``[λ (B_loc) | λ_T (Tn)]`` a shard, ``(S, B_loc + Tn)``."""
    return torch.stack([_back_shard(tab, j, d[j], r[j], wn[j], lam_T) for j in range(tab.S)])


# ---------------------------------------------------------------- kernels


class _Edges(ctypes.Structure):
    """``DistEdges`` of ``csrc/dist_tree.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("W", "g", "Ftot", "spbc", "epbc", "sbif", "ebif")]


class _FoldArgs(ctypes.Structure):
    """``DistFoldArgs`` of ``csrc/dist_tree.cu``."""

    _fields_ = [("S", ctypes.c_int), ("e", _Edges * MAX_SHARDS)]


def _check_tables(tab: DistShardTables, index: int) -> None:
    """The tables on CUDA device ``index``: contiguous int32."""
    for t in (tab.t_edge, tab.s_edge, tab.w_edge, tab.tT_edge, tab.sT_edge, tab.wT_edge, tab.levels,
              tab.kids, tab.parent_pos, tab.root_T, tab.rfold):
        if not t.is_cuda or t.get_device() != index or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"dist_tree: the tables must be contiguous int32 tensors on CUDA "
                             f"device {index}")


def _check(index: int, *pairs, dtype=torch.float64) -> None:
    """``(tensor, shape)`` pairs: contiguous ``dtype`` tensors of that shape
    on CUDA device ``index``."""
    for t, shape in pairs:
        if (not t.is_cuda or t.get_device() != index or t.dtype != dtype
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"dist_tree: expected a contiguous {dtype} {shape} tensor on CUDA "
                             f"device {index}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _device_index(t: torch.Tensor) -> int:
    if not t.is_cuda:
        raise ValueError("dist_tree: tensors must be on a CUDA device")
    return t.get_device()


def _walk_scratch(tab: DistShardTables, doubles: int, device):
    """Device scratch of the walks' level buffers (``doubles`` a node of the
    widest level) when that level is too wide for shared memory, else None."""
    if tab.width <= BUF_SMEM:
        return None
    return torch.empty(tab.S * doubles * tab.width, dtype=torch.float64, device=device)


def folds(tab: DistShardTables, eds):
    """K22c's folds of every shard of ``tab`` (``eds`` their K8a edge data,
    in the tables' order) on their device: ``(d, r, wn, part)`` stacked, in
    one launch a :data:`MAX_SHARDS` shards."""
    if eds[0].W.device.type == "cpu":
        return folds_plain(tab, eds)
    index = _device_index(eds[0].W)
    _check_tables(tab, index)
    if len(eds) != tab.S:
        raise ValueError(f"dist_tree: edge data of {tab.S} shards expected, got {len(eds)}")
    for ed in eds:
        E = ed.W.shape[0]
        _check(index, *((t, (E,)) for t in (ed.W, ed.g, ed.cumF[-1], ed.start_pbc, ed.end_pbc)))
        _check(index, (ed.start_bif, (E,)), (ed.end_bif, (E,)), dtype=torch.int32)
    dev, dt = eds[0].W.device, torch.float64
    S, B_loc, Tn = tab.S, tab.B_loc, tab.Tn
    d, r, wn = (torch.empty((S, B_loc), dtype=dt, device=dev) for _ in range(3))
    part = torch.empty((S, 3 * Tn), dtype=dt, device=dev)
    tables = []
    for t in (tab.t_edge, tab.s_edge, tab.w_edge, tab.tT_edge, tab.sT_edge, tab.wT_edge):
        tables += [t.data_ptr(), t.shape[2]]
    stream = build.raw_stream(index)
    for chunk, s0 in enumerate(range(0, S, MAX_SHARDS)):
        run = eds[s0 : s0 + MAX_SHARDS]
        args = tab._fold_args(stream, chunk)
        args.S = len(run)
        for e, ed in zip(args.e, run):
            e.W, e.g, e.Ftot = ed.W.data_ptr(), ed.g.data_ptr(), ed.cumF[-1].data_ptr()
            e.spbc, e.epbc = ed.start_pbc.data_ptr(), ed.end_pbc.data_ptr()
            e.sbif, e.ebif = ed.start_bif.data_ptr(), ed.end_bif.data_ptr()
        code = build.on_device(index, build.library().nxfx_dist_folds, ctypes.addressof(args), s0,
                               B_loc, Tn, *tables, d.data_ptr(), r.data_ptr(), wn.data_ptr(),
                               part.data_ptr(), stream)
        build.check(code, "dist_tree")
        LAUNCHES.launches += 1
    return d, r, wn, part


def forward(tab: DistShardTables, d, r, wn, part) -> None:
    """K22c's level walks of every shard of ``tab`` on ``d``'s device, in
    place on ``d``, ``r``, ``part``: one launch, a block a shard."""
    if d.device.type == "cpu":
        return forward_plain(tab, d, r, wn, part)
    index = _device_index(d)
    S, B_loc, Tn = tab.S, tab.B_loc, tab.Tn
    _check_tables(tab, index)
    _check(index, (d, (S, B_loc)), (r, (S, B_loc)), (wn, (S, B_loc)), (part, (S, 3 * Tn)))
    scratch = _walk_scratch(tab, 4, d.device)
    code = build.on_device(index, build.library().nxfx_dist_forward, S, tab.L, B_loc, Tn, tab.width,
                           tab.levels.data_ptr(), tab.kids.data_ptr(),
                           tab.rfold.data_ptr(), tab.rfold.shape[2], wn.data_ptr(), d.data_ptr(),
                           r.data_ptr(), part.data_ptr(), None if scratch is None else scratch.data_ptr(),
                           build.raw_stream(index))
    build.check(code, "dist_tree")
    LAUNCHES.launches += 1
    return None


def back(tab: DistShardTables, d, r, wn, lam_T) -> torch.Tensor:
    """K22c's back-substitutions of every shard of ``tab`` on ``d``'s
    device: ``[λ | λ_T]`` a shard, ``(S, B_loc + Tn)``; one launch."""
    if d.device.type == "cpu":
        return back_plain(tab, d, r, wn, lam_T)
    index = _device_index(d)
    S, B_loc, Tn = tab.S, tab.B_loc, tab.Tn
    _check_tables(tab, index)
    _check(index, (d, (S, B_loc)), (r, (S, B_loc)), (wn, (S, B_loc)), (lam_T, (Tn,)))
    lam = torch.empty((S, B_loc + Tn), dtype=torch.float64, device=d.device)
    scratch = _walk_scratch(tab, 2, d.device)
    code = build.on_device(index, build.library().nxfx_dist_back, S, tab.L, B_loc, Tn, tab.width,
                           tab.levels.data_ptr(), tab.parent_pos.data_ptr(), tab.root_T.data_ptr(),
                           d.data_ptr(), r.data_ptr(), wn.data_ptr(), lam_T.data_ptr(), lam.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), build.raw_stream(index))
    build.check(code, "dist_tree")
    LAUNCHES.launches += 1
    return lam
