"""K7: level-ordered elimination of a general forest (``csrc/level_eliminate.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_level_eliminate`` and
``_level_eliminate_core2`` (``:2131-2241``): from the condensed edge data,
assemble the per-bifurcation diagonal and rhs in the level plan's permuted
order (three sorted-segment sums, K6), take ``‖rhs‖`` before any fold, fold
the levels into their parents deepest first, back-substitute ``λ`` root
down and un-permute it to the public bifurcation order.

:func:`level_eliminate` launches the kernels for CUDA tensors — a prepare
pass, the three K6 sums in one launch (:func:`.segsum.segsum_plan` on the
plan's ``sums``), then one launcher that runs the assembly, the norm and the
plan's :class:`LevelWalk` schedule: each run of consecutive levels no wider
than :data:`WALK_MAX` folded in one launch of one block and back-substituted
in another (writing ``λ`` in the public order as it goes), each wider level
one grid launch each way — and runs :func:`level_eliminate_plain`, the eager
transcription of the reference, for CPU tensors.  :func:`level_eliminate_system`
runs the same elimination from an assembled public-order ``(diag, rhs)`` and
the pair conductances (the sharded general solve's replicated stage).
:func:`level_walk_plain` runs the arithmetic in the schedule's grouping, as
the kernels do.

Both wrappers count on :data:`LAUNCHES`: ``launches`` a call, ``device`` the
kernels its launchers enqueued, as they report them.

A sweep on the level route runs S scenarios in the launches of one call,
:func:`level_eliminate_scenarios`: the prepare pass over S rows of the edge
data of :func:`.edge_data.edge_data_scenarios`, K6's three sums over S
(:func:`.segsum.segsum_plan_scenarios`), then the same schedule with the
scenario as every launch's grid y (a walk row S blocks, one a scenario, each
with its own ``d, r, wn, λ`` rows); both channels run for every scenario.
Row ``i`` is :func:`level_eliminate` of row ``i`` bit for bit; the plain
version is :func:`level_eliminate_plain` a row, stacked.  It counts on its own
``launches`` and ``device``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..edge_data import _EdgeData
from ..levels import DeviceLevelPlan
from . import build, segsum

__all__ = [
    "level_eliminate", "level_eliminate_plain", "level_eliminate_system",
    "level_eliminate_system_plain", "level_walk_plain", "walk_schedule", "cuda_launches",
    "LevelWalk", "WALK_MAX", "WALK", "GRID", "LAUNCHES", "level_eliminate_scenarios",
    "level_eliminate_scenarios_plain",
]

LAUNCHES = build.Counter("level_eliminate")
LAUNCHES.device = 0  # kernels enqueued (the prepare pass, the assembly, the norm, the schedule's rows)

WALK_MAX = 128  # the widest level a walk takes (WALK_MAX in csrc/level_walk.cuh)
WALK, GRID = 0, 1  # the kinds of a schedule row


def walk_schedule(level_offsets, walk_max: int = WALK_MAX) -> tuple[np.ndarray, np.ndarray]:
    """``(fwd, back)``: K7's launches after the assembly and the norm, as
    int32 rows ``(kind, first, last)``.

    Forward, deepest first: the fold of level ``p + 1`` into level ``p`` is
    walked when both levels are at most ``walk_max`` wide; a run of such
    folds, ``p = last - 1`` down to ``first``, is one :data:`WALK` row
    ``(first, last)``; any other fold is a :data:`GRID` row ``(p, p)``.
    Back, root first: a run of such narrow levels is one :data:`WALK` row,
    a wider level a :data:`GRID` row."""
    offs = np.asarray(level_offsets, np.int64)
    narrow = np.diff(offs) <= walk_max
    L = narrow.size
    fwd, p = [], L - 2
    while p >= 0:
        if narrow[p] and narrow[p + 1]:
            last = p + 1
            while p >= 0 and narrow[p]:
                p -= 1
            fwd.append((WALK, p + 1, last))
        else:
            fwd.append((GRID, p, p))
            p -= 1
    back, l = [], 0
    while l < L:
        if narrow[l]:
            first = l
            while l < L and narrow[l]:
                l += 1
            back.append((WALK, first, l - 1))
        else:
            back.append((GRID, l, l))
            l += 1
    return (np.asarray(fwd, np.int32).reshape(-1, 3), np.asarray(back, np.int32).reshape(-1, 3))


class _LevelWalkArgs(ctypes.Structure):
    """``LevelWalkArgs`` of ``csrc/level_eliminate.cu``."""

    _fields_ = [("B", ctypes.c_int), ("L", ctypes.c_int), ("n_fwd", ctypes.c_int),
                ("n_back", ctypes.c_int), ("fwd", ctypes.c_void_p), ("back", ctypes.c_void_p),
                ("offs", ctypes.c_void_p), ("lvl", ctypes.c_void_p), ("parent_pos", ctypes.c_void_p),
                ("parent_pair", ctypes.c_void_p), ("child_ptr", ctypes.c_void_p),
                ("kids", ctypes.c_void_p), ("perm", ctypes.c_void_p), ("inv_perm", ctypes.c_void_p)]


_TABLES = ("levels", "parent_pos", "parent_pair", "child_ptr", "kids", "perm", "inv_perm")


class LevelWalk:
    """K7's schedule on a :class:`..levels.DeviceLevelPlan` (made with it):
    ``fwd`` and ``back`` (:func:`walk_schedule`), ``launches`` a call after
    K6's (the assembly, the norm and a launch a row), and the launcher's
    argument struct.  Raises ``ValueError`` unless the plan's tables are
    contiguous int32 on one device."""

    __slots__ = ("fwd", "back", "launches", "device", "_args", "_offs")

    def __init__(self, dlp: DeviceLevelPlan):
        tables = [getattr(dlp, name) for name in _TABLES]
        dev = tables[0].device
        if any(t.device != dev or t.dtype is not torch.int32 or not t.is_contiguous() for t in tables):
            raise ValueError("level_eliminate: the plan's tables must be contiguous int32 on one device")
        self.fwd, self.back = walk_schedule(dlp.host_offsets, WALK_MAX)
        self.launches = 2 + len(self.fwd) + len(self.back)
        self.device = dev
        self._offs = np.ascontiguousarray(dlp.host_offsets, np.int64)
        ptr = [t.data_ptr() for t in tables]
        self._args = _LevelWalkArgs(
            dlp.num_bifurcations, dlp.num_levels, len(self.fwd), len(self.back),
            self.fwd.ctypes.data, self.back.ctypes.data, self._offs.ctypes.data, *ptr)

    def address(self, device) -> int:
        if device != self.device:
            raise ValueError(f"level_eliminate: the plan is on {self.device}, the values on {device}")
        return ctypes.addressof(self._args)


def cuda_launches(dlp: DeviceLevelPlan) -> int:
    """CUDA kernel launches of one :func:`level_eliminate` call: prepare,
    the three segment sums (one launch), then the plan's walk
    (:attr:`LevelWalk.launches`: the assembly, the norm, a launch a walk and
    a launch a level wider than :data:`WALK_MAX` each way)."""
    return 2 + dlp.walk.launches


def _prepare_plain(ed: _EdgeData):
    """``(w, (w, const + Ftot), (w, -const))`` per edge (reference ``:2137-2154``)."""
    w_edges = 1.0 / ed.W
    s_is_bif = ed.start_bif >= 0
    t_is_bif = ed.end_bif >= 0
    const = (-ed.start_pbc * (~s_is_bif) + ed.end_pbc * (~t_is_bif) - ed.g) / ed.W
    Ftot = ed.cumF[-1]
    return (
        w_edges,
        torch.stack([w_edges, const + Ftot], dim=-1),
        torch.stack([w_edges, -const], dim=-1),
    )


def _pair_sums_plain(dlp: DeviceLevelPlan, ed: _EdgeData):
    """``(dr (B, 2) permuted, w_pairs (P,))``: the prepare pass and K6's sums."""
    w_edges, vt, vs = _prepare_plain(ed)
    if dlp.num_pairs > 0:
        w_pairs = segsum.segsum_plain(dlp.p_idx, w_edges)
    else:
        w_pairs = torch.zeros(0, dtype=torch.float64, device=ed.W.device)
    dr = segsum.segsum_plain(dlp.t_idx, vt) + segsum.segsum_plain(dlp.s_idx, vs)
    return dr, w_pairs


def level_eliminate_plain(dlp: DeviceLevelPlan, ed: _EdgeData):
    """Eager version: returns ``(λ (B,) public order, ‖rhs‖)``."""
    return _levels_plain(dlp, *_pair_sums_plain(dlp, ed))


def _node_conductances(dlp: DeviceLevelPlan, w_pairs: torch.Tensor, B: int) -> torch.Tensor:
    pp = dlp.parent_pair.long()
    if w_pairs.shape[0]:
        return torch.where(pp >= 0, w_pairs[torch.clamp(pp, min=0)], 0.0)
    return torch.zeros(B, dtype=torch.float64, device=w_pairs.device)


def _levels_plain(dlp: DeviceLevelPlan, dr: torch.Tensor, w_pairs: torch.Tensor):
    """``(λ public, ‖rhs‖)`` from the permuted-order ``dr (B, 2)`` (modified)."""
    dt, dev = torch.float64, dr.device
    B = dlp.num_bifurcations
    rhs_norm = torch.linalg.norm(dr[:, 1])
    w_node = _node_conductances(dlp, w_pairs, B)
    offs = dlp.level_offsets
    L = len(offs) - 1
    for lev in range(L - 1, 0, -1):  # forward: deepest level first
        o, o1, op = offs[lev], offs[lev + 1], offs[lev - 1]
        db, rb = dr[o:o1, 0], dr[o:o1, 1]
        w = w_node[o:o1]
        factor = w / db
        upd = segsum.segsum_plain(dlp.fold_idx[lev - 1], torch.stack([-w * factor, factor * rb], dim=-1))
        dr[op:o] = dr[op:o] + upd
    lam = torch.empty(B, dtype=dt, device=dev)
    lam[: offs[1]] = dr[: offs[1], 1] / dr[: offs[1], 0]  # roots
    parent = dlp.parent_pos.long()
    for lev in range(1, L):  # back-substitution: root down
        o, o1 = offs[lev], offs[lev + 1]
        lam[o:o1] = (dr[o:o1, 1] + w_node[o:o1] * lam[parent[o:o1]]) / dr[o:o1, 0]
    return lam[dlp.perm.long()], rhs_norm


NORM_LANES = 1024  # REDUCE_THREADS in csrc/level_eliminate.cu


def _norm_plain(x: torch.Tensor) -> torch.Tensor:
    """``‖x‖`` in the norm kernel's order: lane ``t`` adds ``x_i²`` for
    ``i ≡ t`` (mod :data:`NORM_LANES`) in ascending ``i``, then the lanes
    are added pairwise by halving strides."""
    m = -(-x.shape[0] // NORM_LANES)
    sq = torch.zeros(max(m, 1) * NORM_LANES, dtype=x.dtype, device=x.device)
    sq[: x.shape[0]] = x * x
    part = torch.zeros(NORM_LANES, dtype=x.dtype, device=x.device)
    for row in sq.view(-1, NORM_LANES):
        part = part + row
    stride = NORM_LANES // 2
    while stride:
        part = torch.cat([part[:stride] + part[stride:2 * stride], part[2 * stride:]])
        stride //= 2
    return torch.sqrt(part[0])


def level_walk_plain(dlp: DeviceLevelPlan, dr: torch.Tensor, w_pairs: torch.Tensor):
    """The kernels' grouping in eager PyTorch: ``(λ public, ‖rhs‖)`` from
    the permuted-order ``dr (B, 2)`` (not modified), each row of the plan's
    schedule in turn — a walk's folds level by level, each parent gathering
    its children's terms as its ``(first, count)`` run and adding them in
    order (a parent without children left as it is), a grid row's fold
    over ``child_ptr``; the back-substitution by the same rows, written in
    the public order through ``inv_perm``; the norm in the kernel's order."""
    B = dlp.num_bifurcations
    d, r = dr[:, 0].clone(), dr[:, 1].clone()
    rhs_norm = _norm_plain(r)
    wn = _node_conductances(dlp, w_pairs, B)
    offs = dlp.level_offsets
    kids, cp = dlp.kids.long(), dlp.child_ptr.long()

    def fold(p: int, walked: bool) -> None:  # level p + 1 into level p
        o, o1, oc, oc1 = offs[p], offs[p + 1], offs[p + 1], offs[p + 2]
        f = wn[oc:oc1] / d[oc:oc1]
        td, tr = -wn[oc:oc1] * f, f * r[oc:oc1]
        if walked:  # a walk reads the run as (first, count), a grid launch child_ptr
            first, count = kids[o:o1, 0], kids[o:o1, 1]
        else:
            first, count = cp[o:o1] - oc, cp[o + 1:o1 + 1] - cp[o:o1]
        ud, ur = torch.zeros_like(d[o:o1]), torch.zeros_like(d[o:o1])
        for k in range(int(count.max()) if o1 > o else 0):
            has = k < count
            at = torch.clamp(first + k, max=max(oc1 - oc - 1, 0))
            ud = torch.where(has, td[at] if k == 0 else ud + td[at], ud)
            ur = torch.where(has, tr[at] if k == 0 else ur + tr[at], ur)
        d[o:o1] = torch.where(count > 0, d[o:o1] + ud, d[o:o1])
        r[o:o1] = torch.where(count > 0, r[o:o1] + ur, r[o:o1])

    for kind, first, last in dlp.walk.fwd.tolist():
        for p in range(last - 1, first - 1, -1) if kind == WALK else (first,):
            fold(p, kind == WALK)
    lam_perm = torch.empty_like(d)
    lam = torch.empty_like(d)
    parent, pub = dlp.parent_pos.long(), dlp.inv_perm.long()
    for _, first, last in dlp.walk.back.tolist():
        for lev in range(first, last + 1):
            o, o1 = offs[lev], offs[lev + 1]
            p = parent[o:o1]
            up = lam_perm[torch.clamp(p, min=0)]
            v = torch.where(p < 0, r[o:o1] / d[o:o1], (r[o:o1] + wn[o:o1] * up) / d[o:o1])
            lam_perm[o:o1] = v
            lam[pub[o:o1]] = v
    return lam, rhs_norm


def level_eliminate_system_plain(dlp: DeviceLevelPlan, dr: torch.Tensor, w_pairs: torch.Tensor):
    """Eager version of :func:`level_eliminate_system`."""
    dr_perm = torch.empty_like(dr)
    dr_perm[dlp.perm.long()] = dr
    return _levels_plain(dlp, dr_perm, w_pairs)


def _outputs(B: int, dev):
    """``(scratch, its four pointers, λ, ‖rhs‖)``: the call's ``d``, ``r``,
    ``wn`` and permuted ``λ`` in one scratch vector, and its results (the
    norm kernel writes ``‖rhs‖``)."""
    scratch = torch.empty(4 * B, dtype=torch.float64, device=dev)
    lam = torch.empty(B, dtype=torch.float64, device=dev)
    rhs_norm = torch.empty((), dtype=torch.float64, device=dev)
    return scratch, [scratch.data_ptr() + 8 * B * i for i in range(4)], lam, rhs_norm


def _empty(dev):
    """``(λ, ‖rhs‖)`` of a forest without bifurcations: nothing to launch."""
    return torch.empty(0, dtype=torch.float64, device=dev), torch.zeros((), dtype=torch.float64, device=dev)


def _count(enqueued: int, counter=None) -> None:
    """Count a launcher's kernels (minus a CUDA error when negative)."""
    if enqueued < 0:
        build.check(-enqueued, "level_eliminate")
    (counter or LAUNCHES).device += enqueued


def level_eliminate_system(dlp: DeviceLevelPlan, dr: torch.Tensor, w_pairs: torch.Tensor):
    """K7 from an assembled system on ``dr``'s device: ``(λ, ‖rhs‖)`` from the
    public-order ``dr (B, 2)`` (diagonal, rhs) and the pair conductances
    ``w_pairs (P,)`` — the sharded general solve's replicated elimination
    (the reference's ``_level_eliminate_core``, ``:2163-2241``)."""
    if dr.device.type == "cpu":
        return level_eliminate_system_plain(dlp, dr, w_pairs)
    build.require_cuda("level_eliminate", dr, w_pairs)
    B = dlp.num_bifurcations
    if tuple(dr.shape) != (B, 2) or tuple(w_pairs.shape) != (dlp.num_pairs,):
        raise ValueError("level_eliminate: dr must be (B, 2) and w_pairs (P,)")
    dev = dr.device
    args = dlp.walk.address(dev)
    if B == 0:
        return _empty(dev)
    _scratch, ptrs, lam, rhs_norm = _outputs(B, dev)
    with torch.cuda.device(dev):
        _count(build.library().nxfx_level_eliminate_system(
            args, w_pairs.data_ptr(), dr.data_ptr(), *ptrs, lam.data_ptr(), rhs_norm.data_ptr(),
            build.stream_handle(dev),
        ))
    LAUNCHES.launches += 1
    return lam, rhs_norm


def level_eliminate(dlp: DeviceLevelPlan, ed: _EdgeData):
    """K7 (with its K6 sums) on the edge data's device: ``(λ, ‖rhs‖)``."""
    if ed.W.device.type == "cpu":
        return level_eliminate_plain(dlp, ed)
    Ftot = ed.cumF[-1]
    build.require_cuda("level_eliminate", ed.W, ed.g, Ftot, ed.start_pbc, ed.end_pbc)
    build.require_cuda("level_eliminate", dlp.start_bif, dlp.end_bif, dtype=torch.int32)
    E, B = dlp.num_edges, dlp.num_bifurcations
    if any(tuple(t.shape) != (E,) for t in (ed.W, ed.g, Ftot, ed.start_pbc, ed.end_pbc)):
        raise ValueError("level_eliminate: the edge data must be (E,) per edge")
    dev = ed.W.device
    args = dlp.walk.address(dev)
    if B == 0:
        return _empty(dev)
    dt = torch.float64
    w_edges = torch.empty(E, dtype=dt, device=dev)
    vt = torch.empty((E, 2), dtype=dt, device=dev)
    vs = torch.empty((E, 2), dtype=dt, device=dev)
    lib = build.library()
    stream = build.stream_handle(dev)
    with torch.cuda.device(dev):
        _count(lib.nxfx_level_prepare(
            E, ed.W.data_ptr(), ed.g.data_ptr(), Ftot.data_ptr(),
            ed.start_pbc.data_ptr(), ed.end_pbc.data_ptr(),
            dlp.start_bif.data_ptr(), dlp.end_bif.data_ptr(),
            w_edges.data_ptr(), vt.data_ptr(), vs.data_ptr(), stream,
        ))
    w_pairs, dt_t, dt_s = segsum.segsum_plan(dlp.sums, w_edges, vt, vs)
    _scratch, ptrs, lam, rhs_norm = _outputs(B, dev)
    with torch.cuda.device(dev):
        _count(lib.nxfx_level_eliminate(
            args, w_pairs.data_ptr(), dt_t.data_ptr(), dt_s.data_ptr(), *ptrs, lam.data_ptr(),
            rhs_norm.data_ptr(), stream,
        ))
    LAUNCHES.launches += 1
    return lam, rhs_norm


def _scenario_count(name: str, dlp: DeviceLevelPlan, ed: _EdgeData) -> int:
    """The scenario count of a sweep's edge data, or raise: ``W``, ``g``
    ``(S, E)``, ``cumF`` ``(S, ·, E)``, the boundary pressures ``(S, E)`` or
    shared ``(E,)``."""
    E = dlp.num_edges
    if ed.W.dim() != 2 or ed.W.shape[1] != E or ed.W.shape[0] < 1:
        raise ValueError(f"{name}: the edge data must be a sweep's, W (S, E)")
    S = int(ed.W.shape[0])
    if (tuple(ed.g.shape) != (S, E) or ed.cumF.dim() != 3 or ed.cumF.shape[0] != S
            or ed.cumF.shape[2] != E):
        raise ValueError(f"{name}: g must be (S, E) and cumF (S, ·, E)")
    build.scenarios(name, (ed.start_pbc, (E,)), (ed.end_pbc, (E,)), S=S)
    return S


def level_eliminate_scenarios_plain(dlp: DeviceLevelPlan, ed: _EdgeData):
    """Eager version of :func:`level_eliminate_scenarios`:
    :func:`level_eliminate_plain` a scenario, stacked ``(λ (S, B), ‖rhs‖ (S,))``."""
    from ..edge_data import scenario_row

    S = _scenario_count("level_eliminate_scenarios", dlp, ed)
    rows = [level_eliminate_plain(dlp, scenario_row(ed, i)) for i in range(S)]
    return torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])


def level_eliminate_scenarios(dlp: DeviceLevelPlan, ed: _EdgeData):
    """K7 (with its K6 sums) of S scenarios on the edge data's device, in the
    launches of one :func:`level_eliminate` call: ``ed`` a sweep's edge data
    (:func:`.edge_data.edge_data_scenarios`, a leading S); returns ``(λ (S,
    B), ‖rhs‖ (S,))``, row ``i`` :func:`level_eliminate` of row ``i`` bit for
    bit."""
    if ed.W.device.type == "cpu":
        return level_eliminate_scenarios_plain(dlp, ed)
    name = "level_eliminate_scenarios"
    S = _scenario_count(name, dlp, ed)
    Ftot = ed.cumF[:, -1]
    build.require_cuda(name, ed.W, ed.g, ed.start_pbc, ed.end_pbc)
    build.require_cuda(name, Ftot, contiguous=False)
    build.require_cuda(name, dlp.start_bif, dlp.end_bif, dtype=torch.int32)
    if Ftot.stride(1) != 1:
        raise ValueError(f"{name}: cumF's rows must be contiguous")
    E, B = dlp.num_edges, dlp.num_bifurcations
    dev, dt = ed.W.device, torch.float64
    args = dlp.walk.address(dev)
    if B == 0:
        return (torch.empty((S, 0), dtype=dt, device=dev),
                torch.zeros(S, dtype=dt, device=dev))
    w_edges = torch.empty((S, E), dtype=dt, device=dev)
    vt = torch.empty((S, E, 2), dtype=dt, device=dev)
    vs = torch.empty((S, E, 2), dtype=dt, device=dev)
    lib = build.library()
    stream = build.stream_handle(dev)
    counter = level_eliminate_scenarios
    with torch.cuda.device(dev):
        _count(lib.nxfx_level_prepare_scen(
            E, S, Ftot.stride(0), build.scenario_stride(ed.start_pbc, (E,)),
            build.scenario_stride(ed.end_pbc, (E,)), ed.W.data_ptr(), ed.g.data_ptr(),
            Ftot.data_ptr(), ed.start_pbc.data_ptr(), ed.end_pbc.data_ptr(),
            dlp.start_bif.data_ptr(), dlp.end_bif.data_ptr(), w_edges.data_ptr(), vt.data_ptr(),
            vs.data_ptr(), stream,
        ), counter)
    w_pairs, dt_t, dt_s = segsum.segsum_plan_scenarios(dlp.sums, w_edges, vt, vs)
    scratch = torch.empty((4, S, B), dtype=dt, device=dev)  # d, r, wn, permuted λ a scenario
    lam = torch.empty((S, B), dtype=dt, device=dev)
    rhs_norm = torch.empty(S, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _count(lib.nxfx_level_eliminate_scen(
            args, S, dlp.num_pairs, w_pairs.data_ptr(), dt_t.data_ptr(), dt_s.data_ptr(),
            *(scratch[j].data_ptr() for j in range(4)), lam.data_ptr(), rhs_norm.data_ptr(),
            stream,
        ), counter)
    level_eliminate_scenarios.launches += 1
    return lam, rhs_norm


level_eliminate_scenarios.launches = 0
level_eliminate_scenarios.device = 0  # kernels enqueued (the launchers report them)
