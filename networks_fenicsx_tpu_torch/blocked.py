"""Blocked-sibling layout of uniformly-K-ary forests (host NumPy planner).

Counterpart of the blocked planner in ``networks_fenicsx_tpu/solver.py``:
``_BlockedLevel``/``_BlockedPlan`` (``:2249-2297``), ``_blocked_walk``,
``_blocked_csr`` and ``_plan_blocked`` (``:2300-2412``),
``_permute_coefficient`` (``:2976-2993``) and
``_condensed_scalar_constants`` (``:440-464``).  The same plan gives the same
elimination order, so values match the reference to roundoff.

The layout renumbers bifurcations level-major with, per level, all
first-siblings before all second-siblings, and edges as ``[root in-edges]
[per level: out-slot 0 block, out-slot 1 block, ...]``: every out slot of a
level is one contiguous ``m``-wide edge block, and child ``j`` (the j-th
bifurcation-targeting slot) of the bifurcation at level position ``i`` sits
at position ``j·m + i`` of the next level.

:func:`device_plan` flattens a plan into index tensors for the kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import typing

import numpy as np
import torch

from .ops import elements

__all__ = ["DevicePlan", "EndsPlan", "IndexedEnds", "device_plan", "ends_plan", "flatten_plan"]


class _BlockedLevel(typing.NamedTuple):
    """One level of the blocked-sibling layout (all values host-static).

    ``in_parts`` are the internal-edge slices holding this level's in-edges
    (widths summing to ``m``, ordered to match the level's bifurcation
    order); ``outs`` is one ``(edge_offset, targets_bif)`` entry per
    out-edge slot — every bifurcation of the level has the same out-degree
    ``len(outs)`` and slot ``j`` of all of them forms one contiguous
    ``m``-wide block."""

    m: int  # number of bifurcations at this level
    in_parts: tuple  # ((start, width), ...) in-edge slices
    outs: tuple  # ((start, targets_bif), ...) per out slot, each m wide

    @property
    def n_bif_outs(self) -> int:
        return sum(1 for _, b in self.outs if b)


class _BlockedPlan(typing.NamedTuple):
    """Interleave-free elimination layout for uniformly-K-ary forests.

    Applies when every bifurcation has exactly one in-edge, all
    bifurcations of a level share one out-degree K (K may vary between
    levels), and each sibling block's targets are uniformly bifurcations
    or uniformly boundary leaves."""

    bif_order: np.ndarray  # (B,) internal position -> public bif index
    edge_order: np.ndarray  # (E,) internal position -> public edge id
    n_roots: int  # root in-edges occupy internal positions [0, n_roots)
    levels: tuple  # tuple[_BlockedLevel]
    bif_offsets: np.ndarray  # (L+1,) internal bif slice bounds per level
    s_is_bif: np.ndarray  # (E,) internal order: edge source is a bif
    t_is_bif: np.ndarray  # (E,) internal order: edge target is a bif


def _blocked_walk(
    roots: np.ndarray,
    in_edge: np.ndarray,
    out_data: np.ndarray,
    out_offs: np.ndarray,
    out_counts: np.ndarray,
    tgt_bif: np.ndarray,
):
    """Level-major sibling-blocked BFS from ``roots``; returns
    ``(bif_order, edge_order, levels, bif_offsets)`` or None when a level
    breaks the uniformity conditions (mixed out-degree or mixed sub-block
    targets)."""
    bif_order_parts = [roots]
    edge_order_parts = [in_edge[roots]]
    levels: list[_BlockedLevel] = []
    offsets = [0, roots.size]
    epos = roots.size  # next free internal edge position
    cur = roots
    in_parts: tuple = ((0, int(roots.size)),)
    while cur.size:
        m = cur.size
        K_arr = out_counts[cur]
        K = int(K_arr[0])
        if not np.all(K_arr == K) or K == 0:
            return None  # mixed out-degree within a level
        out_e = out_data[out_offs[cur][:, None] + np.arange(K)[None, :]]  # (m, K)
        outs = []
        nxt_parts = []
        next_in_parts = []
        for j in range(K):
            ej = out_e[:, j]
            tj = tgt_bif[ej]
            sub_bif = bool(np.all(tj >= 0))
            if not sub_bif and np.any(tj >= 0):
                return None  # mixed targets within a sibling block
            outs.append((epos + j * m, sub_bif))
            edge_order_parts.append(ej)
            if sub_bif:
                nxt_parts.append(tj)
                next_in_parts.append((epos + j * m, m))
        levels.append(_BlockedLevel(m=m, in_parts=in_parts, outs=tuple(outs)))
        epos += K * m
        in_parts = tuple(next_in_parts)
        nxt = np.concatenate(nxt_parts) if nxt_parts else np.empty(0, np.int64)
        if nxt.size:
            bif_order_parts.append(nxt)
            offsets.append(offsets[-1] + nxt.size)
        cur = nxt
    return (
        np.concatenate(bif_order_parts),
        np.concatenate(edge_order_parts).astype(np.int64),
        tuple(levels),
        np.asarray(offsets, dtype=np.int64),
    )


def _blocked_csr(asm):
    """Host CSR arrays for the blocked walk, or None when some bifurcation
    has in-degree != 1."""
    mesh = asm.network
    in_data, in_offs = mesh.bif_in_csr
    out_data, out_offs = mesh.bif_out_csr
    if not np.all(np.diff(in_offs) == 1):
        return None
    return (
        np.asarray(in_data, dtype=np.int64),
        np.asarray(out_data, dtype=np.int64),
        np.asarray(out_offs[:-1], dtype=np.int64),
        np.diff(out_offs).astype(np.int64),
    )


def _plan_blocked(asm) -> _BlockedPlan | None:
    """Build the blocked-sibling plan, or None when the topology is not a
    uniformly-K-ary forest (reference ``_plan_blocked``)."""
    mesh = asm.network
    B = mesh.num_multipliers
    E = mesh.num_edges
    if B == 0:
        return None
    csr = _blocked_csr(asm)
    if csr is None:
        return None
    in_edge, out_data, out_offs, out_counts = csr
    src_bif = np.asarray(asm._edge_start_bif)  # (E,) -1 for boundary source
    tgt_bif = np.asarray(asm._edge_end_bif)

    roots = np.flatnonzero(src_bif[in_edge] < 0)  # bifs fed from a boundary
    if roots.size == 0:
        return None
    roots = np.sort(roots)
    walk = _blocked_walk(roots, in_edge, out_data, out_offs, out_counts, tgt_bif)
    if walk is None:
        return None
    bif_order, edge_order, levels, offsets = walk
    if bif_order.size != B or np.unique(bif_order).size != B:
        return None  # disconnected bifs (e.g. a separate cycle)
    if edge_order.size != E or np.unique(edge_order).size != E:
        return None  # uncovered edges (boundary-to-boundary segments)
    if len(levels) > 512:
        return None  # deep chain-like topologies: one launch group per level
    return _BlockedPlan(
        bif_order=bif_order,
        edge_order=edge_order,
        n_roots=int(roots.size),
        levels=levels,
        bif_offsets=offsets,
        s_is_bif=src_bif[edge_order] >= 0,
        t_is_bif=tgt_bif[edge_order] >= 0,
    )


def _permute_coefficient(arr, mode: str, N: int, edge_order=None):
    """Host-side coefficient relayout: public order -> internal layout.

    ``scalar`` passes through; ``edge`` ``(E,)`` data reorders by
    ``edge_order`` (None = identity); ``cell`` ``(C,)`` public cell order
    becomes j-major ``(N, E)`` blocks (reference ``_permute_coefficient``)."""
    a = np.asarray(arr)
    if mode == "scalar":
        return a
    if mode == "cell":
        a2 = a.reshape(a.size // N, N)
        if edge_order is not None:
            a2 = a2[edge_order]
        return np.ascontiguousarray(a2.T)
    return a if edge_order is None else a[edge_order]


@functools.lru_cache(maxsize=None)
def _condensed_scalar_constants(
    k: int,
) -> tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """Host constants of the degree-k condensed cell matrix.

    For cellwise-constant resistance the cell mass is ``a_c · M̂`` with
    ``M̂`` the reference P_k mass; static condensation of the interior dofs
    commutes with the scaling, so the condensed endpoint matrix is
    ``a_c · M̃̂`` with a fixed ``M̃̂ = M̂_EE − M̂_EI M̂_II⁻¹ M̂_IE``, and the
    interior recovery matrix ``M̂_II⁻¹ M̂_IE`` is scale-free.

    Returns ``(M̃̂ (2, 2), colsum 1ᵀM̃̂ (2,), w̃ = 1ᵀM̃̂1, Minv_IE (k-1, 2))``.
    """
    Mhat = elements.mass_matrix(k)
    if k == 1:
        Mt = Mhat
        Minv = np.zeros((0, 2))
    else:
        ends = [0, k]
        ints = list(range(1, k))
        Minv = np.linalg.solve(Mhat[np.ix_(ints, ints)], Mhat[np.ix_(ints, ends)])
        Mt = Mhat[np.ix_(ends, ends)] - Mhat[np.ix_(ends, ints)] @ Minv
    return Mt, Mt.sum(axis=0), float(Mt.sum()), Minv


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """A :class:`_BlockedPlan` flattened into index tensors on one device.

    Internal order throughout (bifurcations by ``plan.bif_order`` position,
    edges by ``plan.edge_order`` position); ``-1`` marks "none".  Uploaded
    once per plan; the kernels read only these tensors, the plain versions
    only ``plan``.

    Attributes:
        plan: The host plan.
        bif_in: ``(B,)`` int32 in-edge of each bifurcation.
        bif_out: ``(B, K_max)`` int32 out-edges, each row holding its level's
            K entries then ``-1`` padding.
        bif_child: ``(B, K_max)`` int32 children in bifurcation-targeting
            slot order (child ``j`` is the target of the j-th slot that
            targets bifurcations), then ``-1``.
        bif_parent: ``(B,)`` int32 parent bifurcation, ``-1`` for roots.
        level_offsets: host ``(L+1,)`` bifurcation slice bounds per level.
        edge_src: ``(E,)`` int32 source bifurcation, ``-1`` at a boundary.
        edge_tgt: ``(E,)`` int32 target bifurcation, ``-1`` at a boundary.
    """

    plan: _BlockedPlan
    bif_in: torch.Tensor
    bif_out: torch.Tensor
    bif_child: torch.Tensor
    bif_parent: torch.Tensor
    level_offsets: tuple
    edge_src: torch.Tensor
    edge_tgt: torch.Tensor

    @property
    def num_bifurcations(self) -> int:
        return int(self.bif_in.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def max_out(self) -> int:
        return int(self.bif_out.shape[1])


def flatten_plan(plan: _BlockedPlan) -> dict[str, np.ndarray]:
    """Host arrays of :class:`DevicePlan` (see there), built from the
    level structure alone."""
    offs = np.asarray(plan.bif_offsets)
    B = int(offs[-1])
    E = int(plan.edge_order.size)
    Kmax = max(len(lv.outs) for lv in plan.levels)
    bif_in = np.empty(B, np.int64)
    bif_out = np.full((B, Kmax), -1, np.int64)
    bif_child = np.full((B, Kmax), -1, np.int64)
    bif_parent = np.full(B, -1, np.int64)
    edge_src = np.full(E, -1, np.int64)
    edge_tgt = np.full(E, -1, np.int64)
    for l, lv in enumerate(plan.levels):
        base = int(offs[l])
        pos = np.arange(lv.m)
        bifs = base + pos
        bif_in[bifs] = np.concatenate([s + np.arange(w) for s, w in lv.in_parts])
        edge_tgt[bif_in[bifs]] = bifs
        slot = 0
        for j, (o, is_bif) in enumerate(lv.outs):
            edges = o + pos
            bif_out[bifs, j] = edges
            edge_src[edges] = bifs
            if is_bif:
                child = int(offs[l + 1]) + slot * lv.m + pos
                bif_child[bifs, slot] = child
                bif_parent[child] = bifs
                slot += 1
    return dict(
        bif_in=bif_in,
        bif_out=bif_out,
        bif_child=bif_child,
        bif_parent=bif_parent,
        edge_src=edge_src,
        edge_tgt=edge_tgt,
    )


def device_plan(plan: _BlockedPlan, device: torch.device | str) -> DevicePlan:
    """Upload the flattened plan to ``device`` (int32 index tensors)."""
    host = flatten_plan(plan)
    tensors = {
        k: torch.as_tensor(v.astype(np.int32), device=device) for k, v in host.items()
    }
    return DevicePlan(
        plan=plan,
        level_offsets=tuple(int(o) for o in plan.bif_offsets),
        **tensors,
    )


class IndexedEnds(typing.NamedTuple):
    """Edge ends by index into a multiplier vector, for rows that no level
    structure orders (a shard's rows, whose ends reach past its own
    bifurcations): ``edge_src``/``edge_tgt (E,)``, ``-1`` at a boundary."""

    edge_src: np.ndarray
    edge_tgt: np.ndarray

    @property
    def s_is_bif(self) -> np.ndarray:
        return self.edge_src >= 0

    @property
    def t_is_bif(self) -> np.ndarray:
        return self.edge_tgt >= 0


@dataclasses.dataclass(frozen=True)
class EndsPlan:
    """An :class:`IndexedEnds` on one device: what K1 and K5 read of a plan
    (``edge_src``, ``edge_tgt`` int32, and the λ length
    ``num_bifurcations`` they index)."""

    plan: IndexedEnds
    edge_src: torch.Tensor
    edge_tgt: torch.Tensor
    num_bifurcations: int

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])


def ends_plan(edge_src, edge_tgt, n_lambda: int, device: torch.device | str) -> EndsPlan:
    """Upload edge ends indexing a λ vector of length ``n_lambda``."""
    src = np.asarray(edge_src, np.int64)
    tgt = np.asarray(edge_tgt, np.int64)

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    return EndsPlan(plan=IndexedEnds(src, tgt), edge_src=i32(src), edge_tgt=i32(tgt),
                    num_bifurcations=int(n_lambda))
