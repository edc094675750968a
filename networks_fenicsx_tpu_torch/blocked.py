"""Blocked-sibling layout of uniformly-K-ary forests (host NumPy planner).

Counterpart of the blocked planner in ``networks_fenicsx_tpu/solver.py``:
``_BlockedLevel``/``_BlockedPlan`` (``:2249-2297``), ``_blocked_walk``,
``_blocked_csr`` and ``_plan_blocked`` (``:2300-2412``),
``_permute_coefficient`` (``:2976-2993``, and its batched mirror of
``batch.py:248-257``) and
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

__all__ = [
    "DevicePlan", "EndsPlan", "IndexedEnds", "SweepPlan", "block_nodes", "check_sweep_plan",
    "device_plan", "ends_plan", "flatten_plan", "sweep_plan",
]


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


def _permute_coefficient_batch(arr, mode: str, edge_order=None) -> np.ndarray:
    """:func:`_permute_coefficient` of each row of an ``(S, ...)`` batch, in
    one relayout: ``(S, C)`` cell data to ``(S, N, E)`` j-major blocks,
    ``(S, E)`` edge data reordered, anything else (and everything when
    ``edge_order`` is None) as it is."""
    a = np.asarray(arr, dtype=np.float64)
    if edge_order is not None and mode == "cell":
        E = edge_order.shape[0]
        return np.ascontiguousarray(a.reshape(a.shape[0], E, -1)[:, edge_order].swapaxes(1, 2))
    if edge_order is not None and mode != "scalar":
        return np.ascontiguousarray(a[:, edge_order])
    return a


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


# The subtree-blocked sweep (K2–K4, kernels/csrc/tree_sweep.cu): the plan's
# constants, read when a sweep plan is made (tests monkeypatch them).
TOP_MAX = 2048  # nodes of the top, the levels above the cut, walked by one block
TOP_THREADS = 256  # the top block (a power of two: the norm's halving tree)
MIN_SUBTREES = 256  # the cut: the first level at least this wide whose top fits
SUB_NODES = 256  # nodes a subtree block aims at
SUB_THREADS = 256  # the most threads of a subtree block (a power of two)
SMS = 132  # the H100's SMs: a subtree launch keeps at least this many blocks where it can
SUB_SMEM = 96 * 1024  # a subtree block's d, r, wn in shared memory up to this many bytes
LEVEL_WORDS = 5  # a level's row of the device table: offset, width, children, runs, run prefix


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """How the blocked sweep is cut into launches (see ``kernels/csrc/tree_sweep.cu``).

    The **top** is levels ``0 … cut−1``, internal positions ``[0, top_nodes)``,
    walked by one block.  The **bottom** is the subtrees rooted at level
    ``cut``: the descendants of the node at position ``q`` of level ``cut``
    sit, at each level ``l ≥ cut``, at the positions ``p ≡ q (mod m_cut)``
    (child ``s`` of position ``p`` of level ``l`` is ``s·m_l + p`` of level
    ``l + 1``), so ``R_l = m_l / m_cut`` runs of one position each.
    Subtree block ``b`` takes the ``g_b = min(group, m_cut − b·group)``
    subtrees ``q0 = b·group, …``; at level ``l`` it holds ``R_l`` runs of
    ``g_b`` consecutive positions at stride ``m_cut``, its local node
    ``g_b·P_l + r·g_b + j`` being position ``r·m_cut + q0 + j``
    (``P_l = Σ_{cut ≤ l' < l} R_l'``).

    Attributes:
        cut, group, blocks: the cut level, subtrees a block and subtree blocks.
        threads: a subtree block's threads (a power of two).
        top_threads: the top block's threads (:data:`TOP_THREADS`).
        block_nodes: the nodes of a full subtree block, ``group·P_L``.
        top_nodes: the top's nodes, ``offsets[cut]``.
        smem: whether a subtree block keeps its values in shared memory.
        host_levels: ``(L, 5)`` int64 rows ``(offset, width m_l, bifurcation
            children a node, R_l, P_l)``; ``R_l = P_l = 0`` above the cut.
        levels: the same table, int32, on the plan's device.
    """

    cut: int
    group: int
    blocks: int
    threads: int
    top_threads: int
    block_nodes: int
    top_nodes: int
    smem: bool
    host_levels: np.ndarray
    levels: torch.Tensor

    @property
    def num_levels(self) -> int:
        return int(self.host_levels.shape[0])


def _sweep_cut(offs: np.ndarray, widths: np.ndarray) -> int:
    """The cut: every level (``L``, one launch) when the forest fits the
    top, else the first level ``c ≥ 1`` at least :data:`MIN_SUBTREES` wide
    whose top fits (``offs[c] ≤ TOP_MAX``), else the deepest level whose
    top fits; 0 when not even level 0 fits."""
    L = widths.size
    if offs[L] <= TOP_MAX:
        return L
    fits = [c for c in range(1, L + 1) if offs[c] <= TOP_MAX]
    if not fits:
        return 0
    wide = [c for c in fits if c < L and widths[c] >= MIN_SUBTREES]
    return wide[0] if wide else fits[-1]


def sweep_plan(plan: _BlockedPlan, bif_child: np.ndarray, device: torch.device | str) -> SweepPlan:
    """The subtree-blocked sweep of ``plan`` (its constants this module's),
    checked by :func:`check_sweep_plan` against ``bif_child``
    (:func:`flatten_plan`'s) and its level table uploaded."""
    offs = np.asarray(plan.bif_offsets, np.int64)
    widths = np.asarray([lv.m for lv in plan.levels], np.int64)
    L = widths.size
    c = _sweep_cut(offs, widths)
    table = np.zeros((L, LEVEL_WORDS), np.int64)
    table[:, 0], table[:, 1] = offs[:L], widths
    table[: L - 1, 2] = widths[1:] // widths[:-1]
    if c < L:
        table[c:, 3] = widths[c:] // widths[c]
        table[c:, 4] = np.concatenate([[0], np.cumsum(table[c:-1, 3])])
        S = int(table[-1, 3] + table[-1, 4])  # a subtree's nodes
        mc = int(widths[c])
        group = max(1, min(SUB_NODES // S, mc // SMS))
        blocks = -(-mc // group)
        nodes = group * S
        threads = min(SUB_THREADS, 1 << max(5, (nodes - 1).bit_length()))
    else:
        group = blocks = nodes = 0
        threads = 32
    sp = SweepPlan(
        cut=c, group=group, blocks=blocks, threads=threads, top_threads=TOP_THREADS,
        block_nodes=nodes,
        top_nodes=int(offs[c]), smem=3 * 8 * nodes <= SUB_SMEM, host_levels=table,
        levels=torch.as_tensor(table.astype(np.int32), device=device),
    )
    check_sweep_plan(sp, bif_child)
    return sp


def block_nodes(sp: SweepPlan, b: int) -> np.ndarray:
    """Subtree block ``b``'s nodes (internal positions) in its local order."""
    t, c, g = sp.host_levels, sp.cut, sp.group
    q0 = b * g
    gb = min(g, int(t[c, 1]) - q0)
    mc = int(t[c, 1])
    out = [int(t[l, 0]) + (np.arange(int(t[l, 3]))[:, None] * mc + q0 + np.arange(gb)[None, :]).ravel()
           for l in range(c, sp.num_levels)]
    return np.concatenate(out)


def check_sweep_plan(sp: SweepPlan, bif_child: np.ndarray) -> None:
    """Raise ``ValueError("sweep plan: ...")`` unless every bifurcation is in
    exactly one subtree block or in the top, each block is closed under
    ``bif_child`` (the top's children in the top or at the cut), and the top
    fits one block."""
    bif_child = np.asarray(bif_child)
    B, L, c = bif_child.shape[0], sp.num_levels, sp.cut
    t = sp.host_levels
    if sp.top_nodes > TOP_MAX or (c > 0 and sp.top_nodes != int(t[c - 1, 0] + t[c - 1, 1])):
        raise ValueError(f"sweep plan: a top of {sp.top_nodes} nodes does not fit one block")
    if B and int(t[-1, 0] + t[-1, 1]) != B:
        raise ValueError("sweep plan: the level table does not cover the bifurcations")
    owner = np.full(B, -2, np.int64)
    owner[: sp.top_nodes] = -1
    for b in range(sp.blocks):
        nodes = block_nodes(sp, b)
        if nodes.size and (nodes.min() < sp.top_nodes or nodes.max() >= B):
            raise ValueError(f"sweep plan: block {b} names a node outside the bottom")
        if np.any(owner[nodes] != -2):
            raise ValueError(f"sweep plan: a node of block {b} is in two blocks")
        owner[nodes] = b
        if nodes.size > sp.block_nodes:
            raise ValueError(f"sweep plan: block {b} holds {nodes.size} > {sp.block_nodes} nodes")
    if np.any(owner == -2):
        raise ValueError(f"sweep plan: {int(np.sum(owner == -2))} bifurcations in no block")
    kids = bif_child.reshape(B, -1)
    par = np.repeat(np.arange(B), kids.shape[1])
    kid = kids.ravel()
    ok = kid >= 0
    par, kid = par[ok], kid[ok]
    top_par = owner[par] == -1
    cut_lo = sp.top_nodes
    cut_hi = int(t[c, 0] + t[c, 1]) if c < L else cut_lo
    bad_top = top_par & (owner[kid] != -1) & ~((kid >= cut_lo) & (kid < cut_hi))
    if np.any(bad_top) or np.any(~top_par & (owner[kid] != owner[par])):
        raise ValueError("sweep plan: a block is not closed under bif_child")


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
        bif_parent: ``(B,)`` int32 parent bifurcation, ``-1`` for roots.
        level_offsets: host ``(L+1,)`` bifurcation slice bounds per level.
        edge_src: ``(E,)`` int32 source bifurcation, ``-1`` at a boundary.
        edge_tgt: ``(E,)`` int32 target bifurcation, ``-1`` at a boundary.
        sweep: the subtree-blocked sweep (:class:`SweepPlan`), checked.
    """

    plan: _BlockedPlan
    bif_in: torch.Tensor
    bif_out: torch.Tensor
    bif_parent: torch.Tensor
    level_offsets: tuple
    edge_src: torch.Tensor
    edge_tgt: torch.Tensor
    sweep: SweepPlan
    # a kernel's fixed launch state on this plan (K1's :class:`.kernels.condense.Batch`)
    _scratch: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

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
    level structure alone, and ``bif_child (B, K_max)``: the children in
    bifurcation-targeting slot order (child ``j`` is the target of the j-th
    slot that targets bifurcations), then ``-1`` (what the sweep plan's
    check holds the subtree blocks to)."""
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
    """Upload the flattened plan to ``device`` (int32 index tensors) with
    its checked sweep plan."""
    host = flatten_plan(plan)
    tensors = {
        k: torch.as_tensor(v.astype(np.int32), device=device) for k, v in host.items()
        if k != "bif_child"
    }
    return DevicePlan(
        plan=plan,
        level_offsets=tuple(int(o) for o in plan.bif_offsets),
        sweep=sweep_plan(plan, host["bif_child"], device),
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
    # a kernel's fixed launch state on these ends (K1's :class:`.kernels.condense.Batch`)
    _scratch: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

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
