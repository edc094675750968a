"""Elimination plans of the bifurcation graph (host NumPy + SciPy planners).

Counterpart of the tree and level planners in
``networks_fenicsx_tpu/solver.py``: ``_TreePlan`` and
``_plan_tree_elimination`` (``:1617-1733``), ``attach_core_plan``
(``:1735-1817``), ``_cached_tree_plan``
(``:3384-3410``), ``_LevelPlan`` and ``_plan_level_elimination``
(``:1820-1965``), ``_LambdaPlan`` and ``_build_lambda_plan``
(``:673-697``).  The same inputs give ``np.array_equal`` plans, so the
elimination order, and with it every rounding, follows the reference.

:func:`device_level_plan` flattens a level plan into the index tensors the
general-forest kernels read (:mod:`.kernels.segsum`,
:mod:`.kernels.level_eliminate`, :mod:`.kernels.backsub`); the cyclic
counterpart is :func:`.tree.device_tree_plan`.
"""

from __future__ import annotations

import dataclasses
import functools
import typing

import numpy as np
import torch

__all__ = [
    "DeviceLevelPlan",
    "attach_core_plan",
    "device_level_plan",
    "flatten_level_plan",
    "segsum_matrix",
]


class _TreePlan(typing.NamedTuple):
    """Static peel-then-core elimination plan for the bifurcation graph.

    Degree-≤1 nodes eliminate fill-in-free in rounds (exact for forests);
    whatever cycle core remains is solved densely or by the sparse core
    plan :func:`attach_core_plan` attaches.
    """

    pair_nodes: np.ndarray  # (P, 2) bifurcation index pairs with >=1 edge
    edge_pair: np.ndarray  # (E,) pair id of each graph edge, -1 if not bif-bif
    rounds: tuple  # tuple of (elim_nodes, parents, pair_ids) int32 arrays
    core_nodes: np.ndarray = np.empty(0, np.int32)  # un-peeled (cycle) nodes
    core_pairs: np.ndarray = np.empty((0, 3), np.int32)  # (ci, cj, pair_id)
    core_plan: "object | None" = None  # MFPlan, CoreElimPlan or None

    @property
    def core_size(self) -> int:
        return int(self.core_nodes.size)


def _plan_tree_elimination(asm, force_rounds: bool = False) -> _TreePlan:
    """Build the peel order plus the residual cycle core (empty for forests).

    ``force_rounds=True`` computes the peel rounds even for forests (the
    fast path otherwise returns ``rounds=()``, because the level plan
    supersedes them)."""
    mesh = asm.network
    B = mesh.num_multipliers
    if B == 0:
        return _TreePlan(np.empty((0, 2), np.int64), np.full(mesh.num_edges, -1, np.int64), ())

    s_bif = asm._edge_start_bif
    t_bif = asm._edge_end_bif
    both = (s_bif >= 0) & (t_bif >= 0)
    a = np.minimum(s_bif[both], t_bif[both])
    b = np.maximum(s_bif[both], t_bif[both])
    pairs, pair_of_bb = np.unique(np.stack([a, b], 1), axis=0, return_inverse=True)
    pair_of_bb = pair_of_bb.reshape(-1)
    edge_pair = np.full(mesh.num_edges, -1, dtype=np.int64)
    edge_pair[both] = pair_of_bb
    P = pairs.shape[0]

    # Forest fast path: a graph is a forest iff #pairs == #nodes - #components.
    if P > 0:
        import scipy.sparse as _sp
        from scipy.sparse.csgraph import connected_components as _cc

        adjm = _sp.coo_matrix((np.ones(P), (pairs[:, 0], pairs[:, 1])), shape=(B, B))
        n_comp = _cc(adjm, directed=False)[0]
    else:
        n_comp = B
    if P == B - n_comp and not force_rounds:
        return _TreePlan(pairs, edge_pair, ())

    adj: list[dict[int, int]] = [dict() for _ in range(B)]  # node -> {nbr: pair}
    for p_id, (u, v) in enumerate(pairs):
        adj[u][v] = p_id
        adj[v][u] = p_id
    degree = np.array([len(d) for d in adj])
    alive = np.ones(B, dtype=bool)
    rounds = []
    remaining = B
    while remaining > 0:
        cand = np.flatnonzero(alive & (degree <= 1))
        if cand.size == 0:
            break  # a cycle core remains
        # independent set: skip a leaf whose (leaf) neighbour has lower id
        chosen = []
        cand_set = set(int(c) for c in cand)
        for c in cand:
            nbrs = [n for n in adj[c] if alive[n]]
            if nbrs and nbrs[0] in cand_set and nbrs[0] < c:
                continue
            chosen.append(int(c))
        elim = np.array(chosen, dtype=np.int32)
        parents = np.full(elim.size, -1, dtype=np.int32)
        pair_ids = np.full(elim.size, -1, dtype=np.int32)
        for i, c in enumerate(elim):
            nbrs = [n for n in adj[c] if alive[n]]
            if nbrs:
                parents[i] = nbrs[0]
                pair_ids[i] = adj[c][nbrs[0]]
        rounds.append((elim, parents, pair_ids))
        for i, c in enumerate(elim):
            alive[c] = False
            if parents[i] >= 0:
                degree[parents[i]] -= 1
        remaining -= elim.size

    core_nodes = np.flatnonzero(alive).astype(np.int32)
    core_pairs = np.empty((0, 3), np.int32)
    if core_nodes.size:
        # peeling creates no new couplings: the core's off-diagonals are
        # the original pairs with both endpoints alive
        in_core = np.zeros(B, dtype=bool)
        in_core[core_nodes] = True
        core_rank = np.full(B, -1, np.int64)
        core_rank[core_nodes] = np.arange(core_nodes.size)
        sel = in_core[pairs[:, 0]] & in_core[pairs[:, 1]]
        pid = np.flatnonzero(sel)
        core_pairs = np.stack(
            [core_rank[pairs[sel, 0]], core_rank[pairs[sel, 1]], pid], axis=1
        ).astype(np.int32)
    return _TreePlan(pairs, edge_pair, tuple(rounds), core_nodes, core_pairs)


def attach_core_plan(
    tree_plan: _TreePlan,
    dense_cutoff: int = 384,
    max_core: int = 300_000,
    tail_stop: bool = True,
) -> _TreePlan:
    """Attach a sparse core-elimination plan when the cycle core admits one.

    A core above 2,048 nodes is first planned by the tree multifrontal
    engine (:func:`.ops.multifrontal.plan_multifrontal`); a refused or
    smaller core of at most 65,536 nodes by the min-degree planner
    (:func:`.ops.core_elim.plan_core_elimination`), and above 4,096 nodes,
    when that blows its fill budget, by the same planner on a
    nested-dissection order with a dense tail of up to 8,192 nodes or
    supernodal fronts beyond it (retried without the front-stop when a front
    outgrows its cap).  Returns the plan unchanged when it has a core plan
    already, no core, a core above ``max_core``, or no planner succeeds
    (callers then keep the dense / CG behaviour)."""
    if tree_plan.core_plan is not None or tree_plan.core_size == 0:
        return tree_plan
    if tree_plan.core_size > max_core:
        return tree_plan
    from .ops.core_elim import nested_dissection_order, plan_core_elimination

    cp = None
    if tree_plan.core_size > 2048:
        from .ops.multifrontal import plan_multifrontal

        cp = plan_multifrontal(np.asarray(tree_plan.core_pairs), tree_plan.core_size)
    if cp is None and tree_plan.core_size <= 65_536:
        cp = plan_core_elimination(
            tree_plan.core_pairs, tree_plan.core_size, dense_cutoff=dense_cutoff,
            tail_stop=tail_stop,
        )
    if cp is None and tree_plan.core_size > 4096:
        nd = nested_dissection_order(np.asarray(tree_plan.core_pairs), tree_plan.core_size, leaf=8)
        nd_kwargs = dict(
            dense_cutoff=8192, kcap=64, tail_stop=tail_stop, order=nd, dense_cap=8192,
            supernodal_tail=True,
        )
        cp = plan_core_elimination(tree_plan.core_pairs, tree_plan.core_size, **nd_kwargs)
        if cp is None:
            cp = plan_core_elimination(
                tree_plan.core_pairs, tree_plan.core_size, front_stop=False, **nd_kwargs
            )
    if cp is None:
        return tree_plan
    return tree_plan._replace(core_plan=cp)


def _cached_tree_plan(asm, force_rounds: bool = False, attach: bool = False) -> _TreePlan:
    """Memoized :func:`_plan_tree_elimination` / :func:`attach_core_plan`.

    The plan depends on the topology only, fixed at assembler
    construction, so executors built over one assembler share it and the
    host symbolic phase is paid once per assembler.  The attached core
    plan is shared across the ``force_rounds`` variants, which must have
    equal ``core_pairs`` (asserted).  Device payloads are not cached here:
    each executor uploads its own and keeps it for its lifetime."""
    cache = asm.__dict__.setdefault("_nxfx_plan_cache", {})
    key = ("plan", force_rounds)
    if key not in cache:
        cache[key] = _plan_tree_elimination(asm, force_rounds=force_rounds)
    plan = cache[key]
    if not attach or plan.core_size == 0:
        return plan
    akey = ("attached", force_rounds)
    if akey not in cache:
        other = cache.get(("attached", not force_rounds))
        if other is not None and other.core_plan is not None:
            assert np.array_equal(other.core_pairs, plan.core_pairs)
            cache[akey] = plan._replace(core_plan=other.core_plan)
        else:
            cache[akey] = attach_core_plan(plan)
    return cache[akey]


class _LambdaPlan(typing.NamedTuple):
    """Sorted-segment plan for assembling the bifurcation system: the
    edge → bifurcation incidences of each side, sorted once on the host,
    turn the (E → B) reductions into sorted segment sums plus adds into
    sorted unique bins."""

    t_sel: np.ndarray  # edges with a bifurcation at their target, sorted by it
    t_bins: np.ndarray  # sorted unique target bifurcations
    t_seg: np.ndarray  # segment id of each t_sel entry
    s_sel: np.ndarray
    s_bins: np.ndarray
    s_seg: np.ndarray


def _build_lambda_plan(asm) -> _LambdaPlan:
    def side(bif: np.ndarray):
        sel = np.flatnonzero(bif >= 0)
        order = sel[np.argsort(bif[sel], kind="stable")]
        bins, seg = np.unique(bif[order], return_inverse=True)
        return order.astype(np.int32), bins.astype(np.int32), seg.astype(np.int32)

    t_sel, t_bins, t_seg = side(asm._edge_end_bif)
    s_sel, s_bins, s_seg = side(asm._edge_start_bif)
    return _LambdaPlan(t_sel, t_bins, t_seg, s_sel, s_bins, s_seg)


class _LevelPlan(typing.NamedTuple):
    """Elimination plan for forest bifurcation graphs.

    Bifurcations are permuted into root-down level order, each level
    grouped by parent; elimination runs deepest level first."""

    perm: np.ndarray  # (B,) original bif index -> permuted position
    inv_perm: np.ndarray  # (B,) permuted position -> original bif index
    level_offsets: np.ndarray  # (L+1,) slice bounds per depth level
    parent_pos: np.ndarray  # (B,) permuted parent position (-1 for roots)
    parent_pair: np.ndarray  # (B,) pair id to parent (-1 for roots)
    # λ-system assembly (sorted segment sums in permuted order)
    t_sel: np.ndarray
    t_seg: np.ndarray
    s_sel: np.ndarray
    s_seg: np.ndarray
    # sorted edge -> pair aggregation for the pair conductances
    p_sel: np.ndarray
    p_seg: np.ndarray
    num_pairs: int


def _plan_level_elimination(asm, tree_plan: _TreePlan) -> _LevelPlan | None:
    """Build the level plan; None when the bifurcation graph has cycles."""
    if tree_plan.core_size > 0:
        return None
    mesh = asm.network
    B = mesh.num_multipliers
    pairs = tree_plan.pair_nodes
    P = pairs.shape[0]

    # frontier BFS over symmetric half-edge arrays (src, dst, pair id)
    if P > 0:
        src = np.concatenate([pairs[:, 0], pairs[:, 1]])
        dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
        pid2 = np.concatenate([np.arange(P), np.arange(P)])
        order_by_src = np.argsort(src, kind="stable")
        src_s, dst_s, pid_s = src[order_by_src], dst[order_by_src], pid2[order_by_src]
        starts = np.searchsorted(src_s, np.arange(B + 1))
    else:
        dst_s = pid_s = np.empty(0, np.int64)
        starts = np.zeros(B + 1, np.int64)

    depth = np.full(B, -1, np.int64)
    parent = np.full(B, -1, np.int64)
    parent_pairid = np.full(B, -1, np.int64)
    unvisited = np.ones(B, dtype=bool)
    # roots: every component's minimum-id node (SciPy's component labels)
    import scipy.sparse as _sp
    from scipy.sparse.csgraph import connected_components as _cc

    if P > 0:
        adjm = _sp.coo_matrix((np.ones(P), (pairs[:, 0], pairs[:, 1])), shape=(B, B))
        _, labels = _cc(adjm, directed=False)
    else:
        labels = np.arange(B)
    _, first_idx = np.unique(labels, return_index=True)
    roots = np.sort(first_idx)
    depth[roots] = 0
    unvisited[roots] = False
    frontier = roots
    d = 0
    while frontier.size:
        counts = starts[frontier + 1] - starts[frontier]
        total = int(counts.sum())
        if total:
            offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
            idx = np.repeat(starts[frontier] - offsets, counts) + np.arange(total)
            cand_dst = dst_s[idx]
            cand_pid = pid_s[idx]
            cand_src = np.repeat(frontier, counts)
            new_mask = unvisited[cand_dst]
            nd, npid, nsrc = cand_dst[new_mask], cand_pid[new_mask], cand_src[new_mask]
            uniq, ui = np.unique(nd, return_index=True)
            depth[uniq] = d + 1
            parent[uniq] = nsrc[ui]
            parent_pairid[uniq] = npid[ui]
            unvisited[uniq] = False
            frontier = uniq
        else:
            frontier = np.empty(0, np.int64)
        d += 1

    # permute: levels ascending; within a level grouped by parent position,
    # so the children of one parent are contiguous and ordered
    max_depth = int(depth.max())
    perm = np.empty(B, np.int64)
    pos = 0
    level_offsets = [0]
    prev_positions = np.full(B, -1, np.int64)
    for d in range(max_depth + 1):
        nodes = np.flatnonzero(depth == d)
        if d > 0:
            nodes = nodes[np.argsort(prev_positions[parent[nodes]], kind="stable")]
        perm[nodes] = pos + np.arange(nodes.size)
        prev_positions[nodes] = perm[nodes]
        pos += nodes.size
        level_offsets.append(pos)

    inv_perm = np.argsort(perm)
    parent_pos = np.full(B, -1, np.int64)
    has_parent = parent >= 0
    parent_pos[perm[has_parent.nonzero()[0]]] = perm[parent[has_parent]]
    parent_pair = np.full(B, -1, np.int64)
    parent_pair[perm[has_parent.nonzero()[0]]] = parent_pairid[has_parent]

    def side(bif: np.ndarray):
        sel = np.flatnonzero(bif >= 0)
        key = perm[bif[sel]]
        order_ = sel[np.argsort(key, kind="stable")]
        return order_.astype(np.int32), np.sort(key).astype(np.int32)

    t_sel, t_seg = side(asm._edge_end_bif)
    s_sel, s_seg = side(asm._edge_start_bif)
    ep = tree_plan.edge_pair
    p_sel = np.flatnonzero(ep >= 0)
    p_order = p_sel[np.argsort(ep[p_sel], kind="stable")]
    return _LevelPlan(
        perm=perm.astype(np.int32),
        inv_perm=inv_perm.astype(np.int32),
        level_offsets=np.asarray(level_offsets, np.int64),
        parent_pos=parent_pos.astype(np.int32),
        parent_pair=parent_pair.astype(np.int32),
        t_sel=t_sel,
        t_seg=t_seg,
        s_sel=s_sel,
        s_seg=s_seg,
        p_sel=p_order.astype(np.int32),
        p_seg=np.sort(ep[p_sel]).astype(np.int32),
        num_pairs=P,
    )


def segsum_matrix(
    seg_sorted: np.ndarray, num_segments: int, n_vals: int, sel: np.ndarray | None = None
) -> np.ndarray:
    """The ``(num_segments, K)`` gather matrix of a sorted-segment sum.

    Row ``s`` lists the value rows of segment ``s`` in order (``sel``
    composed in), padded with ``n_vals`` — the zero slot — to the widest
    segment's ``K``, exactly as the reference's ``_segsum_sorted`` builds it
    (``:2099-2110``).  Any ``K`` is kept (the reference hands ``K > 32`` to
    ``segment_sum``; the sum is the same)."""
    seg = np.asarray(seg_sorted)
    n_in = seg.shape[0]
    if n_in == 0 or num_segments == 0:
        return np.zeros((num_segments, 0), np.int64)
    counts = np.bincount(seg, minlength=num_segments)
    K = int(counts.max())
    offsets = np.concatenate([[0], np.cumsum(counts)])
    idx = offsets[:-1, None] + np.arange(K)[None, :]
    valid = np.arange(K)[None, :] < counts[:, None]
    if sel is not None:
        idx = np.where(valid, np.asarray(sel)[np.minimum(idx, n_in - 1)], n_vals)
    else:
        idx = np.where(valid, idx, n_vals)
    return idx.astype(np.int64)


def flatten_level_plan(lp: _LevelPlan, tree_plan: _TreePlan) -> dict[str, np.ndarray]:
    """Host arrays of :class:`DeviceLevelPlan` (see there), from the two
    plans alone."""
    E = int(tree_plan.edge_pair.size)
    B = int(lp.perm.size)
    inv_perm = np.asarray(lp.inv_perm, np.int64)
    parent_pos = np.asarray(lp.parent_pos, np.int64)
    # children of a parent are contiguous: non-root positions have
    # non-decreasing parent positions (levels ascend, each grouped by parent)
    n_roots = int(lp.level_offsets[1]) if B else 0
    child_ptr = n_roots + np.searchsorted(parent_pos[n_roots:], np.arange(B + 1), side="left")
    # each edge end's bifurcation, back from the sorted side selections
    start_bif = np.full(E, -1, np.int64)
    start_bif[lp.s_sel] = inv_perm[lp.s_seg]
    end_bif = np.full(E, -1, np.int64)
    end_bif[lp.t_sel] = inv_perm[lp.t_seg]
    return dict(
        p_idx=segsum_matrix(lp.p_seg, lp.num_pairs, E, sel=lp.p_sel),
        t_idx=segsum_matrix(lp.t_seg, B, E, sel=lp.t_sel),
        s_idx=segsum_matrix(lp.s_seg, B, E, sel=lp.s_sel),
        perm=np.asarray(lp.perm, np.int64),
        parent_pos=parent_pos,
        parent_pair=np.asarray(lp.parent_pair, np.int64),
        child_ptr=child_ptr.astype(np.int64),
        start_bif=start_bif,
        end_bif=end_bif,
    )


@dataclasses.dataclass(frozen=True)
class DeviceLevelPlan:
    """A :class:`_LevelPlan` flattened into int32 index tensors on one device.

    Uploaded once per executor; the kernels and the plain versions read
    the same tensors.

    Attributes:
        plan: The host level plan.
        p_idx: ``(P, Kp)`` gather matrix of the edge → pair conductance sum.
        t_idx: ``(B, Kt)`` gather matrix of the target-side (diag, rhs) sum.
        s_idx: ``(B, Ks)`` gather matrix of the source-side (diag, rhs) sum.
            All three index rows of an ``(E, C)`` value array; ``E`` is the
            zero pad slot.
        perm: ``(B,)`` public bifurcation -> permuted position.
        parent_pos: ``(B,)`` permuted parent position, ``-1`` for roots.
        parent_pair: ``(B,)`` pair to the parent, ``-1`` for roots.
        child_ptr: ``(B + 1,)`` children of permuted node ``p`` are the
            positions ``[child_ptr[p], child_ptr[p + 1])``, in order.
        start_bif, end_bif: ``(E,)`` public bifurcation at each edge end,
            ``-1`` at a boundary node.
        level_offsets: host ``(L+1,)`` permuted slice bounds per level, as
            a tuple and as the contiguous int64 array the level kernels'
            launcher reads (built once, not per solve).
    """

    plan: _LevelPlan
    p_idx: torch.Tensor
    t_idx: torch.Tensor
    s_idx: torch.Tensor
    perm: torch.Tensor
    parent_pos: torch.Tensor
    parent_pair: torch.Tensor
    child_ptr: torch.Tensor
    start_bif: torch.Tensor
    end_bif: torch.Tensor
    level_offsets: tuple
    host_offsets: np.ndarray

    @functools.cached_property
    def fold_idx(self) -> tuple:
        """Per level ``l >= 1``: the ``(m_{l-1}, K)`` gather matrix summing
        level ``l``'s terms into their parents (the reference's per-level
        ``_segsum_sorted``), entry ``l - 1``; the plain versions read it."""
        offs = self.level_offsets
        pp = np.asarray(self.plan.parent_pos, np.int64)
        mats = []
        for lev in range(1, len(offs) - 1):
            o, o1, op = offs[lev], offs[lev + 1], offs[lev - 1]
            mats.append(torch.as_tensor(
                segsum_matrix(pp[o:o1] - op, o - op, o1 - o), device=self.perm.device
            ))
        return tuple(mats)

    @property
    def num_bifurcations(self) -> int:
        return int(self.perm.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.start_bif.shape[0])

    @property
    def num_pairs(self) -> int:
        return int(self.plan.num_pairs)

    @property
    def num_levels(self) -> int:
        return len(self.level_offsets) - 1


def device_level_plan(
    level_plan: _LevelPlan, tree_plan: _TreePlan, device: torch.device | str
) -> DeviceLevelPlan:
    """Upload the flattened level plan to ``device`` (int32 index tensors)."""
    host = flatten_level_plan(level_plan, tree_plan)
    tensors = {
        k: torch.as_tensor(np.ascontiguousarray(v, dtype=np.int32), device=device)
        for k, v in host.items()
    }
    offs = np.ascontiguousarray(level_plan.level_offsets, dtype=np.int64)
    return DeviceLevelPlan(
        plan=level_plan,
        level_offsets=tuple(int(o) for o in offs),
        host_offsets=offs,
        **tensors,
    )
