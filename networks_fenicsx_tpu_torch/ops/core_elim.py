"""Host planner of the sparse elimination of unstructured cyclic cores.

Counterpart of the host half of ``networks_fenicsx_tpu/ops/core_elim.py``
(``:65-876``): ``nested_dissection_order``, ``_Round``, ``_Front``,
``CoreElimPlan``, ``_plan_fold``, ``_inverse_map``, ``_plan_fronts`` and
``plan_core_elimination``, line for line and under the reference's names;
the same inputs give ``np.array_equal`` plans with equal dtypes (the plan's
int64 index arrays are narrowed to int32 where they fit, array by array, as
the reference's ``tree_map`` over its pytree does).

The plan is a greedy minimum-degree independent-set elimination of the SPD
core Schur system: each round eliminates an independent set of low-degree
nodes, the fill among their neighbours gets static value slots, and the
Schur sums go to an update stream at static offsets that each slot's single
reader folds.  What remains is solved densely (the dense tail, K11) or, past
``dense_cap``, as supernodal fronts.  :func:`device_core_plan` uploads a
plan once per executor; the numeric phase is K12 (:mod:`..kernels.core_elim`
for the rounds, :mod:`..kernels.core_fronts` for the fronts) with K10 folds
and K11 on the dense tail.  The device side of a fold plan is K10
(:mod:`..kernels.fold`).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

__all__ = [
    "CoreElimPlan",
    "DeviceCorePlan",
    "DeviceCoreRound",
    "DeviceFront",
    "_inverse_map",
    "_plan_fold",
    "device_core_plan",
    "nested_dissection_order",
    "plan_core_elimination",
]


def nested_dissection_order(
    core_pairs: np.ndarray, n_core: int, leaf: int = 64
) -> np.ndarray:
    """Level-structure nested-dissection elimination order.

    Recursive graph bisection: BFS levels from a pseudo-peripheral node
    split each component at the median level; that level's nodes form the
    separator, appended AFTER both halves.  Leaf components (< ``leaf``
    nodes) keep BFS order.  Where greedy minimum-degree fill blows up —
    large 2-D lattice cores are the canonical case (MUMPS uses METIS ND
    there) — this order bounds fill near the O(n log n) ND asymptotic,
    letting :func:`plan_core_elimination` stay within its budget.
    """
    # CSR adjacency
    ci = np.asarray(core_pairs[:, 0], dtype=np.int64)
    cj = np.asarray(core_pairs[:, 1], dtype=np.int64)
    src = np.concatenate([ci, cj])
    dst = np.concatenate([cj, ci])
    o = np.argsort(src, kind="stable")
    src, dst = src[o], dst[o]
    indptr = np.zeros(n_core + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)

    def neighbors(v: int) -> np.ndarray:
        return dst[indptr[v] : indptr[v + 1]]

    order: list[np.ndarray] = []
    # worklist of (nodes, emit_after): separators are pushed to emit after
    # both halves complete (LIFO preserves the recursive emission order)
    in_part = np.full(n_core, -1, dtype=np.int64)  # partition stamp
    stamp = 0
    stack: list[tuple[np.ndarray, bool]] = [
        (np.arange(n_core, dtype=np.int64), False)
    ]
    while stack:
        nodes, is_sep = stack.pop()
        if is_sep or nodes.size <= leaf:
            order.append(nodes)
            continue
        stamp += 1
        in_part[nodes] = stamp
        # BFS levels from a pseudo-peripheral node of this part (first
        # BFS finds a far node; second BFS from it gives the levels).
        # Parts can be disconnected (separator removal); handle per seed.
        level = np.full(n_core, -1, dtype=np.int64)
        remaining = nodes
        comp_sets = []
        while remaining.size:
            seed = int(remaining[0])
            for _pass in range(2):
                level[nodes] = -1
                level[seed] = 0
                frontier = [seed]
                comp = [seed]
                far = seed
                lv = 0
                while frontier:
                    lv += 1
                    nxt = []
                    for v in frontier:
                        for w in neighbors(v):
                            w = int(w)
                            if in_part[w] == stamp and level[w] < 0:
                                level[w] = lv
                                nxt.append(w)
                                comp.append(w)
                    if nxt:
                        far = nxt[0]
                    frontier = nxt
                seed = far  # second pass starts from the far end
            comp_arr = np.asarray(comp, dtype=np.int64)
            # capture levels NOW — the next component's BFS resets them
            comp_sets.append((comp_arr, level[comp_arr].copy()))
            mask = np.ones(remaining.size, dtype=bool)
            mask[np.isin(remaining, comp_arr)] = False
            remaining = remaining[mask]
        for comp_arr, lvs in comp_sets:
            if comp_arr.size <= leaf:
                order.append(comp_arr)
                continue
            # separator: the THINNEST level within the middle band of the
            # cumulative count (35-65%) — exact-median levels on irregular
            # graphs can be fat, and separator width drives both fill and
            # the dense-tail size
            counts = np.bincount(lvs)
            cum = np.cumsum(counts)
            lo_b = int(np.searchsorted(cum, int(0.35 * comp_arr.size)))
            hi_b = int(np.searchsorted(cum, int(0.65 * comp_arr.size)))
            lo_b = min(max(lo_b, 1), counts.size - 1)
            hi_b = min(max(hi_b, lo_b), counts.size - 1)
            band = counts[lo_b : hi_b + 1]
            half = lo_b + int(np.argmin(band))
            sep = comp_arr[lvs == half]
            lo = comp_arr[lvs < half]
            hi = comp_arr[lvs > half]
            stack.append((sep, True))  # emitted after both halves (LIFO)
            if hi.size:
                stack.append((hi, False))
            if lo.size:
                stack.append((lo, False))
    out = np.concatenate(order) if order else np.empty(0, np.int64)
    assert out.size == n_core
    return out


class _Round(typing.NamedTuple):
    """One elimination round, formulated without a materialized slot-value
    array: the elimination is left-looking over an update stream.  Each
    round writes its per-slot Schur sums at a static offset, and a slot's
    single read (every slot is read exactly once, in the round that
    eliminates one of its endpoints, or by a front or the dense tail)
    gather-folds its own updates from the stream, so every per-round index
    operation is proportional to the round's read and write sets.
    """

    elim: np.ndarray  # (S,) core-rank node ids, sorted ascending
    nbr_node: np.ndarray  # (S, K) neighbour core-rank ids, pad = Bc
    # slot-value reads: a = vals_init_ext[init_idx] - fold(ustream, u_read)
    init_idx: np.ndarray  # (S, K) index into (P0+1,) init values, pad = P0
    u_read: tuple  # fold plan: ustream -> (S*K,) prior-update sums
    # diagonal / rhs updates, as a gather-FOLD plan (see _plan_fold): the
    # (S*K) neighbour grid folds into one sum per touched node, applied
    # back through a full-size inverse gather (n_core-sized — cheap
    # relative to the slot axis).
    d_fold: tuple  # tuple of (n_i, w_i) int arrays; level-1 indexes (S*K)
    d_inv: np.ndarray  # (Bc,) node -> row of the folded sums, pad = U1
    # off-diagonal Schur updates: index PAIRS into the (S*K) grid produce
    # the (M2,) contribution vector; u_fold folds it per target slot into
    # this round's ustream segment (written at offset u_off).
    u_src_i: np.ndarray  # (M2,)
    u_src_j: np.ndarray  # (M2,)
    u_fold: tuple  # fold plan over the (M2,) contribution vector
    u_off: int  # static offset of this round's (U2,) segment in ustream
    e_inv: np.ndarray  # (Bc + 1,) node -> row in elim, pad = S (backsub)


class _Front(typing.NamedTuple):
    """One supernodal front: a pivot chunk S plus its boundary clique B.

    Local index space is ``[S | B]`` (m = w + b entries).  ``slot_*``
    scatter the sparse value slots whose pair has at least one endpoint in
    S into the frontal matrix; pairs fully inside B are NOT assembled here
    (they belong to the front that later pivots them).  ``consume`` lists
    earlier fronts whose update matrices extend-add into this one, with a
    local index map for each (their boundary is a clique, so the first
    front pivoting any member contains all of them — see module docs).
    """

    nodes: np.ndarray  # (w,) core-rank pivot ids, elimination-ordered
    bnd: np.ndarray  # (b,) core-rank boundary ids, sorted ascending
    slot_val: np.ndarray  # (ns,) value-slot ids
    slot_i: np.ndarray  # (ns,) local row index in [S | B]
    slot_j: np.ndarray  # (ns,) local col index (slot_i < slot_j)
    consume: tuple  # tuple[(front_id, (m,) INVERSE index map, pad=m_c), ...]
    # slot-value reads (see _Round): sval = init_ext[f_init] - fold(ustream)
    f_init: np.ndarray = np.empty(0, np.int64)  # (ns,) into (P0+1,), pad P0
    f_fold: tuple = ()  # fold plan: ustream -> (ns,) prior-update sums


class CoreElimPlan(typing.NamedTuple):
    """Host-planned sparse elimination of a cycle core (see module docs)."""

    n_core: int  # number of core nodes Bc
    n_slots: int  # off-diagonal value slots (original pairs + fill)
    init_slot: np.ndarray  # (P0,) global pair id feeding slot p (p < P0)
    rounds: tuple  # tuple[_Round]
    dense_nodes: np.ndarray  # (Bd,) core-rank ids solved densely at the top
    dense_pairs: np.ndarray  # (Pd, 3) (di, dj, slot) for the dense tail
    fill_slots: int  # diagnostic: slots added beyond the original pairs
    fronts: tuple = ()  # tuple[_Front] — supernodal tail (excludes dense)
    mu_all: int = 0  # total update-stream length (Σ per-round U2)
    # dense-pair slot reads (see _Round): init gather + update fold
    dp_init: np.ndarray = np.empty(0, np.int64)  # (Pd,) into (P0+1,)
    dp_fold: tuple = ()  # fold plan: ustream -> (Pd,) prior-update sums

    @property
    def stats(self) -> dict:
        return {
            "core": self.n_core,
            "rounds": len(self.rounds),
            "slots": self.n_slots,
            "fill": self.fill_slots,
            "dense_tail": int(self.dense_nodes.size),
            "fronts": len(self.fronts),
            "front_max": max(
                (f.nodes.size + f.bnd.size for f in self.fronts), default=0
            ),
        }

    @property
    def index_bytes(self) -> int:
        """Total bytes of the plan's index arrays."""
        return sum(leaf.size * leaf.dtype.itemsize for leaf in _plan_leaves(self))


def _plan_leaves(plan: CoreElimPlan) -> list:
    """The index arrays of a plan in the reference's pytree order: the
    plan's, each round's (``u_off`` is static), each front's (the consume
    ids are static), the fold-level tuples flattened."""
    out = [plan.init_slot]
    for rd in plan.rounds:
        out += [rd.elim, rd.nbr_node, rd.init_idx, *rd.u_read, *rd.d_fold, rd.d_inv,
                rd.u_src_i, rd.u_src_j, *rd.u_fold, rd.e_inv]
    out += [plan.dense_nodes, plan.dense_pairs]
    for fr in plan.fronts:
        out += [fr.nodes, fr.bnd, fr.slot_val, fr.slot_i, fr.slot_j,
                *(lminv for _, lminv in fr.consume), fr.f_init, *fr.f_fold]
    return out + [plan.dp_init, *plan.dp_fold]


def _map_plan_arrays(fn, plan: CoreElimPlan) -> CoreElimPlan:
    """``plan`` with ``fn`` applied to each of its index arrays (the
    reference's ``jax.tree_util.tree_map`` over the registered pytree)."""

    def tup(levels):
        return tuple(fn(a) for a in levels)

    rounds = tuple(
        rd._replace(
            elim=fn(rd.elim), nbr_node=fn(rd.nbr_node), init_idx=fn(rd.init_idx),
            u_read=tup(rd.u_read), d_fold=tup(rd.d_fold), d_inv=fn(rd.d_inv),
            u_src_i=fn(rd.u_src_i), u_src_j=fn(rd.u_src_j), u_fold=tup(rd.u_fold),
            e_inv=fn(rd.e_inv),
        )
        for rd in plan.rounds
    )
    fronts = tuple(
        fr._replace(
            nodes=fn(fr.nodes), bnd=fn(fr.bnd), slot_val=fn(fr.slot_val),
            slot_i=fn(fr.slot_i), slot_j=fn(fr.slot_j),
            consume=tuple((int(cid), fn(lminv)) for cid, lminv in fr.consume),
            f_init=fn(fr.f_init), f_fold=tup(fr.f_fold),
        )
        for fr in plan.fronts
    )
    return plan._replace(
        init_slot=fn(plan.init_slot), rounds=rounds, dense_nodes=fn(plan.dense_nodes),
        dense_pairs=fn(plan.dense_pairs), fronts=fronts, dp_init=fn(plan.dp_init),
        dp_fold=tup(plan.dp_fold),
    )


def _plan_fold(
    seg: np.ndarray, U: int, src: np.ndarray, src_len: int, cap: int = 64
) -> tuple:
    """Host plan for an exact gather-fold segment reduction.

    Returns a tuple of padded 2-D int index arrays ("levels") such that
    :func:`..kernels.fold.fold_apply` sums the entries of a length-``src_len``
    vector into ``(U,)`` per-segment totals using only gathers and row sums.
    ``seg[i]``/``src[i]`` give entry i's segment and its index into the
    source vector.  Pad cells index one past the level's input (a zero).
    Segments wider than ``cap`` fold through intermediate chunk levels, so
    summation is an exact f64 tree reduction at any width.
    """
    seg = np.asarray(seg, dtype=np.int64)
    order = np.argsort(seg, kind="stable")
    cur = np.asarray(src, dtype=np.int64)[order]
    cur_counts = np.bincount(seg, minlength=U).astype(np.int64)
    cur_len = int(src_len)
    levels: list[np.ndarray] = []
    while True:
        W = int(cur_counts.max()) if cur_counts.size else 0
        n_grp = int(cur_counts.size)
        if W <= cap:
            lv = np.full((n_grp, max(W, 1)), cur_len, dtype=np.int64)
            offs = np.concatenate([[0], np.cumsum(cur_counts)])
            col = np.arange(cur.size) - np.repeat(offs[:-1], cur_counts)
            row = np.repeat(np.arange(n_grp), cur_counts)
            lv[row, col] = cur
            levels.append(lv)
            return tuple(levels)
        offs = np.concatenate([[0], np.cumsum(cur_counts)])
        pos = np.arange(cur.size) - np.repeat(offs[:-1], cur_counts)
        n_chunks_grp = (cur_counts + cap - 1) // cap
        chunk_offs = np.concatenate([[0], np.cumsum(n_chunks_grp)])
        chunk_id = np.repeat(chunk_offs[:-1], cur_counts) + pos // cap
        n_chunks = int(chunk_offs[-1])
        lv = np.full((n_chunks, cap), cur_len, dtype=np.int64)
        lv[chunk_id, pos % cap] = cur
        levels.append(lv)
        cur = np.arange(n_chunks, dtype=np.int64)
        cur_counts = n_chunks_grp
        cur_len = n_chunks


def _inverse_map(targets: np.ndarray, size: int, pad_rows: int) -> np.ndarray:
    """(size,) map: position of index i in ``targets`` (else ``pad_rows``)."""
    inv = np.full(size, pad_rows, dtype=np.int64)
    inv[np.asarray(targets, dtype=np.int64)] = np.arange(targets.size, dtype=np.int64)
    return inv


def _plan_fronts(
    adj: list, tail_order: np.ndarray, front_max: int, front_cap: int
) -> tuple | None:
    """Symbolic multifrontal elimination of the stalled tail.

    ``tail_order`` is the remaining alive nodes in elimination order;
    consecutive chunks of ``front_max`` become dense fronts.  ``adj`` is
    the post-sparse-rounds adjacency (node -> {nbr: slot}) — read only.
    Returns ``None`` when a front would exceed ``front_cap`` (host/HBM
    safety: callers keep the dense/CG fallback).
    """
    cliques: list[np.ndarray] = []  # update-matrix member lists
    node_cliques: dict[int, set] = {}
    elim: set = set()
    fronts: list[_Front] = []
    for start in range(0, tail_order.size, front_max):
        S = np.asarray(tail_order[start : start + front_max], dtype=np.int64)
        Sset = {int(v) for v in S}
        B: set = set()
        consume_ids: set = set()
        for v in Sset:
            for w in adj[v]:
                if w not in elim and w not in Sset:
                    B.add(w)
            for c in node_cliques.get(v, ()):
                consume_ids.add(c)
        for c in consume_ids:
            for w in cliques[c]:
                w = int(w)
                if w not in elim and w not in Sset:
                    B.add(w)
        bnd = np.asarray(sorted(B), dtype=np.int64)
        w_ = int(S.size)
        if w_ + bnd.size > front_cap:
            return None
        loc = {int(v): i for i, v in enumerate(S)}
        for i, v in enumerate(bnd):
            loc[int(v)] = w_ + i
        sv: list[int] = []
        si: list[int] = []
        sj: list[int] = []
        # sparse values with >= 1 endpoint in S; B-B pairs assemble later,
        # in the front that pivots them
        for v in Sset:
            lv = loc[v]
            for w, slot in adj[v].items():
                if w in elim:
                    continue
                lw = loc[w]
                if w in Sset and lw < lv:
                    continue  # S-S pairs once, from the lower-local side
                sv.append(slot)
                si.append(min(lv, lw))
                sj.append(max(lv, lw))
        consume: list[tuple[int, np.ndarray]] = []
        m_f = w_ + int(bnd.size)
        for c in sorted(consume_ids):
            # no clique member is ever eliminated before consumption (the
            # eliminating front consumes it), so every member has a slot
            # in [S | B] — a KeyError here would be a planner bug.
            # Stored as the INVERSE map (F-local -> update-local, pad =
            # m_c): the extend-add then runs as an (m, m) gather from the
            # padded update matrix instead of a serialized 2-D scatter.
            lmap = np.asarray([loc[int(w)] for w in cliques[c]], dtype=np.int64)
            lminv = np.full(m_f, lmap.size, dtype=np.int64)
            lminv[lmap] = np.arange(lmap.size, dtype=np.int64)
            consume.append((c, lminv))
            for w in cliques[c]:
                node_cliques.get(int(w), set()).discard(c)
        fid = len(fronts)
        fronts.append(
            _Front(
                nodes=S,
                bnd=bnd,
                slot_val=np.asarray(sv, dtype=np.int64),
                slot_i=np.asarray(si, dtype=np.int64),
                slot_j=np.asarray(sj, dtype=np.int64),
                consume=tuple(consume),
            )
        )
        if bnd.size:
            cid = len(cliques)
            assert cid == fid  # one clique per front, same numbering
            cliques.append(bnd)
            for w in bnd:
                node_cliques.setdefault(int(w), set()).add(cid)
        else:
            cliques.append(np.empty(0, np.int64))  # keep ids aligned
        elim.update(Sset)
    assert not any(node_cliques.values()), "unconsumed update matrices"
    return tuple(fronts)


def plan_core_elimination(
    core_pairs: np.ndarray,
    n_core: int,
    dense_cutoff: int = 384,
    kcap: int = 32,
    max_fill_ratio: float = 60.0,
    max_slots: int = 20_000_000,
    tail_stop: bool = True,
    order: np.ndarray | None = None,
    dense_cap: int | None = None,
    supernodal_tail: bool = False,
    front_max: int = 1024,
    front_cap: int = 16384,
    front_stop: bool = True,
) -> CoreElimPlan | None:
    """Symbolic minimum-degree independent-set elimination.

    Args:
        core_pairs: ``(P0, 3)`` rows ``(ci, cj, pair_id)`` in core-rank
            numbering (the ``_TreePlan.core_pairs`` layout).
        n_core: number of core nodes.
        dense_cutoff: stop eliminating and solve the remainder densely
            once this few nodes remain.
        kcap: maximum neighbour count an eliminated node may have (bounds
            the per-round padding width).
        max_fill_ratio / max_slots: fill budget — beyond it the planner
            gives up (returns ``None``) and the caller keeps the dense/CG
            fallback.
        tail_stop: apply the diminishing-returns stop (see the loop
            comment).  ``False`` forces the sparse rounds all the way to
            ``dense_cutoff`` — used by tests that pin the sparse numeric
            phase on small cores where the stop would otherwise keep the
            whole core dense.
        order: optional elimination order (e.g.
            :func:`nested_dissection_order`): per round every alive node
            that is a rank-local-minimum among its alive neighbours
            eliminates (parallel pivoting — fill equals the sequential
            order's, rounds = elimination-tree height).  Bounds fill on
            large lattice-like cores where greedy min-degree blows the
            budget; wide separator cliques (degree > kcap under any
            order) land in the dense tail, as in a multifrontal solver.
        dense_cap: maximum dense-tail size (default
            ``max(dense_cutoff, 4096)``).  ND orders on big lattices
            stall with top-separator tails of 4-8k — cheap to factor
            densely, so the ND caller raises this.
        supernodal_tail: when the stalled remainder exceeds ``dense_cap``,
            eliminate it multifrontally (see :func:`_plan_fronts`)
            instead of giving up — the path for per-edge-R lattices
            beyond ~300 per side and very large webs.
        front_max: pivot-chunk width of each supernodal front.
        front_cap: hard bound on a front's total size (pivots +
            boundary); beyond it the planner returns ``None``.
        front_stop: with ``supernodal_tail``, break out of the rounds as
            soon as a round shrinks below ``max(64, n_alive/64)`` pivots
            and let the fronts absorb the remainder.  The sliver tail is
            pure launch overhead on device (measured 512² lattice: the
            last 32 of 68 rounds eliminate ~2k of 262k nodes; the web50k
            tail is proportionally longer), while the few extra front
            pivots are cheap dense work.  Disabled on a retry when the wider
            remainder makes a front outgrow ``front_cap``.

    Returns None when the core is empty or the fill budget is exceeded.
    """
    P0 = int(core_pairs.shape[0])
    if n_core == 0:
        return None
    budget = min(max_slots, int(max(P0, n_core) * max_fill_ratio) + 1024)

    # adjacency: node -> {nbr: slot}
    adj: list[dict[int, int]] = [dict() for _ in range(n_core)]
    for p, (ci, cj, _pid) in enumerate(np.asarray(core_pairs, dtype=np.int64)):
        adj[int(ci)][int(cj)] = p
        adj[int(cj)][int(ci)] = p
    n_slots = P0
    alive = np.ones(n_core, dtype=bool)
    n_alive = n_core
    rounds: list[dict] = []  # _Round fields; assembled post-loop (stream)
    rank = None
    low_cnt = None
    pool: set = set()
    if order is not None:
        order = np.asarray(order, dtype=np.int64)
        rank = np.empty(n_core, dtype=np.int64)
        rank[order] = np.arange(n_core, dtype=np.int64)
        # incremental local-min bookkeeping: low_cnt[v] = alive neighbours
        # of lower rank; v is eligible exactly when it reaches 0.  Kept in
        # sync through eliminations (decrements) and fill edges (the
        # higher-rank endpoint gains a lower-rank neighbour) — replaces a
        # full O(n_core) eligibility scan per round (68 rounds x 262k
        # nodes at 512² cost ~2 min of host time).
        low_cnt = np.zeros(n_core, dtype=np.int64)
        for v in range(n_core):
            rv_ = rank[v]
            low_cnt[v] = sum(1 for w in adj[v] if rank[w] < rv_)
        pool = {v for v in range(n_core) if low_cnt[v] == 0}

    while n_alive > dense_cutoff:
        if rank is not None:
            # parallel pivoting consistent with the given order: eliminate
            # every alive node that is a rank-local-MINIMUM among its
            # alive neighbours (non-adjacent by construction; the fill is
            # exactly the sequential-order fill, rounds = elimination-tree
            # height).  Wide separator cliques serialize under any order,
            # so nodes beyond kcap are left for the dense tail.
            chosen = []
            stale = []
            for v in pool:
                if not alive[v] or low_cnt[v] != 0:
                    stale.append(v)  # re-added on the decrement to 0
                elif len(adj[v]) <= kcap:
                    chosen.append(v)
                # else: eligible but over-wide — stays pooled; its degree
                # shrinks as neighbours eliminate
            pool.difference_update(stale)
        else:
            # candidates: independent set of minimum-ish degree nodes
            degs = {v: len(adj[v]) for v in range(n_core) if alive[v]}
            dmin = min(degs.values())
            thresh = min(kcap, max(dmin + 2, 4))
            blocked = set()
            chosen = []
            for v in sorted(degs, key=degs.get):  # type: ignore[arg-type]
                if degs[v] > thresh:
                    break
                if v in blocked:
                    continue
                chosen.append(v)
                blocked.add(v)
                blocked.update(adj[v])
        if not chosen:
            break  # every remaining node exceeds kcap: dense tail
        # Diminishing-returns stop: once independent sets shrink to
        # slivers (fill pushes every degree near the threshold) a long
        # tail of tiny rounds costs more fixed launches than one dense
        # solve of the remainder.  Only when the remainder fits the dense
        # envelope.
        if tail_stop and n_alive <= 2048 and len(chosen) < max(16, n_alive // 32):
            break
        # Front-stop: with a supernodal tail available there is no reason
        # to crawl through sliver rounds at any size — the fronts factor
        # the remainder in a handful of dense Choleskys.
        if (
            supernodal_tail
            and front_stop
            and len(chosen) < max(64, n_alive // 64)
        ):
            break
        chosen.sort()
        K = max((len(adj[v]) for v in chosen), default=1)
        K = max(K, 1)
        S = len(chosen)
        nbr_node = np.full((S, K), n_core, dtype=np.int64)
        nbr_slot = np.full((S, K), -1, dtype=np.int64)  # -1 pads consumed by init_idx/_read_fold
        d_entries: list[tuple[int, int]] = []  # (flat_src, tgt_node)
        u_entries: list[tuple[int, int, int]] = []  # (src_i, src_j, tgt_slot)
        for s, v in enumerate(chosen):
            nbrs = sorted(adj[v].items())
            for k, (n, slot) in enumerate(nbrs):
                nbr_node[s, k] = n
                nbr_slot[s, k] = slot
                d_entries.append((s * K + k, n))
            # fill: clique among the neighbours
            for i in range(len(nbrs)):
                ni = nbrs[i][0]
                for j in range(i + 1, len(nbrs)):
                    nj = nbrs[j][0]
                    slot = adj[ni].get(nj)
                    if slot is None:
                        slot = n_slots
                        n_slots += 1
                        adj[ni][nj] = slot
                        adj[nj][ni] = slot
                        if low_cnt is not None:
                            # new edge: the higher-rank endpoint gains a
                            # lower-rank alive neighbour
                            hi = ni if rank[ni] > rank[nj] else nj
                            low_cnt[hi] += 1
                    u_entries.append((s * K + i, s * K + j, slot))
            # remove v
            for n, _slot in nbrs:
                del adj[n][v]
                if low_cnt is not None and rank[n] > rank[v]:
                    low_cnt[n] -= 1
                    if low_cnt[n] == 0:
                        pool.add(n)
            adj[v] = {}
            alive[v] = False
        n_alive -= S
        if n_slots > budget:
            return None

        d_src = np.array([e[0] for e in d_entries], dtype=np.int64)
        d_tgt_all = np.array([e[1] for e in d_entries], dtype=np.int64)
        d_tgt, d_seg = np.unique(d_tgt_all, return_inverse=True)
        d_fold = _plan_fold(d_seg, d_tgt.size, d_src, S * K)
        d_inv = _inverse_map(d_tgt, n_core, d_tgt.size)
        if u_entries:
            u_src_i = np.array([e[0] for e in u_entries], dtype=np.int64)
            u_src_j = np.array([e[1] for e in u_entries], dtype=np.int64)
            u_tgt_all = np.array([e[2] for e in u_entries], dtype=np.int64)
            u_tgt, u_seg = np.unique(u_tgt_all, return_inverse=True)
            u_fold = _plan_fold(
                u_seg, u_tgt.size, np.arange(u_src_i.size), u_src_i.size
            )
        else:
            u_src_i = u_src_j = np.empty(0, dtype=np.int64)
            u_tgt = np.empty(0, dtype=np.int64)
            u_fold = ()
        elim_arr = np.asarray(chosen, dtype=np.int64)
        e_inv = _inverse_map(elim_arr, n_core + 1, S)
        # _Round assembled post-loop (the update-stream read folds need
        # the global update records and final slot pads)
        rounds.append(
            dict(
                elim=elim_arr,
                nbr_node=nbr_node,
                nbr_slot=nbr_slot,
                d_fold=d_fold,
                d_inv=d_inv,
                u_src_i=u_src_i,
                u_src_j=u_src_j,
                u_fold=u_fold,
                u_tgt=u_tgt,
                e_inv=e_inv,
            )
        )

    dense_nodes = np.flatnonzero(alive).astype(np.int64)
    fronts: tuple = ()
    cap = dense_cap if dense_cap is not None else max(dense_cutoff, 4096)
    if dense_nodes.size > cap:
        if not supernodal_tail:
            return None  # fill forced a huge dense tail: not worth it
        tail_order = (
            dense_nodes[np.argsort(rank[dense_nodes], kind="stable")]
            if rank is not None
            else dense_nodes
        )
        planned = _plan_fronts(adj, tail_order, front_max, front_cap)
        if planned is None:
            return None  # a front outgrew the cap: keep dense/CG fallback
        fronts = planned
        dense_nodes = np.empty(0, np.int64)
    rank = np.full(n_core, -1, dtype=np.int64)
    rank[dense_nodes] = np.arange(dense_nodes.size)
    dense_pairs: list[tuple[int, int, int]] = []
    for v in dense_nodes:
        for n, slot in adj[int(v)].items():
            if v < n:
                dense_pairs.append((int(rank[v]), int(rank[n]), slot))
    dp = (
        np.asarray(dense_pairs, dtype=np.int64)
        if dense_pairs
        else np.empty((0, 3), dtype=np.int64)
    )

    # ---- update-stream assembly (see the _Round docstring) ----
    # Pass 1: static per-round stream offsets and the global write record
    # (stream position -> target slot).  Round r's unique target slots
    # u_tgt occupy stream positions [u_off_r, u_off_r + |u_tgt|).
    u_offs: list[int] = []
    mu_all = 0
    for rdd in rounds:
        u_offs.append(mu_all)
        mu_all += int(rdd["u_tgt"].size)
    w_slot = (
        np.concatenate([np.asarray(rdd["u_tgt"], dtype=np.int64) for rdd in rounds])
        if rounds
        else np.empty(0, np.int64)
    )
    o = np.argsort(w_slot, kind="stable")
    ws = w_slot[o]  # write slots, sorted
    ps = np.arange(mu_all, dtype=np.int64)[o]  # positions, ascending per slot

    def _read_fold(slots_flat: np.ndarray, cutoff: int, n_reads: int) -> tuple:
        """Fold plan summing each read's prior stream writes (< cutoff).

        ``slots_flat[i]`` is read i's slot id (< 0 = pad, no reads).
        Every stream position is read exactly once across the whole plan
        (each slot is consumed by exactly one round / front / dense pair),
        so the total fold work equals the stream length."""
        valid = np.flatnonzero(slots_flat >= 0)
        fs = slots_flat[valid]
        lo = np.searchsorted(ws, fs)
        hi = np.searchsorted(ws, fs, side="right")
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return ()
        rep = np.repeat(np.arange(fs.size), counts)
        within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        srcp = ps[lo[rep] + within]
        m = srcp < cutoff
        if not m.any():
            return ()
        return _plan_fold(valid[rep[m]], n_reads, srcp[m], mu_all)

    final_rounds: list[_Round] = []
    for rdd, u_off in zip(rounds, u_offs):
        nbr_slot = rdd.pop("nbr_slot")
        rdd.pop("u_tgt")
        S, K = nbr_slot.shape
        flat = nbr_slot.reshape(-1)
        init_idx = np.where((flat >= 0) & (flat < P0), flat, P0).reshape(S, K)
        final_rounds.append(
            _Round(
                init_idx=init_idx,
                u_read=_read_fold(flat, u_off, S * K),
                u_off=u_off,
                **rdd,
            )
        )
    if fronts:
        fronts = tuple(
            fr._replace(
                f_init=np.where(fr.slot_val < P0, fr.slot_val, P0),
                f_fold=_read_fold(fr.slot_val, mu_all, int(fr.slot_val.size)),
            )
            for fr in fronts
        )
    dp_init = np.where(dp[:, 2] < P0, dp[:, 2], P0)
    dp_fold = _read_fold(dp[:, 2], mu_all, int(dp.shape[0]))

    plan = CoreElimPlan(
        n_core=n_core,
        n_slots=n_slots,
        init_slot=np.asarray(core_pairs[:, 2], dtype=np.int64),
        rounds=tuple(final_rounds),
        dense_nodes=dense_nodes,
        dense_pairs=dp,
        fill_slots=n_slots - P0,
        fronts=fronts,
        mu_all=mu_all,
        dp_init=dp_init,
        dp_fold=dp_fold,
    )
    # Index compaction: the plan rides to the device as runtime buffers
    # (see the pytree registration), so narrowing int64 indices to int32
    # where the values fit halves both the transfer and its resident HBM.
    # Per-array check: different arrays index different spaces (nodes,
    # init values, stream positions, fold chunks) with different bounds.
    i32max = np.iinfo(np.int32).max

    def _compact(a):
        if (
            isinstance(a, np.ndarray)
            and a.dtype == np.int64
            and (a.size == 0 or int(a.max()) < i32max)
        ):
            return a.astype(np.int32)
        return a

    return _map_plan_arrays(_compact, plan)


# ---------------------------------------------------------------------------
# device: the plan's index tensors, uploaded once per executor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceCoreRound:
    """One min-degree round on the device (the :class:`_Round` fields as
    int32 tensors, the fold plans as tuples of level tensors).

    Attributes:
        elim, nbr_node, init_idx, u_read, d_fold, d_inv, u_src_i, u_src_j,
            u_fold, e_inv, u_off: the round (see :class:`_Round`).
        a_off: offset of the round's ``(S, K)`` entries in the saved value
            stream ``a`` of a solve.
        s_off: offset of its ``(S,)`` rows in the saved ``inv`` and ``rv``.
    """

    elim: torch.Tensor
    nbr_node: torch.Tensor
    init_idx: torch.Tensor
    u_read: tuple
    d_fold: tuple
    d_inv: torch.Tensor
    u_src_i: torch.Tensor
    u_src_j: torch.Tensor
    u_fold: tuple
    e_inv: torch.Tensor
    u_off: int
    a_off: int
    s_off: int

    @property
    def S(self) -> int:
        return int(self.nbr_node.shape[0])

    @property
    def K(self) -> int:
        return int(self.nbr_node.shape[1])

    @property
    def M2(self) -> int:
        return int(self.u_src_i.shape[0])

    @property
    def U1(self) -> int:
        """Rows of the folded diagonal sums (``d_inv``'s pad)."""
        return int(self.d_fold[-1].shape[0])

    @property
    def U2(self) -> int:
        """Length of the round's update-stream segment."""
        return int(self.u_fold[-1].shape[0]) if self.u_fold else 0


@dataclasses.dataclass(frozen=True)
class DeviceFront:
    """One supernodal front on the device.

    Attributes:
        nodes, bnd, slot_i, slot_j, f_init, f_fold: the front (see
            :class:`_Front`), int32 tensors and fold levels.
        consume: the ids of the fronts it consumes, in plan order.
        lminv: their ``(m,)`` inverse maps concatenated, ``(n_c·m,)``.
        cons: host ``(n_c, 3)`` int64 table of each consumed front's offset
            in the front buffer, its ``m`` and its ``w``.
        f_off: offset of this front's ``(m, m)`` block in the front buffer.
        y_off: offset of its ``(w,)`` slice in the saved forward stream.
    """

    nodes: torch.Tensor
    bnd: torch.Tensor
    slot_i: torch.Tensor
    slot_j: torch.Tensor
    f_init: torch.Tensor
    f_fold: tuple
    consume: tuple
    lminv: torch.Tensor
    cons: np.ndarray
    f_off: int
    y_off: int

    @property
    def w(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def b(self) -> int:
        return int(self.bnd.shape[0])


@dataclasses.dataclass(frozen=True)
class DeviceCorePlan:
    """A :class:`CoreElimPlan` on one device, uploaded once per executor:
    the rounds, the dense tail's nodes, pairs (with their ids ``0, 1, …``
    into the negated pair values K11 takes) and slot reads, and the fronts
    with their buffer offsets (``a_len``, ``s_len``: the saved round streams;
    ``f_len``: Σ m² of the fronts; ``y_len``: Σ w)."""

    plan: CoreElimPlan
    init_slot: torch.Tensor
    rounds: tuple
    dense_nodes: torch.Tensor
    dense_di: torch.Tensor
    dense_dj: torch.Tensor
    dense_pid: torch.Tensor
    dp_init: torch.Tensor
    dp_fold: tuple
    fronts: tuple
    a_len: int
    s_len: int
    f_len: int
    y_len: int

    @property
    def n_core(self) -> int:
        return int(self.plan.n_core)

    @property
    def n_pairs(self) -> int:
        return int(self.init_slot.shape[0])

    @property
    def mu_all(self) -> int:
        return int(self.plan.mu_all)

    @property
    def max_SK(self) -> int:
        return max((rd.S * rd.K for rd in self.rounds), default=0)

    @property
    def max_M2(self) -> int:
        return max((rd.M2 for rd in self.rounds), default=0)


def device_core_plan(plan: CoreElimPlan, device: torch.device | str) -> DeviceCorePlan:
    """Upload ``plan``'s index arrays to ``device`` once, as int32 tensors,
    with the offsets of every round's and front's slice of the solve's
    buffers: a solve then runs the launch loop and nothing else per round."""

    def up(a):
        a = np.asarray(a)
        if a.size and int(a.max()) > np.iinfo(np.int32).max:
            raise ValueError("device_core_plan: an index does not fit in int32")
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    def levels(fold):
        return tuple(up(lv) for lv in fold)

    rounds = []
    a_off = s_off = 0
    for rd in plan.rounds:
        S, K = rd.nbr_node.shape
        rounds.append(DeviceCoreRound(
            elim=up(rd.elim), nbr_node=up(rd.nbr_node), init_idx=up(rd.init_idx),
            u_read=levels(rd.u_read), d_fold=levels(rd.d_fold), d_inv=up(rd.d_inv),
            u_src_i=up(rd.u_src_i), u_src_j=up(rd.u_src_j), u_fold=levels(rd.u_fold),
            e_inv=up(rd.e_inv), u_off=int(rd.u_off), a_off=a_off, s_off=s_off,
        ))
        a_off += int(S * K)
        s_off += int(S)
    fronts = []
    f_off = y_off = 0
    offs: list[tuple[int, int, int]] = []  # (F offset, m, w) per front id
    for fr in plan.fronts:
        w, b = int(fr.nodes.size), int(fr.bnd.size)
        m = w + b
        cons = np.asarray([offs[int(cid)] for cid, _ in fr.consume], np.int64).reshape(-1, 3)
        lminv = (np.concatenate([np.asarray(lm) for _, lm in fr.consume])
                 if fr.consume else np.empty(0, np.int32))
        fronts.append(DeviceFront(
            nodes=up(fr.nodes), bnd=up(fr.bnd), slot_i=up(fr.slot_i), slot_j=up(fr.slot_j),
            f_init=up(fr.f_init), f_fold=levels(fr.f_fold),
            consume=tuple(int(cid) for cid, _ in fr.consume),
            lminv=up(lminv), cons=cons, f_off=f_off, y_off=y_off,
        ))
        offs.append((f_off, m, w))
        f_off += m * m
        y_off += w
    dp = np.asarray(plan.dense_pairs).reshape(-1, 3)
    return DeviceCorePlan(
        plan=plan,
        init_slot=up(plan.init_slot),
        rounds=tuple(rounds),
        dense_nodes=up(plan.dense_nodes),
        dense_di=up(dp[:, 0]),
        dense_dj=up(dp[:, 1]),
        dense_pid=up(np.arange(dp.shape[0])),
        dp_init=up(plan.dp_init),
        dp_fold=levels(plan.dp_fold),
        fronts=tuple(fronts),
        a_len=a_off,
        s_len=s_off,
        f_len=f_off,
        y_len=y_off,
    )
