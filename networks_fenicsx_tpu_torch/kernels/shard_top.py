"""K22-reduce and the T solve (``csrc/shard_top.cu``): what the shards of a
sharded solve share.

Replaces the ``psum`` and ``pmin`` of ``networks_fenicsx_tpu/parallel/*`` and
the replicated dense solve of the top forest T
(``blocked_sharded.py:361-376``, ``distributed_tree.py:489-503``):

* :func:`reduce` — the D shards' partials ``(D, stride)`` summed in shard
  order (columns ``[offset, offset + n)``);
* :func:`reduce_placed` — D strip windows ``(C, h+1, nx)`` placed at row
  offset ``(d0 + d)·h`` and summed in shard order into ``(C, ny, nx)`` (the
  lattice's ghost update, ``grid_sharded.py:320-327``);
* :func:`all_finite` — the min of D int flags (the finiteness ``pmin``);
* :func:`t_solve` — ``L_T λ_T = r_T`` on the T forest, exact, as the
  reference's Jacobi-scaled Cholesky is, since ``L_T``'s only
  off-diagonals are parent–child (``T_parent``): the host plan
  (:func:`t_plan`, checked by :func:`check_t_plan`) cuts T's runs of
  one-child nodes into segments of at most ``CHAIN`` nodes, round after
  round; a segment is eliminated by one thread bottom to top into one edge
  between the separators around it, the forest left is eliminated level by
  level, then λ comes back down the same way.  With ``sq_extra`` it also
  gives ``sqrt(sq_extra + ‖r_T‖²)``.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version, which adds in the kernel's order, for CPU tensors.  The three
K22-reduce wrappers take K10's lean launch path (``fold.py``): attribute
checks once, the device index from ``get_device()``, ``new_empty``, the raw
stream, and no device switch when the device is already current.  ``REDUCE``
counts the reduce, placed and finiteness launches, ``T_SOLVE`` the T solves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build

__all__ = [
    "REDUCE", "T_SOLVE", "TForest", "TRound", "t_forest", "t_plan", "check_t_plan", "reduce", "reduce_plain", "reduce_placed",
    "reduce_placed_plain", "all_finite", "all_finite_plain", "t_solve", "t_solve_plain",
]

REDUCE = build.Counter("shard_reduce")
T_SOLVE = build.Counter("t_solve")


# ------------------------------------------------------------------ reduce


def reduce_plain(parts: torch.Tensor, n: int | None = None, offset: int = 0) -> torch.Tensor:
    """Eager version: ``Σ_d parts[d, offset:offset + n]`` in shard order."""
    n = parts.shape[1] - offset if n is None else n
    acc = parts[0, offset : offset + n]
    for d in range(1, parts.shape[0]):
        acc = acc + parts[d, offset : offset + n]
    return acc.clone()


def _check_parts(parts: torch.Tensor, dtype=torch.float64) -> int:
    """The device index of a CUDA ``parts`` after the checks every K22-reduce
    wrapper makes once (raises for a tensor off the card)."""
    if not parts.is_cuda:
        build.require_cuda("shard_reduce", parts, dtype=dtype)
    if parts.dtype is not dtype or not parts.is_contiguous():
        raise ValueError(f"shard_reduce: expected a contiguous {dtype} tensor")
    return parts.get_device()


def _launch(index: int, fn, *args) -> None:
    """Launch the library function ``fn`` on device ``index``'s current
    stream, entering the device only when it is not already current."""
    if index == torch._C._cuda_getDevice():
        code = fn(*args, build.raw_stream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, build.raw_stream(index))
    if code:
        build.check(code, "shard_reduce")
    REDUCE.launches += 1


def reduce(parts: torch.Tensor, n: int | None = None, offset: int = 0) -> torch.Tensor:
    """K22-reduce on ``parts``' device: the ``(n,)`` shard-ordered sum."""
    if parts.device.type == "cpu":
        return reduce_plain(parts, n, offset)
    index = _check_parts(parts)
    if parts.dim() != 2:
        raise ValueError("shard_reduce: parts must be (D, stride)")
    D, stride = parts.shape
    n = stride - offset if n is None else n
    if offset < 0 or n < 0 or offset + n > stride:
        raise ValueError("shard_reduce: columns out of range")
    out = parts.new_empty(n)
    _launch(index, build.library().nxfx_shard_reduce, D, n, stride, offset, parts.data_ptr(),
            out.data_ptr())
    return out


def reduce_placed_plain(parts: torch.Tensor, d0: int, C: int, h: int, nx: int, ny: int):
    """Eager version: each shard's ``C`` windows placed at row ``(d0 + d)·h``
    of a zero ``(C, ny, nx)`` grid (rows past ``ny`` dropped), added in
    shard order."""
    dt, dev = parts.dtype, parts.device
    acc = torch.zeros((C, ny, nx), dtype=dt, device=dev)
    for d in range(parts.shape[0]):
        win = parts[d, : C * (h + 1) * nx].reshape(C, h + 1, nx)
        full = torch.zeros((C, ny, nx), dtype=dt, device=dev)
        y0 = (d0 + d) * h
        rows = max(0, min(h + 1, ny - y0))
        if rows:
            full[:, y0 : y0 + rows] = win[:, :rows]
        acc = acc + full
    return acc


def reduce_placed(parts: torch.Tensor, d0: int, C: int, h: int, nx: int, ny: int):
    """K22-reduce's placed form on ``parts``' device: ``(C, ny, nx)``."""
    if parts.device.type == "cpu":
        return reduce_placed_plain(parts, d0, C, h, nx, ny)
    index = _check_parts(parts)
    D, stride = parts.shape
    if stride < C * (h + 1) * nx:
        raise ValueError("shard_reduce: a shard's row is shorter than its windows")
    out = parts.new_empty((C, ny, nx))
    _launch(index, build.library().nxfx_shard_reduce_placed, D, d0, C, h, nx, ny, stride,
            parts.data_ptr(), out.data_ptr())
    return out


def all_finite_plain(flags: torch.Tensor) -> torch.Tensor:
    """Eager version: ``min(flags)`` as a 0-d int32 tensor."""
    return flags.min().reshape(())


def all_finite(flags: torch.Tensor) -> torch.Tensor:
    """The finiteness min over ``(D,)`` int32 shard flags on their device."""
    if flags.device.type == "cpu":
        return all_finite_plain(flags)
    index = _check_parts(flags, torch.int32)
    out = flags.new_empty(())
    _launch(index, build.library().nxfx_shard_all, int(flags.shape[0]), flags.data_ptr(), out.data_ptr())
    return out


# ------------------------------------------------------------------ T solve

CHAIN = 16  # the most nodes a segment holds: one thread eliminates them in a row (shard_top.cu TS_CHAIN)
MAX_TN = 4096
SOLVE_THREADS = 256  # the solve's one block (shard_top.cu TS_THREADS)
_HEADER = 10  # the device table's header (shard_top.cu)


@dataclasses.dataclass(frozen=True)
class TRound:
    """One compression round of the T plan (host arrays, node ids of T).

    Attributes:
        segs: ``(S, 4)`` the round's segments ``(bottom, top, first,
            length)``, sorted by top: a run of ``length`` single-child nodes
            ``chain[first : first + length]``, bottom to top, between two
            separators (``bottom`` below the run, ``top`` above it).
        chain: ``(C,)`` the segments' nodes, a run each.
        gathers: ``(G, 3)`` per distinct top ``(top, first segment row,
            count)``: the segments whose top it is, a run of ``segs``.
    """

    segs: np.ndarray
    chain: np.ndarray
    gathers: np.ndarray


@dataclasses.dataclass(frozen=True)
class TForest:
    """The T plan on one device, built and checked once per plan
    (:func:`t_plan`, :func:`check_t_plan`).

    Attributes:
        table: int32 device table the kernel reads (header, then the
            rounds' segment, gather and chain rows, then the forest's rows
            and level bounds).
        Tn: T's nodes.
        depth: T's levels.
        rounds: the compression rounds, in order.
        rows: ``(F, 4)`` the forest left after the rounds, level by level:
            ``(node, parent node or -1, first child row, children)``, a
            node's children a run of the level below.
        lvl_off: ``(n_lvl + 1,)`` its level bounds in ``rows``.
    """

    table: torch.Tensor
    Tn: int
    depth: int
    rounds: tuple
    rows: np.ndarray
    lvl_off: np.ndarray

    @property
    def n_lvl(self) -> int:
        return int(self.lvl_off.size) - 1


def _depths(par: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Depth of each of ``nodes`` in the forest ``par`` restricted to them
    (``-1`` roots); raises unless it is a forest."""
    depth = np.full(par.size, -1, np.int64)
    roots = nodes[par[nodes] < 0]
    depth[roots] = 0
    todo = nodes[par[nodes] >= 0]
    while todo.size:
        ready = depth[par[todo]] >= 0
        if not ready.any():
            raise ValueError("T plan: not a forest")
        depth[todo[ready]] = depth[par[todo[ready]]] + 1
        todo = todo[~ready]
    return depth


def _compress(par: np.ndarray, alive: np.ndarray) -> TRound | None:
    """One round on the forest ``par`` of the ``alive`` nodes: each maximal
    run of nodes with one child (not roots) cut into segments of at most
    ``CHAIN`` by as few cut points as that allows, spread evenly.
    Updates ``par`` (a segment's bottom hangs from its top) and ``alive``
    (the segments' nodes leave); None when no node has one child."""
    Tn = par.size
    has = alive & (par >= 0)
    kids = np.bincount(par[has], minlength=Tn)
    chainable = has & (kids == 1)
    if not chainable.any():
        return None
    only_child = np.full(Tn, -1, np.int64)
    only_child[par[has]] = np.flatnonzero(has)  # the child of each one-child node
    segs, chain = [], []
    for v in np.flatnonzero(chainable & ~chainable[np.maximum(only_child, 0)]):
        run = [int(v)]
        while chainable[par[run[-1]]]:
            run.append(int(par[run[-1]]))
        L = len(run)
        k = -(-(L + 1) // (CHAIN + 1))  # segments; k - 1 cut points
        base, extra = divmod(L - (k - 1), k)
        b, pos = int(only_child[v]), 0
        for i in range(k):
            n = base + (i < extra)
            inner = run[pos : pos + n]
            pos += n
            t = run[pos] if i < k - 1 else int(par[run[-1]])
            pos += i < k - 1
            segs.append((b, t, inner))
            b = t
    segs.sort(key=lambda sg: (sg[1], sg[0]))
    rows = np.zeros((len(segs), 4), np.int64)
    for j, (b, t, inner) in enumerate(segs):
        rows[j] = (b, t, len(chain), len(inner))
        chain.extend(inner)
        alive[inner] = False
        par[b] = t
    tops, first, count = np.unique(rows[:, 1], return_index=True, return_counts=True)
    return TRound(segs=rows, chain=np.asarray(chain, np.int64),
                  gathers=np.stack([tops, first, count], axis=1))


def t_plan(T_parent: np.ndarray, rounds: int | None = None):
    """The T plan of the forest ``T_parent``: ``(rounds, rows, lvl_off,
    depth)`` (see :class:`TForest`).  Round after round, until no node but
    a root has one child (or for ``rounds`` rounds; 0 leaves T's own
    levels), the runs of one-child nodes are cut into segments of at most
    ``CHAIN``; the separators (roots, leaves, branching nodes and the cut
    points) form the next round's forest, in which a separator's parent is
    the separator above it.  The forest left is ordered level by level, a
    node's children a run of the level below, ascending by node within a
    parent."""
    par = np.asarray(T_parent, dtype=np.int64).copy()
    Tn = par.size
    if Tn and (np.any(par >= Tn) or np.any(par < -1)):
        raise ValueError("T plan: a parent out of range")
    depth = int(_depths(par, np.arange(Tn)).max()) + 1 if Tn else 0
    alive = np.ones(Tn, bool)
    out = []
    while rounds is None or len(out) < rounds:
        rd = _compress(par, alive)
        if rd is None:
            break
        out.append(rd)
    nodes = np.flatnonzero(alive)
    lv = _depths(par, nodes)[nodes] if nodes.size else nodes
    n_lvl = int(lv.max()) + 1 if nodes.size else 0
    pos = np.full(Tn, -1, np.int64)
    order = []
    for level in range(n_lvl):
        here = nodes[lv == level]
        if level:  # by the parent's row, then by node
            here = here[np.lexsort((here, pos[par[here]]))]
        pos[here] = len(order) + np.arange(here.size)
        order.extend(here.tolist())
    order = np.asarray(order, np.int64)
    lvl_off = np.searchsorted(lv[np.argsort(lv, kind="stable")], np.arange(n_lvl + 1))
    rows = np.zeros((order.size, 4), np.int64)
    if order.size:
        p = par[order]
        rows[:, 0], rows[:, 1] = order, p
        counts = np.bincount(pos[p[p >= 0]], minlength=order.size)
        first = np.concatenate([[int(lvl_off[1]) if n_lvl else 0], np.cumsum(counts)[:-1] + lvl_off[1]])
        rows[:, 2], rows[:, 3] = first, counts
    return tuple(out), rows, lvl_off.astype(np.int64), depth


def check_t_plan(T_parent: np.ndarray, rounds, rows: np.ndarray, lvl_off: np.ndarray) -> None:
    """Raise ``ValueError`` unless the plan covers T: every node is in
    exactly one segment or in the forest left; every segment holds 1 to
    ``CHAIN`` nodes, each the only child of the next, between its
    bottom (the first one's only child) and its top (the last one's
    parent) in the forest of its round; the tops of a round's gathers are
    its segments' tops, each a run; and the forest left is one, level by
    level, children as runs (:func:`levels.check_child_runs`)."""
    from ..levels import check_child_runs

    par = np.asarray(T_parent, dtype=np.int64).copy()
    Tn = par.size
    seen = np.zeros(Tn, np.int64)
    alive = np.ones(Tn, bool)
    for rd in rounds:
        has = alive & (par >= 0)
        kids = np.bincount(par[has], minlength=Tn)
        S = rd.segs.shape[0]
        if rd.segs.ndim != 2 or rd.segs.shape[1] != 4 or S == 0:
            raise ValueError("T plan: a round without segments")
        for b, t, first, n in rd.segs:
            inner = rd.chain[first : first + n]
            if not 1 <= n <= CHAIN or inner.size != n:
                raise ValueError("T plan: a segment holds no node or more than the chain")
            if not alive[b] or not alive[t] or np.any(~alive[inner]):
                raise ValueError("T plan: a segment names a node of an earlier round")
            path = np.concatenate([[b], inner, [t]])
            if np.any(par[path[:-1]] != path[1:]) or np.any(kids[inner] != 1):
                raise ValueError("T plan: a segment is not a run of one-child nodes")
            seen[inner] += 1
        tops = rd.segs[:, 1]
        if np.any(np.diff(tops) < 0):
            raise ValueError("T plan: a round's segments are not sorted by top")
        g = rd.gathers
        if (g[:, 2].sum() != S or np.any(g[:, 1] != np.concatenate([[0], np.cumsum(g[:, 2])[:-1]]))
                or np.any(tops[g[:, 1]] != g[:, 0]) or np.unique(g[:, 0]).size != g.shape[0]):
            raise ValueError("T plan: a round's gathers are not its tops' runs")
        alive[rd.chain] = False
        par[rd.segs[:, 0]] = rd.segs[:, 1]
    nodes = np.flatnonzero(alive)
    seen[nodes] += 1
    if np.any(seen != 1):
        raise ValueError("T plan: a node is in no segment and not left, or in two")
    F = rows.shape[0]
    if F != nodes.size or not np.array_equal(np.sort(rows[:, 0]), nodes):
        raise ValueError("T plan: the forest left is not the nodes no segment holds")
    pos = np.full(Tn, -1, np.int64)
    pos[rows[:, 0]] = np.arange(F)
    if np.any(rows[:, 1] != par[rows[:, 0]]):
        raise ValueError("T plan: a parent of the forest left is not the round's")
    parent_pos = np.where(rows[:, 1] >= 0, pos[np.maximum(rows[:, 1], 0)], -1)
    child_ptr = np.concatenate([rows[:, 2], [F]]) if F else np.zeros(1, np.int64)
    if F and np.any(rows[:, 2] + rows[:, 3] != child_ptr[1:]):
        raise ValueError("T plan: the children of a parent are not a run")
    try:
        check_child_runs(lvl_off, parent_pos, child_ptr)
    except ValueError as exc:
        raise ValueError(f"T plan: {exc}") from None


def _table(rounds, rows: np.ndarray, lvl_off: np.ndarray) -> np.ndarray:
    """The int32 table the kernel reads: the header ``(rounds, levels, then
    the offsets of the per-round segment bounds, the per-round gather
    bounds, the segments (4 a row), the gathers (3 a row, segment rows
    absolute), the chain, the rows of the forest left (4 a row) and its level
    bounds, then its node count)``, then the sections in that order."""
    seg_off = np.concatenate([[0], np.cumsum([rd.segs.shape[0] for rd in rounds])])
    gat_off = np.concatenate([[0], np.cumsum([rd.gathers.shape[0] for rd in rounds])])
    chain_off = np.concatenate([[0], np.cumsum([rd.chain.size for rd in rounds])])
    segs = [rd.segs + np.array([0, 0, c, 0]) for rd, c in zip(rounds, chain_off)]
    gats = [rd.gathers + np.array([0, s, 0]) for rd, s in zip(rounds, seg_off)]
    parts = [seg_off, gat_off, np.concatenate(segs).ravel() if segs else np.zeros(0, np.int64),
             np.concatenate(gats).ravel() if gats else np.zeros(0, np.int64),
             np.concatenate([rd.chain for rd in rounds]) if rounds else np.zeros(0, np.int64),
             rows.ravel(), lvl_off]
    offs = _HEADER + np.concatenate([[0], np.cumsum([a.size for a in parts])[:-1]])
    head = np.array([len(rounds), lvl_off.size - 1, *offs, rows.shape[0]], np.int64)
    assert head.size == _HEADER
    return np.concatenate([head, *parts]).astype(np.int32)


def t_forest(T_parent: np.ndarray, device: torch.device | str, rounds: int | None = None) -> TForest:
    """The checked T plan of the forest ``T_parent`` on ``device`` (at most
    ``rounds`` compression rounds, as many as T has by default; 0 walks T's
    own levels)."""
    rounds, rows, lvl_off, depth = t_plan(T_parent, rounds=rounds)
    check_t_plan(T_parent, rounds, rows, lvl_off)
    table = torch.as_tensor(_table(rounds, rows, lvl_off), device=device)
    return TForest(table=table, Tn=int(np.asarray(T_parent).size), depth=depth,
                   rounds=rounds, rows=rows, lvl_off=lvl_off)


def _norm_plain(rT, sq_extra):
    """``sqrt(sq_extra + ‖r_T‖²)`` in the kernel's order: thread ``t`` of
    the block sums entries ``t, t + 256, …``, each warp by an xor butterfly,
    the warps in order."""
    n = rT.shape[0]
    sq = rT * rT
    pad = torch.zeros(-(-max(n, 1) // SOLVE_THREADS) * SOLVE_THREADS, dtype=rT.dtype,
                      device=rT.device)
    pad[:n] = sq
    rows = pad.reshape(-1, SOLVE_THREADS)
    acc = rows[0].clone()
    for row in rows[1:]:
        acc = acc + row
    lanes = torch.arange(32, device=rT.device)
    v = acc.reshape(-1, 32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    total = v[0, 0]
    for k in range(1, v.shape[0]):
        total = total + v[k, 0]
    return torch.sqrt(sq_extra.reshape(()) + total)


def t_solve_plain(tf: TForest, dT, rT, wT, sq_extra=None):
    """Eager version in the kernel's order: ``(λ_T (Tn,), norm or None)``.
    Per round each segment eliminated bottom to top (its ``k``-th nodes
    together), then each top's segments gathered in order; the forest
    left leaf to root and root down; per round, reversed, each segment
    back-substituted from its two separators."""
    dev = dT.device
    norm = None if sq_extra is None else _norm_plain(rT, sq_extra)
    Tn = tf.Tn
    # one pad slot past Tn: the inactive lanes of a step read and write it
    d, r, w = (torch.cat([v, v.new_zeros(1)]) for v in (dT, rT, wT))
    e, td, tr = (torch.zeros(Tn + 1, dtype=dT.dtype, device=dev) for _ in range(3))

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    def mask(a):
        return torch.as_tensor(np.asarray(a, bool), device=dev)

    def chains(rd):
        """``(S, CHAIN)`` the segments' nodes by step, the pad slot past a length."""
        tab = np.full((rd.segs.shape[0], CHAIN), Tn, np.int64)
        for j, (_, _, first, n) in enumerate(rd.segs):
            tab[j, :n] = rd.chain[first : first + n]
        return idx(tab)

    for rd in tf.rounds:
        b = idx(rd.segs[:, 0])
        tab = chains(rd)
        eb = w[b]
        db = rb = dn = rn = None
        for k in range(int(rd.segs[:, 3].max())):
            on = mask(rd.segs[:, 3] > k)
            v = tab[:, k]
            dv = d[v] if k == 0 else torch.where(on, d[v] + dn, dn)
            rv = r[v] if k == 0 else torch.where(on, r[v] + rn, rn)
            wv = w[v]
            fb, ft = eb / dv, wv / dv
            cd, cr = -eb * fb, fb * rv
            if k == 0:
                db, rb = cd, cr
            else:
                db, rb = torch.where(on, db + cd, db), torch.where(on, rb + cr, rb)
            nd, nr = -wv * ft, ft * rv
            d[v], r[v], e[v] = dv, rv, eb
            dn, rn = (nd, nr) if k == 0 else (torch.where(on, nd, dn), torch.where(on, nr, rn))
            eb = torch.where(on, eb * ft, eb)
        d[b], r[b] = d[b] + db, r[b] + rb
        td[b], tr[b], w[b] = dn, rn, eb
        g = rd.gathers
        t = idx(g[:, 0])
        ud, ur = td[b[idx(g[:, 1])]], tr[b[idx(g[:, 1])]]
        for j in range(1, int(g[:, 2].max())):
            on = mask(g[:, 2] > j)
            bj = b[idx(np.minimum(g[:, 1] + j, rd.segs.shape[0] - 1))]
            ud = torch.where(on, ud + td[bj], ud)
            ur = torch.where(on, ur + tr[bj], ur)
        d[t], r[t] = d[t] + ud, r[t] + ur

    rows, off = tf.rows, tf.lvl_off
    for lv in range(tf.n_lvl - 2, -1, -1):
        here = rows[off[lv] : off[lv + 1]]
        here = here[here[:, 3] > 0]
        if not here.size:
            continue
        p = idx(here[:, 0])
        K = int(here[:, 3].max())
        ud = ur = None
        for j in range(K):
            on = mask(here[:, 3] > j)
            c = idx(rows[np.minimum(here[:, 2] + j, rows.shape[0] - 1), 0])
            factor = w[c] / d[c]
            cd, cr = -w[c] * factor, factor * r[c]
            ud = cd if j == 0 else torch.where(on, ud + cd, ud)
            ur = cr if j == 0 else torch.where(on, ur + cr, ur)
        d[p], r[p] = d[p] + ud, r[p] + ur
    lam = torch.zeros(Tn + 1, dtype=dT.dtype, device=dev)
    for lv in range(tf.n_lvl):
        here = rows[off[lv] : off[lv + 1]]
        t, p = idx(here[:, 0]), idx(here[:, 1])
        lam_p = lam[p.clamp(min=0)]
        lam[t] = torch.where(p >= 0, (r[t] + w[t] * lam_p) / d[t], r[t] / d[t])
    for rd in reversed(tf.rounds):
        tab = chains(rd)
        lb = lam[idx(rd.segs[:, 0])]
        ln = lam[idx(rd.segs[:, 1])]
        for k in range(CHAIN - 1, -1, -1):
            on = mask(rd.segs[:, 3] > k)
            if not bool(on.any()):
                continue
            v = tab[:, k]
            x = ((r[v] + e[v] * lb) + w[v] * ln) / d[v]
            lam[v] = torch.where(on, x, lam[v])
            ln = torch.where(on, x, ln)
    return lam[:Tn], norm


def t_solve(tf: TForest, dT, rT, wT, sq_extra=None):
    """The T solve on ``dT``'s device: ``(λ_T, sqrt(sq_extra + ‖r_T‖²) or None)``."""
    if dT.device.type == "cpu":
        return t_solve_plain(tf, dT, rT, wT, sq_extra)
    if tf.Tn == 0 and sq_extra is None:
        return dT[:0].clone(), None
    extra = [] if sq_extra is None else [sq_extra]
    build.require_cuda("t_solve", dT, rT, wT, *extra)
    build.require_cuda("t_solve", tf.table, dtype=torch.int32)
    Tn = tf.Tn
    if any(tuple(t.shape) != (Tn,) for t in (dT, rT, wT)):
        raise ValueError("t_solve: dT, rT and wT must be (Tn,)")
    if Tn > MAX_TN:
        raise ValueError("t_solve: at most 4,096 T nodes")
    if tf.table.device != dT.device:
        raise ValueError("t_solve: the plan is on another device")
    dev = dT.device
    lam = torch.empty(max(Tn, 1), dtype=torch.float64, device=dev)
    norm = None if sq_extra is None else torch.empty((), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_t_solve(
            Tn, tf.table.data_ptr(), dT.data_ptr(), rT.data_ptr(), wT.data_ptr(),
            None if sq_extra is None else sq_extra.data_ptr(), lam.data_ptr(),
            None if norm is None else norm.data_ptr(), build.stream_handle(dev),
        )
    build.check(code, "t_solve")
    T_SOLVE.launches += 1
    return lam[:Tn], norm
