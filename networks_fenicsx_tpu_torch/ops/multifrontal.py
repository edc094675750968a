"""Tree supernodal multifrontal elimination of cyclic bifurcation cores (host).

Counterpart of the host half of ``networks_fenicsx_tpu/ops/multifrontal.py``
(``:69-555``): ``_csr_adjacency``, ``_neighbors_many``, ``_bfs_component``,
``build_nd_tree``, ``_GroupMeta``, ``MFPlan``, ``_size_class`` and
``plan_multifrontal``, line for line — the same inputs give
``np.array_equal`` buffers and equal ``groups``, so the fronts, their
grouping and the λ stream are the reference's.

The elimination follows the nested-dissection separator tree: each tree
node is a dense front (its pivots plus the ancestors its subtree touches),
fronts are grouped by (tree level, padded size class), and a group is one
batched launch.  :func:`device_mf_plan` uploads the flat int buffers once
per executor and builds the host launch tables of the factor (K13 + K14,
:mod:`..kernels.mf_factor`) and the apply (K15, :mod:`..kernels.mf_apply`).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

__all__ = [
    "MFPlan",
    "DeviceMFPlan",
    "build_nd_tree",
    "device_mf_plan",
    "plan_multifrontal",
]


# ---------------------------------------------------------------------------
# host: graph utilities
# ---------------------------------------------------------------------------


def _csr_adjacency(core_pairs: np.ndarray, n_core: int):
    ci = np.asarray(core_pairs[:, 0], dtype=np.int64)
    cj = np.asarray(core_pairs[:, 1], dtype=np.int64)
    src = np.concatenate([ci, cj])
    dst = np.concatenate([cj, ci])
    o = np.argsort(src, kind="stable")
    src, dst = src[o], dst[o]
    indptr = np.zeros(n_core + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    return np.cumsum(indptr), dst


def _neighbors_many(indptr: np.ndarray, dst: np.ndarray, vs: np.ndarray):
    """All neighbours of ``vs`` (with multiplicity), vectorized."""
    starts = indptr[vs]
    counts = indptr[vs + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    offs = np.cumsum(counts) - counts
    pos = np.arange(total, dtype=np.int64) - np.repeat(offs, counts)
    return dst[np.repeat(starts, counts) + pos]


def _bfs_component(indptr, dst, seed: int, in_part, stamp: int, level):
    """One vectorized BFS inside the stamped part; fills ``level`` and
    returns (component nodes in BFS order, last frontier)."""
    level[seed] = 0
    frontier = np.asarray([seed], dtype=np.int64)
    order = [frontier]
    lv = 0
    while True:
        nbr = _neighbors_many(indptr, dst, frontier)
        nbr = nbr[(in_part[nbr] == stamp) & (level[nbr] < 0)]
        if nbr.size == 0:
            return np.concatenate(order), frontier
        nbr = np.unique(nbr)
        lv += 1
        level[nbr] = lv
        order.append(nbr)
        frontier = nbr


def build_nd_tree(
    core_pairs: np.ndarray, n_core: int, leaf: int = 64
) -> tuple[list[np.ndarray], list[list[int]]]:
    """Nested-dissection separator tree, postorder.

    Returns ``(pivots, children)``: ``pivots[f]`` are tree node f's pivot
    node ids (elimination-ordered within the node), ``children[f]`` the
    ids of the tree nodes it consumes.  Children strictly precede parents,
    and the concatenation of ``pivots`` is a valid elimination order.
    Bisection: two-pass pseudo-peripheral BFS; the separator is the
    thinnest BFS level in the 35–65 % cumulative band.
    """
    indptr, dst = _csr_adjacency(core_pairs, n_core)
    pivots: list[np.ndarray] = []
    children: list[list[int]] = []
    in_part = np.full(n_core, -1, dtype=np.int64)
    level = np.full(n_core, -1, dtype=np.int64)
    stamp_box = [0]

    def process(nodes: np.ndarray) -> list[int]:
        """Dissect ``nodes``; returns the top tree-node id per component."""
        tops: list[int] = []
        stamp_box[0] += 1
        stamp = stamp_box[0]
        in_part[nodes] = stamp
        level[nodes] = -1
        remaining = nodes
        comps = []
        while remaining.size:
            seed = int(remaining[0])
            comp, far = _bfs_component(indptr, dst, seed, in_part, stamp, level)
            if comp.size > leaf:
                # second pass from a pseudo-peripheral node for the levels
                level[comp] = -1
                comp, _ = _bfs_component(indptr, dst, int(far[0]), in_part, stamp, level)
            comps.append((comp, level[comp].copy()))
            if comp.size == remaining.size:
                break
            mask = np.ones(remaining.size, dtype=bool)
            mask[np.isin(remaining, comp)] = False
            remaining = remaining[mask]
        for comp, lvs in comps:
            if comp.size <= leaf:
                pivots.append(comp)  # BFS order
                children.append([])
                tops.append(len(pivots) - 1)
                continue
            counts = np.bincount(lvs)
            cum = np.cumsum(counts)
            lo_b = int(np.searchsorted(cum, int(0.35 * comp.size)))
            hi_b = int(np.searchsorted(cum, int(0.65 * comp.size)))
            lo_b = min(max(lo_b, 1), counts.size - 1)
            hi_b = min(max(hi_b, lo_b), counts.size - 1)
            band = counts[lo_b : hi_b + 1]
            half = lo_b + int(np.argmin(band))
            sep = comp[lvs == half]
            lo = comp[lvs < half]
            hi = comp[lvs > half]
            kids: list[int] = []
            if lo.size:
                kids += process(lo)
            if hi.size:
                kids += process(hi)
            pivots.append(sep)
            children.append(kids)
            tops.append(len(pivots) - 1)
        return tops

    process(np.arange(n_core, dtype=np.int64))
    assert sum(p.size for p in pivots) == n_core
    return pivots, children


# ---------------------------------------------------------------------------
# plan structures
# ---------------------------------------------------------------------------


class _GroupMeta(typing.NamedTuple):
    """Static descriptor of one batched front group."""

    k: int  # fronts in the group
    w: int  # padded pivot width
    b: int  # padded boundary width
    c: int  # padded per-pivot-row original-entry count
    nodes_off: int  # offset into nodes_all, length k*w
    cval_off: int  # offset into cval_all, length k*w*c
    ccol_off: int  # offset into ccol_all, length k*w*c
    bndpos_off: int  # offset into bndpos_all, length k*b
    lam_off: int  # this group's segment offset in the λ stream
    # consume descriptors: (child_group, cidx_off (k,), lminv_off (k*(w+b),))
    consume: tuple


class MFPlan(typing.NamedTuple):
    """Host-planned tree-multifrontal elimination (see module docs).

    All per-group index payloads live concatenated in a handful of flat
    int32 buffers; ``groups`` carries the static offsets and shapes."""

    n_core: int
    n_pairs: int  # P0 (cval entries index (P0+1,))
    lam_len: int  # λ stream length (sum of k*w over groups)
    n_refine: int  # f64 iterative-refinement sweeps in the apply
    groups: tuple  # tuple[_GroupMeta], factor/forward order
    init_slot: np.ndarray  # (P0,) global pair id per core pair
    nodes_all: np.ndarray  # int32 concat of (k, w) pivot ids, pad = n_core
    cval_all: np.ndarray  # int32 concat of (k, w, c) value idx, pad = P0
    ccol_all: np.ndarray  # int32 concat of (k, w, c) local cols, pad = m
    bndpos_all: np.ndarray  # int32 concat of (k, b) λ-stream pos, pad = lam_len
    cidx_all: np.ndarray  # int32 concat of (k,) child row indices
    lminv_all: np.ndarray  # int32 concat of (k, m) parent→child-U maps
    lam_pos: np.ndarray  # (n_core,) node -> λ stream position
    # f64 core operator for iterative refinement: y = dc⊙x − Σ_p w_p x_other
    pci: np.ndarray  # (P0,) pair endpoints, core-rank
    pcj: np.ndarray  # (P0,)
    mv_fold_i: tuple  # fold plan: per-pair contribs -> per-ci sums
    mv_fold_j: tuple  # fold plan: per-pair contribs -> per-cj sums
    mv_inv_i: np.ndarray  # (n_core,) inverse map of fold_i targets
    mv_inv_j: np.ndarray  # (n_core,)

    @property
    def stats(self) -> dict:
        ks = [g.k for g in self.groups]
        return {
            "core": self.n_core,
            "mf_groups": len(self.groups),
            "mf_fronts": int(sum(ks)),
            "front_max": max((g.w + g.b for g in self.groups), default=0),
            "index_mb": round(self.index_bytes / 1e6, 1),
        }

    @property
    def index_bytes(self) -> int:
        return sum(leaf.size * leaf.dtype.itemsize for leaf in _leaves(self))


def _leaves(p: MFPlan) -> list[np.ndarray]:
    """The array fields of a plan, the fold-level tuples flattened."""
    out = []
    for item in (
        p.init_slot, p.nodes_all, p.cval_all, p.ccol_all, p.bndpos_all,
        p.cidx_all, p.lminv_all, p.lam_pos, p.pci, p.pcj,
        p.mv_fold_i, p.mv_fold_j, p.mv_inv_i, p.mv_inv_j,
    ):
        out.extend(item if isinstance(item, tuple) else (item,))
    return out


def _size_class(x: int, grid_step: float = 1.5) -> int:
    """Smallest member ≥ x of a geometric size grid (multiples of 8),
    bounding padding waste at ~grid_step while keeping group count low."""
    c = 8
    while c < x:
        c = int(np.ceil(c * grid_step / 8.0)) * 8
    return c


def plan_multifrontal(
    core_pairs: np.ndarray,
    n_core: int,
    leaf: int = 64,
    front_cap: int = 16384,
    max_groups: int = 160,
    max_index_mb: float = 512.0,
    n_refine: int = 3,
) -> MFPlan | None:
    """Symbolic tree-multifrontal phase (see module docs).

    ``core_pairs`` is ``(P0, 3)`` rows ``(ci, cj, pair_id)`` in core-rank
    numbering (the ``_TreePlan.core_pairs`` layout); refusal returns
    ``None``.  Budgets: ``front_cap`` bounds any front's padded size;
    ``max_groups`` the number of groups; ``max_index_mb`` the index
    payload.  ``n_refine`` sets the f64 refinement sweeps of the apply.
    """
    P0 = int(core_pairs.shape[0])
    if n_core == 0 or P0 == 0:
        return None
    pivots, kids = build_nd_tree(core_pairs, n_core, leaf=leaf)
    nf = len(pivots)

    # postorder ranks / front membership
    rank = np.empty(n_core, dtype=np.int64)
    front_of = np.empty(n_core, dtype=np.int64)
    pos_in = np.empty(n_core, dtype=np.int64)
    r = 0
    for f in range(nf):
        piv = pivots[f]
        rank[piv] = np.arange(r, r + piv.size)
        front_of[piv] = f
        pos_in[piv] = np.arange(piv.size)
        r += piv.size

    # tree levels (children precede parents in postorder)
    tlevel = np.zeros(nf, dtype=np.int64)
    for f in range(nf):
        for ch in kids[f]:
            tlevel[f] = max(tlevel[f], tlevel[ch] + 1)

    # boundaries, bottom-up: ancestors adjacent to the subtree
    indptr, dst = _csr_adjacency(core_pairs, n_core)
    bnds: list[np.ndarray] = [np.empty(0, np.int64)] * nf
    for f in range(nf):
        piv = pivots[f]
        cand = [_neighbors_many(indptr, dst, piv)]
        cand += [bnds[ch] for ch in kids[f]]
        cand_u = np.unique(np.concatenate(cand))
        rmax = int(rank[piv].max())
        bnds[f] = cand_u[rank[cand_u] > rmax]
        if piv.size + bnds[f].size > front_cap:
            return None

    # pair → front assignment (front pivoting the lower-ranked endpoint)
    ci = np.asarray(core_pairs[:, 0], dtype=np.int64)
    cj = np.asarray(core_pairs[:, 1], dtype=np.int64)
    swap = rank[ci] > rank[cj]
    plo = np.where(swap, cj, ci)
    pup = np.where(swap, ci, cj)
    pf = front_of[plo]
    pair_order = np.argsort(pf, kind="stable")
    pair_bounds = np.searchsorted(pf[pair_order], np.arange(nf + 1))

    # per-front compact entry lists: (pivot row, local col, value idx).
    # Entries live in the pivot-row strip; S-S pairs appear on BOTH pivot
    # rows so the assembled strip is symmetric over the pivot block.
    ent_rows: list[np.ndarray] = [None] * nf  # type: ignore[list-item]
    ent_cols: list[np.ndarray] = [None] * nf  # type: ignore[list-item]
    ent_vals: list[np.ndarray] = [None] * nf  # type: ignore[list-item]
    c_real = np.zeros(nf, dtype=np.int64)
    for f in range(nf):
        sel = pair_order[pair_bounds[f] : pair_bounds[f + 1]]
        bnd = bnds[f]
        if sel.size:
            li = pos_in[plo[sel]]
            up = pup[sel]
            in_piv = front_of[up] == f
            # columns in front-local unpadded numbering here; shifted into
            # the padded layout when the group payloads are built
            lu_piv = pos_in[up]
            lu_bnd = np.searchsorted(bnd, up)
            rows = np.concatenate([li, lu_piv[in_piv]])
            cols = np.concatenate(
                [
                    np.where(in_piv, lu_piv, pivots[f].size + lu_bnd),
                    li[in_piv],
                ]
            )
            vals = np.concatenate([sel, sel[in_piv]])
        else:
            rows = cols = vals = np.empty(0, np.int64)
        ent_rows[f], ent_cols[f], ent_vals[f] = rows, cols, vals
        if rows.size:
            c_real[f] = int(np.bincount(rows).max())

    # group fronts by (tree level, pivot class, boundary class)
    w_real = np.asarray([p.size for p in pivots])
    b_real = np.asarray([b.size for b in bnds])
    keys = [
        (int(tlevel[f]), _size_class(int(w_real[f])),
         _size_class(int(b_real[f])) if b_real[f] else 0)
        for f in range(nf)
    ]
    group_ids: dict[tuple, int] = {}
    members: list[list[int]] = []
    for f in range(nf):
        g = group_ids.setdefault(keys[f], len(group_ids))
        if g == len(members):
            members.append([])
        members[g].append(f)
    if len(members) > max_groups:
        return None
    order = sorted(range(len(members)), key=lambda g: keys[members[g][0]][0])
    group_of = np.empty(nf, dtype=np.int64)
    row_of = np.empty(nf, dtype=np.int64)
    for gi, g in enumerate(order):
        for row, f in enumerate(members[g]):
            group_of[f] = gi
            row_of[f] = row

    # λ stream layout (offsets static and disjoint)
    lam_off_g = []
    lam_len = 0
    for g in order:
        lam_off_g.append(lam_len)
        f0 = members[g][0]
        lam_len += len(members[g]) * keys[f0][1]

    lam_pos = np.empty(n_core, dtype=np.int64)
    for f in range(nf):
        gi = int(group_of[f])
        wpad = keys[members[order[gi]][0]][1]
        seg = lam_off_g[gi] + row_of[f] * wpad
        lam_pos[pivots[f]] = seg + pos_in[pivots[f]]

    # per-group payloads
    nodes_parts: list[np.ndarray] = []
    cval_parts: list[np.ndarray] = []
    ccol_parts: list[np.ndarray] = []
    bndpos_parts: list[np.ndarray] = []
    cidx_parts: list[np.ndarray] = []
    lminv_parts: list[np.ndarray] = []
    groups: list[_GroupMeta] = []
    nodes_off = cv_off = bndpos_off = cidx_off = lminv_off = 0
    for gi, g in enumerate(order):
        fs = members[g]
        k = len(fs)
        _, wpad, bpad = keys[fs[0]]
        m = wpad + bpad
        cpad = max(1, int(max(c_real[fs])))
        nodes = np.full((k, wpad), n_core, dtype=np.int64)
        cval = np.full((k, wpad, cpad), P0, dtype=np.int64)
        ccol = np.full((k, wpad, cpad), m, dtype=np.int64)
        bndpos = np.full((k, bpad), lam_len, dtype=np.int64)
        con_groups: dict[tuple, list[tuple[int, int]]] = {}
        for row, f in enumerate(fs):
            piv = pivots[f]
            w_f = piv.size
            nodes[row, :w_f] = piv
            bnd = bnds[f]
            bndpos[row, : bnd.size] = lam_pos[bnd]
            rows_f, cols_f, vals_f = ent_rows[f], ent_cols[f], ent_vals[f]
            if rows_f.size:
                # boundary cols shift into the padded layout
                cols_p = np.where(cols_f >= w_f, cols_f - w_f + wpad, cols_f)
                o = np.argsort(rows_f, kind="stable")
                rs, cs, vs = rows_f[o], cols_p[o], vals_f[o]
                slot = np.arange(rs.size) - np.searchsorted(rs, rs)
                cval[row, rs, slot] = vs
                ccol[row, rs, slot] = cs
            occ: dict[int, int] = {}
            for ch in kids[f]:
                if bnds[ch].size == 0:
                    continue  # nothing to extend-add
                cg = int(group_of[ch])
                oo = occ.get(cg, 0)
                occ[cg] = oo + 1
                con_groups.setdefault((cg, oo), []).append((row, ch))
        consume = []
        for (cg, _o), entries in sorted(con_groups.items()):
            kc = len(members[order[cg]])
            cbpad = keys[members[order[cg]][0]][2]
            cidx = np.full(k, kc, dtype=np.int64)
            lminv = np.full((k, m), cbpad, dtype=np.int64)
            for row, ch in entries:
                cidx[row] = row_of[ch]
                cb_nodes = bnds[ch]
                f = fs[row]
                in_piv = front_of[cb_nodes] == f
                ploc = np.where(
                    in_piv,
                    pos_in[cb_nodes],
                    wpad + np.searchsorted(bnds[f], cb_nodes),
                )
                lminv[row, ploc] = np.arange(cb_nodes.size)
            consume.append((cg, cidx_off, lminv_off))
            cidx_parts.append(cidx)
            lminv_parts.append(lminv.reshape(-1))
            cidx_off += k
            lminv_off += k * m
        groups.append(
            _GroupMeta(
                k=k, w=wpad, b=bpad, c=cpad,
                nodes_off=nodes_off, cval_off=cv_off, ccol_off=cv_off,
                bndpos_off=bndpos_off, lam_off=lam_off_g[gi],
                consume=tuple(consume),
            )
        )
        nodes_parts.append(nodes.reshape(-1))
        cval_parts.append(cval.reshape(-1))
        ccol_parts.append(ccol.reshape(-1))
        bndpos_parts.append(bndpos.reshape(-1))
        nodes_off += k * wpad
        cv_off += k * wpad * cpad
        bndpos_off += k * bpad

    # iterative-refinement matvec plans (exact f64 core operator)
    from .core_elim import _inverse_map, _plan_fold

    tgt_i, seg_i = np.unique(ci, return_inverse=True)
    tgt_j, seg_j = np.unique(cj, return_inverse=True)
    mv_fold_i = _plan_fold(seg_i, tgt_i.size, np.arange(P0), P0)
    mv_fold_j = _plan_fold(seg_j, tgt_j.size, np.arange(P0), P0)
    mv_inv_i = _inverse_map(tgt_i, n_core, tgt_i.size)
    mv_inv_j = _inverse_map(tgt_j, n_core, tgt_j.size)

    def cat(parts, dtype=np.int32):
        if not parts:
            return np.empty(0, dtype)
        out = np.concatenate(parts)
        assert out.size == 0 or int(out.max()) < np.iinfo(np.int32).max
        return out.astype(np.int32)

    plan = MFPlan(
        n_core=n_core,
        n_pairs=P0,
        lam_len=lam_len,
        n_refine=n_refine,
        groups=tuple(groups),
        init_slot=np.asarray(core_pairs[:, 2], dtype=np.int32),
        nodes_all=cat(nodes_parts),
        cval_all=cat(cval_parts),
        ccol_all=cat(ccol_parts),
        bndpos_all=cat(bndpos_parts),
        cidx_all=cat(cidx_parts),
        lminv_all=cat(lminv_parts),
        lam_pos=lam_pos.astype(np.int32),
        pci=ci.astype(np.int32),
        pcj=cj.astype(np.int32),
        mv_fold_i=tuple(lv.astype(np.int32) for lv in mv_fold_i),
        mv_fold_j=tuple(lv.astype(np.int32) for lv in mv_fold_j),
        mv_inv_i=mv_inv_i.astype(np.int32),
        mv_inv_j=mv_inv_j.astype(np.int32),
    )
    if plan.index_bytes > max_index_mb * 1e6:
        return None
    return plan


# ---------------------------------------------------------------------------
# device payload
# ---------------------------------------------------------------------------

# columns of DeviceMFPlan.groups
G_K, G_W, G_B, G_C, G_NODES, G_CVAL, G_BNDPOS, G_LAM, G_FAC, G_POOL, G_VPOOL, G_CONS, G_NCONS = (
    range(13)
)
# columns of DeviceMFPlan.consume: the child group's U-pool and v-pool
# offsets, its front count and boundary width, and this edge's cidx and
# lminv offsets
C_POOL, C_VPOOL, C_K, C_B, C_CIDX, C_LMINV = range(6)


@dataclasses.dataclass(frozen=True)
class DeviceMFPlan:
    """A :class:`MFPlan` on one device, uploaded once per executor.

    Attributes:
        plan: The host plan.
        init_slot … mv_inv_j: The plan's flat int32 buffers as tensors
            (the fold plans as tuples of ``(n_grp, K)`` tensors).
        groups: host ``(G, 13)`` int64 launch table, one row per group in
            factor order (columns ``G_*``): shapes, offsets into the flat
            index buffers and the λ stream, offsets into the factor, U-pool
            and v-pool buffers, and the group's rows of ``consume``.
        consume: ``(n_consume, 6)`` int64 table on the device (columns
            ``C_*``).
        fac_len: f64 length of the factor buffer: Σ k·m² over groups, each
            front's ``(m, m)`` block holding L (pivot block, lower, with Lᵀ
            above its diagonal), Yᵀ = (L⁻¹F_SB)ᵀ (lower-left) and
            U = F_BB − YᵀY (lower-right, lower).
        pool_len: f64 length of the U pools, Σ k·b² (each front's full U).
        vpool_len: f64 length of the apply's boundary pools, Σ k·b.
    """

    plan: MFPlan
    init_slot: torch.Tensor
    nodes_all: torch.Tensor
    cval_all: torch.Tensor
    ccol_all: torch.Tensor
    bndpos_all: torch.Tensor
    cidx_all: torch.Tensor
    lminv_all: torch.Tensor
    lam_pos: torch.Tensor
    pci: torch.Tensor
    pcj: torch.Tensor
    mv_fold_i: tuple
    mv_fold_j: tuple
    mv_inv_i: torch.Tensor
    mv_inv_j: torch.Tensor
    groups: np.ndarray
    consume: torch.Tensor
    fac_len: int
    pool_len: int
    vpool_len: int

    @property
    def n_core(self) -> int:
        return self.plan.n_core

    @property
    def device_bytes(self) -> int:
        """f64 bytes of the factor, its pools and one apply's streams."""
        return 8 * (self.fac_len + self.pool_len + self.vpool_len + 2 * self.plan.lam_len)


def mf_launch_tables(plan: MFPlan) -> tuple[np.ndarray, np.ndarray, int, int, int]:
    """``(groups, consume, fac_len, pool_len, vpool_len)`` of
    :class:`DeviceMFPlan`, from the host plan alone."""
    G = len(plan.groups)
    groups = np.zeros((G, 13), np.int64)
    pool_off = np.zeros(G, np.int64)
    vpool_off = np.zeros(G, np.int64)
    fac = pool = vpool = 0
    cons_rows = []
    for gi, g in enumerate(plan.groups):
        m = g.w + g.b
        pool_off[gi], vpool_off[gi] = pool, vpool
        groups[gi, [G_K, G_W, G_B, G_C]] = g.k, g.w, g.b, g.c
        groups[gi, [G_NODES, G_CVAL, G_BNDPOS, G_LAM]] = (
            g.nodes_off, g.cval_off, g.bndpos_off, g.lam_off
        )
        groups[gi, [G_FAC, G_POOL, G_VPOOL]] = fac, pool, vpool
        groups[gi, [G_CONS, G_NCONS]] = len(cons_rows), len(g.consume)
        for cg, cidx_off, lminv_off in g.consume:
            child = plan.groups[cg]
            cons_rows.append((pool_off[cg], vpool_off[cg], child.k, child.b, cidx_off, lminv_off))
        fac += g.k * m * m
        pool += g.k * g.b * g.b
        vpool += g.k * g.b
    consume = np.asarray(cons_rows, np.int64).reshape(-1, 6)
    return groups, consume, fac, pool, vpool


def device_mf_plan(plan: MFPlan, device: torch.device | str) -> DeviceMFPlan:
    """Upload ``plan``'s int buffers to ``device`` once, with its launch tables."""

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    groups, consume, fac_len, pool_len, vpool_len = mf_launch_tables(plan)
    return DeviceMFPlan(
        plan=plan,
        init_slot=up(plan.init_slot),
        nodes_all=up(plan.nodes_all),
        cval_all=up(plan.cval_all),
        ccol_all=up(plan.ccol_all),
        bndpos_all=up(plan.bndpos_all),
        cidx_all=up(plan.cidx_all),
        lminv_all=up(plan.lminv_all),
        lam_pos=up(plan.lam_pos),
        pci=up(plan.pci),
        pcj=up(plan.pcj),
        mv_fold_i=tuple(up(lv) for lv in plan.mv_fold_i),
        mv_fold_j=tuple(up(lv) for lv in plan.mv_fold_j),
        mv_inv_i=up(plan.mv_inv_i),
        mv_inv_j=up(plan.mv_inv_j),
        groups=groups,
        consume=torch.as_tensor(consume, device=device),
        fac_len=fac_len,
        pool_len=pool_len,
        vpool_len=vpool_len,
    )
