"""Distributed (multiplier-sharded) exact tree elimination.

Counterpart of ``networks_fenicsx_tpu/parallel/distributed_tree.py``:
``DistTreePlan``, ``_bif_forest`` and ``plan_distributed_tree``
(``:43-375``), ``plan_rows`` (``:388-393``) and the per-shard program
``local_eliminate`` (``:396-515``), which :class:`DistTreeExecutor` runs
as K22c (:mod:`..kernels.dist_tree`) split around the psum: per shard its
K8a edge data, then the folds and the level walks of every shard of a
device in one launch each; across the shards K22-reduce and the T solve
(once per distinct device); per device again the back walks in one launch,
then K8b a shard.

The bifurcation forest is partitioned on the host into D bins of complete
subtrees plus a small replicated top forest T; edges follow the node
partition, so every Schur contribution of a shard's edges lands on its own
nodes or on T, and the cross-shard traffic is one reduce of the T system.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from ..adjoint import refuse_grad
from ..kernels import backsub, dist_tree, edge_data, shard_top

__all__ = ["DistTreePlan", "plan_distributed_tree", "plan_rows", "DistTreeExecutor"]


class DistTreePlan(typing.NamedTuple):
    """Host-built static plan for the distributed λ elimination (the
    reference's fields; arrays with a leading ``D`` axis are per shard,
    padded to uniform shape)."""

    D: int
    B: int  # true multiplier count
    B_loc: int  # padded per-shard local node count
    Tn: int  # replicated top-tree size
    level_offsets: np.ndarray  # (L+1,) uniform local level slice bounds
    edge_perm: np.ndarray  # (D, E_loc) index into the PADDED edge arrays
    e_start_loc: np.ndarray  # (D, E_loc) remapped start_bif: local pos,
    #     B_loc + t for T nodes, -1 for boundary/pad
    e_end_loc: np.ndarray  # (D, E_loc)
    t_sel: np.ndarray  # (D, S_t) local edge index of end-bif contributions
    t_fold: np.ndarray  # (D, B_loc, K) gather-fold into the sel stream
    t_mask: np.ndarray  # (D, S_t) 1.0 valid / 0.0 pad
    s_sel: np.ndarray  # (D, S_s) start-bif contributions
    s_fold: np.ndarray
    s_mask: np.ndarray
    w_sel: np.ndarray  # (D, S_w) pair edges, folded onto the child node
    w_fold: np.ndarray
    w_mask: np.ndarray
    tT_sel: np.ndarray  # (D, S_T) end-bif in T
    tT_fold: np.ndarray  # (D, Tn, K)
    tT_mask: np.ndarray
    sT_sel: np.ndarray  # (D, S_T2) start-bif in T
    sT_fold: np.ndarray
    sT_mask: np.ndarray
    wT_sel: np.ndarray  # (D, S_WT) T-T pair edges, child T index
    wT_fold: np.ndarray
    wT_mask: np.ndarray
    level_folds: tuple  # per level 1..L-1: (D, npar, K) into the child slice (n = pad)
    parent_pos: np.ndarray  # (D, B_loc) local parent position (self for level 0 / pads)
    root_T_idx: np.ndarray  # (D, W0) T index of each level-0 node's parent (Tn none)
    T_parent: np.ndarray  # (Tn,) parent T index (-1 roots)
    lam_src: np.ndarray  # (B,) index into [flat local (D*B_loc) | T (Tn)]
    edge_inv: np.ndarray  # (E,) position of edge e in the flat (D*E_loc) layout


def _bif_forest(B: int, pairs: np.ndarray):
    """Rooted forest over the bifurcation pair graph: (depth, parent).
    Roots = minimum-id node per component."""
    P = pairs.shape[0]
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order, connected_components

    depth = np.full(B, -1, np.int64)
    parent = np.full(B, -1, np.int64)
    if P == 0:
        return np.zeros(B, np.int64), parent

    adjm = sp.csr_matrix(
        (np.ones(2 * P), (np.r_[pairs[:, 0], pairs[:, 1]], np.r_[pairs[:, 1], pairs[:, 0]])),
        shape=(B, B),
    )
    n_comp, labels = connected_components(adjm, directed=False)
    _, roots = np.unique(labels, return_index=True)
    for r in roots:
        order, preds = breadth_first_order(adjm, int(r), directed=False, return_predecessors=True)
        parent[order] = preds[order]
        parent[int(r)] = -1
        depth[int(r)] = 0
        for v in order[1:]:
            depth[v] = depth[parent[v]] + 1
    return depth, parent


def plan_distributed_tree(asm, tree_plan, D: int, max_T: int = 4096) -> DistTreePlan | None:
    """Build the distributed elimination plan, or None when unsupported
    (cycle cores, or a top tree too large, e.g. chain-like networks)."""
    mesh = asm.network
    B = mesh.num_multipliers
    if B == 0 or tree_plan is None or tree_plan.core_size > 0:
        return None
    pairs = np.asarray(tree_plan.pair_nodes)
    depth, parent = _bif_forest(B, pairs)

    size = np.ones(B, np.int64)
    max_depth = int(depth.max()) if B else 0
    for d in range(max_depth, 0, -1):
        nodes = np.flatnonzero(depth == d)
        np.add.at(size, parent[nodes], size[nodes])

    target = -(-B // D)  # ceil
    inT = size > target
    if np.count_nonzero(inT) > max_T:
        return None
    T_nodes = np.flatnonzero(inT)
    Tn = int(T_nodes.size)
    tidx = np.full(B, -1, np.int64)
    tidx[T_nodes] = np.arange(Tn)
    T_parent = np.full(Tn, -1, np.int64)
    has_par = parent[T_nodes] >= 0
    T_parent[has_par] = tidx[parent[T_nodes[has_par]]]
    assert np.all((parent[T_nodes[has_par]] < 0) | inT[parent[T_nodes[has_par]]])

    par_safe = np.where(parent >= 0, parent, 0)
    is_chunk_root = (~inT) & ((parent < 0) | inT[par_safe])
    chunk_roots = np.flatnonzero(is_chunk_root)
    n_chunks = int(chunk_roots.size)
    chunk_of = np.full(B, -1, np.int64)
    chunk_of[chunk_roots] = np.arange(n_chunks)
    for d in range(1, max_depth + 1):
        nodes = np.flatnonzero((depth == d) & ~inT & ~is_chunk_root)
        chunk_of[nodes] = chunk_of[parent[nodes]]

    s_bif = np.asarray(asm._edge_start_bif, np.int64)
    t_bif = np.asarray(asm._edge_end_bif, np.int64)
    E = s_bif.shape[0]
    both = (s_bif >= 0) & (t_bif >= 0)
    sd = np.where(s_bif >= 0, depth[np.where(s_bif >= 0, s_bif, 0)], -1)
    td = np.where(t_bif >= 0, depth[np.where(t_bif >= 0, t_bif, 0)], -1)
    child_bif = np.where(both, np.where(sd > td, s_bif, t_bif),
                         np.where(s_bif >= 0, s_bif, t_bif))
    own_chunk = np.where(child_bif >= 0, chunk_of[np.where(child_bif >= 0, child_bif, 0)], -1)

    weights = np.bincount(own_chunk[own_chunk >= 0], minlength=n_chunks)
    bin_of_chunk = np.zeros(n_chunks, np.int64)
    loads = np.zeros(D, np.int64)
    for c in np.argsort(weights)[::-1]:
        k = int(np.argmin(loads))
        bin_of_chunk[c] = k
        loads[k] += weights[c]
    edge_dev = np.where(own_chunk >= 0, bin_of_chunk[np.where(own_chunk >= 0, own_chunk, 0)], -1)
    free = np.flatnonzero(edge_dev < 0)
    for e in free:
        k = int(np.argmin(loads))
        edge_dev[e] = k
        loads[k] += 1

    E_loc = int(np.max(np.bincount(edge_dev, minlength=D)))
    edge_perm = np.full((D, E_loc), E, np.int64)
    local_edge_of = np.full(E, -1, np.int64)
    for k in range(D):
        mine = np.flatnonzero(edge_dev == k)
        edge_perm[k, : mine.size] = mine
        local_edge_of[mine] = np.arange(mine.size)
    edge_inv = np.empty(E, np.int64)
    edge_inv = edge_dev * E_loc + local_edge_of

    node_dev = np.full(B, -1, np.int64)
    sel_nodes = ~inT
    node_dev[sel_nodes] = bin_of_chunk[chunk_of[sel_nodes]]
    depth_local = np.full(B, -1, np.int64)
    root_depth_of_chunk = depth[chunk_roots]
    depth_local[sel_nodes] = depth[sel_nodes] - root_depth_of_chunk[chunk_of[sel_nodes]]
    L = int(depth_local.max()) + 1 if np.any(sel_nodes) else 1

    lvl_w = np.zeros(L, np.int64)
    for lev in range(L):
        at = depth_local == lev
        if np.any(at):
            lvl_w[lev] = np.max(np.bincount(node_dev[at], minlength=D))
    lvl_w = np.maximum(lvl_w, 1)
    level_offsets = np.concatenate([[0], np.cumsum(lvl_w)])
    B_loc = int(level_offsets[-1])

    pos_local = np.full(B, -1, np.int64)
    parent_pos = np.tile(np.arange(B_loc, dtype=np.int64), (D, 1))
    for lev in range(L):
        off = int(level_offsets[lev])
        for k in range(D):
            nodes = np.flatnonzero((depth_local == lev) & (node_dev == k))
            if lev > 0 and nodes.size:
                nodes = nodes[np.argsort(pos_local[parent[nodes]], kind="stable")]
            pos_local[nodes] = off + np.arange(nodes.size)
            if lev > 0 and nodes.size:
                parent_pos[k, off : off + nodes.size] = pos_local[parent[nodes]]
                if nodes.size < lvl_w[lev]:
                    parent_pos[k, off + nodes.size : off + int(lvl_w[lev])] = (
                        pos_local[parent[nodes]][-1]
                    )
            elif lev > 0:
                parent_pos[k, off : off + int(lvl_w[lev])] = int(level_offsets[lev - 1])

    level_folds = []
    for lev in range(1, L):
        o, op = int(level_offsets[lev]), int(level_offsets[lev - 1])
        n, npar = int(lvl_w[lev]), int(lvl_w[lev - 1])
        counts = np.zeros((D, npar), np.int64)
        for k in range(D):
            real = np.flatnonzero((depth_local == lev) & (node_dev == k))
            seg = np.sort(parent_pos[k, o : o + real.size] - op)
            if real.size:
                counts[k] = np.bincount(seg, minlength=npar)
        K = max(1, int(counts.max()))
        fold = np.full((D, npar, K), n, np.int64)
        for k in range(D):
            offs_ = np.concatenate([[0], np.cumsum(counts[k])])
            idx = offs_[:-1, None] + np.arange(K)[None, :]
            valid = np.arange(K)[None, :] < counts[k][:, None]
            fold[k] = np.where(valid, idx, n)
        level_folds.append(fold)

    W0 = int(lvl_w[0])
    root_T_idx = np.full((D, W0), Tn, np.int64)
    for k in range(D):
        roots_k = np.flatnonzero(is_chunk_root & (node_dev == k))
        roots_k = roots_k[np.argsort(pos_local[roots_k])]
        pp = parent[roots_k]
        root_T_idx[k, pos_local[roots_k]] = np.where(pp >= 0, tidx[np.where(pp >= 0, pp, 0)], Tn)

    def seg_plan(edge_ids: np.ndarray, targets: np.ndarray, width: int):
        """Per-shard (sel into local edges, gather-fold idx, mask) stacks:
        each target pulls its contributions; pad slots point past the
        valid stream."""
        sels, segs = [], []
        for k in range(D):
            mine = edge_dev[edge_ids] == k
            eid = edge_ids[mine]
            tgt = targets[mine]
            order = np.argsort(tgt, kind="stable")
            sels.append(local_edge_of[eid][order])
            segs.append(tgt[order])
        S = max((len(s) for s in sels), default=0)
        S = max(S, 1)
        sel = np.zeros((D, S), np.int64)
        mask = np.zeros((D, S))
        if width == 0:
            return sel, np.zeros((D, 0, 1), np.int64), mask
        counts = np.zeros((D, width), np.int64)
        for k in range(D):
            n = len(sels[k])
            sel[k, :n] = sels[k]
            mask[k, :n] = 1.0
            if n:
                counts[k] = np.bincount(segs[k], minlength=width)
        K = max(1, int(counts.max()))
        fold = np.full((D, width, K), S, np.int64)
        for k in range(D):
            offs_ = np.concatenate([[0], np.cumsum(counts[k])])
            idx = offs_[:-1, None] + np.arange(K)[None, :]
            valid = np.arange(K)[None, :] < counts[k][:, None]
            fold[k] = np.where(valid, idx, S)
        return sel, fold, mask

    t_edges = np.flatnonzero(t_bif >= 0)
    t_local = t_edges[~inT[t_bif[t_edges]]]
    t_inT = t_edges[inT[t_bif[t_edges]]]
    t_sel, t_fold, t_mask = seg_plan(t_local, pos_local[t_bif[t_local]], B_loc)
    tT_sel, tT_fold, tT_mask = seg_plan(t_inT, tidx[t_bif[t_inT]], Tn)
    s_edges = np.flatnonzero(s_bif >= 0)
    s_local = s_edges[~inT[s_bif[s_edges]]]
    s_inT = s_edges[inT[s_bif[s_edges]]]
    s_sel, s_fold, s_mask = seg_plan(s_local, pos_local[s_bif[s_local]], B_loc)
    sT_sel, sT_fold, sT_mask = seg_plan(s_inT, tidx[s_bif[s_inT]], Tn)
    pair_edges = np.flatnonzero(both)
    pc = child_bif[pair_edges]
    pw_local = pair_edges[~inT[pc]]
    pw_T = pair_edges[inT[pc]]
    w_sel, w_fold, w_mask = seg_plan(pw_local, pos_local[child_bif[pw_local]], B_loc)
    wT_sel, wT_fold, wT_mask = seg_plan(pw_T, tidx[child_bif[pw_T]], Tn)

    def remap(bifs: np.ndarray) -> np.ndarray:
        out = np.full(E + 1, -1, np.int64)  # +1: the inert pad edge
        valid = bifs >= 0
        vb = bifs[valid]
        out[:E][valid] = np.where(inT[vb], B_loc + tidx[vb], pos_local[vb])
        return out

    rs = remap(s_bif)
    rt = remap(t_bif)
    e_start_loc = rs[edge_perm]
    e_end_loc = rt[edge_perm]

    lam_src = np.empty(B, np.int64)
    lam_src[sel_nodes] = node_dev[sel_nodes] * B_loc + pos_local[sel_nodes]
    lam_src[inT] = D * B_loc + tidx[inT]

    return DistTreePlan(
        D=D, B=B, B_loc=B_loc, Tn=Tn, level_offsets=level_offsets, edge_perm=edge_perm,
        e_start_loc=e_start_loc, e_end_loc=e_end_loc,
        t_sel=t_sel, t_fold=t_fold, t_mask=t_mask,
        s_sel=s_sel, s_fold=s_fold, s_mask=s_mask,
        w_sel=w_sel, w_fold=w_fold, w_mask=w_mask,
        tT_sel=tT_sel, tT_fold=tT_fold, tT_mask=tT_mask,
        sT_sel=sT_sel, sT_fold=sT_fold, sT_mask=sT_mask,
        wT_sel=wT_sel, wT_fold=wT_fold, wT_mask=wT_mask,
        level_folds=tuple(level_folds), parent_pos=parent_pos, root_T_idx=root_T_idx,
        T_parent=T_parent, lam_src=lam_src, edge_inv=edge_inv,
    )


# plan fields with a leading shard axis (the reference ships them as sharded
# shard_map operands; here each shard's tables are built from its row)
ROW_FIELDS = (
    "t_sel", "t_fold", "t_mask", "s_sel", "s_fold", "s_mask",
    "w_sel", "w_fold", "w_mask", "tT_sel", "tT_fold", "tT_mask",
    "sT_sel", "sT_fold", "sT_mask", "wT_sel", "wT_fold", "wT_mask",
    "parent_pos", "root_T_idx",
)


def plan_rows(plan: DistTreePlan) -> dict:
    """The per-shard plan arrays (host), with the level folds as
    ``lvlfold_i``."""
    rows = {f: getattr(plan, f) for f in ROW_FIELDS}
    for i, fold in enumerate(plan.level_folds):
        rows[f"lvlfold_{i}"] = fold
    return rows


def shard_coefficients(a, mode: str, eids: np.ndarray, N: int):
    """A public-order coefficient's values on the edges ``eids`` (scalars
    pass through; per cell and per quadrature point keep their edge-major
    cell order)."""
    a = np.asarray(a)
    if mode == "scalar":
        return a
    if mode == "edge":
        return a[eids]
    if mode == "cell":
        return a.reshape(-1, N)[eids].reshape(-1)
    return a.reshape(-1, N, a.shape[-1])[eids].reshape(-1, a.shape[-1])


class _EdgeEnds(typing.NamedTuple):
    """The edge ends K8a copies into its edge data."""

    start_bif: torch.Tensor
    end_bif: torch.Tensor

    @property
    def num_edges(self) -> int:
        return int(self.start_bif.shape[0])


class ShardEdges:
    """A shard's real edges and what K8a reads for them on its device; the
    padding rows up to ``E_loc`` come from :func:`.sharding._pad_edge_data`."""

    def __init__(self, asm, eids, start_bif, end_bif, E_loc: int, device):
        mesh = asm.network
        self.eids = np.asarray(eids, np.int64)
        self.E_loc = int(E_loc)
        self.device = device

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

        self.ends = _EdgeEnds(i32(start_bif), i32(end_bif))
        self.h_e = torch.as_tensor(
            np.asarray(mesh.edge_length, dtype=np.float64)[self.eids] / mesh.N, device=device)
        self.quad_w = torch.as_tensor(np.asarray(asm._quad_weights, np.float64), device=device)
        self.quad_phi = torch.as_tensor(np.asarray(asm._quad_phi, np.float64), device=device)

    def args(self, N: int, R_data, f_data, start_pbc, end_pbc, R_mode: str, f_mode: str):
        """The shard's ``(R, f, start_pbc, end_pbc)`` on its device."""
        vals = (shard_coefficients(R_data, R_mode, self.eids, N),
                shard_coefficients(f_data, f_mode, self.eids, N),
                np.asarray(start_pbc)[self.eids], np.asarray(end_pbc)[self.eids])
        return tuple(torch.as_tensor(np.ascontiguousarray(v, dtype=np.float64), device=self.device)
                     for v in vals)

    def edge_data(self, N: int, k: int, args, modes, plain: bool):
        """K8a on the real edges, padded to ``E_loc`` inert rows."""
        from .sharding import _pad_edge_data

        R_mode, f_mode, f_zero = modes
        make = edge_data.edge_data_plain if plain else edge_data.edge_data
        R, f, sp, ep = args
        ed = make(self.ends, N, k, self.h_e, self.quad_w, self.quad_phi, R, f, R_mode, f_mode,
                  f_zero, sp, ep)
        return _pad_edge_data(ed, self.E_loc - self.eids.size, n_cells=N)


class _Fwd(typing.NamedTuple):
    """A device's shards after the forward stage: their K8a edge data (in
    the group's order) and K22c's stacked ``(S, ·)`` ``d``, ``r``, ``wn``
    and T partials."""

    eds: list
    d: torch.Tensor
    r: torch.Tensor
    wn: torch.Tensor
    part: torch.Tensor


class DistTreeExecutor:
    """The distributed tree elimination on a :class:`..parallel.mesh.ShardMesh`:
    per owned shard its edges (:class:`ShardEdges`, the plan's remapped
    ends); per distinct device of the owned shards a group, its shards' K22c
    tables stacked (:class:`..kernels.dist_tree.DistShardTables`), and the T
    forest.  A solve is per group K8a a shard, then K22c's folds of all the
    group's shards in one launch and their level walks in another; across
    the shards K22-reduce and the T solve (once per device); per group
    again K22c's back walks in one launch, then K8b a shard.  So K22c makes
    3 launches a device whatever its number of shards (24 → 3 for 8 shards
    on one card).  Calling it returns per owned shard ``q_T (k·N+1,
    E_loc)``, ``p_T (N, E_loc)``, ``λ_loc (B_loc,)``, and ``λ_T (Tn,)`` and
    the finiteness flag."""

    method_name = "schur_sharded_dist"

    def __init__(self, asm, plan: DistTreePlan, mesh, modes: tuple):
        self.plan = plan
        self.mesh = mesh
        self._N = asm.network.N
        self._k = asm.flux_degree
        self._modes = modes
        E = asm.network.num_edges
        self.t_forest = {dev: shard_top.t_forest(plan.T_parent, dev) for dev in mesh.local_devices}
        self.shards = []
        for d in mesh.owned:
            dev = mesh.devices[d]
            perm = plan.edge_perm[d]
            n_real = int(np.count_nonzero(perm < E))
            self.shards.append(dict(
                device=dev,
                edges=ShardEdges(asm, perm[:n_real], plan.e_start_loc[d][:n_real],
                                 plan.e_end_loc[d][:n_real], perm.size, dev),
            ))
        owned = list(mesh.owned)
        self.groups = []
        for dev in mesh.local_devices:
            members = tuple(i for i, sh in enumerate(self.shards) if sh["device"] == dev)
            self.groups.append(dict(device=dev, members=members, tables=dist_tree.dist_shard_tables(
                plan, [owned[i] for i in members], dev)))

    def prepare_args(self, R_data, f_data, start_pbc, end_pbc):
        R_mode, f_mode, _ = self._modes
        return [sh["edges"].args(self._N, R_data, f_data, start_pbc, end_pbc, R_mode, f_mode)
                for sh in self.shards]

    def forward(self, g: int, shard_args, plain: bool = False) -> _Fwd:
        """Group ``g``'s shards up to their rows of the reduce: K8a a shard,
        then K22c's folds and walks of them all (``shard_args`` every owned
        shard's, :meth:`prepare_args`)."""
        grp = self.groups[g]
        eds = [self.shards[i]["edges"].edge_data(self._N, self._k, shard_args[i], self._modes, plain)
               for i in grp["members"]]
        run_folds = dist_tree.folds_plain if plain else dist_tree.folds
        run_forward = dist_tree.forward_plain if plain else dist_tree.forward
        d_, r_, wn, part = run_folds(grp["tables"], eds)
        run_forward(grp["tables"], d_, r_, wn, part)
        return _Fwd(eds, d_, r_, wn, part)

    def top(self, parts, plain: bool = False) -> dict:
        """K22-reduce of the owned shards' T partials (in owned order) and the
        T solve: ``{device: λ_T}``."""
        Tn = self.plan.Tn
        total = self.mesh.reduce(self.mesh.stack(parts), plain=plain)
        solve = shard_top.t_solve_plain if plain else shard_top.t_solve

        def run(tot):
            return solve(self.t_forest[tot.device], tot[:Tn], tot[Tn : 2 * Tn],
                         tot[2 * Tn : 3 * Tn])[0]

        return self.mesh.replicate(run, total)

    def back(self, g: int, fw: _Fwd, lam_T, plain: bool = False) -> list:
        """Group ``g``'s K22c back walks and K8b a shard: ``(q_T, p_T, λ_loc,
        finite)`` of each of its shards, in the group's order."""
        grp = self.groups[g]
        run_back = dist_tree.back_plain if plain else dist_tree.back
        expand_lam = backsub.backsub_plain if plain else backsub.backsub
        lam = run_back(grp["tables"], fw.d, fw.r, fw.wn, lam_T)
        outs = []
        for j, ed in enumerate(fw.eds):
            q_T, p_T, finite = expand_lam(ed, lam[j], self._N, self._k)
            outs.append((q_T, p_T, lam[j, : self.plan.B_loc], finite))
        return outs

    def __call__(self, shard_args, plain: bool = False):
        refuse_grad(type(self).__name__, *(t for args in shard_args for t in args))
        fws = [self.forward(g, shard_args, plain) for g in range(len(self.groups))]
        parts = [None] * len(self.shards)
        for grp, fw in zip(self.groups, fws):
            for j, i in enumerate(grp["members"]):
                parts[i] = fw.part[j]
        top = self.top(parts, plain)
        outs = [None] * len(self.shards)
        for g, (grp, fw) in enumerate(zip(self.groups, fws)):
            for i, out in zip(grp["members"], self.back(g, fw, top[grp["device"]], plain)):
                outs[i] = out
        finite = self.mesh.all_finite([o[3] for o in outs], plain)
        return ([o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs],
                top[self.mesh.home], finite)

    def plain(self, shard_args):
        return self(shard_args, plain=True)
