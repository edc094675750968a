"""Sharded blocked-sibling elimination: the blocked forest solve over D shards.

Counterpart of ``networks_fenicsx_tpu/parallel/blocked_sharded.py``:
``ShardedBlockedPlan`` and ``plan_sharded_blocked`` (``:60-238``, on the
port's ``_plan_blocked``, ``_blocked_csr`` and ``_blocked_walk``), the
executor (``:241-301``) and the per-shard body (``_make_local_body``,
``:304-417``).

The uniformly-K-ary forest is cut at the shallowest level whose width is a
multiple of D; each shard owns ``c = m_t / D`` complete subtrees, all of
one level structure, plus a share of the edges of the top forest T above
the cut.  Per device, K1 on all its shards' E_loc rows in one launch; per
shard, on its device, the K2–K3 forward of its subtrees down to their
chunk roots; per device, K22a's T partials of all its shards in one
launch; across the shards, K22-reduce
and the T solve (once per distinct device); per device again, K22a's λ of
all its shards in one launch; per shard, the K4 back-substitution and K5.
The host maps the shards' rows back to the public layout.

``sharded_blocked_sweep`` (batched scenarios) is ROADMAP A9.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from ..adjoint import refuse_grad
from ..blocked import _BlockedPlan, _blocked_csr, _blocked_walk, _plan_blocked, device_plan, ends_plan
from ..kernels import condense, expand, shard_blocked, shard_top, tree_sweep

__all__ = ["ShardedBlockedPlan", "plan_sharded_blocked", "build_sharded_blocked_executor",
           "ShardedBlockedExecutor", "sharded_blocked_sweep"]


class ShardedBlockedPlan(typing.NamedTuple):
    """Host-static plan for the sharded blocked elimination (the reference's
    fields: arrays with a leading ``D`` axis are per shard)."""

    D: int
    Tn: int  # top-forest size (0 when the root level already divides D)
    E_loc: int  # per-shard edge rows (local subtree + T share + pad)
    E_sub: int  # local subtree edges (occupy rows [0, E_sub))
    B_sub: int  # local bifurcations per shard
    c: int  # chunk roots per shard
    local_plan: _BlockedPlan  # identical level structure on every shard
    edge_rows: np.ndarray  # (D, E_loc) public edge id, -1 for pad
    h: np.ndarray  # (D, E_loc) edge lengths (pad: 1.0)
    s_is_bif: np.ndarray  # (D, E_loc)
    t_is_bif: np.ndarray  # (D, E_loc)
    tT_idx: np.ndarray  # (D, E_loc) target's T position (Tn if none)
    sT_idx: np.ndarray  # (D, E_loc) source's T position (Tn if none)
    pT_idx: np.ndarray  # (D, E_loc) T-pair child position for w_T (Tn if none)
    root_T: np.ndarray  # (D, c) parent T position of each chunk root (Tn if none)
    T_parent: np.ndarray  # (Tn,) parent T position, -1 for T roots
    lam_src: np.ndarray  # (B,) index into [flat local (D*B_sub) | T (Tn)]
    edge_flat: np.ndarray  # (E,) row of public edge e in the (D*E_loc) layout


def plan_sharded_blocked(asm, D: int, max_T: int = 4096) -> ShardedBlockedPlan | None:
    """Build the plan, or None when the topology and D do not admit
    identically-shaped per-shard subforests."""
    gp = _plan_blocked(asm)
    if gp is None:
        return None
    csr = _blocked_csr(asm)
    in_edge, out_data, out_offs, out_counts = csr
    src_bif = np.asarray(asm._edge_start_bif)
    tgt_bif = np.asarray(asm._edge_end_bif)
    E = src_bif.shape[0]
    B = asm.network.num_multipliers
    offs = gp.bif_offsets

    # cut level: shallowest level whose width is a positive multiple of D
    widths = [lv.m for lv in gp.levels]
    t = next((i for i, m in enumerate(widths) if m >= D and m % D == 0), None)
    if t is None:
        return None
    Tn = int(offs[t])
    if Tn > max_T:
        return None
    c = widths[t] // D

    # T numbering follows the global blocked bifurcation order
    T_ids = gp.bif_order[:Tn]
    tidx = np.full(B, Tn, np.int64)
    tidx[T_ids] = np.arange(Tn)
    inT = np.zeros(B, dtype=bool)
    inT[T_ids] = True
    T_parent = np.full(Tn, -1, np.int64)
    if Tn:
        par = src_bif[in_edge[T_ids]]
        has = par >= 0
        T_parent[has] = tidx[par[has]]

    # per-shard walks from the chunk-root slices of the global level-t order
    level_t_bifs = gp.bif_order[offs[t] : offs[t + 1]]
    local_plan = None
    bif_rows = []
    edge_rows_sub = []
    for d in range(D):
        roots_d = level_t_bifs[d * c : (d + 1) * c]
        walk = _blocked_walk(roots_d, in_edge, out_data, out_offs, out_counts, tgt_bif)
        if walk is None:
            return None
        bif_order_d, edge_order_d, levels_d, offsets_d = walk
        if local_plan is None:
            local_plan = _BlockedPlan(
                bif_order=bif_order_d,
                edge_order=edge_order_d,
                n_roots=int(c),
                levels=levels_d,
                bif_offsets=offsets_d,
                s_is_bif=src_bif[edge_order_d] >= 0,
                t_is_bif=tgt_bif[edge_order_d] >= 0,
            )
        elif levels_d != local_plan.levels:
            return None  # shape mismatch across shards
        bif_rows.append(bif_order_d)
        edge_rows_sub.append(edge_order_d)
    B_sub = int(bif_rows[0].size)
    E_sub = int(edge_rows_sub[0].size)

    # T edges: owner bifurcation (child side; source for boundary out-edges)
    owner = np.where(tgt_bif >= 0, tgt_bif, src_bif)
    if np.any(owner < 0):
        return None  # boundary-boundary edge
    T_edges = np.flatnonzero(inT[owner])
    n_T = int(T_edges.size)
    T_loc = -(-n_T // D) if Tn else 0
    E_loc = E_sub + T_loc

    edge_rows = np.full((D, E_loc), -1, np.int64)
    for d in range(D):
        edge_rows[d, :E_sub] = edge_rows_sub[d]
        mine = T_edges[d::D]
        edge_rows[d, E_sub : E_sub + mine.size] = mine
    flat = edge_rows[edge_rows >= 0]
    if flat.size != E or np.unique(flat).size != E:
        return None

    h = np.ones((D, E_loc))
    s_b = np.zeros((D, E_loc), dtype=bool)
    t_b = np.zeros((D, E_loc), dtype=bool)
    tT = np.full((D, E_loc), Tn, np.int64)
    sT = np.full((D, E_loc), Tn, np.int64)
    pT = np.full((D, E_loc), Tn, np.int64)
    lengths = np.asarray(asm.network.edge_length)
    for d in range(D):
        rows = edge_rows[d]
        valid = rows >= 0
        rv = rows[valid]
        h[d, valid] = lengths[rv]
        s_b[d, valid] = src_bif[rv] >= 0
        t_b[d, valid] = tgt_bif[rv] >= 0
        tT[d, valid] = np.where(tgt_bif[rv] >= 0, tidx[np.maximum(tgt_bif[rv], 0)], Tn)
        sT[d, valid] = np.where(src_bif[rv] >= 0, tidx[np.maximum(src_bif[rv], 0)], Tn)
        both_T = (tT[d] < Tn) & (sT[d] < Tn)
        pT[d] = np.where(both_T, tT[d], Tn)

    root_T = np.full((D, c), Tn, np.int64)
    if Tn:
        for d in range(D):
            roots_d = level_t_bifs[d * c : (d + 1) * c]
            par = src_bif[in_edge[roots_d]]
            root_T[d] = np.where(par >= 0, tidx[np.maximum(par, 0)], Tn)

    lam_src = np.empty(B, np.int64)
    for d in range(D):
        lam_src[bif_rows[d]] = d * B_sub + np.arange(B_sub)
    lam_src[T_ids] = D * B_sub + np.arange(Tn)
    edge_flat = np.empty(E, np.int64)
    for d in range(D):
        rows = edge_rows[d]
        valid = rows >= 0
        edge_flat[rows[valid]] = d * E_loc + np.flatnonzero(valid)

    return ShardedBlockedPlan(
        D=D, Tn=Tn, E_loc=E_loc, E_sub=E_sub, B_sub=B_sub, c=int(c), local_plan=local_plan,
        edge_rows=edge_rows, h=h, s_is_bif=s_b, t_is_bif=t_b,
        tT_idx=tT.astype(np.int32), sT_idx=sT.astype(np.int32), pT_idx=pT.astype(np.int32),
        root_T=root_T.astype(np.int32), T_parent=T_parent, lam_src=lam_src,
        edge_flat=edge_flat,
    )


def shard_rows(plan, N: int, R_data, f_data, start_pbc, end_pbc, R_mode: str, f_mode: str):
    """The public-order coefficient arrays in the plans' per-shard row layout
    (``edge_rows``; pad rows R = 1, f = 0, zero boundary pressures): per
    shard ``(R, f, start_pbc, end_pbc)``, per-cell data j-major ``(N, E_loc)``,
    scalars broadcast per row (reference ``prepare_args``, ``:270-298``)."""
    rows = plan.edge_rows.reshape(-1)
    valid = rows >= 0
    rv = np.maximum(rows, 0)

    def per_edge(a, mode, pad):
        a = np.asarray(a)
        if mode == "scalar":
            a = np.broadcast_to(a.reshape(-1)[:1], (rows.size,))
            return np.where(valid, a, pad)
        if mode == "cell":
            cells = a.reshape(-1, N)[rv].T  # (N, rows)
            return np.where(valid[None, :], cells, pad)
        return np.where(valid, a[rv], pad)

    full = (per_edge(R_data, R_mode, 1.0), per_edge(f_data, f_mode, 0.0),
            per_edge(start_pbc, "edge", 0.0), per_edge(end_pbc, "edge", 0.0))
    E_loc = plan.E_loc
    return [tuple(np.ascontiguousarray(a[..., d * E_loc : (d + 1) * E_loc], dtype=np.float64)
                  for a in full) for d in range(plan.D)]


def row_mode(mode: str) -> str:
    """The kernels' mode of a row-laid coefficient: per cell stays, the rest
    is per row."""
    return "cell" if mode == "cell" else "edge"


class _Fwd(typing.NamedTuple):
    """A shard's state between its forward half and its back half."""

    R: torch.Tensor
    f: torch.Tensor
    sp: torch.Tensor
    ep: torch.Tensor
    W: torch.Tensor
    w: torch.Tensor
    g: torch.Tensor
    Ftot: torch.Tensor
    const: torch.Tensor
    d: torch.Tensor
    r: torch.Tensor
    wn: torch.Tensor
    rhs_sq: torch.Tensor


class ShardedBlockedExecutor:
    """The sharded blocked solve on a :class:`..parallel.mesh.ShardMesh`.

    Holds, per owned shard, its row tables on its device: the cell widths,
    K22a's fold tables and the row ends for K1 and K5 (its subtree's
    bifurcations, then T behind them); per distinct device, the local
    plan's tables for K2–K4, the T forest and a group: its shards (in
    owned order), their K1 batch (:class:`..kernels.condense.Batch`) and
    their K22a tables stacked
    (:class:`..kernels.shard_blocked.ShardBatchTables`), so K1 makes 1
    launch and K22a 2 a device a solve whatever its number of shards.
    ``prepare_args`` lays the coefficients out per shard on the host;
    calling the executor runs the solve (``plain=True``: the kernels' plain
    versions) and returns per owned shard ``q_T (k·N+1, E_loc)``, ``p_T (N,
    E_loc)``, ``λ_loc (B_sub,)``, and ``λ_T (Tn,)``, ``‖rhs‖`` and the
    finiteness flag."""

    method_name = "schur_sharded_blocked"

    def __init__(self, asm, plan: ShardedBlockedPlan, mesh, R_mode: str, f_mode: str):
        self.plan = plan
        self.mesh = mesh
        self._N = asm.network.N
        self._k = asm.flux_degree
        self._R_mode, self._f_mode = R_mode, f_mode
        self._modes = (row_mode(R_mode), row_mode(f_mode))
        Tn, B_sub, c, E_sub = plan.Tn, plan.B_sub, plan.c, plan.E_sub
        host = _flat_local(plan.local_plan)
        self.local = {dev: device_plan(plan.local_plan, dev) for dev in mesh.local_devices}
        self.t_forest = {dev: shard_top.t_forest(plan.T_parent, dev) for dev in mesh.local_devices}
        self.shards = []
        for d in mesh.owned:
            dev = mesh.devices[d]
            src = np.full(plan.E_loc, -1, np.int64)
            tgt = np.full(plan.E_loc, -1, np.int64)
            src[:E_sub], tgt[:E_sub] = host
            root_T = plan.root_T[d].astype(np.int64)
            src[:c] = np.where(root_T < Tn, B_sub + root_T, -1)  # the chunk roots' in-edges
            for ends, T_idx in ((src, plan.sT_idx[d]), (tgt, plan.tT_idx[d])):
                tail = T_idx[E_sub:].astype(np.int64)
                ends[E_sub:] = np.where(tail < Tn, B_sub + tail, -1)
            self.shards.append(dict(
                device=dev,
                h_e=torch.as_tensor(plan.h[d] / self._N, device=dev),
                ends=ends_plan(src, tgt, B_sub + Tn, dev),
                tables=shard_blocked.shard_tables(plan.tT_idx[d], plan.sT_idx[d],
                                                  plan.pT_idx[d], plan.root_T[d], Tn, B_sub, dev),
            ))
        self.groups = []
        for dev in mesh.local_devices:
            members = tuple(i for i, sh in enumerate(self.shards) if sh["device"] == dev)
            self.groups.append(dict(
                device=dev, members=members,
                k1=condense.Batch([self.shards[i]["ends"] for i in members], self._N, self._k,
                                  *self._modes),
                tables=shard_blocked.batch_tables([self.shards[i]["tables"] for i in members])))

    def prepare_args(self, R_data, f_data, start_pbc, end_pbc):
        """Per owned shard, its ``(R, f, start_pbc, end_pbc)`` rows on its device."""
        rows = shard_rows(self.plan, self._N, R_data, f_data, start_pbc, end_pbc,
                          self._R_mode, self._f_mode)
        return [tuple(torch.as_tensor(a, device=sh["device"]) for a in rows[d])
                for d, sh in zip(self.mesh.owned, self.shards)]

    # -- the stages, also what the kernel checks replay
    def condense(self, g: int, shard_args, plain: bool = False) -> torch.Tensor:
        """K1 of group ``g``'s shards (``shard_args`` every owned shard's
        :meth:`prepare_args` row), one launch: the ``(5, S, E_loc)`` planes
        ``W, w, g, Ftot, const``."""
        grp = self.groups[g]
        run = condense.condense_batch_plain if plain else condense.condense_batch
        return run(grp["k1"], [(self.shards[i]["h_e"], *shard_args[i]) for i in grp["members"]])

    def forward(self, i: int, R, f, sp, ep, plain: bool = False, k1=None) -> _Fwd:
        """Shard ``i`` (of the owned ones) down to its chunk roots: K2–K3
        on its K1 outputs ``k1`` (``W, w, g, Ftot, const``: its column of
        :meth:`condense`), or on its own K1 launch without them."""
        sh = self.shards[i]
        run_forward = tree_sweep.tree_sweep_forward_plain if plain else tree_sweep.tree_sweep_forward
        ends, lp = sh["ends"], self.local[sh["device"]]
        if k1 is None:
            run_condense = condense.condense_plain if plain else condense.condense
            k1 = run_condense(ends.plan if plain else ends, self._N, self._k, sh["h_e"], R, f,
                              *self._modes, sp, ep)
        W, w, g, Ftot, const = k1
        d_, r_, wn, rhs_sq = run_forward(lp.plan if plain else lp, w, const, Ftot)
        return _Fwd(R, f, sp, ep, W, w, g, Ftot, const, d_, r_, wn, rhs_sq)

    def partials(self, g: int, fws, plain: bool = False) -> torch.Tensor:
        """K22a's partials of group ``g``'s shards (``fws`` every owned
        shard's :meth:`forward`), one launch: their ``(S, 3·Tn + 1)`` rows."""
        grp = self.groups[g]
        run = shard_blocked.partials_batch_plain if plain else shard_blocked.partials_batch
        return run(grp["tables"], [(fws[i].w, fws[i].const, fws[i].Ftot, fws[i].d, fws[i].r,
                                    fws[i].wn, fws[i].rhs_sq) for i in grp["members"]])

    def top(self, rows, plain: bool = False) -> dict:
        """K22-reduce of the groups' rows (:meth:`partials`, one tensor a
        group) and the T solve, once per device: ``{device: (λ_T, ‖rhs‖)}``.
        One group's rows are the reduce's input as they are; shards on
        several devices or processes go through :meth:`ShardMesh.stack`."""
        Tn = self.plan.Tn
        if len(self.groups) == 1 and not self.mesh.distributed:
            stacked = rows[0]
        else:
            parts = [None] * len(self.shards)
            for grp, part in zip(self.groups, rows):
                for j, i in enumerate(grp["members"]):
                    parts[i] = part[j]
            stacked = self.mesh.stack(parts)
        total = self.mesh.reduce(stacked, plain=plain)
        solve = shard_top.t_solve_plain if plain else shard_top.t_solve

        def run(tot):
            tf = self.t_forest[tot.device]
            return solve(tf, tot[:Tn], tot[Tn : 2 * Tn], tot[2 * Tn : 3 * Tn], tot[3 * Tn])

        return self.mesh.replicate(run, total)

    def lam(self, g: int, fws, lam_T, plain: bool = False) -> torch.Tensor:
        """K22a's λ of group ``g``'s shards, one launch: ``(S, B_sub + Tn)``,
        a row ``[λ0 | 0 … | λ_T]`` a shard."""
        grp = self.groups[g]
        run = shard_blocked.lam_batch_plain if plain else shard_blocked.lam_batch
        return run(grp["tables"], [(fws[i].d, fws[i].r, fws[i].wn) for i in grp["members"]], lam_T)

    def back(self, i: int, fw: _Fwd, lam, plain: bool = False):
        """Shard ``i``'s K4 from level 0 (in place on its :meth:`lam` row)
        and K5: ``(q_T, p_T, λ_loc, finite)``."""
        sh = self.shards[i]
        run_back = tree_sweep.tree_sweep_backward_plain if plain else tree_sweep.tree_sweep_backward
        run_expand = expand.expand_plain if plain else expand.expand
        ends, lp = sh["ends"], self.local[sh["device"]]
        lam = run_back(lp.plan if plain else lp, fw.d, fw.r, fw.wn, lam)
        Rm, fm = self._modes
        q_T, p_T, finite = run_expand(ends.plan if plain else ends, self._N, self._k, lam,
                                      fw.sp, fw.ep, fw.W, fw.w, fw.g, fw.Ftot, sh["h_e"], fw.R,
                                      fw.f, Rm, fm)
        return q_T, p_T, lam[: self.plan.B_sub], finite

    def __call__(self, shard_args, plain: bool = False):
        refuse_grad(type(self).__name__, *(t for args in shard_args for t in args))
        fws = [None] * len(self.shards)
        for g, grp in enumerate(self.groups):
            k1 = self.condense(g, shard_args, plain)
            for j, i in enumerate(grp["members"]):
                fws[i] = self.forward(i, *shard_args[i], plain=plain, k1=k1[:, j].unbind(0))
        top = self.top([self.partials(g, fws, plain) for g in range(len(self.groups))], plain)
        outs = [None] * len(self.shards)
        for g, grp in enumerate(self.groups):
            lam = self.lam(g, fws, top[grp["device"]][0], plain)
            for j, i in enumerate(grp["members"]):
                outs[i] = self.back(i, fws[i], lam[j], plain)
        lam_T, rhs_norm = top[self.mesh.home]
        finite = self.mesh.all_finite([o[3] for o in outs], plain)
        return ([o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs], lam_T,
                rhs_norm, finite)

    def plain(self, shard_args):
        return self(shard_args, plain=True)


def _flat_local(lp: _BlockedPlan):
    """``(edge_src, edge_tgt)`` of the local plan's rows (its bifurcations)."""
    from ..blocked import flatten_plan

    host = flatten_plan(lp)
    return host["edge_src"], host["edge_tgt"]


def build_sharded_blocked_executor(asm, plan: ShardedBlockedPlan, mesh, modes: tuple | None = None
                                   ) -> ShardedBlockedExecutor:
    """The executor for a prepared plan; ``modes`` overrides the live
    ``asm.coefficient_modes()`` (an assemble-time snapshot's kinds)."""
    R_mode, f_mode, _ = modes if modes is not None else asm.coefficient_modes()
    if R_mode not in ("scalar", "edge", "cell") or f_mode not in ("scalar", "edge", "cell"):
        raise ValueError("sharded blocked executor requires per-edge or per-cell coefficients")
    return ShardedBlockedExecutor(asm, plan, mesh, R_mode, f_mode)


def sharded_blocked_sweep(*args, **kwargs):
    """Batched resistance scenarios through the sharded blocked solve — not ported."""
    raise NotImplementedError("ROADMAP A9: sharded_blocked_sweep is not ported yet")
