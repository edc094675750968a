"""Sharded lattice executor: the grid route over D horizontal strips.

Counterpart of ``networks_fenicsx_tpu/parallel/grid_sharded.py``:
``ShardedGridPlan`` and ``plan_sharded_grid`` (``:63-184``, on the port's
``_plan_shift_matvec``, ``_plan_dct_lattice`` and ``_plan_grid_layout``),
the executor (``:186-245``) and the per-strip body
(``_make_grid_local_body``, ``:247-391``).

Each shard owns a strip of ``h = ⌈ny / D⌉`` λ rows and every edge incident
from it (its x-edges, the y-edges sourced in it, its boundary stubs).  Per
device, for all its strips at once: K1 on their E_loc slots (one launch)
and K22b's windows (one launch, the rows written straight into the
reduce's input); across the strips, K22-reduce places the windows at their
row offsets (the ghost update) and sums the stub groups, then, once per
distinct device, K22b's fill and the exact DCT capacitance solve (K16)
with K17's stencil as its matvec and residual; per strip again, K5 reads
the strip's λ ends by index into the replicated λ.

``sharded_grid_sweep`` (batched scenarios) is ROADMAP A9.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from ..adjoint import refuse_grad
from ..blocked import ends_plan
from ..kernels import condense, dct_lattice, expand, grid_core, shard_grid
from ..lattice import (
    _DctPlan,
    _plan_dct_lattice,
    _plan_grid_layout,
    _plan_shift_matvec,
    device_grid_plan,
)
from .blocked_sharded import row_mode, shard_rows

__all__ = ["ShardedGridPlan", "plan_sharded_grid", "build_sharded_grid_executor",
           "ShardedGridExecutor", "sharded_grid_sweep"]


class ShardedGridPlan(typing.NamedTuple):
    """Host-static plan for the strip-sharded lattice solve (the reference's
    fields).  Per-shard slot layout: ``[x-edges (h, nx-1) | y-edges (h, nx) |
    stubs (st_cap)]``, row ``i`` being λ row ``d·h + i``; invalid slots are
    inert."""

    D: int
    nx: int
    ny: int
    h: int  # λ rows per strip (⌈ny / D⌉)
    st_cap: int  # stub slots per shard
    E_loc: int  # h*(nx-1) + h*nx + st_cap
    dct: _DctPlan
    edge_rows: np.ndarray  # (D, E_loc) public edge id, -1 pad
    h_e: np.ndarray  # (D, E_loc) cell lengths L/N (pad 1.0)
    valid: np.ndarray  # (D, E_loc)
    s_is_bif: np.ndarray  # (D, E_loc)
    t_is_bif: np.ndarray  # (D, E_loc)
    stub_rel: np.ndarray  # (D, st_cap) flat index into the (h+1, nx) window
    stub_grp: np.ndarray  # (D, st_cap) index into dct.stub_rows (0 pad)
    stub_s_bif: np.ndarray  # (D, st_cap)
    stub_valid: np.ndarray  # (D, st_cap)
    edge_flat: np.ndarray  # (E,) public edge -> row in the (D·E_loc) output
    lam_src: np.ndarray  # (B,) identity (λ comes back in node order)


def plan_sharded_grid(asm, D: int, modes: tuple | None = None) -> ShardedGridPlan | None:
    """Strip partition of a uniform lattice, or None outside the envelope
    (scalar R, the DCT plan and the grid layout)."""
    R_mode, _f_mode, _ = modes if modes is not None else asm.coefficient_modes()
    if R_mode != "scalar":
        return None
    shift_plan = _plan_shift_matvec(asm)
    if shift_plan is None:
        return None
    dct = _plan_dct_lattice(asm, shift_plan)
    if dct is None:
        return None
    gp = _plan_grid_layout(asm, dct)
    if gp is None:
        return None
    nx, ny = gp.nx, gp.ny
    mesh = asm.network
    E = mesh.num_edges
    h = -(-ny // D)  # ceil
    Ex_loc, Ey_loc = h * (nx - 1), h * nx
    stub_pub = gp.edge_order[gp.Ex + gp.Ey :]
    stub_row = gp.stub_rows_e
    stub_dev = stub_row // nx // h  # strip owning the stub's λ row
    st_cap = int(np.max(np.bincount(stub_dev, minlength=D))) if stub_pub.size else 0
    E_loc = Ex_loc + Ey_loc + st_cap

    edge_rows = np.full((D, E_loc), -1, dtype=np.int64)
    h_e = np.ones((D, E_loc))
    valid = np.zeros((D, E_loc), dtype=bool)
    s_b = np.zeros((D, E_loc), dtype=bool)
    t_b = np.zeros((D, E_loc), dtype=bool)
    stub_rel = np.zeros((D, st_cap), dtype=np.int64)
    stub_grp = np.zeros((D, st_cap), dtype=np.int64)
    stub_sb = np.zeros((D, st_cap), dtype=bool)
    stub_val = np.zeros((D, st_cap), dtype=bool)

    h_cells = np.asarray(mesh.edge_length) / mesh.N
    x_pub = gp.edge_order[: gp.Ex].reshape(ny, nx - 1)
    y_pub = gp.edge_order[gp.Ex : gp.Ex + gp.Ey].reshape(ny - 1, nx)
    for d in range(D):
        y0 = d * h
        rows_x = min(max(ny - y0, 0), h)
        if rows_x > 0:
            sl = slice(0, rows_x * (nx - 1))
            ids = x_pub[y0 : y0 + rows_x].reshape(-1)
            edge_rows[d, sl] = ids
            h_e[d, sl] = h_cells[ids]
            valid[d, sl] = True
            s_b[d, sl] = True
            t_b[d, sl] = True
        rows_y = min(max(ny - 1 - y0, 0), h)
        if rows_y > 0:
            sl = slice(Ex_loc, Ex_loc + rows_y * nx)
            ids = y_pub[y0 : y0 + rows_y].reshape(-1)
            edge_rows[d, sl] = ids
            h_e[d, sl] = h_cells[ids]
            valid[d, sl] = True
            s_b[d, sl] = True
            t_b[d, sl] = True
        mine = np.nonzero(stub_dev == d)[0]
        for j, t in enumerate(mine):
            slot = Ex_loc + Ey_loc + j
            pub = int(stub_pub[t])
            edge_rows[d, slot] = pub
            h_e[d, slot] = h_cells[pub]
            valid[d, slot] = True
            s_b[d, slot] = bool(gp.stub_s_bif[t])
            t_b[d, slot] = not gp.stub_s_bif[t]
            stub_rel[d, j] = int(stub_row[t]) - y0 * nx
            stub_grp[d, j] = int(gp.stub_group[t])
            stub_sb[d, j] = bool(gp.stub_s_bif[t])
            stub_val[d, j] = True

    edge_flat = np.empty(E, dtype=np.int64)
    rows_all = edge_rows.reshape(-1)
    pos = np.nonzero(rows_all >= 0)[0]
    edge_flat[rows_all[pos]] = pos
    B = mesh.num_multipliers
    return ShardedGridPlan(
        D=D, nx=nx, ny=ny, h=h, st_cap=st_cap, E_loc=E_loc, dct=dct,
        edge_rows=edge_rows, h_e=h_e, valid=valid, s_is_bif=s_b,
        t_is_bif=t_b, stub_rel=stub_rel, stub_grp=stub_grp,
        stub_s_bif=stub_sb, stub_valid=stub_val, edge_flat=edge_flat,
        lam_src=np.arange(B, dtype=np.int64),
    )


def strip_ends(plan: ShardedGridPlan, d: int):
    """Strip ``d``'s slot ends as indices into the lattice's λ (node order):
    the λ window and the λ → edge parts of the reference (``:348-360``)."""
    nx, ny, h = plan.nx, plan.ny, plan.h
    Ex_loc, Ey_loc = h * (nx - 1), h * nx
    src = np.full(plan.E_loc, -1, np.int64)
    tgt = np.full(plan.E_loc, -1, np.int64)
    y = d * h + np.arange(h)
    xs = (y[:, None] * nx + np.arange(nx - 1)[None, :]).reshape(-1)
    ys = (y[:, None] * nx + np.arange(nx)[None, :]).reshape(-1)
    ok = plan.valid[d]
    src[:Ex_loc] = np.where(ok[:Ex_loc], xs, -1)
    tgt[:Ex_loc] = np.where(ok[:Ex_loc], xs + 1, -1)
    sl = slice(Ex_loc, Ex_loc + Ey_loc)
    src[sl] = np.where(ok[sl], ys, -1)
    tgt[sl] = np.where(ok[sl], ys + nx, -1)
    st = d * h * nx + plan.stub_rel[d].astype(np.int64)
    st_ok = plan.stub_valid[d].astype(bool)
    sb = plan.stub_s_bif[d].astype(bool)
    tail = slice(Ex_loc + Ey_loc, plan.E_loc)
    src[tail] = np.where(st_ok & sb, st, -1)
    tgt[tail] = np.where(st_ok & ~sb, st, -1)
    return src, tgt


class _Fwd(typing.NamedTuple):
    R: torch.Tensor
    f: torch.Tensor
    sp: torch.Tensor
    ep: torch.Tensor
    W: torch.Tensor
    w: torch.Tensor
    g: torch.Tensor
    Ftot: torch.Tensor
    const: torch.Tensor
    part: torch.Tensor


class ShardedGridExecutor:
    """The strip-sharded lattice solve on a :class:`..parallel.mesh.ShardMesh`.

    Holds, per owned strip, its cell widths, K22b's tables and its slot ends
    into λ on its device; per distinct device, the lattice's K17 plan, K16's
    operator (its representative conductances at positions 0 and 1, each
    stub group's at ``2 + group``: the reduce's tail) and a group: its
    strips (in owned order), their K1 batch (:class:`..kernels.condense.Batch`)
    and their K22b tables stacked
    (:class:`..kernels.shard_grid.StripBatchTables`), so K1 makes 1 launch
    and K22b 2 a device a solve whatever its number of strips.  Calling it
    returns per owned strip ``q_T``, ``p_T``, and λ (B,), the λ-system
    residual ``‖Lλ − rhs‖`` and the finiteness flag."""

    method_name = "schur_sharded_grid"

    def __init__(self, asm, plan: ShardedGridPlan, mesh, R_mode: str, f_mode: str):
        self.plan = plan
        self.mesh = mesh
        self._N = asm.network.N
        self._k = asm.flux_degree
        self._R_mode, self._f_mode = R_mode, f_mode
        self._modes = (row_mode(R_mode), row_mode(f_mode))
        B = asm.network.num_multipliers
        r = int(plan.dct.stub_rows.size)
        gp = _plan_grid_layout(asm, plan.dct)
        self.grid = {dev: device_grid_plan(gp, dev) for dev in mesh.local_devices}
        self.operator = {
            dev: dct_lattice.dct_operator(plan.dct, dev, stub_edge=2 + np.arange(r),
                                          stub_group=np.arange(r), rep_x=0, rep_y=1)
            for dev in mesh.local_devices
        }
        self.shards = []
        for d in mesh.owned:
            dev = mesh.devices[d]
            src, tgt = strip_ends(plan, d)
            self.shards.append(dict(
                device=dev,
                h_e=torch.as_tensor(plan.h_e[d], device=dev),
                ends=ends_plan(src, tgt, B, dev),
                tables=shard_grid.strip_tables(plan, d, dev),
            ))
        self.groups = []
        for dev in mesh.local_devices:
            members = tuple(i for i, sh in enumerate(self.shards) if sh["device"] == dev)
            self.groups.append(dict(
                device=dev, members=members,
                k1=condense.Batch([self.shards[i]["ends"] for i in members], self._N, self._k,
                                  *self._modes),
                tables=shard_grid.batch_strips([self.shards[i]["tables"] for i in members])))

    def prepare_args(self, R_data, f_data, start_pbc, end_pbc):
        """Per owned strip, its ``(R, f, start_pbc, end_pbc)`` slots on its device."""
        rows = shard_rows(self.plan, self._N, R_data, f_data, start_pbc, end_pbc,
                          self._R_mode, self._f_mode)
        return [tuple(torch.as_tensor(a, device=sh["device"]) for a in rows[d])
                for d, sh in zip(self.mesh.owned, self.shards)]

    # -- the stages, also what the kernel checks replay
    def condense(self, g: int, shard_args, plain: bool = False) -> torch.Tensor:
        """K1 of group ``g``'s strips (``shard_args`` every owned strip's
        :meth:`prepare_args` row), one launch: the ``(5, S, E_loc)`` planes
        ``W, w, g, Ftot, const``."""
        grp = self.groups[g]
        run = condense.condense_batch_plain if plain else condense.condense_batch
        return run(grp["k1"], [(self.shards[i]["h_e"], *shard_args[i]) for i in grp["members"]])

    def window(self, g: int, k1: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """K22b's windows of group ``g``'s strips from their K1 planes
        (:meth:`condense`), one launch: their ``(S, row_length)`` rows of
        the reduce."""
        run = shard_grid.window_batch_plain if plain else shard_grid.window_batch
        return run(self.groups[g]["tables"], k1[1], k1[4], k1[3])

    def forward(self, i: int, R, f, sp, ep, plain: bool = False) -> _Fwd:
        """Strip ``i`` (of the owned ones) alone up to its row of the
        reduce: its own K1 and K22b launches (what the stages of a group
        compute for it)."""
        sh = self.shards[i]
        run_condense = condense.condense_plain if plain else condense.condense
        run_window = shard_grid.window_plain if plain else shard_grid.window
        ends = sh["ends"]
        Rm, fm = self._modes
        W, w, g, Ftot, const = run_condense(ends.plan if plain else ends, self._N, self._k,
                                            sh["h_e"], R, f, Rm, fm, sp, ep)
        return _Fwd(R, f, sp, ep, W, w, g, Ftot, const,
                    run_window(sh["tables"], w, const, Ftot))

    def top(self, rows, plain: bool = False) -> dict:
        """The placed reduce of the groups' rows (:meth:`window`, one tensor
        a group), then once per device K22b's fill, K16 and K17: ``{device:
        (λ, residual)}``.  One group's rows are the reduce's input as they
        are; strips on several devices or processes go through
        :meth:`ShardMesh.stack`."""
        p = self.plan
        nx, ny, h = p.nx, p.ny, p.h
        r = int(p.dct.stub_rows.size)
        if len(self.groups) == 1 and not self.mesh.distributed:
            stacked = rows[0]
        else:
            parts = [None] * len(self.shards)
            for grp, part in zip(self.groups, rows):
                for j, i in enumerate(grp["members"]):
                    parts[i] = part[j]
            stacked = self.mesh.stack(parts)
        windows = self.mesh.reduce_placed(stacked, 2, h, nx, ny, plain=plain)
        tail = self.mesh.reduce(stacked, 2 + r, 2 * (h + 1) * nx, plain=plain)
        fill = shard_grid.fill_plain if plain else shard_grid.fill
        solve = dct_lattice.dct_lattice_plain if plain else dct_lattice.dct_lattice
        resid = grid_core.grid_residual_plain if plain else grid_core.grid_residual
        Ex, Ey = ny * (nx - 1), (ny - 1) * nx

        def run(win, wts):
            gdp = self.grid[win.device]
            w_grid = fill(Ex, Ey, gdp.num_edges, wts)
            rhs, diag = win[0].reshape(-1), win[1].reshape(-1)
            lam = solve(self.operator[win.device], wts, rhs,
                        lambda lam: resid(gdp, w_grid, diag, lam, rhs))
            _, res = resid(gdp, w_grid, diag, lam, rhs, norm=True)
            return lam, res

        return self.mesh.replicate(run, windows, tail)

    def back(self, i: int, fw: _Fwd, lam, plain: bool = False):
        """Strip ``i``'s K5 from the replicated λ: ``(q_T, p_T, finite)``."""
        sh = self.shards[i]
        run_expand = expand.expand_plain if plain else expand.expand
        ends = sh["ends"]
        Rm, fm = self._modes
        return run_expand(ends.plan if plain else ends, self._N, self._k, lam, fw.sp, fw.ep,
                          fw.W, fw.w, fw.g, fw.Ftot, sh["h_e"], fw.R, fw.f, Rm, fm)

    def __call__(self, shard_args, plain: bool = False):
        refuse_grad(type(self).__name__, *(t for args in shard_args for t in args))
        fws, rows = [None] * len(self.shards), []
        for g, grp in enumerate(self.groups):
            k1 = self.condense(g, shard_args, plain)
            rows.append(self.window(g, k1, plain))
            for j, i in enumerate(grp["members"]):
                fws[i] = _Fwd(*shard_args[i], *k1[:, j].unbind(0), rows[-1][j])
        top = self.top(rows, plain)
        outs = [self.back(i, fw, top[self.shards[i]["device"]][0], plain)
                for i, fw in enumerate(fws)]
        lam, res = top[self.mesh.home]
        finite = self.mesh.all_finite([o[2] for o in outs], plain)
        return [o[0] for o in outs], [o[1] for o in outs], lam, res, finite

    def plain(self, shard_args):
        return self(shard_args, plain=True)


def build_sharded_grid_executor(asm, plan: ShardedGridPlan, mesh, modes: tuple | None = None
                                ) -> ShardedGridExecutor:
    """The executor for a prepared plan; ``modes`` overrides the live
    ``asm.coefficient_modes()`` (an assemble-time snapshot's kinds)."""
    R_mode, f_mode, _ = modes if modes is not None else asm.coefficient_modes()
    if f_mode not in ("scalar", "edge", "cell"):
        raise ValueError("sharded grid executor requires scalar/per-edge/per-cell f")
    return ShardedGridExecutor(asm, plan, mesh, R_mode, f_mode)


def sharded_grid_sweep(*args, **kwargs):
    """Batched scalar-R lattice scenarios through the strip solve — not ported."""
    raise NotImplementedError("ROADMAP A9: sharded_grid_sweep is not ported yet")
