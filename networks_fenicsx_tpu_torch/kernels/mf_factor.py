"""K13 + K14: the factor of the tree multifrontal core solve (``csrc/mf_factor.cu``).

Replaces ``networks_fenicsx_tpu/ops/multifrontal.py:_mf_factor`` with
``_consume_onehot`` (``:669-741``: front assembly, extend-add) and
``_chol_inv_small`` / ``chol_inverse_batched`` (``:561-653``: the batched
Cholesky).  Per group of fronts, in the plan's postorder: the pivot-row
strips of ``−w_pairs[init_slot]`` and the peeled diagonal ``dc`` on the
pivots, the extend-add of each consumed child group's update matrix, then
the Cholesky factor ``L`` of the pivot block, ``Y = L⁻¹F_SB`` and the update
``U = F_BB − YᵀY`` its parent consumes.

The factor keeps ``L`` and ``Y`` (the apply, :mod:`.mf_apply`, solves the
triangles) instead of the reference's explicit ``Li = L⁻¹`` and ``X``, and
is float64 where the reference's is float32 (its workaround for emulated
float64 on the TPU); the refinement passes of the apply stay.  The state
(:class:`MFState`) is one flat factor buffer — per front an ``(m, m)``
block with ``L`` (pivot block, lower, and ``Lᵀ`` above its diagonal, so
that the apply reads both triangles along rows), ``Yᵀ`` (lower-left) and
``U`` (lower-right, lower triangle), zero elsewhere — plus the flat U
pools, the pair values, the f64 diagonal and the gate flag (0 when an entry
of ``L`` is not finite).

:func:`mf_factor` launches the kernels for CUDA tensors (the values pass,
then per level of the plan's :class:`..ops.multifrontal.MFSchedule` one
launch of its wide fronts and one of the rest: :func:`cuda_launches`) and
runs :func:`mf_factor_plain` for CPU tensors.  :func:`assemble_fronts`
writes the assembled fronts alone (the kernels' extend-add through ``rel``),
:func:`assemble_fronts_plain` the same by the reference's gather through
``lminv`` (``rel=True``: by a scatter through ``rel``).

:func:`mf_factor_scenarios` makes S factors in the launches of one (every
launch of the schedule with the scenario as its grid's y): ``dc (S, n)``
and ``w_pairs (S, P)`` (either may be shared, one row), an :class:`MFState`
whose entries carry a leading S, row ``i`` :func:`mf_factor` of row ``i`` bit
for bit; its plain version is :func:`mf_factor_plain` a row, stacked.
:func:`scenario_chunk` bounds the factors a sweep holds at once.
"""

from __future__ import annotations

import typing

import torch

from ..ops.multifrontal import (
    C_B, C_REL, G_B, G_C, G_CONS, G_CVAL, G_FAC, G_K, G_NODES, G_POOL, G_VPOOL, G_W,
    DeviceMFPlan,
)
from . import build
from .dense_core import MAX_SCENARIOS, SCENARIO_BUDGET

__all__ = [
    "MFState", "assemble_fronts", "assemble_fronts_plain", "cuda_launches", "front_factor_plain",
    "group_views", "mf_factor", "mf_factor_plain", "mf_factor_scenarios", "mf_factor_scenarios_plain",
    "scenario_chunk",
]


def cuda_launches(dmf: DeviceMFPlan) -> int:
    """CUDA kernel launches of one :func:`mf_factor` call: the values pass,
    and per level one launch of its fronts wider than ``WIDE_M`` and one of
    the rest, where it has them."""
    return dmf.schedule.factor_launches


class MFState(typing.NamedTuple):
    """The factor of a core: what :func:`.mf_apply.mf_apply` reads."""

    fac: torch.Tensor  # (fac_len,) per-front (m, m) blocks: L | Yᵀ | U
    pools: torch.Tensor  # (pool_len,) per-front (b, b) update matrices U
    vals: torch.Tensor  # (P0 + 1,) −w_pairs[init_slot], then 0
    ok: torch.Tensor  # () int32: 1 when every entry of L is finite
    dc: torch.Tensor  # (n_core,) the peeled diagonal


def group_views(dmf: DeviceMFPlan, gi: int) -> tuple:
    """``(k, w, b, c, m, nodes (k, w), cval (k, w, c), ccol (k, w, c))`` of group ``gi``."""
    row = dmf.groups[gi]
    k, w, b, c = (int(row[i]) for i in (G_K, G_W, G_B, G_C))
    no, co = int(row[G_NODES]), int(row[G_CVAL])
    nodes = dmf.nodes_all[no : no + k * w].view(k, w)
    cval = dmf.cval_all[co : co + k * w * c].view(k, w, c)
    ccol = dmf.ccol_all[co : co + k * w * c].view(k, w, c)
    return k, w, b, c, w + b, nodes, cval, ccol


def _child_pool(dmf: DeviceMFPlan, pools: torch.Tensor, cg: int, width: int) -> torch.Tensor:
    """Group ``cg``'s ``(k, b, b)`` (``width=2``) or ``(k, b)`` pool, padded
    with a zero front and a zero row/column: the reference's ``jnp.pad``."""
    row = dmf.groups[cg]
    kc, cb = int(row[G_K]), int(row[G_B])
    shape = (kc,) + (cb,) * width
    off = int(row[G_POOL] if width == 2 else row[G_VPOOL])
    n = kc * cb**width
    pad = torch.zeros((kc + 1,) + (cb + 1,) * width, dtype=torch.float64, device=pools.device)
    pad[(slice(0, kc),) + (slice(0, cb),) * width] = pools[off : off + n].view(shape)
    return pad


def _values(dmf: DeviceMFPlan, dc: torch.Tensor, w_pairs: torch.Tensor) -> tuple:
    """``(vals, dc_ext)``: ``−w_pairs[init_slot]`` then 0, and ``dc`` then 1."""
    dt, dev = torch.float64, dc.device
    vals = torch.cat([-w_pairs[dmf.init_slot.long()], torch.zeros(1, dtype=dt, device=dev)])
    return vals, torch.cat([dc, torch.ones(1, dtype=dt, device=dev)])


def _child_rel(dmf: DeviceMFPlan, edge: int, k: int) -> torch.Tensor:
    """Consume edge ``edge``'s ``rel (k, cb)`` (−1: no parent index)."""
    cb, off = (int(v) for v in dmf.consume[edge, [C_B, C_REL]])
    return dmf.rel_all[off : off + k * cb].view(k, cb).long()


def _assemble_group(dmf: DeviceMFPlan, gi: int, vals, dc_ext, pools, rel: bool) -> torch.Tensor:
    """Group ``gi``'s assembled fronts ``F (k, m, m)``: the pivot-row strips,
    the diagonal and each consumed child's update, in plan order, gathered
    through ``lminv`` (the reference's) or, with ``rel``, scattered through
    ``rel`` (the kernels')."""
    dt, dev = torch.float64, vals.device
    g = dmf.plan.groups[gi]
    k, w, b, c, m, nodes, cval, ccol = group_views(dmf, gi)
    S = torch.zeros((k, w, m + 1), dtype=dt, device=dev)  # column m: the pads
    S.scatter_(2, ccol.long(), vals[cval.long()])
    F = torch.zeros((k, m, m), dtype=dt, device=dev)
    F[:, :w, :] = S[:, :, :m]
    F[:, w:, :w] = S[:, :, w:m].transpose(1, 2)
    ar = torch.arange(w, device=dev)
    F[:, ar, ar] = F[:, ar, ar] + dc_ext[nodes.long()]
    ark = torch.arange(k, device=dev)[:, None, None]
    for e, (cg, cidx_off, lminv_off) in enumerate(g.consume):
        Upad = _child_pool(dmf, pools, cg, 2)
        cidx = dmf.cidx_all[cidx_off : cidx_off + k].long()
        Us = Upad[cidx]
        if rel:
            r = _child_rel(dmf, int(dmf.groups[gi][G_CONS]) + e, k)
            valid = r >= 0
            # every pair of the child's mapped slots: distinct entries of the
            # front (rel is one to one), one add each
            P, A, Q = torch.nonzero(valid[:, :, None] & valid[:, None, :], as_tuple=True)
            I, J = r[P, A], r[P, Q]
            F[P, I, J] = F[P, I, J] + Us[P, A, Q]
        else:
            lminv = dmf.lminv_all[lminv_off : lminv_off + k * m].view(k, m).long()
            F = F + Us[ark, lminv[:, :, None], lminv[:, None, :]]
    return F


def assemble_fronts_plain(dmf: DeviceMFPlan, dc: torch.Tensor, w_pairs: torch.Tensor,
                          pools: torch.Tensor, rel: bool = False) -> torch.Tensor:
    """Every front's assembled block (before its factor) in the factor
    buffer's layout ``(fac_len,)``, each child's update read from ``pools``
    (a factor's :attr:`MFState.pools`): gathered through ``lminv`` or, with
    ``rel``, scattered through ``rel``."""
    vals, dc_ext = _values(dmf, dc, w_pairs)
    out = torch.zeros(dmf.fac_len, dtype=torch.float64, device=dc.device)
    for gi in range(len(dmf.plan.groups)):
        F = _assemble_group(dmf, gi, vals, dc_ext, pools, rel)
        fo = int(dmf.groups[gi][G_FAC])
        out[fo : fo + F.numel()] = F.reshape(-1)
    return out


def mf_factor_plain(dmf: DeviceMFPlan, dc: torch.Tensor, w_pairs: torch.Tensor) -> MFState:
    """Eager version, batched per group with PyTorch's float64 Cholesky
    and triangular solve."""
    dt, dev = torch.float64, dc.device
    vals, dc_ext = _values(dmf, dc, w_pairs)
    fac = torch.zeros(dmf.fac_len, dtype=dt, device=dev)
    pools = torch.zeros(dmf.pool_len, dtype=dt, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for gi in range(len(dmf.plan.groups)):
        k, w, b, _, m, _, _, _ = group_views(dmf, gi)
        F = _assemble_group(dmf, gi, vals, dc_ext, pools, rel=False)
        blk, U, front_ok = front_factor_plain(F, w)
        ok = ok & front_ok
        if b:
            po = int(dmf.groups[gi][G_POOL])
            pools[po : po + k * b * b] = U.reshape(-1)
        fo = int(dmf.groups[gi][G_FAC])
        fac[fo : fo + k * m * m] = blk.reshape(-1)
    return MFState(fac, pools, vals, ok.to(torch.int32), dc)


def front_factor_plain(F: torch.Tensor, w: int) -> tuple:
    """K13 and the update of K14 on a batch of assembled fronts ``F (k, m, m)``
    with ``w`` pivots: ``(blk, U, ok)`` with ``blk`` the factor's
    ``(k, m, m)`` blocks (``L`` of ``F_SS = L Lᵀ`` with ``Lᵀ`` above its
    diagonal, ``Yᵀ = (L⁻¹F_SB)ᵀ``, the lower triangle of
    ``U = F_BB − YᵀY``), ``U`` in full and ``ok`` False when the Cholesky
    failed or an entry of ``L`` is not finite."""
    k, m, _ = F.shape
    L, info = torch.linalg.cholesky_ex(F[:, :w, :w])
    ok = torch.all(info == 0) & torch.all(torch.isfinite(L))
    blk = torch.zeros((k, m, m), dtype=torch.float64, device=F.device)
    blk[:, :w, :w] = L + torch.triu(L.transpose(1, 2), 1)
    U = None
    if m > w:
        Y = torch.linalg.solve_triangular(L, F[:, :w, w:], upper=False)
        U = F[:, w:, w:] - Y.transpose(1, 2) @ Y
        blk[:, w:, :w] = Y.transpose(1, 2)
        blk[:, w:, w:] = torch.tril(U)
    return blk, U, ok


def _launch(dmf: DeviceMFPlan, dc, w_pairs, pools_in, assemble_only: bool) -> tuple:
    """``(vals, fac, pools, ok)`` of one ``nxfx_mf_factor`` call."""
    build.require_cuda("mf_factor", dc, w_pairs)
    build.require_cuda(
        "mf_factor", dmf.init_slot, dmf.nodes_all, dmf.cval_all, dmf.ccol_all, dmf.rel_all,
        dmf.xadd_ptr, dmf.xadd, dmf.fronts, dtype=torch.int32,
    )
    build.require_cuda("mf_factor", dmf.groups_dev, dtype=torch.int64)
    plan = dmf.plan
    if tuple(dc.shape) != (plan.n_core,):
        raise ValueError("mf_factor: dc must be (n_core,)")
    dev, dt = dc.device, torch.float64
    P0 = plan.n_pairs
    vals = torch.empty(P0 + 1, dtype=dt, device=dev)
    fac = torch.empty(dmf.fac_len, dtype=dt, device=dev)
    pools = torch.empty(max(dmf.pool_len, 1), dtype=dt, device=dev)
    ok = torch.empty((), dtype=torch.int32, device=dev)
    sched = dmf.schedule
    with torch.cuda.device(dev):
        code = build.library().nxfx_mf_factor(
            sched.n_levels, sched.levels.ctypes.data, plan.n_core, P0, int(assemble_only),
            dmf.groups_dev.data_ptr(), dmf.fronts.data_ptr(),
            dmf.init_slot.data_ptr(), w_pairs.data_ptr(), dc.data_ptr(),
            dmf.nodes_all.data_ptr(), dmf.cval_all.data_ptr(), dmf.ccol_all.data_ptr(),
            dmf.rel_all.data_ptr(), dmf.xadd_ptr.data_ptr(),
            dmf.xadd.data_ptr(), (pools if pools_in is None else pools_in).data_ptr(),
            vals.data_ptr(), fac.data_ptr(), pools.data_ptr(), ok.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "mf_factor")
    return vals, fac, pools[: dmf.pool_len], ok


def mf_factor(dmf: DeviceMFPlan, dc: torch.Tensor, w_pairs: torch.Tensor) -> MFState:
    """K13 + K14 on ``dc``'s device: the factor of the core with peeled
    diagonal ``dc (n_core,)`` and pair conductances ``w_pairs (P,)``."""
    if dc.device.type == "cpu":
        return mf_factor_plain(dmf, dc, w_pairs)
    vals, fac, pools, ok = _launch(dmf, dc, w_pairs, None, False)
    mf_factor.launches += 1
    return MFState(fac, pools, vals, ok, dc)


mf_factor.launches = 0


def assemble_fronts(dmf: DeviceMFPlan, dc: torch.Tensor, w_pairs: torch.Tensor,
                    pools: torch.Tensor) -> torch.Tensor:
    """The kernels' assembled fronts (``(fac_len,)``, before the factor),
    each child's update read from ``pools``: the factor's launches stopped
    after the extend-add.  CPU tensors: :func:`assemble_fronts_plain`."""
    if dc.device.type == "cpu":
        return assemble_fronts_plain(dmf, dc, w_pairs, pools, rel=True)
    build.require_cuda("assemble_fronts", pools)
    if pools.numel() < dmf.pool_len:
        raise ValueError("assemble_fronts: pools must hold pool_len values")
    fac = _launch(dmf, dc, w_pairs, pools, True)[1]
    assemble_fronts.launches += 1
    return fac


assemble_fronts.launches = 0


def scenario_chunk(dmf: DeviceMFPlan, budget: int = SCENARIO_BUDGET) -> int:
    """Factors a chunk of a sweep's R batch holds: a factor's buffer, its U
    pools and its apply's v pools (8 bytes each of ``fac_len + pool_len +
    vpool_len``) as many times as ``budget`` holds, at least 1 and at most
    :data:`MAX_SCENARIOS` (36 on the 100k web, 134 on the perfusion bed)."""
    per = 8 * max(dmf.fac_len + dmf.pool_len + dmf.vpool_len, 1)
    return max(1, min(MAX_SCENARIOS, budget // per))


def _scenario_inputs(name: str, dmf: DeviceMFPlan, dc, w_pairs) -> int:
    """The scenario count of a factor call over S (``dc`` (S, n) or (n,),
    ``w_pairs`` (S, P) or (P,)), or raise."""
    S = build.scenarios(name, (dc, (dmf.plan.n_core,)), (w_pairs, (w_pairs.shape[-1],)))
    if S > MAX_SCENARIOS:
        raise ValueError(f"{name}: at most {MAX_SCENARIOS} scenarios a call, got {S}")
    return S


def mf_factor_scenarios_plain(dmf: DeviceMFPlan, dc: torch.Tensor, w_pairs: torch.Tensor) -> MFState:
    """Eager version of :func:`mf_factor_scenarios`: :func:`mf_factor_plain` a
    scenario, stacked."""
    S = _scenario_inputs("mf_factor_scenarios", dmf, dc, w_pairs)
    n, P = dmf.plan.n_core, w_pairs.shape[-1]
    rows = [mf_factor_plain(dmf, build.scenario_row(dc, (n,), i),
                            build.scenario_row(w_pairs, (P,), i)) for i in range(S)]
    return MFState(*(torch.stack(t) for t in zip(*rows)))


def mf_factor_scenarios(dmf: DeviceMFPlan, dc: torch.Tensor, w_pairs: torch.Tensor) -> MFState:
    """K13 + K14 of S cores on ``dc``'s device in the launches of one
    :func:`mf_factor`: ``dc (S, n_core)`` the peeled diagonals and ``w_pairs
    (S, P)`` the pair conductances (either shared as one row).  Returns an
    :class:`MFState` with a leading S on ``fac``, ``pools``, ``vals``, ``ok``
    and ``dc``; row ``i`` is :func:`mf_factor` of row ``i`` bit for bit."""
    if dc.device.type == "cpu":
        return mf_factor_scenarios_plain(dmf, dc, w_pairs)
    name = "mf_factor_scenarios"
    S = _scenario_inputs(name, dmf, dc, w_pairs)
    build.require_cuda(name, dc, w_pairs)
    build.require_cuda(
        name, dmf.init_slot, dmf.nodes_all, dmf.cval_all, dmf.ccol_all, dmf.rel_all,
        dmf.xadd_ptr, dmf.xadd, dmf.fronts, dtype=torch.int32,
    )
    build.require_cuda(name, dmf.groups_dev, dtype=torch.int64)
    plan = dmf.plan
    n, P0, P = plan.n_core, plan.n_pairs, w_pairs.shape[-1]
    dev, dt = dc.device, torch.float64
    vals = torch.empty((S, P0 + 1), dtype=dt, device=dev)
    fac = torch.empty((S, dmf.fac_len), dtype=dt, device=dev)
    pl = max(dmf.pool_len, 1)
    pools = torch.empty((S, pl), dtype=dt, device=dev)
    ok = torch.empty(S, dtype=torch.int32, device=dev)
    sched = dmf.schedule
    with torch.cuda.device(dev):
        code = build.library().nxfx_mf_factor_scen(
            sched.n_levels, sched.levels.ctypes.data, n, P0, S,
            dmf.groups_dev.data_ptr(), dmf.fronts.data_ptr(), dmf.init_slot.data_ptr(),
            build.scenario_stride(w_pairs, (P,)), w_pairs.data_ptr(),
            build.scenario_stride(dc, (n,)), dc.data_ptr(),
            dmf.nodes_all.data_ptr(), dmf.cval_all.data_ptr(), dmf.ccol_all.data_ptr(),
            dmf.rel_all.data_ptr(), dmf.xadd_ptr.data_ptr(), dmf.xadd.data_ptr(),
            vals.data_ptr(), dmf.fac_len, fac.data_ptr(), pl, pools.data_ptr(), ok.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, name)
    mf_factor_scenarios.launches += 1
    dc_rows = dc if dc.dim() == 2 else dc[None].expand(S, n)
    return MFState(fac, pools[:, : dmf.pool_len], vals, ok, dc_rows)


mf_factor_scenarios.launches = 0
