"""K15: the apply of the tree multifrontal core solve (``csrc/mf_apply.cu``).

Replaces ``networks_fenicsx_tpu/ops/multifrontal.py:_mf_sweep`` and
``_mf_apply`` (``:744-816``).  A sweep solves the core against the factor
of :mod:`.mf_factor`: bottom-up per group ``y = L⁻¹b_S`` and
``u = b_B − Yᵀy`` (the children's ``u`` folded in through ``lminv``), then
top-down ``λ_S = L⁻ᵀ(y − Y λ_B)`` into the λ stream, read back through
``lam_pos`` — the reference's ``u = b_B − Xᵀb_S`` and
``λ_S = F_SS⁻¹b_S − Xλ_B``.  Then ``plan.n_refine`` refinement passes
``x += sweep(rc − A x)`` against the exact float64 core operator
``A x = dc⊙x + folds of vals·x[other]`` (the folds are K10,
:mod:`.fold`), and NaN everywhere when the factor's gate tripped.

:func:`mf_apply` launches the kernels for CUDA tensors (per sweep, one C
call of a forward launch per level of the plan's
:class:`..ops.multifrontal.MFSchedule`, bottom-up, a backward launch per
level, top-down, and a gather; per refinement pass, a terms pass, two K10
folds and a residual pass: :func:`cuda_launches`) and runs
:func:`mf_apply_plain` for CPU tensors.

:func:`mf_apply_scenarios` solves S right-hand sides ``rc (S, n)`` in the
launches of one apply (every launch with the scenario as its grid's y, the
refinement's folds :func:`.fold.fold_apply_scenarios`), on S factors of
:func:`.mf_factor.mf_factor_scenarios` or on one factor read at stride 0;
row ``i`` is :func:`mf_apply` of its factor and ``rc[i]`` bit for bit.  Its
plain version is :func:`mf_apply_plain` a row, stacked.
"""

from __future__ import annotations

import torch

from ..ops.multifrontal import G_BNDPOS, G_CONS, G_FAC, G_LAM, G_VPOOL, DeviceMFPlan
from . import build, fold
from .core_fronts import fold_launches
from .mf_factor import MFState, _child_pool, _child_rel, group_views

__all__ = ["mf_apply", "mf_apply_plain", "cuda_launches", "sweep_rhs_plain",
           "mf_apply_scenarios", "mf_apply_scenarios_plain"]


def cuda_launches(dmf: DeviceMFPlan) -> int:
    """CUDA kernel launches of one :func:`mf_apply` call (the K10 folds
    included): ``(1 + n_refine)`` sweeps of ``2 L + 1`` for the schedule's
    ``L`` levels, per refinement pass a terms pass, the two folds and a
    residual pass, and the gate."""
    per_pass = 2 + fold_launches(dmf.mv_fold_i) + fold_launches(dmf.mv_fold_j)
    n = dmf.plan.n_refine
    return (1 + n) * dmf.schedule.sweep_launches + n * per_pass + 1


def sweep_rhs_plain(dmf: DeviceMFPlan, gi: int, rc_ext: torch.Tensor, vpools: torch.Tensor,
                    rel: bool = False) -> torch.Tensor:
    """Group ``gi``'s forward right-hand sides ``bv (k, m)``: ``rc`` on the
    pivots, 0 on the boundary, plus each consumed child's ``v`` in plan
    order, gathered through ``lminv`` (the reference's) or, with ``rel``,
    scattered through ``rel`` (the kernels')."""
    dt, dev = torch.float64, rc_ext.device
    k, w, b, _, m, nodes, _, _ = group_views(dmf, gi)
    bv = torch.cat([rc_ext[nodes.long()], torch.zeros((k, b), dtype=dt, device=dev)], dim=1)
    ark = torch.arange(k, device=dev)[:, None]
    for e, (cg, cidx_off, lminv_off) in enumerate(dmf.plan.groups[gi].consume):
        Vpad = _child_pool(dmf, vpools, cg, 1)
        cidx = dmf.cidx_all[cidx_off : cidx_off + k].long()
        if rel:
            r = _child_rel(dmf, int(dmf.groups[gi][G_CONS]) + e, k)
            P, A = torch.nonzero(r >= 0, as_tuple=True)
            bv[P, r[P, A]] = bv[P, r[P, A]] + Vpad[cidx][P, A]
        else:
            lminv = dmf.lminv_all[lminv_off : lminv_off + k * m].view(k, m).long()
            bv = bv + Vpad[cidx][ark, lminv]
    return bv


def _sweep_plain(dmf: DeviceMFPlan, state: MFState, rhs: torch.Tensor) -> torch.Tensor:
    """One multifrontal solve of the core, batched per group."""
    dt, dev = torch.float64, rhs.device
    plan = dmf.plan
    ys = torch.zeros(plan.lam_len, dtype=dt, device=dev)
    vpools = torch.zeros(dmf.vpool_len, dtype=dt, device=dev)
    rc_ext = torch.cat([rhs, torch.zeros(1, dtype=dt, device=dev)])
    blocks = []
    for gi in range(len(plan.groups)):
        k, w, b, _, m, _, _, _ = group_views(dmf, gi)
        row = dmf.groups[gi]
        fo = int(row[G_FAC])
        blk = state.fac[fo : fo + k * m * m].view(k, m, m)
        L, Yt = blk[:, :w, :w], blk[:, w:, :w]
        blocks.append((L, Yt))
        bv = sweep_rhs_plain(dmf, gi, rc_ext, vpools)
        y = torch.linalg.solve_triangular(L, bv[:, :w, None], upper=False)[..., 0]
        lo = int(row[G_LAM])
        ys[lo : lo + k * w] = y.reshape(-1)
        if b:
            u = bv[:, w:] - (Yt @ y[..., None])[..., 0]
            vo = int(row[G_VPOOL])
            vpools[vo : vo + k * b] = u.reshape(-1)
    lam = torch.zeros(plan.lam_len + 1, dtype=dt, device=dev)  # trailing pad cell
    for gi in reversed(range(len(plan.groups))):
        k, w, b, _, m, _, _, _ = group_views(dmf, gi)
        row = dmf.groups[gi]
        L, Yt = blocks[gi]
        lo = int(row[G_LAM])
        t = ys[lo : lo + k * w].view(k, w)
        if b:
            bo = int(row[G_BNDPOS])
            bndpos = dmf.bndpos_all[bo : bo + k * b].view(k, b).long()
            t = t - (Yt.transpose(1, 2) @ lam[bndpos][..., None])[..., 0]
        z = torch.linalg.solve_triangular(L.transpose(1, 2), t[..., None], upper=True)[..., 0]
        lam[lo : lo + k * w] = z.reshape(-1)
    return lam[dmf.lam_pos.long()]


def mf_apply_plain(dmf: DeviceMFPlan, state: MFState, rc: torch.Tensor) -> torch.Tensor:
    """Eager version: the refined core solution ``x (n_core,)``."""
    plan = dmf.plan
    P0 = plan.n_pairs
    vals = state.vals[:P0]
    pci, pcj = dmf.pci.long(), dmf.pcj.long()
    zero = torch.zeros(1, dtype=torch.float64, device=rc.device)

    def matvec(x):
        si = fold.fold_apply_plain(vals * x[pcj], dmf.mv_fold_i)
        sj = fold.fold_apply_plain(vals * x[pci], dmf.mv_fold_j)
        return (
            state.dc * x
            + torch.cat([si, zero])[dmf.mv_inv_i.long()]
            + torch.cat([sj, zero])[dmf.mv_inv_j.long()]
        )

    x = _sweep_plain(dmf, state, rc)
    for _ in range(plan.n_refine):
        x = x + _sweep_plain(dmf, state, rc - matvec(x))
    return torch.where(state.ok.bool(), x, torch.nan)


def mf_apply(dmf: DeviceMFPlan, state: MFState, rc: torch.Tensor) -> torch.Tensor:
    """K15 on ``rc``'s device: the core solution ``x (n_core,)`` of ``A x = rc``."""
    if rc.device.type == "cpu":
        return mf_apply_plain(dmf, state, rc)
    build.require_cuda("mf_apply", rc, state.fac, state.pools, state.vals, state.dc)
    build.require_cuda("mf_apply", state.ok, dtype=torch.int32)
    build.require_cuda(
        "mf_apply", dmf.nodes_all, dmf.bndpos_all, dmf.xadd_ptr, dmf.xadd, dmf.fronts,
        dmf.lam_pos, dmf.pci, dmf.pcj, dmf.mv_inv_i, dmf.mv_inv_j, dtype=torch.int32,
    )
    build.require_cuda("mf_apply", dmf.groups_dev, dtype=torch.int64)
    plan = dmf.plan
    n, P0 = plan.n_core, plan.n_pairs
    if tuple(rc.shape) != (n,) or tuple(state.fac.shape) != (dmf.fac_len,):
        raise ValueError("mf_apply: rc must be (n_core,) and the state this plan's")
    dev, dt = rc.device, torch.float64
    lib = build.library()
    stream = build.stream_handle(dev)
    sched = dmf.schedule
    ys = torch.empty(plan.lam_len, dtype=dt, device=dev)
    lam = torch.empty(plan.lam_len, dtype=dt, device=dev)
    vpools = torch.empty(max(dmf.vpool_len, 1), dtype=dt, device=dev)
    x = torch.empty(n, dtype=dt, device=dev)
    r = torch.empty(n, dtype=dt, device=dev)
    ti = torch.empty(P0, dtype=dt, device=dev)
    tj = torch.empty(P0, dtype=dt, device=dev)

    def sweep(rhs, accumulate):
        with torch.cuda.device(dev):
            code = lib.nxfx_mf_sweep(
                sched.n_levels, sched.levels.ctypes.data, n, plan.lam_len,
                dmf.groups_dev.data_ptr(), dmf.fronts.data_ptr(),
                rhs.data_ptr(), dmf.nodes_all.data_ptr(), dmf.bndpos_all.data_ptr(),
                dmf.xadd_ptr.data_ptr(), dmf.xadd.data_ptr(),
                dmf.lam_pos.data_ptr(),
                state.fac.data_ptr(), vpools.data_ptr(), ys.data_ptr(), lam.data_ptr(),
                x.data_ptr(), int(accumulate), stream,
            )
        build.check(code, "mf_apply")

    sweep(rc, False)
    for _ in range(plan.n_refine):
        with torch.cuda.device(dev):
            code = lib.nxfx_mf_terms(
                P0, state.vals.data_ptr(), dmf.pci.data_ptr(), dmf.pcj.data_ptr(), x.data_ptr(),
                ti.data_ptr(), tj.data_ptr(), stream,
            )
        build.check(code, "mf_apply")
        si = fold.fold_apply(ti, dmf.mv_fold_i)
        sj = fold.fold_apply(tj, dmf.mv_fold_j)
        with torch.cuda.device(dev):
            code = lib.nxfx_mf_residual(
                n, rc.data_ptr(), state.dc.data_ptr(), x.data_ptr(),
                dmf.mv_inv_i.data_ptr(), si.shape[0], si.data_ptr(),
                dmf.mv_inv_j.data_ptr(), sj.shape[0], sj.data_ptr(), r.data_ptr(), stream,
            )
        build.check(code, "mf_apply")
        sweep(r, True)
    with torch.cuda.device(dev):
        code = lib.nxfx_mf_gate(n, state.ok.data_ptr(), x.data_ptr(), stream)
    build.check(code, "mf_apply")
    mf_apply.launches += 1
    return x


mf_apply.launches = 0


def _scenario_state(name: str, dmf: DeviceMFPlan, state: MFState, rc: torch.Tensor) -> tuple:
    """``(S, shared)`` of an apply over S: ``rc (S, n)``, the state one
    factor's (shared) or S factors' (a leading S), or raise."""
    n = dmf.plan.n_core
    if rc.dim() != 2 or rc.shape[1] != n or rc.shape[0] < 1:
        raise ValueError(f"{name}: rc must be (S, n_core), S >= 1")
    S = int(rc.shape[0])
    shared = state.fac.dim() == 1
    want = (() if shared else (S,))
    if (tuple(state.fac.shape) != want + (dmf.fac_len,) or tuple(state.dc.shape) != want + (n,)
            or tuple(state.ok.shape) != want or state.vals.shape[-1] != dmf.plan.n_pairs + 1):
        raise ValueError(f"{name}: the state must be one factor of this plan or S of them")
    return S, shared


def mf_apply_scenarios_plain(dmf: DeviceMFPlan, state: MFState, rc: torch.Tensor) -> torch.Tensor:
    """Eager version of :func:`mf_apply_scenarios`: :func:`mf_apply_plain` a
    scenario (on its factor), stacked."""
    S, shared = _scenario_state("mf_apply_scenarios", dmf, state, rc)
    return torch.stack([mf_apply_plain(dmf, state if shared else MFState(*(t[i] for t in state)),
                                       rc[i]) for i in range(S)])


def mf_apply_scenarios(dmf: DeviceMFPlan, state: MFState, rc: torch.Tensor) -> torch.Tensor:
    """K15 over S right-hand sides on ``rc``'s device in the launches of one
    :func:`mf_apply`: ``rc (S, n_core)``, ``state`` S factors
    (:func:`.mf_factor.mf_factor_scenarios`) or one (:func:`.mf_factor.mf_factor`,
    read at stride 0).  Returns ``x (S, n_core)``, row ``i`` :func:`mf_apply`
    of its factor and ``rc[i]`` bit for bit."""
    if rc.device.type == "cpu":
        return mf_apply_scenarios_plain(dmf, state, rc)
    name = "mf_apply_scenarios"
    S, shared = _scenario_state(name, dmf, state, rc)
    build.require_cuda(name, rc, state.fac, state.pools, state.vals)
    build.require_cuda(name, state.dc, contiguous=False)
    build.require_cuda(name, state.ok, dtype=torch.int32)
    build.require_cuda(
        name, dmf.nodes_all, dmf.bndpos_all, dmf.xadd_ptr, dmf.xadd, dmf.fronts,
        dmf.lam_pos, dmf.pci, dmf.pcj, dmf.mv_inv_i, dmf.mv_inv_j, dtype=torch.int32,
    )
    build.require_cuda(name, dmf.groups_dev, dtype=torch.int64)
    plan = dmf.plan
    n, P0 = plan.n_core, plan.n_pairs
    s_dc = 0 if shared else state.dc.stride(0)
    if state.dc.stride(-1) != 1:
        raise ValueError(f"{name}: the state's dc rows must be contiguous")
    dev, dt = rc.device, torch.float64
    lib = build.library()
    stream = build.stream_handle(dev)
    sched = dmf.schedule
    vl = max(dmf.vpool_len, 1)
    ys = torch.empty((S, plan.lam_len), dtype=dt, device=dev)
    lam = torch.empty((S, plan.lam_len), dtype=dt, device=dev)
    vpools = torch.empty((S, vl), dtype=dt, device=dev)
    x = torch.empty((S, n), dtype=dt, device=dev)
    r = torch.empty((S, n), dtype=dt, device=dev)
    ti = torch.empty((S, P0), dtype=dt, device=dev)
    tj = torch.empty((S, P0), dtype=dt, device=dev)

    def run(fn, *args):
        with torch.cuda.device(dev):
            code = fn(*args)
        build.check(code, name)

    def sweep(rhs, accumulate):
        run(lib.nxfx_mf_sweep_scen, sched.n_levels, sched.levels.ctypes.data, n, plan.lam_len, S,
            dmf.groups_dev.data_ptr(), dmf.fronts.data_ptr(), n, rhs.data_ptr(),
            dmf.nodes_all.data_ptr(), dmf.bndpos_all.data_ptr(), dmf.xadd_ptr.data_ptr(),
            dmf.xadd.data_ptr(), dmf.lam_pos.data_ptr(), 0 if shared else dmf.fac_len,
            state.fac.data_ptr(), vl, vpools.data_ptr(), ys.data_ptr(), lam.data_ptr(),
            x.data_ptr(), int(accumulate), stream)

    sweep(rc, False)
    for _ in range(plan.n_refine):
        run(lib.nxfx_mf_terms_scen, P0, n, S, 0 if shared else state.vals.shape[-1],
            state.vals.data_ptr(), dmf.pci.data_ptr(), dmf.pcj.data_ptr(), x.data_ptr(),
            ti.data_ptr(), tj.data_ptr(), stream)
        si = fold.fold_apply_scenarios(ti, dmf.mv_fold_i)
        sj = fold.fold_apply_scenarios(tj, dmf.mv_fold_j)
        run(lib.nxfx_mf_residual_scen, n, S, n, rc.data_ptr(), s_dc, state.dc.data_ptr(),
            x.data_ptr(), dmf.mv_inv_i.data_ptr(), si.shape[1], si.data_ptr(),
            dmf.mv_inv_j.data_ptr(), sj.shape[1], sj.data_ptr(), r.data_ptr(), stream)
        sweep(r, True)
    run(lib.nxfx_mf_gate_scen, n, S, 0 if shared else 1, state.ok.data_ptr(), x.data_ptr(), stream)
    mf_apply_scenarios.launches += 1
    return x


mf_apply_scenarios.launches = 0
