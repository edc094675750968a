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
loop of 2 launches per group and a gather; per refinement pass, a terms
pass, two K10 folds and a residual pass) and runs :func:`mf_apply_plain`
for CPU tensors.
"""

from __future__ import annotations

import torch

from ..ops.multifrontal import G_BNDPOS, G_FAC, G_LAM, G_VPOOL, DeviceMFPlan
from . import build, fold
from .mf_factor import MFState, _child_pool, group_views

__all__ = ["mf_apply", "mf_apply_plain", "cuda_launches"]


def cuda_launches(dmf: DeviceMFPlan) -> int:
    """CUDA kernel launches of one :func:`mf_apply` call (the K10 folds
    included): ``(1 + n_refine)`` sweeps of ``2 G + 1``, per refinement
    pass a terms pass, the fold levels and a residual pass, and the gate."""
    G = len(dmf.plan.groups)
    per_pass = 2 + len(dmf.mv_fold_i) + len(dmf.mv_fold_j)
    n = dmf.plan.n_refine
    return (1 + n) * (2 * G + 1) + n * per_pass + 1


def _sweep_plain(dmf: DeviceMFPlan, state: MFState, rhs: torch.Tensor) -> torch.Tensor:
    """One multifrontal solve of the core, batched per group."""
    dt, dev = torch.float64, rhs.device
    plan = dmf.plan
    ys = torch.zeros(plan.lam_len, dtype=dt, device=dev)
    vpools = torch.zeros(dmf.vpool_len, dtype=dt, device=dev)
    rc_ext = torch.cat([rhs, torch.zeros(1, dtype=dt, device=dev)])
    blocks = []
    for gi, g in enumerate(plan.groups):
        k, w, b, _, m, nodes, _, _ = group_views(dmf, gi)
        row = dmf.groups[gi]
        fo = int(row[G_FAC])
        blk = state.fac[fo : fo + k * m * m].view(k, m, m)
        L, Yt = blk[:, :w, :w], blk[:, w:, :w]
        blocks.append((L, Yt))
        bv = torch.cat([rc_ext[nodes.long()], torch.zeros((k, b), dtype=dt, device=dev)], dim=1)
        ark = torch.arange(k, device=dev)[:, None]
        for cg, cidx_off, lminv_off in g.consume:
            Vpad = _child_pool(dmf, vpools, cg, 1)
            cidx = dmf.cidx_all[cidx_off : cidx_off + k].long()
            lminv = dmf.lminv_all[lminv_off : lminv_off + k * m].view(k, m).long()
            bv = bv + Vpad[cidx][ark, lminv]
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
        "mf_apply", dmf.nodes_all, dmf.bndpos_all, dmf.cidx_all, dmf.lminv_all, dmf.lam_pos,
        dmf.pci, dmf.pcj, dmf.mv_inv_i, dmf.mv_inv_j, dtype=torch.int32,
    )
    plan = dmf.plan
    n, P0, G = plan.n_core, plan.n_pairs, len(plan.groups)
    if tuple(rc.shape) != (n,) or tuple(state.fac.shape) != (dmf.fac_len,):
        raise ValueError("mf_apply: rc must be (n_core,) and the state this plan's")
    dev, dt = rc.device, torch.float64
    lib = build.library()
    stream = build.stream_handle(dev)
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
                G, dmf.groups.ctypes.data, dmf.consume.data_ptr(), n, plan.lam_len,
                rhs.data_ptr(), dmf.nodes_all.data_ptr(), dmf.bndpos_all.data_ptr(),
                dmf.cidx_all.data_ptr(), dmf.lminv_all.data_ptr(), dmf.lam_pos.data_ptr(),
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
