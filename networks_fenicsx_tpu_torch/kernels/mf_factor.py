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

:func:`mf_factor` launches the kernels for CUDA tensors (one launch per
group, from one C loop) and runs :func:`mf_factor_plain` for CPU tensors.
"""

from __future__ import annotations

import typing

import torch

from ..ops.multifrontal import (
    G_B, G_C, G_CVAL, G_FAC, G_K, G_NODES, G_POOL, G_VPOOL, G_W, DeviceMFPlan,
)
from . import build

__all__ = ["MFState", "front_factor_plain", "mf_factor", "mf_factor_plain", "group_views"]


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


def mf_factor_plain(dmf: DeviceMFPlan, dc: torch.Tensor, w_pairs: torch.Tensor) -> MFState:
    """Eager version, batched per group with PyTorch's float64 Cholesky
    and triangular solve."""
    dt, dev = torch.float64, dc.device
    plan = dmf.plan
    vals = torch.cat([-w_pairs[dmf.init_slot.long()], torch.zeros(1, dtype=dt, device=dev)])
    dc_ext = torch.cat([dc, torch.ones(1, dtype=dt, device=dev)])
    fac = torch.zeros(dmf.fac_len, dtype=dt, device=dev)
    pools = torch.zeros(dmf.pool_len, dtype=dt, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for gi, g in enumerate(plan.groups):
        k, w, b, c, m, nodes, cval, ccol = group_views(dmf, gi)
        S = torch.zeros((k, w, m + 1), dtype=dt, device=dev)  # column m: the pads
        S.scatter_(2, ccol.long(), vals[cval.long()])
        F = torch.zeros((k, m, m), dtype=dt, device=dev)
        F[:, :w, :] = S[:, :, :m]
        F[:, w:, :w] = S[:, :, w:m].transpose(1, 2)
        ar = torch.arange(w, device=dev)
        F[:, ar, ar] = F[:, ar, ar] + dc_ext[nodes.long()]
        ark = torch.arange(k, device=dev)[:, None, None]
        for cg, cidx_off, lminv_off in g.consume:
            Upad = _child_pool(dmf, pools, cg, 2)
            cidx = dmf.cidx_all[cidx_off : cidx_off + k].long()
            lminv = dmf.lminv_all[lminv_off : lminv_off + k * m].view(k, m).long()
            Us = Upad[cidx]
            F = F + Us[ark, lminv[:, :, None], lminv[:, None, :]]
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


def mf_factor(dmf: DeviceMFPlan, dc: torch.Tensor, w_pairs: torch.Tensor) -> MFState:
    """K13 + K14 on ``dc``'s device: the factor of the core with peeled
    diagonal ``dc (n_core,)`` and pair conductances ``w_pairs (P,)``."""
    if dc.device.type == "cpu":
        return mf_factor_plain(dmf, dc, w_pairs)
    build.require_cuda("mf_factor", dc, w_pairs)
    build.require_cuda(
        "mf_factor", dmf.init_slot, dmf.nodes_all, dmf.cval_all, dmf.ccol_all, dmf.cidx_all,
        dmf.lminv_all, dtype=torch.int32,
    )
    build.require_cuda("mf_factor", dmf.consume, dtype=torch.int64)
    plan = dmf.plan
    if tuple(dc.shape) != (plan.n_core,):
        raise ValueError("mf_factor: dc must be (n_core,)")
    dev, dt = dc.device, torch.float64
    P0 = plan.n_pairs
    vals = torch.empty(P0 + 1, dtype=dt, device=dev)
    fac = torch.empty(dmf.fac_len, dtype=dt, device=dev)
    pools = torch.empty(max(dmf.pool_len, 1), dtype=dt, device=dev)
    ok = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_mf_factor(
            len(plan.groups), dmf.groups.ctypes.data, dmf.consume.data_ptr(), plan.n_core, P0,
            dmf.init_slot.data_ptr(), w_pairs.data_ptr(), dc.data_ptr(),
            dmf.nodes_all.data_ptr(), dmf.cval_all.data_ptr(), dmf.ccol_all.data_ptr(),
            dmf.cidx_all.data_ptr(), dmf.lminv_all.data_ptr(),
            vals.data_ptr(), fac.data_ptr(), pools.data_ptr(), ok.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "mf_factor")
    mf_factor.launches += 1
    return MFState(fac, pools[: dmf.pool_len], vals, ok, dc)


mf_factor.launches = 0
