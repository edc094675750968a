"""K2 + K3 + K4: the level sweep of the blocked forest (``csrc/tree_sweep.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_blocked_forward_factor`` (K2,
``:2420-2450``), ``_blocked_forward_apply`` (K3, ``:2453-2481``) and
``_blocked_backward`` (K4, ``:2503-2517``) — together
``_blocked_eliminate``: assemble the per-bifurcation diagonal ``d`` and rhs
``r`` from the edge conductances, fold each level into its parents
bottom-up, back-substitute ``λ`` top-down, and report ``‖r‖`` over the
unfolded rhs for the convergence gate.

:func:`tree_sweep` launches the kernels for CUDA tensors (one launch per
level for the fold and the back-substitution: the sweep is bound by launch
latency, not bytes) and runs :func:`tree_sweep_plain`, the eager
transcription of the reference's contiguous-slice program, for CPU tensors.

The sharded blocked solve splits the sweep where its shards meet the top
forest: :func:`tree_sweep_forward` stops at level 0 and returns the folded
``(d, r, wn)`` with ``Σ r²`` (the reference's ``_blocked_forward``,
``:2486-2500``), :func:`tree_sweep_backward` back-substitutes levels 1.. from
a level 0 the caller computes (``_blocked_backward``).  Both count on
``tree_sweep.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..blocked import DevicePlan, _BlockedPlan
from . import build

__all__ = [
    "tree_sweep", "tree_sweep_plain", "tree_sweep_forward", "tree_sweep_forward_plain",
    "tree_sweep_backward", "tree_sweep_backward_plain",
]


def _parts_concat(vec: torch.Tensor, parts) -> torch.Tensor:
    ps = [vec[s : s + width] for s, width in parts]
    return ps[0] if len(ps) == 1 else torch.cat(ps)


def _forward_levels(plan: _BlockedPlan, w: torch.Tensor, const: torch.Tensor, Ftot: torch.Tensor):
    """Per-level ``(d, r, wn)`` folded down to level 0, and ``Σ r²`` over the
    unfolded ``r``."""
    L = len(plan.levels)
    d_lev: list = [None] * L
    wn_lev: list = [None] * L
    r_lev: list = [None] * L
    cF = const + Ftot
    for l, lv in enumerate(plan.levels):
        w_in = _parts_concat(w, lv.in_parts)
        d = w_in
        r = _parts_concat(cF, lv.in_parts)
        for o, _ in lv.outs:
            d = d + w[o : o + lv.m]
            r = r - const[o : o + lv.m]
        d_lev[l], wn_lev[l], r_lev[l] = d, w_in, r
    rhs_sq = sum(torch.sum(r * r) for r in r_lev)
    for l in range(L - 1, 0, -1):
        m_par = plan.levels[l - 1].m
        nb = plan.levels[l - 1].n_bif_outs
        wn = wn_lev[l]
        factor = wn / d_lev[l]
        cd = -wn * factor
        cr = factor * r_lev[l]
        upd_d = cd[:m_par]
        upd_r = cr[:m_par]
        for j in range(1, nb):
            upd_d = upd_d + cd[j * m_par : (j + 1) * m_par]
            upd_r = upd_r + cr[j * m_par : (j + 1) * m_par]
        d_lev[l - 1] = d_lev[l - 1] + upd_d
        r_lev[l - 1] = r_lev[l - 1] + upd_r
    return d_lev, r_lev, wn_lev, rhs_sq


def _backward_levels(plan: _BlockedPlan, d_lev, r_lev, wn_lev, lam0: torch.Tensor):
    """λ level by level, root down, from level 0's ``lam0``."""
    L = len(plan.levels)
    lam_lev: list = [None] * L
    lam_lev[0] = lam0
    for l in range(1, L):
        nb = plan.levels[l - 1].n_bif_outs
        lp_ = lam_lev[l - 1]
        lam_par = lp_ if nb == 1 else torch.cat([lp_] * nb)
        lam_lev[l] = (r_lev[l] + wn_lev[l] * lam_par) / d_lev[l]
    return torch.cat(lam_lev)


def tree_sweep_plain(
    plan: _BlockedPlan, w: torch.Tensor, const: torch.Tensor, Ftot: torch.Tensor
):
    """Eager version: returns ``(lam, rhs_norm, d, r, wn)``, the last three
    being the folded per-bifurcation diagonal, rhs and in-edge conductance
    the back-substitution reads (all (B,), internal order)."""
    d_lev, r_lev, wn_lev, rhs_sq = _forward_levels(plan, w, const, Ftot)
    lam = _backward_levels(plan, d_lev, r_lev, wn_lev, r_lev[0] / d_lev[0])
    return (
        lam,
        torch.sqrt(rhs_sq),
        torch.cat(d_lev),
        torch.cat(r_lev),
        torch.cat(wn_lev),
    )


def tree_sweep_forward_plain(
    plan: _BlockedPlan, w: torch.Tensor, const: torch.Tensor, Ftot: torch.Tensor
):
    """Eager version of :func:`tree_sweep_forward`: ``(d, r, wn, Σ r²)``."""
    d_lev, r_lev, wn_lev, rhs_sq = _forward_levels(plan, w, const, Ftot)
    return torch.cat(d_lev), torch.cat(r_lev), torch.cat(wn_lev), rhs_sq


def tree_sweep_backward_plain(plan: _BlockedPlan, d, r, wn, lam: torch.Tensor):
    """Eager version of :func:`tree_sweep_backward`: fills ``lam``'s levels
    1.. in place from its level 0 and returns it."""
    offs = [int(o) for o in plan.bif_offsets]
    for l in range(1, len(plan.levels)):
        nb = plan.levels[l - 1].n_bif_outs
        lp_ = lam[offs[l - 1] : offs[l]]
        lam_par = lp_ if nb == 1 else torch.cat([lp_] * nb)
        o, o1 = offs[l], offs[l + 1]
        lam[o:o1] = (r[o:o1] + wn[o:o1] * lam_par) / d[o:o1]
    return lam


def tree_sweep(dplan: DevicePlan, w: torch.Tensor, const: torch.Tensor, Ftot: torch.Tensor):
    """K2–K4 on ``w``'s device: ``(lam, rhs_norm, d, r, wn)``."""
    if w.device.type == "cpu":
        return tree_sweep_plain(dplan.plan, w, const, Ftot)
    build.require_cuda("tree_sweep", w, const, Ftot)
    build.require_cuda(
        "tree_sweep", dplan.bif_in, dplan.bif_out, dplan.bif_child, dplan.bif_parent,
        dtype=torch.int32,
    )
    B, E = dplan.num_bifurcations, dplan.num_edges
    if any(tuple(t.shape) != (E,) for t in (w, const, Ftot)):
        raise ValueError("tree_sweep: w, const and Ftot must be (E,)")
    dev = w.device
    d, r, wn, lam = (torch.empty(B, dtype=torch.float64, device=dev) for _ in range(4))
    rhs_norm = torch.empty((), dtype=torch.float64, device=dev)
    offs = dplan.level_offsets
    offsets = (ctypes.c_longlong * len(offs))(*offs)
    with torch.cuda.device(dev):
        code = build.library().nxfx_tree_sweep(
            B, dplan.max_out, len(offs) - 1, ctypes.cast(offsets, ctypes.c_void_p),
            dplan.bif_in.data_ptr(), dplan.bif_out.data_ptr(),
            dplan.bif_child.data_ptr(), dplan.bif_parent.data_ptr(),
            w.data_ptr(), const.data_ptr(), Ftot.data_ptr(),
            d.data_ptr(), r.data_ptr(), wn.data_ptr(), lam.data_ptr(), rhs_norm.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "tree_sweep")
    tree_sweep.launches += 1
    return lam, rhs_norm, d, r, wn


tree_sweep.launches = 0


def _check(dplan: DevicePlan, *vecs):
    build.require_cuda("tree_sweep", *vecs)
    build.require_cuda(
        "tree_sweep", dplan.bif_in, dplan.bif_out, dplan.bif_child, dplan.bif_parent,
        dtype=torch.int32,
    )


def _offsets(dplan: DevicePlan):
    offs = dplan.level_offsets
    return (ctypes.c_longlong * len(offs))(*offs)


def tree_sweep_forward(dplan: DevicePlan, w: torch.Tensor, const: torch.Tensor, Ftot: torch.Tensor):
    """K2–K3 on ``w``'s device down to level 0: ``(d, r, wn, Σ r²)``, the
    first three (B,) in internal order (level 0 first)."""
    if w.device.type == "cpu":
        return tree_sweep_forward_plain(dplan.plan, w, const, Ftot)
    _check(dplan, w, const, Ftot)
    B = dplan.num_bifurcations
    if any(t.dim() != 1 or t.shape[0] < dplan.num_edges for t in (w, const, Ftot)):
        raise ValueError("tree_sweep: w, const and Ftot must cover the plan's edges")
    dev = w.device
    d, r, wn = (torch.empty(B, dtype=torch.float64, device=dev) for _ in range(3))
    rhs_sq = torch.empty((), dtype=torch.float64, device=dev)
    offsets = _offsets(dplan)
    with torch.cuda.device(dev):
        code = build.library().nxfx_tree_sweep_forward(
            B, dplan.max_out, len(offsets) - 1, ctypes.cast(offsets, ctypes.c_void_p),
            dplan.bif_in.data_ptr(), dplan.bif_out.data_ptr(), dplan.bif_child.data_ptr(),
            w.data_ptr(), const.data_ptr(), Ftot.data_ptr(),
            d.data_ptr(), r.data_ptr(), wn.data_ptr(), rhs_sq.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "tree_sweep")
    tree_sweep.launches += 1
    return d, r, wn, rhs_sq


def tree_sweep_backward(dplan: DevicePlan, d, r, wn, lam: torch.Tensor):
    """K4 on ``d``'s device: fills levels 1.. of ``lam`` (its first B entries,
    internal order) in place from its level 0, which the caller has
    written; returns ``lam``."""
    if d.device.type == "cpu":
        return tree_sweep_backward_plain(dplan.plan, d, r, wn, lam)
    _check(dplan, d, r, wn, lam)
    B = dplan.num_bifurcations
    if any(tuple(t.shape) != (B,) for t in (d, r, wn)) or lam.dim() != 1 or lam.shape[0] < B:
        raise ValueError("tree_sweep: d, r, wn must be (B,) and lam at least (B,)")
    offsets = _offsets(dplan)
    with torch.cuda.device(d.device):
        code = build.library().nxfx_tree_sweep_backward(
            B, len(offsets) - 1, ctypes.cast(offsets, ctypes.c_void_p),
            dplan.bif_parent.data_ptr(), d.data_ptr(), r.data_ptr(), wn.data_ptr(),
            lam.data_ptr(), build.stream_handle(d.device),
        )
    build.check(code, "tree_sweep")
    tree_sweep.launches += 1
    return lam
