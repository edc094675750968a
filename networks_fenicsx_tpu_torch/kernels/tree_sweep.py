"""K2 + K3 + K4: the level sweep of the blocked forest (``csrc/tree_sweep.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_blocked_forward_factor`` (K2,
``:2420-2450``), ``_blocked_forward_apply`` (K3, ``:2453-2481``) and
``_blocked_backward`` (K4, ``:2503-2517``) — together
``_blocked_eliminate``: assemble the per-bifurcation diagonal ``d`` and rhs
``r`` from the edge conductances, fold each level into its parents
bottom-up, back-substitute ``λ`` top-down, and report ``‖r‖`` over the
unfolded rhs for the convergence gate.

:func:`tree_sweep` launches the kernels for CUDA tensors and runs
:func:`tree_sweep_plain`, the eager transcription of the reference's
contiguous-slice program, for CPU tensors.  On the card the sweep is cut
by the device plan's :class:`..blocked.SweepPlan`: a launch of subtree
blocks folding the subtrees below the cut, one block for the top (its
fold, the norm, the roots and its back-substitution) and a launch of
subtree blocks back-substituting them — three launches a sweep
(:func:`cuda_launches`), whatever the depth.  :func:`tree_sweep_blocked_plain`
runs the same cut block by block from the plan's tables, and the norm in
the kernels' order: ``λ``, ``d``, ``r`` and ``wn`` equal
:func:`tree_sweep_plain`'s to the bit, the norm to roundoff.

The sharded blocked solve splits the sweep where its shards meet the top
forest: :func:`tree_sweep_forward` stops at level 0 and returns the folded
``(d, r, wn)`` with ``Σ r²`` (the reference's ``_blocked_forward``,
``:2486-2500``; the subtree launch and the top's fold), :func:`tree_sweep_backward`
back-substitutes levels 1.. from a level 0 the caller computes
(``_blocked_backward``; the top's back-substitution and the subtree
launch).  Both count on ``tree_sweep.launches``.

Factor reuse splits it by channel, as the reference's
``_blocked_forward_factor`` and ``_blocked_forward_apply``:
:func:`tree_sweep_factor` (K2) folds ``d`` alone and returns the folded
``d``, ``wn`` and ``factor = wn / d`` of every bifurcation (the subtree
launch and the top's: two launches); :func:`tree_sweep_apply` (K3–K4)
assembles ``r`` alone, folds it with the stored factor and back-substitutes
(three launches).  The full sweep forms ``factor·r`` from the same bits, so
the apply's ``λ`` is the full sweep's to the bit.  Their plain versions come
in both orders (``tree_sweep_factor_plain`` / ``tree_sweep_apply_plain``,
the reference's level by level, and ``…_blocked_plain``, the kernels'), and
each counts on its own ``launches`` and ``device``.

A sweep (:mod:`...batch`) runs S scenarios in the same launches:
:func:`tree_sweep_scenarios` is the full sweep of S rows of ``(w, const,
Ftot)`` (R varies by scenario), :func:`tree_sweep_apply_scenarios` the apply
of S right-hand sides on one stored factor; three launches each whatever S
(the scenario is one more grid dimension).  Row
``i`` is the one-scenario call's bits.  Their plain versions stack the
one-scenario plain versions, in the reference's order or (``blocked=True``)
the kernels'.

The blocked route's adjoint solves ``S z = ρ`` on the forward pass's stored
factor with :func:`tree_sweep_solve`: the apply's launches on ``const = 0``
and ``ρ`` placed at each bifurcation's in-edge (no kernel of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from ..blocked import DevicePlan, SweepPlan, _BlockedPlan
from . import build

__all__ = [
    "cuda_launches", "tree_sweep", "tree_sweep_plain", "tree_sweep_forward",
    "tree_sweep_forward_plain", "tree_sweep_backward", "tree_sweep_backward_plain",
    "tree_sweep_blocked_plain", "tree_sweep_forward_blocked_plain",
    "tree_sweep_backward_blocked_plain", "tree_sweep_factor", "tree_sweep_factor_plain",
    "tree_sweep_factor_blocked_plain", "tree_sweep_apply", "tree_sweep_apply_plain",
    "tree_sweep_apply_blocked_plain", "tree_sweep_scenarios", "tree_sweep_scenarios_plain",
    "tree_sweep_apply_scenarios", "tree_sweep_apply_scenarios_plain", "tree_sweep_solve",
    "tree_sweep_solve_plain",
]

FULL, FORWARD, BACKWARD, FACTOR, APPLY = 0, 1, 2, 3, 4  # nxfx_tree_sweep's modes


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


def _levels_of(plan: _BlockedPlan, v: torch.Tensor) -> list:
    """``v (B,)`` split into its levels' views."""
    return list(torch.split(v, np.diff(plan.bif_offsets).tolist()))


def tree_sweep_factor_plain(plan: _BlockedPlan, w: torch.Tensor):
    """Eager version of :func:`tree_sweep_factor` (the reference's
    ``_blocked_forward_factor``): ``(d, wn, factor)``, each (B,) in internal
    order, ``d`` folded and ``factor = wn / d`` (at a root too)."""
    L = len(plan.levels)
    d_lev: list = [None] * L
    wn_lev: list = [None] * L
    for l, lv in enumerate(plan.levels):
        w_in = _parts_concat(w, lv.in_parts)
        d = w_in
        for o, _ in lv.outs:
            d = d + w[o : o + lv.m]
        d_lev[l], wn_lev[l] = d, w_in
    for l in range(L - 1, 0, -1):
        m_par = plan.levels[l - 1].m
        nb = plan.levels[l - 1].n_bif_outs
        wn = wn_lev[l]
        cd = -wn * (wn / d_lev[l])
        upd_d = cd[:m_par]
        for j in range(1, nb):
            upd_d = upd_d + cd[j * m_par : (j + 1) * m_par]
        d_lev[l - 1] = d_lev[l - 1] + upd_d
    d, wn = torch.cat(d_lev), torch.cat(wn_lev)
    return d, wn, wn / d


def tree_sweep_apply_plain(plan: _BlockedPlan, d, wn, factor, const: torch.Tensor,
                           Ftot: torch.Tensor):
    """Eager version of :func:`tree_sweep_apply` (the reference's
    ``_blocked_forward_apply`` and ``_blocked_backward``): ``(lam, rhs_norm,
    r)``, ``r`` the folded rhs, from the factor's ``(d, wn, factor)``."""
    L = len(plan.levels)
    r_lev: list = [None] * L
    cF = const + Ftot
    for l, lv in enumerate(plan.levels):
        r = _parts_concat(cF, lv.in_parts)
        for o, _ in lv.outs:
            r = r - const[o : o + lv.m]
        r_lev[l] = r
    rhs_sq = sum(torch.sum(r * r) for r in r_lev)
    f_lev = _levels_of(plan, factor)
    for l in range(L - 1, 0, -1):
        m_par = plan.levels[l - 1].m
        nb = plan.levels[l - 1].n_bif_outs
        cr = f_lev[l] * r_lev[l]
        upd_r = cr[:m_par]
        for j in range(1, nb):
            upd_r = upd_r + cr[j * m_par : (j + 1) * m_par]
        r_lev[l - 1] = r_lev[l - 1] + upd_r
    d_lev, wn_lev = _levels_of(plan, d), _levels_of(plan, wn)
    lam = _backward_levels(plan, d_lev, r_lev, wn_lev, r_lev[0] / d_lev[0])
    return lam, torch.sqrt(rhs_sq), torch.cat(r_lev)


# --- the subtree-blocked order (the kernels'), from the sweep plan's tables ---


def _group_nodes(sp: SweepPlan, q0s: np.ndarray, gb: int) -> np.ndarray:
    """``(len(q0s), g_b·S)``: the nodes of the subtree blocks whose first
    subtrees are ``q0s``, each row in the block's local order (level by
    level, ``R_l`` runs of ``g_b`` positions at stride ``m_cut``)."""
    t, c = sp.host_levels, sp.cut
    mc = int(t[c, 1])
    parts = []
    for l in range(c, sp.num_levels):
        runs = np.arange(int(t[l, 3]))
        pos = runs[None, :, None] * mc + q0s[:, None, None] + np.arange(gb)[None, None, :]
        parts.append((int(t[l, 0]) + pos).reshape(len(q0s), -1))
    return np.concatenate(parts, axis=1)


def _block_groups(sp: SweepPlan) -> list:
    """``[(g_b, first block, nodes (n_blocks, g_b·S))]`` in block order: the
    full blocks, then a last one with fewer subtrees."""
    if not sp.blocks:
        return []
    mc = int(sp.host_levels[sp.cut, 1])
    full = mc // sp.group
    out = []
    if full:
        out.append((sp.group, 0, _group_nodes(sp, np.arange(full) * sp.group, sp.group)))
    if full < sp.blocks:
        q0 = full * sp.group
        out.append((mc - q0, full, _group_nodes(sp, np.asarray([q0]), mc - q0)))
    return out


def _lanes(x: torch.Tensor, threads: int, acc: torch.Tensor | None = None) -> torch.Tensor:
    """Each thread's strided sum of ``x (…, n)`` over the last axis
    (``threads`` lanes, entry ``i`` to lane ``i mod threads``, in order),
    continuing ``acc``."""
    n = x.shape[-1]
    pad = (-n) % threads
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    rows = x.reshape(x.shape[:-1] + (-1, threads))
    if acc is None:
        acc = x.new_zeros(x.shape[:-1] + (threads,))
    for k in range(rows.shape[-2]):
        acc = acc + rows[..., k, :]
    return acc


def _halving(acc: torch.Tensor) -> torch.Tensor:
    """The kernels' halving tree over the last axis (a power of two)."""
    acc = acc.clone()
    s = acc.shape[-1] // 2
    while s:
        acc[..., :s] = acc[..., :s] + acc[..., s : 2 * s]
        s //= 2
    return acc[..., 0]


def _assemble_d_plain(dplan: DevicePlan, w):
    """Every bifurcation's unfolded ``(d, wn)``, as each thread assembles it."""
    bif_in, bif_out = dplan.bif_in.long(), dplan.bif_out.long()
    wn = w[bif_in]
    d = wn
    for j in range(bif_out.shape[1]):
        oe = bif_out[:, j]
        ok = oe >= 0
        d = torch.where(ok, d + w[torch.where(ok, oe, torch.zeros_like(oe))], d)
    return d, wn


def _assemble_r_plain(dplan: DevicePlan, const, Ftot):
    """Every bifurcation's unfolded ``r``, as each thread assembles it."""
    bif_in, bif_out = dplan.bif_in.long(), dplan.bif_out.long()
    r = const[bif_in] + Ftot[bif_in]
    for j in range(bif_out.shape[1]):
        oe = bif_out[:, j]
        ok = oe >= 0
        r = torch.where(ok, r - const[torch.where(ok, oe, torch.zeros_like(oe))], r)
    return r


def _fold_blocks(sp: SweepPlan, d, r, wn, fac=None):
    """The subtree blocks' folds in place on ``d`` and ``r`` (block by block,
    in local order); each block's Σ r² partial (from ``r`` unfolded), in
    block order.  ``r`` None folds ``d`` alone; ``fac`` given folds ``r``
    alone with that factor (``d`` and ``wn`` unread)."""
    t, c, L = sp.host_levels, sp.cut, sp.num_levels
    dev = (r if d is None else d).device
    partials = []
    for gb, _, nodes in _block_groups(sp):
        idx = torch.as_tensor(nodes, device=dev)
        vd, vwn = (None, None) if fac is not None else (d[idx], wn[idx])
        vr = None if r is None else r[idx]
        vf = None if fac is None else fac[idx]
        if vr is not None:
            partials.append(_halving(_lanes(vr * vr, sp.threads)))
        for l in range(L - 2, c - 1, -1):
            R, nb = int(t[l, 3]), int(t[l, 2])
            i = np.arange(gb * R)
            run, j = i // gb, i % gb
            par = torch.as_tensor(gb * int(t[l, 4]) + i, device=dev)
            upd_d = upd_r = None
            for s in range(nb):
                ch = torch.as_tensor(gb * int(t[l + 1, 4]) + (s * R + run) * gb + j, device=dev)
                factor = vf[:, ch] if vf is not None else vwn[:, ch] / vd[:, ch]
                if vd is not None:
                    cd = -vwn[:, ch] * factor
                    upd_d = cd if s == 0 else upd_d + cd
                if vr is not None:
                    cr = factor * vr[:, ch]
                    upd_r = cr if s == 0 else upd_r + cr
            if vd is not None:
                vd[:, par] = vd[:, par] + upd_d
            if vr is not None:
                vr[:, par] = vr[:, par] + upd_r
        if vd is not None:
            d[idx] = vd
        if vr is not None:
            r[idx] = vr
    return torch.cat(partials) if partials else torch.zeros(0, dtype=torch.float64, device=dev)


def _top_fold(sp: SweepPlan, d, r, wn, fac=None) -> None:
    """The top's fold in place, level ``cut − 1`` up to the roots (channels
    as :func:`_fold_blocks`)."""
    t = sp.host_levels
    for l in range(sp.cut - 1, -1, -1):
        nb, m, off = int(t[l, 2]), int(t[l, 1]), int(t[l, 0])
        if nb == 0:
            continue
        off1 = int(t[l + 1, 0])
        upd_d = upd_r = None
        for s in range(nb):
            ch = slice(off1 + s * m, off1 + (s + 1) * m)
            factor = fac[ch] if fac is not None else wn[ch] / d[ch]
            if fac is None:
                cd = -wn[ch] * factor
                upd_d = cd if s == 0 else upd_d + cd
            if r is not None:
                cr = factor * r[ch]
                upd_r = cr if s == 0 else upd_r + cr
        if fac is None:
            d[off : off + m] = d[off : off + m] + upd_d
        if r is not None:
            r[off : off + m] = r[off : off + m] + upd_r


def _top_back(sp: SweepPlan, d, r, wn, lam, first: int) -> None:
    """The top's back-substitution into ``lam``, levels ``first … cut − 1``."""
    t = sp.host_levels
    for l in range(first, sp.cut):
        m, off = int(t[l, 1]), int(t[l, 0])
        s = slice(off, off + m)
        if l == 0:
            lam[s] = r[s] / d[s]
        else:
            mp, offp = int(t[l - 1, 1]), int(t[l - 1, 0])
            lp = lam[offp + torch.arange(m, device=lam.device) % mp]
            lam[s] = (r[s] + wn[s] * lp) / d[s]


def _back_blocks(sp: SweepPlan, dplan: DevicePlan, d, r, wn, lam, first: int) -> None:
    """The subtree blocks' back-substitution into ``lam`` from level
    ``max(cut, first)``, its parents' λ through ``bif_parent``."""
    t, c, L = sp.host_levels, sp.cut, sp.num_levels
    lf = max(c, first)
    parent = dplan.bif_parent.long()
    for gb, _, nodes in _block_groups(sp):
        idx = torch.as_tensor(nodes, device=d.device)
        vd, vr, vwn, vlam = d[idx], r[idx], wn[idx], lam[idx]
        for l in range(lf, L):
            R = int(t[l, 3])
            i = np.arange(gb * R)
            x = torch.as_tensor(gb * int(t[l, 4]) + i, device=d.device)
            if l == lf:
                p = parent[idx[:, x]]
                lp = lam[torch.where(p >= 0, p, torch.zeros_like(p))]
                v = torch.where(p < 0, vr[:, x] / vd[:, x], (vr[:, x] + vwn[:, x] * lp) / vd[:, x])
            else:
                run, j = i // gb, i % gb
                px = torch.as_tensor(gb * int(t[l - 1, 4]) + (run % int(t[l - 1, 3])) * gb + j,
                                     device=d.device)
                v = (vr[:, x] + vwn[:, x] * vlam[:, px]) / vd[:, x]
            vlam[:, x] = v
        lam[idx] = vlam


def _forward_blocked(dplan: DevicePlan, w, const, Ftot, d=None, wn=None, fac=None):
    """``(d, r, wn, Σ r²)`` folded down to level 0 in the kernels' order;
    with ``fac``, ``r`` alone folded with it (``d``, ``wn`` the factor's)."""
    sp = dplan.sweep
    if fac is None:
        d, wn = _assemble_d_plain(dplan, w)
        d = d.clone()
    r = _assemble_r_plain(dplan, const, Ftot).clone()
    r_top = r[: sp.top_nodes]
    partials = _fold_blocks(sp, d, r, wn, fac)
    acc = _lanes(r_top * r_top, sp.top_threads, _lanes(partials, sp.top_threads))
    _top_fold(sp, d, r, wn, fac)
    return d, r, wn, _halving(acc)


def tree_sweep_blocked_plain(dplan: DevicePlan, w: torch.Tensor, const: torch.Tensor,
                             Ftot: torch.Tensor):
    """:func:`tree_sweep_plain`'s ``(lam, rhs_norm, d, r, wn)`` in the
    kernels' order: the subtree blocks of ``dplan.sweep`` folded block by
    block from its tables, the top, its back-substitution and the blocks'."""
    d, r, wn, sq = _forward_blocked(dplan, w, const, Ftot)
    lam = torch.empty_like(d)
    _top_back(dplan.sweep, d, r, wn, lam, 0)
    _back_blocks(dplan.sweep, dplan, d, r, wn, lam, 0)
    return lam, torch.sqrt(sq), d, r, wn


def tree_sweep_forward_blocked_plain(dplan: DevicePlan, w, const, Ftot):
    """:func:`tree_sweep_forward` in the kernels' order: ``(d, r, wn, Σ r²)``."""
    return _forward_blocked(dplan, w, const, Ftot)


def tree_sweep_backward_blocked_plain(dplan: DevicePlan, d, r, wn, lam: torch.Tensor):
    """:func:`tree_sweep_backward` in the kernels' order: fills ``lam``'s
    levels 1.. in place from its level 0."""
    _top_back(dplan.sweep, d, r, wn, lam, 1)
    _back_blocks(dplan.sweep, dplan, d, r, wn, lam, 1)
    return lam


def tree_sweep_factor_blocked_plain(dplan: DevicePlan, w: torch.Tensor):
    """:func:`tree_sweep_factor_plain`'s ``(d, wn, factor)`` in the kernels'
    order (the subtree blocks' folds of ``d``, then the top's)."""
    sp = dplan.sweep
    d, wn = _assemble_d_plain(dplan, w)
    d = d.clone()
    _fold_blocks(sp, d, None, wn)
    _top_fold(sp, d, None, wn)
    return d, wn, wn / d


def tree_sweep_apply_blocked_plain(dplan: DevicePlan, d, wn, factor, const: torch.Tensor,
                                   Ftot: torch.Tensor):
    """:func:`tree_sweep_apply_plain`'s ``(lam, rhs_norm, r)`` in the kernels'
    order: ``λ`` equals :func:`tree_sweep_blocked_plain`'s to the bit."""
    _, r, _, sq = _forward_blocked(dplan, None, const, Ftot, d, wn, factor)
    lam = torch.empty_like(d)
    _top_back(dplan.sweep, d, r, wn, lam, 0)
    _back_blocks(dplan.sweep, dplan, d, r, wn, lam, 0)
    return lam, torch.sqrt(sq), r


# --- the launches ---


def cuda_launches(dplan: DevicePlan, mode: int = FULL) -> int:
    """CUDA kernel launches of one sweep (``FULL``, or ``APPLY`` on a stored
    factor) or part (``FORWARD``, ``BACKWARD``, ``FACTOR``) on ``dplan``:
    the subtree forward launch where the plan has subtree blocks, the top's
    (in the backward half only when the top holds more than level 0) and the
    subtree back launch (not in the forward half or the factor)."""
    sp = dplan.sweep
    if sp.num_levels == 0:
        return 0
    sub = int(sp.blocks > 0)
    if mode in (FULL, APPLY):
        return 2 * sub + 1
    if mode in (FORWARD, FACTOR):
        return sub + 1
    return sub + int(sp.cut >= 2)


def _launch(mode: int, dplan: DevicePlan, w, const, Ftot, d, r, wn, lam, out, fac=None,
            counter=None, S: int = 1, strides=(0, 0, 0, 0)) -> None:
    """One sweep or part; ``S`` scenarios with ``strides`` (elements a
    scenario of w; const and Ftot; d, wn and the factor; r and lam)."""
    sp = dplan.sweep
    dev = d.device
    partial = torch.empty(S * max(sp.blocks, 1), dtype=torch.float64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        code = build.library().nxfx_tree_sweep(
            mode, dplan.max_out, sp.num_levels, sp.cut, sp.group, sp.blocks, sp.threads,
            sp.block_nodes, int(sp.smem), sp.top_nodes, sp.top_threads, sp.levels.data_ptr(),
            dplan.bif_in.data_ptr(), dplan.bif_out.data_ptr(), dplan.bif_parent.data_ptr(),
            ptr(w), ptr(const), ptr(Ftot), ptr(d), ptr(r), ptr(wn), ptr(lam), ptr(fac),
            partial.data_ptr(), ptr(out), S, *strides, build.stream_handle(dev),
        )
    if code < 0:
        build.check(-code, "tree_sweep")
    if code != cuda_launches(dplan, mode):
        raise RuntimeError(f"tree_sweep: {code} launches, the plan counts {cuda_launches(dplan, mode)}")
    counter = counter or tree_sweep
    counter.launches += 1
    counter.device += code


def _check(dplan: DevicePlan, *vecs):
    build.require_cuda("tree_sweep", *vecs)
    build.require_cuda(
        "tree_sweep", dplan.bif_in, dplan.bif_out, dplan.bif_parent, dplan.sweep.levels,
        dtype=torch.int32,
    )


def tree_sweep(dplan: DevicePlan, w: torch.Tensor, const: torch.Tensor, Ftot: torch.Tensor):
    """K2–K4 on ``w``'s device: ``(lam, rhs_norm, d, r, wn)``."""
    if w.device.type == "cpu":
        return tree_sweep_plain(dplan.plan, w, const, Ftot)
    _check(dplan, w, const, Ftot)
    B, E = dplan.num_bifurcations, dplan.num_edges
    if any(tuple(t.shape) != (E,) for t in (w, const, Ftot)):
        raise ValueError("tree_sweep: w, const and Ftot must be (E,)")
    dev = w.device
    d, r, wn, lam = (torch.empty(B, dtype=torch.float64, device=dev) for _ in range(4))
    rhs_norm = torch.empty((), dtype=torch.float64, device=dev)
    if B:
        _launch(FULL, dplan, w, const, Ftot, d, r, wn, lam, rhs_norm)
    return lam, rhs_norm, d, r, wn


tree_sweep.launches = 0  # wrapper calls that launched (the three wrappers')
tree_sweep.device = 0  # the kernels they enqueued, as the launcher reports them


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
    if B:
        _launch(FORWARD, dplan, w, const, Ftot, d, r, wn, None, rhs_sq)
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
    if cuda_launches(dplan, BACKWARD):
        _launch(BACKWARD, dplan, None, None, None, d, r, wn, lam, None)
    return lam


def tree_sweep_factor(dplan: DevicePlan, w: torch.Tensor):
    """K2 on ``w``'s device: ``(d, wn, factor)``, each (B,) in internal order —
    the folded diagonal, the in-edge conductances and ``wn / d``, what
    :func:`tree_sweep_apply` reads for every right-hand side."""
    if w.device.type == "cpu":
        return tree_sweep_factor_plain(dplan.plan, w)
    _check(dplan, w)
    B, E = dplan.num_bifurcations, dplan.num_edges
    if tuple(w.shape) != (E,):
        raise ValueError("tree_sweep_factor: w must be (E,)")
    d, wn, fac = (torch.empty(B, dtype=torch.float64, device=w.device) for _ in range(3))
    if B:
        _launch(FACTOR, dplan, w, None, None, d, None, wn, None, None, fac=fac,
                counter=tree_sweep_factor)
    return d, wn, fac


tree_sweep_factor.launches = 0
tree_sweep_factor.device = 0


def tree_sweep_apply(dplan: DevicePlan, d: torch.Tensor, wn: torch.Tensor, factor: torch.Tensor,
                     const: torch.Tensor, Ftot: torch.Tensor):
    """K3–K4 on ``const``'s device from :func:`tree_sweep_factor`'s ``(d, wn,
    factor)``: ``(lam, rhs_norm, r)``, ``r`` the folded rhs (B,)."""
    if const.device.type == "cpu":
        return tree_sweep_apply_plain(dplan.plan, d, wn, factor, const, Ftot)
    _check(dplan, d, wn, factor, const, Ftot)
    B, E = dplan.num_bifurcations, dplan.num_edges
    if any(tuple(t.shape) != (B,) for t in (d, wn, factor)) or any(
            tuple(t.shape) != (E,) for t in (const, Ftot)):
        raise ValueError("tree_sweep_apply: d, wn, factor must be (B,) and const, Ftot (E,)")
    dev = const.device
    r, lam = (torch.empty(B, dtype=torch.float64, device=dev) for _ in range(2))
    rhs_norm = torch.empty((), dtype=torch.float64, device=dev)
    if B:
        _launch(APPLY, dplan, None, const, Ftot, d, r, wn, lam, rhs_norm, fac=factor,
                counter=tree_sweep_apply)
    return lam, rhs_norm, r


tree_sweep_apply.launches = 0
tree_sweep_apply.device = 0


def _zero_const(dplan: DevicePlan, like: torch.Tensor) -> torch.Tensor:
    """A zero ``const (E,)`` on ``like``'s device, kept on the plan."""
    key = ("zero_const", like.device)
    zero = dplan._scratch.get(key)
    if zero is None:
        zero = dplan._scratch[key] = torch.zeros(dplan.num_edges, dtype=torch.float64,
                                                 device=like.device)
    return zero


def tree_sweep_solve_plain(dplan: DevicePlan, d, wn, factor, rhs_edges: torch.Tensor):
    """Eager version of :func:`tree_sweep_solve` (the reference's order)."""
    return tree_sweep_apply_plain(dplan.plan, d, wn, factor, _zero_const(dplan, rhs_edges),
                                  rhs_edges)[0]


def tree_sweep_solve(dplan: DevicePlan, d, wn, factor, rhs_edges: torch.Tensor) -> torch.Tensor:
    """``S⁻¹ ρ`` on :func:`tree_sweep_factor`'s stored factor, through
    :func:`tree_sweep_apply`'s launches (K3–K4): the apply assembles ``r_b =
    const[in_b] + Ftot[in_b] - Σ const[out_b]``, so with ``const = 0`` and
    ``rhs_edges (E,)`` holding ``ρ_b`` at each bifurcation's in-edge (0
    elsewhere) it solves for ``ρ``.  The adjoint λ solve of the blocked
    route (``rhs_edges`` from :func:`.expand.expand_vjp_fold`)."""
    return tree_sweep_apply(dplan, d, wn, factor, _zero_const(dplan, rhs_edges), rhs_edges)[0]


# --- the scenario axis (a sweep's S rows in the same launches) ---


def tree_sweep_scenarios_plain(dplan: DevicePlan, w: torch.Tensor, const: torch.Tensor,
                               Ftot: torch.Tensor, blocked: bool = False):
    """Eager version of :func:`tree_sweep_scenarios`: :func:`tree_sweep_plain`
    (or, ``blocked``, :func:`tree_sweep_blocked_plain`) a row, stacked."""
    rows = [tree_sweep_blocked_plain(dplan, *row) if blocked else tree_sweep_plain(dplan.plan, *row)
            for row in zip(w, const, Ftot)]
    return tuple(torch.stack(col) for col in zip(*rows))


def _scenario_rows(name: str, dplan: DevicePlan, *rows: torch.Tensor) -> int:
    """S of ``rows``, each ``(S, E)``."""
    S, E = rows[0].shape[0], dplan.num_edges
    if any(tuple(t.shape) != (S, E) for t in rows):
        raise ValueError(f"{name}: the rows must be (S, {E}) alike, got "
                         f"{[tuple(t.shape) for t in rows]}")
    return S


def tree_sweep_scenarios(dplan: DevicePlan, w: torch.Tensor, const: torch.Tensor,
                         Ftot: torch.Tensor):
    """K2–K4 of S scenarios on ``w``'s device, ``w``, ``const``, ``Ftot`` each
    ``(S, E)``: ``(lam, rhs_norm, d, r, wn)``, each with a leading ``S``;
    :func:`cuda_launches` launches whatever S."""
    if w.device.type == "cpu":
        return tree_sweep_scenarios_plain(dplan, w, const, Ftot)
    _check(dplan, w, const, Ftot)
    S = _scenario_rows("tree_sweep_scenarios", dplan, w, const, Ftot)
    E, B = dplan.num_edges, dplan.num_bifurcations
    dev = w.device
    d, r, wn, lam = (torch.empty((S, B), dtype=torch.float64, device=dev) for _ in range(4))
    rhs_norm = torch.empty(S, dtype=torch.float64, device=dev)
    if B:
        _launch(FULL, dplan, w, const, Ftot, d, r, wn, lam, rhs_norm,
                counter=tree_sweep_scenarios, S=S, strides=(E, E, B, B))
    return lam, rhs_norm, d, r, wn


tree_sweep_scenarios.launches = 0
tree_sweep_scenarios.device = 0


def tree_sweep_apply_scenarios_plain(dplan: DevicePlan, d, wn, factor, const: torch.Tensor,
                                     Ftot: torch.Tensor, blocked: bool = False):
    """Eager version of :func:`tree_sweep_apply_scenarios`:
    :func:`tree_sweep_apply_plain` (or, ``blocked``,
    :func:`tree_sweep_apply_blocked_plain`) a row, stacked."""
    rows = [tree_sweep_apply_blocked_plain(dplan, d, wn, factor, c, F) if blocked
            else tree_sweep_apply_plain(dplan.plan, d, wn, factor, c, F)
            for c, F in zip(const, Ftot)]
    return tuple(torch.stack(col) for col in zip(*rows))


def tree_sweep_apply_scenarios(dplan: DevicePlan, d: torch.Tensor, wn: torch.Tensor,
                               factor: torch.Tensor, const: torch.Tensor, Ftot: torch.Tensor):
    """K3–K4 of S right-hand sides on ``const``'s device, ``const`` and ``Ftot``
    each ``(S, E)``, on one stored factor of :func:`tree_sweep_factor`
    (``d``, ``wn``, ``factor``, each ``(B,)``, read by every scenario):
    ``(lam, rhs_norm, r)``, each with a leading ``S``; three launches
    whatever S."""
    if const.device.type == "cpu":
        return tree_sweep_apply_scenarios_plain(dplan, d, wn, factor, const, Ftot)
    _check(dplan, d, wn, factor, const, Ftot)
    S = _scenario_rows("tree_sweep_apply_scenarios", dplan, const, Ftot)
    E, B = dplan.num_edges, dplan.num_bifurcations
    if any(tuple(t.shape) != (B,) for t in (d, wn, factor)):
        raise ValueError("tree_sweep_apply_scenarios: d, wn and factor must be (B,)")
    dev = const.device
    r, lam = (torch.empty((S, B), dtype=torch.float64, device=dev) for _ in range(2))
    rhs_norm = torch.empty(S, dtype=torch.float64, device=dev)
    if B:
        _launch(APPLY, dplan, None, const, Ftot, d, r, wn, lam, rhs_norm, fac=factor,
                counter=tree_sweep_apply_scenarios, S=S, strides=(0, E, 0, B))
    return lam, rhs_norm, r


tree_sweep_apply_scenarios.launches = 0
tree_sweep_apply_scenarios.device = 0
