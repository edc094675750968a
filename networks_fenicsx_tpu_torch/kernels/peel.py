"""K9: the peel rounds of a cyclic bifurcation graph (``csrc/peel.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_tree_eliminate_factor`` and
``_tree_eliminate_apply`` (``:3678-3812``) around the core solve, and the
assembly of the bifurcation system, ``_lambda_system_sorted``
(``:700-737``).

* :func:`lambda_system` — per-edge conductances and rhs terms (prepare
  kernel), their sums into each side's sorted unique bifurcations (K6, one
  :func:`.segsum.segsum_plan` launch on the plan's ``lambda_sums``, each
  row written once) and ``‖rhs‖``; returns the
  interleaved ``dr (B, 2)`` (diagonal, rhs), ``w (E,) = 1/W`` and the norm.
* :func:`peel` — forward through the rounds (per round: the terms
  ``(−w·factor, factor·r)`` of its eliminated nodes, their K10 fold into
  the round's unique parents, the add into those parents), the core solve
  ``solve_core(d_core, r_core) -> λ_core`` the caller passes, then the
  back-substitution ``λ_e = (r_e + w λ_parent) / d_e`` in reverse.  The
  diagonal and rhs rounds of the reference run as one two-channel pass:
  the sums are the same.

Each wrapper launches its kernels for CUDA tensors and runs its plain
version, an eager transcription of the reference, for CPU tensors.
"""

from __future__ import annotations

import typing

import torch

from ..edge_data import _EdgeData
from . import build, fold, segsum
from .level_eliminate import _prepare_plain

__all__ = ["lambda_system", "lambda_system_plain", "lambda_sums", "peel", "peel_plain"]

CoreSolve = typing.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def lambda_sums(plan) -> segsum.SumPlan:
    """The K6 plan of a device plan's bifurcation system: the target side's
    and then the source side's ``(diag, rhs)`` sums into one ``(B, 2)``
    output, in the order the reference's ``_lambda_system_sorted`` adds them."""
    return segsum.SumPlan(((plan.t_idx, plan.t_bins), (plan.s_idx, plan.s_bins)), (2, 2),
                          rows=plan.num_bifurcations)


def lambda_system_plain(dtp, ed: _EdgeData):
    """Eager version: ``(dr (B, 2), w (E,), ‖rhs‖)``."""
    w_edges, vt, vs = _prepare_plain(ed)
    dr = torch.zeros((dtp.num_bifurcations, 2), dtype=torch.float64, device=ed.W.device)
    segsum.segsum_plain(dtp.t_idx, vt, dtp.t_bins, dr)
    segsum.segsum_plain(dtp.s_idx, vs, dtp.s_bins, dr)
    return dr, w_edges, torch.linalg.norm(dr[:, 1])


def lambda_system(dtp, ed: _EdgeData):
    """The bifurcation system on the edge data's device (see module docs)."""
    if ed.W.device.type == "cpu":
        return lambda_system_plain(dtp, ed)
    Ftot = ed.cumF[-1]
    build.require_cuda("lambda_system", ed.W, ed.g, Ftot, ed.start_pbc, ed.end_pbc)
    build.require_cuda("lambda_system", dtp.start_bif, dtp.end_bif, dtype=torch.int32)
    E, B = dtp.num_edges, dtp.num_bifurcations
    if any(tuple(t.shape) != (E,) for t in (ed.W, ed.g, Ftot, ed.start_pbc, ed.end_pbc)):
        raise ValueError("lambda_system: the edge data must be (E,) per edge")
    dev, dt = ed.W.device, torch.float64
    w_edges = torch.empty(E, dtype=dt, device=dev)
    vt = torch.empty((E, 2), dtype=dt, device=dev)
    vs = torch.empty((E, 2), dtype=dt, device=dev)
    lib = build.library()
    stream = build.stream_handle(dev)
    with torch.cuda.device(dev):
        code = lib.nxfx_lambda_prepare(
            E, ed.W.data_ptr(), ed.g.data_ptr(), Ftot.data_ptr(),
            ed.start_pbc.data_ptr(), ed.end_pbc.data_ptr(),
            dtp.start_bif.data_ptr(), dtp.end_bif.data_ptr(),
            w_edges.data_ptr(), vt.data_ptr(), vs.data_ptr(), stream,
        )
    build.check(code, "lambda_system")
    dr, = segsum.segsum_plan(dtp.lambda_sums, vt, vs)
    rhs_norm = torch.empty((), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = lib.nxfx_rhs_norm(B, dr.data_ptr(), rhs_norm.data_ptr(), stream)
    build.check(code, "lambda_system")
    lambda_system.launches += 1
    return dr, w_edges, rhs_norm


lambda_system.launches = 0


def peel_plain(dtp, dr: torch.Tensor, w_pairs: torch.Tensor, solve_core: CoreSolve):
    """Eager version: returns ``λ (B,)``; ``dr`` is not modified."""
    dt, dev = torch.float64, dr.device
    d = dr[:, 0].clone()
    r = dr[:, 1].clone()
    saved = []
    for rd in dtp.rounds:
        e = rd.elim.long()
        par = rd.parents.long()
        has_par = par >= 0
        if w_pairs.shape[0] > 0:
            pid = torch.where(rd.pair_ids >= 0, rd.pair_ids, 0).long()
            w = torch.where(has_par, w_pairs[pid], 0.0)
        else:
            w = torch.zeros(rd.size, dtype=dt, device=dev)
        db = d[e]
        factor = w / db
        rb = r[e]
        if rd.upar.shape[0]:
            s = fold.fold_apply_plain(torch.stack([-w * factor, factor * rb], dim=-1), rd.fold)
            up = rd.upar.long()
            d[up] = d[up] + s[:, 0]
            r[up] = r[up] + s[:, 1]
        saved.append((e, par, has_par, w, db, rb))
    lam = torch.zeros(dtp.num_bifurcations, dtype=dt, device=dev)
    cn = dtp.core_nodes.long()
    if cn.shape[0]:
        lam[cn] = solve_core(d[cn], r[cn])
    for e, par, has_par, w, db, rb in reversed(saved):
        lam_par = torch.where(has_par, lam[torch.clamp(par, min=0)], 0.0)
        lam[e] = (rb + w * lam_par) / db
    return lam


def peel(dtp, dr: torch.Tensor, w_pairs: torch.Tensor, solve_core: CoreSolve):
    """K9 on ``dr``'s device: ``λ (B,)``.  ``dr (B, 2)`` is the assembled
    (diagonal, rhs) and is not modified; ``solve_core`` gets the core's
    folded ``(d, r)`` and returns its ``λ``."""
    if dr.device.type == "cpu":
        return peel_plain(dtp, dr, w_pairs, solve_core)
    build.require_cuda("peel", dr, w_pairs)
    B = dtp.num_bifurcations
    if tuple(dr.shape) != (B, 2) or tuple(w_pairs.shape) != (dtp.num_pairs,):
        raise ValueError("peel: dr must be (B, 2) and w_pairs (P,)")
    dev, dt = dr.device, torch.float64
    lib = build.library()
    stream = build.stream_handle(dev)
    dr = dr.clone()  # the rounds fold into it in place
    saved = torch.empty((3, dtp.n_peeled), dtype=dt, device=dev)  # w, db, rb
    terms = torch.empty((dtp.max_round, 2), dtype=dt, device=dev)
    has_pairs = int(dtp.num_pairs > 0)
    for rd in dtp.rounds:
        n, o = rd.size, rd.offset
        with torch.cuda.device(dev):
            code = lib.nxfx_peel_forward(
                n, rd.elim.data_ptr(), rd.parents.data_ptr(), rd.pair_ids.data_ptr(), has_pairs,
                w_pairs.data_ptr(), dr.data_ptr(),
                saved[0, o:].data_ptr(), saved[1, o:].data_ptr(), saved[2, o:].data_ptr(),
                terms.data_ptr(), stream,
            )
        build.check(code, "peel")
        if rd.upar.shape[0]:
            s = fold.fold_apply(terms[:n], rd.fold)
            with torch.cuda.device(dev):
                code = lib.nxfx_peel_parents(
                    rd.upar.shape[0], rd.upar.data_ptr(), s.data_ptr(), dr.data_ptr(), stream
                )
            build.check(code, "peel")
    lam = torch.zeros(B, dtype=dt, device=dev)
    n_c = dtp.core_size
    if n_c:
        dc = torch.empty(n_c, dtype=dt, device=dev)
        rc = torch.empty(n_c, dtype=dt, device=dev)
        with torch.cuda.device(dev):
            code = lib.nxfx_core_gather(
                n_c, dtp.core_nodes.data_ptr(), dr.data_ptr(), dc.data_ptr(), rc.data_ptr(), stream
            )
        build.check(code, "peel")
        x = solve_core(dc, rc)
        build.require_cuda("peel", x)
        with torch.cuda.device(dev):
            code = lib.nxfx_core_scatter(
                n_c, dtp.core_nodes.data_ptr(), x.data_ptr(), lam.data_ptr(), stream
            )
        build.check(code, "peel")
    for rd in reversed(dtp.rounds):
        o = rd.offset
        with torch.cuda.device(dev):
            code = lib.nxfx_peel_back(
                rd.size, rd.elim.data_ptr(), rd.parents.data_ptr(),
                saved[0, o:].data_ptr(), saved[1, o:].data_ptr(), saved[2, o:].data_ptr(),
                lam.data_ptr(), stream,
            )
        build.check(code, "peel")
    peel.launches += 1
    return lam


peel.launches = 0
