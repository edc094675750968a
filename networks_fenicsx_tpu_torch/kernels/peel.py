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
  ``(−w·factor, factor·r)`` of its eliminated nodes, their fold into the
  round's unique parents, the add into those parents), the core solve
  ``solve_core(d_core, r_core) -> λ_core`` the caller passes, then the
  back-substitution ``λ_e = (r_e + w λ_parent) / d_e`` in reverse.  The
  diagonal and rhs rounds of the reference run as one two-channel pass:
  the sums are the same.

On the card :func:`peel` is one host call each way around the core solve,
walking the executor's packed, checked round table
(:class:`..ops.peel_table.PeelTable`, ``DeviceTreePlan.peel_table``): a
round of at least :data:`CUT` eliminated nodes is a grid launch (a launch a
fold level), a run of narrower rounds one block of 1,024 threads; each
unique parent sums its fold row, making its children's terms as it reads
them; the core's gather and scatter ride on those launches
(:func:`cuda_launches`: 10 on the 100k-site web, 2 on web1000, were 74 and
46); :data:`CUT` is read when a plan is made.  λ is :func:`peel_plain`'s to
the bit, and :func:`peel_table_plain` walks the packed table in the kernels'
order.

Factor reuse runs the two channels apart on the same table and launches
(the reference's ``_tree_eliminate_factor`` and ``_tree_eliminate_apply``):
:func:`peel_factor` the ``d`` channel alone (the forward entries), giving a
:class:`PeelFactor` — each peeled node's saved ``w`` and ``db``, each
child's ``factor = w / db`` by node, the core's folded diagonal ``dc`` —;
:func:`peel_apply`, per right-hand side, the ``r`` channel alone with the
stored factor, the core solve ``solve_core(r_core) -> λ_core`` and the back
pass on the stored ``w``, ``db`` (both directions).  The two-channel pass
forms ``factor·rb`` from the same bits, so λ is :func:`peel`'s to the bit for
the same core solution.  Their plain versions come in the reference's order
(:func:`peel_factor_plain`, :func:`peel_apply_plain`) and the table's
(``…_table_plain``); each counts on its own ``launches`` and ``device``.

A sweep on the dense route assembles S scenarios' systems in the launches
of one (:func:`bifurcation_system_scenarios`: the prepare kernel over S rows,
then K6's two sides over S rows, :func:`.segsum.segsum_plan_scenarios`),
giving ``dr (S, B, 2)`` and ``w (S, E)``, row ``i`` :func:`bifurcation_system`
of row ``i`` bit for bit.  It forms no ``‖rhs‖``: the sweep drops it, as the
reference's vmapped solve returns only ``q_T``, ``p_T`` and λ.

Each wrapper launches its kernels for CUDA tensors and runs its plain
version, an eager transcription of the reference, for CPU tensors.
"""

from __future__ import annotations

import ctypes
import typing

import numpy as np
import torch

from ..edge_data import _EdgeData
from ..ops import peel_table as table_words
from . import build, fold, segsum

__all__ = ["CUT", "cuda_launches", "lambda_system", "lambda_system_plain", "lambda_sums", "peel",
           "bifurcation_system", "bifurcation_system_plain",
           "peel_plain", "peel_table_plain", "PeelFactor", "peel_factor", "peel_factor_plain",
           "peel_factor_table_plain", "peel_apply", "peel_apply_plain", "peel_apply_table_plain",
           "factor_launches", "bifurcation_system_scenarios",
           "bifurcation_system_scenarios_plain", "peel_scenarios", "peel_scenarios_plain",
           "peel_apply_scenarios", "peel_apply_scenarios_plain"]

CUT = 1024  # the narrowest round a grid launch takes; narrower runs are one block

CoreSolve = typing.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
CoreApply = typing.Callable[[torch.Tensor], torch.Tensor]


class PeelFactor(typing.NamedTuple):
    """The ``d`` channel of the peel rounds (:func:`peel_factor`)."""

    w: torch.Tensor  # (n_peeled,) each peeled node's pair conductance to its parent, saved order
    db: torch.Tensor  # (n_peeled,) its diagonal at elimination
    factor: torch.Tensor  # (B,) w / db of each node with a parent, by node (0 elsewhere)
    dc: torch.Tensor  # (n_core,) the core's folded diagonal


def lambda_sums(plan) -> segsum.SumPlan:
    """The K6 plan of a device plan's bifurcation system: the target side's
    and then the source side's ``(diag, rhs)`` sums into one ``(B, 2)``
    output, in the order the reference's ``_lambda_system_sorted`` adds them."""
    return segsum.SumPlan(((plan.t_idx, plan.t_bins), (plan.s_idx, plan.s_bins)), (2, 2),
                          rows=plan.num_bifurcations)


def bifurcation_system_plain(dtp, W, g=None, Ftot=None, start_pbc=None, end_pbc=None):
    """Eager version of :func:`bifurcation_system`: ``(dr (B, 2), w (E,),
    ‖rhs‖)``; without ``g`` the diagonal alone (a zero rhs, no norm)."""
    w_edges = 1.0 / W
    if g is None:
        vt = vs = torch.stack([w_edges, torch.zeros_like(W)], dim=-1)
    else:
        s_is_bif = dtp.start_bif >= 0
        t_is_bif = dtp.end_bif >= 0
        const = (-start_pbc * (~s_is_bif) + end_pbc * (~t_is_bif) - g) / W
        vt = torch.stack([w_edges, const + Ftot], dim=-1)
        vs = torch.stack([w_edges, -const], dim=-1)
    dr = torch.zeros((dtp.num_bifurcations, 2), dtype=torch.float64, device=W.device)
    segsum.segsum_plain(dtp.t_idx, vt, dtp.t_bins, dr)
    segsum.segsum_plain(dtp.s_idx, vs, dtp.s_bins, dr)
    return dr, w_edges, None if g is None else torch.linalg.norm(dr[:, 1])


def lambda_system_plain(dtp, ed: _EdgeData):
    """Eager version: ``(dr (B, 2), w (E,), ‖rhs‖)``."""
    return bifurcation_system_plain(dtp, ed.W, ed.g, ed.cumF[-1], ed.start_pbc, ed.end_pbc)


def bifurcation_system(dtp, W, g=None, Ftot=None, start_pbc=None, end_pbc=None, counter=None):
    """The bifurcation system on ``W``'s device from per-edge ``(E,)``
    totals, in public edge order (the reference's ``_lambda_system_sorted``,
    and the target-then-source adds of ``TreeFactorization``): the prepare
    kernel, K6's two sides' sums and the norm (three launches).  Without
    ``g`` (a factor's call) the diagonal alone: the rhs channel 0, no norm
    (two launches, ``‖rhs‖`` None)."""
    if W.device.type == "cpu":
        return bifurcation_system_plain(dtp, W, g, Ftot, start_pbc, end_pbc)
    rhs = () if g is None else (g, Ftot, start_pbc, end_pbc)
    build.require_cuda("lambda_system", W, *rhs)
    build.require_cuda("lambda_system", dtp.start_bif, dtp.end_bif, dtype=torch.int32)
    E, B = dtp.num_edges, dtp.num_bifurcations
    if any(tuple(t.shape) != (E,) for t in (W, *rhs)):
        raise ValueError("lambda_system: the edge data must be (E,) per edge")
    dev, dt = W.device, torch.float64
    w_edges = torch.empty(E, dtype=dt, device=dev)
    vt = torch.empty((E, 2), dtype=dt, device=dev)
    vs = torch.empty((E, 2), dtype=dt, device=dev)
    lib = build.library()
    stream = build.stream_handle(dev)
    with torch.cuda.device(dev):
        code = lib.nxfx_lambda_prepare(
            E, W.data_ptr(), *([t.data_ptr() for t in rhs] if rhs else [None] * 4),
            dtp.start_bif.data_ptr(), dtp.end_bif.data_ptr(),
            w_edges.data_ptr(), vt.data_ptr(), vs.data_ptr(), stream,
        )
    build.check(code, "lambda_system")
    dr, = segsum.segsum_plan(dtp.lambda_sums, vt, vs)
    if not rhs:
        (counter or bifurcation_system).launches += 1
        return dr, w_edges, None
    rhs_norm = torch.empty((), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = lib.nxfx_rhs_norm(B, dr.data_ptr(), rhs_norm.data_ptr(), stream)
    build.check(code, "lambda_system")
    (counter or bifurcation_system).launches += 1
    return dr, w_edges, rhs_norm


bifurcation_system.launches = 0


def bifurcation_system_scenarios_plain(dtp, W, g, Ftot, start_pbc, end_pbc, norm: bool = False):
    """Eager version of :func:`bifurcation_system_scenarios`:
    :func:`bifurcation_system_plain` a scenario, stacked ``(dr, w)`` (and
    ``‖rhs‖`` with ``norm``)."""
    S, E = _system_shapes(dtp, W, g, Ftot, start_pbc, end_pbc)
    rows = []
    for i in range(S):
        sp, ep = (build.scenario_row(t, (E,), i) for t in (start_pbc, end_pbc))
        rows.append(bifurcation_system_plain(dtp, W[i], g[i], Ftot[i], sp, ep)[:3 if norm else 2])
    return tuple(torch.stack(t) for t in zip(*rows))


def _system_shapes(dtp, W, g, Ftot, start_pbc, end_pbc) -> tuple:
    """``(S, E)`` of a scenario system, or raise."""
    name, E = "bifurcation_system_scenarios", dtp.num_edges
    if W.dim() != 2 or W.shape[1] != E or W.shape[0] < 1:
        raise ValueError(f"{name}: W must be (S, E), S >= 1")
    S = W.shape[0]
    if tuple(g.shape) != (S, E) or tuple(Ftot.shape) != (S, E) or Ftot.stride(1) != 1:
        raise ValueError(f"{name}: g and Ftot must be (S, E), Ftot's rows contiguous")
    build.scenarios(name, (start_pbc, (E,)), (end_pbc, (E,)), S=S)
    return S, E


def bifurcation_system_scenarios(dtp, W, g, Ftot, start_pbc, end_pbc, norm: bool = False):
    """The bifurcation systems of S scenarios on ``W``'s device, in two
    launches (the prepare kernel over S rows, K6 over S rows): ``W``, ``g``
    ``(S, E)``, ``Ftot`` ``(S, E)`` with contiguous rows (a sweep passes
    ``cumF[:, -1]``), ``start_pbc`` and ``end_pbc`` ``(S, E)`` or shared
    ``(E,)``.  Returns ``(dr (S, B, 2), w (S, E))``; with ``norm`` also
    ``‖rhs‖ (S,)`` (one more launch, a block a scenario)."""
    if W.device.type == "cpu":
        return bifurcation_system_scenarios_plain(dtp, W, g, Ftot, start_pbc, end_pbc, norm)
    name = "bifurcation_system_scenarios"
    S, E = _system_shapes(dtp, W, g, Ftot, start_pbc, end_pbc)
    build.require_cuda(name, W, g, start_pbc, end_pbc)
    build.require_cuda(name, Ftot, contiguous=False)
    build.require_cuda(name, dtp.start_bif, dtp.end_bif, dtype=torch.int32)
    dev, dt = W.device, torch.float64
    w_edges = torch.empty((S, E), dtype=dt, device=dev)
    vt = torch.empty((S, E, 2), dtype=dt, device=dev)
    vs = torch.empty((S, E, 2), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_lambda_prepare_scen(
            E, S, Ftot.stride(0), build.scenario_stride(start_pbc, (E,)),
            build.scenario_stride(end_pbc, (E,)), W.data_ptr(), g.data_ptr(), Ftot.data_ptr(),
            start_pbc.data_ptr(), end_pbc.data_ptr(), dtp.start_bif.data_ptr(),
            dtp.end_bif.data_ptr(), w_edges.data_ptr(), vt.data_ptr(), vs.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, name)
    bifurcation_system_scenarios.launches += 1
    dr, = segsum.segsum_plan_scenarios(dtp.lambda_sums, vt, vs)
    if not norm:
        return dr, w_edges
    rhs_norm = torch.empty(S, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_rhs_norm_scen(dtp.num_bifurcations, S, dr.data_ptr(),
                                                  rhs_norm.data_ptr(), build.stream_handle(dev))
    build.check(code, name)
    return dr, w_edges, rhs_norm


bifurcation_system_scenarios.launches = 0


def lambda_system(dtp, ed: _EdgeData):
    """The bifurcation system on the edge data's device (see module docs)."""
    if ed.W.device.type == "cpu":
        return lambda_system_plain(dtp, ed)
    return bifurcation_system(dtp, ed.W, ed.g, ed.cumF[-1], ed.start_pbc, ed.end_pbc,
                              counter=lambda_system)


lambda_system.launches = 0


def _forward_plain(dtp, dr: torch.Tensor, w_pairs: torch.Tensor):
    """The rounds forward of :func:`peel_plain`: ``(d, r, saved)``."""
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
    return d, r, saved


def _back_plain(dtp, saved, x, dev) -> torch.Tensor:
    """The core's solution ``x`` (None without a core) into λ and the rounds
    back (:func:`peel_plain`'s and :func:`peel_apply_plain`'s)."""
    lam = torch.zeros(dtp.num_bifurcations, dtype=torch.float64, device=dev)
    cn = dtp.core_nodes.long()
    if cn.shape[0]:
        lam[cn] = x
    for e, par, has_par, w, db, rb in reversed(saved):
        lam_par = torch.where(has_par, lam[torch.clamp(par, min=0)], 0.0)
        lam[e] = (rb + w * lam_par) / db
    return lam


def peel_plain(dtp, dr: torch.Tensor, w_pairs: torch.Tensor, solve_core: CoreSolve):
    """Eager version: returns ``λ (B,)``; ``dr`` is not modified."""
    d, r, saved = _forward_plain(dtp, dr, w_pairs)
    cn = dtp.core_nodes.long()
    x = solve_core(d[cn], r[cn]) if cn.shape[0] else None
    return _back_plain(dtp, saved, x, dr.device)


def _round_w(rd, w_pairs, has_par, dt, dev):
    if w_pairs.shape[0] > 0:
        pid = torch.where(rd.pair_ids >= 0, rd.pair_ids, 0).long()
        return torch.where(has_par, w_pairs[pid], 0.0)
    return torch.zeros(rd.size, dtype=dt, device=dev)


def peel_factor_plain(dtp, dr: torch.Tensor, w_pairs: torch.Tensor) -> PeelFactor:
    """Eager version of :func:`peel_factor` (the reference's
    ``_tree_eliminate_factor`` up to the core): only ``dr[:, 0]`` is read."""
    dt, dev = torch.float64, dr.device
    d = dr[:, 0].clone()
    fac = torch.zeros(dtp.num_bifurcations, dtype=dt, device=dev)
    ws, dbs = [], []
    for rd in dtp.rounds:
        e = rd.elim.long()
        has_par = rd.parents >= 0
        w = _round_w(rd, w_pairs, has_par, dt, dev)
        db = d[e]
        factor = w / db
        if rd.upar.shape[0]:
            s = fold.fold_apply_plain(-w * factor, rd.fold)
            up = rd.upar.long()
            d[up] = d[up] + s
        fac[e[has_par]] = factor[has_par]
        ws.append(w)
        dbs.append(db)
    cat = (lambda xs: torch.cat(xs) if xs else torch.zeros(0, dtype=dt, device=dev))
    return PeelFactor(cat(ws), cat(dbs), fac, d[dtp.core_nodes.long()])


def _apply_forward_plain(dtp, state: PeelFactor, dr: torch.Tensor):
    """The rounds forward of :func:`peel_apply_plain`: ``(r, saved)``."""
    r = dr[:, 1].clone()
    saved, off = [], 0
    for rd in dtp.rounds:
        e = rd.elim.long()
        par = rd.parents.long()
        rb = r[e]
        if rd.upar.shape[0]:
            s = fold.fold_apply_plain(state.factor[e] * rb, rd.fold)
            up = rd.upar.long()
            r[up] = r[up] + s
        n = rd.size
        saved.append((e, par, par >= 0, state.w[off : off + n], state.db[off : off + n], rb))
        off += n
    return r, saved


def peel_apply_plain(dtp, state: PeelFactor, dr: torch.Tensor, solve_core: CoreApply):
    """Eager version of :func:`peel_apply` (the reference's
    ``_tree_eliminate_apply`` around the core): ``λ (B,)``; only ``dr[:, 1]``
    is read."""
    r, saved = _apply_forward_plain(dtp, state, dr)
    cn = dtp.core_nodes.long()
    x = solve_core(r[cn]) if cn.shape[0] else None
    return _back_plain(dtp, saved, x, dr.device)


def peel_table_plain(dtp, dr: torch.Tensor, w_pairs: torch.Tensor, solve_core: CoreSolve):
    """:func:`peel_plain` in the kernels' order, every index from the packed
    table ``dtp.peel_table``: per round the saved ``(w, db, rb)``, the terms
    gathered by each fold row and summed in its order (level by level), the
    sums added into the parents and, on a core node's last update, its core
    slot; the core nodes no round updates; the core solve; the rounds back,
    a core parent's λ read from the core's solution, and the scatter."""
    W = table_words
    words = dtp.peel_table.host.astype(np.int64)
    dt, dev = torch.float64, dr.device

    def T(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    n_peeled, n_core = int(words[W.H_NPEEL]), int(words[W.H_NCORE])
    core = T(words[int(words[W.H_CORE]): int(words[W.H_CORE]) + n_core])
    d, r = dr[:, 0].clone(), dr[:, 1].clone()
    saved = torch.empty((3, n_peeled), dtype=dt, device=dev)
    dc = torch.empty(n_core, dtype=dt, device=dev)
    rc = torch.empty(n_core, dtype=dt, device=dev)
    rounds = [W.round_arrays(words, k) for k in range(int(words[W.H_ROUNDS]))]
    for rd in rounds:
        e, par = T(rd["elim"]), T(rd["parents"])
        if w_pairs.shape[0] > 0:
            pid = T(rd["pair_ids"])
            w = torch.where(par >= 0, w_pairs[torch.where(pid >= 0, pid, 0)], 0.0)
        else:
            w = torch.zeros(rd["n"], dtype=dt, device=dev)
        db, rb = d[e], r[e]
        saved[:, rd["off"]: rd["off"] + rd["n"]] = torch.stack([w, db, rb])
        if not rd["fold"]:
            continue
        factor = w / db
        vec = torch.stack([-w * factor, factor * rb], dim=-1)
        for lv, _ in rd["fold"]:
            vec = segsum.segsum_plain(T(lv), vec)
        up, uc = T(rd["upar"]), T(rd["ucore"])
        dn, rn = d[up] + vec[:, 0], r[up] + vec[:, 1]
        d[up], r[up] = dn, rn
        hit = uc >= 0
        dc[uc[hit]], rc[uc[hit]] = dn[hit], rn[hit]
    early = T(words[int(words[W.H_EARLY]): int(words[W.H_EARLY]) + int(words[W.H_NEARLY])])
    dc[early], rc[early] = d[core[early]], r[core[early]]
    x = solve_core(dc, rc) if n_core else torch.zeros(1, dtype=dt, device=dev)
    lam = torch.empty(int(words[W.H_B]), dtype=dt, device=dev)
    for rd in reversed(rounds):
        sw, sd, sr = saved[:, rd["off"]: rd["off"] + rd["n"]]
        bp = T(rd["bpar"])
        lp = torch.where(bp >= 0, lam[bp.clamp(min=0)],
                         torch.where(bp == -1, 0.0, x[(-2 - bp).clamp(min=0)]))
        lam[T(rd["elim"])] = (sr + sw * lp) / sd
    if n_core:
        lam[core] = x
    return lam


def _table(dtp, dev):
    W = table_words
    words = dtp.peel_table.host.astype(np.int64)

    def T(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    n_core = int(words[W.H_NCORE])
    core = T(words[int(words[W.H_CORE]): int(words[W.H_CORE]) + n_core])
    early = T(words[int(words[W.H_EARLY]): int(words[W.H_EARLY]) + int(words[W.H_NEARLY])])
    rounds = [W.round_arrays(words, k) for k in range(int(words[W.H_ROUNDS]))]
    return words, T, core, early, rounds


def peel_factor_table_plain(dtp, dr: torch.Tensor, w_pairs: torch.Tensor) -> PeelFactor:
    """:func:`peel_factor_plain` in the kernels' order, every index from the
    packed table (as :func:`peel_table_plain`, the ``d`` channel alone)."""
    dt, dev = torch.float64, dr.device
    words, T, core, early, rounds = _table(dtp, dev)
    n_peeled = int(words[table_words.H_NPEEL])
    d = dr[:, 0].clone()
    sw = torch.empty(n_peeled, dtype=dt, device=dev)
    sd = torch.empty(n_peeled, dtype=dt, device=dev)
    fac = torch.zeros(dtp.num_bifurcations, dtype=dt, device=dev)
    dc = torch.empty(core.shape[0], dtype=dt, device=dev)
    for rd in rounds:
        e, par = T(rd["elim"]), T(rd["parents"])
        if w_pairs.shape[0] > 0:
            pid = T(rd["pair_ids"])
            w = torch.where(par >= 0, w_pairs[torch.where(pid >= 0, pid, 0)], 0.0)
        else:
            w = torch.zeros(rd["n"], dtype=dt, device=dev)
        db = d[e]
        sw[rd["off"]: rd["off"] + rd["n"]] = w
        sd[rd["off"]: rd["off"] + rd["n"]] = db
        if not rd["fold"]:
            continue
        factor = w / db
        fac[e[par >= 0]] = factor[par >= 0]
        vec = -w * factor
        for lv, _ in rd["fold"]:
            vec = segsum.segsum_plain(T(lv), vec)
        up, uc = T(rd["upar"]), T(rd["ucore"])
        dn = d[up] + vec
        d[up] = dn
        hit = uc >= 0
        dc[uc[hit]] = dn[hit]
    dc[early] = d[core[early]]
    return PeelFactor(sw, sd, fac, dc)


def peel_apply_table_plain(dtp, state: PeelFactor, dr: torch.Tensor, solve_core: CoreApply):
    """:func:`peel_apply_plain` in the kernels' order, every index from the
    packed table (as :func:`peel_table_plain`, the ``r`` channel alone on the
    stored factor)."""
    dt, dev = torch.float64, dr.device
    words, T, core, early, rounds = _table(dtp, dev)
    n_peeled, n_core = int(words[table_words.H_NPEEL]), core.shape[0]
    r = dr[:, 1].clone()
    sr = torch.empty(n_peeled, dtype=dt, device=dev)
    rc = torch.empty(n_core, dtype=dt, device=dev)
    for rd in rounds:
        e = T(rd["elim"])
        rb = r[e]
        sr[rd["off"]: rd["off"] + rd["n"]] = rb
        if not rd["fold"]:
            continue
        vec = state.factor[e] * rb
        for lv, _ in rd["fold"]:
            vec = segsum.segsum_plain(T(lv), vec)
        up, uc = T(rd["upar"]), T(rd["ucore"])
        rn = r[up] + vec
        r[up] = rn
        hit = uc >= 0
        rc[uc[hit]] = rn[hit]
    rc[early] = r[core[early]]
    x = solve_core(rc) if n_core else torch.zeros(1, dtype=dt, device=dev)
    lam = torch.empty(int(words[table_words.H_B]), dtype=dt, device=dev)
    for rd in reversed(rounds):
        sl = slice(rd["off"], rd["off"] + rd["n"])
        bp = T(rd["bpar"])
        lp = torch.where(bp >= 0, lam[bp.clamp(min=0)],
                         torch.where(bp == -1, 0.0, x[(-2 - bp).clamp(min=0)]))
        lam[T(rd["elim"])] = (sr[sl] + state.w[sl] * lp) / state.db[sl]
    if n_core:
        lam[core] = x
    return lam


class _PeelArgs(ctypes.Structure):
    """``PeelArgs`` of ``csrc/peel.cu``."""

    _fields_ = ([(f, ctypes.c_int) for f in ("has_pairs", "n_peeled", "B", "chan")]
                + [(f, ctypes.c_void_p)
                   for f in ("tab", "w_pairs", "dr", "wk", "work", "dc", "rc", "x", "lam", "sw",
                             "sd", "sr", "fac")]
                + [("S", ctypes.c_int)]
                + [(f, ctypes.c_longlong)
                   for f in ("s_wp", "s_dr", "s_wk", "s_work", "s_dc", "s_rc", "s_x", "s_lam",
                             "s_sw", "s_sd", "s_sr", "s_fac")])


BOTH, D_ONLY, R_ONLY = 0, 1, 2  # PeelArgs.chan


def _count(enqueued: int, counter=None) -> None:
    """Count a launcher's kernels (minus a CUDA error when negative)."""
    if enqueued < 0:
        build.check(-enqueued, "peel")
    (counter or peel).device += enqueued


def _check_call(dtp, dr: torch.Tensor, name: str) -> None:
    B, pt = dtp.num_bifurcations, dtp.peel_table
    if tuple(dr.shape) != (B, 2):
        raise ValueError(f"{name}: dr must be (B, 2)")
    if pt.table.device != dr.device:
        raise ValueError(f"{name}: the plan's table must be on dr's device")


def _work(dtp, dev):
    """A call's scratch: the updated nodes' ``(d, r)`` and the work buffer
    (the saved planes, then the fold levels)."""
    wk = torch.empty((dtp.num_bifurcations, 2), dtype=torch.float64, device=dev)
    work = torch.empty(max(dtp.peel_table.work_len, 1), dtype=torch.float64, device=dev)
    return wk, work


def peel(dtp, dr: torch.Tensor, w_pairs: torch.Tensor, solve_core: CoreSolve):
    """K9 on ``dr``'s device: ``λ (B,)``.  ``dr (B, 2)`` is the assembled
    (diagonal, rhs) and is not modified; ``solve_core`` gets the core's
    folded ``(d, r)`` and returns its ``λ``.  On CUDA one launcher call
    each way walks the plan's :class:`..ops.peel_table.PeelTable`."""
    if dr.device.type == "cpu":
        return peel_plain(dtp, dr, w_pairs, solve_core)
    build.require_cuda("peel", dr, w_pairs)
    B, n_c, pt = dtp.num_bifurcations, dtp.core_size, dtp.peel_table
    _check_call(dtp, dr, "peel")
    if tuple(w_pairs.shape) != (dtp.num_pairs,):
        raise ValueError("peel: w_pairs must be (P,)")
    dev, dt = dr.device, torch.float64
    lib = build.library()
    stream = build.stream_handle(dev)
    wk, work = _work(dtp, dev)  # the updated nodes' (d, r); dr is only read
    dc = torch.empty(n_c, dtype=dt, device=dev)
    rc = torch.empty(n_c, dtype=dt, device=dev)
    lam = torch.empty(B, dtype=dt, device=dev)
    n_p = dtp.n_peeled
    args = _PeelArgs(S=1, has_pairs=int(dtp.num_pairs > 0), n_peeled=n_p, B=B, chan=BOTH,
                     tab=pt.table.data_ptr(), w_pairs=w_pairs.data_ptr(), dr=dr.data_ptr(),
                     wk=wk.data_ptr(), work=work.data_ptr(), dc=dc.data_ptr(), rc=rc.data_ptr(),
                     x=None, lam=lam.data_ptr(), sw=work.data_ptr(), sd=work[n_p:].data_ptr(),
                     sr=work[2 * n_p:].data_ptr(), fac=None)
    host = pt.host.ctypes.data
    with torch.cuda.device(dev):
        _count(lib.nxfx_peel_forward(ctypes.byref(args), host, stream))
    x = None
    if n_c:
        x = solve_core(dc, rc)
        build.require_cuda("peel", x)
        if tuple(x.shape) != (n_c,) or x.device != dev:
            raise ValueError("peel: the core solve must give (n_core,) on dr's device")
        args.x = x.data_ptr()
    with torch.cuda.device(dev):
        _count(lib.nxfx_peel_back(ctypes.byref(args), host, stream))
    peel.launches += 1
    return lam


peel.launches = 0
peel.device = 0  # K9's kernels enqueued (the launchers report them)


def cuda_launches(dtp) -> int:
    """K9's CUDA launches of one :func:`peel` call, or of one
    :func:`peel_apply`: its table's entries each way."""
    return dtp.peel_table.launches


def factor_launches(dtp) -> int:
    """K9's CUDA launches of one :func:`peel_factor`: the forward entries."""
    return dtp.peel_table.n_forward


def peel_factor(dtp, dr: torch.Tensor, w_pairs: torch.Tensor) -> PeelFactor:
    """K9's ``d`` channel on ``dr``'s device: the :class:`PeelFactor` of the
    assembled diagonal ``dr[:, 0]`` (``dr (B, 2)`` is only read, its rhs
    channel not at all) and the pair conductances; one launcher call, the
    table's forward entries."""
    if dr.device.type == "cpu":
        return peel_factor_plain(dtp, dr, w_pairs)
    build.require_cuda("peel_factor", dr, w_pairs)
    _check_call(dtp, dr, "peel_factor")
    if tuple(w_pairs.shape) != (dtp.num_pairs,):
        raise ValueError("peel_factor: w_pairs must be (P,)")
    dev, dt, B, n_p = dr.device, torch.float64, dtp.num_bifurcations, dtp.n_peeled
    wk, work = _work(dtp, dev)
    saved = torch.empty((2, n_p), dtype=dt, device=dev)
    fac = torch.zeros(B, dtype=dt, device=dev)
    dc = torch.empty(dtp.core_size, dtype=dt, device=dev)
    args = _PeelArgs(S=1, has_pairs=int(dtp.num_pairs > 0), n_peeled=n_p, B=B, chan=D_ONLY,
                     tab=dtp.peel_table.table.data_ptr(), w_pairs=w_pairs.data_ptr(),
                     dr=dr.data_ptr(), wk=wk.data_ptr(), work=work.data_ptr(), dc=dc.data_ptr(),
                     rc=None, x=None, lam=None, sw=saved[0].data_ptr(), sd=saved[1].data_ptr(),
                     sr=work[2 * n_p:].data_ptr(), fac=fac.data_ptr())
    with torch.cuda.device(dev):
        _count(build.library().nxfx_peel_forward(ctypes.byref(args), dtp.peel_table.host.ctypes.data,
                                                  build.stream_handle(dev)), peel_factor)
    peel_factor.launches += 1
    return PeelFactor(saved[0], saved[1], fac, dc)


peel_factor.launches = 0
peel_factor.device = 0


def peel_apply(dtp, state: PeelFactor, dr: torch.Tensor, solve_core: CoreApply):
    """K9's ``r`` channel on ``dr``'s device from :func:`peel_factor`'s
    ``state``: ``λ (B,)`` of the rhs ``dr[:, 1]`` (``dr (B, 2)`` is only
    read, its diagonal channel not at all); ``solve_core`` gets the core's
    folded rhs and returns its ``λ`` (on the stored core factor).  One
    launcher call each way around the core solve, as :func:`peel`."""
    if dr.device.type == "cpu":
        return peel_apply_plain(dtp, state, dr, solve_core)
    build.require_cuda("peel_apply", dr, state.w, state.db, state.factor)
    _check_call(dtp, dr, "peel_apply")
    dev, dt, B, n_p, n_c = dr.device, torch.float64, dtp.num_bifurcations, dtp.n_peeled, dtp.core_size
    if (tuple(state.w.shape) != (n_p,) or tuple(state.db.shape) != (n_p,)
            or tuple(state.factor.shape) != (B,)):
        raise ValueError("peel_apply: the state must be the plan's peel_factor")
    wk, work = _work(dtp, dev)
    rc = torch.empty(n_c, dtype=dt, device=dev)
    lam = torch.empty(B, dtype=dt, device=dev)
    args = _PeelArgs(S=1, has_pairs=int(dtp.num_pairs > 0), n_peeled=n_p, B=B, chan=R_ONLY,
                     tab=dtp.peel_table.table.data_ptr(), w_pairs=None, dr=dr.data_ptr(),
                     wk=wk.data_ptr(), work=work.data_ptr(), dc=None, rc=rc.data_ptr(), x=None,
                     lam=lam.data_ptr(), sw=state.w.data_ptr(), sd=state.db.data_ptr(),
                     sr=work[2 * n_p:].data_ptr(), fac=state.factor.data_ptr())
    lib, host, stream = build.library(), dtp.peel_table.host.ctypes.data, build.stream_handle(dev)
    with torch.cuda.device(dev):
        _count(lib.nxfx_peel_forward(ctypes.byref(args), host, stream), peel_apply)
    if n_c:
        x = solve_core(rc)
        build.require_cuda("peel_apply", x)
        if tuple(x.shape) != (n_c,) or x.device != dev:
            raise ValueError("peel_apply: the core solve must give (n_core,) on dr's device")
        args.x = x.data_ptr()
    with torch.cuda.device(dev):
        _count(lib.nxfx_peel_back(ctypes.byref(args), host, stream), peel_apply)
    peel_apply.launches += 1
    return lam


peel_apply.launches = 0
peel_apply.device = 0


# ---------------------------------------------------------------- the rounds over S


def _scenario_system(name: str, dtp, dr: torch.Tensor) -> int:
    """The scenario count of ``dr (S, B, 2)``, or raise."""
    B = dtp.num_bifurcations
    if dr.dim() != 3 or tuple(dr.shape[1:]) != (B, 2) or dr.shape[0] < 1:
        raise ValueError(f"{name}: dr must be (S, B, 2), S >= 1")
    return int(dr.shape[0])


def _core_values(name: str, x: torch.Tensor, S: int, n_c: int, dev) -> None:
    build.require_cuda(name, x)
    if tuple(x.shape) != (S, n_c) or x.device != dev:
        raise ValueError(f"{name}: the core solve must give (S, n_core) on dr's device")


def peel_scenarios_plain(dtp, dr: torch.Tensor, w_pairs: torch.Tensor, solve_core: CoreSolve):
    """Eager version of :func:`peel_scenarios`: the rounds forward of
    :func:`peel_plain` a scenario, ``solve_core`` once on the stacked core
    values, the rounds back a scenario; ``λ (S, B)``."""
    name = "peel_scenarios"
    S = _scenario_system(name, dtp, dr)
    P = dtp.num_pairs
    build.scenarios(name, (w_pairs, (P,)), S=S)
    rows = [_forward_plain(dtp, dr[i], build.scenario_row(w_pairs, (P,), i)) for i in range(S)]
    cn = dtp.core_nodes.long()
    x = (solve_core(torch.stack([d[cn] for d, _, _ in rows]), torch.stack([r[cn] for _, r, _ in rows]))
         if cn.shape[0] else None)
    return torch.stack([_back_plain(dtp, saved, None if x is None else x[i], dr.device)
                        for i, (_, _, saved) in enumerate(rows)])


def peel_scenarios(dtp, dr: torch.Tensor, w_pairs: torch.Tensor, solve_core: CoreSolve):
    """K9's two channels over S scenarios on ``dr``'s device, in the launches
    of one :func:`peel` call: ``dr (S, B, 2)`` the assembled systems (only
    read), ``w_pairs (S, P)`` their pair conductances or ``(P,)`` shared;
    ``solve_core`` gets the cores' folded ``(S, n_core)`` diagonals and right-hand
    sides and returns their ``(S, n_core)`` λ.  Returns ``λ (S, B)``, row
    ``i`` :func:`peel` of row ``i`` bit for bit (for the same core solution)."""
    if dr.device.type == "cpu":
        return peel_scenarios_plain(dtp, dr, w_pairs, solve_core)
    name = "peel_scenarios"
    S = _scenario_system(name, dtp, dr)
    P = dtp.num_pairs
    build.scenarios(name, (w_pairs, (P,)), S=S)
    build.require_cuda(name, dr, w_pairs)
    pt = dtp.peel_table
    if pt.table.device != dr.device:
        raise ValueError(f"{name}: the plan's table must be on dr's device")
    B, n_c, n_p = dtp.num_bifurcations, dtp.core_size, dtp.n_peeled
    dev, dt = dr.device, torch.float64
    wl = max(pt.work_len, 1)
    wk = torch.empty((S, B, 2), dtype=dt, device=dev)  # each scenario's updated (d, r)
    work = torch.empty((S, wl), dtype=dt, device=dev)  # its saved planes, then its fold levels
    dc = torch.empty((S, n_c), dtype=dt, device=dev)
    rc = torch.empty((S, n_c), dtype=dt, device=dev)
    lam = torch.empty((S, B), dtype=dt, device=dev)
    w0 = work.data_ptr()
    args = _PeelArgs(has_pairs=int(P > 0), n_peeled=n_p, B=B, chan=BOTH, tab=pt.table.data_ptr(),
                     w_pairs=w_pairs.data_ptr(), dr=dr.data_ptr(), wk=wk.data_ptr(), work=w0,
                     dc=dc.data_ptr(), rc=rc.data_ptr(), x=None, lam=lam.data_ptr(), sw=w0,
                     sd=w0 + 8 * n_p, sr=w0 + 16 * n_p, fac=None, S=S,
                     s_wp=build.scenario_stride(w_pairs, (P,)), s_dr=2 * B, s_wk=2 * B,
                     s_work=wl, s_dc=n_c, s_rc=n_c, s_x=n_c, s_lam=B, s_sw=wl, s_sd=wl, s_sr=wl,
                     s_fac=0)
    lib, host, stream = build.library(), pt.host.ctypes.data, build.stream_handle(dev)
    with torch.cuda.device(dev):
        _count(lib.nxfx_peel_forward(ctypes.byref(args), host, stream), peel_scenarios)
    if n_c:
        x = solve_core(dc, rc)
        _core_values(name, x, S, n_c, dev)
        args.x = x.data_ptr()
    with torch.cuda.device(dev):
        _count(lib.nxfx_peel_back(ctypes.byref(args), host, stream), peel_scenarios)
    peel_scenarios.launches += 1
    return lam


peel_scenarios.launches = 0
peel_scenarios.device = 0


def peel_apply_scenarios_plain(dtp, state: PeelFactor, dr: torch.Tensor, solve_core: CoreApply):
    """Eager version of :func:`peel_apply_scenarios`: the rounds forward of
    :func:`peel_apply_plain` a scenario, ``solve_core`` once on the stacked
    core right-hand sides, the rounds back a scenario; ``λ (S, B)``."""
    S = _scenario_system("peel_apply_scenarios", dtp, dr)
    rows = [_apply_forward_plain(dtp, state, dr[i]) for i in range(S)]
    cn = dtp.core_nodes.long()
    x = solve_core(torch.stack([r[cn] for r, _ in rows])) if cn.shape[0] else None
    return torch.stack([_back_plain(dtp, saved, None if x is None else x[i], dr.device)
                        for i, (_, saved) in enumerate(rows)])


def peel_apply_scenarios(dtp, state: PeelFactor, dr: torch.Tensor, solve_core: CoreApply):
    """K9's ``r`` channel over S right-hand sides on one stored factor, on
    ``dr``'s device in the launches of one :func:`peel_apply` call: ``dr (S,
    B, 2)`` (only its rhs channel read), ``state`` :func:`peel_factor`'s
    (read at stride 0); ``solve_core`` gets the cores' folded ``(S, n_core)``
    right-hand sides and returns their ``(S, n_core)`` λ.  Returns ``λ (S,
    B)``, row ``i`` :func:`peel_apply` of row ``i`` bit for bit."""
    if dr.device.type == "cpu":
        return peel_apply_scenarios_plain(dtp, state, dr, solve_core)
    name = "peel_apply_scenarios"
    S = _scenario_system(name, dtp, dr)
    build.require_cuda(name, dr, state.w, state.db, state.factor)
    pt = dtp.peel_table
    if pt.table.device != dr.device:
        raise ValueError(f"{name}: the plan's table must be on dr's device")
    B, n_c, n_p = dtp.num_bifurcations, dtp.core_size, dtp.n_peeled
    if (tuple(state.w.shape) != (n_p,) or tuple(state.db.shape) != (n_p,)
            or tuple(state.factor.shape) != (B,)):
        raise ValueError(f"{name}: the state must be the plan's peel_factor")
    dev, dt = dr.device, torch.float64
    wl = max(pt.work_len, 1)
    wk = torch.empty((S, B, 2), dtype=dt, device=dev)
    work = torch.empty((S, wl), dtype=dt, device=dev)
    rc = torch.empty((S, n_c), dtype=dt, device=dev)
    lam = torch.empty((S, B), dtype=dt, device=dev)
    w0 = work.data_ptr()
    args = _PeelArgs(has_pairs=int(dtp.num_pairs > 0), n_peeled=n_p, B=B, chan=R_ONLY,
                     tab=pt.table.data_ptr(), w_pairs=None, dr=dr.data_ptr(), wk=wk.data_ptr(),
                     work=w0, dc=None, rc=rc.data_ptr(), x=None, lam=lam.data_ptr(),
                     sw=state.w.data_ptr(), sd=state.db.data_ptr(), sr=w0 + 16 * n_p,
                     fac=state.factor.data_ptr(), S=S, s_wp=0, s_dr=2 * B, s_wk=2 * B, s_work=wl,
                     s_dc=0, s_rc=n_c, s_x=n_c, s_lam=B, s_sw=0, s_sd=0, s_sr=wl, s_fac=0)
    lib, host, stream = build.library(), pt.host.ctypes.data, build.stream_handle(dev)
    with torch.cuda.device(dev):
        _count(lib.nxfx_peel_forward(ctypes.byref(args), host, stream), peel_apply_scenarios)
    if n_c:
        x = solve_core(rc)
        _core_values(name, x, S, n_c, dev)
        args.x = x.data_ptr()
    with torch.cuda.device(dev):
        _count(lib.nxfx_peel_back(ctypes.byref(args), host, stream), peel_apply_scenarios)
    peel_apply_scenarios.launches += 1
    return lam


peel_apply_scenarios.launches = 0
peel_apply_scenarios.device = 0
