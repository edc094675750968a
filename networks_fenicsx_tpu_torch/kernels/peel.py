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
from .level_eliminate import _prepare_plain

__all__ = ["CUT", "cuda_launches", "lambda_system", "lambda_system_plain", "lambda_sums", "peel",
           "peel_plain", "peel_table_plain"]

CUT = 1024  # the narrowest round a grid launch takes; narrower runs are one block

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


class _PeelArgs(ctypes.Structure):
    """``PeelArgs`` of ``csrc/peel.cu``."""

    _fields_ = ([(f, ctypes.c_int) for f in ("has_pairs", "n_peeled", "B")]
                + [(f, ctypes.c_void_p)
                   for f in ("tab", "w_pairs", "dr", "wk", "work", "dc", "rc", "x", "lam")])


def _count(enqueued: int) -> None:
    """Count a launcher's kernels (minus a CUDA error when negative)."""
    if enqueued < 0:
        build.check(-enqueued, "peel")
    peel.device += enqueued


def peel(dtp, dr: torch.Tensor, w_pairs: torch.Tensor, solve_core: CoreSolve):
    """K9 on ``dr``'s device: ``λ (B,)``.  ``dr (B, 2)`` is the assembled
    (diagonal, rhs) and is not modified; ``solve_core`` gets the core's
    folded ``(d, r)`` and returns its ``λ``.  On CUDA one launcher call
    each way walks the plan's :class:`..ops.peel_table.PeelTable`."""
    if dr.device.type == "cpu":
        return peel_plain(dtp, dr, w_pairs, solve_core)
    build.require_cuda("peel", dr, w_pairs)
    B, n_c, pt = dtp.num_bifurcations, dtp.core_size, dtp.peel_table
    if tuple(dr.shape) != (B, 2) or tuple(w_pairs.shape) != (dtp.num_pairs,):
        raise ValueError("peel: dr must be (B, 2) and w_pairs (P,)")
    if pt.table.device != dr.device:
        raise ValueError("peel: the plan's table must be on dr's device")
    dev, dt = dr.device, torch.float64
    lib = build.library()
    stream = build.stream_handle(dev)
    wk = torch.empty((B, 2), dtype=dt, device=dev)  # the updated nodes' (d, r); dr is only read
    work = torch.empty(max(pt.work_len, 1), dtype=dt, device=dev)
    dc = torch.empty(n_c, dtype=dt, device=dev)
    rc = torch.empty(n_c, dtype=dt, device=dev)
    lam = torch.empty(B, dtype=dt, device=dev)
    args = _PeelArgs(has_pairs=int(dtp.num_pairs > 0), n_peeled=dtp.n_peeled, B=B,
                     tab=pt.table.data_ptr(), w_pairs=w_pairs.data_ptr(), dr=dr.data_ptr(),
                     wk=wk.data_ptr(), work=work.data_ptr(), dc=dc.data_ptr(), rc=rc.data_ptr(),
                     x=None, lam=lam.data_ptr())
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
    """K9's CUDA launches of one :func:`peel` call: its table's entries each
    way."""
    return dtp.peel_table.launches
