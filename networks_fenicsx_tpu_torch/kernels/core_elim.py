"""K12a: the min-degree rounds of the sparse core elimination (``csrc/core_elim.cu``).

Replaces ``networks_fenicsx_tpu/ops/core_elim.py:_core_factor`` and
``_core_apply`` (``:879-1050``) for a :class:`..ops.core_elim.CoreElimPlan`:
solve the core system ``(diag dc, off-diagonals −w_pairs) λ = rc``.

* Factor, per round: the slot values ``a (S, K) = init_ext[init_idx] −
  fold(ustream, u_read)`` with ``init_ext = [−w_pairs[init_slot], 0]``, the
  pivots' inverses ``inv = 1/d[elim]``, ``d −= fold(a·a·inv)`` through
  ``d_fold`` and ``d_inv``, and the fill updates ``fold(a[u_src_i]·(a·inv)
  [u_src_j])`` written into the update stream at ``u_off``.
* Apply: forward ``r −= fold(a·inv·r[elim])`` per round; the remainder —
  the supernodal fronts (K12b, :mod:`.core_fronts`) or the dense tail (K11,
  :mod:`.dense_core`, on ``d`` and ``r`` at the dense nodes and the pair
  values ``init_ext[dp_init] − fold(ustream, dp_fold)``, given negated with
  the pair ids ``dense_pid = 0, 1, …``); then the rounds in
  reverse, ``λ[elim] = (r_e − Σ_k a·λ[nbr_node])·inv`` (pads read
  ``λ[n_core] = 0``).

On the card a solve is two launches around the tail's (K11's) or the
fronts' (K12b's): the factor's and the forward sweep's rounds with every
fold inside (as K10 sums it, ``csrc/fold.cuh``) and the tail's gathers,
then the tail's scatter and the back-substitution, each walking the
plan's packed round table (:class:`..ops.core_elim.RoundTable`).  A core
whose phases fit one block runs in one block, ``d`` and ``r`` in shared
memory; a larger one as a cooperative grid (:func:`launch_grid`, the
resident blocks of each kernel from an occupancy query on it).  The
arithmetic is the reference's.

Factor reuse (:mod:`..factorization`, the reference's ``_core_factor`` and
``_core_apply``) splits the solve: :func:`core_factor` once — the rounds'
factor launch (the ``d`` channel alone: the slot values, the pivots'
inverses and the update stream into a factor buffer of the table's layout,
the tail's ``d`` and ``−ov`` gathers), then the dense tail's K11 factor and
gate or K12b's fronts' factor — and :func:`core_apply` a right-hand side:
the apply's forward launch (the ``r`` channel on the stored ``a`` and
``inv``, ``a·inv`` formed as the fused launch forms it, the tail's rhs
gather) with a scratch of its own, K11's solve or K12b's sweeps, and the
back launch.  Each channel's folds sum the same rows in the same order as
the fused launch's, so the split's ``d``, ``r``, slot values and stream
are the fused launch's to the bit; the tail's split solve is within
1.7e-15·scale of the fused K11's.  An apply only reads the factor.

:func:`core_elim` launches for CUDA tensors and runs :func:`core_elim_plain`
for CPU tensors, :func:`core_factor` and :func:`core_apply` likewise their
plain versions, the reference's loops (:func:`core_factor_plain`,
:func:`core_apply_plain`; ``core_elim_plain`` is the two in a row).
:func:`core_factor_table_plain` and :func:`core_apply_table_plain` run the
split kernels' order from the packed table (the folds' last levels summed
by their readers), :func:`core_elim_table_plain` the two in a row:
``λ_core`` equal to :func:`core_elim_plain`'s to the bit.
"""

from __future__ import annotations

import ctypes
import typing

import numpy as np
import torch

from ..ops import core_elim as plan_words
from ..ops.core_elim import DeviceCorePlan
from . import build, core_fronts, dense_core, fold, segsum

__all__ = [
    "APPLY", "BACK", "CoreFactor", "FACTOR", "FUSED", "ONE_BLOCK_CORE", "ONE_BLOCK_WORK",
    "apply_launches", "core_apply", "core_apply_plain", "core_apply_table_plain", "core_elim",
    "core_elim_plain", "core_elim_table_plain", "core_factor", "core_factor_plain",
    "core_factor_table_plain", "cuda_launches", "factor_launches", "factor_rounds",
    "factor_stream", "init_values_plain", "launch_grid",
]

# One launch size or the other, by the plan's size (neither runs the plain version):
ONE_BLOCK_CORE = 4096  # cores whose d and r (64 KB) one block keeps in shared memory
ONE_BLOCK_WORK = 8192  # the widest phase one block of 1,024 threads takes
STAGE_HEAD = 48 * 1024  # header bytes a block stages into shared memory (else read in place)
GRID_THREADS = 512  # a cooperative block's threads, a block an SM (csrc/core_elim.cu)


def init_values_plain(dcp: DeviceCorePlan, w_pairs: torch.Tensor) -> torch.Tensor:
    """``init_ext (P0 + 1,)``: ``−w_pairs[init_slot]`` and a trailing zero."""
    zero = torch.zeros(1, dtype=torch.float64, device=w_pairs.device)
    return torch.cat([-w_pairs[dcp.init_slot.long()], zero])


def _ordered_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the columns of ``x (S, K)``, added in column order (the kernel's)."""
    acc = x[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
    return acc


class CoreFactor(typing.NamedTuple):
    """K12a's stored factor of a min-degree core (the reference's
    ``_core_factor`` state), what :func:`core_apply` solves against."""

    fac: torch.Tensor  # (rt.fac_len,) the rounds' slot values a, the pivots' inverses inv
    # and the update stream, end to end in the round table's factor layout
    d: torch.Tensor  # (n_core,) the diagonal after the rounds
    tail: tuple | None  # K11's (Lc, s, C, ok) of the dense tail (dense_factor, dense_gate)
    fronts: core_fronts.FrontsFactor | None  # K12b's factor


def factor_rounds(dcp: DeviceCorePlan, fac: torch.Tensor) -> tuple:
    """``((a (S, K), inv (S,)), ...)``: each round's slot values and pivots'
    inverses, views of a factor buffer."""
    out, a_off, s_off = [], 0, dcp.a_len
    for rd in dcp.rounds:
        S, K = rd.S, rd.K
        out.append((fac[a_off : a_off + S * K].view(S, K), fac[s_off : s_off + S]))
        a_off += S * K
        s_off += S
    return tuple(out)


def factor_stream(dcp: DeviceCorePlan, fac: torch.Tensor) -> torch.Tensor:
    """The update stream ``(mu_all,)`` of a factor buffer (a view)."""
    us = dcp.a_len + dcp.s_len
    return fac[us : us + dcp.mu_all]


def _tail_factor_plain(dcp: DeviceCorePlan, d: torch.Tensor, ov: torch.Tensor) -> tuple:
    """K11's factor and gate of the dense tail: ``(Lc, s, C, ok)``."""
    Lc, s, C = dense_core.dense_factor_plain(dcp.dense_di, dcp.dense_dj, dcp.dense_pid, d, -ov)
    return Lc, s, C, dense_core.dense_gate_plain(C)


def core_factor_plain(dcp: DeviceCorePlan, dc: torch.Tensor, w_pairs: torch.Tensor) -> CoreFactor:
    """Eager version of the factor, the reference's loops: the rounds (the
    slot values, the pivots' inverses, the diagonal and the update stream),
    then the dense tail's K11 factor and gate or the fronts' factor."""
    dt, dev = torch.float64, dc.device
    zero = torch.zeros(1, dtype=dt, device=dev)
    init_ext = init_values_plain(dcp, w_pairs)
    ustream = torch.zeros(dcp.mu_all + 1, dtype=dt, device=dev)
    d = dc.clone()
    saved = []
    for rd in dcp.rounds:
        e = rd.elim.long()
        a = init_ext[rd.init_idx.long()]
        if rd.u_read:
            a = a - fold.fold_apply_plain(ustream, rd.u_read).reshape(a.shape)
        inv = 1.0 / d[e]
        ainv = a * inv[:, None]
        s = fold.fold_apply_plain((a * ainv).reshape(-1), rd.d_fold)
        d = d - torch.cat([s, zero])[rd.d_inv.long()]
        if rd.M2:
            contrib = a.reshape(-1)[rd.u_src_i.long()] * ainv.reshape(-1)[rd.u_src_j.long()]
            su = fold.fold_apply_plain(contrib, rd.u_fold)
            ustream[rd.u_off : rd.u_off + su.shape[0]] = su
        saved.append((a, inv))
    fac = torch.cat([a.reshape(-1) for a, _ in saved] + [inv for _, inv in saved]
                    + [ustream[: dcp.mu_all]])
    tail = fronts = None
    if dcp.fronts:
        fronts = core_fronts.core_fronts_factor_plain(dcp, d, ustream, w_pairs)
    elif dcp.dense_nodes.shape[0]:
        ov = init_ext[dcp.dp_init.long()]
        if dcp.dp_fold:
            ov = ov - fold.fold_apply_plain(ustream, dcp.dp_fold)
        tail = _tail_factor_plain(dcp, d[dcp.dense_nodes.long()], ov)
    return CoreFactor(fac, d, tail, fronts)


def apply_forward_plain(dcp: DeviceCorePlan, fac: torch.Tensor, rc: torch.Tensor) -> tuple:
    """The apply's forward rounds on a factor buffer, the reference's loop:
    ``(r, rvs)``, the swept rhs (the input of the fronts' sweeps and of the
    tail's solve) and each round's pivot values ``r[elim]``."""
    zero = torch.zeros(1, dtype=torch.float64, device=rc.device)
    r = rc.clone()
    rvs = []
    for rd, (a, inv) in zip(dcp.rounds, factor_rounds(dcp, fac)):
        rv = r[rd.elim.long()]
        s = fold.fold_apply_plain(((a * inv[:, None]) * rv[:, None]).reshape(-1), rd.d_fold)
        r = r - torch.cat([s, zero])[rd.d_inv.long()]
        rvs.append(rv)
    return r, rvs


def core_apply_plain(dcp: DeviceCorePlan, factor: CoreFactor, rc: torch.Tensor,
                     n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """Eager version of the apply, the reference's loops: the forward
    rounds, the fronts' sweeps or the dense tail's solve, the
    back-substitution; ``λ_core (n_core,)``."""
    dt, dev = torch.float64, rc.device
    zero = torch.zeros(1, dtype=dt, device=dev)
    rounds = factor_rounds(dcp, factor.fac)
    r, rvs = apply_forward_plain(dcp, factor.fac, rc)

    n = dcp.n_core
    if dcp.fronts:
        lam = core_fronts.core_fronts_apply_plain(dcp, factor.fronts, r)
    else:
        lam = torch.zeros(n + 1, dtype=dt, device=dev)
        if factor.tail is not None:
            dn = dcp.dense_nodes.long()
            lam[dn] = dense_core.dense_solve_plain(*factor.tail, r[dn], n_refine)

    for rd, (a, inv), rv in zip(reversed(dcp.rounds), reversed(rounds), reversed(rvs)):
        new = (rv - _ordered_row_sum(a * lam[rd.nbr_node.long()])) * inv
        e_inv = rd.e_inv.long()
        lam = torch.where(e_inv < rd.S, torch.cat([new, zero])[e_inv], lam)
    return lam[:n]


def core_elim_plain(dcp: DeviceCorePlan, dc: torch.Tensor, w_pairs: torch.Tensor,
                    rc: torch.Tensor, n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """Eager version, the reference's loops: ``λ_core (n_core,)``, NaN when
    the dense tail's or a front's pivot gate trips."""
    return core_apply_plain(dcp, core_factor_plain(dcp, dc, w_pairs), rc, n_refine)


def _table_plain(dcp: DeviceCorePlan, device):
    """``(words, T, folded)`` for the table-order plain versions."""
    words = dcp.rt.host.astype(np.int64)

    def T(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def folded(levels, vec):
        for lv, _ in levels:
            vec = segsum.segsum_plain(T(lv), vec)
        return vec

    return words, T, folded


def core_factor_table_plain(dcp: DeviceCorePlan, dc: torch.Tensor,
                            w_pairs: torch.Tensor) -> CoreFactor:
    """:func:`core_factor_plain` in the factor kernel's order, every index
    from the packed round table ``dcp.rt``: per round the slot values, the
    pivots' inverses and the ``d`` channel's terms, the diagonal update, the
    fill contributions and their stream segment, into the factor layout;
    then the tail's gathers and K11's factor, or the fronts' factor."""
    W = plan_words
    words, T, folded = _table_plain(dcp, dc.device)
    dt, dev = torch.float64, dc.device
    mu = int(words[W.G_MU])

    def init(pid):  # a slot's initial value from its pair id, 0 at -1
        pid = T(pid)
        return torch.where(pid >= 0, -w_pairs[pid.clamp(min=0)], torch.zeros((), dtype=dt, device=dev))

    fac = torch.zeros(int(words[W.G_FAC]), dtype=dt, device=dev)
    a_all, inv_all = fac[int(words[W.G_A]) :], fac[int(words[W.G_INV]) :]
    ustream = fac[int(words[W.G_US]) : int(words[W.G_US]) + mu]
    d = dc.clone()
    for k in range(int(words[W.G_ROUNDS])):
        rd = W._round_arrays(words, k)
        S, K = rd["S"], rd["K"]
        a = init(rd["init_pid"])
        if rd["u_read"]:
            a = a - folded(rd["u_read"], ustream)
        e = T(rd["elim"])
        inv = 1.0 / d[e]
        ai = a * inv.repeat_interleave(K)
        sums = folded(rd["d_fold"], a * ai)
        node = T(rd["d_node"])
        hit = node >= 0
        d[node[hit]] = d[node[hit]] - sums[hit]
        if rd["M2"]:
            contrib = a[T(rd["u_src_i"])] * ai[T(rd["u_src_j"])]
            ustream[rd["u_off"] : rd["u_off"] + rd["U2"]] = folded(rd["u_fold"], contrib)
        a_all[rd["a_off"] : rd["a_off"] + S * K] = a
        inv_all[rd["s_off"] : rd["s_off"] + S] = inv
    tail = fronts = None
    if dcp.fronts:
        zero = torch.zeros(1, dtype=dt, device=dev)
        fronts = core_fronts.core_fronts_factor_plain(dcp, d, torch.cat([ustream, zero]), w_pairs)
    else:
        # the tail is the plan's (a copy of it without one keeps the table)
        Bd, Pd = int(dcp.dense_nodes.shape[0]), int(dcp.dp_init.shape[0])
        if Bd:
            dn = T(words[int(words[W.G_DN]) : int(words[W.G_DN]) + Bd])
            ov = init(words[int(words[W.G_DPINIT]) : int(words[W.G_DPINIT]) + Pd])
            dp = W._fold_levels(words, W.G_DPFOLD)
            if dp:
                ov = ov - folded(dp, ustream)
            tail = _tail_factor_plain(dcp, d[dn], ov)
    return CoreFactor(fac, d, tail, fronts)


def core_apply_table_plain(dcp: DeviceCorePlan, factor: CoreFactor, rc: torch.Tensor,
                           n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """:func:`core_apply_plain` in the apply kernels' order from the packed
    table: per round the swept rhs and the ``r`` channel's terms on the
    stored ``a`` and ``inv``, the rhs update; the tail's gather and K11's
    solve or the fronts' sweeps; the back-substitution."""
    W = plan_words
    words, T, folded = _table_plain(dcp, rc.device)
    dt, dev = torch.float64, rc.device
    n = int(words[W.G_NCORE])
    fac = factor.fac
    r = rc.clone()
    saved = []
    for k in range(int(words[W.G_ROUNDS])):
        rd = W._round_arrays(words, k)
        S, K = rd["S"], rd["K"]
        a = fac[int(words[W.G_A]) + rd["a_off"] :][: S * K]
        inv = fac[int(words[W.G_INV]) + rd["s_off"] :][:S]
        rv = r[T(rd["elim"])]
        sums = folded(rd["d_fold"], (a * inv.repeat_interleave(K)) * rv.repeat_interleave(K))
        node = T(rd["d_node"])
        hit = node >= 0
        r[node[hit]] = r[node[hit]] - sums[hit]
        saved.append((rd, a.reshape(S, K), inv, rv))
    if dcp.fronts:
        lam = core_fronts.core_fronts_apply_plain(dcp, factor.fronts, r)
    else:
        lam = torch.zeros(n + 1, dtype=dt, device=dev)
        Bd = int(dcp.dense_nodes.shape[0])
        if Bd:
            dn = T(words[int(words[W.G_DN]) : int(words[W.G_DN]) + Bd])
            lam[dn] = dense_core.dense_solve_plain(*factor.tail, r[dn], n_refine)
    for rd, a, inv, rv in reversed(saved):
        nbr = T(rd["nbr"]).reshape(a.shape)
        acc = a[:, 0] * lam[nbr[:, 0]]
        for j in range(1, a.shape[1]):
            acc = acc + a[:, j] * lam[nbr[:, j]]
        lam[T(rd["elim"])] = (rv - acc) * inv
    return lam[:n]


def core_elim_table_plain(dcp: DeviceCorePlan, dc: torch.Tensor, w_pairs: torch.Tensor,
                          rc: torch.Tensor, n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """:func:`core_elim_plain` in the kernels' order: the apply's table
    order on the factor's (the fused forward launch makes each round's
    terms of both channels in one phase, the values are the same)."""
    return core_apply_table_plain(dcp, core_factor_table_plain(dcp, dc, w_pairs), rc, n_refine)


class _CoreArgs(ctypes.Structure):
    """``CoreArgs`` of ``csrc/core_elim.cu``."""

    _fields_ = ([(f, ctypes.c_int) for f in ("head_words", "staged", "n_core", "tail", "zero_lam", "grid")]
                + [(f, ctypes.c_void_p) for f in ("tab", "w_pairs", "dc", "rc", "d", "r", "work", "fac",
                                                  "dd", "rr", "neg_ov", "x", "lam")])


# the kernels of csrc/core_elim.cu, as nxfx_core_grid_blocks numbers them
FUSED, BACK, FACTOR, APPLY = range(4)
_GRID_BLOCKS: dict = {}


def launch_grid(dcp: DeviceCorePlan, index: int | None = None,
                kernels: tuple = (FUSED, BACK)) -> int:
    """The launch size of ``dcp``'s rounds: 0 for one block (a core of at
    most :data:`ONE_BLOCK_CORE` nodes whose widest phase is at most
    :data:`ONE_BLOCK_WORK` entries), else the cooperative grid's blocks
    (its widest phase over :data:`GRID_THREADS`, at most the blocks of each
    of ``kernels`` resident on CUDA device ``index``, from an occupancy
    query on that kernel; 1 without a device)."""
    rt = dcp.rt
    if dcp.n_core <= ONE_BLOCK_CORE and rt.max_work <= ONE_BLOCK_WORK:
        return 0
    want = max(1, -(-rt.max_work // GRID_THREADS))
    if index is None:
        return want
    staged = int(4 * rt.head_words <= STAGE_HEAD)
    for kernel in kernels:
        key = (index, rt.head_words, staged, kernel)
        if key not in _GRID_BLOCKS:
            with torch.cuda.device(index):
                _GRID_BLOCKS[key] = build.library().nxfx_core_grid_blocks(index, rt.head_words, staged,
                                                                          kernel)
            if _GRID_BLOCKS[key] <= 0:
                raise RuntimeError("core_elim: no cooperative grid fits the device")
        want = min(want, _GRID_BLOCKS[key])
    return want


def _args(dcp: DeviceCorePlan, tail: bool, **ptrs) -> _CoreArgs:
    """The launch arguments with the table's and the given tensors' pointers."""
    rt = dcp.rt
    return _CoreArgs(head_words=rt.head_words, staged=int(4 * rt.head_words <= STAGE_HEAD),
                     n_core=dcp.n_core, tail=int(tail), zero_lam=int(not dcp.fronts),
                     tab=rt.table.data_ptr(),
                     **{k: v.data_ptr() for k, v in ptrs.items()})


def _require_plan(name: str, dcp: DeviceCorePlan, core_vector: torch.Tensor,
                  *others: torch.Tensor) -> None:
    """The launch's inputs: float64 on one CUDA device with the plan's
    int32 tables, ``core_vector`` of ``n_core`` entries."""
    build.require_cuda(name, core_vector, *others)
    build.require_cuda(name, dcp.init_slot, dcp.dense_nodes, dcp.rt.table, dtype=torch.int32)
    if tuple(core_vector.shape) != (dcp.n_core,):
        raise ValueError(f"{name}: the core's vectors must be (n_core,)")
    if dcp.rt.table.device != core_vector.device:
        raise ValueError(f"{name}: the plan's table must be on the inputs' device")


def core_elim(dcp: DeviceCorePlan, dc: torch.Tensor, w_pairs: torch.Tensor, rc: torch.Tensor,
              n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """K12a on ``dc``'s device: ``λ_core (n_core,)`` of the core with peeled
    diagonal ``dc``, pair conductances ``w_pairs (P,)`` and rhs ``rc``
    (neither input is modified)."""
    if dc.device.type == "cpu":
        return core_elim_plain(dcp, dc, w_pairs, rc, n_refine)
    _require_plan("core_elim", dcp, dc, w_pairs, rc)
    n = dcp.n_core
    if tuple(rc.shape) != (n,):
        raise ValueError("core_elim: dc and rc must be (n_core,)")
    dev, dt = dc.device, torch.float64
    Bd, Pd = int(dcp.dense_nodes.shape[0]), int(dcp.dp_init.shape[0])
    if not (dcp.rounds or Bd or dcp.fronts):
        return torch.zeros(n, dtype=dt, device=dev)
    if not (dcp.rounds or Bd):  # the fronts alone: no round for K12a
        ustream = torch.empty(dcp.mu_all, dtype=dt, device=dev)
        return core_fronts.core_fronts(dcp, dc.clone(), ustream, w_pairs, rc.clone())[:n]
    rt = dcp.rt
    lib = build.library()
    stream = build.stream_handle(dev)
    tail = bool(Bd) and not dcp.fronts
    d, r = torch.empty(n, dtype=dt, device=dev), torch.empty(n, dtype=dt, device=dev)
    fac = torch.empty(max(rt.fac_len, 1), dtype=dt, device=dev)
    work = torch.empty(max(rt.work_len, 1), dtype=dt, device=dev)
    dd, rr, neg_ov = (torch.empty(m, dtype=dt, device=dev) for m in (Bd, Bd, Pd))
    lam = torch.empty(n + 1, dtype=dt, device=dev)
    args = _args(dcp, tail, w_pairs=w_pairs, dc=dc, rc=rc, d=d, r=r, work=work, fac=fac, dd=dd, rr=rr,
                 neg_ov=neg_ov, lam=lam)
    args.grid = launch_grid(dcp, dev.index)
    with torch.cuda.device(dev):
        build.check(lib.nxfx_core_forward(ctypes.byref(args), stream), "core_elim")
        if dcp.fronts:
            lam = core_fronts.core_fronts(dcp, d, factor_stream(dcp, fac), w_pairs, r)
            args.lam = lam.data_ptr()
        elif tail:
            x = dense_core.dense_core(dcp.dense_di, dcp.dense_dj, dcp.dense_pid, dd, rr, neg_ov,
                                      n_refine)
            args.x = x.data_ptr()
        build.check(lib.nxfx_core_back(ctypes.byref(args), stream), "core_elim")
    core_elim.launches += 1
    core_elim.device += 2
    return lam[:n]


core_elim.launches = 0
core_elim.device = 0  # K12a's own kernels enqueued (two a call)


def core_factor(dcp: DeviceCorePlan, dc: torch.Tensor, w_pairs: torch.Tensor) -> CoreFactor:
    """K12a's factor on ``dc``'s device, kept for :func:`core_apply`: the
    rounds' factor launch (the slot values, the pivots' inverses, the
    diagonal and the update stream into a factor buffer of its own, and the
    tail's ``d`` and ``−ov`` gathers), then the dense tail's K11 factor and
    gate (``dense_factor``, ``dense_gate``) or the fronts' factor
    (``core_fronts_factor``); :func:`core_factor_plain` for CPU tensors."""
    if dc.device.type == "cpu":
        return core_factor_plain(dcp, dc, w_pairs)
    _require_plan("core_factor", dcp, dc, w_pairs)
    n, dev, dt = dcp.n_core, dc.device, torch.float64
    Bd, Pd = int(dcp.dense_nodes.shape[0]), int(dcp.dp_init.shape[0])
    rt = dcp.rt
    fac = torch.empty(rt.fac_len, dtype=dt, device=dev)
    if not (dcp.rounds or Bd):  # no round for K12a: the fronts alone, or nothing
        fronts = (core_fronts.core_fronts_factor(dcp, dc, torch.empty(dcp.mu_all, dtype=dt, device=dev),
                                                 w_pairs) if dcp.fronts else None)
        return CoreFactor(fac, dc.clone(), None, fronts)
    tail = bool(Bd) and not dcp.fronts
    d = torch.empty(n, dtype=dt, device=dev)
    work = torch.empty(max(rt.work_len, 1), dtype=dt, device=dev)
    dd, neg_ov = torch.empty(Bd, dtype=dt, device=dev), torch.empty(Pd, dtype=dt, device=dev)
    args = _args(dcp, tail, w_pairs=w_pairs, dc=dc, d=d, work=work, fac=fac, dd=dd, neg_ov=neg_ov)
    args.grid = launch_grid(dcp, dev.index, (FACTOR,))
    with torch.cuda.device(dev):
        build.check(build.library().nxfx_core_factor(ctypes.byref(args), build.stream_handle(dev)),
                    "core_factor")
    core_factor.launches += 1
    core_factor.device += 1
    if dcp.fronts:
        return CoreFactor(fac, d, None, core_fronts.core_fronts_factor(dcp, d, factor_stream(dcp, fac),
                                                                       w_pairs))
    if tail:
        Lc, s, C = dense_core.dense_factor(dcp.dense_di, dcp.dense_dj, dcp.dense_pid, dd, neg_ov)
        return CoreFactor(fac, d, (Lc, s, C, dense_core.dense_gate(C)), None)
    return CoreFactor(fac, d, None, None)


core_factor.launches = 0
core_factor.device = 0  # K12a's own kernels enqueued (one a call with rounds or a tail)


def core_apply(dcp: DeviceCorePlan, factor: CoreFactor, rc: torch.Tensor,
               n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """K12a's solve on a stored factor on ``rc``'s device: ``λ_core
    (n_core,)``.  The apply's forward launch (the ``r`` channel on the
    stored ``a`` and ``inv``, the tail's rhs gather), the dense tail's K11
    solve (``dense_solve``) or the fronts' sweeps (``core_fronts_apply``),
    the back launch.  The factor is only read and each call takes a scratch
    of its own, so solves on one factor may run on several streams;
    :func:`core_apply_plain` for CPU tensors."""
    if rc.device.type == "cpu":
        return core_apply_plain(dcp, factor, rc, n_refine)
    _require_plan("core_apply", dcp, rc, factor.fac)
    n, dev, dt = dcp.n_core, rc.device, torch.float64
    rt = dcp.rt
    if tuple(factor.fac.shape) != (rt.fac_len,):
        raise ValueError("core_apply: the factor must be the plan's (fac_len,) factor buffer")
    Bd = int(dcp.dense_nodes.shape[0])
    if not (dcp.rounds or Bd):
        lam = (core_fronts.core_fronts_apply(dcp, factor.fronts, rc.clone()) if dcp.fronts
               else torch.zeros(n + 1, dtype=dt, device=dev))
        return lam[:n]
    tail = bool(Bd) and not dcp.fronts
    lib = build.library()
    stream = build.stream_handle(dev)
    r = torch.empty(n, dtype=dt, device=dev)
    work = torch.empty(max(rt.apply_len, 1), dtype=dt, device=dev)
    rr = torch.empty(Bd, dtype=dt, device=dev)
    lam = torch.empty(n + 1, dtype=dt, device=dev)
    args = _args(dcp, tail, rc=rc, r=r, work=work, fac=factor.fac, rr=rr, lam=lam)
    args.grid = launch_grid(dcp, dev.index, (APPLY,))
    with torch.cuda.device(dev):
        build.check(lib.nxfx_core_apply(ctypes.byref(args), stream), "core_apply")
        if dcp.fronts:
            lam = core_fronts.core_fronts_apply(dcp, factor.fronts, r)
            args.lam = lam.data_ptr()
        elif tail:
            x = dense_core.dense_solve(*factor.tail, rr, n_refine)
            args.x = x.data_ptr()
        args.grid = launch_grid(dcp, dev.index, (BACK,))
        build.check(lib.nxfx_core_back(ctypes.byref(args), stream), "core_apply")
    core_apply.launches += 1
    core_apply.device += 2
    return lam[:n]


core_apply.launches = 0
core_apply.device = 0  # K12a's own kernels enqueued (two a call with rounds or a tail)


def cuda_launches(dcp: DeviceCorePlan, n_refine: int = dense_core.N_REFINE) -> int:
    """CUDA kernel launches of one :func:`core_elim` call: the rounds' two
    (the factor and forward sweep with the tail's gathers; the back-
    substitution with the tail's scatter; none for fronts without rounds),
    and the fronts' (K12b) or the dense tail's K11 between them."""
    Bd = int(dcp.dense_nodes.shape[0])
    if not (dcp.rounds or Bd or dcp.fronts):
        return 0
    if dcp.fronts:
        return 2 * bool(dcp.rounds) + core_fronts.cuda_launches(dcp)
    if Bd:
        return 2 + dense_core.cuda_launches(Bd, int(dcp.dp_init.shape[0]), n_refine)
    return 2


def factor_launches(dcp: DeviceCorePlan) -> int:
    """CUDA kernel launches of one :func:`core_factor`: the rounds' factor
    launch (with rounds or a tail), then the fronts' factor or the dense
    tail's K11 assembly, factor and gate."""
    Bd = int(dcp.dense_nodes.shape[0])
    n = int(bool(dcp.rounds or Bd))
    if dcp.fronts:
        return n + core_fronts.factor_launches(dcp)
    if Bd:
        Pd = int(dcp.dp_init.shape[0])
        n += 1 + (Pd > 0) + dense_core.tiled_factor_launches(Bd, Bd) + 1
    return n


def apply_launches(dcp: DeviceCorePlan, n_refine: int = dense_core.N_REFINE) -> int:
    """CUDA kernel launches of one :func:`core_apply`: the apply's forward
    and back launches (with rounds or a tail) around the fronts' sweeps or
    the dense tail's K11 solve."""
    Bd = int(dcp.dense_nodes.shape[0])
    n = 2 * bool(dcp.rounds or Bd)
    if dcp.fronts:
        return n + core_fronts.apply_launches(dcp)
    return n + dense_core.solve_launches(Bd, n_refine)
