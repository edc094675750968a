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
memory; a larger one as a cooperative grid (:func:`launch_grid`).  A solve
factors and solves in one call, so the forward launch runs the rounds'
factor beside their forward sweep and the dense tail's factor and solve run
together after it: factor reuse (:mod:`..factorization`) does not take a
min-degree core yet and raises ``NotImplementedError`` (ROADMAP A3b: the
rounds split from their forward sweep, the tail's factor from its solve,
K12b's fronts' factor from their solves).  The arithmetic is the
reference's.

:func:`core_elim` launches for CUDA tensors and runs :func:`core_elim_plain`
for CPU tensors.  :func:`core_elim_table_plain` runs the kernels' order from
the packed table (the folds' last levels summed by their readers, the
forward sweep beside the factor): ``λ_core`` equal to :func:`core_elim_plain`'s
to the bit.
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
    "CoreState", "ONE_BLOCK_CORE", "ONE_BLOCK_WORK", "core_apply_plain", "core_elim",
    "core_elim_plain", "core_elim_table_plain", "core_factor_plain", "cuda_launches",
    "init_values_plain", "launch_grid",
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


class CoreState(typing.NamedTuple):
    """The factor half of the plain version (the reference's ``_core_factor``
    state, its dense tail not yet factored: the port factors and solves it
    in one call)."""

    d: torch.Tensor  # (n_core,) the diagonal after the rounds
    ustream: torch.Tensor  # (mu_all + 1,) the update stream, its last entry 0
    rounds: tuple  # per round (a (S, K), inv (S,))


def core_factor_plain(dcp: DeviceCorePlan, dc: torch.Tensor, w_pairs: torch.Tensor) -> CoreState:
    """Eager version of the rounds' factor (the reference's loop)."""
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
    return CoreState(d, ustream, tuple(saved))


def core_apply_plain(dcp: DeviceCorePlan, state: CoreState, w_pairs: torch.Tensor,
                     rc: torch.Tensor, n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """Eager version of the apply: the forward rounds, the fronts or the
    dense tail, the back-substitution; ``λ_core (n_core,)``."""
    dt, dev = torch.float64, rc.device
    zero = torch.zeros(1, dtype=dt, device=dev)
    r = rc.clone()
    rvs = []
    for rd, (a, inv) in zip(dcp.rounds, state.rounds):
        rv = r[rd.elim.long()]
        s = fold.fold_apply_plain(((a * inv[:, None]) * rv[:, None]).reshape(-1), rd.d_fold)
        r = r - torch.cat([s, zero])[rd.d_inv.long()]
        rvs.append(rv)

    n, d = dcp.n_core, state.d
    if dcp.fronts:
        lam = core_fronts.core_fronts_plain(dcp, d, state.ustream, w_pairs, r)
    else:
        lam = torch.zeros(n + 1, dtype=dt, device=dev)
        if dcp.dense_nodes.shape[0]:
            dn = dcp.dense_nodes.long()
            ov = init_values_plain(dcp, w_pairs)[dcp.dp_init.long()]
            if dcp.dp_fold:
                ov = ov - fold.fold_apply_plain(state.ustream, dcp.dp_fold)
            lam[dn] = dense_core.dense_core_plain(dcp.dense_di, dcp.dense_dj, dcp.dense_pid, d[dn],
                                                  r[dn], -ov, n_refine)

    for rd, (a, inv), rv in zip(reversed(dcp.rounds), reversed(state.rounds), reversed(rvs)):
        new = (rv - _ordered_row_sum(a * lam[rd.nbr_node.long()])) * inv
        e_inv = rd.e_inv.long()
        lam = torch.where(e_inv < rd.S, torch.cat([new, zero])[e_inv], lam)
    return lam[:n]


def core_elim_plain(dcp: DeviceCorePlan, dc: torch.Tensor, w_pairs: torch.Tensor,
                    rc: torch.Tensor, n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """Eager version, the reference's loops: ``λ_core (n_core,)``, NaN when
    the dense tail's or a front's pivot gate trips."""
    return core_apply_plain(dcp, core_factor_plain(dcp, dc, w_pairs), w_pairs, rc, n_refine)


def core_elim_table_plain(dcp: DeviceCorePlan, dc: torch.Tensor, w_pairs: torch.Tensor,
                          rc: torch.Tensor, n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """:func:`core_elim_plain` in the kernels' order, every index from the
    packed round table ``dcp.rt``: per round the terms (the slot values, the
    pivots' inverses, the swept rhs and both channels of terms), the
    diagonal and rhs updates, the fill contributions and their stream
    segment; then the tail or the fronts, and the back-substitution."""
    W = plan_words
    words = dcp.rt.host.astype(np.int64)
    dt, dev = torch.float64, dc.device

    def T(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    def folded(levels, vec):
        for lv, _ in levels:
            vec = segsum.segsum_plain(T(lv), vec)
        return vec

    n, mu = int(words[W.G_NCORE]), int(words[W.G_MU])

    def init(pid):  # a slot's initial value from its pair id, 0 at -1
        pid = T(pid)
        return torch.where(pid >= 0, -w_pairs[pid.clamp(min=0)], torch.zeros((), dtype=dt, device=dev))

    ustream = torch.zeros(mu + 1, dtype=dt, device=dev)
    d, r = dc.clone(), rc.clone()
    saved = []
    for k in range(int(words[W.G_ROUNDS])):
        rd = W._round_arrays(words, k)
        S, K = rd["S"], rd["K"]
        a = init(rd["init_pid"])
        if rd["u_read"]:
            a = a - folded(rd["u_read"], ustream[:mu])
        e = T(rd["elim"])
        inv, rv = 1.0 / d[e], r[e]
        ai = a * inv.repeat_interleave(K)
        sums = folded(rd["d_fold"], torch.stack([a * ai, ai * rv.repeat_interleave(K)], dim=1))
        node = T(rd["d_node"])
        hit = node >= 0
        d[node[hit]] = d[node[hit]] - sums[hit, 0]
        r[node[hit]] = r[node[hit]] - sums[hit, 1]
        if rd["M2"]:
            contrib = a[T(rd["u_src_i"])] * ai[T(rd["u_src_j"])]
            ustream[rd["u_off"] : rd["u_off"] + rd["U2"]] = folded(rd["u_fold"], contrib)
        saved.append((rd, a.reshape(S, K), inv, rv))
    if dcp.fronts:
        lam = core_fronts.core_fronts_plain(dcp, d, ustream, w_pairs, r)
    else:
        lam = torch.zeros(n + 1, dtype=dt, device=dev)
        # the tail is the plan's (a copy of it without one keeps the table)
        Bd, Pd = int(dcp.dense_nodes.shape[0]), int(dcp.dp_init.shape[0])
        if Bd:
            dn = T(words[int(words[W.G_DN]) : int(words[W.G_DN]) + Bd])
            ov = init(words[int(words[W.G_DPINIT]) : int(words[W.G_DPINIT]) + Pd])
            dp = W._fold_levels(words, W.G_DPFOLD)
            if dp:
                ov = ov - folded(dp, ustream[:mu])
            lam[dn] = dense_core.dense_core_plain(dcp.dense_di, dcp.dense_dj, dcp.dense_pid, d[dn],
                                                  r[dn], -ov, n_refine)
    for rd, a, inv, rv in reversed(saved):
        nbr = T(rd["nbr"]).reshape(a.shape)
        acc = a[:, 0] * lam[nbr[:, 0]]
        for j in range(1, a.shape[1]):
            acc = acc + a[:, j] * lam[nbr[:, j]]
        lam[T(rd["elim"])] = (rv - acc) * inv
    return lam[:n]


class _CoreArgs(ctypes.Structure):
    """``CoreArgs`` of ``csrc/core_elim.cu``."""

    _fields_ = ([(f, ctypes.c_int) for f in ("head_words", "staged", "n_core", "tail", "zero_lam", "grid")]
                + [(f, ctypes.c_void_p) for f in ("tab", "w_pairs", "dc", "rc", "d", "r", "work", "dd",
                                                  "rr", "neg_ov", "x", "lam")])


_GRID_BLOCKS: dict = {}


def launch_grid(dcp: DeviceCorePlan, index: int | None = None) -> int:
    """The launch size of ``dcp``'s rounds: 0 for one block (a core of at
    most :data:`ONE_BLOCK_CORE` nodes whose widest phase is at most
    :data:`ONE_BLOCK_WORK` entries), else the cooperative grid's blocks
    (its widest phase over :data:`GRID_THREADS`, at most the blocks resident
    on CUDA device ``index``; 1 without a device)."""
    rt = dcp.rt
    if dcp.n_core <= ONE_BLOCK_CORE and rt.max_work <= ONE_BLOCK_WORK:
        return 0
    want = max(1, -(-rt.max_work // GRID_THREADS))
    if index is None:
        return want
    staged = int(4 * rt.head_words <= STAGE_HEAD)
    key = (index, rt.head_words, staged)
    if key not in _GRID_BLOCKS:
        with torch.cuda.device(index):
            _GRID_BLOCKS[key] = build.library().nxfx_core_grid_blocks(index, rt.head_words, staged)
        if _GRID_BLOCKS[key] <= 0:
            raise RuntimeError("core_elim: no cooperative grid fits the device")
    return min(want, _GRID_BLOCKS[key])


def core_elim(dcp: DeviceCorePlan, dc: torch.Tensor, w_pairs: torch.Tensor, rc: torch.Tensor,
              n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """K12a on ``dc``'s device: ``λ_core (n_core,)`` of the core with peeled
    diagonal ``dc``, pair conductances ``w_pairs (P,)`` and rhs ``rc``
    (neither input is modified)."""
    if dc.device.type == "cpu":
        return core_elim_plain(dcp, dc, w_pairs, rc, n_refine)
    build.require_cuda("core_elim", dc, w_pairs, rc)
    build.require_cuda("core_elim", dcp.init_slot, dcp.dense_nodes, dcp.rt.table, dtype=torch.int32)
    n = dcp.n_core
    if tuple(dc.shape) != (n,) or tuple(rc.shape) != (n,):
        raise ValueError("core_elim: dc and rc must be (n_core,)")
    if dcp.rt.table.device != dc.device:
        raise ValueError("core_elim: the plan's table must be on dc's device")
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
    d = torch.empty(n, dtype=dt, device=dev)
    r = torch.empty(n, dtype=dt, device=dev)
    work = torch.empty(max(rt.work_len, 1), dtype=dt, device=dev)
    dd, rr, neg_ov = (torch.empty(m, dtype=dt, device=dev) for m in (Bd, Bd, Pd))
    lam = torch.empty(n + 1, dtype=dt, device=dev)
    args = _CoreArgs(
        head_words=rt.head_words, staged=int(4 * rt.head_words <= STAGE_HEAD), n_core=n,
        tail=int(tail), zero_lam=int(not dcp.fronts), grid=launch_grid(dcp, dev.index),
        tab=rt.table.data_ptr(), w_pairs=w_pairs.data_ptr(),
        dc=dc.data_ptr(), rc=rc.data_ptr(), d=d.data_ptr(), r=r.data_ptr(), work=work.data_ptr(),
        dd=dd.data_ptr(), rr=rr.data_ptr(), neg_ov=neg_ov.data_ptr(), lam=lam.data_ptr(),
    )
    with torch.cuda.device(dev):
        build.check(lib.nxfx_core_forward(ctypes.byref(args), stream), "core_elim")
        if dcp.fronts:
            us = rt.word(plan_words.G_US)
            lam = core_fronts.core_fronts(dcp, d, work[us : us + dcp.mu_all], w_pairs, r)
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
