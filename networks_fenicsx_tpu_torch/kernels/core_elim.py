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

Every fold is K10 (:mod:`.fold`); the kernel does the per-round gathers,
products and inverse-map applies (two launches per round and direction),
the tail's gathers and its scatter.  The port solves a core in one call
(factor reuse is ROADMAP A3), so the dense tail's factor and solve run
together after the forward rounds; the arithmetic is the reference's.

:func:`core_elim` launches for CUDA tensors and runs :func:`core_elim_plain`
for CPU tensors.
"""

from __future__ import annotations

import typing

import torch

from ..ops.core_elim import DeviceCorePlan
from . import build, core_fronts, dense_core, fold

__all__ = [
    "CoreState", "core_apply_plain", "core_elim", "core_elim_plain", "core_factor_plain",
    "cuda_launches", "init_values_plain",
]


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


def _at(t: torch.Tensor, offset: int) -> int:
    """Device address of float64 element ``offset`` of ``t``."""
    return t.data_ptr() + 8 * offset


def core_elim(dcp: DeviceCorePlan, dc: torch.Tensor, w_pairs: torch.Tensor, rc: torch.Tensor,
              n_refine: int = dense_core.N_REFINE) -> torch.Tensor:
    """K12a on ``dc``'s device: ``λ_core (n_core,)`` of the core with peeled
    diagonal ``dc``, pair conductances ``w_pairs (P,)`` and rhs ``rc``
    (neither input is modified)."""
    if dc.device.type == "cpu":
        return core_elim_plain(dcp, dc, w_pairs, rc, n_refine)
    build.require_cuda("core_elim", dc, w_pairs, rc)
    build.require_cuda("core_elim", dcp.init_slot, dcp.dense_nodes, dtype=torch.int32)
    n = dcp.n_core
    if tuple(dc.shape) != (n,) or tuple(rc.shape) != (n,):
        raise ValueError("core_elim: dc and rc must be (n_core,)")
    dev, dt = dc.device, torch.float64
    lib = build.library()
    stream = build.stream_handle(dev)
    P0 = dcp.n_pairs
    d, r = dc.clone(), rc.clone()  # the rounds update both in place
    a = torch.empty(dcp.a_len, dtype=dt, device=dev)
    inv = torch.empty(dcp.s_len, dtype=dt, device=dev)
    rv = torch.empty(dcp.s_len, dtype=dt, device=dev)
    t = torch.empty(dcp.max_SK, dtype=dt, device=dev)
    contrib = torch.empty(dcp.max_M2, dtype=dt, device=dev)
    # the update stream; a fold's pad index mu_all reads zero
    ustream = torch.empty(dcp.mu_all, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        for rd in dcp.rounds:
            S, K = rd.S, rd.K
            ur = fold.fold_apply(ustream, rd.u_read) if rd.u_read else None
            code = lib.nxfx_core_round_terms(
                S, K, P0, rd.elim.data_ptr(), rd.init_idx.data_ptr(), dcp.init_slot.data_ptr(),
                w_pairs.data_ptr(), None if ur is None else ur.data_ptr(), d.data_ptr(),
                _at(a, rd.a_off), _at(inv, rd.s_off), t.data_ptr(), stream,
            )
            build.check(code, "core_elim")
            sd = fold.fold_apply(t[: S * K], rd.d_fold)
            code = lib.nxfx_core_round_update(
                n, rd.U1, rd.M2, K, rd.d_inv.data_ptr(), sd.data_ptr(), d.data_ptr(),
                rd.u_src_i.data_ptr(), rd.u_src_j.data_ptr(), _at(a, rd.a_off),
                _at(inv, rd.s_off), contrib.data_ptr(), stream,
            )
            build.check(code, "core_elim")
            if rd.M2:
                fold.fold_apply(contrib[: rd.M2], rd.u_fold,
                                out=ustream[rd.u_off : rd.u_off + rd.U2])
        for rd in dcp.rounds:
            S, K = rd.S, rd.K
            code = lib.nxfx_core_apply_terms(
                S, K, rd.elim.data_ptr(), _at(a, rd.a_off), _at(inv, rd.s_off), r.data_ptr(),
                _at(rv, rd.s_off), t.data_ptr(), stream,
            )
            build.check(code, "core_elim")
            sr = fold.fold_apply(t[: S * K], rd.d_fold)
            code = lib.nxfx_core_apply_update(n, rd.U1, rd.d_inv.data_ptr(), sr.data_ptr(),
                                              r.data_ptr(), stream)
            build.check(code, "core_elim")

        if dcp.fronts:
            lam = core_fronts.core_fronts(dcp, d, ustream, w_pairs, r)
        else:
            lam = torch.zeros(n + 1, dtype=dt, device=dev)
            Bd, Pd = int(dcp.dense_nodes.shape[0]), int(dcp.dp_init.shape[0])
            if Bd:
                dpf = fold.fold_apply(ustream, dcp.dp_fold) if dcp.dp_fold else None
                dd = torch.empty(Bd, dtype=dt, device=dev)
                rr = torch.empty(Bd, dtype=dt, device=dev)
                neg_ov = torch.empty(Pd, dtype=dt, device=dev)
                code = lib.nxfx_core_tail_gather(
                    Bd, Pd, P0, dcp.dense_nodes.data_ptr(), d.data_ptr(), r.data_ptr(),
                    dcp.dp_init.data_ptr(), dcp.init_slot.data_ptr(), w_pairs.data_ptr(),
                    None if dpf is None else dpf.data_ptr(), dd.data_ptr(), rr.data_ptr(),
                    neg_ov.data_ptr(), stream,
                )
                build.check(code, "core_elim")
                x = dense_core.dense_core(dcp.dense_di, dcp.dense_dj, dcp.dense_pid, dd, rr, neg_ov,
                                          n_refine)
                code = lib.nxfx_core_scatter_nodes(Bd, dcp.dense_nodes.data_ptr(), x.data_ptr(),
                                                   lam.data_ptr(), stream)
                build.check(code, "core_elim")

        for rd in reversed(dcp.rounds):
            code = lib.nxfx_core_back(
                rd.S, rd.K, rd.elim.data_ptr(), rd.nbr_node.data_ptr(), _at(a, rd.a_off),
                _at(inv, rd.s_off), _at(rv, rd.s_off), lam.data_ptr(), stream,
            )
            build.check(code, "core_elim")
    if dcp.rounds or dcp.dense_nodes.shape[0]:
        core_elim.launches += 1
    return lam[:n]


core_elim.launches = 0


def cuda_launches(dcp: DeviceCorePlan, n_refine: int = dense_core.N_REFINE) -> int:
    """CUDA kernel launches of one :func:`core_elim` call: per round the
    factor's folds and its two launches, the forward sweep's fold and its
    two launches, and the back-substitution; then the fronts' (K12b) or the
    dense tail's fold, gather, K11 and scatter."""
    fl = core_fronts.fold_launches
    n = 0
    for rd in dcp.rounds:
        n += fl(rd.u_read) + 2 + fl(rd.d_fold) + (fl(rd.u_fold) if rd.M2 else 0)
        n += 2 + fl(rd.d_fold) + 1
    if dcp.fronts:
        n += core_fronts.cuda_launches(dcp)
    elif dcp.dense_nodes.shape[0]:
        Bd, Pd = int(dcp.dense_nodes.shape[0]), int(dcp.dp_init.shape[0])
        n += fl(dcp.dp_fold) + 2 + dense_core.cuda_launches(Bd, Pd, n_refine)
    return n
