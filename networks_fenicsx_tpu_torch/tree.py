"""Peel-then-core Schur solve of a cyclic bifurcation graph (device side).

Counterpart of ``networks_fenicsx_tpu/solver.py``: the cyclic branch of
``_finish`` (``:4112-4118``) — ``_lambda_system_sorted`` (``:700-737``),
then ``_tree_schur_solve`` (``:3633-3660``) with ``_tree_eliminate_factor``
and ``_tree_eliminate_apply`` (``:3678-3812``).  On the bifurcation
Laplacian ``L λ = rhs``:

1. assemble the diagonal and rhs (:func:`.kernels.peel.lambda_system`: a
   prepare pass and two K6 sums added into the sides' sorted unique bins)
   and the per-pair conductances ``w_pairs`` (K6);
2. peel the degree-≤1 nodes in the plan's rounds, folding each round into
   its parents (K9 with its K10 folds, :mod:`.kernels.peel`);
3. solve the cycle core as ``_tree_eliminate_factor/_apply`` dispatch
   (``:3718-3743``, ``:3777-3798``): by the tree multifrontal engine when
   its plan is an ``MFPlan`` (K13–K14 factor, K15 apply:
   :mod:`.kernels.mf_factor`, :mod:`.kernels.mf_apply`), by the min-degree
   elimination when it is a ``CoreElimPlan`` (K12a rounds with K10 folds,
   then the dense tail on K11 or the supernodal fronts K12b:
   :mod:`.kernels.core_elim`, :mod:`.kernels.core_fronts`), and densely
   without a plan (K11, :mod:`.kernels.dense_core`);
4. back-substitute the rounds in reverse (K9).

:func:`device_tree_plan` precomputes, once per executor, every round's
tables and fold levels and the core's index tensors, so a solve runs one
launch loop over the rounds and nothing else per round in Python.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .levels import _LambdaPlan, _TreePlan, segsum_matrix
from .ops.core_elim import CoreElimPlan, DeviceCorePlan, _plan_fold, device_core_plan
from .ops.multifrontal import DeviceMFPlan, MFPlan, device_mf_plan

__all__ = [
    "DeviceRound", "DeviceTreePlan", "cuda_launches", "device_tree_plan", "tree_schur_solve",
]


@dataclasses.dataclass(frozen=True)
class DeviceRound:
    """One peel round on the device.

    Attributes:
        elim: ``(n,)`` eliminated nodes (ascending, unique).
        parents: ``(n,)`` each one's surviving neighbour, ``-1`` if none.
        pair_ids: ``(n,)`` the pair to the parent, ``-1`` if none.
        upar: ``(U,)`` sorted unique parents.
        fold: the K10 plan summing the round's ``n`` terms into ``upar``
            (``_plan_fold`` levels as int32 tensors; empty when ``U = 0``).
        offset: the round's offset in the solve's saved ``(w, d, r)`` stream.
    """

    elim: torch.Tensor
    parents: torch.Tensor
    pair_ids: torch.Tensor
    upar: torch.Tensor
    fold: tuple
    offset: int

    @property
    def size(self) -> int:
        return int(self.elim.shape[0])


@dataclasses.dataclass(frozen=True)
class DeviceTreePlan:
    """A :class:`.levels._TreePlan` and :class:`.levels._LambdaPlan` on one
    device, uploaded once per executor.

    Attributes:
        plan: The host tree plan (with its attached core plan, if any).
        start_bif, end_bif: ``(E,)`` bifurcation at each edge end, ``-1`` at
            a boundary node (what the edge-data kernel reads).
        t_idx, s_idx: ``(S, K)`` K6 gather matrices of the target- and
            source-side sums of ``_lambda_system_sorted``; ``t_bins``,
            ``s_bins`` the sorted unique bifurcations they add into.
        pair_idx: ``(P, K)`` K6 gather matrix of the edge → pair
            conductance sum.
        rounds: the peel rounds, in order.
        n_peeled: peeled nodes in all (the saved stream's length).
        core_nodes: ``(n_c,)`` the cycle core's nodes.
        core_ci, core_cj, core_pid: ``(P0,)`` the core pairs (core ranks,
            pair id), read by the dense core.
        mf: the multifrontal device plan when the core plan is one, else None.
        ce: the min-degree device plan when the core plan is a
            ``CoreElimPlan``, else None.
        num_bifurcations: B.
    """

    plan: _TreePlan
    start_bif: torch.Tensor
    end_bif: torch.Tensor
    t_idx: torch.Tensor
    t_bins: torch.Tensor
    s_idx: torch.Tensor
    s_bins: torch.Tensor
    pair_idx: torch.Tensor
    rounds: tuple
    n_peeled: int
    core_nodes: torch.Tensor
    core_ci: torch.Tensor
    core_cj: torch.Tensor
    core_pid: torch.Tensor
    mf: DeviceMFPlan | None
    ce: DeviceCorePlan | None
    num_bifurcations: int

    @property
    def num_edges(self) -> int:
        return int(self.start_bif.shape[0])

    @property
    def num_pairs(self) -> int:
        return int(self.plan.pair_nodes.shape[0])

    @property
    def core_size(self) -> int:
        return int(self.core_nodes.shape[0])

    @property
    def max_round(self) -> int:
        return max((rd.size for rd in self.rounds), default=0)


def round_tables(elim: np.ndarray, parents: np.ndarray) -> tuple[np.ndarray, tuple]:
    """``(upar, fold levels)`` of one round: its sorted unique parents and
    the ``_plan_fold`` plan of the reference's per-round fold
    (``:3703-3712``)."""
    sel = np.flatnonzero(parents >= 0)
    upar, inv = np.unique(parents[sel], return_inverse=True)
    if not upar.size:
        return upar, ()
    return upar, _plan_fold(inv, upar.size, sel, int(parents.size))


def device_tree_plan(
    tree_plan: _TreePlan, lam_plan: _LambdaPlan, asm, device: torch.device | str
) -> DeviceTreePlan:
    """Upload the peel rounds, the λ-system plan and the core to ``device``;
    the core runs the multifrontal engine when its plan is an
    :class:`.ops.multifrontal.MFPlan`, the min-degree elimination when it is
    a :class:`.ops.core_elim.CoreElimPlan`, and the dense core otherwise."""

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    E = int(tree_plan.edge_pair.size)
    P = int(tree_plan.pair_nodes.shape[0])
    ep = tree_plan.edge_pair
    sel = np.flatnonzero(ep >= 0)
    ids = ep[sel]
    order = np.argsort(ids, kind="stable")
    pair_idx = segsum_matrix(ids[order], P, E, sel=sel[order])
    rounds = []
    off = 0
    for elim, parents, pair_ids in tree_plan.rounds:
        upar, fold = round_tables(elim, parents)
        rounds.append(DeviceRound(
            elim=up(elim), parents=up(parents), pair_ids=up(pair_ids), upar=up(upar),
            fold=tuple(up(lv) for lv in fold), offset=off,
        ))
        off += int(elim.size)
    cp = np.asarray(tree_plan.core_pairs)
    lp = lam_plan
    return DeviceTreePlan(
        plan=tree_plan,
        start_bif=up(asm._edge_start_bif),
        end_bif=up(asm._edge_end_bif),
        t_idx=up(segsum_matrix(lp.t_seg, lp.t_bins.size, E, sel=lp.t_sel)),
        t_bins=up(lp.t_bins),
        s_idx=up(segsum_matrix(lp.s_seg, lp.s_bins.size, E, sel=lp.s_sel)),
        s_bins=up(lp.s_bins),
        pair_idx=up(pair_idx),
        rounds=tuple(rounds),
        n_peeled=off,
        core_nodes=up(tree_plan.core_nodes),
        core_ci=up(cp[:, 0]),
        core_cj=up(cp[:, 1]),
        core_pid=up(cp[:, 2]),
        mf=(device_mf_plan(tree_plan.core_plan, device)
            if isinstance(tree_plan.core_plan, MFPlan) else None),
        ce=(device_core_plan(tree_plan.core_plan, device)
            if isinstance(tree_plan.core_plan, CoreElimPlan) else None),
        num_bifurcations=int(asm.network.num_multipliers),
    )


def cuda_launches(dtp: DeviceTreePlan) -> int:
    """CUDA kernel launches of one :func:`tree_schur_solve` on the card: the
    bifurcation system (prepare, two sums, norm) and the pair sum; per peel
    round a forward pass, its fold levels and the parent add, and a back
    pass; the core's gather and scatter and the core solve — the dense
    core's (:func:`.kernels.dense_core.cuda_launches`), the min-degree
    elimination's (:func:`.kernels.core_elim.cuda_launches`), or the
    multifrontal factor's values pass and one launch per group plus the
    apply's (:func:`.kernels.mf_apply.cuda_launches`)."""
    from .kernels import core_elim, dense_core, mf_apply

    n = 4 + (1 if dtp.num_pairs else 0)
    for rd in dtp.rounds:
        n += 2 + (len(rd.fold) + 1 if rd.upar.shape[0] else 0)
    if dtp.core_size:
        n += 2
        if dtp.mf is not None:
            n += 1 + len(dtp.mf.plan.groups) + mf_apply.cuda_launches(dtp.mf)
        elif dtp.ce is not None:
            n += core_elim.cuda_launches(dtp.ce)
        else:
            n += dense_core.cuda_launches(dtp.core_size, int(dtp.core_ci.shape[0]))
    return n


def tree_schur_solve(dtp: DeviceTreePlan, ed, plain: bool):
    """``(λ (B,), ‖rhs‖)`` of the cyclic bifurcation system of ``ed``:
    the reference's ``_lambda_system_sorted`` then ``_tree_schur_solve``,
    through the kernels (``plain=False``) or their plain versions."""
    from .kernels import core_elim, dense_core, mf_apply, mf_factor, peel, segsum

    if plain:
        lam_sys, sums, run_peel = peel.lambda_system_plain, segsum.segsum_plain, peel.peel_plain
        dense, factor, apply, sparse = (
            dense_core.dense_core_plain, mf_factor.mf_factor_plain, mf_apply.mf_apply_plain,
            core_elim.core_elim_plain,
        )
    else:
        lam_sys, sums, run_peel = peel.lambda_system, segsum.segsum, peel.peel
        dense, factor, apply, sparse = (
            dense_core.dense_core, mf_factor.mf_factor, mf_apply.mf_apply, core_elim.core_elim
        )
    dr, w_edges, rhs_norm = lam_sys(dtp, ed)
    if dtp.num_pairs > 0:
        w_pairs = sums(dtp.pair_idx, w_edges)
    else:
        w_pairs = torch.zeros(0, dtype=torch.float64, device=w_edges.device)

    if dtp.mf is not None:
        def solve_core(dc, rc):
            return apply(dtp.mf, factor(dtp.mf, dc, w_pairs), rc)
    elif dtp.ce is not None:
        def solve_core(dc, rc):
            return sparse(dtp.ce, dc, w_pairs, rc)
    else:
        def solve_core(dc, rc):
            return dense(dtp.core_ci, dtp.core_cj, dtp.core_pid, dc, rc, w_pairs)

    lam = run_peel(dtp, dr, w_pairs, solve_core)
    return lam, rhs_norm
