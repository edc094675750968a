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
   its parents (K9, :mod:`.kernels.peel`, on the packed round table);
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
tables and fold levels, the core's index tensors and the rounds packed and
checked for K9 (:class:`.ops.peel_table.PeelTable`), so a solve makes one
host call each way around the core and nothing per round in Python.

A sweep solves S systems in the launches of one solve
(:func:`tree_solve_scenarios`): with S resistance rows, K9's two channels
over S (:func:`.kernels.peel.peel_scenarios`) around S core factors and
solves — the multifrontal K13–K15 over S or the dense K11 over S, in chunks
that bound the factors' memory (:func:`core_chunk`); with one R, K9's
``d`` channel and the core's factor once and the ``r`` channel with the
core's apply over the S right-hand sides
(:func:`.kernels.peel.peel_apply_scenarios`, :func:`core_apply_scenarios`).
A min-degree core (K12a, K12b) has no scenario axis yet
(:func:`has_scenario_axis`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kernels.dense_core import SCENARIO_BUDGET
from .kernels.fold import FoldPlan
from .kernels.peel import lambda_sums
from .kernels.segsum import SumPlan
from .levels import _LambdaPlan, _TreePlan, segsum_matrix
from .ops.core_elim import CoreElimPlan, DeviceCorePlan, _plan_fold, device_core_plan
from .ops.multifrontal import DeviceMFPlan, MFPlan, device_mf_plan
from .ops.peel_table import PeelTable, peel_table

__all__ = [
    "DeviceRound", "DeviceTreePlan", "cuda_launches", "device_tree_plan", "tree_schur_solve",
    "tree_solve_system", "has_scenario_axis", "core_chunk", "core_factor", "core_apply_scenarios",
    "tree_solve_scenarios",
]


@dataclasses.dataclass(frozen=True)
class DeviceRound:
    """One peel round on the device (the plain version's; the kernels walk
    :attr:`DeviceTreePlan.peel_table`).

    Attributes:
        elim: ``(n,)`` eliminated nodes (ascending, unique).
        parents: ``(n,)`` each one's surviving neighbour, ``-1`` if none.
        pair_ids: ``(n,)`` the pair to the parent, ``-1`` if none.
        upar: ``(U,)`` sorted unique parents.
        fold: the K10 plan summing the round's ``n`` terms into ``upar``
            (``_plan_fold`` levels as int32 tensors; empty when ``U = 0``).
    """

    elim: torch.Tensor
    parents: torch.Tensor
    pair_ids: torch.Tensor
    upar: torch.Tensor
    fold: tuple

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
        peel_table: the rounds and the core packed for K9 and checked
            (:func:`.ops.peel_table.peel_table`).
        lambda_sums, pair_sums: the K6 plans (:class:`.kernels.segsum.SumPlan`)
            of the two sides' sums into one ``(B, 2)`` system and of the pair
            sum, validated at upload.
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
    peel_table: PeelTable
    lambda_sums: SumPlan = dataclasses.field(init=False, compare=False, repr=False)
    pair_sums: SumPlan = dataclasses.field(init=False, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "lambda_sums", lambda_sums(self))
        object.__setattr__(self, "pair_sums", SumPlan(((self.pair_idx, None),), (1,)))

    @property
    def num_edges(self) -> int:
        return int(self.start_bif.shape[0])

    @property
    def num_pairs(self) -> int:
        return int(self.plan.pair_nodes.shape[0])

    @property
    def core_size(self) -> int:
        return int(self.core_nodes.shape[0])


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
    a :class:`.ops.core_elim.CoreElimPlan`, and the dense core otherwise.
    The rounds are also packed into K9's checked table, cut at
    :data:`.kernels.peel.CUT`, read here."""
    from .kernels import peel

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    E = int(tree_plan.edge_pair.size)
    P = int(tree_plan.pair_nodes.shape[0])
    ep = tree_plan.edge_pair
    sel = np.flatnonzero(ep >= 0)
    ids = ep[sel]
    order = np.argsort(ids, kind="stable")
    pair_idx = segsum_matrix(ids[order], P, E, sel=sel[order])
    rounds, packed = [], []
    off = 0
    for elim, parents, pair_ids in tree_plan.rounds:
        upar, fold = round_tables(elim, parents)
        packed.append((elim, parents, pair_ids, upar, fold))
        rounds.append(DeviceRound(
            elim=up(elim), parents=up(parents), pair_ids=up(pair_ids), upar=up(upar),
            fold=FoldPlan(up(lv) for lv in fold) if fold else (),
        ))
        off += int(elim.size)
    cp = np.asarray(tree_plan.core_pairs)
    lp = lam_plan
    B = int(asm.network.num_multipliers)
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
        num_bifurcations=B,
        peel_table=peel_table(packed, tree_plan.core_nodes, B, P, device, cut=peel.CUT),
    )


def cuda_launches(dtp: DeviceTreePlan) -> int:
    """CUDA kernel launches of one :func:`tree_schur_solve` on the card: the
    bifurcation system (prepare, the two sides' sums in one launch, norm)
    and the pair sum; K9's (:func:`.kernels.peel.cuda_launches`: the peel
    rounds with the core's gather and scatter) and the core solve — the dense
    core's (:func:`.kernels.dense_core.cuda_launches`), the min-degree
    elimination's (:func:`.kernels.core_elim.cuda_launches`), or the
    multifrontal factor's (:func:`.kernels.mf_factor.cuda_launches`: the
    values pass and one or two launches a level) and the apply's
    (:func:`.kernels.mf_apply.cuda_launches`)."""
    from .kernels import core_elim, dense_core, mf_apply, mf_factor, peel

    n = 3 + (1 if dtp.num_pairs else 0) + peel.cuda_launches(dtp)
    if dtp.core_size:
        if dtp.mf is not None:
            n += mf_factor.cuda_launches(dtp.mf) + mf_apply.cuda_launches(dtp.mf)
        elif dtp.ce is not None:
            n += core_elim.cuda_launches(dtp.ce)
        else:
            n += dense_core.cuda_launches(dtp.core_size, int(dtp.core_ci.shape[0]))
    return n


def tree_schur_solve(dtp: DeviceTreePlan, ed, plain: bool):
    """``(λ (B,), ‖rhs‖)`` of the cyclic bifurcation system of ``ed``:
    the reference's ``_lambda_system_sorted`` then ``_tree_schur_solve``,
    through the kernels (``plain=False``) or their plain versions."""
    from .kernels import peel, segsum

    lam_sys = peel.lambda_system_plain if plain else peel.lambda_system
    dr, w_edges, rhs_norm = lam_sys(dtp, ed)
    if dtp.num_pairs > 0:
        w_pairs = (segsum.segsum_plain(dtp.pair_idx, w_edges) if plain
                   else segsum.segsum_plan(dtp.pair_sums, w_edges)[0])
    else:
        w_pairs = torch.zeros(0, dtype=torch.float64, device=w_edges.device)
    return tree_solve_system(dtp, dr, w_pairs, plain), rhs_norm


def tree_solve_system(dtp: DeviceTreePlan, dr: torch.Tensor, w_pairs: torch.Tensor, plain: bool):
    """``λ (B,)`` of the assembled cyclic system — ``dr (B, 2)`` the diagonal
    and rhs, ``w_pairs (P,)`` the pair conductances: the peel rounds, the
    core and the reversed rounds (the reference's ``_tree_schur_solve``;
    the sharded general solve's replicated stage)."""
    from .kernels import core_elim, dense_core, mf_apply, mf_factor, peel

    if plain:
        run_peel = peel.peel_plain
        dense, factor, apply, sparse = (
            dense_core.dense_core_plain, mf_factor.mf_factor_plain, mf_apply.mf_apply_plain,
            core_elim.core_elim_plain,
        )
    else:
        run_peel = peel.peel
        dense, factor, apply, sparse = (
            dense_core.dense_core, mf_factor.mf_factor, mf_apply.mf_apply, core_elim.core_elim
        )

    if dtp.mf is not None:
        def solve_core(dc, rc):
            return apply(dtp.mf, factor(dtp.mf, dc, w_pairs), rc)
    elif dtp.ce is not None:
        def solve_core(dc, rc):
            return sparse(dtp.ce, dc, w_pairs, rc)
    else:
        def solve_core(dc, rc):
            return dense(dtp.core_ci, dtp.core_cj, dtp.core_pid, dc, rc, w_pairs)

    return run_peel(dtp, dr, w_pairs, solve_core)


# ---------------------------------------------------------------- S scenarios


def has_scenario_axis(dtp: DeviceTreePlan) -> bool:
    """Whether the plan's solve runs S scenarios in its launches: every core
    but the min-degree one (K12a's rounds and K12b's fronts, ROADMAP A9b)."""
    return dtp.ce is None


def core_chunk(dtp: DeviceTreePlan, factors: bool, budget: int = SCENARIO_BUDGET) -> int:
    """Scenarios a chunk of a sweep's core work: the multifrontal factors
    (:func:`.kernels.mf_factor.scenario_chunk`; one factor's applies are not
    chunked) or K11's (:func:`.kernels.dense_core.scenario_chunk`)."""
    from .kernels import dense_core, mf_factor

    if dtp.mf is not None:
        return mf_factor.scenario_chunk(dtp.mf, budget) if factors else dense_core.MAX_SCENARIOS
    return dense_core.scenario_chunk(dtp.core_size, factors, budget)


def _chunks(fn, S: int, chunk: int, *rows):
    """``fn`` on the rows of each chunk of ``chunk`` scenarios, joined."""
    parts = [fn(*(t[i0: i0 + chunk] for t in rows)) for i0 in range(0, S, chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def core_factor(dtp: DeviceTreePlan, dc: torch.Tensor, w_pairs: torch.Tensor):
    """The core's factor of one R: :class:`.kernels.mf_factor.MFState`, or
    K11's ``(Lc, s, C, ok)`` without a core plan (a dense core)."""
    from .kernels import dense_core, mf_factor

    if dtp.mf is not None:
        return mf_factor.mf_factor(dtp.mf, dc, w_pairs)
    Lc, s, C = dense_core.dense_factor(dtp.core_ci, dtp.core_cj, dtp.core_pid, dc, w_pairs)
    return Lc, s, C, dense_core.dense_gate(C)


def core_apply_scenarios(dtp: DeviceTreePlan, state, budget: int = SCENARIO_BUDGET):
    """``rc (S, n) -> x (S, n)`` on one stored core factor (``state`` of
    :func:`core_factor`): K15 over S, or K11's solves over S in chunks."""
    from .kernels import dense_core, mf_apply

    if dtp.mf is not None:
        return lambda rc: mf_apply.mf_apply_scenarios(dtp.mf, state, rc)
    chunk = core_chunk(dtp, False, budget)
    return lambda rc: _chunks(lambda r: dense_core.dense_solve_scenarios(*state, r), rc.shape[0],
                              chunk, rc)


def _core_solve_scenarios(dtp: DeviceTreePlan, w_pairs: torch.Tensor, budget: int):
    """``(dc (S, n), rc (S, n)) -> x (S, n)`` with S factors (``w_pairs (S,
    P)``), in chunks of :func:`core_chunk`: K13–K15 or K11 over S."""
    from .kernels import dense_core, mf_apply, mf_factor

    chunk = core_chunk(dtp, True, budget)
    if dtp.mf is not None:
        def solve(dc, rc, wp):
            return mf_apply.mf_apply_scenarios(dtp.mf, mf_factor.mf_factor_scenarios(dtp.mf, dc, wp),
                                               rc)
    else:
        pairs = (dtp.core_ci, dtp.core_cj, dtp.core_pid)

        def solve(dc, rc, wp):
            Lc, s, C = dense_core.dense_factor_scenarios(*pairs, dc, wp)
            return dense_core.dense_solve_scenarios(Lc, s, C, dense_core.dense_gate_scenarios(C), rc)

    return lambda dc, rc: _chunks(solve, dc.shape[0], chunk, dc, rc, w_pairs)


def tree_solve_scenarios(dtp: DeviceTreePlan, dr: torch.Tensor, w_edges: torch.Tensor,
                         R_batched: bool, budget: int = SCENARIO_BUDGET) -> torch.Tensor:
    """``λ (S, B)`` of S assembled systems ``dr (S, B, 2)`` with the per-edge
    conductances ``w_edges (S, E)``: with ``R_batched`` the pair sums (K6)
    and K9's two channels over S around S core factors and solves; else (one
    R: every row's diagonal and conductances the same bits) the pair sums,
    K9's ``d`` channel and the core's factor once on row 0, then K9's ``r``
    channel and the core's apply over S.  Row ``i`` is :func:`tree_schur_solve`'s
    λ of row ``i`` bit for bit.  Raises for a min-degree core."""
    from .kernels import peel, segsum

    if not has_scenario_axis(dtp):
        raise ValueError("tree_solve_scenarios: a min-degree core has no scenario axis")
    S, dev = dr.shape[0], dr.device
    if R_batched:
        w_pairs = (segsum.segsum_plan_scenarios(dtp.pair_sums, w_edges)[0] if dtp.num_pairs
                   else torch.zeros((S, 0), dtype=torch.float64, device=dev))
        return peel.peel_scenarios(dtp, dr, w_pairs, _core_solve_scenarios(dtp, w_pairs, budget))
    w_pairs = (segsum.segsum_plan(dtp.pair_sums, w_edges[0])[0] if dtp.num_pairs
               else torch.zeros(0, dtype=torch.float64, device=dev))
    pf = peel.peel_factor(dtp, dr[0], w_pairs)
    apply = (core_apply_scenarios(dtp, core_factor(dtp, pf.dc, w_pairs), budget) if dtp.core_size
             else None)
    return peel.peel_apply_scenarios(dtp, pf, dr, apply)
