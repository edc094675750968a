"""K5: multipliers to the solution blocks (``csrc/expand.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_blocked_lambda_to_edges``
(``:2743-2773``), the ``back`` closure of ``_blocked_condense_f``
(``:2866-2909``) and the tail of ``_blocked_uniform_solve``
(``:2954-2971``), and the same tail of the lattice grid route
(``_grid_blocked_core``, ``:1264-1279``): per edge the endpoint
multipliers, ``r0``, ``rN`` and ``q0``, then the j-major solution columns
``q_T (k·N+1, E)`` and ``p_T (N, E)`` in closed form, and a finiteness flag
over the (E,)-sized precursors ``W, g, Ftot, λ, q0, r0`` (the blocks are
affine in them).

:func:`expand` launches the kernel for CUDA tensors and runs
:func:`expand_plain`, the eager transcription of the reference, for CPU
tensors.  The kernel is bound by the bytes of the solution it writes.

A sweep (:mod:`...batch`) expands S scenarios in one launch:
:func:`expand_scenarios` takes each input batched (a leading scenario axis)
or shared by every scenario (read with stride 0) and writes ``q_T (S, k·N+1,
E)``, ``p_T (S, N, E)`` and a finiteness flag a scenario; scenario ``i`` is
:func:`expand` of row ``i`` bit for bit.  :func:`expand_scenarios_plain`
stacks :func:`expand_plain` a scenario.

The blocked route's adjoint (:mod:`...adjoint`) runs K5's transpose in two
launches: :func:`expand_vjp`, a thread an edge walking its columns of the
blocks' cotangents from the last cell to the first, gives per edge the
cotangents of ``q0``, ``r0`` and ``rN`` and K5's share of the coefficients'
(per cell in ``"cell"`` mode); :func:`expand_vjp_fold`, a thread a
bifurcation, gathers the endpoint cotangents into ``rho``, the right-hand
side of the adjoint λ solve.  Their plain versions are
:func:`expand_vjp_plain` and :func:`expand_vjp_fold_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..blocked import DevicePlan, IndexedEnds, _BlockedPlan, _condensed_scalar_constants
from ..lattice import _GridPlan
from . import build
from .condense import MODES

__all__ = ["expand", "expand_plain", "expand_scenarios", "expand_scenarios_plain", "expand_vjp",
           "expand_vjp_plain", "expand_vjp_fold", "expand_vjp_fold_plain"]


@functools.lru_cache(maxsize=None)
def _recovery_matrix(k: int, device: torch.device) -> torch.Tensor:
    """Interior recovery matrix ``Minv_IE`` (k-1, 2), flattened, on ``device``
    (one zero for k = 1, where the kernel never reads it)."""
    Minv = _condensed_scalar_constants(k)[3]
    flat = np.ascontiguousarray(Minv, dtype=np.float64).reshape(-1)
    return torch.as_tensor(flat if flat.size else np.zeros(1), device=device)


def _grid_lambda_to_edges(plan: _GridPlan, lam: torch.Tensor):
    """The grid route's ``(lam_s, lam_t)``: 2-D slices of the λ grid plus the
    stub gather (reference ``_grid_blocked_core``, ``:1264-1273``)."""
    nx, ny = plan.nx, plan.ny
    l2 = lam.reshape(ny, nx)
    rows = torch.as_tensor(plan.stub_rows_e, device=lam.device)
    s_bif = torch.as_tensor(plan.stub_s_bif, device=lam.device)
    lam_st = lam[rows]
    zero = torch.zeros_like(lam_st)
    lam_s = torch.cat([l2[:, : nx - 1].reshape(-1), l2[: ny - 1, :].reshape(-1),
                       torch.where(s_bif, lam_st, zero)])
    lam_t = torch.cat([l2[:, 1:].reshape(-1), l2[1:, :].reshape(-1),
                       torch.where(s_bif, zero, lam_st)])
    return lam_s, lam_t


def _lambda_to_edges(plan: _BlockedPlan | _GridPlan, lam: torch.Tensor):
    """Per-edge ``(lam_s, lam_t)`` in internal edge order, zeros at
    boundary endpoints (reference ``_blocked_lambda_to_edges``; on a grid
    plan, the grid route's slices; on :class:`..blocked.IndexedEnds`, the
    gather by index a shard's rows take)."""
    if isinstance(plan, _GridPlan):
        return _grid_lambda_to_edges(plan, lam)
    if isinstance(plan, IndexedEnds):
        zero = torch.zeros(1, dtype=lam.dtype, device=lam.device)
        lp = torch.cat([lam, zero])
        n = lam.shape[0]
        src = torch.as_tensor(np.where(plan.edge_src >= 0, plan.edge_src, n), device=lam.device)
        tgt = torch.as_tensor(np.where(plan.edge_tgt >= 0, plan.edge_tgt, n), device=lam.device)
        return lp[src], lp[tgt]
    dt, dev = lam.dtype, lam.device
    sizes = np.diff(plan.bif_offsets).tolist()
    lam_lev = list(torch.split(lam, sizes))
    s_parts = [torch.zeros(plan.n_roots, dtype=dt, device=dev)]
    t_parts = [lam_lev[0]]  # root in-edges target the level-0 bifs
    for l, lv in enumerate(plan.levels):
        lam_l = lam_lev[l]
        lam_child = lam_lev[l + 1] if lv.n_bif_outs else None
        cursor = 0
        for _, is_bif in lv.outs:
            s_parts.append(lam_l)
            if is_bif:
                t_parts.append(lam_child[cursor : cursor + lv.m])
                cursor += lv.m
            else:
                t_parts.append(torch.zeros(lv.m, dtype=dt, device=dev))
    return torch.cat(s_parts), torch.cat(t_parts)


def expand_plain(
    plan: _BlockedPlan,
    N: int,
    k: int,
    lam: torch.Tensor,
    start_pbc: torch.Tensor,
    end_pbc: torch.Tensor,
    W: torch.Tensor,
    w: torch.Tensor,
    g: torch.Tensor,
    Ftot: torch.Tensor,
    h_e: torch.Tensor,
    R_data: torch.Tensor,
    f_data: torch.Tensor,
    R_mode: str,
    f_mode: str,
):
    """Eager version: returns ``(q_T, p_T, finite)``."""
    dt, dev = torch.float64, lam.device
    E = h_e.shape[0]
    s_b = torch.as_tensor(plan.s_is_bif, device=dev)
    t_b = torch.as_tensor(plan.t_is_bif, device=dev)
    lam_s, lam_t = _lambda_to_edges(plan, lam)
    r0 = torch.where(s_b, lam_s, -start_pbc)
    rN = torch.where(t_b, -lam_t, end_pbc)
    q0 = (r0 + rN - g) * w

    # the coefficient halves the reference's `back` closure captures
    if R_mode in ("scalar", "edge"):
        a1 = (R_data[0] * torch.ones(E, dtype=dt, device=dev) if R_mode == "scalar" else R_data) * h_e
        a2 = None
    else:
        a1, a2 = None, R_data * h_e[None, :]
    if f_mode in ("scalar", "edge"):
        F1 = (f_data[0] * torch.ones(E, dtype=dt, device=dev) if f_mode == "scalar" else f_data) * h_e
        cumF = None
    else:
        F1 = None
        cumF = torch.cat(
            [torch.zeros((1, E), dtype=dt, device=dev), torch.cumsum(f_data * h_e[None, :], dim=0)]
        )

    if k == 1 and a1 is not None and F1 is not None:
        j = torch.arange(N + 1, dtype=dt, device=dev)
        q_T = q0[None, :] + F1[None, :] * j[:, None]
        c = torch.arange(N, dtype=dt, device=dev)
        p_T = (
            r0[None, :]
            - (a1 * q0)[None, :] * (c + 0.5)[:, None]
            - (a1 * F1)[None, :] * (c * c / 2.0 + (3.0 * c + 1.0) / 6.0)[:, None]
        )
    else:
        cf = cumF
        if cf is None:
            j = torch.arange(N + 1, dtype=dt, device=dev)
            cf = F1[None, :] * j[:, None]
        q_chain = q0[None, :] + cf
        qj, qj1 = q_chain[:-1], q_chain[1:]
        ab = a2 if a2 is not None else a1[None, :]
        if k == 1:
            mc0 = ab * (qj / 3.0 + qj1 / 6.0)
            mc1 = ab * (qj / 6.0 + qj1 / 3.0)
        else:
            Mt, _, _, Minv = _condensed_scalar_constants(k)
            mc0 = ab * (float(Mt[0, 0]) * qj + float(Mt[0, 1]) * qj1)
            mc1 = ab * (float(Mt[1, 0]) * qj + float(Mt[1, 1]) * qj1)
        zrow = torch.zeros((1, E), dtype=dt, device=dev)
        m_nodes = torch.cat([mc0, zrow]) + torch.cat([zrow, mc1])
        p_T = r0[None, :] - torch.cumsum(m_nodes[:-1], dim=0)
        if k == 1:
            q_T = q_chain
        else:
            q_int = torch.stack(
                [-(float(Minv[i, 0]) * qj + float(Minv[i, 1]) * qj1) for i in range(k - 1)],
                dim=1,
            )  # (N, k-1, E)
            cell_blk = torch.cat([qj[:, None, :], q_int], dim=1)  # (N, k, E)
            q_T = torch.cat([cell_blk.reshape(N * k, E), q_chain[-1:]])
    finite = (
        torch.all(torch.isfinite(q0))
        & torch.all(torch.isfinite(r0))
        & torch.all(torch.isfinite(lam))
        & torch.all(torch.isfinite(W))
        & torch.all(torch.isfinite(g))
        & torch.all(torch.isfinite(Ftot))
    )
    return q_T, p_T, finite


def expand(
    dplan: DevicePlan,
    N: int,
    k: int,
    lam: torch.Tensor,
    start_pbc: torch.Tensor,
    end_pbc: torch.Tensor,
    W: torch.Tensor,
    w: torch.Tensor,
    g: torch.Tensor,
    Ftot: torch.Tensor,
    h_e: torch.Tensor,
    R_data: torch.Tensor,
    f_data: torch.Tensor,
    R_mode: str,
    f_mode: str,
):
    """K5 on ``lam``'s device: ``(q_T (k·N+1, E), p_T (N, E), finite)``."""
    if lam.device.type == "cpu":
        return expand_plain(
            dplan.plan, N, k, lam, start_pbc, end_pbc, W, w, g, Ftot, h_e,
            R_data, f_data, R_mode, f_mode,
        )
    build.require_cuda("expand", lam, start_pbc, end_pbc, W, w, g, Ftot, h_e, R_data, f_data)
    build.require_cuda("expand", dplan.edge_src, dplan.edge_tgt, dtype=torch.int32)
    B, E = dplan.num_bifurcations, dplan.num_edges
    if tuple(lam.shape) != (B,):
        raise ValueError("expand: lam must be (B,)")
    if any(tuple(t.shape) != (E,) for t in (start_pbc, end_pbc, W, w, g, Ftot, h_e)):
        raise ValueError("expand: per-edge inputs must be (E,)")
    build.require_coefficients("expand", N, E, ("R", R_data, R_mode), ("f", f_data, f_mode))
    dev = lam.device
    Mt = _condensed_scalar_constants(k)[0]
    minv = _recovery_matrix(k, dev)
    q_T = torch.empty((k * N + 1, E), dtype=torch.float64, device=dev)
    p_T = torch.empty((N, E), dtype=torch.float64, device=dev)
    finite = torch.ones((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_expand(
            E, B, N, k,
            lam.data_ptr(), dplan.edge_src.data_ptr(), dplan.edge_tgt.data_ptr(),
            start_pbc.data_ptr(), end_pbc.data_ptr(),
            W.data_ptr(), w.data_ptr(), g.data_ptr(), Ftot.data_ptr(), h_e.data_ptr(),
            R_data.data_ptr(), MODES[R_mode], f_data.data_ptr(), MODES[f_mode],
            float(Mt[0, 0]), float(Mt[0, 1]), float(Mt[1, 0]), float(Mt[1, 1]), minv.data_ptr(),
            q_T.data_ptr(), p_T.data_ptr(), finite.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "expand")
    expand.launches += 1
    return q_T, p_T, finite.bool()


expand.launches = 0


# ---------------------------------------------------------------- the adjoint (K5ᵀ)


def _reverse_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``out[c] = Σ_{i ≥ c} x[i]`` along the first axis."""
    return torch.flip(torch.cumsum(torch.flip(x, [0]), dim=0), [0])


def expand_vjp_plain(plan, N: int, k: int, lam, start_pbc, end_pbc, w, g, h_e, R_data, f_data,
                     R_mode: str, f_mode: str, q_bar, p_bar):
    """Eager version of :func:`expand_vjp`: ``(bars (3, E), R_part, f_part)``.

    K5 reads the multipliers and the boundary data through ``q0 = (r0 + rN -
    g) w`` and the endpoint value ``r0``, and the coefficients through the
    cell momenta.  Given the cotangents ``q_bar (k·N+1, E)`` and ``p_bar (N,
    E)`` of its blocks, ``bars`` holds per edge ``q̄0``, the whole cotangent
    of ``r0`` (``Σ p̄ + q̄0 w``) and that of ``rN`` (``q̄0 w``); ``R_part``
    and ``f_part`` are K5's own share of the coefficients' cotangents, per
    cell ``(N, E)`` in ``"cell"`` mode, else per edge ``(E,)`` (summed over
    the edges for a ``"scalar"`` coefficient by :func:`..condense.condense_vjp`)."""
    dt, dev = torch.float64, lam.device
    E = h_e.shape[0]
    s_b = torch.as_tensor(plan.s_is_bif, device=dev)
    t_b = torch.as_tensor(plan.t_is_bif, device=dev)
    lam_s, lam_t = _lambda_to_edges(plan, lam)
    r0 = torch.where(s_b, lam_s, -start_pbc)
    rN = torch.where(t_b, -lam_t, end_pbc)
    q0 = (r0 + rN - g) * w
    r_cell, f_cell = R_mode == "cell", f_mode == "cell"
    ones = torch.ones((N, E), dtype=dt, device=dev)
    if r_cell:
        ab = R_data * h_e[None, :]
    else:
        ab = (R_data if R_mode == "edge" else R_data[0]) * h_e * ones
    zrow = torch.zeros((1, E), dtype=dt, device=dev)
    j = torch.arange(N + 1, dtype=dt, device=dev)[:, None]
    if f_cell:
        cumF = torch.cat([zrow, torch.cumsum(f_data * h_e[None, :], dim=0)])
    else:
        cumF = (f_data if f_mode == "edge" else f_data[0]) * h_e * j
    q_chain = q0 + cumF
    qj, qj1 = q_chain[:-1], q_chain[1:]
    Mt, _, _, Minv = _condensed_scalar_constants(k)
    m00, m01, m10, m11 = (float(Mt[a, b]) for a, b in ((0, 0), (0, 1), (1, 0), (1, 1)))
    P = _reverse_cumsum(p_bar)  # Σ_{i ≥ c} p̄_i: minus the cotangent of cell c's mc0
    P_next = torch.cat([P[1:], zrow])  # minus that of its mc1
    ab_bar = -P * (m00 * qj + m01 * qj1) - P_next * (m10 * qj + m11 * qj1)
    if k == 1:
        Q = q_bar.clone()
    else:
        qb = q_bar[: N * k].reshape(N, k, E)
        Q = torch.cat([qb[:, 0], q_bar[N * k :]])
        for i in range(k - 1):
            Q[:-1] = Q[:-1] - float(Minv[i, 0]) * qb[:, 1 + i]
            Q[1:] = Q[1:] - float(Minv[i, 1]) * qb[:, 1 + i]
    Q[:-1] = Q[:-1] + ab * (-m00 * P - m10 * P_next)
    Q[1:] = Q[1:] + ab * (-m01 * P - m11 * P_next)
    q0_bar = torch.sum(Q, dim=0)
    cumF_bar = Q[1:]  # cumF_0 = 0 is no input
    if f_cell:
        f_part = _reverse_cumsum(cumF_bar) * h_e[None, :]
    else:
        f_part = torch.sum(cumF_bar * j[1:], dim=0) * h_e
    R_part = ab_bar * h_e[None, :] if r_cell else torch.sum(ab_bar, dim=0) * h_e
    bars = torch.stack([q0_bar, P[0] + q0_bar * w, q0_bar * w])
    return bars, R_part, f_part


class _VjpArgs(ctypes.Structure):
    """``ExpandVjpArgs`` of ``csrc/expand.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in ("E", "B", "N", "k", "R_mode", "f_mode")]
                + [(n, ctypes.c_double) for n in ("mt00", "mt01", "mt10", "mt11")]
                + [(n, ctypes.c_void_p) for n in (
                    "edge_src", "edge_tgt", "h_e", "Minv", "lam", "start_pbc", "end_pbc", "w",
                    "g", "R", "f", "q_bar", "p_bar", "bars", "R_part", "f_part")])


def expand_vjp(dplan: DevicePlan, N: int, k: int, lam, start_pbc, end_pbc, w, g, h_e, R_data,
               f_data, R_mode: str, f_mode: str, q_bar, p_bar):
    """K5's transpose on ``lam``'s device, one launch: ``(bars (3, E),
    R_part, f_part)`` (see :func:`expand_vjp_plain`) from the cotangents
    ``q_bar (k·N+1, E)`` and ``p_bar (N, E)`` of K5's blocks."""
    if lam.device.type == "cpu":
        return expand_vjp_plain(dplan.plan, N, k, lam, start_pbc, end_pbc, w, g, h_e, R_data,
                                f_data, R_mode, f_mode, q_bar, p_bar)
    build.require_cuda("expand_vjp", lam, start_pbc, end_pbc, w, g, h_e, R_data, f_data, q_bar,
                       p_bar)
    build.require_cuda("expand_vjp", dplan.edge_src, dplan.edge_tgt, dtype=torch.int32)
    B, E = dplan.num_bifurcations, dplan.num_edges
    if tuple(lam.shape) != (B,) or any(tuple(t.shape) != (E,)
                                       for t in (start_pbc, end_pbc, w, g, h_e)):
        raise ValueError("expand_vjp: lam must be (B,) and the per-edge inputs (E,)")
    if tuple(q_bar.shape) != (k * N + 1, E) or tuple(p_bar.shape) != (N, E):
        raise ValueError("expand_vjp: q_bar must be (k·N+1, E) and p_bar (N, E)")
    build.require_coefficients("expand_vjp", N, E, ("R", R_data, R_mode), ("f", f_data, f_mode))
    dev = lam.device
    Mt = _condensed_scalar_constants(k)[0]
    bars = torch.empty((3, E), dtype=torch.float64, device=dev)
    R_part = torch.empty((N, E) if R_mode == "cell" else (E,), dtype=torch.float64, device=dev)
    f_part = torch.empty((N, E) if f_mode == "cell" else (E,), dtype=torch.float64, device=dev)
    a = _VjpArgs(E=E, B=B, N=N, k=k, R_mode=MODES[R_mode], f_mode=MODES[f_mode],
                 mt00=float(Mt[0, 0]), mt01=float(Mt[0, 1]), mt10=float(Mt[1, 0]),
                 mt11=float(Mt[1, 1]), edge_src=dplan.edge_src.data_ptr(),
                 edge_tgt=dplan.edge_tgt.data_ptr(), h_e=h_e.data_ptr(),
                 Minv=_recovery_matrix(k, dev).data_ptr(), lam=lam.data_ptr(),
                 start_pbc=start_pbc.data_ptr(), end_pbc=end_pbc.data_ptr(), w=w.data_ptr(),
                 g=g.data_ptr(), R=R_data.data_ptr(), f=f_data.data_ptr(),
                 q_bar=q_bar.data_ptr(), p_bar=p_bar.data_ptr(), bars=bars.data_ptr(),
                 R_part=R_part.data_ptr(), f_part=f_part.data_ptr())
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    build.check(build.on_device(index, build.library().nxfx_expand_vjp, ctypes.addressof(a),
                                build.raw_stream(index)), "expand_vjp")
    expand_vjp.launches += 1
    return bars, R_part, f_part


expand_vjp.launches = 0


def expand_vjp_fold_plain(dplan: DevicePlan, lam_bar, bars):
    """Eager version of :func:`expand_vjp_fold`: ``(rho (B,), Ftot_adj (E,))``."""
    bif_in, bif_out = dplan.bif_in.long(), dplan.bif_out.long()
    rho = lam_bar - bars[2][bif_in]
    for j in range(bif_out.shape[1]):
        oe = bif_out[:, j]
        ok = oe >= 0
        rho = torch.where(ok, rho + bars[1][torch.where(ok, oe, torch.zeros_like(oe))], rho)
    Ftot_adj = torch.zeros(bars.shape[1], dtype=bars.dtype, device=bars.device)
    Ftot_adj[bif_in] = rho
    return rho, Ftot_adj


def expand_vjp_fold(dplan: DevicePlan, lam_bar, bars):
    """The fold of :func:`expand_vjp`'s endpoint cotangents into the
    bifurcations, one launch (a thread a bifurcation, a gather over its in-
    and out-edges: no atomics): ``rho = λ̄ - r̄N[in] + Σ r̄0[out]`` (B,), and
    ``Ftot_adj (E,)`` holding ``rho_b`` at ``bif_in[b]`` and 0 elsewhere — the
    right-hand side whose K3–K4 apply (``const = 0``) is the adjoint solve
    ``S⁻¹ rho`` (:func:`.tree_sweep.tree_sweep_solve`)."""
    if lam_bar.device.type == "cpu":
        return expand_vjp_fold_plain(dplan, lam_bar, bars)
    build.require_cuda("expand_vjp_fold", lam_bar, bars)
    build.require_cuda("expand_vjp_fold", dplan.bif_in, dplan.bif_out, dplan.edge_tgt,
                       dtype=torch.int32)
    B, E = dplan.num_bifurcations, dplan.num_edges
    if tuple(lam_bar.shape) != (B,) or tuple(bars.shape) != (3, E):
        raise ValueError("expand_vjp_fold: lam_bar must be (B,) and bars (3, E)")
    dev = lam_bar.device
    rho = torch.empty(B, dtype=torch.float64, device=dev)
    Ftot_adj = torch.empty(E, dtype=torch.float64, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    build.check(build.on_device(index, build.library().nxfx_expand_vjp_fold, E, B,
                                dplan.max_out, dplan.bif_in.data_ptr(), dplan.bif_out.data_ptr(),
                                dplan.edge_tgt.data_ptr(), lam_bar.data_ptr(), bars.data_ptr(),
                                rho.data_ptr(), Ftot_adj.data_ptr(), build.raw_stream(index)),
                "expand_vjp_fold")
    expand_vjp_fold.launches += 1
    return rho, Ftot_adj


expand_vjp_fold.launches = 0


# ---------------------------------------------------------------- scenarios


class _ScenArgs(ctypes.Structure):
    """``ExpandArgs`` of ``csrc/expand.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in ("S", "E", "B", "N", "k", "R_mode", "f_mode")]
                + [(n, ctypes.c_double) for n in ("mt00", "mt01", "mt10", "mt11")]
                + [(n, ctypes.c_void_p) for n in (
                    "edge_src", "edge_tgt", "h_e", "Minv", "lam", "start_pbc", "end_pbc", "W",
                    "w", "g", "Ftot", "R", "f", "q_T", "p_T", "finite")]
                + [(n, ctypes.c_longlong) for n in (
                    "s_lam", "s_sp", "s_ep", "s_cond", "s_R", "s_f", "s_q", "s_p")])


def _scenario_inputs(N: int, E: int, B: int, R_mode: str, f_mode: str, lam, start_pbc, end_pbc,
                     W, w, g, Ftot, R_data, f_data) -> tuple[int, dict, dict]:
    """``(S, inputs, their one-scenario shapes)``; W, w, g and Ftot share one
    stride (all batched or all shared)."""
    coeff = {"scalar": (1,), "edge": (E,), "cell": (N, E)}
    ins = {"lam": lam, "sp": start_pbc, "ep": end_pbc, "W": W, "w": w, "g": g, "Ftot": Ftot,
           "R": R_data, "f": f_data}
    base = {n: (E,) for n in ins}
    base.update(lam=(B,), R=coeff[R_mode], f=coeff[f_mode])
    S = build.scenarios("expand", *((t, base[n]) for n, t in ins.items()))
    if len({build.batched(ins[n], (E,)) for n in ("W", "w", "g", "Ftot")}) != 1:
        raise ValueError("expand_scenarios: W, w, g and Ftot must all be batched or all shared")
    return S, ins, base


def expand_scenarios_plain(dplan, N: int, k: int, lam, start_pbc, end_pbc, W, w, g, Ftot, h_e,
                           R_data, f_data, R_mode: str, f_mode: str):
    """Eager version of :func:`expand_scenarios`: :func:`expand_plain` a
    scenario, stacked ``(q_T, p_T, finite)``."""
    S, ins, base = _scenario_inputs(N, h_e.shape[0], dplan.num_bifurcations, R_mode, f_mode, lam,
                                    start_pbc, end_pbc, W, w, g, Ftot, R_data, f_data)
    rows = []
    for i in range(S):
        r = {n: build.scenario_row(t, base[n], i) for n, t in ins.items()}
        rows.append(expand_plain(dplan.plan, N, k, r["lam"], r["sp"], r["ep"], r["W"], r["w"],
                                 r["g"], r["Ftot"], h_e, r["R"], r["f"], R_mode, f_mode))
    return tuple(torch.stack(col) for col in zip(*rows))


def expand_scenarios(dplan, N: int, k: int, lam, start_pbc, end_pbc, W, w, g, Ftot, h_e, R_data,
                     f_data, R_mode: str, f_mode: str):
    """K5 of S scenarios on ``lam``'s device, one launch: ``(q_T (S, k·N+1, E),
    p_T (S, N, E), finite (S,))``; each input batched (a leading ``S``) or
    shared, ``h_e`` and the plan's row ends shared."""
    if lam.device.type == "cpu":
        return expand_scenarios_plain(dplan, N, k, lam, start_pbc, end_pbc, W, w, g, Ftot, h_e,
                                      R_data, f_data, R_mode, f_mode)
    B, E = dplan.num_bifurcations, dplan.num_edges
    S, ins, base = _scenario_inputs(N, E, B, R_mode, f_mode, lam, start_pbc, end_pbc, W, w, g,
                                    Ftot, R_data, f_data)
    build.require_cuda("expand", h_e, *ins.values())
    build.require_cuda("expand", dplan.edge_src, dplan.edge_tgt, dtype=torch.int32)
    if tuple(h_e.shape) != (E,):
        raise ValueError("expand: h_e must be (E,)")
    dev = lam.device
    Mt = _condensed_scalar_constants(k)[0]
    minv = _recovery_matrix(k, dev)
    q_T = torch.empty((S, k * N + 1, E), dtype=torch.float64, device=dev)
    p_T = torch.empty((S, N, E), dtype=torch.float64, device=dev)
    finite = torch.ones(S, dtype=torch.int32, device=dev)
    stride = {n: build.scenario_stride(t, base[n]) for n, t in ins.items()}
    a = _ScenArgs(S=S, E=E, B=B, N=N, k=k, R_mode=MODES[R_mode], f_mode=MODES[f_mode],
                  mt00=float(Mt[0, 0]), mt01=float(Mt[0, 1]), mt10=float(Mt[1, 0]),
                  mt11=float(Mt[1, 1]), edge_src=dplan.edge_src.data_ptr(),
                  edge_tgt=dplan.edge_tgt.data_ptr(), h_e=h_e.data_ptr(), Minv=minv.data_ptr(),
                  lam=lam.data_ptr(), start_pbc=start_pbc.data_ptr(), end_pbc=end_pbc.data_ptr(),
                  W=W.data_ptr(), w=w.data_ptr(), g=g.data_ptr(), Ftot=Ftot.data_ptr(),
                  R=R_data.data_ptr(), f=f_data.data_ptr(), q_T=q_T.data_ptr(),
                  p_T=p_T.data_ptr(), finite=finite.data_ptr(), s_lam=stride["lam"],
                  s_sp=stride["sp"], s_ep=stride["ep"], s_cond=stride["W"], s_R=stride["R"],
                  s_f=stride["f"], s_q=(k * N + 1) * E, s_p=N * E)
    with torch.cuda.device(dev):
        code = build.library().nxfx_expand_scen(ctypes.addressof(a), build.stream_handle(dev))
    build.check(code, "expand_scenarios")
    expand_scenarios.launches += 1
    return q_T, p_T, finite.bool()


expand_scenarios.launches = 0
