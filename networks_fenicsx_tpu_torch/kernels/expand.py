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
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..blocked import DevicePlan, _BlockedPlan, _condensed_scalar_constants
from ..lattice import _GridPlan
from . import build
from .condense import MODES

__all__ = ["expand", "expand_plain"]


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
    plan, the grid route's slices)."""
    if isinstance(plan, _GridPlan):
        return _grid_lambda_to_edges(plan, lam)
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
