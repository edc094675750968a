"""K1: per-edge static condensation (``csrc/condense.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_blocked_condense``,
``_blocked_condense_R`` and ``_blocked_condense_f`` (``:2776-2911``, the
``W, g, Ftot`` half) and the ``const`` line of ``_blocked_uniform_solve``
(``:2941-2950``).  All inputs and outputs are float64 in the plan's internal
edge order; ``"cell"``-mode coefficients are ``(N, E)`` j-major blocks.

:func:`condense` launches the kernel for CUDA tensors and runs
:func:`condense_plain` — an eager transcription of the reference — for CPU
tensors.  The kernel is memory-bound: it reads each coefficient once and
writes five (E,) vectors; one thread walks one edge's column.
"""

from __future__ import annotations

import torch

from ..blocked import DevicePlan, _BlockedPlan, _condensed_scalar_constants
from . import build

__all__ = ["condense", "condense_plain", "MODES"]

MODES = {"scalar": 0, "edge": 1, "cell": 2}


def _constants(k: int) -> tuple[float, float, float]:
    """(wt, cs0, cs1): total and column sums of the condensed cell matrix."""
    if k == 1:
        return 1.0, 0.5, 0.5
    _, csum, wt, _ = _condensed_scalar_constants(k)
    return float(wt), float(csum[0]), float(csum[1])


def condense_plain(
    plan: _BlockedPlan,
    N: int,
    k: int,
    h_e: torch.Tensor,
    R_data: torch.Tensor,
    f_data: torch.Tensor,
    R_mode: str,
    f_mode: str,
    start_pbc: torch.Tensor,
    end_pbc: torch.Tensor,
):
    """Eager version: returns ``(W, w, g, Ftot, const)``."""
    dt, dev = torch.float64, h_e.device
    E = h_e.shape[0]
    wt, cs0, cs1 = _constants(k)
    if R_mode in ("scalar", "edge"):
        a1 = (R_data[0] * torch.ones(E, dtype=dt, device=dev) if R_mode == "scalar" else R_data) * h_e
        a2 = None
        W = a1 * (N * wt)
    else:
        a2 = R_data * h_e[None, :]
        a1 = None
        W = wt * torch.sum(a2, dim=0)
    if f_mode in ("scalar", "edge"):
        F1 = (f_data[0] * torch.ones(E, dtype=dt, device=dev) if f_mode == "scalar" else f_data) * h_e
        Ftot = F1 * N
        cumF = None
    else:
        F2 = f_data * h_e[None, :]
        F1 = None
        cumF = torch.cat([torch.zeros((1, E), dtype=dt, device=dev), torch.cumsum(F2, dim=0)])
        Ftot = cumF[-1]
    if a1 is not None and F1 is not None:
        g = a1 * F1 * (wt * (N * (N - 1) / 2.0) + cs1 * N)
    else:
        if cumF is None:
            j = torch.arange(N + 1, dtype=dt, device=dev)
            cumF = F1[None, :] * j[:, None]
        wsum = cs0 * cumF[:-1] + cs1 * cumF[1:]
        g = a1 * torch.sum(wsum, dim=0) if a2 is None else torch.sum(a2 * wsum, dim=0)
    w = 1.0 / W
    s_b = torch.as_tensor(plan.s_is_bif, device=dev)
    t_b = torch.as_tensor(plan.t_is_bif, device=dev)
    const = (-start_pbc * (~s_b) + end_pbc * (~t_b) - g) * w
    return W, w, g, Ftot, const


def condense(
    dplan: DevicePlan,
    N: int,
    k: int,
    h_e: torch.Tensor,
    R_data: torch.Tensor,
    f_data: torch.Tensor,
    R_mode: str,
    f_mode: str,
    start_pbc: torch.Tensor,
    end_pbc: torch.Tensor,
):
    """K1 on ``h_e``'s device: ``(W, w, g, Ftot, const)``, each (E,)."""
    if h_e.device.type == "cpu":
        return condense_plain(
            dplan.plan, N, k, h_e, R_data, f_data, R_mode, f_mode, start_pbc, end_pbc
        )
    build.require_cuda("condense", h_e, R_data, f_data, start_pbc, end_pbc)
    build.require_cuda("condense", dplan.edge_src, dplan.edge_tgt, dtype=torch.int32)
    E = dplan.num_edges
    build.require_coefficients("condense", N, E, ("R", R_data, R_mode), ("f", f_data, f_mode))
    if tuple(h_e.shape) != (E,) or tuple(start_pbc.shape) != (E,) or tuple(end_pbc.shape) != (E,):
        raise ValueError("condense: h_e and the boundary data must be (E,)")
    wt, cs0, cs1 = _constants(k)
    g_closed = wt * (N * (N - 1) / 2.0) + cs1 * N
    outs = [torch.empty(E, dtype=torch.float64, device=h_e.device) for _ in range(5)]
    lib = build.library()
    with torch.cuda.device(h_e.device):
        code = lib.nxfx_condense(
            E, N, h_e.data_ptr(),
            R_data.data_ptr(), MODES[R_mode], f_data.data_ptr(), MODES[f_mode],
            start_pbc.data_ptr(), end_pbc.data_ptr(),
            dplan.edge_src.data_ptr(), dplan.edge_tgt.data_ptr(),
            wt, cs0, cs1, g_closed,
            *(o.data_ptr() for o in outs),
            build.stream_handle(h_e.device),
        )
    build.check(code, "condense")
    condense.launches += 1
    return tuple(outs)


condense.launches = 0
