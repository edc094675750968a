"""K8b: multipliers to the solution blocks (``csrc/backsub.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_backsub_from_lambda``
(``:4418-4515``) and ``_solution_blocks_T`` (``:4518-4566``): per edge the
endpoint multipliers, ``r0``, ``rN`` and ``q0``, then the j-major solution
columns ``q_T (k·N+1, E)`` and ``p_T (N, E)`` — closed forms in the uniform
layout, the chain walk with the layout's cell momenta otherwise — and the
finiteness flag of the general path, over ``q_T``, ``p_T`` and ``λ``
(``:4251-4255``).

:func:`backsub` launches the kernel for CUDA tensors and runs
:func:`backsub_plain`, the eager transcription of the reference, for CPU
tensors.  The kernel is bound by the bytes of the solution it writes.

A sweep (:func:`..batch.solve_sweep` on the dense route and without
multipliers) expands S scenarios in one launch, :func:`backsub_scenarios`:
the ``(S, ·)`` edge data of :func:`.edge_data.edge_data_scenarios` and ``λ
(S, B)`` give ``q_T (S, k·N+1, E)``, ``p_T (S, N, E)`` and a finiteness flag
a scenario, row ``i`` :func:`backsub` of row ``i`` bit for bit;
:func:`backsub_scenarios_plain` stacks :func:`backsub_plain`.
"""

from __future__ import annotations

import torch

from ..blocked import _condensed_scalar_constants
import ctypes

from ..edge_data import LAYOUTS, _EdgeData, scenario_row
from . import build

__all__ = ["backsub", "backsub_plain", "layout_of", "backsub_scenarios", "backsub_scenarios_plain"]


def layout_of(ed: _EdgeData, k: int) -> str:
    """The layout an :class:`_EdgeData` was made in."""
    if ed.ua is not None:
        return "uniform"
    if ed.mt is not None:
        return "general"
    return "scalar" if k == 1 else "scalar_k"


def backsub_plain(ed: _EdgeData, lam: torch.Tensor, N: int, k: int):
    """Eager version: returns ``(q_T, p_T, finite)``.

    The pressure prefix sums run row by row and the 2×2 products are
    written out, in the kernel's order (not ``cumsum``/``einsum`` in the
    backend's), so the two agree to the last bit."""
    dt, dev = torch.float64, lam.device
    E = ed.W.shape[0]
    s_is_bif = ed.start_bif >= 0
    t_is_bif = ed.end_bif >= 0
    lam_pad = torch.cat([lam, torch.zeros(1, dtype=dt, device=dev)])
    lam_s = lam_pad[ed.start_bif.long()]  # -1 takes the pad slot: 0
    lam_t = lam_pad[ed.end_bif.long()]
    r0 = torch.where(s_is_bif, lam_s, -ed.start_pbc)
    rN = torch.where(t_is_bif, -lam_t, ed.end_pbc)
    q0 = (r0 + rN - ed.g) / ed.W

    if ed.ua is not None and k == 1:
        a, F = ed.ua, ed.uF
        j = torch.arange(N + 1, dtype=dt, device=dev)
        q_T = q0[None, :] + F[None, :] * j[:, None]
        c = torch.arange(N, dtype=dt, device=dev)
        p_T = (
            r0[None, :]
            - (a * q0)[None, :] * (c + 0.5)[:, None]
            - (a * F)[None, :] * (c * c / 2.0 + (3.0 * c + 1.0) / 6.0)[:, None]
        )
    else:
        q_chain = q0[None, :] + ed.cumF  # (N+1, E)
        qj, qj1 = q_chain[:-1], q_chain[1:]
        if ed.mt is None and k == 1:
            a = ed.rh
            mc0 = a * (qj / 3.0 + qj1 / 6.0)
            mc1 = a * (qj / 6.0 + qj1 / 3.0)
        elif ed.mt is None:
            Mt = _condensed_scalar_constants(k)[0]
            a = ed.rh
            mc0 = a * (float(Mt[0, 0]) * qj + float(Mt[0, 1]) * qj1)
            mc1 = a * (float(Mt[1, 0]) * qj + float(Mt[1, 1]) * qj1)
        else:
            mc0 = ed.mt[:, 0, 0] * qj + ed.mt[:, 0, 1] * qj1
            mc1 = ed.mt[:, 1, 0] * qj + ed.mt[:, 1, 1] * qj1
        zrow = torch.zeros((1, E), dtype=dt, device=dev)
        m_nodes = torch.cat([mc0, zrow]) + torch.cat([zrow, mc1])  # (N+1, E)
        # p = r0 - cumsum(m_nodes[:-1]), the prefix sums taken row by row
        psum = [m_nodes[0]]
        for c in range(1, N):
            psum.append(psum[-1] + m_nodes[c])
        p_T = r0[None, :] - torch.stack(psum)
        if k == 1:
            q_T = q_chain
        else:
            (Minv_IE,) = ed.interior
            if Minv_IE.dim() == 2:  # the fixed matrix: its host copy, no device sync
                Minv = _condensed_scalar_constants(k)[3]
                q_int = [-(float(Minv[i, 0]) * qj + float(Minv[i, 1]) * qj1) for i in range(k - 1)]
            else:
                q_int = [-(Minv_IE[:, i, 0] * qj + Minv_IE[:, i, 1] * qj1) for i in range(k - 1)]
            cell_blk = torch.stack([qj, *q_int], dim=1)  # (N, k, E)
            q_T = torch.cat([cell_blk.reshape(N * k, E), q_chain[-1:]])
    finite = (
        torch.all(torch.isfinite(q_T)) & torch.all(torch.isfinite(p_T)) & torch.all(torch.isfinite(lam))
    )
    return q_T, p_T, finite


def backsub(ed: _EdgeData, lam: torch.Tensor, N: int, k: int):
    """K8b on ``lam``'s device: ``(q_T (k·N+1, E), p_T (N, E), finite)``."""
    if lam.device.type == "cpu":
        return backsub_plain(ed, lam, N, k)
    layout = layout_of(ed, k)
    present = [t for t in (ed.mt, ed.rh, ed.ua, ed.uF) if t is not None]
    interior = list(ed.interior)
    build.require_cuda(
        "backsub", lam, ed.W, ed.g, ed.cumF, ed.start_pbc, ed.end_pbc, *present, *interior
    )
    build.require_cuda("backsub", ed.start_bif, ed.end_bif, dtype=torch.int32)
    E, B = ed.W.shape[0], lam.shape[0]
    rows = 1 if layout == "uniform" else N + 1
    if tuple(ed.cumF.shape) != (rows, E) or lam.dim() != 1:
        raise ValueError("backsub: cumF must be (N+1, E) ((1, E) uniform) and lam (B,)")
    if (k > 1) != bool(interior) or layout == "uniform" and k != 1:
        raise ValueError("backsub: the interior recovery data does not fit the degree")
    dev = lam.device
    dt = torch.float64
    empty = torch.empty(0, dtype=dt, device=dev)
    minv = interior[0] if interior else empty
    per_cell = bool(interior) and minv.dim() == 4
    if per_cell and tuple(minv.shape) != (N, k - 1, 2, E):
        raise ValueError("backsub: per-cell Minv_IE must be (N, k-1, 2, E)")
    Mt = _condensed_scalar_constants(k)[0]
    q_T = torch.empty((k * N + 1, E), dtype=dt, device=dev)
    p_T = torch.empty((N, E), dtype=dt, device=dev)
    finite = torch.ones((), dtype=torch.int32, device=dev)

    def ptr(t):
        return (empty if t is None else t).data_ptr()

    with torch.cuda.device(dev):
        code = build.library().nxfx_backsub(
            LAYOUTS.index(layout), E, B, N, k,
            lam.data_ptr(), ed.start_bif.data_ptr(), ed.end_bif.data_ptr(),
            ed.start_pbc.data_ptr(), ed.end_pbc.data_ptr(),
            ed.W.data_ptr(), ed.g.data_ptr(), ed.cumF.data_ptr(),
            ptr(ed.mt), ptr(ed.rh), minv.data_ptr(), int(per_cell), ptr(ed.ua), ptr(ed.uF),
            float(Mt[0, 0]), float(Mt[0, 1]), float(Mt[1, 0]), float(Mt[1, 1]),
            q_T.data_ptr(), p_T.data_ptr(), finite.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "backsub")
    backsub.launches += 1
    return q_T, p_T, finite.bool()


backsub.launches = 0


def _scenario_shapes(ed: _EdgeData, lam: torch.Tensor, N: int, k: int) -> tuple:
    """``(layout, S, B, E, per-cell Minv_IE)`` of a scenario call, or raise."""
    layout = layout_of(ed, k)
    if lam.dim() != 2 or ed.W.dim() != 2 or not lam.shape[0]:
        raise ValueError("backsub_scenarios: lam must be (S, B), S >= 1, and the edge data (S, E)")
    (S, B), E = lam.shape, ed.start_bif.shape[0]
    rows = 1 if layout == "uniform" else N + 1
    if (tuple(ed.W.shape) != (S, E) or tuple(ed.g.shape) != (S, E)
            or tuple(ed.cumF.shape) != (S, rows, E)):
        raise ValueError("backsub_scenarios: W, g (S, E), cumF (S, N+1, E) ((S, 1, E) uniform)")
    if any(tuple(t.shape) not in ((E,), (S, E)) for t in (ed.start_pbc, ed.end_pbc)):
        raise ValueError("backsub_scenarios: the boundary data must be (E,) or (S, E)")
    if (k > 1) != bool(ed.interior) or layout == "uniform" and k != 1:
        raise ValueError("backsub_scenarios: the interior recovery data does not fit the degree")
    per_cell = bool(ed.interior) and ed.interior[0].dim() != 2
    if per_cell and tuple(ed.interior[0].shape) != (S, N, k - 1, 2, E):
        raise ValueError("backsub_scenarios: per-cell Minv_IE must be (S, N, k-1, 2, E)")
    for name, shape in {"mt": (S, N, 2, 2, E), "rh": (S, N, E), "ua": (S, E),
                        "uF": (S, E)}.items():
        t = getattr(ed, name)
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"backsub_scenarios: {name} must be {shape}")
    return layout, S, B, E, per_cell


def backsub_scenarios_plain(ed: _EdgeData, lam: torch.Tensor, N: int, k: int):
    """Eager version of :func:`backsub_scenarios`: :func:`backsub_plain` a
    scenario, stacked."""
    S = _scenario_shapes(ed, lam, N, k)[1]
    rows = [backsub_plain(scenario_row(ed, i), lam[i], N, k) for i in range(S)]
    return tuple(torch.stack(t) for t in zip(*rows))


def backsub_scenarios(ed: _EdgeData, lam: torch.Tensor, N: int, k: int):
    """K8b of S scenarios on ``lam``'s device in one launch: the sweep's edge
    data (its per-scenario fields with a leading S, see
    :mod:`..edge_data`) and ``lam (S, B)``; returns ``(q_T (S, k·N+1, E),
    p_T (S, N, E), finite (S,))``."""
    if lam.device.type == "cpu":
        return backsub_scenarios_plain(ed, lam, N, k)
    layout, S, B, E, per_cell = _scenario_shapes(ed, lam, N, k)
    present = [t for t in (ed.mt, ed.rh, ed.ua, ed.uF) if t is not None]
    build.require_cuda("backsub_scenarios", lam, ed.W, ed.g, ed.cumF, ed.start_pbc, ed.end_pbc,
                       *present, *ed.interior)
    build.require_cuda("backsub_scenarios", ed.start_bif, ed.end_bif, dtype=torch.int32)
    dev, dt = lam.device, torch.float64
    empty = torch.empty(0, dtype=dt, device=dev)
    minv = ed.interior[0] if ed.interior else empty
    rows = 1 if layout == "uniform" else N + 1
    Mt = _condensed_scalar_constants(k)[0]
    q_T = torch.empty((S, k * N + 1, E), dtype=dt, device=dev)
    p_T = torch.empty((S, N, E), dtype=dt, device=dev)
    finite = torch.ones(S, dtype=torch.int32, device=dev)

    def ptr(t):
        return (empty if t is None else t).data_ptr()

    def per(t):  # doubles between two scenarios' rows of a batched t (0: shared or absent)
        return 0 if t is None or t.dim() < 2 else t[0].numel()

    strides = (ctypes.c_longlong * 10)(
        B, per(ed.start_pbc), per(ed.end_pbc), E, rows * E, per(ed.mt), per(ed.rh),
        per(minv) if per_cell else 0, (k * N + 1) * E, N * E)
    with torch.cuda.device(dev):
        code = build.library().nxfx_backsub_scen(
            LAYOUTS.index(layout), E, B, N, k, S, ctypes.addressof(strides),
            lam.data_ptr(), ed.start_bif.data_ptr(), ed.end_bif.data_ptr(),
            ed.start_pbc.data_ptr(), ed.end_pbc.data_ptr(),
            ed.W.data_ptr(), ed.g.data_ptr(), ed.cumF.data_ptr(),
            ptr(ed.mt), ptr(ed.rh), minv.data_ptr(), int(per_cell), ptr(ed.ua), ptr(ed.uF),
            float(Mt[0, 0]), float(Mt[0, 1]), float(Mt[1, 0]), float(Mt[1, 1]),
            q_T.data_ptr(), p_T.data_ptr(), finite.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "backsub_scenarios")
    backsub_scenarios.launches += 1
    return q_T, p_T, finite.bool()


backsub_scenarios.launches = 0
