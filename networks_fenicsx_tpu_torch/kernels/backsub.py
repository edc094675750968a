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
"""

from __future__ import annotations

import torch

from ..blocked import _condensed_scalar_constants
from ..edge_data import LAYOUTS, _EdgeData
from . import build

__all__ = ["backsub", "backsub_plain", "layout_of"]


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
