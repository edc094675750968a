"""K8a: element formation and condensation, four layouts (``csrc/edge_data.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_make_edge_data_uniform``
(``:394-436``), ``_make_edge_data_scalar`` / ``_make_edge_data_scalar_k``
(``:467-566``), ``_make_edge_data`` (``:569-619``) and the quadrature
einsums of the generic ``core`` (``:4289-4313``).

Inputs are the assembler's compact coefficients in public order (``R``,
``f``: ``(1,)`` scalar, ``(E,)`` per edge, ``(C,)`` per cell edge-major,
``(C, nq)`` quad) and ``h_e = |e| / N``; the layout follows from the
degree and the modes (:func:`..edge_data.edge_layout`); the output is an
:class:`..edge_data._EdgeData` with j-major per-cell arrays.

:func:`edge_data` launches the kernel for CUDA tensors and runs
:func:`edge_data_plain`, an eager transcription of the reference, for CPU
tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..blocked import _condensed_scalar_constants
from ..edge_data import LAYOUTS, _EdgeData, edge_layout, elides_source
from ..levels import DeviceLevelPlan
from . import build

__all__ = ["edge_data", "edge_data_plain", "COEFF_MODES"]

COEFF_MODES = {"scalar": 0, "edge": 1, "cell": 2, "quad": 3}


def _fold(terms):
    """Left-to-right sum of a sequence of tensors (the kernels' order)."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def quad_table(quad_w: torch.Tensor, quad_phi: torch.Tensor) -> torch.Tensor:
    """``w_q φ_qi φ_qj``, ``(nq, k+1, k+1)``: the element-mass integrand."""
    return (quad_w[:, None, None] * quad_phi[:, :, None] * quad_phi[:, None, :]).contiguous()


def edge_data_plain(
    dlp: DeviceLevelPlan,
    N: int,
    k: int,
    h_e: torch.Tensor,
    quad_w: torch.Tensor,
    quad_phi: torch.Tensor,
    R: torch.Tensor,
    f: torch.Tensor,
    R_mode: str,
    f_mode: str,
    f_is_zero: bool,
    start_pbc: torch.Tensor,
    end_pbc: torch.Tensor,
) -> _EdgeData:
    """Eager version: the reference's layout functions, outputs j-major.

    Every sum over quadrature points and along an edge's cells is taken
    left to right, as the kernel takes it, instead of by ``einsum``,
    ``sum`` or ``cumsum`` in the backend's order; the values are the
    reference's up to that order."""
    layout = edge_layout(k, R_mode, f_mode)
    dt, dev = torch.float64, h_e.device
    E = h_e.shape[0]
    nq = k + 1
    bifs = dict(start_bif=dlp.start_bif, end_bif=dlp.end_bif, start_pbc=start_pbc, end_pbc=end_pbc)
    if layout == "uniform":
        R_e = R[0] * torch.ones(E, dtype=dt, device=dev) if R_mode == "scalar" else R
        f_e = f[0] * torch.ones(E, dtype=dt, device=dev) if f_mode == "scalar" else f
        a = R_e * h_e
        F = f_e * h_e
        W = a * N
        Ftot = F * N
        g = a * F * (N * N / 2.0)
        return _EdgeData(mt=None, cumF=Ftot[None, :], W=W, g=g, interior=(), ua=a, uF=F, **bifs)

    h = h_e.repeat_interleave(N)  # cell_h, public cell order
    C = h.shape[0]
    if f_mode == "quad":
        cell_f_int = _fold([f[:, q] * quad_w[q] for q in range(nq)]) * h
    elif f_mode == "scalar":
        cell_f_int = f[0] * h
    elif f_mode == "edge":
        cell_f_int = f.repeat_interleave(N) * h
    else:
        cell_f_int = f * h

    def chain(F2):  # (E, N) cell integrals -> [cumF_0 .. cumF_N], each (E,)
        cum = [torch.zeros(E, dtype=dt, device=dev)]
        for c in range(N):
            cum.append(cum[-1] + F2[:, c])
        return cum

    if layout == "general":
        wphi = quad_table(quad_w, quad_phi)
        cell_mass = _fold([R[:, q, None, None] * wphi[q] for q in range(nq)]) * h[:, None, None]
        if k == 1:
            mt = cell_mass
            interior: tuple = ()
        else:
            ends = torch.tensor([0, k], device=dev)
            ints = torch.arange(1, k, device=dev)
            M_EE = cell_mass[:, ends][:, :, ends]
            M_EI = cell_mass[:, ends][:, :, ints]
            M_IE = cell_mass[:, ints][:, :, ends]
            M_II = cell_mass[:, ints][:, :, ints]
            L = torch.linalg.cholesky(M_II)
            Minv_IE = torch.cholesky_solve(M_IE, L)
            mt = M_EE - _fold([M_EI[:, :, i, None] * Minv_IE[:, None, i, :] for i in range(k - 1)])
            interior = (Minv_IE.reshape(E, N, k - 1, 2).permute(1, 2, 3, 0).contiguous(),)
        mt = mt.reshape(E, N, 2, 2)
        cum = chain(cell_f_int.reshape(E, N))
        col0 = mt[:, :, 0, 0] + mt[:, :, 1, 0]  # column sums of each cell's mt
        col1 = mt[:, :, 0, 1] + mt[:, :, 1, 1]
        W = _fold([col0[:, c] + col1[:, c] for c in range(N)])
        g = _fold([col0[:, c] * cum[c] + col1[:, c] * cum[c + 1] for c in range(N)])
        return _EdgeData(
            mt=mt.permute(1, 2, 3, 0).contiguous(), cumF=torch.stack(cum), W=W, g=g,
            interior=interior, **bifs,
        )

    if R_mode == "scalar":
        R_cells = R[0] * torch.ones(C, dtype=dt, device=dev)
    elif R_mode == "edge":
        R_cells = R.repeat_interleave(N)
    else:
        R_cells = R
    a = (R_cells * h).reshape(E, N)
    if layout == "scalar":
        W = _fold([a[:, c] for c in range(N)])
        interior = ()
    else:
        _, csum, wt, Minv = _condensed_scalar_constants(k)
        W = wt * _fold([a[:, c] for c in range(N)])
        interior = (torch.as_tensor(np.asarray(Minv, dtype=np.float64), device=dev),)
    if elides_source(layout, f_is_zero):
        cumF = torch.zeros((N + 1, E), dtype=dt, device=dev)
        g = torch.zeros(E, dtype=dt, device=dev)
    else:
        cum = chain(cell_f_int.reshape(E, N))
        cumF = torch.stack(cum)
        if layout == "scalar":
            g = 0.5 * _fold([a[:, c] * (cum[c] + cum[c + 1]) for c in range(N)])
        else:
            c0, c1 = float(csum[0]), float(csum[1])
            g = _fold([a[:, c] * (c0 * cum[c] + c1 * cum[c + 1]) for c in range(N)])
    return _EdgeData(
        mt=None, cumF=cumF, W=W, g=g, interior=interior, rh=a.T.contiguous(), **bifs,
    )


@functools.lru_cache(maxsize=None)
def _fixed_recovery(k: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(
        np.ascontiguousarray(_condensed_scalar_constants(k)[3], dtype=np.float64), device=device
    )


def edge_data(
    dlp: DeviceLevelPlan,
    N: int,
    k: int,
    h_e: torch.Tensor,
    quad_w: torch.Tensor,
    quad_phi: torch.Tensor,
    R: torch.Tensor,
    f: torch.Tensor,
    R_mode: str,
    f_mode: str,
    f_is_zero: bool,
    start_pbc: torch.Tensor,
    end_pbc: torch.Tensor,
) -> _EdgeData:
    """K8a on ``h_e``'s device.  ``quad_w (nq,)`` and ``quad_phi (nq, k+1)``
    are the assembler's Gauss rule; the kernel reads them as the table
    ``w_q φ_qi φ_qj``."""
    if h_e.device.type == "cpu":
        return edge_data_plain(
            dlp, N, k, h_e, quad_w, quad_phi, R, f, R_mode, f_mode, f_is_zero, start_pbc, end_pbc
        )
    layout = edge_layout(k, R_mode, f_mode)
    build.require_cuda("edge_data", h_e, R, f, start_pbc, end_pbc)
    build.require_cuda("edge_data", dlp.start_bif, dlp.end_bif, dtype=torch.int32)
    E = dlp.num_edges
    C, nq = E * N, k + 1
    expect = {"scalar": (1,), "edge": (E,), "cell": (C,), "quad": (C, nq)}
    for label, t, mode in (("R", R, R_mode), ("f", f, f_mode)):
        if tuple(t.shape) != expect[mode]:
            raise ValueError(f"edge_data: {label} of mode {mode!r} has shape {tuple(t.shape)}")
    if any(tuple(t.shape) != (E,) for t in (h_e, start_pbc, end_pbc)):
        raise ValueError("edge_data: h_e and the boundary data must be (E,)")
    dev = h_e.device
    dt = torch.float64
    build.require_cuda("edge_data", quad_w, quad_phi)
    wphi = quad_table(quad_w, quad_phi)
    wt, cs0, cs1 = 1.0, 0.5, 0.5
    if layout == "scalar_k":
        _, csum, wt, _ = _condensed_scalar_constants(k)
        cs0, cs1 = float(csum[0]), float(csum[1])
    elide = elides_source(layout, f_is_zero)
    empty = torch.empty(0, dtype=dt, device=dev)
    W = torch.empty(E, dtype=dt, device=dev)
    g = torch.empty(E, dtype=dt, device=dev)
    mt = minv = work = rh = ua = uF = empty
    interior: tuple = ()
    if layout == "uniform":
        cumF = torch.empty((1, E), dtype=dt, device=dev)
        ua = torch.empty(E, dtype=dt, device=dev)
        uF = torch.empty(E, dtype=dt, device=dev)
    else:
        cumF = torch.empty((N + 1, E), dtype=dt, device=dev)
    if layout == "general":
        mt = torch.empty((N, 2, 2, E), dtype=dt, device=dev)
        if k > 1:
            minv = torch.empty((N, k - 1, 2, E), dtype=dt, device=dev)
            work = torch.empty(((k - 1) ** 2, E), dtype=dt, device=dev)
            interior = (minv,)
    elif layout in ("scalar", "scalar_k"):
        rh = torch.empty((N, E), dtype=dt, device=dev)
        if layout == "scalar_k":
            interior = (_fixed_recovery(k, dev),)
    with torch.cuda.device(dev):
        code = build.library().nxfx_edge_data(
            LAYOUTS.index(layout), E, N, k, nq,
            h_e.data_ptr(), R.data_ptr(), COEFF_MODES[R_mode],
            f.data_ptr(), COEFF_MODES[f_mode], int(elide),
            quad_w.data_ptr(), wphi.data_ptr(), float(wt), cs0, cs1,
            mt.data_ptr(), minv.data_ptr(), work.data_ptr(), cumF.data_ptr(),
            W.data_ptr(), g.data_ptr(), rh.data_ptr(), ua.data_ptr(), uF.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "edge_data")
    edge_data.launches += 1
    return _EdgeData(
        mt=mt if layout == "general" else None,
        cumF=cumF, W=W, g=g,
        start_bif=dlp.start_bif, end_bif=dlp.end_bif, start_pbc=start_pbc, end_pbc=end_pbc,
        interior=interior,
        rh=rh if layout in ("scalar", "scalar_k") else None,
        ua=ua if layout == "uniform" else None,
        uF=uF if layout == "uniform" else None,
    )


edge_data.launches = 0
