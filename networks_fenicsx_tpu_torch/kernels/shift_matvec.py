"""K18: the bifurcation Laplacian matvec by shift classes (``csrc/shift_matvec.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_shift``, ``_shift_matvec`` and
``_matvec_from_shift_plan`` (``:806-827``): with the class offsets ``d_c``
(:func:`..lattice._plan_shift_matvec`), the ``(C, B)`` class weights (K6,
:func:`..lattice._shift_class_weights`) and the bifurcation system ``dr =
(diag, rhs)`` of K9's ``lambda_system``, one launch gives

    res = rhs − (diag·λ − Σ_c w_c · shift(λ, d_c))

(and ``‖res‖`` when asked) — the refinement matvec and the final residual
of the general DCT route.

:func:`shift_matvec` launches the kernel for CUDA tensors and runs
:func:`shift_matvec_plain`, the reference's zero-padded shifts in eager
PyTorch, for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

__all__ = ["shift_matvec", "shift_matvec_plain"]

THREADS = 256
MAX_CLASSES = 16


def _shift(lam: torch.Tensor, d: int, m: int) -> torch.Tensor:
    """Zero-padded shift: ``out[i] = lam[i + d]`` (0 outside [0, m))."""
    pad = torch.zeros(abs(d), dtype=lam.dtype, device=lam.device)
    if d > 0:
        return torch.cat([lam[d:], pad])
    return torch.cat([pad, lam[: m + d]])


def shift_matvec_plain(
    offsets: np.ndarray, cw: torch.Tensor, dr: torch.Tensor, lam: torch.Tensor, norm: bool = False,
):
    """Eager version: ``res = rhs − L λ`` (and ``‖res‖`` with ``norm``)."""
    B = lam.shape[0]
    out = dr[:, 0] * lam
    for c, d in enumerate(np.asarray(offsets).tolist()):
        out = out - cw[c] * _shift(lam, int(d), B)
    res = dr[:, 1] - out
    return (res, torch.linalg.norm(res)) if norm else res


def shift_matvec(
    offsets: np.ndarray, cw: torch.Tensor, dr: torch.Tensor, lam: torch.Tensor, norm: bool = False,
):
    """K18 on ``lam``'s device.  ``offsets`` is the host int32 ``(C,)`` array
    of class offsets in ascending order, ``cw`` the ``(C, B)`` class weights,
    ``dr`` the ``(B, 2)`` (diagonal, rhs)."""
    if lam.device.type == "cpu":
        return shift_matvec_plain(offsets, cw, dr, lam, norm)
    build.require_cuda("shift_matvec", cw, dr, lam)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    B, C = lam.shape[0], offsets.shape[0]
    if C > MAX_CLASSES or tuple(cw.shape) != (C, B) or tuple(dr.shape) != (B, 2):
        raise ValueError("shift_matvec: at most 16 classes, cw (C, B), dr (B, 2)")
    dev, dt = lam.device, torch.float64
    res = torch.empty(B, dtype=dt, device=dev)
    partial = torch.empty((B + THREADS - 1) // THREADS, dtype=dt, device=dev) if norm else None
    out = torch.empty((), dtype=dt, device=dev) if norm else None
    with torch.cuda.device(dev):
        code = build.library().nxfx_shift_matvec(
            B, C, offsets.ctypes.data, cw.data_ptr(), dr.data_ptr(), lam.data_ptr(),
            res.data_ptr(), None if partial is None else partial.data_ptr(),
            None if out is None else out.data_ptr(), build.stream_handle(dev),
        )
    build.check(code, "shift_matvec")
    shift_matvec.launches += 1
    return (res, out) if norm else res


shift_matvec.launches = 0
