"""K18: the bifurcation Laplacian matvec by shift classes (``csrc/shift_matvec.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_shift``, ``_shift_matvec`` and
``_matvec_from_shift_plan`` (``:806-827``): with the class offsets ``d_c``
(:func:`..lattice._plan_shift_matvec`), the ``(C, B)`` class weights (K6,
:func:`..lattice._shift_class_weights`) and the bifurcation system ``dr =
(diag, rhs)`` of K9's ``lambda_system``, one launch of :func:`shift_matvec`
gives ``L λ = diag·λ − Σ_c w_c · shift(λ, d_c)`` (CG's matvec, the 1-D
multigrid levels) or ``rhs − L λ`` and its norm (the refinement matvec and
the final residual of the general DCT route and of the CG route), and
:func:`shift_cheb` one fused step of the Chebyshev-Jacobi smoother
(``ops/krylov.py:58-65``); both count in ``shift_matvec.launches``.

Each wrapper launches the kernel for CUDA tensors and runs its plain
version, the reference's zero-padded shifts in eager PyTorch, for CPU
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

__all__ = [
    "shift_matvec", "shift_matvec_plain", "shift_cheb", "shift_cheb_plain",
]

THREADS = 256
MAX_CLASSES = 16


def _shift(lam: torch.Tensor, d: int, m: int) -> torch.Tensor:
    """Zero-padded shift: ``out[i] = lam[i + d]`` (0 outside [0, m))."""
    pad = torch.zeros(abs(d), dtype=lam.dtype, device=lam.device)
    if d > 0:
        return torch.cat([lam[d:], pad])
    return torch.cat([pad, lam[: m + d]])


def shift_matvec_plain(offsets, cw, diag, x, b=None, norm: bool = False):
    """Eager version: ``L x`` (with ``b``: ``b − L x``, and its norm with ``norm``)."""
    out = diag * x
    for c, d in enumerate(np.asarray(offsets).tolist()):
        out = out - cw[c] * _shift(x, int(d), x.shape[0])
    if b is None:
        return out
    res = b - out
    return (res, torch.linalg.norm(res)) if norm else res


def shift_cheb_plain(offsets, cw, diag, s, rs, dvec, x_in, x_out, c1: float, c2: float, z=None,
                     base=None) -> None:
    """Eager version of one Chebyshev-Jacobi step (see ``csrc/shift_matvec.cu``)."""
    mv = s * shift_matvec_plain(offsets, cw, diag, s * x_in)
    dv = c1 * dvec + c2 * (rs - mv)
    dvec.copy_(dv)
    xn = x_in + dv
    x_out.copy_(xn)
    if z is not None:
        z.copy_(s * xn if base is None else base + s * xn)


def _check_classes(name, offsets, cw, B):
    C = np.asarray(offsets).shape[0]
    if C > MAX_CLASSES or tuple(cw.shape) != (C, B):
        raise ValueError(f"{name}: at most 16 classes and cw (C, B)")
    return np.ascontiguousarray(offsets, dtype=np.int32), C


def shift_matvec(offsets, cw, diag, x, b=None, norm: bool = False):
    """K18 on ``x``'s device: ``L x``, or ``b − L x`` (and its norm) when
    ``b`` is given.  ``offsets`` is the host int32 ``(C,)`` array of class
    offsets in ascending order, ``cw`` the ``(C, B)`` class weights; ``diag``
    and ``b`` are ``(B,)`` views of any stride (the DCT route passes the two
    columns of its ``(B, 2)`` system ``dr``), ``x`` is contiguous."""
    if x.device.type == "cpu":
        return shift_matvec_plain(offsets, cw, diag, x, b, norm)
    B = x.shape[0]
    vecs = (x, diag) if b is None else (x, diag, b)
    build.require_cuda("shift_matvec", cw, *vecs, contiguous=False)
    offsets, C = _check_classes("shift_matvec", offsets, cw, B)
    if (any(tuple(v.shape) != (B,) for v in vecs) or not (cw.is_contiguous() and x.is_contiguous())
            or (norm and b is None)):
        raise ValueError("shift_matvec: diag, x and b (B,), cw and x contiguous; norm needs b")
    dev, dt = x.device, torch.float64
    out = torch.empty(B, dtype=dt, device=dev)
    partial = torch.empty((B + THREADS - 1) // THREADS, dtype=dt, device=dev) if norm else None
    nrm = torch.empty((), dtype=dt, device=dev) if norm else None
    with torch.cuda.device(dev):
        code = build.library().nxfx_shift_matvec(
            B, C, offsets.ctypes.data, cw.data_ptr(), diag.data_ptr(), diag.stride(0), x.data_ptr(),
            None if b is None else b.data_ptr(), 0 if b is None else b.stride(0), out.data_ptr(),
            None if partial is None else partial.data_ptr(), None if nrm is None else nrm.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "shift_matvec")
    shift_matvec.launches += 1
    return (out, nrm) if norm else out


shift_matvec.launches = 0


def shift_cheb(offsets, cw, diag, s, rs, dvec, x_in, x_out, c1: float, c2: float, z=None,
               base=None) -> None:
    """K18's fused Chebyshev-Jacobi step: ``dvec`` in place, ``x_out`` (a
    buffer other than ``x_in``) and, on the last step, ``z``."""
    if x_in.device.type == "cpu":
        return shift_cheb_plain(offsets, cw, diag, s, rs, dvec, x_in, x_out, c1, c2, z, base)
    B = x_in.shape[0]
    vecs = [diag, s, rs, dvec, x_in, x_out] + [t for t in (z, base) if t is not None]
    build.require_cuda("shift_cheb", cw, *vecs)
    offsets, C = _check_classes("shift_cheb", offsets, cw, B)
    if any(tuple(v.shape) != (B,) for v in vecs) or x_in.data_ptr() == x_out.data_ptr():
        raise ValueError("shift_cheb: (B,) vectors, x_out other than x_in")
    dev = x_in.device
    with torch.cuda.device(dev):
        code = build.library().nxfx_shift_cheb(
            B, C, offsets.ctypes.data, cw.data_ptr(), diag.data_ptr(), s.data_ptr(), rs.data_ptr(),
            dvec.data_ptr(), x_in.data_ptr(), x_out.data_ptr(), float(c1), float(c2),
            None if z is None else z.data_ptr(), None if base is None else base.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "shift_cheb")
    shift_matvec.launches += 1
