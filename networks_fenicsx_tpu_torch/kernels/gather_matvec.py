"""K19b: the bifurcation Laplacian matvec by gather and fold
(``csrc/gather_matvec.cu``), for graphs without a shift plan.

Replaces ``networks_fenicsx_tpu/solver.py:_matvec_from_plan``
(``:1561-1580``): with the ``(K, B)`` tables ``mv_edge`` and ``mv_other`` of
:func:`..lattice.gather_matvec_tables` (row ``i``'s half-edges in the fold
order of the reference's ``_segsum_sorted``, ``-1`` past the last),
``w = 1/W`` per edge and the diagonal,

    (L x)_i = diag_i·x_i + Σ_k (−w[mv_edge[k, i]])·x[mv_other[k, i]]

with the sum over ``k`` in order.  :func:`gather_matvec` gives ``L x`` or,
with ``b``, ``b − L x`` (and its norm); :func:`gather_cheb` one fused
Chebyshev-Jacobi step (``ops/krylov.py:58-65``), counted with it.  The
reference's ``_structured_take`` (a TPU pattern match of gathers into
slices) is not ported: a plain gather.

Each wrapper launches the kernel for CUDA tensors and runs its plain
version, the gather matrix's columns added in order, for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["gather_matvec", "gather_matvec_plain", "gather_cheb", "gather_cheb_plain"]

THREADS = 256


def _matvec_plain(mv_edge, mv_other, w, diag, y):
    acc = torch.zeros_like(y)
    for k in range(mv_edge.shape[0]):
        e, j = mv_edge[k].long(), mv_other[k].long()
        ok = e >= 0
        c = torch.where(ok, (-w[e.clamp(min=0)]) * y[j.clamp(min=0)], 0.0)
        acc = c if k == 0 else acc + c
    return diag * y + acc


def gather_matvec_plain(mv_edge, mv_other, w, diag, x, b=None, norm: bool = False):
    """Eager version: ``L x`` (with ``b``: ``b − L x``, and its norm with ``norm``)."""
    out = _matvec_plain(mv_edge, mv_other, w, diag, x)
    if b is None:
        return out
    res = b - out
    return (res, torch.linalg.norm(res)) if norm else res


def gather_cheb_plain(mv_edge, mv_other, w, diag, s, rs, dvec, x_in, x_out, c1: float, c2: float,
                      z=None, base=None) -> None:
    """Eager version of one Chebyshev-Jacobi step."""
    mv = s * _matvec_plain(mv_edge, mv_other, w, diag, s * x_in)
    dv = c1 * dvec + c2 * (rs - mv)
    dvec.copy_(dv)
    xn = x_in + dv
    x_out.copy_(xn)
    if z is not None:
        z.copy_(s * xn if base is None else base + s * xn)


def _check(name, mv_edge, mv_other, w, vecs, B):
    build.require_cuda(name, w, *vecs)
    build.require_cuda(name, mv_edge, mv_other, dtype=torch.int32)
    if mv_edge.dim() != 2 or mv_edge.shape != mv_other.shape or mv_edge.shape[1] != B:
        raise ValueError(f"{name}: the tables must both be (K, B)")
    if any(tuple(v.shape) != (B,) for v in vecs):
        raise ValueError(f"{name}: vectors must be (B,)")


def gather_matvec(mv_edge, mv_other, w, diag, x, b=None, norm: bool = False):
    """K19b on ``x``'s device: ``L x``, or ``b − L x`` (and its norm) when
    ``b`` is given."""
    if x.device.type == "cpu":
        return gather_matvec_plain(mv_edge, mv_other, w, diag, x, b, norm)
    B = x.shape[0]
    _check("gather_matvec", mv_edge, mv_other, w, [diag, x] + ([] if b is None else [b]), B)
    if norm and b is None:
        raise ValueError("gather_matvec: norm needs b")
    dev, dt = x.device, torch.float64
    out = torch.empty(B, dtype=dt, device=dev)
    partial = torch.empty((B + THREADS - 1) // THREADS, dtype=dt, device=dev) if norm else None
    nrm = torch.empty((), dtype=dt, device=dev) if norm else None
    with torch.cuda.device(dev):
        code = build.library().nxfx_gather_apply(
            B, mv_edge.shape[0], mv_edge.data_ptr(), mv_other.data_ptr(), w.data_ptr(),
            diag.data_ptr(), x.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), None if nrm is None else nrm.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "gather_matvec")
    gather_matvec.launches += 1
    return (out, nrm) if norm else out


gather_matvec.launches = 0


def gather_cheb(mv_edge, mv_other, w, diag, s, rs, dvec, x_in, x_out, c1: float, c2: float, z=None,
                base=None) -> None:
    """One fused Chebyshev-Jacobi step: ``dvec`` in place, ``x_out`` (a
    buffer other than ``x_in``) and, on the last step, ``z``."""
    if x_in.device.type == "cpu":
        return gather_cheb_plain(mv_edge, mv_other, w, diag, s, rs, dvec, x_in, x_out, c1, c2, z, base)
    B = x_in.shape[0]
    vecs = [diag, s, rs, dvec, x_in, x_out] + [t for t in (z, base) if t is not None]
    _check("gather_cheb", mv_edge, mv_other, w, vecs, B)
    if x_in.data_ptr() == x_out.data_ptr():
        raise ValueError("gather_cheb: x_out must be another buffer than x_in")
    dev = x_in.device
    with torch.cuda.device(dev):
        code = build.library().nxfx_gather_cheb(
            B, mv_edge.shape[0], mv_edge.data_ptr(), mv_other.data_ptr(), w.data_ptr(),
            diag.data_ptr(), s.data_ptr(), rs.data_ptr(), dvec.data_ptr(), x_in.data_ptr(),
            x_out.data_ptr(), float(c1), float(c2), None if z is None else z.data_ptr(),
            None if base is None else base.data_ptr(), build.stream_handle(dev),
        )
    build.check(code, "gather_cheb")
    gather_matvec.launches += 1
