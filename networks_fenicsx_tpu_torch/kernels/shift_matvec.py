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

Both take a :class:`ShiftPlan`, made once where the classes are uploaded
(:func:`..lattice.device_lattice_plan` for the general DCT route, the CG
executor's operator, the 1-D multigrid levels).  Each wrapper launches the
kernel for CUDA tensors — one launch a call, the norm finished inside it, on
the lean path: one pass of checks, the raw stream, no device switch when the
device is current, the norm's scratch from the plan — and runs its plain
version, the reference's zero-padded shifts in eager PyTorch, for CPU
tensors.

:func:`shift_matvec_scenarios` takes S scenarios in one launch (the general
DCT route's sweep): ``x`` ``(S, B)``, the class weights, ``diag`` and ``b``
batched or shared, each scenario's norm with its own partials and ticket
(:func:`.build.norm_scratch`); row ``i`` is :func:`shift_matvec`'s bits on
row ``i``.  It counts its own calls.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

__all__ = [
    "ShiftPlan", "shift_matvec", "shift_matvec_plain", "shift_cheb", "shift_cheb_plain",
    "shift_matvec_scenarios", "shift_matvec_scenarios_plain",
]

THREADS = 256
MAX_CLASSES = 16  # SHIFT_MAX_CLASSES in csrc/shift_matvec.cu


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


class _ShiftArgs(ctypes.Structure):
    """``ShiftArgs`` of ``csrc/shift_matvec.cu``."""

    _fields_ = [("B", ctypes.c_int), ("C", ctypes.c_int), ("stride", ctypes.c_int),
                ("d", ctypes.c_int * MAX_CLASSES), ("partial", ctypes.c_void_p),
                ("ticket", ctypes.c_void_p)]


class ShiftPlan:
    """K18's classes on one device, made once where they are uploaded.

    ``offsets`` are the host class offsets in ascending order (int32, at most
    :data:`MAX_CLASSES`), ``B`` the rows, ``stride`` the stride at which the
    kernel reads ``diag`` and ``b`` (2 for the columns of the general DCT
    route's interleaved ``(B, 2)`` system ``dr``, else 1), ``index`` the
    CUDA device (-1 off CUDA).  The launcher's argument struct (rows,
    classes, offsets, stride) is packed once per calling stream together with
    that stream's scratch — the norm's ``blocks`` partial sums and its ticket
    word, zeroed on the stream at its first call and left at 0 by every
    launch.  The class weights change every solve and are checked per call,
    in the pass that checks the vectors.  Raises ``ValueError`` for offsets
    that are not ascending, more classes than the kernel takes, or a shape
    out of its range."""

    __slots__ = ("offsets", "B", "C", "stride", "index", "blocks", "_scratch")

    def __init__(self, offsets, B: int, device, stride: int = 1):
        offsets = np.ascontiguousarray(offsets, dtype=np.int32)
        if offsets.ndim != 1 or offsets.size > MAX_CLASSES or np.any(np.diff(offsets) <= 0):
            raise ValueError(f"ShiftPlan: at most {MAX_CLASSES} class offsets, ascending")
        if not 0 <= B < 2**31 - THREADS or stride not in (1, 2):
            raise ValueError(f"ShiftPlan: B in [0, 2^31) and stride 1 or 2, got {B}, {stride}")
        device = torch.device(device)
        if device.type == "meta":
            raise ValueError("ShiftPlan: a meta device holds no data")
        self.offsets, self.B, self.C, self.stride = offsets, int(B), int(offsets.size), int(stride)
        self.index = (device.index if device.index is not None else torch.cuda.current_device()) \
            if device.type == "cuda" else -1
        self.blocks = -(-self.B // THREADS)
        self._scratch = {}

    def _args(self, stream: int) -> int:
        """The address of the plan's :class:`_ShiftArgs` on CUDA stream
        ``stream``, made at the stream's first call."""
        entry = self._scratch.get(stream)
        if entry is None:
            buf = torch.zeros(self.blocks + 1, dtype=torch.float64, device=f"cuda:{self.index}")
            args = _ShiftArgs(self.B, self.C, self.stride, (ctypes.c_int * MAX_CLASSES)(*self.offsets),
                              buf.data_ptr(), buf.data_ptr() + 8 * self.blocks)
            entry = self._scratch[stream] = (ctypes.addressof(args), args, buf)
        return entry[0]


def _require_operator(name: str, plan: ShiftPlan, cw, *strided) -> None:
    """The per-call check of the class weights (``(C, B)`` contiguous) and of
    the tensors read at the plan's stride (``diag``, ``b``), one pass."""
    index, B = plan.index, plan.B
    if (not cw.is_cuda or cw.get_device() != index or cw.dtype is not torch.float64
            or tuple(cw.shape) != (plan.C, B) or not cw.is_contiguous()):
        raise ValueError(f"{name}: cw must be a contiguous float64 ({plan.C}, {B}) tensor on CUDA "
                         f"device {index}")
    for t in strided:
        if (not t.is_cuda or t.get_device() != index or t.dtype is not torch.float64
                or t.dim() != 1 or t.shape[0] != B or (B > 1 and t.stride(0) != plan.stride)):
            raise ValueError(f"{name}: diag and b must be float64 ({B},) tensors of stride "
                             f"{plan.stride} on CUDA device {index}")


def shift_matvec(plan: ShiftPlan, cw, diag, x, b=None, norm: bool = False):
    """K18 on ``x``'s device: ``L x``, or ``b − L x`` (and its norm) when
    ``b`` is given; ``cw`` the ``(C, B)`` class weights, ``diag`` and ``b``
    ``(B,)`` at the plan's stride, ``x`` contiguous.  One launch a call."""
    if x.device.type == "cpu":
        return shift_matvec_plain(plan.offsets, cw, diag, x, b, norm)
    index, B = plan.index, plan.B
    build.require_vectors("shift_matvec", index, (x, B))
    _require_operator("shift_matvec", plan, cw, diag, *(() if b is None else (b,)))
    if norm and b is None:
        raise ValueError("shift_matvec: the norm is of the residual b - L x: b is needed")
    out = x.new_empty(B)
    nrm = x.new_empty(()) if norm else None
    stream = build.raw_stream(index)
    code = build.on_device(index, build.library().nxfx_shift_matvec, plan._args(stream), cw.data_ptr(),
                           diag.data_ptr(), x.data_ptr(), None if b is None else b.data_ptr(),
                           out.data_ptr(), None if nrm is None else nrm.data_ptr(), stream)
    if code:
        build.check(code, "shift_matvec")
    shift_matvec.launches += 1
    return (out, nrm) if norm else out


shift_matvec.launches = 0


def shift_cheb(plan: ShiftPlan, cw, diag, s, rs, dvec, x_in, x_out, c1: float, c2: float, z=None,
               base=None) -> None:
    """K18's fused Chebyshev-Jacobi step: ``dvec`` in place, ``x_out`` (a
    buffer other than ``x_in``) and, on the last step, ``z``."""
    if x_in.device.type == "cpu":
        return shift_cheb_plain(plan.offsets, cw, diag, s, rs, dvec, x_in, x_out, c1, c2, z, base)
    index, B = plan.index, plan.B
    build.require_vectors("shift_cheb", index, *((t, B) for t in (s, rs, dvec, x_in, x_out, z, base)
                                               if t is not None))
    _require_operator("shift_cheb", plan, cw, diag)
    if x_in.data_ptr() == x_out.data_ptr():
        raise ValueError("shift_cheb: x_out must be another buffer than x_in")
    stream = build.raw_stream(index)
    code = build.on_device(index, build.library().nxfx_shift_cheb, plan._args(stream), cw.data_ptr(),
                           diag.data_ptr(), s.data_ptr(), rs.data_ptr(), dvec.data_ptr(), x_in.data_ptr(),
                           x_out.data_ptr(), float(c1), float(c2), None if z is None else z.data_ptr(),
                           None if base is None else base.data_ptr(), stream)
    if code:
        build.check(code, "shift_cheb")
    shift_matvec.launches += 1


def _scenario_shapes(name: str, plan: ShiftPlan, cw, diag, x, b) -> tuple:
    """``(S, s_cw, s_diag, s_b)`` of a scenario call, or raise: ``x`` the
    contiguous ``(S, B)`` rows, ``cw`` ``(C, B)`` or ``(S, C, B)``
    contiguous, ``diag`` and ``b`` ``(B,)`` or ``(S, B)`` at the plan's
    stride within a row and any row stride."""
    B, C = plan.B, plan.C
    if x.dtype is not torch.float64 or x.dim() != 2 or x.shape[1] != B or x.shape[0] < 1 \
            or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous float64 (S, {B}), got {x.dtype} "
                         f"{tuple(x.shape)}")
    S = int(x.shape[0])
    if cw.dtype is not torch.float64 or tuple(cw.shape) not in ((C, B), (S, C, B)) \
            or not cw.is_contiguous():
        raise ValueError(f"{name}: cw must be contiguous float64 ({C}, {B}) or ({S}, {C}, {B}), "
                         f"got {cw.dtype} {tuple(cw.shape)}")
    strides = []
    for t in (diag, b):
        if t is None:
            strides.append(0)
            continue
        if t.dtype is not torch.float64 or tuple(t.shape) not in ((B,), (S, B)) \
                or (B > 1 and t.stride(-1) != plan.stride):
            raise ValueError(f"{name}: diag and b must be float64 ({B},) or ({S}, {B}) at stride "
                             f"{plan.stride} within a row, got {t.dtype} {tuple(t.shape)}")
        strides.append(t.stride(0) if t.dim() == 2 else 0)
    return S, (C * B if cw.dim() == 3 else 0), strides[0], strides[1]


def shift_matvec_scenarios_plain(plan: ShiftPlan, cw, diag, x, b=None, norm: bool = False):
    """Eager version of :func:`shift_matvec_scenarios`: :func:`shift_matvec_plain`
    a row, stacked."""
    S = _scenario_shapes("shift_matvec_scenarios", plan, cw, diag, x, b)[0]

    def row(t, dims, i):
        return t[i] if t is not None and t.dim() > dims else t

    rows = [shift_matvec_plain(plan.offsets, row(cw, 2, i), row(diag, 1, i), x[i], row(b, 1, i),
                               norm) for i in range(S)]
    if not norm:
        return torch.stack(rows)
    out, nrm = (torch.stack(t) for t in zip(*rows))
    return out, nrm


def shift_matvec_scenarios(plan: ShiftPlan, cw, diag, x, b=None, norm: bool = False):
    """K18 over S scenarios on ``x``'s device, one launch: ``L x`` or ``b −
    L x`` (and its norm ``(S,)``) of each row of ``x (S, B)``; ``cw`` ``(C,
    B)`` or ``(S, C, B)``, ``diag`` and ``b`` ``(B,)`` or ``(S, B)`` at the
    plan's stride within a row (any row stride: the columns of the
    ``(S, B, 2)`` systems)."""
    if x.device.type == "cpu":
        return shift_matvec_scenarios_plain(plan, cw, diag, x, b, norm)
    name, index = "shift_matvec_scenarios", plan.index
    S, s_cw, s_diag, s_b = _scenario_shapes(name, plan, cw, diag, x, b)
    if norm and b is None:
        raise ValueError(f"{name}: the norm is of the residual b - L x: b is needed")
    build.require_cuda(name, x, cw, diag, *(() if b is None else (b,)), contiguous=False)
    if x.get_device() != index:
        raise ValueError(f"{name}: tensors must be on CUDA device {index}")
    out = x.new_empty((S, plan.B))
    nrm = x.new_empty(S) if norm else None
    stream = build.raw_stream(index)
    partial, tickets = build.norm_scratch(plan._scratch, stream, index, S, plan.blocks)
    code = build.on_device(index, build.library().nxfx_shift_matvec_scen, plan._args(stream), S,
                           s_cw, s_diag, s_b, cw.data_ptr(), diag.data_ptr(), x.data_ptr(),
                           None if b is None else b.data_ptr(), out.data_ptr(),
                           None if nrm is None else nrm.data_ptr(), partial, tickets, stream)
    if code:
        build.check(code, name)
    shift_matvec_scenarios.launches += 1
    return (out, nrm) if norm else out


shift_matvec_scenarios.launches = 0
