"""K19b: the bifurcation Laplacian matvec by gather and fold
(``csrc/gather_matvec.cu``), for graphs without a shift plan.

Replaces ``networks_fenicsx_tpu/solver.py:_matvec_from_plan``
(``:1561-1580``): with the ``(K, B)`` tables ``mv_edge`` and ``mv_other`` of
:func:`..lattice.gather_matvec_tables` (row ``i``'s half-edges in the fold
order of the reference's ``_segsum_sorted``, ``-1`` past the last),
``w = 1/W`` per edge and the diagonal,

    (L x)_i = diag_i·x_i + Σ_k (−w[mv_edge[k, i]])·x[mv_other[k, i]]

with the sum over ``k`` in order.  The reference's ``_structured_take`` (a
TPU pattern match of gathers into slices) is not ported: a plain gather.

A :class:`GatherPlan` holds the tables on one device, checked once (the CG
executor makes it with its device tables).  ``w`` is fixed for a solve, so
:func:`gather_values` gathers a solve's value table ``−w[mv_edge]`` once
(``0`` past a row's last entry), and the wrappers read it:
:func:`gather_matvec` gives ``L x`` or, with ``b``, ``b − L x`` (and its
norm); :class:`ChebApply` a whole Chebyshev-Jacobi application
(``ops/krylov.py:20-68``: K19a's start and the ``degree − 1`` steps) from
one host call and one launch.  Products and sums are the direct form's
(``(−w_e)·x_j`` in order), so the results are the plain versions' to the
bit.  :func:`gather_cheb_plain`, one step of the composed application, is
the plain path's step.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
— the gather matrix's columns added in order — for CPU tensors.  All count
on :data:`LAUNCHES`: ``launches`` a call, ``device`` the kernels the
launchers enqueued, as they report them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

__all__ = [
    "GatherPlan", "ChebApply", "gather_values", "gather_values_plain", "gather_matvec",
    "gather_matvec_plain", "gather_cheb_plain", "cheb_apply_plain", "LAUNCHES",
]

THREADS = 256
LAUNCHES = build.Counter("gather_matvec")
LAUNCHES.device = 0  # kernels enqueued, as the launchers report them


def gather_values_plain(mv_edge, w) -> torch.Tensor:
    """Eager version of :func:`gather_values`: ``−w[mv_edge]``, 0 at ``-1``."""
    e = mv_edge.long()
    return torch.where(e >= 0, -w[e.clamp(min=0)], 0.0)


def _values_matvec_plain(mv_other, vals, diag, y):
    acc = torch.zeros_like(y)
    for k in range(mv_other.shape[0]):
        j = mv_other[k].long()
        c = torch.where(j >= 0, vals[k] * y[j.clamp(min=0)], 0.0)
        acc = c if k == 0 else acc + c
    return diag * y + acc


def _residual(out, b, norm: bool):
    if b is None:
        return out
    res = b - out
    return (res, torch.linalg.norm(res)) if norm else res


def gather_matvec_plain(mv_edge, mv_other, w, diag, x, b=None, norm: bool = False):
    """Eager version: ``L x`` (with ``b``: ``b − L x``, and its norm with ``norm``)."""
    return _residual(_values_matvec_plain(mv_other, gather_values_plain(mv_edge, w), diag, x), b, norm)


def _cheb_plain(mv_other, vals, diag, s, rs, dvec, x_in, x_out, c1: float, c2: float, z=None,
                base=None) -> None:
    mv = s * _values_matvec_plain(mv_other, vals, diag, s * x_in)
    dv = c1 * dvec + c2 * (rs - mv)
    dvec.copy_(dv)
    xn = x_in + dv
    x_out.copy_(xn)
    if z is not None:
        z.copy_(s * xn if base is None else base + s * xn)


def gather_cheb_plain(mv_edge, mv_other, w, diag, s, rs, dvec, x_in, x_out, c1: float, c2: float,
                      z=None, base=None) -> None:
    """Eager version of one Chebyshev-Jacobi step."""
    _cheb_plain(mv_other, gather_values_plain(mv_edge, w), diag, s, rs, dvec, x_in, x_out, c1, c2, z,
                base)


def _cheb_apply_values(mv_other, vals, diag, s, r, theta: float, coeffs, z=None, base=None):
    z = torch.empty_like(r) if z is None else z
    rs = s * r
    dvec = rs / torch.full_like(rs, theta)
    if not coeffs:
        z.copy_(s * dvec if base is None else base + s * dvec)
        return z
    xa, xb = dvec.clone(), torch.empty_like(r)
    for t, (c1, c2) in enumerate(coeffs):
        last = t == len(coeffs) - 1
        _cheb_plain(mv_other, vals, diag, s, rs, dvec, xa, xb, c1, c2, z if last else None,
                    base if last else None)
        xa, xb = xb, xa
    return z


def cheb_apply_plain(mv_edge, mv_other, w, diag, s, r, theta: float, coeffs, z=None, base=None):
    """Eager version of :class:`ChebApply`: K19a's start (``rs = s r``,
    ``x = dvec = rs/θ``, an elementwise IEEE division, as the kernels
    divide) and :func:`gather_cheb_plain`'s steps, composed; returns ``z``
    (plus ``base``)."""
    return _cheb_apply_values(mv_other, gather_values_plain(mv_edge, w), diag, s, r, theta, coeffs, z, base)


class GatherPlan:
    """K19b's tables on one device, checked once: ``mv_edge`` and
    ``mv_other`` contiguous int32 ``(K, B)`` on one device (not meta), each
    entry in ``[-1, num_edges)`` and ``[-1, B)``, ``-1`` in both at the same
    places and, down a column, past its first ``-1`` only.  ``index`` is the
    CUDA device (-1 off CUDA).  Each calling stream gets a scratch (a
    Chebyshev application's four vectors, the norm's partial sums and the
    application's barrier words, zeroed), made at its first call.  Raises
    ``ValueError`` for tables that break any of this."""

    __slots__ = ("mv_edge", "mv_other", "K", "B", "E", "index", "blocks", "_scratch")

    def __init__(self, mv_edge, mv_other, num_edges: int):
        for t in (mv_edge, mv_other):
            if (not isinstance(t, torch.Tensor) or t.dtype is not torch.int32 or t.dim() != 2
                    or not t.is_contiguous() or t.device.type == "meta"):
                raise ValueError("GatherPlan: the tables must be contiguous int32 (K, B) tensors with data")
        if mv_edge.shape != mv_other.shape or mv_edge.device != mv_other.device:
            raise ValueError("GatherPlan: the two tables must share one shape and one device")
        K, B = (int(n) for n in mv_edge.shape)
        if not 0 <= B < 2**31 - THREADS or K * B >= 2**31:
            raise ValueError(f"GatherPlan: B = {B} rows of {K} out of range")
        e, j = mv_edge.cpu().numpy(), mv_other.cpu().numpy()
        pad = e < 0
        if (np.any(e < -1) or np.any(e >= num_edges) or np.any(j < -1) or np.any(j >= B)
                or not np.array_equal(pad, j < 0)):
            raise ValueError("GatherPlan: an entry out of range, or -1 in one table only")
        if K > 1 and np.any(pad[:-1] & ~pad[1:]):
            raise ValueError("GatherPlan: an entry past a row's first -1")
        dev = mv_edge.device
        self.mv_edge, self.mv_other, self.K, self.B, self.E = mv_edge, mv_other, K, B, int(num_edges)
        self.index = (dev.index if dev.index is not None else torch.cuda.current_device()) \
            if dev.type == "cuda" else -1
        self.blocks = -(-B // THREADS)
        self._scratch = {}

    def scratch(self, stream: int) -> torch.Tensor:
        """Stream ``stream``'s scratch: ``4 B`` doubles (an application's
        ``rs``, ``dvec`` and its two iterates), ``blocks`` partial sums and
        one double holding the barrier's two words."""
        buf = self._scratch.get(stream)
        if buf is None:
            buf = self._scratch[stream] = torch.zeros(4 * self.B + self.blocks + 1, dtype=torch.float64,
                                                      device=f"cuda:{self.index}")
        return buf


def _count(enqueued: int, name: str) -> None:
    """Count a launcher's kernels (minus a CUDA error when negative)."""
    if enqueued < 0:
        build.check(-enqueued, name)
    LAUNCHES.launches += 1
    LAUNCHES.device += enqueued


def _require_values(name: str, plan: GatherPlan, vals) -> None:
    if (not vals.is_cuda or vals.get_device() != plan.index or vals.dtype is not torch.float64
            or tuple(vals.shape) != (plan.K, plan.B) or not vals.is_contiguous()):
        raise ValueError(f"{name}: the value table must be a contiguous float64 ({plan.K}, {plan.B}) "
                         f"tensor on CUDA device {plan.index}")


def gather_values(plan: GatherPlan, w) -> torch.Tensor:
    """A solve's value table ``−w[mv_edge]`` ``(K, B)`` on ``w``'s device
    (one launch)."""
    if w.device.type == "cpu":
        return gather_values_plain(plan.mv_edge, w)
    index = plan.index
    build.require_vectors("gather_values", index, (w, plan.E))
    vals = w.new_empty((plan.K, plan.B))
    stream = build.raw_stream(index)
    _count(build.on_device(index, build.library().nxfx_gather_values, plan.B, plan.K, plan.mv_edge.data_ptr(),
                           w.data_ptr(), vals.data_ptr(), stream), "gather_values")
    return vals


def gather_matvec(plan: GatherPlan, vals, diag, x, b=None, norm: bool = False, out=None):
    """K19b on ``x``'s device from a solve's value table: ``L x``, or
    ``b − L x`` (and its norm) when ``b`` is given; into ``out`` when given."""
    if x.device.type == "cpu":
        return _residual(_values_matvec_plain(plan.mv_other, vals, diag, x), b, norm)
    index, B = plan.index, plan.B
    build.require_vectors("gather_matvec", index, *((t, B) for t in (diag, x, b, out) if t is not None))
    _require_values("gather_matvec", plan, vals)
    if norm and b is None:
        raise ValueError("gather_matvec: norm needs b")
    out = x.new_empty(B) if out is None else out
    stream = build.raw_stream(index)
    partial = nrm = None
    if norm:
        partial = plan.scratch(stream)[4 * B:]
        nrm = x.new_empty(())
    _count(build.on_device(index, build.library().nxfx_gather_plan_apply, B, plan.K, plan.mv_other.data_ptr(),
                           vals.data_ptr(), diag.data_ptr(), x.data_ptr(), None if b is None else b.data_ptr(),
                           out.data_ptr(), None if partial is None else partial.data_ptr(),
                           None if nrm is None else nrm.data_ptr(), stream), "gather_matvec")
    return (out, nrm) if norm else out


class _ChebArgs(ctypes.Structure):
    """``GatherChebArgs`` of ``csrc/gather_matvec.cu``."""

    _fields_ = [("B", ctypes.c_int), ("K", ctypes.c_int), ("steps", ctypes.c_int),
                ("grid", ctypes.c_int), ("o_idx", ctypes.c_void_p),
                ("nw", ctypes.c_void_p), ("diag", ctypes.c_void_p), ("s", ctypes.c_void_p),
                ("coef", ctypes.c_void_p), ("theta", ctypes.c_double), ("rs", ctypes.c_void_p),
                ("dvec", ctypes.c_void_p), ("xa", ctypes.c_void_p), ("xb", ctypes.c_void_p),
                ("bar", ctypes.c_void_p)]


@functools.cache
def _resident_blocks(index: int) -> int:
    """The blocks of a :class:`ChebApply` launch that CUDA device ``index``
    holds at once (its grid barrier needs them all resident)."""
    grid = build.on_device(index, build.library().nxfx_gather_cheb_blocks, index)
    if grid <= 0:
        raise RuntimeError("ChebApply: no co-resident grid for the application's launch")
    return grid


class ChebApply:
    """A Chebyshev-Jacobi application ``M⁻¹ ≈ A⁻¹`` of degree
    ``len(coeffs) + 1`` on a plan's operator, from one host call and one
    device launch: K19a's start (``rs = s r``, ``x = dvec = rs/θ``) folded
    into the first step, then the others
    (:func:`..ops.krylov.chebyshev_coefficients` gives ``θ`` and
    ``coeffs``), a grid barrier between two steps, each step's vectors in the
    calling stream's scratch of the plan.  ``vals``, ``diag`` and the
    scaling ``s`` (``diag^-1/2``) are checked once here and held as long as
    the application.  Equal to :func:`cheb_apply_plain` to the bit, which
    it runs on a plan off CUDA."""

    __slots__ = ("plan", "_base", "_held", "_plain", "_scratch")

    def __init__(self, plan: GatherPlan, vals, diag, s, theta: float, coeffs):
        index, B = plan.index, plan.B
        coeffs = [(float(c1), float(c2)) for c1, c2 in coeffs]
        self.plan, self._scratch = plan, {}
        if index < 0:
            self._plain = (plan.mv_other, vals, diag, s, float(theta), coeffs)
            return
        build.require_vectors("ChebApply", index, (diag, B), (s, B))
        _require_values("ChebApply", plan, vals)
        coef = torch.tensor([c for c, _ in coeffs] + [c for _, c in coeffs] or [0.0], dtype=torch.float64,
                            device=diag.device)
        self._plain = None
        self._held = (vals, diag, s, coef)  # kept alive: the struct points at them
        self._base = _ChebArgs(B, plan.K, len(coeffs), _resident_blocks(index), plan.mv_other.data_ptr(),
                               vals.data_ptr(), diag.data_ptr(), s.data_ptr(), coef.data_ptr(),
                               float(theta))

    def _args(self, stream: int) -> int:
        entry = self._scratch.get(stream)
        if entry is None:
            buf = self.plan.scratch(stream)
            B = self.plan.B
            args = _ChebArgs.from_buffer_copy(self._base)
            at = buf.data_ptr()
            args.rs, args.dvec, args.xa, args.xb = (at + 8 * B * i for i in range(4))
            args.bar = at + 8 * (buf.numel() - 1)
            entry = self._scratch[stream] = (ctypes.addressof(args), args)
        return entry[0]

    def __call__(self, r, out=None, base=None) -> torch.Tensor:
        """``M⁻¹ r`` (plus ``base``), into ``out`` when given, else a new vector."""
        if r.device.type == "cpu":
            if self._plain is None:
                raise ValueError("ChebApply: the plan is on CUDA, r on the CPU")
            mv_other, vals, diag, s, theta, coeffs = self._plain
            return _cheb_apply_values(mv_other, vals, diag, s, r, theta, coeffs, out, base)
        index, B = self.plan.index, self.plan.B
        build.require_vectors("ChebApply", index, *((t, B) for t in (r, out, base) if t is not None))
        z = r.new_empty(B) if out is None else out
        stream = build.raw_stream(index)
        _count(build.on_device(index, build.library().nxfx_gather_cheb_apply, self._args(stream), r.data_ptr(),
                               z.data_ptr(), None if base is None else base.data_ptr(), stream),
               "gather_cheb_apply")
        return z
