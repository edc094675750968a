"""K19d: the 1-D pairwise-aggregation multigrid V-cycle (``csrc/mg1d.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_mg_preconditioner``
(``:1482-1558``) on the host plan of :func:`..multigrid._plan_mg`:

* :func:`level0` — level 0's boundary excess ``extra = diag − Σ_c w_c`` and
  Jacobi scaling ``diag^-1/2``;
* :func:`coarsen` — a coarse level's class weights through the plan's
  parity mapping (:class:`..multigrid.Mg1dLevel`, its tables uploaded once
  per executor), its ``extra`` (pair sums), diagonal and scaling.

A smoothed level of a cycle is a :class:`Level`: its class offsets and
``(C, m)`` class weights, its diagonal and scaling.  The plain level loop
composes K19a's smoother start, K18's operator and Chebyshev steps
(:func:`.shift_matvec.shift_matvec_plain`, :func:`.shift_matvec.shift_cheb_plain`),
:func:`restrict_plain` (pair sums, even padding) and :func:`prolong_plain`
(``x += overcorrect·e[i // 2]``); the V-cycle's kernel path fuses them, each
fusion computing exactly what the composed plain versions compute, in
their order:

* :func:`cheb_first` — the smoother's start folded into its first step;
* :func:`residual_restrict` — ``restrict(b − L x)``, the fine residual
  never stored;
* :func:`prolong_residual` — ``x' = x + overcorrect·e[i // 2]`` and
  ``b − L x'``, into two other buffers.

A :class:`Cycle` holds a hierarchy's smoothed levels on one CUDA device,
checked once, with a scratch of the calling stream's vectors made at its
first call; its :meth:`Cycle.down` and :meth:`Cycle.up` issue a V-cycle's
descent and ascent around K19c's coarsest solve (:func:`.mg2d.coarse_solve`),
3 launches a level each way (a smoother's two and one fused transfer), from
one host call each.

Every wrapper launches its kernel for CUDA tensors (counted in
:data:`LAUNCHES`) and runs its plain version — the reference's pads,
reshapes and repeats in eager PyTorch — for CPU tensors.
"""

from __future__ import annotations

import ctypes
import typing

import numpy as np
import torch

from . import build, krylov, shift_matvec

__all__ = [
    "level0", "level0_plain", "coarsen", "coarsen_plain", "restrict_plain", "prolong_plain",
    "cheb_first", "cheb_first_plain", "residual_restrict", "residual_restrict_plain",
    "prolong_residual", "prolong_residual_plain", "cycle_plain", "Level", "Cycle", "sweep_launches",
    "LAUNCHES",
]

MAX_LEVELS = 16  # MG1D_MAX_LEVELS in csrc/mg1d.cu
MAX_STEPS = 8  # MG1D_MAX_STEPS: the smoother's steps after its start
MAX_CLASSES = 16  # MG1D_MAX_CLASSES: _plan_mg's max_classes
LAUNCHES = build.Counter("mg1d")


class Level(typing.NamedTuple):
    """A smoothed level: its class ``offsets`` (host int32, ascending), the
    ``(C, m)`` class weights ``cw``, the diagonal and its Jacobi scaling
    ``dis = diag^-1/2``."""

    offsets: np.ndarray
    cw: torch.Tensor
    diag: torch.Tensor
    dis: torch.Tensor


# ------------------------------------------------------------------ plain


def level0_plain(cw, diag) -> tuple[torch.Tensor, torch.Tensor]:
    total = 0.0
    for c in range(cw.shape[0]):
        total = total + cw[c]
    return diag - total, 1.0 / torch.sqrt(diag)


def _pad_even(v: torch.Tensor, mc: int) -> torch.Tensor:
    return torch.nn.functional.pad(v, (0, 2 * mc - v.shape[0]))


def coarsen_plain(level, cw_f, extra_f):
    """``(cw_c (Cc, mc), extra_c, diag_c, dis_c)`` of the level below ``level``."""
    mc = level.mc
    cw_c = []
    total = 0.0
    for _, contribs in level.mapping:
        acc = torch.zeros(mc, dtype=cw_f.dtype, device=cw_f.device)
        for ci, p in contribs:
            acc = acc + _pad_even(cw_f[ci], mc)[p::2]
        cw_c.append(acc)
        total = total + acc
    extra_c = _pad_even(extra_f, mc).reshape(mc, 2)
    extra_c = extra_c[:, 0] + extra_c[:, 1]
    diag_c = extra_c + total
    return torch.stack(cw_c), extra_c, diag_c, 1.0 / torch.sqrt(diag_c)


def restrict_plain(res, mc: int) -> torch.Tensor:
    pairs = _pad_even(res, mc).reshape(mc, 2)
    return pairs[:, 0] + pairs[:, 1]


def prolong_plain(x, ec, overcorrect: float) -> None:
    x.copy_(x + overcorrect * ec.repeat_interleave(2)[: x.shape[0]])


def cheb_first_plain(lev: Level, r, theta: float, rs, dvec, x_out, c1: float, c2: float, z=None,
                     base=None) -> None:
    """The composed version: K19a's ``cheb_start_plain`` with the level's
    scaling into ``rs``, ``dvec`` and a start ``x``, then K18's
    ``shift_cheb_plain``."""
    x = torch.empty_like(r)
    krylov.cheb_start_plain(lev.dis, r, theta, rs, dvec, x)
    shift_matvec.shift_cheb_plain(lev.offsets, lev.cw, lev.diag, lev.dis, rs, dvec, x, x_out, c1, c2,
                                  z, base)


def residual_restrict_plain(lev: Level, x, b) -> torch.Tensor:
    """The composed version: ``restrict(b − L x)``."""
    res = shift_matvec.shift_matvec_plain(lev.offsets, lev.cw, lev.diag, x, b)
    return restrict_plain(res, (x.shape[0] + 1) // 2)


def prolong_residual_plain(lev: Level, x, ec, overcorrect: float, b):
    """The composed version: ``(x', b − L x')`` with ``x'`` the prolonged
    copy of ``x`` (which is not modified)."""
    xp = x.clone()
    prolong_plain(xp, ec, overcorrect)
    return xp, shift_matvec.shift_matvec_plain(lev.offsets, lev.cw, lev.diag, xp, b)


def cycle_plain(levels, theta: float, coeffs, overcorrect: float, coarse, r) -> torch.Tensor:
    """A :class:`Cycle`'s V-cycle composed of the plain pieces, in its order:
    per level down the smoother (:func:`cheb_first_plain`, then K18's plain
    steps) and :func:`residual_restrict_plain`, ``coarse(rb)`` the coarsest
    solve, per level up :func:`prolong_residual_plain` and the smoother on
    its residual added to the prolonged iterate.  With the plain coarsest
    solve it is ``Mg1dPreconditioner(plain=True)``'s cycle to the bit; with
    the kernel's it is what the :class:`Cycle` computes around that solve."""

    def smooth(lev, rr, base=None):
        rs, dvec, xa, xb, z = (torch.empty_like(rr) for _ in range(5))
        last = len(coeffs) == 1
        cheb_first_plain(lev, rr, theta, rs, dvec, xa, *coeffs[0], z if last else None,
                         base if last else None)
        for t in range(1, len(coeffs)):
            end = t == len(coeffs) - 1
            shift_matvec.shift_cheb_plain(lev.offsets, lev.cw, lev.diag, lev.dis, rs, dvec, xa, xb,
                                          *coeffs[t], z if end else None, base if end else None)
            xa, xb = xb, xa
        return z

    rhs, xs = [r], []
    for l, lev in enumerate(levels):
        xs.append(smooth(lev, rhs[l]))
        rhs.append(residual_restrict_plain(lev, xs[l], rhs[l]))
    e = coarse(rhs[-1])
    for l in reversed(range(len(levels))):
        xp, res = prolong_residual_plain(levels[l], xs[l], e, overcorrect, rhs[l])
        e = smooth(levels[l], res, xp)
    return e


# ---------------------------------------------------------------- kernels


def _launch(name: str, device, *args) -> None:
    index = device.index
    code = build.on_device(index, getattr(build.library(), name), *args, build.raw_stream(index))
    build.check(code, "mg1d")
    LAUNCHES.launches += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(m: int, *vecs) -> None:
    build.require_cuda("mg1d", *vecs)
    if any(tuple(v.shape) != (m,) for v in vecs):
        raise ValueError(f"mg1d: vectors must be ({m},)")


def level0(cw, diag) -> tuple[torch.Tensor, torch.Tensor]:
    """``(extra, dis)`` of level 0 from its ``(C, m)`` class weights and diagonal."""
    if diag.device.type == "cpu":
        return level0_plain(cw, diag)
    m = diag.shape[0]
    _check(m, diag)
    build.require_cuda("mg1d", cw)
    if cw.dim() != 2 or cw.shape[1] != m:
        raise ValueError("mg1d: cw must be (C, m)")
    extra, dis = torch.empty_like(diag), torch.empty_like(diag)
    _launch("nxfx_mg1d_level0", diag.device, m, cw.shape[0], cw.data_ptr(), diag.data_ptr(),
            extra.data_ptr(), dis.data_ptr())
    return extra, dis


def coarsen(level, cw_f, extra_f):
    """The level below ``level`` (an :class:`..multigrid.Mg1dLevel`):
    ``(cw_c (Cc, mc), extra_c, diag_c, dis_c)``."""
    if extra_f.device.type == "cpu":
        return coarsen_plain(level, cw_f, extra_f)
    m, mc, Cc = level.m, level.mc, len(level.mapping)
    _check(m, extra_f)
    build.require_cuda("mg1d", cw_f)
    build.require_cuda("mg1d", level.map_ptr, level.map_ci, level.map_p, dtype=torch.int32)
    if cw_f.dim() != 2 or cw_f.shape[1] != m or tuple(level.map_ptr.shape) != (Cc + 1,):
        raise ValueError("mg1d: cw_f must be (C, m) and the mapping hold Cc + 1 offsets")
    dev, dt = extra_f.device, torch.float64
    cw_c = torch.empty((Cc, mc), dtype=dt, device=dev)
    extra_c, diag_c, dis_c = (torch.empty(mc, dtype=dt, device=dev) for _ in range(3))
    _launch("nxfx_mg1d_coarsen", dev, m, mc, cw_f.data_ptr(), extra_f.data_ptr(), Cc,
            level.map_ptr.data_ptr(), level.map_ci.data_ptr(), level.map_p.data_ptr(),
            cw_c.data_ptr(), extra_c.data_ptr(), diag_c.data_ptr(), dis_c.data_ptr())
    return cw_c, extra_c, diag_c, dis_c


class _LevelArgs(ctypes.Structure):
    """``Mg1dLevelArgs`` of ``csrc/mg1d.cu``."""

    _fields_ = [("m", ctypes.c_int), ("C", ctypes.c_int), ("d", ctypes.c_int * MAX_CLASSES)] + [
        (name, ctypes.c_void_p)
        for name in ("cw", "diag", "dis", "r", "x", "xp", "res", "rs", "dvec", "xa", "xb")]


class _CycleArgs(ctypes.Structure):
    """``Mg1dCycle`` of ``csrc/mg1d.cu``."""

    _fields_ = [("L", ctypes.c_int), ("steps", ctypes.c_int), ("m_bottom", ctypes.c_int),
                ("inv_theta", ctypes.c_double), ("oc", ctypes.c_double),
                ("c1", ctypes.c_double * MAX_STEPS), ("c2", ctypes.c_double * MAX_STEPS),
                ("r_bottom", ctypes.c_void_p), ("lv", _LevelArgs * MAX_LEVELS)]


def _check_level(lev: Level, dev: torch.device, m: int | None = None) -> tuple[np.ndarray, int]:
    """``(offsets, rows)`` of a level checked: int32 offsets ascending, at
    most :data:`MAX_CLASSES`; ``cw (C, m)``, ``diag`` and ``dis (m,)``
    contiguous float64 on ``dev``; ``m`` rows when given."""
    offsets = np.ascontiguousarray(lev.offsets, dtype=np.int32)
    C = offsets.size
    if offsets.ndim != 1 or C > MAX_CLASSES or np.any(np.diff(offsets) <= 0):
        raise ValueError(f"mg1d: a level takes at most {MAX_CLASSES} class offsets, ascending")
    rows = lev.diag.shape[0] if lev.diag.dim() == 1 else -1
    if m is not None and rows != m:
        raise ValueError(f"mg1d: a level of {m} rows expected, got {tuple(lev.diag.shape)}")
    if not 0 < rows < 2**30:
        raise ValueError("mg1d: a level holds 1 to 2^30 rows")
    for t, shape in ((lev.cw, (C, rows)), (lev.diag, (rows,)), (lev.dis, (rows,))):
        if (t.device != dev or t.dtype != torch.float64 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"mg1d: a level's cw, diag and dis must be contiguous float64 "
                             f"({C}, {rows}), ({rows},), ({rows},) tensors on {dev}")
    return offsets, rows


def _pack(lev: Level, offsets: np.ndarray, rows: int, args: _LevelArgs) -> None:
    """A checked level into ``args`` (its scratch left null)."""
    args.m, args.C = rows, offsets.size
    args.d[: offsets.size] = offsets.tolist()
    args.cw, args.diag, args.dis = lev.cw.data_ptr(), lev.diag.data_ptr(), lev.dis.data_ptr()


def _lean(lev: Level, *vecs):
    """The kernel call's checks: CUDA vectors of the level's rows (or the
    coarse rows), the level packed."""
    dev = vecs[0][0].device
    if dev.type != "cuda":
        raise ValueError("mg1d: tensors must be on a CUDA device")
    build.require_vectors("mg1d", dev.index, *vecs)
    args = _LevelArgs()
    _pack(lev, *_check_level(lev, dev, vecs[0][1]), args)
    return args


def cheb_first(lev: Level, r, theta: float, rs, dvec, x_out, c1: float, c2: float, z=None,
               base=None) -> None:
    """The smoother's start folded into its first step: ``rs``, ``dvec``,
    ``x_out`` and, when it is also the last step, ``z``.  The start is
    ``rs·(1/θ)``, ``1/θ`` taken on the host: what PyTorch computes for
    ``rs / θ`` on the card, so the kernel equals :func:`cheb_first_plain` to
    the bit there."""
    if r.device.type == "cpu":
        return cheb_first_plain(lev, r, theta, rs, dvec, x_out, c1, c2, z, base)
    m = r.shape[0]
    args = _lean(lev, *((t, m) for t in (r, rs, dvec, x_out, z, base) if t is not None))
    _launch("nxfx_mg1d_cheb_first", r.device, ctypes.addressof(args), r.data_ptr(), 1.0 / float(theta),
            float(c1), float(c2), rs.data_ptr(), dvec.data_ptr(), x_out.data_ptr(), _ptr(z),
            _ptr(base))


def residual_restrict(lev: Level, x, b) -> torch.Tensor:
    """``restrict(b − L x)`` in one launch."""
    if x.device.type == "cpu":
        return residual_restrict_plain(lev, x, b)
    m = x.shape[0]
    args = _lean(lev, (x, m), (b, m))
    rc = x.new_empty((m + 1) // 2)
    _launch("nxfx_mg1d_residual_restrict", x.device, ctypes.addressof(args), x.data_ptr(), b.data_ptr(),
            rc.data_ptr())
    return rc


def prolong_residual(lev: Level, x, ec, overcorrect: float, b):
    """``(x', b − L x')`` with ``x' = x + overcorrect·e[i // 2]``, in one
    launch (``x`` is not modified)."""
    if x.device.type == "cpu":
        return prolong_residual_plain(lev, x, ec, overcorrect, b)
    m = x.shape[0]
    args = _lean(lev, (x, m), (b, m), (ec, (m + 1) // 2))
    xp, res = x.new_empty(m), x.new_empty(m)
    _launch("nxfx_mg1d_prolong_residual", x.device, ctypes.addressof(args), x.data_ptr(), ec.data_ptr(),
            float(overcorrect), b.data_ptr(), xp.data_ptr(), res.data_ptr())
    return xp, res


# ------------------------------------------------------------- the cycle


def sweep_launches(L: int, steps: int) -> int:
    """K19d's launches of a cycle's descent (and of its ascent) over ``L``
    smoothed levels with a smoother of ``steps`` steps after its start: the
    smoother's ``steps`` launches (its start folded into the first) and one
    fused transfer a level.  A cycle makes twice that, 6 a level at degree
    3, besides K19c's coarsest solve."""
    return L * (steps + 1)


class Cycle:
    """The smoothed levels of a 1-D V-cycle on one CUDA device, checked at
    construction: ``levels`` (:class:`Level`, each of ``(m + 1) // 2`` the
    rows of the one before), the smoother's start ``theta`` and step
    coefficients ``coeffs`` (:func:`..ops.krylov.chebyshev_coefficients`,
    1..:data:`MAX_STEPS` pairs), the overcorrection.

    Raises ``ValueError`` for 0 or more than :data:`MAX_LEVELS` levels, more
    than :data:`MAX_CLASSES` classes or offsets that do not ascend, weights,
    diagonals and scalings that are not contiguous float64 tensors of the
    level's shape on the first level's CUDA device, or rows that do not
    halve (rounded up) level by level.  Each calling stream gets its own
    scratch (the levels' right-hand sides, iterates and smoother vectors,
    one buffer of ``8·Σ m + m_bottom`` float64), made at its first call and
    kept for the cycle's life, so cycles on two streams run side by side.
    A cycle is ``rb = down(r)``, the coarsest solve ``e = A⁻¹ rb`` (the
    caller's), ``z = up(r, e)``: 3 host calls and :attr:`sweep_launches`
    launches each way; ``rb`` is scratch of the stream, valid until its
    next :meth:`down`."""

    __slots__ = ("levels", "sizes", "m_bottom", "index", "sweep_launches", "_base", "_scratch")

    def __init__(self, levels, theta: float, coeffs, overcorrect: float):
        levels = tuple(levels)
        coeffs = tuple((float(c1), float(c2)) for c1, c2 in coeffs)
        L = len(levels)
        if not 0 < L <= MAX_LEVELS or not 0 < len(coeffs) <= MAX_STEPS:
            raise ValueError(f"mg1d: a cycle takes 1..{MAX_LEVELS} levels and 1..{MAX_STEPS} "
                             f"smoother steps")
        dev = levels[0].diag.device
        checked, m = [], None
        for lev in levels:
            checked.append(_check_level(lev, dev, m))
            m = (checked[-1][1] + 1) // 2
        if dev.type != "cuda":
            raise ValueError("mg1d: a cycle's levels must be on a CUDA device")
        base = _CycleArgs()
        for l, (lev, (offsets, rows)) in enumerate(zip(levels, checked)):
            _pack(lev, offsets, rows, base.lv[l])
        self.levels, self.sizes, self.m_bottom = levels, [rows for _, rows in checked], m
        self.index = dev.index
        self.sweep_launches = sweep_launches(L, len(coeffs))
        base.L, base.steps, base.m_bottom = L, len(coeffs), m
        base.inv_theta, base.oc = 1.0 / float(theta), float(overcorrect)
        for t, (c1, c2) in enumerate(coeffs):
            base.c1[t], base.c2[t] = c1, c2
        self._base = base
        self._scratch = {}  # {raw stream handle: (address, args, buffer, rb)}

    def _args(self, stream: int):
        """The cycle's arguments on CUDA stream ``stream``, with its scratch:
        eight vectors a level and the coarsest rhs."""
        entry = self._scratch.get(stream)
        if entry is None:
            total = sum(self.sizes)
            buf = torch.empty(8 * total + self.m_bottom, dtype=torch.float64,
                              device=self.levels[0].diag.device)
            args = _CycleArgs.from_buffer_copy(self._base)
            at = buf.data_ptr()
            for l, m in enumerate(self.sizes):
                lv = args.lv[l]
                for name in ("r", "x", "xp", "res", "rs", "dvec", "xa", "xb"):
                    setattr(lv, name, at)
                    at += 8 * m
            rb = buf[8 * total:]
            args.r_bottom = rb.data_ptr()
            entry = self._scratch[stream] = (ctypes.addressof(args), args, buf, rb)
        return entry

    def down(self, r: torch.Tensor) -> torch.Tensor:
        """The descent from ``r``: per level the smoother and the restricted
        residual; returns the coarsest right-hand side (scratch)."""
        index = self.index
        build.require_vectors("mg1d", index, (r, self.sizes[0]))
        stream = build.raw_stream(index)
        addr, _, _, rb = self._args(stream)
        code = build.on_device(index, build.library().nxfx_mg1d_down, addr, r.data_ptr(), stream)
        build.check(code, "mg1d")
        LAUNCHES.launches += self.sweep_launches
        return rb

    def up(self, r: torch.Tensor, e_bottom: torch.Tensor) -> torch.Tensor:
        """The ascent from the coarsest correction ``e_bottom`` (``r`` the
        descent's): per level the prolonged iterate with its residual and the
        post-smoother; returns the cycle's result, a new vector."""
        index = self.index
        build.require_vectors("mg1d", index, (r, self.sizes[0]), (e_bottom, self.m_bottom))
        stream = build.raw_stream(index)
        addr = self._args(stream)[0]
        out = r.new_empty(self.sizes[0])
        code = build.on_device(index, build.library().nxfx_mg1d_up, addr, r.data_ptr(),
                               e_bottom.data_ptr(), out.data_ptr(), stream)
        build.check(code, "mg1d")
        LAUNCHES.launches += self.sweep_launches
        return out
