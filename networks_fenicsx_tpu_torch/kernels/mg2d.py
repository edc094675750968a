"""K19c: the 2-D aggregation multigrid V-cycle of lattice λ systems, and the
coarsest dense solve it shares with K19d (``csrc/mg2d.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_mg2d_preconditioner``
(``:1315-1438``).  A level is an ``(ny, nx)`` grid held as one ``(7, ny·nx)``
float64 tensor of :data:`FIELDS`: the direction weights E (+1), W (−1), S
(+nx), N (−nx), the boundary excess ``extra``, the diagonal (1.0 in padded
cells) and its Jacobi scaling ``diag^-1/2``.  The wrappers:

* :func:`level0` and :func:`coarsen` — the hierarchy, built once per solve
  from the class weights and the diagonal;
* :func:`stencil` — the 5-point weighted stencil ``L x`` or ``b − L x``;
* :func:`coarse_factor` and :func:`coarse_solve` — the coarsest level's
  banded matrix from its classes, its Cholesky factor (the port's tiled
  factor, ``tiled_cholesky.cuh``) and the two triangular solves per V-cycle.

The plain level loop composes :func:`cheb_plain` (one step of the level's
Chebyshev-Jacobi smoother), :func:`restrict_plain` (2×2 block sums with even
padding) and :func:`prolong_plain` (``x += overcorrect·e`` repeated over 2×2
blocks, cropped); the V-cycle's kernel path fuses them, each fusion
computing exactly what the composed plain versions compute, in their order:

* :func:`cheb_first` — the smoother's start (K19a's ``cheb_start``) folded
  into its first step;
* :func:`residual_restrict` — ``restrict(b − L x)``, the fine residual
  never stored;
* :func:`prolong_residual` — ``x' = x + overcorrect·e`` and ``b − L x'``,
  into two other buffers.

A :class:`Cycle` holds a hierarchy's smoothed levels on one CUDA device,
checked once, with a scratch of the calling stream's vectors made at its
first call; its :meth:`Cycle.down` and :meth:`Cycle.up` issue a V-cycle's
descent and ascent around the coarsest solve, 3 launches a level each way
(a smoother's two and one fused transfer), from one host call each.

Every wrapper launches its kernel for CUDA tensors (counted in
:data:`LAUNCHES`) and runs its plain version — the reference's reshapes,
pads and shifts in eager PyTorch, and ``torch.linalg.cholesky`` /
``cholesky_solve`` for the coarsest solve, as the reference calls
``jnp.linalg.cholesky`` / ``cho_solve`` — for CPU tensors.  The block sums
add in one stated order, ``((x00 + x01) + x10) + x11``, in both.  The
launches read the raw stream and enter the device only when it is not the
current one; :func:`stencil` checks its vectors in one pass.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, krylov

__all__ = [
    "level0", "level0_plain", "coarsen", "coarsen_plain", "stencil", "stencil_plain",
    "cheb_plain", "restrict_plain", "prolong_plain", "coarse_factor",
    "coarse_factor_plain", "coarse_solve", "coarse_solve_plain", "cheb_first", "cheb_first_plain",
    "residual_restrict", "residual_restrict_plain", "prolong_residual", "prolong_residual_plain",
    "Cycle", "FIELDS", "LAUNCHES", "COARSE_SOLVE_LAUNCHES",
]

FIELDS = ("E", "W", "S", "N", "extra", "diag", "dis")
FE, FW, FS, FN, FX, FD, FI = range(len(FIELDS))
MAX_CLASSES = 16
MAX_COARSE = 8192
MAX_LEVELS = 16  # MG_MAX_LEVELS in csrc/mg2d.cu
MAX_STEPS = 8  # MG_MAX_STEPS: the smoother's steps after its start
COARSE_SOLVE_LAUNCHES = 3  # device launches of a coarse_solve: a copy, two triangular solves
THREADS = 256
LAUNCHES = build.Counter("mg2d")

Shape = tuple[int, int]


# ------------------------------------------------------------------ plain


def _level(e, w, s, n, extra) -> torch.Tensor:
    d = (((extra + e) + w) + s) + n
    d = torch.where(d > 0, d, 1.0)
    return torch.stack([e, w, s, n, extra, d, 1.0 / torch.sqrt(d)])


def level0_plain(cw, dirs, diag0) -> torch.Tensor:
    zero = torch.zeros_like(diag0)
    e, w, s, n = (cw[c] if c >= 0 else zero for c in dirs)
    return _level(e, w, s, n, diag0 - (((e + w) + s) + n))


def _blocks(a: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``(ny, nx)`` → ``(ny/2, 2, nx/2, 2)`` after even padding."""
    ny, nx = shape
    a = torch.nn.functional.pad(a.reshape(ny, nx), (0, nx % 2, 0, ny % 2))
    return a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2)


def _block_sum(b: torch.Tensor) -> torch.Tensor:
    return ((b[:, 0, :, 0] + b[:, 0, :, 1]) + b[:, 1, :, 0]) + b[:, 1, :, 1]


def coarsen_plain(lev, shape_f: Shape, shape_c: Shape) -> torch.Tensor:
    bE, bW, bS, bN, bX = (_blocks(lev[f], shape_f) for f in (FE, FW, FS, FN, FX))
    return _level(
        (bE[:, 0, :, 1] + bE[:, 1, :, 1]).reshape(-1),
        (bW[:, 0, :, 0] + bW[:, 1, :, 0]).reshape(-1),
        (bS[:, 1, :, 0] + bS[:, 1, :, 1]).reshape(-1),
        (bN[:, 0, :, 0] + bN[:, 0, :, 1]).reshape(-1),
        _block_sum(bX).reshape(-1),
    )


def _shift2(v: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[i, j] = v[i + dy, j + dx]``, 0 outside."""
    ny, nx = v.shape
    out = torch.zeros_like(v)
    out[max(-dy, 0): ny - max(dy, 0), max(-dx, 0): nx - max(dx, 0)] = \
        v[max(dy, 0): ny + min(dy, 0), max(dx, 0): nx + min(dx, 0)]
    return out


def _stencil(lev, shape: Shape, y) -> torch.Tensor:
    v = y.reshape(shape)
    e, w, s, n, _, d, _ = (f.reshape(shape) for f in lev)
    out = d * v - e * _shift2(v, 0, 1) - w * _shift2(v, 0, -1) - s * _shift2(v, 1, 0) \
        - n * _shift2(v, -1, 0)
    return out.reshape(-1)


def stencil_plain(lev, shape: Shape, x, b=None) -> torch.Tensor:
    out = _stencil(lev, shape, x)
    return out if b is None else b - out


def cheb_plain(lev, shape: Shape, rs, dvec, x_in, x_out, c1: float, c2: float, z=None,
               base=None) -> None:
    s = lev[FI]
    mv = s * _stencil(lev, shape, s * x_in)
    dv = c1 * dvec + c2 * (rs - mv)
    dvec.copy_(dv)
    xn = x_in + dv
    x_out.copy_(xn)
    if z is not None:
        z.copy_(s * xn if base is None else base + s * xn)


def restrict_plain(res, shape_f: Shape, shape_c: Shape) -> torch.Tensor:
    del shape_c
    return _block_sum(_blocks(res, shape_f)).reshape(-1)


def prolong_plain(x, shape_f: Shape, shape_c: Shape, ec, overcorrect: float) -> None:
    ny, nx = shape_f
    up = ec.reshape(shape_c).repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:ny, :nx]
    x.copy_(x + overcorrect * up.reshape(-1))


def _banded(offsets, cw, diag) -> torch.Tensor:
    Lc = torch.diag(diag)
    m = diag.shape[0]
    for c, d in enumerate(np.asarray(offsets).tolist()):
        d = int(d)
        Lc = Lc - (torch.diag(cw[c][: m - d], d) if d > 0 else torch.diag(cw[c][-d:], d))
    return Lc


def coarse_factor_plain(offsets, cw, diag) -> torch.Tensor:
    """The Cholesky factor of the coarsest banded matrix (lower)."""
    return torch.linalg.cholesky(_banded(offsets, cw, diag))


def coarse_solve_plain(factor, r) -> torch.Tensor:
    return torch.cholesky_solve(r[:, None], factor)[:, 0]


def cheb_first_plain(lev, shape: Shape, r, theta: float, rs, dvec, x_out, c1: float, c2: float,
                     z=None, base=None) -> None:
    """The composed version: K19a's ``cheb_start_plain`` with the level's
    scaling into ``rs``, ``dvec`` and a start ``x``, then :func:`cheb_plain`."""
    x = torch.empty_like(r)
    krylov.cheb_start_plain(lev[FI], r, theta, rs, dvec, x)
    cheb_plain(lev, shape, rs, dvec, x, x_out, c1, c2, z, base)


def residual_restrict_plain(lev, shape_f: Shape, shape_c: Shape, x, b) -> torch.Tensor:
    """The composed version: ``restrict(b − L x)``."""
    return restrict_plain(stencil_plain(lev, shape_f, x, b), shape_f, shape_c)


def prolong_residual_plain(lev, shape_f: Shape, shape_c: Shape, x, ec, overcorrect: float, b):
    """The composed version: ``(x', b − L x')`` with ``x'`` the prolonged
    copy of ``x`` (which is not modified)."""
    xp = x.clone()
    prolong_plain(xp, shape_f, shape_c, ec, overcorrect)
    return xp, stencil_plain(lev, shape_f, xp, b)


# ---------------------------------------------------------------- kernels


def _launch(name: str, device, *args) -> None:
    index = device.index
    code = build.on_device(index, getattr(build.library(), name), *args, build.raw_stream(index))
    build.check(code, "mg2d")
    LAUNCHES.launches += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, m: int, *vecs, lev=None):
    build.require_cuda(name, *vecs, *(() if lev is None else (lev,)))
    if any(tuple(v.shape) != (m,) for v in vecs):
        raise ValueError(f"{name}: vectors must be ({m},)")
    if lev is not None and tuple(lev.shape) != (len(FIELDS), m):
        raise ValueError(f"{name}: a level must be ({len(FIELDS)}, {m})")


def level0(cw, dirs, diag0) -> torch.Tensor:
    """Level 0 from the ``(C, B)`` class weights, the class index of each
    direction E, W, S, N (−1 when absent) and the diagonal."""
    if diag0.device.type == "cpu":
        return level0_plain(cw, dirs, diag0)
    m = diag0.shape[0]
    _check("mg2d", m, diag0)
    build.require_cuda("mg2d", cw)
    if cw.dim() != 2 or cw.shape[1] != m or max(dirs) >= cw.shape[0]:
        raise ValueError("mg2d: cw must be (C, B) and hold the named classes")
    lev = torch.empty((len(FIELDS), m), dtype=torch.float64, device=diag0.device)
    _launch("nxfx_mg2d_level0", diag0.device, m, cw.data_ptr(), *(int(c) for c in dirs),
            diag0.data_ptr(), lev.data_ptr())
    return lev


def coarsen(lev, shape_f: Shape, shape_c: Shape) -> torch.Tensor:
    """The next level: 2×2 aggregation of ``lev``."""
    if lev.device.type == "cpu":
        return coarsen_plain(lev, shape_f, shape_c)
    _check("mg2d", shape_f[0] * shape_f[1], lev=lev)
    if shape_c != ((shape_f[0] + 1) // 2, (shape_f[1] + 1) // 2):
        raise ValueError("mg2d: the coarse shape halves the fine one, rounded up")
    out = torch.empty((len(FIELDS), shape_c[0] * shape_c[1]), dtype=torch.float64, device=lev.device)
    _launch("nxfx_mg2d_coarsen", lev.device, *shape_f, lev.data_ptr(), *shape_c, out.data_ptr())
    return out


def _require_level(name: str, lev, m: int, index: int) -> None:
    """A level on CUDA device ``index``: a contiguous ``(7, m)`` float64 tensor."""
    if (not lev.is_cuda or lev.get_device() != index or lev.dtype is not torch.float64
            or not lev.is_contiguous() or lev.shape != (len(FIELDS), m)):
        raise ValueError(f"{name}: a level must be a contiguous ({len(FIELDS)}, {m}) float64 tensor "
                         f"on CUDA device {index}")


def stencil(lev, shape: Shape, x, b=None) -> torch.Tensor:
    """``L x`` of the level, or ``b − L x`` when ``b`` is given."""
    if x.device.type == "cpu":
        return stencil_plain(lev, shape, x, b)
    m = shape[0] * shape[1]
    index = x.get_device()
    build.require_vectors("mg2d", index, (x, m), *(() if b is None else ((b, m),)))
    _require_level("mg2d", lev, m, index)
    out = x.new_empty(m)
    code = build.on_device(index, build.library().nxfx_mg2d_stencil, shape[0], shape[1],
                           lev.data_ptr(), x.data_ptr(), _ptr(b), out.data_ptr(),
                           build.raw_stream(index))
    build.check(code, "mg2d")
    LAUNCHES.launches += 1
    return out


def cheb_first(lev, shape: Shape, r, theta: float, rs, dvec, x_out, c1: float, c2: float, z=None,
               base=None) -> None:
    """The smoother's start folded into its first step: ``rs``, ``dvec``,
    ``x_out`` and, when it is also the last step, ``z``.  The start is
    ``rs·(1/θ)``, ``1/θ`` taken on the host: what PyTorch computes for
    ``rs / θ`` on the card, so the kernel equals :func:`cheb_first_plain` to
    the bit there."""
    if r.device.type == "cpu":
        return cheb_first_plain(lev, shape, r, theta, rs, dvec, x_out, c1, c2, z, base)
    m = shape[0] * shape[1]
    _check("mg2d", m, r, rs, dvec, x_out, *(t for t in (z, base) if t is not None), lev=lev)
    _launch("nxfx_mg2d_cheb_first", r.device, *shape, lev.data_ptr(), r.data_ptr(), 1.0 / float(theta),
            float(c1), float(c2), rs.data_ptr(), dvec.data_ptr(), x_out.data_ptr(), _ptr(z),
            _ptr(base))


def residual_restrict(lev, shape_f: Shape, shape_c: Shape, x, b) -> torch.Tensor:
    """``restrict(b − L x)`` in one launch."""
    if x.device.type == "cpu":
        return residual_restrict_plain(lev, shape_f, shape_c, x, b)
    _check("mg2d", shape_f[0] * shape_f[1], x, b, lev=lev)
    if shape_c != ((shape_f[0] + 1) // 2, (shape_f[1] + 1) // 2):
        raise ValueError("mg2d: the coarse shape halves the fine one, rounded up")
    rc = x.new_empty(shape_c[0] * shape_c[1])
    _launch("nxfx_mg2d_residual_restrict", x.device, *shape_f, lev.data_ptr(), x.data_ptr(),
            b.data_ptr(), *shape_c, rc.data_ptr())
    return rc


def prolong_residual(lev, shape_f: Shape, shape_c: Shape, x, ec, overcorrect: float, b):
    """``(x', b − L x')`` with ``x' = x + overcorrect·e`` repeated over 2×2
    blocks, in one launch (``x`` is not modified)."""
    if x.device.type == "cpu":
        return prolong_residual_plain(lev, shape_f, shape_c, x, ec, overcorrect, b)
    _check("mg2d", shape_f[0] * shape_f[1], x, b, lev=lev)
    _check("mg2d", shape_c[0] * shape_c[1], ec)
    if shape_c != ((shape_f[0] + 1) // 2, (shape_f[1] + 1) // 2):
        raise ValueError("mg2d: the coarse shape halves the fine one, rounded up")
    xp, res = x.new_empty(x.shape[0]), x.new_empty(x.shape[0])
    _launch("nxfx_mg2d_prolong_residual", x.device, *shape_f, lev.data_ptr(), x.data_ptr(), shape_c[1],
            ec.data_ptr(), float(overcorrect), b.data_ptr(), xp.data_ptr(), res.data_ptr())
    return xp, res


def coarse_factor(offsets, cw, diag) -> torch.Tensor:
    """The coarsest banded matrix ``diag(diag) − Σ_c band(cw[c], d_c)``
    factored: an ``(m, m)`` buffer whose lower triangle is the Cholesky
    factor (the strict upper triangle of its 64×64 diagonal tiles holds their
    inverses, which :func:`coarse_solve` reads)."""
    if diag.device.type == "cpu":
        return coarse_factor_plain(offsets, cw, diag)
    m = diag.shape[0]
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    C = offsets.shape[0]
    _check("mg2d", m, diag)
    build.require_cuda("mg2d", cw)
    if C > MAX_CLASSES or tuple(cw.shape) != (C, m) or m > MAX_COARSE:
        raise ValueError(f"mg2d: at most {MAX_CLASSES} classes, cw (C, m), m <= {MAX_COARSE}")
    A = torch.empty((m, m), dtype=torch.float64, device=diag.device)
    _launch("nxfx_mg_coarse_factor", diag.device, m, C, offsets.ctypes.data, cw.data_ptr(),
            diag.data_ptr(), A.data_ptr())
    return A


def coarse_solve(factor, r) -> torch.Tensor:
    """``A⁻¹ r`` on :func:`coarse_factor`'s factor."""
    if r.device.type == "cpu":
        return coarse_solve_plain(factor, r)
    m = r.shape[0]
    _check("mg2d", m, r)
    build.require_cuda("mg2d", factor)
    if tuple(factor.shape) != (m, m):
        raise ValueError("mg2d: the factor must be (m, m)")
    v, y, x = (torch.empty_like(r) for _ in range(3))
    _launch("nxfx_mg_coarse_solve", r.device, m, factor.data_ptr(), r.data_ptr(), v.data_ptr(),
            y.data_ptr(), x.data_ptr())
    return x


# ------------------------------------------------------------- the cycle


class _LevelArgs(ctypes.Structure):
    """``Mg2dLevelArgs`` of ``csrc/mg2d.cu``."""

    _fields_ = [("ny", ctypes.c_int), ("nx", ctypes.c_int)] + [
        (name, ctypes.c_void_p) for name in ("lev", "r", "x", "xp", "res", "rs", "dvec", "xa", "xb")]


class _CycleArgs(ctypes.Structure):
    """``Mg2dCycle`` of ``csrc/mg2d.cu``."""

    _fields_ = [("L", ctypes.c_int), ("steps", ctypes.c_int), ("ny_bottom", ctypes.c_int),
                ("nx_bottom", ctypes.c_int), ("inv_theta", ctypes.c_double), ("oc", ctypes.c_double),
                ("c1", ctypes.c_double * MAX_STEPS), ("c2", ctypes.c_double * MAX_STEPS),
                ("r_bottom", ctypes.c_void_p), ("lv", _LevelArgs * MAX_LEVELS)]


class Cycle:
    """The smoothed levels of a 2-D V-cycle on one CUDA device, checked at
    construction: ``levels`` the ``(7, ny·nx)`` fields of each ``shapes``
    entry, ``bottom`` the coarsest shape, the smoother's start ``theta`` and
    step coefficients ``coeffs`` (:func:`..ops.krylov.chebyshev_coefficients`,
    1..:data:`MAX_STEPS` pairs), the overcorrection.

    Raises ``ValueError`` for 0 or more than :data:`MAX_LEVELS` levels, a
    level that is not a contiguous float64 tensor of its shape on the first
    level's CUDA device, or shapes that do not halve (rounded up) level by
    level down to ``bottom``.  Each calling stream gets its own scratch (the
    levels' right-hand sides, iterates and smoother vectors, one buffer),
    made at its first call, so cycles on two streams run side by side.
    A scratch is ``8·Σ ny·nx + ny_bottom·nx_bottom`` float64 (about 22 MB
    for the 512² hierarchy) and is kept for the cycle's life: one for each
    stream that ever called it.
    A cycle is ``rb = down(r)``, the coarsest solve ``e = A⁻¹ rb`` (the
    caller's), ``z = up(r, e)``; ``rb`` is scratch of the stream, valid
    until its next :meth:`down`."""

    __slots__ = ("levels", "shapes", "bottom", "index", "sweep_launches", "_base", "_scratch")

    def __init__(self, levels, shapes, bottom, theta: float, coeffs, overcorrect: float):
        levels = tuple(levels)
        shapes = tuple((int(ny), int(nx)) for ny, nx in shapes)
        bottom = (int(bottom[0]), int(bottom[1]))
        coeffs = tuple((float(c1), float(c2)) for c1, c2 in coeffs)
        L = len(levels)
        if not 0 < L <= MAX_LEVELS or len(shapes) != L or not 0 < len(coeffs) <= MAX_STEPS:
            raise ValueError(f"mg2d: a cycle takes 1..{MAX_LEVELS} levels and 1..{MAX_STEPS} "
                             f"smoother steps")
        dev = levels[0].device
        if dev.type != "cuda":
            raise ValueError("mg2d: a cycle's levels must be on a CUDA device")
        for lev, (ny, nx), (nyc, nxc) in zip(levels, shapes, shapes[1:] + (bottom,)):
            if (lev.device != dev or lev.dtype != torch.float64 or not lev.is_contiguous()
                    or tuple(lev.shape) != (len(FIELDS), ny * nx)):
                raise ValueError(f"mg2d: a level of shape {(ny, nx)} must be a contiguous "
                                 f"({len(FIELDS)}, {ny * nx}) float64 tensor on {dev}")
            if (nyc, nxc) != ((ny + 1) // 2, (nx + 1) // 2) or ny * nx >= 2**31 - THREADS:
                raise ValueError("mg2d: each coarse shape halves the fine one, rounded up")
        self.levels, self.shapes, self.bottom = levels, shapes, bottom
        self.index = dev.index
        self.sweep_launches = L * (len(coeffs) + 1)  # a smoother's and a transfer a level
        base = _CycleArgs()
        base.L, base.steps, base.ny_bottom, base.nx_bottom = L, len(coeffs), *bottom
        base.inv_theta, base.oc = 1.0 / float(theta), float(overcorrect)
        for t, (c1, c2) in enumerate(coeffs):
            base.c1[t], base.c2[t] = c1, c2
        for l, (lev, (ny, nx)) in enumerate(zip(levels, shapes)):
            base.lv[l].ny, base.lv[l].nx, base.lv[l].lev = ny, nx, lev.data_ptr()
        self._base = base
        self._scratch = {}  # {raw stream handle: (address, args, buffer, rb)}

    def _args(self, stream: int):
        """The cycle's arguments on CUDA stream ``stream``, with its scratch:
        eight vectors a level (seven at level 0) and the coarsest rhs."""
        entry = self._scratch.get(stream)
        if entry is None:
            sizes = [ny * nx for ny, nx in self.shapes]
            mb = self.bottom[0] * self.bottom[1]
            buf = torch.empty(8 * sum(sizes) + mb, dtype=torch.float64, device=self.levels[0].device)
            args = _CycleArgs.from_buffer_copy(self._base)
            at = buf.data_ptr()
            for l, m in enumerate(sizes):
                lv = args.lv[l]
                for name in ("r", "x", "xp", "res", "rs", "dvec", "xa", "xb"):
                    setattr(lv, name, at)
                    at += 8 * m
            rb = buf[8 * sum(sizes):]
            args.r_bottom = rb.data_ptr()
            entry = self._scratch[stream] = (ctypes.addressof(args), args, buf, rb)
        return entry

    def down(self, r: torch.Tensor) -> torch.Tensor:
        """The descent from ``r``: per level the smoother and the restricted
        residual; returns the coarsest right-hand side (scratch)."""
        index, (ny, nx) = self.index, self.shapes[0]
        build.require_vectors("mg2d", index, (r, ny * nx))
        stream = build.raw_stream(index)
        addr, _, _, rb = self._args(stream)
        code = build.on_device(index, build.library().nxfx_mg2d_down, addr, r.data_ptr(), stream)
        build.check(code, "mg2d")
        LAUNCHES.launches += self.sweep_launches
        return rb

    def up(self, r: torch.Tensor, e_bottom: torch.Tensor) -> torch.Tensor:
        """The ascent from the coarsest correction ``e_bottom`` (``r`` the
        descent's): per level the prolonged iterate with its residual and the
        post-smoother; returns the cycle's result, a new vector."""
        index, (ny, nx) = self.index, self.shapes[0]
        build.require_vectors("mg2d", index, (r, ny * nx), (e_bottom, self.bottom[0] * self.bottom[1]))
        stream = build.raw_stream(index)
        addr = self._args(stream)[0]
        out = r.new_empty(ny * nx)
        code = build.on_device(index, build.library().nxfx_mg2d_up, addr, r.data_ptr(),
                               e_bottom.data_ptr(), out.data_ptr(), stream)
        build.check(code, "mg2d")
        LAUNCHES.launches += self.sweep_launches
        return out
