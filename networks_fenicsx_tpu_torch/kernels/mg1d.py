"""K19d: the 1-D pairwise-aggregation multigrid V-cycle (``csrc/mg1d.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_mg_preconditioner``
(``:1482-1558``) on the host plan of :func:`..multigrid._plan_mg`:

* :func:`level0` — level 0's boundary excess ``extra = diag − Σ_c w_c`` and
  Jacobi scaling ``diag^-1/2``;
* :func:`coarsen` — a coarse level's class weights through the plan's
  parity mapping (:class:`..multigrid.Mg1dLevel`, its tables uploaded once
  per executor), its ``extra`` (pair sums), diagonal and scaling;
* :func:`restrict` and :func:`prolong` — pair sums of a residual (even
  padding), and ``x += overcorrect·e[i // 2]``.

The level matvecs and smoother steps run on K18
(:func:`.shift_matvec.shift_matvec`, :func:`.shift_matvec.shift_cheb`), the
coarsest dense solve on K19c (:func:`.mg2d.coarse_factor`,
:func:`.mg2d.coarse_solve`).  Every wrapper launches its kernel for CUDA
tensors (counted in :data:`LAUNCHES`) and runs its plain version, the
reference's pads, reshapes and repeats in eager PyTorch, for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = [
    "level0", "level0_plain", "coarsen", "coarsen_plain", "restrict", "restrict_plain", "prolong",
    "prolong_plain", "LAUNCHES",
]

LAUNCHES = build.Counter("mg1d")


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


# ---------------------------------------------------------------- kernels


def _launch(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        code = getattr(build.library(), name)(*args, build.stream_handle(device))
    build.check(code, "mg1d")
    LAUNCHES.launches += 1


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


def restrict(res, mc: int) -> torch.Tensor:
    """Pair sums ``res[2I] + res[2I + 1]`` (0 past the end)."""
    if res.device.type == "cpu":
        return restrict_plain(res, mc)
    m = res.shape[0]
    _check(m, res)
    if mc != (m + 1) // 2:
        raise ValueError("mg1d: mc must be (m + 1) // 2")
    rc = torch.empty(mc, dtype=torch.float64, device=res.device)
    _launch("nxfx_mg1d_restrict", res.device, m, mc, res.data_ptr(), rc.data_ptr())
    return rc


def prolong(x, ec, overcorrect: float) -> None:
    """``x += overcorrect·e[i // 2]``, in place."""
    if x.device.type == "cpu":
        return prolong_plain(x, ec, overcorrect)
    m = x.shape[0]
    _check(m, x)
    _check((m + 1) // 2, ec)
    _launch("nxfx_mg1d_prolong", x.device, m, x.data_ptr(), ec.data_ptr(), float(overcorrect))
