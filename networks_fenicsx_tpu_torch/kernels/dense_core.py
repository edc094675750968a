"""K11: the dense solve of a cycle core or a dense tail (``csrc/dense_core.cu``).

Replaces ``networks_fenicsx_tpu/ops/mixed_precision.py:scaled_cholesky_factor``
and ``scaled_cholesky_solve`` (``:34-69``) on the two matrices the reference
hands them: the cycle core of ``_tree_eliminate_factor`` (``:3729-3743``),
``Lc`` from the peeled diagonal ``dc`` and ``−w_pairs[pid]`` at the core
pairs, and the dense tail of the min-degree elimination
(``ops/core_elim.py:_core_factor``, ``:977-991``), whose negated pair values
are given with ``pid = 0, 1, …``.  Then Jacobi scaling, a Cholesky factor, the pivot gate
(``min pivot > 1e-7·max pivot``, all finite), the solve and ``n_refine``
refinement passes against ``Lc`` (three, the reference's ``_N_REFINE``), and
NaN everywhere when the gate trips.  ``n_refine`` is an argument of the
kernel and of the plain version alike, as of ``scaled_cholesky_solve``: the
checks on the card set it to 0 to hold the unrefined solve, which
refinement would otherwise hide.

The reference factors in float32 and refines in float64 because float64
Cholesky is emulated on the TPU; the port factors in float64 (kernel and
plain version alike) and keeps the gate and the refinement passes.

:func:`dense_core` launches the kernel for CUDA tensors (a tiled
multi-block factor and blocked triangular solves, any core up to
``MAX_CORE`` nodes) and runs :func:`dense_core_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = [
    "cuda_launches", "dense_core", "dense_core_plain", "dense_factor", "dense_factor_plain",
    "assemble_core", "MAX_CORE", "PIVOT_RTOL", "N_REFINE",
]

MAX_CORE = 8192
PIVOT_RTOL = 1e-7
N_REFINE = 3


def assemble_core(ci, cj, pid, dc: torch.Tensor, w_pairs: torch.Tensor) -> torch.Tensor:
    """``Lc``: ``diag(dc)`` with the pair values ``−w_pairs[pid]`` at
    ``(ci, cj)`` and ``(cj, ci)``."""
    n = dc.shape[0]
    Lc = torch.zeros((n, n), dtype=torch.float64, device=dc.device)
    ar = torch.arange(n, device=dc.device)
    Lc[ar, ar] = dc
    if ci.shape[0]:
        wv = -w_pairs[pid.long()]
        Lc[ci.long(), cj.long()] = wv
        Lc[cj.long(), ci.long()] = wv
    return Lc


def dense_core_plain(ci, cj, pid, dc, rc, w_pairs, n_refine: int = N_REFINE) -> torch.Tensor:
    """Eager version: the solution ``x (n,)`` after ``n_refine`` refinement
    passes, NaN when singular."""
    Lc = assemble_core(ci, cj, pid, dc, w_pairs)
    dscale = torch.sqrt(torch.diagonal(Lc))
    Ls = (Lc / dscale[:, None]) / dscale[None, :]
    chol, info = torch.linalg.cholesky_ex(Ls)
    piv = torch.diagonal(chol)
    ok = (info == 0) & torch.all(torch.isfinite(piv)) & (piv.min() > PIVOT_RTOL * piv.max())

    def solve_scaled(rv):
        return torch.cholesky_solve((rv / dscale)[:, None], chol)[:, 0] / dscale

    x = solve_scaled(rc)
    for _ in range(n_refine):
        x = x + solve_scaled(rc - Lc @ x)
    return torch.where(ok, x, torch.nan)


def dense_core(ci, cj, pid, dc, rc, w_pairs, n_refine: int = N_REFINE) -> torch.Tensor:
    """K11 on ``dc``'s device.  ``ci``, ``cj`` ``(P0,)`` int32 are the pairs'
    rows and columns (core ranks) and ``pid`` ``(P0,)`` int32 their pair ids
    into the conductances ``w_pairs`` ``(P,)``; ``dc``, ``rc`` ``(n,)`` the
    diagonal and the rhs."""
    if dc.device.type == "cpu":
        return dense_core_plain(ci, cj, pid, dc, rc, w_pairs, n_refine)
    build.require_cuda("dense_core", dc, rc, w_pairs)
    build.require_cuda("dense_core", ci, cj, pid, dtype=torch.int32)
    n = dc.shape[0]
    if n > MAX_CORE or tuple(rc.shape) != (n,) or n_refine < 0:
        raise ValueError(f"dense_core: the core must have at most {MAX_CORE} nodes, rc (n,), "
                         "n_refine >= 0")
    dev, dt = dc.device, torch.float64
    Lc = torch.empty((n, n), dtype=dt, device=dev)
    C = torch.empty((n, n), dtype=dt, device=dev)
    sv = torch.empty((3, n), dtype=dt, device=dev)
    x = torch.empty(n, dtype=dt, device=dev)
    ok = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_dense_core(
            n, ci.shape[0], n_refine, ci.data_ptr(), cj.data_ptr(), pid.data_ptr(),
            w_pairs.data_ptr(), dc.data_ptr(), rc.data_ptr(), Lc.data_ptr(), C.data_ptr(),
            sv[0].data_ptr(), sv[1].data_ptr(), sv[2].data_ptr(), x.data_ptr(), ok.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "dense_core")
    dense_core.launches += 1
    return x


dense_core.launches = 0


def dense_factor_plain(ci, cj, pid, dc, w_pairs) -> tuple:
    """Eager version of :func:`dense_factor`: ``(Lc, s, C)``, ``C`` lower
    (NaN where the factor breaks down, as the kernel's square roots give)."""
    Lc = assemble_core(ci, cj, pid, dc, w_pairs)
    s = torch.sqrt(torch.diagonal(Lc))
    chol, info = torch.linalg.cholesky_ex((Lc / s[:, None]) / s[None, :])
    if int(info):
        chol = torch.full_like(chol, torch.nan)
    return Lc, s, chol


def dense_factor(ci, cj, pid, dc, w_pairs) -> tuple:
    """K11's assembly and factor alone: ``(Lc, s, C)`` with ``s =
    sqrt(diag Lc)`` and ``C``'s lower triangle the Cholesky factor of ``Ls =
    (Lc / s_i) / s_j`` (its strict upper triangle is scratch) — what a check
    of the factor's backward error ``max|Ls − C Cᵀ|`` reads, and the factor
    of ``schur_method="dense_f64"``.  Counted with :func:`dense_core`'s
    launches; runs :func:`dense_factor_plain` for CPU tensors."""
    if dc.device.type == "cpu":
        return dense_factor_plain(ci, cj, pid, dc, w_pairs)
    build.require_cuda("dense_factor", dc, w_pairs)
    build.require_cuda("dense_factor", ci, cj, pid, dtype=torch.int32)
    n = dc.shape[0]
    if n > MAX_CORE:
        raise ValueError(f"dense_factor: the core must have at most {MAX_CORE} nodes")
    dev, dt = dc.device, torch.float64
    Lc = torch.empty((n, n), dtype=dt, device=dev)
    C = torch.empty((n, n), dtype=dt, device=dev)
    s = torch.empty(n, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_dense_factor(
            n, ci.shape[0], ci.data_ptr(), cj.data_ptr(), pid.data_ptr(), w_pairs.data_ptr(), dc.data_ptr(), Lc.data_ptr(), C.data_ptr(), s.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "dense_factor")
    dense_core.launches += 1
    return Lc, s, C


TILE = 64  # the tiled route's panel width (csrc/tiled_cholesky.cuh)


def tiled_factor_launches(m: int, w: int) -> int:
    """Launches of ``tiled_cholesky`` on the first ``w`` columns of an
    ``m x m`` block: a diagonal launch per 64 columns, a panel and a
    trailing launch where rows remain below them, and the inverse launch."""
    return sum(1 + 2 * (m - k0 - min(TILE, w - k0) > 0) for k0 in range(0, w, TILE)) + (w > 0)


def tiled_solve_launches(n: int) -> int:
    """Launches of one blocked triangular solve of order ``n``."""
    return -(-n // TILE)


def cuda_launches(n: int, P0: int, n_refine: int = N_REFINE) -> int:
    """CUDA kernel launches of one :func:`dense_core` call: the assembly (one,
    two with pairs), the factor, the gate, and per pass a residual, two
    solves and an update."""
    per_pass = 2 + 2 * tiled_solve_launches(n)
    return 1 + (P0 > 0) + tiled_factor_launches(n, n) + 1 + (1 + n_refine) * per_pass
