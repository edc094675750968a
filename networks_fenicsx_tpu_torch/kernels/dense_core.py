"""K11: the dense solve of a small cycle core (``csrc/dense_core.cu``).

Replaces ``networks_fenicsx_tpu/ops/mixed_precision.py:scaled_cholesky_factor``
and ``scaled_cholesky_solve`` (``:34-69``) on the core the reference
assembles in ``_tree_eliminate_factor`` (``:3729-3743``): ``Lc`` from the
peeled diagonal ``dc`` and the core pairs' conductances, Jacobi scaling, a
Cholesky factor, the pivot gate (``min pivot > 1e-7·max pivot``, all
finite), the solve and ``n_refine`` refinement passes against ``Lc``
(three, the reference's ``_N_REFINE``), and NaN everywhere when the gate
trips.  ``n_refine`` is an argument of the kernel and of the plain version
alike, as of ``scaled_cholesky_solve``: the checks on the card set it to 0
to hold the unrefined solve, which refinement would otherwise hide.

The reference factors in float32 and refines in float64 because float64
Cholesky is emulated on the TPU; the port factors in float64 (kernel and
plain version alike) and keeps the gate and the refinement passes.

:func:`dense_core` launches the kernel for CUDA tensors (a core of at most
512 nodes, one thread block) and runs :func:`dense_core_plain` for CPU
tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["dense_core", "dense_core_plain", "MAX_CORE", "PIVOT_RTOL", "N_REFINE"]

MAX_CORE = 512
PIVOT_RTOL = 1e-7
N_REFINE = 3


def assemble_core(ci, cj, pid, dc: torch.Tensor, w_pairs: torch.Tensor) -> torch.Tensor:
    """``Lc``: ``diag(dc)`` with ``−w_pairs[pid]`` at ``(ci, cj)`` and ``(cj, ci)``."""
    n = dc.shape[0]
    Lc = torch.zeros((n, n), dtype=torch.float64, device=dc.device)
    ar = torch.arange(n, device=dc.device)
    Lc[ar, ar] = dc
    if ci.shape[0]:
        wv = w_pairs[pid.long()]
        Lc[ci.long(), cj.long()] = -wv
        Lc[cj.long(), ci.long()] = -wv
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
    """K11 on ``dc``'s device.  ``ci``, ``cj``, ``pid`` ``(P0,)`` int32 are the
    core pairs (core ranks, pair id); ``dc``, ``rc`` ``(n,)`` the core's
    peeled diagonal and rhs; ``w_pairs`` ``(P,)`` the pair conductances."""
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
    x = torch.empty(n, dtype=dt, device=dev)
    ok = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_dense_core(
            n, ci.shape[0], n_refine, ci.data_ptr(), cj.data_ptr(), pid.data_ptr(),
            w_pairs.data_ptr(), dc.data_ptr(), rc.data_ptr(), Lc.data_ptr(), C.data_ptr(),
            x.data_ptr(), ok.data_ptr(), build.stream_handle(dev),
        )
    build.check(code, "dense_core")
    dense_core.launches += 1
    return x


dense_core.launches = 0
