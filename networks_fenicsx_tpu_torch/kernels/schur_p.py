"""K21a: the per-edge flux blocks of the continuous-pressure reduced solve
(``csrc/schur_p.cu``).

Replaces the ``A_blocks`` assembly, ``jnp.linalg.cholesky`` and
``apply_Ainv`` of ``networks_fenicsx_tpu/solver.py:_continuous_pressure_solve``
(``:4666-4685``, ``:4718-4724``).  Edge ``e``'s flux block is the sum of its
``N`` overlapping ``(k+1)²`` cell masses, an ``(m, m)`` SPD band of half
bandwidth ``k`` (``m = kN + 1``); its Cholesky factor keeps the band, stored
as ``Lb (m, k+1, E)`` with ``Lb[i, d, e] = L_e[i, i−d]``.

* :func:`schur_p_factor` — the band from the cell masses ``(E·N, k+1,
  k+1)``, its diagonal written into ``adiag`` at the edge's global flux
  dofs ``base[e] + i`` (``adiag`` is the flux block's diagonal, the
  reference's ``A_diag``), then the band Cholesky;
* :func:`schur_p_solve` — ``A⁻¹ v`` on the flux dofs, forward then back
  substitution per edge, in and out at ``base[e] + i`` (for ``k ≤ 4``
  through a scratch ``(m, E)``).

Both run one thread an edge on the card (counted in :data:`FACTOR` and
:data:`SOLVE`) and their plain versions, the same loops vectorised over the
edges, for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["schur_p_factor", "schur_p_factor_plain", "schur_p_solve", "schur_p_solve_plain",
           "FACTOR", "SOLVE"]

FACTOR = build.Counter("schur_p_factor")
SOLVE = build.Counter("schur_p_solve")
WINDOW_MAX_K = 4  # the solve keeps its last k values in registers up to this degree


def _dof_table(base: torch.Tensor, m: int) -> torch.Tensor:
    """``(m, E)`` global flux dof of local dof ``i`` of edge ``e``."""
    return base.long()[None, :] + torch.arange(m, device=base.device)[:, None]


def schur_p_factor_plain(cm, base, N: int, k: int, n_flux: int):
    """Eager version: ``(Lb (m, k+1, E), adiag (n_flux,))``."""
    E = base.shape[0]
    m, kk = k * N + 1, k + 1
    dt, dev = torch.float64, cm.device
    Lb = torch.zeros((m, kk, E), dtype=dt, device=dev)
    cmv = cm.reshape(E, N, kk, kk)
    for j in range(N):
        for a in range(kk):
            for b in range(a + 1):
                Lb[k * j + a, a - b] = Lb[k * j + a, a - b] + cmv[:, j, a, b]
    adiag = torch.zeros(n_flux, dtype=dt, device=dev)
    adiag[_dof_table(base, m)] = Lb[:, 0]
    for i in range(m):
        t0 = max(0, i - k)
        for j in range(t0, i):
            s = Lb[i, i - j]
            for t in range(t0, j):
                s = s - Lb[i, i - t] * Lb[j, j - t]
            Lb[i, i - j] = s / Lb[j, 0]
        s = Lb[i, 0]
        for t in range(t0, i):
            s = s - Lb[i, i - t] * Lb[i, i - t]
        Lb[i, 0] = torch.sqrt(s)
    return Lb, adiag


def schur_p_solve_plain(Lb, base, N: int, k: int, v) -> torch.Tensor:
    m = k * N + 1
    dofs = _dof_table(base, m)
    rhs = v[dofs]
    x = torch.empty_like(rhs)
    for i in range(m):
        s = rhs[i]
        for t in range(max(0, i - k), i):
            s = s - Lb[i, i - t] * x[t]
        x[i] = s / Lb[i, 0]
    for i in range(m - 1, -1, -1):
        s = x[i]
        for t in range(i + 1, min(m - 1, i + k) + 1):
            s = s - Lb[t, t - i] * x[t]
        x[i] = s / Lb[i, 0]
    out = torch.zeros_like(v)
    out[dofs] = x
    return out


def _check(name: str, base, N: int, k: int, *tensors) -> None:
    build.require_cuda(name, *tensors)
    build.require_cuda(name, base, dtype=torch.int32)
    if N <= 0 or k <= 0 or base.dim() != 1:
        raise ValueError(f"{name}: N and k must be positive and base (E,)")


def schur_p_factor(cm, base, N: int, k: int, n_flux: int):
    """K21a's factor on ``cm``'s device: ``cm (E·N, k+1, k+1)`` float64
    cell masses, ``base (E,)`` int32 first flux dof of each edge; returns
    ``(Lb, adiag)``."""
    if cm.device.type == "cpu":
        return schur_p_factor_plain(cm, base, N, k, n_flux)
    _check("schur_p_factor", base, N, k, cm)
    E = base.shape[0]
    if cm.shape != (E * N, k + 1, k + 1):
        raise ValueError("schur_p_factor: cm must be (E·N, k+1, k+1)")
    m = k * N + 1
    Lb = torch.empty((m, k + 1, E), dtype=torch.float64, device=cm.device)
    adiag = torch.zeros(n_flux, dtype=torch.float64, device=cm.device)
    if E:
        with torch.cuda.device(cm.device):
            code = build.library().nxfx_schur_p_factor(
                E, N, k, cm.data_ptr(), base.data_ptr(), Lb.data_ptr(), adiag.data_ptr(),
                build.stream_handle(cm.device),
            )
        build.check(code, "schur_p_factor")
        FACTOR.launches += 1
    return Lb, adiag


def schur_p_solve(Lb, base, N: int, k: int, v) -> torch.Tensor:
    """K21a's solve: ``A⁻¹ v`` for the flux vector ``v (n_flux,)``."""
    if v.device.type == "cpu":
        return schur_p_solve_plain(Lb, base, N, k, v)
    _check("schur_p_solve", base, N, k, Lb, v)
    E = base.shape[0]
    if Lb.shape != (k * N + 1, k + 1, E) or v.dim() != 1:
        raise ValueError("schur_p_solve: Lb must be (kN+1, k+1, E) and v a vector")
    out = torch.empty_like(v)
    scratch = torch.empty((k * N + 1, E) if k <= WINDOW_MAX_K else 0, dtype=torch.float64,
                          device=v.device)
    if E:
        with torch.cuda.device(v.device):
            code = build.library().nxfx_schur_p_solve(
                E, N, k, Lb.data_ptr(), base.data_ptr(), v.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), build.stream_handle(v.device),
            )
        build.check(code, "schur_p_solve")
        SOLVE.launches += 1
    return out
