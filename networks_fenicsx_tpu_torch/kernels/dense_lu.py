"""K21b: the float64 dense solve (``csrc/dense_lu.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_dense_solve_f64`` (``:4763-4778``;
``jnp.linalg.solve`` on the CPU, an f32 LU with f64 refinement on the TPU)
with a float64 LU with partial pivoting on the card:

* :func:`lu_factor` — right-looking on a copy of ``A (n, n)``: per column
  the pivot (largest ``|a[i, k]|``, the lowest row on ties, as LAPACK's
  ``idamax``), the row swap, the column times ``1/a[k, k]`` and the rank-1
  update of the trailing block; returns ``(LU, piv)``, ``piv[k]`` the row
  swapped with row ``k`` at step ``k`` (0-based, as ``scipy.linalg.lu_factor``);
* :func:`lu_solve` — the swaps on ``b``, then the unit-lower and the upper
  triangular solve;
* :func:`trsv` — one triangular solve, on a triangle of ``A`` or of its
  transpose, with a unit or a stored diagonal (the Cholesky solve of
  ``schur_method="dense_f64"`` on K11's factor).

Sized for ``method="dense"`` systems, ``n`` up to :data:`MAX_N`.  Each
wrapper launches for CUDA tensors (counted in :data:`LAUNCHES`) and runs its
plain version — the same steps in the same order — for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["lu_factor", "lu_factor_plain", "lu_solve", "lu_solve_plain", "trsv", "trsv_plain",
           "LAUNCHES", "MAX_N"]

MAX_N = 8192
LAUNCHES = build.Counter("dense_lu")


def lu_factor_plain(A):
    """Eager version: ``(LU, piv)``."""
    LU = A.clone()
    n = LU.shape[0]
    piv = torch.empty(n, dtype=torch.int32, device=A.device)
    for k in range(n):
        p = k + torch.argmax(LU[k:, k].abs())
        piv[k] = p
        rows = torch.stack([torch.as_tensor(k, device=A.device), p])
        LU[rows] = LU[rows.flip(0)]
        if k + 1 < n:
            r = 1.0 / LU[k, k]
            LU[k + 1:, k] = LU[k + 1:, k] * r
            LU[k + 1:, k + 1:] = LU[k + 1:, k + 1:] - torch.outer(LU[k + 1:, k], LU[k, k + 1:])
    return LU, piv


def trsv_plain(A, x, lower: bool, trans: bool = False, unit: bool = False) -> torch.Tensor:
    """``op(T)⁻¹ x`` (a new vector), column by column as the kernel runs."""
    x = x.clone()
    n = x.shape[0]
    forward = lower != trans
    for s in range(n):
        c = s if forward else n - 1 - s
        if not unit:
            x[c] = x[c] / A[c, c]
        col = A[c, :] if trans else A[:, c]
        if forward:
            x[c + 1:] = x[c + 1:] - col[c + 1:] * x[c]
        else:
            x[:c] = x[:c] - col[:c] * x[c]
    return x


def lu_solve_plain(LU, piv, b) -> torch.Tensor:
    x = b.clone()
    for k, p in enumerate(piv.tolist()):
        if p != k:
            x[[k, p]] = x[[p, k]]
    y = trsv_plain(LU, x, lower=True, unit=True)
    return trsv_plain(LU, y, lower=False)


def _check_square(name: str, A, *vectors) -> int:
    build.require_cuda(name, A, *vectors)
    n = A.shape[0]
    if A.dim() != 2 or A.shape != (n, n) or not 0 < n <= MAX_N:
        raise ValueError(f"{name}: A must be square of order 1..{MAX_N}")
    if any(v.shape != (n,) for v in vectors):
        raise ValueError(f"{name}: vectors must be ({n},)")
    return n


def _launch(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        code = getattr(build.library(), name)(*args, build.stream_handle(device))
    build.check(code, "dense_lu")
    LAUNCHES.launches += 1


def lu_factor(A):
    """K21b's factor of ``A (n, n)`` float64 (not modified): ``(LU, piv)``."""
    if A.device.type == "cpu":
        return lu_factor_plain(A)
    n = _check_square("lu_factor", A)
    LU = A.clone()
    piv = torch.empty(n, dtype=torch.int32, device=A.device)
    _launch("nxfx_lu_factor", A.device, n, LU.data_ptr(), piv.data_ptr())
    return LU, piv


def lu_solve(LU, piv, b) -> torch.Tensor:
    """``A⁻¹ b`` from :func:`lu_factor`'s ``(LU, piv)``."""
    if b.device.type == "cpu":
        return lu_solve_plain(LU, piv, b)
    n = _check_square("lu_solve", LU, b)
    build.require_cuda("lu_solve", piv, dtype=torch.int32)
    x = torch.empty_like(b)
    _launch("nxfx_lu_solve", b.device, n, LU.data_ptr(), piv.data_ptr(), b.data_ptr(), x.data_ptr())
    return x


def trsv(A, x, lower: bool, trans: bool = False, unit: bool = False) -> torch.Tensor:
    """``op(T)⁻¹ x`` (a new vector): ``T`` the lower or upper triangle of
    ``A``, ``op`` its transpose when ``trans``, its diagonal 1 when ``unit``."""
    if x.device.type == "cpu":
        return trsv_plain(A, x, lower, trans, unit)
    n = _check_square("trsv", A, x)
    out = x.clone()
    _launch("nxfx_trsv", x.device, n, A.data_ptr(), int(lower), int(trans), int(unit), out.data_ptr())
    return out
