"""K21b: the float64 dense solve (``csrc/dense_lu.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_dense_solve_f64`` (``:4763-4778``;
``jnp.linalg.solve`` on the CPU, an f32 LU with f64 refinement on the TPU)
with a float64 LU with partial pivoting on the card:

* :func:`lu_factor` — a right-looking LU on a copy of ``A (n, n)``, blocked
  in panels of :data:`NB` columns; returns ``(LU, piv)``, ``piv[k]`` the row
  swapped with row ``k`` at step ``k`` (0-based, as ``scipy.linalg.lu_factor``);
* :func:`lu_solve` — the swaps on ``b``, then the unit-lower and the upper
  triangular solve;
* :func:`trsv` — one triangular solve, on a triangle of ``A`` or of its
  transpose, with a unit or a stored diagonal (the Cholesky solve of
  ``schur_method="dense_f64"`` on K11's factor), blocked in :data:`TILE`-row
  diagonal tiles.

The blocking keeps the unblocked loop's arithmetic: every element goes
through the same products and differences in the same order, so the pivots
(the saddle matrix's ties go to the lowest row, as LAPACK's ``idamax``) and
the factor are the same bits for any panel width.  A panel ``[k0, k1)`` is
factored with the unblocked steps on its own columns (pivot, swap, scale by
``r = 1/a[k][k]``, rank-1 update of the panel's later columns); its swaps are
then applied to the other columns (LAPACK's ``dlaswp``); the rows ``k0..k1-1``
right of the panel are forward-substituted in ascending ``m`` (U12), and the
trailing block gets the panel's ``k1 - k0`` rank-1 updates in ascending ``m``.
:func:`lu_factor_plain` runs that schedule for any ``nb`` (``nb = 1`` is the
unblocked loop); :func:`trsv_plain` the tiled solve (a tile of one row is the
column loop).

On the card a panel is factored by a thread-block cluster that keeps it in
shared memory, on a stream of the greatest priority that runs one panel
ahead of the trailing updates on the caller's stream (``csrc/dense_lu.cu``).

Sized for ``method="dense"`` systems, ``n`` up to :data:`MAX_N`.  Each
wrapper launches for CUDA tensors (counted in :data:`LAUNCHES`; the factor's
device launches in ``LAUNCHES.device``) and runs its plain version for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["lu_factor", "lu_factor_plain", "lu_solve", "lu_solve_plain", "trsv", "trsv_plain",
           "LAUNCHES", "MAX_N", "NB", "TILE"]

MAX_N = 8192
NB = 64  # the trailing update's panel width (the kernel's outer panel)
TILE = 64  # trsv's diagonal tile
LAUNCHES = build.Counter("dense_lu")
LAUNCHES.device = 0  # device kernel launches of the factors, as the launcher reports them


def _swap_rows(M, k: int, p, cols: slice) -> None:
    """Rows ``k`` and ``p`` (a 0-d tensor) of ``M[:, cols]`` exchanged."""
    rows = torch.stack([torch.as_tensor(k, device=M.device), p])
    M[rows, cols] = M[rows.flip(0), cols]


def lu_factor_plain(A, nb: int = NB):
    """Eager version: ``(LU, piv)`` in the kernel's schedule, panels of
    ``nb`` columns (``nb = 1``: the unblocked loop); the same bits for any
    ``nb``."""
    if nb < 1:
        raise ValueError("lu_factor_plain: nb must be at least 1")
    LU = A.clone()
    n = LU.shape[0]
    piv = torch.empty(n, dtype=torch.int32, device=A.device)
    pivots = []
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        for k in range(k0, k1):  # the panel: the unblocked steps on its own columns
            p = k + torch.argmax(LU[k:, k].abs())
            piv[k] = p
            pivots.append(p)
            _swap_rows(LU, k, p, slice(k0, k1))
            if k + 1 < n:
                r = 1.0 / LU[k, k]
                LU[k + 1:, k] = LU[k + 1:, k] * r
                LU[k + 1:, k + 1:k1] = LU[k + 1:, k + 1:k1] - torch.outer(LU[k + 1:, k],
                                                                           LU[k, k + 1:k1])
        for k in range(k0, k1):  # the panel's swaps on the other columns
            _swap_rows(LU, k, pivots[k], slice(0, k0))
            _swap_rows(LU, k, pivots[k], slice(k1, n))
        for m in range(k0, k1 - 1):  # U12: forward substitution, ascending m
            LU[m + 1:k1, k1:] = LU[m + 1:k1, k1:] - torch.outer(LU[m + 1:k1, m], LU[m, k1:])
        for m in range(k0, k1):  # the trailing block: the panel's rank-1 updates, ascending m
            LU[k1:, k1:] = LU[k1:, k1:] - torch.outer(LU[k1:, m], LU[m, k1:])
    return LU, piv


def trsv_plain(A, x, lower: bool, trans: bool = False, unit: bool = False,
               tile: int = TILE) -> torch.Tensor:
    """``op(T)⁻¹ x`` (a new vector) in the kernel's schedule: ``tile``-row
    diagonal tiles, each solved column by column, then its columns applied
    to the rows beyond it, column by column — each ``x[i]`` updated in the
    column loop's order (``tile = 1`` is that loop)."""
    x = x.clone()
    n = x.shape[0]
    M = A.T if trans else A  # a(i, c) = M[i, c]
    if lower != trans:  # forward: ascending columns
        for t0 in range(0, n, tile):
            t1 = min(t0 + tile, n)
            for c in range(t0, t1):
                if not unit:
                    x[c] = x[c] / M[c, c]
                x[c + 1:t1] = x[c + 1:t1] - M[c + 1:t1, c] * x[c]
            for c in range(t0, t1):
                x[t1:] = x[t1:] - M[t1:, c] * x[c]
    else:  # backward: descending columns
        for t0 in reversed(range(0, n, tile)):
            t1 = min(t0 + tile, n)
            for c in range(t1 - 1, t0 - 1, -1):
                if not unit:
                    x[c] = x[c] / M[c, c]
                x[t0:c] = x[t0:c] - M[t0:c, c] * x[c]
            for c in range(t1 - 1, t0 - 1, -1):
                x[:t0] = x[:t0] - M[:t0, c] * x[c]
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


def _tiles(n: int) -> int:
    return -(-n // TILE)


def lu_factor(A):
    """K21b's factor of ``A (n, n)`` float64 (not modified): ``(LU, piv)``."""
    if A.device.type == "cpu":
        return lu_factor_plain(A)
    n = _check_square("lu_factor", A)
    LU = A.clone()
    piv = torch.empty(n, dtype=torch.int32, device=A.device)
    launched = ctypes.c_int(0)
    _launch("nxfx_lu_factor", A.device, n, LU.data_ptr(), piv.data_ptr(), ctypes.byref(launched))
    LAUNCHES.device += launched.value
    return LU, piv


def lu_solve(LU, piv, b) -> torch.Tensor:
    """``A⁻¹ b`` from :func:`lu_factor`'s ``(LU, piv)``."""
    if b.device.type == "cpu":
        return lu_solve_plain(LU, piv, b)
    n = _check_square("lu_solve", LU, b)
    build.require_cuda("lu_solve", piv, dtype=torch.int32)
    x = torch.empty_like(b)
    flags = torch.empty(2 * (1 + _tiles(n)), dtype=torch.int32, device=b.device)
    _launch("nxfx_lu_solve", b.device, n, LU.data_ptr(), piv.data_ptr(), b.data_ptr(), x.data_ptr(),
            flags.data_ptr())
    return x


def trsv(A, x, lower: bool, trans: bool = False, unit: bool = False) -> torch.Tensor:
    """``op(T)⁻¹ x`` (a new vector): ``T`` the lower or upper triangle of
    ``A``, ``op`` its transpose when ``trans``, its diagonal 1 when ``unit``."""
    if x.device.type == "cpu":
        return trsv_plain(A, x, lower, trans, unit)
    n = _check_square("trsv", A, x)
    out = x.clone()
    flags = torch.empty(1 + _tiles(n), dtype=torch.int32, device=x.device)
    _launch("nxfx_trsv", x.device, n, A.data_ptr(), int(lower), int(trans), int(unit), out.data_ptr(),
            flags.data_ptr())
    return out
