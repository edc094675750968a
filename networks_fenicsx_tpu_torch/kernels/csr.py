"""K20: the CSR duplicate fold; K20b: the CSR matvec and row reductions
(``csrc/csr.cu``).

Replaces ``networks_fenicsx_tpu/ops/csr_assembly.py:make_gather_assembler``
(``:76-101``) and ``ops/sparse.py:CSRMatrix.__matmul__`` (``:40-46``), with
the diagonal of ``solver.py:_extract_diagonal`` (``:4842-4851``) and the
Jacobi diagonal ``Σ_row J² / A_diag[col]`` of ``_continuous_pressure_solve``
(``:4725-4735``):

* :func:`csr_fold` — ``data[s] = Σ_j vals[perm[idx[s, j]]]`` over the host
  gather table ``idx (nnz, max_dup)``, whose pad entries name the slot
  ``nraw`` (zero), added in ``j`` order;
* :func:`csr_spmv` — ``out = A·v``, or ``signs ⊙ (A·v)``;
* :func:`csr_diagonal` — the diagonal; :func:`csr_tdiag` — ``Σ_row
  data² / adiag[col]``, 1 where that is not > 0.

The CSR arrays are the device copies a :class:`..ops.sparse.CSRMatrix`
keeps: ``indptr`` int64, ``indices`` int32 and ``data`` float64.  Each
wrapper launches its kernel for CUDA tensors (counted in :data:`FOLD` and
:data:`SPMV`, the row reductions with the matvec) and runs its plain
version for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = [
    "csr_fold", "csr_fold_plain", "csr_spmv", "csr_spmv_plain", "csr_diagonal",
    "csr_diagonal_plain", "csr_tdiag", "csr_tdiag_plain", "row_ids", "FOLD", "SPMV",
]

FOLD = build.Counter("csr_fold")
SPMV = build.Counter("csr_spmv")


def row_ids(indptr: torch.Tensor) -> torch.Tensor:
    """``(nnz,)`` int64 row of every stored entry."""
    n = indptr.shape[0] - 1
    counts = indptr[1:] - indptr[:-1]
    return torch.repeat_interleave(torch.arange(n, device=indptr.device), counts)


# ------------------------------------------------------------------ plain


def csr_fold_plain(perm, idx, vals) -> torch.Tensor:
    """Eager version: the padded gather, summed along ``j`` in order."""
    padded = torch.cat([vals[perm.long()], vals.new_zeros(1)])
    g = padded[idx.long()]
    acc = torch.zeros(idx.shape[0], dtype=vals.dtype, device=vals.device)
    for j in range(idx.shape[1]):
        acc = acc + g[:, j]
    return acc


def csr_spmv_plain(indptr, indices, data, v, signs=None) -> torch.Tensor:
    out = torch.zeros(indptr.shape[0] - 1, dtype=data.dtype, device=data.device)
    out.index_add_(0, row_ids(indptr), data * v[indices.long()])
    return out if signs is None else signs * out


def csr_diagonal_plain(indptr, indices, data) -> torch.Tensor:
    rows = row_ids(indptr)
    out = torch.zeros(indptr.shape[0] - 1, dtype=data.dtype, device=data.device)
    out.index_add_(0, rows, torch.where(rows == indices.long(), data, 0.0))
    return out


def csr_tdiag_plain(indptr, indices, data, adiag) -> torch.Tensor:
    out = torch.zeros(indptr.shape[0] - 1, dtype=data.dtype, device=data.device)
    out.index_add_(0, row_ids(indptr), (data * data) / adiag[indices.long()])
    return torch.where(out > 0, out, 1.0)


# ---------------------------------------------------------------- kernels


def csr_fold(perm, idx, vals) -> torch.Tensor:
    """K20 on ``vals``' device: ``perm (nraw,)`` and ``idx (nnz, max_dup)``
    int32, ``vals (nraw,)`` float64; returns ``data (nnz,)``."""
    if vals.device.type == "cpu":
        return csr_fold_plain(perm, idx, vals)
    build.require_cuda("csr_fold", vals)
    build.require_cuda("csr_fold", perm, idx, dtype=torch.int32)
    nraw = vals.shape[0]
    if perm.shape != (nraw,) or idx.dim() != 2:
        raise ValueError("csr_fold: perm must be (nraw,) and idx (nnz, max_dup)")
    nnz, max_dup = idx.shape
    data = torch.empty(nnz, dtype=torch.float64, device=vals.device)
    if nnz == 0:
        return data
    with torch.cuda.device(vals.device):
        code = build.library().nxfx_csr_fold(
            nnz, max_dup, nraw, perm.data_ptr(), idx.data_ptr(), vals.data_ptr(), data.data_ptr(),
            build.stream_handle(vals.device),
        )
    build.check(code, "csr_fold")
    FOLD.launches += 1
    return data


def _check_csr(name: str, indptr, indices, data, *vectors) -> int:
    build.require_cuda(name, data, *vectors)
    build.require_cuda(name, indptr, dtype=torch.int64)
    build.require_cuda(name, indices, dtype=torch.int32)
    if indices.shape != data.shape or indptr.dim() != 1:
        raise ValueError(f"{name}: indices and data must be (nnz,), indptr (n + 1,)")
    return indptr.shape[0] - 1


def _launch_rows(name: str, n: int, *args, device) -> None:
    with torch.cuda.device(device):
        code = getattr(build.library(), name)(n, *args, build.stream_handle(device))
    build.check(code, "csr_spmv")
    SPMV.launches += 1


def csr_spmv(indptr, indices, data, v, signs=None) -> torch.Tensor:
    """K20b: ``A·v`` (``signs ⊙ (A·v)`` with ``signs``) for the CSR arrays
    of an ``(n, m)`` matrix and ``v (m,)``."""
    if data.device.type == "cpu":
        return csr_spmv_plain(indptr, indices, data, v, signs)
    n = _check_csr("csr_spmv", indptr, indices, data, v, *(() if signs is None else (signs,)))
    if v.dim() != 1 or (signs is not None and signs.shape != (n,)):
        raise ValueError("csr_spmv: v must be a vector and signs (n,)")
    out = torch.empty(n, dtype=torch.float64, device=data.device)
    if n:
        _launch_rows("nxfx_csr_spmv", n, indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
                     v.data_ptr(), None if signs is None else signs.data_ptr(), out.data_ptr(),
                     device=data.device)
    return out


def csr_diagonal(indptr, indices, data) -> torch.Tensor:
    """The diagonal ``(n,)`` of the CSR arrays (0 where a row stores none)."""
    if data.device.type == "cpu":
        return csr_diagonal_plain(indptr, indices, data)
    n = _check_csr("csr_diagonal", indptr, indices, data)
    out = torch.empty(n, dtype=torch.float64, device=data.device)
    if n:
        _launch_rows("nxfx_csr_rows", n, 0, indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
                     None, out.data_ptr(), device=data.device)
    return out


def csr_tdiag(indptr, indices, data, adiag) -> torch.Tensor:
    """``Σ_row data² / adiag[col]`` ``(n,)``, 1 where that is not > 0."""
    if data.device.type == "cpu":
        return csr_tdiag_plain(indptr, indices, data, adiag)
    n = _check_csr("csr_tdiag", indptr, indices, data, adiag)
    out = torch.empty(n, dtype=torch.float64, device=data.device)
    if n:
        _launch_rows("nxfx_csr_rows", n, 1, indptr.data_ptr(), indices.data_ptr(), data.data_ptr(),
                     adiag.data_ptr(), out.data_ptr(), device=data.device)
    return out
