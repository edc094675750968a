"""Static-pattern CSR assembly.

Counterpart of ``networks_fenicsx_tpu/ops/csr_assembly.py``: the sparsity
pattern of the raw COO stream is static per mesh and degree (host NumPy,
:class:`CSRPattern`, equal to the reference's), so assembling is a
permutation and a fold of the value stream into unique CSR slots.  The
default ``"gather"`` fold sums each slot's few duplicates through a host
``(nnz, max_dup)`` gather table (K20, :mod:`..kernels.csr`); ``"segment"``
is the sorted segment sum, kept as the reference keeps it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import csr as K20

__all__ = ["CSRPattern", "build_csr_pattern", "gather_table", "make_csr_assembler",
           "make_gather_assembler"]


class CSRPattern:
    """Static CSR sparsity + duplicate-folding plan for a COO stream.

    Attributes:
        indptr: (nrows+1,) CSR row pointers.
        indices: (nnz,) CSR column indices.
        perm: (nraw,) permutation sorting the raw COO stream by (row, col).
        segment_ids: (nraw,) unique-slot id of each sorted raw entry.
        shape: Matrix shape.
    """

    def __init__(self, rows: np.ndarray, cols: np.ndarray, shape: tuple[int, int]):
        nraw = rows.shape[0]
        order = np.lexsort((cols, rows))
        r_sorted, c_sorted = rows[order], cols[order]
        new_slot = np.empty(nraw, dtype=bool)
        new_slot[0] = True
        new_slot[1:] = (r_sorted[1:] != r_sorted[:-1]) | (c_sorted[1:] != c_sorted[:-1])
        segment_ids = np.cumsum(new_slot) - 1
        nnz = int(segment_ids[-1]) + 1
        u_rows = r_sorted[new_slot]
        u_cols = c_sorted[new_slot]
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, u_rows + 1, 1)
        np.cumsum(indptr, out=indptr)

        self.shape = shape
        self.perm = order.astype(np.int32)
        self.segment_ids = segment_ids.astype(np.int32)
        self.indptr = indptr
        self.indices = u_cols.astype(np.int32)
        self.nnz = nnz
        self.nraw = nraw


def build_csr_pattern(rows: np.ndarray, cols: np.ndarray, shape) -> CSRPattern:
    return CSRPattern(np.asarray(rows), np.asarray(cols), tuple(shape))


def gather_table(pattern: CSRPattern) -> np.ndarray:
    """The ``(nnz, max_dup)`` int32 gather table of the reference's
    ``make_gather_assembler``: slot ``s`` sums the sorted stream's entries
    ``idx[s, j]``, the pad entries naming the zero slot ``nraw``."""
    nnz, nraw = pattern.nnz, pattern.nraw
    counts = np.bincount(pattern.segment_ids, minlength=nnz)
    max_dup = int(counts.max()) if nnz else 1
    offsets = np.concatenate([[0], np.cumsum(counts)])
    idx = np.minimum(offsets[:-1, None] + np.arange(max_dup)[None, :], nraw)
    mask = np.arange(max_dup)[None, :] < counts[:, None]
    return np.where(mask, idx, nraw).astype(np.int32)


class _Fold:
    """``fold(values) -> data``: the pattern's host tables, uploaded once per
    device the values arrive on."""

    def __init__(self, perm: np.ndarray, table: np.ndarray, fold):
        self.perm, self.table, self._fold = perm, table, fold
        self._device: dict = {}

    def tables(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        key = str(device)
        if key not in self._device:
            self._device[key] = tuple(
                torch.as_tensor(np.ascontiguousarray(a), device=device) for a in (self.perm, self.table)
            )
        return self._device[key]

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        perm, table = self.tables(values.device)
        return self._fold(perm, table, values)


def make_gather_assembler(pattern: CSRPattern) -> _Fold:
    """Exact float64 duplicate folding with no scatter: each CSR slot gathers
    its (boundedly many) contributions through :func:`gather_table` and adds
    them in order (K20)."""
    return _Fold(pattern.perm, gather_table(pattern), K20.csr_fold)


def _segment_sum_fallback(pattern: CSRPattern) -> _Fold:
    """The sorted segment sum of the reference's ``"segment"`` method."""
    nnz = pattern.nnz

    def fold(perm, seg, values):
        out = torch.zeros(nnz, dtype=values.dtype, device=values.device)
        return out.index_add_(0, seg.long(), values[perm.long()])

    return _Fold(pattern.perm, pattern.segment_ids, fold)


def make_csr_assembler(
    pattern: CSRPattern,
    block: int = 512,
    method: str = "auto",
    interpret: bool = False,
) -> _Fold:
    """Build ``assemble(values) -> csr_data`` for a fixed sparsity pattern.

    Methods: ``"gather"`` (K20, the default under ``"auto"``) and
    ``"segment"``; ``"pallas"`` raises the reference's ``ValueError``: that
    TPU kernel was removed there.  ``block`` and ``interpret`` are unused
    (the reference's signature)."""
    del block, interpret
    if method == "auto":
        method = "gather"
    if method == "gather":
        return make_gather_assembler(pattern)
    if method == "segment":
        return _segment_sum_fallback(pattern)
    if method != "pallas":
        raise ValueError(f"unknown csr assembler method {method!r}")
    raise ValueError(
        "the Mosaic CSR fold kernel was removed from the reference: it was f32-only and could "
        "never be validated compiled on its TPU -- use method='gather' (default) or 'segment'"
    )
