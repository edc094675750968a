"""Host parts of the exact gather-fold segment reduction.

Counterpart of ``networks_fenicsx_tpu/ops/core_elim.py:_plan_fold`` and
``_inverse_map`` (``:348-425``), under the reference's names; the same
inputs give ``np.array_equal`` plans.  The device side of a fold plan is
K10 (:mod:`..kernels.fold`).  The rest of that module — the min-degree
core elimination (``plan_core_elimination``, K12) — is ROADMAP A6b.
"""

from __future__ import annotations

import numpy as np

__all__ = ["_plan_fold", "_inverse_map"]


def _plan_fold(
    seg: np.ndarray, U: int, src: np.ndarray, src_len: int, cap: int = 64
) -> tuple:
    """Host plan for an exact gather-fold segment reduction.

    Returns a tuple of padded 2-D int index arrays ("levels") such that
    :func:`..kernels.fold.fold_apply` sums the entries of a length-``src_len``
    vector into ``(U,)`` per-segment totals using only gathers and row sums.
    ``seg[i]``/``src[i]`` give entry i's segment and its index into the
    source vector.  Pad cells index one past the level's input (a zero).
    Segments wider than ``cap`` fold through intermediate chunk levels, so
    summation is an exact f64 tree reduction at any width.
    """
    seg = np.asarray(seg, dtype=np.int64)
    order = np.argsort(seg, kind="stable")
    cur = np.asarray(src, dtype=np.int64)[order]
    cur_counts = np.bincount(seg, minlength=U).astype(np.int64)
    cur_len = int(src_len)
    levels: list[np.ndarray] = []
    while True:
        W = int(cur_counts.max()) if cur_counts.size else 0
        n_grp = int(cur_counts.size)
        if W <= cap:
            lv = np.full((n_grp, max(W, 1)), cur_len, dtype=np.int64)
            offs = np.concatenate([[0], np.cumsum(cur_counts)])
            col = np.arange(cur.size) - np.repeat(offs[:-1], cur_counts)
            row = np.repeat(np.arange(n_grp), cur_counts)
            lv[row, col] = cur
            levels.append(lv)
            return tuple(levels)
        offs = np.concatenate([[0], np.cumsum(cur_counts)])
        pos = np.arange(cur.size) - np.repeat(offs[:-1], cur_counts)
        n_chunks_grp = (cur_counts + cap - 1) // cap
        chunk_offs = np.concatenate([[0], np.cumsum(n_chunks_grp)])
        chunk_id = np.repeat(chunk_offs[:-1], cur_counts) + pos // cap
        n_chunks = int(chunk_offs[-1])
        lv = np.full((n_chunks, cap), cur_len, dtype=np.int64)
        lv[chunk_id, pos % cap] = cur
        levels.append(lv)
        cur = np.arange(n_chunks, dtype=np.int64)
        cur_counts = n_chunks_grp
        cur_len = n_chunks


def _inverse_map(targets: np.ndarray, size: int, pad_rows: int) -> np.ndarray:
    """(size,) map: position of index i in ``targets`` (else ``pad_rows``)."""
    inv = np.full(size, pad_rows, dtype=np.int64)
    inv[np.asarray(targets, dtype=np.int64)] = np.arange(targets.size, dtype=np.int64)
    return inv
