"""K10: the multi-level gather-fold segment reduction, on K6's kernel (``csrc/segsum.cu``).

Replaces ``networks_fenicsx_tpu/ops/core_elim.py:_fold_apply`` and
``_fold_apply_pre`` (``:394-415``).  A fold plan (host
:func:`..ops.core_elim._plan_fold`) is a tuple of padded ``(n_grp, K)``
index levels; level ``l`` sums ``K`` entries of the previous level's output
into each of its rows, a pad index pointing one past the input, at a zero.
That is K6's computation and pad convention, so :func:`fold_apply` makes
one ``nxfx_segsum`` launch per level.  ``vec`` is ``(n,)`` or ``(n, C)``
float64: the peel folds its two channels (diagonal, rhs) in one pass.

:func:`fold_apply` launches for CUDA tensors and runs :func:`fold_apply_plain`,
the reference's level loop with K6's plain sum, for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build, segsum

__all__ = ["fold_apply", "fold_apply_plain"]


def fold_apply_plain(vec: torch.Tensor, levels: tuple, out: torch.Tensor | None = None) -> torch.Tensor:
    """Eager version: per level ``cat([vec, 0])[lv]`` summed along K in
    ascending order (K6's plain version); with ``out``, the sums are also
    written into it (and it is returned)."""
    for lv in levels:
        vec = segsum.segsum_plain(lv, vec)
    if out is not None:
        out.copy_(vec)
        return out
    return vec


def fold_apply(vec: torch.Tensor, levels: tuple, out: torch.Tensor | None = None) -> torch.Tensor:
    """K10 on ``vec``'s device: ``(U,) + vec.shape[1:]`` fold sums; the last
    level writes into ``out`` when given (a contiguous view, e.g. a segment
    of the core elimination's update stream)."""
    if vec.device.type == "cpu":
        return fold_apply_plain(vec, levels, out)
    build.require_cuda("fold_apply", vec)
    if vec.dim() not in (1, 2):
        raise ValueError("fold_apply: vec must be (n,) or (n, C)")
    launched = False
    for i, lv in enumerate(levels):
        build.require_cuda("fold_apply", lv, dtype=torch.int32)
        shape = (lv.shape[0],) + tuple(vec.shape[1:])
        if out is not None and i == len(levels) - 1:
            build.require_cuda("fold_apply", out)
            if tuple(out.shape) != shape:
                raise ValueError("fold_apply: out must have the fold's output shape")
            dst = out
        else:
            dst = torch.empty(shape, dtype=torch.float64, device=vec.device)
        launched |= segsum.launch(lv, vec, dst, name="fold_apply")
        vec = dst
    if launched:
        fold_apply.launches += 1
    return vec


fold_apply.launches = 0
