"""K10: the multi-level gather-fold segment reduction (``csrc/segsum.cu``).

Replaces ``networks_fenicsx_tpu/ops/core_elim.py:_fold_apply`` and
``_fold_apply_pre`` (``:394-415``).  A fold plan (host
:func:`..ops.core_elim._plan_fold`) is a tuple of padded ``(n_grp, K)``
index levels; level ``l`` sums ``K`` entries of the previous level's output
into each of its rows, a pad index pointing one past the input, at a zero.
``vec`` is ``(n,)`` or ``(n, C)`` float64: the peel folds its two channels
(diagonal, rhs) in one pass.

A :class:`FoldPlan` holds the levels of one fold on one device, validated
once where the plan is uploaded (int32, 2-D, contiguous, one device, each
level's indices within the previous level's rows) with their pointers and
shapes packed for the launcher.  :func:`fold_apply` then makes one
``nxfx_fold`` launch a fold, whatever its levels (K6's loop for one level;
one warp an output for more), with no per-level validation, no device
switch when the tensor's device is the current one, and the stream handle
read without a Python ``Stream`` object.

:func:`fold_apply` launches for CUDA tensors and runs :func:`fold_apply_plain`,
the reference's level loop with K6's plain sum, for CPU tensors.

:func:`fold_apply_scenarios` folds S scenarios' vectors ``(S, n)`` or ``(S, n,
C)`` in the same one launch (``nxfx_fold_scen``, the scenario its grid's y),
row ``i`` :func:`fold_apply` of row ``i`` bit for bit (the multifrontal
apply's refinement over S runs its two folds so); its plain version is
:func:`fold_apply_plain` a row, stacked.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, segsum

__all__ = ["FoldPlan", "fold_apply", "fold_apply_plain", "MAX_LEVELS", "fold_apply_scenarios",
           "fold_apply_scenarios_plain"]

MAX_LEVELS = 8  # FOLD_MAX_LEVELS in csrc/segsum.cu: segments of up to 64^8 entries


class FoldPlan:
    """The levels of one fold on one device, validated at construction.

    Raises ``ValueError`` for an empty plan, more than :data:`MAX_LEVELS`
    levels, a level that is not a contiguous 2-D int32 tensor with data (a
    meta tensor has none) on the first level's device, or one whose indices
    leave ``[0, rows of the previous level]`` (its pad).  ``rows`` is the
    fold's output length; ``src_max`` the largest index of level 0, which a
    source vector's row count must reach; ``index`` the levels' CUDA device
    (-1 off CUDA)."""

    __slots__ = ("levels", "index", "n_levels", "rows", "src_max", "_ptrs", "_rows", "_widths")

    def __init__(self, levels):
        levels = tuple(levels)
        if not 0 < len(levels) <= MAX_LEVELS:
            raise ValueError(f"FoldPlan: 1..{MAX_LEVELS} levels, got {len(levels)}")
        dev = levels[0].device
        if dev.type == "meta":
            raise ValueError("FoldPlan: levels must hold data (a meta tensor has none)")
        for lv in levels:
            if lv.device != dev:
                raise ValueError("FoldPlan: levels must share one device")
            if lv.dtype != torch.int32 or lv.dim() != 2:
                raise ValueError(f"FoldPlan: levels must be 2-D int32, got {lv.dtype} {tuple(lv.shape)}")
            if not lv.is_contiguous():
                raise ValueError("FoldPlan: levels must be contiguous")
        lows, highs = [], []
        for lv in levels:
            lows.append(lv.min() if lv.numel() else torch.zeros((), dtype=torch.int32, device=dev))
            highs.append(lv.max() if lv.numel() else torch.zeros((), dtype=torch.int32, device=dev))
        bounds = torch.stack(lows + highs).tolist()  # one device read for the whole plan
        lows, highs = bounds[: len(levels)], bounds[len(levels):]
        if min(lows) < 0:
            raise ValueError("FoldPlan: negative index")
        for l in range(1, len(levels)):
            if highs[l] > levels[l - 1].shape[0]:
                raise ValueError(f"FoldPlan: level {l} indexes past the {levels[l - 1].shape[0]} rows "
                                 f"of level {l - 1} and its pad")
        self.levels = levels
        self.index = dev.index if dev.type == "cuda" else -1  # Tensor.get_device()'s numbering
        self.n_levels = len(levels)
        self.rows = int(levels[-1].shape[0])
        self.src_max = int(highs[0])
        L = len(levels)
        self._ptrs = (ctypes.c_void_p * L)(*(lv.data_ptr() for lv in levels))
        self._rows = (ctypes.c_int * L)(*(lv.shape[0] for lv in levels))
        self._widths = (ctypes.c_int * L)(*(lv.shape[1] for lv in levels))

    def __len__(self) -> int:
        return len(self.levels)

    def __iter__(self):
        return iter(self.levels)

    def __getitem__(self, i):
        return self.levels[i]


def fold_apply_plain(vec: torch.Tensor, levels, out: torch.Tensor | None = None) -> torch.Tensor:
    """Eager version: per level ``cat([vec, 0])[lv]`` summed along K in
    ascending order (K6's plain version); with ``out``, the sums are also
    written into it (and it is returned).  ``levels`` is a tuple of levels or
    a :class:`FoldPlan`."""
    for lv in levels:
        vec = segsum.segsum_plain(lv, vec)
    if out is not None:
        out.copy_(vec)
        return out
    return vec


def fold_apply(vec: torch.Tensor, plan, out: torch.Tensor | None = None) -> torch.Tensor:
    """K10 on ``vec``'s device: ``(plan.rows,) + vec.shape[1:]`` fold sums,
    written into ``out`` when given (a contiguous view, e.g. a segment of
    the core elimination's update stream).  On CUDA ``plan`` is a
    :class:`FoldPlan` on ``vec``'s device."""
    if not vec.is_cuda:
        if vec.device.type == "cpu":
            return fold_apply_plain(vec, plan, out)
        build.require_cuda("fold_apply", vec)
    if type(plan) is not FoldPlan:
        raise TypeError("fold_apply: a CUDA fold takes a FoldPlan")
    index = vec.get_device()
    if (index != plan.index or vec.dtype is not torch.float64 or not vec.is_contiguous()
            or vec.dim() > 2 or vec.dim() == 0):
        raise ValueError("fold_apply: vec must be (n,) or (n, C) float64 on the plan's CUDA device")
    shape = vec.shape
    if shape[0] < plan.src_max:
        raise ValueError(f"fold_apply: the plan reads row {plan.src_max} of a {shape[0]}-row vec")
    C = shape[1] if len(shape) == 2 else 1
    if out is None:
        out = vec.new_empty((plan.rows,) + tuple(shape[1:]))
    elif (out.get_device() != index or out.dtype is not torch.float64 or not out.is_contiguous()
          or out.shape != (plan.rows,) + tuple(shape[1:])):
        raise ValueError("fold_apply: out must be a contiguous float64 tensor of the fold's shape "
                         "on vec's device")
    if plan.rows * C == 0:
        return out
    if index == torch._C._cuda_getDevice():
        code = _launch(plan, C, shape[0], vec, out, index)
    else:
        with torch.cuda.device(index):
            code = _launch(plan, C, shape[0], vec, out, index)
    build.check(code, "fold_apply")
    fold_apply.launches += 1
    return out


def _launch(plan: FoldPlan, C: int, n: int, vec, out, index: int) -> int:
    return build.library().nxfx_fold(plan.n_levels, plan._ptrs, plan._rows, plan._widths, C, n,
                                     vec.data_ptr(), out.data_ptr(), build.raw_stream(index))


fold_apply.launches = 0


def _scenario_shape(vec: torch.Tensor) -> tuple:
    """``(S, n, C)`` of a scenario fold's ``vec``, or raise."""
    if vec.dim() not in (2, 3) or vec.shape[0] < 1:
        raise ValueError("fold_apply_scenarios: vec must be (S, n) or (S, n, C), S >= 1")
    return int(vec.shape[0]), int(vec.shape[1]), int(vec.shape[2]) if vec.dim() == 3 else 1


def fold_apply_scenarios_plain(vec: torch.Tensor, levels) -> torch.Tensor:
    """Eager version of :func:`fold_apply_scenarios`: :func:`fold_apply_plain`
    a scenario, stacked."""
    S, _, _ = _scenario_shape(vec)
    return torch.stack([fold_apply_plain(vec[i], levels) for i in range(S)])


def fold_apply_scenarios(vec: torch.Tensor, plan) -> torch.Tensor:
    """K10 over S scenarios on ``vec``'s device, one launch: ``vec (S, n)``
    or ``(S, n, C)``; returns ``(S, plan.rows) + vec.shape[2:]``, row ``i``
    :func:`fold_apply` of ``vec[i]`` bit for bit.  On CUDA ``plan`` is a
    :class:`FoldPlan` on ``vec``'s device."""
    if vec.device.type == "cpu":
        return fold_apply_scenarios_plain(vec, plan)
    name = "fold_apply_scenarios"
    if type(plan) is not FoldPlan:
        raise TypeError(f"{name}: a CUDA fold takes a FoldPlan")
    S, n, C = _scenario_shape(vec)
    if (not vec.is_cuda or vec.get_device() != plan.index or vec.dtype is not torch.float64
            or not vec.is_contiguous()):
        raise ValueError(f"{name}: vec must be contiguous float64 on the plan's CUDA device")
    if n < plan.src_max:
        raise ValueError(f"{name}: the plan reads row {plan.src_max} of a {n}-row vec")
    out = vec.new_empty((S, plan.rows) + tuple(vec.shape[2:]))
    if plan.rows * C == 0:
        return out
    index = plan.index
    code = build.on_device(index, build.library().nxfx_fold_scen, plan.n_levels, plan._ptrs,
                           plan._rows, plan._widths, C, n, S, vec.data_ptr(), out.data_ptr(),
                           build.raw_stream(index))
    build.check(code, name)
    fold_apply_scenarios.launches += 1
    return out


fold_apply_scenarios.launches = 0
