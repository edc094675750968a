"""K6: exact sorted-segment sums (``csrc/segsum.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_segsum_sorted`` (``:2058-2128``):
``out[s, c] = Σ_j vals[idx[s, j], c]`` over a host-built ``(S, K)`` gather
matrix (:func:`..levels.segsum_matrix`) whose padding names the zero slot
``n = vals.shape[0]``.  ``vals`` is ``(n,)`` or ``(n, C)`` float64.
Given ``bins`` (sorted, unique), the sums are added into rows ``out[bins[s]]``
instead — the sorted-unique scatter-add of ``_lambda_system_sorted``
(``:700-737``).  :func:`segsum_plain` is the reference's padded gather and
row sum, in eager PyTorch.

A route's sums go through a :class:`SumPlan`: up to :data:`MAX_GROUPS`
groups ``(idx, bins or None)`` on one device, validated once where the
device plan is uploaded, with their pointers and shapes packed for the
launcher.  :func:`segsum_plan` then makes one ``nxfx_segsum_plan`` launch
for all of them (the level route's three sums, the bifurcation system's
two sides, a shard's sides and pairs), checking only its float64 value
tensors, with the stream handle read without a Python ``Stream`` and no
device switch when the values' device is the current one.  The groups with
``bins`` share one output, written whole: the rows no group names are 0,
the others ``(+0.0 + sum of the first group) + sum of the next ...`` in
group order — the plain version's zero-filled output with each group added
into it in turn (:func:`segsum_plan_plain`), to the bit.  CPU values run
:func:`segsum_plan_plain`.  The launches count on :data:`LAUNCHES`.

A sweep runs a plan over S scenarios in one launch,
:func:`segsum_plan_scenarios`: each value tensor ``(S, n)`` or ``(S, n, C)``,
each output ``(S,) +`` its one-scenario shape, scenario ``i`` the
one-scenario launch on row ``i`` bit for bit (its own count,
``segsum_plan_scenarios.launches``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["segsum_plain", "SumPlan", "segsum_plan", "segsum_plan_plain", "MAX_GROUPS", "LAUNCHES",
           "segsum_plan_scenarios", "segsum_plan_scenarios_plain"]

MAX_GROUPS = 4  # SUM_MAX_GROUPS in csrc/segsum.cu
LAUNCHES = build.Counter("segsum")


def segsum_plain(
    idx: torch.Tensor, vals: torch.Tensor, bins: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Eager version: ``cat([vals, 0])[idx]`` summed over the K columns in
    ascending order, shape ``(S,) + vals.shape[1:]`` (with ``bins``: added
    into ``out[bins]``, which is returned).

    The columns are added one by one rather than by ``torch.sum``, whose
    order is the backend's: the sum is then the kernel's to the last bit,
    and a deep elimination downstream cannot amplify a rounding difference
    between the two."""
    pad = torch.zeros((1,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    vp = torch.cat([vals, pad])
    idx = idx.long()
    if idx.shape[1] == 0:
        sums = torch.zeros((idx.shape[0],) + tuple(vals.shape[1:]), dtype=vals.dtype,
                           device=vals.device)
    else:
        sums = vp[idx[:, 0]]
        for j in range(1, idx.shape[1]):
            sums = sums + vp[idx[:, j]]
    if bins is None:
        return sums
    b = bins.long()
    out[b] = out[b] + sums
    return out


class _SumPlanArgs(ctypes.Structure):
    """``SumPlanArgs`` of ``csrc/segsum.cu``."""

    _fields_ = [("G", ctypes.c_int), ("rows", ctypes.c_int),
                ("idx", ctypes.c_void_p * MAX_GROUPS), ("inv", ctypes.c_void_p * MAX_GROUPS),
                ("S", ctypes.c_int * MAX_GROUPS), ("K", ctypes.c_int * MAX_GROUPS),
                ("C", ctypes.c_int * MAX_GROUPS)]


class SumPlan:
    """The sums of one route on one device, validated at construction.

    ``groups`` is a sequence of 1..:data:`MAX_GROUPS` ``(idx, bins)``: ``idx``
    an ``(S, K)`` gather matrix (:func:`..levels.segsum_matrix`), ``bins``
    None for a group with its own ``(S,) + channel`` output, or the ``(S,)``
    sorted unique rows of the shared ``(rows,) + channel`` output its sums
    add into.  ``channels[g]`` is 1 for ``(n,)`` values, ``C`` for ``(n, C)``;
    the groups with bins share theirs.

    Raises ``ValueError`` for a tensor that is not contiguous, not int32, of
    the wrong rank or shape, without data (a meta tensor has none) or off the
    first table's device; for a negative index; for bins that are not sorted
    and unique in ``[0, rows)``; and for a plan the launcher cannot take.
    ``src_max`` is the largest index, which the values' row count must
    reach; ``index`` the tables' CUDA device (-1 off CUDA).  The checks of
    the indices and bins take one device read for the whole plan."""

    __slots__ = ("groups", "channels", "rows", "index", "src_max", "shapes", "slots", "_layout",
                 "_total", "_inv", "_args", "_addr")

    def __init__(self, groups, channels, rows: int | None = None):
        groups = tuple((idx, bins) for idx, bins in groups)
        channels = tuple(int(c) for c in channels)
        G = len(groups)
        if not 0 < G <= MAX_GROUPS or len(channels) != G or min(channels) < 1:
            raise ValueError(f"SumPlan: 1..{MAX_GROUPS} groups, each with a channel count")
        dev = groups[0][0].device
        if dev.type == "meta":
            raise ValueError("SumPlan: tables must hold data (a meta tensor has none)")
        shared = [g for g, (_, bins) in enumerate(groups) if bins is not None]
        if shared and (rows is None or rows < 0 or len({channels[g] for g in shared}) != 1):
            raise ValueError("SumPlan: groups with bins need the shared output's rows and one "
                             "channel count")
        checks = []
        for idx, bins in groups:
            for t, dim in ((idx, 2), (bins, 1)):
                if t is None:
                    continue
                if t.device != dev:
                    raise ValueError("SumPlan: tables must share one device")
                if t.dtype != torch.int32 or t.dim() != dim or not t.is_contiguous():
                    raise ValueError(f"SumPlan: expected a contiguous {dim}-D int32 table, "
                                     f"got {t.dtype} {tuple(t.shape)}")
            if bins is not None and bins.shape[0] != idx.shape[0]:
                raise ValueError("SumPlan: bins must name one row a segment")
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            checks += [idx.min() if idx.numel() else zero, idx.max() if idx.numel() else zero]
            if bins is not None:
                ordered = (bins[1:] > bins[:-1]).all().to(torch.int32)  # True when empty
                checks += [bins.min() if bins.numel() else zero, bins.max() if bins.numel() else zero,
                           ordered]
        bounds = torch.stack(checks).tolist()  # one device read for the whole plan
        at, highs = 0, []
        for _, bins in groups:
            low, high = bounds[at], bounds[at + 1]
            at += 2
            if low < 0:
                raise ValueError("SumPlan: negative index")
            highs.append(high)
            if bins is not None:
                b_low, b_high, ordered = bounds[at: at + 3]
                at += 3
                if bins.shape[0] and (b_low < 0 or b_high >= rows or not ordered):
                    raise ValueError(f"SumPlan: bins must be sorted, unique and in [0, {rows})")
        self.groups, self.channels = groups, channels
        self.rows = int(rows) if shared else None
        self.index = dev.index if dev.type == "cuda" else -1  # Tensor.get_device()'s numbering
        self.src_max = max(highs)
        # the outputs in the order of their groups' first appearance, and each group's output
        self.shapes, self.slots = [], []
        for g, ((idx, bins), c) in enumerate(zip(groups, channels)):
            if bins is not None and g != shared[0]:
                self.slots.append(self.slots[shared[0]])
                continue
            self.slots.append(len(self.shapes))
            S = idx.shape[0] if bins is None else self.rows
            self.shapes.append(torch.Size((S,) if c == 1 else (S, c)))
        self.shapes, self.slots = tuple(self.shapes), tuple(self.slots)
        # fresh outputs are views of one buffer: (shape, strides, offset) each
        self._layout, self._total = [], 0
        for shape in self.shapes:
            self._layout.append((shape, (shape[1], 1) if len(shape) == 2 else (1,), self._total))
            self._total += shape.numel()
        # the shared output's inverse tables: row -> the group's segment, -1 none
        self._inv = []
        for idx, bins in groups:
            if bins is None:
                self._inv.append(None)
                continue
            inv = torch.full((self.rows,), -1, dtype=torch.int32, device=dev)
            inv[bins.long()] = torch.arange(bins.shape[0], dtype=torch.int32, device=dev)
            self._inv.append(inv)
        if any(idx.shape[0] * c >= 2**31 for (idx, _), c in zip(groups, channels)) or (
                shared and self.rows * channels[shared[0]] >= 2**31):
            raise ValueError("SumPlan: a group is out of the launcher's int32 range")
        args = _SumPlanArgs()
        args.G, args.rows = G, self.rows or 0
        for g, ((idx, _), inv, c) in enumerate(zip(groups, self._inv, channels)):
            args.idx[g] = idx.data_ptr()
            args.inv[g] = None if inv is None else inv.data_ptr()
            args.S[g], args.K[g], args.C[g] = idx.shape[0], idx.shape[1], c
        self._args, self._addr = args, ctypes.addressof(args)

    def __len__(self) -> int:
        return len(self.groups)


def segsum_plan_plain(plan: SumPlan, *vals: torch.Tensor) -> tuple:
    """Eager version: each group's :func:`segsum_plain` in group order; the
    groups with bins added in turn into one zero-filled output.  Returns the
    outputs in the order of their groups' first appearance."""
    outs, shared = [], None
    for (idx, bins), v in zip(plan.groups, vals):
        if bins is None:
            outs.append(segsum_plain(idx, v))
            continue
        if shared is None:
            shared = torch.zeros((plan.rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
            outs.append(shared)
        segsum_plain(idx, v, bins, shared)
    return tuple(outs)


def segsum_plan(plan: SumPlan, *vals: torch.Tensor) -> tuple:
    """K6 on a plan, one launch for all its groups: ``vals`` one float64
    tensor a group (``(n,)`` or ``(n, C)`` by the plan's channels, one ``n``
    for all, at least ``plan.src_max``), on the plan's device.  Returns the
    outputs as :func:`segsum_plan_plain` orders them (on CUDA views of one
    new buffer)."""
    if vals and vals[0].device.type == "cpu":
        return segsum_plan_plain(plan, *vals)
    outs = launch_plan(plan, vals)
    LAUNCHES.launches += 1
    return outs


def launch_plan(plan: SumPlan, vals, out=None, name: str = "segsum_plan") -> tuple:
    """:func:`segsum_plan`'s checks and launch on CUDA values, uncounted (the
    sharded partials count their own launches)."""
    if len(vals) != len(plan.groups):
        raise ValueError(f"{name}: {len(plan.groups)} value tensors expected, got {len(vals)}")
    index, v0 = plan.index, vals[0]
    n = v0.shape[0] if v0.dim() else -1
    for v, C in zip(vals, plan.channels):
        if not v.is_cuda or v.get_device() != index:
            raise ValueError(f"{name}: values must be on the plan's CUDA device {index}")
        if (v.dtype is not torch.float64 or not v.is_contiguous() or v.dim() != (1 if C == 1 else 2)
                or v.shape[0] != n or (C > 1 and v.shape[1] != C)):
            raise ValueError(f"{name}: expected contiguous float64 values of {n} rows and the "
                             f"plan's channels, got {v.dtype} {tuple(v.shape)}")
    if n < plan.src_max:
        raise ValueError(f"{name}: the plan reads row {plan.src_max} of {n}-row values")
    if out is None:
        buf = v0.new_empty(plan._total)
        outs = tuple(buf.as_strided(shape, strides, at) for shape, strides, at in plan._layout)
    else:
        outs = tuple(out)
        if len(outs) != len(plan.shapes) or any(
                not o.is_cuda or o.get_device() != index or o.dtype is not torch.float64
                or not o.is_contiguous() or o.shape != shape for o, shape in zip(outs, plan.shapes)):
            raise ValueError(f"{name}: out must be contiguous float64 tensors of shapes "
                             f"{tuple(plan.shapes)} on the plan's device")
    pad = [None] * (MAX_GROUPS - len(vals))
    args = (plan._addr, n, *(v.data_ptr() for v in vals), *pad,
            *(outs[k].data_ptr() for k in plan.slots), *pad, build.raw_stream(index))
    lib = build.library()
    if index == torch._C._cuda_getDevice():
        code = lib.nxfx_segsum_plan(*args)
    else:
        with torch.cuda.device(index):
            code = lib.nxfx_segsum_plan(*args)
    build.check(code, name)
    return outs


def _scenario_values(name: str, plan: SumPlan, vals) -> tuple:
    """``(S, n)`` of a scenario call's values, or raise."""
    if len(vals) != len(plan.groups):
        raise ValueError(f"{name}: {len(plan.groups)} value tensors expected, got {len(vals)}")
    S = vals[0].shape[0] if vals[0].dim() > 1 else 0
    n = vals[0].shape[1] if vals[0].dim() > 1 else -1
    for v, C in zip(vals, plan.channels):
        if (v.dtype is not torch.float64 or not v.is_contiguous() or v.dim() != (2 if C == 1 else 3)
                or v.shape[0] != S or v.shape[1] != n or (C > 1 and v.shape[2] != C)):
            raise ValueError(f"{name}: expected contiguous float64 values (S, n) or (S, n, C) of "
                             f"one S and n and the plan's channels, got {v.dtype} {tuple(v.shape)}")
    if S < 1 or n < plan.src_max:
        raise ValueError(f"{name}: at least one scenario of at least {plan.src_max} rows")
    return S, n


def segsum_plan_scenarios_plain(plan: SumPlan, *vals: torch.Tensor) -> tuple:
    """Eager version of :func:`segsum_plan_scenarios`: :func:`segsum_plan_plain`
    a scenario, stacked."""
    S, _ = _scenario_values("segsum_plan_scenarios", plan, vals)
    rows = [segsum_plan_plain(plan, *(v[i] for v in vals)) for i in range(S)]
    return tuple(torch.stack(t) for t in zip(*rows))


def segsum_plan_scenarios(plan: SumPlan, *vals: torch.Tensor) -> tuple:
    """K6 on a plan over S scenarios, one launch: ``vals`` one float64 tensor
    a group, ``(S, n)`` or ``(S, n, C)`` by the plan's channels (one S and one
    ``n`` for all); returns the outputs of :func:`segsum_plan`, each with a
    leading S."""
    if vals and vals[0].device.type == "cpu":
        return segsum_plan_scenarios_plain(plan, *vals)
    name = "segsum_plan_scenarios"
    S, n = _scenario_values(name, plan, vals)
    index = plan.index
    if any(not v.is_cuda or v.get_device() != index for v in vals):
        raise ValueError(f"{name}: values must be on the plan's CUDA device {index}")
    buf = vals[0].new_empty(S * plan._total)
    outs, at = [], 0
    for shape, _, _ in plan._layout:
        outs.append(buf[at: at + S * shape.numel()].view((S,) + tuple(shape)))
        at += S * shape.numel()
    pad = [None] * (MAX_GROUPS - len(vals))
    with torch.cuda.device(index):
        code = build.library().nxfx_segsum_plan_scen(
            plan._addr, n, S, *(v.data_ptr() for v in vals), *pad,
            *(outs[k].data_ptr() for k in plan.slots), *pad, build.raw_stream(index))
    build.check(code, name)
    segsum_plan_scenarios.launches += 1
    return tuple(outs)


segsum_plan_scenarios.launches = 0
