"""K22a: the per-shard body of the sharded blocked solve (``csrc/shard_blocked.cu``).

Replaces ``networks_fenicsx_tpu/parallel/blocked_sharded.py:_make_local_body``
(``:304-417``) around the shard's K1, K2–K3 forward, K4 and K5:

* :func:`partials` — the shard's row of the T system: ``dT, rT, wT`` (Tn,)
  from its E_loc rows (``tT_idx``, ``sT_idx``, ``pT_idx``), its chunk roots
  eliminated into their T parents (``root_T``), and its ``Σ r²``
  (``:345-364``, ``:377``): ``(3·Tn + 1,)``, what K22-reduce sums;
* :func:`lam_ext` — after the T solve, level 0 of the shard's λ from its T
  parents and λ_T behind its B_sub entries (``:375-376``, ``:393-399``):
  ``[λ_loc (B_sub) | λ_T (Tn)]``, which K4 completes and K5 reads by index
  (the T edges' tail rows included).

The executor runs both for every shard of a device at once:
:func:`batch_tables` stacks the shards' tables (:class:`ShardBatchTables`)
and :func:`partials_batch` / :func:`lam_batch` take all of them, each
shard's inputs reached through a per-stream struct of pointers, so a
device makes 2 launches a solve (:func:`cuda_launches`; one a
:data:`MAX_SHARDS` shards).  The one-shard wrappers launch the same kernels
on one shard's tables.

The reference's scatter-adds are gathers here, through host fold tables
(:func:`shard_tables`).  Each wrapper launches its kernel for CUDA tensors
and runs its plain version, which adds in the kernel's order, for CPU
tensors (the batched ones: the one-shard plain version in a loop over the
shards, stacked); all count on ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import build

__all__ = ["LAUNCHES", "MAX_SHARDS", "ShardTables", "ShardBatchTables", "fold_table",
           "shard_tables", "batch_tables", "cuda_launches", "partials", "partials_plain",
           "partials_batch", "partials_batch_plain", "lam_ext", "lam_ext_plain", "lam_batch",
           "lam_batch_plain"]

LAUNCHES = build.Counter("shard_blocked")
MAX_SHARDS = 32  # SB_MAX_SHARDS in csrc/shard_blocked.cu: the shards of one launch


def fold_table(target: np.ndarray, n_targets: int) -> np.ndarray:
    """``(n_targets, K)`` table of the positions ``i`` with ``target[i] == t``
    (ascending, ``-1`` padded); entries ``>= n_targets`` name no target."""
    target = np.asarray(target, np.int64)
    pos = np.flatnonzero((target >= 0) & (target < n_targets))
    tgt = target[pos]
    counts = np.bincount(tgt, minlength=n_targets)
    K = int(counts.max()) if counts.size else 0
    table = np.full((n_targets, K), -1, np.int64)
    order = np.argsort(tgt, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    rank = np.arange(pos.size) - starts[tgt[order]]
    table[tgt[order], rank] = pos[order]
    return table


@dataclasses.dataclass(frozen=True)
class ShardTables:
    """One shard's fold tables on its device (int32, ``-1`` padded): the
    rows whose target (``tfold``), source (``sfold``) or T-pair child
    (``pfold``) is T node ``t``, the chunk roots (level-0 positions) whose
    T parent is ``t`` (``rfold``), and each chunk root's T parent
    (``root_T``, ``Tn`` for none)."""

    tfold: torch.Tensor
    sfold: torch.Tensor
    pfold: torch.Tensor
    rfold: torch.Tensor
    root_T: torch.Tensor
    B_sub: int
    _scratch: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def Tn(self) -> int:
        return int(self.tfold.shape[0])

    @property
    def c(self) -> int:
        return int(self.root_T.shape[0])


FOLDS = ("tfold", "sfold", "pfold", "rfold")


@dataclasses.dataclass(frozen=True)
class ShardBatchTables:
    """The :class:`ShardTables` of S shards on one device, stacked on a
    leading shard axis: ``tfold``, ``sfold``, ``pfold``, ``rfold`` ``(S,
    Tn, K)`` (each ``K`` the widest shard's, ``-1`` padded), ``root_T``
    ``(S, c)``; ``widths[j]`` shard ``j``'s own four widths."""

    tfold: torch.Tensor
    sfold: torch.Tensor
    pfold: torch.Tensor
    rfold: torch.Tensor
    root_T: torch.Tensor
    B_sub: int
    widths: tuple
    _scratch: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def S(self) -> int:
        return int(self.root_T.shape[0])

    @property
    def Tn(self) -> int:
        return int(self.tfold.shape[1])

    @property
    def c(self) -> int:
        return int(self.root_T.shape[1])

    def shard(self, j: int) -> ShardTables:
        """Shard ``j``'s :class:`ShardTables` (views, its own widths)."""
        return ShardTables(**{name: getattr(self, name)[j, :, :K]
                              for name, K in zip(FOLDS, self.widths[j])},
                           root_T=self.root_T[j], B_sub=self.B_sub)


def batch_tables(tabs) -> ShardBatchTables:
    """The shards' :class:`ShardTables` (one device, one plan) stacked."""
    tabs = list(tabs)
    if not tabs:
        raise ValueError("shard_blocked: tables of at least one shard")
    first = tabs[0]
    if any((t.Tn, t.c, t.B_sub, t.tfold.device) != (first.Tn, first.c, first.B_sub,
                                                     first.tfold.device) for t in tabs):
        raise ValueError("shard_blocked: the shards' tables must share Tn, c, B_sub and a device")
    widths = tuple(tuple(int(getattr(t, name).shape[1]) for name in FOLDS) for t in tabs)
    stacked = {}
    for f, name in enumerate(FOLDS):
        K = max(w[f] for w in widths)
        out = torch.full((len(tabs), first.Tn, K), -1, dtype=torch.int32, device=first.tfold.device)
        for j, t in enumerate(tabs):
            out[j, :, : widths[j][f]] = getattr(t, name)
        stacked[name] = out
    root_T = torch.stack([t.root_T for t in tabs]).contiguous()
    return ShardBatchTables(**stacked, root_T=root_T, B_sub=first.B_sub, widths=widths)


def cuda_launches(bt: ShardBatchTables) -> int:
    """K22a's launches a solve on ``bt``'s device: the partials and the λ,
    one each a :data:`MAX_SHARDS` shards."""
    return 2 * -(-bt.S // MAX_SHARDS)


def shard_tables(tT_idx, sT_idx, pT_idx, root_T, Tn: int, B_sub: int, device) -> ShardTables:
    """The tables of one shard's plan rows (``ShardedBlockedPlan`` row ``d``)."""

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    return ShardTables(
        tfold=i32(fold_table(tT_idx, Tn)), sfold=i32(fold_table(sT_idx, Tn)),
        pfold=i32(fold_table(pT_idx, Tn)), rfold=i32(fold_table(root_T, Tn)),
        root_T=i32(root_T), B_sub=int(B_sub),
    )


def _table_sum(acc, vals, table):
    """``acc`` plus, column by column, the values a table row names."""
    if table.shape[1] == 0:
        return acc
    vp = torch.cat([vals, torch.zeros(1, dtype=vals.dtype, device=vals.device)])
    idx = torch.where(table >= 0, table, vals.shape[0]).long()
    for k in range(table.shape[1]):
        acc = acc + vp[idx[:, k]]
    return acc


def partials_plain(tab: ShardTables, w, const, Ftot, d, r, wn, rhs_sq) -> torch.Tensor:
    """Eager version: ``[dT | rT | wT | Σ r²]``."""
    Tn, c = tab.Tn, tab.c
    zero = torch.zeros(Tn, dtype=torch.float64, device=w.device)
    factor0 = wn[:c] / d[:c]
    dT = _table_sum(_table_sum(zero, w, tab.tfold), w, tab.sfold)
    dT = _table_sum(dT, -wn[:c] * factor0, tab.rfold)
    rT = _table_sum(_table_sum(zero, const + Ftot, tab.tfold), -const, tab.sfold)
    rT = _table_sum(rT, factor0 * r[:c], tab.rfold)
    wT = _table_sum(zero, w, tab.pfold)
    return torch.cat([dT, rT, wT, rhs_sq.reshape(1)])


def lam_ext_plain(tab: ShardTables, d, r, wn, lam_T) -> torch.Tensor:
    """Eager version: ``[λ0 | 0 … | λ_T]`` of length ``B_sub + Tn``."""
    c, Tn = tab.c, tab.Tn
    lam = torch.zeros(tab.B_sub + Tn, dtype=torch.float64, device=d.device)
    lam_pad = torch.cat([lam_T, torch.zeros(1, dtype=torch.float64, device=d.device)])
    lam[:c] = (r[:c] + wn[:c] * lam_pad[tab.root_T.long()]) / d[:c]
    lam[tab.B_sub :] = lam_T
    return lam


def partials_batch_plain(bt: ShardBatchTables, ins) -> torch.Tensor:
    """Eager version of :func:`partials_batch`: :func:`partials_plain` a
    shard, stacked ``(S, 3·Tn + 1)``."""
    return torch.stack([partials_plain(bt.shard(j), *ins[j]) for j in range(bt.S)])


def lam_batch_plain(bt: ShardBatchTables, ins, lam_T) -> torch.Tensor:
    """Eager version of :func:`lam_batch`: :func:`lam_ext_plain` a shard,
    stacked ``(S, B_sub + Tn)``."""
    return torch.stack([lam_ext_plain(bt.shard(j), *ins[j], lam_T) for j in range(bt.S)])


# ---------------------------------------------------------------- kernels


class _Inputs(ctypes.Structure):
    """``ShardBlockedInputs`` of ``csrc/shard_blocked.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("w", "cst", "Ftot", "d0", "r0", "w0", "rhs_sq")]


class _Args(ctypes.Structure):
    """``ShardBlockedArgs`` of ``csrc/shard_blocked.cu``."""

    _fields_ = [("S", ctypes.c_int), ("s", _Inputs * MAX_SHARDS)]


def _args(tab, stream: int, chunk: int) -> _Args:
    """The :class:`_Args` of chunk ``chunk`` of ``tab``'s shards on CUDA
    stream ``stream``, made at the stream's first call."""
    key = (stream, chunk)
    args = tab._scratch.get(key)
    if args is None:
        args = tab._scratch[key] = _Args()
    return args


def _index(*tables) -> int:
    """The CUDA device of the tables, checked: contiguous int32."""
    if not tables[0].is_cuda:
        raise ValueError("shard_blocked: the tables must be on a CUDA device")
    index = tables[0].get_device()
    for t in tables:
        if not t.is_cuda or t.get_device() != index or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"shard_blocked: the tables must be contiguous int32 tensors on CUDA "
                             f"device {index}")
    return index


def _check_f64(index: int, *ts) -> None:
    for t in ts:
        if (not t.is_cuda or t.get_device() != index or t.dtype != torch.float64
                or not t.is_contiguous()):
            raise ValueError(f"shard_blocked: inputs must be contiguous float64 tensors on CUDA "
                             f"device {index}")


def _check_level0(c: int, d, r, wn) -> None:
    if any(t.dim() != 1 or t.shape[0] < c for t in (d, r, wn)):
        raise ValueError("shard_blocked: d, r, wn must hold level 0")


def _launch_partials(tab, tables, ins, part) -> None:
    """One launch a :data:`MAX_SHARDS` shards of ``ins`` (per shard ``(w,
    const, Ftot, d, r, wn, rhs_sq)``) on ``tables`` (``(S, Tn, K)``, or
    one shard's ``(Tn, K)``) into ``part``."""
    index = _index(*tables)
    for w, const, Ftot, d, r, wn, rhs_sq in ins:
        _check_f64(index, w, const, Ftot, d, r, wn, rhs_sq)
        _check_level0(tab.c, d, r, wn)
        if any(t.dim() != 1 or t.shape != w.shape for t in (const, Ftot)) or rhs_sq.dim() != 0:
            raise ValueError("shard_blocked: w, const, Ftot must be one (E_loc,) and rhs_sq 0-d")
    Tn = int(tables[0].shape[-2])
    dims = [int(t.shape[-1]) for t in tables]
    stream = build.raw_stream(index)
    for chunk, s0 in enumerate(range(0, len(ins), MAX_SHARDS)):
        run = ins[s0 : s0 + MAX_SHARDS]
        args = _args(tab, stream, chunk)
        args.S = len(run)
        for a, (w, const, Ftot, d, r, wn, rhs_sq) in zip(args.s, run):
            a.w, a.cst, a.Ftot = w.data_ptr(), const.data_ptr(), Ftot.data_ptr()
            a.d0, a.r0, a.w0, a.rhs_sq = d.data_ptr(), r.data_ptr(), wn.data_ptr(), rhs_sq.data_ptr()
        code = build.on_device(index, build.library().nxfx_shard_blocked_partials,
                               ctypes.addressof(args), s0, Tn, *dims,
                               *(t.data_ptr() for t in tables), part.data_ptr(), stream)
        build.check(code, "shard_blocked")
        LAUNCHES.launches += 1


def _launch_lam(tab, ins, lam_T, lam) -> None:
    """One launch a :data:`MAX_SHARDS` shards of ``ins`` (per shard ``(d,
    r, wn)``) into ``lam`` (``(S, B_sub + Tn)``, or one shard's row)."""
    index = _index(tab.root_T)
    for d, r, wn in ins:
        _check_f64(index, d, r, wn)
        _check_level0(tab.c, d, r, wn)
    build.require_vectors("shard_blocked", index, (lam_T, tab.Tn))
    stream = build.raw_stream(index)
    for chunk, s0 in enumerate(range(0, len(ins), MAX_SHARDS)):
        run = ins[s0 : s0 + MAX_SHARDS]
        args = _args(tab, stream, chunk)
        args.S = len(run)
        for a, (d, r, wn) in zip(args.s, run):
            a.d0, a.r0, a.w0 = d.data_ptr(), r.data_ptr(), wn.data_ptr()
        code = build.on_device(index, build.library().nxfx_shard_blocked_lambda,
                               ctypes.addressof(args), s0, tab.c, tab.B_sub, tab.Tn,
                               tab.root_T.data_ptr(), lam_T.data_ptr(), lam.data_ptr(), stream)
        build.check(code, "shard_blocked")
        LAUNCHES.launches += 1


def partials(tab: ShardTables, w, const, Ftot, d, r, wn, rhs_sq) -> torch.Tensor:
    """K22a's partials of one shard on ``w``'s device: ``(3·Tn + 1,)``."""
    if w.device.type == "cpu":
        return partials_plain(tab, w, const, Ftot, d, r, wn, rhs_sq)
    build.require_cuda("shard_blocked", w, const, Ftot, d, r, wn, rhs_sq)
    part = torch.empty(3 * tab.Tn + 1, dtype=torch.float64, device=w.device)
    _launch_partials(tab, tuple(getattr(tab, name) for name in FOLDS),
                     [(w, const, Ftot, d, r, wn, rhs_sq)], part)
    return part


def partials_batch(bt: ShardBatchTables, ins) -> torch.Tensor:
    """K22a's partials of every shard of ``bt`` (``ins`` per shard ``(w,
    const, Ftot, d, r, wn, rhs_sq)``, in the tables' order) on their device:
    the ``(S, 3·Tn + 1)`` rows K22-reduce sums, one launch."""
    if len(ins) != bt.S:
        raise ValueError(f"shard_blocked: inputs of {bt.S} shards expected, got {len(ins)}")
    if ins[0][0].device.type == "cpu":
        return partials_batch_plain(bt, ins)
    part = torch.empty((bt.S, 3 * bt.Tn + 1), dtype=torch.float64, device=ins[0][0].device)
    _launch_partials(bt, tuple(getattr(bt, name) for name in FOLDS), list(ins), part)
    return part


def lam_ext(tab: ShardTables, d, r, wn, lam_T) -> torch.Tensor:
    """K22a's λ of one shard on ``d``'s device: ``[λ0 | 0 … | λ_T]``; K4
    fills the middle."""
    if d.device.type == "cpu":
        return lam_ext_plain(tab, d, r, wn, lam_T)
    build.require_cuda("shard_blocked", d, r, wn, lam_T)
    if tuple(lam_T.shape) != (tab.Tn,):
        raise ValueError("shard_blocked: lam_T must be (Tn,)")
    lam = torch.empty(tab.B_sub + tab.Tn, dtype=torch.float64, device=d.device)
    _launch_lam(tab, [(d, r, wn)], lam_T, lam)
    return lam


def lam_batch(bt: ShardBatchTables, ins, lam_T) -> torch.Tensor:
    """K22a's λ of every shard of ``bt`` (``ins`` per shard ``(d, r, wn)``)
    on their device: ``(S, B_sub + Tn)``, a row ``[λ0 | 0 … | λ_T]`` a
    shard, which K4 completes in place; one launch."""
    if len(ins) != bt.S:
        raise ValueError(f"shard_blocked: inputs of {bt.S} shards expected, got {len(ins)}")
    if ins[0][0].device.type == "cpu":
        return lam_batch_plain(bt, ins, lam_T)
    if tuple(lam_T.shape) != (bt.Tn,):
        raise ValueError("shard_blocked: lam_T must be (Tn,)")
    lam = torch.empty((bt.S, bt.B_sub + bt.Tn), dtype=torch.float64, device=ins[0][0].device)
    _launch_lam(bt, list(ins), lam_T, lam)
    return lam
