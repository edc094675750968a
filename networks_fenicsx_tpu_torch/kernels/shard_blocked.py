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

The reference's scatter-adds are gathers here, through host fold tables
(:func:`shard_tables`).  Each wrapper launches its kernel for CUDA tensors
and runs its plain version, which adds in the kernel's order, for CPU
tensors; both count on ``LAUNCHES``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build

__all__ = ["LAUNCHES", "ShardTables", "fold_table", "shard_tables", "partials", "partials_plain",
           "lam_ext", "lam_ext_plain"]

LAUNCHES = build.Counter("shard_blocked")


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

    @property
    def Tn(self) -> int:
        return int(self.tfold.shape[0])

    @property
    def c(self) -> int:
        return int(self.root_T.shape[0])


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


def partials(tab: ShardTables, w, const, Ftot, d, r, wn, rhs_sq) -> torch.Tensor:
    """K22a's partials on ``w``'s device: ``(3·Tn + 1,)``."""
    if w.device.type == "cpu":
        return partials_plain(tab, w, const, Ftot, d, r, wn, rhs_sq)
    build.require_cuda("shard_blocked", w, const, Ftot, d, r, wn, rhs_sq)
    build.require_cuda("shard_blocked", tab.tfold, tab.sfold, tab.pfold, tab.rfold,
                       dtype=torch.int32)
    Tn = tab.Tn
    if d.shape[0] < tab.c or tuple(rhs_sq.shape) != ():
        raise ValueError("shard_blocked: d, r, wn must hold level 0 and rhs_sq be 0-d")
    part = torch.empty(3 * Tn + 1, dtype=torch.float64, device=w.device)
    with torch.cuda.device(w.device):
        code = build.library().nxfx_shard_blocked_partials(
            Tn, tab.tfold.shape[1], tab.sfold.shape[1], tab.pfold.shape[1], tab.rfold.shape[1],
            tab.tfold.data_ptr(), tab.sfold.data_ptr(), tab.pfold.data_ptr(),
            tab.rfold.data_ptr(), w.data_ptr(), const.data_ptr(), Ftot.data_ptr(),
            d.data_ptr(), r.data_ptr(), wn.data_ptr(), rhs_sq.data_ptr(), part.data_ptr(),
            build.stream_handle(w.device),
        )
    build.check(code, "shard_blocked")
    LAUNCHES.launches += 1
    return part


def lam_ext_plain(tab: ShardTables, d, r, wn, lam_T) -> torch.Tensor:
    """Eager version: ``[λ0 | 0 … | λ_T]`` of length ``B_sub + Tn``."""
    c, Tn = tab.c, tab.Tn
    lam = torch.zeros(tab.B_sub + Tn, dtype=torch.float64, device=d.device)
    lam_pad = torch.cat([lam_T, torch.zeros(1, dtype=torch.float64, device=d.device)])
    lam[:c] = (r[:c] + wn[:c] * lam_pad[tab.root_T.long()]) / d[:c]
    lam[tab.B_sub :] = lam_T
    return lam


def lam_ext(tab: ShardTables, d, r, wn, lam_T) -> torch.Tensor:
    """K22a's λ on ``d``'s device: ``[λ0 | 0 … | λ_T]``; K4 fills the middle."""
    if d.device.type == "cpu":
        return lam_ext_plain(tab, d, r, wn, lam_T)
    build.require_cuda("shard_blocked", d, r, wn, lam_T)
    build.require_cuda("shard_blocked", tab.root_T, dtype=torch.int32)
    if tuple(lam_T.shape) != (tab.Tn,):
        raise ValueError("shard_blocked: lam_T must be (Tn,)")
    lam = torch.zeros(tab.B_sub + tab.Tn, dtype=torch.float64, device=d.device)
    with torch.cuda.device(d.device):
        code = build.library().nxfx_shard_blocked_lambda(
            tab.c, tab.B_sub, tab.Tn, tab.root_T.data_ptr(), d.data_ptr(), r.data_ptr(),
            wn.data_ptr(), lam_T.data_ptr(), lam.data_ptr(), build.stream_handle(d.device),
        )
    build.check(code, "shard_blocked")
    LAUNCHES.launches += 1
    return lam
