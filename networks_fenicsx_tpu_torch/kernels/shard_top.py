"""K22-reduce and the T solve (``csrc/shard_top.cu``): what the shards of a
sharded solve share.

Replaces the ``psum`` and ``pmin`` of ``networks_fenicsx_tpu/parallel/*`` and
the replicated dense solve of the top forest T
(``blocked_sharded.py:361-376``, ``distributed_tree.py:489-503``):

* :func:`reduce` — the D shards' partials ``(D, stride)`` summed in shard
  order (columns ``[offset, offset + n)``);
* :func:`reduce_placed` — D strip windows ``(C, h+1, nx)`` placed at row
  offset ``(d0 + d)·h`` and summed in shard order into ``(C, ny, nx)`` (the
  lattice's ghost update, ``grid_sharded.py:320-327``);
* :func:`all_finite` — the min of D int flags (the finiteness ``pmin``);
* :func:`t_solve` — ``L_T λ_T = r_T`` on the T forest: leaf-to-root
  elimination over the host's T levels (:func:`t_forest`), then root-down
  back-substitution; exact, as the reference's Jacobi-scaled Cholesky is,
  since ``L_T``'s only off-diagonals are parent–child (``T_parent``).  With
  ``sq_extra`` it also gives ``sqrt(sq_extra + ‖r_T‖²)``.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version, which adds in the kernel's order, for CPU tensors.  The three
K22-reduce wrappers take K10's lean launch path (``fold.py``): attribute
checks once, the device index from ``get_device()``, ``new_empty``, the raw
stream, and no device switch when the device is already current.  ``REDUCE``
counts the reduce, placed and finiteness launches, ``T_SOLVE`` the T solves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import build

__all__ = [
    "REDUCE", "T_SOLVE", "TForest", "t_forest", "reduce", "reduce_plain", "reduce_placed",
    "reduce_placed_plain", "all_finite", "all_finite_plain", "t_solve", "t_solve_plain",
]

REDUCE = build.Counter("shard_reduce")
T_SOLVE = build.Counter("t_solve")


# ------------------------------------------------------------------ reduce


def reduce_plain(parts: torch.Tensor, n: int | None = None, offset: int = 0) -> torch.Tensor:
    """Eager version: ``Σ_d parts[d, offset:offset + n]`` in shard order."""
    n = parts.shape[1] - offset if n is None else n
    acc = parts[0, offset : offset + n]
    for d in range(1, parts.shape[0]):
        acc = acc + parts[d, offset : offset + n]
    return acc.clone()


def _check_parts(parts: torch.Tensor, dtype=torch.float64) -> int:
    """The device index of a CUDA ``parts`` after the checks every K22-reduce
    wrapper makes once (raises for a tensor off the card)."""
    if not parts.is_cuda:
        build.require_cuda("shard_reduce", parts, dtype=dtype)
    if parts.dtype is not dtype or not parts.is_contiguous():
        raise ValueError(f"shard_reduce: expected a contiguous {dtype} tensor")
    return parts.get_device()


def _launch(index: int, fn, *args) -> None:
    """Launch the library function ``fn`` on device ``index``'s current
    stream, entering the device only when it is not already current."""
    if index == torch._C._cuda_getDevice():
        code = fn(*args, build.raw_stream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, build.raw_stream(index))
    if code:
        build.check(code, "shard_reduce")
    REDUCE.launches += 1


def reduce(parts: torch.Tensor, n: int | None = None, offset: int = 0) -> torch.Tensor:
    """K22-reduce on ``parts``' device: the ``(n,)`` shard-ordered sum."""
    if parts.device.type == "cpu":
        return reduce_plain(parts, n, offset)
    index = _check_parts(parts)
    if parts.dim() != 2:
        raise ValueError("shard_reduce: parts must be (D, stride)")
    D, stride = parts.shape
    n = stride - offset if n is None else n
    if offset < 0 or n < 0 or offset + n > stride:
        raise ValueError("shard_reduce: columns out of range")
    out = parts.new_empty(n)
    _launch(index, build.library().nxfx_shard_reduce, D, n, stride, offset, parts.data_ptr(),
            out.data_ptr())
    return out


def reduce_placed_plain(parts: torch.Tensor, d0: int, C: int, h: int, nx: int, ny: int):
    """Eager version: each shard's ``C`` windows placed at row ``(d0 + d)·h``
    of a zero ``(C, ny, nx)`` grid (rows past ``ny`` dropped), added in
    shard order."""
    dt, dev = parts.dtype, parts.device
    acc = torch.zeros((C, ny, nx), dtype=dt, device=dev)
    for d in range(parts.shape[0]):
        win = parts[d, : C * (h + 1) * nx].reshape(C, h + 1, nx)
        full = torch.zeros((C, ny, nx), dtype=dt, device=dev)
        y0 = (d0 + d) * h
        rows = max(0, min(h + 1, ny - y0))
        if rows:
            full[:, y0 : y0 + rows] = win[:, :rows]
        acc = acc + full
    return acc


def reduce_placed(parts: torch.Tensor, d0: int, C: int, h: int, nx: int, ny: int):
    """K22-reduce's placed form on ``parts``' device: ``(C, ny, nx)``."""
    if parts.device.type == "cpu":
        return reduce_placed_plain(parts, d0, C, h, nx, ny)
    index = _check_parts(parts)
    D, stride = parts.shape
    if stride < C * (h + 1) * nx:
        raise ValueError("shard_reduce: a shard's row is shorter than its windows")
    out = parts.new_empty((C, ny, nx))
    _launch(index, build.library().nxfx_shard_reduce_placed, D, d0, C, h, nx, ny, stride,
            parts.data_ptr(), out.data_ptr())
    return out


def all_finite_plain(flags: torch.Tensor) -> torch.Tensor:
    """Eager version: ``min(flags)`` as a 0-d int32 tensor."""
    return flags.min().reshape(())


def all_finite(flags: torch.Tensor) -> torch.Tensor:
    """The finiteness min over ``(D,)`` int32 shard flags on their device."""
    if flags.device.type == "cpu":
        return all_finite_plain(flags)
    index = _check_parts(flags, torch.int32)
    out = flags.new_empty(())
    _launch(index, build.library().nxfx_shard_all, int(flags.shape[0]), flags.data_ptr(), out.data_ptr())
    return out


# ------------------------------------------------------------------ T solve


@dataclasses.dataclass(frozen=True)
class TForest:
    """The T forest's levels on one device, built once per plan.

    Attributes:
        parent: ``(Tn,)`` parent T node, ``-1`` at a root (``T_parent``).
        order: ``(Tn,)`` the nodes level by level, roots first, ascending in
            a level.
        lvl_off: ``(n_lvl + 1,)`` level bounds in ``order``.
        child_ptr, child_idx: each node's children, ascending.
        folds: host ``(n_l, K_l)`` child tables per level (``-1`` pad), what
            the plain version reads.
    """

    parent: torch.Tensor
    order: torch.Tensor
    lvl_off: torch.Tensor
    child_ptr: torch.Tensor
    child_idx: torch.Tensor
    host_order: np.ndarray
    host_lvl_off: np.ndarray
    folds: tuple

    @property
    def Tn(self) -> int:
        return int(self.parent.shape[0])

    @property
    def n_lvl(self) -> int:
        return int(self.host_lvl_off.size) - 1


def t_forest(T_parent: np.ndarray, device: torch.device | str) -> TForest:
    """Depth levels and child lists of the forest ``T_parent`` on ``device``."""
    par = np.asarray(T_parent, dtype=np.int64)
    Tn = par.size
    depth = np.full(Tn, -1, np.int64)
    depth[par < 0] = 0
    while np.any(depth < 0):
        todo = np.flatnonzero(depth < 0)
        ready = todo[depth[par[todo]] >= 0]
        if not ready.size:
            raise ValueError("T_parent is not a forest")
        depth[ready] = depth[par[ready]] + 1
    order = np.lexsort((np.arange(Tn), depth)) if Tn else np.zeros(0, np.int64)
    n_lvl = int(depth.max()) + 1 if Tn else 0
    lvl_off = np.searchsorted(depth[order], np.arange(n_lvl + 1)).astype(np.int64)
    kids = np.flatnonzero(par >= 0)
    kids = kids[np.argsort(par[kids], kind="stable")]
    child_ptr = np.concatenate([[0], np.cumsum(np.bincount(par[kids], minlength=Tn))])
    folds = []
    for lv in range(n_lvl):
        nodes = order[lvl_off[lv] : lvl_off[lv + 1]]
        counts = child_ptr[nodes + 1] - child_ptr[nodes]
        K = int(counts.max()) if nodes.size else 0
        fold = np.full((nodes.size, K), -1, np.int64)
        for j in range(K):
            has = counts > j
            fold[has, j] = kids[child_ptr[nodes[has]] + j]
        folds.append(fold)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    return TForest(
        parent=i32(par), order=i32(order), lvl_off=i32(lvl_off), child_ptr=i32(child_ptr),
        child_idx=i32(kids if kids.size else np.zeros(1)), host_order=order,
        host_lvl_off=lvl_off, folds=tuple(folds),
    )


def t_solve_plain(tf: TForest, dT, rT, wT, sq_extra=None):
    """Eager version: ``(λ_T (Tn,), norm or None)``."""
    dt, dev = torch.float64, dT.device
    norm = None if sq_extra is None else torch.sqrt(sq_extra.reshape(()) + torch.sum(rT * rT))
    d, r = dT.clone(), rT.clone()
    zero = torch.zeros(1, dtype=dt, device=dev)
    order, off = tf.host_order, tf.host_lvl_off
    for lv in range(tf.n_lvl - 2, -1, -1):
        fold = tf.folds[lv]
        if fold.shape[1] == 0:
            continue
        nodes = torch.as_tensor(order[off[lv] : off[lv + 1]], device=dev)
        factor = wT / d
        cd = torch.cat([-wT * factor, zero])
        cr = torch.cat([factor * r, zero])
        idx = torch.as_tensor(np.where(fold >= 0, fold, dT.shape[0]), device=dev)
        ud, ur = cd[idx[:, 0]], cr[idx[:, 0]]
        for j in range(1, fold.shape[1]):
            ud = ud + cd[idx[:, j]]
            ur = ur + cr[idx[:, j]]
        d[nodes] = d[nodes] + ud
        r[nodes] = r[nodes] + ur
    lam = torch.zeros_like(dT)
    par = tf.parent.long().to(dev)
    for lv in range(tf.n_lvl):
        nodes = torch.as_tensor(order[off[lv] : off[lv + 1]], device=dev)
        p = par[nodes]
        lam_p = torch.where(p >= 0, lam[p.clamp(min=0)], 0.0)
        lam[nodes] = torch.where(p >= 0, (r[nodes] + wT[nodes] * lam_p) / d[nodes],
                                 r[nodes] / d[nodes])
    return lam, norm


def t_solve(tf: TForest, dT, rT, wT, sq_extra=None):
    """The T solve on ``dT``'s device: ``(λ_T, sqrt(sq_extra + ‖r_T‖²) or None)``."""
    if dT.device.type == "cpu":
        return t_solve_plain(tf, dT, rT, wT, sq_extra)
    if tf.Tn == 0 and sq_extra is None:
        return dT[:0].clone(), None
    extra = [] if sq_extra is None else [sq_extra]
    build.require_cuda("t_solve", dT, rT, wT, *extra)
    build.require_cuda("t_solve", tf.order, tf.lvl_off, tf.child_ptr, tf.child_idx, tf.parent,
                       dtype=torch.int32)
    Tn = tf.Tn
    if any(tuple(t.shape) != (Tn,) for t in (dT, rT, wT)):
        raise ValueError("t_solve: dT, rT and wT must be (Tn,)")
    if Tn > 4096:
        raise ValueError("t_solve: at most 4,096 T nodes")
    dev, dt = dT.device, torch.float64
    d, r, lam = (torch.empty(max(Tn, 1), dtype=dt, device=dev) for _ in range(3))
    norm = None if sq_extra is None else torch.empty((), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_t_solve(
            Tn, tf.n_lvl, tf.order.data_ptr(), tf.lvl_off.data_ptr(), tf.child_ptr.data_ptr(),
            tf.child_idx.data_ptr(), tf.parent.data_ptr(), dT.data_ptr(), rT.data_ptr(),
            wT.data_ptr(), None if sq_extra is None else sq_extra.data_ptr(),
            d.data_ptr(), r.data_ptr(), lam.data_ptr(),
            None if norm is None else norm.data_ptr(), build.stream_handle(dev),
        )
    build.check(code, "t_solve")
    T_SOLVE.launches += 1
    return lam[:Tn], norm
