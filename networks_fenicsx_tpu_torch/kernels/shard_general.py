"""K22d: the per-shard body of the general sharded solve, on the kernels of
``csrc/peel.cu``, ``csrc/segsum.cu`` and ``csrc/gather_matvec.cu``.

Replaces ``networks_fenicsx_tpu/parallel/sharding.py:_sharded_schur_pipeline``'s
``local_solve`` (``:248-323``) around the psum and the replicated λ solve:

* :func:`partials` — the shard's row of the reduce from its K8a edge data:
  the λ-system partials ``(diag, rhs)`` interleaved as ``(B, 2)`` and the
  per-pair conductances ``w_pairs (P,)`` (``:254-286``), through host-sorted
  per-shard tables (:func:`shard_lambda_tables`): the prepare pass of K9's
  ``lambda_system`` and one K6 launch (the tables' :class:`.segsum.SumPlan`,
  made at the first call) for the two sides' sums into the sorted unique
  bifurcations and the sum into the pairs; ``[dr (2B) | w_pairs (P)]``,
  and the shard's ``w = 1/W``;
* :func:`offdiag` — the shard's part of the CG matvec (``:310-314``): K19b's
  gather-fold on the half-edges of the shard's edges, ``diag·x`` on shard 0
  and 0 elsewhere, so that the reduce gives ``L x``.

Each wrapper launches the kernels for CUDA tensors and runs its plain
version, the same sums in the same order, for CPU tensors; both count on
``LAUNCHES``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..edge_data import _EdgeData
from ..lattice import gather_matvec_tables
from ..levels import segsum_matrix
from . import build, gather_matvec, segsum
from .level_eliminate import _prepare_plain

__all__ = ["LAUNCHES", "ShardLambdaTables", "shard_lambda_tables", "partials", "partials_plain",
           "offdiag", "offdiag_plain"]

LAUNCHES = build.Counter("shard_general")


@dataclasses.dataclass(frozen=True)
class ShardLambdaTables:
    """One shard's tables on its device (int32).

    Attributes:
        start_bif, end_bif: ``(E_s,)`` the shard's edge ends (global
            bifurcations, ``-1`` at a boundary or a padding edge).
        t_idx, t_bins, s_idx, s_bins: the K6 tables of the two sides' sums
            (``(S, K)`` gather matrices over the shard's edges, the sorted
            unique bifurcations they add into).
        pair_idx: ``(P, K)`` K6 gather matrix of the shard's edges into pairs.
        mv_edge, mv_other: ``(K, B)`` K19b tables of the shard's half-edges
            (None unless the CG branch runs).
        B: bifurcations.
    """

    start_bif: torch.Tensor
    end_bif: torch.Tensor
    t_idx: torch.Tensor
    t_bins: torch.Tensor
    s_idx: torch.Tensor
    s_bins: torch.Tensor
    pair_idx: torch.Tensor
    mv_edge: torch.Tensor | None
    mv_other: torch.Tensor | None
    B: int

    @property
    def P(self) -> int:
        return int(self.pair_idx.shape[0])

    @functools.cached_property
    def sums(self) -> segsum.SumPlan:
        """K6's plan of the partials: the two sides into ``dr (B, 2)``, then
        the pairs (made and validated once, at the first kernel call)."""
        groups = ((self.t_idx, self.t_bins), (self.s_idx, self.s_bins))
        if self.P:
            return segsum.SumPlan(groups + ((self.pair_idx, None),), (2, 2, 1), rows=self.B)
        return segsum.SumPlan(groups, (2, 2), rows=self.B)


def shard_lambda_tables(start_bif, end_bif, edge_pair, B: int, P: int, device,
                        matvec: bool = False) -> ShardLambdaTables:
    """The tables of a shard whose edges have ends ``start_bif``/``end_bif``
    and pair ids ``edge_pair`` (``-1`` none), host arrays over its edges."""
    sb = np.asarray(start_bif, np.int64)
    eb = np.asarray(end_bif, np.int64)
    E = sb.size

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    def side(bif):
        sel = np.flatnonzero(bif >= 0)
        order = sel[np.argsort(bif[sel], kind="stable")]
        bins, seg = np.unique(bif[order], return_inverse=True)
        return i32(segsum_matrix(seg, bins.size, E, sel=order)), i32(bins)

    t_idx, t_bins = side(eb)
    s_idx, s_bins = side(sb)
    ep = np.asarray(edge_pair, np.int64)
    sel = np.flatnonzero(ep >= 0)
    order = np.argsort(ep[sel], kind="stable")
    pair_idx = i32(segsum_matrix(ep[sel][order], P, E, sel=sel[order]))
    mv_edge = mv_other = None
    if matvec:
        e = np.flatnonzero((sb >= 0) & (eb >= 0))
        own = np.concatenate([eb[e], sb[e]])
        other = np.concatenate([sb[e], eb[e]])
        edge = np.concatenate([e, e])
        o = np.argsort(own, kind="stable")
        tables = gather_matvec_tables(
            (edge[o].astype(np.int32), other[o].astype(np.int32), own[o].astype(np.int32)), B)
        mv_edge, mv_other = i32(tables[0]), i32(tables[1])
    return ShardLambdaTables(i32(sb), i32(eb), t_idx, t_bins, s_idx, s_bins, pair_idx,
                             mv_edge, mv_other, int(B))


def partials_plain(tab: ShardLambdaTables, ed: _EdgeData):
    """Eager version: ``([dr (2B) | w_pairs (P)], w (E_s,))``."""
    w_edges, vt, vs = _prepare_plain(ed)
    dr = torch.zeros((tab.B, 2), dtype=torch.float64, device=ed.W.device)
    segsum.segsum_plain(tab.t_idx, vt, tab.t_bins, dr)
    segsum.segsum_plain(tab.s_idx, vs, tab.s_bins, dr)
    if tab.P:
        w_pairs = segsum.segsum_plain(tab.pair_idx, w_edges)
    else:
        w_pairs = torch.zeros(0, dtype=torch.float64, device=ed.W.device)
    return torch.cat([dr.reshape(-1), w_pairs]), w_edges


def partials(tab: ShardLambdaTables, ed: _EdgeData):
    """K22d's partials on the edge data's device (see the module docs)."""
    if ed.W.device.type == "cpu":
        return partials_plain(tab, ed)
    Ftot = ed.cumF[-1]
    build.require_cuda("shard_general", ed.W, ed.g, Ftot, ed.start_pbc, ed.end_pbc)
    build.require_cuda("shard_general", tab.start_bif, tab.end_bif, tab.t_idx, tab.t_bins,
                       tab.s_idx, tab.s_bins, tab.pair_idx, dtype=torch.int32)
    E, B, P = int(tab.start_bif.shape[0]), tab.B, tab.P
    if any(tuple(t.shape) != (E,) for t in (ed.W, ed.g, Ftot, ed.start_pbc, ed.end_pbc)):
        raise ValueError("shard_general: the edge data must be (E_s,) per edge")
    dev, dt = ed.W.device, torch.float64
    part = torch.empty(2 * B + P, dtype=dt, device=dev)
    w_edges = torch.empty(E, dtype=dt, device=dev)
    vt = torch.empty((E, 2), dtype=dt, device=dev)
    vs = torch.empty((E, 2), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_lambda_prepare(
            E, ed.W.data_ptr(), ed.g.data_ptr(), Ftot.data_ptr(),
            ed.start_pbc.data_ptr(), ed.end_pbc.data_ptr(),
            tab.start_bif.data_ptr(), tab.end_bif.data_ptr(),
            w_edges.data_ptr(), vt.data_ptr(), vs.data_ptr(), build.stream_handle(dev),
        )
    build.check(code, "shard_general")
    dr = part[: 2 * B].view(B, 2)
    if P:
        segsum.launch_plan(tab.sums, (vt, vs, w_edges), (dr, part[2 * B :]), "shard_general")
    else:
        segsum.launch_plan(tab.sums, (vt, vs), (dr,), "shard_general")
    LAUNCHES.launches += 1
    return part, w_edges


def offdiag_plain(tab: ShardLambdaTables, w_edges, diag, x) -> torch.Tensor:
    """Eager version: ``diag·x − Σ_k w[mv_edge]·x[mv_other]`` over the
    shard's half-edges."""
    return gather_matvec.gather_matvec_plain(tab.mv_edge, tab.mv_other, w_edges, diag, x)


def offdiag(tab: ShardLambdaTables, w_edges, diag, x) -> torch.Tensor:
    """K22d's matvec part on ``x``'s device: ``(B,)``."""
    if x.device.type == "cpu":
        return offdiag_plain(tab, w_edges, diag, x)
    build.require_cuda("shard_general", w_edges, diag, x)
    build.require_cuda("shard_general", tab.mv_edge, tab.mv_other, dtype=torch.int32)
    B = tab.B
    if tuple(diag.shape) != (B,) or tuple(x.shape) != (B,):
        raise ValueError("shard_general: diag and x must be (B,)")
    out = torch.empty(B, dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        code = build.library().nxfx_gather_apply(
            B, tab.mv_edge.shape[0], tab.mv_edge.data_ptr(), tab.mv_other.data_ptr(),
            w_edges.data_ptr(), diag.data_ptr(), x.data_ptr(), None, out.data_ptr(), None, None,
            build.stream_handle(x.device),
        )
    build.check(code, "shard_general")
    LAUNCHES.launches += 1
    return out
