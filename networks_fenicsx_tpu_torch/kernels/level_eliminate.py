"""K7: level-ordered elimination of a general forest (``csrc/level_eliminate.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_level_eliminate`` and
``_level_eliminate_core2`` (``:2131-2241``): from the condensed edge data,
assemble the per-bifurcation diagonal and rhs in the level plan's permuted
order (three sorted-segment sums, K6), take ``‖rhs‖`` before any fold, fold
the levels into their parents deepest first, back-substitute ``λ`` root
down and un-permute it to the public bifurcation order.

:func:`level_eliminate` launches the kernels for CUDA tensors — a prepare
pass, the three K6 sums (:func:`.segsum.segsum`), then one launcher that
runs the assembly, the norm, one fold and one back-substitution launch per
level and the un-permute — and runs :func:`level_eliminate_plain`, the eager
transcription of the reference, for CPU tensors.
"""

from __future__ import annotations

import torch

from ..edge_data import _EdgeData
from ..levels import DeviceLevelPlan
from . import build, segsum

__all__ = ["level_eliminate", "level_eliminate_plain", "cuda_launches"]


def cuda_launches(dlp: DeviceLevelPlan) -> int:
    """CUDA kernel launches of one :func:`level_eliminate` call: prepare,
    three segment sums, assemble, norm, ``L - 1`` folds, ``L``
    back-substitutions and the un-permute."""
    L = dlp.num_levels
    sums = (1 if dlp.num_pairs else 0) + 2
    return 1 + sums + 2 + (L - 1) + L + 1


def _prepare_plain(ed: _EdgeData):
    """``(w, (w, const + Ftot), (w, -const))`` per edge (reference ``:2137-2154``)."""
    w_edges = 1.0 / ed.W
    s_is_bif = ed.start_bif >= 0
    t_is_bif = ed.end_bif >= 0
    const = (-ed.start_pbc * (~s_is_bif) + ed.end_pbc * (~t_is_bif) - ed.g) / ed.W
    Ftot = ed.cumF[-1]
    return (
        w_edges,
        torch.stack([w_edges, const + Ftot], dim=-1),
        torch.stack([w_edges, -const], dim=-1),
    )


def level_eliminate_plain(dlp: DeviceLevelPlan, ed: _EdgeData):
    """Eager version: returns ``(λ (B,) public order, ‖rhs‖)``."""
    dt, dev = torch.float64, ed.W.device
    B = dlp.num_bifurcations
    w_edges, vt, vs = _prepare_plain(ed)
    if dlp.num_pairs > 0:
        w_pairs = segsum.segsum_plain(dlp.p_idx, w_edges)
    else:
        w_pairs = torch.zeros(0, dtype=dt, device=dev)
    dr = segsum.segsum_plain(dlp.t_idx, vt) + segsum.segsum_plain(dlp.s_idx, vs)
    rhs_norm = torch.linalg.norm(dr[:, 1])

    pp = dlp.parent_pair.long()
    if w_pairs.shape[0]:
        w_node = torch.where(pp >= 0, w_pairs[torch.clamp(pp, min=0)], 0.0)
    else:
        w_node = torch.zeros(B, dtype=dt, device=dev)
    offs = dlp.level_offsets
    L = len(offs) - 1
    for lev in range(L - 1, 0, -1):  # forward: deepest level first
        o, o1, op = offs[lev], offs[lev + 1], offs[lev - 1]
        db, rb = dr[o:o1, 0], dr[o:o1, 1]
        w = w_node[o:o1]
        factor = w / db
        upd = segsum.segsum_plain(dlp.fold_idx[lev - 1], torch.stack([-w * factor, factor * rb], dim=-1))
        dr[op:o] = dr[op:o] + upd
    lam = torch.empty(B, dtype=dt, device=dev)
    lam[: offs[1]] = dr[: offs[1], 1] / dr[: offs[1], 0]  # roots
    parent = dlp.parent_pos.long()
    for lev in range(1, L):  # back-substitution: root down
        o, o1 = offs[lev], offs[lev + 1]
        lam[o:o1] = (dr[o:o1, 1] + w_node[o:o1] * lam[parent[o:o1]]) / dr[o:o1, 0]
    return lam[dlp.perm.long()], rhs_norm


def level_eliminate(dlp: DeviceLevelPlan, ed: _EdgeData):
    """K7 (with its K6 sums) on the edge data's device: ``(λ, ‖rhs‖)``."""
    if ed.W.device.type == "cpu":
        return level_eliminate_plain(dlp, ed)
    Ftot = ed.cumF[-1]
    build.require_cuda("level_eliminate", ed.W, ed.g, Ftot, ed.start_pbc, ed.end_pbc)
    build.require_cuda(
        "level_eliminate", dlp.start_bif, dlp.end_bif, dlp.parent_pos, dlp.parent_pair,
        dlp.child_ptr, dlp.perm, dtype=torch.int32,
    )
    E, B = dlp.num_edges, dlp.num_bifurcations
    if any(tuple(t.shape) != (E,) for t in (ed.W, ed.g, Ftot, ed.start_pbc, ed.end_pbc)):
        raise ValueError("level_eliminate: the edge data must be (E,) per edge")
    dev = ed.W.device
    dt = torch.float64
    w_edges = torch.empty(E, dtype=dt, device=dev)
    vt = torch.empty((E, 2), dtype=dt, device=dev)
    vs = torch.empty((E, 2), dtype=dt, device=dev)
    lib = build.library()
    stream = build.stream_handle(dev)
    with torch.cuda.device(dev):
        code = lib.nxfx_level_prepare(
            E, ed.W.data_ptr(), ed.g.data_ptr(), Ftot.data_ptr(),
            ed.start_pbc.data_ptr(), ed.end_pbc.data_ptr(),
            dlp.start_bif.data_ptr(), dlp.end_bif.data_ptr(),
            w_edges.data_ptr(), vt.data_ptr(), vs.data_ptr(), stream,
        )
    build.check(code, "level_eliminate")
    w_pairs = segsum.segsum(dlp.p_idx, w_edges)
    dt_t = segsum.segsum(dlp.t_idx, vt)
    dt_s = segsum.segsum(dlp.s_idx, vs)
    d, r, wn, lam_perm, lam = (torch.empty(B, dtype=dt, device=dev) for _ in range(5))
    rhs_norm = torch.zeros((), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = lib.nxfx_level_eliminate(
            B, dlp.num_levels, dlp.host_offsets.ctypes.data,
            dlp.parent_pos.data_ptr(), dlp.parent_pair.data_ptr(),
            dlp.child_ptr.data_ptr(), dlp.perm.data_ptr(),
            w_pairs.data_ptr(), dt_t.data_ptr(), dt_s.data_ptr(),
            d.data_ptr(), r.data_ptr(), wn.data_ptr(), lam_perm.data_ptr(), lam.data_ptr(),
            rhs_norm.data_ptr(), stream,
        )
    build.check(code, "level_eliminate")
    level_eliminate.launches += 1
    return lam, rhs_norm


level_eliminate.launches = 0
