"""Lattice planners of the bifurcation graph (host NumPy + SciPy).

Counterpart of ``networks_fenicsx_tpu/solver.py``: ``_directed_half_edges``
(``:740-749``), ``_plan_shift_matvec`` (``:765-796``), ``_DctPlan`` and
``_plan_dct_lattice`` (``:829-924``) and ``lattice_solve_applicable``
(``:3853-3870``).  The same inputs give ``np.array_equal`` plans.

The port's routing reads only :func:`lattice_solve_applicable`: a
scalar-R uniform lattice whose cycle core exceeds the dense cutoff takes
the reference's exact separable-DCT solve, which is ROADMAP A7; that item
runs on these plans.
"""

from __future__ import annotations

import typing

import numpy as np

__all__ = ["lattice_solve_applicable"]


def _directed_half_edges(asm):
    """The two directed half-edges of every interior (bif-bif) edge:
    ``(own, other, edge_id)`` arrays."""
    s = np.asarray(asm._edge_start_bif)
    t = np.asarray(asm._edge_end_bif)
    e = np.flatnonzero((s >= 0) & (t >= 0))
    own = np.concatenate([t[e], s[e]])
    other = np.concatenate([s[e], t[e]])
    edge = np.concatenate([e, e])
    return own, other, edge


def _plan_shift_matvec(asm, max_classes: int = 16):
    """Shift-class decomposition of the λ-graph matvec, or None.

    Groups the directed off-diagonal contributions ``row i ← col j`` by
    the constant index offset ``δ = j − i``; None beyond ``max_classes``
    distinct offsets.  Returns a list of ``(delta, rows_sorted, edge_sel)``.
    """
    own, other, eidx = _directed_half_edges(asm)
    if eidx.size == 0:
        return None
    i, j = own, other  # row pulls from column: out[i] -= w * lam[j]
    delta = j - i
    deltas = np.unique(delta)
    if deltas.size > max_classes:
        return None
    classes = []
    for d in deltas:
        m = delta == d
        rows = i[m]
        order = np.argsort(rows, kind="stable")
        classes.append((int(d), rows[order].astype(np.int32), eidx[m][order]))
    return classes


class _DctPlan(typing.NamedTuple):
    """Host plan of the separable-DCT direct λ solve (ROADMAP A7)."""

    s: int  # row stride (lattice width nx)
    ny: int
    rep_x: int  # representative x-edge id (runtime w_x = 1/W)
    rep_y: int
    len_x: float  # geometric x-edge length
    stub_rows: np.ndarray  # (r,) λ rows carrying boundary-stub coupling
    stub_edge_idx: np.ndarray  # stub edge ids (runtime w_r = Σ 1/W)
    stub_edge_group: np.ndarray  # group index (into stub_rows) per stub edge
    g_geo: np.ndarray  # (r, B) geometric L⁺ columns at the stub rows
    lamx: np.ndarray  # (s,) Neumann path eigenvalues 2−2cos(πk/s)
    lamy: np.ndarray


def _plan_dct_lattice(asm, shift_plan):
    """Exact direct λ solve plan for uniform rectangular lattices, or None.

    The structure checks of the reference: four shift classes {±1, ±s}
    with the exact grid row patterns, uniform edge length per class, and
    at most 16 boundary-stub edges."""
    if shift_plan is None:
        return None
    deltas = sorted(c[0] for c in shift_plan)
    if len(deltas) != 4:
        return None
    s = deltas[3]
    if deltas != [-s, -1, 1, s] or s <= 2:
        return None
    mesh = asm.network
    B = mesh.num_multipliers
    if B % s != 0:
        return None
    ny = B // s
    if ny < 2:
        return None
    idx = np.arange(B)
    want = {
        1: idx[idx % s != s - 1],
        -1: idx[idx % s != 0],
        s: idx[: B - s],
        -s: idx[s:],
    }
    L_all = np.asarray(mesh.edge_length)
    lens: dict[int, float] = {}
    rep: dict[int, int] = {}
    for d, rows, esel in shift_plan:
        if not np.array_equal(np.sort(rows), want[d]):
            return None
        Ld = L_all[esel]
        if Ld.size == 0 or not np.allclose(Ld, Ld[0], rtol=1e-12, atol=0.0):
            return None
        prev = lens.get(abs(d))
        if prev is not None and not np.isclose(prev, Ld[0], rtol=1e-12):
            return None
        lens[abs(d)] = float(Ld[0])
        rep[d] = int(esel[0])
    # boundary stubs: edges with exactly one multiplier endpoint
    sb = np.asarray(asm._edge_start_bif)
    eb = np.asarray(asm._edge_end_bif)
    one = (sb >= 0) ^ (eb >= 0)
    stub_e = np.nonzero(one)[0]
    if stub_e.size == 0 or stub_e.size > 16:
        return None
    stub_row = np.where(sb[stub_e] >= 0, sb[stub_e], eb[stub_e])
    rows_u, group = np.unique(stub_row, return_inverse=True)

    import scipy.fft as _sfft

    lamx = 2.0 - 2.0 * np.cos(np.pi * np.arange(s) / s)
    lamy = 2.0 - 2.0 * np.cos(np.pi * np.arange(ny) / ny)
    sym = (1.0 / lens[1]) * lamx[None, :] + (1.0 / lens[s]) * lamy[:, None]
    sym[0, 0] = np.inf
    g = np.empty((rows_u.size, B))
    for t, row in enumerate(rows_u):
        e = np.zeros(B)
        e[int(row)] = 1.0
        c = _sfft.dctn(e.reshape(ny, s), type=2, norm="ortho") / sym
        g[t] = _sfft.idctn(c, type=2, norm="ortho").reshape(-1)
    return _DctPlan(
        s, ny, rep[1], rep[s], lens[1],
        rows_u.astype(np.int64), stub_e.astype(np.int64),
        group.astype(np.int64), g, lamx, lamy,
    )


def lattice_solve_applicable(asm) -> bool:
    """Would the reference's exact separable-DCT lattice solve engage?

    True when the multiplier graph is a uniform rectangular lattice
    (``make_grid`` family) and the resistance coefficient is scalar."""
    if asm.network.num_multipliers == 0:
        return False
    R_mode, _, _ = asm.coefficient_modes()
    if R_mode != "scalar":
        return False
    shift_plan = _plan_shift_matvec(asm)
    if shift_plan is None:
        return False
    return _plan_dct_lattice(asm, shift_plan) is not None
