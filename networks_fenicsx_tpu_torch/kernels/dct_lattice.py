"""K16: the separable-DCT capacitance λ solve of a uniform lattice (``csrc/dct_lattice.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_dct_capacitance_factor``,
``_dct_capacitance_apply``, ``_dct2_matrix_device`` and
``_dct_lattice_solve`` (``:927-1102``).  On a uniform rectangular lattice
with scalar R the bifurcation Laplacian is ``wx (I ⊗ Lx) + wy (Ly ⊗ I) + D_s``
with ``Lx``, ``Ly`` Neumann path Laplacians, which the orthonormal DCT-II
diagonalises, and ``D_s`` the boundary-stub coupling at ``r ≤ 16`` rows.
λ solves exactly by one transform solve of the singular separable part
plus an ``(r+1) × (r+1)`` bordered system, then two refinement passes
against the exact matvec (K17's stencil on the grid route, K18's shift
classes on the general one), which the caller passes as
``residual(λ) = rhs − L λ``.

The reference inverts the bordered matrix in float32 and polishes it with
Newton steps, and transforms its refinement passes in float32, because the
TPU's LU and matrix unit are float32; the card has native float64, so the
port inverts and transforms in float64 throughout and keeps the pass count.

* :func:`dct_operator` — the per-executor state: the DCT-II matrices (host
  constants up to :data:`..lattice.HOST_DCT_MAX` per side, generated on the
  device above), the eigenvalues, the geometric stub columns and tables;
* :func:`dct_lattice` — one solve: factor (``inv``, ``g``, ``M⁻¹``), one
  direct pass, ``n_refine`` refinement passes.

:func:`dct_lattice` launches the kernels for CUDA tensors and runs
:func:`dct_lattice_plain` (``torch.matmul`` for the four products) for CPU
tensors.  Its ``launches`` counts solves.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import numpy as np
import torch

from ..lattice import HOST_DCT_MAX, _dct2_matrix, _dct2_matrix_device, _DctPlan
from . import build

__all__ = ["DctOperator", "DctState", "dct_operator", "dct_matrix", "dct_lattice",
           "dct_lattice_plain", "factor_plain", "transform", "transform_plain", "lplus_plain",
           "direct_plain", "N_REFINE"]

N_REFINE = 2  # refinement passes after the direct one (reference ``:1097``)

Residual = typing.Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DctOperator:
    """K16's state on one device, built once per executor.

    Attributes:
        s, ny: Lattice width (row stride) and height; ``B = s·ny``.
        len_x: The geometric x-edge length (``κ = 1/(wx·len_x)``).
        Dx, Dy: ``(s, s)`` and ``(ny, ny)`` orthonormal DCT-II matrices.
        lamx, lamy: ``(s,)``, ``(ny,)`` Neumann path eigenvalues.
        g_geo: ``(r, B)`` geometric L⁺ columns at the stub rows.
        stub_rows: ``(r,)`` int32 λ rows of the stubs (sorted, unique).
        stub_edge, stub_group: ``(n_stub,)`` int32 stub edges (in the
            executor's edge order) and their row group.
        rep_x, rep_y: The edges whose conductance is ``wx``, ``wy``.
    """

    s: int
    ny: int
    len_x: float
    Dx: torch.Tensor
    Dy: torch.Tensor
    lamx: torch.Tensor
    lamy: torch.Tensor
    g_geo: torch.Tensor
    stub_rows: torch.Tensor
    stub_edge: torch.Tensor
    stub_group: torch.Tensor
    rep_x: int
    rep_y: int

    @property
    def r(self) -> int:
        return int(self.stub_rows.shape[0])

    @property
    def B(self) -> int:
        return self.s * self.ny


class DctState(typing.NamedTuple):
    """The conductance side of one solve (reference ``_dct_capacitance_factor``)."""

    inv: torch.Tensor  # (ny, s) inverse separable eigenvalues, 0 at the zero mode
    g: torch.Tensor  # (r, B) runtime-scaled stub columns
    Minv: torch.Tensor  # (r+1, r+1) inverse of the bordered matrix


def dct_matrix(n: int, device: torch.device | str) -> torch.Tensor:
    """The ``(n, n)`` DCT-II matrix of a side: the host constant up to
    :data:`HOST_DCT_MAX`, above it generated on ``device`` (K16's generator
    on the card, :func:`..lattice._dct2_matrix_device` on the CPU)."""
    device = torch.device(device)
    if n <= HOST_DCT_MAX:
        return torch.as_tensor(_dct2_matrix(n), device=device)
    if device.type == "cpu":
        return _dct2_matrix_device(n, device)
    D = torch.empty((n, n), dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        code = build.library().nxfx_dct_matrix(
            n, math.sqrt(2.0 / n), math.sqrt(0.5), D.data_ptr(), build.stream_handle(device))
    build.check(code, "dct_matrix")
    return D


def dct_operator(
    plan: _DctPlan, device: torch.device | str, stub_edge=None, stub_group=None, rep_x=None,
    rep_y=None,
) -> DctOperator:
    """Upload a DCT plan.  ``stub_edge`` (with its ``stub_group``), ``rep_x``
    and ``rep_y`` name the stub and representative edges in the executor's
    edge order (default: the plan's, public order)."""

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=device)

    return DctOperator(
        s=int(plan.s), ny=int(plan.ny), len_x=float(plan.len_x),
        Dx=dct_matrix(plan.s, device), Dy=dct_matrix(plan.ny, device),
        lamx=f64(plan.lamx), lamy=f64(plan.lamy), g_geo=f64(plan.g_geo),
        stub_rows=i32(plan.stub_rows),
        stub_edge=i32(plan.stub_edge_idx if stub_edge is None else stub_edge),
        stub_group=i32(plan.stub_edge_group if stub_group is None else stub_group),
        rep_x=int(plan.rep_x if rep_x is None else rep_x),
        rep_y=int(plan.rep_y if rep_y is None else rep_y),
    )


# ------------------------------------------------------------------ plain versions


def factor_plain(op: DctOperator, w: torch.Tensor) -> DctState:
    """Eager version of the factor: ``w`` is the ``(E,)`` conductances 1/W."""
    wx, wy = w[op.rep_x], w[op.rep_y]
    r = op.r
    sym = wx * op.lamx[None, :] + wy * op.lamy[:, None]
    pos = sym > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, sym, 1.0), 0.0)
    kappa = 1.0 / (wx * op.len_x)
    g = kappa * op.g_geo
    w_r = torch.zeros(r, dtype=w.dtype, device=w.device)
    for e, t in zip(op.stub_edge.tolist(), op.stub_group.tolist()):
        w_r[t] = w_r[t] + w[e]
    rows = op.stub_rows.long()
    M = torch.zeros((r + 1, r + 1), dtype=w.dtype, device=w.device)
    M[:r, :r] = g[:, rows].T + torch.diag(1.0 / w_r)
    M[:r, r] = -1.0
    M[r, :r] = 1.0
    return DctState(inv, g, torch.linalg.inv(M))


def transform_plain(op: DctOperator, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The 2-D DCT-II ``Dy x Dxᵀ`` of ``x (B,)``, or with ``inverse`` its
    inverse ``Dyᵀ x Dx``, flattened."""
    x2 = x.reshape(op.ny, op.s)
    return (op.Dy.T @ x2 @ op.Dx if inverse else op.Dy @ x2 @ op.Dx.T).reshape(-1)


def lplus_plain(op: DctOperator, state: DctState, b: torch.Tensor) -> torch.Tensor:
    """The separable pseudo-inverse ``Dyᵀ((Dy b Dxᵀ) ∘ inv) Dx`` of ``b (B,)``."""
    b2 = b.reshape(op.ny, op.s)
    c = op.Dy @ b2 @ op.Dx.T
    return (op.Dy.T @ (c * state.inv) @ op.Dx).reshape(-1)


def direct_plain(op: DctOperator, state: DctState, b: torch.Tensor) -> torch.Tensor:
    """One direct pass on ``b``: the transform solve and the bordered stub
    correction."""
    r = op.r
    z = lplus_plain(op, state, b)
    v = torch.cat([z[op.stub_rows.long()], torch.sum(b)[None]])
    sol = state.Minv @ v
    corr = sol[0] * state.g[0]
    for t in range(1, r):
        corr = corr + sol[t] * state.g[t]
    return z - corr + sol[r]


def dct_lattice_plain(
    op: DctOperator, w: torch.Tensor, rhs: torch.Tensor, residual: Residual,
    n_refine: int = N_REFINE,
) -> torch.Tensor:
    """Eager version of :func:`dct_lattice`."""
    state = factor_plain(op, w)
    lam = direct_plain(op, state, rhs)
    for _ in range(n_refine):
        lam = lam + direct_plain(op, state, residual(lam))
    return lam


# ------------------------------------------------------------------ kernels


def _factor(op: DctOperator, w: torch.Tensor) -> DctState:
    """The factor through K16's kernels (plain for a CPU tensor)."""
    if w.device.type == "cpu":
        return factor_plain(op, w)
    dev, dt = w.device, torch.float64
    r, B = op.r, op.B
    inv = torch.empty((op.ny, op.s), dtype=dt, device=dev)
    g = torch.empty((r, B), dtype=dt, device=dev)
    Minv = torch.empty((r + 1, r + 1), dtype=dt, device=dev)
    lib, stream = build.library(), build.stream_handle(dev)
    with torch.cuda.device(dev):
        code = lib.nxfx_dct_scale(
            op.s, op.ny, r, B, w.data_ptr(), op.rep_x, op.rep_y, op.len_x,
            op.lamx.data_ptr(), op.lamy.data_ptr(), op.g_geo.data_ptr(),
            inv.data_ptr(), g.data_ptr(), stream,
        )
        build.check(code, "dct_lattice")
        code = lib.nxfx_dct_minv(
            r, int(op.stub_edge.shape[0]), B, w.data_ptr(), op.stub_edge.data_ptr(),
            op.stub_group.data_ptr(), op.stub_rows.data_ptr(), g.data_ptr(), Minv.data_ptr(),
            stream,
        )
    build.check(code, "dct_lattice")
    return DctState(inv, g, Minv)


GEMM_TILE = (32, 64)  # the product kernel's output tile (rows, columns)
BLOCKS_PER_SM = 4  # product blocks to keep resident on each SM
BORDER_BLOCKS = 1024  # first-stage blocks of the border's sum (csrc BORDER_BLOCKS)


def gemm_split(M: int, N: int, K: int, sms: int) -> int:
    """How many blocks share one output tile's k range: enough tiles to keep
    about :data:`BLOCKS_PER_SM` blocks on each of ``sms`` SMs, at most 8,
    each at least 64 deep."""
    tiles = -(-M // GEMM_TILE[0]) * -(-N // GEMM_TILE[1])
    return max(1, min(8, BLOCKS_PER_SM * sms // tiles, K // 64))


def _gemm(lib, stream, M, N, K, A, transA, Bm, transB, C, S=None, work=None) -> None:
    split = gemm_split(M, N, K, torch.cuda.get_device_properties(C.device).multi_processor_count)
    if split > 1 and (work is None or work.numel() < split * M * N):
        work = torch.empty(split * M * N, dtype=torch.float64, device=C.device)
    code = lib.nxfx_dct_gemm(
        M, N, K, A.data_ptr(), int(transA), Bm.data_ptr(), int(transB),
        None if S is None else S.data_ptr(), C.data_ptr(), split,
        None if split == 1 else work.data_ptr(), stream,
    )
    build.check(code, "dct_lattice")


def transform(op: DctOperator, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """:func:`transform_plain` through K16's product kernel on the card
    (two launches, not counted: the solve's passes run the same kernel)."""
    if x.device.type == "cpu":
        return transform_plain(op, x, inverse)
    build.require_cuda("dct_lattice", x, op.Dx, op.Dy)
    s, ny = op.s, op.ny
    t = torch.empty((ny, s), dtype=torch.float64, device=x.device)
    out = torch.empty(ny * s, dtype=torch.float64, device=x.device)
    lib, stream = build.library(), build.stream_handle(x.device)
    with torch.cuda.device(x.device):
        _gemm(lib, stream, ny, s, ny, op.Dy, inverse, x, False, t)
        _gemm(lib, stream, ny, s, s, t, False, op.Dx, not inverse, out)
    return out


def _lplus(op: DctOperator, state: DctState, b: torch.Tensor) -> torch.Tensor:
    """The four products of one transform solve (two scratch grids; plain
    for a CPU tensor)."""
    if b.device.type == "cpu":
        return lplus_plain(op, state, b)
    dev = b.device
    s, ny = op.s, op.ny
    t1 = torch.empty((ny, s), dtype=torch.float64, device=dev)
    t2 = torch.empty((ny, s), dtype=torch.float64, device=dev)
    z = torch.empty(ny * s, dtype=torch.float64, device=dev)
    work = torch.empty(8 * ny * s, dtype=torch.float64, device=dev)  # split-K partials
    lib, stream = build.library(), build.stream_handle(dev)
    with torch.cuda.device(dev):
        _gemm(lib, stream, ny, s, ny, op.Dy, False, b, False, t1, work=work)  # Dy b
        _gemm(lib, stream, ny, s, s, t1, False, op.Dx, True, t2, S=state.inv,
              work=work)  # (· Dxᵀ) ∘ inv
        _gemm(lib, stream, ny, s, ny, op.Dy, True, t2, False, t1, work=work)  # Dyᵀ ·
        _gemm(lib, stream, ny, s, s, t1, False, op.Dx, False, z, work=work)  # · Dx
    return z


def _direct(op: DctOperator, state: DctState, b: torch.Tensor, lam: torch.Tensor | None = None):
    """One direct pass on ``b``; with ``lam``, returns ``lam`` plus it."""
    dev = b.device
    r, B = op.r, op.B
    z = _lplus(op, state, b)
    sol = torch.empty(r + 1, dtype=torch.float64, device=dev)
    partial = torch.empty(BORDER_BLOCKS, dtype=torch.float64, device=dev)
    out = torch.empty(B, dtype=torch.float64, device=dev)
    lib, stream = build.library(), build.stream_handle(dev)
    with torch.cuda.device(dev):
        code = lib.nxfx_dct_border(
            B, r, b.data_ptr(), z.data_ptr(), op.stub_rows.data_ptr(), state.Minv.data_ptr(),
            partial.data_ptr(), sol.data_ptr(), stream,
        )
        build.check(code, "dct_lattice")
        code = lib.nxfx_dct_correct(
            B, r, z.data_ptr(), state.g.data_ptr(), sol.data_ptr(),
            None if lam is None else lam.data_ptr(), out.data_ptr(), stream,
        )
    build.check(code, "dct_lattice")
    return out


def _require(op: DctOperator, w: torch.Tensor, rhs: torch.Tensor) -> None:
    build.require_cuda("dct_lattice", w, rhs, op.Dx, op.Dy, op.lamx, op.lamy, op.g_geo)
    build.require_cuda("dct_lattice", op.stub_rows, op.stub_edge, op.stub_group, dtype=torch.int32)
    if tuple(rhs.shape) != (op.B,) or w.dim() != 1:
        raise ValueError("dct_lattice: rhs must be (B,) and w (E,)")
    if not 1 <= op.r <= 16:
        raise ValueError("dct_lattice: 1 to 16 stub rows")


def dct_lattice(
    op: DctOperator, w: torch.Tensor, rhs: torch.Tensor, residual: Residual,
    n_refine: int = N_REFINE,
) -> torch.Tensor:
    """K16 on ``rhs``' device: ``λ (B,)`` of ``L λ = rhs`` from the
    conductances ``w = 1/W`` (E,) — the factor, one direct pass and
    ``n_refine`` passes on ``residual(λ) = rhs − L λ``."""
    if rhs.device.type == "cpu":
        return dct_lattice_plain(op, w, rhs, residual, n_refine)
    _require(op, w, rhs)
    state = _factor(op, w)
    lam = _direct(op, state, rhs)
    for _ in range(n_refine):
        res = residual(lam)
        build.require_cuda("dct_lattice", res)
        lam = _direct(op, state, res, lam)
    dct_lattice.launches += 1
    return lam


dct_lattice.launches = 0
