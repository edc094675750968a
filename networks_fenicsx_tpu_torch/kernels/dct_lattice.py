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
  direct pass, ``n_refine`` refinement passes;
* :func:`dct_apply` — the passes alone on a stored :class:`DctState` (the
  reference's ``_dct_capacitance_apply``; factor reuse): :func:`_factor`
  writes the state into tensors of its own, which no other solve touches,
  and each pass reads it (six launches a pass, 18 a solve; the same bits as
  :func:`dct_lattice` on the factor of the same ``w``).

* :func:`dct_factor_scenarios`, :func:`dct_apply_scenarios` — the factor
  and the passes over S scenarios (a sweep, S right-hand sides on one
  stored factor) in the launches of one: S factors in the factor's two,
  each pass's six over S factors or one read at stride 0, row ``i`` the
  one-scenario call's bits on row ``i`` (each product keeps one scenario's
  k split); the scenarios' grids, border partials, ``sol`` and tickets are
  the calling stream's scenario scratch (:meth:`DctOperator.scenario_scratch`).

:func:`dct_lattice` launches the kernels for CUDA tensors and runs
:func:`dct_lattice_plain` (``torch.matmul`` for the four products) for CPU
tensors.  Its ``launches`` counts solves; :func:`cuda_launches` gives the
kernel launches of one (20 at two refinement passes: the factor's two and
six a pass — four products on the float64 tensor cores, the border and
the correction — issued a pass at a time by one library call).  The
operator is validated once, at construction, reads the device's SM count
once and plans each product's k split (:func:`gemm_plan`); it holds the
scratch of every calling stream (the factor, the transform grids, the
border's partial sums, ``sol`` and its ticket, which the kernel resets
itself), so a solve checks only ``w``, ``rhs`` and each residual,
allocates only ``λ`` (updated in place by the refinement passes) and
launches on the raw stream.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import typing

import numpy as np
import torch

from ..lattice import HOST_DCT_MAX, _dct2_matrix, _dct2_matrix_device, _DctPlan
from . import build

__all__ = ["DctOperator", "DctState", "dct_operator", "dct_matrix", "dct_lattice",
           "dct_lattice_plain", "factor_plain", "transform", "transform_plain", "lplus_plain",
           "direct_plain", "product", "product_plain", "gemm_plan", "cuda_launches", "N_REFINE",
           "dct_apply", "dct_apply_plain", "apply_launches", "dct_factor", "dct_factor_scenarios",
           "dct_factor_scenarios_plain", "dct_apply_scenarios", "dct_apply_scenarios_plain"]

N_REFINE = 2  # refinement passes after the direct one (reference ``:1097``)

Residual = typing.Callable[[torch.Tensor], torch.Tensor]


TILE = (64, 64)  # the product kernel's output tile (csrc BM, BN)
SLAB_K = 32  # the k depth of a staged slab (csrc BK)
MAX_SPLIT = 8  # blocks sharing one tile's k range, one cluster (csrc MAX_SPLIT)
MAX_ROWS = 16  # stub rows the bordered matrix takes (csrc MAX_BORDER - 1)
BORDER_BLOCKS = 256  # the border's blocks at most, one partial sum each (csrc BORDER_BLOCKS)


def gemm_plan(M: int, N: int, K: int, sms: int) -> int:
    """The product kernel's k split for ``op(A) (M, K) op(B) (K, N)`` on
    ``sms`` SMs: the tile's k range shared by as many blocks (one cluster)
    as fill the SMs once, a power of two up to :data:`MAX_SPLIT`, each at
    least 64 deep (a 512² product: 64 tiles of 64 × 64, each over two
    blocks of 256).  Returns the blocks a tile, as the kernel counts them."""
    tiles = -(-M // TILE[0]) * -(-N // TILE[1])
    split = 1
    while 2 * split <= min(MAX_SPLIT, sms // tiles, K // 64):
        split *= 2
    kchunk = -(-(-(-K // split)) // SLAB_K) * SLAB_K
    return -(-K // kchunk)


@dataclasses.dataclass(frozen=True)
class DctOperator:
    """K16's state on one device, built once per executor.

    Validated once, at construction: the float64 matrices, eigenvalues and
    columns and the int32 tables contiguous, with data, on one device and
    of the shapes below, the representative and stub edges non-negative;
    on CUDA also 1 to :data:`MAX_ROWS` stub rows.  A ``ValueError``
    otherwise.

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
        index: The CUDA device index (-1 off CUDA).
        n_edges: The least length of ``w`` (one past the largest edge read).
        plans: The products' :func:`gemm_plan` splits on the device (CUDA
            only): ``(Dy-side, Dx-side)``, k = ``ny`` and k = ``s``.
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
    index: int = dataclasses.field(init=False, compare=False)
    n_edges: int = dataclasses.field(init=False, compare=False)
    plans: tuple = dataclasses.field(init=False, compare=False)
    # the scratch of each calling stream: {raw stream handle: _Scratch}
    _scratch: dict = dataclasses.field(init=False, compare=False, repr=False)
    # the scenario scratch of each calling stream: {raw stream handle: _ScenScratch}
    _scen_scratch: dict = dataclasses.field(init=False, compare=False, repr=False)

    def __post_init__(self):
        s, ny, r = self.s, self.ny, int(self.stub_rows.shape[0])
        n_stub = int(self.stub_edge.shape[0])
        dev = self.Dx.device
        if dev.type == "meta":
            raise ValueError("DctOperator: tensors must hold data (a meta tensor has none)")
        shapes = {"Dx": (self.Dx, (s, s), torch.float64), "Dy": (self.Dy, (ny, ny), torch.float64),
                  "lamx": (self.lamx, (s,), torch.float64), "lamy": (self.lamy, (ny,), torch.float64),
                  "g_geo": (self.g_geo, (r, s * ny), torch.float64),
                  "stub_rows": (self.stub_rows, (r,), torch.int32),
                  "stub_edge": (self.stub_edge, (n_stub,), torch.int32),
                  "stub_group": (self.stub_group, (n_stub,), torch.int32)}
        for name, (t, shape, dtype) in shapes.items():
            if t.device != dev:
                raise ValueError("DctOperator: tensors must share one device")
            if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"DctOperator: {name} must be a contiguous {shape} {dtype} tensor, "
                                 f"got {t.dtype} {tuple(t.shape)}")
        if s < 1 or ny < 1 or min(self.rep_x, self.rep_y) < 0:
            raise ValueError("DctOperator: an empty lattice or a negative edge")
        edge_min, edge_max = (torch.stack([self.stub_edge.min(), self.stub_edge.max()]).tolist()
                              if n_stub else (0, -1))  # one device read
        if edge_min < 0:
            raise ValueError("DctOperator: a negative stub edge")
        cuda = dev.type == "cuda"
        if cuda and not 1 <= r <= MAX_ROWS:
            raise ValueError(f"DctOperator: 1 to {MAX_ROWS} stub rows on CUDA, got {r}")
        plans = ()
        if cuda:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            plans = (gemm_plan(ny, s, ny, sms), gemm_plan(ny, s, s, sms))
        object.__setattr__(self, "index", dev.index if cuda else -1)
        object.__setattr__(self, "n_edges", max(self.rep_x, self.rep_y, edge_max) + 1)
        object.__setattr__(self, "plans", plans)
        object.__setattr__(self, "_scratch", {})
        object.__setattr__(self, "_scen_scratch", {})

    @property
    def r(self) -> int:
        return int(self.stub_rows.shape[0])

    @property
    def B(self) -> int:
        return self.s * self.ny

    def scratch(self, stream: int) -> "_Scratch":
        """The scratch of the CUDA stream ``stream``, made (zeroed) on that
        stream at its first use there."""
        scr = self._scratch.get(stream)
        if scr is None:
            scr = self._scratch[stream] = _Scratch(self)
        return scr

    def scenario_scratch(self, stream: int, S: int) -> "_ScenScratch":
        """The scenario scratch of the CUDA stream ``stream`` for at least
        ``S`` scenarios, made (zeroed) on that stream at its first use there
        and made anew for more scenarios than it holds, once the stream has
        drained (its launches may still read the old one)."""
        scr = self._scen_scratch.get(stream)
        if scr is None or scr.capacity < S:
            if scr is not None:
                torch.cuda.current_stream(self.Dx.device).synchronize()
            scr = self._scen_scratch[stream] = _ScenScratch(self, S)
        return scr


class _DctArgs(ctypes.Structure):
    """``DctArgs`` of ``csrc/dct_lattice.cu``: one operator's shapes and
    pointers on one calling stream."""

    _fields_ = (
        [(n, ctypes.c_int) for n in ("s", "ny", "r", "B", "n_stub", "rep_x", "rep_y", "split_y",
                                     "split_x")]
        + [("len_x", ctypes.c_double)]
        + [(n, ctypes.c_void_p) for n in ("Dx", "Dy", "lamx", "lamy", "g_geo", "stub_rows",
                                          "stub_edge", "stub_group", "inv", "g", "Minv", "t1",
                                          "t2", "z", "partial", "sol", "border_ticket")]
    )


class _Scratch:
    """One calling stream's device scratch of a :class:`DctOperator`: one
    zeroed float64 buffer holding the factor (``inv``, ``g``, ``Minv``), the
    transform grids ``t1``, ``t2`` and ``z``, the border's ``partial`` sums,
    ``sol`` and its ticket (a 32-bit word the kernel resets); ``args`` their
    :class:`_DctArgs` with the operator's, ``ref`` its address."""

    __slots__ = ("buf", "args", "ref")

    def __init__(self, op: DctOperator):
        B, r = op.B, op.r
        sizes = (("inv", B), ("g", r * B), ("Minv", (r + 1) ** 2), ("t1", B), ("t2", B), ("z", B),
                 ("partial", BORDER_BLOCKS), ("sol", r + 1), ("border_ticket", 1))
        sizes = tuple((name, n + n % 2) for name, n in sizes)  # 16-byte aligned regions
        self.buf = torch.zeros(sum(n for _, n in sizes), dtype=torch.float64, device=op.Dx.device)
        ptrs, ptr = {}, self.buf.data_ptr()
        for name, n in sizes:
            ptrs[name] = ptr
            ptr += 8 * n
        self.args = _DctArgs(
            s=op.s, ny=op.ny, r=r, B=B, n_stub=int(op.stub_edge.shape[0]), rep_x=op.rep_x,
            rep_y=op.rep_y, split_y=op.plans[0], split_x=op.plans[1], len_x=op.len_x,
            Dx=op.Dx.data_ptr(), Dy=op.Dy.data_ptr(), lamx=op.lamx.data_ptr(),
            lamy=op.lamy.data_ptr(), g_geo=op.g_geo.data_ptr(), stub_rows=op.stub_rows.data_ptr(),
            stub_edge=op.stub_edge.data_ptr(), stub_group=op.stub_group.data_ptr(), **ptrs)
        self.ref = ctypes.addressof(self.args)


class _ScenArgs(ctypes.Structure):
    """``DctScen`` of ``csrc/dct_lattice.cu``: one stream's scenario scratch."""

    _fields_ = [("capacity", ctypes.c_int)] + [
        (n, ctypes.c_void_p) for n in ("t1", "t2", "z", "partial", "sol", "tickets")]


class _ScenScratch:
    """One calling stream's scratch of :func:`dct_apply_scenarios` for
    ``capacity`` scenarios: one zeroed float64 buffer holding a scenario's
    transform grids ``t1``, ``t2``, ``z`` (B each), border partials
    (:data:`BORDER_BLOCKS`) and ``sol`` (r + 1) side by side, and a ticket a
    scenario (32-bit words the kernel resets); ``args`` their
    :class:`_ScenArgs`, ``ref`` its address."""

    __slots__ = ("capacity", "buf", "args", "ref")

    def __init__(self, op: DctOperator, capacity: int):
        B, r, S = op.B, op.r, capacity
        sizes = (("t1", S * B), ("t2", S * B), ("z", S * B), ("partial", S * BORDER_BLOCKS),
                 ("sol", S * (r + 1)), ("tickets", -(-S // 2)))
        sizes = tuple((name, n + n % 2) for name, n in sizes)  # 16-byte aligned regions
        self.capacity = S
        self.buf = torch.zeros(sum(n for _, n in sizes), dtype=torch.float64, device=op.Dx.device)
        ptrs, ptr = {}, self.buf.data_ptr()
        for name, n in sizes:
            ptrs[name] = ptr
            ptr += 8 * n
        self.args = _ScenArgs(capacity=S, **ptrs)
        self.ref = ctypes.addressof(self.args)


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
    # sol = Minv v as the border kernel adds it, column by column: the same
    # bits whatever Minv's layout (a row of a stacked factor, or the
    # column-major inverse of torch.linalg.inv)
    sol = state.Minv[:, 0] * v[0]
    for j in range(1, r + 1):
        sol = sol + state.Minv[:, j] * v[j]
    corr = sol[0] * state.g[0]
    for t in range(1, r):
        corr = corr + sol[t] * state.g[t]
    return z - corr + sol[r]


def dct_apply_plain(
    op: DctOperator, state: DctState, rhs: torch.Tensor, residual: Residual,
    n_refine: int = N_REFINE,
) -> torch.Tensor:
    """Eager version of :func:`dct_apply`: the direct pass and ``n_refine``
    refinement passes on ``state``."""
    lam = direct_plain(op, state, rhs)
    for _ in range(n_refine):
        lam = lam + direct_plain(op, state, residual(lam))
    return lam


def dct_lattice_plain(
    op: DctOperator, w: torch.Tensor, rhs: torch.Tensor, residual: Residual,
    n_refine: int = N_REFINE,
) -> torch.Tensor:
    """Eager version of :func:`dct_lattice`."""
    return dct_apply_plain(op, factor_plain(op, w), rhs, residual, n_refine)


# ------------------------------------------------------------------ kernels


def cuda_launches(op: DctOperator, n_refine: int = N_REFINE) -> int:
    """K16's kernel launches in one :func:`dct_lattice` solve: the factor's
    two (scale, bordered inverse) and per pass four products, the border
    and the correction — whatever the lattice's shape or stub rows, since a
    split product adds its slices in its own launch."""
    return 2 + 6 * (1 + n_refine)


def apply_launches(n_refine: int = N_REFINE) -> int:
    """K16's kernel launches in one :func:`dct_apply`: six a pass."""
    return 6 * (1 + n_refine)


def _lib_stream(index: int):
    return build.library(), build.raw_stream(index)


def _gemm(lib, stream, split, M, N, K, A, transA, Bp, transB, C, S=None) -> None:
    """One product launch on pointers: ``C = op(A) op(B) [∘ S]``."""
    code = lib.nxfx_dct_gemm(M, N, K, A, transA, Bp, transB, S, C, split, stream)
    if code:
        build.check(code, "dct_lattice")


def _require(op: DctOperator, *pairs) -> None:
    build.require_vectors("dct_lattice", op.index, *pairs)


def _factor(op: DctOperator, w: torch.Tensor) -> DctState:
    """The factor through K16's kernels into fresh tensors (plain for a CPU
    tensor)."""
    if w.device.type == "cpu":
        return factor_plain(op, w)
    _require(op, (w, -op.n_edges))
    r, B = op.r, op.B
    inv = w.new_empty((op.ny, op.s))
    g = w.new_empty((r, B))
    Minv = w.new_empty((r + 1, r + 1))

    def run(lib, stream):
        code = lib.nxfx_dct_factor(op.scratch(stream).ref, w.data_ptr(), inv.data_ptr(),
                                   g.data_ptr(), Minv.data_ptr(), stream)
        build.check(code, "dct_lattice")

    build.on_device(op.index, run, *_lib_stream(op.index))
    return DctState(inv, g, Minv)


def dct_factor(op: DctOperator, w: torch.Tensor) -> DctState:
    """K16's factor on ``w``'s device into tensors of its own (two launches;
    :func:`factor_plain` for a CPU tensor): what :func:`dct_apply` reads."""
    state = _factor(op, w)
    if w.is_cuda:
        dct_factor.launches += 1
    return state


dct_factor.launches = 0


def product_plain(A: torch.Tensor, Bm: torch.Tensor, transA: bool = False, transB: bool = False,
                  S: torch.Tensor | None = None) -> torch.Tensor:
    """``op(A) op(B)`` (``∘ S``) by ``torch.matmul``."""
    C = (A.T if transA else A) @ (Bm.T if transB else Bm)
    return C * S if S is not None else C


def product(A: torch.Tensor, Bm: torch.Tensor, transA: bool = False, transB: bool = False,
            S: torch.Tensor | None = None, split: int | None = None) -> torch.Tensor:
    """K16's product kernel alone on 2-D row-major float64 operands (plain
    for CPU tensors): ``op(A) op(B)`` (``∘ S``), ``split`` a k split other
    than :func:`gemm_plan`'s.  Not counted: it checks the kernel on shapes
    the lattices do not give it."""
    if A.device.type == "cpu":
        return product_plain(A, Bm, transA, transB, S)
    build.require_cuda("dct_lattice", A, Bm, *(() if S is None else (S,)))
    if A.dim() != 2 or Bm.dim() != 2:
        raise ValueError("dct_lattice: product operands must be 2-D")
    M, K = (A.shape[1], A.shape[0]) if transA else tuple(A.shape)
    Kb, N = (Bm.shape[1], Bm.shape[0]) if transB else tuple(Bm.shape)
    if K != Kb or (S is not None and tuple(S.shape) != (M, N)):
        raise ValueError("dct_lattice: product shapes do not match")
    dev = A.device
    if split is None:
        split = gemm_plan(M, N, K, torch.cuda.get_device_properties(dev).multi_processor_count)
    C = A.new_empty((M, N))
    build.on_device(dev.index, _gemm, *_lib_stream(dev.index), split, M, N, K, A.data_ptr(),
               int(transA), Bm.data_ptr(), int(transB), C.data_ptr(),
               None if S is None else S.data_ptr())
    return C


def transform(op: DctOperator, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """:func:`transform_plain` through K16's product kernel on the card
    (two launches, not counted: the solve's passes run the same kernel)."""
    if x.device.type == "cpu":
        return transform_plain(op, x, inverse)
    _require(op, (x, op.B))
    out = x.new_empty(op.B)

    def run(lib, stream):
        t1 = op.scratch(stream).args.t1
        py, px = op.plans
        _gemm(lib, stream, py, op.ny, op.s, op.ny, op.Dy.data_ptr(), int(inverse), x.data_ptr(), 0,
              t1)
        _gemm(lib, stream, px, op.ny, op.s, op.s, t1, 0, op.Dx.data_ptr(), int(not inverse),
              out.data_ptr())

    build.on_device(op.index, run, *_lib_stream(op.index))
    return out


def _lplus(op: DctOperator, state: DctState, b: torch.Tensor) -> torch.Tensor:
    """The four products of one transform solve into a fresh ``z`` (plain
    for a CPU tensor)."""
    if b.device.type == "cpu":
        return lplus_plain(op, state, b)
    _require(op, (b, op.B))
    z = b.new_empty(op.B)

    def run(lib, stream):
        code = lib.nxfx_dct_lplus(op.scratch(stream).ref, state.inv.data_ptr(), b.data_ptr(),
                                  z.data_ptr(), stream)
        build.check(code, "dct_lattice")

    build.on_device(op.index, run, *_lib_stream(op.index))
    return z


def dct_lattice(
    op: DctOperator, w: torch.Tensor, rhs: torch.Tensor, residual: Residual,
    n_refine: int = N_REFINE,
) -> torch.Tensor:
    """K16 on ``rhs``' device: ``λ (B,)`` of ``L λ = rhs`` from the
    conductances ``w = 1/W`` (E,) — the factor, one direct pass and
    ``n_refine`` passes on ``residual(λ) = rhs − L λ``."""
    if rhs.device.type == "cpu":
        return dct_lattice_plain(op, w, rhs, residual, n_refine)
    _require(op, (w, -op.n_edges), (rhs, op.B))
    lam = build.on_device(op.index, _solve, op, w, rhs, residual, n_refine)
    dct_lattice.launches += 1
    return lam


def _solve(op: DctOperator, w, rhs, residual: Residual, n_refine: int) -> torch.Tensor:
    """The solve's launches: the factor and the direct pass in one call of
    the library (eight launches), then each refinement pass in one (six)."""
    lib, stream = _lib_stream(op.index)
    ref = op.scratch(stream).ref
    lam = rhs.new_empty(op.B)
    lp = lam.data_ptr()
    code = lib.nxfx_dct_pass(ref, w.data_ptr(), rhs.data_ptr(), lp, 0, stream)
    for _ in range(n_refine):
        if code:
            break
        res = residual(lam)
        _require(op, (res, op.B))
        code = lib.nxfx_dct_pass(ref, None, res.data_ptr(), lp, 1, stream)
    if code:
        build.check(code, "dct_lattice")
    return lam


dct_lattice.launches = 0


def dct_apply(
    op: DctOperator, state: DctState, rhs: torch.Tensor, residual: Residual,
    n_refine: int = N_REFINE,
) -> torch.Tensor:
    """K16's passes on ``rhs``' device from a stored factor (``state``, from
    :func:`_factor`): ``λ (B,)`` after one direct pass and ``n_refine``
    passes on ``residual(λ) = rhs − L λ``."""
    if rhs.device.type == "cpu":
        return dct_apply_plain(op, state, rhs, residual, n_refine)
    if not all(isinstance(t, torch.Tensor) and t.is_contiguous() for t in state):
        raise ValueError("dct_apply: the state's tensors must be contiguous")
    r, B = op.r, op.B
    _require(op, (rhs, B), (state.inv.view(-1), B), (state.g.view(-1), r * B),
             (state.Minv.view(-1), (r + 1) ** 2))
    lam = build.on_device(op.index, _apply, op, state, rhs, residual, n_refine)
    dct_apply.launches += 1
    return lam


def _apply(op: DctOperator, state: DctState, rhs, residual: Residual, n_refine: int) -> torch.Tensor:
    lib, stream = _lib_stream(op.index)
    ref = op.scratch(stream).ref
    lam = rhs.new_empty(op.B)
    lp = lam.data_ptr()
    fac = (state.inv.data_ptr(), state.g.data_ptr(), state.Minv.data_ptr())
    code = lib.nxfx_dct_apply(ref, *fac, rhs.data_ptr(), lp, 0, stream)
    for _ in range(n_refine):
        if code:
            break
        res = residual(lam)
        _require(op, (res, op.B))
        code = lib.nxfx_dct_apply(ref, *fac, res.data_ptr(), lp, 1, stream)
    if code:
        build.check(code, "dct_lattice")
    return lam


dct_apply.launches = 0


# ------------------------------------------------------------------ scenarios


def _factor_rows(name: str, op: DctOperator, w: torch.Tensor) -> int:
    """``S`` of the ``(S, ≥ n_edges)`` conductance rows of a scenario factor,
    or raise."""
    if (w.dtype is not torch.float64 or w.dim() != 2 or w.shape[0] < 1
            or w.shape[1] < op.n_edges or not w.is_contiguous()):
        raise ValueError(f"{name}: w must be contiguous float64 (S, E) rows, S >= 1 and E >= "
                         f"{op.n_edges}, got {w.dtype} {tuple(w.shape)}")
    return int(w.shape[0])


def dct_factor_scenarios_plain(op: DctOperator, w: torch.Tensor) -> DctState:
    """Eager version of :func:`dct_factor_scenarios`: :func:`factor_plain` a
    row, stacked."""
    S = _factor_rows("dct_factor_scenarios", op, w)
    return DctState(*(torch.stack(t) for t in zip(*(factor_plain(op, w[i]) for i in range(S)))))


def dct_factor_scenarios(op: DctOperator, w: torch.Tensor) -> DctState:
    """K16's factors of S scenarios on ``w``'s device, in the two launches of
    one: ``w`` the ``(S, E)`` conductance rows; returns a :class:`DctState`
    whose tensors have a leading ``S`` (``inv (S, ny, s)``, ``g (S, r, B)``,
    ``Minv (S, r+1, r+1)``), row ``i`` the bits of :func:`dct_factor` on
    ``w[i]`` (:func:`dct_factor_scenarios_plain` for a CPU tensor)."""
    if w.device.type == "cpu":
        return dct_factor_scenarios_plain(op, w)
    S = _factor_rows("dct_factor_scenarios", op, w)
    if not w.is_cuda or w.get_device() != op.index:
        raise ValueError(f"dct_factor_scenarios: w must be on CUDA device {op.index}")
    r, B = op.r, op.B
    inv = w.new_empty((S, op.ny, op.s))
    g = w.new_empty((S, r, B))
    Minv = w.new_empty((S, r + 1, r + 1))

    def run(lib, stream):
        code = lib.nxfx_dct_factor_scen(op.scratch(stream).ref, S, w.data_ptr(), w.stride(0),
                                        inv.data_ptr(), g.data_ptr(), Minv.data_ptr(), stream)
        build.check(code, "dct_factor_scenarios")

    build.on_device(op.index, run, *_lib_stream(op.index))
    dct_factor_scenarios.launches += 1
    return DctState(inv, g, Minv)


dct_factor_scenarios.launches = 0


def _apply_shapes(name: str, op: DctOperator, state: DctState, rhs: torch.Tensor) -> tuple:
    """``(S, shared)`` of a scenario apply: ``rhs`` the contiguous ``(S, B)``
    right-hand sides, ``state`` one factor (:func:`dct_factor`'s shapes) or
    ``S`` (:func:`dct_factor_scenarios`'); raise otherwise."""
    r, B = op.r, op.B
    if rhs.dtype is not torch.float64 or rhs.dim() != 2 or rhs.shape[0] < 1 or rhs.shape[1] != B \
            or not rhs.is_contiguous():
        raise ValueError(f"{name}: rhs must be contiguous float64 (S, {B}), S >= 1, got "
                         f"{rhs.dtype} {tuple(rhs.shape)}")
    S = int(rhs.shape[0])
    one = ((op.ny, op.s), (r, B), (r + 1, r + 1))
    shapes = tuple(tuple(t.shape) for t in state)
    if shapes == one:
        shared = True
    elif shapes == tuple((S,) + sh for sh in one):
        shared = False
    else:
        raise ValueError(f"{name}: the state must be one factor {one} or {S} of them, got {shapes}")
    return S, shared


def dct_apply_scenarios_plain(
    op: DctOperator, state: DctState, rhs: torch.Tensor, residual: Residual,
    n_refine: int = N_REFINE,
) -> torch.Tensor:
    """Eager version of :func:`dct_apply_scenarios`: :func:`direct_plain` a
    row, stacked, around ``residual`` on all rows."""
    S, shared = _apply_shapes("dct_apply_scenarios", op, state, rhs)
    states = [state if shared else DctState(*(t[i] for t in state)) for i in range(S)]

    def direct(b):  # each row a fresh tensor, as a call of one gets it
        return torch.stack([direct_plain(op, states[i], b[i].clone()) for i in range(S)])

    lam = direct(rhs)
    for _ in range(n_refine):
        lam = lam + direct(residual(lam))
    return lam


def dct_apply_scenarios(
    op: DctOperator, state: DctState, rhs: torch.Tensor, residual: Residual,
    n_refine: int = N_REFINE,
) -> torch.Tensor:
    """K16's passes over S scenarios on ``rhs``' device, six launches a pass
    whatever S: ``rhs`` the ``(S, B)`` right-hand sides, ``state`` S factors
    (:func:`dct_factor_scenarios`) or one that every scenario shares
    (:func:`dct_factor`, read at stride 0), ``residual`` maps ``(S, B)`` λ
    to ``(S, B)`` residuals.  Returns ``λ (S, B)``, row ``i`` the bits of
    :func:`dct_apply` on row ``i``'s factor and right-hand side (with the
    same residual a row).  The stream's scenario scratch holds the S
    scenarios' grids: 8·(3B + 256 + r + 1) bytes and a ticket a scenario
    (6 MiB at 512², 96 MiB for S = 16), on top of a batched factor's
    8·((r + 1)·B + (r + 1)²)."""
    if rhs.device.type == "cpu":
        return dct_apply_scenarios_plain(op, state, rhs, residual, n_refine)
    S, shared = _apply_shapes("dct_apply_scenarios", op, state, rhs)
    build.require_cuda("dct_apply_scenarios", rhs, *state)
    if any(t.get_device() != op.index for t in (rhs, *state)):
        raise ValueError(f"dct_apply_scenarios: tensors must be on CUDA device {op.index}")
    lam = build.on_device(op.index, _apply_scenarios, op, state, rhs, residual, n_refine, S,
                          shared)
    dct_apply_scenarios.launches += 1
    return lam


def _apply_scenarios(op: DctOperator, state: DctState, rhs, residual: Residual, n_refine: int,
                     S: int, shared: bool) -> torch.Tensor:
    lib, stream = _lib_stream(op.index)
    ref, scen = op.scratch(stream).ref, op.scenario_scratch(stream, S).ref
    lam = rhs.new_empty((S, op.B))
    lp = lam.data_ptr()
    fac = (state.inv.data_ptr(), state.g.data_ptr(), state.Minv.data_ptr())
    code = lib.nxfx_dct_apply_scen(ref, scen, S, int(shared), *fac, rhs.data_ptr(), lp, 0, stream)
    for _ in range(n_refine):
        if code:
            break
        res = residual(lam)
        if (not res.is_cuda or res.get_device() != op.index or res.dtype is not torch.float64
                or tuple(res.shape) != (S, op.B) or not res.is_contiguous()):
            raise ValueError(f"dct_apply_scenarios: the residual must be a contiguous float64 "
                             f"({S}, {op.B}) tensor on CUDA device {op.index}")
        code = lib.nxfx_dct_apply_scen(ref, scen, S, int(shared), *fac, res.data_ptr(), lp, 1,
                                       stream)
    if code:
        build.check(code, "dct_apply_scenarios")
    return lam


dct_apply_scenarios.launches = 0
