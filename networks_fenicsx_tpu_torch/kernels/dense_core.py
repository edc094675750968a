"""K11: the dense solve of a cycle core or a dense tail (``csrc/dense_core.cu``).

Replaces ``networks_fenicsx_tpu/ops/mixed_precision.py:scaled_cholesky_factor``
and ``scaled_cholesky_solve`` (``:34-69``) on the two matrices the reference
hands them: the cycle core of ``_tree_eliminate_factor`` (``:3729-3743``),
``Lc`` from the peeled diagonal ``dc`` and ``−w_pairs[pid]`` at the core
pairs, and the dense tail of the min-degree elimination
(``ops/core_elim.py:_core_factor``, ``:977-991``), whose negated pair values
are given with ``pid = 0, 1, …``.  Then Jacobi scaling, a Cholesky factor, the pivot gate
(``min pivot > 1e-7·max pivot``, all finite), the solve and ``n_refine``
refinement passes against ``Lc`` (three, the reference's ``_N_REFINE``), and
NaN everywhere when the gate trips.  ``n_refine`` is an argument of the
kernel and of the plain version alike, as of ``scaled_cholesky_solve``: the
checks on the card set it to 0 to hold the unrefined solve, which
refinement would otherwise hide.

The reference factors in float32 and refines in float64 because float64
Cholesky is emulated on the TPU; the port factors in float64 (kernel and
plain version alike) and keeps the gate and the refinement passes.

:func:`dense_core` launches the kernel for CUDA tensors (a tiled
multi-block factor with its trailing updates on the float64 tensor cores,
two launches a 64-column panel, and one-launch triangular solves, any core
up to ``MAX_CORE`` nodes: 146 launches at 4,096 nodes, 34 at 455) and runs
:func:`dense_core_plain` for CPU tensors.

Factor reuse splits the call: :func:`dense_factor` and :func:`dense_gate`
once (the reference's ``scaled_cholesky_factor``), then :func:`dense_solve`
a right-hand side (``scaled_cholesky_solve``: the passes of
:func:`dense_core` after its gate, NaN everywhere when the gate tripped, the
same bits as :func:`dense_core` where the same factor feeds both; 16
launches at three refinement passes, whatever ``n``).

A sweep (:func:`..batch.solve_sweep` on the dense route) runs S scenarios in
the launches of one call, the scenario one more grid dimension:
:func:`dense_factor_scenarios` (S assemblies and factors, one panel launch
covering panel ``k`` of every scenario on the one lookahead chain),
:func:`dense_gate_scenarios` (a flag a scenario) and
:func:`dense_solve_scenarios` (the passes over S right-hand sides, on S
factors or on one shared factor, read at stride 0: an ``f`` or ``p_bc``
batch factors once, as the reference's ``vmap`` does).  Scenario ``i`` is
the one-scenario call on row ``i`` bit for bit; the plain versions stack
the one-scenario plain versions.  A launch takes at most
:data:`MAX_SCENARIOS`.  An R batch holds ``Lc`` and ``C`` a scenario, 16 n²
bytes (268 MB at 4,095 nodes), so the sweep runs its scenarios in chunks of
:func:`scenario_chunk`: as many as :data:`SCENARIO_BUDGET` (2 GiB) holds, 8
at 4,095 nodes — 2.5 % of the H100's 80 GB, which leaves the card to the
rest of the sweep's arrays, while eight factors' trailing updates already
give the 132 SMs eight times one factor's tiles.  Each chunk takes one
factor's launches; the bits do not depend on the chunk.
"""

from __future__ import annotations

import torch

from . import build

__all__ = [
    "cuda_launches", "dense_core", "dense_core_plain", "dense_factor", "dense_factor_plain",
    "assemble_core", "MAX_CORE", "PIVOT_RTOL", "N_REFINE", "dense_gate", "dense_gate_plain",
    "dense_solve", "dense_solve_plain", "solve_launches", "dense_factor_scenarios",
    "dense_factor_scenarios_plain", "dense_gate_scenarios", "dense_gate_scenarios_plain",
    "dense_solve_scenarios", "dense_solve_scenarios_plain", "scenario_chunk", "MAX_SCENARIOS",
    "SCENARIO_BUDGET",
]

MAX_CORE = 8192
PIVOT_RTOL = 1e-7
N_REFINE = 3


def assemble_core(ci, cj, pid, dc: torch.Tensor, w_pairs: torch.Tensor) -> torch.Tensor:
    """``Lc``: ``diag(dc)`` with the pair values ``−w_pairs[pid]`` at
    ``(ci, cj)`` and ``(cj, ci)``."""
    n = dc.shape[0]
    Lc = torch.zeros((n, n), dtype=torch.float64, device=dc.device)
    ar = torch.arange(n, device=dc.device)
    Lc[ar, ar] = dc
    if ci.shape[0]:
        wv = -w_pairs[pid.long()]
        Lc[ci.long(), cj.long()] = wv
        Lc[cj.long(), ci.long()] = wv
    return Lc


def dense_core_plain(ci, cj, pid, dc, rc, w_pairs, n_refine: int = N_REFINE) -> torch.Tensor:
    """Eager version: the solution ``x (n,)`` after ``n_refine`` refinement
    passes, NaN when singular."""
    Lc = assemble_core(ci, cj, pid, dc, w_pairs)
    dscale = torch.sqrt(torch.diagonal(Lc))
    Ls = (Lc / dscale[:, None]) / dscale[None, :]
    chol, info = torch.linalg.cholesky_ex(Ls)
    ok = (info == 0) & dense_gate_plain(chol)
    return dense_solve_plain(Lc, dscale, chol, ok, rc, n_refine)


def dense_gate_plain(C: torch.Tensor) -> torch.Tensor:
    """Eager version of :func:`dense_gate`: every pivot ``C_ii`` finite and
    ``min > PIVOT_RTOL·max`` (a bool tensor)."""
    piv = torch.diagonal(C)
    return torch.all(torch.isfinite(piv)) & (piv.min() > PIVOT_RTOL * piv.max())


def dense_solve_plain(Lc, s, C, ok, rc, n_refine: int = N_REFINE) -> torch.Tensor:
    """Eager version of :func:`dense_solve`, in :func:`dense_core_plain`'s
    order: ``x = solve(rc)``, ``n_refine`` passes ``x += solve(rc − Lc x)``
    with ``solve(v) = C⁻ᵀ C⁻¹ (v / s) / s``, NaN everywhere unless ``ok``."""

    def solve_scaled(rv):
        return torch.cholesky_solve((rv / s)[:, None], C)[:, 0] / s

    x = solve_scaled(rc)
    for _ in range(n_refine):
        x = x + solve_scaled(rc - Lc @ x)
    return torch.where(ok.bool(), x, torch.nan)


def dense_core(ci, cj, pid, dc, rc, w_pairs, n_refine: int = N_REFINE) -> torch.Tensor:
    """K11 on ``dc``'s device.  ``ci``, ``cj`` ``(P0,)`` int32 are the pairs'
    rows and columns (core ranks) and ``pid`` ``(P0,)`` int32 their pair ids
    into the conductances ``w_pairs`` ``(P,)``; ``dc``, ``rc`` ``(n,)`` the
    diagonal and the rhs."""
    if dc.device.type == "cpu":
        return dense_core_plain(ci, cj, pid, dc, rc, w_pairs, n_refine)
    build.require_cuda("dense_core", dc, rc, w_pairs)
    build.require_cuda("dense_core", ci, cj, pid, dtype=torch.int32)
    n = dc.shape[0]
    if n > MAX_CORE or tuple(rc.shape) != (n,) or n_refine < 0:
        raise ValueError(f"dense_core: the core must have at most {MAX_CORE} nodes, rc (n,), "
                         "n_refine >= 0")
    dev, dt = dc.device, torch.float64
    Lc = torch.empty((n, n), dtype=dt, device=dev)
    C = torch.empty((n, n), dtype=dt, device=dev)
    sv = torch.empty((3, n), dtype=dt, device=dev)
    x = torch.empty(n, dtype=dt, device=dev)
    ok = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_dense_core(
            n, ci.shape[0], n_refine, ci.data_ptr(), cj.data_ptr(), pid.data_ptr(),
            w_pairs.data_ptr(), dc.data_ptr(), rc.data_ptr(), Lc.data_ptr(), C.data_ptr(),
            sv[0].data_ptr(), sv[1].data_ptr(), sv[2].data_ptr(), x.data_ptr(), ok.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "dense_core")
    dense_core.launches += 1
    return x


dense_core.launches = 0


def dense_factor_plain(ci, cj, pid, dc, w_pairs) -> tuple:
    """Eager version of :func:`dense_factor`: ``(Lc, s, C)``, ``C`` lower
    (NaN where the factor breaks down, as the kernel's square roots give)."""
    Lc = assemble_core(ci, cj, pid, dc, w_pairs)
    s = torch.sqrt(torch.diagonal(Lc))
    chol, info = torch.linalg.cholesky_ex((Lc / s[:, None]) / s[None, :])
    if int(info):
        chol = torch.full_like(chol, torch.nan)
    return Lc, s, chol


def dense_factor(ci, cj, pid, dc, w_pairs) -> tuple:
    """K11's assembly and factor alone: ``(Lc, s, C)`` with ``s =
    sqrt(diag Lc)`` and ``C``'s lower triangle the Cholesky factor of ``Ls =
    (Lc / s_i) / s_j`` (its strict upper triangle is scratch) — what a check
    of the factor's backward error ``max|Ls − C Cᵀ|`` reads, and the factor
    of ``schur_method="dense_f64"``.  Counted with :func:`dense_core`'s
    launches; runs :func:`dense_factor_plain` for CPU tensors."""
    if dc.device.type == "cpu":
        return dense_factor_plain(ci, cj, pid, dc, w_pairs)
    build.require_cuda("dense_factor", dc, w_pairs)
    build.require_cuda("dense_factor", ci, cj, pid, dtype=torch.int32)
    n = dc.shape[0]
    if n > MAX_CORE:
        raise ValueError(f"dense_factor: the core must have at most {MAX_CORE} nodes")
    dev, dt = dc.device, torch.float64
    Lc = torch.empty((n, n), dtype=dt, device=dev)
    C = torch.empty((n, n), dtype=dt, device=dev)
    s = torch.empty(n, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_dense_factor(
            n, ci.shape[0], ci.data_ptr(), cj.data_ptr(), pid.data_ptr(), w_pairs.data_ptr(), dc.data_ptr(), Lc.data_ptr(), C.data_ptr(), s.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "dense_factor")
    dense_core.launches += 1
    return Lc, s, C


def dense_gate(C: torch.Tensor) -> torch.Tensor:
    """K11's pivot gate of a factor ``C`` (:func:`dense_factor`'s) on its
    device: an int32 flag, 1 when every pivot is finite and ``min >
    PIVOT_RTOL·max`` (one launch); :func:`dense_gate_plain` for a CPU tensor."""
    if C.device.type == "cpu":
        return dense_gate_plain(C)
    build.require_cuda("dense_gate", C)
    n = C.shape[0]
    if tuple(C.shape) != (n, n) or n > MAX_CORE:
        raise ValueError(f"dense_gate: C must be (n, n) with n at most {MAX_CORE}")
    ok = torch.zeros((), dtype=torch.int32, device=C.device)
    with torch.cuda.device(C.device):
        code = build.library().nxfx_dense_gate(n, C.data_ptr(), ok.data_ptr(),
                                               build.stream_handle(C.device))
    build.check(code, "dense_gate")
    dense_gate.launches += 1
    return ok


dense_gate.launches = 0


def dense_solve(Lc, s, C, ok, rc, n_refine: int = N_REFINE) -> torch.Tensor:
    """K11's solve on a stored factor on ``rc``'s device: ``(Lc, s, C)`` from
    :func:`dense_factor`, ``ok`` from :func:`dense_gate`; the solution ``x
    (n,)`` after ``n_refine`` refinement passes, NaN everywhere unless
    ``ok``.  Each call allocates its own scratch, so solves on one factor
    may run on several streams."""
    if rc.device.type == "cpu":
        return dense_solve_plain(Lc, s, C, ok, rc, n_refine)
    build.require_cuda("dense_solve", Lc, s, C, rc)
    build.require_cuda("dense_solve", ok, dtype=torch.int32)
    n = rc.shape[0]
    if (n > MAX_CORE or tuple(Lc.shape) != (n, n) or tuple(C.shape) != (n, n)
            or tuple(s.shape) != (n,) or ok.numel() != 1 or n_refine < 0):
        raise ValueError(f"dense_solve: Lc, C (n, n), s, rc (n,) with n at most {MAX_CORE}, "
                         "one ok flag, n_refine >= 0")
    dev, dt = rc.device, torch.float64
    vy = torch.empty((2, n), dtype=dt, device=dev)
    x = torch.empty(n, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_dense_solve(
            n, n_refine, Lc.data_ptr(), C.data_ptr(), s.data_ptr(), ok.data_ptr(), rc.data_ptr(),
            vy[0].data_ptr(), vy[1].data_ptr(), x.data_ptr(), build.stream_handle(dev),
        )
    build.check(code, "dense_solve")
    dense_solve.launches += 1
    return x


dense_solve.launches = 0


def solve_launches(n: int, n_refine: int = N_REFINE) -> int:
    """CUDA kernel launches of one :func:`dense_solve`: per pass a residual,
    two solves and an update."""
    return (1 + n_refine) * (2 + 2 * tiled_solve_launches(n)) if n else 0


TILE = 64  # the tiled route's panel width (csrc/tiled_cholesky.cuh)


def tiled_factor_launches(m: int, w: int) -> int:
    """Launches of ``tiled_cholesky`` on the first ``w`` columns of an
    ``m x m`` block: for each 64-column panel a panel launch (its diagonal
    tile and the rows below it, with the previous panel's update of its
    column of tiles) and a trailing launch on the tensor cores where tiles
    remain past the next panel's column (after the last panel, or before a
    panel whose column reaches past ``w``, any tile); then the inverse
    launch."""
    if w <= 0:
        return 0
    n = 1
    for k0 in range(0, w, TILE):
        k1 = k0 + min(TILE, w - k0)
        tiles = -(-(m - k1) // TILE)
        j0 = int(k1 < w and (k1 + TILE <= w or w == m))
        n += 1 + (tiles - j0 > 0)
    return n


def tiled_solve_launches(n: int) -> int:
    """Launches of one triangular solve of order ``n``: one (a dataflow over
    its 64-row blocks)."""
    return int(n > 0)


def cuda_launches(n: int, P0: int, n_refine: int = N_REFINE) -> int:
    """CUDA kernel launches of one :func:`dense_core` call: the assembly (one,
    two with pairs), the factor, the gate, and per pass a residual, two
    solves and an update."""
    per_pass = 2 + 2 * tiled_solve_launches(n)
    return 1 + (P0 > 0) + tiled_factor_launches(n, n) + 1 + (1 + n_refine) * per_pass


# ---------------------------------------------------------------- scenarios

MAX_SCENARIOS = 65_535  # scenarios a launch: the grid's y limit (csrc: TC_MAX_SCENARIOS)
SCENARIO_BUDGET = 2 << 30  # bytes of a chunk's per-scenario arrays (module docs)


def scenario_chunk(n: int, factors: bool, budget: int = SCENARIO_BUDGET) -> int:
    """Scenarios a chunk of a sweep's K11 work at ``n`` nodes: with
    ``factors`` (an R batch) ``Lc`` and ``C`` a scenario, 16 n² bytes; else
    (right-hand sides on one factor) the solve's scratch ``v``, ``y``, 16 n
    bytes; as many as ``budget`` holds, at least 1 and at most
    :data:`MAX_SCENARIOS`."""
    per = 16 * max(n, 1) * (max(n, 1) if factors else 1)
    return max(1, min(MAX_SCENARIOS, budget // per))


def _scenario_count(name: str, S: int) -> None:
    if not 0 < S <= MAX_SCENARIOS:
        raise ValueError(f"{name}: 1 to {MAX_SCENARIOS} scenarios a launch, got {S}")


def _factor_shapes(name, dc, w_pairs) -> tuple:
    """``(S, n)`` of a scenario factor, or raise."""
    if dc.dim() != 2 or w_pairs.dim() != 2 or w_pairs.shape[0] != dc.shape[0] or not dc.shape[0]:
        raise ValueError(f"{name}: dc must be (S, n) and w_pairs (S, P), S >= 1")
    if dc.shape[1] > MAX_CORE:
        raise ValueError(f"{name}: the core must have at most {MAX_CORE} nodes")
    return tuple(dc.shape)


def dense_factor_scenarios_plain(ci, cj, pid, dc, w_pairs) -> tuple:
    """Eager version of :func:`dense_factor_scenarios`:
    :func:`dense_factor_plain` a scenario, stacked."""
    S, _ = _factor_shapes("dense_factor_scenarios", dc, w_pairs)
    rows = [dense_factor_plain(ci, cj, pid, dc[i], w_pairs[i]) for i in range(S)]
    return tuple(torch.stack(t) for t in zip(*rows))


def dense_factor_scenarios(ci, cj, pid, dc, w_pairs) -> tuple:
    """K11's assembly and factor of S scenarios in one factor's launches:
    ``dc (S, n)`` and ``w_pairs (S, P)`` a row a scenario, the pair tables
    shared; returns ``(Lc (S, n, n), s (S, n), C (S, n, n))``, row ``i``
    :func:`dense_factor` of row ``i`` bit for bit."""
    if dc.device.type == "cpu":
        return dense_factor_scenarios_plain(ci, cj, pid, dc, w_pairs)
    build.require_cuda("dense_factor_scenarios", dc, w_pairs)
    build.require_cuda("dense_factor_scenarios", ci, cj, pid, dtype=torch.int32)
    S, n = _factor_shapes("dense_factor_scenarios", dc, w_pairs)
    _scenario_count("dense_factor_scenarios", S)
    dev, dt = dc.device, torch.float64
    Lc = torch.empty((S, n, n), dtype=dt, device=dev)
    C = torch.empty((S, n, n), dtype=dt, device=dev)
    s = torch.empty((S, n), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_dense_factor_scen(
            n, S, ci.shape[0], w_pairs.shape[1], ci.data_ptr(), cj.data_ptr(), pid.data_ptr(),
            w_pairs.data_ptr(), dc.data_ptr(), Lc.data_ptr(), C.data_ptr(), s.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "dense_factor_scenarios")
    dense_factor_scenarios.launches += 1
    return Lc, s, C


dense_factor_scenarios.launches = 0


def _gate_shapes(C) -> tuple:
    if (C.dim() != 3 or C.shape[1] != C.shape[2] or not 0 < C.shape[1] <= MAX_CORE
            or not C.shape[0]):
        raise ValueError(f"dense_gate_scenarios: C must be (S, n, n) with S >= 1 and 1 <= n <= "
                         f"{MAX_CORE}")
    return C.shape[0], C.shape[1]


def dense_gate_scenarios_plain(C: torch.Tensor) -> torch.Tensor:
    """Eager version of :func:`dense_gate_scenarios`: :func:`dense_gate_plain`
    a scenario, stacked (bool)."""
    S, _ = _gate_shapes(C)
    return torch.stack([dense_gate_plain(C[i]) for i in range(S)])


def dense_gate_scenarios(C: torch.Tensor) -> torch.Tensor:
    """K11's pivot gates of S factors ``C (S, n, n)`` in one launch: an int32
    flag a scenario, :func:`dense_gate` of its row."""
    if C.device.type == "cpu":
        return dense_gate_scenarios_plain(C)
    build.require_cuda("dense_gate_scenarios", C)
    S, n = _gate_shapes(C)
    _scenario_count("dense_gate_scenarios", S)
    ok = torch.empty(S, dtype=torch.int32, device=C.device)  # every flag written
    with torch.cuda.device(C.device):
        code = build.library().nxfx_dense_gate_scen(n, S, C.data_ptr(), ok.data_ptr(),
                                                    build.stream_handle(C.device))
    build.check(code, "dense_gate_scenarios")
    dense_gate_scenarios.launches += 1
    return ok


dense_gate_scenarios.launches = 0


def _solve_shapes(name, Lc, s, C, ok, rc):
    """``(S, n, shared)`` of a scenario solve, or raise."""
    if rc.dim() != 2 or not rc.shape[0]:
        raise ValueError(f"{name}: rc must be (S, n), S >= 1")
    S, n = rc.shape
    shared = Lc.dim() == 2
    lead = () if shared else (S,)
    if (tuple(Lc.shape) != lead + (n, n) or tuple(C.shape) != lead + (n, n)
            or tuple(s.shape) != lead + (n,) or ok.numel() != (1 if shared else S)):
        raise ValueError(f"{name}: Lc, C (n, n), s (n,) and one ok flag (shared), or each with a "
                         f"leading S = {S}; rc (S, n)")
    return S, n, shared


def dense_solve_scenarios_plain(Lc, s, C, ok, rc, n_refine: int = N_REFINE) -> torch.Tensor:
    """Eager version of :func:`dense_solve_scenarios`: :func:`dense_solve_plain`
    a scenario, stacked."""
    S, _, shared = _solve_shapes("dense_solve_scenarios", Lc, s, C, ok, rc)
    ok = ok.reshape(-1)
    rows = []
    for i in range(S):
        j = 0 if shared else i
        rows.append(dense_solve_plain(Lc if shared else Lc[i], s if shared else s[i],
                                      C if shared else C[i], ok[j], rc[i], n_refine))
    return torch.stack(rows)


def dense_solve_scenarios(Lc, s, C, ok, rc, n_refine: int = N_REFINE) -> torch.Tensor:
    """K11's solve of S right-hand sides ``rc (S, n)`` in one solve's
    launches: on S stored factors (``Lc``, ``C`` ``(S, n, n)``, ``s (S, n)``,
    ``ok (S,)`` of :func:`dense_factor_scenarios` and
    :func:`dense_gate_scenarios`) or on one shared factor (the one-scenario
    shapes of :func:`dense_factor` and :func:`dense_gate`, read at stride 0).
    Row ``i`` is :func:`dense_solve` of its factor and ``rc[i]`` bit for bit."""
    if rc.device.type == "cpu":
        return dense_solve_scenarios_plain(Lc, s, C, ok, rc, n_refine)
    S, n, shared = _solve_shapes("dense_solve_scenarios", Lc, s, C, ok, rc)
    build.require_cuda("dense_solve_scenarios", Lc, s, C, rc)
    build.require_cuda("dense_solve_scenarios", ok, dtype=torch.int32)
    _scenario_count("dense_solve_scenarios", S)
    if n > MAX_CORE or n_refine < 0:
        raise ValueError(f"dense_solve_scenarios: n at most {MAX_CORE}, n_refine >= 0")
    dev, dt = rc.device, torch.float64
    vy = torch.empty((2, S, n), dtype=dt, device=dev)
    x = torch.empty((S, n), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        code = build.library().nxfx_dense_solve_scen(
            n, S, n_refine, int(shared), Lc.data_ptr(), C.data_ptr(), s.data_ptr(), ok.data_ptr(),
            rc.data_ptr(), vy[0].data_ptr(), vy[1].data_ptr(), x.data_ptr(),
            build.stream_handle(dev),
        )
    build.check(code, "dense_solve_scenarios")
    dense_solve_scenarios.launches += 1
    return x


dense_solve_scenarios.launches = 0
