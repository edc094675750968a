"""K1: per-edge static condensation (``csrc/condense.cu``).

Replaces ``networks_fenicsx_tpu/solver.py:_blocked_condense``,
``_blocked_condense_R`` and ``_blocked_condense_f`` (``:2776-2911``, the
``W, g, Ftot`` half) and the ``const`` line of ``_blocked_uniform_solve``
(``:2941-2950``).  All inputs and outputs are float64 in the plan's internal
edge order; ``"cell"``-mode coefficients are ``(N, E)`` j-major blocks.

One launch computes K1 for every shard of a device: a :class:`Batch` holds
what is fixed for the shards of one plan or group (their row ends, ``N``,
``k``, the modes and the condensed matrix's constants, and the launch's
struct of pointers), and :func:`condense_batch` takes each shard's
``(h_e, R, f, start_pbc, end_pbc)`` and returns one ``(5, S, E)`` buffer,
the planes ``W, w, g, Ftot, const`` (one launch a :data:`MAX_SHARDS`
shards; :func:`cuda_launches`).  :func:`condense` is the one-plan call the
serial routes make, the same kernel with S = 1 on a :class:`Batch` kept on
the plan.  The kernel is memory-bound: it reads each coefficient once and
writes five rows a shard; one thread walks one edge's column.

A sweep (:mod:`...batch`) runs K1 over S scenarios of one plan in one
launch, whatever S: :func:`condense_scenarios` takes each of ``R``, ``f``,
``start_pbc`` and ``end_pbc`` either with a leading scenario axis or shared
by every scenario (read with stride 0, not copied) and returns one ``(5, S,
E)`` buffer; scenario ``i``'s column is :func:`condense` of row ``i`` bit
for bit (the same per-edge body).

Each wrapper launches the kernel for CUDA tensors and runs its plain
version for CPU tensors: :func:`condense_plain`, an eager transcription of
the reference, :func:`condense_batch_plain`, that one a shard, stacked, and
:func:`condense_scenarios_plain`, that one a scenario, stacked.

The blocked route's adjoint (:mod:`...adjoint`) ends in K1's transpose:
:func:`condense_vjp` (plain version :func:`condense_vjp_plain`), a thread
an edge reading the saved λ and the adjoint solve's ``z`` at the edge's
ends, chains their cotangents through ``const``, ``w = 1/W``, ``W(R)``,
``g(R, f)`` and ``Ftot(f)`` back to R, f and the boundary data.
"""

from __future__ import annotations

import ctypes

import torch

from ..blocked import DevicePlan, _BlockedPlan, _condensed_scalar_constants
from . import build

__all__ = ["condense", "condense_plain", "condense_batch", "condense_batch_plain", "Batch",
           "cuda_launches", "MODES", "MAX_SHARDS", "condense_scenarios",
           "condense_scenarios_plain", "condense_vjp", "condense_vjp_plain"]

MODES = {"scalar": 0, "edge": 1, "cell": 2}
MAX_SHARDS = 32  # CONDENSE_MAX_SHARDS in csrc/condense.cu: the shards of one launch


def _constants(k: int) -> tuple[float, float, float]:
    """(wt, cs0, cs1): total and column sums of the condensed cell matrix."""
    if k == 1:
        return 1.0, 0.5, 0.5
    _, csum, wt, _ = _condensed_scalar_constants(k)
    return float(wt), float(csum[0]), float(csum[1])


def condense_plain(
    plan: _BlockedPlan,
    N: int,
    k: int,
    h_e: torch.Tensor,
    R_data: torch.Tensor,
    f_data: torch.Tensor,
    R_mode: str,
    f_mode: str,
    start_pbc: torch.Tensor,
    end_pbc: torch.Tensor,
):
    """Eager version: returns ``(W, w, g, Ftot, const)``."""
    dt, dev = torch.float64, h_e.device
    E = h_e.shape[0]
    wt, cs0, cs1 = _constants(k)
    if R_mode in ("scalar", "edge"):
        a1 = (R_data[0] * torch.ones(E, dtype=dt, device=dev) if R_mode == "scalar" else R_data) * h_e
        a2 = None
        W = a1 * (N * wt)
    else:
        a2 = R_data * h_e[None, :]
        a1 = None
        W = wt * torch.sum(a2, dim=0)
    if f_mode in ("scalar", "edge"):
        F1 = (f_data[0] * torch.ones(E, dtype=dt, device=dev) if f_mode == "scalar" else f_data) * h_e
        Ftot = F1 * N
        cumF = None
    else:
        F2 = f_data * h_e[None, :]
        F1 = None
        cumF = torch.cat([torch.zeros((1, E), dtype=dt, device=dev), torch.cumsum(F2, dim=0)])
        Ftot = cumF[-1]
    if a1 is not None and F1 is not None:
        g = a1 * F1 * (wt * (N * (N - 1) / 2.0) + cs1 * N)
    else:
        if cumF is None:
            j = torch.arange(N + 1, dtype=dt, device=dev)
            cumF = F1[None, :] * j[:, None]
        wsum = cs0 * cumF[:-1] + cs1 * cumF[1:]
        g = a1 * torch.sum(wsum, dim=0) if a2 is None else torch.sum(a2 * wsum, dim=0)
    w = 1.0 / W
    s_b = torch.as_tensor(plan.s_is_bif, device=dev)
    t_b = torch.as_tensor(plan.t_is_bif, device=dev)
    const = (-start_pbc * (~s_b) + end_pbc * (~t_b) - g) * w
    return W, w, g, Ftot, const


# ---------------------------------------------------------------- kernel


class _Shard(ctypes.Structure):
    """``CondenseShard`` of ``csrc/condense.cu``."""

    _fields_ = [(name, ctypes.c_void_p)
                for name in ("h_e", "R", "f", "start_pbc", "end_pbc", "edge_src", "edge_tgt")]


class _Args(ctypes.Structure):
    """``CondenseArgs`` of ``csrc/condense.cu``."""

    _fields_ = [("S", ctypes.c_int), ("s0", ctypes.c_int), ("rows", ctypes.c_int),
                ("E", ctypes.c_int), ("N", ctypes.c_int), ("R_mode", ctypes.c_int),
                ("f_mode", ctypes.c_int), ("wt", ctypes.c_double), ("cs0", ctypes.c_double),
                ("cs1", ctypes.c_double), ("g_closed", ctypes.c_double),
                ("s", _Shard * MAX_SHARDS)]


class Batch:
    """What K1 keeps fixed for S shards of one device: each shard's plan
    (a ``DevicePlan``, ``EndsPlan`` or ``GridDevicePlan``: its ``edge_src``,
    ``edge_tgt`` and the host ``plan`` the plain version reads), ``N``,
    ``k``, the modes and the condensed matrix's constants; on a CUDA device
    the launch's structs of pointers, one a :data:`MAX_SHARDS` shards, with
    the row ends filled in once.  Every shard has ``E`` rows: plans of
    unequal length raise."""

    def __init__(self, plans, N: int, k: int, R_mode: str, f_mode: str):
        self.plans = tuple(plans)
        if not self.plans:
            raise ValueError("condense: a batch of at least one shard")
        lengths = {p.num_edges for p in self.plans}
        if len(lengths) != 1:
            raise ValueError(f"condense: the shards must have one length, got {sorted(lengths)}")
        if R_mode not in MODES or f_mode not in MODES:
            raise ValueError(f"condense: unknown modes {(R_mode, f_mode)}")
        (self.E,) = lengths
        self.S, self.N, self.k = len(self.plans), int(N), int(k)
        self.R_mode, self.f_mode = R_mode, f_mode
        self.wt, self.cs0, self.cs1 = _constants(k)
        self.g_closed = self.wt * (N * (N - 1) / 2.0) + self.cs1 * N
        self.shapes = {"scalar": (1,), "edge": (self.E,), "cell": (self.N, self.E)}
        dev = self.plans[0].edge_src.device
        self.index = dev.index if dev.type == "cuda" else -1
        self._args = []
        if self.index < 0:
            return
        for p in self.plans:
            for t in (p.edge_src, p.edge_tgt):
                if (not t.is_cuda or t.get_device() != self.index or t.dtype != torch.int32
                        or not t.is_contiguous() or tuple(t.shape) != (self.E,)):
                    raise ValueError(f"condense: the row ends must be contiguous ({self.E},) int32 "
                                     f"tensors on CUDA device {self.index}")
        for s0 in range(0, self.S, MAX_SHARDS):
            args = _Args(S=min(MAX_SHARDS, self.S - s0), s0=s0, rows=self.S, E=self.E, N=self.N,
                         R_mode=MODES[R_mode], f_mode=MODES[f_mode], wt=self.wt, cs0=self.cs0,
                         cs1=self.cs1, g_closed=self.g_closed)
            for a, p in zip(args.s, self.plans[s0 : s0 + MAX_SHARDS]):
                a.edge_src, a.edge_tgt = p.edge_src.data_ptr(), p.edge_tgt.data_ptr()
            self._args.append((args, ctypes.addressof(args)))

    def check(self, ins) -> None:
        """Raise unless ``ins`` holds one ``(h_e, R, f, start_pbc, end_pbc)``
        a shard, each of its shard's length (the device is the launch's)."""
        if len(ins) != self.S:
            raise ValueError(f"condense: inputs of {self.S} shards expected, got {len(ins)}")
        R_shape, f_shape = self.shapes[self.R_mode], self.shapes[self.f_mode]
        for h_e, R, f, sp, ep in ins:
            if (h_e.shape != (self.E,) or sp.shape != (self.E,) or ep.shape != (self.E,)
                    or R.shape != R_shape or f.shape != f_shape):
                raise ValueError(
                    f"condense: a shard's h_e and boundary data must be ({self.E},), R "
                    f"{R_shape} and f {f_shape}; got {tuple(h_e.shape)}, {tuple(R.shape)}, "
                    f"{tuple(f.shape)}, {tuple(sp.shape)}, {tuple(ep.shape)}")

    def launch(self, ins, out: torch.Tensor) -> None:
        """One launch a :data:`MAX_SHARDS` shards of ``ins`` into ``out``
        ``(5, S, E)``: the lean path (one check pass, the raw stream, three
        ctypes arguments)."""
        index = self.index
        if index < 0:
            raise ValueError("condense: the batch's row ends are not on a CUDA device")
        cell = "cell" in (self.R_mode, self.f_mode)
        for h_e, R, f, sp, ep in ins:  # their shapes: check()
            build.require_vectors("condense", index, (h_e, self.E), (sp, self.E), (ep, self.E))
            if cell:  # a (N, E) block
                build.require_cuda("condense", h_e, R, f)
            else:
                build.require_vectors("condense", index, (R, R.shape[0]), (f, f.shape[0]))
        lib = build.library()
        stream = build.raw_stream(index)
        for chunk, (args, ptr) in enumerate(self._args):
            s0 = chunk * MAX_SHARDS
            for a, (h_e, R, f, sp, ep) in zip(args.s, ins[s0 : s0 + MAX_SHARDS]):
                a.h_e, a.R, a.f = h_e.data_ptr(), R.data_ptr(), f.data_ptr()
                a.start_pbc, a.end_pbc = sp.data_ptr(), ep.data_ptr()
            build.check(build.on_device(index, lib.nxfx_condense, ptr, out.data_ptr(), stream),
                        "condense")
            condense.launches += 1


def cuda_launches(batch: Batch) -> int:
    """K1's launches a call on ``batch``'s device: one a :data:`MAX_SHARDS`
    shards (1 a device a solve on the sharded routes)."""
    return -(-batch.S // MAX_SHARDS)


def condense_batch_plain(batch: Batch, ins) -> torch.Tensor:
    """Eager version of :func:`condense_batch`: :func:`condense_plain` a
    shard, stacked ``(5, S, E)``."""
    batch.check(ins)
    return torch.stack([torch.stack(condense_plain(p.plan, batch.N, batch.k, h_e, R, f,
                                                   batch.R_mode, batch.f_mode, sp, ep))
                        for p, (h_e, R, f, sp, ep) in zip(batch.plans, ins)], dim=1)


def condense_batch(batch: Batch, ins) -> torch.Tensor:
    """K1 of every shard of ``batch`` (``ins`` a shard ``(h_e, R, f,
    start_pbc, end_pbc)``, in the batch's order) on their device: the ``(5,
    S, E)`` planes ``W, w, g, Ftot, const``, one launch."""
    batch.check(ins)
    h_e = ins[0][0]
    if h_e.device.type == "cpu":
        return condense_batch_plain(batch, ins)
    if not h_e.is_cuda:
        raise ValueError("condense: tensors must be on a CUDA device")
    out = torch.empty((5, batch.S, batch.E), dtype=torch.float64, device=h_e.device)
    batch.launch(ins, out)
    return out


def condense(
    dplan: DevicePlan,
    N: int,
    k: int,
    h_e: torch.Tensor,
    R_data: torch.Tensor,
    f_data: torch.Tensor,
    R_mode: str,
    f_mode: str,
    start_pbc: torch.Tensor,
    end_pbc: torch.Tensor,
):
    """K1 on ``h_e``'s device: ``(W, w, g, Ftot, const)``, each (E,) (views
    of one buffer on a CUDA device)."""
    if h_e.device.type == "cpu":
        return condense_plain(
            dplan.plan, N, k, h_e, R_data, f_data, R_mode, f_mode, start_pbc, end_pbc
        )
    if not h_e.is_cuda:
        raise ValueError("condense: tensors must be on a CUDA device")
    key = ("condense", N, k, R_mode, f_mode)
    batch = dplan._scratch.get(key)
    if batch is None:
        batch = dplan._scratch[key] = Batch((dplan,), N, k, R_mode, f_mode)
    ins = ((h_e, R_data, f_data, start_pbc, end_pbc),)
    batch.check(ins)
    out = torch.empty((5, batch.E), dtype=torch.float64, device=h_e.device)
    batch.launch(ins, out)
    return out.unbind(0)


condense.launches = 0


# ---------------------------------------------------------------- scenarios


class _ScenArgs(ctypes.Structure):
    """``CondenseScenArgs`` of ``csrc/condense.cu``."""

    _fields_ = [("S", ctypes.c_int), ("E", ctypes.c_int), ("N", ctypes.c_int),
                ("R_mode", ctypes.c_int), ("f_mode", ctypes.c_int), ("wt", ctypes.c_double),
                ("cs0", ctypes.c_double), ("cs1", ctypes.c_double), ("g_closed", ctypes.c_double),
                ("s", _Shard), ("sR", ctypes.c_longlong), ("sf", ctypes.c_longlong),
                ("ssp", ctypes.c_longlong), ("sep", ctypes.c_longlong)]


def _scenario_shapes(N: int, E: int, R_mode: str, f_mode: str) -> dict:
    """A scenario's shapes: what each input is when it is shared."""
    shapes = {"scalar": (1,), "edge": (E,), "cell": (N, E)}
    if R_mode not in shapes or f_mode not in shapes:
        raise ValueError(f"condense: unknown modes {(R_mode, f_mode)}")
    return {"R": shapes[R_mode], "f": shapes[f_mode], "sp": (E,), "ep": (E,)}


def condense_scenarios_plain(dplan, N: int, k: int, h_e: torch.Tensor, R_data: torch.Tensor,
                             f_data: torch.Tensor, R_mode: str, f_mode: str,
                             start_pbc: torch.Tensor, end_pbc: torch.Tensor) -> torch.Tensor:
    """Eager version of :func:`condense_scenarios`: :func:`condense_plain` a
    scenario, stacked ``(5, S, E)``."""
    base = _scenario_shapes(N, h_e.shape[0], R_mode, f_mode)
    ins = {"R": R_data, "f": f_data, "sp": start_pbc, "ep": end_pbc}
    S = build.scenarios("condense", *((t, base[n]) for n, t in ins.items()))
    rows = []
    for i in range(S):
        r = {n: build.scenario_row(t, base[n], i) for n, t in ins.items()}
        rows.append(torch.stack(condense_plain(dplan.plan, N, k, h_e, r["R"], r["f"], R_mode,
                                               f_mode, r["sp"], r["ep"])))
    return torch.stack(rows, dim=1)


def condense_scenarios(dplan, N: int, k: int, h_e: torch.Tensor, R_data: torch.Tensor,
                       f_data: torch.Tensor, R_mode: str, f_mode: str, start_pbc: torch.Tensor,
                       end_pbc: torch.Tensor) -> torch.Tensor:
    """K1 of S scenarios of ``dplan`` on ``h_e``'s device, one launch: each of
    ``R_data``, ``f_data``, ``start_pbc``, ``end_pbc`` is batched, ``(S,) +``
    its one-scenario shape, or shared; returns the ``(5, S, E)`` planes ``W,
    w, g, Ftot, const``."""
    if h_e.device.type == "cpu":
        return condense_scenarios_plain(dplan, N, k, h_e, R_data, f_data, R_mode, f_mode,
                                        start_pbc, end_pbc)
    if not h_e.is_cuda:
        raise ValueError("condense: tensors must be on a CUDA device")
    E = dplan.num_edges
    base = _scenario_shapes(N, E, R_mode, f_mode)
    ins = {"R": R_data, "f": f_data, "sp": start_pbc, "ep": end_pbc}
    S = build.scenarios("condense", *((t, base[n]) for n, t in ins.items()))
    build.require_vectors("condense", h_e.get_device(), (h_e, E))
    build.require_cuda("condense", h_e, R_data, f_data, start_pbc, end_pbc)
    build.require_cuda("condense", dplan.edge_src, dplan.edge_tgt, dtype=torch.int32)
    wt, cs0, cs1 = _constants(k)
    args = _ScenArgs(S=S, E=E, N=N, R_mode=MODES[R_mode], f_mode=MODES[f_mode], wt=wt, cs0=cs0,
                     cs1=cs1, g_closed=wt * (N * (N - 1) / 2.0) + cs1 * N,
                     sR=build.scenario_stride(R_data, base["R"]),
                     sf=build.scenario_stride(f_data, base["f"]),
                     ssp=build.scenario_stride(start_pbc, base["sp"]),
                     sep=build.scenario_stride(end_pbc, base["ep"]))
    a = args.s
    a.h_e, a.R, a.f = h_e.data_ptr(), R_data.data_ptr(), f_data.data_ptr()
    a.start_pbc, a.end_pbc = start_pbc.data_ptr(), end_pbc.data_ptr()
    a.edge_src, a.edge_tgt = dplan.edge_src.data_ptr(), dplan.edge_tgt.data_ptr()
    out = torch.empty((5, S, E), dtype=torch.float64, device=h_e.device)
    index = h_e.get_device()
    lib = build.library()
    build.check(build.on_device(index, lib.nxfx_condense_scen, ctypes.addressof(args),
                                out.data_ptr(), build.raw_stream(index)), "condense_scenarios")
    condense_scenarios.launches += 1
    return out


condense_scenarios.launches = 0


# ---------------------------------------------------------------- the adjoint (K1ᵀ)


def condense_vjp_plain(plan, N: int, k: int, h_e: torch.Tensor, R_data: torch.Tensor,
                       f_data: torch.Tensor, R_mode: str, f_mode: str, start_pbc: torch.Tensor,
                       end_pbc: torch.Tensor, w: torch.Tensor, g: torch.Tensor, lam: torch.Tensor,
                       z: torch.Tensor, bars: torch.Tensor, R_part: torch.Tensor,
                       f_part: torch.Tensor):
    """Eager version of :func:`condense_vjp`: ``(R_bar, f_bar, sp_bar, ep_bar)``.

    With ``a_e`` the edge's column of the bifurcation incidence (+1 at its
    target, -1 at its source, 0 at a boundary end), the λ solve is ``S(w) λ
    = A const + T Ftot`` with ``S = Σ_e w_e a_e a_eᵀ``; given the adjoint
    ``z = S⁻¹ rho`` and K5's cotangents ``bars`` (:func:`..expand.expand_vjp`)
    each edge gets ``w̄ = q̄0 (r0 + rN - g) - (a_eᵀz)(a_eᵀλ) + (a_eᵀz) ĉ``
    (``ĉ = const / w``), ``c̄onst = a_eᵀz``, ``F̄tot = z_t``, then the chain
    through ``const``, ``w = 1/W``, ``W(R)``, ``g(R, f)`` and ``Ftot(f)``,
    added to K5's shares ``R_part`` and ``f_part`` (summed over the edges for
    a ``"scalar"`` coefficient)."""
    from .expand import _lambda_to_edges

    dt, dev = torch.float64, h_e.device
    E = h_e.shape[0]
    wt, cs0, cs1 = _constants(k)
    s_b = torch.as_tensor(plan.s_is_bif, device=dev)
    t_b = torch.as_tensor(plan.t_is_bif, device=dev)
    lam_s, lam_t = _lambda_to_edges(plan, lam)
    z_s, z_t = _lambda_to_edges(plan, z)
    r0 = torch.where(s_b, lam_s, -start_pbc)
    rN = torch.where(t_b, -lam_t, end_pbc)
    num = r0 + rN - g  # q0 / w
    cnum = -start_pbc * (~s_b) + end_pbc * (~t_b) - g  # const / w
    q0_bar, r0_bar, rN_bar = bars
    a_z = z_t - z_s  # the cotangent of const
    w_bar = q0_bar * num - a_z * (lam_t - lam_s) + a_z * cnum
    g_bar = -(q0_bar + a_z) * w
    W_bar = -w_bar * w * w
    zero = torch.zeros_like(w)
    sp_bar = torch.where(s_b, zero, -r0_bar - a_z * w)
    ep_bar = torch.where(t_b, zero, rN_bar + a_z * w)
    r_cell, f_cell = R_mode == "cell", f_mode == "cell"
    a1 = None if r_cell else (R_data if R_mode == "edge" else R_data[0]) * h_e
    F1 = None if f_cell else (f_data if f_mode == "edge" else f_data[0]) * h_e
    if not r_cell and not f_cell:
        g_closed = wt * (N * (N - 1) / 2.0) + cs1 * N
        R_own = (W_bar * (N * wt) + g_bar * F1 * g_closed) * h_e
        f_own = (g_bar * a1 * g_closed + z_t * N) * h_e
    else:
        zrow = torch.zeros((1, E), dtype=dt, device=dev)
        c = torch.arange(N + 1, dtype=dt, device=dev)[:, None]
        cumF = torch.cat([zrow, torch.cumsum(f_data * h_e[None, :], dim=0)]) if f_cell else F1 * c
        wsum = cs0 * cumF[:-1] + cs1 * cumF[1:]
        ab = R_data * h_e[None, :] if r_cell else a1 * torch.ones((N, E), dtype=dt, device=dev)
        if r_cell:
            R_own = (g_bar * wsum + W_bar * wt) * h_e[None, :]
        else:
            R_own = (W_bar * (N * wt) + g_bar * torch.sum(wsum, dim=0)) * h_e
        if f_cell:
            # cumF_j's cotangent ḡ (cs0 ab_j + cs1 ab_{j-1}), summed from j = c + 1 up
            cum_bar = g_bar * (cs0 * torch.cat([ab[1:], zrow]) + cs1 * ab)
            suffix = torch.flip(torch.cumsum(torch.flip(cum_bar, [0]), dim=0), [0])
            f_own = (suffix + z_t) * h_e[None, :]
        else:
            f_own = (g_bar * torch.sum(ab * (cs0 * c[:-1] + cs1 * c[1:]), dim=0) + z_t * N) * h_e
    R_bar, f_bar = R_part + R_own, f_part + f_own
    if R_mode == "scalar":
        R_bar = torch.sum(R_bar).reshape(1)
    if f_mode == "scalar":
        f_bar = torch.sum(f_bar).reshape(1)
    return R_bar, f_bar, sp_bar, ep_bar


class _VjpArgs(ctypes.Structure):
    """``CondenseVjpArgs`` of ``csrc/condense.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in ("E", "N", "R_mode", "f_mode", "blocks")]
                + [(n, ctypes.c_double) for n in ("wt", "cs0", "cs1", "g_closed")]
                + [(n, ctypes.c_void_p) for n in (
                    "edge_src", "edge_tgt", "h_e", "R", "f", "start_pbc", "end_pbc", "w", "g",
                    "lam", "z", "bars", "R_part", "f_part", "R_bar", "f_bar", "sp_bar", "ep_bar",
                    "partial")])


VJP_THREADS = 256  # THREADS in csrc/condense.cu: a block's edges, its partial's share


def condense_vjp(dplan: DevicePlan, N: int, k: int, h_e: torch.Tensor, R_data: torch.Tensor,
                 f_data: torch.Tensor, R_mode: str, f_mode: str, start_pbc: torch.Tensor,
                 end_pbc: torch.Tensor, w: torch.Tensor, g: torch.Tensor, lam: torch.Tensor,
                 z: torch.Tensor, bars: torch.Tensor, R_part: torch.Tensor,
                 f_part: torch.Tensor):
    """K1's transpose on ``h_e``'s device (see :func:`condense_vjp_plain`):
    ``(R_bar, f_bar, sp_bar, ep_bar)``, the cotangents of K1's inputs, from
    the saved ``λ``, the adjoint ``z`` (both (B,)) and
    :func:`..expand.expand_vjp`'s outputs.  One launch a thread an edge,
    reading ``λ`` and ``z`` at the edge's ends through the plan's row ends;
    an ``"edge"`` or ``"cell"`` coefficient's cotangent is written over its
    ``R_part`` or ``f_part`` (returned as ``R_bar``, ``f_bar``); a
    ``"scalar"`` one's is summed deterministically (each block's partial in a
    halving tree, then a second launch of one block adding the partials in
    block order)."""
    if h_e.device.type == "cpu":
        return condense_vjp_plain(dplan.plan, N, k, h_e, R_data, f_data, R_mode, f_mode,
                                  start_pbc, end_pbc, w, g, lam, z, bars, R_part, f_part)
    build.require_cuda("condense_vjp", h_e, R_data, f_data, start_pbc, end_pbc, w, g, lam, z,
                       bars, R_part, f_part)
    build.require_cuda("condense_vjp", dplan.edge_src, dplan.edge_tgt, dtype=torch.int32)
    B, E = dplan.num_bifurcations, dplan.num_edges
    if (any(tuple(t.shape) != (E,) for t in (h_e, start_pbc, end_pbc, w, g))
            or tuple(lam.shape) != (B,) or tuple(z.shape) != (B,) or tuple(bars.shape) != (3, E)):
        raise ValueError("condense_vjp: the per-edge inputs must be (E,), lam and z (B,), bars "
                         "(3, E)")
    build.require_coefficients("condense_vjp", N, E, ("R", R_data, R_mode), ("f", f_data, f_mode))
    part_shape = {"scalar": (E,), "edge": (E,), "cell": (N, E)}
    if tuple(R_part.shape) != part_shape[R_mode] or tuple(f_part.shape) != part_shape[f_mode]:
        raise ValueError("condense_vjp: R_part and f_part must be (N, E) in cell mode, else (E,)")
    dev = h_e.device
    blocks = -(-E // VJP_THREADS)
    R_bar = torch.empty(1, dtype=torch.float64, device=dev) if R_mode == "scalar" else R_part
    f_bar = torch.empty(1, dtype=torch.float64, device=dev) if f_mode == "scalar" else f_part
    sp_bar, ep_bar = (torch.empty(E, dtype=torch.float64, device=dev) for _ in range(2))
    partial = torch.empty(2 * max(blocks, 1), dtype=torch.float64, device=dev)
    wt, cs0, cs1 = _constants(k)
    a = _VjpArgs(E=E, N=N, R_mode=MODES[R_mode], f_mode=MODES[f_mode], blocks=blocks, wt=wt,
                 cs0=cs0, cs1=cs1, g_closed=wt * (N * (N - 1) / 2.0) + cs1 * N,
                 edge_src=dplan.edge_src.data_ptr(), edge_tgt=dplan.edge_tgt.data_ptr(),
                 h_e=h_e.data_ptr(), R=R_data.data_ptr(), f=f_data.data_ptr(),
                 start_pbc=start_pbc.data_ptr(), end_pbc=end_pbc.data_ptr(), w=w.data_ptr(),
                 g=g.data_ptr(), lam=lam.data_ptr(), z=z.data_ptr(), bars=bars.data_ptr(),
                 R_part=R_part.data_ptr(), f_part=f_part.data_ptr(), R_bar=R_bar.data_ptr(),
                 f_bar=f_bar.data_ptr(), sp_bar=sp_bar.data_ptr(), ep_bar=ep_bar.data_ptr(),
                 partial=partial.data_ptr())
    index = h_e.get_device()
    build.check(build.on_device(index, build.library().nxfx_condense_vjp, ctypes.addressof(a),
                                build.raw_stream(index)), "condense_vjp")
    condense_vjp.launches += 1
    return R_bar, f_bar, sp_bar, ep_bar


condense_vjp.launches = 0
