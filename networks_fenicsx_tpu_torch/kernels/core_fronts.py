"""K12b: the supernodal fronts of the sparse core elimination (``csrc/core_fronts.cu``).

Replaces the front tail of ``networks_fenicsx_tpu/ops/core_elim.py:_core_factor``
(``:934-976``) and the front sweeps of ``_core_apply`` (``:1016-1041``).  Per
front, in plan order: assemble ``F (m, m)``, ``m = w + b``, from the diagonal
``d`` on its ``w`` pivots, the slot values ``init_ext[f_init] − fold(ustream,
f_fold)`` at ``(slot_i, slot_j)`` and their mirror, and the update matrices
of the fronts it consumes, extend-added through each inverse map ``lminv``
as a gather; factor its first ``w`` columns in float64, ``F_SS = L Lᵀ`` with
``Y = L⁻¹F_SB`` and ``U = F_BB − YᵀY`` for its consumer; the zero-pivot gate
(every ``L_ii`` finite and ``min > 1e-12·max``).  Then the sweeps: forward
``y = L⁻¹r_S``, ``r_B −= Yᵀy`` in front order; back, in reverse,
``λ_S = L⁻ᵀ(y − Y λ_B)``; λ is NaN everywhere when the gate trips.

The reference keeps ``C = chol(F_SS)``, ``X = F_SS⁻¹F_SB`` and
``U = F_BB − F_BS X``: the same factor and sweeps, associated otherwise
(``Xᵀr_S = Yᵀ(L⁻¹r_S)``, ``C⁻ᵀC⁻¹r_S − Xλ_B = L⁻ᵀ(L⁻¹r_S − Yλ_B)``); the
kernel and the plain version both take the ``L``, ``Y`` form, and the plain
version's ``U`` is the lower triangle mirrored, as the kernel reads it.

:func:`core_fronts` launches for CUDA tensors (the factor, the gate and the
sweeps of ``csrc/core_fronts.cu`` on the tiled factor and solves of
``csrc/tiled_cholesky.cuh``, with K10 for the slot folds) and runs
:func:`core_fronts_plain` for CPU tensors.  Factor reuse splits it:
:func:`core_fronts_factor` once (the folds, the assemblies, the factors and
the gate into a front buffer of its own, a :class:`FrontsFactor`), then
:func:`core_fronts_apply` a right-hand side (the sweeps and the NaN gate,
with scratch of its own; the front buffer is only read).  ``core_fronts``
is the two in a row, and each has its plain version.
"""

from __future__ import annotations

import typing

import torch

from ..ops.core_elim import DeviceCorePlan
from . import build, fold
from .dense_core import tiled_factor_launches, tiled_solve_launches

__all__ = [
    "FrontsFactor", "PIVOT_RTOL", "apply_launches", "core_fronts", "core_fronts_apply",
    "core_fronts_apply_plain", "core_fronts_factor", "core_fronts_factor_plain", "core_fronts_plain",
    "cuda_launches", "factor_launches", "front_factor_plain",
]

PIVOT_RTOL = 1e-12


def front_factor_plain(F: torch.Tensor, w: int) -> tuple:
    """``(L, Y, U, ok)`` of one assembled front ``F (m, m)`` with ``w``
    pivots: ``L`` of ``F_SS``, ``Y = L⁻¹F_SB`` and the lower triangle of
    ``U = F_BB − YᵀY`` mirrored (both None without a boundary), ``ok`` the
    zero-pivot gate."""
    L, info = torch.linalg.cholesky_ex(F[:w, :w])
    piv = torch.diagonal(L)
    ok = (info == 0) & torch.all(torch.isfinite(piv)) & (piv.min() > PIVOT_RTOL * piv.max())
    if F.shape[0] == w:
        return L, None, None, ok
    Y = torch.linalg.solve_triangular(L, F[:w, w:], upper=False)
    U = torch.tril(F[w:, w:] - Y.T @ Y)
    return L, Y, U + torch.tril(U, -1).T, ok


class FrontsFactor(typing.NamedTuple):
    """K12b's stored factor: every front's ``L`` and ``Y`` and the gate."""

    fronts: typing.Any  # the kernel's front buffer (f_len,): each front's (m, m) block, L
    # and Yᵀ in its first w columns (its trailing U read by its consumer); the plain
    # version's ((L, Y), ...) a front, Y None without a boundary
    ok: torch.Tensor  # () the zero-pivot gate: int32 on the card, bool in the plain version


def core_fronts_factor_plain(dcp: DeviceCorePlan, d: torch.Tensor, ustream: torch.Tensor,
                             w_pairs: torch.Tensor) -> FrontsFactor:
    """Eager version of the fronts' factor: per front the assembly, the
    extend-add of the fronts it consumes and :func:`front_factor_plain`,
    from the diagonal ``d`` after the rounds and the update stream
    ``ustream`` (its last entry 0)."""
    dt, dev = torch.float64, d.device
    zero = torch.zeros(1, dtype=dt, device=dev)
    init_ext = torch.cat([-w_pairs[dcp.init_slot.long()], zero])
    pending: dict[int, torch.Tensor] = {}
    factors = []
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for fid, fr in enumerate(dcp.fronts):
        w, m = fr.w, fr.w + fr.b
        F = torch.zeros((m, m), dtype=dt, device=dev)
        ar = torch.arange(w, device=dev)
        F[ar, ar] = F[ar, ar] + d[fr.nodes.long()]
        if fr.slot_i.shape[0]:
            sval = init_ext[fr.f_init.long()]
            if fr.f_fold:
                sval = sval - fold.fold_apply_plain(ustream, fr.f_fold)
            fi, fj = fr.slot_i.long(), fr.slot_j.long()
            F[fi, fj] = F[fi, fj] + sval
            F[fj, fi] = F[fj, fi] + sval
        for c, cid in enumerate(fr.consume):
            Upad = torch.nn.functional.pad(pending.pop(cid), (0, 1, 0, 1))
            lmi = fr.lminv[c * m : (c + 1) * m].long()
            F = F + Upad[lmi[:, None], lmi[None, :]]
        L, Y, U, front_ok = front_factor_plain(F, w)
        ok = ok & front_ok
        if U is not None:
            pending[fid] = U
        factors.append((L, Y))
    return FrontsFactor(tuple(factors), ok)


def core_fronts_apply_plain(dcp: DeviceCorePlan, ff: FrontsFactor, r: torch.Tensor) -> torch.Tensor:
    """Eager version of the fronts' sweeps on a stored factor: ``λ (n_core +
    1,)`` on the fronts' nodes (zero elsewhere, NaN everywhere when a gate
    tripped) from the rhs ``r`` after the rounds (not modified)."""
    dt, dev = torch.float64, r.device
    r = r.clone()
    ys = []
    for fr, (L, Y) in zip(dcp.fronts, ff.fronts):
        y = torch.linalg.solve_triangular(L, r[fr.nodes.long()][:, None], upper=False)[:, 0]
        ys.append(y)
        if Y is not None:
            b = fr.bnd.long()
            r[b] = r[b] - Y.T @ y
    lam = torch.zeros(dcp.n_core + 1, dtype=dt, device=dev)
    for fr, (L, Y), y in zip(reversed(dcp.fronts), reversed(ff.fronts), reversed(ys)):
        t = y if Y is None else y - Y @ lam[fr.bnd.long()]
        lam[fr.nodes.long()] = torch.linalg.solve_triangular(L.T, t[:, None], upper=True)[:, 0]
    return torch.where(ff.ok.bool(), lam, torch.nan)


def core_fronts_plain(dcp: DeviceCorePlan, d: torch.Tensor, ustream: torch.Tensor,
                      w_pairs: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Eager version: ``λ (n_core + 1,)`` on the fronts' nodes (zero
    elsewhere, NaN everywhere when a gate trips), from the diagonal ``d``
    and rhs ``r`` after the rounds and the update stream ``ustream``: the
    sweeps of :func:`core_fronts_apply_plain` on :func:`core_fronts_factor_plain`."""
    return core_fronts_apply_plain(dcp, core_fronts_factor_plain(dcp, d, ustream, w_pairs), r)


def _check(name: str, dcp: DeviceCorePlan, *vectors: torch.Tensor) -> None:
    if any(tuple(v.shape) != (dcp.n_core,) for v in vectors) or not dcp.fronts:
        raise ValueError(f"{name}: d and r must be (n_core,) and the plan must have fronts")


def _factor(dcp: DeviceCorePlan, d: torch.Tensor, ustream: torch.Tensor,
            w_pairs: torch.Tensor) -> FrontsFactor:
    """The fronts' factor launches (per front its slot fold, the assembly,
    the tiled factor and the gate) into a new front buffer."""
    dev, lib = d.device, build.library()
    stream = build.stream_handle(dev)
    fbuf = torch.empty(dcp.f_len, dtype=torch.float64, device=dev)
    ok = torch.empty((), dtype=torch.int32, device=dev)
    P0 = dcp.n_pairs
    with torch.cuda.device(dev):
        for fid, fr in enumerate(dcp.fronts):
            sf = fold.fold_apply(ustream, fr.f_fold) if fr.f_fold else None
            code = lib.nxfx_front_factor(
                fr.w, fr.b, fr.slot_i.shape[0], P0, int(fid == 0), fr.nodes.data_ptr(),
                d.data_ptr(), fr.slot_i.data_ptr(), fr.slot_j.data_ptr(), fr.f_init.data_ptr(),
                dcp.init_slot.data_ptr(), w_pairs.data_ptr(), None if sf is None else sf.data_ptr(),
                len(fr.consume), fr.cons.ctypes.data, fr.lminv.data_ptr(), fbuf.data_ptr(),
                fr.f_off, ok.data_ptr(), stream,
            )
            build.check(code, "core_fronts")
    return FrontsFactor(fbuf, ok)


def _apply(dcp: DeviceCorePlan, ff: FrontsFactor, r: torch.Tensor) -> torch.Tensor:
    """The sweeps' launches on a stored front buffer (read only), with a
    forward stream and solve scratch of their own; ``r`` takes the forward
    sweep's updates in place."""
    dev, dt, lib = r.device, torch.float64, build.library()
    stream = build.stream_handle(dev)
    fbuf = ff.fronts
    ybuf = torch.empty(dcp.y_len, dtype=dt, device=dev)
    tbuf = torch.empty((2, max(fr.w for fr in dcp.fronts)), dtype=dt, device=dev)
    n = dcp.n_core
    with torch.cuda.device(dev):
        for fr in dcp.fronts:
            code = lib.nxfx_front_forward(
                fr.w, fr.b, fr.nodes.data_ptr(), fr.bnd.data_ptr(), fbuf.data_ptr(), fr.f_off,
                r.data_ptr(), tbuf[0].data_ptr(), ybuf.data_ptr() + 8 * fr.y_off, stream,
            )
            build.check(code, "core_fronts")
        lam = torch.zeros(n + 1, dtype=dt, device=dev)
        for fr in reversed(dcp.fronts):
            code = lib.nxfx_front_back(
                fr.w, fr.b, fr.nodes.data_ptr(), fr.bnd.data_ptr(), fbuf.data_ptr(), fr.f_off,
                ybuf.data_ptr() + 8 * fr.y_off, tbuf[0].data_ptr(), tbuf[1].data_ptr(),
                lam.data_ptr(), stream,
            )
            build.check(code, "core_fronts")
        code = lib.nxfx_front_nan_gate(n + 1, ff.ok.data_ptr(), lam.data_ptr(), stream)
        build.check(code, "core_fronts")
    return lam


def core_fronts(dcp: DeviceCorePlan, d: torch.Tensor, ustream: torch.Tensor,
                w_pairs: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """K12b on ``d``'s device: ``λ (n_core + 1,)`` (see the plain version);
    ``r`` takes the forward sweep's updates in place.  The factor's and the
    sweeps' launches of :func:`core_fronts_factor` and
    :func:`core_fronts_apply` in a row."""
    if d.device.type == "cpu":
        return core_fronts_plain(dcp, d, ustream, w_pairs, r)
    build.require_cuda("core_fronts", d, ustream, w_pairs, r)
    _check("core_fronts", dcp, d, r)
    lam = _apply(dcp, _factor(dcp, d, ustream, w_pairs), r)
    core_fronts.launches += 1
    return lam


core_fronts.launches = 0


def core_fronts_factor(dcp: DeviceCorePlan, d: torch.Tensor, ustream: torch.Tensor,
                       w_pairs: torch.Tensor) -> FrontsFactor:
    """K12b's factor on ``d``'s device, kept for the sweeps of
    :func:`core_fronts_apply`: per front the slot fold (K10), the assembly,
    the tiled factor and the gate, into a front buffer of its own;
    :func:`core_fronts_factor_plain` for CPU tensors."""
    if d.device.type == "cpu":
        return core_fronts_factor_plain(dcp, d, ustream, w_pairs)
    build.require_cuda("core_fronts_factor", d, ustream, w_pairs)
    _check("core_fronts_factor", dcp, d)
    ff = _factor(dcp, d, ustream, w_pairs)
    core_fronts_factor.launches += 1
    return ff


core_fronts_factor.launches = 0


def core_fronts_apply(dcp: DeviceCorePlan, ff: FrontsFactor, r: torch.Tensor) -> torch.Tensor:
    """K12b's sweeps and NaN gate on a stored factor on ``r``'s device:
    ``λ (n_core + 1,)``; ``r`` takes the forward sweep's updates in place,
    the factor is only read (applies on several streams may share it);
    :func:`core_fronts_apply_plain` for CPU tensors."""
    if r.device.type == "cpu":
        return core_fronts_apply_plain(dcp, ff, r)
    build.require_cuda("core_fronts_apply", ff.fronts, r)
    _check("core_fronts_apply", dcp, r)
    build.require_cuda("core_fronts_apply", ff.ok, dtype=torch.int32)
    if tuple(ff.fronts.shape) != (dcp.f_len,) or ff.ok.numel() != 1:
        raise ValueError("core_fronts_apply: the factor must be the plan's (f_len,) front buffer")
    lam = _apply(dcp, ff, r)
    core_fronts_apply.launches += 1
    return lam


core_fronts_apply.launches = 0


def fold_launches(levels) -> int:
    """K10 launches of one fold: one, unless it has no output rows."""
    return 1 if len(levels) and levels[-1].shape[0] else 0


def factor_launches(dcp: DeviceCorePlan) -> int:
    """CUDA kernel launches of one :func:`core_fronts_factor`: per front its
    slot fold, the assembly (one, one more with slots, one per consumed
    front), the factor and the gate."""
    n = 0
    for fr in dcp.fronts:
        m = fr.w + fr.b
        n += fold_launches(fr.f_fold) + 1 + (fr.slot_i.shape[0] > 0) + len(fr.consume)
        n += tiled_factor_launches(m, fr.w) + 1
    return n


def apply_launches(dcp: DeviceCorePlan) -> int:
    """CUDA kernel launches of one :func:`core_fronts_apply`: per front the
    forward sweep (gather, solve, the boundary push) and the back sweep
    (pull, solve, scatter); one NaN gate."""
    n = 1
    for fr in dcp.fronts:
        n += 1 + tiled_solve_launches(fr.w) + (fr.b > 0)
        n += 2 + tiled_solve_launches(fr.w)
    return n


def cuda_launches(dcp: DeviceCorePlan) -> int:
    """CUDA kernel launches of one :func:`core_fronts` call: the factor's
    and the sweeps'."""
    return factor_launches(dcp) + apply_launches(dcp)
