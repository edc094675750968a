"""Gradients through the blocked forest solve (the discrete adjoint).

The reference differentiates its blocked program with ``jax.grad``, the
transpose of ``networks_fenicsx_tpu/solver.py:_blocked_uniform_solve``
(``:2914-2972``): of the condensation (``:2776-2911``, ``const`` at
``:2950``), the level elimination (K2–K4, ``:2420-2517``), the λ gather to
the edges (``:2743``) and the recovery closure ``back`` (``:2866``).
:class:`BlockedSolve` is that transpose written out:

* forward — K1 (:func:`.kernels.condense.condense`), K2's factor
  (:func:`.kernels.tree_sweep.tree_sweep_factor`, kept for the backward),
  K3–K4's apply (:func:`.kernels.tree_sweep.tree_sweep_apply`; the full
  sweep's λ to the bit), K5 (:func:`.kernels.expand.expand`);
* backward — K5ᵀ (:func:`.kernels.expand.expand_vjp`), the fold of its
  endpoint cotangents into the bifurcations
  (:func:`.kernels.expand.expand_vjp_fold`), the adjoint λ solve ``z =
  S⁻¹ρ`` on the stored factor through K3–K4's apply
  (:func:`.kernels.tree_sweep.tree_sweep_solve`; ``S`` is symmetric), and
  K1ᵀ (:func:`.kernels.condense.condense_vjp`) back to R, f and the
  boundary data.

On CPU tensors every step runs its plain PyTorch version, on CUDA tensors
its kernel (or raises); nothing falls back.  The backward is not itself
differentiable (``once_differentiable``: a double backward raises, ROADMAP
A9c-4).  Every other executor refuses inputs that require grad
(:func:`refuse_grad`, ``NotImplementedError`` naming ROADMAP A9c) rather
than return outputs cut from the graph.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .kernels import condense, expand, tree_sweep

__all__ = ["BlockedSolve", "wants_grad", "refuse_grad"]


def wants_grad(*args) -> bool:
    """Whether autograd would record a graph through any of ``args``."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def refuse_grad(what: str, *args) -> None:
    """Raise ``NotImplementedError`` (ROADMAP A9c) when an input of ``what``,
    a solve without an adjoint, requires grad under grad mode."""
    if wants_grad(*args):
        raise NotImplementedError(
            f"ROADMAP A9c: gradients through {what} are not ported yet (the blocked route of "
            "uniformly-K-ary forests has them); call it under torch.no_grad() or on detached "
            "inputs")


class BlockedSolve(torch.autograd.Function):
    """The blocked solve of a ``_BlockedExecutor`` as one autograd node:
    ``apply(executor, R, f, start_pbc, end_pbc)`` on internal-order float64
    tensors of the executor's device returns ``(q_T, p_T, λ, rhs_norm,
    finite)``, the last two not differentiable."""

    @staticmethod
    def forward(ctx, ex, R, f, sp, ep):
        dp, N, k, h = ex.device_plan, ex._N, ex._k, ex._h_e
        Rm, fm = ex._R_mode, ex._f_mode
        W, w, g, Ftot, const = condense.condense(dp, N, k, h, R, f, Rm, fm, sp, ep)
        d, wn, fac = tree_sweep.tree_sweep_factor(dp, w)
        lam, rhs_norm, _ = tree_sweep.tree_sweep_apply(dp, d, wn, fac, const, Ftot)
        q_T, p_T, finite = expand.expand(dp, N, k, lam, sp, ep, W, w, g, Ftot, h, R, f, Rm, fm)
        ctx.ex = ex
        ctx.save_for_backward(R, f, sp, ep, w, g, d, wn, fac, lam)
        ctx.mark_non_differentiable(rhs_norm, finite)
        return q_T, p_T, lam, rhs_norm, finite

    @staticmethod
    @once_differentiable
    def backward(ctx, q_bar, p_bar, lam_bar, _rhs_norm_bar, _finite_bar):
        ex = ctx.ex
        R, f, sp, ep, w, g, d, wn, fac, lam = ctx.saved_tensors
        dp, N, k, h = ex.device_plan, ex._N, ex._k, ex._h_e
        Rm, fm = ex._R_mode, ex._f_mode
        bars, R_part, f_part = expand.expand_vjp(dp, N, k, lam, sp, ep, w, g, h, R, f, Rm, fm,
                                                 q_bar.contiguous(), p_bar.contiguous())
        _, rhs_edges = expand.expand_vjp_fold(dp, lam_bar.contiguous(), bars)
        z = tree_sweep.tree_sweep_solve(dp, d, wn, fac, rhs_edges)
        R_bar, f_bar, sp_bar, ep_bar = condense.condense_vjp(dp, N, k, h, R, f, Rm, fm, sp, ep, w,
                                                             g, lam, z, bars, R_part, f_part)
        if ex.f_elided:  # the reference's program ignores its f argument
            f_bar = torch.zeros_like(f)
        return None, R_bar, f_bar, sp_bar, ep_bar
