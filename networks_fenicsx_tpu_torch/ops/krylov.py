"""Preconditioned conjugate gradients and the Chebyshev-Jacobi
preconditioner of the λ system.

Counterpart of ``networks_fenicsx_tpu/ops/krylov.py``: ``KrylovResult``,
``cg`` (``:78-119``) and ``chebyshev_preconditioner`` (``:20-68``).  The
reference runs CG in one ``lax.while_loop``; here the host launches the
iterations, :data:`CHUNK` at a time, while the loop state stays on the
device (K19a, :mod:`..kernels.krylov`): the updates stop changing ``x``,
``r`` and ``k`` once the device sets its ``done`` flag by the reference's
rule, and the host reads the flag once per chunk.  The iteration count is
the per-iteration rule's; a chunk's launches after ``done`` are wasted work.
``plain=True`` runs the same loop on the plain versions.

``minres`` (``:120-224``) is not ported here: its one caller is the
assembled-matrix route of ROADMAP A8.
"""

from __future__ import annotations

import typing

import torch

from ..kernels import krylov as K19a

__all__ = ["KrylovResult", "cg", "chebyshev_coefficients", "chebyshev_preconditioner", "CHUNK"]

CHUNK = 4  # CG iterations launched between two host reads of the done flag


class KrylovResult(typing.NamedTuple):
    x: torch.Tensor
    iters: int
    residual: float  # the recurrence's final ‖r‖
    converged: bool


def _steps(plain: bool):
    if plain:
        return (K19a.cg_start_plain, K19a.cg_update_x_plain, K19a.cg_update_p_plain,
                K19a.cheb_start_plain, K19a.inv_sqrt_plain)
    return K19a.cg_start, K19a.cg_update_x, K19a.cg_update_p, K19a.cheb_start, K19a.inv_sqrt


def chebyshev_coefficients(degree: int, lam_max: float = 2.0, ratio: float = 30.0):
    """``(θ, [(c1, c2), ...])`` of the reference's recurrence on
    ``[lam_max/ratio, lam_max]``, as host floats: the first step is
    ``x = rs/θ`` and step t ``dvec = c1·dvec + c2·(rs − Â x)``."""
    a = lam_max / ratio
    theta = 0.5 * (lam_max + a)
    delta = 0.5 * (lam_max - a)
    sigma = theta / delta
    rho = 1.0 / sigma
    coeffs = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        coeffs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, coeffs


def chebyshev_preconditioner(step, diag=None, degree: int = 8, lam_max: float = 2.0,
                             ratio: float = 30.0, plain: bool = False, d_isqrt=None):
    """``M⁻¹ ≈ A⁻¹`` as ``degree`` Chebyshev iterations on the Jacobi-scaled
    operator ``D^-1/2 A D^-1/2`` over ``[lam_max/ratio, lam_max]``.

    ``step(s, rs, dvec, x_in, x_out, c1, c2, z=None, base=None)`` is the
    operator's fused step (K18, K19b or K19c), ``d_isqrt`` the scaling
    ``diag^-1/2`` when the caller has it.  Returns ``apply(r, out=None,
    base=None)``: ``M⁻¹ r`` (plus ``base``), into ``out`` when given."""
    cheb_start, inv_sqrt = _steps(plain)[3:]
    s = inv_sqrt(diag) if d_isqrt is None else d_isqrt
    theta, coeffs = chebyshev_coefficients(degree, lam_max, ratio)

    def apply(r, out=None, base=None):
        rs, dvec, xa, xb = (torch.empty_like(r) for _ in range(4))
        z = torch.empty_like(r) if out is None else out
        first_out = None if coeffs else z
        cheb_start(s, r, theta, rs, dvec, xa, first_out, None if coeffs else base)
        for t, (c1, c2) in enumerate(coeffs):
            last = t == len(coeffs) - 1
            step(s, rs, dvec, xa, xb, c1, c2, z if last else None, base if last else None)
            xa, xb = xb, xa
        return z

    return apply


def cg(matvec, b: torch.Tensor, x0: torch.Tensor | None = None, precond=None, rtol: float = 1e-12,
       atol: float = 0.0, maxiter: int | None = None, plain: bool = False,
       chunk: int = CHUNK) -> KrylovResult:
    """Preconditioned conjugate gradients for SPD systems (the reference's
    stop rule: iterate while ``k < maxiter`` and ``‖r‖ > max(rtol·‖b‖,
    atol)``, ``maxiter = 4n + 20`` by default).  ``matvec`` and ``precond``
    return new vectors; counts its host reads in ``cg.flag_reads``."""
    start, update_x, update_p = _steps(plain)[:3]
    n = b.shape[0]
    maxiter = int(maxiter) if maxiter is not None else 4 * n + 20
    M = precond if precond is not None else (lambda v: v)
    if x0 is None:
        x, r = torch.zeros_like(b), b.clone()  # b − A·0
    else:
        x, r = x0.clone(), b - matvec(x0)
    z = M(r)
    p = z.clone()
    st = K19a.new_state(b.device)
    part = K19a.partials(n, b.device)
    start(st, b, r, z, part, rtol, atol, maxiter)
    while True:
        state = st.tolist()  # the one host read of a chunk
        cg.flag_reads += 1
        if state[K19a.DONE]:
            break
        for _ in range(chunk):
            update_x(st, p, matvec(p), x, r, part)
            update_p(st, r, M(r), p, part)
    rnorm = state[K19a.RNORM]
    return KrylovResult(x, int(state[K19a.K]), rnorm, rnorm <= state[K19a.TOL])


cg.flag_reads = 0
