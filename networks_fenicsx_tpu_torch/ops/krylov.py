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
A :class:`..kernels.krylov.Jacobi` preconditioner is applied inside the
steps (3 device launches an iteration besides the matvec); any other
callable between them (4).  ``plain=True`` runs the same loop on the plain
versions.

``minres`` (``:120-224``), the preconditioned MINRES of the assembled
saddle-point route, is driven the same way on K19e's steps
(``minres.flag_reads`` counts its host reads): with ``Jacobi`` one launch an
iteration besides the matvec up to 8,192 unknowns.
"""

from __future__ import annotations

import typing

import torch

from ..kernels import krylov as K19a

__all__ = [
    "KrylovResult", "cg", "chebyshev_coefficients", "chebyshev_preconditioner", "minres", "CHUNK",
]

CHUNK = 4  # CG iterations launched between two host reads of the done flag


class KrylovResult(typing.NamedTuple):
    x: torch.Tensor
    iters: int
    residual: float  # the recurrence's final ‖r‖
    converged: bool


def _steps(plain: bool):
    if plain:
        return K19a.cg_start_plain, K19a.jacobi_plain, K19a.cheb_start_plain, K19a.inv_sqrt_plain
    return K19a.cg_start, K19a.jacobi, K19a.cheb_start, K19a.inv_sqrt


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
    operator's fused step (K18 or K19c; K19b's plain step), ``d_isqrt`` the
    scaling ``diag^-1/2`` when the caller has it.  Returns ``apply(r,
    out=None, base=None)``: ``M⁻¹ r`` (plus ``base``), into ``out`` when
    given."""
    cheb_start, inv_sqrt = _steps(plain)[2:]
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
    return new vectors; a :class:`..kernels.krylov.Jacobi` ``precond`` runs
    inside the steps.  Counts its host reads in ``cg.flag_reads``."""
    start, jacobi = _steps(plain)[:2]
    n = b.shape[0]
    maxiter = int(maxiter) if maxiter is not None else 4 * n + 20
    diag = precond.diag if isinstance(precond, K19a.Jacobi) else None
    M = precond if precond is not None else (lambda v: v)
    if x0 is None:
        x, r = torch.zeros_like(b), b.clone()  # b − A·0
    else:
        x, r = x0.clone(), b - matvec(x0)
    p = jacobi(r, diag) if diag is not None else M(r).clone()  # p₀ = z₀
    st = K19a.new_state(b.device)
    part = K19a.partials(n, b.device)
    start(st, b, r, p, part, rtol, atol, maxiter)
    steps = K19a.CgSteps(st, part, x, r, p, diag, plain=plain)
    while True:
        state = st.tolist()  # the one host read of a chunk
        cg.flag_reads += 1
        if state[K19a.DONE]:
            break
        for _ in range(chunk):
            steps.step(matvec(p))
            steps.direction(None if diag is not None else M(r))
    rnorm = state[K19a.RNORM]
    cg.last_tol = state[K19a.TOL]
    return KrylovResult(x, int(state[K19a.K]), rnorm, rnorm <= state[K19a.TOL])


cg.flag_reads = 0
cg.last_tol = None  # the stop rule's max(rtol·‖b‖, atol) of the last run


def minres(matvec, b: torch.Tensor, x0: torch.Tensor | None = None, precond=None,
           rtol: float = 1e-12, atol: float = 0.0, maxiter: int | None = None, plain: bool = False,
           chunk: int = CHUNK) -> KrylovResult:
    """Preconditioned MINRES for symmetric (possibly indefinite) systems, the
    preconditioner SPD (the reference's Paige-Saunders recurrence and stop
    rule: iterate while ``k < maxiter`` and ``|φ̄| > max(rtol·‖b‖, atol)``,
    ``maxiter = 4n + 20`` by default).  ``matvec`` and ``precond`` return
    new vectors; a :class:`..kernels.krylov.Jacobi` ``precond`` runs inside
    the steps.  Counts its host reads in ``minres.flag_reads`` and keeps the
    stop rule's tolerance in ``minres.last_tol``."""
    start = K19a.minres_start_plain if plain else K19a.minres_start
    jacobi = _steps(plain)[1]
    n = b.shape[0]
    maxiter = int(maxiter) if maxiter is not None else 4 * n + 20
    diag = precond.diag if isinstance(precond, K19a.Jacobi) else None
    M = precond if precond is not None else (lambda v: v)
    if x0 is None:
        x, r = torch.zeros_like(b), b.clone()  # b − A·0
    else:
        x, r = x0.clone(), b - matvec(x0)
    ms = K19a.minres_state(b.device)
    part = K19a.partials(n, b.device)
    v = torch.empty_like(b)
    y = jacobi(r, diag) if diag is not None else M(r)
    start(ms, b, r, y, v, part, rtol, atol, maxiter)
    steps = K19a.MinresSteps(ms, part, v, x, r, diag, plain=plain)
    while True:
        state = ms.tolist()  # the one host read of a chunk
        minres.flag_reads += 1
        if state[K19a.M_DONE]:
            break
        for _ in range(chunk):
            yv = matvec(v)
            steps.step(yv)
            if diag is None:
                steps.finish(M(yv))
    res = abs(state[K19a.M_PHIBAR])
    minres.last_tol = state[K19a.M_TOL]
    return KrylovResult(x, int(state[K19a.M_K]), res, res <= state[K19a.M_TOL])


minres.flag_reads = 0
minres.last_tol = None  # the stop rule's max(rtol·‖b‖, atol) of the last run
