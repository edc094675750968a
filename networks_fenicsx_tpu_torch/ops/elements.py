"""Closed-form interval finite elements (equispaced Lagrange + DG).

Counterpart of ``networks_fenicsx_tpu/ops/elements.py`` (host NumPy, the
same tables).  Replacement for the Basix element tabulation
(reference ``assembly.py:127-150`` uses ``basix.ufl.element("Lagrange",
"interval", degree, lagrange_variant=equispaced)``) and for the whole
UFL → FFCx JIT C-kernel pipeline (reference ``assembly.py:288-299``): on a 1D
interval the element matrices have simple closed forms, so they are
tabulated once on the host in float64 and passed to the kernels as
scalars — there is nothing to "compile" per problem.

Basis ordering is lexicographic along the reference interval [0, 1]:
dof ``i`` of a degree-``k`` element sits at ``ξ = i / k``; dof 0 and dof k
are the endpoint (vertex) dofs.
"""

from __future__ import annotations

import functools

import numpy as np
import numpy.typing as npt

__all__ = [
    "equispaced_nodes",
    "lagrange_coefficients",
    "tabulate",
    "gauss_legendre",
    "mass_matrix",
    "div_matrix",
    "stiffness_matrix",
    "load_vector",
    "endpoint_matrix",
]


def equispaced_nodes(degree: int) -> npt.NDArray[np.float64]:
    """Equispaced Lagrange nodes on [0, 1] (matches the reference's
    ``LagrangeVariant.equispaced``, ``assembly.py:131``)."""
    if degree == 0:
        return np.array([0.5])
    return np.linspace(0.0, 1.0, degree + 1)


@functools.lru_cache(maxsize=None)
def lagrange_coefficients(degree: int) -> npt.NDArray[np.float64]:
    """Monomial coefficients ``A`` with ``φ_j(x) = Σ_m A[m, j] x**m``."""
    nodes = equispaced_nodes(degree)
    V = np.vander(nodes, N=degree + 1, increasing=True)
    return np.linalg.inv(V)


def tabulate(
    degree: int, points: npt.NDArray[np.float64], nderiv: int = 0
) -> npt.NDArray[np.float64]:
    """Evaluate basis (or its ``nderiv``-th derivative) at ``points``.

    Returns an array of shape ``(len(points), degree + 1)``.
    """
    A = lagrange_coefficients(degree)
    n = degree + 1
    # Derivative of monomial basis: d^r/dx^r x^m = m!/(m-r)! x^(m-r)
    powers = np.arange(n)
    coeff = np.ones(n)
    for r in range(nderiv):
        coeff = coeff * np.clip(powers - r, 0, None)
    pts = np.atleast_1d(np.asarray(points, dtype=np.float64))
    shifted = np.clip(powers - nderiv, 0, None)
    mono = coeff[None, :] * pts[:, None] ** shifted[None, :]
    mono[:, :nderiv] = 0.0  # monomials below the derivative order vanish
    return mono @ A


def gauss_legendre(npoints: int) -> tuple[npt.NDArray[np.float64], npt.NDArray[np.float64]]:
    """Gauss–Legendre rule on [0, 1]: exact for polynomials of degree
    ``2 * npoints - 1``."""
    x, w = np.polynomial.legendre.leggauss(npoints)
    return 0.5 * (x + 1.0), 0.5 * w


@functools.lru_cache(maxsize=None)
def mass_matrix(degree: int) -> npt.NDArray[np.float64]:
    """``M̂[i, j] = ∫₀¹ φ_i φ_j dξ`` — scale by ``R·h`` per cell to get the
    flux mass block ``∫ R q v ds`` (reference form ``assembly.py:253``)."""
    q = degree + 1
    x, w = gauss_legendre(q)
    phi = tabulate(degree, x)
    return np.einsum("q,qi,qj->ij", w, phi, phi)


@functools.lru_cache(maxsize=None)
def div_matrix(p_degree: int, q_degree: int) -> npt.NDArray[np.float64]:
    """``D̂[m, j] = ∫₀¹ ψ_m φ'_j dξ`` (h-independent).

    Scaled by the cell orientation this is the pressure–flux coupling
    ``∫ φ (∇q · tangent) ds`` (reference form ``assembly.py:254``); its
    negative transpose is the flux–pressure block (``assembly.py:255``).
    """
    npts = max(1, (p_degree + q_degree + 1) // 2 + 1)
    x, w = gauss_legendre(npts)
    psi = tabulate(p_degree, x) if p_degree > 0 else np.ones((x.size, 1))
    dphi = tabulate(q_degree, x, nderiv=1)
    return np.einsum("q,qm,qj->mj", w, psi, dphi)


@functools.lru_cache(maxsize=None)
def stiffness_matrix(degree: int) -> npt.NDArray[np.float64]:
    """``K̂[i, j] = ∫₀¹ φ'_i φ'_j dξ`` — divide by ``h`` per cell."""
    x, w = gauss_legendre(degree + 1)
    dphi = tabulate(degree, x, nderiv=1)
    return np.einsum("q,qi,qj->ij", w, dphi, dphi)


@functools.lru_cache(maxsize=None)
def load_vector(degree: int) -> npt.NDArray[np.float64]:
    """``b̂[i] = ∫₀¹ φ_i dξ`` — scale by ``f·h`` per cell for constant f."""
    x, w = gauss_legendre(degree + 1)
    phi = tabulate(degree, x) if degree > 0 else np.ones((x.size, 1))
    return np.einsum("q,qi->i", w, phi)


@functools.lru_cache(maxsize=None)
def endpoint_matrix(degree: int) -> npt.NDArray[np.float64]:
    """``P[s, j] = φ_j(s)`` for s ∈ {0, 1}: point evaluation at the interval
    ends, used for the bifurcation multiplier coupling (the reference's
    exterior-facet ``ds`` measures, ``assembly.py:268-277``)."""
    return tabulate(degree, np.array([0.0, 1.0]))
