"""K19a: the conjugate-gradient steps, the Chebyshev start and the Jacobi
apply (``csrc/krylov.cu``).

Replaces ``networks_fenicsx_tpu/ops/krylov.py:cg`` (``:78-119``) and the
elementwise parts of ``chebyshev_preconditioner`` (``:20-68``).  The loop
state lives on the device in the 8 float64 entries of ``st`` (see
:data:`SLOTS`); :func:`.ops.krylov.cg` drives the iterations:

* :func:`cg_start` — ``γ₀ = r·z``, ``tol = max(rtol·‖b‖, atol)``, ``‖r₀‖``,
  ``k = 0`` and ``done = not (0 < maxiter and ‖r₀‖ > tol)``;
* :func:`cg_update_x` — ``α = γ / p·Ap``, ``x += αp``, ``r −= αAp``, then
  ``k += 1``, ``‖r‖`` and ``done = not (k < maxiter and ‖r‖ > tol)``;
* :func:`cg_update_p` — ``γ' = r·z``, ``β = γ'/γ``, ``γ = γ'``,
  ``p = z + βp``.

Once ``done`` is set the updates leave ``x``, ``r``, ``k`` and the scalars
as they are, so the host may launch several iterations between two reads
of the flag.  :func:`cheb_start` is the first step of a Chebyshev-Jacobi
application (``rs = s·r``, ``dvec = x = rs/θ``, and with ``z`` the result
``s·x`` plus ``base``), :func:`jacobi` the Jacobi apply ``v / diag``,
:func:`inv_sqrt` the scaling ``1/√diag``.

Each wrapper launches its kernels for CUDA tensors (counted in
:data:`LAUNCHES`) and runs its plain version, eager PyTorch without a host
read, for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = [
    "cg_start", "cg_start_plain", "cg_update_x", "cg_update_x_plain", "cg_update_p",
    "cg_update_p_plain", "cheb_start", "cheb_start_plain", "jacobi", "jacobi_plain", "inv_sqrt",
    "inv_sqrt_plain", "new_state", "partials", "LAUNCHES", "SLOTS",
]

THREADS = 256
SLOTS = ("gamma", "tol", "done", "k", "maxiter", "alpha", "beta", "rnorm")
GAMMA, TOL, DONE, K, MAXITER, ALPHA, BETA, RNORM = range(len(SLOTS))
LAUNCHES = build.Counter("krylov")


def new_state(device) -> torch.Tensor:
    """The loop state ``st``, one float64 per :data:`SLOTS` entry."""
    return torch.zeros(len(SLOTS), dtype=torch.float64, device=device)


def partials(n: int, device) -> torch.Tensor:
    """Scratch of the block partial sums of a length-``n`` dot product (three)."""
    return torch.empty(3 * ((n + THREADS - 1) // THREADS), dtype=torch.float64, device=device)


def _flag(cond: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, 1.0, 0.0).to(torch.float64)


# ------------------------------------------------------------------ plain


def cg_start_plain(st, b, r, z, part, rtol: float, atol: float, maxiter: int) -> None:
    del part
    rnorm = torch.linalg.norm(r)
    tol = torch.maximum(rtol * torch.linalg.norm(b), torch.tensor(atol, dtype=b.dtype, device=b.device))
    st[GAMMA] = torch.dot(r, z)
    st[TOL] = tol
    st[K] = 0.0
    st[MAXITER] = float(maxiter)
    st[ALPHA] = 0.0
    st[BETA] = 0.0
    st[RNORM] = rnorm
    st[DONE] = _flag(~((rnorm > tol) & (0 < maxiter)))


def cg_update_x_plain(st, p, Ap, x, r, part) -> None:
    del part
    done = st[DONE] != 0
    alpha = torch.where(done, st[ALPHA], st[GAMMA] / torch.dot(p, Ap))
    x.copy_(torch.where(done, x, x + alpha * p))
    r.copy_(torch.where(done, r, r - alpha * Ap))
    k = torch.where(done, st[K], st[K] + 1.0)
    rnorm = torch.where(done, st[RNORM], torch.linalg.norm(r))
    st[ALPHA] = alpha
    st[K] = k
    st[RNORM] = rnorm
    st[DONE] = _flag(done | ~((k < st[MAXITER]) & (rnorm > st[TOL])))


def cg_update_p_plain(st, r, z, p, part) -> None:
    del part
    done = st[DONE] != 0
    g = torch.dot(r, z)
    beta = torch.where(done, st[BETA], g / st[GAMMA])
    st[GAMMA] = torch.where(done, st[GAMMA], g)
    st[BETA] = beta
    p.copy_(torch.where(done, p, z + beta * p))


def cheb_start_plain(s, r, theta: float, rs, dvec, x, z=None, base=None) -> None:
    rs.copy_(s * r)
    dv = rs / theta
    dvec.copy_(dv)
    x.copy_(dv)
    if z is not None:
        z.copy_(s * dv if base is None else base + s * dv)


def jacobi_plain(v, diag) -> torch.Tensor:
    return v / diag


def inv_sqrt_plain(d) -> torch.Tensor:
    return 1.0 / torch.sqrt(d)


# ---------------------------------------------------------------- kernels


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        code = getattr(build.library(), name)(*args, build.stream_handle(device))
    build.check(code, "krylov")
    LAUNCHES.launches += 1


def cg_start(st, b, r, z, part, rtol: float, atol: float, maxiter: int) -> None:
    """Initialise ``st`` from ``b``, ``r₀`` and ``z₀ = M r₀`` (see module docs)."""
    if b.device.type == "cpu":
        return cg_start_plain(st, b, r, z, part, rtol, atol, maxiter)
    n = b.shape[0]
    _check_vectors(n, b, r, z)
    _check_scratch(st, part, n)
    _launch("nxfx_krylov_cg_start", b.device, n, b.data_ptr(), r.data_ptr(), z.data_ptr(),
            part.data_ptr(), st.data_ptr(), float(rtol), float(atol), float(maxiter))


def cg_update_x(st, p, Ap, x, r, part) -> None:
    """``α``, the updates of ``x`` and ``r``, ``k``, ``‖r‖`` and ``done``."""
    if p.device.type == "cpu":
        return cg_update_x_plain(st, p, Ap, x, r, part)
    n = p.shape[0]
    _check_vectors(n, p, Ap, x, r)
    _check_scratch(st, part, n)
    _launch("nxfx_krylov_cg_update_x", p.device, n, p.data_ptr(), Ap.data_ptr(), x.data_ptr(),
            r.data_ptr(), part.data_ptr(), st.data_ptr())


def cg_update_p(st, r, z, p, part) -> None:
    """``β`` and the new search direction ``p``."""
    if p.device.type == "cpu":
        return cg_update_p_plain(st, r, z, p, part)
    n = p.shape[0]
    _check_vectors(n, r, z, p)
    _check_scratch(st, part, n)
    _launch("nxfx_krylov_cg_update_p", p.device, n, r.data_ptr(), z.data_ptr(), p.data_ptr(),
            part.data_ptr(), st.data_ptr())


def cheb_start(s, r, theta: float, rs, dvec, x, z=None, base=None) -> None:
    """The first Chebyshev step into ``rs``, ``dvec`` and ``x`` (and ``z``)."""
    if r.device.type == "cpu":
        return cheb_start_plain(s, r, theta, rs, dvec, x, z, base)
    n = r.shape[0]
    _check_vectors(n, s, r, rs, dvec, x, *(t for t in (z, base) if t is not None))
    _launch("nxfx_krylov_cheb_start", r.device, n, s.data_ptr(), r.data_ptr(), float(theta),
            rs.data_ptr(), dvec.data_ptr(), x.data_ptr(), _ptr(z), _ptr(base))


def jacobi(v, diag) -> torch.Tensor:
    """``v / diag``."""
    if v.device.type == "cpu":
        return jacobi_plain(v, diag)
    n = v.shape[0]
    _check_vectors(n, v, diag)
    z = torch.empty_like(v)
    _launch("nxfx_krylov_jacobi", v.device, n, v.data_ptr(), diag.data_ptr(), z.data_ptr())
    return z


def inv_sqrt(d) -> torch.Tensor:
    """``1 / √d``."""
    if d.device.type == "cpu":
        return inv_sqrt_plain(d)
    n = d.shape[0]
    _check_vectors(n, d)
    s = torch.empty_like(d)
    _launch("nxfx_krylov_inv_sqrt", d.device, n, d.data_ptr(), s.data_ptr())
    return s


def _check_vectors(n: int, *vectors) -> None:
    build.require_cuda("krylov", *vectors)
    if n <= 0 or any(tuple(v.shape) != (n,) for v in vectors):
        raise ValueError(f"krylov: expected non-empty ({n},) vectors")


def _check_scratch(st, part, n: int) -> None:
    build.require_cuda("krylov", st, part)
    if tuple(st.shape) != (len(SLOTS),) or part.numel() < 3 * ((n + THREADS - 1) // THREADS):
        raise ValueError("krylov: st must hold 8 slots and part 3 partials a block")
