"""K19a: the conjugate-gradient steps, the Chebyshev start and the Jacobi
apply; K19e: the MINRES steps (``csrc/krylov.cu``).

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

K19e replaces ``ops/krylov.py:minres`` (``:120-224``): its state lives in
the 17 float64 entries of ``ms`` (see :data:`MINRES_SLOTS`) and
:func:`.ops.krylov.minres` drives it, around its matvec and Jacobi apply:

* :func:`minres_start` — ``β₁ = √max(r·y, 0)``, ``tol = max(rtol·‖b‖,
  atol)``, the rotation's initial values, ``done`` and ``v = y/β₁``;
* :func:`minres_alpha` — ``yv −= (β/oldb)·r1`` from the second iteration,
  ``α = v·yv``, ``yv −= (α/β)·r2``;
* :func:`minres_update` — ``β' = √max(yv·y, 0)``, the rotation (``γ =
  max(‖(γ̄, β')‖, ε)``, ``k += 1`` and ``done = not (k < maxiter and |φ̄| >
  tol)``), ``w1 = (v − ε_old·w − δ·w2)/γ`` into ``w``, ``x += φ·w1`` and the
  next ``v = y/β'``.

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
    "minres_start", "minres_start_plain", "minres_alpha", "minres_alpha_plain", "minres_update",
    "minres_update_plain", "minres_state", "MINRES", "MINRES_SLOTS",
]

THREADS = 256
SLOTS = ("gamma", "tol", "done", "k", "maxiter", "alpha", "beta", "rnorm")
GAMMA, TOL, DONE, K, MAXITER, ALPHA, BETA, RNORM = range(len(SLOTS))
LAUNCHES = build.Counter("krylov")
MINRES_SLOTS = ("beta", "oldb", "dbar", "epsln", "phibar", "cs", "sn", "tol", "k", "maxiter",
                "done", "alfa", "oldeps", "delta", "gamma", "phi", "active")
(M_BETA, M_OLDB, M_DBAR, M_EPSLN, M_PHIBAR, M_CS, M_SN, M_TOL, M_K, M_MAXITER, M_DONE, M_ALFA,
 M_OLDEPS, M_DELTA, M_GAMMA, M_PHI, M_ACTIVE) = range(len(MINRES_SLOTS))
MINRES = build.Counter("minres")
EPS = float(torch.finfo(torch.float64).eps)


def new_state(device) -> torch.Tensor:
    """The loop state ``st``, one float64 per :data:`SLOTS` entry."""
    return torch.zeros(len(SLOTS), dtype=torch.float64, device=device)


def partials(n: int, device) -> torch.Tensor:
    """Scratch of the block partial sums of a length-``n`` dot product (three)."""
    return torch.empty(3 * ((n + THREADS - 1) // THREADS), dtype=torch.float64, device=device)


def minres_state(device) -> torch.Tensor:
    """The MINRES loop state ``ms``, one float64 per :data:`MINRES_SLOTS` entry."""
    return torch.zeros(len(MINRES_SLOTS), dtype=torch.float64, device=device)


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


def _nan_max(a: torch.Tensor, b) -> torch.Tensor:
    return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def minres_start_plain(ms, b, r, y, v, part, rtol: float, atol: float, maxiter: int) -> None:
    del part
    beta1 = torch.sqrt(_nan_max(torch.dot(r, y), 0.0))
    ms.zero_()
    ms[M_BETA] = beta1
    ms[M_PHIBAR] = beta1
    ms[M_CS] = -1.0
    ms[M_TOL] = _nan_max(rtol * torch.sqrt(torch.dot(b, b)), atol)
    ms[M_MAXITER] = float(maxiter)
    ms[M_DONE] = _flag(~((0 < maxiter) & (beta1.abs() > ms[M_TOL])))
    v.copy_(y / torch.where(beta1 > 0, beta1, 1.0))


def minres_alpha_plain(ms, v, yv, r1, r2, part) -> None:
    del part
    done = ms[M_DONE] != 0
    y = torch.where(ms[M_K] + 1.0 >= 2.0, yv - (ms[M_BETA] / ms[M_OLDB]) * r1, yv)
    alfa = torch.where(done, ms[M_ALFA], torch.dot(v, y))
    yv.copy_(torch.where(done, yv, y - (alfa / ms[M_BETA]) * r2))
    ms[M_ALFA] = alfa


def minres_update_plain(ms, yv, y, v, w, w2, x, part) -> None:
    del part
    done = ms[M_DONE] != 0
    beta = torch.sqrt(_nan_max(torch.dot(yv, y), 0.0))
    cs, sn, dbar, alfa, phibar = ms[M_CS], ms[M_SN], ms[M_DBAR], ms[M_ALFA], ms[M_PHIBAR]
    oldeps = ms[M_EPSLN]
    delta = cs * dbar + sn * alfa
    gbar = sn * dbar - cs * alfa
    gamma = _nan_max(torch.sqrt(gbar * gbar + beta * beta), EPS)
    cs_new, sn_new = gbar / gamma, beta / gamma
    k = ms[M_K] + 1.0
    new = torch.stack([
        beta, ms[M_BETA], -cs * beta, sn * beta, sn_new * phibar, cs_new, sn_new, ms[M_TOL], k,
        ms[M_MAXITER], _flag(~((k < ms[M_MAXITER]) & ((sn_new * phibar).abs() > ms[M_TOL]))),
        alfa, oldeps, delta, gamma, cs_new * phibar, torch.ones_like(k),
    ])
    old = ms.clone()
    old[M_ACTIVE] = 0.0
    st = torch.where(done, old, new)
    ms.copy_(st)
    w1 = (v - st[M_OLDEPS] * w - st[M_DELTA] * w2) / st[M_GAMMA]
    active = st[M_ACTIVE] != 0
    x.copy_(torch.where(active, x + st[M_PHI] * w1, x))
    w.copy_(torch.where(active, w1, w))
    v.copy_(torch.where(active, y / torch.where(st[M_BETA] > 0, st[M_BETA], 1.0), v))


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


def _minres_launch(name: str, device, *args) -> None:
    with torch.cuda.device(device):
        code = getattr(build.library(), name)(*args, build.stream_handle(device))
    build.check(code, "minres")
    MINRES.launches += 1


def minres_start(ms, b, r, y, v, part, rtol: float, atol: float, maxiter: int) -> None:
    """Initialise ``ms`` from ``b``, ``r₀`` and ``y₀ = M r₀``; ``v = y₀/β₁``."""
    if b.device.type == "cpu":
        return minres_start_plain(ms, b, r, y, v, part, rtol, atol, maxiter)
    n = b.shape[0]
    _check_vectors(n, b, r, y, v)
    _check_minres(ms, part, n)
    _minres_launch("nxfx_krylov_minres_start", b.device, n, b.data_ptr(), r.data_ptr(), y.data_ptr(),
                   v.data_ptr(), part.data_ptr(), ms.data_ptr(), float(rtol), float(atol),
                   float(maxiter))


def minres_alpha(ms, v, yv, r1, r2, part) -> None:
    """The Lanczos step on ``yv = A v`` (in place) and ``α``."""
    if v.device.type == "cpu":
        return minres_alpha_plain(ms, v, yv, r1, r2, part)
    n = v.shape[0]
    _check_vectors(n, v, yv, r1, r2)
    _check_minres(ms, part, n)
    _minres_launch("nxfx_krylov_minres_alpha", v.device, n, v.data_ptr(), yv.data_ptr(),
                   r1.data_ptr(), r2.data_ptr(), part.data_ptr(), ms.data_ptr())


def minres_update(ms, yv, y, v, w, w2, x, part) -> None:
    """``β'``, the rotation, ``w1`` into ``w``, ``x`` and the next ``v``."""
    if v.device.type == "cpu":
        return minres_update_plain(ms, yv, y, v, w, w2, x, part)
    n = v.shape[0]
    _check_vectors(n, yv, y, v, w, w2, x)
    _check_minres(ms, part, n)
    _minres_launch("nxfx_krylov_minres_update", v.device, n, yv.data_ptr(), y.data_ptr(),
                   v.data_ptr(), w.data_ptr(), w2.data_ptr(), x.data_ptr(), part.data_ptr(),
                   ms.data_ptr())


def _check_minres(ms, part, n: int) -> None:
    build.require_cuda("minres", ms, part)
    if tuple(ms.shape) != (len(MINRES_SLOTS),) or part.numel() < 2 * ((n + THREADS - 1) // THREADS):
        raise ValueError("minres: ms must hold 17 slots and part 2 partials a block")


def _check_vectors(n: int, *vectors) -> None:
    build.require_cuda("krylov", *vectors)
    if n <= 0 or any(tuple(v.shape) != (n,) for v in vectors):
        raise ValueError(f"krylov: expected non-empty ({n},) vectors")


def _check_scratch(st, part, n: int) -> None:
    build.require_cuda("krylov", st, part)
    if tuple(st.shape) != (len(SLOTS),) or part.numel() < 3 * ((n + THREADS - 1) // THREADS):
        raise ValueError("krylov: st must hold 8 slots and part 3 partials a block")
