"""K19a: the conjugate-gradient steps, the Chebyshev start and the Jacobi
apply; K19e: the MINRES steps (``csrc/krylov.cu``).

Replaces ``networks_fenicsx_tpu/ops/krylov.py:cg`` (``:78-119``) and the
elementwise parts of ``chebyshev_preconditioner`` (``:20-68``).  The loop
state lives on the device in the 8 float64 entries of ``st`` (see
:data:`SLOTS`); :func:`.ops.krylov.cg` drives the iterations on a
:class:`CgSteps`, made once a solve:

* :func:`cg_start` — ``γ₀ = r·z``, ``tol = max(rtol·‖b‖, atol)``, ``‖r₀‖``,
  ``k = 0`` and ``done = not (0 < maxiter and ‖r₀‖ > tol)``;
* :meth:`CgSteps.step` — ``α = γ / p·Ap``, ``x += αp``, ``r −= αAp``, then
  ``k += 1``, ``‖r‖`` and ``done = not (k < maxiter and ‖r‖ > tol)``; with
  the :class:`Jacobi` preconditioner also ``z = r / diag``, ``γ' = r·z``,
  ``β = γ'/γ`` and ``γ = γ'`` unless done (2 device launches);
* :meth:`CgSteps.direction` — ``p = z + βp``, after ``β`` and ``γ`` from the
  caller's ``z = M r`` for another preconditioner (1 device launch with
  Jacobi, 2 without).

Each reduction is finished by the last block of its launch (a ticket) in
the order of a separate finishing launch, so the iterations are the
parent's bit for bit: 3 device launches an iteration with Jacobi, 4
without.  Once ``done`` is set the steps leave ``x``, ``r``, ``k`` and the
scalars as they are, so the host may launch several iterations between two
reads of the flag.  :func:`cg_update_x_plain` and :func:`cg_update_p_plain`
are the steps of the unfused iteration (α with the update, β with the
direction), the reference of the fused ones.  :func:`cheb_start` is the first step of a Chebyshev-Jacobi application
(``rs = s·r``, ``dvec = x = rs/θ``, and with ``z`` the result ``s·x`` plus
``base``), :func:`jacobi` the Jacobi apply ``v / diag``, :func:`inv_sqrt`
the scaling ``1/√diag``.

K19e replaces ``ops/krylov.py:minres`` (``:120-224``): its state lives in
the 17 float64 entries of ``ms`` (see :data:`MINRES_SLOTS`) and
:func:`.ops.krylov.minres` drives it on a :class:`MinresSteps`, around its
matvec:

* :func:`minres_start` — ``β₁ = √max(r·y, 0)``, ``tol = max(rtol·‖b‖,
  atol)``, the rotation's initial values, ``done`` and ``v = y/β₁``;
* :meth:`MinresSteps.step` — the Lanczos step on ``yv = A v``: ``yv −=
  (β/oldb)·r1`` from the second iteration, ``α = v·yv``, ``yv −= (α/β)·r2``;
  with Jacobi then ``y = yv/d`` and the rest of the iteration;
* :meth:`MinresSteps.finish` — for another preconditioner, on ``y = M
  yv``: ``β' = √max(yv·y, 0)``, the rotation (``γ = max(‖(γ̄, β')‖, ε)``,
  ``k += 1`` and ``done = not (k < maxiter and |φ̄| > tol)``), ``w1 = (v −
  ε_old·w − δ·w2)/γ`` into ``w``, ``x += φ·w1`` and the next ``v = y/β'``.

Up to :data:`CLUSTER_CHUNKS` chunks of 256 entries a cluster of 8 CTAs
runs a step in one launch; above, ticket-finished launches (3 an
iteration with Jacobi).  :func:`minres_alpha_plain` and :func:`minres_update_plain` are
the step and finish of the generic iteration, of which the fused plain
step is the composition around ``y = yv / d``.

Each wrapper launches its kernels for CUDA tensors (calls counted in
:data:`LAUNCHES` and :data:`MINRES`; the steps' device launches, as their
launchers return them, in their ``device``)
and runs its plain version, eager PyTorch without a host read, for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = [
    "cg_start", "cg_start_plain", "cg_update_x_plain", "cg_update_p_plain", "cg_alpha_plain", "cg_advance_plain", "cg_beta_plain",
    "cg_direction_plain", "CgSteps", "Jacobi", "cheb_start", "cheb_start_plain", "jacobi",
    "jacobi_plain", "inv_sqrt", "inv_sqrt_plain", "new_state", "partials", "LAUNCHES", "SLOTS",
    "minres_start", "minres_start_plain", "minres_alpha_plain", "minres_update_plain", "minres_step_plain", "MinresSteps", "minres_state", "MINRES",
    "MINRES_SLOTS", "CLUSTER_CHUNKS",
]

THREADS = 256
SLOTS = ("gamma", "tol", "done", "k", "maxiter", "alpha", "beta", "rnorm")
GAMMA, TOL, DONE, K, MAXITER, ALPHA, BETA, RNORM = range(len(SLOTS))
LAUNCHES = build.Counter("krylov")
LAUNCHES.device = 0  # device kernel launches of the CG steps, as the launchers report them
MINRES_SLOTS = ("beta", "oldb", "dbar", "epsln", "phibar", "cs", "sn", "tol", "k", "maxiter",
                "done", "alfa", "oldeps", "delta", "gamma", "phi", "active")
(M_BETA, M_OLDB, M_DBAR, M_EPSLN, M_PHIBAR, M_CS, M_SN, M_TOL, M_K, M_MAXITER, M_DONE, M_ALFA,
 M_OLDEPS, M_DELTA, M_GAMMA, M_PHI, M_ACTIVE) = range(len(MINRES_SLOTS))
MINRES = build.Counter("minres")
MINRES.device = 0  # device kernel launches of the MINRES steps, as the launchers report them
CLUSTER_CHUNKS = 32  # of csrc/krylov.cu: one cluster launch runs a MINRES step up to 8,192 entries
EPS = float(torch.finfo(torch.float64).eps)


def new_state(device) -> torch.Tensor:
    """The loop state ``st``, one float64 per :data:`SLOTS` entry."""
    return torch.zeros(len(SLOTS), dtype=torch.float64, device=device)


def _blocks(n: int) -> int:
    return (n + THREADS - 1) // THREADS


def partials(n: int, device) -> torch.Tensor:
    """A solve's scratch for length-``n`` vectors: three sets of block
    partial sums, then the ticket word (zero, and left at zero by every
    launch)."""
    return torch.zeros(3 * _blocks(n) + 1, dtype=torch.float64, device=device)


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


def cg_alpha_plain(st, p, Ap) -> None:
    """``α = γ / p·Ap`` unless done."""
    st[ALPHA] = torch.where(st[DONE] != 0, st[ALPHA], st[GAMMA] / torch.dot(p, Ap))


def cg_advance_plain(st, p, Ap, x, r, diag=None, z=None) -> None:
    """``x += αp``, ``r −= αAp``, ``k``, ``‖r‖`` and ``done``; with ``diag``
    also ``z = r / diag`` into ``z``, ``β`` and ``γ`` unless done after the
    update."""
    done = st[DONE] != 0
    alpha = st[ALPHA]
    x.copy_(torch.where(done, x, x + alpha * p))
    r.copy_(torch.where(done, r, r - alpha * Ap))
    k = torch.where(done, st[K], st[K] + 1.0)
    rnorm = torch.where(done, st[RNORM], torch.linalg.norm(r))
    stop = done | ~((k < st[MAXITER]) & (rnorm > st[TOL]))
    st[K] = k
    st[RNORM] = rnorm
    st[DONE] = _flag(stop)
    if diag is None:
        return
    zr = r / diag
    z.copy_(torch.where(done, z, zr))
    g = torch.dot(r, zr)
    st[BETA] = torch.where(stop, st[BETA], g / st[GAMMA])
    st[GAMMA] = torch.where(stop, st[GAMMA], g)


def cg_beta_plain(st, r, z) -> None:
    """``γ' = r·z``, ``β = γ'/γ`` and ``γ = γ'`` unless done."""
    done = st[DONE] != 0
    g = torch.dot(r, z)
    st[BETA] = torch.where(done, st[BETA], g / st[GAMMA])
    st[GAMMA] = torch.where(done, st[GAMMA], g)


def cg_direction_plain(st, p, z) -> None:
    """``p = z + βp`` unless done."""
    p.copy_(torch.where(st[DONE] != 0, p, z + st[BETA] * p))


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


def minres_step_plain(ms, v, yv, r1, r2, w, w2, x, diag=None) -> None:
    """The Lanczos step on ``yv``; with ``diag`` then ``y = yv / diag`` and
    the rest of the iteration."""
    minres_alpha_plain(ms, v, yv, r1, r2, None)
    if diag is not None:
        minres_update_plain(ms, yv, yv / diag, v, w, w2, x, None)


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


class _CgArgs(ctypes.Structure):
    """``CgArgs`` of ``csrc/krylov.cu``."""

    _fields_ = [("n", ctypes.c_int), ("nblk", ctypes.c_int), ("x", ctypes.c_void_p),
                ("r", ctypes.c_void_p), ("p", ctypes.c_void_p), ("z", ctypes.c_void_p),
                ("diag", ctypes.c_void_p), ("st", ctypes.c_void_p), ("part", ctypes.c_void_p)]


class CgSteps:
    """K19a's steps of one CG solve: ``x``, ``r`` and ``p`` updated in place,
    the state ``st`` (:func:`new_state`) and the scratch ``part``
    (:func:`partials`); with ``diag`` the Jacobi preconditioner fused into
    the steps, its ``z = r / diag`` kept in a vector of the solve.

    For CUDA tensors the vectors are checked once, here, and packed with
    the scratch into the launcher's argument struct, so that a step is one
    short call on the current stream (the lean launch path); the caller's
    ``Ap`` and ``z`` are checked per call.  With ``plain`` or CPU tensors
    the steps run their plain versions."""

    __slots__ = ("st", "part", "x", "r", "p", "diag", "z", "n", "plain", "index", "_args", "_addr")

    def __init__(self, st, part, x, r, p, diag=None, plain: bool = False):
        self.st, self.part, self.x, self.r, self.p, self.diag = st, part, x, r, p, diag
        self.z = z = None if diag is None else torch.empty_like(x)
        self.n = n = x.shape[0]
        self.plain = plain or x.device.type == "cpu"
        if self.plain:
            return
        self.index = index = x.get_device()
        nblk = _blocks(n)
        build.require_vectors("krylov", index, (x, n), (r, n), (p, n), (st, len(SLOTS)),
                              (part, -(3 * nblk + 1)), *(((diag, n),) if diag is not None else ()))
        if not 0 < n < 2**31 - THREADS:
            raise ValueError(f"krylov: n = {n} out of [1, 2^31 - 256)")
        self._args = _CgArgs(n, nblk, x.data_ptr(), r.data_ptr(), p.data_ptr(), _ptr(z), _ptr(diag),
                             st.data_ptr(), part.data_ptr())
        self._addr = ctypes.addressof(self._args)

    def step(self, Ap) -> None:
        """``α``, the updates of ``x`` and ``r``, ``k``, ``‖r‖`` and ``done``
        (with Jacobi also ``z``, ``β`` and ``γ``) from ``Ap = A p``."""
        if self.plain:
            cg_alpha_plain(self.st, self.p, Ap)
            return cg_advance_plain(self.st, self.p, Ap, self.x, self.r, self.diag, self.z)
        build.require_vectors("krylov", self.index, (Ap, self.n))
        self._launch(build.library().nxfx_krylov_cg_step, Ap.data_ptr())

    def direction(self, z=None) -> None:
        """``p = z + βp``: with Jacobi on its own ``z``, else on the caller's
        ``z = M r``, after ``β`` and ``γ`` from ``r·z``."""
        if (z is None) != (self.diag is not None):
            raise ValueError("krylov: direction takes z = M r exactly when the steps have no diag")
        if self.plain:
            if z is not None:
                cg_beta_plain(self.st, self.r, z)
            return cg_direction_plain(self.st, self.p, z if z is not None else self.z)
        if z is None:
            return self._launch(build.library().nxfx_krylov_cg_direction, None)
        build.require_vectors("krylov", self.index, (z, self.n))
        self._launch(build.library().nxfx_krylov_cg_direction, z.data_ptr())

    def _launch(self, fn, ptr) -> None:
        index = self.index
        stream = build.raw_stream(index)
        enqueued = build.on_device(index, fn, self._addr, ptr, stream)
        if enqueued < 0:
            build.check(-enqueued, "krylov")
        LAUNCHES.launches += 1
        LAUNCHES.device += enqueued


class Jacobi:
    """The Jacobi preconditioner ``v ↦ v / diag``.  Called, it is
    :func:`jacobi`; :func:`.ops.krylov.cg` and ``minres`` recognise it and
    apply it inside their steps instead."""

    __slots__ = ("diag",)

    def __init__(self, diag: torch.Tensor):
        self.diag = diag

    def __call__(self, v) -> torch.Tensor:
        return jacobi(v, self.diag)


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


def minres_start(ms, b, r, y, v, part, rtol: float, atol: float, maxiter: int) -> None:
    """Initialise ``ms`` from ``b``, ``r₀`` and ``y₀ = M r₀``; ``v = y₀/β₁``."""
    if b.device.type == "cpu":
        return minres_start_plain(ms, b, r, y, v, part, rtol, atol, maxiter)
    n = b.shape[0]
    _check_vectors(n, b, r, y, v)
    _check_minres(ms, part, n)
    with torch.cuda.device(b.device):
        code = build.library().nxfx_krylov_minres_start(
            n, b.data_ptr(), r.data_ptr(), y.data_ptr(), v.data_ptr(), part.data_ptr(),
            ms.data_ptr(), float(rtol), float(atol), float(maxiter), build.stream_handle(b.device))
    build.check(code, "minres")
    MINRES.launches += 1


class _MinresArgs(ctypes.Structure):
    """``MinresArgs`` of ``csrc/krylov.cu``."""

    _fields_ = [("n", ctypes.c_int), ("nblk", ctypes.c_int), ("one_launch", ctypes.c_int),
                ("v", ctypes.c_void_p), ("x", ctypes.c_void_p), ("d", ctypes.c_void_p),
                ("ms", ctypes.c_void_p), ("part", ctypes.c_void_p)]


class MinresSteps:
    """K19e's steps of one MINRES solve on ``v`` and ``x`` (in place), the
    state ``ms`` (:func:`minres_state`, after :func:`minres_start`), the
    scratch ``part`` (:func:`partials`) and ``r₀`` (the first Lanczos
    vector ``r2``); with ``diag`` the Jacobi preconditioner fused into the
    steps.  Holds the rotated buffers: ``r1 ← r2 ← yv`` and ``w ← w2 ← w1``
    after each iteration.  Up to :data:`CLUSTER_CHUNKS` chunks of 256
    entries each step is one cluster launch, above it ticket-finished
    launches over ``⌈n/256⌉`` blocks.

    For CUDA tensors the vectors are checked once, here, and packed with the
    scratch into the launcher's argument struct (the lean launch path); the
    caller's ``yv`` and ``y`` are checked per call.  With ``plain`` or CPU
    tensors the steps run their plain versions."""

    __slots__ = ("ms", "part", "v", "x", "diag", "n", "plain", "r1", "r2", "w", "w2", "index",
                 "_args", "_addr")

    def __init__(self, ms, part, v, x, r, diag=None, plain: bool = False):
        self.ms, self.part, self.v, self.x, self.diag = ms, part, v, x, diag
        self.n = n = x.shape[0]
        self.plain = plain or x.device.type == "cpu"
        self.r1, self.r2 = torch.zeros_like(x), r
        self.w, self.w2 = torch.zeros_like(x), torch.zeros_like(x)
        if self.plain:
            return
        self.index = index = x.get_device()
        nblk = _blocks(n)
        build.require_vectors("minres", index, (v, n), (x, n), (r, n), (ms, len(MINRES_SLOTS)),
                              (part, -(3 * nblk + 1)), *(((diag, n),) if diag is not None else ()))
        if not 0 < n < 2**31 - THREADS:
            raise ValueError(f"minres: n = {n} out of [1, 2^31 - 256)")
        self._args = _MinresArgs(n, nblk, int(nblk <= CLUSTER_CHUNKS), v.data_ptr(), x.data_ptr(),
                                 _ptr(diag), ms.data_ptr(), part.data_ptr())
        self._addr = ctypes.addressof(self._args)

    def step(self, yv) -> None:
        """The Lanczos step on ``yv = A v`` (in place); with Jacobi the rest
        of the iteration too, else :meth:`finish` follows on ``M yv``."""
        if self.plain:
            minres_step_plain(self.ms, self.v, yv, self.r1, self.r2, self.w, self.w2, self.x,
                              self.diag)
        else:
            build.require_vectors("minres", self.index, (yv, self.n))
            ws = (self.w.data_ptr(), self.w2.data_ptr()) if self.diag is not None else (None, None)
            self._launch(build.library().nxfx_krylov_minres_step, yv.data_ptr(), self.r1.data_ptr(),
                         self.r2.data_ptr(), *ws)
        self.r1, self.r2 = self.r2, yv
        if self.diag is not None:
            self.w, self.w2 = self.w2, self.w

    def finish(self, y) -> None:
        """Without Jacobi, on ``y = M yv`` of the last step's ``yv``:
        ``β'``, the rotation, ``w1`` into ``w``, ``x`` and the next ``v``."""
        if self.diag is not None:
            raise ValueError("minres: the Jacobi steps finish inside step()")
        yv = self.r2
        if self.plain:
            minres_update_plain(self.ms, yv, y, self.v, self.w, self.w2, self.x, None)
        else:
            build.require_vectors("minres", self.index, (y, self.n))
            self._launch(build.library().nxfx_krylov_minres_finish, yv.data_ptr(), y.data_ptr(),
                         self.w.data_ptr(), self.w2.data_ptr())
        self.w, self.w2 = self.w2, self.w

    def _launch(self, fn, *ptrs) -> None:
        index = self.index
        stream = build.raw_stream(index)
        enqueued = build.on_device(index, fn, self._addr, *ptrs, stream)
        if enqueued < 0:
            build.check(-enqueued, "minres")
        MINRES.launches += 1
        MINRES.device += enqueued


def _check_minres(ms, part, n: int) -> None:
    build.require_cuda("minres", ms, part)
    if tuple(ms.shape) != (len(MINRES_SLOTS),) or part.numel() < 3 * _blocks(n) + 1:
        raise ValueError("minres: ms must hold 17 slots and part 3 partials a block and a ticket")


def _check_vectors(n: int, *vectors) -> None:
    build.require_cuda("krylov", *vectors)
    if not 0 < n < 2**31 - THREADS or any(tuple(v.shape) != (n,) for v in vectors):
        raise ValueError(f"krylov: expected non-empty ({n},) vectors")


def _check_scratch(st, part, n: int) -> None:
    build.require_cuda("krylov", st, part)
    if tuple(st.shape) != (len(SLOTS),) or part.numel() < 3 * _blocks(n) + 1:
        raise ValueError("krylov: st must hold 8 slots and part 3 partials a block and a ticket")
