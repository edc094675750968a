"""K19a's and K19e's fused Krylov steps against the steps they replace and
against the JAX reference.

* the fused plain CG steps (``CgSteps``: α; the x/r update with z = r/diag,
  ‖r‖, β and γ; p) equal the composition ``cg_update_x_plain`` →
  ``jacobi_plain`` → ``cg_update_p_plain`` by ``torch.equal`` at every
  iteration, including the iterations launched after ``done`` (which leave
  the state as it is), and the generic steps equal ``cg_update_x_plain`` →
  M → ``cg_update_p_plain``; the same for MINRES (``MinresSteps``) against
  ``minres_alpha_plain`` → ``jacobi_plain`` → ``minres_update_plain``;
* the port's ``cg`` and ``minres`` with ``Jacobi`` against the JAX
  package's with ``precond=lambda v: v / d`` on seeded systems: CG at
  1e-9·scale with iterations within 1, MINRES at 1e-7·scale (the bars of
  ``test_torch_krylov.py`` and ``test_torch_generic.py``); the fused
  drivers equal the generic ones on a lambda bit for bit;
* ``Solver`` on the CPU through ``schur_p``, ``minres`` and the CG
  executor's Jacobi against the JAX package, the Jacobi applied inside the
  steps only.

The card tests (``pytest -m cuda``) hold the kernels against the plain
steps at 1e-12·scale, bit for bit against a plain model that sums in the
kernels' order (one cluster launch and many), and CG and MINRES (in its
cluster launch and its ticketed launches) on two streams at once and in 3
replays of a CUDA graph of a chunk.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu.ops import krylov as JK
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch.kernels import krylov
from networks_fenicsx_tpu_torch.ops import krylov as PK

torch.set_num_threads(1)


def _close(got, want, tol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _spd(n, seed, cond=1e3):
    """A seeded SPD system with a badly scaled diagonal (Jacobi matters):
    ``(A, b, diag)`` as numpy."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    D = np.diag(np.geomspace(1.0, 30.0, n)[rng.permutation(n)])
    A = D @ ((Q * np.geomspace(1.0, cond, n)) @ Q.T) @ D
    return A, A @ rng.standard_normal(n), np.diagonal(A).copy()


def _indefinite(n, seed):
    """Symmetric indefinite ``A = Q diag(±[1, 1.05]) Qᵀ`` and a Jacobi
    diagonal near 1 that keeps the two clusters (as test_torch_generic.py)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.concatenate([np.linspace(1, 1.05, n // 2), -np.linspace(1, 1.05, n - n // 2)])
    A = (Q * eig) @ Q.T
    return A, A @ rng.standard_normal(n), rng.uniform(1.0, 1.01, n)


def _cg_start(b, diag, maxiter, dev="cpu", plain=True):
    """``(st, part, x, r, p)`` after the start of a Jacobi CG from x = 0."""
    b = torch.as_tensor(b, device=dev)
    st, part = krylov.new_state(dev), krylov.partials(b.shape[0], dev)
    x, r = torch.zeros_like(b), b.clone()
    p = krylov.jacobi_plain(r, diag)
    (krylov.cg_start_plain if plain else krylov.cg_start)(st, b, r, p, part, 1e-12, 0.0, maxiter)
    return st, part, x, r, p


# ------------------------------------------------ fused plain = composed plain


@pytest.mark.parametrize("n,seed", [(30, 0), (100, 1), (255, 2), (256, 3), (257, 4), (600, 5)])
def test_fused_cg_plain_equals_composed_steps(n, seed):
    """Three fused steps an iteration against the parent's composition, by
    ``torch.equal`` after each iteration; ``maxiter`` stops the run half way,
    and the iterations after ``done`` change nothing."""
    A, b, d = _spd(n, seed)
    At, diag = torch.as_tensor(A), torch.as_tensor(d)
    maxiter = 12
    fused = _cg_start(b, diag, maxiter)
    composed = tuple(t.clone() for t in fused)
    steps = krylov.CgSteps(*fused, diag=diag)
    st_c, part_c, x_c, r_c, p_c = composed
    for it in range(2 * maxiter):
        before = [t.clone() for t in fused]
        steps.step(At @ fused[4])
        steps.direction()
        krylov.cg_update_x_plain(st_c, p_c, At @ p_c, x_c, r_c, part_c)
        krylov.cg_update_p_plain(st_c, r_c, krylov.jacobi_plain(r_c, diag), p_c, part_c)
        for got, want in zip(fused, composed):
            assert torch.equal(got, want), it
        if it >= maxiter:  # done since iteration maxiter: nothing moves
            assert all(torch.equal(a, b_) for a, b_ in zip(before, fused)), it
    assert fused[0][krylov.K] == maxiter and fused[0][krylov.DONE] == 1


@pytest.mark.parametrize("n,seed", [(40, 3), (300, 4)])
def test_generic_cg_plain_equals_composed_steps(n, seed):
    """The generic steps (α; x, r; β from the caller's z; p) against
    ``cg_update_x_plain`` → M → ``cg_update_p_plain``, past ``done``."""
    A, b, d = _spd(n, seed)
    At = torch.as_tensor(A)
    M = lambda v: v / torch.as_tensor(d) + 0.5 * v  # noqa: E731  (an SPD M, not Jacobi)
    bt = torch.as_tensor(b)
    st, part, x, r = krylov.new_state("cpu"), krylov.partials(n, "cpu"), torch.zeros_like(bt), bt.clone()
    p = M(r)
    krylov.cg_start_plain(st, bt, r, p, part, 1e-12, 0.0, 10)
    fused = (st, part, x, r, p)
    composed = tuple(t.clone() for t in fused)
    steps = krylov.CgSteps(*fused)
    for it in range(16):
        steps.step(At @ fused[4])
        steps.direction(M(fused[3]))
        krylov.cg_update_x_plain(composed[0], composed[4], At @ composed[4], composed[2],
                                 composed[3], composed[1])
        krylov.cg_update_p_plain(composed[0], composed[3], M(composed[3]), composed[4], composed[1])
        for got, want in zip(fused, composed):
            assert torch.equal(got, want), it
    assert st[krylov.K] == 10


def _minres_start(b, d, maxiter, dev="cpu", plain=True):
    b = torch.as_tensor(b, device=dev)
    n = b.shape[0]
    ms, part, v = krylov.minres_state(dev), krylov.partials(n, dev), torch.empty_like(b)
    x, r = torch.zeros_like(b), b.clone()
    start = krylov.minres_start_plain if plain else krylov.minres_start
    start(ms, b, r, krylov.jacobi_plain(r, d), v, part, 1e-12, 0.0, maxiter)
    return ms, part, v, x, r


@pytest.mark.parametrize("jacobi", [True, False])
@pytest.mark.parametrize("n,seed", [(30, 5), (120, 6)])
def test_fused_minres_plain_equals_composed_steps(n, seed, jacobi):
    """One fused step an iteration (with Jacobi; else the Lanczos step and
    the finish on the caller's M yv) against ``minres_alpha_plain`` →
    ``jacobi_plain`` → ``minres_update_plain`` with the host's rotation, by
    ``torch.equal``; ``maxiter`` stops it half way and later iterations
    leave the state as it is."""
    A, b, d = _indefinite(n, seed)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    maxiter = 8
    ms, part, v, x, r = _minres_start(b, dt, maxiter)
    ms_c, v_c, x_c = ms.clone(), v.clone(), x.clone()
    r1, r2, w, w2 = torch.zeros_like(r), r.clone(), torch.zeros_like(r), torch.zeros_like(r)
    steps = krylov.MinresSteps(ms, part, v, x, r, diag=dt if jacobi else None)
    for it in range(2 * maxiter):
        before = [t.clone() for t in (ms, v, x, steps.w)]
        yv = At @ v
        steps.step(yv)
        if not jacobi:
            steps.finish(krylov.jacobi_plain(yv, dt))
        yv_c = At @ v_c
        krylov.minres_alpha_plain(ms_c, v_c, yv_c, r1, r2, None)
        r1, r2 = r2, yv_c
        krylov.minres_update_plain(ms_c, yv_c, krylov.jacobi_plain(yv_c, dt), v_c, w, w2, x_c, None)
        w, w2 = w2, w
        for got, want in ((ms, ms_c), (v, v_c), (x, x_c), (steps.w, w), (steps.w2, w2),
                          (steps.r2, r2), (steps.r1, r1)):
            assert torch.equal(got, want), it
        if it > maxiter:  # done and inactive: nothing moves
            assert all(torch.equal(a, b_) for a, b_ in zip(before, (ms, v, x, steps.w2))), it
    assert ms[krylov.M_K] == maxiter and ms[krylov.M_ACTIVE] == 0


def test_steps_check_their_arguments():
    """The direction takes z exactly when the steps have no diag; the
    Jacobi MINRES steps finish inside ``step``; off the CPU the step
    classes validate (and raise for a meta device)."""
    A, b, d = _spd(20, 7)
    dt = torch.as_tensor(d)
    st, part, x, r, p = _cg_start(b, dt, 5)
    with pytest.raises(ValueError, match="z = M r"):
        krylov.CgSteps(st, part, x, r, p, diag=dt).direction(r)
    with pytest.raises(ValueError, match="z = M r"):
        krylov.CgSteps(st, part, x, r, p).direction()
    ms, part_m, v, xm, rm = _minres_start(b, dt, 5)
    with pytest.raises(ValueError, match="inside step"):
        krylov.MinresSteps(ms, part_m, v, xm, rm, diag=dt).finish(rm)
    meta = torch.ones(20, dtype=torch.float64, device="meta")
    for call in (lambda: krylov.CgSteps(krylov.new_state("meta"), meta, meta, meta, meta, meta),
                 lambda: krylov.MinresSteps(krylov.minres_state("meta"), meta, meta, meta, meta)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert callable(krylov.Jacobi(dt)) and torch.equal(krylov.Jacobi(dt)(r), r / dt)


# ----------------------------------------------------- drivers vs reference


@pytest.mark.parametrize("n,seed", [(40, 8), (150, 9)])
def test_cg_with_jacobi_matches_reference(n, seed):
    """``cg(precond=Jacobi(d))`` against the JAX package's ``cg`` with
    ``precond=lambda v: v / d``: iterations within 1, x at 1e-9·scale; and
    against the port's generic driver on a lambda, bit for bit.  κ = 30
    behind the diagonal scaling: CG converges well under n iterations, so
    the counts are the recurrence's, not roundoff's."""
    A, b, d = _spd(n, seed, cond=30.0)
    want = JK.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), precond=lambda v: v / jnp.asarray(d),
                 rtol=1e-12, maxiter=10 * n)
    At, bt, dt = torch.as_tensor(A), torch.as_tensor(b), torch.as_tensor(d)
    got = PK.cg(lambda v: At @ v, bt, precond=krylov.Jacobi(dt), rtol=1e-12, maxiter=10 * n)
    assert got.converged and bool(want.converged)
    assert abs(got.iters - int(want.iters)) <= 1, (got.iters, int(want.iters))
    _close(got.x, want.x, 1e-9)
    generic = PK.cg(lambda v: At @ v, bt, precond=lambda v: krylov.jacobi(v, dt), rtol=1e-12,
                    maxiter=10 * n)
    assert generic.iters == got.iters and torch.equal(generic.x, got.x)


@pytest.mark.parametrize("n,seed", [(20, 10), (60, 11)])
def test_minres_with_jacobi_matches_reference(n, seed):
    """``minres(precond=Jacobi(d))`` against the JAX package's ``minres``
    with ``precond=lambda v: v / d``: x at 1e-7·scale; against the port's
    generic driver on a lambda, bit for bit."""
    A, b, d = _indefinite(n, seed)
    want = JK.minres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), rtol=1e-12,
                     precond=lambda v: v / jnp.asarray(d))
    At, bt, dt = torch.as_tensor(A), torch.as_tensor(b), torch.as_tensor(d)
    got = PK.minres(lambda v: At @ v, bt, precond=krylov.Jacobi(dt), rtol=1e-12)
    assert got.converged and bool(want.converged)
    assert abs(got.iters - int(want.iters)) <= 1, (got.iters, int(want.iters))
    _close(got.x, want.x, 1e-7)
    generic = PK.minres(lambda v: At @ v, bt, precond=lambda v: krylov.jacobi(v, dt), rtol=1e-12)
    assert generic.iters == got.iters and torch.equal(generic.x, got.x)


# -------------------------------------------------------- whole solves


def _solve_both(graph, N, k, kp, options, R=None):
    out = []
    for pkg in (J, P):
        mesh = pkg.NetworkMesh(graph(pkg), N=N)
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=kp)
        asm.compute_forms(p_bc_ex=lambda x: x[1], R=R(mesh) if callable(R) else R)
        kw = {"device": "cpu"} if pkg is P else {}
        s = pkg.Solver(asm, options=pkg.SolverOptions(**options), **kw)
        s.solve()
        out.append((np.asarray(s.solution_vector()), s.info, s))
    return out


def _edge_R(mesh):
    return np.random.default_rng(3).uniform(0.5, 2.0, mesh.num_edges)


SOLVES = {
    # (graph, N, k, kp, options, R, method, bar)
    "schur_p": (lambda pkg: pkg.network_generation.make_tree(4, 1, 2, arrays=True), 3, 2, 1,
                {"rtol": 1e-13}, _edge_R, "schur_p", 1e-9),
    "minres": (lambda pkg: pkg.network_generation.make_tree(3, 1, 2, arrays=True), 3, 1, 0,
               {"method": "minres", "rtol": 1e-13}, None, "minres", 1e-7),
    "cg_jacobi": (lambda pkg: pkg.network_generation.make_grid(12, 10, arrays=True), 1, 1, 0,
                  {"schur_method": "cg", "cg_precond": "jacobi"}, _edge_R, "schur", 1e-9),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solver_jacobi_routes_match_reference(name, monkeypatch):
    """The three Jacobi call sites (the schur_p executor, MINRES, the CG
    executor) against the JAX package, the Jacobi never called as a
    function: the drivers apply it inside their steps."""
    graph, N, k, kp, options, R, method, bar = SOLVES[name]

    def refuse(self, v):
        raise AssertionError("the Jacobi preconditioner was called outside the steps")

    monkeypatch.setattr(krylov.Jacobi, "__call__", refuse)
    (xj, ij, _), (xp, ip, sp_) = _solve_both(graph, N, k, kp, options, R)
    assert ip.method == method and ip.converged, ip
    if name == "cg_jacobi":
        assert isinstance(sp_._executor, PS._CgExecutor) and sp_._executor.precond_kind[0] == "jacobi"
    assert abs(ip.iterations - ij.iterations) <= 1, (ip, ij)
    _close(xp, xj, bar)


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tree(s):
    """block_sum over the rows of ``s`` (m, 256): the pairs (t, t + half)."""
    half = s.shape[1] // 2
    while half:
        s = s[:, :half] + s[:, half:2 * half]
        half //= 2
    return s[:, 0]


def _ordered_dot(a, b):
    """``a·b`` summed as the kernels sum: a tree over each 256 entries, then
    the partials strided by 256 threads and a tree (a 0-dim tensor)."""
    n = a.shape[0]
    nblk = -(-n // 256)
    prod = torch.zeros(nblk * 256, dtype=a.dtype, device=a.device)
    prod[:n] = a * b
    part = _tree(prod.view(nblk, 256))
    rows = torch.zeros(-(-nblk // 256) * 256, dtype=a.dtype, device=a.device)
    rows[:nblk] = part
    acc = torch.zeros(256, dtype=a.dtype, device=a.device)
    for row in rows.view(-1, 256):
        acc = acc + row
    return _tree(acc.view(1, 256))[0]


def _model_cg(st, x, r, p, Ap, diag):
    """One Jacobi CG iteration in the kernels' order (0-dim device scalars,
    so that every division is one)."""
    S = krylov
    if st[S.DONE] != 0:
        return
    st[S.ALPHA] = st[S.GAMMA] / _ordered_dot(p, Ap)
    alpha = st[S.ALPHA]
    x.copy_(x + alpha * p)
    r.copy_(r - alpha * Ap)
    z = r / diag
    k = st[S.K] + 1.0
    rnorm = torch.sqrt(_ordered_dot(r, r))
    rz = _ordered_dot(r, z)
    st[S.K], st[S.RNORM] = k, rnorm
    done = not bool((k < st[S.MAXITER]) & (rnorm > st[S.TOL]))
    st[S.DONE] = float(done)
    if not done:
        st[S.BETA] = rz / st[S.GAMMA]
        st[S.GAMMA] = rz
        p.copy_(z + st[S.BETA] * p)


def _model_minres(ms, v, yv, r1, r2, w, w2, x, d):
    """One Jacobi MINRES iteration in the kernels' order (``w1`` into
    ``w``); False once done."""
    S = krylov
    if ms[S.M_DONE] != 0:
        ms[S.M_ACTIVE] = 0.0
        return False
    beta = ms[S.M_BETA].clone()
    if ms[S.M_K] + 1.0 >= 2.0:
        yv.copy_(yv - (beta / ms[S.M_OLDB]) * r1)
    alfa = _ordered_dot(v, yv)
    yv.copy_(yv - (alfa / beta) * r2)
    y = yv / d
    bnew = torch.sqrt(torch.maximum(_ordered_dot(yv, y), torch.zeros_like(beta)))
    cs, sn, dbar, phibar, oldeps = (ms[i].clone() for i in (S.M_CS, S.M_SN, S.M_DBAR, S.M_PHIBAR,
                                                             S.M_EPSLN))
    delta = cs * dbar + sn * alfa
    gbar = sn * dbar - cs * alfa
    gamma = torch.maximum(torch.sqrt(gbar * gbar + bnew * bnew), torch.full_like(beta, S.EPS))
    cs_new, sn_new = gbar / gamma, bnew / gamma
    k = ms[S.M_K] + 1.0
    phi = cs_new * phibar
    new = {S.M_ALFA: alfa, S.M_OLDEPS: oldeps, S.M_DELTA: delta, S.M_GAMMA: gamma, S.M_PHI: phi,
           S.M_PHIBAR: sn_new * phibar, S.M_EPSLN: sn * bnew, S.M_DBAR: -cs * bnew, S.M_CS: cs_new,
           S.M_SN: sn_new, S.M_OLDB: beta, S.M_BETA: bnew, S.M_K: k, S.M_ACTIVE: torch.ones_like(k)}
    for slot, val in new.items():
        ms[slot] = val
    ms[S.M_DONE] = float(not bool((k < ms[S.M_MAXITER]) & ((sn_new * phibar).abs() > ms[S.M_TOL])))
    w1 = (v - oldeps * w - delta * w2) / gamma
    x.copy_(x + phi * w1)
    w.copy_(w1)
    v.copy_(y / torch.where(bnew > 0, bnew, torch.ones_like(bnew)))
    return True


def _tridiagonal(n, seed, dev):
    """A seeded diagonally dominant SPD tridiagonal matvec, its diagonal and a b."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = torch.rand(n, generator=gen, dtype=torch.float64, device=dev) + 3.0
    off = torch.rand(n - 1, generator=gen, dtype=torch.float64, device=dev)

    def mv(v):
        out = d * v
        out[:-1] += off * v[1:]
        out[1:] += off * v[:-1]
        return out

    return mv, d, torch.randn(n, generator=gen, dtype=torch.float64, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2_422, 70_924])
def test_fused_cg_kernels_match_plain_and_ordered_model_on_card(n):
    """K19a's fused steps: 12 Jacobi iterations against the plain steps at
    1e-12·scale and against the kernels' summation order bit for bit; the
    generic steps against the plain ones at 1e-12·scale."""
    dev = _card()
    mv, d, b = _tridiagonal(n, n, dev)
    runs = {}
    for key in ("kernel", "plain", "model"):  # the model from the kernel's start
        st, part, x, r, p = _cg_start(b, d, 10**6, dev, plain=key == "plain")
        if key == "model":
            for _ in range(12):
                _model_cg(st, x, r, p, mv(p), d)
        else:
            steps = krylov.CgSteps(st, part, x, r, p, diag=d, plain=key == "plain")
            for _ in range(12):
                steps.step(mv(p))
                steps.direction()
        torch.cuda.synchronize()
        runs[key] = (st, x, r, p)
    for got, want in zip(runs["kernel"], runs["plain"]):
        _close(got, want, 1e-12)
    for got, want in zip(runs["kernel"], runs["model"]):
        assert torch.equal(got, want)
    M = lambda v: v / d + 0.5 * v  # noqa: E731
    outs = []
    for plain in (False, True):
        st, part, x, r, _ = _cg_start(b, d, 10**6, dev, plain=plain)
        p = M(r)
        (krylov.cg_start_plain if plain else krylov.cg_start)(st, b, r, p, part, 1e-12, 0.0, 10**6)
        steps = krylov.CgSteps(st, part, x, r, p, plain=plain)
        for _ in range(6):
            steps.step(mv(p))
            steps.direction(M(r))
        outs.append((st, x, r, p))
    for got, want in zip(*outs):
        _close(got, want, 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [700, 2_422, 8_192, 20_000])
def test_fused_minres_kernels_match_plain_on_card(n, monkeypatch):
    """K19e: 40 Jacobi iterations in one cluster launch (up to 8,192: 3, 10
    and 32 chunks) and in ticket-finished launches (forced, and above),
    against the plain steps at 1e-12·scale and bit for bit against each
    other and the kernels' summation order; the generic step and finish
    against the plain ones."""
    dev = _card()
    if n <= 2_422:
        At, bt, dt = (torch.as_tensor(a, device=dev) for a in _indefinite(n, 12))
        mv = lambda v: At @ v  # noqa: E731
    else:  # a symmetric tridiagonal operator
        mv, dt, bt = _tridiagonal(n, 13, dev)
    modes = [("kernel", False, True), ("plain", True, True), ("generic", False, False),
             ("generic_plain", True, False)]
    if n <= 8_192:
        modes.append(("many", False, True))
    runs = {}
    for key, plain, jac in modes:
        ms, part, v, x, r = _minres_start(bt, dt, 10**6, dev, plain=plain)
        with monkeypatch.context() as m:
            if key == "many":  # the ticketed launches below the cluster's size
                m.setattr(krylov, "CLUSTER_CHUNKS", 0)
            steps = krylov.MinresSteps(ms, part, v, x, r, diag=dt if jac else None, plain=plain)
        for _ in range(40):
            yv = mv(v)
            steps.step(yv)
            if not jac:
                steps.finish(yv / dt)
        torch.cuda.synchronize()
        runs[key] = (ms, v, x, steps.w)
    ms, part, v, x, r = _minres_start(bt, dt, 10**6, dev, plain=False)  # the kernel's start
    r1, r2, w, w2 = torch.zeros_like(r), r.clone(), torch.zeros_like(r), torch.zeros_like(r)
    for _ in range(40):
        yv = mv(v)
        _model_minres(ms, v, yv, r1, r2, w, w2, x, dt)
        r1, r2, w, w2 = r2, yv, w2, w
    runs["model"] = (ms, v, x, w)
    for got, want in zip(runs["kernel"], runs["plain"]):
        _close(got, want, 1e-12)
    for got, want in zip(runs["generic"], runs["generic_plain"]):
        _close(got, want, 1e-12)
    for key in ("many", "model"):
        for got, want in zip(runs["kernel"], runs.get(key, runs["kernel"])):
            assert torch.equal(got, want), key


class _CgChunks:
    """Jacobi CG solves of a seeded tridiagonal system for the two-stream
    and graph tests: the buffers an iteration reads and writes, and a copy
    of a solve on clones of them."""

    n = 100_000

    def __init__(self, dev):
        self.dev = dev
        self.mv, self.d, self.b = _tridiagonal(self.n, 14, dev)

    def fresh(self):
        st, part, x, r, p = _cg_start(self.b, self.d, 10**6, self.dev, plain=False)
        return krylov.CgSteps(st, part, x, r, p, diag=self.d)

    def iteration(self, steps):
        steps.step(self.mv(steps.p))
        steps.direction()

    def buffers(self, steps):
        return [steps.st, steps.x, steps.r, steps.p, steps.z]

    def copy(self, steps):
        st, x, r, p, z = (t.clone() for t in self.buffers(steps))
        new = krylov.CgSteps(st, krylov.partials(self.n, self.dev), x, r, p, diag=self.d)
        new.z.copy_(z)
        return new


class _MinresChunks:
    """Jacobi MINRES solves of a seeded tridiagonal system, as
    :class:`_CgChunks`; ``tickets`` forces the ticket-finished launches
    below the cluster's size."""

    n = 8_000

    def __init__(self, dev, tickets):
        self.dev, self.tickets = dev, tickets
        self.mv, self.d, self.b = _tridiagonal(self.n, 15, dev)

    def _steps(self, ms, part, v, x, r):
        with pytest.MonkeyPatch.context() as m:
            if self.tickets:
                m.setattr(krylov, "CLUSTER_CHUNKS", 0)
            return krylov.MinresSteps(ms, part, v, x, r, diag=self.d)

    def fresh(self):
        return self._steps(*_minres_start(self.b, self.d, 10**6, self.dev, plain=False))

    def iteration(self, steps):
        steps.step(self.mv(steps.v))

    def buffers(self, steps):
        return [steps.ms, steps.v, steps.x, steps.r1, steps.r2, steps.w, steps.w2]

    def copy(self, steps):
        ms, v, x, r1, r2, w, w2 = (t.clone() for t in self.buffers(steps))
        new = self._steps(ms, krylov.partials(self.n, self.dev), v, x, r2)
        new.r1, new.w, new.w2 = r1, w, w2
        return new


@pytest.mark.cuda
@pytest.mark.parametrize("solve", ["cg", "minres_cluster", "minres_tickets"])
def test_fused_krylov_on_two_streams_and_in_graph_replays_on_card(solve):
    """Two Jacobi solves on two streams at once, and 3 replays of a CUDA
    graph of one chunk (4 iterations) from the same state, give the bits of
    one solve alone: CG, and MINRES in its one cluster launch and in its
    ticket-finished launches (the ticket word in the solve's scratch)."""
    dev = _card()
    case = _CgChunks(dev) if solve == "cg" else _MinresChunks(dev, solve == "minres_tickets")

    def chunk(steps):
        for _ in range(PK.CHUNK):
            case.iteration(steps)

    def same(got, want):
        return all(torch.equal(a, b_) for a, b_ in zip(case.buffers(got), case.buffers(want)))

    alone = case.fresh()
    for _ in range(3):
        chunk(alone)
    runs = [case.fresh() for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in runs]
    torch.cuda.synchronize()
    for steps, s in zip(runs, streams):
        with torch.cuda.stream(s):
            for _ in range(3):
                chunk(steps)
    torch.cuda.synchronize()
    assert all(same(steps, alone) for steps in runs)

    steps = case.fresh()
    chunk(steps)  # warm up, then capture the next chunk
    torch.cuda.synchronize()
    start = case.buffers(steps)  # what the captured chunk reads first
    saved = [t.clone() for t in start]
    eager = case.copy(steps)
    chunk(eager)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chunk(steps)
    for _ in range(3):
        for t, v in zip(start, saved):
            t.copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        assert same(steps, eager)
