"""Gradients through the blocked solve (``networks_fenicsx_tpu_torch.adjoint``).

The blocked route's executor is one autograd node (``BlockedSolve``): its
forward runs K1, K2's factor, K3–K4's apply and K5, its backward K5's
transpose (``expand_vjp``), the fold of its endpoint cotangents
(``expand_vjp_fold``), the adjoint λ solve on the stored factor
(``tree_sweep_solve``) and K1's transpose (``condense_vjp``).  On the CPU
each runs its plain version.

The mirrors of ``tests/test_transforms.py:52, 107, 123`` run the port as
those tests run the reference (``outputs="flat"`` for the first two, the
blocks and ``prepare_args`` for the third), held to the reference's
central differences at its rtol and to ``jax.grad`` of the JAX package's
executor on the same inputs at 1e-11·max(1, max|g|); so is a random linear
functional of ``(q_T, p_T, λ)`` in every R-mode × f-mode × degree case,
with respect to all four inputs.  The plain transposes are held to
PyTorch's autograd through ``expand_plain`` and ``condense_plain`` at
1e-13·scale; ``gradcheck`` runs on a Y-bifurcation; the no-grad outputs
equal the grad-mode outputs bit for bit; ``outputs="flat"`` equals the
host flatten bit for bit and the reference's flat vector at 1e-12·scale;
every executor without an adjoint raises naming ROADMAP A9c.  The
``cuda``-marked tests hold the kernels on the card against their plain
versions and the card's gradient against the plain path's.  The JAX
package is imported only inside the tests that compare with it.
"""

import itertools

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import kernels
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch.kernels import condense, expand, tree_sweep
from networks_fenicsx_tpu_torch.kernels.expand import _lambda_to_edges
from networks_fenicsx_tpu_torch.solver import _flatten_blocks_host

torch.set_num_threads(1)

CPU = {"device": "cpu"}
MODES = ("scalar", "edge", "cell")
JAX_TOL = 1e-11  # port vs jax.grad, times max(1, max |g|)
PLAIN_TOL = 1e-13  # plain transposes vs autograd through the plain versions, times the scale
CARD_TOL = 1e-12  # kernel vs plain version on the card, times the scale


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _jax():
    import jax

    import networks_fenicsx_tpu as J
    from networks_fenicsx_tpu.solver import build_schur_executor

    return jax, J, build_schur_executor


def _setup(pkg, n=3, N=3):
    """tests/test_transforms.py:21: make_tree(n), per-edge R = 1, p_bc = y."""
    mesh = pkg.NetworkMesh(pkg.network_generation.make_tree(n, 1.0, 2.0), N=N)
    asm = pkg.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.ones(mesh.num_edges))
    return mesh, asm


# ------------------------------------------------------- mirrors of test_transforms.py


def test_grad_through_solve():
    """tests/test_transforms.py:52: d x[0] / dR through ``outputs="flat"``."""
    jax, J, jbuild = _jax()
    mesh, asm = _setup(P)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), outputs="flat", **CPU)
    assert type(ex.inner).__name__ == "_BlockedExecutor" and not ex.blocks_out
    R_q, f_q, spbc, epbc = asm.schur_arguments(device=False)

    def outflow(R):
        x, *_ = ex(R, f_q, spbc, epbc)
        return x[0]

    R = torch.tensor(R_q, requires_grad=True)
    (g,) = torch.autograd.grad(outflow(R), R)
    assert g.shape == R.shape
    rng = np.random.default_rng(0)
    d = torch.tensor(rng.standard_normal(R_q.shape))
    eps = 1e-6
    with torch.no_grad():
        fd = (outflow(R + eps * d) - outflow(R - eps * d)) / (2 * eps)
    np.testing.assert_allclose(float(g @ d), float(fd), rtol=1e-5)

    _, aj = _setup(J)
    exj = jbuild(aj, J.SolverOptions(), jit=False)
    Rj, fj, spj, epj = aj.schur_arguments()
    gj = jax.grad(lambda R: exj(R, fj, spj, epj)[0][0])(Rj)
    _close(g, gj, JAX_TOL)


def test_grad_wrt_boundary_pressure():
    """tests/test_transforms.py:107: the mean pressure's gradient wrt end_pbc."""
    jax, J, jbuild = _jax()
    mesh, asm = _setup(P)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), outputs="flat", **CPU)
    R_q, f_q, spbc, epbc = asm.schur_arguments(device=False)
    offs = asm.block_offsets
    M = mesh.num_edge_colors

    def mean_pressure(pb_end):
        x, *_ = ex(R_q, f_q, spbc, pb_end)
        return torch.mean(x[offs[M] : offs[M + 1]])

    pb = torch.tensor(epbc, requires_grad=True)
    (g,) = torch.autograd.grad(mean_pressure(pb), pb)
    eps = 1e-6
    d = torch.ones_like(pb)
    with torch.no_grad():
        fd = (mean_pressure(pb + eps * d) - mean_pressure(pb - eps * d)) / (2 * eps)
    np.testing.assert_allclose(float(g @ d), float(fd), rtol=1e-6)

    _, aj = _setup(J)
    exj = jbuild(aj, J.SolverOptions(), jit=False)
    Rj, fj, spj, epj = aj.schur_arguments()
    gj = jax.grad(lambda e: jax.numpy.mean(exj(Rj, fj, spj, e)[0][offs[M] : offs[M + 1]]))(epj)
    _close(g, gj, JAX_TOL)


def _degree2(pkg):
    """tests/test_transforms.py:123: make_tree(3), N = 2, k = 2, R linspace."""
    mesh = pkg.NetworkMesh(pkg.network_generation.make_tree(3, 1.0, 2.0), N=2,
                           color_strategy="fast")
    asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=2)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=np.linspace(0.5, 2.0, mesh.num_edges))
    return asm


def test_grad_through_blocked_high_degree():
    """tests/test_transforms.py:123: Σ q_T[0]² at k = 2 through the blocks."""
    jax, J, jbuild = _jax()
    asm = _degree2(P)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), outputs="blocks", **CPU)
    assert type(ex).__name__ == "_BlockedExecutor"
    args = ex.prepare_args(*asm.schur_arguments(device=False))

    def loss(R):
        q_T, p_T, lam, *_ = ex(R, args[1], args[2], args[3])
        return torch.sum(q_T[0] ** 2)

    R = torch.tensor(np.asarray(args[0], np.float64), requires_grad=True)
    (g,) = torch.autograd.grad(loss(R), R)
    eps = 1e-6
    Rp, Rm = R.detach().clone(), R.detach().clone()
    Rp[2] += eps
    Rm[2] -= eps
    with torch.no_grad():
        fd = (loss(Rp) - loss(Rm)) / (2 * eps)
    np.testing.assert_allclose(float(g[2]), float(fd), rtol=1e-6)

    exj = jbuild(_degree2(J), J.SolverOptions(), outputs="blocks", internal_layout=True)
    gj = jax.grad(lambda R: jax.numpy.sum(exj(R, *args[1:])[0][0] ** 2))(jax.numpy.asarray(args[0]))
    _close(g, gj, JAX_TOL)


# ------------------------------------------------------- every mode against jax.grad


def _mode_assembler(pkg, R_mode: str, f_mode: str, k: int, seed: int, n: int = 4, N: int = 3):
    """make_tree(n) at N cells an edge with seeded R and f of the given modes
    (f of either sign) and p_bc = y + x / 3."""
    mesh = pkg.NetworkMesh(pkg.network_generation.make_tree(n, 1.0, 2.0, arrays=True), N=N)
    asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k)
    rng = np.random.default_rng(seed)
    size = {"scalar": None, "edge": mesh.num_edges, "cell": mesh.num_cells}
    R = rng.uniform(0.5, 2.0, size[R_mode])
    f = rng.uniform(-1.0, 1.0, size[f_mode])
    asm.compute_forms(p_bc_ex=lambda x: x[1] + x[0] / 3.0, R=float(R) if R_mode == "scalar" else R,
                      f=float(f) if f_mode == "scalar" else f)
    assert asm.coefficient_modes()[:2] == (R_mode, f_mode)
    return asm


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("R_mode,f_mode", list(itertools.product(MODES, MODES)))
def test_gradients_match_jax(R_mode, f_mode, k):
    """A random linear functional of ``(q_T, p_T, λ)``: its gradient wrt R,
    f, start_pbc and end_pbc (internal order, ``elide_zero_f=False``)
    against ``jax.grad`` of the reference's blocked executor, and against
    PyTorch's autograd of the plain path."""
    jax, J, jbuild = _jax()
    seed = 10 * k + 3 * MODES.index(R_mode) + MODES.index(f_mode)
    asm = _mode_assembler(P, R_mode, f_mode, k, seed)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), elide_zero_f=False, **CPU)
    assert type(ex).__name__ == "_BlockedExecutor" and ex.has_adjoint
    args = [np.asarray(a, np.float64) for a in ex.prepare_args(*asm.schur_arguments(device=False))]
    out = ex(*args)
    rng = np.random.default_rng(seed + 100)
    weights = [rng.standard_normal(tuple(t.shape)) for t in out[:3]]

    def loss_of(blocks, total=lambda a, b: torch.sum(a * b)):
        return sum(total(blk, torch.as_tensor(w)) for blk, w in zip(blocks, weights))

    xs = [torch.tensor(a, requires_grad=True) for a in args]
    grads = torch.autograd.grad(loss_of(ex(*xs)[:3]), xs)
    ys = [torch.tensor(a, requires_grad=True) for a in args]
    plain = torch.autograd.grad(loss_of(ex.plain(*ys)[:3]), ys)

    exj = jbuild(_mode_assembler(J, R_mode, f_mode, k, seed), J.SolverOptions(), jit=False,
                 outputs="blocks", internal_layout=True, elide_zero_f=False)

    def loss_j(*a):
        return sum(jax.numpy.sum(b * w) for b, w in zip(exj(*a)[:3], weights))

    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*(jax.numpy.asarray(a) for a in args))
    for got, want, also in zip(grads, gj, plain):
        _close(got, want, JAX_TOL)
        _close(got, also, JAX_TOL)


# ------------------------------------------------------- the plain transposes


def _forward_inputs(R_mode, f_mode, k, seed):
    """A blocked executor on the CPU and its internal-order inputs, with
    K1's outputs and λ."""
    asm = _mode_assembler(P, R_mode, f_mode, k, seed)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), elide_zero_f=False, **CPU)
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments(device=False)))
    dp, N, h = ex.device_plan, ex._N, ex._h_e
    W, w, g, Ftot, const = condense.condense_plain(dp.plan, N, k, h, R, f, R_mode, f_mode, sp, ep)
    lam = tree_sweep.tree_sweep_plain(dp.plan, w, const, Ftot)[0]
    return ex, dp, N, h, (R, f, sp, ep), (W, w, g, Ftot), lam


CASES = [("edge", "scalar", 1), ("scalar", "cell", 1), ("cell", "edge", 2), ("cell", "cell", 3),
         ("scalar", "scalar", 2), ("edge", "cell", 2)]


@pytest.mark.parametrize("R_mode,f_mode,k", CASES)
def test_expand_vjp_plain_matches_autograd(R_mode, f_mode, k):
    """``expand_vjp_plain`` and the fold against ``torch.autograd.grad``
    through ``expand_plain`` wrt λ, the boundary data, w, g, R and f."""
    ex, dp, N, h, (R, f, sp, ep), (W, w, g, Ftot), lam = _forward_inputs(R_mode, f_mode, k, k + 7)
    rng = np.random.default_rng(k)
    E = dp.num_edges
    q_bar = torch.tensor(rng.standard_normal((k * N + 1, E)))
    p_bar = torch.tensor(rng.standard_normal((N, E)))
    xs = [t.detach().clone().requires_grad_(True) for t in (lam, sp, ep, w, g, R, f)]
    q_T, p_T, _ = expand.expand_plain(dp.plan, N, k, xs[0], xs[1], xs[2], W, xs[3], xs[4], Ftot, h,
                                      xs[5], xs[6], R_mode, f_mode)
    want = torch.autograd.grad(torch.sum(q_T * q_bar) + torch.sum(p_T * p_bar), xs)
    bars, R_part, f_part = expand.expand_vjp_plain(dp.plan, N, k, lam, sp, ep, w, g, h, R, f,
                                                   R_mode, f_mode, q_bar, p_bar)
    rho, rhs_edges = expand.expand_vjp_fold_plain(dp, torch.zeros_like(lam), bars)
    s_b = torch.as_tensor(dp.plan.s_is_bif)
    t_b = torch.as_tensor(dp.plan.t_is_bif)
    lam_s, lam_t = _lambda_to_edges(dp.plan, lam)
    num = torch.where(s_b, lam_s, -sp) + torch.where(t_b, -lam_t, ep) - g
    zero = torch.zeros_like(sp)
    got = (rho, torch.where(s_b, zero, -bars[1]), torch.where(t_b, zero, bars[2]),
           bars[0] * num, -bars[0] * w,
           R_part.sum().reshape(1) if R_mode == "scalar" else R_part,
           f_part.sum().reshape(1) if f_mode == "scalar" else f_part)
    for a, b in zip(got, want):
        _close(a, b, PLAIN_TOL)
    # the fold's right-hand side: rho at each bifurcation's in-edge, 0 elsewhere
    want_rhs = torch.zeros_like(sp)
    want_rhs[dp.bif_in.long()] = rho
    assert torch.equal(rhs_edges, want_rhs)


@pytest.mark.parametrize("R_mode,f_mode,k", CASES)
def test_condense_vjp_plain_matches_autograd(R_mode, f_mode, k):
    """``condense_vjp_plain`` against ``torch.autograd.grad`` of the adjoint
    Lagrangian through ``condense_plain``: with λ and z held, ``⟨q̄0, q0⟩ +
    ⟨P, r0⟩ + zᵀ(A const + T Ftot) − Σ_e w_e (a_eᵀz)(a_eᵀλ) + ⟨R_part, R⟩ +
    ⟨f_part, f⟩``, whose gradient is K1ᵀ's by construction."""
    ex, dp, N, h, (R, f, sp, ep), (W, w, g, Ftot), lam = _forward_inputs(R_mode, f_mode, k, k + 11)
    rng = np.random.default_rng(k + 1)
    E, B = dp.num_edges, dp.num_bifurcations
    q0_bar, P0 = (torch.tensor(rng.standard_normal(E)) for _ in range(2))
    z = torch.tensor(rng.standard_normal(B))
    part = {"scalar": (E,), "edge": (E,), "cell": (N, E)}
    R_part = torch.tensor(rng.standard_normal(part[R_mode]))
    f_part = torch.tensor(rng.standard_normal(part[f_mode]))
    bars = torch.stack([q0_bar, P0 + q0_bar * w, q0_bar * w])

    xs = [t.detach().clone().requires_grad_(True) for t in (R, f, sp, ep)]
    _, w_, g_, Ftot_, const_ = condense.condense_plain(dp.plan, N, k, h, *xs[:2], R_mode, f_mode,
                                                       *xs[2:])
    s_b = torch.as_tensor(dp.plan.s_is_bif)
    t_b = torch.as_tensor(dp.plan.t_is_bif)
    lam_s, lam_t = _lambda_to_edges(dp.plan, lam)
    z_s, z_t = _lambda_to_edges(dp.plan, z)
    r0 = torch.where(s_b, lam_s, -xs[2])
    rN = torch.where(t_b, -lam_t, xs[3])
    lagrangian = (torch.sum(q0_bar * (r0 + rN - g_) * w_) + torch.sum(P0 * r0)
                  + torch.sum((z_t - z_s) * const_ + z_t * Ftot_)
                  - torch.sum(w_ * (z_t - z_s) * (lam_t - lam_s))
                  + torch.sum((R_part.sum() if R_mode == "scalar" else R_part) * xs[0])
                  + torch.sum((f_part.sum() if f_mode == "scalar" else f_part) * xs[1]))
    want = torch.autograd.grad(lagrangian, xs)
    got = condense.condense_vjp_plain(dp.plan, N, k, h, R, f, R_mode, f_mode, sp, ep, w, g, lam, z,
                                      bars, R_part, f_part)
    for a, b in zip(got, want):
        _close(a, b, PLAIN_TOL)


def test_tree_sweep_solve_solves_the_adjoint_system():
    """``tree_sweep_solve`` on the stored factor: ``S z = ρ`` with ``S = Σ_e
    w_e a_e a_eᵀ``, ρ placed at each bifurcation's in-edge."""
    ex, dp, N, h, _, (W, w, g, Ftot), lam = _forward_inputs("edge", "edge", 1, 5)
    B = dp.num_bifurcations
    rho = torch.tensor(np.random.default_rng(3).standard_normal(B))
    rhs = torch.zeros_like(w)
    rhs[dp.bif_in.long()] = rho
    z = tree_sweep.tree_sweep_solve(dp, *tree_sweep.tree_sweep_factor(dp, w), rhs)
    assert torch.equal(z, tree_sweep.tree_sweep_solve_plain(
        dp, *tree_sweep.tree_sweep_factor_plain(dp.plan, w), rhs))
    S = torch.zeros((B, B), dtype=torch.float64)
    for e, (s, t) in enumerate(zip(dp.edge_src.tolist(), dp.edge_tgt.tolist())):
        a = torch.zeros(B, dtype=torch.float64)
        if s >= 0:
            a[s] -= 1.0
        if t >= 0:
            a[t] += 1.0
        S += w[e] * torch.outer(a, a)
    _close(S @ z, rho, PLAIN_TOL)
    assert np.array_equal(np.sort(dp.bif_in.numpy()), np.unique(dp.bif_in.numpy()))


def test_gradcheck_y_bifurcation():
    """``torch.autograd.gradcheck`` through the executor on make_tree(2)
    (per-edge R, per-cell f, k = 2)."""
    mesh = P.NetworkMesh(P.network_generation.make_tree(2, 1.0, 3.0), N=3)
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=2)
    rng = np.random.default_rng(2)
    asm.compute_forms(p_bc_ex=lambda x: x[1], R=rng.uniform(0.5, 2.0, mesh.num_edges),
                      f=rng.uniform(-1.0, 1.0, mesh.num_cells))
    ex = PS.build_schur_executor(asm, P.SolverOptions(), **CPU)
    xs = tuple(torch.tensor(np.asarray(a, np.float64), requires_grad=True)
               for a in ex.prepare_args(*asm.schur_arguments(device=False)))
    assert torch.autograd.gradcheck(lambda *a: ex(*a)[:3], xs)


def test_no_grad_outputs_equal_grad_mode_outputs():
    """The grad-mode solve (K2's factor and K3–K4's apply) gives the no-grad
    solve's outputs bit for bit, and only the blocked kernels' wrappers
    are called."""
    asm = _mode_assembler(P, "cell", "edge", 2, 4, n=5)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), **CPU)
    args = ex.upload(*ex.prepare_args(*asm.schur_arguments(device=False)))
    with torch.no_grad():
        want = ex(*args)
    got = ex(*(a.clone().requires_grad_(True) for a in args))
    assert got[0].requires_grad and got[2].requires_grad and not got[5].requires_grad
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b)


def test_double_backward_raises():
    """The backward is not differentiable (ROADMAP A9c-4): differentiating
    a gradient taken with ``create_graph=True`` raises."""
    asm = _mode_assembler(P, "edge", "scalar", 1, 6)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), **CPU)
    R, *rest = ex.prepare_args(*asm.schur_arguments(device=False))
    R = torch.tensor(np.asarray(R, np.float64), requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(ex(R, *rest)[0] ** 2), R, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        torch.sum(g).backward()


@pytest.mark.parametrize("k,R_kind", [(1, "edge"), (2, "edge"), (1, "cell")])
def test_elided_zero_source(k, R_kind):
    """Under ``outputs="flat"`` a zero scalar f is elided where the
    reference's flat program elides it (its gradient zero) and read where
    the program reads it (flux degree 1, R per edge): f's gradient against
    ``jax.grad`` of the reference's flat executor."""
    jax, J, jbuild = _jax()

    def build(pkg):
        mesh = pkg.NetworkMesh(pkg.network_generation.make_tree(3, 1.0, 2.0), N=3)
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k)
        R = np.linspace(0.5, 2.0, mesh.num_edges if R_kind == "edge" else mesh.num_cells)
        asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)
        return asm

    asm = build(P)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), outputs="flat", **CPU)
    assert ex.f_elided == (k != 1 or R_kind == "cell")
    R_q, f_q, spbc, epbc = asm.schur_arguments(device=False)
    f = torch.tensor(np.asarray(f_q, np.float64), requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(ex(R_q, f, spbc, epbc)[0] ** 2), f)
    aj = build(J)
    exj = jbuild(aj, J.SolverOptions(), jit=False)
    Rj, fj, spj, epj = aj.schur_arguments()
    gj = jax.grad(lambda f: jax.numpy.sum(exj(Rj, f, spj, epj)[0] ** 2))(fj)
    _close(g, gj, JAX_TOL)
    assert bool(torch.all(g == 0)) == ex.f_elided


# ------------------------------------------------------- outputs="flat"


@pytest.mark.parametrize("k,R_mode,f_mode", [(1, "edge", "scalar"), (2, "cell", "cell"),
                                             (1, "scalar", "edge")])
def test_flat_output(k, R_mode, f_mode):
    """``outputs="flat"``: public-order arguments permuted on the device, x
    one gather of the blocks — the host flatten's bits, and the reference's
    flat x at 1e-12·scale."""
    _, J, jbuild = _jax()
    asm = _mode_assembler(P, R_mode, f_mode, k, 21, n=4)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), outputs="flat", **CPU)
    args = asm.schur_arguments(device=False)
    x, iters, residual, rhs_norm, finite = ex(*args)
    assert x.shape == (asm.num_dofs,) and bool(finite) and int(iters) == 0
    blocks = ex.inner(*ex.inner.prepare_args(*args))
    host = _flatten_blocks_host(blocks[0].numpy(), blocks[1].numpy(), blocks[2].numpy(),
                                asm.network.edge_color, ex.inner.edge_order, ex.inner.bif_order)
    assert np.array_equal(x.numpy(), host)
    assert torch.equal(rhs_norm, blocks[5])
    assert ex.plain(*args)[0].shape == x.shape
    aj = _mode_assembler(J, R_mode, f_mode, k, 21, n=4)
    xj = jbuild(aj, J.SolverOptions(), jit=False)(*aj.schur_arguments())[0]
    _close(x, np.asarray(xj), 1e-12)


def test_outputs_keyword_is_checked():
    _, asm = _setup(P)
    with pytest.raises(ValueError, match="outputs"):
        PS.build_schur_executor(asm, P.SolverOptions(), outputs="vector", **CPU)


# ------------------------------------------------------- routes without an adjoint


def _route(name: str):
    """``(assembler, options)`` of a route that has no adjoint yet."""
    g = P.network_generation
    mesh_of = {
        "level": lambda: P.NetworkMesh(g.make_random_network(60, keep=0.0, seed=5, arrays=True),
                                       N=2),
        "tree": lambda: P.NetworkMesh(g.make_random_network(60, keep=0.3, seed=5, arrays=True),
                                      N=2),
        "grid": lambda: P.NetworkMesh(g.make_grid(5, 4, arrays=True), N=1),
        "cg": lambda: P.NetworkMesh(g.make_tree(3, 1.0, 2.0, arrays=True), N=2),
        "dense": lambda: P.NetworkMesh(g.make_tree(3, 1.0, 2.0, arrays=True), N=2),
        "edge": lambda: P.NetworkMesh(g.make_tree(1, 1.0, 3.0, arrays=True), N=4),
    }
    method = {"grid": "dct", "cg": "cg", "dense": "dense"}.get(name, "auto")
    asm = P.HydraulicNetworkAssembler(mesh_of[name]())
    asm.compute_forms(p_bc_ex=lambda x: x[1],
                      R=1.0 if name == "grid" else np.ones(asm.network.num_edges))
    return asm, P.SolverOptions(schur_method=method)


ROUTES = {"level": "_LevelExecutor", "tree": "_TreeExecutor", "grid": "_GridExecutor",
          "cg": "_CgExecutor", "dense": "_DenseExecutor", "edge": "_EdgeExecutor"}


@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_without_adjoint_raise(route):
    """An input that requires grad raises ``NotImplementedError`` naming
    ROADMAP A9c on every route but the blocked one (the grid route
    subclasses the blocked executor and does not inherit its adjoint),
    through ``__call__``, ``plain`` and ``outputs="flat"``; under
    ``torch.no_grad()`` the same call solves."""
    asm, opts = _route(route)
    ex = PS.build_schur_executor(asm, opts, **CPU)
    assert type(ex).__name__ == ROUTES[route] and not ex.has_adjoint
    R, *rest = ex.prepare_args(*asm.schur_arguments(device=False))
    R = torch.tensor(np.asarray(R, np.float64), requires_grad=True)
    for call in (ex, ex.plain):
        with pytest.raises(NotImplementedError, match="ROADMAP A9c"):
            call(R, *rest)
    flat = PS.build_schur_executor(asm, opts, outputs="flat", **CPU)
    public = asm.schur_arguments(device=False)
    with pytest.raises(NotImplementedError, match="ROADMAP A9c"):
        flat(torch.tensor(np.asarray(public[0], np.float64), requires_grad=True), *public[1:])
    with torch.no_grad():
        q_T = ex(R, *rest)[0]
        x = flat(torch.tensor(np.asarray(public[0], np.float64), requires_grad=True),
                 *public[1:])[0]
    assert not q_T.requires_grad and x.shape == (asm.num_dofs,)


def test_sharded_executor_refuses_grad():
    """The sharded blocked executor (two shards on the CPU) refuses inputs
    that require grad."""
    from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

    _, asm = _setup(P)
    solver = ShardedNetworkSolver(asm, devices=["cpu"] * 2)
    solver.solve()
    ex = solver._blocked_exec
    assert type(ex).__name__ == "ShardedBlockedExecutor"
    shard_args = [tuple(torch.as_tensor(np.asarray(a, np.float64)).clone().requires_grad_(True)
                        for a in shard) for shard in ex.prepare_args(*solver._coeff_args)]
    with pytest.raises(NotImplementedError, match="ROADMAP A9c"):
        ex(shard_args)


def test_sweep_scenarios_refuse_grad():
    """A sweep's scenario axis and ``solve_sweep`` refuse inputs that
    require grad (ROADMAP A9c-4)."""
    asm = _mode_assembler(P, "edge", "scalar", 1, 8)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), **CPU)
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments(device=False)))
    with pytest.raises(NotImplementedError, match="ROADMAP A9c"):
        ex.scenarios(torch.stack([R, 2 * R]).requires_grad_(True), f, sp, ep)
    public_R = torch.as_tensor(np.asarray(asm.schur_arguments(device=False)[0], np.float64))
    with pytest.raises(NotImplementedError, match="ROADMAP A9c"):
        P.solve_sweep(asm, R=torch.stack([public_R, 2 * public_R]).requires_grad_(True),
                      device="cpu")


# ---------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("R_mode,f_mode", list(itertools.product(MODES, MODES)))
def test_adjoint_kernels_on_card(R_mode, f_mode, k):
    """On a CUDA device: ``expand_vjp``, the fold and ``condense_vjp``
    against their plain versions on the same inputs (the fold bit for bit),
    the gradient of a random functional against PyTorch's autograd of the
    plain path at 1e-12·scale, the no-grad outputs equal to the grad-mode
    outputs, and the wrappers' launches of one gradient."""
    dev = _card()
    seed = 10 * k + 3 * MODES.index(R_mode) + MODES.index(f_mode)
    asm = _mode_assembler(P, R_mode, f_mode, k, seed, n=9, N=5)
    ex = PS.build_schur_executor(asm, P.SolverOptions(), device=dev, elide_zero_f=False)
    base = ex.upload(*ex.prepare_args(*asm.schur_arguments(device=False)))
    R, f, sp, ep = base
    dp, N, h = ex.device_plan, ex._N, ex._h_e
    E, B = dp.num_edges, dp.num_bifurcations
    W, w, g, Ftot, const = condense.condense(dp, N, k, h, R, f, R_mode, f_mode, sp, ep)
    d, wn, fac = tree_sweep.tree_sweep_factor(dp, w)
    lam = tree_sweep.tree_sweep_apply(dp, d, wn, fac, const, Ftot)[0]
    rng = np.random.default_rng(seed)
    q_bar, p_bar, lam_bar = (torch.as_tensor(rng.standard_normal(s), device=dev)
                             for s in ((k * N + 1, E), (N, E), (B,)))
    got = expand.expand_vjp(dp, N, k, lam, sp, ep, w, g, h, R, f, R_mode, f_mode, q_bar, p_bar)
    want = expand.expand_vjp_plain(dp.plan, N, k, lam, sp, ep, w, g, h, R, f, R_mode, f_mode,
                                   q_bar, p_bar)
    for a, b in zip(got, want):
        _close(a, b, CARD_TOL)
    bars, R_part, f_part = got
    rho, rhs = expand.expand_vjp_fold(dp, lam_bar, bars)
    rho_p, rhs_p = expand.expand_vjp_fold_plain(dp, lam_bar, bars)
    assert torch.equal(rho, rho_p) and torch.equal(rhs, rhs_p)
    z = tree_sweep.tree_sweep_solve(dp, d, wn, fac, rhs)
    _close(z, tree_sweep.tree_sweep_solve_plain(dp, d, wn, fac, rhs), CARD_TOL)
    args = (N, k, h, R, f, R_mode, f_mode, sp, ep, w, g, lam, z, bars)
    want = condense.condense_vjp_plain(dp.plan, *args, R_part, f_part)
    got = condense.condense_vjp(dp, *args, R_part.clone(), f_part.clone())
    for a, b in zip(got, want):
        _close(a, b, CARD_TOL)

    weights = [torch.as_tensor(rng.standard_normal(s), device=dev)
               for s in ((k * N + 1, E), (N, E), (B,))]

    def gradient(run):
        xs = [t.clone().requires_grad_(True) for t in base]
        out = run(*xs)
        return out, torch.autograd.grad(sum(torch.sum(a * b) for a, b in zip(out, weights)), xs)

    kernels.reset_launches()
    out, grads = gradient(ex)
    torch.cuda.synchronize()
    counts = {n: v for n, v in kernels.launches().items() if v}
    assert counts == {"condense": 1, "tree_sweep_factor": 1, "tree_sweep_apply": 2, "expand": 1,
                      "expand_vjp": 1, "expand_vjp_fold": 1, "condense_vjp": 1}, counts
    _, plain = gradient(ex.plain)
    for a, b in zip(grads, plain):
        _close(a, b, CARD_TOL)
    with torch.no_grad():
        nograd = ex(*base)
    assert all(torch.equal(a.detach(), b) for a, b in zip(out[:3], nograd[:3]))
