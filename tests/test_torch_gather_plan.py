"""K19b on a checked plan, from a solve's value table, and the Chebyshev
application in one host call (``kernels/gather_matvec.py``).

The CG executor makes one ``GatherPlan`` for its tables; a solve's operator
gathers the value table ``−w[mv_edge]`` once, and the matvec, the residual
and a whole Chebyshev-Jacobi application (``ChebApply``: K19a's start
folded into the first of the ``degree − 1`` steps) read it.  On the CPU:

* ``GatherPlan`` refuses tables that are not int32 ``(K, B)`` pairs on one
  device, entries out of range, ``-1`` in one table only, or an entry past a
  row's first ``-1``;
* the wrappers' CPU path (the value table) equals the direct plain versions
  by ``torch.equal``, and ``cheb_apply_plain`` (the fused application's
  plain version) equals the composed plain steps
  (``chebyshev_preconditioner`` on the plain operator) by ``torch.equal``,
  at degrees 1, 2 and 8, with and without ``base``;
* the executor's Chebyshev preconditioner on the operator is one
  ``ChebApply`` (on the CPU its plain version, equal to the composed plain
  steps), and the plain executor's the composed plain steps;
* ``Solver(device="cpu")`` under ``schur_method="cg"`` on small webs meets
  the JAX package at 1e-9·scale, iterations within 1.

The ``cuda``-marked test holds the kernels against the plain versions bit
for bit: the value table, the matvec and residual, ``ChebApply`` against
``cheb_apply_plain`` on two streams, also as the executor makes it (and
the operator's per-step form refused on the card); and a CG solve on the
card meets the CPU's.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import multigrid as PM
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch.kernels import edge_data, gather_matvec as GM, krylov, peel
from networks_fenicsx_tpu_torch.ops import krylov as PK

torch.set_num_threads(1)


def _web(n, keep, seed):
    return lambda pkg: pkg.network_generation.make_random_network(n, keep=keep, num_boundary=6, seed=seed,
                                                                  arrays=True)


def _assembler(pkg, graph, seed=0):
    mesh = pkg.NetworkMesh(graph(pkg), N=2, color_strategy="fast")
    asm = pkg.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=np.random.default_rng(seed).uniform(0.5, 2.0, mesh.num_edges))
    return asm


def _system(graph, device="cpu"):
    """``(executor, plan, w, diag, rhs)`` of the port's CG executor on
    ``graph``, the λ system from the plain versions."""
    asm = _assembler(P, graph, seed=3)
    ex = PS.build_schur_executor(asm, P.SolverOptions(schur_method="cg"), device=device)
    assert isinstance(ex, PS._CgExecutor) and ex.gather_plan is not None
    dlp = ex.device_plan
    R, f, sp, ep = ex.upload(*ex.prepare_args(*asm.schur_arguments()))
    Rm, fm, f_zero = asm.coefficient_modes()
    ed = edge_data.edge_data_plain(dlp, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi, R, f, Rm, fm,
                                   f_zero, sp, ep)
    dr, w, _ = peel.lambda_system_plain(dlp, ed)
    return ex, ex.gather_plan, w, dr[:, 0].contiguous(), dr[:, 1].contiguous()


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and torch.equal(a, b), (a.shape, b.shape)


WEB = _web(300, 0.3, 11)


def test_plan_refuses_bad_tables():
    _, plan, w, _, _ = _system(WEB)
    e, j = plan.mv_edge.clone(), plan.mv_other.clone()
    E = w.shape[0]
    GM.GatherPlan(e, j, E)
    bad = {
        "int64": (e.long(), j),
        "shape": (e[:, 1:].contiguous(), j),
        "edge range": (torch.where(e >= 0, E, e).to(torch.int32), j),
        "row range": (e, torch.where(j >= 0, j.shape[1], j).to(torch.int32)),
        "one table": (e, torch.where(e >= 0, j, 0).to(torch.int32)),
    }
    row = int(np.argmax((e[1] >= 0).numpy()))  # a row of two entries or more
    ep, jp = e.clone(), j.clone()
    ep[0, row], jp[0, row] = -1, -1  # its second entry now past its first -1
    bad["past -1"] = (ep, jp)
    for a, b in bad.values():
        with pytest.raises(ValueError, match="GatherPlan"):
            GM.GatherPlan(a, b, E)
    with pytest.raises(ValueError, match="GatherPlan"):
        GM.GatherPlan(e.to("meta"), j.to("meta"), E)


def test_cpu_wrappers_equal_the_direct_plain_versions():
    """The value table's matvec, residual and step equal the direct forms
    (``−w`` gathered through the edge table) to the bit."""
    _, plan, w, diag, rhs = _system(WEB)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(diag.shape[0]))
    vals = GM.gather_values(plan, w)
    tables = (plan.mv_edge, plan.mv_other)
    _equal(GM.gather_matvec(plan, vals, diag, x), GM.gather_matvec_plain(*tables, w, diag, x))
    _equal(GM.gather_matvec(plan, vals, diag, x, rhs, norm=True),
           GM.gather_matvec_plain(*tables, w, diag, x, rhs, norm=True))
    op, ref = PM.GatherOperator(plan, w, diag), PM.GatherOperator(plan, w, diag, plain=True)
    _equal(op.apply(x), ref.apply(x))
    _equal(op.residual(rhs, x, norm=True), ref.residual(rhs, x, norm=True))


@pytest.mark.parametrize("degree", [1, 2, 8])
@pytest.mark.parametrize("with_base", [False, True])
def test_plain_fused_apply_equals_composed_steps(degree, with_base):
    """``cheb_apply_plain`` (the start with an elementwise division, then
    the steps) is the composed plain application to the bit."""
    _, plan, w, diag, rhs = _system(WEB)
    base = torch.as_tensor(np.random.default_rng(2).standard_normal(diag.shape[0])) if with_base else None
    op = PM.GatherOperator(plan, w, diag, plain=True)
    want = PK.chebyshev_preconditioner(op.step, diag, degree=degree, plain=True)(rhs, base=base)
    theta, coeffs = PK.chebyshev_coefficients(degree)
    s = 1.0 / torch.sqrt(diag)
    got = GM.cheb_apply_plain(plan.mv_edge, plan.mv_other, w, diag, s, rhs, theta, coeffs, base=base)
    _equal(got, want)


@pytest.mark.parametrize("degree", [1, 2, 8])
def test_executor_chebyshev_is_one_application(degree):
    """The executor's preconditioner: a ``ChebApply`` (its plain version on
    the CPU) equal to the composed plain steps to the bit; ``plain`` gives
    the composed plain steps themselves."""
    ex, plan, w, diag, rhs = _system(WEB)
    ex.precond_kind = ("chebyshev", degree)
    base = torch.as_tensor(np.random.default_rng(3).standard_normal(diag.shape[0]))
    op, ref = PM.GatherOperator(plan, w, diag), PM.GatherOperator(plan, w, diag, plain=True)
    apply = ex._preconditioner(op, None, False)
    assert isinstance(apply, GM.ChebApply)
    composed = ex._preconditioner(ref, None, True)
    assert not isinstance(composed, GM.ChebApply)
    want = PK.chebyshev_preconditioner(ref.step, diag, degree=degree, plain=True)(rhs, base=base)
    _equal(apply(rhs, base=base), want)
    _equal(composed(rhs, base=base), want)
    out = torch.empty_like(rhs)
    assert apply(rhs, out=out) is out
    _equal(out, PK.chebyshev_preconditioner(ref.step, diag, degree=degree, plain=True)(rhs))


def test_operator_products_are_new_vectors():
    """``apply`` and ``residual`` give a new vector each call, as ``cg`` and
    ``minres`` take them."""
    _, plan, w, diag, rhs = _system(WEB)
    op = PM.GatherOperator(plan, w, diag)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(diag.shape[0]))
    a, b = op.apply(x), op.apply(rhs)
    assert a.data_ptr() != b.data_ptr()
    _equal(a, op.apply(x))
    r1, _ = op.residual(rhs, x, norm=True)
    r2, _ = op.residual(rhs, rhs, norm=True)
    assert r1.data_ptr() != r2.data_ptr()


CG_WEBS = {"web300": (WEB, {}), "web500_deg3": (_web(500, 0.2, 4), dict(cheb_degree=3))}


@pytest.mark.parametrize("name", sorted(CG_WEBS))
def test_cg_solve_on_a_web_matches_reference(name):
    graph, opts = CG_WEBS[name]
    xs, iters = [], []
    for pkg in (J, P):
        asm = _assembler(pkg, graph, seed=5)
        kw = {"device": "cpu"} if pkg is P else {}
        s = pkg.Solver(asm, options=pkg.SolverOptions(schur_method="cg", **opts), **kw)
        s.solve()
        assert s.info.converged, s.info
        xs.append(np.asarray(s.solution_vector()))
        iters.append(s.info.iterations)
    ex = s._executor
    assert isinstance(ex, PS._CgExecutor) and ex.gather_plan is not None
    assert ex.precond_kind == ("chebyshev", opts.get("cheb_degree", 8))
    scale = max(1.0, float(np.abs(xs[0]).max()))
    np.testing.assert_allclose(xs[1], xs[0], rtol=0, atol=1e-9 * scale)
    assert abs(iters[1] - iters[0]) <= 1, iters


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_gather_plan_kernels_on_card():
    """The value table, the matvec and residual and ``ChebApply`` (one
    launch, a grid barrier between steps) equal their plain versions bit for
    bit, on two streams and as the operator makes it; the per-step form is
    refused on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    _, plan, w, diag, rhs = _system(_web(3000, 0.1, 9), dev)
    tables = (plan.mv_edge, plan.mv_other)
    x = torch.randn(diag.shape[0], dtype=torch.float64, device=dev)
    vals = GM.gather_values(plan, w)
    _equal(vals, GM.gather_values_plain(plan.mv_edge, w))
    _equal(GM.gather_matvec(plan, vals, diag, x), GM.gather_matvec_plain(*tables, w, diag, x))
    res, nrm = GM.gather_matvec(plan, vals, diag, x, rhs, norm=True)
    _equal(res, GM.gather_matvec_plain(*tables, w, diag, x, rhs))
    s = 1.0 / torch.sqrt(diag)
    kernel_op = PM.GatherOperator(plan, w, diag)
    with pytest.raises(ValueError, match="GatherOperator"):
        kernel_op.step(s, rhs, x.clone(), x, torch.empty_like(x), 0.5, 0.5)
    for degree in (1, 2, 8):
        theta, coeffs = PK.chebyshev_coefficients(degree)
        want = GM.cheb_apply_plain(*tables, w, diag, s, rhs, theta, coeffs, base=x)
        apply = GM.ChebApply(plan, vals, diag, s, theta, coeffs)
        launches = GM.LAUNCHES.device
        got = apply(rhs, base=x)
        assert GM.LAUNCHES.device - launches == 1
        _equal(got, want)
        streams = [torch.cuda.Stream(dev) for _ in range(2)]
        torch.cuda.synchronize(dev)
        outs = []
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(apply(rhs, base=x))
        torch.cuda.synchronize(dev)
        for o in outs:
            _equal(o, want)
        # as the executor makes it: the scaling made inside, held by the application alone
        fused = kernel_op.chebyshev(degree)
        assert isinstance(fused, GM.ChebApply)
        junk = torch.full((8 * diag.shape[0],), float("nan"), dtype=torch.float64, device=dev)
        s_k = krylov.inv_sqrt(diag)
        _equal(fused(rhs, base=x), GM.cheb_apply_plain(*tables, w, diag, s_k, rhs, theta, coeffs, base=x))
        del junk
    # a whole CG solve on the card against the CPU's
    xs = []
    for device in ("cuda", "cpu"):
        solver = P.Solver(_assembler(P, _web(3000, 0.1, 9), seed=3),
                          options=P.SolverOptions(schur_method="cg"), device=device)
        solver.solve()
        assert solver.info.converged, solver.info
        xs.append((np.asarray(solver.solution_vector()), solver.info.iterations))
    scale = max(1.0, float(np.abs(xs[1][0]).max()))
    np.testing.assert_allclose(xs[0][0], xs[1][0], rtol=0, atol=1e-9 * scale)
    assert abs(xs[0][1] - xs[1][1]) <= 1, (xs[0][1], xs[1][1])
