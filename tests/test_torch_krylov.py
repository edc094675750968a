"""The CG route of the PyTorch port against the JAX reference.

Mirrors ``tests/test_krylov.py`` against ``networks_fenicsx_tpu.ops.krylov``
and ``networks_fenicsx_tpu.solver``:

* host plans — ``_build_matvec_plan``, ``_plan_mg`` and ``_mg2d_feasible`` —
  ``np.array_equal`` to the reference's on the same grids;
* single applications of the plain versions — the gather-fold matvec
  (K19b), one Chebyshev-Jacobi application (K19a with K18), one 2-D (K19c)
  and one 1-D (K19d) V-cycle — at 1e-12·scale (scale = max(1, max |reference|);
  the 1-D cycle at 1e-10 for its coarsest chain's conditioning) on the
  reference's own λ systems;
* ``cg`` on the reference's seeded SPD systems: the same iterations within
  1 (2 on the dense n = 100 system, :func:`_iters_close`), x at 1e-12·scale
  (1e-11, κ·rtol, on the dense κ = 100 system);
* whole solves under ``schur_method="cg"`` against the JAX package at its
  own bar, 1e-9·scale (``test_krylov.py:94, 165``), iteration counts within
  1 (2 on the 400-iteration 3×2000 lattice), with every ``cg_precond`` and
  both matvecs.

The card tests (``pytest -m cuda``) hold each kernel against its plain
version on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu.ops import krylov as JK
from networks_fenicsx_tpu_torch import kernels
from networks_fenicsx_tpu_torch import lattice as PLat
from networks_fenicsx_tpu_torch import multigrid as PM
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch.kernels import gather_matvec, krylov, mg1d, mg2d, shift_matvec
from networks_fenicsx_tpu_torch.ops import krylov as PK

torch.set_num_threads(1)


def _close(got, want, tol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(a, dtype=torch.float64, device="cpu"):
    # a C-ordered copy: the kernels take contiguous tensors, and the gather
    # tables come transposed (column-major) from gather_matvec_tables
    return torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)


def _grid(nx, ny):
    return lambda pkg: pkg.network_generation.make_grid(nx, ny, arrays=True)


def _web2k(pkg):
    return pkg.network_generation.make_random_network(2000, keep=0.7, num_boundary=8, seed=5,
                                                      arrays=True)


def _bed4(pkg):
    return pkg.network_generation.make_vascular_bed(4, 32, 20, arrays=True)


def _assembler(pkg, graph, N=1, R="edge", seed=0, p_bc=lambda x: x[0]):
    mesh = pkg.NetworkMesh(graph(pkg), N=N, color_strategy="fast")
    asm = pkg.HydraulicNetworkAssembler(mesh)
    if R == "edge":
        R = np.random.default_rng(seed).uniform(0.5, 2.0, mesh.num_edges)
    elif R == "poiseuille":
        R = 1.0 / mesh.edge_radius**4
    asm.compute_forms(p_bc_ex=p_bc, R=R)
    return asm


def _reference_system(graph, seed=3):
    """The reference's λ system of ``graph`` (N = 2, per-edge R from a
    seed): ``(asm_p, diag, rhs, w_edges, class_w or None)`` as numpy."""
    aj = _assembler(J, graph, N=2, seed=seed)
    ap = _assembler(P, graph, N=2, seed=seed)
    R_mode, f_mode, _ = aj.coefficient_modes()
    ed = JS._make_edge_data_uniform(aj, *aj.schur_arguments(), R_mode, f_mode)
    B = aj.network.num_multipliers
    diag, rhs = JS._lambda_system_sorted(ed, B, JS._build_lambda_plan(aj))
    classes = JS._plan_shift_matvec(aj)
    class_w = None if classes is None else JS._shift_class_weights(ed, classes, B)
    return aj, ap, ed, np.asarray(diag), np.asarray(rhs), classes, class_w


# ------------------------------------------------------------ host plans

PLAN_GRIDS = {"9x7": (9, 7), "24x24": (24, 24), "33x17": (33, 17), "70x70": (70, 70),
              "3x2000": (3, 2000)}


@pytest.mark.parametrize("name", sorted(PLAN_GRIDS))
def test_host_plans_equal_reference(name):
    nx, ny = PLAN_GRIDS[name]
    aj = _assembler(J, _grid(nx, ny), R=1.0)
    ap = _assembler(P, _grid(nx, ny), R=1.0)
    for a, b in zip(PLat._build_matvec_plan(ap), JS._build_matvec_plan(aj)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    B = ap.network.num_multipliers
    deltas = [d for d, _, _ in PLat._plan_shift_matvec(ap)]
    assert PM._plan_mg(deltas, B) == JS._plan_mg(deltas, B)
    for stride in sorted({abs(d) for d in deltas}) + [nx, 2, 5]:
        assert PM._mg2d_feasible(B, stride) == JS._mg2d_feasible(B, stride), stride


def test_gather_tables_hold_the_fold_order():
    """Row i of the (K, B) tables lists its half-edges in the order of the
    sorted plan, padded with -1."""
    ap = _assembler(P, _web2k)
    plan = PLat._build_matvec_plan(ap)
    B = ap.network.num_multipliers
    edge_idx, other_idx = PLat.gather_matvec_tables(plan, B)
    edge_sel, other_sel, own = plan
    counts = np.bincount(own, minlength=B)
    assert edge_idx.shape == (counts.max(), B)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for i in (0, 7, B // 2, B - 1):
        h = np.arange(starts[i], starts[i + 1])
        assert np.array_equal(edge_idx[: h.size, i], edge_sel[h])
        assert np.array_equal(other_idx[: h.size, i], other_sel[h])
        assert np.all(edge_idx[h.size:, i] == -1) and np.all(other_idx[h.size:, i] == -1)


# ---------------------------------------------------- single applications


def test_gather_matvec_matches_reference_and_shift_matvec():
    """``test_krylov.py:98``: on the 9×7 lattice the gather-fold matvec
    equals the reference's ``_matvec_from_plan`` and K18's shift matvec."""
    aj, ap, ed, diag, rhs, classes, class_w = _reference_system(_grid(9, 7))
    B = ap.network.num_multipliers
    lam = np.random.default_rng(3).standard_normal(B)
    want = JS._matvec_from_plan(ed, jnp.asarray(diag), JS._build_matvec_plan(aj), B)(jnp.asarray(lam))
    tables = [_t(a, torch.int32) for a in PLat.gather_matvec_tables(PLat._build_matvec_plan(ap), B)]
    w = _t(1.0 / np.asarray(ed.W))
    plan = gather_matvec.GatherPlan(*tables, w.shape[0])
    vals = gather_matvec.gather_values(plan, w)
    got = gather_matvec.gather_matvec(plan, vals, _t(diag), _t(lam))
    _close(got, want, 1e-12)
    offsets = np.asarray([d for d, _, _ in classes], np.int32)
    cw = _t(np.stack([np.asarray(v) for _, v in class_w]))
    _close(shift_matvec.shift_matvec(shift_matvec.ShiftPlan(offsets, B, "cpu"), cw, _t(diag), _t(lam)),
           got, 1e-12)
    res, norm = gather_matvec.gather_matvec(plan, vals, _t(diag), _t(lam), _t(rhs), norm=True)
    _close(res, rhs - np.asarray(want), 1e-12)
    _close(norm, np.linalg.norm(rhs - np.asarray(want)), 1e-12)


@pytest.mark.parametrize("graph,matvec", [("24x24", "shift"), ("web2k", "gather")])
def test_chebyshev_application_matches_reference(graph, matvec):
    """One Chebyshev-Jacobi application (degree 8, ratio 30) on the
    reference's λ system: the shift-class matvec on a 24² lattice, the
    gather-fold matvec on web2k."""
    g = _grid(24, 24) if graph == "24x24" else _web2k
    aj, ap, ed, diag, rhs, classes, class_w = _reference_system(g)
    B = ap.network.num_multipliers
    if matvec == "shift":
        mv = JS._matvec_from_shift_plan(ed, jnp.asarray(diag), classes, B)
        offsets = np.asarray([d for d, _, _ in classes], np.int32)
        op = PM.ShiftOperator(shift_matvec.ShiftPlan(offsets, B, "cpu"),
                              _t(np.stack([np.asarray(v) for _, v in class_w])), _t(diag))
    else:
        assert classes is None
        mv = JS._matvec_from_plan(ed, jnp.asarray(diag), JS._build_matvec_plan(aj), B)
        tables = [_t(a, torch.int32) for a in
                  PLat.gather_matvec_tables(PLat._build_matvec_plan(ap), B)]
        w = _t(1.0 / np.asarray(ed.W))
        op = PM.GatherOperator(gather_matvec.GatherPlan(*tables, w.shape[0]), w, _t(diag))
    want = JK.chebyshev_preconditioner(mv, jnp.asarray(diag), degree=8)(jnp.asarray(rhs))
    got = PK.chebyshev_preconditioner(op.step, op.diag, degree=8)(_t(rhs))
    _close(got, want, 1e-12)


def _vcycle_inputs(nx, ny, seed):
    aj, ap, ed, diag, rhs, classes, class_w = _reference_system(_grid(nx, ny), seed=seed)
    offsets = np.asarray([d for d, _, _ in classes], np.int32)
    cw = np.stack([np.asarray(v) for _, v in class_w])
    r = np.random.default_rng(seed).standard_normal(diag.size)
    return classes, class_w, offsets, cw, diag, r


@pytest.mark.parametrize("dims", [(24, 24), (33, 17)])
def test_mg2d_vcycle_matches_reference(dims):
    """One 2-D V-cycle application against ``_mg2d_preconditioner`` on the
    same class weights (33×17: odd sides, even padding at every level)."""
    nx, ny = dims
    classes, class_w, offsets, cw, diag, r = _vcycle_inputs(nx, ny, seed=5)
    B = diag.size
    want = JS._mg2d_preconditioner(class_w, jnp.asarray(diag), B, nx, overcorrect=1.8)(jnp.asarray(r))
    plan = PM.mg2d_plan(offsets, B, nx)
    assert len(plan.shapes) >= 1
    got = PM.Mg2dPreconditioner(plan, _t(cw), _t(diag), 1.8)(_t(r))
    _close(got, want, 1e-12)


def test_mg1d_vcycle_matches_reference():
    """One 1-D V-cycle application against ``_mg_preconditioner`` on a 3×2000
    lattice's classes (4 levels, coarsest 375).  Held at 1e-10·scale, not
    1e-12: the coarsest system is a chain of condition ~4.5e6, on which two
    Cholesky solves (LAPACK's here, XLA's there) differ by up to κ·ε
    relative (8.4e-12 measured on the solve alone, 8.6e-12 on the cycle)."""
    classes, class_w, offsets, cw, diag, r = _vcycle_inputs(3, 2000, seed=4)
    B = diag.size
    plan_j = JS._plan_mg([d for d, _, _ in classes], B)
    assert (len(plan_j[0]), plan_j[1]) == (4, 375)
    want = JS._mg_preconditioner(plan_j, class_w, jnp.asarray(diag), B, overcorrect=1.8)(jnp.asarray(r))
    plan = PM.device_mg1d_plan(PM._plan_mg([d for d, _, _ in classes], B), "cpu")
    got = PM.Mg1dPreconditioner(plan, offsets, _t(cw), _t(diag), 1.8)(_t(r))
    _close(got, want, 1e-10)


# ------------------------------------------------------------------- cg


def _iters_close(got: int, want: int, slack: int = 1) -> None:
    """Iteration counts within ``slack`` of the reference's: 1, and 2 on the
    two runs named in :data:`LONG_RUNS`.

    Where CG runs long enough to lose orthogonality (≳ n/2 iterations on the
    dense systems, a few hundred on the 3×2000 lattice, whose coarsest solve
    also carries ~κ·ε ≈ 1e-9 of roundoff), ‖r‖ first crosses the tolerance
    at an iteration that moves with the summation order of the dot products
    and the matvec: 103 here and 105 there on the dense n = 100 system,
    400 / 401 / 402 on 3×2000 (reference / default threads / one thread),
    while ‖r‖ falls only 5–10 % an iteration near the end."""
    assert abs(got - want) <= slack, (got, want, slack)


# the runs whose observed gap to the reference is 2 iterations (see _iters_close)
LONG_RUNS = {"spd100": 2, "3x2000_mg": 2}


def _spd(n, seed=0, cond=100.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.geomspace(1.0, cond, n)
    return (Q * eig) @ Q.T


@pytest.mark.parametrize("n", [20, 100])
def test_cg_spd_matches_reference(n):
    """``test_krylov.py:18``: the same iterations; x at 1e-11·scale, κ·rtol:
    each run stops at ‖r‖ ≤ 1e-13·‖b‖ on a κ = 100 system, at iterations
    that differ on the longer run, so each x is that close to A⁻¹b."""
    A = _spd(n, seed=1)
    b = A @ np.linspace(-1, 1, n)
    want = JK.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), rtol=1e-13)
    At = _t(A)
    got = PK.cg(lambda v: At @ v, _t(b), rtol=1e-13)
    assert got.converged and bool(want.converged)
    _iters_close(got.iters, int(want.iters), LONG_RUNS.get(f"spd{n}", 1))
    _close(got.x, want.x, 1e-11)


def test_cg_jacobi_matches_reference_and_reduces_iterations():
    """``test_krylov.py:29``: Jacobi cuts the iterations; both runs take the
    reference's iterations, and the Jacobi run lands on its x at
    1e-12·scale (the unpreconditioned run on this κ ≈ 1e10 system stops
    with an x that only rtol bounds, as the reference's own test allows)."""
    n = 120
    D = np.diag(np.geomspace(1, 1e5, n))
    A = D @ _spd(n, seed=3, cond=10.0) @ D
    b = np.ones(n)
    diag = np.diagonal(A)
    At, dt = _t(A), _t(diag)
    runs = []
    for pre_j, pre_p in ((None, None), (lambda v: v / jnp.asarray(diag), lambda v: krylov.jacobi(v, dt))):
        want = JK.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), precond=pre_j, rtol=1e-10,
                     maxiter=5000)
        got = PK.cg(lambda v: At @ v, _t(b), precond=pre_p, rtol=1e-10, maxiter=5000)
        _iters_close(got.iters, int(want.iters))
        if pre_p is not None:
            _close(got.x, want.x, 1e-12)
        runs.append(got)
    assert runs[1].iters < runs[0].iters
    np.testing.assert_allclose(runs[1].x.numpy(), np.linalg.solve(A, b), atol=1e-5)


def test_cg_stops_by_the_per_iteration_rule():
    """The chunked loop stops where a flag read after every iteration would:
    the count does not depend on the chunk, and ``maxiter`` caps it."""
    A = _spd(60, seed=2, cond=1e3)
    b = _t(A @ np.ones(60))
    At = _t(A)
    counts = {c: PK.cg(lambda v: At @ v, b, rtol=1e-12, chunk=c).iters for c in (1, 3, 4, 7)}
    assert len(set(counts.values())) == 1, counts
    capped = PK.cg(lambda v: At @ v, b, rtol=1e-12, maxiter=5)
    assert capped.iters == 5 and not capped.converged


# -------------------------------------------------------- whole solves


def _solve_both(graph, opts, R="edge", seed=0, p_bc=lambda x: x[0], slack=1):
    xs, infos = [], []
    for pkg in (J, P):
        asm = _assembler(pkg, graph, R=R, seed=seed, p_bc=p_bc)
        kw = {"device": "cpu"} if pkg is P else {}
        s = pkg.Solver(asm, options=pkg.SolverOptions(**opts), **kw)
        s.solve()
        assert s.info.converged, s.info
        xs.append(np.asarray(s.solution_vector()))
        infos.append(s.info)
    scale = max(1.0, float(np.abs(xs[0]).max()))
    np.testing.assert_allclose(xs[1], xs[0], rtol=0, atol=1e-9 * scale)
    _iters_close(infos[1].iterations, infos[0].iterations, slack)
    return infos[1], s


CG_SOLVES = {
    "24x24_deg1": (_grid(24, 24), dict(cheb_degree=1), dict(R=1.0), "jacobi"),
    "24x24_deg8": (_grid(24, 24), dict(cheb_degree=8), dict(R=1.0), "chebyshev"),
    "24x24_jacobi": (_grid(24, 24), dict(cg_precond="jacobi"), {}, "jacobi"),
    "32x32_mg": (_grid(32, 32), dict(cg_precond="mg"), {}, "2d"),
    "64x64_mg": (_grid(64, 64), dict(cg_precond="mg"), {}, "2d"),
    "3x2000_mg": (_grid(3, 2000), dict(cg_precond="mg"), dict(seed=4, p_bc=lambda x: x[1]), "1d"),
    "web2k": (_web2k, {}, dict(seed=7), "chebyshev"),
    "bed4": (_bed4, {}, dict(R="poiseuille"), "chebyshev"),
}


@pytest.mark.parametrize("name", sorted(CG_SOLVES))
def test_cg_solve_matches_reference(name):
    graph, opts, kw, kind = CG_SOLVES[name]
    info, s = _solve_both(graph, dict(schur_method="cg", **opts), slack=LONG_RUNS.get(name, 1), **kw)
    ex = s._executor
    assert isinstance(ex, PS._CgExecutor) and ex.precond_kind[0] == kind
    assert (ex.device_plan.classes is None) == (name in ("web2k", "bed4"))
    assert info.method == "schur" and info.iterations > 0
    rhs_norm = float(ex(*ex.prepare_args(*s.assembler.schur_arguments()))[5])
    assert info.residual <= max(10 * 1e-12 * rhs_norm, 1e-9)  # the reference's gate


def test_chebyshev_cuts_iterations():
    """``test_krylov.py:70``: degree 8 takes under a third of Jacobi's iterations."""
    iters = {}
    for deg in (1, 8):
        asm = _assembler(P, _grid(24, 24), R=1.0)
        s = P.Solver(asm, options=P.SolverOptions(schur_method="cg", cheb_degree=deg), device="cpu")
        s.solve()
        iters[deg] = s.info.iterations
    assert iters[8] * 3 < iters[1], iters


def test_mg_on_a_web_is_a_value_error():
    asm = _assembler(P, _web2k, seed=7)
    s = P.Solver(asm, options=P.SolverOptions(schur_method="cg", cg_precond="mg"), device="cpu")
    with pytest.raises(ValueError, match="few-shift-class"):
        s.solve()


def test_mg_overcorrect_option_matters():
    """``test_krylov.py:249``: 1.0 (no over-correction) costs iterations at 64²."""
    iters = {}
    for oc in (1.8, 1.0):
        asm = _assembler(P, _grid(64, 64), seed=7)
        s = P.Solver(asm, options=P.SolverOptions(schur_method="cg", cg_precond="mg",
                                                  mg_overcorrect=oc), device="cpu")
        s.solve()
        assert s.info.converged
        iters[oc] = s.info.iterations
    assert iters[1.8] < iters[1.0], iters


def test_cg_never_takes_the_dct_solve():
    """An explicit ``"cg"`` on a scalar-R lattice stays CG (reference
    ``:3985-3996``), and reports its iterations."""
    asm = _assembler(P, _grid(9, 7), R=2.0)
    s = P.Solver(asm, options=P.SolverOptions(schur_method="cg"), device="cpu")
    s.solve()
    assert isinstance(s._executor, PS._CgExecutor) and s.info.iterations > 0


def test_error_if_not_converged_and_monitor(capsys):
    """``maxiter`` too small: the gate fails, ``error_if_not_converged``
    raises; with it off the solve returns and ``monitor`` prints."""
    asm = _assembler(P, _grid(24, 24))
    opts = dict(schur_method="cg", cg_precond="jacobi", maxiter=3)
    with pytest.raises(RuntimeError, match="did not converge"):
        P.Solver(asm, options=P.SolverOptions(**opts), device="cpu").solve()
    s = P.Solver(asm, options=P.SolverOptions(error_if_not_converged=False, monitor=True, **opts),
                 device="cpu")
    s.solve()
    assert not s.info.converged and s.info.iterations == 3
    assert "iters=3" in capsys.readouterr().out


# ---------------------------------------------------------------- wrappers


def test_iterative_wrappers_never_fall_back_off_the_cpu():
    """CPU tensors run the plain versions without counting a launch; any
    other device goes to the kernel path, which validates and raises."""
    kernels.reset_launches()
    B = 12
    one = _t(np.ones(B))
    plan = gather_matvec.GatherPlan(*(_t(np.full((1, B), -1), torch.int32),) * 2, B)
    gather_matvec.gather_matvec(plan, one[None], one, one)
    krylov.jacobi(one, one)
    level = mg1d.Level(np.array([1], np.int32), one[None], one, one)
    mg1d.residual_restrict(level, one, one)
    mg2d.stencil(torch.ones((len(mg2d.FIELDS), B), dtype=torch.float64), (3, 4), one, one)
    assert all(n == 0 for n in kernels.launches().values())
    meta = torch.ones(B, dtype=torch.float64, device="meta")
    for call in (
        lambda: gather_matvec.gather_matvec(plan, meta[None], meta, meta),
        lambda: krylov.jacobi(meta, meta),
        lambda: krylov.CgSteps(krylov.new_state("meta"), meta, meta, meta, meta),
        lambda: mg1d.residual_restrict(mg1d.Level(np.array([1], np.int32), meta[None], meta, meta),
                                       meta, meta),
        lambda: mg2d.stencil(meta.expand(len(mg2d.FIELDS), B), (3, 4), meta, meta),
        lambda: mg2d.coarse_solve(meta, meta),
        lambda: shift_matvec.shift_matvec(shift_matvec.ShiftPlan([1], B, "cpu"), meta[None], meta, meta),
        lambda: shift_matvec.shift_cheb(shift_matvec.ShiftPlan([1], B, "cpu"), meta[None], meta, meta,
                                        meta, meta, meta, meta.clone(), 1.0, 1.0),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(n == 0 for n in kernels.launches().values())


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_system(graph, dev, seed=3):
    aj, ap, ed, diag, rhs, classes, class_w = _reference_system(graph, seed=seed)
    B = ap.network.num_multipliers
    w = _t(1.0 / np.asarray(ed.W), device=dev)
    out = {"diag": _t(diag, device=dev), "rhs": _t(rhs, device=dev), "w": w, "B": B}
    if classes is not None:
        out["offsets"] = np.asarray([d for d, _, _ in classes], np.int32)
        out["cw"] = _t(np.stack([np.asarray(v) for _, v in class_w]), device=dev)
        out["classes"] = classes
    else:
        out["tables"] = [_t(a, torch.int32, dev) for a in
                         PLat.gather_matvec_tables(PLat._build_matvec_plan(ap), B)]
        out["plan"] = gather_matvec.GatherPlan(*out["tables"], w.shape[0])
    return out


@pytest.mark.cuda
def test_krylov_kernels_match_plain_on_card():
    """K19a: one CG step pair and one Chebyshev application on web2k's λ
    system, kernel against plain, at 1e-12·scale; whole CG loops take the
    same iterations."""
    dev = _card()
    sysd = _card_system(_web2k, dev)
    diag, rhs = sysd["diag"], sysd["rhs"]
    outs = []
    for plain in (False, True):
        op = PM.GatherOperator(sysd["plan"], sysd["w"], diag, plain)
        M = op.chebyshev(8)  # as the executor makes it: ChebApply, or the composed plain steps
        outs.append((M(rhs), PK.cg(op.apply, rhs, precond=M, plain=plain)))
    _close(outs[0][0], outs[1][0], 1e-12)
    assert abs(outs[0][1].iters - outs[1][1].iters) <= 1
    _close(outs[0][1].x, outs[1][1].x, 1e-9)
    n = rhs.shape[0]
    x0, p0 = torch.zeros_like(rhs), torch.randn(n, dtype=torch.float64, device=dev)
    states = []
    for plain in (False, True):  # the generic steps against the unfused plain ones
        st, part = krylov.new_state(dev), krylov.partials(n, dev)
        x, r, p = x0.clone(), rhs.clone(), p0.clone()
        (krylov.cg_start_plain if plain else krylov.cg_start)(st, rhs, r, p, part, 1e-12, 0.0, 100)
        if plain:
            krylov.cg_update_x_plain(st, p, diag * p, x, r, part)
            krylov.cg_update_p_plain(st, r, r / diag, p, part)
        else:
            steps = krylov.CgSteps(st, part, x, r, p)
            steps.step(diag * p)
            steps.direction(r / diag)
        states.append((st, x, r, p))
    for a, b in zip(*states):
        _close(a, b, 1e-12)


@pytest.mark.cuda
def test_gather_matvec_kernel_matches_plain_on_card():
    dev = _card()
    sysd = _card_system(_web2k, dev)
    x = torch.randn(sysd["B"], dtype=torch.float64, device=dev)
    args = (*sysd["tables"], sysd["w"], sysd["diag"], x)
    kargs = (sysd["plan"], gather_matvec.gather_values(sysd["plan"], sysd["w"]), sysd["diag"], x)
    _close(gather_matvec.gather_matvec(*kargs), gather_matvec.gather_matvec_plain(*args), 1e-12)
    for a, b in zip(gather_matvec.gather_matvec(*kargs, sysd["rhs"], norm=True),
                    gather_matvec.gather_matvec_plain(*args, sysd["rhs"], norm=True)):
        _close(a, b, 1e-12)


@pytest.mark.cuda
def test_mg2d_kernels_match_plain_on_card():
    """K19c: the hierarchy, the coarsest factor and one V-cycle at 33×17."""
    dev = _card()
    sysd = _card_system(_grid(33, 17), dev, seed=5)
    plan = PM.mg2d_plan(sysd["offsets"], sysd["B"], 33)
    r = torch.randn(sysd["B"], dtype=torch.float64, device=dev)
    got = PM.Mg2dPreconditioner(plan, sysd["cw"], sysd["diag"])
    want = PM.Mg2dPreconditioner(plan, sysd["cw"], sysd["diag"], plain=True)
    for a, b in zip(got.levels + [got.bottom], want.levels + [want.bottom]):
        _close(a, b, 1e-12)
    _close(torch.tril(got.factor), want.factor, 1e-12)
    _close(got(r), want(r), 1e-12)


@pytest.mark.cuda
def test_mg1d_kernels_match_plain_on_card():
    """K19d (with K18's level steps): one 1-D V-cycle on the 3×2000 lattice,
    at 1e-10·scale for the coarsest chain's conditioning (see
    ``test_mg1d_vcycle_matches_reference``)."""
    dev = _card()
    sysd = _card_system(_grid(3, 2000), dev, seed=4)
    plan = PM.device_mg1d_plan(PM._plan_mg(sysd["offsets"].tolist(), sysd["B"]), dev)
    r = torch.randn(sysd["B"], dtype=torch.float64, device=dev)
    got = PM.Mg1dPreconditioner(plan, sysd["offsets"], sysd["cw"], sysd["diag"])(r)
    want = PM.Mg1dPreconditioner(plan, sysd["offsets"], sysd["cw"], sysd["diag"], plain=True)(r)
    _close(got, want, 1e-10)
