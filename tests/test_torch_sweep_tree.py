"""Scenario sweeps on the tree route (``_TreeExecutor.scenarios``) and the
tree factorization's ``solve_batch``.

A cyclic bifurcation graph takes the tree route: K8a, the bifurcation
system, K9's peel rounds around the core, K8b.  With a dense core (≤ 512
nodes), a multifrontal core (``MFPlan``) or none, the port runs S scenarios
in the launches of one solve: K9's two channels over S
(``peel_scenarios``) around S core factors and solves (K13–K15 or K11 over
S, in chunks), or, with one R, K9's ``d`` channel and the core's factor once
and the ``r`` channel with the core's apply over S (``peel_apply_scenarios``);
the multifrontal refinement folds over S (``fold_apply_scenarios``).  A
min-degree core (K12a, K12b) keeps its rows.

Held here: the port's sweep against the JAX package's ``solve_sweep`` under
``schur_method="tree"`` on a small cyclic web (a dense core) at
1e-10·scale, for R, per-cell f, p_bc and R + p_bc batches at k = 1 and 2; a
forced multifrontal plan's ``scenarios`` against the reference's blocks
executor under ``jax.vmap`` at 1e-10·scale; each new plain scenario version
against its one-scenario plain version row by row (``torch.equal``); one
call of each scenario wrapper a sweep whatever S, a factor call a chunk past
the budget; ``TreeFactorization.solve_batch`` for dense, multifrontal and
peel-only plans against ``solve()`` bit for bit and against the reference's
``solve_batch``; the min-degree core on rows; the shape refusals.  Every
sweep row against ``Solver.solve()`` bit for bit is
``tests/test_torch_sweep.py::test_sweep_rows_equal_solve`` (route
``"tree"``).  The ``cuda``-marked test holds the scenario kernels on the card
against the one-scenario kernels bit for bit.  The JAX package is imported
only inside the tests that compare with it.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import batch as PB
from networks_fenicsx_tpu_torch import factorization as PF
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch import tree as PT
from networks_fenicsx_tpu_torch.kernels import (
    backsub, dense_core, edge_data, fold, mf_apply, mf_factor, peel, segsum,
)
from networks_fenicsx_tpu_torch.ops import multifrontal as PMF

torch.set_num_threads(1)

CPU = {"device": "cpu"}
TREE = {"schur_method": "tree"}
BATCHES = ["R", "f", "p_bc", "R+p_bc"]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = max(1.0, float(np.abs(want[ok]).max())) if ok.any() else 1.0
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol * scale)


def _graph(pkg, net):
    gen = pkg.network_generation
    if net in ("web", "mf"):  # 109 bifurcations, 5 peel rounds, a 96-node core: dense, or
        # forced onto the multifrontal engine
        return gen.make_random_network(150, keep=0.1, seed=3, arrays=True), 2
    return gen.make_random_network(60, keep=0.0, seed=2, arrays=True), 2  # a forest


def _assembler(pkg, net, k=1, seed=0):
    G, N = _graph(pkg, net)
    mesh = pkg.NetworkMesh(G, N=N)
    asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k)
    rng = np.random.default_rng(seed)
    R0 = rng.uniform(0.5, 2.0, mesh.num_edges)
    f0 = rng.uniform(-1.0, 1.0, mesh.num_cells)
    asm.compute_forms(p_bc_ex=lambda x: x[1] - 0.5 * x[0], R=R0, f=f0)
    return asm, R0, f0


def _batches(asm, R0, f0, batch, S, seed):
    rng = np.random.default_rng(seed)
    out = {}
    if "R" in batch:
        out["R"] = R0[None] * rng.uniform(0.5, 2.0, (S, 1))
    if "f" in batch:
        out["f"] = rng.uniform(-1.0, 1.0, (S, f0.size))
    if "p_bc" in batch:
        mesh = asm.network
        y = mesh.vertices[: mesh.num_graph_nodes][:, 1]
        out["p_bc_node_values"] = (y[None] * rng.uniform(-2.0, 2.0, (S, 1))
                                   + rng.uniform(-1.0, 1.0, (S, 1)))
    return out


def _executor(asm):
    return list(asm._sweep_cache.values())[-1][1]


def _mf_plan(asm, pkg_levels, pkg_mf, leaf=4, force_rounds=False):
    tp = pkg_levels._plan_tree_elimination(asm, force_rounds=force_rounds)
    return tp._replace(core_plan=pkg_mf.plan_multifrontal(np.asarray(tp.core_pairs), tp.core_size,
                                                          leaf=leaf))


# ------------------------------------------------------- against the JAX package


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("batch", BATCHES)
def test_tree_sweep_matches_jax(batch, k):
    """A small cyclic web under ``schur_method="tree"``: the port's tree
    route with its dense core over S against the reference's vmapped tree
    solve, at 1e-10·scale."""
    import networks_fenicsx_tpu as J

    aj, _, _ = _assembler(J, "web", k=k, seed=3)
    ap, R0, f0 = _assembler(P, "web", k=k, seed=3)
    batches = _batches(ap, R0, f0, batch, 3, seed=4)
    xj = np.asarray(J.solve_sweep(aj, options=J.SolverOptions(**TREE), **batches).x)
    xp = P.solve_sweep(ap, options=P.SolverOptions(**TREE), **CPU, **batches).x
    ex = _executor(ap)
    assert isinstance(ex, PS._TreeExecutor) and ex.has_scenario_axis
    assert 0 < ex.device_plan.core_size <= 512 and ex.device_plan.mf is None
    _close(xp, xj, 1e-10)


def _forced_args(asm, batch, S, seed):
    """The executor's compact arguments with ``batch`` batched ``(S, ...)``:
    R (per-edge), f (per-cell) or the boundary pressures at the boundary
    edge ends; ``in_axes`` as ``solve_sweep`` gives them."""
    R0, f0, sp0, ep0 = (np.asarray(a, dtype=np.float64) for a in asm.schur_arguments())
    rng = np.random.default_rng(seed)
    args = [R0, f0, sp0, ep0]
    if batch == "R":
        args[0] = R0[None] * rng.uniform(0.5, 2.0, (S, 1))
    elif batch == "f":
        args[1] = rng.uniform(-1.0, 1.0, (S,) + f0.shape)
    else:
        args[2] = sp0[None] * rng.uniform(-2.0, 2.0, (S, 1))
        args[3] = ep0[None] * rng.uniform(-2.0, 2.0, (S, 1))
    in_axes = (0 if batch == "R" else None, 0 if batch == "f" else None,
               0 if batch == "p_bc" else None, 0 if batch == "p_bc" else None)
    return args, in_axes


@pytest.mark.parametrize("batch", ["R", "f", "p_bc"])
def test_forced_multifrontal_scenarios_match_jax(batch):
    """A forced multifrontal plan (the 96-node core of a 150-site web, leaf
    4): the port's ``build_schur_executor(..., _tree_plan=)`` and its
    ``scenarios`` against the reference's blocks executor under ``jax.vmap``
    (its ``batch.py:198-202``), at 1e-10·scale; the rows are the port
    executor's calls bit for bit."""
    import jax

    import networks_fenicsx_tpu as J
    from networks_fenicsx_tpu import solver as JS
    from networks_fenicsx_tpu.ops import multifrontal as JMF

    aj, _, _ = _assembler(J, "mf", seed=7)
    ap, _, _ = _assembler(P, "mf", seed=7)
    exj = JS.build_schur_executor(aj, J.SolverOptions(**TREE), jit=False, elide_zero_f=False,
                                  outputs="blocks", internal_layout=True,
                                  _tree_plan=_mf_plan(aj, JS, JMF))
    exp = PS.build_schur_executor(ap, P.SolverOptions(**TREE), device="cpu", elide_zero_f=False,
                                  _tree_plan=_mf_plan(ap, PL, PMF))
    assert exp.device_plan.mf is not None and exp.has_scenario_axis
    args, in_axes = _forced_args(ap, batch, 3, seed=8)

    def one(Ra, fa, spa, epa):
        q_T, p_T, lam, *_ = exj(Ra, fa, spa, epa)
        return q_T, p_T, lam

    want = jax.vmap(one, in_axes=in_axes)(*args)
    got = PB._run_scenarios(exp, args, in_axes)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-10)
    rows = PB._run_rows(exp, args, in_axes)
    assert all(torch.equal(g, r) for g, r in zip(got, rows))


# ------------------------------------------------------- plain scenario versions


def _tree_case(net, S, seed, mf=False):
    """A tree executor (``mf``: the forced multifrontal plan) and S systems:
    ``dr (S, B, 2)`` and the pair conductances ``(S, P)`` of S R rows."""
    asm, _, _ = _assembler(P, net, seed=seed)
    plan = _mf_plan(asm, PL, PMF) if mf else None
    ex = PS.build_schur_executor(asm, P.SolverOptions(**TREE), device="cpu", elide_zero_f=False,
                                 _tree_plan=plan)
    R0, f0, sp0, ep0 = ex.upload(*asm.schur_arguments())
    rng = np.random.default_rng(seed + 1)
    R = R0[None] * torch.as_tensor(rng.uniform(0.5, 2.0, (S, 1)))
    f = torch.as_tensor(rng.uniform(-1.0, 1.0, (S,) + tuple(f0.shape)))
    dtp = ex.device_plan
    ed = edge_data.edge_data_scenarios(dtp, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi, R, f,
                                       ex._R_mode, ex._f_mode, ex._f_is_zero, sp0, ep0)
    dr, w = peel.bifurcation_system_scenarios(dtp, ed.W, ed.g, ed.cumF[:, -1], sp0, ep0)
    wp = segsum.segsum_plan_scenarios(dtp.pair_sums, w)[0]
    return ex, dtp, dr, wp


def _dense_core(dtp, wp):
    return lambda d, r: dense_core.dense_core_plain(dtp.core_ci, dtp.core_cj, dtp.core_pid, d, r,
                                                    wp)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("w_shared", [False, True])
def test_peel_scenario_plain_equals_rows(w_shared, S):
    """``peel_scenarios`` and ``peel_apply_scenarios`` (their plain versions
    on the CPU) row by row are ``peel_plain`` and ``peel_apply_plain`` of that
    row with the same core solve, ``torch.equal``; shared pair conductances
    are read as one row; the rhs-only pass on row 0's factor gives the
    two-channel pass's bits where the diagonals agree."""
    ex, dtp, dr, wp = _tree_case("web", S, seed=2 + S)
    assert dtp.core_size > 0 and len(dtp.rounds) > 0
    if w_shared:
        wp = wp[0]
        dr = torch.cat([dr[:1, :, :1].expand(S, -1, 1), dr[:, :, 1:]], dim=2).contiguous()
    row_w = (lambda i: wp) if w_shared else (lambda i: wp[i])

    def core(d, r):
        return torch.stack([_dense_core(dtp, row_w(i))(d[i], r[i]) for i in range(S)])

    lam = peel.peel_scenarios(dtp, dr, wp, core)
    assert torch.equal(lam, peel.peel_scenarios_plain(dtp, dr, wp, core))
    assert lam.shape == (S, dtp.num_bifurcations)
    pf = peel.peel_factor_plain(dtp, dr[0], row_w(0))
    Lc, s, C = dense_core.dense_factor_plain(dtp.core_ci, dtp.core_cj, dtp.core_pid, pf.dc, row_w(0))
    ok = dense_core.dense_gate_plain(C)

    def apply(r):
        return torch.stack([dense_core.dense_solve_plain(Lc, s, C, ok, r[i]) for i in range(S)])

    lam_a = peel.peel_apply_scenarios(dtp, pf, dr, apply)
    assert torch.equal(lam_a, peel.peel_apply_scenarios_plain(dtp, pf, dr, apply))
    for i in range(S):
        one = peel.peel_plain(dtp, dr[i], row_w(i), _dense_core(dtp, row_w(i)))
        assert torch.equal(lam[i], one), i
        one_a = peel.peel_apply_plain(dtp, pf, dr[i],
                                      lambda r: dense_core.dense_solve_plain(Lc, s, C, ok, r))
        assert torch.equal(lam_a[i], one_a), i
        if w_shared:  # one R: the rhs-only pass is the two-channel pass's bits
            assert torch.equal(lam_a[i], lam[i]), i


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("shared", [False, True])
def test_mf_scenario_plain_equals_rows(shared, S):
    """``mf_factor_scenarios`` and ``mf_apply_scenarios`` (plain on the CPU)
    row by row are ``mf_factor_plain`` and ``mf_apply_plain`` of that row,
    ``torch.equal`` on every field; with ``shared`` the applies run on one
    factor (read at stride 0) and a shared diagonal is read as one row."""
    ex, dtp, dr, wp = _tree_case("mf", S, seed=11 + S, mf=True)
    dmf = dtp.mf
    pfs = [peel.peel_factor_plain(dtp, dr[i], wp[i]) for i in range(S)]
    dc = torch.stack([p.dc for p in pfs])
    rc = torch.as_tensor(np.random.default_rng(S).uniform(-1.0, 1.0, dc.shape))
    if shared:
        state = mf_factor.mf_factor_plain(dmf, dc[0], wp[0])
        x = mf_apply.mf_apply_scenarios(dmf, state, rc)
        assert torch.equal(x, mf_apply.mf_apply_scenarios_plain(dmf, state, rc))
        for i in range(S):
            assert torch.equal(x[i], mf_apply.mf_apply_plain(dmf, state, rc[i])), i
        fac = mf_factor.mf_factor_scenarios(dmf, dc[0], wp)  # a shared diagonal, S pair rows
        for i in range(S):
            one = mf_factor.mf_factor_plain(dmf, dc[0], wp[i])
            assert all(torch.equal(a[i], b) for a, b in zip(fac, one)), i
        return
    fac = mf_factor.mf_factor_scenarios(dmf, dc, wp)
    plain = mf_factor.mf_factor_scenarios_plain(dmf, dc, wp)
    assert all(torch.equal(a, b) for a, b in zip(fac, plain))
    assert fac.fac.shape == (S, dmf.fac_len) and fac.ok.shape == (S,)
    x = mf_apply.mf_apply_scenarios(dmf, fac, rc)
    for i in range(S):
        one = mf_factor.mf_factor_plain(dmf, dc[i], wp[i])
        assert all(torch.equal(a[i], b) for a, b in zip(fac, one)), i
        assert torch.equal(x[i], mf_apply.mf_apply_plain(dmf, one, rc[i])), i


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("channels", [1, 2])
def test_fold_scenario_plain_equals_rows(channels, S):
    """``fold_apply_scenarios`` (plain on the CPU) row by row is
    ``fold_apply_plain`` of that row, ``torch.equal``, on the multifrontal
    refinement's folds and on the peel rounds' multi-level folds."""
    ex, dtp, dr, wp = _tree_case("mf", 1, seed=4, mf=True)
    plans = [dtp.mf.mv_fold_i, dtp.mf.mv_fold_j]
    plans += [rd.fold for rd in dtp.rounds if rd.fold]
    rng = np.random.default_rng(channels + S)
    for plan in plans:
        n = int(plan.src_max) + 1
        shape = (S, n) if channels == 1 else (S, n, channels)
        vec = torch.as_tensor(rng.uniform(-1.0, 1.0, shape))
        out = fold.fold_apply_scenarios(vec, plan)
        assert torch.equal(out, fold.fold_apply_scenarios_plain(vec, plan))
        assert out.shape == (S, plan.rows) + tuple(shape[2:])
        for i in range(S):
            assert torch.equal(out[i], fold.fold_apply_plain(vec[i], plan)), i


def test_tree_scenario_shapes_raise():
    ex, dtp, dr, wp = _tree_case("mf", 3, seed=1, mf=True)
    core = lambda d, r: r  # noqa: E731
    with pytest.raises(ValueError, match="\\(S, B, 2\\)"):
        peel.peel_scenarios(dtp, dr[0], wp[0], core)
    with pytest.raises(ValueError, match="scenarios"):
        peel.peel_scenarios(dtp, dr, wp[:2], core)
    pf = peel.peel_factor_plain(dtp, dr[0], wp[0])
    with pytest.raises(ValueError, match="\\(S, B, 2\\)"):
        peel.peel_apply_scenarios(dtp, pf, dr[:, :, :1], lambda r: r)
    dmf = dtp.mf
    dc = torch.ones((3, dmf.plan.n_core), dtype=torch.float64)
    with pytest.raises(ValueError, match="scenarios"):
        mf_factor.mf_factor_scenarios(dmf, dc, wp[:2])
    with pytest.raises(ValueError, match="expected"):
        mf_factor.mf_factor_scenarios(dmf, dc[:, :-1], wp)
    state = mf_factor.mf_factor_plain(dmf, pf.dc, wp[0])
    with pytest.raises(ValueError, match="rc must be"):
        mf_apply.mf_apply_scenarios(dmf, state, dc[0])
    batched = mf_factor.mf_factor_scenarios(dmf, dc, wp)
    with pytest.raises(ValueError, match="one factor of this plan or S"):
        mf_apply.mf_apply_scenarios(dmf, batched, dc[:2])
    with pytest.raises(ValueError, match="\\(S, n\\)"):
        fold.fold_apply_scenarios(dc[0], dmf.mv_fold_i)


# ------------------------------------------------------- wrapper calls and chunks


def _count_calls(monkeypatch):
    names = {edge_data: ("edge_data_scenarios", "edge_data"),
             peel: ("bifurcation_system_scenarios", "lambda_system", "peel_scenarios", "peel",
                    "peel_factor", "peel_apply_scenarios", "peel_apply"),
             segsum: ("segsum_plan_scenarios", "segsum_plan"),
             mf_factor: ("mf_factor_scenarios", "mf_factor"),
             mf_apply: ("mf_apply_scenarios", "mf_apply"),
             dense_core: ("dense_factor_scenarios", "dense_gate_scenarios",
                          "dense_solve_scenarios", "dense_factor", "dense_gate", "dense_core"),
             backsub: ("backsub_scenarios", "backsub")}
    calls = {}
    for mod, fns in names.items():
        for name in fns:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, name, counted)
    return calls


COMMON = {"edge_data_scenarios": 1, "bifurcation_system_scenarios": 1, "backsub_scenarios": 1}
WANT_CALLS = {
    ("dense", "R"): {"segsum_plan_scenarios": 1, "peel_scenarios": 1, "dense_factor_scenarios": 1,
                     "dense_gate_scenarios": 1, "dense_solve_scenarios": 1},
    ("dense", "f"): {"segsum_plan": 1, "peel_factor": 1, "dense_factor": 1, "dense_gate": 1,
                     "peel_apply_scenarios": 1, "dense_solve_scenarios": 1},
    ("mf", "R"): {"segsum_plan_scenarios": 1, "peel_scenarios": 1, "mf_factor_scenarios": 1,
                  "mf_apply_scenarios": 1},
    ("mf", "f"): {"segsum_plan": 1, "peel_factor": 1, "mf_factor": 1, "peel_apply_scenarios": 1,
                  "mf_apply_scenarios": 1},
}


@pytest.mark.parametrize("S", [1, 4, 9])
@pytest.mark.parametrize("core", ["dense", "mf"])
def test_tree_sweep_launches_independent_of_S(monkeypatch, core, S):
    """A tree sweep calls each scenario wrapper once whatever S: with an R
    batch K9's two channels and the core's factor and solve over S, with one
    R (an f or p_bc batch) K9's ``d`` channel and the core's factor once and
    the applies over S; no one-scenario solve.  The core's kernel launches a
    call are the plan's alone (``tree.cuda_launches``)."""
    asm, R0, f0 = _assembler(P, "web" if core == "dense" else "mf", seed=S)
    plan = _mf_plan(asm, PL, PMF) if core == "mf" else None
    ex = PS.build_schur_executor(asm, P.SolverOptions(**TREE), device="cpu", elide_zero_f=False,
                                 _tree_plan=plan)
    calls = _count_calls(monkeypatch)
    for batch in ("R", "f", "p_bc"):
        args, in_axes = _forced_args(asm, batch, S, seed=S)
        calls.clear()
        PB._run_scenarios(ex, args, in_axes)
        want = {**COMMON, **WANT_CALLS[(core, "R" if batch == "R" else "f")]}
        assert calls == want, (core, batch, calls)
    dtp = ex.device_plan
    assert PT.cuda_launches(dtp) > 0 and PT.has_scenario_axis(dtp)


@pytest.mark.parametrize("core", ["dense", "mf"])
def test_tree_sweep_chunks(monkeypatch, core):
    """An R batch past the budget runs a core factor call a chunk and gives
    the one-chunk sweep's bits; the chunk is what the budget holds."""
    asm, _, _ = _assembler(P, "web" if core == "dense" else "mf", seed=6)
    plan = _mf_plan(asm, PL, PMF) if core == "mf" else None
    ex = PS.build_schur_executor(asm, P.SolverOptions(**TREE), device="cpu", elide_zero_f=False,
                                 _tree_plan=plan)
    args, in_axes = _forced_args(asm, "R", 5, seed=7)
    whole = PB._run_scenarios(ex, args, in_axes)
    dtp = ex.device_plan
    if core == "mf":
        dmf = dtp.mf
        per = 8 * (dmf.fac_len + dmf.pool_len + dmf.vpool_len)
        assert mf_factor.scenario_chunk(dmf) == min(mf_factor.MAX_SCENARIOS, (2 << 30) // per)
        ex.scenario_budget = 2 * per
    else:
        n = dtp.core_size
        ex.scenario_budget = 2 * 16 * n * n
    assert PT.core_chunk(dtp, True, ex.scenario_budget) == 2
    calls = _count_calls(monkeypatch)
    chunked = PB._run_scenarios(ex, args, in_axes)
    assert all(torch.equal(a, b) for a, b in zip(chunked, whole))
    factor = "mf_factor_scenarios" if core == "mf" else "dense_factor_scenarios"
    assert calls[factor] == 3 and calls["peel_scenarios"] == 1


# ------------------------------------------------------- the tree factorization


def _factorizations(case, jax_too=True):
    """Both packages' tree factorizations of one network: ``dense`` a web's
    dense core, ``mf`` the forced multifrontal plan, ``peel`` a forest's
    forced rounds (no core)."""
    import networks_fenicsx_tpu as J
    from networks_fenicsx_tpu import solver as JS
    from networks_fenicsx_tpu.ops import multifrontal as JMF

    net = {"dense": "web", "mf": "mf", "peel": "forest"}[case]
    aj, _, _ = _assembler(J, net, k=2, seed=5)
    ap, R0, f0 = _assembler(P, net, k=2, seed=5)
    kw_j = {"_tree_plan": _mf_plan(aj, JS, JMF, force_rounds=True)} if case == "mf" else {}
    kw_p = {"_tree_plan": _mf_plan(ap, PL, PMF, force_rounds=True)} if case == "mf" else {}
    fj = JS.build_tree_factorization(aj, **kw_j) if jax_too else None
    fp = PF.build_tree_factorization(ap, **CPU, **kw_p)
    return fj, fp, ap, R0, f0


@pytest.mark.parametrize("case", ["dense", "mf", "peel"])
def test_tree_factorization_solve_batch(case):
    """``TreeFactorization.solve_batch`` of 3 right-hand sides: one call of
    each scenario wrapper, every row ``solve()`` of that row bit for bit, and
    the blocks against the reference's ``solve_batch`` (1e-12·scale without a
    core, 1e-10·scale with one)."""
    fj, fp, ap, R0, f0 = _factorizations(case)
    dtp = fp.device_tree_plan
    assert (dtp.core_size == 0) == (case == "peel")
    assert (dtp.mf is not None) == (case == "mf") and dtp.ce is None
    st = fp.factor(R0)
    base = [np.asarray(a) for a in ap.schur_arguments()]
    rng = np.random.default_rng(9)
    fb = rng.uniform(-1.0, 1.0, (3,) + base[1].shape)
    spb = base[2][None] * rng.uniform(-2.0, 2.0, (3, 1))
    epb = base[3][None] * rng.uniform(-2.0, 2.0, (3, 1))
    out = fp.solve_batch(st, fb, spb, epb)
    assert out[2].shape == (3, dtp.num_bifurcations) and out[3].shape == (3,)
    for i in range(3):
        one = fp.solve(st, fb[i], spb[i], epb[i])
        assert all(torch.equal(a[i], b) for a, b in zip(out, one)), (case, i)
    oj = fj.solve_batch(fj.factor(R0), fb, spb, epb)
    tol = 1e-12 if case == "peel" else 1e-10
    for g, w in zip(out[:3], oj[:3]):
        _close(g.numpy(), np.asarray(w), tol)


def test_tree_factorization_solve_batch_wrapper_calls(monkeypatch):
    """A multifrontal ``solve_batch`` calls K9's and K15's scenario wrappers
    once, and no one-scenario apply."""
    _, fp, ap, R0, f0 = _factorizations("mf", jax_too=False)
    st = fp.factor(R0)
    base = [np.asarray(a) for a in ap.schur_arguments()]
    calls = _count_calls(monkeypatch)
    fp.solve_batch(st, np.stack([base[1]] * 4), np.stack([base[2]] * 4), np.stack([base[3]] * 4))
    assert calls == {"bifurcation_system_scenarios": 1, "peel_apply_scenarios": 1,
                     "mf_apply_scenarios": 1}, calls


def test_min_degree_core_keeps_rows():
    """A min-degree core (forced rounds on the web's core) has no scenario
    axis: the executor says so and refuses ``scenarios``, a sweep runs its
    rows (``batch._run_rows``), bit for bit the executor's calls, and the
    factorization's ``solve_batch`` is its rows' ``solve()``."""
    asm, R0, f0 = _assembler(P, "mf", seed=3)
    plan = PL.attach_core_plan(PL._plan_tree_elimination(asm), dense_cutoff=4, tail_stop=False)
    assert type(plan.core_plan).__name__ == "CoreElimPlan"
    ex = PS.build_schur_executor(asm, P.SolverOptions(**TREE), device="cpu", elide_zero_f=False,
                                 _tree_plan=plan)
    assert ex.device_plan.ce is not None and not ex.has_scenario_axis
    assert not PT.has_scenario_axis(ex.device_plan)
    args, in_axes = _forced_args(asm, "R", 2, seed=1)
    with pytest.raises(ValueError, match="min-degree"):
        ex.scenarios(*ex.upload(*args))
    rows = PB._run_rows(ex, args, in_axes)
    for i in range(2):
        one = ex(args[0][i], *args[1:])
        assert all(torch.equal(r[i], o) for r, o in zip(rows, one[:3])), i
    fplan = PL.attach_core_plan(PL._plan_tree_elimination(asm, force_rounds=True), dense_cutoff=4,
                                tail_stop=False)
    fp = PF.build_tree_factorization(asm, **CPU, _tree_plan=fplan)
    assert fp.device_tree_plan.ce is not None
    st = fp.factor(R0)
    base = [np.asarray(a) for a in asm.schur_arguments()]
    fb = np.random.default_rng(2).uniform(-1.0, 1.0, (2,) + base[1].shape)
    out = fp.solve_batch(st, fb, np.stack([base[2]] * 2), np.stack([base[3]] * 2))
    for i in range(2):
        one = fp.solve(st, fb[i], base[2], base[3])
        assert all(torch.equal(a[i], b) for a, b in zip(out, one)), i


# ------------------------------------------------------- on the card


@pytest.mark.cuda
def test_tree_scenario_kernels_on_card(monkeypatch):
    """On a CUDA device: K9 over S (both channels; the ``r`` channel on one
    factor) against the one-scenario kernels row by row, with rounds of a
    grid launch (``peel.CUT`` patched to 16) and of block runs; K10 over S
    against ``fold_apply``; K13–K14 over S against ``mf_factor`` on every
    field, also with every front on the cluster kernel (``WIDE_M`` 0); K15
    over S on S factors and on one against ``mf_apply``; a row whose diagonal
    trips the multifrontal gate NaN alone; each against its plain version; a
    sweep's rows and ``solve_batch``'s rows against ``solve()`` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from networks_fenicsx_tpu_torch.ops import multifrontal as OMF

    dev = torch.device("cuda", 0)
    S = 5

    def same(a, b):
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])

    def close(a, b, tol):
        a, b = a.cpu(), b.cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        m = ~torch.isnan(b)
        if m.any():
            scale = max(1.0, float(b[m].abs().max()))
            assert float((a[m] - b[m]).abs().max()) <= tol * scale

    for cut, wide_m in ((peel.CUT, OMF.WIDE_M), (16, 0)):
        monkeypatch.setattr(peel, "CUT", cut)
        monkeypatch.setattr(OMF, "WIDE_M", wide_m)
        asm, _, _ = _assembler(P, "mf", seed=3)
        ex = PS.build_schur_executor(asm, P.SolverOptions(**TREE), device=dev, elide_zero_f=False,
                                     _tree_plan=_mf_plan(asm, PL, PMF))
        dtp, dmf = ex.device_plan, ex.device_plan.mf
        R0, f0, sp0, ep0 = ex.upload(*asm.schur_arguments())
        R = (R0[None] * torch.linspace(0.5, 2.0, S, dtype=torch.float64, device=dev)[:, None])
        ed = edge_data.edge_data_scenarios(dtp, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi,
                                           R.contiguous(), f0, ex._R_mode, ex._f_mode,
                                           ex._f_is_zero, sp0, ep0)
        dr, w = peel.bifurcation_system_scenarios(dtp, ed.W, ed.g, ed.cumF[:, -1], sp0, ep0)
        wp = segsum.segsum_plan_scenarios(dtp.pair_sums, w)[0]
        # K13–K14 over S, a row's diagonal negated to trip the gate
        pfs = [peel.peel_factor(dtp, dr[i], wp[i]) for i in range(S)]
        dc = torch.stack([p.dc for p in pfs])
        dc[2] = -dc[2]
        fac = mf_factor.mf_factor_scenarios(dmf, dc, wp)
        assert fac.ok.tolist() == [1, 1, 0, 1, 1]
        rc = torch.linspace(-1.0, 1.0, dc.numel(), dtype=torch.float64, device=dev).view(dc.shape)
        x = mf_apply.mf_apply_scenarios(dmf, fac, rc)
        x_sh = mf_apply.mf_apply_scenarios(dmf, mf_factor.mf_factor(dmf, dc[0], wp[0]), rc)
        assert torch.isnan(x[2]).all() and not torch.isnan(x[[0, 1, 3, 4]]).any()
        for i in range(S):
            one = mf_factor.mf_factor(dmf, dc[i], wp[i])
            assert all(same(a[i], b) for a, b in zip(fac[:4], one[:4])), i
            assert same(x[i], mf_apply.mf_apply(dmf, one, rc[i])), i
            assert same(x_sh[i], mf_apply.mf_apply(dmf, mf_factor.mf_factor(dmf, dc[0], wp[0]),
                                                   rc[i])), i
        cpu_dmf = PS.build_schur_executor(asm, P.SolverOptions(**TREE), device="cpu",
                                          elide_zero_f=False,
                                          _tree_plan=_mf_plan(asm, PL, PMF)).device_plan.mf
        plain = mf_apply.mf_apply_scenarios_plain(
            cpu_dmf, mf_factor.mf_factor_scenarios_plain(cpu_dmf, dc.cpu(), wp.cpu()), rc.cpu())
        close(x, plain, 1e-10)
        # K10 over S
        for plan in (dmf.mv_fold_i, dmf.mv_fold_j):
            vec = torch.linspace(-1.0, 1.0, S * (plan.src_max + 1), dtype=torch.float64,
                                 device=dev).view(S, -1)
            out = fold.fold_apply_scenarios(vec, plan)
            for i in range(S):
                assert torch.equal(out[i], fold.fold_apply(vec[i].contiguous(), plan)), i
        # K9 over S, both channels and the r channel on row 0's factor
        def core(d, r):
            return mf_apply.mf_apply_scenarios(dmf, mf_factor.mf_factor_scenarios(dmf, d, wp), r)

        lam = peel.peel_scenarios(dtp, dr, wp, core)
        pf = peel.peel_factor(dtp, dr[0], wp[0])
        st0 = mf_factor.mf_factor(dmf, pf.dc, wp[0])
        lam_a = peel.peel_apply_scenarios(dtp, pf, dr,
                                          lambda r: mf_apply.mf_apply_scenarios(dmf, st0, r))
        for i in range(S):
            one = peel.peel(dtp, dr[i], wp[i],
                            lambda d, r: mf_apply.mf_apply(dmf, mf_factor.mf_factor(dmf, d, wp[i]),
                                                           r))
            assert torch.equal(lam[i], one), (cut, i)
            one_a = peel.peel_apply(dtp, pf, dr[i], lambda r: mf_apply.mf_apply(dmf, st0, r))
            assert torch.equal(lam_a[i], one_a), (cut, i)
    # a sweep's rows and solve_batch's rows against solve() on the card
    monkeypatch.setattr(peel, "CUT", 1024)
    for net in ("web", "mf"):
        asm, R0, f0 = _assembler(P, net, seed=4)
        opts = P.SolverOptions(**TREE)
        Rb = R0[None] * np.linspace(0.5, 2.0, 4)[:, None]
        res = P.solve_sweep(asm, R=Rb, options=opts, device=dev)
        assert _executor(asm).has_scenario_axis
        for i in range(4):
            asm.compute_forms(p_bc_ex=lambda x: x[1] - 0.5 * x[0], R=Rb[i], f=f0)
            s = P.Solver(asm, options=opts, device=dev)
            s.solve()
            assert np.array_equal(s.solution_vector(), res.x[i]), (net, i)
    for case in ("dense", "mf", "peel"):
        net = {"dense": "web", "mf": "mf", "peel": "forest"}[case]
        asm, R0, f0 = _assembler(P, net, k=2, seed=5)
        kw = {"_tree_plan": _mf_plan(asm, PL, PMF, force_rounds=True)} if case == "mf" else {}
        fp = PF.build_tree_factorization(asm, device=dev, **kw)
        st = fp.factor(R0)
        base = [np.asarray(a) for a in asm.schur_arguments()]
        fb = np.random.default_rng(9).uniform(-1.0, 1.0, (S,) + base[1].shape)
        out = fp.solve_batch(st, fb, np.stack([base[2]] * S), np.stack([base[3]] * S))
        for i in range(S):
            one = fp.solve(st, fb[i], base[2], base[3])
            assert all(torch.equal(a[i], b) for a, b in zip(out, one)), (case, i)
