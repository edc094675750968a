"""Factor reuse of the PyTorch port against the JAX reference, on the CPU.

``Solver.factorize()`` and the three factorization classes
(``networks_fenicsx_tpu_torch/factorization.py``) run here on the kernels'
plain versions (``device="cpu"``); each factorized solve must equal the JAX
package's factorization of the same problem at 1e-12·scale on the blocked
and peel-only tree routes and at 1e-10·scale on the lattice and on cycle
cores (scale = max(1, max |reference|)).  Mirrored: the reuse and fallback,
kind change, O(1) staleness, in-place mutation, mutate-then-freeze,
read-only view, irregular forest and ``f_zero`` cases of
``tests/test_solver.py``, the factorization cases of ``test_blocked.py``,
``test_grid_blocked.py``, ``test_multifrontal.py`` and
``test_vascular_bed.py``, and the min-degree (``CoreElimPlan``) cases of
``test_core_elim.py`` (the 700-site web with its ``solve_batch``, the 26²
forced fronts) at 1e-10·scale of host LU; ``solve_batch`` rows equal
``solve()``'s bits.

The split kernels' plain versions are held against the reference
functions they replace: K2 and K3–K4 (``_blocked_forward_factor``,
``_blocked_forward_apply``, ``_blocked_backward``) and K9's channels
(``_tree_eliminate_factor``, ``_tree_eliminate_apply``) at 1e-12·scale;
K11's solve on a stored factor against ``scaled_cholesky_solve`` and K16's
passes on a stored factor against ``_dct_capacitance_apply`` at
1e-12·scale (or the lattice's conditioning floor 4·n²·ε where that is
larger).  Each split's plain versions in both orders equal the fused plain
versions by ``torch.equal``.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu.ops import core_elim as JCE
from networks_fenicsx_tpu.ops import mixed_precision as JMP
from networks_fenicsx_tpu_torch import blocked as PB
from networks_fenicsx_tpu_torch import factorization as PF
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch import tree as PT
from networks_fenicsx_tpu_torch.kernels import dct_lattice, dense_core, peel, tree_sweep
from networks_fenicsx_tpu_torch.ops import core_elim as PCE
from networks_fenicsx_tpu_torch.ops import multifrontal as PMF

from test_torch_blocked_subtree import TOPOLOGIES, _patched
from test_torch_cyclic import _core_system, _peel_problem
from test_torch_lattice import GRIDS, _lattice_system, _reference_system

torch.set_num_threads(1)

CPU = {"device": "cpu"}


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _tree(pkg, gens=4):
    return pkg.network_generation.make_tree(gens, 1.0, 2.0, arrays=True)


def _pair(graph, N=2, k=1, strategy="fast", **forms):
    """Both packages' assemblers of one graph with the same forms."""
    out = []
    for pkg in (J, P):
        mesh = pkg.NetworkMesh(graph(pkg), N=N, color_strategy=strategy)
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k)
        if forms:
            asm.compute_forms(**forms)
        out.append(asm)
    return out


def _solvers(aj, ap):
    return J.Solver(aj), P.Solver(ap, **CPU)


def _x(solver):
    return np.asarray(solver.solution_vector())


def _both(fn, aj, ap):
    """``fn(asm)`` on both assemblers (the same forms)."""
    fn(aj)
    fn(ap)


# ------------------------------------------------------------ Solver.factorize()


def test_factorize_reuse_and_fallback():
    """Rhs-only re-solves while R is unchanged (``schur_factorized``, the
    reference's factorized solve at 1e-12·scale), the fused path the moment
    R changes, the tree factorization on a per-edge-R lattice (1e-10·scale)
    and ``ValueError`` outside every envelope (tests/test_solver.py:508)."""
    rng = np.random.default_rng(21)
    aj, ap = _pair(lambda pkg: _tree(pkg, 5))
    E = ap.network.num_edges
    R = rng.uniform(0.5, 2.0, E)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], f=np.linspace(-1, 1, E), R=R), aj, ap)
    sj, sp = _solvers(aj, ap)
    sj.factorize()
    sp.factorize()
    assert isinstance(sp._factorization[0], PF.BlockedFactorization)
    for _ in range(2):
        f = rng.uniform(-1, 1, E)
        _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], f=f, R=R), aj, ap)
        sj.solve()
        sp.solve()
        assert sj.info.method == sp.info.method == "schur_factorized" and sp.info.converged
        _close(_x(sp), _x(sj), 1e-12)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], R=R * 1.5), aj, ap)
    sj.solve()
    sp.solve()
    assert sp.info.method == sj.info.method == "schur" and sp._factorization is None
    _close(_x(sp), _x(sj), 1e-12)

    aj, ap = _pair(lambda pkg: pkg.network_generation.make_grid(4, 3), N=1, strategy=None)
    Rc = rng.uniform(0.5, 2.0, ap.network.num_edges)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[0], f=0.2, R=Rc), aj, ap)
    sj, sp = _solvers(aj, ap)
    sj.factorize()
    sp.factorize()
    assert isinstance(sp._factorization[0], PF.TreeFactorization)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: 2.0 * x[0] + x[1], f=0.5, R=Rc), aj, ap)
    sj.solve()
    sp.solve()
    assert sp.info.method == "schur_factorized"
    _close(_x(sp), _x(sj), 1e-10)

    aq = P.HydraulicNetworkAssembler(ap.network)
    aq.compute_forms(p_bc_ex=lambda x: x[0], R=lambda x: 1.0 + 0.5 * x[0] ** 2)
    with pytest.raises(ValueError, match=r"factorize\(\) requires"):
        P.Solver(aq, **CPU).factorize()


def test_factorize_kind_change_falls_back():
    """A changed coefficient kind drops the factor (test_solver.py:576)."""
    rng = np.random.default_rng(6)
    aj, ap = _pair(_tree)
    E = ap.network.num_edges
    R = rng.uniform(0.5, 2.0, E)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], f=0.4, R=R), aj, ap)
    sj, sp = _solvers(aj, ap)
    sj.factorize()
    sp.factorize()
    f = rng.uniform(-1, 1, E)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], f=f, R=R), aj, ap)
    sj.solve()
    sp.solve()
    assert sp.info.method == sj.info.method == "schur"
    _close(_x(sp), _x(sj), 1e-12)


def test_factorize_staleness_check_is_o1(monkeypatch):
    """No hash on rhs-only solves or a same read-only R; one hash a
    ``compute_forms`` with a writeable R; the fallback on a changed R after
    one more (test_solver.py:602)."""
    rng = np.random.default_rng(33)
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(_tree(P), N=2, color_strategy="fast"))
    E = ap.network.num_edges
    R = rng.uniform(0.5, 2.0, E)
    R.setflags(write=False)
    ap.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=R)
    solver = P.Solver(ap, **CPU)
    solver.factorize()
    calls = {"n": 0}
    real_sha1 = hashlib.sha1

    def counting_sha1(*args, **kwargs):
        calls["n"] += 1
        return real_sha1(*args, **kwargs)

    monkeypatch.setattr(hashlib, "sha1", counting_sha1)
    for _ in range(3):
        solver.solve()
        assert solver.info.method == "schur_factorized"
    for _ in range(3):
        ap.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=R)
        solver.solve()
        assert solver.info.method == "schur_factorized"
    assert calls["n"] == 0
    Rw = np.array(R)
    for n in (1, 2):
        ap.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=Rw)
        solver.solve()
        assert solver.info.method == "schur_factorized" and calls["n"] == n
    solver.solve()
    assert solver.info.method == "schur_factorized" and calls["n"] == 2
    ap.compute_forms(p_bc_ex=lambda x: x[1], R=np.asarray(R) * 1.5)
    solver.solve()
    assert solver.info.method != "schur_factorized" and calls["n"] == 3


def _mutation_case(seed, prepare, mutate):
    """Factorize on R, mutate it as ``mutate`` says, re-run compute_forms:
    the factor must be dropped and the fused solve equal the reference's."""
    rng = np.random.default_rng(seed)
    aj, ap = _pair(_tree)
    base = rng.uniform(0.5, 2.0, ap.network.num_edges)
    Rs = [prepare(base.copy()) for _ in (aj, ap)]
    for a, R in zip((aj, ap), Rs):
        a.compute_forms(p_bc_ex=lambda x: x[1], R=R)
    sj, sp = _solvers(aj, ap)
    for s in (sj, sp):
        s.factorize()
        s.solve()
        assert s.info.method == "schur_factorized"
    for a, R in zip((aj, ap), Rs):
        mutate(R)
        a.compute_forms(p_bc_ex=lambda x: x[1], R=R)
    sj.solve()
    sp.solve()
    assert sp.info.method == sj.info.method == "schur"
    _close(_x(sp), _x(sj), 1e-12)


def _scale_base(R):
    (R.base if R.base is not None else R)[...] *= 3.0


def _freeze_after(R):
    R *= 3.0
    R.setflags(write=False)


def _view(R):
    v = R[:]
    v.setflags(write=False)
    return v


@pytest.mark.parametrize("case", ["inplace", "mutate-then-freeze", "readonly-view"])
def test_factorize_mutated_R_is_stale(case):
    """In-place mutation of the same R, a buffer mutated while writeable and
    frozen after, and a read-only view over a writeable base that is
    mutated (test_solver.py:661, 692, 724)."""
    seed, prepare, mutate = {
        "inplace": (7, lambda R: R, _scale_base),
        "mutate-then-freeze": (11, lambda R: R, _freeze_after),
        "readonly-view": (12, _view, _scale_base),
    }[case]
    _mutation_case(seed, prepare, mutate)


def test_factorize_irregular_forest():
    """A forest outside the blocked envelope: the tree factorization runs
    the forced peel rounds (not λ = 0), equal to the reference's
    factorization at 1e-12·scale (test_solver.py:753)."""
    rng = np.random.default_rng(11)
    graph = lambda pkg: pkg.network_generation.make_random_network(120, keep=0.0, seed=5)
    aj, ap = _pair(graph)
    E = ap.network.num_edges
    R, f = rng.uniform(0.5, 2.0, E), rng.uniform(-1, 1, E)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[0], f=f, R=R), aj, ap)
    sj, sp = _solvers(aj, ap)
    for s in (sj, sp):
        s.factorize()
        s.solve()
    assert sp.info.method == "schur_factorized"
    fac = sp._factorization[0]
    assert isinstance(fac, PF.TreeFactorization) and len(fac.device_tree_plan.rounds) > 1
    assert np.abs(_x(sj)).max() > 1e-6
    _close(_x(sp), _x(sj), 1e-12)


def test_factorize_survives_f_zero_flip():
    """f between zero and nonzero keeps the factor (test_solver.py:785)."""
    rng = np.random.default_rng(2)
    aj, ap = _pair(_tree)
    R = rng.uniform(0.5, 2.0, ap.network.num_edges)
    R.setflags(write=False)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], R=R), aj, ap)
    sj, sp = _solvers(aj, ap)
    sj.factorize()
    sp.factorize()
    for forms in (dict(p_bc_ex=lambda x: x[1], f=0.7, R=R), dict(p_bc_ex=lambda x: 2.0 * x[1], R=R)):
        _both(lambda a: a.compute_forms(**forms), aj, ap)
        sj.solve()
        sp.solve()
        assert sp.info.method == "schur_factorized"
        _close(_x(sp), _x(sj), 1e-12)


def test_factorize_monitor_error_and_set_executor(capsys):
    """The monitor line, ``error_if_not_converged`` on a non-finite
    factorized solve, ``set_executor`` keyed to the current kinds, and
    ``factorize()`` outside the Schur method."""
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(_tree(P), N=2, color_strategy="fast"))
    ap.compute_forms(p_bc_ex=lambda x: x[1], R=2.0)
    s = P.Solver(ap, options=P.SolverOptions(monitor=True, error_if_not_converged=False), **CPU)
    s.factorize()
    s.solve()
    assert "method=schur_factorized iters=0" in capsys.readouterr().out
    fac, state = s._factorization[:2]
    s._factorization = (fac, state._replace(d=state.d * np.nan), *s._factorization[2:])
    s.solve()
    assert s.info.method == "schur_factorized" and not s.info.converged
    s._options.error_if_not_converged = True
    with pytest.raises(RuntimeError, match="factorized solve produced non-finite"):
        s.solve()
    t = P.Solver(ap, **CPU)
    ex = P.solver.build_schur_executor(ap, P.SolverOptions(), device="cpu")
    t.set_executor(ex)
    assert t._executor is ex and t._executor_key == ap.coefficient_modes()
    t.solve()
    assert t._executor is ex and t.info.method == "schur"
    with pytest.raises(ValueError, match="schur method only"):
        P.Solver(ap, options=P.SolverOptions(method="host_lu"), **CPU).factorize()


# ------------------------------------------------------------ the factorization classes


@pytest.mark.parametrize("gens,N,k,fkind", [(5, 3, 1, "edge"), (4, 2, 2, "cell")])
def test_blocked_factorization_reuse(gens, N, k, fkind):
    """One factor, two rhs-only solves, each the reference's
    ``BlockedFactorization`` at 1e-12·scale, finite (test_blocked.py:329)."""
    rng = np.random.default_rng(4)
    aj, ap = _pair(lambda pkg: _tree(pkg, gens), N=N, k=k)
    E, C = ap.network.num_edges, ap.network.num_edges * N
    R = rng.uniform(0.5, 2.0, E)
    f0 = rng.uniform(-1.0, 1.0, E if fkind == "edge" else C)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], f=f0, R=R), aj, ap)
    fj = JS.build_blocked_factorization(aj)
    fp = PF.build_blocked_factorization(ap, **CPU)
    stj, stp = fj.factor(R), fp.factor(R)
    for _ in range(2):
        fv = rng.uniform(-1.0, 1.0, E if fkind == "edge" else C)
        _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], f=fv, R=R), aj, ap)
        args = ap.schur_arguments()
        oj, op = fj.solve(stj, *args[1:]), fp.solve(stp, *args[1:])
        assert bool(op[4]) and len(op) == 5
        _close(fp.solution_vector(op), fj.solution_vector(oj), 1e-12)
        _close(op[3], oj[3], 1e-12)
        out = fp.solve_prepared(stp, fp.prepare_rhs(*args[1:]))
        assert all(torch.equal(a, b) for a, b in zip(out, op))
    # a batch of two: each row the single solve's bits, the stacked layout
    fs = rng.uniform(-1.0, 1.0, (2, E if fkind == "edge" else C))
    sp, ep = (np.stack([np.asarray(a)] * 2) for a in args[2:])
    outb = fp.solve_batch(stp, fs, sp, ep)
    assert len(outb) == 5 and all(o.shape[0] == 2 for o in outb)
    for i in range(2):
        assert all(torch.equal(a[i], b) for a, b in zip(outb, fp.solve(stp, fs[i], sp[i], ep[i])))
    with pytest.raises(ValueError, match="leading scenario axis"):
        fp.solve_batch(stp, fs, sp[:1], ep)


def test_factorization_envelopes():
    """The reference's ``ValueError`` outside each envelope: a cyclic graph
    for the blocked class, per-edge R or a forest for the lattice's, a
    callable R for all (test_blocked.py:361, test_grid_blocked.py:209)."""
    grid = lambda pkg: pkg.network_generation.make_grid(4, 3)
    _, ap = _pair(grid, strategy=None, p_bc_ex=lambda x: x[0])
    with pytest.raises(ValueError, match="blocked-eligible"):
        PF.build_blocked_factorization(ap, **CPU)
    ap.compute_forms(p_bc_ex=lambda x: x[0], R=np.linspace(1, 2, ap.network.num_edges))
    with pytest.raises(ValueError, match="scalar resistance"):
        PF.build_grid_factorization(ap, **CPU)
    _, at = _pair(_tree, p_bc_ex=lambda x: x[1])
    with pytest.raises(ValueError, match="rectangular-lattice"):
        PF.build_grid_factorization(at, **CPU)
    at.compute_forms(p_bc_ex=lambda x: x[1], R=lambda x: 1.0 + x[0] ** 2)
    for build in (PF.build_blocked_factorization, PF.build_tree_factorization):
        with pytest.raises(ValueError, match="quad-mode"):
            build(at, **CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        PF.build_blocked_factorization(_pair(_tree, p_bc_ex=lambda x: x[1])[1],
                                       P.SolverOptions(dtype="float32"), **CPU)
    if not torch.cuda.is_available():  # the default device is the card, and nothing falls back
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PF.build_blocked_factorization(_pair(_tree, p_bc_ex=lambda x: x[1])[1])


@pytest.mark.parametrize("nx,ny,N,k,fkind", [(6, 5, 2, 1, "edge"), (5, 7, 3, 2, "cell")])
def test_grid_factorization_reuse(nx, ny, N, k, fkind):
    """Lattice factor reuse against the reference's ``GridFactorization``
    at 1e-10·scale, its λ residual reported (test_grid_blocked.py:176)."""
    rng = np.random.default_rng(8)
    aj, ap = _pair(lambda pkg: pkg.network_generation.make_grid(nx, ny, arrays=True), N=N, k=k,
                   strategy=None)
    E, C = ap.network.num_edges, ap.network.num_edges * N
    f0 = rng.uniform(-1.0, 1.0, E if fkind == "edge" else C)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[0], f=f0, R=1.8), aj, ap)
    fj = JS.build_grid_factorization(aj)
    fp = PF.build_grid_factorization(ap, **CPU)
    R_data = ap.schur_arguments()[0]
    stj, stp = fj.factor(R_data), fp.factor(R_data)
    for _ in range(2):
        fv = rng.uniform(-1.0, 1.0, E if fkind == "edge" else C)
        _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[0], f=fv, R=1.8), aj, ap)
        args = ap.schur_arguments()
        oj, op = fj.solve(stj, *args[1:]), fp.solve(stp, *args[1:])
        assert bool(op[5]) and len(op) == 6 and fp.solve_has_residual
        _close(fp.solution_vector(op), fj.solution_vector(oj), 1e-10)
        assert float(op[3]) <= 1e-10 * float(op[4])


def _mf_plan(ap, leaf=4):
    tp = PL._plan_tree_elimination(ap, force_rounds=True)
    return tp._replace(core_plan=PMF.plan_multifrontal(np.asarray(tp.core_pairs), tp.core_size,
                                                       leaf=leaf))


def test_tree_factorization_multifrontal_core():
    """The multifrontal core (K13–K14 once, K15 a solve): on a 52² per-edge
    R lattice (a 2,704-node core, planned by ``auto``) against the port's
    fused solve and the reference's host LU at 1e-10·scale
    (test_multifrontal.py:184), and a forced plan on a small web's core
    (``_tree_plan=``) against the reference's factorization with the dense
    core at 1e-10·scale."""
    rng = np.random.default_rng(11)
    aj, ap = _pair(lambda pkg: pkg.network_generation.make_grid(52, 52, arrays=True), N=1)
    R = rng.uniform(0.5, 2.0, ap.network.num_edges)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[0], R=R), aj, ap)
    fused = P.Solver(ap, **CPU)
    fused.solve()
    fac = PF.build_tree_factorization(ap, P.SolverOptions(), **CPU)
    assert isinstance(fac.device_tree_plan.plan.core_plan, PMF.MFPlan)
    args = ap.schur_arguments()
    out = fac.solve_prepared(fac.factor(args[0]), fac.prepare_rhs(*args[1:]))
    x = fac.solution_vector(out)
    _close(x, _x(fused), 1e-10)
    ref = J.Solver(aj, options=J.SolverOptions(method="host_lu"))
    ref.solve()
    _close(x, _x(ref), 1e-10)

    graph = lambda pkg: pkg.network_generation.make_random_network(300, keep=0.1, seed=5)
    aj, ap = _pair(graph)
    E = ap.network.num_edges
    R, f = rng.uniform(0.5, 2.0, E), rng.uniform(-1, 1, E)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[0], f=f, R=R), aj, ap)
    fp = PF.build_tree_factorization(ap, **CPU, _tree_plan=_mf_plan(ap))
    assert fp.device_tree_plan.mf is not None
    fj = JS.build_tree_factorization(aj)
    args = ap.schur_arguments()
    op = fp.solve(fp.factor(R), *args[1:])
    oj = fj.solve(fj.factor(R), *args[1:])
    assert bool(op[4])
    _close(fp.solution_vector(op), fj.solution_vector(oj), 1e-10)


def test_vascular_bed_factorize():
    """The perfusion bed's factorize half (test_vascular_bed.py:120): a
    dense cycle core, the reference's factorized solve at 1e-10·scale."""
    graph = lambda pkg: pkg.network_generation.make_vascular_bed(3, 12, 8, arrays=True)
    aj, ap = _pair(graph, N=1, strategy=None)
    R0 = 1.0 / ap.network.edge_radius**4
    R0.setflags(write=False)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], R=R0), aj, ap)
    sj, sp = _solvers(aj, ap)
    for s in (sj, sp):
        s.factorize()
        s.solve()
    assert sp.info.method == "schur_factorized"
    fac = sp._factorization[0]
    assert fac.device_tree_plan.core_size and fac.device_tree_plan.mf is None
    _close(_x(sp), _x(sj), 1e-10)


def test_core_elim_core_raises_a3b():
    """A ``CoreElimPlan`` core, which raised ``NotImplementedError`` (ROADMAP
    A3b) until the port factored it: forced supernodal fronts on the bed (as
    tests/test_core_elim.py:578 forces them) through the class, equal to the
    reference's factorization of the same plan and to its host LU at
    1e-10·scale; and ``Solver.factorize()`` on the 2k web, whose core the
    planner gives min-degree rounds and a dense tail, equal to the
    reference's factorized solve at 1e-10·scale."""
    graph = lambda pkg: pkg.network_generation.make_vascular_bed(3, 12, 8, arrays=True)
    aj, ap = _pair(graph, N=2, strategy="fast")
    R = np.random.default_rng(5).uniform(0.5, 2.0, ap.network.num_edges)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], R=R), aj, ap)
    kw = dict(dense_cutoff=64, kcap=24, dense_cap=16, supernodal_tail=True, front_max=23,
              tail_stop=False)
    pj = JS._plan_tree_elimination(aj, force_rounds=True)
    pairs = np.asarray(pj.core_pairs)
    cpj = JCE.plan_core_elimination(
        pairs, pj.core_size, order=JCE.nested_dissection_order(pairs, pj.core_size, leaf=8), **kw)
    assert cpj is not None and cpj.fronts
    fj = JS.build_tree_factorization(aj, _tree_plan=pj._replace(core_plan=cpj))
    oj = fj.solve(fj.factor(R), *aj.schur_arguments(device=False)[1:])
    ref = J.Solver(aj, options=J.SolverOptions(method="host_lu"))
    ref.solve()
    _close(fj.solution_vector(oj), _x(ref), 1e-10)
    pp = PL._plan_tree_elimination(ap, force_rounds=True)
    cpp = PCE.plan_core_elimination(
        pairs, pp.core_size, order=PCE.nested_dissection_order(pairs, pp.core_size, leaf=8), **kw)
    fp = PF.build_tree_factorization(ap, **CPU, _tree_plan=pp._replace(core_plan=cpp))
    assert fp.device_tree_plan.ce is not None and fp.device_tree_plan.ce.fronts
    op = fp.solve(fp.factor(R), *ap.schur_arguments(device=False)[1:])
    assert bool(op[4])
    _close(fp.solution_vector(op), fj.solution_vector(oj), 1e-10)
    _close(fp.solution_vector(op), _x(ref), 1e-10)

    web = lambda pkg: pkg.network_generation.make_random_network(2000, keep=0.7, num_boundary=8,
                                                                 seed=5)
    aj, ap = _pair(web, N=1, strategy=None)
    R = np.linspace(0.5, 2.0, ap.network.num_edges)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[0], R=R), aj, ap)
    sj, sp = _solvers(aj, ap)
    sj.factorize()
    sp.factorize()
    fac = sp._factorization[0]
    ce = fac.device_tree_plan.ce
    assert ce is not None and ce.rounds and ce.dense_nodes.shape[0] and not ce.fronts
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: 2.0 * x[1] - x[0], f=0.4, R=R), aj, ap)
    sj.solve()
    sp.solve()
    assert sj.info.method == sp.info.method == "schur_factorized" and sp.info.converged
    _close(_x(sp), _x(sj), 1e-10)


def _web700():
    """Both packages' assemblers of the 700-site web of
    tests/test_core_elim.py:208 (a 686-node core: two min-degree rounds and
    a 352-node dense tail), its first forms, R and the rng."""
    graph = lambda pkg: pkg.network_generation.make_random_network(700, keep=0.55, seed=21)
    aj, ap = _pair(graph, N=2)
    rng = np.random.default_rng(9)
    E = ap.network.num_edges
    R = rng.uniform(0.5, 3.0, E)
    f0 = rng.uniform(-1.0, 1.0, E)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[0], f=f0, R=R), aj, ap)
    return aj, ap, R, f0, rng


def _host_lu(asm) -> np.ndarray:
    ref = J.Solver(asm, options=J.SolverOptions(method="host_lu"))
    ref.solve()
    return _x(ref)


def test_tree_factorization_unstructured_web():
    """tests/test_core_elim.py:208 in full: the 700-site web factored once
    (the min-degree rounds and K11's factor of the dense tail), the solve
    and an rhs-only re-solve at 1e-10·scale of the JAX package's host LU, a
    ``solve_batch`` of three right-hand sides (each row against host LU,
    and ``solve()``'s bits), and ``Solver.factorize()`` routing the tree
    factorization (``schur_factorized``)."""
    aj, ap, R, f0, rng = _web700()
    E = ap.network.num_edges
    fac = PF.build_tree_factorization(ap, **CPU)
    cp = fac.device_tree_plan.plan.core_plan
    assert isinstance(cp, PCE.CoreElimPlan) and len(cp.rounds) == 2 and cp.dense_nodes.size == 352
    state = fac.factor(R)
    args = ap.schur_arguments(device=False)
    _close(fac.solution_vector(fac.solve(state, *args[1:])), _host_lu(aj), 1e-10)
    f1 = rng.uniform(-1.0, 1.0, E)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: 3.0 * x[1], f=f1, R=R), aj, ap)
    args1 = ap.schur_arguments(device=False)
    _close(fac.solution_vector(fac.solve(state, *args1[1:])), _host_lu(aj), 1e-10)
    S = 3
    fb = rng.uniform(-1.0, 1.0, (S, E))
    spb = np.broadcast_to(args1[2], (S, E)).copy()
    epb = np.broadcast_to(args1[3], (S, E)).copy()
    outb = fac.solve_batch(state, fb, spb, epb)
    for i in range(S):
        aj.compute_forms(p_bc_ex=lambda x: 3.0 * x[1], f=fb[i], R=R)
        _close(fac.solution_vector([o[i] for o in outb]), _host_lu(aj), 1e-10)
        assert all(torch.equal(a[i], b) for a, b in zip(outb, fac.solve(state, fb[i], spb[i], epb[i])))
    asm2 = P.HydraulicNetworkAssembler(ap.network)
    asm2.compute_forms(p_bc_ex=lambda x: x[0], f=f0, R=R)
    s2 = P.Solver(asm2, **CPU)
    s2.factorize()
    assert isinstance(s2._factorization[0], PF.TreeFactorization)
    asm2.compute_forms(p_bc_ex=lambda x: x[0] - x[1], f=f1, R=R)
    s2.solve()
    assert s2.info.method == "schur_factorized"
    aj.compute_forms(p_bc_ex=lambda x: x[0] - x[1], f=f1, R=R)
    _close(_x(s2), _host_lu(aj), 1e-10)


def test_tree_factorization_supernodal_fronts():
    """tests/test_core_elim.py:550: a forced fronts plan on the 26² per-edge
    R lattice (``front_max=23``) factored once; the solve and an rhs-only
    re-solve at 1e-10·scale of host LU and of the reference's factorization
    of the same plan."""
    graph = lambda pkg: pkg.network_generation.make_grid(26, 26, arrays=True)
    aj, ap = _pair(graph, N=1)
    R = np.random.default_rng(31).uniform(0.5, 2.0, ap.network.num_edges)
    _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[0], R=R), aj, ap)
    kw = dict(dense_cutoff=64, kcap=24, dense_cap=16, supernodal_tail=True, front_max=23,
              tail_stop=False)
    pj = JS._plan_tree_elimination(aj, force_rounds=True)
    pairs = np.asarray(pj.core_pairs)
    cpj = JCE.plan_core_elimination(
        pairs, pj.core_size, order=JCE.nested_dissection_order(pairs, pj.core_size, leaf=8), **kw)
    pp = PL._plan_tree_elimination(ap, force_rounds=True)
    cpp = PCE.plan_core_elimination(
        pairs, pp.core_size, order=PCE.nested_dissection_order(pairs, pp.core_size, leaf=8), **kw)
    assert cpp is not None and cpp.fronts and cpp.rounds
    fj = JS.build_tree_factorization(aj, _tree_plan=pj._replace(core_plan=cpj))
    fp = PF.build_tree_factorization(ap, **CPU, _tree_plan=pp._replace(core_plan=cpp))
    stj, stp = fj.factor(R), fp.factor(R)
    for forms in (dict(p_bc_ex=lambda x: x[0], R=R), dict(p_bc_ex=lambda x: 2.0 * x[1] - x[0], R=R)):
        _both(lambda a: a.compute_forms(**forms), aj, ap)
        args = ap.schur_arguments(device=False)
        x = fp.solution_vector(fp.solve(stp, *args[1:]))
        _close(x, _host_lu(aj), 1e-10)
        _close(x, fj.solution_vector(fj.solve(stj, *args[1:])), 1e-10)


@pytest.mark.parametrize("fac_class", ["blocked", "grid"])
def test_factorization_solve_batch(fac_class):
    """tests/test_blocked.py:372 (blocked) and the lattice class alike:
    ``solve_batch`` rows against per-rhs solves, the reference's
    ``solve_batch`` at its 1e-14 (blocked) or the lattice's 1e-10·scale,
    and ``solve()``'s bits."""
    rng = np.random.default_rng(12)
    if fac_class == "blocked":
        aj, ap = _pair(lambda pkg: pkg.network_generation.make_tree(5, 1.0, 2.0, arrays=True))
        E = ap.network.num_edges
        R = rng.uniform(0.5, 2.0, E)
        _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, E), R=R),
              aj, ap)
        fj, fp = JS.build_blocked_factorization(aj), PF.build_blocked_factorization(ap, **CPU)
        tol = 1e-14
    else:
        aj, ap = _pair(lambda pkg: pkg.network_generation.make_grid(6, 5, arrays=True),
                       strategy=None)
        E = ap.network.num_edges
        R = 1.8
        _both(lambda a: a.compute_forms(p_bc_ex=lambda x: x[0], f=0.3, R=R), aj, ap)
        fj, fp = JS.build_grid_factorization(aj), PF.build_grid_factorization(ap, **CPU)
        R = ap.schur_arguments()[0]
        tol = 1e-10
    stj, stp = fj.factor(R), fp.factor(R)
    S = 3
    fb = rng.uniform(-1.0, 1.0, (S, E))
    _, _, spbc, epbc = ap.schur_arguments(device=False)
    sp_b = np.broadcast_to(np.asarray(spbc), (S, E))
    ep_b = np.broadcast_to(np.asarray(epbc), (S, E))
    outs = fp.solve_batch(stp, fb, sp_b, ep_b)
    outs_j = fj.solve_batch(stj, fb, sp_b, ep_b)
    for i in range(S):
        single = fp.solve(stp, fb[i], spbc, epbc)
        assert all(torch.equal(a[i], b) for a, b in zip(outs, single))
        _close(fp.solution_vector([o[i] for o in outs]),
               fj.solution_vector([o[i] for o in outs_j]), tol)


def test_blocked_solve_batch_scenario_axis(monkeypatch):
    """``BlockedFactorization.solve_batch`` of three per-cell right-hand sides
    at k = 2: each of K1, K3–K4 and K5 called once for all rows (their
    scenario axis), each row ``solve()``'s bits."""
    from networks_fenicsx_tpu_torch.kernels import condense, expand

    rng = np.random.default_rng(13)
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(_tree(P, 5), N=3, color_strategy="fast"),
                                     flux_degree=2)
    E, C = ap.network.num_edges, ap.network.num_cells
    R = rng.uniform(0.5, 2.0, E)
    ap.compute_forms(p_bc_ex=lambda x: x[1], f=rng.uniform(-1, 1, C), R=R)
    fp = PF.build_blocked_factorization(ap, **CPU)
    stp = fp.factor(R)
    S = 3
    fb = rng.uniform(-1.0, 1.0, (S, C))
    _, _, spbc, epbc = ap.schur_arguments()
    sp_b = np.stack([spbc * s for s in (1.0, -0.5, 2.0)])
    ep_b = np.stack([epbc * s for s in (1.0, -0.5, 2.0)])
    calls = []
    for mod, name in ((condense, "condense_scenarios"), (tree_sweep, "tree_sweep_apply_scenarios"),
                      (expand, "expand_scenarios")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: calls.append(_n)
                            or _fn(*a, **kw))
    outs = fp.solve_batch(stp, fb, sp_b, ep_b)
    assert calls == ["condense_scenarios", "tree_sweep_apply_scenarios", "expand_scenarios"]
    assert len(outs) == 5 and all(o.shape[0] == S for o in outs)
    for i in range(S):
        single = fp.solve(stp, fb[i], sp_b[i], ep_b[i])
        assert all(torch.equal(a[i], b) for a, b in zip(outs, single))


def test_tree_factorization_singular_core_raises():
    """A zero-pivot gate that trips in the stored factor (the 700-site
    web's dense tail) makes λ NaN, and ``Solver`` raises its non-finite
    error, as on the fused path."""
    _, ap, R, _, _ = _web700()
    s = P.Solver(ap, options=P.SolverOptions(error_if_not_converged=True), **CPU)
    s.factorize()
    fac, state = s._factorization[:2]
    Lc, sc, C, ok = state.core.tail
    core = state.core._replace(tail=(Lc, sc, C, torch.zeros_like(ok)))
    s._factorization = (fac, state._replace(core=core), *s._factorization[2:])
    out = fac.solve(state._replace(core=core), *ap.schur_arguments(device=False)[1:])
    assert torch.isnan(out[2]).any() and not bool(out[4])
    with pytest.raises(RuntimeError, match="factorized solve produced non-finite"):
        s.solve()


# ------------------------------------------------------------ the split kernels' plain versions


SWEEP_CASES = ["arterial5", "arterial7", "degrees-3-2-1-4-2", "forest-5-roots",
               "chain-deeper-than-top", "all-top"]


@pytest.mark.parametrize("name", SWEEP_CASES)
def test_sweep_factor_apply_plain(monkeypatch, name):
    """K2 and K3–K4's plain versions: in the reference's order against
    ``_blocked_forward_factor``, ``_blocked_forward_apply`` and
    ``_blocked_backward`` at 1e-12·scale, and both orders equal to the
    fused plain versions (λ, d, r, wn; the norm in its own order)."""
    graph, consts = TOPOLOGIES[name]
    _patched(monkeypatch, consts)
    aj, ap = _pair(graph, p_bc_ex=lambda x: x[1])
    jplan, plan = JS._plan_blocked(aj), PB._plan_blocked(ap)
    dp = PB.device_plan(plan, "cpu")
    rng = np.random.default_rng(3)
    E = plan.edge_order.size
    w, const, Ftot = rng.uniform(0.5, 2.0, E), rng.uniform(-1, 1, E), rng.uniform(-1, 1, E)
    d_lev, wn_lev, f_lev = JS._blocked_forward_factor(jplan, jnp.asarray(w))
    d0, r0, _, saved, rhs_sq = JS._blocked_forward_apply(jplan, d_lev, wn_lev, f_lev,
                                                        jnp.asarray(const), jnp.asarray(Ftot))
    _, lam_j = JS._blocked_backward(jplan, saved, r0 / d0)
    d, wn, fac = tree_sweep.tree_sweep_factor_plain(plan, _t(w))
    _close(d, jnp.concatenate(d_lev), 1e-12)
    _close(wn, jnp.concatenate(wn_lev), 1e-12)
    n0 = plan.levels[0].m
    if len(f_lev) > 1:
        _close(fac[n0:], jnp.concatenate(f_lev[1:]), 1e-12)
    lam, norm, r = tree_sweep.tree_sweep_apply_plain(plan, d, wn, fac, _t(const), _t(Ftot))
    _close(lam, lam_j, 1e-12)
    _close(norm, jnp.sqrt(rhs_sq), 1e-12)
    fused = tree_sweep.tree_sweep_plain(plan, _t(w), _t(const), _t(Ftot))
    assert torch.equal(lam, fused[0]) and torch.equal(norm, fused[1])
    assert torch.equal(d, fused[2]) and torch.equal(r, fused[3]) and torch.equal(wn, fused[4])
    fb = tree_sweep.tree_sweep_blocked_plain(dp, _t(w), _t(const), _t(Ftot))
    db, wnb, facb = tree_sweep.tree_sweep_factor_blocked_plain(dp, _t(w))
    lamb, normb, rb = tree_sweep.tree_sweep_apply_blocked_plain(dp, db, wnb, facb, _t(const),
                                                                _t(Ftot))
    assert torch.equal(db, fb[2]) and torch.equal(wnb, fb[4]) and torch.equal(facb, wnb / db)
    assert torch.equal(lamb, fb[0]) and torch.equal(normb, fb[1]) and torch.equal(rb, fb[3])
    # the wrappers' CPU path, and the launch counts of the split
    assert all(torch.equal(a, b) for a, b in zip(tree_sweep.tree_sweep_factor(dp, _t(w)),
                                                  (d, wn, fac)))
    assert tree_sweep.cuda_launches(dp, tree_sweep.FACTOR) == tree_sweep.cuda_launches(
        dp, tree_sweep.FORWARD)
    assert tree_sweep.cuda_launches(dp, tree_sweep.APPLY) == tree_sweep.cuda_launches(dp)


@pytest.mark.parametrize("seed", [0, 1])
def test_peel_factor_apply_plain(seed):
    """K9's channels on a 1,000-site web (11 rounds, a 455-node dense
    core): in the reference's order against ``_tree_eliminate_factor`` (the
    saved w, db and factor, the core's diagonal) and ``_tree_eliminate_apply``
    (λ, with the port's dense core) at 1e-12·scale; in the table's order
    equal to it, and λ equal to the fused pass's on the same core
    solution."""
    pj, dtp, diag, rhs, w_pairs = _peel_problem(seed=seed)
    state = jax.jit(lambda d, w: JS._tree_eliminate_factor(pj, d, w))(jnp.asarray(diag),
                                                                       jnp.asarray(w_pairs))
    lam_j = jax.jit(lambda s, r: JS._tree_eliminate_apply(pj, s, r))(state, jnp.asarray(rhs))
    dr, wp = _t(np.stack([diag, rhs], 1)), _t(w_pairs)
    pf = peel.peel_factor_plain(dtp, dr, wp)
    _close(pf.w, jnp.concatenate([w for w, _, _ in state["rounds"]]), 1e-12)
    _close(pf.db, jnp.concatenate([db for _, db, _ in state["rounds"]]), 1e-12)
    _close(pf.dc, jnp.diagonal(state["core_dense"]["Lc"]), 1e-12)
    for rd, (_, _, fac) in zip(dtp.rounds, state["rounds"]):
        has = rd.parents >= 0
        _close(pf.factor[rd.elim.long()][has], np.asarray(fac)[has.numpy()], 1e-12)
    Lc, s, C = dense_core.dense_factor_plain(dtp.core_ci, dtp.core_cj, dtp.core_pid, pf.dc, wp)
    ok = dense_core.dense_gate_plain(C)
    seen = {}

    def core(rc):
        seen["x"] = dense_core.dense_solve_plain(Lc, s, C, ok, rc)
        return seen["x"]

    lam = peel.peel_apply_plain(dtp, pf, dr, core)
    _close(lam, lam_j, 1e-12)
    x = seen["x"]
    pt = peel.peel_factor_table_plain(dtp, dr, wp)
    assert all(torch.equal(a, b) for a, b in zip(pt, pf))
    assert torch.equal(peel.peel_apply_table_plain(dtp, pt, dr, lambda rc: x), lam)
    assert torch.equal(peel.peel_plain(dtp, dr, wp, lambda dc, rc: x), lam)
    assert torch.equal(peel.peel_table_plain(dtp, dr, wp, lambda dc, rc: x), lam)
    assert peel.factor_launches(dtp) + dtp.peel_table.n_back == peel.cuda_launches(dtp)


def test_peel_factor_apply_forced_forest_rounds():
    """The forced rounds of an irregular forest (no core): the channels in
    both orders equal the fused pass's λ, and the wrappers' CPU path."""
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(
        P.network_generation.make_random_network(2000, keep=0.0, seed=7), N=1,
        color_strategy="fast"))
    tp = PL._cached_tree_plan(ap, force_rounds=True)
    dtp = PT.device_tree_plan(tp, PL._build_lambda_plan(ap), ap, "cpu")
    assert dtp.core_size == 0 and len(dtp.rounds) > 20
    rng = np.random.default_rng(4)
    B = dtp.num_bifurcations
    wp = _t(rng.uniform(0.5, 2.0, dtp.num_pairs))
    dr = _t(np.stack([rng.uniform(3.0, 5.0, B), rng.standard_normal(B)], 1))
    lam = peel.peel_plain(dtp, dr, wp, None)
    pf = peel.peel_factor(dtp, dr, wp)
    assert torch.equal(peel.peel_apply(dtp, pf, dr, None), lam)
    pt = peel.peel_factor_table_plain(dtp, dr, wp)
    assert torch.equal(peel.peel_apply_table_plain(dtp, pt, dr, None), lam)


def test_dense_solve_plain_matches_scaled_cholesky():
    """K11's solve on a stored factor against the reference's
    ``scaled_cholesky_solve`` on its ``scaled_cholesky_factor`` at
    1e-12·scale, ``dense_core_plain``'s bits where the same factor feeds
    both, and NaN everywhere when the gate trips."""
    dtp, Lc, rc, w_pairs = _core_system()
    want = JMP.scaled_cholesky_solve(JMP.scaled_cholesky_factor(jnp.asarray(Lc)), jnp.asarray(rc))
    pairs = (dtp.core_ci, dtp.core_cj, dtp.core_pid)
    dc, wp = _t(np.diagonal(Lc)), _t(w_pairs)
    L, s, C = dense_core.dense_factor(*pairs, dc, wp)
    ok = dense_core.dense_gate(C)
    got = dense_core.dense_solve(L, s, C, ok, _t(rc))
    _close(got, want, 1e-12)
    assert torch.equal(got, dense_core.dense_core_plain(*pairs, dc, _t(rc), wp))
    assert torch.equal(dense_core.dense_solve(L, s, C, ok, _t(rc), n_refine=0),
                       dense_core.dense_core_plain(*pairs, dc, _t(rc), wp, n_refine=0))
    singular = _t(np.array([1.0, 1.0]))
    ci, cj, pid = (_t(np.array([0]), torch.int32), _t(np.array([1]), torch.int32),
                   _t(np.array([0]), torch.int32))
    L, s, C = dense_core.dense_factor(ci, cj, pid, singular, _t(np.array([1.0])))
    assert not bool(dense_core.dense_gate(C))
    assert torch.isnan(dense_core.dense_solve(L, s, C, dense_core.dense_gate(C),
                                              _t(np.array([1.0, 2.0])))).all()
    assert dense_core.solve_launches(455) == 16 and dense_core.solve_launches(0) == 0


@pytest.mark.parametrize("graph", ["6x5", "two_stubs", "66x66"])
def test_dct_apply_plain_matches_capacitance_apply(graph):
    """K16's passes on a stored factor against ``_dct_capacitance_apply``
    on the reference's ``_dct_capacitance_factor`` with the same rhs and
    matvec, at 1e-12·scale or the conditioning floor 4·n²·ε where that is
    larger; on the port's factor equal to ``dct_lattice_plain``'s bits."""
    aj, ap, dct, W, g, Ftot, sp, ep = _lattice_system(GRIDS[graph], seed=2)
    _, diag_j, rhs_j, class_w = _reference_system(aj, W, g, Ftot, sp, ep)
    B = ap.network.num_multipliers
    matvec = JS._shift_matvec(class_w, diag_j, B)
    w = 1.0 / W
    w_r = np.zeros(dct.stub_rows.size)
    np.add.at(w_r, dct.stub_edge_group, w[dct.stub_edge_idx])
    plan_j = JS._plan_dct_lattice(aj, JS._plan_shift_matvec(aj))
    state_j = JS._dct_capacitance_factor(plan_j, w[dct.rep_x], w[dct.rep_y], jnp.asarray(w_r),
                                         jnp.float64)
    want = JS._dct_capacitance_apply(plan_j, state_j, rhs_j, matvec)
    op = dct_lattice.dct_operator(dct, "cpu")
    rhs = _t(np.asarray(rhs_j))

    def residual(lam):
        return rhs - _t(np.asarray(matvec(jnp.asarray(lam.numpy()))))

    st = dct_lattice.dct_factor(op, _t(w))
    got = dct_lattice.dct_apply(op, st, rhs, residual)
    kappa = float(max(dct.s, dct.ny)) ** 2
    _close(got, want, max(1e-12, 4 * kappa * np.finfo(np.float64).eps))
    assert torch.equal(got, dct_lattice.dct_lattice_plain(op, _t(w), rhs, residual))
    assert dct_lattice.apply_launches() == dct_lattice.cuda_launches(op) - 2 == 18


def test_dct_apply_refuses_a_strided_state():
    """Off the CPU a stored factor the kernel cannot read raises before any
    launch: a transposed (non-contiguous) eigenvalue inverse."""
    f64 = dict(dtype=torch.float64)
    st = dct_lattice.DctState(torch.zeros((4, 4), **f64).t(), torch.zeros((1, 16), **f64),
                              torch.zeros((2, 2), **f64))
    with pytest.raises(ValueError, match="contiguous"):
        dct_lattice.dct_apply(None, st, torch.zeros(16, device="meta", **f64), None)
