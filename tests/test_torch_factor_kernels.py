"""The split kernels of factor reuse on the card, and their counters here.

K2 from K3–K4 (``tree_sweep_factor``/``tree_sweep_apply``), K9's channels
(``peel_factor``/``peel_apply``), K11's solve on a stored factor
(``dense_gate``/``dense_solve``) and K16's passes on a stored factor
(``dct_factor``/``dct_apply``).  The ``cuda``-marked tests hold each on a
CUDA device against its plain version in the kernels' order bit for bit,
the apply's λ against the fused kernel's on the same inputs bit for bit,
and ``Solver.factorize()`` against the fused solve (1e-12·scale on the
blocked tree; 1e-10·scale on the lattice, on cycle cores and on a forest,
whose fused route eliminates in another order); they skip without a
card.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import blocked as PB
from networks_fenicsx_tpu_torch import kernels
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch import tree as PT
from networks_fenicsx_tpu_torch.kernels import dense_core, peel, tree_sweep

from test_torch_blocked_subtree import TOPOLOGIES, _asm, _inputs, _patched

torch.set_num_threads(1)


def _web(sites=1000, keep=0.05, N=2):
    net = P.network_generation.make_random_network(sites, keep=keep, seed=7, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=N, color_strategy="fast"))
    rng = np.random.default_rng(0)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=rng.uniform(0.5, 2.0, asm.network.num_edges),
                      f=rng.uniform(-1.0, 1.0, asm.network.num_cells))
    return asm


def test_factored_wrappers_are_counted():
    """The split wrappers are in ``kernels.FACTORED`` and counted with the
    others; their CPU paths (the plain versions) launch nothing."""
    names = {fn.__name__ for fn in kernels.FACTORED}
    assert names == {"tree_sweep_factor", "tree_sweep_apply", "bifurcation_system", "peel_factor",
                     "peel_apply", "dense_gate", "dense_solve", "dct_factor", "dct_apply",
                     "core_factor", "core_apply", "core_fronts_factor", "core_fronts_apply"}
    assert names <= set(kernels.launches())
    kernels.reset_launches()
    asm = _web(300, keep=0.1)
    s = P.Solver(asm, device="cpu")
    s.factorize()
    s.solve()
    assert s.info.method == "schur_factorized"
    assert all(n == 0 for n in kernels.launches().values())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_sweep_factor_apply_on_card(monkeypatch, name):
    """FACTOR and APPLY equal the blocked plain versions bit for bit (the
    norm too) and the full sweep's d, wn, λ and norm."""
    dev = _card()
    graph, consts = TOPOLOGIES[name]
    _patched(monkeypatch, consts)
    dp = PB.device_plan(PB._plan_blocked(_asm(P, graph)), dev)
    w, const, Ftot = (t.to(dev) for t in _inputs(dp.plan))
    fac = tree_sweep.tree_sweep_factor(dp, w)
    assert all(torch.equal(a, b) for a, b in zip(fac, tree_sweep.tree_sweep_factor_blocked_plain(dp, w)))
    got = tree_sweep.tree_sweep_apply(dp, *fac, const, Ftot)
    want = tree_sweep.tree_sweep_apply_blocked_plain(dp, *fac, const, Ftot)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), name
    full = tree_sweep.tree_sweep(dp, w, const, Ftot)
    assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    assert torch.equal(fac[0], full[2]) and torch.equal(fac[1], full[4])


@pytest.mark.cuda
@pytest.mark.parametrize("sites,keep", [(1000, 0.05), (2000, 0.0)])
def test_peel_channels_on_card(sites, keep):
    """K9's d and r channels equal their table-order plain versions bit for
    bit, and the apply's λ the two-channel pass's on the same core solution
    (a 455-node dense core; an irregular forest's forced rounds)."""
    dev = _card()
    asm = _web(sites, keep)
    tp = PL._cached_tree_plan(asm, force_rounds=True)
    dtp = PT.device_tree_plan(tp, PL._build_lambda_plan(asm), asm, dev)
    rng = np.random.default_rng(1)
    B = dtp.num_bifurcations
    dr = torch.as_tensor(np.stack([rng.uniform(3.0, 5.0, B), rng.standard_normal(B)], 1), device=dev)
    wp = torch.as_tensor(rng.uniform(0.5, 1.0, dtp.num_pairs), device=dev)
    x = torch.as_tensor(rng.standard_normal(dtp.core_size), device=dev)
    pf = peel.peel_factor(dtp, dr, wp)
    assert all(torch.equal(a, b) for a, b in zip(pf, peel.peel_factor_table_plain(dtp, dr, wp)))
    lam = peel.peel_apply(dtp, pf, dr, lambda rc: x)
    assert torch.equal(lam, peel.peel_apply_table_plain(dtp, pf, dr, lambda rc: x))
    assert torch.equal(lam, peel.peel(dtp, dr, wp, lambda dc, rc: x))


def _bifurcation_inputs(dev):
    asm = _web(1000, 0.05)
    tp = PL._cached_tree_plan(asm, force_rounds=True)
    dtp = PT.device_tree_plan(tp, PL._build_lambda_plan(asm), asm, dev)
    rng = np.random.default_rng(3)
    E = dtp.num_edges
    W = torch.as_tensor(rng.uniform(0.5, 2.0, E), device=dev)
    rhs = [torch.as_tensor(rng.standard_normal(E), device=dev) for _ in range(4)]
    return dtp, W, rhs


def test_bifurcation_diagonal_alone():
    """The factor's bifurcation system (no rhs arguments) is the whole
    system's diagonal bit for bit, with a zero rhs channel and no norm."""
    dtp, W, rhs = _bifurcation_inputs("cpu")
    dr, w, norm = peel.bifurcation_system(dtp, W)
    full = peel.bifurcation_system(dtp, W, *rhs)
    assert norm is None and not dr[:, 1].any()
    assert torch.equal(dr[:, 0], full[0][:, 0]) and torch.equal(w, full[1])


@pytest.mark.cuda
def test_bifurcation_diagonal_alone_on_card():
    """The prepare kernel without rhs pointers and K6: the plain version's
    bits, the whole system's diagonal, two launches (no norm)."""
    dev = _card()
    dtp, W, rhs = _bifurcation_inputs(dev)
    kernels.reset_launches()
    dr, w, norm = peel.bifurcation_system(dtp, W)
    assert peel.bifurcation_system.launches == 1 and norm is None
    want = peel.bifurcation_system_plain(dtp, W)
    assert torch.equal(dr, want[0]) and torch.equal(w, want[1])
    assert torch.equal(dr[:, 0], peel.bifurcation_system(dtp, W, *rhs)[0][:, 0])


@pytest.mark.cuda
def test_dense_solve_on_card():
    """K11's solve on a stored factor: ``dense_core``'s bits on the same
    factor, its plain version at 1e-10·scale (1e-12 unrefined), NaN when
    the gate trips."""
    dev = _card()
    n = 455
    rng = np.random.default_rng(2)
    i, j = np.triu_indices(n, 1)
    pick = rng.random(i.size) < 8.0 / n
    ci, cj = (torch.as_tensor(a[pick].astype(np.int32), device=dev) for a in (i, j))
    P0 = int(ci.shape[0])
    pid = torch.arange(P0, dtype=torch.int32, device=dev)
    wp = torch.as_tensor(rng.uniform(0.5, 1.0, P0), device=dev)
    dc = torch.full((n,), 1.0, dtype=torch.float64, device=dev)
    dc.index_add_(0, ci.long(), wp).index_add_(0, cj.long(), wp)
    rc = torch.as_tensor(rng.standard_normal(n), device=dev)
    Lc, s, C = dense_core.dense_factor(ci, cj, pid, dc, wp)
    ok = dense_core.dense_gate(C)
    x = dense_core.dense_solve(Lc, s, C, ok, rc)
    assert torch.equal(x, dense_core.dense_core(ci, cj, pid, dc, rc, wp))
    chol = torch.tril(C)
    want = dense_core.dense_solve_plain(Lc, s, chol, ok, rc)
    assert float((x - want).abs().max()) <= 1e-10 * max(1.0, float(want.abs().max()))
    x0 = dense_core.dense_solve(Lc, s, C, ok, rc, n_refine=0)
    want0 = dense_core.dense_solve_plain(Lc, s, chol, ok, rc, n_refine=0)
    assert float((x0 - want0).abs().max()) <= 1e-12 * max(1.0, float(want0.abs().max()))
    bad = torch.zeros_like(ok)
    assert torch.isnan(dense_core.dense_solve(Lc, s, C, bad, rc)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tree", "lattice", "forest", "web", "web2k"])
def test_factorize_on_card(case):
    """``Solver.factorize()`` on the card: the class of the case, rhs-only
    solves equal to the fused solve (1e-12·scale on the tree; 1e-10 on the
    lattice, the forest's other elimination order and a cycle core: web2k's
    is min-degree rounds with a dense tail)."""
    dev = _card()
    if case == "tree":
        net = P.network_generation.make_arterial_tree(8, direction=[0.1, 1, 0], arrays=True)
        asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=6, color_strategy="fast"))
        R, tol, cls = 1.0 / asm.network.edge_radius**4, 1e-12, "BlockedFactorization"
    elif case == "lattice":
        net = P.network_generation.make_grid(40, 30, arrays=True)
        asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=2, color_strategy="fast"))
        R, tol, cls = 1.5, 1e-10, "GridFactorization"
    elif case == "web2k":
        net = P.network_generation.make_random_network(2000, keep=0.7, num_boundary=8, seed=5,
                                                       arrays=True)
        asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=1, color_strategy="fast"))
        R = np.random.default_rng(7).uniform(0.5, 2.0, asm.network.num_edges)
        tol, cls = 1e-10, "TreeFactorization"
    else:
        asm = _web(3000 if case == "forest" else 1000, 0.0 if case == "forest" else 0.05)
        R, tol, cls = asm.schur_arguments()[0].copy(), 1e-10, "TreeFactorization"

    def forms(s):
        f = np.random.default_rng(s).uniform(-1.0, 1.0, asm.network.num_cells)
        asm.compute_forms(p_bc_ex=lambda x: x[1] + 0.1 * s * x[0], R=R, f=f)

    forms(0)
    solver, fused = P.Solver(asm, device=dev), P.Solver(asm, device=dev)
    solver.factorize()
    assert type(solver._factorization[0]).__name__ == cls
    for s in range(1, 4):
        forms(s)
        solver.solve()
        fused.solve()
        assert solver.info.method == "schur_factorized" and solver.info.converged
        x, xf = solver.solution_vector(), fused.solution_vector()
        assert np.abs(x - xf).max() <= tol * max(1.0, np.abs(xf).max()), (case, s)


@pytest.mark.cuda
def test_forced_fronts_factorization_on_card():
    """A forced supernodal-fronts plan on a 26² per-edge-R lattice (as
    tests/test_core_elim.py:550 forces it) factored on the card: rhs-only
    solves within 1e-10·scale of the same factorization's plain versions,
    and each ``solve_batch`` row ``solve()``'s bits."""
    from networks_fenicsx_tpu_torch import factorization as PF
    from networks_fenicsx_tpu_torch.ops import core_elim as PCE

    dev = _card()
    net = P.network_generation.make_grid(26, 26, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=1, color_strategy="fast"))
    rng = np.random.default_rng(31)
    E = asm.network.num_edges
    R = rng.uniform(0.5, 2.0, E)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=R, f=rng.uniform(-1.0, 1.0, E))
    plan = PL._plan_tree_elimination(asm, force_rounds=True)
    pairs = np.asarray(plan.core_pairs)
    cp = PCE.plan_core_elimination(
        pairs, plan.core_size, dense_cutoff=64, kcap=24, dense_cap=16, supernodal_tail=True,
        front_max=23, tail_stop=False,
        order=PCE.nested_dissection_order(pairs, plan.core_size, leaf=8))
    assert cp is not None and cp.fronts
    facs = [PF.build_tree_factorization(asm, device=d, _tree_plan=plan._replace(core_plan=cp))
            for d in (dev, "cpu")]
    states = [fac.factor(R) for fac in facs]
    fb = rng.uniform(-1.0, 1.0, (3, E))
    _, _, sp, ep = asm.schur_arguments(device=False)
    spb, epb = np.broadcast_to(sp, (3, E)).copy(), np.broadcast_to(ep, (3, E)).copy()
    outb = facs[0].solve_batch(states[0], fb, spb, epb)
    for i in range(3):
        got = facs[0].solve(states[0], fb[i], sp, ep)
        assert all(torch.equal(a[i], b) for a, b in zip(outb, got))
        x = facs[0].solution_vector(got)
        want = facs[1].solution_vector(facs[1].solve(states[1], fb[i], sp, ep))
        assert np.abs(x - want).max() <= 1e-10 * max(1.0, np.abs(want).max()), i
