"""Scenario sweeps on the level route (``_LevelExecutor.scenarios``).

An irregular forest (``make_random_network(n, keep=0.0)``) and callable
coefficients take the level route: K8a, K7 with its K6 sums and K8b, each
over S scenarios in the launches of one solve
(:func:`networks_fenicsx_tpu_torch.kernels.level_eliminate.level_eliminate_scenarios`:
the prepare pass and K6's three sums over S rows, then the walk schedule
with the scenario as every launch's grid y).

Held here: the port's sweep against the JAX package's ``solve_sweep`` under
``schur_method="tree"`` in both (the level route in both) at
1e-12·max(1, |x|), for R, per-cell f, p_bc and R + p_bc batches at k = 1
and 2; K7's plain scenario version against its one-scenario plain version
row by row (``torch.equal``) with batched and shared inputs; one call of
each scenario wrapper a sweep whatever S; the wrapper's shape refusals.
Every row against ``Solver.solve()`` bit for bit is
``tests/test_torch_sweep.py::test_sweep_rows_equal_solve`` (route
``"level"``).  The ``cuda``-marked test holds K7 over S on the card against
the one-scenario kernel row by row (``torch.equal``), its plain version, and
a schedule of interleaved walks and grid levels.  The JAX package is
imported only inside the test that compares with it.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import edge_data as PE
from networks_fenicsx_tpu_torch import solver as PS
from networks_fenicsx_tpu_torch.kernels import backsub, edge_data, level_eliminate

torch.set_num_threads(1)

CPU = {"device": "cpu"}
TREE = {"schur_method": "tree"}
BATCHES = ["R", "f", "p_bc", "R+p_bc"]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _assembler(pkg, n=60, N=3, k=1, seed=0, sites_seed=2):
    """An irregular forest of ``n`` sites (``keep=0.0``), per-edge R and
    per-cell f from ``default_rng(seed)``, p_bc = y − x/2."""
    G = pkg.network_generation.make_random_network(n, keep=0.0, seed=sites_seed, arrays=True)
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


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("batch", BATCHES)
def test_level_sweep_matches_jax(batch, k):
    """The irregular forest under ``schur_method="tree"``: the level route in
    both packages, the port's scenario axis, at 1e-12·max(1, |x|)."""
    import networks_fenicsx_tpu as J

    aj, _, _ = _assembler(J, k=k, seed=3)
    ap, R0, f0 = _assembler(P, k=k, seed=3)
    batches = _batches(ap, R0, f0, batch, 3, seed=4)
    xj = np.asarray(J.solve_sweep(aj, options=J.SolverOptions(**TREE), **batches).x)
    xp = P.solve_sweep(ap, options=P.SolverOptions(**TREE), **CPU, **batches).x
    ex = _executor(ap)
    assert isinstance(ex, PS._LevelExecutor) and ex.has_scenario_axis
    assert type(_executor(aj)).__name__ != "_TreeExecutor"
    _close(xp, xj, 1e-12)


def _level_case(k, S, seed, shared=()):
    """The forest's level executor and a sweep's edge data: R, f and the
    boundary pressures batched ``(S, ...)`` unless named in ``shared``."""
    asm, _, _ = _assembler(P, k=k, seed=seed)
    ex = PS.build_schur_executor(asm, P.SolverOptions(**TREE), device="cpu", elide_zero_f=False)
    assert isinstance(ex, PS._LevelExecutor)
    R0, f0, sp0, ep0 = ex.upload(*asm.schur_arguments())
    rng = np.random.default_rng(seed + 1)

    def batch(name, t, lo, hi, mask=None):
        if name in shared:
            return t
        v = torch.as_tensor(rng.uniform(lo, hi, (S,) + tuple(t.shape)))
        return v * mask if mask is not None else v

    dlp = ex.device_plan
    R = batch("R", R0, 0.5, 2.0)
    f = batch("f", f0, -1.0, 1.0)
    sp = batch("sp", sp0, -1.0, 1.0, (dlp.start_bif < 0).double())
    ep = batch("ep", ep0, -1.0, 1.0, (dlp.end_bif < 0).double())
    ed = edge_data.edge_data_scenarios(dlp, ex._N, ex._k, ex._h_e, ex._quad_w, ex._quad_phi, R, f,
                                       ex._R_mode, ex._f_mode, ex._f_is_zero, sp, ep)
    return ex, ed


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("shared", [(), ("R",), ("f", "sp", "ep"), ("R", "sp", "ep")])
@pytest.mark.parametrize("k", [1, 2])
def test_level_scenario_plain_equals_rows(k, shared, S):
    """``level_eliminate_scenarios`` (its plain version on the CPU) row by row
    is ``level_eliminate_plain`` of that row, ``torch.equal``, with shared
    inputs read as one row."""
    ex, ed = _level_case(k, S, seed=k + 5 * S, shared=shared)
    dlp = ex.device_plan
    lam, norm = level_eliminate.level_eliminate_scenarios(dlp, ed)
    plain = level_eliminate.level_eliminate_scenarios_plain(dlp, ed)
    assert lam.shape == (S, dlp.num_bifurcations) and norm.shape == (S,)
    assert torch.equal(lam, plain[0]) and torch.equal(norm, plain[1])
    for i in range(S):
        row = PE.scenario_row(ed, i)
        one = level_eliminate.level_eliminate_plain(dlp, row)
        assert torch.equal(lam[i], one[0]) and torch.equal(norm[i], one[1]), i


def test_level_scenario_shapes_raise():
    ex, ed = _level_case(1, 3, seed=0)
    dlp = ex.device_plan
    with pytest.raises(ValueError, match="W \\(S, E\\)"):
        level_eliminate.level_eliminate_scenarios(dlp, PE.scenario_row(ed, 0))
    with pytest.raises(ValueError, match="g must be"):
        level_eliminate.level_eliminate_scenarios(dlp, ed._replace(g=ed.g[:2]))
    with pytest.raises(ValueError, match="scenarios"):
        level_eliminate.level_eliminate_scenarios(dlp, ed._replace(start_pbc=ed.start_pbc[:2]))
    with pytest.raises(ValueError, match="expected"):
        level_eliminate.level_eliminate_scenarios(dlp, ed._replace(end_pbc=ed.end_pbc[:, :-1]))


LEVEL_CALLS = {"edge_data_scenarios": 1, "level_eliminate_scenarios": 1, "backsub_scenarios": 1}


@pytest.mark.parametrize("S", [1, 4, 9])
def test_level_sweep_launches_independent_of_S(monkeypatch, S):
    """A level sweep calls each scenario wrapper once whatever S, and no
    one-scenario wrapper; K7's kernel launches a call are the plan's alone
    (``level_eliminate.cuda_launches``: no S in it)."""
    asm, R0, f0 = _assembler(P, seed=S)
    calls = {}
    for mod, names in ((edge_data, ("edge_data_scenarios", "edge_data")),
                       (level_eliminate, ("level_eliminate_scenarios", "level_eliminate")),
                       (backsub, ("backsub_scenarios", "backsub"))):
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, name, counted)
    opts = P.SolverOptions(**TREE)
    for batch in ("R", "f", "p_bc"):
        calls.clear()
        P.solve_sweep(asm, options=opts, **CPU, **_batches(asm, R0, f0, batch, S, seed=S))
        assert calls == LEVEL_CALLS, (batch, calls)
    dlp = _executor(asm).device_plan
    assert level_eliminate.cuda_launches(dlp) == 2 + dlp.walk.launches


@pytest.mark.cuda
def test_level_scenario_kernels_on_card(monkeypatch):
    """On a CUDA device: K7 over S against the one-scenario kernel row by
    row (``torch.equal``, λ and the norm), against its plain version at
    1e-12·scale, its kernels enqueued equal to one call's; with the walks cut
    at 2 levels wide (grid levels between the walks); and a sweep's rows
    against ``Solver.solve()`` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for walk_max in (level_eliminate.WALK_MAX, 2):
        monkeypatch.setattr(level_eliminate, "WALK_MAX", walk_max)
        for k in (1, 2):
            for S in (1, 5):
                asm, _, _ = _assembler(P, n=200, k=k, seed=S)
                ex = PS.build_schur_executor(asm, P.SolverOptions(**TREE), device=dev,
                                             elide_zero_f=False)
                R0, f0, sp0, ep0 = ex.upload(*asm.schur_arguments())
                scales = torch.linspace(0.5, 2.0, S, dtype=torch.float64, device=dev)
                R = (R0[None] * scales[:, None]).contiguous()
                dlp = ex.device_plan
                ed = edge_data.edge_data_scenarios(dlp, ex._N, ex._k, ex._h_e, ex._quad_w,
                                                   ex._quad_phi, R, f0, ex._R_mode, ex._f_mode,
                                                   ex._f_is_zero, sp0, ep0)
                before = level_eliminate.level_eliminate_scenarios.device
                lam, norm = level_eliminate.level_eliminate_scenarios(dlp, ed)
                assert (level_eliminate.level_eliminate_scenarios.device - before
                        == level_eliminate.cuda_launches(dlp) - 1)  # K6's launch is segsum's
                for i in range(S):
                    row = PE.scenario_row(ed, i)
                    one = level_eliminate.level_eliminate(dlp, row)
                    assert torch.equal(lam[i], one[0]) and torch.equal(norm[i], one[1]), i
                    ref = level_eliminate.level_eliminate_plain(dlp, row)
                    scale = max(1.0, float(ref[0].abs().max()))
                    assert float((lam[i] - ref[0]).abs().max()) <= 1e-12 * scale
    monkeypatch.setattr(level_eliminate, "WALK_MAX", 128)
    asm, R0, f0 = _assembler(P, n=300, seed=9)
    opts = P.SolverOptions(**TREE)
    Rb = R0[None] * np.linspace(0.5, 2.0, 4)[:, None]
    res = P.solve_sweep(asm, R=Rb, options=opts, device=dev)
    for i in range(4):
        asm.compute_forms(p_bc_ex=lambda x: x[1] - 0.5 * x[0], R=Rb[i], f=f0)
        s = P.Solver(asm, options=opts, device=dev)
        s.solve()
        assert np.array_equal(s.solution_vector(), res.x[i]), i
