"""The min-degree core elimination of the PyTorch port against the JAX reference.

Host planners — ``plan_core_elimination`` (default, forced sparse, nested
dissection with a dense tail or supernodal fronts, and its refusals),
``nested_dissection_order`` and ``attach_core_plan`` — must give plans equal
to the reference's array for array, dtypes included.  The plain PyTorch
versions of the kernels must equal the reference's JAX functions on the
same inputs made from a seed:

* K12a (:mod:`~networks_fenicsx_tpu_torch.kernels.core_elim`): the rounds'
  slot values and pivot inverses against ``_core_factor`` at 1e-12·scale
  (exact float64, unpivoted); the solve against ``core_eliminate`` at
  1e-10·scale with a dense tail (the reference factors it in float32 and
  refines) and at 1e-12·scale without one;
* K12b (:mod:`~networks_fenicsx_tpu_torch.kernels.core_fronts`) on a
  forced-fronts plan against ``core_eliminate`` at 1e-12·scale, NaN in both
  when a pivot collapses;
* K11 (:mod:`~networks_fenicsx_tpu_torch.kernels.dense_core`) at 513–2,304
  nodes against ``scaled_cholesky_solve`` at 1e-10·scale, NaN when singular.

Scale is ``max(1, max |reference|)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu.ops import core_elim as JCE
from networks_fenicsx_tpu.ops import mixed_precision as JMP
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch.kernels import core_elim, core_fronts, dense_core
from networks_fenicsx_tpu_torch.ops import core_elim as PCE

from _torch_cases import assert_plans_equal

torch.set_num_threads(1)


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


GRAPHS = {
    # the reference's mid-size web (__graft_entry__.py:244-252)
    "web2k": lambda g: g.make_random_network(2000, keep=0.7, num_boundary=8, seed=5, arrays=True),
    # the production-size bed (tests/test_vascular_bed.py:101)
    "bed4": lambda g: g.make_vascular_bed(4, 32, 20, arrays=True),
    "web2000": lambda g: g.make_random_network(2000, keep=0.05, seed=7, arrays=True),
    "web150": lambda g: g.make_random_network(150, keep=0.6, seed=9, arrays=True),
    "grid24": lambda g: g.make_grid(24, 24, arrays=True),
    "grid40": lambda g: g.make_grid(40, 40, arrays=True),
}

_CORES: dict = {}


def _core(name):
    """``(core_pairs, n_core)`` of a graph's cycle core (port planner)."""
    if name not in _CORES:
        mesh = P.NetworkMesh(GRAPHS[name](P.network_generation), N=1, color_strategy="fast")
        tp = PL._plan_tree_elimination(P.HydraulicNetworkAssembler(mesh))
        _CORES[name] = (np.asarray(tp.core_pairs), tp.core_size)
    return _CORES[name]


def _nd_fronts(name, leaf=8, **kw):
    cp, n = _core(name)
    return dict(order=PCE.nested_dissection_order(cp, n, leaf=leaf), **kw)


# the forced-fronts plans of the reference's tests (test_core_elim.py:346, :387)
FRONTS_40 = dict(dense_cutoff=64, kcap=24, dense_cap=16, supernodal_tail=True, front_max=37,
                 tail_stop=False)
FRONT_CAP_24 = dict(dense_cutoff=32, kcap=8, dense_cap=8, supernodal_tail=True, front_max=16,
                    front_cap=24, tail_stop=False)

PLAN_CASES = {
    "web2k-default": ("web2k", {}),
    "bed4-default": ("bed4", {}),
    "web2000-default": ("web2000", {}),
    "web150-forced": ("web150", dict(dense_cutoff=8, tail_stop=False)),
    "web150-no-tail": ("web150", dict(dense_cutoff=0, tail_stop=False)),
    "grid40-nd-tail": ("grid40", dict(dense_cutoff=64, kcap=64, tail_stop=False, nd=8)),
    "grid40-fronts": ("grid40", dict(FRONTS_40, nd=8)),
}


def _plan_kwargs(name, kw):
    kw = dict(kw)
    leaf = kw.pop("nd", None)
    if leaf is not None:
        kw = _nd_fronts(name, leaf=leaf, **kw)
    return kw


def _plans(case):
    name, kw = PLAN_CASES[case]
    cp, n = _core(name)
    kw = _plan_kwargs(name, kw)
    return JCE.plan_core_elimination(cp, n, **kw), PCE.plan_core_elimination(cp, n, **kw)


# ------------------------------------------------------------------ host planners


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_core_elimination_equal(case):
    pj, pp = _plans(case)
    assert pj is not None and pp is not None
    assert_plans_equal(pj, pp)
    assert pj.stats == pp.stats and pj.index_bytes == pp.index_bytes


def test_plan_sizes_of_the_mid_size_web():
    """The reference's 2k-junction web: 7 rounds of the stated (S, K), a
    628-node dense tail, 9,933 value slots of which 5,156 are fill."""
    _, pp = _plans("web2k-default")
    assert pp.n_core == 1994
    assert [rd.nbr_node.shape for rd in pp.rounds] == [
        (584, 4), (153, 4), (258, 5), (167, 6), (35, 6), (90, 7), (79, 8)]
    assert (pp.n_slots, pp.fill_slots, pp.mu_all, pp.dense_nodes.size) == (9933, 5156, 11584, 628)


@pytest.mark.parametrize("leaf", [4, 8, 64])
def test_nested_dissection_order_equal(leaf):
    cp, n = _core("grid40")
    want = JCE.nested_dissection_order(cp, n, leaf=leaf)
    got = PCE.nested_dissection_order(cp, n, leaf=leaf)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("refusal", ["front_cap", "fill_budget"])
def test_planner_refusals_equal(refusal):
    """A front outgrowing ``front_cap`` (``test_core_elim.py:387``), and fill
    beyond the budget: both planners return None."""
    if refusal == "front_cap":
        cp, n = _core("grid24")
        kw = _nd_fronts("grid24", **FRONT_CAP_24)
    else:
        cp, n = _core("grid40")
        kw = dict(max_fill_ratio=0.5, max_slots=n)
    assert JCE.plan_core_elimination(cp, n, **kw) is None
    assert PCE.plan_core_elimination(cp, n, **kw) is None


@pytest.mark.parametrize("name,kw", [
    ("bed4", {}), ("web2000", {}), ("web150", dict(dense_cutoff=8, tail_stop=False)),
])
def test_attach_core_plan_equal(name, kw):
    """The attached plan of ``attach_core_plan`` — its min-degree branch
    for cores of at most 2,048 nodes — equals the reference's."""
    mesh_j = P.NetworkMesh(GRAPHS[name](P.network_generation), N=1, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh_j)
    tp = PL._plan_tree_elimination(asm)
    import networks_fenicsx_tpu as J

    aj = J.HydraulicNetworkAssembler(J.NetworkMesh(GRAPHS[name](J.network_generation), N=1,
                                                   color_strategy="fast"))
    pj = JS.attach_core_plan(JS._plan_tree_elimination(aj), **kw)
    pp = PL.attach_core_plan(tp, **kw)
    assert isinstance(pp.core_plan, PCE.CoreElimPlan)
    assert_plans_equal(pj.core_plan, pp.core_plan)
    assert PL.attach_core_plan(pp) is pp  # a plan is attached once


@pytest.mark.parametrize("refused", [("plain",), ("plain", "front_stop")])
def test_attach_core_plan_nested_dissection_branch(monkeypatch, refused):
    """Above 4,096 nodes, when the multifrontal and the plain min-degree
    planners refuse, ``attach_core_plan`` plans on a nested-dissection order
    (and retries without the front stop when that refuses too): a 70²
    lattice core of 4,900 nodes, both planners refusing as told."""
    import networks_fenicsx_tpu as J
    from networks_fenicsx_tpu.ops import multifrontal as JMF
    from networks_fenicsx_tpu_torch.ops import multifrontal as PMF

    def refusing(real):
        def plan(*args, **kw):
            if "order" not in kw and "plain" in refused:
                return None
            if kw.get("front_stop", True) and "order" in kw and "front_stop" in refused:
                return None
            return real(*args, **kw)
        return plan

    for mf, ce in ((JMF, JCE), (PMF, PCE)):
        monkeypatch.setattr(mf, "plan_multifrontal", lambda *a, **k: None)
        monkeypatch.setattr(ce, "plan_core_elimination", refusing(ce.plan_core_elimination))
    plans = []
    for pkg, S in ((J, JS), (P, PL)):
        mesh = pkg.NetworkMesh(pkg.network_generation.make_grid(70, 70, arrays=True), N=1,
                               color_strategy="fast")
        tp = S._plan_tree_elimination(pkg.HydraulicNetworkAssembler(mesh))
        assert tp.core_size == 4900
        plans.append(S.attach_core_plan(tp).core_plan)
    pj, pp = plans
    assert isinstance(pp, PCE.CoreElimPlan)
    assert_plans_equal(pj, pp)


def test_device_core_plan_offsets():
    """The device plan's tensors are the plan's int32 arrays and its offsets
    partition the saved round streams and the front buffer."""
    _, pp = _plans("grid40-fronts")
    dcp = PCE.device_core_plan(pp, "cpu")
    assert dcp.a_len == sum(rd.nbr_node.size for rd in pp.rounds)
    assert dcp.s_len == sum(rd.elim.size for rd in pp.rounds)
    for rd, drd in zip(pp.rounds, dcp.rounds):
        assert drd.elim.dtype == torch.int32 and np.array_equal(drd.nbr_node.numpy(), rd.nbr_node)
        assert drd.u_off == rd.u_off and len(drd.d_fold) == len(rd.d_fold)
    offs = [0]
    for fr in pp.fronts:
        m = fr.nodes.size + fr.bnd.size
        offs.append(offs[-1] + m * m)
    assert [fr.f_off for fr in dcp.fronts] == offs[:-1] and dcp.f_len == offs[-1]
    for fr, dfr in zip(pp.fronts, dcp.fronts):
        for (cid, _), row in zip(fr.consume, dfr.cons):
            src = pp.fronts[cid]
            assert tuple(row) == (offs[cid], src.nodes.size + src.bnd.size, src.nodes.size)


# ------------------------------------------------------------------ numeric phase


def _spd_system(case, seed):
    """Seeded ``(dc, w_pairs, rc)`` of a diagonally dominant core system."""
    name, _ = PLAN_CASES[case]
    cp, n = _core(name)
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, int(cp[:, 2].max()) + 3)
    dc = rng.uniform(0.05, 0.5, n)
    np.add.at(dc, cp[:, 0], w[cp[:, 2]])
    np.add.at(dc, cp[:, 1], w[cp[:, 2]])
    return dc, w, rng.standard_normal(n)


def _reference(pj, dc, w, rc):
    state = jax.jit(lambda d, ww: JCE._core_factor(pj, d, ww))(jnp.asarray(dc), jnp.asarray(w))
    lam = jax.jit(lambda st, r: JCE._core_apply(pj, st, r))(state, jnp.asarray(rc))
    return state, np.asarray(lam)


@pytest.mark.parametrize("case,tol", [
    ("web2k-default", 1e-10), ("web150-no-tail", 1e-12), ("grid40-nd-tail", 1e-10),
])
def test_core_elim_plain_matches_reference(case, tol):
    """K12a: every round's (a, inv) at 1e-12·scale, the solve at ``tol``."""
    pj, pp = _plans(case)
    dc, w, rc = _spd_system(case, seed=3)
    state, want = _reference(pj, dc, w, rc)
    dcp = PCE.device_core_plan(pp, "cpu")
    st = core_elim.core_factor_plain(dcp, _t(dc), _t(w))
    assert len(st.rounds) == len(state["rounds"]) == len(pp.rounds) > 0
    for (a, inv), (a_j, inv_j) in zip(st.rounds, state["rounds"]):
        _close(a, a_j, 1e-12)
        _close(inv, inv_j, 1e-12)
    _close(core_elim.core_apply_plain(dcp, st, _t(w), _t(rc)), want, tol)
    _close(core_elim.core_elim(dcp, _t(dc), _t(w), _t(rc)), want, tol)
    if pp.dense_nodes.size:  # the tail's matrix is the reference's
        from networks_fenicsx_tpu_torch.kernels import fold

        d = st.d[dcp.dense_nodes.long()]
        ov = core_elim.init_values_plain(dcp, _t(w))[dcp.dp_init.long()]
        if dcp.dp_fold:
            ov = ov - fold.fold_apply_plain(st.ustream, dcp.dp_fold)
        Lc = dense_core.assemble_core(dcp.dense_di, dcp.dense_dj, dcp.dense_pid, d, -ov)
        _close(Lc, state["dense"]["Lc"], 1e-12)


def test_core_fronts_plain_matches_reference():
    """K12b on the forced-fronts plan of a 40² lattice core: 16 fronts, an
    extend-add chain; exact float64 in both, so 1e-12·scale."""
    pj, pp = _plans("grid40-fronts")
    assert len(pp.fronts) == 16 and any(fr.consume for fr in pp.fronts)
    dc, w, rc = _spd_system("grid40-fronts", seed=4)
    _, want = _reference(pj, dc, w, rc)
    got = core_elim.core_elim(PCE.device_core_plan(pp, "cpu"), _t(dc), _t(w), _t(rc))
    _close(got, want, 1e-12)


def test_core_fronts_gate_gives_nan_in_both():
    """A negative diagonal collapses a front's pivot: NaN everywhere."""
    pj, pp = _plans("grid40-fronts")
    dc, w, rc = _spd_system("grid40-fronts", seed=5)
    dc[int(pp.fronts[3].nodes[0])] = -50.0
    _, want = _reference(pj, dc, w, rc)
    got = core_elim.core_elim(PCE.device_core_plan(pp, "cpu"), _t(dc), _t(w), _t(rc))
    assert np.isnan(want).all() and torch.isnan(got).all()


def test_front_factor_is_the_schur_complement():
    """K12b's factor: ``L`` of ``F_SS``, ``Y = L⁻¹F_SB`` and the symmetric
    ``U = F_BB − F_BS F_SS⁻¹ F_SB``."""
    rng = np.random.default_rng(6)
    w, b = 7, 5
    M = rng.standard_normal((w + b, w + b))
    F = M @ M.T + (w + b) * np.eye(w + b)
    L, Y, U, ok = core_fronts.front_factor_plain(_t(F), w)
    assert bool(ok)
    S, SB, BB = F[:w, :w], F[:w, w:], F[w:, w:]
    np.testing.assert_allclose(L.numpy() @ L.numpy().T, S, atol=1e-12)
    np.testing.assert_allclose(Y.numpy(), np.linalg.solve(np.linalg.cholesky(S), SB), atol=1e-12)
    np.testing.assert_allclose(U.numpy(), BB - SB.T @ np.linalg.solve(S, SB), atol=1e-12)
    assert np.array_equal(U.numpy(), U.numpy().T)


@pytest.mark.parametrize("n", [513, 1200, 2304])
def test_dense_core_plain_at_mid_sizes(n):
    """K11 above the old 512-node envelope: a seeded lattice-like Laplacian,
    against the reference's ``scaled_cholesky_solve``, with core pairs and
    with given negated pair values (the dense tail's form: ``pid = 0, 1, …``),
    and one unrefined pass against the exact solve."""
    rng = np.random.default_rng(n)
    side = int(np.sqrt(n))
    i = np.arange(n)
    ci = np.concatenate([i[:-1], i[:-side]]).astype(np.int32)
    cj = np.concatenate([i[1:], i[side:]]).astype(np.int32)
    w = rng.uniform(0.5, 2.0, ci.size)
    dc = rng.uniform(0.01, 0.1, n)
    np.add.at(dc, ci, w)
    np.add.at(dc, cj, w)
    rc = rng.standard_normal(n)
    Lc = np.diag(dc)
    Lc[ci, cj] = Lc[cj, ci] = -w
    want = JMP.scaled_cholesky_solve(JMP.scaled_cholesky_factor(jnp.asarray(Lc)), jnp.asarray(rc))
    pairs = (_t(ci, torch.int32), _t(cj, torch.int32))
    pid = _t(np.arange(ci.size), torch.int32)
    got = dense_core.dense_core(*pairs, pid, _t(dc), _t(rc), _t(w))
    _close(got, want, 1e-10)
    perm = rng.permutation(ci.size)  # the same pairs through scattered ids
    w_perm = np.empty_like(w)
    w_perm[perm] = w
    got_p = dense_core.dense_core(*pairs, _t(perm, torch.int32), _t(dc), _t(rc), _t(w_perm))
    assert torch.equal(got, got_p)
    _close(dense_core.dense_core(*pairs, pid, _t(dc), _t(rc), _t(w), n_refine=0),
           np.linalg.solve(Lc, rc), 1e-12)


def test_dense_tail_singular_gives_nan():
    """A dense tail with a zero pivot (two nodes coupled only to each other
    with no diagonal excess): NaN from the plain version and the reference."""
    n = 600
    ci = np.arange(0, n - 1, 2, dtype=np.int32)
    cj = ci + 1
    dc = np.full(n, 1.0)
    vals = np.full(ci.size, -1.0)
    Lc = np.diag(dc)
    Lc[ci, cj] = Lc[cj, ci] = vals
    rc = np.ones(n)
    want = np.asarray(JMP.scaled_cholesky_solve(JMP.scaled_cholesky_factor(jnp.asarray(Lc)),
                                                jnp.asarray(rc)))
    got = dense_core.dense_core(_t(ci, torch.int32), _t(cj, torch.int32),
                                _t(np.arange(ci.size), torch.int32), _t(dc), _t(rc), _t(-vals))
    assert np.isnan(want).all() and torch.isnan(got).all()


def test_core_wrappers_never_fall_back_off_the_cpu():
    """CPU tensors run the plain versions without counting a launch; any
    other device goes to the kernel path, which validates and raises."""
    from networks_fenicsx_tpu_torch import kernels

    kernels.reset_launches()
    _, pp = _plans("grid40-fronts")
    dcp = PCE.device_core_plan(pp, "cpu")
    dc, w, rc = _spd_system("grid40-fronts", seed=7)
    core_elim.core_elim(dcp, _t(dc), _t(w), _t(rc))
    assert all(n == 0 for n in kernels.launches().values())
    meta = torch.ones(dcp.n_core, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        core_elim.core_elim(dcp, meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        core_fronts.core_fronts(dcp, meta, meta, meta, meta)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dense_core.dense_core(idx, idx, idx, meta, meta, meta)
    assert all(n == 0 for n in kernels.launches().values())


def test_launch_counts_follow_the_plan():
    """The hand count of CUDA launches (what ``chip_smoke.py`` prints beside
    the profiler's) grows with the rounds, the fronts and the tail."""
    _, pp = _plans("web2k-default")
    dcp = PCE.device_core_plan(pp, "cpu")
    n = core_elim.cuda_launches(dcp)
    tail = dense_core.cuda_launches(628, int(dcp.dp_init.shape[0]))
    assert n > tail > 2 * dense_core.tiled_solve_launches(628) * (1 + dense_core.N_REFINE)
    _, pf = _plans("grid40-fronts")
    assert core_elim.cuda_launches(PCE.device_core_plan(pf, "cpu")) > 16 * 6


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_core_kernels_match_plain_on_card():
    """On a CUDA device: K12a (web2k's plan, and one without a dense tail),
    K12b (the forced fronts) and K11 (628 and 2,304 nodes) equal their plain
    versions (``pytest -m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for case, tol in (("web2k-default", 1e-12), ("web150-no-tail", 1e-12),
                      ("grid40-fronts", 1e-12)):
        _, pp = _plans(case)
        dcp = PCE.device_core_plan(pp, dev)
        dc, w, rc = (_t(a).to(dev) for a in _spd_system(case, seed=8))
        got = core_elim.core_elim(dcp, dc, w, rc)
        want = core_elim.core_elim_plain(dcp, dc, w, rc)
        _close(got.cpu(), want.cpu().numpy(), tol)
        if pp.dense_nodes.size:  # one unrefined pass, which refinement would hide
            _close(core_elim.core_elim(dcp, dc, w, rc, n_refine=0).cpu(),
                   core_elim.core_elim_plain(dcp, dc, w, rc, n_refine=0).cpu().numpy(), tol)
    for n, tol in ((628, 1e-12), (2304, 1e-10)):
        rng = np.random.default_rng(n)
        i = np.arange(n)
        side = int(np.sqrt(n))
        ci = np.concatenate([i[:-1], i[:-side]]).astype(np.int32)
        cj = np.concatenate([i[1:], i[side:]]).astype(np.int32)
        w = rng.uniform(0.5, 2.0, ci.size)
        dc = rng.uniform(0.01, 0.1, n)
        np.add.at(dc, ci, w)
        np.add.at(dc, cj, w)
        args = (_t(ci, torch.int32).to(dev), _t(cj, torch.int32).to(dev),
                _t(np.arange(ci.size), torch.int32).to(dev), _t(dc).to(dev),
                _t(rng.standard_normal(n)).to(dev), _t(w).to(dev))
        _close(dense_core.dense_core(*args).cpu(), dense_core.dense_core_plain(*args).cpu().numpy(),
               tol)
    torch.cuda.synchronize()
