"""The cyclic (peel-then-core) path of the PyTorch port against the JAX reference.

Host planners — the tree plan, the attached multifrontal plan, the
nested-dissection tree, the fold plans, the λ-system plan and the lattice
check — must give ``np.array_equal`` results on the same graphs.  The plain
PyTorch versions of the cyclic kernels must equal the reference's JAX
functions on the same inputs made from a seed:

* K10 (:mod:`~networks_fenicsx_tpu_torch.kernels.fold`) against
  ``_fold_apply`` at 1e-12·scale;
* K9 (:mod:`~networks_fenicsx_tpu_torch.kernels.peel`) against
  ``_lambda_system_sorted`` and ``_tree_eliminate`` at 1e-12·scale;
* K11 (:mod:`~networks_fenicsx_tpu_torch.kernels.dense_core`) against
  ``scaled_cholesky_solve`` at 1e-10·scale, NaN in both when singular, and
  its unrefined float64 solve against ``numpy.linalg.solve``;
* K13 against ``inv(cholesky)`` at 1e-12 and ``chol_inverse_batched`` at
  its own 2e-4;
* K14 + K15 against ``_mf_factor``/``_mf_apply`` and SciPy's ``splu`` at
  1e-11 relative, unrefined and refined.

Scale is ``max(1, max |reference|)``.  The port factors in float64 where the
reference factors in float32 and refines; both refine to the tolerances
above.
"""

import dataclasses
import functools
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
from networks_fenicsx_tpu.ops import multifrontal as JMF
from networks_fenicsx_tpu_torch import lattice as PLat
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch import tree as PT
from networks_fenicsx_tpu_torch.edge_data import _EdgeData
from networks_fenicsx_tpu_torch.kernels import dense_core, fold, mf_apply, mf_factor, peel, segsum
from networks_fenicsx_tpu_torch.ops import core_elim as PCE
from networks_fenicsx_tpu_torch.ops import multifrontal as PMF

from _torch_cases import assert_plans_equal, golden_graph

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
    "web48": (lambda pkg: golden_graph(pkg, "web48"), "scalar"),
    "grid5x4": (lambda pkg: golden_graph(pkg, "grid5x4"), "scalar"),
    "bed3": (lambda pkg: pkg.network_generation.make_vascular_bed(3, 12, 8, arrays=True), "edge"),
    "web2600": (lambda pkg: pkg.network_generation.make_random_network(
        2600, keep=0.7, seed=3, arrays=True), "edge"),
    "grid52": (lambda pkg: pkg.network_generation.make_grid(52, 52, arrays=True), "edge"),
    "grid24": (lambda pkg: pkg.network_generation.make_grid(24, 24, arrays=True), "scalar"),
}
MF_GRAPHS = ("web2600", "grid52")  # cores above 2,048 nodes


@functools.cache
def _assemblers(name):
    """(reference, port) assemblers of one graph at N = 1: scalar R, or
    per-edge R from a seed."""
    graph_fn, R_mode = GRAPHS[name]
    out = []
    for pkg in (J, P):
        mesh = pkg.NetworkMesh(graph_fn(pkg), N=1, color_strategy="fast")
        asm = pkg.HydraulicNetworkAssembler(mesh)
        R = None if R_mode == "scalar" else np.random.default_rng(7).uniform(0.5, 2.0, mesh.num_edges)
        asm.compute_forms(p_bc_ex=lambda x: x[0], R=R)
        out.append(asm)
    return tuple(out)


def _web(pkg, n, seed=7):
    return pkg.network_generation.make_random_network(n, keep=0.05, seed=seed, arrays=True)


# ------------------------------------------------------------------ host planners


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tree_plan_equal(name):
    aj, ap = _assemblers(name)
    for force in (False, True):
        pj = JS._plan_tree_elimination(aj, force_rounds=force)
        pp = PL._plan_tree_elimination(ap, force_rounds=force)
        for field in ("pair_nodes", "edge_pair", "core_nodes", "core_pairs"):
            assert np.array_equal(getattr(pj, field), getattr(pp, field)), (field, force)
        assert len(pj.rounds) == len(pp.rounds)
        for rj, rp in zip(pj.rounds, pp.rounds):
            assert all(np.array_equal(a, b) for a, b in zip(rj, rp))
        assert pp.core_size > 0


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_lambda_plan_equal(name):
    aj, ap = _assemblers(name)
    lj, lp = JS._build_lambda_plan(aj), PL._build_lambda_plan(ap)
    for field in lj._fields:
        a, b = getattr(lj, field), getattr(lp, field)
        assert np.array_equal(a, b) and a.dtype == b.dtype, field


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_lattice_check_equal(name):
    aj, ap = _assemblers(name)
    want = JS.lattice_solve_applicable(aj)
    assert PLat.lattice_solve_applicable(ap) == want
    assert want == (name in ("grid5x4", "grid24"))  # the scalar-R lattices


def _assert_mf_plans_equal(mj, mp):
    assert mj is not None and mp is not None
    for field in ("n_core", "n_pairs", "lam_len", "n_refine"):
        assert getattr(mj, field) == getattr(mp, field), field
    assert len(mj.groups) == len(mp.groups)
    for gj, gp in zip(mj.groups, mp.groups):
        assert tuple(gj) == tuple(gp)
    for field in ("init_slot", "nodes_all", "cval_all", "ccol_all", "bndpos_all", "cidx_all",
                  "lminv_all", "lam_pos", "pci", "pcj", "mv_inv_i", "mv_inv_j"):
        a, b = getattr(mj, field), getattr(mp, field)
        assert np.array_equal(a, b) and a.dtype == b.dtype, field
    for field in ("mv_fold_i", "mv_fold_j"):
        a, b = getattr(mj, field), getattr(mp, field)
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), field
    assert mj.stats == mp.stats


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_attached_core_plan_equal(name):
    """A core above 2,048 nodes attaches the reference's multifrontal plan,
    buffer for buffer; a smaller one the reference's min-degree plan, field
    by field."""
    aj, ap = _assemblers(name)
    pj = JS.attach_core_plan(JS._plan_tree_elimination(aj))
    pp = PL._cached_tree_plan(ap, attach=True)
    if name in MF_GRAPHS:
        assert isinstance(pj.core_plan, JMF.MFPlan)
        assert isinstance(pp.core_plan, PMF.MFPlan)
        _assert_mf_plans_equal(pj.core_plan, pp.core_plan)
        # the force_rounds variant shares the attached plan
        assert PL._cached_tree_plan(ap, force_rounds=True, attach=True).core_plan is pp.core_plan
    else:
        assert isinstance(pj.core_plan, JCE.CoreElimPlan)
        assert isinstance(pp.core_plan, PCE.CoreElimPlan)
        assert pp.core_plan.n_core == pp.core_size
        assert_plans_equal(pj.core_plan, pp.core_plan)


@pytest.mark.parametrize("leaf", [4, 16, 64])
@pytest.mark.parametrize("name", ["web48", "grid5x4", "bed3", "web2600", "grid52"])
def test_nd_tree_equal(name, leaf):
    _, ap = _assemblers(name)
    tp = PL._plan_tree_elimination(ap)
    cp = np.asarray(tp.core_pairs)
    pj, kj = JMF.build_nd_tree(cp, tp.core_size, leaf=leaf)
    pp, kp = PMF.build_nd_tree(cp, tp.core_size, leaf=leaf)
    assert kj == kp
    assert len(pj) == len(pp) and all(np.array_equal(a, b) for a, b in zip(pj, pp))


@pytest.mark.parametrize("leaf", [4, 16])
@pytest.mark.parametrize("name", ["web48", "bed3"])
def test_forced_multifrontal_plan_equal(name, leaf):
    """Many tiny groups: the multifrontal planner on a small core."""
    _, ap = _assemblers(name)
    tp = PL._plan_tree_elimination(ap)
    cp = np.asarray(tp.core_pairs)
    _assert_mf_plans_equal(JMF.plan_multifrontal(cp, tp.core_size, leaf=leaf),
                           PMF.plan_multifrontal(cp, tp.core_size, leaf=leaf))


def test_multifrontal_refusals_equal():
    _, ap = _assemblers("grid52")
    tp = PL._plan_tree_elimination(ap)
    cp = np.asarray(tp.core_pairs)
    for kw in (dict(leaf=8, front_cap=12), dict(leaf=8, max_groups=2)):
        assert JMF.plan_multifrontal(cp, tp.core_size, **kw) is None
        assert PMF.plan_multifrontal(cp, tp.core_size, **kw) is None


@pytest.mark.parametrize("n", [1000, 5000])
def test_peel_round_folds_equal(n):
    """Every peel round's unique parents and ``_plan_fold`` levels are the
    reference's (``_tree_eliminate_factor``, ``:3703-3708``)."""
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(_web(P, n), N=1, color_strategy="fast"))
    tp = PL._plan_tree_elimination(ap)
    assert len(tp.rounds) == {1000: 11, 5000: 9}[n]
    for elim, parents, _ in tp.rounds:
        sel = np.flatnonzero(parents >= 0)
        upar, inv = np.unique(parents[sel], return_inverse=True)
        want = JCE._plan_fold(inv, upar.size, sel, int(parents.size))
        got_upar, got = PT.round_tables(elim, parents)
        assert np.array_equal(got_upar, upar)
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def _segments(rng, widths):
    seg = np.repeat(np.arange(len(widths)), widths)
    rng.shuffle(seg)
    return seg


@pytest.mark.parametrize("channels", [1, 2])
def test_fold_plain_matches_fold_apply(channels):
    """K10 with segments wider than ``cap = 64`` (three levels)."""
    rng = np.random.default_rng(channels)
    widths = np.concatenate([[0, 5000, 300, 1], rng.integers(1, 70, 40)])
    seg = _segments(rng, widths)
    src_len = seg.size + 17
    src = rng.permutation(src_len)[: seg.size]
    levels_j = JCE._plan_fold(seg, widths.size, src, src_len)
    levels_p = PCE._plan_fold(seg, widths.size, src, src_len)
    assert len(levels_j) == 3
    assert all(np.array_equal(a, b) for a, b in zip(levels_j, levels_p))
    tgt = rng.permutation(40)[:9]
    assert np.array_equal(JCE._inverse_map(tgt, 40, 9), PCE._inverse_map(tgt, 40, 9))
    vec = rng.standard_normal((src_len, channels)) * 100
    levels_t = tuple(_t(lv, torch.int32) for lv in levels_p)
    got = fold.fold_apply(_t(vec), levels_t)
    plan = fold.FoldPlan(levels_t)
    assert (len(plan), plan.rows, plan.src_max) == (3, widths.size, src_len)
    assert torch.equal(fold.fold_apply(_t(vec), plan), got)
    for c in range(channels):
        want = JCE._fold_apply(jnp.asarray(vec[:, c]), levels_j)
        _close(got[:, c], want, 1e-12)


def test_fold_plan_validates_at_construction():
    """A :class:`FoldPlan` checks its levels once: int32, 2-D, contiguous,
    with data on one device, each level's indices within the previous
    level's rows and its pad; on a non-CPU tensor ``fold_apply`` takes only
    a plan."""
    rng = np.random.default_rng(4)
    seg = _segments(rng, np.array([130, 3, 70]))
    levels = tuple(_t(lv, torch.int32) for lv in PCE._plan_fold(seg, 3, np.arange(seg.size),
                                                                seg.size))
    assert len(fold.FoldPlan(levels)) == 2
    with pytest.raises(ValueError, match="int32"):
        fold.FoldPlan((levels[0].long(), levels[1]))
    with pytest.raises(ValueError, match="contiguous"):
        fold.FoldPlan((levels[0].t().contiguous().t(), levels[1]))
    with pytest.raises(ValueError, match="level 1"):
        fold.FoldPlan((levels[0][:2].contiguous(), levels[1]))  # level 1 names 6 chunks
    with pytest.raises(ValueError, match="meta"):
        fold.FoldPlan(tuple(lv.to("meta") for lv in levels))
    with pytest.raises(ValueError, match="levels"):
        fold.FoldPlan(())
    meta = torch.ones(seg.size, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fold.fold_apply(meta, fold.FoldPlan(levels))


def _peel_problem(n=1000, seed=0):
    """A web's tree plans and a random SPD bifurcation system on them."""
    aj = J.HydraulicNetworkAssembler(J.NetworkMesh(_web(J, n), N=1, color_strategy="fast"))
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(_web(P, n), N=1, color_strategy="fast"))
    pj, pp = JS._plan_tree_elimination(aj), PL._plan_tree_elimination(ap)
    dtp = PT.device_tree_plan(pp, PL._build_lambda_plan(ap), ap, "cpu")
    rng = np.random.default_rng(seed)
    B, npairs = ap.network.num_multipliers, pp.pair_nodes.shape[0]
    w_pairs = rng.uniform(0.5, 2.0, npairs)
    diag = rng.uniform(0.1, 1.0, B)
    np.add.at(diag, pp.pair_nodes[:, 0], w_pairs)
    np.add.at(diag, pp.pair_nodes[:, 1], w_pairs)
    rhs = rng.standard_normal(B)
    return pj, dtp, diag, rhs, w_pairs


def test_peel_plain_matches_tree_eliminate():
    """K9 (with K10 and the dense core) on a 1,000-site web: 11 peel rounds
    and a dense core of 455."""
    pj, dtp, diag, rhs, w_pairs = _peel_problem()
    assert len(dtp.rounds) == 11 and dtp.core_size == 455
    want = jax.jit(lambda d, r, w: JS._tree_eliminate(pj, d, r, w))(
        jnp.asarray(diag), jnp.asarray(rhs), jnp.asarray(w_pairs))
    seen = {}

    def solve_core(dc, rc):
        seen["dc"] = dc
        return dense_core.dense_core(dtp.core_ci, dtp.core_cj, dtp.core_pid, dc, rc, wp)

    wp = _t(w_pairs)
    got = peel.peel(dtp, _t(np.stack([diag, rhs], 1)), wp, solve_core)
    _close(got, want, 1e-12)
    # the rounds fold the reference's eliminated diagonals into the core
    state = _factor_jit(pj, diag, w_pairs)
    _close(seen["dc"], jnp.diagonal(state["core_dense"]["Lc"]), 1e-12)


def test_lambda_system_plain_matches_reference():
    """K9's assembly of the bifurcation system (the prepare pass and two K6
    sums added into sorted unique bins) against ``_lambda_system_sorted``."""
    aj = J.HydraulicNetworkAssembler(J.NetworkMesh(_web(J, 1000), N=1, color_strategy="fast"))
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(_web(P, 1000), N=1, color_strategy="fast"))
    dtp = PT.device_tree_plan(PL._plan_tree_elimination(ap), PL._build_lambda_plan(ap), ap, "cpu")
    rng = np.random.default_rng(3)
    E, N = ap.network.num_edges, 3
    W, g = rng.uniform(0.5, 2.0, E), rng.standard_normal(E)
    cumF = rng.standard_normal((E, N + 1))
    sb, eb = ap._edge_start_bif, ap._edge_end_bif
    sp = np.where(sb < 0, rng.standard_normal(E), 0.0)
    ep = np.where(eb < 0, rng.standard_normal(E), 0.0)
    ed_j = JS._EdgeData(None, jnp.asarray(cumF), jnp.asarray(W), jnp.asarray(g), jnp.asarray(sb),
                        jnp.asarray(eb), jnp.asarray(sp), jnp.asarray(ep), ())
    ed_p = _EdgeData(None, _t(cumF.T), _t(W), _t(g), _t(sb, torch.int32), _t(eb, torch.int32),
                     _t(sp), _t(ep), ())
    d_j, r_j = JS._lambda_system_sorted(ed_j, ap.network.num_multipliers, JS._build_lambda_plan(aj))
    dr, w_edges, norm = peel.lambda_system(dtp, ed_p)
    _close(dr[:, 0], d_j, 1e-12)
    _close(dr[:, 1], r_j, 1e-12)
    _close(w_edges, 1.0 / W, 1e-12)
    _close(norm, jnp.linalg.norm(r_j), 1e-12)
    w_pairs, = segsum.segsum_plan(dtp.pair_sums, w_edges)
    pj = JS._plan_tree_elimination(aj)
    sel = np.flatnonzero(pj.edge_pair >= 0)
    ids = pj.edge_pair[sel]
    order = np.argsort(ids, kind="stable")
    want = JS._segsum_sorted(jnp.asarray(1.0 / W), ids[order], pj.pair_nodes.shape[0], sel=sel[order])
    _close(w_pairs, want, 1e-12)


def _factor_jit(pj, diag, w_pairs):
    return jax.jit(lambda d, w: JS._tree_eliminate_factor(pj, d, w))(
        jnp.asarray(diag), jnp.asarray(w_pairs))


def _core_system(seed=0):
    pj, dtp, diag, rhs, w_pairs = _peel_problem(seed=seed)
    state = _factor_jit(pj, diag, w_pairs)
    Lc = np.asarray(state["core_dense"]["Lc"])
    rc = np.random.default_rng(seed + 1).standard_normal(Lc.shape[0])
    return dtp, Lc, rc, w_pairs


def test_dense_core_plain_matches_scaled_cholesky():
    dtp, Lc, rc, w_pairs = _core_system()
    want = JMP.scaled_cholesky_solve(JMP.scaled_cholesky_factor(jnp.asarray(Lc)), jnp.asarray(rc))
    got = dense_core.dense_core(dtp.core_ci, dtp.core_cj, dtp.core_pid, _t(np.diagonal(Lc)),
                                _t(rc), _t(w_pairs))
    _close(got, want, 1e-10)
    _close(dense_core.assemble_core(dtp.core_ci, dtp.core_cj, dtp.core_pid, _t(np.diagonal(Lc)),
                                    _t(w_pairs)), Lc, 0.0)


def test_dense_core_singular_gives_nan_in_both():
    """Two nodes joined only to each other with no other conductance: a
    zero pivot, and NaN everywhere from both."""
    n = 6
    ci = np.array([0, 2, 3, 4], np.int32)
    cj = np.array([1, 3, 4, 5], np.int32)
    w = np.array([1.0, 0.5, 0.25, 0.5])
    dc = np.array([1.0, 1.0, 2.0, 2.0, 2.0, 2.0])
    Lc = np.diag(dc)
    Lc[ci, cj] = Lc[cj, ci] = -w
    rc = np.arange(1.0, n + 1)
    want = np.asarray(JMP.scaled_cholesky_solve(JMP.scaled_cholesky_factor(jnp.asarray(Lc)),
                                                jnp.asarray(rc)))
    got = dense_core.dense_core(_t(ci, torch.int32), _t(cj, torch.int32),
                                _t(np.arange(4), torch.int32), _t(dc), _t(rc), _t(w))
    assert np.isnan(want).all() and torch.isnan(got).all()


def test_dense_core_unrefined_is_the_float64_solve():
    """With no refinement pass K11's plain version is the float64 scaled
    Cholesky solve alone: it equals ``numpy.linalg.solve`` to roundoff."""
    dtp, Lc, rc, w_pairs = _core_system(seed=2)
    args = (dtp.core_ci, dtp.core_cj, dtp.core_pid, _t(np.diagonal(Lc)), _t(rc), _t(w_pairs))
    exact = np.linalg.solve(Lc, rc)
    _close(dense_core.dense_core(*args, n_refine=0), exact, 1e-12)
    _close(dense_core.dense_core(*args), exact, 1e-12)


@pytest.mark.parametrize("k,w", [(7, 5), (3, 33), (1, 70)])
def test_front_cholesky_matches_inverse_cholesky(k, w):
    """K13: the fronts' Cholesky factor, against ``inv(cholesky)`` at 1e-12
    and the reference's f32 ``chol_inverse_batched`` at its own 2e-4
    (``test_multifrontal.py:70-81``)."""
    rng = np.random.default_rng(k * 100 + w)
    M = rng.standard_normal((k, w, w))
    A = M @ np.swapaxes(M, 1, 2) + w * np.eye(w)
    blk, U, ok = mf_factor.front_factor_plain(_t(A), w)
    assert U is None and bool(ok)
    Li = np.linalg.inv(np.tril(blk.numpy()))
    Li_f32 = np.asarray(jax.jit(JMF.chol_inverse_batched)(jnp.asarray(A.astype(np.float32))))
    for i in range(k):
        ref = np.linalg.inv(np.linalg.cholesky(A[i]))
        np.testing.assert_allclose(Li[i], ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(Li[i], Li_f32[i], rtol=2e-4, atol=2e-4)


def test_front_update_is_the_schur_complement():
    """K14's update: ``U = F_BB − F_BS F_SS⁻¹ F_SB`` and ``Yᵀ = F_BS L⁻ᵀ``."""
    rng = np.random.default_rng(5)
    k, w, b = 3, 6, 4
    M = rng.standard_normal((k, w + b, w + b))
    F = M @ np.swapaxes(M, 1, 2) + (w + b) * np.eye(w + b)
    blk, U, ok = mf_factor.front_factor_plain(_t(F), w)
    assert bool(ok)
    for i in range(k):
        S, SB, BB = F[i, :w, :w], F[i, :w, w:], F[i, w:, w:]
        np.testing.assert_allclose(U[i].numpy(), BB - SB.T @ np.linalg.solve(S, SB), atol=1e-12)
        L = np.linalg.cholesky(S)
        np.testing.assert_allclose(blk[i, w:, :w].numpy(), np.linalg.solve(L, SB).T, atol=1e-12)
        B = blk[i].numpy()  # Lᵀ above L in the pivot block, nothing else above the diagonal
        np.testing.assert_array_equal(np.triu(B[:w, :w], 1), np.tril(B[:w, :w], -1).T)
        assert np.all(np.triu(B, 1)[:, w:] == 0.0)


def _lattice_core(n):
    idx = np.arange(n * n).reshape(n, n)
    h = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    v = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    pairs = np.concatenate([h, v], axis=0)
    return np.concatenate([pairs, np.arange(pairs.shape[0])[:, None]], axis=1), n * n


def _spd_core(core_pairs, n_core, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, core_pairs.shape[0])
    dc = np.zeros(n_core)
    np.add.at(dc, core_pairs[:, 0], w)
    np.add.at(dc, core_pairs[:, 1], w)
    return dc * 1.001 + 0.05, w, rng.standard_normal(n_core)


@pytest.mark.parametrize("n,leaf", [(9, 4), (24, 16), (40, 64)])
def test_multifrontal_plain_matches_reference_and_splu(n, leaf):
    """K14 + K15 on the lattice cores of ``test_mf_exact_vs_scipy``."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    cp, nc = _lattice_core(n)
    dc, w, rc = _spd_core(cp, nc, seed=n)
    plan_j = JMF.plan_multifrontal(cp, nc, leaf=leaf)
    state = jax.jit(JMF._mf_factor)(plan_j, jnp.asarray(dc), jnp.asarray(w))
    want = np.asarray(jax.jit(JMF._mf_apply)(plan_j, state, jnp.asarray(rc)))
    A = sp.csc_matrix(
        (np.concatenate([dc, -w, -w]),
         (np.concatenate([np.arange(nc), cp[:, 0], cp[:, 1]]),
          np.concatenate([np.arange(nc), cp[:, 1], cp[:, 0]]))),
        shape=(nc, nc),
    )
    exact = spla.splu(A).solve(rc)
    dmf = PMF.device_mf_plan(PMF.plan_multifrontal(cp, nc, leaf=leaf), "cpu")
    st = mf_factor.mf_factor(dmf, _t(dc), _t(w))
    assert int(st.ok) == 1
    got = mf_apply.mf_apply(dmf, st, _t(rc)).numpy()
    scale = np.max(np.abs(exact))
    assert np.max(np.abs(got - exact)) / scale < 1e-11
    assert np.max(np.abs(got - want)) / scale < 1e-11
    # one sweep, no refinement pass: the float64 factor alone solves to roundoff
    dmf0 = dataclasses.replace(dmf, plan=dmf.plan._replace(n_refine=0))
    one = mf_apply.mf_apply(dmf0, st, _t(rc)).numpy()
    assert np.max(np.abs(one - exact)) / scale < 1e-11


def test_multifrontal_indefinite_core_gives_nan():
    cp, nc = _lattice_core(9)
    dc, w, rc = _spd_core(cp, nc, seed=1)
    dc[40] = -5.0
    dmf = PMF.device_mf_plan(PMF.plan_multifrontal(cp, nc, leaf=4), "cpu")
    st = mf_factor.mf_factor(dmf, _t(dc), _t(w))
    assert int(st.ok) == 0
    assert torch.isnan(mf_apply.mf_apply(dmf, st, _t(rc))).all()


def test_cyclic_wrappers_never_fall_back_off_the_cpu():
    """CPU tensors run the plain versions without counting a launch; any
    other device goes to the kernel path, which validates and raises."""
    from networks_fenicsx_tpu_torch import kernels

    kernels.reset_launches()
    _, dtp, diag, rhs, w_pairs = _peel_problem(n=300)
    dr, wp = _t(np.stack([diag, rhs], 1)), _t(w_pairs)
    peel.peel(dtp, dr, wp, lambda dc, rc: dense_core.dense_core(
        dtp.core_ci, dtp.core_cj, dtp.core_pid, dc, rc, wp))
    assert all(n == 0 for n in kernels.launches().values())
    meta = torch.ones(4, dtype=torch.float64, device="meta")
    idx = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fold.fold_apply(meta, (idx,))
    with pytest.raises(ValueError, match="CUDA"):
        peel.peel(dtp, torch.ones((4, 2), dtype=torch.float64, device="meta"), meta, None)
    with pytest.raises(ValueError, match="CUDA"):
        dense_core.dense_core(idx[0], idx[0], idx[0], meta, meta, meta)
    cp, nc = _lattice_core(4)
    dmf = PMF.device_mf_plan(PMF.plan_multifrontal(cp, nc, leaf=4), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        mf_factor.mf_factor(dmf, meta, meta)
    st = mf_factor.mf_factor(dmf, _t(np.full(nc, 5.0)), _t(np.ones(cp.shape[0])))
    with pytest.raises(ValueError, match="CUDA"):
        mf_apply.mf_apply(dmf, st, meta)
    assert all(n == 0 for n in kernels.launches().values())


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_cyclic_kernels_match_plain_on_card():
    """On a CUDA device: K10 (bit for bit, one launch a fold, a one-level
    round fold and a three-level fold), K9, K11 and K13–K15 each equal their
    plain versions on the same inputs (``pytest -m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    _, dtp_cpu, diag, rhs, w_pairs = _peel_problem()
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(_web(P, 1000), N=1, color_strategy="fast"))
    dtp = PT.device_tree_plan(PL._plan_tree_elimination(ap), PL._build_lambda_plan(ap), ap, dev)
    dr, wp = _t(np.stack([diag, rhs], 1)).to(dev), _t(w_pairs).to(dev)

    pairs, seen = (dtp.core_ci, dtp.core_cj, dtp.core_pid), {}

    def core(dense):
        def solve(dc, rc):
            seen["dc"], seen["rc"] = dc, rc
            return dense(*pairs, dc, rc, wp)
        return solve

    got = peel.peel(dtp, dr, wp, core(dense_core.dense_core))
    want = peel.peel_plain(dtp, dr, wp, core(dense_core.dense_core_plain))
    _close(got.cpu(), want.cpu().numpy(), 1e-10)
    # the unrefined solve, which refinement would hide
    core_in = (seen["dc"], seen["rc"], wp)
    _close(dense_core.dense_core(*pairs, *core_in, n_refine=0).cpu(),
           dense_core.dense_core_plain(*pairs, *core_in, n_refine=0).cpu().numpy(), 1e-12)
    rd = dtp.rounds[0]
    v = torch.rand((rd.size, 2), dtype=torch.float64, device=dev)
    launched = fold.fold_apply.launches
    assert torch.equal(fold.fold_apply(v, rd.fold), fold.fold_apply_plain(v, rd.fold))
    # a three-level fold (segments wider than 64 twice over), one launch
    rng = np.random.default_rng(1)
    seg = _segments(rng, np.concatenate([[0, 5000, 300, 1], rng.integers(1, 70, 40)]))
    plan = fold.FoldPlan(_t(lv, torch.int32).to(dev)
                         for lv in PCE._plan_fold(seg, 44, np.arange(seg.size), seg.size))
    assert len(plan) == 3
    for C in (1, 2):
        v3 = torch.randn((seg.size, C), dtype=torch.float64, device=dev).squeeze(1 if C == 1 else -1)
        assert torch.equal(fold.fold_apply(v3, plan), fold.fold_apply_plain(v3, plan))
    assert fold.fold_apply.launches == launched + 3
    cp, nc = _lattice_core(24)
    dc, w, rc = _spd_core(cp, nc, seed=3)
    dmf = PMF.device_mf_plan(PMF.plan_multifrontal(cp, nc, leaf=16), dev)
    dc, w, rc = (_t(a).to(dev) for a in (dc, w, rc))
    st, st_plain = mf_factor.mf_factor(dmf, dc, w), mf_factor.mf_factor_plain(dmf, dc, w)
    _close(st.fac.cpu(), st_plain.fac.cpu().numpy(), 1e-12)
    _close(mf_apply.mf_apply(dmf, st, rc).cpu(),
           mf_apply.mf_apply_plain(dmf, st_plain, rc).cpu().numpy(), 1e-10)
    # one unrefined sweep on the kernel's own factor: only the sweeps differ
    dmf0 = dataclasses.replace(dmf, plan=dmf.plan._replace(n_refine=0))
    _close(mf_apply.mf_apply(dmf0, st, rc).cpu(),
           mf_apply.mf_apply_plain(dmf0, st, rc).cpu().numpy(), 1e-12)
    torch.cuda.synchronize()
