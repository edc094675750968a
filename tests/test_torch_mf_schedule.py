"""The level schedule of the multifrontal factor and apply (K13–K15).

* :func:`mf_schedule`: each front in exactly one level, every consumed
  group on a lower level than its consumer, the widest fronts first;
* ``rel``: the inverse of ``lminv`` (the skipped slots' updates are zero;
  an ``lminv`` that maps two parent indices to one slot is refused);
* the extend-add through ``rel`` equals, bit for bit, the gather through
  ``lminv`` of the factor's fronts and of the apply's right-hand sides;
* the factor run level by level equals the group-order factor bit for bit,
  and the solve the reference's ``_mf_factor`` / ``_mf_apply``;
* the launch counts of one factor and one apply, on these plans and on the
  100k-site web of ``chip_smoke.py`` (18 and 129);

on the forced multifrontal plans of ``test_torch_cyclic.py``'s small
graphs and its lattice cores; and, on the card, the kernels against their
plain versions, the assembled fronts bit for bit, and both kernels bit for
bit on two streams and in 3 CUDA-graph replays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu.ops import multifrontal as JMF
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch.kernels import mf_apply, mf_factor
from networks_fenicsx_tpu_torch.kernels.core_fronts import fold_launches
from networks_fenicsx_tpu_torch.ops import multifrontal as PMF

from _torch_cases import golden_graph


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _lattice_core(n):
    idx = np.arange(n * n).reshape(n, n)
    h = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    v = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    pairs = np.concatenate([h, v], axis=0)
    return np.concatenate([pairs, np.arange(pairs.shape[0])[:, None]], axis=1), n * n


def _graph_core(name):
    """The core pairs of ``test_torch_cyclic.py``'s ``web48`` or ``bed3``."""
    graph = (golden_graph(P, "web48") if name == "web48"
             else P.network_generation.make_vascular_bed(3, 12, 8, arrays=True))
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(graph, N=1, color_strategy="fast"))
    tp = PL._plan_tree_elimination(asm)
    return np.asarray(tp.core_pairs), tp.core_size


# (core, leaf): the forced plans of small graphs and the lattice cores
PLANS = {"web48-4": ("web48", 4), "web48-8": ("web48", 8), "bed3-4": ("bed3", 4),
         "bed3-8": ("bed3", 8), "lattice9-4": (9, 4), "lattice24-16": (24, 16),
         "lattice40-64": (40, 64)}


def _plan(key):
    core, leaf = PLANS[key]
    cp, nc = _lattice_core(core) if isinstance(core, int) else _graph_core(core)
    return cp, nc, PMF.plan_multifrontal(cp, nc, leaf=leaf)


def _spd_core(core_pairs, n_core, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 3.0, core_pairs.shape[0])
    dc = np.zeros(n_core)
    np.add.at(dc, core_pairs[:, 0], w)
    np.add.at(dc, core_pairs[:, 1], w)
    return dc * 1.001 + 0.05, w, rng.standard_normal(n_core)


@pytest.mark.parametrize("key", sorted(PLANS))
def test_schedule_levels(key, monkeypatch):
    """Every front once, consumers above what they consume, the widest first."""
    _, _, plan = _plan(key)
    sched = PMF.mf_schedule(plan)
    G = len(plan.groups)
    for gi, g in enumerate(plan.groups):
        lv = [int(sched.level[cg]) for cg, _, _ in g.consume]
        assert all(v < sched.level[gi] for v in lv)
        assert sched.level[gi] == (1 + max(lv) if lv else 0)
    seen = {(int(g), int(p)) for g, p in sched.fronts}
    assert len(seen) == sched.fronts.shape[0] == sum(g.k for g in plan.groups)
    assert seen == {(gi, p) for gi, g in enumerate(plan.groups) for p in range(g.k)}
    m = np.asarray([g.w + g.b for g in plan.groups])
    L = sched.levels
    assert L[0, PMF.L_START] == 0 and L[:, PMF.L_COUNT].sum() == sched.fronts.shape[0]
    for lv in range(sched.n_levels):
        start, wide, count, wide_m, narrow_m = (int(v) for v in L[lv])
        grp = sched.fronts[start : start + count, 0]
        assert np.all(sched.level[grp] == lv) and count > 0
        ms = m[grp]
        assert np.all(np.diff(ms) <= 0)  # the widest first
        assert np.count_nonzero(ms > PMF.WIDE_M) == wide
        assert wide_m == ms[:wide].max(initial=0) and narrow_m == ms[wide:].max(initial=0)
    assert sched.n_levels == int(sched.level.max()) + 1 and G > 0
    # every front wide: the same order, one cluster launch a level
    monkeypatch.setattr(PMF, "WIDE_M", 0)
    all_wide = PMF.mf_schedule(plan)
    assert np.array_equal(all_wide.fronts, sched.fronts)
    assert np.array_equal(all_wide.levels[:, PMF.L_WIDE], L[:, PMF.L_COUNT])
    assert all_wide.factor_launches == 1 + sched.n_levels


@pytest.mark.parametrize("key", sorted(PLANS))
def test_rel_inverts_lminv(key):
    """``rel[p, a] = i`` exactly where ``lminv[p, i] = a``; a skipped slot
    of a consuming front is the child's padding, whose update is zero."""
    cp, nc, plan = _plan(key)
    dmf = PMF.device_mf_plan(plan, "cpu")
    dc, w, _ = _spd_core(cp, nc, seed=2)
    st = mf_factor.mf_factor_plain(dmf, _t(dc), _t(w))
    skipped = 0
    for gi, g in enumerate(plan.groups):
        m = g.w + g.b
        for e, (cg, cidx_off, lminv_off) in enumerate(g.consume):
            child = plan.groups[cg]
            row = dmf.consume[int(dmf.groups[gi, PMF.G_CONS]) + e]
            assert (row[PMF.C_K], row[PMF.C_B]) == (child.k, child.b)
            rel = dmf.rel_all[row[PMF.C_REL] : row[PMF.C_REL] + g.k * child.b].numpy()
            rel = rel.reshape(g.k, child.b)
            lm = plan.lminv_all[lminv_off : lminv_off + g.k * m].reshape(g.k, m)
            cidx = plan.cidx_all[cidx_off : cidx_off + g.k]
            pool = st.pools[int(dmf.groups[cg, PMF.G_POOL]):][: child.k * child.b**2]
            pool = pool.view(child.k, child.b, child.b)
            for p in range(g.k):
                if cidx[p] >= child.k:
                    assert np.all(rel[p] == -1)
                    continue
                for a in range(child.b):
                    hits = np.flatnonzero(lm[p] == a)
                    assert hits.size <= 1
                    if hits.size:
                        assert rel[p, a] == hits[0]
                    else:
                        assert rel[p, a] == -1
                        skipped += 1
                        assert torch.all(pool[cidx[p], a] == 0) and torch.all(pool[cidx[p], :, a] == 0)
    assert skipped > 0  # the plans pad their boundaries


@pytest.mark.parametrize("key", ["web48-4", "bed3-8", "lattice24-16"])
def test_work_lists_are_rel_by_parent_index(key):
    """The extend-add's work list of each front's index ``i`` holds the
    child rows ``a`` with ``rel[edge][p, a] == i``, every one once, the
    edges in plan order (what a warp or thread owning ``i`` adds, in
    order), as the offsets of the child's update row, ``p``'s ``rel`` row,
    the child's width and its ``v`` entry."""
    _, _, plan = _plan(key)
    dmf = PMF.device_mf_plan(plan, "cpu")
    ptr, ent = dmf.xadd_ptr.numpy(), dmf.xadd.numpy()
    total = 0
    for gi, g in enumerate(plan.groups):
        m, e0 = g.w + g.b, int(dmf.groups[gi, PMF.G_CONS])
        blk = ptr[int(dmf.groups[gi, PMF.G_XADD]) :][: g.k * m + 1]
        want = {}
        for e, (_, cidx_off, _) in enumerate(g.consume):
            row = dmf.consume[e0 + e]
            cb = int(row[PMF.C_B])
            rel = dmf.rel_all[row[PMF.C_REL] :][: g.k * cb].numpy().reshape(g.k, -1)
            for p, a in zip(*np.nonzero(rel >= 0)):
                child_row = int(plan.cidx_all[cidx_off + p]) * cb + a
                want.setdefault((p, rel[p, a]), []).append(
                    (row[PMF.C_POOL] + child_row * cb, row[PMF.C_REL] + p * cb, cb,
                     row[PMF.C_VPOOL] + child_row))
        for p in range(g.k):
            for i in range(m):
                got = [tuple(x) for x in ent[blk[p * m + i] : blk[p * m + i + 1]]]
                assert got == want.get((p, i), []), (gi, p, i)
                total += len(got)
    assert total == ent.shape[0] == int((dmf.rel_all >= 0).sum())


def test_rel_refuses_a_slot_mapped_twice():
    """An ``lminv`` that maps two parent indices to one child slot: a
    scatter through ``rel`` would differ from the gather, so the upload
    raises."""
    _, _, plan = _plan("lattice9-4")
    gi = next(gi for gi, g in enumerate(plan.groups) if g.consume)
    g = plan.groups[gi]
    _, cidx_off, lminv_off = g.consume[0]
    m = g.w + g.b
    lm = plan.lminv_all.copy()
    row = lm[lminv_off : lminv_off + g.k * m].reshape(g.k, m)
    p = int(np.flatnonzero(plan.cidx_all[cidx_off : cidx_off + g.k] < plan.groups[g.consume[0][0]].k)[0])
    mapped = np.flatnonzero(row[p] < plan.groups[g.consume[0][0]].b)
    assert mapped.size >= 2
    row[p, mapped[1]] = row[p, mapped[0]]
    bad = plan._replace(lminv_all=lm)
    with pytest.raises(ValueError, match="two parent indices"):
        PMF.mf_rel_tables(bad)
    with pytest.raises(ValueError, match="two parent indices"):
        PMF.device_mf_plan(bad, "cpu")


@pytest.mark.parametrize("key", sorted(PLANS))
def test_rel_extend_add_equals_gather(key):
    """The extend-add through ``rel`` is the gather through ``lminv`` bit
    for bit: the assembled fronts on the factor's own pools and on random
    pools, the CPU ``assemble_fronts``, and the apply's right-hand sides."""
    cp, nc, plan = _plan(key)
    dmf = PMF.device_mf_plan(plan, "cpu")
    dc, w, rc = (_t(a) for a in _spd_core(cp, nc, seed=5))
    st = mf_factor.mf_factor_plain(dmf, dc, w)
    rng = np.random.default_rng(11)
    for pools in (st.pools, _t(rng.standard_normal(dmf.pool_len))):
        gather = mf_factor.assemble_fronts_plain(dmf, dc, w, pools)
        assert torch.equal(mf_factor.assemble_fronts_plain(dmf, dc, w, pools, rel=True), gather)
        assert torch.equal(mf_factor.assemble_fronts(dmf, dc, w, pools), gather)
    vpools = _t(rng.standard_normal(dmf.vpool_len))
    rc_ext = torch.cat([rc, torch.zeros(1, dtype=torch.float64)])
    for gi in range(len(plan.groups)):
        assert torch.equal(mf_apply.sweep_rhs_plain(dmf, gi, rc_ext, vpools, rel=True),
                           mf_apply.sweep_rhs_plain(dmf, gi, rc_ext, vpools))


def _factor_by_levels(dmf, dc, w):
    """The plain factor with the groups taken level by level (each level's
    groups in reverse order) and the extend-add through ``rel``."""
    vals, dc_ext = mf_factor._values(dmf, dc, w)
    fac = torch.zeros(dmf.fac_len, dtype=torch.float64)
    pools = torch.zeros(dmf.pool_len, dtype=torch.float64)
    level = dmf.schedule.level
    for lv in range(dmf.schedule.n_levels):
        for gi in reversed(np.flatnonzero(level == lv).tolist()):
            k, w_, b, _, m, _, _, _ = mf_factor.group_views(dmf, gi)
            F = mf_factor._assemble_group(dmf, gi, vals, dc_ext, pools, rel=True)
            blk, U, _ = mf_factor.front_factor_plain(F, w_)
            if b:
                po = int(dmf.groups[gi][PMF.G_POOL])
                pools[po : po + k * b * b] = U.reshape(-1)
            fo = int(dmf.groups[gi][PMF.G_FAC])
            fac[fo : fo + k * m * m] = blk.reshape(-1)
    return fac, pools


@pytest.mark.parametrize("key", ["web48-4", "bed3-8", "lattice24-16"])
def test_level_order_factor_matches_reference(key):
    """Level by level (any order inside a level) the factor is the group
    order's bit for bit; the solve on it is the reference's."""
    cp, nc, plan = _plan(key)
    dmf = PMF.device_mf_plan(plan, "cpu")
    dc, w, rc = _spd_core(cp, nc, seed=9)
    st = mf_factor.mf_factor_plain(dmf, _t(dc), _t(w))
    fac, pools = _factor_by_levels(dmf, _t(dc), _t(w))
    assert torch.equal(fac, st.fac) and torch.equal(pools, st.pools)
    plan_j = JMF.plan_multifrontal(cp, nc, leaf=PLANS[key][1])
    state = jax.jit(JMF._mf_factor)(plan_j, jnp.asarray(dc), jnp.asarray(w))
    want = np.asarray(jax.jit(JMF._mf_apply)(plan_j, state, jnp.asarray(rc)))
    got = mf_apply.mf_apply(dmf, mf_factor.MFState(fac, pools, *st[2:]), _t(rc)).numpy()
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11 * scale)


def _launches(plan) -> tuple[int, int]:
    """The launch formulas recomputed from the plan's groups alone."""
    level = []
    for g in plan.groups:
        level.append(1 + max((level[cg] for cg, _, _ in g.consume), default=-1))
    factor = 1
    for lv in set(level):
        ms = [g.w + g.b for g, l_ in zip(plan.groups, level) if l_ == lv]
        factor += any(m > PMF.WIDE_M for m in ms) + any(m <= PMF.WIDE_M for m in ms)
    folds = fold_launches(plan.mv_fold_i) + fold_launches(plan.mv_fold_j)
    n = plan.n_refine
    return factor, (1 + n) * (2 * len(set(level)) + 1) + n * (2 + folds) + 1


@pytest.mark.parametrize("key", sorted(PLANS))
def test_launch_counts(key):
    _, _, plan = _plan(key)
    dmf = PMF.device_mf_plan(plan, "cpu")
    assert (mf_factor.cuda_launches(dmf), mf_apply.cuda_launches(dmf)) == _launches(plan)
    dmf0 = dataclasses.replace(dmf, plan=plan._replace(n_refine=0))
    assert mf_apply.cuda_launches(dmf0) == dmf.schedule.sweep_launches + 1


def test_web_launch_counts():
    """``chip_smoke.py``'s 100k-site web with anastomoses: 94 groups on 14
    levels, wide fronts on the top 7, 3 levels split; the factor 18
    launches (was 95), the apply 129 (was 769)."""
    net = P.network_generation.make_random_network(100_000, keep=0.05, seed=7, arrays=True)
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(net, N=1, color_strategy="fast"))
    plan = PL._cached_tree_plan(asm, attach=True).core_plan
    assert isinstance(plan, PMF.MFPlan) and len(plan.groups) == 94
    sched = PMF.mf_schedule(plan)
    wide, count = sched.levels[:, PMF.L_WIDE], sched.levels[:, PMF.L_COUNT]
    assert sched.n_levels == 14 and int(np.count_nonzero(wide)) == 7  # levels 7-13
    assert int(np.count_nonzero(wide * (count - wide))) == 3  # 7-9 hold narrow fronts too
    assert _launches(plan) == (18, 129)
    dmf = PMF.device_mf_plan(plan, "cpu")
    assert (mf_factor.cuda_launches(dmf), mf_apply.cuda_launches(dmf)) == (18, 129)


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wide_m", [PMF.WIDE_M, 0])
def test_mf_kernels_on_card(wide_m, monkeypatch):
    """K13–K15 on the 40² lattice core (leaf 64), with the default split and
    with every front on the cluster path: the factor and the apply against
    their plain versions, the kernels' assembled fronts equal to the gather
    bit for bit, and each kernel bit for bit on two streams at once and in
    3 replays of a CUDA graph."""
    dev = _card()
    cp, nc = _lattice_core(40)
    monkeypatch.setattr(PMF, "WIDE_M", wide_m)
    dmf = PMF.device_mf_plan(PMF.plan_multifrontal(cp, nc, leaf=64), dev)
    dc, w, rc = (_t(a).to(dev) for a in _spd_core(cp, nc, seed=3))
    st, st_plain = mf_factor.mf_factor(dmf, dc, w), mf_factor.mf_factor_plain(dmf, dc, w)
    assert int(st.ok) == 1
    scale = float(st_plain.fac.abs().max())
    assert float((st.fac - st_plain.fac).abs().max()) <= 1e-12 * scale
    assert torch.equal(mf_factor.assemble_fronts(dmf, dc, w, st.pools),
                       mf_factor.assemble_fronts_plain(dmf, dc, w, st.pools))
    x, want = mf_apply.mf_apply(dmf, st, rc), mf_apply.mf_apply_plain(dmf, st_plain, rc)
    assert float((x - want).abs().max()) <= 1e-10 * max(1.0, float(want.abs().max()))
    dmf0 = dataclasses.replace(dmf, plan=dmf.plan._replace(n_refine=0))
    one, one_plain = mf_apply.mf_apply(dmf0, st, rc), mf_apply.mf_apply_plain(dmf0, st, rc)
    assert float((one - one_plain).abs().max()) <= 1e-12 * max(1.0, float(one_plain.abs().max()))

    runs = {"factor": (lambda: mf_factor.mf_factor(dmf, dc, w)[:3], st[:3]),
            "apply": (lambda: (mf_apply.mf_apply(dmf, st, rc),), (x,))}
    for name, (fn, alone) in runs.items():
        streams = [torch.cuda.Stream() for _ in range(2)]
        torch.cuda.synchronize()
        outs = []
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(fn())
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for out in outs for a, b in zip(out, alone)), name
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = fn()
        for _ in range(3):
            for t in captured:
                t.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(captured, alone)), name
