"""K12a's packed round table and its order, on the CPU and the card.

A :class:`~networks_fenicsx_tpu_torch.ops.core_elim.DeviceCorePlan` packs
its min-degree rounds into one int32 table (``dcp.rt``) that K12a's two
launches walk.  Here:

* the table's check (indices in range, pads one past their source, one
  writer per output, each fold level within the previous level's rows,
  every update-stream slot written once) passes on web2k's plan, the web48
  golden's forced sparse and supernodal plans, the forced-front 40²
  lattice and others, and refuses broken tables;
* the plain version in the kernels' order (``core_elim_table_plain``, every
  index from the table, the folds' last levels summed by their readers, the
  forward sweep beside the factor) equals ``core_elim_plain`` bit for bit
  (``torch.equal``, NaN where it is NaN); ``tests/test_torch_sweep_core_reference.py``
  holds it against the JAX package's ``_core_factor``/``_core_apply`` at
  the tolerances ``tests/test_torch_core_elim.py`` pins;
* the launch count (two a solve, plus the tail's or the fronts') and the
  launch size (one block on web2k, a cooperative grid past the one-block
  limits);
* factor reuse's split (``core_factor`` / ``core_apply``): the factor
  buffer in both orders bit for bit, each apply ``core_elim_plain``'s
  ``λ_core`` bit for bit, singular cores NaN, and the table's refusal of a
  broken factor or scratch layout.

The ``cuda``-marked tests hold the kernels, fused and split, in one block
and in a forced cooperative grid, to the table's plain version bit for
bit on the rounds (the tail and fronts left out) and within chip_smoke's
bar with them; this file imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch.kernels import core_elim, dense_core
from networks_fenicsx_tpu_torch.ops import core_elim as PCE

torch.set_num_threads(1)


GRAPHS = {
    # the reference's mid-size web (__graft_entry__.py:244-252)
    "web2k": lambda g: g.make_random_network(2000, keep=0.7, num_boundary=8, seed=5, arrays=True),
    "web48": lambda g: g.make_random_network(48, keep=0.6, num_boundary=3, seed=5, arrays=True),
    "web150": lambda g: g.make_random_network(150, keep=0.6, seed=9, arrays=True),
    "bed4": lambda g: g.make_vascular_bed(4, 32, 20, arrays=True),
    "grid40": lambda g: g.make_grid(40, 40, arrays=True),
}

_CORES: dict = {}


def _core(name):
    """``(core_pairs, n_core)`` of a graph's cycle core (the port's planner)."""
    if name not in _CORES:
        mesh = P.NetworkMesh(GRAPHS[name](P.network_generation), N=1, color_strategy="fast")
        tp = PL._plan_tree_elimination(P.HydraulicNetworkAssembler(mesh))
        _CORES[name] = (np.asarray(tp.core_pairs), tp.core_size)
    return _CORES[name]


def _nd(name, leaf, **kw):
    cp, n = _core(name)
    return dict(order=PCE.nested_dissection_order(cp, n, leaf=leaf), **kw)


# the forced plans: web48's (tests/test_golden.py:148, :183), the 40² lattice's
# fronts of 37 pivots (tests/test_core_elim.py:346)
CASES = {
    "web2k-default": ("web2k", lambda: {}),
    "web48-sparse": ("web48", lambda: dict(dense_cutoff=4, tail_stop=False)),
    "web48-supernodal": ("web48", lambda: _nd("web48", 4, dense_cutoff=8, kcap=16, dense_cap=4,
                                              supernodal_tail=True, front_max=7, front_cap=64,
                                              tail_stop=False)),
    "grid40-fronts": ("grid40", lambda: _nd("grid40", 8, dense_cutoff=64, kcap=24, dense_cap=16,
                                            supernodal_tail=True, front_max=37, tail_stop=False)),
    "grid40-nd-tail": ("grid40", lambda: _nd("grid40", 8, dense_cutoff=64, kcap=64, tail_stop=False)),
    "web150-no-tail": ("web150", lambda: dict(dense_cutoff=0, tail_stop=False)),
    "bed4-default": ("bed4", lambda: {}),
}


def _plan(case):
    name, kw = CASES[case]
    cp, n = _core(name)
    return PCE.plan_core_elimination(cp, n, **kw())


def _system(case, seed):
    """Seeded ``(dc, w_pairs, rc)`` of a diagonally dominant core system."""
    cp, n = _core(CASES[case][0])
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, int(cp[:, 2].max()) + 3)
    dc = rng.uniform(0.05, 0.5, n)
    np.add.at(dc, cp[:, 0], w[cp[:, 2]])
    np.add.at(dc, cp[:, 1], w[cp[:, 2]])
    return tuple(torch.as_tensor(a) for a in (dc, w, rng.standard_normal(n)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_table_checks_and_describes_the_plan(case):
    """The table passes its check and gives back each round's arrays."""
    pp = _plan(case)
    dcp = PCE.device_core_plan(pp, "cpu")  # packs and checks the table
    words = dcp.rt.host.astype(np.int64)
    PCE.check_round_table(words, int(pp.init_slot.max()))
    assert dcp.rt.rounds == len(pp.rounds) and dcp.rt.head_words == (
        PCE.HEAD_WORDS + len(pp.rounds) * PCE.ROUND_WORDS)
    for k, rd in enumerate(pp.rounds):
        got = PCE._round_arrays(words, k)
        assert np.array_equal(got["elim"], rd.elim) and np.array_equal(got["nbr"], rd.nbr_node.ravel())
        P0 = pp.init_slot.size
        pid = np.where(rd.init_idx < P0, pp.init_slot[np.minimum(rd.init_idx, P0 - 1)], -1)
        assert np.array_equal(got["init_pid"], pid.ravel()) and got["u_off"] == rd.u_off
        for levels, plan_levels in ((got["u_read"], rd.u_read), (got["d_fold"], rd.d_fold)):
            assert [lv.tolist() for lv, _ in levels] == [np.asarray(lv).tolist() for lv in plan_levels]
        hit = rd.d_inv < got["U1"]
        assert np.array_equal(got["d_node"][rd.d_inv[hit]], np.flatnonzero(hit))


def _broken(words, k, field, value):
    out = words.copy()
    out[PCE.HEAD_WORDS + k * PCE.ROUND_WORDS + field] = value
    return out


def test_round_table_refuses_broken_tables():
    pp = _plan("web2k-default")
    words = PCE.device_core_plan(pp, "cpu").rt.host.astype(np.int64)
    top = int(pp.init_slot.max())
    check = lambda w: PCE.check_round_table(w, top)
    rd = PCE._round_arrays(words, 1)
    elim_at = int(words[PCE.HEAD_WORDS + PCE.ROUND_WORDS + PCE.R_ELIM])
    dup = words.copy()
    dup[elim_at + 1] = dup[elim_at]
    with pytest.raises(ValueError, match="eliminates a node twice"):
        check(dup)
    far = words.copy()
    far[int(words[PCE.HEAD_WORDS + PCE.ROUND_WORDS + PCE.R_NBR])] = words[PCE.G_NCORE] + 1
    with pytest.raises(ValueError, match="nbr_node outside"):
        check(far)
    with pytest.raises(ValueError, match="update-stream slot"):
        check(_broken(words, 1, PCE.R_UOFF, rd["u_off"] + 1))
    node_at = int(words[PCE.HEAD_WORDS + PCE.ROUND_WORDS + PCE.R_DNODE])
    twice = words.copy()
    twice[node_at + 1] = twice[node_at]
    with pytest.raises(ValueError, match="from two rows"):
        check(twice)
    fold_at = PCE.HEAD_WORDS + PCE.ROUND_WORDS + PCE.R_DFOLD
    past = words.copy()
    past[int(words[fold_at + 1])] = rd["S"] * rd["K"] + 1  # a level-0 index past the pad
    with pytest.raises(ValueError, match="d_fold level 0 outside"):
        check(past)
    bad_pid = words.copy()
    bad_pid[int(words[PCE.HEAD_WORDS + PCE.ROUND_WORDS + PCE.R_INIT])] = top + 1
    with pytest.raises(ValueError, match="pair ids outside"):
        check(bad_pid)


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_plain_equals_plain(case):
    """The kernels' order from the table: ``λ_core`` bit for bit."""
    pp = _plan(case)
    dcp = PCE.device_core_plan(pp, "cpu")
    dc, w, rc = _system(case, seed=3)
    want = core_elim.core_elim_plain(dcp, dc, w, rc)
    got = core_elim.core_elim_table_plain(dcp, dc, w, rc)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)), case
    rounds_only = dataclasses.replace(dcp, fronts=(), dense_nodes=dcp.dense_nodes[:0],
                                      dp_init=dcp.dp_init[:0])  # the tail is the plan's, not the table's
    assert torch.equal(core_elim.core_elim_table_plain(rounds_only, dc, w, rc),
                       core_elim.core_elim_plain(rounds_only, dc, w, rc))
    unrefined = core_elim.core_elim_table_plain(dcp, dc, w, rc, n_refine=0)
    assert torch.equal(unrefined, core_elim.core_elim_plain(dcp, dc, w, rc, n_refine=0))


def _same(got, want):
    """``torch.equal`` with NaN where NaN is."""
    return torch.equal(torch.isnan(got), torch.isnan(want)) and torch.equal(
        torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_plain_equals_plain(case):
    """Factor reuse's split: the factor in the table's order and in the
    reference's gives the same factor buffer (``a``, ``inv``, the update
    stream) and diagonal bit for bit, each apply on it gives
    ``core_elim_plain``'s ``λ_core`` bit for bit (refined and not), the
    wrappers' CPU path is the plain version, and an apply leaves the factor
    as it was."""
    pp = _plan(case)
    dcp = PCE.device_core_plan(pp, "cpu")
    dc, w, rc = _system(case, seed=5)
    fp = core_elim.core_factor_plain(dcp, dc, w)
    ft = core_elim.core_factor_table_plain(dcp, dc, w)
    assert fp.fac.shape == (dcp.rt.fac_len,) and torch.equal(fp.fac, ft.fac) and torch.equal(fp.d, ft.d)
    assert torch.equal(core_elim.factor_stream(dcp, fp.fac), core_elim.core_factor_plain(
        dcp, dc, w).fac[dcp.a_len + dcp.s_len:])
    kept = fp.fac.clone()
    for n_refine in (dense_core.N_REFINE, 0):
        want = core_elim.core_elim_plain(dcp, dc, w, rc, n_refine)
        assert _same(core_elim.core_apply_plain(dcp, fp, rc, n_refine), want), case
        assert _same(core_elim.core_apply_table_plain(dcp, ft, rc, n_refine), want), case
        assert _same(core_elim.core_apply(dcp, core_elim.core_factor(dcp, dc, w), rc, n_refine), want)
    assert torch.equal(fp.fac, kept)
    rounds_only = dataclasses.replace(dcp, fronts=(), dense_nodes=dcp.dense_nodes[:0],
                                      dp_init=dcp.dp_init[:0])
    fr = core_elim.core_factor_table_plain(rounds_only, dc, w)
    assert fr.tail is None and fr.fronts is None
    assert torch.equal(core_elim.core_apply_table_plain(rounds_only, fr, rc),
                       core_elim.core_elim_plain(rounds_only, dc, w, rc))


@pytest.mark.parametrize("case", ["web2k-default", "grid40-fronts"])
def test_split_singular_core_is_nan(case):
    """An indefinite core (the diagonal negated): the tail's K11 gate or a
    front's gate trips in the factor and the apply's ``λ_core`` is NaN
    where ``core_elim_plain``'s is, all of it on the fronts."""
    dcp = PCE.device_core_plan(_plan(case), "cpu")
    dc, w, rc = _system(case, seed=6)
    f = core_elim.core_factor(dcp, -dc, w)
    gate = f.tail[3] if f.tail is not None else f.fronts.ok
    assert not bool(gate)
    lam = core_elim.core_apply(dcp, f, rc)
    assert torch.isnan(lam).any() and _same(lam, core_elim.core_elim_plain(dcp, -dc, w, rc))
    if dcp.fronts:
        assert torch.isnan(lam).all()


def test_round_table_refuses_bad_buffer_offsets():
    """The factor's and the scratch's layout: a factor offset off its
    running place, an apply scratch too short for ``t`` or longer than the
    scratch, scratch entries that overlap, one past the scratch."""
    pp = _plan("web2k-default")
    words = PCE.device_core_plan(pp, "cpu").rt.host.astype(np.int64)
    top = int(pp.init_slot.max())
    check = lambda w: PCE.check_round_table(w, top)

    def head(field, value):
        out = words.copy()
        out[field] = value
        return out

    with pytest.raises(ValueError, match="factor is not"):
        check(head(PCE.G_US, words[PCE.G_US] + 1))
    with pytest.raises(ValueError, match="running one"):
        check(_broken(words, 1, PCE.R_AOFF, 0))
    with pytest.raises(ValueError, match="outside the apply's scratch"):
        check(head(PCE.G_AWORK, words[PCE.G_T] + 1))
    with pytest.raises(ValueError, match="overlaps"):
        check(head(PCE.G_T, words[PCE.G_RV]))
    with pytest.raises(ValueError, match="outside the scratch"):
        check(head(PCE.G_C, words[PCE.G_WORK]))
    with pytest.raises(ValueError, match="apply's scratch .* outside"):
        check(head(PCE.G_AWORK, words[PCE.G_WORK] + 1))


def test_launches_and_launch_size(monkeypatch):
    """web2k: two launches and K11's on its 628-node tail, in one block;
    past the one-block limits a cooperative grid of the widest phase over
    512 threads; a rounds-only plan two launches."""
    pp = _plan("web2k-default")
    dcp = PCE.device_core_plan(pp, "cpu")
    Pd = int(dcp.dp_init.shape[0])
    assert core_elim.cuda_launches(dcp) == 2 + dense_core.cuda_launches(628, Pd) == 40
    assert core_elim.launch_grid(dcp) == 0
    assert dcp.rt.max_work <= core_elim.ONE_BLOCK_WORK and dcp.n_core <= core_elim.ONE_BLOCK_CORE
    rounds_only = dataclasses.replace(dcp, dense_nodes=dcp.dense_nodes[:0], dp_init=dcp.dp_init[:0])
    assert core_elim.cuda_launches(rounds_only) == 2
    monkeypatch.setattr(core_elim, "ONE_BLOCK_CORE", 0)
    assert core_elim.launch_grid(dcp) == -(-dcp.rt.max_work // core_elim.GRID_THREADS)
    pf = _plan("grid40-fronts")
    dcf = PCE.device_core_plan(pf, "cpu")
    assert core_elim.cuda_launches(dcf) == 2 + core_elim.core_fronts.cuda_launches(dcf)
    # the split: the factor's one launch and the apply's two around K11's or K12b's halves
    for plan in (dcp, dcf, rounds_only):
        assert (core_elim.factor_launches(plan) + core_elim.apply_launches(plan)
                == core_elim.cuda_launches(plan) + 1)
    assert core_elim.apply_launches(dcp) == 2 + dense_core.solve_launches(628) == 18
    assert core_elim.factor_launches(rounds_only) == 1


# ------------------------------------------------------------------ card


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_core_rounds_on_card(monkeypatch, case, grid):
    """On a CUDA device, in one block and in a cooperative grid: the rounds
    alone bit for bit with the table's plain version; the whole solve (with
    K11's tail or K12b's fronts) within ``chip_smoke.py``'s bar of it
    (1e-12·scale with a tail of at most 628 nodes and no fronts, else
    1e-10)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if grid:
        monkeypatch.setattr(core_elim, "ONE_BLOCK_CORE", 0)
    dev = torch.device("cuda")
    pp = _plan(case)
    dcp = PCE.device_core_plan(pp, dev)
    assert (core_elim.launch_grid(dcp, dev.index or 0) > 0) == grid
    dc, w, rc = (t.to(dev) for t in _system(case, seed=8))
    rounds_only = dataclasses.replace(dcp, fronts=(), dense_nodes=dcp.dense_nodes[:0],
                                      dp_init=dcp.dp_init[:0])
    got = core_elim.core_elim(rounds_only, dc, w, rc)
    assert torch.equal(got, core_elim.core_elim_table_plain(rounds_only, dc, w, rc)), case
    got = core_elim.core_elim(dcp, dc, w, rc)
    want = core_elim.core_elim_table_plain(dcp, dc, w, rc)
    scale = max(1.0, float(want.abs().max()))
    tol = 1e-12 if pp.dense_nodes.size <= 628 and not pp.fronts else 1e-10
    assert float((got - want).abs().max()) <= tol * scale, case
    assert torch.equal(core_elim.core_elim(dcp, dc, w, rc), got)  # repeat calls bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_core_on_card(monkeypatch, case, grid):
    """Factor reuse's split on a CUDA device, in one block and in a
    cooperative grid: the factor launch's buffer and diagonal bit for bit
    with the table's plain version; the apply on the rounds alone bit for
    bit; the whole apply (K11's split solve or K12b's sweeps) within the
    fused ``core_elim``'s bar of it; two applies on two streams against one
    factor each their own bits, the factor unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if grid:
        monkeypatch.setattr(core_elim, "ONE_BLOCK_CORE", 0)
    dev = torch.device("cuda")
    pp = _plan(case)
    dcp = PCE.device_core_plan(pp, dev)
    dc, w, rc = (t.to(dev) for t in _system(case, seed=9))
    f = core_elim.core_factor(dcp, dc, w)
    ft = core_elim.core_factor_table_plain(dcp, dc, w)
    assert torch.equal(f.fac, ft.fac) and torch.equal(f.d, ft.d), case
    rounds_only = dataclasses.replace(dcp, fronts=(), dense_nodes=dcp.dense_nodes[:0],
                                      dp_init=dcp.dp_init[:0])
    fr = core_elim.core_factor(rounds_only, dc, w)
    assert torch.equal(core_elim.core_apply(rounds_only, fr, rc),
                       core_elim.core_apply_table_plain(rounds_only, fr, rc)), case
    got = core_elim.core_apply(dcp, f, rc)
    fused = core_elim.core_elim(dcp, dc, w, rc)
    scale = max(1.0, float(fused.abs().max()))
    tol = 1e-12 if pp.dense_nodes.size <= 628 and not pp.fronts else 1e-10
    assert float((got - fused).abs().max()) <= tol * scale, case
    kept, rc2 = f.fac.clone(), rc.flip(0).contiguous()
    want2 = core_elim.core_apply(dcp, f, rc2)
    torch.cuda.synchronize()
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    outs = []
    for stream, r in zip(streams, (rc, rc2)):
        with torch.cuda.stream(stream):
            outs.append(core_elim.core_apply(dcp, f, r))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], got) and torch.equal(outs[1], want2) and torch.equal(f.fac, kept)
