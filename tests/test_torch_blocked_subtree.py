"""K2–K4's subtree-blocked sweep: its plan, its plain version, its kernels.

The blocked sweep (``networks_fenicsx_tpu_torch/kernels/tree_sweep.py``)
runs on the card as three launches cut by the device plan's
:class:`~networks_fenicsx_tpu_torch.blocked.SweepPlan`: subtree blocks
below the cut, one block for the top, subtree blocks back.  Here, on the
CPU:

* the plan's check (every bifurcation in one subtree block or in the top,
  each block closed under ``bif_child``, the top within one block) on
  arterial trees of 4–8 generations, a tree whose out-degree varies by
  level, a multi-root forest, a chain deeper than the top and the sharded
  tree's local plans, with the cut's constants patched so that small trees
  are cut too; and its refusal of broken plans;
* the plain version in the kernels' order (``tree_sweep_blocked_plain``,
  block by block from the plan's tables, the norm in the kernels' order)
  against the level-by-level plain version: λ, d, r and wn ``torch.equal``,
  the norm within 1e-14 relative; the halves of the sharded solve too
  (``tests/test_torch_sweep_core_reference.py`` holds it against the JAX
  package's ``_blocked_eliminate`` at 1e-12·scale);
* the launch counts (3 a full sweep on the 16-generation headline tree).

The ``cuda``-marked test holds the kernels to the blocked plain version bit
for bit (the norm included) on the card; this file imports no JAX.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import blocked as PB
from networks_fenicsx_tpu_torch.kernels import tree_sweep as TS
from networks_fenicsx_tpu_torch.parallel import blocked_sharded as PBS

torch.set_num_threads(1)

# the cut's constants for small trees (a forest that fits the top is not
# cut): a top of at most 2 nodes cut at the first level 2 wide, or of 16
# cut at the first level 8 wide
SMALL = dict(TOP_MAX=2, MIN_SUBTREES=2, SMS=2, SUB_NODES=8)
MID = dict(TOP_MAX=16, MIN_SUBTREES=8, SMS=2, SUB_NODES=16)


def _arterial(gens):
    return lambda pkg: pkg.network_generation.make_arterial_tree(
        gens, direction=np.array([0.1, 1.0, 0.0]), arrays=True)


def _by_degrees(degrees, roots=1):
    """A forest of ``roots`` trees whose junctions of level l all have
    ``degrees[l]`` out-edges, each tree fed by its own inlet."""
    pos, edges = [], []

    def node(x, y):
        pos.append((x, y))
        return len(pos) - 1

    for t in range(roots):
        inlet = node(10.0 * t, -1.0)
        level = [node(10.0 * t, 0.0)]
        edges.append((inlet, level[0]))
        for l, K in enumerate(degrees):
            nxt = []
            for i, b in enumerate(level):
                for j in range(K):
                    c = node(10.0 * t + 0.37 * (i * K + j) + 0.1 * l, float(l + 1))
                    edges.append((b, c))
                    nxt.append(c)
            level = nxt
    pos = np.asarray(pos, float)
    edges = np.asarray(edges, np.int64)
    return lambda pkg: pkg.ArrayNetwork(pos=pos, edges=edges)


def _chain(n):
    """A path of ``n`` edges: n − 1 junctions of one out-edge, a level each."""
    pos = np.stack([0.1 * np.arange(n + 1), np.arange(n + 1, dtype=float)], axis=1)
    edges = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return lambda pkg: pkg.ArrayNetwork(pos=pos, edges=edges)


TOPOLOGIES = {
    **{f"arterial{g}": (_arterial(g), SMALL if g < 6 else MID) for g in (4, 5, 6, 7, 8)},
    "arterial8-default": (_arterial(8), {}),
    "degrees-3-2-1-4-2": (_by_degrees((3, 2, 1, 4, 2)), SMALL),
    "degrees-partial-block": (_by_degrees((3, 3, 2, 2)), dict(TOP_MAX=4, MIN_SUBTREES=9, SMS=2,
                                                               SUB_NODES=64)),
    "forest-5-roots": (_by_degrees((2, 3, 2), roots=5), dict(SMALL, TOP_MAX=16)),
    "forest-cut-at-roots": (_by_degrees((2, 2), roots=6), dict(SMALL, TOP_MAX=4)),
    "chain-deeper-than-top": (_chain(40), dict(TOP_MAX=5, MIN_SUBTREES=1000)),
    "all-top": (_arterial(6), {}),
    "global-values": (_arterial(7), dict(SUB_SMEM=0, **SMALL)),
}


def _asm(pkg, graph_fn, N=2):
    asm = pkg.HydraulicNetworkAssembler(pkg.NetworkMesh(graph_fn(pkg), N=N))
    asm.compute_forms(p_bc_ex=lambda x: x[1])
    return asm


def _patched(monkeypatch, consts):
    for name, value in consts.items():
        monkeypatch.setattr(PB, name, value)


def _inputs(plan, seed=21):
    rng = np.random.default_rng(seed)
    E = plan.edge_order.size
    return tuple(torch.as_tensor(rng.uniform(lo, 2.0, E)) for lo in (0.5, -1.0, -1.0))


def _local_plans():
    asm = _asm(P, _arterial(8))
    return {D: PBS.plan_sharded_blocked(asm, D).local_plan for D in (2, 4)}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_sweep_plan_check_and_blocks(monkeypatch, name):
    """The plan's check passes, and the blocks' nodes with the top's are
    every bifurcation once, each block a union of whole subtrees."""
    graph, consts = TOPOLOGIES[name]
    _patched(monkeypatch, consts)
    plan = PB._plan_blocked(_asm(P, graph))
    assert plan is not None
    dp = PB.device_plan(plan, "cpu")  # checks the sweep plan
    sp = dp.sweep
    B = int(plan.bif_offsets[-1])
    seen = np.zeros(B, np.int64)
    seen[: sp.top_nodes] += 1
    for b in range(sp.blocks):
        nodes = PB.block_nodes(sp, b)
        seen[nodes] += 1
        parent = dp.bif_parent.numpy()[nodes]
        inside = np.isin(parent, nodes)
        assert np.all(inside | (parent < sp.top_nodes)), name  # only the block's roots leave it
    assert np.all(seen == 1), name
    if name == "chain-deeper-than-top":
        assert (sp.cut, sp.blocks, sp.top_nodes) == (5, 1, 5)
    if name == "forest-cut-at-roots":
        assert sp.cut == 0 and sp.top_nodes == 0 and sp.blocks > 0
    if name == "all-top":
        assert sp.blocks == 0 and sp.cut == sp.num_levels
    if name == "degrees-partial-block":
        assert int(sp.host_levels[sp.cut, 1]) % sp.group != 0  # the last block is partial
    if name == "global-values":
        assert not sp.smem


@pytest.mark.parametrize("D", [2, 4])
def test_sweep_plan_of_the_sharded_local_plans(monkeypatch, D):
    _patched(monkeypatch, SMALL)
    lp = _local_plans()[D]
    sp = PB.device_plan(lp, "cpu").sweep
    assert sp.blocks > 0 and sp.cut >= 1


def test_sweep_plan_of_the_headline_tree():
    """The 16-generation tree: cut at level 8 (255 top nodes), 256 subtrees
    of 127 nodes a block, 3 launches a sweep (were 31)."""
    plan = PB._plan_blocked(_asm(P, _arterial(16), N=1))
    dp = PB.device_plan(plan, "cpu")
    sp = dp.sweep
    assert (sp.cut, sp.top_nodes, sp.blocks, sp.group, sp.block_nodes, sp.threads) == (
        8, 255, 256, 1, 127, 128)
    assert TS.cuda_launches(dp) == 3
    assert (TS.cuda_launches(dp, TS.FORWARD), TS.cuda_launches(dp, TS.BACKWARD)) == (2, 2)


def test_sweep_plan_refuses_broken_plans(monkeypatch):
    _patched(monkeypatch, SMALL)
    plan = PB._plan_blocked(_asm(P, _arterial(6)))
    dp = PB.device_plan(plan, "cpu")
    sp, child = dp.sweep, PB.flatten_plan(plan)["bif_child"]
    import dataclasses

    wider = sp.host_levels.copy()
    wider[sp.cut:, 3] += 1  # a run more a level: blocks reach into each other
    with pytest.raises(ValueError, match="sweep plan"):
        PB.check_sweep_plan(dataclasses.replace(sp, host_levels=wider), child)
    with pytest.raises(ValueError, match="no block"):
        PB.check_sweep_plan(dataclasses.replace(sp, blocks=sp.blocks - 1), child)
    with pytest.raises(ValueError, match="does not fit"):
        PB.check_sweep_plan(dataclasses.replace(sp, top_nodes=PB.TOP_MAX + 1), child)
    swapped = child.copy()
    swapped[[0, 1]] = swapped[[1, 0]]  # node 0 adopts node 1's children
    a = np.flatnonzero(child[:, 0] >= sp.top_nodes)[0]
    b = np.flatnonzero(child[:, 0] >= sp.top_nodes)[-1]
    swapped[[a, b]] = swapped[[b, a]]  # children moved across blocks
    with pytest.raises(ValueError, match="closed"):
        PB.check_sweep_plan(sp, swapped)


def _sweeps(dp, w, const, Ftot):
    return (TS.tree_sweep_plain(dp.plan, w, const, Ftot),
            TS.tree_sweep_blocked_plain(dp, w, const, Ftot))


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_blocked_plain_equals_plain(monkeypatch, name):
    """λ, d, r, wn bit for bit with the level-by-level plain version, the
    norm within 1e-14 relative."""
    graph, consts = TOPOLOGIES[name]
    _patched(monkeypatch, consts)
    plan = PB._plan_blocked(_asm(P, graph))
    dp = PB.device_plan(plan, "cpu")
    w, const, Ftot = _inputs(plan)
    want, got = _sweeps(dp, w, const, Ftot)
    for i in (0, 2, 3, 4):
        assert torch.equal(got[i], want[i]), (name, i)
    assert abs(float(got[1]) - float(want[1])) <= 1e-14 * float(want[1])


@pytest.mark.parametrize("name", ["arterial7", "forest-cut-at-roots", "chain-deeper-than-top",
                                  "degrees-3-2-1-4-2"])
def test_blocked_plain_halves_equal_plain_halves(monkeypatch, name):
    """The sharded solve's halves in the kernels' order: the forward's d, r,
    wn bit for bit and Σ r² within 1e-14 relative; the backward's λ bit for
    bit from the same level 0."""
    graph, consts = TOPOLOGIES[name]
    _patched(monkeypatch, consts)
    plan = PB._plan_blocked(_asm(P, graph))
    dp = PB.device_plan(plan, "cpu")
    w, const, Ftot = _inputs(plan, seed=5)
    fw = TS.tree_sweep_forward_plain(plan, w, const, Ftot)
    fb = TS.tree_sweep_forward_blocked_plain(dp, w, const, Ftot)
    assert all(torch.equal(a, b) for a, b in zip(fw[:3], fb[:3]))
    assert abs(float(fb[3]) - float(fw[3])) <= 1e-14 * float(fw[3])
    n0 = plan.levels[0].m
    lam0 = torch.zeros(int(plan.bif_offsets[-1]), dtype=torch.float64)
    lam0[:n0] = fw[1][:n0] / fw[0][:n0]
    want = TS.tree_sweep_backward_plain(plan, *fw[:3], lam0.clone())
    assert torch.equal(TS.tree_sweep_backward_blocked_plain(dp, *fw[:3], lam0.clone()), want)


@pytest.mark.parametrize("D", [2, 4])
def test_blocked_plain_on_the_sharded_local_plans(monkeypatch, D):
    _patched(monkeypatch, SMALL)
    lp = _local_plans()[D]
    dp = PB.device_plan(lp, "cpu")
    w, const, Ftot = _inputs(lp, seed=D)
    fw = TS.tree_sweep_forward_plain(lp, w, const, Ftot)
    fb = TS.tree_sweep_forward_blocked_plain(dp, w, const, Ftot)
    assert all(torch.equal(a, b) for a, b in zip(fw[:3], fb[:3]))
    lam0 = torch.zeros(dp.num_bifurcations, dtype=torch.float64)
    lam0[: lp.levels[0].m] = 0.5
    assert torch.equal(TS.tree_sweep_backward_blocked_plain(dp, *fw[:3], lam0.clone()),
                       TS.tree_sweep_backward_plain(lp, *fw[:3], lam0.clone()))


def test_launch_counts_follow_the_plan(monkeypatch):
    """Three a full sweep with subtree blocks, the top's alone without; a
    half two, the backward's top left out when the top is level 0 alone."""
    counts = {}
    for name in ("arterial4", "arterial6", "chain-deeper-than-top", "all-top", "forest-cut-at-roots"):
        graph, consts = TOPOLOGIES[name]
        with monkeypatch.context() as m:
            for k, v in consts.items():
                m.setattr(PB, k, v)
            dp = PB.device_plan(PB._plan_blocked(_asm(P, graph)), "cpu")
        counts[name] = tuple(TS.cuda_launches(dp, mode) for mode in (TS.FULL, TS.FORWARD, TS.BACKWARD))
    assert counts == {"arterial4": (3, 2, 1), "arterial6": (3, 2, 2), "chain-deeper-than-top": (3, 2, 2),
                      "all-top": (1, 1, 1), "forest-cut-at-roots": (3, 2, 1)}


# ------------------------------------------------------------------ card


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_tree_sweep_kernels_equal_blocked_plain_on_card(monkeypatch, name):
    """On a CUDA device: the three launches equal the blocked plain version
    bit for bit (λ, d, r, wn and the norm), the halves too, and the plain
    level-by-level version's λ, d, r, wn bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    graph, consts = TOPOLOGIES[name]
    _patched(monkeypatch, consts)
    plan = PB._plan_blocked(_asm(P, graph))
    dp = PB.device_plan(plan, dev)
    w, const, Ftot = (t.to(dev) for t in _inputs(plan))
    got = TS.tree_sweep(dp, w, const, Ftot)
    want = TS.tree_sweep_blocked_plain(dp, w, const, Ftot)
    level = TS.tree_sweep_plain(plan, w, const, Ftot)
    for i in range(5):
        assert torch.equal(got[i], want[i]), (name, i)
    for i in (0, 2, 3, 4):
        assert torch.equal(got[i], level[i]), (name, i)
    fw = TS.tree_sweep_forward(dp, w, const, Ftot)
    fb = TS.tree_sweep_forward_blocked_plain(dp, w, const, Ftot)
    assert all(torch.equal(a, b) for a, b in zip(fw, fb)), name
    lam0 = torch.zeros(dp.num_bifurcations, dtype=torch.float64, device=dev)
    n0 = plan.levels[0].m
    lam0[:n0] = fw[1][:n0] / fw[0][:n0]
    assert torch.equal(TS.tree_sweep_backward(dp, *fw[:3], lam0.clone()),
                       TS.tree_sweep_backward_blocked_plain(dp, *fw[:3], lam0.clone())), name
