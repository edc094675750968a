"""K22c for every co-located shard at once (``kernels/dist_tree.py``).

The shards of one device share a stacked table set, and K22c's folds, level
walk and back walk each take all of them: 3 launches a device a solve.  On
the CPU:

* the batched plain versions equal the per-shard plain versions (the
  tables of one shard, one shard's edge data) by ``torch.equal``, shard by
  shard, on the forests of ``tests/test_torch_sharding.py`` over
  ``["cpu"] * D`` meshes (D = 1 included);
* the executor's grouped solve equals the same composition shard by shard;
* the tables refuse a plan whose folds or parents leave the level the
  walks read them from, or whose folds do not name a parent's children as a
  run, and the launch formula counts the design's launches.

The ``cuda``-marked test holds the kernels against the plain versions on a
card, bit for bit, on two streams, in 3 launches, also on a level wider than
the walks' shared buffers and on more levels than their staged table.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch.kernels import dist_tree
from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver as PSharded

torch.set_num_threads(1)


def _arterial(gens):
    return lambda pkg: pkg.network_generation.make_arterial_tree(
        gens, direction=np.array([0.1, 1.0, 0.0]), arrays=True)


def _tree(n):
    return lambda pkg: pkg.network_generation.make_tree(n, 1.0, 2.0, arrays=True)


def _random_forest(n=400, seed=7):
    return lambda pkg: pkg.network_generation.make_random_network(n, keep=0.0, seed=seed,
                                                                  arrays=True)


def _two_trees():
    """The disjoint union of make_tree(4, 1, 2) and make_tree(3, 2, 1)."""
    def build(pkg):
        a = pkg.network_generation.make_tree(4, 1.0, 2.0, arrays=True)
        b = pkg.network_generation.make_tree(3, 2.0, 1.0, arrays=True)
        pos_a, pos_b = np.asarray(a.pos), np.asarray(b.pos)
        edges = np.concatenate([np.asarray(a.edges), np.asarray(b.edges) + pos_a.shape[0]])
        return pkg.ArrayNetwork(pos=np.concatenate([pos_a, pos_b]), edges=edges)

    return build


def _chain(n_nodes):
    pos = np.asarray([[float(i), 0.0] for i in range(n_nodes)])
    edges = np.asarray([[i, i + 1] for i in range(n_nodes - 1)], np.int64)
    return lambda pkg: pkg.ArrayNetwork(pos=pos, edges=edges)


def _solver(graph, D, N=2, k=1, device="cpu", seed=3):
    """A tree_dist solve over ``[device] * D`` with per-edge R from a seed
    (solved once, so its executor and arguments are built)."""
    mesh = P.NetworkMesh(graph(P), N=N, color_strategy="fast")
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k)
    asm.compute_forms(p_bc_ex=lambda x: x[1], f=0.3,
                      R=np.random.default_rng(seed).uniform(0.5, 2.0, mesh.num_edges))
    sp = PSharded(asm, devices=[device] * D, schur_method="tree_dist")
    sp.assemble()
    sp.solve()
    assert sp.info.method == "schur_sharded_dist", sp.info
    return sp


def _equal(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and torch.equal(a, b), (a.shape, b.shape)


CASES = [(_arterial(6), 1), (_arterial(6), 2), (_arterial(6), 3), (_arterial(6), 8),
         (_two_trees(), 8), (_random_forest(), 2), (_random_forest(), 8), (_tree(7), 1)]
IDS = ["arterial6-D1", "arterial6-D2", "arterial6-D3", "arterial6-D8", "two_trees-D8",
       "forest400-D2", "forest400-D8", "tree7-D1"]


def _shard_by_shard(ex, args, plain=True):
    """The executor's stages composed one shard at a time, each on the
    tables of that shard alone: ``(d, r, wn, part, lam)`` stacked."""
    outs = []
    for grp in ex.groups:
        for i in grp["members"]:
            tab = dist_tree.dist_shard_tables(ex.plan, ex.mesh.owned[i], grp["device"])
            ed = ex.shards[i]["edges"].edge_data(ex._N, ex._k, args[i], ex._modes, plain)
            outs.append((tab, ed, dist_tree.folds_plain(tab, [ed])))
    for tab, _, (d, r, wn, part) in outs:
        dist_tree.forward_plain(tab, d, r, wn, part)
    top = ex.top([o[2][3][0] for o in outs], plain=True)
    lam = [dist_tree.back_plain(tab, d, r, wn, top[ex.mesh.home])
           for tab, _, (d, r, wn, _) in outs]
    return [torch.cat([o[2][f] for o in outs]) for f in range(4)] + [torch.cat(lam)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_batched_plain_equals_per_shard_plain(case):
    """The batched folds, walk and back walk of a device's shards equal
    the per-shard plain versions shard by shard (``torch.equal``)."""
    graph, D = case
    sp = _solver(graph, D)
    ex = sp._dist_exec
    assert len(ex.groups) == 1 and ex.groups[0]["tables"].S == D
    args = ex.prepare_args(*sp._coeff_args)
    fw = ex.forward(0, args, plain=True)
    lam_T = ex.top(list(fw.part), plain=True)[ex.mesh.home]
    lam = dist_tree.back_plain(ex.groups[0]["tables"], fw.d, fw.r, fw.wn, lam_T)
    _equal((fw.d, fw.r, fw.wn, fw.part, lam), _shard_by_shard(ex, args))


@pytest.mark.parametrize("case", CASES[:4] + CASES[6:7], ids=IDS[:4] + IDS[6:7])
def test_grouped_solve_equals_shard_by_shard(case):
    """A whole grouped solve (``DistTreeExecutor.__call__``) gives each
    shard the λ of the shard-by-shard composition, and its fluxes are K8b's
    on that λ; on the ``["cpu"] * D`` mesh the wrappers are the plain
    versions, so the call and its ``plain`` twin are equal too."""
    graph, D = case
    sp = _solver(graph, D)
    ex = sp._dist_exec
    args = ex.prepare_args(*sp._coeff_args)
    q_T, p_T, lam_loc, lam_T, finite = ex(args)
    assert finite
    want = _shard_by_shard(ex, args)[4]
    B_loc = ex.plan.B_loc
    _equal(lam_loc, [want[j, :B_loc] for j in range(D)])
    _equal((lam_T,), (want[0, B_loc:],))
    q2, p2, lam2, lamT2, _ = ex.plain(args)
    _equal(q_T + p_T + lam_loc + [lam_T], q2 + p2 + lam2 + [lamT2])


def test_tables_refuse_what_the_walks_cannot_read():
    sp = _solver(_random_forest(), 4)
    plan = sp._dist_plan
    dist_tree.dist_shard_tables(plan, range(4), "cpu")
    with pytest.raises(ValueError, match="at least one shard"):
        dist_tree.dist_shard_tables(plan, [], "cpu")
    folds = list(plan.level_folds)
    bad = folds[0].copy()
    bad[0, 0, 0] = -1
    with pytest.raises(ValueError, match="fold names a child"):
        dist_tree.dist_shard_tables(plan._replace(level_folds=(bad,) + tuple(folds[1:])), 0, "cpu")
    lev = next(i for i, f in enumerate(folds)
               if f.shape[2] > 1 and np.any(f[0, :, 1] == f[0, :, 0] + 1))
    swapped = folds[lev].copy()
    row = int(np.flatnonzero(swapped[0, :, 1] == swapped[0, :, 0] + 1)[0])
    swapped[0, row, :2] = swapped[0, row, 1::-1]  # a parent's two children out of order
    with pytest.raises(ValueError, match="as a run"):
        dist_tree.dist_shard_tables(
            plan._replace(level_folds=tuple(folds[:lev]) + (swapped,) + tuple(folds[lev + 1:])), 0,
            "cpu")
    offs = plan.level_offsets
    pp = plan.parent_pos.copy()
    pp[0, offs[1]] = offs[1]  # a level-1 node naming itself: outside level 0
    with pytest.raises(ValueError, match="outside level 0"):
        dist_tree.dist_shard_tables(plan._replace(parent_pos=pp), 0, "cpu")


def test_launch_formula(monkeypatch):
    """3 launches a device (the folds, the walk, the back walk), and one
    more folds launch a :data:`MAX_SHARDS` shards beyond the first."""
    sp = _solver(_random_forest(), 8)
    tab = sp._dist_exec.groups[0]["tables"]
    assert dist_tree.cuda_launches(tab) == 3
    monkeypatch.setattr(dist_tree, "MAX_SHARDS", 3)
    assert dist_tree.cuda_launches(tab) == 2 + 3


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_dist_walk_kernels_on_card():
    """K22c's batched folds, walk and back walk equal their plain versions
    bit for bit (a shard's plain versions in a loop) in 3 launches, on two
    streams; on forests over 8 shards, a 12-generation tree over 1 (a level
    of 1,024 nodes: the walks' buffers in device memory) and a chain over 1
    (1,100 levels: the level table read from device memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for graph, D in ((_random_forest(), 8), (_arterial(6), 3), (_tree(12), 1), (_chain(1_100), 1)):
        sp = _solver(graph, D, device="cuda:0")
        ex = sp._dist_exec
        args = ex.prepare_args(*sp._coeff_args)
        tab = ex.groups[0]["tables"]
        eds = [ex.shards[i]["edges"].edge_data(ex._N, ex._k, args[i], ex._modes, False)
               for i in ex.groups[0]["members"]]
        before = dist_tree.LAUNCHES.launches
        got = dist_tree.folds(tab, eds)
        dist_tree.forward(tab, *got)
        lam_T = ex.top(list(got[3]))[dev]
        lam = dist_tree.back(tab, got[0], got[1], got[2], lam_T)
        assert dist_tree.LAUNCHES.launches - before == dist_tree.cuda_launches(tab) == 3
        want = dist_tree.folds_plain(tab, eds)
        dist_tree.forward_plain(tab, *want)
        _equal(got, want)
        _equal((lam,), (dist_tree.back_plain(tab, *want[:3], lam_T),))
        streams = [torch.cuda.Stream(dev) for _ in range(2)]
        outs = []
        torch.cuda.synchronize(dev)
        for st in streams:
            with torch.cuda.stream(st):
                f = dist_tree.folds(tab, eds)
                dist_tree.forward(tab, *f)
                outs.append(f + (dist_tree.back(tab, f[0], f[1], f[2], lam_T),))
        torch.cuda.synchronize(dev)
        for o in outs:
            _equal(o, got + (lam,))
