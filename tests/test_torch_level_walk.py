"""K7's level elimination as depth-bound walks (``kernels/level_eliminate.py``).

The level route folds and back-substitutes the forest's levels by a
schedule made once per plan (:func:`walk_schedule`): each run of consecutive
levels no wider than ``WALK_MAX`` is one launch of one block each way, each
wider level one grid launch each way.  On the CPU:

* :func:`level_walk_plain` — the arithmetic in the schedule's grouping, each
  parent gathering its children's terms as a ``(first, count)`` run, and
  the norm in the norm kernel's order — equals ``level_eliminate_plain`` and
  ``level_eliminate_system_plain`` (λ by ``torch.equal``, the norm, which
  torch adds in its own order, at 1e-15·scale) on irregular forests, an arterial tree with levels wider
  than a walk, a chain and two trees side by side, also with walks as narrow
  as 2 (runs and grid levels interleaved);
* on one case it meets the JAX package's ``_level_eliminate`` at
  1e-12·scale;
* the schedule and the launch formula, and the plan check that refuses
  children that are not a run or a parent outside the level above.

The ``cuda``-marked test holds the kernels against the walk's plain version
bit for bit, on two streams, in the formula's launches as the launchers
report them.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch.edge_data import _EdgeData
from networks_fenicsx_tpu_torch.kernels import level_eliminate as LE
from networks_fenicsx_tpu_torch.kernels import segsum

from test_torch_levels import _close, _edge_problem

torch.set_num_threads(1)


def _irregular(n, seed):
    return lambda pkg: pkg.network_generation.make_random_network(n, keep=0.0, seed=seed, arrays=True)


def _arterial(gens):
    return lambda pkg: pkg.network_generation.make_arterial_tree(
        gens, direction=np.array([0.1, 1.0, 0.0]), arrays=True)


def _chain(n_nodes):
    pos = np.asarray([[float(i), 0.0] for i in range(n_nodes)])
    edges = np.asarray([[i, i + 1] for i in range(n_nodes - 1)], np.int64)
    return lambda pkg: pkg.ArrayNetwork(pos=pos, edges=edges)


def _two_trees(pkg):
    """The disjoint union of make_tree(4, 1, 2) and make_tree(3, 2, 1): two roots."""
    a = pkg.network_generation.make_tree(4, 1.0, 2.0, arrays=True)
    b = pkg.network_generation.make_tree(3, 2.0, 1.0, arrays=True)
    pos_a, pos_b = np.asarray(a.pos), np.asarray(b.pos)
    edges = np.concatenate([np.asarray(a.edges), np.asarray(b.edges) + pos_a.shape[0]])
    return pkg.ArrayNetwork(pos=np.concatenate([pos_a, pos_b]), edges=edges)


GRAPHS = {
    "irregular120": _irregular(120, 5),
    "irregular400": _irregular(400, 7),
    "irregular200": _irregular(200, 3),
    "arterial10": _arterial(10),
    "chain300": _chain(300),
    "two_trees": _two_trees,
}


def _plans(graph, device="cpu"):
    asm = P.HydraulicNetworkAssembler(P.NetworkMesh(graph(P), N=2))
    asm.compute_forms(p_bc_ex=lambda x: x[0])
    tp = PL._plan_tree_elimination(asm)
    lp = PL._plan_level_elimination(asm, tp)
    return asm, tp, lp, PL.device_level_plan(lp, tp, device)


def _system(dlp, seed, device="cpu"):
    """A random public-order ``dr (B, 2)`` (diagonally dominant) and pair
    conductances, from a seed."""
    rng = np.random.default_rng(seed)
    B, Pn = dlp.num_bifurcations, dlp.num_pairs
    dr = np.stack([rng.uniform(3.0, 5.0, B), rng.standard_normal(B)], axis=1)
    w = rng.uniform(0.5, 1.0, Pn)
    return (torch.as_tensor(dr, device=device), torch.as_tensor(w, device=device))


def _edge_data(dlp, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    E = dlp.num_edges
    sb, eb = dlp.start_bif.cpu().numpy(), dlp.end_bif.cpu().numpy()

    def t(a):
        return torch.as_tensor(a, device=device)

    return _EdgeData(mt=None, cumF=t(rng.uniform(-1, 1, E))[None, :], W=t(rng.uniform(0.5, 2.0, E)),
                     g=t(rng.uniform(-1, 1, E)), start_bif=dlp.start_bif, end_bif=dlp.end_bif,
                     start_pbc=t(np.where(sb < 0, rng.uniform(-1, 1, E), 0.0)),
                     end_pbc=t(np.where(eb < 0, rng.uniform(-1, 1, E), 0.0)), interior=())


def _walk_plain(dlp, dr, w_pairs):
    """:func:`LE.level_walk_plain` from a public-order system."""
    dr_perm = torch.empty_like(dr)
    dr_perm[dlp.perm.long()] = dr
    return LE.level_walk_plain(dlp, dr_perm, w_pairs)


def _equal(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and torch.equal(a, b), (a.shape, b.shape)


@pytest.mark.parametrize("walk_max", [LE.WALK_MAX, 2], ids=["walk128", "walk2"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walk_plain_equals_level_plain(name, walk_max, monkeypatch):
    """The walk's grouping computes the plain versions' λ and ‖rhs‖ to the
    bit, from the edge data and from an assembled system."""
    monkeypatch.setattr(LE, "WALK_MAX", walk_max)
    _, _, _, dlp = _plans(GRAPHS[name])
    wide = int(np.sum(np.diff(dlp.host_offsets) > walk_max))
    assert int(np.sum(dlp.walk.back[:, 0] == LE.GRID)) == wide
    for got, want in ((_walk_plain(dlp, *_system(dlp, 1)),
                       LE.level_eliminate_system_plain(dlp, *_system(dlp, 1))),
                      (LE.level_walk_plain(dlp, *LE._pair_sums_plain(dlp, _edge_data(dlp, 2))),
                       LE.level_eliminate_plain(dlp, _edge_data(dlp, 2)))):
        _equal(got[:1], want[:1])
        _close(got[1], want[1].numpy(), tol=1e-15)  # the norm kernel's order, not torch's


def test_norm_in_the_kernel_order():
    """The walk's norm adds lane by lane (1,024 lanes) and then by halving
    strides, as the norm kernel does: a NumPy model of that order, to the
    bit."""
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(3_000))
    lanes = np.zeros(1024)
    for i, v in enumerate(x.numpy()):
        lanes[i % 1024] = lanes[i % 1024] + v * v
    stride = 512
    while stride:
        lanes[:stride] = lanes[:stride] + lanes[stride:2 * stride]
        stride //= 2
    assert float(LE._norm_plain(x)) == float(np.sqrt(lanes[0]))


def test_walk_meets_reference():
    """On an irregular forest with quadrature R, the walk's λ and ‖rhs‖
    meet the JAX package's ``_level_eliminate`` at 1e-12·scale."""
    aj, ap, lj, dlp, _, ed_j, ed_p = _edge_problem(3, "quad", "edge", False, seed=6)
    lam_j, norm_j = JS._level_eliminate(lj, ed_j, ap.network.num_multipliers)
    lam, norm = LE.level_walk_plain(dlp, *LE._pair_sums_plain(dlp, ed_p))
    _close(lam, lam_j)
    _close(norm, norm_j)


def test_schedule_groups_runs_and_wide_levels():
    """Rows of :func:`walk_schedule` on widths 1, 2, 300, 4, 4, 4, 200, 8:
    forward deepest first, a walk a run of narrow folds; back root first, a
    walk a run of narrow levels, a grid row a wide level."""
    offs = np.concatenate([[0], np.cumsum([1, 2, 300, 4, 4, 4, 200, 8])])
    fwd, back = LE.walk_schedule(offs)
    W, G = LE.WALK, LE.GRID
    assert fwd.tolist() == [[G, 6, 6], [G, 5, 5], [W, 3, 5], [G, 2, 2], [G, 1, 1], [W, 0, 1]]
    assert back.tolist() == [[W, 0, 1], [G, 2, 2], [W, 3, 5], [G, 6, 6], [W, 7, 7]]
    assert fwd.dtype == back.dtype == np.int32


@pytest.mark.parametrize("name,launches", [("irregular400", 6), ("chain300", 6), ("arterial10", 8)])
def test_launch_formula(name, launches):
    """Prepare, K6's sums, the assembly, the norm and a launch a schedule
    row: 6 on a forest no wider than a walk, whatever its depth; an arterial
    tree adds 2 a level wider than 128 (10 generations: one level of 256)."""
    _, _, _, dlp = _plans(GRAPHS[name])
    walk = dlp.walk
    assert LE.cuda_launches(dlp) == 4 + len(walk.fwd) + len(walk.back) == launches
    wide = int(np.sum(np.diff(dlp.host_offsets) > LE.WALK_MAX))
    assert launches == 6 + 2 * wide


def test_plan_refuses_children_that_are_not_a_run():
    """:func:`levels.check_child_runs` at upload: a level whose children
    are not grouped by parent, and a parent outside the level above."""
    _, tp, lp, _ = _plans(GRAPHS["irregular400"])
    offs = lp.level_offsets
    pp = lp.parent_pos
    lev = next(l for l in range(1, len(offs) - 1)
               if len(np.unique(pp[offs[l]:offs[l + 1]])) > 1)
    o, o1 = offs[lev], offs[lev + 1]
    i = o
    j = next(x for x in range(o, o1) if pp[x] != pp[i])
    swapped = pp.copy()
    swapped[i], swapped[j] = pp[j], pp[i]  # two children of different parents trade places
    with pytest.raises(ValueError, match="not a run"):
        PL.device_level_plan(lp._replace(parent_pos=swapped), tp, "cpu")
    same = pp.copy()
    same[offs[1]] = offs[1]  # a level-1 node naming itself: not in the level above
    with pytest.raises(ValueError, match="level above"):
        PL.device_level_plan(lp._replace(parent_pos=same), tp, "cpu")


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_level_walk_kernels_on_card(monkeypatch):
    """K7's walks and grid levels equal the walk's plain version bit for
    bit (λ and ‖rhs‖, from edge data and from a system), on forests, an
    arterial tree with levels wider than a walk, a chain of 2,100 levels
    (the level table read from device memory) and walks as narrow as 2, on
    two streams, in the formula's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cases = [("irregular400", LE.WALK_MAX), ("arterial10", LE.WALK_MAX), ("two_trees", LE.WALK_MAX),
             ("chain2100", LE.WALK_MAX), ("irregular400", 2)]
    for name, walk_max in cases:
        monkeypatch.setattr(LE, "WALK_MAX", walk_max)
        graph = _chain(2_103) if name == "chain2100" else GRAPHS[name]
        _, _, _, dlp = _plans(graph, dev)
        dr, w_pairs = _system(dlp, 3, dev)
        got = LE.level_eliminate_system(dlp, dr, w_pairs)
        _equal(got, _walk_plain(dlp, dr, w_pairs))
        ed = _edge_data(dlp, 4, dev)
        want = LE.level_walk_plain(dlp, *LE._pair_sums_plain(dlp, ed))
        before = (LE.LAUNCHES.device, segsum.LAUNCHES.launches)
        _equal(LE.level_eliminate(dlp, ed), want)
        enqueued = LE.LAUNCHES.device - before[0] + segsum.LAUNCHES.launches - before[1]
        assert enqueued == LE.cuda_launches(dlp), (name, enqueued)
        streams = [torch.cuda.Stream(dev) for _ in range(2)]
        outs = []
        torch.cuda.synchronize(dev)
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(LE.level_eliminate(dlp, ed))
        torch.cuda.synchronize(dev)
        for o in outs:
            _equal(o, want)
