"""The T solve's host plan and its plain version (``kernels/shard_top.py``).

The sharded routes solve the top forest T of their shards' boundaries; the
reference factors its Laplacian densely (Jacobi-scaled ``cholesky`` +
``cho_solve``, ``networks_fenicsx_tpu/parallel/distributed_tree.py:489-503``).
The port's plan cuts T's runs of one-child nodes into segments of at most
``CHAIN`` nodes, round after round, and walks the forest left by levels.
Here: the plan's invariants on random forests, on chains and on a 1,128-node
T of the sharded forest's shape (711 levels, at most 2 wide, built from a
seed); ``check_t_plan`` refusing broken plans; and ``t_solve_plain`` against
a dense Cholesky solve and against the reference's own formula in JAX, at
1e-12·scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax.scipy.linalg

from networks_fenicsx_tpu_torch.kernels import shard_top

torch.set_num_threads(1)

TOL = 1e-12


def random_forest(n, seed, p_child=0.9):
    """Node i > 0 hangs from a node below it with probability ``p_child``."""
    rng = np.random.default_rng(seed)
    parent = np.full(n, -1, np.int64)
    for i in range(1, n):
        if rng.uniform() < p_child:
            parent[i] = rng.integers(0, i)
    return parent


def line(n):
    """A chain of n nodes, node 0 the root."""
    return np.arange(-1, n - 1, dtype=np.int64)


def sharded_forest_shape(seed):
    """A T of the 100k sharded forest's shape (1,128 nodes, 711 levels, one
    node with two children, two leaves): a root chain to a branching node,
    then two arms; the split point and the node numbering from ``seed``."""
    rng = np.random.default_rng(seed)
    a = int(rng.integers(150, 294))  # the stem's nodes below the root, the branch node last
    x = 710 - a  # the longer arm (x >= y) sets the 711 levels
    y = 1127 - a - x
    lab = rng.permutation(1128)
    parent = np.full(1128, -1, np.int64)
    chain = list(range(a + 1))
    arms = (list(range(a + 1, a + 1 + x)), list(range(a + 1 + x, 1128)))
    for i in chain[1:]:
        parent[lab[i]] = lab[i - 1]
    for arm in arms:
        prev = a
        for i in arm:
            parent[lab[i]] = lab[prev]
            prev = i
    return parent


def widths(parent):
    depth = np.full(parent.size, -1)
    depth[parent < 0] = 0
    while np.any(depth < 0):
        todo = np.flatnonzero(depth < 0)
        ok = depth[parent[todo]] >= 0
        depth[todo[ok]] = depth[parent[todo[ok]]] + 1
    return np.bincount(depth)


CASES = {
    "one": np.array([-1]),
    "empty": np.zeros(0, np.int64),
    "random7": random_forest(7, 1),
    "random60": random_forest(60, 2),
    "random300": random_forest(300, 3),
    "sparse400": random_forest(400, 5, p_child=0.99),
    "star": np.concatenate([[-1], np.zeros(50, np.int64)]),
    "line2": line(2),
    "line17": line(17),
    "line18": line(18),
    "line19": line(19),
    "line300": line(300),
    "sharded_forest": sharded_forest_shape(0),
    "sharded_forest_b": sharded_forest_shape(1),
}


def system(parent, seed):
    """A T Laplacian from ``seed`` as the sharded routes make one (diagonally
    dominant): ``(dT, rT, wT, dense L_T)``."""
    n = parent.size
    rng = np.random.default_rng(seed)
    has = parent >= 0
    wT = np.where(has, rng.uniform(0.5, 2.0, n), 0.0)
    dT = rng.uniform(0.1, 1.0, n) + wT
    np.add.at(dT, np.maximum(parent, 0), np.where(has, wT, 0.0))
    rT = rng.uniform(-1.0, 1.0, n)
    L = np.diag(dT)
    kids = np.flatnonzero(has)
    L[kids, parent[kids]] -= wT[kids]
    L[parent[kids], kids] -= wT[kids]
    return dT, rT, wT, L


@pytest.mark.parametrize("name", list(CASES))
def test_t_plan_covers_the_forest(name):
    """Every node in one segment or in the forest left, segments of 1 to
    CHAIN one-child nodes, the forest left with children as runs, and no
    node with one child left once the rounds are done (roots aside)."""
    parent = CASES[name]
    rounds, rows, lvl_off, depth = shard_top.t_plan(parent)
    shard_top.check_t_plan(parent, rounds, rows, lvl_off)
    assert depth == (widths(parent).size if parent.size else 0)
    assert all(1 <= n <= shard_top.CHAIN for rd in rounds for n in rd.segs[:, 3])
    inner = np.concatenate([rd.chain for rd in rounds]) if rounds else np.zeros(0, np.int64)
    assert inner.size + rows.shape[0] == parent.size
    assert np.unique(np.concatenate([inner, rows[:, 0]])).size == parent.size
    one_child = (rows[:, 3] == 1) & (rows[:, 1] >= 0)
    assert not one_child.any()


@pytest.mark.parametrize("n,rounds", [(2, 0), (3, 1), (18, 1), (19, 2), (300, 3), (5000, 4)])
def test_t_plan_compresses_a_chain(n, rounds):
    """A chain of n nodes: its n - 2 one-child nodes in ceil((n - 1) / 17)
    segments, the cut points a chain for the next round, until one segment
    holds the rest; the root and the leaf are left, 2 levels."""
    got, rows, lvl_off, depth = shard_top.t_plan(line(n))
    assert (len(got), rows.shape[0], depth) == (rounds, 2, n)
    if got:
        assert got[0].segs.shape[0] == -(-(n - 1) // (shard_top.CHAIN + 1))
    assert lvl_off.size - 1 == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_t_plan_on_the_sharded_forest_shape(seed):
    """1,128 nodes in 711 levels at most 2 wide: 3 rounds leave the root,
    the branching node and the two leaves, 3 levels to walk."""
    parent = sharded_forest_shape(seed)
    w = widths(parent)
    assert (parent.size, w.size, int(w.max())) == (1128, 711, 2)
    kids = np.bincount(parent[parent >= 0], minlength=parent.size)
    assert (int(np.sum(kids == 1)), int(np.sum(kids == 2)), int(np.sum(kids == 0))) == (1125, 1, 2)
    tf = shard_top.t_forest(parent, "cpu")
    assert (len(tf.rounds), tf.rows.shape[0], tf.n_lvl, tf.depth) == (3, 4, 3, 711)
    assert sum(rd.chain.size for rd in tf.rounds) == 1124


def _broken(plan, how):
    rounds, rows, lvl_off = (list(plan[0]), plan[1].copy(), plan[2].copy())
    rd = rounds[0]
    if how == "node_twice":
        chain = rd.chain.copy()
        chain[1] = chain[0]
        rounds[0] = dataclasses.replace(rd, chain=chain)
    elif how == "not_a_path":
        chain = rd.chain.copy()
        chain[[0, 1]] = chain[[1, 0]]
        rounds[0] = dataclasses.replace(rd, chain=chain)
    elif how == "gather":
        g = rd.gathers.copy()
        g[0, 2] += 1
        rounds[0] = dataclasses.replace(rd, gathers=g)
    elif how == "left_parent":
        rows[-1, 1] = rows[0, 0]
    elif how == "left_runs":
        rows[[0, 1]] = rows[[1, 0]]
    elif how == "dropped_round":
        rounds = rounds[1:]
    return rounds, rows, lvl_off


@pytest.mark.parametrize("how", ["long_segment", "node_twice", "not_a_path", "gather",
                                 "left_parent", "left_runs", "dropped_round"])
def test_check_t_plan_refuses_a_broken_plan(how, monkeypatch):
    parent = sharded_forest_shape(3)
    if how == "long_segment":  # a plan cut for a longer chain than the kernel's
        monkeypatch.setattr(shard_top, "CHAIN", 2 * shard_top.CHAIN)
    plan = shard_top.t_plan(parent)
    monkeypatch.undo()
    if how == "long_segment":
        with pytest.raises(ValueError, match="T plan"):
            shard_top.check_t_plan(parent, *plan[:3])
        return
    shard_top.check_t_plan(parent, *plan[:3])
    with pytest.raises(ValueError, match="T plan"):
        shard_top.check_t_plan(parent, *_broken(plan, how))


def test_t_plan_refuses_a_cycle():
    with pytest.raises(ValueError, match="not a forest"):
        shard_top.t_plan(np.array([1, 2, 0, -1]))


def jax_reference(parent, dT, rT, wT):
    """The reference's T solve as ``distributed_tree.py:489-503`` writes it:
    the dense L_T, Jacobi-scaled, ``cholesky`` and ``cho_solve``."""
    Tn = parent.size
    tp = jnp.asarray(parent)
    has_p = tp >= 0
    tps = jnp.where(has_p, tp, 0)
    LT = jnp.zeros((Tn, Tn), dtype=jnp.float64)
    LT = LT.at[jnp.arange(Tn), jnp.arange(Tn)].add(jnp.asarray(dT))
    wTp = jnp.where(has_p, jnp.asarray(wT), 0.0)
    LT = LT.at[jnp.arange(Tn), tps].add(-wTp)
    LT = LT.at[tps, jnp.arange(Tn)].add(-wTp)
    scale = jnp.sqrt(jnp.diagonal(LT))
    LTs = (LT / scale[:, None]) / scale[None, :]
    chol = jnp.linalg.cholesky(LTs)
    return np.asarray(jax.scipy.linalg.cho_solve((chol, True), jnp.asarray(rT) / scale) / scale)


@pytest.mark.parametrize("name", [n for n in CASES if n != "empty"])
def test_t_solve_plain_equals_dense_and_reference(name):
    """λ_T of the segments' order against a dense Cholesky solve and the
    reference's formula in JAX, both at 1e-12·scale; the norm in the
    kernel's order against the plain sum."""
    parent = CASES[name]
    dT, rT, wT, L = system(parent, 11)
    tf = shard_top.t_forest(parent, "cpu")
    sq = torch.tensor(0.25, dtype=torch.float64)
    lam, norm = shard_top.t_solve(tf, *(torch.as_tensor(a) for a in (dT, rT, wT)), sq)
    dense = torch.cholesky_solve(torch.as_tensor(rT)[:, None],
                                 torch.linalg.cholesky(torch.as_tensor(L)))[:, 0].numpy()
    ref = jax_reference(parent, dT, rT, wT)
    scale = max(1.0, float(np.abs(dense).max()))
    assert float(np.abs(lam.numpy() - dense).max()) <= TOL * scale
    assert float(np.abs(lam.numpy() - ref).max()) <= TOL * scale
    assert abs(float(norm) - float(np.sqrt(0.25 + np.sum(rT * rT)))) <= 1e-14 * max(1.0, float(norm))


@pytest.mark.parametrize("name", ["random300", "line300", "sharded_forest"])
@pytest.mark.parametrize("rounds", [0, 1, 2])
def test_fewer_rounds_give_the_same_solve(name, rounds):
    """Capping the rounds (0: the plain level walk of T) changes the order of
    the elimination, not λ_T beyond roundoff."""
    parent = CASES[name]
    dT, rT, wT, _ = (torch.as_tensor(a) for a in system(parent, 12))
    want = shard_top.t_solve(shard_top.t_forest(parent, "cpu"), dT, rT, wT)[0]
    tf = shard_top.t_forest(parent, "cpu", rounds=rounds)
    assert len(tf.rounds) <= rounds
    got = shard_top.t_solve(tf, dT, rT, wT)[0]
    assert float((got - want).abs().max()) <= TOL * max(1.0, float(want.abs().max()))


def test_t_forest_table_layout():
    """The device table's header points at its sections in order and ends
    with the forest left's node count."""
    parent = sharded_forest_shape(4)
    tf = shard_top.t_forest(parent, "cpu")
    tab = tf.table.numpy()
    R, n_lvl, *offs, F = tab[:10].tolist()
    assert (R, n_lvl, F) == (len(tf.rounds), tf.n_lvl, tf.rows.shape[0])
    assert offs[0] == 10 and offs == sorted(offs)
    seg_off = tab[offs[0] : offs[0] + R + 1]
    assert seg_off.tolist() == np.cumsum([0] + [rd.segs.shape[0] for rd in tf.rounds]).tolist()
    assert tab[offs[5] : offs[5] + 4 * F].reshape(F, 4).tolist() == tf.rows.tolist()
    assert tab[offs[6] :].tolist() == tf.lvl_off.tolist()
