"""K9's packed peel table and its order, on the CPU and the card.

A :class:`~networks_fenicsx_tpu_torch.tree.DeviceTreePlan` packs its peel
rounds and its cycle core into one int32 table (``dtp.peel_table``,
:mod:`networks_fenicsx_tpu_torch.ops.peel_table`) that K9's launches walk.
Here:

* the table's check passes on web1000's and a 300-site web's plans, a
  network without pairs, a peeled tree with no core and a star whose hub
  takes 100 leaves in one round (a fold of two levels), and refuses every
  corruption it names;
* the plain version in the kernels' order (``peel_table_plain``: every
  index from the table, terms summed row by row in fold order, the core's
  gather on each node's last update, a core parent's λ from the core's
  solution) equals ``peel_plain`` bit for bit (``torch.equal``), and both
  stay within 1e-12·scale of the JAX package's ``_tree_eliminate`` (the
  one test that imports JAX, inside its body);
* the launch lists: one block a run of rounds narrower than the cut, a
  grid launch a fold level of a wider round, the duty on the first and
  last launch or its own, and ``tree.cuda_launches``' formula.

The ``cuda``-marked tests hold the kernels, at three cut widths, to both
plain versions bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch import tree as PT
from networks_fenicsx_tpu_torch.kernels import dense_core, mf_apply, mf_factor, peel
from networks_fenicsx_tpu_torch.mesh import ArrayNetwork
from networks_fenicsx_tpu_torch.ops import peel_table as W

torch.set_num_threads(1)


def _web(n):
    return P.network_generation.make_random_network(n, keep=0.05, seed=7, arrays=True)


def _star(leaves=100):
    """A hub on a triangle of bifurcations with ``leaves`` leaf bifurcations,
    each with a boundary stub: one round peels every leaf into the hub."""
    ang = np.linspace(0.0, 2 * np.pi, leaves, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], 1)
    pos = np.concatenate([[[0.0, 0.0], [0.3, 0.1], [0.1, 0.3]], 2 * ring, 3 * ring])
    leaf = 3 + np.arange(leaves)
    edges = np.concatenate([[[0, 1], [1, 2], [2, 0]],
                            np.stack([np.zeros(leaves, np.int64), leaf], 1),
                            np.stack([leaf, leaf + leaves], 1)])
    return ArrayNetwork(pos=pos, edges=edges.astype(np.int64))


def _no_pairs():
    """Two junctions of three boundary stubs each: bifurcations, no pair."""
    pos = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0],
                    [5.0, 0.0], [6.0, 0.0], [5.0, 1.0], [4.0, 0.0]])
    edges = np.array([[1, 0], [0, 2], [0, 3], [5, 4], [4, 6], [4, 7]], np.int64)
    return ArrayNetwork(pos=pos, edges=edges)


GRAPHS = {
    "web1000": (lambda: _web(1000), False),
    "web300": (lambda: _web(300), False),
    "no-pairs": (_no_pairs, True),
    "tree-no-core": (lambda: P.network_generation.make_arterial_tree(5, arrays=True), True),
    "star": (_star, False),
}


@functools.cache
def _assembler(name):
    return P.HydraulicNetworkAssembler(P.NetworkMesh(GRAPHS[name][0](), N=1, color_strategy="fast"))


def _plan(name, device="cpu"):
    """The tree plan (rounds forced on forests) on ``device``."""
    ap = _assembler(name)
    tp = PL._plan_tree_elimination(ap, force_rounds=GRAPHS[name][1])
    return PT.device_tree_plan(tp, PL._build_lambda_plan(ap), ap, device)


def _system(dtp, seed):
    """Seeded ``(dr (B, 2), w_pairs)`` of a diagonally dominant system."""
    pairs = dtp.plan.pair_nodes
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, pairs.shape[0])
    diag = rng.uniform(0.1, 1.0, dtp.num_bifurcations)
    np.add.at(diag, pairs[:, 0], w)
    np.add.at(diag, pairs[:, 1], w)
    dr = np.stack([diag, rng.standard_normal(dtp.num_bifurcations)], 1)
    return torch.as_tensor(dr), torch.as_tensor(w)


def _dense(dtp, w):
    def solve(dc, rc):
        return dense_core.dense_core_plain(dtp.core_ci, dtp.core_cj, dtp.core_pid, dc, rc, w)
    return solve


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_peel_table_checks_and_describes_the_plan(name):
    """The table passes its check and gives back each round's arrays; the
    star's round has a fold of two levels."""
    dtp = _plan(name)
    words = dtp.peel_table.host.astype(np.int64)
    W.check_peel_table(words, dtp.num_bifurcations, dtp.num_pairs)
    assert dtp.peel_table.rounds == len(dtp.rounds)
    assert dtp.n_peeled + dtp.core_size == dtp.num_bifurcations
    for k, (elim, parents, pair_ids) in enumerate(dtp.plan.rounds):
        got = W.round_arrays(words, k)
        upar, fold = PT.round_tables(elim, parents)
        assert np.array_equal(got["elim"], elim) and np.array_equal(got["parents"], parents)
        assert np.array_equal(got["pair_ids"], pair_ids) and np.array_equal(got["upar"], upar)
        assert [lv.tolist() for lv, _ in got["fold"]] == [lv.tolist() for lv in fold]
    folds = [len(W.round_arrays(words, k)["fold"]) for k in range(len(dtp.rounds))]
    if name == "star":
        assert folds[0] == 2 and dtp.rounds[0].size == 100 and dtp.core_size == 3
    if name == "no-pairs":
        assert dtp.num_pairs == 0 and folds == [0]
    if name == "tree-no-core":
        assert dtp.core_size == 0 and len(dtp.rounds) > 1


def _child(words, k):
    """A child with a parent in round k, and its row and column in the fold."""
    rd = W.round_arrays(words, k)
    lv = rd["fold"][0][0]
    row, col = np.argwhere(lv < rd["n"])[0]
    return rd, int(lv[row, col]), int(row), int(col)


def _corrupt(words, what):
    """``words`` with one corruption (a copy); the message the check gives."""
    w = words.copy()
    B = int(w[W.H_B])
    r0, r1 = W.round_arrays(w, 0), W.round_arrays(w, 1)
    rd, i, row, col = _child(w, 1)
    two = next(k for k in range(int(w[W.H_ROUNDS])) if W.round_arrays(w, k)["U"] >= 2)
    rt = W.round_arrays(w, two)
    lv = rt["fold"][0][0]
    if what == "elim out of range":
        r0["elim"][0] = B
        return w, "elim outside"
    if what == "parent out of range":
        rd["parents"][i] = B
        return w, "parents outside"
    if what == "pair id out of range":
        rd["pair_ids"][i] = int(w[W.H_P])
        return w, "pair ids outside"
    if what == "a parent without a pair":
        rd["pair_ids"][i] = -1
        return w, "a parent and no pair"
    if what == "fold index out of range":
        rd["fold"][0][0][row, col] = rd["n"] + 1
        return w, "fold level 0 outside"
    if what == "eliminated twice":
        r1["elim"][0] = r0["elim"][0]
        return w, "eliminates a node eliminated before"
    if what == "parent eliminated before":
        rd["parents"][i] = r0["elim"][0]
        return w, "eliminated in that round or before"
    if what == "parent eliminated in its round":
        rd["parents"][i] = rd["elim"][(i + 1) % rd["n"]]
        return w, "eliminated in that round or before"
    if what == "upar not sorted":
        rt["upar"][[0, 1]] = rt["upar"][[1, 0]]
        return w, "not sorted and unique"
    if what == "upar not unique":
        rt["upar"][1] = rt["upar"][0]
        return w, "not sorted and unique"
    if what == "a child named twice":
        a = lv[0][lv[0] < rt["n"]][0]
        lv[1, 0] = a
        return w, "names an entry twice"
    if what == "a child of another parent":
        lv[0, 0], lv[1, 0] = lv[1, 0], lv[0, 0]
        return w, "whose parent is another node"
    if what == "a core node peeled":
        W._array(w, int(w[W.H_CORE]), 1, "core")[0] = r0["elim"][0]
        return w, "a core node is also peeled"
    if what == "a wrong core gather":
        hit = np.flatnonzero(rt["ucore"] >= 0)
        rt["ucore"][hit[0] if hit.size else 0] = -1 if hit.size else 0
        return w, "core gathers"
    if what == "a wrong back parent":
        rd["bpar"][i] = -1
        return w, "bpar"
    if what == "a wrong local slot":
        r1["lelim"][0] += 1
        return w, "local slots are not its nodes'"
    if what == "a staged array outside its run":
        f, b = W.entries(w)
        f[0, W.E_HI] = b[-1, W.E_HI] = f[0, W.E_HI] - 1
        return w, "reads outside the run"
    if what == "a run's shared memory too small":
        f, b = W.entries(w)
        f[0, W.E_SMEM] = b[-1, W.E_SMEM] = f[0, W.E_SMEM] - 8
        return w, "bytes of shared memory"
    if what == "a wrong back source":
        f, _ = W.entries(w)
        W._array(w, int(f[0, W.E_BSRC]), 1, "bsrc")[0] += 1
        return w, "bsrc is not where"
    if what == "a saved offset":
        w[W.HEAD_WORDS + W.ROUND_WORDS + W.R_OFF] += 1
        return w, "saved offset"
    if what == "a round left out of the launches":
        f, _ = W.entries(w)
        f[-1, W.E_LAST] -= 1
        return w, "walk every round"
    if what == "the scatter left out":
        _, b = W.entries(w)
        b[0, W.E_DUTY] = 0
        return w, "back duty is taken 0 times"
    raise AssertionError(what)


CORRUPTIONS = ("elim out of range", "parent out of range", "pair id out of range",
               "a parent without a pair", "fold index out of range", "eliminated twice",
               "parent eliminated before", "parent eliminated in its round", "upar not sorted",
               "upar not unique", "a child named twice", "a child of another parent",
               "a core node peeled", "a wrong core gather", "a wrong back parent", "a saved offset",
               "a round left out of the launches", "the scatter left out", "a wrong local slot",
               "a staged array outside its run", "a run's shared memory too small",
               "a wrong back source")


@pytest.mark.parametrize("what", CORRUPTIONS)
def test_peel_table_refuses_a_corrupted_table(what):
    """Each corruption of web1000's table raises before any launch."""
    dtp = _plan("web1000")
    words = dtp.peel_table.host.astype(np.int64)
    bad, match = _corrupt(words, what)
    with pytest.raises(ValueError, match=match):
        W.check_peel_table(bad, dtp.num_bifurcations, dtp.num_pairs)
    W.check_peel_table(words, dtp.num_bifurcations, dtp.num_pairs)  # the original stands


def test_peel_table_refuses_wrong_grid_reads(monkeypatch):
    """A grid round reads each node from the copy that holds it (the
    assembled system until a round updates it), and its first fold level
    as (child, pair) entries that are the fold's; a run reads its slots so."""
    monkeypatch.setattr(peel, "CUT", 16)
    dtp = _plan("web1000")
    words = dtp.peel_table.host.astype(np.int64)
    rd = W.round_arrays(words, 1)
    assert rd["fsrc"] is not None and rd["lelim"] is None
    B = dtp.num_bifurcations
    assert np.any(rd["usrc"] >= B) and np.any(rd["esrc"] >= B)  # round 0 updated some of them
    for key, match in (("fsrc", "fold children"), ("fpid", "fold children"), ("esrc", "wrong copy"),
                       ("usrc", "wrong copy")):
        bad = words.copy()
        W.round_arrays(bad, 1)[key][0] += B
        with pytest.raises(ValueError, match=match):
            W.check_peel_table(bad, B, dtp.num_pairs)
    fwd, _ = W.entries(words)
    run = fwd[fwd[:, W.E_KIND] == W.BLOCK][0]
    bad = words.copy()
    W._array(bad, int(run[W.E_SSRC]), 1, "ssrc")[0] += B
    with pytest.raises(ValueError, match="reads its slots from the wrong copy"):
        W.check_peel_table(bad, B, dtp.num_pairs)


def test_peel_table_refuses_another_system():
    dtp = _plan("web300")
    words = dtp.peel_table.host.astype(np.int64)
    with pytest.raises(ValueError, match="made for"):
        W.check_peel_table(words, dtp.num_bifurcations + 1, dtp.num_pairs)


@pytest.mark.parametrize("cut", [1024, 16, 1])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_table_plain_equals_peel_plain(monkeypatch, name, cut):
    """The kernels' order from the table, cut into grid rounds or not: λ
    bit for bit with the reference's transcription, ``dr`` untouched."""
    monkeypatch.setattr(peel, "CUT", cut)
    dtp = _plan(name)
    dr, w = _system(dtp, seed=4)
    before = dr.clone()
    want = peel.peel_plain(dtp, dr, w, _dense(dtp, w))
    got = peel.peel_table_plain(dtp, dr, w, _dense(dtp, w))
    assert torch.equal(got, want), name
    assert torch.equal(dr, before)
    assert torch.equal(peel.peel(dtp, dr, w, _dense(dtp, w)), want)  # CPU: the plain version


def test_table_plain_matches_the_reference():
    """``peel_table_plain`` and ``peel`` with the dense core against the JAX
    package's ``_tree_eliminate`` on the same seeded system (web1000: 11
    rounds, a 455-node core) at 1e-12·scale."""
    import jax
    import jax.numpy as jnp

    import networks_fenicsx_tpu as J
    from networks_fenicsx_tpu import solver as JS

    aj = J.HydraulicNetworkAssembler(J.NetworkMesh(
        J.network_generation.make_random_network(1000, keep=0.05, seed=7, arrays=True), N=1,
        color_strategy="fast"))
    pj = JS._plan_tree_elimination(aj)
    dtp = _plan("web1000")
    assert len(dtp.rounds) == 11 and dtp.core_size == 455
    dr, w = _system(dtp, seed=0)
    want = np.asarray(jax.jit(lambda d, r, wp: JS._tree_eliminate(pj, d, r, wp))(
        jnp.asarray(dr[:, 0].numpy()), jnp.asarray(dr[:, 1].numpy()), jnp.asarray(w.numpy())))
    scale = max(1.0, float(np.abs(want).max()))

    def core(dc, rc):
        return dense_core.dense_core(dtp.core_ci, dtp.core_cj, dtp.core_pid, dc, rc, w)

    for fn in (peel.peel_table_plain, peel.peel):
        got = fn(dtp, dr, w, core).numpy()
        assert float(np.abs(got - want).max()) <= 1e-12 * scale, fn.__name__


def test_launch_lists(monkeypatch):
    """web1000's 11 rounds: one block each way with the duty; cut at 64:
    a grid launch a round of at least 64 nodes, a block a narrower run; the
    star's 100-leaf round at a cut of 64: two grid launches forward (its two
    fold levels), one back."""
    dtp = _plan("web1000")
    fwd, back = W.entries(dtp.peel_table.host.astype(np.int64))
    assert fwd[:, :W.E_LO].tolist() == back[:, :W.E_LO].tolist() == [[W.BLOCK, 0, 11, 0, 1, 1]]
    assert peel.cuda_launches(dtp) == 2
    monkeypatch.setattr(peel, "CUT", 64)
    dtp = _plan("web1000")
    sizes = [rd.size for rd in dtp.rounds]
    wide = sum(s >= 64 for s in sizes)
    assert sizes == sorted(sizes, reverse=True) and 0 < wide < len(sizes)
    fwd, back = W.entries(dtp.peel_table.host.astype(np.int64))
    assert [e[W.E_KIND] for e in fwd] == [W.GRID] * wide + [W.BLOCK]
    assert [e[W.E_KIND] for e in back] == [W.BLOCK] + [W.GRID] * wide
    assert fwd[0, W.E_DUTY] == 1 and back[-1, W.E_DUTY] == 1
    early = int(dtp.peel_table.host[W.H_NEARLY])
    assert fwd[0, W.E_BLOCKS] * W.GRID_THREADS >= max(sizes[0], early)
    assert peel.cuda_launches(dtp) == 2 * (wide + 1)
    star = _plan("star")
    fwd, back = W.entries(star.peel_table.host.astype(np.int64))
    assert [tuple(e[:4]) for e in fwd] == [(W.GRID, 0, 1, 0), (W.GRID, 0, 1, 1)]
    assert [tuple(e[:4]) for e in back] == [(W.GRID, 0, 1, 0)] and peel.cuda_launches(star) == 3


def test_duty_takes_its_own_launch_when_a_block_cannot():
    """A core wider than a block takes when the first round runs in one
    block: a grid launch of the gather before it and of the scatter after."""
    rounds = [(np.array([0]), np.array([1]), np.array([0]), np.array([1]), (np.array([[0]]),))]
    B = W.DUTY_IN_BLOCK + 3  # a gather of DUTY_IN_BLOCK + 1 nodes
    core = np.arange(1, B)
    words = W.pack_peel_table(rounds, core, B, 1)
    W.check_peel_table(words, B, 1)
    fwd, back = W.entries(words)
    assert [e[W.E_KIND] for e in fwd] == [W.DUTY, W.BLOCK]
    assert [e[W.E_KIND] for e in back] == [W.BLOCK, W.DUTY]
    assert int(words[W.H_NEARLY]) == B - 2  # node 1, the parent, is gathered on its update
    none = W.pack_peel_table([], np.arange(5), 5, 4)
    W.check_peel_table(none, 5, 4)
    assert [e[:, :W.E_LO].tolist() for e in W.entries(none)] == [[[W.DUTY, 0, 0, 0, 1, 1]]] * 2


def test_tree_launch_formula():
    """``tree.cuda_launches``: the λ system's 3, the pair sum, K9's table
    entries (no per-round term: were 4 a round and 2 for the core) and the
    core's."""
    for name in ("web1000", "web300", "star", "tree-no-core"):
        dtp = _plan(name)
        core = (dense_core.cuda_launches(dtp.core_size, int(dtp.core_ci.shape[0])) if dtp.core_size
                else 0)
        assert dtp.mf is None and dtp.ce is None
        want = 3 + (dtp.num_pairs > 0) + peel.cuda_launches(dtp) + core
        assert PT.cuda_launches(dtp) == want, name
    assert peel.cuda_launches(_plan("web1000")) == 2  # was 11 · 4 + 2 = 46


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [1024, 64, 1])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_peel_kernels_on_card(monkeypatch, name, cut):
    """On a CUDA device: λ of the kernels bit for bit with ``peel_plain``
    and ``peel_table_plain`` on the same core solution, every launch
    reported (``peel.device``), no K10 launch, ``dr`` untouched."""
    dev = _card()
    monkeypatch.setattr(peel, "CUT", cut)
    dtp = _plan(name, dev)
    dr, w = (t.to(dev) for t in _system(_plan(name), seed=6))
    before = dr.clone()
    from networks_fenicsx_tpu_torch.kernels import fold

    folds, device = fold.fold_apply.launches, peel.peel.device
    got = peel.peel(dtp, dr, w, _dense(dtp, w))
    assert peel.peel.device - device == peel.cuda_launches(dtp)
    assert fold.fold_apply.launches == folds
    assert torch.equal(got, peel.peel_plain(dtp, dr, w, _dense(dtp, w))), name
    assert torch.equal(got, peel.peel_table_plain(dtp, dr, w, _dense(dtp, w))), name
    assert torch.equal(dr, before)
    assert torch.equal(peel.peel(dtp, dr, w, _dense(dtp, w)), got)  # repeat calls bit for bit


@pytest.mark.cuda
def test_peel_kernels_with_the_multifrontal_core_on_card():
    """The 300-site web with a multifrontal core (leaf 4): the kernels and
    the plain version around the same plain core solve, bit for bit."""
    from networks_fenicsx_tpu_torch.ops.multifrontal import plan_multifrontal

    dev = _card()
    ap = _assembler("web300")
    tp = PL._plan_tree_elimination(ap)
    tp = tp._replace(core_plan=plan_multifrontal(np.asarray(tp.core_pairs), tp.core_size, leaf=4))
    dtp = PT.device_tree_plan(tp, PL._build_lambda_plan(ap), ap, dev)
    dr, w = (t.to(dev) for t in _system(_plan("web300"), seed=2))

    def core(dc, rc):
        return mf_apply.mf_apply_plain(dtp.mf, mf_factor.mf_factor_plain(dtp.mf, dc, w), rc)

    assert torch.equal(peel.peel(dtp, dr, w, core), peel.peel_plain(dtp, dr, w, core))
