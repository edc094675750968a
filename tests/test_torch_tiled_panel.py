"""The T solve and the tiled Cholesky's panel on the card (``pytest -m cuda``).

The T solve (``kernels/csrc/shard_top.cu``) against its plain version, which
adds in the kernel's order, on forests with and without compression rounds,
a 4,096-node chain (the kernel's shared-memory limit) and a T of the sharded
forest's shape; the tiled factor (``csrc/tiled_cholesky.cuh``: 16-column
sub-panels, a warp's register factor, the tensor cores' updates) through
K11's ``dense_factor`` at sizes that end a panel or a sub-panel early,
against ``torch.linalg.cholesky`` and within a backward error of 8·n·ε.
On the CPU the T cases run the plain version against a dense solve, so
the inputs are checked here too.  No JAX: the card's machine needs none.
"""

import numpy as np
import pytest
import torch

from networks_fenicsx_tpu_torch.kernels import dense_core, shard_top

EPS = float(np.finfo(np.float64).eps)


def _forest(n, seed, p_child=0.9):
    rng = np.random.default_rng(seed)
    parent = np.full(n, -1, np.int64)
    for i in range(1, n):
        if rng.uniform() < p_child:
            parent[i] = rng.integers(0, i)
    return parent


def _two_arms(seed):
    """1,128 nodes in 711 levels: a stem to a branching node, two arms."""
    rng = np.random.default_rng(seed)
    a = int(rng.integers(150, 294))
    lab = rng.permutation(1128)
    parent = np.full(1128, -1, np.int64)
    for i in range(1, a + 1):
        parent[lab[i]] = lab[i - 1]
    for lo, hi in ((a + 1, 711), (711, 1128)):
        prev = a
        for i in range(lo, hi):
            parent[lab[i]] = lab[prev]
            prev = i
    return parent


T_CASES = {
    "forest300": _forest(300, 3),
    "sparse1000": _forest(1000, 4, p_child=0.995),
    "star": np.concatenate([[-1], np.zeros(200, np.int64)]),
    "chain4096": np.arange(-1, 4095, dtype=np.int64),
    "two_arms": _two_arms(5),
    "tree7": np.array([-1, 0, 0, 1, 1, 2, 2]),
}


def _t_system(parent, dev, seed=6):
    n = parent.size
    rng = np.random.default_rng(seed)
    has = parent >= 0
    wT = np.where(has, rng.uniform(0.5, 2.0, n), 0.0)
    dT = rng.uniform(0.1, 1.0, n) + wT
    np.add.at(dT, np.maximum(parent, 0), np.where(has, wT, 0.0))
    rT = rng.uniform(-1.0, 1.0, n)
    return tuple(torch.as_tensor(a, device=dev) for a in (dT, rT, wT))


def _dense_t(parent, dT, rT, wT):
    L = torch.diag(dT)
    kids = torch.as_tensor(np.flatnonzero(parent >= 0), device=dT.device)
    par = torch.as_tensor(parent[parent >= 0], device=dT.device)
    L[kids, par] -= wT[kids]
    L[par, kids] -= wT[kids]
    return torch.cholesky_solve(rT[:, None], torch.linalg.cholesky(L))[:, 0]


@pytest.mark.parametrize("name", list(T_CASES))
def test_t_solve_plain_inputs_on_the_cpu(name):
    """The card cases' inputs: the plain version equals a dense solve."""
    parent = T_CASES[name]
    args = _t_system(parent, "cpu")
    want = _dense_t(parent, *args)
    got = shard_top.t_solve(shard_top.t_forest(parent, "cpu"), *args)[0]
    assert float((got - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_t_solve_on_card_equals_plain():
    """On a CUDA device: the T solve kernel equals its plain version (same
    order of operations: to the bit, held at 1e-14·scale) and a dense
    solve at 1e-12·scale, with and without compression rounds and the norm;
    one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    sq = torch.tensor(0.25, dtype=torch.float64, device=dev)
    for name, parent in T_CASES.items():
        args = _t_system(parent, dev)
        want = _dense_t(parent, *args)
        scale = max(1.0, float(want.abs().max()))
        for rounds in (None, 0):
            tf = shard_top.t_forest(parent, dev, rounds=rounds)
            before = shard_top.T_SOLVE.launches
            lam, norm = shard_top.t_solve(tf, *args, sq)
            assert shard_top.T_SOLVE.launches == before + 1
            plam, pnorm = shard_top.t_solve_plain(tf, *args, sq)
            torch.cuda.synchronize()
            assert float((lam - plam).abs().max()) <= 1e-14 * scale, (name, rounds)
            assert float((lam - want).abs().max()) <= 1e-12 * scale, (name, rounds)
            assert abs(float(norm) - float(pnorm)) <= 1e-14 * float(pnorm), (name, rounds)


def _laplacian(n, dev, seed):
    """A seeded SPD lattice-like core of order n as K11's arguments."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    side = max(1, int(np.sqrt(n)))
    ci = np.concatenate([i[:-1], i[:-side]]).astype(np.int32)
    cj = np.concatenate([i[1:], i[side:]]).astype(np.int32)
    w = rng.uniform(0.5, 2.0, ci.size)
    dc = rng.uniform(0.01, 0.1, n)
    np.add.at(dc, ci, w)
    np.add.at(dc, cj, w)

    def up(a, dt=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    return (up(ci, torch.int32), up(cj, torch.int32), up(np.arange(ci.size), torch.int32), up(dc),
            up(rng.standard_normal(n)), up(w))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 16, 17, 40, 64, 65, 100, 130, 455, 1000])
def test_tiled_factor_on_card(n):
    """On a CUDA device: the tiled factor of a scaled Laplacian (panels and
    sub-panels cut short at n = 5, 17, 40, 65, 100, 130, ...) equals
    ``torch.linalg.cholesky`` at 1e-12 and meets a backward error of
    8·n·ε; the whole K11 solve equals its plain version at 1e-12·scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    ci, cj, pid, dc, rc, w = _laplacian(n, dev, seed=n)
    Lc, s, C = dense_core.dense_factor(ci, cj, pid, dc, w)
    Ls = (Lc / s[:, None]) / s[None, :]
    L = torch.tril(C)
    assert float((Ls - L @ L.T).abs().max()) <= 8 * n * EPS
    assert float((L - torch.linalg.cholesky(Ls)).abs().max()) <= 1e-12
    x = dense_core.dense_core(ci, cj, pid, dc, rc, w)
    xp = dense_core.dense_core_plain(ci, cj, pid, dc, rc, w)
    assert float((x - xp).abs().max()) <= 1e-12 * max(1.0, float(xp.abs().max()))
