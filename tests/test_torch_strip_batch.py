"""K22b for every strip of a device at once: the stacked strip tables, the
cell → stub map, the batched plain version, the executor's stages and the
launch count.

The strip-sharded lattice executor stacks its strips' K22b tables a device
(``shard_grid.batch_strips``) and writes every strip's row of the reduce in
one launch, each window cell finding its stubs through the strip's cell →
stub map.  On the CPU: the stack gives back every strip's ``StripTables``
row for row; the map names exactly ``st_cell``'s cells; the batched plain
version equals ``window_plain`` a strip, stacked, with ``torch.equal`` (the
lattices of ``tests/test_torch_grid_sharded.py`` in 1, 2, 4 and 8 strips,
their two stubs included, and synthetic strips whose cells hold several
stubs); the sharded lattice solve still matches the JAX package's at
1e-10·scale; ``cuda_launches`` gives 2 a device.  The ``cuda``-marked test
holds the batched kernel to the batched plain version with ``torch.equal``
on the card.  The JAX package is imported only inside the test that
compares with it.
"""

import types

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch.kernels import shard_grid
from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

torch.set_num_threads(1)

SHARDS = [1, 2, 4, 8]
LATTICES = [(9, 16), (6, 5), (7, 3)]  # (7, 3) in 4 and 8 strips: inert strips


def _solver(dims, D, device="cpu", N=2):
    """The sharded lattice solver of ``make_grid(*dims)`` on ``D`` strips of
    ``device`` (scalar R, per-edge f), solved once."""
    mesh = P.NetworkMesh(P.network_generation.make_grid(*dims, arrays=True), N=N)
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=1)
    asm.compute_forms(p_bc_ex=lambda x: x[0] + 0.2 * x[1], R=1.8,
                      f=np.random.default_rng(dims[0] * 31 + dims[1]).uniform(0.5, 1.5,
                                                                              mesh.num_edges))
    solver = ShardedNetworkSolver(asm, devices=[device] * D)
    solver.assemble()
    solver.solve()
    assert solver.info.method == "schur_sharded_grid"
    return solver


def _synthetic(S=3, h=4, nx=6, st_cap=7, r=3, seed=0, device="cpu"):
    """S strips' tables of a made-up plan whose cells hold up to three
    stubs, in three groups, some slots invalid; and random ``(S, E_loc)``
    w, const, Ftot."""
    rng = np.random.default_rng(seed)
    cells = (h + 1) * nx
    E_loc = h * (nx - 1) + h * nx + st_cap
    stub_valid = rng.uniform(size=(S, st_cap)) < 0.8
    stub_valid[0, :3] = True
    stub_rel = rng.integers(0, 4, size=(S, st_cap)) * (cells // 4)  # 4 cells, shared
    plan = types.SimpleNamespace(
        h=h, nx=nx, st_cap=st_cap, dct=types.SimpleNamespace(stub_rows=np.arange(r)),
        valid=np.concatenate([rng.uniform(size=(S, E_loc - st_cap)) < 0.9, stub_valid], axis=1),
        stub_valid=stub_valid, stub_rel=stub_rel, stub_grp=rng.integers(0, r, size=(S, st_cap)),
        stub_s_bif=rng.uniform(size=(S, st_cap)) < 0.5)
    tabs = [shard_grid.strip_tables(plan, d, device) for d in range(S)]
    vals = [torch.as_tensor(rng.uniform(-1.0, 1.0, (S, E_loc)), device=device) for _ in range(3)]
    return tabs, vals


@pytest.mark.parametrize("dims", LATTICES)
@pytest.mark.parametrize("D", SHARDS)
def test_batch_strips_reproduce_each_strip(dims, D):
    ex = _solver(dims, D)._blocked_exec
    assert len(ex.groups) == 1 and ex.groups[0]["members"] == tuple(range(D))
    bt = ex.groups[0]["tables"]
    assert (bt.S, bt.E_loc, bt.h, bt.nx) == (D, ex.plan.E_loc, ex.plan.h, ex.plan.nx)
    assert bt.first == 0
    for j, sh in enumerate(ex.shards):
        tab, got = sh["tables"], bt.strip(j)
        for name in ("valid", "st_cell", "st_fold", "grp_fold", "st_sb", "cell_map"):
            assert torch.equal(getattr(got, name), getattr(tab, name)), (j, name)
        assert (got.h, got.nx, got.r_dct, got.first) == (tab.h, tab.nx, tab.r_dct, tab.first)
        U, Kc, Kg = bt.widths[j]
        assert bool((bt.st_cell[j, U:] == -1).all()) and bool((bt.st_fold[j, :, Kc:] == -1).all())
        assert bool((bt.st_fold[j, U:] == -1).all()) and bool((bt.grp_fold[j, :, Kg:] == -1).all())
    with pytest.raises(ValueError, match="at least one"):
        shard_grid.batch_strips([])


@pytest.mark.parametrize("dims", LATTICES)
@pytest.mark.parametrize("D", SHARDS)
def test_cell_map_finds_st_cell(dims, D):
    ex = _solver(dims, D)._blocked_exec
    cells = (ex.plan.h + 1) * ex.plan.nx
    for sh in ex.shards:
        tab = sh["tables"]
        cmap, st_cell = tab.cell_map.numpy(), tab.st_cell.numpy()
        assert cmap.shape == (cells,)
        assert np.array_equal(np.flatnonzero(cmap >= 0), st_cell)
        assert np.array_equal(cmap[st_cell], np.arange(st_cell.size))


def test_cell_map_of_shared_cells():
    """Cells holding several stubs: the map names each once, and its row of
    ``st_fold`` holds every stub of the cell, ascending."""
    tabs, _ = _synthetic()
    for tab in tabs:
        cmap, st_cell, fold = tab.cell_map.numpy(), tab.st_cell.numpy(), tab.st_fold.numpy()
        assert np.array_equal(np.flatnonzero(cmap >= 0), st_cell)
        for u, c in enumerate(st_cell):
            assert cmap[c] == u
            row = fold[u][fold[u] >= 0]
            assert row.size >= 1 and np.all(np.diff(row) > 0)
    assert max(int(t.st_fold.shape[1]) for t in tabs) >= 2


@pytest.mark.parametrize("dims", LATTICES)
@pytest.mark.parametrize("D", SHARDS)
def test_window_batch_plain_equals_per_strip(dims, D):
    solver = _solver(dims, D)
    ex = solver._blocked_exec
    args = ex.prepare_args(*solver._coeff_args)
    bt = ex.groups[0]["tables"]
    k1 = ex.condense(0, args)
    w, const, Ftot = k1[1], k1[4], k1[3]
    want = torch.stack([shard_grid.window_plain(sh["tables"], w[j], const[j], Ftot[j])
                        for j, sh in enumerate(ex.shards)])
    length = shard_grid.row_length(bt.h, bt.nx, bt.r_dct)
    for got in (shard_grid.window_batch_plain(bt, w, const, Ftot),
                shard_grid.window_batch(bt, w, const, Ftot), ex.window(0, k1),
                ex.window(0, k1, plain=True)):
        assert got.shape == (D, length) and torch.equal(got, want)
    # each strip alone (its own K1 and window) gives its row of the group's
    for i, a in enumerate(args):
        assert torch.equal(ex.forward(i, *a).part, want[i])


def test_window_batch_plain_on_shared_cells():
    tabs, (w, const, Ftot) = _synthetic()
    bt = shard_grid.batch_strips(tabs)
    want = torch.stack([shard_grid.window_plain(t, w[j], const[j], Ftot[j])
                        for j, t in enumerate(tabs)])
    assert torch.equal(shard_grid.window_batch_plain(bt, w, const, Ftot), want)
    assert torch.equal(shard_grid.window_batch(bt, w, const, Ftot), want)
    assert bt.first == 0 and float(want[1:, 2 * (bt.h + 1) * bt.nx:][:, :2].abs().sum()) == 0.0


@pytest.mark.parametrize("D", SHARDS)
def test_sharded_grid_solve_matches_reference(D):
    """The restructured executor (a device's strips through one K1 and one
    K22b window launch) against the JAX package's strip-sharded solve and
    the port's serial solve, at 1e-10·scale."""
    import test_torch_grid_sharded as TG

    def f(mesh):
        return np.random.default_rng(7).uniform(0.5, 1.5, mesh.num_edges)

    sp = TG._both((9, 16), 2, 1, 1.8, f, D)
    assert sp.info.method == "schur_sharded_grid"
    assert len(sp._blocked_exec.groups) == 1


@pytest.mark.parametrize("D", SHARDS)
def test_cuda_launches_two_a_device(D):
    bt = _solver((6, 5), D)._blocked_exec.groups[0]["tables"]
    assert shard_grid.cuda_launches(bt) == 2


def test_top_reads_one_group_as_is():
    """One device: the placed reduce reads the group's rows themselves (no
    ``mesh.stack``), with the stacked path's result."""
    solver = _solver((9, 16), 4)
    ex = solver._blocked_exec
    args = ex.prepare_args(*solver._coeff_args)
    rows = ex.window(0, ex.condense(0, args))
    calls = []
    stack = ex.mesh.stack
    ex.mesh.stack = lambda parts: calls.append(len(parts)) or stack(parts)
    try:
        (lam, res), = ex.top([rows]).values()
    finally:
        ex.mesh.stack = stack
    assert calls == []
    groups = ex.groups  # as two groups of two strips: the parts go through the stack
    ex.groups = [dict(groups[0], members=(0, 1)), dict(groups[0], members=(2, 3))]
    try:
        (lam2, res2), = ex.top([rows[:2], rows[2:]]).values()
    finally:
        ex.groups = groups
    assert torch.equal(lam, lam2) and torch.equal(res, res2)


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_strip_batch_kernel_equals_plain_on_card():
    """On a CUDA device: K22b's batched windows over 8 strips equal the
    batched plain version with ``torch.equal``, in one launch; so do the
    synthetic strips with shared stub cells, and the one-strip wrapper on
    each strip; the sharded solve equals the plain executor's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    solver = _solver((33, 40), 8, device="cuda:0")
    ex = solver._blocked_exec
    args = ex.prepare_args(*solver._coeff_args)
    bt = ex.groups[0]["tables"]
    k1 = ex.condense(0, args)
    w, const, Ftot = k1[1], k1[4], k1[3]
    before = shard_grid.LAUNCHES.launches
    got = shard_grid.window_batch(bt, w, const, Ftot)
    assert shard_grid.LAUNCHES.launches - before == 1
    assert torch.equal(got, shard_grid.window_batch_plain(bt, w, const, Ftot))
    for j, sh in enumerate(ex.shards):
        assert torch.equal(shard_grid.window(sh["tables"], w[j], const[j], Ftot[j]), got[j])
    tabs, (sw, sc, sF) = _synthetic(device="cuda:0")
    sbt = shard_grid.batch_strips(tabs)
    assert torch.equal(shard_grid.window_batch(sbt, sw, sc, sF),
                       shard_grid.window_batch_plain(sbt, sw, sc, sF))
    out, want = ex(args), ex.plain(args)
    for a, b in zip(out[:2], want[:2]):
        for x, y in zip(a, b):
            assert float((x - y).abs().max()) <= 1e-10 * max(1.0, float(y.abs().max()))
