"""K22a for every shard of a device at once: the stacked tables, the batched
plain versions, the executor's stages and the launch count.

The sharded blocked executor stacks its shards' K22a fold tables a device
(``shard_blocked.batch_tables``) and runs the partials and the λ of all of
them in one launch each.  On the CPU: the stack gives back every shard's
``ShardTables`` row for row; the batched plain versions equal the one-shard
``partials_plain`` / ``lam_ext_plain``, stacked, with ``torch.equal``; the
sharded solve (1, 2, 4 and 8 shards of ``tests/test_torch_sharding.py``'s
tree) still matches the JAX package's at 1e-10·scale; ``cuda_launches``
gives 2 a device.  The ``cuda``-marked test holds both kernels to the
batched plain versions with ``torch.equal`` on the card.  The JAX package
is imported only inside the test that compares with it.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch.kernels import shard_blocked
from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

torch.set_num_threads(1)

SHARDS = [1, 2, 4, 8]


def _solver(D, device="cpu", gens=6, N=4):
    """The sharded blocked solver of ``make_tree(gens)`` on ``D`` shards of
    ``device`` (per-edge R, per-edge f: the sharding tests' tree), solved once."""
    mesh = P.NetworkMesh(P.network_generation.make_tree(gens, 1.0, 2.0, arrays=True), N=N)
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=1)
    asm.compute_forms(p_bc_ex=lambda x: x[1],
                      R=np.random.default_rng(17).uniform(0.5, 2.0, mesh.num_edges),
                      f=np.random.default_rng(18).uniform(-1, 1, mesh.num_edges))
    solver = ShardedNetworkSolver(asm, devices=[device] * D)
    solver.assemble()
    solver.solve()
    assert solver.info.method == "schur_sharded_blocked"
    return solver


def _stages(solver):
    """The executor, its shards' forward halves and a λ_T."""
    ex = solver._blocked_exec
    fws = [ex.forward(i, *a) for i, a in enumerate(ex.prepare_args(*solver._coeff_args))]
    dev = ex.groups[0]["device"]
    lam_T = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, ex.plan.Tn), device=dev)
    return ex, fws, lam_T


def _ins(ex, fws, g=0):
    members = ex.groups[g]["members"]
    parts = [(fws[i].w, fws[i].const, fws[i].Ftot, fws[i].d, fws[i].r, fws[i].wn, fws[i].rhs_sq)
             for i in members]
    return parts, [p[3:6] for p in parts]


@pytest.mark.parametrize("D", SHARDS)
def test_batch_tables_reproduce_each_shard(D):
    ex = _solver(D)._blocked_exec
    assert len(ex.groups) == 1 and ex.groups[0]["members"] == tuple(range(D))
    bt = ex.groups[0]["tables"]
    assert (bt.S, bt.Tn, bt.c, bt.B_sub) == (D, ex.plan.Tn, ex.plan.c, ex.plan.B_sub)
    for j, sh in enumerate(ex.shards):
        tab, got = sh["tables"], bt.shard(j)
        for name in ("tfold", "sfold", "pfold", "rfold", "root_T"):
            assert torch.equal(getattr(got, name), getattr(tab, name)), (j, name)
            full = getattr(bt, name)[j]
            if name != "root_T":  # the pad past the shard's own width
                assert bool((full[:, getattr(tab, name).shape[1]:] == -1).all())
        assert (got.Tn, got.c, got.B_sub) == (tab.Tn, tab.c, tab.B_sub)
    with pytest.raises(ValueError, match="at least one"):
        shard_blocked.batch_tables([])


@pytest.mark.parametrize("D", SHARDS)
def test_batched_plain_equals_per_shard(D):
    ex, fws, lam_T = _stages(_solver(D))
    bt = ex.groups[0]["tables"]
    pa, la = _ins(ex, fws)
    tabs = [sh["tables"] for sh in ex.shards]
    want = torch.stack([shard_blocked.partials_plain(t, *a) for t, a in zip(tabs, pa)])
    for got in (shard_blocked.partials_batch_plain(bt, pa), shard_blocked.partials_batch(bt, pa),
                ex.partials(0, fws), ex.partials(0, fws, plain=True)):
        assert got.shape == (D, 3 * bt.Tn + 1) and torch.equal(got, want)
    want = torch.stack([shard_blocked.lam_ext_plain(t, *a, lam_T) for t, a in zip(tabs, la)])
    for got in (shard_blocked.lam_batch_plain(bt, la, lam_T), shard_blocked.lam_batch(bt, la, lam_T),
                ex.lam(0, fws, lam_T), ex.lam(0, fws, lam_T, plain=True)):
        assert got.shape == (D, bt.B_sub + bt.Tn) and torch.equal(got, want)
    with pytest.raises(ValueError, match="inputs of"):
        shard_blocked.partials_batch(bt, pa[:-1] if D > 1 else pa + pa)


@pytest.mark.parametrize("D", SHARDS)
def test_sharded_blocked_solve_matches_reference(D):
    """The restructured executor (a device's shards through one K22a call
    a stage) against the JAX package's sharded blocked solve and the port's
    serial solve, at 1e-10·scale."""
    import test_torch_sharding as TS

    *_, sp, _ = TS._sharded_both(TS._tree(6), D, N=4, R=TS._rand(0.5, 2.0, 17),
                                 f=lambda m: np.random.default_rng(18).uniform(-1, 1, m.num_edges))
    assert sp.info.method == "schur_sharded_blocked"
    assert len(sp._blocked_exec.groups) == 1


@pytest.mark.parametrize("D", SHARDS)
def test_cuda_launches_two_a_device(D):
    bt = _solver(D)._blocked_exec.groups[0]["tables"]
    assert shard_blocked.cuda_launches(bt) == 2
    many = shard_blocked.batch_tables([bt.shard(0)] * (shard_blocked.MAX_SHARDS + 1))
    assert shard_blocked.cuda_launches(many) == 4  # one a MAX_SHARDS shards


def test_top_reads_one_group_as_is():
    """One device: the reduce reads the group's rows themselves (no
    ``mesh.stack``), with the stacked path's result."""
    from networks_fenicsx_tpu_torch.kernels import shard_top

    ex, fws, _ = _stages(_solver(4))
    rows = ex.partials(0, fws)
    calls = []
    stack = ex.mesh.stack
    ex.mesh.stack = lambda parts: calls.append(len(parts)) or stack(parts)
    try:
        (lam_T, norm), = ex.top([rows]).values()
    finally:
        ex.mesh.stack = stack
    assert calls == []
    Tn = ex.plan.Tn
    tot = ex.mesh.reduce(stack(list(rows)))
    want = shard_top.t_solve_plain(ex.t_forest[tot.device], tot[:Tn], tot[Tn:2 * Tn],
                                   tot[2 * Tn:3 * Tn], tot[3 * Tn])
    assert torch.equal(lam_T, want[0]) and torch.equal(norm, want[1])


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_shard_batch_kernels_equal_plain_on_card():
    """On a CUDA device: K22a's batched partials and λ over the 8 shards of
    the tree equal the batched plain versions with ``torch.equal``, one
    launch each; the one-shard wrappers equal the one-shard plain versions;
    the sharded solve equals the plain executor's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    solver = _solver(8, device="cuda:0", gens=8, N=3)
    ex, fws, lam_T = _stages(solver)
    bt = ex.groups[0]["tables"]
    pa, la = _ins(ex, fws)
    before = shard_blocked.LAUNCHES.launches
    got_p = shard_blocked.partials_batch(bt, pa)
    got_l = shard_blocked.lam_batch(bt, la, lam_T)
    assert shard_blocked.LAUNCHES.launches - before == shard_blocked.cuda_launches(bt) == 2
    assert torch.equal(got_p, shard_blocked.partials_batch_plain(bt, pa))
    assert torch.equal(got_l, shard_blocked.lam_batch_plain(bt, la, lam_T))
    for j, sh in enumerate(ex.shards):
        tab = sh["tables"]
        assert torch.equal(shard_blocked.partials(tab, *pa[j]), shard_blocked.partials_plain(tab, *pa[j]))
        assert torch.equal(shard_blocked.lam_ext(tab, *la[j], lam_T),
                           shard_blocked.lam_ext_plain(tab, *la[j], lam_T))
    args = ex.prepare_args(*solver._coeff_args)
    got, want = ex(args), ex.plain(args)
    for a, b in zip(got[:3], want[:3]):
        for x, y in zip(a, b):
            assert float((x - y).abs().max()) <= 1e-10 * max(1.0, float(y.abs().max()))
