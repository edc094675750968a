"""K1 for every shard of a device in one launch: the batch, its plain
version, the sharded executors' K1 stage and the launch count.

Both sharded executors keep a K1 batch a device (``condense.Batch``: the
shards' row ends, N, k, the modes and the condensed matrix's constants) and
run K1 of all their shards in one launch into one ``(5, S, E_loc)`` buffer;
the serial routes run the same kernel with S = 1.  On the CPU: the batched
plain version equals ``condense_plain`` a shard, stacked, with
``torch.equal`` in the scalar, edge and cell modes; ``condense_plain`` stays
within 1e-12·scale of the JAX package's ``_blocked_condense`` on a tree (the
blocked plan's order) and a lattice (the grid plan's); the sharded blocked
and lattice solves still match the JAX package's at 1e-10·scale; shards of
unequal length raise; ``cuda_launches`` gives 1 a device.  The
``cuda``-marked test holds the kernel, one shard and batched, to the plain
versions on the card: ``torch.equal`` in the scalar and edge modes,
1e-12·scale in cell mode.  The JAX package is imported only inside the
tests that compare with it.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import blocked as PB
from networks_fenicsx_tpu_torch.kernels import condense
from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

torch.set_num_threads(1)

MODES = [(R, f) for R in ("scalar", "edge", "cell") for f in ("scalar", "edge", "cell")]
SHARDS = [1, 2, 4, 8]


def _tree_solver(D, device="cpu", gens=6, N=4):
    """The sharded blocked solver of ``make_tree(gens)`` on ``D`` shards."""
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


def _shard_inputs(ex, R_mode, f_mode, seed, device="cpu"):
    """Random per-shard ``(h_e, R, f, start_pbc, end_pbc)`` of ``ex``'s row
    layout in the given modes (boundary data zero where an end is a
    bifurcation)."""
    rng = np.random.default_rng(seed)
    N, E = ex._N, ex.plan.E_loc
    shapes = {"scalar": (1,), "edge": (E,), "cell": (N, E)}
    ins = []
    for sh in ex.shards:
        ends = sh["ends"].plan

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device)

        ins.append((t(rng.uniform(0.1, 1.0, E)), t(rng.uniform(0.5, 2.0, shapes[R_mode])),
                    t(rng.uniform(-1.0, 1.0, shapes[f_mode])),
                    t(np.where(ends.s_is_bif, 0.0, rng.uniform(-1, 1, E))),
                    t(np.where(ends.t_is_bif, 0.0, rng.uniform(-1, 1, E)))))
    return ins


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("R_mode,f_mode", MODES)
def test_condense_batch_plain_equals_per_shard(R_mode, f_mode, k):
    ex = _tree_solver(4)._blocked_exec
    plans = [sh["ends"] for sh in ex.shards]
    batch = condense.Batch(plans, ex._N, k, R_mode, f_mode)
    ins = _shard_inputs(ex, R_mode, f_mode, seed=k)
    want = torch.stack([torch.stack(condense.condense_plain(p.plan, ex._N, k, h, R, f, R_mode,
                                                            f_mode, sp, ep))
                        for p, (h, R, f, sp, ep) in zip(plans, ins)], dim=1)
    assert want.shape == (5, 4, ex.plan.E_loc)
    for got in (condense.condense_batch_plain(batch, ins), condense.condense_batch(batch, ins)):
        assert got.shape == want.shape and torch.equal(got, want)
    for j, (p, (h, R, f, sp, ep)) in enumerate(zip(plans, ins)):  # the one-plan wrapper
        got = condense.condense(p, ex._N, k, h, R, f, R_mode, f_mode, sp, ep)
        assert all(torch.equal(a, b) for a, b in zip(got, want[:, j]))


@pytest.mark.parametrize("D", SHARDS)
def test_executor_stage_equals_per_shard(D):
    """The blocked executor's K1 stage: each shard's column equals its own
    K1; the forward half on it equals the forward half with its own K1."""
    solver = _tree_solver(D)
    ex = solver._blocked_exec
    args = ex.prepare_args(*solver._coeff_args)
    k1 = ex.condense(0, args)
    assert k1.shape == (5, D, ex.plan.E_loc)
    assert torch.equal(k1, ex.condense(0, args, plain=True))
    for i, a in enumerate(args):
        own = ex.forward(i, *a)
        staged = ex.forward(i, *a, k1=k1[:, i].unbind(0))
        assert all(torch.equal(x, y) for x, y in zip(own, staged))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("R_mode,f_mode", MODES)
def test_condense_plain_matches_jax_on_tree(R_mode, f_mode, k):
    import test_torch_kernels as TK
    from _torch_cases import arterial

    N = 4
    jplan, plan, _ = TK._plans(arterial, N)
    x = TK._inputs(np.random.default_rng(40 + k), plan, N, R_mode, f_mode)
    want, _ = TK._jax_condense(jplan, N, k, x, R_mode, f_mode)
    got = condense.condense_plain(plan, N, k, *(TK._t(x[n]) for n in ("h_e", "R", "f")), R_mode,
                                  f_mode, TK._t(x["sp"]), TK._t(x["ep"]))
    for a, b in zip(got, want):
        TK._close(a, b)


@pytest.mark.parametrize("R_mode,f_mode", [("scalar", "scalar"), ("scalar", "edge"),
                                           ("scalar", "cell"), ("edge", "cell")])
def test_condense_plain_matches_jax_on_lattice(R_mode, f_mode):
    """The grid route's internal order (x-edges, y-edges, stubs) on a 9 × 7
    lattice: the JAX package's ``_blocked_condense`` with the grid plan's
    endpoint masks."""
    import jax.numpy as jnp
    import test_torch_kernels as TK
    from networks_fenicsx_tpu import solver as JS

    from networks_fenicsx_tpu_torch.lattice import (
        _plan_dct_lattice, _plan_grid_layout, _plan_shift_matvec,
    )

    N, k = 2, 1
    mesh = P.NetworkMesh(P.network_generation.make_grid(9, 7, arrays=True), N=N)
    asm = P.HydraulicNetworkAssembler(mesh, flux_degree=k)
    asm.compute_forms(p_bc_ex=lambda x: x[0], R=1.3)
    gp = _plan_grid_layout(asm, _plan_dct_lattice(asm, _plan_shift_matvec(asm)))
    E = gp.edge_order.size
    rng = np.random.default_rng(5)
    shapes = {"scalar": (1,), "edge": (E,), "cell": (N, E)}
    x = dict(h_e=np.asarray(gp.h_e, np.float64), R=rng.uniform(0.5, 2.0, shapes[R_mode]),
             f=rng.uniform(-1.0, 1.0, shapes[f_mode]),
             sp=np.where(gp.s_is_bif, 0.0, rng.uniform(-1, 1, E)),
             ep=np.where(gp.t_is_bif, 0.0, rng.uniform(-1, 1, E)))
    W, g, Ftot, _ = JS._blocked_condense(N, E, jnp.asarray(x["h_e"]), jnp.asarray(x["R"]),
                                         jnp.asarray(x["f"]), R_mode, f_mode, k=k)
    w = 1.0 / W
    s_b, t_b = jnp.asarray(gp.s_is_bif), jnp.asarray(gp.t_is_bif)
    const = (-jnp.asarray(x["sp"]) * (~s_b) + jnp.asarray(x["ep"]) * (~t_b) - g) * w
    got = condense.condense_plain(gp, N, k, *(TK._t(x[n]) for n in ("h_e", "R", "f")), R_mode,
                                  f_mode, TK._t(x["sp"]), TK._t(x["ep"]))
    for a, b in zip(got, (W, w, g, Ftot, const)):
        TK._close(a, b)


@pytest.mark.parametrize("D", SHARDS)
def test_sharded_blocked_solve_matches_reference(D):
    """The sharded blocked solve through one K1 launch a device, per-cell R
    and f (K1's cell mode), against the JAX package's and the port's serial
    solve at 1e-10·scale."""
    import test_torch_sharding as TS

    *_, sp, _ = TS._sharded_both(TS._tree(6), D, N=3, R=TS._rand(0.5, 2.0, 21, per="cell"),
                                 f=TS._rand(-1.0, 1.0, 22, per="cell"))
    assert sp.info.method == "schur_sharded_blocked"
    assert sp._blocked_exec.groups[0]["k1"].S == D


@pytest.mark.parametrize("D", [2, 8])
def test_sharded_lattice_solve_matches_reference(D):
    """The strip-sharded lattice solve with per-cell f through one K1 launch
    a device, against the JAX package's and the port's serial solve at
    1e-10·scale."""
    import test_torch_grid_sharded as TG

    def f(mesh):
        return np.random.default_rng(9).uniform(-1.0, 1.0, mesh.num_cells)

    sp = TG._both((7, 9), 3, 1, 1.4, f, D)
    assert sp.info.method == "schur_sharded_grid"
    assert sp._blocked_exec.groups[0]["k1"].S == D


def test_unequal_shards_raise():
    ex = _tree_solver(2)._blocked_exec
    short = PB.ends_plan(np.full(ex.plan.E_loc - 1, -1), np.full(ex.plan.E_loc - 1, -1), 1, "cpu")
    with pytest.raises(ValueError, match="one length"):
        condense.Batch([ex.shards[0]["ends"], short], ex._N, 1, "edge", "edge")
    with pytest.raises(ValueError, match="at least one"):
        condense.Batch([], ex._N, 1, "edge", "edge")
    batch = ex.groups[0]["k1"]
    ins = _shard_inputs(ex, "edge", "edge", seed=3)
    bad = [ins[0], tuple(t[:-1] for t in ins[1])]
    for run in (condense.condense_batch, condense.condense_batch_plain):
        with pytest.raises(ValueError, match="must be"):
            run(batch, bad)
        with pytest.raises(ValueError, match="inputs of 2"):
            run(batch, ins[:1])


@pytest.mark.parametrize("D", SHARDS)
def test_cuda_launches_one_a_device(D):
    for ex in (_tree_solver(D)._blocked_exec,):
        batch = ex.groups[0]["k1"]
        assert batch.S == D and condense.cuda_launches(batch) == 1
    many = condense.Batch([ex.shards[0]["ends"]] * (condense.MAX_SHARDS + 1), ex._N, 1, "edge",
                          "edge")
    assert condense.cuda_launches(many) == 2  # one a MAX_SHARDS shards


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_condense_batch_kernel_equals_plain_on_card():
    """On a CUDA device: K1 over 8 shards in one launch, and on each shard
    alone, against the plain versions: ``torch.equal`` in the scalar and
    edge modes, 1e-12·scale in cell mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ex = _tree_solver(8, device="cuda:0", gens=8, N=3)._blocked_exec
    plans = [sh["ends"] for sh in ex.shards]
    for k in (1, 2):
        for R_mode, f_mode in MODES:
            batch = condense.Batch(plans, ex._N, k, R_mode, f_mode)
            ins = _shard_inputs(ex, R_mode, f_mode, seed=k, device="cuda:0")
            before = condense.condense.launches
            got = condense.condense_batch(batch, ins)
            assert condense.condense.launches - before == 1
            want = condense.condense_batch_plain(batch, ins)
            ones = [torch.stack(condense.condense(p, ex._N, k, *a[:3], R_mode, f_mode, *a[3:]))
                    for p, a in zip(plans, ins)]
            for out in (got, torch.stack(ones, dim=1)):
                if "cell" in (R_mode, f_mode):
                    err = float((out - want).abs().max())
                    assert err <= 1e-12 * max(1.0, float(want.abs().max())), (R_mode, f_mode, k)
                else:
                    assert torch.equal(out, want), (R_mode, f_mode, k)
