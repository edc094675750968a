"""Plain versions of the port's kernels against the JAX functions they replace.

Each kernel module of ``networks_fenicsx_tpu_torch.kernels`` holds a CUDA
kernel and its plain PyTorch version; on the CPU the wrapper runs the plain
version, which must match the reference at 1e-12·scale (scale = max(1, max
|reference|): float64 roundoff of O(N + depth) operations).  The CUDA
kernels themselves are compared with the plain versions by the
``cuda``-marked test (and by ``chip_smoke.py``) on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu_torch import blocked as PB
from networks_fenicsx_tpu_torch import kernels
from networks_fenicsx_tpu_torch.kernels import condense, expand, tree_sweep

from _torch_cases import arterial, kary

torch.set_num_threads(1)

TOL = 1e-12


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _plans(graph_fn, N=3):
    """Equal (JAX, port) blocked plans plus the port assembler."""
    Gj, Gp = graph_fn(J), graph_fn(P)
    aj = J.HydraulicNetworkAssembler(J.NetworkMesh(Gj, N=N))
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(Gp, N=N))
    for a in (aj, ap):
        a.compute_forms(p_bc_ex=lambda x: x[1])
    return JS._plan_blocked(aj), PB._plan_blocked(ap), ap


def _inputs(rng, plan, N, R_mode, f_mode):
    E = plan.edge_order.size
    shapes = {"scalar": (1,), "edge": (E,), "cell": (N, E)}
    return dict(
        h_e=rng.uniform(0.1, 1.0, E),
        R=rng.uniform(0.5, 2.0, shapes[R_mode]),
        f=rng.uniform(-1.0, 1.0, shapes[f_mode]),
        sp=np.where(plan.s_is_bif, 0.0, rng.uniform(-1, 1, E)),
        ep=np.where(plan.t_is_bif, 0.0, rng.uniform(-1, 1, E)),
    )


def _jax_condense(jplan, N, k, x, R_mode, f_mode):
    E = x["h_e"].size
    W, g, Ftot, back = JS._blocked_condense(
        N, E, jnp.asarray(x["h_e"]), jnp.asarray(x["R"]), jnp.asarray(x["f"]),
        R_mode, f_mode, k=k,
    )
    w = 1.0 / W
    s_b, t_b = jnp.asarray(jplan.s_is_bif), jnp.asarray(jplan.t_is_bif)
    sp, ep = jnp.asarray(x["sp"]), jnp.asarray(x["ep"])
    const = (-sp * (~s_b) + ep * (~t_b) - g) * w
    return (W, w, g, Ftot, const), back


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


MODES = [(R, f) for R in ("scalar", "edge", "cell") for f in ("scalar", "edge", "cell")]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("R_mode,f_mode", MODES)
def test_condense_plain_matches_blocked_condense(R_mode, f_mode, k):
    N = 4
    jplan, plan, _ = _plans(arterial, N)
    x = _inputs(np.random.default_rng(10 + k), plan, N, R_mode, f_mode)
    want, _ = _jax_condense(jplan, N, k, x, R_mode, f_mode)
    dp = PB.device_plan(plan, "cpu")
    got = condense.condense(
        dp, N, k, _t(x["h_e"]), _t(x["R"]), _t(x["f"]), R_mode, f_mode, _t(x["sp"]), _t(x["ep"])
    )
    for a, b in zip(got, want):
        _close(a, b)


SWEEP_TOPOLOGIES = {
    "arterial": arterial,
    "binary": lambda pkg: pkg.network_generation.make_tree(6, 1.0, 2.0, arrays=True),
    "k3": lambda pkg: kary(pkg, 3, 2),
    "k4": lambda pkg: kary(pkg, 4, 1),
}


@pytest.mark.parametrize("name", sorted(SWEEP_TOPOLOGIES))
def test_tree_sweep_plain_matches_blocked_eliminate(name):
    jplan, plan, _ = _plans(SWEEP_TOPOLOGIES[name])
    rng = np.random.default_rng(21)
    E = plan.edge_order.size
    w, const, Ftot = rng.uniform(0.5, 2.0, E), rng.uniform(-1, 1, E), rng.uniform(-1, 1, E)
    _, lam_j, norm_j = JS._blocked_eliminate(
        jplan, jnp.asarray(w), jnp.asarray(const), jnp.asarray(Ftot)
    )
    dp = PB.device_plan(plan, "cpu")
    lam, rhs_norm, d, r, wn = tree_sweep.tree_sweep(dp, _t(w), _t(const), _t(Ftot))
    _close(lam, lam_j)
    _close(rhs_norm, norm_j)
    assert d.shape == r.shape == wn.shape == lam.shape


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("R_mode,f_mode", [("edge", "scalar"), ("scalar", "edge"),
                                           ("cell", "edge"), ("edge", "cell"), ("cell", "cell")])
def test_expand_plain_matches_lambda_to_edges_and_back(R_mode, f_mode, k):
    N = 3
    jplan, plan, _ = _plans(arterial, N)
    rng = np.random.default_rng(30 + k)
    x = _inputs(rng, plan, N, R_mode, f_mode)
    (W, w, g, Ftot, _), back = _jax_condense(jplan, N, k, x, R_mode, f_mode)
    B = plan.bif_order.size
    lam = rng.uniform(-1, 1, B)
    lam_lev = np.split(lam, plan.bif_offsets[1:-1])
    lam_s, lam_t = JS._blocked_lambda_to_edges(jplan, [jnp.asarray(a) for a in lam_lev], jnp.float64)
    s_b, t_b = jnp.asarray(jplan.s_is_bif), jnp.asarray(jplan.t_is_bif)
    r0 = jnp.where(s_b, lam_s, -x["sp"])
    rN = jnp.where(t_b, -lam_t, x["ep"])
    q0 = (r0 + rN - g) * w
    q_T, p_T = back(q0, r0)

    dp = PB.device_plan(plan, "cpu")
    got = expand.expand(
        dp, N, k, _t(lam), _t(x["sp"]), _t(x["ep"]), _t(W), _t(w), _t(g), _t(Ftot),
        _t(x["h_e"]), _t(x["R"]), _t(x["f"]), R_mode, f_mode,
    )
    assert got[0].shape == (k * N + 1, plan.edge_order.size)
    _close(got[0], q_T)
    _close(got[1], p_T)
    assert bool(got[2])


def test_expand_finite_flag_catches_nonfinite_lambda():
    N, k = 3, 1
    jplan, plan, _ = _plans(arterial, N)
    x = _inputs(np.random.default_rng(4), plan, N, "edge", "scalar")
    (W, w, g, Ftot, _), _ = _jax_condense(jplan, N, k, x, "edge", "scalar")
    lam = np.zeros(plan.bif_order.size)
    lam[-1] = np.nan
    dp = PB.device_plan(plan, "cpu")
    *_, finite = expand.expand(
        dp, N, k, _t(lam), _t(x["sp"]), _t(x["ep"]), _t(W), _t(w), _t(g), _t(Ftot),
        _t(x["h_e"]), _t(x["R"]), _t(x["f"]), "edge", "scalar",
    )
    assert not bool(finite)


def test_wrappers_never_fall_back_off_the_cpu():
    """A CPU tensor runs the plain version without counting a launch; a
    tensor on any other device goes to the kernel path, which validates it
    and raises rather than falling back."""
    _, plan, _ = _plans(arterial)
    dp = PB.device_plan(plan, "cpu")
    E = plan.edge_order.size
    kernels.reset_launches()
    ones = torch.ones(E, dtype=torch.float64)
    tree_sweep.tree_sweep(dp, ones, ones, ones)
    assert kernels.launches() == {"condense": 0, "tree_sweep": 0, "expand": 0}
    meta = torch.ones(E, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tree_sweep.tree_sweep(dp, meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        condense.condense(dp, 3, 1, meta, meta[:1], meta[:1], "scalar", "scalar", meta, meta)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On a CUDA device: each kernel equals its plain version on the same
    inputs (run on the card via ``chip_smoke.py`` or ``pytest -m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for k, R_mode, f_mode in [(1, "edge", "scalar"), (2, "cell", "cell"), (3, "scalar", "edge")]:
        N = 4
        _, plan, _ = _plans(arterial, N)
        x = _inputs(np.random.default_rng(k), plan, N, R_mode, f_mode)
        dp = PB.device_plan(plan, dev)
        h, R, f, sp, ep = (_t(x[n]).to(dev) for n in ("h_e", "R", "f", "sp", "ep"))
        c_args = (N, k, h, R, f, R_mode, f_mode, sp, ep)
        c_plain = condense.condense_plain(plan, *c_args)
        for a, b in zip(condense.condense(dp, *c_args), c_plain):
            _close(a.cpu(), b.cpu())
        W, w, g, Ftot, const = c_plain
        s_plain = tree_sweep.tree_sweep_plain(plan, w, const, Ftot)
        for a, b in zip(tree_sweep.tree_sweep(dp, w, const, Ftot), s_plain):
            _close(a.cpu(), b.cpu())
        x_args = (N, k, s_plain[0], sp, ep, W, w, g, Ftot, h, R, f, R_mode, f_mode)
        got = expand.expand(dp, *x_args)
        want = expand.expand_plain(plan, *x_args)
        _close(got[0].cpu(), want[0].cpu())
        _close(got[1].cpu(), want[1].cpu())
        assert bool(got[2]) and bool(want[2])
