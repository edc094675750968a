"""The general forest path of the PyTorch port against the JAX reference.

Host: the tree and level planners must give ``np.array_equal`` plans, and
the flattened device level plan must describe the same elimination.
Kernels: the plain version of each general-forest kernel — K6 segment
sums, K8a edge data, K7 level elimination, K8b back-substitution — must
match the JAX function it replaces at 1e-12·scale (scale = max(1, max
|reference|): float64 roundoff of O(N + depth) operations in another
summation order).  The CUDA kernels are held against the plain versions by
the ``cuda``-marked test and by ``chip_smoke.py`` on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch.edge_data import _EdgeData, edge_layout
from networks_fenicsx_tpu_torch.kernels import backsub, edge_data, level_eliminate, segsum

from _torch_cases import arterial, assert_plans_equal, asymmetric, golden_graph

torch.set_num_threads(1)

TOL = 1e-12
def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _irregular(pkg, n=120, seed=5):
    return pkg.network_generation.make_random_network(n, keep=0.0, seed=seed, arrays=True)


GRAPHS = {
    "arterial6": lambda pkg: arterial(pkg, 6),
    "asymmetric": asymmetric,
    "irregular120": _irregular,
    "web48": lambda pkg: golden_graph(pkg, "web48"),
    "grid5x4": lambda pkg: golden_graph(pkg, "grid5x4"),
}
FORESTS = ("arterial6", "asymmetric", "irregular120")


def _assemblers(graph_fn, N=2, k=1):
    out = []
    for pkg in (J, P):
        asm = pkg.HydraulicNetworkAssembler(pkg.NetworkMesh(graph_fn(pkg), N=N), flux_degree=k)
        asm.compute_forms(p_bc_ex=lambda x: x[0])
        out.append(asm)
    return out


# ------------------------------------------------------------------ host


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tree_plan_equal(name):
    aj, ap = _assemblers(GRAPHS[name])
    for force in (False, True):
        pj = JS._plan_tree_elimination(aj, force_rounds=force)
        pp = PL._plan_tree_elimination(ap, force_rounds=force)
        for field in ("pair_nodes", "edge_pair", "core_nodes", "core_pairs"):
            assert np.array_equal(getattr(pj, field), getattr(pp, field)), (field, force)
        assert len(pj.rounds) == len(pp.rounds)
        for rj, rp in zip(pj.rounds, pp.rounds):
            assert all(np.array_equal(a, b) for a, b in zip(rj, rp))
    assert (pp.core_size > 0) == (name in ("web48", "grid5x4"))
    assert PL._cached_tree_plan(ap) is PL._cached_tree_plan(ap)
    attached = PL._cached_tree_plan(ap, attach=True)
    if pp.core_size == 0:  # nothing to attach to a forest
        assert attached is PL._cached_tree_plan(ap)
    else:  # a core of at most 2,048 nodes takes the reference's min-degree plan
        assert_plans_equal(JS.attach_core_plan(pj).core_plan, attached.core_plan)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_level_plan_equal(name):
    aj, ap = _assemblers(GRAPHS[name])
    lj = JS._plan_level_elimination(aj, JS._plan_tree_elimination(aj))
    lp = PL._plan_level_elimination(ap, PL._plan_tree_elimination(ap))
    if name not in FORESTS:
        assert lj is None and lp is None
        return
    for field in lj._fields:
        a, b = getattr(lj, field), getattr(lp, field)
        assert np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype, field


def _eliminate_through_indices(host, offsets, W, g, Ftot, sp, ep):
    """The level kernels' index walk (prepare, three gathered sums,
    assemble, per-level fold over the child ranges, per-level
    back-substitution, un-permute), emulated in NumPy."""
    w = 1.0 / W
    const = (-sp * (host["start_bif"] < 0) + ep * (host["end_bif"] < 0) - g) / W
    vt = np.stack([w, const + Ftot], -1)
    vs = np.stack([w, -const], -1)

    def gather_sum(idx, vals):
        vp = np.concatenate([vals, np.zeros((1,) + vals.shape[1:])])
        return np.stack([sum(vp[i] for i in row) if row.size else 0 * vp[0] for row in idx])

    w_pairs = gather_sum(host["p_idx"], w) if host["p_idx"].shape[0] else np.zeros(0)
    dr = gather_sum(host["t_idx"], vt) + gather_sum(host["s_idx"], vs)
    d, r = dr[:, 0].copy(), dr[:, 1].copy()
    rhs_norm = np.sqrt(np.sum(r * r))
    pp = host["parent_pair"]
    wn = np.where(pp >= 0, w_pairs[np.maximum(pp, 0)] if w_pairs.size else 0.0, 0.0)
    cp = host["child_ptr"]
    for l in range(len(offsets) - 3, -1, -1):
        for p in range(offsets[l], offsets[l + 1]):
            kids = range(cp[p], cp[p + 1])
            if not kids:
                continue
            ud = sum(-wn[c] * (wn[c] / d[c]) for c in kids)
            ur = sum((wn[c] / d[c]) * r[c] for c in kids)
            d[p], r[p] = d[p] + ud, r[p] + ur
    lam = np.empty_like(d)
    for l in range(len(offsets) - 1):
        for b in range(offsets[l], offsets[l + 1]):
            par = host["parent_pos"][b]
            lam[b] = r[b] / d[b] if par < 0 else (r[b] + wn[b] * lam[par]) / d[b]
    return lam[host["perm"]], rhs_norm


@pytest.mark.parametrize("name", FORESTS)
def test_device_level_plan_reproduces_plain_elimination(name):
    _, ap = _assemblers(GRAPHS[name])
    tp = PL._plan_tree_elimination(ap)
    lp = PL._plan_level_elimination(ap, tp)
    host = PL.flatten_level_plan(lp, tp)
    assert np.array_equal(host["start_bif"], ap._edge_start_bif)
    assert np.array_equal(host["end_bif"], ap._edge_end_bif)
    B = ap.network.num_multipliers
    offs = lp.level_offsets
    for p in range(B):  # each child range holds exactly the children, in order
        kids = np.flatnonzero(lp.parent_pos == p)
        assert np.array_equal(kids, np.arange(host["child_ptr"][p], host["child_ptr"][p + 1]))
    dlp = PL.device_level_plan(lp, tp, "cpu")
    assert all(t.dtype == torch.int32 for t in (dlp.t_idx, dlp.child_ptr, dlp.perm, dlp.start_bif))
    assert dlp.level_offsets == tuple(int(o) for o in offs)
    assert dlp.host_offsets.dtype == np.int64 and dlp.host_offsets.flags.c_contiguous
    rng = np.random.default_rng(3)
    E = ap.network.num_edges
    W, g, Ftot = rng.uniform(0.5, 2.0, E), rng.uniform(-1, 1, E), rng.uniform(-1, 1, E)
    sp = np.where(host["start_bif"] < 0, rng.uniform(-1, 1, E), 0.0)
    ep = np.where(host["end_bif"] < 0, rng.uniform(-1, 1, E), 0.0)
    lam, norm = _eliminate_through_indices(host, dlp.level_offsets, W, g, Ftot, sp, ep)
    ed = _EdgeData(
        mt=None, cumF=_t(Ftot)[None, :], W=_t(W), g=_t(g), start_bif=dlp.start_bif,
        end_bif=dlp.end_bif, start_pbc=_t(sp), end_pbc=_t(ep), interior=(),
    )
    lam_p, norm_p = level_eliminate.level_eliminate(dlp, ed)
    _close(lam_p, lam, tol=1e-13)
    _close(norm_p, norm, tol=1e-13)


# ------------------------------------------------------------------ K6


def _segments(rng, S, hub=0):
    """Sorted segment ids of S segments of 0-3 members, one of ``hub``."""
    counts = rng.integers(0, 4, S)
    if hub:
        counts[S // 2] = hub
    counts[0] = max(counts[0], 1)
    return np.repeat(np.arange(S), counts).astype(np.int32)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("with_sel", [False, True])
@pytest.mark.parametrize("hub", [0, 40])
def test_segsum_plain_matches_segsum_sorted(channels, with_sel, hub):
    rng = np.random.default_rng(7 + hub + channels)
    S = 25
    seg = _segments(rng, S, hub=hub)
    n_vals = seg.size + 9
    sel = rng.permutation(n_vals)[: seg.size].astype(np.int32) if with_sel else None
    shape = (n_vals if with_sel else seg.size,) + ((channels,) if channels > 1 else ())
    vals = rng.uniform(-1, 1, shape)
    want = JS._segsum_sorted(jnp.asarray(vals), seg, S, sel=sel)
    idx = PL.segsum_matrix(seg, S, vals.shape[0], sel=sel)
    assert idx.shape == (S, max(np.bincount(seg, minlength=S)))
    got = segsum.segsum(torch.as_tensor(idx.astype(np.int32)), _t(vals))
    _close(got, want)


def test_segsum_matrix_pads_to_the_zero_slot():
    idx = PL.segsum_matrix(np.array([0, 0, 2]), 3, n_vals=5, sel=np.array([4, 1, 3]))
    assert np.array_equal(idx, [[4, 1], [5, 5], [3, 5]])
    assert PL.segsum_matrix(np.empty(0, np.int32), 3, 5).shape == (3, 0)
    got = segsum.segsum(torch.zeros((3, 0), dtype=torch.int32), _t(np.ones(5)))
    assert torch.equal(got, torch.zeros(3, dtype=torch.float64))


# ------------------------------------------------------------------ K8a / K7 / K8b

# (k, R_mode, f_mode, f is the scalar zero): every layout, k in {1, 2, 3}
EDGE_CASES = [
    (1, "edge", "scalar", True),  # uniform
    (1, "scalar", "edge", False),  # uniform
    (1, "cell", "scalar", True),  # scalar, source elided
    (1, "cell", "quad", False),  # scalar
    (2, "edge", "cell", False),  # scalar_k
    (2, "cell", "scalar", True),  # scalar_k, source elided
    (3, "scalar", "edge", False),  # scalar_k
    (1, "quad", "scalar", True),  # general
    (1, "quad", "quad", False),  # general
    (2, "quad", "cell", False),  # general, per-cell interior Cholesky
    (3, "quad", "scalar", True),  # general
    (3, "quad", "edge", False),  # general
]


def _coefficients(rng, mode, E, C, nq, lo, hi, zero=False):
    if zero:
        return np.zeros(1)
    shape = {"scalar": (1,), "edge": (E,), "cell": (C,), "quad": (C, nq)}[mode]
    return rng.uniform(lo, hi, shape)


def _reference_edge_data(aj, k, R_mode, f_mode, f_zero, R, f, sp, ep):
    """The reference's generic ``core`` up to its edge data (``:4278-4322``)."""
    mesh = aj.network
    R, f, sp, ep = (jnp.asarray(a) for a in (R, f, sp, ep))
    if k == 1 and R_mode in ("scalar", "edge") and f_mode in ("scalar", "edge"):
        return JS._make_edge_data_uniform(aj, R, f, sp, ep, R_mode, f_mode)
    w = jnp.asarray(aj._quad_weights)
    phi = jnp.asarray(aj._quad_phi)
    h = jnp.asarray(mesh.cell_h)
    cell_edge = jnp.asarray(mesh.cell_edge)
    if f_mode == "quad":
        cell_f_int = jnp.einsum("cq,q->c", f, w) * h
    elif f_mode == "scalar":
        cell_f_int = f[0] * h
    elif f_mode == "edge":
        cell_f_int = f[cell_edge] * h
    else:
        cell_f_int = f * h
    if R_mode == "quad":
        cell_mass = jnp.einsum("cq,q,qi,qj->cij", R, w, phi, phi) * h[:, None, None]
        return JS._make_edge_data(aj, cell_mass, cell_f_int, sp, ep)
    R_cells = {"scalar": lambda: R[0] * jnp.ones_like(h), "edge": lambda: R[cell_edge],
               "cell": lambda: R}[R_mode]()
    return JS._make_edge_data_scalar(aj, R_cells * h, cell_f_int, sp, ep, f_zero)


def _port_inputs(ap, k, R_mode, f_mode, f_zero, seed, device="cpu"):
    """The edge-data arguments of a random problem on the port assembler:
    ``(dlp, N, k, h_e, quad_w, quad_phi, R, f, R_mode, f_mode, f_zero,
    start_pbc, end_pbc)``, tensors on ``device``."""
    mesh = ap.network
    E, C, nq = mesh.num_edges, mesh.num_cells, k + 1
    rng = np.random.default_rng(seed)
    R = _coefficients(rng, R_mode, E, C, nq, 0.5, 2.0)
    f = _coefficients(rng, f_mode, E, C, nq, -1.0, 1.0, zero=f_zero)
    sp = np.where(ap._edge_start_bif < 0, rng.uniform(-1, 1, E), 0.0)
    ep = np.where(ap._edge_end_bif < 0, rng.uniform(-1, 1, E), 0.0)
    tp = PL._plan_tree_elimination(ap)
    dlp = PL.device_level_plan(PL._plan_level_elimination(ap, tp), tp, device)
    h_e, qw, qphi, R, f, sp, ep = (
        _t(a).to(device) for a in (mesh.edge_length / mesh.N, ap._quad_weights, ap._quad_phi,
                                   R, f, sp, ep)
    )
    return (dlp, mesh.N, k, h_e, qw, qphi, R, f, R_mode, f_mode, f_zero, sp, ep)


def _edge_problem(k, R_mode, f_mode, f_zero, graph=_irregular, N=3, seed=0):
    aj, ap = _assemblers(graph, N=N, k=k)
    args = _port_inputs(ap, k, R_mode, f_mode, f_zero, seed)
    dlp, layout = args[0], edge_layout(k, R_mode, f_mode)
    R, f, sp, ep = (a.numpy() for a in (args[6], args[7], args[11], args[12]))
    ed_j = _reference_edge_data(aj, k, R_mode, f_mode, f_zero, R, f, sp, ep)
    ed_p = edge_data.edge_data(*args)
    lj = JS._plan_level_elimination(aj, JS._plan_tree_elimination(aj))
    return aj, ap, lj, dlp, layout, ed_j, ed_p


@pytest.mark.parametrize("k,R_mode,f_mode,f_zero", EDGE_CASES)
def test_edge_data_plain_matches_make_edge_data(k, R_mode, f_mode, f_zero):
    _, ap, _, _, layout, ed_j, ed_p = _edge_problem(k, R_mode, f_mode, f_zero)
    N, E = ap.network.N, ap.network.num_edges
    _close(ed_p.W, ed_j.W)
    _close(ed_p.g, ed_j.g)
    _close(ed_p.cumF, np.asarray(ed_j.cumF).T)
    assert (ed_p.mt is None) == (ed_j.mt is None)
    if layout == "general":
        _close(ed_p.mt, np.transpose(np.asarray(ed_j.mt), (1, 2, 3, 0)))
    for field in ("rh", "ua", "uF"):
        a, b = getattr(ed_p, field), getattr(ed_j, field)
        assert (a is None) == (b is None), field
        if a is not None:
            _close(a, np.asarray(b).T)
    assert len(ed_p.interior) == len(ed_j.interior) == (1 if k > 1 else 0)
    if k > 1:
        want = np.asarray(ed_j.interior[0])
        if want.ndim == 3:  # per cell (C, k-1, 2) -> (N, k-1, 2, E)
            want = np.transpose(want.reshape(E, N, k - 1, 2), (1, 2, 3, 0))
        _close(ed_p.interior[0], want)


@pytest.mark.parametrize("k,R_mode,f_mode,f_zero", EDGE_CASES[::3] + [EDGE_CASES[9]])
def test_level_eliminate_and_backsub_plain_match_reference(k, R_mode, f_mode, f_zero):
    aj, ap, lj, dlp, _, ed_j, ed_p = _edge_problem(k, R_mode, f_mode, f_zero, seed=4)
    B = ap.network.num_multipliers
    lam_j, norm_j = JS._level_eliminate(lj, ed_j, B)
    lam_p, norm_p = level_eliminate.level_eliminate(dlp, ed_p)
    _close(lam_p, lam_j)
    _close(norm_p, norm_j)
    q_j, p_j, _ = JS._solution_blocks_T(aj, ed_j, lam_j)
    q_p, p_p, finite = backsub.backsub(ed_p, _t(np.asarray(lam_j)), ap.network.N, k)
    _close(q_p, q_j)
    _close(p_p, p_j)
    assert bool(finite)


def test_backsub_finite_flag_covers_lambda_and_blocks():
    _, ap, _, _, _, _, ed_p = _edge_problem(2, "quad", "cell", False, seed=5)
    B, N = ap.network.num_multipliers, ap.network.N
    lam = torch.zeros(B, dtype=torch.float64)
    assert bool(backsub.backsub(ed_p, lam, N, 2)[2])
    lam[-1] = float("nan")
    assert not bool(backsub.backsub(ed_p, lam, N, 2)[2])
    bad = ed_p._replace(W=ed_p.W.clone())
    bad.W[0] = 0.0
    assert not bool(backsub.backsub(bad, torch.zeros(B, dtype=torch.float64), N, 2)[2])


def test_general_wrappers_never_fall_back_off_the_cpu():
    """CPU tensors run the plain versions without counting a launch; any
    other device goes to the kernel path, which validates and raises."""
    from networks_fenicsx_tpu_torch import kernels

    kernels.reset_launches()
    _, ap, _, dlp, layout, _, ed_p = _edge_problem(1, "quad", "scalar", True)
    level_eliminate.level_eliminate(dlp, ed_p)
    assert all(n == 0 for n in kernels.launches().values())
    meta = torch.ones(4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        segsum.segsum(torch.zeros((2, 1), dtype=torch.int32), meta)
    with pytest.raises(ValueError, match="CUDA"):
        backsub.backsub(ed_p._replace(W=meta), meta, ap.network.N, 1)
    with pytest.raises(ValueError, match="CUDA"):
        edge_data.edge_data(dlp, 3, 1, meta, None, None, meta, meta, "quad", "scalar", True, meta,
                            meta)


# ------------------------------------------------------------------ card

CARD_CASES = [
    (1, "quad", "quad", False, lambda pkg: arterial(pkg, 7)),  # general, k = 1
    (2, "edge", "cell", False, lambda pkg: _irregular(pkg, 400, 7)),  # scalar_k
    (3, "quad", "edge", False, lambda pkg: _irregular(pkg, 200, 3)),  # general, Cholesky
    (1, "edge", "scalar", False, lambda pkg: _irregular(pkg, 400, 7)),  # uniform
    (1, "cell", "scalar", True, lambda pkg: _irregular(pkg, 200, 3)),  # scalar, elided source
]


@pytest.mark.cuda
def test_general_kernels_match_plain_on_card():
    """On a CUDA device: K8a, K6, K6 + K7 and K8b each equal their plain
    versions on the same inputs (``pytest -m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for k, R_mode, f_mode, f_zero, graph in CARD_CASES:
        ap = P.HydraulicNetworkAssembler(P.NetworkMesh(graph(P), N=4), flux_degree=k)
        ap.compute_forms(p_bc_ex=lambda x: x[0])
        args = _port_inputs(ap, k, R_mode, f_mode, f_zero, seed=k, device=dev)
        dlp, N, E = args[0], args[1], ap.network.num_edges
        ed = edge_data.edge_data(*args)
        ed_plain = edge_data.edge_data_plain(*args)
        for a, b in zip(ed, ed_plain):
            if isinstance(a, torch.Tensor) and a.dtype == torch.float64:
                _close(a.cpu(), b.cpu())
        for a, b in zip(ed.interior, ed_plain.interior):
            _close(a.cpu(), b.cpu())
        for idx, vals in ((dlp.t_idx, torch.rand(E, 2, dtype=torch.float64, device=dev)),
                          (dlp.p_idx, torch.rand(E, dtype=torch.float64, device=dev))):
            _close(segsum.segsum(idx, vals).cpu(), segsum.segsum_plain(idx, vals).cpu())
        lam, norm = level_eliminate.level_eliminate(dlp, ed_plain)
        lam_plain, norm_plain = level_eliminate.level_eliminate_plain(dlp, ed_plain)
        _close(lam.cpu(), lam_plain.cpu())
        _close(norm.cpu(), norm_plain.cpu())
        got = backsub.backsub(ed_plain, lam_plain, N, k)
        want = backsub.backsub_plain(ed_plain, lam_plain, N, k)
        _close(got[0].cpu(), want[0].cpu())
        _close(got[1].cpu(), want[1].cpu())
        assert bool(got[2]) and bool(want[2])
    torch.cuda.synchronize()
