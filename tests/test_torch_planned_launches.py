"""K6's sum plans and K19c's fused V-cycle pieces of the PyTorch port.

K6 (``kernels/segsum.py``): a :class:`SumPlan` holds a route's sums, checked
once, and ``segsum_plan`` sums them in one launch.  On the CPU:

* the plan's plain version against the JAX reference's ``_segsum_sorted``
  (random segments with hubs of K > 32) and ``_lambda_system_sorted`` on
  the level, tree and lattice plans, at 1e-12·scale;
* a model of the kernel's shared output (each row ``+0.0`` plus every
  group's sum in group order, found through the plan's inverse tables)
  against the plain version's two sequential ``segsum_plain`` adds, by
  ``torch.equal``;
* the plan refusing bad tables at construction, as ``FoldPlan`` does.

K19c (``kernels/mg2d.py``): the smoother's start folded into its first
step, ``residual_restrict`` and ``prolong_residual`` (their plain versions
on the CPU, and a cell-by-cell model of their kernels) equal the composed
plain versions by ``torch.equal``, and a model of the ``Cycle``'s two
sweeps (the fused pieces, its buffers and their order) equals the plain
V-cycle of ``Mg2dPreconditioner`` by ``torch.equal``.

The ``cuda``-marked tests hold the kernels against the plain versions on a
card: bit for bit, one launch a plan, 6 launches a smoothed level.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu_torch import lattice as PLat
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch import multigrid as PM
from networks_fenicsx_tpu_torch import tree as PT
from networks_fenicsx_tpu_torch.edge_data import _EdgeData
from networks_fenicsx_tpu_torch.kernels import krylov, mg2d, segsum, shard_general
from networks_fenicsx_tpu_torch.kernels.level_eliminate import _prepare_plain
from networks_fenicsx_tpu_torch.ops.krylov import chebyshev_coefficients

torch.set_num_threads(1)

TOL = 1e-12


def _close(got, want, tol=TOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(a, dtype=torch.float64, device="cpu"):
    return torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)


def _i32(a, device="cpu"):
    return _t(a, torch.int32, device)


def _segments(rng, S, hub=0):
    """Sorted segment ids over S segments, each 0–3 long, one of ``hub``."""
    counts = rng.integers(0, 4, S)
    if hub:
        counts[S // 2] = hub
    counts[0] = max(counts[0], 1)
    return np.repeat(np.arange(S), counts).astype(np.int32)


def _web(pkg, n=1000, seed=7):
    return pkg.network_generation.make_random_network(n, keep=0.05, seed=seed, arrays=True)


def _forest(pkg, n=400, seed=7):
    return pkg.network_generation.make_random_network(n, keep=0.0, seed=seed, arrays=True)


def _grid(nx, ny):
    return lambda pkg: pkg.network_generation.make_grid(nx, ny, arrays=True)


def _assembler(pkg, graph, N=1, seed=0):
    mesh = pkg.NetworkMesh(graph(pkg), N=N, color_strategy="fast")
    asm = pkg.HydraulicNetworkAssembler(mesh)
    asm.compute_forms(p_bc_ex=lambda x: x[0],
                      R=np.random.default_rng(seed).uniform(0.5, 2.0, mesh.num_edges))
    return asm


def _edge_data(ap, seed=3, N=3, device="cpu"):
    """Random condensed edge data on ``ap``'s edges, as the reference's
    ``_EdgeData`` and the port's."""
    rng = np.random.default_rng(seed)
    E = ap.network.num_edges
    W, g = rng.uniform(0.5, 2.0, E), rng.standard_normal(E)
    cumF = rng.standard_normal((E, N + 1))
    sb, eb = ap._edge_start_bif, ap._edge_end_bif
    sp = np.where(sb < 0, rng.standard_normal(E), 0.0)
    ep = np.where(eb < 0, rng.standard_normal(E), 0.0)
    ed_j = JS._EdgeData(None, jnp.asarray(cumF), jnp.asarray(W), jnp.asarray(g), jnp.asarray(sb),
                        jnp.asarray(eb), jnp.asarray(sp), jnp.asarray(ep), ())
    ed_p = _EdgeData(None, _t(cumF.T, device=device), _t(W, device=device), _t(g, device=device),
                     _i32(sb, device), _i32(eb, device), _t(sp, device=device), _t(ep, device=device),
                     ())
    return ed_j, ed_p


def _kernel_model(plan, *vals):
    """The kernel's outputs in eager PyTorch: a group with its own output is
    its segment sums; the shared output starts at +0.0 and each row adds the
    sum of every group whose inverse table names it, in group order."""
    outs, shared = [], None
    for (idx, bins), inv, v in zip(plan.groups, plan._inv, vals):
        sums = segsum.segsum_plain(idx, v)
        if bins is None:
            outs.append(sums)
            continue
        if shared is None:
            shared = torch.zeros((plan.rows,) + tuple(v.shape[1:]), dtype=v.dtype)
            outs.append(shared)
        hit = inv >= 0
        shared[hit] = shared[hit] + sums[inv[hit].long()]
    return tuple(outs)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a.cpu(), b.cpu()), (a.shape, b.shape)


# ------------------------------------------------------------------ K6 on the CPU


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("with_sel", [False, True])
@pytest.mark.parametrize("hub", [0, 40])
def test_sum_plan_plain_matches_segsum_sorted(channels, with_sel, hub):
    """Three groups of one plan (one with a hub of 40 > 32 entries) against
    the reference's ``_segsum_sorted``, each at 1e-12·scale."""
    rng = np.random.default_rng(11 + hub + channels)
    segs = [_segments(rng, 25, hub=hub), _segments(rng, 9), _segments(rng, 30, hub=hub // 2)]
    n_vals = max(s.size for s in segs) + 7
    groups, vals, want = [], [], []
    for g, seg in enumerate(segs):
        S = int(seg.max()) + 1
        shape = (n_vals,) + ((channels,) if channels > 1 and g != 1 else ())
        v = rng.uniform(-1, 1, shape)
        if with_sel:
            sel = rng.permutation(n_vals)[: seg.size].astype(np.int32)
            want.append(JS._segsum_sorted(jnp.asarray(v), seg, S, sel=sel))
        else:  # the reference's values are the segments' own rows, the plan's their prefix
            sel = np.arange(seg.size)
            want.append(JS._segsum_sorted(jnp.asarray(v[: seg.size]), seg, S))
        groups.append((_i32(PL.segsum_matrix(seg, S, n_vals, sel=sel)), None))
        vals.append(_t(v))
    plan = segsum.SumPlan(groups, [channels if g != 1 else 1 for g in range(3)])
    assert plan.src_max <= n_vals
    got = segsum.segsum_plan(plan, *vals)
    assert len(got) == 3
    for a, b in zip(got, want):
        _close(a, b)
    _equal(_kernel_model(plan, *vals), got)


def test_level_plan_sums_match_reference():
    """The level route's plan (pairs, target side, source side) on an
    irregular forest against ``_segsum_sorted`` with the reference's plan."""
    aj, ap = _assembler(J, _forest), _assembler(P, _forest)
    tp = PL._plan_tree_elimination(ap)
    dlp = PL.device_level_plan(PL._plan_level_elimination(ap, tp), tp, "cpu")
    lj = JS._plan_level_elimination(aj, JS._plan_tree_elimination(aj))
    E, B = ap.network.num_edges, ap.network.num_multipliers
    rng = np.random.default_rng(5)
    w, vt, vs = rng.uniform(0.5, 2, E), rng.standard_normal((E, 2)), rng.standard_normal((E, 2))
    assert dlp.sums.shapes == (torch.Size((dlp.num_pairs,)), torch.Size((B, 2)), torch.Size((B, 2)))
    got = segsum.segsum_plan(dlp.sums, _t(w), _t(vt), _t(vs))
    want = (JS._segsum_sorted(jnp.asarray(w), lj.p_seg, lj.num_pairs, sel=lj.p_sel),
            JS._segsum_sorted(jnp.asarray(vt), lj.t_seg, B, sel=lj.t_sel),
            JS._segsum_sorted(jnp.asarray(vs), lj.s_seg, B, sel=lj.s_sel))
    for a, b in zip(got, want):
        _close(a, b)
    _equal(got, (segsum.segsum_plain(dlp.p_idx, _t(w)), segsum.segsum_plain(dlp.t_idx, _t(vt)),
                 segsum.segsum_plain(dlp.s_idx, _t(vs))))


@pytest.mark.parametrize("route", ["tree", "lattice"])
def test_lambda_sums_match_lambda_system_sorted(route):
    """The bifurcation system's plan (both sides into one output) on a web's
    tree plan and a lattice's plan against ``_lambda_system_sorted``; its
    shared rows equal the two sequential ``segsum_plain`` adds by
    ``torch.equal``, and so does the kernel's model of them."""
    graph = _web if route == "tree" else _grid(12, 9)
    aj, ap = _assembler(J, graph), _assembler(P, graph)
    lam_plan = PL._build_lambda_plan(ap)
    if route == "tree":
        plan = PT.device_tree_plan(PL._plan_tree_elimination(ap), lam_plan, ap, "cpu")
    else:
        plan = PLat.device_lattice_plan(ap, lam_plan, "cpu")
    ed_j, ed_p = _edge_data(ap)
    B = ap.network.num_multipliers
    d_j, r_j = JS._lambda_system_sorted(ed_j, B, JS._build_lambda_plan(aj))
    _, vt, vs = _prepare_plain(ed_p)
    dr, = segsum.segsum_plan(plan.lambda_sums, vt, vs)
    _close(dr[:, 0], d_j)
    _close(dr[:, 1], r_j)
    seq = torch.zeros((B, 2), dtype=torch.float64)
    segsum.segsum_plain(plan.t_idx, vt, plan.t_bins, seq)
    segsum.segsum_plain(plan.s_idx, vs, plan.s_bins, seq)
    _equal((dr,), (seq,))
    _equal(_kernel_model(plan.lambda_sums, vt, vs), (seq,))


def test_class_sums_match_shift_class_weights():
    """The lattice's class-weight plan against the reference's
    ``_shift_class_weights`` and the port's plain gather."""
    aj, ap = _assembler(J, _grid(10, 7)), _assembler(P, _grid(10, 7))
    dlp = PLat.device_lattice_plan(ap, PL._build_lambda_plan(ap), "cpu")
    R_mode, f_mode, _ = aj.coefficient_modes()
    ed = JS._make_edge_data_uniform(aj, *aj.schur_arguments(), R_mode, f_mode)
    classes = JS._plan_shift_matvec(aj)
    want = JS._shift_class_weights(ed, classes, aj.network.num_multipliers)
    w = _t(1.0 / np.asarray(ed.W))
    got = segsum.segsum_plan(dlp.class_sums, w)[0].view(len(classes), -1)
    for c, (_, v) in enumerate(want):
        _close(got[c], v)
    _equal((got,), (PLat._shift_class_weights(w, dlp.class_idx, len(classes), segsum.segsum_plain),))


@pytest.mark.parametrize("pairs", [True, False])
def test_shard_sums_equal_partials_plain(pairs):
    """A shard's plan (both sides into ``dr``, then the pairs) gives the
    plain partials bit for bit, with and without pairs."""
    ap = _assembler(P, _web)
    tp = PL._plan_tree_elimination(ap)
    E, B = ap.network.num_edges, ap.network.num_multipliers
    half = np.arange(E // 2, E)
    ep = tp.edge_pair[half] if pairs else -np.ones(half.size, np.int64)
    P_ = int(tp.pair_nodes.shape[0]) if pairs else 0
    tab = shard_general.shard_lambda_tables(ap._edge_start_bif[half], ap._edge_end_bif[half], ep, B,
                                            P_, "cpu")
    assert len(tab.sums) == (3 if pairs else 2)
    _, ed = _edge_data(ap)
    ed = ed._replace(cumF=ed.cumF[:, half].contiguous(), W=ed.W[half], g=ed.g[half],
                     start_bif=ed.start_bif[half], end_bif=ed.end_bif[half],
                     start_pbc=ed.start_pbc[half], end_pbc=ed.end_pbc[half])
    part, w = shard_general.partials_plain(tab, ed)
    _, vt, vs = _prepare_plain(ed)
    outs = segsum.segsum_plan(tab.sums, vt, vs, *((w,) if pairs else ()))
    _equal((torch.cat([o.reshape(-1) for o in outs]),), (part,))
    _equal(_kernel_model(tab.sums, vt, vs, *((w,) if pairs else ())), outs)


def _bad_plans():
    idx = _i32([[0, 1], [2, 4]])
    bins = _i32([0, 2])
    return {
        "no_groups": lambda: segsum.SumPlan((), ()),
        "five_groups": lambda: segsum.SumPlan([(idx, None)] * 5, (1,) * 5),
        "channel_count": lambda: segsum.SumPlan([(idx, None)], (1, 2)),
        "meta": lambda: segsum.SumPlan([(torch.zeros((2, 2), dtype=torch.int32, device="meta"), None)],
                                       (1,)),
        "int64": lambda: segsum.SumPlan([(idx.long(), None)], (1,)),
        "one_dim": lambda: segsum.SumPlan([(idx[0], None)], (1,)),
        "strided": lambda: segsum.SumPlan([(idx.t(), None)], (1,)),
        "negative": lambda: segsum.SumPlan([(_i32([[0, -1]]), None)], (1,)),
        "no_rows": lambda: segsum.SumPlan([(idx, bins)], (2,)),
        "bins_unsorted": lambda: segsum.SumPlan([(idx, _i32([2, 0]))], (2,), rows=3),
        "bins_repeated": lambda: segsum.SumPlan([(idx, _i32([1, 1]))], (2,), rows=3),
        "bins_past_rows": lambda: segsum.SumPlan([(idx, _i32([0, 3]))], (2,), rows=3),
        "bins_length": lambda: segsum.SumPlan([(idx, _i32([0]))], (2,), rows=3),
        "shared_channels": lambda: segsum.SumPlan([(idx, bins), (idx, bins)], (2, 1), rows=3),
    }


@pytest.mark.parametrize("case", sorted(_bad_plans()))
def test_sum_plan_refuses_bad_tables(case):
    with pytest.raises(ValueError, match="SumPlan"):
        _bad_plans()[case]()


def test_sum_plan_calls_check_their_values():
    """CPU values run the plain version, uncounted; any other device goes to
    the kernel path, which checks and raises; so do too few values."""
    plan = segsum.SumPlan([(_i32([[0, 1], [2, 4]]), None)], (1,))
    before = segsum.LAUNCHES.launches
    out, = segsum.segsum_plan(plan, _t(np.arange(4.0)))
    assert torch.equal(out, _t([1.0, 2.0])) and segsum.LAUNCHES.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        segsum.segsum_plan(plan, torch.ones(4, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="value tensors"):
        segsum.launch_plan(plan, ())
    assert segsum.LAUNCHES.launches == before


# ------------------------------------------------------------------ K19c on the CPU


def _mg_inputs(nx, ny, seed=5):
    """The 2-D hierarchy's plan and class weights of an ``nx × ny`` lattice's
    λ system (the reference's, per-edge R from a seed) and a random rhs."""
    aj = _assembler(J, _grid(nx, ny), N=2, seed=seed)
    R_mode, f_mode, _ = aj.coefficient_modes()
    ed = JS._make_edge_data_uniform(aj, *aj.schur_arguments(), R_mode, f_mode)
    B = aj.network.num_multipliers
    diag, _ = JS._lambda_system_sorted(ed, B, JS._build_lambda_plan(aj))
    classes = JS._plan_shift_matvec(aj)
    cw = np.stack([np.asarray(v) for _, v in JS._shift_class_weights(ed, classes, B)])
    offsets = np.asarray([d for d, _, _ in classes], np.int32)
    plan = PM.mg2d_plan(offsets, B, nx)
    r = np.random.default_rng(seed).standard_normal(B)
    return plan, _t(cw), _t(np.asarray(diag)), _t(r)


MG_DIMS = [(24, 24), (33, 17), (40, 9)]


def _fused_kernels_cellwise(lev, shape, shape_c, r, x, b, ec, theta, c1, c2, oc, z_base):
    """``mg2d_cheb_first_kernel``, ``mg2d_residual_restrict_kernel`` and
    ``mg2d_prolong_residual_kernel`` of ``csrc/mg2d.cu`` one cell at a time
    in float64 scalars: each neighbour's value formed where the stencil
    reads it (the start's ``s·((s·r)/θ)``, the prolonged
    ``x + oc·e[i/2, j/2]`` by the kernel's index arithmetic), the stencil's
    terms in the kernel's order with 0 past the edges, and a coarse cell's
    four fine residuals added in the kernel's order with 0 in the padding.
    The kernel multiplies by ``1/θ``, which is what PyTorch's ``rs / θ``
    computes on the card; on the CPU both divide.  Returns
    ``([rs, dvec, x_out, z], rc, (x', res))``."""
    ny, nx = shape
    nxc = shape_c[1]
    F = lev.numpy()
    s_, r_, x_, b_, ec_ = (t.numpy() for t in (lev[mg2d.FI], r, x, b, ec))
    base_ = None if z_base is None else z_base.numpy()

    def stencil_of(i, y):
        row, col = divmod(i, nx)
        o = F[mg2d.FD, i] * y(i)
        o = o - F[mg2d.FE, i] * (y(i + 1) if col + 1 < nx else 0.0)
        o = o - F[mg2d.FW, i] * (y(i - 1) if col > 0 else 0.0)
        o = o - F[mg2d.FS, i] * (y(i + nx) if row + 1 < ny else 0.0)
        o = o - F[mg2d.FN, i] * (y(i - nx) if row > 0 else 0.0)
        return o

    def start(j):
        return s_[j] * ((s_[j] * r_[j]) / theta)

    def prolonged(j):
        return x_[j] + oc * ec_[(j // nx // 2) * nxc + (j % nx) // 2]

    def fine_residual(row, col):
        if row >= ny or col >= nx:
            return 0.0
        i = row * nx + col
        return b_[i] - stencil_of(i, lambda j: x_[j])

    m = ny * nx
    rs, dvec, x_out, z, xp, res = (np.empty(m) for _ in range(6))
    for i in range(m):
        mv = s_[i] * stencil_of(i, start)
        rsv = s_[i] * r_[i]
        dv0 = rsv / theta
        dv = c1 * dv0 + c2 * (rsv - mv)
        rs[i], dvec[i] = rsv, dv
        xn = dv0 + dv
        x_out[i] = xn
        z[i] = s_[i] * xn if base_ is None else base_[i] + s_[i] * xn
        xp[i] = prolonged(i)
        res[i] = b_[i] - stencil_of(i, prolonged)
    rc = np.empty(shape_c[0] * nxc)
    for i in range(rc.size):
        row, col = 2 * (i // nxc), 2 * (i % nxc)
        rc[i] = ((fine_residual(row, col) + fine_residual(row, col + 1))
                 + fine_residual(row + 1, col)) + fine_residual(row + 1, col + 1)
    return [_t(a) for a in (rs, dvec, x_out, z)], _t(rc), (_t(xp), _t(res))


@pytest.mark.parametrize("dims", MG_DIMS)
def test_fused_mg2d_plain_equal_composed(dims):
    """The start folded into the first step, ``residual_restrict`` and
    ``prolong_residual`` equal K19a's start, the step, the stencil, the
    restriction and the prolongation composed, by ``torch.equal``, on every
    smoothed level.  On the CPU the wrappers are their plain versions, so
    that comparison pins the plain composition; the cell-by-cell model of
    the three kernels' arithmetic is what holds the kernels' design to it
    here (the card test holds the kernels themselves)."""
    plan, cw, diag, r0 = _mg_inputs(*dims)
    pre = PM.Mg2dPreconditioner(plan, cw, diag, plain=True)
    theta, coeffs = chebyshev_coefficients(PM.SMOOTH_DEGREE, ratio=PM.SMOOTH_RATIO)
    (c1, c2) = coeffs[0]
    chain = plan.shapes + (plan.bottom,)
    gen = torch.Generator().manual_seed(dims[0])
    for lev, shape, shape_c in zip(pre.levels, plan.shapes, chain[1:]):
        m, mc = shape[0] * shape[1], shape_c[0] * shape_c[1]
        r, x, b = (torch.randn(m, generator=gen, dtype=torch.float64) for _ in range(3))
        ec, base = torch.randn(mc, generator=gen, dtype=torch.float64), torch.randn(m, generator=gen,
                                                                                   dtype=torch.float64)
        rc = mg2d.restrict_plain(mg2d.stencil(lev, shape, x, b), shape, shape_c)
        xp = x.clone()
        mg2d.prolong_plain(xp, shape, shape_c, ec, pre.overcorrect)
        prolonged = (xp, mg2d.stencil(lev, shape, xp, b))
        for z_base in (None, base):
            fused = [torch.empty(m, dtype=torch.float64) for _ in range(4)]
            mg2d.cheb_first(lev, shape, r, theta, *fused[:3], c1, c2, fused[3], z_base)
            comp = [torch.empty(m, dtype=torch.float64) for _ in range(5)]
            krylov.cheb_start(lev[mg2d.FI], r, theta, comp[0], comp[1], comp[4])
            mg2d.cheb_plain(lev, shape, comp[0], comp[1], comp[4], comp[2], c1, c2, comp[3], z_base)
            _equal(fused, comp[:4])
            cells, cells_rc, cells_prolonged = _fused_kernels_cellwise(
                lev, shape, shape_c, r, x, b, ec, theta, c1, c2, pre.overcorrect, z_base)
            _equal(cells, comp[:4])
        _equal((mg2d.residual_restrict(lev, shape, shape_c, x, b),), (rc,))
        _equal(mg2d.prolong_residual(lev, shape, shape_c, x, ec, pre.overcorrect, b), prolonged)
        _equal((cells_rc,), (rc,))
        _equal(cells_prolonged, prolonged)


def _cycle_model(pre, r):
    """``Cycle.down``, the coarsest solve and ``Cycle.up`` in eager PyTorch:
    the fused pieces' plain versions in the sweeps' order, on the sweeps'
    buffers (the post-smoother's result written over its base ``xp``)."""
    theta, coeffs = chebyshev_coefficients(PM.SMOOTH_DEGREE, ratio=PM.SMOOTH_RATIO)
    shapes = pre.plan.shapes
    chain = shapes + (pre.plan.bottom,)

    def smooth(lev, shape, rr, z, base):
        rs, dvec, xa, xb = (torch.empty_like(rr) for _ in range(4))
        last = len(coeffs) == 1
        mg2d.cheb_first_plain(lev, shape, rr, theta, rs, dvec, xa, *coeffs[0], z if last else None,
                              base if last else None)
        for t in range(1, len(coeffs)):
            end = t == len(coeffs) - 1
            mg2d.cheb_plain(lev, shape, rs, dvec, xa, xb, *coeffs[t], z if end else None,
                            base if end else None)
            xa, xb = xb, xa

    rhs, xs = [r], []
    for l, (lev, shape) in enumerate(zip(pre.levels, shapes)):
        xs.append(torch.empty_like(rhs[l]))
        smooth(lev, shape, rhs[l], xs[l], None)
        rhs.append(mg2d.residual_restrict_plain(lev, shape, chain[l + 1], xs[l], rhs[l]))
    e = mg2d.coarse_solve_plain(pre.factor, rhs[-1])
    for l in reversed(range(len(shapes))):
        xp, res = mg2d.prolong_residual_plain(pre.levels[l], shapes[l], chain[l + 1], xs[l], e,
                                              pre.overcorrect, rhs[l])
        smooth(pre.levels[l], shapes[l], res, xp, xp)
        e = xp
    return e


@pytest.mark.parametrize("dims", MG_DIMS)
def test_cycle_model_equals_plain_vcycle(dims):
    """The fused cycle's order of work gives the plain V-cycle's result to
    the bit."""
    plan, cw, diag, r = _mg_inputs(*dims)
    pre = PM.Mg2dPreconditioner(plan, cw, diag, plain=True)
    assert len(plan.shapes) >= 1 and pre.cycle is None
    _equal((_cycle_model(pre, r),), (pre(r),))


def test_cycle_refuses_bad_hierarchies():
    lev = torch.zeros((len(mg2d.FIELDS), 16), dtype=torch.float64)
    coeffs = [(0.5, 0.25)]
    for args in (((), (), (2, 2)), ((lev,) * 17, ((4, 4),) * 17, (2, 2)), ((lev,), ((4, 4),), (2, 2))):
        with pytest.raises(ValueError, match="mg2d"):
            mg2d.Cycle(*args, 2.0, coeffs, 1.8)
    with pytest.raises(ValueError, match="mg2d"):
        mg2d.Cycle((lev,), ((4, 4),), (2, 2), 2.0, [], 1.8)


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sum_plans_match_plain_on_card():
    """K6 on its plans — the forest's level route, the web's bifurcation
    system and pairs, the lattice's sides and classes, a web shard's
    partials — equal the plain versions bit for bit, one launch a plan."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(12)

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64, device=dev)

    ap = _assembler(P, _forest)
    tp = PL._plan_tree_elimination(ap)
    dlp = PL.device_level_plan(PL._plan_level_elimination(ap, tp), tp, dev)
    E = ap.network.num_edges
    web = _assembler(P, _web)
    dtp = PT.device_tree_plan(PL._plan_tree_elimination(web), PL._build_lambda_plan(web), web, dev)
    Ew = web.network.num_edges
    grid = _assembler(P, _grid(40, 30))
    dgp = PLat.device_lattice_plan(grid, PL._build_lambda_plan(grid), dev)
    Eg = grid.network.num_edges
    cases = [(dlp.sums, (rand(E), rand(E, 2), rand(E, 2))),
             (dtp.lambda_sums, (rand(Ew, 2), rand(Ew, 2))), (dtp.pair_sums, (rand(Ew),)),
             (dgp.lambda_sums, (rand(Eg, 2), rand(Eg, 2))), (dgp.class_sums, (rand(Eg),))]
    for plan, vals in cases:
        before = segsum.LAUNCHES.launches
        got = segsum.segsum_plan(plan, *vals)
        assert segsum.LAUNCHES.launches == before + 1
        _equal(got, segsum.segsum_plan_plain(plan, *vals))
    tpw = PL._plan_tree_elimination(web)
    half = np.arange(Ew // 2, Ew)
    tab = shard_general.shard_lambda_tables(web._edge_start_bif[half], web._edge_end_bif[half],
                                            tpw.edge_pair[half], web.network.num_multipliers,
                                            int(tpw.pair_nodes.shape[0]), dev)
    _, ed = _edge_data(web, device=dev)
    ed = ed._replace(cumF=ed.cumF[:, half].contiguous(), W=ed.W[half].contiguous(),
                     g=ed.g[half].contiguous(), start_bif=ed.start_bif[half].contiguous(),
                     end_bif=ed.end_bif[half].contiguous(), start_pbc=ed.start_pbc[half].contiguous(),
                     end_pbc=ed.end_pbc[half].contiguous())
    _equal(shard_general.partials(tab, ed), shard_general.partials_plain(tab, ed))


@pytest.mark.cuda
def test_mg2d_fused_kernels_and_cycle_on_card():
    """K19c's fused kernels equal their plain versions bit for bit at 33×17;
    the V-cycle equals the plain one at 1e-12·scale in 6 launches a
    smoothed level and one coarsest solve, and two cycles on two streams
    give the same bits."""
    dev = _card()
    plan, cw, diag, r0 = _mg_inputs(33, 17)
    cw, diag, r = cw.to(dev), diag.to(dev), r0.to(dev)
    got = PM.Mg2dPreconditioner(plan, cw, diag)
    want = PM.Mg2dPreconditioner(plan, cw, diag, plain=True)
    assert got.cycle is not None
    theta, coeffs = chebyshev_coefficients(PM.SMOOTH_DEGREE, ratio=PM.SMOOTH_RATIO)
    chain = plan.shapes + (plan.bottom,)
    gen = torch.Generator(device=dev).manual_seed(3)
    for lev, shape, shape_c in zip(want.levels, plan.shapes, chain[1:]):
        m, mc = shape[0] * shape[1], shape_c[0] * shape_c[1]
        x, b = (torch.randn(m, generator=gen, dtype=torch.float64, device=dev) for _ in range(2))
        ec = torch.randn(mc, generator=gen, dtype=torch.float64, device=dev)
        _equal((mg2d.residual_restrict(lev, shape, shape_c, x, b),),
               (mg2d.residual_restrict_plain(lev, shape, shape_c, x, b),))
        _equal(mg2d.prolong_residual(lev, shape, shape_c, x, ec, 1.8, b),
               mg2d.prolong_residual_plain(lev, shape, shape_c, x, ec, 1.8, b))
        outs = [[torch.empty(m, dtype=torch.float64, device=dev) for _ in range(4)] for _ in range(2)]
        for fn, o in zip((mg2d.cheb_first, mg2d.cheb_first_plain), outs):
            fn(lev, shape, x, theta, *o[:3], *coeffs[0], o[3], b)
        _equal(outs[0], outs[1])
    mg2d.LAUNCHES.launches = krylov.LAUNCHES.launches = 0
    z = got(r)
    assert mg2d.LAUNCHES.launches == 6 * len(plan.shapes) + 1 and krylov.LAUNCHES.launches == 0
    _close(z, want(r))
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs = []
    torch.cuda.synchronize(dev)
    for s in streams:
        with torch.cuda.stream(s):
            outs.append(got(r))
    torch.cuda.synchronize(dev)
    _equal(outs, (z, z))
