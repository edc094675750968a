"""K19d's fused 1-D V-cycle (``kernels/mg1d.py``: ``Cycle``).

On a CUDA device ``Mg1dPreconditioner`` runs its smoothed levels as one
``mg1d.Cycle``: per level the smoother's start folded into its first step,
its second step, the residual with the pair-sum restriction, the
prolongation with the next residual, the post-smoother's two steps — 6
launches a level, in two host calls around K19c's coarsest solve.  On the
CPU, on the 3×2000 lattice's hierarchy (4 levels, even sizes) and two
smaller ``_plan_mg`` hierarchies (4×250: one level; 5×301: 1,505 and 753
rows, odd, and 6 classes on the second level):

* the three fused pieces' plain versions, and a row-by-row NumPy model of
  the kernels (``csrc/mg1d.cu``: each neighbour's value formed where the
  operator reads it, the classes in ascending offset, 0 past the ends, a
  coarse row's two fine residuals added in order), equal the composed plain
  pieces (K19a's start, K18's step and residual, the pair sums and the
  repeat) by ``torch.equal``;
* a model of the ``Cycle``'s two sweeps (the fused pieces in their order on
  the sweeps' buffers), and ``mg1d.cycle_plain``, equal the plain V-cycle by
  ``torch.equal``, in the launches of the ``Cycle``'s formula;
* the ``Cycle`` refuses bad hierarchies.

The ``cuda``-marked test holds the kernels themselves on a card: the fused
pieces bit for bit with their plain versions, a whole cycle bit for bit
with the plain pieces composed around the same coarsest solve, on two
streams, in 6 launches a level and one coarsest solve.
"""

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu as J
from networks_fenicsx_tpu import solver as JS
from networks_fenicsx_tpu_torch import multigrid as PM
from networks_fenicsx_tpu_torch.kernels import krylov, mg1d, mg2d, shift_matvec
from networks_fenicsx_tpu_torch.ops.krylov import chebyshev_coefficients

torch.set_num_threads(1)

HIERARCHIES = {"3x2000": (3, 2000), "4x250": (4, 250), "5x301": (5, 301)}
LEVELS = {"3x2000": [6000, 3000, 1500, 750], "4x250": [1000], "5x301": [1505, 753]}


def _t(a, dtype=torch.float64, device="cpu"):
    return torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)


def _inputs(nx, ny, seed=4, device="cpu"):
    """The 1-D hierarchy's plan, the class weights and diagonal of an
    ``nx × ny`` lattice's λ system (the reference's, N = 2, per-edge R from
    a seed) and a random rhs."""
    mesh = J.NetworkMesh(J.network_generation.make_grid(nx, ny, arrays=True), N=2,
                         color_strategy="fast")
    aj = J.HydraulicNetworkAssembler(mesh)
    aj.compute_forms(p_bc_ex=lambda x: x[0],
                     R=np.random.default_rng(seed).uniform(0.5, 2.0, mesh.num_edges))
    R_mode, f_mode, _ = aj.coefficient_modes()
    ed = JS._make_edge_data_uniform(aj, *aj.schur_arguments(), R_mode, f_mode)
    B = aj.network.num_multipliers
    diag, _ = JS._lambda_system_sorted(ed, B, JS._build_lambda_plan(aj))
    classes = JS._plan_shift_matvec(aj)
    cw = np.stack([np.asarray(v) for _, v in JS._shift_class_weights(ed, classes, B)])
    plan = PM.device_mg1d_plan(PM._plan_mg([d for d, _, _ in classes], B), device)
    r = np.random.default_rng(seed).standard_normal(B)
    return plan, _t(cw, device=device), _t(np.asarray(diag), device=device), _t(r, device=device)


def _close(got, want, tol):
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


def _equal(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and torch.equal(a, b), (a.shape, b.shape)


def _rows(lev: mg1d.Level):
    """``apply(i, y)``: row ``i`` of the level's operator on ``y(j)``, as the
    kernels form it (diag first, then the classes in ascending offset, 0
    outside the level)."""
    off, cw, diag = lev.offsets.tolist(), lev.cw.numpy(), lev.diag.numpy()
    m = diag.size

    def apply(i, y):
        o = diag[i] * y(i)
        for c, dlt in enumerate(off):
            j = i + dlt
            o = o - cw[c, i] * (y(j) if 0 <= j < m else 0.0)
        return o

    return apply


def _kernels_rowwise(lev, r, x, b, ec, rs_in, dvec_in, theta, c1, c2, oc, base):
    """``mg1d_cheb_first_kernel``, ``mg1d_cheb_kernel``,
    ``mg1d_residual_restrict_kernel`` and ``mg1d_prolong_residual_kernel``
    one row at a time in float64 scalars.  The kernel multiplies by ``1/θ``,
    which is what PyTorch's ``rs / θ`` computes on the card; on the CPU both
    divide.  Returns ``([rs, dvec, x_out, z], [dvec, x_out, z], rc,
    [x', res])``."""
    apply = _rows(lev)
    s_, r_, x_, b_, ec_ = (t.numpy() for t in (lev.dis, r, x, b, ec))
    rs0, dv0_, base_ = rs_in.numpy(), dvec_in.numpy(), None if base is None else base.numpy()
    m = s_.size

    def z_of(i, xn):
        return s_[i] * xn if base_ is None else base_[i] + s_[i] * xn

    first, step, pro = [np.empty(m) for _ in range(4)], [np.empty(m) for _ in range(3)], \
        [np.empty(m) for _ in range(2)]
    for i in range(m):
        mv = s_[i] * apply(i, lambda j: s_[j] * ((s_[j] * r_[j]) / theta))
        rsv = s_[i] * r_[i]
        dv0 = rsv / theta
        dv = c1 * dv0 + c2 * (rsv - mv)
        xn = dv0 + dv
        first[0][i], first[1][i], first[2][i], first[3][i] = rsv, dv, xn, z_of(i, xn)
        mv = s_[i] * apply(i, lambda j: s_[j] * x_[j])
        dv = c1 * dv0_[i] + c2 * (rs0[i] - mv)
        xn = x_[i] + dv
        step[0][i], step[1][i], step[2][i] = dv, xn, z_of(i, xn)

        def prolonged(j):
            return x_[j] + oc * ec_[j // 2]

        pro[0][i], pro[1][i] = prolonged(i), b_[i] - apply(i, prolonged)

    def fine(i):
        return 0.0 if i >= m else b_[i] - apply(i, lambda j: x_[j])

    rc = np.asarray([fine(2 * I) + fine(2 * I + 1) for I in range((m + 1) // 2)])
    return [_t(a) for a in first], [_t(a) for a in step], _t(rc), [_t(a) for a in pro]


@pytest.mark.parametrize("name", sorted(HIERARCHIES))
def test_fused_pieces_equal_composed(name):
    """On every smoothed level: the fused pieces' plain versions equal the
    composed plain pieces, and so does the row model of the kernels (the
    smoother's step too), by ``torch.equal``."""
    plan, cw, diag, _ = _inputs(*HIERARCHIES[name])
    pre = PM.Mg1dPreconditioner(plan, None, cw, diag, plain=True)
    assert [lev.diag.shape[0] for lev in pre.levels] == LEVELS[name]
    theta, coeffs = chebyshev_coefficients(PM.SMOOTH_DEGREE, ratio=PM.SMOOTH_RATIO)
    (c1, c2) = coeffs[0]
    oc = pre.overcorrect
    gen = torch.Generator().manual_seed(sum(HIERARCHIES[name]))
    for lev in pre.levels:
        m = lev.diag.shape[0]
        r, x, b, base, rs, dvec = (torch.randn(m, generator=gen, dtype=torch.float64)
                                   for _ in range(6))
        ec = torch.randn((m + 1) // 2, generator=gen, dtype=torch.float64)
        rows_first, rows_step, rows_rc, rows_pro = _kernels_rowwise(
            lev, r, x, b, ec, rs, dvec, theta, c1, c2, oc, base)
        fused = [torch.empty(m, dtype=torch.float64) for _ in range(4)]
        mg1d.cheb_first(lev, r, theta, *fused[:3], c1, c2, fused[3], base)
        comp = [torch.empty(m, dtype=torch.float64) for _ in range(5)]
        krylov.cheb_start_plain(lev.dis, r, theta, comp[0], comp[1], comp[4])
        shift_matvec.shift_cheb_plain(lev.offsets, lev.cw, lev.diag, lev.dis, comp[0], comp[1],
                                      comp[4], comp[2], c1, c2, comp[3], base)
        _equal(fused, comp[:4])
        _equal(rows_first, comp[:4])
        step = [dvec.clone(), torch.empty(m, dtype=torch.float64), torch.empty(m, dtype=torch.float64)]
        shift_matvec.shift_cheb_plain(lev.offsets, lev.cw, lev.diag, lev.dis, rs, step[0], x, step[1],
                                      c1, c2, step[2], base)
        _equal(rows_step, step)
        res = shift_matvec.shift_matvec_plain(lev.offsets, lev.cw, lev.diag, x, b)
        rc = mg1d.restrict_plain(res, (m + 1) // 2)
        _equal((mg1d.residual_restrict(lev, x, b), rows_rc), (rc, rc))
        xp = x.clone()
        mg1d.prolong_plain(xp, ec, oc)
        prolonged = (xp, shift_matvec.shift_matvec_plain(lev.offsets, lev.cw, lev.diag, xp, b))
        _equal(mg1d.prolong_residual(lev, x, ec, oc, b), prolonged)
        _equal(rows_pro, prolonged)


def _cycle_model(pre, r):
    """``Cycle.down``, the coarsest solve and ``Cycle.up`` in eager PyTorch:
    the fused pieces' plain versions in the sweeps' order, on the sweeps'
    buffers (the post-smoother's result written over its base ``xp``).
    Returns the result and the launches the kernels would make."""
    theta, coeffs = chebyshev_coefficients(PM.SMOOTH_DEGREE, ratio=PM.SMOOTH_RATIO)
    launches = 0

    def smooth(lev, rr, z, base):
        nonlocal launches
        rs, dvec, xa, xb = (torch.empty_like(rr) for _ in range(4))
        last = len(coeffs) == 1
        mg1d.cheb_first_plain(lev, rr, theta, rs, dvec, xa, *coeffs[0], z if last else None,
                              base if last else None)
        for t in range(1, len(coeffs)):
            end = t == len(coeffs) - 1
            shift_matvec.shift_cheb_plain(lev.offsets, lev.cw, lev.diag, lev.dis, rs, dvec, xa, xb,
                                          *coeffs[t], z if end else None, base if end else None)
            xa, xb = xb, xa
        launches += len(coeffs)

    rhs, xs = [r], []
    for l, lev in enumerate(pre.levels):
        xs.append(torch.empty_like(rhs[l]))
        smooth(lev, rhs[l], xs[l], None)
        rhs.append(mg1d.residual_restrict_plain(lev, xs[l], rhs[l]))
        launches += 1
    e = mg2d.coarse_solve_plain(pre.factor, rhs[-1])
    for l in reversed(range(len(pre.levels))):
        xp, res = mg1d.prolong_residual_plain(pre.levels[l], xs[l], e, pre.overcorrect, rhs[l])
        launches += 1
        smooth(pre.levels[l], res, xp, xp)
        e = xp
    return e, launches


@pytest.mark.parametrize("name", sorted(HIERARCHIES))
def test_cycle_model_equals_plain_vcycle(name):
    """The fused cycle's order of work gives the plain V-cycle's result to
    the bit, in 2 × ``sweep_launches`` = 6 launches a level."""
    plan, cw, diag, r = _inputs(*HIERARCHIES[name])
    pre = PM.Mg1dPreconditioner(plan, None, cw, diag, plain=True)
    assert pre.cycle is None and len(pre.levels) == len(LEVELS[name])
    z, launches = _cycle_model(pre, r)
    theta, coeffs = chebyshev_coefficients(PM.SMOOTH_DEGREE, ratio=PM.SMOOTH_RATIO)
    composed = mg1d.cycle_plain(pre.levels, theta, coeffs, pre.overcorrect,
                                lambda rb: mg2d.coarse_solve_plain(pre.factor, rb), r)
    _equal((z, composed), (pre(r), pre(r)))
    L = len(pre.levels)
    assert launches == 2 * mg1d.sweep_launches(L, PM.SMOOTH_DEGREE - 1) == 6 * L


def test_cycle_refuses_bad_hierarchies():
    coeffs = [(0.5, 0.25), (0.4, 0.2)]

    def level(m, C=2, dtype=torch.float64, offsets=None, device="cpu"):
        offsets = np.arange(1, C + 1, dtype=np.int32) if offsets is None else offsets
        return mg1d.Level(offsets, torch.ones((len(offsets), m), dtype=dtype, device=device),
                          torch.ones(m, dtype=dtype, device=device),
                          torch.ones(m, dtype=dtype, device=device))

    bad = {
        "no levels": [],
        "17 levels": [level(2**(17 - l)) for l in range(17)],
        "float32": [level(8, dtype=torch.float32)],
        "17 classes": [level(40, C=17)],
        "descending offsets": [level(8, offsets=np.array([1, -1], np.int32))],
        "rows that do not halve": [level(8), level(3)],
        "a level's weights of the wrong shape": [level(8)._replace(cw=torch.ones((2, 7),
                                                                              dtype=torch.float64))],
        "CPU levels": [level(8), level(4)],
    }
    for what, levels in bad.items():
        with pytest.raises(ValueError, match="mg1d"):
            mg1d.Cycle(levels, 2.0, coeffs, 1.8)
        assert what
    with pytest.raises(ValueError, match="mg1d"):
        mg1d.Cycle([level(8)], 2.0, [], 1.8)


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_mg1d_cycle_on_card():
    """K19d's fused pieces equal their plain versions bit for bit on every
    level of the 3×2000 and 5×301 hierarchies; a V-cycle makes 6 launches a
    smoothed level and one coarsest solve, equals the plain pieces composed
    around the same coarsest solve (``mg1d.cycle_plain``) bit for bit, and
    the plain preconditioner (its own Cholesky factor) at 1e-10·scale (the
    coarsest chain's conditioning, ``test_mg1d_vcycle_matches_reference``);
    two cycles on two streams give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    theta, coeffs = chebyshev_coefficients(PM.SMOOTH_DEGREE, ratio=PM.SMOOTH_RATIO)
    for name in ("3x2000", "5x301"):
        plan, cw, diag, r = _inputs(*HIERARCHIES[name], device=dev)
        got = PM.Mg1dPreconditioner(plan, None, cw, diag)
        want = PM.Mg1dPreconditioner(plan, None, cw, diag, plain=True)
        assert got.cycle is not None and want.cycle is None
        gen = torch.Generator(device=dev).manual_seed(5)
        for lev in want.levels:
            m = lev.diag.shape[0]
            x, b = (torch.randn(m, generator=gen, dtype=torch.float64, device=dev) for _ in range(2))
            ec = torch.randn((m + 1) // 2, generator=gen, dtype=torch.float64, device=dev)
            _equal((mg1d.residual_restrict(lev, x, b),), (mg1d.residual_restrict_plain(lev, x, b),))
            _equal(mg1d.prolong_residual(lev, x, ec, 1.8, b),
                   mg1d.prolong_residual_plain(lev, x, ec, 1.8, b))
            outs = [[torch.empty(m, dtype=torch.float64, device=dev) for _ in range(4)]
                    for _ in range(2)]
            for fn, o in zip((mg1d.cheb_first, mg1d.cheb_first_plain), outs):
                fn(lev, x, theta, *o[:3], *coeffs[0], o[3], b)
            _equal(outs[0], outs[1])
        mg1d.LAUNCHES.launches = mg2d.LAUNCHES.launches = krylov.LAUNCHES.launches = 0
        shift_matvec.shift_matvec.launches = 0
        z = got(r)
        L = len(plan.levels)
        assert (mg1d.LAUNCHES.launches, mg2d.LAUNCHES.launches) == (6 * L, 1)
        assert krylov.LAUNCHES.launches == shift_matvec.shift_matvec.launches == 0
        composed = mg1d.cycle_plain(got.levels, theta, coeffs, got.overcorrect,
                                    lambda rb: mg2d.coarse_solve(got.factor, rb), r)
        _equal((z,), (composed,))
        _close(z, want(r), 1e-10)
        streams = [torch.cuda.Stream(dev) for _ in range(2)]
        outs = []
        torch.cuda.synchronize(dev)
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(got(r))
        torch.cuda.synchronize(dev)
        _equal(outs, [z, z])
