// K19d: the 1-D pairwise-aggregation multigrid V-cycle of λ systems with a
// shift plan that the 2-D cycle does not take (skinny lattices).
//
// Replaces networks_fenicsx_tpu/solver.py:_mg_preconditioner on the host
// plan of _plan_mg: aggregating index pairs (i -> i / 2) maps the shift
// class d at parity p = i mod 2 to the coarse class D = floor((p + d) / 2);
// D = 0 vanishes.  Per solve the hierarchy is built once:
//   level0    extra = diag0 - (((0 + w_0) + w_1) + ...) over the classes
//             and the Jacobi scaling diag0^-1/2
//   coarsen   per coarse class D, acc = ((0 + w_c0[2I + p0]) + w_c1[2I + p1])
//             + ... over its (class, parity) contributions (the plan's
//             mapping tables, uploaded once per executor; 0 past the fine
//             end), extra' = extra[2I] + extra[2I + 1], diag' = extra' +
//             ((0 + acc_0) + acc_1) + ..., and diag'^-1/2
// and per V-cycle application, on each smoothed level of m rows with the
// level's classes (offsets d_c ascending, weights cw, diagonal, scaling
// s = diag^-1/2):
//   L y       (L y)_i = diag_i y_i - sum_c cw[c, i] y_{i + d_c}, 0 outside
//             [0, m), the classes in ascending offset (K18's order)
//   smoother  degree-3 Chebyshev-Jacobi (ops/krylov.py's recurrence on
//             [lam_max / 4, lam_max]): a start and two steps
//             dvec = c1 dvec + c2 (rs - s L (s x)), x' = x + dvec, and on
//             the last z = s x' (+ base)
//   restrict  pair sums r[2I] + r[2I + 1], even padding (+ 0.0 past the end)
//   prolong   x += overcorrect * e[i / 2]
// The cycle's launch path fuses what the plain level loop composes, each
// fusion computing what the composed pieces compute, in their order:
//   cheb_first        the smoother's start (rs = s r, x = dvec = rs (1 / theta))
//                     folded into its first step: a row forms the start at
//                     itself and at its C neighbours.  1 / theta is taken on
//                     the host, as for K19c (mg2d.cu): a tensor divided by a
//                     host scalar is that product on the card in PyTorch
//   residual_restrict each coarse row forms its <= 2 fine residuals b - L x
//                     and adds them; the fine residual is never stored
//   prolong_residual  each fine row forms x' = x + oc e[i / 2] at itself and
//                     at its neighbours, writes x' and b - L x' to two other
//                     buffers (no in-place race)
// so a smoothed level takes 6 launches: smoother (2), residual_restrict,
// prolong_residual, smoother (2).  nxfx_mg1d_down and nxfx_mg1d_up issue a
// whole cycle's descent and ascent around the coarsest solve (K19c's
// coarse_solve, mg2d.cu), each from one host call, on a per-stream argument
// struct (Mg1dCycle) holding the levels and the stream's scratch: a cycle
// is 3 host calls.  One thread owns one row; the kernels are -fmad=false and
// add in the plain versions' order, so the cycle is the composed plain
// cycle's to the bit.  Bound: device-memory bytes (a level's C + 2 rows of
// weights, diagonal and scaling and a few vectors, read per launch); on the
// skinny lattices (m <= 6,000) a launch's latency sets the pace.

#include <cuda_runtime.h>

constexpr int MG1D_MAX_LEVELS = 16;
constexpr int MG1D_MAX_STEPS = 8;
constexpr int MG1D_MAX_CLASSES = 16;

// One smoothed level of a 1-D V-cycle: its rows, its classes in ascending
// offset, its (C, m) class weights, diagonal and scaling, and the calling
// stream's scratch, each vector m doubles (a ctypes Structure of the same
// fields).
struct Mg1dLevelArgs {
    int m, C;
    int d[MG1D_MAX_CLASSES];
    const double* cw;
    const double* diag;
    const double* dis;
    double* r;     // the level's right-hand side (levels >= 1; level 0 takes the caller's)
    double* x;     // the pre-smoothed iterate
    double* xp;    // the prolonged iterate, then (levels >= 1) the level's result
    double* res;   // the post-smoothing residual
    double* rs;    // the smoother's s r, its dvec and its two iterates
    double* dvec;
    double* xa;
    double* xb;
};

// A V-cycle's smoothed levels on one stream: L levels, the smoother's start
// factor 1 / theta and its `steps` step coefficient pairs, the
// overcorrection, and the coarsest level's rows and right-hand side.
struct Mg1dCycle {
    int L, steps, m_bottom;
    double inv_theta, oc;
    double c1[MG1D_MAX_STEPS];
    double c2[MG1D_MAX_STEPS];
    double* r_bottom;
    Mg1dLevelArgs lv[MG1D_MAX_LEVELS];
};

namespace {

constexpr int THREADS = 256;

int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

__global__ void __launch_bounds__(THREADS) mg1d_level0_kernel(int m, int C, const double* cw,
                                                              const double* diag, double* extra,
                                                              double* dis)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= m) return;
    double sum = 0.0;
    for (int c = 0; c < C; ++c) sum = sum + cw[static_cast<size_t>(c) * m + i];
    extra[i] = diag[i] - sum;
    dis[i] = 1.0 / sqrt(diag[i]);
}

__global__ void __launch_bounds__(THREADS) mg1d_coarsen_kernel(
    int m, int mc, const double* cw_f, const double* extra_f, int Cc, const int* __restrict__ map_ptr,
    const int* __restrict__ map_ci, const int* __restrict__ map_p, double* cw_c, double* extra_c,
    double* diag_c, double* dis_c)
{
    const int I = blockIdx.x * THREADS + threadIdx.x;
    if (I >= mc) return;
    double sum = 0.0;
    for (int D = 0; D < Cc; ++D) {
        double acc = 0.0;
        for (int t = map_ptr[D]; t < map_ptr[D + 1]; ++t) {
            const int j = 2 * I + map_p[t];
            acc = acc + (j < m ? cw_f[static_cast<size_t>(map_ci[t]) * m + j] : 0.0);
        }
        cw_c[static_cast<size_t>(D) * mc + I] = acc;
        sum = sum + acc;
    }
    const double x = extra_f[2 * I] + (2 * I + 1 < m ? extra_f[2 * I + 1] : 0.0);
    const double d = x + sum;
    extra_c[I] = x;
    diag_c[I] = d;
    dis_c[I] = 1.0 / sqrt(d);
}

// the operator's input y at a row: x, s x, the smoother's start s (s r (1 / theta)),
// or the prolonged x + oc e[i / 2]
struct Plain {
    const double* x;
    __device__ double operator()(int j) const { return x[j]; }
};
struct Scaled {
    const double* s;
    const double* x;
    __device__ double operator()(int j) const { return s[j] * x[j]; }
};
struct StartScaled {
    const double* s;
    const double* r;
    double inv_theta;
    __device__ double operator()(int j) const { return s[j] * ((s[j] * r[j]) * inv_theta); }
};
struct Prolonged {
    const double* x;
    const double* ec;
    double oc;
    __device__ double operator()(int j) const { return x[j] + oc * ec[j / 2]; }
};

// (L y)_i of the level: diag_i y_i, then each class's term in ascending offset
template <class Y>
__device__ __forceinline__ double level_apply(const Mg1dLevelArgs& v, int i, const Y& y)
{
    const int m = v.m;
    double o = v.diag[i] * y(i);
#pragma unroll
    for (int c = 0; c < MG1D_MAX_CLASSES; ++c) {  // unrolled: the offsets stay kernel parameters
        if (c >= v.C) break;
        const long long j = static_cast<long long>(i) + v.d[c];
        const double yj = (j >= 0 && j < m) ? y(static_cast<int>(j)) : 0.0;
        o = o - v.cw[static_cast<size_t>(c) * m + i] * yj;
    }
    return o;
}

// one smoother step (K18's shift_cheb on the level): dvec in place, x_out,
// and with z its result s x_out (+ base; z may be base)
__global__ void __launch_bounds__(THREADS) mg1d_cheb_kernel(Mg1dLevelArgs v, const double* rs, double* dvec,
                                                            const double* x_in, double* x_out, double c1,
                                                            double c2, double* z, const double* base)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= v.m) return;
    const double* s = v.dis;
    const double mv = s[i] * level_apply(v, i, Scaled{s, x_in});
    const double dv = c1 * dvec[i] + c2 * (rs[i] - mv);
    dvec[i] = dv;
    const double xn = x_in[i] + dv;
    x_out[i] = xn;
    if (z != nullptr) z[i] = base != nullptr ? base[i] + s[i] * xn : s[i] * xn;
}

// the smoother's start and first step: rs = s r, dvec = x = rs (1 / theta),
// then the step with (c1, c2); x_out, and with z its result s x (+ base)
__global__ void __launch_bounds__(THREADS) mg1d_cheb_first_kernel(Mg1dLevelArgs v, const double* r,
                                                                  double inv_theta, double c1, double c2,
                                                                  double* rs, double* dvec, double* x_out,
                                                                  double* z, const double* base)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= v.m) return;
    const double* s = v.dis;
    const double mv = s[i] * level_apply(v, i, StartScaled{s, r, inv_theta});
    const double rsv = s[i] * r[i];
    const double dv0 = rsv * inv_theta;
    const double dv = c1 * dv0 + c2 * (rsv - mv);
    rs[i] = rsv;
    dvec[i] = dv;
    const double xn = dv0 + dv;
    x_out[i] = xn;
    if (z != nullptr) z[i] = base != nullptr ? base[i] + s[i] * xn : s[i] * xn;
}

// b - L x at fine row i, 0 in the even padding
__device__ __forceinline__ double fine_residual(const Mg1dLevelArgs& v, int i, const double* x,
                                                const double* b)
{
    if (i >= v.m) return 0.0;
    return b[i] - level_apply(v, i, Plain{x});
}

__global__ void __launch_bounds__(THREADS) mg1d_residual_restrict_kernel(Mg1dLevelArgs v, const double* x,
                                                                         const double* b, int mc, double* rc)
{
    const int I = blockIdx.x * THREADS + threadIdx.x;
    if (I < mc) rc[I] = fine_residual(v, 2 * I, x, b) + fine_residual(v, 2 * I + 1, x, b);
}

__global__ void __launch_bounds__(THREADS) mg1d_prolong_residual_kernel(Mg1dLevelArgs v, const double* x,
                                                                        const double* ec, double oc,
                                                                        const double* b, double* xp,
                                                                        double* res)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= v.m) return;
    const Prolonged y{x, ec, oc};
    xp[i] = y(i);
    res[i] = b[i] - level_apply(v, i, y);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

bool level_ok(const Mg1dLevelArgs& v)
{
    return v.m > 0 && v.m < (1 << 30) && v.C >= 0 && v.C <= MG1D_MAX_CLASSES;
}

int launch_cheb(const Mg1dLevelArgs& v, const double* rs, double* dvec, const double* x_in, double* x_out,
                double c1, double c2, double* z, const double* base, cudaStream_t stream)
{
    mg1d_cheb_kernel<<<blocks_of(v.m), THREADS, 0, stream>>>(v, rs, dvec, x_in, x_out, c1, c2, z, base);
    return last_error();
}

int launch_cheb_first(const Mg1dLevelArgs& v, const double* r, double inv_theta, double c1, double c2,
                      double* rs, double* dvec, double* x_out, double* z, const double* base,
                      cudaStream_t stream)
{
    mg1d_cheb_first_kernel<<<blocks_of(v.m), THREADS, 0, stream>>>(v, r, inv_theta, c1, c2, rs, dvec, x_out,
                                                                    z, base);
    return last_error();
}

int launch_residual_restrict(const Mg1dLevelArgs& v, const double* x, const double* b, double* rc,
                             cudaStream_t stream)
{
    const int mc = (v.m + 1) / 2;
    mg1d_residual_restrict_kernel<<<blocks_of(mc), THREADS, 0, stream>>>(v, x, b, mc, rc);
    return last_error();
}

int launch_prolong_residual(const Mg1dLevelArgs& v, const double* x, const double* ec, double oc,
                            const double* b, double* xp, double* res, cudaStream_t stream)
{
    mg1d_prolong_residual_kernel<<<blocks_of(v.m), THREADS, 0, stream>>>(v, x, ec, oc, b, xp, res);
    return last_error();
}

// level l's smoother on r: the folded start and first step, then the other
// steps; the last writes z (= s x, + base when given)
int smooth(const Mg1dCycle* a, int l, const double* r, double* z, const double* base, cudaStream_t stream)
{
    const Mg1dLevelArgs& v = a->lv[l];
    const bool last = a->steps == 1;
    int code = launch_cheb_first(v, r, a->inv_theta, a->c1[0], a->c2[0], v.rs, v.dvec, v.xa,
                                 last ? z : nullptr, last ? base : nullptr, stream);
    double* x_in = v.xa;
    double* x_out = v.xb;
    for (int t = 1; t < a->steps && code == 0; ++t) {
        const bool end = t == a->steps - 1;
        code = launch_cheb(v, v.rs, v.dvec, x_in, x_out, a->c1[t], a->c2[t], end ? z : nullptr,
                           end ? base : nullptr, stream);
        double* swap = x_in;
        x_in = x_out;
        x_out = swap;
    }
    return code;
}

bool cycle_ok(const Mg1dCycle* a)
{
    if (a->L < 1 || a->L > MG1D_MAX_LEVELS || a->steps < 1 || a->steps > MG1D_MAX_STEPS) return false;
    for (int l = 0; l < a->L; ++l)
        if (!level_ok(a->lv[l])) return false;
    return true;
}

}  // namespace

extern "C" int nxfx_mg1d_level0(int m, int C, const double* cw, const double* diag, double* extra,
                                double* dis, cudaStream_t stream)
{
    if (m <= 0) return 0;
    mg1d_level0_kernel<<<blocks_of(m), THREADS, 0, stream>>>(m, C, cw, diag, extra, dis);
    return last_error();
}

extern "C" int nxfx_mg1d_coarsen(int m, int mc, const double* cw_f, const double* extra_f, int Cc,
                                 const int* map_ptr, const int* map_ci, const int* map_p, double* cw_c,
                                 double* extra_c, double* diag_c, double* dis_c, cudaStream_t stream)
{
    if (mc <= 0) return 0;
    mg1d_coarsen_kernel<<<blocks_of(mc), THREADS, 0, stream>>>(m, mc, cw_f, extra_f, Cc, map_ptr, map_ci,
                                                               map_p, cw_c, extra_c, diag_c, dis_c);
    return last_error();
}

// the smoother's start folded into its first step (inv_theta = 1 / theta);
// z and base may be null
extern "C" int nxfx_mg1d_cheb_first(const Mg1dLevelArgs* v, const double* r, double inv_theta, double c1,
                                    double c2, double* rs, double* dvec, double* x_out, double* z,
                                    const double* base, cudaStream_t stream)
{
    if (!level_ok(*v)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_cheb_first(*v, r, inv_theta, c1, c2, rs, dvec, x_out, z, base, stream);
}

// rc ((m + 1) / 2) = the pair sums of b - L x
extern "C" int nxfx_mg1d_residual_restrict(const Mg1dLevelArgs* v, const double* x, const double* b,
                                           double* rc, cudaStream_t stream)
{
    if (!level_ok(*v)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_residual_restrict(*v, x, b, rc, stream);
}

// xp = x + oc e[i / 2], res = b - L xp
extern "C" int nxfx_mg1d_prolong_residual(const Mg1dLevelArgs* v, const double* x, const double* ec,
                                          double oc, const double* b, double* xp, double* res,
                                          cudaStream_t stream)
{
    if (!level_ok(*v)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_prolong_residual(*v, x, ec, oc, b, xp, res, stream);
}

// A V-cycle's descent from the caller's r0 (L (steps + 1) launches): per
// level the smoother into x, then the restricted residual into the next
// level's r (the coarsest level's r_bottom)
extern "C" int nxfx_mg1d_down(const Mg1dCycle* a, const double* r0, cudaStream_t stream)
{
    if (!cycle_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
    for (int l = 0; l < a->L; ++l) {
        const Mg1dLevelArgs& v = a->lv[l];
        const double* r = l == 0 ? r0 : v.r;
        int code = smooth(a, l, r, v.x, nullptr, stream);
        if (code != 0) return code;
        code = launch_residual_restrict(v, v.x, r, l + 1 < a->L ? a->lv[l + 1].r : a->r_bottom, stream);
        if (code != 0) return code;
    }
    return 0;
}

// Its ascent from the coarsest correction e_bottom (L (steps + 1) launches):
// per level, deepest first, the prolonged x and its residual, then the
// smoother on that residual added to the prolonged x, into xp (level 0:
// into out0)
extern "C" int nxfx_mg1d_up(const Mg1dCycle* a, const double* r0, const double* e_bottom, double* out0,
                            cudaStream_t stream)
{
    if (!cycle_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
    for (int l = a->L - 1; l >= 0; --l) {
        const Mg1dLevelArgs& v = a->lv[l];
        int code = launch_prolong_residual(v, v.x, l + 1 < a->L ? a->lv[l + 1].xp : e_bottom, a->oc,
                                           l == 0 ? r0 : v.r, v.xp, v.res, stream);
        if (code != 0) return code;
        code = smooth(a, l, v.res, l == 0 ? out0 : v.xp, v.xp, stream);
        if (code != 0) return code;
    }
    return 0;
}
