// K19c: the 2-D aggregation multigrid V-cycle of lattice λ systems, and
// the coarsest dense solve it shares with the 1-D cycle (K19d).
//
// Replaces networks_fenicsx_tpu/solver.py:_mg2d_preconditioner.  A level is
// an ny x nx grid (row-major, the λ rows of the lattice) holding seven
// fields, each ny nx doubles: the direction weights E (+1), W (-1), S (+nx),
// N (-nx), the boundary excess `extra`, the diagonal (padded cells 1.0) and
// its Jacobi scaling diag^-1/2.  Per solve the hierarchy is built once:
//   level0    the fields from the class weights and the diagonal
//             (extra = diag0 - (((E + W) + S) + N), diag = extra + E + W + S + N)
//   coarsen   2 x 2 aggregation with even padding: the crossings out of the
//             block survive (E' = E[2I, 2J+1] + E[2I+1, 2J+1], ...), extra
//             is the block sum ((x00 + x01) + x10) + x11
//   coarse    the coarsest level's banded matrix, dense, and its Cholesky
//             factor (tiled_cholesky.cuh, the port's K11 factor)
// and per V-cycle application:
//   stencil   the 5-point weighted stencil with zero-padded shifts, as L x or
//             b - L x, and one fused Chebyshev-Jacobi smoother step
//             (degree 3 on [lam_max / 4, lam_max]; ops/krylov.py's recurrence)
//   solve     the two triangular solves on the coarsest factor.
// Every entry's sum is taken in the plain version's order.
//
// The V-cycle's launch path fuses what the plain level loop composes (2 x 2
// block sums of a residual with even padding, and x += overcorrect *
// e[i / 2, j / 2], cropped), each fusion computing what the composed pieces
// compute, in their order:
//   cheb_first        the smoother's start (rs = s r, x = dvec = rs (1 / theta))
//                     folded into its first step: a cell forms the start at
//                     its four neighbours (a one-cell halo of r).  1 / theta
//                     is taken on the host: a tensor divided by a host scalar
//                     is that product on the card in PyTorch, so the fold
//                     equals the composed plain versions to the bit
//   residual_restrict each coarse cell forms its <= 4 fine residuals b - L x
//                     and adds them ((x00 + x01) + x10) + x11; the fine
//                     residual is never stored
//   prolong_residual  each fine cell forms x' = x + oc e[i / 2, j / 2] at itself
//                     and its neighbours, writes x' and b - L x' to two other
//                     buffers (no in-place race)
// so a smoothed level takes 6 launches: smoother (2), residual_restrict,
// prolong_residual, smoother (2).  nxfx_mg2d_down and nxfx_mg2d_up issue a
// whole cycle's descent and ascent around the coarsest solve, each from one
// host call, on a per-stream argument struct (Mg2dCycle) holding the
// levels and the stream's scratch.  Bound:
// device-memory bytes (seven fields and a few vectors per level), except the
// coarsest factor, m^3 / 3 operations of a matrix of order m <= 4,096
// (256 at the 512^2 lattice).

#include <cuda_runtime.h>

#include "tiled_cholesky.cuh"

constexpr int MG_MAX_LEVELS = 16;
constexpr int MG_MAX_STEPS = 8;

// One smoothed level of a V-cycle and the calling stream's scratch, each
// vector ny nx doubles (a ctypes Structure of the same fields).
struct Mg2dLevelArgs {
    int ny, nx;
    const double* lev;
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
// overcorrection, and the coarsest grid's shape and right-hand side.
struct Mg2dCycle {
    int L, steps, ny_bottom, nx_bottom;
    double inv_theta, oc;
    double c1[MG_MAX_STEPS];
    double c2[MG_MAX_STEPS];
    double* r_bottom;
    Mg2dLevelArgs lv[MG_MAX_LEVELS];
};

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CLASSES = 16;
enum Field { FE = 0, FW = 1, FS = 2, FN = 3, FX = 4, FD = 5, FI = 6 };

struct Offsets {
    int d[MAX_CLASSES];
};

int blocks_of(long long n) { return static_cast<int>((n + THREADS - 1) / THREADS); }

__device__ __forceinline__ double at_or_zero(const double* f, int ny, int nx, int y, int x)
{
    return (y < ny && x < nx) ? f[static_cast<size_t>(y) * nx + x] : 0.0;
}

__device__ __forceinline__ void write_diag(double* lev, size_t m, size_t i, double extra, double e,
                                           double w, double s, double n)
{
    double d = (((extra + e) + w) + s) + n;
    d = d > 0.0 ? d : 1.0;
    lev[FE * m + i] = e;
    lev[FW * m + i] = w;
    lev[FS * m + i] = s;
    lev[FN * m + i] = n;
    lev[FX * m + i] = extra;
    lev[FD * m + i] = d;
    lev[FI * m + i] = 1.0 / sqrt(d);
}

// class index of each direction, -1 when the class is absent
__global__ void __launch_bounds__(THREADS) mg2d_level0_kernel(int m, const double* cw, int ce, int cwi,
                                                              int cs, int cn, const double* diag0,
                                                              double* lev)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= m) return;
    const size_t mm = m;
    const double e = ce >= 0 ? cw[ce * mm + i] : 0.0;
    const double w = cwi >= 0 ? cw[cwi * mm + i] : 0.0;
    const double s = cs >= 0 ? cw[cs * mm + i] : 0.0;
    const double n = cn >= 0 ? cw[cn * mm + i] : 0.0;
    const double extra = diag0[i] - (((e + w) + s) + n);
    write_diag(lev, mm, i, extra, e, w, s, n);
}

__global__ void __launch_bounds__(THREADS) mg2d_coarsen_kernel(int nyf, int nxf, const double* fine,
                                                               int nyc, int nxc, double* coarse)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= nyc * nxc) return;
    const int I = i / nxc, J = i % nxc;
    const int y0 = 2 * I, y1 = 2 * I + 1, x0 = 2 * J, x1 = 2 * J + 1;
    const size_t mf = static_cast<size_t>(nyf) * nxf;
    const double* fe = fine + FE * mf;
    const double* fw = fine + FW * mf;
    const double* fs = fine + FS * mf;
    const double* fn = fine + FN * mf;
    const double* fx = fine + FX * mf;
    const double e = at_or_zero(fe, nyf, nxf, y0, x1) + at_or_zero(fe, nyf, nxf, y1, x1);
    const double w = at_or_zero(fw, nyf, nxf, y0, x0) + at_or_zero(fw, nyf, nxf, y1, x0);
    const double s = at_or_zero(fs, nyf, nxf, y1, x0) + at_or_zero(fs, nyf, nxf, y1, x1);
    const double n = at_or_zero(fn, nyf, nxf, y0, x0) + at_or_zero(fn, nyf, nxf, y0, x1);
    const double extra = ((at_or_zero(fx, nyf, nxf, y0, x0) + at_or_zero(fx, nyf, nxf, y0, x1))
                          + at_or_zero(fx, nyf, nxf, y1, x0)) + at_or_zero(fx, nyf, nxf, y1, x1);
    write_diag(coarse, static_cast<size_t>(nyc) * nxc, i, extra, e, w, s, n);
}

// the stencil's input y at a cell: x, s x, the smoother's start s (s r (1 / theta)),
// or the prolonged x + oc e[i / 2, j / 2]
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
    int nx, nxc;
    double oc;
    __device__ double operator()(int j) const
    {
        return x[j] + oc * ec[static_cast<size_t>(j / nx / 2) * nxc + (j % nx) / 2];
    }
};

// (L y)_i of the level's stencil, zero-padded shifts
template <class Y>
__device__ __forceinline__ double stencil_of(int i, int ny, int nx, const double* lev, const Y& y)
{
    const size_t m = static_cast<size_t>(ny) * nx;
    const int r = i / nx, c = i % nx;
    const double xi = y(i);
    const double xe = c + 1 < nx ? y(i + 1) : 0.0;
    const double xw = c > 0 ? y(i - 1) : 0.0;
    const double xs = r + 1 < ny ? y(i + nx) : 0.0;
    const double xn = r > 0 ? y(i - nx) : 0.0;
    double o = lev[FD * m + i] * xi;
    o = o - lev[FE * m + i] * xe;
    o = o - lev[FW * m + i] * xw;
    o = o - lev[FS * m + i] * xs;
    o = o - lev[FN * m + i] * xn;
    return o;
}

__global__ void __launch_bounds__(THREADS) mg2d_stencil_kernel(int ny, int nx, const double* lev,
                                                               const double* x, const double* b,
                                                               double* out)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= ny * nx) return;
    const double o = stencil_of(i, ny, nx, lev, Plain{x});
    out[i] = b != nullptr ? b[i] - o : o;
}

__global__ void __launch_bounds__(THREADS) mg2d_cheb_kernel(int ny, int nx, const double* lev,
                                                            const double* rs, double* dvec,
                                                            const double* x_in, double* x_out, double c1,
                                                            double c2, double* z, const double* base)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= ny * nx) return;
    const double* s = lev + FI * static_cast<size_t>(ny) * nx;
    const double mv = s[i] * stencil_of(i, ny, nx, lev, Scaled{s, x_in});
    const double dv = c1 * dvec[i] + c2 * (rs[i] - mv);
    dvec[i] = dv;
    const double xn = x_in[i] + dv;
    x_out[i] = xn;
    if (z != nullptr) z[i] = base != nullptr ? base[i] + s[i] * xn : s[i] * xn;
}

// the smoother's start and first step: rs = s r, dvec = x = rs (1 / theta),
// then the step with (c1, c2); x_out, and with z its result s x (+ base)
__global__ void __launch_bounds__(THREADS) mg2d_cheb_first_kernel(int ny, int nx, const double* lev,
                                                                  const double* r, double inv_theta,
                                                                  double c1, double c2, double* rs,
                                                                  double* dvec, double* x_out,
                                                                  double* z, const double* base)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= ny * nx) return;
    const double* s = lev + FI * static_cast<size_t>(ny) * nx;
    const double mv = s[i] * stencil_of(i, ny, nx, lev, StartScaled{s, r, inv_theta});
    const double rsv = s[i] * r[i];
    const double dv0 = rsv * inv_theta;
    const double dv = c1 * dv0 + c2 * (rsv - mv);
    rs[i] = rsv;
    dvec[i] = dv;
    const double xn = dv0 + dv;
    x_out[i] = xn;
    if (z != nullptr) z[i] = base != nullptr ? base[i] + s[i] * xn : s[i] * xn;
}

// b - L x at fine cell (y, c), 0 in the even padding
__device__ __forceinline__ double fine_residual(int y, int c, int ny, int nx, const double* lev,
                                                const double* x, const double* b)
{
    if (y >= ny || c >= nx) return 0.0;
    const int i = y * nx + c;
    return b[i] - stencil_of(i, ny, nx, lev, Plain{x});
}

__global__ void __launch_bounds__(THREADS) mg2d_residual_restrict_kernel(int nyf, int nxf, const double* lev,
                                                                         const double* x, const double* b,
                                                                         int nyc, int nxc, double* rc)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= nyc * nxc) return;
    const int y = 2 * (i / nxc), c = 2 * (i % nxc);
    rc[i] = ((fine_residual(y, c, nyf, nxf, lev, x, b) + fine_residual(y, c + 1, nyf, nxf, lev, x, b))
             + fine_residual(y + 1, c, nyf, nxf, lev, x, b)) + fine_residual(y + 1, c + 1, nyf, nxf, lev, x, b);
}

__global__ void __launch_bounds__(THREADS) mg2d_prolong_residual_kernel(int ny, int nx, const double* lev,
                                                                        const double* x, int nxc,
                                                                        const double* ec, double oc,
                                                                        const double* b, double* xp,
                                                                        double* res)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= ny * nx) return;
    const Prolonged y{x, ec, nx, nxc, oc};
    xp[i] = y(i);
    res[i] = b[i] - stencil_of(i, ny, nx, lev, y);
}

// A = diag(diag) - sum_c band(cw[c], d_c), dense m x m row-major:
// A[i, i + d_c] = -cw[c, i]
__global__ void __launch_bounds__(THREADS) mg_assemble_kernel(int m, int C, Offsets off, const double* cw,
                                                              const double* diag, double* A)
{
    const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    if (t >= static_cast<long long>(m) * m) return;
    const int i = static_cast<int>(t / m), j = static_cast<int>(t % m);
    double v = i == j ? diag[i] : 0.0;
    for (int c = 0; c < C; ++c)
        if (j - i == off.d[c]) v = v - cw[static_cast<size_t>(c) * m + i];
    A[t] = v;
}

__global__ void __launch_bounds__(THREADS) mg_copy_kernel(int m, const double* src, double* dst)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < m) dst[i] = src[i];
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

int launch_cheb(int ny, int nx, const double* lev, const double* rs, double* dvec, const double* x_in,
                double* x_out, double c1, double c2, double* z, const double* base, cudaStream_t stream)
{
    mg2d_cheb_kernel<<<blocks_of(static_cast<long long>(ny) * nx), THREADS, 0, stream>>>(
        ny, nx, lev, rs, dvec, x_in, x_out, c1, c2, z, base);
    return last_error();
}

int launch_cheb_first(int ny, int nx, const double* lev, const double* r, double inv_theta, double c1,
                      double c2, double* rs, double* dvec, double* x_out, double* z, const double* base,
                      cudaStream_t stream)
{
    mg2d_cheb_first_kernel<<<blocks_of(static_cast<long long>(ny) * nx), THREADS, 0, stream>>>(
        ny, nx, lev, r, inv_theta, c1, c2, rs, dvec, x_out, z, base);
    return last_error();
}

int launch_residual_restrict(int nyf, int nxf, const double* lev, const double* x, const double* b, int nyc,
                             int nxc, double* rc, cudaStream_t stream)
{
    mg2d_residual_restrict_kernel<<<blocks_of(static_cast<long long>(nyc) * nxc), THREADS, 0, stream>>>(
        nyf, nxf, lev, x, b, nyc, nxc, rc);
    return last_error();
}

int launch_prolong_residual(int ny, int nx, const double* lev, const double* x, int nxc, const double* ec,
                            double oc, const double* b, double* xp, double* res, cudaStream_t stream)
{
    mg2d_prolong_residual_kernel<<<blocks_of(static_cast<long long>(ny) * nx), THREADS, 0, stream>>>(
        ny, nx, lev, x, nxc, ec, oc, b, xp, res);
    return last_error();
}

// level l's smoother on r: the folded start and first step, then the other
// steps; the last writes z (= s x, + base when given)
int smooth(const Mg2dCycle* a, int l, const double* r, double* z, const double* base, cudaStream_t stream)
{
    const Mg2dLevelArgs& v = a->lv[l];
    const bool last = a->steps == 1;
    int code = launch_cheb_first(v.ny, v.nx, v.lev, r, a->inv_theta, a->c1[0], a->c2[0], v.rs, v.dvec, v.xa,
                                 last ? z : nullptr, last ? base : nullptr, stream);
    double* x_in = v.xa;
    double* x_out = v.xb;
    for (int t = 1; t < a->steps && code == 0; ++t) {
        const bool end = t == a->steps - 1;
        code = launch_cheb(v.ny, v.nx, v.lev, v.rs, v.dvec, x_in, x_out, a->c1[t], a->c2[t],
                           end ? z : nullptr, end ? base : nullptr, stream);
        double* swap = x_in;
        x_in = x_out;
        x_out = swap;
    }
    return code;
}

bool cycle_ok(const Mg2dCycle* a)
{
    return a->L >= 1 && a->L <= MG_MAX_LEVELS && a->steps >= 1 && a->steps <= MG_MAX_STEPS;
}

}  // namespace

// class indices of the E, W, S, N directions (-1 when absent)
extern "C" int nxfx_mg2d_level0(int m, const double* cw, int ce, int cwi, int cs, int cn,
                                const double* diag0, double* lev, cudaStream_t stream)
{
    if (m <= 0) return 0;
    mg2d_level0_kernel<<<blocks_of(m), THREADS, 0, stream>>>(m, cw, ce, cwi, cs, cn, diag0, lev);
    return last_error();
}

extern "C" int nxfx_mg2d_coarsen(int nyf, int nxf, const double* fine, int nyc, int nxc, double* coarse,
                                 cudaStream_t stream)
{
    mg2d_coarsen_kernel<<<blocks_of(static_cast<long long>(nyc) * nxc), THREADS, 0, stream>>>(
        nyf, nxf, fine, nyc, nxc, coarse);
    return last_error();
}

// out = L x, or b - L x when b is given
extern "C" int nxfx_mg2d_stencil(int ny, int nx, const double* lev, const double* x, const double* b,
                                 double* out, cudaStream_t stream)
{
    mg2d_stencil_kernel<<<blocks_of(static_cast<long long>(ny) * nx), THREADS, 0, stream>>>(
        ny, nx, lev, x, b, out);
    return last_error();
}

// the smoother's start folded into its first step (inv_theta = 1 / theta);
// z and base may be null
extern "C" int nxfx_mg2d_cheb_first(int ny, int nx, const double* lev, const double* r, double inv_theta,
                                    double c1, double c2, double* rs, double* dvec, double* x_out, double* z,
                                    const double* base, cudaStream_t stream)
{
    return launch_cheb_first(ny, nx, lev, r, inv_theta, c1, c2, rs, dvec, x_out, z, base, stream);
}

// rc = the 2 x 2 block sums of b - L x
extern "C" int nxfx_mg2d_residual_restrict(int nyf, int nxf, const double* lev, const double* x,
                                           const double* b, int nyc, int nxc, double* rc, cudaStream_t stream)
{
    return launch_residual_restrict(nyf, nxf, lev, x, b, nyc, nxc, rc, stream);
}

// xp = x + oc e[i / 2, j / 2], res = b - L xp
extern "C" int nxfx_mg2d_prolong_residual(int ny, int nx, const double* lev, const double* x, int nxc,
                                          const double* ec, double oc, const double* b, double* xp,
                                          double* res, cudaStream_t stream)
{
    return launch_prolong_residual(ny, nx, lev, x, nxc, ec, oc, b, xp, res, stream);
}

// A V-cycle's descent from the caller's r0 (L (steps + 1) launches): per
// level the smoother into x, then the restricted residual into the next
// level's r (the coarsest level's r_bottom)
extern "C" int nxfx_mg2d_down(const Mg2dCycle* a, const double* r0, cudaStream_t stream)
{
    if (!cycle_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
    for (int l = 0; l < a->L; ++l) {
        const Mg2dLevelArgs& v = a->lv[l];
        const double* r = l == 0 ? r0 : v.r;
        int code = smooth(a, l, r, v.x, nullptr, stream);
        if (code != 0) return code;
        const bool inner = l + 1 < a->L;
        code = launch_residual_restrict(v.ny, v.nx, v.lev, v.x, r, inner ? a->lv[l + 1].ny : a->ny_bottom,
                                        inner ? a->lv[l + 1].nx : a->nx_bottom,
                                        inner ? a->lv[l + 1].r : a->r_bottom, stream);
        if (code != 0) return code;
    }
    return 0;
}

// Its ascent from the coarsest correction e_bottom (L (steps + 1) launches):
// per level, deepest first, the prolonged x and its residual, then the
// smoother on that residual added to the prolonged x, into xp (level 0:
// into out0)
extern "C" int nxfx_mg2d_up(const Mg2dCycle* a, const double* r0, const double* e_bottom, double* out0,
                            cudaStream_t stream)
{
    if (!cycle_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
    for (int l = a->L - 1; l >= 0; --l) {
        const Mg2dLevelArgs& v = a->lv[l];
        const bool inner = l + 1 < a->L;
        int code = launch_prolong_residual(v.ny, v.nx, v.lev, v.x, inner ? a->lv[l + 1].nx : a->nx_bottom,
                                           inner ? a->lv[l + 1].xp : e_bottom, a->oc, l == 0 ? r0 : v.r,
                                           v.xp, v.res, stream);
        if (code != 0) return code;
        code = smooth(a, l, v.res, l == 0 ? out0 : v.xp, v.xp, stream);
        if (code != 0) return code;
    }
    return 0;
}

// the coarsest matrix from C classes (host offsets, (C, m) weights) and its
// diagonal, factored in place: A's lower triangle becomes the Cholesky
// factor with its diagonal tiles' inverses (tiled_cholesky)
extern "C" int nxfx_mg_coarse_factor(int m, int C, const int* offsets_host, const double* cw,
                                     const double* diag, double* A, cudaStream_t stream)
{
    if (m <= 0 || C < 0 || C > MAX_CLASSES || m > 8192) return static_cast<int>(cudaErrorInvalidValue);
    Offsets off{};
    for (int c = 0; c < C; ++c) off.d[c] = offsets_host[c];
    mg_assemble_kernel<<<blocks_of(static_cast<long long>(m) * m), THREADS, 0, stream>>>(m, C, off, cw,
                                                                                          diag, A);
    const int code = last_error();
    if (code != 0) return code;
    return static_cast<int>(tiled_cholesky(A, m, m, m, stream));
}

// x = A^-1 r on the factor of nxfx_mg_coarse_factor; v and y are workspaces
extern "C" int nxfx_mg_coarse_solve(int m, const double* A, const double* r, double* v, double* y, double* x,
                                    cudaStream_t stream)
{
    if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
    mg_copy_kernel<<<blocks_of(m), THREADS, 0, stream>>>(m, r, v);
    int code = last_error();
    if (code != 0) return code;
    code = static_cast<int>(tiled_solve(A, m, m, v, y, false, stream));
    if (code != 0) return code;
    return static_cast<int>(tiled_solve(A, m, m, y, x, true, stream));
}
