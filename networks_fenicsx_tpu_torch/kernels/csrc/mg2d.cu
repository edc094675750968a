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
//   restrict  2 x 2 block sums of a residual, even padding
//   prolong   x += overcorrect * e[i / 2, j / 2], cropped
//   solve     the two triangular solves on the coarsest factor.
// Every entry's sum is taken in the plain version's order.  Bound:
// device-memory bytes (seven fields and a few vectors per level), except the
// coarsest factor, m^3 / 3 operations of a matrix of order m <= 4,096
// (256 at the 512^2 lattice).

#include <cuda_runtime.h>

#include "tiled_cholesky.cuh"

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

// (L y)_i of the level's stencil, y = x or y = s x
__device__ __forceinline__ double stencil_row(int i, int ny, int nx, const double* lev, const double* x,
                                              const double* s)
{
    const size_t m = static_cast<size_t>(ny) * nx;
    const int y = i / nx, c = i % nx;
    const double xi = s != nullptr ? s[i] * x[i] : x[i];
    const double xe = c + 1 < nx ? (s != nullptr ? s[i + 1] * x[i + 1] : x[i + 1]) : 0.0;
    const double xw = c > 0 ? (s != nullptr ? s[i - 1] * x[i - 1] : x[i - 1]) : 0.0;
    const double xs = y + 1 < ny ? (s != nullptr ? s[i + nx] * x[i + nx] : x[i + nx]) : 0.0;
    const double xn = y > 0 ? (s != nullptr ? s[i - nx] * x[i - nx] : x[i - nx]) : 0.0;
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
    const double o = stencil_row(i, ny, nx, lev, x, nullptr);
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
    const double mv = s[i] * stencil_row(i, ny, nx, lev, x_in, s);
    const double dv = c1 * dvec[i] + c2 * (rs[i] - mv);
    dvec[i] = dv;
    const double xn = x_in[i] + dv;
    x_out[i] = xn;
    if (z != nullptr) z[i] = base != nullptr ? base[i] + s[i] * xn : s[i] * xn;
}

__global__ void __launch_bounds__(THREADS) mg2d_restrict_kernel(int nyf, int nxf, const double* res,
                                                                int nyc, int nxc, double* rc)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= nyc * nxc) return;
    const int I = i / nxc, J = i % nxc;
    rc[i] = ((at_or_zero(res, nyf, nxf, 2 * I, 2 * J) + at_or_zero(res, nyf, nxf, 2 * I, 2 * J + 1))
             + at_or_zero(res, nyf, nxf, 2 * I + 1, 2 * J)) + at_or_zero(res, nyf, nxf, 2 * I + 1, 2 * J + 1);
}

__global__ void __launch_bounds__(THREADS) mg2d_prolong_kernel(int nyf, int nxf, double* x, int nxc,
                                                               const double* ec, double oc)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= nyf * nxf) return;
    const int y = i / nxf, c = i % nxf;
    x[i] = x[i] + oc * ec[static_cast<size_t>(y / 2) * nxc + c / 2];
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

// one smoother step; z and base may be null
extern "C" int nxfx_mg2d_cheb(int ny, int nx, const double* lev, const double* rs, double* dvec,
                              const double* x_in, double* x_out, double c1, double c2, double* z,
                              const double* base, cudaStream_t stream)
{
    mg2d_cheb_kernel<<<blocks_of(static_cast<long long>(ny) * nx), THREADS, 0, stream>>>(
        ny, nx, lev, rs, dvec, x_in, x_out, c1, c2, z, base);
    return last_error();
}

extern "C" int nxfx_mg2d_restrict(int nyf, int nxf, const double* res, int nyc, int nxc, double* rc,
                                  cudaStream_t stream)
{
    mg2d_restrict_kernel<<<blocks_of(static_cast<long long>(nyc) * nxc), THREADS, 0, stream>>>(
        nyf, nxf, res, nyc, nxc, rc);
    return last_error();
}

extern "C" int nxfx_mg2d_prolong(int nyf, int nxf, double* x, int nxc, const double* ec, double oc,
                                 cudaStream_t stream)
{
    mg2d_prolong_kernel<<<blocks_of(static_cast<long long>(nyf) * nxf), THREADS, 0, stream>>>(
        nyf, nxf, x, nxc, ec, oc);
    return last_error();
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
