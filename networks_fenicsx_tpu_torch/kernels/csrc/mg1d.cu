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
// and per application:
//   restrict  pair sums r[2I] + r[2I + 1], even padding
//   prolong   x += overcorrect * e[i / 2]
// The level matvecs and smoother steps run on K18 (shift_matvec.cu); the
// coarsest dense solve is K19c's (mg2d.cu).  Bound: device-memory bytes.

#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(THREADS) mg1d_restrict_kernel(int m, int mc, const double* res, double* rc)
{
    const int I = blockIdx.x * THREADS + threadIdx.x;
    if (I < mc) rc[I] = res[2 * I] + (2 * I + 1 < m ? res[2 * I + 1] : 0.0);
}

__global__ void __launch_bounds__(THREADS) mg1d_prolong_kernel(int m, double* x, const double* ec, double oc)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < m) x[i] = x[i] + oc * ec[i / 2];
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

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

extern "C" int nxfx_mg1d_restrict(int m, int mc, const double* res, double* rc, cudaStream_t stream)
{
    if (mc <= 0) return 0;
    mg1d_restrict_kernel<<<blocks_of(mc), THREADS, 0, stream>>>(m, mc, res, rc);
    return last_error();
}

extern "C" int nxfx_mg1d_prolong(int m, double* x, const double* ec, double oc, cudaStream_t stream)
{
    if (m <= 0) return 0;
    mg1d_prolong_kernel<<<blocks_of(m), THREADS, 0, stream>>>(m, x, ec, oc);
    return last_error();
}
