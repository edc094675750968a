// K19a: the conjugate-gradient steps, the Chebyshev start and the Jacobi
// apply of the iterative λ solve.
//
// Replaces networks_fenicsx_tpu/ops/krylov.py:cg and the elementwise parts
// of chebyshev_preconditioner.  The reference runs CG inside one
// lax.while_loop; here the host launches the iterations and the loop state
// stays on the device in eight doubles,
//   st = [gamma, tol, done, k, maxiter, alpha, beta, ||r||],
// so that no iteration reads anything back.  The kernels that update x and
// r test `done` first and leave x, r and k as they are once it is set; the
// check after each update sets it by the reference's rule, done = !(k <
// maxiter && ||r|| > tol).  The host reads `done` once per chunk of
// iterations, and the iteration count is exactly the per-iteration rule's.
//
// One CG iteration, around the caller's matvec and preconditioner:
//   update_x: p.Ap (block partials, then one block), alpha = gamma / p.Ap,
//             x += alpha p, r -= alpha Ap with the partials of ||r||^2, then
//             one block: k += 1, ||r||, done
//   update_p: r.z (partials, one block), beta = gamma' / gamma, gamma = gamma',
//             p = z + beta p
// Every dot product and norm is a block tree in shared memory over 256
// entries, then one block sums the partials in a fixed order: no float64
// atomics, the same bits from run to run.  A scalar is written by the one
// block that computes it and read by later launches only.
//
// K19e, MINRES (networks_fenicsx_tpu/ops/krylov.py:minres, 120-224): the
// Paige-Saunders recurrence of the reference line for line, its loop state
// in the 17 doubles of `ms` (see MinresSlot) and driven like CG.  Around the
// caller's matvec and preconditioner, one iteration is
//   minres_alpha:  yv -= (beta/oldb) r1 when k >= 2 (k counted from 1),
//                  alfa = v.yv (partials, one block), yv -= (alfa/beta) r2;
//   minres_update: beta' = sqrt(max(yv.y, 0)) (partials, one block that
//                  also runs the rotation: delta, gbar, epsln, dbar, gamma =
//                  max(|(gbar, beta')|, eps), cs, sn, phi, phibar, k += 1,
//                  done = !(k < maxiter && |phibar| > tol)), then
//                  w1 = (v - oldeps w - delta w2) / gamma, x += phi w1,
//                  w1 into w's buffer, and the next v = y / beta' (1 for a
//                  beta' that is not > 0).
// The host rotates the buffers (r1 <- r2 <- yv, w <- w2 <- w1).  Every
// kernel of an iteration that starts with `done` set leaves everything as
// it is (the last one reads `active`, which the rotation block sets), so
// the host may launch a chunk of iterations between two reads of the flag.
//
// Bound: device-memory bytes, every vector read or written once per step.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
enum Slot { GAMMA = 0, TOL = 1, DONE = 2, K = 3, MAXITER = 4, ALPHA = 5, BETA = 6, RNORM = 7 };
enum MinresSlot {
    M_BETA = 0, M_OLDB = 1, M_DBAR = 2, M_EPSLN = 3, M_PHIBAR = 4, M_CS = 5, M_SN = 6, M_TOL = 7,
    M_K = 8, M_MAXITER = 9, M_DONE = 10, M_ALFA = 11, M_OLDEPS = 12, M_DELTA = 13, M_GAMMA = 14,
    M_PHI = 15, M_ACTIVE = 16
};
constexpr double EPS = 2.220446049250313e-16;  // float64 machine epsilon

// max(a, b) that propagates a NaN, as jnp.maximum does
__device__ double nan_max(double a, double b) { return (a > b || isnan(a)) ? a : b; }

// Sum of v over the block in a fixed tree order; every thread gets it.
__device__ double block_sum(double v, double* sh)
{
    __syncthreads();
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) sh[threadIdx.x] = sh[threadIdx.x] + sh[threadIdx.x + half];
        __syncthreads();
    }
    return sh[0];
}

// Sum of m partials by one block: strided per thread, then the tree.
__device__ double finish_sum(int m, const double* part, double* sh)
{
    double acc = 0.0;
    for (int j = threadIdx.x; j < m; j += THREADS) acc = acc + part[j];
    return block_sum(acc, sh);
}

__global__ void __launch_bounds__(THREADS) dot_partial_kernel(int n, const double* a, const double* b,
                                                              double* part)
{
    __shared__ double sh[THREADS];
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const double v = i < n ? a[i] * b[i] : 0.0;
    const double s = block_sum(v, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// part = [r.z | b.b | r.r], nblk partials each
__global__ void __launch_bounds__(THREADS) cg_init_kernel(int nblk, const double* part, double rtol,
                                                          double atol, double maxiter, double* st)
{
    __shared__ double sh[THREADS];
    const double rz = finish_sum(nblk, part, sh);
    const double bb = finish_sum(nblk, part + nblk, sh);
    const double rr = finish_sum(nblk, part + 2 * nblk, sh);
    if (threadIdx.x != 0) return;
    const double rb = rtol * sqrt(bb);
    const double tol = (rb > atol || isnan(rb)) ? rb : atol;  // max, NaN propagating
    const double rnorm = sqrt(rr);
    st[GAMMA] = rz;
    st[TOL] = tol;
    st[K] = 0.0;
    st[MAXITER] = maxiter;
    st[ALPHA] = 0.0;
    st[BETA] = 0.0;
    st[RNORM] = rnorm;
    st[DONE] = (0.0 < maxiter && rnorm > tol) ? 0.0 : 1.0;
}

__global__ void __launch_bounds__(THREADS) cg_alpha_kernel(int nblk, const double* part, double* st)
{
    __shared__ double sh[THREADS];
    const double pap = finish_sum(nblk, part, sh);
    if (threadIdx.x == 0 && st[DONE] == 0.0) st[ALPHA] = st[GAMMA] / pap;
}

__global__ void __launch_bounds__(THREADS) cg_update_x_kernel(int n, const double* st, const double* p,
                                                              const double* ap, double* x, double* r,
                                                              double* part)
{
    if (st[DONE] != 0.0) return;
    __shared__ double sh[THREADS];
    const double alpha = st[ALPHA];
    const int i = blockIdx.x * THREADS + threadIdx.x;
    double ri = 0.0;
    if (i < n) {
        x[i] = x[i] + alpha * p[i];
        ri = r[i] - alpha * ap[i];
        r[i] = ri;
    }
    const double s = block_sum(ri * ri, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS) cg_check_kernel(int nblk, const double* part, double* st)
{
    if (st[DONE] != 0.0) return;
    __shared__ double sh[THREADS];
    const double rr = finish_sum(nblk, part, sh);
    if (threadIdx.x != 0) return;
    const double k = st[K] + 1.0;
    const double rnorm = sqrt(rr);
    st[K] = k;
    st[RNORM] = rnorm;
    st[DONE] = (k < st[MAXITER] && rnorm > st[TOL]) ? 0.0 : 1.0;
}

__global__ void __launch_bounds__(THREADS) cg_beta_kernel(int nblk, const double* part, double* st)
{
    if (st[DONE] != 0.0) return;
    __shared__ double sh[THREADS];
    const double g = finish_sum(nblk, part, sh);
    if (threadIdx.x != 0) return;
    st[BETA] = g / st[GAMMA];
    st[GAMMA] = g;
}

__global__ void __launch_bounds__(THREADS) cg_update_p_kernel(int n, const double* st, const double* z,
                                                              double* p)
{
    if (st[DONE] != 0.0) return;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < n) p[i] = z[i] + st[BETA] * p[i];
}

// rs = s r, dvec = x = rs / theta; with z: z = s x (+ base)
__global__ void __launch_bounds__(THREADS) cheb_start_kernel(int n, const double* s, const double* r,
                                                             double theta, double* rs, double* dvec,
                                                             double* x, double* z, const double* base)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const double rsv = s[i] * r[i];
    const double dv = rsv / theta;
    rs[i] = rsv;
    dvec[i] = dv;
    x[i] = dv;
    if (z != nullptr) z[i] = base != nullptr ? base[i] + s[i] * dv : s[i] * dv;
}

__global__ void __launch_bounds__(THREADS) jacobi_kernel(int n, const double* v, const double* diag,
                                                         double* z)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < n) z[i] = v[i] / diag[i];
}

__global__ void __launch_bounds__(THREADS) inv_sqrt_kernel(int n, const double* d, double* s)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < n) s[i] = 1.0 / sqrt(d[i]);
}

// part = [r.y | b.b], nblk partials each
__global__ void __launch_bounds__(THREADS) minres_init_kernel(int nblk, const double* part, double rtol,
                                                              double atol, double maxiter, double* ms)
{
    __shared__ double sh[THREADS];
    const double ry = finish_sum(nblk, part, sh);
    const double bb = finish_sum(nblk, part + nblk, sh);
    if (threadIdx.x != 0) return;
    const double beta1 = sqrt(nan_max(ry, 0.0));
    const double tol = nan_max(rtol * sqrt(bb), atol);
    ms[M_BETA] = beta1;
    ms[M_OLDB] = 0.0;
    ms[M_DBAR] = 0.0;
    ms[M_EPSLN] = 0.0;
    ms[M_PHIBAR] = beta1;
    ms[M_CS] = -1.0;
    ms[M_SN] = 0.0;
    ms[M_TOL] = tol;
    ms[M_K] = 0.0;
    ms[M_MAXITER] = maxiter;
    ms[M_DONE] = (0.0 < maxiter && fabs(beta1) > tol) ? 0.0 : 1.0;
    ms[M_ALFA] = 0.0;
    ms[M_OLDEPS] = 0.0;
    ms[M_DELTA] = 0.0;
    ms[M_GAMMA] = 0.0;
    ms[M_PHI] = 0.0;
    ms[M_ACTIVE] = 0.0;
}

// v = y / beta (1 for a beta that is not > 0)
__global__ void __launch_bounds__(THREADS) minres_v_kernel(int n, const double* ms, const double* y,
                                                           double* v)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const double beta = ms[M_BETA];
    if (i < n) v[i] = y[i] / (beta > 0.0 ? beta : 1.0);
}

__global__ void __launch_bounds__(THREADS) minres_lanczos_kernel(int n, const double* ms, const double* v,
                                                                 double* yv, const double* r1,
                                                                 double* part)
{
    if (ms[M_DONE] != 0.0) return;
    __shared__ double sh[THREADS];
    const int i = blockIdx.x * THREADS + threadIdx.x;
    double t = 0.0;
    if (i < n) {
        double y = yv[i];
        if (ms[M_K] + 1.0 >= 2.0) y = y - (ms[M_BETA] / ms[M_OLDB]) * r1[i];
        yv[i] = y;
        t = v[i] * y;
    }
    const double s = block_sum(t, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS) minres_alfa_kernel(int nblk, const double* part, double* ms)
{
    if (ms[M_DONE] != 0.0) return;
    __shared__ double sh[THREADS];
    const double alfa = finish_sum(nblk, part, sh);
    if (threadIdx.x == 0) ms[M_ALFA] = alfa;
}

__global__ void __launch_bounds__(THREADS) minres_orth_kernel(int n, const double* ms, double* yv,
                                                              const double* r2)
{
    if (ms[M_DONE] != 0.0) return;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < n) yv[i] = yv[i] - (ms[M_ALFA] / ms[M_BETA]) * r2[i];
}

__global__ void __launch_bounds__(THREADS) minres_rotate_kernel(int nblk, const double* part, double* ms)
{
    __shared__ double sh[THREADS];
    const bool done = ms[M_DONE] != 0.0;
    const double yy = done ? 0.0 : finish_sum(nblk, part, sh);
    if (threadIdx.x != 0) return;
    if (done) {
        ms[M_ACTIVE] = 0.0;
        return;
    }
    const double beta = sqrt(nan_max(yy, 0.0));
    const double cs = ms[M_CS], sn = ms[M_SN], dbar = ms[M_DBAR], alfa = ms[M_ALFA];
    const double oldeps = ms[M_EPSLN];
    const double delta = cs * dbar + sn * alfa;
    const double gbar = sn * dbar - cs * alfa;
    const double epsln = sn * beta;
    const double dbar_new = -cs * beta;
    const double gamma = nan_max(sqrt(gbar * gbar + beta * beta), EPS);
    const double cs_new = gbar / gamma;
    const double sn_new = beta / gamma;
    const double phibar = ms[M_PHIBAR];
    const double k = ms[M_K] + 1.0;
    ms[M_OLDEPS] = oldeps;
    ms[M_DELTA] = delta;
    ms[M_GAMMA] = gamma;
    ms[M_PHI] = cs_new * phibar;
    ms[M_PHIBAR] = sn_new * phibar;
    ms[M_EPSLN] = epsln;
    ms[M_DBAR] = dbar_new;
    ms[M_CS] = cs_new;
    ms[M_SN] = sn_new;
    ms[M_OLDB] = ms[M_BETA];
    ms[M_BETA] = beta;
    ms[M_K] = k;
    ms[M_ACTIVE] = 1.0;
    ms[M_DONE] = (k < ms[M_MAXITER] && fabs(sn_new * phibar) > ms[M_TOL]) ? 0.0 : 1.0;
}

// w1 = (v - oldeps w - delta w2) / gamma into w, x += phi w1, v = y / beta
__global__ void __launch_bounds__(THREADS) minres_step_kernel(int n, const double* ms, double* v,
                                                              const double* y, double* w,
                                                              const double* w2, double* x)
{
    if (ms[M_ACTIVE] == 0.0) return;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const double w1 = (v[i] - ms[M_OLDEPS] * w[i] - ms[M_DELTA] * w2[i]) / ms[M_GAMMA];
    x[i] = x[i] + ms[M_PHI] * w1;
    w[i] = w1;
    const double beta = ms[M_BETA];
    v[i] = y[i] / (beta > 0.0 ? beta : 1.0);
}

int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// part: 3 ceil(n / 256) doubles; st: 8 doubles
extern "C" int nxfx_krylov_cg_start(int n, const double* b, const double* r, const double* z,
                                    double* part, double* st, double rtol, double atol,
                                    double maxiter, cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nblk = blocks_of(n);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, r, z, part);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, b, b, part + nblk);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, r, r, part + 2 * nblk);
    cg_init_kernel<<<1, THREADS, 0, stream>>>(nblk, part, rtol, atol, maxiter, st);
    return last_error();
}

extern "C" int nxfx_krylov_cg_update_x(int n, const double* p, const double* ap, double* x, double* r,
                                       double* part, double* st, cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nblk = blocks_of(n);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, p, ap, part);
    cg_alpha_kernel<<<1, THREADS, 0, stream>>>(nblk, part, st);
    cg_update_x_kernel<<<nblk, THREADS, 0, stream>>>(n, st, p, ap, x, r, part);
    cg_check_kernel<<<1, THREADS, 0, stream>>>(nblk, part, st);
    return last_error();
}

extern "C" int nxfx_krylov_cg_update_p(int n, const double* r, const double* z, double* p, double* part,
                                       double* st, cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nblk = blocks_of(n);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, r, z, part);
    cg_beta_kernel<<<1, THREADS, 0, stream>>>(nblk, part, st);
    cg_update_p_kernel<<<nblk, THREADS, 0, stream>>>(n, st, z, p);
    return last_error();
}

// z and base may be null
extern "C" int nxfx_krylov_cheb_start(int n, const double* s, const double* r, double theta, double* rs,
                                      double* dvec, double* x, double* z, const double* base,
                                      cudaStream_t stream)
{
    if (n <= 0) return 0;
    cheb_start_kernel<<<blocks_of(n), THREADS, 0, stream>>>(n, s, r, theta, rs, dvec, x, z, base);
    return last_error();
}

extern "C" int nxfx_krylov_jacobi(int n, const double* v, const double* diag, double* z,
                                  cudaStream_t stream)
{
    if (n <= 0) return 0;
    jacobi_kernel<<<blocks_of(n), THREADS, 0, stream>>>(n, v, diag, z);
    return last_error();
}

extern "C" int nxfx_krylov_inv_sqrt(int n, const double* d, double* s, cudaStream_t stream)
{
    if (n <= 0) return 0;
    inv_sqrt_kernel<<<blocks_of(n), THREADS, 0, stream>>>(n, d, s);
    return last_error();
}

// ms: 17 doubles; part: 2 ceil(n / 256); r = b - A x0, y = M r; writes v = y / beta1
extern "C" int nxfx_krylov_minres_start(int n, const double* b, const double* r, const double* y,
                                        double* v, double* part, double* ms, double rtol, double atol,
                                        double maxiter, cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nblk = blocks_of(n);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, r, y, part);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, b, b, part + nblk);
    minres_init_kernel<<<1, THREADS, 0, stream>>>(nblk, part, rtol, atol, maxiter, ms);
    minres_v_kernel<<<nblk, THREADS, 0, stream>>>(n, ms, y, v);
    return last_error();
}

// yv = A v on entry; the Lanczos step of one iteration (see the header)
extern "C" int nxfx_krylov_minres_alpha(int n, const double* v, double* yv, const double* r1,
                                        const double* r2, double* part, double* ms,
                                        cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nblk = blocks_of(n);
    minres_lanczos_kernel<<<nblk, THREADS, 0, stream>>>(n, ms, v, yv, r1, part);
    minres_alfa_kernel<<<1, THREADS, 0, stream>>>(nblk, part, ms);
    minres_orth_kernel<<<nblk, THREADS, 0, stream>>>(n, ms, yv, r2);
    return last_error();
}

// y = M yv on entry; beta', the rotation, the updates of w and x, the next v
extern "C" int nxfx_krylov_minres_update(int n, const double* yv, const double* y, double* v,
                                         double* w, const double* w2, double* x, double* part,
                                         double* ms, cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nblk = blocks_of(n);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, yv, y, part);
    minres_rotate_kernel<<<1, THREADS, 0, stream>>>(nblk, part, ms);
    minres_step_kernel<<<nblk, THREADS, 0, stream>>>(n, ms, v, y, w, w2, x);
    return last_error();
}
