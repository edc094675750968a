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
// Bound: device-memory bytes, every vector read or written once per step.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
enum Slot { GAMMA = 0, TOL = 1, DONE = 2, K = 3, MAXITER = 4, ALPHA = 5, BETA = 6, RNORM = 7 };

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
