// K21b: the float64 dense solve of the assembled saddle-point matrix — an
// LU factor with partial pivoting, its solve, and the triangular solves it
// is made of (also used on K11's Cholesky factor).
//
// Replaces networks_fenicsx_tpu/solver.py:_dense_solve_f64 (4763-4778):
// there an f32 LU with four f64 refinement passes works around the TPU's
// f32-only LU, and on the CPU the reference calls jnp.linalg.solve (LAPACK
// getrf + getrs).  Here the factor is float64 on the card, right-looking
// and unblocked, on a row-major (n, n) matrix in place (n <= 8,192):
//   for each column k: the pivot search, one block over rows k..n-1 taking
//   the largest |a[i][k]| and, on ties, the lowest row index (LAPACK's
//   idamax rule: the saddle matrix is full of equal +-1 entries and zero
//   diagonals, and a reduction that broke ties otherwise would pick other
//   pivots); the swap of rows k and p over every column; the column scaled
//   by r = 1 / a[k][k] (LAPACK's dscal by the reciprocal); the rank-1
//   update a[i][j] -= a[i][k] a[k][j] of the trailing block, product then
//   difference (-fmad=false), as the plain version does it.
// piv[k] is the row swapped with row k at step k (0-based).  The solve
// applies the swaps to a copy of b, then two triangular solves.  A
// triangular solve is one block, column by column (x[k] is final, then
// every later row subtracts a(i, k) x[k]), on A or on its transpose, with a
// unit or a stored diagonal: L and U of the LU factor, and a Cholesky
// factor C and C^T.
//
// Bound: float64 operations, 2n^3/3 for the factor.  The rank-1 update
// moves the trailing block through device memory at every step, n^3/3
// element updates: this simple kernel is bound by those bytes instead.

#include <cuda_runtime.h>

namespace {

constexpr int PIVOT_THREADS = 1024;
constexpr int THREADS = 256;
constexpr int TRSV_THREADS = 1024;

__global__ void __launch_bounds__(PIVOT_THREADS) pivot_kernel(int n, int k, double* A, int* piv)
{
    __shared__ double best[PIVOT_THREADS];
    __shared__ int where[PIVOT_THREADS];
    double bv = -1.0;
    int bi = n;
    for (int i = k + threadIdx.x; i < n; i += PIVOT_THREADS) {
        const double a = fabs(A[static_cast<long long>(i) * n + k]);
        if (a > bv || (isnan(a) && !isnan(bv))) {  // first NaN wins, as idamax's first maximum
            bv = a;
            bi = i;
        }
    }
    best[threadIdx.x] = bv;
    where[threadIdx.x] = bi;
    __syncthreads();
    for (int half = PIVOT_THREADS / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) {
            const double ov = best[threadIdx.x + half];
            const int oi = where[threadIdx.x + half];
            const double mv = best[threadIdx.x];
            const int mi = where[threadIdx.x];
            const bool take = (ov > mv) || (ov == mv && oi < mi) || (isnan(ov) && !isnan(mv))
                              || (isnan(ov) && isnan(mv) && oi < mi);
            if (take) {
                best[threadIdx.x] = ov;
                where[threadIdx.x] = oi;
            }
        }
        __syncthreads();
    }
    const int p = where[0] < n ? where[0] : k;
    if (threadIdx.x == 0) piv[k] = p;
    if (p == k) return;
    double* rk = A + static_cast<long long>(k) * n;
    double* rp = A + static_cast<long long>(p) * n;
    for (int j = threadIdx.x; j < n; j += PIVOT_THREADS) {
        const double t = rk[j];
        rk[j] = rp[j];
        rp[j] = t;
    }
}

__global__ void __launch_bounds__(THREADS) scale_kernel(int n, int k, double* A)
{
    const int i = k + 1 + blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const double r = 1.0 / A[static_cast<long long>(k) * n + k];
    A[static_cast<long long>(i) * n + k] = A[static_cast<long long>(i) * n + k] * r;
}

// the trailing block rows/cols k+1..n-1: a 32 x 8 thread tile, 4 rows a thread
__global__ void __launch_bounds__(THREADS) update_kernel(int n, int k, double* A)
{
    const int j = k + 1 + blockIdx.x * 32 + threadIdx.x;
    if (j >= n) return;
    const double ukj = A[static_cast<long long>(k) * n + j];
    for (int r = 0; r < 4; ++r) {
        const int i = k + 1 + (blockIdx.y * 8 + threadIdx.y) * 4 + r;
        if (i >= n) return;
        double* row = A + static_cast<long long>(i) * n;
        row[j] = row[j] - row[k] * ukj;
    }
}

// x[i] = b[piv-permuted]: the swaps in order, one thread
__global__ void permute_kernel(int n, const int* piv, const double* b, double* x)
{
    for (int i = 0; i < n; ++i) x[i] = b[i];
    for (int k = 0; k < n; ++k) {
        const int p = piv[k];
        if (p != k) {
            const double t = x[k];
            x[k] = x[p];
            x[p] = t;
        }
    }
}

// a(i, c) = trans ? A[c][i] : A[i][c]; the effective matrix is lower when
// lower != trans (forward), upper otherwise (backward)
__global__ void __launch_bounds__(TRSV_THREADS) trsv_kernel(int n, const double* A, int lower, int trans,
                                                            int unit, double* x)
{
    const bool forward = (lower != 0) != (trans != 0);
    for (int s = 0; s < n; ++s) {
        const int c = forward ? s : n - 1 - s;
        if (!unit && threadIdx.x == 0) {
            x[c] = x[c] / A[static_cast<long long>(c) * n + c];
        }
        __syncthreads();
        const double xc = x[c];
        if (forward) {
            for (int i = c + 1 + threadIdx.x; i < n; i += TRSV_THREADS) {
                const double a = trans ? A[static_cast<long long>(c) * n + i] : A[static_cast<long long>(i) * n + c];
                x[i] = x[i] - a * xc;
            }
        } else {
            for (int i = threadIdx.x; i < c; i += TRSV_THREADS) {
                const double a = trans ? A[static_cast<long long>(c) * n + i] : A[static_cast<long long>(i) * n + c];
                x[i] = x[i] - a * xc;
            }
        }
        __syncthreads();
    }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// A: (n, n) row-major, factored in place into unit-lower L and U; piv: (n,)
extern "C" int nxfx_lu_factor(int n, double* A, int* piv, cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < n; ++k) {
        pivot_kernel<<<1, PIVOT_THREADS, 0, stream>>>(n, k, A, piv);
        const int rest = n - k - 1;
        if (rest > 0) {
            scale_kernel<<<(rest + THREADS - 1) / THREADS, THREADS, 0, stream>>>(n, k, A);
            const dim3 grid((rest + 31) / 32, (rest + 31) / 32);
            update_kernel<<<grid, dim3(32, 8), 0, stream>>>(n, k, A);
        }
        const int code = last_error();
        if (code != 0) return code;
    }
    return 0;
}

// x = A^-1 b from the factor and pivots of nxfx_lu_factor (x may not alias b)
extern "C" int nxfx_lu_solve(int n, const double* LU, const int* piv, const double* b, double* x,
                             cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    permute_kernel<<<1, 1, 0, stream>>>(n, piv, b, x);
    trsv_kernel<<<1, TRSV_THREADS, 0, stream>>>(n, LU, 1, 0, 1, x);
    trsv_kernel<<<1, TRSV_THREADS, 0, stream>>>(n, LU, 0, 0, 0, x);
    return last_error();
}

// x = op(T)^-1 x in place, T the lower (lower = 1) or upper triangle of A,
// op the transpose when trans = 1, unit diagonal when unit = 1
extern "C" int nxfx_trsv(int n, const double* A, int lower, int trans, int unit, double* x,
                         cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    trsv_kernel<<<1, TRSV_THREADS, 0, stream>>>(n, A, lower, trans, unit, x);
    return last_error();
}
