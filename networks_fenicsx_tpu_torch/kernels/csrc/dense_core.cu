// K11: the dense solve of a small cycle core (at most 512 nodes).
//
// Replaces networks_fenicsx_tpu/ops/mixed_precision.py:scaled_cholesky_factor
// and scaled_cholesky_solve, with the core assembly of
// networks_fenicsx_tpu/solver.py:_tree_eliminate_factor.
//   Lc = diag(dc) - sum over core pairs (i, j, q) of w_q (e_i e_j^T + e_j e_i^T)
//   s = sqrt(diag Lc),  Ls = (Lc / s_row) / s_col,  Ls = C C^T (Cholesky, float64)
//   ok = all pivots C_ii finite and min C_ii > 1e-7 max C_ii   (the singularity gate)
//   solve(v) = C^-T C^-1 (v / s) / s,  x = solve(rc),  n_refine x:  x += solve(rc - Lc x)
//   x = NaN everywhere when not ok
// The reference factors in float32 because float64 is emulated on the TPU;
// the H100 has native float64, so the factor is float64 here and the pivot
// gate and the refinement passes (three in the solver, as in the reference's
// scaled_cholesky_solve) are kept.
//
// Bound: the n^3/6 multiply-adds of the factor (right_looking_cholesky.cuh)
// in one thread block and its 2 n barriers (about 22 M for n = 512).  The
// two n x n matrices (2 MB each at n = 512) live in global scratch and stay
// in L2; the vectors live in shared memory.  The core pairs are unique, so the assembly writes each
// entry once.  Lc and C are written by one thread and read by others after
// a barrier, so they carry no __restrict__: with it the compiler may keep a
// value in a register across __syncthreads().

#include <cuda_runtime.h>

#include "right_looking_cholesky.cuh"

namespace {

constexpr int THREADS = 512;  // 128 registers a thread: the solves' 32-entry rows do not spill
constexpr int MAX_N = 512;
constexpr double PIVOT_RTOL = 1e-7;
constexpr int PANEL_BYTES = 160 * 1024;  // shared memory for the Cholesky panel

// v <- C^-T C^-1 v in place (C lower with C^T above the diagonal, n x n,
// row-major; v in shared memory), by the whole block
__device__ void cholesky_solve_inplace(int n, const double* C, double* v)
{
    lower_solve_block(C, n, n, v);
    lower_transpose_solve_block(C, n, n, v);
}

__global__ void __launch_bounds__(THREADS) dense_core_kernel(
    int n, int P0, int nb, int n_refine,
    const int* __restrict__ ci,
    const int* __restrict__ cj,
    const int* __restrict__ pid,
    const double* __restrict__ w_pairs,
    const double* __restrict__ dc,
    const double* __restrict__ rc,
    double* Lc,                // (n, n) scratch: the assembled core
    double* C,                 // (n, n) scratch: the scaled matrix, then its factor
    double* __restrict__ x,    // (n,) out
    int* __restrict__ ok_out)
{
    __shared__ double s[MAX_N];
    __shared__ double xs[MAX_N];
    __shared__ double v[MAX_N];
    extern __shared__ double panel[];  // right_looking_cholesky's column panel
    __shared__ int ok;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_warps = blockDim.x >> 5;

    // the n x n loops go a warp per row and a lane per column, coalesced
    for (int i = warp; i < n; i += n_warps)
        for (int j = lane; j < n; j += 32) Lc[static_cast<size_t>(i) * n + j] = 0.0;
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) Lc[static_cast<size_t>(i) * n + i] = dc[i];
    for (int p = tid; p < P0; p += blockDim.x) {
        const double wv = -w_pairs[pid[p]];
        Lc[static_cast<size_t>(ci[p]) * n + cj[p]] = wv;
        Lc[static_cast<size_t>(cj[p]) * n + ci[p]] = wv;
    }
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) s[i] = sqrt(Lc[static_cast<size_t>(i) * n + i]);
    __syncthreads();
    for (int i = warp; i < n; i += n_warps)
        for (int j = lane; j < n; j += 32) {
            const size_t t = static_cast<size_t>(i) * n + j;
            C[t] = (Lc[t] / s[i]) / s[j];
        }
    __syncthreads();

    right_looking_cholesky(C, n, n, panel, nb);  // lower triangle, in place
    mirror_lower(C, n, n);  // C^T above the diagonal, for the solves
    __syncthreads();
    if (warp == 0) {  // the pivot gate, reduced over the warp
        double lo = INFINITY, hi = -INFINITY;
        int finite = 1;
        for (int i = lane; i < n; i += 32) {
            const double p = C[static_cast<size_t>(i) * n + i];
            finite &= isfinite(p) ? 1 : 0;
            lo = fmin(lo, p);
            hi = fmax(hi, p);
        }
        for (int o = 16; o > 0; o >>= 1) {
            lo = fmin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
            hi = fmax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        finite = __all_sync(0xffffffffu, finite);
        if (lane == 0) {
            ok = finite && lo > PIVOT_RTOL * hi;
            ok_out[0] = ok;
        }
    }
    __syncthreads();

    // x = solve(rc), then n_refine passes x += solve(rc - Lc x)
    for (int i = tid; i < n; i += blockDim.x) v[i] = rc[i] / s[i];
    __syncthreads();
    cholesky_solve_inplace(n, C, v);
    for (int i = tid; i < n; i += blockDim.x) xs[i] = v[i] / s[i];
    __syncthreads();
    for (int pass = 0; pass < n_refine; ++pass) {
        for (int i = warp; i < n; i += n_warps) {  // v = (rc - Lc xs) / s, a warp per row
            const double* row = Lc + static_cast<size_t>(i) * n;
            double acc = 0.0;
            for (int j = lane; j < n; j += 32) acc = acc + row[j] * xs[j];
            for (int o = 16; o > 0; o >>= 1) acc = acc + __shfl_down_sync(0xffffffffu, acc, o);
            if (lane == 0) v[i] = (rc[i] - acc) / s[i];
        }
        __syncthreads();
        cholesky_solve_inplace(n, C, v);
        for (int i = tid; i < n; i += blockDim.x) xs[i] = xs[i] + v[i] / s[i];
        __syncthreads();
    }
    for (int i = tid; i < n; i += blockDim.x) x[i] = ok ? xs[i] : __longlong_as_double(0x7ff8000000000000LL);
}

}  // namespace

extern "C" int nxfx_dense_core(
    int n, int P0, int n_refine, const int* ci, const int* cj, const int* pid,
    const double* w_pairs, const double* dc, const double* rc, double* Lc, double* C, double* x,
    int* ok, cudaStream_t stream)
{
    if (n <= 0) return 0;
    if (n > MAX_N || n_refine < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nb = panel_width(n, PANEL_BYTES);
    const int shared = panel_bytes(n, nb);
    const cudaError_t err = cudaFuncSetAttribute(
        dense_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    dense_core_kernel<<<1, THREADS, shared, stream>>>(
        n, P0, nb, n_refine, ci, cj, pid, w_pairs, dc, rc, Lc, C, x, ok);
    return static_cast<int>(cudaGetLastError());
}
