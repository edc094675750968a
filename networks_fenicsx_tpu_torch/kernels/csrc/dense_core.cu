// K11: the dense solve of a cycle core or of a dense tail (at most 8,192 nodes).
//
// Replaces networks_fenicsx_tpu/ops/mixed_precision.py:scaled_cholesky_factor
// and scaled_cholesky_solve, with the two assemblies that feed them: the core
// of networks_fenicsx_tpu/solver.py:_tree_eliminate_factor (pair p at
// (ci[p], cj[p]) with value -w_pairs[pid[p]]) and the dense tail of
// networks_fenicsx_tpu/ops/core_elim.py:_core_factor (pid = 0, 1, ..., the
// negated values given: -(init_ext[dp_init] - fold(ustream, dp_fold))).
//   Lc = diag(dc) + the pair values at (ci, cj) and (cj, ci)
//   s = sqrt(diag Lc),  Ls = (Lc / s_row) / s_col,  Ls = C C^T (Cholesky, float64)
//   ok = all pivots C_ii finite and min C_ii > 1e-7 max C_ii   (the singularity gate)
//   solve(v) = C^-T C^-1 (v / s) / s,  x = solve(rc),  n_refine x:  x += solve(rc - Lc x)
//   x = NaN everywhere when not ok
// The reference factors in float32 because float64 is emulated on the TPU;
// the H100 has native float64, so the factor is float64 here and the pivot
// gate and the refinement passes (three in the solver, as in the reference's
// scaled_cholesky_solve) are kept.
//
// The assembly and the Jacobi scaling run over the whole card, then the
// tiled multi-block factor, the blocked triangular solves and the one-block
// pivot gate of tiled_cholesky.cuh, and a warp per row for each refinement
// matvec rc - Lc x.  Bound: the factor's n^3/3 operations; then the
// 2 (1 + n_refine) n^2 / 2 factor entries read by the solves and the
// n_refine n^2 of Lc read by the matvecs.  (A one-block kernel of the first
// port, for n <= 512, measured slower than this route at n = 455.)
// The pairs are unique, so the assembly writes each entry once.  Lc, C, s,
// v and y are written by one thread and read by others, so they carry no
// __restrict__.

#include <cuda_runtime.h>

#include "tiled_cholesky.cuh"

namespace {

constexpr double PIVOT_RTOL = 1e-7;

// Lc = diag(dc), C = its scaled diagonal (dc / s) / s, s = sqrt(dc): over n^2
__global__ void tiled_init_kernel(int n, const double* __restrict__ dc, double* Lc, double* C, double* s)
{
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= static_cast<long long>(n) * n) return;
    const int i = static_cast<int>(t / n), j = static_cast<int>(t % n);
    if (i == j) {
        const double si = sqrt(dc[i]);
        Lc[t] = dc[i];
        C[t] = (dc[i] / si) / si;
        s[i] = si;
    } else {
        Lc[t] = 0.0;
        C[t] = 0.0;
    }
}

// the pairs into Lc and their scaled values into C
__global__ void tiled_pairs_kernel(int n, int P0, const int* __restrict__ ci, const int* __restrict__ cj,
                                   const int* __restrict__ pid, const double* __restrict__ w_pairs,
                                   const double* s, double* Lc, double* C)
{
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P0) return;
    const double wv = -w_pairs[pid[p]];
    const int i = ci[p], j = cj[p];
    const size_t ij = static_cast<size_t>(i) * n + j, ji = static_cast<size_t>(j) * n + i;
    Lc[ij] = wv;
    Lc[ji] = wv;
    C[ij] = (wv / s[i]) / s[j];
    C[ji] = (wv / s[j]) / s[i];
}

// v = (rc - Lc x) / s, a warp per row (first pass: x = 0, v = rc / s)
__global__ void tiled_residual_kernel(int n, const double* Lc, const double* __restrict__ rc,
                                      const double* s, const double* x, int first, double* v)
{
    const int lane = threadIdx.x & 31;
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (i >= n) return;
    double acc = 0.0;
    if (!first) {
        const double* row = Lc + static_cast<size_t>(i) * n;
        for (int j = lane; j < n; j += 32) acc = acc + row[j] * x[j];
        for (int o = 16; o > 0; o >>= 1) acc = acc + __shfl_down_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) v[i] = (first ? rc[i] : rc[i] - acc) / s[i];
}

// x = v / s (first pass) or x + v / s; last: NaN everywhere unless ok
__global__ void tiled_update_kernel(int n, const double* v, const double* s, int first, int last,
                                    const int* ok, double* x)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    double xi = first ? v[i] / s[i] : x[i] + v[i] / s[i];
    if (last && !ok[0]) xi = __longlong_as_double(0x7ff8000000000000LL);
    x[i] = xi;
}

}  // namespace

namespace {

// Lc, its scaled copy C factored in place (lower triangle) and s
cudaError_t assemble_and_factor(int n, int P0, const int* ci, const int* cj, const int* pid,
                                const double* w_pairs, const double* dc, double* Lc, double* C,
                                double* s, cudaStream_t stream)
{
    const long long nn = static_cast<long long>(n) * n;
    tiled_init_kernel<<<static_cast<int>((nn + 255) / 256), 256, 0, stream>>>(n, dc, Lc, C, s);
    if (P0 > 0)
        tiled_pairs_kernel<<<(P0 + 255) / 256, 256, 0, stream>>>(n, P0, ci, cj, pid, w_pairs, s, Lc, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return tiled_cholesky(C, n, n, n, stream);
}

}  // namespace

// Lc, C (n x n) and s, v, y (n,) are scratch; x (n,) and ok out.
extern "C" int nxfx_dense_core(
    int n, int P0, int n_refine, const int* ci, const int* cj, const int* pid,
    const double* w_pairs, const double* dc, const double* rc, double* Lc, double* C, double* s,
    double* v, double* y, double* x, int* ok, cudaStream_t stream)
{
    if (n <= 0) return 0;
    if (n_refine < 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = assemble_and_factor(n, P0, ci, cj, pid, w_pairs, dc, Lc, C, s, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc_gate_kernel<<<1, 1024, 0, stream>>>(n, n, C, PIVOT_RTOL, 1, ok);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int rows = (n * 32 + 255) / 256;
    for (int pass = 0; pass <= n_refine; ++pass) {
        tiled_residual_kernel<<<rows, 256, 0, stream>>>(n, Lc, rc, s, x, pass == 0, v);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
        // y = C^-1 v, then v = C^-T y
        if ((err = tiled_solve(C, n, n, v, y, false, stream)) != cudaSuccess) return static_cast<int>(err);
        if ((err = tiled_solve(C, n, n, y, v, true, stream)) != cudaSuccess) return static_cast<int>(err);
        tiled_update_kernel<<<(n + 255) / 256, 256, 0, stream>>>(n, v, s, pass == 0, pass == n_refine,
                                                                  ok, x);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

// The assembly and the factor alone (what the checks of the factor's
// backward error read): Lc, s and C out (its lower triangle the factor, its
// strict upper triangle scratch).
extern "C" int nxfx_dense_factor(
    int n, int P0, const int* ci, const int* cj, const int* pid, const double* w_pairs,
    const double* dc, double* Lc, double* C, double* s, cudaStream_t stream)
{
    if (n <= 0) return 0;
    return static_cast<int>(assemble_and_factor(n, P0, ci, cj, pid, w_pairs, dc, Lc, C, s, stream));
}
