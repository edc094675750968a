// The one-block right-looking Cholesky of the multifrontal fronts
// (mf_factor.cu, K13), and the triangular solves of the multifrontal apply
// (mf_apply.cu, K15).
//
// The buffers are written by one thread and read by others after a barrier,
// so they carry no __restrict__: with it the compiler may keep a value in a
// register across __syncthreads() or __syncwarp().

#pragma once

#include <cuda_runtime.h>

namespace {

// Shared memory of right_looking_cholesky for an m-row block: the panel of
// nb columns (row stride nb + 1 past one column, against bank conflicts),
// with nb the widest of 32, 16, ..., 1 that fits in limit bytes.
inline int panel_width(int m, int limit)
{
    int nb = 32;
    while (nb > 1 && static_cast<long long>(m) * (nb + 1) * 8 > limit) nb >>= 1;
    return nb;
}

inline int panel_bytes(int m, int nb)
{
    return m * (nb > 1 ? nb + 1 : 1) * 8;
}

// Right-looking Cholesky of the first w columns of the m x m row-major
// block F (lower triangle), in place, by the whole thread block, a panel of
// nb columns at a time (P: shared scratch of panel_bytes(m, nb) bytes).
// Per panel: its columns, rows k0..m-1, are copied into P (a warp per row,
// its lanes over the nb <= 32 columns) and factored there column by column
// (every thread takes the pivot sqrt(P[c][c]) and scales its rows; after a
// barrier the rest of the panel is updated, again a warp per row and a lane
// per column, so no index is divided); the panel is written back, then each
// warp updates whole rows of the trailing lower triangle,
// F[i][j] -= sum_c P[i][c] P[j][c] for k0 + nb <= j <= i, its lanes over j.
// Every entry takes its column updates in column order, as in the unblocked
// algorithm, so the rounding is the same.
__device__ void right_looking_cholesky(double* F, int m, int w, double* P, int nb_max)
{
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_warps = blockDim.x >> 5;
    const int ld = nb_max > 1 ? nb_max + 1 : 1;
    for (int k0 = 0; k0 < w; k0 += nb_max) {
        const int nb = w - k0 < nb_max ? w - k0 : nb_max;
        const int rows = m - k0;
        if (lane < nb)
            for (int r = warp; r < rows; r += n_warps)
                P[r * ld + lane] = F[static_cast<size_t>(k0 + r) * m + k0 + lane];
        __syncthreads();
        for (int c = 0; c < nb; ++c) {
            const double piv = sqrt(P[c * ld + c]);
            for (int r = c + 1 + tid; r < rows; r += blockDim.x) P[r * ld + c] = P[r * ld + c] / piv;
            __syncthreads();
            if (tid == 0) P[c * ld + c] = piv;
            const int q = c + 1 + lane;  // this lane's column of the panel
            if (q < nb) {
                const double pq = P[q * ld + c];
                for (int r = c + 1 + warp; r < rows; r += n_warps)
                    if (r >= q) P[r * ld + q] = P[r * ld + q] - P[r * ld + c] * pq;
            }
            __syncthreads();
        }
        if (lane < nb)
            for (int r = warp; r < rows; r += n_warps)
                if (r >= lane) F[static_cast<size_t>(k0 + r) * m + k0 + lane] = P[r * ld + lane];
        for (int r = nb + warp; r < rows; r += n_warps) {
            double* row = F + static_cast<size_t>(k0 + r) * m + k0;
            const double* pr = P + r * ld;
            for (int q = nb + lane; q <= r; q += 32) {
                const double* pq = P + q * ld;
                double acc = row[q];
                for (int c = 0; c < nb; ++c) acc = acc - pr[c] * pq[c];
                row[q] = acc;
            }
        }
        __syncthreads();
    }
}

// v <- L^-1 v for the n x n lower-triangular L (row stride ld) whose strict
// upper triangle holds L^T, by the whole block, v in shared memory.  Per
// block of 32 rows: warp 0 solves the diagonal block in registers (lane l
// holds v[k0 + l], the reciprocal of its pivot, taken before the chain so
// that no division waits in it, and column l of the block's rows of L^T,
// read along rows; one shuffle per step), then every thread subtracts the
// block's part from its rows below, reading L^T along rows.  Each entry
// takes its updates in column order, as the column-oriented solve does.
// Ends with a barrier.
__device__ void lower_solve_block(const double* L, int n, int ld, double* v)
{
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    for (int k0 = 0; k0 < n; k0 += 32) {
        const int nb = n - k0 < 32 ? n - k0 : 32;
        if (tid < 32) {
            double a[32];  // a[c] = L[k0 + lane][k0 + c] (the diagonal at c = lane)
#pragma unroll
            for (int c = 0; c < 32; ++c)
                a[c] = (c < nb && lane < nb) ? L[static_cast<size_t>(k0 + c) * ld + k0 + lane] : 0.0;
            double x = lane < nb ? v[k0 + lane] : 0.0;
            const double inv =
                lane < nb ? 1.0 / L[static_cast<size_t>(k0 + lane) * ld + k0 + lane] : 0.0;
#pragma unroll
            for (int c = 0; c < 32; ++c) {
                if (c < nb) {
                    if (lane == c) x = x * inv;
                    const double xc = __shfl_sync(0xffffffffu, x, c);
                    if (lane > c) x = x - a[c] * xc;
                }
            }
            if (lane < nb) v[k0 + lane] = x;
        }
        __syncthreads();
        for (int i = k0 + nb + tid; i < n; i += blockDim.x) {
            double acc = v[i];
#pragma unroll 16
            for (int c = 0; c < nb; ++c)
                acc = acc - L[static_cast<size_t>(k0 + c) * ld + i] * v[k0 + c];
            v[i] = acc;
        }
        __syncthreads();
    }
}

// v <- L^-T v for the same L, by the whole block, v in shared memory: the
// blocks of 32 rows from the bottom, each solved by warp 0 in registers
// (lane l holds row l of the block's rows of L, read along rows, and the
// reciprocal of its pivot), then its part subtracted from the rows above
// along L's rows.  Ends with a barrier.
__device__ void lower_transpose_solve_block(const double* L, int n, int ld, double* v)
{
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    for (int k1 = n; k1 > 0; k1 -= 32) {
        const int k0 = k1 > 32 ? k1 - 32 : 0;
        const int nb = k1 - k0;
        if (tid < 32) {
            double a[32];  // a[c] = L[k0 + c][k0 + lane] (the diagonal at c = lane)
#pragma unroll
            for (int c = 0; c < 32; ++c)
                a[c] = (c < nb && lane < nb) ? L[static_cast<size_t>(k0 + c) * ld + k0 + lane] : 0.0;
            double x = lane < nb ? v[k0 + lane] : 0.0;
            const double inv =
                lane < nb ? 1.0 / L[static_cast<size_t>(k0 + lane) * ld + k0 + lane] : 0.0;
#pragma unroll
            for (int c = 31; c >= 0; --c) {
                if (c < nb) {
                    if (lane == c) x = x * inv;
                    const double xc = __shfl_sync(0xffffffffu, x, c);
                    if (lane < c) x = x - a[c] * xc;
                }
            }
            if (lane < nb) v[k0 + lane] = x;
        }
        __syncthreads();
        for (int i = tid; i < k0; i += blockDim.x) {
            double acc = v[i];
#pragma unroll 16
            for (int c = nb - 1; c >= 0; --c)
                acc = acc - L[static_cast<size_t>(k0 + c) * ld + i] * v[k0 + c];
            v[i] = acc;
        }
        __syncthreads();
    }
}

// Mirror the strict lower triangle of the first n rows and columns of the
// row-major block F (row stride ld) into its strict upper triangle, by the
// whole block; the caller synchronises after.
__device__ void mirror_lower(double* F, int n, int ld)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    for (int i = warp; i < n; i += n_warps)
        for (int j = lane; j < i; j += 32)
            F[static_cast<size_t>(j) * ld + i] = F[static_cast<size_t>(i) * ld + j];
}

}  // namespace
