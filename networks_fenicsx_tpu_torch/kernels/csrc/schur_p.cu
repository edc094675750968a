// K21a: the per-edge flux blocks of the continuous-pressure reduced solve —
// their banded Cholesky factor and the solves A^-1 v.
//
// Replaces the A_blocks assembly, jnp.linalg.cholesky and apply_Ainv of
// networks_fenicsx_tpu/solver.py:_continuous_pressure_solve (4666-4685,
// 4718-4724).  The flux block of edge e is the sum of its N overlapping
// (k+1)^2 cell masses: an (m, m) SPD matrix, m = kN + 1, banded with half
// bandwidth k.  The reference factors it dense, (E, m, m); the Cholesky
// factor of a band matrix keeps the band (the dense factor has exact zeros
// outside it), so here it is stored as the band alone,
//   L(e, i, d) = L_e[i][i - d], d = 0..k, at Lb[(i (k+1) + d) E + e],
// (m, k+1, E) with the edge fastest so that neighbouring threads touch
// neighbouring addresses: 127 MB at the 16-generation P2/P1 tree, against
// 3.4 GB for the dense blocks.
//
// One thread an edge:
//   factor: form the band from the cell masses (c = eN + j, lower triangle,
//           cells in order: a node shared by two cells gets M_{j-1}[k][k]
//           then M_j[0][0]), write its diagonal into adiag at the edge's
//           global flux dofs, then the band Cholesky in place, row by row:
//           L[i][j] = (A[i][j] - sum_{t<j} L[i][t] L[j][t]) / L[j][j] for
//           j = i-k..i-1, L[i][i] = sqrt(A[i][i] - sum_{t<i} L[i][t]^2),
//           the sums over the band in ascending t;
//   solve:  forward then back substitution on the band, in and out at the
//           edge's global flux dofs base[e] + i, where they already sit in
//           the color-sorted global layout (the reference permutes to edge
//           order and back: the same values).  For k <= 4 the last k
//           values of each sweep stay in registers and the forward result
//           goes through a scratch Y (m, E) laid out like the band, so the
//           only strided accesses are one read of v and one write of out a
//           row; other k keep every value in out.  The terms are subtracted
//           in ascending column order either way, as the plain version does.
//
// Bound: device-memory bytes — the factor reads the cell masses and writes
// the band and the diagonal; a solve reads the band and v and writes out.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) factor_kernel(int E, int N, int k, const double* cm,
                                                         const int* base, double* Lb, double* adiag)
{
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e >= E) return;
    const int kk = k + 1;
    const int m = k * N + 1;
    const long long stride = E;
    double* L = Lb + e;  // L(i, d) = L[(i * kk + d) * stride]
    for (int i = 0; i < m; ++i)
        for (int d = 0; d < kk; ++d) L[(static_cast<long long>(i) * kk + d) * stride] = 0.0;
    for (int j = 0; j < N; ++j) {
        const double* M = cm + (static_cast<long long>(e) * N + j) * kk * kk;
        for (int a = 0; a < kk; ++a) {
            for (int b = 0; b <= a; ++b) {
                double* slot = L + (static_cast<long long>(k * j + a) * kk + (a - b)) * stride;
                *slot = *slot + M[a * kk + b];
            }
        }
    }
    const long long b0 = base[e];
    for (int i = 0; i < m; ++i) adiag[b0 + i] = L[static_cast<long long>(i) * kk * stride];
    for (int i = 0; i < m; ++i) {
        const int t0 = i - k > 0 ? i - k : 0;
        for (int j = t0; j < i; ++j) {
            double s = L[(static_cast<long long>(i) * kk + (i - j)) * stride];
            for (int t = t0; t < j; ++t)
                s = s - L[(static_cast<long long>(i) * kk + (i - t)) * stride]
                        * L[(static_cast<long long>(j) * kk + (j - t)) * stride];
            L[(static_cast<long long>(i) * kk + (i - j)) * stride] =
                s / L[static_cast<long long>(j) * kk * stride];
        }
        double s = L[static_cast<long long>(i) * kk * stride];
        for (int t = t0; t < i; ++t) {
            const double l = L[(static_cast<long long>(i) * kk + (i - t)) * stride];
            s = s - l * l;
        }
        L[static_cast<long long>(i) * kk * stride] = sqrt(s);
    }
}

__global__ void __launch_bounds__(THREADS) solve_kernel(int E, int m, int k, const double* Lb,
                                                        const int* base, const double* v,
                                                        double* out)
{
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e >= E) return;
    const int kk = k + 1;
    const long long stride = E;
    const double* L = Lb + e;
    const long long b0 = base[e];
    double* x = out + b0;
    const double* rhs = v + b0;
    for (int i = 0; i < m; ++i) {  // L y = v
        const int t0 = i - k > 0 ? i - k : 0;
        double s = rhs[i];
        for (int t = t0; t < i; ++t) s = s - L[(static_cast<long long>(i) * kk + (i - t)) * stride] * x[t];
        x[i] = s / L[static_cast<long long>(i) * kk * stride];
    }
    for (int i = m - 1; i >= 0; --i) {  // L^T x = y
        const int t1 = i + k < m - 1 ? i + k : m - 1;
        double s = x[i];
        for (int t = i + 1; t <= t1; ++t) s = s - L[(static_cast<long long>(t) * kk + (t - i)) * stride] * x[t];
        x[i] = s / L[static_cast<long long>(i) * kk * stride];
    }
}

// the solve for a half bandwidth K known at compile time (see the header)
template <int K>
__global__ void __launch_bounds__(THREADS) solve_window_kernel(int E, int m, const double* Lb,
                                                               const int* base, const double* v,
                                                               double* Y, double* out)
{
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e >= E) return;
    constexpr int KK = K + 1;
    const long long stride = E;
    const double* L = Lb + e;
    double* y = Y + e;
    const long long b0 = base[e];
    double win[K];  // forward: x[i-K .. i-1], oldest first
#pragma unroll
    for (int j = 0; j < K; ++j) win[j] = 0.0;
    for (int i = 0; i < m; ++i) {  // L y = v
        double s = v[b0 + i];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            if (i - K + j >= 0) s = s - L[(static_cast<long long>(i) * KK + (K - j)) * stride] * win[j];
        }
        const double xi = s / L[static_cast<long long>(i) * KK * stride];
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) win[j] = win[j + 1];
        win[K - 1] = xi;
        y[static_cast<long long>(i) * stride] = xi;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) win[j] = 0.0;  // backward: x[i+1 .. i+K], nearest first
    for (int i = m - 1; i >= 0; --i) {  // L^T x = y
        double s = y[static_cast<long long>(i) * stride];
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const int t = i + 1 + j;
            if (t < m) s = s - L[(static_cast<long long>(t) * KK + (t - i)) * stride] * win[j];
        }
        const double xi = s / L[static_cast<long long>(i) * KK * stride];
#pragma unroll
        for (int j = K - 1; j > 0; --j) win[j] = win[j - 1];
        win[0] = xi;
        out[b0 + i] = xi;
    }
}

int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// cm: (E N, k+1, k+1) cell masses; base: (E,) first global flux dof of each
// edge; Lb: (kN+1, k+1, E) band factor; adiag: the global flux diagonal
extern "C" int nxfx_schur_p_factor(int E, int N, int k, const double* cm, const int* base, double* Lb,
                                   double* adiag, cudaStream_t stream)
{
    if (E <= 0) return 0;
    if (N <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
    factor_kernel<<<blocks_of(E), THREADS, 0, stream>>>(E, N, k, cm, base, Lb, adiag);
    return last_error();
}

// out = A^-1 v on the flux dofs of every edge (out may not alias v); Y:
// (kN+1, E) scratch, read for k <= 4 only
extern "C" int nxfx_schur_p_solve(int E, int N, int k, const double* Lb, const int* base, const double* v,
                                  double* Y, double* out, cudaStream_t stream)
{
    if (E <= 0) return 0;
    if (N <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int m = k * N + 1;
    switch (k) {
    case 1: solve_window_kernel<1><<<blocks_of(E), THREADS, 0, stream>>>(E, m, Lb, base, v, Y, out); break;
    case 2: solve_window_kernel<2><<<blocks_of(E), THREADS, 0, stream>>>(E, m, Lb, base, v, Y, out); break;
    case 3: solve_window_kernel<3><<<blocks_of(E), THREADS, 0, stream>>>(E, m, Lb, base, v, Y, out); break;
    case 4: solve_window_kernel<4><<<blocks_of(E), THREADS, 0, stream>>>(E, m, Lb, base, v, Y, out); break;
    default: solve_kernel<<<blocks_of(E), THREADS, 0, stream>>>(E, m, k, Lb, base, v, out);
    }
    return last_error();
}
