// K8a: element formation and per-edge static condensation of the general
// forest Schur solve.
//
// Replaces networks_fenicsx_tpu/solver.py:_make_edge_data_uniform,
// _make_edge_data_scalar(_k), _make_edge_data and the quadrature einsums of
// the generic `core` of build_schur_executor.  Per edge e of length N h:
//   element formation, per cell c:
//     quad R:  M_c[i][j] = h sum_q R_cq w_q phi_qi phi_qj      (general layout)
//     else:    a_c = R_c h                                      (scalar layouts)
//     F_c = h sum_q f_cq w_q (quad f), f_c h otherwise; 0 when the source is elided
//   condensation, by layout:
//     uniform   a = R_e h, F = f_e h: W = a N, Ftot = F N, g = a F N^2 / 2
//     scalar    W = sum a_c,      g = 1/2 sum a_c (cumF_c + cumF_c+1)
//     scalar_k  W = wt sum a_c,   g = sum a_c (cs0 cumF_c + cs1 cumF_c+1)
//     general   k = 1: mt_c = M_c; k >= 2: Cholesky of the interior block
//               M_II, Minv_IE = M_II^-1 M_IE, mt_c = M_EE - M_EI Minv_IE;
//               W = sum 1^T mt_c 1,  g = sum colsum(mt_c) . (cumF_c, cumF_c+1)
//     cumF_0 = 0, cumF_c+1 = cumF_c + F_c
//   every sum left to right in the order the plain version takes it
//   (quadrature points, then cells), so the two agree to the last bit
//
// Bound: device-memory bytes.  Every output is written j-major (cell row
// first, edge last), so one thread owning one edge and walking down its N
// cells writes one coalesced row per step across the warp.  The inputs are
// the reference's public edge-major arrays, read as they come (no host
// transpose): a thread's cells are consecutive, so a warp's reads of one
// step land in cache lines the next steps reuse.  The interior Cholesky of
// degree k >= 2 needs (k-1)^2 doubles a thread, for any k: they live in a
// j-major scratch array the wrapper allocates, so no degree is capped.

#include <cuda_runtime.h>

namespace {

constexpr int MODE_SCALAR = 0;
constexpr int MODE_EDGE = 1;
constexpr int MODE_CELL = 2;
constexpr int MODE_QUAD = 3;

constexpr int LAYOUT_UNIFORM = 0;
constexpr int LAYOUT_SCALAR = 1;
constexpr int LAYOUT_SCALAR_K = 2;

// cellwise value of a coefficient of cell c of edge e (quad: its Gauss sum)
__device__ inline double cell_value(
    const double* a, int mode, int e, int c, int N, int nq, const double* wq)
{
    if (mode == MODE_SCALAR) return a[0];
    if (mode == MODE_EDGE) return a[e];
    const size_t cell = static_cast<size_t>(e) * N + c;
    if (mode == MODE_CELL) return a[cell];
    double s = 0.0;
    for (int q = 0; q < nq; ++q) s += a[cell * nq + q] * wq[q];
    return s;
}

__global__ void edge_data_kernel(
    int layout, int E, int N, int k, int nq,
    const double* __restrict__ h_e,
    const double* __restrict__ R, int R_mode,
    const double* __restrict__ f, int f_mode, int elide_f,
    const double* __restrict__ wq,    // (nq,) Gauss weights
    const double* __restrict__ wphi,  // (nq, k+1, k+1) w_q phi_qi phi_qj
    double wt, double cs0, double cs1,
    double* __restrict__ mt,      // (N, 2, 2, E)            general
    double* __restrict__ minv,    // (N, k-1, 2, E)          general, k >= 2
    double* __restrict__ work,    // ((k-1)^2, E) scratch    general, k >= 2
    double* __restrict__ cumF,    // (N+1, E); (1, E) = Ftot uniform
    double* __restrict__ W_out,
    double* __restrict__ g_out,
    double* __restrict__ rh,      // (N, E)                  scalar layouts
    double* __restrict__ ua,      // (E,)                    uniform
    double* __restrict__ uF)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    const double h = h_e[e];
    const double dN = static_cast<double>(N);

    if (layout == LAYOUT_UNIFORM) {
        const double a = (R_mode == MODE_SCALAR ? R[0] : R[e]) * h;
        const double F = (f_mode == MODE_SCALAR ? f[0] : f[e]) * h;
        W_out[e] = a * dN;
        g_out[e] = a * F * (dN * dN / 2.0);
        cumF[e] = F * dN;
        ua[e] = a;
        uF[e] = F;
        return;
    }

    const bool general = layout != LAYOUT_SCALAR && layout != LAYOUT_SCALAR_K;
    const int n = k - 1;   // interior dofs of a cell
    const int kk = k + 1;  // dofs of a cell
    const size_t sE = static_cast<size_t>(E);
    double cum = 0.0, Wacc = 0.0, gacc = 0.0;
    cumF[e] = 0.0;
    for (int c = 0; c < N; ++c) {
        const double F = elide_f ? 0.0 : cell_value(f, f_mode, e, c, N, nq, wq) * h;
        const double next = cum + F;
        cumF[(c + 1) * sE + e] = next;
        if (!general) {
            const double a = cell_value(R, R_mode, e, c, N, nq, wq) * h;
            rh[c * sE + e] = a;
            Wacc += a;
            if (!elide_f)
                gacc += layout == LAYOUT_SCALAR ? a * (cum + next) : a * (cs0 * cum + cs1 * next);
        } else {
            const double* Rc = R + (static_cast<size_t>(e) * N + c) * nq;
            auto M = [&](int i, int j) {
                double s = 0.0;
                for (int q = 0; q < nq; ++q) s += Rc[q] * wphi[(q * kk + i) * kk + j];
                return s * h;
            };
            double m[2][2];
            const int ends[2] = {0, k};
            if (k == 1) {
                for (int i = 0; i < 2; ++i)
                    for (int j = 0; j < 2; ++j) m[i][j] = M(i, j);
            } else {
                // lower Cholesky factor of M_II in work, L(i, j) at row i * n + j
                auto L = [&](int i, int j) -> double& { return work[(static_cast<size_t>(i) * n + j) * sE + e]; };
                for (int j = 0; j < n; ++j) {
                    double s = M(1 + j, 1 + j);
                    for (int p = 0; p < j; ++p) s -= L(j, p) * L(j, p);
                    const double d = sqrt(s);
                    L(j, j) = d;
                    for (int i = j + 1; i < n; ++i) {
                        double t = M(1 + i, 1 + j);
                        for (int p = 0; p < j; ++p) t -= L(i, p) * L(j, p);
                        L(i, j) = t / d;
                    }
                }
                // Minv_IE = M_II^-1 M_IE: forward then backward substitution
                double* X = minv + static_cast<size_t>(c) * n * 2 * sE + e;  // X(i, t) at (i * 2 + t) * E
                for (int t = 0; t < 2; ++t) {
                    for (int i = 0; i < n; ++i) {
                        double s = M(1 + i, ends[t]);
                        for (int p = 0; p < i; ++p) s -= L(i, p) * X[(p * 2 + t) * sE];
                        X[(i * 2 + t) * sE] = s / L(i, i);
                    }
                    for (int i = n - 1; i >= 0; --i) {
                        double s = X[(i * 2 + t) * sE];
                        for (int p = i + 1; p < n; ++p) s -= L(p, i) * X[(p * 2 + t) * sE];
                        X[(i * 2 + t) * sE] = s / L(i, i);
                    }
                }
                for (int a = 0; a < 2; ++a)
                    for (int b = 0; b < 2; ++b) {
                        double s = 0.0;
                        for (int i = 0; i < n; ++i) s += M(ends[a], 1 + i) * X[(i * 2 + b) * sE];
                        m[a][b] = M(ends[a], ends[b]) - s;
                    }
            }
            double* mc = mt + static_cast<size_t>(c) * 4 * sE + e;
            mc[0] = m[0][0];
            mc[sE] = m[0][1];
            mc[2 * sE] = m[1][0];
            mc[3 * sE] = m[1][1];
            const double col0 = m[0][0] + m[1][0];  // column sums of mt_c
            const double col1 = m[0][1] + m[1][1];
            Wacc += col0 + col1;
            gacc += col0 * cum + col1 * next;
        }
        cum = next;
    }
    W_out[e] = layout == LAYOUT_SCALAR_K ? wt * Wacc : Wacc;
    g_out[e] = elide_f ? 0.0 : (layout == LAYOUT_SCALAR ? 0.5 * gacc : gacc);
}

}  // namespace

extern "C" int nxfx_edge_data(
    int layout, int E, int N, int k, int nq,
    const double* h_e, const double* R, int R_mode, const double* f, int f_mode, int elide_f,
    const double* wq, const double* wphi, double wt, double cs0, double cs1,
    double* mt, double* minv, double* work, double* cumF, double* W, double* g,
    double* rh, double* ua, double* uF,
    cudaStream_t stream)
{
    if (E <= 0) return 0;
    const int threads = 128;
    const int blocks = (E + threads - 1) / threads;
    edge_data_kernel<<<blocks, threads, 0, stream>>>(
        layout, E, N, k, nq, h_e, R, R_mode, f, f_mode, elide_f, wq, wphi, wt, cs0, cs1,
        mt, minv, work, cumF, W, g, rh, ua, uF);
    return static_cast<int>(cudaGetLastError());
}
