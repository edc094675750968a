// K8b: multipliers -> the solution blocks of the general forest Schur solve.
//
// Replaces networks_fenicsx_tpu/solver.py:_backsub_from_lambda and
// _solution_blocks_T.  Per edge e (public order):
//   lam_s, lam_t from the edge's source / target bifurcation (0 at a boundary)
//   r0 = s bif ? lam_s : -p_s,   rN = t bif ? -lam_t : p_t,   q0 = (r0 + rN - g) / W
//   uniform layout (P1, R and f per edge), closed forms:
//     q_j = q0 + F j,   p_c = r0 - a q0 (c + 1/2) - a F (c^2/2 + (3c + 1)/6)
//   otherwise the chain walk, q_j = q0 + cumF_j and the cell momenta
//     m_c = M~_c (q_c, q_c+1):  P1 scalar  a_c [[1/3, 1/6], [1/6, 1/3]]
//                               degree-k scalar  a_c M~^ (fixed)
//                               general  mt_c (per cell)
//     p_c = r0 - sum_{i <= c} (m_c,0 + m_c-1,1)
//     interior flux dofs q_int = -Minv_IE (q_c, q_c+1), fixed or per cell
//   q_T[:, e] (k N + 1 rows) and p_T[:, e] (N rows), j-major
//   finite &= isfinite of every value written, and of lam[e] for e < B
//
// Bound: device-memory bytes.  It writes the whole solution,
// (k N + 1 + N) E doubles, and reads O(N E) of condensed data (the
// uniform layout reads O(E)).  One thread owns one edge and walks down its
// column, so each row of q_T / p_T and of the j-major inputs is one
// coalesced run across the warp.  The finiteness flag only ever goes from
// 1 to 0, so concurrent plain stores suffice.
//
// A sweep (batch.solve_sweep on the dense route and without multipliers)
// expands S scenarios in one launch (nxfx_backsub_scen): the grid's y,
// min(S, 65,535) rows of blocks walking the scenarios y, y + gridDim.y, ...;
// every array moves by its own stride a scenario (0 when shared: the
// boundary pressures of an R or f batch, the fixed recovery matrix), each
// scenario has its own finiteness flag, and the per-edge body is the
// one-scenario launch's, so a scenario's blocks are that launch's bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int LAYOUT_UNIFORM = 0;
constexpr int LAYOUT_SCALAR = 1;
constexpr int LAYOUT_SCALAR_K = 2;

// The doubles between two scenarios' arrays (0: shared or unused).
struct BacksubStrides {
    long long lam, sp, ep, edge, cumF, mt, rh, minv, qT, pT;
};

// edge e (and multiplier e < B) of one scenario
__device__ __forceinline__ void backsub_edge(
    int e, int layout, int E, int B, int N, int k,
    const double* __restrict__ lam,
    const int* __restrict__ start_bif,
    const int* __restrict__ end_bif,
    const double* __restrict__ start_pbc,
    const double* __restrict__ end_pbc,
    const double* __restrict__ W,
    const double* __restrict__ g,
    const double* __restrict__ cumF,   // (N+1, E)
    const double* __restrict__ mt,     // (N, 2, 2, E)      general
    const double* __restrict__ rh,     // (N, E)            scalar layouts
    const double* __restrict__ minv,   // (k-1, 2) fixed, or (N, k-1, 2, E) per cell
    int minv_per_cell,
    const double* __restrict__ ua,
    const double* __restrict__ uF,
    double mt00, double mt01, double mt10, double mt11,
    double* __restrict__ q_T,
    double* __restrict__ p_T,
    int* __restrict__ finite)
{
    if (e < B && !isfinite(lam[e])) *finite = 0;
    if (e >= E) return;
    const size_t sE = static_cast<size_t>(E);
    const int s = start_bif[e];
    const int t = end_bif[e];
    const double r0 = s >= 0 ? lam[s] : -start_pbc[e];
    const double rN = t >= 0 ? -lam[t] : end_pbc[e];
    const double q0 = (r0 + rN - g[e]) / W[e];
    bool ok = true;

    if (layout == LAYOUT_UNIFORM) {
        const double F = uF[e];
        for (int j = 0; j <= N; ++j) {
            const double v = q0 + F * static_cast<double>(j);
            q_T[j * sE + e] = v;
            ok = ok && isfinite(v);
        }
        const double aq = ua[e] * q0;
        const double aF = ua[e] * F;
        for (int c = 0; c < N; ++c) {
            const double dc = static_cast<double>(c);
            const double v = r0 - aq * (dc + 0.5) - aF * (dc * dc / 2.0 + (3.0 * dc + 1.0) / 6.0);
            p_T[c * sE + e] = v;
            ok = ok && isfinite(v);
        }
        if (!ok) *finite = 0;
        return;
    }

    const int n = k - 1;
    double qj = q0 + cumF[e];
    double carry = 0.0, psum = 0.0;
    for (int c = 0; c < N; ++c) {
        const double qj1 = q0 + cumF[(c + 1) * sE + e];
        double mc0, mc1;
        if (layout == LAYOUT_SCALAR) {
            const double a = rh[c * sE + e];
            mc0 = a * (qj / 3.0 + qj1 / 6.0);
            mc1 = a * (qj / 6.0 + qj1 / 3.0);
        } else if (layout == LAYOUT_SCALAR_K) {
            const double a = rh[c * sE + e];
            mc0 = a * (mt00 * qj + mt01 * qj1);
            mc1 = a * (mt10 * qj + mt11 * qj1);
        } else {
            const double* m = mt + static_cast<size_t>(c) * 4 * sE + e;
            mc0 = m[0] * qj + m[sE] * qj1;
            mc1 = m[2 * sE] * qj + m[3 * sE] * qj1;
        }
        psum += mc0 + carry;
        carry = mc1;
        const double p = r0 - psum;
        p_T[c * sE + e] = p;
        q_T[static_cast<size_t>(c) * k * sE + e] = qj;
        ok = ok && isfinite(p) && isfinite(qj);
        for (int i = 0; i < n; ++i) {
            double m0, m1;
            if (minv_per_cell) {
                const double* x = minv + (static_cast<size_t>(c) * n + i) * 2 * sE + e;
                m0 = x[0];
                m1 = x[sE];
            } else {
                m0 = minv[2 * i];
                m1 = minv[2 * i + 1];
            }
            const double v = -(m0 * qj + m1 * qj1);
            q_T[(static_cast<size_t>(c) * k + 1 + i) * sE + e] = v;
            ok = ok && isfinite(v);
        }
        qj = qj1;
    }
    q_T[static_cast<size_t>(N) * k * sE + e] = qj;
    ok = ok && isfinite(qj);
    if (!ok) *finite = 0;
}

// S scenarios (S = 1: the one-scenario launch), scenario z's arrays z
// strides further on and its flag finite[z]
__global__ void backsub_blocks_kernel(
    int layout, int E, int B, int N, int k, int S, BacksubStrides z0,
    const double* lam, const int* start_bif, const int* end_bif, const double* start_pbc,
    const double* end_pbc, const double* W, const double* g, const double* cumF, const double* mt,
    const double* rh, const double* minv, int minv_per_cell, const double* ua, const double* uF,
    double mt00, double mt01, double mt10, double mt11, double* q_T, double* p_T, int* finite)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    for (int zi = blockIdx.y; zi < S; zi += gridDim.y) {
        const size_t z = static_cast<size_t>(zi);
        backsub_edge(e, layout, E, B, N, k, lam + z * z0.lam, start_bif, end_bif, start_pbc + z * z0.sp,
                     end_pbc + z * z0.ep, W + z * z0.edge, g + z * z0.edge, cumF + z * z0.cumF, mt + z * z0.mt,
                     rh + z * z0.rh, minv + z * z0.minv, minv_per_cell, ua + z * z0.edge, uF + z * z0.edge,
                     mt00, mt01, mt10, mt11, q_T + z * z0.qT, p_T + z * z0.pT, finite + z);
    }
}

int launch_backsub(
    int layout, int E, int B, int N, int k, int S, const BacksubStrides& z0,
    const double* lam, const int* start_bif, const int* end_bif,
    const double* start_pbc, const double* end_pbc,
    const double* W, const double* g, const double* cumF,
    const double* mt, const double* rh, const double* minv, int minv_per_cell,
    const double* ua, const double* uF,
    double mt00, double mt01, double mt10, double mt11,
    double* q_T, double* p_T, int* finite,
    cudaStream_t stream)
{
    const int n = E > B ? E : B;
    if (n <= 0 || S <= 0) return 0;
    const int threads = 256;
    const dim3 grid((n + threads - 1) / threads, S < 65535 ? S : 65535);
    backsub_blocks_kernel<<<grid, threads, 0, stream>>>(
        layout, E, B, N, k, S, z0, lam, start_bif, end_bif, start_pbc, end_pbc, W, g, cumF,
        mt, rh, minv, minv_per_cell, ua, uF, mt00, mt01, mt10, mt11, q_T, p_T, finite);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nxfx_backsub(
    int layout, int E, int B, int N, int k,
    const double* lam, const int* start_bif, const int* end_bif,
    const double* start_pbc, const double* end_pbc,
    const double* W, const double* g, const double* cumF,
    const double* mt, const double* rh, const double* minv, int minv_per_cell,
    const double* ua, const double* uF,
    double mt00, double mt01, double mt10, double mt11,
    double* q_T, double* p_T, int* finite,
    cudaStream_t stream)
{
    return launch_backsub(layout, E, B, N, k, 1, BacksubStrides{}, lam, start_bif, end_bif, start_pbc, end_pbc,
                          W, g, cumF, mt, rh, minv, minv_per_cell, ua, uF, mt00, mt01, mt10, mt11, q_T, p_T,
                          finite, stream);
}

// K8b of S scenarios in one launch: the one-scenario arguments (the first
// scenario's pointers) with S and the host array of the strides (lam,
// start_pbc, end_pbc, the (E,) edge data W, g, ua, uF, cumF, mt, rh, minv,
// q_T, p_T; 0 when shared or unused); finite (S,).
extern "C" int nxfx_backsub_scen(
    int layout, int E, int B, int N, int k, int S, const long long* strides,
    const double* lam, const int* start_bif, const int* end_bif,
    const double* start_pbc, const double* end_pbc,
    const double* W, const double* g, const double* cumF,
    const double* mt, const double* rh, const double* minv, int minv_per_cell,
    const double* ua, const double* uF,
    double mt00, double mt01, double mt10, double mt11,
    double* q_T, double* p_T, int* finite,
    cudaStream_t stream)
{
    const BacksubStrides z0{strides[0], strides[1], strides[2], strides[3], strides[4],
                            strides[5], strides[6], strides[7], strides[8], strides[9]};
    return launch_backsub(layout, E, B, N, k, S, z0, lam, start_bif, end_bif, start_pbc, end_pbc, W, g, cumF,
                          mt, rh, minv, minv_per_cell, ua, uF, mt00, mt01, mt10, mt11, q_T, p_T, finite,
                          stream);
}
