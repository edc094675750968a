// K5: multipliers -> per-edge endpoint data -> the solution blocks.
//
// Replaces networks_fenicsx_tpu/solver.py:_blocked_lambda_to_edges, the
// `back` closure of _blocked_condense_f and the tail of
// _blocked_uniform_solve.  Per internal edge e:
//   lam_s, lam_t from the edge's source / target bifurcation (0 at a boundary)
//   r0 = s bif ? lam_s : -p_s,   rN = t bif ? -lam_t : p_t,   q0 = (r0 + rN - g) w
//   q_T[:, e] (k N + 1 rows) and p_T[:, e] (N rows) by the closed forms:
//     P1 with per-edge R and f:  q_j = q0 + F j,
//                                p_c = r0 - a q0 (c + 1/2) - a F (c^2/2 + (3c + 1)/6)
//     otherwise the chain walk:  q_j = q0 + cumF_j,  p_c = r0 - sum_{i<=c} m_i with
//                                m the condensed cell momentum, plus the interior
//                                recovery q_int = -Minv [q_c, q_{c+1}] for k >= 2
//   finite &= isfinite(W, g, Ftot, q0, r0) and, for e < B, isfinite(lam[e])
//
// Bound: device-memory bytes.  It writes the whole solution, (k N + 1 + N) E
// doubles (43 MB at 16 generations, N = 40), and reads O(E) (O(N E) in cell
// mode).  One thread owns one edge and walks down its column: each row of
// q_T / p_T is written by a warp as one coalesced run.  The finiteness flag
// only ever goes from 1 to 0, so concurrent plain stores suffice.

#include <cuda_runtime.h>

namespace {

constexpr int MODE_SCALAR = 0;
constexpr int MODE_CELL = 2;

__device__ inline double coeff(const double* a, int mode, int c, int e, int E)
{
    return mode == MODE_SCALAR ? a[0] : (mode == MODE_CELL ? a[(size_t)c * E + e] : a[e]);
}

__global__ void expand_kernel(
    int E, int B, int N, int k,
    const double* __restrict__ lam,
    const int* __restrict__ edge_src,
    const int* __restrict__ edge_tgt,
    const double* __restrict__ start_pbc,
    const double* __restrict__ end_pbc,
    const double* __restrict__ W,
    const double* __restrict__ w,
    const double* __restrict__ g,
    const double* __restrict__ Ftot,
    const double* __restrict__ h_e,
    const double* __restrict__ R, int R_mode,
    const double* __restrict__ f, int f_mode,
    double mt00, double mt01, double mt10, double mt11,
    const double* __restrict__ Minv,  // (k - 1, 2) interior recovery
    double* __restrict__ q_T,
    double* __restrict__ p_T,
    int* __restrict__ finite)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e < B && !isfinite(lam[e])) *finite = 0;
    if (e >= E) return;
    const int s = edge_src[e];
    const int t = edge_tgt[e];
    const double r0 = s >= 0 ? lam[s] : -start_pbc[e];
    const double rN = t >= 0 ? -lam[t] : end_pbc[e];
    const double ge = g[e];
    const double q0 = (r0 + rN - ge) * w[e];
    if (!(isfinite(q0) && isfinite(r0) && isfinite(W[e]) && isfinite(ge) && isfinite(Ftot[e])))
        *finite = 0;

    const double h = h_e[e];
    const bool r_cell = R_mode == MODE_CELL;
    const bool f_cell = f_mode == MODE_CELL;
    const double a1 = r_cell ? 0.0 : coeff(R, R_mode, 0, e, E) * h;
    const double F1 = f_cell ? 0.0 : coeff(f, f_mode, 0, e, E) * h;

    if (k == 1 && !r_cell && !f_cell) {
        // uniform closed forms
        for (int j = 0; j <= N; ++j)
            q_T[(size_t)j * E + e] = q0 + F1 * static_cast<double>(j);
        const double aq = a1 * q0;
        const double aF = a1 * F1;
        for (int c = 0; c < N; ++c) {
            const double dc = static_cast<double>(c);
            p_T[(size_t)c * E + e] =
                r0 - aq * (dc + 0.5) - aF * (dc * dc / 2.0 + (3.0 * dc + 1.0) / 6.0);
        }
        return;
    }

    // chain walk: q_c, q_{c+1} of cell c, the momentum carry mc1 of cell c - 1
    double cum = 0.0;  // cumF_c
    double qj = q0;    // q_chain_c = q0 + cumF_c
    double carry = 0.0, psum = 0.0;
    for (int c = 0; c < N; ++c) {
        const double next = f_cell ? cum + f[(size_t)c * E + e] * h
                                   : F1 * static_cast<double>(c + 1);
        const double qj1 = q0 + next;
        const double ab = r_cell ? R[(size_t)c * E + e] * h : a1;
        double mc0, mc1;
        if (k == 1) {
            mc0 = ab * (qj / 3.0 + qj1 / 6.0);
            mc1 = ab * (qj / 6.0 + qj1 / 3.0);
        } else {
            mc0 = ab * (mt00 * qj + mt01 * qj1);
            mc1 = ab * (mt10 * qj + mt11 * qj1);
        }
        psum += mc0 + carry;
        carry = mc1;
        p_T[(size_t)c * E + e] = r0 - psum;
        q_T[(size_t)(c * k) * E + e] = qj;
        for (int i = 0; i < k - 1; ++i)
            q_T[(size_t)(c * k + 1 + i) * E + e] = -(Minv[2 * i] * qj + Minv[2 * i + 1] * qj1);
        cum = next;
        qj = qj1;
    }
    q_T[(size_t)(N * k) * E + e] = qj;
}

}  // namespace

extern "C" int nxfx_expand(
    int E, int B, int N, int k,
    const double* lam, const int* edge_src, const int* edge_tgt,
    const double* start_pbc, const double* end_pbc,
    const double* W, const double* w, const double* g, const double* Ftot,
    const double* h_e, const double* R, int R_mode, const double* f, int f_mode,
    double mt00, double mt01, double mt10, double mt11, const double* Minv,
    double* q_T, double* p_T, int* finite,
    cudaStream_t stream)
{
    const int n = E > B ? E : B;
    if (n <= 0) return 0;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    expand_kernel<<<blocks, threads, 0, stream>>>(
        E, B, N, k, lam, edge_src, edge_tgt, start_pbc, end_pbc, W, w, g, Ftot,
        h_e, R, R_mode, f, f_mode, mt00, mt01, mt10, mt11, Minv, q_T, p_T, finite);
    return static_cast<int>(cudaGetLastError());
}
