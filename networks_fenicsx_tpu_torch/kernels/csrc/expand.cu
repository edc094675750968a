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
//
// A sweep (batch.solve_sweep) expands S scenarios in one launch: grid
// (blocks over max(E, B), min(S, 65,535)), each block row looping over the
// scenarios y, y + gridDim.y, ...  Every input and output moves by its own
// stride a scenario (0 for an input the scenarios share: the row ends,
// h_e and the recovery matrix always, R, f or the boundary data when they
// are not batched), each scenario has its own finiteness flag, and the
// per-edge body is the one-scenario kernel's (expand_edge), so a
// scenario's blocks are its one-scenario launch's bit for bit.  The
// one-scenario call passes S = 1.

#include <cuda_runtime.h>

// The launch's arguments: the first scenario's pointers and each one's
// stride a scenario (0: shared by all scenarios).
struct ExpandArgs {
    int S, E, B, N, k, R_mode, f_mode;
    double mt00, mt01, mt10, mt11;
    const int* edge_src;
    const int* edge_tgt;
    const double* h_e;
    const double* Minv;  // (k - 1, 2) interior recovery
    const double* lam;
    const double* start_pbc;
    const double* end_pbc;
    const double* W;
    const double* w;
    const double* g;
    const double* Ftot;
    const double* R;
    const double* f;
    double* q_T;
    double* p_T;
    int* finite;
    long long s_lam, s_sp, s_ep, s_cond, s_R, s_f, s_q, s_p;  // s_cond: W, w, g, Ftot
};

namespace {

constexpr int MODE_SCALAR = 0;
constexpr int MODE_CELL = 2;

__device__ inline double coeff(const double* a, int mode, int c, int e, int E)
{
    return mode == MODE_SCALAR ? a[0] : (mode == MODE_CELL ? a[(size_t)c * E + e] : a[e]);
}

// edge e (and multiplier e < B) of one scenario
__device__ __forceinline__ void expand_edge(
    int e, int E, int B, int N, int k,
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
    const double* __restrict__ Minv,
    double* __restrict__ q_T,
    double* __restrict__ p_T,
    int* __restrict__ finite)
{
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

// grid (blocks over max(E, B), min(S, 65,535)): edge e of scenarios
// blockIdx.y, blockIdx.y + gridDim.y, ...
__global__ void expand_kernel(const ExpandArgs a)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    for (int s = blockIdx.y; s < a.S; s += gridDim.y) {
        expand_edge(e, a.E, a.B, a.N, a.k, a.lam + s * a.s_lam, a.edge_src, a.edge_tgt,
                    a.start_pbc + s * a.s_sp, a.end_pbc + s * a.s_ep, a.W + s * a.s_cond,
                    a.w + s * a.s_cond, a.g + s * a.s_cond, a.Ftot + s * a.s_cond, a.h_e,
                    a.R + s * a.s_R, a.R_mode, a.f + s * a.s_f, a.f_mode, a.mt00, a.mt01,
                    a.mt10, a.mt11, a.Minv, a.q_T + s * a.s_q, a.p_T + s * a.s_p, a.finite + s);
    }
}

int launch(const ExpandArgs& a, cudaStream_t stream)
{
    const int n = a.E > a.B ? a.E : a.B;
    if (n <= 0 || a.S == 0) return 0;
    if (a.S < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const dim3 grid((n + threads - 1) / threads, a.S < 65535 ? a.S : 65535);
    expand_kernel<<<grid, threads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5 of a->S scenarios (q_T (S, k N + 1, E), p_T (S, N, E), finite (S,)).
extern "C" int nxfx_expand_scen(const ExpandArgs* a, cudaStream_t stream)
{
    return launch(*a, stream);
}

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
    const ExpandArgs a = {1, E, B, N, k, R_mode, f_mode, mt00, mt01, mt10, mt11, edge_src,
                          edge_tgt, h_e, Minv, lam, start_pbc, end_pbc, W, w, g, Ftot, R, f,
                          q_T, p_T, finite, 0, 0, 0, 0, 0, 0, 0, 0};
    return launch(a, stream);
}

// ---------------------------------------------------------------- K5's transpose
//
// The blocked route's adjoint (adjoint.py; what jax.grad makes of the
// reference's _blocked_lambda_to_edges and `back` closure).  Per internal
// edge e, from the cotangents q_bar (k N + 1, E) and p_bar (N, E) of K5's
// blocks:
//   P_c   = sum_{i >= c} p_bar_i        (minus the cotangent of cell c's mc0;
//                                        P_{c+1} that of its mc1)
//   Q_j   = the cotangent of q_chain_j = q0 + cumF_j: q_bar's chain row, the
//           interior rows through -Minv, and the momenta's a_c Mt terms
//   q0_bar = sum_j Q_j,  r0's = P_0 + q0_bar w,  rN's = q0_bar w
//   R: a_c's cotangent -P_c (Mt[0,:] q) - P_{c+1} (Mt[1,:] q), times h
//   f: cumF_j's is Q_j (j >= 1): per cell sum_{j > c} Q_j, per edge sum_j j Q_j, times h
// One thread an edge walks its column from the last cell to the first (the
// suffix sums), rebuilding cumF_c = cumF_{c+1} - f_c h from the forward
// pass's sum in per-cell f mode.  Writes bars (3, E) = (q0_bar, r0_bar,
// rN_bar) and K5's share of R's and f's cotangents, per cell (N, E) in
// cell mode, else per edge (E,).
//
// Bound: device-memory bytes.  It reads the (k N + 1 + N) E cotangents
// once (42.5 MB at 16 generations, N = 40) and O(E) (O(N E) in cell mode)
// besides; each step of the walk is one coalesced row read across the warp.
//
// The fold (expand_vjp_fold_kernel), a thread a bifurcation b with in-edge
// i and out-edges o_j:  rho_b = lam_bar_b - rN_bar_i + sum_j r0_bar_oj,
// written to rho and to Ftot_adj at i; a thread an edge zeroes Ftot_adj at
// the edges that end at a boundary.  bif_in names every bifurcation once
// and no edge twice, so every entry has one writer: no atomics.  Ftot_adj
// is the right-hand side on which K3-K4's apply (const = 0) solves S z = rho.

struct ExpandVjpArgs {
    int E, B, N, k, R_mode, f_mode;
    double mt00, mt01, mt10, mt11;
    const int* edge_src;
    const int* edge_tgt;
    const double* h_e;
    const double* Minv;  // (k - 1, 2) interior recovery
    const double* lam;
    const double* start_pbc;
    const double* end_pbc;
    const double* w;
    const double* g;
    const double* R;
    const double* f;
    const double* q_bar;  // (k N + 1, E)
    const double* p_bar;  // (N, E)
    double* bars;         // (3, E): q0_bar, r0_bar, rN_bar
    double* R_part;       // (N, E) in cell mode, else (E,)
    double* f_part;
};

namespace {

constexpr int VJP_THREADS = 256;

__global__ void __launch_bounds__(VJP_THREADS) expand_vjp_kernel(const ExpandVjpArgs a)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int E = a.E, N = a.N, k = a.k;
    if (e >= E) return;
    const int s = a.edge_src[e];
    const int t = a.edge_tgt[e];
    const double r0 = s >= 0 ? a.lam[s] : -a.start_pbc[e];
    const double rN = t >= 0 ? -a.lam[t] : a.end_pbc[e];
    const double we = a.w[e];
    const double q0 = (r0 + rN - a.g[e]) * we;
    const double h = a.h_e[e];
    const bool r_cell = a.R_mode == MODE_CELL;
    const bool f_cell = a.f_mode == MODE_CELL;
    const double a1 = r_cell ? 0.0 : coeff(a.R, a.R_mode, 0, e, E) * h;
    const double F1 = f_cell ? 0.0 : coeff(a.f, a.f_mode, 0, e, E) * h;

    double cum_next;  // cumF_{c+1}: cumF_N first, as the forward pass sums it
    if (f_cell) {
        double cum = 0.0;
        for (int c = 0; c < N; ++c) cum = cum + a.f[(size_t)c * E + e] * h;
        cum_next = cum;
    } else {
        cum_next = F1 * static_cast<double>(N);
    }
    double P = 0.0;                                // P_{c+1}
    double Qn = a.q_bar[(size_t)(N * k) * E + e];  // Q_{c+1}, complete once cell c is done
    double q0b = 0.0, Fsuf = 0.0, F1b = 0.0, a1b = 0.0;
    for (int c = N - 1; c >= 0; --c) {
        const size_t ic = (size_t)c * E + e;
        const double cum = f_cell ? cum_next - a.f[ic] * h : F1 * static_cast<double>(c);
        const double qj = q0 + cum;
        const double qj1 = q0 + cum_next;
        const double Pc = P + a.p_bar[ic];
        const double ab = r_cell ? a.R[ic] * h : a1;
        const double abb = -Pc * (a.mt00 * qj + a.mt01 * qj1) - P * (a.mt10 * qj + a.mt11 * qj1);
        double Qc = a.q_bar[(size_t)(c * k) * E + e];
        for (int i = 0; i < k - 1; ++i) {
            const double qb = a.q_bar[(size_t)(c * k + 1 + i) * E + e];
            Qc = Qc - a.Minv[2 * i] * qb;
            Qn = Qn - a.Minv[2 * i + 1] * qb;
        }
        Qc = Qc + ab * (-a.mt00 * Pc - a.mt10 * P);
        Qn = Qn + ab * (-a.mt01 * Pc - a.mt11 * P);
        q0b += Qn;
        if (f_cell) {
            Fsuf += Qn;
            a.f_part[ic] = Fsuf * h;
        } else {
            F1b += static_cast<double>(c + 1) * Qn;
        }
        if (r_cell)
            a.R_part[ic] = abb * h;
        else
            a1b += abb;
        P = Pc;
        Qn = Qc;
        cum_next = cum;
    }
    q0b += Qn;  // node 0 (cumF_0 = 0 is no input)
    a.bars[e] = q0b;
    a.bars[(size_t)E + e] = P + q0b * we;
    a.bars[2 * (size_t)E + e] = q0b * we;
    if (!r_cell) a.R_part[e] = a1b * h;
    if (!f_cell) a.f_part[e] = F1b * h;
}

// grid over max(E, B)
__global__ void __launch_bounds__(VJP_THREADS) expand_vjp_fold_kernel(
    int E, int B, int K, const int* __restrict__ bif_in, const int* __restrict__ bif_out,
    const int* __restrict__ edge_tgt, const double* __restrict__ lam_bar,
    const double* __restrict__ bars, double* __restrict__ rho, double* __restrict__ Ftot_adj)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < E && edge_tgt[i] < 0) Ftot_adj[i] = 0.0;
    if (i >= B) return;
    const int in = bif_in[i];
    double r = lam_bar[i] - bars[2 * (size_t)E + in];
    for (int j = 0; j < K; ++j) {
        const int o = bif_out[(size_t)i * K + j];
        if (o >= 0) r = r + bars[(size_t)E + o];
    }
    rho[i] = r;
    Ftot_adj[in] = r;
}

}  // namespace

// K5's transpose over the a->E edges, one launch.
extern "C" int nxfx_expand_vjp(const ExpandVjpArgs* a, cudaStream_t stream)
{
    if (a->E < 0 || a->N < 1 || a->k < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (a->E == 0) return 0;
    expand_vjp_kernel<<<(a->E + VJP_THREADS - 1) / VJP_THREADS, VJP_THREADS, 0, stream>>>(*a);
    return static_cast<int>(cudaGetLastError());
}

// The fold into rho (B,) and Ftot_adj (E,), one launch.
extern "C" int nxfx_expand_vjp_fold(int E, int B, int K, const int* bif_in, const int* bif_out,
                                    const int* edge_tgt, const double* lam_bar,
                                    const double* bars, double* rho, double* Ftot_adj,
                                    cudaStream_t stream)
{
    if (E < 0 || B < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int n = E > B ? E : B;
    if (n == 0) return 0;
    expand_vjp_fold_kernel<<<(n + VJP_THREADS - 1) / VJP_THREADS, VJP_THREADS, 0, stream>>>(
        E, B, K, bif_in, bif_out, edge_tgt, lam_bar, bars, rho, Ftot_adj);
    return static_cast<int>(cudaGetLastError());
}
