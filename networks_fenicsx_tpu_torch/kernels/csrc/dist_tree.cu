// K22c: the per-shard body of the distributed tree elimination.
//
// Replaces networks_fenicsx_tpu/parallel/distributed_tree.py:local_eliminate
// (:396-515) around the psum and the T solve (K22-reduce, shard_top.cu).
// A shard owns B_loc local nodes (its subtrees below T, in uniform padded
// levels, each level grouped by parent) and E_loc edges (K8a's edge data;
// their ends are remapped to [local B_loc | T Tn | -1]).
//
//   folds, one thread per target (B_loc local nodes, then Tn T nodes), the
//   six pull-style reductions of the reference, each over a host table of
//   the target's edges (-1 padded, the reference's sel composed into its
//   fold): with w_e = 1 / W_e and const_e = (-p_s [s no bif] + p_e [t no bif]
//   - g_e) / W_e,
//     local:  d = sum_t w + sum_s w   (1 where it is 0: a padding slot)
//             r = sum_t (const + Ftot) + sum_s (-const),   wn = sum_w w
//     T:      the same sums over tT, sT, wT: the shard's T partials;
//   forward, one block: levels deepest first, each parent gathering its
//     children through the host's level folds,
//             d_p += sum_c -wn_c (wn_c / d_c),   r_p += sum_c (wn_c / d_c) r_c,
//     then the chunk roots (local level 0) into their T parents' partials;
//   back, one block, after the T solve: lam_j = (r_j + wn_j lam_T[root_T_j]) / d_j
//     on level 0, lam_i = (r_i + wn_i lam[parent_i]) / d_i down the levels,
//     and lam_T copied behind: lam_all = [lam (B_loc) | lam_T (Tn)], what K8b reads.
//
// Bound: latency.  The folds are one grid; the level walks one block each,
// a barrier between levels (the tree depth is sequential), in place of the
// reference's unrolled per-level program.  One writer per output, sums in
// table order, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WALK_THREADS = 1024;

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

struct EdgeTerms {
    const double* W;
    const double* g;
    const double* Ftot;
    const double* spbc;
    const double* epbc;
    const int* sbif;
    const int* ebif;
    __device__ double w(int e) const { return 1.0 / W[e]; }
    __device__ double cst(int e) const {
        const double not_s = sbif[e] >= 0 ? 0.0 : 1.0;
        const double not_t = ebif[e] >= 0 ? 0.0 : 1.0;
        return (-spbc[e] * not_s + epbc[e] * not_t - g[e]) / W[e];
    }
};

// (sum w, sum side-rhs) over a table row; side 0 target (const + Ftot), 1 source (-const)
__device__ void fold_dr(const EdgeTerms& et, const int* row, int K, int side, double& ad, double& ar)
{
    ad = 0.0;
    ar = 0.0;
    for (int k = 0; k < K; ++k) {
        const int e = row[k];
        if (e < 0) break;
        const double c = et.cst(e);
        const double v = side == 0 ? c + et.Ftot[e] : -c;
        ad = k == 0 ? et.w(e) : ad + et.w(e);
        ar = k == 0 ? v : ar + v;
    }
}

__device__ double fold_w(const EdgeTerms& et, const int* row, int K)
{
    double a = 0.0;
    for (int k = 0; k < K; ++k) {
        const int e = row[k];
        if (e < 0) break;
        a = k == 0 ? et.w(e) : a + et.w(e);
    }
    return a;
}

__global__ void dist_folds_kernel(
    int B_loc, int Tn, EdgeTerms et,
    const int* __restrict__ t_edge, int Kt, const int* __restrict__ s_edge, int Ks,
    const int* __restrict__ w_edge, int Kw,
    const int* __restrict__ tT_edge, int KtT, const int* __restrict__ sT_edge, int KsT,
    const int* __restrict__ wT_edge, int KwT,
    double* __restrict__ d, double* __restrict__ r, double* __restrict__ wn,
    double* __restrict__ part)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    double dt, rt, ds, rs;
    if (i < B_loc) {
        fold_dr(et, t_edge + static_cast<size_t>(i) * Kt, Kt, 0, dt, rt);
        fold_dr(et, s_edge + static_cast<size_t>(i) * Ks, Ks, 1, ds, rs);
        const double dd = dt + ds;
        d[i] = dd == 0.0 ? 1.0 : dd;
        r[i] = rt + rs;
        wn[i] = fold_w(et, w_edge + static_cast<size_t>(i) * Kw, Kw);
    } else if (i < B_loc + Tn) {
        const int t = i - B_loc;
        fold_dr(et, tT_edge + static_cast<size_t>(t) * KtT, KtT, 0, dt, rt);
        fold_dr(et, sT_edge + static_cast<size_t>(t) * KsT, KsT, 1, ds, rs);
        part[t] = dt + ds;
        part[Tn + t] = rt + rs;
        part[2 * Tn + t] = fold_w(et, wT_edge + static_cast<size_t>(t) * KwT, KwT);
    }
}

// d, r and part are read after other threads wrote them: not restricted
__global__ void __launch_bounds__(WALK_THREADS) dist_forward_kernel(
    int L, int Tn, const int* __restrict__ offs, const int* __restrict__ lf_off,
    const int* __restrict__ lf_K, const int* __restrict__ lf,
    const int* __restrict__ rfold, int Kr, const double* __restrict__ wn,
    double* d, double* r, double* part)
{
    for (int lev = L - 1; lev >= 1; --lev) {
        const int o = offs[lev], n = offs[lev + 1] - o;
        const int op = offs[lev - 1], npar = o - op;
        const int K = lf_K[lev - 1];
        const int* fold = lf + lf_off[lev - 1];
        for (int p = threadIdx.x; p < npar; p += WALK_THREADS) {
            double ud = 0.0, ur = 0.0;
            for (int k = 0; k < K; ++k) {
                const int c = fold[static_cast<size_t>(p) * K + k];
                if (c >= n) break;
                const int ci = o + c;
                const double factor = wn[ci] / d[ci];
                const double cd = -wn[ci] * factor;
                const double cr = factor * r[ci];
                ud = k == 0 ? cd : ud + cd;
                ur = k == 0 ? cr : ur + cr;
            }
            d[op + p] = d[op + p] + ud;
            r[op + p] = r[op + p] + ur;
        }
        __syncthreads();
    }
    for (int t = threadIdx.x; t < Tn; t += WALK_THREADS) {
        double ad = 0.0, ar = 0.0;
        for (int k = 0; k < Kr; ++k) {
            const int j = rfold[static_cast<size_t>(t) * Kr + k];
            if (j < 0) break;
            const double factor = wn[j] / d[j];
            const double cd = -wn[j] * factor;
            const double cr = factor * r[j];
            ad = k == 0 ? cd : ad + cd;
            ar = k == 0 ? cr : ar + cr;
        }
        part[t] = part[t] + ad;
        part[Tn + t] = part[Tn + t] + ar;
    }
}

__global__ void __launch_bounds__(WALK_THREADS) dist_back_kernel(
    int L, int B_loc, int Tn, const int* __restrict__ offs, const int* __restrict__ parent_pos,
    const int* __restrict__ root_T, const double* __restrict__ d,
    const double* __restrict__ r, const double* __restrict__ wn,
    const double* __restrict__ lam_T, double* lam)
{
    const int W0 = offs[1];
    for (int j = threadIdx.x; j < W0; j += WALK_THREADS) {
        const int p = root_T[j];
        const double lp = p < Tn ? lam_T[p] : 0.0;
        lam[j] = (r[j] + wn[j] * lp) / d[j];
    }
    __syncthreads();
    for (int lev = 1; lev < L; ++lev) {
        for (int i = offs[lev] + threadIdx.x; i < offs[lev + 1]; i += WALK_THREADS)
            lam[i] = (r[i] + wn[i] * lam[parent_pos[i]]) / d[i];
        __syncthreads();
    }
    for (int t = threadIdx.x; t < Tn; t += WALK_THREADS) lam[B_loc + t] = lam_T[t];
}

}  // namespace

extern "C" int nxfx_dist_folds(
    int B_loc, int Tn,
    const double* W, const double* g, const double* Ftot, const double* spbc,
    const double* epbc, const int* sbif, const int* ebif,
    const int* t_edge, int Kt, const int* s_edge, int Ks, const int* w_edge, int Kw,
    const int* tT_edge, int KtT, const int* sT_edge, int KsT, const int* wT_edge, int KwT,
    double* d, double* r, double* wn, double* part, cudaStream_t stream)
{
    const int n = B_loc + Tn;
    if (n <= 0) return 0;
    EdgeTerms et{W, g, Ftot, spbc, epbc, sbif, ebif};
    dist_folds_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
        B_loc, Tn, et, t_edge, Kt, s_edge, Ks, w_edge, Kw, tT_edge, KtT, sT_edge, KsT,
        wT_edge, KwT, d, r, wn, part);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_dist_forward(
    int L, int Tn, const int* offs, const int* lf_off, const int* lf_K, const int* lf,
    const int* rfold, int Kr, const double* wn, double* d, double* r, double* part,
    cudaStream_t stream)
{
    dist_forward_kernel<<<1, WALK_THREADS, 0, stream>>>(
        L, Tn, offs, lf_off, lf_K, lf, rfold, Kr, wn, d, r, part);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_dist_back(
    int L, int B_loc, int Tn, const int* offs, const int* parent_pos, const int* root_T,
    const double* d, const double* r, const double* wn, const double* lam_T, double* lam,
    cudaStream_t stream)
{
    dist_back_kernel<<<1, WALK_THREADS, 0, stream>>>(
        L, B_loc, Tn, offs, parent_pos, root_T, d, r, wn, lam_T, lam);
    return static_cast<int>(cudaGetLastError());
}
