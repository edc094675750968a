// K22c: the per-shard body of the distributed tree elimination, for every
// shard of one device at once.
//
// Replaces networks_fenicsx_tpu/parallel/distributed_tree.py:local_eliminate
// (:396-515) around the psum and the T solve (K22-reduce, shard_top.cu).
// A shard owns B_loc local nodes (its subtrees below T, in uniform padded
// levels, each level grouped by parent) and E_loc edges (K8a's edge data;
// their ends are remapped to [local B_loc | T Tn | -1]).  The plan's tables
// are uniform across shards, so the S shards of a device hold them stacked
// (a leading shard axis) and each kernel takes them all:
//
//   folds, one thread per target and shard (grid y), the six pull-style
//   reductions of the reference, each over a table of the target's edges
//   (-1 padded, the reference's sel composed into its fold): with
//   w_e = 1 / W_e and const_e = (-p_s [s no bif] + p_e [t no bif] - g_e) / W_e,
//     local:  d = sum_t w + sum_s w   (1 where it is 0: a padding slot)
//             r = sum_t (const + Ftot) + sum_s (-const),   wn = sum_w w
//     T:      the same sums over tT, sT, wT: the shard's T partials;
//   each shard's edge data reaches the launch through a per-stream argument
//   struct of pointers (DistFoldArgs), not a copy;
//   forward, one block a shard: levels deepest first, each parent gathering
//   its children through the plan's level folds,
//             d_p += sum_c -wn_c (wn_c / d_c),   r_p += sum_c (wn_c / d_c) r_c,
//     then the chunk roots (local level 0) into their T parents' partials;
//   back, one block a shard, after the T solve:
//     lam_j = (r_j + wn_j lam_T[root_T_j]) / d_j on level 0,
//     lam_i = (r_i + wn_i lam[parent_i]) / d_i down the levels,
//     and lam_T copied behind: lam_all = [lam (B_loc) | lam_T (Tn)], what K8b reads.
//
// Bound: the dependency depth.  A walk is 2 x (L - 1) dependent levels
// (528 on the 100k forest over 8 shards, <= 79 nodes wide); the bytes it
// moves take under a microsecond, so a level's cost is what sets the time.
// The walks are level_walk.cuh's (shared with K7), a block a shard: the
// block sized to the widest level, the level table staged in shared memory,
// a thread's own node's values copied two levels ahead by cp.async, a
// parent's children gathered as a run (the plan's folds are checked to be
// runs when the tables are built), and a level handed to the next through
// two buffers of the widest level's width (in device scratch above
// BUF_SMEM).  The arithmetic and its order are the per-shard plain
// version's: one writer per output, sums in table order, no atomics.
// Nothing read after a barrier is __restrict__.

#include <cuda_runtime.h>

#include "level_walk.cuh"

constexpr int DIST_MAX_SHARDS = 32;

// One shard's K8a edge data, what the folds read.
struct DistEdges {
    const double* W;
    const double* g;
    const double* Ftot;
    const double* spbc;
    const double* epbc;
    const int* sbif;
    const int* ebif;
};

// The edge data of a run of S <= DIST_MAX_SHARDS shards (a ctypes Structure
// of the same fields, one per calling stream, rewritten each call).
struct DistFoldArgs {
    int S;
    DistEdges e[DIST_MAX_SHARDS];
};

namespace {

using namespace level_walk;

constexpr int THREADS = 256;
constexpr int BUF_SMEM = 512;       // widest level held in shared memory

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

struct EdgeTerms {
    DistEdges e;
    __device__ double w(int i) const { return 1.0 / e.W[i]; }
    __device__ double cst(int i) const {
        const double not_s = e.sbif[i] >= 0 ? 0.0 : 1.0;
        const double not_t = e.ebif[i] >= 0 ? 0.0 : 1.0;
        return (-e.spbc[i] * not_s + e.epbc[i] * not_t - e.g[i]) / e.W[i];
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
        const double v = side == 0 ? c + et.e.Ftot[e] : -c;
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

struct Tables {
    const int* t;
    const int* s;
    const int* w;
    const int* tT;
    const int* sT;
    const int* wT;
    int Kt, Ks, Kw, KtT, KsT, KwT;
};

// grid (blocks over B_loc + Tn, S): shard s0 + blockIdx.y of the device's stack
__global__ void __launch_bounds__(THREADS) dist_folds_kernel(
    DistFoldArgs a, int s0, int B_loc, int Tn, Tables tb, double* d, double* r, double* wn,
    double* part)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y;
    const size_t s = static_cast<size_t>(s0) + j;
    const EdgeTerms et{a.e[j]};
    double dt, rt, ds, rs;
    if (i < B_loc) {
        const size_t n = s * B_loc + i;
        fold_dr(et, tb.t + n * tb.Kt, tb.Kt, 0, dt, rt);
        fold_dr(et, tb.s + n * tb.Ks, tb.Ks, 1, ds, rs);
        const double dd = dt + ds;
        d[n] = dd == 0.0 ? 1.0 : dd;
        r[n] = rt + rs;
        wn[n] = fold_w(et, tb.w + n * tb.Kw, tb.Kw);
    } else if (i < B_loc + Tn) {
        const int t = i - B_loc;
        const size_t n = s * Tn + t;
        double* p = part + s * 3 * Tn;
        fold_dr(et, tb.tT + n * tb.KtT, tb.KtT, 0, dt, rt);
        fold_dr(et, tb.sT + n * tb.KsT, tb.KsT, 1, ds, rs);
        p[t] = dt + ds;
        p[Tn + t] = rt + rs;
        p[2 * Tn + t] = fold_w(et, tb.wT + n * tb.KwT, tb.KwT);
    }
}

// one block a shard; d, r and part are written and read back: not restricted
__global__ void __launch_bounds__(WALK_MAX) dist_forward_kernel(
    int L, int B_loc, int Tn, int W, const int2* lvl, const int2* kids, const int* rfold, int Kr,
    const double* wn, double* d, double* r, double* part, double2* scratch)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    wn += static_cast<size_t>(s) * B_loc;
    d += static_cast<size_t>(s) * B_loc;
    r += static_cast<size_t>(s) * B_loc;
    kids += static_cast<size_t>(s) * B_loc;
    part += static_cast<size_t>(s) * 3 * Tn;
    rfold += static_cast<size_t>(s) * Tn * Kr;
    FwdStage* ring = reinterpret_cast<FwdStage*>(smem_raw);
    int2* meta_s = reinterpret_cast<int2*>(ring + STAGES * nt);
    double2* buf = scratch != nullptr ? scratch + static_cast<size_t>(s) * 2 * W
                                      : reinterpret_cast<double2*>(meta_s + table_rows(L));
    const int2* meta = stage_levels(L, lvl, meta_s);
    __syncthreads();
    // level 0's (-wn^2 / d, wn r / d), what the T parents gather; strides only for a level wider than the block
    const double2* terms = W > nt ? fold_run<true, true>(meta, L, ring + tid, kids, wn, d, r, buf, buf + W)
                                  : fold_run<true, false>(meta, L, ring + tid, kids, wn, d, r, buf, buf + W);
    for (int t = tid; t < Tn; t += nt) {  // level 0's terms into the T partials
        double ad = 0.0, ar = 0.0;
        for (int k = 0; k < Kr; ++k) {
            const int j = rfold[static_cast<size_t>(t) * Kr + k];
            if (j < 0) break;
            ad = k == 0 ? terms[j].x : ad + terms[j].x;
            ar = k == 0 ? terms[j].y : ar + terms[j].y;
        }
        part[t] = part[t] + ad;
        part[Tn + t] = part[Tn + t] + ar;
    }
}

__global__ void __launch_bounds__(WALK_MAX) dist_back_kernel(
    int L, int B_loc, int Tn, int W, const int2* lvl, const int* parent_pos, const int* root_T,
    const double* d, const double* r, const double* wn, const double* lam_T, double* lam,
    double* scratch)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const size_t so = static_cast<size_t>(s) * B_loc;
    d += so;
    r += so;
    wn += so;
    parent_pos += so;
    lam += static_cast<size_t>(s) * (B_loc + Tn);
    BackStage* ring = reinterpret_cast<BackStage*>(smem_raw);
    int2* meta_s = reinterpret_cast<int2*>(ring + STAGES * nt);
    double* up = scratch != nullptr ? scratch + static_cast<size_t>(s) * 2 * W
                                    : reinterpret_cast<double*>(meta_s + table_rows(L));  // the level above's lam
    const int2* meta = stage_levels(L, lvl, meta_s);
    __syncthreads();
    back_prime(meta, L, ring + tid, r, wn, d, parent_pos, nullptr);
    const int W0 = meta[0].y;
    root_T += static_cast<size_t>(s) * W0;
    for (int j = tid; j < W0; j += nt) {
        const int p = root_T[j];
        const double lp = p < Tn ? lam_T[p] : 0.0;
        const double v = (r[j] + wn[j] * lp) / d[j];
        lam[j] = v;
        up[j] = v;
    }
    __syncthreads();
    if (W > nt)
        solve_run<false, true>(meta, L, ring + tid, r, wn, d, parent_pos, nullptr, lam, nullptr, up, up + W);
    else
        solve_run<false, false>(meta, L, ring + tid, r, wn, d, parent_pos, nullptr, lam, nullptr, up, up + W);
    for (int t = tid; t < Tn; t += nt) lam[B_loc + t] = lam_T[t];
}

int walk_threads(int W)
{
    const int t = (W + 31) / 32 * 32;
    return t < 32 ? 32 : (t > WALK_MAX ? WALK_MAX : t);
}

}  // namespace

// The folds of shards s0 .. s0 + a->S - 1 of the device's stack, one grid.
extern "C" int nxfx_dist_folds(
    const DistFoldArgs* a, int s0, int B_loc, int Tn,
    const int* t_edge, int Kt, const int* s_edge, int Ks, const int* w_edge, int Kw,
    const int* tT_edge, int KtT, const int* sT_edge, int KsT, const int* wT_edge, int KwT,
    double* d, double* r, double* wn, double* part, cudaStream_t stream)
{
    const int n = B_loc + Tn;
    if (a->S < 0 || a->S > DIST_MAX_SHARDS) return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 0 || a->S == 0) return 0;
    const Tables tb{t_edge, s_edge, w_edge, tT_edge, sT_edge, wT_edge, Kt, Ks, Kw, KtT, KsT, KwT};
    dist_folds_kernel<<<dim3(blocks_for(n), a->S), THREADS, 0, stream>>>(*a, s0, B_loc, Tn, tb, d, r, wn,
                                                                       part);
    return static_cast<int>(cudaGetLastError());
}

// The forward walks of S shards, one block each; scratch (S x 2 W double2s)
// when W > BUF_SMEM, else null.
extern "C" int nxfx_dist_forward(
    int S, int L, int B_loc, int Tn, int W, const int* lvl, const int* kids, const int* rfold, int Kr,
    const double* wn, double* d, double* r, double* part, double* scratch, cudaStream_t stream)
{
    if (S <= 0) return 0;
    if (L < 1 || W < 1 || (W > BUF_SMEM) != (scratch != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = walk_threads(W);
    const size_t smem = smem_bytes(L, threads, sizeof(FwdStage), scratch != nullptr ? 0 : 2 * W * sizeof(double2));
    dist_forward_kernel<<<S, threads, smem, stream>>>(L, B_loc, Tn, W, reinterpret_cast<const int2*>(lvl),
                                                      reinterpret_cast<const int2*>(kids), rfold, Kr, wn, d, r, part,
                                                      reinterpret_cast<double2*>(scratch));
    return static_cast<int>(cudaGetLastError());
}

// The back walks of S shards, one block each; scratch (S x 2 W doubles)
// when W > 512, else null.
extern "C" int nxfx_dist_back(
    int S, int L, int B_loc, int Tn, int W, const int* lvl, const int* parent_pos, const int* root_T,
    const double* d, const double* r, const double* wn, const double* lam_T, double* lam, double* scratch,
    cudaStream_t stream)
{
    if (S <= 0) return 0;
    if (L < 1 || W < 1 || (W > BUF_SMEM) != (scratch != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = walk_threads(W);
    const size_t smem = smem_bytes(L, threads, sizeof(BackStage), scratch != nullptr ? 0 : 2 * W * sizeof(double));
    dist_back_kernel<<<S, threads, smem, stream>>>(L, B_loc, Tn, W, reinterpret_cast<const int2*>(lvl),
                                                   parent_pos, root_T, d, r, wn, lam_T, lam, scratch);
    return static_cast<int>(cudaGetLastError());
}
