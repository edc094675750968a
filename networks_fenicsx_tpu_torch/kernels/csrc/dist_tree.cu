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
// A level's chain is kept to a barrier, shared-memory reads, the sums and
// one division (the IEEE division the plain version divides by; on the
// card it is ~0.2 us of a level):
//   * the block is sized to the widest level (<= 128 threads; a wider level
//     is walked in strides), not 1,024;
//   * the level table (its bounds, one int2 a level) is staged in shared
//     memory once (read from device memory above 1,024 levels), and a
//     thread's own node's d, r, wn and run of children (forward) or r, wn,
//     d, parent (back) are copied two levels ahead by cp.async into a
//     3-stage ring of its own;
//   * a parent's children are a run of the level below (the plan groups
//     each level by parent), so it gathers them as (first, count): the
//     plan's folds are checked to be runs when the tables are built;
//   * each level's results go to device memory (the back walk and K8b read
//     them) and to a shared buffer the next level reads: the children's
//     (-wn^2 / d, wn r / d) as one double2 forward, the parents' lam back;
//     two buffers of the widest level's width (in device scratch above 512).
// The arithmetic and its order are the per-shard plain version's: one
// writer per output, sums in table order, no atomics.  Nothing read after
// a barrier is __restrict__.

#include <cuda_runtime.h>

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

constexpr int THREADS = 256;
constexpr int WALK_MAX = 128;       // a walk's block: the widest level, rounded to a warp
constexpr int AHEAD = 2;            // levels a thread's copies run ahead of its use
constexpr int STAGES = AHEAD + 1;   // the ring: AHEAD in flight, one in use
constexpr int META_SMEM = 1024;     // levels whose table rows are staged in shared memory
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

__device__ __forceinline__ void copy4(void* dst, const void* src)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copy8(void* dst, const void* src)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// this thread's copies of all but its AHEAD latest groups have landed
__device__ __forceinline__ void wait_ahead() { asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD) : "memory"); }

// A walk's shared memory: the stage ring (STAGES x blockDim), the level
// table when staged, then the level buffers when held here.
struct FwdStage {
    double d, r, wn;
    int2 kids;  // the node's first child (in the level below) and its children
};
struct BackStage {
    double r, wn, d;
    int par, pad;
};

// The level table: row l = (offs[l], offs[l + 1]); staged into shared memory
// when it fits.
__device__ const int2* stage_levels(int L, const int2* lvl, int2* smem)
{
    if (L > META_SMEM) return lvl;
    for (int l = threadIdx.x; l < L; l += blockDim.x) smem[l] = lvl[l];
    return smem;
}

// Copy ahead the stage of level lev (parents at lev - 1 gathering level lev):
// parent p = threadIdx.x's run of children and its d, r, wn.
__device__ __forceinline__ void fwd_issue(FwdStage* st, const int2* meta, int lev, const int* kids,
                                          const double* d, const double* r, const double* wn)
{
    if (lev >= 1) {
        const int2 pm = meta[lev - 1];
        if (static_cast<int>(threadIdx.x) < pm.y - pm.x) {
            const int pi = pm.x + threadIdx.x;
            copy8(&st->kids, kids + 2 * static_cast<size_t>(pi));
            copy8(&st->d, d + pi);
            copy8(&st->r, r + pi);
            copy8(&st->wn, wn + pi);
        }
    }
    commit();  // one group a level, empty or not: the waits count groups
}

__device__ __forceinline__ void back_issue(BackStage* st, const int2* meta, int lev, int L,
                                           const double* r, const double* wn, const double* d,
                                           const int* parent_pos)
{
    if (lev < L) {
        const int2 m = meta[lev];
        const int i = m.x + threadIdx.x;
        if (i < m.y) {
            copy8(&st->r, r + i);
            copy8(&st->wn, wn + i);
            copy8(&st->d, d + i);
            copy4(&st->par, parent_pos + i);
        }
    }
    commit();
}

// one block a shard; d, r and part are written and read back: not restricted
__global__ void __launch_bounds__(WALK_MAX) dist_forward_kernel(
    int L, int B_loc, int Tn, int W, const int2* lvl, const int* kids, const int* rfold, int Kr,
    const double* wn, double* d, double* r, double* part, double2* scratch)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    wn += static_cast<size_t>(s) * B_loc;
    d += static_cast<size_t>(s) * B_loc;
    r += static_cast<size_t>(s) * B_loc;
    kids += static_cast<size_t>(s) * 2 * B_loc;
    part += static_cast<size_t>(s) * 3 * Tn;
    rfold += static_cast<size_t>(s) * Tn * Kr;
    FwdStage* ring = reinterpret_cast<FwdStage*>(smem_raw);
    int2* meta_s = reinterpret_cast<int2*>(ring + STAGES * nt);
    double2* buf = scratch != nullptr ? scratch + static_cast<size_t>(s) * 2 * W
                                      : reinterpret_cast<double2*>(meta_s + (L > META_SMEM ? 0 : (L + 1) / 2 * 2));
    double2* terms = buf;  // a level's (-wn^2 / d, wn r / d), what its parents gather
    double2* next = buf + W;
    const int2* meta = stage_levels(L, lvl, meta_s);
    __syncthreads();

    FwdStage* mine = ring + tid;  // slot q of this thread: mine + q nt
    for (int k = 1; k <= AHEAD; ++k)  // slot (L - k) mod STAGES, kept non-negative
        fwd_issue(mine + ((L - k + STAGES) % STAGES) * nt, meta, L - k, kids, d, r, wn);
    {
        const int2 m = meta[L - 1];
        for (int c = tid; c < m.y - m.x; c += nt) {  // the deepest level, as folded
            const int ci = m.x + c;
            const double f = wn[ci] / d[ci];
            terms[c] = make_double2(-wn[ci] * f, f * r[ci]);
        }
    }
    __syncthreads();
    for (int lev = L - 1; lev >= 1; --lev) {
        fwd_issue(mine + ((lev + 1) % STAGES) * nt, meta, lev - AHEAD, kids, d, r, wn);  // (lev - AHEAD) mod STAGES
        wait_ahead();
        const FwdStage* st = mine + (lev % STAGES) * nt;
        const int2 pm = meta[lev - 1];
        const int op = pm.x, npar = pm.y - pm.x;
        for (int p = tid; p < npar; p += nt) {
            const bool pre = p == tid;
            const int pi = op + p;
            const int2 kc = pre ? st->kids : make_int2(kids[2 * pi], kids[2 * pi + 1]);
            double ud = 0.0, ur = 0.0;
            for (int k = 0; k < kc.y; ++k) {  // the run of children, in the fold's order
                const double2 t = terms[kc.x + k];
                ud = k == 0 ? t.x : ud + t.x;
                ur = k == 0 ? t.y : ur + t.y;
            }
            const double wp = pre ? st->wn : wn[pi];
            const double dp = (pre ? st->d : d[pi]) + ud;
            const double rp = (pre ? st->r : r[pi]) + ur;
            d[pi] = dp;
            r[pi] = rp;
            const double f = wp / dp;
            next[p] = make_double2(-wp * f, f * rp);
        }
        __syncthreads();
        double2* t = terms;
        terms = next;
        next = t;
    }
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
    double* buf = scratch != nullptr ? scratch + static_cast<size_t>(s) * 2 * W
                                     : reinterpret_cast<double*>(meta_s + (L > META_SMEM ? 0 : L));
    double* up = buf;        // the level above's lam
    double* here = buf + W;  // this level's
    const int2* meta = stage_levels(L, lvl, meta_s);
    __syncthreads();

    BackStage* mine = ring + tid;
    for (int k = 1; k <= AHEAD; ++k) back_issue(mine + (k % STAGES) * nt, meta, k, L, r, wn, d, parent_pos);
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
    for (int lev = 1; lev < L; ++lev) {
        back_issue(mine + ((lev + AHEAD) % STAGES) * nt, meta, lev + AHEAD, L, r, wn, d, parent_pos);
        wait_ahead();
        const BackStage* st = mine + (lev % STAGES) * nt;
        const int o = meta[lev].x, o1 = meta[lev].y, op = meta[lev - 1].x;
        for (int i = o + tid; i < o1; i += nt) {
            const bool pre = i == o + tid;
            const int par = pre ? st->par : parent_pos[i];
            const double v = ((pre ? st->r : r[i]) + (pre ? st->wn : wn[i]) * up[par - op])
                             / (pre ? st->d : d[i]);
            lam[i] = v;
            here[i - o] = v;
        }
        __syncthreads();
        double* t = up;
        up = here;
        here = t;
    }
    for (int t = tid; t < Tn; t += nt) lam[B_loc + t] = lam_T[t];
}

int walk_threads(int W)
{
    const int t = (W + 31) / 32 * 32;
    return t < 32 ? 32 : (t > WALK_MAX ? WALK_MAX : t);
}

size_t walk_smem(int L, int W, int threads, size_t stage, size_t buffers, bool scratch)
{
    return STAGES * threads * stage + (L > META_SMEM ? 0 : sizeof(int2) * ((L + 1) / 2 * 2))
           + (scratch ? 0 : buffers * W);
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
    const size_t smem = walk_smem(L, W, threads, sizeof(FwdStage), 2 * sizeof(double2), scratch != nullptr);
    dist_forward_kernel<<<S, threads, smem, stream>>>(L, B_loc, Tn, W, reinterpret_cast<const int2*>(lvl),
                                                      kids, rfold, Kr, wn, d, r, part,
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
    const size_t smem = walk_smem(L, W, threads, sizeof(BackStage), 2 * sizeof(double), scratch != nullptr);
    dist_back_kernel<<<S, threads, smem, stream>>>(L, B_loc, Tn, W, reinterpret_cast<const int2*>(lvl),
                                                   parent_pos, root_T, d, r, wn, lam_T, lam, scratch);
    return static_cast<int>(cudaGetLastError());
}
