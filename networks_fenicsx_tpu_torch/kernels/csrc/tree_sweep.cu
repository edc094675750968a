// K2 + K3 + K4: level-blocked elimination of the bifurcation Laplacian on a
// uniformly-K-ary forest, and the back-substitution of the multipliers.
//
// Replaces networks_fenicsx_tpu/solver.py:_blocked_forward_factor (K2),
// _blocked_forward_apply (K3) and _blocked_backward (K4), i.e.
// _blocked_eliminate.  Per bifurcation b (internal order) with in-edge i
// and out-edges o_j:
//   assemble:  d_b = w_i + sum_j w_oj,   r_b = (const_i + Ftot_i) - sum_j const_oj
//   |r|^2 over the unfolded r (the convergence gate's rhs norm)
//   fold, bottom-up: for each child c of b in slot order
//              d_b += sum_c -wn_c (wn_c / d_c),   r_b += sum_c (wn_c / d_c) r_c
//   back-sub, top-down:  lam_root = r / d,  lam_c = (r_c + wn_c lam_parent) / d_c
//
// Subtree-blocked: the host plan (blocked.SweepPlan, checked when it is
// made) cuts the forest at a level c.  The top, levels 0 .. c-1, is one
// block's work; the subtrees rooted at level c are shared out to the
// blocks of a grid, `group` subtrees a block.  The blocked layout puts
// child s of position p of level l at position s m_l + p of level l + 1,
// so a subtree block's nodes at level l are R_l = m_l / m_c runs of g_b
// consecutive positions at stride m_c; the level table row
// (offset, m, children, R, P) gives them, P the runs above l in a subtree.
// A full sweep is three launches:
//   1. subtree forward: each block assembles its nodes into shared memory
//      (one pass over all its levels), folds them bottom-up with a barrier
//      a level, writes d, r, wn and its sum of r^2 (its threads' strided
//      sums, then a halving tree);
//   2. top, one block: assembles the top, folds level c (the subtree roots,
//      from launch 1) into c - 1 and up to the roots, sums the blocks'
//      partials and the top's r^2 in a fixed order into the norm, solves
//      the roots and back-substitutes down to level c - 1;
//   3. subtree back: each block stages its d, r, wn and back-substitutes
//      its levels from its roots' parents' lam.
// The sharded blocked solve splits the sweep at level 0 (its shards'
// forward stops at their chunk roots): the forward half is launches 1 and
// 2 without the root solve (sum r^2, no square root), the backward half
// the top's back-substitution from a level 0 the caller wrote, then 3.
// Factor reuse splits it by channel (the reference's _blocked_forward_factor
// and _blocked_forward_apply): FACTOR is launches 1 and 2 on d alone, and
// writes d, wn and factor = wn / d of every bifurcation (d final: its
// children are folded); APPLY assembles r alone and folds it with the
// stored factor (factor r, the product the full sweep forms from the same
// bits), then the norm, the roots and launch 3 as the full sweep.
//
// A sweep (batch.solve_sweep) runs S scenarios in the same launches: the
// scenario is one more grid dimension (y of the subtree launches, x of the
// top's, min(S, 65,535) of them, each block looping over the scenarios
// y, y + gridDim.y, ... with a barrier between two).  Each pointer moves by
// its own stride a scenario: w; const and Ftot; d, wn and the factor (0 in
// APPLY on one stored factor that all scenarios share); r and lam; the
// partials by the plan's blocks and the norm by one.  The shared scratch
// (the halving tree's lanes, the values) and the partials are a
// scenario's while its block walks it.  Each scenario does the
// one-scenario arithmetic in the same order, so its outputs are its own
// launch's bit for bit.  The one-scenario calls pass S = 1.
//
// Bound: the dependency depth (2 L levels) at a barrier and a division a
// level; the bytes (a few MB at 16 generations) take a microsecond.  The
// parent gathers its children (no atomics), first summing the siblings'
// terms in slot order and then adding to its own entry, the division is
// the IEEE one, so d, r, wn and lam are those of the level-by-level
// plain version to the bit; the norm's order is the one above
// (tree_sweep.tree_sweep_blocked_plain runs it).  Nothing read after a
// barrier is __restrict__.

#include <cuda_runtime.h>

namespace {

struct Lvl {
    int off, m, nb, R, P;  // a level's table row (blocked.LEVEL_WORDS)
};

enum Channel { BOTH = 0, D_ONLY = 1, R_ONLY = 2 };  // what a launch assembles and folds

struct SweepArgs {
    int Kmax, L, cut, group, blocks, first;
    int S;                     // scenarios
    long long sw, sc, sd, sr;  // strides a scenario: w; cst, Ftot; d, wn, fac; r, lam
    const int* levels;
    const int* bif_in;
    const int* bif_out;
    const int* bif_parent;
    const double* w;
    const double* cst;
    const double* Ftot;
    double* d;
    double* r;
    double* wn;
    double* lam;
    double* fac;  // factor = wn / d per bifurcation: FACTOR writes it, APPLY reads it
    double* partial;
    double* out;
};

// p moved by n elements; a mode's unused (null) pointers stay null
template <typename T>
__device__ __forceinline__ T* moved(T* p, long long n)
{
    return p ? p + n : p;
}

// scenario s's view of the arguments: its pointers moved by their strides
__device__ __forceinline__ SweepArgs scenario(const SweepArgs& a0, int s)
{
    SweepArgs a = a0;
    a.w = moved(a0.w, s * a0.sw);
    a.cst = moved(a0.cst, s * a0.sc);
    a.Ftot = moved(a0.Ftot, s * a0.sc);
    a.d = moved(a0.d, s * a0.sd);
    a.wn = moved(a0.wn, s * a0.sd);
    a.fac = moved(a0.fac, s * a0.sd);
    a.r = moved(a0.r, s * a0.sr);
    a.lam = moved(a0.lam, s * a0.sr);
    a.partial = moved(a0.partial, static_cast<long long>(s) * a0.blocks);
    a.out = moved(a0.out, s);
    return a;
}

// a bifurcation's unfolded d and in-edge conductance, and its r: the row's
// -1 pads trail its edges
__device__ __forceinline__ void assemble_d(const SweepArgs& a, int b, double& db, double& wb)
{
    const int ie = a.bif_in[b];
    const double w_in = a.w[ie];
    double dd = w_in;
    const int* row = a.bif_out + static_cast<size_t>(b) * a.Kmax;
#pragma unroll 4
    for (int j = 0; j < a.Kmax; ++j) {
        const int oe = row[j];
        if (oe >= 0) dd = dd + a.w[oe];
    }
    db = dd;
    wb = w_in;
}

__device__ __forceinline__ double assemble_r(const SweepArgs& a, int b)
{
    const int ie = a.bif_in[b];
    double rr = a.cst[ie] + a.Ftot[ie];
    const int* row = a.bif_out + static_cast<size_t>(b) * a.Kmax;
#pragma unroll 4
    for (int j = 0; j < a.Kmax; ++j) {
        const int oe = row[j];
        if (oe >= 0) rr = rr - a.cst[oe];
    }
    return rr;
}

// the children ci(0 .. nb-1) of a parent folded into its (dp, rp), in slot
// order: both channels, d alone, or r alone with the stored factor (f)
template <int CH, typename ChildIndex>
__device__ __forceinline__ void fold_into(int nb, ChildIndex ci, const double* d, const double* r,
                                          const double* wn, const double* f, double* dp, double* rp)
{
    double upd_d = 0.0, upd_r = 0.0;
    for (int s = 0; s < nb; ++s) {
        const int c = ci(s);
        const double factor = CH == R_ONLY ? f[c] : wn[c] / d[c];
        if (CH != R_ONLY) {
            const double cd = -wn[c] * factor;
            upd_d = s == 0 ? cd : upd_d + cd;
        }
        if (CH != D_ONLY) {
            const double cr = factor * r[c];
            upd_r = s == 0 ? cr : upd_r + cr;
        }
    }
    if (CH != R_ONLY) *dp = *dp + upd_d;
    if (CH != D_ONLY) *rp = *rp + upd_r;
}

// the block's sum of its threads' s (thread 0's result): a halving tree
// over blockDim.x (a power of two), its last five steps by shuffles in the
// first warp (the same pairs in the same order)
__device__ double block_sum(double s, double* part)
{
    part[threadIdx.x] = s;
    __syncthreads();
    for (int stride = blockDim.x / 2; stride >= 32; stride >>= 1) {
        if (threadIdx.x < stride) part[threadIdx.x] += part[threadIdx.x + stride];
        __syncthreads();
    }
    double v = 0.0;
    if (threadIdx.x < 32) {
        v = part[threadIdx.x];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    }
    return v;
}

// shared memory: the halving tree's lanes, the level table, then the values
__device__ __forceinline__ const Lvl* stage_table(const SweepArgs& a, unsigned char* smem, double** values)
{
    double* part = reinterpret_cast<double*>(smem);
    int* tab = reinterpret_cast<int*>(part + blockDim.x);
    for (int i = threadIdx.x; i < a.L * 5; i += blockDim.x) tab[i] = a.levels[i];
    *values = reinterpret_cast<double*>(tab + (a.L * 5 + 1) / 2 * 2);
    __syncthreads();
    return reinterpret_cast<const Lvl*>(tab);
}

// A subtree block's view: its first subtree q0 and its g_b subtrees; local
// node g_b P_l + i of level l (i = run g_b + j) is position run m_c + q0 + j.
struct Block {
    int c, mc, q0, gb, n;

    __device__ Block(const SweepArgs& a, const Lvl* lv)
    {
        c = a.cut;
        mc = lv[c].m;
        q0 = blockIdx.x * a.group;
        gb = min(a.group, mc - q0);
        n = gb * (lv[a.L - 1].P + lv[a.L - 1].R);
    }
    __device__ int node(const Lvl* lv, int l, int i) const
    {
        const int run = i / gb;
        return lv[l].off + run * mc + q0 + (i - run * gb);
    }
    __device__ int level_of(const Lvl* lv, int L, int k) const
    {
        int l = c;
        while (l + 1 < L && k >= gb * lv[l + 1].P) ++l;
        return l;
    }
};

// Launch 1: assemble, fold and write the block's subtrees; its sum of r^2.
// SMEM: the values in shared memory (local order), else in d, r, wn.  CH:
// the channels; R_ONLY keeps the stored factor where the others keep d, and
// D_ONLY writes the factor of every node (its d is final after the fold).
template <bool SMEM, int CH>
__device__ void subtree_forward(const SweepArgs& a)
{
    extern __shared__ __align__(16) unsigned char smem[];
    double* vals;
    const Lvl* lv = stage_table(a, smem, &vals);
    const Block bk(a, lv);
    double* vd = SMEM ? vals : a.d;
    double* vr = SMEM ? vals + bk.n : a.r;
    double* vwn = SMEM ? vals + 2 * bk.n : a.wn;
    const double* vf = SMEM ? vals : a.fac;
    auto at = [&](int l, int i) { return SMEM ? bk.gb * lv[l].P + i : bk.node(lv, l, i); };

    double s = 0.0;
    for (int k = threadIdx.x; k < bk.n; k += blockDim.x) {
        const int l = bk.level_of(lv, a.L, k);
        const int b = bk.node(lv, l, k - bk.gb * lv[l].P);
        const int x = SMEM ? k : b;
        if (CH != R_ONLY) {
            double db, wb;
            assemble_d(a, b, db, wb);
            vd[x] = db;
            vwn[x] = wb;
        } else if (SMEM) {
            vals[k] = a.fac[b];
        }
        if (CH != D_ONLY) {
            const double rb = assemble_r(a, b);
            vr[x] = rb;
            s += rb * rb;
        }
    }
    __syncthreads();
    for (int l = a.L - 2; l >= bk.c; --l) {
        const int nb = lv[l].nb, R = lv[l].R, cnt = bk.gb * R;
        for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
            const int run = i / bk.gb, j = i - run * bk.gb;
            const int p = at(l, i);
            fold_into<CH>(nb, [&](int sl) { return at(l + 1, (sl * R + run) * bk.gb + j); }, vd, vr, vwn,
                          vf, vd + p, vr + p);
        }
        __syncthreads();
    }
    if (SMEM || CH == D_ONLY) {
        for (int k = threadIdx.x; k < bk.n; k += blockDim.x) {
            const int l = bk.level_of(lv, a.L, k);
            const int b = bk.node(lv, l, k - bk.gb * lv[l].P);
            const int x = SMEM ? k : b;
            if (CH != R_ONLY) {
                a.d[b] = vd[x];
                a.wn[b] = vwn[x];
            }
            if (CH != D_ONLY) a.r[b] = vr[x];
            if (CH == D_ONLY) a.fac[b] = vwn[x] / vd[x];
        }
    }
    if (CH == D_ONLY) return;
    const double total = block_sum(s, reinterpret_cast<double*>(smem));
    if (threadIdx.x == 0) a.partial[blockIdx.x] = total;
}

template <bool SMEM, int CH>
__global__ void subtree_forward_kernel(SweepArgs a)
{
    for (int s = blockIdx.y; s < a.S; s += gridDim.y) {
        subtree_forward<SMEM, CH>(scenario(a, s));
        __syncthreads();
    }
}

// Launch 3: the block's levels from max(cut, first) down, the first of them
// from its parents' lam (bif_parent; r / d at a root).
template <bool SMEM>
__device__ void subtree_back(const SweepArgs& a)
{
    extern __shared__ __align__(16) unsigned char smem[];
    double* vals;
    const Lvl* lv = stage_table(a, smem, &vals);
    const Block bk(a, lv);
    const double* vd = SMEM ? vals : a.d;
    const double* vr = SMEM ? vals + bk.n : a.r;
    const double* vwn = SMEM ? vals + 2 * bk.n : a.wn;
    double* vlam = SMEM ? vals + 3 * bk.n : a.lam;
    auto at = [&](int l, int i) { return SMEM ? bk.gb * lv[l].P + i : bk.node(lv, l, i); };
    if (SMEM) {
        for (int k = threadIdx.x; k < bk.n; k += blockDim.x) {
            const int l = bk.level_of(lv, a.L, k);
            const int b = bk.node(lv, l, k - bk.gb * lv[l].P);
            vals[k] = a.d[b];
            vals[bk.n + k] = a.r[b];
            vals[2 * bk.n + k] = a.wn[b];
        }
        __syncthreads();
    }
    const int lf = max(bk.c, a.first);
    for (int l = lf; l < a.L; ++l) {
        const int cnt = bk.gb * lv[l].R;
        for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
            const int x = at(l, i);
            const int b = bk.node(lv, l, i);
            double v;
            if (l == lf) {
                const int p = a.bif_parent[b];
                v = p < 0 ? vr[x] / vd[x] : (vr[x] + vwn[x] * a.lam[p]) / vd[x];
            } else {
                const int run = i / bk.gb, j = i - run * bk.gb;
                const double lp = vlam[at(l - 1, (run % lv[l - 1].R) * bk.gb + j)];
                v = (vr[x] + vwn[x] * lp) / vd[x];
            }
            vlam[x] = v;
            if (SMEM) a.lam[b] = v;
        }
        __syncthreads();
    }
}

template <bool SMEM>
__global__ void subtree_back_kernel(SweepArgs a)
{
    for (int s = blockIdx.y; s < a.S; s += gridDim.y) {
        subtree_back<SMEM>(scenario(a, s));
        __syncthreads();
    }
}

enum TopMode { FULL = 0, FORWARD = 1, BACKWARD = 2, FACTOR = 3, APPLY = 4 };

// Launch 2, one block: the top's fold (from level cut's folded values),
// the norm, the roots' solve and the back-substitution (FULL); the fold
// and sum r^2 (FORWARD); the back-substitution from the caller's level 0
// (BACKWARD); the fold of d alone, writing d, wn and the factor (FACTOR);
// FULL on r alone, d, wn and the factor read (APPLY).  The top's values in
// shared memory by internal position.
template <int CH>
__device__ void top_fold(const SweepArgs& a, const Lvl* lv, double* vd, double* vr, double* vwn)
{
    for (int l = a.cut - 1; l >= 0; --l) {
        const int nb = lv[l].nb, m = lv[l].m, off = lv[l].off;
        if (nb == 0) continue;  // the deepest level (block-uniform)
        const int off1 = lv[l + 1].off;
        const bool below = l + 1 == a.cut;  // the children are the subtree roots
        for (int p = threadIdx.x; p < m; p += blockDim.x) {
            auto ci = [&](int sl) { return off1 + sl * m + p; };
            if (below)
                fold_into<CH>(nb, ci, a.d, a.r, a.wn, a.fac, vd + off + p, vr + off + p);
            else
                fold_into<CH>(nb, ci, vd, vr, vwn, a.fac, vd + off + p, vr + off + p);
        }
        __syncthreads();
    }
}

__device__ void top_body(const SweepArgs& a, int mode, int top)
{
    extern __shared__ __align__(16) unsigned char smem[];
    double* vals;
    const Lvl* lv = stage_table(a, smem, &vals);
    const int c = a.cut;
    double* vd = vals;
    double* vr = vals + top;
    double* vwn = vals + 2 * top;
    double* vlam = vals + 3 * top;
    if (mode != BACKWARD) {
        double s = 0.0;
        if (mode != FACTOR)
            for (int i = threadIdx.x; i < a.blocks; i += blockDim.x) s += a.partial[i];
        for (int b = threadIdx.x; b < top; b += blockDim.x) {
            if (mode != APPLY) {
                double db, wb;
                assemble_d(a, b, db, wb);
                vd[b] = db;
                vwn[b] = wb;
            } else {
                vd[b] = a.d[b];
                vwn[b] = a.wn[b];
            }
            if (mode != FACTOR) {
                const double rb = assemble_r(a, b);
                vr[b] = rb;
                s += rb * rb;
            }
        }
        __syncthreads();
        if (mode == FACTOR)
            top_fold<D_ONLY>(a, lv, vd, vr, vwn);
        else if (mode == APPLY)
            top_fold<R_ONLY>(a, lv, vd, vr, vwn);
        else
            top_fold<BOTH>(a, lv, vd, vr, vwn);
        for (int b = threadIdx.x; b < top; b += blockDim.x) {
            if (mode != APPLY) {
                a.d[b] = vd[b];
                a.wn[b] = vwn[b];
            }
            if (mode != FACTOR) a.r[b] = vr[b];
            if (mode == FACTOR) a.fac[b] = vwn[b] / vd[b];
        }
        if (mode == FACTOR) return;
        const double total = block_sum(s, reinterpret_cast<double*>(smem));
        if (threadIdx.x == 0) a.out[0] = mode == FORWARD ? total : sqrt(total);
        if (mode == FORWARD) return;
    } else {
        for (int b = threadIdx.x; b < top; b += blockDim.x) {
            vd[b] = a.d[b];
            vr[b] = a.r[b];
            vwn[b] = a.wn[b];
            if (c > 0 && b < lv[0].m) vlam[b] = a.lam[b];
        }
        __syncthreads();
    }
    for (int l = mode == BACKWARD ? 1 : 0; l < c; ++l) {
        const int m = lv[l].m, off = lv[l].off;
        for (int p = threadIdx.x; p < m; p += blockDim.x) {
            const int b = off + p;
            const double v = l == 0 ? vr[b] / vd[b]
                                    : (vr[b] + vwn[b] * vlam[lv[l - 1].off + p % lv[l - 1].m]) / vd[b];
            vlam[b] = v;
            a.lam[b] = v;
        }
        __syncthreads();
    }
}

// one block a scenario: blockIdx.x, blockIdx.x + gridDim.x, ...
__global__ void top_kernel(SweepArgs a, int mode, int top_nodes)
{
    for (int s = blockIdx.x; s < a.S; s += gridDim.x) {
        top_body(scenario(a, s), mode, top_nodes);
        __syncthreads();
    }
}

size_t table_bytes(int L) { return sizeof(int) * static_cast<size_t>((L * 5 + 1) / 2 * 2); }

// the scenarios a launch's grid row holds at once (each block loops over the rest)
int scen_grid(int S) { return S < 65535 ? S : 65535; }

template <typename Kernel>
int launch(Kernel kernel, int blocks, int threads, size_t smem, cudaStream_t stream, const SweepArgs& a)
{
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(blocks, scen_grid(a.S)), threads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

int launch_top(int mode, int top, int threads, cudaStream_t stream, const SweepArgs& a)
{
    const size_t smem = 8 * static_cast<size_t>(threads) + table_bytes(a.L) + 4 * 8 * static_cast<size_t>(top);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(top_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    top_kernel<<<scen_grid(a.S), threads, smem, stream>>>(a, mode, top);
    return static_cast<int>(cudaGetLastError());
}

template <int CH>
int launch_forward(int blocks, int threads, size_t smem, int use_smem, cudaStream_t stream, const SweepArgs& a)
{
    return use_smem ? launch(subtree_forward_kernel<true, CH>, blocks, threads, smem, stream, a)
                    : launch(subtree_forward_kernel<false, CH>, blocks, threads, smem, stream, a);
}

}  // namespace

// One sweep, or one of its parts, on a blocked.SweepPlan (mode 0 full, 1
// forward, 2 backward, 3 factor, 4 apply), for S scenarios (S = 1: one
// sweep; the strides as SweepArgs's): levels (L, 5) on the device;
// blocks subtree blocks of threads each, block_nodes the nodes of a full
// one, smem whether they keep their values in shared memory; top the top's
// nodes, top_threads its block.  out: the norm (full, apply) or sum r^2
// (forward); fac the factor (factor writes, apply reads).  Returns the
// kernels enqueued, or minus the CUDA error.
extern "C" int nxfx_tree_sweep(
    int mode, int Kmax, int L, int cut, int group, int blocks, int threads, int block_nodes, int smem,
    int top, int top_threads, const int* levels,
    const int* bif_in, const int* bif_out, const int* bif_parent,
    const double* w, const double* cst, const double* Ftot,
    double* d, double* r, double* wn, double* lam, double* fac, double* partial, double* out,
    int S, long long sw, long long sc, long long sd, long long sr, cudaStream_t stream)
{
    if (L <= 0 || S == 0) return 0;
    if (mode < FULL || mode > APPLY || S < 0) return -static_cast<int>(cudaErrorInvalidValue);
    SweepArgs a = {Kmax, L, cut, group, blocks, mode == BACKWARD ? 1 : 0, S, sw, sc, sd, sr,
                   levels, bif_in, bif_out, bif_parent, w, cst, Ftot, d, r, wn, lam, fac, partial,
                   out};
    const size_t head = 8 * static_cast<size_t>(threads) + table_bytes(L);
    const size_t fwd = head + (smem ? 3 * 8 * static_cast<size_t>(block_nodes) : 0);
    const size_t back = head + (smem ? 4 * 8 * static_cast<size_t>(block_nodes) : 0);
    int n = 0, code;
    if (mode != BACKWARD && blocks > 0) {
        code = mode == FACTOR  ? launch_forward<D_ONLY>(blocks, threads, fwd, smem, stream, a)
               : mode == APPLY ? launch_forward<R_ONLY>(blocks, threads, fwd, smem, stream, a)
                               : launch_forward<BOTH>(blocks, threads, fwd, smem, stream, a);
        if (code != 0) return -code;
        ++n;
    }
    if (mode != BACKWARD || cut >= 2) {
        if ((code = launch_top(mode, top, top_threads, stream, a)) != 0) return -code;
        ++n;
    }
    if (mode != FORWARD && mode != FACTOR && blocks > 0) {
        code = smem ? launch(subtree_back_kernel<true>, blocks, threads, back, stream, a)
                    : launch(subtree_back_kernel<false>, blocks, threads, back, stream, a);
        if (code != 0) return -code;
        ++n;
    }
    return n;
}
