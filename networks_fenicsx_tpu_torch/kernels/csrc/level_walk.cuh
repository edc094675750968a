// The level walks of a tree elimination, shared by K7 (level_eliminate.cu:
// runs of a forest's narrow levels, one block a run) and K22c
// (dist_tree.cu: every level of a shard, one block a shard).
//
// A walk is one block that takes a run of n consecutive levels in turn;
// its table row j = (start, end) of the run's level j, row 0 the shallowest.
// Each level groups its nodes by parent, so a parent's children are a run
// of the level below, named by kids = (first child relative to the level
// below, count) (checked when the tables are built).
//   forward, deepest row first, each parent gathering its children:
//     d_p += sum_c -wn_c (wn_c / d_c),   r_p += sum_c (wn_c / d_c) r_c,
//     siblings summed in order, then the sum added to the parent;
//   back, root row down:
//     lam_i = (r_i + wn_i lam[parent_i]) / d_i   (r_i / d_i at a root).
//
// Bound: the dependency depth.  The bytes a level moves take nanoseconds,
// so a level's chain sets the time, and it is kept to a barrier,
// shared-memory reads, the sums and one division (the IEEE division the
// plain versions divide by):
//   * the block is sized to the widest level (<= WALK_MAX threads; a wider
//     level is taken in strides);
//   * the run's level table is staged in shared memory (read from device
//     memory above META_SMEM levels), and a thread's own node's d, r, wn
//     and run of children (forward) or r, wn, d, parent and public index
//     (back) are copied AHEAD levels ahead by cp.async into a ring of
//     STAGES slots of its own;
//   * each level's results go to device memory and to a shared buffer the
//     next level reads: the children's (-wn^2 / d, wn r / d) as one double2
//     forward, the parents' lam back.
// One writer per output, no atomics.  Nothing read after a barrier is
// __restrict__.

#pragma once

#include <cuda_runtime.h>

namespace level_walk {

constexpr int WALK_MAX = 128;       // a walk's block: the widest level, rounded to a warp
constexpr int AHEAD = 2;            // levels a thread's copies run ahead of their use
constexpr int STAGES = AHEAD + 1;   // the ring: AHEAD in flight, one in use
constexpr int META_SMEM = 2048;     // levels of a run whose table rows are staged in shared memory

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

// A thread's stage of one level.
struct FwdStage {
    double d, r, wn;
    int2 kids;  // the node's first child (in the level below) and its children
};
struct BackStage {
    double r, wn, d;
    int par, pub;
};

// A walk's shared memory: the stage ring (STAGES x blockDim stages), the
// run's level table when staged (an even count of rows, so that what
// follows is 16-byte aligned), then the level buffers when held there.
inline __host__ __device__ int table_rows(int n) { return n > META_SMEM ? 0 : (n + 1) / 2 * 2; }

inline size_t smem_bytes(int n, int threads, size_t stage, size_t buffers)
{
    return STAGES * static_cast<size_t>(threads) * stage + sizeof(int2) * table_rows(n) + buffers;
}

// The run's table: staged into shared memory (meta_s) when it fits.
__device__ __forceinline__ const int2* stage_levels(int n, const int2* lvl, int2* meta_s)
{
    if (n > META_SMEM) return lvl;
    for (int j = threadIdx.x; j < n; j += blockDim.x) meta_s[j] = lvl[j];
    return meta_s;
}

// Copy ahead the stage of row j (its parents, at row j - 1, gathering it):
// parent threadIdx.x's run of children and its d, r, wn.
__device__ __forceinline__ void fwd_issue(FwdStage* st, const int2* meta, int j, const int2* kids,
                                          const double* d, const double* r, const double* wn)
{
    if (j >= 1) {
        const int2 pm = meta[j - 1];
        if (static_cast<int>(threadIdx.x) < pm.y - pm.x) {
            const int pi = pm.x + threadIdx.x;
            copy8(&st->kids, kids + pi);
            copy8(&st->d, d + pi);
            copy8(&st->r, r + pi);
            copy8(&st->wn, wn + pi);
        }
    }
    commit();  // one group a level, empty or not: the waits count groups
}

// Copy ahead the stage of row j: node threadIdx.x's r, wn, d, parent and,
// with pub, its public index.
__device__ __forceinline__ void back_issue(BackStage* st, const int2* meta, int j, int n, const double* r,
                                           const double* wn, const double* d, const int* parent_pos,
                                           const int* pub)
{
    if (j < n) {
        const int2 m = meta[j];
        const int i = m.x + threadIdx.x;
        if (i < m.y) {
            copy8(&st->r, r + i);
            copy8(&st->wn, wn + i);
            copy8(&st->d, d + i);
            copy4(&st->par, parent_pos + i);
            if (pub != nullptr) copy4(&st->pub, pub + i);
        }
    }
    commit();
}

// Parent p of a row (pi its position; pre: the thread's copied stage st,
// else device memory) gathers its children's terms and hands its own on.
template <bool ADD_EMPTY>
__device__ __forceinline__ void fold_parent(int p, int pi, bool pre, const FwdStage* st, const int2* kids,
                                            const double* wn, double* d, double* r, const double2* terms,
                                            double2* next)
{
    const int2 kc = pre ? st->kids : kids[pi];
    double dp = pre ? st->d : d[pi];
    double rp = pre ? st->r : r[pi];
    if (ADD_EMPTY || kc.y > 0) {
        double ud = 0.0, ur = 0.0;
        for (int k = 0; k < kc.y; ++k) {  // the run of children, in order
            const double2 t = terms[kc.x + k];
            ud = k == 0 ? t.x : ud + t.x;
            ur = k == 0 ? t.y : ur + t.y;
        }
        dp = dp + ud;
        rp = rp + ur;
        d[pi] = dp;
        r[pi] = rp;
    }
    const double wp = pre ? st->wn : wn[pi];
    const double f = wp / dp;
    next[p] = make_double2(-wp * f, f * rp);
}

// The folds of a run of n levels, deepest row first, by one block; mine is
// the thread's first ring slot (slot q at mine + q blockDim).  A parent
// without children keeps its d and r unless ADD_EMPTY (then it adds the
// empty sums, 0.0, as K22c's plain version does).  STRIDED: a level may be
// wider than the block (its threads take it in strides), else a thread
// owns one node of each level and reads it from its stage alone.  Returns
// the buffer that holds row 0's terms.
template <bool ADD_EMPTY, bool STRIDED>
__device__ double2* fold_run(const int2* meta, int n, FwdStage* mine, const int2* kids, const double* wn,
                             double* d, double* r, double2* terms, double2* next)
{
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int k = 1; k <= AHEAD; ++k)  // slot (n - k) mod STAGES, kept non-negative
        fwd_issue(mine + ((n - k + STAGES) % STAGES) * nt, meta, n - k, kids, d, r, wn);
    {
        const int2 m = meta[n - 1];
        for (int c = tid; c < m.y - m.x; c += nt) {  // the deepest row, as folded
            const int ci = m.x + c;
            const double f = wn[ci] / d[ci];
            terms[c] = make_double2(-wn[ci] * f, f * r[ci]);
        }
    }
    __syncthreads();
    for (int j = n - 1; j >= 1; --j) {
        fwd_issue(mine + ((j + 1) % STAGES) * nt, meta, j - AHEAD, kids, d, r, wn);  // (j - AHEAD) mod STAGES
        wait_ahead();
        const FwdStage* st = mine + (j % STAGES) * nt;
        const int2 pm = meta[j - 1];
        if (STRIDED) {
            for (int p = tid; p < pm.y - pm.x; p += nt)
                fold_parent<ADD_EMPTY>(p, pm.x + p, p == tid, st, kids, wn, d, r, terms, next);
        } else if (tid < pm.y - pm.x) {
            fold_parent<ADD_EMPTY>(tid, pm.x + tid, true, st, kids, wn, d, r, terms, next);
        }
        __syncthreads();
        double2* t = terms;
        terms = next;
        next = t;
    }
    return terms;
}

// Issue the copies of rows 1 .. AHEAD of a back walk (before row 0 is solved).
__device__ __forceinline__ void back_prime(const int2* meta, int n, BackStage* mine, const double* r,
                                           const double* wn, const double* d, const int* parent_pos,
                                           const int* pub)
{
    for (int k = 1; k <= AHEAD; ++k)
        back_issue(mine + (k % STAGES) * blockDim.x, meta, k, n, r, wn, d, parent_pos, pub);
}

// Node i (the c-th of its row; pre: the thread's copied stage st, else
// device memory) from its parent's lam in up (op: the row above's start).
template <bool PUB>
__device__ __forceinline__ void solve_node(int i, int c, int op, bool pre, const BackStage* st, const double* r,
                                           const double* wn, const double* d, const int* parent_pos,
                                           const int* pub, double* lam, double* lam_pub, const double* up,
                                           double* here)
{
    const int par = pre ? st->par : parent_pos[i];
    const double ri = pre ? st->r : r[i];
    const double di = pre ? st->d : d[i];
    const double v = par < 0 ? ri / di : (ri + (pre ? st->wn : wn[i]) * up[par - op]) / di;
    lam[i] = v;
    if (PUB) lam_pub[pre ? st->pub : pub[i]] = v;
    here[c] = v;
}

// The back-substitution of rows 1 .. n - 1 of a run by one block, after
// back_prime and row 0 (its lam in up, at its place in the row): lam into
// lam[i] and, with PUB, lam_pub[pub[i]].  STRIDED as for fold_run.
template <bool PUB, bool STRIDED>
__device__ void solve_run(const int2* meta, int n, BackStage* mine, const double* r, const double* wn,
                          const double* d, const int* parent_pos, const int* pub, double* lam,
                          double* lam_pub, double* up, double* here)
{
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int j = 1; j < n; ++j) {
        back_issue(mine + ((j + AHEAD) % STAGES) * nt, meta, j + AHEAD, n, r, wn, d, parent_pos,
                   PUB ? pub : nullptr);
        wait_ahead();
        const BackStage* st = mine + (j % STAGES) * nt;
        const int o = meta[j].x, o1 = meta[j].y, op = meta[j - 1].x;
        if (STRIDED) {
            for (int c = tid; o + c < o1; c += nt)
                solve_node<PUB>(o + c, c, op, c == tid, st, r, wn, d, parent_pos, pub, lam, lam_pub, up, here);
        } else if (o + tid < o1) {
            solve_node<PUB>(o + tid, tid, op, true, st, r, wn, d, parent_pos, pub, lam, lam_pub, up, here);
        }
        __syncthreads();
        double* t = up;
        up = here;
        here = t;
    }
}

}  // namespace level_walk
