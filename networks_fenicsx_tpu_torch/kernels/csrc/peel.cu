// K9: the peel rounds of the bifurcation Laplacian of a cyclic graph, and
// the assembly of that Laplacian from the condensed edge data.
//
// Replaces networks_fenicsx_tpu/solver.py:_tree_eliminate_factor and
// _tree_eliminate_apply (the rounds, :3678-3812), and the elementwise part
// of _lambda_system_sorted.  The diagonal d and rhs r live interleaved,
// dr[2 b] = d_b, dr[2 b + 1] = r_b.
//   prepare, per edge:  w = 1 / W,  const = (-p_s [s not bif] + p_t [t not bif] - g) / W,
//                       (w, const + Ftot) for the target side, (w, -const) for the source side
//                       (the sums into the sides' bifurcations are K6)
//   |r| over the assembled r (the convergence gate's rhs norm)
//   forward, per round, for each eliminated node e with parent p over pair q:
//       w = w_pairs[q] (0 without a parent),  db = d_e,  factor = w / db,  rb = r_e
//       saved (w, db, rb); the terms (-w factor, factor rb) folded per
//       unique parent (K10's fold, summed by the parent's thread as it reads
//       them), then d_p += fold_d,  r_p += fold_r, into a working copy of
//       the updated nodes (a node is read from the assembled system until a
//       round updates it: the table names each read's copy, so the system is
//       neither copied nor written)
//   core: (d, r) of the core nodes out, the core's solution x back in
//   back, rounds reversed:  lambda_e = (rb + w lambda_p) / db
//
// The rounds walk one packed table (ops/peel_table.py, checked once per
// executor) in a few launches a direction, their order on the host's launch
// lists.  A round needs no barrier between its terms and its fold: a unique
// parent's thread makes each child's terms as it reads its fold row (the
// products and the order of the plain version) and adds the row's sum into
// d_p and r_p; a fold of more than one level (a parent with more than 64
// children in the round) writes its earlier levels to the work buffer, a
// phase each.
//   * A round of at least the cut width (1,024 eliminated nodes) is a grid
//     launch a fold level, the launch boundary its barrier.  Its fields are
//     a kernel parameter and its first fold level is read as (child, pair)
//     entries, so a thread's chain is its entries, then their d, r and w.
//   * A run of narrower rounds is one block of 1,024 threads in shared
//     memory: the (d, r) of the nodes it touches in local slots, its
//     children's conductances and saved values, its round rows and its
//     staged words (cp.async), a __syncthreads() a round and a fold level,
//     and no device-memory store until its end (the saved stream, the
//     (d, r) of the slots it does not eliminate, their core gathers; back,
//     lambda of the slots it eliminates).
// The core's gather rides on the first forward launch (the nodes no round
// updates) and on each core node's last update (its parent's thread writes
// dc, rc; a run at its end), its scatter on the last back launch; the back
// pass reads a core parent's lambda from x, so no launch waits for the
// scatter.  (One cooperative launch a direction, a grid barrier between the
// entries, measured slower on an H100: PERF.md.)
//
// Factor reuse runs the channels apart on the same table and launches (the
// reference's _tree_eliminate_factor and _tree_eliminate_apply): the d
// channel alone (the saved w and db, the core's dc, and factor = w / d of
// each child at its fold, by node) and then, per right-hand side, the r
// channel alone with the stored factor (factor rb, the product the two-
// channel pass forms from the same bits), the core's rc, the core solve and
// the back pass on the stored w, db and the new rb.  A block run keeps a
// slot's factor where the two-channel pass keeps its d.
//
// A sweep (batch.solve_sweep on the dense route) prepares S scenarios in
// one launch (nxfx_lambda_prepare_scen): the grid's y, min(S, 65,535) rows
// of blocks walking the scenarios y, y + gridDim.y, ...; W, g, the outputs a
// row a scenario, Ftot and the boundary pressures at their own strides (0:
// shared), each edge the one-scenario kernel's operations.  Its sums are
// K6's nxfx_segsum_plan_scen; its |r| (a factorization's solve_batch reads
// it; the sweep drops it) is one more launch, a block a scenario.
//
// The rounds over S scenarios (a sweep on the tree route, a tree
// factorization's solve_batch) take the launches of one call: each launch
// of the table takes the scenario as its grid's y (min(S, 65,535) rows of
// blocks walking the scenarios y, y + gridDim.y, ...), a grid round so
// becoming gridDim.x x S blocks and a block run S blocks of 1,024 threads,
// one a scenario.  PeelArgs carries a stride per buffer (0: shared, as the
// stored d channel of R_ONLY is): each scenario has its own system, working
// copy, work buffer, saved planes, core gathers, core solution and lambda,
// and the scenario only selects base pointers, so each row is the
// one-scenario launch's bits.
//
// Bound: the rounds' dependent latency (a round is a few dependent gathers
// and a division: ~0.8 us a round forward in a run, the grid launches
// 2-6 us each), not bytes: the 100k-site web's 18 rounds move ~3 MB.
// Each eliminated node and unique parent has one thread, the elimination
// set is independent of its parents and the parents are unique, so each
// output has one writer; what a launch writes it reads after a barrier, so
// dr, the work buffer and lambda are not __restrict__.  -fmad=false keeps
// every rounding the plain version's.

#include <cuda_runtime.h>

#include "fold.cuh"
#include "level_walk.cuh"

// The launches' arguments (kernels.peel's _PeelArgs, a ctypes mirror).
enum { BOTH, D_ONLY, R_ONLY };  // the channels a call runs

struct PeelArgs {
    int has_pairs, n_peeled, B, chan;
    const int* tab;
    const double* w_pairs;
    const double* dr;  // the assembled system (B, 2), never written
    double* wk;        // (B, 2): the (d, r) of the nodes a round updated
    double* work;
    double* dc;
    double* rc;
    const double* x;
    double* lam;
    double* sw;   // the saved stream's planes (n_peeled each): w and db at
    double* sd;   // elimination (the d channel writes them), rb (the r
    double* sr;   // channel's), read back by the back pass
    double* fac;  // (B,) a child's factor w / d at its fold: D_ONLY writes, R_ONLY reads
    int S;        // scenarios (1: one call's)
    long long s_wp, s_dr, s_wk, s_work, s_dc, s_rc, s_x, s_lam, s_sw, s_sd, s_sr, s_fac;  // their strides
};

// a launch entry of the table (ops/peel_table.py), passed by value
struct PeelEntry {
    int kind, first, last, level, blocks, duty;
    int lo, hi, slots, S, bsrc, wsrc, smem, ssrc;  // a block run's staged words, slots and shared memory
};

namespace {

constexpr int THREADS = 256;
constexpr int REDUCE_THREADS = 1024;

inline int blocks_for(long long n) { return static_cast<int>((n + THREADS - 1) / THREADS); }

// edge e of one scenario
__device__ __forceinline__ void lambda_prepare_edge(
    int e,
    const double* __restrict__ W,
    const double* __restrict__ g,
    const double* __restrict__ Ftot,
    const double* __restrict__ start_pbc,
    const double* __restrict__ end_pbc,
    const int* __restrict__ start_bif,
    const int* __restrict__ end_bif,
    double* __restrict__ w_out,
    double* __restrict__ vt,   // (E, 2)
    double* __restrict__ vs)   // (E, 2)
{
    const double We = W[e];
    const double w = 1.0 / We;
    w_out[e] = w;
    vt[2 * e] = w;
    vs[2 * e] = w;
    if (g == nullptr) {  // the diagonal alone (a factor): no rhs terms
        vt[2 * e + 1] = 0.0;
        vs[2 * e + 1] = 0.0;
        return;
    }
    const double not_s = start_bif[e] >= 0 ? 0.0 : 1.0;
    const double not_t = end_bif[e] >= 0 ? 0.0 : 1.0;
    const double cst = (-start_pbc[e] * not_s + end_pbc[e] * not_t - g[e]) / We;
    vt[2 * e + 1] = cst + Ftot[e];
    vs[2 * e + 1] = -cst;
}

__global__ void lambda_prepare_kernel(
    int E, const double* W, const double* g, const double* Ftot, const double* start_pbc,
    const double* end_pbc, const int* start_bif, const int* end_bif, double* w_out, double* vt, double* vs)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    lambda_prepare_edge(e, W, g, Ftot, start_pbc, end_pbc, start_bif, end_bif, w_out, vt, vs);
}

// S scenarios: W, g, w_out a row (E) a scenario, vt, vs 2 E, Ftot, start_pbc
// and end_pbc at their strides
__global__ void lambda_prepare_scen_kernel(
    int E, int S, long long sFt, long long ssp, long long sep, const double* W, const double* g,
    const double* Ftot, const double* start_pbc, const double* end_pbc, const int* start_bif,
    const int* end_bif, double* w_out, double* vt, double* vs)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const size_t Z = static_cast<size_t>(z), sE = static_cast<size_t>(E);
        lambda_prepare_edge(e, W + Z * sE, g + Z * sE, Ftot + Z * sFt, start_pbc + Z * ssp, end_pbc + Z * sep,
                            start_bif, end_bif, w_out + Z * sE, vt + 2 * Z * sE, vs + 2 * Z * sE);
    }
}

// sqrt(sum r^2) over the rhs channel of dr, one block a scenario (dr 2 B
// apart), fixed summation order
__global__ void rhs_norm_kernel(int B, int S, const double* dr0, double* out)
{
    __shared__ double part[REDUCE_THREADS];
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const double* dr = dr0 + 2 * static_cast<size_t>(z) * B;
        double s = 0.0;
        for (int i = threadIdx.x; i < B; i += REDUCE_THREADS) {
            const double r = dr[2 * i + 1];
            s += r * r;
        }
        part[threadIdx.x] = s;
        __syncthreads();
        for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
            if (threadIdx.x < stride) part[threadIdx.x] += part[threadIdx.x + stride];
            __syncthreads();
        }
        if (threadIdx.x == 0) out[z] = sqrt(part[0]);
        __syncthreads();
    }
}


// ---------------------------------------------------------------- the rounds

// the table's layout (ops/peel_table.py)
enum { H_B, H_P, H_ROUNDS, H_NPEEL, H_NCORE, H_CORE, H_EARLY, H_NEARLY, H_WORK, H_NFWD, H_FWD, H_NBACK,
       H_BACK, HEAD_WORDS };
enum { R_N, R_U, R_OFF, R_ELIM, R_PAR, R_PID, R_BPAR, R_UPAR, R_UCORE, R_LELIM, R_LPAR, R_LUPAR, R_ESRC, R_USRC,
       R_FSRC, R_FPID, R_FOLD };
constexpr int FOLD_MAX = 8;
constexpr int FOLD_WORDS = 1 + 4 * FOLD_MAX;
constexpr int ROUND_WORDS = R_FOLD + FOLD_WORDS;
enum { E_KIND, E_FIRST, E_LAST, E_LEVEL, E_BLOCKS, E_DUTY, E_LO, E_HI, E_SLOTS, E_S, E_BSRC, E_WSRC, E_SMEM,
       E_SSRC, ENTRY_WORDS };
enum { GRID, BLOCK, DUTY };
constexpr int GRID_THREADS = 256;   // a grid entry's block
constexpr int BLOCK_THREADS = 1024;  // a block entry's

__device__ __forceinline__ const int* round_row(const int* tab, int k)
{
    return tab + HEAD_WORDS + static_cast<size_t>(k) * ROUND_WORDS;
}

inline PeelEntry entry_at(const int* w)
{
    return {w[E_KIND], w[E_FIRST], w[E_LAST], w[E_LEVEL], w[E_BLOCKS], w[E_DUTY], w[E_LO],
            w[E_HI], w[E_SLOTS], w[E_S], w[E_BSRC], w[E_WSRC], w[E_SMEM], w[E_SSRC]};
}

// a node's current (d, r): source v < B in the assembled system, B + v in
// the working copy (a round updated it)
__device__ __forceinline__ const double* current(const PeelArgs& A, int src)
{
    return src < A.B ? A.dr + 2 * static_cast<size_t>(src) : A.wk + 2 * static_cast<size_t>(src - A.B);
}

// the node of a source (see current)
__device__ __forceinline__ int node_of(const PeelArgs& A, int src) { return src < A.B ? src : src - A.B; }

// One round's fields and one of its fold levels, as a grid launch takes
// them (a kernel parameter: no load of the table's round row).
struct GridRound {
    int n, off, elim, par, pid, bpar, upar, ucore, esrc, usrc, fsrc, fpid;
    int L, l, idx, rows, K, out, prev_out, prev_rows;  // fold level l of L
};

inline GridRound grid_round(const int* tab, int k, int l)
{
    const int* rw = tab + HEAD_WORDS + static_cast<size_t>(k) * ROUND_WORDS;
    const int* f = rw + R_FOLD;
    const int* lv = f + 1 + 4 * l;
    return {rw[R_N], rw[R_OFF], rw[R_ELIM], rw[R_PAR], rw[R_PID], rw[R_BPAR], rw[R_UPAR], rw[R_UCORE],
            rw[R_ESRC], rw[R_USRC], rw[R_FSRC], rw[R_FPID], f[0], l, lv[0], f[0] ? lv[1] : 0, lv[2], lv[3],
            l ? lv[-1] : 0, l ? lv[-3] : 0};
}

// phase g.l of a round forward: level 0 writes the saved (w, db, rb) of the
// round's nodes; each row of the fold level is summed (level 0 making the
// children's terms as it reads them, from the row's children and pairs),
// into the work buffer or, on the last level, into its parent (and the
// parent's core slot on its last update)
__device__ void forward_phase(const PeelArgs& A, const GridRound& g, int tid, int nth)
{
    const int* tab = A.tab;
    const int items = (g.l == 0 && g.n > g.rows) ? g.n : g.rows;
    double* sw = A.sw + g.off;
    double* sd = A.sd + g.off;
    double* sr = A.sr + g.off;
    for (int t = tid; t < items; t += nth) {
        if (g.l == 0 && t < g.n) {
            const double* v = current(A, tab[g.esrc + t]);
            if (A.chan != R_ONLY) {
                const int q = tab[g.pid + t];
                sw[t] = (A.has_pairs && tab[g.par + t] >= 0) ? A.w_pairs[q >= 0 ? q : 0] : 0.0;
                sd[t] = v[0];
            }
            if (A.chan != D_ONLY) sr[t] = v[1];
        }
        if (t >= g.rows) continue;
        const int K = g.K;
        double s0 = 0.0, s1 = 0.0;
        if (g.l == 0) {
            const int* node = tab + g.fsrc + static_cast<size_t>(t) * K;
            const int* pair = tab + g.fpid + static_cast<size_t>(t) * K;
#pragma unroll 4
            for (int j = 0; j < K; ++j) {
                const int e = node[j];
                const int q = pair[j];
                double v0 = 0.0, v1 = 0.0;
                if (e >= 0) {
                    const double* v = current(A, e);
                    if (A.chan == R_ONLY) {
                        v1 = A.fac[node_of(A, e)] * v[1];
                    } else {
                        const double w = (A.has_pairs && q >= 0) ? A.w_pairs[q] : 0.0;
                        const double factor = w / v[0];
                        v0 = -w * factor;
                        v1 = factor * v[1];
                        if (A.chan == D_ONLY) A.fac[node_of(A, e)] = factor;
                    }
                }
                s0 = j == 0 ? v0 : s0 + v0;
                s1 = j == 0 ? v1 : s1 + v1;
            }
        } else {
            const int* row = tab + g.idx + static_cast<size_t>(t) * K;
            const double* src = A.work + g.prev_out;  // level l - 1's output and its rows
            if (A.chan != R_ONLY) s0 = fold::row_sum(row, K, src, g.prev_rows, 2, 0);
            if (A.chan != D_ONLY) s1 = fold::row_sum(row, K, src, g.prev_rows, 2, 1);
        }
        if (g.l < g.L - 1) {
            double* out = A.work + g.out;
            out[2 * t] = s0;
            out[2 * t + 1] = s1;
        } else {
            const int p = tab[g.upar + t];
            const double* v = current(A, tab[g.usrc + t]);
            const int c = tab[g.ucore + t];
            if (A.chan != R_ONLY) {
                const double d = v[0] + s0;
                A.wk[2 * p] = d;
                if (c >= 0) A.dc[c] = d;
            }
            if (A.chan != D_ONLY) {
                const double r = v[1] + s1;
                A.wk[2 * p + 1] = r;
                if (c >= 0) A.rc[c] = r;
            }
        }
    }
}

// a round back: lambda_e = (rb + w lambda_parent) / db, a core parent's from x
__device__ void back_round(const PeelArgs& A, const GridRound& g, int tid, int nth)
{
    const int* tab = A.tab;
    const double* sw = A.sw + g.off;
    const double* sd = A.sd + g.off;
    const double* sr = A.sr + g.off;
    for (int t = tid; t < g.n; t += nth) {
        const int p = tab[g.bpar + t];
        const double lp = p >= 0 ? A.lam[p] : (p == -1 ? 0.0 : A.x[-2 - p]);
        A.lam[tab[g.elim + t]] = (sr[t] + sw[t] * lp) / sd[t];
    }
}

// the core nodes no round updates: (dc, rc) from the assembled system
__device__ void gather_duty(const PeelArgs& A, int tid, int nth)
{
    const int* tab = A.tab;
    const int n = tab[H_NEARLY];
    const int* early = tab + tab[H_EARLY];
    const int* core = tab + tab[H_CORE];
    for (int t = tid; t < n; t += nth) {
        const int c = early[t];
        const int b = core[c];
        if (A.chan != R_ONLY) A.dc[c] = A.dr[2 * b];
        if (A.chan != D_ONLY) A.rc[c] = A.dr[2 * b + 1];
    }
}

// the core's solution into lambda
__device__ void scatter_duty(const PeelArgs& A, int tid, int nth)
{
    const int* tab = A.tab;
    const int n = tab[H_NCORE];
    const int* core = tab + tab[H_CORE];
    for (int t = tid; t < n; t += nth) A.lam[core[t]] = A.x[t];
}

// A staging loop with UNROLL items a thread in flight at once: load(i) for
// i < n, a thread's items all loaded before any is stored
constexpr int UNROLL = 4;

template <typename Load, typename Store>
__device__ __forceinline__ void stage(int n, Load load, Store store)
{
    for (int j = threadIdx.x; j < n; j += UNROLL * blockDim.x) {
        decltype(load(0)) v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int i = j + u * blockDim.x;
            if (i < n) v[u] = load(i);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int i = j + u * blockDim.x;
            if (i < n) store(i, v[u]);
        }
    }
}

// n items from device to shared memory by cp.async, a thread's every
// blockDim-th; the caller waits (wait_copies) before its barrier
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n)
{
    static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async copies 4 or 8 bytes here");
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        if constexpr (sizeof(T) == 4)
            level_walk::copy4(dst + j, src + j);
        else
            level_walk::copy8(dst + j, src + j);
    }
}

__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

struct Triple {
    double a, b, c;
};

// A block run in shared memory: its round rows and its staged words [lo, hi)
// (the rounds' local slots, core gathers and fold levels), after the run's
// values; `base` is the saved offset of its first round.
struct Run {
    const int* rows;
    const int* reg;
    int first, lo, base, n;

    __device__ const int* row(int k) const { return rows + (k - first) * ROUND_WORDS; }
    __device__ const int* at(int off) const { return reg + (off - lo); }
};

// start copying the run's round rows and staged words into `words`
// (cp.async: the caller waits before its barrier)
__device__ Run stage_run(const PeelArgs& A, const PeelEntry& e, int* words)
{
    const int nr = e.last - e.first;
    const int* rows = round_row(A.tab, e.first);
    const int* last = round_row(A.tab, e.last - 1);
    copy_async(words, rows, nr * ROUND_WORDS);
    int* reg = words + nr * ROUND_WORDS;
    copy_async(reg, A.tab + e.lo, e.hi - e.lo);
    return Run{words, reg, e.first, e.lo, rows[R_OFF], last[R_OFF] + last[R_N] - rows[R_OFF]};
}

// the doubles before a run's words: the (d, r) of its slots (back: their
// lambda) and its children's saved (w, d, r)
__device__ __forceinline__ int run_doubles(const PeelArgs& A, const PeelEntry& e, bool forward)
{
    const int* first = round_row(A.tab, e.first);
    const int* last = round_row(A.tab, e.last - 1);
    const int n = last[R_OFF] + last[R_N] - first[R_OFF];
    return (forward ? 2 : 1) * e.S + 3 * n;
}

// phase l of round k of a block run forward, on shared memory: D, Rr the
// slots' (d, r) (R_ONLY: D their factors), Sw, Sd, Sr the run's children's
// saved (w, d, r); slots the run's nodes (D_ONLY writes their factors)
__device__ void run_forward_phase(const PeelArgs& A, const Run& run, int k, int l, double* D, double* Rr,
                                  const double* Sw, double* Sd, double* Sr, double* work, const int* slots)
{
    const int* rw = run.row(k);
    const int n = rw[R_N];
    const int q0 = rw[R_OFF] - run.base;
    const int* lelim = run.at(rw[R_LELIM]);
    const double* Wk = Sw + q0;
    const int* f = rw + R_FOLD;
    const int L = f[0];
    const int* lv = f + 1 + 4 * l;
    const int rows = L ? lv[1] : 0;
    const int items = (l == 0 && n > rows) ? n : rows;
    double* sd = Sd + q0;
    double* sr = Sr + q0;
    for (int t = threadIdx.x; t < items; t += blockDim.x) {
        if (l == 0 && t < n) {
            const int s = lelim[t];
            if (A.chan != R_ONLY) sd[t] = D[s];
            if (A.chan != D_ONLY) sr[t] = Rr[s];
        }
        if (t >= rows) continue;
        const int K = lv[2];
        const int* row = run.at(lv[0]) + static_cast<size_t>(t) * K;
        double s0 = 0.0, s1 = 0.0;
        if (l == 0) {
#pragma unroll 4
            for (int j = 0; j < K; ++j) {
                const int i = row[j];
                double v0 = 0.0, v1 = 0.0;
                if (i >= 0 && i < n) {
                    const int c = lelim[i];
                    if (A.chan == R_ONLY) {
                        v1 = D[c] * Rr[c];
                    } else {
                        const double w = Wk[i];
                        const double factor = w / D[c];
                        v0 = -w * factor;
                        v1 = factor * Rr[c];
                        if (A.chan == D_ONLY) A.fac[slots[c]] = factor;
                    }
                }
                s0 = j == 0 ? v0 : s0 + v0;
                s1 = j == 0 ? v1 : s1 + v1;
            }
        } else {
            const double* src = work + lv[-1];  // level l - 1's output and its rows
            if (A.chan != R_ONLY) s0 = fold::row_sum(row, K, src, lv[-3], 2, 0);
            if (A.chan != D_ONLY) s1 = fold::row_sum(row, K, src, lv[-3], 2, 1);
        }
        if (l < L - 1) {
            double* out = work + lv[3];
            out[2 * t] = s0;
            out[2 * t + 1] = s1;
        } else {
            const int p = run.at(rw[R_LUPAR])[t];
            if (A.chan != R_ONLY) D[p] = D[p] + s0;
            if (A.chan != D_ONLY) Rr[p] = Rr[p] + s1;
        }
    }
}

// a block run forward: stage its slots' (d, r), its children's
// conductances and its words, walk its rounds with a barrier a phase (no
// device-memory store before a barrier: a barrier waits for them), then
// write the saved stream, the (d, r) of the slots it does not eliminate and
// their core gathers (a later launch's gather of a node it updates again
// writes over it)
__device__ void run_forward(const PeelArgs& A, const PeelEntry& e, double* smem)
{
    double* D = smem;
    double* Rr = D + e.S;
    double* Wc = Rr + e.S;
    const Run run = stage_run(A, e, reinterpret_cast<int*>(smem + run_doubles(A, e, true)));
    double* Sd = Wc + run.n;
    double* Sr = Sd + run.n;
    // the slots' (d, r) and the children's conductances, their gathers in flight together
    const int* ssrc = A.tab + e.ssrc;
    const int* wsrc = A.tab + e.wsrc;
    const int* slots = A.tab + e.slots;
    stage(e.S > run.n ? e.S : run.n,
          [&](int i) {
              const double* v = i < e.S ? current(A, ssrc[i]) : nullptr;
              const int p = (i < run.n && A.chan != R_ONLY) ? wsrc[i] : -1;
              const double first = !v ? 0.0 : (A.chan == R_ONLY ? A.fac[slots[i]] : v[0]);
              return Triple{first, v ? v[1] : 0.0, (A.has_pairs && p >= 0) ? A.w_pairs[p] : 0.0};
          },
          [&](int i, Triple t) {
              if (i < e.S) {
                  D[i] = t.a;
                  Rr[i] = t.b;
              }
              if (i < run.n) Wc[i] = t.c;
          });
    wait_copies();
    __syncthreads();
    for (int k = e.first; k < e.last; ++k) {
        const int L = run.row(k)[R_FOLD];
        for (int l = 0; l < (L > 1 ? L : 1); ++l) {
            run_forward_phase(A, run, k, l, D, Rr, Wc, Sd, Sr, A.work, slots);
            __syncthreads();
        }
    }
    double* const saved[3] = {A.sw, A.sd, A.sr};
    for (int plane = 0; plane < 3; ++plane) {
        if (plane == 2 ? A.chan == D_ONLY : A.chan == R_ONLY) continue;  // the other channel's
        const double* from = Wc + plane * run.n;
        double* to = saved[plane] + run.base;
        stage(run.n, [&](int q) { return from[q]; }, [&](int q, double v) { to[q] = v; });
    }
    const int* bsrc = A.tab + e.bsrc;
    stage(e.S, [&](int s) { return bsrc[s]; }, [&](int s, int c) {
        if (c == -1) return;  // eliminated here: no later launch reads its (d, r)
        const int v = slots[s];
        if (A.chan != R_ONLY) A.wk[2 * v] = D[s];
        if (A.chan != D_ONLY) A.wk[2 * v + 1] = Rr[s];
        if (c <= -2) {
            if (A.chan != R_ONLY) A.dc[-2 - c] = D[s];
            if (A.chan != D_ONLY) A.rc[-2 - c] = Rr[s];
        }
    });
}

// a block run back: stage the lambda of the slots it does not eliminate
// (from lambda or the core's x), its children's saved values and its words,
// walk its rounds in reverse with a barrier a round, then write the lambda
// of the slots it eliminates
__device__ void run_back(const PeelArgs& A, const PeelEntry& e, double* smem)
{
    double* Lam = smem;
    const Run run = stage_run(A, e, reinterpret_cast<int*>(smem + run_doubles(A, e, false)));
    double* Sw = Lam + e.S;
    double* Sd = Sw + run.n;
    double* Sr = Sd + run.n;
    const double* const saved[3] = {A.sw, A.sd, A.sr};
    for (int plane = 0; plane < 3; ++plane) copy_async(Sw + plane * run.n, saved[plane] + run.base, run.n);
    const int* bsrc = A.tab + e.bsrc;
    stage(e.S, [&](int s) { const int c = bsrc[s]; return c >= 0 ? A.lam[c] : (c == -1 ? 0.0 : A.x[-2 - c]); },
          [&](int s, double v) { Lam[s] = v; });
    wait_copies();
    __syncthreads();
    for (int k = e.last - 1; k >= e.first; --k) {
        const int* rw = run.row(k);
        const int n = rw[R_N];
        const int q0 = rw[R_OFF] - run.base;
        const int* lelim = run.at(rw[R_LELIM]);
        const int* lpar = run.at(rw[R_LPAR]);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int p = lpar[t];
            const double lp = p >= 0 ? Lam[p] : 0.0;
            Lam[lelim[t]] = (Sr[q0 + t] + Sw[q0 + t] * lp) / Sd[q0 + t];
        }
        __syncthreads();
    }
    const int* slots = A.tab + e.slots;
    stage(e.S, [&](int s) { return bsrc[s]; }, [&](int s, int c) {
        if (c == -1) A.lam[slots[s]] = Lam[s];  // the slots it eliminates
    });
}

// scenario z's arguments: each buffer its stride z further on
template <typename T>
__device__ __forceinline__ T* at_scenario(T* p, long long stride, size_t z)
{
    return p == nullptr ? p : p + z * static_cast<size_t>(stride);
}

__device__ __forceinline__ PeelArgs scenario(const PeelArgs& A, int z)
{
    const size_t Z = static_cast<size_t>(z);
    PeelArgs a = A;
    a.w_pairs = at_scenario(A.w_pairs, A.s_wp, Z);
    a.dr = at_scenario(A.dr, A.s_dr, Z);
    a.wk = at_scenario(A.wk, A.s_wk, Z);
    a.work = at_scenario(A.work, A.s_work, Z);
    a.dc = at_scenario(A.dc, A.s_dc, Z);
    a.rc = at_scenario(A.rc, A.s_rc, Z);
    a.x = at_scenario(A.x, A.s_x, Z);
    a.lam = at_scenario(A.lam, A.s_lam, Z);
    a.sw = at_scenario(A.sw, A.s_sw, Z);
    a.sd = at_scenario(A.sd, A.s_sd, Z);
    a.sr = at_scenario(A.sr, A.s_sr, Z);
    a.fac = at_scenario(A.fac, A.s_fac, Z);
    return a;
}

__global__ void __launch_bounds__(GRID_THREADS) peel_grid_forward_kernel(PeelArgs A0, PeelEntry e, GridRound g)
{
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int nth = gridDim.x * blockDim.x;
    for (int z = blockIdx.y; z < A0.S; z += gridDim.y) {
        const PeelArgs A = scenario(A0, z);
        if (e.kind == GRID) forward_phase(A, g, tid, nth);
        if (e.duty) gather_duty(A, tid, nth);
    }
}

__global__ void __launch_bounds__(BLOCK_THREADS) peel_block_forward_kernel(PeelArgs A0, PeelEntry e)
{
    extern __shared__ double smem[];
    for (int z = blockIdx.y; z < A0.S; z += gridDim.y) {  // a block a scenario
        const PeelArgs A = scenario(A0, z);
        if (e.duty) gather_duty(A, threadIdx.x, blockDim.x);  // nodes the rounds never touch
        run_forward(A, e, smem);
        __syncthreads();
    }
}

__global__ void __launch_bounds__(GRID_THREADS) peel_grid_back_kernel(PeelArgs A0, PeelEntry e, GridRound g)
{
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int nth = gridDim.x * blockDim.x;
    for (int z = blockIdx.y; z < A0.S; z += gridDim.y) {
        const PeelArgs A = scenario(A0, z);
        if (e.kind == GRID) back_round(A, g, tid, nth);
        if (e.duty) scatter_duty(A, tid, nth);
    }
}

__global__ void __launch_bounds__(BLOCK_THREADS) peel_block_back_kernel(PeelArgs A0, PeelEntry e)
{
    extern __shared__ double smem[];
    for (int z = blockIdx.y; z < A0.S; z += gridDim.y) {  // a block a scenario
        const PeelArgs A = scenario(A0, z);
        run_back(A, e, smem);
        if (e.duty) scatter_duty(A, threadIdx.x, blockDim.x);  // lambda at the core: nothing reads it here
        __syncthreads();
    }
}

// a kernel's dynamic shared memory above the default 48 KB
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes)
{
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// a direction's entries as launches: the kernels enqueued, minus a CUDA error
template <typename Grid, typename Block>
int run_entries(const PeelArgs& A, const int* host, int count, int at, Grid grid, Block block,
                cudaStream_t stream)
{
    PeelArgs args = A;
    if (args.S < 1) return -static_cast<int>(cudaErrorInvalidValue);
    const unsigned ys = args.S < 65535 ? args.S : 65535;  // the scenarios: the grid's y
    cudaError_t err;
    for (int i = 0; i < count; ++i) {
        const PeelEntry e = entry_at(host + at + i * ENTRY_WORDS);
        if (e.kind == BLOCK) {
            if ((err = allow_smem(block, e.smem)) != cudaSuccess) return -static_cast<int>(err);
            block<<<dim3(1, ys), BLOCK_THREADS, e.smem, stream>>>(args, e);
        } else {
            const GridRound g = e.kind == GRID ? grid_round(host, e.first, e.level) : GridRound{};
            grid<<<dim3(e.blocks, ys), GRID_THREADS, 0, stream>>>(args, e, g);
        }
        if ((err = cudaGetLastError()) != cudaSuccess) return -static_cast<int>(err);
    }
    return count;
}

}  // namespace

// The per-edge conductances and the two sides' (diag, rhs) terms; g null:
// the diagonal alone (start_pbc, end_pbc and Ftot unread, the rhs terms 0).
extern "C" int nxfx_lambda_prepare(
    int E, const double* W, const double* g, const double* Ftot,
    const double* start_pbc, const double* end_pbc,
    const int* start_bif, const int* end_bif,
    double* w, double* vt, double* vs,
    cudaStream_t stream)
{
    if (E <= 0) return 0;
    lambda_prepare_kernel<<<blocks_for(E), THREADS, 0, stream>>>(
        E, W, g, Ftot, start_pbc, end_pbc, start_bif, end_bif, w, vt, vs);
    return static_cast<int>(cudaGetLastError());
}

// The same for S scenarios (g, Ftot and the boundary pressures required):
// W, g (S, E), Ftot rows sFt apart, start_pbc, end_pbc rows ssp, sep apart
// (0: shared); w (S, E), vt, vs (S, E, 2) out.  One launch.
extern "C" int nxfx_lambda_prepare_scen(
    int E, int S, long long sFt, long long ssp, long long sep, const double* W, const double* g,
    const double* Ftot, const double* start_pbc, const double* end_pbc, const int* start_bif,
    const int* end_bif, double* w, double* vt, double* vs, cudaStream_t stream)
{
    if (E <= 0 || S <= 0) return 0;
    const dim3 grid(blocks_for(E), S < 65535 ? S : 65535);
    lambda_prepare_scen_kernel<<<grid, THREADS, 0, stream>>>(E, S, sFt, ssp, sep, W, g, Ftot, start_pbc,
                                                             end_pbc, start_bif, end_bif, w, vt, vs);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_rhs_norm(int B, const double* dr, double* out, cudaStream_t stream)
{
    rhs_norm_kernel<<<1, REDUCE_THREADS, 0, stream>>>(B, 1, dr, out);
    return static_cast<int>(cudaGetLastError());
}

// The norms of S scenarios' systems dr (S, B, 2) into out (S,), one launch.
extern "C" int nxfx_rhs_norm_scen(int B, int S, const double* dr, double* out, cudaStream_t stream)
{
    if (S <= 0) return 0;
    rhs_norm_kernel<<<dim3(1, S < 65535 ? S : 65535), REDUCE_THREADS, 0, stream>>>(B, S, dr, out);
    return static_cast<int>(cudaGetLastError());
}


// The rounds forward and the core's gather into dc, rc (A->dr the assembled
// system, read; A->wk the updated nodes' (d, r); the saved planes and the
// work buffer's fold levels written), on the channels of A->chan (D_ONLY
// also writes A->fac, R_ONLY reads it).  `host` is the table on the host
// (its launch lists).  Returns the kernels enqueued, or minus a CUDA error.
extern "C" int nxfx_peel_forward(const PeelArgs* A, const int* host, cudaStream_t stream)
{
    return run_entries(*A, host, host[H_NFWD], host[H_FWD], peel_grid_forward_kernel, peel_block_forward_kernel,
                       stream);
}

// The core's solution A->x scattered into lambda and the rounds back.
extern "C" int nxfx_peel_back(const PeelArgs* A, const int* host, cudaStream_t stream)
{
    return run_entries(*A, host, host[H_NBACK], host[H_BACK], peel_grid_back_kernel, peel_block_back_kernel,
                       stream);
}
