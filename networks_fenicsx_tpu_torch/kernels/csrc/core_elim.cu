// K12a: the min-degree rounds of the sparse core elimination.
//
// Replaces networks_fenicsx_tpu/ops/core_elim.py:_core_factor (its rounds)
// and _core_apply (the forward rounds and the back-substitution), with the
// K10 folds (_fold_apply, :394) inside.  A round eliminates an independent
// set elim (S,) whose nodes have at most K neighbours (nbr_node (S, K),
// padded with n_core); the host planner gives each slot read an index into
// the initial values and a fold of the update stream.  With the table's
// pair ids (the plan's init_slot[init_idx], -1 for a fill slot) and
// init(p) = -w_pairs[p] (0 at -1), per round:
//   terms:   a[s,k] = init(pid[s,k]) - fold(ustream, u_read)[s,k] (no fold: no term)
//            inv[s] = 1 / d[elim[s]],  rv[s] = r[elim[s]]
//            t[s,k] = (a (a inv),  (a inv) rv)          (two channels)
//   update:  (d, r)[i] -= fold(t, d_fold)[row], row = d_inv[i] (each row's node d_node)
//            ustream[u_off ..] = fold(contrib, u_fold),
//            contrib[m] = a[u_src_i[m]] (a[u_src_j[m]] inv[u_src_j[m] / K])
// then the dense tail's gathers: d and r at the dense nodes and the negated
// pair values -(init(dp_pid[p]) - fold(ustream, dp_fold)[p]) for K11 (or
// the supernodal fronts, K12b, on d, r and the stream), and, rounds
// reversed, lam[elim[s]] = (rv[s] - sum_k a[s,k] lam[nbr_node[s,k]]) inv[s]
// (lam[n_core] = 0 backs the pads; the sum runs over k in order).
//
// Two launches a solve, walking the packed round table (ops/core_elim.py
// RoundTable, checked when the plan is uploaded): the forward launch runs
// each round's factor and forward sweep together (round k's forward needs
// only round k's a, inv and the swept r) and ends with the tail's gathers;
// the back launch scatters the tail's solution (or takes the fronts' lam)
// and back-substitutes.  Factor reuse splits the forward launch in two:
// the factor (the d channel, the slot values, the update stream and the
// tail's dd and -ov gathers) once, into a factor buffer [a | inv | ustream]
// kept across solves, and an apply (the r channel on the stored a and inv,
// the tail's rr gather) a right-hand side, with a scratch of its own
// [rv | t | the diagonal folds' levels] that the back launch reads; an
// apply only reads the factor.  A phase is a loop over its entries with a
// barrier after it: two a round (the terms with the slots' stream reads folded in;
// the update, the diagonal fold's rows and the stream segment's rows, each
// fill product made as the update fold reads it; one block makes the
// products in the update and folds them in a third phase, its gathers
// shorter where each thread takes several rows), one a round back; a
// fold's earlier levels (segments wider than 64) are a phase each; a fold's
// last level is summed by its reader, as K10 sums it (fold.cuh), so every
// fold value is the plain version's to the bit.  A row of 8 terms or more
// (a late round's slot reads, its back-substitution dot products: up to 63
// on the 128^2 lattice's fronts) is shared by a group of lanes that load
// its terms together and add them in order, where a grid has the threads
// to spare (one block's threads are few for its rows: a lane a row).
// Two sizes, both hand-written: a core whose phases fit one block runs as
// one block of 1024 threads with d and r in shared memory and
// __syncthreads() between phases; a larger one as a cooperative grid, up
// to its resident blocks, with a grid barrier between phases.
//
// The products are those of the reference, in its order (-fmad=false), so
// every rounding is the plain version's.  Bound: the phases' dependent
// latency (a barrier, a few gathers and a division each); the bytes (a
// round's tables and values, a few hundred kB at most) take microseconds.
// The elimination set is independent and d_node is one-to-one, so each
// output has one writer; what a launch writes it reads after a barrier, so
// nothing here is __restrict__.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fold.cuh"

namespace cg = cooperative_groups;

// The launch's arguments (kernels.core_elim's _CoreArgs, a ctypes mirror).
struct CoreArgs {
    int head_words, staged, n_core, tail, zero_lam, grid;
    const int* tab;
    const double* w_pairs;
    const double* dc;
    const double* rc;
    double* d;
    double* r;
    double* work;
    double* fac;
    double* dd;
    double* rr;
    double* neg_ov;
    const double* x;
    double* lam;
};

namespace {

// the table's layout (ops/core_elim.py)
constexpr int FOLD_MAX = 8;
constexpr int FOLD_WORDS = 1 + 4 * FOLD_MAX;
enum { G_NCORE, G_P0, G_ROUNDS, G_BD, G_PD, G_DN, G_DPINIT, G_MU, G_A, G_INV, G_RV, G_US, G_T, G_C,
       G_WORK, G_MAXW, G_FAC, G_AWORK, G_DPFOLD };
constexpr int HEAD_WORDS = G_DPFOLD + FOLD_WORDS;
enum { R_S, R_K, R_ELIM, R_INIT, R_NBR, R_AOFF, R_SOFF, R_UOFF, R_U1, R_M2, R_U2, R_DNODE, R_USI, R_USJ,
       R_UREAD };
constexpr int R_DFOLD = R_UREAD + FOLD_WORDS;
constexpr int R_UFOLD = R_DFOLD + FOLD_WORDS;
constexpr int ROUND_WORDS = R_UFOLD + FOLD_WORDS;

constexpr int ONE_BLOCK = 1024;  // the one-block launch's threads
constexpr int GRID_THREADS = 512;  // a cooperative block's (a block an SM)

// the launch's threads: one block, or the whole grid
template <bool GRID>
struct Team {
    int tid, nth;
    __device__ Team()
    {
        if constexpr (GRID) {
            tid = blockIdx.x * blockDim.x + threadIdx.x;
            nth = gridDim.x * blockDim.x;
        } else {
            tid = threadIdx.x;
            nth = blockDim.x;
        }
    }
    __device__ void sync() const
    {
        if constexpr (GRID)
            cg::this_grid().sync();
        else
            __syncthreads();
    }
    // the lanes each of `rows` rows of K terms gets: one in one block, whose
    // threads are few for its rows (the group code is then compiled out)
    __device__ int group(int K, long long rows) const
    {
        if constexpr (GRID)
            return fold::group_for(K, rows, nth);
        else
            return 1;
    }
};

// a slot's initial value from its pair id (-1: a fill slot, 0)
__device__ __forceinline__ double init_value(int pid, const double* w_pairs)
{
    return pid >= 0 ? -w_pairs[pid] : 0.0;
}

// a fold's level-0 source: n rows of C channels
struct Src {
    const double* v;
    int n, C;
};

// row `row`, channel c, of level l of the fold whose descriptor is f,
// summed by one lane or a group of G lanes (fold.cuh)
__device__ __forceinline__ double fold_at(const int* tab, const int* f, int l, int row, int c, Src src,
                                          const double* work, int G)
{
    const int* lv = f + 1 + 4 * l;
    const int* idx = tab + lv[0] + static_cast<size_t>(row) * lv[2];
    const double* v = l == 0 ? src.v : work + lv[-1];  // level l - 1's output,
    const int n = l == 0 ? src.n : lv[-3];              // and its rows
    if (G == 1) return fold::row_sum(idx, lv[2], v, n, src.C, c);
    return fold::group_row_sum(idx, lv[2], n, G, [&](int i) { return v[static_cast<size_t>(i) * src.C + c]; });
}

// A round's fill products a[u_src_i] (a[u_src_j] inv[u_src_j / K]), made as a
// fold reads them.
struct Products {
    const int* ui;
    const int* uj;
    const double* a;
    const double* inv;
    int K, M2;

    __device__ __forceinline__ double operator()(int m) const
    {
        const int j = uj[m];
        return a[ui[m]] * (a[j] * inv[j / K]);
    }
};

// the same, level 0 reading the products
__device__ __forceinline__ double fold_at(const int* tab, const int* f, int l, int row, const Products& p,
                                          const double* work, int G)
{
    if (l > 0) return fold_at(tab, f, l, row, 0, Src{nullptr, 0, 1}, work, G);
    const int* lv = f + 1;
    return fold::group_row_sum(tab + lv[0] + static_cast<size_t>(row) * lv[2], lv[2], p.M2, G, p);
}

// the lanes a reader of `rows` rows of the fold's last level gives each row
template <bool GRID>
__device__ __forceinline__ int last_group(const Team<GRID>& tm, const int* f, int rows)
{
    return f[0] > 0 ? tm.group(f[1 + 4 * (f[0] - 1) + 2], rows) : 1;
}

// the fold's levels but its last, a phase each, into the work buffer;
// at(l, row, c, G) sums one of their rows
template <bool GRID, typename At>
__device__ void fold_front(const Team<GRID>& tm, const int* f, int C, double* work, At at)
{
    for (int l = 0; l + 1 < f[0]; ++l) {
        const int* lv = f + 1 + 4 * l;
        const int outs = lv[1] * C;
        const int G = tm.group(lv[2], outs);
        double* out = work + lv[3];
        for (int t = tm.tid; t < outs * G; t += tm.nth) {
            const int o = t / G;
            const double v = at(l, o / C, o % C, G);
            if (t % G == 0) out[o] = v;
        }
        tm.sync();
    }
}

// the header and the round rows: staged into shared memory, or read in place
__device__ __forceinline__ const int* stage_head(const CoreArgs& A, unsigned char* smem)
{
    if (!A.staged) return A.tab;
    int* h = reinterpret_cast<int*>(smem);
    for (int i = threadIdx.x; i < A.head_words; i += blockDim.x) h[i] = A.tab[i];
    __syncthreads();
    return h;
}

__device__ __forceinline__ double* after_head(const CoreArgs& A, unsigned char* smem)
{
    return reinterpret_cast<double*>(smem) + (A.staged ? (A.head_words + 1) / 2 : 0);
}

// The rounds forward.  FUSED: each round's factor and forward sweep
// together, both channels (d, r); FACTOR: the factor alone, the d channel
// (the slot values, the pivots' inverses, the update stream); APPLY: the
// forward sweep alone on a stored factor, the r channel, a·inv re-formed
// from the stored a and inv as FUSED forms it.  One channel's folds sum the
// same rows in the same order as that channel of the two-channel fold, so
// a split launch's d and r are FUSED's to the bit.
enum Mode { FUSED, FACTOR, APPLY };

template <bool GRID, int MODE>
__global__ void __launch_bounds__(ONE_BLOCK) core_rounds_kernel(CoreArgs A)
{
    constexpr bool HAS_D = MODE != APPLY, HAS_R = MODE != FACTOR;
    constexpr int C = HAS_D && HAS_R ? 2 : 1;  // the terms' channels
    extern __shared__ __align__(16) unsigned char smem[];
    const Team<GRID> tm;
    const int* H = stage_head(A, smem);
    const int n = H[G_NCORE];
    double* staged = after_head(A, smem);
    double* d = GRID ? A.d : staged;
    double* r = GRID ? A.r : (HAS_D ? staged + n : staged);
    double* work = A.work;
    double* fac = A.fac;
    const Src us{fac + H[G_US], H[G_MU], 1};
    auto us_at = [&](const int* f) {
        return [&, f](int l, int row, int c, int G) { return fold_at(A.tab, f, l, row, c, us, work, G); };
    };
    for (int i = tm.tid; i < n; i += tm.nth) {
        if constexpr (HAS_D) d[i] = A.dc[i];
        if constexpr (HAS_R) r[i] = A.rc[i];
    }
    tm.sync();
    for (int k = 0; k < H[G_ROUNDS]; ++k) {
        const int* R = H + HEAD_WORDS + k * ROUND_WORDS;
        const int K = R[R_K], SK = R[R_S] * K;
        const int* elim = A.tab + R[R_ELIM];
        const int* init_pid = A.tab + R[R_INIT];
        double* a = fac + H[G_A] + R[R_AOFF];
        double* inv = fac + H[G_INV] + R[R_SOFF];
        double* rv = work + H[G_RV] + R[R_SOFF];
        double* t = work + H[G_T];

        if constexpr (MODE == APPLY) {
            // terms: the swept rhs and the r channel on the stored a and inv
            for (int e = tm.tid; e < SK; e += tm.nth) {
                const int s = e / K;
                const double rs = r[elim[s]];
                t[e] = (a[e] * inv[s]) * rs;
                if (e == s * K) rv[s] = rs;
            }
        } else {
            // terms: the slot values (their stream reads folded in), pivots, swept rhs
            const int* fu = R + R_UREAD;
            fold_front(tm, fu, 1, work, us_at(fu));
            const int Gu = last_group(tm, fu, SK);
            for (int q = tm.tid; q < SK * Gu; q += tm.nth) {
                const int e = q / Gu, s = e / K;
                double v = init_value(init_pid[e], A.w_pairs);
                if (fu[0] > 0) v = v - fold_at(A.tab, fu, fu[0] - 1, e, 0, us, work, Gu);
                if (q % Gu) continue;
                const int el = elim[s];
                const double is = 1.0 / d[el];
                const double ai = v * is;
                a[e] = v;
                if constexpr (MODE == FUSED) {
                    const double rs = r[el];
                    t[2 * e] = v * ai;
                    t[2 * e + 1] = ai * rs;
                    if (e == s * K) rv[s] = rs;
                } else {
                    t[e] = v * ai;
                }
                if (e == s * K) inv[s] = is;
            }
        }
        tm.sync();

        // update: d and r through the diagonal fold, and the round's stream
        // segment through the update fold of the fill products, each product
        // made as the fold reads it
        const int* fd = R + R_DFOLD;
        const int* ff = R + R_UFOLD;
        const Src ts{t, SK, C};
        const int M2 = HAS_D ? R[R_M2] : 0;
        const Products products{A.tab + R[R_USI], A.tab + R[R_USJ], a, inv, K, M2};
        // a grid makes each product as the fold reads it (a barrier less);
        // one block, whose threads take several rows each, keeps the gathers
        // short: the products first, folded in a phase of their own
        double* contrib = work + H[G_C];
        const Src cs{contrib, M2, 1};
        auto stream_at = [&](int l, int row, int, int G) {
            return GRID ? fold_at(A.tab, ff, l, row, products, work, G)
                        : fold_at(A.tab, ff, l, row, 0, cs, work, G);
        };
        fold_front(tm, fd, C, work, [&](int l, int row, int c, int G) {
            return fold_at(A.tab, fd, l, row, c, ts, work, G);
        });
        if constexpr (HAS_D) {
            if (!GRID) {
                for (int m = tm.tid; m < M2; m += tm.nth) contrib[m] = products(m);
            }
            if (GRID) fold_front(tm, ff, 1, work, stream_at);
        }
        const int U1 = R[R_U1], U2 = M2 > 0 ? R[R_U2] : 0;
        const int* d_node = A.tab + R[R_DNODE];
        const int Gd = last_group(tm, fd, U1);
        for (int q = tm.tid; q < U1 * Gd; q += tm.nth) {
            const int row = q / Gd, node = d_node[row];
            if (node < 0) continue;  // group-uniform
            if constexpr (MODE == FUSED) {
                const double sd = fold_at(A.tab, fd, fd[0] - 1, row, 0, ts, work, Gd);
                const double sr = fold_at(A.tab, fd, fd[0] - 1, row, 1, ts, work, Gd);
                if (q % Gd == 0) {
                    d[node] = d[node] - sd;
                    r[node] = r[node] - sr;
                }
            } else {
                const double sv = fold_at(A.tab, fd, fd[0] - 1, row, 0, ts, work, Gd);
                double* x = HAS_D ? d : r;
                if (q % Gd == 0) x[node] = x[node] - sv;
            }
        }
        if (!GRID && U2 > 0) {
            tm.sync();
            fold_front(tm, ff, 1, work, stream_at);
        }
        double* seg = fac + H[G_US] + R[R_UOFF];
        const int Gf = last_group(tm, ff, U2);
        for (int q = tm.tid; q < U2 * Gf; q += tm.nth) {
            const double v = stream_at(ff[0] - 1, q / Gf, 0, Gf);
            if (q % Gf == 0) seg[q / Gf] = v;
        }
        tm.sync();
    }
    if (A.tail) {
        const int Bd = H[G_BD], Pd = H[G_PD];
        const int* dn = A.tab + H[G_DN];
        for (int q = tm.tid; q < Bd; q += tm.nth) {
            if constexpr (HAS_D) A.dd[q] = d[dn[q]];
            if constexpr (HAS_R) A.rr[q] = r[dn[q]];
        }
        if constexpr (HAS_D) {
            const int* fp = H + G_DPFOLD;
            fold_front(tm, fp, 1, work, us_at(fp));
            const int* dp_pid = A.tab + H[G_DPINIT];
            const int Gp = last_group(tm, fp, Pd);
            for (int q = tm.tid; q < Pd * Gp; q += tm.nth) {
                double v = init_value(dp_pid[q / Gp], A.w_pairs);
                if (fp[0] > 0) v = v - fold_at(A.tab, fp, fp[0] - 1, q / Gp, 0, us, work, Gp);
                if (q % Gp == 0) A.neg_ov[q / Gp] = -v;
            }
        }
    }
    if (!GRID) {
        for (int i = tm.tid; i < n; i += tm.nth) {
            if constexpr (HAS_D) A.d[i] = d[i];
            if constexpr (HAS_R) A.r[i] = r[i];
        }
    }
}

template <bool GRID>
__global__ void __launch_bounds__(ONE_BLOCK) core_back_kernel(CoreArgs A)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const Team<GRID> tm;
    const int* H = stage_head(A, smem);
    const int n = H[G_NCORE];
    double* lam = GRID ? A.lam : after_head(A, smem);
    const double* work = A.work;
    if (A.zero_lam) {  // the dense tail's solution (none: zeros) into a zero lam
        for (int i = tm.tid; i <= n; i += tm.nth) lam[i] = 0.0;
        tm.sync();
        if (A.tail) {
            const int* dn = A.tab + H[G_DN];
            for (int q = tm.tid; q < H[G_BD]; q += tm.nth) lam[dn[q]] = A.x[q];
        }
    } else if (!GRID) {  // the fronts' lam
        for (int i = tm.tid; i <= n; i += tm.nth) lam[i] = A.lam[i];
    }
    tm.sync();
    for (int k = H[G_ROUNDS] - 1; k >= 0; --k) {
        const int* R = H + HEAD_WORDS + k * ROUND_WORDS;
        const int S = R[R_S], K = R[R_K];
        const int* elim = A.tab + R[R_ELIM];
        const int* nbr = A.tab + R[R_NBR];
        const double* a = A.fac + H[G_A] + R[R_AOFF];
        const double* inv = A.fac + H[G_INV] + R[R_SOFF];
        const double* rv = work + H[G_RV] + R[R_SOFF];
        const int G = tm.group(K, S);
        for (int q = tm.tid; q < S * G; q += tm.nth) {
            const int s = q / G;
            const int* nb = nbr + static_cast<size_t>(s) * K;
            const double* as = a + static_cast<size_t>(s) * K;
            double acc;
            if (G == 1) {
                acc = as[0] * lam[nb[0]];
                for (int j = 1; j < K; ++j) acc = acc + as[j] * lam[nb[j]];
            } else {
                acc = fold::group_sum(K, G, [&](int j) { return as[j] * lam[nb[j]]; });
            }
            if (q % G == 0) lam[elim[s]] = (rv[s] - acc) * inv[s];
        }
        tm.sync();
    }
    if (!GRID) {
        for (int i = tm.tid; i <= n; i += tm.nth) A.lam[i] = lam[i];
    }
}

size_t smem_bytes(const CoreArgs& A, size_t doubles)
{
    return (A.staged ? 4 * static_cast<size_t>((A.head_words + 1) / 2 * 2) : 0) + 8 * doubles;
}

// one block, or a cooperative grid of A.grid blocks (all resident)
template <typename Kernel>
int launch(Kernel kernel, const CoreArgs& A, size_t smem, cudaStream_t stream)
{
    cudaError_t err;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
        return static_cast<int>(err);
    CoreArgs args = A;
    if (A.grid <= 0) {
        kernel<<<1, ONE_BLOCK, smem, stream>>>(args);
        return static_cast<int>(cudaGetLastError());
    }
    void* params[] = {&args};
    return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(A.grid),
                                                        dim3(GRID_THREADS), params, smem, stream));
}

}  // namespace

// The blocks of a cooperative launch of one kernel (0: the fused forward,
// 1: the back-substitution, 2: the factor, 3: the apply's forward) that fit
// on the device at once with `staged` header words in shared memory: a
// block an SM when one fits (the barrier's arrivals stay few), else 0.
extern "C" int nxfx_core_grid_blocks(int device, int head_words, int staged, int kernel)
{
    const void* fns[] = {reinterpret_cast<const void*>(core_rounds_kernel<true, FUSED>),
                         reinterpret_cast<const void*>(core_back_kernel<true>),
                         reinterpret_cast<const void*>(core_rounds_kernel<true, FACTOR>),
                         reinterpret_cast<const void*>(core_rounds_kernel<true, APPLY>)};
    if (kernel < 0 || kernel > 3) return -1;
    int sms = 0, blocks = 0;
    CoreArgs A = {};
    A.head_words = head_words;
    A.staged = staged;
    const size_t smem = smem_bytes(A, 0);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return -1;
    if (smem > 48 * 1024 && cudaFuncSetAttribute(fns[kernel], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem)) != cudaSuccess)
        return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[kernel], GRID_THREADS, smem) != cudaSuccess)
        return -1;
    return blocks > 0 ? sms : 0;
}

// The factor and forward rounds with the tail's gathers (A.tail): d, r (the
// swept rhs), the factor buffer (a, inv, the update stream), the scratch's
// saved rhs, and dd, rr, neg_ov for K11.  One block (A.grid 0) or a
// cooperative grid.
extern "C" int nxfx_core_forward(const CoreArgs* A, cudaStream_t stream)
{
    if (A->grid > 0)
        return launch(core_rounds_kernel<true, FUSED>, *A, smem_bytes(*A, 0), stream);
    return launch(core_rounds_kernel<false, FUSED>, *A, smem_bytes(*A, 2 * static_cast<size_t>(A->n_core)),
                  stream);
}

// The rounds' factor alone with the tail's factor-side gathers (A.tail): d,
// the factor buffer, and dd, neg_ov for K11.
extern "C" int nxfx_core_factor(const CoreArgs* A, cudaStream_t stream)
{
    if (A->grid > 0)
        return launch(core_rounds_kernel<true, FACTOR>, *A, smem_bytes(*A, 0), stream);
    return launch(core_rounds_kernel<false, FACTOR>, *A, smem_bytes(*A, static_cast<size_t>(A->n_core)),
                  stream);
}

// The forward sweep alone on a stored factor (A.fac, read only) with the
// tail's rhs gather (A.tail): r, the scratch's saved rhs, and rr for K11.
extern "C" int nxfx_core_apply(const CoreArgs* A, cudaStream_t stream)
{
    if (A->grid > 0)
        return launch(core_rounds_kernel<true, APPLY>, *A, smem_bytes(*A, 0), stream);
    return launch(core_rounds_kernel<false, APPLY>, *A, smem_bytes(*A, static_cast<size_t>(A->n_core)),
                  stream);
}

// The back-substitution into lam (n_core + 1) on the factor's a and inv and
// the scratch's saved rhs: from the tail's solution x scattered into zeros
// (A.zero_lam), or from the fronts' lam.
extern "C" int nxfx_core_back(const CoreArgs* A, cudaStream_t stream)
{
    if (A->grid > 0)
        return launch(core_back_kernel<true>, *A, smem_bytes(*A, 0), stream);
    return launch(core_back_kernel<false>, *A, smem_bytes(*A, static_cast<size_t>(A->n_core) + 1), stream);
}
