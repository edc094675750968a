// K1: per-edge static condensation of the blocked forest Schur solve, for
// every shard of one device in one launch.
//
// Replaces networks_fenicsx_tpu/solver.py:_blocked_condense,
// _blocked_condense_R and _blocked_condense_f (g, Ftot) plus the `const`
// line of _blocked_uniform_solve.  Per internal edge e of a shard:
//   W     = wt * sum_c R_c h          (scalar/edge R: R h N wt)
//   w     = 1 / W
//   Ftot  = sum_c f_c h               (scalar/edge f: f h N)
//   g     = 1^T M cumF                (closed form when neither R nor f is per cell)
//   const = (-p_s [s not bif] + p_t [t not bif] - g) * w
//
// Bound: device-memory bytes.  Scalar/edge modes read and write O(E)
// doubles (~88 bytes an edge with per-row R, f and boundary data);
// cell mode reads the (N, E) j-major R and f blocks once.  One thread owns
// one edge and walks its column down the N cells, so each step of the walk
// is one coalesced row read across the warp; no shared memory, no atomics,
// every sum in the reference's order along the edge.
//
// What the design answers.  The sharded executors made one launch a shard
// (8 a solve on the 16-generation tree's 8 shards of 8,192 rows, ~0.7 MB
// each: latency alone) and the wrapper's host path (five allocations, a
// check of every tensor, 21 ctypes arguments, a device guard) cost ~60 us
// around ~3.5 us of device time.  Here the grid is (blocks over E, S): the
// shard is blockIdx.y, its inputs reach the launch through a struct of
// pointers (CondenseArgs, fixed per plan and group on the host, only the
// coefficient pointers rewritten a call), and the five outputs go to one
// (5, rows, E) buffer, so a device makes one launch a solve whatever its
// number of shards (one a CONDENSE_MAX_SHARDS).  The serial routes launch
// the same kernel with S = 1.  The body is the one-shard kernel's: each
// output equals it bit for bit.
//
// A sweep (batch.solve_sweep) runs K1 over S scenarios of one plan in one
// launch: condense_scen_kernel, grid (blocks over E, min(S, 65,535)), each
// block row looping over the scenarios y, y + gridDim.y, ...  Each input
// has its own stride a scenario (0 for an input that all scenarios share,
// read in place, never copied S times); the row ends, h_e, N, the modes
// and the constants are the plan's, fixed for the launch.  The output is
// one (5, S, E) buffer.  The per-edge body is the one the shard kernel
// runs (condense_edge), so a scenario's row is its one-scenario launch's
// bit for bit.
//
// The serial body, read on the one-shard kernel before this design: the
// headline's launch (E = 65,535, 5.2 MB, 256 blocks of 256 threads) took
// 2.31-2.41 us of device time against a 1.57 us byte bound (profiler, NVIDIA
// H100 80GB HBM3 at 700 W; scripts/profile_torch_main_path.py --kernels
// --select condense).  Every thread issues all its loads at once, so that is
// the launch and about one device-memory round trip; wider loads or two
// edges a thread would not shorten it, and the body stays a thread an edge.
// Reading the shard's pointers at a dynamic index of a one-shard struct
// took 4.1 us on the same card (the parameter copied to local memory, as it
// seems): a one-shard launch reads them at index 0, as its arguments were.

#include <cuda_runtime.h>

constexpr int CONDENSE_MAX_SHARDS = 32;

// One shard's inputs (E rows each; R and f by mode: one value, E, or the
// (N, E) j-major block) and its row ends (-1 at a boundary).
struct CondenseShard {
    const double* h_e;
    const double* R;
    const double* f;
    const double* start_pbc;
    const double* end_pbc;
    const int* edge_src;
    const int* edge_tgt;
};

// A launch over S <= M shards: shard j writes row s0 + j of each output
// plane of the (5, rows, E) buffer.  The host passes CondenseArgs (a ctypes
// Structure of the same fields, one per plan or group and chunk); a
// one-shard launch copies it into the one-shard instance (120 bytes of
// parameter, read at a constant index), any other launch passes all 1.8 KB.
template <int M>
struct CondenseArgsT {
    int S;
    int s0;
    int rows;
    int E;
    int N;
    int R_mode;
    int f_mode;
    double wt;
    double cs0;
    double cs1;
    double g_closed;
    CondenseShard s[M];
};

using CondenseArgs = CondenseArgsT<CONDENSE_MAX_SHARDS>;

// A launch over S scenarios of one plan: scenario s reads each input at
// s times its stride (0: one row for all scenarios) and writes row s of
// each output plane of the (5, S, E) buffer.
struct CondenseScenArgs {
    int S;
    int E;
    int N;
    int R_mode;
    int f_mode;
    double wt;
    double cs0;
    double cs1;
    double g_closed;
    CondenseShard in;  // the plan's row ends and the scenarios' first rows
    long long sR;      // stride a scenario of R, f, start_pbc, end_pbc
    long long sf;
    long long ssp;
    long long sep;
};

namespace {

// coefficient modes, as passed by kernels/condense.py
constexpr int MODE_SCALAR = 0;
constexpr int MODE_EDGE = 1;
constexpr int MODE_CELL = 2;
constexpr int THREADS = 256;

// K1 of edge e: the five outputs at o, o + plane, ... (one thread an edge)
__device__ __forceinline__ void condense_edge(const CondenseShard& in, int e, int E, int N,
                                              int R_mode, int f_mode, double wt, double cs0,
                                              double cs1, double g_closed, double* o, size_t plane)
{
    const double h = __ldg(in.h_e + e);
    const double dN = static_cast<double>(N);
    const bool r_cell = R_mode == MODE_CELL;
    const bool f_cell = f_mode == MODE_CELL;

    // resistance side: a1 = R h per edge, or a2_c = R_c h per cell
    double a1 = 0.0, W;
    if (!r_cell) {
        a1 = __ldg(in.R + (R_mode == MODE_SCALAR ? 0 : e)) * h;
        W = a1 * (dN * wt);
    } else {
        double s = 0.0;
        for (int c = 0; c < N; ++c) s += __ldg(in.R + (size_t)c * E + e) * h;
        W = wt * s;
    }

    // source side: F1 = f h per edge, or F2_c = f_c h per cell
    double F1 = 0.0, Ftot, g;
    if (!f_cell) {
        F1 = __ldg(in.f + (f_mode == MODE_SCALAR ? 0 : e)) * h;
        Ftot = F1 * dN;
    }
    if (!r_cell && !f_cell) {
        g = a1 * F1 * g_closed;
    } else {
        // g = sum_c ab_c (cs0 cumF_c + cs1 cumF_{c+1}), one pass down the column
        double cum = 0.0, acc = 0.0;
        for (int c = 0; c < N; ++c) {
            const double next = f_cell ? cum + __ldg(in.f + (size_t)c * E + e) * h
                                       : F1 * static_cast<double>(c + 1);
            const double wsum = cs0 * cum + cs1 * next;
            acc += r_cell ? (__ldg(in.R + (size_t)c * E + e) * h) * wsum : wsum;
            cum = next;
        }
        if (f_cell) Ftot = cum;
        g = r_cell ? acc : a1 * acc;
    }

    const double w = 1.0 / W;
    const double not_s = __ldg(in.edge_src + e) >= 0 ? 0.0 : 1.0;
    const double not_t = __ldg(in.edge_tgt + e) >= 0 ? 0.0 : 1.0;
    const double cst = (-__ldg(in.start_pbc + e) * not_s + __ldg(in.end_pbc + e) * not_t - g) * w;
    o[0] = W;
    o[plane] = w;
    o[2 * plane] = g;
    o[3 * plane] = Ftot;
    o[4 * plane] = cst;
}

// grid (blocks over E, S): edge e of shard blockIdx.y
template <int M>
__global__ void __launch_bounds__(THREADS) condense_kernel(const CondenseArgsT<M> a,
                                                          double* __restrict__ out)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int E = a.E;
    if (e >= E) return;
    // one shard: a constant index, so its pointers are read from the
    // parameter space as the one-shard kernel read its arguments
    const CondenseShard in = a.s[M == 1 ? 0 : blockIdx.y];
    const size_t plane = static_cast<size_t>(a.rows) * E;
    condense_edge(in, e, E, a.N, a.R_mode, a.f_mode, a.wt, a.cs0, a.cs1, a.g_closed,
                  out + static_cast<size_t>(a.s0 + blockIdx.y) * E + e, plane);
}

// grid (blocks over E, min(S, 65,535)): edge e of scenarios blockIdx.y,
// blockIdx.y + gridDim.y, ...
__global__ void __launch_bounds__(THREADS) condense_scen_kernel(const CondenseScenArgs a,
                                                               double* __restrict__ out)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int E = a.E;
    if (e >= E) return;
    const size_t plane = static_cast<size_t>(a.S) * E;
    for (int s = blockIdx.y; s < a.S; s += gridDim.y) {
        CondenseShard in = a.in;
        in.R += s * a.sR;
        in.f += s * a.sf;
        in.start_pbc += s * a.ssp;
        in.end_pbc += s * a.sep;
        condense_edge(in, e, E, a.N, a.R_mode, a.f_mode, a.wt, a.cs0, a.cs1, a.g_closed,
                      out + static_cast<size_t>(s) * E + e, plane);
    }
}

template <int M>
int launch(const CondenseArgs* a, double* out, cudaStream_t stream)
{
    CondenseArgsT<M> b;
    b.S = a->S;
    b.s0 = a->s0;
    b.rows = a->rows;
    b.E = a->E;
    b.N = a->N;
    b.R_mode = a->R_mode;
    b.f_mode = a->f_mode;
    b.wt = a->wt;
    b.cs0 = a->cs0;
    b.cs1 = a->cs1;
    b.g_closed = a->g_closed;
    for (int j = 0; j < a->S; ++j) b.s[j] = a->s[j];
    const dim3 grid((a->E + THREADS - 1) / THREADS, a->S);
    condense_kernel<M><<<grid, THREADS, 0, stream>>>(b, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 of a->S scenarios of one plan into out (5, a->S, a->E), one grid.
extern "C" int nxfx_condense_scen(const CondenseScenArgs* a, double* out, cudaStream_t stream)
{
    if (a->S < 0 || a->E < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (a->S == 0 || a->E == 0) return 0;
    const dim3 grid((a->E + THREADS - 1) / THREADS, a->S < 65535 ? a->S : 65535);
    condense_scen_kernel<<<grid, THREADS, 0, stream>>>(*a, out);
    return static_cast<int>(cudaGetLastError());
}

// K1 of shards a->s0 .. a->s0 + a->S - 1 into out (5, a->rows, a->E), one grid.
extern "C" int nxfx_condense(const CondenseArgs* a, double* out, cudaStream_t stream)
{
    if (a->S < 0 || a->S > CONDENSE_MAX_SHARDS || a->E < 0 || a->s0 < 0 || a->s0 + a->S > a->rows)
        return static_cast<int>(cudaErrorInvalidValue);
    if (a->S == 0 || a->E == 0) return 0;
    return a->S == 1 ? launch<1>(a, out, stream) : launch<CONDENSE_MAX_SHARDS>(a, out, stream);
}

// ---------------------------------------------------------------- K1's transpose
//
// The blocked route's adjoint (adjoint.py; what jax.grad makes of the
// reference's _blocked_condense and the `const` line).  With a_e the
// edge's incidence column (+1 at its target bifurcation, -1 at its source,
// 0 at a boundary end), the lambda solve is S(w) lam = A const + T Ftot,
// S = sum_e w_e a_e a_e^T; given z = S^-1 rho (the adjoint solve) and
// K5's cotangents (expand_vjp: q0_bar, r0_bar, rN_bar), per internal edge:
//   const_bar = a_e^T z = z_t - z_s,   Ftot_bar = z_t
//   w_bar = q0_bar (r0 + rN - g) - (a_e^T z)(a_e^T lam) + const_bar const / w
//   g_bar = -(q0_bar + const_bar) w,   W_bar = -w_bar w^2
//   p_s's = -r0_bar - const_bar w (s a boundary),  p_t's = rN_bar + const_bar w (t a boundary)
// then back through W(R) = wt sum_c a_c, g = sum_c a_c (cs0 cumF_c + cs1
// cumF_{c+1}) (closed form when neither R nor f is per cell) and Ftot =
// cumF_N, added to K5's shares R_part, f_part: a forward walk down the
// column for a_c's cotangent, and in per-cell f mode a backward walk for
// the suffix sums of cumF's.  lam and z are read at the edge's ends
// through its row ends, as K5 reads lam.
//
// A per-edge or per-cell coefficient's cotangent is written over its part
// (R_bar may be R_part: each entry is read and written by its one thread).
// A scalar coefficient's is a sum over the edges, kept deterministic with
// no atomics: each block sums its edges in a halving tree into partial
// (R's row, then f's), and a second launch of one block adds the partials
// in block order, then halves.
//
// Bound: device-memory bytes, ~20 doubles an edge (10 MB at 16
// generations) plus the (N, E) blocks of a per-cell coefficient.

struct CondenseVjpArgs {
    int E;
    int N;
    int R_mode;
    int f_mode;
    int blocks;  // ceil(E / THREADS): the rows of partial
    double wt;
    double cs0;
    double cs1;
    double g_closed;
    const int* edge_src;
    const int* edge_tgt;
    const double* h_e;
    const double* R;
    const double* f;
    const double* start_pbc;
    const double* end_pbc;
    const double* w;
    const double* g;
    const double* lam;
    const double* z;
    const double* bars;    // (3, E): q0_bar, r0_bar, rN_bar
    const double* R_part;  // K5's share: (N, E) in cell mode, else (E,)
    const double* f_part;
    double* R_bar;  // (1,) for a scalar coefficient, else its part's shape (may be R_part)
    double* f_bar;
    double* sp_bar;
    double* ep_bar;
    double* partial;  // (2, blocks)
};

namespace {

// the block's sum of v in a halving tree (every thread calls it)
__device__ double block_sum(double v, double* part)
{
    part[threadIdx.x] = v;
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) part[threadIdx.x] = part[threadIdx.x] + part[threadIdx.x + half];
        __syncthreads();
    }
    const double out = part[0];
    __syncthreads();
    return out;
}

__global__ void __launch_bounds__(THREADS) condense_vjp_kernel(const CondenseVjpArgs a)
{
    __shared__ double part[THREADS];
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int E = a.E, N = a.N;
    const bool r_cell = a.R_mode == MODE_CELL;
    const bool f_cell = a.f_mode == MODE_CELL;
    double R_sum = 0.0, f_sum = 0.0;  // the edge's share of a scalar coefficient's cotangent
    if (e < E) {
        const int s = a.edge_src[e];
        const int t = a.edge_tgt[e];
        const double ls = s >= 0 ? a.lam[s] : 0.0;
        const double lt = t >= 0 ? a.lam[t] : 0.0;
        const double zs = s >= 0 ? a.z[s] : 0.0;
        const double zt = t >= 0 ? a.z[t] : 0.0;
        const double sp = a.start_pbc[e], ep = a.end_pbc[e], ge = a.g[e], we = a.w[e];
        const double not_s = s >= 0 ? 0.0 : 1.0;
        const double not_t = t >= 0 ? 0.0 : 1.0;
        const double r0 = s >= 0 ? ls : -sp;
        const double rN = t >= 0 ? -lt : ep;
        const double num = r0 + rN - ge;
        const double cnum = -sp * not_s + ep * not_t - ge;
        const double q0b = a.bars[e], r0b = a.bars[(size_t)E + e], rNb = a.bars[2 * (size_t)E + e];
        const double az = zt - zs;
        const double wb = q0b * num - az * (lt - ls) + az * cnum;
        const double gb = -(q0b + az) * we;
        const double Wb = -wb * we * we;
        a.sp_bar[e] = s >= 0 ? 0.0 : -r0b - az * we;
        a.ep_bar[e] = t >= 0 ? 0.0 : rNb + az * we;

        const double h = a.h_e[e];
        const double dN = static_cast<double>(N);
        const double a1 = r_cell ? 0.0 : a.R[a.R_mode == MODE_SCALAR ? 0 : e] * h;
        const double F1 = f_cell ? 0.0 : a.f[a.f_mode == MODE_SCALAR ? 0 : e] * h;
        double a1b = 0.0, F1b = 0.0;
        if (!r_cell && !f_cell) {
            a1b = Wb * (dN * a.wt) + gb * F1 * a.g_closed;
            F1b = gb * a1 * a.g_closed + zt * dN;
        } else {
            double cum = 0.0, wsum_sum = 0.0, moment = 0.0;
            for (int c = 0; c < N; ++c) {
                const size_t ic = (size_t)c * E + e;
                const double next = f_cell ? cum + a.f[ic] * h : F1 * static_cast<double>(c + 1);
                const double wsum = a.cs0 * cum + a.cs1 * next;
                const double ab = r_cell ? a.R[ic] * h : a1;
                if (r_cell)
                    a.R_bar[ic] = a.R_part[ic] + (gb * wsum + Wb * a.wt) * h;
                else
                    wsum_sum += wsum;
                if (!f_cell)
                    moment += ab * (a.cs0 * static_cast<double>(c) + a.cs1 * static_cast<double>(c + 1));
                cum = next;
            }
            a1b = Wb * (dN * a.wt) + gb * wsum_sum;
            if (f_cell) {
                // cumF_j's cotangent g_bar (cs0 a_j + cs1 a_{j-1}), summed from j = c + 1 up
                double suffix = 0.0, ab_next = 0.0;
                for (int c = N - 1; c >= 0; --c) {
                    const size_t ic = (size_t)c * E + e;
                    const double ab = r_cell ? a.R[ic] * h : a1;
                    suffix += gb * (a.cs0 * ab_next + a.cs1 * ab);
                    a.f_bar[ic] = a.f_part[ic] + (suffix + zt) * h;
                    ab_next = ab;
                }
            } else {
                F1b = gb * moment + zt * dN;
            }
        }
        if (!r_cell) {
            const double v = a.R_part[e] + a1b * h;
            if (a.R_mode == MODE_SCALAR)
                R_sum = v;
            else
                a.R_bar[e] = v;
        }
        if (!f_cell) {
            const double v = a.f_part[e] + F1b * h;
            if (a.f_mode == MODE_SCALAR)
                f_sum = v;
            else
                a.f_bar[e] = v;
        }
    }
    if (a.R_mode == MODE_SCALAR) {
        const double v = block_sum(R_sum, part);
        if (threadIdx.x == 0) a.partial[blockIdx.x] = v;
    }
    if (a.f_mode == MODE_SCALAR) {
        const double v = block_sum(f_sum, part);
        if (threadIdx.x == 0) a.partial[(size_t)a.blocks + blockIdx.x] = v;
    }
}

// one block: each scalar coefficient's partials added in block order (a
// thread's strided run, then the halving tree)
__global__ void __launch_bounds__(THREADS) condense_vjp_finish(const CondenseVjpArgs a)
{
    __shared__ double part[THREADS];
    for (int row = 0; row < 2; ++row) {
        if ((row == 0 ? a.R_mode : a.f_mode) != MODE_SCALAR) continue;
        double acc = 0.0;
        for (int i = threadIdx.x; i < a.blocks; i += THREADS) acc += a.partial[(size_t)row * a.blocks + i];
        const double v = block_sum(acc, part);
        if (threadIdx.x == 0) *(row == 0 ? a.R_bar : a.f_bar) = v;
    }
}

}  // namespace

// K1's transpose over the a->E edges: one launch, and a second of one block
// when R or f is a scalar.
extern "C" int nxfx_condense_vjp(const CondenseVjpArgs* a, cudaStream_t stream)
{
    if (a->E < 1 || a->N < 1 || a->blocks != (a->E + THREADS - 1) / THREADS)
        return static_cast<int>(cudaErrorInvalidValue);
    condense_vjp_kernel<<<a->blocks, THREADS, 0, stream>>>(*a);
    const int code = static_cast<int>(cudaGetLastError());
    if (code != 0 || (a->R_mode != MODE_SCALAR && a->f_mode != MODE_SCALAR)) return code;
    condense_vjp_finish<<<1, THREADS, 0, stream>>>(*a);
    return static_cast<int>(cudaGetLastError());
}
