// K15: the apply of the tree multifrontal core elimination.
//
// Replaces networks_fenicsx_tpu/ops/multifrontal.py:_mf_sweep and _mf_apply.
// One sweep solves the core against the factor of mf_factor.cu (per front:
// L, the Cholesky factor of the pivot block, with L^T above its diagonal,
// and Y = L^-1 F_SB):
//   forward, levels bottom-up, one block per front:
//       b_S = rc[nodes] (0 on a padded pivot), b_B = 0,
//       b[i] += v_child[a] for each consumed child row a that rel maps to i, in plan order,
//       y = L^-1 b_S (kept in the y stream),  u = b_B - Y^T y  (the front's v pool)
//   backward, levels top-down:
//       z = L^-T (y - Y lambda[bndpos])  (ancestors' values, already written;
//       pad position lam_len reads 0), written at the group's lam_off
//   x = lambda[lam_pos]  (or x += ..., for a refinement pass)
// which is the reference's u = b_B - X^T b_S and z = F_SS^-1 b_S - X lambda_B
// with X = F_SS^-1 F_SB.  The refinement residual r = rc - (dc x + folds of
// vals x[other]) takes a terms pass, two K10 folds (fold.py) and a combine
// pass; a tripped factor gate sets x to NaN.
//
// Bound: the factor's 49 MB, read once a sweep, and the sweeps' vectors
// (~1 MB) on the web; what costs is the chain of dependent fronts.
// Design: the level schedule of the factor (ops/multifrontal.py:
// mf_schedule).  A sweep is one forward launch per level, bottom-up, one
// backward launch per level, top-down, and the gather: 2 L + 1 launches
// for L levels (29 on the web, where it was 2 G + 1 = 189 for G groups).
// A block reads its (group, front) from the schedule's device table and the
// group's row from the device group table; a level that holds wide fronts
// (m > 160: the factor's cluster path) takes 512 threads a block, the
// others 256.  The children's v is
// folded in by a thread an index from the index's work list (xadd: the
// child slots that rel maps to it, in plan order), with no barrier between
// children, so every entry takes its contributions in the plan's order
// (bit for bit the gather's).  The triangles are solved on the front's
// vector in shared memory, a 32-row block at a time by warp 0 with
// reciprocal pivots, the block staged in shared memory (lower_solve_block).  The launches hold no state
// across calls: two streams and CUDA-graph replays are safe.
//
// S right-hand sides (a sweep on the tree route, a tree factorization's
// solve_batch) take the launches of one apply: every launch takes the
// scenario as its grid's y (min(S, 65,535) rows walking the scenarios y,
// y + gridDim.y, ...), each scenario with its own stride into rc, the
// factor (0: one factor for all, as a shared R gives), the v pools, the y
// and lambda streams, x, the refinement's terms and residual and the gate
// flag.  The scenario only selects base pointers: each row is the
// one-scenario launch's bits.  The buffers
// a thread writes and another reads after a barrier carry no __restrict__
// (with it the compiler may keep a value in a register across the barrier).

#include <cuda_runtime.h>

#include "dmma.cuh"

namespace {

constexpr int THREADS = 256;       // the elementwise passes, and the fronts of a level
constexpr int WIDE_THREADS = 512;  // ... that holds wide fronts (the schedule's L_WIDE)

enum { G_K, G_W, G_B, G_C, G_NODES, G_CVAL, G_BNDPOS, G_LAM, G_FAC, G_POOL, G_VPOOL, G_CONS,
       G_NCONS, G_XADD, G_COLS };
enum { L_START, L_WIDE, L_COUNT, L_WIDE_M, L_NARROW_M, L_COLS };
enum { X_UROW, X_REL, X_CB, X_V, X_COLS };

inline int blocks_for(long long n) { return static_cast<int>((n + THREADS - 1) / THREADS); }

// Warp 0: the nb x nb diagonal block at (k0, k0) of L (row stride ld) into
// Ls (row stride 33), zero right of column nb, by cp.async (every row's copy
// in flight at once, no registers held).
__device__ __forceinline__ void stage_block(double* Ls, const double* L, int ld, int k0, int nb)
{
    const int lane = threadIdx.x & 31;
    for (int c = 0; c < nb; ++c) {
        if (lane < nb) tc_cp_async8(Ls + c * 33 + lane, L + static_cast<size_t>(k0 + c) * ld + k0 + lane);
        else Ls[c * 33 + lane] = 0.0;
    }
    tc_cp_commit();
    tc_cp_wait<0>();
    __syncwarp();
}

// v <- L^-1 v for the n x n lower-triangular L (row stride ld) whose strict
// upper triangle holds L^T, by the whole block, v in shared memory.  Per
// block of 32 rows: warp 0 stages the diagonal block in Ls (shared, row
// stride 33: Ls[c][l] is entry (k0 + c, k0 + l), L^T right of the diagonal,
// read along rows) and
// solves the diagonal block (lane l holds v[k0 + l] and the reciprocal of
// its pivot, taken before the chain so that no division waits in it; one
// shuffle per step), then every thread subtracts the block's part from its
// rows below, reading L^T along rows.  Each entry takes its updates in
// column order, as the column-oriented solve does.  Ends with a barrier.
__device__ void lower_solve_block(const double* L, int n, int ld, double* v, double* Ls)
{
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    for (int k0 = 0; k0 < n; k0 += 32) {
        const int nb = n - k0 < 32 ? n - k0 : 32;
        if (tid < 32) {
            stage_block(Ls, L, ld, k0, nb);
            double x = lane < nb ? v[k0 + lane] : 0.0;
            const double inv = lane < nb ? 1.0 / Ls[lane * 33 + lane] : 0.0;
#pragma unroll
            for (int c = 0; c < 32; ++c) {
                if (c < nb) {
                    if (lane == c) x = x * inv;
                    const double xc = __shfl_sync(0xffffffffu, x, c);
                    if (lane > c) x = x - Ls[c * 33 + lane] * xc;
                }
            }
            if (lane < nb) v[k0 + lane] = x;
        }
        __syncthreads();
        for (int i = k0 + nb + tid; i < n; i += blockDim.x) {
            double acc = v[i];
#pragma unroll 16
            for (int c = 0; c < nb; ++c)
                acc = acc - L[static_cast<size_t>(k0 + c) * ld + i] * v[k0 + c];
            v[i] = acc;
        }
        __syncthreads();
    }
}

// v <- L^-T v for the same L, by the whole block, v in shared memory: the
// blocks of 32 rows from the bottom, each staged in Ls as above and solved
// by warp 0 (lane l holds row l of the block's rows of L and the
// reciprocal of its pivot), then its part subtracted from the rows above
// along L's rows.  Ends with a barrier.
__device__ void lower_transpose_solve_block(const double* L, int n, int ld, double* v, double* Ls)
{
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    for (int k1 = n; k1 > 0; k1 -= 32) {
        const int k0 = k1 > 32 ? k1 - 32 : 0;
        const int nb = k1 - k0;
        if (tid < 32) {
            stage_block(Ls, L, ld, k0, nb);
            double x = lane < nb ? v[k0 + lane] : 0.0;
            const double inv = lane < nb ? 1.0 / Ls[lane * 33 + lane] : 0.0;
#pragma unroll
            for (int c = 31; c >= 0; --c) {
                if (c < nb) {
                    if (lane == c) x = x * inv;
                    const double xc = __shfl_sync(0xffffffffu, x, c);
                    if (lane < c) x = x - Ls[c * 33 + lane] * xc;
                }
            }
            if (lane < nb) v[k0 + lane] = x;
        }
        __syncthreads();
        for (int i = tid; i < k0; i += blockDim.x) {
            double acc = v[i];
#pragma unroll 16
            for (int c = nb - 1; c >= 0; --c)
                acc = acc - L[static_cast<size_t>(k0 + c) * ld + i] * v[k0 + c];
            v[i] = acc;
        }
        __syncthreads();
    }
}

struct SweepArgs {
    int n_core;
    int lam_len;
    const long long* groups;   // (G, G_COLS) on the device
    const int* fronts;         // (n_fronts, 2): (group, front) by level
    const double* rc;          // (n_core,)
    const int* nodes_all;
    const int* bndpos_all;
    const int* xadd_ptr;       // the extend-add's work lists by parent index
    const int* xadd;           // (n, X_COLS): a child row's offsets
    const double* fac;
    double* vpools;            // every group's v pool (children read, each front writes its own)
    double* ys;                // (lam_len,) the y stream
    double* lam;               // (lam_len,) the lambda stream (ancestors read)
    int S;                     // scenarios (1: one apply)
    long long s_rc, s_fac, s_vp;  // strides of rc, fac (0: shared) and vpools; ys and lam lam_len
};

// scenario z's arguments: each buffer its stride z further on
__device__ __forceinline__ SweepArgs scenario(const SweepArgs& A, int z)
{
    const size_t Z = static_cast<size_t>(z);
    SweepArgs a = A;
    a.rc = A.rc + Z * A.s_rc;
    a.fac = A.fac + Z * A.s_fac;
    a.vpools = A.vpools + Z * A.s_vp;
    a.ys = A.ys + Z * A.lam_len;
    a.lam = A.lam + Z * A.lam_len;
    return a;
}

__device__ void forward_front(const SweepArgs& a, int first, double* bv, double* Ls)
{
    const int f = first + blockIdx.x;
    const long long* row = a.groups + static_cast<size_t>(a.fronts[2 * f]) * G_COLS;
    const int p = a.fronts[2 * f + 1];
    const int tid = threadIdx.x;
    const int w = static_cast<int>(row[G_W]), b = static_cast<int>(row[G_B]), m = w + b;
    const double* F = a.fac + row[G_FAC] + static_cast<size_t>(p) * m * m;
    const int* nodes = a.nodes_all + row[G_NODES] + static_cast<size_t>(p) * w;

    // b = rc on the pivots, 0 on the boundary, plus the children's v in plan
    // order: a thread an index, from its work list (no barrier between children)
    const int* xp = a.xadd_ptr + row[G_XADD] + static_cast<size_t>(p) * m;
    for (int i = tid; i < m; i += blockDim.x) {
        const int node = i < w ? nodes[i] : a.n_core;
        double acc = node < a.n_core ? a.rc[node] : 0.0;
#pragma unroll 4
        for (int t = xp[i]; t < xp[i + 1]; ++t) acc = acc + a.vpools[a.xadd[X_COLS * t + X_V]];
        bv[i] = acc;
    }
    __syncthreads();
    lower_solve_block(F, w, m, bv, Ls);  // y = L^-1 b_S
    double* u = a.vpools + row[G_VPOOL] + static_cast<size_t>(p) * b;
    const int lane = tid & 31;
    for (int j = tid >> 5; j < b; j += blockDim.x >> 5) {  // u = b_B - Y^T y, a warp per row
        const double* Yt = F + static_cast<size_t>(w + j) * m;
        double acc = 0.0;
        for (int i = lane; i < w; i += 32) acc = acc + Yt[i] * bv[i];
        for (int off = 16; off > 0; off >>= 1) acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) u[j] = bv[w + j] - acc;
    }
    double* ys = a.ys + row[G_LAM] + static_cast<size_t>(p) * w;
    for (int i = tid; i < w; i += blockDim.x) ys[i] = bv[i];
}

__global__ void __launch_bounds__(WIDE_THREADS, 2) mf_forward_kernel(SweepArgs a0, int first)
{
    extern __shared__ double bv[];     // (m,): b, then y = L^-1 b_S in the first w
    __shared__ double Ls[32 * 33];     // a diagonal block of L
    for (int z = blockIdx.y; z < a0.S; z += gridDim.y) {  // a block a scenario's front
        forward_front(scenario(a0, z), first, bv, Ls);
        __syncthreads();
    }
}

__device__ void backward_front(const SweepArgs& a, int first, double* z, double* Ls)
{
    const int f = first + blockIdx.x;
    const long long* row = a.groups + static_cast<size_t>(a.fronts[2 * f]) * G_COLS;
    const int p = a.fronts[2 * f + 1];
    const int tid = threadIdx.x;
    const int w = static_cast<int>(row[G_W]), b = static_cast<int>(row[G_B]), m = w + b;
    const double* F = a.fac + row[G_FAC] + static_cast<size_t>(p) * m * m;
    const double* y = a.ys + row[G_LAM] + static_cast<size_t>(p) * w;
    const int* bp = a.bndpos_all + row[G_BNDPOS] + static_cast<size_t>(p) * b;

    double* lb = z + w;  // lambda_B, staged
    for (int j = tid; j < b; j += blockDim.x) {
        const int q = bp[j];
        lb[j] = q < a.lam_len ? a.lam[q] : 0.0;
    }
    __syncthreads();
    for (int i = tid; i < w; i += blockDim.x) {  // z = y - Y lambda_B
        double acc = 0.0;
        for (int j = 0; j < b; ++j) acc = acc + F[static_cast<size_t>(w + j) * m + i] * lb[j];
        z[i] = y[i] - acc;
    }
    __syncthreads();
    lower_transpose_solve_block(F, w, m, z, Ls);  // z = L^-T z
    double* out = a.lam + row[G_LAM] + static_cast<size_t>(p) * w;
    for (int i = tid; i < w; i += blockDim.x) out[i] = z[i];
}

__global__ void __launch_bounds__(WIDE_THREADS, 2) mf_backward_kernel(SweepArgs a0, int first)
{
    extern __shared__ double zs[];     // (m,): y - Y lambda_B, then L^-T of it; lambda_B after w
    __shared__ double Ls[32 * 33];     // a diagonal block of L
    for (int z = blockIdx.y; z < a0.S; z += gridDim.y) {  // a block a scenario's front
        backward_front(scenario(a0, z), first, zs, Ls);
        __syncthreads();
    }
}

// The elementwise passes: scenario z's rows their strides z further on (a
// lambda stream lam_len, x and r n, the terms P0, the folds n_i and n_j).
__global__ void mf_gather_kernel(
    int n, const int* __restrict__ lam_pos, const double* __restrict__ lam, int accumulate,
    double* __restrict__ x, int S, long long s_lam)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const size_t Z = static_cast<size_t>(z);
        const double v = lam[Z * s_lam + lam_pos[i]];
        double* xz = x + Z * n;
        xz[i] = accumulate ? xz[i] + v : v;
    }
}

__global__ void mf_terms_kernel(
    int P0, const double* __restrict__ vals, const int* __restrict__ pci,
    const int* __restrict__ pcj, const double* __restrict__ x,
    double* __restrict__ ti, double* __restrict__ tj, int S, long long s_vals, int n)
{
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P0) return;
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const size_t Z = static_cast<size_t>(z);
        const double v = vals[Z * s_vals + p];
        const double* xz = x + Z * n;
        ti[Z * P0 + p] = v * xz[pcj[p]];  // pairs touch row ci with -w x[cj]
        tj[Z * P0 + p] = v * xz[pci[p]];
    }
}

__global__ void mf_residual_kernel(
    int n, const double* __restrict__ rc, const double* __restrict__ dc,
    const double* __restrict__ x,
    const int* __restrict__ inv_i, int n_i, const double* __restrict__ si,
    const int* __restrict__ inv_j, int n_j, const double* __restrict__ sj,
    double* __restrict__ r, int S, long long s_rc, long long s_dc)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int a = inv_i[i], c = inv_j[i];
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const size_t Z = static_cast<size_t>(z);
        const double* xz = x + Z * n;
        const double ax = dc[Z * s_dc + i] * xz[i] + (a < n_i ? si[Z * n_i + a] : 0.0)
                          + (c < n_j ? sj[Z * n_j + c] : 0.0);
        r[Z * n + i] = rc[Z * s_rc + i] - ax;
    }
}

__global__ void mf_gate_kernel(int n, const int* __restrict__ ok, double* __restrict__ x, int S,
                               long long s_ok)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const size_t Z = static_cast<size_t>(z);
        if (!ok[Z * s_ok]) x[Z * n + i] = __longlong_as_double(0x7ff8000000000000LL);
    }
}

inline unsigned scen_rows(int S) { return S < 65535 ? S : 65535; }

// Raise the dynamic shared memory of the kernels k1 (and k2) to bytes where
// that is beyond what was set on this device before (the default, 48 KB
// less the kernel's static shared memory, may be too little below 48 KB), so
// that a launch captured in a CUDA graph after a first call sets no attribute.
template <typename K1, typename K2>
cudaError_t allow_shared(int bytes, K1 k1, K2 k2)
{
    static int granted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev >= 64 || bytes <= granted[dev]) return err;
    err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && k2 != nullptr)
        err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) granted[dev] = bytes;
    return err;
}

}  // namespace

namespace {

int mf_sweep_launch(
    int n_levels, const long long* levels, int n_core, int lam_len, int S,
    const long long* groups, const int* fronts,
    long long s_rc, const double* rc, const int* nodes_all, const int* bndpos_all,
    const int* xadd_ptr, const int* xadd, const int* lam_pos,
    long long s_fac, const double* fac, long long s_vp, double* vpools, double* ys, double* lam, double* x,
    int accumulate, cudaStream_t stream)
{
    cudaError_t err;
    if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
    long long m_max = 0;
    for (int l = 0; l < n_levels; ++l) {
        const long long* lv = levels + static_cast<size_t>(l) * L_COLS;
        const long long m = lv[L_WIDE_M] > lv[L_NARROW_M] ? lv[L_WIDE_M] : lv[L_NARROW_M];
        m_max = m > m_max ? m : m_max;
    }
    if ((err = allow_shared(static_cast<int>(m_max * sizeof(double)), mf_forward_kernel,
                            mf_backward_kernel)) != cudaSuccess)
        return static_cast<int>(err);
    SweepArgs a{n_core, lam_len, groups, fronts, rc, nodes_all, bndpos_all, xadd_ptr, xadd, fac,
                vpools, ys, lam, S, s_rc, s_fac, s_vp};
    const unsigned ys_rows = scen_rows(S);
    for (int pass = 0; pass < 2; ++pass) {  // forward bottom-up, then backward top-down
        for (int i = 0; i < n_levels; ++i) {
            const long long* lv = levels + static_cast<size_t>(pass ? n_levels - 1 - i : i) * L_COLS;
            const long long m = lv[L_WIDE_M] > lv[L_NARROW_M] ? lv[L_WIDE_M] : lv[L_NARROW_M];
            const int threads = lv[L_WIDE] > 0 ? WIDE_THREADS : THREADS;
            const size_t shared = static_cast<size_t>(m) * sizeof(double);
            const int count = static_cast<int>(lv[L_COUNT]), start = static_cast<int>(lv[L_START]);
            if (pass == 0) mf_forward_kernel<<<dim3(count, ys_rows), threads, shared, stream>>>(a, start);
            else mf_backward_kernel<<<dim3(count, ys_rows), threads, shared, stream>>>(a, start);
            if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
        }
    }
    mf_gather_kernel<<<dim3(blocks_for(n_core), ys_rows), THREADS, 0, stream>>>(n_core, lam_pos, lam, accumulate,
                                                                               x, S, lam_len);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One sweep: x = sweep(rc) (accumulate = 0) or x += sweep(rc) (accumulate = 1).
// levels: host (n_levels, L_COLS) table; groups, fronts: device tables.
extern "C" int nxfx_mf_sweep(
    int n_levels, const long long* levels, int n_core, int lam_len,
    const long long* groups, const int* fronts,
    const double* rc, const int* nodes_all, const int* bndpos_all,
    const int* xadd_ptr, const int* xadd, const int* lam_pos,
    const double* fac, double* vpools, double* ys, double* lam, double* x, int accumulate,
    cudaStream_t stream)
{
    return mf_sweep_launch(n_levels, levels, n_core, lam_len, 1, groups, fronts, 0, rc, nodes_all, bndpos_all,
                           xadd_ptr, xadd, lam_pos, 0, fac, 0, vpools, ys, lam, x, accumulate, stream);
}

// The same sweep of S right-hand sides in its launches: rc rows s_rc apart,
// the factor s_fac (0: one factor), vpools s_vp; ys, lam (S, lam_len), x (S, n).
extern "C" int nxfx_mf_sweep_scen(
    int n_levels, const long long* levels, int n_core, int lam_len, int S,
    const long long* groups, const int* fronts,
    long long s_rc, const double* rc, const int* nodes_all, const int* bndpos_all,
    const int* xadd_ptr, const int* xadd, const int* lam_pos,
    long long s_fac, const double* fac, long long s_vp, double* vpools, double* ys, double* lam, double* x,
    int accumulate, cudaStream_t stream)
{
    return mf_sweep_launch(n_levels, levels, n_core, lam_len, S, groups, fronts, s_rc, rc, nodes_all, bndpos_all,
                           xadd_ptr, xadd, lam_pos, s_fac, fac, s_vp, vpools, ys, lam, x, accumulate, stream);
}

extern "C" int nxfx_mf_terms(
    int P0, const double* vals, const int* pci, const int* pcj, const double* x,
    double* ti, double* tj, cudaStream_t stream)
{
    if (P0 <= 0) return 0;
    mf_terms_kernel<<<blocks_for(P0), THREADS, 0, stream>>>(P0, vals, pci, pcj, x, ti, tj, 1, 0, 0);
    return static_cast<int>(cudaGetLastError());
}

// S scenarios: vals rows s_vals apart (0: shared), x (S, n), ti, tj (S, P0)
extern "C" int nxfx_mf_terms_scen(
    int P0, int n, int S, long long s_vals, const double* vals, const int* pci, const int* pcj,
    const double* x, double* ti, double* tj, cudaStream_t stream)
{
    if (P0 <= 0 || S <= 0) return 0;
    mf_terms_kernel<<<dim3(blocks_for(P0), scen_rows(S)), THREADS, 0, stream>>>(P0, vals, pci, pcj, x, ti, tj,
                                                                               S, s_vals, n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_mf_residual(
    int n, const double* rc, const double* dc, const double* x,
    const int* inv_i, int n_i, const double* si, const int* inv_j, int n_j, const double* sj,
    double* r, cudaStream_t stream)
{
    if (n <= 0) return 0;
    mf_residual_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
        n, rc, dc, x, inv_i, n_i, si, inv_j, n_j, sj, r, 1, 0, 0);
    return static_cast<int>(cudaGetLastError());
}

// S scenarios: rc, dc rows s_rc, s_dc apart (0: shared), x and r (S, n),
// si (S, n_i), sj (S, n_j)
extern "C" int nxfx_mf_residual_scen(
    int n, int S, long long s_rc, const double* rc, long long s_dc, const double* dc, const double* x,
    const int* inv_i, int n_i, const double* si, const int* inv_j, int n_j, const double* sj,
    double* r, cudaStream_t stream)
{
    if (n <= 0 || S <= 0) return 0;
    mf_residual_kernel<<<dim3(blocks_for(n), scen_rows(S)), THREADS, 0, stream>>>(
        n, rc, dc, x, inv_i, n_i, si, inv_j, n_j, sj, r, S, s_rc, s_dc);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_mf_gate(int n, const int* ok, double* x, cudaStream_t stream)
{
    if (n <= 0) return 0;
    mf_gate_kernel<<<blocks_for(n), THREADS, 0, stream>>>(n, ok, x, 1, 0);
    return static_cast<int>(cudaGetLastError());
}

// S scenarios: ok s_ok apart (0: one factor's), x (S, n)
extern "C" int nxfx_mf_gate_scen(int n, int S, long long s_ok, const int* ok, double* x, cudaStream_t stream)
{
    if (n <= 0 || S <= 0) return 0;
    mf_gate_kernel<<<dim3(blocks_for(n), scen_rows(S)), THREADS, 0, stream>>>(n, ok, x, S, s_ok);
    return static_cast<int>(cudaGetLastError());
}
