// K15: the apply of the tree multifrontal core elimination.
//
// Replaces networks_fenicsx_tpu/ops/multifrontal.py:_mf_sweep and _mf_apply.
// One sweep solves the core against the factor of mf_factor.cu (per front:
// L, the Cholesky factor of the pivot block, with L^T above its diagonal,
// and Y = L^-1 F_SB):
//   forward, groups in order, one block per front:
//       b_S = rc[nodes] (0 on a padded pivot), b_B = 0,
//       b += v_child[lminv] for each consumed child group (pads read as 0),
//       y = L^-1 b_S (kept in the y stream),  u = b_B - Y^T y  (the front's v pool)
//   backward, groups reversed:
//       z = L^-T (y - Y lambda[bndpos])  (ancestors' values, already written;
//       pad position lam_len reads 0), written at the group's lam_off
//   x = lambda[lam_pos]  (or x += ..., for a refinement pass)
// which is the reference's u = b_B - X^T b_S and z = F_SS^-1 b_S - X lambda_B
// with X = F_SS^-1 F_SB.  The refinement residual r = rc - (dc x + folds of
// vals x[other]) takes a terms pass, two K10 folds (fold.py) and a combine
// pass; a tripped factor gate sets x to NaN.
//
// Bound: launch latency and the per-front triangular solves (blocks of 32
// rows, each solved by one warp, on the front's vector staged in shared
// memory: right_looking_cholesky.cuh).  A sweep is 2 G + 1 launches
// for G groups, made from one C loop over the host group table.

#include <cuda_runtime.h>

#include "right_looking_cholesky.cuh"

namespace {

constexpr int THREADS = 256;

enum { G_K, G_W, G_B, G_C, G_NODES, G_CVAL, G_BNDPOS, G_LAM, G_FAC, G_POOL, G_VPOOL, G_CONS,
       G_NCONS, G_COLS };
enum { C_POOL, C_VPOOL, C_K, C_B, C_CIDX, C_LMINV, C_COLS };

inline int blocks_for(long long n) { return static_cast<int>((n + THREADS - 1) / THREADS); }

__global__ void __launch_bounds__(THREADS) mf_forward_kernel(
    int w, int b, int n_core,
    const int* __restrict__ nodes,     // (k, w)
    const double* __restrict__ rc,     // (n_core,)
    const long long* __restrict__ cons, int n_cons,
    const int* __restrict__ cidx_all,
    const int* __restrict__ lminv_all,
    const double* vpools,              // every group's v pool (children read)
    const double* __restrict__ fac,    // (k, m, m)
    double* __restrict__ ys,           // (k, w): this group's y segment
    double* vpool)                     // (k, b): this group's, inside vpools
{
    extern __shared__ double y[];      // (w,): b_S, then L^-1 b_S
    const int p = blockIdx.x;
    const int tid = threadIdx.x;
    const int m = w + b;
    const double* F = fac + static_cast<size_t>(p) * m * m;
    double* u = vpool + static_cast<size_t>(p) * b;

    for (int i = tid; i < w; i += blockDim.x) {
        const int node = nodes[static_cast<size_t>(p) * w + i];
        y[i] = node < n_core ? rc[node] : 0.0;
    }
    for (int j = tid; j < b; j += blockDim.x) u[j] = 0.0;
    __syncthreads();
    for (int ce = 0; ce < n_cons; ++ce) {
        const long long* row = cons + static_cast<size_t>(ce) * C_COLS;
        const int kc = static_cast<int>(row[C_K]);
        const int cb = static_cast<int>(row[C_B]);
        const int child = cidx_all[row[C_CIDX] + p];
        if (child < kc) {
            const double* V = vpools + row[C_VPOOL] + static_cast<size_t>(child) * cb;
            const int* lm = lminv_all + row[C_LMINV] + static_cast<size_t>(p) * m;
            for (int i = tid; i < m; i += blockDim.x) {
                const int a = lm[i];
                if (a < cb) {
                    if (i < w) y[i] = y[i] + V[a];
                    else u[i - w] = u[i - w] + V[a];
                }
            }
        }
        __syncthreads();
    }
    lower_solve_block(F, w, m, y);  // y = L^-1 b_S
    const int lane = tid & 31;
    for (int j = tid >> 5; j < b; j += blockDim.x >> 5) {  // u = b_B - Y^T y, a warp per row
        const double* Yt = F + static_cast<size_t>(w + j) * m;
        double acc = 0.0;
        for (int i = lane; i < w; i += 32) acc = acc + Yt[i] * y[i];
        for (int off = 16; off > 0; off >>= 1) acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) u[j] = u[j] - acc;
    }
    for (int i = tid; i < w; i += blockDim.x) ys[static_cast<size_t>(p) * w + i] = y[i];
}

__global__ void __launch_bounds__(THREADS) mf_backward_kernel(
    int w, int b, int lam_len,
    const int* __restrict__ bndpos,    // (k, b)
    const double* __restrict__ fac,    // (k, m, m)
    const double* __restrict__ ys,     // (k, w)
    const double* lam,                 // (lam_len,) stream; ancestors' segments
    double* z_out)                     // lam + lam_off: this group's (k, w)
{
    extern __shared__ double z[];      // (w,): y - Y lambda_B, then L^-T of it
    const int p = blockIdx.x;
    const int tid = threadIdx.x;
    const int m = w + b;
    const double* F = fac + static_cast<size_t>(p) * m * m;
    const double* y = ys + static_cast<size_t>(p) * w;
    const int* bp = bndpos + static_cast<size_t>(p) * b;

    for (int i = tid; i < w; i += blockDim.x) {  // z = y - Y lambda_B
        double acc = 0.0;
        for (int j = 0; j < b; ++j) {
            const int q = bp[j];
            const double lb = q < lam_len ? lam[q] : 0.0;
            acc = acc + F[static_cast<size_t>(w + j) * m + i] * lb;
        }
        z[i] = y[i] - acc;
    }
    __syncthreads();
    lower_transpose_solve_block(F, w, m, z);  // z = L^-T z
    for (int i = tid; i < w; i += blockDim.x) z_out[static_cast<size_t>(p) * w + i] = z[i];
}

__global__ void mf_gather_kernel(
    int n, const int* __restrict__ lam_pos, const double* __restrict__ lam, int accumulate,
    double* __restrict__ x)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const double v = lam[lam_pos[i]];
    x[i] = accumulate ? x[i] + v : v;
}

__global__ void mf_terms_kernel(
    int P0, const double* __restrict__ vals, const int* __restrict__ pci,
    const int* __restrict__ pcj, const double* __restrict__ x,
    double* __restrict__ ti, double* __restrict__ tj)
{
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P0) return;
    ti[p] = vals[p] * x[pcj[p]];  // pairs touch row ci with -w x[cj]
    tj[p] = vals[p] * x[pci[p]];
}

__global__ void mf_residual_kernel(
    int n, const double* __restrict__ rc, const double* __restrict__ dc,
    const double* __restrict__ x,
    const int* __restrict__ inv_i, int n_i, const double* __restrict__ si,
    const int* __restrict__ inv_j, int n_j, const double* __restrict__ sj,
    double* __restrict__ r)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int a = inv_i[i], c = inv_j[i];
    const double ax = dc[i] * x[i] + (a < n_i ? si[a] : 0.0) + (c < n_j ? sj[c] : 0.0);
    r[i] = rc[i] - ax;
}

__global__ void mf_gate_kernel(int n, const int* __restrict__ ok, double* __restrict__ x)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n || ok[0]) return;
    x[i] = __longlong_as_double(0x7ff8000000000000LL);
}

}  // namespace

// One sweep: x = sweep(rc) (accumulate = 0) or x += sweep(rc) (accumulate = 1).
// groups: host (G, G_COLS) table; cons: device (n_consume, C_COLS) table.
extern "C" int nxfx_mf_sweep(
    int G, const long long* groups, const long long* cons, int n_core, int lam_len,
    const double* rc, const int* nodes_all, const int* bndpos_all,
    const int* cidx_all, const int* lminv_all, const int* lam_pos,
    const double* fac, double* vpools, double* ys, double* lam, double* x, int accumulate,
    cudaStream_t stream)
{
    cudaError_t err;
    long long w_max = 0;
    for (int g = 0; g < G; ++g) {
        const long long w = groups[static_cast<size_t>(g) * G_COLS + G_W];
        w_max = w > w_max ? w : w_max;
    }
    if (w_max * sizeof(double) > 48 * 1024) {  // beyond the default dynamic shared memory
        const int bytes = static_cast<int>(w_max * sizeof(double));
        err = cudaFuncSetAttribute(mf_forward_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(mf_backward_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    for (int g = 0; g < G; ++g) {
        const long long* row = groups + static_cast<size_t>(g) * G_COLS;
        const size_t shared = static_cast<size_t>(row[G_W]) * sizeof(double);
        mf_forward_kernel<<<static_cast<int>(row[G_K]), THREADS, shared, stream>>>(
            static_cast<int>(row[G_W]), static_cast<int>(row[G_B]), n_core,
            nodes_all + row[G_NODES], rc, cons + row[G_CONS] * C_COLS,
            static_cast<int>(row[G_NCONS]), cidx_all, lminv_all, vpools,
            fac + row[G_FAC], ys + row[G_LAM], vpools + row[G_VPOOL]);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    for (int g = G - 1; g >= 0; --g) {
        const long long* row = groups + static_cast<size_t>(g) * G_COLS;
        const size_t shared = static_cast<size_t>(row[G_W]) * sizeof(double);
        mf_backward_kernel<<<static_cast<int>(row[G_K]), THREADS, shared, stream>>>(
            static_cast<int>(row[G_W]), static_cast<int>(row[G_B]), lam_len,
            bndpos_all + row[G_BNDPOS], fac + row[G_FAC], ys + row[G_LAM], lam,
            lam + row[G_LAM]);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    mf_gather_kernel<<<blocks_for(n_core), THREADS, 0, stream>>>(n_core, lam_pos, lam, accumulate, x);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_mf_terms(
    int P0, const double* vals, const int* pci, const int* pcj, const double* x,
    double* ti, double* tj, cudaStream_t stream)
{
    if (P0 <= 0) return 0;
    mf_terms_kernel<<<blocks_for(P0), THREADS, 0, stream>>>(P0, vals, pci, pcj, x, ti, tj);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_mf_residual(
    int n, const double* rc, const double* dc, const double* x,
    const int* inv_i, int n_i, const double* si, const int* inv_j, int n_j, const double* sj,
    double* r, cudaStream_t stream)
{
    if (n <= 0) return 0;
    mf_residual_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
        n, rc, dc, x, inv_i, n_i, si, inv_j, n_j, sj, r);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_mf_gate(int n, const int* ok, double* x, cudaStream_t stream)
{
    if (n <= 0) return 0;
    mf_gate_kernel<<<blocks_for(n), THREADS, 0, stream>>>(n, ok, x);
    return static_cast<int>(cudaGetLastError());
}
