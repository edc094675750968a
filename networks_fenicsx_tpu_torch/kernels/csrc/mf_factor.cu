// K13 + K14: the factor of the tree multifrontal core elimination.
//
// Replaces networks_fenicsx_tpu/ops/multifrontal.py:_mf_factor with
// _consume_onehot (front assembly and extend-add, K14) and
// _chol_inv_small / chol_inverse_batched (the batched Cholesky, K13).
// Groups run in the plan's postorder, one launch per group, one thread block
// per front.  A front of pivot width w and boundary width b (m = w + b) is
// an m x m block of the factor buffer:
//   F = pivot-row strips (values -w_pairs[init_slot], both triangles for the
//       boundary columns) + diag(dc[nodes]) on the pivots (1 on a padded pivot)
//   F += U_child[lminv, lminv] for each consumed child group, in plan order
//       (a gather; lminv's pad index b_child and cidx's pad k_child read as 0)
//   partial Cholesky of the first w columns, lower triangle:
//       F_SS = L L^T,  lower-left = Y^T with Y = L^-1 F_SB,  lower-right = U = F_BB - Y^T Y
//   ok = 0 when an entry of L is not finite; the pivot block's strict upper
//   triangle gets L^T (the apply reads both factors along rows), the rest
//   of the upper triangle is zeroed, and U (full) goes to the group's pool
//   for its parent.
// The reference keeps Li = L^-1 explicitly and forms X = Li^T Li F_SB, and
// assembles through one-hot matrix products, both for the TPU's matrix
// unit; here L and Y are kept and the apply (mf_apply.cu) solves triangles.
// The reference factors in float32 (float64 is emulated on the TPU) and
// refines in float64; here the factor is float64 and the refinement stays.
//
// Bound: the partial Cholesky, w steps of an O(m^2) trailing update with
// two barriers each, per front; the top groups hold one wide front each, so
// the widest fronts set the critical path.  A front's block has a warp per
// 8 of its rows (64 to 1,024 threads) and factors in panels of up to 32
// columns held in shared memory (right_looking_cholesky.cuh), so each entry
// of the trailing block is read and written once per panel.  The factor buffer (sum of
// k m^2 doubles) stays in device memory for the apply.  A front is written
// by one thread and read by others after a barrier, so the factor buffer
// carries no __restrict__ (with it the compiler may keep a value in a
// register across __syncthreads()).

#include <cuda_runtime.h>

#include "right_looking_cholesky.cuh"

namespace {

constexpr int THREADS = 1024;  // the most threads a front's block takes
constexpr int PANEL_BYTES = 200 * 1024;  // shared memory for the Cholesky panel

// threads of a front's block: a warp per 8 rows of the front, 64 to THREADS
inline int front_threads(int m)
{
    int t = 64;
    while (t < THREADS && t * 8 < 32 * m) t *= 2;
    return t;
}

// columns of the host group table and the device consume table
enum { G_K, G_W, G_B, G_C, G_NODES, G_CVAL, G_BNDPOS, G_LAM, G_FAC, G_POOL, G_VPOOL, G_CONS,
       G_NCONS, G_COLS };
enum { C_POOL, C_VPOOL, C_K, C_B, C_CIDX, C_LMINV, C_COLS };

__global__ void mf_values_kernel(
    int P0, const int* __restrict__ init_slot, const double* __restrict__ w_pairs,
    double* __restrict__ vals, int* __restrict__ ok)
{
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p < P0) vals[p] = -w_pairs[init_slot[p]];
    if (p == P0) {
        vals[P0] = 0.0;
        ok[0] = 1;
    }
}

__global__ void __launch_bounds__(THREADS) mf_factor_group_kernel(
    int w, int b, int c, int n_core, int nb,
    const int* __restrict__ nodes,   // (k, w)
    const int* __restrict__ cval,    // (k, w, c)
    const int* __restrict__ ccol,    // (k, w, c)
    const double* __restrict__ vals, // (P0 + 1,)
    const double* __restrict__ dc,   // (n_core,)
    const long long* __restrict__ cons, int n_cons,
    const int* __restrict__ cidx_all,
    const int* __restrict__ lminv_all,
    const double* pools,             // every group's U pool (children read)
    double* fac,                     // (k, m, m)
    double* pool,                    // (k, b, b): this group's, inside pools
    int* ok)
{
    extern __shared__ double panel[];  // right_looking_cholesky's column panel
    const int p = blockIdx.x;
    const int tid = threadIdx.x;
    const int m = w + b;
    const long long mm = static_cast<long long>(m) * m;
    double* F = fac + static_cast<size_t>(p) * mm;

    for (long long t = tid; t < mm; t += blockDim.x) F[t] = 0.0;
    __syncthreads();
    for (int t = tid; t < w * c; t += blockDim.x) {
        const int i = t / c;
        const size_t e = static_cast<size_t>(p) * w * c + t;
        const int col = ccol[e];
        if (col < m) {
            const double v = vals[cval[e]];
            F[static_cast<size_t>(i) * m + col] = v;
            if (col >= w) F[static_cast<size_t>(col) * m + i] = v;
        }
    }
    __syncthreads();
    for (int i = tid; i < w; i += blockDim.x) {
        const int node = nodes[static_cast<size_t>(p) * w + i];
        const double d = node < n_core ? dc[node] : 1.0;
        F[static_cast<size_t>(i) * m + i] = F[static_cast<size_t>(i) * m + i] + d;
    }
    __syncthreads();
    for (int ce = 0; ce < n_cons; ++ce) {
        const long long* row = cons + static_cast<size_t>(ce) * C_COLS;
        const int kc = static_cast<int>(row[C_K]);
        const int cb = static_cast<int>(row[C_B]);
        const int child = cidx_all[row[C_CIDX] + p];
        if (child < kc) {
            const double* U = pools + row[C_POOL] + static_cast<size_t>(child) * cb * cb;
            const int* lm = lminv_all + row[C_LMINV] + static_cast<size_t>(p) * m;
            for (long long t = tid; t < mm; t += blockDim.x) {
                const int a = lm[t / m];
                const int bb = lm[t % m];
                if (a < cb && bb < cb) F[t] = F[t] + U[static_cast<size_t>(a) * cb + bb];
            }
        }
        __syncthreads();
    }

    // partial Cholesky of the first w columns, lower triangle
    right_looking_cholesky(F, m, w, panel, nb);
    for (long long t = tid; t < mm; t += blockDim.x) {
        const int i = static_cast<int>(t / m), j = static_cast<int>(t % m);
        if (j > i) {
            if (j >= w) F[t] = 0.0;  // the pivot block's upper triangle: L^T, below
        } else if (i < w && !isfinite(F[t])) {
            ok[0] = 0;
        }
    }
    __syncthreads();
    mirror_lower(F, w, m);
    __syncthreads();
    for (long long t = tid; t < static_cast<long long>(b) * b; t += blockDim.x) {
        const int i = static_cast<int>(t / b), j = static_cast<int>(t % b);
        const int hi = i > j ? i : j, lo = i > j ? j : i;
        pool[static_cast<size_t>(p) * b * b + t] = F[static_cast<size_t>(w + hi) * m + w + lo];
    }
}

}  // namespace

// groups: host (G, G_COLS) table; cons: device (n_consume, C_COLS) table.
extern "C" int nxfx_mf_factor(
    int G, const long long* groups, const long long* cons, int n_core, int P0,
    const int* init_slot, const double* w_pairs, const double* dc,
    const int* nodes_all, const int* cval_all, const int* ccol_all,
    const int* cidx_all, const int* lminv_all,
    double* vals, double* fac, double* pools, int* ok,
    cudaStream_t stream)
{
    cudaError_t err;
    mf_values_kernel<<<(P0 + 1 + 255) / 256, 256, 0, stream>>>(P0, init_slot, w_pairs, vals, ok);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    int shared_max = 0;
    for (int g = 0; g < G; ++g) {
        const long long* row = groups + static_cast<size_t>(g) * G_COLS;
        const int m = static_cast<int>(row[G_W] + row[G_B]);
        const int bytes = panel_bytes(m, panel_width(m, PANEL_BYTES));
        shared_max = bytes > shared_max ? bytes : shared_max;
    }
    if (shared_max > 48 * 1024) {  // beyond the default dynamic shared memory
        err = cudaFuncSetAttribute(mf_factor_group_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, shared_max);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    for (int g = 0; g < G; ++g) {
        const long long* row = groups + static_cast<size_t>(g) * G_COLS;
        const int k = static_cast<int>(row[G_K]);
        const int w = static_cast<int>(row[G_W]);
        const int b = static_cast<int>(row[G_B]);
        const int c = static_cast<int>(row[G_C]);
        const int nb = panel_width(w + b, PANEL_BYTES);
        const size_t shared = static_cast<size_t>(panel_bytes(w + b, nb));
        mf_factor_group_kernel<<<k, front_threads(w + b), shared, stream>>>(
            w, b, c, n_core, nb,
            nodes_all + row[G_NODES], cval_all + row[G_CVAL], ccol_all + row[G_CVAL],
            vals, dc, cons + row[G_CONS] * C_COLS, static_cast<int>(row[G_NCONS]),
            cidx_all, lminv_all, pools, fac + row[G_FAC], pools + row[G_POOL], ok);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}
