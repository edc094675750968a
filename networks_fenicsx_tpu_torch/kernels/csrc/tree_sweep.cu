// K2 + K3 + K4: level-blocked elimination of the bifurcation Laplacian on a
// uniformly-K-ary forest, and the back-substitution of the multipliers.
//
// Replaces networks_fenicsx_tpu/solver.py:_blocked_forward_factor (K2),
// _blocked_forward_apply (K3) and _blocked_backward (K4), i.e.
// _blocked_eliminate.  Per bifurcation b (internal order) with in-edge i
// and out-edges o_j:
//   assemble:  d_b = w_i + sum_j w_oj,   r_b = (const_i + Ftot_i) - sum_j const_oj
//   |r|^2 over the unfolded r (the convergence gate's rhs norm)
//   fold, bottom-up, level by level: for each child c of b in slot order
//              d_b += sum_c -wn_c (wn_c / d_c),   r_b += sum_c (wn_c / d_c) r_c
//   back-sub, top-down:  lam_root = r / d,  lam_c = (r_c + wn_c lam_parent) / d_c
//
// The sharded blocked solve runs the same kernels in two entries: the
// forward (assemble, |r|^2 without the root, folds down to level 0), and
// the back-substitution of levels 1.. from a level 0 it computes itself.
//
// Bound: launch latency.  The work is O(B) doubles, a few MB at 16
// generations, but the fold and the back-substitution are sequential in the
// tree depth: one launch per level (2 L + 2 launches in all).  The parent
// gathers its children (no atomics), first summing the siblings' terms in
// slot order and then adding to its own entry, so the result is
// deterministic and in the reference's order.  The rhs norm is one
// single-block reduction in a fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int REDUCE_THREADS = 1024;

__global__ void assemble_kernel(
    int B, int Kmax,
    const int* __restrict__ bif_in,
    const int* __restrict__ bif_out,
    const double* __restrict__ w,
    const double* __restrict__ cst,
    const double* __restrict__ Ftot,
    double* __restrict__ d,
    double* __restrict__ r,
    double* __restrict__ wn)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int ie = bif_in[b];
    const double w_in = w[ie];
    double db = w_in;
    double rb = cst[ie] + Ftot[ie];
    for (int j = 0; j < Kmax; ++j) {
        const int oe = bif_out[(size_t)b * Kmax + j];
        if (oe < 0) break;
        db = db + w[oe];
        rb = rb - cst[oe];
    }
    d[b] = db;
    r[b] = rb;
    wn[b] = w_in;
}

// sum x^2 over n entries (its square root with SQRT), one block, fixed
// summation order
template <bool SQRT>
__global__ void norm_kernel(int n, const double* __restrict__ x, double* __restrict__ out)
{
    __shared__ double part[REDUCE_THREADS];
    double s = 0.0;
    for (int i = threadIdx.x; i < n; i += REDUCE_THREADS) s += x[i] * x[i];
    part[threadIdx.x] = s;
    __syncthreads();
    for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
        if (threadIdx.x < stride) part[threadIdx.x] += part[threadIdx.x + stride];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[0] = SQRT ? sqrt(part[0]) : part[0];
}

// fold the children of the parents in [lo, hi) into them
__global__ void fold_kernel(
    int lo, int hi, int Kmax,
    const int* __restrict__ bif_child,
    const double* __restrict__ wn,
    double* __restrict__ d,
    double* __restrict__ r)
{
    const int b = lo + blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= hi) return;
    const int* ch = bif_child + (size_t)b * Kmax;
    if (ch[0] < 0) return;
    double upd_d = 0.0, upd_r = 0.0;
    for (int j = 0; j < Kmax; ++j) {
        const int c = ch[j];
        if (c < 0) break;
        const double factor = wn[c] / d[c];
        const double cd = -wn[c] * factor;
        const double cr = factor * r[c];
        upd_d = j == 0 ? cd : upd_d + cd;
        upd_r = j == 0 ? cr : upd_r + cr;
    }
    d[b] = d[b] + upd_d;
    r[b] = r[b] + upd_r;
}

// back-substitute the bifurcations in [lo, hi)
__global__ void backsub_kernel(
    int lo, int hi,
    const int* __restrict__ bif_parent,
    const double* __restrict__ d,
    const double* __restrict__ r,
    const double* __restrict__ wn,
    double* __restrict__ lam)
{
    const int b = lo + blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= hi) return;
    const int p = bif_parent[b];
    lam[b] = p < 0 ? r[b] / d[b] : (r[b] + wn[b] * lam[p]) / d[b];
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// level_offsets: host array of L + 1 bifurcation slice bounds per level.
extern "C" int nxfx_tree_sweep(
    int B, int Kmax, int L, const long long* level_offsets,
    const int* bif_in, const int* bif_out, const int* bif_child, const int* bif_parent,
    const double* w, const double* cst, const double* Ftot,
    double* d, double* r, double* wn, double* lam, double* rhs_norm,
    cudaStream_t stream)
{
    cudaError_t err;
    if (B <= 0) return 0;
    assemble_kernel<<<blocks_for(B), THREADS, 0, stream>>>(
        B, Kmax, bif_in, bif_out, w, cst, Ftot, d, r, wn);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    norm_kernel<true><<<1, REDUCE_THREADS, 0, stream>>>(B, r, rhs_norm);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    for (int l = L - 2; l >= 0; --l) {  // parents at level l, children at l + 1
        const int lo = static_cast<int>(level_offsets[l]);
        const int hi = static_cast<int>(level_offsets[l + 1]);
        fold_kernel<<<blocks_for(hi - lo), THREADS, 0, stream>>>(
            lo, hi, Kmax, bif_child, wn, d, r);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    for (int l = 0; l < L; ++l) {
        const int lo = static_cast<int>(level_offsets[l]);
        const int hi = static_cast<int>(level_offsets[l + 1]);
        backsub_kernel<<<blocks_for(hi - lo), THREADS, 0, stream>>>(
            lo, hi, bif_parent, d, r, wn, lam);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

// The forward half: d, r, wn folded down to level 0 and sum r^2 over the
// unfolded r (no square root).
extern "C" int nxfx_tree_sweep_forward(
    int B, int Kmax, int L, const long long* level_offsets,
    const int* bif_in, const int* bif_out, const int* bif_child,
    const double* w, const double* cst, const double* Ftot,
    double* d, double* r, double* wn, double* rhs_sq,
    cudaStream_t stream)
{
    cudaError_t err;
    if (B <= 0) return 0;
    assemble_kernel<<<blocks_for(B), THREADS, 0, stream>>>(
        B, Kmax, bif_in, bif_out, w, cst, Ftot, d, r, wn);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    norm_kernel<false><<<1, REDUCE_THREADS, 0, stream>>>(B, r, rhs_sq);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    for (int l = L - 2; l >= 0; --l) {
        const int lo = static_cast<int>(level_offsets[l]);
        const int hi = static_cast<int>(level_offsets[l + 1]);
        fold_kernel<<<blocks_for(hi - lo), THREADS, 0, stream>>>(
            lo, hi, Kmax, bif_child, wn, d, r);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

// The backward half: lam of levels 1 .. L-1 from lam's level 0, which the
// caller has written.
extern "C" int nxfx_tree_sweep_backward(
    int B, int L, const long long* level_offsets, const int* bif_parent,
    const double* d, const double* r, const double* wn, double* lam,
    cudaStream_t stream)
{
    cudaError_t err;
    for (int l = 1; l < L; ++l) {
        const int lo = static_cast<int>(level_offsets[l]);
        const int hi = static_cast<int>(level_offsets[l + 1]);
        if (hi <= lo) continue;
        backsub_kernel<<<blocks_for(hi - lo), THREADS, 0, stream>>>(
            lo, hi, bif_parent, d, r, wn, lam);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}
