// K7: level-ordered elimination of the bifurcation Laplacian of a general
// forest, and the back-substitution of the multipliers.
//
// Replaces networks_fenicsx_tpu/solver.py:_level_eliminate and
// _level_eliminate_core2.  Bifurcations are in the level plan's permuted
// order: levels root-down, each level grouped by parent, so the children of
// a node are the contiguous positions [child_ptr[p], child_ptr[p + 1]).
//   prepare, per edge:  w = 1 / W,  const = (-p_s [s not bif] + p_t [t not bif] - g) / W,
//                       (w, const + Ftot) for the target side, (w, -const) for the source side
//   (the three sorted-segment sums over the plan's gather matrices are K6)
//   assemble:  (d, r) = t-side sum + s-side sum,  wn = w of the pair to the parent (0 at roots)
//   |r| over the assembled, unfolded r (the convergence gate's rhs norm)
//   fold, deepest level first, each parent gathering its children in order:
//              d_p += sum_c -wn_c (wn_c / d_c),   r_p += sum_c (wn_c / d_c) r_c
//   back-sub, root-down:  lam_root = r / d,  lam_c = (r_c + wn_c lam_parent) / d_c
//   un-permute:  lam_public[i] = lam[perm[i]]
//
// Bound: launch latency.  The work is O(E + B) doubles, but the fold and the
// back-substitution are sequential in the tree depth: one launch per level
// each (2 L + 3 launches in all, about 2,500 for an irregular forest of
// 1,240 levels).  The launch loop runs here in C over a host offset array
// the plan keeps, so a solve does no per-level work in Python.  The parent
// gathers its children (no atomics): the siblings' terms are summed first,
// in order, and then added to its own entry, as the reference does, so the
// result is deterministic.  The rhs norm is one single-block reduction in a
// fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int REDUCE_THREADS = 1024;

inline int blocks_for(long long n) { return static_cast<int>((n + THREADS - 1) / THREADS); }

__global__ void level_prepare_kernel(
    int E,
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
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    const double We = W[e];
    const double w = 1.0 / We;
    const double not_s = start_bif[e] >= 0 ? 0.0 : 1.0;
    const double not_t = end_bif[e] >= 0 ? 0.0 : 1.0;
    const double cst = (-start_pbc[e] * not_s + end_pbc[e] * not_t - g[e]) / We;
    w_out[e] = w;
    vt[2 * e] = w;
    vt[2 * e + 1] = cst + Ftot[e];
    vs[2 * e] = w;
    vs[2 * e + 1] = -cst;
}

__global__ void level_assemble_kernel(
    int B,
    const double* __restrict__ dt_t,   // (B, 2)
    const double* __restrict__ dt_s,   // (B, 2)
    const int* __restrict__ parent_pair,
    const double* __restrict__ w_pairs,
    double* __restrict__ d,
    double* __restrict__ r,
    double* __restrict__ wn)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    d[b] = dt_t[2 * b] + dt_s[2 * b];
    r[b] = dt_t[2 * b + 1] + dt_s[2 * b + 1];
    const int pp = parent_pair[b];
    wn[b] = pp >= 0 ? w_pairs[pp] : 0.0;
}

// sqrt(sum x^2) over n entries, one block, fixed summation order
__global__ void level_norm_kernel(int n, const double* __restrict__ x, double* __restrict__ out)
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
    if (threadIdx.x == 0) out[0] = sqrt(part[0]);
}

// fold the children of the parents in [lo, hi) into them
__global__ void level_fold_kernel(
    int lo, int hi,
    const int* __restrict__ child_ptr,
    const double* __restrict__ wn,
    double* __restrict__ d,
    double* __restrict__ r)
{
    const int p = lo + blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hi) return;
    const int c0 = child_ptr[p];
    const int c1 = child_ptr[p + 1];
    if (c0 >= c1) return;
    double upd_d = 0.0, upd_r = 0.0;
    for (int c = c0; c < c1; ++c) {
        const double factor = wn[c] / d[c];
        const double cd = -wn[c] * factor;
        const double cr = factor * r[c];
        upd_d = c == c0 ? cd : upd_d + cd;
        upd_r = c == c0 ? cr : upd_r + cr;
    }
    d[p] = d[p] + upd_d;
    r[p] = r[p] + upd_r;
}

// back-substitute the nodes in [lo, hi)
__global__ void level_backsub_kernel(
    int lo, int hi,
    const int* __restrict__ parent_pos,
    const double* __restrict__ d,
    const double* __restrict__ r,
    const double* __restrict__ wn,
    double* __restrict__ lam)
{
    const int b = lo + blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= hi) return;
    const int p = parent_pos[b];
    lam[b] = p < 0 ? r[b] / d[b] : (r[b] + wn[b] * lam[p]) / d[b];
}

__global__ void level_unpermute_kernel(
    int B, const int* __restrict__ perm, const double* __restrict__ lam_perm,
    double* __restrict__ lam)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    lam[i] = lam_perm[perm[i]];
}

}  // namespace

extern "C" int nxfx_level_prepare(
    int E, const double* W, const double* g, const double* Ftot,
    const double* start_pbc, const double* end_pbc,
    const int* start_bif, const int* end_bif,
    double* w, double* vt, double* vs,
    cudaStream_t stream)
{
    if (E <= 0) return 0;
    level_prepare_kernel<<<blocks_for(E), THREADS, 0, stream>>>(
        E, W, g, Ftot, start_pbc, end_pbc, start_bif, end_bif, w, vt, vs);
    return static_cast<int>(cudaGetLastError());
}

// level_offsets: host array of L + 1 permuted slice bounds per level.
extern "C" int nxfx_level_eliminate(
    int B, int L, const long long* level_offsets,
    const int* parent_pos, const int* parent_pair, const int* child_ptr, const int* perm,
    const double* w_pairs, const double* dt_t, const double* dt_s,
    double* d, double* r, double* wn, double* lam_perm, double* lam, double* rhs_norm,
    cudaStream_t stream)
{
    cudaError_t err;
    if (B <= 0) return 0;
    level_assemble_kernel<<<blocks_for(B), THREADS, 0, stream>>>(
        B, dt_t, dt_s, parent_pair, w_pairs, d, r, wn);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    level_norm_kernel<<<1, REDUCE_THREADS, 0, stream>>>(B, r, rhs_norm);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    for (int l = L - 2; l >= 0; --l) {  // parents at level l, children at l + 1
        const int lo = static_cast<int>(level_offsets[l]);
        const int hi = static_cast<int>(level_offsets[l + 1]);
        level_fold_kernel<<<blocks_for(hi - lo), THREADS, 0, stream>>>(lo, hi, child_ptr, wn, d, r);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    for (int l = 0; l < L; ++l) {
        const int lo = static_cast<int>(level_offsets[l]);
        const int hi = static_cast<int>(level_offsets[l + 1]);
        level_backsub_kernel<<<blocks_for(hi - lo), THREADS, 0, stream>>>(
            lo, hi, parent_pos, d, r, wn, lam_perm);
        if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    level_unpermute_kernel<<<blocks_for(B), THREADS, 0, stream>>>(B, perm, lam_perm, lam);
    return static_cast<int>(cudaGetLastError());
}
