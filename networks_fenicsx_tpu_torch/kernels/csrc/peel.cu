// K9: the peel rounds of the bifurcation Laplacian of a cyclic graph, and
// the assembly of that Laplacian from the condensed edge data.
//
// Replaces networks_fenicsx_tpu/solver.py:_tree_eliminate_factor and
// _tree_eliminate_apply (the rounds), and the elementwise part of
// _lambda_system_sorted.  The diagonal d and rhs r live interleaved,
// dr[2 b] = d_b, dr[2 b + 1] = r_b.
//   prepare, per edge:  w = 1 / W,  const = (-p_s [s not bif] + p_t [t not bif] - g) / W,
//                       (w, const + Ftot) for the target side, (w, -const) for the source side
//                       (the sums into the sides' bifurcations are K6)
//   |r| over the assembled r (the convergence gate's rhs norm)
//   forward, per round, for each eliminated node e with parent p over pair q:
//       w = w_pairs[q] (0 without a parent),  db = d_e,  factor = w / db,  rb = r_e
//       terms (-w factor, factor rb), folded per unique parent by K10, then
//       d_p += fold_d,  r_p += fold_r  (unique parents: one writer each)
//   core: (d, r) of the core nodes out, the core's solution back in
//   back, rounds reversed:  lambda_e = (rb + w lambda_p) / db
//
// Bound: launch latency.  A round is O(n_r) doubles, and the rounds are
// sequential (18 on the 100k-site web, a few hundred on near-tree webs):
// three launches forward and one back per round.  The reference folds the
// parent sums back through a B-sized inverse-map gather per round (a
// scatter workaround on the TPU); here the unique parents are written
// directly.  The saved (w, db, rb) of every round is one flat stream.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int REDUCE_THREADS = 1024;

inline int blocks_for(long long n) { return static_cast<int>((n + THREADS - 1) / THREADS); }

__global__ void lambda_prepare_kernel(
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

// sqrt(sum r^2) over the rhs channel of dr, one block, fixed summation order
__global__ void rhs_norm_kernel(int B, const double* __restrict__ dr, double* __restrict__ out)
{
    __shared__ double part[REDUCE_THREADS];
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
    if (threadIdx.x == 0) out[0] = sqrt(part[0]);
}

__global__ void peel_forward_kernel(
    int n,
    const int* __restrict__ elim,
    const int* __restrict__ parents,
    const int* __restrict__ pair_ids,
    int has_pairs,
    const double* __restrict__ w_pairs,
    const double* __restrict__ dr,
    double* __restrict__ w_out,
    double* __restrict__ db_out,
    double* __restrict__ rb_out,
    double* __restrict__ terms)  // (n, 2)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int e = elim[i];
    const int q = pair_ids[i];
    const double w = (has_pairs && parents[i] >= 0) ? w_pairs[q >= 0 ? q : 0] : 0.0;
    const double db = dr[2 * e];
    const double factor = w / db;
    const double rb = dr[2 * e + 1];
    w_out[i] = w;
    db_out[i] = db;
    rb_out[i] = rb;
    terms[2 * i] = -w * factor;
    terms[2 * i + 1] = factor * rb;
}

__global__ void peel_parents_kernel(
    int U, const int* __restrict__ upar, const double* __restrict__ s, double* __restrict__ dr)
{
    const int u = blockIdx.x * blockDim.x + threadIdx.x;
    if (u >= U) return;
    const int p = upar[u];
    dr[2 * p] = dr[2 * p] + s[2 * u];
    dr[2 * p + 1] = dr[2 * p + 1] + s[2 * u + 1];
}

__global__ void core_gather_kernel(
    int n, const int* __restrict__ nodes, const double* __restrict__ dr,
    double* __restrict__ dc, double* __restrict__ rc)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int b = nodes[i];
    dc[i] = dr[2 * b];
    rc[i] = dr[2 * b + 1];
}

__global__ void core_scatter_kernel(
    int n, const int* __restrict__ nodes, const double* __restrict__ x, double* __restrict__ lam)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    lam[nodes[i]] = x[i];
}

__global__ void peel_back_kernel(
    int n,
    const int* __restrict__ elim,
    const int* __restrict__ parents,
    const double* __restrict__ w,
    const double* __restrict__ db,
    const double* __restrict__ rb,
    double* lam)  // read at the parents, written at the round's nodes
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int p = parents[i];
    const double lp = p >= 0 ? lam[p] : 0.0;
    lam[elim[i]] = (rb[i] + w[i] * lp) / db[i];
}

}  // namespace

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

extern "C" int nxfx_rhs_norm(int B, const double* dr, double* out, cudaStream_t stream)
{
    rhs_norm_kernel<<<1, REDUCE_THREADS, 0, stream>>>(B, dr, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_peel_forward(
    int n, const int* elim, const int* parents, const int* pair_ids, int has_pairs,
    const double* w_pairs, const double* dr,
    double* w, double* db, double* rb, double* terms,
    cudaStream_t stream)
{
    if (n <= 0) return 0;
    peel_forward_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
        n, elim, parents, pair_ids, has_pairs, w_pairs, dr, w, db, rb, terms);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_peel_parents(
    int U, const int* upar, const double* s, double* dr, cudaStream_t stream)
{
    if (U <= 0) return 0;
    peel_parents_kernel<<<blocks_for(U), THREADS, 0, stream>>>(U, upar, s, dr);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_core_gather(
    int n, const int* nodes, const double* dr, double* dc, double* rc, cudaStream_t stream)
{
    if (n <= 0) return 0;
    core_gather_kernel<<<blocks_for(n), THREADS, 0, stream>>>(n, nodes, dr, dc, rc);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_core_scatter(
    int n, const int* nodes, const double* x, double* lam, cudaStream_t stream)
{
    if (n <= 0) return 0;
    core_scatter_kernel<<<blocks_for(n), THREADS, 0, stream>>>(n, nodes, x, lam);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_peel_back(
    int n, const int* elim, const int* parents,
    const double* w, const double* db, const double* rb, double* lam,
    cudaStream_t stream)
{
    if (n <= 0) return 0;
    peel_back_kernel<<<blocks_for(n), THREADS, 0, stream>>>(n, elim, parents, w, db, rb, lam);
    return static_cast<int>(cudaGetLastError());
}
