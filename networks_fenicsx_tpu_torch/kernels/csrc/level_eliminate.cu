// K7: level-ordered elimination of the bifurcation Laplacian of a general
// forest, and the back-substitution of the multipliers.
//
// Replaces networks_fenicsx_tpu/solver.py:_level_eliminate and
// _level_eliminate_core2.  Bifurcations are in the level plan's permuted
// order: levels root-down, each level grouped by parent, so the children of
// a node are the contiguous positions [child_ptr[p], child_ptr[p + 1]) of
// the level below (checked when the plan is uploaded).
//   prepare, per edge:  w = 1 / W,  const = (-p_s [s not bif] + p_t [t not bif] - g) / W,
//                       (w, const + Ftot) for the target side, (w, -const) for the source side
//   (the three sorted-segment sums over the plan's gather matrices are K6)
//   assemble:  (d, r) = t-side sum + s-side sum,  wn = w of the pair to the parent (0 at roots)
//   |r| over the assembled, unfolded r (the convergence gate's rhs norm)
//   fold, deepest level first, each parent gathering its children in order:
//              d_p += sum_c -wn_c (wn_c / d_c),   r_p += sum_c (wn_c / d_c) r_c
//   back-sub, root-down:  lam_root = r / d,  lam_c = (r_c + wn_c lam_parent) / d_c,
//              written in the permuted order and, through the inverse
//              permutation, in the public order.
//
// Bound: the dependency depth.  The work is O(E + B) doubles (bytes of a
// few microseconds), but the fold and the back-substitution are chains of
// L levels (1,240 on the 100k-site forest, at most 126 nodes wide), so a
// level's latency sets the time.  A launch a level (2 L in all) cost a
// launch's latency a level; here a run of consecutive levels no wider than
// WALK_MAX is walked by one block in one launch (level_walk.cuh, shared
// with K22c), and only a level wider than that (the top of an arterial
// tree's wide generations) keeps a grid launch of its own, in the same
// place in the sequence.  The host plan (LevelWalkArgs: the schedule of
// walks and grid levels, made once per plan) is issued here in C.  The
// arithmetic and its order are the grid kernels' and the plain version's:
// one writer per output, siblings summed in order and then added to the
// parent (a parent without children left as it is), no atomics; the rhs
// norm is one single-block reduction in a fixed order.  The launchers
// return the kernels they enqueued, or minus the CUDA error.
//
// A sweep (batch.solve_sweep on the level route) runs S scenarios in the
// launches of one solve (nxfx_level_prepare_scen, then K6 over S, then
// nxfx_level_eliminate_scen): every launch takes the scenario as its grid's
// y (min(S, 65,535) rows of blocks walking the scenarios y, y + gridDim.y,
// ...), a walk row so becoming S blocks, one a scenario, each with its own
// d, r, wn and lambda rows (B apart) and its own norm.  The scenario only
// selects base pointers: each row is the one-scenario launch's bits.

#include <cuda_runtime.h>

#include "level_walk.cuh"

// The plan's launch arguments (a ctypes Structure of the same fields, made
// once per plan).  A schedule row is (kind, first level, last level):
// forward, a walk folds levels last .. first + 1 into their parents, a grid
// row folds level first + 1 into level first; back, a walk solves levels
// first .. last, a grid row level first.
struct LevelWalkArgs {
    int B;
    int L;
    int n_fwd;
    int n_back;
    const int* fwd;           // host (n_fwd, 3), deepest first
    const int* back;          // host (n_back, 3), root first
    const long long* offs;    // host (L + 1)
    const int* lvl;           // (L, 2): each level's (start, end)
    const int* parent_pos;    // (B,)
    const int* parent_pair;   // (B,)
    const int* child_ptr;     // (B + 1,)
    const int* kids;          // (B, 2): (first child relative to the level below, count)
    const int* perm;          // (B,) public -> permuted
    const int* inv_perm;      // (B,) permuted -> public
};

namespace {

using namespace level_walk;

constexpr int THREADS = 256;
constexpr int REDUCE_THREADS = 1024;
constexpr int KIND_WALK = 0;

inline int blocks_for(long long n) { return static_cast<int>((n + THREADS - 1) / THREADS); }

// edge e of one scenario
__device__ __forceinline__ void level_prepare_edge(
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
    const double not_s = start_bif[e] >= 0 ? 0.0 : 1.0;
    const double not_t = end_bif[e] >= 0 ? 0.0 : 1.0;
    const double cst = (-start_pbc[e] * not_s + end_pbc[e] * not_t - g[e]) / We;
    w_out[e] = w;
    vt[2 * e] = w;
    vt[2 * e + 1] = cst + Ftot[e];
    vs[2 * e] = w;
    vs[2 * e + 1] = -cst;
}

__global__ void level_prepare_kernel(
    int E, const double* W, const double* g, const double* Ftot, const double* start_pbc,
    const double* end_pbc, const int* start_bif, const int* end_bif, double* w_out, double* vt, double* vs)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    level_prepare_edge(e, W, g, Ftot, start_pbc, end_pbc, start_bif, end_bif, w_out, vt, vs);
}

// S scenarios: W, g, w_out a row (E) a scenario, vt, vs 2 E, Ftot, start_pbc
// and end_pbc at their strides (0: shared)
__global__ void level_prepare_scen_kernel(
    int E, int S, long long sFt, long long ssp, long long sep, const double* W, const double* g,
    const double* Ftot, const double* start_pbc, const double* end_pbc, const int* start_bif,
    const int* end_bif, double* w_out, double* vt, double* vs)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const size_t Z = static_cast<size_t>(z), sE = static_cast<size_t>(E);
        level_prepare_edge(e, W + Z * sE, g + Z * sE, Ftot + Z * sFt, start_pbc + Z * ssp, end_pbc + Z * sep,
                           start_bif, end_bif, w_out + Z * sE, vt + 2 * Z * sE, vs + 2 * Z * sE);
    }
}

// scenario z's sums 2 B z further on, its pair conductances sWP z, its d,
// r, wn sB z
__global__ void level_assemble_kernel(
    int B,
    const double* __restrict__ dt_t,   // (B, 2)
    const double* __restrict__ dt_s,   // (B, 2)
    const int* __restrict__ parent_pair,
    const double* __restrict__ w_pairs,
    double* __restrict__ d,
    double* __restrict__ r,
    double* __restrict__ wn,
    int S, long long sWP, long long sB)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int pp = parent_pair[b];
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const size_t Z = static_cast<size_t>(z), o = Z * sB, t = 2 * Z * static_cast<size_t>(B);
        d[o + b] = dt_t[t + 2 * b] + dt_s[t + 2 * b];
        r[o + b] = dt_t[t + 2 * b + 1] + dt_s[t + 2 * b + 1];
        wn[o + b] = pp >= 0 ? w_pairs[Z * sWP + pp] : 0.0;
    }
}

// the system given: (d, r) from the public-order dr (B, 2) into the
// permuted positions, wn from the pair conductances
__global__ void level_system_kernel(
    int B, const int* __restrict__ perm, const double* __restrict__ dr,
    const int* __restrict__ parent_pair, const double* __restrict__ w_pairs,
    double* __restrict__ d, double* __restrict__ r, double* __restrict__ wn)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    const int p = perm[i];
    d[p] = dr[2 * i];
    r[p] = dr[2 * i + 1];
    const int pp = parent_pair[i];
    wn[i] = pp >= 0 ? w_pairs[pp] : 0.0;
}

// sqrt(sum x^2) over n entries, one block a scenario (x sx apart), fixed
// summation order
__global__ void level_norm_kernel(int n, const double* x, double* out, int S, long long sx)
{
    __shared__ double part[REDUCE_THREADS];
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const double* xz = x + static_cast<size_t>(z) * sx;
        double s = 0.0;
        for (int i = threadIdx.x; i < n; i += REDUCE_THREADS) s += xz[i] * xz[i];
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

// a level wider than a walk: fold the children of the parents in [lo, hi) into them
__global__ void level_fold_kernel(int lo, int hi, const int* __restrict__ child_ptr,
                                  const double* wn0, double* d0, double* r0, int S, long long sB)
{
    const int p = lo + blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hi) return;
    const int c0 = child_ptr[p];
    const int c1 = child_ptr[p + 1];
    if (c0 >= c1) return;
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const size_t o = static_cast<size_t>(z) * sB;
        const double* wn = wn0 + o;
        double* d = d0 + o;
        double* r = r0 + o;
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
}

// a level wider than a walk: back-substitute the nodes in [lo, hi)
__global__ void level_backsub_kernel(int lo, int hi, const int* __restrict__ parent_pos,
                                     const int* __restrict__ inv_perm, const double* d0,
                                     const double* r0, const double* wn0,
                                     double* lam_perm0, double* lam0, int S, long long sB)
{
    const int b = lo + blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= hi) return;
    const int p = parent_pos[b];
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const size_t o = static_cast<size_t>(z) * sB;
        const double* d = d0 + o;
        const double* r = r0 + o;
        const double* wn = wn0 + o;
        double* lam_perm = lam_perm0 + o;
        const double v = p < 0 ? r[b] / d[b] : (r[b] + wn[b] * lam_perm[p]) / d[b];
        lam_perm[b] = v;
        lam0[o + inv_perm[b]] = v;
    }
}

// The folds of the run of levels [first, last] (each no wider than the
// block), deepest first, in one block.
__global__ void __launch_bounds__(WALK_MAX) level_walk_kernel(
    int first, int last, const int2* lvl, const int2* kids, const double* wn, double* d, double* r,
    int S, long long sB)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nt = blockDim.x, n = last - first + 1;
    FwdStage* ring = reinterpret_cast<FwdStage*>(smem_raw);
    int2* meta_s = reinterpret_cast<int2*>(ring + STAGES * nt);
    double2* terms = reinterpret_cast<double2*>(meta_s + table_rows(n));
    const int2* meta = stage_levels(n, lvl + first, meta_s);
    __syncthreads();
    for (int z = blockIdx.y; z < S; z += gridDim.y) {  // a block a scenario
        const size_t o = static_cast<size_t>(z) * sB;
        fold_run<false, false>(meta, n, ring + threadIdx.x, kids, wn + o, d + o, r + o, terms, terms + nt);
        __syncthreads();
    }
}

// The back-substitution of the run of levels [first, last] (each no wider
// than the block), root-down, in one block; level first's parents (if any)
// are read from lam_perm, written by an earlier launch.
__global__ void __launch_bounds__(WALK_MAX) level_back_kernel(
    int first, int last, const int2* lvl, const int* parent_pos, const int* inv_perm,
    const double* d0, const double* r0, const double* wn0, double* lam_perm0, double* lam0, int S,
    long long sB)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int tid = threadIdx.x, nt = blockDim.x, n = last - first + 1;
    BackStage* ring = reinterpret_cast<BackStage*>(smem_raw);
    int2* meta_s = reinterpret_cast<int2*>(ring + STAGES * nt);
    double* up0 = reinterpret_cast<double*>(meta_s + table_rows(n));  // the level above's lam
    const int2* meta = stage_levels(n, lvl + first, meta_s);
    __syncthreads();
    for (int z = blockIdx.y; z < S; z += gridDim.y) {  // a block a scenario
        const size_t o = static_cast<size_t>(z) * sB;
        const double* d = d0 + o;
        const double* r = r0 + o;
        const double* wn = wn0 + o;
        double* lam_perm = lam_perm0 + o;
        double* lam = lam0 + o;
        double* up = up0;
        back_prime(meta, n, ring + tid, r, wn, d, parent_pos, inv_perm);
        {
            const int2 m = meta[0];
            const int i = m.x + tid;
            if (i < m.y) {
                const int p = parent_pos[i];
                const double v = p < 0 ? r[i] / d[i] : (r[i] + wn[i] * lam_perm[p]) / d[i];
                lam_perm[i] = v;
                lam[inv_perm[i]] = v;
                up[tid] = v;
            }
        }
        __syncthreads();
        solve_run<true, false>(meta, n, ring + tid, r, wn, d, parent_pos, inv_perm, lam_perm, lam, up, up + nt);
        __syncthreads();
    }
}

// a walk's block: its widest level, rounded up to a warp
int walk_threads(const long long* offs, int first, int last)
{
    long long w = 1;
    for (int l = first; l <= last; ++l) w = offs[l + 1] - offs[l] > w ? offs[l + 1] - offs[l] : w;
    const int t = static_cast<int>((w + 31) / 32 * 32);
    return t > WALK_MAX ? -1 : t;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

// the kernels enqueued, or minus the CUDA error of their launches
int enqueued(int count)
{
    const int err = last_error();
    return err != 0 ? -err : count;
}

constexpr int INVALID = -static_cast<int>(cudaErrorInvalidValue);

// norm, folds and back-substitution after the assembly, by the plan's
// schedule: the kernels enqueued, or minus the CUDA error
int eliminate_levels(const LevelWalkArgs* a, double* d, double* r, double* wn, double* lam_perm,
                     double* lam, double* rhs_norm, int S, long long sB, cudaStream_t stream)
{
    const int ys = S < 65535 ? S : 65535;
    level_norm_kernel<<<dim3(1, ys), REDUCE_THREADS, 0, stream>>>(a->B, r, rhs_norm, S, sB);
    int count = 1, err = last_error();
    if (err != 0) return -err;
    const int2* lvl = reinterpret_cast<const int2*>(a->lvl);
    const int2* kids = reinterpret_cast<const int2*>(a->kids);
    for (int s = 0; s < a->n_fwd; ++s) {
        const int kind = a->fwd[3 * s], first = a->fwd[3 * s + 1], last = a->fwd[3 * s + 2];
        if (first < 0 || last >= a->L || last < first) return INVALID;
        if (kind == KIND_WALK) {
            const int threads = walk_threads(a->offs, first, last);
            if (threads < 0 || last == first) return INVALID;
            level_walk_kernel<<<dim3(1, ys), threads, smem_bytes(last - first + 1, threads, sizeof(FwdStage),
                                                                 2 * threads * sizeof(double2)), stream>>>(
                first, last, lvl, kids, wn, d, r, S, sB);
        } else {
            const int lo = static_cast<int>(a->offs[first]), hi = static_cast<int>(a->offs[first + 1]);
            level_fold_kernel<<<dim3(blocks_for(hi - lo), ys), THREADS, 0, stream>>>(lo, hi, a->child_ptr, wn, d,
                                                                                     r, S, sB);
        }
        ++count;
        if ((err = last_error()) != 0) return -err;
    }
    for (int s = 0; s < a->n_back; ++s) {
        const int kind = a->back[3 * s], first = a->back[3 * s + 1], last = a->back[3 * s + 2];
        if (first < 0 || last >= a->L || last < first) return INVALID;
        if (kind == KIND_WALK) {
            const int threads = walk_threads(a->offs, first, last);
            if (threads < 0) return INVALID;
            level_back_kernel<<<dim3(1, ys), threads, smem_bytes(last - first + 1, threads, sizeof(BackStage),
                                                                 2 * threads * sizeof(double)), stream>>>(
                first, last, lvl, a->parent_pos, a->inv_perm, d, r, wn, lam_perm, lam, S, sB);
        } else {
            const int lo = static_cast<int>(a->offs[first]), hi = static_cast<int>(a->offs[first + 1]);
            level_backsub_kernel<<<dim3(blocks_for(hi - lo), ys), THREADS, 0, stream>>>(
                lo, hi, a->parent_pos, a->inv_perm, d, r, wn, lam_perm, lam, S, sB);
        }
        ++count;
        if ((err = last_error()) != 0) return -err;
    }
    return count;
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
    return enqueued(1);
}

// The same for S scenarios in one launch: W, g (S, E), Ftot rows sFt apart,
// start_pbc, end_pbc rows ssp, sep apart (0: shared); w (S, E), vt, vs
// (S, E, 2) out.
extern "C" int nxfx_level_prepare_scen(
    int E, int S, long long sFt, long long ssp, long long sep, const double* W, const double* g,
    const double* Ftot, const double* start_pbc, const double* end_pbc, const int* start_bif,
    const int* end_bif, double* w, double* vt, double* vs, cudaStream_t stream)
{
    if (E <= 0 || S <= 0) return 0;
    level_prepare_scen_kernel<<<dim3(blocks_for(E), S < 65535 ? S : 65535), THREADS, 0, stream>>>(
        E, S, sFt, ssp, sep, W, g, Ftot, start_pbc, end_pbc, start_bif, end_bif, w, vt, vs);
    return enqueued(1);
}

// The assembly from K6's sums, the norm and the schedule's walks and grid
// levels (B > 0).
extern "C" int nxfx_level_eliminate(
    const LevelWalkArgs* a, const double* w_pairs, const double* dt_t, const double* dt_s,
    double* d, double* r, double* wn, double* lam_perm, double* lam, double* rhs_norm,
    cudaStream_t stream)
{
    if (a->B <= 0) return INVALID;
    level_assemble_kernel<<<blocks_for(a->B), THREADS, 0, stream>>>(
        a->B, dt_t, dt_s, a->parent_pair, w_pairs, d, r, wn, 1, 0, 0);
    const int err = last_error();
    if (err != 0) return -err;
    const int rest = eliminate_levels(a, d, r, wn, lam_perm, lam, rhs_norm, 1, 0, stream);
    return rest < 0 ? rest : 1 + rest;
}

// The same for S scenarios in the same launches: dt_t, dt_s (S, B, 2) from
// K6 over S, w_pairs (S, P); d, r, wn, lam_perm and lam (S, B), rhs_norm (S,).
extern "C" int nxfx_level_eliminate_scen(
    const LevelWalkArgs* a, int S, long long sWP, const double* w_pairs, const double* dt_t,
    const double* dt_s, double* d, double* r, double* wn, double* lam_perm, double* lam,
    double* rhs_norm, cudaStream_t stream)
{
    if (a->B <= 0 || S <= 0) return INVALID;
    const int ys = S < 65535 ? S : 65535;
    level_assemble_kernel<<<dim3(blocks_for(a->B), ys), THREADS, 0, stream>>>(
        a->B, dt_t, dt_s, a->parent_pair, w_pairs, d, r, wn, S, sWP, a->B);
    const int err = last_error();
    if (err != 0) return -err;
    const int rest = eliminate_levels(a, d, r, wn, lam_perm, lam, rhs_norm, S, a->B, stream);
    return rest < 0 ? rest : 1 + rest;
}

// The same elimination from an assembled system: the interleaved public-order
// (diag, rhs) dr (B, 2) and the pair conductances, as the sharded general
// solve has them after its reduce (the reference's _level_eliminate_core).
extern "C" int nxfx_level_eliminate_system(
    const LevelWalkArgs* a, const double* w_pairs, const double* dr,
    double* d, double* r, double* wn, double* lam_perm, double* lam, double* rhs_norm,
    cudaStream_t stream)
{
    if (a->B <= 0) return INVALID;
    level_system_kernel<<<blocks_for(a->B), THREADS, 0, stream>>>(
        a->B, a->perm, dr, a->parent_pair, w_pairs, d, r, wn);
    const int err = last_error();
    if (err != 0) return -err;
    const int rest = eliminate_levels(a, d, r, wn, lam_perm, lam, rhs_norm, 1, 0, stream);
    return rest < 0 ? rest : 1 + rest;
}
