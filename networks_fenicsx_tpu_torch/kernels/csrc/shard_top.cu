// K22-reduce and the T solve: what the shards of a sharded solve share.
//
// Replaces the jax.lax.psum / pmin of networks_fenicsx_tpu/parallel/*
// (blocked_sharded.py:358-360, 377, 412; distributed_tree.py:486-488;
// grid_sharded.py:314, 320-335, 373; sharding.py:265-300) and the
// replicated dense solve of the top forest T (blocked_sharded.py:361-376,
// distributed_tree.py:489-503).
//
//   reduce:  out[j] = ((p_0[j] + p_1[j]) + p_2[j]) + ... over the D shard
//            partials, in shard order
//   placed:  D strip windows (C, h+1, nx) placed at row offset (d0+d)·h and
//            summed in shard order into (C, ny, nx); rows >= ny are dropped
//   all:     min over D int flags (the finiteness pmin)
//   T solve: L_T λ_T = r_T with L_T = diag(d_T) − w_T (child, parent) +
//            its transpose, a forest of Tn nodes.  Its only off-diagonals
//            are parent–child, so leaf-to-root elimination over the host's
//            T levels, then root-down back-substitution, solves it exactly
//            in O(Tn) (the reference factors it densely, Tn³/3).
//
// Bound: latency.  The partials are a few KB to a few MB (the reduce issues
// a thread's loads eight shards at a time, before their adds); the T solve is
// one block of 1,024 threads walking the levels with a barrier between
// them (Tn <= 4,096).  Each output has one writer and sums in a fixed
// order: no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SOLVE_THREADS = 1024;

inline int blocks_for(long long n) { return static_cast<int>((n + THREADS - 1) / THREADS); }

__global__ void shard_reduce_kernel(
    int D, long long n, long long stride, long long offset,
    const double* __restrict__ parts, double* __restrict__ out)
{
    constexpr int UNROLL = 8;
    const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (j >= n) return;
    double acc = __ldcs(parts + offset + j);
    for (int d0 = 1; d0 < D; d0 += UNROLL) {
        double v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (d0 + u < D) v[u] = __ldcs(parts + (d0 + u) * stride + offset + j);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (d0 + u < D) acc = acc + v[u];
    }
    out[j] = acc;
}

// window c of shard d lies at parts[d * stride + c * (h + 1) * nx]
__global__ void shard_reduce_placed_kernel(
    int D, int d0, int C, int h, int nx, int ny, long long stride,
    const double* __restrict__ parts, double* __restrict__ out)
{
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long cells = static_cast<long long>(ny) * nx;
    if (t >= cells * C) return;
    const int c = static_cast<int>(t / cells);
    const long long rc = t % cells;
    const int row = static_cast<int>(rc / nx);
    const int col = static_cast<int>(rc % nx);
    double acc = 0.0;
    for (int d = 0; d < D; ++d) {
        const int i = row - (d0 + d) * h;
        if (i < 0 || i > h) continue;
        acc = acc + parts[d * stride + (static_cast<long long>(c) * (h + 1) + i) * nx + col];
    }
    out[t] = acc;
}

__global__ void shard_all_kernel(int D, const int* __restrict__ flags, int* __restrict__ out)
{
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    int m = flags[0];
    for (int d = 1; d < D; ++d) m = min(m, flags[d]);
    out[0] = m;
}

// One block.  order (Tn,) lists the T nodes level by level (roots first),
// lvl_off (n_lvl + 1,) bounds the levels in it; a node's children are
// child_idx[child_ptr[t] .. child_ptr[t + 1]) in ascending order; parent
// (Tn,) is -1 at a root.  d and r are scratch (Tn,), not restricted: they
// are written by one thread and read by another after a barrier.
__global__ void __launch_bounds__(SOLVE_THREADS) t_solve_kernel(
    int Tn, int n_lvl,
    const int* __restrict__ order, const int* __restrict__ lvl_off,
    const int* __restrict__ child_ptr, const int* __restrict__ child_idx,
    const int* __restrict__ parent,
    const double* __restrict__ dT, const double* __restrict__ rT, const double* __restrict__ wT,
    const double* sq_extra, double* d, double* r, double* lam, double* norm_out)
{
    __shared__ double part[SOLVE_THREADS];
    double s = 0.0;
    for (int t = threadIdx.x; t < Tn; t += SOLVE_THREADS) {
        d[t] = dT[t];
        r[t] = rT[t];
        s += rT[t] * rT[t];
    }
    if (norm_out != nullptr) {
        part[threadIdx.x] = s;
        __syncthreads();
        for (int half = SOLVE_THREADS / 2; half > 0; half >>= 1) {
            if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
            __syncthreads();
        }
        if (threadIdx.x == 0) norm_out[0] = sqrt(sq_extra[0] + part[0]);
    }
    __syncthreads();
    // leaf to root: the parents of level l gather their children at l + 1
    for (int l = n_lvl - 2; l >= 0; --l) {
        for (int i = lvl_off[l] + threadIdx.x; i < lvl_off[l + 1]; i += SOLVE_THREADS) {
            const int p = order[i];
            const int lo = child_ptr[p], hi = child_ptr[p + 1];
            if (lo == hi) continue;
            double ud = 0.0, ur = 0.0;
            for (int k = lo; k < hi; ++k) {
                const int c = child_idx[k];
                const double factor = wT[c] / d[c];
                const double cd = -wT[c] * factor;
                const double cr = factor * r[c];
                ud = k == lo ? cd : ud + cd;
                ur = k == lo ? cr : ur + cr;
            }
            d[p] = d[p] + ud;
            r[p] = r[p] + ur;
        }
        __syncthreads();
    }
    // root down
    for (int l = 0; l < n_lvl; ++l) {
        for (int i = lvl_off[l] + threadIdx.x; i < lvl_off[l + 1]; i += SOLVE_THREADS) {
            const int t = order[i];
            const int p = parent[t];
            lam[t] = p < 0 ? r[t] / d[t] : (r[t] + wT[t] * lam[p]) / d[t];
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int nxfx_shard_reduce(
    int D, long long n, long long stride, long long offset, const double* parts, double* out,
    cudaStream_t stream)
{
    if (n <= 0) return 0;
    shard_reduce_kernel<<<blocks_for(n), THREADS, 0, stream>>>(D, n, stride, offset, parts, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_shard_reduce_placed(
    int D, int d0, int C, int h, int nx, int ny, long long stride, const double* parts,
    double* out, cudaStream_t stream)
{
    const long long total = static_cast<long long>(C) * ny * nx;
    if (total <= 0) return 0;
    shard_reduce_placed_kernel<<<blocks_for(total), THREADS, 0, stream>>>(
        D, d0, C, h, nx, ny, stride, parts, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_shard_all(int D, const int* flags, int* out, cudaStream_t stream)
{
    shard_all_kernel<<<1, 32, 0, stream>>>(D, flags, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_t_solve(
    int Tn, int n_lvl, const int* order, const int* lvl_off, const int* child_ptr,
    const int* child_idx, const int* parent, const double* dT, const double* rT,
    const double* wT, const double* sq_extra, double* d, double* r, double* lam,
    double* norm_out, cudaStream_t stream)
{
    if (Tn <= 0 && norm_out == nullptr) return 0;
    t_solve_kernel<<<1, SOLVE_THREADS, 0, stream>>>(
        Tn, n_lvl, order, lvl_off, child_ptr, child_idx, parent, dT, rT, wT, sq_extra,
        d, r, lam, norm_out);
    return static_cast<int>(cudaGetLastError());
}
