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
//            are parent–child, so elimination in any order leaves a forest:
//            eliminating a node with one child and a parent adds one edge
//            between them (the reference factors it densely, Tn³/3).
//
// Bound: latency.  The partials are a few KB to a few MB (the reduce issues
// a thread's loads eight shards at a time, before their adds).  The T solve
// is one block whose time is its chain of dependent divisions and barriers:
// the sharded forest's T is 1,128 nodes in 711 levels at most 2 wide, and
// a walk of its levels took a barrier and a division a level each way.  So
// the host plan (shard_top.py t_plan) cuts every run of one-child nodes
// into segments of at most TS_CHAIN; a thread eliminates a segment's run in
// registers and shared memory, bottom to top with no barrier, leaving one
// compressed edge between the separators below and above it, and the
// separators form the next round's forest; the forest left after the
// rounds (roots, leaves and branching nodes) is walked by levels; then the
// rounds are undone in reverse, a thread back-substituting its segment.
// The 711-level T takes 3 rounds and a 3-level walk: ~3 x 16 dependent
// steps and ~15 barriers each way.  Everything lives in shared memory (7
// arrays of Tn doubles, 224 KB at the limit of 4,096 nodes).  Each output
// has one writer and sums in a fixed order: no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TS_THREADS = 256;  // the T solve's block (shard_top.py SOLVE_THREADS)
constexpr int TS_CHAIN = 16;     // the most nodes of a segment (shard_top.py CHAIN)
constexpr int TS_ARRAYS = 7;     // the T solve's shared arrays, Tn doubles each

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

// One block of TS_THREADS.  plan is shard_top.py's int32 table: a header
// of TS_HEADER words (rounds, levels of the forest left, the offsets of the
// per-round segment bounds, the per-round gather bounds, the segments
// (bottom, top, first, length), the gathers (top, first segment, count), the
// chain of the segments' nodes, the rows of the forest left (node, parent,
// first child row, children) and its level bounds; its node count), then
// those sections.  d, r, w, e, lam, td, tr live in shared memory, Tn each.
__global__ void __launch_bounds__(TS_THREADS) t_solve_kernel(
    int Tn, const int* __restrict__ plan, const double* __restrict__ dT,
    const double* __restrict__ rT, const double* __restrict__ wT, const double* sq_extra,
    double* __restrict__ lam_out, double* norm_out)
{
    extern __shared__ double ts_smem[];
    __shared__ double warp_sum[TS_THREADS / 32];
    double* d = ts_smem;
    double* r = d + Tn;
    double* w = r + Tn;   // a node's edge weight to its parent in the current forest
    double* e = w + Tn;   // an eliminated node's coupling to its segment's bottom
    double* lam = e + Tn;
    double* td = lam + Tn;  // a segment's terms for its top, kept at its bottom
    double* tr = td + Tn;
    const int tid = threadIdx.x;
    double s = 0.0;
    for (int t = tid; t < Tn; t += TS_THREADS) {
        const double rv = rT[t];
        d[t] = dT[t];
        r[t] = rv;
        w[t] = wT[t];
        s = s + rv * rv;
    }
    if (norm_out != nullptr) {
        for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, o);
        if ((tid & 31) == 0) warp_sum[tid >> 5] = s;
    }
    __syncthreads();
    if (norm_out != nullptr && tid == 0) {
        double total = warp_sum[0];
        for (int k = 1; k < TS_THREADS / 32; ++k) total = total + warp_sum[k];
        norm_out[0] = sqrt(sq_extra[0] + total);
    }
    const int R = plan[0], n_lvl = plan[1];
    const int* seg_off = plan + plan[2];
    const int* gat_off = plan + plan[3];
    const int* seg = plan + plan[4];
    const int* gat = plan + plan[5];
    const int* chain = plan + plan[6];
    const int* rows = plan + plan[7];
    const int* lvl = plan + plan[8];

    for (int rd = 0; rd < R; ++rd) {
        // each segment's run, bottom to top, in one thread: no barrier
        for (int j = seg_off[rd] + tid; j < seg_off[rd + 1]; j += TS_THREADS) {
            const int b = seg[4 * j], first = seg[4 * j + 2], len = seg[4 * j + 3];
            double eb = w[b], db = 0.0, rb = 0.0, dn = 0.0, rn = 0.0;
#pragma unroll
            for (int k = 0; k < TS_CHAIN; ++k) {
                if (k < len) {
                    const int v = chain[first + k];
                    const double dv = k == 0 ? d[v] : d[v] + dn;
                    const double rv = k == 0 ? r[v] : r[v] + rn;
                    const double wv = w[v];
                    const double fb = eb / dv, ft = wv / dv;
                    const double cd = -eb * fb, cr = fb * rv;
                    db = k == 0 ? cd : db + cd;
                    rb = k == 0 ? cr : rb + cr;
                    dn = -wv * ft;
                    rn = ft * rv;
                    d[v] = dv;
                    r[v] = rv;
                    e[v] = eb;
                    eb = eb * ft;
                }
            }
            d[b] = d[b] + db;
            r[b] = r[b] + rb;
            td[b] = dn;
            tr[b] = rn;
            w[b] = eb;
        }
        __syncthreads();
        // each top takes its segments' terms in order
        for (int g = gat_off[rd] + tid; g < gat_off[rd + 1]; g += TS_THREADS) {
            const int t = gat[3 * g], s0 = gat[3 * g + 1], cnt = gat[3 * g + 2];
            double ud = td[seg[4 * s0]], ur = tr[seg[4 * s0]];
            for (int k = 1; k < cnt; ++k) {
                const int b = seg[4 * (s0 + k)];
                ud = ud + td[b];
                ur = ur + tr[b];
            }
            d[t] = d[t] + ud;
            r[t] = r[t] + ur;
        }
        __syncthreads();
    }
    // the forest left: leaf to root, the parents of level l gathering their
    // children (a run of level l + 1)
    for (int l = n_lvl - 2; l >= 0; --l) {
        for (int i = lvl[l] + tid; i < lvl[l + 1]; i += TS_THREADS) {
            const int p = rows[4 * i], kf = rows[4 * i + 2], kc = rows[4 * i + 3];
            if (kc == 0) continue;
            double ud = 0.0, ur = 0.0;
            for (int k = 0; k < kc; ++k) {
                const int c = rows[4 * (kf + k)];
                const double factor = w[c] / d[c];
                const double cd = -w[c] * factor, cr = factor * r[c];
                ud = k == 0 ? cd : ud + cd;
                ur = k == 0 ? cr : ur + cr;
            }
            d[p] = d[p] + ud;
            r[p] = r[p] + ur;
        }
        __syncthreads();
    }
    // root down
    for (int l = 0; l < n_lvl; ++l) {
        for (int i = lvl[l] + tid; i < lvl[l + 1]; i += TS_THREADS) {
            const int t = rows[4 * i], p = rows[4 * i + 1];
            lam[t] = p < 0 ? r[t] / d[t] : (r[t] + w[t] * lam[p]) / d[t];
        }
        __syncthreads();
    }
    // the rounds reversed: each segment from its two separators' lambda
    for (int rd = R - 1; rd >= 0; --rd) {
        for (int j = seg_off[rd] + tid; j < seg_off[rd + 1]; j += TS_THREADS) {
            const int first = seg[4 * j + 2], len = seg[4 * j + 3];
            const double lb = lam[seg[4 * j]];
            double ln = lam[seg[4 * j + 1]];
            for (int k = len - 1; k >= 0; --k) {
                const int v = chain[first + k];
                ln = ((r[v] + e[v] * lb) + w[v] * ln) / d[v];
                lam[v] = ln;
            }
        }
        __syncthreads();
    }
    for (int t = tid; t < Tn; t += TS_THREADS) lam_out[t] = lam[t];
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
    int Tn, const int* plan, const double* dT, const double* rT, const double* wT,
    const double* sq_extra, double* lam, double* norm_out, cudaStream_t stream)
{
    if (Tn <= 0 && norm_out == nullptr) return 0;
    const int smem = TS_ARRAYS * Tn * static_cast<int>(sizeof(double));
    cudaError_t err = cudaFuncSetAttribute(t_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    t_solve_kernel<<<1, TS_THREADS, smem, stream>>>(Tn, plan, dT, rT, wT, sq_extra, lam, norm_out);
    return static_cast<int>(cudaGetLastError());
}
