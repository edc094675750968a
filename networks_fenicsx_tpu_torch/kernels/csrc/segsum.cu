// K6: exact sorted-segment sums through a padded gather matrix.
//
// Replaces networks_fenicsx_tpu/solver.py:_segsum_sorted.  With idx the
// (S, K) gather matrix the host builds from the sorted segment ids (the
// selection composed in, rows padded with the zero slot n):
//   out[s, c] = sum_{j < K} vals[idx[s, j], c],   vals[n, :] = 0
//
// Bound: device-memory latency of the gathers.  The sums are tiny (a
// bifurcation has a handful of incident edges, a pair one or two) and the
// rows an index names are scattered, so one thread owns one (segment,
// channel) output and adds its K values in ascending j, the reference's
// order; no shared memory, no atomics.  Any K runs through the same loop,
// so neither of the reference's TPU branches (slice-and-reshape for
// contiguous layouts, segment_sum for K > 32) is needed.
//
// nxfx_fold is K10 (networks_fenicsx_tpu/ops/core_elim.py:_fold_apply,
// :394-415): a chain of L such gather levels, level l summing K_l entries
// of level l-1's rows (level 0 of vals), a pad index (>= the previous
// level's rows) reading 0.  One launch a fold, whatever L:
//   L = 1: the segment sum above, one thread an output;
//   L >= 2 (segments wider than 64, chunked by the host plan): one warp an
//   (output, channel); level-1 rows are computed lane-parallel over their
//   entries (each lane a level-0 chunk sum) and added across the lanes in
//   ascending order; higher levels walk their entries in ascending order.
// Every intermediate sum is the value the level-by-level plain version
// rounds to, added in its order, so the fold equals it bit for bit (the
// row sum is fold.cuh's, which K12a's rounds share).
// Bound: the latency of a few dependent gathers; the launch count (one a
// fold instead of one a level) and the host's per-call work are what move
// the launch-bound chains K10 runs in.  nxfx_fold_scen folds S scenarios'
// vectors (n C apart, their outputs rows C apart) in the same one launch,
// the scenario the grid's y (min(S, 65,535) rows of blocks walking the
// scenarios y, y + gridDim.y, ...): each scenario's sums are the
// one-scenario launch's bits.
//
// nxfx_segsum_plan is one launch for all the sums of a route (a sum plan of
// up to SUM_MAX_GROUPS groups, each a gather matrix over one value array):
// the grid is flattened over the groups' (segment, channel) outputs by
// prefix offsets.  A group without bins writes its own output; the groups
// with bins share one output of `rows` rows, each row written once by one
// thread as (+0.0 + sum of the first such group) + sum of the next ..., in
// group order, a group's sum added only where its bins name the row (the
// plan's inverse table `inv`, -1 elsewhere).  That is the plain version's
// zero-filled output with each group's sum added into it in turn, to the
// bit, so neither the zero fill nor a launch a group is needed.
//
// nxfx_segsum_plan_scen runs a plan over S scenarios in one launch: the
// grid's y, min(S, 65,535) rows of blocks walking the scenarios y, y +
// gridDim.y, ...; scenario z's values are each group's (n, C) rows z times
// n C further on, its outputs z times their size.  A scenario's sums are
// the one-scenario launch's bit for bit.

#include <cuda_runtime.h>

#include "fold.cuh"

constexpr int SUM_MAX_GROUPS = 4;

// A sum plan's tables, made once per plan by the Python plan (a ctypes
// Structure of the same fields).  inv[g] is null for a group with its own
// output, else (rows,) the group's segment of each row of the shared
// output (-1 none).
struct SumPlanArgs {
    int G, rows;
    const int* idx[SUM_MAX_GROUPS];
    const int* inv[SUM_MAX_GROUPS];
    int S[SUM_MAX_GROUPS];
    int K[SUM_MAX_GROUPS];
    int C[SUM_MAX_GROUPS];
};

namespace {

// out[s, c] = sum (K10's one-level fold); scenario z's vals sv z further
// on, its out so z
__global__ void segsum_kernel(
    int S, int K, int C, int n,
    const int* __restrict__ idx,
    const double* __restrict__ vals,
    double* __restrict__ out,
    int Z, long long sv, long long so)
{
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= static_cast<long long>(S) * C) return;
    const int s = static_cast<int>(t / C);
    const int c = static_cast<int>(t % C);
    for (int z = blockIdx.y; z < Z; z += gridDim.y)
        out[static_cast<size_t>(z) * so + t] =
            fold::row_sum(idx + static_cast<size_t>(s) * K, K, vals + static_cast<size_t>(z) * sv, n, C, c);
}

constexpr int FOLD_MAX_LEVELS = 8;
constexpr int FOLD_THREADS = 256;

struct FoldLevels {
    const int* idx[FOLD_MAX_LEVELS];
    int rows[FOLD_MAX_LEVELS];
    int K[FOLD_MAX_LEVELS];
};

// level 0's row r, channel c: its K_0 gathers of vals (n rows) in ascending order
__device__ double fold_level0(const FoldLevels& F, int n, int C, const double* vals, int r, int c)
{
    return fold::row_sum(F.idx[0] + static_cast<size_t>(r) * F.K[0], F.K[0], vals, n, C, c);
}

// level l's row r (l >= 1), warp-uniform: every lane returns the sum
__device__ double fold_row(const FoldLevels& F, int l, int r, int n, int C, const double* vals, int c)
{
    const int K = F.K[l];
    const int* row = F.idx[l] + static_cast<size_t>(r) * K;
    const int lane = threadIdx.x & 31;
    double acc = 0.0;
    if (l == 1) {
        for (int j0 = 0; j0 < K; j0 += 32) {
            const int j = j0 + lane;
            double v = 0.0;
            if (j < K) {
                const int e = row[j];
                if (e >= 0 && e < F.rows[0]) v = fold_level0(F, n, C, vals, e, c);
            }
            for (int jj = 0; jj < 32 && j0 + jj < K; ++jj) {
                const double vj = __shfl_sync(0xffffffffu, v, jj);
                acc = j0 + jj == 0 ? vj : acc + vj;
            }
        }
        return acc;
    }
    for (int j = 0; j < K; ++j) {
        const int e = row[j];
        const double v = (e >= 0 && e < F.rows[l - 1]) ? fold_row(F, l - 1, e, n, C, vals, c) : 0.0;
        acc = j == 0 ? v : acc + v;
    }
    return acc;
}

__global__ void __launch_bounds__(FOLD_THREADS) fold_kernel(FoldLevels F, int L, int C, int n,
                                                            const double* __restrict__ vals,
                                                            double* __restrict__ out,
                                                            int Z, long long sv, long long so)
{
    const long long wid = (static_cast<long long>(blockIdx.x) * FOLD_THREADS + threadIdx.x) >> 5;
    if (wid >= static_cast<long long>(F.rows[L - 1]) * C) return;  // warp-uniform
    const int g = static_cast<int>(wid / C), c = static_cast<int>(wid % C);
    for (int z = blockIdx.y; z < Z; z += gridDim.y) {
        const double v = fold_row(F, L - 1, g, n, C, vals + static_cast<size_t>(z) * sv, c);
        if ((threadIdx.x & 31) == 0) out[static_cast<size_t>(z) * so + wid] = v;
    }
}

constexpr int SUM_THREADS = 256;

// One launch's jobs, by value: each group with its own output, then the
// shared output (group -1); job j owns threads [start[j], start[j + 1]).
struct SumLaunch {
    SumPlanArgs p;
    const double* vals[SUM_MAX_GROUPS];
    double* out[SUM_MAX_GROUPS];
    long long start[SUM_MAX_GROUPS + 2];
    int group[SUM_MAX_GROUPS + 1];
    int jobs, n, C_shared;
    double* shared;
    int S;  // scenarios (1: the one-scenario launch)
};

// segment s's sum of channel c: its K gathers in ascending order
__device__ __forceinline__ double row_sum(const int* idx, int K, int s, const double* vals, int n, int C,
                                          int c)
{
    return fold::row_sum(idx + static_cast<size_t>(s) * K, K, vals, n, C, c);
}

// group h's values of scenario z
__device__ __forceinline__ const double* scen_vals(const SumLaunch& L, int h, size_t z)
{
    return L.vals[h] + z * static_cast<size_t>(L.n) * L.p.C[h];
}

__global__ void __launch_bounds__(SUM_THREADS) segsum_plan_kernel(SumLaunch L)
{
    const long long t = static_cast<long long>(blockIdx.x) * SUM_THREADS + threadIdx.x;
    if (t >= L.start[L.jobs]) return;
    int j = 0;
    while (t >= L.start[j + 1]) ++j;
    const long long local = t - L.start[j];
    const int g = L.group[j];
    for (int zi = blockIdx.y; zi < L.S; zi += gridDim.y) {
        const size_t z = static_cast<size_t>(zi);
        if (g >= 0) {
            const int C = L.p.C[g];
            L.out[g][z * L.p.S[g] * C + local] = row_sum(L.p.idx[g], L.p.K[g], static_cast<int>(local / C),
                                                         scen_vals(L, g, z), L.n, C, static_cast<int>(local % C));
            continue;
        }
        const int C = L.C_shared;
        const int b = static_cast<int>(local / C), c = static_cast<int>(local % C);
        double acc = 0.0;
        for (int h = 0; h < L.p.G; ++h) {
            if (L.p.inv[h] == nullptr) continue;
            const int s = L.p.inv[h][b];
            if (s >= 0) acc = acc + row_sum(L.p.idx[h], L.p.K[h], s, scen_vals(L, h, z), L.n, C, c);
        }
        L.shared[z * L.p.rows * C + local] = acc;
    }
}

}  // namespace

namespace {

int launch_segsum(
    int S, int K, int C, int n, const int* idx, const double* vals, double* out, int Z, cudaStream_t stream)
{
    const long long total = static_cast<long long>(S) * C;
    if (total <= 0) return 0;
    const int threads = 256;
    const int blocks = static_cast<int>((total + threads - 1) / threads);
    segsum_kernel<<<dim3(blocks, Z < 65535 ? Z : 65535), threads, 0, stream>>>(
        S, K, C, n, idx, vals, out, Z, static_cast<long long>(n) * C, total);
    return static_cast<int>(cudaGetLastError());
}

// K10 on Z scenarios' vals (Z, n, C) into out (Z, rows[L - 1], C)
int launch_fold(int L, const int* const* idx, const int* rows, const int* K, int C, int n, int Z,
                const double* vals, double* out, cudaStream_t stream)
{
    if (L < 1 || L > FOLD_MAX_LEVELS || Z < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (L == 1) return launch_segsum(rows[0], K[0], C, n, idx[0], vals, out, Z, stream);
    FoldLevels F = {};
    for (int l = 0; l < L; ++l) {
        F.idx[l] = idx[l];
        F.rows[l] = rows[l];
        F.K[l] = K[l];
    }
    const long long warps = static_cast<long long>(rows[L - 1]) * C;
    if (warps <= 0) return 0;
    const long long blocks = (warps * 32 + FOLD_THREADS - 1) / FOLD_THREADS;
    fold_kernel<<<dim3(static_cast<unsigned>(blocks), Z < 65535 ? Z : 65535), FOLD_THREADS, 0, stream>>>(
        F, L, C, n, vals, out, Z, static_cast<long long>(n) * C, warps);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10: L levels (host arrays of their device pointers, rows and widths)
// folded from vals (n, C) into out (rows[L - 1], C) in one launch
extern "C" int nxfx_fold(
    int L, const int* const* idx, const int* rows, const int* K, int C, int n,
    const double* vals, double* out, cudaStream_t stream)
{
    return launch_fold(L, idx, rows, K, C, n, 1, vals, out, stream);
}

// The same over S scenarios in one launch: vals (S, n, C), out (S, rows[L - 1], C).
extern "C" int nxfx_fold_scen(
    int L, const int* const* idx, const int* rows, const int* K, int C, int n, int S,
    const double* vals, double* out, cudaStream_t stream)
{
    return launch_fold(L, idx, rows, K, C, n, S, vals, out, stream);
}

namespace {

int launch_segsum_plan(
    const SumPlanArgs* plan, int n, int S,
    const double* v0, const double* v1, const double* v2, const double* v3,
    double* o0, double* o1, double* o2, double* o3, cudaStream_t stream)
{
    if (plan->G < 1 || plan->G > SUM_MAX_GROUPS || S < 1) return static_cast<int>(cudaErrorInvalidValue);
    SumLaunch L = {};
    L.S = S;
    L.p = *plan;
    const double* vals[SUM_MAX_GROUPS] = {v0, v1, v2, v3};
    double* outs[SUM_MAX_GROUPS] = {o0, o1, o2, o3};
    L.n = n;
    long long total = 0;
    for (int g = 0; g < plan->G; ++g) {
        L.vals[g] = vals[g];
        L.out[g] = outs[g];
        if (plan->inv[g] != nullptr) {
            if (L.shared == nullptr) {
                L.shared = outs[g];
                L.C_shared = plan->C[g];
            }
            continue;
        }
        L.start[L.jobs] = total;
        L.group[L.jobs++] = g;
        total += static_cast<long long>(plan->S[g]) * plan->C[g];
    }
    if (L.shared != nullptr) {
        L.start[L.jobs] = total;
        L.group[L.jobs++] = -1;
        total += static_cast<long long>(plan->rows) * L.C_shared;
    }
    L.start[L.jobs] = total;
    if (total <= 0) return 0;
    const long long blocks = (total + SUM_THREADS - 1) / SUM_THREADS;
    const dim3 grid(static_cast<unsigned>(blocks), S < 65535 ? S : 65535);
    segsum_plan_kernel<<<grid, SUM_THREADS, 0, stream>>>(L);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6 on a sum plan: one launch for all its groups.  vals: the groups' value
// arrays (n rows each; a null past the plan's groups); out: each group's
// output (the groups with bins name the shared output).
extern "C" int nxfx_segsum_plan(
    const SumPlanArgs* plan, int n,
    const double* v0, const double* v1, const double* v2, const double* v3,
    double* o0, double* o1, double* o2, double* o3, cudaStream_t stream)
{
    return launch_segsum_plan(plan, n, 1, v0, v1, v2, v3, o0, o1, o2, o3, stream);
}

// The same over S scenarios in one launch: each value array (S, n, C) and
// each output (S,) + its one-scenario shape.
extern "C" int nxfx_segsum_plan_scen(
    const SumPlanArgs* plan, int n, int S,
    const double* v0, const double* v1, const double* v2, const double* v3,
    double* o0, double* o1, double* o2, double* o3, cudaStream_t stream)
{
    return launch_segsum_plan(plan, n, S, v0, v1, v2, v3, o0, o1, o2, o3, stream);
}
