// The gather-fold row sum shared by K10 (segsum.cu: nxfx_fold, and K6's
// segment sums) and K12a (core_elim.cu: the folds inside its rounds).
//
// A fold level is a padded (rows, K) index matrix; row s sums channel c of
// the K rows it names of its source vals (n rows, C channels), in
// ascending j, an index outside [0, n) (the pad, one past the source)
// reading 0.  Every intermediate sum is the value the level-by-level plain
// version (kernels.fold.fold_apply_plain, K6's segsum_plain) rounds to,
// added in its order, so a fold equals it bit for bit whatever launch runs
// it.  vals is not __restrict__: K12a folds what its own launch wrote.

#pragma once

#include <cstddef>

namespace fold {

__device__ __forceinline__ double row_sum(const int* row, int K, const double* vals, int n, int C, int c)
{
    double acc = 0.0;
    for (int j = 0; j < K; ++j) {
        const int i = row[j];
        const double v = (i >= 0 && i < n) ? vals[static_cast<size_t>(i) * C + c] : 0.0;
        acc = j == 0 ? v : acc + v;
    }
    return acc;
}

// A group of G lanes (a power of two up to 32, aligned in its warp: lanes
// g G .. g G + G - 1) shares a row: each lane loads every G-th term, the
// terms are handed round by shuffles and every lane adds them in ascending
// order, so the sum is the sequential one to the bit while the row's loads
// are in flight together.  Every lane of the group must call it.
__device__ __forceinline__ unsigned group_mask(int G)
{
    return G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

template <typename Term>
__device__ __forceinline__ double group_sum(int K, int G, Term term)
{
    if (G == 1) {
        double acc = 0.0;
        for (int j = 0; j < K; ++j) {
            const double v = term(j);
            acc = j == 0 ? v : acc + v;
        }
        return acc;
    }
    const unsigned mask = group_mask(G);
    const int lane = threadIdx.x & (G - 1);
    double acc = 0.0;
    for (int k0 = 0; k0 < K; k0 += G) {
        const double p = k0 + lane < K ? term(k0 + lane) : 0.0;
        const int n = K - k0 < G ? K - k0 : G;
        for (int j = 0; j < n; ++j) {
            const double v = __shfl_sync(mask, p, j, G);
            acc = k0 + j == 0 ? v : acc + v;
        }
    }
    return acc;
}

// row_sum with the row's K gathers shared by a group of G lanes; value(i)
// gives the source's row i (an index outside [0, n) reads 0)
template <typename Value>
__device__ __forceinline__ double group_row_sum(const int* row, int K, int n, int G, const Value& value)
{
    return group_sum(K, G, [&](int j) {
        const int i = row[j];
        return (i >= 0 && i < n) ? value(i) : 0.0;
    });
}

// the lanes given each of `rows` rows of K terms when nth threads share
// them: one below GROUP_FROM terms, else the power of two at least K, at
// most a warp, halved while the rows would take more than one pass
constexpr int GROUP_FROM = 16;

__device__ __forceinline__ int group_for(int K, long long rows, int nth)
{
    if (K < GROUP_FROM) return 1;
    int G = GROUP_FROM;
    while (G < K && G < 32) G *= 2;
    while (G > 1 && rows * G > nth) G /= 2;
    return G;
}

}  // namespace fold
