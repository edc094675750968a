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
// nxfx_segsum_into adds the sums into rows of an existing output instead:
//   out[bins[s], c] += sum_j vals[idx[s, j], c]
// with bins sorted and unique (the reference's sorted-unique scatter-add of
// _lambda_system_sorted), so each output row has one writer: no atomics.

#include <cuda_runtime.h>

namespace {

// bins == nullptr: out[s, c] = sum; otherwise out[bins[s], c] += sum
__global__ void segsum_kernel(
    int S, int K, int C, int n,
    const int* __restrict__ idx,
    const double* __restrict__ vals,
    const int* __restrict__ bins,
    double* __restrict__ out)
{
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= static_cast<long long>(S) * C) return;
    const int s = static_cast<int>(t / C);
    const int c = static_cast<int>(t % C);
    const int* row = idx + static_cast<size_t>(s) * K;
    double acc = 0.0;
    for (int j = 0; j < K; ++j) {
        const int i = row[j];
        const double v = (i >= 0 && i < n) ? vals[static_cast<size_t>(i) * C + c] : 0.0;
        acc = j == 0 ? v : acc + v;
    }
    if (bins == nullptr) {
        out[t] = acc;
    } else {
        const size_t o = static_cast<size_t>(bins[s]) * C + c;
        out[o] = out[o] + acc;
    }
}

}  // namespace

namespace {

int launch_segsum(
    int S, int K, int C, int n, const int* idx, const double* vals, const int* bins,
    double* out, cudaStream_t stream)
{
    const long long total = static_cast<long long>(S) * C;
    if (total <= 0) return 0;
    const int threads = 256;
    const int blocks = static_cast<int>((total + threads - 1) / threads);
    segsum_kernel<<<blocks, threads, 0, stream>>>(S, K, C, n, idx, vals, bins, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nxfx_segsum(
    int S, int K, int C, int n,
    const int* idx, const double* vals, double* out,
    cudaStream_t stream)
{
    return launch_segsum(S, K, C, n, idx, vals, nullptr, out, stream);
}

extern "C" int nxfx_segsum_into(
    int S, int K, int C, int n,
    const int* idx, const double* vals, const int* bins, double* out,
    cudaStream_t stream)
{
    return launch_segsum(S, K, C, n, idx, vals, bins, out, stream);
}
