// K19b: the bifurcation Laplacian matvec by gather and fold, for graphs
// without a shift plan.
//
// Replaces networks_fenicsx_tpu/solver.py:_matvec_from_plan: with the
// directed interior half-edges sorted by their owning row
// (_build_matvec_plan) and laid out as (K, B) tables in the fold order of the
// reference's _segsum_sorted (column k of row i: the edge e and the
// neighbour j of the row's k-th half-edge, -1 past its last),
//   out_i = diag_i x_i + sum_k (-w_e) x_j,    w = 1 / W per edge,
// the sum taken over k in order, as the plain version adds the gather
// matrix's columns.  Three forms, as K18's: apply (L x), residual (b - L x,
// with ||b - L x|| as per-block partial sums of squares finished by one
// block) and one fused Chebyshev-Jacobi step with the scaling s = diag^-1/2
// (y = s x; dvec = c1 dvec + c2 (rs - s L y); x_out = x_in + dvec; on the
// last step z = s x_out, plus base when given).
//
// Bound: device-memory bytes: the two index tables, diag, x (and b), w at
// the row's edges and the output.  One thread owns one row; the (K, B)
// layout makes the table reads coalesced across a warp; the gathers of w
// and x follow the graph.  x_in and x_out are different buffers.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// (L y)_i with y = x, or y = s x when s is given
__device__ __forceinline__ double gather_row(int i, int B, int K, const int* e_idx, const int* o_idx,
                                             const double* w, const double* diag, const double* x,
                                             const double* s)
{
    double acc = 0.0;
    for (int k = 0; k < K; ++k) {
        const size_t at = static_cast<size_t>(k) * B + i;
        const int e = e_idx[at];
        if (e < 0) break;
        const int j = o_idx[at];
        const double xj = s != nullptr ? s[j] * x[j] : x[j];
        const double c = (-w[e]) * xj;
        acc = k == 0 ? c : acc + c;
    }
    const double xi = s != nullptr ? s[i] * x[i] : x[i];
    return diag[i] * xi + acc;
}

__global__ void __launch_bounds__(THREADS) gather_apply_kernel(
    int B, int K, const int* __restrict__ e_idx, const int* __restrict__ o_idx,
    const double* __restrict__ w, const double* __restrict__ diag, const double* __restrict__ x,
    const double* b, double* __restrict__ out, double* __restrict__ partial)
{
    __shared__ double part[THREADS];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    double r = 0.0;
    if (i < B) {
        const double o = gather_row(i, B, K, e_idx, o_idx, w, diag, x, nullptr);
        r = b != nullptr ? b[i] - o : o;
        out[i] = r;
    }
    if (partial == nullptr) return;
    part[threadIdx.x] = r * r;
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) part[threadIdx.x] = part[threadIdx.x] + part[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0) partial[blockIdx.x] = part[0];
}

__global__ void __launch_bounds__(THREADS) gather_cheb_kernel(
    int B, int K, const int* __restrict__ e_idx, const int* __restrict__ o_idx,
    const double* __restrict__ w, const double* __restrict__ diag, const double* __restrict__ s,
    const double* __restrict__ rs, double* __restrict__ dvec, const double* __restrict__ x_in,
    double* __restrict__ x_out, double c1, double c2, double* z, const double* base)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    const double mv = s[i] * gather_row(i, B, K, e_idx, o_idx, w, diag, x_in, s);
    const double dv = c1 * dvec[i] + c2 * (rs[i] - mv);
    dvec[i] = dv;
    const double xn = x_in[i] + dv;
    x_out[i] = xn;
    if (z != nullptr) z[i] = base != nullptr ? base[i] + s[i] * xn : s[i] * xn;
}

__global__ void sumsq_finish_kernel(int m, const double* __restrict__ partial, double* __restrict__ out)
{
    __shared__ double part[1024];
    double acc = 0.0;
    for (int i = threadIdx.x; i < m; i += blockDim.x) acc += partial[i];
    part[threadIdx.x] = acc;
    __syncthreads();
    for (int half = blockDim.x / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) part[threadIdx.x] = part[threadIdx.x] + part[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0) *out = sqrt(part[0]);
}

}  // namespace

// out = L x, or b - L x when b is given; partial (ceil(B / 256) doubles) and
// norm may be null
extern "C" int nxfx_gather_apply(
    int B, int K, const int* e_idx, const int* o_idx, const double* w, const double* diag,
    const double* x, const double* b, double* out, double* partial, double* norm, cudaStream_t stream)
{
    if (B <= 0) return 0;
    const int blocks = (B + THREADS - 1) / THREADS;
    gather_apply_kernel<<<blocks, THREADS, 0, stream>>>(B, K, e_idx, o_idx, w, diag, x, b, out, partial);
    const int code = static_cast<int>(cudaGetLastError());
    if (code != 0 || partial == nullptr) return code;
    sumsq_finish_kernel<<<1, 1024, 0, stream>>>(blocks, partial, norm);
    return static_cast<int>(cudaGetLastError());
}

// one Chebyshev step; z and base may be null
extern "C" int nxfx_gather_cheb(
    int B, int K, const int* e_idx, const int* o_idx, const double* w, const double* diag,
    const double* s, const double* rs, double* dvec, const double* x_in, double* x_out,
    double c1, double c2, double* z, const double* base, cudaStream_t stream)
{
    if (B <= 0) return 0;
    gather_cheb_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        B, K, e_idx, o_idx, w, diag, s, rs, dvec, x_in, x_out, c1, c2, z, base);
    return static_cast<int>(cudaGetLastError());
}
