// K18: the bifurcation Laplacian matvec by shift classes.
//
// Replaces networks_fenicsx_tpu/solver.py:_shift, _shift_matvec and
// _matvec_from_shift_plan.  With the class offsets d_c, the (C, B) class
// weights cw (K6 sums of the runtime conductances, once per solve) and the
// diagonal:
//   out_i = diag_i x_i - sum_c cw[c, i] x_{i + d_c}   (0 outside [0, B))
// three forms:
//   apply     out = L x, or with b the residual b - L x and, when asked,
//             ||b - L x|| as per-block partial sums of squares finished by
//             one block; diag and b are strided (the general DCT route
//             reads them from the interleaved (B, 2) system dr: stride 2);
//   cheb      one step of the Chebyshev-Jacobi smoother of the CG route and
//             of the 1-D multigrid levels (ops/krylov.py:58-65) with the
//             Jacobi scaling s = diag^-1/2 fused: y = s x, then
//             dvec = c1 dvec + c2 (rs - s L y), x_out = x_in + dvec, and on
//             the last step z = s x_out (+ base).
//
// Bound: device-memory bytes, (2 + 2 C) B doubles read and B written per
// apply.  One thread owns one row and walks the classes in the reference's
// order (ascending offset), so the sum is the plain version's to the last
// bit; the reads of x at the C offsets are coalesced across the warp.  x_in
// and x_out are different buffers: a row reads its neighbours' x.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CLASSES = 16;

struct Offsets {
    int d[MAX_CLASSES];
};

__global__ void __launch_bounds__(THREADS) shift_apply_kernel(
    int B, int C, Offsets off,
    const double* __restrict__ cw,
    const double* diag, int dstride,
    const double* __restrict__ x,
    const double* b, int bstride,
    double* __restrict__ out,
    double* __restrict__ partial)
{
    __shared__ double part[THREADS];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    double r = 0.0;
    if (i < B) {
        double o = diag[static_cast<size_t>(dstride) * i] * x[i];
        for (int c = 0; c < C; ++c) {
            const long long j = (long long)i + off.d[c];
            const double v = (j >= 0 && j < B) ? x[j] : 0.0;
            o = o - cw[(size_t)c * B + i] * v;
        }
        r = b != nullptr ? b[static_cast<size_t>(bstride) * i] - o : o;
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

__global__ void __launch_bounds__(THREADS) shift_cheb_kernel(
    int B, int C, Offsets off,
    const double* __restrict__ cw,
    const double* __restrict__ diag,
    const double* __restrict__ s,
    const double* __restrict__ rs,
    double* __restrict__ dvec,
    const double* __restrict__ x_in,
    double* __restrict__ x_out,
    double c1, double c2,
    double* z, const double* base)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    double o = diag[i] * (s[i] * x_in[i]);
    for (int c = 0; c < C; ++c) {
        const long long j = (long long)i + off.d[c];
        const double v = (j >= 0 && j < B) ? s[j] * x_in[j] : 0.0;
        o = o - cw[(size_t)c * B + i] * v;
    }
    const double mv = s[i] * o;
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

int offsets_of(int C, const int* offsets_host, Offsets* off)
{
    if (C < 0 || C > MAX_CLASSES) return static_cast<int>(cudaErrorInvalidValue);
    for (int c = 0; c < C; ++c) off->d[c] = offsets_host[c];
    return 0;
}

}  // namespace

// out = L x, or b - L x when b is given; diag and b are read at strides
// dstride and bstride (2 for the columns of the interleaved (B, 2) dr);
// partial (ceil(B / 256) doubles) and norm may be null
extern "C" int nxfx_shift_matvec(
    int B, int C, const int* offsets_host,
    const double* cw, const double* diag, int dstride, const double* x, const double* b, int bstride,
    double* out, double* partial, double* norm, cudaStream_t stream)
{
    if (B <= 0) return 0;
    Offsets off{};
    int code = offsets_of(C, offsets_host, &off);
    if (code != 0) return code;
    const int blocks = (B + THREADS - 1) / THREADS;
    shift_apply_kernel<<<blocks, THREADS, 0, stream>>>(B, C, off, cw, diag, dstride, x, b, bstride, out,
                                                       partial);
    code = static_cast<int>(cudaGetLastError());
    if (code != 0 || partial == nullptr) return code;
    sumsq_finish_kernel<<<1, 1024, 0, stream>>>(blocks, partial, norm);
    return static_cast<int>(cudaGetLastError());
}

// one Chebyshev step; z and base may be null
extern "C" int nxfx_shift_cheb(
    int B, int C, const int* offsets_host,
    const double* cw, const double* diag, const double* s, const double* rs, double* dvec,
    const double* x_in, double* x_out, double c1, double c2, double* z, const double* base,
    cudaStream_t stream)
{
    if (B <= 0) return 0;
    Offsets off{};
    const int code = offsets_of(C, offsets_host, &off);
    if (code != 0) return code;
    shift_cheb_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        B, C, off, cw, diag, s, rs, dvec, x_in, x_out, c1, c2, z, base);
    return static_cast<int>(cudaGetLastError());
}
