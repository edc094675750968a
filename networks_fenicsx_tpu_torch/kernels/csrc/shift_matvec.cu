// K18: the bifurcation Laplacian matvec by shift classes.
//
// Replaces networks_fenicsx_tpu/solver.py:_shift, _shift_matvec and
// _matvec_from_shift_plan.  With the class offsets d_c, the (C, B) class
// weights cw (K6 sums of the runtime conductances, once per solve) and the
// interleaved (B, 2) bifurcation system dr = (diag, rhs):
//   out_i = diag_i lam_i - sum_c cw[c, i] lam_{i + d_c}   (0 outside [0, B))
//   res_i = rhs_i - out_i
// and, when asked, ||res|| as per-block partial sums of squares finished by
// one block.
//
// Bound: device-memory bytes, (2 + 2 C) B doubles read and B written per
// call.  One thread owns one row and walks the classes in the reference's
// order (ascending offset), so the sum is the plain version's to the last
// bit; the reads of lam at the C offsets are coalesced across the warp.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CLASSES = 16;

struct Offsets {
    int d[MAX_CLASSES];
};

__global__ void __launch_bounds__(THREADS) shift_matvec_kernel(
    int B, int C, Offsets off,
    const double* __restrict__ cw,
    const double* __restrict__ dr,
    const double* __restrict__ lam,
    double* __restrict__ res,
    double* __restrict__ partial)
{
    __shared__ double part[THREADS];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    double r = 0.0;
    if (i < B) {
        double out = dr[2 * (size_t)i] * lam[i];
        for (int c = 0; c < C; ++c) {
            const long long j = (long long)i + off.d[c];
            const double v = (j >= 0 && j < B) ? lam[j] : 0.0;
            out = out - cw[(size_t)c * B + i] * v;
        }
        r = dr[2 * (size_t)i + 1] - out;
        res[i] = r;
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

// partial (ceil(B / 256) doubles) and norm may be null
extern "C" int nxfx_shift_matvec(
    int B, int C, const int* offsets_host,
    const double* cw, const double* dr, const double* lam,
    double* res, double* partial, double* norm, cudaStream_t stream)
{
    if (B <= 0) return 0;
    if (C < 0 || C > MAX_CLASSES) return static_cast<int>(cudaErrorInvalidValue);
    Offsets off{};
    for (int c = 0; c < C; ++c) off.d[c] = offsets_host[c];
    const int blocks = (B + THREADS - 1) / THREADS;
    shift_matvec_kernel<<<blocks, THREADS, 0, stream>>>(B, C, off, cw, dr, lam, res, partial);
    int code = static_cast<int>(cudaGetLastError());
    if (code != 0 || partial == nullptr) return code;
    sumsq_finish_kernel<<<1, 1024, 0, stream>>>(blocks, partial, norm);
    return static_cast<int>(cudaGetLastError());
}
