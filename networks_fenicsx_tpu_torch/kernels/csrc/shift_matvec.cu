// K18: the bifurcation Laplacian matvec by shift classes.
//
// Replaces networks_fenicsx_tpu/solver.py:_shift, _shift_matvec and
// _matvec_from_shift_plan.  With the class offsets d_c, the (C, B) class
// weights cw (K6 sums of the runtime conductances, once per solve) and the
// diagonal:
//   out_i = diag_i x_i - sum_c cw[c, i] x_{i + d_c}   (0 outside [0, B))
// two forms:
//   apply     out = L x, or with b the residual b - L x and, when asked,
//             ||b - L x||, finished inside the launch by the last block
//             (ticket_norm.cuh); diag and b are read at the plan's stride
//             (the general DCT route reads them from the interleaved (B, 2)
//             system dr: stride 2);
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
//
// Over S scenarios (the general DCT route's sweep) a call is still one
// launch: the scenarios walk grid y, each operand moving by its own stride
// (0 for class weights that every scenario shares), each scenario's norm
// with its own partials and ticket, so row i is the bits of a call of one.
//
// Each call is one launch.  The rows, classes, offsets and stride are packed
// once per plan into a ShiftArgs (kernels/shift_matvec.py:ShiftPlan), with
// the norm's partials and ticket as scratch of the calling stream, so two
// streams and CUDA-graph replays give the bits of calls made alone.

#include <cuda_runtime.h>

#include "ticket_norm.cuh"

constexpr int SHIFT_MAX_CLASSES = 16;

// A plan's rows, classes in ascending offset, the stride of diag and b, and
// one calling stream's scratch: partial holds ceil(B / 256) doubles, ticket
// is 0 on entry and exit.  Built by the Python plan (a ctypes Structure of
// the same fields).
struct ShiftArgs {
    int B, C, stride;
    int d[SHIFT_MAX_CLASSES];
    double* partial;
    unsigned int* ticket;
};

namespace {

constexpr int THREADS = 256;

// out = L x or b - L x (and its norm) of scenarios y, y + gridDim.y, ... of
// S: cw, diag and b s_cw, s_diag and s_b further on a scenario (0: shared),
// x and out B; each scenario's norm with its own partials (one scenario's
// gridDim.x) and ticket
__global__ void __launch_bounds__(THREADS) shift_apply_kernel(
    ShiftArgs a, int S, long long s_cw, long long s_diag, long long s_b,
    const double* __restrict__ cw,
    const double* diag,
    const double* __restrict__ x,
    const double* b,
    double* __restrict__ out,
    double* norm, double* partial, unsigned int* ticket)
{
    const int B = a.B;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    for (int sc = blockIdx.y; sc < S; sc += gridDim.y) {
        const double* cs = cw + (size_t)sc * s_cw;
        const double* xs = x + (size_t)sc * B;
        double r = 0.0;
        if (i < B) {
            double o = diag[(size_t)sc * s_diag + static_cast<size_t>(a.stride) * i] * xs[i];
#pragma unroll
            for (int c = 0; c < SHIFT_MAX_CLASSES; ++c) {  // unrolled: the offsets stay kernel parameters
                if (c >= a.C) break;
                const long long j = (long long)i + a.d[c];
                const double v = (j >= 0 && j < B) ? xs[j] : 0.0;
                o = o - cs[(size_t)c * B + i] * v;
            }
            r = b != nullptr ? b[(size_t)sc * s_b + static_cast<size_t>(a.stride) * i] - o : o;
            out[(size_t)sc * B + i] = r;
        }
        if (norm != nullptr) ticket_norm<THREADS>(r, partial + (size_t)sc * gridDim.x, ticket + sc, norm + sc);
    }
}

__global__ void __launch_bounds__(THREADS) shift_cheb_kernel(
    ShiftArgs a,
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
    const int B = a.B;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    double o = diag[static_cast<size_t>(a.stride) * i] * (s[i] * x_in[i]);
#pragma unroll
    for (int c = 0; c < SHIFT_MAX_CLASSES; ++c) {
        if (c >= a.C) break;
        const long long j = (long long)i + a.d[c];
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

int blocks_of(int B) { return (B + THREADS - 1) / THREADS; }

}  // namespace

// One launch: out = L x, or b - L x when b is given; with norm non-null
// (and b given) also norm = ||b - L x||.
extern "C" int nxfx_shift_matvec(
    const ShiftArgs* a, const double* cw, const double* diag, const double* x, const double* b,
    double* out, double* norm, cudaStream_t stream)
{
    if (a->B <= 0) return 0;
    if (a->C < 0 || a->C > SHIFT_MAX_CLASSES) return static_cast<int>(cudaErrorInvalidValue);
    shift_apply_kernel<<<blocks_of(a->B), THREADS, 0, stream>>>(*a, 1, 0, 0, 0, cw, diag, x, b, out, norm, a->partial,
                                                                a->ticket);
    return static_cast<int>(cudaGetLastError());
}

// One launch over S scenarios: out (S, B) = L x, or b - L x when b is given,
// x (S, B) contiguous, cw, diag and b s_cw, s_diag and s_b apart a scenario
// (0: shared; diag and b at the plan's stride within a row); with norm
// non-null (and b given) the S norms, partial holding S blocks_of(B)
// doubles and tickets S words, 0 on entry and exit.
extern "C" int nxfx_shift_matvec_scen(
    const ShiftArgs* a, int S, long long s_cw, long long s_diag, long long s_b, const double* cw,
    const double* diag, const double* x, const double* b, double* out, double* norm, double* partial,
    unsigned int* tickets, cudaStream_t stream)
{
    if (a->B <= 0) return 0;
    if (a->C < 0 || a->C > SHIFT_MAX_CLASSES || S < 1) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(blocks_of(a->B), S < 65535 ? S : 65535);
    shift_apply_kernel<<<grid, THREADS, 0, stream>>>(*a, S, s_cw, s_diag, s_b, cw, diag, x, b, out, norm, partial,
                                                     tickets);
    return static_cast<int>(cudaGetLastError());
}

// One Chebyshev step; z and base may be null.
extern "C" int nxfx_shift_cheb(
    const ShiftArgs* a, const double* cw, const double* diag, const double* s, const double* rs,
    double* dvec, const double* x_in, double* x_out, double c1, double c2, double* z, const double* base,
    cudaStream_t stream)
{
    if (a->B <= 0) return 0;
    if (a->C < 0 || a->C > SHIFT_MAX_CLASSES) return static_cast<int>(cudaErrorInvalidValue);
    shift_cheb_kernel<<<blocks_of(a->B), THREADS, 0, stream>>>(*a, cw, diag, s, rs, dvec, x_in, x_out, c1,
                                                               c2, z, base);
    return static_cast<int>(cudaGetLastError());
}
