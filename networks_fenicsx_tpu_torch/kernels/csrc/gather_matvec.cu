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
// matrix's columns.
//
// A CG solve's w does not change across its iterations, so a plan's solve
// first gathers its value table nw = -w[e] ((K, B), 0 past a row's last
// entry; one launch), and every later product reads (j, nw) and no longer
// gathers w through e: the products (-w_e) x_j and their order are the
// same, so the results are the direct form's to the bit.  On the table:
//   * apply (L x) and residual (b - L x, with ||b - L x|| as per-block
//     partial sums of squares finished by one block);
//   * a whole Chebyshev-Jacobi application (ops/krylov.py:chebyshev_preconditioner)
//     with the scaling s = diag^-1/2, from one host call on a per-stream
//     argument struct (GatherChebArgs): its start (rs = s r,
//     x = dvec = rs / theta, K19a's cheb_start) folded into its first step,
//     each neighbour's start value formed where the step reads it, then the
//     steps (y = s x; dvec = c1 dvec + c2 (rs - s L y); x_out = x_in + dvec;
//     on the last z = s x_out, plus base when given), into the stream's
//     scratch, in one cooperative launch with a grid barrier between steps
//     (a launch a step took ~10 % less device time and ~1 % more time a
//     call, its host issue 3-4x as long: the web-cg solve is held by its host).
// The launchers on the table return the kernels they enqueued, or minus
// the CUDA error.
// The direct form (w gathered through e) stays for the sharded general
// solve's off-diagonal apply (nxfx_gather_apply).
//
// Bound: device-memory bytes: the tables, diag, x (and b), the values and
// the output, which an application's steps read again from L2.  One thread
// owns one row (eight lanes a row, each forming one entry's product, ran a
// step ~1.5x slower on the card: the lanes' table reads coalesce worse);
// the (K, B) layout makes the table reads coalesced across a warp; the
// gathers of x follow the graph.  x_in and x_out are different buffers.

#include <cuda_runtime.h>

// A Chebyshev application's arguments on one stream (a ctypes Structure of
// the same fields): the plan's neighbour table, the solve's value table,
// diagonal and scaling, the coefficients (c1 then c2, steps each, on the
// device), and the stream's scratch.
struct GatherChebArgs {
    int B;
    int K;
    int steps;       // the steps after the start (degree - 1)
    int grid;        // the launch's blocks at most (all co-resident)
    const int* o_idx;
    const double* nw;
    const double* diag;
    const double* s;
    const double* coef;   // (2, steps)
    double theta;
    double* rs;
    double* dvec;
    double* xa;
    double* xb;
    unsigned* bar;        // the grid barrier: (arrivals, generation)
};

namespace {

constexpr int THREADS = 256;

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

// (L y)_i with y = x, or y = s x when s is given; w gathered through e
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

// (L y)_i on the value table, y(j) the operand at row j
template <class Y>
__device__ __forceinline__ double values_row(int i, int B, int K, const int* o_idx, const double* nw,
                                             const double* diag, Y y)
{
    double acc = 0.0;
    for (int k = 0; k < K; ++k) {
        const size_t at = static_cast<size_t>(k) * B + i;
        const int j = o_idx[at];
        if (j < 0) break;
        const double c = nw[at] * y(j);
        acc = k == 0 ? c : acc + c;
    }
    return diag[i] * y(i) + acc;
}

__device__ __forceinline__ void block_sumsq(double v, double* partial)
{
    __shared__ double part[THREADS];
    part[threadIdx.x] = v * v;
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) part[threadIdx.x] = part[threadIdx.x] + part[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0) partial[blockIdx.x] = part[0];
}

__global__ void __launch_bounds__(THREADS) gather_apply_kernel(
    int B, int K, const int* __restrict__ e_idx, const int* __restrict__ o_idx,
    const double* __restrict__ w, const double* __restrict__ diag, const double* __restrict__ x,
    const double* b, double* __restrict__ out, double* __restrict__ partial)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    double r = 0.0;
    if (i < B) {
        const double o = gather_row(i, B, K, e_idx, o_idx, w, diag, x, nullptr);
        r = b != nullptr ? b[i] - o : o;
        out[i] = r;
    }
    if (partial != nullptr) block_sumsq(r, partial);
}

// nw = -w[e] over the (K, B) edge table, 0 past a row's last entry
__global__ void __launch_bounds__(THREADS) gather_values_kernel(
    long long n, const int* __restrict__ e_idx, const double* __restrict__ w, double* __restrict__ nw)
{
    const long long at = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (at >= n) return;
    const int e = e_idx[at];
    nw[at] = e >= 0 ? -w[e] : 0.0;
}

__global__ void __launch_bounds__(THREADS) plan_apply_kernel(
    int B, int K, const int* __restrict__ o_idx, const double* __restrict__ nw,
    const double* __restrict__ diag, const double* __restrict__ x, const double* b,
    double* __restrict__ out, double* __restrict__ partial)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    double r = 0.0;
    if (i < B) {
        const double o = values_row(i, B, K, o_idx, nw, diag, [x](int j) { return x[j]; });
        r = b != nullptr ? b[i] - o : o;
        out[i] = r;
    }
    if (partial != nullptr) block_sumsq(r, partial);
}

// one Chebyshev step of row i from x_in, or from the start (rs = s r,
// x = dvec = rs / theta, formed here and at each neighbour) when x_in is
// null; z (plus base) on the last step when z is given
__device__ __forceinline__ void cheb_row(const GatherChebArgs& a, int i, const double* r, const double* x_in,
                                         double* x_out, double c1, double c2, bool last, double* z,
                                         const double* base)
{
    const double* s = a.s;
    double xi, rsi, dvi, mv;
    if (x_in == nullptr) {
        const double theta = a.theta;
        rsi = s[i] * r[i];
        xi = rsi / theta;
        dvi = xi;
        a.rs[i] = rsi;
        mv = s[i] * values_row(i, a.B, a.K, a.o_idx, a.nw, a.diag,
                               [s, r, theta](int j) { return s[j] * ((s[j] * r[j]) / theta); });
    } else {
        xi = x_in[i];
        rsi = a.rs[i];
        dvi = a.dvec[i];
        mv = s[i] * values_row(i, a.B, a.K, a.o_idx, a.nw, a.diag, [s, x_in](int j) { return s[j] * x_in[j]; });
    }
    const double dv = c1 * dvi + c2 * (rsi - mv);
    a.dvec[i] = dv;
    const double xn = xi + dv;
    x_out[i] = xn;
    if (last && z != nullptr) z[i] = base != nullptr ? base[i] + s[i] * xn : s[i] * xn;
}

// step t of an application: the start folded into step 0 (degree 1: the
// start alone, z = s (s r / theta)); step t writes xa for even t and xb for
// odd t, and reads what step t - 1 wrote
__device__ __forceinline__ void apply_row(const GatherChebArgs& a, int i, int t, const double* r, double* z,
                                          const double* base)
{
    if (a.steps == 0) {
        const double xi = (a.s[i] * r[i]) / a.theta;
        z[i] = base != nullptr ? base[i] + a.s[i] * xi : a.s[i] * xi;
        return;
    }
    const double* x_in = t == 0 ? nullptr : (t % 2 == 1 ? a.xa : a.xb);
    double* x_out = t % 2 == 0 ? a.xa : a.xb;
    cheb_row(a, i, r, x_in, x_out, a.coef[t], a.coef[a.steps + t], t == a.steps - 1, z, base);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p)
{
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// every block of the (co-resident) grid past this point before any goes on
__device__ void grid_barrier(unsigned* bar)
{
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned gen = load_acquire(bar + 1);
        __threadfence();
        if (atomicAdd(bar, 1u) == gridDim.x - 1) {
            atomicExch(bar, 0u);
            __threadfence();
            atomicAdd(bar + 1, 1u);
        } else {
            while (load_acquire(bar + 1) == gen) {
            }
        }
        __threadfence();
    }
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS) cheb_apply_kernel(GatherChebArgs a, const double* r, double* z,
                                                             const double* base)
{
    const int stride = gridDim.x * blockDim.x;
    const int last = a.steps > 0 ? a.steps : 1;
    for (int t = 0; t < last; ++t) {
        if (t > 0) grid_barrier(a.bar);
        for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.B; i += stride) apply_row(a, i, t, r, z, base);
    }
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

int finish_norm(int code, int blocks, double* partial, double* norm, cudaStream_t stream)
{
    if (code != 0 || partial == nullptr) return code;
    sumsq_finish_kernel<<<1, 1024, 0, stream>>>(blocks, partial, norm);
    return static_cast<int>(cudaGetLastError());
}

// the kernels enqueued, or minus the CUDA error of their launches
int enqueued(int code, int count) { return code != 0 ? -code : count; }

}  // namespace

// The direct form: out = L x, or b - L x when b is given; partial (ceil(B /
// 256) doubles) and norm may be null
extern "C" int nxfx_gather_apply(
    int B, int K, const int* e_idx, const int* o_idx, const double* w, const double* diag,
    const double* x, const double* b, double* out, double* partial, double* norm, cudaStream_t stream)
{
    if (B <= 0) return 0;
    const int blocks = (B + THREADS - 1) / THREADS;
    gather_apply_kernel<<<blocks, THREADS, 0, stream>>>(B, K, e_idx, o_idx, w, diag, x, b, out, partial);
    return finish_norm(static_cast<int>(cudaGetLastError()), blocks, partial, norm, stream);
}

// A solve's value table nw (K, B) from w and the plan's edge table
extern "C" int nxfx_gather_values(int B, int K, const int* e_idx, const double* w, double* nw,
                                  cudaStream_t stream)
{
    const long long n = static_cast<long long>(B) * K;
    if (n <= 0) return 0;
    gather_values_kernel<<<static_cast<int>((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(n, e_idx, w, nw);
    return enqueued(static_cast<int>(cudaGetLastError()), 1);
}

// On the value table: out = L x, or b - L x when b is given; partial and norm may be null
extern "C" int nxfx_gather_plan_apply(
    int B, int K, const int* o_idx, const double* nw, const double* diag, const double* x,
    const double* b, double* out, double* partial, double* norm, cudaStream_t stream)
{
    if (B <= 0) return 0;
    const int blocks = (B + THREADS - 1) / THREADS;
    plan_apply_kernel<<<blocks, THREADS, 0, stream>>>(B, K, o_idx, nw, diag, x, b, out, partial);
    const int code = finish_norm(static_cast<int>(cudaGetLastError()), blocks, partial, norm, stream);
    return enqueued(code, partial != nullptr ? 2 : 1);
}

// The blocks of one persistent application that fit on the device at once
extern "C" int nxfx_gather_cheb_blocks(int device)
{
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cheb_apply_kernel, THREADS, 0) != cudaSuccess)
        return -1;
    return sms * per_sm;
}

// A whole Chebyshev application: z = M^-1 r (plus base), base may be null;
// one cooperative launch (its blocks all resident, as the barrier needs)
extern "C" int nxfx_gather_cheb_apply(const GatherChebArgs* a, const double* r, double* z, const double* base,
                                      cudaStream_t stream)
{
    if (a->B <= 0) return 0;
    const int blocks = blocks_for(a->B);
    GatherChebArgs args = *a;
    void* params[] = {&args, &r, &z, &base};
    const int grid = a->grid < blocks ? a->grid : blocks;
    if (grid <= 0) return -static_cast<int>(cudaErrorInvalidValue);
    return enqueued(static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(cheb_apply_kernel),
                                                                 dim3(grid), dim3(THREADS), params, 0, stream)),
                    1);
}
