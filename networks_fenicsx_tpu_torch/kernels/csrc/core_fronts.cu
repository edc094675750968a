// K12b: the supernodal fronts of the sparse core elimination.
//
// Replaces networks_fenicsx_tpu/ops/core_elim.py:_core_factor (its front
// tail) and _core_apply (the front sweeps).  A front pivots w nodes (S) with
// a boundary clique of b nodes (B), m = w + b, stored as an m x m row-major
// block F of one flat buffer.  With init(i) = -w_pairs[init_slot[i]] for
// i < P0, else 0, per front in plan order:
//
//   assemble:  F = diag(d[nodes]) on the pivots, the slot values
//              init(f_init[q]) - sf[q] at (slot_i[q], slot_j[q]) and their
//              mirror (sf: the f_fold fold of the update stream, K10), then
//              + U_c[lminv, lminv] for each consumed front c, in plan order
//              (lminv's pad b_c adds nothing)
//   factor:    the first w columns of F (tiled_cholesky.cuh): F_SS = L L^T,
//              lower-left Y^T = F_BS L^-T, trailing U = F_BB - Y^T Y (lower
//              triangle; its consumer reads U(a, b) at max(a, b), min(a, b))
//   gate:      ok = 0 unless every pivot L_ii is finite and min > 1e-12 max
//              (the gate, the sweeps' gather and scatter: tiled_cholesky.cuh)
//   forward:   y = L^-1 r[nodes],  r[bnd] -= Y^T y
//   back, fronts reversed:
//              lam[nodes] = L^-T (y - Y lam[bnd])
//   last:      lam = NaN everywhere unless ok
//
// The reference keeps C = chol(F_SS), X = F_SS^-1 F_SB and U = F_BB - F_BS X
// for its matrix unit: the same factor and sweeps in another association
// (r_B -= X^T r_S = Y^T (L^-1 r_S); L^-T(L^-1 r_S - Y lam_B) = C^-T C^-1 r_S
// - X lam_B).  Bound: the fronts' w^3/3 + w^2 b + w b^2 factor operations;
// the factor and the sweeps run multi-block, a launch per 64 columns.
// F is written by one thread and read by others in a later launch, and
// lam and r carry the sweeps between launches: no __restrict__ on them.

#include <cuda_runtime.h>

#include "tiled_cholesky.cuh"

namespace {

constexpr double FRONT_PIVOT_RTOL = 1e-12;

inline int blocks(long long n) { return static_cast<int>((n + 255) / 256); }

__global__ void front_init_kernel(int m, int w, const int* __restrict__ nodes, const double* d, double* F)
{
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= static_cast<long long>(m) * m) return;
    const int i = static_cast<int>(t / m), j = static_cast<int>(t % m);
    F[t] = (i == j && i < w) ? d[nodes[i]] : 0.0;
}

__global__ void front_slots_kernel(
    int ns, int m, int P0, const int* __restrict__ slot_i, const int* __restrict__ slot_j,
    const int* __restrict__ f_init, const int* __restrict__ init_slot,
    const double* __restrict__ w_pairs, const double* sf, double* F)
{
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= ns) return;
    const int fi = f_init[q];
    double v = fi < P0 ? -w_pairs[init_slot[fi]] : 0.0;
    if (sf != nullptr) v = v - sf[q];
    const int i = slot_i[q], j = slot_j[q];
    F[static_cast<size_t>(i) * m + j] = v;
    F[static_cast<size_t>(j) * m + i] = v;
}

// F += U_c[lminv, lminv], U_c the trailing block of the consumed front's Fc
// (mc x mc, wc pivots): U_c(a, b) = Fc[wc + max(a, b)][wc + min(a, b)]
__global__ void front_consume_kernel(int m, const int* __restrict__ lminv, const double* Fc, int mc,
                                     int wc, double* F)
{
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= static_cast<long long>(m) * m) return;
    const int bc = mc - wc;
    const int a = lminv[t / m], b = lminv[t % m];
    if (a >= bc || b >= bc) return;
    const int hi = a > b ? a : b, lo = a > b ? b : a;
    F[t] = F[t] + Fc[static_cast<size_t>(wc + hi) * mc + wc + lo];
}

// r[bnd[j]] -= sum_i Y^T[j][i] y[i], a warp per boundary row j (rows w + j of F)
__global__ void front_push_kernel(int w, int b, int m, const int* __restrict__ bnd, const double* F,
                                  const double* y, double* r)
{
    const int lane = threadIdx.x & 31;
    const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (j >= b) return;
    const double* row = F + static_cast<size_t>(w + j) * m;
    double acc = 0.0;
    for (int i = lane; i < w; i += 32) acc = fma(row[i], y[i], acc);
    for (int o = 16; o > 0; o >>= 1) acc = acc + __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) r[bnd[j]] = r[bnd[j]] - acc;
}

// t[i] = y[i] - sum_j Y^T[j][i] lam[bnd[j]], a thread per pivot i
__global__ void front_pull_kernel(int w, int b, int m, const int* __restrict__ bnd, const double* F,
                                  const double* y, const double* lam, double* t)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= w) return;
    double acc = 0.0;
    for (int j = 0; j < b; ++j) acc = fma(F[static_cast<size_t>(w + j) * m + i], lam[bnd[j]], acc);
    t[i] = y[i] - acc;
}

__global__ void nan_gate_kernel(int n, const int* ok, double* lam)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n && !ok[0]) lam[i] = __longlong_as_double(0x7ff8000000000000LL);
}

#define NXFX_CHECK()                                                          \
    do {                                                                      \
        const cudaError_t e_ = cudaGetLastError();                            \
        if (e_ != cudaSuccess) return static_cast<int>(e_);                   \
    } while (0)

}  // namespace

// Assemble and factor one front (fid = 0 sets ok, later fronts AND into it).
// cons: (n_cons, 3) host table of (F offset, m_c, w_c) of the consumed
// fronts; lminv: their (n_cons, m) inverse maps, concatenated.
extern "C" int nxfx_front_factor(
    int w, int b, int ns, int P0, int first, const int* nodes, const double* d,
    const int* slot_i, const int* slot_j, const int* f_init, const int* init_slot,
    const double* w_pairs, const double* sf, int n_cons, const long long* cons, const int* lminv,
    double* fbuf, long long f_off, int* ok, cudaStream_t stream)
{
    const int m = w + b;
    const long long mm = static_cast<long long>(m) * m;
    double* F = fbuf + f_off;
    front_init_kernel<<<blocks(mm), 256, 0, stream>>>(m, w, nodes, d, F);
    if (ns > 0)
        front_slots_kernel<<<blocks(ns), 256, 0, stream>>>(ns, m, P0, slot_i, slot_j, f_init,
                                                           init_slot, w_pairs, sf, F);
    NXFX_CHECK();
    for (int c = 0; c < n_cons; ++c) {
        const long long* row = cons + 3 * c;
        front_consume_kernel<<<blocks(mm), 256, 0, stream>>>(
            m, lminv + static_cast<size_t>(c) * m, fbuf + row[0], static_cast<int>(row[1]),
            static_cast<int>(row[2]), F);
        NXFX_CHECK();
    }
    const cudaError_t err = tiled_cholesky(F, m, m, w, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc_gate_kernel<<<1, 1024, 0, stream>>>(w, m, F, FRONT_PIVOT_RTOL, first, ok);
    NXFX_CHECK();
    return 0;
}

// Forward sweep of one front: t = r[nodes], y = L^-1 t (y: this front's (w,)
// slice of the saved stream, t (w,) scratch), r[bnd] -= Y^T y.
extern "C" int nxfx_front_forward(
    int w, int b, const int* nodes, const int* bnd, const double* fbuf, long long f_off,
    double* r, double* t, double* y, cudaStream_t stream)
{
    const int m = w + b;
    const double* F = fbuf + f_off;
    tc_gather_kernel<<<blocks(w), 256, 0, stream>>>(w, nodes, r, t);
    NXFX_CHECK();
    const cudaError_t err = tiled_solve(F, m, w, t, y, false, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (b > 0) {
        front_push_kernel<<<blocks(static_cast<long long>(b) * 32), 256, 0, stream>>>(w, b, m, bnd, F, y, r);
        NXFX_CHECK();
    }
    return 0;
}

// Back sweep of one front: t = y - Y lam[bnd], u = L^-T t, lam[nodes] = u
// (t, u (w,) scratch).
extern "C" int nxfx_front_back(
    int w, int b, const int* nodes, const int* bnd, const double* fbuf, long long f_off,
    const double* y, double* t, double* u, double* lam, cudaStream_t stream)
{
    const int m = w + b;
    const double* F = fbuf + f_off;
    front_pull_kernel<<<blocks(w), 256, 0, stream>>>(w, b, m, bnd, F, y, lam, t);
    NXFX_CHECK();
    const cudaError_t err = tiled_solve(F, m, w, t, u, true, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc_scatter_kernel<<<blocks(w), 256, 0, stream>>>(w, nodes, u, lam);
    NXFX_CHECK();
    return 0;
}

// lam (n,) = NaN everywhere unless ok.
extern "C" int nxfx_front_nan_gate(int n, const int* ok, double* lam, cudaStream_t stream)
{
    if (n <= 0) return 0;
    nan_gate_kernel<<<blocks(n), 256, 0, stream>>>(n, ok, lam);
    NXFX_CHECK();
    return 0;
}
