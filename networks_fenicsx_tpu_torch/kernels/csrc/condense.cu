// K1: per-edge static condensation of the blocked forest Schur solve.
//
// Replaces networks_fenicsx_tpu/solver.py:_blocked_condense,
// _blocked_condense_R and _blocked_condense_f (g, Ftot) plus the `const`
// line of _blocked_uniform_solve.  Per internal edge e:
//   W     = wt * sum_c R_c h          (scalar/edge R: R h N wt)
//   w     = 1 / W
//   Ftot  = sum_c f_c h               (scalar/edge f: f h N)
//   g     = 1^T M cumF                (closed form when neither R nor f is per cell)
//   const = (-p_s [s not bif] + p_t [t not bif] - g) * w
//
// Bound: device-memory bytes.  Scalar/edge modes read and write O(E)
// doubles; cell mode reads the (N, E) j-major R and f blocks once.  One
// thread owns one edge and walks its column down the N cells, so each
// step of the walk is one coalesced row read across the warp; no shared
// memory, no atomics, every sum in the reference's order along the edge.

#include <cuda_runtime.h>

namespace {

// coefficient modes, as passed by kernels/condense.py
constexpr int MODE_SCALAR = 0;
constexpr int MODE_EDGE = 1;
constexpr int MODE_CELL = 2;

__global__ void condense_kernel(
    int E, int N,
    const double* __restrict__ h_e,
    const double* __restrict__ R, int R_mode,
    const double* __restrict__ f, int f_mode,
    const double* __restrict__ start_pbc,
    const double* __restrict__ end_pbc,
    const int* __restrict__ edge_src,
    const int* __restrict__ edge_tgt,
    double wt, double cs0, double cs1, double g_closed,
    double* __restrict__ W_out,
    double* __restrict__ w_out,
    double* __restrict__ g_out,
    double* __restrict__ Ftot_out,
    double* __restrict__ const_out)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    const double h = h_e[e];
    const double dN = static_cast<double>(N);
    const bool r_cell = R_mode == MODE_CELL;
    const bool f_cell = f_mode == MODE_CELL;

    // resistance side: a1 = R h per edge, or a2_c = R_c h per cell
    double a1 = 0.0, W;
    if (!r_cell) {
        a1 = (R_mode == MODE_SCALAR ? R[0] : R[e]) * h;
        W = a1 * (dN * wt);
    } else {
        double s = 0.0;
        for (int c = 0; c < N; ++c) s += R[(size_t)c * E + e] * h;
        W = wt * s;
    }

    // source side: F1 = f h per edge, or F2_c = f_c h per cell
    double F1 = 0.0, Ftot, g;
    if (!f_cell) {
        F1 = (f_mode == MODE_SCALAR ? f[0] : f[e]) * h;
        Ftot = F1 * dN;
    }
    if (!r_cell && !f_cell) {
        g = a1 * F1 * g_closed;
    } else {
        // g = sum_c ab_c (cs0 cumF_c + cs1 cumF_{c+1}), one pass down the column
        double cum = 0.0, acc = 0.0;
        for (int c = 0; c < N; ++c) {
            const double next = f_cell ? cum + f[(size_t)c * E + e] * h
                                       : F1 * static_cast<double>(c + 1);
            const double wsum = cs0 * cum + cs1 * next;
            acc += r_cell ? (R[(size_t)c * E + e] * h) * wsum : wsum;
            cum = next;
        }
        if (f_cell) Ftot = cum;
        g = r_cell ? acc : a1 * acc;
    }

    const double w = 1.0 / W;
    const double not_s = edge_src[e] >= 0 ? 0.0 : 1.0;
    const double not_t = edge_tgt[e] >= 0 ? 0.0 : 1.0;
    W_out[e] = W;
    w_out[e] = w;
    g_out[e] = g;
    Ftot_out[e] = Ftot;
    const_out[e] = (-start_pbc[e] * not_s + end_pbc[e] * not_t - g) * w;
}

}  // namespace

extern "C" int nxfx_condense(
    int E, int N,
    const double* h_e,
    const double* R, int R_mode,
    const double* f, int f_mode,
    const double* start_pbc, const double* end_pbc,
    const int* edge_src, const int* edge_tgt,
    double wt, double cs0, double cs1, double g_closed,
    double* W, double* w, double* g, double* Ftot, double* cst,
    cudaStream_t stream)
{
    if (E <= 0) return 0;
    const int threads = 256;
    const int blocks = (E + threads - 1) / threads;
    condense_kernel<<<blocks, threads, 0, stream>>>(
        E, N, h_e, R, R_mode, f, f_mode, start_pbc, end_pbc, edge_src, edge_tgt,
        wt, cs0, cs1, g_closed, W, w, g, Ftot, cst);
    return static_cast<int>(cudaGetLastError());
}
