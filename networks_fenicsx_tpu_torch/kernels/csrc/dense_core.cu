// K11: the dense solve of a cycle core or of a dense tail (at most 8,192 nodes).
//
// Replaces networks_fenicsx_tpu/ops/mixed_precision.py:scaled_cholesky_factor
// and scaled_cholesky_solve, with the two assemblies that feed them: the core
// of networks_fenicsx_tpu/solver.py:_tree_eliminate_factor (pair p at
// (ci[p], cj[p]) with value -w_pairs[pid[p]]) and the dense tail of
// networks_fenicsx_tpu/ops/core_elim.py:_core_factor (pid = 0, 1, ..., the
// negated values given: -(init_ext[dp_init] - fold(ustream, dp_fold))).
//   Lc = diag(dc) + the pair values at (ci, cj) and (cj, ci)
//   s = sqrt(diag Lc),  Ls = (Lc / s_row) / s_col,  Ls = C C^T (Cholesky, float64)
//   ok = all pivots C_ii finite and min C_ii > 1e-7 max C_ii   (the singularity gate)
//   solve(v) = C^-T C^-1 (v / s) / s,  x = solve(rc),  n_refine x:  x += solve(rc - Lc x)
//   x = NaN everywhere when not ok
// The reference factors in float32 because float64 is emulated on the TPU;
// the H100 has native float64, so the factor is float64 here and the pivot
// gate and the refinement passes (three in the solver, as in the reference's
// scaled_cholesky_solve) are kept.
//
// The assembly and the Jacobi scaling run over the whole card, then the
// tiled multi-block factor (a panel launch a 64-column panel on a lookahead
// stream, its trailing updates on the float64 tensor cores beside the next
// panel), the one-launch dataflow triangular solves and the one-block pivot
// gate of tiled_cholesky.cuh, and a warp per row for each refinement matvec
// rc - Lc x: 2 + (2 ceil(n / 64) - 1) + 1 + 4 (1 + n_refine) launches for
// n > 64 (146 at 4,096 nodes, 34 at 455).  Factor reuse runs the factor and
// the gate once (nxfx_dense_factor, nxfx_dense_gate) and the passes per
// right-hand side (nxfx_dense_solve: 4 (1 + n_refine) launches).  Bound: the factor's n^3/3
// operations; then the 2 (1 + n_refine) n^2 / 2 factor entries read by the
// solves and the n_refine n^2 of Lc read by the matvecs.  (A one-block
// kernel of the first port, for n <= 512, measured slower than this route
// at n = 455.)
// The pairs are unique, so the assembly writes each entry once.  Lc, C, s,
// v and y are written by one thread and read by others, so they carry no
// __restrict__.
//
// A sweep (batch.solve_sweep on the dense route) runs S scenarios in the
// launches of one call: every kernel takes the scenario as its grid's y (the
// gate as its x), each array a stride further on a scenario.
//   nxfx_dense_factor_scen: S assemblies (dc and w_pairs a row each, the
//     pair tables shared) and S factors (tiled_cholesky_scen: one panel
//     launch covers panel k of every scenario), Lc, C n^2 apart;
//   nxfx_dense_gate_scen: a block a scenario, one ok flag each;
//   nxfx_dense_solve_scen: the passes of solve_passes over S right-hand
//     sides, on S factors or (shared) on one, whose Lc, C, s and ok are
//     then read at stride 0.
// A scenario's operations are the one-scenario call's, so its Lc, s, C, ok
// and x are that call's bit for bit; the launch count is one call's,
// whatever S (at most 65,535 a call: the caller chunks).

#include <cuda_runtime.h>

#include "tiled_cholesky.cuh"

namespace {

constexpr double PIVOT_RTOL = 1e-7;

// Lc = diag(dc), C = its scaled diagonal (dc / s) / s, s = sqrt(dc): over n^2
// (scenario blockIdx.y: dc, s n apart, Lc, C n^2 apart)
__global__ void tiled_init_kernel(int n, const double* __restrict__ dc, double* Lc, double* C, double* s)
{
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= static_cast<long long>(n) * n) return;
    const size_t z = blockIdx.y;
    dc += z * n;
    s += z * n;
    Lc += z * n * n;
    C += z * n * n;
    const int i = static_cast<int>(t / n), j = static_cast<int>(t % n);
    if (i == j) {
        const double si = sqrt(dc[i]);
        Lc[t] = dc[i];
        C[t] = (dc[i] / si) / si;
        s[i] = si;
    } else {
        Lc[t] = 0.0;
        C[t] = 0.0;
    }
}

// the pairs into Lc and their scaled values into C (scenario blockIdx.y:
// w_pairs P apart, s n apart, Lc, C n^2 apart)
__global__ void tiled_pairs_kernel(int n, int P0, long long P, const int* __restrict__ ci,
                                   const int* __restrict__ cj, const int* __restrict__ pid,
                                   const double* __restrict__ w_pairs, const double* s, double* Lc, double* C)
{
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P0) return;
    const size_t z = blockIdx.y;
    w_pairs += z * P;
    s += z * n;
    Lc += z * n * n;
    C += z * n * n;
    const double wv = -w_pairs[pid[p]];
    const int i = ci[p], j = cj[p];
    const size_t ij = static_cast<size_t>(i) * n + j, ji = static_cast<size_t>(j) * n + i;
    Lc[ij] = wv;
    Lc[ji] = wv;
    C[ij] = (wv / s[i]) / s[j];
    C[ji] = (wv / s[j]) / s[i];
}

// v = (rc - Lc x) / s, a warp per row (first pass: x = 0, v = rc / s);
// scenario blockIdx.y: Lc sL, s ss and rc, x, v n further on
__global__ void tiled_residual_kernel(int n, const double* Lc, const double* __restrict__ rc,
                                      const double* s, const double* x, int first, double* v, long long sL,
                                      long long ss)
{
    const int lane = threadIdx.x & 31;
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (i >= n) return;
    const size_t z = blockIdx.y;
    Lc += z * sL;
    s += z * ss;
    rc += z * n;
    x += z * n;
    v += z * n;
    double acc = 0.0;
    if (!first) {
        const double* row = Lc + static_cast<size_t>(i) * n;
        for (int j = lane; j < n; j += 32) acc = acc + row[j] * x[j];
        for (int o = 16; o > 0; o >>= 1) acc = acc + __shfl_down_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) v[i] = (first ? rc[i] : rc[i] - acc) / s[i];
}

// x = v / s (first pass) or x + v / s; last: NaN everywhere unless ok;
// scenario blockIdx.y: s ss, ok sok and v, x n further on
__global__ void tiled_update_kernel(int n, const double* v, const double* s, int first, int last,
                                    const int* ok, double* x, long long ss, long long sok)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t z = blockIdx.y;
    v += z * n;
    s += z * ss;
    ok += z * sok;
    x += z * n;
    double xi = first ? v[i] / s[i] : x[i] + v[i] / s[i];
    if (last && !ok[0]) xi = __longlong_as_double(0x7ff8000000000000LL);
    x[i] = xi;
}

}  // namespace

namespace {

// Lc, its scaled copy C factored in place (lower triangle) and s, for S
// scenarios (w_pairs P apart)
cudaError_t assemble_and_factor(int n, int P0, const int* ci, const int* cj, const int* pid,
                                const double* w_pairs, const double* dc, double* Lc, double* C,
                                double* s, int S, long long P, cudaStream_t stream)
{
    if (S > TC_MAX_SCENARIOS) return cudaErrorInvalidValue;
    const long long nn = static_cast<long long>(n) * n;
    tiled_init_kernel<<<dim3(static_cast<unsigned>((nn + 255) / 256), S), 256, 0, stream>>>(n, dc, Lc, C, s);
    if (P0 > 0)
        tiled_pairs_kernel<<<dim3((P0 + 255) / 256, S), 256, 0, stream>>>(n, P0, P, ci, cj, pid, w_pairs, s,
                                                                          Lc, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return tiled_cholesky_scen(C, n, n, n, S, nn, stream);
}

}  // namespace

namespace {

// The passes after the factor: x = solve(rc), n_refine x: x += solve(rc -
// Lc x), NaN everywhere unless ok; v and y (n,) are scratch.  S scenarios:
// rc, v, y, x n apart; Lc, C, s and ok a scenario apart, or (shared) one
// for all.
cudaError_t solve_passes(int n, int n_refine, const double* Lc, const double* C, const double* s,
                         const int* ok, const double* rc, double* v, double* y, double* x, int S, bool shared,
                         cudaStream_t stream)
{
    if (S > TC_MAX_SCENARIOS) return cudaErrorInvalidValue;
    cudaError_t err;
    const long long nn = shared ? 0 : static_cast<long long>(n) * n, sn = shared ? 0 : n, sok = shared ? 0 : 1;
    const dim3 rows((n * 32 + 255) / 256, S), cols((n + 255) / 256, S);
    for (int pass = 0; pass <= n_refine; ++pass) {
        tiled_residual_kernel<<<rows, 256, 0, stream>>>(n, Lc, rc, s, x, pass == 0, v, nn, sn);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        // y = C^-1 v, then v = C^-T y (a solve reads its v and writes its x)
        if ((err = tiled_solve_scen(C, n, n, v, y, false, S, nn, n, stream)) != cudaSuccess) return err;
        if ((err = tiled_solve_scen(C, n, n, y, v, true, S, nn, n, stream)) != cudaSuccess) return err;
        tiled_update_kernel<<<cols, 256, 0, stream>>>(n, v, s, pass == 0, pass == n_refine, ok, x, sn, sok);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

// Lc, C (n x n) and s, v, y (n,) are scratch; x (n,) and ok out.
extern "C" int nxfx_dense_core(
    int n, int P0, int n_refine, const int* ci, const int* cj, const int* pid,
    const double* w_pairs, const double* dc, const double* rc, double* Lc, double* C, double* s,
    double* v, double* y, double* x, int* ok, cudaStream_t stream)
{
    if (n <= 0) return 0;
    if (n_refine < 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = assemble_and_factor(n, P0, ci, cj, pid, w_pairs, dc, Lc, C, s, 1, 0, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc_gate_kernel<<<1, 1024, 0, stream>>>(n, n, C, PIVOT_RTOL, 1, ok, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(solve_passes(n, n_refine, Lc, C, s, ok, rc, v, y, x, 1, true, stream));
}

// The assembly and the factor alone (what the checks of the factor's
// backward error read): Lc, s and C out (its lower triangle the factor, its
// strict upper triangle scratch).
extern "C" int nxfx_dense_factor(
    int n, int P0, const int* ci, const int* cj, const int* pid, const double* w_pairs,
    const double* dc, double* Lc, double* C, double* s, cudaStream_t stream)
{
    if (n <= 0) return 0;
    return static_cast<int>(assemble_and_factor(n, P0, ci, cj, pid, w_pairs, dc, Lc, C, s, 1, 0, stream));
}

// The pivot gate of a factor (ok out): one launch.
extern "C" int nxfx_dense_gate(int n, const double* C, int* ok, cudaStream_t stream)
{
    if (n <= 0) return 0;
    tc_gate_kernel<<<1, 1024, 0, stream>>>(n, n, C, PIVOT_RTOL, 1, ok, 0);
    return static_cast<int>(cudaGetLastError());
}

// The solve on a stored factor (nxfx_dense_factor's Lc, C and s, the gate's
// ok): nxfx_dense_core after its gate, the same bits; v, y (n,) scratch.
extern "C" int nxfx_dense_solve(
    int n, int n_refine, const double* Lc, const double* C, const double* s, const int* ok,
    const double* rc, double* v, double* y, double* x, cudaStream_t stream)
{
    if (n <= 0) return 0;
    if (n_refine < 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(solve_passes(n, n_refine, Lc, C, s, ok, rc, v, y, x, 1, true, stream));
}

// S assemblies and factors (dc (S, n), w_pairs (S, P); Lc, C (S, n, n), s
// (S, n) out): one factor's launches.
extern "C" int nxfx_dense_factor_scen(
    int n, int S, int P0, long long P, const int* ci, const int* cj, const int* pid, const double* w_pairs,
    const double* dc, double* Lc, double* C, double* s, cudaStream_t stream)
{
    if (n <= 0 || S <= 0) return 0;
    return static_cast<int>(assemble_and_factor(n, P0, ci, cj, pid, w_pairs, dc, Lc, C, s, S, P, stream));
}

// The pivot gates of S factors (C (S, n, n); ok (S,) out): one launch, a
// block a scenario.
extern "C" int nxfx_dense_gate_scen(int n, int S, const double* C, int* ok, cudaStream_t stream)
{
    if (n <= 0 || S <= 0) return 0;
    tc_gate_kernel<<<S, 1024, 0, stream>>>(n, n, C, PIVOT_RTOL, 1, ok, static_cast<long long>(n) * n);
    return static_cast<int>(cudaGetLastError());
}

// The passes on S right-hand sides (rc (S, n); v, y (S, n) scratch; x (S,
// n) out): on S stored factors (Lc, C (S, n, n), s (S, n), ok (S,)) or,
// shared, on one (Lc, C (n, n), s (n,), ok (1,)); one solve's launches.
extern "C" int nxfx_dense_solve_scen(
    int n, int S, int n_refine, int shared, const double* Lc, const double* C, const double* s, const int* ok,
    const double* rc, double* v, double* y, double* x, cudaStream_t stream)
{
    if (n <= 0 || S <= 0) return 0;
    if (n_refine < 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(solve_passes(n, n_refine, Lc, C, s, ok, rc, v, y, x, S, shared != 0, stream));
}
