// K17: the lattice-layout Schur system of the grid route.
//
// Replaces the per-solve body of networks_fenicsx_tpu/solver.py:1184
// _grid_blocked_core (the 2-D assembly, the refinement stencil and the
// norms; condensation is K1, the expansion K5).  Edges are in the grid
// plan's internal order: x-edges (ny, nx-1) row-major from 0, y-edges
// (ny-1, nx) row-major from Ex, then the boundary stubs.  Node n = i nx + j.
//   assemble:  rhs[n]  = sum over incident edges of (const + Ftot) at an
//                        edge's target end and -const at its source end,
//              diag[n] = sum of w over incident edges,
//              each stub adding its term at its row (in stub order);
//   residual:  res = rhs - L lam,  L lam = diag lam - sum w_e lam(neighbour);
//   norms:     ||rhs||, ||res||.
// Each node reads its at most four lattice edges by index arithmetic and
// walks the (at most 16) stubs, adding in the reference's order of slice
// adds: no gather table.
//
// Bound: device-memory bytes.  At 512^2 the assembly reads three (E,) edge
// vectors and writes two (B,) grids (~16 MB, 5.0 us at 3.35 TB/s), a
// residual reads lam, diag, rhs and the two weight blocks and writes res
// (~12.6 MB, 3.75 us).  At that size a call's device time sits at its bound,
// so what is left is the host's: one launch a call.  The norm is finished
// inside the launch: every block writes its partial sum of squares, and the
// last block to finish (a ticket) adds the partials in block order and
// writes the square root, so repeated calls give the same bits.
//
// The ticket and the partials (ticket_norm.cuh) are scratch of the calling
// stream, held by the Python plan (one buffer per stream, zeroed on that
// stream at its first call), so calls on two streams never share them.  The
// last block puts the ticket back to 0 before the launch ends, so every
// launch, a CUDA-graph replay included, finds it at 0: the kernel needs no
// refusal under graph capture.
//
// Over S scenarios (a sweep, or S right-hand sides on one factor) each call
// is still one launch: the scenarios walk grid y (y, y + gridDim.y, ...),
// every input moving by its own stride (0 where every scenario shares it:
// the conductances and the diagonal when R is shared), and each scenario's
// norm has its own partials (one scenario's gridDim.x of them) and ticket in
// the stream's scenario scratch, so row i is the bits of a call of one.

#include <cuda_runtime.h>

#include "ticket_norm.cuh"

// Elements between two scenarios' rows of each input and output (0: shared);
// a ctypes Structure of the same fields on the Python side.
struct GridStrides {
    long long w, cst, F, diag, lam, rhs;
};

namespace {

constexpr int THREADS = 256;

// rhs, diag (when sd or sc == 0: a shared w gives one diag) and, with
// rhs_norm non-null, ||rhs|| of scenarios y, y + gridDim.y, ... of S
__global__ void __launch_bounds__(THREADS) grid_assemble_kernel(
    int nx, int ny, int n_stub, int S, GridStrides st,
    const double* __restrict__ w,
    const double* __restrict__ cst,
    const double* __restrict__ Ftot,
    const int* __restrict__ stub_rows,
    const int* __restrict__ stub_s_bif,
    double* __restrict__ rhs,
    double* __restrict__ diag,
    double* partial, unsigned int* ticket, double* rhs_norm)
{
    const int B = nx * ny;
    const int Ex = ny * (nx - 1);
    const int Ey = (ny - 1) * nx;
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    for (int sc = blockIdx.y; sc < S; sc += gridDim.y) {
        const double* ws = w + (size_t)sc * st.w;
        const double* cs = cst + (size_t)sc * st.cst;
        const double* Fs = Ftot + (size_t)sc * st.F;
        double acc = 0.0;
        if (n < B) {
            const int i = n / nx, j = n % nx;
            const int xl = i * (nx - 1) + j - 1;  // x-edge ending here (j >= 1)
            const int xr = i * (nx - 1) + j;      // x-edge starting here (j <= nx - 2)
            const int yd = Ex + (i - 1) * nx + j; // y-edge ending here (i >= 1)
            const int yu = Ex + i * nx + j;       // y-edge starting here (i <= ny - 2)
            double d = 0.0;
            if (j >= 1) acc += cs[xl] + Fs[xl];
            if (j <= nx - 2) acc += -cs[xr];
            if (i >= 1) acc += cs[yd] + Fs[yd];
            if (i <= ny - 2) acc += -cs[yu];
            if (j <= nx - 2) d += ws[xr];
            if (j >= 1) d += ws[xl];
            if (i <= ny - 2) d += ws[yu];
            if (i >= 1) d += ws[yd];
            for (int t = 0; t < n_stub; ++t) {
                if (stub_rows[t] != n) continue;
                const int e = Ex + Ey + t;
                acc += stub_s_bif[t] ? -cs[e] : cs[e] + Fs[e];
            }
            for (int t = 0; t < n_stub; ++t)
                if (stub_rows[t] == n) d += ws[Ex + Ey + t];
            rhs[(size_t)sc * B + n] = acc;
            if (st.diag != 0 || sc == 0) diag[(size_t)sc * st.diag + n] = d;
        }
        if (rhs_norm != nullptr)
            ticket_norm<THREADS>(acc, partial + (size_t)sc * gridDim.x, ticket + sc, rhs_norm + sc);
    }
}

// res = rhs - L lam (and, with norm non-null, ||res||) of scenarios y,
// y + gridDim.y, ... of S; res is B a scenario
__global__ void __launch_bounds__(THREADS) grid_residual_kernel(
    int nx, int ny, int S, GridStrides st,
    const double* __restrict__ w,
    const double* __restrict__ diag,
    const double* __restrict__ lam,
    const double* __restrict__ rhs,
    double* __restrict__ res,
    double* partial, unsigned int* ticket, double* norm)
{
    const int B = nx * ny;
    const int Ex = ny * (nx - 1);
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    for (int sc = blockIdx.y; sc < S; sc += gridDim.y) {
        const double* ws = w + (size_t)sc * st.w;
        const double* ls = lam + (size_t)sc * st.lam;
        double r = 0.0;
        if (n < B) {
            const int i = n / nx, j = n % nx;
            double out = diag[(size_t)sc * st.diag + n] * ls[n];
            if (j <= nx - 2) out += -ws[i * (nx - 1) + j] * ls[n + 1];
            if (j >= 1) out += -ws[i * (nx - 1) + j - 1] * ls[n - 1];
            if (i <= ny - 2) out += -ws[Ex + i * nx + j] * ls[n + nx];
            if (i >= 1) out += -ws[Ex + (i - 1) * nx + j] * ls[n - nx];
            r = rhs[(size_t)sc * st.rhs + n] - out;
            res[(size_t)sc * B + n] = r;
        }
        if (norm != nullptr) ticket_norm<THREADS>(r, partial + (size_t)sc * gridDim.x, ticket + sc, norm + sc);
    }
}

int grid_blocks(int B) { return (B + THREADS - 1) / THREADS; }

// the grid rows of a launch over S scenarios (the grid's y limit)
unsigned int scen_rows(int S) { return static_cast<unsigned int>(S < 65535 ? S : 65535); }

}  // namespace

// The lattice and the calling stream's scratch, built once per plan and
// stream by the Python plan (a ctypes Structure of the same fields):
// partial holds grid_blocks(nx ny) doubles, ticket is 0 on entry and exit.
struct GridArgs {
    int nx, ny, n_stub;
    const int* stub_rows;
    const int* stub_s_bif;
    double* partial;
    unsigned int* ticket;
};

// One launch: rhs, diag and ||rhs||.
extern "C" int nxfx_grid_assemble(
    const GridArgs* a, const double* w, const double* cst, const double* Ftot,
    double* rhs, double* diag, double* rhs_norm, cudaStream_t stream)
{
    const int B = a->nx * a->ny;
    if (B <= 0) return 0;
    grid_assemble_kernel<<<grid_blocks(B), THREADS, 0, stream>>>(
        a->nx, a->ny, a->n_stub, 1, GridStrides{0, 0, 0, 0, 0, 0}, w, cst, Ftot, a->stub_rows, a->stub_s_bif,
        rhs, diag, a->partial, a->ticket, rhs_norm);
    return static_cast<int>(cudaGetLastError());
}

// One launch: res = rhs - L lam; with norm non-null also norm = ||res||.
extern "C" int nxfx_grid_residual(
    const GridArgs* a, const double* w, const double* diag, const double* lam, const double* rhs,
    double* res, double* norm, cudaStream_t stream)
{
    const int B = a->nx * a->ny;
    if (B <= 0) return 0;
    grid_residual_kernel<<<grid_blocks(B), THREADS, 0, stream>>>(
        a->nx, a->ny, 1, GridStrides{0, 0, 0, 0, 0, 0}, w, diag, lam, rhs, res, a->partial, a->ticket, norm);
    return static_cast<int>(cudaGetLastError());
}

// One launch over S scenarios: rhs (S, B), diag ((S, B), or (B,) when the
// conductances are shared: st.w == 0) and, with rhs_norm non-null, the S
// norms; partial holds S grid_blocks(nx ny) doubles and tickets S words, 0
// on entry and exit.
extern "C" int nxfx_grid_assemble_scen(
    const GridArgs* a, int S, const GridStrides* st, const double* w, const double* cst, const double* Ftot,
    double* rhs, double* diag, double* rhs_norm, double* partial, unsigned int* tickets, cudaStream_t stream)
{
    const int B = a->nx * a->ny;
    if (B <= 0) return 0;
    if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
    grid_assemble_kernel<<<dim3(grid_blocks(B), scen_rows(S)), THREADS, 0, stream>>>(
        a->nx, a->ny, a->n_stub, S, *st, w, cst, Ftot, a->stub_rows, a->stub_s_bif, rhs, diag, partial, tickets,
        rhs_norm);
    return static_cast<int>(cudaGetLastError());
}

// One launch over S scenarios: res (S, B) = rhs - L lam and, with norm
// non-null, the S norms (scratch as nxfx_grid_assemble_scen's).
extern "C" int nxfx_grid_residual_scen(
    const GridArgs* a, int S, const GridStrides* st, const double* w, const double* diag, const double* lam,
    const double* rhs, double* res, double* norm, double* partial, unsigned int* tickets, cudaStream_t stream)
{
    const int B = a->nx * a->ny;
    if (B <= 0) return 0;
    if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
    grid_residual_kernel<<<dim3(grid_blocks(B), scen_rows(S)), THREADS, 0, stream>>>(
        a->nx, a->ny, S, *st, w, diag, lam, rhs, res, partial, tickets, norm);
    return static_cast<int>(cudaGetLastError());
}
