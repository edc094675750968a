// K17: the lattice-layout Schur system of the grid route.
//
// Replaces the per-solve body of networks_fenicsx_tpu/solver.py:
// _grid_blocked_core (the 2-D assembly, the refinement stencil and the
// norms; condensation is K1, the expansion K5).  Edges are in the grid
// plan's internal order: x-edges (ny, nx-1) row-major from 0, y-edges
// (ny-1, nx) row-major from Ex, then the boundary stubs.  Node n = i nx + j.
//   assemble:  rhs[n]  = sum over incident edges of (const + Ftot) at an
//                        edge's target end and -const at its source end,
//              diag[n] = sum of w over incident edges,
//              each stub adding its term at its row (in stub order);
//   residual:  res = rhs - L lam,  L lam = diag lam - sum w_e lam(neighbour);
//   norms:     ||rhs||, ||res|| as per-block partial sums of squares, then
//              one block that adds them up.
// Each node reads its at most four lattice edges by index arithmetic and
// walks the (at most 16) stubs, adding in the reference's order of slice
// adds: no gather table, no atomics.
//
// Bound: device-memory bytes.  At 512^2 the assembly reads three (E,) edge
// vectors and writes two (B,) grids (~16 MB), a residual reads lam, diag,
// rhs and the two weight blocks and writes res (~10 MB).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ void block_sumsq(double v, double* partial)
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

__global__ void __launch_bounds__(THREADS) grid_assemble_kernel(
    int nx, int ny, int n_stub,
    const double* __restrict__ w,
    const double* __restrict__ cst,
    const double* __restrict__ Ftot,
    const int* __restrict__ stub_rows,
    const int* __restrict__ stub_s_bif,
    double* __restrict__ rhs,
    double* __restrict__ diag,
    double* __restrict__ partial)
{
    const int B = nx * ny;
    const int Ex = ny * (nx - 1);
    const int Ey = (ny - 1) * nx;
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    double acc = 0.0;
    if (n < B) {
        const int i = n / nx, j = n % nx;
        const int xl = i * (nx - 1) + j - 1;  // x-edge ending here (j >= 1)
        const int xr = i * (nx - 1) + j;      // x-edge starting here (j <= nx - 2)
        const int yd = Ex + (i - 1) * nx + j; // y-edge ending here (i >= 1)
        const int yu = Ex + i * nx + j;       // y-edge starting here (i <= ny - 2)
        double d = 0.0;
        if (j >= 1) acc += cst[xl] + Ftot[xl];
        if (j <= nx - 2) acc += -cst[xr];
        if (i >= 1) acc += cst[yd] + Ftot[yd];
        if (i <= ny - 2) acc += -cst[yu];
        if (j <= nx - 2) d += w[xr];
        if (j >= 1) d += w[xl];
        if (i <= ny - 2) d += w[yu];
        if (i >= 1) d += w[yd];
        for (int t = 0; t < n_stub; ++t) {
            if (stub_rows[t] != n) continue;
            const int e = Ex + Ey + t;
            acc += stub_s_bif[t] ? -cst[e] : cst[e] + Ftot[e];
        }
        for (int t = 0; t < n_stub; ++t)
            if (stub_rows[t] == n) d += w[Ex + Ey + t];
        rhs[n] = acc;
        diag[n] = d;
    }
    block_sumsq(acc, partial);
}

__global__ void __launch_bounds__(THREADS) grid_residual_kernel(
    int nx, int ny,
    const double* __restrict__ w,
    const double* __restrict__ diag,
    const double* __restrict__ lam,
    const double* __restrict__ rhs,
    double* __restrict__ res,
    double* __restrict__ partial)
{
    const int B = nx * ny;
    const int Ex = ny * (nx - 1);
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    double r = 0.0;
    if (n < B) {
        const int i = n / nx, j = n % nx;
        double out = diag[n] * lam[n];
        if (j <= nx - 2) out += -w[i * (nx - 1) + j] * lam[n + 1];
        if (j >= 1) out += -w[i * (nx - 1) + j - 1] * lam[n - 1];
        if (i <= ny - 2) out += -w[Ex + i * nx + j] * lam[n + nx];
        if (i >= 1) out += -w[Ex + (i - 1) * nx + j] * lam[n - nx];
        r = rhs[n] - out;
        res[n] = r;
    }
    if (partial != nullptr) block_sumsq(r, partial);
}

// out = sqrt(sum of the partial sums), one block
__global__ void grid_norm_kernel(int m, const double* __restrict__ partial, double* __restrict__ out)
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

int grid_blocks(int B) { return (B + THREADS - 1) / THREADS; }

int finish_norm(int m, double* partial, double* out, cudaStream_t stream)
{
    grid_norm_kernel<<<1, 1024, 0, stream>>>(m, partial, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partial must hold grid_blocks(nx ny) doubles
extern "C" int nxfx_grid_assemble(
    int nx, int ny, int n_stub,
    const double* w, const double* cst, const double* Ftot,
    const int* stub_rows, const int* stub_s_bif,
    double* rhs, double* diag, double* partial, double* rhs_norm, cudaStream_t stream)
{
    const int B = nx * ny;
    if (B <= 0) return 0;
    grid_assemble_kernel<<<grid_blocks(B), THREADS, 0, stream>>>(
        nx, ny, n_stub, w, cst, Ftot, stub_rows, stub_s_bif, rhs, diag, partial);
    const int code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
    return finish_norm(grid_blocks(B), partial, rhs_norm, stream);
}

// res = rhs - L lam; with partial and norm non-null also norm = ||res||
extern "C" int nxfx_grid_residual(
    int nx, int ny,
    const double* w, const double* diag, const double* lam, const double* rhs,
    double* res, double* partial, double* norm, cudaStream_t stream)
{
    const int B = nx * ny;
    if (B <= 0) return 0;
    grid_residual_kernel<<<grid_blocks(B), THREADS, 0, stream>>>(
        nx, ny, w, diag, lam, rhs, res, partial);
    const int code = static_cast<int>(cudaGetLastError());
    if (code != 0 || partial == nullptr) return code;
    return finish_norm(grid_blocks(B), partial, norm, stream);
}
