// K22b: the per-strip body of the strip-sharded lattice solve.
//
// Replaces networks_fenicsx_tpu/parallel/grid_sharded.py:_make_grid_local_body
// (:247-391) between the strip's K1 and the placed K22-reduce:
//
//   window, one thread per cell (i, j) of the strip's (h+1, nx) window (row
//   i is lambda row d·h + i), from the strip's x-edges (h, nx-1), y-edges
//   (h, nx) and conductances masked by the slot's validity (:279-300):
//     rhs = cF_x(i, j-1) - const_x(i, j) + cF_y(i-1, j) - const_y(i, j)
//     diag = w_x(i, j) + w_x(i, j-1) + w_y(i, j) + w_y(i-1, j)
//   (terms outside the strip's slots absent, in the reference's order);
//   stubs, one thread per window cell that holds stubs, then one per stub
//   group (:302-314): the cell's stubs' rhs (-const at a source end, cF at
//   a target end) and conductance added in slot order, and w_r, each
//   group's summed stub conductance; shard 0 also writes its representative
//   x- and y-edge conductances wx, wy (:333-335; the other strips write 0,
//   so that the reduce yields them, as the reference's psum does);
//   row layout: [rhs window | diag window | wx, wy | w_r (r)];
//   fill, replicated after the reduce: the lattice's uniform per-edge
//   conductances (Ex of wx, Ey of wy, 0 at the stubs), K17's matvec input.
//
// Bound: bytes of the strip (a few MB at 512², 8 strips).  Each output has
// one writer and sums in a fixed order: no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

inline int blocks_for(long long n) { return static_cast<int>((n + THREADS - 1) / THREADS); }

struct Slots {
    const double* w;
    const double* cst;
    const double* Ftot;
    const int* valid;
    __device__ double wm(int e) const { return valid[e] ? w[e] : 0.0; }
    __device__ double cm(int e) const { return valid[e] ? cst[e] : 0.0; }
    __device__ double cF(int e) const { return cm(e) + Ftot[e]; }
};

__global__ void grid_window_kernel(int h, int nx, Slots s, double* __restrict__ part)
{
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long cells = static_cast<long long>(h + 1) * nx;
    if (t >= cells) return;
    const int i = static_cast<int>(t / nx);
    const int j = static_cast<int>(t % nx);
    const int Ex_loc = h * (nx - 1);
    const int xr = i * (nx - 1);             // x-edge row base
    const int ya = Ex_loc + (i - 1) * nx;     // y-edge row above (i - 1)
    const int yb = Ex_loc + i * nx;           // y-edge row below (i)
    double r = 0.0, d = 0.0;
    if (i < h && j >= 1) r = r + s.cF(xr + j - 1);
    if (i < h && j < nx - 1) r = r + (-s.cm(xr + j));
    if (i >= 1) r = r + s.cF(ya + j);
    if (i < h) r = r + (-s.cm(yb + j));
    if (i < h && j < nx - 1) d = d + s.wm(xr + j);
    if (i < h && j >= 1) d = d + s.wm(xr + j - 1);
    if (i < h) d = d + s.wm(yb + j);
    if (i >= 1) d = d + s.wm(ya + j);
    part[t] = r;
    part[cells + t] = d;
}

__global__ void grid_stubs_kernel(
    int h, int nx, int U, int Kc, int r_dct, int Kg, int first, Slots s,
    const int* __restrict__ st_cell, const int* __restrict__ st_fold,
    const int* __restrict__ grp_fold, const int* __restrict__ st_sb, double* part)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const long long cells = static_cast<long long>(h + 1) * nx;
    const int base = h * (nx - 1) + h * nx;   // first stub slot
    if (t < U) {
        double ar = 0.0, ad = 0.0;
        for (int k = 0; k < Kc; ++k) {
            const int q = st_fold[static_cast<size_t>(t) * Kc + k];
            if (q < 0) break;
            const int e = base + q;
            const double v = st_sb[q] ? -s.cm(e) : s.cF(e);
            ar = k == 0 ? v : ar + v;
            ad = k == 0 ? s.wm(e) : ad + s.wm(e);
        }
        const long long c = st_cell[t];
        part[c] = part[c] + ar;
        part[cells + c] = part[cells + c] + ad;
    } else if (t < U + r_dct) {
        const int g = t - U;
        double a = 0.0;
        for (int k = 0; k < Kg; ++k) {
            const int q = grp_fold[static_cast<size_t>(g) * Kg + k];
            if (q < 0) break;
            a = k == 0 ? s.wm(base + q) : a + s.wm(base + q);
        }
        part[2 * cells + 2 + g] = a;
    } else if (t == U + r_dct) {
        part[2 * cells] = first ? s.wm(0) : 0.0;
        part[2 * cells + 1] = first ? s.wm(h * (nx - 1)) : 0.0;
    }
}

__global__ void grid_fill_kernel(long long Ex, long long Ey, long long E, const double* __restrict__ wxy,
                            double* __restrict__ w_grid)
{
    const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= E) return;
    w_grid[e] = e < Ex ? wxy[0] : (e < Ex + Ey ? wxy[1] : 0.0);
}

}  // namespace

extern "C" int nxfx_shard_grid_window(
    int h, int nx, int U, int Kc, int r_dct, int Kg, int first,
    const double* w, const double* cst, const double* Ftot, const int* valid,
    const int* st_cell, const int* st_fold, const int* grp_fold, const int* st_sb,
    double* part, cudaStream_t stream)
{
    cudaError_t err;
    Slots s{w, cst, Ftot, valid};
    const long long cells = static_cast<long long>(h + 1) * nx;
    grid_window_kernel<<<blocks_for(cells), THREADS, 0, stream>>>(h, nx, s, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    grid_stubs_kernel<<<blocks_for(U + r_dct + 1), THREADS, 0, stream>>>(
        h, nx, U, Kc, r_dct, Kg, first, s, st_cell, st_fold, grp_fold, st_sb, part);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_shard_grid_fill(
    long long Ex, long long Ey, long long E, const double* wxy, double* w_grid,
    cudaStream_t stream)
{
    if (E <= 0) return 0;
    grid_fill_kernel<<<blocks_for(E), THREADS, 0, stream>>>(Ex, Ey, E, wxy, w_grid);
    return static_cast<int>(cudaGetLastError());
}
