// K22b: the per-strip body of the strip-sharded lattice solve, for every
// strip of one device in one launch.
//
// Replaces networks_fenicsx_tpu/parallel/grid_sharded.py:_make_grid_local_body
// (:247-391) between the strips' K1 and the placed K22-reduce:
//
//   window, one thread per cell (i, j) of a strip's (h+1, nx) window (row
//   i is lambda row d·h + i), from the strip's x-edges (h, nx-1), y-edges
//   (h, nx) and conductances masked by the slot's validity (:279-300):
//     rhs = cF_x(i, j-1) - const_x(i, j) + cF_y(i-1, j) - const_y(i, j)
//     diag = w_x(i, j) + w_x(i, j-1) + w_y(i, j) + w_y(i-1, j)
//   (terms outside the strip's slots absent, in the reference's order);
//   where the cell holds stubs (its row of the cell -> stub map), the
//   stubs' rhs (-const at a source end, cF at a target end) and conductance
//   summed in slot order and added after (:302-314); each value written once;
//   further threads of the launch: w_r, each stub group's summed stub
//   conductance, and the representative x- and y-edge conductances wx, wy
//   of the first strip (:333-335; the other strips write 0, so that the
//   reduce yields them, as the reference's psum does);
//   row layout: [rhs window | diag window | wx, wy | w_r (r)], a row a
//   strip of the (S, row) tensor that the placed reduce reads;
//   fill, replicated after the reduce: the lattice's uniform per-edge
//   conductances (Ex of wx, Ey of wy, 0 at the stubs), K17's matvec input.
//
// The grid is (blocks over a window's cells + r + 1, S), the strip being
// blockIdx.y; its w, const and Ftot are row blockIdx.y of K1's (S, E_loc)
// planes and its tables row blockIdx.y of the stacked tables, so no struct
// of pointers is needed.  Two launches a device a solve (window, fill),
// where a launch a strip for the window and one for its stubs made 17 on 8
// strips: 43-48 us of device time on an NVIDIA H100 80GB HBM3 at 700 W, ~2.8
// us of latency a launch around ~0.9 us of bytes; in one launch and the fill,
// 8.3-8.4 us (scripts/profile_torch_main_path.py --kernels --select strips).
//
// Bound: bytes.  A 512² solve in 8 strips reads each strip's three K1 rows,
// its validity, its cell -> stub map and stub tables and writes its row
// (24.2 MB with the fill: 7.22 us at 3.35 TB/s).  Each output has one
// writer and sums in a fixed order (the per-strip kernels': the window's
// terms, then the stubs' sum added), no atomics, so each row is theirs to
// the bit.

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

// grid (blocks over (h+1)·nx + r + 1, S): strip blockIdx.y's row
__global__ void __launch_bounds__(THREADS) grid_window_kernel(
    int h, int nx, int U, int Kc, int r_dct, int Kg, int E_loc, int st_len, int first,
    const double* __restrict__ w, const double* __restrict__ cst,
    const double* __restrict__ Ftot, const int* __restrict__ valid,
    const int* __restrict__ cell_map, const int* __restrict__ st_fold,
    const int* __restrict__ grp_fold, const int* __restrict__ st_sb, double* __restrict__ part)
{
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int j = blockIdx.y;
    const long long cells = static_cast<long long>(h + 1) * nx;
    const size_t off = static_cast<size_t>(j) * E_loc;
    const Slots s{w + off, cst + off, Ftot + off, valid + off};
    double* row = part + static_cast<size_t>(j) * (2 * cells + 2 + r_dct);
    const int base = h * (nx - 1) + h * nx;   // first stub slot
    if (t < cells) {
        const int i = static_cast<int>(t / nx);
        const int c = static_cast<int>(t % nx);
        const int Ex_loc = h * (nx - 1);
        const int xr = i * (nx - 1);             // x-edge row base
        const int ya = Ex_loc + (i - 1) * nx;     // y-edge row above (i - 1)
        const int yb = Ex_loc + i * nx;           // y-edge row below (i)
        double r = 0.0, d = 0.0;
        if (i < h && c >= 1) r = r + s.cF(xr + c - 1);
        if (i < h && c < nx - 1) r = r + (-s.cm(xr + c));
        if (i >= 1) r = r + s.cF(ya + c);
        if (i < h) r = r + (-s.cm(yb + c));
        if (i < h && c < nx - 1) d = d + s.wm(xr + c);
        if (i < h && c >= 1) d = d + s.wm(xr + c - 1);
        if (i < h) d = d + s.wm(yb + c);
        if (i >= 1) d = d + s.wm(ya + c);
        const int u = cell_map[static_cast<size_t>(j) * cells + t];
        if (u >= 0) {
            const int* fold = st_fold + (static_cast<size_t>(j) * U + u) * Kc;
            const int* sb = st_sb + static_cast<size_t>(j) * st_len;
            double ar = 0.0, ad = 0.0;
            for (int k = 0; k < Kc; ++k) {
                const int q = fold[k];
                if (q < 0) break;
                const int e = base + q;
                const double v = sb[q] ? -s.cm(e) : s.cF(e);
                ar = k == 0 ? v : ar + v;
                ad = k == 0 ? s.wm(e) : ad + s.wm(e);
            }
            r = r + ar;
            d = d + ad;
        }
        row[t] = r;
        row[cells + t] = d;
    } else if (t < cells + r_dct) {
        const int g = static_cast<int>(t - cells);
        const int* fold = grp_fold + (static_cast<size_t>(j) * r_dct + g) * Kg;
        double a = 0.0;
        for (int k = 0; k < Kg; ++k) {
            const int q = fold[k];
            if (q < 0) break;
            a = k == 0 ? s.wm(base + q) : a + s.wm(base + q);
        }
        row[2 * cells + 2 + g] = a;
    } else if (t == cells + r_dct) {
        row[2 * cells] = j == first ? s.wm(0) : 0.0;
        row[2 * cells + 1] = j == first ? s.wm(h * (nx - 1)) : 0.0;
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

// The rows of S strips (tables and K1 planes stacked on a leading strip
// axis; strip `first` of them, or none for -1, writes wx, wy), one grid.
extern "C" int nxfx_shard_grid_window(
    int S, int h, int nx, int U, int Kc, int r_dct, int Kg, int E_loc, int st_len, int first,
    const double* w, const double* cst, const double* Ftot, const int* valid,
    const int* cell_map, const int* st_fold, const int* grp_fold, const int* st_sb,
    double* part, cudaStream_t stream)
{
    if (S < 0 || S > 65535 || h < 0 || nx < 1 || U < 0 || Kc < 0 || r_dct < 0 || Kg < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (S == 0) return 0;
    const long long cells = static_cast<long long>(h + 1) * nx;
    const dim3 grid(blocks_for(cells + r_dct + 1), S);
    grid_window_kernel<<<grid, THREADS, 0, stream>>>(
        h, nx, U, Kc, r_dct, Kg, E_loc, st_len, first, w, cst, Ftot, valid, cell_map, st_fold,
        grp_fold, st_sb, part);
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
