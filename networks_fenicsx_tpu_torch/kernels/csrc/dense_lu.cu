// K21b: the float64 dense solve of the assembled saddle-point matrix — an
// LU factor with partial pivoting, its solve, and the triangular solves it
// is made of (also used on K11's Cholesky factor).
//
// Replaces networks_fenicsx_tpu/solver.py:_dense_solve_f64 (4763-4778):
// there an f32 LU with four f64 refinement passes works around the TPU's
// f32-only LU, and on the CPU the reference calls jnp.linalg.solve (LAPACK
// getrf + getrs).  Here the factor is float64 on the card, right-looking
// and blocked, on a row-major (n, n) matrix in place (n <= 8,192).
//
// The order of the arithmetic is the unblocked loop's.  The saddle matrix
// is full of equal +-1 entries and zero diagonals, so its pivots hang on
// exact ties, broken by LAPACK's idamax rule (the largest |a[i][k]|, the
// lowest row on ties; the first NaN).  Every element therefore goes through
// the same operations in the same order as in the loop
//   for k: pivot p; swap rows k, p; a[i][k] *= r = 1 / a[k][k];
//          a[i][j] = a[i][j] - a[i][k] a[k][j]  (product, then difference:
//          -fmad=false)
// and the pivots and the factor equal the plain version's bit for bit for
// any panel width.  Per outer panel [K0, K1) of NB = 64 columns:
//   1. panel_kernel factors inner panels [k0, k1) of w <= 64 columns over
//      rows k0..n-1 with the unblocked steps, on chip: a thread-block
//      cluster of CLUSTER CTAs holds the panel in shared memory, a slice of
//      rows each.  Per column each CTA reduces its best candidate and pushes
//      it with its row into every CTA's inbox (asynchronous stores to
//      distributed shared memory that count their bytes on the receiver's
//      mbarrier); each CTA waits on its own mbarrier, picks the winner and
//      applies the swap, the scale and the rank-1 update to its rows.  No
//      cluster barrier and no release fence inside the loop (either costs
//      more than a one-way push); inboxes and mbarriers are double-buffered
//      by column parity.
//      w is the widest that fits (w = 64 up to ~3,400 rows, else 32 or 16).
//   2. swap_u12_kernel applies the panel's row swaps to the other columns
//      (LAPACK's dlaswp, replayed in shared memory) and forward-substitutes
//      the panel's rows right of it, u[m][j] = a[m][j] - sum_{m' < m}
//      l[m][m'] u[m'][j] in ascending m' (U12), one warp a column.
//   3. trailing_kernel updates the trailing block tile by tile: each block
//      loads its 64 x 64 C tile once, stages L21 and U12 in shared memory
//      and applies the panel's rank-1 updates in ascending m.
// Inner panels (w < 64) run 2-3 on the outer panel's own columns; the outer
// panel then runs 2-3 on the rest with the full 64-column depth, with
// lookahead: the next panel's columns first, on a panel stream of the
// greatest priority that then factors the next panel, while the caller's
// stream updates the columns beyond (see nxfx_lu_factor).
//
// Bound: float64 operations, 2n^3/3 (67 TFLOP/s on the tensor cores).  The
// order forbids DMMA and fused multiply-adds: the trailing update runs at
// the DMUL + DSUB issue rate (~17 TFLOP/s, ~2.7 ms at n = 4,096); its bytes
// are n^3/(3 NB) x 16 (5.7 GB at n = 4,096).  The panels are latency-bound,
// one exchange between the cluster's CTAs a column, and set the pace: the
// lookahead hides the trailing updates behind them.  5-9 launches a
// 64-column panel instead of 3 a column.
//
// piv[k] is the row swapped with row k at step k (0-based).  The solve
// permutes b in shared memory, then two triangular solves.  A triangular
// solve runs one block per 64-row tile, taken in order from a ticket: a
// tile waits for the flags of the tiles before it, applies their columns to
// its rows through a coalesced 64 x 64 tile in shared memory (each x[i]
// updated in the column loop's order), solves its diagonal tile in one warp
// and publishes its x with a flag.  On A or on its transpose, with a unit
// or a stored diagonal: L and U of the LU factor, and a Cholesky factor C
// and C^T.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NB = 64;          // outer panel: the depth of the trailing update
constexpr int CLUSTER = 8;      // CTAs of a panel factor (a portable cluster size)
constexpr int PANEL_THREADS = 512;
constexpr int PANEL_WARPS = PANEL_THREADS / 32;
constexpr int PANEL_SMEM_MAX = 220 * 1024;
constexpr int REC = NB + 2;    // an inbox record: |a|, the row index, the row
constexpr int STAGE = 2 * CLUSTER * REC + 2 * NB;  // the inboxes and rows c, double-buffered
constexpr int TILE = 64;        // trailing and trsv tiles
constexpr int TRAIL_THREADS = 256;
constexpr int TRAIL_SMEM = 2 * NB * (TILE + 1) * 8;
constexpr int U12_THREADS = 256;
constexpr int U12_COLS = 8;  // one warp a column in U12
constexpr int U12_SMEM = (NB * (NB + 1) + 2 * NB * (U12_COLS + 1)) * 8;
constexpr int TRSV_THREADS = 256;
constexpr int TRSV_SMEM = 2 * TILE * (TILE + 1) * 8;
constexpr int PERMUTE_THREADS = 1024;

// the candidate (ov, oi) beats (mv, mi): larger |a|, the lower row on ties, the first NaN
__device__ __forceinline__ bool better(double ov, int oi, double mv, int mi)
{
    return (ov > mv) || (ov == mv && oi < mi) || (isnan(ov) && !isnan(mv))
           || (isnan(ov) && isnan(mv) && oi < mi);
}

// the warp's best candidate (v >= 0 or NaN, no candidate = (0, INT_MAX)) in
// every lane: the largest bits of |a| (NaN above +inf, as for idamax's first
// NaN), then the lowest row among the lanes that hold them
__device__ __forceinline__ void warp_best(double& v, int& i)
{
    const unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(v));
    const unsigned hi = static_cast<unsigned>(b >> 32), lo = static_cast<unsigned>(b);
    const unsigned mh = __reduce_max_sync(0xffffffffu, hi);
    const unsigned ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
    const bool top = hi == mh && lo == ml;
    i = __reduce_min_sync(0xffffffffu, top ? i : INT_MAX);
    v = __longlong_as_double(static_cast<long long>((static_cast<unsigned long long>(mh) << 32) | ml));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int rank)
{
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
    return remote;
}

// v into the shared memory of another CTA of the cluster (cluster address
// at), counted as 8 bytes on its mbarrier (cluster address bar) on arrival
__device__ __forceinline__ void push(uint32_t at, double v, uint32_t bar)
{
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
                 :: "r"(at), "l"(__double_as_longlong(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity)
{
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

// Columns [k0, k0 + w) over rows k0..n-1 (h = n - k0 rows, panel-relative
// index i): CTA q holds rows [q R, q R + R) column-major in s[c * Rs + li],
// thread t the rows li = t, t + PANEL_THREADS, ...  A column: each CTA
// reduces its candidate (a CTA barrier), then its warp r pushes the
// candidate, its row and (from row c's owner) row c into CTA r's inbox with
// asynchronous stores that count their bytes on CTA r's mbarrier (a second
// CTA barrier: the pushes have read the rows before they change); every
// CTA waits on its own mbarrier for the bytes of all CLUSTER pushes, picks
// the winner and updates its rows.  Inboxes and mbarriers are
// double-buffered by column parity: a CTA pushes into a buffer again only
// after every CTA has pushed the column in between, which it does after
// finishing the column that read the buffer.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(PANEL_THREADS)
panel_kernel(int n, int k0, int w, int R, int Rs, double* A, int* piv)
{
    cg::cluster_group cluster = cg::this_cluster();
    const int q = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    extern __shared__ double smem[];
    double* s = smem;
    double* inbox = s + static_cast<size_t>(w) * Rs;  // [2][CLUSTER][REC]: |a|, i, the row
    double* rowc = inbox + 2 * CLUSTER * REC;         // [2][NB] row c before the swap
    __shared__ double warp_v[PANEL_WARPS];
    __shared__ int warp_i[PANEL_WARPS];
    __shared__ unsigned long long full[2];  // the mbarriers of the two inbox buffers
    const unsigned bytes = static_cast<unsigned>((CLUSTER * (2 + w) + w) * 8);

    const int h = n - k0;
    const int base = q * R;
    const int rows = max(0, min(R, h - base));
    if (tid == 0) {
        for (int b = 0; b < 2; ++b) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&full[b])) : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int t = tid; t < rows * w; t += PANEL_THREADS) {
        const int li = t / w, c = t - li * w;
        s[c * Rs + li] = A[static_cast<long long>(k0 + base + li) * n + k0 + c];
    }
    cluster.sync();  // the mbarriers of every CTA initialised, the panel loaded
    // this thread's best candidate in column 0 (none: (0, INT_MAX), which
    // every row's |a| >= 0 beats or ties with a lower index)
    double bv = 0.0;
    int bi = INT_MAX;
    for (int li = tid; li < rows; li += PANEL_THREADS) {
        const double a = fabs(s[li]);
        if (better(a, base + li, bv, bi)) {
            bv = a;
            bi = base + li;
        }
    }
    for (int c = 0; c < w; ++c) {
        const int par = c & 1;
        const int owner_c = c / R, lc = c - owner_c * R;
        const uint32_t bar = smem_addr(&full[par]);
        if (tid == 0) asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                                   :: "r"(bar), "r"(bytes) : "memory");
        warp_best(bv, bi);
        if (lane == 0) {
            warp_v[warp] = bv;
            warp_i[warp] = bi;
        }
        __syncthreads();
        if (warp < CLUSTER) {  // warp r pushes this CTA's candidate to CTA r
            bv = lane < PANEL_WARPS ? warp_v[lane] : 0.0;
            bi = lane < PANEL_WARPS ? warp_i[lane] : INT_MAX;
            warp_best(bv, bi);
            const uint32_t rbar = cluster_addr(bar, warp);
            const uint32_t rec = cluster_addr(smem_addr(inbox + (par * CLUSTER + q) * REC), warp);
            if (lane == 0) push(rec, bv, rbar);
            if (lane == 1) push(rec + 8, static_cast<double>(bi), rbar);
            for (int j = lane; j < w; j += 32) {
                push(rec + 8 * (2 + j), bi != INT_MAX ? s[j * Rs + (bi - base)] : 0.0, rbar);
            }
            if (q == owner_c) {
                const uint32_t rc = cluster_addr(smem_addr(rowc + par * NB), warp);
                for (int j = lane; j < w; j += 32) push(rc + 8 * j, s[j * Rs + lc], rbar);
            }
        }
        __syncthreads();  // the pushes have read this CTA's rows before any thread updates them
        wait_phase(bar, (c >> 1) & 1);
        // the pivot: the best of the CLUSTER candidates, reduced in every warp
        double pv = 0.0;
        int p = INT_MAX;
        if (lane < CLUSTER) {
            pv = inbox[(par * CLUSTER + lane) * REC];
            p = static_cast<int>(inbox[(par * CLUSTER + lane) * REC + 1]);
        }
        const int mine = p;
        warp_best(pv, p);
        const int winner = __ffs(__ballot_sync(0xffffffffu, lane < CLUSTER && mine == p)) - 1;
        const double* urow = inbox + (par * CLUSTER + winner) * REC + 2;
        const double* krow = rowc + par * NB;
        const int owner_p = p / R, lp = p - owner_p * R;
        const bool swapped = p != c;
        if (q == 0 && tid == 0) piv[k0 + c] = k0 + p;
        // the swap, the scale and the rank-1 update of this thread's rows,
        // and its best candidate of the next column
        bv = 0.0;
        bi = INT_MAX;
        if (q == owner_c && swapped && lc % PANEL_THREADS == tid) {
            for (int j = 0; j < w; ++j) s[j * Rs + lc] = urow[j];
        }
        if (c + 1 < h) {
            const double r = 1.0 / urow[c];
            int li = max(0, c + 1 - base);
            li += (tid - li % PANEL_THREADS + PANEL_THREADS) % PANEL_THREADS;  // this thread's first row
            for (; li < rows; li += PANEL_THREADS) {
                double* row = s + li;
                if (swapped && q == owner_p && li == lp) {  // row p takes the old row c
                    for (int j = 0; j < w; ++j) row[j * Rs] = krow[j];
                }
                const double l = row[c * Rs] * r;
                row[c * Rs] = l;
                double* at = row + (c + 1) * Rs;
                const double* u = urow + c + 1;
                int m = w - c - 1;
                if (m > 0) {
                    const double v = at[0] - l * u[0];
                    at[0] = v;
                    const double av = fabs(v);
                    if (better(av, base + li, bv, bi)) {
                        bv = av;
                        bi = base + li;
                    }
                    at += Rs;
                    ++u;
                    --m;
                }
                for (; m >= 4; m -= 4, at += 4 * Rs, u += 4) {
                    const double x0 = at[0], x1 = at[Rs], x2 = at[2 * Rs], x3 = at[3 * Rs];
                    at[0] = x0 - l * u[0];
                    at[Rs] = x1 - l * u[1];
                    at[2 * Rs] = x2 - l * u[2];
                    at[3 * Rs] = x3 - l * u[3];
                }
                for (; m > 0; --m, at += Rs, ++u) at[0] = at[0] - l * u[0];
            }
        }
    }
    __syncthreads();
    for (int t = tid; t < rows * w; t += PANEL_THREADS) {
        const int li = t / w, c = t - li * w;
        A[static_cast<long long>(k0 + base + li) * n + k0 + c] = s[c * Rs + li];
    }
    cluster.sync();  // no CTA leaves while another may still push into it
}

// The swaps of the panel [p0, p1) on the columns [a0, a1) and [b0, b1),
// then on [b0, b1) the forward substitution of rows p0..p1-1 (U12).
// Blocks of U12_COLS columns: the first ceil((a1 - a0) / U12_COLS) over [a0, a1).
// The swaps run in shared memory: the block loads rows p0..p1-1 (T) and
// each row beyond them that a swap names once (O, indexed by the first swap
// naming it), one thread a column replays the swaps in order, and both
// go back to A: no chain of dependent device-memory accesses.
__global__ void __launch_bounds__(U12_THREADS)
swap_u12_kernel(int n, int p0, int p1, int a0, int a1, int b0, int b1, double* A, const int* piv)
{
    extern __shared__ double usm[];
    auto Lt = reinterpret_cast<double (*)[NB + 1]>(usm);                       // Lt[m'][m] = l(p0 + m, p0 + m')
    auto T = reinterpret_cast<double (*)[U12_COLS + 1]>(usm + NB * (NB + 1));  // rows p0..p1-1
    auto O = T + NB;                                                            // rows beyond, by first swap
    __shared__ int pv[NB], first[NB];
    const int w = p1 - p0;
    const int blocks_a = (a1 - a0 + U12_COLS - 1) / U12_COLS;
    const bool u12 = static_cast<int>(blockIdx.x) >= blocks_a;
    const int j0 = u12 ? b0 + (blockIdx.x - blocks_a) * U12_COLS : a0 + blockIdx.x * U12_COLS;
    const int cols = min(U12_COLS, (u12 ? b1 : a1) - j0);
    const int tid = threadIdx.x;
    if (tid < w) pv[tid] = piv[p0 + tid];
    for (int t = tid; t < w * U12_COLS; t += U12_THREADS) {
        const int m = t / U12_COLS, jj = t - m * U12_COLS;
        if (jj < cols) T[m][jj] = A[static_cast<long long>(p0 + m) * n + j0 + jj];
    }
    if (u12) {
        for (int t = tid; t < w * w; t += U12_THREADS) {
            const int m = t / w, mp = t - m * w;
            Lt[mp][m] = A[static_cast<long long>(p0 + m) * n + p0 + mp];
        }
    }
    __syncthreads();
    if (tid < w) {
        const int p = pv[tid];
        int f = -1;  // a row in the panel
        if (p >= p1) {
            f = tid;
            for (int k = 0; k < tid; ++k) {
                if (pv[k] == p) {
                    f = k;
                    break;
                }
            }
        }
        first[tid] = f;
    }
    __syncthreads();
    for (int t = tid; t < w * U12_COLS; t += U12_THREADS) {
        const int k = t / U12_COLS, jj = t - k * U12_COLS;
        if (jj < cols && first[k] == k) O[k][jj] = A[static_cast<long long>(pv[k]) * n + j0 + jj];
    }
    __syncthreads();
    if (tid < cols) {
        for (int k = 0; k < w; ++k) {
            const int p = pv[k];
            double* other = first[k] < 0 ? &T[p - p0][tid] : &O[first[k]][tid];
            const double t = T[k][tid];
            T[k][tid] = *other;
            *other = t;
        }
    }
    __syncthreads();
    for (int t = tid; t < w * U12_COLS; t += U12_THREADS) {
        const int k = t / U12_COLS, jj = t - k * U12_COLS;
        if (jj < cols && first[k] == k) A[static_cast<long long>(pv[k]) * n + j0 + jj] = O[k][jj];
    }
    if (u12) {
        const int lane = tid & 31, warp = tid >> 5;
        for (int jj = warp; jj < cols; jj += U12_THREADS / 32) {
            double v0 = lane < w ? T[lane][jj] : 0.0;
            double v1 = lane + 32 < w ? T[lane + 32][jj] : 0.0;
            for (int mp = 0; mp < w - 1; ++mp) {
                const double u = __shfl_sync(0xffffffffu, mp < 32 ? v0 : v1, mp & 31);
                if (lane > mp && lane < w) v0 = v0 - Lt[mp][lane] * u;
                if (lane + 32 > mp && lane + 32 < w) v1 = v1 - Lt[mp][lane + 32] * u;
            }
            if (lane < w) T[lane][jj] = v0;
            if (lane + 32 < w) T[lane + 32][jj] = v1;
        }
        __syncthreads();
    }
    for (int t = tid; t < w * U12_COLS; t += U12_THREADS) {
        const int m = t / U12_COLS, jj = t - m * U12_COLS;
        if (jj < cols) A[static_cast<long long>(p0 + m) * n + j0 + jj] = T[m][jj];
    }
}

// a[i][j] -= sum_{m = p0}^{p1-1} a[i][m] a[m][j] in ascending m (product,
// then difference) for i >= r0, j in [c0, c1): one 64 x 64 tile a block,
// 4 x 4 elements a thread at a stride of 16 rows and 16 columns.
__global__ void __launch_bounds__(TRAIL_THREADS)
trailing_kernel(int n, int p0, int p1, int r0, int c0, int c1, double* A)
{
    extern __shared__ double tsm[];
    double* Ls = tsm;                      // Ls[m * (TILE + 1) + ii] = a[i0 + ii][p0 + m]
    double* Us = tsm + NB * (TILE + 1);    // Us[m * (TILE + 1) + jj] = a[p0 + m][j0 + jj]
    const int w = p1 - p0;
    const int i0 = r0 + blockIdx.y * TILE, j0 = c0 + blockIdx.x * TILE;
    const int tid = threadIdx.x;
    for (int t = tid; t < TILE * w; t += TRAIL_THREADS) {
        const int ii = t / w, m = t - ii * w;
        Ls[m * (TILE + 1) + ii] = i0 + ii < n ? A[static_cast<long long>(i0 + ii) * n + p0 + m] : 0.0;
    }
    for (int t = tid; t < TILE * w; t += TRAIL_THREADS) {
        const int m = t / TILE, jj = t - m * TILE;
        Us[m * (TILE + 1) + jj] = j0 + jj < c1 ? A[static_cast<long long>(p0 + m) * n + j0 + jj] : 0.0;
    }
    const int tx = tid & 15, ty = tid >> 4;
    double acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
            acc[r][c] = (i < n && j < c1) ? A[static_cast<long long>(i) * n + j] : 0.0;
        }
    }
    __syncthreads();
#pragma unroll 4
    for (int m = 0; m < w; ++m) {
        double a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Ls[m * (TILE + 1) + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = Us[m * (TILE + 1) + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = acc[r][c] - a[r] * b[c];
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
            if (i < n && j < c1) A[static_cast<long long>(i) * n + j] = acc[r][c];
        }
    }
}

// x[i] = b[perm[i]], perm the swaps of piv applied in order to the identity
// (one thread walks the swaps in shared memory)
__global__ void __launch_bounds__(PERMUTE_THREADS) permute_kernel(int n, const int* piv, const double* b, double* x)
{
    extern __shared__ int psm[];
    int* perm = psm;
    int* pv = psm + n;
    for (int i = threadIdx.x; i < n; i += PERMUTE_THREADS) {
        perm[i] = i;
        pv[i] = piv[i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int k = 0; k < n; ++k) {
            const int p = pv[k];
            if (p != k) {
                const int t = perm[k];
                perm[k] = perm[p];
                perm[p] = t;
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += PERMUTE_THREADS) x[i] = b[perm[i]];
}

// a(i, c) = trans ? A[c][i] : A[i][c]: its 64 x 64 tile at rows r0.., columns c0..
// into At[ii][cc], coalesced along A's rows either way
__device__ __forceinline__ void load_tile(const double* A, int n, int trans, int r0, int c0,
                                          double (*At)[TILE + 1])
{
    for (int t = threadIdx.x; t < TILE * TILE; t += TRSV_THREADS) {
        const int hi = t / TILE, lo = t - hi * TILE;  // lo runs along A's row
        const int ii = trans ? lo : hi, cc = trans ? hi : lo;
        const int i = r0 + ii, c = c0 + cc;
        double v = 0.0;
        if (i < n && c < n) v = trans ? A[static_cast<long long>(c) * n + i] : A[static_cast<long long>(i) * n + c];
        At[ii][cc] = v;
    }
}

// x = op(T)^-1 x in place; sync[0] the ticket, sync[1 + b] tile b's flag
// (zeroed).  The A tiles are loaded before the flag they wait for.
__global__ void __launch_bounds__(TRSV_THREADS)
trsv_kernel(int n, const double* A, int lower, int trans, int unit, double* x, int* sync)
{
    extern __shared__ double trsv_sm[];
    auto At = reinterpret_cast<double (*)[TILE + 1]>(trsv_sm);                     // a dependency tile
    auto Ad = reinterpret_cast<double (*)[TILE + 1]>(trsv_sm + TILE * (TILE + 1));  // the diagonal tile
    __shared__ double xs[TILE];
    __shared__ int s_ticket;
    const int tiles = (n + TILE - 1) / TILE;
    const bool forward = (lower != 0) != (trans != 0);
    const int tid = threadIdx.x, lane = tid & 31;
    if (tid == 0) s_ticket = atomicAdd(sync, 1);
    __syncthreads();
    const int b = forward ? s_ticket : tiles - 1 - s_ticket;
    const int r0 = b * TILE;
    const int h = min(TILE, n - r0);
    load_tile(A, n, trans, r0, r0, Ad);
    double xm = (tid < h) ? x[r0 + tid] : 0.0;
    const int deps = forward ? b : tiles - 1 - b;
    for (int s = 0; s < deps; ++s) {
        const int t = forward ? s : tiles - 1 - s;  // the tiles before this one, in the column loop's order
        const int c0 = t * TILE;
        load_tile(A, n, trans, r0, c0, At);
        if (tid == 0) {
            while (atomicAdd(sync + 1 + t, 0) == 0) {
            }
            __threadfence();
        }
        __syncthreads();
        if (tid < TILE) xs[tid] = c0 + tid < n ? __ldcg(x + c0 + tid) : 0.0;
        __syncthreads();
        if (tid < h) {
            if (forward) {
                for (int cc = 0; cc < TILE && c0 + cc < n; ++cc) xm = xm - At[tid][cc] * xs[cc];
            } else {
                for (int cc = min(TILE, n - c0) - 1; cc >= 0; --cc) xm = xm - At[tid][cc] * xs[cc];
            }
        }
        __syncthreads();
    }
    // the diagonal tile, column by column in one warp (rows lane and lane + 32)
    if (tid < h) xs[tid] = xm;
    __syncthreads();
    if (tid < 32) {
        double v0 = lane < h ? xs[lane] : 0.0;
        double v1 = lane + 32 < h ? xs[lane + 32] : 0.0;
        for (int s = 0; s < h; ++s) {
            const int c = forward ? s : h - 1 - s;
            if (!unit) {
                if (c < 32) {
                    if (lane == c) v0 = v0 / Ad[c][c];
                } else if (lane + 32 == c) {
                    v1 = v1 / Ad[c][c];
                }
            }
            const double xc = __shfl_sync(0xffffffffu, c < 32 ? v0 : v1, c & 31);
            if (forward) {
                if (lane > c && lane < h) v0 = v0 - Ad[lane][c] * xc;
                if (lane + 32 > c && lane + 32 < h) v1 = v1 - Ad[lane + 32][c] * xc;
            } else {
                if (lane < c) v0 = v0 - Ad[lane][c] * xc;
                if (lane + 32 < c) v1 = v1 - Ad[lane + 32][c] * xc;
            }
        }
        if (lane < h) x[r0 + lane] = v0;
        if (lane + 32 < h) x[r0 + lane + 32] = v1;
        __threadfence();
    }
    __syncthreads();
    if (tid == 0) atomicExch(sync + 1 + b, 1);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

int panel_smem(int h, int w, int* R, int* Rs)
{
    *R = (h + CLUSTER - 1) / CLUSTER;
    *Rs = *R | 1;  // odd: the row loads and the column reads both miss bank conflicts
    return (*Rs * w + STAGE) * 8;
}

int launch_trsv(int n, const double* A, int lower, int trans, int unit, double* x, int* sync,
                cudaStream_t stream)
{
    const int tiles = (n + TILE - 1) / TILE;
    int code = static_cast<int>(
        cudaFuncSetAttribute(trsv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TRSV_SMEM));
    if (code == 0) code = static_cast<int>(cudaMemsetAsync(sync, 0, sizeof(int) * (1 + tiles), stream));
    if (code != 0) return code;
    trsv_kernel<<<tiles, TRSV_THREADS, TRSV_SMEM, stream>>>(n, A, lower, trans, unit, x, sync);
    return last_error();
}


// the panel stream of a device (the greatest priority, so that the panel's
// cluster gets its SMs as soon as they free up, ahead of the queued blocks
// of a trailing update) and three events that order it with the caller's
// stream, created at the first factor on that device
struct PanelStream {
    cudaStream_t stream = nullptr;
    cudaEvent_t start = nullptr, panel = nullptr, bulk = nullptr;
};

int panel_stream_of_device(PanelStream** out)
{
    static PanelStream streams[64];
    int dev = 0;
    int code = static_cast<int>(cudaGetDevice(&dev));
    if (code != 0 || dev < 0 || dev >= 64) return code != 0 ? code : static_cast<int>(cudaErrorInvalidDevice);
    PanelStream& ps = streams[dev];
    if (ps.stream == nullptr) {
        int least = 0, greatest = 0;
        code = static_cast<int>(cudaDeviceGetStreamPriorityRange(&least, &greatest));
        if (code == 0) {
            code = static_cast<int>(cudaStreamCreateWithPriority(&ps.stream, cudaStreamNonBlocking, greatest));
        }
        for (cudaEvent_t* ev : {&ps.start, &ps.panel, &ps.bulk}) {
            if (code == 0) code = static_cast<int>(cudaEventCreateWithFlags(ev, cudaEventDisableTiming));
        }
        if (code != 0) return code;
    }
    *out = &ps;
    return 0;
}

}  // namespace

// A: (n, n) row-major, factored in place into unit-lower L and U; piv: (n,);
// *launched (a host int, may be null) gets the kernel launches made.
// Lookahead: a panel stream factors outer panel K and applies it to the
// next panel's columns, then factors that panel, while the caller's stream
// applies panel K to the columns beyond and its swaps to the columns
// before; the panel stream waits for that bulk work before it updates the
// panel after, and the caller's stream waits for the panel stream at the end.
extern "C" int nxfx_lu_factor(int n, double* A, int* piv, int* launched, cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    int code = static_cast<int>(
        cudaFuncSetAttribute(panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PANEL_SMEM_MAX));
    if (code == 0) {
        code = static_cast<int>(
            cudaFuncSetAttribute(trailing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TRAIL_SMEM));
    }
    if (code == 0) {
        code = static_cast<int>(
            cudaFuncSetAttribute(swap_u12_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, U12_SMEM));
    }
    PanelStream* ps = nullptr;
    if (code == 0) code = panel_stream_of_device(&ps);
    if (code == 0) code = static_cast<int>(cudaEventRecord(ps->start, stream));
    if (code == 0) code = static_cast<int>(cudaStreamWaitEvent(ps->stream, ps->start, 0));
    if (code != 0) return code;
    const cudaStream_t hi = ps->stream;
    int count = 0;
    // the swaps of the panel [p0, p1) on [a0, a1) and [b0, b1); U12 and the update on [b0, b1)
    auto apply = [&](cudaStream_t st, int p0, int p1, int a0, int a1, int b0, int b1) {
        const int blocks = (a1 - a0 + U12_COLS - 1) / U12_COLS + (b1 - b0 + U12_COLS - 1) / U12_COLS;
        if (blocks > 0) {
            swap_u12_kernel<<<blocks, U12_THREADS, U12_SMEM, st>>>(n, p0, p1, a0, a1, b0, b1, A, piv);
            ++count;
        }
        if (b1 > b0 && p1 < n) {
            const dim3 grid((b1 - b0 + TILE - 1) / TILE, (n - p1 + TILE - 1) / TILE);
            trailing_kernel<<<grid, TRAIL_THREADS, TRAIL_SMEM, st>>>(n, p0, p1, p1, b0, b1, A);
            ++count;
        }
    };
    bool bulk_pending = false;
    for (int K0 = 0; K0 < n; K0 += NB) {
        const int K1 = K0 + NB < n ? K0 + NB : n;
        const int K2 = K1 + NB < n ? K1 + NB : n;
        for (int k0 = K0; k0 < K1;) {
            int R = 0, Rs = 0, w = K1 - k0;
            while (w > 1 && panel_smem(n - k0, w, &R, &Rs) > PANEL_SMEM_MAX) w = (w + 1) / 2;
            const int bytes = panel_smem(n - k0, w, &R, &Rs);
            if (bytes > PANEL_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
            const int k1 = k0 + w;
            panel_kernel<<<CLUSTER, PANEL_THREADS, bytes, hi>>>(n, k0, w, R, Rs, A, piv);
            ++count;
            apply(hi, k0, k1, K0, k0, k1, K1);  // within the outer panel
            k0 = k1;
        }
        if (bulk_pending) code = static_cast<int>(cudaStreamWaitEvent(hi, ps->bulk, 0));
        if (code == 0 && K1 < n) {
            code = static_cast<int>(cudaEventRecord(ps->panel, hi));
            if (code == 0) code = static_cast<int>(cudaStreamWaitEvent(stream, ps->panel, 0));
            if (code == 0) {
                apply(stream, K0, K1, 0, K0, K2, n);  // the columns before and beyond
                code = static_cast<int>(cudaEventRecord(ps->bulk, stream));
                bulk_pending = true;
            }
            apply(hi, K0, K1, 0, 0, K1, K2);  // the next panel's columns
        } else if (code == 0) {
            apply(hi, K0, K1, 0, K0, K1, n);  // the last panel: its swaps on the columns before
        }
        if (code == 0) code = last_error();
        if (code != 0) return code;
    }
    code = static_cast<int>(cudaEventRecord(ps->panel, hi));
    if (code == 0) code = static_cast<int>(cudaStreamWaitEvent(stream, ps->panel, 0));
    if (code != 0) return code;
    if (launched != nullptr) *launched = count;
    return 0;
}

// x = A^-1 b from the factor and pivots of nxfx_lu_factor (x may not alias b);
// sync: 2 (1 + ceil(n / 64)) ints of scratch
extern "C" int nxfx_lu_solve(int n, const double* LU, const int* piv, const double* b, double* x,
                             int* sync, cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = static_cast<int>(2 * sizeof(int)) * n;
    int code = static_cast<int>(
        cudaFuncSetAttribute(permute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    if (code != 0) return code;
    permute_kernel<<<1, PERMUTE_THREADS, bytes, stream>>>(n, piv, b, x);
    code = last_error();
    if (code != 0) return code;
    const int tiles = (n + TILE - 1) / TILE;
    const int c1 = launch_trsv(n, LU, 1, 0, 1, x, sync, stream);
    if (c1 != 0) return c1;
    return launch_trsv(n, LU, 0, 0, 0, x, sync + 1 + tiles, stream);
}

// x = op(T)^-1 x in place, T the lower (lower = 1) or upper triangle of A,
// op the transpose when trans = 1, unit diagonal when unit = 1; sync:
// 1 + ceil(n / 64) ints of scratch
extern "C" int nxfx_trsv(int n, const double* A, int lower, int trans, int unit, double* x, int* sync,
                         cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_trsv(n, A, lower, trans, unit, x, sync, stream);
}
