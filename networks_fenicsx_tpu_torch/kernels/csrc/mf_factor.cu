// K13 + K14: the factor of the tree multifrontal core elimination.
//
// Replaces networks_fenicsx_tpu/ops/multifrontal.py:_mf_factor with
// _consume_onehot (front assembly and extend-add, K14) and
// _chol_inv_small / chol_inverse_batched (the batched Cholesky, K13).
// A front of pivot width w and boundary width b (m = w + b) is an m x m
// block of the factor buffer:
//   F = pivot-row strips (values -w_pairs[init_slot], both triangles for the
//       boundary columns) + diag(dc[nodes]) on the pivots (1 on a padded pivot)
//   F[rel[a]][rel[c]] += U_child[a][c] for each consumed child group, in plan
//       order (rel, the inverse of the plan's lminv, skips the child's padding)
//   partial Cholesky of the first w columns, lower triangle:
//       F_SS = L L^T,  lower-left = Y^T with Y = L^-1 F_SB,  lower-right = U = F_BB - Y^T Y
//   ok = 0 when an entry of L is not finite; the pivot block's strict upper
//   triangle gets L^T (the apply reads both factors along rows), the rest
//   of the upper triangle is zeroed, and U (full) goes to the group's pool
//   for its parent.
// The reference keeps Li = L^-1 explicitly and forms X = Li^T Li F_SB, and
// assembles through one-hot matrix products, both for the TPU's matrix
// unit; here L and Y are kept and the apply (mf_apply.cu) solves triangles.
// The reference factors in float32 (float64 is emulated on the TPU) and
// refines in float64; here the factor is float64 and the refinement stays.
//
// Bound: on the web (52,571 core nodes, 3,326 fronts) the factor buffer's
// 49 MB, written once, take ~15 us at 3.35 TB/s and its ~148 M multiply-adds
// ~4 us at the float64 tensor-core peak; what costs is the chain of
// dependent fronts (14 levels) and, inside a front, of dependent columns.
// Design:
// - A level schedule (ops/multifrontal.py:mf_schedule): the fronts of one
//   dependency level run in one launch, or two where the level holds fronts
//   wider than WIDE_M (m > 160), so a factor is 1 + (levels + split levels)
//   launches (18 on the web) where it was 1 + one per group (95), and every
//   launch fills the card as far as its level has fronts.  A block reads its
//   (group, front) from the schedule's device table and the group's row
//   from a device copy of the group table.
// - The extend-add scatters each child's cb x cb block through rel, not
//   the parent's m x m block through lminv (15x fewer entry visits on the
//   web, no index division).  A warp owns a row of the front and takes, from
//   the row's work list (xadd: the children's rows that map to it, in plan
//   order), each child row's update along rel, a __syncwarp after each: no
//   barrier between children, and every entry takes its contributions in
//   plan order, so the assembled fronts are bit for bit those of the gather.
//   The factor reads only the lower triangle, so only it is assembled.
// - Every 32-column panel (both kinds of front below): the block factors
//   the diagonal block in shared memory, every step spread over its warps
//   (2 barriers a column; the reciprocal square root is the one operation
//   on the chain), and inverts it (Z = L^-1); the rows below are then one
//   product with Z on the float64 tensor cores (mma.sync m16n8k16,
//   dmma.cuh), as the reference's explicit inverse, and so is the trailing
//   update.  A panel's serial work is so 2 x 32 short steps, not a chain of
//   divisions a row.
// - A front with m <= WIDE_M is assembled and factored in one block's
//   shared memory (its lower triangle packed, <= 103 KB; <= 256 threads and
//   64 registers a thread, so that up to 4 fronts share an SM), written out
//   once.
// - A front with m > WIDE_M (13 on the web, all on the top levels) is one
//   cluster of CLUSTER CTAs on the front's block in device memory (L2): CTA
//   0 factors each panel and the panel is read by the others from L2
//   (ld.global.cg: it is written to the factor buffer once anyway, and no
//   CTA can leave while another reads its shared memory); the trailing
//   update is split in 16 x 32 units over the cluster's warps.  CTA 0
//   updates the next panel's columns itself and factors that panel while
//   the others update the rest, so the cluster synchronises once a panel.
// The factor buffer stays in device memory for the apply.  A buffer written
// by one thread and read by another after a barrier carries no __restrict__
// (with it the compiler may keep a value in a register across the barrier).
//
// S factors (a sweep's R batch on the tree route) take the launches of one:
// every launch of the level schedule takes the scenario as its grid's y
// (min(S, 65,535) rows walking the scenarios y, y + gridDim.y, ...; the wide
// fronts' clusters stay along x), each scenario with its own stride into
// the pair conductances, the peeled diagonal, vals, fac, the pools and ok.
// The scenario only selects base pointers: each factor is the one-scenario
// launch's bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;          // CTAs of a wide front (a portable cluster size)
constexpr int WIDE_THREADS = 512;   // threads of each of those CTAs
constexpr int NARROW_THREADS = 256;  // the most threads a narrow front's block takes
constexpr int NARROW_BLOCKS = 4;     // ... and the blocks an SM holds (64 registers a thread)

// columns of the group table and the level table
enum { G_K, G_W, G_B, G_C, G_NODES, G_CVAL, G_BNDPOS, G_LAM, G_FAC, G_POOL, G_VPOOL, G_CONS,
       G_NCONS, G_XADD, G_COLS };
enum { L_START, L_WIDE, L_COUNT, L_WIDE_M, L_NARROW_M, L_COLS };
enum { X_UROW, X_REL, X_CB, X_V, X_COLS };

struct FactorArgs {
    int n_core;
    int assemble_only;              // 1: write the assembled fronts and stop
    const long long* groups;        // (G, G_COLS) on the device
    const int* fronts;              // (n_fronts, 2): (group, front) by level
    const int* nodes_all;
    const int* cval_all;
    const int* ccol_all;
    const int* rel_all;
    const int* xadd_ptr;            // the extend-add's work lists by parent index
    const int* xadd;                // (n, X_COLS): a child row's offsets
    const double* vals;             // (P0 + 1,)
    const double* dc;               // (n_core,)
    const double* pools_in;         // the children's U pools, read
    double* fac;
    double* pools;                  // this factor's U pools, written
    int* ok;
    int S;                          // scenarios (1: one factor)
    long long s_dc, s_vals, s_pin, s_fac, s_pools, s_ok;  // their strides
};

// scenario z's arguments: each buffer its stride z further on
__device__ __forceinline__ FactorArgs scenario(const FactorArgs& A, int z)
{
    const size_t Z = static_cast<size_t>(z);
    FactorArgs a = A;
    a.dc = A.dc + Z * A.s_dc;
    a.vals = A.vals + Z * A.s_vals;
    a.pools_in = A.pools_in + Z * A.s_pin;
    a.fac = A.fac + Z * A.s_fac;
    a.pools = A.pools + Z * A.s_pools;
    a.ok = A.ok + Z * A.s_ok;
    return a;
}

struct FrontRef {
    const long long* row;  // the group's row of the group table
    int p, w, b, c, m;
};

__device__ __forceinline__ FrontRef front_ref(const FactorArgs& a, int f)
{
    FrontRef r;
    r.row = a.groups + static_cast<size_t>(a.fronts[2 * f]) * G_COLS;
    r.p = a.fronts[2 * f + 1];
    r.w = static_cast<int>(r.row[G_W]);
    r.b = static_cast<int>(r.row[G_B]);
    r.c = static_cast<int>(r.row[G_C]);
    r.m = r.w + r.b;
    return r;
}

// threads of a narrow front's block: a warp per 16 rows, 64 to NARROW_THREADS
inline int front_threads(int m)
{
    int t = 64;
    while (t < NARROW_THREADS && t * 16 < 32 * m) t *= 2;
    return t;
}

// offset of row i in a packed lower triangle
__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// scenario z's w_pairs s_wp z further on, its vals P0 + 1, its ok 1
__global__ void mf_values_kernel(
    int P0, const int* __restrict__ init_slot, const double* __restrict__ w_pairs,
    double* __restrict__ vals, int* __restrict__ ok, int S, long long s_wp)
{
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    for (int z = blockIdx.y; z < S; z += gridDim.y) {
        const size_t Z = static_cast<size_t>(z);
        double* v = vals + Z * (P0 + 1);
        if (p < P0) v[p] = -w_pairs[Z * s_wp + init_slot[p]];
        if (p == P0) {
            v[P0] = 0.0;
            ok[Z] = 1;
        }
    }
}

// Assemble the lower triangle of front fr's rows i = rank (mod nranks) (all
// rows: nranks = 1), at(i, j) (j <= i) the storage of entry (i, j), by the
// whole block: zero, the pivot-row strips, the diagonal; a barrier; then
// the extend-add, each row by the LANES lanes that own it (a warp's rows
// rank + nranks (warp + n_warps t), 32 / LANES at a time) from the row's
// work list (xadd: the children's rows that map to it, in plan order; rel
// maps their columns), a __syncwarp of those lanes after each, so every
// entry takes its children's updates in plan order with no barrier between
// children.  Ends with a barrier.
template <int LANES, typename At>
__device__ void assemble_front(const FactorArgs& a, const FrontRef& fr, int rank, int nranks, At at)
{
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
    const int w = fr.w, m = fr.m, c = fr.c, p = fr.p;
    const int first = rank + nranks * warp, stride = nranks * n_warps;
    for (int i = first; i < m; i += stride)
        for (int j = lane; j <= i; j += 32) at(i, j) = 0.0;
    __syncthreads();
    const int* cval = a.cval_all + fr.row[G_CVAL] + static_cast<size_t>(p) * w * c;
    const int* ccol = a.ccol_all + fr.row[G_CVAL] + static_cast<size_t>(p) * w * c;
    for (int t = tid; t < w * c; t += blockDim.x) {
        const int i = t / c;
        const int col = ccol[t];
        if (col < m) {  // the lower of each pair's two entries (a pivot pair is on both rows)
            if (col < i && i % nranks == rank) at(i, col) = a.vals[cval[t]];
            if (col >= w && col % nranks == rank) at(col, i) = a.vals[cval[t]];
        }
    }
    __syncthreads();
    const int* nodes = a.nodes_all + fr.row[G_NODES] + static_cast<size_t>(p) * w;
    for (int i = tid; i < w; i += blockDim.x) {
        if (i % nranks != rank) continue;
        const int node = nodes[i];
        at(i, i) = at(i, i) + (node < a.n_core ? a.dc[node] : 1.0);
    }
    __syncthreads();
    // 32 / LANES rows at a time a warp, LANES lanes a row: the rows' work
    // lists run side by side, their loads in flight together
    constexpr int ROWS = 32 / LANES;
    const int* xp = a.xadd_ptr + fr.row[G_XADD] + static_cast<size_t>(p) * m;
    const int sub = lane / LANES, sl = lane % LANES;
    const unsigned group = (LANES == 32 ? 0xffffffffu : (1u << LANES) - 1u) << (LANES * sub);
    for (int i0 = first; i0 < m; i0 += ROWS * stride) {
        const int i = i0 + sub * stride;
        if (i < m) {
            for (int t = xp[i]; t < xp[i + 1]; ++t) {
                const int* e = a.xadd + X_COLS * static_cast<size_t>(t);
                const double* U = a.pools_in + e[X_UROW];
                const int* rel = a.rel_all + e[X_REL];
                const int cb = e[X_CB];
                for (int q = sl; q < cb; q += LANES) {
                    const int j = rel[q];
                    if (j >= 0 && j <= i) at(i, j) = at(i, j) + U[q];
                }
                __syncwarp(group);
            }
        }
    }
    __syncthreads();
}

// Cholesky of the nb x nb (nb <= 32) diagonal block D (shared memory, row
// stride 33, lower triangle) in place, then Z = L^-1 (row stride 33, zero
// above the diagonal), by the whole block, every step spread over its
// warps (a warp a row, a lane a column).  Per column c: the pivot's
// reciprocal 1/sqrt(D[c][c]) (kept in rinv) and the column below it scaled
// by it; a barrier; the update D[r][q] -= D[r][c] D[q][c] (c < q <= r) and
// the pivot D[c][c]/sqrt(D[c][c]); a barrier: the unblocked right-looking
// steps.  Then per column c of L: row c of Z scaled by rinv[c], a barrier,
// Z[q][j] -= L[q][c] Z[c][j] (q > c, j <= c), a barrier.  Loops kept
// compact: unrolled, the steps would be thousands of instructions, streamed
// through the instruction cache by every block.
__device__ void diag_factor(double* D, double* rinv, double* Z, int nb)
{
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
    for (int c = 0; c < nb; ++c) {
        const double d = D[c * 33 + c];
        const double inv = rsqrt(d);  // one operation on the chain, not a root and a division
        if (tid > c && tid < nb) D[tid * 33 + c] = D[tid * 33 + c] * inv;
        if (tid == 0) rinv[c] = inv;
        __syncthreads();
        if (tid == 0) D[c * 33 + c] = d * inv;
        for (int r = c + 1 + warp; r < nb; r += n_warps)
            if (lane > c && lane <= r) D[r * 33 + lane] = D[r * 33 + lane] - D[r * 33 + c] * D[lane * 33 + c];
        __syncthreads();
    }
    for (int r = warp; r < nb; r += n_warps) Z[r * 33 + lane] = r == lane ? 1.0 : 0.0;
    __syncthreads();
    for (int c = 0; c < nb; ++c) {
        if (tid <= c) Z[c * 33 + tid] = Z[c * 33 + tid] * rinv[c];
        __syncthreads();
        for (int q = c + 1 + warp; q < nb; q += n_warps)
            if (lane <= c) Z[q * 33 + lane] = Z[q * 33 + lane] - D[q * 33 + c] * Z[c * 33 + lane];
        __syncthreads();
    }
}

// The panel's rows below its diagonal block: E[r][k0 + c] <- sum_k E[r][k0 +
// k] Z[c][k] (X = A L^-T) for r in [r_lo, m), c < nb, on the float64 tensor
// cores, a 16-row strip a warp (wi, wi + W, ...): the strip's A fragments
// are read before its results are written, so the product is in place.
// at(i, j) addresses entry (i, j), load(ptr) reads it.
template <typename At, typename Load>
__device__ void panel_rows(At at, Load load, const double* Z, int m, int k0, int nb, int r_lo,
                           int wi, int W)
{
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int steps = nb > 16 ? 2 : 1;
    for (int row0 = r_lo + 16 * wi; row0 < m; row0 += 16 * W) {
        double af[2][8];
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int r = row0 + g + 8 * (i % 2), kk = 16 * s + t + 4 * (i / 2);
                af[s][i] = (s < steps && r < m && kk < nb) ? load(at(r, k0 + kk)) : 0.0;
            }
        double d[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int i = 0; i < 4; ++i) d[q][i] = 0.0;
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                if (s >= steps) break;
                double bf[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int c = 8 * q + g, kk = 16 * s + t + 4 * i;
                    bf[i] = (c < nb && kk < nb) ? Z[c * 33 + kk] : 0.0;
                }
                tc_mma16x8x16(d[q], af[s], bf);
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = row0 + g + 8 * (i / 2), c = 8 * q + 2 * t + i % 2;
                if (r < m && c < nb) *at(r, k0 + c) = d[q][i];
            }
    }
}

// E[i][j] -= sum_{c < nb} E[i][k0 + c] E[j][k0 + c] for r_lo <= i < m and
// c_lo <= j < min(c_hi, i + 1) on the float64 tensor cores (mma.sync
// m16n8k16), in 16-row x 32-column units dealt to the warps wi, wi + W, ...;
// at(i, j) addresses entry (i, j) (j <= i), load(ptr) reads it.  KEEP_A
// holds a unit's row fragments for its four 8-column tiles (for a block in
// L2); without it they are read again a tile (from shared memory), so that
// the fragments take 32 registers and 4 blocks of 256 threads fit an SM.
template <bool KEEP_A, typename At, typename Load>
__device__ void tile_update(At at, Load load, int m, int k0, int nb, int r_lo, int c_lo, int c_hi,
                            int wi, int W)
{
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int S = (m - r_lo + 15) / 16, U = (c_hi - c_lo + 31) / 32;
    const int steps = nb > 16 ? 2 : 1;
    for (int unit = wi; unit < S * U; unit += W) {
        const int row0 = r_lo + 16 * (unit / U), col0 = c_lo + 32 * (unit % U);
        if (col0 > row0 + 15) continue;  // above the diagonal
        double ak[KEEP_A ? 2 : 1][8];
        const auto a_frag = [&](double* af, int s) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int r = row0 + g + 8 * (i % 2), kk = 16 * s + t + 4 * (i / 2);
                af[i] = (r < m && kk < nb) ? -load(at(r, k0 + kk)) : 0.0;
            }
        };
        if (KEEP_A) {
#pragma unroll
            for (int s = 0; s < 2; ++s)
                if (s < steps) a_frag(ak[KEEP_A ? s : 0], s);
        }
        for (int q = 0; q < 4; ++q) {
            const int cj = col0 + 8 * q;
            if (cj >= c_hi || cj > row0 + 15) break;
            double d[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = row0 + g + 8 * (i / 2), col = cj + 2 * t + i % 2;
                d[i] = (r < m && col < c_hi && col <= r) ? load(at(r, col)) : 0.0;
            }
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                if (s >= steps) break;
                double bf[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int col = cj + g, kk = 16 * s + t + 4 * i;
                    bf[i] = (col < c_hi && kk < nb) ? load(at(col, k0 + kk)) : 0.0;
                }
                if (!KEEP_A) a_frag(ak[0], s);
                tc_mma16x8x16(d, ak[KEEP_A ? s : 0], bf);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = row0 + g + 8 * (i / 2), col = cj + 2 * t + i % 2;
                if (r < m && col < c_hi && col <= r) *at(r, col) = d[i];
            }
        }
    }
}

// ---- narrow fronts (m <= WIDE_M): one block, the front's lower triangle
// packed in shared memory (row i at tri(i): the 16 rows of a half-warp's
// column reads hit 16 distinct bank pairs)

__device__ void narrow_front(const FactorArgs& a, int first, double* F, double* Ld, double* rinv, double* Z)
{
    const FrontRef fr = front_ref(a, first + blockIdx.x);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
    const int w = fr.w, b = fr.b, m = fr.m;
    double* out = a.fac + fr.row[G_FAC] + static_cast<size_t>(fr.p) * m * m;

    assemble_front<8>(a, fr, 0, 1, [F](int i, int j) -> double& { return F[tri(i) + j]; });
    if (a.assemble_only) {  // the assembled front is symmetric: its upper triangle mirrored
        for (int i = warp; i < m; i += n_warps)
            for (int j = lane; j < m; j += 32)
                out[static_cast<size_t>(i) * m + j] = j <= i ? F[tri(i) + j] : F[tri(j) + i];
        return;
    }
    for (int k0 = 0; k0 < w; k0 += 32) {
        const int nb = w - k0 < 32 ? w - k0 : 32;
        if (warp == 0)  // the diagonal block into Ld
            for (int c = 0; c <= lane && lane < nb; ++c) Ld[lane * 33 + c] = F[tri(k0 + lane) + k0 + c];
        __syncthreads();
        diag_factor(Ld, rinv, Z, nb);
        if (warp == 0)
            for (int c = 0; c <= lane && lane < nb; ++c) F[tri(k0 + lane) + k0 + c] = Ld[lane * 33 + c];
        const auto at = [F](int i, int j) { return F + tri(i) + j; };
        const auto load = [](const double* v) { return *v; };
        panel_rows(at, load, Z, m, k0, nb, k0 + nb, warp, n_warps);
        __syncthreads();
        tile_update<false>(at, load, m, k0, nb, k0 + nb, k0 + nb, m, warp, n_warps);  // the trailing lower triangle
        __syncthreads();
    }
    bool bad = false;  // write out: the gate on L, L^T above the pivot block, zeros above U and Y^T
    for (int i = warp; i < m; i += n_warps) {
        for (int j = lane; j < m; j += 32) {
            double v;
            if (j > i) {
                v = j >= w ? 0.0 : F[tri(j) + i];
            } else {
                v = F[tri(i) + j];
                if (i < w && !isfinite(v)) bad = true;
            }
            out[static_cast<size_t>(i) * m + j] = v;
        }
    }
    if (bad) a.ok[0] = 0;
    double* pool = a.pools + fr.row[G_POOL] + static_cast<size_t>(fr.p) * b * b;
    for (int i = warp; i < b; i += n_warps)
        for (int j = lane; j < b; j += 32) {
            const int hi = i > j ? i : j, lo = i > j ? j : i;
            pool[static_cast<size_t>(i) * b + j] = F[tri(w + hi) + w + lo];
        }
}

__global__ void __launch_bounds__(NARROW_THREADS, NARROW_BLOCKS) mf_front_kernel(FactorArgs a0, int first)
{
    extern __shared__ double F[];  // (tri(m),)
    __shared__ double Ld[32 * 33];  // the panel's factored diagonal block
    __shared__ double rinv[32];     // and its pivots' reciprocals
    __shared__ double Z[32 * 33];   // and its inverse
    for (int z = blockIdx.y; z < a0.S; z += gridDim.y) {  // a block a scenario's front
        narrow_front(scenario(a0, z), first, F, Ld, rinv, Z);
        __syncthreads();
    }
}

// ---- wide fronts (m > WIDE_M): a cluster of CLUSTER CTAs, the front in L2

__device__ __forceinline__ void cluster_sync_all()
{
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Factor panel columns [k0, k0 + nb) of the front F (m x m, in device
// memory), rows k0..m-1, by one CTA: the diagonal block in Ld (row stride
// 33; a row's loads in flight at once), its factor and inverse Z, then the
// rows below as a product with Z on the tensor cores.
__device__ void wide_panel(double* F, int m, int k0, int nb, double* Ld, double* rinv, double* Z)
{
    const int tid = threadIdx.x, lane = tid & 31;
    if (tid < 32) {
        const double* D = F + static_cast<size_t>(k0 + lane) * m + k0;
        double v[32];
#pragma unroll
        for (int c = 0; c < 32; ++c) v[c] = (c <= lane && lane < nb) ? __ldcg(D + c) : 0.0;
#pragma unroll
        for (int c = 0; c < 32; ++c)
            if (c <= lane && lane < nb) Ld[lane * 33 + c] = v[c];
    }
    __syncthreads();
    diag_factor(Ld, rinv, Z, nb);
    if (tid < 32)
        for (int c = 0; c <= lane && lane < nb; ++c)
            F[static_cast<size_t>(k0 + lane) * m + k0 + c] = Ld[lane * 33 + c];
    panel_rows([F, m](int i, int j) { return F + static_cast<size_t>(i) * m + j; },
               [](const double* v) { return __ldcg(v); }, Z, m, k0, nb, k0 + nb, tid >> 5,
               static_cast<int>(blockDim.x >> 5));
}

__device__ void wide_front(const FactorArgs& a, int first, int rank, double* Ld, double* rinv, double* Z)
{
    const FrontRef fr = front_ref(a, first + static_cast<int>(blockIdx.x) / CLUSTER);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
    const int w = fr.w, b = fr.b, m = fr.m;
    double* F = a.fac + fr.row[G_FAC] + static_cast<size_t>(fr.p) * m * m;

    assemble_front<32>(a, fr, rank, CLUSTER,
                   [F, m](int i, int j) -> double& { return F[static_cast<size_t>(i) * m + j]; });
    cluster_sync_all();
    if (a.assemble_only) {  // the assembled front is symmetric: its upper triangle mirrored
        for (int i = rank + CLUSTER * warp; i < m; i += CLUSTER * n_warps)
            for (int j = i + 1 + lane; j < m; j += 32)
                F[static_cast<size_t>(i) * m + j] = __ldcg(F + static_cast<size_t>(j) * m + i);
        return;
    }
    if (rank == 0) wide_panel(F, m, 0, w < 32 ? w : 32, Ld, rinv, Z);
    cluster_sync_all();
    const auto at = [F, m](int i, int j) { return F + static_cast<size_t>(i) * m + j; };
    const auto load = [](const double* v) { return __ldcg(v); };
    for (int k0 = 0; k0 < w; k0 += 32) {
        const int nb = w - k0 < 32 ? w - k0 : 32;
        const int t0 = k0 + nb;
        const int nb2 = w - t0 < 32 ? w - t0 : 32;  // the next panel's width (<= 0: none)
        if (nb2 > 0) {
            if (rank == 0) {  // the next panel's columns, then that panel
                tile_update<true>(at, load, m, k0, nb, t0, t0, t0 + nb2, warp, n_warps);
                __syncthreads();
                wide_panel(F, m, t0, nb2, Ld, rinv, Z);
            } else {
                tile_update<true>(at, load, m, k0, nb, t0 + nb2, t0 + nb2, m, (rank - 1) * n_warps + warp,
                            (CLUSTER - 1) * n_warps);
            }
        } else {
            tile_update<true>(at, load, m, k0, nb, t0, t0, m, rank * n_warps + warp, CLUSTER * n_warps);
        }
        cluster_sync_all();
    }
    bool bad = false;  // the rows of this CTA: the gate on L, L^T above the pivot block, zeros
    for (int i = rank + CLUSTER * warp; i < m; i += CLUSTER * n_warps) {
        for (int j = lane; j < m; j += 32) {
            if (j > i) F[static_cast<size_t>(i) * m + j] = j >= w ? 0.0 : __ldcg(F + static_cast<size_t>(j) * m + i);
            else if (i < w && !isfinite(__ldcg(F + static_cast<size_t>(i) * m + j))) bad = true;
        }
    }
    if (bad) a.ok[0] = 0;
    double* pool = a.pools + fr.row[G_POOL] + static_cast<size_t>(fr.p) * b * b;
    for (int i = rank + CLUSTER * warp; i < b; i += CLUSTER * n_warps)
        for (int j = lane; j < b; j += 32) {
            const int hi = i > j ? i : j, lo = i > j ? j : i;
            pool[static_cast<size_t>(i) * b + j] = __ldcg(F + static_cast<size_t>(w + hi) * m + w + lo);
        }
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(WIDE_THREADS)
    mf_wide_kernel(FactorArgs a0, int first)
{
    __shared__ double Ld[32 * 33];
    __shared__ double rinv[32];
    __shared__ double Z[32 * 33];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    for (int z = blockIdx.y; z < a0.S; z += gridDim.y) {  // a cluster a scenario's front
        wide_front(scenario(a0, z), first, rank, Ld, rinv, Z);
        cluster_sync_all();
    }
}

// Raise the dynamic shared memory of the kernels k1 (and k2) to bytes where
// that is beyond what was set on this device before (the default, 48 KB
// less the kernel's static shared memory, may be too little below 48 KB), so
// that a launch captured in a CUDA graph after a first call sets no attribute.
template <typename K1, typename K2>
cudaError_t allow_shared(int bytes, K1 k1, K2 k2)
{
    static int granted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev >= 64 || bytes <= granted[dev]) return err;
    err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && k2 != nullptr)
        err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) granted[dev] = bytes;
    return err;
}

}  // namespace

// levels: host (n_levels, L_COLS) table; groups, fronts: device tables.
// assemble_only: write each front's assembled block into fac (children read
// from pools_in) and stop.
namespace {

int mf_factor_launch(
    int n_levels, const long long* levels, int n_core, int P0, int assemble_only,
    const long long* groups, const int* fronts,
    const int* init_slot, const double* w_pairs, const double* dc,
    const int* nodes_all, const int* cval_all, const int* ccol_all,
    const int* rel_all, const int* xadd_ptr, const int* xadd,
    const double* pools_in, double* vals, double* fac, double* pools, int* ok,
    int S, long long s_wp, long long s_dc, long long s_fac, long long s_pools,
    cudaStream_t stream)
{
    cudaError_t err;
    if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned ys = S < 65535 ? S : 65535;
    mf_values_kernel<<<dim3((P0 + 1 + 255) / 256, ys), 256, 0, stream>>>(P0, init_slot, w_pairs, vals, ok, S,
                                                                          s_wp);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    long long narrow_max = 0;
    for (int l = 0; l < n_levels; ++l) {
        const long long mn = levels[static_cast<size_t>(l) * L_COLS + L_NARROW_M];
        narrow_max = mn > narrow_max ? mn : narrow_max;
    }
    const int shared_max = static_cast<int>(tri(static_cast<int>(narrow_max)) * sizeof(double));
    if ((err = allow_shared(shared_max, mf_front_kernel, nullptr)) != cudaSuccess)
        return static_cast<int>(err);

    FactorArgs a{n_core, assemble_only, groups, fronts, nodes_all, cval_all, ccol_all,
                 rel_all, xadd_ptr, xadd, vals, dc, pools_in, fac, pools, ok,
                 S, s_dc, P0 + 1, s_pools, s_fac, s_pools, 1};
    for (int l = 0; l < n_levels; ++l) {
        const long long* lv = levels + static_cast<size_t>(l) * L_COLS;
        const int start = static_cast<int>(lv[L_START]);
        const int wide = static_cast<int>(lv[L_WIDE]);
        const int narrow = static_cast<int>(lv[L_COUNT]) - wide;
        if (wide > 0) {
            mf_wide_kernel<<<dim3(wide * CLUSTER, ys), WIDE_THREADS, 0, stream>>>(a, start);
            if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
        }
        if (narrow > 0) {
            const int mn = static_cast<int>(lv[L_NARROW_M]);
            const size_t shared = static_cast<size_t>(tri(mn)) * sizeof(double);
            mf_front_kernel<<<dim3(narrow, ys), front_threads(mn), shared, stream>>>(a, start + wide);
            if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
        }
    }
    return 0;
}

}  // namespace

extern "C" int nxfx_mf_factor(
    int n_levels, const long long* levels, int n_core, int P0, int assemble_only,
    const long long* groups, const int* fronts,
    const int* init_slot, const double* w_pairs, const double* dc,
    const int* nodes_all, const int* cval_all, const int* ccol_all,
    const int* rel_all, const int* xadd_ptr, const int* xadd,
    const double* pools_in, double* vals, double* fac, double* pools, int* ok,
    cudaStream_t stream)
{
    return mf_factor_launch(n_levels, levels, n_core, P0, assemble_only, groups, fronts, init_slot, w_pairs, dc,
                            nodes_all, cval_all, ccol_all, rel_all, xadd_ptr, xadd, pools_in, vals, fac, pools, ok,
                            1, 0, 0, 0, 0, stream);
}

// S factors in one factor's launches: w_pairs rows s_wp apart (0: shared),
// dc rows s_dc apart (0: shared), vals (S, P0 + 1), fac (S, s_fac), pools
// (S, s_pools), ok (S,).
extern "C" int nxfx_mf_factor_scen(
    int n_levels, const long long* levels, int n_core, int P0, int S,
    const long long* groups, const int* fronts,
    const int* init_slot, long long s_wp, const double* w_pairs, long long s_dc, const double* dc,
    const int* nodes_all, const int* cval_all, const int* ccol_all,
    const int* rel_all, const int* xadd_ptr, const int* xadd,
    double* vals, long long s_fac, double* fac, long long s_pools, double* pools, int* ok,
    cudaStream_t stream)
{
    return mf_factor_launch(n_levels, levels, n_core, P0, 0, groups, fronts, init_slot, w_pairs, dc,
                            nodes_all, cval_all, ccol_all, rel_all, xadd_ptr, xadd, pools, vals, fac, pools, ok,
                            S, s_wp, s_dc, s_fac, s_pools, stream);
}
