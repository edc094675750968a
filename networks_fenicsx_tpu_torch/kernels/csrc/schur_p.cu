// K21a: the per-edge flux blocks of the continuous-pressure reduced solve —
// their banded Cholesky factor and the solves A^-1 v, over flux-ordered tiles.
//
// Replaces the A_blocks assembly, jnp.linalg.cholesky and apply_Ainv of
// networks_fenicsx_tpu/solver.py:_continuous_pressure_solve (4666-4685,
// 4718-4724).  The flux block of an edge is the sum of its N overlapping
// (k+1)^2 cell masses: an (m, m) SPD matrix, m = kN + 1, banded with half
// bandwidth k.  The reference factors it dense, (E, m, m); the Cholesky
// factor of a band matrix keeps the band, so here it is stored as the band.
//
// Layout.  The global flux vector is the reference's: edges sorted by
// (color, id) — flux slot s holds edge perm[s] — each edge's m dofs
// contiguous, so the vector is an (E, m) row-major matrix.  Slots are cut
// into tiles of TILE = 32 edges (the last one ragged, padded with identity
// blocks), one warp lane an edge, and the band is stored tile-major:
//   Lb[((t m + i) (k+1) + d) TILE + lane] = L(i, i - d) of slot t TILE + lane,
// d = 0 holding the reciprocal pivot 1 / L(i, i), so that a solve multiplies
// where the chain would otherwise wait on a float64 division.  One tile's
// band is one contiguous run (62 KB at k = 2, N = 40), a row of it 32
// neighbouring doubles: every band access of a warp is coalesced.
//
// factor  one warp a tile.  The cell masses (E N, k+1, k+1) are in edge-id
//         order, each edge's run contiguous: the warp stages J cells of its
//         32 edges at a time in shared memory, one edge's run after the
//         other (coalesced), then each lane forms its band rows from them
//         (a node shared by two cells gets M_{j-1}[k][k] + M_j[0][0], cells
//         in order), writes the diagonal into a staging row of adiag, and
//         runs the band Cholesky on a ring of its last k+1 rows in shared
//         memory, row by row:
//           L(i, j) = (A(i, j) - sum_{t<j} L(i, t) L(j, t)) / L(j, j), j = i-k..i-1,
//           L(i, i) = sqrt(A(i, i) - sum_{t<i} L(i, t)^2),
//         the sums in ascending t, the division a product with the stored
//         reciprocal.  Rows leave as coalesced band rows; adiag (the flux
//         block's diagonal in flux order, the reference's A_diag) leaves
//         from its staging rows as contiguous runs.
// solve   a staged pipeline, one block (a solving warp and a staging warp)
//         a tile.  The staging warp puts the tile's v — T m contiguous
//         doubles — and its band, in stages of STAGE_ROWS rows, in flight at
//         once by cp.async.bulk (1-D TMA), each completing on its own
//         mbarrier; the solving warp runs the forward sweep L y = v as the
//         stages land, keeps y on chip in place of v, runs L^T x = y on the
//         band still in shared memory (no second read of it from device
//         memory), and the staging warp writes x out as one bulk store.  A
//         ragged tile or an unaligned vector is moved by coalesced loads and
//         stores instead.  For k <= 4 the last k values of each sweep stay
//         in registers (the chain is then a multiply, a subtract and a
//         multiply a term); other k read them back from shared memory.
//         A tile whose band and vector do not fit in shared memory (m (k+2)
//         256 B above ~227 KB, N > 110 at k = 2) is solved from device
//         memory in place in out, in the same order.
//         Shared-memory banks: the band is lane-fastest (conflict-free);
//         the vector keeps its global stride m a lane, conflict-free for
//         odd m (m = 81 on the main path) and two-way for even m.
//
// Both sweeps add their terms in ascending column order, as the plain
// versions do (kernels/schur_p.py), which run the same loops over the same
// layout.
//
// Bound: device-memory bytes — a factor reads the cell masses and writes
// the band and the diagonal once; a solve reads the band and v and writes
// out once (212 MB at the 16-generation P2/P1 tree: 0.0634 ms at 3.35 TB/s).

#include <cuda_runtime.h>

#include "dmma.cuh"

namespace {

constexpr int TILE = 32;
constexpr int STAGE_ROWS = 8;
constexpr int MAX_SMEM = 232448;        // what one block may take on an H100
constexpr int FACTOR_SMEM = 48 * 1024;  // the factor's budget for its cell stages
constexpr int MAX_CELLS = 8;            // cells a factor stage holds, at most

__host__ __device__ int odd(int n) { return n | 1; }

// the factor's staging strides (doubles) and shared memory for J cells a stage
__host__ __device__ int factor_cstride(int k, int J) { return odd((J + 1) * (k + 1) * (k + 1)); }
__host__ __device__ int factor_astride(int k, int J) { return odd(k * J + 2); }
__host__ __device__ int factor_smem(int k, int J)
{
    return 8 * TILE * (factor_cstride(k, J) + (k + 1) * (k + 1) + factor_astride(k, J));
}

__global__ void __launch_bounds__(TILE) factor_kernel(int E, int N, int k, int J, const double* cm,
                                                      const int* __restrict__ perm, double* Lb,
                                                      double* adiag)
{
    extern __shared__ double fsm[];
    const int tile = blockIdx.x, lane = threadIdx.x;
    const int kk = k + 1, kk2 = kk * kk, m = k * N + 1;
    const int cstr = factor_cstride(k, J), astr = factor_astride(k, J);
    double* cms = fsm;                    // [edge][cell][a][b], edge stride cstr
    double* ring = cms + TILE * cstr;     // [row % kk][d][lane]
    double* ads = ring + kk * kk * TILE;  // [edge][row], edge stride astr
    const int first = tile * TILE;
    const int nvalid = min(TILE, E - first);
    const bool valid = lane < nvalid;
    double* Lt = Lb + static_cast<long long>(first) * m * kk;
    for (int j0 = 0; j0 < N; j0 += J) {
        const int jlo = j0 > 0 ? j0 - 1 : 0;
        const int jhi = min(N, j0 + J);
        const int cnt = (jhi - jlo) * kk2;
        __syncwarp();
        for (int q = 0; q < nvalid; ++q) {
            const double* src = cm + (static_cast<long long>(perm[first + q]) * N + jlo) * kk2;
            for (int p = lane; p < cnt; p += TILE) cms[q * cstr + p] = src[p];
        }
        __syncwarp();
        const int i0 = k * j0, i1 = j0 + J >= N ? m : k * (j0 + J);
        for (int i = i0; i < i1; ++i) {
            double* cur = ring + (i % kk) * kk * TILE + lane;
            double* Lrow = Lt + static_cast<long long>(i) * kk * TILE + lane;
            if (!valid) {  // a ghost slot of the ragged tile: the identity
                for (int d = 0; d < kk; ++d) Lrow[d * TILE] = d == 0 ? 1.0 : 0.0;
                continue;
            }
            const double* mine = cms + lane * cstr;
            if (i == 0) {
                cur[0] = 0.0 + mine[(0 - jlo) * kk2];
                for (int d = 1; d < kk; ++d) cur[d * TILE] = 0.0;
            } else {
                const int c = (i - 1) / k, a = i - k * c;  // row i is local dof a (1..k) of cell c
                const double* Mc = mine + (c - jlo) * kk2;
                for (int d = 0; d < kk; ++d) {
                    double val = 0.0;
                    if (d <= a) val = 0.0 + Mc[a * kk + (a - d)];
                    if (d == 0 && a == k && c + 1 < N) val = val + Mc[kk2];  // M_{c+1}[0][0]
                    cur[d * TILE] = val;
                }
            }
            ads[lane * astr + (i - i0)] = cur[0];
            const int t0 = i - k > 0 ? i - k : 0;
            for (int j = t0; j < i; ++j) {
                const double* rj = ring + (j % kk) * kk * TILE + lane;
                double s = cur[(i - j) * TILE];
                for (int t = t0; t < j; ++t) s = s - cur[(i - t) * TILE] * rj[(j - t) * TILE];
                cur[(i - j) * TILE] = s * rj[0];
            }
            double s = cur[0];
            for (int t = t0; t < i; ++t) {
                const double l = cur[(i - t) * TILE];
                s = s - l * l;
            }
            cur[0] = 1.0 / sqrt(s);
            for (int d = 0; d < kk; ++d) Lrow[d * TILE] = cur[d * TILE];
        }
        __syncwarp();
        const int rows = i1 - i0;
        for (int p = lane; p < nvalid * rows; p += TILE) {
            const int q = p / rows, r = p % rows;
            adiag[static_cast<long long>(first + q) * m + i0 + r] = ads[q * astr + r];
        }
    }
}

// The forward and backward sweeps of one lane: L points at the lane's band
// (L[(i (k+1) + d) TILE] = L(i, i - d), d = 0 the reciprocal pivot), x at its
// m values, v in and A^-1 v out.  bars (one mbarrier a stage of STAGE_ROWS
// band rows) are waited on before a stage's rows are read; null when the
// band is in place.  K > 0: k == K, the window in registers.
template <int K>
__device__ __forceinline__ void band_solve(int m, int k, const double* L, double* x,
                                           unsigned long long* bars)
{
    const int kk = (K > 0 ? K : k) + 1;
    double w[K > 0 ? K : 1];  // forward: x[i-K .. i-1], oldest first
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = 0.0;
    for (int i0 = 0, c = 0; i0 < m; i0 += STAGE_ROWS, ++c) {
        if (bars != nullptr && !tc_mbar_wait(bars + c, 0)) __trap();
#pragma unroll
        for (int r = 0; r < STAGE_ROWS; ++r) {
            const int i = i0 + r;
            if (i >= m) break;
            const double* Li = L + static_cast<long long>(i) * kk * TILE;
            double s = x[i];
            if constexpr (K > 0) {
#pragma unroll
                for (int j = 0; j < K; ++j)
                    if (i - K + j >= 0) s = s - Li[(K - j) * TILE] * w[j];
                const double xi = s * Li[0];
#pragma unroll
                for (int j = 0; j + 1 < K; ++j) w[j] = w[j + 1];
                w[K - 1] = xi;
                x[i] = xi;
            } else {
                for (int t = i - k > 0 ? i - k : 0; t < i; ++t) s = s - Li[(i - t) * TILE] * x[t];
                x[i] = s * Li[0];
            }
        }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = 0.0;  // backward: x[i+1 .. i+K], nearest first
#pragma unroll 4
    for (int i = m - 1; i >= 0; --i) {
        double s = x[i];
        if constexpr (K > 0) {
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const int t = i + 1 + j;
                if (t < m) s = s - L[(static_cast<long long>(t) * kk + (j + 1)) * TILE] * w[j];
            }
            const double xi = s * L[static_cast<long long>(i) * kk * TILE];
#pragma unroll
            for (int j = K - 1; j > 0; --j) w[j] = w[j - 1];
            w[0] = xi;
            x[i] = xi;
        } else {
            const int t1 = i + k < m - 1 ? i + k : m - 1;
            for (int t = i + 1; t <= t1; ++t)
                s = s - L[(static_cast<long long>(t) * kk + (t - i)) * TILE] * x[t];
            x[i] = s * L[static_cast<long long>(i) * kk * TILE];
        }
    }
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(tc_smem_u32(bar)), "r"(bytes)
                 : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global to shared
// memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, unsigned long long* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(tc_smem_u32(dst)), "l"(src), "r"(bytes), "r"(tc_smem_u32(bar))
                 : "memory");
}

// bytes from shared to global memory, waited for before the block may exit
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes)
{
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(tc_smem_u32(src)), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__host__ __device__ int stages_of(int m) { return (m + STAGE_ROWS - 1) / STAGE_ROWS; }
__host__ __device__ int bar_bytes(int m) { return ((8 * (stages_of(m) + 1) + 127) / 128) * 128; }
__host__ __device__ long long staged_smem(int m, int k) { return bar_bytes(m) + 8LL * TILE * m * (k + 2); }

template <int K>
__global__ void __launch_bounds__(2 * TILE) solve_staged_kernel(int E, int m, int k, const double* Lb,
                                                                const double* v, double* out)
{
    extern __shared__ __align__(128) unsigned char ssm[];
    const int kk = (K > 0 ? K : k) + 1;
    const int S = stages_of(m);
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(ssm);  // S band stages, then v
    double* band = reinterpret_cast<double*>(ssm + bar_bytes(m));           // [i][d][lane]
    double* xs = band + static_cast<long long>(m) * kk * TILE;               // [lane][i]
    const int tile = blockIdx.x, lane = threadIdx.x % TILE;
    const bool solver = threadIdx.x < TILE;
    const int first = tile * TILE;
    const int nvalid = min(TILE, E - first);
    const unsigned vbytes = 8u * TILE * m;
    const long long off = static_cast<long long>(first) * m;
    const bool bulk_in = nvalid == TILE && (reinterpret_cast<unsigned long long>(v) & 15) == 0;
    const bool bulk_out = nvalid == TILE && (reinterpret_cast<unsigned long long>(out) & 15) == 0;
    if (threadIdx.x == TILE) {
        for (int c = 0; c < S; ++c) tc_mbar_init(bars + c, 1);
        tc_mbar_init(bars + S, bulk_in ? 1 : TILE);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (!solver) {  // the staging warp: every copy in flight at once
        if (bulk_in) {
            if (lane == 0) {
                mbar_expect(bars + S, vbytes);
                bulk_load(xs, v + off, vbytes, bars + S);
            }
        } else {
            const int n = nvalid * m;
            for (int p = lane; p < TILE * m; p += TILE) xs[p] = p < n ? v[off + p] : 0.0;
            tc_mbar_arrive(bars + S);
        }
        if (lane == 0) {
            const double* src = Lb + static_cast<long long>(tile) * m * kk * TILE;
            for (int c = 0; c < S; ++c) {
                const int rows = min(STAGE_ROWS, m - c * STAGE_ROWS);
                const unsigned bytes = 8u * rows * kk * TILE;
                const long long at = static_cast<long long>(c) * STAGE_ROWS * kk * TILE;
                mbar_expect(bars + c, bytes);
                bulk_load(band + at, src + at, bytes, bars + c);
            }
        }
    } else {
        if (!tc_mbar_wait(bars + S, 0)) __trap();
        band_solve<K>(m, k, band + lane, xs + lane * m, bars);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (solver) return;
    if (bulk_out) {
        if (lane == 0) bulk_store(out + off, xs, vbytes);
    } else {
        for (int p = lane; p < nvalid * m; p += TILE) out[off + p] = xs[p];
    }
}

// a tile too large for shared memory: each lane solves its edge in place in out
__global__ void __launch_bounds__(TILE) solve_global_kernel(int E, int m, int k, const double* Lb,
                                                            const double* v, double* out)
{
    const int tile = blockIdx.x, lane = threadIdx.x;
    const int s = tile * TILE + lane;
    if (s >= E) return;
    double* x = out + static_cast<long long>(s) * m;
    const double* rhs = v + static_cast<long long>(s) * m;
    for (int i = 0; i < m; ++i) x[i] = rhs[i];
    band_solve<0>(m, k, Lb + static_cast<long long>(tile) * m * (k + 1) * TILE + lane, x, nullptr);
}

template <int K>
int launch_staged(int E, int m, int k, const double* Lb, const double* v, double* out, cudaStream_t stream)
{
    const int bytes = static_cast<int>(staged_smem(m, k));
    cudaError_t err = cudaFuncSetAttribute(solve_staged_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    solve_staged_kernel<K><<<(E + TILE - 1) / TILE, 2 * TILE, bytes, stream>>>(E, m, k, Lb, v, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A tile plan (made once by the Python plan, a ctypes Structure of the same
// fields): E edges in flux order, N cells an edge, degree k, perm[s] the
// edge id of flux slot s.
struct SchurTiles {
    int E, N, k;
    const int* perm;
};

// cm: (E N, k+1, k+1) cell masses in edge-id order; Lb: the tile-major band
// (ceil(E / 32) 32 (kN+1) (k+1) doubles); adiag: (E (kN+1),) in flux order
extern "C" int nxfx_schur_p_factor(const SchurTiles* a, const double* cm, double* Lb, double* adiag,
                                   cudaStream_t stream)
{
    const int E = a->E, N = a->N, k = a->k;
    if (E <= 0) return 0;
    if (N <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
    int J = MAX_CELLS;
    while (J > 1 && factor_smem(k, J) > FACTOR_SMEM) --J;
    const int bytes = factor_smem(k, J);
    if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    factor_kernel<<<(E + TILE - 1) / TILE, TILE, bytes, stream>>>(E, N, k, J, cm, a->perm, Lb, adiag);
    return static_cast<int>(cudaGetLastError());
}

// out = A^-1 v on the flux dofs of every edge (out may not alias v)
extern "C" int nxfx_schur_p_solve(const SchurTiles* a, const double* Lb, const double* v, double* out,
                                  cudaStream_t stream)
{
    const int E = a->E, N = a->N, k = a->k;
    if (E <= 0) return 0;
    if (N <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int m = k * N + 1;
    if (staged_smem(m, k) > MAX_SMEM) {
        solve_global_kernel<<<(E + TILE - 1) / TILE, TILE, 0, stream>>>(E, m, k, Lb, v, out);
        return static_cast<int>(cudaGetLastError());
    }
    switch (k) {
    case 1: return launch_staged<1>(E, m, k, Lb, v, out, stream);
    case 2: return launch_staged<2>(E, m, k, Lb, v, out, stream);
    case 3: return launch_staged<3>(E, m, k, Lb, v, out, stream);
    case 4: return launch_staged<4>(E, m, k, Lb, v, out, stream);
    default: return launch_staged<0>(E, m, k, Lb, v, out, stream);
    }
}
