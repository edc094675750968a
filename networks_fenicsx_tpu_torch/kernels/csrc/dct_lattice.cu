// K16: the separable-DCT capacitance solve of a uniform scalar-R lattice.
//
// Replaces networks_fenicsx_tpu/solver.py:941-1102 _dct_capacitance_factor,
// _dct_capacitance_apply, _dct2_matrix_device and _dct_lattice_solve (927).
// With the orthonormal DCT-II matrices Dx (s, s) and Dy (ny, ny):
//   factor (once per solve):
//     inv = 1 / (wx lamx[col] + wy lamy[row]), 0 at the zero mode     (ny, s)
//     g   = kappa g_geo, kappa = 1 / (wx len_x)                        (r, B)
//     M   = [[g[:, rows]^T + diag(1 / w_r), -1], [1, 0]], its inverse  (r+1)^2
//   one direct pass on b (B,):
//     z   = Dy^T ((Dy b Dx^T) o inv) Dx      four float64 products
//     sol = Minv [z[rows], sum b]
//     out = (z - sum_t sol_t g_t) + sol_r    (+ lam when refining)
//
// Bound: float64 operations.  At 512^2 one pass is four 512^3 products,
// 1.07 GFLOP (16 us at the 67 TFLOP/s of the float64 tensor cores), against
// ~8 MB of traffic; a solve is three passes.  So the products run on the
// tensor cores (mma.sync m16n8k16 f64: on an H100 the m16n8k* shapes run at
// the full rate and m8n8k4 at half of it, in a register-only test).  A block
// computes a 64 x 64 output tile.  Its warps specialise: four producer
// warps stage 32-deep k slabs of op(A) and op(B) into shared memory by
// cp.async, four slabs in flight, and eight consumer warps (32 x 16 of the
// tile each) multiply, the two sides handing each slab over through a pair
// of mbarriers (full: the producers' copies have landed, counted by
// cp.async.mbarrier.arrive; empty: every consumer warp has read it), with no
// block barrier in the loop.  On an H100, when the same warps both staged
// and multiplied, a 64 x 64 x 32 slab cost ~1.3 us an SM whatever the warp
// tile, MMA or pipeline depth: staging alone took ~0.4 us and the fed MMAs
// ~0.7 us, and the issue of the copies (tens of cycles each a warp) kept
// them from overlapping; split between warps, a slab costs ~1.0 us.  The
// copies are 16 bytes where every staged row is 16-byte aligned (8
// otherwise); they copy bytes and cannot transpose, so an operand whose
// source is contiguous along k is staged [row][k] and one contiguous along
// its rows [k][row], both with a row stride of 4 mod 16 doubles, which the
// fragment reads (templated on the two layouts) take without bank
// conflicts; ragged M, N and K are zero-filled by the copies and masked at
// the store.  A 512^2 product has 64 tiles for 132 SMs, so the host may
// split the k range over up to 8 blocks a tile, launched as one cluster:
// each block dumps its partial tile into its shared memory, and the
// cluster's blocks share out the tile's entries, each adding the dumps in
// rank (= k) order through distributed shared memory, scaling by S and
// writing C.  No reduce launch, no work buffer, and the same bits every
// call.  The eigenvalue scaling is the second product's epilogue.  A wait
// on an mbarrier is bounded: a phase that never completes (a fault) traps
// instead of hanging the card.
//
// The direct pass's border is one launch: per-block partial sums of b, and
// the last block to finish (a ticket) adds them in block order and forms
// sol.  So a solve is 2 + 6 (1 + n_refine) launches (20 at two refinement
// passes), and the host issues a pass's six (eight with the factor) in one
// call, from a struct of the operator's shapes and pointers built once per
// calling stream.
//
// The border's partials and ticket, like the transform grids, are scratch of
// the calling stream, held by the Python operator (one buffer per stream,
// zeroed on that stream at its first use), so solves on two streams never
// share them; the ticket is put back to 0 by the block that takes its last
// value, inside the launch, so a CUDA-graph replay finds it at 0 and needs no
// refusal under capture.  Buffers one block writes and another reads carry
// no __restrict__ and are read past L1 (__ldcg).  The bordered matrix (r + 1
// <= 17) is inverted in one block by Gauss-Jordan with partial pivoting, in
// float64.
//
// Over S scenarios (a sweep's resistance or right-hand-side batch) every
// launch takes them all, so a pass is six launches and a solve 20 whatever
// S: a product puts the scenario beside its column tiles in grid x and keeps
// one scenario's k split (the split decides the bits), each operand moving by
// its own stride (0 for Dx, Dy and a factor that every scenario shares); the
// factor's scale kernel, the border and the correction walk the scenarios in
// grid y, and the bordered inverse is one block a scenario.  Each scenario
// has its own grids, border partials, ticket and sol in the calling stream's
// scenario scratch, and the border's block count is one scenario's, so row i
// is the bits of a call of one on row i.

#include <atomic>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;              // output tile rows
constexpr int BN = 64;              // output tile columns
constexpr int WM = 2, WN = 4;       // consumer warps down and across the tile: 32 x 16 each
constexpr int CONSUMERS = WM * WN;  // warps that multiply
constexpr int PRODUCERS = 4;        // warps that stage the slabs
constexpr int GEMM_THREADS = (CONSUMERS + PRODUCERS) * 32;
constexpr int FM = BM / WM / 16;    // m16 fragments a warp (2)
constexpr int FN = BN / WN / 8;     // n8 fragments a warp (2)
constexpr int BK = 32;              // k slab depth
constexpr int KSTEP = 16;           // k depth of one mma (m16n8k16)
static_assert(BK % KSTEP == 0, "whole mma steps a slab");
constexpr int STAGES = 4;           // slabs in flight
constexpr int LDK = BK + 4;         // row stride of a [row][k] slab: 4 mod 16 doubles
constexpr int LDC = BN + 8;         // row stride of a dumped tile: 8 mod 16 doubles
constexpr int MAX_SPLIT = 8;        // blocks sharing one tile's k range: a portable cluster
constexpr int MAX_BORDER = 17;      // r + 1 for at most 16 stub rows
constexpr int BORDER_THREADS = 256;
constexpr int BORDER_BLOCKS = 256;  // at most, partial sums of b

// doubles of one staged slab of ROWS rows in either layout ([row][k] with
// stride LDK, or [k][row] with stride ROWS + 4, also 4 mod 16)
template <int ROWS>
__host__ __device__ constexpr int slab_doubles() { return ROWS * LDK > BK * (ROWS + 4) ? ROWS * LDK : BK * (ROWS + 4); }

constexpr int SLAB_A = slab_doubles<BM>();
constexpr int SLAB_B = slab_doubles<BN>();
constexpr int GEMM_SMEM = STAGES * (SLAB_A + SLAB_B) * static_cast<int>(sizeof(double));
static_assert(BM * LDC <= STAGES * (SLAB_A + SLAB_B), "the dumped tile reuses the slabs");

// Stage rows [r0, r0 + ROWS) and k [k0, k0 + BK) of a matrix op(X) with R
// rows (zeros past R or k_end) into S by cp.async.  KC (k-contiguous
// source, element (r, k) at X[r K + k]): S is [row][k], stride LDK; else
// (element (r, k) at X[k R + r]) S is [k][row], stride ROWS + 4.  Each
// copy takes two neighbours along the contiguous axis when vec (16-byte
// aligned rows), else one; producer thread p (of PRODUCERS * 32) takes every
// (PRODUCERS * 32)-th copy from the p-th.  A warp's copies cover whole 256-
// or 512-byte runs of a source row and land on distinct banks.
template <int ROWS, bool KC>
__device__ __forceinline__ void stage_slab(double* S, const double* X, bool vec, int r0, int R, int K, int k0,
                                           int k_end, int p)
{
    constexpr int LDT = ROWS + 4;
    constexpr int LANES = PRODUCERS * 32;
    const int w = vec ? 2 : 1;
    const int per = ROWS * BK / (LANES * w);
    for (int u = 0; u < per; ++u) {
        const int e = (p + LANES * u) * w;
        int r, k;
        if (KC) {
            r = e / BK;
            k = e % BK;
        } else {
            k = e / ROWS;
            r = e % ROWS;
        }
        const int gr = r0 + r, gk = k0 + k;
        // elements of the copy inside the matrix: along k (KC) or along the rows
        const int lim = KC ? (gr < R ? k_end - gk : 0) : (gk < k_end ? R - gr : 0);
        const int n = lim < 0 ? 0 : (lim < w ? lim : w);
        const double* src = n > 0 ? (KC ? X + static_cast<size_t>(gr) * K + gk : X + static_cast<size_t>(gk) * R + gr) : X;
        tc_cp_async_zfill(KC ? S + r * LDK + k : S + k * LDT + r, src, vec, 8 * n);
    }
}

// Fragment (row, k) of a staged slab: [row][k] (KC) or [k][row]
template <int ROWS, bool KC>
__device__ __forceinline__ double frag(const double* S, int row, int k)
{
    return KC ? S[row * LDK + k] : S[k * (ROWS + 4) + row];
}

// Elements between two scenarios' operands of a product (0: shared).
struct GemmStrides {
    long long a, b, s, c;
};

// C (M, N) = op(A) (M, K) op(B) (K, N) [o S], all row-major, for each of
// gridDim.x / tiles_n scenarios, each operand st's stride further on.
// op(A) = A stored (M, K) (k-contiguous: AKC), or A^T with A stored (K, M);
// op(B) = B stored (K, N), or B^T with B stored (N, K) (k-contiguous: BKC).
// Block (x, y, z): the BM x BN output tile (y, x % tiles_n) of scenario
// x / tiles_n, k in [z kchunk, (z + 1) kchunk); the gridDim.z blocks of a
// tile form one cluster, so a scenario's k split is one scenario's.  Warp w owns
// rows 32 (w / WN) .. + 32 and columns 16 (w % WN) .. + 16 of the tile:
// acc[mi][ni] the 16 x 8 block at rows + 16 mi, columns + 8 ni (see
// tc_mma16x8x16).
template <bool AKC, bool BKC>
__global__ void __launch_bounds__(GEMM_THREADS) dct_gemm_kernel(
    int M, int N, int K, int kchunk, int vec, int tiles_n, GemmStrides st,
    const double* __restrict__ A, const double* __restrict__ Bm,
    const double* __restrict__ S, double* __restrict__ C)
{
    extern __shared__ __align__(16) double dct_smem[];
    double* As = dct_smem;                       // [STAGES][SLAB_A]
    double* Bs = dct_smem + STAGES * SLAB_A;     // [STAGES][SLAB_B]
    // block x: column tile x % tiles_n of scenario x / tiles_n
    const int sc = blockIdx.x / tiles_n;
    A += static_cast<size_t>(sc) * st.a;
    Bm += static_cast<size_t>(sc) * st.b;
    C += static_cast<size_t>(sc) * st.c;
    if (S) S += static_cast<size_t>(sc) * st.s;
    const int m0 = blockIdx.y * BM, n0 = (blockIdx.x - sc * tiles_n) * BN, z = blockIdx.z;
    const int k_begin = z * kchunk;
    const int k_end = min(K, k_begin + kchunk);
    const int nk = (k_end - k_begin + BK - 1) / BK;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wr = BM / WM * (warp / WN), wc = BN / WN * (warp % WN);
    double acc[FM][FN][4];
#pragma unroll
    for (int mi = 0; mi < FM; ++mi)
#pragma unroll
        for (int ni = 0; ni < FN; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;

    // the producer warps stage slab kt into stage kt % STAGES once the
    // consumers have released it (empty) and signal full[stage] as their
    // copies land; the consumer warps wait on full[stage], multiply, and
    // release it
    __shared__ __align__(8) unsigned long long full[STAGES], empty[STAGES];
    if (threadIdx.x == 0) {
        for (int st = 0; st < STAGES; ++st) {
            tc_mbar_init(&full[st], PRODUCERS * 32);
            tc_mbar_init(&empty[st], CONSUMERS);
        }
    }
    __syncthreads();
    if (warp >= CONSUMERS) {
        const int p = threadIdx.x - CONSUMERS * 32;
        for (int kt = 0; kt < nk; ++kt) {
            const int stage = kt % STAGES, k0 = k_begin + kt * BK;
            if (kt >= STAGES && !tc_mbar_wait(&empty[stage], (kt / STAGES - 1) & 1)) __trap();
            stage_slab<BM, AKC>(As + stage * SLAB_A, A, vec, m0, M, K, k0, k_end, p);
            stage_slab<BN, BKC>(Bs + stage * SLAB_B, Bm, vec, n0, N, K, k0, k_end, p);
            tc_mbar_arrive_copies(&full[stage]);
        }
    } else {
        for (int kt = 0; kt < nk; ++kt) {
            const int stage = kt % STAGES;
            if (!tc_mbar_wait(&full[stage], (kt / STAGES) & 1)) __trap();
            const double* as = As + stage * SLAB_A;
            const double* bs = Bs + stage * SLAB_B;
#pragma unroll
            for (int kk = 0; kk < BK; kk += KSTEP) {
                double a[FM][KSTEP / 2], b[FN][KSTEP / 4];
#pragma unroll
                for (int mi = 0; mi < FM; ++mi)
#pragma unroll
                    for (int i = 0; i < KSTEP / 2; ++i)
                        a[mi][i] = frag<BM, AKC>(as, wr + 16 * mi + g + 8 * (i % 2), kk + t + 4 * (i / 2));
#pragma unroll
                for (int ni = 0; ni < FN; ++ni)
#pragma unroll
                    for (int i = 0; i < KSTEP / 4; ++i) b[ni][i] = frag<BN, BKC>(bs, wc + 8 * ni + g, kk + t + 4 * i);
#pragma unroll
                for (int mi = 0; mi < FM; ++mi)
#pragma unroll
                    for (int ni = 0; ni < FN; ++ni) tc_mma16x8x16(acc[mi][ni], a[mi], b[ni]);
            }
            __syncwarp();
            if (lane == 0) tc_mbar_arrive(&empty[stage]);
        }
    }
    __syncthreads();  // every slab landed and read: the slabs are free

    const bool consumer = warp < CONSUMERS;
    if (gridDim.z == 1) {
        if (!consumer) return;
#pragma unroll
        for (int mi = 0; mi < FM; ++mi)
#pragma unroll
            for (int ni = 0; ni < FN; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int gm = m0 + wr + 16 * mi + g + 8 * (e >> 1), gn = n0 + wc + 8 * ni + 2 * t + (e & 1);
                    if (gm >= M || gn >= N) continue;
                    const size_t o = static_cast<size_t>(gm) * N + gn;
                    C[o] = S ? acc[mi][ni][e] * S[o] : acc[mi][ni][e];
                }
        return;
    }
    // split: dump the block's partial tile into the slabs' shared memory
    // (free once every copy has landed and every warp is past its last
    // fragment read), then share its entries out over the cluster's blocks,
    // each adding the cluster's dumps in rank (= slice) order through
    // distributed shared memory
    double* dump = dct_smem;  // [BM][LDC]
    if (consumer) {
#pragma unroll
        for (int mi = 0; mi < FM; ++mi)
#pragma unroll
            for (int ni = 0; ni < FN; ++ni)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = wr + 16 * mi + g + 8 * h, c = wc + 8 * ni + 2 * t;
                    *reinterpret_cast<double2*>(dump + r * LDC + c) =
                        make_double2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
                }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's dump is written
    const int split = gridDim.z;
    const double* dumps[MAX_SPLIT];
    for (int q = 0; q < split; ++q) dumps[q] = cluster.map_shared_rank(dump, q);
#pragma unroll 4
    for (int idx = z * GEMM_THREADS + threadIdx.x; idx < BM * BN; idx += split * GEMM_THREADS) {
        const int r = idx / BN, c = idx % BN;
        const int gm = m0 + r, gn = n0 + c;
        if (gm >= M || gn >= N) continue;
        double v = 0.0;
        for (int q = 0; q < split; ++q) v += dumps[q][r * LDC + c];  // slices in order
        const size_t o = static_cast<size_t>(gm) * N + gn;
        C[o] = S ? v * S[o] : v;
    }
    cluster.sync();  // no block leaves while another still reads its dump
}

// Once per device and instance: the product kernel's dynamic shared memory
// above 48 KB.
template <bool AKC, bool BKC>
cudaError_t gemm_allow_smem()
{
    static std::atomic<unsigned long long> done{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(dct_gemm_kernel<AKC, BKC>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
    return err;
}

// One launch of a cluster of zs blocks a tile (zs = the effective split),
// nscen scenarios side by side in grid x.
template <bool AKC, bool BKC>
int launch_gemm(int M, int N, int K, const double* A, const double* B, const double* S, double* C, int split,
                int nscen, GemmStrides st, cudaStream_t stream)
{
    const int kchunk = ((K + split - 1) / split + BK - 1) / BK * BK;
    const int zs = (K + kchunk - 1) / kchunk;
    const int tiles_n = (N + BN - 1) / BN;
    if (static_cast<long long>(tiles_n) * nscen > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    // 16-byte copies when every staged row of every scenario starts 16-byte aligned
    const bool vec = (reinterpret_cast<uintptr_t>(A) % 16 == 0) && (reinterpret_cast<uintptr_t>(B) % 16 == 0)
                     && (AKC ? K : M) % 2 == 0 && (BKC ? K : N) % 2 == 0 && st.a % 2 == 0 && st.b % 2 == 0;
    cudaError_t err = gemm_allow_smem<AKC, BKC>();
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles_n * nscen, (M + BM - 1) / BM, zs);
    cfg.blockDim = dim3(GEMM_THREADS);
    cfg.dynamicSmemBytes = GEMM_SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = zs;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, dct_gemm_kernel<AKC, BKC>, M, N, K, kchunk, static_cast<int>(vec), tiles_n, st,
                             A, B, S, C);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// inv (ny, s) and g = kappa g_geo (r, B), one element per thread, for
// scenarios y, y + gridDim.y, ... of S: w sw further on, inv B and g r B
__global__ void dct_scale_kernel(
    int s, int ny, int r, int B, int S,
    const double* __restrict__ w, long long sw, int rep_x, int rep_y, double len_x,
    const double* __restrict__ lamx, const double* __restrict__ lamy,
    const double* __restrict__ g_geo,
    double* __restrict__ inv, double* __restrict__ g)
{
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    for (int sc = blockIdx.y; sc < S; sc += gridDim.y) {
        const double* ws = w + (size_t)sc * sw;
        const double wx = ws[rep_x];
        const double wy = ws[rep_y];
        if (i < (size_t)ny * s) {
            const int row = (int)(i / s), col = (int)(i % s);
            const double sym = wx * lamx[col] + wy * lamy[row];
            inv[(size_t)sc * B + i] = sym > 0.0 ? 1.0 / sym : 0.0;
        }
        if (i < (size_t)r * B) {
            const double kappa = 1.0 / (wx * len_x);
            g[(size_t)sc * r * B + i] = kappa * g_geo[i];
        }
    }
}

// w_r, the bordered matrix M and its inverse, in one block a scenario
// (block x: w sw, g r B, Minv (r + 1)^2 further on)
__global__ void dct_minv_kernel(
    int r, int n_stub, int B,
    const double* __restrict__ w, long long sw,
    const int* __restrict__ stub_edge, const int* __restrict__ stub_group,
    const int* __restrict__ stub_rows,
    const double* __restrict__ g,
    double* __restrict__ Minv)
{
    __shared__ double wr[MAX_BORDER];
    __shared__ double aug[MAX_BORDER][2 * MAX_BORDER];
    __shared__ double col[MAX_BORDER];
    __shared__ int piv;
    const int n = r + 1;
    const int tid = threadIdx.x;
    w += (size_t)blockIdx.x * sw;
    g += (size_t)blockIdx.x * r * B;
    Minv += (size_t)blockIdx.x * n * n;
    if (tid == 0) {
        for (int t = 0; t < r; ++t) wr[t] = 0.0;
        for (int i = 0; i < n_stub; ++i) wr[stub_group[i]] += w[stub_edge[i]];
    }
    __syncthreads();
    for (int idx = tid; idx < n * 2 * n; idx += blockDim.x) {
        const int a = idx / (2 * n), b = idx % (2 * n);
        double v;
        if (b >= n) {
            v = (b - n == a) ? 1.0 : 0.0;
        } else if (a < r && b < r) {
            v = g[(size_t)b * B + stub_rows[a]] + (a == b ? 1.0 / wr[a] : 0.0);
        } else if (a < r) {
            v = -1.0;  // column r
        } else {
            v = b < r ? 1.0 : 0.0;  // row r
        }
        aug[a][b] = v;
    }
    __syncthreads();
    for (int p = 0; p < n; ++p) {
        if (tid == 0) {
            int best = p;
            for (int i = p + 1; i < n; ++i)
                if (fabs(aug[i][p]) > fabs(aug[best][p])) best = i;
            piv = best;
        }
        __syncthreads();
        const int q = piv;
        if (q != p && tid < 2 * n) {
            const double t = aug[p][tid];
            aug[p][tid] = aug[q][tid];
            aug[q][tid] = t;
        }
        __syncthreads();
        const double d = aug[p][p];
        __syncthreads();
        if (tid < 2 * n) aug[p][tid] = aug[p][tid] / d;
        if (tid < n) col[tid] = aug[tid][p];
        __syncthreads();
        for (int idx = tid; idx < n * 2 * n; idx += blockDim.x) {
            const int a = idx / (2 * n), b = idx % (2 * n);
            if (a != p) aug[a][b] = aug[a][b] - col[a] * aug[p][b];
        }
        __syncthreads();
    }
    for (int idx = tid; idx < n * n; idx += blockDim.x)
        Minv[idx] = aug[idx / n][n + idx % n];
}

// sol = Minv [z[rows], sum b]: per-block partial sums of b (grid-stride),
// then the last block (a ticket) adds them in block order and forms sol.
// Scenarios y, y + gridDim.y, ... of S, each with its own partial row
// (BORDER_BLOCKS apart), ticket and sol (r + 1 apart), b and z B apart and
// Minv sM apart; every scenario has the same gridDim.x blocks, so the same
// sums in the same order as a call of one.
__global__ void __launch_bounds__(BORDER_THREADS) dct_border_kernel(
    int B, int r, int S,
    const double* __restrict__ b, const double* __restrict__ z,
    const int* __restrict__ stub_rows, const double* __restrict__ Minv, long long sM,
    double* partial, unsigned int* ticket, double* __restrict__ sol)
{
    __shared__ double part[BORDER_THREADS];
    __shared__ bool last;
    const int tid = threadIdx.x;
    const int n = r + 1;
    for (int sc = blockIdx.y; sc < S; sc += gridDim.y) {
        const double* bs = b + (size_t)sc * B;
        double* ps = partial + (size_t)sc * BORDER_BLOCKS;
        unsigned int* ts = ticket + sc;
        double acc = 0.0;
        for (int i = blockIdx.x * BORDER_THREADS + tid; i < B; i += gridDim.x * BORDER_THREADS) acc += bs[i];
        part[tid] = acc;
        __syncthreads();
        for (int half = BORDER_THREADS / 2; half > 0; half /= 2) {
            if (tid < half) part[tid] = part[tid] + part[tid + half];
            __syncthreads();
        }
        if (tid == 0) {
            ps[blockIdx.x] = part[0];
            __threadfence();
            last = atomicAdd(ts, 1u) == gridDim.x - 1;
        }
        __syncthreads();
        if (last) {
            __threadfence();
            acc = 0.0;
            for (int i = tid; i < static_cast<int>(gridDim.x); i += BORDER_THREADS) acc += __ldcg(ps + i);
            part[tid] = acc;
            __syncthreads();
            for (int half = BORDER_THREADS / 2; half > 0; half /= 2) {
                if (tid < half) part[tid] = part[tid] + part[tid + half];
                __syncthreads();
            }
            if (tid < n) {
                const double* zs = z + (size_t)sc * B;
                const double* Ms = Minv + (size_t)sc * sM;
                double v = 0.0;
                for (int j = 0; j < n; ++j) {
                    const double vj = j < r ? zs[stub_rows[j]] : part[0];
                    v += Ms[tid * n + j] * vj;
                }
                sol[(size_t)sc * n + tid] = v;
            }
            if (tid == 0) *ts = 0u;
        }
        __syncthreads();  // part and last are free for the next scenario
    }
}

// out = (z - sum_t sol_t g_t) + sol_r, plus lam_in when refining (lam_out may be
// lam_in: each thread reads its entry before it writes it), for scenarios y,
// y + gridDim.y, ... of S: z and lam B apart, g sg apart, sol r + 1 apart
__global__ void dct_correct_kernel(
    int B, int r, int S,
    const double* __restrict__ z, const double* __restrict__ g, long long sg,
    const double* __restrict__ sol, const double* lam_in, double* lam_out)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    for (int sc = blockIdx.y; sc < S; sc += gridDim.y) {
        const size_t o = (size_t)sc * B + i;
        const double* gs = g + (size_t)sc * sg;
        const double* ss = sol + (size_t)sc * (r + 1);
        double corr = ss[0] * gs[i];
        for (int t = 1; t < r; ++t) corr += ss[t] * gs[(size_t)t * B + i];
        const double v = (z[o] - corr) + ss[r];
        lam_out[o] = lam_in ? lam_in[o] + v : v;
    }
}

// the orthonormal DCT-II matrix of a side above the host-constant limit
__global__ void dct_matrix_kernel(int n, double scale, double scale0, double* __restrict__ D)
{
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (size_t)n * n) return;
    const int k = (int)(idx / n), j = (int)(idx % n);
    // the argument reaches ~n^2/2: formed in float64, as in the plain version
    const double arg = 3.141592653589793 * (((double)j + 0.5) * (double)k / (double)n);
    double v = cos(arg) * scale;
    if (k == 0) v *= scale0;
    D[idx] = v;
}

int blocks_for(size_t n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

// The shapes and pointers of one operator on one calling stream, built once
// by the Python operator (a ctypes Structure of the same fields): its DCT
// matrices, eigenvalues, stub columns and tables, each product's tile rows
// and k split (y: k = ny, x: k = s), and the stream's scratch.
struct DctArgs {
    int s, ny, r, B, n_stub, rep_x, rep_y;
    int split_y, split_x;
    double len_x;
    const double* Dx;
    const double* Dy;
    const double* lamx;
    const double* lamy;
    const double* g_geo;
    const int* stub_rows;
    const int* stub_edge;
    const int* stub_group;
    double* inv;
    double* g;
    double* Minv;
    double* t1;
    double* t2;
    double* z;
    double* partial;
    double* sol;
    unsigned int* border_ticket;
};

// One stream's scratch of a scenario call (dct_apply_scenarios): the
// transform grids t1, t2, z (B a scenario), the border's partial sums
// (BORDER_BLOCKS a scenario), sol (r + 1 a scenario) and one ticket a
// scenario, for at most `capacity` scenarios; built by the Python operator
// when the stream's scratch grows (a ctypes Structure of the same fields).
struct DctScen {
    int capacity;
    double* t1;
    double* t2;
    double* z;
    double* partial;
    double* sol;
    unsigned int* tickets;
};

namespace {

// the grid rows of a launch over S scenarios: one a scenario up to the
// grid's y limit, each row then walking the scenarios y, y + gridDim.y, ...
unsigned int scen_rows(int S) { return static_cast<unsigned int>(S < 65535 ? S : 65535); }

// the factors of S scenarios into inv, g and Minv (each scenario's B, r B
// and (r + 1)^2 further on), w sw further on a scenario: two launches
int dct_factor(const DctArgs* a, int S, const double* w, long long sw, double* inv, double* g, double* Minv,
               cudaStream_t stream)
{
    if (a->r < 1 || a->r + 1 > MAX_BORDER || S < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t n = (size_t)a->ny * a->s > (size_t)a->r * a->B ? (size_t)a->ny * a->s : (size_t)a->r * a->B;
    dct_scale_kernel<<<dim3(blocks_for(n, 256), scen_rows(S)), 256, 0, stream>>>(
        a->s, a->ny, a->r, a->B, S, w, sw, a->rep_x, a->rep_y, a->len_x, a->lamx, a->lamy, a->g_geo, inv, g);
    int code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
    dct_minv_kernel<<<S, 2 * MAX_BORDER * 4, 0, stream>>>(
        a->r, a->n_stub, a->B, w, sw, a->stub_edge, a->stub_group, a->stub_rows, g, Minv);
    return static_cast<int>(cudaGetLastError());
}

int dct_gemm(int M, int N, int K, const double* A, int transA, const double* B, int transB, const double* S,
             double* C, int split, int nscen, GemmStrides st, cudaStream_t stream)
{
    if (M <= 0 || N <= 0) return 0;
    if (K <= 0 || split < 1 || split > MAX_SPLIT || (M + BM - 1) / BM > 65535 || nscen < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (!transA && transB) return launch_gemm<true, true>(M, N, K, A, B, S, C, split, nscen, st, stream);
    if (!transA) return launch_gemm<true, false>(M, N, K, A, B, S, C, split, nscen, st, stream);
    if (transB) return launch_gemm<false, true>(M, N, K, A, B, S, C, split, nscen, st, stream);
    return launch_gemm<false, false>(M, N, K, A, B, S, C, split, nscen, st, stream);
}

// The buffers of one pass over S scenarios: the grids and border scratch
// (B, B, B, BORDER_BLOCKS, r + 1 and one ticket a scenario) and the factor's
// strides (0: one factor shared by every scenario).
struct PassBufs {
    int S;
    double* t1;
    double* t2;
    double* z;
    double* partial;
    double* sol;
    unsigned int* tickets;
    long long s_inv, s_g, s_minv;
};

// the one-scenario pass's buffers: the stream's scratch of DctArgs
PassBufs one_scenario(const DctArgs* a)
{
    return PassBufs{1, a->t1, a->t2, a->z, a->partial, a->sol, a->border_ticket, 0, 0, 0};
}

// z = Dy^T ((Dy b Dx^T) o inv) Dx through t1 and t2, b and z B apart a
// scenario: four launches.  Each product keeps one scenario's k split, so
// a scenario's bits are those of a call of one.
int dct_lplus(const DctArgs* a, const PassBufs& p, const double* inv, const double* b, double* z,
              cudaStream_t stream)
{
    const int s = a->s, ny = a->ny;
    const long long B = a->B;
    int code = dct_gemm(ny, s, ny, a->Dy, 0, b, 0, nullptr, p.t1, a->split_y, p.S, GemmStrides{0, B, 0, B}, stream);
    if (code == 0)
        code = dct_gemm(ny, s, s, p.t1, 0, a->Dx, 1, inv, p.t2, a->split_x, p.S, GemmStrides{B, 0, p.s_inv, B},
                        stream);
    if (code == 0)
        code = dct_gemm(ny, s, ny, a->Dy, 1, p.t2, 0, nullptr, p.t1, a->split_y, p.S, GemmStrides{0, B, 0, B}, stream);
    if (code == 0)
        code = dct_gemm(ny, s, s, p.t1, 0, a->Dx, 0, nullptr, z, a->split_x, p.S, GemmStrides{B, 0, 0, B}, stream);
    return code;
}

}  // namespace

// One launch: C = op(A) op(B) [o S], the tile's k range split over split
// blocks (a cluster) when split > 1.
extern "C" int nxfx_dct_gemm(
    int M, int N, int K, const double* A, int transA, const double* B, int transB,
    const double* S, double* C, int split, cudaStream_t stream)
{
    return dct_gemm(M, N, K, A, transA, B, transB, S, C, split, 1, GemmStrides{0, 0, 0, 0}, stream);
}

// The factor into the given buffers: two launches.
extern "C" int nxfx_dct_factor(const DctArgs* a, const double* w, double* inv, double* g, double* Minv,
                               cudaStream_t stream)
{
    return dct_factor(a, 1, w, 0, inv, g, Minv, stream);
}

// The factors of S scenarios into (S, ny, s) inv, (S, r, B) g and (S, r + 1,
// r + 1) Minv, w's rows sw apart: the same two launches as one factor.
extern "C" int nxfx_dct_factor_scen(const DctArgs* a, int S, const double* w, long long sw, double* inv, double* g,
                                    double* Minv, cudaStream_t stream)
{
    return dct_factor(a, S, w, sw, inv, g, Minv, stream);
}

// One transform solve z = L+ b with the given inv: four launches.
extern "C" int nxfx_dct_lplus(const DctArgs* a, const double* inv, const double* b, double* z,
                              cudaStream_t stream)
{
    return dct_lplus(a, one_scenario(a), inv, b, z, stream);
}

namespace {

// One direct pass over p.S scenarios on b (S, B) into lam (S, B) from the
// factor (inv, g, Minv, each read at p's stride): the four products, the
// border and the correction, six launches whatever S.
int dct_direct(const DctArgs* a, const PassBufs& p, const double* inv, const double* g, const double* Minv,
               const double* b, double* lam, int accumulate, cudaStream_t stream)
{
    int code = dct_lplus(a, p, inv, b, p.z, stream);
    if (code != 0) return code;
    const int m = blocks_for((size_t)a->B, BORDER_THREADS) < BORDER_BLOCKS ? blocks_for((size_t)a->B, BORDER_THREADS)
                                                                          : BORDER_BLOCKS;
    dct_border_kernel<<<dim3(m, scen_rows(p.S)), BORDER_THREADS, 0, stream>>>(
        a->B, a->r, p.S, b, p.z, a->stub_rows, Minv, p.s_minv, p.partial, p.tickets, p.sol);
    code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
    dct_correct_kernel<<<dim3(blocks_for((size_t)a->B, 256), scen_rows(p.S)), 256, 0, stream>>>(
        a->B, a->r, p.S, p.z, g, p.s_g, p.sol, accumulate ? lam : nullptr, lam);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One direct pass on b into lam (lam plus it when accumulate; lam may be
// read and written in place): the four products, the border and the
// correction, six launches on the scratch's factor.  With w non-null the
// factor comes first, into the scratch: two launches more.
extern "C" int nxfx_dct_pass(const DctArgs* a, const double* w, const double* b, double* lam, int accumulate,
                             cudaStream_t stream)
{
    const int code = w != nullptr ? dct_factor(a, 1, w, 0, a->inv, a->g, a->Minv, stream) : 0;
    if (code != 0) return code;
    return dct_direct(a, one_scenario(a), a->inv, a->g, a->Minv, b, lam, accumulate, stream);
}

// The same pass on a stored factor (nxfx_dct_factor's inv, g, Minv, which no
// other solve writes): six launches, the same bits as nxfx_dct_pass on the
// factor of the same w.
extern "C" int nxfx_dct_apply(const DctArgs* a, const double* inv, const double* g, const double* Minv,
                              const double* b, double* lam, int accumulate, cudaStream_t stream)
{
    return dct_direct(a, one_scenario(a), inv, g, Minv, b, lam, accumulate, stream);
}

// One pass over S scenarios on b (S, B) into lam (S, B), on S stored factors
// (nxfx_dct_factor_scen's) or, with shared, on one read at stride 0, through
// the stream's scenario scratch sc (capacity at least S): six launches, row
// i the bits of nxfx_dct_apply on row i's factor and b.
extern "C" int nxfx_dct_apply_scen(const DctArgs* a, const DctScen* sc, int S, int shared, const double* inv,
                                   const double* g, const double* Minv, const double* b, double* lam,
                                   int accumulate, cudaStream_t stream)
{
    if (S < 1 || S > sc->capacity) return static_cast<int>(cudaErrorInvalidValue);
    const long long B = a->B, r = a->r;
    const PassBufs p{S, sc->t1, sc->t2, sc->z, sc->partial, sc->sol, sc->tickets,
                     shared ? 0 : B, shared ? 0 : r * B, shared ? 0 : (r + 1) * (r + 1)};
    return dct_direct(a, p, inv, g, Minv, b, lam, accumulate, stream);
}

extern "C" int nxfx_dct_matrix(int n, double scale, double scale0, double* D, cudaStream_t stream)
{
    const size_t total = (size_t)n * n;
    if (total == 0) return 0;
    dct_matrix_kernel<<<blocks_for(total, 256), 256, 0, stream>>>(n, scale, scale0, D);
    return static_cast<int>(cudaGetLastError());
}
