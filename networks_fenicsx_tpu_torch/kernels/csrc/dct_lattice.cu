// K16: the separable-DCT capacitance solve of a uniform scalar-R lattice.
//
// Replaces networks_fenicsx_tpu/solver.py:_dct_capacitance_factor,
// _dct_capacitance_apply, _dct2_matrix_device and _dct_lattice_solve.
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
// 1.07 GFLOP, against ~8 MB of traffic.  The product is a shared-memory
// tiled GEMM: a 32 x 64 output tile per 128-thread block, 16-deep k slabs of
// op(A) and op(B) staged in shared memory (padded by one double against bank
// conflicts, loaded along the contiguous axis of either layout, the next
// slab fetched into registers while the current one is multiplied), each
// thread a 4 x 4 register block with explicit fma (the library builds with
// -fmad=false).  A 512^2 product has only 128 such tiles for 132 SMs, so
// the k range is split over up to 8 blocks per tile (about four resident
// blocks per SM) and a second launch adds the partial products in order.
// The eigenvalue scaling is the second product's epilogue.  The shared
// tiles are written and read by different threads across __syncthreads(),
// so nothing aliases them through __restrict__.  The bordered matrix
// (r + 1 <= 17) is inverted in one block by Gauss-Jordan with partial
// pivoting, in float64; sum b is a two-stage reduction.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int GEMM_THREADS = 128;  // 16 x 8 threads, 4 x 4 outputs each
constexpr int MAX_BORDER = 17;     // r + 1 for at most 16 stub rows
constexpr int BORDER_BLOCKS = 1024;  // first-stage blocks of the sum of b

// C (M, N) = op(A) (M, K) op(B) (K, N) [o S], all row-major.  op(A) = A
// stored (M, K), or A^T with A stored (K, M) when transA; likewise op(B) = B
// stored (K, N), or B^T with B stored (N, K).  Block z of a split-K launch
// sums k in [z kchunk, (z + 1) kchunk) into its slice of `partial`
// (split, M, N); dct_splitk_reduce_kernel adds the slices in order.  The
// next slab's global loads are issued into registers before the current
// slab is multiplied, so they overlap the arithmetic.
__global__ void __launch_bounds__(GEMM_THREADS) dct_gemm_kernel(
    int M, int N, int K, int kchunk,
    const double* __restrict__ A, int transA,
    const double* __restrict__ Bm, int transB,
    const double* __restrict__ S,
    double* __restrict__ C,
    double* __restrict__ partial)
{
    constexpr int A_PER = BM * BK / GEMM_THREADS;  // 4
    constexpr int B_PER = BK * BN / GEMM_THREADS;  // 8
    __shared__ double As[BK][BM + 1];
    __shared__ double Bs[BK][BN + 1];
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    const int k_begin = blockIdx.z * kchunk;
    const int k_end = min(K, k_begin + kchunk);
    double acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;

    double ra[A_PER], rb[B_PER];
    auto load = [&](int k0) {
#pragma unroll
        for (int u = 0; u < A_PER; ++u) {
            const int idx = tid + u * GEMM_THREADS;
            int m, k;
            if (transA) { k = idx / BM; m = idx % BM; } else { m = idx / BK; k = idx % BK; }
            const int gm = m0 + m, gk = k0 + k;
            ra[u] = (gm < M && gk < k_end)
                        ? (transA ? A[(size_t)gk * M + gm] : A[(size_t)gm * K + gk]) : 0.0;
        }
#pragma unroll
        for (int u = 0; u < B_PER; ++u) {
            const int idx = tid + u * GEMM_THREADS;
            int k, n;
            if (transB) { n = idx / BK; k = idx % BK; } else { k = idx / BN; n = idx % BN; }
            const int gk = k0 + k, gn = n0 + n;
            rb[u] = (gk < k_end && gn < N)
                        ? (transB ? Bm[(size_t)gn * K + gk] : Bm[(size_t)gk * N + gn]) : 0.0;
        }
    };
    if (k_begin < k_end) load(k_begin);
    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
        for (int u = 0; u < A_PER; ++u) {
            const int idx = tid + u * GEMM_THREADS;
            if (transA) As[idx / BM][idx % BM] = ra[u]; else As[idx % BK][idx / BK] = ra[u];
        }
#pragma unroll
        for (int u = 0; u < B_PER; ++u) {
            const int idx = tid + u * GEMM_THREADS;
            if (transB) Bs[idx % BK][idx / BK] = rb[u]; else Bs[idx / BN][idx % BN] = rb[u];
        }
        __syncthreads();
        if (k0 + BK < k_end) load(k0 + BK);
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            double a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 8 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
    double* out = partial ? partial + (size_t)blockIdx.z * M * N : C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gm = m0 + ty + 8 * i;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gn = n0 + tx + 16 * j;
            if (gn >= N) continue;
            const size_t o = (size_t)gm * N + gn;
            out[o] = (partial == nullptr && S) ? acc[i][j] * S[o] : acc[i][j];
        }
    }
}

// C = (sum over z of partial[z]) [o S], the slices added in order
__global__ void dct_splitk_reduce_kernel(
    size_t MN, int split,
    const double* __restrict__ partial, const double* __restrict__ S, double* __restrict__ C)
{
    const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (o >= MN) return;
    double v = partial[o];
    for (int z = 1; z < split; ++z) v += partial[(size_t)z * MN + o];
    C[o] = S ? v * S[o] : v;
}

// inv (ny, s) and g = kappa g_geo (r, B), one element per thread
__global__ void dct_scale_kernel(
    int s, int ny, int r, int B,
    const double* __restrict__ w, int rep_x, int rep_y, double len_x,
    const double* __restrict__ lamx, const double* __restrict__ lamy,
    const double* __restrict__ g_geo,
    double* __restrict__ inv, double* __restrict__ g)
{
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const double wx = w[rep_x];
    const double wy = w[rep_y];
    if (i < (size_t)ny * s) {
        const int row = (int)(i / s), col = (int)(i % s);
        const double sym = wx * lamx[col] + wy * lamy[row];
        inv[i] = sym > 0.0 ? 1.0 / sym : 0.0;
    }
    if (i < (size_t)r * B) {
        const double kappa = 1.0 / (wx * len_x);
        g[i] = kappa * g_geo[i];
    }
}

// w_r, the bordered matrix M and its inverse, in one block
__global__ void dct_minv_kernel(
    int r, int n_stub, int B,
    const double* __restrict__ w,
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

// per-block partial sums of b (grid-stride), the first stage of sum b
__global__ void dct_sum_kernel(int B, const double* __restrict__ b, double* __restrict__ partial)
{
    __shared__ double part[256];
    double acc = 0.0;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B; i += gridDim.x * blockDim.x)
        acc += b[i];
    part[threadIdx.x] = acc;
    __syncthreads();
    for (int half = blockDim.x / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) part[threadIdx.x] = part[threadIdx.x] + part[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0) partial[blockIdx.x] = part[0];
}

// sol = Minv [z[rows], sum b], in one block, from the m partial sums of b
__global__ void dct_border_kernel(
    int m, int r,
    const double* __restrict__ partial, const double* __restrict__ z,
    const int* __restrict__ stub_rows, const double* __restrict__ Minv,
    double* __restrict__ sol)
{
    __shared__ double part[1024];
    const int tid = threadIdx.x;
    double acc = 0.0;
    for (int i = tid; i < m; i += blockDim.x) acc += partial[i];
    part[tid] = acc;
    __syncthreads();
    for (int half = blockDim.x / 2; half > 0; half /= 2) {
        if (tid < half) part[tid] = part[tid] + part[tid + half];
        __syncthreads();
    }
    const int n = r + 1;
    if (tid < n) {
        double v = 0.0;
        for (int j = 0; j < n; ++j) {
            const double vj = j < r ? z[stub_rows[j]] : part[0];
            v += Minv[tid * n + j] * vj;
        }
        sol[tid] = v;
    }
}

// out = (z - sum_t sol_t g_t) + sol_r, plus lam_in when refining
__global__ void dct_correct_kernel(
    int B, int r,
    const double* __restrict__ z, const double* __restrict__ g,
    const double* __restrict__ sol, const double* __restrict__ lam_in,
    double* __restrict__ lam_out)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    double corr = sol[0] * g[i];
    for (int t = 1; t < r; ++t) corr += sol[t] * g[(size_t)t * B + i];
    const double v = (z[i] - corr) + sol[r];
    lam_out[i] = lam_in ? lam_in[i] + v : v;
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

// split > 1: work holds split M N doubles for the partial products
extern "C" int nxfx_dct_gemm(
    int M, int N, int K,
    const double* A, int transA, const double* B, int transB,
    const double* S, double* C, int split, double* work, cudaStream_t stream)
{
    if (M <= 0 || N <= 0) return 0;
    if (split < 1 || (split > 1 && work == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    const int kchunk = ((K + split - 1) / split + BK - 1) / BK * BK;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
    dct_gemm_kernel<<<grid, GEMM_THREADS, 0, stream>>>(
        M, N, K, kchunk, A, transA, B, transB, S, C, split > 1 ? work : nullptr);
    int code = static_cast<int>(cudaGetLastError());
    if (code != 0 || split == 1) return code;
    const size_t MN = (size_t)M * N;
    dct_splitk_reduce_kernel<<<blocks_for(MN, 256), 256, 0, stream>>>(MN, split, work, S, C);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_dct_scale(
    int s, int ny, int r, int B,
    const double* w, int rep_x, int rep_y, double len_x,
    const double* lamx, const double* lamy, const double* g_geo,
    double* inv, double* g, cudaStream_t stream)
{
    const size_t n = (size_t)ny * s > (size_t)r * B ? (size_t)ny * s : (size_t)r * B;
    if (n == 0) return 0;
    dct_scale_kernel<<<blocks_for(n, 256), 256, 0, stream>>>(
        s, ny, r, B, w, rep_x, rep_y, len_x, lamx, lamy, g_geo, inv, g);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_dct_minv(
    int r, int n_stub, int B, const double* w,
    const int* stub_edge, const int* stub_group, const int* stub_rows,
    const double* g, double* Minv, cudaStream_t stream)
{
    if (r < 1 || r + 1 > MAX_BORDER) return static_cast<int>(cudaErrorInvalidValue);
    dct_minv_kernel<<<1, 2 * MAX_BORDER * 4, 0, stream>>>(
        r, n_stub, B, w, stub_edge, stub_group, stub_rows, g, Minv);
    return static_cast<int>(cudaGetLastError());
}

// partial holds BORDER_BLOCKS doubles
extern "C" int nxfx_dct_border(
    int B, int r, const double* b, const double* z,
    const int* stub_rows, const double* Minv, double* partial, double* sol, cudaStream_t stream)
{
    const int m = blocks_for((size_t)B, 256) < BORDER_BLOCKS ? blocks_for((size_t)B, 256)
                                                              : BORDER_BLOCKS;
    dct_sum_kernel<<<m, 256, 0, stream>>>(B, b, partial);
    int code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
    dct_border_kernel<<<1, 1024, 0, stream>>>(m, r, partial, z, stub_rows, Minv, sol);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_dct_correct(
    int B, int r, const double* z, const double* g, const double* sol,
    const double* lam_in, double* lam_out, cudaStream_t stream)
{
    if (B <= 0) return 0;
    dct_correct_kernel<<<blocks_for((size_t)B, 256), 256, 0, stream>>>(
        B, r, z, g, sol, lam_in, lam_out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_dct_matrix(int n, double scale, double scale0, double* D, cudaStream_t stream)
{
    const size_t total = (size_t)n * n;
    if (total == 0) return 0;
    dct_matrix_kernel<<<blocks_for(total, 256), 256, 0, stream>>>(n, scale, scale0, D);
    return static_cast<int>(cudaGetLastError());
}
