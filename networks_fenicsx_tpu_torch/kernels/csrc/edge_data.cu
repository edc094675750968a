// K8a: element formation and per-edge static condensation of the general
// forest Schur solve.
//
// Replaces networks_fenicsx_tpu/solver.py:_make_edge_data_uniform,
// _make_edge_data_scalar(_k), _make_edge_data and the quadrature einsums of
// the generic `core` of build_schur_executor.  Per edge e of length N h:
//   element formation, per cell c:
//     quad R:  M_c[i][j] = h sum_q R_cq w_q phi_qi phi_qj      (general layout)
//     else:    a_c = R_c h                                      (scalar layouts)
//     F_c = h sum_q f_cq w_q (quad f), f_c h otherwise; 0 when the source is elided
//   condensation, by layout:
//     uniform   a = R_e h, F = f_e h: W = a N, Ftot = F N, g = a F N^2 / 2
//     scalar    W = sum a_c,      g = 1/2 sum a_c (cumF_c + cumF_c+1)
//     scalar_k  W = wt sum a_c,   g = sum a_c (cs0 cumF_c + cs1 cumF_c+1)
//     general   k = 1: mt_c = M_c; k >= 2: Cholesky of the interior block
//               M_II, Minv_IE = M_II^-1 M_IE, mt_c = M_EE - M_EI Minv_IE;
//               W = sum 1^T mt_c 1,  g = sum colsum(mt_c) . (cumF_c, cumF_c+1)
//     cumF_0 = 0, cumF_c+1 = cumF_c + F_c
//   every sum left to right in the order the plain version takes it
//   (quadrature points, then cells), so the two agree to the last bit
//
// Bound: device-memory bytes (the callable tree: R and f 42 MB each, mt
// 84 MB, cumF 21.5 MB).  The outputs are j-major (cell row first, edge
// last); the inputs are the reference's public edge-major arrays.  One
// thread an edge walking its N cells left the card a quarter occupied (one
// chain of N dependent steps a thread) and read the inputs with lanes N.w
// doubles apart (w a cell's doubles of R and f), a cache line a lane.  So
// a tile of 32 consecutive edges, whose per-cell inputs (R, f in cell or
// quad mode) are one run of doubles an edge, is worked by CY warps:
//   - chunks of CN cells (about 64 doubles an edge) are copied into shared
//     memory by cp.async, the tile's threads along its runs (coalesced),
//     STAGES chunks in flight in a ring, so the footprint does not grow
//     with N; rows padded to an odd pitch so that lanes reading one cell of
//     32 edges hit 32 banks;
//   - the warps form the cells in parallel, lanes along the edges:
//     quadrature sums, for k >= 2 the interior Cholesky (its (k-1)^2 factor
//     in shared memory where it fits, else in a device scratch array),
//     Minv_IE and mt; they write mt, minv, rh j-major (a warp one coalesced
//     row) and leave each cell's F and column sums (or a_c) in shared
//     memory;
//   - warp 0 then walks the chunk's cells left to right, an edge a lane,
//     carrying cum, W and g in the old order, and writes cumF j-major.
// Where an edge's inputs are a few doubles (kernels/edge_data.py:
// DIRECT_DOUBLES; the 100k forest at N = 8, a lattice at N = 1: a warp's
// reads stay in a few lines L1 keeps) there is nothing to coalesce and the
// staging's round trip only adds latency: a thread an edge walks its cells
// from device memory (the direct kernel), with the same per-cell and chain
// code.  The host picks the plan
// (kernels/edge_data.py:edge_tile); the launcher recomputes the bytes and
// refuses what the card would.  The uniform layout reads one value an edge:
// a thread an edge.
//
// A sweep (batch.solve_sweep) forms S scenarios' edge data in one launch
// (nxfx_edge_data_scen): the grid's y, min(S, 65,535) rows of blocks, each
// block walking the scenarios y, y + gridDim.y, ...  R and f move by their
// own stride a scenario (0 when every scenario shares one), every output by
// its size; h_e and the Gauss rule are shared.  The plan (layout, tile,
// chunk, warps) is the one-scenario call's, and each scenario runs the
// one-scenario body on its pointers, so its rows are that call's bit for
// bit.  A tile launch's device scratch holds a set a block of the grid.

#include <cuda_runtime.h>

namespace {

constexpr int MODE_SCALAR = 0;
constexpr int MODE_EDGE = 1;
constexpr int MODE_CELL = 2;
constexpr int MODE_QUAD = 3;

constexpr int LAYOUT_UNIFORM = 0;
constexpr int LAYOUT_SCALAR = 1;
constexpr int LAYOUT_SCALAR_K = 2;

constexpr int TILE = 32;             // edges of a tile: a warp's lanes
constexpr int MAX_ROWS = 8;          // warps of a block
constexpr int STAGES = 3;            // chunks in flight: the ring's slots
constexpr int CHAIN = 3;             // doubles a cell and edge left for the chain
constexpr int THREADS = 128;         // the direct and uniform kernels' blocks
constexpr size_t SMEM_MAX = 232448;  // what a block may use on the H100

// What every kernel of a launch reads and writes.
struct EdgeArgs {
    int layout, E, N, k, nq, R_mode, f_mode, elide_f;
    const double* h_e;
    const double* R;
    const double* f;
    const double* wq;    // (nq,) Gauss weights
    const double* phi;   // (nq, k+1) the basis at the Gauss points
    double wt, cs0, cs1;
    double* mt;          // (N, 2, 2, E)            general
    double* minv;        // (N, k-1, 2, E)          general, k >= 2 (read back)
    double* cumF;        // (N+1, E); (1, E) = Ftot uniform
    double* W;
    double* g;
    double* rh;          // (N, E)                  scalar layouts
    double* ua;          // (E,)                    uniform
    double* uF;
    // scenarios: S, and the doubles between two scenarios' R, f, mt, minv,
    // cumF, (E,) outputs (W, g, ua, uF) and rh (0: shared or unused)
    int S;
    long long zR, zF, zmt, zminv, zcumF, zE, zrh;
};

// Scenario z's arguments.
__device__ __forceinline__ EdgeArgs at_scenario(EdgeArgs a, int z)
{
    const size_t Z = static_cast<size_t>(z);
    a.R += Z * a.zR;
    a.f += Z * a.zF;
    a.mt += Z * a.zmt;
    a.minv += Z * a.zminv;
    a.cumF += Z * a.zcumF;
    a.W += Z * a.zE;
    a.g += Z * a.zE;
    a.ua += Z * a.zE;
    a.uF += Z * a.zE;
    a.rh += Z * a.zrh;
    return a;
}

// A tile launch's plan: the chunk's cells, a cell's staged doubles of R
// and f (0: read from device memory) and their rows' pitches, and where
// the interior factor lives.
struct TilePlan {
    int CN, wR, pR, wF, pF, shared_scratch;
};

__device__ __forceinline__ void copy8(double* dst, const double* src)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// every copy group of this thread but the newest STAGES - 1 has landed
__device__ __forceinline__ void wait_older()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The shared doubles of one tile (kernels/edge_data.py:edge_tile counts the
// same bytes).
__host__ __device__ inline long long tile_doubles(int k, int CY, const TilePlan& t)
{
    const long long n = k - 1;
    return static_cast<long long>(STAGES) * TILE * (t.pR + t.pF)
           + static_cast<long long>(CHAIN) * t.CN * TILE + (t.shared_scratch ? n * n * TILE * CY : 0);
}

__global__ void edge_uniform_kernel(EdgeArgs a0)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= a0.E) return;
    for (int z = blockIdx.y; z < a0.S; z += gridDim.y) {
    const EdgeArgs a = at_scenario(a0, z);
    const double h = a.h_e[e];
    const double dN = static_cast<double>(a.N);
    const double ra = (a.R_mode == MODE_SCALAR ? a.R[0] : a.R[e]) * h;
    const double F = (a.f_mode == MODE_SCALAR ? a.f[0] : a.f[e]) * h;
    a.W[e] = ra * dN;
    a.g[e] = ra * F * (dN * dN / 2.0);
    a.cumF[e] = F * dN;
    a.ua[e] = ra;
    a.uF[e] = F;
    }
}

// A coefficient of cell cg (public index e N + c) of edge e: from its staged
// doubles (`staged`, non-null) or from device memory; quad mode gives its
// Gauss sum.
__device__ __forceinline__ double cell_value(
    const double* __restrict__ src, int mode, const double* staged, int e, size_t cg, int nq,
    const double* __restrict__ wq)
{
    if (mode == MODE_SCALAR) return src[0];
    if (mode == MODE_EDGE) return src[e];
    const double* p = staged != nullptr ? staged : src + cg * (mode == MODE_QUAD ? nq : 1);
    if (mode == MODE_CELL) return p[0];
    double s = 0.0;
    for (int q = 0; q < nq; ++q) s += p[q] * wq[q];
    return s;
}

// Cell c of edge e: writes rh (scalar layouts) or mt and minv (general),
// and returns what the chain needs: F_c, and a_c or the column sums of mt_c
// (v1, v2).  sR, sF: the cell's staged R and f (or null); L(i, j) of the
// interior factor at L[(i n + j) Ls].
template <bool GENERAL, bool CHOL>
__device__ __forceinline__ void form_cell(
    const EdgeArgs& a, int e, int c, double h, const double* sR, const double* sF, double* L, size_t Ls,
    double& F, double& v1, double& v2)
{
    const size_t sE = static_cast<size_t>(a.E);
    const size_t cg = static_cast<size_t>(e) * a.N + c;
    F = a.elide_f ? 0.0 : cell_value(a.f, a.f_mode, sF, e, cg, a.nq, a.wq) * h;
    v2 = 0.0;
    if constexpr (!GENERAL) {
        v1 = cell_value(a.R, a.R_mode, sR, e, cg, a.nq, a.wq) * h;
        a.rh[c * sE + e] = v1;
    } else {
        const int k = a.k, nq = a.nq, kk = k + 1;
        const double* Rc = sR != nullptr ? sR : a.R + cg * nq;
        const double* wq = a.wq;
        const double* phi = a.phi;
        auto M = [&](int i, int j) {  // w_q phi_qi phi_qj rounded as the plain version's table
            double s = 0.0;
            for (int q = 0; q < nq; ++q) s += Rc[q] * ((wq[q] * phi[q * kk + i]) * phi[q * kk + j]);
            return s * h;
        };
        double m[2][2];
        if constexpr (!CHOL) {
            for (int i = 0; i < 2; ++i)
                for (int j = 0; j < 2; ++j) m[i][j] = M(i, j);
        } else {
            const int n = k - 1;
            const int ends[2] = {0, k};
            auto Lf = [&](int i, int j) -> double& { return L[(static_cast<size_t>(i) * n + j) * Ls]; };
            for (int j = 0; j < n; ++j) {
                double s = M(1 + j, 1 + j);
                for (int p = 0; p < j; ++p) s -= Lf(j, p) * Lf(j, p);
                const double d = sqrt(s);
                Lf(j, j) = d;
                for (int i = j + 1; i < n; ++i) {
                    double t = M(1 + i, 1 + j);
                    for (int p = 0; p < j; ++p) t -= Lf(i, p) * Lf(j, p);
                    Lf(i, j) = t / d;
                }
            }
            // Minv_IE = M_II^-1 M_IE: forward then backward substitution
            double* X = a.minv + static_cast<size_t>(c) * n * 2 * sE + e;  // X(i, t) at (i * 2 + t) * E
            for (int t = 0; t < 2; ++t) {
                for (int i = 0; i < n; ++i) {
                    double s = M(1 + i, ends[t]);
                    for (int p = 0; p < i; ++p) s -= Lf(i, p) * X[(p * 2 + t) * sE];
                    X[(i * 2 + t) * sE] = s / Lf(i, i);
                }
                for (int i = n - 1; i >= 0; --i) {
                    double s = X[(i * 2 + t) * sE];
                    for (int p = i + 1; p < n; ++p) s -= Lf(p, i) * X[(p * 2 + t) * sE];
                    X[(i * 2 + t) * sE] = s / Lf(i, i);
                }
            }
            for (int r = 0; r < 2; ++r)
                for (int b = 0; b < 2; ++b) {
                    double s = 0.0;
                    for (int i = 0; i < n; ++i) s += M(ends[r], 1 + i) * X[(i * 2 + b) * sE];
                    m[r][b] = M(ends[r], ends[b]) - s;
                }
        }
        double* mc = a.mt + static_cast<size_t>(c) * 4 * sE + e;
        mc[0] = m[0][0];
        mc[sE] = m[0][1];
        mc[2 * sE] = m[1][0];
        mc[3 * sE] = m[1][1];
        v1 = m[0][0] + m[1][0];  // column sums of mt_c
        v2 = m[0][1] + m[1][1];
    }
}

// One step of an edge's chain: cumF_c+1, and W and g carried on.
template <bool GENERAL>
__device__ __forceinline__ double chain_step(
    const EdgeArgs& a, double F, double v1, double v2, double& cum, double& Wacc, double& gacc)
{
    const double next = cum + F;
    if constexpr (!GENERAL) {
        Wacc += v1;
        if (!a.elide_f)
            gacc += a.layout == LAYOUT_SCALAR ? v1 * (cum + next) : v1 * (a.cs0 * cum + a.cs1 * next);
    } else {
        Wacc += v1 + v2;
        gacc += v1 * cum + v2 * next;
    }
    cum = next;
    return next;
}

__device__ __forceinline__ void finish(const EdgeArgs& a, int e, double Wacc, double gacc)
{
    a.W[e] = a.layout == LAYOUT_SCALAR_K ? a.wt * Wacc : Wacc;
    a.g[e] = a.elide_f ? 0.0 : (a.layout == LAYOUT_SCALAR ? 0.5 * gacc : gacc);
}

// short edges: a thread an edge, its cells from device memory (no k >= 2)
template <bool GENERAL>
__global__ void __launch_bounds__(THREADS) edge_direct_kernel(EdgeArgs a0)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= a0.E) return;
    for (int z = blockIdx.y; z < a0.S; z += gridDim.y) {
    const EdgeArgs a = at_scenario(a0, z);
    const size_t sE = static_cast<size_t>(a.E);
    const double h = a.h_e[e];
    double cum = 0.0, Wacc = 0.0, gacc = 0.0, F, v1, v2;
    a.cumF[e] = 0.0;
    for (int c = 0; c < a.N; ++c) {
        form_cell<GENERAL, false>(a, e, c, h, nullptr, nullptr, nullptr, 0, F, v1, v2);
        a.cumF[(c + 1) * sE + e] = chain_step<GENERAL>(a, F, v1, v2, cum, Wacc, gacc);
    }
    finish(a, e, Wacc, gacc);
    }
}

// The runs of cells [c0, c0 + cn) of the tile's ne edges from `src` (w
// doubles a cell) into `dst` (rows `pitch` doubles apart), the tile's
// threads along the runs.
__device__ __forceinline__ void copy_runs(
    const double* src, int w, int pitch, double* dst, int e0, int ne, int N, int c0, int cn, int tid,
    int nthreads)
{
    if (w == 0) return;
    const unsigned run = static_cast<unsigned>(cn * w), total = static_cast<unsigned>(ne) * run;
    const double* base = src + (static_cast<size_t>(e0) * N + c0) * w;
    const size_t stride = static_cast<size_t>(N) * w;
    for (unsigned i = tid; i < total; i += nthreads) {
        const unsigned j = i / run, r = i - j * run;
        copy8(dst + j * pitch + r, base + j * stride + r);
    }
}

// A tile of TILE edges a block of (TILE, CY) threads.  Shared memory, in
// doubles (tile_doubles): STAGES x TILE x pR staged R rows, STAGES x TILE x
// pF staged f rows, CHAIN x CN x TILE chain inputs, and (shared_scratch)
// (k-1)^2 a thread.
// GENERAL: the general layout (else the scalar ones); CHOL: its k >= 2.
template <bool GENERAL, bool CHOL>
__global__ void __launch_bounds__(TILE * MAX_ROWS) edge_tile_kernel(EdgeArgs a0, TilePlan t, double* work)
{
    extern __shared__ __align__(16) double smem[];
    for (int z = blockIdx.y; z < a0.S; z += gridDim.y) {
    __syncthreads();  // the previous scenario's tile is done with shared memory
    const EdgeArgs a = at_scenario(a0, z);
    const int lane = threadIdx.x, row = threadIdx.y, CY = blockDim.y;
    const int tid = row * TILE + lane, nthreads = TILE * CY;
    const int e0 = blockIdx.x * TILE;
    const int ne = min(TILE, a.E - e0);  // the last tile's may be fewer
    const int e = e0 + lane;
    const bool live = lane < ne;
    const int N = a.N, CN = t.CN;
    double* sR = smem;                             // [STAGES][TILE][pR]
    double* sF = sR + STAGES * TILE * t.pR;        // [STAGES][TILE][pF]
    double* sC = sF + STAGES * TILE * t.pF;        // [CHAIN][CN][TILE]
    const size_t sE = static_cast<size_t>(a.E);
    double* L = nullptr;   // the thread's interior factor, L(i, j) at ((i n + j) Ls)
    size_t Ls = 0;
    if constexpr (CHOL) {
        if (t.shared_scratch) {
            L = sC + CHAIN * CN * TILE + tid;
            Ls = static_cast<size_t>(nthreads);
        } else {  // a set a block of the grid
            L = work + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * nthreads + tid;
            Ls = static_cast<size_t>(gridDim.x) * gridDim.y * nthreads;
        }
    }
    const double h = live ? a.h_e[e] : 0.0;
    const int chunks = (N + CN - 1) / CN;

    // chunk ch's staged runs into its ring slot
    auto stage = [&](int ch) {
        const int c0 = ch * CN, cn = min(CN, N - c0), slot = ch % STAGES;
        copy_runs(a.R, t.wR, t.pR, sR + slot * TILE * t.pR, e0, ne, N, c0, cn, tid, nthreads);
        copy_runs(a.f, t.wF, t.pF, sF + slot * TILE * t.pF, e0, ne, N, c0, cn, tid, nthreads);
        commit();
    };

    // a group a slot, empty past the last chunk: at its wait chunk ch is
    // always followed by STAGES - 1 newer groups
    for (int ch = 0; ch < STAGES; ++ch) {
        if (ch < chunks)
            stage(ch);
        else
            commit();
    }
    double cum = 0.0, Wacc = 0.0, gacc = 0.0;
    if (row == 0 && live) a.cumF[e] = 0.0;
    for (int ch = 0; ch < chunks; ++ch) {
        const int c0 = ch * CN, cn = min(CN, N - c0), slot = ch % STAGES;
        wait_older();
        __syncthreads();
        const double* rowR = sR + (slot * TILE + lane) * t.pR;
        const double* rowF = sF + (slot * TILE + lane) * t.pF;
        if (live) {
            for (int c = row; c < cn; c += CY) {
                double F, v1, v2;
                form_cell<GENERAL, CHOL>(a, e, c0 + c, h, t.wR > 0 ? rowR + c * t.wR : nullptr,
                                         t.wF > 0 ? rowF + c * t.wF : nullptr, L, Ls, F, v1, v2);
                sC[c * TILE + lane] = F;
                sC[(CN + c) * TILE + lane] = v1;
                sC[(2 * CN + c) * TILE + lane] = v2;
            }
        }
        __syncthreads();
        // the slot is read: refill it with chunk ch + STAGES while the chain runs
        if (ch + STAGES < chunks)
            stage(ch + STAGES);
        else
            commit();
        if (row == 0 && live) {
            for (int c = 0; c < cn; ++c)
                a.cumF[(c0 + c + 1) * sE + e] = chain_step<GENERAL>(
                    a, sC[c * TILE + lane], sC[(CN + c) * TILE + lane], sC[(2 * CN + c) * TILE + lane],
                    cum, Wacc, gacc);
        }
    }
    wait_all();
    if (row == 0 && live) finish(a, e, Wacc, gacc);
    }
}

}  // namespace

namespace {

// The launch of a (S scenarios, gy rows of blocks; the tile kernels'
// device scratch holds gy sets).
int launch_edge_data(const EdgeArgs& a, int CN, int CY, int wR, int pR, int wF, int pF, int shared_scratch,
                     double* work, int gy, cudaStream_t stream)
{
    const int E = a.E, N = a.N, k = a.k, layout = a.layout;
    if (E <= 0 || a.S <= 0) return 0;
    if (gy < 1 || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const bool general = layout > LAYOUT_SCALAR_K;
    if (layout == LAYOUT_UNIFORM) {
        edge_uniform_kernel<<<dim3((E + THREADS - 1) / THREADS, gy), THREADS, 0, stream>>>(a);
        return static_cast<int>(cudaGetLastError());
    }
    if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (CY == 0) {
        if (general && k >= 2) return static_cast<int>(cudaErrorInvalidValue);
        auto kernel = general ? edge_direct_kernel<true> : edge_direct_kernel<false>;
        kernel<<<dim3((E + THREADS - 1) / THREADS, gy), THREADS, 0, stream>>>(a);
        return static_cast<int>(cudaGetLastError());
    }
    const TilePlan t{CN, wR, pR, wF, pF, shared_scratch};
    if (CN < 1 || CY < 1 || CY > MAX_ROWS || wR < 0 || wF < 0 || pR < wR * CN || pF < wF * CN
        || (!shared_scratch && general && k >= 2 && work == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long bytes = 8 * tile_doubles(k, CY, t);
    if (bytes > static_cast<long long>(SMEM_MAX)) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = !general ? edge_tile_kernel<false, false>
                           : (k == 1 ? edge_tile_kernel<true, false> : edge_tile_kernel<true, true>);
    if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3((E + TILE - 1) / TILE, gy), dim3(TILE, CY), static_cast<size_t>(bytes), stream>>>(a, t, work);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8a's one launch.  The plan: CY == 0 a thread an edge (the direct
// kernel; not for the general layout at k >= 2), else tiles of CY warps,
// chunks of CN cells.
extern "C" int nxfx_edge_data(
    int layout, int E, int N, int k, int nq, int CN, int CY, int wR, int pR, int wF, int pF,
    int shared_scratch,
    const double* h_e, const double* R, int R_mode, const double* f, int f_mode, int elide_f,
    const double* wq, const double* phi, double wt, double cs0, double cs1,
    double* mt, double* minv, double* work, double* cumF, double* W, double* g,
    double* rh, double* ua, double* uF,
    cudaStream_t stream)
{
    const EdgeArgs a{layout, E, N, k, nq, R_mode, f_mode, elide_f, h_e, R, f, wq, phi, wt, cs0, cs1,
                     mt, minv, cumF, W, g, rh, ua, uF, 1, 0, 0, 0, 0, 0, 0, 0};
    return launch_edge_data(a, CN, CY, wR, pR, wF, pF, shared_scratch, work, 1, stream);
}

// K8a of S scenarios in one launch (gy rows of blocks, each walking the
// scenarios y, y + gy, ...): the one-scenario arguments (the first
// scenario's pointers), then S, gy and the strides of R and f (0: shared);
// every output (S,) + its one-scenario shape, the scratch gy sets.
extern "C" int nxfx_edge_data_scen(
    int layout, int E, int N, int k, int nq, int CN, int CY, int wR, int pR, int wF, int pF,
    int shared_scratch,
    const double* h_e, const double* R, int R_mode, const double* f, int f_mode, int elide_f,
    const double* wq, const double* phi, double wt, double cs0, double cs1,
    double* mt, double* minv, double* work, double* cumF, double* W, double* g,
    double* rh, double* ua, double* uF,
    int S, int gy, long long zR, long long zF,
    cudaStream_t stream)
{
    const long long sE = E, sN = N;
    const bool uniform = layout == LAYOUT_UNIFORM, general = layout > LAYOUT_SCALAR_K;
    const EdgeArgs a{layout, E, N, k, nq, R_mode, f_mode, elide_f, h_e, R, f, wq, phi, wt, cs0, cs1,
                     mt, minv, cumF, W, g, rh, ua, uF, S, zR, zF,
                     general ? sN * 4 * sE : 0, general && k > 1 ? sN * (k - 1) * 2 * sE : 0,
                     (uniform ? 1 : sN + 1) * sE, sE, !uniform && !general ? sN * sE : 0};
    return launch_edge_data(a, CN, CY, wR, pR, wF, pF, shared_scratch, work, gy, stream);
}
