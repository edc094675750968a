// K19a: the conjugate-gradient steps, the Chebyshev start and the Jacobi
// apply of the iterative λ solve.
//
// Replaces networks_fenicsx_tpu/ops/krylov.py:cg and the elementwise parts
// of chebyshev_preconditioner.  The reference runs CG inside one
// lax.while_loop; here the host launches the iterations and the loop state
// stays on the device in eight doubles,
//   st = [gamma, tol, done, k, maxiter, alpha, beta, ||r||],
// so that no iteration reads anything back.  The kernels that update x and
// r test `done` first and leave x, r, k and every scalar as they are once
// it is set; the step that updates r sets it by the reference's rule, done
// = !(k < maxiter && ||r|| > tol).  The host reads `done` once per chunk of
// iterations, and the iteration count is exactly the per-iteration rule's.
//
// One CG iteration, around the caller's matvec, on a CgArgs that the host
// packs once a solve (the vectors, the state, the partials and a ticket):
//   cg_alpha:    p.Ap; the last block to finish writes alpha = gamma / p.Ap
//   cg_advance:  x += alpha p, r -= alpha Ap and the partials of ||r||^2;
//                the last block writes k += 1, ||r|| and done.  With the
//                Jacobi preconditioner (diag given) also z = r / diag and
//                the partials of r.z, and the last block, unless done,
//                beta = r.z / gamma and gamma = r.z
//   cg_beta:     (another preconditioner, z = M r from the host) r.z, beta
//                and gamma, finished by the last block
//   cg_direction: p = z + beta p (with Jacobi the z the update stored)
// so an iteration is 3 launches with Jacobi and 4 with another
// preconditioner, 13 vector passes with Jacobi.  Every dot product and
// norm is a tree over chunks of 256 entries, then the chunk sums strided by
// 256 threads and a tree: the order of the block-a-chunk kernels and a
// separate finishing launch, so no float64 atomics and the same bits from
// run to run.  A warp owns a chunk (8 entries a lane, the tree in
// registers and shuffles), so each thread has 8 loads of each vector in
// flight and a launch is a few waves of blocks: with one entry a thread,
// the blocks' serial latency (state read, tree, fence, ticket) over ~16
// waves held the update at half the memory rate.  The last block of the
// launch (a ticket, as in ticket_norm.cuh) finishes the sums and puts the
// ticket back to 0, so two solves on two streams (each with its own
// scratch) and CUDA-graph replays give the same bits.  Partials are written
// by one block and read by another: no __restrict__, fenced by their
// writers, read past L1 (__ldcg).

// K19e, MINRES (networks_fenicsx_tpu/ops/krylov.py:minres, 120-224): the
// Paige-Saunders recurrence of the reference line for line, its loop state
// in the 17 doubles of `ms` (see MinresSlot) and driven like CG.  Around the
// caller's matvec yv = A v, one iteration is
//   Lanczos:   yv -= (beta/oldb) r1 when k >= 2 (k counted from 1),
//              alfa = v.yv, yv -= (alfa/beta) r2;
//   Jacobi:    y = yv / d;
//   rotation:  beta' = sqrt(max(yv.y, 0)), delta, gbar, epsln, dbar,
//              gamma = max(|(gbar, beta')|, eps), cs, sn, phi, phibar,
//              k += 1, done = !(k < maxiter && |phibar| > tol);
//   update:    w1 = (v - oldeps w - delta w2) / gamma, x += phi w1, w1 into
//              w's buffer, and the next v = y / beta' (1 for a beta' that is
//              not > 0).
// Up to CLUSTER_CHUNKS chunks of 256 entries (n <= 8,192) a cluster of 8
// CTAs runs the whole iteration with Jacobi in one launch
// (minres_cluster_kernel): a warp owns a chunk, 8 entries a lane, its sum in
// the block tree's order in registers and shuffles, read by every CTA
// through distributed shared memory, so the bits are the multi-block
// kernels'.  One CTA took ~12 us an iteration on an H100 (the bytes of 12
// vectors through one SM), against ~8.5 for the cluster and ~9.5 for the
// ticketed launches at n = 2,422.  Above that, three ticket-finished
// launches.  Another preconditioner splits the iteration
// at y = M yv, which the host computes: 2 launches, else 4.  The host
// rotates the buffers (r1 <- r2 <- yv, w <- w2 <- w1).
// Every kernel of an iteration that starts with `done` set leaves
// everything as it is (the update reads `active`, which the rotation sets),
// so the host may launch a chunk of iterations between two reads of the
// flag.
//
// Bound: device-memory bytes, every vector read or written once per step
// (CG with Jacobi: 13 vectors an iteration besides the matvec).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// One CG solve's vectors and scratch, packed by the host once a solve.
// part holds 3 nblk partials (p.Ap | r.r | r.z), then the ticket word.
struct CgArgs {
    int n, nblk;
    double* x;
    double* r;
    double* p;
    double* z;           // Jacobi's z = r / diag (with diag)
    const double* diag;  // Jacobi's diagonal, or null: another preconditioner
    double* st;
    double* part;
};

// One MINRES solve's fixed vectors and scratch; part as CgArgs's.
struct MinresArgs {
    int n, nblk;
    int one_launch;  // the whole iteration in one cluster launch (nblk <= CLUSTER_CHUNKS)
    double* v;
    double* x;
    const double* d;  // Jacobi's diagonal, or null: another preconditioner
    double* ms;
    double* part;
};

namespace {

constexpr int THREADS = 256;  // a chunk: the entries of one block tree
constexpr int WARPS = THREADS / 32;  // chunks a CG block
constexpr int CLUSTER = 8;  // CTAs of the one-launch MINRES iteration (a portable cluster size)
constexpr int CLUSTER_CHUNKS = 32;  // its chunks at most (n <= 8,192): 4 warps a CTA
enum Slot { GAMMA = 0, TOL = 1, DONE = 2, K = 3, MAXITER = 4, ALPHA = 5, BETA = 6, RNORM = 7 };
enum MinresSlot {
    M_BETA = 0, M_OLDB = 1, M_DBAR = 2, M_EPSLN = 3, M_PHIBAR = 4, M_CS = 5, M_SN = 6, M_TOL = 7,
    M_K = 8, M_MAXITER = 9, M_DONE = 10, M_ALFA = 11, M_OLDEPS = 12, M_DELTA = 13, M_GAMMA = 14,
    M_PHI = 15, M_ACTIVE = 16, M_SLOTS = 17
};
constexpr double EPS = 2.220446049250313e-16;  // float64 machine epsilon

// max(a, b) that propagates a NaN, as jnp.maximum does
__device__ double nan_max(double a, double b) { return (a > b || isnan(a)) ? a : b; }

// Sum of v over the block in a fixed tree order; every thread gets it.
__device__ double block_sum(double v, double* sh)
{
    __syncthreads();
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) sh[threadIdx.x] = sh[threadIdx.x] + sh[threadIdx.x + half];
        __syncthreads();
    }
    return sh[0];
}

// Sum of m partials by one block: strided per thread, then the tree.
__device__ double finish_sum(int m, const double* part, double* sh)
{
    double acc = 0.0;
    for (int j = threadIdx.x; j < m; j += THREADS) acc = acc + part[j];
    return block_sum(acc, sh);
}

// block_sum's tree over 256 entries held by one warp, lane l holding entries
// l + 32 j in t[j]: the pair sums at half = 128, 64, 32 are register pairs
// j, j + 4 / 2 / 1, those at 16 .. 1 lanes l, l + half.  The sum lands in
// lane 0; every lane of the warp calls it.
__device__ double warp_tree(double t[8])
{
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = t[j] + t[j + 4];
#pragma unroll
    for (int j = 0; j < 2; ++j) t[j] = t[j] + t[j + 2];
    double s = t[0] + t[1];
#pragma unroll
    for (int half = 16; half > 0; half /= 2) s = s + __shfl_down_sync(0xffffffffu, s, half);
    return s;
}

// Thread t's share of finish_sum over partials that other blocks of this
// launch wrote: 0.0 + part[t] + part[t + 256] + ... in that order, sixteen
// loads in flight at a time, read past L1.  A batch's missing terms add
// 0.0, which leaves a sum that starts at +0.0 as it is.
__device__ double strided_partials(int m, const double* part)
{
    double acc = 0.0;
    for (int j = threadIdx.x; j < m; j += 16 * THREADS) {
        double v[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = j + k * THREADS < m ? __ldcg(part + j + k * THREADS) : 0.0;
#pragma unroll
        for (int k = 0; k < 16; ++k) acc = acc + v[k];
    }
    return acc;
}

// block_sum's tree over the block's 256 values v, by warp w (its lane 0
// gets the sum); sh holds 256 doubles.  Every thread of the block calls it.
__device__ double tree_by_warp(double v, double* sh, int w)
{
    sh[threadIdx.x] = v;
    __syncthreads();
    double t[8] = {};
    if (static_cast<int>(threadIdx.x >> 5) == w) {
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = sh[(threadIdx.x & 31) + 32 * j];
    }
    return warp_tree(t);
}

// The writers of the block's partials have fenced them: take a ticket.  True
// in every thread of the last block of the launch, which may then read all
// of them.  Every thread of the block calls it.
__device__ bool last_block(unsigned int* ticket)
{
    __shared__ bool last;
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (last) __threadfence();
    return last;
}

__device__ unsigned int* ticket_of(double* part, int nblk)
{
    return reinterpret_cast<unsigned int*>(part + 3 * nblk);
}

__global__ void __launch_bounds__(THREADS) dot_partial_kernel(int n, const double* a, const double* b,
                                                              double* part)
{
    __shared__ double sh[THREADS];
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const double v = i < n ? a[i] * b[i] : 0.0;
    const double s = block_sum(v, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// part = [r.z | b.b | r.r], nblk partials each
__global__ void __launch_bounds__(THREADS) cg_init_kernel(int nblk, const double* part, double rtol,
                                                          double atol, double maxiter, double* st)
{
    __shared__ double sh[THREADS];
    const double rz = finish_sum(nblk, part, sh);
    const double bb = finish_sum(nblk, part + nblk, sh);
    const double rr = finish_sum(nblk, part + 2 * nblk, sh);
    if (threadIdx.x != 0) return;
    const double rb = rtol * sqrt(bb);
    const double tol = (rb > atol || isnan(rb)) ? rb : atol;  // max, NaN propagating
    const double rnorm = sqrt(rr);
    st[GAMMA] = rz;
    st[TOL] = tol;
    st[K] = 0.0;
    st[MAXITER] = maxiter;
    st[ALPHA] = 0.0;
    st[BETA] = 0.0;
    st[RNORM] = rnorm;
    st[DONE] = (0.0 < maxiter && rnorm > tol) ? 0.0 : 1.0;
}

// The CG kernels: warp w of block b owns chunk c = 8 b + w of 256 entries,
// lane l its entries c 256 + l + 32 j (j < 8; a warp's load of one j is
// 256 contiguous bytes), and sums the chunk in block_sum's order
// (warp_tree), so a chunk's partial is the one-entry-a-thread kernel's.
// Each thread issues its loads before it reads `done`.
__device__ int chunk_of() { return blockIdx.x * WARPS + static_cast<int>(threadIdx.x >> 5); }

__device__ int chunk_base(int c) { return c * THREADS + static_cast<int>(threadIdx.x & 31); }

// The warp's chunk sum of u.v into part[c], fenced for the last block.
__device__ void chunk_dot(int n, int nblk, const double* u, const double* v, double* part)
{
    const int c = chunk_of(), base = chunk_base(c);
    double t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int i = base + 32 * j;
        t[j] = i < n ? u[i] * v[i] : 0.0;
    }
    const double s = warp_tree(t);
    if ((threadIdx.x & 31) == 0 && c < nblk) {
        part[c] = s;
        __threadfence();
    }
}

// alpha = gamma / p.Ap
__global__ void __launch_bounds__(THREADS) cg_alpha_kernel(CgArgs a, const double* ap)
{
    double* st = a.st;
    chunk_dot(a.n, a.nblk, a.p, ap, a.part);
    if (st[DONE] != 0.0) return;  // the whole grid alike (the part is scratch)
    unsigned int* ticket = ticket_of(a.part, a.nblk);
    if (!last_block(ticket)) return;
    __shared__ double sh[THREADS];
    const double pap = tree_by_warp(strided_partials(a.nblk, a.part), sh, 0);
    if (threadIdx.x == 0) {
        st[ALPHA] = st[GAMMA] / pap;
        *ticket = 0u;
    }
}

// x += alpha p, r -= alpha Ap, k, ||r||, done; JACOBI: z = r / diag, beta, gamma
template <bool JACOBI>
__global__ void __launch_bounds__(THREADS, 2) cg_advance_kernel(CgArgs a, const double* ap)
{
    double* st = a.st;
    const int c = chunk_of(), base = chunk_base(c), n = a.n;
    double xv[8], pv[8], rv[8], av[8], dv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int i = base + 32 * j;
        xv[j] = pv[j] = rv[j] = av[j] = dv[j] = 0.0;
        if (i < n) {
            xv[j] = a.x[i];
            pv[j] = a.p[i];
            rv[j] = a.r[i];
            av[j] = ap[i];
            if constexpr (JACOBI) dv[j] = a.diag[i];
        }
    }
    const double alpha = st[ALPHA];
    if (st[DONE] != 0.0) return;
    double trr[8], trz[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int i = base + 32 * j;
        double ri = 0.0, zi = 0.0;
        if (i < n) {
            a.x[i] = xv[j] + alpha * pv[j];
            ri = rv[j] - alpha * av[j];
            a.r[i] = ri;
            if constexpr (JACOBI) {
                zi = ri / dv[j];
                a.z[i] = zi;
            }
        }
        trr[j] = ri * ri;
        trz[j] = ri * zi;
    }
    double* prr = a.part + a.nblk;
    double* prz = a.part + 2 * a.nblk;
    const double s_rr = warp_tree(trr);
    const double s_rz = JACOBI ? warp_tree(trz) : 0.0;
    if ((threadIdx.x & 31) == 0 && c < a.nblk) {
        prr[c] = s_rr;
        if constexpr (JACOBI) prz[c] = s_rz;
        __threadfence();
    }
    unsigned int* ticket = ticket_of(a.part, a.nblk);
    if (!last_block(ticket)) return;
    __shared__ double sr[THREADS];
    __shared__ double sz[JACOBI ? THREADS : 1];
    __shared__ double rz_sum;
    const double rr_all = tree_by_warp(strided_partials(a.nblk, prr), sr, 0);
    if constexpr (JACOBI) {
        const double rz = tree_by_warp(strided_partials(a.nblk, prz), sz, 1);
        if (threadIdx.x == 32) rz_sum = rz;
        __syncthreads();
    }
    if (threadIdx.x != 0) return;
    const double k = st[K] + 1.0;
    const double rnorm = sqrt(rr_all);
    const bool done = !(k < st[MAXITER] && rnorm > st[TOL]);
    st[K] = k;
    st[RNORM] = rnorm;
    st[DONE] = done ? 1.0 : 0.0;
    if (JACOBI && !done) {
        st[BETA] = rz_sum / st[GAMMA];
        st[GAMMA] = rz_sum;
    }
    *ticket = 0u;
}

// r.z, beta = r.z / gamma, gamma = r.z (z = M r from the host)
__global__ void __launch_bounds__(THREADS) cg_beta_kernel(CgArgs a, const double* z)
{
    double* st = a.st;
    double* prz = a.part + 2 * a.nblk;
    chunk_dot(a.n, a.nblk, a.r, z, prz);
    if (st[DONE] != 0.0) return;
    unsigned int* ticket = ticket_of(a.part, a.nblk);
    if (!last_block(ticket)) return;
    __shared__ double sh[THREADS];
    const double g = tree_by_warp(strided_partials(a.nblk, prz), sh, 0);
    if (threadIdx.x == 0) {
        st[BETA] = g / st[GAMMA];
        st[GAMMA] = g;
        *ticket = 0u;
    }
}

// p = z + beta p (z stored by the Jacobi update, or the host's z = M r).
// Storing z and reading it here measured 3 us an iteration faster on the
// p1tree on an H100 than reading r and diag again (the same bytes).
__global__ void __launch_bounds__(THREADS) cg_direction_kernel(CgArgs a, const double* z)
{
    const double* st = a.st;
    const int base = chunk_base(chunk_of()), n = a.n;
    double zv[8], pv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int i = base + 32 * j;
        zv[j] = pv[j] = 0.0;
        if (i < n) {
            pv[j] = a.p[i];
            zv[j] = z[i];
        }
    }
    const double beta = st[BETA];
    if (st[DONE] != 0.0) return;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int i = base + 32 * j;
        if (i < n) a.p[i] = zv[j] + beta * pv[j];
    }
}

// rs = s r, dvec = x = rs / theta; with z: z = s x (+ base)
__global__ void __launch_bounds__(THREADS) cheb_start_kernel(int n, const double* s, const double* r,
                                                             double theta, double* rs, double* dvec,
                                                             double* x, double* z, const double* base)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const double rsv = s[i] * r[i];
    const double dv = rsv / theta;
    rs[i] = rsv;
    dvec[i] = dv;
    x[i] = dv;
    if (z != nullptr) z[i] = base != nullptr ? base[i] + s[i] * dv : s[i] * dv;
}

__global__ void __launch_bounds__(THREADS) jacobi_kernel(int n, const double* v, const double* diag,
                                                         double* z)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < n) z[i] = v[i] / diag[i];
}

__global__ void __launch_bounds__(THREADS) inv_sqrt_kernel(int n, const double* d, double* s)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < n) s[i] = 1.0 / sqrt(d[i]);
}

// part = [r.y | b.b], nblk partials each
__global__ void __launch_bounds__(THREADS) minres_init_kernel(int nblk, const double* part, double rtol,
                                                              double atol, double maxiter, double* ms)
{
    __shared__ double sh[THREADS];
    const double ry = finish_sum(nblk, part, sh);
    const double bb = finish_sum(nblk, part + nblk, sh);
    if (threadIdx.x != 0) return;
    const double beta1 = sqrt(nan_max(ry, 0.0));
    const double tol = nan_max(rtol * sqrt(bb), atol);
    ms[M_BETA] = beta1;
    ms[M_OLDB] = 0.0;
    ms[M_DBAR] = 0.0;
    ms[M_EPSLN] = 0.0;
    ms[M_PHIBAR] = beta1;
    ms[M_CS] = -1.0;
    ms[M_SN] = 0.0;
    ms[M_TOL] = tol;
    ms[M_K] = 0.0;
    ms[M_MAXITER] = maxiter;
    ms[M_DONE] = (0.0 < maxiter && fabs(beta1) > tol) ? 0.0 : 1.0;
    ms[M_ALFA] = 0.0;
    ms[M_OLDEPS] = 0.0;
    ms[M_DELTA] = 0.0;
    ms[M_GAMMA] = 0.0;
    ms[M_PHI] = 0.0;
    ms[M_ACTIVE] = 0.0;
}

// v = y / beta (1 for a beta that is not > 0)
__global__ void __launch_bounds__(THREADS) minres_v_kernel(int n, const double* ms, const double* y,
                                                           double* v)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const double beta = ms[M_BETA];
    if (i < n) v[i] = y[i] / (beta > 0.0 ? beta : 1.0);
}

// The rotation of one iteration from beta'^2 = yy and alfa on the 17 slots
// of m, by one thread.
__device__ void minres_rotation(double yy, double alfa, double* m)
{
    const double beta = sqrt(nan_max(yy, 0.0));
    const double cs = m[M_CS], sn = m[M_SN], dbar = m[M_DBAR];
    const double oldeps = m[M_EPSLN];
    const double delta = cs * dbar + sn * alfa;
    const double gbar = sn * dbar - cs * alfa;
    const double epsln = sn * beta;
    const double dbar_new = -cs * beta;
    const double gamma = nan_max(sqrt(gbar * gbar + beta * beta), EPS);
    const double cs_new = gbar / gamma;
    const double sn_new = beta / gamma;
    const double phibar = m[M_PHIBAR];
    const double k = m[M_K] + 1.0;
    m[M_ALFA] = alfa;
    m[M_OLDEPS] = oldeps;
    m[M_DELTA] = delta;
    m[M_GAMMA] = gamma;
    m[M_PHI] = cs_new * phibar;
    m[M_PHIBAR] = sn_new * phibar;
    m[M_EPSLN] = epsln;
    m[M_DBAR] = dbar_new;
    m[M_CS] = cs_new;
    m[M_SN] = sn_new;
    m[M_OLDB] = m[M_BETA];
    m[M_BETA] = beta;
    m[M_K] = k;
    m[M_ACTIVE] = 1.0;
    m[M_DONE] = (k < m[M_MAXITER] && fabs(sn_new * phibar) > m[M_TOL]) ? 0.0 : 1.0;
}

// minres_rotation on the state in device memory, by one thread
__device__ void minres_rotate(double yy, double alfa, double* ms)
{
    double m[M_SLOTS];
#pragma unroll
    for (int i = 0; i < M_SLOTS; ++i) m[i] = ms[i];
    minres_rotation(yy, alfa, m);
#pragma unroll
    for (int i = 0; i < M_SLOTS; ++i) ms[i] = m[i];
}

// ---- MINRES in one launch: a cluster of CLUSTER CTAs.  Warp w of CTA q
// owns chunk c = CLUSTER w + q of 256 entries, lane l its entries c 256 + l +
// 32 j, and leaves the chunk's sum (warp_tree) in its CTA's shared memory.
// After one cluster barrier every CTA reads all the chunk sums through
// distributed shared memory and finishes them in finish_sum's order, so
// each has the launch's sum with the multi-block kernels' bits, and runs
// the rotation itself (rank 0 stores it).  A barrier is split: between its
// arrive (release: the chunk sums) and its wait, a CTA issues the loads it
// needs next; the last wait keeps a CTA's sums alive until every CTA has
// read them.  Six whole cluster.sync()s (a sum in rank 0, then its
// broadcast) took 14.5 us an iteration at n = 2,422 on an H100.

__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The launch's sum of the chunk sums sums[w] of every CTA (chunk CLUSTER w +
// q in CTA q), after a cluster barrier; every thread of the CTA gets it.
__device__ double gather_sum(double* sums, int nblk, cg::cluster_group& cluster, double* total)
{
    if (threadIdx.x < 32) {
        double f[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int k = static_cast<int>(threadIdx.x) + 32 * j;
            f[j] = k < nblk ? 0.0 + cluster.map_shared_rank(sums, k % CLUSTER)[k / CLUSTER] : 0.0;
        }
        const double tot = warp_tree(f);
        if (threadIdx.x == 0) *total = tot;
    }
    __syncthreads();
    return *total;
}

// MODE 0: the whole iteration with Jacobi; 1: the Lanczos step (yv, alfa);
// 2: beta', the rotation and the update with y = M yv from the host.
template <int MODE>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(32 * CLUSTER_CHUNKS / CLUSTER)
    minres_cluster_kernel(MinresArgs a, double* yv, const double* r1, const double* r2, const double* y_in,
                          double* w, const double* w2)
{
    constexpr int WMAX = CLUSTER_CHUNKS / CLUSTER;
    cg::cluster_group cluster = cg::this_cluster();
    __shared__ double sums_a[WMAX], sums_b[WMAX], total_a, total_b;
    __shared__ double scal[5];  // oldeps, delta, gamma, phi, beta'
    double* ms = a.ms;
    if (ms[M_DONE] != 0.0) {  // the whole cluster alike
        if (MODE != 1 && cluster.block_rank() == 0 && threadIdx.x == 0) ms[M_ACTIVE] = 0.0;
        return;
    }
    const int n = a.n, nblk = a.nblk, warp = static_cast<int>(threadIdx.x >> 5);
    const int c = warp * CLUSTER + static_cast<int>(cluster.block_rank());
    const int base = c * THREADS + static_cast<int>(threadIdx.x & 31);
    double m[M_SLOTS];  // thread 0: the state as the launch found it
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < M_SLOTS; ++i) m[i] = ms[i];
    }
    double vv[8], yvv[8], yy[8], t[8], r2v[8], dv[8], wv[8], w2v[8], xv[8];
    double alfa = ms[M_ALFA];
    if constexpr (MODE != 2) {
        const double beta = ms[M_BETA];
        const bool second = ms[M_K] + 1.0 >= 2.0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int i = base + 32 * j;
            vv[j] = yvv[j] = t[j] = 0.0;
            if (i < n) {
                double y = yv[i];
                if (second) y = y - (beta / ms[M_OLDB]) * r1[i];
                vv[j] = a.v[i];
                yvv[j] = y;
                t[j] = vv[j] * y;
            }
        }
        const double s = warp_tree(t);
        if ((threadIdx.x & 31) == 0) sums_a[warp] = s;
        cluster_arrive();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int i = base + 32 * j;
            r2v[j] = dv[j] = 0.0;
            if (i < n) {
                r2v[j] = r2[i];
                if constexpr (MODE == 0) dv[j] = a.d[i];
            }
        }
        cluster_wait();
        alfa = gather_sum(sums_a, nblk, cluster, &total_a);
#pragma unroll
        for (int j = 0; j < 8; ++j) yvv[j] = yvv[j] - (alfa / beta) * r2v[j];
        if constexpr (MODE == 1) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int i = base + 32 * j;
                if (i < n) yv[i] = yvv[j];
            }
            if (cluster.block_rank() == 0 && threadIdx.x == 0) ms[M_ALFA] = alfa;
            cluster_arrive();
            cluster_wait();  // no CTA leaves while another may still read its sums
            return;
        }
    } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int i = base + 32 * j;
            vv[j] = i < n ? a.v[i] : 0.0;
            yvv[j] = i < n ? yv[i] : 0.0;
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int i = base + 32 * j;
        yy[j] = 0.0;
        if (i < n) yy[j] = MODE == 0 ? yvv[j] / dv[j] : y_in[i];
        t[j] = i < n ? yvv[j] * yy[j] : 0.0;
    }
    const double s = warp_tree(t);
    if ((threadIdx.x & 31) == 0) sums_b[warp] = s;
    cluster_arrive();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int i = base + 32 * j;
        wv[j] = w2v[j] = xv[j] = 0.0;
        if (i < n) {
            if constexpr (MODE == 0) yv[i] = yvv[j];
            wv[j] = w[i];
            w2v[j] = w2[i];
            xv[j] = a.x[i];
        }
    }
    cluster_wait();
    const double yyd = gather_sum(sums_b, nblk, cluster, &total_b);
    if (threadIdx.x == 0) {
        minres_rotation(yyd, alfa, m);
        scal[0] = m[M_OLDEPS];
        scal[1] = m[M_DELTA];
        scal[2] = m[M_GAMMA];
        scal[3] = m[M_PHI];
        scal[4] = m[M_BETA];
        if (cluster.block_rank() == 0) {
#pragma unroll
            for (int i = 0; i < M_SLOTS; ++i) ms[i] = m[i];
        }
    }
    cluster_arrive();  // this CTA's reads of the others' sums are done
    __syncthreads();
    const double oldeps = scal[0], delta = scal[1], gamma = scal[2], phi = scal[3], bnew = scal[4];
    const double vdiv = bnew > 0.0 ? bnew : 1.0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int i = base + 32 * j;
        if (i < n) {
            const double w1 = (vv[j] - oldeps * wv[j] - delta * w2v[j]) / gamma;
            a.x[i] = xv[j] + phi * w1;
            w[i] = w1;
            a.v[i] = yy[j] / vdiv;
        }
    }
    cluster_wait();  // no CTA leaves while another may still read its sums
}

// ---- MINRES, many blocks (ticket-finished)

// yv -= (beta/oldb) r1 from the second iteration; alfa = v.yv
__global__ void __launch_bounds__(THREADS) minres_lanczos_kernel(MinresArgs a, double* yv,
                                                                 const double* r1)
{
    double* ms = a.ms;
    if (ms[M_DONE] != 0.0) return;
    __shared__ double sh[THREADS];
    const int i = blockIdx.x * THREADS + threadIdx.x;
    double t = 0.0;
    if (i < a.n) {
        double y = yv[i];
        if (ms[M_K] + 1.0 >= 2.0) y = y - (ms[M_BETA] / ms[M_OLDB]) * r1[i];
        yv[i] = y;
        t = a.v[i] * y;
    }
    const double s = block_sum(t, sh);
    if (threadIdx.x == 0) {
        a.part[blockIdx.x] = s;
        __threadfence();
    }
    unsigned int* ticket = ticket_of(a.part, a.nblk);
    if (!last_block(ticket)) return;
    const double alfa = tree_by_warp(strided_partials(a.nblk, a.part), sh, 0);
    if (threadIdx.x == 0) {
        ms[M_ALFA] = alfa;
        *ticket = 0u;
    }
}

// yv -= (alfa/beta) r2 (another preconditioner's M yv follows on the host)
__global__ void __launch_bounds__(THREADS) minres_orth_kernel(MinresArgs a, double* yv, const double* r2)
{
    const double* ms = a.ms;
    if (ms[M_DONE] != 0.0) return;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < a.n) yv[i] = yv[i] - (ms[M_ALFA] / ms[M_BETA]) * r2[i];
}

// JACOBI: yv -= (alfa/beta) r2 and y = yv / d; else yv and y = M yv given.
// beta' = sqrt(max(yv.y, 0)) and the rotation, by the last block.
template <bool JACOBI>
__global__ void __launch_bounds__(THREADS) minres_beta_kernel(MinresArgs a, double* yv, const double* r2,
                                                              const double* y)
{
    double* ms = a.ms;
    if (ms[M_DONE] != 0.0) {
        if (blockIdx.x == 0 && threadIdx.x == 0) ms[M_ACTIVE] = 0.0;
        return;
    }
    __shared__ double sh[THREADS];
    const int i = blockIdx.x * THREADS + threadIdx.x;
    double t = 0.0;
    if (i < a.n) {
        double u = yv[i], yi;
        if constexpr (JACOBI) {
            u = u - (ms[M_ALFA] / ms[M_BETA]) * r2[i];
            yv[i] = u;
            yi = u / a.d[i];
        } else {
            yi = y[i];
        }
        t = u * yi;
    }
    double* pyy = a.part + a.nblk;
    const double s = block_sum(t, sh);
    if (threadIdx.x == 0) {
        pyy[blockIdx.x] = s;
        __threadfence();
    }
    unsigned int* ticket = ticket_of(a.part, a.nblk);
    if (!last_block(ticket)) return;
    const double yy = tree_by_warp(strided_partials(a.nblk, pyy), sh, 0);
    if (threadIdx.x == 0) {
        minres_rotate(yy, ms[M_ALFA], ms);
        *ticket = 0u;
    }
}

// w1 = (v - oldeps w - delta w2) / gamma into w, x += phi w1, v = y / beta'
// (JACOBI: y = yv / d)
template <bool JACOBI>
__global__ void __launch_bounds__(THREADS) minres_update_kernel(MinresArgs a, const double* y, double* w,
                                                                const double* w2)
{
    const double* ms = a.ms;
    if (ms[M_ACTIVE] == 0.0) return;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= a.n) return;
    const double w1 = (a.v[i] - ms[M_OLDEPS] * w[i] - ms[M_DELTA] * w2[i]) / ms[M_GAMMA];
    a.x[i] = a.x[i] + ms[M_PHI] * w1;
    w[i] = w1;
    const double beta = ms[M_BETA];
    const double yi = JACOBI ? y[i] / a.d[i] : y[i];
    a.v[i] = yi / (beta > 0.0 ? beta : 1.0);
}

int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

int cg_grid(int nblk) { return (nblk + WARPS - 1) / WARPS; }

// the one-launch MINRES grid: a cluster, a warp a chunk
int cluster_threads(int nblk) { return 32 * ((nblk + CLUSTER - 1) / CLUSTER); }

int last_error() { return static_cast<int>(cudaGetLastError()); }

// what a step's launcher returns: the kernels it enqueued, or minus the
// CUDA error of its launches
int enqueued(int count)
{
    const int err = last_error();
    return err != 0 ? -err : count;
}

constexpr int INVALID = -static_cast<int>(cudaErrorInvalidValue);

bool valid(int n, int nblk) { return n > 0 && nblk == blocks_of(n); }

}  // namespace

// part: 3 ceil(n / 256) doubles; st: 8 doubles
extern "C" int nxfx_krylov_cg_start(int n, const double* b, const double* r, const double* z,
                                    double* part, double* st, double rtol, double atol,
                                    double maxiter, cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nblk = blocks_of(n);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, r, z, part);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, b, b, part + nblk);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, r, r, part + 2 * nblk);
    cg_init_kernel<<<1, THREADS, 0, stream>>>(nblk, part, rtol, atol, maxiter, st);
    return last_error();
}

// alpha, then x, r, ||r||, done (and with Jacobi z, beta, gamma): 2 launches.
// This and the other step launchers below return the kernels they enqueued
// (see enqueued).
extern "C" int nxfx_krylov_cg_step(const CgArgs* a, const double* ap, cudaStream_t stream)
{
    if (!valid(a->n, a->nblk) || (a->diag != nullptr && a->z == nullptr)) return INVALID;
    const int grid = cg_grid(a->nblk);
    int count = 0;
    cg_alpha_kernel<<<grid, THREADS, 0, stream>>>(*a, ap);
    ++count;
    if (a->diag != nullptr) cg_advance_kernel<true><<<grid, THREADS, 0, stream>>>(*a, ap);
    else cg_advance_kernel<false><<<grid, THREADS, 0, stream>>>(*a, ap);
    ++count;
    return enqueued(count);
}

// with Jacobi: p = z + beta p on the stored z, 1 launch; else beta from r.z
// and p = z + beta p for the host's z = M r, 2 launches
extern "C" int nxfx_krylov_cg_direction(const CgArgs* a, const double* z, cudaStream_t stream)
{
    if (!valid(a->n, a->nblk) || (a->diag == nullptr ? z : a->z) == nullptr) return INVALID;
    const int grid = cg_grid(a->nblk);
    int count = 0;
    if (a->diag == nullptr) {
        cg_beta_kernel<<<grid, THREADS, 0, stream>>>(*a, z);
        ++count;
    }
    cg_direction_kernel<<<grid, THREADS, 0, stream>>>(*a, a->diag != nullptr ? a->z : z);
    ++count;
    return enqueued(count);
}

// z and base may be null
extern "C" int nxfx_krylov_cheb_start(int n, const double* s, const double* r, double theta, double* rs,
                                      double* dvec, double* x, double* z, const double* base,
                                      cudaStream_t stream)
{
    if (n <= 0) return 0;
    cheb_start_kernel<<<blocks_of(n), THREADS, 0, stream>>>(n, s, r, theta, rs, dvec, x, z, base);
    return last_error();
}

extern "C" int nxfx_krylov_jacobi(int n, const double* v, const double* diag, double* z,
                                  cudaStream_t stream)
{
    if (n <= 0) return 0;
    jacobi_kernel<<<blocks_of(n), THREADS, 0, stream>>>(n, v, diag, z);
    return last_error();
}

extern "C" int nxfx_krylov_inv_sqrt(int n, const double* d, double* s, cudaStream_t stream)
{
    if (n <= 0) return 0;
    inv_sqrt_kernel<<<blocks_of(n), THREADS, 0, stream>>>(n, d, s);
    return last_error();
}

// ms: 17 doubles; part: 2 ceil(n / 256); r = b - A x0, y = M r; writes v = y / beta1
extern "C" int nxfx_krylov_minres_start(int n, const double* b, const double* r, const double* y,
                                        double* v, double* part, double* ms, double rtol, double atol,
                                        double maxiter, cudaStream_t stream)
{
    if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int nblk = blocks_of(n);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, r, y, part);
    dot_partial_kernel<<<nblk, THREADS, 0, stream>>>(n, b, b, part + nblk);
    minres_init_kernel<<<1, THREADS, 0, stream>>>(nblk, part, rtol, atol, maxiter, ms);
    minres_v_kernel<<<nblk, THREADS, 0, stream>>>(n, ms, y, v);
    return last_error();
}

// yv = A v on entry.  With Jacobi (a->d) the whole iteration: one cluster
// launch, else 3; without, the Lanczos step that ends in yv: one cluster
// launch, else 2.
extern "C" int nxfx_krylov_minres_step(const MinresArgs* a, double* yv, const double* r1,
                                       const double* r2, double* w, const double* w2,
                                       cudaStream_t stream)
{
    const int nblk = a->nblk;
    if (!valid(a->n, nblk) || (a->one_launch && nblk > CLUSTER_CHUNKS)) return INVALID;
    if (a->one_launch) {
        const int threads = cluster_threads(nblk);
        if (a->d != nullptr)
            minres_cluster_kernel<0><<<CLUSTER, threads, 0, stream>>>(*a, yv, r1, r2, nullptr, w, w2);
        else
            minres_cluster_kernel<1><<<CLUSTER, threads, 0, stream>>>(*a, yv, r1, r2, nullptr, nullptr, nullptr);
        return enqueued(1);
    }
    int count = 0;
    minres_lanczos_kernel<<<nblk, THREADS, 0, stream>>>(*a, yv, r1);
    ++count;
    if (a->d != nullptr) {
        minres_beta_kernel<true><<<nblk, THREADS, 0, stream>>>(*a, yv, r2, nullptr);
        ++count;
        minres_update_kernel<true><<<nblk, THREADS, 0, stream>>>(*a, yv, w, w2);
        ++count;
    } else {
        minres_orth_kernel<<<nblk, THREADS, 0, stream>>>(*a, yv, r2);
        ++count;
    }
    return enqueued(count);
}

// Without Jacobi, after y = M yv on the host: beta', the rotation, the
// updates of w and x, the next v.  One cluster launch, else 2.
extern "C" int nxfx_krylov_minres_finish(const MinresArgs* a, double* yv, const double* y, double* w,
                                         const double* w2, cudaStream_t stream)
{
    const int nblk = a->nblk;
    if (!valid(a->n, nblk) || a->d != nullptr || (a->one_launch && nblk > CLUSTER_CHUNKS))
        return INVALID;
    if (a->one_launch) {
        minres_cluster_kernel<2><<<CLUSTER, cluster_threads(nblk), 0, stream>>>(*a, yv, nullptr, nullptr, y, w, w2);
        return enqueued(1);
    }
    int count = 0;
    minres_beta_kernel<false><<<nblk, THREADS, 0, stream>>>(*a, yv, nullptr, y);
    ++count;
    minres_update_kernel<false><<<nblk, THREADS, 0, stream>>>(*a, y, w, w2);
    ++count;
    return enqueued(count);
}
