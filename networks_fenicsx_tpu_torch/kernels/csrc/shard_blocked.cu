// K22a: the per-shard body of the sharded blocked solve around the top
// forest T, for every shard of one device at once.
//
// Replaces networks_fenicsx_tpu/parallel/blocked_sharded.py:_make_local_body
// (:304-417) between the shards' K1 + K2-K3 forward (which stops at their
// chunk roots, level 0) and their K4 back-substitution + K5:
//
//   partials, per shard and T node t (one thread each), from the shard's
//   E_loc rows:
//     dT_t = sum_{tT(e)=t} w_e + sum_{sT(e)=t} w_e + sum_{roots j -> t} -w0_j (w0_j / d0_j)
//     rT_t = sum_{tT(e)=t} (const_e + Ftot_e) + sum_{sT(e)=t} -const_e
//            + sum_{roots j -> t} (w0_j / d0_j) r0_j
//     wT_t = sum_{pT(e)=t} w_e
//   and the shard's sum r^2 behind them (:353-364, :377): each shard's row
//   of the (S, 3 Tn + 1) tensor that K22-reduce sums;
//   lambda, after the T solve: level 0 of each shard's lambda from its T
//   parents, lam0_j = (r0_j + w0_j lam_T[root_T_j]) / d0_j (0 without a
//   parent), zeros for the levels K4 fills, and lam_T behind the shard's
//   B_sub entries, so that K5 reads every row's endpoints, the T edges'
//   tail rows included (:375-399), by index from one vector: a row of one
//   (S, B_sub + Tn) buffer a shard.
//
// The scatter-adds of the reference become gathers through host-built
// fold tables (rows of a T node, -1 padded), stacked on a leading shard
// axis: one writer per output, sums in table order, no atomics, so each
// shard's row is the one-shard version's to the bit.  Each shard's inputs
// reach the launch through a per-stream struct of pointers
// (ShardBlockedArgs), the shard the grid's y index.
//
// Bound: latency.  A shard's work is a few microseconds of threads on a
// T of Tn <= 4,096 nodes (7 on the 16-generation tree over 8 shards) and
// its bytes move in well under a microsecond; a launch a shard made the
// solve 2 x D launches, so every shard of a device goes in one launch a
// stage: 2 a device a solve (one a MAX_SHARDS shards).

#include <cuda_runtime.h>

constexpr int SB_MAX_SHARDS = 32;

// One shard's inputs: its rows' w, const, Ftot (E_loc), its level-0 d, r,
// wn (at least c), its sum r^2 (one double).
struct ShardBlockedInputs {
    const double* w;
    const double* cst;
    const double* Ftot;
    const double* d0;
    const double* r0;
    const double* w0;
    const double* rhs_sq;
};

// The inputs of a run of S <= SB_MAX_SHARDS shards (a ctypes Structure of
// the same fields, one per calling stream, rewritten each call).
struct ShardBlockedArgs {
    int S;
    ShardBlockedInputs s[SB_MAX_SHARDS];
};

namespace {

constexpr int THREADS = 128;

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

// grid (blocks over Tn, S): shard s0 + blockIdx.y of the tables' stack
__global__ void __launch_bounds__(THREADS) shard_partials_kernel(
    ShardBlockedArgs a, int s0, int Tn, int Kt, int Ks, int Kp, int Kr,
    const int* __restrict__ tfold, const int* __restrict__ sfold,
    const int* __restrict__ pfold, const int* __restrict__ rfold, double* __restrict__ part)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y;
    const size_t s = static_cast<size_t>(s0) + j;
    const ShardBlockedInputs in = a.s[j];
    double* row = part + s * (3 * static_cast<size_t>(Tn) + 1);
    if (t == 0) row[3 * Tn] = in.rhs_sq[0];
    if (t >= Tn) return;
    const size_t n = s * Tn + t;
    double ad = 0.0, ar = 0.0, aw = 0.0;
    for (int k = 0; k < Kt; ++k) {
        const int e = tfold[n * Kt + k];
        if (e < 0) break;
        ad = ad + in.w[e];
        ar = ar + (in.cst[e] + in.Ftot[e]);
    }
    for (int k = 0; k < Ks; ++k) {
        const int e = sfold[n * Ks + k];
        if (e < 0) break;
        ad = ad + in.w[e];
        ar = ar + (-in.cst[e]);
    }
    for (int k = 0; k < Kr; ++k) {
        const int r = rfold[n * Kr + k];
        if (r < 0) break;
        const double factor = in.w0[r] / in.d0[r];
        ad = ad + (-in.w0[r] * factor);
        ar = ar + factor * in.r0[r];
    }
    for (int k = 0; k < Kp; ++k) {
        const int e = pfold[n * Kp + k];
        if (e < 0) break;
        aw = aw + in.w[e];
    }
    row[t] = ad;
    row[Tn + t] = ar;
    row[2 * Tn + t] = aw;
}

// grid (blocks over B_sub + Tn, S): shard s0 + blockIdx.y's whole row
__global__ void __launch_bounds__(THREADS) shard_lambda_kernel(
    ShardBlockedArgs a, int s0, int c, int B_sub, int Tn, const int* __restrict__ root_T,
    const double* __restrict__ lam_T, double* __restrict__ lam)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y;
    const size_t s = static_cast<size_t>(s0) + j;
    double* out = lam + s * (static_cast<size_t>(B_sub) + Tn);
    if (i < c) {
        const ShardBlockedInputs in = a.s[j];
        const int p = root_T[s * c + i];
        const double lp = p < Tn ? lam_T[p] : 0.0;
        out[i] = (in.r0[i] + in.w0[i] * lp) / in.d0[i];
    } else if (i < B_sub) {
        out[i] = 0.0;
    } else if (i < B_sub + Tn) {
        out[i] = lam_T[i - B_sub];
    }
}

}  // namespace

// The partials of shards s0 .. s0 + a->S - 1 of the tables' stack (tables
// (S, Tn, K), part (S, 3 Tn + 1)), one grid.
extern "C" int nxfx_shard_blocked_partials(
    const ShardBlockedArgs* a, int s0, int Tn, int Kt, int Ks, int Kp, int Kr,
    const int* tfold, const int* sfold, const int* pfold, const int* rfold, double* part,
    cudaStream_t stream)
{
    if (a->S < 0 || a->S > SB_MAX_SHARDS || Tn < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (a->S == 0) return 0;
    const int n = Tn > 0 ? Tn : 1;
    shard_partials_kernel<<<dim3(blocks_for(n), a->S), THREADS, 0, stream>>>(
        *a, s0, Tn, Kt, Ks, Kp, Kr, tfold, sfold, pfold, rfold, part);
    return static_cast<int>(cudaGetLastError());
}

// The lambda rows of shards s0 .. s0 + a->S - 1 (root_T (S, c), lam
// (S, B_sub + Tn)), one grid.
extern "C" int nxfx_shard_blocked_lambda(
    const ShardBlockedArgs* a, int s0, int c, int B_sub, int Tn, const int* root_T,
    const double* lam_T, double* lam, cudaStream_t stream)
{
    if (a->S < 0 || a->S > SB_MAX_SHARDS || c < 0 || B_sub < c || Tn < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n = B_sub + Tn;
    if (a->S == 0 || n <= 0) return 0;
    shard_lambda_kernel<<<dim3(blocks_for(n), a->S), THREADS, 0, stream>>>(
        *a, s0, c, B_sub, Tn, root_T, lam_T, lam);
    return static_cast<int>(cudaGetLastError());
}
