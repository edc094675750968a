// K22a: the per-shard body of the sharded blocked solve around the top
// forest T.
//
// Replaces networks_fenicsx_tpu/parallel/blocked_sharded.py:_make_local_body
// (:304-417) between the shard's K1 + K2-K3 forward (which stops at its
// chunk roots, level 0) and its K4 back-substitution + K5:
//
//   partials, per T node t (one thread each), from the shard's E_loc rows:
//     dT_t = sum_{tT(e)=t} w_e + sum_{sT(e)=t} w_e + sum_{roots j -> t} -w0_j (w0_j / d0_j)
//     rT_t = sum_{tT(e)=t} (const_e + Ftot_e) + sum_{sT(e)=t} -const_e
//            + sum_{roots j -> t} (w0_j / d0_j) r0_j
//     wT_t = sum_{pT(e)=t} w_e
//   and the shard's sum r^2 behind them (:353-364, :377): the row of the
//   shard that K22-reduce sums;
//   lambda, after the T solve: level 0 of the shard's lambda from its T
//   parents, lam0_j = (r0_j + w0_j lam_T[root_T_j]) / d0_j (0 without a
//   parent), and lam_T copied behind the shard's B_sub entries, so that K5
//   reads every row's endpoints, the T edges' tail rows included
//   (:375-399), by index from one vector.
//
// The scatter-adds of the reference become gathers through host-built
// fold tables (rows of a T node, -1 padded): one writer per output, sums
// in table order, no atomics.  Bound: latency (Tn <= 4,096 threads).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

__global__ void shard_partials_kernel(
    int Tn, int Kt, int Ks, int Kp, int Kr,
    const int* __restrict__ tfold, const int* __restrict__ sfold,
    const int* __restrict__ pfold, const int* __restrict__ rfold,
    const double* __restrict__ w, const double* __restrict__ cst,
    const double* __restrict__ Ftot, const double* __restrict__ d0,
    const double* __restrict__ r0, const double* __restrict__ w0,
    const double* __restrict__ rhs_sq, double* __restrict__ part)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t == 0) part[3 * Tn] = rhs_sq[0];
    if (t >= Tn) return;
    double ad = 0.0, ar = 0.0, aw = 0.0;
    for (int k = 0; k < Kt; ++k) {
        const int e = tfold[static_cast<size_t>(t) * Kt + k];
        if (e < 0) break;
        ad = ad + w[e];
        ar = ar + (cst[e] + Ftot[e]);
    }
    for (int k = 0; k < Ks; ++k) {
        const int e = sfold[static_cast<size_t>(t) * Ks + k];
        if (e < 0) break;
        ad = ad + w[e];
        ar = ar + (-cst[e]);
    }
    for (int k = 0; k < Kr; ++k) {
        const int j = rfold[static_cast<size_t>(t) * Kr + k];
        if (j < 0) break;
        const double factor = w0[j] / d0[j];
        ad = ad + (-w0[j] * factor);
        ar = ar + factor * r0[j];
    }
    for (int k = 0; k < Kp; ++k) {
        const int e = pfold[static_cast<size_t>(t) * Kp + k];
        if (e < 0) break;
        aw = aw + w[e];
    }
    part[t] = ad;
    part[Tn + t] = ar;
    part[2 * Tn + t] = aw;
}

__global__ void shard_lambda_kernel(
    int c, int B_sub, int Tn, const int* __restrict__ root_T,
    const double* __restrict__ d0, const double* __restrict__ r0,
    const double* __restrict__ w0, const double* __restrict__ lam_T,
    double* __restrict__ lam_ext)
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j < c) {
        const int p = root_T[j];
        const double lp = p < Tn ? lam_T[p] : 0.0;
        lam_ext[j] = (r0[j] + w0[j] * lp) / d0[j];
    } else if (j < c + Tn) {
        lam_ext[B_sub + (j - c)] = lam_T[j - c];
    }
}

}  // namespace

extern "C" int nxfx_shard_blocked_partials(
    int Tn, int Kt, int Ks, int Kp, int Kr,
    const int* tfold, const int* sfold, const int* pfold, const int* rfold,
    const double* w, const double* cst, const double* Ftot,
    const double* d0, const double* r0, const double* w0, const double* rhs_sq,
    double* part, cudaStream_t stream)
{
    const int n = Tn > 0 ? Tn : 1;
    shard_partials_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
        Tn, Kt, Ks, Kp, Kr, tfold, sfold, pfold, rfold, w, cst, Ftot, d0, r0, w0, rhs_sq, part);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_shard_blocked_lambda(
    int c, int B_sub, int Tn, const int* root_T,
    const double* d0, const double* r0, const double* w0, const double* lam_T,
    double* lam_ext, cudaStream_t stream)
{
    const int n = c + Tn;
    if (n <= 0) return 0;
    shard_lambda_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
        c, B_sub, Tn, root_T, d0, r0, w0, lam_T, lam_ext);
    return static_cast<int>(cudaGetLastError());
}
