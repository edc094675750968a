// K12a: the min-degree rounds of the sparse core elimination.
//
// Replaces networks_fenicsx_tpu/ops/core_elim.py:_core_factor (its rounds)
// and _core_apply (the forward rounds and the back-substitution).  A round
// eliminates an independent set elim (S,) whose nodes have at most K
// neighbours (nbr_node (S, K), padded with n_core); the host planner gives
// each slot read an index into the initial values and a K10 fold of the
// update stream.  With init(i) = -w_pairs[init_slot[i]] for i < P0, else 0:
//
// factor, per round (the folds between the launches are K10's):
//   terms:   a[s,k] = init(init_idx[s,k]) - ur[s,k]      (ur: the u_read fold, or 0)
//            inv[s] = 1 / d[elim[s]],  t[s,k] = a[s,k] (a[s,k] inv[s])
//   update:  d[i] -= sd[d_inv[i]] where d_inv[i] < U1      (sd: t folded by d_fold)
//            contrib[m] = a[u_src_i[m]] (a[u_src_j[m]] inv[u_src_j[m] / K])
//            (folded by u_fold straight into the stream at u_off)
// apply:
//   forward: rv[s] = r[elim[s]],  t[s,k] = (a[s,k] inv[s]) rv[s];  r[i] -= sr[d_inv[i]]
//   back, rounds reversed: lam[elim[s]] = (rv[s] - sum_k a[s,k] lam[nbr_node[s,k]]) inv[s]
//            (lam[n_core] = 0 backs the pads; the sum runs over k in order)
// dense tail: gather d and r at the dense nodes and the negated pair values
// -(init(dp_init[p]) - dpf[p]) for K11, and scatter K11's solution back
// (tiled_cholesky.cuh's scatter).
//
// The products are those of the reference, in its order; every rounding is
// the plain version's.  Bound: device-memory latency of the gathers (a
// round's index tables and values are a few hundred kB at most), and one
// launch each.  One thread per entry, no shared memory, no atomics: the
// elimination set is independent and d_inv is an inverse map, so each
// output has one writer.

#include <cuda_runtime.h>

#include "tiled_cholesky.cuh"

namespace {

__device__ __forceinline__ double init_value(int i, int P0, const int* init_slot, const double* w_pairs)
{
    return i < P0 ? -w_pairs[init_slot[i]] : 0.0;
}

__global__ void round_terms_kernel(
    int S, int K, int P0,
    const int* __restrict__ elim, const int* __restrict__ init_idx,
    const int* __restrict__ init_slot, const double* __restrict__ w_pairs,
    const double* __restrict__ ur, const double* __restrict__ d,
    double* __restrict__ a, double* __restrict__ inv, double* __restrict__ t)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= S * K) return;
    const int s = e / K;
    double v = init_value(init_idx[e], P0, init_slot, w_pairs);
    if (ur != nullptr) v = v - ur[e];
    const double is = 1.0 / d[elim[s]];
    a[e] = v;
    t[e] = v * (v * is);
    if (e - s * K == 0) inv[s] = is;
}

__global__ void round_update_kernel(
    int n_core, int U1, int M2, int K,
    const int* __restrict__ d_inv, const double* __restrict__ sd, double* __restrict__ d,
    const int* __restrict__ u_src_i, const int* __restrict__ u_src_j,
    const double* __restrict__ a, const double* __restrict__ inv, double* __restrict__ contrib)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n_core) {
        const int j = d_inv[t];
        if (j < U1) d[t] = d[t] - sd[j];
    }
    if (t < M2) {
        const int i = u_src_i[t], j = u_src_j[t];
        contrib[t] = a[i] * (a[j] * inv[j / K]);
    }
}

__global__ void apply_terms_kernel(
    int S, int K, const int* __restrict__ elim, const double* __restrict__ a,
    const double* __restrict__ inv, const double* __restrict__ r,
    double* __restrict__ rv, double* __restrict__ t)
{
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= S * K) return;
    const int s = e / K;
    const double rs = r[elim[s]];
    t[e] = (a[e] * inv[s]) * rs;
    if (e - s * K == 0) rv[s] = rs;
}

__global__ void apply_update_kernel(
    int n_core, int U1, const int* __restrict__ d_inv, const double* __restrict__ sr,
    double* __restrict__ r)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_core) return;
    const int j = d_inv[t];
    if (j < U1) r[t] = r[t] - sr[j];
}

// lam is read at the neighbours and written at elim: disjoint within a
// round (elim is independent), but no __restrict__ on the one buffer
__global__ void back_kernel(
    int S, int K, const int* __restrict__ elim, const int* __restrict__ nbr,
    const double* __restrict__ a, const double* __restrict__ inv, const double* __restrict__ rv,
    double* lam)
{
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= S) return;
    const int* nb = nbr + static_cast<size_t>(s) * K;
    const double* as = a + static_cast<size_t>(s) * K;
    double acc = as[0] * lam[nb[0]];
    for (int k = 1; k < K; ++k) acc = acc + as[k] * lam[nb[k]];
    lam[elim[s]] = (rv[s] - acc) * inv[s];
}

__global__ void tail_gather_kernel(
    int Bd, int Pd, int P0, const int* __restrict__ dn, const double* __restrict__ d,
    const double* __restrict__ r, const int* __restrict__ dp_init,
    const int* __restrict__ init_slot, const double* __restrict__ w_pairs,
    const double* __restrict__ dpf, double* __restrict__ dd, double* __restrict__ rr,
    double* __restrict__ ov)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < Bd) {
        dd[t] = d[dn[t]];
        rr[t] = r[dn[t]];
    }
    if (t < Pd) {
        double v = init_value(dp_init[t], P0, init_slot, w_pairs);
        if (dpf != nullptr) v = v - dpf[t];
        ov[t] = -v;
    }
}

inline int blocks(long long n) { return static_cast<int>((n + 255) / 256); }

}  // namespace

extern "C" int nxfx_core_round_terms(
    int S, int K, int P0, const int* elim, const int* init_idx, const int* init_slot,
    const double* w_pairs, const double* ur, const double* d, double* a, double* inv, double* t,
    cudaStream_t stream)
{
    if (S * K <= 0) return 0;
    round_terms_kernel<<<blocks(static_cast<long long>(S) * K), 256, 0, stream>>>(
        S, K, P0, elim, init_idx, init_slot, w_pairs, ur, d, a, inv, t);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_core_round_update(
    int n_core, int U1, int M2, int K, const int* d_inv, const double* sd, double* d,
    const int* u_src_i, const int* u_src_j, const double* a, const double* inv, double* contrib,
    cudaStream_t stream)
{
    const int n = n_core > M2 ? n_core : M2;
    if (n <= 0) return 0;
    round_update_kernel<<<blocks(n), 256, 0, stream>>>(
        n_core, U1, M2, K, d_inv, sd, d, u_src_i, u_src_j, a, inv, contrib);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_core_apply_terms(
    int S, int K, const int* elim, const double* a, const double* inv, const double* r,
    double* rv, double* t, cudaStream_t stream)
{
    if (S * K <= 0) return 0;
    apply_terms_kernel<<<blocks(static_cast<long long>(S) * K), 256, 0, stream>>>(
        S, K, elim, a, inv, r, rv, t);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_core_apply_update(
    int n_core, int U1, const int* d_inv, const double* sr, double* r, cudaStream_t stream)
{
    if (n_core <= 0) return 0;
    apply_update_kernel<<<blocks(n_core), 256, 0, stream>>>(n_core, U1, d_inv, sr, r);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_core_back(
    int S, int K, const int* elim, const int* nbr, const double* a, const double* inv,
    const double* rv, double* lam, cudaStream_t stream)
{
    if (S <= 0) return 0;
    back_kernel<<<blocks(S), 256, 0, stream>>>(S, K, elim, nbr, a, inv, rv, lam);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_core_tail_gather(
    int Bd, int Pd, int P0, const int* dn, const double* d, const double* r, const int* dp_init,
    const int* init_slot, const double* w_pairs, const double* dpf, double* dd, double* rr,
    double* ov, cudaStream_t stream)
{
    const int n = Bd > Pd ? Bd : Pd;
    if (n <= 0) return 0;
    tail_gather_kernel<<<blocks(n), 256, 0, stream>>>(
        Bd, Pd, P0, dn, d, r, dp_init, init_slot, w_pairs, dpf, dd, rr, ov);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int nxfx_core_scatter_nodes(
    int n, const int* nodes, const double* x, double* lam, cudaStream_t stream)
{
    if (n <= 0) return 0;
    tc_scatter_kernel<<<blocks(n), 256, 0, stream>>>(n, nodes, x, lam);
    return static_cast<int>(cudaGetLastError());
}
