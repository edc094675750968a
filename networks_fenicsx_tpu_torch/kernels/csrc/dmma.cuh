// The float64 tensor-core products, the cp.async staging and the mbarrier helpers
// shared by the matrix kernels: K11's tiled Cholesky (tiled_cholesky.cuh, replacing
// networks_fenicsx_tpu/ops/mixed_precision.py:34, with K12b and K19c's
// coarsest level on the same header) and K16's DCT products (dct_lattice.cu,
// replacing networks_fenicsx_tpu/solver.py:941-1102).
//
// Bound: the H100 SXM's float64 tensor cores (DMMA) peak at 67 TFLOP/s,
// twice the 34 of its float64 FMA pipe (NVIDIA's data sheet, at 700 W).
// Hopper's wgmma has no float64 form, so the warp-level mma.sync is the way
// to that rate, each product fused into its sum (not rounded first, as the
// library's -fmad=false keeps the fma-free kernels).  On an H100, in a
// register-only test, the m16n8k4/k8/k16 shapes ran at the full 66-67
// TFLOP/s and m8n8k4 at half of it: every kernel takes m16n8k16.  A
// kernel built on them stages its operands in shared memory with cp.async
// (global to shared without registers; zero-filled past a ragged edge), so
// that the next slab lands while the current one is multiplied, tracked by
// commit groups or, across warps, by mbarriers, and reads its fragments
// from a layout whose row stride is 4 mod 16 doubles: the 16 lanes of a
// half-warp then hit 16 distinct bank pairs.

#pragma once

#include <cuda_runtime.h>

namespace {

// one double from global to shared memory, asynchronously
__device__ __forceinline__ void tc_cp_async8(double* dst, const double* src)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

// close the group of the copies issued since the last commit
__device__ __forceinline__ void tc_cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void tc_cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// d (16 x 8) += a (16 x 16) b (16 x 8) on the float64 tensor cores, one warp:
// lane (g, t) = (lane / 4, lane % 4) holds a[i] = A(g + 8 (i % 2), t + 4 (i /
// 2)), b[i] = B(t + 4 i, g) and d[i] = D(g + 8 (i / 2), 2 t + i % 2).
__device__ __forceinline__ void tc_mma16x8x16(double* d, const double* a, const double* b)
{
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                   "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// cp.async of 16 (or, with vec false, 8) bytes, of which src_bytes are read
// and the rest zero-filled
__device__ __forceinline__ void tc_cp_async_zfill(double* dst, const double* src, bool vec, int src_bytes)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if (vec)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}

// mbarriers in shared memory: init, arrive, the arrival of this thread's
// earlier cp.async copies once they land, and a wait on a phase's parity,
// bounded (false after ~2^26 polls, so that a fault traps instead of hanging)
__device__ __forceinline__ unsigned tc_smem_u32(const void* p) { return static_cast<unsigned>(__cvta_generic_to_shared(p)); }

__device__ __forceinline__ void tc_mbar_init(unsigned long long* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(tc_smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void tc_mbar_arrive(unsigned long long* bar)
{
    asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(tc_smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void tc_mbar_arrive_copies(unsigned long long* bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(tc_smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool tc_mbar_wait(unsigned long long* bar, unsigned parity)
{
    unsigned done = 0;
    for (long long spin = 0; spin < (1ll << 26) && !done; ++spin)
        asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done)
                     : "r"(tc_smem_u32(bar)), "r"(parity)
                     : "memory");
    return done != 0;
}

}  // namespace
