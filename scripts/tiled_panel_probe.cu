// A standalone probe of csrc/tiled_cholesky.cuh's panel on one GPU (no
// PyTorch): the latencies that set its pivot chain, tc_sqrt_rcp against the
// library's sqrt and 1.0 / (bit for bit), and tc_panel_kernel against a CPU
// Cholesky of the panel on shapes that end a panel or a sub-panel early,
// with and without the lookahead's update, and its time a launch.
//
//   nvcc -O3 -std=c++17 -fmad=false -gencode=arch=compute_90a,code=sm_90a \
//        -I networks_fenicsx_tpu_torch/kernels/csrc -o probe scripts/tiled_panel_probe.cu && ./probe
//
// Exits non-zero when a value disagrees.

#include <cmath>
#include <cstdio>
#include <vector>

#include "tiled_cholesky.cuh"

namespace {

__device__ __forceinline__ long long probe_clock(double dep)
{
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "d"(dep) : "memory");
    return t;
}

// cycles of 64 dependent operations of one kind (a clock read ordered on
// each side by a data dependence)
template <int OP>
__global__ void latency_kernel(double seed, long long* cycles, double* sink)
{
    const long long t0 = probe_clock(seed);
    double x = seed + threadIdx.x * 1e-9 + static_cast<double>(t0 & 1) * 1e-30;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        if (OP == 0) x = fma(x, 0.999, 1e-3);
        if (OP == 1) x = x * 1.0001;
        if (OP == 2) x = rsqrt(x);
        if (OP == 3) x = sqrt(x);
        if (OP == 4) x = 1.0 / x;
        if (OP == 5) {
            double s, r;
            tc_sqrt_rcp(x, s, r);
            x = r;
        }
    }
    const long long t1 = probe_clock(x);
    if (threadIdx.x == 0) cycles[OP] = t1 - t0;
    sink[threadIdx.x] = x;
}

__global__ void sqrt_rcp_kernel(const double* x, double* lib, double* ours, int n)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    lib[2 * i] = sqrt(x[i]);
    lib[2 * i + 1] = 1.0 / lib[2 * i];
    tc_sqrt_rcp(x[i], ours[2 * i], ours[2 * i + 1]);
}

// The panel at (k0, k0) of nb columns of an m x m lower triangle against a
// CPU factor of it (minus the previous panel's columns when pre): the max
// abs difference of L_kk and of the rows below; the time a launch (us).
double panel_case(int m, int k0, int nb, bool pre, float* us)
{
    std::vector<double> a(static_cast<size_t>(m) * m, 0.0);
    for (int i = 0; i < m; ++i)
        for (int j = 0; j <= i; ++j)
            a[static_cast<size_t>(i) * m + j] =
                i == j ? 40.0 + i % 7 : ((i - j) % 5 == 0 ? 1.0 / (1 + (i * 7 + j * 3) % 11) : 0.0);
    const int kp = pre ? k0 - TC_NB : -1;
    std::vector<double> w(static_cast<size_t>(m - k0) * nb);
    for (int i = k0; i < m; ++i)
        for (int j = 0; j < nb; ++j) {
            double t = a[static_cast<size_t>(i) * m + k0 + j];
            if (pre)
                for (int k = 0; k < TC_NB; ++k)
                    t -= a[static_cast<size_t>(i) * m + kp + k] * a[static_cast<size_t>(k0 + j) * m + kp + k];
            w[static_cast<size_t>(i - k0) * nb + j] = t;
        }
    std::vector<double> l(static_cast<size_t>(m - k0) * nb, 0.0);  // the factor's columns, rows k0 ..
    for (int j = 0; j < nb; ++j) {
        double s = w[static_cast<size_t>(j) * nb + j];
        for (int k = 0; k < j; ++k) s -= l[static_cast<size_t>(j) * nb + k] * l[static_cast<size_t>(j) * nb + k];
        l[static_cast<size_t>(j) * nb + j] = std::sqrt(s);
        for (int i = j + 1; i < m - k0; ++i) {
            double t = w[static_cast<size_t>(i) * nb + j];
            for (int k = 0; k < j; ++k) t -= l[static_cast<size_t>(i) * nb + k] * l[static_cast<size_t>(j) * nb + k];
            l[static_cast<size_t>(i) * nb + j] = t / l[static_cast<size_t>(j) * nb + j];
        }
    }
    double* d = nullptr;
    cudaMalloc(&d, sizeof(double) * a.size());
    cudaMemcpy(d, a.data(), sizeof(double) * a.size(), cudaMemcpyHostToDevice);
    cudaFuncSetAttribute(tc_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_PANEL_BYTES);
    const int tiles = (m - k0 - nb + TC_NB - 1) / TC_NB;
    const int grid = tiles > 0 ? tiles : 1;
    tc_panel_kernel<<<grid, TC_THREADS, TC_PANEL_BYTES>>>(d, m, m, k0, nb, kp);
    cudaError_t err = cudaDeviceSynchronize();
    std::vector<double> got(a.size());
    cudaMemcpy(got.data(), d, sizeof(double) * a.size(), cudaMemcpyDeviceToHost);
    double diff = err == cudaSuccess ? 0.0 : INFINITY;
    for (int i = 0; i < m - k0; ++i)
        for (int j = 0; j < nb && j <= (i < nb ? i : nb - 1); ++j)
            diff = std::fmax(diff, std::fabs(got[static_cast<size_t>(k0 + i) * m + k0 + j] -
                                             l[static_cast<size_t>(i) * nb + j]));
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    for (int r = 0; r < 20; ++r) tc_panel_kernel<<<grid, TC_THREADS, TC_PANEL_BYTES>>>(d, m, m, k0, nb, kp);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, e0, e1);
    *us = ms * 1000.0f / 20;
    cudaFree(d);
    return diff;
}

}  // namespace

int main()
{
    int bad = 0;
    long long* cycles = nullptr;
    double* sink = nullptr;
    cudaMalloc(&cycles, 8 * sizeof(long long));
    cudaMalloc(&sink, 32 * sizeof(double));
    latency_kernel<0><<<1, 32>>>(2.0, cycles, sink);
    latency_kernel<1><<<1, 32>>>(2.0, cycles, sink);
    latency_kernel<2><<<1, 32>>>(2.0, cycles, sink);
    latency_kernel<3><<<1, 32>>>(2.0, cycles, sink);
    latency_kernel<4><<<1, 32>>>(2.0, cycles, sink);
    latency_kernel<5><<<1, 32>>>(2.0, cycles, sink);
    long long c[6];
    cudaMemcpy(c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
    printf("dependent latency (cycles): DFMA %.1f, DMUL %.1f, rsqrt %.1f, sqrt %.1f, 1.0 / x %.1f, tc_sqrt_rcp %.1f\n",
           c[0] / 64.0, c[1] / 64.0, c[2] / 64.0, c[3] / 64.0, c[4] / 64.0, c[5] / 64.0);

    const int n = 1 << 22;
    std::vector<double> x(n);
    unsigned long long st = 88172645463325252ull;
    for (int i = 0; i < n; ++i) {
        st ^= st << 13;
        st ^= st >> 7;
        st ^= st << 17;
        x[i] = std::ldexp(1.0 + static_cast<double>(st >> 11) / 9007199254740992.0, static_cast<int>(st % 600) - 300);
    }
    double *dx = nullptr, *dl = nullptr, *dou = nullptr;
    cudaMalloc(&dx, sizeof(double) * n);
    cudaMalloc(&dl, 2 * sizeof(double) * n);
    cudaMalloc(&dou, 2 * sizeof(double) * n);
    cudaMemcpy(dx, x.data(), sizeof(double) * n, cudaMemcpyHostToDevice);
    sqrt_rcp_kernel<<<n / 256, 256>>>(dx, dl, dou, n);
    std::vector<double> lib(2 * static_cast<size_t>(n)), ours(2 * static_cast<size_t>(n));
    cudaMemcpy(lib.data(), dl, 2 * sizeof(double) * n, cudaMemcpyDeviceToHost);
    cudaMemcpy(ours.data(), dou, 2 * sizeof(double) * n, cudaMemcpyDeviceToHost);
    long long differ = 0;
    for (size_t i = 0; i < lib.size(); ++i) differ += lib[i] != ours[i];
    printf("tc_sqrt_rcp against sqrt and 1.0 / sqrt on %d positive normal inputs: %lld results differ\n", n, differ);
    bad |= differ != 0;

    const int shapes[][4] = {{1240, 0, 64, 0}, {1240, 64, 64, 1}, {455, 0, 64, 0}, {455, 64, 64, 1},
                             {455, 448, 7, 1}, {100, 0, 37, 0}, {40, 0, 40, 0}, {130, 64, 64, 1},
                             {4096, 64, 64, 1}, {1, 0, 1, 0}};
    for (const auto& s : shapes) {
        float us = 0.0f;
        const double diff = panel_case(s[0], s[1], s[2], s[3] != 0, &us);
        printf("panel m %4d k0 %4d nb %2d pre %d: max |L - CPU| %.2e, %.2f us a launch\n", s[0], s[1], s[2], s[3], diff, us);
        bad |= !(diff <= 1e-12);
    }
    return bad;
}
