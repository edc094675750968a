// The norm of a vector finished inside the launch that computes it, shared
// by K17's stencil (grid_core.cu) and K18's matvec (shift_matvec.cu).
//
// Every block writes its partial sum of squares; the last block to finish
// (a ticket) adds the partials in block order, writes the square root and
// puts the ticket back to 0 before the launch ends, so repeated launches,
// launches on two streams (each with its own partials and ticket) and
// CUDA-graph replays give the same bits.  The partials are written by one
// block and read by another, so they carry no __restrict__ and are read
// past L1 (__ldcg).

#pragma once

#include <cuda_runtime.h>

namespace {

// The block's sum of v^2 into partial[blockIdx.x]; the last block of the
// launch adds the gridDim.x partials in block order, writes sqrt(sum) to
// out and resets the ticket.  Every thread of the block calls it.
template <int THREADS>
__device__ void ticket_norm(double v, double* partial, unsigned int* ticket, double* out)
{
    __shared__ double part[THREADS];
    __shared__ bool last;
    part[threadIdx.x] = v * v;
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) part[threadIdx.x] = part[threadIdx.x] + part[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        partial[blockIdx.x] = part[0];
        __threadfence();
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    double acc = 0.0;
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += THREADS) acc += __ldcg(partial + i);
    part[threadIdx.x] = acc;
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) part[threadIdx.x] = part[threadIdx.x] + part[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        *out = sqrt(part[0]);
        *ticket = 0u;
    }
}

}  // namespace
