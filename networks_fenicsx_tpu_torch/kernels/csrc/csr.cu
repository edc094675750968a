// K20: the duplicate fold of the static-pattern CSR assembly; K20b: the CSR
// matvec and the row reductions read off it.
//
// Replaces networks_fenicsx_tpu/ops/csr_assembly.py:make_gather_assembler
// (the (nnz, max_dup) gather-matrix fold of the raw COO value stream into
// unique CSR slots) and ops/sparse.py:CSRMatrix.__matmul__ (gather +
// sorted segment sum), with _extract_diagonal (solver.py:4842) and the
// Jacobi diagonal of the continuous-pressure system (solver.py:4725-4735).
//
//   fold:  data[s] = sum_{j < max_dup} pad(idx[s, j]), pad(i) = vals[perm[i]]
//          for i < nraw and 0 for the pad slot i = nraw, added in j order
//          (duplicates are few: at most 2 on the assembled saddle matrix);
//   spmv:  out[i] = (signs[i] *) sum_p data[p] v[indices[p]] over row i in
//          column order, one row a thread (rows hold a handful of entries);
//   rows:  mode 0, diag[i] = the sum of row i's entries on the diagonal;
//          mode 1, tdiag[i] = sum_p data[p]^2 / adiag[indices[p]], 1 where
//          that is not > 0.
//
// Every sum runs in one thread in a fixed order: no atomics, the same bits
// as the plain versions, which add in the same order.  Index arithmetic on
// nnz * max_dup and the row pointers is 64-bit.
//
// Bound: device-memory bytes.  The fold reads the table, perm and values
// once and writes nnz doubles; a matvec reads the row pointers, column
// indices, values and the vector and writes the rows.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) fold_kernel(long long nnz, int max_dup, long long nraw,
                                                       const int* perm, const int* idx,
                                                       const double* vals, double* data)
{
    const long long s = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    if (s >= nnz) return;
    const int* slot = idx + s * max_dup;
    double acc = 0.0;
    for (int j = 0; j < max_dup; ++j) {
        const long long i = slot[j];
        acc = acc + (i < nraw ? vals[perm[i]] : 0.0);
    }
    data[s] = acc;
}

__global__ void __launch_bounds__(THREADS) spmv_kernel(int n, const long long* indptr,
                                                       const int* indices, const double* data,
                                                       const double* v, const double* signs,
                                                       double* out)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    double acc = 0.0;
    for (long long p = indptr[i]; p < indptr[i + 1]; ++p) acc = acc + data[p] * v[indices[p]];
    out[i] = signs != nullptr ? signs[i] * acc : acc;
}

__global__ void __launch_bounds__(THREADS) rows_kernel(int n, int mode, const long long* indptr,
                                                       const int* indices, const double* data,
                                                       const double* adiag, double* out)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    double acc = 0.0;
    for (long long p = indptr[i]; p < indptr[i + 1]; ++p) {
        const int c = indices[p];
        if (mode == 0) {
            acc = acc + (c == i ? data[p] : 0.0);
        } else {
            const double d = data[p];
            acc = acc + (d * d) / adiag[c];
        }
    }
    out[i] = (mode == 0 || acc > 0.0) ? acc : 1.0;
}

long long blocks_of(long long n) { return (n + THREADS - 1) / THREADS; }

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// idx: (nnz, max_dup) int32 positions into the sorted stream, nraw = pad
extern "C" int nxfx_csr_fold(long long nnz, int max_dup, long long nraw, const int* perm,
                             const int* idx, const double* vals, double* data, cudaStream_t stream)
{
    if (nnz <= 0) return 0;
    if (max_dup <= 0 || blocks_of(nnz) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    fold_kernel<<<static_cast<unsigned>(blocks_of(nnz)), THREADS, 0, stream>>>(
        nnz, max_dup, nraw, perm, idx, vals, data);
    return last_error();
}

// signs may be null
extern "C" int nxfx_csr_spmv(int n, const long long* indptr, const int* indices, const double* data,
                             const double* v, const double* signs, double* out, cudaStream_t stream)
{
    if (n <= 0) return 0;
    spmv_kernel<<<static_cast<unsigned>(blocks_of(n)), THREADS, 0, stream>>>(
        n, indptr, indices, data, v, signs, out);
    return last_error();
}

// mode 0: the diagonal (adiag unused, may be null); mode 1: the Jacobi
// diagonal sum_p data[p]^2 / adiag[col p], 1 where not > 0
extern "C" int nxfx_csr_rows(int n, int mode, const long long* indptr, const int* indices,
                             const double* data, const double* adiag, double* out,
                             cudaStream_t stream)
{
    if (n <= 0) return 0;
    if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
    rows_kernel<<<static_cast<unsigned>(blocks_of(n)), THREADS, 0, stream>>>(
        n, mode, indptr, indices, data, adiag, out);
    return last_error();
}
