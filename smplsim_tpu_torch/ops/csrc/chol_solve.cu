// Batched fused SPD factor + solve for Hopper (sm_90a):
//     x = (A + diag(d))^-1 b        A (B,n,n), b (B,n,m), d (B,n) or null,
// and, through the same device code with the factor stored,
//     L = chol(A)                   (cholesky: no right-hand side, m = 0).
//
// chol_solve_* replaces the TPU kernel
// smplsim_tpu/ops/linalg_kernels.py::chol_solve_lanes (body
// _chol_solve_only_kernel); cholesky_* replaces
// linalg_kernels.py::cholesky_batched (body _chol_kernel), the factor alone,
// which backs the contact QP's implicit-function derivative (the masked
// K x K system H = A o (a a^T) + diag(1 - a)). One thread block owns one
// system: the lower triangle of H = A + diag(d) and the right-hand side are
// copied into shared memory once, factored in place by a right-looking
// column Cholesky (threads over the trailing triangle), then solved by
// forward and back substitution (threads over rows x rhs columns). Each
// input byte is read once and x is written once; chol_solve keeps the factor
// on chip, cholesky writes it out once as a full (n,n) matrix with exact
// zeros above the diagonal. (cho_factor_solve.cu holds Kernel C, which
// returns both, on a design of its own.)
//
// What bounds it on the H100: at n=75 a system moves 12 KB (m=1) to 31 KB
// (m=33) in float32 and needs 1.5e5 to 5.1e5 flops, light on both, so the
// kernel is latency-bound on the 3n block-wide barriers of the factor and
// the two substitutions (cholesky at K=32: 6.2 KB, 1.1e4 flops and the
// factor's 3K barriers alone), and on the r^2 index walk of each trailing
// update. The design keeps all of the recurrence in shared memory so that
// no barrier waits on device memory; the TPU's panel blocking, rhs chunking
// and 128-lane padding (cholesky_batched pads n to a multiple of 8 with
// identity) are VMEM and lane devices and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, bool kStoreL>
__global__ void chol_solve_kernel(const T* __restrict__ A, const T* __restrict__ b,
                                  const T* __restrict__ diag, T* __restrict__ x,
                                  T* __restrict__ Lout, int n, int m) {
  extern __shared__ unsigned char smem_raw[];
  T* L = reinterpret_cast<T*>(smem_raw);  // (n, n) row-major; lower triangle used
  T* X = L + n * n;                       // (n, m) row-major
  const int sys = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* As = A + (size_t)sys * n * n;
  const T* bs = b + (size_t)sys * n * m;
  const T* ds = diag ? diag + (size_t)sys * n : nullptr;

  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx - (idx / n) * n;
    if (j <= i) {
      T v = As[idx];
      if (ds != nullptr && i == j) v += ds[i];
      L[idx] = v;
    }
  }
  for (int idx = tid; idx < n * m; idx += nt) X[idx] = bs[idx];
  __syncthreads();

  // right-looking Cholesky: column k is scaled by its pivot, then the
  // trailing lower triangle takes the rank-1 update
  for (int k = 0; k < n; ++k) {
    const T piv = sqrt(L[k * n + k]);
    __syncthreads();
    if (tid == 0) L[k * n + k] = piv;
    for (int i = k + 1 + tid; i < n; i += nt) L[i * n + k] = L[i * n + k] / piv;
    __syncthreads();
    const int r = n - k - 1;
    for (int idx = tid; idx < r * r; idx += nt) {
      const int i = k + 1 + idx / r, j = k + 1 + (idx - (idx / r) * r);
      if (j <= i) L[i * n + j] -= L[i * n + k] * L[j * n + k];
    }
    __syncthreads();
  }

  // forward substitution L y = b (m is uniform over the block: with no
  // right-hand side both substitutions and their barriers are skipped)
  for (int k = 0; k < n && m > 0; ++k) {
    const T piv = L[k * n + k];
    for (int c = tid; c < m; c += nt) X[k * m + c] = X[k * m + c] / piv;
    __syncthreads();
    const int rows = n - k - 1;
    for (int idx = tid; idx < rows * m; idx += nt) {
      const int i = k + 1 + idx / m, c = idx - (idx / m) * m;
      X[i * m + c] -= L[i * n + k] * X[k * m + c];
    }
    __syncthreads();
  }
  // back substitution L^T x = y
  for (int k = n - 1; k >= 0 && m > 0; --k) {
    const T piv = L[k * n + k];
    for (int c = tid; c < m; c += nt) X[k * m + c] = X[k * m + c] / piv;
    __syncthreads();
    for (int idx = tid; idx < k * m; idx += nt) {
      const int i = idx / m, c = idx - (idx / m) * m;
      X[i * m + c] -= L[k * n + i] * X[k * m + c];
    }
    __syncthreads();
  }

  T* xs = x + (size_t)sys * n * m;
  for (int idx = tid; idx < n * m; idx += nt) xs[idx] = X[idx];
  if (kStoreL) {
    // the upper triangle of the shared tile was never written: store zeros
    T* Ls = Lout + (size_t)sys * n * n;
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx - (idx / n) * n;
      Ls[idx] = j <= i ? L[idx] : T(0);
    }
  }
}

template <typename T, bool kStoreL>
int launch(const void* A, const void* b, const void* diag, void* x, void* L, int B,
           int n, int m, void* stream) {
  const size_t smem = sizeof(T) * ((size_t)n * n + (size_t)n * m);
  cudaError_t err = cudaFuncSetAttribute(chol_solve_kernel<T, kStoreL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    chol_solve_kernel<T, kStoreL><<<B, 256, smem, (cudaStream_t)stream>>>(
        (const T*)A, (const T*)b, (const T*)diag, (T*)x, (T*)L, n, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The launch goes to `stream` on the current device; returns cudaGetLastError().
extern "C" int chol_solve_f32(const void* A, const void* b, const void* diag, void* x,
                              int B, int n, int m, void* stream) {
  return launch<float, false>(A, b, diag, x, nullptr, B, n, m, stream);
}

extern "C" int chol_solve_f64(const void* A, const void* b, const void* diag, void* x,
                              int B, int n, int m, void* stream) {
  return launch<double, false>(A, b, diag, x, nullptr, B, n, m, stream);
}

// L (B,n,n), the lower Cholesky factor of each SPD A (B,n,n) with exact zeros
// above the diagonal (only the lower triangle of A is read).
extern "C" int cholesky_f32(const void* A, void* L, int B, int n, void* stream) {
  return launch<float, true>(A, nullptr, nullptr, nullptr, L, B, n, 0, stream);
}

extern "C" int cholesky_f64(const void* A, void* L, int B, int n, void* stream) {
  return launch<double, true>(A, nullptr, nullptr, nullptr, L, B, n, 0, stream);
}
