// Batched triangular solves for Hopper (sm_90a):
//     L x = b   or   L^T x = b (trans)      L (B,n,n) lower, b (B,n,m).
//
// Replaces the TPU kernel smplsim_tpu/ops/linalg_kernels.py::
// solve_lower_batched (body _solve_lower_kernel). Only the lower triangle of
// L is read. One thread block owns one system: L's lower triangle is packed
// row by row into shared memory (n(n+1)/2 values, 11.4 KB at n=75 in
// float32) beside the right-hand side tile (n,m); then n column steps, each
// one block barrier: each thread divides its columns of row k of the tile
// by the pivot (row k is final and only read in step k, so no barrier is
// needed for it), the threads of row lane 0 write the finished row k to x,
// and the threads over (row, rhs column) update the rows still open (below
// k, or above k for L^T). Each input byte is read once and x is written
// once.
//
// What bounds it on the H100: at n=75 a system moves 12 KB at m=1 and 31 KB
// at m=32 in float32 with 2 n^2 m flops, so the work is light on both bytes
// and flops and the kernel is latency-bound on its n dependent block
// barriers; at m=1 only one column's worth of threads (n-1 at most) has
// work in a step. The design keeps the whole recurrence in shared memory so
// that no barrier waits on device memory, and sizes the block to the rhs
// (96 threads at m=1, 256 at m >= 4) so that more systems are resident per
// SM. The TPU kernel's rhs chunks of 32 columns and 128-lane padding are
// VMEM and lane devices and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

template <typename T>
__global__ void solve_lower_kernel(const T* __restrict__ L, const T* __restrict__ b,
                                   T* __restrict__ x, int n, int m, int trans) {
  extern __shared__ unsigned char smem_raw[];
  T* Lp = reinterpret_cast<T*>(smem_raw);  // packed lower triangle: (i,j) at tri(i)+j
  T* X = Lp + tri(n);                      // (n, m) row-major
  const int sys = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* Ls = L + (size_t)sys * n * n;
  const T* bs = b + (size_t)sys * n * m;
  T* xs = x + (size_t)sys * n * m;

  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx - (idx / n) * n;
    if (j <= i) Lp[tri(i) + j] = Ls[idx];
  }
  for (int idx = tid; idx < n * m; idx += nt) X[idx] = bs[idx];
  __syncthreads();

  // thread t owns rhs columns c = t % cw (+ cw, ...) and, in each step,
  // the open rows r = t / cw (+ rl, ...): each thread divides its column's
  // pivot row once per step, with no integer division in the inner loop
  const int cw = m < nt ? m : nt;
  const int rl = nt / cw;
  const int c0 = tid % cw, r0 = tid / cw;
  if (!trans) {
    // forward substitution, column k: x_k = X_k / L_kk; X_i -= L_ik x_k, i > k
    for (int k = 0; k < n; ++k) {
      const T piv = Lp[tri(k) + k];
      for (int c = c0; c < m; c += cw) {
        const T xk = X[k * m + c] / piv;
        if (r0 == 0) xs[k * m + c] = xk;
        if (r0 < rl)
          for (int i = k + 1 + r0; i < n; i += rl) X[i * m + c] -= Lp[tri(i) + k] * xk;
      }
      __syncthreads();
    }
  } else {
    // back substitution with L^T, column k: x_k = X_k / L_kk; X_i -= L_ki x_k, i < k
    for (int k = n - 1; k >= 0; --k) {
      const T piv = Lp[tri(k) + k];
      for (int c = c0; c < m; c += cw) {
        const T xk = X[k * m + c] / piv;
        if (r0 == 0) xs[k * m + c] = xk;
        if (r0 < rl)
          for (int i = r0; i < k; i += rl) X[i * m + c] -= Lp[tri(k) + i] * xk;
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* L, const void* b, void* x, int B, int n, int m, int trans,
           void* stream) {
  const size_t smem = sizeof(T) * ((size_t)n * (n + 1) / 2 + (size_t)n * m);
  cudaError_t err = cudaFuncSetAttribute(solve_lower_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((n * m + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  if (B > 0) {
    solve_lower_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
        (const T*)L, (const T*)b, (T*)x, n, m, trans);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The launch goes to `stream` on the current device; returns cudaGetLastError().
extern "C" int solve_lower_f32(const void* L, const void* b, void* x, int B, int n, int m,
                               int trans, void* stream) {
  return launch<float>(L, b, x, B, n, m, trans, stream);
}

extern "C" int solve_lower_f64(const void* L, const void* b, void* x, int B, int n, int m,
                               int trans, void* stream) {
  return launch<double>(L, b, x, B, n, m, trans, stream);
}
