// Device code shared by Kernel D (solve_lower.cu) and Kernel C
// (cho_factor_solve.cu): the packed lower triangle in shared memory, its
// load, and the warp-synchronous triangular substitutions.
//
// Layout: the lower triangle of an (n,n) matrix packed row by row, (i,j) at
// tri(i) + j. Triangular numbers taken mod 32 run through all 32 banks for
// any 32 consecutive rows, so a warp reading column k of 32 consecutive rows
// (tri(i) + k) and a warp reading 32 consecutive entries of row k are both
// free of bank conflicts.
//
// Warp substitution: a warp holds one right-hand-side column; lane l owns
// rows i = l + 32 s (s < R) in registers. Step k: the lane owning row k
// scales its value by the reciprocal pivot (taken once per row, before the
// recurrence) and broadcasts it with one __shfl_sync, and every lane updates
// its own rows with the column (L x = b) or row (L^T x = b) of L that meets
// them. No block barrier and no shared-memory traffic for x; the loops are
// counted, so a NaN pivot cannot hang them, and a lane's row slots are
// registers (no array in local memory).
#pragma once
#include <cuda_runtime.h>

namespace tri {

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// Start of row i in the row-aligned packed layout: row r takes r + 1
// entries rounded up to a multiple of 4, so every row starts 16-byte aligned
// in float (32-byte in double) and four consecutive entries of a row from a
// multiple of 4 are one vector load.
__host__ __device__ __forceinline__ int rowoff(int i) {
  const int q = i >> 2;
  return 8 * q * (q + 1) + (i - 4 * q) * 4 * (q + 1);
}

// Copy the lower triangle of the row-major (n,n) matrix `src` into `dst`,
// packed (kRowAligned: in the row-aligned layout), and nothing of the upper
// triangle. Thread t of nt copies packed elements t, t + nt, ..., in batches
// of kBatch plain loads that are all in flight before the batch is stored
// (the rows of `src` are 4-byte aligned only, so 16-byte copies and TMA do
// not apply). The row of the first element comes from a square root
// corrected by one step, the next ones by stepping along the rows, so no
// loop carries a division. Pair with a barrier.
template <typename T, bool kRowAligned = false, int kBatch = (sizeof(T) == 4 ? 32 : 16)>
__device__ __forceinline__ void load_lower(T* dst, const T* __restrict__ src, int n, int t,
                                           int nt) {
  const int total = tri(n);
  int i = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  if (tri(i + 1) <= t) ++i;
  if (tri(i) > t) --i;
  int j = t - tri(i);
  for (int p0 = t; p0 < total; p0 += kBatch * nt) {
    T v[kBatch];
    int d[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (p0 + u * nt < total) {
        v[u] = src[(size_t)i * n + j];
        d[u] = kRowAligned ? rowoff(i) + j : p0 + u * nt;
      }
      j += nt;
      while (j > i && i < n) {
        j -= i + 1;
        ++i;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (p0 + u * nt < total) dst[d[u]] = v[u];
  }
}

// four consecutive entries from a 16-byte aligned shared address
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

// a / b. Double: IEEE division. Float: the special-function unit's
// reciprocal refined by two Newton steps (within an ulp of IEEE), which keeps
// the float kernels free of the call to the slow-path division subroutine
// and of the stack frame that call brings.
__device__ __forceinline__ double div(double a, double b) { return a / b; }
__device__ __forceinline__ float div(float a, float b) {
  float r = __fdividef(1.0f, b);
  r = fmaf(fmaf(-b, r, 1.0f), r, r);
  const float q = a * r;
  return fmaf(fmaf(-b, q, a), r, q);
}

// sqrt(x), the same way: IEEE in double; in float the reciprocal square root
// refined by one Newton step.
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float root(float x) {
  const float r = rsqrtf(x);
  const float s = x * r;
  return fmaf(fmaf(-s, s, x), 0.5f * r, s);
}

// 1 / L_ii for this lane's rows (zero past n), taken before the recurrence
// so that a step's chain is a multiply, a shuffle and an FMA, with no
// division on it.
template <typename T, int R>
__device__ __forceinline__ void pivots(const T* Lp, int n, int lane, T (&inv)[R]) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + 32 * s;
    inv[s] = i < n ? div(T(1), Lp[tri(i) + i]) : T(0);
  }
}

// Step k = 32 sk + rr lives in slot sk of lane rr. Unrolling the
// slot loop makes every register index static: the owner's value is X[sk]
// (no select over slots) and the slots that step k can touch are a static
// range (s > sk forward, s < sk backward), beside the owner slot itself,
// where rows on both sides of k meet and a masked entry of L (zero) leaves
// the finished rows as they are.

// Forward substitution L y = X in place, column-oriented: step k finishes
// y_k and takes L_ik y_k off every row i > k.
template <typename T, int R>
__device__ __forceinline__ void forward(const T* Lp, const T (&inv)[R], T (&X)[R], int n,
                                        int lane) {
#pragma unroll
  for (int sk = 0; sk < R; ++sk) {
    for (int rr = 0; rr < 32; ++rr) {
      const int k = 32 * sk + rr;
      if (k >= n) break;
      const T xk = __shfl_sync(0xffffffffu, X[sk] * inv[sk], rr);
      const int ik = lane + 32 * sk;
      const T lk = ik > k && ik < n ? Lp[tri(ik) + k] : T(0);
      X[sk] = ik == k ? xk : X[sk] - lk * xk;
#pragma unroll
      for (int s = sk + 1; s < R; ++s) {
        const int i = lane + 32 * s;
        X[s] -= (i < n ? Lp[tri(i) + k] : T(0)) * xk;
      }
    }
  }
}

// Back substitution L^T x = X in place: step k (from n-1 down) finishes x_k
// and takes L_kj x_k off every row j < k, reading row k of L.
template <typename T, int R>
__device__ __forceinline__ void backward(const T* Lp, const T (&inv)[R], T (&X)[R], int n,
                                         int lane) {
#pragma unroll
  for (int sk = R - 1; sk >= 0; --sk) {
    for (int rr = 31; rr >= 0; --rr) {
      const int k = 32 * sk + rr;
      if (k >= n) continue;
      const T* row = Lp + tri(k);
      const T xk = __shfl_sync(0xffffffffu, X[sk] * inv[sk], rr);
      const int jk = lane + 32 * sk;
      const T lk = jk < k ? row[jk] : T(0);
      X[sk] = jk == k ? xk : X[sk] - lk * xk;
#pragma unroll
      for (int s = 0; s < sk; ++s) X[s] -= row[lane + 32 * s] * xk;
    }
  }
}

// Load this lane's rows of rhs column c of the (n,m) row-major b (zeros
// outside), and store them back.
template <typename T, int R>
__device__ __forceinline__ void load_col(const T* __restrict__ b, T (&X)[R], int n, int m,
                                         int c, int lane) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + 32 * s;
    X[s] = (i < n && c < m) ? b[(size_t)i * m + c] : T(0);
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_col(T* __restrict__ x, const T (&X)[R], int n, int m,
                                          int c, int lane) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + 32 * s;
    if (i < n && c < m) x[(size_t)i * m + c] = X[s];
  }
}

// cudaFuncGetAttributes of one kernel into out[0] (registers per thread) and
// out[1] (local memory per thread, bytes: spills and dynamically indexed
// arrays).
inline int attributes(const void* fn, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}

// Raise a kernel's dynamic shared-memory limit where a launch needs more
// than the default 48 KB (a per-function attribute, set before each such
// launch so that it holds for every size and type).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace tri
