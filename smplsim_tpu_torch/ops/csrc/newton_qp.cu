// Batched contact QP for Hopper (sm_90a): projected Newton on
//     min 1/2 f^T A f - b^T f   s.t. f >= 0 on the active rows,
// A (B,K,K), b/active/f0 (B,K) -> f (B,K).
//
// Replaces the TPU kernel smplsim_tpu/ops/qp_kernel.py::_qp_kernel (entry
// _newton_qp_pallas_lanes, wrapper newton_qp_twophase_lanes). The semantics
// are those of newton_qp_reference (qp_kernel.py:67-115): each iteration is
// a projected-gradient step, the active-set mask, a masked Cholesky of
// A*(a a^T) + diag(1-a) and its solve, then a projected-arc line search over
// [1, .5, .25, .0625, .015625, stay] where the FIRST minimum wins.
//
// Two deliberate deviations from the TPU kernel:
//   * per-system early exit: each block stops as soon as its own KKT
//     residual max|f - max(f - g, 0)| <= tol * (1 + max|b|), as the
//     reference's batched while_loop does; the TPU kernel iterates a whole
//     128-lane block until every lane converges, which is why its wrapper
//     sorts lanes by warm-start residual (qp_kernel.py:319-333). Nothing
//     here needs that sort, so it is not ported.
//   * line-search ties go to the earlier candidate (a step beats "stay"),
//     as in the reference's argmin; the TPU kernel keeps "stay" on ties.
//
// Layout: one thread block per system, one thread per row (blockDim is K
// rounded up to a warp). A and the masked factor live in shared memory with
// a padded leading dimension K+1 so that a column walk hits 32 different
// banks; reductions are warp shuffles, combined across warps through shared
// memory and broadcast so every thread takes the same branch.
//
// What bounds it on the H100: per iteration ~K^3/3 flops for the factor plus
// ten K^2 matvecs and two triangular solves, against 4.6 KB moved per system
// at K=32 in float32 (inputs read once, f written once); the work
// is small and serial, so the kernel is bound by barrier latency (about 6K
// block barriers per iteration), not by bytes or flops. Keeping A and the
// factor in shared memory for all iterations is what the design does about
// it: device memory is touched once on entry and once on exit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  // jnp.max semantics: NaN propagates
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T max0(T x) {
  // jnp.maximum(x, 0) semantics: NaN propagates
  return x < T(0) ? T(0) : x;
}

template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int nw = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) red[w] = v;
  __syncthreads();
  T s = red[0];
  for (int k = 1; k < nw; ++k) s += red[k];
  return s;
}

template <typename T>
__device__ T block_max(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_down_sync(kFull, v, o));
  const int nw = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) red[w] = v;
  __syncthreads();
  T s = red[0];
  for (int k = 1; k < nw; ++k) s = nan_max(s, red[k]);
  return s;
}

template <typename T>
__device__ __forceinline__ T row_dot(const T* M, int ld, int i, const T* v, int K) {
  T s = T(0);
  for (int j = 0; j < K; ++j) s += M[i * ld + j] * v[j];
  return s;
}

template <typename T>
__global__ void newton_qp_kernel(const T* __restrict__ A, const T* __restrict__ b,
                                 const T* __restrict__ act, const T* __restrict__ f0,
                                 T* __restrict__ fout, int K, int iters, T tol) {
  extern __shared__ unsigned char smem_raw[];
  const int ld = K + 1;
  T* sA = reinterpret_cast<T*>(smem_raw);  // (K, K+1)
  T* sL = sA + K * ld;                     // (K, K+1) masked factor
  T* red = sL + K * ld;                    // 32 warp partials
  T* sv = red + 32;                        // (K) broadcast vector
  T* sam = sv + K;                         // (K) active-set mask
  T* sbc = sam + K;                        // 1 scalar broadcast

  const int sys = blockIdx.x;
  const int i = threadIdx.x;
  const bool row = i < K;
  const T* As = A + (size_t)sys * K * K;
  for (int idx = i; idx < K * K; idx += blockDim.x) {
    const int r = idx / K;
    sA[r * ld + (idx - r * K)] = As[idx];
  }
  const T bi = row ? b[(size_t)sys * K + i] : T(0);
  const bool ai = row && act[(size_t)sys * K + i] > T(0.5);
  const T af = ai ? T(1) : T(0);
  T fi = row ? max0(f0[(size_t)sys * K + i]) * af : T(0);
  const T tol_sys = tol * (T(1) + block_max(row ? fabs(bi) : T(0), red));
  const T steps[5] = {T(1), T(0.5), T(0.25), T(0.0625), T(0.015625)};

  for (int it = 0;; ++it) {
    // KKT residual of the current iterate (the while_loop condition)
    __syncthreads();
    if (row) sv[i] = fi;
    __syncthreads();
    T gi = row ? row_dot(sA, ld, i, sv, K) - bi : T(0);
    const T ri = row ? fabs(fi - max0(fi - gi)) * af : T(0);
    const T r = block_max(ri, red);
    if (it >= iters || !(r > tol_sys)) break;

    // projected-gradient step with exact step length along d
    const T di = (row && (fi > T(0) || gi < T(0)) && ai) ? -gi : T(0);
    __syncthreads();
    if (row) sv[i] = di;
    __syncthreads();
    const T Adi = row ? row_dot(sA, ld, i, sv, K) : T(0);
    const T dAd = block_sum(di * Adi, red);
    const T dd = block_sum(di * di, red);
    const T alpha = dAd > T(1e-30) ? dd / fmax(dAd, T(1e-30)) : T(0);
    fi = row ? max0(fi + alpha * di) : T(0);

    // active set at the new point, masked system H = A*(a a^T) + diag(1-a)
    __syncthreads();
    if (row) sv[i] = fi;
    __syncthreads();
    gi = row ? row_dot(sA, ld, i, sv, K) - bi : T(0);
    const T am = (row && (fi > T(0) || gi < T(0)) && ai) ? T(1) : T(0);
    if (row) sam[i] = am;
    __syncthreads();
    if (row) {
      for (int j = 0; j <= i; ++j)
        sL[i * ld + j] = sA[i * ld + j] * am * sam[j] + (j == i ? T(1) - am : T(0));
    }
    // right-looking Cholesky, one thread per row
    for (int k = 0; k < K; ++k) {
      __syncthreads();
      const T piv = sqrt(sL[k * ld + k]);
      __syncthreads();
      if (i == k) sL[k * ld + k] = piv;
      else if (row && i > k) sL[i * ld + k] = sL[i * ld + k] / piv;
      __syncthreads();
      if (row && i > k) {
        const T lik = sL[i * ld + k];
        for (int j = k + 1; j <= i; ++j) sL[i * ld + j] -= lik * sL[j * ld + k];
      }
    }
    // forward substitution L y = b*a (y_i held by thread i)
    T yi = bi * am;
    for (int k = 0; k < K; ++k) {
      __syncthreads();
      if (i == k) {
        yi = yi / sL[k * ld + k];
        sbc[0] = yi;
      }
      __syncthreads();
      const T yk = sbc[0];
      if (row && i > k) yi -= sL[i * ld + k] * yk;
    }
    // back substitution L^T x = y
    for (int k = K - 1; k >= 0; --k) {
      __syncthreads();
      if (i == k) {
        yi = yi / sL[k * ld + k];
        sbc[0] = yi;
      }
      __syncthreads();
      const T xk = sbc[0];
      if (i < k) yi -= sL[k * ld + i] * xk;
    }
    const T dn = row ? max0(yi * am) - fi : T(0);

    // projected-arc line search: [1, .5, .25, .0625, .015625, stay]
    int best = 0;
    T best_v = T(0);
    for (int s = 0; s < 6; ++s) {
      const T ci = row ? (s < 5 ? max0(fi + steps[s] * dn) : fi) : T(0);
      __syncthreads();
      if (row) sv[i] = ci;
      __syncthreads();
      const T Aci = row ? row_dot(sA, ld, i, sv, K) : T(0);
      const T cAc = block_sum(ci * Aci, red);
      const T cb = block_sum(ci * bi, red);
      const T v = T(0.5) * cAc - cb;
      // argmin: the first minimum wins; a NaN value counts as the minimum
      const bool take = (s == 0) || (v != v && best_v == best_v) ||
                        (best_v == best_v && v < best_v);
      if (take) {
        best = s;
        best_v = v;
      }
    }
    if (row && best < 5) fi = max0(fi + steps[best] * dn);
  }
  if (row) fout[(size_t)sys * K + i] = fi;
}

template <typename T>
int launch(const void* A, const void* b, const void* act, const void* f0, void* f,
           int B, int K, int iters, double tol, void* stream) {
  const int threads = ((K + 31) / 32) * 32;
  const size_t smem = sizeof(T) * (2 * (size_t)K * (K + 1) + 32 + 2 * (size_t)K + 1);
  cudaError_t err = cudaFuncSetAttribute(newton_qp_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    newton_qp_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
        (const T*)A, (const T*)b, (const T*)act, (const T*)f0, (T*)f, K, iters, (T)tol);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The launch goes to `stream` on the current device; returns cudaGetLastError().
extern "C" int newton_qp_f32(const void* A, const void* b, const void* act, const void* f0,
                             void* f, int B, int K, int iters, double tol, void* stream) {
  return launch<float>(A, b, act, f0, f, B, K, iters, tol, stream);
}

extern "C" int newton_qp_f64(const void* A, const void* b, const void* act, const void* f0,
                             void* f, int B, int K, int iters, double tol, void* stream) {
  return launch<double>(A, b, act, f0, f, B, K, iters, tol, stream);
}
