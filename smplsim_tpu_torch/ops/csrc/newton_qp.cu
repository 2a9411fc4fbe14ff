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
// What bounds it on the H100: a system moves (K^2 + 4K) values, 4.6 KB at
// K=32 in float32 (inputs read once, f written once), and an iteration needs
// ~K^3/3 flops for the factor plus ~10 K^2 for the matvecs and the two
// triangular solves, so 4,096 systems at ~2 iterations each are bound by
// bytes at ~0.006 ms. The work of one system is serial: the kernel's time is
// the latency of one iteration times the iterations of the slowest system
// of each wave (the cap, 16 on the main path, while the mean is ~2).
//
// newton_qp_warp_kernel (K <= 64): a warp per system, several systems per
// block, and no block barrier after the load, since warps leave at different
// iterations. Lane l owns rows l and, at K > 32, l + 32 (R rows). A stays in
// shared memory for every iteration, rows padded to a 16-byte vector more
// than K so that a warp's row reads are free of bank conflicts, read in
// 16-byte vectors (registers for
// A's row would cost the 4,096 systems at K=32 their single wave: the block
// is sized so that 32 warps of 64 registers fit an SM). A matvec is a
// dot product of the lane's row against a vector broadcast through shared
// memory. Reductions are butterfly shuffles, so every lane holds the result
// and takes the same branch. The masked factor (tri::warp_factor, which
// Kernel E's warp form shares) runs warp-synchronously with
// each lane's rows in registers (in float32 at K <= 32 only columns 16-31:
// the first 16 are factored in place in shared memory, which keeps the
// instantiation at 64 registers without a spill): per pivot one shuffle, one column published
// in shared memory and one __syncwarp, then 16-byte broadcast reads of that
// column for the trailing update; it is stored packed (tri_warp.cuh) for the
// warp substitutions tri::forward/backward. The six line-search candidates'
// objectives are evaluated together (one pass over A's row for the five
// moving ones, twelve reductions interleaved), and the product A c of the
// chosen candidate is kept as the next iteration's A f.
//
// newton_qp_kernel (any K whose system fits a block): one thread block per
// system, one thread per row (blockDim is K rounded up to a warp). A and the
// masked factor live in shared memory with a padded leading dimension K+1
// so that a column walk hits 32 different banks; reductions are warp
// shuffles, combined across warps through shared memory and broadcast so
// every thread takes the same branch; about 6K block barriers an iteration.
// ops/qp.py dispatches by K: the warp form up to K = 64, this one above.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tri_warp.cuh"

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


// ------------------------------------------------ the warp-per-system form
namespace wq {

using tri::ld16;

template <typename T>
__device__ __forceinline__ T wsum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T wmax(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Shapes of one instantiation: KP = 32 R rows (K padded), V values per
// 16-byte vector. Per system, in shared memory: A (KP x KP with rows LD =
// KP + V apart, so that eight lanes reading the same 16-byte vector of eight
// consecutive rows hit 32 different banks, and every address is a base
// register plus a constant), the packed factor (tri layout,
// which also holds the five line-search candidates once the substitutions
// are done), two column buffers of the factor and one broadcast vector.
template <typename T, int R>
struct Shape {
  static constexpr int KP = 32 * R;
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int NC = KP / V;
  static constexpr int kLp = (KP * (KP + 1) / 2 + V - 1) / V * V;
  static constexpr int LD = KP + V;
  static constexpr int kPerSys = KP * LD + kLp + 3 * KP;
  // systems (warps) per block, and the blocks per SM the registers are
  // sized for: at K <= 32 in float32, 4 blocks of 8 warps (64 registers a
  // thread) hold 4,096 systems in one wave on 132 SMs
  static constexpr int kSystems = R == 1 ? 8 : 4;
  static constexpr int kMinBlocks = sizeof(T) == 4 ? (R == 1 ? 4 : 2) : 1;
  // the masked system's columns j < kShared stay in shared memory (in the
  // packed factor's own slots) rather than in registers: at 64 registers a
  // thread, 32 columns of a row in registers spill
  static constexpr int kShared = sizeof(T) == 4 && R == 1 ? 16 : 0;
};

// out[s] = (A v)_row for this lane's rows row = lane + 32 s. v goes through
// the warp's broadcast vector; A's row is read in 16-byte vectors.
template <typename T, int R>
__device__ __forceinline__ void matvec(const T* sA, T* vec, const T (&v)[R], T (&out)[R],
                                       int lane, int K) {
  using S = Shape<T, R>;
  __syncwarp();  // every lane is done with the previous vector
#pragma unroll
  for (int s = 0; s < R; ++s) {
    vec[lane + 32 * s] = v[s];
    out[s] = T(0);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < S::NC; ++c) {
    if (c * S::V >= K) break;
    T x[S::V];
    ld16(vec + c * S::V, x);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      T a[S::V];
      ld16(sA + (lane + 32 * s) * S::LD + c * S::V, a);
#pragma unroll
      for (int q = 0; q < S::V; ++q) out[s] += a[q] * x[q];
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(32 * Shape<T, R>::kSystems, Shape<T, R>::kMinBlocks)
newton_qp_warp_kernel(const T* __restrict__ A, const T* __restrict__ b,
                      const T* __restrict__ act, const T* __restrict__ f0, T* __restrict__ fout,
                      int B, int K, int iters, T tol) {
  using S = Shape<T, R>;
  constexpr int KP = S::KP, V = S::V, NC = S::NC, LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem_warp[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * S::kSystems + warp;
  if (sys >= B) return;  // no block barrier anywhere: each warp runs alone
  T* sA = reinterpret_cast<T*>(smem_warp) + (size_t)warp * S::kPerSys;
  T* Lp = sA + KP * LD;   // the factor, then the line-search candidates
  T* col = Lp + S::kLp;   // two buffers of one column of the factor
  T* vec = col + 2 * KP;  // the matvec's broadcast vector

  // A, zero-padded to KP x KP: batches of 8 plain loads per lane in flight
  const T* As = A + (size_t)sys * K * K;
#pragma unroll 1
  for (int e0 = 0; e0 < KP * KP; e0 += 32 * 8) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + 32 * u + lane, r = e / KP, j = e % KP;
      v[u] = r < K && j < K ? As[(size_t)r * K + j] : T(0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + 32 * u + lane, r = e / KP, j = e % KP;
      sA[r * LD + j] = v[u];
    }
  }
  // The 16-byte padding at the end of each of the lane's rows of A holds
  // what a lane needs before and after the factor but not during it: b_i
  // and the system's tolerance, and in float32 (four slots) the iterate f
  // and A f as well: the factor's rows take most of the 64 registers a
  // thread has when 32 warps share an SM. The active rows are one ballot
  // word.
  auto pad = [&](int s) { return sA + (lane + 32 * s) * LD + KP; };
  T f[R], Af[R];
  unsigned amask[R];
  T bmax = T(0);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + 32 * s;
    const bool in = i < K;
    const T bv = in ? b[(size_t)sys * K + i] : T(0);
    const bool a = in && act[(size_t)sys * K + i] > T(0.5);
    amask[s] = __ballot_sync(kFull, a);
    f[s] = in ? max0(f0[(size_t)sys * K + i]) * (a ? T(1) : T(0)) : T(0);
    bmax = nan_max(bmax, fabs(bv));
    pad(s)[0] = bv;
  }
  const T tol_all = tol * (T(1) + wmax(bmax));
#pragma unroll
  for (int s = 0; s < R; ++s) pad(s)[1] = tol_all;
  const T steps[5] = {T(1), T(0.5), T(0.25), T(0.0625), T(0.015625)};
  auto bit = [&](const unsigned (&m)[R], int s) { return (m[s] >> lane) & 1u ? T(1) : T(0); };
  matvec<T, R>(sA, vec, f, Af, lane, K);

  for (int it = 0;; ++it) {
    // KKT residual of the current iterate; A f is the previous iteration's
    // product of the chosen candidate (the while_loop condition)
    T g[R], rr = T(0);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      g[s] = Af[s] - pad(s)[0];
      rr = nan_max(rr, fabs(f[s] - max0(f[s] - g[s])) * bit(amask, s));
    }
    const T r = wmax(rr);
    if (it >= iters || !(r > pad(0)[1])) break;

    // projected-gradient step with exact step length along d
    T d[R], Ad[R], pdad = T(0), pdd = T(0);
#pragma unroll
    for (int s = 0; s < R; ++s)
      d[s] = ((f[s] > T(0) || g[s] < T(0)) && bit(amask, s) > T(0)) ? -g[s] : T(0);
    matvec<T, R>(sA, vec, d, Ad, lane, K);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      pdad += d[s] * Ad[s];
      pdd += d[s] * d[s];
    }
    const T dAd = wsum(pdad), dd = wsum(pdd);
    const T alpha = dAd > T(1e-30) ? tri::div(dd, fmax(dAd, T(1e-30))) : T(0);
#pragma unroll
    for (int s = 0; s < R; ++s) f[s] = max0(f[s] + alpha * d[s]);
    matvec<T, R>(sA, vec, f, Af, lane, K);

    // active set at the new point, masked system H = A o (a a^T) + diag(1-a)
    // with lane's rows in registers (h[s][j], j < 32 (s + 1))
    unsigned msk[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const T gs = Af[s] - pad(s)[0];
      const bool a = (f[s] > T(0) || gs < T(0)) && bit(amask, s) > T(0);
      msk[s] = __ballot_sync(kFull, a);
      if constexpr (V >= 4) {
        pad(s)[2] = f[s];
        pad(s)[3] = Af[s];
      }
    }
    // (columns j < kShared of a row go to its slots of the packed factor,
    // j <= row only, and are factored there in place)
    constexpr int JS = S::kShared;
    T h[R][KP];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int row = lane + 32 * s;
      T* Lrow = Lp + tri::tri(row);
      const T am = bit(msk, s);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c * V >= 32 * (s + 1)) break;
        T a[V];
        ld16(sA + row * LD + c * V, a);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int j = c * V + q;
          const T amj = (msk[j / 32] >> (j % 32)) & 1u ? T(1) : T(0);
          const T hv = a[q] * am * amj + (j == row ? T(1) - am : T(0));
          if (j >= JS) h[s][j] = hv;
          else if (j <= row) Lrow[j] = hv;
        }
      }
    }
    // the warp-synchronous masked factor (tri::warp_factor, shared with
    // Kernel E's warp form)
    tri::warp_factor<T, R, JS>(h, Lp, col, K, lane);
    // Newton direction: y = H^-1 (b o a) by the warp substitutions
    T X[R];
#pragma unroll
    for (int s = 0; s < R; ++s) X[s] = pad(s)[0] * bit(msk, s);
    __syncwarp();  // the packed factor is complete
    T inv[R];
    tri::pivots<T, R>(Lp, K, lane, inv);
    tri::forward<T, R>(Lp, inv, X, K, lane);
    tri::backward<T, R>(Lp, inv, X, K, lane);

    // projected-arc line search over [1, .5, .25, .0625, .015625, stay]:
    // the five moving candidates' products A c in one pass over A's row
    // (the candidates live in the factor's space; a lane reads its own
    // back where it needs them)
    T Ac[5][R];
    __syncwarp();  // every lane is done reading the factor
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if constexpr (V >= 4) {
        f[s] = pad(s)[2];
        Af[s] = pad(s)[3];
      }
      const T dn = max0(X[s] * bit(msk, s)) - f[s];
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        Lp[p * KP + lane + 32 * s] = max0(f[s] + steps[p] * dn);
        Ac[p][s] = T(0);
      }
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c * V >= K) break;
      T a[R][V];
#pragma unroll
      for (int s = 0; s < R; ++s) ld16(sA + (lane + 32 * s) * LD + c * V, a[s]);
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        T x[V];
        ld16(Lp + p * KP + c * V, x);
#pragma unroll
        for (int s = 0; s < R; ++s)
#pragma unroll
          for (int q = 0; q < V; ++q) Ac[p][s] += a[s][q] * x[q];
      }
    }
    // the six objectives 1/2 c^T A c - c^T b, reduced together ("stay" is
    // f, whose A f is known)
    T cAc[6], cb6[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      cAc[p] = T(0);
      cb6[p] = T(0);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const T cv = p < 5 ? Lp[p * KP + lane + 32 * s] : f[s];
        cAc[p] += cv * (p < 5 ? Ac[p][s] : Af[s]);
        cb6[p] += cv * pad(s)[0];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        cAc[p] += __shfl_xor_sync(kFull, cAc[p], o);
        cb6[p] += __shfl_xor_sync(kFull, cb6[p], o);
      }
    // argmin: the first minimum wins; a NaN value counts as the minimum
    int best = 0;
    T best_v = T(0.5) * cAc[0] - cb6[0];
#pragma unroll
    for (int p = 1; p < 6; ++p) {
      const T v = T(0.5) * cAc[p] - cb6[p];
      if ((v != v && best_v == best_v) || (best_v == best_v && v < best_v)) {
        best = p;
        best_v = v;
      }
    }
    if (best < 5) {
#pragma unroll
      for (int s = 0; s < R; ++s) f[s] = Lp[best * KP + lane + 32 * s];
    }
#pragma unroll
    for (int p = 0; p < 5; ++p)
      if (best == p)
#pragma unroll
        for (int s = 0; s < R; ++s) Af[s] = Ac[p][s];
  }
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + 32 * s;
    if (i < K) fout[(size_t)sys * K + i] = f[s];
  }
}

template <typename T, int R>
cudaError_t prepare(size_t* smem) {
  using S = Shape<T, R>;
  *smem = sizeof(T) * (size_t)S::kSystems * S::kPerSys;
  cudaError_t err = tri::allow_smem(newton_qp_warp_kernel<T, R>, *smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(newton_qp_warp_kernel<T, R>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int R>
int run(const void* A, const void* b, const void* act, const void* f0, void* f, int B, int K,
        int iters, double tol, cudaStream_t stream) {
  using S = Shape<T, R>;
  size_t smem = 0;
  cudaError_t err = prepare<T, R>(&smem);
  if (err != cudaSuccess) return (int)err;
  newton_qp_warp_kernel<T, R><<<(B + S::kSystems - 1) / S::kSystems, 32 * S::kSystems, smem,
                                stream>>>((const T*)A, (const T*)b, (const T*)act, (const T*)f0,
                                          (T*)f, B, K, iters, (T)tol);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A, const void* b, const void* act, const void* f0, void* f, int B, int K,
           int iters, double tol, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 32) return run<T, 1>(A, b, act, f0, f, B, K, iters, tol, s);
  if (K <= 64) return run<T, 2>(A, b, act, f0, f, B, K, iters, tol, s);
  return (int)cudaErrorInvalidValue;
}

// {registers, local memory bytes, bytes of the element type, R, resident
// systems per SM} of instantiation i; -1 past the last one
template <typename T, int R>
int attrs(int* out) {
  size_t smem = 0;
  cudaError_t err = prepare<T, R>(&smem);
  if (err != cudaSuccess) return (int)err;
  const int e = tri::attributes((const void*)newton_qp_warp_kernel<T, R>, out);
  if (e != 0) return e;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, newton_qp_warp_kernel<T, R>,
                                                      32 * Shape<T, R>::kSystems, smem);
  if (err != cudaSuccess) return (int)err;
  out[2] = (int)sizeof(T);
  out[3] = R;
  out[4] = blocks * Shape<T, R>::kSystems;
  return 0;
}

}  // namespace wq

}  // namespace

// The warp-per-system form, K <= 64: a warp runs each system, several
// systems share a block. The launch goes to `stream` on the current device;
// returns cudaGetLastError() (cudaErrorInvalidValue above K = 64).
extern "C" int newton_qp_warp_f32(const void* A, const void* b, const void* act, const void* f0,
                                  void* f, int B, int K, int iters, double tol, void* stream) {
  return wq::launch<float>(A, b, act, f0, f, B, K, iters, tol, stream);
}

extern "C" int newton_qp_warp_f64(const void* A, const void* b, const void* act, const void* f0,
                                  void* f, int B, int K, int iters, double tol, void* stream) {
  return wq::launch<double>(A, b, act, f0, f, B, K, iters, tol, stream);
}

extern "C" int newton_qp_warp_attrs(int i, int* out) {
  switch (i) {
    case 0: return wq::attrs<float, 1>(out);
    case 1: return wq::attrs<float, 2>(out);
    case 2: return wq::attrs<double, 1>(out);
    case 3: return wq::attrs<double, 2>(out);
    default: return -1;
  }
}

// The block-per-system form, any K whose system fits a block (K <= 1024).
// The launch goes to `stream` on the current device; returns cudaGetLastError().
extern "C" int newton_qp_f32(const void* A, const void* b, const void* act, const void* f0,
                             void* f, int B, int K, int iters, double tol, void* stream) {
  return launch<float>(A, b, act, f0, f, B, K, iters, tol, stream);
}

extern "C" int newton_qp_f64(const void* A, const void* b, const void* act, const void* f0,
                             void* f, int B, int K, int iters, double tol, void* stream) {
  return launch<double>(A, b, act, f0, f, B, K, iters, tol, stream);
}
