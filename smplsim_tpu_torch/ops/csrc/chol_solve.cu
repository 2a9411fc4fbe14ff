// Batched fused SPD factor + solve for Hopper (sm_90a):
//     x = (A + diag(d))^-1 b        A (B,n,n), b (B,n,m), d (B,n) or null,
// and the factor alone (Kernel E's column form: L = chol(A), no right-hand
// side).
//
// chol_solve_tiled_* (Kernel A) replaces the TPU kernel
// smplsim_tpu/ops/linalg_kernels.py::chol_solve_lanes (body
// _chol_solve_only_kernel). The uhc_pd path calls it twice per substep, at
// n=75: m=1 with d = dt kd (stable PD) and m=33 (smooth + Delassus).
//
// What bounds it on the H100: at n=75 a system moves 12 KB (m=1) to 31 KB
// (m=33) in float32 (A's triangle, d, b and x) and needs 1.5e5 to 5.1e5
// flops, so 4096 systems are bound by bytes at 0.015 and 0.038 ms; the work
// itself is n dependent pivots in the factor and n more in each
// substitution, so the time is the latency of one system times the waves
// of resident blocks.
//
// Design (one block per system, no block barrier after the factor):
//   * Load: A's lower triangle, packed, into shared memory (tri_warp.cuh),
//     batches of plain loads in flight together, no division per element.
//   * Factor: Kernel C's tiled register factor (tri::factor_tiles): 4x4
//     tiles of the triangle in registers, ownership found once, 4-column
//     panels with two block barriers each, the diagonal tile factored in
//     registers by every panel owner. The diagonal shift d is added into
//     the diagonal tiles as they are loaded. The factor never leaves the
//     chip.
//   * Solve, by m. m <= 4 (kThreadCols false): a warp per right-hand-side
//     column on the factor packed in the tri layout, x in registers, one
//     shuffle and one FMA per row per step (tri::forward/backward, Kernel
//     C's and D's). m > 4: a thread per column on the factor in the
//     row-aligned layout, rows in 8-row register blocks
//     (tri::cols_forward/cols_backward, Kernel D's wide form); the forward
//     pass leaves y in the thread's column of Xs and the backward pass
//     overwrites it with x.
//   * Right-hand-side chunks (the thread form): Xs holds cw column slots,
//     the most that fit the shared memory left after the factor's region,
//     in whole warps, and at most the m rounded up to the solve threads.
//     The columns are solved cw at a time (ceil(m / cw) chunks), in the
//     same launch, on the one factor; a column's arithmetic does not
//     depend on its slot, so the chunked solve equals the unchunked one
//     bit for bit. With one chunk
//     the launch is the unchunked kernel. Chunks lift the limit that sent
//     n = 159, m = 65 in float64 (233,088 B unchunked) to the column
//     kernel: every n <= 176, m <= 65 in either type runs here.
//   * Float32 uses the special-function reciprocal and square root with
//     Newton steps (tri::div, tri::root): no call to the slow-path
//     subroutines, no local memory. FP32 FMA, no TF32.
// The tiles hold n <= 176; above that ops/linalg.py dispatches by shape to
// the column kernel below.
//
// chol_solve_kernel, the column kernel, serves chol_solve_* (every n whose
// system fits a block's shared memory) and cholesky_* (Kernel E above
// n = 176, the factor alone; cho_factor_solve.cu holds E's warp and tiled
// forms below that, which ops/linalg.py picks by shape). One block per
// system: the lower triangle of H = A + diag(d) and the right-hand side in
// shared memory, a right-looking column Cholesky (threads over the trailing
// triangle, 3n block barriers), then forward and back substitution
// (threads over rows x rhs columns, 2n barriers each). cholesky writes the
// factor out once as a full (n,n) matrix with exact zeros above the
// diagonal. It is bound by that barrier chain (3n barriers in the
// factor alone). The TPU's panel
// blocking, rhs chunking and 128-lane padding are VMEM and lane devices and
// are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tri_warp.cuh"

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


// ------------------------------------------------------------- Kernel A
using tri::rowoff;
using tri::tri;

constexpr int kTiledThreads = 256;

// entries of the factor's region in shared memory: the packed triangle, or
// with kThreadCols the row-aligned one over n rounded up to 8 rows
template <bool kThreadCols>
__host__ __device__ __forceinline__ int lp_entries(int n) {
  const int n8 = (n + tri::kRB - 1) / tri::kRB * tri::kRB;
  return kThreadCols ? (rowoff(n8) > tri(n) ? rowoff(n8) : tri(n)) : tri(n);
}

template <typename T, int TPT, int R, bool kThreadCols>
__global__ void __launch_bounds__(kTiledThreads)
chol_solve_tiled_kernel(const T* __restrict__ A, const T* __restrict__ b,
                        const T* __restrict__ diag, T* __restrict__ x, int n, int m, int mw,
                        int cw) {
  extern __shared__ __align__(16) unsigned char smem_tiled[];
  const int ntr = (n + 3) >> 2;
  T* D = reinterpret_cast<T*>(smem_tiled);  // the next diagonal tile (4x4)
  T* PB = D + 16;                         // the panel's factor tiles (ntr x 4x4)
  T* Lp = PB + 16 * ntr;                  // the triangle, then the factor
  const int sys = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  tri::load_lower<T, false, 8>(Lp, A + (size_t)sys * n * n, n, tid, nt);
  __syncthreads();
  tri::factor_tiles<T, TPT, kThreadCols>(D, PB, Lp, diag ? diag + (size_t)sys * n : nullptr, n,
                                         tid, nt);

  const T* bs = b + (size_t)sys * n * m;
  T* xs = x + (size_t)sys * n * m;
  if (!kThreadCols) {
    if (warp < m) tri::cho_solve_warps<T, R>(Lp, bs, xs, n, m, warp, nwarps, lane);
  } else {
    // (n8, cw): y, then x, by column slot; columns c0 + s of chunk c0 in
    // slot s, each slot owned by one thread across the chunks
    T* Xs = Lp + lp_entries<true>(n);
    for (int c0 = 0; c0 < m; c0 += cw) {
      for (int s = tid; s < cw && c0 + s < mw; s += nt) {
        const int c = c0 + s;
        const bool live = c < m;
        tri::cols_forward<T>(
            Lp, Xs, cw, s, n, [&](int i) { return live ? bs[(size_t)i * m + c] : T(0); },
            [](int, T) {});
        tri::cols_backward<T>(
            Lp, Xs, cw, s, n, [&](int i) { return Xs[i * cw + s]; },
            [&](int i, T v) {
              if (live) xs[(size_t)i * m + c] = v;
            });
      }
    }
  }
}

// threads and rhs width of the thread-per-column form: a thread per column
// up to 256, every column slot of Xs covered by the loop over tid
inline int tiled_threads(int n, int m, int tpt, bool thread_cols, int* mw) {
  int solve = thread_cols ? (m + 31) / 32 * 32 : 32 * (m < 8 ? m : 8);
  if (solve > kTiledThreads) solve = kTiledThreads;
  if (solve < 32) solve = 32;
  *mw = thread_cols ? (m + solve - 1) / solve * solve : 0;
  const int f = tri::tile_threads(n, tpt);
  return f > solve ? f : solve;
}

constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block may use

// Shared memory of the tiled form and the column slots cw of one rhs chunk:
// the factor's region, then as many whole warps of slots as fit, at most
// mw. Returns 0 where not one warp of slots fits (ops/linalg.py mirrors
// this in chol_solve_tiled_layout).
template <typename T, bool kThreadCols>
size_t tiled_smem(int n, int mw, int* cw) {
  const int n8 = (n + tri::kRB - 1) / tri::kRB * tri::kRB;
  const size_t base = 16 + 16 * (size_t)((n + 3) / 4) + (size_t)lp_entries<kThreadCols>(n);
  *cw = 0;
  if (sizeof(T) * base > kSmemMax) return 0;
  if (kThreadCols) {
    const int fit = (int)((kSmemMax / sizeof(T) - base) / n8) / 32 * 32;
    *cw = fit < mw ? fit : mw;
    if (*cw < 32) return 0;
  }
  return sizeof(T) * (base + (size_t)n8 * *cw);
}

template <typename T, int TPT, int R, bool kThreadCols>
int run_tiled(const void* A, const void* b, const void* diag, void* x, int B, int n, int m,
              cudaStream_t stream) {
  int mw = 0, cw = 0;
  const int threads = tiled_threads(n, m, TPT, kThreadCols, &mw);
  if (threads > kTiledThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = tiled_smem<T, kThreadCols>(n, mw, &cw);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = tri::allow_smem(chol_solve_tiled_kernel<T, TPT, R, kThreadCols>, smem);
  if (err != cudaSuccess) return (int)err;
  chol_solve_tiled_kernel<T, TPT, R, kThreadCols><<<B, threads, smem, stream>>>(
      (const T*)A, (const T*)b, (const T*)diag, (T*)x, n, m, mw, cw);
  return (int)cudaGetLastError();
}

// What a launch of (n, m) in form `form` takes: out = {threads, dynamic
// shared memory bytes, rhs chunk width cw (0 in the warp form), resident
// blocks per SM, registers per thread}.
template <typename T, int TPT, int R, bool kThreadCols>
int occupancy_of(int n, int m, int* out) {
  int mw = 0, cw = 0;
  const int threads = tiled_threads(n, m, TPT, kThreadCols, &mw);
  const size_t smem = tiled_smem<T, kThreadCols>(n, mw, &cw);
  if (threads > kTiledThreads || smem == 0) return (int)cudaErrorInvalidValue;
  auto fn = chol_solve_tiled_kernel<T, TPT, R, kThreadCols>;
  cudaError_t err = tri::allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  int attrs[2];
  const int rc = tri::attributes((const void*)fn, attrs);
  out[0] = threads;
  out[1] = (int)smem;
  out[2] = cw;
  out[3] = blocks;
  out[4] = attrs[0];
  return rc;
}

// tiles per thread TPT and solve rows per lane R by n, as Kernel C (n <=
// 176), but for the thread-per-column form at n <= 64, which takes TPT 2:
// at TPT 1 ptxas holds it to 64 registers and spills
// f(TPT, R) on the instantiation of order n, the TPT and R as
// std::integral_constant
template <int V>
using IC = std::integral_constant<int, V>;
template <bool kThreadCols, class F>
int by_order(int n, F f) {
  if (kThreadCols && n <= 64) return f(IC<2>{}, IC<1>{});
  if (n <= 32) return f(IC<1>{}, IC<1>{});
  if (n <= 64) return f(IC<1>{}, IC<2>{});
  if (n <= 96) return f(IC<2>{}, IC<kThreadCols ? 1 : 3>{});
  if (n <= 128) return f(IC<4>{}, IC<kThreadCols ? 1 : 4>{});
  if (n <= 176) return f(IC<4>{}, IC<kThreadCols ? 1 : 6>{});
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kThreadCols>
int launch_tiled(const void* A, const void* b, const void* diag, void* x, int B, int n, int m,
                 cudaStream_t s) {
  return by_order<kThreadCols>(n, [&](auto tpt, auto r) {
    return run_tiled<T, decltype(tpt)::value, decltype(r)::value, kThreadCols>(A, b, diag, x, B,
                                                                                n, m, s);
  });
}

template <typename T>
int tiled(const void* A, const void* b, const void* diag, void* x, int B, int n, int m, int form,
          void* stream) {
  if (B <= 0 || n <= 0 || m <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 0) return launch_tiled<T, false>(A, b, diag, x, B, n, m, s);
  if (form == 1) return launch_tiled<T, true>(A, b, diag, x, B, n, m, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kThreadCols>
int occupancy(int n, int m, int* out) {
  return by_order<kThreadCols>(n, [&](auto tpt, auto r) {
    return occupancy_of<T, decltype(tpt)::value, decltype(r)::value, kThreadCols>(n, m, out);
  });
}

struct Inst {
  const void* fn;
  int dtype_bytes, tpt, r;  // r: warp-form rows per lane, 0 for a thread per column
};

#define CS_WARP(T, TPT, R) {(const void*)chol_solve_tiled_kernel<T, TPT, R, false>, (int)sizeof(T), TPT, R}
#define CS_COLS(T, TPT) {(const void*)chol_solve_tiled_kernel<T, TPT, 1, true>, (int)sizeof(T), TPT, 0}
const Inst kInsts[] = {
    CS_WARP(float, 1, 1),  CS_WARP(float, 1, 2),  CS_WARP(float, 2, 3),  CS_WARP(float, 4, 4),
    CS_WARP(float, 4, 6),  CS_COLS(float, 2),     CS_COLS(float, 4),     CS_WARP(double, 1, 1),
    CS_WARP(double, 1, 2), CS_WARP(double, 2, 3), CS_WARP(double, 4, 4), CS_WARP(double, 4, 6),
    CS_COLS(double, 2),    CS_COLS(double, 4)};
#undef CS_WARP
#undef CS_COLS

}  // namespace

// Kernel A: x = (A + diag(d))^-1 b for n <= 176; form 0 solves with a warp
// per rhs column, 1 with a thread per column. The launch goes to `stream` on
// the current device; returns cudaGetLastError() (cudaErrorInvalidValue for
// a shape the tiles or a block's shared memory do not hold).
extern "C" int chol_solve_tiled_f32(const void* A, const void* b, const void* diag, void* x,
                                    int B, int n, int m, int form, void* stream) {
  return tiled<float>(A, b, diag, x, B, n, m, form, stream);
}

extern "C" int chol_solve_tiled_f64(const void* A, const void* b, const void* diag, void* x,
                                    int B, int n, int m, int form, void* stream) {
  return tiled<double>(A, b, diag, x, B, n, m, form, stream);
}

// Kernel A's launch of (n, m) in form `form` (0 warp, 1 thread per column)
// for elements of `dtype_bytes` (4 or 8): out = {threads, dynamic shared
// memory bytes, rhs chunk width (0 in the warp form), resident blocks per
// SM, registers per thread}. Returns a CUDA error code.
extern "C" int chol_solve_tiled_occupancy(int n, int m, int dtype_bytes, int form, int* out) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  if (dtype_bytes == 4)
    return form ? occupancy<float, true>(n, m, out) : occupancy<float, false>(n, m, out);
  if (dtype_bytes == 8)
    return form ? occupancy<double, true>(n, m, out) : occupancy<double, false>(n, m, out);
  return (int)cudaErrorInvalidValue;
}

// Instantiation i of Kernel A: out = {registers per thread, local memory
// bytes per thread, bytes of the element type, TPT, R (0: a thread per
// column)}. Returns -1 past the last one, else a CUDA error code.
extern "C" int chol_solve_tiled_attrs(int i, int* out) {
  if (i < 0 || i >= (int)(sizeof(kInsts) / sizeof(kInsts[0]))) return -1;
  const Inst& k = kInsts[i];
  out[2] = k.dtype_bytes;
  out[3] = k.tpt;
  out[4] = k.r;
  return tri::attributes(k.fn, out);
}

// The column kernel: x = (A + diag(d))^-1 b for any n whose system fits a
// block's shared memory. The launch goes to `stream` on the current device;
// returns cudaGetLastError().
extern "C" int chol_solve_f32(const void* A, const void* b, const void* diag, void* x,
                              int B, int n, int m, void* stream) {
  return launch<float, false>(A, b, diag, x, nullptr, B, n, m, stream);
}

extern "C" int chol_solve_f64(const void* A, const void* b, const void* diag, void* x,
                              int B, int n, int m, void* stream) {
  return launch<double, false>(A, b, diag, x, nullptr, B, n, m, stream);
}

// L (B,n,n), the lower Cholesky factor of each SPD A (B,n,n) with exact zeros
// above the diagonal (only the lower triangle of A is read): Kernel E's
// column form, for any n whose system fits a block's shared memory.
extern "C" int cholesky_f32(const void* A, void* L, int B, int n, void* stream) {
  return launch<float, true>(A, nullptr, nullptr, nullptr, L, B, n, 0, stream);
}

extern "C" int cholesky_f64(const void* A, void* L, int B, int n, void* stream) {
  return launch<double, true>(A, nullptr, nullptr, nullptr, L, B, n, 0, stream);
}
