// Batched SPD factor + solve for Hopper (sm_90a):
//     L = chol(A), x = A^-1 b       A (B,n,n), b (B,n,m)      (Kernel C)
//     L = chol(A)                   A (B,n,n)                 (Kernel E)
// L returned with exact zeros above the diagonal; only the lower triangle
// of A is read.
//
// Kernel C replaces the TPU kernel smplsim_tpu/ops/linalg_kernels.py::
// chol_solve_batched (body _chol_solve_kernel). Kernel E replaces
// linalg_kernels.py::cholesky_batched (body _chol_kernel), the factor that
// the contact QP's implicit-function derivative solves with (ops/qp.py,
// once per substep under forward AD, at n = K = 32 on 880 systems).
//
// What bounds them on the H100: at n=75, m=1 a system of C moves 34.5 KB
// in float32 (A's triangle read, the full L written, b and x) for n^3/3 +
// 2 n^2 flops, so 4096 systems are bound by bytes at 0.042 ms; E at K=32
// moves 6.2 KB a system, 880 systems at 0.0016 ms. The factor is n
// dependent column steps, each a rank-1 update of the trailing triangle,
// so both run at the latency of one system's chain times the waves.
//
// C, and E at 64 < n <= 176 (cho_factor_solve_kernel, kSolve false for E):
// one block per system, the factor in registers (tri::factor_tiles in
// tri_warp.cuh, which Kernel A shares).
//   * Load: A's lower triangle, packed, into shared memory (tri_warp.cuh):
//     batches of plain loads in flight together, no division per element.
//   * Ownership: the lower triangle is cut into 4x4 tiles, numbered down the
//     tile columns, and thread t keeps tiles t, t + P, ... (TPT of them) in
//     registers for the whole factor. The tile coordinates are found once;
//     no loop divides, and tiles above the diagonal do not exist. Rows past
//     n are identity, so the last diagonal tile stays finite.
//   * Blocked right-looking factor over 4-column panels, two block barriers
//     per panel (n/2 in all, against 3n in the column-by-column factor of
//     chol_solve.cu, which A and E keep above n = 176). (a) The owners of
//     panel p's tiles each factor the diagonal tile from a shared copy (a
//     4x4 Cholesky in registers) and turn their tile into
//     L_ip = A_ip L_pp^-T, written to a panel buffer. (b) Every trailing
//     tile takes A_ij -= L_ip L_jp^T, 64 FMAs from eight vector loads of
//     the buffer, and the owner of the next diagonal tile copies it out. The
//     same tiles stepped column by column (one barrier and a rank-1 update
//     of 16 FMAs per tile per column) measured slower on the H100: a column
//     step's latency is mostly the barrier and the pivot, not the FMAs.
//   * FP32 FMA on the CUDA cores: TF32 tensor cores would miss the 1e-5
//     factor and residual gates.
//   * Solve (C only): the factor goes back to the packed triangle in shared
//     memory; one warp per right-hand-side column runs the forward and the
//     back substitution with x in registers (tri_warp.cuh), no block
//     barrier.
//   * Store: L row by row, coalesced, zeros above the diagonal written with
//     it.
//
// E at n <= 64 (cholesky_warp_kernel): a warp per system, one system to a
// block (880 blocks spread over all 132 SMs; 2, 4 or 8 to a block measured
// the same), no block barrier anywhere. A block of 256 threads per 32x32
// system (the column kernel) left most threads idle at 3n barriers.
//   * Load: the lower triangle into a packed triangle of the warp's own in
//     shared memory (tri::load_lower), then each lane takes its rows l and
//     l + 32 into registers.
//   * Factor: tri::warp_factor, Kernel B's masked factor without the mask:
//     per pivot one shuffle, the square root and reciprocal rounded as the
//     plain version's are, one column published in shared memory and one
//     __syncwarp, then the trailing update from 16-byte broadcast reads.
//     In float64 at n > 32 a row's first 16 columns stay in shared memory
//     (WarpShape::kShared).
//   * Store: L row by row from the packed factor, coalesced, the zeros
//     above the diagonal with it.
// The TPU kernels' panel blocking, rhs chunking and 128-lane padding are
// VMEM and lane devices and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_warp.cuh"

namespace {

using tri::tri;

constexpr int kMaxThreads = 256;

template <typename T, int TPT, int R, bool kSolve>
__global__ void __launch_bounds__(kMaxThreads)
cho_factor_solve_kernel(const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ Lout,
                        T* __restrict__ x, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ntr = (n + 3) >> 2;              // tile rows
  T* D = reinterpret_cast<T*>(smem_raw);     // the next diagonal tile, updated (4x4)
  T* PB = D + 16;                            // the panel's factor tiles (ntr x 4x4)
  T* Lp = PB + 16 * ntr;                     // packed lower triangle
  const int sys = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  // a block of 96 threads at n=75 copies 30 entries each: batches of 8 keep
  // the loader's registers below the factor's
  tri::load_lower<T, false, 8>(Lp, A + (size_t)sys * n * n, n, tid, nt);
  __syncthreads();
  tri::factor_tiles<T, TPT, false>(D, PB, Lp, nullptr, n, tid, nt);

  if constexpr (kSolve) {
    if (warp < m)
      tri::cho_solve_warps<T, R>(Lp, b + (size_t)sys * n * m, x + (size_t)sys * n * m, n, m,
                                 warp, nwarps, lane);
  }
  T* Ls = Lout + (size_t)sys * n * n;
#pragma unroll 2
  for (int i = warp; i < n; i += nwarps)
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int j = lane + 32 * s;
      if (j < n) Ls[(size_t)i * n + j] = j <= i ? Lp[tri(i) + j] : T(0);
    }
}

template <typename T, int TPT, int R, bool kSolve>
int run(const void* A, const void* b, void* L, void* x, int B, int n, int m,
        cudaStream_t stream) {
  const int ntr = (n + 3) / 4;
  const int threads = tri::tile_threads(n, TPT);
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * (16 + 16 * (size_t)ntr + (size_t)tri(n));
  cudaError_t err = tri::allow_smem(cho_factor_solve_kernel<T, TPT, R, kSolve>, smem);
  if (err != cudaSuccess) return (int)err;
  cho_factor_solve_kernel<T, TPT, R, kSolve><<<B, threads, smem, stream>>>(
      (const T*)A, (const T*)b, (T*)L, (T*)x, n, m);
  return (int)cudaGetLastError();
}

// tiles per thread TPT and solve (and store) rows per lane R by n: at most
// 256 threads per system, n <= 176; without kSolve, L alone (Kernel E)
template <typename T, bool kSolve>
int launch(const void* A, const void* b, void* L, void* x, int B, int n, int m, void* stream_) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream_;
  if (n <= 32) return run<T, 1, 1, kSolve>(A, b, L, x, B, n, m, s);
  if (n <= 64) return run<T, 1, 2, kSolve>(A, b, L, x, B, n, m, s);
  if (n <= 96) return run<T, 2, 3, kSolve>(A, b, L, x, B, n, m, s);
  if (n <= 128) return run<T, 4, 4, kSolve>(A, b, L, x, B, n, m, s);
  if (n <= 176) return run<T, 4, 6, kSolve>(A, b, L, x, B, n, m, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------ Kernel E, the warp form
// Per system in shared memory: the packed triangle (rounded up to a 16-byte
// vector) and two column buffers. Columns j < kShared of a row stay in the
// packed triangle through the factor: in float64 at n <= 64 a lane's two
// rows (96 entries) would take 192 registers.
template <typename T, int R>
struct WarpShape {
  static constexpr int KP = 32 * R;
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int kLp = (KP * (KP + 1) / 2 + V - 1) / V * V;
  static constexpr int kPerSys = kLp + 2 * KP;
  static constexpr int kShared = sizeof(T) == 8 && R == 2 ? 16 : 0;
};

// One warp, one block, one system.
template <typename T, int R>
__global__ void __launch_bounds__(32)
cholesky_warp_kernel(const T* __restrict__ A, T* __restrict__ Lout, int n) {
  using S = WarpShape<T, R>;
  constexpr int KP = S::KP, JS = S::kShared;
  extern __shared__ __align__(16) unsigned char smem_warp[];
  const int lane = threadIdx.x;
  const size_t sys = blockIdx.x;
  T* Lp = reinterpret_cast<T*>(smem_warp);
  T* col = Lp + S::kLp;

  tri::load_lower<T>(Lp, A + sys * n * n, n, lane, 32);
  __syncwarp();
  // the lane's rows into registers (columns j >= JS; rows past n identity,
  // in registers and in the packed slots past row n - 1 alike)
  T h[R][KP];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int row = lane + 32 * s;
#pragma unroll
    for (int j = 0; j < 32 * (s + 1); ++j) {
      if (j >= JS) h[s][j] = row >= n ? T(j == row) : j <= row ? Lp[tri(row) + j] : T(0);
      else if (row >= n && j <= row) Lp[tri(row) + j] = T(j == row);
    }
  }
  tri::warp_factor<T, R, JS>(h, Lp, col, n, lane);
  __syncwarp();
  // L row by row, coalesced, with the zeros above the diagonal
  T* Ls = Lout + sys * n * n;
#pragma unroll 2
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int j = lane + 32 * s;
      if (j < n) Ls[(size_t)i * n + j] = j <= i ? Lp[tri(i) + j] : T(0);
    }
}

template <typename T, int R>
int warp_run(const void* A, void* L, int B, int n, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)WarpShape<T, R>::kPerSys;
  const cudaError_t err = tri::allow_smem(cholesky_warp_kernel<T, R>, smem);
  if (err != cudaSuccess) return (int)err;
  cholesky_warp_kernel<T, R><<<B, 32, smem, stream>>>((const T*)A, (T*)L, n);
  return (int)cudaGetLastError();
}

template <typename T>
int warp_launch(const void* A, void* L, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 32) return warp_run<T, 1>(A, L, B, n, s);
  if (n <= 64) return warp_run<T, 2>(A, L, B, n, s);
  return (int)cudaErrorInvalidValue;
}

struct Inst {
  const void* fn;
  int dtype_bytes, tpt, r;
};

#define CFS_INST(T, TPT, R) {(const void*)cho_factor_solve_kernel<T, TPT, R, true>, (int)sizeof(T), TPT, R}
const Inst kInsts[] = {
    CFS_INST(float, 1, 1),  CFS_INST(float, 1, 2),  CFS_INST(float, 2, 3),
    CFS_INST(float, 4, 4),  CFS_INST(float, 4, 6),  CFS_INST(double, 1, 1),
    CFS_INST(double, 1, 2), CFS_INST(double, 2, 3), CFS_INST(double, 4, 4),
    CFS_INST(double, 4, 6)};
#undef CFS_INST

// Kernel E's instantiations: the warp form (TPT 0) and the tiled factor
// without a solve
#define E_WARP(T, R) {(const void*)cholesky_warp_kernel<T, R>, (int)sizeof(T), 0, R}
#define E_TILED(T, TPT, R) {(const void*)cho_factor_solve_kernel<T, TPT, R, false>, (int)sizeof(T), TPT, R}
const Inst kCholInsts[] = {
    E_WARP(float, 1),          E_WARP(float, 2),          E_TILED(float, 1, 1),
    E_TILED(float, 1, 2),      E_TILED(float, 2, 3),      E_TILED(float, 4, 4),
    E_TILED(float, 4, 6),      E_WARP(double, 1),         E_WARP(double, 2),
    E_TILED(double, 1, 1),     E_TILED(double, 1, 2),     E_TILED(double, 2, 3),
    E_TILED(double, 4, 4),     E_TILED(double, 4, 6)};
#undef E_WARP
#undef E_TILED

int inst_attrs(const Inst& k, int* out) {
  out[2] = k.dtype_bytes;
  out[3] = k.tpt;
  out[4] = k.r;
  return tri::attributes(k.fn, out);
}

}  // namespace

// L (B,n,n) and x (B,n,m) with L L^T = A, A x = b. The launch goes to
// `stream` on the current device; returns cudaGetLastError().
extern "C" int cho_factor_solve_f32(const void* A, const void* b, void* L, void* x, int B,
                                    int n, int m, void* stream) {
  return launch<float, true>(A, b, L, x, B, n, m, stream);
}

extern "C" int cho_factor_solve_f64(const void* A, const void* b, void* L, void* x, int B,
                                    int n, int m, void* stream) {
  return launch<double, true>(A, b, L, x, B, n, m, stream);
}

// Kernel E, L (B,n,n) with L L^T = A and exact zeros above the diagonal.
// The warp form (n <= 64): a warp per system, one system to a block. The
// tiled form (n <= 176): C's factor and store, no solve. The
// launch goes to `stream` on the current device; returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape the form does not
// hold).
extern "C" int cholesky_warp_f32(const void* A, void* L, int B, int n, void* stream) {
  return warp_launch<float>(A, L, B, n, stream);
}

extern "C" int cholesky_warp_f64(const void* A, void* L, int B, int n, void* stream) {
  return warp_launch<double>(A, L, B, n, stream);
}

extern "C" int cholesky_tiled_f32(const void* A, void* L, int B, int n, void* stream) {
  return launch<float, false>(A, nullptr, L, nullptr, B, n, 0, stream);
}

extern "C" int cholesky_tiled_f64(const void* A, void* L, int B, int n, void* stream) {
  return launch<double, false>(A, nullptr, L, nullptr, B, n, 0, stream);
}

// Instantiation i of the kernel: out = {registers per thread, local memory
// bytes per thread, bytes of the element type, TPT, R}. Returns -1 past the
// last one, else a CUDA error code.
extern "C" int cho_factor_solve_attrs(int i, int* out) {
  if (i < 0 || i >= (int)(sizeof(kInsts) / sizeof(kInsts[0]))) return -1;
  return inst_attrs(kInsts[i], out);
}

// Kernel E's instantiation i: out = {registers per thread, local memory
// bytes per thread, bytes of the element type, TPT (0: the warp form), R
// (rows per lane)}. Returns -1 past the last one, else a CUDA error code.
extern "C" int cholesky_attrs(int i, int* out) {
  if (i < 0 || i >= (int)(sizeof(kCholInsts) / sizeof(kCholInsts[0]))) return -1;
  return inst_attrs(kCholInsts[i], out);
}
