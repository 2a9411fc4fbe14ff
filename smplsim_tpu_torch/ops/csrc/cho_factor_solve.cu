// Batched SPD factor + solve for Hopper (sm_90a):
//     L = chol(A), x = A^-1 b       A (B,n,n), b (B,n,m),
// L returned with exact zeros above the diagonal.
//
// Replaces the TPU kernel smplsim_tpu/ops/linalg_kernels.py::
// chol_solve_batched (body _chol_solve_kernel). Only the lower triangle of A
// is read.
//
// What bounds it on the H100: at n=75, m=1 a system moves 34.5 KB in
// float32 (A's triangle read, the full L written, b and x) for n^3/3 + 2 n^2
// flops, so 4096 systems are bound by bytes at 0.042 ms; the factor is n
// dependent column steps, each a rank-1 update of the trailing triangle.
//
// Design: one block per system, the factor in registers (tri::factor_tiles
// in tri_warp.cuh, which Kernel A shares).
//   * Load: A's lower triangle, packed, into shared memory (tri_warp.cuh):
//     batches of plain loads in flight together, no division per element.
//   * Ownership: the lower triangle is cut into 4x4 tiles, numbered down the
//     tile columns, and thread t keeps tiles t, t + P, ... (TPT of them) in
//     registers for the whole factor. The tile coordinates are found once;
//     no loop divides, and tiles above the diagonal do not exist. Rows past
//     n are identity, so the last diagonal tile stays finite.
//   * Blocked right-looking factor over 4-column panels, two block barriers
//     per panel (n/2 in all, against 3n in the column-by-column factor of
//     chol_solve.cu, which A and E share). (a) The owners of panel p's
//     tiles each factor the diagonal tile from a shared copy (a 4x4
//     Cholesky in registers) and turn their tile into L_ip = A_ip L_pp^-T,
//     written to a panel buffer. (b) Every trailing tile takes
//     A_ij -= L_ip L_jp^T, 64 FMAs from eight vector loads of the buffer,
//     and the owner of the next diagonal tile copies it out. The same tiles
//     stepped column by column (one barrier and a rank-1 update of 16 FMAs
//     per tile per column) measured slower on the H100: a column step's
//     latency is mostly the barrier and the pivot, not the FMAs.
//   * FP32 FMA on the CUDA cores: TF32 tensor cores would miss the 1e-5
//     factor and residual gates.
//   * Solve: the factor goes back to the packed triangle in shared memory;
//     one warp per right-hand-side column runs the forward and the back
//     substitution with x in registers (tri_warp.cuh), no block barrier.
//   * Store: L row by row, coalesced, zeros above the diagonal written with
//     it.
// The TPU kernel's panel blocking, rhs chunking and 128-lane padding are
// VMEM and lane devices and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_warp.cuh"

namespace {

using tri::tri;

constexpr int kMaxThreads = 256;

template <typename T, int TPT, int R>
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

  const T* bs = b + (size_t)sys * n * m;
  T* xs = x + (size_t)sys * n * m;
  if (warp < m) tri::cho_solve_warps<T, R>(Lp, bs, xs, n, m, warp, nwarps, lane);
  T* Ls = Lout + (size_t)sys * n * n;
#pragma unroll 2
  for (int i = warp; i < n; i += nwarps)
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int j = lane + 32 * s;
      if (j < n) Ls[(size_t)i * n + j] = j <= i ? Lp[tri(i) + j] : T(0);
    }
}

template <typename T, int TPT, int R>
int run(const void* A, const void* b, void* L, void* x, int B, int n, int m,
        cudaStream_t stream) {
  const int ntr = (n + 3) / 4;
  const int threads = tri::tile_threads(n, TPT);
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * (16 + 16 * (size_t)ntr + (size_t)tri(n));
  cudaError_t err = tri::allow_smem(cho_factor_solve_kernel<T, TPT, R>, smem);
  if (err != cudaSuccess) return (int)err;
  cho_factor_solve_kernel<T, TPT, R><<<B, threads, smem, stream>>>(
      (const T*)A, (const T*)b, (T*)L, (T*)x, n, m);
  return (int)cudaGetLastError();
}

// tiles per thread TPT and solve rows per lane R by n: at most 256 threads
// per system, n <= 176
template <typename T>
int launch(const void* A, const void* b, void* L, void* x, int B, int n, int m, void* stream_) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream_;
  if (n <= 32) return run<T, 1, 1>(A, b, L, x, B, n, m, s);
  if (n <= 64) return run<T, 1, 2>(A, b, L, x, B, n, m, s);
  if (n <= 96) return run<T, 2, 3>(A, b, L, x, B, n, m, s);
  if (n <= 128) return run<T, 4, 4>(A, b, L, x, B, n, m, s);
  if (n <= 176) return run<T, 4, 6>(A, b, L, x, B, n, m, s);
  return (int)cudaErrorInvalidValue;
}

struct Inst {
  const void* fn;
  int dtype_bytes, tpt, r;
};

#define CFS_INST(T, TPT, R) {(const void*)cho_factor_solve_kernel<T, TPT, R>, (int)sizeof(T), TPT, R}
const Inst kInsts[] = {
    CFS_INST(float, 1, 1),  CFS_INST(float, 1, 2),  CFS_INST(float, 2, 3),
    CFS_INST(float, 4, 4),  CFS_INST(float, 4, 6),  CFS_INST(double, 1, 1),
    CFS_INST(double, 1, 2), CFS_INST(double, 2, 3), CFS_INST(double, 4, 4),
    CFS_INST(double, 4, 6)};
#undef CFS_INST

}  // namespace

// L (B,n,n) and x (B,n,m) with L L^T = A, A x = b. The launch goes to
// `stream` on the current device; returns cudaGetLastError().
extern "C" int cho_factor_solve_f32(const void* A, const void* b, void* L, void* x, int B,
                                    int n, int m, void* stream) {
  return launch<float>(A, b, L, x, B, n, m, stream);
}

extern "C" int cho_factor_solve_f64(const void* A, const void* b, void* L, void* x, int B,
                                    int n, int m, void* stream) {
  return launch<double>(A, b, L, x, B, n, m, stream);
}

// Instantiation i of the kernel: out = {registers per thread, local memory
// bytes per thread, bytes of the element type, TPT, R}. Returns -1 past the
// last one, else a CUDA error code.
extern "C" int cho_factor_solve_attrs(int i, int* out) {
  if (i < 0 || i >= (int)(sizeof(kInsts) / sizeof(kInsts[0]))) return -1;
  const Inst& k = kInsts[i];
  out[2] = k.dtype_bytes;
  out[3] = k.tpt;
  out[4] = k.r;
  return tri::attributes(k.fn, out);
}
