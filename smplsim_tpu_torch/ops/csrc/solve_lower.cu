// Batched triangular solves for Hopper (sm_90a):
//     L x = b   or   L^T x = b (trans)      L (B,n,n) lower, b (B,n,m).
//
// Replaces the TPU kernel smplsim_tpu/ops/linalg_kernels.py::
// solve_lower_batched (body _solve_lower_kernel). Only the lower triangle of
// L is read.
//
// What bounds it on the H100: at n=75 a system moves 12 KB at m=1 and 31 KB
// at m=32 in float32 (the triangle once, b and x) for n^2 m flops, so 4096
// systems are bound by bytes at 0.015 ms (m=1) and 0.037 ms (m=32); the
// recurrence itself is n dependent steps per column.
//
// Both forms load only the n(n+1)/2 lower entries into shared memory, in
// batches of plain loads all in flight at once, with no division per
// element (tri_warp.cuh), and run no block barrier after that load.
//
// m <= 4, a warp per column (solve_lower_warp_kernel): lane l holds rows
// l, l + 32, ... of x in registers; step k is one multiply by the reciprocal
// pivot (taken once per row before the recurrence), one shuffle (the owner
// of row k broadcasts x_k) and one FMA per owned row, with L read from the
// packed triangle. This column-oriented form is used in both directions
// (L x = b reads column k of L, L^T x = b reads row k, both free of bank
// conflicts); the row-oriented one (a dot product of row k with x, reduced
// across the warp) puts five dependent shuffles on every step instead of
// one. At m = 1 four systems share a block, each warp on its own: a tail
// warp past the batch returns, since nothing waits for it.
//
// m > 4, a thread per column (solve_lower_cols_kernel, on
// tri::cols_forward/cols_backward, which Kernel A shares): one block per
// system, thread c owns rhs column c, and the rows go in blocks of 8 kept in
// registers: the finished rows' contribution is a loop of 8-row by 4-column
// products (eight vector loads of L, four of x from shared memory, 32 FMAs),
// then the 8x8 diagonal block is solved in registers. L sits in the
// row-aligned layout so that those vector loads are aligned. Warps of 8
// columns x 4 row groups (the warp form widened) measured no faster than
// torch.linalg.solve_triangular at m = 75, B = 880 on the H100: each step
// does one FMA per shared load, and the code unrolled per register slot
// runs to tens of KB; this form does four FMAs per load in a loop of a few
// hundred instructions.
// The TPU kernel's rhs chunks of 32 columns and 128-lane padding are VMEM
// and lane devices and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_warp.cuh"

namespace {

using tri::kRB;
using tri::rowoff;
using tri::tri;

constexpr int kSystemsPerBlock = 4;  // warp kernel, one warp per system at m = 1
constexpr int kColsThreads = 256;    // column kernel, most threads per block

template <typename T, int R>
__global__ void __launch_bounds__(32 * kSystemsPerBlock)
solve_lower_warp_kernel(const T* __restrict__ L, const T* __restrict__ b, T* __restrict__ x,
                        int B, int n, int m, int trans, int spb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // spb systems of one warp each, or one system of m warps (spb = 1)
  const int slot = spb > 1 ? warp : 0;
  const int sys = blockIdx.x * spb + slot;
  if (sys >= B) return;  // only where spb > 1: no block barrier follows
  const int nsw = spb > 1 ? 1 : blockDim.x >> 5;  // warps of this system
  const int wsys = warp - slot;
  T* Lp = reinterpret_cast<T*>(smem_raw) + (size_t)slot * tri(n);
  tri::load_lower(Lp, L + (size_t)sys * n * n, n, wsys * 32 + lane, nsw * 32);
  if (nsw == 1) __syncwarp();
  else __syncthreads();

  const T* bs = b + (size_t)sys * n * m;
  T* xs = x + (size_t)sys * n * m;
  T inv[R];
  tri::pivots<T, R>(Lp, n, lane, inv);
  for (int c = wsys; c < m; c += nsw) {
    T X[R];
    tri::load_col<T, R>(bs, X, n, m, c, lane);
    if (trans) tri::backward<T, R>(Lp, inv, X, n, lane);
    else tri::forward<T, R>(Lp, inv, X, n, lane);
    tri::store_col<T, R>(xs, X, n, m, c, lane);
  }
}

template <typename T>
__global__ void __launch_bounds__(kColsThreads)
solve_lower_cols_kernel(const T* __restrict__ L, const T* __restrict__ b, T* __restrict__ x,
                        int n, int m, int mw, int trans) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n8 = (n + kRB - 1) / kRB * kRB;
  T* Lr = reinterpret_cast<T*>(smem_raw);  // row-aligned lower triangle, n8 rows
  T* Xs = Lr + rowoff(n8);                 // (n8, mw): finished rows of x
  const int sys = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  tri::load_lower<T, true>(Lr, L + (size_t)sys * n * n, n, tid, nt);
  __syncthreads();

  const T* bs = b + (size_t)sys * n * m;
  T* xs = x + (size_t)sys * n * m;
  for (int c = tid; c < mw; c += nt) {
    const bool live = c < m;
    auto rhs = [&](int i) { return live ? bs[(size_t)i * m + c] : T(0); };
    auto out = [&](int i, T v) {
      if (live) xs[(size_t)i * m + c] = v;
    };
    if (trans) tri::cols_backward<T>(Lr, Xs, mw, c, n, rhs, out);
    else tri::cols_forward<T>(Lr, Xs, mw, c, n, rhs, out);
  }
}

template <typename T, int R>
int run_warp(const void* L, const void* b, void* x, int B, int n, int m, int trans,
             cudaStream_t stream) {
  const size_t tri_bytes = sizeof(T) * (size_t)tri(n);
  int spb = 1;
  if (m == 1) {
    spb = kSystemsPerBlock;
    while (spb > 1 && spb * tri_bytes > 48 * 1024) --spb;
  }
  const int threads = spb > 1 ? 32 * spb : 32 * m;
  const size_t smem = spb * tri_bytes;
  cudaError_t err = tri::allow_smem(solve_lower_warp_kernel<T, R>, smem);
  if (err != cudaSuccess) return (int)err;
  solve_lower_warp_kernel<T, R><<<(B + spb - 1) / spb, threads, smem, stream>>>(
      (const T*)L, (const T*)b, (T*)x, B, n, m, trans, spb);
  return (int)cudaGetLastError();
}

template <typename T>
int run_cols(const void* L, const void* b, void* x, int B, int n, int m, int trans,
             cudaStream_t stream) {
  const int n8 = (n + kRB - 1) / kRB * kRB;
  int threads = (m + 31) / 32 * 32;
  if (threads > kColsThreads) threads = kColsThreads;
  const int mw = (m + threads - 1) / threads * threads;
  const size_t smem = sizeof(T) * ((size_t)rowoff(n8) + (size_t)n8 * mw);
  cudaError_t err = tri::allow_smem(solve_lower_cols_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  solve_lower_cols_kernel<T><<<B, threads, smem, stream>>>((const T*)L, (const T*)b, (T*)x, n,
                                                          m, mw, trans);
  return (int)cudaGetLastError();
}

// m <= 4: rows per lane R in 1, 2, 3, 4, 8 (n <= 32 R, n <= 256)
template <typename T>
int launch(const void* L, const void* b, void* x, int B, int n, int m, int trans,
           void* stream_) {
  if (B <= 0 || n <= 0 || m <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream_;
  if (m > 4) return run_cols<T>(L, b, x, B, n, m, trans, s);
  if (n <= 32) return run_warp<T, 1>(L, b, x, B, n, m, trans, s);
  if (n <= 64) return run_warp<T, 2>(L, b, x, B, n, m, trans, s);
  if (n <= 96) return run_warp<T, 3>(L, b, x, B, n, m, trans, s);
  if (n <= 128) return run_warp<T, 4>(L, b, x, B, n, m, trans, s);
  if (n <= 256) return run_warp<T, 8>(L, b, x, B, n, m, trans, s);
  return (int)cudaErrorInvalidValue;
}

struct Inst {
  const void* fn;
  int dtype_bytes, form, r;  // form: 1 warp per column, 0 thread per column
};

#define SL_WARP(T, R) {(const void*)solve_lower_warp_kernel<T, R>, (int)sizeof(T), 1, R}
#define SL_COLS(T) {(const void*)solve_lower_cols_kernel<T>, (int)sizeof(T), 0, kRB}
const Inst kInsts[] = {
    SL_WARP(float, 1),  SL_WARP(float, 2),  SL_WARP(float, 3),  SL_WARP(float, 4),
    SL_WARP(float, 8),  SL_COLS(float),     SL_WARP(double, 1), SL_WARP(double, 2),
    SL_WARP(double, 3), SL_WARP(double, 4), SL_WARP(double, 8), SL_COLS(double)};
#undef SL_WARP
#undef SL_COLS

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

// Instantiation i of the kernels: out = {registers per thread, local memory
// bytes per thread, bytes of the element type, form (1: a warp per column,
// 0: a thread per column), rows per lane or per register block}. Returns -1
// past the last one, else a CUDA error code.
extern "C" int solve_lower_attrs(int i, int* out) {
  if (i < 0 || i >= (int)(sizeof(kInsts) / sizeof(kInsts[0]))) return -1;
  const Inst& k = kInsts[i];
  out[2] = k.dtype_bytes;
  out[3] = k.form;
  out[4] = k.r;
  return tri::attributes(k.fn, out);
}
