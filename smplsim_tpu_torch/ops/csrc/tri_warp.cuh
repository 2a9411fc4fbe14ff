// Device code shared by Kernels A (chol_solve.cu), B (newton_qp.cu), C and E
// (cho_factor_solve.cu) and D (solve_lower.cu): the packed lower triangle in
// shared memory, its load, the warp-synchronous triangular substitutions
// (C, A at m <= 4, D at m <= 4, B), the thread-per-column substitutions (D
// and A at m > 4), the tiled register factor (C, A, and E at n > 64) and the
// warp factor (B, and E at n <= 64).
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

// 16 bytes from a 16-byte aligned shared address: four floats or two doubles
__device__ __forceinline__ void ld16(const float* p, float (&v)[4]) { load4(p, v); }
__device__ __forceinline__ void ld16(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x;
  v[1] = q.y;
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

// ---------------------------------------------------------------------------
// Thread-per-column substitutions (D and A at m > 4). Thread c owns
// right-hand-side column c; the rows go in blocks of kRB kept in registers.
// Lr is the row-aligned lower triangle (rowoff) with rows padded to n8 = n
// rounded up to kRB; Xs (n8, mw) holds the finished rows of every column,
// and a thread touches only its own column of it, so no barrier is needed.
// rhs(i) gives row i < n of the right-hand side, out(i, v) takes row i < n
// of the solution. Rows n..n8-1 of the last block hold garbage: they are
// never passed to out, and no row < n reads them.
constexpr int kRB = 8;

// L x = rhs. The finished rows' contribution is a loop of 8-row by 4-column
// products: eight vector loads of L, four loads of x, 32 FMAs.
template <typename T, class Rhs, class Out>
__device__ __forceinline__ void cols_forward(const T* Lr, T* Xs, int mw, int c, int n, Rhs rhs,
                                             Out out) {
  for (int i0 = 0; i0 < n; i0 += kRB) {
    T acc[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc[r] = i0 + r < n ? rhs(i0 + r) : T(0);
    for (int j = 0; j < i0; j += 4) {
      T xq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xq[q] = Xs[(j + q) * mw + c];
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        T lq[4];
        load4(Lr + rowoff(i0 + r) + j, lq);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r] -= lq[q] * xq[q];
      }
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      const T* row = Lr + rowoff(i0 + r) + i0;
#pragma unroll
      for (int q = 0; q < r; ++q) acc[r] -= row[q] * acc[q];
      acc[r] = div(acc[r], row[r]);
      Xs[(i0 + r) * mw + c] = acc[r];
      if (i0 + r < n) out(i0 + r, acc[r]);
    }
  }
}

// L^T x = rhs, from the last block up. rhs may read Xs itself (the rows of
// the current block are read before they are overwritten).
template <typename T, class Rhs, class Out>
__device__ __forceinline__ void cols_backward(const T* Lr, T* Xs, int mw, int c, int n, Rhs rhs,
                                              Out out) {
  const int n8 = (n + kRB - 1) / kRB * kRB;
  for (int i0 = n8 - kRB; i0 >= 0; i0 -= kRB) {
    T acc[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc[r] = i0 + r < n ? rhs(i0 + r) : T(0);
    for (int j = i0 + kRB; j < n; ++j) {
      const T xj = Xs[j * mw + c];
      T lo[4], hi[4];
      load4(Lr + rowoff(j) + i0, lo);
      load4(Lr + rowoff(j) + i0 + 4, hi);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r] -= lo[r] * xj;
        acc[r + 4] -= hi[r] * xj;
      }
    }
#pragma unroll
    for (int r = kRB - 1; r >= 0; --r) {
      const int i = i0 + r;
#pragma unroll
      for (int q = r + 1; q < kRB; ++q)
        if (i0 + q < n) acc[r] -= Lr[rowoff(i0 + q) + i] * acc[q];
      acc[r] = div(acc[r], Lr[rowoff(i) + i]);
      Xs[i * mw + c] = acc[r];
      if (i < n) out(i, acc[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// The tiled register factor of Kernels C and A (see cho_factor_solve.cu for
// the design). The 4x4 lower Cholesky factor l of the tile d (row-major,
// lower part read) and the reciprocals of its diagonal:
template <typename T>
__device__ __forceinline__ void chol4(const T (&d)[4][4], T (&l)[4][4], T (&inv)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    T s = d[c][c];
#pragma unroll
    for (int q = 0; q < c; ++q) s -= l[c][q] * l[c][q];
    l[c][c] = root(s);
    inv[c] = div(T(1), l[c][c]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < c) {
        l[r][c] = T(0);
      } else if (r > c) {
        T v = d[r][c];
#pragma unroll
        for (int q = 0; q < c; ++q) v -= l[r][q] * l[c][q];
        l[r][c] = v * inv[c];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_tile(const T* p, T (&v)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) load4(p + 4 * r, v[r]);
}

template <typename T>
__device__ __forceinline__ void store_tile(T* p, const T (&v)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) p[4 * r + c] = v[r][c];
}

// Factor H = A + diag(ds) (ds may be null) in place. On entry Lp holds A's
// packed lower triangle (tri layout, after a barrier); on exit it holds L,
// packed in the tri layout or, with kRowAligned, in the row-aligned one
// (then Lp must have room for rowoff(n rounded up to 8) entries), followed
// by a barrier. D (16 entries) and PB (16 (n+3)/4 entries) are scratch,
// all three 16-byte aligned. Thread t of nt keeps tiles t, t + nt, ...
// (TPT of them, numbered down the tile columns) in registers; TPT nt must
// cover the (n+3)/4 ((n+3)/4 + 1) / 2 tiles.
template <typename T, int TPT, bool kRowAligned>
__device__ __forceinline__ void factor_tiles(T* D, T* PB, T* Lp, const T* __restrict__ ds, int n,
                                             int tid, int nt) {
  const int ntr = (n + 3) >> 2;  // tile rows
  int ti[TPT], tj[TPT];
  bool own[TPT];
  T a[TPT][4][4];
#pragma unroll
  for (int t = 0; t < TPT; ++t) {
    int rem = tid + t * nt, j = 0;
    while (j < ntr && rem >= ntr - j) {
      rem -= ntr - j;
      ++j;
    }
    own[t] = j < ntr;
    tj[t] = j;
    ti[t] = j + rem;
    // rows and columns past n: identity, which keeps the last diagonal
    // tile's factor finite and leaves the others untouched; the diagonal
    // shift goes into the diagonal tiles here
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * ti[t] + r, jj = 4 * tj[t] + c;
        a[t][r][c] = !own[t] || jj > i ? T(0)
                     : i >= n          ? T(i == jj)
                     : ds != nullptr && i == jj ? Lp[tri(i) + jj] + ds[i]
                                                : Lp[tri(i) + jj];
      }
    if (own[t] && ti[t] == 0) store_tile(D, a[t]);
  }
  __syncthreads();

  for (int p = 0; p < ntr; ++p) {
    // the panel: tiles (i, p) become L_ip = A_ip L_pp^-T, L_pp from the
    // diagonal tile, which every owner in the panel factors for itself
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
      if (!own[t] || tj[t] != p) continue;
      T d[4][4], l[4][4], inv[4];
      load_tile(D, d);
      chol4(d, l, inv);
      if (ti[t] == p) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) a[t][r][c] = l[r][c];
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            T v = a[t][r][c];
#pragma unroll
            for (int q = 0; q < c; ++q) v -= a[t][r][q] * l[c][q];
            a[t][r][c] = v * inv[c];
          }
      }
      store_tile(PB + 16 * ti[t], a[t]);
    }
    __syncthreads();
    // the trailing update A_ij -= L_ip L_jp^T, 64 FMAs per tile
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
      if (!own[t] || tj[t] <= p) continue;
      T li[4][4], lj[4][4];
      load_tile(PB + 16 * ti[t], li);
      load_tile(PB + 16 * tj[t], lj);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int q = 0; q < 4; ++q) a[t][r][c] -= li[r][q] * lj[c][q];
      if (ti[t] == p + 1 && tj[t] == p + 1) store_tile(D, a[t]);
    }
    __syncthreads();
  }

  // every read of the input triangle happened before the first barrier
  // above, so the factor may go back in either layout
#pragma unroll
  for (int t = 0; t < TPT; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * ti[t] + r, j = 4 * tj[t] + c;
        if (own[t] && i < n && j <= i) Lp[(kRowAligned ? rowoff(i) : tri(i)) + j] = a[t][r][c];
      }
  __syncthreads();
}

// x = (L L^T)^-1 b for the (n, m) row-major b, L packed (tri layout) in
// shared memory: warp w of nw solves columns w, w + nw, ... forward and back
// in registers (Kernels C and A at m <= 4).
template <typename T, int R>
__device__ __forceinline__ void cho_solve_warps(const T* Lp, const T* __restrict__ b,
                                                T* __restrict__ x, int n, int m, int warp,
                                                int nwarps, int lane) {
  T inv[R];
  pivots<T, R>(Lp, n, lane, inv);
  for (int c = warp; c < m; c += nwarps) {
    T X[R];
    load_col<T, R>(b, X, n, m, c, lane);
    forward<T, R>(Lp, inv, X, n, lane);
    backward<T, R>(Lp, inv, X, n, lane);
    store_col<T, R>(x, X, n, m, c, lane);
  }
}

// ---------------------------------------------------------------------------
// The warp-synchronous right-looking Cholesky of Kernels B (the masked Newton
// system, newton_qp.cu) and E (its warp form, cho_factor_solve.cu): one warp
// factors one SPD system of order n <= KP = 32 R. Lane l owns rows l + 32 s
// (s < R). On entry a row's columns j >= JS are in h[s][j], and its columns
// j < JS (j <= row) in the packed factor Lp (tri layout), where they are
// factored in place; on exit Lp holds L, packed, and h is spent. col is two
// column buffers of KP entries, 16-byte aligned. Step k takes the pivot
// from lane k mod 32 by one shuffle, every lane scales its rows' entry k and
// publishes it in a column buffer (two, alternating, so one __syncwarp a
// step suffices) and in Lp, then updates its rows' trailing entries from
// 16-byte broadcast reads of the column. sqrt and 1 / sqrt are rounded as
// the plain version's sqrt and division are (root, div): a cheaper
// reciprocal square root moved ill-conditioned float32 systems off the
// plain version. The loops are unrolled, so every register index is
// static, and counted, so a NaN system cannot hang them. A row's entries
// past its diagonal and rows past n take garbage that reaches no row < n.
// Follow with __syncwarp before another lane reads Lp.
template <typename T, int R, int JS>
__device__ __forceinline__ void warp_factor(T (&h)[R][32 * R], T* Lp, T* col, int n, int lane) {
  constexpr int KP = 32 * R, V = 16 / (int)sizeof(T), NC = KP / V;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    if (k >= n) break;
    const int sk = k / 32;
    const int own = lane + 32 * sk;
    const T hk_own = k < JS ? (own >= k ? Lp[tri(own) + k] : T(0)) : h[sk][k];
    const T piv = root(__shfl_sync(0xffffffffu, hk_own, k % 32));
    const T ip = div(T(1), piv);
    T* cb = col + (k & 1) * KP;
    T l[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (s < sk) continue;  // rows < 32 (s + 1) <= k: finished
      const int row = lane + 32 * s;
      const T hk = k < JS ? (row >= k ? Lp[tri(row) + k] : T(0)) : h[s][k];
      l[s] = hk * ip;
      cb[row] = l[s];
      if (row >= k) Lp[tri(row) + k] = row == k ? piv : l[s];
    }
    __syncwarp();
#pragma unroll
    for (int c = (k + 1) / V; c < NC; ++c) {
      T x[V];
      ld16(cb + c * V, x);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (s < sk || c * V >= 32 * (s + 1)) continue;
        const int row = lane + 32 * s;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int j = c * V + q;
          if (j <= k) continue;
          if (j >= JS) h[s][j] -= l[s] * x[q];
          else if (j <= row) Lp[tri(row) + j] -= l[s] * x[q];
        }
      }
    }
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

// The threads a tiled factor of order n needs at TPT tiles per thread,
// rounded up to whole warps.
__host__ __device__ __forceinline__ int tile_threads(int n, int tpt) {
  const int ntr = (n + 3) / 4;
  return ((ntr * (ntr + 1) / 2 + tpt - 1) / tpt + 31) / 32 * 32;
}

}  // namespace tri
