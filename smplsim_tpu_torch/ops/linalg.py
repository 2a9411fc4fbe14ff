"""Batched dense SPD linear algebra: four hand-written kernels and their
plain versions.

  * `chol_solve` (Kernel A): x = (A + diag(d))^-1 b, replacing the TPU
    kernel smplsim_tpu/ops/linalg_kernels.py::chol_solve_lanes (body
    _chol_solve_only_kernel). The uhc_pd path calls it twice per substep:
    stable-PD (m=1, d = dt*kd) and the fused smooth + Delassus solve
    (m = 1 + K, no d).
  * `cho_factor_solve` (Kernel C): (L, x) with L L^T = A and A x = b,
    replacing linalg_kernels.py::chol_solve_batched (body
    _chol_solve_kernel), the vmap rule of smplsim_tpu/physics/linalg.py::
    cho_factor_solve. The per-env path calls it once per substep (smooth
    dynamics, m=1).
  * `solve_lower` (Kernel D): L x = b or L^T x = b, replacing
    linalg_kernels.py::solve_lower_batched (body _solve_lower_kernel), the
    vmap rule of physics/linalg.py::tri_solve_lower (one launch) and
    cho_solve (two). The per-env path calls it three times per substep: the
    Gram-form Delassus factor Y = L^-1 J^T (m=K) and the constraint
    acceleration (m=1, twice).
  * `cholesky` (Kernel E): L with L L^T = A, replacing
    linalg_kernels.py::cholesky_batched (body _chol_kernel), the vmap rule
    of physics/linalg.py::cholesky. Only the contact QP's implicit-function
    derivative calls it (ops/qp.py), once per substep under forward AD, at
    n = K = 32.

On a CUDA tensor each wrapper launches its kernel, built from csrc/. What
bounds them on the H100: at n=75 a system moves 12 KB (m=1) to 35 KB (C
with its stored factor) and needs 1.5e5 to 5.1e5 flops, so for 4096 systems
in float32 the byte bound is 0.015 to 0.042 ms, while every kernel runs n to
3n dependent steps per system; the designs differ in what a step costs.

  * chol_solve.cu, Kernel A (chol_solve_tiled_kernel, n <= 176): one block
    per system; C's tiled register factor with the diagonal shift added on
    the load and no store of L, then the solve by m: a warp per rhs column
    at m <= CHOL_SOLVE_WARP_MAX_M, a thread per column with 8-row register
    blocks (D's wide form) above. The thread form solves its columns in
    chunks of as many whole warps of column slots as fit in the shared
    memory left after the factor, all in one launch on the one factor, so
    every n <= 176 runs here whatever m (n = 159, m = 65 in float64 needs
    233,088 B unchunked and takes two chunks of 64 columns); a chunked
    solve equals the unchunked one bit for bit. `chol_solve_route` picks
    the form by shape, and the column kernel above n = 176.
  * chol_solve.cu, the column kernel (chol_solve_kernel, A and E above
    n = 176, E with the factor stored and no right-hand side): one thread
    block per system, the matrix and the right-hand side in shared memory,
    the column recurrences with block barriers between columns (3n in the
    factor, 4n more in the two substitutions): bound by that barrier chain.
  * cho_factor_solve.cu (C): one block per system, each thread keeps fixed
    4x4 tiles of the lower triangle in registers; a blocked right-looking
    factor over 4-column panels, two barriers per panel, 64 FMAs per tile
    and panel from vector reads of a shared panel buffer; the substitutions
    run warp-synchronously on the factor packed in shared memory. E at
    64 < n <= 176 is the same kernel without the solve.
  * cho_factor_solve.cu, E at n <= 64 (cholesky_warp_kernel): a warp per
    system, one system to a block, no block barrier; B's warp factor (tri::warp_factor) without the mask, one
    shuffle and one published column per pivot. `cholesky_route` picks
    E's form by shape.
  * solve_lower.cu (D): the lower triangle in shared memory (lower entries
    only, loaded in batches all in flight), the right-hand side in
    registers, no block barrier after the load. m <= 4: a warp per column
    (one warp per system at m=1, four systems per block), one multiply by
    the reciprocal pivot, one shuffle and one FMA per row per step. m > 4:
    a thread per column, rows in register blocks of 8.

The shared pieces are in tri_warp.cuh; PERF.md has the measured times
against the bounds.

On a CPU tensor each wrapper runs its plain version: the column recurrences
of smplsim_tpu/physics/linalg.py::_cholesky_ref, solve_lower, solve_lower_t
and _cho_solve_ref, batched. All of them read only the lower triangle.
The kernels take contiguous tensors and raise on any other layout: a caller
with a transposed view makes the copy itself (`.contiguous()`).

The wrappers are not differentiable: a kernel writes a fresh tensor from
its inputs' primal values, so each wrapper raises on an input that carries a
forward-mode tangent or requires grad. Derivatives go through the
`torch.autograd.Function`s of physics/linalg.py and ops/qp.py, whose rules
call these wrappers on primal values and tangents.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd import forward_ad

from smplsim_tpu_torch.ops import _build

# dynamic shared memory a block may use on Hopper (232,448 bytes)
_SMEM_MAX = 232448
# the largest n the register tiles of Kernels A and C hold, and the rows
# per lane of Kernel D
_CFS_MAX_N = 176
_SL_MAX_N = 256
# Kernel A solves with a warp per rhs column up to this m, with a thread per
# column above it
CHOL_SOLVE_WARP_MAX_M = 4
# Kernel E factors with a warp per system up to this n (two rows per lane),
# with C's tiled factor up to _CFS_MAX_N, with the column kernel above
CHOLESKY_WARP_MAX_N = 64


def cholesky_plain(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each SPD (B,n,n) system (lower triangle read)."""
    n = H.shape[-1]
    idx = torch.arange(n, device=H.device)
    L = H.clone()
    for j in range(n):
        s = (L[:, :, :j] @ L[:, j, :j, None])[..., 0]       # (B,n)
        c = L[:, :, j] - s
        piv = torch.sqrt(c[:, j:j + 1])
        L[:, :, j] = torch.where(
            idx == j, piv, torch.where(idx > j, c / piv, torch.zeros_like(c)))
    return L


def solve_lower_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution L y = b, b (B,n,m)."""
    n = L.shape[-1]
    y = b.clone()
    for j in range(n):
        yj = y[:, j, :] / L[:, j, j, None]
        y[:, j + 1:, :] -= L[:, j + 1:, j, None] * yj[:, None, :]
        y[:, j, :] = yj
    return y


def solve_lower_t_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Back substitution L^T x = b, b (B,n,m)."""
    n = L.shape[-1]
    x = b.clone()
    for j in range(n - 1, -1, -1):
        s = (L[:, j + 1:, j, None] * x[:, j + 1:, :]).sum(1)
        x[:, j, :] = (x[:, j, :] - s) / L[:, j, j, None]
    return x


def chol_solve_plain(A, b, diag=None):
    """Plain PyTorch version of `chol_solve` (the CPU path and the yardstick
    the kernel is held to)."""
    H = A if diag is None else A + torch.diag_embed(diag)
    L = cholesky_plain(H)
    return solve_lower_t_plain(L, solve_lower_plain(L, b))


def cho_factor_solve_plain(A, b):
    """Plain PyTorch version of `cho_factor_solve`."""
    L = cholesky_plain(A)
    return L, solve_lower_t_plain(L, solve_lower_plain(L, b))


def solve_lower_any_plain(L, b, trans: bool = False):
    """Plain PyTorch version of `solve_lower`."""
    return solve_lower_t_plain(L, b) if trans else solve_lower_plain(L, b)


def check_no_derivative(name, *ts):
    """Raise if a tensor carries a forward-mode tangent or requires grad: the
    kernel would drop its derivative without a word."""
    for t in ts:
        if t.requires_grad or forward_ad.unpack_dual(t).tangent is not None:
            raise RuntimeError(
                f"{name}: an input carries a derivative, which the kernel would drop; "
                "differentiate through smplsim_tpu_torch.physics.linalg or "
                "ops.qp.newton_qp_ad")


def _check(name, A, b=None, diag=None):
    """Shapes, types and devices of a (B,n,n) matrix, an optional (B,n,m)
    right-hand side and an optional (B,n) diagonal, none carrying a
    derivative; on a CUDA device also contiguity. Returns True where the
    kernel is to run, False on the CPU."""
    if A.dim() != 3 or A.shape[1] != A.shape[2] or (
            b is not None and (b.dim() != 3 or b.shape[:2] != A.shape[:2])):
        raise ValueError(f"{name}: A {tuple(A.shape)} and b "
                         f"{None if b is None else tuple(b.shape)} must be (B,n,n) and (B,n,m)")
    if diag is not None and diag.shape != A.shape[:2]:
        raise ValueError(f"{name}: diag {tuple(diag.shape)} must be (B,n)")
    ts = tuple(t for t in (A, b, diag) if t is not None)
    check_no_derivative(name, *ts)
    for t in ts:
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != A.dtype:
            raise TypeError(f"{name}: all inputs must share float32 or float64")
        if t.device != A.device:
            raise ValueError(f"{name}: all inputs must be on one device")
    if A.device.type == "cpu":
        return False
    if A.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {A.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return True


def _tri(i: int) -> int:
    return i * (i + 1) // 2


def _rowoff(i: int) -> int:
    """Start of row i in the row-aligned packed triangle (tri_warp.cuh)."""
    q = i >> 2
    return 8 * q * (q + 1) + (i - 4 * q) * 4 * (q + 1)


def _tile_threads(n: int, thread_cols: bool = False) -> int:
    """Threads of Kernel A's tiled factor of order n (tri::tile_threads at
    the tiles per thread chol_solve.cu's launch_tiled picks)."""
    ntr = (n + 3) // 4
    tiles = ntr * (ntr + 1) // 2
    tpt = 2 if thread_cols and n <= 64 else 1 if n <= 64 else 2 if n <= 96 else 4
    return (-(-tiles // tpt) + 31) // 32 * 32


def chol_solve_tiled_layout(n: int, m: int, itemsize: int, form: str):
    """(shared memory bytes, rhs chunk width) of Kernel A's tiled form for
    one (n, m) system with the given solve form ("warp" or "thread"), or
    None where the block would exceed 256 threads or not fit
    (chol_solve.cu's run_tiled and tiled_smem). The thread form solves its
    columns in chunks of the width given: as many whole warps of column
    slots as fit beside the factor, at most m rounded up to the solve
    threads (then one chunk: the unchunked solve), ceil(m / width) chunks.
    The warp form has no slots: width 0."""
    thread = form == "thread"
    solve = min(256, max(32, -(-m // 32) * 32 if thread else 32 * min(m, 8)))
    mw = -(-m // solve) * solve if thread else 0
    if max(_tile_threads(n, thread), solve) > 256:
        return None
    n8 = -(-n // 8) * 8
    lp = max(_rowoff(n8), _tri(n)) if thread else _tri(n)
    base = 16 + 16 * ((n + 3) // 4) + lp
    if itemsize * base > _SMEM_MAX:
        return None
    cw = 0
    if thread:
        cw = min(mw, (_SMEM_MAX // itemsize - base) // n8 // 32 * 32)
        if cw < 32:
            return None
    return itemsize * (base + n8 * cw), cw


def chol_solve_route(n: int, m: int, itemsize: int) -> str:
    """Which kernel `chol_solve` launches for (B,n,n) systems with m
    right-hand sides of `itemsize` bytes: "warp" or "thread" (Kernel A's
    tiled factor, solved with a warp or a thread per rhs column, the latter
    in column chunks where the columns do not fit at once), or "column" (the
    column kernel) where the tiles do not hold n (n > 176) or m = 0. A
    dispatch on shape only."""
    if 1 <= m and n <= _CFS_MAX_N:
        form = "warp" if m <= CHOL_SOLVE_WARP_MAX_M else "thread"
        if chol_solve_tiled_layout(n, m, itemsize, form) is not None:
            return form
    return "column"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def chol_solve(A: torch.Tensor, b: torch.Tensor,
               diag: torch.Tensor | None = None) -> torch.Tensor:
    """x (B,n,m) with (A + diag(d)) x = b for SPD A (B,n,n), b (B,n,m)."""
    if not _check("chol_solve", A, b, diag):
        return chol_solve_plain(A, b, diag)
    Bn, n, m = b.shape
    route = chol_solve_route(n, m, A.element_size())
    if route == "column" and A.element_size() * n * (n + m) > _SMEM_MAX:
        raise ValueError(f"chol_solve: n={n}, m={m} exceed a block's shared memory")
    x = torch.empty_like(b)
    suffix = "f32" if A.dtype == torch.float32 else "f64"
    d_ptr = None if diag is None else diag.data_ptr()
    with torch.cuda.device(A.device):
        if route == "column":
            name = f"chol_solve_{suffix}"
            status = _build.kernel("chol_solve.cu", name)(
                A.data_ptr(), b.data_ptr(), d_ptr, x.data_ptr(), Bn, n, m, _stream(A))
        else:
            name = f"chol_solve_tiled_{suffix}"
            status = _build.kernel("chol_solve.cu", name)(
                A.data_ptr(), b.data_ptr(), d_ptr, x.data_ptr(), Bn, n, m,
                int(route == "thread"), _stream(A))
    _build.check(status, name)
    chol_solve.launches += 1
    return x


chol_solve.launches = 0


def cho_factor_solve(A: torch.Tensor, b: torch.Tensor):
    """(L (B,n,n), x (B,n,m)) for SPD A (B,n,n), b (B,n,m): L is the lower
    Cholesky factor with exact zeros above the diagonal, A x = b."""
    if not _check("cho_factor_solve", A, b):
        return cho_factor_solve_plain(A, b)
    Bn, n, m = b.shape
    if n > _CFS_MAX_N:
        raise ValueError(f"cho_factor_solve: n={n} exceeds the kernel's register tiles "
                         f"(n <= {_CFS_MAX_N})")
    L = torch.empty_like(A)
    x = torch.empty_like(b)
    name = "cho_factor_solve_f32" if A.dtype == torch.float32 else "cho_factor_solve_f64"
    fn = _build.kernel("cho_factor_solve.cu", name)
    with torch.cuda.device(A.device):
        status = fn(A.data_ptr(), b.data_ptr(), L.data_ptr(), x.data_ptr(), Bn, n, m,
                    _stream(A))
    _build.check(status, name)
    cho_factor_solve.launches += 1
    return L, x


cho_factor_solve.launches = 0


def solve_lower(L: torch.Tensor, b: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """x (B,n,m) with L x = b, or L^T x = b if `trans`; L (B,n,n) lower
    (its upper triangle is not read), b (B,n,m)."""
    if not _check("solve_lower", L, b):
        return solve_lower_any_plain(L, b, trans)
    Bn, n, m = b.shape
    if n > _SL_MAX_N or L.element_size() * n * (n + 1) // 2 > _SMEM_MAX:
        raise ValueError(f"solve_lower: n={n} exceeds the kernel's register rows or a "
                         "block's shared memory")
    x = torch.empty_like(b)
    name = "solve_lower_f32" if L.dtype == torch.float32 else "solve_lower_f64"
    fn = _build.kernel("solve_lower.cu", name)
    with torch.cuda.device(L.device):
        status = fn(L.data_ptr(), b.data_ptr(), x.data_ptr(), Bn, n, m, int(bool(trans)),
                    _stream(L))
    _build.check(status, name)
    solve_lower.launches += 1
    return x


solve_lower.launches = 0


def cholesky_route(n: int, itemsize: int) -> str:
    """Which kernel `cholesky` launches for (B,n,n) systems of `itemsize`
    bytes: "warp" (a warp per system), "tiled" (Kernel C's tiled factor with
    its L store and no solve) where its register tiles hold n and its shared
    memory fits, or "column" (the column kernel). A dispatch on shape only."""
    if n <= CHOLESKY_WARP_MAX_N:
        return "warp"
    if n <= _CFS_MAX_N and itemsize * (16 + 16 * ((n + 3) // 4) + _tri(n)) <= _SMEM_MAX:
        return "tiled"
    return "column"


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """L (B,n,n), the lower Cholesky factor of each SPD A (B,n,n), with exact
    zeros above the diagonal; only the lower triangle of A is read."""
    if not _check("cholesky", A):
        return cholesky_plain(A)
    Bn, n = A.shape[:2]
    route = cholesky_route(n, A.element_size())
    if route == "column" and A.element_size() * n * n > _SMEM_MAX:
        raise ValueError(f"cholesky: n={n} exceeds a block's shared memory")
    L = torch.empty_like(A)
    suffix = "f32" if A.dtype == torch.float32 else "f64"
    ptrs = (A.data_ptr(), L.data_ptr(), Bn, n)
    with torch.cuda.device(A.device):
        if route == "column":
            name = f"cholesky_{suffix}"
            status = _build.kernel("chol_solve.cu", name)(*ptrs, _stream(A))
        else:
            name = f"cholesky_{route}_{suffix}"
            status = _build.kernel("cho_factor_solve.cu", name)(*ptrs, _stream(A))
    _build.check(status, name)
    cholesky.launches += 1
    return L


cholesky.launches = 0


def tri_solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution L x = b: one `solve_lower` launch
    (smplsim_tpu/physics/linalg.py::tri_solve_lower)."""
    return solve_lower(L, b)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L L^T x = b given the lower factor L: two `solve_lower`
    launches (smplsim_tpu/physics/linalg.py::cho_solve)."""
    return solve_lower(L, solve_lower(L, b), trans=True)


def kernel_attributes() -> list[dict]:
    """cudaFuncGetAttributes of every instantiation of Kernels A (tiled), B
    (warp form), C, D and E (warp and tiled forms): registers and local
    memory (spills) per thread, by type and tile (A: tiles per thread TPT and
    solve rows per lane R, R = 0 for a thread per column; B: rows per lane R
    and the systems an SM holds at once; C: TPT and R; D: its form and rows
    per lane or per register block R; E: TPT, 0 for the warp form, and rows
    per lane R)."""
    out = []
    for src, kind, entry, keys in (
            ("chol_solve.cu", "chol_solve", "chol_solve_tiled_attrs", ("TPT", "R")),
            ("newton_qp.cu", "newton_qp", "newton_qp_warp_attrs", ("R", "resident_per_sm")),
            ("cho_factor_solve.cu", "cho_factor_solve", "cho_factor_solve_attrs", ("TPT", "R")),
            ("solve_lower.cu", "solve_lower", "solve_lower_attrs", ("warp_per_column", "R")),
            ("cho_factor_solve.cu", "cholesky", "cholesky_attrs", ("TPT", "R"))):
        fn = _build.kernel(src, entry)
        i = 0
        while True:
            vals = (ctypes.c_int * 5)()
            status = fn(i, vals)
            if status == -1:
                break
            _build.check(status, entry)
            regs, local, size, t, r = vals
            out.append(dict(kernel=kind, dtype="float32" if size == 4 else "float64",
                            **dict(zip(keys, (t, r))), num_regs=regs, local_bytes=local))
            i += 1
    return out


def chol_solve_occupancy(n: int, m: int, itemsize: int) -> dict:
    """What Kernel A's tiled launch of (n, m) systems of `itemsize` bytes
    takes on this card, in the form `chol_solve_route` picks: threads,
    dynamic shared memory, the rhs chunk width (0 in the warp form), the
    blocks resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    and the registers per thread."""
    form = chol_solve_route(n, m, itemsize)
    if form == "column":
        raise ValueError(f"chol_solve_occupancy: n={n}, m={m} take the column kernel")
    vals = (ctypes.c_int * 5)()
    _build.check(_build.kernel("chol_solve.cu", "chol_solve_tiled_occupancy")(
        n, m, itemsize, int(form == "thread"), vals), "chol_solve_tiled_occupancy")
    return dict(n=n, m=m, dtype="float32" if itemsize == 4 else "float64", form=form,
                threads=vals[0], smem_bytes=vals[1], chunk=vals[2], blocks_per_sm=vals[3],
                num_regs=vals[4])
