"""Batched fused SPD factor + solve: x = (A + diag(d))^-1 b (Kernel A).

`chol_solve` replaces the TPU kernel smplsim_tpu/ops/linalg_kernels.py::
chol_solve_lanes (body _chol_solve_only_kernel). The main path calls it twice
per substep: stable-PD (m=1, d = dt*kd) and the fused smooth + Delassus
solve (m = 1 + K, no d).

On a CUDA tensor it launches the hand-written kernel in csrc/chol_solve.cu:
one thread block per system, the lower triangle of H = A + diag(d) and the
right-hand side in shared memory, a right-looking column Cholesky, then
forward and back substitution; the factor never reaches device memory.
What bounds it on the H100: at n=75 a system moves 12 KB (m=1) to 31 KB
(m=33) and needs 1.5e5 to 5.1e5 flops, so the byte bound is 0.015 / 0.038
ms for 4096 systems in float32, while the column recurrence is 3n = 225
dependent steps with a block barrier each: the kernel is bound by that
barrier chain, not by bytes or flops. The design answers with shared-memory residency (no step
waits on device memory) and many resident blocks per SM to hide the
barriers; PERF.md has its measured time against the bound.

On a CPU tensor it runs `chol_solve_plain`, the column recurrences of
smplsim_tpu/physics/linalg.py::_cholesky_ref and _cho_solve_ref, batched.
Both read only the lower triangle of A.
"""
from __future__ import annotations

import torch

from smplsim_tpu_torch.ops import _build

# dynamic shared memory a block may use on Hopper (232,448 bytes)
_SMEM_MAX = 232448


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


def _check(A, b, diag):
    if A.dim() != 3 or b.dim() != 3 or A.shape[1] != A.shape[2] \
            or b.shape[:2] != A.shape[:2]:
        raise ValueError(f"chol_solve: A {tuple(A.shape)} and b {tuple(b.shape)} "
                         "must be (B,n,n) and (B,n,m)")
    if diag is not None and diag.shape != A.shape[:2]:
        raise ValueError(f"chol_solve: diag {tuple(diag.shape)} must be (B,n)")
    for t in (A, b) + (() if diag is None else (diag,)):
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != A.dtype:
            raise TypeError("chol_solve: all inputs must share float32 or float64")
        if t.device != A.device:
            raise ValueError("chol_solve: all inputs must be on one device")


def chol_solve(A: torch.Tensor, b: torch.Tensor,
               diag: torch.Tensor | None = None) -> torch.Tensor:
    """x (B,n,m) with (A + diag(d)) x = b for SPD A (B,n,n), b (B,n,m)."""
    _check(A, b, diag)
    if A.device.type == "cpu":
        return chol_solve_plain(A, b, diag)
    if A.device.type != "cuda":
        raise ValueError(f"chol_solve: unsupported device {A.device}")
    if not all(t.is_contiguous() for t in (A, b) + (() if diag is None else (diag,))):
        raise ValueError("chol_solve: the kernel takes contiguous tensors")
    Bn, n, m = b.shape
    if A.element_size() * n * (n + m) > _SMEM_MAX:
        raise ValueError(f"chol_solve: n={n}, m={m} exceed a block's shared memory")
    x = torch.empty_like(b)
    name = "chol_solve_f32" if A.dtype == torch.float32 else "chol_solve_f64"
    fn = _build.kernel("chol_solve.cu", name)
    with torch.cuda.device(A.device):
        status = fn(A.data_ptr(), b.data_ptr(), None if diag is None else diag.data_ptr(),
                    x.data_ptr(), Bn, n, m, torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(status, name)
    chol_solve.launches += 1
    return x


chol_solve.launches = 0
