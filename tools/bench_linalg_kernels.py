"""Device time, host time per call and latency of the dense linear-algebra
kernels (ops/linalg.py) against their PyTorch library calls, on one GPU.

    python3 tools/bench_linalg_kernels.py

Inputs are random SPD float32 systems at the port's shapes (n=75; B=4096,
and B=880 for D at m=75 and E at n=32), made from seed 0 on the card; for
Kernel E also each of its forms through its raw entry point (the column
kernel, the tiled form, the warp form) at n=32, and the wrapper beside the
column kernel at n=64 and 75; and
for Kernel B 4096 random Delassus-like K=32 systems (A = J J^T / 75 +
1e-3 I, 80% of the rows active), solved at tol 0 so that every system runs
all 16 iterations: B's graph_ms / 16 is the time of one iteration with the
card full, its graph_ms_b132 / 16 the latency of one iteration of one
system. For each kernel and its library call (B has none) it prints:

  * event_ms: CUDA events around 20 back-to-back calls, as chip_smoke.py
    times them (includes the host's time per call where that is longer);
  * graph_ms: the same 20 calls captured in a CUDA graph and replayed, the
    device time alone (null for the library's Cholesky calls, which
    allocate during the call and cannot be captured);
  * host_us: host wall time per call, without a synchronise;
  * graph_ms_b132: graph_ms at B=132 (one system or one block per SM: the
    latency of one system).

The last line is one JSON object with all of these and the card's name and
power limit. Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPS = 20


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / REPS


def graph_ms(fn) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(REPS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (5 * REPS)


def host_us(fn, reps: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * t / reps


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from smplsim_tpu_torch.ops import _build, linalg, qp

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    _build.build_all()
    g = torch.Generator(device=dev).manual_seed(0)

    def spd(Bn, n):
        G = torch.randn(Bn, n, n, generator=g, device=dev, dtype=torch.float64)
        return (G @ G.mT / n + torch.eye(n, device=dev, dtype=torch.float64)).float().contiguous()

    def rhs(Bn, n, m):
        return torch.randn(Bn, n, m, generator=g, device=dev).contiguous()

    A = spd(4096, 75)
    L = linalg.cholesky_plain(A.double()).float().contiguous()
    A880, H880 = spd(880, 75), spd(880, 32)
    H64 = spd(880, 64)
    b33 = rhs(4096, 75, 33)
    J = torch.randn(4096, 32, 75, generator=g, device=dev, dtype=torch.float64)
    Aq = (J @ J.mT / 75 + 1e-3 * torch.eye(32, device=dev, dtype=torch.float64)).float()
    bq = torch.randn(4096, 32, generator=g, device=dev)
    aq = (torch.rand(4096, 32, generator=g, device=dev) < 0.8).float()
    f0q = torch.zeros(4096, 32, device=dev)
    L880 = linalg.cholesky_plain(A880.double()).float().contiguous()
    b1, b32, b75 = rhs(4096, 75, 1), rhs(4096, 75, 32), rhs(880, 75, 75)
    d1 = torch.rand(4096, 75, generator=g, device=dev)

    def lib_cfs(A_, b_):
        return torch.cholesky_solve(b_, torch.linalg.cholesky_ex(A_)[0])

    def e_raw(src, name):
        """An uncounted call of one of Kernel E's raw entry points."""
        def call(H_):
            L_ = torch.empty_like(H_)
            _build.check(_build.kernel(src, name)(
                H_.data_ptr(), L_.data_ptr(), *H_.shape[:2],
                torch.cuda.current_stream().cuda_stream), name)
            return L_
        return call

    lib_chol = lambda H_: torch.linalg.cholesky_ex(H_)[0]
    column = e_raw("chol_solve.cu", "cholesky_f32")

    # name: (kernel call, library call, batch-sliceable inputs); the library
    # calls of C, A and E are not captured in a graph
    capturable = ("D solve_lower m=1", "D solve_lower m=1 trans", "D solve_lower m=32",
                  "D solve_lower m=75 B=880")
    cases = {
        "C cho_factor_solve m=1": (linalg.cho_factor_solve, lib_cfs, (A, b1)),
        "D solve_lower m=1": (lambda L_, b_: linalg.solve_lower(L_, b_),
                              lambda L_, b_: torch.linalg.solve_triangular(L_, b_, upper=False),
                              (L, b1)),
        "D solve_lower m=1 trans": (lambda L_, b_: linalg.solve_lower(L_, b_, True),
                                    lambda L_, b_: torch.linalg.solve_triangular(
                                        L_.mT, b_, upper=True), (L, b1)),
        "D solve_lower m=32": (lambda L_, b_: linalg.solve_lower(L_, b_),
                               lambda L_, b_: torch.linalg.solve_triangular(L_, b_, upper=False),
                               (L, b32)),
        "D solve_lower m=75 B=880": (lambda L_, b_: linalg.solve_lower(L_, b_),
                                     lambda L_, b_: torch.linalg.solve_triangular(
                                         L_, b_, upper=False), (L880, b75)),
        "A chol_solve m=1+diag": (linalg.chol_solve,
                                  lambda A_, b_, d_: lib_cfs(A_ + torch.diag_embed(d_), b_),
                                  (A, b1, d1)),
        "A chol_solve m=33": (linalg.chol_solve, lib_cfs, (A, b33)),
        "B newton_qp K=32 tol 0": (lambda *a: qp.newton_qp(*a, 16, 0.0), None,
                                   (Aq, bq, aq, f0q)),
        "E cholesky K=32 B=880": (linalg.cholesky, lib_chol, (H880,)),
        "E cholesky K=32 B=880 column form": (column, None, (H880,)),
        "E cholesky K=32 B=880 tiled form": (e_raw("cho_factor_solve.cu", "cholesky_tiled_f32"),
                                             None, (H880,)),
        "E cholesky K=32 B=880 warp form": (e_raw("cho_factor_solve.cu", "cholesky_warp_f32"),
                                            None, (H880,)),
        "E cholesky n=64 B=880": (linalg.cholesky, lib_chol, (H64,)),
        "E cholesky n=64 B=880 column form": (column, None, (H64,)),
        "E cholesky n=75 B=880": (linalg.cholesky, lib_chol, (A880,)),
        "E cholesky n=75 B=880 column form": (column, None, (A880,)),
    }
    out = {}
    for name, (kern, lib, args) in cases.items():
        small = tuple(a[:132].contiguous() for a in args)
        row = {}
        for who, fn in (("kernel", kern), ("library", lib)):
            if fn is None:
                row[who] = None
                continue
            graph = who == "kernel" or name in capturable
            row[who] = dict(event_ms=event_ms(lambda: fn(*args)),
                            graph_ms=graph_ms(lambda: fn(*args)) if graph else None,
                            host_us=host_us(lambda: fn(*small)),
                            graph_ms_b132=graph_ms(lambda: fn(*small)) if graph else None)
        out[name] = row
        print(f"{name}: " + "; ".join(
            f"{who} " + (", ".join(f"{k} {v:.4f}" if v is not None else f"{k} none"
                                   for k, v in r.items()) if r is not None else "none")
            for who, r in row.items()), flush=True)
    print(card)
    print(json.dumps({"card": card, "cases": out}))


if __name__ == "__main__":
    main()
