"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch, CUDA, the card's name and power limit; TF32 off;
     build the CUDA kernels from smplsim_tpu_torch/ops/csrc with nvcc;
  2. kernels against their plain PyTorch versions on the card, on inputs
     taken from a real substep of the main path (B=4096 HumanoidSpeed envs
     after a few control steps): Kernel A chol_solve at m=1 + diag
     (stable-PD) and m=33 (smooth + Delassus), Kernel B newton_qp at K=32,
     16 iterations, tol 1e-4; float64 elementwise, float32 by residual,
     objective and KKT; times of kernel, plain version and library call;
  3. the main path: default_humanoid(float32) -> HumanoidSpeed ->
     reset(4096) -> 16 x step_autoreset with uniform random actions, at
     SMPLSIM_QP_ITERS=16, SMPLSIM_QP_TOL=1e-4, SMPLSIM_QP_ROWS=32; launch
     counts (30 chol_solve + 15 newton_qp per control step), finite state,
     env-steps/s;
  4. card vs CPU: 16 envs from a fresh reset, 2 control steps with
     half-scale random actions on the card (kernels) and on the CPU (plain
     versions); qpos within 5e-3.

The second-to-last line is the `kernels` JSON object, the line before it the
card's name and power limit; the last line is the result object.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

B_MAIN = 4096
STEPS = 16
CFI = 15
QP = dict(qp_iters=16, qp_tol=1e-4, qp_rows=32)
# H100 SXM published peaks (dense, 700 W): HBM bytes/s, float32 and float64
# rates outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)
    print(f"  ok: {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from smplsim_tpu_torch.envs import HumanoidSpeed
    from smplsim_tpu_torch.models import registry
    from smplsim_tpu_torch.ops import _build, linalg, qp
    from smplsim_tpu_torch.physics import (constraints, control, dynamics, engine,
                                           kinematics, solver)

    # ------------------------------------------------------------ 1. environment
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {card}; device count {torch.cuda.device_count()}")
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.time()
    _build.build_all()
    print(f"kernels built in {time.time() - t0:.1f} s into {_build.BUILD_DIR}", flush=True)

    model = registry.default_humanoid(torch.float32)
    env = HumanoidSpeed(model, **QP)
    gen = torch.Generator(device=dev).manual_seed(0)
    action = lambda n: torch.rand(n, model.nu, generator=gen, device=dev) * 2.0 - 1.0

    # --------------------------------------- 2. kernels vs plain, real inputs
    print("phase 2: kernels against their plain versions", flush=True)
    state = env.reset(B_MAIN, gen)
    for _ in range(3):
        state = env.step_autoreset(state, action(B_MAIN))
    q, v = state.phys.qpos, state.phys.qvel
    M_prev, C_prev, f_w = state.pd_cache
    target = control.pd_target_from_action(model, action(B_MAIN))
    rhs1, diag1, _ = control.stable_pd_system(model, C_prev, q, v, target)
    kin = kinematics.fk(model, q)
    M = dynamics.mass_matrix(model, kin)
    C = dynamics.bias_forces(model, kin, v)
    tau = control.stable_pd_torque(model, M_prev, C_prev, q, v, target)
    z6 = torch.zeros((B_MAIN, 6), device=dev)
    qfrc = torch.cat([z6, model.gear * tau], 1) - model.dof_damping * v - C
    efc = constraints.make_efc(model, kin, q, v)
    K = min(QP["qp_rows"], constraints.NEFC)
    rows = solver.select_rows(model, kin.S, efc, f_w, K)
    rhs33 = solver.smooth_rhs(qfrc, rows)
    A_qp, b_qp = solver.delassus(rows, linalg.chol_solve_plain(M, rhs33))
    act_qp, f0_qp = rows.actf, rows.f0
    print(f"  inputs: M_prev {tuple(M_prev.shape)}, rhs {tuple(rhs1.shape)} and "
          f"{tuple(rhs33.shape)}, QP {tuple(A_qp.shape)}, active rows per env "
          f"mean {efc.active.sum(1).float().mean().item():.2f} "
          f"max {int(efc.active.sum(1).max())}", flush=True)

    report = {}
    chol_cases = {"m=1,diag": (M_prev, rhs1, diag1), "m=33": (M, rhs33, None)}
    for name, (A, b, d) in chol_cases.items():
        for dt in (torch.float64, torch.float32):
            Ad, bd = A.to(dt).contiguous(), b.to(dt).contiguous()
            dd = None if d is None else d.to(dt).contiguous()
            xk = linalg.chol_solve(Ad, bd, dd)
            torch.cuda.synchronize()
            xp = linalg.chol_solve_plain(Ad, bd, dd)
            check(bool(torch.isfinite(xk).all()), f"chol_solve[{name}] {dt} finite")
            if dt == torch.float64:
                rel = ((xk - xp).abs().amax() / xp.abs().amax()).item()
                check(rel <= 1e-9, f"chol_solve[{name}] float64 vs plain: {rel:.3e} <= 1e-9")
            else:
                H = Ad if dd is None else Ad + torch.diag_embed(dd)
                res = ((H @ xk - bd).abs().amax((1, 2))
                       / (H.abs().amax((1, 2)) * xk.abs().amax((1, 2))
                          + bd.abs().amax((1, 2)))).amax().item()
                check(res <= 1e-5, f"chol_solve[{name}] float32 relative residual "
                                   f"{res:.3e} <= 1e-5")
                err = (xk - xp).abs().amax().item()
                rel = ((xk - xp).abs().amax((1, 2)) / xp.abs().amax((1, 2))).amax().item()
                ms = cuda_ms(lambda: linalg.chol_solve(Ad, bd, dd), 20)
                plain = cuda_ms(lambda: linalg.chol_solve_plain(Ad, bd, dd), 3)

                def library():
                    L = torch.linalg.cholesky(H if dd is None else Ad + torch.diag_embed(dd))
                    return torch.cholesky_solve(bd, L)
                lib = cuda_ms(library, 10)
                Bn, n, m = bd.shape
                nbytes = 4 * Bn * (n * (n + 1) / 2 + 2 * n * m + (n if dd is not None else 0))
                flops = Bn * (n ** 3 / 3 + 2 * n * n * m)
                bms, by = bound_ms(nbytes, flops, dt)
                report[name] = dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain,
                                    library_ms=lib, bound_ms=bms, bound_by=by)
                print(f"  chol_solve[{name}] f32: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                      f"library {lib:.4f} ms, bound {bms:.4f} ms ({by}), "
                      f"max|kernel-plain| {err:.3e} (per system, relative to max|plain|: "
                      f"{rel:.3e})", flush=True)

    for dt in (torch.float64, torch.float32):
        A, b = A_qp.to(dt).contiguous(), b_qp.to(dt).contiguous()
        a, f0 = act_qp.to(dt).contiguous(), f0_qp.to(dt).contiguous()
        tol = 1e-12 if dt == torch.float64 else QP["qp_tol"]
        it = QP["qp_iters"]
        fk = qp.newton_qp(A, b, a, f0, it, tol)
        torch.cuda.synchronize()
        fp, its = qp.newton_qp_plain_counted(A, b, a, f0, it, tol)
        check(bool(torch.isfinite(fk).all()), f"newton_qp {dt} finite")
        obj = lambda f: 0.5 * (f * (A @ f[..., None])[..., 0]).sum(-1) - (b * f).sum(-1)
        ok_, op_ = obj(fk), obj(fp)
        orel = ((ok_ - op_).abs() / op_.abs().clamp_min(1e-12)).amax().item()
        tol_sys = tol * (1.0 + b.abs().amax(-1))
        kk, kp = qp.kkt_residual(A, b, fk, a), qp.kkt_residual(A, b, fp, a)
        conv_p, conv_k = kp <= tol_sys, kk <= tol_sys
        if dt == torch.float64:
            # elementwise where both solves met the tolerance. Elsewhere the
            # line search met candidates whose objectives tie to rounding,
            # and the kernel's summation order may break such a tie the
            # other way than the plain version's: those systems are held by
            # objective and KKT residual below.
            both = conv_p & conv_k
            rel = ((fk - fp).abs() / (1.0 + fp.abs())).amax(1)
            print(f"  newton_qp float64: {int(both.sum())} of {both.numel()} systems meet tol "
                  f"1e-12 within {it} iterations in both; {int((conv_p ^ conv_k).sum())} in "
                  f"one only; |k-p|/(1+|p|) max {rel[both].max().item():.3e} over the first, "
                  f"{rel[~both].max().item() if (~both).any() else 0.0:.3e} over the rest",
                  flush=True)
            check(rel[both].max().item() <= 1e-9,
                  "newton_qp float64 vs plain elementwise <= 1e-9 where both converge")
            check(orel <= 1e-12, f"newton_qp float64 objective within {orel:.3e} <= 1e-12")
        else:
            check(orel <= 1e-4, f"newton_qp float32 objective within {orel:.3e} <= 1e-4")
        # the KKT residual: where the plain version meets its tolerance the
        # kernel meets it too, but for the rounding-tie systems above
        only_p, only_k = int((conv_p & ~conv_k).sum()), int((conv_k & ~conv_p).sum())
        print(f"  newton_qp {dt}: plain meets tol in {int(conv_p.sum())}, kernel in "
              f"{int(conv_k.sum())}; only plain {only_p}, only kernel {only_k}", flush=True)
        check(only_p <= conv_p.numel() // 100,
              f"newton_qp {dt}: the kernel misses the tolerance on at most 1% of the systems "
              f"where the plain version meets it ({only_p})")
        if dt != torch.float32:
            continue
        err = (fk - fp).abs().amax().item()
        rel = ((fk - fp).abs().amax(1) / fp.abs().amax(1).clamp_min(1e-30)).amax().item()
        ms = cuda_ms(lambda: qp.newton_qp(A, b, a, f0, it, tol), 20)
        plain = cuda_ms(lambda: qp.newton_qp_plain(A, b, a, f0, it, tol), 3)
        Bn, Kq = b.shape
        nbytes = 4 * Bn * (Kq * Kq + 4 * Kq)
        # the work this run's data needs: the Newton iterations each system
        # ran (masked factor K^3/3, 11 matvecs and 2 triangular solves of
        # 2K^2 each), plus one KKT matvec per system to stop
        n_it = int(its.sum())
        flops = n_it * (Kq ** 3 / 3 + 26 * Kq * Kq) + Bn * 2 * Kq * Kq
        bms, by = bound_ms(nbytes, flops, dt)
        report["qp"] = dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain,
                            library_ms=None, bound_ms=bms, bound_by=by,
                            iterations_mean=n_it / Bn, iterations_max=int(its.max()))
        print(f"  newton_qp f32: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bms:.4f} ms ({by}), iterations mean {n_it / Bn:.2f} max "
              f"{int(its.max())}, max|kernel-plain| {err:.3e} (per system, relative to "
              f"max|plain|: {rel:.3e})", flush=True)

    # ------------------------------------------------------------ 3. main path
    print("phase 3: main path", flush=True)
    linalg.chol_solve.launches = 0
    qp.newton_qp.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    state = env.reset(B_MAIN, gen)
    overflow = stalled = 0.0
    for _ in range(STEPS):
        state = env.step_autoreset(state, action(B_MAIN))
        overflow += state.info["overflow"].float().mean()
        stalled += state.info["stalled"].float().mean()
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    n_chol, n_qp = linalg.chol_solve.launches, qp.newton_qp.launches
    check(n_chol == 2 * CFI * STEPS, f"chol_solve launched {n_chol} = 30 x {STEPS} times")
    check(n_qp == CFI * STEPS, f"newton_qp launched {n_qp} = 15 x {STEPS} times")
    finite = all(bool(torch.isfinite(x).all()) for x in (
        state.phys.qpos, state.phys.qvel, state.obs, state.reward, *state.pd_cache))
    check(finite, "main-path state finite")
    check(state.obs.shape == (B_MAIN, env.obs_size), f"obs shape {tuple(state.obs.shape)}")
    rate = B_MAIN * STEPS / elapsed
    print(f"  {STEPS} control steps x {B_MAIN} envs in {elapsed:.3f} s: {rate:.1f} env-steps/s "
          f"({CFI} substeps each) on {card}")
    print(f"  overflow fraction {(overflow / STEPS).item():.5f}, stalled fraction "
          f"{(stalled / STEPS).item():.5f}, done at the last step "
          f"{state.done.float().mean().item():.4f}", flush=True)

    # ------------------------------------------------------- 4. card vs CPU
    print("phase 4: card vs CPU", flush=True)
    # from a fresh reset with half-scale random actions: under full-scale
    # random actions the closed loop is chaotic within two control steps
    # (a float32 and a float64 run on the CPU part by 7e-2 in one env of 16),
    # which would measure the chaos, not the kernels
    n = min(16, B_MAIN)
    cpu_model = registry.default_humanoid(torch.float32, device="cpu")
    fresh = env.reset(n, gen)
    st_gpu, cache_gpu = fresh.phys, fresh.pd_cache
    st_cpu = engine.PhysicsState(st_gpu.qpos.cpu(), st_gpu.qvel.cpu())
    cache_cpu = tuple(x.cpu() for x in cache_gpu)
    for _ in range(2):
        act = 0.5 * action(n)
        st_gpu, _, _, cache_gpu = engine.control_step(model, st_gpu, act, CFI, cache_gpu, **QP)
        st_cpu, _, _, cache_cpu = engine.control_step(cpu_model, st_cpu, act.cpu(), CFI,
                                                      cache_cpu, **QP)
    diff = ((st_gpu.qpos.cpu() - st_cpu.qpos).abs() / (1.0 + st_cpu.qpos.abs())).amax().item()
    check(diff <= 5e-3, f"qpos card vs CPU after 2 control steps: {diff:.3e} <= 5e-3")

    # ---------------------------------------------------------------- report
    per_step = lambda c: c / STEPS
    kernels = [
        dict(name="chol_solve", route="cuda", source="smplsim_tpu_torch/ops/csrc/chol_solve.cu",
             replaces="smplsim_tpu/ops/linalg_kernels.py:334", launches=n_chol,
             launches_per_control_step=per_step(n_chol),
             # the main path calls it once at each shape per substep: the
             # numbers are the mean of one launch of each
             **{k: (report["m=1,diag"][k] + report["m=33"][k]) / 2
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             **{k: max(report["m=1,diag"][k], report["m=33"][k])
                for k in ("max_abs_err", "max_rel_err")},
             bound_by=report["m=33"]["bound_by"],
             shapes={k: report[k] for k in ("m=1,diag", "m=33")}),
        dict(name="newton_qp", route="cuda", source="smplsim_tpu_torch/ops/csrc/newton_qp.cu",
             replaces="smplsim_tpu/ops/qp_kernel.py:256", launches=n_qp,
             launches_per_control_step=per_step(n_qp), **report["qp"]),
    ]
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
