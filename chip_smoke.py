"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch, CUDA, the card's name and power limit; TF32 off;
     build the CUDA kernels from smplsim_tpu_torch/ops/csrc with nvcc; the
     registers and local memory (cudaFuncGetAttributes) of every
     instantiation of Kernels A (tiled), B (warp form), C, D and E (warp and
     tiled forms), failing if a float32 one spills; B's resident systems per SM, failing unless 4096
     systems at K=32 fit the card in one wave; Kernel A's tiled launches at
     n = 159 (m = 1, 33; float64 also 65, in chunks): threads, shared
     memory, rhs chunk width, registers and resident blocks per SM;
  2. kernels against their plain PyTorch versions on the card, on inputs
     taken from a real substep of the main path (B=4096 HumanoidSpeed envs
     after a few control steps): Kernel A chol_solve at m=1 + diag
     (stable-PD) and m=33 (smooth + Delassus), Kernel B newton_qp at K=32,
     16 iterations, tol 1e-4; float64 elementwise (a system where both
     meet the tolerance yet part by more than 1e-9 held by the distance
     that tolerance allows two solutions, `tolerance_spread`), float32 by
     residual, objective and KKT; times of kernel, plain version and library call;
     the control: the column kernel (chol_solve.cu's chol_solve_f32) and
     both solve forms of A's tiled kernel, and B's block-per-system form,
     timed through their raw entry points on the same inputs (failing
     unless the wrappers' kernels are the faster);
  3. the main path: default_humanoid(float32) -> HumanoidSpeed ->
     reset(4096) -> 16 x step_autoreset with uniform random actions, at
     SMPLSIM_QP_ITERS=16, SMPLSIM_QP_TOL=1e-4, SMPLSIM_QP_ROWS=32; launch
     counts (30 chol_solve + 15 newton_qp per control step), finite state,
     env-steps/s;
  4. card vs CPU: 16 envs from a fresh reset, 2 control steps with
     half-scale random actions on the card (kernels) and on the CPU (plain
     versions); qpos within 5e-3;
 4b. phase 4 again from another reset with the process at TF32
     (torch.set_float32_matmul_precision("high")): through
     engine.control_step, which pins full float32 (physics/precision.py),
     within 5e-3 of the CPU, and again with TF32 set through
     torch.backends.cuda.matmul.fp32_precision = "tf32" (the API that
     makes the legacy getter raise); beside them the same two control
     steps through the unpinned inner loop (substep.control_loop), printed,
     not gated; the process set back to "highest";
  5. Kernels C cho_factor_solve (m=1) and D solve_lower (m=32, and m=1
     forward and transposed) against their plain versions on the card, on
     inputs of the torque path (B=4096 HumanoidSpeed envs in torque control
     after 3 control steps): float64 elementwise, float32 by relative
     residual (and |L L^T - A| for C); times of kernel, plain version and
     library call; newton_qp timed on the same path's Gram-form systems,
     beside its block-per-system form;
  6. the torque path: SpeedConfig(control_mode="torque") -> reset(4096) ->
     16 x step_autoreset with the same action draw as phase 3; launch counts
     (15 cho_factor_solve + 45 solve_lower + 15 newton_qp and no chol_solve
     per control step), finite state, env-steps/s;
  7. card vs CPU on the torque path: 16 envs from a fresh reset, half-scale
     random actions over 3 substeps, then actions at 0.3% of full scale over
     2 control steps (with 1000 Nm torque limits at power_scale 10 the
     float32 loop stays non-chaotic only that long: on the CPU a float32
     and a float64 run part by 6.8 after 6 substeps at half scale and by
     0.55 after 27 substeps at 1%); qpos within 5e-3;
  8. Kernel E cholesky against its plain version on the card, on the masked
     K x K systems H = A o (a a^T) + diag(1 - a) that the contact QP's
     implicit-function derivative factors on phase 9's path (the first
     substep at its 4 trajectory points, K=32, each system replicated 220
     times as the Jacobian batch holds it): float64 elementwise and float32
     by |L L^T - H| / |H|, exact zeros above the diagonal in both; times of
     kernel (the route linalg.cholesky_route picks: a warp per system),
     plain version and torch.linalg.cholesky_ex; the control: E's column
     kernel (chol_solve.cu's cholesky_f32) through its raw entry point on
     the same inputs, both also timed by CUDA-graph replay (device time
     alone: at this size the wrapper's host time per call is as long as the
     kernel), failing unless the wrapper's kernel is the faster there;
     Kernel D at
     m = n = 75 on the same batch (the factors of M at the points), the
     shape of the cholesky rule's L^-1 dA solves, the same way;
  9. the differentiable path: one Jacobian evaluation (control.jacobians:
     one forward-AD pass over the replicated batch) of the uhc_pd
     control_step at 4 trajectory points, nq + nv + nu = 220 replicas each
     (880 systems), 15 substeps, at the bench operating point; launch counts
     per evaluation (30 cho_factor_solve, 240 solve_lower, 15 newton_qp, 15
     cholesky and no chol_solve), finite Jacobians; the wall time of a warm
     evaluation beside one forward-AD pass over the 4 points alone; then
     card vs CPU in float64 (2 substeps, an air and a contact state, actions
     at 10% of full scale): Jacobians within 1e-6 relative, with the QP
     active sets of both devices' reference loops equal;
 10. ilqr_plan on the card from HumanoidSpeed's reset state: 4 control
     steps, 2 iterations, the root-velocity cost of tests/test_control.py;
     the final cost finite and not above the initial one; wall seconds per
     iteration;
 11. edge cases of Kernels C and D against their plain versions on random
     SPD systems: B in (1, 3, 33), n in (32, 75), m in (1, 2, 32, 75), D in
     both directions, float64 elementwise within 1e-9, float32 by relative
     residual within 1e-5 (and |L L^T - A| / |A| for C); C exactly zero
     above the diagonal; 7.0 and NaN above the diagonal change no bit of
     either result; a NaN system in the middle of a batch of 33 changes no
     bit of the other 32; and n = 159 (SMPLX) at B = 3, m in (1, 33);
 12. edge cases of Kernels A and B against their plain versions. A: B in
     (1, 3, 33), n in (32, 75, 180) (180 is above the tiles: the column
     kernel, float32 only; float64 must raise), m in (1, 2, 33, 75), and
     n in (159, 176) at m in (1, 33, 65) (float64 in rhs chunks; no n <=
     176 reaches the column kernel), with
     and without d, float64 elementwise within 1e-9, float32 by relative
     residual within 1e-5, 7.0 and NaN above the diagonal change no bit, a
     NaN system in a batch of 33 changes no bit of the others, all three
     routes reached; the solve of m columns (in chunks where they do not
     fit at once) equals its two column slices, each one chunk, bit for bit
     (float64 n = 75, 159, 176; float32 n = 159). B: K in (8, 32, 33, 64, 80) (80 is above the warp
     form: the block form), 256 Delassus-like systems, one with no active
     row (result 0); iters = 0 and a huge tol return max(f0, 0) * active;
     a NaN system changes no bit of the others; float64 elementwise within
     1e-9 where both converge, float32 objective within 1e-4 and the kernel
     missing the tolerance on at most 1% of the systems where the plain
     version meets it;
 13. edge cases of Kernel E against its plain version on random SPD
     systems: B in (1, 3, 33), n in (8, 32, 33, 64, 75, 159, 180), all three
     routes of linalg.cholesky_route (180 is above the tiles: the column
     kernel, float32 only; float64 must raise); float64 elementwise within
     1e-9, float32 by |L L^T - A| / |A| within 1e-5, exact zeros above the
     diagonal; 7.0 and NaN above the diagonal change no bit; a NaN system
     in a batch of 33 changes no bit of the other 32;
 14. the getup path: default_humanoid(float32) -> HumanoidGetup with the
     per-reset Fall init -> reset(4096) (the Fall's 3 control steps: 90
     chol_solve + 45 newton_qp launches) -> 8 x step_autoreset with
     uniform random actions, each 120 chol_solve + 60 newton_qp launches
     (the Fall is computed for every env and selected where one finished,
     as the JAX package's vmapped step_autoreset does); finite state,
     env-steps/s, overflow and stalled shares; no env terminates while its
     recovery counter is > 0, and a step with half the counters spent
     terminates only those envs; then a pool of 4096 Fall states
     (GetupConfig(fall_init_pool=4096)), its build time, and 4 x
     step_autoreset at 30 + 15 launches each, the reset launching none;
 15. Kernels A and B against their plain versions on the systems of a
     real substep of phase 14's getup states, with phase 2's checks and
     timings; B's mean and maximum iterations and the share of systems
     with all K rows active;
 16. HumanoidReach with observation v2: reset(4096), 4 x step_autoreset
     (30 + 15 launches each), the observation's width, finite state,
     env-steps/s;
 17. the perturbation hooks at 4096 envs from the standing pose, 25
     control steps of 5 substeps at zero actions: one ball per env
     (tests/test_projectiles.py's: radius 0.12, inverse mass 0.5, from
     (1.2, -0.2, 0.85) at -10 m/s; 250 chol_solve + 125 newton_qp
     launches) does not pass through (final x-velocity > -9) and shoves
     the root by more than 0.05 m against a run with the ball at rest; a
     50 N push on the root moves it along the push in every env; then card
     vs CPU with both hooks (the push, and a ball thrown at each root), 16
     envs from Fall init states, 2 control steps of 3 substeps at
     half-scale random actions (the Fall states are chaotic over longer
     windows: on the CPU two float32 runs 1e-6 apart part by 0.04 after 2
     control steps of 15 substeps, by 6e-5 at most after 2 of 3): qpos and
     the ball positions within 5e-3, at least 3/4 of the balls met;
 18. the PPO trainer at full width: AgentHumanoid(RunConfig(num_epochs=2,
     save_frequency=1)) with PPOConfig()'s defaults (1024 envs, horizon 32,
     both nets (2048, 1536, 1024, 1024, 512, 512) silu, 10 epochs x 4
     minibatches) on HumanoidSpeed at the package's default QP (K = 64
     compact rows, 40 iterations, tol 1e-6); optimize_policy(2) launches
     exactly 960 chol_solve + 480 newton_qp per PPO iteration and no C, D
     or E; every weight and bias changed and finite; log.txt's nine keys;
     each epoch's T_step, env-steps/s, rollout and update seconds and
     solver health printed; the epoch-2 checkpoint loads into a new agent
     bit for bit, and one more epoch from it reproduces the trainer's bit
     for bit; run_policy(4 episodes, 8 steps) at 30 + 15 launches per step;
     Kernels A and B against their plain versions, as in phase 2, on a
     real substep of the trainer's env states after the third epoch under
     the policy's mean action, at the trainer's QP: A at m = 1 + diag and
     m = 65, B at K = 64 with 40 iterations and tol 1e-6 (the shapes no
     other phase holds on real systems), with their times and bounds;
     then PPO.update on the card and on the CPU in float64 (widths (64, 64),
     one numpy-made trajectory of 8 x 64 and the same permutations):
     parameters, Adam moments and running norm within 1e-9 relative;
 19. the CEM planner: CEMPlanner(HumanoidGetup(model, GetupConfig()),
     CEMConfig()) (128 samples, horizon 8, 3 iterations) from a Fall reset
     of one env: one plan launches 30 x 24 chol_solve + 15 x 24 newton_qp
     and no C, D or E; its best cost is at most the zero-action rollout's;
     the env's generator is as it was; seconds per plan; then
     receding_horizon(state, 2).
 20. the β batch (bench.py's BENCH_BETA_HET path): 64 bodies built by
     build_robot_model from the synthetic SMPL body
     (tests/_torch_synthetic_body.py) with β ~ N(0, 0.8²) drawn by
     np.random.RandomState(11), the native hull library asserted, their
     build time; stack_models, tile_model to 4096 envs; HumanoidSpeed, 16
     control steps of uniform random actions at the bench QP: exactly 30
     chol_solve + 15 newton_qp launches per control step, env-steps/s
     beside phase 3's, overflow and stalled shares; card vs CPU over 3
     control steps of 3 substeps on 8 of the bodies within 5e-3; Kernels A
     and B against their plain versions on a real substep after 3 control
     steps (hold_a_b), leaving out the wild envs (|qvel| > 1e3: flung far
     away, their float32 M may not be SPD, where kernel and plain version
     must both give non-finite values, and their QPs are too ill-conditioned
     in float32 for two solvers to agree), counted; B's float32 objectives
     where both solvers meet the tolerance, each system left out shown to
     stop at the iteration cap in at least one solver, the reading over
     all printed beside it (a third of the systems fill K);
 21. the SMPLX humanoid (bench.py's BENCH_MODEL=smplx path: 52 bodies with
     finger capsules, nv = 159): 4096 envs, 8 control steps at the bench
     QP, 30 + 15 launches each, env-steps/s, overflow and stalled shares,
     the largest active-row count; A at n = 159 (m = 1 + diag, m = 33) and
     B against their plain versions on a real substep, as in phase 20 (B's
     objectives where both meet the tolerance), with time, bound and
     library time; one float64 control step at the package's default
     QP (K = 64: A at m = 65 in two chunks) on 64 envs from a reset, card
     vs CPU within 1e-9, and A's chunked launch timed on its systems.
 22. the articulated-body route (SMPLSIM_ABA=1, physics/substep.py): the
     speed path of phase 3 on the route and on the dense route, each 16
     step_autoresets from one reset under one action draw (a generator
     seeded 22 for both): exactly 1 chol_solve + 15 newton_qp per control
     step on the route (30 + 15 on the dense one), env-steps/s of both,
     overflow and stalled shares; card vs CPU on the route, 16 envs, 2
     control steps of half-scale actions, qpos within 5e-3; on a real
     substep after 3 control steps, physics/aba.py's mass_solve against
     Kernel A on the same (M + diag, rhs) at m = 1 + diag and m = 33: the
     float64 relative residual against M + diag within ABA_RESIDUAL (the
     envs with |qvel| > 1e3 or M + diag not SPD left out, counted), the
     events ms, device busy ms and device ops of one elimination beside
     A's ms;
 23. NvHumanoid (obs v2 with 5 past steps, freeze_hand, an impulse every 4
     control steps, 2 projectiles thrown every 8) through GymVectEnv at
     4096 envs, 16 steps of numpy actions: 30 + 15 launches per step,
     finite observations of width obs_max_v2_size(24, 6), the termination
     share, env-steps/s with the facade's host copies; card vs CPU, 16
     envs, 2 control steps, the impulse and throw draws made on the card
     and fed to both: qpos and sphere positions within 5e-3;
 24. DomainRandEnv over HumanoidSpeed at 4096 envs, every physical field
     and both noises randomized, frequency 1: 16 step_autoresets at 30 + 15
     launches each, the redraw count, env-steps/s; Kernels A and B against
     their plain versions on a real domain-randomized substep after 3
     control steps, as in phase 20; card vs CPU on one 16-env realization,
     2 control steps, qpos within 5e-3;
 25. HumanoidMove at 180 Hz (the model's timestep set to 1/180), 6 substeps
     per control step, 4096 envs, 16 step_autoresets: 12 chol_solve + 6
     newton_qp per step, every reward finite in [0, 1], env-steps/s;
 26. the motion library: 4096 synthetic clips of 60-600 frames
     (tests/_torch_synthetic_motion.py, 1 in 4 at 60 fps) loaded with the
     heading randomized (numpy.random.default_rng(0)): seconds, frames,
     table bytes and memory_allocated before and after; the first 16 clips
     card vs CPU (positions and rotations as +-q within 5e-3), and the
     batched load against a per-clip load of them on the card (1e-6);
 27. get_motion_state and get_motion_state_intervaled at B = 4096 (ids
     from sample_motion_ids, times from sample_time): seconds per call and
     states/s over 100 calls after a warm-up; card vs CPU on one call over
     clips 0-15 within 5e-3;
 28. HumanoidPlayback over that library at 4096 envs (env i plays clip
     i), 64 step_autoresets: env-steps/s, no launch of Kernels A-E;
     compute_metrics_lite of the physics FK of the played qpos against the
     library's global_translation at the same frames, over the envs that
     played 64 frames without a reset: mpjpe_g mean and max, those of
     clips 0-15 within PLAYBACK_FK_GAP_MM (the JAX package's float64 gap)
     + FK_GAP_SLACK_MM;
 29. PoseFitter (tests/test_fitting.py's camera and draws) on a 300-frame
     clip: after a 2-step warm-up, fit(steps=100, lr=0.01) in float32,
     seconds and the final / initial proj_2d_loss (< 0.2), fit() at its
     defaults timed; the
     float64 fit(steps=5) card vs CPU (losses and vector within 1e-9);
 30. poselib on the first 16 clips of phase 26: SkeletonState from the
     clips' local rotations, its global_translation within 1e-5 m of
     HumanoidBatchFK's; from the library's global rotations, printed.
 31. the sharded PPO step (parallel.sharded_ppo_step) at a world of 1 over
     NCCL in this process (init_process_group at a file:// rendezvous):
     PPOConfig() on HumanoidSpeed at the default QP, one iteration, 960
     chol_solve + 480 newton_qp and no C, D or E; every tensor of the
     TrainState (generators, nets, Adam states, running norm, env states)
     and the six metrics equal bit for bit to rollout + update (no group)
     from the derived local TrainState (parallel.rollout.local_train_state)
     of a second, identical init; seconds per iteration beside phase 18's;
 32. two ranks in processes started with the spawn method
     (parallel.mesh.run_ranks; the kernels built by this process first) on
     the one card over gloo (NCCL takes no two ranks on one device):
     PPOConfig() with 512 envs per rank, 2 iterations of the sharded step,
     each 960 + 480 launches per rank; the six metrics equal on both ranks;
     the trainer's generator, every parameter, Adam moment and the running
     norm bit-identical across the ranks (SHA-256 of every tensor); seconds
     per iteration and the training env-steps/s summed over the ranks;
     then the float64 PPO.update(group=) of phase 18 (widths (64, 64), 2
     ranks x 32 of the 64 envs) on the card and on the CPU in the same
     world, within 1e-9 relative;
 33. CEMPlanner(HumanoidGetup, CEMConfig(num_samples=64)).plan(group=) at
     the same 2 ranks from the same Fall reset, each rank's samples from
     fold_in(generator, rank): 720 chol_solve + 360 newton_qp per rank;
     both ranks' first action, mean and best cost equal bit for bit; the
     best cost at most the zero-action rollout's; seconds per plan beside
     phase 19's. A rank that fails, dies or outlives RANKS_TIMEOUT kills
     both and fails the run.
 34. the product gate (tools/gate_f32_torch.py's functions; BASELINE.md's
     1e-2 over 150 closed-loop steps against MuJoCo), one env:
     HumanoidSpeed from the MuJoCo golden's start under its actions
     (tests/golden/speed_ref_150.npz), cut in depth from the tool's 150
     steps (GATE_* below): float64 at the package's default QP over
     GATE_STEPS = 42 control steps, within 1e-9 of the golden at every
     step; float32 at the product QP on the dense route over 42 steps and
     on the articulated-body route over 20, within 5e-3 of the JAX
     package's float32 trajectory (speed_ref_150_jax_f32_product.npy) over
     steps 0-39 and 0-19, the golden and tight curves and the 45-step
     envelope printed, not gated; getup at 64 envs x 3 step_autoresets,
     stalled share <= 0.05; 30 + 15 launches per control step on the
     dense route, 1 + 15 on the ABA route, 90 + 45 for getup's reset and
     120 + 60 per step_autoreset; then Kernels A (m = 1 + diag and m =
     65) and B (K = 64, 40 iterations) against their plain versions at B =
     1 on the float64 loop's own systems before control steps 18 and 41
     (hold_a_b; the race with the column kernel and the block form printed,
     not gated: at one system it is one launch's latency).

Phases 3, 6, 9, 14, 16, 17's projectile run, 18's training, 18's eval,
19's plan, 20's and 21's runs, 21's float64 step, 22's two runs, 23's,
24's, 25's and 28's runs, 31's iteration, each rank's iterations in 32
and plan in 33, and 34's four gate runs each set every launch count to 0
just before and read them just after. The third-to-last line is the
`kernels` JSON object, the
line after it the card's name and power limit; the last line is the result
object.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import forward_ad

B_MAIN = 4096
STEPS = 16
CFI = 15
QP = dict(qp_iters=16, qp_tol=1e-4, qp_rows=32)
# phase 7: (action scale, substeps per control step, control steps)
TORQUE_CMP = ((0.5, 3, 1), (0.003, CFI, 2))
# phases 8-10: trajectory points (= iLQR horizon), substeps of the float64
# card-vs-CPU Jacobians, iLQR iterations
N_POINTS = 4
CMP_CFI = 2
ILQR_ITERS = 2
# phase 17: substeps per control step of the card-vs-CPU check from Fall states
PERTURB_CMP_CFI = 3
# phases 20-21: β bodies (bench.py's BENCH_BETAS), control steps of the β
# batch and of the SMPLX humanoid, envs of the SMPLX float64 step
N_BETAS = 64
BETA_STEPS = 16
SMPLX_STEPS = 8
X64_ENVS = 64
# phases 20-21 hold A and B on the envs below this |qvel| (held_inputs)
WILD_QVEL = 1e3
# phase 22: the float32 elimination's relative residual against M + diag,
# the bound of Kernel A's float32 checks (on the CPU, 128 envs after 3
# control steps: 2.6e-07 at m = 1 + diag, 1.0e-07 at m = 33; A 1.6e-08)
ABA_RESIDUAL = 1e-5
# phase 3's solver health with A's column kernel and B's block form, same
# seed, draw and card: a kernel change that moves them moves the operating
# point
PREVIOUS_HEALTH = {"overflow": 0.20546, "stalled": 0.07318}
# phase 28: the physics FK of the played qpos against the library's
# global_translation is held to the JAX package's own float64 gap on the
# same clips (frames 1-64 of the first PLAYBACK_CMP_CLIPS clips of the
# motion set that play 64 steps, their heading draws), measured by
# tests/test_torch_playback_poselib.py::test_physics_fk_against_library_gap
# (which asserts it stays below these), plus FK_GAP_SLACK_MM of float32.
# On the CPU in float64 the JAX package read mean 1.741e-13, max 1.461e-12
# mm over those 16 clips, the port 1.781e-13 and 1.494e-12: rounding only
# (the baked offsets already have 4 decimals, so the motion FK's rounding
# to 5 changes nothing)
PLAYBACK_CMP_CLIPS = 16
# phases 26-29: clips of the motion library, calls timed per sampler,
# playback steps, frames of the fitted clip
N_CLIPS = 4096
SAMPLE_CALLS = 100
PLAY_STEPS = 64
FIT_FRAMES = 300
PLAYBACK_FK_GAP_MM = {"mean": 2e-13, "max": 2e-12}
FK_GAP_SLACK_MM = 1e-2
# phases 31-33: ranks of the gloo world on the one card, its iterations,
# each rank's CEM samples, the seconds the world may take
SHARDED_WORLD = 2
SHARDED_ITERS = 2
CEM_RANK_SAMPLES = 64
RANKS_TIMEOUT = 900
# phase 34: the product gate (tools/gate_f32_torch.py, 150 control steps
# each, 64 x 150 for getup) cut to this run's time. One env steps
# launch-bound: on an H100 80GB HBM3 at 700 W, 0.72-0.75 s per control
# step alone, 0.92-0.98 s after phases 1-33, 1.43 s on the ABA route,
# getup 2.5-4.5 s per step_autoreset; and the whole script took 850.8 s
# on one host and 1,224.1 s on a slower one (the rates of every phase
# 0.64-0.75x), against a limit of 1,200 s. The float64 and the dense
# float32 loops run GATE_STEPS = 42 steps: the float32 gate's window (steps
# 0-39) and the golden's crossing at 41; the articulated-body route
# GATE_ABA_STEPS = 20 (its window steps 0-19); getup GATE_GETUP_ENVS envs x
# GATE_GETUP_STEPS = 3 step_autoresets. Kernels A and B are held at B = 1
# on the float64 loop's systems before the control steps GATE_HOLD_STEPS,
# two of the most contact-rich of the 42 (32 active rows each; steps 0,
# 6, 12 and 27-30 have none, on the CPU and on the card, whose float64
# loops agree to 1e-12)
GATE_STEPS = 42
GATE_ABA_STEPS = 20
GATE_GETUP_ENVS = 64
GATE_GETUP_STEPS = 3
GATE_HOLD_STEPS = (18, 41)
# H100 SXM published peaks (dense, 700 W): HBM bytes/s, float32 outside the
# tensor cores, float64 on them (the card's top rate for the type; 34e12
# outside them)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}


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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of fn() alone: reps calls captured in one CUDA graph,
    replayed 5 times, the mean per call (no host time per call in it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (5 * reps)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def inf_norm(X):
    """Per-system max row sum of |X| (B,n,m) -> (B,)."""
    return X.abs().sum(-1).amax(-1)


def rel_residual(H, x, b):
    """Per-system |H x - b| / (|H| |x| + |b|) in the infinity norms, max;
    computed in float64 (a system with b = 0 and x = 0 counts 0)."""
    H, x, b = H.double(), x.double(), b.double()
    return ((H @ x - b).abs().amax((1, 2))
            / (inf_norm(H) * x.abs().amax((1, 2)) + b.abs().amax((1, 2))).clamp_min(1e-300)
            ).amax().item()


def rel_diff(k, p):
    """Per-system max|k - p| / max|p|, max over the systems, in float64."""
    k, p = k.double(), p.double()
    return ((k - p).abs().amax((1, 2)) / p.abs().amax((1, 2)).clamp_min(1e-300)).amax().item()


def finite_rows(*ts):
    """(B,) True where every entry of every (B,...) tensor is finite."""
    return torch.stack([torch.isfinite(t).flatten(1).all(1) for t in ts]).all(0)


def cmp_points(m):
    """(x (2,nq+nv), u (2,nu)) float64 on the CPU: an air state (standing
    height, small joint noise) and a contact state (lying at the floor), as
    the parity tests draw them, with actions at 10% of full scale."""
    g = torch.Generator().manual_seed(7)
    randn = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64)
    qpos = m.qpos0[None].repeat(2, 1)
    qpos[0, 2] = 0.95
    qpos[1, 2] = 0.17
    qpos[1, 3:7] = torch.tensor([0.7071068, 0.7071068, 0.0, 0.0], dtype=torch.float64)
    qpos[:, 7:] += 0.1 * randn(2, m.nv - 6)
    u = 0.1 * (2.0 * torch.rand(2, m.nu, generator=g, dtype=torch.float64) - 1.0)
    return torch.cat([qpos, 0.2 * randn(2, m.nv)], 1), u


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def chol_solve_raw(build, A, b, d, x, form=None) -> None:
    """One uncounted launch of a raw chol_solve.cu entry point into x: the
    column kernel (form None), or Kernel A's tiled form with a warp (0) or a
    thread (1) per right-hand-side column."""
    sfx = "f32" if A.dtype == torch.float32 else "f64"
    args = (A.data_ptr(), b.data_ptr(), None if d is None else d.data_ptr(), x.data_ptr(),
            *b.shape)
    name = f"chol_solve_{sfx}" if form is None else f"chol_solve_tiled_{sfx}"
    extra = () if form is None else (form,)
    build.check(build.kernel("chol_solve.cu", name)(*args, *extra, stream_ptr()), name)


def cholesky_column_raw(build, A, L) -> None:
    """One uncounted launch of Kernel E's column form (chol_solve.cu) into L."""
    name = "cholesky_f32" if A.dtype == torch.float32 else "cholesky_f64"
    build.check(build.kernel("chol_solve.cu", name)(A.data_ptr(), L.data_ptr(), *A.shape[:2],
                                                    stream_ptr()), name)


def newton_qp_raw(build, A, b, a, f0, f, it, tol) -> None:
    """One uncounted launch of newton_qp.cu's block-per-system form into f."""
    name = "newton_qp_f32" if A.dtype == torch.float32 else "newton_qp_f64"
    build.check(build.kernel("newton_qp.cu", name)(
        A.data_ptr(), b.data_ptr(), a.data_ptr(), f0.data_ptr(), f.data_ptr(), *b.shape, it, tol,
        stream_ptr()), name)


def objective_where_converged(tag, rel_o, conv_p, conv_k, its, it, ok) -> None:
    """newton_qp float32: the objectives of kernel and plain (relative gap
    rel_o) within 1e-4 on the systems of `ok` where both met the tolerance,
    and each system they part on by more than 1e-4 stopped at the iteration
    cap in at least one solver. Both stop only at the tolerance or at the
    cap (newton_qp.cu, qp.newton_qp_plain_counted), so a system short of the
    tolerance ran every iteration; the plain version's count shows it. A
    system stopped by the cap leaves its iterate mid-way, where float32
    rounding moves the objective by more than 1e-4. Prints the reading over
    all systems of `ok` beside it."""
    both = ok & conv_p & conv_k
    off = ok & (rel_o > 1e-4)
    o_both = rel_o[both].max().item() if both.any() else 0.0
    o_all = rel_o[ok].max().item() if ok.any() else 0.0
    print(f"  {tag}newton_qp float32: objective within {o_both:.3e} on the {int(both.sum())} of "
          f"{int(ok.sum())} systems where both meet tol, {o_all:.3e} over all; {int(off.sum())} "
          f"part by more than 1e-4: the plain version short of tol in "
          f"{int((off & ~conv_p).sum())}, the kernel in {int((off & ~conv_k).sum())}", flush=True)
    check(bool((its[ok & ~conv_p] == it).all()),
          f"{tag}newton_qp float32: every system the plain version leaves short of tol ran all "
          f"{it} iterations")
    check(not bool((off & both).any()),
          f"{tag}newton_qp float32: each of the {int(off.sum())} systems whose objectives part by "
          "more than 1e-4 stopped at the iteration cap in at least one solver")
    check(o_both <= 1e-4, f"{tag}newton_qp float32 objective within {o_both:.3e} <= 1e-4 where "
                          "both meet the tolerance")


def tolerance_spread(A, b, a, fk, fp, tol, parted) -> bool:
    """True if, on each system of `parted`, two answers that both meet the
    KKT tolerance tau = tol (1 + max|b|) lie within the distance that
    tolerance allows two solutions of the system's LCP over its active
    rows: |fk - fp|_2 <= 2 sqrt(k) tau (1 + |A_aa|_2) / lambda_min(A_aa)
    (the natural-residual error bound of a strongly monotone LCP, each
    answer within (1 + L) / mu of the |min(f, g)| residual from the
    solution). On ill-conditioned float64 systems, rare on the main path
    and more frequent on domain-randomized inputs (1 of 1,639 converged
    systems parted by 3.5e-9 in one chip run), two converged answers may
    part by more than 1e-9 with both correct to the tolerance: this shows
    it for each such system. Prints each one."""
    ok = True
    for i in parted.nonzero().flatten().tolist():
        act = a[i] > 0.5
        ev = torch.linalg.eigvalsh(A[i][act][:, act])
        tau = tol * (1.0 + b[i].abs().max())
        bound = (2.0 * math.sqrt(int(act.sum())) * tau * (1.0 + ev[-1]) / ev[0]).item()
        gap = (fk[i] - fp[i]).norm().item()
        ok &= ev[0].item() > 0 and gap <= bound
        print(f"    system {i}: |k-p| {gap:.3e} against the tolerance's bound {bound:.3e} "
              f"(k = {int(act.sum())} active rows, eigenvalues {ev[0].item():.3e} to "
              f"{ev[-1].item():.3e})", flush=True)
    return ok


def time_qp(qp, build, A, b, a, f0, it, tol, converged_only=False,
            gate_forms: bool = True) -> dict:
    """newton_qp float32: kernel against plain on the systems with finite
    inputs and plain result (with converged_only, on those where both meet
    the tolerance), times on all, the bound from the iterations this data
    needs; the block-per-system form timed on the same inputs (gate_forms:
    failing unless the wrapper's form is the faster)."""
    fk = qp.newton_qp(A, b, a, f0, it, tol)
    fp, its = qp.newton_qp_plain_counted(A, b, a, f0, it, tol)
    ok = finite_rows(A, b, f0, fp)
    check(bool(torch.isfinite(fk[ok]).all()),
          f"newton_qp float32 finite on the {int(ok.sum())} systems with finite inputs")
    obj = lambda f: 0.5 * (f * (A @ f[..., None])[..., 0]).sum(-1) - (b * f).sum(-1)
    rel_o = (obj(fk) - obj(fp)).abs() / obj(fp).abs().clamp_min(1e-12)
    if converged_only:
        tol_sys = tol * (1.0 + b.abs().amax(-1))
        conv_k, conv_p = qp.kkt_residual(A, b, fk, a) <= tol_sys, qp.kkt_residual(A, b, fp, a) <= tol_sys
        only_p = int((ok & conv_p & ~conv_k).sum())
        check(only_p <= int(ok.sum()) // 100,
              f"newton_qp float32: the kernel misses the tolerance on at most 1% of the "
              f"systems where the plain version meets it ({only_p})")
        objective_where_converged("", rel_o, conv_p, conv_k, its, it, ok)
    else:
        orel = rel_o[ok].amax().item()
        check(orel <= 1e-4, f"newton_qp float32 objective within {orel:.3e} <= 1e-4")
    ms = cuda_ms(lambda: qp.newton_qp(A, b, a, f0, it, tol), 20)
    fo = torch.empty_like(b)
    prev = cuda_ms(lambda: newton_qp_raw(build, A, b, a, f0, fo, it, tol), 20)
    plain = cuda_ms(lambda: qp.newton_qp_plain(A, b, a, f0, it, tol), 3)
    faster = f"newton_qp float32: the {qp.newton_qp_route(b.shape[1])} form ({ms:.4f} ms) " \
             f"is faster than the block form ({prev:.4f} ms) in this call"
    if gate_forms:
        check(ms < prev, faster)
    else:
        print(f"  not gated: {faster}: {ms < prev}", flush=True)
    Bn, Kq = b.shape
    nbytes = 4 * Bn * (Kq * Kq + 4 * Kq)
    # the work this run's data needs: the Newton iterations each system
    # ran (masked factor K^3/3, 11 matvecs and 2 triangular solves of
    # 2K^2 each), plus one KKT matvec per system to stop
    n_it = int(its.sum())
    flops = n_it * (Kq ** 3 / 3 + 26 * Kq * Kq) + Bn * 2 * Kq * Kq
    bms, by = bound_ms(nbytes, flops, A.dtype)
    return dict(max_abs_err=(fk - fp)[ok].abs().amax().item(),
                max_rel_err=((fk - fp).abs().amax(1)
                             / fp.abs().amax(1).clamp_min(1e-30))[ok].amax().item(),
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by,
                previous_ms=prev, iterations_mean=n_it / Bn, iterations_max=int(its.max()))


def edge_cases(linalg, dev) -> None:
    """Phase 11: Kernels C and D against their plain versions on random SPD
    systems at every dispatch shape, with garbage above the diagonal and a
    NaN system in the batch."""
    g = torch.Generator(device=dev).manual_seed(11)
    worst = {}

    def note(key, val):
        worst[key] = max(worst.get(key, 0.0), val)

    garbage = lambda M, fill: torch.tril(M) + torch.triu(torch.full_like(M, fill), 1)
    # n = 159: the SMPLX humanoid's nv, one batch
    shapes = ((32, (1, 3, 33), (1, 2, 32, 75)), (75, (1, 3, 33), (1, 2, 32, 75)),
              (159, (3,), (1, 33)))
    for dt in (torch.float64, torch.float32):
        name = "float64" if dt == torch.float64 else "float32"
        for n, batches, ms_ in shapes:
            for Bn in batches:
                G = torch.randn(Bn, n, n, generator=g, device=dev, dtype=torch.float64)
                A = (G @ G.mT / n + torch.eye(n, device=dev, dtype=torch.float64)).to(dt)
                Lf = linalg.cholesky_plain(A)
                for m in ms_:
                    b = torch.randn(Bn, n, m, generator=g, device=dev, dtype=torch.float64).to(dt)
                    shape = f"B={Bn}, n={n}, m={m}"
                    for trans in (False, True):
                        xk = linalg.solve_lower(Lf, b, trans)
                        xp = linalg.solve_lower_any_plain(Lf, b, trans)
                        if dt == torch.float64:
                            note(("D", name, "elementwise"), rel_diff(xk, xp))
                        else:
                            note(("D", name, "residual"),
                                 rel_residual(Lf.mT if trans else Lf, xk, b))
                        for fill in (7.0, float("nan")):
                            if not torch.equal(linalg.solve_lower(garbage(Lf, fill), b, trans), xk):
                                fail(f"solve_lower {name} {shape} trans={trans}: {fill} above "
                                     "the diagonal changed the result")
                    Lk, xk = linalg.cho_factor_solve(A, b)
                    Lp, xp = linalg.cho_factor_solve_plain(A, b)
                    if not bool((torch.triu(Lk, 1) == 0).all()):
                        fail(f"cho_factor_solve {name} {shape}: L not zero above the diagonal")
                    if dt == torch.float64:
                        note(("C", name, "elementwise"), max(rel_diff(Lk, Lp), rel_diff(xk, xp)))
                    else:
                        Lk64, A64 = Lk.double(), A.double()
                        note(("C", name, "residual"), rel_residual(A, xk, b))
                        note(("C", name, "factor"),
                             (inf_norm(Lk64 @ Lk64.mT - A64) / inf_norm(A64)).amax().item())
                    for fill in (7.0, float("nan")):
                        Lg, xg = linalg.cho_factor_solve(garbage(A, fill), b)
                        if not (torch.equal(Lg, Lk) and torch.equal(xg, xk)):
                            fail(f"cho_factor_solve {name} {shape}: {fill} above the diagonal "
                                 "changed the result")
                if Bn == 33:
                    # a NaN system between finite ones stays in its own system
                    keep = torch.arange(Bn, device=dev) != Bn // 2
                    An, Ln = A.clone(), Lf.clone()
                    An[Bn // 2] = float("nan")
                    Ln[Bn // 2] = float("nan")
                    for m in (1, 32):
                        b = torch.randn(Bn, n, m, generator=g, device=dev, dtype=dt)
                        ok = all(torch.equal(linalg.solve_lower(Ln, b, t)[keep],
                                             linalg.solve_lower(Lf, b, t)[keep])
                                 for t in (False, True))
                        ok = ok and all(torch.equal(u[keep], v[keep]) for u, v in zip(
                            linalg.cho_factor_solve(An, b), linalg.cho_factor_solve(A, b)))
                        check(ok, f"{name} n={n} m={m}: a NaN system in a batch of {Bn} leaves "
                                  "the others' results bit for bit")
    for (kern, name, what), val in sorted(worst.items()):
        tol = 1e-9 if name == "float64" else 1e-5
        label = {"elementwise": "vs plain, per system relative to max|plain|",
                 "residual": "relative residual", "factor": "|L L^T - A| / |A|"}[what]
        check(val <= tol, f"{'cho_factor_solve' if kern == 'C' else 'solve_lower'} {name} "
                          f"{label}, worst over B in (1, 3, 33), n in (32, 75), m in "
                          f"(1, 2, 32, 75) and B = 3, n = 159, m in (1, 33): {val:.3e} <= {tol:g}")
    print("  ok: 7.0 and NaN above the diagonal change no bit of C's or D's results", flush=True)


def edge_cases_ab(linalg, qp, dev) -> None:
    """Phase 12: Kernels A and B against their plain versions at every shape
    their dispatch tells apart, on degenerate inputs and with a NaN system
    in the batch."""
    g = torch.Generator(device=dev).manual_seed(12)
    worst = {}

    def note(key, val):
        worst[key] = max(worst.get(key, 0.0), val)

    garbage = lambda M, fill: torch.tril(M) + torch.triu(torch.full_like(M, fill), 1)
    # Kernel A: n = 180 is above the tiles (n <= 176): the column kernel,
    # which holds it in float32 only (float64 exceeds a block's shared
    # memory); n = 159 (SMPLX) and 176 at m up to 65, where float64 solves
    # its columns in chunks
    routes = set()
    m_of = lambda n: (1, 33, 65) if n in (159, 176) else (1, 2, 33, 75)
    for dt in (torch.float64, torch.float32):
        name = "float64" if dt == torch.float64 else "float32"
        for n in (32, 75, 159, 176, 180):
            if dt == torch.float64 and n == 180:
                A = torch.eye(n, device=dev, dtype=dt).expand(1, n, n).contiguous()
                try:
                    linalg.chol_solve(A, torch.ones(1, n, 1, device=dev, dtype=dt))
                except ValueError:
                    print("  ok: chol_solve float64 at n=180 raises ValueError (a block's shared "
                          "memory)", flush=True)
                else:
                    fail("chol_solve float64 at n=180 did not raise")
                continue
            for Bn in (1, 3, 33):
                G = torch.randn(Bn, n, n, generator=g, device=dev, dtype=torch.float64)
                A = (G @ G.mT / n + torch.eye(n, device=dev, dtype=torch.float64)).to(dt)
                for m in m_of(n):
                    b = torch.randn(Bn, n, m, generator=g, device=dev, dtype=torch.float64).to(dt)
                    routes.add((n, m, linalg.chol_solve_route(n, m, A.element_size())))
                    for d in (None, torch.rand(Bn, n, generator=g, device=dev, dtype=dt)):
                        shape = f"B={Bn}, n={n}, m={m}, d={'yes' if d is not None else 'no'}"
                        xk = linalg.chol_solve(A, b, d)
                        xp = linalg.chol_solve_plain(A, b, d)
                        H = A if d is None else A + torch.diag_embed(d)
                        if dt == torch.float64:
                            note(("A", name, "elementwise"), rel_diff(xk, xp))
                        else:
                            note(("A", name, "residual"), rel_residual(H, xk, b))
                        for fill in (7.0, float("nan")):
                            if not torch.equal(linalg.chol_solve(garbage(A, fill), b, d), xk):
                                fail(f"chol_solve {name} {shape}: {fill} above the diagonal "
                                     "changed the result")
                if Bn == 33:
                    keep = torch.arange(Bn, device=dev) != Bn // 2
                    An = A.clone()
                    An[Bn // 2] = float("nan")
                    for m in (1, 33):
                        b = torch.randn(Bn, n, m, generator=g, device=dev, dtype=dt)
                        ok = torch.equal(linalg.chol_solve(An, b)[keep],
                                         linalg.chol_solve(A, b)[keep])
                        check(ok, f"chol_solve {name} n={n} m={m}: a NaN system in a batch of "
                                  f"{Bn} leaves the others' results bit for bit")
    print(f"  chol_solve routes (n, m, route): {sorted(routes)}", flush=True)
    check({r for _, _, r in routes} == {"warp", "thread", "column"},
          "the edge cases reach all three of chol_solve's routes")
    check(all(r != "column" for n, _, r in routes if n <= 176),
          "no n <= 176 went to the column kernel")
    # the chunked solve equals the unchunked one bit for bit: the wrapper's
    # launch on all m columns (in chunks where they do not fit at once)
    # against its launches on two column slices, each solved in one chunk on
    # the same factor (a column's arithmetic does not depend on its slot)
    for n, m, dt in ((159, 65, torch.float64), (176, 65, torch.float64),
                     (159, 65, torch.float32), (75, 33, torch.float64)):
        G = torch.randn(33, n, n, generator=g, device=dev, dtype=torch.float64)
        A = (G @ G.mT / n + torch.eye(n, device=dev, dtype=torch.float64)).to(dt)
        b = torch.randn(33, n, m, generator=g, device=dev, dtype=torch.float64).to(dt)
        size, half = A.element_size(), (m + 1) // 2
        lay = lambda m_: linalg.chol_solve_tiled_layout(n, m_, size, "thread")
        chunks = lambda m_: -(-m_ // lay(m_)[1])
        check(linalg._tile_threads(n, True) >= 32 * -(-m // 32)
              and chunks(half) == chunks(m - half) == 1,
              f"chol_solve {dt} n={n}: the slices of {half} and {m - half} columns take one "
              f"chunk each, the factor's threads as at m={m}")
        xs = torch.cat([linalg.chol_solve(A, b[..., :half].contiguous()),
                        linalg.chol_solve(A, b[..., half:].contiguous())], -1)
        check(torch.equal(linalg.chol_solve(A, b), xs),
              f"chol_solve {dt} n={n} m={m}: {chunks(m)} chunk(s) of {lay(m)[1]} columns "
              f"equal the two one-chunk slices bit for bit")

    # Kernel B: K = 80 is above the warp form (K <= 64): the block form
    Bq, iters, nv = 256, 16, 75
    for K in (8, 32, 33, 64, 80):
        J = torch.randn(Bq, K, nv, generator=g, device=dev, dtype=torch.float64)
        A = J @ J.mT / nv + 1e-3 * torch.eye(K, device=dev, dtype=torch.float64)
        b = torch.randn(Bq, K, generator=g, device=dev, dtype=torch.float64)
        act = (torch.rand(Bq, K, generator=g, device=dev) < 0.8).double()
        act[0] = 0.0  # a system with no active row
        f0 = torch.rand(Bq, K, generator=g, device=dev, dtype=torch.float64) - 0.3
        f0[: Bq // 2] = 0.0
        for dt in (torch.float64, torch.float32):
            name = "float64" if dt == torch.float64 else "float32"
            tag = f"K={K} ({qp.newton_qp_route(K)} form) {name}"
            args = [t.to(dt).contiguous() for t in (A, b, act, f0)]
            tol = 1e-12 if dt == torch.float64 else 1e-4
            fk = qp.newton_qp(*args, iters, tol)
            fp = qp.newton_qp_plain(*args, iters, tol)
            check(bool(torch.isfinite(fk).all()) and bool((fk[0] == 0).all()),
                  f"newton_qp {tag}: finite, and 0 on the system with no active row")
            tol_sys = tol * (1.0 + args[1].abs().amax(-1))
            ck = qp.kkt_residual(args[0], args[1], fk, args[2]) <= tol_sys
            cp = qp.kkt_residual(args[0], args[1], fp, args[2]) <= tol_sys
            if dt == torch.float64:
                both = ck & cp
                note(("B", name, "elementwise"),
                     ((fk - fp).abs() / (1.0 + fp.abs())).amax(1)[both].max().item())
            else:
                obj = lambda f: (0.5 * (f * (args[0] @ f[..., None])[..., 0]).sum(-1)
                                 - (args[1] * f).sum(-1)).double()
                note(("B", name, "objective"),
                     ((obj(fk) - obj(fp)).abs() / obj(fp).abs().clamp_min(1e-12)).amax().item())
                only_p = int((cp & ~ck).sum())
                check(only_p <= Bq // 100,
                      f"newton_qp {tag}: the kernel misses the tolerance on at most 1% of the "
                      f"systems where the plain version meets it ({only_p} of {int(cp.sum())})")
            start = args[3].clamp_min(0.0) * args[2]
            check(torch.equal(qp.newton_qp(*args, 0, tol), start),
                  f"newton_qp {tag}: iters = 0 returns max(f0, 0) * active")
            check(torch.equal(qp.newton_qp(*args, iters, 1e30), start),
                  f"newton_qp {tag}: a huge tol returns max(f0, 0) * active at once")
            An = args[0].clone()
            An[Bq // 3] = float("nan")
            keep = torch.arange(Bq, device=dev) != Bq // 3
            check(torch.equal(qp.newton_qp(An, *args[1:], iters, tol)[keep], fk[keep]),
                  f"newton_qp {tag}: a NaN system leaves the others' results bit for bit")
    for (kern, name, what), val in sorted(worst.items()):
        tol = {"elementwise": 1e-9, "residual": 1e-5, "objective": 1e-4}[what]
        label = {"elementwise": "vs plain, elementwise (where both converge, for B)",
                 "residual": "relative residual", "objective": "objective vs plain"}[what]
        check(val <= tol, f"{'chol_solve' if kern == 'A' else 'newton_qp'} {name} {label}, "
                          f"worst over the edge cases: {val:.3e} <= {tol:g}")


def edge_cases_e(linalg, dev) -> None:
    """Phase 13: Kernel E against its plain version at every route of its
    shape dispatch, with garbage above the diagonal and a NaN system in the
    batch."""
    g = torch.Generator(device=dev).manual_seed(13)
    worst, routes = {}, set()
    garbage = lambda M, fill: torch.tril(M) + torch.triu(torch.full_like(M, fill), 1)
    for dt in (torch.float64, torch.float32):
        name = "float64" if dt == torch.float64 else "float32"
        for n in (8, 32, 33, 64, 75, 159, 180):
            route = linalg.cholesky_route(n, torch.finfo(dt).bits // 8)
            if dt == torch.float64 and n == 180:
                A = torch.eye(n, device=dev, dtype=dt).expand(1, n, n).contiguous()
                try:
                    linalg.cholesky(A)
                except ValueError:
                    print("  ok: cholesky float64 at n=180 raises ValueError (a block's shared "
                          "memory)", flush=True)
                else:
                    fail("cholesky float64 at n=180 did not raise")
                continue
            routes.add((n, route))
            for Bn in (1, 3, 33):
                G = torch.randn(Bn, n, n, generator=g, device=dev, dtype=torch.float64)
                A = (G @ G.mT / n + torch.eye(n, device=dev, dtype=torch.float64)).to(dt)
                shape = f"{name} B={Bn}, n={n} ({route} form)"
                Lk = linalg.cholesky(A)
                Lp = linalg.cholesky_plain(A)
                if not bool((torch.triu(Lk, 1) == 0).all()):
                    fail(f"cholesky {shape}: L not zero above the diagonal")
                if dt == torch.float64:
                    key, val = "elementwise", rel_diff(Lk, Lp)
                else:
                    L64, A64 = Lk.double(), A.double()
                    key = "factor"
                    val = (inf_norm(L64 @ L64.mT - A64) / inf_norm(A64)).amax().item()
                worst[(name, key)] = max(worst.get((name, key), 0.0), val)
                for fill in (7.0, float("nan")):
                    if not torch.equal(linalg.cholesky(garbage(A, fill)), Lk):
                        fail(f"cholesky {shape}: {fill} above the diagonal changed the result")
                if Bn == 33:
                    keep = torch.arange(Bn, device=dev) != Bn // 2
                    An = A.clone()
                    An[Bn // 2] = float("nan")
                    check(torch.equal(linalg.cholesky(An)[keep], Lk[keep]),
                          f"cholesky {shape}: a NaN system in a batch of {Bn} leaves the "
                          "others' factors bit for bit")
    print(f"  cholesky routes (n, route): {sorted(routes)}", flush=True)
    check({r for _, r in routes} == {"warp", "tiled", "column"},
          "the edge cases reach all three of cholesky's routes")
    for (name, key), val in sorted(worst.items()):
        tol = 1e-9 if name == "float64" else 1e-5
        label = {"elementwise": "vs plain, per system relative to max|plain|",
                 "factor": "|L L^T - A| / |A|"}[key]
        check(val <= tol, f"cholesky {name} {label}, worst over B in (1, 3, 33), n in (8, 32, "
                          f"33, 64, 75, 159, 180): {val:.3e} <= {tol:g}")
    print("  ok: 7.0 and NaN above the diagonal change no bit of E's factor", flush=True)


def substep_inputs(model, state, act, qp_rows: int = QP["qp_rows"]) -> dict:
    """The inputs of Kernels A and B at one real substep of an env state:
    stable-PD's (M_prev + dt diag(kd)) system with its right-hand side,
    the smooth + Delassus system M [qfrc | J^T] and the QP of the qp_rows
    compact rows, under the PD target of the actions `act`. The chol
    entries are named by their right-hand-side columns: "m=1,diag" and
    "m={1 + K}"."""
    from smplsim_tpu_torch.ops import linalg
    from smplsim_tpu_torch.physics import constraints, control, dynamics, kinematics, solver

    q, v = state.phys.qpos, state.phys.qvel
    M_prev, C_prev, f_w = state.pd_cache
    target = control.pd_target_from_action(model, act)
    rhs1, diag1, _ = control.stable_pd_system(model, C_prev, q, v, target)
    kin = kinematics.fk(model, q)
    M = dynamics.mass_matrix(model, kin)
    C = dynamics.bias_forces(model, kin, v)
    tau = control.stable_pd_torque(model, M_prev, C_prev, q, v, target)
    z6 = torch.zeros((q.shape[0], 6), device=q.device)
    qfrc = torch.cat([z6, model.gear * tau], 1) - model.dof_damping * v - C
    efc = constraints.make_efc(model, kin, q, v)
    K = min(qp_rows, constraints.NEFC)
    rows = solver.select_rows(model, kin.S, efc, f_w, K)
    rhs33 = solver.smooth_rhs(qfrc, rows)
    A_qp, b_qp = solver.delassus(rows, linalg.chol_solve_plain(M, rhs33))
    nact = efc.active.sum(1)
    print(f"  inputs: M_prev {tuple(M_prev.shape)}, rhs {tuple(rhs1.shape)} and "
          f"{tuple(rhs33.shape)}, QP {tuple(A_qp.shape)}, active rows per env "
          f"mean {nact.float().mean().item():.2f} max {int(nact.max())}, systems with all "
          f"{K} compact rows active {(rows.actf.sum(1) == K).float().mean().item():.4f}",
          flush=True)
    return dict(chol={"m=1,diag": (M_prev, rhs1, diag1),
                      f"m={rhs33.shape[-1]}": (M, rhs33, None)},
                qp=(A_qp, b_qp, rows.actf, rows.f0),
                full_rows=(rows.actf.sum(1) == K).float().mean().item())


def hold_a_b(tag: str, inputs: dict, iters: int = QP["qp_iters"],
             tol32: float = QP["qp_tol"], converged_only: bool = False,
             gate_forms: bool = True) -> dict:
    """Kernels A (chol_solve at m=1 + diag and m = 1 + K) and B (newton_qp
    with `iters` iterations, float32 tolerance tol32, float64 1e-12)
    against their plain versions on `inputs` (substep_inputs): float64
    elementwise, float32 by residual, objective and KKT; times of kernel,
    plain version, library call and the previous forms (A's column kernel
    and both solve forms through their raw entry points, B's block form),
    failing unless the wrappers' kernels are the faster (with gate_forms
    False, printed only: at a batch of one system the race is one launch's
    latency). Returns the report entries of inputs["chol"] and "qp"; `tag`
    prefixes the printed names."""
    from smplsim_tpu_torch.ops import _build, linalg, qp

    report = {}
    chol_cases = inputs["chol"]
    A_qp, b_qp, act_qp, f0_qp = inputs["qp"]
    for name, (A, b, d) in chol_cases.items():
        for dt in (torch.float64, torch.float32):
            Ad, bd = A.to(dt).contiguous(), b.to(dt).contiguous()
            dd = None if d is None else d.to(dt).contiguous()
            xk = linalg.chol_solve(Ad, bd, dd)
            torch.cuda.synchronize()
            xp = linalg.chol_solve_plain(Ad, bd, dd)
            check(bool(torch.isfinite(xk).all()), f"{tag}chol_solve[{name}] {dt} finite")
            if dt == torch.float64:
                rel = ((xk - xp).abs().amax() / xp.abs().amax()).item()
                check(rel <= 1e-9, f"{tag}chol_solve[{name}] float64 vs plain: {rel:.3e} <= 1e-9")
            else:
                H = Ad if dd is None else Ad + torch.diag_embed(dd)
                resid = lambda x_: ((H @ x_ - bd).abs().amax((1, 2))
                                    / (H.abs().amax((1, 2)) * x_.abs().amax((1, 2))
                                       + bd.abs().amax((1, 2)))).amax().item()
                res = resid(xk)
                check(res <= 1e-5, f"{tag}chol_solve[{name}] float32 relative residual "
                                   f"{res:.3e} <= 1e-5")
                err = (xk - xp).abs().amax().item()
                rel = ((xk - xp).abs().amax((1, 2)) / xp.abs().amax((1, 2))).amax().item()
                ms = cuda_ms(lambda: linalg.chol_solve(Ad, bd, dd), 20)
                plain = cuda_ms(lambda: linalg.chol_solve_plain(Ad, bd, dd), 3)
                # the control: the column kernel and both solve forms of the
                # tiled kernel through their raw entry points, same inputs
                xo = torch.empty_like(bd)
                prev = cuda_ms(lambda: chol_solve_raw(_build, Ad, bd, dd, xo), 20)
                forms = {}
                for form, fname in ((0, "warp"), (1, "thread")):
                    chol_solve_raw(_build, Ad, bd, dd, xo, form)
                    fres = resid(xo)
                    check(fres <= 1e-5, f"{tag}chol_solve[{name}] float32, {fname} form: relative "
                                        f"residual {fres:.3e} <= 1e-5")
                    forms[fname] = cuda_ms(lambda: chol_solve_raw(_build, Ad, bd, dd, xo, form), 20)
                route = linalg.chol_solve_route(*bd.shape[1:], 4)
                faster = (f"{tag}chol_solve[{name}]: the tiled kernel ({route} form, {ms:.4f} "
                          f"ms) is faster than the column kernel ({prev:.4f} ms) in this call")
                if gate_forms:
                    check(ms < prev, faster)
                else:
                    print(f"  not gated: {faster}: {ms < prev}", flush=True)

                def library():
                    L = torch.linalg.cholesky(H if dd is None else Ad + torch.diag_embed(dd))
                    return torch.cholesky_solve(bd, L)
                lib = cuda_ms(library, 10)
                Bn, n, m = bd.shape
                nbytes = 4 * Bn * (n * (n + 1) / 2 + 2 * n * m + (n if dd is not None else 0))
                flops = Bn * (n ** 3 / 3 + 2 * n * n * m)
                bms, by = bound_ms(nbytes, flops, dt)
                report[name] = dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain,
                                    library_ms=lib, bound_ms=bms, bound_by=by, route=route,
                                    previous_ms=prev, forms_ms=forms)
                print(f"  {tag}chol_solve[{name}] f32: kernel {ms:.4f} ms ({route} form; raw warp "
                      f"form {forms['warp']:.4f}, thread form {forms['thread']:.4f}; column "
                      f"kernel {prev:.4f}), plain {plain:.4f} ms, library {lib:.4f} ms, bound "
                      f"{bms:.4f} ms ({by}), max|kernel-plain| {err:.3e} (per system, relative "
                      f"to max|plain|: {rel:.3e})", flush=True)

    for dt in (torch.float64, torch.float32):
        A, b = A_qp.to(dt).contiguous(), b_qp.to(dt).contiguous()
        a, f0 = act_qp.to(dt).contiguous(), f0_qp.to(dt).contiguous()
        tol = 1e-12 if dt == torch.float64 else tol32
        it = iters
        fk = qp.newton_qp(A, b, a, f0, it, tol)
        torch.cuda.synchronize()
        fp, its = qp.newton_qp_plain_counted(A, b, a, f0, it, tol)
        check(bool(torch.isfinite(fk).all()), f"{tag}newton_qp {dt} finite")
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
            worst = lambda m_: rel[m_].max().item() if m_.any() else 0.0
            print(f"  {tag}newton_qp float64: {int(both.sum())} of {both.numel()} systems meet tol "
                  f"1e-12 within {it} iterations in both; {int((conv_p ^ conv_k).sum())} in "
                  f"one only; |k-p|/(1+|p|) max {worst(both):.3e} over the first, "
                  f"{worst(~both):.3e} over the rest", flush=True)
            parted = both & (rel > 1e-9)
            within = tolerance_spread(A, b, a, fk, fp, tol, parted)
            check(worst(both & ~parted) <= 1e-9 and within,
                  f"newton_qp float64 vs plain elementwise <= 1e-9 where both converge "
                  f"({int(both.sum())} systems; {int(parted.sum())} part by more, each "
                  "within the distance its KKT tolerance allows two solutions)")
            check(orel <= 1e-12, f"{tag}newton_qp float64 objective within {orel:.3e} <= 1e-12")
        elif converged_only:
            objective_where_converged(tag, (ok_ - op_).abs() / op_.abs().clamp_min(1e-12),
                                      conv_p, conv_k, its, it, torch.ones_like(conv_p))
        else:
            check(orel <= 1e-4, f"{tag}newton_qp float32 objective within {orel:.3e} <= 1e-4")
        # the KKT residual: where the plain version meets its tolerance the
        # kernel meets it too, but for the rounding-tie systems above
        only_p, only_k = int((conv_p & ~conv_k).sum()), int((conv_k & ~conv_p).sum())
        print(f"  {tag}newton_qp {dt}: plain meets tol in {int(conv_p.sum())}, kernel in "
              f"{int(conv_k.sum())}; only plain {only_p}, only kernel {only_k}", flush=True)
        check(only_p <= conv_p.numel() // 100,
              f"{tag}newton_qp {dt}: the kernel misses the tolerance on at most 1% of the systems "
              f"where the plain version meets it ({only_p})")
        if dt != torch.float32:
            continue
        report["qp"] = time_qp(qp, _build, A, b, a, f0, it, tol, converged_only, gate_forms)
        r = report["qp"]
        print(f"  {tag}newton_qp f32: kernel {r['ms']:.4f} ms (block form {r['previous_ms']:.4f}), "
              f"plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), iterations mean "
              f"{r['iterations_mean']:.2f} max {r['iterations_max']}, max|kernel-plain| "
              f"{r['max_abs_err']:.3e} (per system, relative to max|plain|: "
              f"{r['max_rel_err']:.3e})", flush=True)

    return report


def env_run(env_, n_steps, per_auto, counted, action, gen):
    """reset(B_MAIN), then n_steps x step_autoreset with every launch
    count set to 0 just before and read just after: checks the launches
    per step_autoreset, finite state and, for a getup env, that no env
    terminates while its recovery counter is > 0. action(n) draws the
    actions; the result holds the largest active-row count too."""
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    st = env_.reset(B_MAIN, gen)
    torch.cuda.synchronize()
    out = dict(reset_ms=(time.time() - t0) * 1e3,
               reset_launches=[fn.launches for fn in counted])
    for fn in counted:
        fn.launches = 0
    ov = stl = 0.0
    nact = torch.zeros((), dtype=torch.int32, device=st.cur_t.device)
    r_lo, r_hi = st.reward.min(), st.reward.max()
    getup = hasattr(st.task, "recovery_counter")
    suppressed_ok = True
    t0 = time.time()
    for _ in range(n_steps):
        recovering = st.task.recovery_counter > 0 if getup else None
        st = env_.step_autoreset(st, action(B_MAIN))
        if getup:
            suppressed_ok &= not bool((st.terminated & recovering).any())
        ov += st.info["overflow"].float().mean()
        stl += st.info["stalled"].float().mean()
        nact = torch.maximum(nact, st.info["nactive"].max())
        r_lo, r_hi = torch.minimum(r_lo, st.reward.min()), torch.maximum(r_hi, st.reward.max())
    torch.cuda.synchronize()
    el = time.time() - t0
    n_a, n_c, n_d, n_b, n_e = (fn.launches for fn in counted)
    a_per, b_per = per_auto
    check(n_a == a_per * n_steps and n_b == b_per * n_steps,
          f"chol_solve {n_a} = {a_per} x {n_steps} and newton_qp {n_b} = {b_per} x {n_steps} "
          "launches over the step_autoresets")
    check(n_c == 0 and n_d == 0 and n_e == 0,
          f"cho_factor_solve, solve_lower and cholesky not launched ({n_c}, {n_d}, {n_e})")
    if getup:
        check(suppressed_ok, "no env terminated while its recovery counter was > 0")
    fin = all(bool(torch.isfinite(x).all()) for x in (
        st.phys.qpos, st.phys.qvel, st.obs, st.reward, *st.pd_cache))
    check(fin, "state finite")
    check(st.obs.shape == (B_MAIN, env_.obs_size), f"obs shape {tuple(st.obs.shape)}")
    out.update(state=st, rate=B_MAIN * n_steps / el, overflow=(ov / n_steps).item(),
               stalled=(stl / n_steps).item(), nactive_max=int(nact), chol_solve=n_a, newton_qp=n_b,
               per_step={"chol_solve": n_a / n_steps, "newton_qp": n_b / n_steps},
               reward_min=float(r_lo), reward_max=float(r_hi))
    return out


def same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(a, b))


def trainer_and_planner(model, dev, counted, card: str, run_cfg, ucfg, ccfg) -> dict:
    """Phases 18 and 19: the PPO trainer (AgentHumanoid with run_cfg), the
    update card vs CPU in float64 (ucfg), and the CEM planner (ccfg) on
    HumanoidGetup; every launch count set to 0 just before each counted
    run and read just after. Returns the launch counts and times."""
    from smplsim_tpu_torch.agents import AgentHumanoid
    from smplsim_tpu_torch.control import CEMPlanner
    from smplsim_tpu_torch.envs import GetupConfig, HumanoidGetup
    from smplsim_tpu_torch.learning.ppo import state_tensors
    from smplsim_tpu_torch.learning.running_norm import normalize
    from smplsim_tpu_torch.ops import qp

    # ------------------------------------------------ 18. the PPO trainer
    print("phase 18: PPO trainer at full width (PPOConfig(), the default QP)", flush=True)
    tmp = tempfile.TemporaryDirectory()
    run_cfg = dataclasses.replace(run_cfg, output_dir=tmp.name)
    pcfg = run_cfg.learning
    cfi = run_cfg.env.control_frequency_inv
    sync = lambda: torch.cuda.synchronize() if dev.type == "cuda" else None
    agent = AgentHumanoid(run_cfg, device=dev)
    print(f"  {pcfg.num_envs} envs x horizon {pcfg.horizon}, nets {pcfg.policy_widths} "
          f"{pcfg.activation}, {pcfg.opt_num_epochs} epochs x {pcfg.num_minibatches} "
          f"minibatches; compact rows K = {agent.env._qp_rows}", flush=True)
    agent.state = agent.ppo.init(run_cfg.seed)
    trained = lambda st: [(f"{k} {n}", p) for k, net in (("policy", st.policy), ("value", st.value))
                          for n, p in net.named_parameters() if n != "log_std"]
    w_init = [(n, p.detach().clone()) for n, p in trained(agent.state)]
    for fn in counted:
        fn.launches = 0
    ts = agent.optimize_policy(2)
    ppo_l = [fn.launches for fn in counted]
    per_iter = pcfg.horizon
    check(ppo_l[0] == 2 * 2 * cfi * per_iter and ppo_l[3] == 2 * cfi * per_iter
          and ppo_l[1] == ppo_l[2] == ppo_l[4] == 0,
          f"2 PPO iterations launched chol_solve {ppo_l[0]} = 2 x {2 * cfi * per_iter}, "
          f"newton_qp {ppo_l[3]} = 2 x {cfi * per_iter}, and no C, D or E ({ppo_l[1]}, "
          f"{ppo_l[2]}, {ppo_l[4]})")
    w_after = trained(ts)
    check(all(bool(torch.isfinite(p).all()) for _, p in w_after), "parameters finite")
    unchanged = [n for (n, a), (_, b) in zip(w_init, w_after) if torch.equal(a, b)]
    check(not unchanged, f"every weight and bias tensor of both nets changed ({len(w_after)}; "
                         f"unchanged: {unchanged})")
    log_lines = [json.loads(x) for x in open(os.path.join(agent.out_dir, "log.txt"))]
    keys = {"epoch", "T_step", "steps_per_sec", "reward_mean", "episode_done_frac", "value_mean",
            "efc_overflow_frac", "qp_stalled_frac", "nactive_max"}
    check([r["epoch"] for r in log_lines] == [1, 2] and all(set(r) == keys for r in log_lines)
          and all(math.isfinite(v) for r in log_lines for v in r.values()),
          "log.txt: two lines of the nine keys, finite")
    for r, s in zip(log_lines, agent.epoch_seconds):
        print(f"  epoch {r['epoch']}: T_step {r['T_step']} s, {r['steps_per_sec']} env-steps/s; "
              f"rollout {s['rollout']:.3f} s, update {s['update']:.3f} s; reward_mean "
              f"{r['reward_mean']:.5f}, overflow {r['efc_overflow_frac']:.5f}, stalled "
              f"{r['qp_stalled_frac']:.5f}, nactive_max {r['nactive_max']:.0f}", flush=True)
    ppo_sec = agent.epoch_seconds[-1]
    # a new agent loads the last checkpoint bit for bit; one more epoch from
    # it and from the trainer that saved it agree bit for bit
    agent2 = AgentHumanoid(dataclasses.replace(run_cfg, epoch=-1), device=dev)
    ts2 = agent2.load_checkpoint(-1)
    check(ts2.epoch == 2 and same_bits(state_tensors(ts), state_tensors(ts2)),
          "the epoch-2 checkpoint loads into a new agent bit for bit")
    agent2.state = ts2
    ts3b = agent2.optimize_policy(1)
    ts3 = agent.optimize_policy(1)
    check(ts3b.epoch == 3 and same_bits(state_tensors(ts3), state_tensors(ts3b)),
          "one more epoch from the loaded checkpoint reproduces the trainer's bit for bit")
    for fn in counted:
        fn.launches = 0
    ev = agent.run_policy(n_episodes=4, horizon=8)
    eval_l = [fn.launches for fn in counted]
    check(math.isfinite(ev["eval_return_mean"]) and eval_l[0] == 8 * 2 * cfi
          and eval_l[3] == 8 * cfi and eval_l[1] == eval_l[2] == eval_l[4] == 0,
          f"run_policy(4 episodes, 8 steps): return {ev['eval_return_mean']:.4f} finite, "
          f"chol_solve {eval_l[0]} and newton_qp {eval_l[3]} launches (30 + 15 per step)")
    # Kernels A and B against their plain versions on the trainer's own
    # systems: a real substep of its env states after the third epoch's
    # rollout, under the policy's mean action, at the trainer's QP
    est = agent.state.env_states
    with torch.no_grad():
        mu, _ = agent.state.policy(normalize(agent.state.obs_norm, est.obs, pcfg.obs_clip))
    t_inputs = substep_inputs(agent.model, est, mu.clamp(-1.0, 1.0), agent.env._qp_rows)
    t_report = hold_a_b("trainer ", t_inputs, qp.NEWTON_ITERS, qp.tol_for(torch.float32))
    t_report["full_rows"] = t_inputs["full_rows"]
    tmp.cleanup()
    # the update, card vs CPU in float64, on one numpy-made trajectory
    upd_err = update_card_vs_cpu(ucfg, 0, 1, None, (dev, torch.device("cpu")))
    check(upd_err <= 1e-9, f"PPO update card vs CPU in float64 (widths {ucfg.policy_widths}, "
                           f"{ucfg.opt_num_epochs} x {ucfg.num_minibatches} minibatch steps): "
                           f"parameters, Adam moments and running norm within {upd_err:.3e} "
                           f"<= 1e-9 relative")

    # ------------------------------------------------------ 19. CEM planning
    print("phase 19: CEM planner on HumanoidGetup (CEMConfig(), the default QP)", flush=True)
    cenv = HumanoidGetup(model, GetupConfig(control_frequency_inv=cfi))
    planner = CEMPlanner(cenv, ccfg)
    env_gen = torch.Generator(device=dev).manual_seed(3)
    sample_gen = torch.Generator(device=dev).manual_seed(4)
    cstate = cenv.reset(1, env_gen)
    gen_before = env_gen.get_state().clone()
    for fn in counted:
        fn.launches = 0
    sync()
    t0 = time.time()
    a0, cmean, best = planner.plan(cstate, generator=sample_gen)
    sync()
    plan_s = time.time() - t0
    cem_l = [fn.launches for fn in counted]
    n_cs = ccfg.iterations * ccfg.horizon
    check(cem_l[0] == 2 * cfi * n_cs and cem_l[3] == cfi * n_cs
          and cem_l[1] == cem_l[2] == cem_l[4] == 0,
          f"one plan launched chol_solve {cem_l[0]} = 30 x {n_cs}, newton_qp {cem_l[3]} = "
          f"15 x {n_cs} (batch {ccfg.num_samples}), and no C, D or E")
    zero_cost = planner._rollout_cost(cstate, torch.zeros(1, ccfg.horizon, cenv.action_size,
                                                          device=dev))
    check(bool(torch.isfinite(cmean).all()) and float(best) <= float(zero_cost[0]) + 1e-6,
          f"best cost {float(best):.5f} <= the zero-action rollout's {float(zero_cost[0]):.5f}")
    check(torch.equal(env_gen.get_state(), gen_before), "the plan left the env's generator as "
                                                        "it was")
    print(f"  {plan_s:.3f} s per plan ({ccfg.num_samples} samples x horizon {ccfg.horizon} x "
          f"{ccfg.iterations} iterations, from a Fall reset) on {card}", flush=True)
    t0 = time.time()
    cfinal, crews, ccosts = planner.receding_horizon(cstate, 2, sample_gen)
    sync()
    rh_s = time.time() - t0
    check(bool(torch.isfinite(crews).all() & torch.isfinite(ccosts).all())
          and int(cfinal.cur_t[0]) == int(cstate.cur_t[0]) + 2,
          f"receding_horizon(2): rewards {crews.tolist()}, costs {ccosts.tolist()} finite, "
          f"{rh_s:.3f} s")

    return dict(ppo_l=ppo_l, eval_l=eval_l, cem_l=cem_l, ppo_sec=ppo_sec, plan_s=plan_s,
                report=t_report)


def time_chol(linalg, A, b, d) -> dict:
    """Kernel A (the wrapper) on (A, b, d) against its plain version:
    max|kernel - plain| and its relative form, times of kernel, plain
    version and the library call (cholesky + cholesky_solve), and the
    bound, in A's dtype."""
    xk = linalg.chol_solve(A, b, d)
    xp = linalg.chol_solve_plain(A, b, d)
    H = A if d is None else A + torch.diag_embed(d)

    def library():
        return torch.cholesky_solve(b, torch.linalg.cholesky(H))
    Bn, n, m = b.shape
    nbytes = A.element_size() * Bn * (n * (n + 1) / 2 + 2 * n * m + (n if d is not None else 0))
    bms, by = bound_ms(nbytes, Bn * (n ** 3 / 3 + 2 * n * n * m), A.dtype)
    return dict(max_abs_err=(xk - xp).abs().amax().item(), max_rel_err=rel_diff(xk, xp),
                ms=cuda_ms(lambda: linalg.chol_solve(A, b, d), 10),
                plain_ms=cuda_ms(lambda: linalg.chol_solve_plain(A, b, d), 2),
                library_ms=cuda_ms(library, 5), bound_ms=bms, bound_by=by,
                route=linalg.chol_solve_route(n, m, A.element_size()),
                chunk=linalg.chol_solve_tiled_layout(n, m, A.element_size(), "thread")[1])


def held_inputs(tag: str, inputs: dict, state) -> dict:
    """substep_inputs restricted to the systems of envs that are not wild.
    Under full-scale random actions a few envs are flung far away at |qvel|
    of 1e6 (ROADMAP §3): their float32 M may not be SPD (there the plain
    factor and Kernel A must both give non-finite values: checked), and
    their QPs are too ill-conditioned in float32 for two solvers to agree
    to 1e-4. Those with |qvel| > WILD_QVEL or a non-SPD system are left
    out, and counted."""
    from smplsim_tpu_torch.ops import linalg

    tame = state.phys.qvel.abs().amax(1) <= WILD_QVEL
    ok = tame
    for A, b, d in inputs["chol"].values():
        A64, b64 = A.double(), b.double()
        d64 = None if d is None else d.double()
        fin_p = torch.isfinite(linalg.chol_solve_plain(A64, b64, d64)).flatten(1).all(1)
        fin_k = torch.isfinite(linalg.chol_solve(A64, b64, d64)).flatten(1).all(1)
        check(torch.equal(fin_p, fin_k), f"{tag}chol_solve float64: the kernel's non-finite "
                                         f"systems are the plain version's ({int((~fin_p).sum())})")
        ok = ok & fin_p
    print(f"  {tag}systems held: {int(ok.sum())} of {ok.numel()} ({int((~tame).sum())} envs "
          f"with |qvel| > {WILD_QVEL:g}, {int((tame & ~ok).sum())} more with a system not SPD)",
          flush=True)
    sub = lambda t: None if t is None else t[ok].contiguous()
    return dict(chol={k: tuple(sub(t) for t in v) for k, v in inputs["chol"].items()},
                qp=tuple(sub(t) for t in inputs["qp"]), full_rows=inputs["full_rows"],
                held=int(ok.sum()))


def advanced(env, action, gen, steps: int = 3):
    """B_MAIN env states after `steps` step_autoresets from a reset."""
    st = env.reset(B_MAIN, gen)
    for _ in range(steps):
        st = env.step_autoreset(st, action(B_MAIN))
    return st


def body_paths(dev, counted, card: str, speed_rate: float, gen) -> dict:
    """Phases 20 and 21: the β-heterogeneous batch and the SMPLX humanoid,
    built from the synthetic bodies of tests/_torch_synthetic_body.py (the
    licensed SMPL files are not in the repository), as bench.py's
    BENCH_BETA_HET and BENCH_MODEL=smplx paths build them."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from _torch_synthetic_body import make_synthetic_body

    from smplsim_tpu_torch import native
    from smplsim_tpu_torch.body_model import SMPLParser
    from smplsim_tpu_torch.envs import HumanoidSpeed
    from smplsim_tpu_torch.models import stack_models, tile_model
    from smplsim_tpu_torch.models.builder import RobotConfig, build_robot_model
    from smplsim_tpu_torch.ops import linalg
    from smplsim_tpu_torch.physics import constraints, engine, solver

    out = {}
    # ------------------------------------------------------- 20. the β batch
    print("phase 20: a β-heterogeneous HumanoidSpeed batch (64 bodies over 4096 envs)", flush=True)
    check(native.available(), "the native asset-prep library builds with g++ (the JAX package's "
                              "hull volumes, not scipy's)")
    parser = SMPLParser(data=make_synthetic_body(np.random.RandomState(0), "smpl"))
    rng = np.random.RandomState(11)
    t0 = time.time()
    bodies = [build_robot_model(parser, betas=rng.randn(1, 10) * 0.8, cfg=RobotConfig(),
                                dtype=torch.float32, device=dev)[0] for _ in range(N_BETAS)]
    build_s = time.time() - t0
    stacked = stack_models(bodies)
    mass = stacked.body_mass.sum(1)
    check(float(mass.std()) > 1e-2, f"the {N_BETAS} bodies differ: total mass "
                                    f"{float(mass.min()):.3f}-{float(mass.max()):.3f} kg")
    model = tile_model(stacked, B_MAIN)
    env = HumanoidSpeed(model, **QP)
    act = lambda n: torch.rand(n, model.nu, generator=gen, device=dev) * 2.0 - 1.0
    b_run = env_run(env, BETA_STEPS, (2 * CFI, CFI), counted, act, gen)
    print(f"  {N_BETAS} bodies built in {build_s:.3f} s ({build_s / N_BETAS * 1e3:.1f} ms each, "
          f"host); {BETA_STEPS} control steps x {B_MAIN} envs: {b_run['rate']:.1f} env-steps/s "
          f"beside the shared model's {speed_rate:.1f} in this call ({b_run['rate'] / speed_rate:.3f}x);"
          f" overflow {b_run['overflow']:.5f}, stalled {b_run['stalled']:.5f}, nactive_max "
          f"{b_run['nactive_max']}; on {card}", flush=True)
    # card vs CPU on 8 envs (bodies 0-7) from a reset, half-scale actions
    m8 = tile_model(stacked, 8)
    m8_cpu = m8.to(device="cpu")
    st_g = HumanoidSpeed(m8, **QP).reset(8, gen).phys
    st_c = engine.PhysicsState(st_g.qpos.cpu(), st_g.qvel.cpu())
    cache_g = engine.pd_cache(m8, st_g) + (torch.zeros(8, constraints.NEFC, device=dev),)
    cache_c = tuple(x.cpu() for x in cache_g)
    for _ in range(3):
        a = 0.5 * act(8)
        st_g, _, _, cache_g = engine.control_step(m8, st_g, a, 3, cache_g, **QP)
        st_c, _, _, cache_c = engine.control_step(m8_cpu, st_c, a.cpu(), 3, cache_c, **QP)
    diff = ((st_g.qpos.cpu() - st_c.qpos).abs() / (1.0 + st_c.qpos.abs())).amax().item()
    check(diff <= 5e-3, f"β batch card vs CPU, 8 bodies, 3 control steps of 3 substeps: qpos "
                        f"{diff:.3e} <= 5e-3")
    # A and B on a real substep after 3 control steps from a reset, as phase
    # 2 takes them, on the envs that are not wild (held_inputs)
    print("phase 20: kernels A and B against their plain versions (β batch inputs)", flush=True)
    b_state = advanced(env, act, gen)
    b_inputs = held_inputs("beta ", substep_inputs(model, b_state, act(B_MAIN)), b_state)
    # the float32 QP objectives are held where both solvers meet the
    # tolerance, as in phase 21: the systems that stop at the iteration cap
    # (a third of the β systems fill all K = 32 rows) part by more than
    # rounding; objective_where_converged shows each one left out is capped
    out["beta"] = hold_a_b("beta ", b_inputs, converged_only=True)
    out["beta"].update(full_rows=b_inputs["full_rows"], systems=b_inputs["held"])
    out.update(b_run=b_run, build_s=build_s)

    # -------------------------------------------------- 21. the SMPLX humanoid
    print("phase 21: the SMPLX humanoid (52 bodies, nv = 159)", flush=True)
    xparser = SMPLParser(data=make_synthetic_body(np.random.default_rng(1), "smplx"),
                         model_type="smplx")
    t0 = time.time()
    xmodel = build_robot_model(xparser, cfg=RobotConfig(model="smplx"), dtype=torch.float32,
                               device=dev)[0]
    xbuild_s = time.time() - t0
    check(xmodel.nbody == 52 and xmodel.nv == 159 and xmodel.nu == 153,
          f"SMPLX humanoid: {xmodel.nbody} bodies, nv {xmodel.nv}, built in {xbuild_s:.3f} s")
    xenv = HumanoidSpeed(xmodel, **QP)
    xact = lambda n: torch.rand(n, xmodel.nu, generator=gen, device=dev) * 2.0 - 1.0
    x_run = env_run(xenv, SMPLX_STEPS, (2 * CFI, CFI), counted, xact, gen)
    print(f"  {SMPLX_STEPS} control steps x {B_MAIN} envs: {x_run['rate']:.1f} env-steps/s "
          f"({x_run['rate'] / speed_rate:.3f}x the 24-body speed path in this call); overflow "
          f"{x_run['overflow']:.5f}, stalled {x_run['stalled']:.5f}, nactive_max "
          f"{x_run['nactive_max']}; on {card}", flush=True)
    x_state = advanced(xenv, xact, gen)
    x_inputs = held_inputs("smplx ", substep_inputs(xmodel, x_state, xact(B_MAIN)), x_state)
    # the float32 QP objectives are held where both solvers meet the
    # tolerance: every SMPLX system fills all K = 32 rows (its overflow share
    # is 1) and many stop at the iteration cap, where the two solvers' float32
    # iterates part by more than rounding; objective_where_converged shows
    # each one left out is capped
    out["smplx"] = hold_a_b("smplx ", x_inputs, converged_only=True)
    out["smplx"].update(full_rows=x_inputs["full_rows"], systems=x_inputs["held"])

    # one float64 control step at the package's default QP (K = 64): the
    # stable-PD solve at m = 1 + diag and the smooth + Delassus solve at
    # m = 65, which takes Kernel A's chunked form at n = 159
    x64 = xmodel.to(torch.float64)
    x64_cpu = x64.to(device="cpu")
    env64 = HumanoidSpeed(x64)
    s64 = env64.reset(X64_ENVS, gen)
    check(linalg.chol_solve_route(159, 65, 8) == "thread"
          and linalg.chol_solve_tiled_layout(159, 65, 8, "thread")[1] == 64,
          "float64 n=159 m=65 takes Kernel A's thread form in 2 chunks of 64 columns")
    a64 = 0.1 * xact(X64_ENVS).double()
    for fn in counted:
        fn.launches = 0
    st_g, _, _, c_g = engine.control_step(x64, s64.phys, a64, CFI, s64.pd_cache)
    torch.cuda.synchronize()
    x64_l = [fn.launches for fn in counted]
    check(x64_l[0] == 2 * CFI and x64_l[3] == CFI and sum(x64_l) == 3 * CFI,
          f"the float64 step launched chol_solve {x64_l[0]} = 30 and newton_qp {x64_l[3]} = 15")
    st_c, _, _, c_c = engine.control_step(
        x64_cpu, engine.PhysicsState(s64.phys.qpos.cpu(), s64.phys.qvel.cpu()), a64.cpu(), CFI,
        tuple(x.cpu() for x in s64.pd_cache))
    rel = lambda g_, c_: ((g_.cpu() - c_).abs() / (1.0 + c_.abs())).amax().item()
    d64 = max(rel(st_g.qpos, st_c.qpos), rel(st_g.qvel, st_c.qvel), rel(c_g[2], c_c[2]))
    check(d64 <= 1e-9, f"SMPLX float64 control step at the default QP, {X64_ENVS} envs, card vs "
                       f"CPU: qpos, qvel and contact forces within {d64:.3e} <= 1e-9")
    x64_inputs = substep_inputs(x64, dataclasses.replace(s64, pd_cache=c_g, phys=st_g),
                                0.1 * xact(X64_ENVS).double(), qp_rows=solver.COMPACT_ROWS)
    A65, b65, _ = x64_inputs["chol"]["m=65"]
    out["smplx_f64_m65"] = time_chol(linalg, A65.contiguous(), b65.contiguous(), None)
    r = out["smplx_f64_m65"]
    check(r["max_rel_err"] <= 1e-9, f"chol_solve float64 n=159 m=65 ({r['route']} form, chunks "
                                    f"of {r['chunk']}) vs plain: {r['max_rel_err']:.3e} <= 1e-9")
    print(f"  chol_solve float64 n=159 m=65 on {X64_ENVS} systems: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']})", flush=True)
    out.update(x_run=x_run, xbuild_s=xbuild_s, x64_launches=x64_l)
    return out


def device_ops(fn) -> tuple[float, float]:
    """Device busy ms and device ops (kernels, copies, sets) of one fn() call
    under torch.profiler, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    return sum(us(e) for e in ev) / 1e3, sum(e.count for e in ev)


def cpu_copy(state):
    """An EnvState's tensors on the CPU, a fresh CPU generator in its rng."""
    from smplsim_tpu_torch.envs.base import map_state

    return map_state(lambda t: t.cpu() if isinstance(t, torch.Tensor) else torch.Generator(), state)


def slice7_paths(model, dev, counted, card: str, speed_rate: float, gen) -> dict:
    """Phases 22-25: the articulated-body route beside the dense one,
    NvHumanoid through GymVectEnv, DomainRandEnv over HumanoidSpeed and
    HumanoidMove, each counted run with every launch count set to 0 just
    before it and read just after."""
    from smplsim_tpu_torch.envs import (DomainRandConfig, DomainRandEnv, GymVectEnv,
                                        HumanoidMove, HumanoidSpeed, NoiseSpec, NvConfig,
                                        NvHumanoid)
    from smplsim_tpu_torch.envs.nv import obs_max_v2_size
    from smplsim_tpu_torch.ops import linalg
    from smplsim_tpu_torch.physics import control, dynamics, engine, kinematics, substep

    out, report = {}, {}
    cpu_model = model.to(device="cpu")
    rel = lambda g_, c_: ((g_.cpu() - c_).abs() / (1.0 + c_.abs())).amax().item()

    def card_vs_cpu(tag, m_g, st_g, cache_g, steps, act):
        """`steps` control steps of CFI substeps on the card and on the CPU
        from the same state under the same actions: qpos within 5e-3."""
        m_c = m_g.to(device="cpu")
        st_c = engine.PhysicsState(st_g.qpos.cpu(), st_g.qvel.cpu())
        cache_c = tuple(x.cpu() for x in cache_g)
        for _ in range(steps):
            a = act()
            st_g, _, _, cache_g = engine.control_step(m_g, st_g, a, CFI, cache_g, **QP)
            st_c, _, _, cache_c = engine.control_step(m_c, st_c, a.cpu(), CFI, cache_c, **QP)
        d = rel(st_g.qpos, st_c.qpos)
        check(d <= 5e-3, f"{tag} card vs CPU, {st_c.qpos.shape[0]} envs, {steps} control steps: "
                         f"qpos {d:.3e} <= 5e-3")
        return d

    # ------------------------------------------------- 22. the ABA route
    print("phase 22: the articulated-body route (SMPLSIM_ABA=1) beside the dense route", flush=True)
    env = HumanoidSpeed(model, **QP)
    runs = {}
    try:
        for route, flag, per in (("dense", "0", (2 * CFI, CFI)), ("aba", "1", (1, CFI))):
            os.environ["SMPLSIM_ABA"] = flag
            g22 = torch.Generator(device=dev).manual_seed(22)
            act22 = lambda n, g_=g22: torch.rand(n, model.nu, generator=g_, device=dev) * 2.0 - 1.0
            runs[route] = env_run(env, STEPS, per, counted, act22, g22)
        r_d, r_a = runs["dense"], runs["aba"]
        print(f"  {STEPS} control steps x {B_MAIN} envs, same draw: ABA route {r_a['rate']:.1f} "
              f"env-steps/s, dense route {r_d['rate']:.1f} ({r_a['rate'] / r_d['rate']:.3f}x); "
              f"overflow {r_a['overflow']:.5f} / {r_d['overflow']:.5f}, stalled "
              f"{r_a['stalled']:.5f} / {r_d['stalled']:.5f}; launches per control step "
              f"{r_a['per_step']} / {r_d['per_step']}; phase 3 {speed_rate:.1f}; on {card}",
              flush=True)
        out["aba_cmp"] = card_vs_cpu(
            "ABA route", model, *(lambda f: (f.phys, f.pd_cache))(env.reset(16, gen)), 2,
            lambda: 0.5 * (torch.rand(16, model.nu, generator=gen, device=dev) * 2.0 - 1.0))
        # the elimination against Kernel A on a real substep's systems
        g22 = torch.Generator(device=dev).manual_seed(23)
        act22 = lambda n: torch.rand(n, model.nu, generator=g22, device=dev) * 2.0 - 1.0
        st = advanced(env, act22, g22)
    finally:
        os.environ.pop("SMPLSIM_ABA")
    q, v = st.phys.qpos, st.phys.qvel
    kin = kinematics.fk(model, q)
    M = dynamics.mass_matrix(model, kin)
    a_now = act22(B_MAIN)
    rhs1, d1, _ = control.stable_pd_system(model, st.pd_cache[1], q, v,
                                           control.pd_target_from_action(model, a_now))
    rhs33 = substep_inputs(model, st, a_now)["chol"]["m=33"][1]
    solve = substep.aba_solver(model, kin)
    held = (v.abs().amax(1) <= WILD_QVEL) & torch.isfinite(
        linalg.chol_solve_plain(M.double(), rhs1.double(), d1.double())).flatten(1).all(1)
    print(f"  systems held: {int(held.sum())} of {B_MAIN} (|qvel| <= {WILD_QVEL:g}, M + diag SPD "
          "in float64)", flush=True)
    report["aba"] = {}
    for name, rhs, d in (("m=1,diag", rhs1, d1), ("m=33", rhs33, None)):
        H = M if d is None else M + torch.diag_embed(d)
        xe, xa = solve(rhs, d), linalg.chol_solve(M, rhs, d)
        res_e = rel_residual(H[held], xe[held], rhs[held])
        res_a = rel_residual(H[held], xa[held], rhs[held])
        check(bool(torch.isfinite(xe[held]).all()) and res_e <= ABA_RESIDUAL,
              f"ABA mass_solve[{name}] float32: relative residual against M + diag {res_e:.3e} "
              f"<= {ABA_RESIDUAL:g} (Kernel A on the same systems {res_a:.3e})")
        ms_e = cuda_ms(lambda: solve(rhs, d), 10)
        ms_a = cuda_ms(lambda: linalg.chol_solve(M, rhs, d), 20)
        busy_e, ops_e = device_ops(lambda: solve(rhs, d))
        report["aba"][name] = dict(residual=res_e, residual_A=res_a, ms=ms_e, A_ms=ms_a,
                                   device_busy_ms=busy_e, device_ops=ops_e,
                                   residual_bound=ABA_RESIDUAL)
        print(f"  ABA mass_solve[{name}]: {ms_e:.4f} ms by events ({busy_e:.4f} ms device busy, "
              f"{ops_e:.0f} device ops per solve) beside Kernel A's {ms_a:.4f} ms (one launch)",
              flush=True)
    out.update(aba=r_a, aba_dense=r_d)

    # ---------------------------------- 23. NvHumanoid through GymVectEnv
    print("phase 23: NvHumanoid (obs v2, freeze_hand, impulses, 2 projectiles) through "
          "GymVectEnv", flush=True)
    ncfg = NvConfig(obs_v=2, past_track_steps=5, freeze_hand=True, perturb_interval=4,
                    num_projectiles=2, proj_interval=8)
    nenv = NvHumanoid(model, ncfg, **QP)
    venv = GymVectEnv(nenv, B_MAIN, seed=23)
    rng = np.random.RandomState(23)
    acts = [rng.uniform(-1.0, 1.0, (B_MAIN, model.nu)).astype(np.float32) for _ in range(STEPS)]
    obs, _ = venv.reset()
    for fn in counted:
        fn.launches = 0
    t0 = time.time()
    term = ov = stl = 0.0
    finite, finals = True, 0
    for a in acts:
        obs, rew, te, tr, info = venv.step(a)
        term += te.mean()
        ov += info["overflow"].mean()
        stl += info["stalled"].mean()
        finite &= bool(np.isfinite(obs).all() and np.isfinite(rew).all())
        finals += "final_observation" in info
    el = time.time() - t0
    n_l = [fn.launches for fn in counted]
    check(n_l[0] == 2 * CFI * STEPS and n_l[3] == CFI * STEPS and sum(n_l) == 3 * CFI * STEPS,
          f"NvHumanoid: chol_solve {n_l[0]} = 30 x {STEPS} and newton_qp {n_l[3]} = 15 x {STEPS}")
    width = obs_max_v2_size(model.nbody, 6)
    check(finite and obs.shape == (B_MAIN, width) == (B_MAIN, nenv.obs_size),
          f"NvHumanoid obs finite, of width obs_max_v2_size(24, 6) = {width}")
    nrate = B_MAIN * STEPS / el
    print(f"  {STEPS} steps x {B_MAIN} envs through the facade (numpy actions in, clipped obs "
          f"and flags copied out): {nrate:.1f} env-steps/s; termination share "
          f"{term / STEPS:.5f}, steps with final_observation {finals}, overflow {ov / STEPS:.5f}, "
          f"stalled {stl / STEPS:.5f}; on {card}", flush=True)
    out["nv"] = dict(rate=nrate, chol_solve=n_l[0], newton_qp=n_l[3], termination=term / STEPS,
                     overflow=ov / STEPS, stalled=stl / STEPS,
                     per_step={"chol_solve": n_l[0] / STEPS, "newton_qp": n_l[3] / STEPS})
    # card vs CPU: 16 envs, 2 control steps, the impulse and throw draws
    # made on the card and fed to both
    env_g, env_c = NvHumanoid(model, ncfg, **QP), NvHumanoid(cpu_model, ncfg, **QP)
    s_g = env_g.reset(16, gen)
    s_c = cpu_copy(s_g)
    for _ in range(2):
        imp = NvHumanoid._impulse_draws(env_g, 16, gen)
        thr = NvHumanoid._throw_draws(env_g, 16, gen)
        env_g._impulse_draws, env_g._throw_draws = (lambda n, g_: imp), (lambda n, g_: thr)
        imp_c, thr_c = tuple(x.cpu() for x in imp), tuple(x.cpu() for x in thr)
        env_c._impulse_draws, env_c._throw_draws = (lambda n, g_: imp_c), (lambda n, g_: thr_c)
        a = 0.5 * (torch.rand(16, model.nu, generator=gen, device=dev) * 2.0 - 1.0)
        s_g, s_c = env_g.step(s_g, a), env_c.step(s_c, a.cpu())
    d = max(rel(s_g.phys.qpos, s_c.phys.qpos), rel(s_g.proj[0], s_c.proj[0]))
    check(d <= 5e-3, f"NvHumanoid card vs CPU, 16 envs, 2 control steps with impulses and "
                     f"throws: qpos and sphere positions {d:.3e} <= 5e-3")
    out["nv"]["cmp"] = d

    # ------------------------------------ 24. DomainRandEnv over HumanoidSpeed
    print("phase 24: DomainRandEnv over HumanoidSpeed (every field, both noises)", flush=True)
    scl = lambda lo, hi: NoiseSpec("uniform", "scaling", (lo, hi))
    gauss = NoiseSpec("gaussian", "additive", (0.0, 0.01))
    drcfg = DomainRandConfig(frequency=1, observations=gauss, actions=gauss,
                             body_mass=scl(0.8, 1.2), friction=scl(0.5, 1.5),
                             dof_damping=scl(0.5, 1.5), armature=scl(0.5, 2.0),
                             pd_gains=scl(0.8, 1.2), gravity=scl(0.95, 1.05))
    denv = DomainRandEnv(HumanoidSpeed(model, **QP), drcfg)
    action = lambda n: torch.rand(n, model.nu, generator=gen, device=dev) * 2.0 - 1.0
    ds = denv.reset(B_MAIN, gen)
    check(float(ds.model.body_mass.sum(1).std()) > 1e-2 and float(ds.model.gravity[:, 2].std()) > 0,
          f"every env its own realization: total mass {float(ds.model.body_mass.sum(1).min()):.3f}-"
          f"{float(ds.model.body_mass.sum(1).max()):.3f} kg")
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    redraws = torch.zeros((), dtype=torch.int64, device=dev)
    ov = stl = 0.0
    for _ in range(STEPS):
        ds = denv.step_autoreset(ds, action(B_MAIN))
        redraws += ds.inner.done.sum()
        ov += ds.inner.info["overflow"].float().mean()
        stl += ds.inner.info["stalled"].float().mean()
    torch.cuda.synchronize()
    el = time.time() - t0
    n_l = [fn.launches for fn in counted]
    check(n_l[0] == 2 * CFI * STEPS and n_l[3] == CFI * STEPS and sum(n_l) == 3 * CFI * STEPS,
          f"DomainRandEnv: chol_solve {n_l[0]} = 30 x {STEPS} and newton_qp {n_l[3]} = 15 x "
          f"{STEPS}")
    check(all(bool(torch.isfinite(x).all()) for x in (
        ds.inner.phys.qpos, ds.inner.phys.qvel, ds.inner.obs, ds.inner.reward,
        *ds.inner.pd_cache)), "DomainRandEnv state finite")
    drate = B_MAIN * STEPS / el
    print(f"  {STEPS} step_autoresets x {B_MAIN} envs: {drate:.1f} env-steps/s "
          f"({drate / speed_rate:.3f}x phase 3's); realizations redrawn {int(redraws)} times "
          f"(frequency 1: every reset); overflow {(ov / STEPS).item():.5f}, stalled "
          f"{(stl / STEPS).item():.5f}; on {card}", flush=True)
    out["dr"] = dict(rate=drate, redraws=int(redraws), chol_solve=n_l[0], newton_qp=n_l[3],
                     overflow=(ov / STEPS).item(), stalled=(stl / STEPS).item(),
                     per_step={"chol_solve": n_l[0] / STEPS, "newton_qp": n_l[3] / STEPS})
    print("phase 24: kernels A and B against their plain versions (domain-randomized inputs)",
          flush=True)
    ds = denv.reset(B_MAIN, gen)
    for _ in range(3):
        ds = denv.step_autoreset(ds, action(B_MAIN))
    a_now = action(B_MAIN)
    d_inputs = held_inputs("dr ", substep_inputs(ds.model, ds.inner, a_now), ds.inner)
    report["dr"] = hold_a_b("dr ", d_inputs, converged_only=True)
    report["dr"].update(full_rows=d_inputs["full_rows"], systems=d_inputs["held"])
    d16 = denv.reset(16, gen)
    out["dr"]["cmp"] = card_vs_cpu(
        "DomainRandEnv realization", d16.model, d16.inner.phys, d16.inner.pd_cache, 2,
        lambda: 0.5 * (torch.rand(16, model.nu, generator=gen, device=dev) * 2.0 - 1.0))

    # ------------------------------------------------- 25. HumanoidMove
    print("phase 25: HumanoidMove (180 Hz physics, 6 substeps per control step)", flush=True)
    m180 = dataclasses.replace(model, timestep=torch.tensor(1.0 / 180.0, device=dev))
    menv = HumanoidMove(m180, **QP)
    mact = lambda n: torch.rand(n, model.nu, generator=gen, device=dev) * 2.0 - 1.0
    mv = env_run(menv, STEPS, (12, 6), counted, mact, gen)
    check(0.0 <= mv["reward_min"] and mv["reward_max"] <= 1.0,
          f"every reward in [0, 1] ({mv['reward_min']:.4f}-{mv['reward_max']:.4f})")
    print(f"  {STEPS} step_autoresets x {B_MAIN} envs: {mv['rate']:.1f} env-steps/s "
          f"({mv['rate'] / speed_rate:.3f}x phase 3's at 15 substeps); overflow "
          f"{mv['overflow']:.5f}, stalled {mv['stalled']:.5f}; on {card}", flush=True)
    out["move"] = mv
    out["report"] = report
    return out


def rel_gap(ref: torch.Tensor, val: torch.Tensor) -> float:
    """max |ref - val| / (1 + |ref|) over all entries, in float64 on the host."""
    ref, val = ref.detach().double().cpu(), val.detach().double().cpu()
    return ((ref - val).abs() / (1.0 + ref.abs())).max().item() if ref.numel() else 0.0


def quat_gap(ref: torch.Tensor, val: torch.Tensor) -> float:
    """rel_gap of quaternions taken as +-q (the sign nearer ref)."""
    ref, val = ref.detach().double().cpu(), val.detach().double().cpu()
    return rel_gap(ref, torch.where((ref * val).sum(-1, keepdim=True) < 0, -val, val))


def motion_paths(model, dev, counted, card: str) -> dict:
    """Phases 26-30: the motion library (load and sampling), playback with
    the tracking metrics, 2-D pose fitting and poselib, on the default
    humanoid in float32 at seed 0 (module doc)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from _torch_synthetic_motion import motion_set
    from smplsim_tpu_torch.envs import HumanoidPlayback, PlaybackState
    from smplsim_tpu_torch.eval import compute_metrics_lite
    from smplsim_tpu_torch.models import registry
    from smplsim_tpu_torch.motion import (CameraParams, HumanoidBatchFK, MotionLib,
                                          MotionLibConfig, PoseFitter)
    from smplsim_tpu_torch.motion import motion_lib
    from smplsim_tpu_torch.motion.motion_lib import TABLES
    from smplsim_tpu_torch.poselib import SkeletonState, SkeletonTree
    from smplsim_tpu_torch import transforms as T

    out = {}
    cpu_model = registry.default_humanoid(torch.float32, device="cpu")
    fk, fk_cpu = HumanoidBatchFK.from_robot_model(model), HumanoidBatchFK.from_robot_model(cpu_model)

    # ---------------------------------------------------- 26. library load
    print(f"phase 26: the motion library ({N_CLIPS} clips of 60-600 frames, 1 in 4 at 60 fps, "
          "the heading randomized)", flush=True)
    t0 = time.time()
    motions = motion_set(N_CLIPS)
    make_s = time.time() - t0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.time()
    lib = MotionLib(fk, MotionLibConfig(randomize_heading=True), motion_dict=motions)
    lib.load_motions(np.arange(N_CLIPS), rng=np.random.default_rng(0))
    torch.cuda.synchronize()
    load_s = time.time() - t0
    mem1 = torch.cuda.memory_allocated()
    frames = int(lib._motion_num_frames.sum())
    table_bytes = sum(getattr(lib, k).numel() * getattr(lib, k).element_size() for k in TABLES)
    print(f"  {N_CLIPS} clips, {frames} frames loaded in {load_s:.3f} s "
          f"({frames / load_s:.1f} frames/s; the clips made on the host in {make_s:.3f} s); "
          f"tables {table_bytes} bytes, memory_allocated {mem0} -> {mem1} "
          f"(+{mem1 - mem0} bytes) on {card}", flush=True)
    check(all(bool(torch.isfinite(getattr(lib, k).float()).all()) for k in TABLES),
          "every table finite")
    n16 = PLAYBACK_CMP_CLIPS
    sub = {k: motions[k] for k in list(motions)[:n16]}
    rows = int(lib.length_starts[n16])
    cpu_lib = MotionLib(fk_cpu, MotionLibConfig(randomize_heading=True), motion_dict=sub)
    cpu_lib.load_motions(np.arange(n16), rng=np.random.default_rng(0))
    gaps = {k: rel_gap(getattr(cpu_lib, k), getattr(lib, k)[:rows])
            for k in ("gts", "gvs", "gavs", "dvs", "qvel")}
    gaps["grs"] = quat_gap(cpu_lib.grs, lib.grs[:rows])
    print("  card vs CPU, first 16 clips: " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    check(max(gaps["gts"], gaps["grs"]) <= 5e-3,
          f"positions and rotations card vs CPU: {gaps['gts']:.3e}, {gaps['grs']:.3e} <= 5e-3")
    one = MotionLib(fk, MotionLibConfig(randomize_heading=True), motion_dict=sub)
    chunk, motion_lib._CHUNK = motion_lib._CHUNK, 1   # the per-clip load
    try:
        one.load_motions(np.arange(n16), rng=np.random.default_rng(0))
    finally:
        motion_lib._CHUNK = chunk
    per = max(rel_gap(getattr(one, k), getattr(lib, k)[:rows] if getattr(lib, k).shape[0] == frames
                      else getattr(lib, k)[:n16]) for k in TABLES)
    check(per <= 1e-6, f"the batched load equals a per-clip load of the first 16 clips on the "
                       f"card: {per:.3e} <= 1e-6 (every table)")
    out["load"] = dict(clips=N_CLIPS, frames=frames, seconds=load_s, table_bytes=table_bytes,
                       allocated_bytes=mem1 - mem0, card_vs_cpu=gaps, batched_vs_per_clip=per)

    # ------------------------------------------------------- 27. sampling
    print(f"phase 27: get_motion_state and get_motion_state_intervaled at B = {B_MAIN}",
          flush=True)
    ids = torch.as_tensor(lib.sample_motion_ids(np.random.default_rng(1), B_MAIN), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    times = lib.sample_time(g, ids)
    rates = {}
    for fn in ("get_motion_state", "get_motion_state_intervaled"):
        call = getattr(lib, fn)
        for _ in range(3):
            call(ids, times)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(SAMPLE_CALLS):
            st = call(ids, times)
        torch.cuda.synchronize()
        el = (time.time() - t0) / SAMPLE_CALLS
        rates[fn] = dict(seconds_per_call=el, states_per_s=B_MAIN / el)
        check(all(bool(torch.isfinite(v.float()).all()) for v in st.values()),
              f"{fn}: {el * 1e3:.3f} ms per call, {B_MAIN / el:.1f} states/s on {card}; finite")
        ids16 = ids % n16
        t16 = lib.sample_time(g, ids16)
        s_card, s_cpu = call(ids16, t16), getattr(cpu_lib, fn)(ids16.cpu(), t16.cpu())
        gap = max((quat_gap if k in ("root_rot", "rb_rot", "xquat") else rel_gap)(s_cpu[k], s_card[k])
                  for k in s_cpu)
        check(gap <= 5e-3, f"{fn} card vs CPU on clips 0-15: {gap:.3e} <= 5e-3")
        rates[fn]["card_vs_cpu"] = gap
    out["sampling"] = rates

    # ------------------------------------------------ 28. playback, metrics
    print(f"phase 28: HumanoidPlayback at {B_MAIN} envs, {PLAY_STEPS} step_autoresets, and "
          "compute_metrics_lite", flush=True)
    env = HumanoidPlayback(model, lib)
    st = env.reset(B_MAIN, torch.Generator(device=dev).manual_seed(0))
    # env i plays clip i (a reset plays clip (0 + 1) mod n)
    st.task = PlaybackState(motion_id=torch.arange(B_MAIN, dtype=torch.int32, device=dev) % N_CLIPS,
                            frame=torch.zeros(B_MAIN, dtype=torch.int32, device=dev))
    zero = torch.zeros(B_MAIN, model.nu, device=dev)
    for fn in counted:
        fn.launches = 0
    xpos, frame, done = [], [], torch.zeros(B_MAIN, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(PLAY_STEPS):
        st = env.step_autoreset(st, zero)
        xpos.append(st.kin.xpos)
        frame.append(st.task.frame)
        done |= st.done
    torch.cuda.synchronize()
    el = time.time() - t0
    launches = [fn.launches for fn in counted]
    play_rate = B_MAIN * PLAY_STEPS / el
    check(sum(launches) == 0, f"kernels A-E launched {launches} times over the playback "
                              f"(0 per step_autoreset); {play_rate:.1f} env-steps/s on {card}")
    check(bool(torch.isfinite(st.obs).all()) and bool((st.reward == 1).all()),
          "playback obs finite, reward 1")
    keep = ~done
    mids = torch.arange(B_MAIN, device=dev)[keep] % N_CLIPS
    pred = torch.stack(xpos, 1)[keep]                                   # (K,64,J,3)
    fl = lib.length_starts[mids][:, None].long() + torch.stack(frame, 1)[keep].long()
    gt = lib.gts[fl]
    m = compute_metrics_lite(pred, gt)
    mg = m["mpjpe_g"]
    first = (mids < n16)
    lim = {k: PLAYBACK_FK_GAP_MM[k] + FK_GAP_SLACK_MM for k in ("mean", "max")}
    print(f"  {int(keep.sum())} of {B_MAIN} envs played {PLAY_STEPS} frames without a reset; "
          f"physics FK vs the library, mpjpe_g mean {mg.mean().item():.4e} max "
          f"{mg.max().item():.4e} mm over all, mpjpe_pa mean {m['mpjpe_pa'].mean().item():.4e}, "
          f"vel_dist {m['vel_dist'].mean().item():.4e}, accel_dist "
          f"{m['accel_dist'].mean().item():.4e} mm, ttr {m['ttr'].float().mean().item():.4f}")
    check(bool(torch.isfinite(mg).all()) and int(first.sum()) >= n16 // 2,
          f"metrics finite; {int(first.sum())} of the first {n16} clips compared")
    f_mean, f_max = mg[first].mean().item(), mg[first].max().item()
    check(f_mean <= lim["mean"] and f_max <= lim["max"],
          f"clips 0-15: mpjpe_g mean {f_mean:.4e} <= {lim['mean']:.4e} and max {f_max:.4e} <= "
          f"{lim['max']:.4e} mm (the JAX package's float64 gap + {FK_GAP_SLACK_MM} mm)")
    out["playback"] = dict(rate=play_rate, launches=launches, envs_compared=int(keep.sum()),
                           mpjpe_g_mean=mg.mean().item(), mpjpe_g_max=mg.max().item(),
                           first16_mean=f_mean, first16_max=f_max,
                           per_step={n: 0.0 for n in ("chol_solve", "newton_qp")})

    # ----------------------------------------------------- 29. pose fitting
    print(f"phase 29: PoseFitter on a {FIT_FRAMES}-frame clip (tests/test_fitting.py's camera)",
          flush=True)
    cam = CameraParams(full_R=np.eye(3), full_t=np.array([0.0, -1.0, 3.0]),
                       K=np.array([[1000.0, 0, 960], [0, 1000.0, 540], [0, 0, 1.0]]))
    rng = np.random.default_rng(1)
    true = np.zeros((FIT_FRAMES, 1, 3 + 24 * 3))
    true[..., 2] = 0.95
    true[..., 3:] += rng.normal(size=(FIT_FRAMES, 1, 24 * 3)) * 0.1
    init = true + rng.normal(size=true.shape) * 0.05
    fitter = PoseFitter(HumanoidBatchFK.from_robot_model(model, filter_vel=False), cam)
    tv = torch.as_tensor(true, dtype=torch.float32, device=dev)
    fitter.set_targets(fitter.proj2d(fitter.fk_from_vec(tv)))
    iv = torch.as_tensor(init, dtype=torch.float32, device=dev)
    fitter.fit(iv, steps=2)                     # warm-up: the first backward's set-up
    torch.cuda.synchronize()
    t0 = time.time()
    vec, losses = fitter.fit(iv, steps=100, lr=0.01)
    torch.cuda.synchronize()
    fit100 = time.time() - t0
    ratio = (fitter.proj_2d_loss(vec) / fitter.proj_2d_loss(iv)).item()
    check(bool(torch.isfinite(losses).all()) and ratio < 0.2,
          f"fit(steps=100, lr=0.01) in {fit100:.3f} s on {card}: final / initial "
          f"proj_2d_loss {ratio:.4f} < 0.2")
    torch.cuda.synchronize()
    t0 = time.time()
    vec, losses = fitter.fit(iv)
    torch.cuda.synchronize()
    fit_def = time.time() - t0
    print(f"  fit() at its defaults (200 steps, lr 0.02): {fit_def:.3f} s, final / initial "
          f"{(losses[-1] / losses[0]).item():.4f}", flush=True)
    f64 = []
    for d in (dev, torch.device("cpu")):
        m64 = registry.default_humanoid(torch.float64, device=d)
        fitter = PoseFitter(HumanoidBatchFK.from_robot_model(m64, filter_vel=False), cam)
        tv = torch.as_tensor(true, device=d)
        fitter.set_targets(fitter.proj2d(fitter.fk_from_vec(tv)))
        f64.append(fitter.fit(torch.as_tensor(init, device=d), steps=5, lr=0.01))
    gap = max(rel_gap(f64[1][i], f64[0][i]) for i in range(2))
    check(gap <= 1e-9, f"float64 fit(steps=5): losses and vector card vs CPU {gap:.3e} <= 1e-9")
    out["fit"] = dict(seconds_100=fit100, ratio_100=ratio, seconds_default=fit_def,
                      card_vs_cpu_f64=gap)

    # ----------------------------------------------------------- 30. poselib
    print("phase 30: poselib on the first 16 clips of phase 26", flush=True)
    tree = SkeletonTree.from_robot_model(model)
    aa = lib._motion_aa[:rows].reshape(rows, 24, 3)
    local = T.exp_map_to_quat(aa)[:, list(fk.smpl_2_mujoco)]
    root = lib.gts[:rows, 0]
    s_loc = SkeletonState.from_rotation_and_root_translation(tree, local, root)
    s_glob = SkeletonState.from_rotation_and_root_translation(tree, lib.grs[:rows], root,
                                                              is_local=False)
    g_loc = (s_loc.global_translation - lib.gts[:rows]).abs().max().item()
    g_glob = (s_glob.global_translation - lib.gts[:rows]).abs().max().item()
    check(g_loc <= 1e-5, f"SkeletonState global_translation from the clips' local rotations vs "
                         f"HumanoidBatchFK's over {rows} frames: {g_loc:.3e} m <= 1e-5 m")
    # from the library's global rotations: two float32 chains (the library's
    # FK, then poselib's local conversion and FK), printed
    print(f"  from the library's global rotations (global -> local -> FK): {g_glob:.3e} m",
          flush=True)
    out["poselib"] = dict(frames=rows, from_local=g_loc, from_global=g_glob)
    return out


def tf32_readings(model, cpu_model, env, gen, action, engine, substep, constraints,
                  control) -> dict:
    """Phase 4b: phase 4's card-vs-CPU check (16 envs from a fresh reset, 2
    control steps at half-scale actions) with the process at TF32, through
    engine.control_step (pinned to full float32) and through the inner
    loop engine.control_step calls, substep.control_loop (not pinned); the
    pinned run again at "highest" beside them, and pinned once more with
    TF32 set through torch.backends.cuda.matmul.fp32_precision instead of
    the legacy call. Restores "highest"."""
    n = 16
    fresh = env.reset(n, gen)
    acts = [0.5 * action(n) for _ in range(2)]
    K = min(QP["qp_rows"], constraints.NEFC)

    def run(m, st, cache, pinned):
        for a in acts:
            a = a.to(st.qpos.device)
            if pinned:
                st, _, _, cache = engine.control_step(m, st, a, CFI, cache, **QP)
            else:
                out = substep.control_loop(
                    m, st.qpos, st.qvel, *cache, control.pd_target_from_action(m, a),
                    engine.reset_reference(m), CFI, QP["qp_iters"], K, QP["qp_tol"], None)
                st, cache = engine.PhysicsState(out[0], out[1]), out[2:5]
        return st.qpos.cpu()

    cpu_st = engine.PhysicsState(fresh.phys.qpos.cpu(), fresh.phys.qvel.cpu())
    q_cpu = run(cpu_model, cpu_st, tuple(x.cpu() for x in fresh.pd_cache), True)
    gap = lambda q: ((q - q_cpu).abs() / (1.0 + q_cpu.abs())).amax().item()
    try:
        q_hi = run(model, fresh.phys, fresh.pd_cache, True)
        torch.set_float32_matmul_precision("high")
        q_pin = run(model, fresh.phys, fresh.pd_cache, True)
        q_unpin = run(model, fresh.phys, fresh.pd_cache, False)
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        q_pin_new = run(model, fresh.phys, fresh.pd_cache, True)
    finally:
        torch.set_float32_matmul_precision("highest")
    return dict(pinned=gap(q_pin), unpinned=gap(q_unpin), pinned_new_api=gap(q_pin_new),
                pinned_vs_highest=(q_pin - q_hi).abs().max().item(),
                pinned_new_api_vs_highest=(q_pin_new - q_hi).abs().max().item())


def update_card_vs_cpu(ucfg, rank: int, world: int, group, devs) -> float:
    """Phase 18's float64 PPO.update on one numpy-made trajectory (the same
    nets and permutations on every device of devs), card vs CPU: the
    largest relative gap of the parameters, Adam moments and running norm.
    With a group, each of its ranks updates its own columns of the global
    trajectory with permutations drawn by RandomState(rank)."""
    from smplsim_tpu_torch.envs import HumanoidSpeed
    from smplsim_tpu_torch.learning.nets import gaussian_log_prob
    from smplsim_tpu_torch.learning.ppo import PPO, state_tensors
    from smplsim_tpu_torch.models import registry

    sides = []
    for d in devs:
        m64 = registry.default_humanoid(torch.float64, device=d)
        sides.append(PPO(HumanoidSpeed(m64), ucfg))
    nobs_dim, nu = sides[0].env.obs_size, sides[0].env.action_size
    rs = np.random.RandomState(0)
    shp = (ucfg.horizon, ucfg.num_envs)
    done_np = rs.rand(*shp) < 0.1
    obs_np = rs.randn(*shp, nobs_dim)
    init_states = [ppo_.init(0) for ppo_ in sides]      # the same nets on both
    with torch.no_grad():
        # actions about the initial policy's mean, logp its own plus noise:
        # some ratios leave the clip range
        mu, ls = init_states[-1].policy(torch.as_tensor(obs_np))
        act = mu + ls.exp() * torch.as_tensor(rs.randn(*shp, nu))
        logp = gaussian_log_prob(mu, ls, act).numpy() + 0.3 * rs.randn(*shp)
    traj_np = dict(obs=obs_np, action=act.numpy(), logp=logp, reward=rs.rand(*shp),
                   done=done_np, terminated=done_np & (rs.rand(*shp) < 0.5),
                   nactive=rs.randint(0, 64, shp), overflow=rs.rand(*shp) < 0.2,
                   stalled=rs.rand(*shp) < 0.1)
    last_np = rs.randn(ucfg.num_envs, nobs_dim)
    b = ucfg.num_envs // world
    cols = slice(rank * b, (rank + 1) * b)
    n_u = ucfg.horizon * b
    perms_np = np.stack([np.random.RandomState(rank).permutation(n_u) if group is not None
                         else rs.permutation(n_u) for _ in range(ucfg.opt_num_epochs)])
    results = []
    for ppo_, uts, d in zip(sides, init_states, devs):
        tr = {k: torch.as_tensor(v[:, cols], device=d) for k, v in traj_np.items()}
        uts, _ = ppo_.update(uts, SimpleNamespace(obs=torch.as_tensor(last_np[cols], device=d)),
                             tr, perms=torch.as_tensor(perms_np, device=d), group=group)
        results.append(state_tensors(uts, env=False))
    return max(((a.cpu().double() - b_.double()).abs() / (1.0 + b_.double().abs())).max().item()
               for a, b_ in zip(results[0], results[1]) if a.is_floating_point())


def state_digests(ts) -> list:
    """SHA-256 of every tensor of a TrainState but its env states (the
    trainer's generator, nets, Adam states, running norm): two ranks hold
    the same values bit for bit where these agree."""
    import hashlib

    from smplsim_tpu_torch.learning.ppo import state_tensors

    return [hashlib.sha256(t.cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
                           ).hexdigest() for t in state_tensors(ts, env=False)]


def time_halves(ppo, sync) -> dict:
    """Wrap ppo.rollout and ppo.update on the instance so that the wall
    seconds of each, synchronized, add up in the returned dict."""
    secs = {"rollout": 0.0, "update": 0.0}

    def timed(name, fn):
        def run(*args, **kwargs):
            sync()
            t0 = time.time()
            out = fn(*args, **kwargs)
            sync()
            secs[name] += time.time() - t0
            return out
        return run

    ppo.rollout, ppo.update = timed("rollout", ppo.rollout), timed("update", ppo.update)
    return secs


def allreduce_ms(ts, mesh, reps: int = 10) -> dict:
    """Milliseconds of one gradient average (parallel.mesh.pmean of a
    flattened buffer of each net's parameter count) over the mesh's group,
    on its device: PPO.update makes one per net and minibatch step."""
    from smplsim_tpu_torch.parallel import mesh as pm

    out = {}
    for name, net in (("policy", ts.policy), ("value", ts.value)):
        buf = torch.ones(sum(p.numel() for p in net.parameters()), device=mesh.device)
        pm.pmean(buf, mesh.group)
        dist.barrier(mesh.group)
        torch.cuda.synchronize(mesh.device)
        t0 = time.time()
        for _ in range(reps):
            pm.pmean(buf, mesh.group)
        torch.cuda.synchronize(mesh.device)
        out[name] = (time.time() - t0) / reps * 1e3
        out[f"{name}_floats"] = buf.numel()
    return out


def rank_phases(rank: int, world: int, store: str, cfi: int, ucfg) -> dict:
    """One rank of phases 32 and 33, in its own process on the one card,
    over gloo: the sharded PPO step at PPOConfig() (num_envs global),
    SHARDED_ITERS iterations; phase 18's float64 update (ucfg) with the
    group, card vs CPU; a sharded CEMConfig() plan of CEM_RANK_SAMPLES
    samples. Every launch count set to 0 just before each counted run and
    read just after."""
    from smplsim_tpu_torch.control import CEMConfig, CEMPlanner
    from smplsim_tpu_torch.envs import GetupConfig, HumanoidGetup, HumanoidSpeed, SpeedConfig
    from smplsim_tpu_torch.learning.ppo import PPO, PPOConfig
    from smplsim_tpu_torch.models import registry
    from smplsim_tpu_torch.ops import _build, linalg, qp
    from smplsim_tpu_torch.parallel import mesh as pm
    from smplsim_tpu_torch.parallel import rollout as pr

    _build.build_all()       # built by the parent: loads them
    counted = (linalg.chol_solve, linalg.cho_factor_solve, linalg.solve_lower, qp.newton_qp,
               linalg.cholesky)
    pm.init_distributed(store, world, rank, backend="gloo")
    try:
        mesh = pm.data_mesh()
        dev = mesh.device
        sync = lambda: torch.cuda.synchronize(dev)
        out = dict(backend=dist.get_backend(mesh.group), device=str(dev), iterations=[])
        # ----------------------------------------------- 32. sharded PPO step
        model = registry.default_humanoid(torch.float32, device=dev)
        ppo = PPO(HumanoidSpeed(model, SpeedConfig()), PPOConfig())
        step, ts = pr.sharded_ppo_step(ppo, mesh, ppo.init(0))
        out["envs"] = ts.env_states.obs.shape[0]
        halves = time_halves(ppo, sync)
        for _ in range(SHARDED_ITERS):
            for fn in counted:
                fn.launches = 0
            halves.update(rollout=0.0, update=0.0)
            dist.barrier(mesh.group)
            sync()
            t0 = time.time()
            ts, metrics = step(ts)
            sync()
            out["iterations"].append(dict(
                seconds=time.time() - t0, launches=[fn.launches for fn in counted],
                metrics={k: float(v) for k, v in metrics.items()}, **halves))
        out["digests"] = state_digests(ts)
        out["allreduce_ms"] = allreduce_ms(ts, mesh)
        out["epoch"] = ts.epoch
        out["finite"] = all(bool(torch.isfinite(p).all()) for net in (ts.policy, ts.value)
                            for p in net.parameters())
        out["update_gap"] = update_card_vs_cpu(ucfg, rank, world, mesh.group,
                                               (dev, torch.device("cpu")))
        # ------------------------------------------------ 33. sharded CEM plan
        cenv = HumanoidGetup(model, GetupConfig(control_frequency_inv=cfi))
        ccfg = CEMConfig(num_samples=CEM_RANK_SAMPLES)
        planner = CEMPlanner(cenv, ccfg)
        cstate = cenv.reset(1, torch.Generator(device=dev).manual_seed(3))
        gen = pm.fold_in(torch.Generator(device=dev).manual_seed(4), rank)
        for fn in counted:
            fn.launches = 0
        dist.barrier(mesh.group)
        sync()
        t0 = time.time()
        a0, mean, best = planner.plan(cstate, generator=gen, group=mesh.group)
        sync()
        out["plan"] = dict(seconds=time.time() - t0, launches=[fn.launches for fn in counted],
                           a0=a0.cpu(), mean=mean.cpu(), best=best.cpu())
        zero = planner._rollout_cost(cstate, torch.zeros(1, ccfg.horizon, cenv.action_size,
                                                         device=dev))
        out["plan"]["zero_cost"] = float(zero[0])
        return out
    finally:
        dist.destroy_process_group()


def parallel_paths(dev, counted, card: str, ucfg, ppo_sec: dict, plan_s: float) -> dict:
    """Phases 31-33: the sharded PPO step at a world of 1 over NCCL in this
    process, bit for bit against rollout + update from the derived state;
    then two ranks in spawned processes on the one card over gloo (NCCL
    takes no two ranks on one device): rank_phases. Returns the launch
    counts and times."""
    from smplsim_tpu_torch.control import CEMConfig
    from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig
    from smplsim_tpu_torch.learning.ppo import PPO, PPOConfig, state_tensors
    from smplsim_tpu_torch.models import registry
    from smplsim_tpu_torch.parallel import mesh as pm
    from smplsim_tpu_torch.parallel import rollout as pr

    names = ("chol_solve", "cho_factor_solve", "solve_lower", "newton_qp", "cholesky")
    pcfg = PPOConfig()
    cfi = SpeedConfig().control_frequency_inv
    per_iter = [2 * cfi * pcfg.horizon, 0, 0, cfi * pcfg.horizon, 0]
    # -------------------------------------------- 31. a world of 1 over NCCL
    print("phase 31: sharded PPO step, a world of 1 over NCCL (PPOConfig(), the default QP)",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0,
                                timeout=pm.TIMEOUT)
        try:
            mesh = pm.data_mesh()
            check(mesh.device == dev and mesh.size == 1
                  and dist.get_backend(mesh.group) == "nccl",
                  f"the mesh: {mesh.size} rank on {mesh.device} over "
                  f"{dist.get_backend(mesh.group)}")
            model = registry.default_humanoid(torch.float32, device=dev)
            ppo = PPO(HumanoidSpeed(model, SpeedConfig()), pcfg)
            step, ts = pr.sharded_ppo_step(ppo, mesh, ppo.init(0))
            ref = pr.place_train_state(ppo.init(0), mesh)
            halves = time_halves(ppo, torch.cuda.synchronize)
            for fn in counted:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            ts, metrics = step(ts)
            torch.cuda.synchronize()
            nccl_s = time.time() - t0
            nccl_l = [fn.launches for fn in counted]
            nccl_halves = dict(halves)
            check(nccl_l == per_iter, f"the sharded iteration launched {dict(zip(names, nccl_l))}"
                                      f" = {dict(zip(names, per_iter))}")
            # the unsharded trainer from the derived local state, no group
            t0 = time.time()
            local = pr.local_train_state(ref, mesh)
            env_states, traj = ppo.rollout(local)
            ref1, ref_metrics = ppo.update(local, env_states, traj)
            torch.cuda.synchronize()
            ref_s = time.time() - t0
            ref1 = dataclasses.replace(ref1, generator=pm.fold_in(ref.generator, pr.CARRY_FOLD))
            check(same_bits(state_tensors(ts), state_tensors(ref1))
                  and all(torch.equal(metrics[k], ref_metrics[k]) for k in metrics),
                  "a world of 1: every tensor of the TrainState (generators, nets, Adam states, "
                  "running norm, env states) and the six metrics equal bit for bit to rollout + "
                  "update from the derived local TrainState")
            nccl_ms = allreduce_ms(ts, mesh)
        finally:
            dist.destroy_process_group()
    phase18_s = ppo_sec["rollout"] + ppo_sec["update"]
    print(f"  {nccl_s:.3f} s per sharded iteration (rollout {nccl_halves['rollout']:.3f} s, "
          f"update {nccl_halves['update']:.3f} s) beside phase 18's {phase18_s:.3f} s "
          f"({nccl_s / phase18_s:.4f}x) and the unsharded iteration's {ref_s:.3f} s after it "
          f"({nccl_s / ref_s:.4f}x) on {card}", flush=True)
    n_mb = pcfg.opt_num_epochs * pcfg.num_minibatches
    print(f"  NCCL gradient average: policy {nccl_ms['policy']:.3f} ms "
          f"({nccl_ms['policy_floats']} floats), value {nccl_ms['value']:.3f} ms; x {n_mb} "
          f"minibatch steps = {(nccl_ms['policy'] + nccl_ms['value']) * n_mb:.1f} ms per "
          f"iteration", flush=True)

    # -------------------------------- 32-33. two ranks on one card over gloo
    print(f"phases 32-33: {SHARDED_WORLD} ranks in spawned processes on one card over gloo",
          flush=True)
    t0 = time.time()
    ranks = pm.run_ranks(rank_phases, SHARDED_WORLD, (cfi, ucfg), timeout=RANKS_TIMEOUT)
    print(f"  the world ran {time.time() - t0:.1f} s (start-up included)", flush=True)
    print(f"phase 32: sharded PPO step, {SHARDED_WORLD} ranks x "
          f"{pcfg.num_envs // SHARDED_WORLD} envs over gloo (PPOConfig())", flush=True)
    check(all(r["backend"] == "gloo" and r["device"] == str(dev) for r in ranks),
          f"every rank over gloo on {dev}: {[(r['backend'], r['device']) for r in ranks]}")
    check(all(r["envs"] * SHARDED_WORLD == pcfg.num_envs for r in ranks),
          f"{[r['envs'] for r in ranks]} envs per rank")
    for it in range(SHARDED_ITERS):
        its = [r["iterations"][it] for r in ranks]
        check(all(i["launches"] == per_iter for i in its),
              f"iteration {it + 1}: each rank launched {[i['launches'] for i in its]} "
              f"({names}) = {per_iter}")
        check(all(i["metrics"] == its[0]["metrics"] for i in its),
              f"iteration {it + 1}: the six metrics equal on both ranks: {its[0]['metrics']}")
        secs = [i["seconds"] for i in its]
        rate = sum(r["envs"] * pcfg.horizon / s for r, s in zip(ranks, secs))
        print(f"  iteration {it + 1}: {max(secs):.3f} s (ranks {secs}; rollout "
              f"{[round(i['rollout'], 3) for i in its]} s, update "
              f"{[round(i['update'], 3) for i in its]} s), {rate:.1f} training env-steps/s "
              f"summed over the ranks", flush=True)
    gms = [r["allreduce_ms"] for r in ranks]
    print(f"  gloo gradient average: policy {[round(g['policy'], 3) for g in gms]} ms, value "
          f"{[round(g['value'], 3) for g in gms]} ms; x {n_mb} minibatch steps = "
          f"{max(g['policy'] + g['value'] for g in gms) * n_mb:.1f} ms per iteration",
          flush=True)
    check(all(r["digests"] == ranks[0]["digests"] and r["epoch"] == SHARDED_ITERS and r["finite"]
              for r in ranks),
          f"the trainer's generator, every parameter, Adam moment and the running norm "
          f"bit-identical across the ranks after {SHARDED_ITERS} iterations "
          f"({len(ranks[0]['digests'])} tensors, SHA-256), finite")
    gaps = [r["update_gap"] for r in ranks]
    check(max(gaps) <= 1e-9, f"PPO.update(group=) in float64 (phase 18's trajectory, its envs "
                             f"split over the ranks), card vs CPU: {gaps} <= 1e-9 relative")
    print(f"phase 33: sharded CEM plan, {SHARDED_WORLD} ranks x {CEM_RANK_SAMPLES} samples over "
          f"gloo (CEMConfig())", flush=True)
    plans = [r["plan"] for r in ranks]
    ccfg = CEMConfig()
    n_cs = ccfg.iterations * ccfg.horizon
    plan_l = [2 * cfi * n_cs, 0, 0, cfi * n_cs, 0]
    check(all(p["launches"] == plan_l for p in plans),
          f"each rank's plan launched {[p['launches'] for p in plans]} ({names}) = {plan_l}")
    check(all(torch.equal(p[k], plans[0][k]) for p in plans for k in ("a0", "mean", "best")),
          "both ranks return the same first action, mean and best cost bit for bit")
    check(all(math.isfinite(float(p["best"])) and float(p["best"]) <= p["zero_cost"] + 1e-6
              for p in plans),
          f"best cost {float(plans[0]['best']):.5f} <= the zero-action rollout's "
          f"{[p['zero_cost'] for p in plans]}")
    plan2_s = max(p["seconds"] for p in plans)
    print(f"  {plan2_s:.3f} s per sharded plan (ranks {[p['seconds'] for p in plans]}) beside "
          f"phase 19's {plan_s:.3f} s at {ccfg.num_samples} samples on {card}", flush=True)
    return dict(nccl_l=nccl_l, nccl_s=nccl_s, phase18_s=phase18_s, unsharded_s=ref_s,
                nccl_halves=nccl_halves, nccl_allreduce_ms=nccl_ms,
                gloo_halves=[[{k: i[k] for k in ("rollout", "update")} for i in r["iterations"]]
                             for r in ranks],
                gloo_allreduce_ms=gms,
                gloo_l=[[i["launches"] for i in r["iterations"]] for r in ranks],
                gloo_s=[[i["seconds"] for i in r["iterations"]] for r in ranks],
                plan_l=[p["launches"] for p in plans], plan_s=plan2_s, update_gap=max(gaps))


def gate_tools():
    """tools/calibrate_solver_torch.py and tools/gate_f32_torch.py as modules."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import calibrate_solver_torch as cal
    import gate_f32_torch as gate
    return cal, gate


def product_gate_paths(dev, counted) -> dict:
    """Phase 34: the product gate of tools/gate_f32_torch.py on the card,
    each run counted: the float64 speed loop at the default QP against the
    MuJoCo golden, the float32 loops at the product QP on the dense and the
    articulated-body route against the JAX package's float32 trajectory,
    getup's solver health; then Kernels A and B against their plain versions
    on the float64 loop's own systems at B = 1. Returns the records, the
    launch counts per run and the hold reports."""
    from smplsim_tpu_torch.models import registry
    from smplsim_tpu_torch.ops import qp

    cal, gate = gate_tools()
    names = ("chol_solve", "cho_factor_solve", "solve_lower", "newton_qp", "cholesky")

    def counted_run(label, fn, a_b):
        for f in counted:
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        rec = fn()
        torch.cuda.synchronize()
        sec = time.time() - t0
        got = [f.launches for f in counted]
        want = [a_b[0], 0, 0, a_b[1], 0]
        check(got == want, f"{label}: launches {dict(zip(names, got))} = chol_solve {a_b[0]}, "
                           f"newton_qp {a_b[1]}, no C, D or E")
        print(f"  {label}: {sec:.1f} s", flush=True)
        return rec, dict(zip(names, got)), sec

    out = {"records": {}, "launches": {}, "seconds": {}}
    print(f"phase 34: the product gate (tools/gate_f32_torch.py) on {GATE_STEPS} float64 and "
          f"float32 control steps, {GATE_ABA_STEPS} on the ABA route, getup {GATE_GETUP_ENVS} "
          f"envs x {GATE_GETUP_STEPS}", flush=True)
    held = {}

    def keep(t, state, action):
        if t in GATE_HOLD_STEPS:
            held[t] = (state, action)

    runs = (("speed_f64", lambda: gate.speed_f64(dev, GATE_STEPS, before_step=keep),
             (2 * CFI * GATE_STEPS, CFI * GATE_STEPS)),
            ("speed_f32_dense", lambda: gate.speed_f32(dev, GATE_STEPS),
             (2 * CFI * GATE_STEPS, CFI * GATE_STEPS)),
            ("speed_f32_aba", lambda: gate.speed_f32(dev, GATE_ABA_STEPS, aba=True),
             (GATE_ABA_STEPS, CFI * GATE_ABA_STEPS)),
            # the reset's Fall (3 control steps) and a Fall for every env at
            # each step_autoreset (phase 14's 120 + 60)
            ("getup", lambda: gate.getup(dev, GATE_GETUP_ENVS, GATE_GETUP_STEPS),
             (6 * CFI + 8 * CFI * GATE_GETUP_STEPS, 3 * CFI + 4 * CFI * GATE_GETUP_STEPS)))
    for label, fn, a_b in runs:
        rec, launches, sec = counted_run(label, fn, a_b)
        out["records"][label], out["launches"][label], out["seconds"][label] = rec, launches, sec
        for k, v in rec.items():
            if k.startswith("vs_"):
                print(f"  {label} {k}: {json.dumps(v)}", flush=True)
    r64 = out["records"]["speed_f64"]
    err = r64["vs_f64_golden"]["max_err_150"]
    check(r64["pass"], f"float64 speed loop at the default QP against the MuJoCo golden over "
                       f"{GATE_STEPS} control steps: {err:.3e} <= 1e-9 (the JAX float64 "
                       f"trajectory: {r64['vs_jax_f64']['max_err_150']:.3e})")
    for label in ("speed_f32_dense", "speed_f32_aba"):
        r = out["records"][label]
        check(r["pass"], f"{label}: against the JAX float32 trajectory over steps 0-"
                         f"{min(r['steps'] - 1, gate.F32_JAX_LAST)}: "
                         f"{r['vs_jax_f32_max_err_0_39']:.3e} <= 5e-3 (over "
                         f"{r['steps']}: {r['vs_jax_f32']['max_err_150']:.3e}; golden's 1e-2 first "
                         f"crossed at {r['vs_f64_golden']['first_step_over_1e-2']}, the 45-step "
                         f"envelope {'met' if r['envelope_pass'] else 'not met'}, recorded)")
    g = out["records"]["getup"]
    check(g["pass"], f"getup {GATE_GETUP_ENVS} envs x {GATE_GETUP_STEPS}: stalled_frac "
                     f"{g['stalled_frac']:.4f} <= 0.05 (overflow {g['overflow_frac']:.4f}, "
                     f"nactive mean {g['nactive_mean']:.2f} max {g['nactive_max']})")
    # A and B on the float64 loop's own systems, one env
    model = registry.default_humanoid(torch.float64, dev)
    out["hold"] = {}
    for t in GATE_HOLD_STEPS:
        state, action = held[t]
        inputs = substep_inputs(model, state, action, qp_rows=cal.DEFAULT_QP["qp_rows"])
        out["hold"][t] = hold_a_b(f"gate f64 step {t} ", inputs, qp.NEWTON_ITERS,
                                  qp.tol_for(torch.float32), gate_forms=False)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from smplsim_tpu_torch.agents import RunConfig
    from smplsim_tpu_torch.control import CEMConfig, ILQRConfig, ilqr_plan, jacobians
    from smplsim_tpu_torch.learning.ppo import PPOConfig
    from smplsim_tpu_torch.envs import (GetupConfig, HumanoidGetup, HumanoidReach,
                                        HumanoidSpeed, ReachConfig, SpeedConfig)
    from smplsim_tpu_torch.envs import obs as obs_mod
    from smplsim_tpu_torch.models import registry
    from smplsim_tpu_torch.ops import _build, linalg, qp
    from smplsim_tpu_torch.physics import (constraints, control, dynamics, engine,
                                           kinematics, solver, substep)

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
    attrs = linalg.kernel_attributes()
    for a in attrs:
        print(f"  {a}")
    spilled = [a for a in attrs if a["dtype"] == "float32" and a["local_bytes"] > 0]
    check(not spilled, f"no float32 instantiation of Kernels A, B, C, D and E uses local memory "
                       f"({len(attrs)} instantiations; float64 with local memory: "
                       f"{sum(a['local_bytes'] > 0 for a in attrs)})")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = next(a["resident_per_sm"] for a in attrs
                    if a["kernel"] == "newton_qp" and a["dtype"] == "float32" and a["R"] == 1)
    check(resident * sms >= B_MAIN,
          f"newton_qp float32 at K <= 32: {resident} systems resident per SM x {sms} SMs "
          f">= {B_MAIN}: the main path's batch runs in one wave")

    # Kernel A's tiled launches at the SMPLX humanoid's n = 159 (phase 21)
    for n_, m_, size in ((159, 1, 4), (159, 33, 4), (159, 1, 8), (159, 33, 8), (159, 65, 8)):
        occ = linalg.chol_solve_occupancy(n_, m_, size)
        print(f"  chol_solve tiled: {occ}")
        check(occ["blocks_per_sm"] >= 1, f"chol_solve {occ['dtype']} n={n_} m={m_} "
                                         f"({occ['form']} form) launches: {occ['blocks_per_sm']} "
                                         "resident blocks per SM")

    model = registry.default_humanoid(torch.float32)
    env = HumanoidSpeed(model, **QP)
    gen = torch.Generator(device=dev).manual_seed(0)
    action = lambda n: torch.rand(n, model.nu, generator=gen, device=dev) * 2.0 - 1.0

    # --------------------------------------- 2. kernels vs plain, real inputs
    print("phase 2: kernels against their plain versions", flush=True)
    state = env.reset(B_MAIN, gen)
    for _ in range(3):
        state = env.step_autoreset(state, action(B_MAIN))
    K = min(QP["qp_rows"], constraints.NEFC)
    report = hold_a_b("", substep_inputs(model, state, action(B_MAIN)))

    # ------------------------------------------------------------ 3. main path
    print("phase 3: main path", flush=True)
    counted = (linalg.chol_solve, linalg.cho_factor_solve, linalg.solve_lower, qp.newton_qp,
               linalg.cholesky)
    for fn in counted:
        fn.launches = 0
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
    n_chol, n_cfs, n_sl, n_qp, n_e = (fn.launches for fn in counted)
    check(n_chol == 2 * CFI * STEPS, f"chol_solve launched {n_chol} = 30 x {STEPS} times")
    check(n_qp == CFI * STEPS, f"newton_qp launched {n_qp} = 15 x {STEPS} times")
    check(n_cfs == 0 and n_sl == 0 and n_e == 0,
          f"cho_factor_solve, solve_lower and cholesky not launched ({n_cfs}, {n_sl}, {n_e})")
    finite = all(bool(torch.isfinite(x).all()) for x in (
        state.phys.qpos, state.phys.qvel, state.obs, state.reward, *state.pd_cache))
    check(finite, "main-path state finite")
    check(state.obs.shape == (B_MAIN, env.obs_size), f"obs shape {tuple(state.obs.shape)}")
    rate = B_MAIN * STEPS / elapsed
    print(f"  {STEPS} control steps x {B_MAIN} envs in {elapsed:.3f} s: {rate:.1f} env-steps/s "
          f"({CFI} substeps each) on {card}")
    print(f"  overflow fraction {(overflow / STEPS).item():.5f} (with the previous kernels "
          f"{PREVIOUS_HEALTH['overflow']:.5f}), stalled fraction {(stalled / STEPS).item():.5f} "
          f"({PREVIOUS_HEALTH['stalled']:.5f}), done at the last step "
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

    # -------------------------------------- 4b. card vs CPU under TF32 ("high")
    print("phase 4b: card vs CPU with the process at torch.set_float32_matmul_precision('high')",
          flush=True)
    tf32 = tf32_readings(model, cpu_model, env, gen, action, engine, substep, constraints,
                         control)
    check(tf32["pinned"] <= 5e-3,
          f"qpos card vs CPU after 2 control steps, the process at TF32 ('high'), through "
          f"engine.control_step (pinned): {tf32['pinned']:.3e} <= 5e-3 (phase 4: {diff:.3e})")
    check(tf32["pinned_new_api"] <= 5e-3,
          f"the same with TF32 set through torch.backends.cuda.matmul.fp32_precision: "
          f"{tf32['pinned_new_api']:.3e} <= 5e-3")
    print(f"  the same two control steps through the unpinned substep.control_loop under TF32: "
          f"{tf32['unpinned']:.3e} (not gated); pinned under TF32 vs pinned at 'highest' on the "
          f"card: {tf32['pinned_vs_highest']:.3e} (legacy call), "
          f"{tf32['pinned_new_api_vs_highest']:.3e} (fp32_precision)", flush=True)
    check(torch.get_float32_matmul_precision() == "highest" and
          not torch.backends.cuda.matmul.allow_tf32, "the process setting restored")

    # ------------------------------ 5. kernels C and D vs plain, torque path
    print("phase 5: kernels C and D against their plain versions (torque path)", flush=True)
    tenv = HumanoidSpeed(model, SpeedConfig(control_mode="torque"), **QP)
    ps = tenv.config.power_scale
    tstate = tenv.reset(B_MAIN, gen)
    for _ in range(3):
        tstate = tenv.step_autoreset(tstate, action(B_MAIN))
    q, v = tstate.phys.qpos, tstate.phys.qvel
    tau = control.torque_ctrl(model, action(B_MAIN), ps)
    kin = kinematics.fk(model, q)
    M = dynamics.mass_matrix(model, kin)
    qfrc = (dynamics.actuator_forces(model, tau) + dynamics.passive_forces(model, v)
            - dynamics.bias_forces(model, kin, v))[..., None]
    efc = constraints.make_efc(model, kin, q, v)
    rows = solver.select_rows(model, kin.S, efc, torch.zeros(B_MAIN, constraints.NEFC,
                                                             device=dev), K)
    Jt = rows.J.transpose(1, 2).contiguous()
    L_p, qacc_s = linalg.cho_factor_solve_plain(M, qfrc)
    Y = linalg.solve_lower_plain(L_p, Jt)
    A_g = Y.mT @ Y + torch.diag_embed(rows.R)
    b_g = torch.where(rows.actf > 0.5, rows.aref - (rows.J @ qacc_s)[..., 0], 0.0)
    f_g = qp.newton_qp_plain(A_g, b_g, rows.actf, rows.f0, QP["qp_iters"], QP["qp_tol"])
    qfrc_c = Jt @ f_g[..., None]
    y_c = linalg.solve_lower_plain(L_p, qfrc_c)
    # a random torque policy at power_scale 10 saturates every joint: some
    # envs fly far from the origin, where the float32 mass matrix (about
    # the world origin) is no longer positive definite, and the loop resets
    # them. Results are held on the systems whose inputs and plain results
    # are finite; the times are taken on all of them.
    print(f"  inputs: M {tuple(M.shape)}, J^T {tuple(Jt.shape)}, |qvel| max "
          f"{v.abs().max().item():.3e}, active rows per env mean "
          f"{efc.active.sum(1).float().mean().item():.2f} max {int(efc.active.sum(1).max())}; "
          f"finite factor in {int(finite_rows(L_p).sum())} envs, finite constraint force in "
          f"{int(finite_rows(qfrc_c).sum())}", flush=True)

    for dt in (torch.float64, torch.float32):
        Ad, bd = M.to(dt).contiguous(), qfrc.to(dt).contiguous()
        Lk, xk = linalg.cho_factor_solve(Ad, bd)
        torch.cuda.synchronize()
        Lp, xp = linalg.cho_factor_solve_plain(Ad, bd)
        ok = finite_rows(Ad, bd, Lp, xp)
        print(f"  cho_factor_solve {dt}: plain result not finite in {int((~ok).sum())} "
              f"systems, kernel in {int((~finite_rows(Lk, xk)).sum())}", flush=True)
        check(bool(torch.isfinite(Lk[ok]).all() and torch.isfinite(xk[ok]).all()),
              f"cho_factor_solve {dt} finite on the {int(ok.sum())} systems with finite inputs")
        check(bool((torch.triu(Lk, 1) == 0).all()),
              f"cho_factor_solve {dt}: L is exactly zero above the diagonal")
        if dt == torch.float64:
            rl, rx = rel_diff(Lk[ok], Lp[ok]), rel_diff(xk[ok], xp[ok])
            check(max(rl, rx) <= 1e-9, f"cho_factor_solve float64 vs plain: L {rl:.3e}, "
                                       f"x {rx:.3e} <= 1e-9")
        else:
            res = rel_residual(Ad[ok], xk[ok], bd[ok])
            Lk64 = Lk.double()
            fac = (inf_norm(Lk64 @ Lk64.mT - Ad.double()) / inf_norm(Ad.double()))[ok].amax().item()
            check(res <= 1e-5 and fac <= 1e-5,
                  f"cho_factor_solve float32: relative residual {res:.3e}, |L L^T - A| / |A| "
                  f"{fac:.3e} <= 1e-5")
            ms = cuda_ms(lambda: linalg.cho_factor_solve(Ad, bd), 20)
            plain = cuda_ms(lambda: linalg.cho_factor_solve_plain(Ad, bd), 3)

            def library():
                # the _ex form: the non-definite systems above must not raise
                Ll = torch.linalg.cholesky_ex(Ad)[0]
                return Ll, torch.cholesky_solve(bd, Ll)
            lib = cuda_ms(library, 10)
            Bn, n, m = bd.shape
            # lower A read, full L written, b read, x written
            nbytes = 4 * Bn * (n * (n + 1) / 2 + n * n + 2 * n * m)
            bms, by = bound_ms(nbytes, Bn * (n ** 3 / 3 + 2 * n * n * m), dt)
            report["C"] = dict(max_abs_err=max((Lk - Lp)[ok].abs().amax().item(),
                                               (xk - xp)[ok].abs().amax().item()),
                               max_rel_err=max(rel_diff(Lk[ok], Lp[ok]), rel_diff(xk[ok], xp[ok])),
                               max_residual=res, max_factor_residual=fac, ms=ms,
                               plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
            print(f"  cho_factor_solve[m=1] f32: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"library {lib:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)

    d_cases = {f"m={K}": (Jt, False), "m=1": (qfrc_c, False), "m=1,trans": (y_c, True)}
    for name, (rhs, trans) in d_cases.items():
        for dt in (torch.float64, torch.float32):
            Ld, bd = L_p.to(dt).contiguous(), rhs.to(dt).contiguous()
            yk = linalg.solve_lower(Ld, bd, trans)
            torch.cuda.synchronize()
            yp = linalg.solve_lower_any_plain(Ld, bd, trans)
            ok = finite_rows(Ld, bd, yp)
            check(bool(torch.isfinite(yk[ok]).all()),
                  f"solve_lower[{name}] {dt} finite on the {int(ok.sum())} systems with finite "
                  "inputs")
            if dt == torch.float64:
                rel = rel_diff(yk[ok], yp[ok])
                check(rel <= 1e-9, f"solve_lower[{name}] float64 vs plain: {rel:.3e} <= 1e-9")
                continue
            Lt = Ld.mT if trans else Ld
            res = rel_residual(Lt[ok], yk[ok], bd[ok])
            check(res <= 1e-5, f"solve_lower[{name}] float32 relative residual {res:.3e} <= 1e-5")
            ms = cuda_ms(lambda: linalg.solve_lower(Ld, bd, trans), 20)
            plain = cuda_ms(lambda: linalg.solve_lower_any_plain(Ld, bd, trans), 3)
            lib = cuda_ms(lambda: torch.linalg.solve_triangular(Lt, bd, upper=trans), 10)
            Bn, n, m = bd.shape
            nbytes = 4 * Bn * (n * (n + 1) / 2 + 2 * n * m)
            bms, by = bound_ms(nbytes, Bn * n * n * m, dt)
            report[name] = dict(max_abs_err=(yk - yp)[ok].abs().amax().item(),
                                max_rel_err=rel_diff(yk[ok], yp[ok]), max_residual=res, ms=ms,
                                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
            print(f"  solve_lower[{name}] f32: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"library {lib:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)

    # flung envs stall at the iteration cap, where the two summation orders
    # stop at different iterates: held where both meet the tolerance
    report["qp_torque"] = time_qp(qp, _build, A_g.contiguous(), b_g.contiguous(), rows.actf,
                                  rows.f0, QP["qp_iters"], QP["qp_tol"], converged_only=True)
    r = report["qp_torque"]
    print(f"  newton_qp f32 (torque path, Gram form): kernel {r['ms']:.4f} ms (block form "
          f"{r['previous_ms']:.4f}), plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, iterations mean "
          f"{r['iterations_mean']:.2f} max {r['iterations_max']}", flush=True)

    # --------------------------------------------------------- 6. torque path
    print("phase 6: torque path", flush=True)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    tstate = tenv.reset(B_MAIN, gen)
    overflow_t = stalled_t = 0.0
    for _ in range(STEPS):
        tstate = tenv.step_autoreset(tstate, action(B_MAIN))
        overflow_t += tstate.info["overflow"].float().mean()
        stalled_t += tstate.info["stalled"].float().mean()
    torch.cuda.synchronize()
    elapsed_t = time.time() - t0
    t_chol, t_cfs, t_sl, t_qp, t_e = (fn.launches for fn in counted)
    check(t_cfs == CFI * STEPS, f"cho_factor_solve launched {t_cfs} = 15 x {STEPS} times")
    check(t_sl == 3 * CFI * STEPS, f"solve_lower launched {t_sl} = 45 x {STEPS} times")
    check(t_qp == CFI * STEPS, f"newton_qp launched {t_qp} = 15 x {STEPS} times")
    check(t_chol == 0 and t_e == 0, f"chol_solve and cholesky not launched ({t_chol}, {t_e})")
    finite = all(bool(torch.isfinite(x).all()) for x in (
        tstate.phys.qpos, tstate.phys.qvel, tstate.obs, tstate.reward))
    check(finite and tstate.pd_cache is None, "torque-path state finite, no stable-PD cache")
    check(tstate.obs.shape == (B_MAIN, tenv.obs_size), f"obs shape {tuple(tstate.obs.shape)}")
    rate_t = B_MAIN * STEPS / elapsed_t
    print(f"  {STEPS} control steps x {B_MAIN} envs in {elapsed_t:.3f} s: {rate_t:.1f} "
          f"env-steps/s ({CFI} substeps each) on {card}; uhc_pd path in this call: "
          f"{rate:.1f} env-steps/s")
    print(f"  overflow fraction {(overflow_t / STEPS).item():.5f}, stalled fraction "
          f"{(stalled_t / STEPS).item():.5f}, done at the last step "
          f"{tstate.done.float().mean().item():.4f}", flush=True)

    # --------------------------------------------- 7. card vs CPU, torque path
    print("phase 7: card vs CPU on the torque path", flush=True)
    for scale, cfi, n_steps in TORQUE_CMP:
        fresh = tenv.reset(n, gen)
        st_gpu = fresh.phys
        st_cpu = engine.PhysicsState(st_gpu.qpos.cpu(), st_gpu.qvel.cpu())
        for k in range(n_steps):
            act = scale * action(n)
            st_gpu = engine.control_step(model, st_gpu, act, cfi, control_mode="torque",
                                         power_scale=ps, **QP)[0]
            st_cpu = engine.control_step(cpu_model, st_cpu, act.cpu(), cfi,
                                         control_mode="torque", power_scale=ps, **QP)[0]
            diff = ((st_gpu.qpos.cpu() - st_cpu.qpos).abs() / (1.0 + st_cpu.qpos.abs())).amax().item()
            check(diff <= 5e-3, f"qpos card vs CPU, actions at {scale} of full scale, after "
                                f"{k + 1} x {cfi} substeps: {diff:.3e} <= 5e-3")

    # ---------------- trajectory points of phases 8-10: one env from a reset
    # state, 3 control steps at 10% of full-scale actions
    nq = model.nq

    def dyn(x, u):
        st = engine.control_step(model, engine.PhysicsState(x[:, :nq], x[:, nq:]), u, CFI,
                                 **QP)[0]
        return torch.cat([st.qpos, st.qvel], 1)

    st0 = env.reset(1, gen).phys
    x_pts = [torch.cat([st0.qpos, st0.qvel], 1)]
    u_pts = 0.1 * action(N_POINTS)
    for t in range(N_POINTS - 1):
        x_pts.append(dyn(x_pts[-1], u_pts[t:t + 1]))
    x_pts = torch.cat(x_pts)
    reps = model.nq + model.nv + model.nu

    # ------------------------------------ 8. Kernel E vs plain, QP derivative
    print("phase 8: kernel E cholesky against its plain version (QP derivative)", flush=True)
    st8 = engine.PhysicsState(x_pts[:, :nq].contiguous(), x_pts[:, nq:].contiguous())
    M8, C8 = engine.pd_cache(model, st8)
    tau = control.stable_pd_torque_ref(model, M8, C8, st8.qpos, st8.qvel,
                                       control.pd_target_from_action(model, u_pts))
    kin = kinematics.fk(model, st8.qpos)
    sm8 = dynamics.smooth_dynamics(model, kin, st8.qvel, tau)
    efc = constraints.make_efc(model, kin, st8.qpos, st8.qvel)
    rows = solver.select_rows(model, kin.S, efc, torch.zeros(N_POINTS, constraints.NEFC,
                                                             device=dev), K)
    Y = linalg.tri_solve_lower(sm8.chol, rows.J.transpose(1, 2).contiguous())
    A8 = Y.mT @ Y + torch.diag_embed(rows.R)
    b8 = torch.where(rows.actf > 0.5,
                     rows.aref - (rows.J @ sm8.qacc_smooth[..., None])[..., 0], 0.0)
    f8 = qp.newton_qp(A8, b8, rows.actf, rows.f0, QP["qp_iters"], QP["qp_tol"])
    am8, H8 = qp.implicit_system(A8, f8, rows.actf)
    H8 = H8.repeat_interleave(reps, 0).contiguous()
    print(f"  H {tuple(H8.shape)}: rows at positive force per point "
          f"{[int(x) for x in am8.sum(1)]}", flush=True)
    for dt in (torch.float64, torch.float32):
        Hd = H8.to(dt).contiguous()
        Lk = linalg.cholesky(Hd)
        torch.cuda.synchronize()
        Lp = linalg.cholesky_plain(Hd)
        check(bool(torch.isfinite(Lk).all()), f"cholesky {dt} finite")
        check(bool((torch.triu(Lk, 1) == 0).all()),
              f"cholesky {dt}: L is exactly zero above the diagonal")
        if dt == torch.float64:
            rel = rel_diff(Lk, Lp)
            check(rel <= 1e-12, f"cholesky float64 vs plain: {rel:.3e} <= 1e-12")
            continue
        Lk64 = Lk.double()
        fac = (inf_norm(Lk64 @ Lk64.mT - Hd.double()) / inf_norm(Hd.double())).amax().item()
        check(fac <= 1e-5, f"cholesky float32: |L L^T - H| / |H| {fac:.3e} <= 1e-5")
        ms = cuda_ms(lambda: linalg.cholesky(Hd), 20)
        plain = cuda_ms(lambda: linalg.cholesky_plain(Hd), 3)
        lib = cuda_ms(lambda: torch.linalg.cholesky_ex(Hd)[0], 10)
        # the control: the column kernel through its raw entry point
        Lo = torch.empty_like(Hd)
        cholesky_column_raw(_build, Hd, Lo)
        Lo64 = Lo.double()
        fac_o = (inf_norm(Lo64 @ Lo64.mT - Hd.double()) / inf_norm(Hd.double())).amax().item()
        check(fac_o <= 1e-5, f"cholesky float32, column form: |L L^T - H| / |H| {fac_o:.3e} "
                             "<= 1e-5")
        prev = cuda_ms(lambda: cholesky_column_raw(_build, Hd, Lo), 20)
        # at this size the wrapper's host time per call is as long as the
        # kernel: the two forms are compared by device time alone
        dev_ms = graph_ms(lambda: linalg.cholesky(Hd))
        prev_dev = graph_ms(lambda: cholesky_column_raw(_build, Hd, Lo))
        Bn, n = Hd.shape[:2]
        form = linalg.cholesky_route(n, 4)
        check(dev_ms < prev_dev, f"cholesky: the {form} form ({dev_ms:.4f} ms of device time) "
                                 f"is faster than the column kernel ({prev_dev:.4f} ms) in "
                                 "this call")
        # lower H read, full L written
        bms, by = bound_ms(4 * Bn * (n * (n + 1) / 2 + n * n), Bn * n ** 3 / 3, dt)
        report["E"] = dict(max_abs_err=(Lk - Lp).abs().amax().item(),
                           max_rel_err=rel_diff(Lk, Lp), max_factor_residual=fac, ms=ms,
                           plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                           form=form, previous_ms=prev, device_ms=dev_ms,
                           previous_device_ms=prev_dev)
        print(f"  cholesky[K={n}] f32: kernel {ms:.4f} ms ({form} form; device time alone "
              f"{dev_ms:.4f}), column kernel {prev:.4f} ms (device {prev_dev:.4f}), plain "
              f"{plain:.4f} ms, library {lib:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    # Kernel D at m = n = 75: the cholesky rule's L^-1 dA solves on the same
    # batch (the factors of M at the points, a symmetric right-hand side)
    L9 = sm8.chol.repeat_interleave(reps, 0).contiguous()
    R9 = M8.repeat_interleave(reps, 0).contiguous()
    for dt in (torch.float64, torch.float32):
        Ld, bd = L9.to(dt), R9.to(dt)
        yk = linalg.solve_lower(Ld, bd)
        torch.cuda.synchronize()
        yp = linalg.solve_lower_plain(Ld, bd)
        if dt == torch.float64:
            rel = rel_diff(yk, yp)
            check(rel <= 1e-9, f"solve_lower[m=75] float64 vs plain: {rel:.3e} <= 1e-9")
            continue
        res = rel_residual(Ld, yk, bd)
        check(res <= 1e-5, f"solve_lower[m=75] float32 relative residual {res:.3e} <= 1e-5")
        ms = cuda_ms(lambda: linalg.solve_lower(Ld, bd), 20)
        plain = cuda_ms(lambda: linalg.solve_lower_plain(Ld, bd), 3)
        lib = cuda_ms(lambda: torch.linalg.solve_triangular(Ld, bd, upper=False), 10)
        Bn, n, m = bd.shape
        bms, by = bound_ms(4 * Bn * (n * (n + 1) / 2 + 2 * n * m), Bn * n * n * m, dt)
        report["m=75"] = dict(max_abs_err=(yk - yp).abs().amax().item(),
                              max_rel_err=rel_diff(yk, yp), max_residual=res, ms=ms,
                              plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
        print(f"  solve_lower[m=75, B={Bn}] f32: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)

    # ------------------------------------------- 9. the differentiable path
    print("phase 9: differentiable path (one Jacobian evaluation)", flush=True)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    A9, B9 = jacobians(dyn, x_pts, u_pts)
    torch.cuda.synchronize()
    t_jac = time.time() - t0
    j_chol, j_cfs, j_sl, j_qp, j_e = (fn.launches for fn in counted)
    check(j_cfs == 2 * CFI, f"cho_factor_solve launched {j_cfs} = 2 x {CFI} times")
    check(j_sl == 16 * CFI, f"solve_lower launched {j_sl} = 16 x {CFI} times")
    check(j_qp == CFI and j_e == CFI,
          f"newton_qp and cholesky launched {j_qp}, {j_e} = {CFI} times")
    check(j_chol == 0, f"chol_solve not launched ({j_chol})")
    check(A9.shape == (N_POINTS, reps - model.nu, reps - model.nu)
          and B9.shape == (N_POINTS, reps - model.nu, model.nu)
          and bool(torch.isfinite(A9).all() and torch.isfinite(B9).all()),
          f"Jacobians {tuple(A9.shape)} and {tuple(B9.shape)} finite")
    print(f"  one Jacobian evaluation of {N_POINTS} points x {reps} replicas "
          f"({N_POINTS * reps} systems, {CFI} substeps) in {t_jac:.3f} s on {card} (the "
          "first forward-AD pass of the run)", flush=True)
    # the replication's cost: the same evaluation again, warm, beside one
    # forward-AD pass over the points alone (one tangent direction each)
    t0 = time.time()
    jacobians(dyn, x_pts, u_pts)
    torch.cuda.synchronize()
    t_jac = time.time() - t0
    t0 = time.time()
    with forward_ad.dual_level():
        out = dyn(forward_ad.make_dual(x_pts, torch.ones_like(x_pts)), u_pts)
        ok = bool(torch.isfinite(forward_ad.unpack_dual(out).tangent).all())
    torch.cuda.synchronize()
    t_jvp = time.time() - t0
    check(ok, "a forward-AD pass over the points alone is finite")
    print(f"  warm: one Jacobian evaluation ({N_POINTS * reps} systems) {t_jac:.3f} s, one "
          f"forward-AD pass over the {N_POINTS} points alone {t_jvp:.3f} s: the {reps}x "
          f"replication costs {t_jac / t_jvp:.2f}x the wall time", flush=True)

    # card vs CPU in float64 on a short step
    m64 = {d: registry.default_humanoid(torch.float64, device=d) for d in ("cuda", "cpu")}
    x64, u64 = cmp_points(m64["cpu"])
    jac64, act64 = {}, {}
    for d, m_ in m64.items():
        def dyn64(x, u, m_=m_):
            st = engine.control_step(m_, engine.PhysicsState(x[:, :nq], x[:, nq:]), u,
                                     CMP_CFI)[0]
            return torch.cat([st.qpos, st.qvel], 1)
        xd, ud = x64.to(d), u64.to(d)
        jac64[d] = jacobians(dyn64, xd, ud)
        # the reference loop's QP active set after each substep
        st = engine.PhysicsState(xd[:, :nq], xd[:, nq:])
        carry = engine.pd_cache(m_, st) + (torch.zeros(2, constraints.NEFC, dtype=torch.float64,
                                                        device=d),)
        q_, v_, sets = st.qpos, st.qvel, []
        for _ in range(CMP_CFI):
            q_, v_, M_, C_, fw_ = substep.control_loop(
                m_, q_, v_, *carry, control.pd_target_from_action(m_, ud),
                engine.reset_reference(m_), 1, reference=True)[:5]
            carry = (M_, C_, fw_)
            sets.append(fw_ > 0)
        act64[d] = torch.stack(sets).cpu()
    check(torch.equal(act64["cuda"], act64["cpu"]),
          f"QP active sets equal on card and CPU ({int(act64['cpu'].sum())} rows at positive "
          "force)")
    for name, k in (("df/dx", 0), ("df/du", 1)):
        ref, val = jac64["cpu"][k], jac64["cuda"][k].cpu()
        diff = ((val - ref).abs() / (1.0 + ref.abs())).amax().item()
        check(diff <= 1e-6,
              f"{name} card vs CPU in float64 ({CMP_CFI} substeps): {diff:.3e} <= 1e-6")

    # ------------------------------------------------------------ 10. iLQR
    print("phase 10: ilqr_plan on the card", flush=True)
    cost = lambda x, u, t: (x[:, nq] - 1.0) ** 2 + 1e-3 * (u * u).sum(1)
    term = lambda x: 5.0 * (x[:, nq] - 1.0) ** 2
    u0 = torch.zeros(N_POINTS, model.nu, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    x, J0 = x_pts[:1], 0.0
    for t in range(N_POINTS):
        J0 = J0 + cost(x, u0[t:t + 1], None)
        x = dyn(x, u0[t:t + 1])
    J0 = float(J0 + term(x))
    t_roll = time.time() - t0
    t0 = time.time()
    xs, us, J = ilqr_plan(dyn, cost, term, x_pts[0], u0, ILQRConfig(iterations=ILQR_ITERS))
    J = float(J)
    t_plan = time.time() - t0
    # the planner's own initial rollout is the one above, bit for bit but
    # for the order of the cost's sums
    check(math.isfinite(J) and J <= J0 + 1e-6 * abs(J0), f"iLQR cost {J:.6f} <= initial {J0:.6f}")
    s_iter = (t_plan - t_roll) / ILQR_ITERS
    print(f"  {ILQR_ITERS} iterations over {N_POINTS} control steps in {t_plan:.3f} s "
          f"({s_iter:.3f} s per iteration past the initial rollout of {t_roll:.3f} s) "
          f"on {card}", flush=True)

    # ------------------------------------------------ 11. C and D edge cases
    print("phase 11: kernels C and D on edge cases", flush=True)
    edge_cases(linalg, dev)

    # ------------------------------------------------ 12. A and B edge cases
    print("phase 12: kernels A and B on edge cases", flush=True)
    edge_cases_ab(linalg, qp, dev)

    # ------------------------------------------------------ 13. E edge cases
    print("phase 13: kernel E on edge cases", flush=True)
    edge_cases_e(linalg, dev)

    # ------------------------------------------------------- 14. getup path
    print("phase 14: getup path (Fall init)", flush=True)
    genv = HumanoidGetup(model, GetupConfig(), **QP)

    G_STEPS = 8
    g_run = env_run(genv, G_STEPS, (4 * 2 * CFI, 4 * CFI), counted, action, gen)
    gstate, g_reset_l = g_run["state"], g_run["reset_launches"]
    check(g_reset_l[0] == 3 * 2 * CFI and g_reset_l[3] == 3 * CFI,
          f"reset: the Fall's 3 control steps launched chol_solve {g_reset_l[0]} and "
          f"newton_qp {g_reset_l[3]} times")
    print(f"  {G_STEPS} step_autoresets x {B_MAIN} envs (per-reset Fall: 4 control steps each): "
          f"{g_run['rate']:.1f} env-steps/s; reset(4096) {g_run['reset_ms']:.1f} ms; overflow "
          f"fraction {g_run['overflow']:.5f}, stalled fraction {g_run['stalled']:.5f}; uhc_pd "
          f"speed path in this call {rate:.1f} env-steps/s, on {card}", flush=True)
    # termination while recovering: spend half the counters, step once
    spent = torch.arange(B_MAIN, device=dev) % 2 == 0
    probe = dataclasses.replace(gstate, task=dataclasses.replace(
        gstate.task, recovery_counter=torch.where(spent, 0, gstate.task.recovery_counter)))
    probe = genv.step(probe, action(B_MAIN))
    check(not bool((probe.terminated & ~spent).any()) and bool(probe.terminated[spent].any()),
          f"with half the recovery counters spent, only those envs terminate "
          f"({int(probe.terminated[spent].sum())} of {int(spent.sum())} at the floor)")
    t0 = time.time()
    penv = HumanoidGetup(model, GetupConfig(fall_init_pool=B_MAIN), **QP)
    torch.cuda.synchronize()
    pool_s = time.time() - t0
    p_run = env_run(penv, 4, (2 * CFI, CFI), counted, action, gen)
    check(sum(p_run["reset_launches"]) == 0,
          f"reset from the pool launches no kernel ({p_run['reset_launches']})")
    print(f"  Fall pool of {B_MAIN} built in {pool_s:.3f} s; 4 step_autoresets from the pool: "
          f"{p_run['rate']:.1f} env-steps/s (reset {p_run['reset_ms']:.1f} ms), overflow "
          f"{p_run['overflow']:.5f}, stalled {p_run['stalled']:.5f}", flush=True)

    # ---------------------------------- 15. Kernels A and B on getup inputs
    print("phase 15: kernels A and B against their plain versions (getup inputs)", flush=True)
    g_inputs = substep_inputs(model, gstate, action(B_MAIN))
    report["getup"] = hold_a_b("getup ", g_inputs)
    report["getup"]["full_rows"] = g_inputs["full_rows"]

    # ------------------------------------------------ 16. reach, obs v2
    print("phase 16: reach path with observation v2", flush=True)
    renv = HumanoidReach(model, ReachConfig(self_obs_v=2), **QP)
    check(renv.obs_size == obs_mod.self_obs_size(24, 2, True) + 3,
          f"reach obs width {renv.obs_size} = self_obs_size(24, 2, True) + 3")
    r_run = env_run(renv, 4, (2 * CFI, CFI), counted, action, gen)
    print(f"  4 step_autoresets x {B_MAIN} envs: {r_run['rate']:.1f} env-steps/s, overflow "
          f"{r_run['overflow']:.5f}, stalled {r_run['stalled']:.5f}", flush=True)

    # ------------------------------------------------ 17. perturbation hooks
    print("phase 17: ext_force and projectiles", flush=True)
    stand = engine.PhysicsState(model.qpos0[None].repeat(B_MAIN, 1),
                                torch.zeros(B_MAIN, model.nv, device=dev))
    stand.qpos[:, 2] = 0.92
    rad = torch.full((B_MAIN, 1), 0.12, device=dev)
    inv = torch.full((B_MAIN, 1), 0.5, device=dev)
    zero_act = torch.zeros(B_MAIN, model.nu, device=dev)
    heading = torch.rand(B_MAIN, generator=gen, device=dev) * 2 * math.pi
    push = torch.zeros(B_MAIN, model.nbody, 3, device=dev)
    push[:, 0, 0], push[:, 0, 1] = 50.0 * torch.cos(heading), 50.0 * torch.sin(heading)

    def perturbed(ball_vx, ext):
        """25 control steps of 5 substeps from the standing pose, zero
        actions, one ball per env from (1.2, -0.2, 0.85) (tests/test_projectiles.py)."""
        st = stand
        cache = engine.pd_cache(model, st) + (torch.zeros(B_MAIN, constraints.NEFC, device=dev),)
        pp = torch.tensor([1.2, -0.2, 0.85], device=dev).repeat(B_MAIN, 1, 1)
        pv = torch.tensor([ball_vx, 0.0, 0.0], device=dev).repeat(B_MAIN, 1, 1)
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(25):
            st, _, _, cache, (pp, pv) = engine.control_step(
                model, st, zero_act, 5, cache, ext_force=ext, proj=(pp, pv, rad, inv), **QP)
        torch.cuda.synchronize()
        ms = (time.time() - t0) / 25 * 1e3
        check(bool(torch.isfinite(st.qpos).all() & torch.isfinite(pv).all()),
              "perturbed state finite")
        return st, pv, ms, [fn.launches for fn in counted]

    still, _, _, _ = perturbed(0.0, None)
    hit, pv_hit, ms_hit, l_hit = perturbed(-10.0, None)
    shoved, _, ms_push, l_push = perturbed(0.0, push)
    check(l_hit[0] == 25 * 5 * 2 and l_hit[3] == 25 * 5 and sum(l_hit) == 25 * 5 * 3,
          f"projectile run: chol_solve {l_hit[0]} = 250, newton_qp {l_hit[3]} = 125 launches")
    check(float(pv_hit[:, 0, 0].min()) > -9.0,
          f"the ball does not pass through: final x-velocity >= "
          f"{float(pv_hit[:, 0, 0].min()):.3f} > -9")
    dx = hit.qpos[:, 0] - still.qpos[:, 0]
    check(float(dx.max()) < -0.05, f"the ball shoves the root along -x by at least "
                                   f"{-float(dx.max()):.4f} m > 0.05 against the undisturbed run")
    along = ((shoved.qpos[:, :2] - still.qpos[:, :2])
             * torch.stack([torch.cos(heading), torch.sin(heading)], 1)).sum(1)
    check(float(along.min()) > 0.0, f"the 50 N push moves the root along it in every env "
                                    f"(at least {float(along.min()):.4f} m)")
    print(f"  {B_MAIN} envs x 25 control steps of 5 substeps: {ms_hit:.1f} ms per control step "
          f"with a ball, {ms_push:.1f} ms with ext_force; root shoved by the ball "
          f"{-float(dx.mean()):.4f} m on average, by the push {float(along.mean()):.4f} m; "
          f"ball x-velocity at the end {float(pv_hit[:, 0, 0].mean()):.3f} m/s", flush=True)
    # card vs CPU with both hooks, 16 envs from Fall init states, a ball
    # thrown at each root, 2 control steps of PERTURB_CMP_CFI substeps. The
    # Fall states are chaotic: on the CPU, over 64 of them, two float32 runs
    # 1e-6 apart part by 0.04 after 2 control steps of 15 substeps even at
    # zero actions (a float32 and a float64 run by 0.06), which would
    # measure the chaos, not the card (an earlier check over 15 substeps
    # read 2.674e-02 here); after 2 of 3 substeps at half-scale actions
    # they part by 2e-5 to 6e-5 (float32 vs float64: 1.2e-5)
    fst = genv.reset(n, gen).phys
    cache_g = engine.pd_cache(model, fst) + (torch.zeros(n, constraints.NEFC, device=dev),)
    pp = (fst.qpos[:, None, :3] + torch.tensor([0.25, 0.0, 0.0], device=dev)).contiguous()
    pv = torch.tensor([-10.0, 0.0, 0.0], device=dev).repeat(n, 1, 1)
    ext = push[:n]
    hooks_gpu = dict(ext_force=ext, proj=(pp, pv, rad[:n], inv[:n]))
    hooks_cpu = dict(ext_force=ext.cpu(), proj=(pp.cpu(), pv.cpu(), rad[:n].cpu(),
                                                inv[:n].cpu()))
    st_gpu, st_cpu = fst, engine.PhysicsState(fst.qpos.cpu(), fst.qvel.cpu())
    cache_cpu = tuple(x.cpu() for x in cache_g)
    for _ in range(2):
        act = 0.5 * action(n)
        st_gpu, _, _, cache_g, pr_gpu = engine.control_step(
            model, st_gpu, act, PERTURB_CMP_CFI, cache_g, **hooks_gpu, **QP)
        st_cpu, _, _, cache_cpu, pr_cpu = engine.control_step(
            cpu_model, st_cpu, act.cpu(), PERTURB_CMP_CFI, cache_cpu, **hooks_cpu, **QP)
        hooks_gpu["proj"] = pr_gpu + (rad[:n], inv[:n])
        hooks_cpu["proj"] = pr_cpu + (rad[:n].cpu(), inv[:n].cpu())
    diff = ((st_gpu.qpos.cpu() - st_cpu.qpos).abs() / (1.0 + st_cpu.qpos.abs())).amax().item()
    pdiff = ((pr_gpu[0].cpu() - pr_cpu[0]).abs() / (1.0 + pr_cpu[0].abs())).amax().item()
    check(diff <= 5e-3 and pdiff <= 5e-3,
          f"card vs CPU with ext_force and a ball, from Fall init states, 2 control steps of "
          f"{PERTURB_CMP_CFI} substeps: qpos {diff:.3e}, ball position {pdiff:.3e} <= 5e-3")
    met = ((pr_cpu[1][:, 0, 0] + 10.0).abs() > 1.0).float().mean().item()
    check(met >= 0.75, f"the balls met their humanoids in {met:.3f} >= 0.75 of the envs "
                       "(x-velocity moved by more than 1 m/s)")

    ucfg = PPOConfig(num_envs=64, horizon=8, policy_widths=(64, 64), value_widths=(64, 64))
    tr = trainer_and_planner(model, dev, counted, card, RunConfig(num_epochs=2, save_frequency=1),
                             ucfg, CEMConfig())
    ppo_l, eval_l, cem_l, ppo_sec, plan_s = (tr[k] for k in ("ppo_l", "eval_l", "cem_l",
                                                              "ppo_sec", "plan_s"))
    pcfg = RunConfig().learning
    report["trainer"] = tr["report"]
    trainer_chol = [k for k in report["trainer"] if k.startswith("m=")]

    bp = body_paths(dev, counted, card, rate, gen)
    report["beta"], report["smplx"] = bp["beta"], bp["smplx"]
    s7 = slice7_paths(model, dev, counted, card, rate, gen)
    report.update(s7["report"])
    mp = motion_paths(model, dev, counted, card)
    par = parallel_paths(dev, counted, card, ucfg, ppo_sec, plan_s)
    pg = product_gate_paths(dev, counted)

    # ---------------------------------------------------------------- report
    per_step = lambda c: c / STEPS
    mean = lambda cases, k: sum(report[c][k] for c in cases) / len(cases)
    d_names = list(d_cases)
    runs4 = {"getup": g_run, "getup_pool": p_run, "reach": r_run, "beta": bp["b_run"],
             "smplx": bp["x_run"], "aba_route": s7["aba"], "aba_dense": s7["aba_dense"],
             "nv_gym": s7["nv"], "domain_rand": s7["dr"], "move": s7["move"],
             "playback": mp["playback"]}
    names = ("chol_solve", "cho_factor_solve", "solve_lower", "newton_qp", "cholesky")
    ball = dict(zip(names, l_hit))
    x64 = dict(zip(names, bp["x64_launches"]))

    ppo_c, eval_c, cem_c = (dict(zip(names, x)) for x in (ppo_l, eval_l, cem_l))
    nccl_c = dict(zip(names, par["nccl_l"]))
    gloo_c = [[dict(zip(names, it)) for it in rank] for rank in par["gloo_l"]]
    plan2_c = [dict(zip(names, x)) for x in par["plan_l"]]

    def paths(uhc, torque, jac, name):
        """Launch counts of kernel `name` on every counted run of the main
        path: phases 3, 6 and 9, then 14, 16 and 17's projectile run, 18's
        two PPO iterations and eval rollout, 19's plan, 20's β batch and
        21's SMPLX runs (its float64 step too), 22's two routes, 23's
        NvHumanoid, 24's domain-randomized and 25's HumanoidMove runs, 28's
        playback (no launch), 31's sharded iteration, and 32's iterations
        and 33's plan on every rank, and 34's four gate runs."""
        new = sum(r.get(name, 0) for r in runs4.values()) + ball[name] + x64[name]
        sharded = (nccl_c[name] + sum(it[name] for rank in gloo_c for it in rank)
                   + sum(c[name] for c in plan2_c))
        gate = {k: c[name] for k, c in pg["launches"].items()}
        return dict(
            launches=uhc + torque + jac + new + ppo_c[name] + eval_c[name] + cem_c[name]
            + sharded + sum(gate.values()),
            launches_per_control_step={"uhc_pd": per_step(uhc), "torque": per_step(torque),
                                       "projectile": ball[name] / 25,
                                       "eval": eval_c[name] / 8,
                                       "smplx_float64": x64[name]},
            launches_per_jacobian=jac,
            launches_per_step_autoreset={k: r["per_step"].get(name, 0)
                                         for k, r in runs4.items()},
            launches_per_ppo_iteration=ppo_c[name] / 2,
            launches_per_cem_plan=cem_c[name],
            launches_per_sharded_ppo_iteration_per_rank={
                "nccl_world_1": nccl_c[name],
                "gloo_world_2": [[it[name] for it in rank] for rank in gloo_c]},
            launches_per_sharded_cem_plan_per_rank=[c[name] for c in plan2_c],
            launches_per_gate_run=gate)
    kernels = [
        dict(name="chol_solve", route="cuda", source="smplsim_tpu_torch/ops/csrc/chol_solve.cu",
             replaces="smplsim_tpu/ops/linalg_kernels.py:334",
             **paths(n_chol, t_chol, j_chol, "chol_solve"),
             # the main path calls it once at each shape per substep: the
             # numbers are the mean of one launch of each
             **{k: mean(("m=1,diag", "m=33"), k)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             **{k: max(report["m=1,diag"][k], report["m=33"][k])
                for k in ("max_abs_err", "max_rel_err")},
             bound_by=report["m=33"]["bound_by"],
             shapes={**{k: report[k] for k in ("m=1,diag", "m=33")},
                     **{f"getup {k}": report["getup"][k] for k in ("m=1,diag", "m=33")},
                     **{f"trainer {k}": report["trainer"][k] for k in trainer_chol},
                     **{f"{p} {k}": report[p][k] for p in ("beta", "smplx", "dr")
                        for k in ("m=1,diag", "m=33")},
                     "smplx float64 m=65": bp["smplx_f64_m65"],
                     **{f"gate float64 B=1 step {t} {k}": pg["hold"][t][k]
                        for t in GATE_HOLD_STEPS for k in ("m=1,diag", "m=65")}},
             aba_elimination=report["aba"]),
        dict(name="newton_qp", route="cuda", source="smplsim_tpu_torch/ops/csrc/newton_qp.cu",
             replaces="smplsim_tpu/ops/qp_kernel.py:256", **paths(n_qp, t_qp, j_qp, "newton_qp"),
             **report["qp"], shapes={"uhc_pd": report["qp"], "torque": report["qp_torque"],
                                     "getup": {**report["getup"]["qp"],
                                               "full_rows": report["getup"]["full_rows"]},
                                     "trainer": {**report["trainer"]["qp"],
                                                 "full_rows": report["trainer"]["full_rows"]},
                                     **{p: {**report[p]["qp"], "full_rows": report[p]["full_rows"]}
                                        for p in ("beta", "smplx", "dr")},
                                     **{f"gate float64 B=1 step {t}": pg["hold"][t]["qp"]
                                        for t in GATE_HOLD_STEPS}}),
        dict(name="cho_factor_solve", route="cuda",
             source="smplsim_tpu_torch/ops/csrc/cho_factor_solve.cu",
             replaces="smplsim_tpu/ops/linalg_kernels.py:104",
             **paths(n_cfs, t_cfs, j_cfs, "cho_factor_solve"),
             **report["C"]),
        dict(name="solve_lower", route="cuda", source="smplsim_tpu_torch/ops/csrc/solve_lower.cu",
             replaces="smplsim_tpu/ops/linalg_kernels.py:423",
             **paths(n_sl, t_sl, j_sl, "solve_lower"),
             # the torque path launches it once at each shape per substep:
             # the numbers are the mean of one launch of each
             **{k: mean(d_names, k) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             **{k: max(report[c][k] for c in d_names)
                for k in ("max_abs_err", "max_rel_err", "max_residual")},
             bound_by=report[d_names[0]]["bound_by"],
             shapes={k: report[k] for k in d_names + ["m=75"]}),
        dict(name="cholesky", route="cuda",
             source="smplsim_tpu_torch/ops/csrc/cho_factor_solve.cu",
             replaces="smplsim_tpu/ops/linalg_kernels.py:410", **paths(n_e, t_e, j_e, "cholesky"),
             **report["E"]),
    ]
    print(f"jacobian: {N_POINTS * reps} systems in {t_jac:.3f} s; ilqr: {s_iter:.3f} s per "
          f"iteration; env-steps/s: speed {rate:.1f}, getup {g_run['rate']:.1f} (pool "
          f"{p_run['rate']:.1f}), reach {r_run['rate']:.1f}; PPO iteration (epoch 2): rollout "
          f"{ppo_sec['rollout']:.3f} s + update {ppo_sec['update']:.3f} s, "
          f"{pcfg.num_envs * pcfg.horizon / (ppo_sec['rollout'] + ppo_sec['update']):.1f} "
          f"training env-steps/s; CEM: {plan_s:.3f} s per plan; β batch "
          f"{bp['b_run']['rate']:.1f}, SMPLX {bp['x_run']['rate']:.1f} env-steps/s; ABA route "
          f"{s7['aba']['rate']:.1f} beside dense {s7['aba_dense']['rate']:.1f}, NvHumanoid "
          f"{s7['nv']['rate']:.1f}, DomainRandEnv {s7['dr']['rate']:.1f}, HumanoidMove "
          f"{s7['move']['rate']:.1f} env-steps/s; motion library: {mp['load']['frames']} frames "
          f"loaded in {mp['load']['seconds']:.3f} s ({mp['load']['table_bytes']} bytes of tables), "
          f"{mp['sampling']['get_motion_state']['states_per_s']:.1f} states/s blended, "
          f"{mp['sampling']['get_motion_state_intervaled']['states_per_s']:.1f} nearest; "
          f"playback {mp['playback']['rate']:.1f} env-steps/s, physics FK vs library mpjpe_g "
          f"mean {mp['playback']['mpjpe_g_mean']:.4e} max {mp['playback']['mpjpe_g_max']:.4e} mm; "
          f"fit {mp['fit']['seconds_100']:.3f} s (100 steps, ratio {mp['fit']['ratio_100']:.4f}), "
          f"{mp['fit']['seconds_default']:.3f} s (200); TF32 card vs CPU pinned "
          f"{tf32['pinned']:.3e}, unpinned {tf32['unpinned']:.3e}; sharded PPO iteration: "
          f"NCCL world of 1 {par['nccl_s']:.3f} s (phase 18 {par['phase18_s']:.3f} s), gloo 2 "
          f"ranks {[max(s) for s in zip(*par['gloo_s'])]} s; sharded CEM plan 2 x "
          f"{CEM_RANK_SAMPLES} samples {par['plan_s']:.3f} s", flush=True)
    print(f"product gate: " + "; ".join(f"{k} {v:.1f} s" for k, v in pg["seconds"].items()),
          flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    sharded = {k: par[k] for k in ("nccl_s", "phase18_s", "unsharded_s", "nccl_halves",
                                   "nccl_allreduce_ms", "gloo_s", "gloo_halves",
                                   "gloo_allreduce_ms", "plan_s", "update_gap")}
    gate = {k: pg[k] for k in ("records", "launches", "seconds")}
    print(json.dumps({"kernels": kernels, "card": card, "motion": mp, "tf32": tf32,
                      "sharded": sharded, "product_gate": gate}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
