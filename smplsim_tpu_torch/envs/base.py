"""Batched humanoid environment (port of smplsim_tpu/envs/base.py).

An env holds the model and its static configuration; its state is an
EnvState of batch-first tensors, one row per environment:

    state = env.reset(batch, generator)
    state = env.step_autoreset(state, action)

Semantics follow the JAX package (and the reference simulator it mirrors):

  * one control step = control_frequency_inv (15) physics substeps at 450 Hz;
    in the uhc_pd control mode (the default) the stable-PD torque is
    recomputed every substep, in the torque mode the action scaled by
    power_scale * torque_lim and clipped is the joint torque of all of them;
  * Default init: qpos = 0 except z = 0.94 and root quat (.5,.5,.5,.5);
    Fall init: the drop pose (qpos = 0 except z = 0.3 and root quat
    (1,0,0,0)) and 3 control steps of uniform random actions in
    [-0.5, 0.5]; with fall_init_pool > 0 a pool of Fall states is simulated
    once at construction and resets draw rows from it;
  * step ordering: update_task -> cache the root -> physics -> cur_t += 1
    -> obs -> reward -> termination flags -> task_termination;
  * termination: a floor contact of a geom outside contact_bodies, unless
    the task's task_termination hook suppresses it; truncation once cur_t
    exceeds episode_length;
  * step_autoreset: envs that finished are replaced by a fresh reset, keeping
    the finishing step's reward, flags and info. The reset is computed for
    every env and selected where done, as the JAX package's vmapped
    step_autoreset does: with the per-reset Fall init a step_autoreset runs
    4 control steps (the pool is the cure).

The env's randomness is the torch.Generator it was reset with, carried in
EnvState.rng; it must live on the model's device.

An env on a stacked model of N rows (models/spec.py: each env its own
body, e.g. N β bodies, `tile_model` to repeat them over a larger batch)
steps batches of exactly N and raises on any other; all N timesteps must be
equal. `reset`, `step` and `step_autoreset` take a `model=` of the env's
topology for one call (the JAX package's hook): a stacked model of one row
per env carries a per-env physical realization in the caller's state
(envs/domain_rand.py), and the bad-state reset reference is recomputed for
it. Its Fall pool is simulated on the bodies repeated in order (a pool
size that N divides), and env i resets from the pool states of its own
body.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from smplsim_tpu_torch.envs import obs as obs_mod
from smplsim_tpu_torch.models.spec import RobotModel, check_batch, tile_model
from smplsim_tpu_torch.physics import constraints, engine, kinematics, solver
from smplsim_tpu_torch.physics.engine import PhysicsState


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static env configuration (the JAX package's EnvConfig). control_mode
    is "uhc_pd", "torque" or "default" (engine.control_step); power_scale
    scales the torque mode's action; self_obs_v picks observation v1 or v2;
    state_init is "Default" or "Fall". kp_scale and kd_scale are the
    reference config's gain scales: the env does not pass them to the
    physics, as the JAX package's does not (control.stable_pd_torque takes
    them)."""

    episode_length: int = 300
    sim_timestep_inv: int = 450
    control_frequency_inv: int = 15
    power_scale: float = 10.0
    root_height_obs: bool = True
    enable_early_termination: bool = True
    self_obs_v: int = 1
    kp_scale: float = 1.0
    kd_scale: float = 1.0
    clip_actions: bool = True
    control_mode: str = "uhc_pd"
    contact_bodies: Tuple[str, ...] = ("R_Ankle", "L_Ankle", "R_Toe", "L_Toe")
    state_init: str = "Default"
    # > 0: simulate this many Fall states once, at construction, from a
    # generator seeded with fall_pool_seed, and reset from the pool
    fall_init_pool: int = 0
    fall_pool_seed: int = 0

    @property
    def dt(self) -> float:
        return self.control_frequency_inv / self.sim_timestep_inv


@dataclasses.dataclass
class EnvState:
    """Complete batched env state: everything the next step needs."""

    phys: PhysicsState
    obs: torch.Tensor          # (B, obs_size)
    reward: torch.Tensor       # (B,)
    terminated: torch.Tensor   # (B,) bool
    truncated: torch.Tensor    # (B,) bool
    cur_t: torch.Tensor        # (B,) int32 control steps since reset
    task: Any                  # task state (None for the plain env)
    info: dict                 # power, nactive, overflow, stalled; (B,) each
    pd_cache: tuple | None     # uhc_pd: (M, C, efc_force) of the last substep
    kin: kinematics.Kin        # FK of phys.qpos
    rng: torch.Generator       # drawn from by task samples and resets
    proj: Any = None           # free projectile spheres (pos, vel); None here

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated


def select(mask: torch.Tensor, a, b):
    """Row-wise where over matching EnvState trees: a where mask (B,) is set,
    else b. Non-tensor leaves (the generator, None) come from b."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(b, **{
            f.name: select(mask, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    if isinstance(a, (tuple, list)):
        return type(b)(select(mask, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return {k: select(mask, a[k], b[k]) for k in b}
    return b


def map_state(fn, tree):
    """Apply fn to every tensor and generator leaf of an EnvState tree
    (dataclasses, tuples, lists, dicts), in field order; other leaves (None)
    are kept."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_state(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_state(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: map_state(fn, v) for k, v in tree.items()}
    return tree


def clone_generator(gen: torch.Generator) -> torch.Generator:
    """A generator on gen's device at gen's state: draws from it leave gen
    where it was."""
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


class HumanoidEnv:
    """Plain humanoid env (no task): reward 0, truncate on episode length.

    qp_iters / qp_rows / qp_tol / keeps override the SMPLSIM_QP_ITERS /
    SMPLSIM_QP_ROWS / SMPLSIM_QP_TOL / SMPLSIM_*_KEEP knobs for this env."""

    def __init__(self, model: RobotModel, config: EnvConfig | None = None, *,
                 qp_iters: int | None = None, qp_rows: int | None = None,
                 qp_tol: float | None = None, keeps=None):
        self.model = model
        self.config = config or EnvConfig()
        steps = model.timestep.reshape(-1)
        if not bool((steps == steps[0]).all()):
            raise ValueError("the rows of a stacked model must share one timestep")
        ts = float(steps[0])
        if round(1.0 / ts) != self.config.sim_timestep_inv:
            raise ValueError(f"model timestep {ts:.6f} != 1/{self.config.sim_timestep_inv}")
        legal_bodies = {model.body_names.index(n) for n in self.config.contact_bodies}
        self._legal_floor_geom = torch.as_tensor(
            np.asarray([b in legal_bodies for b in model.geom_body]), device=model.device)
        self._reset_ref = engine.reset_reference(model)
        self._qp = dict(qp_iters=qp_iters, qp_rows=qp_rows, qp_tol=qp_tol, keeps=keeps)
        rows = solver.COMPACT_ROWS if qp_rows is None else qp_rows
        self._qp_rows = min(rows, constraints.NEFC)
        self._fall_pool = None
        if self.config.state_init == "Fall" and self.config.fall_init_pool > 0:
            pool = self.config.fall_init_pool
            if model.stacked and pool % model.num_stacked:
                raise ValueError(f"fall_init_pool {pool} is not a multiple of the "
                                 f"{model.num_stacked} rows of the stacked model")
            gen = torch.Generator(device=model.device).manual_seed(self.config.fall_pool_seed)
            self._fall_pool = self.fall_phys(
                self._fall_actions(pool, gen),
                tile_model(model, pool) if model.stacked else None)

    # ---------------- sizes ----------------
    @property
    def action_size(self) -> int:
        return self.model.nu

    @property
    def task_obs_size(self) -> int:
        return 0

    @property
    def obs_size(self) -> int:
        return self.self_obs_size + self.task_obs_size

    @property
    def self_obs_size(self) -> int:
        return obs_mod.self_obs_size(self.model.nbody, self.config.self_obs_v,
                                     self.config.root_height_obs)

    @property
    def upright_start(self) -> bool:
        # the baked humanoid carries the SMPL base rotation
        return False

    # ---------------- task hooks (overridden by tasks) ----------------
    def init_task(self, batch: int) -> Any:
        return None

    def reset_task(self, generator: torch.Generator, task: Any, cur_t: torch.Tensor) -> Any:
        return task

    def update_task(self, generator: torch.Generator, task: Any, cur_t: torch.Tensor) -> Any:
        return task

    def task_obs(self, task: Any, phys: PhysicsState, kin: kinematics.Kin) -> torch.Tensor:
        return phys.qpos[:, :0]

    def pre_physics(self, task: Any, phys: PhysicsState, kin: kinematics.Kin) -> Any:
        return task

    def reward(self, task: Any, phys: PhysicsState, kin: kinematics.Kin,
               action: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(phys.qpos[:, 0])

    def task_termination(self, task: Any, terminated: torch.Tensor):
        """Gate termination on the task state; returns (task, terminated)."""
        return task, terminated

    # ---------------- core ----------------
    def _fall_actions(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        """(3,B,nu) uniform draws in [-0.5, 0.5] for the Fall init."""
        m = self.model
        return torch.rand((3, batch, m.nu), generator=generator, dtype=m.dtype,
                          device=m.device) - 0.5

    def fall_phys(self, actions: torch.Tensor, model: RobotModel | None = None) -> PhysicsState:
        """The Fall init under explicit actions (3,B,nu): from the drop pose
        (z = 0.3, root quat (1,0,0,0), joints at 0, at rest), one control
        step of the env's control mode per action row, the stable-PD cache
        primed at the drop pose with a cold warm start. `model` replaces the
        env's (the Fall pool's tiled bodies)."""
        cfg = self.config
        m = self.model if model is None else model
        B = actions.shape[1]
        qpos = torch.zeros((B, m.nq), dtype=m.dtype, device=m.device)
        qpos[:, 2] = 0.3
        qpos[:, 3] = 1.0
        phys = PhysicsState(qpos, torch.zeros((B, m.nv), dtype=m.dtype, device=m.device))
        cache = self._fresh_cache(phys, m)
        reset_ref = self._reset_ref if m is self.model else None
        for a in actions:
            phys, _, _, cache = engine.control_step(
                m, phys, a, control_freq_inv=cfg.control_frequency_inv, cache=cache,
                reset_ref=reset_ref, **self._qp, control_mode=cfg.control_mode,
                power_scale=cfg.power_scale)
        return phys

    def _fresh_cache(self, phys: PhysicsState, model: RobotModel | None = None):
        """uhc_pd: (M, C) at phys with a cold warm start; None otherwise."""
        if self.config.control_mode != "uhc_pd":
            return None
        m = self.model if model is None else model
        return engine.pd_cache(m, phys) + (
            torch.zeros((phys.qpos.shape[0], constraints.NEFC), dtype=m.dtype, device=m.device),)

    def _init_phys(self, batch: int, generator: torch.Generator,
                   model: RobotModel | None = None) -> PhysicsState:
        m = self.model if model is None else model
        cfg = self.config
        if cfg.state_init == "Fall":
            if self._fall_pool is None or m is not self.model:
                return self.fall_phys(self._fall_actions(batch, generator), model)
            if m.stacked:
                # env i draws among the pool states of body i
                k = torch.randint(0, cfg.fall_init_pool // batch, (batch,), generator=generator,
                                  device=m.device)
                i = k * batch + torch.arange(batch, device=m.device)
            else:
                i = torch.randint(0, cfg.fall_init_pool, (batch,), generator=generator,
                                  device=m.device)
            return PhysicsState(self._fall_pool.qpos[i], self._fall_pool.qvel[i])
        if cfg.state_init != "Default":
            raise NotImplementedError(cfg.state_init)
        qpos = torch.zeros((batch, m.nq), dtype=m.dtype, device=m.device)
        qpos[:, 2] = 0.94
        qpos[:, 3:7] = 0.5
        return PhysicsState(qpos, torch.zeros((batch, m.nv), dtype=m.dtype, device=m.device))

    def compute_obs(self, task: Any, phys: PhysicsState, kin: kinematics.Kin,
                    model: RobotModel | None = None) -> torch.Tensor:
        cfg = self.config
        model = self.model if model is None else model
        body_rot = kinematics.body_quats(model, phys.qpos)
        if cfg.self_obs_v == 1:
            prop = obs_mod.compute_self_obs_v1(
                phys.qvel, kin.xpos, body_rot, self.upright_start,
                cfg.root_height_obs, self.model.humanoid_type)
        elif cfg.self_obs_v == 2:
            lin, ang = kinematics.body_velocities(model, kin, phys.qvel)
            prop = obs_mod.compute_self_obs_v2(
                kin.xpos, body_rot, lin, ang, self.upright_start,
                cfg.root_height_obs, self.model.humanoid_type)
        else:
            raise NotImplementedError(f"self_obs_v {cfg.self_obs_v}")
        return torch.cat([prop, self.task_obs(task, phys, kin)], dim=1)

    def reset(self, batch: int, generator: torch.Generator,
              model: RobotModel | None = None) -> EnvState:
        """Fresh states for `batch` envs: task first, then the humanoid; in
        uhc_pd mode the stable-PD cache is the fresh (M, C) at the init state
        (the reference's forward pass after a reset) with a cold constraint
        warm start, in the other modes None. `model` replaces the env's for
        this call: a stacked model of `batch` rows carries a per-env
        physical realization (envs/domain_rand.py); the static topology must
        be the env's."""
        m = self.model if model is None else model
        check_batch(m, batch)
        dev = m.device
        cur_t = torch.zeros(batch, dtype=torch.int32, device=dev)
        task = self.reset_task(generator, self.init_task(batch), cur_t)
        phys = self._init_phys(batch, generator, model)
        kin = kinematics.fk(m, phys.qpos)
        obs = self.compute_obs(task, phys, kin, m)
        cache = self._fresh_cache(phys, m)
        zeros = torch.zeros(batch, dtype=m.dtype, device=dev)
        false = torch.zeros(batch, dtype=torch.bool, device=dev)
        return EnvState(
            phys=phys, obs=obs, reward=zeros, terminated=false, truncated=false,
            cur_t=cur_t, task=task,
            info={"power": zeros, "nactive": cur_t, "overflow": false, "stalled": false},
            pd_cache=cache, kin=kin, rng=generator)

    def _reset_ref_for(self, model: RobotModel):
        """The bad-state reset reference: the env's, or, for another model,
        recomputed (the JAX package's `reset_ref=None`)."""
        return self._reset_ref if model is self.model else engine.reset_reference(model)

    def step(self, state: EnvState, action: torch.Tensor,
             model: RobotModel | None = None) -> EnvState:
        """One control step of every env; `model` as in `reset`."""
        cfg = self.config
        m = self.model if model is None else model
        check_batch(m, action.shape[0])
        action = action.to(state.phys.qpos.dtype)
        if cfg.clip_actions:
            action = action.clamp(-1.0, 1.0)

        task = self.update_task(state.rng, state.task, state.cur_t)
        task = self.pre_physics(task, state.phys, state.kin)

        phys, lean, power, cache = engine.control_step(
            m, state.phys, action, control_freq_inv=cfg.control_frequency_inv,
            cache=state.pd_cache, reset_ref=self._reset_ref_for(m), **self._qp,
            control_mode=cfg.control_mode, power_scale=cfg.power_scale)

        cur_t = state.cur_t + 1
        kin = kinematics.fk(m, phys.qpos)
        obs = self.compute_obs(task, phys, kin, m)
        rew = self.reward(task, phys, kin, action)
        truncated = cur_t > cfg.episode_length
        illegal = lean.geom_floor_contact & ~self._legal_floor_geom
        terminated = illegal.any(1) & cfg.enable_early_termination
        task, terminated = self.task_termination(task, terminated)
        return EnvState(
            phys=phys, obs=obs, reward=rew, terminated=terminated, truncated=truncated,
            cur_t=cur_t, task=task,
            # overflow: a substep had more active rows than the compact solve
            # holds, so its shallowest rows were dropped
            info={"power": power, "nactive": lean.nactive_max,
                  "overflow": lean.nactive_max > self._qp_rows,
                  "stalled": lean.stalled_any},
            pd_cache=cache, kin=kin, rng=state.rng)

    def step_autoreset(self, state: EnvState, action: torch.Tensor,
                       model: RobotModel | None = None) -> EnvState:
        """Step, then reset every env that finished (terminated or
        truncated). Their reward, flags and info are the finishing step's;
        phys, obs, task and caches come from the reset; `model` as in
        `reset`."""
        nxt = self.step(state, action, model)
        fresh = self.reset(nxt.cur_t.shape[0], nxt.rng, model)
        fresh = dataclasses.replace(
            fresh, reward=nxt.reward, terminated=nxt.terminated,
            truncated=nxt.truncated, info=nxt.info)
        return select(nxt.done, fresh, nxt)
