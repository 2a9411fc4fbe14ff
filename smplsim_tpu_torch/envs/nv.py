"""The Isaac-path humanoid, batched (port of smplsim_tpu/envs/nv.py):
max-coords observations, the observation history, freeze masks, per-body
termination heights, reward 1, impulse perturbations and thrown
projectiles.

Observations (one row per env):
  * compute_obs_max      the heading-local max-coords observation;
  * compute_obs_max_v2   its time-stacked form over a BodyHistory window,
                         every frame in the CURRENT heading frame relative
                         to the current root;
  * dof_to_obs_smpl      exp-map hinge triples -> 6-D rotation entries;
  * compute_obs_reduced  reduced coordinates (root, dof obs, key bodies).

Control: freeze_hand / freeze_toe / remove_neck zero the PD target of the
masked joints (engine.control_step(pd_target_mask=)).

Termination: fall = (a body outside contact_bodies touches the floor) AND
(a body outside contact_bodies below its termination height), after the
first control steps (cur_t > 1); the head's height is raised to
head_termination_height. Truncation is the nv rule, cur_t >=
episode_length - 1, not the base env's cur_t > episode_length.

Randomness (torch.Generator in EnvState.rng): every step draws each env's
impulse (a body, a direction and a magnitude) and throw (a bearing, a
height and a speed factor per sphere), and applies them where their
interval is due. The draws are two methods, `_impulse_draws` and
`_throw_draws`, so a caller can feed its own (the tests feed the JAX
package's key draws).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import torch

from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.envs.base import EnvConfig, EnvState, HumanoidEnv
from smplsim_tpu_torch.models.spec import RobotModel, check_batch
from smplsim_tpu_torch.physics import engine, kinematics
from smplsim_tpu_torch.physics.engine import PhysicsState


# ---------------------------------------------------------------------------
# observation functions (batched: a leading env axis)
# ---------------------------------------------------------------------------
def dof_to_obs_smpl(dof_pos: torch.Tensor) -> torch.Tensor:
    """(B, J*3) exp-map dof angles -> (B, J*6) tan-norm joint obs."""
    B = dof_pos.shape[0]
    q = T.exp_map_to_quat(dof_pos.reshape(B, -1, 3))
    return T.quat_to_tan_norm(q).reshape(B, -1)


def _heading(root_rot, upright: bool, humanoid_type: str):
    if not upright:
        root_rot = T.remove_base_rot(root_rot, humanoid_type)
    return root_rot, T.calc_heading_quat_inv(root_rot)


def compute_obs_max(body_pos, body_rot, body_vel, body_ang_vel, smpl_params=None,
                    limb_weight_params=None, local_root_obs: bool = True,
                    root_height_obs: bool = True, upright: bool = True,
                    humanoid_type: str = "smpl") -> torch.Tensor:
    """Heading-local max-coords obs (B, n) from body_pos (B,J,3), body_rot
    (B,J,4) wxyz, body_vel and body_ang_vel (B,J,3).

    Layout: [root_h?] local_body_pos[1:] (J-1)*3 | tan-norm rots J*6 |
    local vels J*3 | local ang vels J*3 | smpl_params? | limb_weights?."""
    B, J, _ = body_pos.shape
    root_pos = body_pos[:, 0]
    root_rot, heading_inv = _heading(body_rot[:, 0], upright, humanoid_type)
    h = heading_inv[:, None, :].expand(B, J, 4)

    local_body_pos = T.quat_rotate(h, body_pos - root_pos[:, None])
    rot_obs = T.quat_to_tan_norm(T.quat_mul(h, body_rot))
    if not local_root_obs:
        # the raw (base-rotation-removed) root rotation replaces entry 0
        rot_obs = torch.cat([T.quat_to_tan_norm(root_rot)[:, None], rot_obs[:, 1:]], 1)
    parts = [root_pos[:, 2:3]] if root_height_obs else []
    parts += [local_body_pos[:, 1:].reshape(B, -1), rot_obs.reshape(B, -1),
              T.quat_rotate(h, body_vel).reshape(B, -1),
              T.quat_rotate(h, body_ang_vel).reshape(B, -1)]
    parts += [p for p in (smpl_params, limb_weight_params) if p is not None]
    return torch.cat(parts, dim=1)


def compute_obs_max_v2(body_pos, body_rot, body_vel, body_ang_vel, local_root_obs: bool = True,
                       root_height_obs: bool = True, upright: bool = True,
                       humanoid_type: str = "smpl") -> torch.Tensor:
    """Time-stacked max-coords obs (B, T*n) from a history (B,T,J,.) oldest
    first: every frame in the CURRENT (latest) heading frame relative to the
    current root position, each frame's root height prepended when
    enabled."""
    B, Tn, J, _ = body_pos.shape
    root_pos = body_pos[:, -1, 0]
    _, heading_inv = _heading(body_rot[:, -1, 0], upright, humanoid_type)
    h = heading_inv[:, None, None, :].expand(B, Tn, J, 4)

    local_body_pos = T.quat_rotate(h, body_pos - root_pos[:, None, None])
    local_body_pos = local_body_pos.reshape(B, Tn, -1)[..., 3:]      # drop the root's
    rot_obs = T.quat_to_tan_norm(T.quat_mul(h, body_rot))            # (B,T,J,6)
    if not local_root_obs:
        raw = T.quat_to_tan_norm(body_rot[:, :, 0])
        rot_obs = torch.cat([raw[:, :, None], rot_obs[:, :, 1:]], 2)
    frames = [local_body_pos, rot_obs.reshape(B, Tn, -1),
              T.quat_rotate(h, body_vel).reshape(B, Tn, -1),
              T.quat_rotate(h, body_ang_vel).reshape(B, Tn, -1)]
    if root_height_obs:
        frames.insert(0, body_pos[:, :, 0, 2:3])
    return torch.cat(frames, dim=-1).reshape(B, -1)


def compute_obs_reduced(root_pos, root_rot, root_vel, root_ang_vel, dof_pos, dof_vel,
                        key_body_pos, smpl_params=None, local_root_obs: bool = True,
                        root_height_obs: bool = True, upright: bool = True,
                        humanoid_type: str = "smpl") -> torch.Tensor:
    """Reduced-coords obs (B, n): root height, rotation and velocities, the
    6-D dof obs, dof velocities and the heading-local key-body positions
    key_body_pos (B,K,3)."""
    B, K, _ = key_body_pos.shape
    root_rot, heading_inv = _heading(root_rot, upright, humanoid_type)
    root_rot_obs = T.quat_to_tan_norm(
        T.quat_mul(heading_inv, root_rot) if local_root_obs else root_rot)
    local_key = T.quat_rotate(heading_inv[:, None].expand(B, K, 4),
                              key_body_pos - root_pos[:, None])
    parts = [root_pos[:, 2:3]] if root_height_obs else []
    parts += [root_rot_obs, T.quat_rotate(heading_inv, root_vel),
              T.quat_rotate(heading_inv, root_ang_vel), dof_to_obs_smpl(dof_pos), dof_vel,
              local_key.reshape(B, -1)]
    if smpl_params is not None:
        parts.append(smpl_params)
    return torch.cat(parts, dim=1)


def obs_max_size(nbody: int, root_height_obs: bool = True) -> int:
    return (1 if root_height_obs else 0) + (nbody - 1) * 3 + nbody * (6 + 3 + 3)


def obs_max_v2_size(nbody: int, time_steps: int, root_height_obs: bool = True) -> int:
    return obs_max_size(nbody, root_height_obs) * time_steps


# ---------------------------------------------------------------------------
# rigid-body history
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BodyHistory:
    """Rolling (B,T,J,.) window of body kinematics, oldest first."""

    pos: torch.Tensor       # (B,T,J,3)
    rot: torch.Tensor       # (B,T,J,4)
    vel: torch.Tensor       # (B,T,J,3)
    ang_vel: torch.Tensor   # (B,T,J,3)

    @staticmethod
    def init(pos, rot, vel, ang_vel, time_steps: int) -> "BodyHistory":
        """The whole window filled with the current frame (B,J,.)."""
        rep = lambda x: x[:, None].expand((x.shape[0], time_steps) + x.shape[1:]).contiguous()
        return BodyHistory(rep(pos), rep(rot), rep(vel), rep(ang_vel))

    def push(self, pos, rot, vel, ang_vel) -> "BodyHistory":
        """Shift out the oldest frame, append the new one (B,J,.)."""
        sh = lambda buf, x: torch.cat([buf[:, 1:], x[:, None]], dim=1)
        return BodyHistory(sh(self.pos, pos), sh(self.rot, rot), sh(self.vel, vel),
                           sh(self.ang_vel, ang_vel))


# ---------------------------------------------------------------------------
# the env
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NvConfig(EnvConfig):
    """Isaac-path knobs (the JAX package's NvConfig)."""

    obs_v: int = 1                   # 1: max-coords; 2: time-stacked
    past_track_steps: int = 5        # history length for obs_v=2
    local_root_obs: bool = True
    termination_height: float = 0.15
    head_termination_height: float = 0.3
    freeze_hand: bool = False
    freeze_toe: bool = False
    remove_neck: bool = False
    contact_bodies: Tuple[str, ...] = ("R_Ankle", "L_Ankle", "R_Toe", "L_Toe")
    # every perturb_interval control steps a random body takes a random
    # horizontal-and-up force up to perturb_force for one control step
    perturb_interval: int = 0        # 0 disables
    perturb_force: float = 200.0     # Newtons, peak magnitude
    # simulated spheres: every proj_interval control steps each is thrown
    # from a random bearing proj_distance away at the humanoid
    num_projectiles: int = 0         # 0 disables
    proj_interval: int = 60
    proj_speed: float = 12.0         # m/s
    proj_radius: float = 0.10
    proj_mass: float = 2.0
    proj_distance: float = 2.0


class NvHumanoid(HumanoidEnv):
    """The reference `Humanoid` task: reward 1, stay-alive termination. With
    obs_v=2 EnvState.task is the BodyHistory window; with projectiles
    EnvState.proj holds the spheres' (pos (B,P,3), vel (B,P,3))."""

    def __init__(self, model: RobotModel, config: NvConfig | None = None, **qp):
        cfg = config or NvConfig()
        super().__init__(model, cfg, **qp)
        names = list(model.body_names)
        self._contact_body_ids = [names.index(n) for n in cfg.contact_bodies]
        heights = np.full(model.nbody, cfg.termination_height, dtype=np.float64)
        if "Head" in names:
            heights[names.index("Head")] = max(cfg.head_termination_height,
                                               cfg.termination_height)
        heights[self._contact_body_ids] = -np.inf     # feet never trip the check
        dev = model.device
        self._termination_heights = torch.as_tensor(heights, dtype=model.dtype, device=dev)
        geom_body = torch.as_tensor(model.geom_body, dtype=torch.long, device=dev)
        exempt = torch.zeros(model.nbody, dtype=torch.bool, device=dev)
        exempt[self._contact_body_ids] = True
        # geoms whose floor contact counts toward a fall
        self._fall_geom = ~exempt[geom_body]
        mask = self._build_pd_mask(cfg, names)
        self._pd_mask = None if mask is None else torch.as_tensor(mask, dtype=model.dtype,
                                                                  device=dev)

    @staticmethod
    def _build_pd_mask(cfg: NvConfig, body_names: list[str]) -> np.ndarray | None:
        frozen: list[str] = []
        if cfg.freeze_hand:
            frozen += ["L_Hand", "R_Hand"]
        if cfg.freeze_toe:
            frozen += ["L_Toe", "R_Toe"]
        if cfg.remove_neck:
            frozen += ["Neck", "Head"]
        if not frozen:
            return None
        mask = np.ones(3 * (len(body_names) - 1))
        for n in frozen:
            if n in body_names:
                d = (body_names.index(n) - 1) * 3
                mask[d:d + 3] = 0.0
        return mask

    def pd_target_mask(self) -> torch.Tensor | None:
        return self._pd_mask

    # ------------- obs -------------
    @property
    def self_obs_size(self) -> int:
        cfg: NvConfig = self.config
        if cfg.obs_v == 1:
            return obs_max_size(self.model.nbody, cfg.root_height_obs)
        return obs_max_v2_size(self.model.nbody, cfg.past_track_steps + 1, cfg.root_height_obs)

    def _kin_tuple(self, phys: PhysicsState, kin: kinematics.Kin, model: RobotModel):
        rot = kinematics.body_quats(model, phys.qpos)
        vel, ang = kinematics.body_velocities(model, kin, phys.qvel)
        return kin.xpos, rot, vel, ang

    def _obs_kw(self):
        cfg: NvConfig = self.config
        return dict(local_root_obs=cfg.local_root_obs, root_height_obs=cfg.root_height_obs,
                    upright=self.upright_start, humanoid_type=self.model.humanoid_type)

    def compute_obs_from_hist(self, hist: BodyHistory) -> torch.Tensor:
        return compute_obs_max_v2(hist.pos, hist.rot, hist.vel, hist.ang_vel, **self._obs_kw())

    def compute_obs(self, task: Any, phys: PhysicsState, kin: kinematics.Kin,
                    model: RobotModel | None = None) -> torch.Tensor:
        model = self.model if model is None else model
        frame = self._kin_tuple(phys, kin, model)
        if self.config.obs_v == 1:
            return compute_obs_max(*frame, **self._obs_kw())
        return self.compute_obs_from_hist(task.push(*frame))

    # ------------- task hooks -------------
    def init_task(self, batch: int) -> Any:
        if self.config.obs_v != 2:
            return None
        # a placeholder window; reset re-primes it from the init pose
        m = self.model
        z3 = torch.zeros((batch, m.nbody, 3), dtype=m.dtype, device=m.device)
        q = torch.zeros((batch, m.nbody, 4), dtype=m.dtype, device=m.device)
        q[..., 0] = 1.0
        return BodyHistory.init(z3, q, z3, z3, self.config.past_track_steps + 1)

    def reward(self, task, phys, kin, action) -> torch.Tensor:
        return torch.ones_like(phys.qpos[:, 0])

    # ------------- randomness -------------
    def _impulse_draws(self, batch: int, generator: torch.Generator):
        """Per env: a body index (B,), a direction (B,3) ~ N(0, 1) and a
        magnitude (B,) uniform in [0, perturb_force)."""
        m = self.model
        kw = dict(generator=generator, dtype=m.dtype, device=m.device)
        body = torch.randint(0, m.nbody, (batch,), generator=generator, device=m.device)
        mag = torch.rand(batch, **kw) * self.config.perturb_force
        return body, torch.randn((batch, 3), **kw), mag

    def _throw_draws(self, batch: int, generator: torch.Generator):
        """Per env and sphere (B,P): a bearing in [0, 2 pi), a height in
        [0.6, 1.4) and a speed factor in [0.7, 1.0)."""
        m = self.model
        kw = dict(generator=generator, dtype=m.dtype, device=m.device)
        shape = (batch, self.config.num_projectiles)
        ang = torch.rand(shape, **kw) * (2 * math.pi)
        h = 0.6 + torch.rand(shape, **kw) * 0.8
        return ang, h, 0.7 + torch.rand(shape, **kw) * 0.3

    def _impulse(self, cur_t, draws, nbody: int):
        """(B,J,3) ext_force: the drawn force on the drawn body (the
        direction's z made upward, then normalized) where the interval is
        due, zero elsewhere."""
        body, d, mag = draws
        d = torch.cat([d[:, :2], d[:, 2:].abs()], 1)
        d = d / torch.linalg.norm(d, dim=1, keepdim=True).clamp_min(1e-6)
        active = (cur_t % self.config.perturb_interval) == 0
        onehot = torch.nn.functional.one_hot(body, nbody).to(d.dtype)
        f = onehot[:, :, None] * (mag[:, None] * d)[:, None, :]
        return torch.where(active[:, None, None], f, torch.zeros_like(f))

    def _throw(self, root_pos, cur_t, proj, draws):
        """The projectile relaunch: where the interval is due, each sphere
        restarts proj_distance away on its bearing at its height, aimed at
        the root (its height clipped to [0.4, 1.2]) at speed factor x
        proj_speed; elsewhere the spheres keep their state."""
        cfg: NvConfig = self.config
        pos, vel = proj
        ang, h, sp = draws
        origin = torch.stack([root_pos[:, None, 0] + cfg.proj_distance * torch.cos(ang),
                              root_pos[:, None, 1] + cfg.proj_distance * torch.sin(ang), h], -1)
        target = torch.stack([root_pos[:, 0], root_pos[:, 1], root_pos[:, 2].clamp(0.4, 1.2)], -1)
        d = target[:, None] - origin
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-6)
        v_new = d * (cfg.proj_speed * sp)[..., None]
        active = ((cur_t % cfg.proj_interval) == 0)[:, None, None]
        return torch.where(active, origin, pos), torch.where(active, v_new, vel)

    # ------------- overrides -------------
    def reset(self, batch: int, generator: torch.Generator,
              model: RobotModel | None = None) -> EnvState:
        state = super().reset(batch, generator, model)
        cfg: NvConfig = self.config
        m = self.model if model is None else model
        if cfg.obs_v == 2:
            frame = self._kin_tuple(state.phys, state.kin, m)
            hist = BodyHistory.init(*frame, cfg.past_track_steps + 1)
            state = dataclasses.replace(state, task=hist, obs=self.compute_obs_from_hist(hist))
        if cfg.num_projectiles > 0:
            P = cfg.num_projectiles
            # parked far away and at rest until the first scheduled throw
            park = torch.tensor([100.0, 0.0, cfg.proj_radius], dtype=m.dtype, device=m.device)
            pos = park + torch.arange(P, dtype=m.dtype, device=m.device)[:, None]
            state = dataclasses.replace(state, proj=(pos.expand(batch, P, 3).contiguous(),
                                                     torch.zeros_like(pos).expand(batch, P, 3)
                                                     .contiguous()))
        return state

    def step(self, state: EnvState, action: torch.Tensor,
             model: RobotModel | None = None) -> EnvState:
        cfg: NvConfig = self.config
        m = self.model if model is None else model
        B = action.shape[0]
        check_batch(m, B)
        dtype = state.phys.qpos.dtype
        action = action.to(dtype)
        if cfg.clip_actions:
            action = action.clamp(-1.0, 1.0)

        ext_force = None
        if cfg.perturb_interval > 0:
            ext_force = self._impulse(state.cur_t, self._impulse_draws(B, state.rng), m.nbody)
        proj_in = None
        if cfg.num_projectiles > 0 and state.proj is not None:
            p_pos, p_vel = self._throw(state.phys.qpos[:, :3], state.cur_t, state.proj,
                                       self._throw_draws(B, state.rng))
            full = lambda v: torch.full((B, cfg.num_projectiles), v, dtype=dtype, device=m.device)
            proj_in = (p_pos, p_vel, full(cfg.proj_radius), full(1.0 / cfg.proj_mass))

        outs = engine.control_step(
            m, state.phys, action, control_freq_inv=cfg.control_frequency_inv,
            cache=state.pd_cache, reset_ref=self._reset_ref_for(m), **self._qp,
            control_mode=cfg.control_mode, power_scale=cfg.power_scale,
            pd_target_mask=self._pd_mask, ext_force=ext_force, proj=proj_in)
        phys, lean, power, cache = outs[:4]
        proj_out = outs[4] if proj_in is not None else None

        cur_t = state.cur_t + 1
        kin = kinematics.fk(m, phys.qpos)
        task = state.task
        frame = self._kin_tuple(phys, kin, m)
        if cfg.obs_v == 2:
            task = task.push(*frame)
            obs = self.compute_obs_from_hist(task)
        else:
            obs = compute_obs_max(*frame, **self._obs_kw())

        # the nv reset rule (compute_humanoid_reset)
        truncated = cur_t >= cfg.episode_length - 1
        fall_contact = (lean.geom_floor_contact & self._fall_geom).any(1)
        fall_height = (kin.xpos[..., 2] < self._termination_heights).any(1)
        has_fallen = fall_contact & fall_height & (cur_t > 1)
        terminated = has_fallen & cfg.enable_early_termination
        return EnvState(
            phys=phys, obs=obs, reward=torch.ones_like(phys.qpos[:, 0]),
            terminated=terminated, truncated=truncated, cur_t=cur_t, task=task,
            info={"power": power, "nactive": lean.nactive_max,
                  "overflow": lean.nactive_max > self._qp_rows, "stalled": lean.stalled_any},
            pd_cache=cache, kin=kin, rng=state.rng, proj=proj_out)
