"""Domain randomization, batched: observation and action noise and scaled
physical properties (port of smplsim_tpu/envs/domain_rand.py).

  * `apply_noise(generator, x, spec, step, corr)`: the reference's noise
    lambdas: gaussian or uniform, additive or scaling, a linear or constant
    annealing schedule, and an optional correlated component `corr` drawn
    once per randomization round and held.
  * `randomize_model(generator, model, cfg, batch)`: a stacked model of
    `batch` rows (models/spec.py), one physical realization per env: mass
    and inertia scaled together, friction on the geoms and the floor,
    damping, armature, both PD gains (one factor for kp and kd, as the JAX
    package's shared key draws them) and gravity. Every physics module reads
    these fields per env; the envs take the model through `model=`.
  * `DomainRandEnv` wraps any HumanoidEnv: a realization per env at reset,
    redrawn at an autoreset every `frequency` resets of that env, and noise
    on every step's observation and action.

Schedules read an absolute step count, passed explicitly. The draws come
from a torch.Generator; every sampling function takes the standard draws
`z` (normal for "gaussian", uniform in [0, 1) for "uniform") or the
finished factors instead, so a caller can feed its own (the tests feed the
JAX package's key draws).
"""
from __future__ import annotations

import dataclasses

import torch

from smplsim_tpu_torch.envs.base import EnvState, HumanoidEnv, select
from smplsim_tpu_torch.models.spec import ARRAY_FIELDS, RobotModel


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """One randomization entry (the reference's dr_params[...])."""

    distribution: str = "gaussian"        # "gaussian" | "uniform"
    operation: str = "additive"           # "additive" | "scaling"
    range: tuple[float, float] = (0.0, 0.0)            # (mu, var) | (lo, hi)
    range_correlated: tuple[float, float] = (0.0, 0.0)
    schedule: str | None = None           # None | "linear" | "constant"
    schedule_steps: int = 1


@dataclasses.dataclass(frozen=True)
class DomainRandConfig:
    """What to randomize. None entries are untouched."""

    frequency: int = 1                     # resets of an env between redraws
    observations: NoiseSpec | None = None
    actions: NoiseSpec | None = None
    body_mass: NoiseSpec | None = None
    friction: NoiseSpec | None = None
    dof_damping: NoiseSpec | None = None
    armature: NoiseSpec | None = None
    pd_gains: NoiseSpec | None = None
    gravity: NoiseSpec | None = None


def schedule_scaling(spec: NoiseSpec, step) -> torch.Tensor:
    """Annealing factor in float32, the shape of `step` (an int or a tensor
    of env step counts): linear ramps 0 -> 1 over schedule_steps, constant
    switches 0 -> 1 at schedule_steps."""
    step = torch.as_tensor(step).to(torch.float32)
    if spec.schedule == "linear":
        return torch.clamp(step, max=float(spec.schedule_steps)) / spec.schedule_steps
    if spec.schedule == "constant":
        return torch.where(step < spec.schedule_steps, 0.0, 1.0)
    return torch.ones_like(step)


def standard_draws(generator, shape, spec: NoiseSpec, dtype, device) -> torch.Tensor:
    """The standard draws one noise of `shape` takes: N(0, 1) for
    "gaussian", uniform in [0, 1) for "uniform"."""
    if spec.distribution == "gaussian":
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)
    if spec.distribution == "uniform":
        return torch.rand(shape, generator=generator, dtype=dtype, device=device)
    raise NotImplementedError(spec.distribution)


def _sample(z: torch.Tensor, spec: NoiseSpec, sched, correlated: bool) -> torch.Tensor:
    """One noise from its standard draws z with the reference's schedule
    semantics: additive scales the parameters by sched; scaling scales the
    spread and pulls the mean toward 1. sched broadcasts against z's
    leading axes."""
    lo, hi = spec.range_correlated if correlated else spec.range
    sched = torch.as_tensor(sched, dtype=z.dtype, device=z.device)
    sched = sched.reshape(sched.shape + (1,) * (z.dim() - sched.dim()))
    if spec.distribution == "gaussian":
        mu, var = lo, hi
        if spec.operation == "additive":
            mu, var = mu * sched, var * sched
        else:
            var = var * sched
            mu = mu * sched + (1.0 - sched)
        return mu + z * var
    if spec.distribution == "uniform":
        if spec.operation == "additive":
            lo, hi = lo * sched, hi * sched
        else:
            lo, hi = lo * sched + (1.0 - sched), hi * sched + (1.0 - sched)
        return torch.maximum(torch.as_tensor(lo, dtype=z.dtype, device=z.device),
                             z * (hi - lo) + lo)
    raise NotImplementedError(spec.distribution)


def sample_correlated(generator, shape, spec: NoiseSpec, step, dtype=torch.float32,
                      device=None, z=None) -> torch.Tensor:
    """The held correlated component, redrawn once per randomization round.
    step (B,) or an int; shape leads with the batch."""
    if z is None:
        z = standard_draws(generator, shape, spec, dtype, device)
    return _sample(z, spec, schedule_scaling(spec, step), True)


def apply_noise(generator, x: torch.Tensor, spec: NoiseSpec, step, corr=None,
                z=None) -> torch.Tensor:
    """The reference's noise lambda: op(x, corr + fresh noise), op + or *."""
    if z is None:
        z = standard_draws(generator, x.shape, spec, x.dtype, x.device)
    noise = _sample(z, spec, schedule_scaling(spec, step), False)
    if corr is not None:
        noise = noise + corr
    return x + noise if spec.operation == "additive" else x * noise


# the factors randomize_model draws: name -> (config entry, model field)
FACTORS = {
    "body_mass": ("body_mass", "body_mass"),
    "geom_friction": ("friction", "geom_friction"),
    "floor_friction": ("friction", "floor_friction"),
    "dof_damping": ("dof_damping", "dof_damping"),
    "armature": ("armature", "armature"),
    "pd_gains": ("pd_gains", "jkp"),
    "gravity": ("gravity", "gravity"),
}


def draw_factors(generator, model: RobotModel, cfg: DomainRandConfig, batch: int,
                 step=0) -> dict:
    """The noise of every configured entry of FACTORS, (batch,) + the
    field's shape, from the generator."""
    out = {}
    for name, (entry, field) in FACTORS.items():
        spec = getattr(cfg, entry)
        if spec is None:
            continue
        shape = getattr(model, field).shape[1:] if model.stacked else getattr(model, field).shape
        z = standard_draws(generator, (batch,) + tuple(shape), spec, model.dtype, model.device)
        out[name] = _sample(z, spec, schedule_scaling(spec, torch.as_tensor(step)), False)
    return out


def randomize_model(generator, model: RobotModel, cfg: DomainRandConfig, batch: int, step=0,
                    factors: dict | None = None) -> RobotModel:
    """A stacked model of `batch` rows: `model` (shared, or stacked with
    `batch` rows) with each configured field randomized per row by its
    factor (`draw_factors`, or `factors` given)."""
    if factors is None:
        factors = draw_factors(generator, model, cfg, batch, step)

    def rows(x):
        return x if model.stacked else x.expand((batch,) + x.shape)

    def scaled(name, spec, field):
        x, f = rows(getattr(model, field)), factors[name]
        return x + f if spec.operation == "additive" else x * f

    new = {f: rows(getattr(model, f)) for f in ARRAY_FIELDS}
    if cfg.body_mass is not None:
        f = factors["body_mass"]
        new["body_mass"] = scaled("body_mass", cfg.body_mass, "body_mass")
        if cfg.body_mass.operation != "additive":
            # the inertia scales with the mass for a fixed geometry
            new["body_inertia"] = new["body_inertia"] * f[..., None, None]
    if cfg.friction is not None:
        new["geom_friction"] = scaled("geom_friction", cfg.friction, "geom_friction")
        new["floor_friction"] = scaled("floor_friction", cfg.friction, "floor_friction")
    if cfg.dof_damping is not None:
        new["dof_damping"] = scaled("dof_damping", cfg.dof_damping, "dof_damping")
    if cfg.armature is not None:
        new["armature"] = scaled("armature", cfg.armature, "armature")
    if cfg.pd_gains is not None:
        new["jkp"] = scaled("pd_gains", cfg.pd_gains, "jkp")
        new["jkd"] = scaled("pd_gains", cfg.pd_gains, "jkd")
    if cfg.gravity is not None:
        new["gravity"] = scaled("gravity", cfg.gravity, "gravity")
    return dataclasses.replace(model, **{k: v.contiguous() for k, v in new.items()})


@dataclasses.dataclass
class DRState:
    """The wrapped env's state, the per-env physical realization and the
    held noise."""

    inner: EnvState
    model: RobotModel              # stacked: one row per env
    corr_obs: torch.Tensor | None  # (B, obs_size)
    corr_act: torch.Tensor | None  # (B, nu)
    resets: torch.Tensor           # (B,) int32 resets of each env (frequency gate)
    step_count: torch.Tensor       # (B,) int32 absolute env steps (schedules)


class DomainRandEnv:
    """Any HumanoidEnv with domain randomization, batched like the env: the
    generator in the wrapped state's `rng` draws every noise and
    realization."""

    def __init__(self, env: HumanoidEnv, cfg: DomainRandConfig):
        self.env = env
        self.cfg = cfg

    def __getattr__(self, name):
        return getattr(self.env, name)

    def _corr(self, generator, batch: int, step):
        cfg, m = self.cfg, self.env.model
        kw = dict(dtype=m.dtype, device=m.device)
        corr_obs = None if cfg.observations is None else sample_correlated(
            generator, (batch, self.env.obs_size), cfg.observations, step, **kw)
        corr_act = None if cfg.actions is None else sample_correlated(
            generator, (batch, self.env.action_size), cfg.actions, step, **kw)
        return corr_obs, corr_act

    def reset(self, batch: int, generator: torch.Generator) -> DRState:
        dev = self.env.model.device
        step0 = torch.zeros(batch, dtype=torch.int32, device=dev)
        model = randomize_model(generator, self.env.model, self.cfg, batch, step0)
        inner = self.env.reset(batch, generator, model)
        corr_obs, corr_act = self._corr(generator, batch, step0)
        if corr_obs is not None:
            inner = dataclasses.replace(inner, obs=apply_noise(
                generator, inner.obs, self.cfg.observations, step0, corr_obs))
        return DRState(inner=inner, model=model, corr_obs=corr_obs, corr_act=corr_act,
                       resets=torch.zeros_like(step0), step_count=step0)

    def step(self, state: DRState, action: torch.Tensor) -> DRState:
        cfg = self.cfg
        gen = state.inner.rng
        if cfg.actions is not None:
            action = apply_noise(gen, action.to(state.model.dtype), cfg.actions,
                                 state.step_count, state.corr_act)
        inner = self.env.step(state.inner, action, state.model)
        if cfg.observations is not None:
            inner = dataclasses.replace(inner, obs=apply_noise(
                gen, inner.obs, cfg.observations, state.step_count, state.corr_obs))
        return dataclasses.replace(state, inner=inner, step_count=state.step_count + 1)

    def step_autoreset(self, state: DRState, action: torch.Tensor) -> DRState:
        """Step; finished envs reset in place, redrawing their physical
        realization every `frequency` resets (the reference's randomize_buf
        gate). Their reward, flags and info are the finishing step's."""
        nxt = self.step(state, action)
        gen = nxt.inner.rng
        B = nxt.step_count.shape[0]
        done = nxt.inner.done
        resets = state.resets + done.to(torch.int32)
        redraw = done & (resets % max(self.cfg.frequency, 1) == 0)
        new_model = randomize_model(gen, self.env.model, self.cfg, B, nxt.step_count)
        model = select(redraw, new_model, nxt.model)
        fresh = self.env.reset(B, gen, model)
        fresh = dataclasses.replace(fresh, reward=nxt.inner.reward,
                                    terminated=nxt.inner.terminated,
                                    truncated=nxt.inner.truncated, info=nxt.inner.info)
        corr_obs, corr_act = self._corr(gen, B, nxt.step_count)
        return DRState(inner=select(done, fresh, nxt.inner), model=model,
                       corr_obs=None if corr_obs is None else select(done, corr_obs, nxt.corr_obs),
                       corr_act=None if corr_act is None else select(done, corr_act, nxt.corr_act),
                       resets=resets, step_count=nxt.step_count)
