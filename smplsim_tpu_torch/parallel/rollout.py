"""Sharded rollout and PPO-step drivers (port of
smplsim_tpu/parallel/rollout.py).

The env batch splits over the ranks of a data mesh: every rank steps its
own rows, and the PPO update averages the gradients and metrics over the
mesh's process group (PPO.update(group=)). Nets, optimiser states, the
running norm and the trainer's generator are replicated and stay
bit-identical across ranks: every rank applies the same averaged update to
the same values, and the carried generator advances by one rule that reads
only its own state.

A rank's draws come from fold_in(generator, rank) (parallel/mesh.py), as
the JAX package folds the shard index into its key. The JAX env state
carries a key per env, the port's one generator per batch, so a run at
W > 1 ranks is not the unsharded run reshuffled; a world of 1 is the
unsharded trainer from the derived state (local_train_state).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from smplsim_tpu_torch.parallel.mesh import DataMesh, fold_in, replicate, shard_env_states

# the data folded into the carried generator after a step (the JAX
# package's fold_in(rng_global, 2**31)): no rank index reaches it
CARRY_FOLD = 2 ** 31


def sharded_rollout(env, policy_fn: Callable[[torch.Generator, torch.Tensor], torch.Tensor],
                    mesh: DataMesh, horizon: int):
    """`run(env_states, generator) -> (env_states', traj)`: each rank steps
    its shard of the env batch `horizon` times with
    policy_fn(generator, obs) -> action, drawing from fold_in(generator,
    rank). traj holds the rank's (T, B/W, ...) obs, reward and done; the
    JAX package's global array is their rank-order concatenation along
    axis 1."""

    @torch.no_grad()
    def run(env_states, generator: torch.Generator):
        gen = fold_in(generator, mesh.rank)
        st, steps = env_states, []
        for _ in range(horizon):
            nxt = env.step_autoreset(st, policy_fn(gen, st.obs))
            steps.append(dict(obs=st.obs, reward=nxt.reward, done=nxt.done))
            st = nxt
        return st, {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    return run


def place_train_state(ts, mesh: DataMesh):
    """A PPO TrainState on the mesh: the env states sharded (this rank's
    rows of the global reset, the env generator folded with the rank); the
    nets, optimiser states, running norm and trainer generator rank 0's."""
    return dataclasses.replace(
        ts, env_states=shard_env_states(ts.env_states, mesh),
        **replicate(dict(policy=ts.policy, value=ts.value, policy_opt=ts.policy_opt,
                         value_opt=ts.value_opt, obs_norm=ts.obs_norm,
                         generator=ts.generator), mesh))


def local_train_state(ts, mesh: DataMesh):
    """The TrainState this rank runs its iteration from: the placed state
    with the trainer's generator folded with the rank."""
    return dataclasses.replace(ts, generator=fold_in(ts.generator, mesh.rank))


def sharded_ppo_step(ppo, mesh: DataMesh, ts, place: bool = True):
    """(step_fn, placed_ts). step_fn(ts) -> (ts', metrics) runs ppo.rollout
    and ppo.update(group=mesh.group) from local_train_state(ts, mesh); the
    returned state carries fold_in(ts.generator, CARRY_FOLD), the same on
    every rank. place=False: ts is placed already."""

    def step(ts_in):
        local = local_train_state(ts_in, mesh)
        env_states, traj = ppo.rollout(local)
        ts_out, metrics = ppo.update(local, env_states, traj, group=mesh.group)
        return dataclasses.replace(ts_out, generator=fold_in(ts_in.generator, CARRY_FOLD)), metrics

    return step, (place_train_state(ts, mesh) if place else ts)
