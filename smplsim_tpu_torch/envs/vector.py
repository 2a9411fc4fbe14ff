"""Gymnasium-style vector env facade over the batched env (port of
smplsim_tpu/envs/vector.py).

The gymnasium.vector API of the reference's GymVectEnv: numpy actions in,
numpy observations out (clipped to +-clip_observations), batched Box
spaces, autoreset, and `final_observation` in `info` on any done. The batch
underneath is one `step_autoreset` of the port's env on its device, and
the facade copies observations, rewards and flags to the host each step.

gymnasium is optional: the spaces are built only where it imports; every
method works without it.
"""
from __future__ import annotations

import numpy as np
import torch

from smplsim_tpu_torch.envs.base import HumanoidEnv


def _gym_spaces():
    """(spaces, batch_space) of gymnasium, or None where it does not import."""
    try:
        from gymnasium import spaces
        from gymnasium.vector.utils import batch_space
    except ImportError:
        return None
    return spaces, batch_space


class GymVectEnv:
    """num_envs envs of `env` stepping in lockstep on the env's device."""

    def __init__(self, env: HumanoidEnv, num_envs: int,
                 clip_observations: float = float(np.inf), seed: int = 0):
        self._env = env
        self.num_envs = num_envs
        self._clip_obs = clip_observations
        self._seed = seed
        self._states = None
        gym = _gym_spaces()
        self.has_spaces = gym is not None
        if gym is not None:
            spaces, batch_space = gym
            inf = float(np.inf)
            self.single_observation_space = spaces.Box(-inf * np.ones(env.obs_size),
                                                       inf * np.ones(env.obs_size))
            self.single_action_space = spaces.Box(-np.ones(env.action_size),
                                                  np.ones(env.action_size))
            self.observation_space = batch_space(self.single_observation_space, num_envs)
            self.action_space = batch_space(self.single_action_space, num_envs)

    # -- gymnasium.vector API ------------------------------------------------
    def reset(self, seed: int | None = None, options=None):
        if seed is not None:
            self._seed = seed
        m = self._env.model
        gen = torch.Generator(device=m.device).manual_seed(self._seed)
        self._states = self._env.reset(self.num_envs, gen)
        return self._clipped_obs(), {}

    def step(self, actions):
        if self._states is None:
            raise RuntimeError("call reset() first")
        obs_before = self._clipped_obs()
        m = self._env.model
        a = torch.as_tensor(np.asarray(actions, np.float32), device=m.device).to(m.dtype)
        self._states = st = self._env.step_autoreset(self._states, a)
        obs = self._clipped_obs()
        reward = st.reward.cpu().numpy()
        terminated = st.terminated.cpu().numpy()
        truncated = st.truncated.cpu().numpy()
        info = {k: v.cpu().numpy() for k, v in st.info.items()}
        if (terminated | truncated).any():
            # the autoreset already happened on the device; the observation
            # before the step is the final one (the reference's gymwrapper)
            info["final_observation"] = obs_before
        return obs, reward, terminated, truncated, info

    def close(self) -> None:
        self._states = None

    def render(self, mode="rgb_array"):
        raise NotImplementedError("the port has no renderer yet")

    def _clipped_obs(self) -> np.ndarray:
        obs = self._states.obs.cpu().numpy()
        if np.isfinite(self._clip_obs):
            obs = np.clip(obs, -self._clip_obs, self._clip_obs)
        return obs
