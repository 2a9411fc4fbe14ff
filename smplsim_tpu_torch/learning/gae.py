"""Generalized advantage estimation (port of smplsim_tpu/learning/gae.py).

A reverse loop over T on device tensors: `not_dead` (0 at a true
termination) gates the bootstrap from the next value, `not_done` (0 at any
episode end, termination or truncation) gates the carried advantage.
"""
from __future__ import annotations

import torch


def estimate_advantages(
    rewards: torch.Tensor,     # (T, B)
    values: torch.Tensor,      # (T, B) V(s_t)
    last_value: torch.Tensor,  # (B,) V(s_T)
    not_done: torch.Tensor,    # (T, B)
    not_dead: torch.Tensor,    # (T, B)
    gamma: float = 0.99,
    tau: float = 0.95,
):
    """Returns (advantages, returns), both (T, B)."""
    advs = torch.empty_like(values)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next * not_dead[t] - values[t]
        adv_next = delta + gamma * tau * not_done[t] * adv_next
        advs[t] = adv_next
        v_next = values[t]
    return advs, advs + values
