"""The operations of a PPO iteration, counted from the nets' widths and the
batch whatever implements them (a multiply-add is two operations):

  * a forward pass of an MLP costs 2 P per sample, P its weights and
    biases; a training step 6 P per sample (forward, and the gradients of
    the activations and of the weights);
  * the update: each minibatch step trains both nets on its samples, and
    the value net's forward pass runs once over the trajectory and the
    observation after it (the GAE's values);
  * the rollout: one policy forward per env-step;
  * the physics: roofline.control_step_flops for each control step, a
    lower bound of its dense work.

Elementwise work (activations, the losses, Adam) is not counted.
"""
from __future__ import annotations

from simbench import roofline


def mlp_params(in_dim: int, widths, out_dim: int) -> int:
    """Weights and biases of an MLP in_dim -> widths -> out_dim."""
    dims = [in_dim, *widths, out_dim]
    return sum((a + 1) * b for a, b in zip(dims[:-1], dims[1:]))


def nets(sh: dict) -> tuple:
    """(policy, value) parameter counts of a traced summary's shapes."""
    return (mlp_params(sh["obs"], sh["policy_widths"], sh["act"]),
            mlp_params(sh["obs"], sh["value_widths"], 1))


def update_flops(sh: dict) -> float:
    """One update: epochs x minibatches steps of both nets over a
    minibatch each, and the value pass over T*B + B observations."""
    p, v = nets(sh)
    n = sh["T"] * sh["B"]
    mb = n // sh["minibatches"]
    return sh["epochs"] * sh["minibatches"] * mb * 6.0 * (p + v) + 2.0 * v * (n + sh["B"])


def rollout_policy_flops(sh: dict) -> float:
    """The rollout's policy forwards: one per env-step."""
    return 2.0 * nets(sh)[0] * sh["T"] * sh["B"]


def iteration_flops(sh: dict) -> float:
    """The whole iteration: the rollout's policy forwards, its T control
    steps' dense physics and the update."""
    physics = sh["T"] * roofline.control_step_flops(sh["B"], sh["nv"], sh["rows"], sh["substeps"])
    return rollout_policy_flops(sh) + physics + update_flops(sh)
