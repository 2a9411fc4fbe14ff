"""The RL stack (port of smplsim_tpu/learning): nets, PPO, GAE, running
normalisation and episode statistics."""
from smplsim_tpu_torch.learning.nets import (
    AMPDiscriminator, MLP, PolicyGaussian, PolicyMCP, PolicyPNN, ValueNet,
    amp_disc_loss, amp_reward,
)
from smplsim_tpu_torch.learning.running_norm import RunningNorm, norm_init, norm_update, normalize
from smplsim_tpu_torch.learning.gae import estimate_advantages

__all__ = [
    "AMPDiscriminator", "MLP", "PolicyGaussian", "PolicyMCP", "PolicyPNN",
    "ValueNet", "amp_disc_loss", "amp_reward",
    "RunningNorm", "norm_init", "norm_update", "normalize",
    "estimate_advantages",
]
