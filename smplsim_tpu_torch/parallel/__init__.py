"""Data parallelism over torch.distributed (port of smplsim_tpu/parallel):
the process group and mesh, placement, and the sharded rollout and PPO
step."""
from smplsim_tpu_torch.parallel.mesh import (
    data_mesh,
    init_distributed,
    replicate,
    shard_batch,
    shard_env_states,
)
from smplsim_tpu_torch.parallel.rollout import sharded_ppo_step, sharded_rollout

__all__ = [
    "data_mesh", "init_distributed", "replicate", "shard_batch",
    "shard_env_states", "sharded_rollout", "sharded_ppo_step",
]
