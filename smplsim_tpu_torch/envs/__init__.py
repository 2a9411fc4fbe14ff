from smplsim_tpu_torch.envs.base import EnvConfig, EnvState, HumanoidEnv
from smplsim_tpu_torch.envs.tasks import (TASKS, GetupConfig, GetupTask, HumanoidGetup,
                                          HumanoidReach, HumanoidSpeed, ReachConfig, ReachTask,
                                          SpeedConfig, SpeedTask)

__all__ = ["EnvConfig", "EnvState", "GetupConfig", "GetupTask", "HumanoidEnv", "HumanoidGetup",
           "HumanoidReach", "HumanoidSpeed", "ReachConfig", "ReachTask", "SpeedConfig",
           "SpeedTask", "TASKS"]
