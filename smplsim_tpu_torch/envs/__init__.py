from smplsim_tpu_torch.envs.base import EnvConfig, EnvState, HumanoidEnv
from smplsim_tpu_torch.envs.domain_rand import (DomainRandConfig, DomainRandEnv, NoiseSpec,
                                                randomize_model)
from smplsim_tpu_torch.envs.legacy import HumanoidMove, HumanoidPlayback, MoveConfig, PlaybackState
from smplsim_tpu_torch.envs.nv import BodyHistory, NvConfig, NvHumanoid
from smplsim_tpu_torch.envs.tasks import (TASKS, GetupConfig, GetupTask, HumanoidGetup,
                                          HumanoidReach, HumanoidSpeed, ReachConfig, ReachTask,
                                          SpeedConfig, SpeedTask)
from smplsim_tpu_torch.envs.vector import GymVectEnv

__all__ = ["BodyHistory", "DomainRandConfig", "DomainRandEnv", "EnvConfig", "EnvState",
           "GetupConfig", "GetupTask", "GymVectEnv", "HumanoidEnv", "HumanoidGetup",
           "HumanoidMove", "HumanoidPlayback", "HumanoidReach", "HumanoidSpeed", "MoveConfig", "NoiseSpec",
           "NvConfig", "NvHumanoid", "PlaybackState", "ReachConfig", "ReachTask", "SpeedConfig", "SpeedTask",
           "TASKS", "randomize_model"]
