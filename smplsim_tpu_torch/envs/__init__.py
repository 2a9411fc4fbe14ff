from smplsim_tpu_torch.envs.base import EnvConfig, EnvState, HumanoidEnv
from smplsim_tpu_torch.envs.tasks import HumanoidSpeed, SpeedConfig, SpeedTask

__all__ = ["EnvConfig", "EnvState", "HumanoidEnv", "HumanoidSpeed", "SpeedConfig",
           "SpeedTask"]
