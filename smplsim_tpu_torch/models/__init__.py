from smplsim_tpu_torch.models.registry import default_humanoid, load_model, model_from_dict
from smplsim_tpu_torch.models.spec import RobotModel

__all__ = ["RobotModel", "default_humanoid", "load_model", "model_from_dict"]
