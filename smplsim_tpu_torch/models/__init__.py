from smplsim_tpu_torch.models.mjcf import export_mjcf, parse_mjcf, parse_mjcf_file
from smplsim_tpu_torch.models.registry import (default_humanoid, load_model, model_from_dict,
                                               model_to_dict, save_model)
from smplsim_tpu_torch.models.spec import (GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, RobotModel,
                                           stack_models, tile_model)

__all__ = [
    "RobotModel", "stack_models", "tile_model", "GEOM_SPHERE", "GEOM_CAPSULE", "GEOM_BOX",
    "parse_mjcf", "parse_mjcf_file", "export_mjcf",
    "default_humanoid", "load_model", "model_from_dict", "model_to_dict", "save_model",
]
