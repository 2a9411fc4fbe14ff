"""SMPL-family body models of the port: linear blend skinning and the
parser the humanoid builder reads its skeleton and skin from."""
from smplsim_tpu_torch.body_model.lbs import lbs
from smplsim_tpu_torch.body_model.smpl import SMPLParser, load_smpl_data

__all__ = ["lbs", "SMPLParser", "load_smpl_data"]
