from smplsim_tpu_torch.agents.agent_humanoid import AgentHumanoid
from smplsim_tpu_torch.agents.config import RunConfig, parse_cli_overrides

__all__ = ["AgentHumanoid", "RunConfig", "parse_cli_overrides"]
