"""CLI entry point: train or evaluate a humanoid policy on the card.

    python -m smplsim_tpu_torch.run env=speed seed=0 num_epochs=200
    python -m smplsim_tpu_torch.run env=speed test=true epoch=-1

Overrides use dotted key=value paths into RunConfig (agents/config.py).
"""
from __future__ import annotations

import sys

from smplsim_tpu_torch.agents import AgentHumanoid, RunConfig, parse_cli_overrides


def main(argv=None, device: str = "cuda"):
    argv = sys.argv[1:] if argv is None else argv
    cfg = parse_cli_overrides(RunConfig(), argv)
    agent = AgentHumanoid(cfg, device=device)
    if cfg.test:
        return agent.run_policy()
    return agent.optimize_policy()


if __name__ == "__main__":
    main()
