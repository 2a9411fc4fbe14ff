"""Evaluate a trained policy of the PyTorch port with its eval metrics
(counterpart of tools/eval_policy_r5.py).

Loads the latest checkpoint of an experiment, runs deterministic eval
rollouts (AgentHumanoid.run_policy(n_episodes=8, horizon=300) with the
trajectory recorded), then computes the physical-plausibility slice of
eval/metrics.py on the recorded bodies: compute_penetration and
compute_skate on one batched FK of every recorded qpos (the mpjpe family
needs a mocap reference). Writes <out_dir>/eval_metrics.json with the JAX
tool's keys: run_policy's three, penetration_mm_mean and skate_mm_mean
(each the mean over episodes of the per-frame metric's mean over time, in
mm as the metrics return it), episodes, platform and qp_iters.

    python tools/eval_policy_torch.py exp_name=speed_r5 env=speed [device=cpu]

The QP runs at the product setting (SMPLSIM_QP_ITERS=16, SMPLSIM_QP_TOL=1e-4,
SMPLSIM_QP_ROWS=32) unless the environment sets them.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("SMPLSIM_QP_ITERS", "16")
os.environ.setdefault("SMPLSIM_QP_TOL", "1e-4")
os.environ.setdefault("SMPLSIM_QP_ROWS", "32")

import torch  # noqa: E402

from smplsim_tpu_torch.agents import AgentHumanoid, RunConfig, parse_cli_overrides  # noqa: E402
from smplsim_tpu_torch.eval import metrics as M  # noqa: E402
from smplsim_tpu_torch.ops import qp  # noqa: E402
from smplsim_tpu_torch.physics import kinematics  # noqa: E402


def plausibility(model, qpos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(penetration, skate) in mm per episode of (E, T, nq) qpos: each the
    per-frame metric of the bodies' FK positions, averaged over time."""
    E, T = qpos.shape[:2]
    xpos = kinematics.fk(model, qpos.reshape(E * T, -1)).xpos.reshape(E, T, -1, 3)
    return M.compute_penetration(xpos).mean(-1), M.compute_skate(xpos).mean(-1)


def evaluate(agent: AgentHumanoid, n_episodes: int = 8, horizon: int = 300) -> dict:
    """Recorded eval rollouts of the agent's policy and their metrics;
    writes eval_metrics.json under the agent's out_dir."""
    import joblib

    rec_path = os.path.join(agent.out_dir, "eval_rollout.pkl")
    out = agent.run_policy(n_episodes=n_episodes, horizon=horizon, record_path=rec_path)
    model = agent.env.model
    qpos = torch.as_tensor(joblib.load(rec_path)["qpos"], dtype=model.dtype,
                           device=model.device)                     # (E, T, nq)
    pen, skate = plausibility(model, qpos)
    rec = dict(out)
    rec.update({
        "penetration_mm_mean": pen.mean().item(),
        "skate_mm_mean": skate.mean().item(),
        "episodes": qpos.shape[0],
        "platform": "gpu" if model.device.type == "cuda" else "cpu",
        "qp_iters": qp.NEWTON_ITERS,
    })
    path = os.path.join(agent.out_dir, "eval_metrics.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec))
    print(f"wrote {path}")
    return rec


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("device=")), "cuda")
    cfg = parse_cli_overrides(RunConfig(), [a for a in argv if not a.startswith("device=")]
                              + ["test=true", "epoch=-1"])
    return evaluate(AgentHumanoid(cfg, device=device))


if __name__ == "__main__":
    main()
