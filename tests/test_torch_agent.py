"""The port's trainer (smplsim_tpu_torch/agents, run.py) on the CPU at a tiny
size: CLI overrides, two epochs with a checkpoint, resume, eval rollouts
and the CLI entry point, as tests/test_agent.py checks the JAX trainer."""
import dataclasses
import functools
import json
import os

import joblib
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test process)
from smplsim_tpu_torch import run
from smplsim_tpu_torch.agents import AgentHumanoid, RunConfig, parse_cli_overrides
from smplsim_tpu_torch.envs.tasks import SpeedConfig
from smplsim_tpu_torch.learning.ppo import PPOConfig, state_tensors

LOG_KEYS = {"epoch", "T_step", "steps_per_sec", "reward_mean", "episode_done_frac",
            "value_mean", "efc_overflow_frac", "qp_stalled_frac", "nactive_max"}


def tiny_cfg(tmp, **kw):
    return RunConfig(
        task="HumanoidSpeed",
        env=SpeedConfig(control_frequency_inv=2),
        learning=PPOConfig(horizon=2, num_envs=4, opt_num_epochs=1, num_minibatches=2,
                           policy_widths=(32, 32), value_widths=(32, 32)),
        output_dir=str(tmp), num_epochs=2, save_frequency=100, **kw)


def same_bits(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def test_cli_overrides():
    cfg = parse_cli_overrides(
        RunConfig(),
        ["env=getup", "seed=3", "learning.gamma=0.9", "env.episode_length=10",
         "learning.policy_widths=64,64", "test=true", "env.fall_init_pool=8"])
    assert cfg.task == "HumanoidGetup" and type(cfg.env).__name__ == "GetupConfig"
    assert cfg.seed == 3 and cfg.test is True
    assert cfg.learning.gamma == 0.9
    assert cfg.env.episode_length == 10 and cfg.env.fall_init_pool == 8
    assert cfg.learning.policy_widths == (64, 64)
    assert cfg.robot.sim_timestep_inv == 450
    with pytest.raises(ValueError):
        parse_cli_overrides(RunConfig(), ["seed"])


def test_train_checkpoint_resume(tmp_path):
    agent = AgentHumanoid(tiny_cfg(tmp_path), device="cpu")
    p0 = [p.detach().clone() for p in agent.ppo.init(0).policy.parameters()]
    ts = agent.optimize_policy(num_epochs=2)
    assert ts.epoch == 2
    assert all(torch.isfinite(p).all() for p in ts.policy.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(p0, ts.policy.parameters()))
    lines = [json.loads(x) for x in open(os.path.join(agent.out_dir, "log.txt"))]
    assert [r["epoch"] for r in lines] == [1, 2]
    assert all(set(r) == LOG_KEYS and all(np.isfinite(v) for v in r.values()) for r in lines)
    assert len(agent.epoch_seconds) == 2
    assert os.path.exists(os.path.join(agent.out_dir, "Humanoid_00000002.pt"))

    # a new agent loads the checkpoint bit for bit
    agent2 = AgentHumanoid(tiny_cfg(tmp_path, epoch=-1), device="cpu")
    ts2 = agent2.load_checkpoint(-1)
    assert ts2.epoch == 2
    assert same_bits(state_tensors(ts), state_tensors(ts2))

    # one more epoch from either reproduces the other bit for bit
    agent2.state = ts2
    ts3 = agent.optimize_policy(num_epochs=1)
    ts3b = agent2.optimize_policy(num_epochs=1)
    assert ts3.epoch == ts3b.epoch == 3
    assert same_bits(state_tensors(ts3), state_tensors(ts3b))
    assert agent2.load_checkpoint(2).epoch == 2
    # a fresh agent with epoch=-1 resumes from the latest checkpoint
    assert AgentHumanoid(tiny_cfg(tmp_path, epoch=-1), device="cpu").optimize_policy(1).epoch == 4


def test_run_policy(tmp_path):
    agent = AgentHumanoid(tiny_cfg(tmp_path), device="cpu")
    agent.state = agent.ppo.init(0)
    rec = str(tmp_path / "rollout.pkl")
    out = agent.run_policy(n_episodes=2, horizon=3, record_path=rec)
    assert set(out) == {"eval_return_mean", "eval_return_std", "eval_length_mean"}
    assert np.isfinite(out["eval_return_mean"]) and out["eval_length_mean"] == 3.0
    traj = joblib.load(rec)
    assert traj["qpos"].shape == (2, 3, agent.model.nq) and traj["done"].shape == (2, 3)
    # the mean action is deterministic; a sampled one differs
    assert agent.run_policy(n_episodes=2, horizon=3) == {k: out[k] for k in out}
    assert agent.run_policy(n_episodes=2, horizon=3, stochastic=True) != out
    # render_path draws episode 0 every second step: frames 0 and 2 of 3
    import imageio.v2 as imageio

    gif = str(tmp_path / "x.gif")
    agent.run_policy(n_episodes=1, horizon=3, render_path=gif)
    assert len(imageio.mimread(gif)) == 2


def test_run_main_trains_then_evaluates(tmp_path, monkeypatch):
    args = [f"output_dir={tmp_path}", "env=speed", "seed=1", "num_epochs=1",
            "env.control_frequency_inv=2", "learning.num_envs=2", "learning.horizon=2",
            "learning.opt_num_epochs=1", "learning.num_minibatches=1",
            "learning.policy_widths=16", "learning.value_widths=16"]
    ts = run.main(args, device="cpu")
    assert ts.epoch == 1
    # eval as main runs it, over 3 steps instead of run_policy's 300
    monkeypatch.setattr(AgentHumanoid, "run_policy",
                        functools.partialmethod(AgentHumanoid.run_policy, horizon=3))
    out = run.main(args + ["test=true", "epoch=-1"], device="cpu")
    assert np.isfinite(out["eval_return_mean"])
    log = open(os.path.join(tmp_path, "humanoid_smpl", "log.txt")).read().splitlines()
    assert len(log) == 2 and "eval_return_mean" in json.loads(log[1])


def test_checkpoint_of_another_config_is_refused(tmp_path):
    agent = AgentHumanoid(tiny_cfg(tmp_path), device="cpu")
    agent.save_checkpoint(agent.ppo.init(0))
    other = tiny_cfg(tmp_path)
    other = dataclasses.replace(other, learning=dataclasses.replace(other.learning, num_envs=3))
    with pytest.raises(ValueError):
        AgentHumanoid(other, device="cpu").load_checkpoint(0)


def test_checkpoint_of_another_dtype_is_refused(tmp_path):
    """A float64 run's env states are refused by a float32 run, as
    load_state_dict would cast the nets silently."""
    agent = AgentHumanoid(tiny_cfg(tmp_path), dtype=torch.float64, device="cpu")
    agent.save_checkpoint(agent.ppo.init(0))
    with pytest.raises(ValueError):
        AgentHumanoid(tiny_cfg(tmp_path), device="cpu").load_checkpoint(0)
