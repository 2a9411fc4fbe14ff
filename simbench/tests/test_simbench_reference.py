"""The frozen reference (simbench/reference) on the CPU: against the MuJoCo
golden, against the port in float64 on a tiny batch (one step of speed and
of getup, with and without rows that finish in it), and a static look at
its imports."""
import ast
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from simbench import envcheck, harness
from simbench.reference.envs import base as ref_base
from simbench.reference.envs import tasks as ref_tasks
from simbench.reference.models.load import load_model as ref_load

GOLDEN = os.path.join(harness.ROOT, "tests", "golden", "speed_ref_150.npz")
SMPL = os.path.join(harness.HERE, "configs", "smpl_humanoid_neutral.json.gz")
WIDE = (4096, 4096, 4096)      # no self-collision pair culled, as MuJoCo
DEFAULT_QP = dict(qp_iters=40, qp_rows=64, qp_tol=1e-12)


def test_reference_matches_mujoco_golden():
    """The reference's float64 speed loop at the default QP from the
    golden's start under its first 10 actions stays within 1e-12 of
    MuJoCo's qpos (the port reads 1.9e-14 there)."""
    gold = np.load(GOLDEN)
    model = ref_load(SMPL, torch.float64, "cpu")
    env = ref_tasks.HumanoidSpeed(model, keeps=WIDE, **DEFAULT_QP)
    st = env.reset(1, torch.Generator().manual_seed(0))
    st = dataclasses.replace(st, task=dataclasses.replace(
        st.task, tar_speed=torch.full_like(st.task.tar_speed, float(gold["tar_speed"])),
        change_step=torch.full_like(st.task.change_step, 10 ** 9)))
    err = 0.0
    for t in range(10):
        st = env.step(st, torch.as_tensor(gold["actions"][t:t + 1]))
        err = max(err, float((st.phys.qpos[0] - torch.as_tensor(gold["qpos"][t])).abs().max()))
    assert err <= 1e-12, err


class _Ctx:
    """What envcheck reads of a run's context."""

    def __init__(self, traffic, config="smpl"):
        self.traffic = harness.load_json(harness.HERE, "traffic", traffic + ".json")
        self.config = harness.load_json(harness.HERE, "configs", config + ".json")
        self.device = torch.device("cpu")

    def model_path(self):
        return os.path.join(harness.HERE, "configs", self.config["model_file"])


@pytest.mark.parametrize("episode_length", [300, 3])
@pytest.mark.parametrize("traffic", ["speed_b4096", "getup_b4096"])
def test_reference_step_matches_port_float64(monkeypatch, traffic, episode_length):
    """One step_autoreset of 6 envs after 3 from a reset, the port against
    the reference in float64, both drawing in float64: the physics, the
    caches, the answers and the resets agree to 1e-9. At an episode length
    of 3 every row finishes in the compared step."""
    from smplsim_tpu_torch.envs import GetupConfig, HumanoidGetup, HumanoidSpeed, SpeedConfig
    from smplsim_tpu_torch.models import registry

    monkeypatch.setattr(ref_base, "DRAW_DTYPE", torch.float64)
    ctx = _Ctx(traffic)
    ctx.config["env"]["episode_length"] = episode_length
    t = ctx.traffic
    cls, cfg_cls = {"HumanoidSpeed": (HumanoidSpeed, SpeedConfig),
                    "HumanoidGetup": (HumanoidGetup, GetupConfig)}[t["task"]]
    env = cls(registry.load_model(SMPL, torch.float64, "cpu"),
              cfg_cls(**ctx.config["env"], **t["task_config"]), keeps=tuple(t["keeps"]), **t["qp"])
    ref = envcheck.reference_env(ctx)
    gen, ga = torch.Generator().manual_seed(4), torch.Generator().manual_seed(5)
    st = env.reset(6, gen)
    for k in range(4):
        a = torch.rand((6, env.model.nu), generator=ga, dtype=torch.float64) * 2 - 1
        g_in, s_in = st.rng.get_state(), envcheck.clone_tree(st)
        st = env.step_autoreset(st, a)
    r = envcheck.reference_out(ref, s_in, a, g_in, torch.float64)
    c = envcheck.compare(ref, s_in, st, r, g_in, torch.float64)
    assert c["done_flips"] == 0
    assert c["reset_rows"] == (6 if episode_length == 3 else int(st.done.sum()))
    assert float(c["state"].max()) <= 1e-9, c
    for k in ("cache_gap_p50", "reset_gap", "answer_gap", "rows_off_share"):
        assert c[k] <= 1e-9, (k, c[k])
    for f in dataclasses.fields(st.task):
        assert torch.allclose(getattr(st.task, f.name).double(),
                              getattr(r.out.task, f.name).double(), atol=1e-9), f.name


def test_reference_imports_nothing_of_the_port_or_jax():
    """Every import in simbench/reference is of torch, numpy, the standard
    library or simbench.reference itself."""
    allowed = {"torch", "numpy", "simbench", "__future__", "dataclasses", "functools", "gzip",
               "json", "math", "typing", "contextlib", "os"}
    files = glob.glob(os.path.join(harness.HERE, "reference", "**", "*.py"), recursive=True)
    assert len(files) > 15
    for f in files:
        for node in ast.walk(ast.parse(open(f).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top in allowed, (f, n)
                assert top not in {"jax", "jaxlib", "flax", "smplsim_tpu", "smplsim_tpu_torch"}
                if top == "simbench":
                    assert n.startswith("simbench.reference"), (f, n)
