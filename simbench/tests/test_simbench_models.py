"""The configurations' model files load through the port's registry at the
sizes their configuration files state, and the SMPL-X file is the port's
own build of the same synthetic body to 1e-9 in float64."""
import os

import numpy as np
import pytest
import torch

from simbench import harness


@pytest.mark.parametrize("name", ["smpl", "smplx"])
def test_model_file_loads_at_the_stated_sizes(name):
    from smplsim_tpu_torch.models import registry

    cfg = harness.load_json(harness.HERE, "configs", name + ".json")
    m = registry.load_model(os.path.join(harness.HERE, "configs", cfg["model_file"]),
                            torch.float64, "cpu")
    assert (m.humanoid_type, m.nbody, len(m.geom_body), m.nv, m.nu) == (
        cfg["humanoid_type"], cfg["nbody"], cfg["ngeom"], cfg["nv"], cfg["nu"])
    assert round(1.0 / float(m.timestep.reshape(-1)[0])) == cfg["env"]["sim_timestep_inv"]


def test_smplx_file_is_the_ports_build_of_the_synthetic_body():
    from smplsim_tpu_torch.body_model import SMPLParser
    from smplsim_tpu_torch.models import registry
    from smplsim_tpu_torch.models.builder import RobotConfig, build_robot_model
    from smplsim_tpu_torch.models.spec import ARRAY_FIELDS, STATIC_FIELDS
    from tests._torch_synthetic_body import make_synthetic_body

    parser = SMPLParser(data=make_synthetic_body(np.random.default_rng(1), "smplx"),
                        model_type="smplx")
    built = build_robot_model(parser, cfg=RobotConfig(model="smplx"), dtype=torch.float64,
                              device="cpu")[0]
    baked = registry.load_model(os.path.join(harness.HERE, "configs", "smplx_synthetic.json.gz"),
                                torch.float64, "cpu")
    for f in STATIC_FIELDS:
        assert getattr(baked, f) == getattr(built, f), f
    for f in ARRAY_FIELDS:
        a, b = getattr(baked, f), getattr(built, f)
        err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-300)) if b.numel() else 0.0
        assert err <= 1e-9, (f, err)

