"""Bake the neutral-SMPL humanoid RobotModel asset of the PyTorch port from
a SMPLSim-format MJCF (counterpart of tools/bake_default_humanoid.py).

Usage: python tools/bake_default_humanoid_torch.py path-to-mjcf [out=path] [device=cpu]

The MJCF is the reference implementation's baked mean-neutral-body
smpl_humanoid.xml (or any MJCF of that format, e.g. models.export_mjcf's).
It is parsed in float64, set to the 450 Hz physics timestep of the
reference's base_env.yaml, and saved with registry.save_model: a numeric
JSON tree, by default the port's own asset
smplsim_tpu_torch/models/assets/smpl_humanoid_neutral.json.gz.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from smplsim_tpu_torch.models import parse_mjcf_file, registry  # noqa: E402

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "smplsim_tpu_torch",
                           "models", "assets", "smpl_humanoid_neutral.json.gz")


def bake(src: str, out: str = DEFAULT_OUT, device="cuda"):
    model = parse_mjcf_file(src, dtype=torch.float64, device=device)
    # the SMPL humanoid runs at 450 Hz physics (reference base_env.yaml)
    model = dataclasses.replace(model, timestep=torch.full_like(model.timestep, 1.0 / 450.0))
    registry.save_model(model, out)
    print(f"baked {model.nbody}-body humanoid -> {out}")
    return model


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    src = [a for a in argv if "=" not in a]
    if len(src) != 1:
        raise SystemExit(__doc__)
    return bake(src[0], kv.get("out", DEFAULT_OUT), kv.get("device", "cuda"))


if __name__ == "__main__":
    main()
