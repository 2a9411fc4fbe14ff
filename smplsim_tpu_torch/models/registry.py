"""Model serialization and the baked neutral-SMPL humanoid.

Port of smplsim_tpu/models/registry.py. `model_from_dict` takes exactly the
dict that the JAX package's `registry.model_to_dict` returns (format
"smplsim_tpu.RobotModel.v1"), and `model_to_dict` writes it, so a model
crosses between the packages as plain data either way.
"""
from __future__ import annotations

import gzip
import json
import os
from typing import Any

import numpy as np
import torch

from smplsim_tpu_torch.models.spec import ARRAY_FIELDS, STATIC_FIELDS, RobotModel

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")


def model_to_dict(model: RobotModel) -> dict[str, Any]:
    out: dict[str, Any] = {"format": "smplsim_tpu.RobotModel.v1"}
    for f in ARRAY_FIELDS:
        out[f] = getattr(model, f).detach().to("cpu", torch.float64).numpy().tolist()
    for f in STATIC_FIELDS:
        v = getattr(model, f)
        out[f] = list(v) if isinstance(v, tuple) else v
    return out


def save_model(model: RobotModel, path: str) -> None:
    data = json.dumps(model_to_dict(model)).encode()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(data)


def model_from_dict(d: dict[str, Any], dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cuda") -> RobotModel:
    kwargs: dict[str, Any] = {}
    for f in ARRAY_FIELDS:
        kwargs[f] = torch.as_tensor(np.asarray(d[f], dtype=np.float64)).to(
            device=device, dtype=dtype)
    for f in STATIC_FIELDS:
        v = d[f]
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f] = v
    return RobotModel(**kwargs)


def load_model(path: str, dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> RobotModel:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    return model_from_dict(json.loads(data), dtype=dtype, device=device)


def default_humanoid(dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cuda") -> RobotModel:
    """The baked mean-neutral SMPL humanoid (24 bodies, 24 geoms, nv=75)."""
    return load_model(os.path.join(_ASSET_DIR, "smpl_humanoid_neutral.json.gz"),
                      dtype=dtype, device=device)
