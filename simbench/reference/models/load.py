"""Read a model file (the "smplsim_tpu.RobotModel.v1" dict, gzipped JSON)
into the reference's RobotModel."""
from __future__ import annotations

import gzip
import json
from typing import Any

import numpy as np
import torch

from simbench.reference.models.spec import ARRAY_FIELDS, STATIC_FIELDS, RobotModel


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
