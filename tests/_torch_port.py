"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs: the JAX model is serialized with
registry.model_to_dict and rebuilt by the port, and batches of states are
drawn from a fixed seed the way tests/test_substep_lanes.py draws them.
"""
import jax.numpy as jnp
import numpy as np
import torch

from smplsim_tpu.models import registry as jax_registry
from smplsim_tpu_torch.models import registry as torch_registry

TORCH_DTYPE = {jnp.float64: torch.float64, jnp.float32: torch.float32}

# The port's CPU path is thousands of small-tensor ops; with several test
# processes sharing the cores, intra-op threads oversubscribe them and
# slow those ops several-fold, so each test process keeps one.
torch.set_num_threads(1)


def models(dtype=jnp.float64):
    """(JAX model, port model on the CPU) of the default humanoid."""
    jm = jax_registry.default_humanoid(dtype=dtype)
    tm = torch_registry.model_from_dict(jax_registry.model_to_dict(jm),
                                        dtype=TORCH_DTYPE[dtype], device="cpu")
    return jm, tm


def states(jm, B, kind, seed=0):
    """(qpos, qvel, action) numpy batches. kind: 'air' (standing height,
    small joint noise), 'contact' (lying, buried at the floor) or 'tangled'
    (large joint angles: self-contacts)."""
    rng = np.random.RandomState(seed)
    nv = jm.nv
    qpos = np.tile(np.asarray(jm.qpos0, np.float64), (B, 1))
    if kind == "contact":
        qpos[:, 2] = 0.15 + 0.05 * rng.rand(B)
        qpos[:, 3:7] = [0.7071068, 0.7071068, 0, 0]
        qpos[:, 7:] += rng.randn(B, nv - 6) * 0.1
    elif kind == "air":
        qpos[:, 2] = 0.9 + 0.1 * rng.rand(B)
        qpos[:, 7:] += rng.randn(B, nv - 6) * 0.1
    elif kind == "tangled":
        qpos[:, 2] = 0.95
        qpos[:, 7:] += rng.randn(B, nv - 6) * 0.7
    else:
        raise ValueError(kind)
    qvel = rng.randn(B, nv) * 0.2
    act = rng.uniform(-1, 1, (B, jm.nu))
    return qpos, qvel, act


def T(x, dtype=torch.float64):
    """numpy / JAX array -> CPU tensor (floats in `dtype`)."""
    a = np.asarray(x)
    t = torch.as_tensor(a.copy())
    return t.to(dtype) if t.is_floating_point() else t


def rel_err(ref, val):
    """max |ref - val| / (1 + |ref|) over all entries, in float64."""
    r = np.asarray(ref, np.float64)
    v = val.detach().cpu().numpy().astype(np.float64) if isinstance(val, torch.Tensor) \
        else np.asarray(val, np.float64)
    assert r.shape == v.shape, (r.shape, v.shape)
    if r.size == 0:
        return 0.0
    return float(np.max(np.abs(r - v) / (1.0 + np.abs(r))))
