"""RobotModel: the humanoid as tensors plus static topology.

Port of smplsim_tpu/models/spec.py. Numeric fields are tensors on one
device in one float dtype; topology (parents, joint layout, geom types,
collision filters) stays plain Python tuples.

Kinematic convention: body 0 has a free joint (qpos[0:3] world position,
qpos[3:7] wxyz quaternion, qvel[0:3] world linear velocity, qvel[3:6]
angular velocity in the root BODY frame); every other body has three hinges
about its local x, y, z applied intrinsically. nq = 7 + 3(J-1),
nv = 6 + 3(J-1), nu = 3(J-1).

A model is shared (every tensor field at its own shape, one body for every
env of a batch) or stacked (`stack_models`: every tensor field with a
leading (N,) axis, row i the body of env i, the topology common). The
physics takes either; an env on a stacked model steps batches of N.

The numpy helpers at the end (inertia of geoms, the capsule frame) are the
host-side work of models/builder.py, copies of smplsim_tpu/models/spec.py's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

GEOM_SPHERE = 0
GEOM_CAPSULE = 1
GEOM_BOX = 2

ARRAY_FIELDS = (
    "body_pos", "body_quat", "body_mass", "body_ipos", "body_inertia",
    "jnt_range", "armature", "dof_damping", "gear", "jkp", "jkd",
    "torque_lim", "pd_action_scale", "pd_action_offset",
    "geom_pos", "geom_quat", "geom_size", "geom_friction", "geom_margin",
    "geom_solref", "geom_solimp",
    "floor_friction", "floor_margin", "floor_solref", "floor_solimp",
    "gravity", "timestep",
    "qpos0", "dof_invweight0", "body_invweight0",
)
STATIC_FIELDS = (
    "parents", "body_names", "geom_body", "geom_type", "geom_names",
    "jnt_limited", "geom_contype", "geom_conaffinity", "contact_excludes",
    "humanoid_type",
)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    # kinematic tree
    body_pos: torch.Tensor       # (J,3) body origin in the parent frame
    body_quat: torch.Tensor      # (J,4) body rotation in the parent frame (wxyz)
    # inertial
    body_mass: torch.Tensor      # (J,)
    body_ipos: torch.Tensor      # (J,3) COM in the body frame
    body_inertia: torch.Tensor   # (J,3,3) rotational inertia about the COM
    # joints and dofs
    jnt_range: torch.Tensor      # (nu,2) hinge limits
    armature: torch.Tensor       # (nv,)
    dof_damping: torch.Tensor    # (nv,)
    # actuation and PD gains
    gear: torch.Tensor           # (nu,)
    jkp: torch.Tensor            # (nu,)
    jkd: torch.Tensor            # (nu,)
    torque_lim: torch.Tensor     # (nu,)
    pd_action_scale: torch.Tensor   # (nu,)
    pd_action_offset: torch.Tensor  # (nu,)
    # geoms
    geom_pos: torch.Tensor       # (G,3)
    geom_quat: torch.Tensor      # (G,4)
    geom_size: torch.Tensor      # (G,3) capsule (r, half-length, -), box half sizes
    geom_friction: torch.Tensor  # (G,3)
    geom_margin: torch.Tensor    # (G,)
    geom_solref: torch.Tensor    # (G,2)
    geom_solimp: torch.Tensor    # (G,5)
    # contact options
    floor_friction: torch.Tensor  # (3,)
    floor_margin: torch.Tensor    # ()
    floor_solref: torch.Tensor    # (2,)
    floor_solimp: torch.Tensor    # (5,)
    # world
    gravity: torch.Tensor        # (3,)
    timestep: torch.Tensor       # ()
    # reference state and solver weights
    qpos0: torch.Tensor          # (nq,)
    dof_invweight0: torch.Tensor  # (nv,)
    body_invweight0: torch.Tensor  # (J,2)
    # static topology
    parents: Tuple[int, ...]
    body_names: Tuple[str, ...]
    geom_body: Tuple[int, ...]
    geom_type: Tuple[int, ...]
    geom_names: Tuple[str, ...]
    jnt_limited: Tuple[bool, ...]
    geom_contype: Tuple[int, ...] = ()
    geom_conaffinity: Tuple[int, ...] = ()
    contact_excludes: Tuple[Tuple[int, int], ...] = ()
    humanoid_type: str = "smpl"

    @property
    def nbody(self) -> int:
        return len(self.parents)

    @property
    def nu(self) -> int:
        return 3 * (self.nbody - 1)

    @property
    def nv(self) -> int:
        return 6 + self.nu

    @property
    def nq(self) -> int:
        return 7 + self.nu

    @property
    def ngeom(self) -> int:
        return len(self.geom_type)

    @property
    def dtype(self) -> torch.dtype:
        return self.qpos0.dtype

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    @property
    def stacked(self) -> bool:
        """True for a stacked model (`stack_models`): every tensor field has
        a leading env axis."""
        return self.qpos0.dim() == 2

    @property
    def num_stacked(self) -> int | None:
        """N of a stacked model, None for a shared one."""
        return self.qpos0.shape[0] if self.stacked else None

    def body_dof_start(self, b: int) -> int:
        """First dof index of body b's hinge triple (b >= 1)."""
        return 6 + 3 * (b - 1)

    def to(self, dtype: torch.dtype | None = None,
           device: str | torch.device | None = None) -> "RobotModel":
        """The model with every tensor field in `dtype` on `device`."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(dtype=dtype or self.dtype, device=device or self.device)
            for f in ARRAY_FIELDS})


def stack_models(models: list[RobotModel]) -> RobotModel:
    """Stack N shared models of one topology into one stacked model: every
    tensor field gains a leading (N,) axis, the static topology (parents,
    geom types, names...) must be identical and is kept once (the port of
    smplsim_tpu/models/spec.py::stack_models; the JAX package maps the
    result with vmap, the port's physics takes it as it is)."""
    if not models:
        raise ValueError("stack_models needs at least one model")
    base = models[0]
    for i, m in enumerate(models[1:], 1):
        for name in STATIC_FIELDS:
            if getattr(m, name) != getattr(base, name):
                raise ValueError(
                    f"model {i} static field {name!r} differs from model 0 — "
                    "stack_models requires identical topology (same SMPL "
                    "family / RobotConfig; betas may differ)")
    if any(m.stacked for m in models):
        raise ValueError("stack_models takes shared models")
    return dataclasses.replace(base, **{
        f: torch.stack([getattr(m, f) for m in models]) for f in ARRAY_FIELDS})


def check_batch(model: RobotModel, batch: int) -> None:
    """Raise unless a batch of `batch` envs can run on the model: any batch
    on a shared model, exactly N on a stacked one."""
    if model.stacked and model.num_stacked != batch:
        raise ValueError(f"a stacked model of {model.num_stacked} rows steps batches of "
                         f"exactly {model.num_stacked}, not {batch}")


def tile_model(model: RobotModel, batch: int) -> RobotModel:
    """A stacked model of `batch` rows: the N bodies of a stacked model
    repeated in order (row i is body i mod N), cut to `batch`, as bench.py
    tiles its β bodies over the envs."""
    if not model.stacked:
        raise ValueError("tile_model takes a stacked model")
    reps = -(-batch // model.num_stacked)

    def tile(x):
        return x.repeat((reps,) + (1,) * (x.dim() - 1))[:batch].contiguous()
    return dataclasses.replace(model, **{f: tile(getattr(model, f)) for f in ARRAY_FIELDS})


# ---------------------------------------------------------------------------
# Inertia of geoms (MuJoCo's compiler inertial pass), numpy, build time
# ---------------------------------------------------------------------------


def geom_mass_inertia(gtype: int, size: np.ndarray, density: float):
    """Mass and rotational inertia about the geom COM in the geom frame, as
    MuJoCo's compiler computes them (capsule = cylinder + two hemispheres)."""
    if gtype == GEOM_SPHERE:
        r = float(size[0])
        m = density * 4.0 / 3.0 * np.pi * r**3
        i = 0.4 * m * r * r
        return m, np.diag([i, i, i])
    if gtype == GEOM_CAPSULE:
        r, hl = float(size[0]), float(size[1])
        m_cyl = density * np.pi * r * r * (2.0 * hl)
        m_sph = density * 4.0 / 3.0 * np.pi * r**3
        m = m_cyl + m_sph
        izz = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
        # the hemispheres by the parallel axis: COM at hl + 3r/8 from the
        # center, inertia 83/320 m r^2 about their own COM
        ixx = (m_cyl * (r * r / 4.0 + hl * hl / 3.0)
               + m_sph * (83.0 / 320.0 * r * r + (hl + 3.0 * r / 8.0) ** 2))
        return m, np.diag([ixx, ixx, izz])
    if gtype == GEOM_BOX:
        hx, hy, hz = float(size[0]), float(size[1]), float(size[2])
        m = density * 8.0 * hx * hy * hz
        return m, np.diag([m * (hy * hy + hz * hz) / 3.0, m * (hx * hx + hz * hz) / 3.0,
                           m * (hx * hx + hy * hy) / 3.0])
    raise ValueError(f"unknown geom type {gtype}")


def body_inertial_from_geoms(geom_specs: list[dict[str, Any]]):
    """Body mass, COM (body frame) and inertia about the COM from its geoms:
    dicts with keys type, size, pos, quat, density."""
    masses, coms, inertias = [], [], []
    for g in geom_specs:
        m, I_geom = geom_mass_inertia(g["type"], g["size"], g["density"])
        R = _quat_to_matrix_np(np.asarray(g["quat"], dtype=np.float64))
        masses.append(m)
        coms.append(np.asarray(g["pos"], dtype=np.float64))
        inertias.append(R @ I_geom @ R.T)
    m_tot = float(sum(masses))
    com = sum(m * c for m, c in zip(masses, coms)) / m_tot
    I_tot = np.zeros((3, 3))
    for m, c, I in zip(masses, coms, inertias):
        d = c - com
        I_tot += I + m * ((d @ d) * np.eye(3) - np.outer(d, d))
    return m_tot, com, I_tot


def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> rotation matrix, float64."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_z_to_vec(v: np.ndarray) -> np.ndarray:
    """wxyz quaternion rotating +z onto the direction of v."""
    v = np.asarray(v, dtype=np.float64)
    n = np.linalg.norm(v)
    if n < 1e-12:
        return np.array([1.0, 0, 0, 0])
    v = v / n
    z = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(z, v))
    if c > 1.0 - 1e-12:
        return np.array([1.0, 0, 0, 0])
    if c < -1.0 + 1e-12:
        return np.array([0.0, 1.0, 0, 0])  # 180 deg about x
    axis = np.cross(z, v)
    s = np.linalg.norm(axis)
    axis = axis / s
    half = np.arctan2(s, c) / 2.0
    return np.array([np.cos(half), *(np.sin(half) * axis)])
