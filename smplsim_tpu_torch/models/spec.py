"""RobotModel: the humanoid as tensors plus static topology.

Port of smplsim_tpu/models/spec.py. Numeric fields are tensors on one
device in one float dtype; topology (parents, joint layout, geom types,
collision filters) stays plain Python tuples.

Kinematic convention: body 0 has a free joint (qpos[0:3] world position,
qpos[3:7] wxyz quaternion, qvel[0:3] world linear velocity, qvel[3:6]
angular velocity in the root BODY frame); every other body has three hinges
about its local x, y, z applied intrinsically. nq = 7 + 3(J-1),
nv = 6 + 3(J-1), nu = 3(J-1).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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
