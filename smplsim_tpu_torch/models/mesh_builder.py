"""Mesh-geometry humanoid pipeline: per-joint convex-hull STL assets and a
mesh-geom MJCF.

Port of smplsim_tpu/models/mesh_builder.py (the reference's mesh branch:
get_joint_geometries, smpl_sim/smpllib/smpl_local_robot.py:82-143, and the
mesh skeleton writer, skeleton_mesh_local.py). Host-side export only: the
hulls, decimation and STL files come from the port's native asset-prep
library, and the physics simulates the primitive humanoid of
models/builder.py.
"""
from __future__ import annotations

import io
import os
import tempfile

import numpy as np

from smplsim_tpu_torch import native
from smplsim_tpu_torch.models.builder import (
    GAINS_MJ,
    EXCLUDE_CONTACTS,
    RobotConfig,
    _build_tree,
    update_joint_limits,
    update_joint_limits_upright,
)

MIN_NUM_VERT = 50  # smpl_local_robot.py:137


def get_joint_geometries(
    verts: np.ndarray,
    jts: np.ndarray,
    skin_weights: np.ndarray,
    joint_names: list[str],
    geom_dir: str,
    scale_dict: dict[str, float] | None = None,
    suffix: str | None = None,
) -> dict:
    """Per-joint decimated hull STLs + hull dict (smpl_local_robot.py:82-143)."""
    scale_dict = scale_dict or {}
    vert_to_joint = np.asarray(skin_weights).argmax(axis=1)
    os.makedirs(geom_dir, exist_ok=True)
    hull_dict = {}
    for jind, jname in enumerate(joint_names):
        vind = np.where(vert_to_joint == jind)[0]
        if len(vind) == 0:
            continue
        norm_verts = (np.asarray(verts)[vind] - np.asarray(jts)[jind]) * (
            scale_dict.get(jname, 1.0)
        )
        faces, volume = native.convex_hull(norm_verts)
        n_hull_verts = len(np.unique(faces))
        # decimate to ~MIN_NUM_VERT hull vertices, capped at 90% reduction
        reduction = min(0.9, 1.0 - MIN_NUM_VERT / max(n_hull_verts, 1))
        target_faces = max(int(round(faces.shape[0] * (1.0 - reduction))), 4)
        dec_verts, dec_faces = native.decimate(norm_verts, faces, target_faces)
        fname = os.path.join(
            geom_dir,
            f"{jname}.stl" if suffix is None else f"{jname}_{suffix}.stl",
        )
        native.write_stl(fname, dec_verts, dec_faces)
        hull_dict[jname] = {
            "norm_verts": norm_verts,
            "faces": faces,
            "volume": volume,
            "stl": fname,
            "dec_verts": dec_verts,
            "dec_faces": dec_faces,
        }
    return hull_dict


def build_mesh_mjcf(
    offsets: dict[str, np.ndarray],
    parents_dict: dict[str, str | None],
    joint_range: dict[str, np.ndarray],
    hull_dict: dict,
    geom_dir: str,
    cfg: RobotConfig = RobotConfig(),
) -> str:
    """Mesh-geom MJCF string (skeleton_mesh_local.py write_str equivalent):
    one `<mesh>` asset + mesh geom per body, 3 hinge joints, gear=1 motors,
    reference contact excludes and the njmax/nconmax buffer bump."""
    jrange = {k: np.asarray(v, dtype=np.float64) for k, v in joint_range.items()}
    if cfg.rel_joint_lm:
        jrange = (update_joint_limits_upright(jrange) if cfg.upright_start
                  else update_joint_limits(jrange))
    root, bones = _build_tree(offsets, parents_dict, jrange)
    base_density = 1000.0 if cfg.real_weight else 500.0

    out = io.StringIO()
    joint_order: list[str] = []

    def w(s, indent):
        out.write("  " * indent + s + "\n")

    def fmt(v, n=4):
        return " ".join(f"{x:.{n}f}" for x in np.atleast_1d(v))

    def emit(bone, indent):
        w(f'<body name="{bone.name}" pos="{fmt(bone.pos)}">', indent)
        if bone.parent is None:
            w(f'<freejoint name="{bone.name}"/>', indent + 1)
        else:
            for i, ax in enumerate(["x", "y", "z"]):
                axis = np.eye(3)[i]
                rng = (
                    f"{bone.lb[i]:.4f} {bone.ub[i]:.4f}"
                    if i < len(bone.lb) else "-180.0 180.0"
                )
                user = " ".join(str(s) for s in GAINS_MJ[bone.name])
                w(
                    f'<joint name="{bone.name}_{ax}" type="hinge" pos="0 0 0" '
                    f'axis="{fmt(axis, 0)}" user="{user}" armature="0.02" '
                    f'range="{rng}" damping="0" stiffness="0"/>',
                    indent + 1,
                )
                joint_order.append(f"{bone.name}_{ax}")
        if bone.name in hull_dict:
            w(
                f'<geom type="mesh" mesh="{bone.name}_mesh" contype="1" '
                f'conaffinity="1" density="{base_density:.1f}" '
                f'name="{bone.name}"/>',
                indent + 1,
            )
        for c in bone.child:
            emit(c, indent + 1)
        w("</body>", indent)

    w('<mujoco model="humanoid_mesh">', 0)
    w('<compiler coordinate="local" meshdir="."/>', 1)
    w(f'<option timestep="{1.0 / cfg.sim_timestep_inv:.8f}"/>', 1)
    w("<default>", 1)
    w('<joint damping="0.0" armature="0.02" stiffness="0.0" limited="true"/>', 2)
    w('<geom conaffinity="1" condim="3" contype="7" margin="0.001" rgba="0.8 0.6 .4 1"/>', 2)
    w("</default>", 1)
    w("<asset>", 1)
    for name, h in hull_dict.items():
        rel = os.path.relpath(h["stl"], geom_dir)
        w(f'<mesh name="{name}_mesh" file="{rel}"/>', 2)
    w("</asset>", 1)
    w("<worldbody>", 1)
    w('<geom conaffinity="1" condim="3" name="floor" pos="0 0 0" '
      'rgba="0.8 0.9 0.8 1" size="100 100 .2" type="plane"/>', 2)
    emit(root, 2)
    w("</worldbody>", 1)
    w("<actuator>", 1)
    for jn in joint_order:
        # mesh writer emits gear=1 motors (skeleton_mesh_local.py:331-341)
        w(f'<motor name="{jn}" joint="{jn}" gear="1"/>', 2)
    w("</actuator>", 1)
    w("<contact>", 1)
    for b1, b2 in EXCLUDE_CONTACTS:
        if b1 in bones and b2 in bones:
            w(f'<exclude body1="{b1}" body2="{b2}"/>', 2)
    w("</contact>", 1)
    # mesh collisions need bigger constraint buffers (skeleton_mesh_local.py:164)
    w('<size njmax="2500" nconmax="500"/>', 1)
    w("</mujoco>", 0)
    return out.getvalue()


def build_mesh_robot(parser, betas=None, cfg: RobotConfig | None = None,
                     geom_dir: str | None = None):
    """Full mesh pipeline: beta -> STL assets + mesh MJCF string
    (SMPL_Robot.load_from_skeleton mesh=True branch,
    smpl_local_robot.py:1331-1424). The STLs go to geom_dir (a new
    temporary directory by default). Returns (xml, hull_dict)."""
    from smplsim_tpu_torch.models.builder import UPRIGHT_ZERO_POSE_AA

    cfg = cfg or RobotConfig(mesh=True)
    geom_dir = geom_dir or tempfile.mkdtemp(prefix="smplsim_geom_")
    J = len(parser.parents)
    zero_pose = np.zeros((1, J * 3))
    if cfg.upright_start:
        zero_pose[0, :3] = UPRIGHT_ZERO_POSE_AA
    (verts, jts, skin_weights, joint_names, joint_offsets, parents_dict,
     channels, joint_range) = parser.get_offsets(betas=betas, zero_pose=zero_pose)
    hull_dict = get_joint_geometries(verts, jts, skin_weights, joint_names, geom_dir)
    xml = build_mesh_mjcf(joint_offsets, parents_dict, joint_range, hull_dict, geom_dir, cfg)
    return xml, hull_dict
