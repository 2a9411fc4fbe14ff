"""beta -> RobotModel: the shape-parameterized humanoid factory.

Port of smplsim_tpu/models/builder.py (the reference's SMPL_Robot
primitive-geometry pipeline, smpl_sim/smpllib/smpl_local_robot.py:1280-1505
and skeleton_local.py:292-684): zero-pose joint offsets from the body model,
per-joint convex hulls of the skin-weight argmax vertex groups, geometry
synthesis (capsule radius from the hull volume by the cubic solve, box feet
by the big-ankle and toe rules, the shrink factors with their density
compensation), joint-limit tables, gains and the contact excludes. The
output is an MJCF string, the JAX package's to the byte, parsed into a
RobotModel (models/mjcf.py). All of it is host work in float64 numpy; only
the finished model moves to the device.
"""
from __future__ import annotations

import dataclasses
import io
from typing import Any

import numpy as np
import torch

# geom primitive per joint (skeleton_local.py:21-79; the writer mutates this
# per-config; each build copies it)
GEOM_TYPES_BASE = {
    "Pelvis": "sphere",
    "L_Hip": "capsule", "L_Knee": "capsule", "L_Ankle": "box", "L_Toe": "box",
    "R_Hip": "capsule", "R_Knee": "capsule", "R_Ankle": "box", "R_Toe": "box",
    "Torso": "capsule", "Spine": "capsule", "Chest": "capsule",
    "Neck": "capsule", "Head": "sphere",
    "L_Thorax": "capsule", "L_Shoulder": "capsule", "L_Elbow": "capsule",
    "L_Wrist": "capsule", "L_Hand": "sphere",
    "R_Thorax": "capsule", "R_Shoulder": "capsule", "R_Elbow": "capsule",
    "R_Wrist": "capsule", "R_Hand": "sphere",
}
for _f in ["Index", "Middle", "Pinky", "Ring", "Thumb"]:
    for _s in "LR":
        for _i in "123":
            GEOM_TYPES_BASE[f"{_s}_{_f}{_i}"] = "capsule"

# joint 'user' fields + gear (skeleton_local.py GAINS_MJ table; gear is [2])
GAINS_MJ = {
    "L_Hip": [250, 2.5, 1, 500, 10, 2], "L_Knee": [250, 2.5, 1, 500, 10, 2],
    "L_Ankle": [150, 2.5, 1, 500, 10, 2], "L_Toe": [150, 1, 1, 500, 1, 1],
    "R_Hip": [250, 2.5, 1, 500, 10, 2], "R_Knee": [250, 2.5, 1, 500, 10, 2],
    "R_Ankle": [150, 1, 1, 500, 10, 2], "R_Toe": [150, 1, 1, 500, 1, 1],
    "Torso": [500, 5, 1, 500, 10, 2], "Spine": [500, 5, 1, 500, 10, 2],
    "Chest": [500, 5, 1, 500, 10, 2], "Neck": [150, 1, 1, 250, 50, 4],
    "Head": [150, 1, 1, 250, 50, 4],
    "L_Thorax": [200, 2, 1, 500, 50, 4], "L_Shoulder": [200, 2, 1, 500, 50, 4],
    "L_Elbow": [150, 1, 1, 150, 10, 2], "L_Wrist": [100, 1, 1, 150, 1, 1],
    "L_Hand": [50, 1, 1, 150, 1, 1],
    "R_Thorax": [200, 2, 1, 150, 10, 2], "R_Shoulder": [200, 2, 1, 250, 10, 2],
    "R_Elbow": [150, 1, 1, 150, 10, 2], "R_Wrist": [100, 1, 1, 150, 1, 1],
    "R_Hand": [50, 1, 1, 150, 1, 1],
}
for _f in ["Index", "Middle", "Pinky", "Ring", "Thumb"]:
    for _s in "LR":
        for _i in "123":
            GAINS_MJ[f"{_s}_{_f}{_i}"] = [100, 10, 1, 150]

EXCLUDE_CONTACTS = [
    ("Torso", "Chest"), ("Head", "Chest"),
    ("R_Knee", "R_Toe"), ("R_Knee", "L_Ankle"), ("R_Knee", "L_Toe"),
    ("L_Knee", "L_Toe"), ("L_Knee", "R_Ankle"), ("L_Knee", "R_Toe"),
    ("L_Shoulder", "Chest"), ("R_Shoulder", "Chest"),
]

UPRIGHT_ZERO_POSE_AA = [1.2091996, 1.2091996, 1.2091996]


@dataclasses.dataclass(frozen=True)
class RobotConfig:
    """Mirrors the reference robot_cfg (humanoid_env.py:221-239 +
    data/cfg/robot/smpl_humanoid.yaml)."""

    model: str = "smpl"
    mesh: bool = False
    upright_start: bool = False
    rel_joint_lm: bool = False       # has_jt_limit
    remove_toe: bool = False
    freeze_hand: bool = False
    real_weight: bool = True
    real_weight_porpotion_capsules: bool = True
    real_weight_porpotion_boxes: bool = True
    big_ankle: bool = True
    box_body: bool = True
    replace_feet: bool = True
    create_vel_sensors: bool = False
    sim_timestep_inv: int = 450


# ---------------------------------------------------------------------------
def compute_hull_dict(verts, jts, skin_weights, joint_names):
    """Per-joint convex hulls of the argmax-skin-weight vertex groups
    (smpl_local_robot.py get_geom_dict:146-173)."""
    from smplsim_tpu_torch import native

    vert_to_joint = np.asarray(skin_weights).argmax(axis=1)
    hulls = {}
    for jind, jname in enumerate(joint_names):
        vind = np.where(vert_to_joint == jind)[0]
        if len(vind) == 0:
            continue
        norm_verts = np.asarray(verts)[vind] - np.asarray(jts)[jind]
        faces, volume = native.convex_hull(norm_verts)
        hulls[jname] = {
            "norm_verts": norm_verts, "volume": volume, "faces": faces,
        }
    return hulls


def update_joint_limits(jr):
    """Relative joint-limit table (smpl_local_robot.py:176-249)."""
    pi = np.pi
    def s(n, lims):
        jr[n] = np.asarray(lims, dtype=np.float64)
    s("Head", [[-pi/2, pi/2]] * 3)
    s("Chest", [[-pi/3, pi/3]] * 3)
    s("Spine", [[-pi/3, pi/3]] * 3)
    s("Torso", [[-pi/3, pi/3]] * 3)
    for n in ["L_Thorax", "R_Thorax", "L_Shoulder", "R_Shoulder"]:
        s(n, [[-pi, pi]] * 3)
    for n in ["L_Hip", "R_Hip"]:
        s(n, [[-pi/2, pi/2]] * 3)
    for n in ["L_Knee", "R_Knee"]:
        s(n, [[-pi, pi], [-pi/32, pi/32], [-pi/32, pi/32]])
    for n in ["L_Ankle", "R_Ankle"]:
        s(n, [[-pi/2, pi/2]] * 3)
    for n in ["L_Toe", "R_Toe"]:
        s(n, [[-pi/2, pi/2], [-pi/4, pi/4], [-pi/4, pi/4]])
    return jr


def update_joint_limits_upright(jr):
    """Upright variant (smpl_local_robot.py:252-319): same table with the
    knee flexion moved to the y hinge."""
    jr = update_joint_limits(jr)
    pi = np.pi
    for n in ["L_Knee", "R_Knee"]:
        jr[n] = np.asarray(
            [[-pi/32, pi/32], [0, pi], [-pi/32, pi/32]], dtype=np.float64
        )
    return jr


# ---------------------------------------------------------------------------
class _Bone:
    def __init__(self, name):
        self.name = name
        self.pos = np.zeros(3)     # local offset in parent frame
        self.end = np.zeros(3)
        self.parent = None
        self.child = []
        self.lb = []
        self.ub = []


def _build_tree(offsets, parents_dict, jrange):
    names = list(offsets.keys())
    bones = {}
    root = _Bone(names[0])
    root.pos = np.asarray(offsets[names[0]], dtype=np.float64)
    bones[names[0]] = root
    for n in names[1:]:
        b = _Bone(n)
        b.pos = np.asarray(offsets[n], dtype=np.float64)
        jr = np.asarray(jrange[n])
        b.lb = np.rad2deg(jr[:, 0])
        b.ub = np.rad2deg(jr[:, 1])
        bones[n] = b
    for n in names[1:]:
        p = parents_dict[n]
        bones[n].parent = bones[p]
        bones[p].child.append(bones[n])
    for b in bones.values():
        if not b.child:
            b.end = b.pos.copy() + 0.002  # leaf quirk (skeleton_local.py:361)
        else:
            b.end = sum(c.pos for c in b.child) / len(b.child)
    return root, bones


def _capsule_radius(volume, side_len):
    """Radius r solving pi r^2 side_len + 4/3 pi r^3 = hull volume
    (skeleton_local.py:559-566)."""
    roots = np.polynomial.polynomial.Polynomial(
        [-volume, 0.0, side_len * np.pi, 4.0 / 3.0 * np.pi]
    ).roots()
    real = roots.real[np.abs(roots.imag) < 1e-5]
    real = real[real > 0]
    return float(real[0])


def build_mjcf(
    offsets: dict[str, np.ndarray],
    parents_dict: dict[str, str | None],
    joint_range: dict[str, np.ndarray],
    hull_dict: dict[str, dict[str, Any]],
    cfg: RobotConfig = RobotConfig(),
) -> str:
    """Emit the humanoid MJCF string (skeleton_local.py write_str)."""
    geom_types = dict(GEOM_TYPES_BASE)
    if not cfg.freeze_hand:
        geom_types["L_Hand"] = "box"
        geom_types["R_Hand"] = "box"
    if cfg.box_body:
        geom_types["Head"] = "box"
        geom_types["Pelvis"] = "box"
    if cfg.model == "smplx":
        geom_types["L_Wrist"] = "box"
        geom_types["R_Wrist"] = "box"

    jrange = {k: np.asarray(v, dtype=np.float64) for k, v in joint_range.items()}
    if cfg.rel_joint_lm:
        jrange = (update_joint_limits_upright(jrange) if cfg.upright_start
                  else update_joint_limits(jrange))

    root, bones = _build_tree(offsets, parents_dict, jrange)
    base_density = 1000.0 if cfg.real_weight else 500.0
    size_buffer: dict[str, np.ndarray] = {}
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
                    f'axis="{fmt(axis, 0)}" user="{user}" armature="0.01" '
                    f'range="{rng}" damping="0" stiffness="0"/>',
                    indent + 1,
                )
                joint_order.append(f"{bone.name}_{ax}")

        gtype = geom_types[bone.name]
        density = base_density
        hull = hull_dict[bone.name]
        e1 = np.zeros(3)
        e2 = bone.end.copy()
        sep = 0.45 if bone.name in ["Torso", "Chest", "Spine"] else 0.2
        e1 = e1 + e2 * sep
        e2 = e2 - e2 * sep

        if gtype == "capsule":
            side_len = np.linalg.norm(e2 - e1)
            r = _capsule_radius(hull["volume"], side_len)
            if bone.name in ["Torso", "Spine", "L_Hip", "R_Hip", "Chest"]:
                r *= 0.7
                if cfg.real_weight_porpotion_capsules:
                    density = (1 / 0.7**2) * base_density
            if bone.name in ["L_Knee", "R_Knee"]:
                r *= 0.9
                if cfg.real_weight_porpotion_capsules:
                    density = (1 / 0.9**2) * base_density
            w(
                f'<geom type="capsule" contype="1" conaffinity="1" '
                f'density="{density:.6f}" fromto="{fmt(np.concatenate([e1, e2]))}" '
                f'size="{r:.4f}" name="{bone.name}"/>',
                indent + 1,
            )
        elif gtype == "box":
            nv = hull["norm_verts"]
            min_v, max_v = nv.min(axis=0), nv.max(axis=0)
            pos = (e1 + e2) / 2
            size = max_v - min_v
            if cfg.upright_start:
                if bone.name in ("L_Toe", "R_Toe"):
                    size[0] = hull["volume"] / (size[2] * size[0])
                else:
                    size[2] = hull["volume"] / (size[1] * size[0])
            else:
                size[1] = hull["volume"] / (size[2] * size[0])
            size = size / 2
            if bone.name in ("L_Toe", "R_Toe"):
                if cfg.upright_start:
                    pos[2] = -bone.pos[2] / 2 - size_buffer[bone.parent.name][2] + size[2]
                    pos[1] = -bone.pos[1] / 2
                else:
                    pos[1] = -bone.pos[1] / 2 - size_buffer[bone.parent.name][1] + size[1]
                    pos[0] = -bone.pos[0] / 2
                if cfg.remove_toe:
                    size = size / 20
                    pos[1] = 0.0
                    pos[0] = 0.0
            rot = np.array([1.0, 0, 0, 0])

            if cfg.big_ankle:
                # bounding-box override (skeleton_local.py:617-638)
                size = max_v - min_v
                pos = (max_v + min_v) / 2
                size = size / 2
                if bone.name in ("L_Toe", "R_Toe"):
                    pnv = hull_dict[bone.parent.name]["norm_verts"]
                    pmin, pmax = pnv.min(axis=0), pnv.max(axis=0)
                    ppos = (pmax + pmin) / 2
                    if cfg.upright_start:
                        pos[2] = pmin[2] - bone.pos[2] + size[2]
                        pos[1] = ppos[1] - bone.pos[1]
                    else:
                        pos[1] = pmin[1] - bone.pos[1] + size[1]
                        pos[0] = ppos[0] - bone.pos[0]
                rot = np.array([1.0, 0, 0, 0])

            if bone.name == "Pelvis":
                size = size / 1.75
            if bone.name == "Head":
                size[0] /= 1.5
                if cfg.upright_start:
                    size[1] /= 1.5
                else:
                    size[2] /= 1.5
            if cfg.model == "smplx" and bone.name in ("L_Wrist", "R_Wrist"):
                size[0] /= 1.15
                size[1] /= 1.3
                if cfg.upright_start:
                    size[2] /= 1.7
                else:
                    size[1] /= 1.7
            if cfg.real_weight_porpotion_boxes:
                density = (
                    hull["volume"] / float(size[0] * size[1] * size[2] * 8)
                ) * base_density
            w(
                f'<geom type="box" pos="{fmt(pos)}" size="{fmt(size)}" '
                f'quat="{fmt(rot)}" density="{density:.6f}" name="{bone.name}"/>',
                indent + 1,
            )
            size_buffer[bone.name] = size
        else:  # sphere
            radius = float(np.cbrt(hull["volume"] * 3 / (4 * np.pi)))
            if bone.name == "Pelvis":
                radius *= 0.6
                if cfg.real_weight_porpotion_capsules:
                    density = (1 / 0.6**3) * base_density
            w(
                f'<geom type="sphere" size="{radius:.4f}" pos="0 0 0" '
                f'density="{density:.6f}" name="{bone.name}"/>',
                indent + 1,
            )

        for c in bone.child:
            emit(c, indent + 1)
        w("</body>", indent)

    # ---- document ----
    w('<mujoco model="humanoid">', 0)
    w('<compiler coordinate="local"/>', 1)
    w(f'<option timestep="{1.0 / cfg.sim_timestep_inv:.8f}"/>', 1)
    w("<default>", 1)
    w('<joint damping="0.0" armature="0.01" stiffness="0.0" limited="true"/>', 2)
    w('<geom conaffinity="1" condim="3" contype="7" margin="0.001" rgba="0.8 0.6 .4 1"/>', 2)
    w("</default>", 1)
    w("<worldbody>", 1)
    w('<geom conaffinity="1" condim="3" name="floor" pos="0 0 0" '
      'rgba="0.8 0.9 0.8 1" size="100 100 .2" type="plane"/>', 2)
    emit(root, 2)
    w("</worldbody>", 1)
    w("<actuator>", 1)
    for jn in joint_order:
        bone_name = jn[:-2]
        gear = GAINS_MJ[bone_name][2]
        w(f'<motor name="{jn}" joint="{jn}" gear="{gear}"/>', 2)
    w("</actuator>", 1)
    w("<contact>", 1)
    for b1, b2 in EXCLUDE_CONTACTS:
        if b1 in bones and b2 in bones:
            w(f'<exclude body1="{b1}" body2="{b2}"/>', 2)
    w("</contact>", 1)
    if cfg.create_vel_sensors:
        w("<sensor>", 1)
        order = list(offsets.keys())
        for stype in ["framelinvel", "frameangvel"]:
            for n in _dfs_names(root):
                w(f'<{stype} name="sensor_{n}_{stype}" objtype="xbody" objname="{n}"/>', 2)
        w("</sensor>", 1)
    w('<size njmax="700" nconmax="700"/>', 1)
    w("</mujoco>", 0)
    return out.getvalue()


def _dfs_names(root):
    out = [root.name]
    for c in root.child:
        out.extend(_dfs_names(c))
    return out


# ---------------------------------------------------------------------------
def build_robot_model(parser, betas=None, cfg: RobotConfig = RobotConfig(),
                      dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda"):
    """Full pipeline: beta -> offsets and hulls -> MJCF -> RobotModel.

    parser is a body_model.SMPLParser, betas (1, num_betas) or None (the
    template). Returns (RobotModel in `dtype` on `device`, mjcf_string,
    height); the primitive-geometry branch (mesh=False) of
    SMPL_Robot.load_from_skeleton (smpl_local_robot.py:1280-1505)."""
    from smplsim_tpu_torch.models import mjcf as mjcf_mod

    J = len(parser.parents)
    zero_pose = np.zeros((1, J * 3))
    if cfg.upright_start:
        zero_pose[0, :3] = UPRIGHT_ZERO_POSE_AA

    (verts, jts, skin_weights, joint_names, joint_offsets, parents_dict,
     channels, joint_range) = parser.get_offsets(betas=betas, zero_pose=zero_pose)
    hull_dict = compute_hull_dict(verts, jts, skin_weights, joint_names)
    xml = build_mjcf(joint_offsets, parents_dict, joint_range, hull_dict, cfg)
    model = mjcf_mod.parse_mjcf(xml, dtype=dtype, device=device)
    model = dataclasses.replace(model, humanoid_type=cfg.model)
    if cfg.upright_start:
        height = float(verts[:, 2].max() - verts[:, 2].min())
    else:
        height = float(verts[:, 1].max() - verts[:, 1].min())
    return model, xml, height
