"""MJCF <-> RobotModel bridge.

Port of smplsim_tpu/models/mjcf.py. Parses SMPLSim-style humanoid MJCF
(free root + 3-hinge bodies, one primitive geom per body: the format the
reference's skeleton writers and models/builder.py emit) into a RobotModel,
and emits MJCF back out for cross-validation against MuJoCo. Host work at
model-build time: numpy in float64, the inverse weights from the port's own
FK and mass matrix in float64 on the CPU, then the finished model in the
requested dtype on the requested device.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Any

import numpy as np
import torch

from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.models import spec
from smplsim_tpu_torch.models.gains import STABLEPD_GAINS

# MuJoCo compiler defaults
_DENSITY_DEFAULT = 1000.0
_FRICTION_DEFAULT = (1.0, 0.005, 0.0001)
_SOLREF_DEFAULT = (0.02, 1.0)
_SOLIMP_DEFAULT = (0.9, 0.95, 0.001, 0.5, 2.0)

_GEOM_TYPES = {"sphere": spec.GEOM_SPHERE, "capsule": spec.GEOM_CAPSULE, "box": spec.GEOM_BOX}


def _floats(s: str | None, default=None) -> np.ndarray | None:
    if s is None:
        return None if default is None else np.asarray(default, dtype=np.float64)
    return np.asarray([float(x) for x in s.split()], dtype=np.float64)


def _merge_defaults(elem: ET.Element, defaults: dict[str, str]) -> dict[str, str]:
    out = dict(defaults)
    out.update(elem.attrib)
    return out


def parse_mjcf(xml_string: str, dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> spec.RobotModel:
    """Parse an SMPLSim humanoid MJCF string into a RobotModel in `dtype` on
    `device`."""
    root = ET.fromstring(xml_string)

    # defaults (single unnamed default class, as the skeleton writers emit)
    joint_default: dict[str, str] = {}
    geom_default: dict[str, str] = {}
    default_el = root.find("default")
    if default_el is not None:
        jd = default_el.find("joint")
        gd = default_el.find("geom")
        if jd is not None:
            joint_default = dict(jd.attrib)
        if gd is not None:
            geom_default = dict(gd.attrib)

    option = root.find("option")
    timestep = 0.002
    gravity = np.array([0.0, 0.0, -9.81])
    if option is not None:
        if option.get("timestep"):
            timestep = float(option.get("timestep"))
        g = _floats(option.get("gravity"))
        if g is not None:
            gravity = g

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF missing <worldbody>")

    # floor
    floor_friction = np.asarray(_FRICTION_DEFAULT)
    floor_margin = 0.0
    floor_solref = np.asarray(_SOLREF_DEFAULT)
    floor_solimp = np.asarray(_SOLIMP_DEFAULT)
    for g in worldbody.findall("geom"):
        attrs = _merge_defaults(g, geom_default)
        if attrs.get("type") == "plane":
            floor_friction = _floats(attrs.get("friction"), _FRICTION_DEFAULT)
            floor_margin = float(attrs.get("margin", 0.0))
            floor_solref = _floats(attrs.get("solref"), _SOLREF_DEFAULT)
            floor_solimp = _floats(attrs.get("solimp"), _SOLIMP_DEFAULT)

    body_names: list[str] = []
    parents: list[int] = []
    body_pos: list[np.ndarray] = []
    body_quat: list[np.ndarray] = []
    jnt_range: list[np.ndarray] = []  # per hinge dof
    jnt_limited: list[bool] = []
    armature: list[float] = [0.0] * 6
    dof_damping: list[float] = [0.0] * 6

    geom_body: list[int] = []
    geom_type: list[int] = []
    geom_names: list[str] = []
    geom_pos: list[np.ndarray] = []
    geom_quat: list[np.ndarray] = []
    geom_size: list[np.ndarray] = []
    geom_friction: list[np.ndarray] = []
    geom_margin: list[float] = []
    geom_solref: list[np.ndarray] = []
    geom_solimp: list[np.ndarray] = []
    geom_contype: list[int] = []
    geom_conaffinity: list[int] = []
    body_geom_specs: dict[int, list[dict[str, Any]]] = {}

    def parse_body(el: ET.Element, parent_idx: int):
        idx = len(body_names)
        body_names.append(el.get("name", f"body{idx}"))
        parents.append(parent_idx)
        body_pos.append(_floats(el.get("pos"), (0, 0, 0)))
        body_quat.append(_floats(el.get("quat"), (1, 0, 0, 0)))
        body_geom_specs[idx] = []

        joints = el.findall("joint")
        free = el.find("freejoint") is not None or any(
            j.get("type") == "free" for j in joints
        )
        if idx == 0:
            if not free:
                raise ValueError("root body must have a free joint")
        else:
            hinges = [j for j in joints if j.get("type", "hinge") == "hinge"]
            if len(hinges) != 3:
                raise ValueError(
                    f"body {body_names[idx]}: expected 3 hinge joints, got {len(hinges)}"
                )
            for j in hinges:
                attrs = _merge_defaults(j, joint_default)
                rng = _floats(attrs.get("range"), (-180.0, 180.0))
                # MJCF ranges are degrees by default
                jnt_range.append(np.deg2rad(rng))
                jnt_limited.append(attrs.get("limited", "true").lower() == "true")
                armature.append(float(attrs.get("armature", 0.0)))
                dof_damping.append(float(attrs.get("damping", 0.0)))

        for g in el.findall("geom"):
            attrs = _merge_defaults(g, geom_default)
            gtype = _GEOM_TYPES[attrs.get("type", "sphere")]
            density = float(attrs.get("density", _DENSITY_DEFAULT))
            size = _floats(attrs.get("size"), (0, 0, 0))
            size = np.pad(size, (0, 3 - len(size)))
            fromto = _floats(attrs.get("fromto"))
            if fromto is not None:
                p1, p2 = fromto[:3], fromto[3:]
                pos = 0.5 * (p1 + p2)
                quat = spec.quat_z_to_vec(p2 - p1)
                size = np.array([size[0], 0.5 * np.linalg.norm(p2 - p1), 0.0])
            else:
                pos = _floats(attrs.get("pos"), (0, 0, 0))
                quat = _floats(attrs.get("quat"), (1, 0, 0, 0))
            geom_body.append(idx)
            geom_type.append(gtype)
            geom_names.append(attrs.get("name", f"geom{len(geom_names)}"))
            geom_pos.append(pos)
            geom_quat.append(quat)
            geom_size.append(size)
            geom_friction.append(_floats(attrs.get("friction"), _FRICTION_DEFAULT))
            geom_margin.append(float(attrs.get("margin", 0.0)))
            geom_solref.append(_floats(attrs.get("solref"), _SOLREF_DEFAULT))
            geom_solimp.append(_floats(attrs.get("solimp"), _SOLIMP_DEFAULT))
            geom_contype.append(int(attrs.get("contype", 1)))
            geom_conaffinity.append(int(attrs.get("conaffinity", 1)))
            body_geom_specs[idx].append(
                dict(type=gtype, size=size, pos=pos, quat=quat, density=density)
            )

        for child in el.findall("body"):
            parse_body(child, idx)

    top_bodies = worldbody.findall("body")
    if len(top_bodies) != 1:
        raise ValueError(f"expected exactly 1 humanoid root body, got {len(top_bodies)}")
    parse_body(top_bodies[0], -1)

    nbody = len(body_names)
    nu = 3 * (nbody - 1)

    # explicit contact excludes (<contact><exclude body1= body2=/>)
    excludes: list[tuple[int, int]] = []
    contact_el = root.find("contact")
    if contact_el is not None:
        for ex in contact_el.findall("exclude"):
            b1 = body_names.index(ex.get("body1"))
            b2 = body_names.index(ex.get("body2"))
            excludes.append((min(b1, b2), max(b1, b2)))

    # inertial properties from geoms (MuJoCo compiler equivalent)
    body_mass = np.zeros(nbody)
    body_ipos = np.zeros((nbody, 3))
    body_inertia = np.zeros((nbody, 3, 3))
    for b in range(nbody):
        gs = body_geom_specs[b]
        if gs:
            m, com, inertia = spec.body_inertial_from_geoms(gs)
            body_mass[b] = m
            body_ipos[b] = com
            body_inertia[b] = inertia

    # actuator order defines the control vector; SMPLSim writes one <motor>
    # per hinge in tree order so ctrl[i] drives dof 6+i. Verify that here.
    gear = np.ones(nu)
    actuator = root.find("actuator")
    if actuator is not None:
        motors = actuator.findall("motor")
        expect = []
        for b in range(1, nbody):
            for ax in "xyz":
                expect.append(f"{body_names[b]}_{ax}")
        got = [m.get("joint") for m in motors]
        if got != expect:
            raise ValueError("actuator order does not match tree dof order")
        gear = np.array([float(m.get("gear", 1.0)) for m in motors])

    # stable-PD gains + torque limits per actuated dof
    # (reference humanoid_env.py:36-110 GAINS table, build_pd_action_scale :325-370)
    jkp = np.zeros(nu)
    jkd = np.zeros(nu)
    torque_lim = np.zeros(nu)
    for b in range(1, nbody):
        g = STABLEPD_GAINS.get(body_names[b])
        if g is None:
            g = (300.0, 30.0, 1.0, 250.0)
        for k in range(3):
            jkp[3 * (b - 1) + k] = g[0]
            jkd[3 * (b - 1) + k] = g[1]
            torque_lim[3 * (b - 1) + k] = g[3]

    # PD action scale from joint ranges: 1.2x the max |limit|, capped at pi
    jr = np.stack(jnt_range)  # (nu,2)
    lim = np.minimum(1.2 * np.maximum(np.abs(jr[:, 0]), np.abs(jr[:, 1])), np.pi)
    pd_action_scale = lim.copy()
    pd_action_offset = np.zeros(nu)

    # the fields in `dtype` on the CPU first: the inverse weights are
    # computed from these values, as the JAX package computes them from its
    # arrays in `dtype`
    a = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64)).to(dtype)
    qpos0 = np.zeros(7 + nu)
    qpos0[0:3] = body_pos[0]
    qpos0[3:7] = body_quat[0]

    model = spec.RobotModel(
        body_pos=a(body_pos),
        body_quat=a(body_quat),
        body_mass=a(body_mass),
        body_ipos=a(body_ipos),
        body_inertia=a(body_inertia),
        jnt_range=a(jr),
        armature=a(armature),
        dof_damping=a(dof_damping),
        gear=a(gear),
        jkp=a(jkp),
        jkd=a(jkd),
        torque_lim=a(torque_lim),
        pd_action_scale=a(pd_action_scale),
        pd_action_offset=a(pd_action_offset),
        geom_pos=a(geom_pos),
        geom_quat=a(geom_quat),
        geom_size=a(geom_size),
        geom_friction=a(geom_friction),
        geom_margin=a(geom_margin),
        geom_solref=a(geom_solref),
        geom_solimp=a(geom_solimp),
        floor_friction=a(floor_friction),
        floor_margin=a(floor_margin),
        floor_solref=a(floor_solref),
        floor_solimp=a(floor_solimp),
        gravity=a(gravity),
        timestep=a(timestep),
        qpos0=a(qpos0),
        dof_invweight0=a(np.zeros(6 + nu)),
        body_invweight0=a(np.zeros((nbody, 2))),
        parents=tuple(parents),
        body_names=tuple(body_names),
        geom_body=tuple(geom_body),
        geom_type=tuple(geom_type),
        geom_names=tuple(geom_names),
        jnt_limited=tuple(jnt_limited),
        geom_contype=tuple(geom_contype),
        geom_conaffinity=tuple(geom_conaffinity),
        contact_excludes=tuple(excludes),
    )
    return _compute_invweights(model, dtype).to(device=device)


def _compute_invweights(model: spec.RobotModel, dtype: torch.dtype) -> spec.RobotModel:
    """Fill dof/body inverse weights: diagonal measures of M^-1 at qpos0.

    MuJoCo precomputes these at compile time (body_invweight0/dof_invweight0)
    and uses them as the diagonal approximation in the constraint-force
    regularizer R = (1-imp)/imp * diagApprox.
    """
    from smplsim_tpu_torch.physics import dynamics as _dyn
    from smplsim_tpu_torch.physics import kinematics as _kin
    from smplsim_tpu_torch.physics.topology import tree_masks

    m64 = model.to(torch.float64, "cpu")
    kin = _kin.fk(m64, m64.qpos0[None])
    M = _dyn.mass_matrix(m64, kin)[0].numpy()
    Minv = np.linalg.inv(M)
    dof_iw = np.diag(Minv).copy()

    body_dof = tree_masks(model.parents)["body_dof"]
    S = kin.S[0].numpy()  # (nv,6) about the world origin
    com = kin.com[0].numpy()
    body_iw = np.zeros((model.nbody, 2))
    for b in range(model.nbody):
        # body-COM point jacobians (3,nv): translation and rotation,
        # v_point(com) = omega x com + v_O
        mask = body_dof[b]
        Jr = (S[:, :3] * mask[:, None]).T
        Jt = (np.cross(S[:, :3], com[b][None, :] - 0.0) + S[:, 3:]).T * mask[None, :]
        At = Jt @ Minv @ Jt.T
        Ar = Jr @ Minv @ Jr.T
        body_iw[b, 0] = np.trace(At) / 3.0
        body_iw[b, 1] = np.trace(Ar) / 3.0

    # free-joint dofs: translational weight measured at the body FRAME origin,
    # rotational weight equals the body's rotational invweight
    mask0 = body_dof[0]
    p0 = kin.xpos[0, 0].numpy()
    Jt0 = (np.cross(S[:, :3], p0[None, :]) + S[:, 3:]).T * mask0[None, :]
    dof_iw[0:3] = np.trace(Jt0 @ Minv @ Jt0.T) / 3.0
    dof_iw[3:6] = body_iw[0, 1]

    return dataclasses.replace(
        model, dof_invweight0=torch.as_tensor(dof_iw).to(dtype),
        body_invweight0=torch.as_tensor(body_iw).to(dtype))


def parse_mjcf_file(path: str, dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cuda") -> spec.RobotModel:
    with open(path) as f:
        return parse_mjcf(f.read(), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Export: RobotModel -> MJCF (cross-validation against MuJoCo; also lets
# reference users take procedurally built robots back into MuJoCo).
# ---------------------------------------------------------------------------


def export_mjcf(model, timestep: float | None = None, with_sensors: bool = True) -> str:
    """Emit an MJCF string semantically equivalent to the RobotModel.

    Inertials are written explicitly (mass/COM/principal inertia) so the
    MuJoCo compiler reproduces the model's masses bit for bit regardless of geom
    densities.
    """
    if model.stacked:
        raise ValueError("export_mjcf takes a shared model")
    m = model
    f64 = lambda x: x.detach().to("cpu", torch.float64).numpy()
    ts = float(m.timestep) if timestep is None else timestep
    g = f64(m.gravity)
    lines = [
        '<mujoco model="smplsim_tpu_humanoid">',
        f'  <option timestep="{ts}" gravity="{g[0]} {g[1]} {g[2]}" integrator="Euler"/>',
        '  <compiler coordinate="local" angle="radian"/>',
        "  <default>",
        '    <joint damping="0" armature="0" stiffness="0" limited="true"/>',
        '    <geom conaffinity="1" condim="3" contype="7"/>',
        "  </default>",
        "  <worldbody>",
        (
            '    <geom name="floor" type="plane" pos="0 0 0" size="100 100 .2" '
            f'conaffinity="1" condim="3" contype="1" margin="{float(m.floor_margin)}" '
            f'friction="{" ".join(str(float(x)) for x in f64(m.floor_friction))}"/>'
        ),
    ]

    body_pos = f64(m.body_pos)
    body_quat = f64(m.body_quat)
    mass = f64(m.body_mass)
    ipos = f64(m.body_ipos)
    inertia = f64(m.body_inertia)
    jr = f64(m.jnt_range)
    arma = f64(m.armature)
    damping = f64(m.dof_damping)
    gpos = f64(m.geom_pos)
    gquat = f64(m.geom_quat)
    gsize = f64(m.geom_size)
    gfric = f64(m.geom_friction)
    gmargin = f64(m.geom_margin)

    children: dict[int, list[int]] = {b: [] for b in range(-1, m.nbody)}
    for b, p in enumerate(m.parents):
        children[p].append(b)
    body_geoms: dict[int, list[int]] = {b: [] for b in range(m.nbody)}
    for gi, b in enumerate(m.geom_body):
        body_geoms[b].append(gi)

    def fmt(v) -> str:
        return " ".join(f"{float(x):.10g}" for x in np.atleast_1d(v))

    def emit_body(b: int, indent: str):
        name = m.body_names[b]
        lines.append(
            f'{indent}<body name="{name}" pos="{fmt(body_pos[b])}" quat="{fmt(body_quat[b])}">'
        )
        # explicit inertial
        evals, evecs = np.linalg.eigh(inertia[b])
        if np.linalg.det(evecs) < 0:
            evecs[:, 0] = -evecs[:, 0]
        iquat = T.matrix_to_quat(torch.as_tensor(evecs)).numpy()
        lines.append(
            f'{indent}  <inertial pos="{fmt(ipos[b])}" quat="{fmt(iquat)}" '
            f'mass="{mass[b]:.10g}" diaginertia="{fmt(evals)}"/>'
        )
        if b == 0:
            lines.append(f'{indent}  <freejoint name="{name}"/>')
        else:
            d0 = m.body_dof_start(b)
            for k, ax in enumerate(("1 0 0", "0 1 0", "0 0 1")):
                u = 3 * (b - 1) + k
                lines.append(
                    f'{indent}  <joint name="{name}_{"xyz"[k]}" type="hinge" pos="0 0 0" '
                    f'axis="{ax}" range="{fmt(jr[u])}" armature="{arma[d0 + k]:.10g}" '
                    f'damping="{damping[d0 + k]:.10g}" stiffness="0"/>'
                )
        for gi in body_geoms[b]:
            gt = _GEOM_TYPE_STR[m.geom_type[gi]]
            nsize = {spec.GEOM_SPHERE: 1, spec.GEOM_CAPSULE: 2, spec.GEOM_BOX: 3}[m.geom_type[gi]]
            lines.append(
                f'{indent}  <geom name="{m.geom_names[gi]}" type="{gt}" '
                f'pos="{fmt(gpos[gi])}" quat="{fmt(gquat[gi])}" size="{fmt(gsize[gi][:nsize])}" '
                f'friction="{fmt(gfric[gi])}" margin="{gmargin[gi]:.10g}"/>'
            )
        for c in children[b]:
            emit_body(c, indent + "  ")
        lines.append(f"{indent}</body>")

    emit_body(0, "    ")
    lines.append("  </worldbody>")

    lines.append("  <actuator>")
    gear = f64(m.gear)
    for b in range(1, m.nbody):
        for k in range(3):
            jn = f"{m.body_names[b]}_{'xyz'[k]}"
            lines.append(f'    <motor name="{jn}" joint="{jn}" gear="{gear[3*(b-1)+k]:.10g}"/>')
    lines.append("  </actuator>")

    if with_sensors:
        lines.append("  <sensor>")
        for kind in ("framelinvel", "frameangvel"):
            for b in range(m.nbody):
                n = m.body_names[b]
                lines.append(
                    f'    <{kind} name="sensor_{n}_{kind}" objtype="xbody" objname="{n}"/>'
                )
        lines.append("  </sensor>")

    lines.append('  <size njmax="700" nconmax="700"/>')
    lines.append("</mujoco>")
    return "\n".join(lines)


_GEOM_TYPE_STR = {spec.GEOM_SPHERE: "sphere", spec.GEOM_CAPSULE: "capsule", spec.GEOM_BOX: "box"}
