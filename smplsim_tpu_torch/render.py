"""Offline rollout rendering: geom-level matplotlib -> GIF or mp4 (port of
smplsim_tpu/render.py).

The reference dumps eval videos through mujoco.Renderer and imageio. This
renderer needs no GL backend and no ffmpeg: it draws the robot's collision
geoms (capsules as thick segments, boxes as filled faces, spheres as discs)
with matplotlib's 3-D axes and writes an animated GIF through imageio (an
mp4 through OpenCV), enough to check physics plausibility and policy
behavior offline. For pixel-accurate rendering, export the MJCF
(models/mjcf.py) and replay the recorded qpos through mujoco.Renderer on a
machine with GL.

The FK of every frame runs in one batched call on the model's device; the
drawing is host work. matplotlib, imageio and cv2 are imported only inside
the functions that draw.
"""
from __future__ import annotations

import numpy as np

import torch

from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.models.spec import GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, RobotModel
from smplsim_tpu_torch.physics import kinematics
from smplsim_tpu_torch.physics.precision import ieee_fp32


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _geom_world_np(model: RobotModel, xpos, xmat, g):
    b = model.geom_body[g]
    R_b = xmat[b]
    pos = xpos[b] + R_b @ _np(model.geom_pos[g])
    Rg = R_b @ _np(T.quat_to_matrix(model.geom_quat[g].detach().cpu().double()))
    return pos, Rg


@ieee_fp32()
def _fk_np(model: RobotModel, qpos) -> tuple[np.ndarray, np.ndarray]:
    """(xpos (T,J,3), xmat (T,J,3,3)) of (T, nq) frames, one batched FK on
    the model's device."""
    q = torch.as_tensor(_np(qpos), dtype=model.dtype, device=model.device)
    kin = kinematics.fk(model, q)
    return _np(kin.xpos), _np(kin.xmat)


_BOX_FACES = [
    (0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
    (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5),
]


def draw_frame(ax, model: RobotModel, qpos, color="#3070b0", floor=True,
               kin_np=None):
    """Draw one pose's geoms onto a 3-D matplotlib axis. `kin_np` optionally
    provides precomputed (xpos, xmat) of the pose (render_rollout computes
    every frame's at once)."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if kin_np is None:
        xpos, xmat = (a[0] for a in _fk_np(model, _np(qpos)[None]))
    else:
        xpos, xmat = kin_np

    if floor:
        s = 1.5
        ax.add_collection3d(Poly3DCollection(
            [[(-s, -s, 0), (s, -s, 0), (s, s, 0), (-s, s, 0)]],
            facecolor="#dddddd", alpha=0.4, zorder=0,
        ))

    for g, t in enumerate(model.geom_type):
        pos, Rg = _geom_world_np(model, xpos, xmat, g)
        size = _np(model.geom_size[g])
        if t == GEOM_CAPSULE:
            a = pos - Rg[:, 2] * size[1]
            b = pos + Rg[:, 2] * size[1]
            lw = max(size[0] * 150, 2.0)
            ax.plot(*zip(a, b), lw=lw, color=color,
                    solid_capstyle="round", alpha=0.9)
        elif t == GEOM_SPHERE:
            ax.plot([pos[0]], [pos[1]], [pos[2]], "o",
                    ms=max(size[0] * 180, 4), color=color, alpha=0.9)
        elif t == GEOM_BOX:
            corners = np.array([
                pos + Rg @ (size * np.array([sx, sy, sz]))
                for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
            ])
            ax.add_collection3d(Poly3DCollection(
                [[corners[i] for i in face] for face in _BOX_FACES],
                facecolor=color, edgecolor="k", lw=0.2, alpha=0.8,
            ))


def render_rollout(
    model: RobotModel,
    qpos_traj,
    path: str,
    fps: int = 30,
    every: int = 1,
    figsize=(5, 5),
    follow: bool = True,
):
    """Render a (T, nq) qpos trajectory to `path` (.gif or .mp4).

    The container is chosen by extension: .mp4 encodes through OpenCV
    (mp4v, no ffmpeg needed), anything else goes through imageio's GIF
    writer.
    `every` subsamples frames (every=2 halves the frame count). `follow`
    keeps the camera centered on the root. Returns the number of frames
    written.
    """
    import imageio.v2 as imageio
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    qpos_traj = _np(qpos_traj)[::every]
    # one batched FK for all frames on the model's device, the drawing after
    xpos_all, xmat_all = _fk_np(model, qpos_traj)
    frames = []
    fig = plt.figure(figsize=figsize, dpi=80)
    for i, qpos in enumerate(qpos_traj):
        fig.clf()
        ax = fig.add_subplot(111, projection="3d")
        draw_frame(ax, model, qpos, kin_np=(xpos_all[i], xmat_all[i]))
        c = qpos[0:3] if follow else np.zeros(3)
        ax.set_xlim(c[0] - 1.0, c[0] + 1.0)
        ax.set_ylim(c[1] - 1.0, c[1] + 1.0)
        ax.set_zlim(0.0, 2.0)
        ax.set_box_aspect((1, 1, 1))
        ax.axis("off")
        fig.tight_layout(pad=0)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(buf.copy())
    plt.close(fig)
    if path.lower().endswith(".mp4"):
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps / every, (w, h)
        )
        if not vw.isOpened():
            raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
    else:
        imageio.mimsave(path, frames, duration=1000.0 / (fps / every), loop=0)
    return len(frames)
