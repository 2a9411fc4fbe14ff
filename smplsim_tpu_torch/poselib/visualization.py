"""Matplotlib skeleton visualization (port of
smplsim_tpu/poselib/visualization.py).

Draw a SkeletonState as a 3-D bone diagram with joint-frame axes, animate a
SkeletonMotion, and dump frame sequences to mp4/gif. Matplotlib is
imported only inside the functions that draw, so import errors surface
only on use; the states may live on any device (they are copied to the
host to draw).
"""
from __future__ import annotations

import numpy as np
import torch


def _require_plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt  # noqa: F401

    return plt


def _bone_segments(tree, gt):
    """(nbones, 2, 3) line segments parent->child."""
    segs = []
    for i, p in enumerate(tree.parent_indices):
        if p >= 0:
            segs.append([gt[p], gt[i]])
    return np.asarray(segs)


def plot_skeleton_state(state, ax=None, color="tab:blue", show_axes=False,
                        axis_len=0.05, title=None):
    """Draw one pose (Draw3DSkeletonState). Returns the matplotlib Axes."""
    from smplsim_tpu_torch import transforms as T

    plt = _require_plt()
    gt = state.global_translation.detach().cpu().numpy()
    if gt.ndim != 2:
        raise ValueError("plot_skeleton_state wants an unbatched state")
    if ax is None:
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")

    segs = _bone_segments(state.skeleton_tree, gt)
    for a, b in segs:
        ax.plot(*np.stack([a, b]).T, color=color, lw=2)
    ax.scatter(gt[:, 0], gt[:, 1], gt[:, 2], color=color, s=12)

    if show_axes:
        gr = state.global_rotation.detach().cpu()
        for c, axis in zip("rgb", np.eye(3)):
            tips = gt + T.quat_rotate(gr, torch.as_tensor(axis, dtype=gr.dtype)).numpy() * axis_len
            for j in range(gt.shape[0]):
                ax.plot(*np.stack([gt[j], tips[j]]).T, color=c, lw=0.8)

    center = gt.mean(axis=0)
    r = max(np.abs(gt - center).max(), 0.5)
    ax.set_xlim(center[0] - r, center[0] + r)
    ax.set_ylim(center[1] - r, center[1] + r)
    ax.set_zlim(center[2] - r, center[2] + r)
    if title:
        ax.set_title(title)
    return ax


def plot_skeleton_motion_frames(motion, frames=None, cols=4, path=None):
    """Grid of poses from a motion (Draw3DSkeletonMotion still-frame view)."""
    plt = _require_plt()
    Tn = motion.local_rotation.shape[0]
    if frames is None:
        frames = np.linspace(0, Tn - 1, min(8, Tn)).astype(int)
    rows = (len(frames) + cols - 1) // cols
    fig = plt.figure(figsize=(3 * cols, 3 * rows))
    from smplsim_tpu_torch.poselib.skeleton import SkeletonState

    for i, f in enumerate(frames):
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        st = SkeletonState(
            motion.skeleton_tree,
            motion.local_rotation[f],
            motion.root_translation[f],
        )
        plot_skeleton_state(st, ax=ax, title=f"t={f}")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=80)
        plt.close(fig)
        return path
    return fig


def animate_skeleton_motion(motion, path, fps=None, stride=1):
    """Render a SkeletonMotion to mp4/gif (plt_plotter animation loop)."""
    plt = _require_plt()
    from matplotlib import animation

    from smplsim_tpu_torch.poselib.skeleton import SkeletonState

    fps = fps or getattr(motion, "fps", 30)
    gt_all = motion.global_translation.detach().cpu().numpy()[::stride]
    tree = motion.skeleton_tree

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")

    def draw(i):
        ax.cla()
        st = SkeletonState(
            tree,
            motion.local_rotation[i * stride],
            motion.root_translation[i * stride],
        )
        plot_skeleton_state(st, ax=ax, title=f"frame {i * stride}")

    anim = animation.FuncAnimation(
        fig, draw, frames=gt_all.shape[0], interval=1000.0 * stride / fps
    )
    writer = "pillow" if path.endswith(".gif") else "ffmpeg"
    anim.save(path, writer=writer, fps=max(int(fps / stride), 1))
    plt.close(fig)
    return path
