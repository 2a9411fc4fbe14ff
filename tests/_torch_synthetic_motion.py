"""Synthetic mocap clips, numpy only: shared by the port's motion tests and
chip_smoke.py (which imports no JAX).

`smooth_motion` is tests/test_motion.py's: a pose_aa (T,J,3) and trans
(T,3) interpolated linearly through 4 random keyframes. `motion_set` makes
n clips of random lengths, three in four at 30 fps and one in four at 60;
the lengths come from their own stream, so the first k clips of a set of
n are the clips of a set of k.
"""
import numpy as np


def smooth_motion(rng, T, J, scale=0.4):
    """Random smooth pose_aa (T,J,3) + trans (T,3); rng a RandomState."""
    aa = rng.randn(4, J, 3) * scale
    t = np.linspace(0, 1, T)
    xs = np.linspace(0, 1, 4)
    pose = np.stack(
        [np.interp(t, xs, aa[:, j, d]) for j in range(J) for d in range(3)],
        axis=1,
    ).reshape(T, J, 3)
    trans = np.stack(
        [np.interp(t, xs, rng.randn(4) * 0.3) for _ in range(3)], axis=1
    )
    trans[:, 2] += 1.0
    return pose, trans


def motion_entry(rng, T, J, fps=30.0, scale=0.4):
    """One clip as a motion library reads it: {"pose_aa" (T, J*3), "trans"
    (T,3), "fps"}."""
    pose, trans = smooth_motion(rng, T, J, scale)
    return {"pose_aa": pose.reshape(T, -1), "trans": trans, "fps": float(fps)}


def motion_set(n, J=24, seed=0, min_len=60, max_len=600, scale=0.4):
    """{"clip_00000": entry, ...}: n clips of min_len..max_len frames
    (uniform integers), clip i at 60 fps where i % 4 == 3, else 30."""
    lengths = np.random.RandomState(seed).randint(min_len, max_len + 1, size=n)
    rng = np.random.RandomState(seed + 1)
    return {f"clip_{i:05d}": motion_entry(rng, int(lengths[i]), J,
                                          60.0 if i % 4 == 3 else 30.0, scale)
            for i in range(n)}
