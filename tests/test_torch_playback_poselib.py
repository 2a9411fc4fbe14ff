"""PyTorch port: HumanoidPlayback (envs/legacy.py) and poselib against the
JAX package, and the gap between the physics FK and the motion FK.

  * HumanoidPlayback: a batch of 2 envs (clips 1 and 2 of 3) over 9 steps
    against the JAX env's reset and step run eagerly per env, on the same
    library tables (float64, 1e-9): qpos, qvel, obs, reward, truncation;
    the port's step_autoreset (the JAX env's raises: its step takes no
    model) resets a finished env to clip (0 + 1) mod n, frame 0;
  * the physics FK of the library's qpos against its global_translation:
    the JAX package's own float64 gap on the clips chip_smoke.py phase 28
    plays (frames 1-64 of the first clips of its motion set, its heading
    draws), which chip_smoke.PLAYBACK_FK_GAP_MM records, and the port's;
  * poselib: SkeletonTree.from_mjcf on the XML that models/mjcf.export_mjcf
    writes, FK against the physics kinematics and the JAX state,
    keep_nodes_by_names, the retarget identity, SkeletonMotion velocities
    and crop, a from_npz round trip, from_fbx raising without the SDK, and
    the matplotlib drawings (float64, 1e-10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from smplsim_tpu import transforms as JT
from smplsim_tpu.envs import legacy as jax_legacy
from smplsim_tpu.motion import fk as jax_fk
from smplsim_tpu.motion import motion_lib as jax_ml
from smplsim_tpu.physics import kinematics as jax_kin
from smplsim_tpu.poselib import skeleton as jax_sk
from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.envs import HumanoidPlayback, PlaybackState
from smplsim_tpu_torch.models import mjcf
from smplsim_tpu_torch.motion.fk import HumanoidBatchFK
from smplsim_tpu_torch.motion.motion_lib import MotionLib, MotionLibConfig, tables_to_numpy
from smplsim_tpu_torch.physics import kinematics
from smplsim_tpu_torch.poselib import SkeletonMotion, SkeletonState, SkeletonTree, visualization
from tests._torch_port import models, rel_err
from tests._torch_synthetic_motion import motion_entry, motion_set


def t64(x):
    return torch.as_tensor(np.array(x, np.float64))


@pytest.fixture(scope="module")
def pair():
    return models()


# ------------------------------------------------------------- playback
def test_playback_matches_jax_env(pair):
    jm, tm = pair
    rng = np.random.RandomState(0)
    clips = {f"c{i}": motion_entry(rng, n, 24, fps, scale=0.4)
             for i, (n, fps) in enumerate(((9, 30.0), (7, 30.0), (12, 60.0)))}
    tl = MotionLib(HumanoidBatchFK.from_robot_model(tm), MotionLibConfig(), motion_dict=clips,
                   dtype=torch.float64).load_motions(np.arange(3), rng=np.random.default_rng(0))
    jl = jax_ml.MotionLib(jax_fk.HumanoidBatchFK.from_robot_model(jm),
                          jax_ml.MotionLibConfig(), motion_dict=clips)
    for k, v in tables_to_numpy(tl).items():
        setattr(jl, k, jnp.asarray(v))
    jl._num_motions = 3
    jenv = jax_legacy.HumanoidPlayback(jm, jl)
    env = HumanoidPlayback(tm, tl)

    st = env.reset(2, torch.Generator().manual_seed(0))
    assert st.task.motion_id.tolist() == [1, 1] and st.task.frame.tolist() == [0, 0]
    st.task = PlaybackState(motion_id=torch.tensor([1, 2], dtype=torch.int32),
                            frame=torch.zeros(2, dtype=torch.int32))
    jst = []
    for i, mid in enumerate((1, 2)):
        s = jenv.reset(jax.random.PRNGKey(i))
        assert int(s.task.motion_id) == 1
        jst.append(s.replace(task=s.task.replace(motion_id=jnp.int32(mid))))
    assert rel_err(np.stack([s.obs for s in jst]), st.obs) < 1e-9
    zero = torch.zeros(2, tm.nu, dtype=torch.float64)
    for _ in range(9):
        st = env.step(st, zero)
        jst = [jenv.step(s, jnp.zeros(jm.nu)) for s in jst]
        for name in ("qpos", "qvel"):
            assert rel_err(np.stack([getattr(s.phys, name) for s in jst]),
                           getattr(st.phys, name)) < 1e-9
        assert rel_err(np.stack([s.obs for s in jst]), st.obs) < 1e-9
        assert st.reward.tolist() == [float(s.reward) for s in jst] == [1.0, 1.0]
        assert st.truncated.tolist() == [bool(s.truncated) for s in jst]
        assert st.task.frame.tolist() == [int(s.task.frame) for s in jst]
    assert st.truncated.tolist() == [True, False] and st.task.frame.tolist() == [6, 9]
    # step_autoreset: env 0 is at its clip's end and resets, env 1 steps on
    nxt = env.step_autoreset(st, zero)
    assert nxt.truncated.tolist() == [True, False]
    assert nxt.task.motion_id.tolist() == [1, 2] and nxt.task.frame.tolist() == [0, 10]
    fresh = env.reset(1, torch.Generator().manual_seed(1))
    assert torch.equal(nxt.phys.qpos[0], fresh.phys.qpos[0])
    assert torch.equal(nxt.phys.qpos[1], tl.qpos[int(tl.length_starts[2]) + 10])
    assert torch.equal(nxt.kin.xpos, kinematics.fk(tm, nxt.phys.qpos).xpos)


def _played_clips(n_clips: int, frames: int = 64):
    """The first n_clips clips of chip_smoke.py's motion set that run past
    `frames` steps, cut to frames + 1, heading-turned by the set's draws:
    (pose (n,F,24,3), trans (n,F,3)) in float64."""
    motions = motion_set(n_clips)
    angles = np.random.default_rng(0).uniform(-np.pi, np.pi, size=n_clips)
    keep = [i for i, m in enumerate(motions.values()) if len(m["trans"]) > frames + 1]
    pose = np.stack([list(motions.values())[i]["pose_aa"][:frames + 1].reshape(-1, 24, 3)
                     for i in keep])
    trans = np.stack([list(motions.values())[i]["trans"][:frames + 1] for i in keep])
    a = angles[keep]
    rq = np.stack([np.cos(a / 2), 0 * a, 0 * a, np.sin(a / 2)], -1)
    root_q = JT.quat_mul(jnp.asarray(rq)[:, None], JT.exp_map_to_quat(jnp.asarray(pose[:, :, 0])))
    pose[:, :, 0] = np.asarray(JT.quat_to_exp_map(root_q))
    Rz = np.stack([np.stack([np.cos(a), -np.sin(a), 0 * a], -1),
                   np.stack([np.sin(a), np.cos(a), 0 * a], -1),
                   np.stack([0 * a, 0 * a, 0 * a + 1], -1)], -2)
    trans = np.einsum("ntk,njk->ntj", trans - trans[:, :1], Rz) + trans[:, :1]
    return pose, trans, keep


def test_physics_fk_against_library_gap(pair):
    """The physics FK (kinematics.fk) of the library's qpos lands on the
    library's global_translation up to rounding: the offsets the library
    rounds to 5 decimals are the baked humanoid's 4-decimal ones."""
    jm, tm = pair
    pose, trans, keep = _played_clips(chip_smoke.PLAYBACK_CMP_CLIPS)
    n, F = pose.shape[:2]
    jout = jax_fk.HumanoidBatchFK.from_robot_model(jm).fk_batch(
        jnp.asarray(pose), jnp.asarray(trans), return_full=True)
    kin = jax.jit(jax.vmap(lambda q: jax_kin.fk(jm, q)))(jout["qpos"].reshape(n * F, -1))
    gap = np.linalg.norm(np.asarray(kin.xpos).reshape(n, F, 24, 3)
                         - np.asarray(jout["global_translation"]), axis=-1)[:, 1:] * 1000.0
    tout = HumanoidBatchFK.from_robot_model(tm).fk_batch(t64(pose), t64(trans), return_full=True)
    tgap = torch.linalg.norm(kinematics.fk(tm, tout["qpos"].reshape(n * F, -1)).xpos
                             .reshape(n, F, 24, 3) - tout["global_translation"],
                             dim=-1)[:, 1:] * 1000.0
    print(f"clips {keep}: JAX gap mean {gap.mean():.3e} max {gap.max():.3e} mm; port "
          f"mean {tgap.mean():.3e} max {tgap.max():.3e} mm")
    ref = chip_smoke.PLAYBACK_FK_GAP_MM
    assert len(keep) >= chip_smoke.PLAYBACK_CMP_CLIPS // 2
    assert gap.mean() <= ref["mean"] and gap.max() <= ref["max"]
    assert tgap.mean() <= ref["mean"] and tgap.max() <= ref["max"]


# -------------------------------------------------------------- poselib
def test_skeleton_tree_from_mjcf_and_robot_model(pair):
    jm, tm = pair
    xml = mjcf.export_mjcf(tm)
    tree = SkeletonTree.from_mjcf(xml)
    assert tree == SkeletonTree.from_robot_model(tm)
    assert tree.node_names == list(tm.body_names)
    assert tuple(tree.parent_indices) == tuple(tm.parents)
    ref = jax_sk.SkeletonTree.from_mjcf(xml)
    assert ref.node_names == tree.node_names
    assert np.array_equal(ref.local_translation, tree.local_translation)
    path = mjcf.__file__  # a path that is not XML
    with pytest.raises(Exception):
        SkeletonTree.from_mjcf(path)


def test_skeleton_fk_matches_physics_and_jax(pair):
    jm, tm = pair
    tree = SkeletonTree.from_robot_model(tm)
    rng = np.random.RandomState(0)
    qpos = np.zeros((3, tm.nq))
    qpos[:, 0:3] = [0.3, -0.2, 1.0]
    q = rng.randn(3, 4)
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    qpos[:, 7:] = rng.uniform(-0.5, 0.5, (3, tm.nq - 7))
    local_q = torch.cat([t64(qpos[:, None, 3:7]),
                         T.euler_xyz_to_quat(t64(qpos[:, 7:]).reshape(3, -1, 3))], 1)
    st = SkeletonState(tree, local_q, t64(qpos[:, :3]))
    kin = kinematics.fk(tm, t64(qpos))
    assert rel_err(kin.xpos, st.global_translation) < 1e-10
    dot = (st.global_rotation * kinematics.body_quats(tm, t64(qpos))).sum(-1).abs()
    assert rel_err(np.ones(dot.shape), dot) < 1e-10
    jst = jax_sk.SkeletonState(jax_sk.SkeletonTree.from_robot_model(jm), jnp.asarray(local_q),
                               jnp.asarray(qpos[:, :3]))
    assert rel_err(jst.global_translation, st.global_translation) < 1e-12
    assert rel_err(jst.global_rotation, st.global_rotation) < 1e-12
    # global -> local round trip
    back = SkeletonState.from_rotation_and_root_translation(tree, st.global_rotation,
                                                            st.root_translation, is_local=False)
    assert rel_err(jst.global_translation, back.global_translation) < 1e-12


def test_keep_nodes_reaccumulates_translation(pair):
    jm, tm = pair
    tree = SkeletonTree(["a", "b", "c", "d"], [-1, 0, 1, 2],
                        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    sub = tree.keep_nodes_by_names(["a", "c", "d"])
    assert sub.node_names == ["a", "c", "d"] and list(sub.parent_indices) == [-1, 0, 1]
    assert np.array_equal(sub.local_translation, [[0, 0, 0], [1, 1, 0], [0, 0, 1]])
    full = SkeletonTree.from_robot_model(tm)
    keep = [n for n in full.node_names if n not in ("L_Knee", "R_Toe", "Spine", "L_Hand")]
    ours = full.keep_nodes_by_names(keep)
    ref = jax_sk.SkeletonTree.from_robot_model(jm).keep_nodes_by_names(keep)
    assert ours.node_names == ref.node_names
    assert np.array_equal(ours.parent_indices, ref.parent_indices)
    assert np.array_equal(ours.local_translation, ref.local_translation)


def test_retarget_identity_and_motion(pair):
    jm, tm = pair
    tree = SkeletonTree.from_robot_model(tm)
    jtree = jax_sk.SkeletonTree.from_robot_model(jm)
    rng = np.random.RandomState(1)
    aa = rng.randn(5, len(tree), 3) * 0.2
    root = rng.randn(5, 3) * 0.1 + [0, 0, 1.0]
    motion = SkeletonMotion(tree, T.exp_map_to_quat(t64(aa)), t64(root), fps=30)
    jmotion = jax_sk.SkeletonMotion(jtree, JT.exp_map_to_quat(jnp.asarray(aa)),
                                    jnp.asarray(root), fps=30)
    mapping = {n: n for n in tree.node_names}
    ident = np.array([1.0, 0, 0, 0])
    out = motion.retarget_to_by_tpose(mapping, SkeletonState.zero_pose(tree, "cpu"),
                                      SkeletonState.zero_pose(tree, "cpu"), ident, 1.0)
    ref = jmotion.retarget_to_by_tpose(mapping, jax_sk.SkeletonState.zero_pose(jtree),
                                       jax_sk.SkeletonState.zero_pose(jtree),
                                       jnp.asarray(ident), 1.0)
    assert rel_err(ref.global_rotation, out.global_rotation) < 1e-10
    assert rel_err(ref.root_translation, out.root_translation) < 1e-10
    dot = (out.global_rotation * motion.global_rotation).sum(-1).abs()
    assert rel_err(np.ones(dot.shape), dot) < 1e-9
    for name in ("global_velocity", "global_angular_velocity"):
        assert rel_err(getattr(jmotion, name), getattr(motion, name)) < 1e-10, name
    c = motion.crop(1, 4)
    assert c.local_rotation.shape[0] == 3 and c.fps == 30
    assert rel_err(jmotion.crop(1, 4).global_translation, c.global_translation) < 1e-12


def test_from_npz_round_trip_and_fbx(pair, tmp_path):
    jm, tm = pair
    tree = SkeletonTree.from_robot_model(tm)
    rng = np.random.RandomState(2)
    lr = np.asarray(T.exp_map_to_quat(t64(rng.randn(4, len(tree), 3) * 0.3)))
    path = str(tmp_path / "clip.npz")
    np.savez(path, node_names=np.array(tree.node_names), parent_indices=tree.parent_indices,
             local_translation=tree.local_translation, local_rotation=lr,
             root_translation=rng.randn(4, 3), fps=np.array(60.0))
    m = SkeletonMotion.from_npz(path, device="cpu")
    ref = jax_sk.SkeletonMotion.from_npz(path)
    assert m.skeleton_tree == tree and m.fps == ref.fps == 60.0
    assert rel_err(ref.global_translation, m.global_translation) < 1e-12
    with pytest.raises(NotImplementedError):
        SkeletonMotion.from_fbx(str(tmp_path / "clip.fbx"))


def test_visualization_draws(pair, tmp_path):
    jm, tm = pair
    tree = SkeletonTree.from_robot_model(tm)
    rng = np.random.RandomState(3)
    motion = SkeletonMotion(tree, T.exp_map_to_quat(t64(rng.randn(3, len(tree), 3) * 0.2)),
                            t64(np.tile([0, 0, 1.0], (3, 1))), fps=30)
    st = SkeletonState(tree, motion.local_rotation[0], motion.root_translation[0])
    ax = visualization.plot_skeleton_state(st, show_axes=True, title="t")
    assert len(ax.lines) >= len(tree) - 1
    grid = visualization.plot_skeleton_motion_frames(motion, path=str(tmp_path / "g.png"))
    assert (tmp_path / "g.png").stat().st_size > 1000 and grid.endswith("g.png")
    gif = visualization.animate_skeleton_motion(motion, str(tmp_path / "m.gif"))
    assert (tmp_path / "m.gif").stat().st_size > 1000 and gif.endswith("m.gif")
    with pytest.raises(ValueError):
        visualization.plot_skeleton_state(motion)
