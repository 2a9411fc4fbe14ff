"""PyTorch port: transforms, motion/fk.py and motion/motion_lib.py against
the JAX package, and the float32 matmul pin (physics/precision.py).

  * the 16 transforms the motion code added, on both sides of every
    threshold (quat_to_angle_axis's 1e-5, quat_slerp's 1e-5 and q1 = -q0,
    exp_map_to_quat's 1e-9, matrix_to_euler_xyz's clamp), and the gradient
    of exp_map_to_quat at exactly zero against jax.grad (float64, 1e-12);
  * gaussian_filter1d_time (and its padded form) against JAX and scipy, and
    fix_continuous_dof on a trajectory whose flips fire (float64, 1e-12);
  * HumanoidBatchFK.fk_batch(return_full=True), every key, and
    qpos_to_pose_aa (float64, 1e-9), and the padded batch of clips of mixed
    length and fps against per-clip calls (float64, 1e-12; the per-clip
    calls are held against JAX through the float64 library below);
  * MotionLib on 3 clips of different lengths at 30 and 60 fps with the
    heading on: the tables against the JAX library's through
    tables_to_numpy (both float32: 5e-5 by |a-b|/(1+|a|), velocities being
    differences of float32 positions over dt), in float64 against the JAX
    package's load computed in float64 (1e-9), the batched load against the
    per-clip load (float64 1e-12), get_motion_state and
    get_motion_state_intervaled at fed times on the same float64 tables
    (1e-9), the PMCP weights, the SMPLH 156-wide pose, a pkl directory;
  * the pin: with the process at TF32, set through the legacy call
    (torch.set_float32_matmul_precision("high")) or through the per-backend
    fp32_precision, code inside engine.control_step, HumanoidEnv.step and
    MotionLib.get_motion_state sees "ieee" matrix products, and the
    caller's setting is back afterwards, also after an exception.

JAX's fix_continuous_dof scans are compiled at three clip lengths.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from smplsim_tpu import transforms as JT
from smplsim_tpu.motion import fk as jax_fk
from smplsim_tpu.motion import motion_lib as jax_ml
from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.envs import HumanoidSpeed, SpeedConfig
from smplsim_tpu_torch.motion import fk as torch_fk
from smplsim_tpu_torch.motion import motion_lib
from smplsim_tpu_torch.motion.motion_lib import (MotionLib, MotionLibConfig, TABLES,
                                                 tables_to_numpy)
from smplsim_tpu_torch.physics import engine, kinematics
from smplsim_tpu_torch.physics.precision import ieee_fp32
from tests._torch_port import models, rel_err
from tests._torch_synthetic_motion import motion_entry, smooth_motion

LENGTHS = (12, 17, 23)
FPS = (30.0, 60.0, 30.0)


def t64(x):
    return torch.as_tensor(np.array(x, np.float64))


@pytest.fixture(scope="module")
def pair():
    jm, tm = models()
    return (jm, tm, jax_fk.HumanoidBatchFK.from_robot_model(jm),
            torch_fk.HumanoidBatchFK.from_robot_model(tm))


@pytest.fixture(scope="module")
def clips():
    rng = np.random.RandomState(4)
    return {f"m{i}": motion_entry(rng, n, 24, fps, scale=0.5)
            for i, (n, fps) in enumerate(zip(LENGTHS, FPS))}


# ------------------------------------------------------------- transforms
def _quats(rng, n):
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_transforms_match_jax():
    rng = np.random.RandomState(0)
    q, q1 = _quats(rng, 64), _quats(rng, 64)
    v, e = rng.randn(64, 3), rng.randn(64, 3)
    m = np.asarray(JT.quat_to_matrix(jnp.asarray(q)))
    tn = rng.randn(64, 6)
    ang = rng.randn(64) * 10
    cases = [
        ("wxyz_to_xyzw", (q,)), ("xyzw_to_wxyz", (q,)), ("quat_unit", (rng.randn(64, 4),)),
        ("quat_rotate_inverse", (q, v)), ("quat_to_exp_map", (q,)),
        ("euler_xyz_to_matrix", (e,)), ("matrix_to_euler_xyz", (m,)),
        ("quat_to_euler_xyz", (q,)), ("calc_heading_quat", (q,)),
        ("tan_norm_to_matrix", (tn,)), ("normalize_angle", (ang,)),
        ("quat_diff_angular_velocity", (q, q1, 1 / 30)),
    ]
    for name, args in cases:
        targs = [t64(a) if isinstance(a, np.ndarray) else a for a in args]
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        assert rel_err(getattr(JT, name)(*jargs), getattr(T, name)(*targs)) < 1e-12, name
    a_j, x_j = JT.quat_to_angle_axis(jnp.asarray(q))
    a_t, x_t = T.quat_to_angle_axis(t64(q))
    assert rel_err(a_j, a_t) < 1e-12 and rel_err(x_j, x_t) < 1e-12
    for shape in ((), (3,), (2, 5)):
        assert rel_err(JT.quat_identity(shape, jnp.float64),
                       T.quat_identity(shape, torch.float64, "cpu")) == 0.0
    x = np.array([-1.0, 0.0, 1e-20, 1e-18, 3.0])
    assert rel_err(jnp.sqrt(jnp.maximum(jnp.asarray(x), 1e-18)), T.safe_sqrt(t64(x))) == 0.0


def test_clamped_euler_and_angle_axis_threshold():
    """matrix_to_euler_xyz clamps m[0,2] just past +-1; quat_to_angle_axis on
    both sides of |xyz| = 1e-5 (angle 0, axis z below)."""
    m = np.tile(np.eye(3), (4, 1, 1))
    m[:, 0, 2] = [1.0 + 1e-12, -1.0 - 1e-12, 0.3, 1.0]
    assert rel_err(JT.matrix_to_euler_xyz(jnp.asarray(m)), T.matrix_to_euler_xyz(t64(m))) < 1e-12
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    s = np.array([2e-5, 1.0001e-5, 0.9999e-5, 5e-6, 0.0])
    q = np.concatenate([np.sqrt(1 - s ** 2)[:, None], s[:, None] * axis], -1)
    q = np.concatenate([q, -q])
    a_j, x_j = JT.quat_to_angle_axis(jnp.asarray(q))
    a_t, x_t = T.quat_to_angle_axis(t64(q))
    assert rel_err(a_j, a_t) < 1e-12 and rel_err(x_j, x_t) < 1e-12
    above = np.asarray(a_t[:2]) != 0
    below = x_t[2:5].numpy()
    assert above.all() and (np.asarray(a_t[2:5]) == 0).all() and (below == [0, 0, 1]).all()


def test_slerp_both_sides_of_its_thresholds():
    rng = np.random.RandomState(1)
    q0 = _quats(rng, 1)[0]
    axis = np.array([0.0, 0.6, 0.8])
    rows = []
    for half in (0.0, 5e-6, 0.9999e-5, 1.0001e-5, 2e-5, 0.3, 2.5):
        dq = np.concatenate([[np.cos(half)], np.sin(half) * axis])
        q1 = np.asarray(JT.quat_mul(jnp.asarray(q0), jnp.asarray(dq)))
        rows += [(q0, q1), (q0, -q1)]
    a = np.stack([r[0] for r in rows])
    b = np.stack([r[1] for r in rows])
    for t in (0.0, 0.37, 1.0):
        assert rel_err(JT.quat_slerp(jnp.asarray(a), jnp.asarray(b), t),
                       T.quat_slerp(t64(a), t64(b), t)) < 1e-12
    tt = rng.rand(len(rows), 1)
    assert rel_err(JT.quat_slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(tt)),
                   T.quat_slerp(t64(a), t64(b), t64(tt))) < 1e-12


def test_exp_map_value_and_gradient_at_zero():
    e = np.zeros((6, 3))
    e[1] = [3e-10, 0, 0]         # below eps = 1e-9
    e[2] = [0, 2e-9, 0]          # above
    e[3] = [0.3, -0.2, 0.5]
    e[4] = [1e-5, 0, 0]
    w = np.random.RandomState(2).randn(6, 4)
    assert rel_err(JT.exp_map_to_quat(jnp.asarray(e)), T.exp_map_to_quat(t64(e))) < 1e-12
    g_j = jax.grad(lambda x: jnp.sum(JT.exp_map_to_quat(x) * jnp.asarray(w)))(jnp.asarray(e))
    x = t64(e).requires_grad_(True)
    (g_t,) = torch.autograd.grad((T.exp_map_to_quat(x) * t64(w)).sum(), x)
    assert torch.isfinite(g_t).all()
    assert rel_err(g_j, g_t) < 1e-12
    # at exactly zero the derivative of xyz is the series limit 0.5 I
    assert torch.allclose(g_t[0], 0.5 * t64(w)[0, 1:])


# ----------------------------------------------------------------- fk.py
def test_gaussian_filter_matches_jax_and_scipy():
    x = np.random.RandomState(3).randn(2, 23, 5, 3)
    out = torch_fk.gaussian_filter1d_time(t64(x))
    assert rel_err(jax_fk.gaussian_filter1d_time(jnp.asarray(x)), out) < 1e-12
    assert rel_err(scipy.ndimage.gaussian_filter1d(x, 2.0, axis=-3, mode="nearest"), out) < 1e-12
    # the padded form: row i ends at frame lengths[i] - 1
    lengths = torch.tensor([23, 9])
    pad = torch_fk.gaussian_filter1d_time(t64(x), lengths=lengths)
    assert rel_err(out[0], pad[0]) == 0.0
    alone = jax_fk.gaussian_filter1d_time(jnp.asarray(x[1:2, :9]))
    assert rel_err(alone[0], pad[1, :9]) < 1e-12


def test_fix_continuous_dof_flips():
    """Frames replaced by their other euler triple jump by >= 3 rad: the fix
    must flip them back (and does, on the JAX side as on the port's)."""
    rng = np.random.RandomState(5)
    Tn, J = LENGTHS[0], 4
    base = np.cumsum(rng.randn(Tn, J, 3) * 0.05, 0) + rng.uniform(-1, 1, (1, J, 3))
    alt = np.asarray(jax_fk.T.normalize_angle(jnp.stack(
        [np.pi + base[..., 0], np.pi - base[..., 1], np.pi + base[..., 2]], -1)))
    dof = base.copy()
    dof[[3, 4, 8]] = alt[[3, 4, 8]]
    out_j = jax_fk.fix_continuous_dof(jnp.asarray(dof))
    out_t = torch_fk.fix_continuous_dof(t64(dof))
    assert rel_err(out_j, out_t) < 1e-12
    fired = np.abs(out_t.numpy() - dof).max(-1) > 1.0
    assert fired[[3, 4, 8]].all() and fired.sum() == 3 * J
    # the batched form runs rows independently
    both = torch_fk.fix_continuous_dof(torch.stack([t64(dof), t64(base)]))
    assert rel_err(out_t, both[0]) == 0.0


def test_fk_batch_full_and_qpos_to_pose_aa(pair, clips):
    jm, tm, jf, tf = pair
    pose, trans = smooth_motion(np.random.RandomState(6), LENGTHS[1], 24, scale=2.5)
    out_j = jf.fk_batch(jnp.asarray(pose)[None], jnp.asarray(trans)[None], return_full=True)
    out_t = tf.fk_batch(t64(pose)[None], t64(trans)[None], return_full=True)
    assert set(out_j) == set(out_t)
    for k in out_j:
        if k == "fps":
            assert out_t[k] == out_j[k] == 30
        else:
            assert rel_err(out_j[k], out_t[k]) < 1e-9, k
    # the continuity fix fired on this clip
    raw = T.quat_to_euler_xyz(T.exp_map_to_quat(t64(pose))[:, list(tf.smpl_2_mujoco)][:, 1:])
    assert (out_t["dof_pos"][0] - raw).abs().amax() > 1.0
    rp_j, aa_j = jf.qpos_to_pose_aa(out_j["qpos"][0])
    rp_t, aa_t = tf.qpos_to_pose_aa(out_t["qpos"][0])
    assert rel_err(rp_j, rp_t) < 1e-9 and rel_err(aa_j, aa_t) < 1e-9


def test_fk_padded_batch_matches_each_clip(pair, clips):
    jm, tm, jf, tf = pair
    ents = list(clips.values())
    Tmax = max(LENGTHS)
    pose = np.zeros((3, Tmax, 24, 3))
    trans = np.zeros((3, Tmax, 3))
    for i, c in enumerate(ents):
        pose[i, :LENGTHS[i]] = c["pose_aa"].reshape(-1, 24, 3)
        trans[i, :LENGTHS[i]] = c["trans"]
    out = tf.fk_batch(t64(pose), t64(trans), return_full=True, lengths=torch.tensor(LENGTHS),
                      dt=t64([1.0 / f for f in FPS]))
    for i, c in enumerate(ents):
        n = LENGTHS[i]
        f = torch_fk.HumanoidBatchFK.from_robot_model(tm, dt=1.0 / FPS[i])
        one = f.fk_batch(t64(pose[i:i + 1, :n]), t64(trans[i:i + 1, :n]), return_full=True)
        for k in one:
            if k != "fps":
                assert rel_err(one[k], out[k][i:i + 1, :n]) < 1e-12, (i, k)


# ---------------------------------------------------------- motion_lib.py
def _jax_load_f64(jm, motions, ids, rng):
    """The JAX package's load_motions (motion_lib.py:111-180) in float64:
    the same heading draw and math, its fk_batch, concatenated."""
    out = {k: [] for k in ("gts", "grs", "gvs", "gavs", "dof_pos", "dvs", "qpos", "qvel",
                           "_motion_aa")}
    keys = list(motions)
    for mid in ids:
        e = motions[keys[mid]]
        pose = np.asarray(e["pose_aa"], np.float64).reshape(len(e["trans"]), -1, 3)[:, :24]
        trans = np.asarray(e["trans"], np.float64)
        ang = rng.uniform(-np.pi, np.pi)
        rq = np.array([np.cos(ang / 2), 0, 0, np.sin(ang / 2)])
        root_q = JT.quat_mul(jnp.asarray(rq)[None], JT.exp_map_to_quat(jnp.asarray(pose[:, 0])))
        pose = pose.copy()
        pose[:, 0] = np.asarray(JT.quat_to_exp_map(root_q))
        Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        trans = (trans - trans[0:1]) @ Rz.T + trans[0:1]
        f = jax_fk.HumanoidBatchFK.from_robot_model(jm, dt=1.0 / e["fps"])
        o = f.fk_batch(jnp.asarray(pose)[None], jnp.asarray(trans)[None], return_full=True)
        for k, src in (("gts", "global_translation"), ("grs", "global_rotation"),
                       ("gvs", "global_velocity"), ("gavs", "global_angular_velocity"),
                       ("dof_pos", "dof_pos"), ("dvs", "dof_vels"), ("qpos", "qpos"),
                       ("qvel", "qvel")):
            out[k].append(np.asarray(o[src][0]))
        out["_motion_aa"].append(pose.reshape(len(pose), -1))
    return {k: np.concatenate(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def libs(pair, clips):
    jm, tm, jf, tf = pair
    ids = np.array([0, 1, 2])
    cfg = jax_ml.MotionLibConfig(randomize_heading=True)
    jl = jax_ml.MotionLib(jf, cfg, motion_dict=clips).load_motions(
        ids, rng=np.random.default_rng(7))
    tl32 = MotionLib(tf, MotionLibConfig(), motion_dict=clips).load_motions(
        ids, rng=np.random.default_rng(7))
    tl64 = MotionLib(tf, MotionLibConfig(), motion_dict=clips, dtype=torch.float64)
    tl64.load_motions(ids, rng=np.random.default_rng(7))
    return jl, tl32, tl64


def test_library_tables_match_jax(pair, clips, libs):
    jm, tm, jf, tf = pair
    jl, tl32, tl64 = libs
    a = tables_to_numpy(tl32)
    for k in TABLES:
        ref = np.asarray(getattr(jl, k))
        assert a[k].dtype == ref.dtype, k
        assert rel_err(ref, a[k]) < 5e-5, k
    ref64 = _jax_load_f64(jm, clips, [0, 1, 2], np.random.default_rng(7))
    b = tables_to_numpy(tl64)
    for k, v in ref64.items():
        assert rel_err(v, b[k]) < 1e-9, k
    for k in ("length_starts", "_motion_num_frames", "_motion_fps"):
        assert (b[k] == a[k]).all()
    assert (tl32.curr_motion_keys == jl.curr_motion_keys).all()


def test_batched_load_matches_per_clip_load(pair, clips, libs, monkeypatch):
    jm, tm, jf, tf = pair
    _, tl32, tl64 = libs
    ids = np.array([2, 0, 1, 2])
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 5e-5)):
        all_ = MotionLib(tf, MotionLibConfig(), motion_dict=clips, dtype=dtype).load_motions(
            ids, rng=np.random.default_rng(9))
        with monkeypatch.context() as mp:
            mp.setattr(motion_lib, "_CHUNK", 1)
            one = MotionLib(tf, MotionLibConfig(), motion_dict=clips, dtype=dtype).load_motions(
                ids, rng=np.random.default_rng(9))
        a, b = tables_to_numpy(one), tables_to_numpy(all_)
        for k in TABLES:
            assert rel_err(a[k], b[k]) < tol, (dtype, k)


def _jax_lib_on(jl, tables):
    """The JAX library with the port's float64 tables swapped in."""
    for k, v in tables.items():
        setattr(jl, k, jnp.asarray(v))
    return jl


def test_motion_state_at_fed_times(pair, clips, libs):
    jm, tm, jf, tf = pair
    _, _, tl64 = libs
    jl = jax_ml.MotionLib(jf, jax_ml.MotionLibConfig(), motion_dict=clips)
    jl._num_motions = 3
    jl = _jax_lib_on(jl, tables_to_numpy(tl64))
    ids = np.array([0, 1, 2, 1, 0, 2, 2, 1])
    lens = tables_to_numpy(tl64)["_motion_lengths"][ids]
    times = lens * np.array([0.0, 0.37, 1.0, 1.2, -0.1, 0.5, 0.999, 0.08])
    times[5] = 1.5 / FPS[2]   # halfway between frames 1 and 2
    off = np.random.RandomState(8).randn(8, 3)
    for fn in ("get_motion_state", "get_motion_state_intervaled"):
        sj = getattr(jl, fn)(jnp.asarray(ids), jnp.asarray(times), jnp.asarray(off))
        st = getattr(tl64, fn)(torch.as_tensor(ids), t64(times), t64(off))
        assert set(sj) == set(st)
        for k in sj:
            assert rel_err(sj[k], st[k]) < 1e-9, (fn, k)
    # the sampler: uniform over each clip's length, on the library's device
    g = torch.Generator().manual_seed(0)
    ts = tl64.sample_time(g, torch.as_tensor(ids), truncate_time=0.05)
    assert ((ts >= 0) & (ts <= t64(lens) - 0.05 + 1e-12)).all()
    assert (tl64.get_motion_num_steps(ids).numpy() ==
            np.asarray(jl.get_motion_num_steps(jnp.asarray(ids)))).all()
    assert tl64.get_total_length() == pytest.approx(jl.get_total_length(), abs=1e-12)


def test_pmcp_weights_and_draws(pair, clips):
    jm, tm, jf, tf = pair
    jl = jax_ml.MotionLib(jf, jax_ml.MotionLibConfig(), motion_dict=clips)
    tl = MotionLib(tf, MotionLibConfig(), motion_dict=clips)
    for lib in (jl, tl):
        lib.update_hard_sampling_weight(["m1"])
    assert (jl._sampling_prob == tl._sampling_prob).all() and tl._sampling_prob[1] == 1.0
    for lib in (jl, tl):
        lib.update_hard_sampling_weight([])
        lib.update_soft_sampling_weight(["m0", "m2"])
        lib.update_soft_sampling_weight(["m2"])
    assert np.allclose(jl._sampling_prob, tl._sampling_prob, rtol=0, atol=1e-15)
    assert np.allclose(tl._sampling_prob, [1 / 3, 0, 2 / 3])
    h = {k: np.copy(v) if isinstance(v, np.ndarray) else v
         for k, v in tl.get_termination_history().items()}
    tl.update_soft_sampling_weight(["m1"])
    tl.set_termination_history(h)
    assert np.allclose(tl._sampling_prob, [1 / 3, 0, 2 / 3])
    assert (jl.sample_motion_ids(np.random.default_rng(3), 50)
            == tl.sample_motion_ids(np.random.default_rng(3), 50)).all()


def test_smplh_pose_layout_and_pkl_directory(pair, clips, tmp_path):
    """A 156-wide SMPLH pose loads as its 72-wide SMPL cut; a directory of
    pkls (one of them nested under a key) loads as the dict it came from."""
    jm, tm, jf, tf = pair
    rng = np.random.RandomState(10)
    wide = {}
    for k, c in clips.items():
        p = np.zeros((len(c["trans"]), 156))
        p[:, :66], p[:, 75:78], p[:, 120:123] = (c["pose_aa"][:, :66], c["pose_aa"][:, 66:69],
                                                 c["pose_aa"][:, 69:72])
        p[:, 66:75] = rng.randn(len(p), 9)
        p[:, 78:120] = rng.randn(len(p), 42)
        p[:, 123:] = rng.randn(len(p), 33)
        wide[k] = dict(c, pose_aa=p)
    load = lambda d, path=None: tables_to_numpy(MotionLib(
        tf, MotionLibConfig(motion_file=path), motion_dict=d, dtype=torch.float64).load_motions(
        np.arange(3), rng=np.random.default_rng(1)))
    ref = load(clips)
    for k, v in load(wide).items():
        assert rel_err(ref[k], v) == 0.0, k
    jl = jax_ml.MotionLib(jf, jax_ml.MotionLibConfig(), motion_dict=wide).load_motions(
        np.arange(3), rng=np.random.default_rng(1))
    assert rel_err(np.asarray(jl.gts), ref["gts"]) < 5e-5
    for i, (k, c) in enumerate(clips.items()):
        with open(tmp_path / f"{k}.pkl", "wb") as f:
            pickle.dump({"wrapped": c} if i == 1 else c, f)
    (tmp_path / "notes.txt").write_text("not a clip")
    lib = MotionLib(tf, MotionLibConfig(motion_file=str(tmp_path)), dtype=torch.float64)
    assert list(lib._motion_data_keys) == list(clips)
    assert list(jax_ml.MotionLib._load_data(str(tmp_path))) == list(clips)
    for k, v in load(None, str(tmp_path)).items():
        assert rel_err(ref[k], v) == 0.0, k


# -------------------------------------------------------------- the pin
def _matmul_precision():
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.mkldnn.matmul.fp32_precision)


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_physics_and_motion_math_pin_full_float32(pair, clips, libs, monkeypatch, api):
    jm, tm, jf, tf = pair
    _, tl32, _ = libs
    seen = []

    def spy(fn):
        def wrapped(*a, **k):
            seen.append(_matmul_precision())
            return fn(*a, **k)
        return wrapped

    prev_legacy, prev = torch.get_float32_matmul_precision(), _matmul_precision()
    if api == "legacy":
        torch.set_float32_matmul_precision("high")
    else:
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        torch.backends.mkldnn.matmul.fp32_precision = "tf32"
    caller = _matmul_precision()
    assert caller == ("tf32", "tf32")
    try:
        monkeypatch.setattr(kinematics, "fk", spy(kinematics.fk))
        monkeypatch.setattr(T, "quat_slerp", spy(T.quat_slerp))
        m32 = models(jnp.float32)[1]
        env = HumanoidSpeed(m32, SpeedConfig(control_frequency_inv=1))
        st = env.reset(2, torch.Generator().manual_seed(0))
        seen.clear()
        env.step(st, torch.zeros(2, m32.nu))
        n_env = len(seen)
        engine.control_step(m32, st.phys, torch.zeros(2, m32.nu), control_freq_inv=1)
        n_ctrl = len(seen) - n_env
        tl32.get_motion_state(torch.tensor([0, 2]), torch.tensor([0.1, 0.2]))
        assert n_env > 0 and n_ctrl > 0 and len(seen) > n_env + n_ctrl
        assert set(seen) == {("ieee", "ieee")}
        assert _matmul_precision() == caller
        with pytest.raises(RuntimeError):
            with ieee_fp32():
                assert _matmul_precision() == ("ieee", "ieee")
                raise RuntimeError("inside the pin")
        assert _matmul_precision() == caller
        if api == "legacy":
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev_legacy)
        torch.backends.cuda.matmul.fp32_precision = prev[0]
        torch.backends.mkldnn.matmul.fp32_precision = prev[1]
