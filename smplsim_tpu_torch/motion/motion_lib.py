"""Mocap motion library: AMASS-style pkl dicts -> state tables on the device
(port of smplsim_tpu/motion/motion_lib.py).

    fk = HumanoidBatchFK.from_robot_model(model)
    lib = MotionLib(fk, MotionLibConfig(), motion_dict=motions).load_motions()
    ids = torch.as_tensor(lib.sample_motion_ids(np.random.default_rng(0), B))
    st = lib.get_motion_state(ids, lib.sample_time(generator, ids))

The state tables (gts/grs/gvs/gavs/dof_pos/dvs/qpos/qvel and the clips'
pose) are flat over all loaded frames, with `length_starts` offsets, and
live on the FK's device. `get_motion_state` blends the two frames around
each time (slerp on rotations), `get_motion_state_intervaled` takes the
nearest frame; both are batched gathers that read nothing back to the host.

`load_motions` runs the FK of the whole batch at once: clips in chunks of
`_CHUNK`, sorted by length and padded to the longest of their chunk, each
with its own frame rate and last frame (motion/fk.py), where the JAX package
runs its FK once per clip. The chunk bounds the padded FK's memory; every
chunk size gives the same tables (a chunk of 1 is the per-clip load). The
heading randomization is batched too.

The draws: `sample_motion_ids` and the heading angles come from a
`numpy.random.Generator`, as in the JAX package, so one seed gives both
packages the same draws; `sample_time` takes a torch.Generator where the
JAX package takes a key. PMCP adaptive sampling (hard/soft) and the
termination history are the JAX package's, in numpy.

The tables are float32 by default, as the JAX package's are (it casts the
clips to float32); `dtype=torch.float64` keeps the clips in float64.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import pickle
from typing import Any

import numpy as np
import torch

from smplsim_tpu_torch import transforms as T
from smplsim_tpu_torch.motion.fk import HumanoidBatchFK
from smplsim_tpu_torch.physics.precision import ieee_fp32

# the flat tables of a loaded library, in tables_to_numpy's order
TABLES = ("gts", "grs", "gvs", "gavs", "dof_pos", "dvs", "qpos", "qvel", "_motion_aa",
          "length_starts", "_motion_lengths", "_motion_fps", "_motion_dt",
          "_motion_num_frames")
# clips whose FK runs in one padded batch
_CHUNK = 1024


class FixHeightMode(enum.Enum):
    no_fix = 0
    full_fix = 1
    ankle_fix = 2


@dataclasses.dataclass(frozen=True)
class MotionLibConfig:
    motion_file: str | None = None
    fix_height: FixHeightMode = FixHeightMode.no_fix
    randomize_heading: bool = True
    min_length: int = -1
    max_length: int = -1
    im_eval: bool = False  # sample by length (eval mode)


def _load_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _as_index(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device).long()


class MotionLib:
    """Host-side loader, device-side sampler."""

    def __init__(self, fk: HumanoidBatchFK, config: MotionLibConfig | None = None,
                 motion_dict: dict[str, Any] | None = None, dtype: torch.dtype = torch.float32):
        self.fk = fk
        self.cfg = config or MotionLibConfig()
        self.dtype = dtype
        self.device = fk.device
        if motion_dict is None:
            motion_dict = self._load_data(self.cfg.motion_file)
        self._motion_data = motion_dict
        self._motion_data_keys = np.array(list(motion_dict.keys()))
        self._num_unique_motions = len(self._motion_data_keys)
        self._sampling_prob = np.ones(self._num_unique_motions) / self._num_unique_motions
        self._termination_history = np.zeros(self._num_unique_motions)
        self.curr_failed_keys = []
        self._loaded = False

    # ------------------------------------------------------------------
    @staticmethod
    def _load_data(path):
        """A pkl file of clips, or a directory of one-clip pkls (keyed by
        file stem)."""
        if path is None:
            raise ValueError("motion_file or motion_dict required")
        if os.path.isdir(path):
            out = {}
            for f in sorted(os.listdir(path)):
                if f.endswith(".pkl"):
                    d = _load_pkl(os.path.join(path, f))
                    out[os.path.splitext(f)[0]] = d if "pose_aa" in d else d[next(iter(d))]
            return out
        return _load_pkl(path)

    # ------------------------------------------------------------------
    def sample_motion_ids(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.choice(self._num_unique_motions, size=n, p=self._sampling_prob, replace=True)

    def _clip(self, mid: int, np_dtype):
        """(pose_aa (T,J,3), trans (T,3), fps) of clip `mid` as the JAX
        package reads it: the SMPLH 156-wide pose cut to SMPL's 72."""
        entry = self._motion_data[self._motion_data_keys[mid]]
        pose_aa = np.asarray(entry["pose_aa"], dtype=np_dtype)
        trans = np.asarray(entry.get("trans", entry.get("trans_orig")), dtype=np_dtype)
        J = self.fk.num_joints
        if pose_aa.ndim == 2:
            if pose_aa.shape[1] == 156 and J == 24:
                pose_aa = np.concatenate(
                    [pose_aa[:, :66], pose_aa[:, 75:78], pose_aa[:, 120:123]], axis=1)
            pose_aa = pose_aa.reshape(pose_aa.shape[0], -1, 3)[:, :J]
        return pose_aa, trans, float(entry.get("fps", 30.0))

    @ieee_fp32()
    def load_motions(self, motion_ids: np.ndarray | None = None, num: int | None = None,
                     rng: np.random.Generator | None = None):
        """FK all selected clips and build the flat device tables."""
        rng = rng or np.random.default_rng(0)
        if motion_ids is None:
            motion_ids = self.sample_motion_ids(rng, num or self._num_unique_motions)
        self._curr_motion_ids = np.asarray(motion_ids)
        self.curr_motion_keys = self._motion_data_keys[self._curr_motion_ids]
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        clips = [self._clip(int(mid), np_dtype) for mid in self._curr_motion_ids]
        n = len(clips)
        num_frames = np.array([c[0].shape[0] for c in clips], np.int64)
        fpses = np.array([c[2] for c in clips], np.float64)
        # one heading draw per clip, in clip order, as the JAX package's loop
        angles = (rng.uniform(-np.pi, np.pi, size=n) if self.cfg.randomize_heading else None)
        starts = np.concatenate([[0], np.cumsum(num_frames)[:-1]]).astype(np.int64)

        dev, dt = self.device, self.dtype
        F, J = int(num_frames.sum()), self.fk.num_joints
        nq, nv = 7 + 3 * (J - 1), 6 + 3 * (J - 1)
        empty = lambda *s: torch.empty((F,) + s, dtype=dt, device=dev)
        tables = dict(gts=empty(J, 3), grs=empty(J, 4), gvs=empty(J, 3), gavs=empty(J, 3),
                      dof_pos=empty(J - 1, 3), dvs=empty(J - 1, 3), qpos=empty(nq),
                      qvel=empty(nv), _motion_aa=empty(J * 3))
        keys = dict(gts="global_translation", grs="global_rotation", gvs="global_velocity",
                    gavs="global_angular_velocity", dof_pos="dof_pos", dvs="dof_vels",
                    qpos="qpos", qvel="qvel")
        order = np.argsort(num_frames, kind="stable")
        for c0 in range(0, n, _CHUNK):
            sel = order[c0:c0 + _CHUNK]
            Tmax = int(num_frames[sel].max())
            pose = np.zeros((len(sel), Tmax, J, 3), np_dtype)
            trans = np.zeros((len(sel), Tmax, 3), np_dtype)
            for r, i in enumerate(sel):
                pose[r, :num_frames[i]] = clips[i][0]
                trans[r, :num_frames[i]] = clips[i][1]
            pose_t = torch.as_tensor(pose, device=dev)
            trans_t = torch.as_tensor(trans, device=dev)
            if angles is not None:
                pose_t, trans_t = _randomize_heading(pose_t, trans_t, angles[sel], np_dtype)
            lens = torch.as_tensor(num_frames[sel], device=dev)
            out = self.fk.fk_batch(pose_t, trans_t, return_full=True, lengths=lens,
                                   dt=torch.as_tensor(1.0 / fpses[sel], dtype=dt, device=dev))
            t = torch.arange(Tmax, device=dev)
            valid = t[None] < lens[:, None]
            dest = (torch.as_tensor(starts[sel], device=dev)[:, None] + t[None])[valid]
            for name, key in keys.items():
                tables[name][dest] = out[key][valid]
            tables["_motion_aa"][dest] = pose_t.reshape(len(sel), Tmax, J * 3)[valid]
        for name, tab in tables.items():
            setattr(self, name, tab)

        self._motion_lengths = torch.as_tensor((num_frames - 1) / fpses, dtype=dt, device=dev)
        self._motion_fps = torch.as_tensor(fpses, dtype=dt, device=dev)
        self._motion_dt = torch.as_tensor(1.0 / fpses, dtype=dt, device=dev)
        self._motion_num_frames = torch.as_tensor(num_frames, dtype=torch.int32, device=dev)
        self.length_starts = torch.as_tensor(starts, dtype=torch.int32, device=dev)
        self._num_motions = n
        self._loaded = True
        return self

    # ------------------------------------------------------------------
    def num_current_motions(self) -> int:
        return self._num_motions

    def num_all_motions(self) -> int:
        return self._num_unique_motions

    def get_total_length(self) -> float:
        return float(self._motion_lengths.sum())

    def get_motion_length(self, motion_ids=None):
        if motion_ids is None:
            return self._motion_lengths
        return self._motion_lengths[_as_index(motion_ids, self.device)]

    def get_motion_num_steps(self, motion_ids=None):
        nf, fps = self._motion_num_frames, self._motion_fps
        if motion_ids is not None:
            i = _as_index(motion_ids, self.device)
            nf, fps = nf[i], fps[i]
        return (nf * 30 / fps).to(torch.int32)

    def sample_time(self, generator: torch.Generator, motion_ids, truncate_time=None):
        """Uniform times over each clip's length (less truncate_time)."""
        ids = _as_index(motion_ids, self.device)
        phase = torch.rand(ids.shape, generator=generator, dtype=self.dtype, device=self.device)
        lens = self._motion_lengths[ids]
        if truncate_time is not None:
            lens = (lens - truncate_time).clamp_min(0.0)
        return phase * lens

    # ------------------------------------------------------------------
    def _frame_blend(self, time, length, num_frames, dt):
        phase = (time / length.clamp_min(1e-9)).clamp(0.0, 1.0)
        time = time.clamp_min(0.0)
        idx0 = torch.floor(phase * (num_frames - 1)).to(torch.int32)
        idx1 = torch.minimum(idx0 + 1, num_frames - 1)
        blend = ((time - idx0 * dt) / dt).clamp(0.0, 1.0)
        return idx0, idx1, blend

    def _lookup(self, motion_ids, motion_times):
        ids = _as_index(motion_ids, self.device)
        times = torch.as_tensor(motion_times, dtype=self.dtype, device=self.device)
        idx0, idx1, blend = self._frame_blend(times, self._motion_lengths[ids],
                                              self._motion_num_frames[ids], self._motion_dt[ids])
        start = self.length_starts[ids]
        return ids, idx0, idx1, blend, start

    @ieee_fp32()
    def get_motion_state(self, motion_ids, motion_times, offset=None) -> dict[str, torch.Tensor]:
        """The state at each (clip, time): the two frames around the time
        blended linearly, rotations by slerp."""
        ids, idx0, idx1, blend, start = self._lookup(motion_ids, motion_times)
        f0, f1 = (idx0 + start).long(), (idx1 + start).long()
        b = blend[..., None]
        be = blend[..., None, None]
        rg_pos = (1 - be) * self.gts[f0] + be * self.gts[f1]
        if offset is not None:
            rg_pos = rg_pos + offset[..., None, :]
        body_vel = (1 - be) * self.gvs[f0] + be * self.gvs[f1]
        body_ang_vel = (1 - be) * self.gavs[f0] + be * self.gavs[f1]
        dof_pos = (1 - b[..., None]) * self.dof_pos[f0] + b[..., None] * self.dof_pos[f1]
        dof_vel = (1 - b[..., None]) * self.dvs[f0] + b[..., None] * self.dvs[f1]
        rb_rot = T.quat_slerp(self.grs[f0], self.grs[f1], be)
        N = ids.shape[0]
        return {
            "root_pos": rg_pos[..., 0, :],
            "root_rot": rb_rot[..., 0, :],
            "dof_pos": dof_pos.reshape(N, -1),
            "root_vel": body_vel[..., 0, :],
            "root_ang_vel": body_ang_vel[..., 0, :],
            "dof_vel": dof_vel.reshape(N, -1),
            "motion_aa": self._motion_aa[f0],
            "rg_pos": rg_pos,
            "rb_rot": rb_rot,
            "body_vel": body_vel,
            "body_ang_vel": body_ang_vel,
        }

    @ieee_fp32()
    def get_motion_state_intervaled(self, motion_ids, motion_times, offset=None):
        """The state of the nearest frame (no blend), with qpos and qvel."""
        ids, idx0, idx1, blend, start = self._lookup(motion_ids, motion_times)
        idx = ((1.0 - blend) * idx0 + blend * idx1).to(torch.int32)
        fl = (idx + start).long()
        xpos = self.gts[fl]
        if offset is not None:
            xpos = xpos + offset[..., None, :]
        N = ids.shape[0]
        return {
            "root_pos": xpos[..., 0, :],
            "root_rot": self.grs[fl][..., 0, :],
            "dof_pos": self.dof_pos[fl].reshape(N, -1),
            "root_vel": self.gvs[fl][..., 0, :],
            "root_ang_vel": self.gavs[fl][..., 0, :],
            "dof_vel": self.dvs[fl].reshape(N, -1),
            "motion_aa": self._motion_aa[fl],
            "xpos": xpos,
            "xquat": self.grs[fl],
            "body_vel": self.gvs[fl],
            "body_ang_vel": self.gavs[fl],
            "qpos": self.qpos[fl],
            "qvel": self.qvel[fl],
        }

    # ---------------- PMCP adaptive sampling ----------------
    def update_hard_sampling_weight(self, failed_keys):
        """Train on the failed clips only."""
        if len(failed_keys):
            all_keys = self._motion_data_keys.tolist()
            idx = [all_keys.index(k) for k in failed_keys]
            self._sampling_prob[:] = 0
            self._sampling_prob[idx] = 1.0 / len(idx)
        else:
            self._sampling_prob = np.ones(self._num_unique_motions) / self._num_unique_motions

    def update_soft_sampling_weight(self, failed_keys):
        """Weight the clips by their accumulated failures."""
        if len(failed_keys):
            self.curr_failed_keys = failed_keys
            all_keys = self._motion_data_keys.tolist()
            idx = [all_keys.index(k) for k in failed_keys]
            self._termination_history[idx] += 1
            self.update_sampling_prob(self._termination_history)
        else:
            self._sampling_prob = np.ones(self._num_unique_motions) / self._num_unique_motions

    def update_sampling_prob(self, termination_history) -> bool:
        if len(self._sampling_prob) == len(termination_history):
            self._sampling_prob[:] = termination_history / termination_history.sum()
            self._termination_history = termination_history
            return True
        return False

    def get_termination_history(self):
        return {"termination_history": self._termination_history,
                "failed_keys": self.curr_failed_keys}

    def set_termination_history(self, h):
        self._termination_history = h["termination_history"]
        self.curr_failed_keys = h["failed_keys"]
        self.update_sampling_prob(self._termination_history)


def _randomize_heading(pose: torch.Tensor, trans: torch.Tensor, angles: np.ndarray, np_dtype):
    """Turn each clip (B,T,...) about z by its angle: the root rotation
    premultiplied, the trajectory rotated about its first frame. The
    quaternion and matrix are built in numpy in the tables' precision, as
    the JAX package builds them."""
    c, s = np.cos(angles), np.sin(angles)
    z = np.zeros_like(angles)
    rq = np.stack([np.cos(angles / 2), z, z, np.sin(angles / 2)], -1).astype(np_dtype)
    Rz = np.stack([np.stack([c, -s, z], -1), np.stack([s, c, z], -1),
                   np.stack([z, z, z + 1], -1)], -2).astype(np_dtype)          # (B,3,3)
    rq = torch.as_tensor(rq, device=pose.device)
    Rz = torch.as_tensor(Rz, device=pose.device)
    root_q = T.quat_mul(rq[:, None], T.exp_map_to_quat(pose[:, :, 0]))
    pose = torch.cat([T.quat_to_exp_map(root_q)[:, :, None], pose[:, :, 1:]], dim=2)
    d = trans - trans[:, 0:1]
    trans = torch.stack([d[..., 0] * Rz[:, None, j, 0] + d[..., 1] * Rz[:, None, j, 1]
                         + d[..., 2] * Rz[:, None, j, 2] for j in range(3)], -1) + trans[:, 0:1]
    return pose, trans


def tables_to_numpy(lib: MotionLib) -> dict[str, np.ndarray]:
    """Every flat table and index array of a loaded library as numpy arrays,
    under the JAX package's attribute names."""
    return {k: getattr(lib, k).detach().cpu().numpy() for k in TABLES}
