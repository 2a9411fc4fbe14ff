"""Skeleton tree / state / motion with retargeting: the poselib layer (port
of smplsim_tpu/poselib/skeleton.py).

SkeletonTree (names, parents, local translations; MJCF import; node
dropping with translation re-accumulation), SkeletonState (local/global
rotation conversion, FK, t-pose retargeting), SkeletonMotion (a state
sequence with fps and finite-difference velocities). The math is torch
(wxyz quaternions, smplsim_tpu_torch.transforms) on the device of the
caller's tensors; the tree structure is host-side python and numpy.
Constructors that make tensors of their own (`zero_pose`, `from_npz`) take
a device, "cuda" unless the caller asks for the CPU.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np
import torch

from smplsim_tpu_torch import transforms as T


class SkeletonTree:
    def __init__(self, node_names, parent_indices, local_translation):
        self.node_names = list(node_names)
        self.parent_indices = np.asarray(parent_indices, dtype=np.int64)
        self.local_translation = np.asarray(local_translation, dtype=np.float64)

    # ---------------- constructors ----------------
    @classmethod
    def from_mjcf(cls, path_or_xml: str) -> "SkeletonTree":
        """Parse <body> nesting into a tree (skeleton3d.py:149-193)."""
        if path_or_xml.lstrip().startswith("<"):
            root = ET.fromstring(path_or_xml)
        else:
            root = ET.parse(path_or_xml).getroot()
        worldbody = root.find("worldbody")
        names, parents, trans = [], [], []

        def walk(el, parent_idx):
            idx = len(names)
            names.append(el.attrib["name"])
            parents.append(parent_idx)
            pos = el.attrib.get("pos", "0 0 0")
            trans.append([float(x) for x in pos.split()])
            for child in el.findall("body"):
                walk(child, idx)

        body = worldbody.find("body")
        walk(body, -1)
        return cls(names, parents, trans)

    @classmethod
    def from_robot_model(cls, model) -> "SkeletonTree":
        return cls(model.body_names, model.parents, model.body_pos.detach().cpu().numpy())

    # ---------------- protocol ----------------
    def __len__(self):
        return len(self.node_names)

    def __iter__(self):
        return iter(self.node_names)

    def __contains__(self, name):
        return name in self.node_names

    def index(self, name) -> int:
        return self.node_names.index(name)

    def parent_of(self, name) -> str:
        return self.node_names[self.parent_indices[self.index(name)]]

    def __eq__(self, other):
        return (
            isinstance(other, SkeletonTree)
            and self.node_names == other.node_names
            and np.array_equal(self.parent_indices, other.parent_indices)
            and np.allclose(self.local_translation, other.local_translation)
        )

    # ---------------- editing ----------------
    def keep_nodes_by_names(
        self, names, pairwise_translation: Optional[np.ndarray] = None
    ) -> "SkeletonTree":
        """Subset tree; removed intermediate joints fold their offsets into
        the surviving child (skeleton3d.py:213-250). pairwise_translation
        (J,J,3) optionally supplies averaged offsets between any two nodes
        (used by retargeting on motion data)."""
        keep = [n for n in self.node_names if n in names]
        new_parents, new_trans = [], []
        for n in keep:
            i = self.index(n)
            # walk up to the nearest kept ancestor, accumulating offsets
            j = self.parent_indices[i]
            offset = self.local_translation[i].copy()
            while j >= 0 and self.node_names[j] not in keep:
                offset = offset + self.local_translation[j]
                j = self.parent_indices[j]
            if j < 0:
                new_parents.append(-1)
                new_trans.append(self.local_translation[i] if i == 0 else offset)
            else:
                anc = self.node_names[j]
                new_parents.append(keep.index(anc))
                if pairwise_translation is not None:
                    new_trans.append(pairwise_translation[self.index(anc), i])
                else:
                    new_trans.append(offset)
        return SkeletonTree(keep, new_parents, new_trans)


class SkeletonState:
    """Batched pose: local_rotation (..., J, 4) wxyz + root_translation (..., 3)."""

    def __init__(self, skeleton_tree: SkeletonTree, local_rotation, root_translation):
        self.skeleton_tree = skeleton_tree
        self.local_rotation = torch.as_tensor(local_rotation)
        self.root_translation = torch.as_tensor(root_translation,
                                                device=self.local_rotation.device)

    @property
    def shape(self):
        return self.local_rotation.shape[:-2]

    # ---------------- constructors ----------------
    @classmethod
    def from_rotation_and_root_translation(cls, skeleton_tree, r, t, is_local=True):
        if is_local:
            return cls(skeleton_tree, r, t)
        # global -> local: l_i = g_parent^-1 * g_i
        r = torch.as_tensor(r)
        parents = skeleton_tree.parent_indices
        locals_ = [r[..., 0, :]]
        for i in range(1, len(skeleton_tree)):
            p = parents[i]
            locals_.append(
                T.quat_mul(T.quat_conjugate(r[..., p, :]), r[..., i, :])
            )
        return cls(skeleton_tree, torch.stack(locals_, dim=-2), t)

    @classmethod
    def zero_pose(cls, skeleton_tree, device: str | torch.device = "cuda"):
        J = len(skeleton_tree)
        return cls(
            skeleton_tree,
            T.quat_identity((J,), torch.float64, device),
            torch.as_tensor(skeleton_tree.local_translation[0], device=device),
        )

    # ---------------- FK ----------------
    @property
    def global_rotation(self):
        parents = self.skeleton_tree.parent_indices
        out = [self.local_rotation[..., 0, :]]
        for i in range(1, len(self.skeleton_tree)):
            out.append(T.quat_mul(out[parents[i]], self.local_rotation[..., i, :]))
        return torch.stack(out, dim=-2)

    @property
    def global_translation(self):
        parents = self.skeleton_tree.parent_indices
        g = self.global_rotation
        lt = torch.as_tensor(self.skeleton_tree.local_translation, dtype=g.dtype, device=g.device)
        out = [self.root_translation.to(g.dtype).expand(g.shape[:-2] + (3,))]
        for i in range(1, len(self.skeleton_tree)):
            p = parents[i]
            out.append(out[p] + T.quat_rotate(g[..., p, :], lt[i]))
        return torch.stack(out, dim=-2)

    @property
    def local_transformation(self):
        return self.local_rotation, self.root_translation

    def local_repr(self):
        return self

    # ---------------- retarget ----------------
    def _transfer_to(self, new_tree: SkeletonTree) -> "SkeletonState":
        """Project onto a subset tree: new locals from kept-node globals."""
        g = self.global_rotation
        idx = [self.skeleton_tree.index(n) for n in new_tree.node_names]
        g_sub = g[..., idx, :]
        return SkeletonState.from_rotation_and_root_translation(
            new_tree, g_sub, self.root_translation, is_local=False
        )

    def _remapped_to(self, joint_mapping: Dict[str, str], target_tree: SkeletonTree):
        renamed = SkeletonTree(
            [joint_mapping[n] for n in self.skeleton_tree.node_names],
            self.skeleton_tree.parent_indices,
            self.skeleton_tree.local_translation,
        )
        return SkeletonState(renamed, self.local_rotation, self.root_translation)

    def _get_pairwise_average_translation(self):
        """(J,J,3) average offset between each pair over the batch."""
        gt = self.global_translation
        gr = self.global_rotation
        diff = gt[..., None, :, :] - gt[..., :, None, :]  # (..., J, J, 3)
        # express in the row joint's frame
        inv = T.quat_conjugate(gr)
        local = T.quat_rotate(inv[..., :, None, :], diff)
        if local.ndim > 3:
            local = local.reshape((-1,) + local.shape[-3:]).mean(0)
        return local.detach().cpu().numpy()

    def retarget_to_by_tpose(
        self,
        joint_mapping: Dict[str, str],
        source_tpose: "SkeletonState",
        target_tpose: "SkeletonState",
        rotation_to_target_skeleton,
        scale_to_target_skeleton: float,
    ) -> "SkeletonState":
        """Naive t-pose retarget (skeleton3d.py:717-909)."""
        target_tree = target_tpose.skeleton_tree
        rot = torch.as_tensor(rotation_to_target_skeleton,
                              dtype=self.local_rotation.dtype, device=self.local_rotation.device)

        # STEP 1: keep only mapped joints
        pairwise = self._get_pairwise_average_translation()
        node_names = list(joint_mapping)
        new_tree = self.skeleton_tree.keep_nodes_by_names(node_names, pairwise)
        src_tpose = source_tpose._transfer_to(
            source_tpose.skeleton_tree.keep_nodes_by_names(node_names)
        )
        src_state = self._transfer_to(new_tree)
        src_tpose = src_tpose._remapped_to(joint_mapping, target_tree)
        src_state = src_state._remapped_to(joint_mapping, target_tree)

        # STEP 2: rotate into the target frame
        def rotate(st):
            lr = torch.cat([T.quat_unit(T.quat_mul(rot, st.local_rotation[..., 0, :]))[..., None, :],
                            st.local_rotation[..., 1:, :]], dim=-2)
            return SkeletonState(
                st.skeleton_tree, lr, T.quat_rotate(rot, st.root_translation)
            )

        src_tpose = rotate(src_tpose)
        src_state = rotate(src_state)

        # STEP 3: scale root translation
        root_diff = (
            src_state.root_translation - src_tpose.root_translation
        ) * scale_to_target_skeleton

        # STEP 4: relative global rotation re-applied to the target tpose
        cur_tree = src_state.skeleton_tree
        tgt_g = target_tpose.global_rotation
        base = []
        for name in cur_tree.node_names:
            base.append(
                tgt_g[..., target_tree.index(name), :]
                if name in target_tree else src_state.global_rotation[..., 0, :]
            )
        base = torch.stack(torch.broadcast_tensors(*base), dim=-2)
        diff = T.quat_unit(
            T.quat_mul(
                src_state.global_rotation,
                T.quat_conjugate(src_tpose.global_rotation),
            )
        )
        new_g = T.quat_unit(T.quat_mul(diff, base))

        # STEP 5: expand to the full target tree (missing joints inherit the
        # nearest mapped ancestor's global rotation)
        cols = []
        for name in target_tree.node_names:
            n = name
            while n not in cur_tree.node_names:
                n = target_tree.parent_of(n)
            cols.append(new_g[..., cur_tree.index(n), :])
        full_g = torch.stack(cols, dim=-2)

        return SkeletonState.from_rotation_and_root_translation(
            target_tree,
            full_g,
            target_tpose.root_translation + root_diff,
            is_local=False,
        )


class SkeletonMotion(SkeletonState):
    """A time-batched SkeletonState with fps and derived velocities."""

    def __init__(self, skeleton_tree, local_rotation, root_translation, fps=30):
        super().__init__(skeleton_tree, local_rotation, root_translation)
        self.fps = fps

    @classmethod
    def from_npz(cls, path, device: str | torch.device = "cuda") -> "SkeletonMotion":
        """Load a motion from the npz layout tools/fbx2npz.py writes:
        node_names (J,), parent_indices (J,), local_translation (J,3),
        local_rotation (T,J,4) wxyz, root_translation (T,3), fps ()."""
        data = np.load(path, allow_pickle=False)
        tree = SkeletonTree(
            [str(n) for n in data["node_names"]],
            np.asarray(data["parent_indices"], np.int64),
            np.asarray(data["local_translation"]),
        )
        return cls(
            tree,
            torch.as_tensor(data["local_rotation"], device=device),
            torch.as_tensor(data["root_translation"], device=device),
            fps=float(data["fps"]),
        )

    @classmethod
    def from_fbx(cls, fbx_file_path, root_joint=None, fps=None, **kwargs):
        """FBX needs the proprietary Autodesk FBX SDK. If its `fbx` python
        bindings are importable, convert in-process via tools/fbx2npz.convert
        and load the result (kwargs go to from_npz); otherwise raise with
        the converter instructions (run tools/fbx2npz.py where the SDK is
        installed, then SkeletonMotion.from_npz the output)."""
        import importlib.util
        import os
        import sys
        import tempfile

        if importlib.util.find_spec("fbx") is None:
            raise NotImplementedError(
                "FBX import requires the external Autodesk FBX SDK python "
                "bindings. On a machine with the SDK: `python tools/"
                "fbx2npz.py clip.fbx clip.npz` then "
                "SkeletonMotion.from_npz('clip.npz')."
            )
        tools = os.path.join(os.path.dirname(__file__), "..", "..", "tools")
        sys.path.insert(0, os.path.abspath(tools))
        try:
            import fbx2npz
        finally:
            sys.path.pop(0)
        with tempfile.NamedTemporaryFile(suffix=".npz") as tmp:
            fbx2npz.convert(fbx_file_path, tmp.name, root_joint, fps)
            return cls.from_npz(tmp.name, **kwargs)

    @classmethod
    def from_skeleton_state(cls, state: SkeletonState, fps=30):
        return cls(state.skeleton_tree, state.local_rotation,
                   state.root_translation, fps)

    @property
    def global_velocity(self):
        p = self.global_translation
        v = (p[1:] - p[:-1]) * self.fps
        return torch.cat([v, v[-1:]], dim=0)

    @property
    def global_angular_velocity(self):
        q = self.global_rotation
        dq = T.quat_unit(T.quat_mul(q[1:], T.quat_conjugate(q[:-1])))
        angle, axis = T.quat_to_angle_axis(dq)
        w = axis * angle[..., None] * self.fps
        return torch.cat([w, torch.zeros_like(w[-1:])], dim=0)

    def crop(self, start: int, end: int, fps=None):
        return SkeletonMotion(
            self.skeleton_tree,
            self.local_rotation[start:end],
            self.root_translation[start:end],
            fps or self.fps,
        )
