"""The validation datasets (port of the validation side of
``raft_ncup_tpu/data/datasets.py``).

Index construction mirrors the reference's globs for MpiSintel,
FlyingChairs (with the packaged train/validation split file) and KITTI.
A sample is a dict of numpy arrays, channel-last: ``image1``/``image2``
(H, W, 3) uint8, ``flow`` (H, W, 2) float32, ``valid`` (H, W) float32;
a test-split sample carries ``extra_info`` instead of flow and validity,
and a Sintel training sample carries it too.
Samples are read as they are, with no augmentation: the training readers
(FlyingThings3D, HD1K, the mixtures and the augmentors) are not ported.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob

import numpy as np

from raft_ncup_tpu_torch.io import read_flow_kitti, read_gen

PACKAGED_CHAIRS_SPLIT = osp.join(osp.dirname(osp.abspath(__file__)), "chairs_split.txt")


class FlowDataset:
    """A list of (image1, image2) paths with their flow paths."""

    def __init__(self, sparse: bool = False):
        self.sparse = sparse
        self.is_test = False
        self.flow_list: list[str] = []
        self.image_list: list[list[str]] = []
        self.extra_info: list = []

    def __len__(self) -> int:
        return len(self.image_list)

    def sample(self, index: int) -> dict:
        """Load one pair as it is on disk."""
        img1 = read_gen(self.image_list[index][0])
        img2 = read_gen(self.image_list[index][1])
        if self.is_test:
            return {"image1": img1, "image2": img2, "extra_info": self.extra_info[index]}
        if self.sparse:
            flow, valid = read_flow_kitti(self.flow_list[index])
        else:
            flow = np.asarray(read_gen(self.flow_list[index]), np.float32)
            # Dense datasets mark |flow| >= 1000 invalid.
            valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
        sample = {
            "image1": np.ascontiguousarray(img1, np.uint8),
            "image2": np.ascontiguousarray(img2, np.uint8),
            "flow": np.ascontiguousarray(flow, np.float32),
            "valid": np.ascontiguousarray(valid, np.float32),
        }
        if self.extra_info:
            # Sintel's (scene, frame): warm-start validation starts each
            # scene cold (the JAX package's training samples lack it, so its
            # warm chain runs on across scenes).
            sample["extra_info"] = self.extra_info[index]
        return sample


class MpiSintel(FlowDataset):
    """Sintel: consecutive frames of each scene (reference:
    core/datasets.py:102-118)."""

    def __init__(self, split="training", root="datasets/Sintel", dstype="clean"):
        super().__init__()
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        if split == "test":
            self.is_test = True
        if not osp.isdir(image_root):
            return
        for scene in sorted(os.listdir(image_root)):
            images = sorted(glob(osp.join(image_root, scene, "*.png")))
            for i in range(len(images) - 1):
                self.image_list.append([images[i], images[i + 1]])
                self.extra_info.append((scene, i))
            if split != "test":
                self.flow_list += sorted(glob(osp.join(flow_root, scene, "*.flo")))


class FlyingChairs(FlowDataset):
    """FlyingChairs; the split file's 1 and 2 labels pick the training and
    the validation pairs (reference: core/datasets.py:121-135)."""

    def __init__(
        self,
        split="train",
        root="datasets/FlyingChairs_release/data",
        split_file=PACKAGED_CHAIRS_SPLIT,
    ):
        super().__init__()
        images = sorted(glob(osp.join(root, "*_img*.png"))) or sorted(
            glob(osp.join(root, "*_img*.ppm")))
        flows = sorted(glob(osp.join(root, "*_flow.flo")))
        if not flows:
            return
        if len(images) // 2 != len(flows):
            raise ValueError(
                f"FlyingChairs under {root}: {len(images)} images for {len(flows)} flows")
        split_list = np.loadtxt(split_file, dtype=np.int32)
        want = 1 if split in ("train", "training") else 2
        for i in range(len(flows)):
            if split_list[i] == want:
                self.flow_list.append(flows[i])
                self.image_list.append([images[2 * i], images[2 * i + 1]])


class KITTI(FlowDataset):
    """KITTI 2015: ``*_10``/``*_11`` pairs, sparse ``flow_occ`` ground
    truth (reference: core/datasets.py:169-185)."""

    def __init__(self, split="training", root="datasets/KITTI"):
        super().__init__(sparse=True)
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
        for img1, img2 in zip(images1, images2):
            self.extra_info.append([osp.basename(img1)])
            self.image_list.append([img1, img2])
        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))
