"""The optical-flow datasets (port of ``raft_ncup_tpu/data/datasets.py``).

Index construction mirrors the reference's globs for MpiSintel,
FlyingChairs (with the packaged train/validation split file),
FlyingThings3D, KITTI and HD1K. A sample is a dict of numpy arrays,
channel-last: ``image1``/``image2`` (H, W, 3) uint8, ``flow`` (H, W, 2)
float32, ``valid`` (H, W) float32; a test-split sample carries
``extra_info`` instead of flow and validity, and a Sintel sample read
without an augmentor (validation) carries it too.

With augmentation parameters a dataset augments each training sample
with ``data/augment.py``'s augmentors, drawing from the generator the
caller passes (the loader's per-(seed, epoch, index) one).
:class:`MixedDataset` concatenates datasets with replication factors by
an index table, and :func:`fetch_training_set` builds each stage's
mixture with the JAX package's augmentation ranges. FlyingThings3D's
compressed form (``load_compressed``) globs webp frames, which the port
cannot decode yet: reading one raises, naming the codec.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob

from typing import Optional, Sequence

import numpy as np

from raft_ncup_tpu_torch.config import DataConfig
from raft_ncup_tpu_torch.data.augment import FlowAugmentor, SparseFlowAugmentor
from raft_ncup_tpu_torch.io import read_flow_kitti, read_gen

PACKAGED_CHAIRS_SPLIT = osp.join(osp.dirname(osp.abspath(__file__)), "chairs_split.txt")


class FlowDataset:
    """A list of (image1, image2) paths with their flow paths, and the
    augmentor that ``aug_params`` configures (none without them)."""

    def __init__(self, aug_params: Optional[dict] = None, sparse: bool = False):
        self.sparse = sparse
        self.augmentor = None
        if aug_params is not None:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(**aug_params)
        self.is_test = False
        self.flow_list: list[str] = []
        self.image_list: list[list[str]] = []
        self.extra_info: list = []

    def __len__(self) -> int:
        return len(self.image_list)

    def sample(self, index: int, rng: Optional[np.random.Generator] = None) -> dict:
        """Load one pair, augmented with ``rng`` when the dataset has an
        augmentor (a fresh generator if ``rng`` is None)."""
        if self.is_test:
            img1 = read_gen(self.image_list[index][0])
            img2 = read_gen(self.image_list[index][1])
            return {"image1": img1, "image2": img2, "extra_info": self.extra_info[index]}
        index %= len(self.image_list)
        if self.sparse:
            flow, valid = read_flow_kitti(self.flow_list[index])
        else:
            flow, valid = read_gen(self.flow_list[index]), None
        img1 = read_gen(self.image_list[index][0])
        img2 = read_gen(self.image_list[index][1])
        flow = np.asarray(flow, np.float32)
        if self.augmentor is not None:
            rng = np.random.default_rng() if rng is None else rng
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow, valid, rng)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, rng)
        if valid is None:
            # Dense datasets mark |flow| >= 1000 invalid.
            valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
        sample = {
            "image1": np.ascontiguousarray(img1, np.uint8),
            "image2": np.ascontiguousarray(img2, np.uint8),
            "flow": np.ascontiguousarray(flow, np.float32),
            "valid": np.ascontiguousarray(valid, np.float32),
        }
        if self.extra_info and self.augmentor is None:
            # Sintel's (scene, frame): warm-start validation starts each
            # scene cold (the JAX package's samples lack it, so its warm
            # chain runs on across scenes). Training samples go without it,
            # as the JAX package's do.
            sample["extra_info"] = self.extra_info[index]
        return sample


class MpiSintel(FlowDataset):
    """Sintel: consecutive frames of each scene (reference:
    core/datasets.py:102-118)."""

    def __init__(self, aug_params=None, split="training", root="datasets/Sintel",
                 dstype="clean"):
        super().__init__(aug_params)
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
        aug_params=None,
        split="train",
        root="datasets/FlyingChairs_release/data",
        split_file=PACKAGED_CHAIRS_SPLIT,
    ):
        super().__init__(aug_params)
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

    def __init__(self, aug_params=None, split="training", root="datasets/KITTI"):
        super().__init__(aug_params, sparse=True)
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


class FlyingThings3D(FlowDataset):
    """FlyingThings3D: the left camera, both temporal directions
    (reference: core/datasets.py:138-166); ``load_compressed`` globs the
    webp frames and npz flows instead."""

    def __init__(
        self,
        aug_params=None,
        root="datasets/FlyingThings3D",
        dstype="frames_cleanpass",
        load_compressed=False,
    ):
        super().__init__(aug_params)
        cam = "left"
        img_dstype = dstype + ("_webp" if load_compressed else "")
        img_ext = "*.webp" if load_compressed else "*.png"
        flow_ext = "*.npz" if load_compressed else "*.pfm"
        image_seq_dirs = sorted(glob(osp.join(root, img_dstype, "TRAIN/*/*")))
        flow_seq_dirs = sorted(glob(osp.join(root, "optical_flow/TRAIN/*/*")))
        for direction in ("into_future", "into_past"):
            image_dirs = sorted(osp.join(f, cam) for f in image_seq_dirs)
            flow_dirs = sorted(osp.join(f, direction, cam) for f in flow_seq_dirs)
            for idir, fdir in zip(image_dirs, flow_dirs):
                images = sorted(glob(osp.join(idir, img_ext)))
                flows = sorted(glob(osp.join(fdir, flow_ext)))
                for i in range(len(flows) - 1):
                    if direction == "into_future":
                        self.image_list.append([images[i], images[i + 1]])
                        self.flow_list.append(flows[i])
                    else:
                        self.image_list.append([images[i + 1], images[i]])
                        self.flow_list.append(flows[i + 1])


class HD1K(FlowDataset):
    """HD1K: consecutive frames of each sequence, sparse ``flow_occ``
    ground truth (reference: core/datasets.py:188-204)."""

    def __init__(self, aug_params=None, root="datasets/HD1k"):
        super().__init__(aug_params, sparse=True)
        seq_ix = 0
        while True:
            flows = sorted(
                glob(osp.join(root, "hd1k_flow_gt", f"flow_occ/{seq_ix:06d}_*.png")))
            images = sorted(
                glob(osp.join(root, "hd1k_input", f"image_2/{seq_ix:06d}_*.png")))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(flows[i])
                self.image_list.append([images[i], images[i + 1]])
            seq_ix += 1


class MixedDataset:
    """Datasets concatenated with replication factors (the reference's
    ``100*sintel_clean + ... + things``): an index table maps a mixed index
    to (dataset, local index). Empty parts are left out."""

    def __init__(self, parts: Sequence[tuple[FlowDataset, int]]):
        self.parts = [(ds, int(w)) for ds, w in parts if len(ds) > 0]
        self._table: list[tuple[int, int]] = []
        for di, (ds, w) in enumerate(self.parts):
            self._table.extend((di, i) for _ in range(w) for i in range(len(ds)))

    def __len__(self) -> int:
        return len(self._table)

    def sample(self, index: int, rng: Optional[np.random.Generator] = None) -> dict:
        di, li = self._table[index]
        return self.parts[di][0].sample(li, rng)


def fetch_training_set(
    stage: str,
    image_size: tuple[int, int],
    data_cfg: Optional[DataConfig] = None,
    train_ds: str = "C+T+K+S+H",
):
    """The stage's training mixture (reference: core/datasets.py:207-238),
    with each stage's augmentation ranges and the sintel stage's
    100/100/200/5/1 mixture. With ``data_cfg.synthetic_ok``, an empty
    mixture (no dataset on disk) gives procedural pairs instead."""
    cfg = data_cfg or DataConfig()
    ds = _fetch_training_set(stage, image_size, cfg, train_ds)
    if len(ds) == 0 and cfg.synthetic_ok:
        from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset

        return SyntheticFlowDataset(tuple(image_size), length=512, style=cfg.synthetic_style)
    return ds


def _fetch_training_set(stage: str, image_size, cfg: DataConfig, train_ds: str):
    crop = tuple(image_size)
    if stage == "chairs":
        aug = dict(crop_size=crop, min_scale=-0.1, max_scale=1.0, do_flip=True)
        return FlyingChairs(aug, split="training", root=cfg.root_chairs,
                            split_file=cfg.chairs_split_file)
    if stage == "things":
        aug = dict(crop_size=crop, min_scale=-0.4, max_scale=0.8, do_flip=True)
        clean = FlyingThings3D(aug, root=cfg.root_things, dstype="frames_cleanpass",
                               load_compressed=cfg.compressed_ft)
        final = FlyingThings3D(aug, root=cfg.root_things, dstype="frames_finalpass",
                               load_compressed=cfg.compressed_ft)
        return MixedDataset([(clean, 1), (final, 1)])
    if stage == "sintel":
        aug = dict(crop_size=crop, min_scale=-0.2, max_scale=0.6, do_flip=True)
        things = FlyingThings3D(aug, root=cfg.root_things, dstype="frames_cleanpass",
                                load_compressed=cfg.compressed_ft)
        clean = MpiSintel(aug, split="training", root=cfg.root_sintel, dstype="clean")
        final = MpiSintel(aug, split="training", root=cfg.root_sintel, dstype="final")
        if train_ds == "C+T+K+S+H":
            kitti = KITTI(dict(crop_size=crop, min_scale=-0.3, max_scale=0.5, do_flip=True),
                          split="training", root=cfg.root_kitti)
            hd1k = HD1K(dict(crop_size=crop, min_scale=-0.5, max_scale=0.2, do_flip=True),
                        root=cfg.root_hd1k)
            return MixedDataset(
                [(clean, 100), (final, 100), (kitti, 200), (hd1k, 5), (things, 1)])
        return MixedDataset([(clean, 100), (final, 100), (things, 1)])
    if stage == "kitti":
        aug = dict(crop_size=crop, min_scale=-0.2, max_scale=0.4, do_flip=False)
        return KITTI(aug, split="training", root=cfg.root_kitti)
    raise ValueError(f"unknown training stage: {stage!r}")
