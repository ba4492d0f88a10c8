"""Segmentation / scene datasets (DGCNN-style HDF5 + ScanNet pickle), a
copy of `hitadv_tpu/data/extra_h5.py` (whose package would import JAX).
``h5py`` is imported where a file is read, so that the package imports
without it.

Parity surface: `Dataset/data.py:94-165` (load_data_partseg /
load_data_semseg) and the dataset classes `ShapeNetPart` (:293-331),
`S3DIS` (:334-354), `ScanNet` (:356-455, block-sampling loader). Loaders
are torch-free; the reference's cv2-rendered color-legend helpers
(`load_color_*`) become plain color tables.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

SHAPENET_CAT2ID = {
    "airplane": 0, "bag": 1, "cap": 2, "car": 3, "chair": 4,
    "earphone": 5, "guitar": 6, "knife": 7, "lamp": 8, "laptop": 9,
    "motor": 10, "mug": 11, "pistol": 12, "rocket": 13,
    "skateboard": 14, "table": 15,
}
SHAPENET_SEG_NUM = [4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3]
SHAPENET_INDEX_START = [0, 4, 6, 8, 12, 16, 19, 22, 24, 28, 30, 36, 38,
                        41, 44, 47]


def load_data_partseg(data_dir: str, partition: str):
    """shapenet_part_seg_hdf5_data h5 files → (data, label, seg)."""
    import h5py

    if partition == "trainval":
        files = (sorted(glob.glob(os.path.join(data_dir, "*train*.h5")))
                 + sorted(glob.glob(os.path.join(data_dir, "*val*.h5"))))
    else:
        files = sorted(glob.glob(os.path.join(data_dir,
                                              f"*{partition}*.h5")))
    if not files:
        raise FileNotFoundError(f"no partseg h5 in {data_dir}")
    data, label, seg = [], [], []
    for name in files:
        with h5py.File(name, "r") as f:
            data.append(f["data"][:].astype("float32"))
            label.append(f["label"][:].astype("int64"))
            seg.append(f["pid"][:].astype("int64"))
    return (np.concatenate(data), np.concatenate(label).squeeze(-1),
            np.concatenate(seg))


def load_data_semseg(data_dir: str):
    """indoor3d_sem_seg_hdf5_data layout (all_files.txt + room_filelist)."""
    import h5py

    with open(os.path.join(data_dir, "all_files.txt")) as f:
        all_files = [l.rstrip() for l in f]
    data, label = [], []
    base = os.path.dirname(data_dir.rstrip("/"))
    for rel in all_files:
        with h5py.File(os.path.join(base, rel), "r") as f:
            data.append(f["data"][:])
            label.append(f["label"][:])
    return np.concatenate(data, 0), np.concatenate(label, 0)


class ShapeNetPartH5:
    """Part segmentation dataset. Parity: `Dataset/data.py:293-331`."""

    def __init__(self, data_dir: str, num_points: int,
                 partition: str = "test",
                 class_choice: Optional[str] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.data, self.label, self.seg = load_data_partseg(data_dir,
                                                            partition)
        self.num_points = num_points
        self.partition = partition
        self.rng = rng or np.random.RandomState(0)
        if class_choice is not None:
            cid = SHAPENET_CAT2ID[class_choice]
            keep = self.label == cid
            self.data, self.label, self.seg = (self.data[keep],
                                               self.label[keep],
                                               self.seg[keep])
            self.seg_num_all = SHAPENET_SEG_NUM[cid]
            self.seg_start_index = SHAPENET_INDEX_START[cid]
        else:
            self.seg_num_all = 50
            self.seg_start_index = 0

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item: int):
        pc = self.data[item][:self.num_points].copy()
        seg = self.seg[item][:self.num_points].copy()
        if self.partition == "trainval":
            order = self.rng.permutation(len(pc))
            pc, seg = pc[order], seg[order]
        return pc, int(self.label[item]), seg


class S3DISH5:
    """Semantic segmentation dataset. Parity: `Dataset/data.py:334-354`."""

    def __init__(self, data_dir: str, num_points: int = 4096,
                 partition: str = "test",
                 rng: Optional[np.random.RandomState] = None):
        self.data, self.seg = load_data_semseg(data_dir)
        self.num_points = num_points
        self.partition = partition
        self.rng = rng or np.random.RandomState(0)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item: int):
        pc = self.data[item][:self.num_points].copy()
        seg = self.seg[item][:self.num_points].copy()
        if self.partition == "train":
            order = self.rng.permutation(len(pc))
            pc, seg = pc[order], seg[order]
        return pc.astype(np.float32), seg.astype(np.int64)


class ScanNetBlocks:
    """ScanNet block-sampling loader. Parity: `Dataset/data.py:356-455`.

    Rooms come from the `scannet_{split}_rgb21c_pointid.pickle` files;
    each __getitem__ samples a (block_size x block_size) column around a
    random center and resamples to ``num_point`` points. Labels are
    remapped 0..20 → 0..19 with ignore=255 like the reference.
    """

    def __init__(self, data_root: str, num_point: int = 8192,
                 partition: str = "train", block_size: float = 1.5,
                 sample_rate: float = 1.0, use_rgb: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        self.num_point = num_point
        self.block_size = block_size
        self.use_rgb = use_rgb
        self.rng = rng or np.random.RandomState(0)

        parts = partition if isinstance(partition, list) else [partition]
        xyz_all: List[np.ndarray] = []
        label_all: List[np.ndarray] = []
        for p in parts:
            path = os.path.join(data_root,
                                f"scannet_{p}_rgb21c_pointid.pickle")
            with open(path, "rb") as f:
                xyz_all.extend(pickle.load(f))
                label_all.extend(pickle.load(f))
        self.xyz_all = xyz_all
        self.label_all = []
        num_point_all = []
        for label in label_all:
            remapped = label.astype(np.int64) - 1
            remapped[label == 0] = 255
            self.label_all.append(remapped.astype(np.uint8))
            num_point_all.append(label.size)

        prob = np.asarray(num_point_all) / np.sum(num_point_all)
        num_iter = int(np.sum(num_point_all) * sample_rate / num_point)
        room_idxs: List[int] = []
        for i in range(len(xyz_all)):
            room_idxs.extend([i] * int(round(prob[i] * num_iter)))
        self.room_idxs = np.asarray(room_idxs, np.int64)

    def __len__(self):
        return len(self.room_idxs)

    def __getitem__(self, idx: int):
        room = self.room_idxs[idx]
        points = self.xyz_all[room]
        labels = self.label_all[room]
        if not self.use_rgb:
            points = points[:, :3]
        n = points.shape[0]
        half = self.block_size / 2.0
        sel = None
        for _ in range(10):
            center = points[self.rng.choice(n)][:3]
            lo = center - [half, half, 0]
            hi = center + [half, half, 0]
            mask = ((points[:, 0] >= lo[0]) & (points[:, 0] <= hi[0])
                    & (points[:, 1] >= lo[1]) & (points[:, 1] <= hi[1]))
            idxs = np.where(mask)[0]
            if idxs.size > 1024:
                sel = idxs
                break
        if sel is None:
            sel = np.arange(n)
        choice = self.rng.choice(sel, self.num_point,
                                 replace=sel.size < self.num_point)
        return (points[choice].astype(np.float32),
                labels[choice].astype(np.int64))
