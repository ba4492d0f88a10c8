"""ShapeNetPart dataset loader, numpy only (a copy of
`hitadv_tpu/data/shapenet.py`, whose package would import JAX).

Parity surface: `Dataset/ShapeNetDataLoader.py:137-236`
(PartNormalDataset): synsetoffset2category catalog, shuffled json
train/val/test splits, whitespace txt files (xyz normal seg), unit-sphere
normalization, random with-replacement resample to npoints, returns
``(point_set, cls)``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from hitadv_torch.data.modelnet import pc_normalize

# Category → segmentation label ids (reference :197-202)
SEG_CLASSES: Dict[str, List[int]] = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
    "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
    "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3],
    "Pistol": [38, 39, 40], "Chair": [12, 13, 14, 15], "Knife": [22, 23],
}


class PartNormalDataset:
    def __init__(self, root: str, npoints: int = 2500,
                 split: str = "test",
                 class_choice: Optional[List[str]] = None,
                 normal_channel: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        self.npoints = npoints
        self.root = root
        self.normal_channel = normal_channel
        self.rng = rng or np.random.RandomState(0)

        catfile = os.path.join(root, "synsetoffset2category.txt")
        self.cat: Dict[str, str] = {}
        with open(catfile) as f:
            for line in f:
                name, offset = line.strip().split()
                self.cat[name] = offset
        self.classes_original = {c: i for i, c in enumerate(self.cat)}
        if class_choice is not None:
            self.cat = {k: v for k, v in self.cat.items()
                        if k in class_choice}

        def split_ids(name):
            path = os.path.join(root, "train_test_split",
                                f"shuffled_{name}_file_list.json")
            with open(path) as f:
                return {d.split("/")[2] for d in json.load(f)}

        wanted = {
            "train": lambda fn: fn in split_ids("train"),
            "val": lambda fn: fn in split_ids("val"),
            "test": lambda fn: fn in split_ids("test"),
        }
        if split == "trainval":
            tv = split_ids("train") | split_ids("val")
            select = lambda fn: fn in tv  # noqa: E731
        elif split in wanted:
            ids = split_ids(split)
            select = lambda fn: fn in ids  # noqa: E731
        else:
            raise ValueError(f"unknown split {split!r}")

        self.datapath: List[Tuple[str, str]] = []
        for item, offset in self.cat.items():
            dir_point = os.path.join(root, offset)
            for fn in sorted(os.listdir(dir_point)):
                token = os.path.splitext(fn)[0]
                if select(token):
                    self.datapath.append(
                        (item, os.path.join(dir_point, token + ".txt")))

        self.classes = {c: self.classes_original[c] for c in self.cat}
        self.seg_classes = SEG_CLASSES
        self._cache: Dict[int, Tuple[np.ndarray, int, np.ndarray]] = {}
        self.cache_size = 20000

    def __len__(self) -> int:
        return len(self.datapath)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        if index in self._cache:
            point_set, cls, seg = self._cache[index]
        else:
            cat, path = self.datapath[index]
            cls = self.classes[cat]
            data = np.loadtxt(path).astype(np.float32)
            point_set = data[:, :6] if self.normal_channel else data[:, :3]
            seg = data[:, -1].astype(np.int32)
            if len(self._cache) < self.cache_size:
                self._cache[index] = (point_set, cls, seg)
        point_set = point_set.copy()
        point_set[:, :3] = pc_normalize(point_set[:, :3])
        choice = self.rng.choice(len(seg), self.npoints, replace=True)
        return point_set[choice].astype(np.float32), int(cls)
