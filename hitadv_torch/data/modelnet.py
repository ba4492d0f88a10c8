"""ModelNet40/10 dataset loaders (txt + HDF5), numpy only.

A copy of `hitadv_tpu/data/modelnet.py`: importing that package would
import JAX. Keep the two identical in what they return, so that both
packages read the same clouds from the same files and seeds.

Parity surface:
  * `Dataset/ModelNet.py:44-137` (ModelNetDataLoader): the
    `modelnet40_normal_resampled` txt layout (comma-separated
    xyz+normal), catalog/split files, take-first-npoints or per-sample
    numpy FPS resampling, unit-sphere normalization of xyz, optional
    pickle preprocessing cache.
  * `Dataset/data.py:76-91` (load_data_cls) + `:275-291` (ModelNet40):
    the DGCNN-style `modelnet40_ply_hdf5_2048/*.h5` files with
    train-time translate+shuffle augmentation.

The reference reads via 10 forked DataLoader workers (`eval.py:90`); here
the threaded prefetching iterator of `data/loader.py` takes their place.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Iterator, List, Optional, Tuple

import numpy as np

# The 40 ModelNet class names (reference `modelnet40_class`, standard
# modelnet40_normal_resampled order).
MODELNET40_CLASSES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant",
    "radio", "range_hood", "sink", "sofa", "stairs", "stool", "table",
    "tent", "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center + scale to the unit sphere. Parity: `Dataset/ModelNet.py:12-17`."""
    pc = pc - pc.mean(axis=0)
    m = np.max(np.sqrt(np.sum(pc ** 2, axis=1)))
    return pc / m


def fps_numpy(point: np.ndarray, npoint: int,
              rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Per-sample numpy FPS with random start.

    Parity: `Dataset/ModelNet.py:20-41` (dataset-side resampling).
    """
    if rng is None:
        rng = np.random
    N = point.shape[0]
    xyz = point[:, :3]
    centroids = np.zeros(npoint, dtype=np.int64)
    distance = np.full(N, 1e10)
    farthest = int(rng.randint(0, N))
    for i in range(npoint):
        centroids[i] = farthest
        dist = np.sum((xyz - xyz[farthest]) ** 2, axis=-1)
        distance = np.minimum(distance, dist)
        farthest = int(np.argmax(distance))
    return point[centroids]


class ModelNetDataset:
    """`modelnet40_normal_resampled` txt dataset.

    Yields ``(points [N, 3|6] float32, label int)`` per item; use
    `data.loader.batch_iterator` to batch.
    """

    def __init__(self, root: str, num_points: int = 1024,
                 split: str = "test", use_normals: bool = True,
                 num_category: int = 40, uniform: bool = False,
                 process_data: bool = False,
                 parser: Optional[object] = None):
        self.root = root
        self.npoints = num_points
        self.uniform = uniform
        self.use_normals = use_normals
        self.process_data = process_data
        self.parser = parser  # optional native txt parser (runtime/)

        prefix = f"modelnet{num_category}"
        catfile = os.path.join(root, f"{prefix}_shape_names.txt")
        self.cat = [l.rstrip() for l in open(catfile)]
        self.classes = {c: i for i, c in enumerate(self.cat)}
        ids = [l.rstrip() for l in
               open(os.path.join(root, f"{prefix}_{split}.txt"))]
        names = ["_".join(x.split("_")[:-1]) for x in ids]
        self.datapath = [
            (names[i], os.path.join(root, names[i], ids[i]) + ".txt")
            for i in range(len(ids))]

        suffix = "pts_fps" if uniform else "pts"
        self.save_path = os.path.join(
            root, f"{prefix}_{split}_{num_points}{suffix}.dat")
        self._points: Optional[List[np.ndarray]] = None
        self._labels: Optional[List[np.ndarray]] = None
        if process_data:
            self._preprocess()

    def _load_txt(self, path: str) -> np.ndarray:
        if self.parser is not None:
            return self.parser.load_txt(path)
        return np.loadtxt(path, delimiter=",").astype(np.float32)

    def _read_raw(self, index: int) -> Tuple[np.ndarray, int]:
        name, path = self.datapath[index]
        point_set = self._load_txt(path)
        if self.uniform:
            point_set = fps_numpy(point_set, self.npoints)
        else:
            point_set = point_set[:self.npoints]
        return point_set, self.classes[name]

    def _preprocess(self) -> None:
        if os.path.exists(self.save_path):
            with open(self.save_path, "rb") as f:
                self._points, self._labels = pickle.load(f)
            return
        self._points, self._labels = [], []
        for i in range(len(self.datapath)):
            pts, lab = self._read_raw(i)
            self._points.append(pts)
            self._labels.append(np.array([lab], np.int32))
        with open(self.save_path, "wb") as f:
            pickle.dump([self._points, self._labels], f)

    def __len__(self) -> int:
        return len(self.datapath)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        if self._points is not None:
            point_set = self._points[index].copy()
            label = int(self._labels[index][0])
        else:
            point_set, label = self._read_raw(index)
        point_set[:, :3] = pc_normalize(point_set[:, :3])
        if not self.use_normals:
            point_set = point_set[:, :3]
        return point_set.astype(np.float32), label


# ---------------------------------------------------------------------------
# HDF5 (DGCNN-style)
# ---------------------------------------------------------------------------

def load_h5_cls(data_dir: str,
                partition: str = "test") -> Tuple[np.ndarray, np.ndarray]:
    """Read `modelnet40_ply_hdf5_2048/*<partition>*.h5` → (data, label).

    Parity: `Dataset/data.py:76-91` (minus the download step).
    """
    import h5py

    all_data, all_label = [], []
    pattern = os.path.join(data_dir, f"*{partition}*.h5")
    for name in sorted(glob.glob(pattern)):
        with h5py.File(name, "r") as f:
            all_data.append(f["data"][:].astype("float32"))
            all_label.append(f["label"][:].astype("int64"))
    if not all_data:
        raise FileNotFoundError(f"no h5 files matching {pattern}")
    return (np.concatenate(all_data, axis=0),
            np.concatenate(all_label, axis=0).squeeze(-1))


class ModelNet40H5:
    """DGCNN-style h5 dataset. Parity: `Dataset/data.py:275-291`."""

    def __init__(self, data_dir: str, num_points: int,
                 partition: str = "test",
                 rng: Optional[np.random.RandomState] = None):
        self.data, self.label = load_h5_cls(data_dir, partition)
        self.num_points = num_points
        self.partition = partition
        self.rng = rng or np.random.RandomState(0)

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, item: int) -> Tuple[np.ndarray, int]:
        from hitadv_torch.data import provider

        pc = self.data[item][:self.num_points].copy()
        label = int(self.label[item])
        if self.partition == "train":
            pc = provider.translate_pointcloud(pc, self.rng)
            self.rng.shuffle(pc)
        return pc, label
