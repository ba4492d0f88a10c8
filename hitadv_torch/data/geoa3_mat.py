"""GeoA3's .mat dataset (a copy of `hitadv_tpu/data/geoa3_mat.py`, numpy
and scipy only: importing that package would import JAX; keep the two
the same, so that both give the same items from the same file and seed).

Reference `Dataset/GeoA3_ModelNet.py:10-130`: loads ``{data [M, 3, N],
normal [M, 3, N], label [M]}`` from a .mat file, optionally resamples
each cloud by farthest point sampling from a random start and
normalises it, and expands the attack labels:
  * a class name of the 10-class list: that class's 25-item slice, each
    item as in 'All';
  * 'All': per item, the 9 target labels (the ten label indexes but the
    true class), the cloud tiled 9 times;
  * 'Untarget': the item alone, untargeted;
  * 'Random': one random target other than the truth.
Every random draw comes from ``np.random.RandomState(seed)``, in the
reference's order. Clouds are channels-last numpy ``[K, N, 3]``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

TEN_LABEL_INDEXES = [17, 9, 36, 20, 3, 16, 34, 38, 23, 15]
TEN_LABEL_NAMES = ["airplane", "bed", "bookshelf", "bottle", "chair",
                   "monitor", "sofa", "table", "toilet", "vase"]


def farthest_points_normalized(points: np.ndarray, num_points: int,
                               normal: np.ndarray,
                               rng: Optional[np.random.RandomState] = None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """FPS resample then center+scale. Parity: `Dataset/GeoA3_ModelNet.py:109-130`."""
    if rng is None:
        rng = np.random
    n = len(points)
    first = int(rng.randint(n))
    selected = [first]
    dists = np.full(n, np.inf)
    for _ in range(num_points - 1):
        dists = np.minimum(
            dists, np.linalg.norm(points - points[selected[-1]], axis=1))
        selected.append(int(np.argmax(dists)))
    pts = points[selected]
    nrm = normal[selected]
    pts = pts - pts.mean(0, keepdims=True)
    scale = np.max(np.linalg.norm(pts, axis=1))
    return (pts / scale).astype(np.float32), nrm.astype(np.float32)


class GeoA3ModelNet40:
    def __init__(self, data_mat_file: str, attack_label: str = "All",
                 resample_num: int = -1, seed: int = 0):
        from scipy.io import loadmat

        self.attack_label = attack_label
        self.rng = np.random.RandomState(seed)
        dataset = loadmat(data_mat_file)
        data = np.asarray(dataset["data"], np.float32)       # [M, 3, N]
        normal = np.asarray(dataset["normal"], np.float32)
        label = np.asarray(dataset["label"]).reshape(len(data), -1)

        # channels-last
        data = np.swapaxes(data, 1, 2)                        # [M, N, 3]
        normal = np.swapaxes(normal, 1, 2)

        if resample_num > 0:
            res = [farthest_points_normalized(d, resample_num, n, self.rng)
                   for d, n in zip(data, normal)]
            data = np.stack([r[0] for r in res])
            normal = np.stack([r[1] for r in res])

        if attack_label in TEN_LABEL_NAMES:
            k = TEN_LABEL_NAMES.index(attack_label)
            sl = slice(k * 25, (k + 1) * 25)
            self.start_index = k * 25
            self.data, self.normal, self.label = (data[sl], normal[sl],
                                                  label[sl])
        elif attack_label in ("All", "Untarget", "Random"):
            self.start_index = 0
            self.data, self.normal, self.label = data, normal, label
        else:
            raise ValueError(f"unknown attack_label {attack_label!r}")

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int):
        label = int(self.label[index].reshape(-1)[0])
        pc = self.data[index]
        normal = self.normal[index]

        if self.attack_label in TEN_LABEL_NAMES or \
                self.attack_label == "All":
            targets = np.array([i for i in TEN_LABEL_INDEXES
                                if i != label], np.int64)
            assert len(targets) == 9
            pcs = np.broadcast_to(pc, (9,) + pc.shape).copy()
            normals = np.broadcast_to(normal, (9,) + normal.shape).copy()
            gts = np.full(9, label, np.int64)
            return pcs, normals, gts, targets
        if self.attack_label == "Untarget":
            return pc[None], normal[None], np.array([label], np.int64)
        # Random
        candidates = [i for i in range(40) if i != label]
        target = np.array([self.rng.choice(candidates)], np.int64)
        return pc[None], normal[None], np.array([label], np.int64), target
