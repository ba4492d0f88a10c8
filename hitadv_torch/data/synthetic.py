"""Deterministic synthetic point-cloud dataset.

Stands in for ModelNet40 when the real data (distributed out-of-band by
the reference, `README.md:24-26`) is absent: class-conditional gaussian
blobs deformed onto distinct ellipsoid surfaces, unit-sphere normalized
with outward normals — same ``(points [B, N, 6], label [B])`` contract as
`Dataset/ModelNet.py:44-137`.

A copy of `hitadv_tpu/data/synthetic.py` (numpy only): importing that
package would import JAX. Keep the two identical, so that both packages
draw the same clouds from the same seed.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def synthetic_clouds(num: int, num_points: int = 1024,
                     num_classes: int = 40,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Generate ``(points [num, N, 6], labels [num])`` float32/int32.

    Each class is an ellipsoid with class-specific axes + lobed radial
    modulation, so a classifier can actually separate them.
    """
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=num).astype(np.int32)
    out = np.zeros((num, num_points, 6), dtype=np.float32)
    for i, c in enumerate(labels):
        crng = np.random.RandomState(1000 + int(c))
        axes = 0.4 + crng.rand(3)                      # class ellipsoid
        freq = 1 + int(c) % 5
        amp = 0.1 + 0.1 * ((int(c) // 5) % 4) / 3.0

        v = rng.randn(num_points, 3)
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
        # lobed radius modulation for class geometry
        r = 1.0 + amp * np.cos(freq * np.arctan2(v[:, 1], v[:, 0]))
        pts = v * r[:, None] * axes[None, :]

        # unit-sphere normalize (pc_normalize parity, Dataset/ModelNet.py:12-17)
        pts = pts - pts.mean(0, keepdims=True)
        pts = pts / (np.abs(np.linalg.norm(pts, axis=1)).max() + 1e-9)

        # outward normals (approximate: radial direction)
        normals = pts / (np.linalg.norm(pts, axis=1, keepdims=True) + 1e-9)
        out[i, :, :3] = pts
        out[i, :, 3:] = normals
    return out, labels


def synthetic_batches(num_batches: int, batch_size: int,
                      num_points: int = 1024, num_classes: int = 40,
                      seed: int = 0) -> Iterator[Tuple[np.ndarray,
                                                       np.ndarray]]:
    """Yield ``(points [B, N, 6], labels [B])`` batches."""
    pts, labels = synthetic_clouds(num_batches * batch_size, num_points,
                                   num_classes, seed)
    for i in range(num_batches):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        yield pts[sl], labels[sl]
