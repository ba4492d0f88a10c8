"""NumPy batch augmentation library (a copy of
`hitadv_tpu/data/provider.py`, whose package would import JAX).

Parity surface: reference `provider.py:3-251` (the 15 classic PointNet
augmentations) plus the per-cloud DGCNN ones (`Dataset/data.py:254-272`).
All functions take explicit ``rng`` (np.random.RandomState) instead of
mutating global numpy state, and operate on ``[B, N, 3]`` (or ``[B, N,
6]`` for the `_with_normal` variants).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rng(rng):
    return rng if rng is not None else np.random


def normalize_data(batch_data: np.ndarray) -> np.ndarray:
    """Center and unit-sphere scale each cloud. Parity: `provider.py:3-19`."""
    out = np.empty_like(batch_data)
    for b in range(batch_data.shape[0]):
        pc = batch_data[b] - np.mean(batch_data[b], axis=0)
        m = np.max(np.sqrt(np.sum(pc ** 2, axis=1)))
        out[b] = pc / m
    return out


def shuffle_data(data: np.ndarray, labels: np.ndarray, rng=None):
    """Shuffle items and labels together. Parity: `provider.py:22-31`."""
    idx = np.arange(len(labels))
    _rng(rng).shuffle(idx)
    return data[idx], labels[idx], idx


def shuffle_points(batch_data: np.ndarray, rng=None) -> np.ndarray:
    """Shuffle point order within every cloud. Parity: `provider.py:34-43`."""
    idx = np.arange(batch_data.shape[1])
    _rng(rng).shuffle(idx)
    return batch_data[:, idx, :]


def _rotate(batch_data, axis: str, angles) -> np.ndarray:
    out = np.empty_like(batch_data)
    for b in range(batch_data.shape[0]):
        c, s = np.cos(angles[b]), np.sin(angles[b])
        if axis == "y":
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        else:  # z
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        out[b] = batch_data[b] @ R
    return out.astype(batch_data.dtype)


def rotate_point_cloud(batch_data: np.ndarray, rng=None) -> np.ndarray:
    """Random y-rotation per cloud. Parity: `provider.py:46-63`."""
    angles = _rng(rng).uniform(size=batch_data.shape[0]) * 2 * np.pi
    return _rotate(batch_data, "y", angles)


def rotate_point_cloud_z(batch_data: np.ndarray, rng=None) -> np.ndarray:
    """Random z-rotation per cloud. Parity: `provider.py:66-83`."""
    angles = _rng(rng).uniform(size=batch_data.shape[0]) * 2 * np.pi
    return _rotate(batch_data, "z", angles)


def rotate_point_cloud_with_normal(batch_xyz_normal: np.ndarray,
                                   rng=None) -> np.ndarray:
    """y-rotation of xyz AND normals. Parity: `provider.py:86-103`."""
    angles = _rng(rng).uniform(size=batch_xyz_normal.shape[0]) * 2 * np.pi
    out = batch_xyz_normal.copy()
    out[..., :3] = _rotate(batch_xyz_normal[..., :3], "y", angles)
    out[..., 3:6] = _rotate(batch_xyz_normal[..., 3:6], "y", angles)
    return out


def _perturbation_rotations(B, angle_sigma, angle_clip, rng):
    return np.clip(angle_sigma * _rng(rng).randn(B, 3),
                   -angle_clip, angle_clip)


def _rotation_matrix_xyz(angles: np.ndarray) -> np.ndarray:
    """R = Rz @ Ry @ Rx from per-axis angles [3]."""
    ax, ay, az = angles
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)],
                   [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0],
                   [0, 0, 1]])
    return Rz @ Ry @ Rx


def rotate_perturbation_point_cloud(batch_data: np.ndarray,
                                    angle_sigma: float = 0.06,
                                    angle_clip: float = 0.18,
                                    rng=None) -> np.ndarray:
    """Small random 3-axis rotations. Parity: `provider.py:176-198`."""
    B = batch_data.shape[0]
    angles = _perturbation_rotations(B, angle_sigma, angle_clip, rng)
    out = np.empty_like(batch_data)
    for b in range(B):
        out[b] = batch_data[b] @ _rotation_matrix_xyz(angles[b]).T
    return out.astype(batch_data.dtype)


def rotate_perturbation_point_cloud_with_normal(batch_data: np.ndarray,
                                                angle_sigma: float = 0.06,
                                                angle_clip: float = 0.18,
                                                rng=None) -> np.ndarray:
    """Parity: `provider.py:106-130`."""
    B = batch_data.shape[0]
    angles = _perturbation_rotations(B, angle_sigma, angle_clip, rng)
    out = batch_data.copy()
    for b in range(B):
        R = _rotation_matrix_xyz(angles[b]).T
        out[b, :, :3] = batch_data[b, :, :3] @ R
        out[b, :, 3:6] = batch_data[b, :, 3:6] @ R
    return out


def rotate_point_cloud_by_angle(batch_data: np.ndarray,
                                rotation_angle: float) -> np.ndarray:
    """Fixed y-rotation. Parity: `provider.py:133-149`."""
    angles = np.full(batch_data.shape[0], rotation_angle)
    return _rotate(batch_data, "y", angles)


def rotate_point_cloud_by_angle_with_normal(batch_data: np.ndarray,
                                            rotation_angle: float
                                            ) -> np.ndarray:
    """Parity: `provider.py:152-173`."""
    angles = np.full(batch_data.shape[0], rotation_angle)
    out = batch_data.copy()
    out[..., :3] = _rotate(batch_data[..., :3], "y", angles)
    out[..., 3:6] = _rotate(batch_data[..., 3:6], "y", angles)
    return out


def jitter_point_cloud(batch_data: np.ndarray, sigma: float = 0.01,
                       clip: float = 0.05, rng=None) -> np.ndarray:
    """Clamped gaussian jitter. Parity: `provider.py:201-211`."""
    jitter = np.clip(sigma * _rng(rng).randn(*batch_data.shape),
                     -clip, clip)
    return (batch_data + jitter).astype(batch_data.dtype)


def shift_point_cloud(batch_data: np.ndarray, shift_range: float = 0.1,
                      rng=None) -> np.ndarray:
    """Per-cloud random translation. Parity: `provider.py:214-225`."""
    B = batch_data.shape[0]
    shifts = _rng(rng).uniform(-shift_range, shift_range, (B, 3))
    return (batch_data + shifts[:, None, :]).astype(batch_data.dtype)


def random_scale_point_cloud(batch_data: np.ndarray,
                             scale_low: float = 0.8,
                             scale_high: float = 1.25,
                             rng=None) -> np.ndarray:
    """Per-cloud random scale. Parity: `provider.py:228-238`."""
    B = batch_data.shape[0]
    scales = _rng(rng).uniform(scale_low, scale_high, B)
    return (batch_data * scales[:, None, None]).astype(batch_data.dtype)


def random_point_dropout(batch_pc: np.ndarray,
                         max_dropout_ratio: float = 0.875,
                         rng=None) -> np.ndarray:
    """Replace a random subset of points with the first point.

    Parity: `provider.py:241-251`.
    """
    r = _rng(rng)
    out = batch_pc.copy()
    for b in range(batch_pc.shape[0]):
        ratio = r.random_sample() * max_dropout_ratio
        drop = np.where(r.random_sample(batch_pc.shape[1]) <= ratio)[0]
        if len(drop) > 0:
            out[b, drop] = batch_pc[b, 0]
    return out


# --- DGCNN-style per-cloud augmentations (Dataset/data.py:254-272) -----

def translate_pointcloud(pointcloud: np.ndarray, rng=None) -> np.ndarray:
    r = _rng(rng)
    xyz1 = r.uniform(2.0 / 3.0, 3.0 / 2.0, 3)
    xyz2 = r.uniform(-0.2, 0.2, 3)
    return (pointcloud * xyz1 + xyz2).astype("float32")


def jitter_pointcloud(pointcloud: np.ndarray, sigma: float = 0.01,
                      clip: float = 0.02, rng=None) -> np.ndarray:
    jitter = np.clip(sigma * _rng(rng).randn(*pointcloud.shape),
                     -clip, clip)
    return (pointcloud + jitter).astype(pointcloud.dtype)


def rotate_pointcloud(pointcloud: np.ndarray, rng=None) -> np.ndarray:
    theta = np.pi * 2 * _rng(rng).uniform()
    R = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    out = pointcloud.copy()
    out[:, [0, 2]] = pointcloud[:, [0, 2]] @ R
    return out
