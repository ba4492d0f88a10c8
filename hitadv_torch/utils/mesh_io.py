"""Mesh and point-cloud files: OBJ, OFF and ASC (port of
`hitadv_tpu/utils/mesh_io.py`).

Reference `FGM/GeoA3_args.py:504-747` (`write_obj`/`read_obj`,
`write_off`/`read_off`, tolerant of ModelNet's OFF header glued to its
counts) and the ``.asc`` dumps of `visual.py:63-68`. numpy only; the
surface reconstruction takes open3d when it is installed.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


def write_obj(path: str, vertices: np.ndarray,
              faces: Sequence[Sequence[int]]) -> None:
    """Triangular OBJ writer (1-based face indices)."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces, dtype=np.int64)
    assert len(vertices) > 0 and vertices.shape[1] == 3
    with open(path, "w") as fp:
        for v in vertices:
            fp.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in faces:
            assert len(f) == 3, "only triangular faces supported"
            assert (0 <= f).all() and (f < len(vertices)).all()
            fp.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
        fp.write("\n")


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read vertices and triangular faces (0-based) from an OBJ file."""
    vertices: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as fp:
        for line in fp:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                # handle "f 1", "f 1/2/3" forms; 1-based -> 0-based
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:4]]
                faces.append(idx)
    return (np.asarray(vertices, np.float32),
            np.asarray(faces, np.int64).reshape(-1, 3))


def write_off(path: str, vertices: np.ndarray,
              faces: Sequence[Sequence[int]]) -> None:
    """OFF writer; faces are (3, i, j, k) rows like the reference's."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces, dtype=np.int64)
    if faces.shape[1] == 3:                                   # accept both
        faces = np.concatenate(
            [np.full((len(faces), 1), 3, np.int64), faces], axis=1)
    with open(path, "w") as fp:
        fp.write("OFF\n")
        fp.write(f"{len(vertices)} {len(faces)} 0\n")
        for v in vertices:
            fp.write(f"{v[0]} {v[1]} {v[2]}\n")
        for f in faces:
            assert f[0] == 3, "only triangular faces supported"
            fp.write(" ".join(str(int(x)) for x in f) + "\n")
        fp.write("\n")


def read_off(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """OFF reader, tolerant of the ModelNet 'OFF123 456 0' header bug
    (counts glued to the magic on line one, `FGM/GeoA3_args.py:666-680`)."""
    with open(path) as fp:
        lines = [l.strip() for l in fp if l.strip()]
    header = lines[0]
    if header[:3].upper() == "OFF" and len(header) > 3:
        counts = header[3:].split()
        start = 1
    else:
        assert header[:3].upper() == "OFF", f"invalid OFF file {path}"
        counts = lines[1].split()
        start = 2
    num_v, num_f = int(counts[0]), int(counts[1])
    vertices = np.array(
        [[float(x) for x in lines[start + i].split()[:3]]
         for i in range(num_v)], np.float32)
    faces = []
    for i in range(num_f):
        parts = [int(x) for x in lines[start + num_v + i].split()]
        assert parts[0] == 3, "only triangular faces supported"
        faces.append(parts[1:4])
    return vertices, np.asarray(faces, np.int64)


def write_asc(path: str, points: np.ndarray) -> None:
    """xyz-per-line dump (`visual.py:63-68` format)."""
    np.savetxt(path, np.asarray(points), fmt="%.6f")


def read_asc(path: str) -> np.ndarray:
    return np.loadtxt(path).astype(np.float32)


def reconstruct_from_pc(npoint: int, output_path: str,
                        output_file_name: str, pc: np.ndarray,
                        output_type: str = "mesh", normal=None,
                        reconstruct_type: str = "PRS",
                        central_points=None):
    """Surface reconstruction of an adversarial cloud (reference
    `util/other_utils.py:104-147`: open3d's ball pivoting, ``"BPA"``, or
    Poisson, ``"PRS"``), written to ``<output_path>/<name>.obj``. Without
    open3d it writes the cloud's vertices alone there and returns None,
    as the JAX module does."""
    os.makedirs(output_path, exist_ok=True)
    out_base = os.path.join(output_path, output_file_name)
    try:
        import open3d as o3d  # an optional package
        if getattr(o3d, "__file__", None) is None:
            raise ImportError("open3d stubbed")
    except ImportError:
        # without open3d: the cloud's vertices as an OBJ, no faces
        with open(out_base + ".obj", "w") as fp:
            for v in np.asarray(pc):
                fp.write(f"v {v[0]} {v[1]} {v[2]}\n")
        return None

    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(pc)
    if normal is not None:
        pcd.normals = o3d.utility.Vector3dVector(normal)
    if reconstruct_type == "BPA":
        dists = pcd.compute_nearest_neighbor_distance()
        radius = 3 * float(np.mean(dists))
        mesh = o3d.geometry.TriangleMesh.create_from_point_cloud_ball_pivoting(
            pcd, o3d.utility.DoubleVector([radius, radius * 2]))
    else:  # PRS
        mesh = o3d.geometry.TriangleMesh.create_from_point_cloud_poisson(
            pcd=pcd, depth=9, width=0, scale=1.1, linear_fit=True,
            n_threads=-1)[0]
        mesh = mesh.crop(pcd.get_axis_aligned_bounding_box())
    o3d.io.write_triangle_mesh(out_base + ".obj", mesh)
    if output_type == "recon_pc":
        return o3d.geometry.TriangleMesh.sample_points_uniformly(
            mesh, number_of_points=npoint)
    return mesh
