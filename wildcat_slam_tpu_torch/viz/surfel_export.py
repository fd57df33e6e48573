"""Surfel and point-cloud export for external viewers.

ROS-free equivalent of the reference's visualization channel (PubSurfels,
surfel_extraction.cc:360-434: surfels as covariance ellipsoids with 3-sigma
axes and normal-coded RGB, published as rviz markers; undistorted clouds on
/scan_in_imu_frame, lidar_odometry.cc:582-595). Here the same geometry is
written to PLY files any point-cloud viewer (CloudCompare, MeshLab, Open3D)
can open, or returned as plain numpy dicts for notebook plotting.

Numpy only: a copy of ``wildcat_slam_tpu/viz/surfel_export.py``, held equal
by a test. ``surfels`` is any object with ``valid`` and ``t`` arrays and
``center_world()``/``cov_world()``/``norm_world()`` methods that return numpy
arrays; the port's CLI converts its ``Surfels`` to one on the host.
"""

from __future__ import annotations

import numpy as np

def surfel_ellipsoids(surfels) -> dict:
    """Ellipsoid parameters per valid surfel: center, 3-sigma semi-axes,
    rotation (columns = axes), RGB from the world normal — the same encoding as
    PubSurfels (scale = 3 sqrt(eigenvalue), color = (n+1)/2)."""
    valid = np.asarray(surfels.valid)
    center = np.asarray(surfels.center_world())[valid]
    cov = np.asarray(surfels.cov_world())[valid]
    norm = np.asarray(surfels.norm_world())[valid]
    vals, vecs = np.linalg.eigh(cov) if cov.size else (np.zeros((0, 3)), np.zeros((0, 3, 3)))
    # right-handedness (makeRightHanded, surfel_extraction.cc:340-358)
    det = np.linalg.det(vecs) if len(vecs) else np.zeros((0,))
    flip = det < 0
    vecs[flip, :, 0] *= -1.0
    return dict(
        center=center,
        radii=3.0 * np.sqrt(np.maximum(vals, 0.0)),
        axes=vecs,
        rgb=(norm + 1.0) / 2.0,
        timestamp=np.asarray(surfels.t)[valid],
    )


def _ellipsoid_mesh(center, radii, axes, n_lat=6, n_lon=8):
    """Low-poly ellipsoid vertices + faces."""
    lat = np.linspace(0, np.pi, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    v = []
    for th in lat:
        for ph in lon:
            p = np.array([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)])
            v.append(center + axes @ (radii * p))
    v = np.asarray(v)
    f = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            f += [[a, b, c], [b, d, c]]
    return v, np.asarray(f)


def save_surfels_ply(path: str, surfels, max_surfels: int = 2000) -> int:
    """Write surfel ellipsoids as a colored triangle mesh PLY. Returns count."""
    e = surfel_ellipsoids(surfels)
    n = min(len(e["center"]), max_surfels)
    all_v, all_f, all_c = [], [], []
    base = 0
    for i in range(n):
        v, f = _ellipsoid_mesh(e["center"][i], e["radii"][i], e["axes"][i])
        all_v.append(v)
        all_f.append(f + base)
        all_c.append(np.tile((e["rgb"][i] * 255).astype(np.uint8), (len(v), 1)))
        base += len(v)
    if not all_v:
        vs = np.zeros((0, 3)); fs = np.zeros((0, 3), int); cs = np.zeros((0, 3), np.uint8)
    else:
        vs, fs, cs = np.concatenate(all_v), np.concatenate(all_f), np.concatenate(all_c)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(vs)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fh.write(f"element face {len(fs)}\nproperty list uchar int vertex_indices\nend_header\n")
        for p, c in zip(vs, cs):
            fh.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
        for tri in fs:
            fh.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
    return n


def save_cloud_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write an (N, 3) point cloud (the /scan_in_imu_frame analog) as PLY."""
    points = np.asarray(points)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(points)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            fh.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        fh.write("end_header\n")
        for i, p in enumerate(points):
            if colors is not None:
                c = colors[i]
                fh.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {int(c[0])} {int(c[1])} {int(c[2])}\n")
            else:
                fh.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
