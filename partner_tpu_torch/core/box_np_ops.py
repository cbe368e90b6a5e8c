"""Host-side (numpy) box and coordinate utilities of the val data path.

Counterpart of the part of ``partner_tpu/core/box_np_ops.py`` that the
data pipeline reads; the port cannot import that module, because
``partner_tpu/core/__init__.py`` imports jax. det3d conventions: boxes are
``[x, y, z, dx, dy, dz, (vx, vy,) yaw]`` with yaw counter-clockwise about
+z and (x, y, z) the geometric box center.

``points_in_rbbox`` keeps only the numpy body: the JAX package's native
host library (``partner_tpu/native/``) is not ported.
"""

import numpy as np


def limit_period(val, offset=0.5, period=np.pi * 2):
    """Wrap angles into [-offset*period, (1-offset)*period)."""
    return val - np.floor(val / period + offset) * period


def transform_points(points, voxel_shape):
    """Cartesian -> the framework's point layout:
      cylinder: [rho, phi, z, x, y, *extra]
      cuboid:   [x, y, z, *extra, rho, phi]
    """
    rho = np.sqrt(points[:, 0] ** 2 + points[:, 1] ** 2)
    phi = np.arctan2(points[:, 1], points[:, 0])
    if voxel_shape == "cylinder":
        return np.concatenate(
            [rho[:, None], phi[:, None], points[:, 2:3], points[:, :2],
             points[:, 3:]], axis=1)
    elif voxel_shape == "cuboid":
        return np.concatenate([points, rho[:, None], phi[:, None]], axis=1)
    raise ValueError(f"unknown voxel_shape {voxel_shape!r}")


def filter_gt_polar_range(gt_boxes, bv_range):
    """Validity mask of gt boxes inside a polar BEV range
    [rho_min, phi_min, rho_max, phi_max]."""
    gt_rho = np.linalg.norm(gt_boxes[:, :2], axis=1)
    gt_az = np.arctan2(gt_boxes[:, 1], gt_boxes[:, 0])
    return ((gt_rho >= bv_range[0]) & (gt_rho <= bv_range[2])
            & (gt_az >= bv_range[1]) & (gt_az <= bv_range[3]))


def filter_gt_cart_range(gt_boxes, bv_range):
    """Validity mask for a cartesian BEV range [xmin, ymin, xmax, ymax]."""
    return ((gt_boxes[:, 0] >= bv_range[0]) & (gt_boxes[:, 0] <= bv_range[2])
            & (gt_boxes[:, 1] >= bv_range[1])
            & (gt_boxes[:, 1] <= bv_range[3]))


def points_in_rbbox(points, boxes):
    """Boolean (P, N) membership of points in rotated 3D boxes: points
    moved into each box frame and compared against its half-dims."""
    if len(boxes) == 0:
        return np.zeros((points.shape[0], 0), dtype=bool)
    shift = points[:, None, :3] - boxes[None, :, :3]  # (P, N, 3)
    c, s = np.cos(boxes[:, -1]), np.sin(boxes[:, -1])
    local_x = shift[..., 0] * c[None] + shift[..., 1] * s[None]
    local_y = -shift[..., 0] * s[None] + shift[..., 1] * c[None]
    half = boxes[:, 3:6] * 0.5
    return ((np.abs(local_x) <= half[None, :, 0])
            & (np.abs(local_y) <= half[None, :, 1])
            & (np.abs(shift[..., 2]) <= half[None, :, 2]))
