"""Host-side (numpy) box and coordinate utilities of the data pipeline.

Counterpart of the part of ``partner_tpu/core/box_np_ops.py`` that the
data pipeline reads in val and train mode (corners, rotations, range
filters, point layouts); the port cannot import that module, because
``partner_tpu/core/__init__.py`` imports jax. det3d conventions: boxes are
``[x, y, z, dx, dy, dz, (vx, vy,) yaw]`` with yaw counter-clockwise about
+z and (x, y, z) the geometric box center; 2D corners run clockwise from
the (-dx/2, -dy/2) corner.

``points_in_rbbox`` runs the port's native library where it is built
(``partner_tpu_torch/native``) and its numpy body, ``points_in_rbbox_np``,
elsewhere, as the JAX package dispatches.
"""

import numpy as np


def limit_period(val, offset=0.5, period=np.pi * 2):
    """Wrap angles into [-offset*period, (1-offset)*period)."""
    return val - np.floor(val / period + offset) * period


def corners_nd(dims, origin=0.5):
    """Relative corner offsets of N axis-aligned boxes, (N, 2**ndim, ndim);
    2D layout (x0,y0), (x0,y1), (x1,y1), (x1,y0)."""
    ndim = dims.shape[-1]
    corners_norm = np.stack(
        np.unravel_index(np.arange(2 ** ndim), [2] * ndim), axis=1
    ).astype(dims.dtype)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array(origin, dtype=dims.dtype)
    return dims.reshape(-1, 1, ndim) * corners_norm.reshape(1, 2 ** ndim, ndim)


def rotation_2d(points, angles):
    """Rotate 2D point sets (N, P, 2) by per-box angles (N,), counter-
    clockwise for a positive angle."""
    c, s = np.cos(angles), np.sin(angles)
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
    return np.einsum("npi,nij->npj", points, rot)


def rotation_3d_in_axis(points, angles, axis=2):
    """Rotate 3D point sets (N, P, 3) about a coordinate axis."""
    s, c = np.sin(angles), np.cos(angles)
    ones, zeros = np.ones_like(c), np.zeros_like(c)
    if axis == 2:
        rot_T = np.stack([c, s, zeros, -s, c, zeros, zeros, zeros, ones], -1)
    elif axis == 0:
        rot_T = np.stack([ones, zeros, zeros, zeros, c, s, zeros, -s, c], -1)
    elif axis == 1:
        rot_T = np.stack([c, zeros, -s, zeros, ones, zeros, s, zeros, c], -1)
    else:
        raise ValueError("axis must be 0, 1 or 2")
    rot_T = rot_T.reshape(angles.shape + (3, 3))
    return np.einsum("npi,nij->npj", points, rot_T)


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """BEV rotated-box corners, (N, 4, 2)."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers.reshape(-1, 1, 2)


def center_to_corner_box3d(centers, dims, angles=None,
                           origin=(0.5, 0.5, 0.5), axis=2):
    """3D box corners, (N, 8, 3)."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    return corners + centers.reshape(-1, 1, 3)


def rotation_points_single_angle(points, angle, axis=2):
    """Rotate (N, 3) points by one angle about an axis."""
    s, c = np.sin(angle), np.cos(angle)
    if axis == 2:
        rot_T = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=points.dtype)
    elif axis == 0:
        rot_T = np.array([[1, 0, 0], [0, c, s], [0, -s, c]], dtype=points.dtype)
    elif axis == 1:
        rot_T = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], dtype=points.dtype)
    else:
        raise ValueError("axis should be in range")
    return points @ rot_T


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
    """Boolean (P, N) membership of points in rotated 3D boxes: the native
    library where it is available, else :func:`points_in_rbbox_np`."""
    if len(boxes) == 0:
        return np.zeros((points.shape[0], 0), dtype=bool)
    from .. import native

    if native.available():
        return native.points_in_rbbox(points, boxes)
    return points_in_rbbox_np(points, boxes)


def points_in_rbbox_np(points, boxes):
    """The numpy body: points moved into each box frame and compared
    against its half-dims (the parity oracle)."""
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
