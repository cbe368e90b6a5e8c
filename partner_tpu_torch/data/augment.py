"""Global augmentations and the BEV box collision test (host numpy).

Counterpart of ``partner_tpu/data/augment.py:17-112``. Boxes are
``[x, y, z, dx, dy, dz, (vx, vy,) yaw]``: flips negate an axis and reflect
yaw, rotation turns centers and velocities and offsets yaw, scaling scales
every column but yaw (velocities included). Each function draws from the
``np.random.RandomState`` it is given, in the JAX package's order, so the
same seed gives the same boxes and points in both packages.

``box_collision_test`` is the JAX package's numpy body
(``box_collision_test_np``); its native C++ twin is not ported.
"""

import numpy as np

from ..core import box_np_ops


def random_flip_both(gt_boxes, points, probability=0.5, *, rng):
    if rng.random() < probability:  # x-axis flip (y = -y)
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + np.pi
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    if rng.random() < probability:  # y-axis flip (x = -x)
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        points[:, 0] = -points[:, 0]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + 2 * np.pi
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 6] = -gt_boxes[:, 6]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rotation=np.pi / 4, *, rng):
    if not isinstance(rotation, (list, tuple, np.ndarray)):
        rotation = [-rotation, rotation]
    noise = rng.uniform(rotation[0], rotation[1])
    points[:, :3] = box_np_ops.rotation_points_single_angle(
        points[:, :3], noise, axis=2)
    gt_boxes[:, :3] = box_np_ops.rotation_points_single_angle(
        gt_boxes[:, :3], noise, axis=2)
    if gt_boxes.shape[1] > 7:
        vel3 = np.concatenate(
            [gt_boxes[:, 6:8], np.zeros((len(gt_boxes), 1))], axis=1)
        gt_boxes[:, 6:8] = box_np_ops.rotation_points_single_angle(
            vel3, noise, axis=2)[:, :2]
    gt_boxes[:, -1] += noise
    return gt_boxes, points


def global_scaling(gt_boxes, points, min_scale=0.95, max_scale=1.05, *, rng):
    s = rng.uniform(min_scale, max_scale)
    points[:, :3] *= s
    gt_boxes[:, :-1] *= s
    return gt_boxes, points


def global_translate(gt_boxes, points, noise_translate_std=0.0, *, rng):
    std = np.broadcast_to(np.asarray(noise_translate_std, np.float64), (3,))
    if np.all(std == 0):
        return gt_boxes, points
    t = np.array([rng.normal(0, s) if s > 0 else 0.0 for s in std])
    points[:, :3] += t
    gt_boxes[:, :3] += t
    return gt_boxes, points


def box_collision_test(corners_a, corners_b):
    """Rectangle overlap by separating axes: corners_a (N, 4, 2),
    corners_b (K, 4, 2) -> bool (N, K), True where they overlap."""
    n, k = len(corners_a), len(corners_b)
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=bool)

    def edge_normals(c):
        e = np.roll(c, -1, axis=1) - c  # (M, 4, 2)
        return np.stack([-e[..., 1], e[..., 0]], axis=-1)

    axes = np.concatenate(
        [np.repeat(edge_normals(corners_a)[:, None], k, 1),
         np.repeat(edge_normals(corners_b)[None], n, 0)], axis=2
    )  # (N, K, 8, 2)

    pa = np.einsum("nkea,npa->nkep", axes, corners_a)  # (N, K, 8, 4)
    pb = np.einsum("nkea,kpa->nkep", axes, corners_b)

    sep = (pa.max(-1) < pb.min(-1) - 1e-9) | (pb.max(-1) < pa.min(-1) - 1e-9)
    return ~sep.any(-1)
