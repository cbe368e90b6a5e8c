"""The E2E head's vote-map target (numpy, host side).

Counterpart of ``draw_votemap`` in ``partner_tpu/core/targets.py:273-343``
and of what it reads there and in ``partner_tpu/core/box_np_ops.py``. The
port cannot import that module: ``partner_tpu/core/__init__.py`` imports
``geometry.py``, which imports jax. ``tests/test_torch_losses.py`` pins this
copy against the JAX package's function.

Grid layout: BEV maps are (azimuth, range); the flattened cell index is
``az * n_r + r``.
"""

import numpy as np


def gaussian_radius(det_size, min_overlap=0.5):
    """CornerNet-style radius (``targets.py:26-47``)."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * c1)) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 16 * c2)) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def gaussian_2d(shape, sigma=1.0):
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def det3d_corner_box2d(gt_boxes):
    """(N, 4, 2) BEV corners in the reference's chirality: det3d rotates
    clockwise for a positive yaw, so the angle is negated
    (``targets.py:79-91``, ``box_np_ops.py:25-74``)."""
    dims = gt_boxes[:, 3:5]
    corners = np.stack(np.unravel_index(np.arange(4), [2, 2]),
                       axis=1).astype(dims.dtype)[[0, 1, 3, 2]] - 0.5
    corners = dims.reshape(-1, 1, 2) * corners.reshape(1, 4, 2)
    angles = -gt_boxes[:, 6]
    c, s = np.cos(angles), np.sin(angles)
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
    return (np.einsum("npi,nij->npj", corners, rot)
            + gt_boxes[:, :2].reshape(-1, 1, 2))


def polar_box_extents(gt_boxes):
    """(min_rho, max_rho, min_phi, max_phi) of the BEV corners, each (N,)."""
    corners = det3d_corner_box2d(gt_boxes)
    rhos = np.linalg.norm(corners, axis=-1)
    phis = np.arctan2(corners[:, :, 1], corners[:, :, 0])
    return rhos.min(1), rhos.max(1), phis.min(1), phis.max(1)


def draw_votemap(gt_boxes, gt_classes, num_classes, grid_size, voxel_size,
                 pc_range, feature_map_stride=8, gaussian_overlap=0.1,
                 num_max_objs=500):
    """Vote map for the E2E head: (n_az, n_r, 4 + num_classes) float32.

    Channels 0:4 carry the owning box's center [x, y, rho, phi] over a hard
    rectangular window; 4: carry per-class gaussians with separate rho/phi
    radii, with the azimuth span truncated for near-origin boxes whose
    corners wrap around +-pi. ``gt_classes`` are 0-based within-task ids;
    ``voxel_size`` is unused (the cell size comes from the range and grid),
    as in the JAX package.
    """
    n_r = int(grid_size[0]) // feature_map_stride
    n_az = int(grid_size[1]) // feature_map_stride
    votemap = np.zeros((n_az, n_r, 4 + num_classes), dtype=np.float32)
    if gt_boxes.shape[0] == 0:
        return votemap

    min_rho, max_rho, min_phi, max_phi = polar_box_extents(gt_boxes)
    vs_r = (pc_range[3] - pc_range[0]) / grid_size[0]
    vs_a = (pc_range[4] - pc_range[1]) / grid_size[1]
    drho = (max_rho - min_rho) / vs_r / feature_map_stride
    dphi = (max_phi - min_phi) / vs_a / feature_map_stride

    crho = np.linalg.norm(gt_boxes[:, :2], axis=-1)
    cphi = np.arctan2(gt_boxes[:, 1], gt_boxes[:, 0])
    centers = np.stack([gt_boxes[:, 0], gt_boxes[:, 1], crho, cphi], axis=-1)
    r_ind = ((crho - pc_range[0]) / vs_r / feature_map_stride).astype(np.int32)
    a_ind = ((cphi - pc_range[1]) / vs_a / feature_map_stride).astype(np.int32)

    corners = det3d_corner_box2d(gt_boxes)
    corner_phis = np.arctan2(corners[:, :, 1], corners[:, :, 0])

    for k in range(min(num_max_objs, gt_boxes.shape[0])):
        if drho[k] <= 0 or dphi[k] <= 0:
            continue
        if not (0 <= r_ind[k] < n_r and 0 <= a_ind[k] < n_az):
            continue
        dphi_k = dphi[k]
        if dphi_k > n_az / 4:  # box spans the +-pi seam: truncate azimuth span
            phis_k = corner_phis[k]
            if cphi[k] > 0:
                trunc = np.pi - phis_k[phis_k > 0].min()
            else:
                trunc = phis_k[phis_k <= 0].max() + np.pi
            dphi_k = trunc / vs_a / feature_map_stride

        radius_rho = int(gaussian_radius((drho[k], drho[k]), gaussian_overlap))
        radius_phi = int(gaussian_radius((dphi_k, dphi_k), gaussian_overlap))
        r0, a0 = int(r_ind[k]), int(a_ind[k])

        left, right = min(r0, radius_rho), min(n_r - r0, radius_rho + 1)
        top, bottom = min(a0, radius_phi), min(n_az - a0, radius_phi + 1)
        votemap[a0 - top : a0 + bottom, r0 - left : r0 + right, :4] = centers[k]

        diam_r, diam_a = 2 * radius_rho + 1, 2 * radius_phi + 1
        g = gaussian_2d((diam_a, diam_r), sigma=max(diam_r, diam_a) / 6)
        cls = 4 + int(gt_classes[k])
        win = votemap[a0 - top : a0 + bottom, r0 - left : r0 + right, cls]
        np.maximum(
            win,
            g[radius_phi - top : radius_phi + bottom,
              radius_rho - left : radius_rho + right],
            out=win,
        )
    return votemap
