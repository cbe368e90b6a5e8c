"""Training targets (numpy, host side): the center heatmaps and
regression targets of ``CenterTargetAssigner`` on polar and cartesian
grids, and the E2E head's vote map.

Counterpart of ``partner_tpu/core/targets.py``. The port cannot import that
module: ``partner_tpu/core/__init__.py`` imports ``geometry.py``, which
imports jax. ``tests/test_torch_losses.py`` pins ``draw_votemap`` and
``tests/test_torch_train_data.py`` the assigner against the JAX package.

Grid layout: BEV maps are (azimuth, range); the flattened cell index is
``az * n_r + r``.
"""

import numpy as np

from . import box_np_ops


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


def draw_gaussian(heatmap, center, radius, k=1.0):
    """Splat a gaussian peak into heatmap (H, W) at integer center (x, y):
    x indexes axis 1, y axis 0 (``targets.py:58-76``)."""
    diameter = 2 * radius + 1
    gaussian = gaussian_2d((diameter, diameter), sigma=diameter / 6)
    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)
    if right <= -left or bottom <= -top:
        return heatmap
    masked_hm = heatmap[y - top : y + bottom, x - left : x + right]
    masked_g = gaussian[radius - top : radius + bottom,
                        radius - left : radius + right]
    if min(masked_g.shape) > 0 and min(masked_hm.shape) > 0:
        np.maximum(masked_hm, masked_g * k, out=masked_hm)
    return heatmap


def det3d_corner_box2d(gt_boxes):
    """(N, 4, 2) BEV corners in the reference's chirality: det3d rotates
    clockwise for a positive yaw, so the angle is negated
    (``targets.py:79-91``)."""
    return box_np_ops.center_to_corner_box2d(
        gt_boxes[:, :2], gt_boxes[:, 3:5], angles=-gt_boxes[:, 6])


def polar_box_extents(gt_boxes):
    """(min_rho, max_rho, min_phi, max_phi) of the BEV corners, each (N,)."""
    corners = det3d_corner_box2d(gt_boxes)
    rhos = np.linalg.norm(corners, axis=-1)
    phis = np.arctan2(corners[:, :, 1], corners[:, :, 0])
    return rhos.min(1), rhos.max(1), phis.min(1), phis.max(1)


class CenterTargetAssigner:
    """Per-task heatmap and regression targets (``targets.py:106-270``).

    ``assign`` gives, per task:
      hm:       (num_cls, n_az, n_r)   float32 gaussian heatmaps
      anno_box: (max_objs, 10)         [dx_c, dy_c, z, log dims(3), vx, vy,
                                        sin yaw, cos yaw]
      ind:      (max_objs,)            flattened az * n_r + r cell index
      mask:     (max_objs,)            valid-object mask
      cat:      (max_objs,)            class id within the task
    """

    def __init__(self, tasks, out_size_factor, gaussian_overlap=0.1,
                 max_objs=500, min_radius=2, voxel_shape="cylinder",
                 rectify=False):
        self.tasks = tasks
        self.out_size_factor = out_size_factor
        self.gaussian_overlap = gaussian_overlap
        self.max_objs = max_objs
        self.min_radius = min_radius
        self.voxel_shape = voxel_shape
        self.rectify = rectify

    def split_tasks(self, gt_boxes, gt_classes):
        """Split global (1-based class ids) annotations by task, the yaw
        wrapped into [-pi, pi)."""
        out = []
        flag = 0
        for task in self.tasks:
            n_cls = len(task["class_names"])
            m = (gt_classes >= flag + 1) & (gt_classes <= flag + n_cls)
            boxes = gt_boxes[m]
            if boxes.shape[0]:
                boxes = boxes.copy()
                boxes[:, -1] = box_np_ops.limit_period(
                    boxes[:, -1], offset=0.5, period=2 * np.pi)
            out.append((boxes, gt_classes[m] - flag))
            flag += n_cls
        return out

    def assign(self, gt_boxes, gt_classes, grid_size, voxel_size, pc_range):
        """gt_boxes: (M, 7+) with yaw last; gt_classes: (M,), 1-based."""
        n_r = int(grid_size[0]) // self.out_size_factor
        n_az = int(grid_size[1]) // self.out_size_factor
        fmap = (n_r, n_az)

        hms, anno_boxs, inds, masks, cats = [], [], [], [], []
        for (task_boxes, task_classes), task in zip(
                self.split_tasks(gt_boxes, gt_classes), self.tasks):
            num_cls = len(task["class_names"])
            hm = np.zeros((num_cls, n_az, n_r), dtype=np.float32)
            anno = np.zeros((self.max_objs, 10), dtype=np.float32)
            ind = np.zeros((self.max_objs,), dtype=np.int64)
            mask = np.zeros((self.max_objs,), dtype=np.uint8)
            cat = np.zeros((self.max_objs,), dtype=np.int64)

            num_objs = min(task_boxes.shape[0], self.max_objs)
            if num_objs:
                assign = (self._assign_polar if self.voxel_shape == "cylinder"
                          else self._assign_cart)
                assign(hm, anno, ind, mask, cat, task_boxes[:num_objs],
                       task_classes[:num_objs], voxel_size, pc_range, fmap)
            hms.append(hm)
            anno_boxs.append(anno)
            inds.append(ind)
            masks.append(mask)
            cats.append(cat)
        return {"hm": hms, "anno_box": anno_boxs, "ind": inds, "mask": masks,
                "cat": cats}

    @staticmethod
    def _box_vel_rot(box):
        """(vx, vy, yaw) of a box with (9+ columns) or without velocity."""
        if box.shape[0] >= 9:
            return box[6], box[7], box[-1]
        return 0.0, 0.0, box[-1]

    def _assign_cart(self, hm, anno, ind, mask, cat, boxes, classes,
                     voxel_size, pc_range, fmap):
        """Cartesian grid (``targets.py:186-215``)."""
        osf = self.out_size_factor
        ws = boxes[:, 3] / voxel_size[0] / osf
        ls = boxes[:, 4] / voxel_size[1] / osf
        for k in range(boxes.shape[0]):
            w, l = ws[k], ls[k]
            if w <= 0 or l <= 0:
                continue
            radius = gaussian_radius((l, w), min_overlap=self.gaussian_overlap)
            radius = max(self.min_radius, int(radius))
            x, y, z = boxes[k, 0], boxes[k, 1], boxes[k, 2]
            coor_x = (x - pc_range[0]) / voxel_size[0] / osf
            coor_y = (y - pc_range[1]) / voxel_size[1] / osf
            ct = np.array([coor_x, coor_y], dtype=np.float32)
            ct_int = ct.astype(np.int32)
            if not (0 <= ct_int[0] < fmap[0] and 0 <= ct_int[1] < fmap[1]):
                continue
            cls_id = int(classes[k]) - 1
            draw_gaussian(hm[cls_id], ct, radius)
            cat[k] = cls_id
            ind[k] = ct_int[1] * fmap[0] + ct_int[0]
            mask[k] = 1
            vx, vy, rot = self._box_vel_rot(boxes[k])
            anno[k] = np.concatenate([
                ct - ct_int, [z], np.log(boxes[k, 3:6]),
                [vx, vy, np.sin(rot), np.cos(rot)],
            ])

    def _assign_polar(self, hm, anno, ind, mask, cat, boxes, classes,
                      voxel_size, pc_range, fmap):
        """Polar grid (``targets.py:217-270``): the (x, y) target is the
        cartesian offset from the cell corner (no +0.5 shift), and the
        radius shrinks by one beyond 30 m."""
        osf = self.out_size_factor
        min_rho, max_rho, min_phi, max_phi = polar_box_extents(boxes)
        drs = (max_rho - min_rho) / voxel_size[0] / osf
        das = (max_phi - min_phi) / voxel_size[1] / osf
        crs = np.linalg.norm(boxes[:, :2], axis=-1)
        cas = np.arctan2(boxes[:, 1], boxes[:, 0])

        for k in range(boxes.shape[0]):
            dr, da = drs[k], das[k]
            if dr <= 0 or da <= 0:
                continue
            r, a, z = crs[k], cas[k], boxes[k, 2]
            radius = gaussian_radius((dr, da), min_overlap=self.gaussian_overlap)
            radius = max(self.min_radius, int(radius) - int(r > 30))
            coor_r = (r - pc_range[0]) / voxel_size[0] / osf
            coor_a = (a - pc_range[1]) / voxel_size[1] / osf
            ct = np.array([coor_r, coor_a], dtype=np.float32)
            ct_int = ct.astype(np.int32)
            ct_int[1] = np.clip(ct_int[1], 0, fmap[1] - 1)
            if not (0 <= ct_int[0] < fmap[0]):
                continue
            cls_id = int(classes[k]) - 1
            draw_gaussian(hm[cls_id], ct, radius)

            r_real = ct_int[0] * osf * voxel_size[0] + pc_range[0]
            a_real = ct_int[1] * osf * voxel_size[1] + pc_range[1]
            cx, cy = r_real * np.cos(a_real), r_real * np.sin(a_real)

            cat[k] = cls_id
            ind[k] = ct_int[1] * fmap[0] + ct_int[0]
            mask[k] = 1

            vx, vy, rot = self._box_vel_rot(boxes[k])
            if self.rectify:
                rot = rot - cas[k]
                vr = np.sqrt(vx * vx + vy * vy)
                va = np.arctan2(vy, vx) - cas[k]
                vx, vy = vr * np.cos(va), vr * np.sin(va)
            anno[k] = np.concatenate([
                boxes[k, :2] - (cx, cy), [z], np.log(boxes[k, 3:6]),
                [vx, vy, np.sin(rot), np.cos(rot)],
            ])


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
