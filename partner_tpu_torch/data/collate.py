"""Fixed-shape batch collation — the host->device contract.

Counterpart of ``partner_tpu/data/collate.py`` (a copy: the port cannot
import ``partner_tpu.data``, whose package imports jax). It replaces the
reference's collate_kitti (det3d/torchie/parallel/
collate.py:88-253) with a padder that emits static-shape numpy arrays the
model step consumes directly:

  points      (B, P_max, C) + points_mask (B, P_max)
              (B*4, ...) grouped [orig, yflip, xflip, xyflip] per example
              when the pipeline ran DoubleFlip TTA (reference collate nests
              the flip copies the same way, collate.py:88-253)
  points_label (B, P_max) int32, 0 = unlabeled  [seg tasks]
  voxels      (B, V, K, C) + coords/num_points/voxel_mask  [hard mode only]
  hm          list per task of (B, n_az, n_r, C)  (NHWC)
  anno_box/ind/mask/cat   list per task of (B, M, ...)
  global_box  (B, M, 8|10+1) + global_box_mask
  votemap_flat (B, n_az*n_r, 4+ncls)
  metadata    python list (host side only)
"""

import numpy as np

_FLIP_KEYS = ("yflip_points", "xflip_points", "double_flip_points")


def collate(batch_list, max_points=200000, max_voxels=None):
    ret = {}
    b = len(batch_list)
    first = batch_list[0]

    # --- points ---
    # double-flip TTA: each example contributes 4 consecutive batch rows
    # [orig, yflip, xflip, xyflip] — the grouping double_flip_average
    # de-flips (models/center_head.py:572-…; reference center_head.py:290-348)
    double_flip = all(k in first for k in _FLIP_KEYS)
    group = 4 if double_flip else 1
    c = first["points"].shape[1]
    pts = np.zeros((b * group, max_points, c), np.float32)
    pmask = np.zeros((b * group, max_points), bool)
    for i, ex in enumerate(batch_list):
        variants = ([ex["points"]] + [ex[k] for k in _FLIP_KEYS]
                    if double_flip else [ex["points"]])
        for j, p in enumerate(variants):
            p = p[:max_points]
            pts[i * group + j, : len(p)] = p
            pmask[i * group + j, : len(p)] = True
    ret["points"] = pts
    ret["points_mask"] = pmask

    # --- per-point seg labels (B, P), 0 = unlabeled; the label column the
    # Preprocess stage split off rides here so the seg loss sees the real
    # pipeline's labels (reference threads them as example['points_label'],
    # collate.py:88-253 -> seg_heads/seg_head.py:99-168) ---
    if "pc_label" in first:
        lab = np.zeros((b, max_points), np.int32)
        for i, ex in enumerate(batch_list):
            l = np.asarray(ex["pc_label"]).reshape(-1)[:max_points]
            # loading pads sweep points (no gt labels) with -1; clamp to 0
            lab[i, : len(l)] = np.maximum(l, 0).astype(np.int32)
        if double_flip:
            # flips negate coordinates but never permute point order
            # (data/pipeline.py DoubleFlip applies sign flips row-wise), so
            # each flip copy carries the same per-point labels; group-expand
            # to (B*4, P) to stay row-aligned with the (B*4, P, C) points
            # (reference collates labels once per flip copy,
            # det3d/torchie/parallel/collate.py:88-253)
            lab = np.repeat(lab, group, axis=0)
        ret["points_label"] = lab

    # --- hard voxels (optional) ---
    if "voxels" in first:
        v_shape = first["voxels"].shape[1:]
        # static cap (the configured max_voxel_num) keeps the jitted step's
        # shape stable across batches — a batch-dependent cap forces a
        # fresh XLA compile per distinct value
        cap = max_voxels or max(len(ex["voxels"]) for ex in batch_list)
        voxels = np.zeros((b, cap) + v_shape, np.float32)
        coords = np.zeros((b, cap, 3), np.int32)
        nump = np.zeros((b, cap), np.int32)
        vmask = np.zeros((b, cap), bool)
        for i, ex in enumerate(batch_list):
            n = min(len(ex["voxels"]), cap)
            voxels[i, :n] = ex["voxels"][:n]
            coords[i, :n] = ex["coordinates"][:n]
            nump[i, :n] = ex["num_points"][:n]
            vmask[i, :n] = True
        ret.update(voxels=voxels, coords=coords, num_points=nump,
                   voxel_mask=vmask)

    # --- per-task targets ---
    for key in ("hm", "anno_box", "ind", "mask", "cat"):
        if key in first:
            n_tasks = len(first[key])
            stacked = [
                np.stack([ex[key][t] for ex in batch_list])
                for t in range(n_tasks)
            ]
            if key == "hm":  # (B, C, az, r) -> NHWC
                stacked = [h.transpose(0, 2, 3, 1) for h in stacked]
            ret[key] = stacked

    if "global_box" in first:
        gb = np.stack([ex["global_box"] for ex in batch_list])
        ret["global_box"] = gb
        ret["global_box_mask"] = gb[..., -1] > 0
    if "votemap" in first:
        vm = np.stack([ex["votemap"] for ex in batch_list])
        ret["votemap_flat"] = vm.reshape(b, -1, vm.shape[-1])

    ret["metadata"] = [ex.get("metadata") for ex in batch_list]
    for key in ("grid_size", "pc_range", "voxel_size"):
        if first.get(key) is not None:
            ret[key] = np.asarray(first[key])
    return ret
