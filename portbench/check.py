"""The numbers that decide ``correct`` in a serve cell, each against the
plain reference (``reference/``), which follows the program stage by
stage from the program's own input to each stage:

- ``rel_err.<stage>``: what a stage of the timed path produced for a
  checked frame (the voxelizer's means, coordinates and mask, the sparse
  backbone's BEV map, the re-alignment's, the neck's, the head's output
  maps) against the float32 reference's same stage run on the same
  input, weights and configuration: the largest ``||got - want|| /
  ||want||`` over the stage's outputs and the checked frames. The first
  stage's input is the sweep itself.
- ``det_mismatch``: the detections the timed path returned to the host
  (boxes, scores, labels, kept mask) against the reference's decode + NMS
  of the program's own head maps of that frame: kept detections of
  either side that find no equal on the other.
- ``sites_dropped``: the active sites of the checked frames' voxels that
  the sparse backbone's capacities (the configuration's ``caps``) hold no
  room for. spconv keeps every site; the port's gather-matmul keeps the
  first ``cap`` of a stage and drops the rest, and the reference, with
  the same capacities, drops the same, so the stage comparison would not
  see it.

A whole-frame comparison would compound each stage's rounding through the
SetBlock's keypoint choice, so that a precision and its next one down
read alike; stage by stage they stay apart. Each limit is in the
configuration's file (``limits``); ``PERF.md`` gives the readings it was
set from."""

import torch

SCORE_TOL = (1e-6, 1e-5)     # absolute, relative
BOX_TOL = (1e-5, 1e-5)       # metres / radians, relative


def flat_maps(tree, prefix=""):
    """{"a.b.0.c": tensor} of a nest of dicts and lists of tensors."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flat_maps(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def rel_err(got, want):
    """max over the tensors of two nests of ||got - want|| / ||want||, in
    float64; inf where the nests or shapes differ or ``got`` is not
    finite."""
    g, w = flat_maps(got), flat_maps(want)
    if set(g) != set(w):
        return float("inf")
    worst = 0.0
    for k in w:
        a, b = g[k].double(), w[k].double().to(g[k].device)
        if a.shape != b.shape or not torch.isfinite(a).all():
            return float("inf")
        den = b.norm()
        worst = max(worst, float((a - b).norm() / den) if den > 0
                    else float((a - b).norm()))
    return worst


def _kept(det, b):
    m = det["mask"][b].bool()
    return (det["box3d_lidar"][b][m].double(), det["scores"][b][m].double(),
            det["label_preds"][b][m].long())


def det_mismatch(got, want):
    """Kept detections of ``got`` with no equal kept detection in ``want``
    (same label, score and box within ``SCORE_TOL`` and ``BOX_TOL``), plus
    those of ``want`` with none in ``got``, summed over the batch."""
    total = 0
    for b in range(want["mask"].shape[0]):
        gb, gs, gl = _kept({k: v.cpu() for k, v in got.items()}, b)
        wb, ws, wl = _kept({k: v.cpu() for k, v in want.items()}, b)
        if len(gb) == 0 or len(wb) == 0:
            total += len(gb) + len(wb)
            continue
        same = (gl[:, None] == wl[None, :]) & (
            (gs[:, None] - ws[None, :]).abs()
            <= SCORE_TOL[0] + SCORE_TOL[1] * ws.abs()[None, :])
        tol = BOX_TOL[0] + BOX_TOL[1] * wb.abs()[None, :, :]
        same &= ((gb[:, None, :] - wb[None, :, :]).abs() <= tol).all(-1)
        total += int((~same.any(1)).sum()) + int((~same.any(0)).sum())
    return total


def sites_dropped(backbone, voxels, grid):
    """Active sites that the sparse backbone ``backbone`` (the reference's,
    with the configuration's ``caps``) would keep no room for, summed over
    its strided stages, for one batch of voxels ({"coords",
    "voxel_mask"}) of grid ``grid``: each stage's sites counted without a
    capacity, less its capacity where they exceed it. Each stage's sites
    are counted from the previous stage's full set."""
    from .reference.ptt.models import sparse
    from .reference.ptt.models.backbone import sort_rows

    coords, mask = voxels["coords"], voxels["voxel_mask"]
    shape = backbone.sparse_shape(grid)
    _, coords, mask = sort_rows(coords, coords, mask, shape)
    n, total = coords.shape[1], 0
    stages = (("conv2", 1), ("conv3", 2), ("conv4", 3), ("extra_conv", 3))
    for name, k in stages:
        st = getattr(backbone, name)
        geom = (st.kernel, st.stride, st.padding)
        coords, mask = sparse.downsample_coords(coords, mask, shape, *geom,
                                                8 * coords.shape[1])
        sites = int(mask.sum(1).max())
        total += max(0, sites - (backbone.caps[k] or n))
        # the sites come first, in order of cell id
        coords, mask = coords[:, :sites], mask[:, :sites]
        shape = sparse.strided_out_shape(shape, *geom)
    return total
