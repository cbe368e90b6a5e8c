"""Greedy rotated NMS and circle NMS, plain PyTorch (counterpart of
``rotated_nms``, ``_greedy_keep_upper``, ``rotate_nms_pcdet``,
``batched_rotated_nms`` and ``circle_nms`` in ``partner_tpu/ops/nms.py``,
which are plain XLA there too).

Matrix form: sort by score, build the strictly upper-triangular
suppression matrix of the score-sorted boxes in row blocks (bounded memory
at N = 2048), resolve the greedy recurrence as a fixpoint, then take the
kept boxes first in score order. Every sort is stable and every top-k
breaks ties toward the lower index, as in JAX.
"""

import torch

from .rotated_iou import rect_intersection_area_green_pretrig

NEG_INF = -1e9
ROW_BLOCK = 256
# fixpoint sweeps run by :func:`_greedy_keep_upper` since the caller last
# set it to 0 (a frame's NMS cost in host reads; chip_smoke.py reads it)
sweeps = 0


def _greedy_keep_upper(sup_u, valid):
    """kept[i] = valid[i] & no kept j < i suppresses i, for a strictly
    upper-triangular sup_u[j, i]: a Jacobi fixpoint that converges to the
    sequential greedy answer in suppression-chain-depth sweeps, each ending
    in a host read."""
    global sweeps
    kept = valid
    for _ in range(sup_u.shape[0]):
        new = valid & ~(sup_u & kept[:, None]).any(0)
        sweeps += 1
        if torch.equal(new, kept):
            break
        kept = new
    return kept


def suppression_matrix(b, valid, iou_threshold):
    """Score-sorted boxes b (N, 5) and their validity (N,) -> the strictly
    upper-triangular (N, N) bool sup_u[j, i]: valid j < i overlaps valid i
    above ``iou_threshold`` (rotated BEV IoU), built in row blocks of
    ROW_BLOCK suppressees against the columns before them."""
    n = b.shape[0]
    trig = torch.stack([torch.cos(b[:, 4]), torch.sin(b[:, 4])], -1)
    area = b[:, 2] * b[:, 3]
    ids = torch.arange(n, device=b.device)
    sup_u = torch.zeros((n, n), dtype=torch.bool, device=b.device)
    for r0 in range(0, n, ROW_BLOCK):
        # rows r0..r1 are the suppressees; only lower-index (higher-score)
        # columns can suppress them
        r1 = min(r0 + ROW_BLOCK, n)
        inter = rect_intersection_area_green_pretrig(
            b[r0:r1, None, :], b[None, :r1, :],
            trig[r0:r1, None, :], trig[None, :r1, :])
        union = torch.clamp(area[r0:r1, None] + area[None, :r1] - inter,
                            min=1e-8)
        blk = (inter / union > iou_threshold) & (
            ids[None, :r1] < ids[r0:r1, None])
        sup_u[:r1, r0:r1] = blk.T
    sup_u &= valid[:, None] & valid[None, :]
    return sup_u


def sort_by_score(boxes, scores):
    """-> (the stable descending score order, the boxes in it, their
    validity: a finite score above NEG_INF / 2)."""
    s = torch.where(torch.isfinite(scores), scores,
                    torch.full_like(scores, NEG_INF))
    order = torch.argsort(-s, stable=True)
    return order, boxes[order], s[order] > NEG_INF / 2


def rotated_nms(boxes, scores, iou_threshold, post_max_size):
    """boxes (N, 5) [x, y, dx, dy, yaw], scores (N,); rows with a score
    <= NEG_INF are padding. Returns (keep_idx (K,) int64 indices into the
    input, keep_mask (K,) bool), K = post_max_size."""
    order, b, valid = sort_by_score(boxes, scores)
    kept = _greedy_keep_upper(suppression_matrix(b, valid, iou_threshold),
                              valid)
    pick = torch.argsort((~kept).to(torch.uint8), stable=True)[:post_max_size]
    return order[pick], kept[pick]


def circle_nms(centers, scores, min_radius, post_max_size):
    """Greedy center-distance NMS: a box is suppressed by a kept box of a
    higher score (ties: the lower index) whose center lies within it.
    As the reference's kernel, the SQUARED distance is compared with
    ``min_radius`` (so the radius is sqrt(min_radius)). centers (N, 2),
    scores (N,) (padding rows at <= NEG_INF) -> (keep_idx (K,), keep_mask
    (K,)), K = post_max_size, the kept first in score order."""
    order, c, valid = sort_by_score(centers, scores)
    n = c.shape[0]
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    ids = torch.arange(n, device=c.device)
    sup_u = ((d2 <= min_radius) & valid[:, None] & valid[None, :]
             & (ids[:, None] < ids[None, :]))
    kept = _greedy_keep_upper(sup_u, valid)
    pick = torch.argsort((~kept).to(torch.uint8), stable=True)[:post_max_size]
    return order[pick], kept[pick]


def topk_lower_index_first(x, k):
    """(values, indices) of the k largest of a 1-D tensor, ties to the
    lower index (the ``jax.lax.top_k`` rule)."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


def rotate_nms_pcdet(boxes, scores, iou_threshold, pre_max_size,
                     post_max_size):
    """Top-k prefilter + greedy NMS. boxes (N, 7) [x, y, z, dx, dy, dz,
    yaw] (BEV dims only); returns (keep_idx (post,), keep_mask (post,))
    with indices into the input."""
    k = min(pre_max_size, boxes.shape[0])
    top_scores, top_idx = topk_lower_index_first(scores, k)
    bev = boxes[top_idx][:, [0, 1, 3, 4, 6]]
    keep, kmask = rotated_nms(bev, top_scores, iou_threshold, post_max_size)
    return top_idx[keep], kmask


def batched_rotated_nms(boxes, scores, labels, iou_threshold,
                        post_max_size):
    """Per-class greedy NMS by the coordinate-offset trick, as JAX writes
    it: each box's x is shifted by label x 2 x extent (float32), the
    extent max |x, y| + max (dx, dy) + 1 taken over all N rows, padding
    included, so boxes of two classes never overlap; then
    :func:`rotated_nms` over every row. boxes (N, 5) [x, y, dx, dy, yaw],
    labels (N,) int."""
    return rotated_nms(class_shifted(boxes, labels), scores, iou_threshold,
                       post_max_size)


def class_shifted(boxes, labels):
    """The boxes of :func:`batched_rotated_nms`, each class's shifted apart
    along x."""
    extent = (boxes[:, :2].abs().max() + boxes[:, 2:4].max()) + 1.0
    shifted = boxes.clone()
    shifted[:, 0] = boxes[:, 0] + labels.to(boxes.dtype) * 2 * extent
    return shifted
