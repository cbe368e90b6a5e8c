"""Greedy rotated NMS, plain PyTorch (counterpart of
``rotated_nms``, ``_greedy_keep_upper`` and ``rotate_nms_pcdet`` in
``partner_tpu/ops/nms.py``, which are plain XLA there too).

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


def _greedy_keep_upper(sup_u, valid):
    """kept[i] = valid[i] & no kept j < i suppresses i, for a strictly
    upper-triangular sup_u[j, i]: a Jacobi fixpoint that converges to the
    sequential greedy answer in suppression-chain-depth sweeps."""
    kept = valid
    for _ in range(sup_u.shape[0]):
        new = valid & ~(sup_u & kept[:, None]).any(0)
        if torch.equal(new, kept):
            break
        kept = new
    return kept


def rotated_nms(boxes, scores, iou_threshold, post_max_size):
    """boxes (N, 5) [x, y, dx, dy, yaw], scores (N,); rows with a score
    <= NEG_INF are padding. Returns (keep_idx (K,) int64 indices into the
    input, keep_mask (K,) bool), K = post_max_size."""
    n = boxes.shape[0]
    s = torch.where(torch.isfinite(scores), scores,
                    torch.full_like(scores, NEG_INF))
    order = torch.argsort(-s, stable=True)
    b = boxes[order]
    valid = s[order] > NEG_INF / 2
    trig = torch.stack([torch.cos(b[:, 4]), torch.sin(b[:, 4])], -1)
    area = b[:, 2] * b[:, 3]
    ids = torch.arange(n, device=boxes.device)
    sup_u = torch.zeros((n, n), dtype=torch.bool, device=boxes.device)
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
