"""Set-prediction matcher on the device (counterpart of
``partner_tpu/losses/matcher.py``).

Per scene, the benefit of query n for gt m is
``prob_n[class_m] ** w_ce * exp(-||w * (pred_n - enc(gt_m))||_1) ** w_bbox``.
Each gt keeps its top-C queries as candidates, and an epsilon-auction over
those lists assigns queries to gts: open gts bid for their best query at
its price, the highest bid per query wins, evicted owners reopen.

The B scenes of a batch run as one batched auction. A scene with no open
gt is left unchanged by an auction round (no bids, so no winners, prices
or evictions), which is also what the JAX package's vmapped ``while_loop``
does with it; so the loop checks on the host whether any gt is still open
only every ``check_every`` rounds, and gives the same result as checking
every round. Ties are resolved as on the JAX side: ``top_k`` and
``argmax`` take the lower index, and among equal winning bids for a query
the highest row wins (the last write of JAX's scatter in its stable,
ascending bid order).
"""

import numpy as np
import torch

NEG = -1e9


def matching_benefit(pred_logits, pred_boxes, gt_classes, gt_encoded,
                     gt_mask, code_weights, w_ce=0.25, w_bbox=0.75):
    """Benefit (B, M, N) of each query for each gt; invalid gts get NEG.

    pred_logits (B, N, ncls) raw; pred_boxes (B, N, code); gt_classes
    (B, M) 0-based; gt_encoded (B, M, code); gt_mask (B, M)."""
    prob = torch.sigmoid(pred_logits)
    wp = pred_boxes * code_weights
    l1 = (wp[:, None] - (gt_encoded * code_weights)[:, :, None]).abs().sum(-1)
    ce = torch.gather(prob.transpose(1, 2), 1,
                      gt_classes.long()[..., None].expand(-1, -1,
                                                          prob.shape[1]))
    benefit = torch.pow(ce, w_ce) * torch.pow(torch.exp(-l1), w_bbox)
    return torch.where(gt_mask[..., None], benefit,
                       torch.full_like(benefit, NEG))


def _topc_candidates(benefit, c):
    """The top-min(c, N) (values, indices) along the last axis, ties to the
    lower index as ``jax.lax.top_k``."""
    vals, idx = torch.sort(benefit, dim=-1, descending=True, stable=True)
    k = min(c, benefit.shape[-1])
    return vals[..., :k], idx[..., :k]


def auction_assign(cand_benefit, cand_idx, gt_mask, num_queries, eps=1e-4,
                   max_iters=3000, check_every=32):
    """Forward auction on candidate lists, batched over scenes.

    cand_benefit (B, M, C), cand_idx (B, M, C) query ids, gt_mask (B, M).
    Returns the assigned query id per gt (B, M), -1 where unassigned or
    invalid. Runs ``min(check_every, rounds left)`` rounds between two
    host checks of whether any gt is still open."""
    b, m, c = cand_benefit.shape
    dev = cand_benefit.device
    rows = torch.arange(m, device=dev).expand(b, m)
    dump = num_queries                 # the column non-bidders write to
    assigned = torch.full((b, m), -1, dtype=torch.long, device=dev)
    prices = torch.zeros((b, num_queries + 1), dtype=cand_benefit.dtype,
                         device=dev)
    owner = torch.full((b, num_queries + 1), -1, dtype=torch.long, device=dev)
    neg = torch.full((), NEG, dtype=cand_benefit.dtype, device=dev)
    cand_idx = cand_idx.long()
    flat_idx = cand_idx.reshape(b, m * c)

    def auction_round(assigned, prices, owner):
        open_rows = (assigned < 0) & gt_mask
        values = cand_benefit - torch.gather(prices, 1, flat_idx).reshape(
            b, m, c)
        values = torch.where(open_rows[..., None], values, neg)
        v1 = values.amax(-1)
        j1 = values.argmax(-1)         # the first index among equal maxima
        v2 = values.scatter(-1, j1[..., None], NEG).amax(-1)
        bid_col = torch.gather(cand_idx, -1, j1[..., None])[..., 0]
        bid_amt = v1 - v2 + eps
        bidding = open_rows & (v1 > NEG / 2)
        col = torch.where(bidding, bid_col, dump)
        # the winner of each column: its highest bid, and among equal
        # highest bids the highest row
        amt = torch.where(bidding, bid_amt, -torch.inf)
        win_amt = torch.full_like(prices, -torch.inf).scatter_reduce(
            1, col, amt, "amax")
        top = bidding & (amt == torch.gather(win_amt, 1, col))
        win_row = torch.full_like(owner, -1).scatter_reduce(
            1, col, torch.where(top, rows, -1), "amax")
        won = bidding & (torch.gather(win_row, 1, col) == rows)
        won_col = torch.where(won, bid_col, dump)
        # evict the previous owners of won columns, then record winners
        prev = torch.gather(owner, 1, won_col)
        evicted = torch.zeros((b, m + 1), dtype=torch.bool, device=dev)
        evicted.scatter_(1, torch.where(prev >= 0, prev, m), True)
        assigned = torch.where(evicted[:, :m], -1, assigned)
        assigned = torch.where(won, bid_col, assigned)
        owner = owner.scatter(1, won_col, torch.where(won, rows, -1))
        prices = prices.scatter_add(
            1, won_col, torch.where(won, torch.gather(win_amt, 1, won_col),
                                    0.0))
        return assigned, prices, owner

    it = 0
    while it < max_iters:
        for _ in range(min(check_every, max_iters - it)):
            assigned, prices, owner = auction_round(assigned, prices, owner)
            it += 1
        if not bool(((assigned < 0) & gt_mask).any()):
            break
    return torch.where(gt_mask, assigned, -1)


@torch.no_grad()
def assign_auction(pred_logits, pred_boxes, gt_classes, gt_encoded, gt_mask,
                   code_weights, num_candidates=32, check_every=32):
    """Batched device assignment: (B, M) matched query id per gt (-1
    invalid or unassigned)."""
    benefit = matching_benefit(pred_logits, pred_boxes, gt_classes,
                               gt_encoded, gt_mask, code_weights)
    vals, idx = _topc_candidates(benefit, num_candidates)
    return auction_assign(vals, idx, gt_mask, pred_logits.shape[1],
                          check_every=check_every)


@torch.no_grad()
def assign_scipy(pred_logits, pred_boxes, gt_classes, gt_encoded, gt_mask,
                 code_weights):
    """Exact Hungarian assignment on the host (scipy), per scene: the
    optimum the auction approximates, for tests."""
    from scipy.optimize import linear_sum_assignment

    cost = -matching_benefit(pred_logits, pred_boxes, gt_classes, gt_encoded,
                             gt_mask, code_weights).cpu().numpy()
    mask = gt_mask.cpu().numpy()
    out = np.full(mask.shape, -1, np.int64)
    for i in range(mask.shape[0]):
        valid = np.flatnonzero(mask[i])
        if valid.size:
            r, c = linear_sum_assignment(cost[i][valid])
            out[i, valid[r]] = c
    return torch.from_numpy(out).to(gt_mask.device)
