"""partner_tpu_torch rotated IoU, NMS and decode against the JAX package
(CPU, f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _trig(b):
    return np.stack([np.cos(b[..., 4]), np.sin(b[..., 4])], -1)


def _pairs(rng, n=400):
    """Random box pairs plus the degenerate cases: identical boxes, a
    shared edge, a corner touch and a box contained in the other."""
    a = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                        rng.uniform(0.5, 4, (n, 2)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    b = a + np.concatenate([rng.normal(0, 1.0, (n, 2)),
                            rng.normal(0, 0.5, (n, 2)),
                            rng.normal(0, 0.6, (n, 1))], 1)
    b[:, 2:4] = np.abs(b[:, 2:4]) + 0.1
    sq = np.array([0.0, 0.0, 2.0, 1.0, 0.3])
    shifted = sq + np.array([2.0 * np.cos(0.3), 2.0 * np.sin(0.3), 0, 0, 0])
    corner = np.array([2.0, 1.0, 2.0, 1.0, 0.0])
    inner = np.array([0.1, 0.05, 0.5, 0.4, 0.3])
    extra_a = np.stack([sq, sq, np.array([0, 0, 2.0, 1.0, 0]), sq])
    extra_b = np.stack([sq, shifted, corner, inner])
    return (np.concatenate([a, extra_a]).astype(np.float32),
            np.concatenate([b, extra_b]).astype(np.float32))


def test_green_pretrig_area_matches_jax(rng):
    from partner_tpu.ops import rotated_iou as jri
    from partner_tpu_torch.ops import rotated_iou as tri

    a, b = _pairs(rng)
    ref = np.asarray(jri.rect_intersection_area_green_pretrig(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(_trig(a)),
        jnp.asarray(_trig(b))))
    out = tri.rect_intersection_area_green_pretrig(
        *(torch.from_numpy(x) for x in (a, b, _trig(a), _trig(b)))).numpy()
    # ~300 f32 operations per pair on areas up to 16 m^2
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # degenerate cases are exact: identical, shared edge, corner, inside
    np.testing.assert_allclose(out[-4:], [2.0, 0.0, 0.0, 0.2], atol=1e-5)


def _scene(rng, n=300, ties=False):
    """Clustered (N, 7) boxes so suppression chains form; scores may tie."""
    centers = rng.uniform(-30, 30, (12, 2))
    c = centers[rng.randint(0, 12, n)] + rng.normal(0, 0.8, (n, 2))
    boxes = np.concatenate([c, rng.normal(0, 1, (n, 1)),
                            rng.uniform(1.5, 5, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    scores = rng.rand(n)
    if ties:
        scores = np.round(scores * 8) / 8
    scores[rng.rand(n) < 0.1] = -np.inf  # masked candidates
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("pre,post", [(200, 50), (512, 400)])
def test_rotate_nms_pcdet_keeps_same_indices(rng, ties, pre, post):
    from partner_tpu.ops.nms import rotate_nms_pcdet as jnms
    from partner_tpu_torch.ops.nms import rotate_nms_pcdet

    boxes, scores = _scene(rng, ties=ties)
    ref_idx, ref_mask = jnms(jnp.asarray(boxes), jnp.asarray(scores), 0.3,
                             pre, post)
    idx, mask = rotate_nms_pcdet(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), 0.3, pre, post)
    assert int(mask.sum()) > 5
    # kept indices and their order are exact
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_center_coder_decode_matches_jax(rng):
    from partner_tpu.core.center_coder import CenterCoder as JCoder
    from partner_tpu_torch.core.center_coder import CenterCoder

    preds = rng.randn(2, 50, 8).astype(np.float32) * 3
    for rectify in (False, True):
        ref = np.asarray(JCoder(rectify=rectify).decode(jnp.asarray(preds)))
        out = CenterCoder(rectify=rectify).decode(torch.from_numpy(preds))
        # elementwise exp/atan2 in f32
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
