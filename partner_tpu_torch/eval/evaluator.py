"""Evaluation engine: predict over a val set, then the dataset's metrics.

Counterpart of ``partner_tpu/eval/evaluator.py`` for one process on one
device: batches from the loader go through the detector's ``predict``,
the middle third of the per-batch times gives the FPS (the reference
protocol, ``evaluator.py:192-195``), the kept detections are written to
``prediction.pkl``, and ``dataset.evaluation`` computes the metrics.

Inside each timed window a batch goes host -> device, through ``predict``
and back to the host; the copy back waits for the device, as JAX's
``np.asarray`` of the outputs does there.

Not ported: the mesh-sharded eval and the per-host gather (ROADMAP.md
queue 1: DDP and mesh eval), the ``voxels`` input contract of the JAX
package's voxel-input detectors (only the point path is ported, so every
ported detector takes points), and seg / panoptic evaluation (they wait
for ``seg_head``).
"""

import os
import pickle
import time

import torch

from ..data import build_dataloader


def build_predict_fn(det, device):
    """``predict(points, points_mask)`` over numpy batches -> numpy outputs
    (the ``points`` input contract)."""

    def predict(points, pmask):
        out = det.predict({
            "points": torch.from_numpy(points).to(device),
            "points_mask": torch.from_numpy(pmask).to(device)})
        return {k: v.cpu().numpy() for k, v in out.items()}

    return predict


def init_example(dataset, device):
    """A small all-padding example of the dataset's point layout (the
    static-RPE fill reads only the fixed cell grid, not the points)."""
    # + per-point extras the loader appends, + the rho, phi decoration
    # columns of transform_points
    nf = (dataset.NumPointFeatures
          + getattr(dataset, "ExtraPointChannels", 0) + 2)
    return {"points": torch.zeros((1, 1024, nf), device=device),
            "points_mask": torch.zeros((1, 1024), dtype=torch.bool,
                                       device=device)}


def evaluate(det, dataset, work_dir, logger, device, batch_size=1,
             max_points=200000, max_frames=None, testset=False):
    """Predict over ``dataset`` and evaluate -> (result, fps)."""
    predict = build_predict_fn(det, device)
    loader = build_dataloader(dataset, batch_size, workers_per_gpu=4,
                              shuffle=False, max_points=max_points)
    detections, times = {}, []
    n_frames = 0
    for batch in loader:
        t0 = time.perf_counter()
        out = predict(batch["points"], batch["points_mask"])
        times.append(time.perf_counter() - t0)
        for i, meta in enumerate(batch["metadata"]):
            token = meta["token"] if meta else str(n_frames)
            m = out["mask"][i]
            detections[token] = {
                "box3d_lidar": out["box3d_lidar"][i][m],
                "scores": out["scores"][i][m],
                "label_preds": out["label_preds"][i][m],
                "metadata": meta,
            }
            n_frames += 1
        if max_frames and n_frames >= max_frames:
            break

    third = max(1, len(times) // 3)
    window = times[third: 2 * third] or times
    fps = batch_size * len(window) / sum(window)
    logger.info(f"frames: {n_frames}, middle-third FPS: {fps:.2f}")

    with open(os.path.join(work_dir, "prediction.pkl"), "wb") as f:
        pickle.dump(detections, f)
    result = dataset.evaluation(detections, output_dir=work_dir,
                                testset=testset)
    logger.info(f"evaluation: {result}")
    return result, fps
