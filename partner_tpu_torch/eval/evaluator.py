"""Evaluation engine: predict over a val set, then the dataset's metrics.

Counterpart of ``partner_tpu/eval/evaluator.py`` for one process on one
device: batches from the loader go through the detector's ``predict``,
the middle third of the per-batch times gives the FPS (the reference
protocol, ``evaluator.py:192-195``), the kept detections are written to
``prediction.pkl``, and ``dataset.evaluation`` computes the metrics.

Batches reach the detector through either input contract, as in JAX:
``points`` (the point buffer as it is) or ``voxels`` (the buffer
voxelized on the device by ``ops.voxelize.dynamic_voxelize`` first, up to
``max_voxel_num`` voxels, its second entry where it is a list). Inside
each timed window a batch goes host -> device, through the voxelizer and
``predict`` and back to the host; the copy back waits for the device, as
JAX's ``np.asarray`` of the outputs does there.

Not ported: the mesh-sharded eval and the per-host gather (ROADMAP.md
queue 1: DDP and mesh eval), and seg / panoptic evaluation (they wait for
``seg_head``).
"""

import os
import pickle
import time

import torch

from ..data import build_dataloader
from ..ops.voxelize import DeviceVoxelizer


def build_predict_fn(det, device, cfg=None, kind="points"):
    """``predict(points, points_mask)`` over numpy batches -> numpy outputs,
    through the ``points`` or the ``voxels`` input contract (the latter
    reads ``cfg["voxel_generator"]``)."""
    voxelize = None
    if kind == "voxels":
        vg = dict(cfg["voxel_generator"])
        mv = vg.get("max_voxel_num", 150000)
        voxelize = DeviceVoxelizer(vg, device,
                                   mv if isinstance(mv, int) else mv[1])

    def predict(points, pmask):
        ex = {"points": torch.from_numpy(points).to(device),
              "points_mask": torch.from_numpy(pmask).to(device)}
        if voxelize is not None:
            ex.update(voxelize(ex["points"], ex["points_mask"]))
        out = det.predict(ex)
        return {k: v.cpu().numpy() for k, v in out.items()}

    return predict


def init_example(dataset, device, kind="points"):
    """A small all-padding example of the dataset's point layout, or of its
    voxel features (the static-RPE fill reads only the fixed cell grid,
    not the points)."""
    # + per-point extras the loader appends, + the rho, phi decoration
    # columns of transform_points
    nf = (dataset.NumPointFeatures
          + getattr(dataset, "ExtraPointChannels", 0) + 2)
    if kind == "points":
        return {"points": torch.zeros((1, 1024, nf), device=device),
                "points_mask": torch.zeros((1, 1024), dtype=torch.bool,
                                           device=device)}
    return {"features": torch.zeros((1, 256, nf), device=device),
            "coords": torch.zeros((1, 256, 3), dtype=torch.int32,
                                  device=device),
            "voxel_mask": torch.zeros((1, 256), dtype=torch.bool,
                                      device=device)}


def evaluate(det, dataset, work_dir, logger, device, batch_size=1,
             max_points=200000, max_frames=None, testset=False, cfg=None,
             input_kind=None):
    """Predict over ``dataset`` and evaluate -> (result, fps). The input
    contract is ``input_kind``, the detector's own (``points``) when
    None; ``voxels`` needs the config ``cfg``."""
    predict = build_predict_fn(det, device, cfg,
                               input_kind or det.input_kind)
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
