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

A detector with a seg head also gives ``point_seg_labels``: each frame's
first ``n_key_points`` labels (the key frame's points, which its lidarseg
file labels) and their cartesian xy columns are kept; after the loop each
frame with a lidarseg file (:func:`load_seg_gt`) gets its mIoU inputs and,
with ``models.seg_head.panoptic_fuse`` over its kept boxes (no instance
where it has none), its panoptic inputs (``evaluator.py:150-240``). A
segmentation-only detector's frames have no boxes: ``prediction.pkl`` is
then empty, as in JAX.

With a process group (``parallel.dist``; torchrun's ranks) the eval is
sharded as JAX's mesh eval is (``evaluator.py:115-135,197-201``): the
batch size is the global batch's, each rank loads and predicts its
positional part of each global batch (``data.loader``), and
``parallel.dist.all_gather_object`` brings every rank's detections and
seg predictions to rank 0, which writes ``prediction.pkl`` (frames in the
dataset's order, whatever rank or loader thread predicted them) and
evaluates; the other ranks return ``(None, fps)``.
"""

import os
import pickle
import time

import numpy as np
import torch

from ..data import build_dataloader
from ..data.pipeline import read_lidarseg
from ..ops.voxelize import DeviceVoxelizer
from ..parallel import dist

# the lidarseg classes (after the 32 -> 17 merge) of the ten detection
# classes, and each one's label in NuScenesDataset.CLASSES
NUSC_THING_CLASSES = tuple(range(1, 11))
NUSC_SEMANTIC2BOX = {1: 5, 2: 7, 3: 3, 4: 0, 5: 2,
                     6: 6, 7: 8, 8: 9, 9: 4, 10: 1}


def load_seg_gt(info):
    """A frame's gt classes (int64, one a key-frame point) from its info's
    ``lidarseg_path``; None without one."""
    path = info.get("lidarseg_path")
    if not path or not os.path.exists(path):
        return None
    return read_lidarseg(path)


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
    """Predict over ``dataset`` and evaluate -> (result, fps) on rank 0
    (the only process without a group), (None, fps) on the others. The
    input contract is ``input_kind``, the detector's own (``points``) when
    None; ``voxels`` needs the config ``cfg``. ``batch_size`` is the
    global batch, which the world size must divide; ``max_frames`` counts
    the global batches' frames; ``fps`` is global frames a second."""
    rank, world = dist.process_info()
    predict = build_predict_fn(det, device, cfg,
                               input_kind or det.input_kind)
    loader = build_dataloader(dataset, batch_size, workers_per_gpu=4,
                              shuffle=False, max_points=max_points,
                              rank=rank, world_size=world)
    vshape = dict((cfg or {}).get("voxel_generator", {})).get(
        "voxel_shape", getattr(det, "voxel_shape", "cylinder"))
    # the cartesian xy columns (transform_points: cylinder rows are
    # [rho, phi, z, x, y, ...]) for the panoptic fusion
    xy_cols = slice(3, 5) if vshape == "cylinder" else slice(0, 2)
    detections, seg_preds, times = {}, {}, []
    n_frames = n_global = 0
    for batch in loader:
        t0 = time.perf_counter()
        out = predict(batch["points"], batch["points_mask"])
        times.append(time.perf_counter() - t0)
        # a double-flip batch holds 4 point rows a sample: the original first
        group = len(batch["points"]) // max(1, len(batch["metadata"]))
        for i, meta in enumerate(batch["metadata"]):
            token = meta["token"] if meta else (
                str(n_frames) if world == 1 else f"{rank}:{n_frames}")
            if "box3d_lidar" in out:
                m = out["mask"][i]
                detections[token] = {
                    "box3d_lidar": out["box3d_lidar"][i][m],
                    "scores": out["scores"][i][m],
                    "label_preds": out["label_preds"][i][m],
                    "metadata": meta,
                }
            if "point_seg_labels" in out:
                pm = batch["points_mask"][i * group]
                n_key = (meta or {}).get("n_key_points", int(pm.sum()))
                seg_preds[token] = {
                    "labels": out["point_seg_labels"][i][:n_key],
                    "xy": batch["points"][i * group][:n_key, xy_cols]}
            n_frames += 1
        n_global += batch_size
        if max_frames and n_global >= max_frames:
            break

    third = max(1, len(times) // 3)
    window = times[third: 2 * third] or times
    fps = batch_size * len(window) / sum(window)
    logger.info(f"frames: {n_global}, middle-third FPS: {fps:.2f}")

    gathered = dist.all_gather_object((detections, seg_preds))
    if rank != 0:
        return None, fps
    detections = in_dataset_order(dataset, [d for d, _ in gathered])
    seg_preds = in_dataset_order(dataset, [s for _, s in gathered])
    with open(os.path.join(work_dir, "prediction.pkl"), "wb") as f:
        pickle.dump(detections, f)
    kwargs = seg_inputs(dataset, detections, seg_preds)
    result = dataset.evaluation(detections, output_dir=work_dir,
                                testset=testset, **kwargs)
    logger.info(f"evaluation: {result}")
    return result, fps


def in_dataset_order(dataset, parts):
    """Per-frame dicts (one a rank) -> one dict, its frames in the
    dataset's order (the infos' tokens), any other key after them."""
    merged = {}
    for p in parts:
        merged.update(p)
    order = {info.get("token", str(i)): i
             for i, info in enumerate(dataset.infos)}
    keys = sorted(merged, key=lambda k: (k not in order, order.get(k, 0)))
    return {k: merged[k] for k in keys}


def seg_inputs(dataset, detections, seg_preds):
    """Each frame's predicted point labels -> {"final_seg", "final_ins"}
    for ``dataset.evaluation`` ({} where no frame has a lidarseg file):
    per frame with one, the first min(gt, predicted) points' predicted and
    gt classes, and the panoptic pairs (the predicted instances of
    ``panoptic_fuse`` over the frame's kept boxes; the gt instances the
    info's ``instance_ids``, else 0)."""
    from ..models.seg_head import panoptic_fuse

    infos = {info.get("token", str(i)): info
             for i, info in enumerate(dataset.infos)}
    final_seg, final_ins = {}, {}
    for token, sp in seg_preds.items():
        gt = load_seg_gt(infos.get(token, {}))
        if gt is None:
            continue
        n = min(len(gt), len(sp["labels"]))
        pred = np.asarray(sp["labels"][:n], np.int64)
        final_seg[token] = {"pred": pred, "gt": gt[:n]}
        det_out = detections.get(token)
        if det_out is not None and len(det_out["box3d_lidar"]):
            inst = panoptic_fuse(
                pred, sp["xy"][:n], det_out["box3d_lidar"],
                det_out["label_preds"], det_out["scores"],
                np.ones(len(det_out["scores"]), bool), NUSC_THING_CLASSES,
                NUSC_SEMANTIC2BOX)
        else:
            inst = np.zeros(n, np.int64)
        gt_inst = infos.get(token, {}).get("instance_ids")
        final_ins[token] = {
            "pred_sem": pred, "pred_inst": inst, "gt_sem": gt[:n],
            "gt_inst": (np.asarray(gt_inst[:n], np.int64)
                        if gt_inst is not None else np.zeros(n, np.int64))}
    if not final_seg:
        return {}
    return dict(final_seg=final_seg, final_ins=final_ins)
