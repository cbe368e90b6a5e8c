"""Segmentation and panoptic metrics (counterpart of
``partner_tpu/eval/seg_metrics.py``, numpy; the port keeps its own copy):
``fast_hist`` and ``per_class_iou`` (the confusion matrix over the
labelled points and each class's IoU, for the mIoU), and
``PanopticEval`` (PQ, SQ and RQ over (semantic, instance) label pairs:
a predicted and a gt segment of one class match above IoU 0.5; predicted
segments under ``min_points`` points are not counted).
"""

import numpy as np


def fast_hist(pred, label, n):
    k = (label >= 0) & (label < n)
    return np.bincount(
        n * label[k].astype(int) + pred[k], minlength=n ** 2
    ).reshape(n, n)


def per_class_iou(hist):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / (
            hist.sum(1) + hist.sum(0) - np.diag(hist)
        )


class PanopticEval:
    """PQ/SQ/RQ over (semantic, instance) label pairs."""

    def __init__(self, n_classes, ignore=None, min_points=50):
        self.n_classes = n_classes
        self.ignore = np.array(ignore or [], dtype=np.int64)
        self.include = np.array(
            [c for c in range(n_classes) if c not in self.ignore], np.int64
        )
        self.min_points = min_points
        self.reset()

    def reset(self):
        n = self.n_classes
        self.pan_tp = np.zeros(n, np.int64)
        self.pan_iou = np.zeros(n, np.double)
        self.pan_fp = np.zeros(n, np.int64)
        self.pan_fn = np.zeros(n, np.int64)
        self.conf = np.zeros((n, n), np.int64)

    def addBatchSemIoU(self, x_sem, y_sem):
        idxs = tuple(np.stack((x_sem, y_sem), axis=0))
        np.add.at(self.conf, idxs, 1)

    def getSemIoU(self):
        conf = self.conf.copy().astype(np.double)
        conf[:, self.ignore] = 0
        tp = conf.diagonal()
        fp = conf.sum(axis=1) - tp
        fn = conf.sum(axis=0) - tp
        iou = tp / np.maximum(tp + fp + fn, 1e-15)
        return iou[self.include].mean(), iou

    def addBatch(self, x_sem, x_inst, y_sem, y_inst):
        self.addBatchSemIoU(x_sem, y_sem)
        x_inst = x_inst + 1
        y_inst = y_inst + 1

        for cl in self.include:
            x_mask = x_sem == cl
            y_mask = y_sem == cl

            x_ids, x_cnt = np.unique(x_inst[x_mask], return_counts=True)
            y_ids, y_cnt = np.unique(y_inst[y_mask], return_counts=True)
            valid_x = x_cnt >= self.min_points
            x_ids, x_cnt = x_ids[valid_x], x_cnt[valid_x]

            matched_x = np.zeros(len(x_ids), bool)
            matched_y = np.zeros(len(y_ids), bool)

            if len(x_ids) and len(y_ids):
                joint = x_inst.astype(np.int64) * 2 ** 32 + y_inst
                both = x_mask & y_mask
                pairs, p_cnt = np.unique(joint[both], return_counts=True)
                px = pairs // 2 ** 32
                py = pairs % 2 ** 32
                x_lookup = {v: c for v, c in zip(x_ids, x_cnt)}
                y_lookup = {v: c for v, c in zip(y_ids, y_cnt)}
                for xi, yi, inter in zip(px, py, p_cnt):
                    if xi not in x_lookup or yi not in y_lookup:
                        continue
                    union = x_lookup[xi] + y_lookup[yi] - inter
                    iou = inter / union
                    if iou > 0.5:
                        self.pan_tp[cl] += 1
                        self.pan_iou[cl] += iou
                        matched_x[np.searchsorted(x_ids, xi)] = True
                        matched_y[np.searchsorted(y_ids, yi)] = True
            self.pan_fp[cl] += int((~matched_x).sum())
            self.pan_fn[cl] += int(
                ((y_cnt >= self.min_points) & ~matched_y).sum()
            )

    def getPQ(self):
        sq = self.pan_iou / np.maximum(self.pan_tp, 1e-15)
        rq = self.pan_tp / np.maximum(
            self.pan_tp + 0.5 * self.pan_fp + 0.5 * self.pan_fn, 1e-15
        )
        pq = sq * rq
        return (
            pq[self.include].mean(), sq[self.include].mean(),
            rq[self.include].mean(), pq, sq, rq,
        )
