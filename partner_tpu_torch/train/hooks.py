"""Training hooks (counterpart of ``partner_tpu/train/hooks.py``): the
running-average ``LogBuffer`` flushed every ``interval`` steps by the text
logger with the reference's key names (``data_time``, ``transfer_time``,
``forward_time``, ``time``, ``sync_time``), the learning rate, per-loss
means and the card's allocated memory; a phase timer; a TensorBoard
writer; and a JSON-lines metrics sink (``PaviLoggerHook`` in configs).
"""

import json
import logging
import os
import time
from collections import OrderedDict

import numpy as np


class LogBuffer:
    """Every value logged, by key, and the means of the last ``n`` of them
    in ``output`` after :meth:`average`; a list value (a per-task loss)
    averages element by element."""

    def __init__(self):
        self.val_history = OrderedDict()
        self.n_history = OrderedDict()
        self.output = OrderedDict()

    def clear_output(self):
        self.output.clear()

    def update(self, vars, count=1):
        for k, v in vars.items():
            self.val_history.setdefault(k, []).append(v)
            self.n_history.setdefault(k, []).append(count)

    def average(self, n=0):
        for k in self.val_history:
            vals = np.array(self.val_history[k][-n:], dtype=np.float64)
            nums = np.array(self.n_history[k][-n:], dtype=np.float64)
            w = nums.reshape((-1,) + (1,) * (vals.ndim - 1))
            avg = (vals * w).sum(0) / nums.sum()
            self.output[k] = avg.tolist() if vals.ndim > 1 else float(avg)


def get_logger(work_dir=None, name="partner_tpu_torch", level=logging.INFO):
    """The package logger: to stderr, and to ``work_dir/<stamp>.log`` when
    a work directory is given (set up once per process)."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if work_dir:
        os.makedirs(work_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
        fh = logging.FileHandler(os.path.join(work_dir, f"{stamp}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class TextLoggerHook:
    def __init__(self, logger, interval=5):
        self.logger = logger
        self.interval = interval

    def after_iter(self, buffer: LogBuffer, step, epoch, lr,
                   max_steps_in_epoch=None):
        """Every ``interval`` global steps: one line of the buffer's means
        over the last ``interval`` entries (a per-task loss as its values
        one after another, as the reference's logger prints it), the
        iteration within the epoch and the card's memory."""
        if (step + 1) % self.interval:
            return
        buffer.average(self.interval)
        it = (step % max_steps_in_epoch) + 1 if max_steps_in_epoch else step + 1
        parts = [f"Epoch [{epoch}][{it}"
                 + (f"/{max_steps_in_epoch}]" if max_steps_in_epoch else "]")]
        parts.append(f"lr: {lr:.5f}")
        for k, v in buffer.output.items():
            if isinstance(v, list):
                parts.append(f"{k}: " + ", ".join(f"{x:.4f}" for x in v))
            elif k.endswith("time"):
                parts.append(f"{k}: {v:.3f}")
            else:
                parts.append(f"{k}: {v:.4f}")
        mem = device_memory_mb()
        if mem is not None:
            parts.append(f"memory: {mem:.0f}MB")
        self.logger.info(", ".join(parts))
        buffer.clear_output()


def device_memory_mb():
    """MiB allocated by PyTorch on the current CUDA card, or None on the
    CPU."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_allocated() / 2 ** 20


class IterTimer:
    """Phase timer: ``lap()`` -> seconds since the last lap."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self):
        now = time.perf_counter()
        dt = now - self.t
        self.t = now
        return dt


class TensorBoardLoggerHook:
    """TensorBoard scalars through ``tensorboardX``, imported when the hook
    is built."""

    def __init__(self, log_dir, interval=5):
        from tensorboardX import SummaryWriter

        self.writer = SummaryWriter(log_dir)
        self.interval = interval

    def log(self, step, scalars, lr=None):
        if step % self.interval:
            return
        for k, v in scalars.items():
            if isinstance(v, list):   # a per-task loss: one curve a task
                for i, x in enumerate(v):
                    self.writer.add_scalar(f"train/{k}/task{i}", float(x),
                                           step)
                continue
            try:
                self.writer.add_scalar(f"train/{k}", float(v), step)
            except (TypeError, ValueError):
                pass
        if lr is not None:
            self.writer.add_scalar("train/lr", float(lr), step)

    def close(self):
        self.writer.close()


class MetricsSinkHook:
    """Structured metrics: one ``{step, epoch, lr, metric: value}`` record
    (a per-task loss as a list) every ``interval`` steps, to a JSON-lines
    file (default ``metrics.jsonl``) or to any callable ``sink``. Configs
    name it ``PaviLoggerHook`` or ``MetricsSinkHook``."""

    def __init__(self, path=None, sink=None, interval=5):
        self.interval = interval
        if sink is not None:
            self.sink = sink
            self._fh = None
        else:
            path = path or "metrics.jsonl"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
            self.sink = lambda rec: (
                self._fh.write(json.dumps(rec) + "\n"), self._fh.flush())

    def log(self, step, scalars, lr=None, epoch=None):
        if step % self.interval:
            return
        rec = {"step": int(step)}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        if lr is not None:
            rec["lr"] = float(lr)
        for k, v in scalars.items():
            try:
                rec[k] = ([float(x) for x in v] if isinstance(v, list)
                          else float(v))
            except (TypeError, ValueError):
                continue
        self.sink(rec)

    def close(self):
        if self._fh is not None:
            self._fh.close()


PaviLoggerHook = MetricsSinkHook  # the reference's hook name in configs
