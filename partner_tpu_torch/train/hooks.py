"""Training hooks (counterpart of ``partner_tpu/train/hooks.py``): only the
text logger so far; the log buffer and hooks come with the train CLI."""

import logging
import os
import time


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
