"""Logging and metric meters (port of `hitadv_tpu/utils/logging.py`):
the evaluation's logger (reference `util/other_utils.py:150-170`), top-k
accuracy (:217-235) and the running mean with its NaN clamp (:275-300)."""

from __future__ import annotations

import logging
import math
import os
from datetime import datetime

import numpy as np


def create_logger(save_path: str = "", file_type: str = "",
                  level: str = "info") -> logging.Logger:
    """Stream(+file) logger; the file goes to
    ``<save_path>/<file_type>_log.txt``."""
    _level = logging.DEBUG if level == "debug" else logging.INFO
    logger = logging.getLogger("hitadv_torch")
    logger.setLevel(_level)
    logger.handlers.clear()

    cs = logging.StreamHandler()
    cs.setLevel(_level)
    logger.addHandler(cs)

    if save_path:
        os.makedirs(save_path, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(save_path, f"{file_type}_log.txt"), mode="w")
        fh.setLevel(_level)
        logger.addHandler(fh)
    return logger


def timestamped_logger(save_path: str = "./log") -> logging.Logger:
    """eval_ASR's convention: a fresh %Y%m%d%H%M%S-named log file."""
    ts = datetime.now().strftime("%Y%m%d%H%M%S")
    return create_logger(save_path, ts, "info")


def topk_accuracy(logits, targets, topk=(1,)):
    """Top-k accuracy percentages (reference ``torch_accuracy``) of logits
    ``[B, K]`` against targets ``[B]``, numpy arrays or tensors on any
    device, ranked by numpy's argsort as the JAX package ranks them."""
    logits = np.asarray(_host(logits))
    targets = np.asarray(_host(targets))
    pred = np.argsort(-logits, axis=-1)[:, :max(topk)]
    correct = pred == targets[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


class AvgMeter:
    """Running mean; a NaN counts as 1e6 (reference
    `util/other_utils.py:275-300`)."""

    def __init__(self, name: str = "No name"):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.sum = 0.0
        self.mean = 0.0
        self.num = 0
        self.now = 0.0

    def update(self, mean_var: float, count: int = 1) -> None:
        if math.isnan(mean_var):
            mean_var = 1e6
        self.now = mean_var
        self.num += count
        self.sum += mean_var * count
        self.mean = float(self.sum) / self.num
