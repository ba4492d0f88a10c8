"""The evaluation's logger (port of `create_logger` and
`timestamped_logger` in `hitadv_tpu/utils/logging.py`; reference
`util/other_utils.py:150-170`)."""

from __future__ import annotations

import logging
import os
from datetime import datetime


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
