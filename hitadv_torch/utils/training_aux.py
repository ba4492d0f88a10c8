"""Resumable evaluation sweeps (port of `EvalProgress` in
`hitadv_tpu/utils/training_aux.py`; the reference has no equivalent)."""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict


class EvalProgress:
    """The batch cursor and the per-batch scalar accumulators of a sweep,
    persisted after every batch so that `evaluation.eval_asr` can restart
    a long sweep after preemption. Only load files this program wrote:
    unpickling runs code."""

    def __init__(self, path: str):
        self.path = path
        self.state: Dict[str, Any] = {"next_batch": 0, "acc": {}}
        if os.path.isfile(path):
            with open(path, "rb") as f:
                self.state = pickle.load(f)

    @property
    def next_batch(self) -> int:
        return int(self.state["next_batch"])

    def accumulators(self) -> Dict[str, float]:
        return dict(self.state["acc"])

    def update(self, batch_index: int, acc: Dict[str, float]) -> None:
        """Record that batches up to ``batch_index`` are done, atomically
        (a reader sees the old file or the new one)."""
        self.state = {"next_batch": batch_index + 1, "acc": dict(acc)}
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.state, f)
        os.replace(tmp, self.path)
