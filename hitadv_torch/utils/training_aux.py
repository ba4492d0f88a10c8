"""Checkpoint and experiment bookkeeping, and resumable evaluation sweeps
(port of `hitadv_tpu/utils/training_aux.py`): `TrainingAux` (reference
`FGM/GeoA3_args.py:855-930`: checkpoint, best copy, state log), the
converged-iteration and loss recorders (`Count_converge_iter`,
`Count_loss_iter`, :930-996) and `EvalProgress` (no reference
equivalent)."""

from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Any, Dict, List, Optional


class TrainingAux:
    """A checkpoint directory with a best copy and a state log (GeoA3's
    ``Training_aux``). Only load files this program wrote: unpickling
    runs code."""

    def __init__(self, fsave: str):
        self.fsave = fsave
        os.makedirs(fsave, exist_ok=True)

    def save_checkpoint(self, state: Dict[str, Any], is_best: bool,
                        filename: str = "checkpoint.pkl") -> None:
        path = os.path.join(self.fsave, filename)
        with open(path, "wb") as f:
            pickle.dump(state, f)
        if is_best:
            shutil.copyfile(path, os.path.join(self.fsave, "modelBest.pkl"))

    def load_checkpoint(self, is_best: bool = False
                        ) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.fsave,
                            "modelBest.pkl" if is_best else "checkpoint.pkl")
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def write_err_to_file(self, info: str) -> None:
        with open(os.path.join(self.fsave, "state.txt"), "a") as f:
            f.write(info)


def _plot(fsave: str, name: str, draw) -> None:
    """``draw(ax)`` into ``<fsave>/<name>.png`` when matplotlib is there;
    nothing without it (a headless host without the optional package)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots()
    draw(ax)
    fig.savefig(os.path.join(fsave, f"{name}.png"), dpi=120)
    plt.close(fig)


class ConvergenceRecorder:
    """Converged-iteration histogram (``Count_converge_iter``): `save`
    writes the recorded steps as JSON and, with matplotlib, a histogram
    PNG."""

    def __init__(self, fsave: str, bins: int = 20):
        self.fsave = fsave
        self.bins = bins
        os.makedirs(fsave, exist_ok=True)
        self.steps: List[int] = []

    def record(self, step: int) -> None:
        self.steps.append(int(step))

    def save(self, name: str = "converge_iter") -> None:
        with open(os.path.join(self.fsave, f"{name}.json"), "w") as f:
            json.dump(self.steps, f)

        def draw(ax):
            ax.hist(self.steps, bins=self.bins)
            ax.set_xlabel(name)
        _plot(self.fsave, name, draw)


class LossRecorder(ConvergenceRecorder):
    """Per-iteration loss curve (``Count_loss_iter``): JSON, and with
    matplotlib a PNG."""

    def __init__(self, fsave: str):
        super().__init__(fsave)
        self.losses: List[float] = []

    def record(self, loss: float) -> None:  # type: ignore[override]
        self.losses.append(float(loss))

    def save(self, name: str = "loss_iter") -> None:
        with open(os.path.join(self.fsave, f"{name}.json"), "w") as f:
            json.dump(self.losses, f)

        def draw(ax):
            ax.plot(self.losses)
            ax.set_xlabel("iteration")
            ax.set_ylabel("loss")
        _plot(self.fsave, name, draw)


class EvalProgress:
    """The batch cursor and the per-batch scalar accumulators of a sweep,
    persisted after every batch so that `evaluation.eval_asr` can restart
    a long sweep after preemption. Only load files this program wrote:
    unpickling runs code. With ``write=False`` it reads the file and
    never writes it (the ranks of a sharded sweep other than rank 0)."""

    def __init__(self, path: str, write: bool = True):
        self.path = path
        self.write = write
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
        if not self.write:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.state, f)
        os.replace(tmp, self.path)
