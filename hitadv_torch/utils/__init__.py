"""Utilities: the logger and meters, checkpoints, experiment
bookkeeping and resumable sweeps, spans and counters (`profiling`), and
mesh and point-cloud files."""

from hitadv_torch.utils.logging import timestamped_logger  # noqa: F401
from hitadv_torch.utils.training_aux import EvalProgress  # noqa: F401
