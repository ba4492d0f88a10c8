"""Utilities of the evaluation: the logger, resumable sweeps, checkpoints."""

from hitadv_torch.utils.logging import timestamped_logger  # noqa: F401
from hitadv_torch.utils.training_aux import EvalProgress  # noqa: F401
