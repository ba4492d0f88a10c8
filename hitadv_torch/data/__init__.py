"""Datasets. Only the synthetic stand-in for ModelNet40 is ported so far."""

from hitadv_torch.data.synthetic import synthetic_batches, synthetic_clouds  # noqa: F401
