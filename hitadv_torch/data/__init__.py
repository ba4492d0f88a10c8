"""Datasets: the synthetic stand-in for ModelNet40 and GeoA3's .mat
files."""

from hitadv_torch.data.geoa3_mat import GeoA3ModelNet40  # noqa: F401
from hitadv_torch.data.synthetic import synthetic_batches, synthetic_clouds  # noqa: F401
