"""Victim models. PointNet, DGCNN, PointNet++ (SSG), PCT, PointConv and
GeoA3's PointNet are ported so far."""

from typing import Dict, Type

from torch import nn

from hitadv_torch.models.dgcnn import DGCNN, DGCNNConfig  # noqa: F401
from hitadv_torch.models.geoa3_pointnet import GeoA3PointNet
from hitadv_torch.models.pct import PCT
from hitadv_torch.models.pointconv import PointConv
from hitadv_torch.models.pointnet import PointNet
from hitadv_torch.models.pointnet2 import PointNet2

_REGISTRY: Dict[str, Type[nn.Module]] = {"pointnet": PointNet,
                                         "dgcnn": DGCNN,
                                         "pointnet++": PointNet2,
                                         "pct": PCT,
                                         "pointconv": PointConv,
                                         "geoa3_pointnet": GeoA3PointNet}


def get_model(name: str) -> Type[nn.Module]:
    """The model class registered under ``name``."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
