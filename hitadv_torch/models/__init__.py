"""Victim models (PointNet, DGCNN, PointNet++, PCT, PointConv and GeoA3's
PointNet) and AdvPC's autoencoder: every model of the JAX package. The
registry maps a victim's name to its `nn.Module` class; `register` adds
one."""

import sys
from typing import Dict, List, Type

from torch import nn

from hitadv_torch.models.autoencoder import AutoEncoder  # noqa: F401
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


def register(name: str, module_class: Type[nn.Module]) -> None:
    """Register ``module_class`` as the victim ``name`` (JAX `register`,
    which takes the family's ``(init, apply)`` pair)."""
    _REGISTRY[name] = module_class


def get_model(name: str) -> Type[nn.Module]:
    """The model class registered under ``name``."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> List[str]:
    """The registered victims' names, sorted (JAX `available`)."""
    return sorted(_REGISTRY)


def torch_spec(name: str) -> Dict:
    """The ``TORCH_SPEC`` of victim ``name``: how the reference's torch
    checkpoint of it maps onto the tree (`utils.checkpoint`)."""
    return sys.modules[get_model(name).__module__].TORCH_SPEC
