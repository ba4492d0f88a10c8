"""Victim models. Only PointNet is ported so far."""

from typing import Dict, Type

from torch import nn

from hitadv_torch.models.pointnet import PointNet

_REGISTRY: Dict[str, Type[nn.Module]] = {"pointnet": PointNet}


def get_model(name: str) -> Type[nn.Module]:
    """The model class registered under ``name``."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
