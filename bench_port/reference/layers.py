"""The layers of the reference victims, in float32 eval mode: a linear
(``w`` as ``[Cin, Cout]``, an optional bias ``b``), batch norm on its
running statistics (``scale``, ``bias``, ``mean``, ``var``), ReLU and
DGCNN's LeakyReLU(0.2)."""

from __future__ import annotations

import torch

EPS = 1e-5


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["w"])
    return y + p["b"] if "b" in p else y


def batchnorm(p, x: torch.Tensor) -> torch.Tensor:
    return (x - p["mean"]) / torch.sqrt(p["var"] + EPS) * p["scale"] \
        + p["bias"]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)
