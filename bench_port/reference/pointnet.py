"""PointNet classification as the PyTorch code of
yanx27/Pointnet_Pointnet2_pytorch builds it (``models/pointnet_cls.py``
``get_model`` over
``models/pointnet_utils.py`` ``PointNetEncoder``, ``STN3d``, ``STNkd``;
HiT-ADV's published code carries a copy), in eval mode: the input
transform (T-Net 64-128-1024 / 512-256), the MLP 64, the feature
transform (the same T-Net on 64 channels), the MLP 128-1024, the global
max-pool of the last conv's batch-normed output (before any ReLU), and
the head 512-256-classes; every other layer a linear, its batch norm and
its ReLU. The paper (Qi et al., CVPR 2017, arXiv:1612.00593) has the
MLPs 64-64 and 64-128-1024, each layer with its ReLU: this code has two
1x1 convs fewer, and the widths here are the code's."""

from __future__ import annotations

import torch

from bench_port.reference.layers import batchnorm, linear, relu


def _tnet(p, x: torch.Tensor, k: int) -> torch.Tensor:
    h = x
    for i in range(3):
        h = relu(batchnorm(p["conv"][f"bn{i}"],
                           linear(p["conv"][f"conv{i}"], h)))
    g = torch.max(h, dim=1).values
    g = relu(batchnorm(p["bn4"], linear(p["fc1"], g)))
    g = relu(batchnorm(p["bn5"], linear(p["fc2"], g)))
    g = linear(p["fc3"], g)
    eye = torch.eye(k, device=x.device, dtype=x.dtype).reshape(1, k * k)
    return (g + eye).reshape(-1, k, k)


def forward(p, x: torch.Tensor, config: dict) -> torch.Tensor:
    """Logits ``[B, classes]`` of clouds ``x [B, N, 3]``."""
    h = torch.matmul(x, _tnet(p["stn"], x, 3))
    h = relu(batchnorm(p["bn1"], linear(p["conv1"], h)))
    h = torch.matmul(h, _tnet(p["fstn"], h, 64))
    h = relu(batchnorm(p["bn2"], linear(p["conv2"], h)))
    h = batchnorm(p["bn3"], linear(p["conv3"], h))
    g = torch.max(h, dim=1).values
    g = relu(batchnorm(p["head_bn1"], linear(p["head_fc1"], g)))
    g = relu(batchnorm(p["head_bn2"], linear(p["head_fc2"], g)))
    return linear(p["head_fc3"], g)
