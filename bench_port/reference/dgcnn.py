"""DGCNN classification (Wang et al., ACM TOG 2019, arXiv:1801.07829) in
eval mode: four EdgeConv layers 64-64-128-256 over the kNN graph of each
layer's input (k of the configuration, the point itself included), the
1024-wide embedding over their concatenation, global max and mean
pooling, and the head 512-256-classes with LeakyReLU(0.2). An EdgeConv
is the textbook one: the edge features ``[x_j - x_i, x_i]`` of every
neighbour j, a linear without bias, batch norm, LeakyReLU, and the
maximum over the neighbours. The kNN of coordinates takes
`geometry.sqdist`; of features, the matrix-product form of the original
code."""

from __future__ import annotations

import torch

from bench_port.reference import geometry as G
from bench_port.reference.layers import batchnorm, leaky, linear


def _edge_conv(pc, pb, h: torch.Tensor, k: int) -> torch.Tensor:
    dist = G.sqdist if h.shape[-1] <= 4 else G.sqdist_mm
    _, idx = G.knn(h, h, k, dist=dist)
    nb = G.gather(h, idx)                                    # [B, N, k, C]
    centre = h[:, :, None, :].expand_as(nb)
    e = torch.cat([nb - centre, centre], dim=-1)             # [B, N, k, 2C]
    return torch.max(leaky(batchnorm(pb, linear(pc, e))), dim=2).values


def forward(p, x: torch.Tensor, config: dict) -> torch.Tensor:
    """Logits ``[B, classes]`` of clouds ``x [B, N, 3]``."""
    feats, h = [], x
    for i in range(1, 5):
        h = _edge_conv(p[f"conv{i}"], p[f"bn{i}"], h, config["k"])
        feats.append(h)
    h = leaky(batchnorm(p["bn5"], linear(p["conv5"], torch.cat(feats, -1))))
    g = torch.cat([torch.max(h, dim=1).values, torch.mean(h, dim=1)], -1)
    g = leaky(batchnorm(p["bn6"], linear(p["linear1"], g)))
    g = leaky(batchnorm(p["bn7"], linear(p["linear2"], g)))
    return linear(p["linear3"], g)
