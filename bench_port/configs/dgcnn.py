"""DGCNN: its parameter tree, its victim in the port, and the model FLOPs
of its passes (see `configs/dgcnn.json`)."""

from __future__ import annotations

from bench_port.trees import batchnorm, linear


def _edge_widths(c):
    widths = [c["input_channels"]] + list(c["edge_conv"])
    return list(zip(widths[:-1], widths[1:]))


def tree(c: dict) -> dict:
    """The parameter tree in the port's layout: each leaf ``("uniform",
    shape, fan_in)`` or ``("const", shape, value)``."""
    p = {}
    for i, (a, b) in enumerate(_edge_widths(c), start=1):
        p[f"conv{i}"], p[f"bn{i}"] = linear(2 * a, b, bias=False), batchnorm(b)
    emb, (h1, h2) = c["emb_dims"], c["head_fc"]
    p["conv5"] = linear(sum(c["edge_conv"]), emb, bias=False)
    p["bn5"] = batchnorm(emb)
    p["linear1"], p["bn6"] = linear(2 * emb, h1, bias=False), batchnorm(h1)
    p["linear2"], p["bn7"] = linear(h1, h2), batchnorm(h2)
    p["linear3"] = linear(h2, c["num_classes"])
    return p


def port_victim(c: dict, params: dict, device):
    """The port's DGCNN on ``params`` with the configuration's k, float32."""
    from hitadv_torch.models import DGCNN, DGCNNConfig

    return DGCNN(params=params, cfg=DGCNNConfig(k=c["k"],
                                                emb_dims=c["emb_dims"]),
                 device=device)


def forward_flops(c: dict, n: int) -> float:
    """One cloud of ``n`` points: each EdgeConv in its least form, two
    per-point products (``max_j W [x_j - x_i; x_i] = max_j x_j Wd + x_i
    (Wc - Wd)``), the embedding and the head. The kNN counts nothing."""
    emb, (h1, h2) = c["emb_dims"], c["head_fc"]
    edge = sum(4 * n * a * b for a, b in _edge_widths(c))
    return edge + 2 * n * sum(c["edge_conv"]) * emb \
        + 2 * (2 * emb * h1 + h1 * h2 + h2 * c["num_classes"])


def input_grad_flops(c: dict, n: int) -> float:
    """The input gradient of one cloud, counted only where every row needs
    it: the head, the embedding (its mean-pool reaches every point) and
    each EdgeConv's centre term. The neighbour terms are not counted:
    only the rows the neighbour max picks need them."""
    emb, (h1, h2) = c["emb_dims"], c["head_fc"]
    edge = sum(2 * n * a * b for a, b in _edge_widths(c))
    return edge + 2 * n * sum(c["edge_conv"]) * emb \
        + 2 * (2 * emb * h1 + h1 * h2 + h2 * c["num_classes"])
