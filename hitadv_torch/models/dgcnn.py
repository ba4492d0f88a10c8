"""DGCNN classifier.

Port of `hitadv_tpu/models/dgcnn.py` (reference `model/dgcnn_cls.py`):
four EdgeConv blocks over a dynamic kNN graph in feature space, the
512 -> emb_dims embedding, global max and mean pooling, and a
512/256/classes head with LeakyReLU(0.2). Input ``[B, N, 3]``.

Each EdgeConv runs in the reference's fused eval form (`edge_conv_fused`,
JAX :60-102): with the eval BN folded in, ``max_j leaky(W [x_j - x_i;
x_i])`` is ``leaky(max_j y_j + z_i)`` for two per-point projections y and
z, so the ``[B, N, k, 2C]`` edge tensor never exists. The kNN of each
block is `geometry.knn_idx` (self included, as the reference's
`model/dgcnn_cls.py:7-13`), the neighbour max is `geometry.graph_max_pool`:
both are kernels on CUDA. Inside `functional.bn_training` (the trainer)
each EdgeConv takes the reference's edge-grid form instead (JAX :129-145):
the kNN, the neighbour gather (`get_graph_feature`, a row gather and, in
the backward, its row scatter), the linear and batch-statistics BN over
the whole ``[B, N, k, C']`` grid, LeakyReLU and the max over k. Like the
JAX package, it has no dropout.

The parameters are the reference's tree (``conv1``..``conv5``,
``bn1``..``bn7``, ``linear1``..``linear3``; ``w`` as ``[Cin, Cout]``),
registered as PointNet registers its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from hitadv_torch import resolve_device
from hitadv_torch.models.pointnet import _register, _tree_to
from hitadv_torch.nn import functional as F
from hitadv_torch.ops import geometry as G


@dataclass(frozen=True)
class DGCNNConfig:
    """The reference's architecture knobs. The JAX package's ``dropout``
    field is read by nothing (no mode of it drops out), so it is not
    ported."""
    k: int = 20
    emb_dims: int = 1024


def init_params(num_classes: int = 40, cfg: DGCNNConfig = DGCNNConfig(), *,
                generator: torch.Generator, device) -> Dict:
    """A fresh parameter tree with PyTorch's default initialisation, in
    the reference's order and shapes (JAX `init`, :105-121)."""
    kw = dict(generator=generator, device=device)
    p = {}
    dims = [(6, 64), (128, 64), (128, 128), (256, 256)]
    for i, (cin, cout) in enumerate(dims, start=1):
        p[f"conv{i}"] = F.conv1x1_init(cin, cout, bias=False, **kw)
        p[f"bn{i}"] = F.batchnorm_init(cout, device=device)
    p["conv5"] = F.conv1x1_init(512, cfg.emb_dims, bias=False, **kw)
    p["bn5"] = F.batchnorm_init(cfg.emb_dims, device=device)
    p["linear1"] = F.linear_init(cfg.emb_dims * 2, 512, bias=False, **kw)
    p["bn6"] = F.batchnorm_init(512, device=device)
    p["linear2"] = F.linear_init(512, 256, **kw)
    p["bn7"] = F.batchnorm_init(256, device=device)
    p["linear3"] = F.linear_init(256, num_classes, **kw)
    return p


def get_graph_feature(x: torch.Tensor, k: int, concat: bool = True):
    """Edge features over the feature-space kNN graph, self included
    (JAX :35-57, reference `model/dgcnn_cls.py:16-43`): ``[B, N, C] ->
    [B, N, k, 2C]``, ``concat(x_j - x_i, x_i)``. With ``concat=False``
    the two parts ``(x_j - x_i, x_i [B, N, 1, C])`` for `F.linear_parts`,
    whose sum broadcasts the centre. The kNN runs on the detached
    features: its indices carry no gradient."""
    idx = G.knn_idx(x, x, k)                                 # [B, N, k]
    neighbors = G.index_points(x, idx)                       # [B, N, k, C]
    center = x[:, :, None, :]
    if not concat:
        return neighbors - center, center
    return torch.cat([neighbors - center, center.expand_as(neighbors)],
                     dim=-1)


def edge_conv_fused(p_conv: Mapping, p_bn: Mapping, h: torch.Tensor, k: int,
                    compute_dtype=None) -> torch.Tensor:
    """Eval-mode EdgeConv ``[B, N, C] -> [B, N, C']`` (JAX :60-102).

    W splits into the rows Wd of ``x_j - x_i`` and Wc of ``x_i``; with the
    BN affine ``a (.) + b`` folded in, ``y = x (Wd a)`` and ``z = x ((Wc -
    Wd) a) + b``, and ``max_j leaky(y_j + z_i) = leaky(max_j y_j + z_i)``
    since LeakyReLU is increasing. The bias sits inside z's linear, so it
    follows the compute dtype (JAX :95-100)."""
    C = h.shape[-1]
    W = p_conv["w"]                                          # [2C, C']
    Wd, Wc = W[:C], W[C:]
    a = p_bn["scale"] * torch.rsqrt(p_bn["var"] + 1e-5)
    b = p_bn["bias"] - p_bn["mean"] * a
    idx = G.knn_idx(h, h, k)                                 # [B, N, k]
    y = F.linear({"w": Wd * a[None]}, h, compute_dtype)      # [B, N, C']
    z = F.linear({"w": (Wc - Wd) * a[None], "b": b}, h, compute_dtype)
    mx = G.graph_max_pool(y, idx)
    return F.leaky_relu(mx + z)


class DGCNN(nn.Module):
    """``DGCNN(num_classes)(x [B, N, 3]) -> logits [B, num_classes]``.

    Args:
      num_classes: the head's width (ignored when ``params`` is given).
      cfg: k and emb_dims (emb_dims follows from ``params`` when given).
      compute_dtype: None (f32) or ``torch.bfloat16`` activations.
      device: where the parameters live; ``"cuda"`` unless the caller
        asks for the CPU.
      generator: the source of a fresh initialisation; a generator seeded
        with 0 on ``device`` when None.
      params: a parameter tree to load instead (see
        `hitadv_torch.convert.params_from_numpy`).
    """

    def __init__(self, num_classes: int = 40, *,
                 cfg: DGCNNConfig = DGCNNConfig(),
                 compute_dtype: Optional[torch.dtype] = None,
                 device="cuda",
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Mapping] = None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            params = init_params(num_classes, cfg, generator=generator,
                                 device=dev)
        else:
            params = _tree_to(params, dev)
        self.params = _register(params)
        self.compute_dtype = compute_dtype
        self.k = cfg.k
        self.num_classes = int(self.params["linear3"]["w"].shape[1])
        self.emb_dims = int(self.params["conv5"]["w"].shape[1])
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``apply`` (JAX :124-158)."""
        p, cd = self.params, self.compute_dtype
        feats = []
        h = x
        for i in range(1, 5):
            if F.bn_is_training():
                # batch statistics over the whole edge grid, as torch's
                e = get_graph_feature(h, self.k, concat=False)
                e = F.leaky_relu(F.linear_bn(p[f"conv{i}"], p[f"bn{i}"], e,
                                             cd))
                h = torch.amax(e, dim=2)                     # [B, N, C']
            else:
                h = edge_conv_fused(p[f"conv{i}"], p[f"bn{i}"], h, self.k,
                                    cd)
            feats.append(h)
        h = torch.cat(feats, dim=-1)                         # [B, N, 512]
        h = F.leaky_relu(F.linear_bn(p["conv5"], p["bn5"], h, cd))
        g = torch.cat([torch.amax(h, dim=1), torch.mean(h, dim=1)], dim=-1)
        g = F.leaky_relu(F.linear_bn(p["linear1"], p["bn6"], g, cd))
        g = F.leaky_relu(F.linear_bn(p["linear2"], p["bn7"], g, cd))
        return F.linear(p["linear3"], g, cd)


# The reference's torch state_dict layout (convN is Sequential(conv, bn,
# leaky) -> ".0"/".1") as the tree's paths (JAX :164-172).
TORCH_SPEC = {
    **{f"conv{i}": (f"conv{i}.0", "conv") for i in range(1, 6)},
    **{f"bn{i}": (f"conv{i}.1", "bn") for i in range(1, 6)},
    "linear1": ("linear1", "linear"),
    "bn6": ("bn6", "bn"),
    "linear2": ("linear2", "linear"),
    "bn7": ("bn7", "bn"),
    "linear3": ("linear3", "linear"),
}
