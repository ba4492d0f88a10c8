"""PCT (Point Cloud Transformer) classifier.

Port of `hitadv_tpu/models/pct.py` (reference `model/pct_cls.py` +
`model/pct_utils.py`): the 3 -> 64 -> 64 embedding, two kNN-32 grouping
stages (npoint 512, then 256) with `Local_op` pooling, four
offset-attention layers whose q and k share one weight (``qk_conv``) and
whose softmax is renormalised over columns, ``conv_fuse`` to 1024 with a
global max-pool, and a 512/256/classes head with LeakyReLU(0.2). Input
``[B, N, 3]``.

Each `Local_op` runs its first conv project-then-gather, as the
reference's eval path does (JAX `_local_op_fused`, :51-73): with the eval
BN folded, ``conv1(concat(g_j - c, c)) = g_j W1 + c (W2 - W1) + b``, so
the features are projected once and one grouped gather of the projected
field (`geometry.gather_group_nm`, neighbours-major) replaces the
``[B, S, ns, 2D]`` concat. ``conv_fuse`` and the global max-pool ride the
fused max-linear kernels (`functional.linear_bn_max`), then the
LeakyReLU (monotone, so it commutes with the max). FPS starts at index 0.
FPS, the gathers, the kNN, the grouped gather and the max-linear pair are
kernels on CUDA. The attention's products and softmax are plain PyTorch,
as they are plain XLA in the reference: energy and attention in f32.

The parameters are the reference's tree (``conv1``, ``bn1``, ...,
``gather0``/``gather1``, ``sa1``..``sa4`` with ``qk_conv``, ...,
``linear3``). The JAX package's ``PCTConfig`` holds only a dropout
rate that nothing reads, so it is not ported. Inside
`functional.bn_training` (the trainer) each grouping stage takes the
reference's formulation instead (JAX :148-157):
`geometry.sample_and_group_knn` (row gathers of the centres and the
neighbours' features, the parts left unconcatenated) and `Local_op`
with batch-statistics BN over the whole group grid; ``conv_fuse`` and its
max-pool are then the plain composition (`functional.linear_bn_max`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from hitadv_torch import resolve_device
from hitadv_torch.models.pointnet import _register, _tree_to
from hitadv_torch.nn import functional as F
from hitadv_torch.ops import geometry as G


def _conv_bn(cin: int, cout: int, kw) -> Dict:
    return {"conv": F.conv1x1_init(cin, cout, bias=False, **kw),
            "bn": F.batchnorm_init(cout, device=kw["device"])}


def init_params(num_classes: int = 40, *, generator: torch.Generator,
                device) -> Dict:
    """A fresh parameter tree with PyTorch's default initialisation, in
    the reference's shapes (JAX `init`, :106-133)."""
    kw = dict(generator=generator, device=device)
    p = {}
    for name, (cin, cout) in (("1", (3, 64)), ("2", (64, 64))):
        cb = _conv_bn(cin, cout, kw)
        p[f"conv{name}"], p[f"bn{name}"] = cb["conv"], cb["bn"]
    for i, c in enumerate((128, 256)):
        a, b = _conv_bn(c, c, kw), _conv_bn(c, c, kw)
        p[f"gather{i}"] = {"conv1": a["conv"], "bn1": a["bn"],
                           "conv2": b["conv"], "bn2": b["bn"]}
    for i in (1, 2):
        cb = _conv_bn(256, 256, kw)
        p[f"pt_conv{i}"], p[f"pt_bn{i}"] = cb["conv"], cb["bn"]
    for i in range(1, 5):
        p[f"sa{i}"] = {
            # q and k share this one tensor (reference model/pct_cls.py
            # :116-117)
            "qk_conv": F.conv1x1_init(256, 64, bias=False, **kw),
            "v_conv": F.conv1x1_init(256, 256, **kw),
            "trans_conv": F.conv1x1_init(256, 256, **kw),
            "after_norm": F.batchnorm_init(256, device=device),
        }
    cb = _conv_bn(1280, 1024, kw)
    p["conv_fuse"], p["bn_fuse"] = cb["conv"], cb["bn"]
    p["linear1"] = F.linear_init(1024, 512, bias=False, **kw)
    p["bn6"] = F.batchnorm_init(512, device=device)
    p["linear2"] = F.linear_init(512, 256, **kw)
    p["bn7"] = F.batchnorm_init(256, device=device)
    p["linear3"] = F.linear_init(256, num_classes, **kw)
    return p


def _local_op_apply(p: Mapping, x, compute_dtype=None) -> torch.Tensor:
    """`Local_op` over grouped features ``[B, S, ns, D]`` (or their
    parts) -> ``[B, S, C]``: two conv-BN-ReLU layers, the max over ns
    (JAX :41-48, reference `model/pct_cls.py:6-23`)."""
    h = F.relu(F.linear_bn(p["conv1"], p["bn1"], x, compute_dtype))
    h = F.relu(F.linear_bn(p["conv2"], p["bn2"], h, compute_dtype))
    return F.max_mid(h)


def _local_op_fused(p: Mapping, points: torch.Tensor, fps_idx: torch.Tensor,
                    idx: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Eval-mode `Local_op` over kNN groups, conv1 project-then-gather
    (JAX :51-73): points ``[B, N, D]``, centres ``fps_idx [B, S]``,
    neighbours ``idx [B, S, ns]`` -> ``[B, S, C]``."""
    cd = compute_dtype
    W, b = F.fold_bn(p["conv1"], p["bn1"])                   # [2D, C]
    D = points.shape[-1]
    q = F.linear({"w": W[:D]}, points, cd)                   # [B, N, C]
    center = G.index_points(points, fps_idx)                 # [B, S, D]
    cterm = F.linear({"w": W[D:] - W[:D], "b": b}, center, cd)  # [B, S, C]
    h = F.relu(G.gather_group_nm(q, idx)
               + cterm[:, None, :, :])                       # [B, ns, S, C]
    h = F.relu(F.linear_bn(p["conv2"], p["bn2"], h, cd))
    return F.max_axis(h, 1)


def _sa_layer_apply(p: Mapping, x: torch.Tensor,
                    compute_dtype=None) -> torch.Tensor:
    """Offset attention on ``[B, N, C]`` (JAX :88-103): q and k from the
    one ``qk_conv``; energy, softmax, the column renormalisation (+1e-9)
    and the value product in f32."""
    cd = compute_dtype
    q = F.linear(p["qk_conv"], x, cd)                        # [B, N, C/4]
    k = F.linear(p["qk_conv"], x, cd)
    v = F.linear(p["v_conv"], x, cd)                         # [B, N, C]
    energy = torch.matmul(q.float(), k.float().transpose(1, 2))
    attention = torch.softmax(energy, dim=-1)
    attention = attention / (1e-9 + attention.sum(dim=1, keepdim=True))
    x_r = torch.matmul(attention.transpose(1, 2), v.float())  # [B, N, C]
    x_r = F.relu(F.linear_bn(p["trans_conv"], p["after_norm"], x - x_r,
                             cd))
    return x + x_r


class PCT(nn.Module):
    """``PCT(num_classes)(x [B, N, 3]) -> logits [B, num_classes]``.

    Args:
      num_classes: the head's width (ignored when ``params`` is given).
      compute_dtype: None (f32) or ``torch.bfloat16`` activations.
      device: where the parameters live; ``"cuda"`` unless the caller
        asks for the CPU.
      generator: the source of a fresh initialisation; a generator seeded
        with 0 on ``device`` when None.
      params: a parameter tree to load instead (see
        `hitadv_torch.convert.params_from_numpy`).
    """

    def __init__(self, num_classes: int = 40, *,
                 compute_dtype: Optional[torch.dtype] = None,
                 device="cuda",
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Mapping] = None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            params = init_params(num_classes, generator=generator,
                                 device=dev)
        else:
            params = _tree_to(params, dev)
        self.params = _register(params)
        self.compute_dtype = compute_dtype
        self.num_classes = int(self.params["linear3"]["w"].shape[1])
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``pct.apply`` (JAX :136-194)."""
        p, cd = self.params, self.compute_dtype
        h = F.relu(F.linear_bn(p["conv1"], p["bn1"], x, cd))
        h = F.relu(F.linear_bn(p["conv2"], p["bn2"], h, cd))   # [B, N, 64]
        if F.bn_is_training():
            new_xyz, grouped = G.sample_and_group_knn(512, 32, x, h,
                                                      concat=False)
            feat0 = _local_op_apply(p["gather0"], grouped, cd)
            _, grouped = G.sample_and_group_knn(256, 32, new_xyz, feat0,
                                                concat=False)
            feat1 = _local_op_apply(p["gather1"], grouped, cd)
        else:
            fps_idx = G.farthest_point_sample(x, 512)
            new_xyz = G.index_points(x, fps_idx)
            idx = G.knn_point(32, x, new_xyz)
            feat0 = _local_op_fused(p["gather0"], h, fps_idx, idx,
                                    cd)                      # [B, 512, 128]
            fps_idx = G.farthest_point_sample(new_xyz, 256)
            xyz2 = G.index_points(new_xyz, fps_idx)
            idx = G.knn_point(32, new_xyz, xyz2)
            feat1 = _local_op_fused(p["gather1"], feat0, fps_idx, idx,
                                    cd)                      # [B, 256, 256]
        h = F.relu(F.linear_bn(p["pt_conv1"], p["pt_bn1"], feat1, cd))
        h = F.relu(F.linear_bn(p["pt_conv2"], p["pt_bn2"], h, cd))
        xs = []
        for i in range(1, 5):
            h = _sa_layer_apply(p[f"sa{i}"], h, cd)
            xs.append(h)
        h = torch.cat(xs + [feat1], dim=-1)                  # [B, 256, 1280]
        g = F.leaky_relu(F.linear_bn_max(p["conv_fuse"], p["bn_fuse"], h))
        g = F.leaky_relu(F.linear_bn(p["linear1"], p["bn6"], g, cd))
        g = F.leaky_relu(F.linear_bn(p["linear2"], p["bn7"], g, cd))
        return F.linear(p["linear3"], g, cd)


def _local_spec(tp, tr):
    return {
        f"{tr}/conv1": (f"{tp}.conv1", "conv"),
        f"{tr}/bn1": (f"{tp}.bn1", "bn"),
        f"{tr}/conv2": (f"{tp}.conv2", "conv"),
        f"{tr}/bn2": (f"{tp}.bn2", "bn"),
    }


def _sa_spec(tp, tr):
    # q_conv and k_conv are tied in torch; q_conv's tensor is canonical
    return {
        f"{tr}/qk_conv": (f"{tp}.q_conv", "conv"),
        f"{tr}/v_conv": (f"{tp}.v_conv", "conv"),
        f"{tr}/trans_conv": (f"{tp}.trans_conv", "conv"),
        f"{tr}/after_norm": (f"{tp}.after_norm", "bn"),
    }


# The reference's torch state_dict layout as the tree's paths (JAX
# :197-238).
TORCH_SPEC = {
    "conv1": ("conv1", "conv"),
    "bn1": ("bn1", "bn"),
    "conv2": ("conv2", "conv"),
    "bn2": ("bn2", "bn"),
    **_local_spec("gather_local_0", "gather0"),
    **_local_spec("gather_local_1", "gather1"),
    "pt_conv1": ("pt_last.conv1", "conv"),
    "pt_bn1": ("pt_last.bn1", "bn"),
    "pt_conv2": ("pt_last.conv2", "conv"),
    "pt_bn2": ("pt_last.bn2", "bn"),
    **_sa_spec("pt_last.sa1", "sa1"),
    **_sa_spec("pt_last.sa2", "sa2"),
    **_sa_spec("pt_last.sa3", "sa3"),
    **_sa_spec("pt_last.sa4", "sa4"),
    "conv_fuse": ("conv_fuse.0", "conv"),
    "bn_fuse": ("conv_fuse.1", "bn"),
    "linear1": ("linear1", "linear"),
    "bn6": ("bn6", "bn"),
    "linear2": ("linear2", "linear"),
    "bn7": ("bn7", "bn"),
    "linear3": ("linear3", "linear"),
}
