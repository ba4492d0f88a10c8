"""PointNet++ SSG classifier, eval mode.

Port of `hitadv_tpu/models/pointnet2.py` (reference
`model/pointnet2_cls_ssg.py` + `model/pointnet2_utils.py:162-203`): three
set-abstraction stages (512/0.2/32, 128/0.4/64, group_all) of a shared MLP
and a max-pool over ball-query groups, then a 512/256/classes head.
Input ``[B, N, C]`` channels-last (C=3, or 6 with normals as features).

The two sampled stages run their first MLP layer project-then-gather, as
the reference's eval path does (JAX `_sa_apply`, :45-100): the layer is
affine once its BN is folded, so it is applied to all N points first and
one grouped gather of the projected field (`geometry.gather_group_nm`,
neighbours-major ``[B, ns, S, C1]``) replaces the gather and concat of
xyz and features; the neighbour max then runs over axis 1 with the
tie-splitting gradient (`functional.max_axis`). FPS starts at index 0,
the reference's ``key=None`` convention. FPS, the centre gathers, the ball
query and the grouped gather are kernels on CUDA, in both directions.

The parameters are the reference's tree (``sa1``..``sa3`` with
``conv{i}``/``bn{i}``, ``fc1``..``fc3``, ``bn1``, ``bn2``; ``w`` as
``[Cin, Cout]``). The train-mode branch (batch-statistics BN over the
grouped grid) and ``TORCH_SPEC`` wait for the port of `train.py` and
`utils/checkpoint.py`.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from hitadv_torch import resolve_device
from hitadv_torch.models.pointnet import _register, _tree_to
from hitadv_torch.nn import functional as F
from hitadv_torch.ops import geometry as G


class SAConfig(NamedTuple):
    npoint: Optional[int]
    radius: Optional[float]
    nsample: Optional[int]
    mlp: Tuple[int, ...]
    group_all: bool


SSG_STAGES = (
    SAConfig(512, 0.2, 32, (64, 64, 128), False),
    SAConfig(128, 0.4, 64, (128, 128, 256), False),
    SAConfig(None, None, None, (256, 512, 1024), True),
)


def init_params(num_classes: int = 40, normal_channel: bool = False, *,
                generator: torch.Generator, device) -> Dict:
    """A fresh parameter tree with PyTorch's default initialisation, in
    the reference's shapes (JAX `init`, :103-117)."""
    kw = dict(generator=generator, device=device)
    in_channel = 6 if normal_channel else 3
    p = {}
    for i, (cin, cfg) in enumerate(zip((in_channel, 128 + 3, 256 + 3),
                                       SSG_STAGES), start=1):
        p[f"sa{i}"] = F.mlp_init([cin, *cfg.mlp], **kw)
    p["fc1"] = F.linear_init(1024, 512, **kw)
    p["bn1"] = F.batchnorm_init(512, device=device)
    p["fc2"] = F.linear_init(512, 256, **kw)
    p["bn2"] = F.batchnorm_init(256, device=device)
    p["fc3"] = F.linear_init(256, num_classes, **kw)
    return p


def _sa_apply(params: Mapping, cfg: SAConfig, xyz: torch.Tensor,
              points: Optional[torch.Tensor], compute_dtype=None):
    """One eval-mode set-abstraction stage: xyz ``[B, N, 3]``, points
    ``[B, N, D]`` or None -> (new_xyz ``[B, S, 3]``, pooled ``[B, S,
    C']``) (JAX :45-100)."""
    cd = compute_dtype
    if cfg.group_all:
        new_xyz, new_points = G.sample_and_group_all(xyz, points,
                                                     concat=False)
        h = F.mlp_apply(params, new_points, cd)
        return new_xyz, F.max_mid(h)                         # [B, 1, C']
    fps_idx = G.farthest_point_sample(xyz, cfg.npoint)
    new_xyz = G.index_points(xyz, fps_idx)                   # [B, S, 3]
    idx = G.query_ball_point(cfg.radius, cfg.nsample, xyz, new_xyz)
    # the first layer, projected before the gather: conv0(concat(xyz_j -
    # centre, feats_j)) = (xyz_j Wx + feats_j Wf) - centre Wx + b
    W, b = F.fold_bn(params["conv0"], params["bn0"])         # [3 + D, C1]
    q = F.linear({"w": W[:3]}, xyz, cd)                      # [B, N, C1]
    if points is not None:
        q = q + F.linear({"w": W[3:]}, points, cd)
    pc = F.linear({"w": W[:3]}, new_xyz, cd)                 # [B, S, C1]
    h = F.relu(G.gather_group_nm(q, idx) - pc[:, None, :, :]
               + b.to(q.dtype))                              # [B, ns, S, C1]
    h = F.mlp_apply(params, h, cd, start=1)
    return new_xyz, F.max_axis(h, 1)                         # [B, S, C']


class PointNet2(nn.Module):
    """``PointNet2(num_classes)(x [B, N, 3]) -> logits [B, num_classes]``.

    Args:
      num_classes, normal_channel: the architecture (ignored when
        ``params`` is given: they follow from its shapes).
      compute_dtype: None (f32) or ``torch.bfloat16`` activations.
      device: where the parameters live; ``"cuda"`` unless the caller
        asks for the CPU.
      generator: the source of a fresh initialisation; a generator seeded
        with 0 on ``device`` when None.
      params: a parameter tree to load instead (see
        `hitadv_torch.convert.params_from_numpy`).
    """

    def __init__(self, num_classes: int = 40, *,
                 normal_channel: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 device="cuda",
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Mapping] = None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            params = init_params(num_classes, normal_channel,
                                 generator=generator, device=dev)
        else:
            params = _tree_to(params, dev)
        self.params = _register(params)
        self.compute_dtype = compute_dtype
        self.num_classes = int(self.params["fc3"]["w"].shape[1])
        self.eval()

    def apply_full(self, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, l3_points ``[B, 1, 1024]``), as the reference's
        ``apply_full`` (JAX :120-138)."""
        p, cd = self.params, self.compute_dtype
        xyz = x[..., :3]
        feats = x[..., 3:] if x.shape[-1] > 3 else None
        l1_xyz, l1_points = _sa_apply(p["sa1"], SSG_STAGES[0], xyz, feats,
                                      cd)
        l2_xyz, l2_points = _sa_apply(p["sa2"], SSG_STAGES[1], l1_xyz,
                                      l1_points, cd)
        _, l3_points = _sa_apply(p["sa3"], SSG_STAGES[2], l2_xyz, l2_points,
                                 cd)
        g = l3_points[:, 0, :]                               # [B, 1024]
        g = F.relu(F.linear_bn(p["fc1"], p["bn1"], g, cd))
        g = F.relu(F.linear_bn(p["fc2"], p["bn2"], g, cd))
        return F.linear(p["fc3"], g, cd), l3_points

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits only: the reference's ``pointnet2.apply``."""
        return self.apply_full(x)[0]


def _sa_spec(torch_prefix: str, tree_prefix: str, n_layers: int):
    spec = {}
    for i in range(n_layers):
        spec[f"{tree_prefix}/conv{i}"] = (
            f"{torch_prefix}.mlp_convs.{i}", "conv")
        spec[f"{tree_prefix}/bn{i}"] = (f"{torch_prefix}.mlp_bns.{i}", "bn")
    return spec


# The reference's torch state_dict layout as the tree's paths (JAX
# :219-237).
TORCH_SPEC = {
    **_sa_spec("sa1", "sa1", 3),
    **_sa_spec("sa2", "sa2", 3),
    **_sa_spec("sa3", "sa3", 3),
    "fc1": ("fc1", "linear"),
    "bn1": ("bn1", "bn"),
    "fc2": ("fc2", "linear"),
    "bn2": ("bn2", "bn"),
    "fc3": ("fc3", "linear"),
}
