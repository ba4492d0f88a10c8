"""PointNet classifier with its spatial and feature transforms.

Port of `hitadv_tpu/models/pointnet.py` (reference `model/pointnet_cls.py`
+ `model/pointnet_utils.py`): STN3d, STNkd, the 64/128/1024 encoder and
the 512/256/classes head. Input ``[B, N, C]`` channels-last (C=3, or 6
with normals).

The parameters are the reference's tree (``stn``, ``fstn``, ``conv1``,
``bn1``, ..., ``head_fc3``; ``w`` as ``[Cin, Cout]``), registered in
nested ``nn.ModuleDict``/``nn.ParameterDict``s so that the functional
layers index them as they index the JAX pytree. They do not require
grad: the model is a frozen victim, and the fused max-pool then skips
its weight gradients; the trainer (`hitadv_torch.train`) asks for them
while it steps. Inside `functional.bn_training` every BN takes batch
statistics and the conv + max-pools their plain composition.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from hitadv_torch import resolve_device
from hitadv_torch.nn import functional as F


class PointNetOutput(NamedTuple):
    logits: torch.Tensor
    trans_feat: torch.Tensor
    features: Tuple[torch.Tensor, ...]


def _stn_init(channel: int, k: int, *, generator, device) -> Dict:
    """STN3d/STNkd: conv 64/128/1024 + fc 512/256/k*k."""
    kw = dict(generator=generator, device=device)
    return {
        "conv": F.mlp_init([channel, 64, 128, 1024], **kw),
        "fc1": F.linear_init(1024, 512, **kw),
        "bn4": F.batchnorm_init(512, device=device),
        "fc2": F.linear_init(512, 256, **kw),
        "bn5": F.batchnorm_init(256, device=device),
        "fc3": F.linear_init(256, k * k, **kw),
    }


def init_params(num_classes: int = 40, normal_channel: bool = False, *,
                generator: torch.Generator, device) -> Dict:
    """A fresh parameter tree with PyTorch's default initialisation."""
    channel = 6 if normal_channel else 3
    kw = dict(generator=generator, device=device)
    return {
        "stn": _stn_init(channel, 3, **kw),
        "conv1": F.conv1x1_init(channel, 64, **kw),
        "bn1": F.batchnorm_init(64, device=device),
        "fstn": _stn_init(64, 64, **kw),
        "conv2": F.conv1x1_init(64, 128, **kw),
        "bn2": F.batchnorm_init(128, device=device),
        "conv3": F.conv1x1_init(128, 1024, **kw),
        "bn3": F.batchnorm_init(1024, device=device),
        "head_fc1": F.linear_init(1024, 512, **kw),
        "head_bn1": F.batchnorm_init(512, device=device),
        "head_fc2": F.linear_init(512, 256, **kw),
        "head_bn2": F.batchnorm_init(256, device=device),
        "head_fc3": F.linear_init(256, num_classes, **kw),
    }


def _register(tree: Mapping) -> nn.Module:
    """Nested dicts of tensors -> nested ModuleDict/ParameterDict."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in tree.items()})
    return nn.ModuleDict({k: _register(v) for k, v in tree.items()})


class PointNet(nn.Module):
    """``PointNet(num_classes)(x [B, N, 3]) -> logits [B, num_classes]``.

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
        self.num_classes = int(self.params["head_fc3"]["w"].shape[1])
        self.eval()

    def _stn(self, p, x: torch.Tensor, k: int, want_feats: bool):
        """x [B, N, C] -> ([B, k, k] transform, conv feature tuple).

        Without features the last conv + max-pool is fused
        (`F.linear_bn_max`; relu commutes with the max)."""
        cd = self.compute_dtype
        feats = []
        h = x
        for i in range(3 if want_feats else 2):
            h = F.relu(F.linear_bn(p["conv"][f"conv{i}"],
                                   p["conv"][f"bn{i}"], h, cd))
            feats.append(h)
        if want_feats:
            g = torch.amax(h, dim=1)                          # [B, 1024]
        else:
            g = F.relu(F.linear_bn_max(p["conv"]["conv2"],
                                       p["conv"]["bn2"], h))
        g = F.relu(F.linear_bn(p["fc1"], p["bn4"], g, cd))
        g = F.relu(F.linear_bn(p["fc2"], p["bn5"], g, cd))
        g = F.linear(p["fc3"], g, cd)                         # [B, k*k]
        iden = torch.eye(k, dtype=g.dtype, device=g.device).reshape(1, k * k)
        return (g + iden).reshape(-1, k, k), tuple(feats)

    def apply_full(self, x: torch.Tensor,
                   want_feats: bool = True) -> PointNetOutput:
        """Forward pass with the transform and the LPIPS feature taps
        (stn x3, fstn x3, conv1 out, conv2 out)."""
        p, cd = self.params, self.compute_dtype
        trans, stn_feats = self._stn(p["stn"], x, 3, want_feats)
        if x.shape[-1] > 3:
            xyz = torch.matmul(x[..., :3], trans.float())
            h = torch.cat([xyz, x[..., 3:]], dim=-1)
            h = F.relu(F.linear_bn(p["conv1"], p["bn1"], h, cd))
        else:
            # the STN transform folded into conv1's weight
            h = F.relu(F.linear_bn_pre(p["conv1"], p["bn1"], trans, x, cd))
        conv1_out = h
        trans_feat, fstn_feats = self._stn(p["fstn"], h, 64, want_feats)
        h = F.relu(F.linear_bn_pre(p["conv2"], p["bn2"], trans_feat, h, cd))
        conv2_out = h
        g = F.linear_bn_max(p["conv3"], p["bn3"], h)         # [B, 1024]
        g = F.relu(F.linear_bn(p["head_fc1"], p["head_bn1"], g, cd))
        g = F.relu(F.linear_bn(p["head_fc2"], p["head_bn2"], g, cd))
        logits = F.linear(p["head_fc3"], g, cd)
        return PointNetOutput(logits=logits, trans_feat=trans_feat,
                              features=stn_feats + fstn_feats
                              + (conv1_out, conv2_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits only — the reference's ``pointnet.apply`` (the name
        `nn.Module.apply` is taken): the attack-facing path, with every
        conv + max-pool bottleneck fused."""
        return self.apply_full(x, want_feats=False).logits

    def features(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The LPIPS activation stack."""
        return self.apply_full(x).features


def _tree_to(tree: Mapping, device) -> Dict:
    return {k: (_tree_to(v, device) if isinstance(v, Mapping)
                else torch.as_tensor(v).to(device))
            for k, v in tree.items()}


def _stn_spec(torch_prefix: str, tree_prefix: str):
    return {
        f"{tree_prefix}/conv/conv0": (f"{torch_prefix}.conv1", "conv"),
        f"{tree_prefix}/conv/bn0": (f"{torch_prefix}.bn1", "bn"),
        f"{tree_prefix}/conv/conv1": (f"{torch_prefix}.conv2", "conv"),
        f"{tree_prefix}/conv/bn1": (f"{torch_prefix}.bn2", "bn"),
        f"{tree_prefix}/conv/conv2": (f"{torch_prefix}.conv3", "conv"),
        f"{tree_prefix}/conv/bn2": (f"{torch_prefix}.bn3", "bn"),
        f"{tree_prefix}/fc1": (f"{torch_prefix}.fc1", "linear"),
        f"{tree_prefix}/bn4": (f"{torch_prefix}.bn4", "bn"),
        f"{tree_prefix}/fc2": (f"{torch_prefix}.fc2", "linear"),
        f"{tree_prefix}/bn5": (f"{torch_prefix}.bn5", "bn"),
        f"{tree_prefix}/fc3": (f"{torch_prefix}.fc3", "linear"),
    }


# The reference's torch state_dict layout (model/pointnet_cls.get_model and
# model/feature_models.PointNetFeatureModel, identical keys) as the tree's
# paths, for `utils.checkpoint.convert_state_dict` (JAX :72-105).
TORCH_SPEC = {
    **_stn_spec("feat.stn", "stn"),
    **_stn_spec("feat.fstn", "fstn"),
    "conv1": ("feat.conv1", "conv"),
    "bn1": ("feat.bn1", "bn"),
    "conv2": ("feat.conv2", "conv"),
    "bn2": ("feat.bn2", "bn"),
    "conv3": ("feat.conv3", "conv"),
    "bn3": ("feat.bn3", "bn"),
    "head_fc1": ("fc1", "linear"),
    "head_bn1": ("bn1", "bn"),
    "head_fc2": ("fc2", "linear"),
    "head_bn2": ("bn2", "bn"),
    "head_fc3": ("fc3", "linear"),
}
