"""GeoA3's PointNet variant (port of
`hitadv_tpu/models/geoa3_pointnet.py`, reference `model/GeoA3_PN.py:
61-189`): two transform nets (K = 3 and K = 64; BN eps 1e-3; ``fc3``
starts as zeros with the identity as its bias), the conv stack
64/64/64/128, a last conv of kernel 3 over the point axis to 1024 (so
the order of the points matters), the max pool, and the 512/256/classes
head (default BN eps there). Input ``[B, N, 3]``.

The max pools are `torch.amax`, whose gradient splits evenly among tied
maxima as jnp.max's does (after a ReLU ties at 0 are common; `torch.max`
over a dim would give all of it to one point). This victim runs no
max-linear kernel: like the reference, it takes the conv and then the
max. Inside `functional.bn_training` (the trainer) every BN, the one
after the kernel-3 ``conv5`` too, normalises with batch statistics at the
model's own eps.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from hitadv_torch import resolve_device
from hitadv_torch.models.pointnet import _register, _tree_to
from hitadv_torch.nn import functional as F

_EPS = 1e-3


def _transform_init(K: int, *, generator, device) -> Dict:
    kw = dict(generator=generator, device=device)
    p = {
        "conv1": F.conv1x1_init(K, 64, **kw),
        "bn1": F.batchnorm_init(64, device=device),
        "conv2": F.conv1x1_init(64, 128, **kw),
        "bn2": F.batchnorm_init(128, device=device),
        "conv3": F.conv1x1_init(128, 1024, **kw),
        "bn3": F.batchnorm_init(1024, device=device),
        "fc1": F.linear_init(1024, 512, **kw),
        "bn4": F.batchnorm_init(512, device=device),
        "fc2": F.linear_init(512, 256, **kw),
        "bn5": F.batchnorm_init(256, device=device),
        "fc3": F.linear_init(256, K * K, **kw),
    }
    # the reference's init: fc3's weight zero, its bias the identity
    # (`GeoA3_PN.py:98-100`)
    p["fc3"]["w"] = torch.zeros_like(p["fc3"]["w"])
    p["fc3"]["b"] = torch.eye(K, device=device).reshape(-1)
    return p


def init_params(num_classes: int = 40, *, generator: torch.Generator,
                device) -> Dict:
    """A fresh parameter tree with PyTorch's default initialisation."""
    kw = dict(generator=generator, device=device)
    return {
        "input_transform": _transform_init(3, **kw),
        "feature_transform": _transform_init(64, **kw),
        "conv1": F.conv1x1_init(3, 64, **kw),
        "bn1": F.batchnorm_init(64, device=device),
        "conv2": F.conv1x1_init(64, 64, **kw),
        "bn2": F.batchnorm_init(64, device=device),
        "conv3": F.conv1x1_init(64, 64, **kw),
        "bn3": F.batchnorm_init(64, device=device),
        "conv4": F.conv1x1_init(64, 128, **kw),
        "bn4": F.batchnorm_init(128, device=device),
        "conv5": F.conv1d_init(128, 1024, 3, **kw),
        "bn5": F.batchnorm_init(1024, device=device),
        "fc1": F.linear_init(1024, 512, **kw),
        "bn6": F.batchnorm_init(512, device=device),
        "fc2": F.linear_init(512, 256, **kw),
        "bn7": F.batchnorm_init(256, device=device),
        "fc3": F.linear_init(256, num_classes, **kw),
    }


class GeoA3PointNet(nn.Module):
    """``GeoA3PointNet(num_classes)(x [B, N, 3]) -> logits``.

    Args:
      num_classes: the architecture (ignored when ``params`` is given).
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
        self.num_classes = int(self.params["fc3"]["w"].shape[1])
        self.eval()

    def _transform(self, p, x: torch.Tensor, K: int) -> torch.Tensor:
        cd = self.compute_dtype
        h = F.relu(F.linear_bn(p["conv1"], p["bn1"], x, cd, eps=_EPS))
        h = F.relu(F.linear_bn(p["conv2"], p["bn2"], h, cd, eps=_EPS))
        h = F.relu(F.linear_bn(p["conv3"], p["bn3"], h, cd, eps=_EPS))
        g = torch.amax(h, dim=1)
        g = F.relu(F.linear_bn(p["fc1"], p["bn4"], g, cd, eps=_EPS))
        g = F.relu(F.linear_bn(p["fc2"], p["bn5"], g, cd, eps=_EPS))
        return F.linear(p["fc3"], g, cd).reshape(-1, K, K)

    def apply_full(self, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, the first point attaining each of the 1024 pooled
        channels ``[B, 1024]``), the reference's ``return_idx``."""
        p, cd = self.params, self.compute_dtype
        trans = self._transform(p["input_transform"], x, 3)
        # the transform folded into conv1's weight
        h = F.relu(F.linear_bn_pre(p["conv1"], p["bn1"], trans, x, cd,
                                   eps=_EPS))
        h = F.relu(F.linear_bn(p["conv2"], p["bn2"], h, cd, eps=_EPS))
        ftrans = self._transform(p["feature_transform"], h, 64)
        h = F.relu(F.linear_bn_pre(p["conv3"], p["bn3"], ftrans, h, cd,
                                   eps=_EPS))
        h = F.relu(F.linear_bn(p["conv4"], p["bn4"], h, cd, eps=_EPS))
        h = F.relu(F.batchnorm(p["bn5"], F.conv1d(p["conv5"], h, cd), cd,
                               eps=_EPS))
        g = torch.amax(h, dim=1)                              # [B, 1024]
        idx = torch.argmax(h, dim=1)
        g = F.relu(F.linear_bn(p["fc1"], p["bn6"], g, cd))
        g = F.relu(F.linear_bn(p["fc2"], p["bn7"], g, cd))
        return F.linear(p["fc3"], g, cd), idx

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits only, the reference's ``apply``."""
        return self.apply_full(x)[0]


def _transform_spec(tp, tr):
    return {
        **{f"{tr}/conv{i}": (f"{tp}.conv{i}", "conv") for i in (1, 2, 3)},
        **{f"{tr}/bn{i}": (f"{tp}.bn{i}", "bn") for i in (1, 2, 3, 4, 5)},
        **{f"{tr}/fc{i}": (f"{tp}.fc{i}", "linear") for i in (1, 2, 3)},
    }


# The reference's torch state_dict layout (`model/GeoA3_PN.py`) as the
# tree's paths, for `utils.checkpoint.convert_state_dict`; ``conv5``'s
# kernel-3 weight converts as "conv1d" to [3, 128, 1024].
TORCH_SPEC = {
    **_transform_spec("input_transform", "input_transform"),
    **_transform_spec("feature_transform", "feature_transform"),
    **{f"conv{i}": (f"conv{i}", "conv") for i in (1, 2, 3, 4)},
    "conv5": ("conv5", "conv1d"),
    **{f"bn{i}": (f"bn{i}", "bn") for i in (1, 2, 3, 4, 5, 6, 7)},
    **{f"fc{i}": (f"fc{i}", "linear") for i in (1, 2, 3)},
}
