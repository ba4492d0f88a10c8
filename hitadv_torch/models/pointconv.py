"""PointConv (density-weighted SSG) classifier, eval mode.

Port of `hitadv_tpu/models/pointconv.py` (reference `model/pointconv.py`
+ `util/pointconv_util.py`): three density set-abstraction stages (512
centres with kNN-32 groups at bandwidth 0.1, 128 with kNN-64 at 0.2, then
one global group at 0.4), each with the per-stage KDE density
(`geometry.kde_density`), the `DensityNet` scale (every layer ReLU, as the
reference's reachable branch is), the `WeightNet` kernel and the
matmul-aggregated continuous convolution; then a 512/256/classes head.
Input ``[B, N, 3]``; the features default to the coordinates.

The two sampled stages run project-then-gather, as the reference's eval
path does (JAX `_stage_apply`, :121-171): with the eval BNs folded, the
first layers of the stage MLP and of `WeightNet` are affine, so they are
applied to all N points and one S-major row gather (`index_points`) of
``[mlp0 | weightnet0 | inverse density]`` replaces the gather of xyz and
features; the centres' images are subtracted after. In bf16 the inverse
density rides the bf16 field; in f32 it stays f32. FPS starts at index 0.
The KDE pair, FPS, the row gathers and the kNN are kernels on CUDA, in
both directions.

The parameters are the reference's tree (``sa1``..``sa3`` each with
``mlp``, ``weightnet``, ``densitynet`` as ``conv{i}``/``bn{i}`` stacks,
``linear``, ``bn_linear``; ``fc1``..``fc3``, ``bn1``, ``bn2``). The
train-mode branch and ``TORCH_SPEC`` wait for the port of `train.py` and
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


class PCStage(NamedTuple):
    npoint: int
    nsample: Optional[int]
    mlp: Tuple[int, ...]
    bandwidth: float
    group_all: bool


STAGES = (
    PCStage(512, 32, (64, 64, 128), 0.1, False),
    PCStage(128, 64, (128, 128, 256), 0.2, False),
    PCStage(1, None, (256, 512, 1024), 0.4, True),
)


def init_params(num_classes: int = 40, *, generator: torch.Generator,
                device) -> Dict:
    """A fresh parameter tree with PyTorch's default initialisation, in
    the reference's shapes (JAX `init`, :95-103, :227-238)."""
    kw = dict(generator=generator, device=device)
    p = {}
    for i, (cin, st) in enumerate(zip((3 + 3, 128 + 3, 256 + 3), STAGES),
                                  start=1):
        p[f"sa{i}"] = {
            "mlp": F.mlp_init([cin, *st.mlp], **kw),
            "weightnet": F.mlp_init([3, 8, 8, 16], **kw),
            "densitynet": F.mlp_init([1, 16, 8, 1], **kw),
            "linear": F.linear_init(16 * st.mlp[-1], st.mlp[-1], **kw),
            "bn_linear": F.batchnorm_init(st.mlp[-1], device=device),
        }
    p["fc1"] = F.linear_init(1024, 512, **kw)
    p["bn1"] = F.batchnorm_init(512, device=device)
    p["fc2"] = F.linear_init(512, 256, **kw)
    p["bn2"] = F.batchnorm_init(256, device=device)
    p["fc3"] = F.linear_init(256, num_classes, **kw)
    return p


def _grouped_fused(p: Mapping, stage: PCStage, xyz: torch.Tensor,
                   points: torch.Tensor, inv_density: torch.Tensor, cd):
    """A sampled stage's groups, project-then-gather (JAX :136-171):
    (new_xyz ``[B, S, 3]``, stage-MLP output ``[B, S, ns, C']``,
    WeightNet's first activation ``[B, S, ns, 8]``, inverse density
    ``[B, S, ns]``)."""
    fps_idx = G.farthest_point_sample(xyz, stage.npoint)
    new_xyz = G.index_points(xyz, fps_idx)                   # [B, S, 3]
    idx = G.knn_point(stage.nsample, xyz, new_xyz)           # [B, S, ns]
    W0, b0 = F.fold_bn(p["mlp"]["conv0"], p["mlp"]["bn0"])
    V0, c0 = F.fold_bn(p["weightnet"]["conv0"], p["weightnet"]["bn0"])
    C1 = W0.shape[1]
    q = F.linear({"w": W0[:3]}, xyz, cd) \
        + F.linear({"w": W0[3:]}, points, cd)                # [B, N, C1]
    qw = F.linear({"w": V0}, xyz, cd)                        # [B, N, 8]
    pc = F.linear({"w": W0[:3]}, new_xyz, cd)                # [B, S, C1]
    pw = F.linear({"w": V0}, new_xyz, cd)                    # [B, S, 8]
    field = torch.cat([q, qw, inv_density[..., None].to(q.dtype)], dim=-1)
    g = G.index_points(field, idx)                           # [B,S,ns,C1+9]
    h = F.relu(g[..., :C1] - pc[:, :, None, :] + b0.to(q.dtype))
    h = F.mlp_apply(p["mlp"], h, cd, start=1)                # [B,S,ns,C']
    wn_h = F.relu(g[..., C1:C1 + 8] - pw[:, :, None, :] + c0.to(q.dtype))
    return new_xyz, h, wn_h, g[..., C1 + 8]


def _stage_apply(p: Mapping, stage: PCStage, xyz: torch.Tensor,
                 points: torch.Tensor, compute_dtype=None):
    """One eval-mode density set abstraction: xyz ``[B, N, 3]``, points
    ``[B, N, D]`` -> (new_xyz ``[B, S, 3]``, features ``[B, S, C']``)
    (JAX :106-224)."""
    cd = compute_dtype
    B, N, _ = xyz.shape
    inv_density = 1.0 / G.kde_density(xyz, stage.bandwidth)  # [B, N] f32
    if stage.group_all:
        new_xyz = torch.mean(xyz, dim=1, keepdim=True)        # [B, 1, 3]
        grouped_xyz = xyz[:, None] - new_xyz[:, :, None]      # [B, 1, N, 3]
        h = F.mlp_apply(p["mlp"], (grouped_xyz, points[:, None]), cd)
        weights = F.mlp_apply(p["weightnet"], grouped_xyz, cd)
        grouped_density = inv_density.reshape(B, 1, N)
    else:
        new_xyz, h, wn_h, grouped_density = _grouped_fused(
            p, stage, xyz, points, inv_density, cd)
        weights = F.mlp_apply(p["weightnet"], wn_h, cd, start=1)
    # DensityNet on the inverse density over its group's max; the max's
    # gradient splits among exact ties (`torch.amax`), as the reference's
    # custom VJP does (:51-75)
    inv_max = torch.amax(grouped_density, dim=-1, keepdim=True)
    density_scale = F.mlp_apply(p["densitynet"],
                                (grouped_density / inv_max)[..., None], cd)
    h = h * density_scale                                     # [B,S,ns,C']
    # the bf16 operands widened exactly: f32 products and sums, f32 out,
    # as the reference's preferred_element_type=f32
    agg = torch.einsum("bsnc,bsnw->bscw", h.float(), weights.float())
    agg = agg.reshape(B, new_xyz.shape[1], -1)               # [B,S,16C']
    return new_xyz, F.relu(F.linear_bn(p["linear"], p["bn_linear"], agg, cd))


class PointConv(nn.Module):
    """``PointConv(num_classes)(x [B, N, 3], feat=None) -> logits
    [B, num_classes]``.

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
        self.num_classes = int(self.params["fc3"]["w"].shape[1])
        self.eval()

    def forward(self, x: torch.Tensor,
                feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The reference's ``pointconv.apply`` (JAX :241-253) in eval
        mode; ``feat`` defaults to the coordinates."""
        p, cd = self.params, self.compute_dtype
        xyz = x[..., :3]
        h = xyz if feat is None else feat
        for i, stage in enumerate(STAGES, start=1):
            xyz, h = _stage_apply(p[f"sa{i}"], stage, xyz, h, cd)
        g = h[:, 0, :]                                        # [B, 1024]
        g = F.relu(F.linear_bn(p["fc1"], p["bn1"], g, cd))
        g = F.relu(F.linear_bn(p["fc2"], p["bn2"], g, cd))
        return F.linear(p["fc3"], g, cd)


def _stage_spec(tp, tr, n_mlp):
    spec = {}
    for i in range(n_mlp):
        spec[f"{tr}/mlp/conv{i}"] = (f"{tp}.mlp_convs.{i}", "conv")
        spec[f"{tr}/mlp/bn{i}"] = (f"{tp}.mlp_bns.{i}", "bn")
    for i in range(3):  # weightnet 3->8->8->16
        spec[f"{tr}/weightnet/conv{i}"] = (
            f"{tp}.weightnet.mlp_convs.{i}", "conv")
        spec[f"{tr}/weightnet/bn{i}"] = (
            f"{tp}.weightnet.mlp_bns.{i}", "bn")
    for i in range(3):  # densitynet 1->16->8->1
        spec[f"{tr}/densitynet/conv{i}"] = (
            f"{tp}.densitynet.mlp_convs.{i}", "conv")
        spec[f"{tr}/densitynet/bn{i}"] = (
            f"{tp}.densitynet.mlp_bns.{i}", "bn")
    spec[f"{tr}/linear"] = (f"{tp}.linear", "linear")
    spec[f"{tr}/bn_linear"] = (f"{tp}.bn_linear", "bn")
    return spec


# The reference's torch state_dict layout as the tree's paths (JAX
# :256-285).
TORCH_SPEC = {
    **_stage_spec("sa1", "sa1", 3),
    **_stage_spec("sa2", "sa2", 3),
    **_stage_spec("sa3", "sa3", 3),
    "fc1": ("fc1", "linear"),
    "bn1": ("bn1", "bn"),
    "fc2": ("fc2", "linear"),
    "bn2": ("bn2", "bn"),
    "fc3": ("fc3", "linear"),
}
