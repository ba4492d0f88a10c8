"""Functional layers on parameter dicts, eval mode.

Port of `hitadv_tpu/nn/functional.py` for inference: pointwise conv
(= linear), the general 1D conv over the point axis, eval-mode BN, BN
folded into the preceding linear, the STN-transform fold, ReLU and
LeakyReLU, the conv-BN-act stack, the neighbour max with the reference's
tie-splitting gradient, and the fused conv + global max-pool over the
max-linear kernels.

Parameters are mappings of tensors in the reference's layout: a linear or
1x1-conv is ``{"w": [Cin, Cout], "b": [Cout]}``, a BN is
``{"scale", "bias", "mean", "var"}`` of ``[C]``. Plain dicts work, and so
do the `nn.ParameterDict`s a model registers them in.

``compute_dtype`` (None for f32, or ``torch.bfloat16``) is the dtype of
the activations between layers; products accumulate in f32 either way
and are rounded once, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import torch

from hitadv_torch.ops import geometry as G
from hitadv_torch.ops import kernels as K

Params = Mapping[str, torch.Tensor]


def _cast(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    if compute_dtype is not None and x.dtype != compute_dtype:
        return x.to(compute_dtype)
    return x


# ---------------------------------------------------------------------------
# Initialisers (PyTorch's Conv1d/Linear defaults)
# ---------------------------------------------------------------------------

def linear_init(in_features: int, out_features: int, *,
                generator: torch.Generator, device,
                bias: bool = True) -> Dict[str, torch.Tensor]:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and (optional) bias —
    the kaiming-uniform(a=sqrt(5)) default of torch's Linear and Conv1d."""
    bound = 1.0 / math.sqrt(in_features)

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (2.0 * bound) - bound

    p = {"w": uniform(in_features, out_features)}
    if bias:
        p["b"] = uniform(out_features)
    return p


conv1x1_init = linear_init


def conv1d_init(in_channels: int, out_channels: int, kernel_size: int, *,
                generator: torch.Generator, device,
                bias: bool = True) -> Dict[str, torch.Tensor]:
    """A general 1D conv's ``{"w": [K, Cin, Cout], "b": [Cout]}`` (torch's
    ``[Cout, Cin, K]`` transposed, as the checkpoint converter gives it),
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in = Cin K."""
    bound = 1.0 / math.sqrt(in_channels * kernel_size)

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (2.0 * bound) - bound

    p = {"w": uniform(kernel_size, in_channels, out_channels)}
    if bias:
        p["b"] = uniform(out_channels)
    return p


def batchnorm_init(c: int, *, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device),
            "var": torch.ones(c, device=device)}


def mlp_init(channels: Sequence[int], *, generator: torch.Generator,
             device) -> Dict[str, Dict]:
    """A stack of (1x1 conv + BN): ``conv{i}``/``bn{i}`` for channels
    [c0, c1, ..., ck]."""
    params = {}
    for i, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
        params[f"conv{i}"] = conv1x1_init(cin, cout, generator=generator,
                                          device=device)
        params[f"bn{i}"] = batchnorm_init(cout, device=device)
    return params


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def relu(x: torch.Tensor) -> torch.Tensor:
    """``maximum(x, 0)``: at x == 0 the gradient splits in half, as
    jnp.maximum's does (torch.relu would give 0)."""
    return torch.maximum(x, x.new_zeros(()))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2
               ) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)`` (DGCNN's LeakyReLU(0.2)); the
    gradient at 0 is 1, as the reference's."""
    return torch.where(x >= 0, x, negative_slope * x)


def max_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``max`` over ``axis`` whose gradient splits among exact ties,
    ``mask * (g / count)`` (reference custom VJP, :233-259). This is
    `torch.amax`'s own backward; `torch.max(dim)` would send the whole
    cotangent to one slot. The ball query pads short balls with their
    first index, so duplicated neighbours, and exact ties, are common."""
    return torch.amax(x, dim=axis)


def max_mid(x: torch.Tensor) -> torch.Tensor:
    """The neighbour-axis max of grouped features ``[..., ns, C] -> [...,
    C]`` (reference :262-267)."""
    return max_axis(x, -2)


def linear(p: Params, x, compute_dtype=None) -> torch.Tensor:
    """``[..., Cin] -> [..., Cout]``; ``x`` may be a tuple of
    channel-partitioned parts (`linear_parts`)."""
    if isinstance(x, (tuple, list)):
        return linear_parts(p, x, compute_dtype)
    if compute_dtype is not None:
        y = torch.matmul(_cast(x, compute_dtype), _cast(p["w"], compute_dtype))
        return y + _cast(p["b"], compute_dtype) if "b" in p else y
    y = torch.matmul(x, p["w"])
    return y + p["b"] if "b" in p else y


def linear_parts(p: Params, parts: Sequence[torch.Tensor],
                 compute_dtype=None) -> torch.Tensor:
    """Linear over ``concat(parts, -1)`` without building the concat:
    ``sum_i parts_i @ W[off_i:off_i + C_i]``, partials summed in f32."""
    w = p["w"]
    off, y = 0, None
    for x in parts:
        c = x.shape[-1]
        wi = w[off:off + c]
        if compute_dtype is not None:
            # f32 partials of the low-precision operands
            yi = torch.matmul(_cast(x, compute_dtype).float(),
                              _cast(wi, compute_dtype).float())
        else:
            yi = torch.matmul(x, wi)
        y = yi if y is None else y + yi
        off += c
    if off != w.shape[0]:
        raise ValueError(
            f"parts supply {off} channels, weight expects {w.shape[0]}")
    if compute_dtype is not None:
        y = y.to(compute_dtype)
        return y + _cast(p["b"], compute_dtype) if "b" in p else y
    return y + p["b"] if "b" in p else y


def conv1d(p: Params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """1D conv over the point axis, ``[B, N, Cin] -> [B, N, Cout]``, with
    the reference's "SAME" zero padding ((K - 1) // 2 before, the rest
    after; reference :129-156, ``lax.conv_general_dilated`` in the layout
    NWC/WIO/NWC). Plain XLA in the reference, `torch.nn.functional.
    conv1d` (cuDNN on the card, TF32 off) here; with ``compute_dtype`` the
    operands are cast to it and the product accumulates in f32."""
    w = p["w"]                                               # [K, Cin, Cout]
    k = w.shape[0]
    left = (k - 1) // 2
    xt = _cast(x, compute_dtype).transpose(1, 2)             # [B, Cin, N]
    xt = torch.nn.functional.pad(xt, (left, k - 1 - left))
    y = torch.nn.functional.conv1d(
        xt, _cast(w, compute_dtype).permute(2, 1, 0)).transpose(1, 2)
    if "b" in p:
        y = y + _cast(p["b"], compute_dtype)
    return y


def batchnorm(p: Params, x: torch.Tensor, compute_dtype=None,
              eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BN over the trailing channel axis, in f32, the result in
    ``compute_dtype`` (reference :200-226)."""
    inv = torch.rsqrt(p["var"] + eps)
    y = (x.float() - p["mean"]) * (inv * p["scale"]) + p["bias"]
    return _cast(y, compute_dtype)


def fold_bn(lin: Params, bn: Params, eps: float = 1e-5
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an eval-mode BN into the preceding linear: bn(xW + b) =
    x(W s) + ((b - mean) s + beta), s = scale / sqrt(var + eps)."""
    s = bn["scale"] * torch.rsqrt(bn["var"] + eps)
    b = bn["bias"] - bn["mean"] * s
    if "b" in lin:
        b = b + lin["b"] * s
    return lin["w"] * s[None], b


def linear_bn(lin: Params, bn: Params, x: torch.Tensor,
              compute_dtype=None, eps: float = 1e-5) -> torch.Tensor:
    """linear then eval-mode BN, the BN folded into the product."""
    w, b = fold_bn(lin, bn, eps)
    return linear({"w": w, "b": b}, x, compute_dtype)


def linear_bn_pre(lin: Params, bn: Params, pre: torch.Tensor,
                  x: torch.Tensor, compute_dtype=None,
                  eps: float = 1e-5) -> torch.Tensor:
    """``bn(linear(lin, x @ pre))`` with the per-example ``[k, k]``
    transform folded into the weight: ``x @ (pre @ W) + b`` (the PointNet
    STN pattern)."""
    w, b = fold_bn(lin, bn, eps)
    wb = torch.matmul(pre.float(), w)                        # [B, k, Cout]
    if compute_dtype is not None:
        y = torch.matmul(_cast(x, compute_dtype), _cast(wb, compute_dtype))
        return y + _cast(b, compute_dtype)
    return torch.matmul(x, wb) + b


def mlp_apply(params: Mapping[str, Params], x, compute_dtype=None,
              start: int = 0) -> torch.Tensor:
    """The conv-BN-ReLU stack ``conv{i}``/``bn{i}`` with each eval BN
    folded into its linear (reference :444-470). ``start`` skips the
    first layers (a caller that fused layer 0 into its gather passes 1,
    and ``x`` is then that layer's activated output). ``x`` may be a
    tuple of parts for `linear_parts`."""
    for i in range(start, len(params) // 2):
        x = relu(linear_bn(params[f"conv{i}"], params[f"bn{i}"], x,
                           compute_dtype))
    return x


class _MaxLinear(torch.autograd.Function):
    """``max_n (x @ w)[:, n, :] + b`` over the max-linear kernels.

    Forward: `kernels.max_linear` keeps the running (max, first-argmax
    row) per column, so the [B, N, C] product never exists. Backward
    (reference functional.py:402-413): the cotangent goes to the one
    argmax row per (b, c) — torch.max's routing; jnp.max's autodiff
    would split it among exact ties — through `kernels.max_linear_dh`.
    dW takes the argmax rows through the gather kernel; it and db are
    computed only when w and b need a gradient.
    """

    @staticmethod
    def forward(ctx, x, w, b):
        vmax, row = K.max_linear(x, w, b)
        ctx.save_for_backward(x, w, row)
        return vmax

    @staticmethod
    def backward(ctx, g):
        x, w, row = ctx.saved_tensors
        gf = g.float().contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = K.max_linear_dh(row, gf, w, x.shape[1]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            xsel = G.index_points(x, row).float()            # [B, C, K]
            dw = torch.einsum("bck,bc->kc", xsel, gf).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = gf.sum(0)
        return dx, dw, db


def linear_bn_max(lin: Params, bn: Params, x: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """``max_n bn(x @ W + b)[:, n, :]`` -> ``[B, C]`` f32: the conv +
    global max-pool bottleneck (PointNet conv3 + torch.max), fused. The
    folded weight is cast to x's dtype; the bias stays f32."""
    w, b = fold_bn(lin, bn, eps)
    return _MaxLinear.apply(x.contiguous(), w.to(x.dtype).contiguous(),
                            b.float().contiguous())
