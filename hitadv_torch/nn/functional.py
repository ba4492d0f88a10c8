"""Functional layers on parameter dicts, eval mode.

Port of `hitadv_tpu/nn/functional.py` for inference: pointwise conv
(= linear), BN folded into the preceding linear, the STN-transform fold,
and the fused conv + global max-pool over the max-linear kernels.

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
                generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias — the
    kaiming-uniform(a=sqrt(5)) default of torch's Linear and Conv1d."""
    bound = 1.0 / math.sqrt(in_features)

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (2.0 * bound) - bound

    return {"w": uniform(in_features, out_features),
            "b": uniform(out_features)}


conv1x1_init = linear_init


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
