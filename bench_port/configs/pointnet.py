"""PointNet: its parameter tree, its victim in the port, and the model
FLOPs of its passes (see `configs/pointnet.json`)."""

from __future__ import annotations

from bench_port.trees import batchnorm, linear


def _tnet(c, cin, k):
    conv, widths = {}, [cin] + list(c["tnet_conv"])
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        conv[f"conv{i}"], conv[f"bn{i}"] = linear(a, b), batchnorm(b)
    f1, f2 = c["tnet_fc"]
    return {"conv": conv, "fc1": linear(widths[-1], f1), "bn4": batchnorm(f1),
            "fc2": linear(f1, f2), "bn5": batchnorm(f2),
            "fc3": linear(f2, k * k)}


def tree(c: dict) -> dict:
    """The parameter tree in the port's layout: each leaf ``("uniform",
    shape, fan_in)`` or ``("const", shape, value)``."""
    cin, m1 = c["input_channels"], c["mlp1"][0]
    m2a, m2b = c["mlp2"]
    h1, h2 = c["head_fc"]
    return {"stn": _tnet(c, cin, cin), "conv1": linear(cin, m1),
            "bn1": batchnorm(m1), "fstn": _tnet(c, m1, m1),
            "conv2": linear(m1, m2a), "bn2": batchnorm(m2a),
            "conv3": linear(m2a, m2b), "bn3": batchnorm(m2b),
            "head_fc1": linear(m2b, h1), "head_bn1": batchnorm(h1),
            "head_fc2": linear(h1, h2), "head_bn2": batchnorm(h2),
            "head_fc3": linear(h2, c["num_classes"])}


def port_victim(c: dict, params: dict, device):
    """The port's PointNet on ``params``, float32."""
    from hitadv_torch.models import PointNet

    return PointNet(params=params, device=device)


def _tnet_flops(c, cin, k, n):
    widths = [cin] + list(c["tnet_conv"])
    f1, f2 = c["tnet_fc"]
    conv = sum(2 * n * a * b for a, b in zip(widths[:-1], widths[1:]))
    return conv + 2 * (widths[-1] * f1 + f1 * f2 + f2 * k * k)


def forward_flops(c: dict, n: int) -> float:
    """One cloud of ``n`` points: every matrix product and 1x1 conv, with
    each transform folded into the next layer's weight (``x (T W)``, the
    least work)."""
    cin, m1 = c["input_channels"], c["mlp1"][0]
    m2a, m2b = c["mlp2"]
    h1, h2 = c["head_fc"]
    return (_tnet_flops(c, cin, cin, n) + 2 * cin * cin * m1
            + 2 * n * cin * m1 + _tnet_flops(c, m1, m1, n)
            + 2 * m1 * m1 * m2a + 2 * n * m1 * m2a + 2 * n * m2a * m2b
            + 2 * (m2b * h1 + h1 * h2 + h2 * c["num_classes"]))


def input_grad_flops(c: dict, n: int) -> float:
    """The input gradient of one cloud, counted only where every row needs
    it: the fully connected layers and each global max-pool's own
    backward, one row per channel. The layers under a max-pool are not
    counted: only the rows its arg-maxes pick need their gradient, and
    how many those are depends on the data."""
    m2b = c["mlp2"][-1]
    h1, h2 = c["head_fc"]
    t = c["tnet_conv"][-1]
    f1, f2 = c["tnet_fc"]
    cin, m1 = c["input_channels"], c["mlp1"][0]
    tnet = sum(2 * (t * f1 + f1 * f2 + f2 * k * k) + 2 * c["tnet_conv"][-2]
               * t for k in (cin, m1))
    return tnet + 2 * (m2b * h1 + h1 * h2 + h2 * c["num_classes"]) \
        + 2 * c["mlp2"][0] * m2b
