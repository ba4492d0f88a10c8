"""Parameter trees: the leaves a configuration module lists, and the
tree the benchmark draws from them on the device in a few large calls."""

from __future__ import annotations

import numpy as np
import torch


def linear(cin: int, cout: int, bias: bool = True) -> dict:
    """A linear or 1x1 conv, ``w`` as ``[Cin, Cout]``, PyTorch's default
    initialisation."""
    p = {"w": ("uniform", (cin, cout), cin)}
    if bias:
        p["b"] = ("uniform", (cout,), cin)
    return p


def batchnorm(c: int) -> dict:
    """A batch norm at its initial running statistics."""
    return {"scale": ("const", (c,), 1.0), "bias": ("const", (c,), 0.0),
            "mean": ("const", (c,), 0.0), "var": ("const", (c,), 1.0)}


def make_tree(spec: dict, generator: torch.Generator, device) -> dict:
    """The parameter tree of ``spec`` from ``generator``: every uniform
    leaf is a slice of one draw, scaled in one call to within
    ``1/sqrt(fan_in)`` (PyTorch's default), every constant a slice of one
    filled buffer."""
    leaves = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves.append((path + (k,), v))

    walk(spec, ())
    uni = [(p, leaf) for p, leaf in leaves if leaf[0] == "uniform"]
    const = [(p, leaf) for p, leaf in leaves if leaf[0] == "const"]
    sizes_u = [int(np.prod(leaf[1])) for _, leaf in uni]
    sizes_c = [int(np.prod(leaf[1])) for _, leaf in const]
    bounds = torch.tensor([1.0 / np.sqrt(leaf[2]) for _, leaf in uni],
                          dtype=torch.float32, device=device)
    values = torch.tensor([float(leaf[2]) for _, leaf in const],
                          dtype=torch.float32, device=device)
    scale = torch.repeat_interleave(
        bounds, torch.tensor(sizes_u, device=device))
    u = (torch.rand(sum(sizes_u), generator=generator, device=device)
         * 2.0 - 1.0) * scale
    c = torch.repeat_interleave(values, torch.tensor(sizes_c, device=device))
    tree: dict = {}
    for (items, buf, sizes) in ((uni, u, sizes_u), (const, c, sizes_c)):
        off = 0
        for (path, leaf), n in zip(items, sizes):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = buf[off:off + n].view(leaf[1])
            off += n
    return tree
