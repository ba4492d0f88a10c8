"""Victim checkpoints (port of `hitadv_tpu/utils/checkpoint.py`).

Two formats load into the port's models:
  * pickled numpy parameter trees (`save_params` / `load_params`), the
    JAX package's ``save_params`` format, nested dicts of arrays in the
    channels-last layout both packages use;
  * the reference's torch checkpoints (`eval.py:79,123`), converted once
    into such a tree by `convert_state_dict` and each model's
    ``TORCH_SPEC``, which maps tree paths to (torch key prefix, kind):
      - Conv1d ``[Cout, Cin, 1]`` / Conv2d ``[Cout, Cin, 1, 1]`` ->
        ``[Cin, Cout]``;
      - Linear ``[Cout, Cin]`` -> ``[Cin, Cout]``;
      - BatchNorm ``weight/bias/running_mean/running_var`` ->
        ``scale/bias/mean/var``.
A tree goes to a device through `hitadv_torch.convert.params_from_numpy`.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

Kind = str  # "conv" | "conv1d" | "linear" | "bn"


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's tensors as numpy, unwrapping the reference's
    'model_state_dict' / 'last' / 'state_dict' keys (`eval.py:123-124`).
    Loads tensors and plain containers only (``weights_only``)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("model_state_dict", "last", "state_dict"):
        if isinstance(state, dict) and wrapper in state:
            state = state[wrapper]
            break
    return {k: v.detach().cpu().numpy() for k, v in state.items()
            if isinstance(v, torch.Tensor)}


def _convert_leaf(sd: Mapping[str, np.ndarray], prefix: str,
                  kind: Kind) -> Dict[str, np.ndarray]:
    if kind == "bn":
        return {"scale": np.asarray(sd[f"{prefix}.weight"]),
                "bias": np.asarray(sd[f"{prefix}.bias"]),
                "mean": np.asarray(sd[f"{prefix}.running_mean"]),
                "var": np.asarray(sd[f"{prefix}.running_var"])}
    w = np.asarray(sd[f"{prefix}.weight"])
    if kind == "conv":
        w = w.reshape(w.shape[0], w.shape[1]).T              # drop 1(x1)
    elif kind == "conv1d":
        w = w.transpose(2, 1, 0)                             # [K, Cin, Cout]
    elif kind == "linear":
        w = w.T
    else:
        raise ValueError(kind)
    out = {"w": w}
    if f"{prefix}.bias" in sd:
        out["b"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def convert_state_dict(sd: Mapping[str, np.ndarray],
                       spec: Mapping[str, Tuple[str, Kind]]) -> Dict:
    """A nested numpy tree from a flat state dict: ``spec`` maps
    slash-separated tree paths to (torch prefix, kind), e.g.
    ``{"stn/conv/conv0": ("feat.stn.conv1", "conv"), ...}``."""
    params: Dict[str, Any] = {}
    for path, (prefix, kind) in spec.items():
        node = params
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _convert_leaf(sd, prefix, kind)
    return params


def _to_numpy(tree: Mapping) -> Dict:
    return {k: (_to_numpy(v) if isinstance(v, Mapping)
                else v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in tree.items()}


def save_params(path: str, params: Mapping) -> None:
    """Pickle a parameter tree (tensors or arrays) as numpy arrays."""
    with open(path, "wb") as f:
        pickle.dump(_to_numpy(params), f)


def load_params(path: str) -> Dict:
    """A parameter tree pickled by `save_params` or by the JAX package's
    ``save_params`` (numpy arrays only). Only load files this project
    wrote: unpickling runs code."""
    with open(path, "rb") as f:
        return pickle.load(f)
