"""Carry the JAX package's parameter trees across.

A `hitadv_tpu` parameter tree is nested dicts of arrays in the
channels-last layout both packages use (``w`` as ``[Cin, Cout]``, ``b``,
and BN ``scale/bias/mean/var``). ``jax.tree_util.tree_map(np.asarray,
params)`` gives it as numpy, and ``hitadv_tpu.utils.checkpoint.
save_params`` pickles exactly that (`hitadv_torch.utils.checkpoint.
load_params` reads it). Loaded here, the same tree makes both packages
compute the same function.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from hitadv_torch import resolve_device


def params_from_numpy(tree: Mapping, device="cuda") -> Dict:
    """Nested dicts of numpy arrays -> the same nesting of f32 tensors on
    ``device`` (pass the result as ``PointNet(params=...)``)."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = params_from_numpy(v, dev)
        else:
            out[k] = torch.from_numpy(
                np.array(v, dtype=np.float32, copy=True)).to(dev)
    return out
