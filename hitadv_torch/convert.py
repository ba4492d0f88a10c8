"""Checkpoint conversion: ``python -m hitadv_torch.convert``, and the JAX
package's parameter trees carried across.

`convert` (port of `hitadv_tpu/convert.py`) reads one of the reference's
torch checkpoints (``state_dict['model_state_dict']`` / ``['last']``
wrappers, `eval.py:123-124`), converts it by the victim's
``TORCH_SPEC`` into the channels-last tree both packages consume, pickles
it (`utils.checkpoint.save_params`), and checks that the victim built
from it gives finite logits on a random batch, on the card unless
``--device cpu`` is given. The JAX CLI's ``--orbax`` (an orbax
checkpoint, JAX machinery) is refused.

A `hitadv_tpu` parameter tree is nested dicts of arrays in the
channels-last layout both packages use (``w`` as ``[Cin, Cout]``, ``b``,
and BN ``scale/bias/mean/var``). ``jax.tree_util.tree_map(np.asarray,
params)`` gives it as numpy, and ``hitadv_tpu.utils.checkpoint.
save_params`` pickles exactly that (`hitadv_torch.utils.checkpoint.
load_params` reads it). Loaded here, the same tree makes both packages
compute the same function.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from hitadv_torch import resolve_device

ORBAX_REFUSED = ("--orbax writes an orbax checkpoint, which is JAX "
                 "machinery: this converter writes the pickled tree that "
                 "both packages load (utils.checkpoint.save_params)")


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


def tree_from_torch(model: str, src: str) -> Dict:
    """The reference's torch checkpoint ``src`` of victim ``model`` as a
    numpy tree, by the victim's ``TORCH_SPEC``."""
    from hitadv_torch import models
    from hitadv_torch.utils import checkpoint as ckpt

    return ckpt.convert_state_dict(ckpt.load_torch_state_dict(src),
                                   models.torch_spec(model))


def convert(model: str, src: str, dst: str, device="cuda") -> Dict:
    """The torch checkpoint ``src`` of victim ``model`` as a tree, pickled
    to ``dst`` (reference :28-50); the victim built from it on
    ``device`` must give finite logits on a random [2, 128, 3] batch.
    Returns the numpy tree."""
    from hitadv_torch.models import get_model
    from hitadv_torch.utils import checkpoint as ckpt

    dev = resolve_device(device)
    params = tree_from_torch(model, src)
    ckpt.save_params(dst, params)

    x = torch.from_numpy(np.random.RandomState(0).randn(2, 128, 3).astype(
        np.float32) * 0.5).to(dev)
    victim = get_model(model)(params=params_from_numpy(params, dev),
                              device=dev)
    with torch.no_grad():
        logits = victim(x)
    if not bool(torch.isfinite(logits).all()):
        raise ValueError(f"{src}: the converted {model} gives non-finite "
                         "logits")
    print(f"converted {src} -> {dst} (logits {tuple(logits.shape)} "
          "finite)")
    return params


def main(argv: Optional[list] = None) -> Dict:
    from hitadv_torch import models

    p = argparse.ArgumentParser("hitadv_torch convert")
    p.add_argument("--model", required=True, choices=models.names())
    p.add_argument("--src", required=True, help="torch checkpoint path")
    p.add_argument("--dst", required=True, help="output tree path (.pkl)")
    p.add_argument("--orbax", action="store_true",
                   help="refused: JAX machinery")
    p.add_argument("--device", default="cuda",
                   help="where the check's forward runs: cuda (the "
                        "default) or cpu")
    args = p.parse_args(argv)
    if args.orbax:
        p.error(ORBAX_REFUSED)
    return convert(args.model, args.src, args.dst, args.device)


if __name__ == "__main__":
    main()
