"""Point-cloud autoencoder, AdvPC's reconstruction network (port of
`hitadv_tpu/models/autoencoder.py`).

The reference loads a pretrained AE distributed out of band
(`CW/AdvPC.py:14-30`); the JAX package defines the AdvPC-style one: a
PointNet-style encoder (the shared conv-BN-ReLU stack 3 -> 64 -> 128 ->
latent and a global max) and a fully connected decoder (latent -> 1024
-> 1024 -> N * 3). I/O is ``[B, N, 3] -> [B, N, 3]``. `fit` trains it on
the Chamfer reconstruction objective where no checkpoint exists.

The functions take the parameter tree (nested dicts of tensors, the JAX
tree's layout) so that `fit` can differentiate it; `AutoEncoder` holds a
tree as frozen parameters for the attacks. The encoder's global max is a
plain ``amax`` (jnp.max in the JAX package: no fused kernel there).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from hitadv_torch import resolve_device
from hitadv_torch.attacks.base import adam_init, adam_update
from hitadv_torch.losses import chamfer_dist
from hitadv_torch.models.pointnet import _register, _tree_to
from hitadv_torch.nn import functional as F


def init_params(num_points: int = 1024, latent: int = 1024, *,
                generator: torch.Generator, device) -> Dict:
    """A fresh parameter tree with PyTorch's default initialisation."""
    kw = dict(generator=generator, device=device)
    return {
        "enc": F.mlp_init([3, 64, 128, latent], **kw),
        "dec_fc1": F.linear_init(latent, 1024, **kw),
        "dec_fc2": F.linear_init(1024, 1024, **kw),
        "dec_fc3": F.linear_init(1024, num_points * 3, **kw),
    }


def encode(params: Mapping, x: torch.Tensor,
           compute_dtype=None) -> torch.Tensor:
    """``[B, N, 3] -> [B, latent]``."""
    h = F.mlp_apply(params["enc"], x, compute_dtype)          # [B, N, L]
    return torch.amax(h, dim=1)


def apply(params: Mapping, x: torch.Tensor,
          compute_dtype=None) -> torch.Tensor:
    """Reconstruct ``[B, N, 3] -> [B, N, 3]`` f32. With a bf16
    ``compute_dtype`` the decoder's bf16 output is widened exactly, as
    jnp's promotion widens it wherever it meets an f32 cloud."""
    B, N, _ = x.shape
    z = encode(params, x, compute_dtype)
    h = F.relu(F.linear(params["dec_fc1"], z, compute_dtype))
    h = F.relu(F.linear(params["dec_fc2"], h, compute_dtype))
    out = F.linear(params["dec_fc3"], h, compute_dtype)
    return out.reshape(B, N, 3).float()


def reconstruction_loss(params: Mapping, x: torch.Tensor,
                        compute_dtype=None) -> torch.Tensor:
    """The two-sided Chamfer reconstruction objective (a scalar)."""
    return torch.mean(chamfer_dist(apply(params, x, compute_dtype), x,
                                   method="both"))


def _leaves(tree, prefix=()):
    """(path, tensor) of every leaf in sorted-path order; ``tree`` is a
    nested mapping, or the module dicts a model registers it in."""
    for k in sorted(tree.keys()):
        v = tree[k]
        if isinstance(v, (Mapping, nn.Module)):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflatten(paths, values) -> Dict:
    out: Dict = {}
    for path, v in zip(paths, values):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def fit_step(params: Mapping, opt_states, batch: torch.Tensor,
             lr: float = 1e-3, compute_dtype=None):
    """One Adam step of `reconstruction_loss` over every leaf of the tree
    (BN statistics included, as the JAX package's ``jax.grad`` over the
    whole tree): (new tree, new Adam states). ``opt_states`` is one
    `AdamState` per leaf in sorted-path order, as `fit` makes them."""
    paths, leaves = zip(*_leaves(params))
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in leaves]
        loss = reconstruction_loss(_unflatten(paths, xs), batch,
                                   compute_dtype)
        grads = torch.autograd.grad(loss, xs)
    with torch.no_grad():
        new = [adam_update(g, s, p, lr)
               for g, s, p in zip(grads, opt_states, leaves)]
    return (_unflatten(paths, [p for p, _ in new]), [s for _, s in new])


def fit(params: Mapping, clouds: torch.Tensor, generator: torch.Generator,
        steps: int = 200, batch_size: int = 16, lr: float = 1e-3,
        compute_dtype=None) -> Dict:
    """Adam on `reconstruction_loss` for ``steps`` steps, each on
    ``batch_size`` clouds drawn with replacement by ``generator`` (on
    the clouds' device). Returns the fitted tree."""
    opt_states = [adam_init(v) for _, v in _leaves(params)]
    n = clouds.shape[0]
    for _ in range(steps):
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=clouds.device)
        params, opt_states = fit_step(params, opt_states, clouds[idx], lr,
                                      compute_dtype)
    return params


class AutoEncoder(nn.Module):
    """``AutoEncoder(num_points)(x [B, N, 3]) -> [B, N, 3]``, frozen.

    Args:
      num_points, latent: the architecture (ignored when ``params`` is
        given).
      compute_dtype: None (f32) or ``torch.bfloat16`` activations.
      device: where the parameters live; ``"cuda"`` unless the caller
        asks for the CPU.
      generator: the source of a fresh initialisation; a generator seeded
        with 0 on ``device`` when None.
      params: a parameter tree to load instead (`fit`'s result, or
        `hitadv_torch.convert.params_from_numpy` of a saved one).
    """

    def __init__(self, num_points: int = 1024, latent: int = 1024, *,
                 compute_dtype: Optional[torch.dtype] = None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 params: Optional[Mapping] = None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            params = init_params(num_points, latent, generator=generator,
                                 device=dev)
        else:
            params = _tree_to(params, dev)
        self.params = _register(params)
        self.compute_dtype = compute_dtype
        self.eval()

    def tree(self) -> Dict:
        """The parameters as a plain tree (for `fit` and `save_params`)."""
        return _unflatten(*zip(*((p, v.detach())
                                 for p, v in _leaves(self.params))))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return encode(self.params, x, self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The reconstruction — the JAX package's ``autoencoder.apply``
        (the name `nn.Module.apply` is taken)."""
        return apply(self.params, x, self.compute_dtype)

    def reconstruction_loss(self, x: torch.Tensor) -> torch.Tensor:
        return reconstruction_loss(self.params, x, self.compute_dtype)
