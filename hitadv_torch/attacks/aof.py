"""The spectral attacks AOF (untargeted), TAOF (targeted) and UAEAOF
(untargeted, with an autoencoder) (port of `hitadv_tpu/attacks/aof.py`,
reference `CW/AOF.py:12-241`, `CW/TAOF.py`, `CW/UAEAOF.py`):
  * the graph: a kNN-30 mask (each point its own neighbour),
    symmetrised, with Gaussian weights exp(-|p_i - p_j|^2); the
    combinatorial Laplacian L = D - A (`CW/AOF.py:30-51`);
  * the cloud splits into a low- and a high-frequency part by the
    projector onto the ``low_pass`` eigenvectors of smallest eigenvalue;
  * only the low part is optimised; the loss mixes the whole cloud's and
    the low part's margins by GAMMA (UAEAOF adds the reconstruction's);
  * after each step the whole cloud is clipped and split again on the
    fixed basis (`:158-165`), so the high part drifts by the clip;
  * the binary steps are restarts.

The basis comes from `torch.linalg.eigh` (ascending, as ``torch.symeig``
and jnp.linalg.eigh) once a restart, outside the inner loop: the
solver's host sync is paid there, never inside an iteration. The
eigenvectors are fixed only up to sign and rotation inside a degenerate
eigenspace; the attack uses only the projector ``V V^T``, which is not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import torch

from hitadv_torch import resolve_device
from hitadv_torch.attacks.base import (
    AttackResult,
    BestState,
    Draws,
    adam_init,
    adam_update,
    update_best,
)
from hitadv_torch.ops import geometry as G
from hitadv_torch.parallel.shard import batch_draw, batch_mean

MODES = ("untargeted", "targeted", "ae_untargeted")
# the subspace solver's filter rounds, Chebyshev degree and guard vectors
# beyond the low band (the JAX package's defaults)
SUBSPACE_ROUNDS = 8
SUBSPACE_DEGREE = 12
SUBSPACE_GUARD = 32


@dataclass(frozen=True)
class AOFConfig:
    """Defaults of `CW/AOF.py:57-58`. ``eigensolver``: "eigh", the full
    dense decomposition, or "subspace", Chebyshev-filtered subspace
    iteration for the low band alone (`graph_laplacian_partial`)."""
    attack_lr: float = 1e-2
    binary_step: int = 2         # restarts, no weight schedule
    num_iter: int = 200
    gamma: float = 0.5
    low_pass: int = 100
    knn: int = 30
    mode: str = "untargeted"     # untargeted | targeted | ae_untargeted
    eigensolver: str = "eigh"    # eigh | subspace


def laplacian_matrix(pc: torch.Tensor, k: int = 30) -> torch.Tensor:
    """The kNN-masked Gaussian graph Laplacian L = D - A ``[B, N, N]``
    (reference `CW/AOF.py:30-48`): the k nearest of each point (itself
    included; the kNN kernel on the card), symmetrised, weighted by
    exp(-|p_i - p_j|^2)."""
    B, N, _ = pc.shape
    sq = G.pairwise_distance(pc)                              # [B, N, N]
    idx = G.knn_idx(pc, pc, k)                                # [B, N, k]
    mask = torch.zeros((B, N, N), dtype=pc.dtype, device=pc.device)
    mask.scatter_(2, idx.long(), 1.0)
    mask = torch.clamp_max(mask + mask.transpose(1, 2), 1.0)
    A = torch.exp(-sq) * mask
    return torch.diag_embed(torch.sum(A, dim=2)) - A


def graph_laplacian(pc: torch.Tensor, k: int = 30
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full eigendecomposition of the graph Laplacian: (eigenvalues
    ``[B, N]`` ascending, eigenvectors ``[B, N, N]``)."""
    return torch.linalg.eigh(laplacian_matrix(pc, k))


def _cheb_filter(L, Q, a, b, degree: int):
    """The degree-``degree`` Chebyshev polynomial of L on Q, mapped so
    that eigenvalues in [a, b] stay within 1 while those below ``a``
    grow as cosh(degree acosh(.)): a low-pass filter of matmuls."""
    c = ((a + b) / 2.0)[:, None, None]
    h = ((b - a) / 2.0)[:, None, None]
    X0, X1 = Q, (torch.matmul(L, Q) - c * Q) / h
    for _ in range(degree - 1):
        X0, X1 = X1, 2.0 * (torch.matmul(L, X1) - c * X1) / h - X0
    return X1


def graph_laplacian_partial(pc: torch.Tensor, k: int = 30,
                            low_pass: int = 100, *,
                            generator: torch.Generator
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``low_pass`` lowest eigenpairs of the graph Laplacian of ``pc``
    by `low_band_subspace`: (Ritz values ``[B, low_pass]`` ascending,
    basis ``[B, N, low_pass]``)."""
    return low_band_subspace(laplacian_matrix(pc, k), low_pass,
                             generator=generator)


def low_band_subspace(L: torch.Tensor, low_pass: int = 100, *,
                      generator: torch.Generator
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``low_pass`` lowest eigenpairs of the Laplacians ``L`` ``[B, N,
    N]`` by Chebyshev-filtered subspace iteration: each of
    `SUBSPACE_ROUNDS` rounds filters ``low_pass + SUBSPACE_GUARD``
    vectors (started from Gaussian draws of ``generator``) over [a,
    sigma], sigma the Gershgorin bound, orthonormalises them and sets
    ``a`` to the largest Ritz value. The
    attack uses only the span (its projector), so only the span has to
    converge. Returns (Ritz values ``[B, low_pass]`` ascending, basis
    ``[B, N, low_pass]``)."""
    B, N, _ = L.shape
    kg = min(low_pass + SUBSPACE_GUARD, N)
    # Gershgorin: lambda_max(L) <= max_i (L_ii + sum_j |A_ij|) = 2 max D_ii
    sigma = 2.0 * torch.amax(torch.diagonal(L, dim1=1, dim2=2), dim=1)
    Q = batch_draw(lambda s: torch.randn(s, generator=generator,
                                         dtype=L.dtype, device=L.device),
                   (B, N, kg))
    Q, _ = torch.linalg.qr(Q)

    def ritz(Q):
        T = torch.matmul(Q.transpose(1, 2), torch.matmul(L, Q))
        return torch.linalg.eigh((T + T.transpose(1, 2)) / 2.0)

    for _ in range(SUBSPACE_ROUNDS):
        e, _ = ritz(Q)
        # suppress [top Ritz value, sigma], kept below sigma so that the
        # map stays well conditioned
        a = torch.minimum(e[:, -1], 0.95 * sigma)
        Q, _ = torch.linalg.qr(_cheb_filter(L, Q, a, sigma,
                                            SUBSPACE_DEGREE))
    e, W = ritz(Q)
    return e[:, :low_pass], torch.matmul(Q, W[:, :, :low_pass])


def spectral_split(adv: torch.Tensor, V: torch.Tensor):
    """``adv`` ``[B, N, 3]`` -> (low part V V^T adv, the rest) on the low
    band's basis V ``[B, N, lp]`` (the same as projecting on the other
    eigenvectors, `CW/AOF.py:111-122`, since the full basis is
    orthonormal)."""
    lfc = torch.matmul(V, torch.matmul(V.transpose(1, 2), adv))
    return lfc, adv - lfc


def make_aof(logits_fn: Callable, adv_fn: Callable, clip_fn: Callable,
             cfg: AOFConfig = AOFConfig(), ae_fn: Optional[Callable] = None,
             *, init_overrides: Optional[Mapping] = None, device="cuda"):
    """Build AOF, TAOF or UAEAOF (``cfg.mode``).

    Args:
      logits_fn: victim ``[B, N, 3] -> [B, classes]`` on ``device``.
      adv_fn: per-example margin loss (the targeted sense for TAOF).
      clip_fn: ``(adv, ori) -> adv`` after every step and, but for TAOF
        (`CW/TAOF.py:232`), at the end.
      ae_fn: the reconstruction of UAEAOF (mode "ae_untargeted").
      init_overrides: optional ``{"noise": [S, B, N, 3]}`` pinning each
        restart's 1e-7 noise (`CW/AOF.py:110-111`); the basis is computed
        from the noisy cloud.
      device: where the attack runs; ``"cuda"`` unless the caller asks
        for the CPU.
    Returns:
      ``attack(points [B, N, >=3], labels, generator) -> AttackResult``;
      TAOF's low-part test (`CW/TAOF.py:203`) compares with the same
      labels, as the JAX package's does without its ``y_truth``.
      ``generator`` may be None only with ``init_overrides`` and the
      "eigh" solver.
    """
    if cfg.mode not in MODES:
        raise ValueError(f"AOF mode {cfg.mode!r}")
    if cfg.eigensolver not in ("eigh", "subspace"):
        raise ValueError(f"AOF eigensolver {cfg.eigensolver!r}")
    if cfg.mode == "ae_untargeted" and ae_fn is None:
        raise ValueError("ae_untargeted mode requires ae_fn")
    dev = resolve_device(device)
    draws = Draws(init_overrides, ("noise",), dev)
    lp, g = cfg.low_pass, cfg.gamma
    with_ae = cfg.mode == "ae_untargeted"

    def low_band_basis(pc, generator):
        if cfg.eigensolver == "subspace":
            return graph_laplacian_partial(pc, cfg.knn, lp,
                                           generator=generator)[1]
        return graph_laplacian(pc, cfg.knn)[1][:, :, :lp]

    def success_mask(pred, lfc_pred, ae_pred, labels):
        if cfg.mode == "targeted":
            return (pred == labels) & (lfc_pred != labels)
        if with_ae:
            return (pred != labels) & (lfc_pred != labels) \
                & (ae_pred != labels)
        ok = pred != labels
        return ok & (lfc_pred != labels) if g >= 0.001 else ok

    def attack(points, labels, generator: Optional[torch.Generator] = None
               ) -> AttackResult:
        draws.check(generator)
        if cfg.eigensolver == "subspace" and generator is None:
            raise ValueError("attack: the subspace solver draws its start "
                             "from a torch.Generator; pass one")
        points = torch.as_tensor(points, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev).long()
        ori = points[..., :3].contiguous()

        def loss_fn(lfc, hfc):
            full_logits = logits_fn(lfc + hfc)
            lfc_logits = logits_fn(lfc)
            if with_ae:
                # (1 - 2 GAMMA) full + GAMMA ae + GAMMA lfc
                # (`CW/UAEAOF.py:143-162`)
                ae_logits = logits_fn(ae_fn(lfc + hfc))
                loss = ((1.0 - 2.0 * g) * batch_mean(adv_fn(full_logits,
                                                             labels))
                        + g * batch_mean(adv_fn(ae_logits, labels)))
            else:
                # (1 - GAMMA) full + GAMMA lfc (`CW/AOF.py:143-150`)
                ae_logits = full_logits
                loss = (1.0 - g) * batch_mean(adv_fn(full_logits, labels))
            loss = loss + g * batch_mean(adv_fn(lfc_logits, labels))
            return loss, (full_logits, lfc_logits, ae_logits)

        o_best = BestState.init(ori)
        adv = torch.zeros_like(ori)
        for step in range(cfg.binary_step):
            adv0 = ori + draws.noise(ori.shape, generator, step)
            with torch.no_grad():
                V = low_band_basis(adv0, generator)
            lfc, hfc = spectral_split(adv0, V)
            opt = adam_init(lfc)
            for _ in range(cfg.num_iter):
                with torch.enable_grad():
                    x = lfc.detach().requires_grad_(True)
                    loss, stale = loss_fn(x, hfc)
                    (grad,) = torch.autograd.grad(loss, x)
                with torch.no_grad():
                    lfc, opt = adam_update(grad, opt, lfc, cfg.attack_lr)
                    lfc, hfc = spectral_split(clip_fn(lfc + hfc, ori), V)
                    adv = lfc + hfc
                    if with_ae:
                        # UAEAOF pairs the predictions before the step with
                        # the clipped cloud after it (`CW/UAEAOF.py:
                        # 179-205`); AOF and TAOF recompute (`CW/AOF.py:
                        # 171-183`)
                        pred, lfc_pred, ae_pred = (
                            torch.argmax(t, dim=-1) for t in stale)
                    else:
                        pred = torch.argmax(logits_fn(adv), dim=-1)
                        lfc_pred = torch.argmax(logits_fn(lfc), dim=-1)
                        ae_pred = pred
                    dist = torch.sqrt(torch.sum((adv - ori) ** 2,
                                                dim=(1, 2)))
                    ok = success_mask(pred, lfc_pred, ae_pred, labels)
                    o_best = update_best(o_best, ok, dist, pred, adv)

        # failures fall back to the last iterate, then the final clip
        # (`CW/AOF.py:224-231`), which TAOF alone skips
        found = o_best.score >= 0
        adv_final = torch.where(found[:, None, None], o_best.adv, adv)
        if cfg.mode != "targeted":
            adv_final = clip_fn(adv_final, ori)
        with torch.no_grad():
            pred = torch.argmax(logits_fn(adv_final), dim=-1)
        success = ((pred == labels) if cfg.mode == "targeted"
                   else (pred != labels))
        return AttackResult(adv_points=adv_final, success=success,
                            pred=pred)

    return attack
