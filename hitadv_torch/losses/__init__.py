"""Losses of the HiT-ADV path."""

from hitadv_torch.losses.adversarial import (  # noqa: F401
    cross_entropy_loss,
    logits_adv_loss,
    untargeted_logits_adv_loss,
)
from hitadv_torch.losses.distance import get_kappa, get_kappa_std  # noqa: F401
