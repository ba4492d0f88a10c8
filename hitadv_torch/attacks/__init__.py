"""Attacks. Only HiT-ADV, the flagship, is ported so far."""

from hitadv_torch.attacks.base import AttackResult, make_adv_fn  # noqa: F401
from hitadv_torch.attacks.hit_adv import HiTADVConfig, make_hit_adv  # noqa: F401
