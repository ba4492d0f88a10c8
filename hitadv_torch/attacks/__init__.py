"""Attacks. HiT-ADV (the flagship) and the CW attacks are ported so far."""

from hitadv_torch.attacks.base import AttackResult, make_adv_fn  # noqa: F401
from hitadv_torch.attacks.cw import (  # noqa: F401
    CWConfig,
    CWKNNConfig,
    make_cw_knn,
    make_cw_perturb,
)
from hitadv_torch.attacks.hit_adv import (  # noqa: F401
    BLENDS,
    HiTADVConfig,
    make_hit_adv,
)
