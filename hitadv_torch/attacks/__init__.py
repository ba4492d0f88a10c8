"""Attacks: HiT-ADV (the flagship), the CW attacks, the FGM family,
SaliencyDrop and GeoA3."""

from hitadv_torch.attacks.base import AttackResult, make_adv_fn  # noqa: F401
from hitadv_torch.attacks.cw import (  # noqa: F401
    CWConfig,
    CWKNNConfig,
    make_cw_knn,
    make_cw_perturb,
)
from hitadv_torch.attacks.drop import (  # noqa: F401
    DropConfig,
    make_sat_forward,
    make_saliency_drop,
)
from hitadv_torch.attacks.fgm import (  # noqa: F401
    FGMConfig,
    make_fgm_l2,
    make_fgsm,
    make_fgsm_rs,
    make_ifgm_l2,
    make_ifgsm,
    make_mifgsm,
    make_pgd,
)
from hitadv_torch.attacks.geoa3 import GeoA3Config, make_geoa3  # noqa: F401
from hitadv_torch.attacks.hit_adv import (  # noqa: F401
    BLENDS,
    HiTADVConfig,
    make_hit_adv,
)
