"""Losses of the ported attacks, and the metrics of the evaluation."""

from hitadv_torch.losses.adversarial import (  # noqa: F401
    cross_entropy_loss,
    logits_adv_loss,
    untargeted_logits_adv_loss,
)
from hitadv_torch.losses.clip import (  # noqa: F401
    clip_points_l2,
    clip_points_linf,
    project_inner_clip_linf,
    project_inner_points,
)
from hitadv_torch.losses.distance import (  # noqa: F401
    chamfer_dist,
    chamfer_knn_dist,
    curv_dist,
    curv_std_dist,
    get_kappa,
    get_kappa_adv,
    get_kappa_std,
    hausdorff_dist,
    knn_dist,
    l2_dist,
    laplacian_dist,
)
from hitadv_torch.losses.geoa3 import (  # noqa: F401
    chamfer_loss,
    curvature_loss,
    hausdorff_loss,
    jitter_input,
    pseudo_chamfer_loss,
    uniform_loss,
)
