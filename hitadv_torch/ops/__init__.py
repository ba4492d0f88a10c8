"""Geometry ops and the hand-written CUDA kernels of the main path.

The geometry API is re-exported under the reference's names
(`hitadv_tpu/ops/__init__.py`), without its Pallas backend switch
(``set_backend`` / ``get_backend``: here the tensor's device picks the
kernel or its plain version) and its ``set_validation`` (the contract
checks are always on). `geometry` imports `kernels` as a submodule
of this package, so importing either first creates no cycle.
"""

from hitadv_torch.ops.geometry import (  # noqa: F401
    KNNResult,
    farthest_point_sample,
    gather_group_nm,
    gaussian_blend,
    gaussian_blend_fused,
    gaussian_blend_negdt,
    graph_max_pool,
    group_points,
    index_points,
    interpolate_weights,
    kde_density,
    knn_gather,
    knn_idx,
    knn_indices,
    knn_point,
    knn_points,
    l2_normalize,
    median_points,
    neg_gaussian_field,
    pairwise_distance,
    query_ball_point,
    sample_and_group,
    sample_and_group_all,
    sample_and_group_knn,
    square_distance,
    three_interpolate,
    three_nn,
)
