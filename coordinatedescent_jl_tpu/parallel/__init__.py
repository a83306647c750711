"""Multi-chip parallel layer: feature-sharded CD + sharded scenario batches.

The reference has no parallelism of any kind (SURVEY.md §2.5); this package
provides the multi-device scaling story (SURVEY.md §5.7-5.8): ``shard_map``
over a ``jax.sharding.Mesh`` with XLA collectives (psum of residual
corrections, pmax convergence certificates, consensus σ),
plus
batch-axis sharding of the embarrassingly-parallel scenario loops.
"""

from .sharded_cd import (
    coordinate_descent_sharded,
    symmetric_coordinate_descent_sharded,
    lasso_sharded,
    sqrt_lasso_sharded,
    scaled_lasso_sharded,
    feasible_lasso_sharded,
    lasso_path_sharded,
    solve_blocked_sharded,
)
from .sharded_group import (
    group_coordinate_descent_sharded,
    group_lasso_sharded,
)
from .row_sharded import (
    coordinate_descent_row_sharded,
    lasso_path_row_sharded,
    lasso_row_sharded,
    lasso_tile_sharded,
    sqrt_lasso_row_sharded,
)
from .batch import (
    lasso_lambda_batch,
    lasso_grid_sharded,
    locpoly_batch,
    lvocv_locpoly_batch,
    lvocv_locpolyl1_batch,
)
from .distributed import (
    initialize_distributed,
    feature_mesh,
    grid_mesh,
    plan_column_shards,
    plan_device_columns,
    load_design_shard,
    shard_design_matrix,
)

__all__ = [
    "coordinate_descent_sharded",
    "symmetric_coordinate_descent_sharded",
    "lasso_sharded",
    "sqrt_lasso_sharded",
    "scaled_lasso_sharded",
    "feasible_lasso_sharded",
    "lasso_path_sharded",
    "solve_blocked_sharded",
    "group_coordinate_descent_sharded",
    "group_lasso_sharded",
    "coordinate_descent_row_sharded",
    "lasso_path_row_sharded",
    "lasso_row_sharded",
    "lasso_tile_sharded",
    "sqrt_lasso_row_sharded",
    "lasso_lambda_batch",
    "lasso_grid_sharded",
    "locpoly_batch",
    "lvocv_locpoly_batch",
    "lvocv_locpolyl1_batch",
    "initialize_distributed",
    "feature_mesh",
    "grid_mesh",
    "plan_column_shards",
    "plan_device_columns",
    "load_design_shard",
    "shard_design_matrix",
]
