"""tpu-coordinate-descent: a JAX (XLA/shard_map) framework for
proximal coordinate descent on L1- and weighted-L1-penalized smooth losses.

Built from scratch against the capability surface of the Julia reference
``mlakolar/CoordinateDescent.jl`` (see SURVEY.md).  The public export list
mirrors the reference module root (``src/CoordinateDescent.jl:9-22``):
estimators, the core CD driver + losses + options, and the
varying-coefficient suite.
"""

from .utils.options import CDOptions, IterLassoOptions
from .utils.helpers import (
    std_X,
    get_loadings,
    get_sigma,
    sample_std,
    find_largest_correlations,
    find_init_residuals,
    find_init_sigma,
)
from .ops.prox import (ProxL1, ProxL1Group, ProxZero,
                       group_soft_threshold, soft_threshold)
from .ops.group_cd import group_coordinate_descent, group_lasso
from .ops.symmetric import (
    sym_num_coordinates,
    sym_indices,
    sym_pack,
    sym_unpack,
    symmetric_coordinate_descent,
)
from .ops.losses import (
    LeastSquaresLoss,
    WeightedLSLoss,
    SqrtLassoLoss,
    QuadraticLoss,
    gradient,
    value,
    num_coordinates,
)
from .ops.block_cd import coordinate_descent
from .ops.diagnostics import (
    lasso_duality_gap,
    lasso_duality_gap_f64,
    lasso_kkt_residual,
)
from .models.lasso import (
    LassoSolution,
    lasso,
    sqrt_lasso,
    scaled_lasso,
    feasible_lasso,
)
from .models.lasso_path import LassoPath, lasso_path, refit_lasso_path
from .models.polish import (PolishResult, polish_lasso,
                            SqrtPolishResult, polish_sqrt_lasso,
                            ScaledPolishResult, polish_scaled_lasso,
                            FeasiblePolishResult, polish_feasible_lasso,
                            GroupPolishResult, polish_group_lasso)
from .ops.compensated import (group_lasso_kkt_compensated,
                              lasso_duality_gap_compensated,
                              sqrt_lasso_kkt_compensated)
from .utils.checkpoint import (
    PathCheckpoint,
    ShardedPathCheckpoint,
    save_checkpoint,
    load_checkpoint,
    save_sharded_checkpoint,
    load_sharded_checkpoint,
    lasso_path_resumable,
    lasso_path_resumable_sharded,
)
from .utils.profiling import (
    EpochTrace,
    RooflineReport,
    SigmaRoundTrace,
    simple_timeit,
    solve_with_trace,
    lasso_sharded_with_trace,
    scaled_lasso_with_trace,
    group_solve_with_trace,
    pass_roofline,
    pass_roofline_multi,
    solve_x_traffic,
    XTrafficReport,
    debug_nans,
)
from .models.varying_coefficient import (
    GaussianKernel,
    EpanechnikovKernel,
    SmoothingKernel,
    create_kernel,
    evaluate,
    expand_X,
    locpoly,
    locpolyl1,
    sparse_coefficients,
    refit_locpolyl1,
    lvocv_locpoly,
    lvocv_locpolyl1,
    split_locpoly,
    get_beta,
    get_nonzero_coordinates,
    get_residuals,
    get_standard_error,
    get_standard_error_hew,
)

__all__ = [
    # options
    "CDOptions", "IterLassoOptions",
    # penalties
    "ProxL1", "ProxL1Group", "ProxZero", "soft_threshold",
    "group_soft_threshold", "group_coordinate_descent", "group_lasso",
    # losses + core driver
    "LeastSquaresLoss", "WeightedLSLoss", "SqrtLassoLoss", "QuadraticLoss",
    "gradient", "value", "num_coordinates", "coordinate_descent",
    # symmetric-matrix iterates
    "sym_num_coordinates", "sym_indices", "sym_pack", "sym_unpack",
    "symmetric_coordinate_descent",
    "lasso_duality_gap", "lasso_duality_gap_f64", "lasso_kkt_residual",
    "lasso_duality_gap_compensated", "sqrt_lasso_kkt_compensated",
    "group_lasso_kkt_compensated",
    "polish_lasso", "PolishResult",
    "polish_sqrt_lasso", "SqrtPolishResult",
    "polish_scaled_lasso", "ScaledPolishResult",
    "polish_feasible_lasso", "FeasiblePolishResult",
    "polish_group_lasso", "GroupPolishResult",
    # estimators
    "LassoSolution", "lasso", "sqrt_lasso", "scaled_lasso", "feasible_lasso",
    "LassoPath", "lasso_path", "refit_lasso_path",
    # checkpoint / observability
    "PathCheckpoint", "save_checkpoint", "load_checkpoint",
    "ShardedPathCheckpoint", "save_sharded_checkpoint",
    "load_sharded_checkpoint", "lasso_path_resumable_sharded",
    "lasso_path_resumable", "EpochTrace", "RooflineReport", "simple_timeit",
    "solve_with_trace", "lasso_sharded_with_trace",
    "scaled_lasso_with_trace", "group_solve_with_trace",
    "SigmaRoundTrace", "pass_roofline", "pass_roofline_multi",
    "solve_x_traffic",
    "XTrafficReport", "debug_nans",
    # helpers
    "std_X", "get_loadings", "get_sigma", "sample_std",
    "find_largest_correlations", "find_init_residuals", "find_init_sigma",
    # varying coefficients
    "GaussianKernel", "EpanechnikovKernel", "SmoothingKernel",
    "create_kernel", "evaluate", "expand_X", "locpoly", "locpolyl1",
    "sparse_coefficients", "refit_locpolyl1", "lvocv_locpoly", "lvocv_locpolyl1", "split_locpoly",
    "get_beta", "get_nonzero_coordinates", "get_residuals",
    "get_standard_error", "get_standard_error_hew",
]

from . import parallel  # noqa: E402  (sharded solvers: cd.parallel.*)

__version__ = "0.1.0"
