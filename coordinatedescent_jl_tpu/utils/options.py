"""Solver option records.

Mirrors the reference's option structs (semantic API parity):

- ``CDOptions``       — reference ``src/utils.jl:7-20``
- ``IterLassoOptions`` — reference ``src/utils.jl:24-39``

Both are frozen (hashable) dataclasses so they can be passed as static
arguments to ``jax.jit``.  ``block_size`` is new: it controls the width of the
block-coordinate updates (multiples of 128 map best onto the hardware); it has
no effect on the solution, only on how work maps to hardware.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import numpy as np


@dataclass(frozen=True)
class CDOptions:
    """Options for the core coordinate-descent driver.

    Fields mirror reference ``src/utils.jl:7-20``:

    - ``max_iter``: maximum number of epochs (full or active-set passes).
    - ``opt_tol``: convergence tolerance on the maximum per-epoch coordinate
      displacement ``maxH`` (reference ``src/coordinate_descent.jl:83-89``).
    - ``randomize``: visit blocks / coordinates in a random order each pass.
    - ``warm_start``: if True the solver starts from the supplied iterate; if
      False it starts from zero and follows a log-spaced λ-continuation path
      from ``λ_max`` down to the target λ with ``num_steps`` segments
      (reference ``src/coordinate_descent.jl:20-38``).
    - ``num_steps``: number of λ-continuation segments (path has
      ``num_steps + 1`` points).
    - ``block_size``: block width for block-coordinate updates (new).
    - ``stall_patience``: stop a λ-solve early if the certified full-check
      ``maxH`` has not improved at all for this many consecutive full
      checks (active-pass maxH is trajectory noise and is not counted) —
      the escape hatch for
      float32 runs whose rounding floor sits above ``opt_tol`` (the
      reference, always float64, has no equivalent; its loops burn
      ``max_iter``).  Only active for sub-float64 dtypes — float64 runs
      keep pure reference semantics (new).
    - ``inner``: within-block solver of the active pass.
      ``'exact'`` = sequential Gauss-Seidel scan (reference-exact
      trajectory, ``B`` dependent steps per block); ``'ista'`` =
      vectorized inexact block solve (``block_iters`` ``B×B`` matvecs —
      same converged solution, certified by the KKT sweep); ``'auto'``
      (default) = ista for sub-f64 dtypes on the ls/wls/sqrt losses, exact
      otherwise (new).
    - ``block_iters``: ISTA iterations per block visit for
      ``inner='ista'`` (new).
    - ``screen``: gap-safe screening of the KKT sweeps for the
      least-squares Lasso (safe-sphere rule; blocks provably zero at the
      optimum are neither swept nor checked, so confirming sweeps read
      only candidate columns of X).  ``None``/``True`` = on (it is exact:
      solutions are unchanged, certified by the safe rule + restricted
      KKT); ``False`` = every sweep reads all stale blocks (new).
    - ``compact``: working-set compaction.  A scattered support leaves
      most lanes of each 128-wide block idle; compaction gathers the
      ``compact_size`` highest-priority coordinates (support + largest
      KKT violations) into a dense ``(n, C)`` subproblem, solves it with
      the normal engine, and repeats until the full KKT check passes —
      so per-pass memory traffic scales with the support, not with how it
      is scattered.  ``None`` (default) = auto: on for sub-float64 dtypes on
      the regression losses when ``p`` is much larger than
      ``compact_size`` (float64 runs keep exact reference trajectories);
      ``True``/``False`` force.  Solutions are unchanged: convergence is
      still certified by the full KKT sweep, with a dense-solve fallback
      if the working set overflows (new).
    - ``compact_size``: working-set capacity ``C`` (rounded up to the
      block width).  Must comfortably exceed the expected support (new).
    - ``compact_rounds``: maximum working-set refinement rounds before
      falling back to the dense solver (new).
    - ``cache_gram``: precompute every block's Gram matrix
      ``K_b = Xw_b' X_b`` once per problem build and stream the cached
      ``B×B`` tiles into the passes instead of recomputing them each block
      visit.  The Gram recursion makes ``K`` most of the FLOPs of a visit
      (2·n·B² vs the 2·n·B reads), so cached Grams leave the pass bound by
      streaming the block once, as it is designed to be.
      ``K`` depends only on ``X`` (λ- and σ-independent), so one build
      serves the whole λ-path / outer σ loop.  ``None`` (default) = auto:
      on for the regression losses when the cache is ≤ 256 MiB
      (``p·B·4`` bytes); ``True``/``False`` force.  No effect on
      solutions (new).
    - ``extrapolate``: secant warm-start extrapolation along solver
      schedules (λ paths, λ-continuation, scaled-lasso σ rounds, the
      locpolyl1 z-grid).  β(λ) is piecewise linear, so shifting the warm
      start along the last secant usually lands within rounding of the
      next solution and the inner epochs collapse.  Requires the
      compaction working set (the shift's residual update uses only the
      cached columns) except on the z-grid, where the residual is rebuilt
      per point anyway.  Solutions are unchanged — every solve is still
      certified by the full KKT sweep.  ``None`` (default) = auto:
      per-consumer defaults — OFF along dense λ paths (warm starts there
      are already near-exact, so the shift work only adds time), ON on
      the locpolyl1 z-grid and the scaled-lasso σ rounds.
      ``True``/``False`` force (new).
    """

    max_iter: int = 2000
    opt_tol: float = 1e-7
    randomize: bool = True
    warm_start: bool = True
    num_steps: int = 50
    block_size: int = 128
    stall_patience: int = 20
    inner: str = "auto"
    block_iters: int = 16
    screen: bool | None = None
    compact: bool | None = None
    compact_size: int = 1024
    compact_rounds: int = 32
    cache_gram: bool | None = None
    extrapolate: bool | None = None

    def replace(self, **kw) -> "CDOptions":
        return dataclasses.replace(self, **kw)


def resolve_extrapolate(options: "CDOptions", consumer_default: bool) -> bool:
    """Resolve the tri-state ``extrapolate`` flag: an explicit user
    ``True``/``False`` wins; ``None`` takes the consumer's measured
    default (ON for z-grid / σ-round / λ-continuation schedules, OFF for
    dense λ paths — see the field doc)."""
    return (consumer_default if options.extrapolate is None
            else options.extrapolate)


def auto_batch_lanes(dtype, n_points: int | None = None,
                     min_points: int = 0) -> int:
    """Shared auto-default for the batched certify/refine execution
    modes (λ-path single-device + sharded, locpolyl1 z-grid, LOO-CV
    local + bandwidth-sharded): 128 lanes iff the dtype is sub-f64 AND
    the backend is an accelerator (on CPU the batched trade — more
    FLOPs for a shorter serial chain — measurably loses) AND the
    schedule has at least ``min_points`` entries.  Returns 0 (the
    sequential scan) otherwise.  Single-sourced so every surface
    engages batching under identical conditions."""
    if np.dtype(dtype).itemsize >= 8:
        return 0
    if jax.default_backend() == "cpu":
        return 0
    if n_points is not None and n_points < min_points:
        return 0
    return 128


@dataclass(frozen=True)
class IterLassoOptions:
    """Options for the outer loops of Scaled-Lasso and Feasible-Lasso.

    Fields mirror reference ``src/utils.jl:24-39``:

    - ``max_iter``: maximum outer (σ / loading) iterations.
    - ``opt_tol``: relative tolerance on the outer fixed point.
    - ``init_procedure``: one of ``'screening' | 'init_std' | 'warm_start'``
      (reference symbols ``:Screening | :InitStd | :WarmStart``).
    - ``s_init``: number of screened columns used for the initial σ /
      residual estimate (reference ``sinit``).
    - ``sigma_init``: initial σ for ``'init_std'`` (reference ``σinit``).
    - ``options_cd``: inner CD options.
    """

    max_iter: int = 20
    opt_tol: float = 1e-2
    init_procedure: str = "screening"
    s_init: int = 5
    sigma_init: float = 1.0
    options_cd: CDOptions = field(default_factory=CDOptions)

    def replace(self, **kw) -> "IterLassoOptions":
        return dataclasses.replace(self, **kw)
