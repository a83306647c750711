"""Sharded scenario batches: λ grids, evaluation grids, bandwidth sweeps.

The reference executes its embarrassingly-parallel outer loops serially
(SURVEY.md §2.5): the λ-path loop (lasso.jl:250-257), the zgrid loop
(varying_coefficient_lasso.jl:59-77), and the bandwidth × LOO loop
(:105-135).  On a device mesh these become **batch-axis shards**: the
scenario dimension is partitioned across ``mesh[batch_axis]``, the problem
data ``(X, y)`` is replicated, and each device sweeps its local scenarios
with ``lax.map`` (SURVEY.md §5.7).

Warm-start caveat: the reference's λ-path and locpolyl1 warm-start β across
consecutive scenarios, which serializes them; those warm-started variants
live in ``models/lasso_path.py`` / ``models/varying_coefficient.py`` (scan)
and ``parallel/sharded_cd.py`` (feature-sharded scan).  The batched solvers
here treat scenarios as independent cold solves — per the reference's own
config-invariance tests (SURVEY.md §4.3), warm starts change only speed,
never the converged solution.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.block_cd import _to_blocked_beta, build_blocked, solve_blocked
from ..utils.options import CDOptions, auto_batch_lanes


def _pad_batch(v, D):
    """Pad the leading (scenario) axis to a multiple of the batch-shard
    count, repeating the last scenario (results are truncated after)."""
    L = v.shape[0]
    Lp = -(-L // D) * D
    if Lp != L:
        v = jnp.concatenate(
            [v, jnp.broadcast_to(v[-1:], (Lp - L,) + v.shape[1:])])
    return v, L


@functools.lru_cache(maxsize=None)
def _make_lambda_batch(opts: CDOptions, mesh: Mesh, axis: str):
    def local_fn(X, y, lamw, lams_local, key):
        prob = build_blocked("ls", opts, lamw, X=X, y=y)
        p = X.shape[1]
        beta_b0 = _to_blocked_beta(jnp.zeros((p,), X.dtype),
                                   opts.block_size)

        def one(lam):
            st = solve_blocked("ls", opts, prob, lam, beta_b0, key)
            return st.beta.reshape(-1)[:p]

        return lax.map(one, lams_local)

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(fn)


def lasso_lambda_batch(X, y, lams, mesh: Mesh,
                       options: CDOptions = CDOptions(), *, weights=None,
                       batch_axis: str = "batch", seed: int = 0):
    """Solve many *independent* Lasso problems — one per λ — with the λ grid
    sharded over ``mesh[batch_axis]`` and ``(X, y)`` replicated.

    The sharded, cold-start counterpart of the reference's serial
    ``LassoPath`` loop (lasso.jl:250-257).  Returns ``(len(lams), p)``
    coefficients.
    """
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    lams = jnp.asarray(lams, X.dtype)
    lamw = (jnp.ones((X.shape[1],), X.dtype) if weights is None
            else jnp.asarray(weights, X.dtype))
    D = mesh.shape[batch_axis]
    lams_p, L = _pad_batch(lams, D)
    opts = options.replace(warm_start=True)  # cold solves, direct at each λ
    solver = _make_lambda_batch(opts, mesh, batch_axis)
    betas = solver(X, y, lamw, lams_p, jax.random.PRNGKey(seed))
    return betas[:L]


@functools.lru_cache(maxsize=None)
def _make_lambda_grid(opts: CDOptions, mesh: Mesh, baxis: str, faxis: str,
                      df: int):
    from .sharded_cd import solve_blocked_sharded

    def local_fn(Xl, y, lamwl, lams_local, key):
        prob = build_blocked("ls", opts, lamwl, X=Xl, y=y)
        p_local = Xl.shape[1]
        beta_b0 = _to_blocked_beta(jnp.zeros((p_local,), Xl.dtype),
                                   opts.block_size)

        def one(lam):
            st = solve_blocked_sharded("ls", opts, prob, lam, beta_b0, key,
                                       faxis, df)
            return st.beta.reshape(-1)[:p_local]

        return lax.map(one, lams_local)

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, faxis), P(), P(faxis), P(baxis), P()),
        out_specs=P(baxis, faxis),
        check_vma=False,
    )

    def outer(X, y, lamw, lams_p, key):
        # pad to the sharded width INSIDE the trace (sharded_cd
        # _pad_cols_to rationale: an eager pad keeps a second full-size
        # design live next to the blocked layout)
        from .sharded_cd import _pad_cols_to, _pad_vec_to, _shard_chunk
        _, P_tot = _shard_chunk(X.shape[1], df, opts.block_size)
        return fn(_pad_cols_to(X, P_tot), y,
                  _pad_vec_to(lamw, P_tot, 1.0), lams_p, key)

    return jax.jit(outer)


def lasso_grid_sharded(X, y, lams, mesh: Mesh,
                       options: CDOptions = CDOptions(), *, weights=None,
                       standardize_X: bool = True,
                       batch_axis: str = "batch",
                       feature_axis: str = "feature", seed: int = 0):
    """Independent Lasso solves over a λ grid on a 2-D
    ``(batch, feature)`` mesh: the λ scenarios are sharded over
    ``mesh[batch_axis]`` while *within* each scenario the columns of ``X``
    are sharded over ``mesh[feature_axis]`` with psum residual merging
    (``parallel.grid_mesh`` builds the right mesh).  This composes the two
    axes the reference loops serially (the λ loop, lasso.jl:250-257, and
    the per-coordinate sweep over all of p) into one program: scenario
    parallelism on the outer mesh axis, long-axis feature scaling on the
    inner axis (SURVEY.md §5.7-5.8).

    Scenarios are cold solves (independent — order-free, unlike the
    warm-started ``lasso_path_sharded`` scan); per the reference's own
    config-invariance semantics warm starts change only speed, never the
    converged solution.  Returns ``(len(lams), p)`` coefficients.
    """
    from ..utils.helpers import std_X

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    lams = jnp.asarray(lams, X.dtype)
    n, p = X.shape
    db = mesh.shape[batch_axis]
    df = mesh.shape[feature_axis]
    # explicit weights win over standardization (same precedence as
    # models/lasso.py and lasso_sharded: standardize_X only fills the
    # default when no weights were given)
    if weights is not None:
        lamw = jnp.asarray(weights, X.dtype)
    elif standardize_X:
        lamw = std_X(X)
    else:
        lamw = jnp.ones((p,), X.dtype)
    lams_p, L = _pad_batch(lams, db)
    opts = options.replace(warm_start=True)  # independent direct solves
    solver = _make_lambda_grid(opts, mesh, batch_axis, feature_axis, df)
    betas = solver(X, y, lamw, lams_p, jax.random.PRNGKey(seed))
    return betas[:L, :p]


@functools.lru_cache(maxsize=None)
def _make_locpoly_batch(degree: int, kernel_type, mesh: Mesh, axis: str):
    from ..models.varying_coefficient import _locpoly_point

    def local_fn(X, z, y, h, zgrid_local):
        kernel = kernel_type(h)
        # (coef, normal-equation relres) per point — the conditioning
        # proxy rides out so the wrapper can host-patch near-singular
        # points through lstsq exactly like single-device ``locpoly``
        return lax.map(
            lambda z0: _locpoly_point(X, z, y, z0, degree, kernel),
            zgrid_local)

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis)),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


def locpoly_batch(X, z, y, zgrid, degree, kernel, mesh: Mesh, *,
                  batch_axis: str = "batch"):
    """``locpoly`` with the evaluation grid sharded over the batch axis
    (the reference's serial zgrid loop, varying_coefficient_lasso.jl:230-234,
    as an embarrassingly-parallel scenario batch).  Returns
    ``(p(degree+1), len(zgrid))`` like ``locpoly``."""
    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    y = jnp.asarray(y, X.dtype)
    zgrid = jnp.asarray(zgrid, X.dtype)
    D = mesh.shape[batch_axis]
    zg, L = _pad_batch(zgrid, D)
    solver = _make_locpoly_batch(degree, type(kernel), mesh, batch_axis)
    out, relres = solver(X, z, y, jnp.asarray(kernel.h, X.dtype), zg)
    out, relres = out[:L], relres[:L]
    # rank-deficient / near-singular grid points: lstsq patch, same
    # contract as single-device locpoly (ADVICE r4)
    bad = np.asarray(~jnp.all(jnp.isfinite(out), axis=1)
                     | (relres > 1e-3))
    if bad.any():
        from ..models.varying_coefficient import _locpoly_point_lstsq
        idx = jnp.asarray(np.nonzero(bad)[0])
        fit_f = jax.vmap(lambda z0: _locpoly_point_lstsq(
            X, z, y, z0, degree, kernel))
        out = jnp.asarray(out).at[idx].set(fit_f(zgrid[idx]))
    return out.T


@functools.lru_cache(maxsize=None)
def _make_lvocv_batch(degree: int, kernel_type, mesh: Mesh, axis: str):
    from ..models.varying_coefficient import _lvocv_locpoly_one_h

    def local_fn(X, z, y, hs_local):
        return lax.map(
            lambda h: _lvocv_locpoly_one_h(X, z, y, h, degree, kernel_type),
            hs_local)

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis)),
        out_specs=P(axis), check_vma=False)
    return jax.jit(fn)


def lvocv_locpoly_batch(X, z, y, degree, h_arr, kernel_type, mesh: Mesh, *,
                        batch_axis: str = "batch"):
    """Bandwidth LOO-CV with the bandwidth sweep sharded over the batch axis
    (reference ``lvocv_locpoly``'s serial ``hArr`` loop, :348-380)."""
    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    y = jnp.asarray(y, X.dtype)
    h_arr = jnp.asarray(h_arr, X.dtype)
    D = mesh.shape[batch_axis]
    hs, L = _pad_batch(h_arr, D)
    solver = _make_lvocv_batch(degree, kernel_type, mesh, batch_axis)
    return solver(X, z, y, hs)[:L]


@functools.lru_cache(maxsize=None)
def _make_lvocv_l1_batch(degree: int, kernel_type, opts: CDOptions,
                         mesh: Mesh, axis: str, cv_batch: int = 0):
    from ..models.varying_coefficient import (
        _lvocv_locpolyl1_one_h,
        _lvocv_locpolyl1_one_h_batched,
    )

    def local_fn(X, z, y, lam0, key, hs_local):
        n = X.shape[0]
        if cv_batch:
            # batched held-out lanes per bandwidth (the batched
            # LOO-CV lever, models/varying_coefficient.py); PER-LANE errors and
            # escape masks ride back so the wrapper can both recompute
            # uncertified bandwidths AND re-solve individual
            # stall-escaped lanes at strict tolerance
            def one(h):
                return _lvocv_locpolyl1_one_h_batched(
                    X, z, y, h, lam0, degree, kernel_type, opts,
                    batch=cv_batch)

            return lax.map(one, hs_local)
        errs = lax.map(
            lambda h: _lvocv_locpolyl1_one_h(X, z, y, h, lam0, key,
                                             degree, kernel_type, opts,
                                             points=jnp.arange(n)),
            hs_local)
        return (errs, jnp.ones(hs_local.shape, bool),
                jnp.zeros(hs_local.shape + (n,), bool))

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)), check_vma=False)
    return jax.jit(fn)


def lvocv_locpolyl1_batch(X, z, y, degree, h_arr, kernel_type, lam0,
                          mesh: Mesh, options: CDOptions = CDOptions(), *,
                          batch_axis: str = "batch", seed: int = 0,
                          cv_batch: int | None = None,
                          stats: dict | None = None):
    """Penalized-fit bandwidth LOO-CV (reference ``lvocv_locpolyl1``'s
    serial ``hArr`` loop, :82-137) with the bandwidth sweep sharded over
    the batch axis — the most expensive CV surface (each bandwidth is n
    held-out weighted-lasso fits), so this is where scenario sharding
    pays most.  Returns the MSE per bandwidth, identical to
    ``lvocv_locpolyl1``.

    ``cv_batch`` composes the held-out-lane batching of
    ``lvocv_locpolyl1(cv_batch=…)`` with the bandwidth sharding (same
    auto default and certified-or-fallback contract: any bandwidth whose
    batched run fails to certify is recomputed sequentially).  ``stats``,
    if a dict, receives ``batched_certified``, ``stall_escaped_lanes``
    (always 0 — escaped lanes are re-solved, see ``lvocv_locpolyl1``) and
    ``lanes_resolved_sequentially``."""
    import warnings

    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    y = jnp.asarray(y, X.dtype)
    h_arr = jnp.asarray(h_arr, X.dtype)
    D = mesh.shape[batch_axis]
    hs, L = _pad_batch(h_arr, D)
    opts = options.replace(warm_start=True)
    if cv_batch is None:
        cv_batch = auto_batch_lanes(X.dtype)
    solver = _make_lvocv_l1_batch(degree, kernel_type, opts, mesh,
                                  batch_axis, int(cv_batch))
    key = jax.random.PRNGKey(seed)
    lam0j = jnp.asarray(lam0, X.dtype)
    errs, oks, escs = solver(X, z, y, lam0j, key, hs)
    errs, oks = np.array(errs[:L]), np.asarray(oks[:L])
    escs = np.asarray(escs[:L])
    from ..models.varying_coefficient import _lvocv_locpolyl1_one_h
    n_resolved = 0
    for i in range(L):
        if not oks[i]:
            continue
        # certified bandwidth: re-solve its stall-escaped lanes (if any)
        # at strict tolerance — same contract as lvocv_locpolyl1
        esc_idx = np.nonzero(escs[i])[0]
        if esc_idx.size:
            fixed = _lvocv_locpolyl1_one_h(
                X, z, y, hs[i], lam0j, key, degree, kernel_type, opts,
                points=jnp.asarray(esc_idx, jnp.int32))
            errs[i, esc_idx] = np.asarray(fixed)
            n_resolved += int(esc_idx.size)
    if stats is not None:
        stats["batched_certified"] = bool(cv_batch) and bool(oks.all())
        # escape-accepted lanes remaining in the output: always 0 now
        stats["stall_escaped_lanes"] = 0
        stats["lanes_resolved_sequentially"] = n_resolved
    mses = errs.sum(axis=1)
    if not oks.all():
        warnings.warn(
            "lvocv_locpolyl1_batch: batched LOO runs for "
            f"{int((~oks).sum())} bandwidth(s) did not certify; "
            "recomputing those sequentially", RuntimeWarning)
        for i in np.nonzero(~oks)[0]:
            mses[i] = _lvocv_locpolyl1_one_h(
                X, z, y, hs[i], lam0j, key, degree, kernel_type, opts)
    return jnp.asarray(mses)
