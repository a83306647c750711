"""Estimator APIs: Lasso, Sqrt-Lasso, Scaled-Lasso, Feasible Lasso.

JAX equivalents of reference ``src/lasso.jl``:

- ``lasso``          — lasso.jl:26-53 (plain + weighted)
- ``sqrt_lasso``     — lasso.jl:62-98
- ``scaled_lasso``   — lasso.jl:107-144 (joint (β, σ) outer loop)
- ``feasible_lasso`` — lasso.jl:154-194 (Belloni heteroscedastic loadings)

All outer fixed-point loops run on-device as ``lax.while_loop``s around the
block-CD engine, so a whole Scaled-Lasso solve is a single XLA program.

Note on broken reference surfaces (SURVEY.md §7): ``sqrtLasso`` with
``standardizeX=true`` (lasso.jl:73) and ``feasibleLasso!`` (lasso.jl:164-165,
183) use pre-1.0 Julia allocation syntax and throw on the pinned Julia 1.5;
here we implement the *intended* semantics, which are clear from context.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.block_cd import (
    _compact_mode,
    _empty_ws_cache,
    _extrapolate_path_start,
    _init_state,
    _pad_to_blocks,
    _blockify_cols,
    _solve_at_lambda_ws,
    _to_blocked_beta,
    _unblock,
    build_blocked,
    coordinate_descent,
    solve_blocked,
)
from ..ops.losses import LeastSquaresLoss, SqrtLassoLoss
from ..ops.prox import ProxL1
from ..utils.helpers import (
    find_init_residuals,
    find_init_sigma,
    get_loadings_blocked,
    sample_std,
    std_X,
)
from ..utils.options import CDOptions, IterLassoOptions, resolve_extrapolate


class LassoSolution(NamedTuple):
    """Result record mirroring reference ``LassoSolution`` (lasso.jl:7-17)."""

    x: jnp.ndarray          # coefficients (dense; zeros encode sparsity)
    residuals: jnp.ndarray  # y - Xβ
    penalty: ProxL1
    sigma: Optional[jnp.ndarray]  # residual scale estimate (or None)


def _blocked_weights(v, B):
    """(p,) → (nb, B) with 1-padding (penalty weights for padded coords)."""
    return _blockify_cols(_pad_to_blocks(v, B, fill=1.0)[None, :], B)[:, 0, :]


# ---------------------------------------------------------------------------
# Lasso (reference lasso.jl:26-53)
# ---------------------------------------------------------------------------


def lasso(X, y, lam, weights=None, options: CDOptions = CDOptions(), *,
          seed: int = 0) -> LassoSolution:
    """(Weighted) Lasso: ``min ‖y−Xβ‖²/(2n) + λ Σ ω_j |β_j|``.

    Reference ``lasso`` (lasso.jl:26-53); the reported σ is the sample std of
    the residuals (lasso.jl:37).
    """
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    g = ProxL1(jnp.asarray(lam, X.dtype),
               None if weights is None else jnp.asarray(weights, X.dtype))
    beta0 = jnp.zeros((X.shape[1],), X.dtype)
    beta, r = coordinate_descent(beta0, LeastSquaresLoss(y, X), g, options,
                                 seed=seed)
    return LassoSolution(beta, r, g, sample_std(r))


# ---------------------------------------------------------------------------
# Sqrt-Lasso (reference lasso.jl:62-98)
# ---------------------------------------------------------------------------


def sqrt_lasso(X, y, lam, weights=None, options: CDOptions = CDOptions(), *,
               standardize_X: bool = True, seed: int = 0) -> LassoSolution:
    """Sqrt-Lasso: ``min ‖y−Xβ‖₂/√n + λ Σ ω_j |β_j|``.

    Reference ``sqrtLasso`` (lasso.jl:62-98).  When ``weights`` is None and
    ``standardize_X`` is True, per-column RMS loadings are used as penalty
    weights (the reference's intended lasso.jl:72-78 path).
    """
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    if weights is None and standardize_X:
        weights = std_X(X)
    g = ProxL1(jnp.asarray(lam, X.dtype),
               None if weights is None else jnp.asarray(weights, X.dtype))
    beta0 = jnp.zeros((X.shape[1],), X.dtype)
    beta, r = coordinate_descent(beta0, SqrtLassoLoss(y, X), g, options,
                                 seed=seed)
    return LassoSolution(beta, r, g, sample_std(r))


# ---------------------------------------------------------------------------
# Scaled Lasso (reference lasso.jl:107-144)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("opts", "init_procedure"))
def _scaled_lasso_core(X, y, lam, lamw, beta0, key, opts: IterLassoOptions,
                       init_procedure: str):
    n = y.shape[0]
    dtype = X.dtype
    cd = opts.options_cd
    prob = build_blocked("ls", cd, lamw, X=X, y=y)
    beta_b = _to_blocked_beta(beta0, cd.block_size)

    # σ initialization (lasso.jl:120-129)
    if init_procedure == "screening":
        sig = find_init_sigma(X, y, opts.s_init)
    elif init_procedure == "init_std":
        sig = jnp.asarray(opts.sigma_init, dtype)
    elif init_procedure == "warm_start":
        r0 = y - jnp.einsum("bnk,bk->n", prob.Xb, beta_b,
                             precision=lax.Precision.HIGHEST)
        sig = sample_std(r0)
    else:
        raise ValueError("init_procedure must be one of "
                         "'screening' | 'init_std' | 'warm_start'")

    n_scale = jnp.asarray(n, dtype)
    # the solver state (incl. residuals and the cached KKT gradient, which
    # is λ-independent) carries across σ rounds — no per-round re-init;
    # the compaction working-set cache rides along for the same reason
    st0 = _init_state("ls", prob, beta_b, key)
    nc = _compact_mode("ls", cd, prob, dtype)
    cache0 = _empty_ws_cache("ls", prob, nc, cd) if nc else None

    def cond(c):
        it, done = c[4], c[5]
        return jnp.logical_and(~done, it < opts.max_iter)

    def body(c):
        (st, cache, sig, sig_used, it, done,
         beta_prev, lam_k, lam_km1) = c
        beta_k = st.beta
        lam_new = lam * sig
        key, k1 = jax.random.split(st.key)
        if cd.warm_start:
            if nc and resolve_extrapolate(cd, True):
                # the σ rounds move the effective penalty along the
                # λ·σ abscissa — same secant accelerant as the λ path
                # (σ oscillations give α < 0, which the clip skips)
                st = _extrapolate_path_start(st, cache, beta_prev,
                                             lam_k, lam_km1, lam_new)
            st, cache = _solve_at_lambda_ws("ls", cd, prob, lam_new,
                                            st._replace(key=k1), n_scale,
                                            cache)
        else:
            # reference semantics: coordinateDescent! with warmStart=false
            # zeroes β and runs λ-continuation every σ round
            # (lasso.jl:133, coordinate_descent.jl:24-37)
            st = solve_blocked("ls", cd, prob, lam_new,
                               jnp.zeros_like(st.beta), k1)
        signew = jnp.sqrt(jnp.sum(st.r * st.r) / n)
        done = jnp.abs(signew - sig) / sig < opts.opt_tol
        sig_used = sig
        sig = jnp.where(done, sig, signew)
        return (st, cache, sig, sig_used, it + 1, done,
                beta_k, lam_new, lam_k)

    lam_first = lam * sig
    init = (st0, cache0, sig, sig, jnp.zeros((), jnp.int32),
            jnp.zeros((), bool), st0.beta, lam_first, lam_first)
    st, _, sig, sig_used, it, done, _, _, _ = lax.while_loop(
        cond, body, init)
    beta = _unblock(st.beta, beta0.shape[0])
    return beta, st.r, sig_used


def scaled_lasso(X, y, lam, weights=None,
                 options: IterLassoOptions = IterLassoOptions(), *,
                 beta0=None, seed: int = 0) -> LassoSolution:
    """Scaled Lasso: alternate weighted-λ Lasso solves and the consensus σ
    update ``σ ← sqrt(Σ r² / n)`` until the relative σ change is below
    ``opt_tol`` (reference ``scaledLasso!``, lasso.jl:107-144)."""
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    p = X.shape[1]
    lamw = (jnp.ones((p,), X.dtype) if weights is None
            else jnp.asarray(weights, X.dtype))
    if beta0 is None:
        beta0 = jnp.zeros((p,), X.dtype)
    key = jax.random.PRNGKey(seed)
    beta, r, sig_used = _scaled_lasso_core(
        X, y, jnp.asarray(lam, X.dtype), lamw, beta0, key, options,
        options.init_procedure)
    g = ProxL1(jnp.asarray(lam, X.dtype) * sig_used, lamw)
    return LassoSolution(beta, r, g, sample_std(r))


# ---------------------------------------------------------------------------
# Feasible (heteroscedastic) Lasso (reference lasso.jl:154-194)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("opts", "init_procedure"))
def _feasible_lasso_core(X, y, lam0, beta0, key, opts: IterLassoOptions,
                         init_procedure: str):
    dtype = X.dtype
    cd = opts.options_cd
    B = cd.block_size
    prob = build_blocked("ls", cd, jnp.ones((X.shape[1],), dtype), X=X, y=y)
    beta_b = _to_blocked_beta(beta0, B)

    # residual initialization (lasso.jl:169-178)
    if init_procedure == "screening":
        r = find_init_residuals(X, y, opts.s_init)
    elif init_procedure == "init_std":
        key, k0 = jax.random.split(key)
        gam0 = std_X(X)
        st0 = solve_blocked("ls", cd,
                            prob._replace(lamw=_blocked_weights(gam0, B)),
                            lam0 * opts.sigma_init, beta_b, k0)
        beta_b, r = st0.beta, st0.r
    elif init_procedure == "warm_start":
        r = y - jnp.einsum("bnk,bk->n", prob.Xb, beta_b,
                           precision=lax.Precision.HIGHEST)
    else:
        raise ValueError("init_procedure must be one of "
                         "'screening' | 'init_std' | 'warm_start'")
    # Γ = sqrt(mean((X_ij e_i)²)) (lasso.jl:179) — from the blocked
    # layout so the loading rounds never keep X-shaped temps live
    # (helpers.get_loadings_blocked; the raw-X form doubles peak memory)
    p = X.shape[1]
    gam = get_loadings_blocked(prob.Xb, r, p)

    n_scale = jnp.asarray(y.shape[0], dtype)
    key, k0 = jax.random.split(key)
    st0 = _init_state("ls", prob, beta_b, k0)
    nc = _compact_mode("ls", cd, prob, dtype)
    cache0 = _empty_ws_cache("ls", prob, nc, cd) if nc else None

    def cond(c):
        st, cache, gam, it, done = c
        return jnp.logical_and(~done, it < opts.max_iter)

    def body(c):
        st, cache, gam, it, done = c
        key, k1 = jax.random.split(st.key)
        # the cached KKT gradient is penalty-weight-independent, so it
        # survives the per-round loading update (and so does the raw-column
        # working-set cache)
        prob_g = prob._replace(lamw=_blocked_weights(gam, B))
        if cd.warm_start:
            st, cache = _solve_at_lambda_ws("ls", cd, prob_g, lam0,
                                            st._replace(key=k1), n_scale,
                                            cache)
        else:
            # reference semantics: cold continuation every loading round
            st = solve_blocked("ls", cd, prob_g, lam0,
                               jnp.zeros_like(st.beta), k1)
        gam_new = get_loadings_blocked(prob.Xb, st.r, p)
        done = (jnp.max(jnp.abs(gam - gam_new)) / jnp.max(gam_new)
                < opts.opt_tol)
        return (st, cache, gam_new, it + 1, done)

    init = (st0, cache0, gam, jnp.zeros((), jnp.int32),
            jnp.zeros((), bool))
    st, _, gam, it, done = lax.while_loop(cond, body, init)
    return _unblock(st.beta, beta0.shape[0]), st.r, gam


def feasible_lasso(X, y, lam0,
                   options: IterLassoOptions = IterLassoOptions(), *,
                   beta0=None, seed: int = 0) -> LassoSolution:
    """Feasible (Belloni-style heteroscedastic) Lasso: re-estimate the
    penalty loadings ``Γ_j = sqrt(mean((X_ij ε_i)²))`` from residuals each
    round until ``max|Γold − Γ| / maxΓ < opt_tol``
    (reference ``feasibleLasso!``, lasso.jl:154-194)."""
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    p = X.shape[1]
    if beta0 is None:
        beta0 = jnp.zeros((p,), X.dtype)
    key = jax.random.PRNGKey(seed)
    beta, r, gam = _feasible_lasso_core(
        X, y, jnp.asarray(lam0, X.dtype), beta0, key, options,
        options.init_procedure)
    g = ProxL1(jnp.asarray(lam0, X.dtype), gam)
    return LassoSolution(beta, r, g, sample_std(r))
