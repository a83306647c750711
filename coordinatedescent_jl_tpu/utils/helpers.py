"""Numeric helpers: column loadings, σ estimates, screening initializers.

Vectorized JAX equivalents of reference ``src/utils.jl:60-175``:

- ``std_X``                 — ``_stdX!`` plain / weighted (utils.jl:127-151)
- ``get_loadings``          — ``_getLoadings!`` (utils.jl:153-164)
- ``get_sigma``             — ``_getSigma`` (utils.jl:167-175)
- ``find_largest_correlations`` — top-s screening (utils.jl:96-124)
- ``find_init_residuals``   — screening OLS residuals (utils.jl:66-92)
- ``find_init_sigma``       — σ upper bound from screened OLS (utils.jl:60-64)

The reference loops over columns with ``@simd``; here each helper is one
fused reduction over the whole matrix (VPU-friendly, single HBM sweep), and
the screening step uses ``lax.top_k`` + a static-shape least-squares solve
instead of ``nlargest`` + a dynamically-sized column view.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def std_X(X, w=None):
    """Per-column root-mean-square loadings.

    Plain: ``sqrt(mean(X_j^2))`` (reference utils.jl:127-138).
    Weighted: ``sqrt(Σ_i w_i X_ij^2 / n)`` — note the divisor is ``n``, not
    ``Σw`` (reference utils.jl:140-151).
    """
    n = X.shape[0]
    if w is None:
        v = jnp.sum(X * X, axis=0)
    else:
        v = jnp.einsum("i,ij->j", w, X * X)
    return jnp.sqrt(v / n)


def get_loadings(X, e):
    """Heteroscedastic penalty loadings ``sqrt(mean((X_ij e_i)^2))``.

    Reference ``_getLoadings!`` (utils.jl:153-164); used by the feasible
    (Belloni-style) Lasso.
    """
    n = X.shape[0]
    # HIGHEST-pinned: the loadings become penalty weights, and a reduced
    # (TF32/bf16) default matmul precision would perturb them at ~1e-3
    return jnp.sqrt(jnp.einsum("i,ij->j", e * e, X * X,
                               precision=jax.lax.Precision.HIGHEST) / n)


def get_loadings_blocked(Xb, e, p: int):
    """``get_loadings`` computed from the blocked design ``Xb (nb, n, B)``.

    Same contraction, but reduced one column-block at a time under
    ``lax.map`` so no X-sized elementwise temp (``X∘X``) or transposed
    layout copy is ever materialized.  The raw-X form inside the
    feasible-lasso loop kept ~7.5 GB of X-shaped HLO temps live across
    the loading rounds at n=10K/p=100K; this form adds only one (n, B)
    temp per step.
    Padded blocked columns are all-zero → loading 0; callers slice to
    ``p`` so those never become penalty weights.
    """
    n = Xb.shape[1]
    ee = e * e

    def one(xb):                                           # (n, B)
        return jnp.einsum("i,ik->k", ee, xb * xb,
                          precision=jax.lax.Precision.HIGHEST)

    s = jax.lax.map(one, Xb)                               # (nb, B)
    return jnp.sqrt(s.reshape(-1)[:p] / n)


def get_sigma(w, r):
    """Weighted residual scale ``sqrt(Σ w_i r_i^2 / Σ w_i)``.

    Reference ``_getSigma`` (utils.jl:167-175).
    """
    return jnp.sqrt(jnp.sum(r * r * w) / jnp.sum(w))


def sample_std(r):
    """Corrected sample standard deviation (Julia ``std``: mean-centered,
    ``n-1`` divisor) — the σ reported by ``lasso`` (reference lasso.jl:37)."""
    n = r.shape[0]
    m = jnp.mean(r)
    return jnp.sqrt(jnp.sum((r - m) ** 2) / (n - 1))


def find_largest_correlations(X, y, s: int, w=None):
    """Indices of the ``s`` columns with largest ``|X_j' y|`` (or weighted
    ``|Σ_i X_ij w_i y_i|``).

    The reference returns a boolean mask thresholded at the s-th largest
    value (utils.jl:96-124), which can select more than ``s`` columns on
    ties; we return exactly ``s`` indices via ``lax.top_k`` (a static
    shape, as compiled programs require). For generic (continuous) data the two agree.
    """
    if w is None:
        c = jnp.abs(jnp.dot(y, X, precision=jax.lax.Precision.HIGHEST))
    else:
        c = jnp.abs(jnp.dot(w * y, X,
                            precision=jax.lax.Precision.HIGHEST))
    _, idx = jax.lax.top_k(c, s)
    return idx


def find_init_residuals(X, y, s: int, w=None):
    """Residuals of (weighted) OLS of ``y`` on the ``s`` most-correlated
    columns of ``X``.

    Plain variant (reference utils.jl:66-77): ``r = y - X_S (X_S \\ y)``.
    Weighted variant (utils.jl:79-92):
    ``r = y - X_S (X_S' W X_S)^{-1} X_S' W y``.
    """
    idx = find_largest_correlations(X, y, s, w)
    Xs = jnp.take(X, idx, axis=1)
    prec = jax.lax.Precision.HIGHEST
    # normal equations + LU, not lstsq (an SVD, slower to compile and
    # run for an s×s system); this is a screening INIT, and the
    # eps-scaled jitter keeps the solve
    # defined even when the top-s columns are collinear (duplicated
    # features) at a perturbation far below the heuristic's own noise
    A = (jnp.dot(Xs.T, Xs, precision=prec) if w is None
         else jnp.dot(Xs.T, w[:, None] * Xs, precision=prec))
    b = (jnp.dot(y, Xs, precision=prec) if w is None
         else jnp.dot(w * y, Xs, precision=prec))
    jitter = (10 * jnp.finfo(X.dtype).eps
              * jnp.trace(A) / s) * jnp.eye(s, dtype=A.dtype)
    coef = jnp.linalg.solve(A + jitter, b)
    return y - jnp.dot(Xs, coef, precision=prec)


def find_init_sigma(X, y, s: int):
    """Initial σ upper bound: sample std of the screened-OLS residuals
    (reference ``_findInitSigma!``, utils.jl:60-64)."""
    return sample_std(find_init_residuals(X, y, s))
