"""Observability: duality gap, KKT residuals, convergence metrics.

The reference tracks convergence only via the max per-epoch coordinate
displacement ``maxH`` (coordinate_descent.jl:83-89) and has no logging
(SURVEY.md §5.5).  The north-star metric for this framework is
time-to-1e-7 **duality gap**, which the reference does not compute — so we
add an explicit Fenchel duality gap for the (weighted) Lasso objective
``P(β) = ‖y − Xβ‖²/(2n) + λ0 Σ_j ω_j |β_j|``.

All contractions pin ``Precision.HIGHEST``: an accelerator's default f32
matmul precision may round operands to TF32 or bf16 (~1e-3 relative
error), which would
corrupt exactly the certificate these functions exist to provide (the same
invariant the solver enforces, block_cd.py).  For gaps near the f32
rounding floor use :func:`lasso_duality_gap_f64`, which runs the two O(n·p)
contractions on device and finishes the scalar arithmetic in float64 on the
host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_PREC = lax.Precision.HIGHEST


def lasso_duality_gap(X, y, beta, lam0, weights=None):
    """Fenchel duality gap for the (weighted) Lasso.

    Dual of ``min ‖y − Xβ‖²/(2n) + λ0 Σ ω_j|β_j|`` over scaled residuals:
    ``D(θ) = (‖y‖² − ‖y − θ‖²)/(2n)`` subject to ``|X_j'θ|/n ≤ λ0 ω_j``.
    We take θ as the residual rescaled into the dual-feasible set,
    the standard gap certificate.  Returns a scalar ≥ 0 (up to rounding).
    Traceable (usable inside jit); the contractions pin HIGHEST precision.
    """
    n = y.shape[0]
    r = y - jnp.dot(X, beta, precision=_PREC)
    g = jnp.dot(r, X, precision=_PREC)
    if weights is None:
        weights = jnp.ones_like(beta)
    # largest |X_j'r| relative to its allowed level n·λ0·ω_j
    ratio = jnp.max(jnp.abs(g) / (n * lam0 * weights))
    scale = jnp.minimum(1.0, 1.0 / jnp.maximum(ratio, 1e-30))
    theta = r * scale
    primal = jnp.sum(r * r) / (2 * n) + lam0 * jnp.sum(
        weights * jnp.abs(beta))
    dual = (jnp.sum(y * y) - jnp.sum((y - theta) ** 2)) / (2 * n)
    return primal - dual


@jax.jit
def _gap_pieces(X, y, beta):
    r = y - jnp.dot(X, beta, precision=_PREC)
    g = jnp.dot(r, X, precision=_PREC)
    return r, g


def lasso_duality_gap_f64(X, y, beta, lam0, weights=None):
    """Host-finished float64 duality gap ``(gap, primal)``.

    The two O(n·p) contractions run jitted on device at HIGHEST precision
    (pulling a multi-GB design matrix to the host for a pure-f64 gap
    would cost a full device-to-host copy); only the O(n + p) vectors
    reach the
    host, where the remaining scalar arithmetic is exact float64.  This is
    the measurement-grade certificate used by ``bench.py`` for gaps at or
    below the float32 rounding floor.  Not traceable (returns floats).
    """
    r, g = _gap_pieces(X, y, beta)
    r = np.asarray(r, np.float64)
    g = np.asarray(g, np.float64)
    beta = np.asarray(beta, np.float64)
    yn = np.asarray(y, np.float64)
    n = yn.shape[0]
    if weights is None:
        w = np.ones_like(beta)
    else:
        w = np.asarray(weights, np.float64)
    ratio = np.max(np.abs(g) / (n * float(lam0) * w))
    theta = r * min(1.0, 1.0 / max(ratio, 1e-300))
    primal = r @ r / (2 * n) + float(lam0) * np.sum(w * np.abs(beta))
    dual = (yn @ yn - (yn - theta) @ (yn - theta)) / (2 * n)
    return primal - dual, primal


def lasso_kkt_residual(X, y, beta, lam0, weights=None):
    """Max KKT violation ``max_j (|X_j'(y−Xβ)|/n − λ0 ω_j)_+`` plus the
    on-support stationarity error — the quantity the reference's tests bound
    (test/lasso.jl:54, 97-98)."""
    n = y.shape[0]
    r = y - jnp.dot(X, beta, precision=_PREC)
    g = jnp.dot(r, X, precision=_PREC) / n
    if weights is None:
        weights = jnp.ones_like(beta)
    lam = lam0 * weights
    off = jnp.maximum(jnp.abs(g) - lam, 0.0)
    on = jnp.where(beta != 0, jnp.abs(g - lam * jnp.sign(beta)), 0.0)
    return jnp.maximum(jnp.max(off), jnp.max(on))
