"""Smooth-loss specifications for the coordinate-descent driver.

JAX re-design of the reference's ``CoordinateDifferentiableFunction``
trait (reference ``src/cd_differentiable_function.jl:1-35``).  The reference
models a loss as a mutable object with ``initialize!`` / ``gradient`` /
``descendCoordinate!`` methods that update an internal residual vector one
coordinate at a time.  Here a loss is an immutable pytree of arrays plus a
static ``kind`` tag; all solver state (residuals, ‖r‖², active masks) lives in
an explicit state pytree threaded through ``lax``-controlled block updates
(see ``block_cd.py``).

Losses (semantics match the reference exactly):

- ``LeastSquaresLoss(y, X)``      — ``‖y − Xβ‖² / (2n)``
  (reference ``CDLeastSquaresLoss``, cd_differentiable_function.jl:43-111)
- ``WeightedLSLoss(y, X, w)``     — ``Σ_i w_i (y_i − X_i β)² / (2n)``
  (reference ``CDWeightedLSLoss``, cd_differentiable_function.jl:118-194)
- ``SqrtLassoLoss(y, X)``         — ``‖y − Xβ‖₂``
  (reference ``CDSqrtLassoLoss``, cd_differentiable_function.jl:202-291;
  the reference's header comment says ``/√n`` but its gradient and exact
  coordinate minimizer are those of plain ``‖r‖`` — see ``value``)
- ``QuadraticLoss(A, b)``         — ``x'Ax/2 + x'b`` (A symmetric)
  (reference ``CDQuadraticLoss``, cd_differentiable_function.jl:299-348)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

# Same invariant as the solver (block_cd.py): an accelerator's default f32
# matmul precision may round to TF32/bf16, corrupting gradients/objectives at
# ~1e-3 relative — every contraction here pins full-f32 precision.
_PREC = lax.Precision.HIGHEST


class LeastSquaresLoss(NamedTuple):
    y: jnp.ndarray
    X: jnp.ndarray

    kind = "ls"


class WeightedLSLoss(NamedTuple):
    y: jnp.ndarray
    X: jnp.ndarray
    w: jnp.ndarray

    kind = "wls"


class SqrtLassoLoss(NamedTuple):
    y: jnp.ndarray
    X: jnp.ndarray

    kind = "sqrt"


class QuadraticLoss(NamedTuple):
    A: jnp.ndarray
    b: jnp.ndarray

    kind = "quad"


Loss = NamedTuple  # any of the above


def num_coordinates(loss) -> int:
    """Number of coordinates the driver iterates over
    (reference ``numCoordinates``)."""
    if isinstance(loss, QuadraticLoss):
        return loss.b.shape[0]
    return loss.X.shape[1]


def gradient(loss, beta):
    """Full gradient vector of the smooth part at ``beta``.

    Coordinate ``j`` matches the reference's ``gradient(f, x, j)``:

    - ls:   ``−X_j'r / n``        (cd_differentiable_function.jl:75-76)
    - wls:  ``−Σ_i w_i X_ij r_i / n``  (:150-158)
    - sqrt: ``−X_j'r / ‖r‖``      (:234-235)
    - quad: ``(Ax)_j + b_j``      (:321-322)
    """
    if isinstance(loss, QuadraticLoss):
        return jnp.dot(loss.A, beta, precision=_PREC) + loss.b
    r = loss.y - jnp.dot(loss.X, beta, precision=_PREC)
    n = loss.y.shape[0]
    if isinstance(loss, LeastSquaresLoss):
        return -jnp.dot(r, loss.X, precision=_PREC) / n
    if isinstance(loss, WeightedLSLoss):
        return -jnp.dot(loss.w * r, loss.X, precision=_PREC) / n
    if isinstance(loss, SqrtLassoLoss):
        return -jnp.dot(r, loss.X, precision=_PREC) / jnp.linalg.norm(r)
    raise TypeError(f"unsupported loss: {type(loss)!r}")


def value(loss, beta):
    """Objective value of the smooth part at ``beta``."""
    if isinstance(loss, QuadraticLoss):
        Ab = jnp.dot(loss.A, beta, precision=_PREC)
        return (0.5 * jnp.dot(beta, Ab, precision=_PREC)
                + jnp.dot(beta, loss.b, precision=_PREC))
    r = loss.y - jnp.dot(loss.X, beta, precision=_PREC)
    n = loss.y.shape[0]
    if isinstance(loss, LeastSquaresLoss):
        return jnp.sum(r * r) / (2 * n)
    if isinstance(loss, WeightedLSLoss):
        return jnp.sum(loss.w * r * r) / (2 * n)
    if isinstance(loss, SqrtLassoLoss):
        # ‖r‖ — NOT ‖r‖/√n: the reference's header comment says /√n
        # (cd_differentiable_function.jl:197) but its gradient (:234-235)
        # and exact coordinate minimizer (:242-291) are those of ‖r‖ with
        # the λ·‖r‖ zero rule, and this engine matches them
        # (block_cd._sqrt_candidate, _lambda_max).  Returning ‖r‖ keeps
        # value/gradient mutually consistent and makes
        # ``value + λ0·Σ λw·|β|`` the objective the solver decreases.
        return jnp.sqrt(jnp.dot(r, r, precision=_PREC))
    raise TypeError(f"unsupported loss: {type(loss)!r}")
