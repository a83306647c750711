"""Proximal operators for separable penalties.

JAX re-design of the reference's ``ProximalBase.ProxL1`` /
``ProxZero`` contract (inferred from call sites, see SURVEY.md §1 L0):

- ``ProxL1(lam0)`` — plain L1 with scalar level ``lam0``.
- ``ProxL1(lam0, weights)`` — weighted L1, per-coordinate level
  ``lam0 * weights[j]`` (reference ``src/lasso.jl:34, 49``).
- ``ProxZero()`` — no penalty (smooth minimization through the same driver,
  reference ``src/coordinate_descent.jl:41-60``).

Instead of the reference's in-place ``cdprox!(g, x, k, γ)`` scalar
soft-threshold, everything here is a pure, vectorizable function: the solver
applies ``soft_threshold`` to whole blocks of coordinates at once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp


def soft_threshold(x, t):
    """Elementwise soft-thresholding ``sign(x) * max(|x| - t, 0)``.

    Semantics of the reference's ``cdprox!`` with threshold ``t``
    (SURVEY.md §2 C8: ``x_k ← prox(x_k + b/a; n λ_k / a)``).
    """
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - t, 0)


class ProxL1(NamedTuple):
    """(Weighted) L1 penalty ``Σ_j lam0 · weights_j · |x_j|``.

    ``weights is None`` reproduces the reference's unweighted
    ``ProxL1{T, Nothing}``; an array reproduces the weighted variant.
    ``lam0`` may be a traced JAX scalar (it participates in outer σ loops).
    """

    lam0: jnp.ndarray
    weights: Optional[jnp.ndarray] = None

    def weight_vector(self, p: int, dtype) -> jnp.ndarray:
        """Per-coordinate multiplicative weights (ones when unweighted)."""
        if self.weights is None:
            return jnp.ones((p,), dtype=dtype)
        w = jnp.asarray(self.weights, dtype=dtype)
        if w.shape != (p,):
            raise ValueError(
                f"penalty weight vector has shape {w.shape}, expected ({p},)"
            )
        return w


def group_soft_threshold(v, t, axis=-1, keepdims=True):
    """Group (block) soft-thresholding ``v · max(0, 1 − t/‖v‖₂)``.

    The prox of ``t·‖·‖₂`` — the reference's ``ProximalBase`` atom prox
    applied by ``cdprox!`` to each ``AtomIterate`` atom (the group analogue
    of the scalar soft threshold, see coordinate_descent.jl:8).
    """
    nrm = jnp.sqrt(jnp.sum(v * v, axis=axis, keepdims=keepdims))
    scale = jnp.maximum(1.0 - t / jnp.maximum(nrm, 1e-30), 0.0)
    return v * scale


class ProxL1Group(NamedTuple):
    """Group-L1 penalty ``Σ_g lam0 · weights_g · ‖x_g‖₂`` over consecutive
    equal-size groups of ``group_size`` coordinates.

    The blocked analogue of the reference driver's ``AtomIterate`` support
    (coordinate_descent.jl:8, test/atom_iterator.jl:32-85): ProximalBase's
    ``AtomIterate`` splits the iterate into equal atoms and ``cdprox!``
    applies the ℓ2 prox per atom.  ``group_size`` is static (it shapes the
    compiled program); ``weights`` is per-GROUP (length ``ceil(p/G)``).
    """

    lam0: jnp.ndarray
    group_size: int = 1
    weights: Optional[jnp.ndarray] = None


class ProxZero(NamedTuple):
    """No penalty: the driver minimizes the smooth loss only.

    Implemented as λ = 0 in the block engine (the soft-threshold becomes the
    identity), matching reference ``src/coordinate_descent.jl:41-60``.
    """


def as_l1(g, p: int, dtype):
    """Normalize a penalty (ProxL1 / ProxZero) to ``(lam0, weight_vector)``."""
    if isinstance(g, ProxZero):
        return jnp.zeros((), dtype=dtype), jnp.ones((p,), dtype=dtype)
    if isinstance(g, ProxL1):
        lam0 = jnp.asarray(g.lam0, dtype=dtype)
        return lam0, g.weight_vector(p, dtype)
    raise TypeError(f"unsupported penalty type: {type(g)!r}")
