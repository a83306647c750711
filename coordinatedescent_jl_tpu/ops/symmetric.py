"""Symmetric-matrix coordinate support (``SymmetricSparseIterate``).

The reference driver accepts ``SymmetricSparseIterate`` alongside
``SparseIterate`` and ``AtomIterate`` (coordinate_descent.jl:8): a symmetric
``p × p`` matrix optimized over its ``q = p(p+1)/2`` lower-triangle
coordinates, where writing packed coordinate ``k ↔ (i, j)`` sets both
``M[i, j]`` and ``M[j, i]``.  The reference ships no symmetric loss itself —
the acceptance is driver-level plumbing for downstream estimators (precision
matrices, covariance thresholding) — and its iterator tests pin the packed
coordinate numbering (test/atom_iterator.jl:31-48, :69-85).

Design: the iterate is a dense packed vector (static shape
``q``), solved by the ordinary block engine — the packed representation is
what makes a symmetric problem lane-dense (no wasted upper-triangle lanes,
no scatter/gather of matrix halves inside the hot loop).  Pack/unpack are
one ``take``/``scatter`` each at the problem boundary.

Coordinate order is the packed lower triangle, column-major —
``(0,0), (1,0), …, (p−1,0), (1,1), …`` — matching ProximalBase's
``SymmetricSparseIterate`` linear indexing (Julia/LAPACK 'L' packed
convention; for p=3 the full pass visits exactly the 6 coordinates of
reference test/atom_iterator.jl:38).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def sym_num_coordinates(p: int) -> int:
    """``numCoordinates`` of a ``SymmetricSparseIterate(p)``:
    ``p(p+1)/2`` (reference test/atom_iterator.jl:38 — a full pass over
    ``SymmetricSparseIterate(3)`` visits 6 coordinates)."""
    return p * (p + 1) // 2


def sym_indices(p: int) -> jnp.ndarray:
    """``(q, 2)`` int32 array of ``(row, col)`` pairs (row ≥ col) for each
    packed coordinate, in the packed-lower-triangle column-major order that
    defines the iterate's linear indexing."""
    iu = np.triu_indices(p)
    # upper triangle traversed row-major == lower triangle column-major
    # after the (row, col) swap
    return jnp.asarray(np.stack([iu[1], iu[0]], axis=1), jnp.int32)


def sym_pack(M: jnp.ndarray) -> jnp.ndarray:
    """Pack a symmetric ``(p, p)`` matrix to its ``(q,)`` coordinate
    vector (lower triangle, column-major)."""
    p = M.shape[0]
    ij = sym_indices(p)
    return M[ij[:, 0], ij[:, 1]]


def sym_unpack(v: jnp.ndarray, p: int) -> jnp.ndarray:
    """Expand a ``(q,)`` packed coordinate vector to the full symmetric
    ``(p, p)`` matrix (the iterate's matrix view: coordinate ``k`` sets
    both ``M[i, j]`` and ``M[j, i]``)."""
    ij = sym_indices(p)
    M = jnp.zeros((p, p), v.dtype).at[ij[:, 0], ij[:, 1]].set(v)
    return jnp.where(jnp.eye(p, dtype=bool), M, M + M.T)


def symmetric_coordinate_descent(M0, loss, penalty, options=None, *,
                                 seed: int = 0, key=None):
    """Coordinate descent over a symmetric-matrix iterate — the reference
    driver called with a ``SymmetricSparseIterate``
    (coordinate_descent.jl:8).

    ``M0`` is the symmetric ``(p, p)`` start; ``loss``/``penalty`` are
    over the ``q = p(p+1)/2`` packed coordinates (the loss sees the packed
    vector, exactly as the reference's ``CoordinateDifferentiableFunction``
    sees the iterate's linear coordinates).  Returns ``(M, residuals)``
    with ``M`` the full symmetric solution.
    """
    from .block_cd import coordinate_descent
    from ..utils.options import CDOptions

    if options is None:
        options = CDOptions()
    p = M0.shape[0]
    v0 = sym_pack(jnp.asarray(M0))
    v, r = coordinate_descent(v0, loss, penalty, options, seed=seed,
                              key=key)
    return sym_unpack(v, p), r
