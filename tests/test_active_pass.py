"""Active pass (``block_cd._active_pass``): exact vs ista inner solvers.

The within-block solver is ``CDOptions.inner``: ``'exact'`` is the
reference's sequential Gauss-Seidel scan, ``'ista'`` the vectorized FISTA
block solve with a zero-snap epilogue.  Both have the same fixed points, so
a solve with either converges to the same KKT-certified solution; the pass
visits only the active blocks either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import coordinatedescent_jl_tpu as cd
from coordinatedescent_jl_tpu.ops.block_cd import (
    _active_pass,
    _init_state,
    _resolve_inner,
    _to_blocked_beta,
    build_blocked,
)


def _gen(n, p, s, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[rng.choice(p, s, replace=False)] = rng.standard_normal(s) + 1.0
    y = X @ beta + 0.3 * rng.standard_normal(n)
    return jnp.asarray(X, dtype), jnp.asarray(y, dtype)


def test_ista_inner_reaches_same_solution():
    # inexact vectorized block solves must converge to the same KKT point
    X, y = _gen(120, 90, 10, seed=23)
    lam = 0.1
    s_exact = cd.lasso(X, y, lam,
                       options=cd.CDOptions(block_size=16, inner="exact"))
    s_ista = cd.lasso(X, y, lam,
                      options=cd.CDOptions(block_size=16, inner="ista",
                                           block_iters=16))
    np.testing.assert_allclose(s_ista.x, s_exact.x, atol=1e-5)
    gap = cd.lasso_duality_gap(X, y, s_ista.x, lam)
    assert float(gap) < 1e-6


def test_sqrt_ista_inner_reaches_same_solution():
    # the MM-majorized ISTA inner for sqrt-lasso must reach the same
    # KKT point as the exact three-branch scan
    X, y = _gen(110, 72, 8, seed=29)
    lam = 1.1 * np.sqrt(2 * np.log(72) / 110)
    s_exact = cd.sqrt_lasso(X, y, lam, standardize_X=False,
                            options=cd.CDOptions(block_size=16,
                                                 inner="exact"))
    s_ista = cd.sqrt_lasso(X, y, lam, standardize_X=False,
                           options=cd.CDOptions(block_size=16,
                                                inner="ista",
                                                block_iters=24))
    np.testing.assert_allclose(s_ista.x, s_exact.x, atol=1e-5)


@pytest.mark.parametrize("cache_gram", [False, True])
@pytest.mark.parametrize("kind", ["ls", "wls", "sqrt"])
def test_ista_pass_matches_exact_pass(kind, cache_gram):
    """The solver driven by the ista pass reaches the exact pass's
    solution — same support, coefficients within the f64 solver
    tolerance — for every loss the ista inner serves, with and without
    the cached per-block Grams."""
    X, y = _gen(96, 80, 6, seed=41)
    base = cd.CDOptions(block_size=16, cache_gram=cache_gram,
                        randomize=False, opt_tol=1e-10)
    if kind == "sqrt":
        def solve(o):
            return cd.sqrt_lasso(X, y, 1.2 * np.sqrt(2 * np.log(80) / 96),
                                 standardize_X=False, options=o).x
    else:
        w = (jnp.asarray(0.3 + np.random.default_rng(5).random(96))
             if kind == "wls" else None)
        loss = (cd.WeightedLSLoss(y, X, w) if kind == "wls"
                else cd.LeastSquaresLoss(y, X))

        def solve(o):
            return cd.coordinate_descent(jnp.zeros(80), loss,
                                         cd.ProxL1(0.08), o)[0]
    b_exact = np.asarray(solve(base.replace(inner="exact")))
    b_ista = np.asarray(solve(base.replace(inner="ista")))
    np.testing.assert_array_equal(b_ista != 0, b_exact != 0)
    np.testing.assert_allclose(b_ista, b_exact, atol=1e-7)


@pytest.mark.parametrize("inner", ["exact", "ista"])
def test_active_pass_touches_only_active_blocks(inner):
    """Inactive blocks' coordinates are bit-identical after a pass, active
    blocks' coordinates may move (reference sparse-iterate semantics: only
    nonzero atoms are visited, atom_iterator.jl:57-75)."""
    rng = np.random.default_rng(3)
    n, p, B = 64, 96, 16
    X = jnp.asarray(rng.standard_normal((n, p)), jnp.float32)
    y = jnp.asarray(rng.standard_normal(n), jnp.float32)
    opts = cd.CDOptions(block_size=B, inner=inner, randomize=False)
    prob = build_blocked("ls", opts, jnp.ones((p,), jnp.float32), X=X, y=y)
    nb = p // B
    beta0 = rng.standard_normal(p).astype(np.float32)
    beta_b = _to_blocked_beta(jnp.asarray(beta0), B)
    st = _init_state("ls", prob, beta_b, jax.random.PRNGKey(0))
    active = jnp.asarray([True, False, True, False, True, False])
    st = st._replace(active=active)
    nsc = jnp.asarray(float(n), jnp.float32)
    st2, _ = _active_pass("ls", prob, st, jnp.asarray(0.05, jnp.float32),
                          nsc, False, opts)
    b2 = np.asarray(st2.beta)
    b0 = np.asarray(beta_b)
    for b in range(nb):
        if bool(active[b]):
            assert not np.array_equal(b2[b], b0[b]), f"block {b} unmoved"
        else:
            np.testing.assert_array_equal(b2[b], b0[b],
                                          err_msg=f"block {b} touched")
    # the residual stays consistent with the moved coordinates
    r_want = np.asarray(y) - np.asarray(X) @ b2.reshape(-1)
    np.testing.assert_allclose(np.asarray(st2.r), r_want, atol=1e-4)


@pytest.mark.parametrize("kind,dtype,inner,want", [
    ("ls", jnp.float32, "auto", "ista"),
    ("sqrt", jnp.float32, "auto", "ista"),
    ("ls", jnp.float64, "auto", "exact"),
    ("quad", jnp.float32, "ista", "exact"),
])
def test_resolve_inner(kind, dtype, inner, want):
    """Auto picks ista below f64 on the regression losses; f64 keeps the
    reference-exact scan, and quad always runs it."""
    assert _resolve_inner(kind, cd.CDOptions(inner=inner), dtype) == want


@pytest.mark.parametrize("screen", [True, False])
def test_plain_f32_check_matches_f64_oracle(screen):
    """An f32 solve (auto inner = ista, plain XLA full check) reaches the
    NumPy f64 sequential-CD oracle's solution: same support, coefficients
    within the f32 solver tolerance."""
    import sys
    import os
    sys.path.insert(0, os.path.dirname(__file__))
    from oracle import cd_lasso

    X, y = _gen(200, 300, 8, seed=7)
    lam = 0.15
    beta_o, _ = cd_lasso(np.asarray(X), np.asarray(y), lam, tol=1e-12)
    sol = cd.lasso(X.astype(jnp.float32), y.astype(jnp.float32), lam,
                   options=cd.CDOptions(opt_tol=1e-6, screen=screen))
    b = np.asarray(sol.x, np.float64)
    np.testing.assert_array_equal(b != 0, beta_o != 0)
    np.testing.assert_allclose(b, beta_o, atol=5e-5)


@pytest.mark.gpu
def test_highest_precision_is_full_f32_on_gpu(gpu):
    """Solver-critical contractions pin ``Precision.HIGHEST``; on the card
    that must mean full f32, not TF32 (a 10-bit mantissa: ~1e-5 error
    relative to ``|A|ᵀ|v|`` at this length, against ~1e-9 for f32).
    Checked for the matvec and the blocked einsum the engine uses."""
    rng = np.random.default_rng(0)
    n, p, B = 4096, 512, 128
    A = rng.standard_normal((n, p)).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    Ab = np.ascontiguousarray(A.reshape(n, p // B, B).transpose(1, 0, 2))
    want = A.T.astype(np.float64) @ v
    scale = np.abs(A.T).astype(np.float64) @ np.abs(v)
    hi = jax.lax.Precision.HIGHEST
    dA, dv, dAb = (jax.device_put(a, gpu) for a in (A, v, Ab))
    dot = jax.jit(lambda A, v: jnp.dot(v, A, precision=hi))(dA, dv)
    blk = jax.jit(lambda Ab, v: jnp.einsum("bnk,n->bk", Ab, v,
                                           precision=hi))(dAb, dv)
    for got in (np.asarray(dot), np.asarray(blk).reshape(-1)):
        assert np.max(np.abs(got - want) / scale) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("inner", ["exact", "ista"])
def test_gpu_f32_solve_matches_f64_oracle(gpu, inner):
    """Compiled for the card, an f32 solve with either inner solver
    reaches the NumPy f64 sequential-CD oracle's support and
    coefficients."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from oracle import cd_lasso

    rng = np.random.default_rng(7)
    X = rng.standard_normal((200, 300))
    beta = np.zeros(300)
    beta[rng.choice(300, 8, replace=False)] = rng.standard_normal(8) + 1.0
    y = X @ beta + 0.3 * rng.standard_normal(200)
    beta_o, _ = cd_lasso(X, y, 0.15, tol=1e-12)
    sol = cd.lasso(jax.device_put(X.astype(np.float32), gpu),
                   jax.device_put(y.astype(np.float32), gpu), 0.15,
                   options=cd.CDOptions(opt_tol=1e-6, inner=inner))
    assert sol.x.devices() == {gpu}
    b = np.asarray(sol.x, np.float64)
    np.testing.assert_array_equal(b != 0, beta_o != 0)
    np.testing.assert_allclose(b, beta_o, atol=5e-5)
