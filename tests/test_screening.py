"""Gap-safe screening tests.

Screening must be *exact*: solutions with ``screen=True`` equal solutions
with ``screen=False`` (it only skips coordinates provably zero at the
optimum).  Also pins which cached gradients a full check refreshes and
checks the rule actually fires (candidate set ≪ p near convergence) while never
discarding a support coordinate.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import coordinatedescent_jl_tpu as cd
from coordinatedescent_jl_tpu.ops.block_cd import (
    _full_check,
    _gap_safe_candidates,
    _init_state,
    _to_blocked_beta,
    build_blocked,
)


def _gen(n, p, s, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    sup = rng.choice(p, s, replace=False)
    beta[sup] = rng.standard_normal(s) + np.sign(rng.standard_normal(s))
    y = X @ beta + noise * rng.standard_normal(n)
    return jnp.asarray(X), jnp.asarray(y), sup


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_screening_is_exact(seed, weighted):
    X, y, _ = _gen(200, 96, 8, seed=seed)
    p = X.shape[1]
    w = None
    if weighted:
        rng = np.random.default_rng(seed + 10)
        w = jnp.asarray(0.5 + np.abs(rng.standard_normal(p)))
    base = cd.CDOptions(block_size=16, randomize=False)
    s_on = cd.lasso(X, y, 0.1, weights=w, options=base.replace(screen=True))
    s_off = cd.lasso(X, y, 0.1, weights=w,
                     options=base.replace(screen=False))
    np.testing.assert_allclose(s_on.x, s_off.x, atol=1e-9)


def test_screening_exact_on_cold_path(seed=3):
    X, y, _ = _gen(150, 64, 6, seed=seed)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.03), 8))
    base = cd.CDOptions(block_size=16)
    p_on = cd.lasso_path(X, y, lams, options=base.replace(screen=True),
                         standardize_X=True)
    p_off = cd.lasso_path(X, y, lams, options=base.replace(screen=False),
                          standardize_X=True)
    np.testing.assert_allclose(p_on.beta_path, p_off.beta_path, atol=1e-9)


def test_screening_exact_cold_start():
    X, y, _ = _gen(120, 80, 5, seed=4)
    base = cd.CDOptions(block_size=16, warm_start=False, num_steps=20)
    s_on = cd.lasso(X, y, 0.08, options=base.replace(screen=True))
    s_off = cd.lasso(X, y, 0.08, options=base.replace(screen=False))
    np.testing.assert_allclose(s_on.x, s_off.x, atol=1e-9)


def test_candidates_small_but_cover_support():
    """Near the optimum the safe sphere is tight: most blocks screen out,
    and no block containing a nonzero optimal coordinate is screened."""
    X, y, _ = _gen(300, 256, 6, seed=5)
    B = 16
    opts = cd.CDOptions(block_size=B, randomize=False)
    lam = 0.15
    sol = cd.lasso(X, y, lam, options=opts)
    beta = np.asarray(sol.x)
    prob = build_blocked("ls", opts, jnp.ones((X.shape[1],), X.dtype),
                         X=X, y=y)
    st = _init_state("ls", prob, _to_blocked_beta(sol.x, B),
                     jax.random.PRNGKey(0))
    # exact cached gradient (drift = 0), as after a confirming sweep
    c = jnp.einsum("bnk,n->bk", prob.Xwb, st.r)
    st = st._replace(c=c, drift=jnp.zeros_like(st.drift))
    n_scale = jnp.asarray(float(X.shape[0]), X.dtype)
    rn2 = st.r @ st.r
    cand = np.asarray(_gap_safe_candidates(prob, st, jnp.asarray(lam),
                                           n_scale, rn2))
    sup_blocks = np.unique(np.nonzero(beta)[0] // B)
    assert all(cand[b] for b in sup_blocks), "support block screened!"
    assert cand.sum() < 0.5 * cand.shape[0], (
        f"screening too weak: {cand.sum()}/{cand.shape[0]} candidates")


def test_candidates_conservative_with_stale_cache():
    """With a large drift bound the rule must keep everything."""
    X, y, _ = _gen(100, 64, 4, seed=6)
    B = 16
    opts = cd.CDOptions(block_size=B)
    prob = build_blocked("ls", opts, jnp.ones((X.shape[1],), X.dtype),
                         X=X, y=y)
    st = _init_state("ls", prob, _to_blocked_beta(
        jnp.zeros((X.shape[1],), X.dtype), B), jax.random.PRNGKey(0))
    n_scale = jnp.asarray(float(X.shape[0]), X.dtype)
    rn2 = st.r @ st.r
    cand = np.asarray(_gap_safe_candidates(prob, st, jnp.asarray(0.1),
                                           n_scale, rn2))
    assert cand.all()


_STALE = {"none": [], "one": [3], "some": [0, 2, 3], "all": range(6)}


@pytest.mark.parametrize("kind", ["ls", "wls", "sqrt"])
@pytest.mark.parametrize("which", sorted(_STALE))
def test_full_check_refreshes_only_needed_blocks(which, kind):
    """A full check refreshes the cached gradient of exactly the blocks it
    cannot certify (here: the stale ones) from the dense blocked einsum,
    keeps the cached rows and drift of the others, and accounts one whole
    design read when it refreshes anything, none otherwise."""
    rng = np.random.default_rng(7)
    n, nb, B = 50, 6, 8
    X = jnp.asarray(rng.standard_normal((n, nb * B)))
    y = jnp.asarray(rng.standard_normal(n))
    w = jnp.asarray(0.3 + rng.random(n)) if kind == "wls" else None
    prob = build_blocked(kind, cd.CDOptions(block_size=B),
                         jnp.ones((nb * B,)), X=X, y=y, w=w)
    need = np.zeros(nb, bool)
    need[list(_STALE[which])] = True
    c_prev = rng.standard_normal((nb, B))
    drift = np.where(need, 1e30, 0.0)
    st = _init_state(kind, prob, jnp.zeros((nb, B)), jax.random.PRNGKey(0))
    st = st._replace(c=jnp.asarray(c_prev), drift=jnp.asarray(drift))
    st2, _, xe = _full_check(kind, prob, st, jnp.asarray(0.1),
                             jnp.asarray(float(n)), 1e-7, None, count_x=True)
    want = np.einsum("bnk,n->bk", np.asarray(prob.Xwb), np.asarray(st.r))
    c2 = np.asarray(st2.c)
    np.testing.assert_allclose(c2[need], want[need], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(c2[~need], c_prev[~need])
    np.testing.assert_array_equal(np.asarray(st2.drift),
                                  np.where(need, 0.0, drift))
    assert float(xe) == (n * nb * B if need.any() else 0.0)


def test_screening_exact_scaled_lasso():
    """The σ outer loop re-screens at every round's effective λ."""
    X, y, _ = _gen(150, 64, 5, seed=8)
    lam = float(np.sqrt(2 * np.log(64) / 150))
    base = cd.CDOptions(block_size=16)
    o_on = cd.IterLassoOptions(options_cd=base.replace(screen=True))
    o_off = cd.IterLassoOptions(options_cd=base.replace(screen=False))
    s_on = cd.scaled_lasso(X, y, lam, options=o_on)
    s_off = cd.scaled_lasso(X, y, lam, options=o_off)
    np.testing.assert_allclose(s_on.x, s_off.x, atol=1e-9)
    np.testing.assert_allclose(float(s_on.sigma), float(s_off.sigma),
                               atol=1e-10)
