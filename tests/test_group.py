"""Group-atom (AtomIterate) engine tests.

The reference driver accepts ``AtomIterate`` group atoms
(coordinate_descent.jl:8) with ProximalBase's per-atom ℓ2 prox — the group
Lasso.  Following SURVEY.md §4 pattern 2, the engine is checked against an
independent NumPy sequential group-CD oracle (exact per-group minimization
by iterated prox steps), plus direct group-KKT certificates and the
G=1 ⇒ plain-Lasso reduction.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import coordinatedescent_jl_tpu as cd


def group_cd_oracle(X, y, lam, G, w=None, tol=1e-11, max_pass=3000,
                    row_w=None):
    """Sequential group CD; each group minimized to (numerical) exactness
    by iterating prox-gradient steps with L = λmax(Xw_g'X_g).  ``row_w``
    gives the weighted-LS loss Σ w_i(y_i − X_iβ)²/(2n) (reference
    CDWeightedLSLoss, cd_differentiable_function.jl:118-194, at atom
    granularity)."""
    n, p = X.shape
    ng = p // G
    assert ng * G == p
    w = np.ones(ng) if w is None else np.asarray(w)
    Xw = X if row_w is None else X * np.asarray(row_w)[:, None]
    beta = np.zeros(p)
    r = y.copy()
    Ls, Ks = [], []
    for g in range(ng):
        K = Xw[:, g * G:(g + 1) * G].T @ X[:, g * G:(g + 1) * G]
        Ks.append(K)
        Ls.append(np.linalg.eigvalsh(0.5 * (K + K.T))[-1])
    for _ in range(max_pass):
        maxh = 0.0
        for g in range(ng):
            Xg = X[:, g * G:(g + 1) * G]
            b0 = beta[g * G:(g + 1) * G].copy()
            c0 = Xw[:, g * G:(g + 1) * G].T @ r
            L, K = Ls[g], Ks[g]
            t = n * lam * w[g] / L
            b = b0.copy()
            for _ in range(10000):
                z = b + (c0 - K @ (b - b0)) / L
                nz = np.linalg.norm(z)
                bn = z * max(0.0, 1.0 - t / nz) if nz > 0 else z * 0.0
                if np.max(np.abs(bn - b)) < 1e-14:
                    b = bn
                    break
                b = bn
            h = b - b0
            maxh = max(maxh, np.max(np.abs(h)))
            r -= Xg @ h
            beta[g * G:(g + 1) * G] = b
        if maxh < tol:
            break
    return beta, r


def _gen(n, p, G, s_groups, seed=0, noise=0.5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    ng = p // G
    beta = np.zeros(p)
    gsup = rng.choice(ng, s_groups, replace=False)
    for g in gsup:
        beta[g * G:(g + 1) * G] = rng.standard_normal(G)
    y = X @ beta + noise * rng.standard_normal(n)
    return X, y, np.sort(gsup)


def _group_kkt(X, y, beta, lam, G, w=None, tol=1e-6):
    """Max group-KKT violation: zero groups need ‖X_g'r‖₂ ≤ n·λ·ω_g,
    active groups need X_g'r = n·λ·ω_g · β_g/‖β_g‖₂."""
    n, p = X.shape
    ng = p // G
    w = np.ones(ng) if w is None else np.asarray(w)
    r = y - X @ beta
    worst = 0.0
    for g in range(ng):
        Xg = X[:, g * G:(g + 1) * G]
        cg = Xg.T @ r
        bg = beta[g * G:(g + 1) * G]
        lvl = n * lam * w[g]
        if np.all(bg == 0):
            worst = max(worst, (np.linalg.norm(cg) - lvl) / max(lvl, 1e-30))
        else:
            want = lvl * bg / np.linalg.norm(bg)
            worst = max(worst, np.max(np.abs(cg - want)) / max(lvl, 1e-30))
    return worst


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("G", [4, 8])
def test_group_lasso_matches_oracle(seed, G):
    X, y, gsup = _gen(150, 64, G, 3, seed=seed)
    lam = 0.08
    opts = cd.CDOptions(opt_tol=1e-9, randomize=False)
    sol = cd.group_lasso(X, y, lam, G, options=opts)
    beta_np, _ = group_cd_oracle(X, y, lam, G)
    np.testing.assert_allclose(np.asarray(sol.x), beta_np, atol=1e-6)
    assert _group_kkt(X, y, np.asarray(sol.x), lam, G) < 1e-5


def test_group_lasso_weighted_matches_oracle():
    X, y, _ = _gen(120, 48, 6, 3, seed=3)
    ng = 48 // 6
    rng = np.random.default_rng(9)
    w = 0.5 + rng.random(ng)
    lam = 0.1
    sol = cd.group_lasso(X, y, lam, 6, weights=jnp.asarray(w),
                         options=cd.CDOptions(opt_tol=1e-9))
    beta_np, _ = group_cd_oracle(X, y, lam, 6, w=w)
    np.testing.assert_allclose(np.asarray(sol.x), beta_np, atol=1e-6)


def test_group_wls_matches_oracle():
    """Weighted-LS group CD (the loss-generic driver acceptance,
    coordinate_descent.jl:8): must match the row-weighted NumPy oracle and
    satisfy the weighted group-KKT conditions ‖Xw_g'r‖ ≤ n·λ·ω_g."""
    X, y, _ = _gen(140, 48, 4, 3, seed=11)
    rng = np.random.default_rng(13)
    rw = 0.2 + rng.random(140)          # kernel-like positive row weights
    lam = 0.08
    opts = cd.CDOptions(opt_tol=1e-10, randomize=False)
    loss = cd.WeightedLSLoss(jnp.asarray(y), jnp.asarray(X),
                             jnp.asarray(rw))
    beta, r = cd.group_coordinate_descent(
        jnp.zeros(48), loss, cd.ProxL1Group(lam, 4), opts)
    beta_np, r_np = group_cd_oracle(X, y, lam, 4, row_w=rw)
    np.testing.assert_allclose(np.asarray(beta), beta_np, atol=1e-7)
    np.testing.assert_allclose(np.asarray(r), r_np, atol=1e-7)
    # weighted group-KKT certificate
    n = 140
    Xw = X * rw[:, None]
    rr = y - X @ np.asarray(beta)
    for g in range(48 // 4):
        cg = Xw[:, g * 4:(g + 1) * 4].T @ rr
        bg = np.asarray(beta)[g * 4:(g + 1) * 4]
        if np.all(bg == 0):
            assert np.linalg.norm(cg) <= n * lam * (1 + 1e-6)
        else:
            target = n * lam * bg / np.linalg.norm(bg)
            np.testing.assert_allclose(cg, target, atol=1e-5 * n * lam)


def test_group_wls_unit_weights_match_ls():
    """Weighted path with w≡1 must agree with the plain-LS group path
    bitwise (same Grams, same trajectory)."""
    X, y, _ = _gen(100, 32, 4, 2, seed=17)
    lam = 0.1
    opts = cd.CDOptions(opt_tol=1e-10, randomize=False)
    b_ls, _ = cd.group_coordinate_descent(
        jnp.zeros(32), cd.LeastSquaresLoss(jnp.asarray(y), jnp.asarray(X)),
        cd.ProxL1Group(lam, 4), opts)
    b_w, _ = cd.group_coordinate_descent(
        jnp.zeros(32),
        cd.WeightedLSLoss(jnp.asarray(y), jnp.asarray(X), jnp.ones(100)),
        cd.ProxL1Group(lam, 4), opts)
    np.testing.assert_array_equal(np.asarray(b_ls), np.asarray(b_w))


def test_group_lasso_group_sparsity_pattern():
    """Sparsity is group-structured: a group is all-zero or (generically)
    all-nonzero, and planted groups are recovered at a reasonable λ."""
    X, y, gsup = _gen(300, 80, 8, 2, seed=5, noise=0.2)
    sol = cd.group_lasso(X, y, 0.08, 8, options=cd.CDOptions(opt_tol=1e-9))
    b = np.asarray(sol.x).reshape(-1, 8)
    nz_groups = np.nonzero(np.any(b != 0, axis=1))[0]
    assert set(gsup) <= set(nz_groups)
    for g in nz_groups:
        assert np.all(b[g] != 0)


def test_group_size_one_reduces_to_lasso():
    """G=1: ‖β_g‖₂ = |β_j| — must match the scalar-L1 engine exactly."""
    X, y, _ = _gen(100, 32, 1, 6, seed=7)
    lam = 0.1
    opts = cd.CDOptions(opt_tol=1e-10, randomize=False)
    g1 = cd.group_lasso(X, y, lam, 1, options=opts)
    l1 = cd.lasso(X, y, lam, options=opts)
    np.testing.assert_allclose(np.asarray(g1.x), np.asarray(l1.x),
                               atol=1e-7)


def test_group_cold_start_continuation():
    X, y, _ = _gen(100, 40, 4, 3, seed=8)
    lam = 0.05
    opts = cd.CDOptions(opt_tol=1e-9, randomize=False)
    warm = cd.group_lasso(X, y, lam, 4, options=opts)
    coldo = opts.replace(warm_start=False, num_steps=20)
    cold = cd.group_lasso(X, y, lam, 4, options=coldo)
    np.testing.assert_allclose(np.asarray(cold.x), np.asarray(warm.x),
                               atol=1e-6)


def test_driver_accepts_group_penalty():
    """The main coordinate_descent driver accepts ProxL1Group — the
    reference's AtomIterate driver contract (coordinate_descent.jl:8)."""
    X, y, _ = _gen(80, 24, 4, 2, seed=11)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    g = cd.ProxL1Group(0.1, 4)
    beta, r = cd.coordinate_descent(
        jnp.zeros((24,), Xj.dtype), cd.LeastSquaresLoss(yj, Xj), g,
        cd.CDOptions(opt_tol=1e-9))
    beta_np, r_np = group_cd_oracle(X, y, 0.1, 4)
    np.testing.assert_allclose(np.asarray(beta), beta_np, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r), r_np, atol=1e-5)


def test_group_padding_uneven_p():
    """p not divisible by G exercises the padded tail group."""
    X, y, _ = _gen(90, 30, 5, 2, seed=13)
    X = X[:, :27]            # p=27, G=5 → 6 groups, last padded
    beta_ref, _ = group_cd_oracle(
        np.pad(X, ((0, 0), (0, 3))), y, 0.1, 5)
    sol = cd.group_lasso(X, y, 0.1, 5, options=cd.CDOptions(opt_tol=1e-9))
    np.testing.assert_allclose(np.asarray(sol.x), beta_ref[:27], atol=1e-6)


def test_group_anticorrelated_pair_no_nan():
    """A group holding an anti-correlated column pair (x, −x) defeats a
    deterministic power-iteration start (K·1 = 0 ⇒ majorizer collapse ⇒
    NaN MM visits) — regression for the randomized start + trace
    fallback."""
    rng = np.random.default_rng(21)
    n = 80
    x1 = rng.standard_normal(n)
    x2 = rng.standard_normal(n)
    X = np.stack([x1, -x1, x2, 0.5 * x2 + rng.standard_normal(n)], axis=1)
    y = X @ np.array([1.0, 0.0, -0.5, 0.2]) + 0.1 * rng.standard_normal(n)
    sol = cd.group_lasso(X, y, 0.05, 2, options=cd.CDOptions(opt_tol=1e-9))
    b = np.asarray(sol.x)
    assert np.all(np.isfinite(b))
    assert _group_kkt(X, y, b, 0.05, 2) < 1e-6


def test_group_f32_noise_floor_converges():
    """f32 group solve at the reference-default opt_tol=1e-7 (below the
    dtype's step floor): the per-coordinate noise floor in the group full
    check (noise_floor_mask with diag(K_b)/L_b scale) must end the solve
    without burning the stall budget, with the f64 group support
    recovered."""
    X, y, gsup = _gen(200, 64, 8, 3, seed=4)
    X32 = jnp.asarray(np.asarray(X), jnp.float32)
    y32 = jnp.asarray(np.asarray(y), jnp.float32)
    lam = 0.08
    opts = cd.CDOptions(opt_tol=1e-7, randomize=False)
    sol32 = cd.group_lasso(X32, y32, lam, 8, options=opts)
    sol64 = cd.group_lasso(X, y, lam, 8, options=opts)
    g32 = set(np.nonzero(np.any(
        np.asarray(sol32.x).reshape(-1, 8) != 0, axis=1))[0])
    g64 = set(np.nonzero(np.any(
        np.asarray(sol64.x).reshape(-1, 8) != 0, axis=1))[0])
    assert g32 == g64
    np.testing.assert_allclose(np.asarray(sol32.x), np.asarray(sol64.x),
                               atol=5e-5)


def group_sqrt_oracle(X, y, lam, G, w=None, mm_rounds=60, tol=1e-12):
    """NumPy MM oracle for ``min ‖y−Xβ‖₂ + λ Σ_g ω_g‖β_g‖``: each round
    fixes ρ = ‖r‖ and solves the LS group lasso with threshold ρ·λ·ω_g
    via group_cd_oracle (whose threshold is n·lam'·ω ⇒ lam' = λ·ρ/n),
    warm-started by re-entering with the previous solution folded into a
    fresh cold solve (the oracle is cold-start; MM still converges)."""
    n = X.shape[0]
    rho = float(np.linalg.norm(y))
    beta = np.zeros(X.shape[1])
    for _ in range(mm_rounds):
        beta, r = group_cd_oracle(X, y, lam * rho / n, G, w=w, tol=tol)
        rho_new = float(np.linalg.norm(r))
        if abs(rho_new - rho) <= 1e-12 * rho:
            rho = rho_new
            break
        rho = rho_new
    return beta, r, rho


def _group_sqrt_kkt(X, y, beta, lam, G, w=None):
    """Max sqrt-group-KKT violation (zero rule ‖X_g'r‖ ≤ λ·ω_g·‖r‖)."""
    p = X.shape[1]
    ng = p // G
    w = np.ones(ng) if w is None else np.asarray(w)
    r = y - X @ beta
    rho = np.linalg.norm(r)
    worst = 0.0
    for g in range(ng):
        cg = X[:, g * G:(g + 1) * G].T @ r
        bg = beta[g * G:(g + 1) * G]
        lvl = lam * w[g] * rho
        if np.all(bg == 0):
            worst = max(worst, (np.linalg.norm(cg) - lvl) / lvl)
        else:
            want = lvl * bg / np.linalg.norm(bg)
            worst = max(worst, np.max(np.abs(cg - want)) / lvl)
    return worst


@pytest.mark.parametrize("G", [4, 6])
def test_group_sqrt_matches_oracle(G):
    """Group atoms × sqrt loss (the last cell of the
    reference driver's loss×iterate acceptance matrix,
    coordinate_descent.jl:8): the MM engine must match an independent
    NumPy MM oracle and satisfy the sqrt group-KKT conditions."""
    X, y, gsup = _gen(150, 48, G, 3, seed=7)
    lam = 1.1 * np.sqrt(2 * np.log(X.shape[1]) / X.shape[0]) * np.sqrt(
        X.shape[0])  # λ·‖r‖ scale (engine's plain-‖r‖ normalization)
    beta_np, r_np, rho = group_sqrt_oracle(X, y, lam, G)
    loss = cd.SqrtLassoLoss(jnp.asarray(y), jnp.asarray(X))
    pen = cd.ProxL1Group(lam, G, None)
    opts = cd.CDOptions(opt_tol=1e-11, randomize=False)
    beta, r = cd.group_coordinate_descent(
        jnp.zeros((X.shape[1],)), loss, pen, opts)
    assert _group_sqrt_kkt(X, y, np.asarray(beta), lam, G) < 1e-7
    np.testing.assert_allclose(np.asarray(beta), beta_np, atol=5e-8)
    np.testing.assert_allclose(np.asarray(r), r_np, atol=5e-8)
    # weighted + warm-start path
    ng = X.shape[1] // G
    wg = 0.5 + np.arange(ng) / ng
    beta_npw, _, _ = group_sqrt_oracle(X, y, lam, G, w=wg)
    penw = cd.ProxL1Group(lam, G, jnp.asarray(wg))
    betaw, _ = cd.group_coordinate_descent(
        jnp.asarray(beta_np), cd.SqrtLassoLoss(jnp.asarray(y),
                                               jnp.asarray(X)), penw,
        opts.replace(warm_start=True))
    assert _group_sqrt_kkt(X, y, np.asarray(betaw), lam, G, w=wg) < 1e-7
    np.testing.assert_allclose(np.asarray(betaw), beta_npw, atol=5e-8)
