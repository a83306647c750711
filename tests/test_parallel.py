"""Single-device vs sharded equivalence on the 8-device CPU mesh.

SURVEY.md §4 test mapping (b): the standard JAX way to test multi-device
collectives without the devices — ``--xla_force_host_platform_device_count=8``
(set in conftest.py) and a real ``Mesh`` + ``shard_map``.  Every test checks
that the feature-sharded / batch-sharded solver converges to the same
solution as the single-device engine (which is itself oracle-checked in
test_coordinate_descent.py), to solver tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import coordinatedescent_jl_tpu as cd
from coordinatedescent_jl_tpu.parallel import (
    coordinate_descent_row_sharded,
    coordinate_descent_sharded,
    lasso_lambda_batch,
    lasso_path_sharded,
    lasso_row_sharded,
    lasso_sharded,
    locpoly_batch,
    lvocv_locpoly_batch,
    scaled_lasso_sharded,
    sqrt_lasso_row_sharded,
    sqrt_lasso_sharded,
)


OPTS = cd.CDOptions(block_size=16)


@pytest.fixture(scope="module")
def feature_mesh():
    devs = np.array(jax.devices()[:8])
    assert devs.size == 8, "conftest must provide 8 virtual CPU devices"
    return Mesh(devs, ("feature",))

@pytest.fixture(scope="module")
def batch_mesh():
    devs = np.array(jax.devices()[:8])
    return Mesh(devs, ("batch",))


@pytest.fixture(scope="module")
def obs_mesh():
    devs = np.array(jax.devices()[:8])
    return Mesh(devs, ("obs",))


def _gen(n, p, s, seed=0, sigma=0.3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[:s] = rng.standard_normal(s)
    y = X @ beta + sigma * rng.standard_normal(n)
    return jnp.asarray(X), jnp.asarray(y)


def test_sharded_lasso_matches_single_device(feature_mesh):
    X, y = _gen(120, 100, 10)
    lam = 0.1
    sol1 = cd.lasso(X, y, lam, options=OPTS)
    sol8 = lasso_sharded(X, y, lam, feature_mesh, options=OPTS)
    np.testing.assert_allclose(sol8.x, sol1.x, atol=1e-5)
    np.testing.assert_allclose(sol8.residuals, sol1.residuals, atol=1e-5)
    # KKT certificate holds for the sharded solution directly
    gap = cd.lasso_duality_gap(X, y, sol8.x, lam)
    assert float(gap) < 1e-6


def test_sharded_lasso_uneven_p(feature_mesh):
    # p not divisible by (devices × block size) exercises the padding path
    X, y = _gen(90, 37, 5, seed=3)
    lam = 0.15
    sol1 = cd.lasso(X, y, lam, options=OPTS)
    sol8 = lasso_sharded(X, y, lam, feature_mesh, options=OPTS)
    np.testing.assert_allclose(sol8.x, sol1.x, atol=1e-5)


def test_sharded_weighted_lasso(feature_mesh):
    X, y = _gen(80, 64, 6, seed=1)
    rng = np.random.default_rng(11)
    lamw = jnp.asarray(0.5 + rng.random(64))
    g = cd.ProxL1(0.08, lamw)
    loss = cd.LeastSquaresLoss(y, X)
    b1, _ = cd.coordinate_descent(jnp.zeros(64), loss, g, OPTS)
    b8, _ = coordinate_descent_sharded(jnp.zeros(64), loss, g, feature_mesh,
                                       OPTS)
    np.testing.assert_allclose(b8, b1, atol=1e-5)


def test_sharded_cold_start_continuation(feature_mesh):
    X, y = _gen(100, 48, 6, seed=5)
    lam = 0.05
    opts = OPTS.replace(warm_start=False, num_steps=20)
    sol1 = cd.lasso(X, y, lam, options=opts)
    sol8 = lasso_sharded(X, y, lam, feature_mesh, options=opts)
    np.testing.assert_allclose(sol8.x, sol1.x, atol=1e-5)


def test_sharded_sqrt_lasso(feature_mesh):
    X, y = _gen(100, 64, 6, seed=7)
    lam = 0.3 / np.sqrt(100)
    s1 = cd.sqrt_lasso(X, y, lam, options=OPTS, standardize_X=False)
    s8 = sqrt_lasso_sharded(X, y, lam, feature_mesh, options=OPTS)
    np.testing.assert_allclose(s8.x, s1.x, atol=1e-4)


def test_sharded_scaled_lasso_consensus_sigma(feature_mesh):
    X, y = _gen(150, 64, 8, seed=9, sigma=0.5)
    lam = np.sqrt(2 * np.log(64) / 150)
    opts = cd.IterLassoOptions(options_cd=OPTS)
    s1 = cd.scaled_lasso(X, y, lam, options=opts)
    s8 = scaled_lasso_sharded(X, y, lam, feature_mesh, options=opts)
    np.testing.assert_allclose(s8.x, s1.x, atol=1e-4)
    np.testing.assert_allclose(float(s8.penalty.lam0),
                               float(s1.penalty.lam0), rtol=1e-3)


def test_sharded_lasso_path(feature_mesh):
    X, y = _gen(100, 48, 6, seed=13)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 8))
    p1 = cd.lasso_path(X, y, lams, options=OPTS, standardize_X=False)
    p8 = lasso_path_sharded(X, y, lams, feature_mesh, options=OPTS,
                            standardize_X=False)
    assert p8.beta_path.shape == p1.beta_path.shape
    np.testing.assert_allclose(p8.beta_path, p1.beta_path, atol=1e-5)


def test_sharded_path_early_stop(feature_mesh):
    X, y = _gen(100, 48, 6, seed=13)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.01), 10))
    p1 = cd.lasso_path(X, y, lams, options=OPTS, max_hat_s=10,
                       standardize_X=False)
    p8 = lasso_path_sharded(X, y, lams, feature_mesh, options=OPTS,
                            max_hat_s=10, standardize_X=False)
    assert p8.lam_path.shape == p1.lam_path.shape
    np.testing.assert_allclose(p8.beta_path, p1.beta_path, atol=1e-5)


def test_sharded_batched_path_matches_scan(feature_mesh):
    """The batched sharded path (distributed certify GEMM + distributed
    top-k union working set + replicated refinement) must reproduce the
    single-device scan path WITHOUT falling back (a fallback would make
    the equivalence vacuous — sharded scan vs scan)."""
    import warnings

    X, y = _gen(150, 96, 8, seed=17)
    lam_max = float(jnp.abs(X.T @ y / 150).max())
    lams = lam_max * np.logspace(-0.1, -2, 12)
    opts = OPTS.replace(opt_tol=1e-10, randomize=False)
    p1 = cd.lasso_path(X, y, lams, options=opts, standardize_X=False)
    st = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        p8 = lasso_path_sharded(X, y, lams, feature_mesh, options=opts,
                                standardize_X=False, path_batch=4,
                                coarse_stride=4, stats=st)
    # f64: strict certification only — the stall escape never fires
    assert st == {"used_batched": True, "batched_certified": True,
                  "stall_escaped_lanes": 0}
    assert p8.beta_path.shape == p1.beta_path.shape
    np.testing.assert_allclose(p8.beta_path, p1.beta_path, atol=1e-7)


def test_sharded_batched_path_early_stop_and_padding(feature_mesh):
    """max_hat_s truncation semantics + the column-padding path (p = 48
    pads to 128 on the 8-device mesh, so most union-set candidates are
    zero columns) under the batched sharded execution."""
    import warnings

    X, y = _gen(100, 48, 6, seed=13)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.01), 10))
    opts = OPTS.replace(opt_tol=1e-10, randomize=False)
    p1 = cd.lasso_path(X, y, lams, options=opts, max_hat_s=10,
                       standardize_X=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        p8 = lasso_path_sharded(X, y, lams, feature_mesh, options=opts,
                                max_hat_s=10, standardize_X=False,
                                path_batch=4, coarse_stride=3)
    assert p8.lam_path.shape == p1.lam_path.shape
    np.testing.assert_allclose(p8.beta_path, p1.beta_path, atol=1e-7)


def test_sharded_batched_path_small_compact_size(feature_mesh):
    """compact_size=40 < P_tot=128 forces the REAL distributed top-k
    (local top-Cl → all_gather → global top-C prunes columns) and the
    Cp != C pad-slot branch (40 → 48 with owner-less index P_tot) —
    with the default compact_size the union set degenerates to every
    column and that machinery is never exercised."""
    import warnings

    X, y = _gen(150, 96, 8, seed=17)
    lam_max = float(jnp.abs(X.T @ y / 150).max())
    lams = lam_max * np.logspace(-0.1, -2, 12)
    opts = OPTS.replace(opt_tol=1e-10, randomize=False, compact_size=40)
    p1 = cd.lasso_path(X, y, lams, options=opts, standardize_X=False,
                       path_batch=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        p8 = lasso_path_sharded(X, y, lams, feature_mesh, options=opts,
                                standardize_X=False, path_batch=4,
                                coarse_stride=4)
    np.testing.assert_allclose(p8.beta_path, p1.beta_path, atol=1e-7)


def test_sharded_batched_path_batch_axis_validation(feature_mesh):
    """batch_axis must be a mesh axis and must differ from the feature
    axis (sharing one axis deadlocks the collectives — shards would take
    different while_loop trip counts)."""
    X, y = _gen(60, 32, 4)
    lams = np.linspace(0.5, 0.1, 6)
    with pytest.raises(ValueError, match="must differ"):
        lasso_path_sharded(X, y, lams, feature_mesh, options=OPTS,
                           path_batch=2, coarse_stride=2,
                           batch_axis="feature")
    with pytest.raises(ValueError, match="not in mesh"):
        lasso_path_sharded(X, y, lams, feature_mesh, options=OPTS,
                           path_batch=2, coarse_stride=2,
                           batch_axis="nope")


def test_sharded_batched_path_2d_mesh():
    """4×2 (batch × feature) mesh: the batched refinement's λ-lane chunks
    partition over 'batch' while every chunk's certify/refine collectives
    ride 'feature' — must match the single-device scan without fallback."""
    import warnings

    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh2 = Mesh(devs, ("batch", "feature"))
    X, y = _gen(150, 96, 8, seed=17)
    lam_max = float(jnp.abs(X.T @ y / 150).max())
    lams = lam_max * np.logspace(-0.1, -2, 12)
    opts = OPTS.replace(opt_tol=1e-10, randomize=False)
    p1 = cd.lasso_path(X, y, lams, options=opts, standardize_X=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        p8 = lasso_path_sharded(X, y, lams, mesh2, options=opts,
                                standardize_X=False, path_batch=2,
                                coarse_stride=4, batch_axis="batch")
        # uneven chunk count (7 rest lanes → 4 chunks over 4 batch rows)
        p8b = lasso_path_sharded(X, y, lams, mesh2, options=opts,
                                 standardize_X=False, path_batch=2,
                                 coarse_stride=3, batch_axis="batch")
    np.testing.assert_allclose(p8.beta_path, p1.beta_path, atol=1e-7)
    np.testing.assert_allclose(p8b.beta_path, p1.beta_path, atol=1e-7)


def test_lambda_batch_matches_individual_solves(batch_mesh):
    X, y = _gen(90, 40, 5, seed=17)
    lams = np.exp(np.linspace(np.log(0.4), np.log(0.08), 6))  # 6 % 8 != 0
    betas = lasso_lambda_batch(X, y, lams, batch_mesh, options=OPTS)
    assert betas.shape == (6, 40)
    for i, lam in enumerate(lams):
        sol = cd.lasso(X, y, lam, options=OPTS)
        np.testing.assert_allclose(betas[i], sol.x, atol=1e-5)


def test_sharded_path_resumable_trajectory(feature_mesh, tmp_path):
    """Sharded checkpoint/resume: an interrupted
    feature-sharded path resumed from the per-shard checkpoint is
    trajectory-identical (bitwise) to the uninterrupted run — compaction
    forced so the per-shard working-set caches go through the
    persist/re-gather cycle — and both match the sharded scan driver."""
    X, y = _gen(120, 256, 8, seed=31)
    lam_max = float(np.abs(np.asarray(X).T @ np.asarray(y) / 120).max())
    lams = lam_max * np.logspace(-0.3, -1.7, 8)
    opts = cd.CDOptions(block_size=8, compact=True, compact_size=32,
                        randomize=True)
    f1 = str(tmp_path / "full.npz")
    f2 = str(tmp_path / "interrupted.npz")
    p_full = cd.lasso_path_resumable_sharded(
        X, y, lams, f1, feature_mesh, options=opts, standardize_X=False,
        seed=3)
    cd.lasso_path_resumable_sharded(
        X, y, lams[:4], f2, feature_mesh, options=opts,
        standardize_X=False, seed=3)
    ck = cd.load_sharded_checkpoint(f2)
    assert ck.n_shards == 8 and ck.next_index == 4
    cd.save_sharded_checkpoint(f2, ck._replace(lam_path=np.asarray(lams)))
    p_res = cd.lasso_path_resumable_sharded(
        X, y, lams, f2, feature_mesh, options=opts, standardize_X=False,
        seed=3)
    assert np.array_equal(np.asarray(p_res.beta_path),
                          np.asarray(p_full.beta_path))
    c1 = cd.load_sharded_checkpoint(f1)
    c2 = cd.load_sharded_checkpoint(f2)
    for fld in ("beta_warm", "residuals", "key", "c", "drift", "active",
                "ws_idx", "ws_ok", "beta_prev", "lam_k", "lam_km1"):
        assert np.array_equal(getattr(c1, fld), getattr(c2, fld)), fld
    p_scan = lasso_path_sharded(X, y, lams, feature_mesh, options=opts,
                                standardize_X=False, seed=3)
    np.testing.assert_allclose(np.asarray(p_scan.beta_path),
                               np.asarray(p_full.beta_path), atol=1e-9)
    # a mesh-shape mismatch must restart cleanly (never mis-shard the
    # 8-shard ws_idx/c/drift state into 4 shards): resuming f1's 8-shard
    # checkpoint on a 4-device mesh re-solves from scratch and still
    # converges to the same certified path
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("feature",))
    p4 = cd.lasso_path_resumable_sharded(
        X, y, lams, f1, mesh4, options=opts, standardize_X=False, seed=3)
    np.testing.assert_allclose(np.asarray(p4.beta_path),
                               np.asarray(p_full.beta_path), atol=1e-5)
    assert cd.load_sharded_checkpoint(f1).n_shards == 4


def _gen_group(n, ng, G, s_groups, seed=0, sigma=0.3):
    rng = np.random.default_rng(seed)
    p = ng * G
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    gidx = rng.choice(ng, s_groups, replace=False)
    for g in gidx:
        beta[g * G:(g + 1) * G] = rng.standard_normal(G)
    y = X @ beta + sigma * rng.standard_normal(n)
    return jnp.asarray(X), jnp.asarray(y)


def test_sharded_group_lasso_matches_single_device(feature_mesh):
    """Sharded group engine: whole groups
    partitioned over the feature axis, block-Jacobi merge + group-KKT
    certification ≡ the single-device group engine."""
    from coordinatedescent_jl_tpu.parallel import group_lasso_sharded

    X, y = _gen_group(150, 64, 4, 6, seed=41)
    lam = 0.15
    s1 = cd.group_lasso(X, y, lam, 4, options=OPTS)
    s8 = group_lasso_sharded(X, y, lam, 4, feature_mesh, options=OPTS)
    np.testing.assert_allclose(s8.x, s1.x, atol=1e-5)
    np.testing.assert_allclose(s8.residuals, s1.residuals, atol=1e-5)
    # exact group sparsity preserved through the damped merges
    g1 = np.sqrt((np.asarray(s1.x).reshape(-1, 4) ** 2).sum(1))
    g8 = np.sqrt((np.asarray(s8.x).reshape(-1, 4) ** 2).sum(1))
    assert np.array_equal(g1 == 0, g8 == 0)


def test_sharded_group_lasso_uneven_groups(feature_mesh):
    """ng not divisible by shards×(128//G) exercises the group padding."""
    from coordinatedescent_jl_tpu.parallel import group_lasso_sharded

    X, y = _gen_group(100, 37, 3, 4, seed=43)
    lam = 0.2
    s1 = cd.group_lasso(X, y, lam, 3, options=OPTS)
    s8 = group_lasso_sharded(X, y, lam, 3, feature_mesh, options=OPTS)
    np.testing.assert_allclose(s8.x, s1.x, atol=1e-5)


def test_sharded_group_weighted_ls(feature_mesh):
    """Weighted-LS loss through the sharded group driver ≡ single-device
    group_coordinate_descent with the same WeightedLSLoss."""
    from coordinatedescent_jl_tpu.parallel import (
        group_coordinate_descent_sharded,
    )

    X, y = _gen_group(120, 32, 4, 5, seed=47)
    rng = np.random.default_rng(5)
    w = jnp.asarray(0.3 + rng.random(120))
    g = cd.ProxL1Group(0.1, 4, None)
    loss = cd.WeightedLSLoss(y, X, w)
    b1, _ = cd.group_coordinate_descent(jnp.zeros(128), loss, g, OPTS)
    b8, _ = group_coordinate_descent_sharded(jnp.zeros(128), loss, g,
                                             feature_mesh, OPTS)
    np.testing.assert_allclose(b8, b1, atol=1e-5)


def test_sharded_feasible_lasso_matches_single(feature_mesh):
    """Feasible-lasso loadings loop at the sharded tier: shard-local
    loadings + gathered global stop maxes ≡ the single-device core, for
    every init procedure."""
    from coordinatedescent_jl_tpu.parallel import feasible_lasso_sharded

    rng = np.random.default_rng(67)
    n, p, s = 150, 96, 6
    X = rng.standard_normal((n, p))
    # heteroscedastic noise — the estimator's target regime
    het = 0.2 + np.abs(X[:, 0])
    beta = np.zeros(p)
    beta[:s] = rng.standard_normal(s)
    y = X @ beta + het * rng.standard_normal(n)
    X, y = jnp.asarray(X), jnp.asarray(y)
    lam = 0.1
    for proc in ("screening", "init_std", "warm_start"):
        o = cd.IterLassoOptions(options_cd=OPTS, init_procedure=proc)
        s1 = cd.feasible_lasso(X, y, lam, options=o)
        s8 = feasible_lasso_sharded(X, y, lam, feature_mesh, options=o)
        np.testing.assert_allclose(np.asarray(s8.x), np.asarray(s1.x),
                                   atol=1e-5, err_msg=proc)
        np.testing.assert_allclose(np.asarray(s8.penalty.weights),
                                   np.asarray(s1.penalty.weights),
                                   atol=1e-6, err_msg=proc)


def test_sharded_feasible_small_loadings_with_padding(feature_mesh):
    """Regression (round-3 review, reproduced): when every true loading
    is < 1 AND the column count pads (p=96 → P_tot=128 at block 16 over 8
    shards), the padded 1.0 loadings must NOT enter the stop criterion's
    denominator — they stopped the loop ~5× early (1.5e-3 divergence)."""
    from coordinatedescent_jl_tpu.parallel import feasible_lasso_sharded

    rng = np.random.default_rng(73)
    n, p, s = 150, 96, 6
    X = rng.standard_normal((n, p))
    het = 0.02 + 0.1 * np.abs(X[:, 0])  # tiny noise → loadings ≪ 1
    beta = np.zeros(p)
    beta[:s] = rng.standard_normal(s)
    y = X @ beta + het * rng.standard_normal(n)
    X, y = jnp.asarray(X), jnp.asarray(y)
    o = cd.IterLassoOptions(options_cd=OPTS)
    s1 = cd.feasible_lasso(X, y, 0.05, options=o)
    assert float(jnp.max(jnp.asarray(s1.penalty.weights))) < 1.0
    s8 = feasible_lasso_sharded(X, y, 0.05, feature_mesh, options=o)
    np.testing.assert_allclose(np.asarray(s8.x), np.asarray(s1.x),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(s8.penalty.weights),
                               np.asarray(s1.penalty.weights), atol=1e-7)


def test_lvocv_locpolyl1_batch_matches_serial(batch_mesh):
    """Bandwidth-sharded penalized LOO-CV ≡ the serial lvocv_locpolyl1."""
    from coordinatedescent_jl_tpu.parallel import lvocv_locpolyl1_batch

    rng = np.random.default_rng(71)
    n, p = 60, 4
    z = np.sort(rng.uniform(0, 1, n))
    X = rng.standard_normal((n, p))
    y = np.sin(2 * np.pi * z) * X[:, 0] + 0.3 * rng.standard_normal(n)
    hs = np.asarray([0.08, 0.12, 0.2])  # 3 % 8 != 0: padding path
    opts = cd.CDOptions(block_size=8, opt_tol=1e-9, randomize=False)
    m1 = cd.lvocv_locpolyl1(X, z, y, 1, hs, cd.GaussianKernel, 0.05,
                            options=opts)
    m8 = lvocv_locpolyl1_batch(X, z, y, 1, hs, cd.GaussianKernel, 0.05,
                               batch_mesh, options=opts)
    np.testing.assert_allclose(np.asarray(m8), np.asarray(m1), rtol=1e-7)
    # held-out-lane batching composed with the bandwidth sharding
    import warnings

    st = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        m8b = lvocv_locpolyl1_batch(X, z, y, 1, hs, cd.GaussianKernel,
                                    0.05, batch_mesh, options=opts,
                                    cv_batch=16, stats=st)
    # f64: strict certification only — the stall escape never fires
    assert st == {"batched_certified": True, "stall_escaped_lanes": 0,
                  "lanes_resolved_sequentially": 0}
    np.testing.assert_allclose(np.asarray(m8b), np.asarray(m1),
                               rtol=1e-8)


def test_lasso_sharded_with_trace(feature_mesh):
    """Sharded per-epoch trace (§5.5 at the multi-chip tier): the traced
    solve must match lasso_sharded and its recorded certificate must hit
    the duality-gap convergence the single-device trace certifies."""
    X, y = _gen(110, 96, 8, seed=61)
    lam = 0.12
    beta, tr = cd.lasso_sharded_with_trace(X, y, lam, feature_mesh,
                                           options=OPTS)
    ref = lasso_sharded(X, y, lam, feature_mesh, options=OPTS)
    np.testing.assert_allclose(np.asarray(beta), np.asarray(ref.x),
                               atol=1e-6)
    assert tr.max_h[-1] < OPTS.opt_tol
    assert tr.duality_gap[-1] < 1e-7
    assert tr.max_h.shape == tr.nnz.shape == tr.duality_gap.shape
    assert np.all(np.diff(tr.seconds) >= 0)
    # with compaction FORCED the trace must run the engine's actual
    # compact working-set rounds (round-3 review: nc was hard-coded 0)
    # and still converge to the same certified solution
    oc = OPTS.replace(compact=True, compact_size=32)
    beta_c, tr_c = cd.lasso_sharded_with_trace(X, y, lam, feature_mesh,
                                               options=oc)
    np.testing.assert_allclose(np.asarray(beta_c), np.asarray(ref.x),
                               atol=1e-6)
    # maxH < opt_tol is the reference convergence contract; the gap bar
    # is looser than opt_tol because a tiny compact_size (32 of 96
    # columns here) leaves non-covered coordinates at their near-tol KKT
    # values — each below opt_tol (certified by the sweep), but their
    # summed dual-scaling effect lands the measured gap a small factor
    # above it (the union round's endpoint; the Jacobi path polished
    # every coordinate each pass and happened to land tighter)
    assert tr_c.max_h[-1] < oc.opt_tol and tr_c.duality_gap[-1] < 1e-6


def test_sharded_symmetric_matches_single_device(feature_mesh):
    """SymmetricSparseIterate, feature-sharded: the packed lower-triangle
    vector is ordinary column sharding of the packed design, so the
    sharded symmetric driver must reproduce the single-device one."""
    from coordinatedescent_jl_tpu.parallel import (
        symmetric_coordinate_descent_sharded,
    )

    p = 12
    q = cd.sym_num_coordinates(p)  # 78: uneven across 8 shards
    rng = np.random.default_rng(59)
    X = jnp.asarray(rng.standard_normal((90, q)))
    v = np.zeros(q)
    v[rng.choice(q, 7, replace=False)] = rng.standard_normal(7)
    y = jnp.asarray(np.asarray(X) @ v + 0.2 * rng.standard_normal(90))
    loss = cd.LeastSquaresLoss(y, X)
    pen = cd.ProxL1(0.1)
    M1, r1 = cd.symmetric_coordinate_descent(jnp.zeros((p, p)), loss, pen,
                                             OPTS)
    M8, r8 = symmetric_coordinate_descent_sharded(
        jnp.zeros((p, p)), loss, pen, feature_mesh, OPTS)
    np.testing.assert_allclose(np.asarray(M8), np.asarray(M1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(r8), np.asarray(r1), atol=1e-5)
    assert np.array_equal(np.asarray(M8), np.asarray(M8).T)


def test_sharded_group_continuation(feature_mesh):
    """warm_start=False λ-continuation with the pmax'd group λmax."""
    from coordinatedescent_jl_tpu.parallel import group_lasso_sharded

    X, y = _gen_group(100, 32, 4, 4, seed=53)
    opts = OPTS.replace(warm_start=False, num_steps=15)
    s1 = cd.group_lasso(X, y, 0.1, 4, options=opts)
    s8 = group_lasso_sharded(X, y, 0.1, 4, feature_mesh, options=opts)
    np.testing.assert_allclose(s8.x, s1.x, atol=1e-5)


def test_lambda_grid_2d_mesh_matches_individual_solves():
    """2-D (batch × feature) composition: λ scenarios
    sharded over 'batch' while each solve feature-shards X's columns with
    psum residual merging over 'feature' — the public twin of the
    composition dryrun_multichip exercises."""
    from coordinatedescent_jl_tpu.parallel import grid_mesh, lasso_grid_sharded

    mesh = grid_mesh(4)  # 4 batch × 2 feature over the 8 CPU devices
    assert mesh.shape == {"batch": 4, "feature": 2}
    X, y = _gen(100, 70, 6, seed=19)  # p=70: uneven feature padding
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.07), 6))  # 6 % 4 != 0
    betas = lasso_grid_sharded(X, y, lams, mesh, options=OPTS,
                               standardize_X=False)
    assert betas.shape == (6, 70)
    for i, lam in enumerate(lams):
        sol = cd.lasso(X, y, lam, options=OPTS)
        np.testing.assert_allclose(betas[i], sol.x, atol=1e-5)
    # explicit penalty weights win over the standardize_X default (same
    # precedence as the single-device API)
    rng = np.random.default_rng(23)
    lamw = jnp.asarray(0.5 + rng.random(70))
    bw = lasso_grid_sharded(X, y, lams[:2], mesh, options=OPTS,
                            weights=lamw)
    g = cd.ProxL1(float(lams[0]), lamw)
    b1, _ = cd.coordinate_descent(jnp.zeros(70),
                                  cd.LeastSquaresLoss(y, X), g, OPTS)
    np.testing.assert_allclose(bw[0], b1, atol=1e-5)


def test_locpoly_batch_matches_serial(batch_mesh):
    rng = np.random.default_rng(23)
    n, p = 80, 3
    X = rng.standard_normal((n, p))
    z = rng.random(n)
    y = np.sum(X * np.sin(2 * z)[:, None], axis=1) + \
        0.1 * rng.standard_normal(n)
    zgrid = np.linspace(0.1, 0.9, 9)
    k = cd.GaussianKernel(0.2)
    serial = cd.locpoly(X, z, y, zgrid, 1, k)
    batched = locpoly_batch(X, z, y, zgrid, 1, k, batch_mesh)
    np.testing.assert_allclose(batched, serial, atol=1e-8)


def test_lvocv_batch_matches_serial(batch_mesh):
    rng = np.random.default_rng(29)
    n, p = 60, 2
    X = rng.standard_normal((n, p))
    z = rng.random(n)
    y = np.sum(X * np.cos(3 * z)[:, None], axis=1) + \
        0.1 * rng.standard_normal(n)
    h_arr = np.array([0.1, 0.2, 0.4])
    serial = cd.lvocv_locpoly(X, z, y, 0, h_arr, cd.GaussianKernel)
    batched = lvocv_locpoly_batch(X, z, y, 0, h_arr, cd.GaussianKernel,
                                  batch_mesh)
    np.testing.assert_allclose(batched, serial, rtol=1e-10)


@pytest.mark.parametrize("kind", ["ls", "sqrt"])
def test_sharded_ista_matches_exact_pass(feature_mesh, kind):
    """The ista inner pass inside the feature-sharded shard_map (with the
    psum residual merge) reaches the single-device exact-pass solution on
    the 8-device CPU mesh."""
    base = OPTS.replace(randomize=False)
    if kind == "ls":
        X, y = _gen(96, 128, 8, seed=21)
        lam = 0.1
        ref = cd.lasso(X, y, lam, options=base.replace(inner="exact"))
        sol = lasso_sharded(X, y, lam, feature_mesh,
                            options=base.replace(inner="ista"))
        assert float(cd.lasso_duality_gap(X, y, sol.x, lam)) < 1e-6
    else:
        X, y = _gen(96, 64, 5, seed=22)
        lam = 1.1 * float(np.sqrt(2 * np.log(64)))
        ref = cd.sqrt_lasso(X, y, lam, standardize_X=False,
                            options=base.replace(inner="exact"))
        sol = sqrt_lasso_sharded(X, y, lam, feature_mesh,
                                 options=base.replace(inner="ista"))
    np.testing.assert_allclose(sol.x, ref.x, atol=1e-5)


def test_sharded_compaction_matches_single_device(feature_mesh):
    """Working-set compaction inside the sharded epoch loop (per-shard
    gathered subproblems, one psum merge per inner solve) must agree with
    the single-device compacting solver and the dense sharded path."""
    rng = np.random.default_rng(51)
    n, p, s = 120, 512, 10
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
    y = X @ beta + 0.2 * rng.standard_normal(n)
    lam = 0.15
    # force compaction (auto is f32-only; tests run f64): B=8, C=32 -> nc=4,
    # local nb = 512/8/8 = 8 blocks per shard >= nc+1
    o_comp = cd.CDOptions(block_size=8, compact=True, compact_size=32,
                          opt_tol=1e-9, randomize=False)
    o_dense = o_comp.replace(compact=False)
    sol_sh = lasso_sharded(X, y, lam, feature_mesh, options=o_comp)
    sol_1d = cd.lasso(X, y, lam, options=o_comp)
    sol_dense = lasso_sharded(X, y, lam, feature_mesh, options=o_dense)
    np.testing.assert_allclose(sol_sh.x, sol_1d.x, atol=1e-6)
    np.testing.assert_allclose(sol_sh.x, sol_dense.x, atol=1e-6)
    # exact-sparsity semantics survive the damped merges + snap
    assert np.array_equal(np.asarray(sol_sh.x) != 0,
                          np.asarray(sol_1d.x) != 0)


def test_sharded_path_extrapolated_compact_matches_single(feature_mesh):
    """λ-path with compaction forced so the sharded secant extrapolation
    (_sharded_extrapolate_start: gathered covered-AND + psum'd residual
    shift) actually runs; every point must match the single-device path."""
    X, y = _gen(150, 128, 8, seed=21)
    lam_max = float(np.abs(np.asarray(X).T @ np.asarray(y) / 150).max())
    lams = lam_max * np.logspace(-0.2, -1.8, 10)
    opts = cd.CDOptions(block_size=8, compact=True, compact_size=64, extrapolate=True,
                        opt_tol=1e-10, randomize=False)
    p1 = cd.lasso_path(X, y, lams, options=opts, standardize_X=False)
    p8 = lasso_path_sharded(X, y, lams, feature_mesh, options=opts,
                            standardize_X=False)
    np.testing.assert_allclose(p8.beta_path, p1.beta_path, atol=1e-8)


def test_sharded_scaled_compact_extrapolated_matches_single(feature_mesh):
    """σ-round secant extrapolation in the sharded scaled lasso with
    compaction forced (the branch is dead under default f64 options):
    must match the single-device solver."""
    X, y = _gen(150, 128, 8, seed=25, sigma=0.5)
    lam = np.sqrt(2 * np.log(128) / 150)
    o = cd.IterLassoOptions(options_cd=cd.CDOptions(
        block_size=8, compact=True, compact_size=64, extrapolate=True, opt_tol=1e-10,
        randomize=False))
    s1 = cd.scaled_lasso(X, y, lam, options=o)
    s8 = scaled_lasso_sharded(X, y, lam, feature_mesh, options=o)
    np.testing.assert_allclose(np.asarray(s8.x), np.asarray(s1.x),
                               atol=1e-8)
    np.testing.assert_allclose(float(s8.sigma), float(s1.sigma),
                               rtol=1e-8)


# ---------------------------------------------------------------------------
# Observation-sharded (row / data-parallel) tier
# ---------------------------------------------------------------------------


def test_row_sharded_lasso_matches_single_device(obs_mesh):
    """Rows partitioned over 8 shards, β replicated: the exact
    Gauss-Seidel pass (psum'd per-block gradients, replicated in-block
    Gram recursion) must reproduce the single-device solution, and the
    sharded solution must satisfy the duality-gap certificate directly."""
    X, y = _gen(160, 64, 8)
    lam = 0.1
    sol1 = cd.lasso(X, y, lam, options=OPTS)
    sol8 = lasso_row_sharded(X, y, lam, obs_mesh, options=OPTS)
    np.testing.assert_allclose(sol8.x, sol1.x, atol=1e-6)
    np.testing.assert_allclose(sol8.residuals, sol1.residuals, atol=1e-6)
    gap = cd.lasso_duality_gap(X, y, sol8.x, lam)
    assert float(gap) < 1e-6


def test_row_sharded_uneven_n(obs_mesh):
    """n = 101 not divisible by 8 exercises the zero-row padding: padded
    rows must not perturb the solution or inflate the n·λ threshold."""
    X, y = _gen(101, 40, 5, seed=3)
    lam = 0.12
    sol1 = cd.lasso(X, y, lam, options=OPTS)
    sol8 = lasso_row_sharded(X, y, lam, obs_mesh, options=OPTS)
    np.testing.assert_allclose(sol8.x, sol1.x, atol=1e-6)
    assert sol8.residuals.shape == (101,)


def test_row_sharded_weighted_ls(obs_mesh):
    """WLS: per-row weights shard with the rows; Grams use Xw'X like the
    single-device engine."""
    X, y = _gen(120, 48, 6, seed=1)
    rng = np.random.default_rng(11)
    w = jnp.asarray(0.5 + rng.random(120))
    g = cd.ProxL1(0.08)
    loss = cd.WeightedLSLoss(y, X, w)
    b1, r1 = cd.coordinate_descent(jnp.zeros(48), loss, g, OPTS)
    b8, r8 = coordinate_descent_row_sharded(jnp.zeros(48), loss, g,
                                            obs_mesh, OPTS)
    np.testing.assert_allclose(b8, b1, atol=1e-6)
    np.testing.assert_allclose(r8, r1, atol=1e-6)


def test_row_sharded_sqrt_lasso(obs_mesh):
    """sqrt-lasso: ‖r‖² is a psum'd scalar maintained by the replicated
    Gram recursion and refreshed exactly at every full check."""
    X, y = _gen(152, 48, 6, seed=7)
    lam = 0.3 / np.sqrt(152)
    s1 = cd.sqrt_lasso(X, y, lam, options=OPTS, standardize_X=False)
    s8 = sqrt_lasso_row_sharded(X, y, lam, obs_mesh, options=OPTS)
    np.testing.assert_allclose(s8.x, s1.x, atol=1e-5)


def test_row_sharded_cold_start_continuation(obs_mesh):
    """warm_start=False: the λmax → λ0 log-continuation (psum'd λmax)
    matches the single-device schedule."""
    X, y = _gen(128, 40, 5, seed=5)
    lam = 0.05
    opts = OPTS.replace(warm_start=False, num_steps=20)
    sol1 = cd.lasso(X, y, lam, options=opts)
    sol8 = lasso_row_sharded(X, y, lam, obs_mesh, options=opts)
    np.testing.assert_allclose(sol8.x, sol1.x, atol=1e-6)


def test_tile_sharded_lasso_matches_single_device():
    """2-D (obs × feature) tiling: each device holds an (n/4 × p/2) tile.
    Row contractions psum over 'obs'; column blocks merge block-Jacobi
    (safeguarded) over 'feature'.  Must converge to the single-device
    solution and satisfy the duality-gap certificate."""
    from coordinatedescent_jl_tpu.parallel import lasso_tile_sharded

    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, ("obs", "feature"))
    X, y = _gen(160, 96, 8)
    lam = 0.1
    sol1 = cd.lasso(X, y, lam, options=OPTS)
    solt = lasso_tile_sharded(X, y, lam, mesh, options=OPTS)
    np.testing.assert_allclose(solt.x, sol1.x, atol=1e-5)
    np.testing.assert_allclose(solt.residuals, sol1.residuals, atol=1e-5)
    gap = cd.lasso_duality_gap(X, y, solt.x, lam)
    assert float(gap) < 1e-6


def test_tile_sharded_uneven_both_dims():
    """n=101 and p=37 both need padding on a 2×4 (obs × feature) mesh."""
    from coordinatedescent_jl_tpu.parallel import lasso_tile_sharded

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("obs", "feature"))
    X, y = _gen(101, 37, 5, seed=3)
    lam = 0.12
    sol1 = cd.lasso(X, y, lam, options=OPTS)
    solt = lasso_tile_sharded(X, y, lam, mesh, options=OPTS)
    np.testing.assert_allclose(solt.x, sol1.x, atol=1e-5)
    assert solt.residuals.shape == (101,)


def test_tile_sharded_sqrt_and_wls():
    """sqrt (psum'd ‖r‖²) and wls (row-sharded weights) on the tiled
    mesh via the generic driver."""
    from coordinatedescent_jl_tpu.parallel import (
        coordinate_descent_row_sharded,
    )

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("obs", "feature"))
    X, y = _gen(120, 48, 6, seed=7)
    lam = 0.3 / np.sqrt(120)
    s1 = cd.sqrt_lasso(X, y, lam, options=OPTS, standardize_X=False)
    b8, _ = coordinate_descent_row_sharded(
        jnp.zeros(48), cd.SqrtLassoLoss(y, X), cd.ProxL1(lam), mesh,
        OPTS, feat_axis="feature")
    np.testing.assert_allclose(b8, s1.x, atol=1e-4)

    rng = np.random.default_rng(11)
    w = jnp.asarray(0.5 + rng.random(120))
    loss = cd.WeightedLSLoss(y, X, w)
    g = cd.ProxL1(0.08)
    b1, _ = cd.coordinate_descent(jnp.zeros(48), loss, g, OPTS)
    bw, _ = coordinate_descent_row_sharded(jnp.zeros(48), loss, g, mesh,
                                           OPTS, feat_axis="feature")
    np.testing.assert_allclose(bw, b1, atol=1e-5)


def test_tile_sharded_axis_validation(obs_mesh):
    from coordinatedescent_jl_tpu.parallel import (
        coordinate_descent_row_sharded,
    )

    X, y = _gen(60, 32, 4)
    loss = cd.LeastSquaresLoss(y, X)
    with pytest.raises(ValueError, match="must differ"):
        coordinate_descent_row_sharded(jnp.zeros(32), loss,
                                       cd.ProxL1(0.1), obs_mesh, OPTS,
                                       feat_axis="obs")
    with pytest.raises(ValueError, match="not in mesh"):
        coordinate_descent_row_sharded(jnp.zeros(32), loss,
                                       cd.ProxL1(0.1), obs_mesh, OPTS,
                                       feat_axis="nope")


def test_row_sharded_penalty_weights_and_proxzero(obs_mesh):
    """Per-coordinate penalty weights ride the replicated lamw; ProxZero
    takes the forced-warm-start branch (λ0=0, no continuation)."""
    X, y = _gen(120, 48, 6, seed=19)
    rng = np.random.default_rng(21)
    lamw = np.asarray(0.5 + rng.random(48))
    s1 = cd.lasso(X, y, 0.08, weights=lamw, options=OPTS)
    s8 = lasso_row_sharded(X, y, 0.08, obs_mesh, weights=lamw,
                           options=OPTS)
    np.testing.assert_allclose(s8.x, s1.x, atol=1e-6)

    # ProxZero: unpenalized least squares on a well-posed (n > p) design
    loss = cd.LeastSquaresLoss(y, X)
    b1, _ = cd.coordinate_descent(jnp.zeros(48), loss, cd.ProxZero(),
                                  OPTS)
    b8, _ = coordinate_descent_row_sharded(jnp.zeros(48), loss,
                                           cd.ProxZero(), obs_mesh, OPTS)
    np.testing.assert_allclose(b8, b1, atol=1e-5)


def test_tile_sharded_cold_start_randomize():
    """warm_start=False continuation and randomize=True on the tiled
    mesh: different trajectories, same certified fixed point."""
    from coordinatedescent_jl_tpu.parallel import lasso_tile_sharded

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("obs", "feature"))
    X, y = _gen(120, 48, 6, seed=5)
    opts = OPTS.replace(warm_start=False, num_steps=20)
    sol1 = cd.lasso(X, y, 0.05, options=opts)
    solt = lasso_tile_sharded(X, y, 0.05, mesh, options=opts)
    np.testing.assert_allclose(solt.x, sol1.x, atol=1e-5)

    opts_r = OPTS.replace(randomize=True)
    sol1r = cd.lasso(X, y, 0.1, options=OPTS)
    soltr = lasso_tile_sharded(X, y, 0.1, mesh, options=opts_r)
    np.testing.assert_allclose(soltr.x, sol1r.x, atol=1e-5)


def test_row_sharded_length_mismatch_raises(obs_mesh):
    X, y = _gen(60, 32, 4)
    loss = cd.WeightedLSLoss(y, X, jnp.ones(59))
    with pytest.raises(ValueError, match="weights have"):
        coordinate_descent_row_sharded(jnp.zeros(32), loss,
                                       cd.ProxL1(0.1), obs_mesh, OPTS)
    with pytest.raises(ValueError, match="beta0 has"):
        coordinate_descent_row_sharded(jnp.zeros(31),
                                       cd.LeastSquaresLoss(y, X),
                                       cd.ProxL1(0.1), obs_mesh, OPTS)


def test_row_sharded_lasso_path(obs_mesh):
    """Warm-started path on the row-sharded layout ≡ single-device path,
    including max_hat_s truncation."""
    from coordinatedescent_jl_tpu.parallel import lasso_path_row_sharded

    X, y = _gen(120, 48, 6, seed=13)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 8))
    p1 = cd.lasso_path(X, y, lams, options=OPTS, standardize_X=False)
    p8 = lasso_path_row_sharded(X, y, lams, obs_mesh, options=OPTS,
                                standardize_X=False)
    assert p8.beta_path.shape == p1.beta_path.shape
    np.testing.assert_allclose(p8.beta_path, p1.beta_path, atol=1e-6)

    lams2 = np.exp(np.linspace(np.log(0.5), np.log(0.01), 10))
    p1s = cd.lasso_path(X, y, lams2, options=OPTS, max_hat_s=10,
                        standardize_X=False)
    p8s = lasso_path_row_sharded(X, y, lams2, obs_mesh, options=OPTS,
                                 max_hat_s=10, standardize_X=False)
    assert p8s.lam_path.shape == p1s.lam_path.shape
    np.testing.assert_allclose(p8s.beta_path, p1s.beta_path, atol=1e-6)


def test_tile_sharded_lasso_path():
    """The same path driver on a 2-D (obs × feature) tiled mesh."""
    from coordinatedescent_jl_tpu.parallel import lasso_path_row_sharded

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("obs", "feature"))
    X, y = _gen(120, 48, 6, seed=13)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 8))
    p1 = cd.lasso_path(X, y, lams, options=OPTS, standardize_X=False)
    pt = lasso_path_row_sharded(X, y, lams, mesh, options=OPTS,
                                standardize_X=False,
                                feat_axis="feature")
    assert pt.beta_path.shape == p1.beta_path.shape
    np.testing.assert_allclose(pt.beta_path, p1.beta_path, atol=1e-5)


def test_lvocv_batch_fallback_recompute(batch_mesh):
    """compact_rounds=0 gives the batched LOO zero refine rounds, so no
    bandwidth certifies — the wrapper must warn and recompute every
    bandwidth sequentially (this path once crashed on a read-only
    np.asarray view of the jax MSE array)."""
    import warnings

    from coordinatedescent_jl_tpu.parallel import lvocv_locpolyl1_batch

    rng = np.random.default_rng(71)
    n, p = 60, 4
    z = np.sort(rng.uniform(0, 1, n))
    X = rng.standard_normal((n, p))
    y = np.sin(2 * np.pi * z) * X[:, 0] + 0.3 * rng.standard_normal(n)
    hs = np.asarray([0.1, 0.2])
    opts = cd.CDOptions(block_size=8, opt_tol=1e-9, randomize=False)
    m1 = cd.lvocv_locpolyl1(X, z, y, 1, hs, cd.GaussianKernel, 0.05,
                            options=opts)
    o0 = opts.replace(compact_rounds=0)
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        m2 = lvocv_locpolyl1_batch(X, z, y, 1, hs, cd.GaussianKernel,
                                   0.05, batch_mesh, options=o0,
                                   cv_batch=16)
        assert any("recomputing" in str(w.message) for w in ws)
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1), rtol=1e-6)


def test_sharded_path_scan_chunked_bitwise(feature_mesh):
    """Host-chunked sharded scan ≡ the monolithic sharded scan bitwise:
    the full carry (sharded CDState + per-shard WsCache + secant
    abscissae + stop flag) round-trips between segment programs as
    sharded global arrays.  Covers compaction (the wrapped cache leaves),
    mid-grid chunk splits, and the max_hat_s host-side early exit."""
    X, y = _gen(100, 48, 6, seed=13)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 9))
    for opts in (OPTS,
                 OPTS.replace(compact=True, compact_size=16,
                              randomize=True)):
        ref = lasso_path_sharded(X, y, lams, feature_mesh, options=opts,
                                 standardize_X=False, path_batch=0)
        for ch in (2, 4, 9):
            chunked = lasso_path_sharded(
                X, y, lams, feature_mesh, options=opts,
                standardize_X=False, path_batch=0, scan_chunk=ch)
            assert chunked.beta_path.shape == ref.beta_path.shape
            assert bool(jnp.all(chunked.beta_path == ref.beta_path)), \
                f"chunk={ch} diverged from the monolithic sharded scan"
    # max_hat_s truncation identical under chunking
    lams2 = np.exp(np.linspace(np.log(0.5), np.log(0.01), 10))
    ref = lasso_path_sharded(X, y, lams2, feature_mesh, options=OPTS,
                             max_hat_s=10, standardize_X=False,
                             path_batch=0)
    chunked = lasso_path_sharded(X, y, lams2, feature_mesh, options=OPTS,
                                 max_hat_s=10, standardize_X=False,
                                 path_batch=0, scan_chunk=3)
    assert chunked.beta_path.shape == ref.beta_path.shape
    assert bool(jnp.all(chunked.beta_path == ref.beta_path))


def test_row_sharded_path_scan_chunked_bitwise():
    """Host-chunked row/tile-sharded path ≡ the monolithic program
    bitwise, on the obs mesh and the 2-D tiled mesh (carry leaves ride
    P(feat)/P(obs) specs), incl. the max_hat_s host-side early exit."""
    from coordinatedescent_jl_tpu.parallel import lasso_path_row_sharded

    X, y = _gen(96, 40, 6, seed=29)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.03), 9))
    devs = np.array(jax.devices())
    obs_mesh = jax.sharding.Mesh(devs[:4], ("obs",))
    tile_mesh = jax.sharding.Mesh(devs[:8].reshape(2, 4),
                                  ("obs", "feature"))
    for mesh, fa in ((obs_mesh, None), (tile_mesh, "feature")):
        ref = lasso_path_row_sharded(X, y, lams, mesh, options=OPTS,
                                     standardize_X=False, feat_axis=fa)
        for ch in (3, 9):
            chunked = lasso_path_row_sharded(
                X, y, lams, mesh, options=OPTS, standardize_X=False,
                feat_axis=fa, scan_chunk=ch)
            assert chunked.beta_path.shape == ref.beta_path.shape
            assert bool(jnp.all(chunked.beta_path == ref.beta_path)), \
                f"mesh={mesh.shape} chunk={ch} diverged"
        stop = lasso_path_row_sharded(X, y, lams, mesh, options=OPTS,
                                      standardize_X=False, feat_axis=fa,
                                      max_hat_s=8)
        stop_ch = lasso_path_row_sharded(X, y, lams, mesh, options=OPTS,
                                         standardize_X=False,
                                         feat_axis=fa, max_hat_s=8,
                                         scan_chunk=2)
        assert stop_ch.beta_path.shape == stop.beta_path.shape
        assert bool(jnp.all(stop_ch.beta_path == stop.beta_path))


def test_sharded_p1m_feature_axis(feature_mesh):
    # the north-star feature-count axis (BASELINE.json config 5): p = 1M
    # columns across the mesh — exercises block-index arithmetic, the
    # distributed top-k working set, and padding at nb = 7813 blocks.
    # f32 keeps the test's memory at ~128 MB  (the dtype is irrelevant to
    # the index paths under test; f32 is also the production dtype).
    p, n, s = 1_000_000, 32, 5
    rng = np.random.default_rng(42)
    X = jnp.asarray(rng.standard_normal((n, p)), jnp.float32)
    beta = np.zeros(p, np.float32)
    idx = rng.choice(p, s, replace=False)
    beta[idx] = rng.standard_normal(s)
    y = jnp.asarray(X @ jnp.asarray(beta)
                    + 0.1 * rng.standard_normal(n).astype(np.float32))
    lammax = float(jnp.max(jnp.abs(y @ X)) / n)
    lam = 0.3 * lammax
    opts = cd.CDOptions(block_size=128)
    sol1 = cd.lasso(X, y, lam, options=opts)
    sol8 = lasso_sharded(X, y, lam, feature_mesh, options=opts)
    np.testing.assert_allclose(sol8.x, sol1.x, atol=5e-4)
    gap = cd.lasso_duality_gap(X, y, sol8.x, lam)
    primal = 0.5 * float(jnp.sum((y - X @ sol8.x) ** 2)) / n
    assert float(gap) / max(primal, 1e-30) < 1e-3


def test_sharded_union_pass_epoch_parity(feature_mesh):
    """The replicated union working-set round must keep the sharded
    epoch count at the single-device engine's level — the block-Jacobi
    coupling rate alone inflated 5 single-device epochs to 21 at 2
    shards.  f32 on the 8-device mesh; epoch counts
    come from the per-epoch traces."""
    rng = np.random.default_rng(17)
    n, p, s = 2000, 4096, 30
    X = jnp.asarray(rng.standard_normal((n, p)), jnp.float32)
    beta = np.zeros(p, np.float32)
    beta[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
    y = jnp.asarray(X @ jnp.asarray(beta)
                    + 0.3 * rng.standard_normal(n).astype(np.float32))
    lam = 0.1 * float(jnp.max(jnp.abs(y @ X)) / n)
    opts = cd.CDOptions(block_size=128)
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("feature",))
    b1, tr1 = cd.lasso_sharded_with_trace(X, y, lam, mesh1, options=opts)
    b8, tr8 = cd.lasso_sharded_with_trace(X, y, lam, feature_mesh,
                                          options=opts)
    np.testing.assert_allclose(b8, b1, atol=5e-4)
    # parity within the alternation's granularity (one extra
    # full-check/active pair of slack)
    assert len(tr8.max_h) <= len(tr1.max_h) + 2, (
        len(tr8.max_h), len(tr1.max_h))
