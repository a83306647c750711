"""Checkpoint/resume + convergence-trace + NaN-mode tests (SURVEY.md §5)."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

import coordinatedescent_jl_tpu as cd


def _gen(n, p, s, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[:s] = rng.standard_normal(s)
    y = X @ beta + 0.3 * rng.standard_normal(n)
    return jnp.asarray(X), jnp.asarray(y)


OPTS = cd.CDOptions(block_size=16)


def test_resumable_path_matches_plain_path(tmp_path):
    X, y = _gen(100, 48, 6)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 6))
    f = str(tmp_path / "ck.npz")
    p1 = cd.lasso_path(X, y, lams, options=OPTS, standardize_X=False)
    p2 = cd.lasso_path_resumable(X, y, lams, f, options=OPTS,
                                 standardize_X=False)
    np.testing.assert_allclose(p2.beta_path, p1.beta_path, atol=1e-7)


def test_resume_mid_path(tmp_path):
    X, y = _gen(100, 48, 6, seed=1)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 6))
    f = str(tmp_path / "ck.npz")
    # simulate an interrupted run: solve only the first 3 points
    cd.lasso_path_resumable(X, y, lams[:3], f, options=OPTS,
                            standardize_X=False)
    ck = cd.load_checkpoint(f)
    assert ck.next_index == 3
    # overwrite with a checkpoint claiming the full grid, 3 points solved
    cd.save_checkpoint(f, ck._replace(lam_path=np.asarray(lams)))
    p2 = cd.lasso_path_resumable(X, y, lams, f, options=OPTS,
                                 standardize_X=False)
    p1 = cd.lasso_path(X, y, lams, options=OPTS, standardize_X=False)
    np.testing.assert_allclose(p2.beta_path, p1.beta_path, atol=1e-7)
    ck2 = cd.load_checkpoint(f)
    assert ck2.next_index == 6


def test_resume_trajectory_identical_randomized(tmp_path):
    """The checkpoint persists the FULL solver state (PRNG key, cached
    gradient + drift, active mask), so an interrupted+resumed run follows
    the exact same randomized trajectory as an uninterrupted one —
    bitwise, not just to solver tolerance."""
    X, y = _gen(100, 48, 6, seed=7)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 6))
    opts = cd.CDOptions(block_size=16, randomize=True)
    f1 = str(tmp_path / "full.npz")
    f2 = str(tmp_path / "interrupted.npz")
    p_full = cd.lasso_path_resumable(X, y, lams, f1, options=opts,
                                     standardize_X=False, seed=3)
    # interrupted run: first 3 points, then resume over the full grid
    cd.lasso_path_resumable(X, y, lams[:3], f2, options=opts,
                            standardize_X=False, seed=3)
    ck = cd.load_checkpoint(f2)
    assert ck.next_index == 3
    cd.save_checkpoint(f2, ck._replace(lam_path=np.asarray(lams)))
    p_res = cd.lasso_path_resumable(X, y, lams, f2, options=opts,
                                    standardize_X=False, seed=3)
    assert np.array_equal(np.asarray(p_res.beta_path),
                          np.asarray(p_full.beta_path))
    # and the final checkpoints agree bitwise too (key, c, drift, active)
    c1, c2 = cd.load_checkpoint(f1), cd.load_checkpoint(f2)
    for fld in ("beta_warm", "residuals", "key", "c", "drift", "active"):
        assert np.array_equal(getattr(c1, fld), getattr(c2, fld)), fld


def test_checkpoint_ignored_for_different_grid(tmp_path):
    X, y = _gen(80, 32, 4, seed=2)
    f = str(tmp_path / "ck.npz")
    cd.lasso_path_resumable(X, y, [0.5, 0.2], f, options=OPTS,
                            standardize_X=False)
    # a different λ grid must restart from scratch, not resume
    p = cd.lasso_path_resumable(X, y, [0.4, 0.1], f, options=OPTS,
                                standardize_X=False)
    assert p.beta_path.shape[0] == 2
    sol = cd.lasso(X, y, 0.1, options=OPTS)
    np.testing.assert_allclose(p.beta_path[-1], sol.x, atol=1e-6)


def test_solve_with_trace_converges_and_logs():
    X, y = _gen(120, 64, 8, seed=3)
    beta, tr = cd.solve_with_trace(X, y, 0.1, options=OPTS)
    sol = cd.lasso(X, y, 0.1, options=OPTS)
    np.testing.assert_allclose(beta, sol.x, atol=1e-6)
    assert tr.max_h.shape == tr.duality_gap.shape == tr.nnz.shape
    assert tr.max_h[-1] < OPTS.opt_tol
    assert tr.duality_gap[-1] < 1e-6
    # gap history is (weakly) decreasing towards the end
    assert tr.duality_gap[-1] <= tr.duality_gap[0]


def test_solve_with_trace_sqrt():
    """Per-epoch trace for the sqrt-lasso: must match
    the production sqrt_lasso solve and certify the scale-free KKT
    conditions max(|X_j'r|/‖r‖ − λ, 0) → 0."""
    X, y = _gen(150, 64, 6, seed=5)
    lam = 1.1 * np.sqrt(2 * np.log(64))
    beta, tr = cd.solve_with_trace(X, y, lam, options=OPTS, loss="sqrt")
    sol = cd.sqrt_lasso(X, y, lam, standardize_X=False, options=OPTS)
    np.testing.assert_allclose(beta, sol.x, atol=1e-6)
    assert tr.max_h[-1] < OPTS.opt_tol
    # the KKT residual is the step criterion times curvature (~n·maxh/‖r‖
    # per coordinate): a hair above opt_tol is expected at the fixed point
    assert tr.certificate[-1] < 5e-7
    assert np.all(np.isfinite(tr.certificate))


def test_solve_with_trace_wls():
    """Weighted-LS trace: certificate is the √w-transformed LS duality
    gap; the solve must match coordinate_descent with WeightedLSLoss."""
    X, y = _gen(120, 48, 5, seed=6)
    rng = np.random.default_rng(7)
    w = jnp.asarray(0.3 + rng.random(120))
    beta, tr = cd.solve_with_trace(X, y, 0.1, options=OPTS, loss="wls",
                                   w=w)
    b2, _ = cd.coordinate_descent(
        jnp.zeros(48), cd.WeightedLSLoss(y, X, w), cd.ProxL1(0.1), OPTS)
    np.testing.assert_allclose(beta, b2, atol=1e-6)
    assert tr.certificate[-1] < 1e-6


def test_scaled_lasso_with_trace():
    """Per-σ-round trace: matches scaled_lasso, the
    recorded rel_change hits the stop tolerance, λ_eff = λ·σ per round."""
    X, y = _gen(200, 80, 6, seed=8)
    lam = float(np.sqrt(2 * np.log(80) / 200))
    opts = cd.IterLassoOptions(options_cd=OPTS)
    sol, tr = cd.scaled_lasso_with_trace(X, y, lam, options=opts)
    ref = cd.scaled_lasso(X, y, lam, options=opts)
    np.testing.assert_allclose(np.asarray(sol.x), np.asarray(ref.x),
                               atol=1e-7)
    np.testing.assert_allclose(float(sol.sigma), float(ref.sigma),
                               rtol=1e-7)
    assert tr.rel_change[-1] < opts.opt_tol
    np.testing.assert_allclose(tr.lam_eff, lam * tr.sigma, rtol=1e-6)
    assert tr.sigma.shape == tr.nnz.shape == tr.seconds.shape


def test_group_solve_with_trace():
    """Per-epoch group trace: matches group_lasso, group-KKT certificate
    reaches zero."""
    rng = np.random.default_rng(11)
    X = jnp.asarray(rng.standard_normal((120, 32)))
    b = np.zeros(32)
    b[:8] = rng.standard_normal(8)
    y = jnp.asarray(X @ b + 0.3 * rng.standard_normal(120))
    beta, tr = cd.group_solve_with_trace(X, y, 0.1, 4, options=OPTS)
    sol = cd.group_lasso(X, y, 0.1, 4, options=OPTS)
    np.testing.assert_allclose(beta, np.asarray(sol.x), atol=1e-7)
    assert tr.max_h[-1] < OPTS.opt_tol
    assert tr.certificate[-1] < 1e-8


def test_debug_nans_context():
    import jax

    with cd.debug_nans(True):
        assert jax.config.jax_debug_nans
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.asarray(-1.0)) / jnp.asarray(0.0)
    assert not jax.config.jax_debug_nans


def test_simple_timeit_returns_positive():
    f = lambda: jnp.sum(jnp.ones((64, 64)))
    assert cd.simple_timeit(f, tries=2, warmup=1) > 0


def test_checkpoint_old_format_ignored(tmp_path):
    """A checkpoint file missing newer fields (older release / foreign
    file) must take the ignore-and-restart path, not crash the resume."""
    import coordinatedescent_jl_tpu as cd

    f = str(tmp_path / "old.npz")
    np.savez(f, lam_path=np.array([0.2, 0.1]), next_index=1,
             beta_path=np.zeros((1, 4)), beta_warm=np.zeros(4),
             residuals=np.zeros(8), sigma=1.0)
    assert cd.load_checkpoint(f) is None
    rng = np.random.default_rng(0)
    X = rng.standard_normal((40, 12))
    y = X[:, 0] + 0.1 * rng.standard_normal(40)
    path = cd.lasso_path_resumable(X, y, np.array([0.2, 0.1]), f,
                                   options=cd.CDOptions(block_size=8))
    assert path.beta_path.shape == (2, 12)


def test_checkpoint_resume_trajectory_with_compaction(tmp_path):
    """Resume mid-path with working-set compaction FORCED (f64): the
    persisted ws_idx reconstructs the cache exactly, so the resumed
    trajectory is bitwise-equal to the uninterrupted run's."""
    import coordinatedescent_jl_tpu as cd

    rng = np.random.default_rng(5)
    n, p = 100, 256
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[rng.choice(p, 6, replace=False)] = rng.standard_normal(6)
    y = X @ beta + 0.2 * rng.standard_normal(n)
    lams = np.exp(np.linspace(np.log(0.4), np.log(0.05), 6))
    opts = cd.CDOptions(block_size=8, compact=True, compact_size=64, extrapolate=True,
                        randomize=True, opt_tol=1e-9)

    f_full = str(tmp_path / "full.npz")
    full = cd.lasso_path_resumable(X, y, lams, f_full, options=opts)

    f_int = str(tmp_path / "inter.npz")
    # run the first 3 points, then "crash" and resume
    cd.lasso_path_resumable(X, y, lams[:3], f_int, options=opts)
    import numpy as _np
    with _np.load(f_int) as z:
        d = {k: z[k] for k in z.files}
    d["lam_path"] = np.asarray(lams, X.dtype)   # pretend the grid was full
    _np.savez(f_int, **d)
    resumed = cd.lasso_path_resumable(X, y, lams, f_int, options=opts)
    np.testing.assert_array_equal(np.asarray(resumed.beta_path),
                                  np.asarray(full.beta_path))


def test_resume_trajectory_identical_compaction(tmp_path):
    """Same bitwise-resume guarantee with compaction (and therefore the
    secant warm-start extrapolation) engaged: the resumable driver must
    mirror the scan path's extrapolated trajectory, and the checkpoint's
    beta_prev/lam_k/lam_km1 must restore the secant state exactly."""
    X, y = _gen(120, 256, 8, seed=11)
    lam_max = float(np.abs(np.asarray(X).T @ np.asarray(y) / 120).max())
    lams = lam_max * np.logspace(-0.3, -1.7, 8)
    opts = cd.CDOptions(block_size=8, compact=True, compact_size=64, extrapolate=True,
                        randomize=True)
    f1 = str(tmp_path / "full.npz")
    f2 = str(tmp_path / "interrupted.npz")
    p_full = cd.lasso_path_resumable(X, y, lams, f1, options=opts,
                                     standardize_X=False, seed=3)
    cd.lasso_path_resumable(X, y, lams[:4], f2, options=opts,
                            standardize_X=False, seed=3)
    ck = cd.load_checkpoint(f2)
    cd.save_checkpoint(f2, ck._replace(lam_path=np.asarray(lams)))
    p_res = cd.lasso_path_resumable(X, y, lams, f2, options=opts,
                                    standardize_X=False, seed=3)
    assert np.array_equal(np.asarray(p_res.beta_path),
                          np.asarray(p_full.beta_path))
    c1, c2 = cd.load_checkpoint(f1), cd.load_checkpoint(f2)
    for fld in ("beta_warm", "residuals", "key", "c", "drift", "active",
                "ws_idx", "beta_prev", "lam_k", "lam_km1"):
        assert np.array_equal(getattr(c1, fld), getattr(c2, fld)), fld
    # and the scan driver follows the same trajectory endpoint
    p_scan = cd.lasso_path(X, y, lams, options=opts, standardize_X=False,
                           seed=3)
    np.testing.assert_allclose(np.asarray(p_scan.beta_path),
                               np.asarray(p_full.beta_path), atol=1e-9)


def test_solve_x_traffic_accounting():
    # the in-trace X-read counter must not perturb the trajectory, and the
    # accounting must show real savings vs a cache-less engine at a
    # compaction-friendly shape
    X, y = _gen(200, 512, 10, seed=3)
    lam = 0.1 * float(np.max(np.abs(np.asarray(X).T @ np.asarray(y))
                             ) / X.shape[0])
    opts = cd.CDOptions(block_size=16)
    rep = cd.solve_x_traffic(X, y, lam, options=opts)
    sol = cd.lasso(X, y, lam, options=opts)
    assert rep.nnz == int(jnp.sum(sol.x != 0))
    assert rep.x_bytes > 0
    assert rep.epochs > 0
    # at least the first full check streams the design once
    itemsize = np.dtype(np.asarray(X).dtype).itemsize
    nb = -(-X.shape[1] // opts.block_size)
    assert rep.x_bytes >= nb * opts.block_size * X.shape[0] * itemsize


def test_measured_peak_hbm_sane():
    # tiny buffer just to exercise the chained-slope path end-to-end
    bw = cd.utils.profiling.measured_peak_hbm(nbytes=1 << 22, chain=4)
    assert np.isfinite(bw) and bw > 0


def test_pass_roofline_multi_shares_build(monkeypatch):
    # tiny shapes on CPU: the multi variant must return one report per
    # iters configuration off a single build, with consistent byte
    # accounting and a sane peak denominator.  The real peak measurement
    # streams a 2 GiB buffer — pointless on CPU, so it is stubbed (its
    # own path is exercised by test_measured_peak_hbm_sane), and the CPU
    # gets a stand-in published peak (the table holds only real devices)
    from coordinatedescent_jl_tpu.utils import profiling as prof
    monkeypatch.setattr(prof, "measured_peak_hbm",
                        lambda *a, **k: 1e11)
    monkeypatch.setitem(prof._PEAK_HBM, jax.devices()[0].device_kind, 1e11)
    reps = cd.pass_roofline_multi(128, 256, block_size=16,
                                  iters_list=(4, 1))
    assert len(reps) == 2
    assert reps[0].bytes_per_pass == reps[1].bytes_per_pass > 0
    assert reps[0].measured_peak_gbps == reps[1].measured_peak_gbps > 0
    for r in reps:
        assert np.isfinite(r.achieved_gbps) and r.achieved_gbps > 0
    # single-config wrapper agrees structurally
    r1 = cd.pass_roofline(128, 256, block_size=16, iters=2)
    assert r1.bytes_per_pass == reps[0].bytes_per_pass


def test_peak_hbm_table():
    """Published peaks are looked up by ``device_kind``; an unknown device
    is an error, never a default."""
    from coordinatedescent_jl_tpu.utils import profiling as prof
    assert prof.peak_hbm("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(ValueError, match="no published peak"):
        prof.peak_hbm("cpu")
