"""Diagnostics precision tests.

The KKT bounds the reference's tests enforce (test/lasso.jl:54, 97-98, 123)
are only meaningful if the certificate itself is computed accurately: an
accelerator's default f32 matmul precision may round to TF32 or bf16 (~1e-3
relative error) —
exactly the failure mode these checks exist to rule out.  Two layers of
testing:

1. value-level: the f32 gap/KKT agree with an exact float64 NumPy
   recomputation on small shapes;
2. static: every ``dot_general`` in the lowered jaxprs of the public
   diagnostics (and ``losses.gradient`` / ``losses.value``) carries
   ``Precision.HIGHEST``, so the f32 device path cannot silently lose
   precision.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

import coordinatedescent_jl_tpu as cd


def _gen(n=60, p=40, s=5, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(dtype)
    beta = np.zeros(p, dtype)
    beta[:s] = rng.standard_normal(s)
    y = (X @ beta + 0.1 * rng.standard_normal(n)).astype(dtype)
    return X, y


def _np_gap(X, y, beta, lam0, weights=None):
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    beta = np.asarray(beta, np.float64)
    n = y.shape[0]
    w = np.ones_like(beta) if weights is None else np.asarray(
        weights, np.float64)
    r = y - X @ beta
    g = X.T @ r
    ratio = np.max(np.abs(g) / (n * lam0 * w))
    theta = r * min(1.0, 1.0 / max(ratio, 1e-300))
    primal = r @ r / (2 * n) + lam0 * np.sum(w * np.abs(beta))
    dual = (y @ y - (y - theta) @ (y - theta)) / (2 * n)
    return primal - dual


def _np_kkt(X, y, beta, lam0, weights=None):
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    beta = np.asarray(beta, np.float64)
    n = y.shape[0]
    w = np.ones_like(beta) if weights is None else np.asarray(
        weights, np.float64)
    g = X.T @ (y - X @ beta) / n
    lam = lam0 * w
    off = np.maximum(np.abs(g) - lam, 0.0)
    on = np.where(beta != 0, np.abs(g - lam * np.sign(beta)), 0.0)
    return max(off.max(), on.max())


def _all_dots_highest(fn, *args):
    """Walk the closed jaxpr (incl. sub-jaxprs): every dot_general must pin
    Precision.HIGHEST."""
    closed = jax.make_jaxpr(fn)(*args)
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params.get("precision"))
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):
                    walk(v.jaxpr)
                if isinstance(v, (tuple, list)):
                    for vv in v:
                        if hasattr(vv, "jaxpr"):
                            walk(vv.jaxpr)

    walk(closed.jaxpr)
    assert found, "expected at least one dot_general"
    for prec in found:
        assert prec == (lax.Precision.HIGHEST, lax.Precision.HIGHEST), prec


def test_gap_matches_f64_recompute_on_f32_inputs():
    X, y = _gen(dtype=np.float32)
    sol = cd.lasso(X, y, 0.05, options=cd.CDOptions(block_size=16))
    beta = np.asarray(sol.x)
    g32 = float(cd.lasso_duality_gap(jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(beta), 0.05))
    g64 = _np_gap(X, y, beta, 0.05)
    assert abs(g32 - g64) < 1e-6
    gf64, primal = cd.lasso_duality_gap_f64(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta), 0.05)
    assert abs(gf64 - g64) < 1e-7
    assert primal > 0


def test_kkt_matches_f64_recompute_on_f32_inputs():
    X, y = _gen(seed=1, dtype=np.float32)
    w = np.abs(np.random.default_rng(2).standard_normal(
        X.shape[1])).astype(np.float32) + 0.5
    sol = cd.lasso(X, y, 0.05, weights=w,
                   options=cd.CDOptions(block_size=16))
    beta = np.asarray(sol.x)
    k32 = float(cd.lasso_kkt_residual(jnp.asarray(X), jnp.asarray(y),
                                      jnp.asarray(beta), 0.05,
                                      jnp.asarray(w)))
    k64 = _np_kkt(X, y, beta, 0.05, w)
    assert abs(k32 - k64) < 1e-6


def test_diagnostics_pin_highest_precision():
    X, y = _gen(dtype=np.float32)
    Xd, yd = jnp.asarray(X), jnp.asarray(y)
    beta = jnp.zeros((X.shape[1],), jnp.float32)
    _all_dots_highest(
        lambda X, y, b: cd.lasso_duality_gap(X, y, b, 0.1), Xd, yd, beta)
    _all_dots_highest(
        lambda X, y, b: cd.lasso_kkt_residual(X, y, b, 0.1), Xd, yd, beta)


def test_losses_pin_highest_precision():
    X, y = _gen(dtype=np.float32)
    Xd, yd = jnp.asarray(X), jnp.asarray(y)
    beta = jnp.zeros((X.shape[1],), jnp.float32)
    w = jnp.ones_like(yd)
    A = jnp.asarray(X.T @ X / X.shape[0])
    b = jnp.asarray(-(X.T @ y) / X.shape[0])
    for loss in (cd.LeastSquaresLoss(yd, Xd), cd.WeightedLSLoss(yd, Xd, w),
                 cd.SqrtLassoLoss(yd, Xd)):
        _all_dots_highest(lambda b_, l=loss: cd.gradient(l, b_), beta)
        _all_dots_highest(lambda b_, l=loss: cd.value(l, b_), beta)
    quad = cd.QuadraticLoss(A, b)
    _all_dots_highest(lambda b_: cd.gradient(quad, b_), beta)
    _all_dots_highest(lambda b_: cd.value(quad, b_), beta)


def test_gradient_value_match_numpy_f64():
    X, y = _gen(seed=3, dtype=np.float32)
    rng = np.random.default_rng(4)
    beta = rng.standard_normal(X.shape[1]).astype(np.float32) * 0.1
    Xd, yd, bd = jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta)
    X64, y64, b64 = (np.asarray(a, np.float64) for a in (X, y, beta))
    n = X.shape[0]
    r = y64 - X64 @ b64
    np.testing.assert_allclose(
        np.asarray(cd.gradient(cd.LeastSquaresLoss(yd, Xd), bd)),
        -(X64.T @ r) / n, atol=1e-5)
    # sqrt value is plain ||r|| — consistent with gradient() = -X'r/||r||
    # and the solver's lam*||r|| zero rule (the reference's /sqrt(n) header
    # comment disagrees with its own gradient/minimizer; see losses.value)
    np.testing.assert_allclose(
        float(cd.value(cd.SqrtLassoLoss(yd, Xd), bd)),
        np.linalg.norm(r), rtol=1e-5)
    # value/gradient consistency: finite-difference of value matches
    # gradient for the sqrt loss (the inconsistency the old /sqrt(n)
    # normalization would fail by a factor sqrt(n))
    j, eps = 3, 1e-4
    bp = b64.copy(); bp[j] += eps
    bm = b64.copy(); bm[j] -= eps
    fd = (np.linalg.norm(y64 - X64 @ bp)
          - np.linalg.norm(y64 - X64 @ bm)) / (2 * eps)
    g = np.asarray(cd.gradient(cd.SqrtLassoLoss(yd, Xd), bd))[j]
    np.testing.assert_allclose(g, fd, rtol=1e-3)


def test_compensated_gap_matches_numpy_oracle():
    """ops/compensated: the f64-accumulated device gap must equal an
    all-NumPy float64 recomputation to ~1e-12 on f32 inputs (this is the
    measurement-grade certificate polish_lasso optimizes against)."""
    X, y = _gen(200, 300, 8, seed=3)
    rng = np.random.default_rng(4)
    beta = np.zeros(300, np.float32)
    beta[rng.choice(300, 12, replace=False)] = rng.standard_normal(
        12).astype(np.float32)
    lam = 0.2
    w = np.abs(rng.standard_normal(300)).astype(np.float32) + 0.5
    gap, primal = cd.lasso_duality_gap_compensated(X, y, beta, lam, w)
    # NumPy float64 oracle (same Fenchel certificate)
    X64 = X.astype(np.float64)
    y64 = y.astype(np.float64)
    b64 = beta.astype(np.float64)
    w64 = w.astype(np.float64)
    n = X.shape[0]
    r = y64 - X64 @ b64
    g = X64.T @ r
    ratio = np.max(np.abs(g) / (n * lam * w64))
    theta = r * min(1.0, 1.0 / ratio)
    primal_o = r @ r / (2 * n) + lam * np.sum(w64 * np.abs(b64))
    dual_o = (y64 @ y64 - (y64 - theta) @ (y64 - theta)) / (2 * n)
    np.testing.assert_allclose(primal, primal_o, rtol=1e-12)
    np.testing.assert_allclose(gap, primal_o - dual_o,
                               rtol=1e-10, atol=1e-13)
    # ragged col_chunk path (p=300 not a multiple of 128)
    gap2, _ = cd.lasso_duality_gap_compensated(X, y, beta, lam, w,
                                               col_chunk=128)
    np.testing.assert_allclose(gap2, gap, rtol=1e-12)


def test_polish_reaches_target_gap():
    """models/polish: starting from an f32-precision solve (KKT satisfied
    only to ~1e-6), the f64 active-set polish must certify rel gap ≤ 1e-7
    (BASELINE.json's metric; SURVEY §7(d)) — including picking up support
    changes via the compensated full sweep."""
    X, y = _gen(300, 800, 10, seed=11)
    lam = 0.05 * float(np.max(np.abs(X.astype(np.float64).T
                                     @ y.astype(np.float64))) / 300)
    opts = cd.CDOptions(opt_tol=1e-5, randomize=False)  # a COARSE solve
    sol = cd.lasso(jnp.asarray(X), jnp.asarray(y), lam, options=opts)
    gap0, primal0 = cd.lasso_duality_gap_compensated(X, y, sol.x, lam)
    res = cd.polish_lasso(X, y, sol.x, lam, target_rel_gap=1e-7)
    assert res.converged, (res.rel_gap, res.rounds)
    assert res.rel_gap <= 1e-7
    assert res.gap <= gap0
    # the polished point is a genuine lasso solution: verify with the
    # independent NumPy oracle gap too
    gap_chk, primal_chk = cd.lasso_duality_gap_compensated(
        X, y, res.beta, lam)
    assert gap_chk / primal_chk <= 1.1e-7
    # weighted variant
    rng = np.random.default_rng(5)
    w = (np.abs(rng.standard_normal(800)) + 0.5).astype(np.float32)
    solw = cd.lasso(jnp.asarray(X), jnp.asarray(y), lam,
                    weights=jnp.asarray(w), options=opts)
    resw = cd.polish_lasso(X, y, solw.x, lam, weights=w,
                           target_rel_gap=1e-7)
    assert resw.converged and resw.rel_gap <= 1e-7


def test_polish_working_set_growth_and_cap():
    """The polish working set must be able to GROW past its initial
    allocation (start from β=0 at a λ whose optimal support exceeds the
    initial C=256), and an input whose support already exceeds
    support_cap must still get an HONEST certificate (finite gap,
    converged=False) rather than NaN."""
    X, y = _gen(800, 900, 320, seed=23)
    lam = 0.02 * float(np.max(np.abs(X.astype(np.float64).T
                                     @ y.astype(np.float64))) / 800)
    # β = 0 start: every optimal-support coordinate enters via the
    # violation augment; the dense planted support (320 > 256) forces at
    # least one allocation re-grow
    res = cd.polish_lasso(X, y, np.zeros(900, np.float32), lam,
                          target_rel_gap=1e-7, max_rounds=10)
    assert res.converged, (res.rel_gap, res.rounds, res.support_size)
    assert res.support_size > 256
    gap_chk, primal_chk = cd.lasso_duality_gap_compensated(
        X, y, res.beta, lam)
    assert gap_chk / primal_chk <= 1.1e-7
    # cap-exceeded input: honest best-effort report
    rng = np.random.default_rng(3)
    beta_big = np.zeros(900, np.float64)
    beta_big[rng.choice(900, 500, replace=False)] = 0.1
    res2 = cd.polish_lasso(X, y, beta_big, lam, support_cap=256)
    assert not res2.converged
    assert np.isfinite(res2.gap) and np.isfinite(res2.rel_gap)


def test_grad_certified_hybrid_matches_full_f64():
    """The hybrid certificate sweep (grad_f64_certified) must give the
    SAME Fenchel gap and the same violation ranking as the full f64
    sweep: exact values on the near-max edge set, and provably
    can't-matter columns elsewhere.  Covers random designs, a
    near-tie design (many columns at the max — large edge set), and the
    cap fallback."""
    from coordinatedescent_jl_tpu.ops.compensated import (
        fenchel_gap_f64, grad_f64, grad_f64_certified, residual_f64)

    rng = np.random.default_rng(41)
    n, p = 400, 1200
    X, y = _gen(n, p, 25, seed=41)
    lam = 0.1 * float(np.max(np.abs(X.astype(np.float64).T
                                    @ y.astype(np.float64))) / n)
    sol = cd.lasso(jnp.asarray(X), jnp.asarray(y), lam,
                   options=cd.CDOptions(opt_tol=1e-6))
    w = np.ones(p)
    bx = np.asarray(sol.x, np.float64)
    sup = np.nonzero(bx)[0]
    C = max(128, -(-sup.size // 128) * 128)
    idx = np.full((C,), p)
    idx[:sup.size] = sup
    bs = np.zeros(C)
    bs[:sup.size] = bx[sup]
    r64 = residual_f64(jnp.asarray(X), jnp.asarray(y), jnp.asarray(idx),
                       jnp.asarray(bs))
    g_full = np.asarray(grad_f64(jnp.asarray(X), r64))
    g_hyb = np.asarray(grad_f64_certified(jnp.asarray(X), r64,
                                          n * lam * w))
    gap_f, primal_f = fenchel_gap_f64(np.asarray(r64), g_full, bx, lam,
                                      w, n, y.astype(np.float64))
    gap_h, primal_h = fenchel_gap_f64(np.asarray(r64), g_hyb, bx, lam,
                                      w, n, y.astype(np.float64))
    assert primal_h == primal_f
    np.testing.assert_allclose(gap_h, gap_f, rtol=1e-12, atol=1e-18)
    # violation ranking (the augment consumer): clipped viols identical
    v_full = np.maximum(np.abs(g_full) / n - lam * w, 0.0)
    v_hyb = np.maximum(np.abs(g_hyb) / n - lam * w, 0.0)
    np.testing.assert_allclose(v_hyb, v_full, rtol=1e-12, atol=1e-20)
    # near-tie design: duplicate the max column many times
    jmax = int(np.argmax(np.abs(g_full)))
    Xt = X.copy()
    Xt[:, :50] = X[:, [jmax]] * (1 + 1e-9 * np.arange(50))[None, :]
    g_full_t = np.asarray(grad_f64(jnp.asarray(Xt), r64))
    g_hyb_t = np.asarray(grad_f64_certified(jnp.asarray(Xt), r64,
                                            n * lam * w))
    rat_f = np.max(np.abs(g_full_t) / (n * lam * w))
    rat_h = np.max(np.abs(g_hyb_t) / (n * lam * w))
    np.testing.assert_allclose(rat_h, rat_f, rtol=1e-13)
    # cap fallback path: cap=0 forces the full sweep — bitwise equal
    g_cap = np.asarray(grad_f64_certified(jnp.asarray(X), r64,
                                          n * lam * w, cap=0))
    np.testing.assert_array_equal(g_cap, g_full)


def test_polish_hybrid_still_reaches_target():
    """polish_lasso with the hybrid sweep still certifies ≤1e-7 and the
    result cross-checks against the full-f64 public certificate."""
    X, y = _gen(300, 800, 10, seed=11)
    lam = 0.05 * float(np.max(np.abs(X.astype(np.float64).T
                                     @ y.astype(np.float64))) / 300)
    sol = cd.lasso(jnp.asarray(X), jnp.asarray(y), lam,
                   options=cd.CDOptions(opt_tol=1e-5, randomize=False))
    res = cd.polish_lasso(X, y, sol.x, lam, target_rel_gap=1e-7)
    assert res.converged and res.rel_gap <= 1e-7
    gap_chk, primal_chk = cd.lasso_duality_gap_compensated(
        X, y, res.beta, lam)
    assert gap_chk / primal_chk <= 1.1e-7


def test_sqrt_kkt_compensated_matches_numpy_oracle():
    """ops/compensated.sqrt_lasso_kkt_compensated ≡ an all-NumPy f64
    recomputation of the sqrt-lasso KKT certificate (off-support excess
    + on-support stationarity, relative to λ‖r‖)."""
    X, y = _gen(150, 400, 8, seed=9)
    lam = 1.1 * float(np.sqrt(2 * np.log(400)))
    sol = cd.sqrt_lasso(X, y, lam, standardize_X=False,
                        options=cd.CDOptions(opt_tol=1e-7,
                                             randomize=False))
    beta = np.asarray(sol.x, np.float64)
    kkt_rel, rn = cd.sqrt_lasso_kkt_compensated(X, y, beta, lam)
    # NumPy f64 oracle
    X64 = X.astype(np.float64)
    r = y.astype(np.float64) - X64 @ beta
    rn_o = float(np.linalg.norm(r))
    g = X64.T @ r
    t = lam * rn_o
    off = np.maximum(np.abs(g) - t, 0.0)
    sup = np.nonzero(beta)[0]
    on = np.abs(g[sup] - t * np.sign(beta[sup]))
    kkt_o = max(off.max(), on.max() if sup.size else 0.0) / t
    np.testing.assert_allclose(rn, rn_o, rtol=1e-12)
    np.testing.assert_allclose(kkt_rel, kkt_o, rtol=1e-9, atol=1e-14)
    # sanity: a converged solve certifies at a small relative residual
    # (the coordinate-change rule at 1e-7 lands near ~1e-5 KKT — that
    # TRUE value is exactly what this measurement exposes)
    assert 0.0 <= kkt_rel < 1e-3
    # weighted variant: the certificate must be PER-COORDINATE relative
    # (each violation measured against its own threshold λ‖r‖w_j)
    rngw = np.random.default_rng(5)
    wv = (np.abs(rngw.standard_normal(400)) + 0.2).astype(np.float64)
    solw = cd.sqrt_lasso(X, y, lam, weights=wv.astype(np.float32),
                         standardize_X=False,
                         options=cd.CDOptions(opt_tol=1e-7,
                                              randomize=False))
    bw = np.asarray(solw.x, np.float64)
    kkt_w, rn_w = cd.sqrt_lasso_kkt_compensated(X, y, bw, lam,
                                                weights=wv)
    rw = y.astype(np.float64) - X.astype(np.float64) @ bw
    gw = X.astype(np.float64).T @ rw
    tw = lam * np.linalg.norm(rw) * wv
    supw = np.nonzero(bw)[0]
    offw = np.max(np.maximum(np.abs(gw) - tw, 0.0) / tw)
    onw = (np.max(np.abs(gw[supw] - tw[supw] * np.sign(bw[supw]))
                  / tw[supw]) if supw.size else 0.0)
    np.testing.assert_allclose(kkt_w, max(offw, onw), rtol=1e-9,
                               atol=1e-12)


def test_group_kkt_compensated_matches_numpy_oracle():
    """ops/compensated.group_lasso_kkt_compensated ≡ an all-NumPy f64
    recomputation of the group-KKT certificate, on a solved group lasso
    (plain + weighted), with the group-roll-up exclusion sound."""
    rng = np.random.default_rng(17)
    n, p, G = 200, 480, 8
    ng = p // G
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    for g in rng.choice(ng, 6, replace=False):
        beta[g * G:(g + 1) * G] = rng.standard_normal(G)
    y = (X @ beta + 0.3 * rng.standard_normal(n)).astype(np.float32)
    lam_max = float(np.max([np.linalg.norm(
        X[:, g * G:(g + 1) * G].astype(np.float64).T
        @ y.astype(np.float64)) for g in range(ng)]) / n)
    lam = 0.3 * lam_max
    bsol = np.asarray(cd.group_lasso(
        X, y, lam, G,
        options=cd.CDOptions(opt_tol=1e-10, randomize=False)).x,
        np.float64)
    for w in (None, (np.abs(rng.standard_normal(ng)) + 0.5)):
        if w is not None:
            bchk = np.asarray(cd.group_lasso(
                X, y, lam, G, weights=w.astype(np.float32),
                options=cd.CDOptions(opt_tol=1e-10,
                                     randomize=False)).x, np.float64)
        else:
            bchk = bsol
        kkt_rel, n_exact = cd.group_lasso_kkt_compensated(
            X, y, bchk, lam, G, weights=w)
        # NumPy f64 oracle
        X64 = X.astype(np.float64)
        r = y.astype(np.float64) - X64 @ bchk
        g64 = X64.T @ r
        wv = np.ones(ng) if w is None else w
        off = on = 0.0
        for gi in range(ng):
            sl = slice(gi * G, (gi + 1) * G)
            t = n * lam * wv[gi]
            nrm = np.linalg.norm(g64[sl])
            bg = bchk[sl]
            if np.any(bg != 0):
                d = np.linalg.norm(g64[sl] - t * bg / np.linalg.norm(bg))
                on = max(on, d / t)
            else:
                off = max(off, max(nrm - t, 0.0) / t)
        kkt_o = max(off, on)
        np.testing.assert_allclose(kkt_rel, kkt_o, rtol=1e-9,
                                   atol=1e-12)
        assert n_exact <= ng
        # sanity: small relative residual at a converged solve (the
        # step-size rule at 1e-10 lands near ~1e-6 relative group-KKT)
        assert 0.0 <= kkt_rel < 1e-4


def test_polish_sqrt_lasso_reaches_target():
    """polish_sqrt_lasso: from an f32 sqrt-lasso solve, the f64 active-set
    polish with the exact three-branch minimizer must certify the
    compensated per-coordinate relative KKT ≤ 1e-7 (the reference's
    optTol bar, utils.jl:17, extended to the sqrt loss)."""
    X, y = _gen(300, 800, 10, seed=13)
    lam = 1.1 * float(np.sqrt(2 * np.log(800)))
    sol = cd.sqrt_lasso(jnp.asarray(X), jnp.asarray(y), lam,
                        standardize_X=False)
    kkt0, _ = cd.sqrt_lasso_kkt_compensated(X, y, sol.x, lam)
    res = cd.polish_sqrt_lasso(X, y, sol.x, lam)
    assert res.converged, (res.kkt_rel, res.rounds)
    assert res.kkt_rel <= 1e-7
    assert res.kkt_rel <= max(kkt0, 1e-12)
    # independent re-certification of the polished iterate
    kkt_chk, rn = cd.sqrt_lasso_kkt_compensated(X, y, res.beta, lam)
    assert kkt_chk <= 1.1e-7
    assert abs(rn - res.norm_r) / rn < 1e-12
    # weighted variant
    rng = np.random.default_rng(7)
    w = (np.abs(rng.standard_normal(800)) + 0.5).astype(np.float32)
    solw = cd.sqrt_lasso(jnp.asarray(X), jnp.asarray(y), lam,
                         weights=jnp.asarray(w))
    resw = cd.polish_sqrt_lasso(X, y, solw.x, lam, weights=w)
    assert resw.converged and resw.kkt_rel <= 1e-7


def test_polish_scaled_lasso_fixed_point():
    """polish_scaled_lasso: the f64 (β, σ) fixed point — β certified at
    λ·σ AND σ = ‖r‖/√n self-consistent (reference scaledLasso!
    alternation at certification accuracy; the σ secant converges in a
    few rounds where the plain alternation needs dozens)."""
    X, y = _gen(300, 800, 10, seed=17)
    lam = float(np.sqrt(2 * np.log(800) / 300))
    sol = cd.scaled_lasso(jnp.asarray(X), jnp.asarray(y), lam)
    res = cd.polish_scaled_lasso(X, y, sol.x, lam)
    assert res.converged, (res.rel_gap, res.sigma_rel_change,
                           res.sigma_rounds)
    assert res.rel_gap <= 1e-7
    assert res.sigma_rel_change <= 1e-7
    # σ is the exact residual norm of the returned β
    r = np.asarray(y, np.float64) - np.asarray(X, np.float64) @ res.beta
    assert abs(np.sqrt(r @ r / 300) - res.sigma) / res.sigma < 1e-9
    # the polished β is optimal for the lasso at λ·σ (independent check)
    gap, primal = cd.lasso_duality_gap_compensated(
        X, y, res.beta, lam * res.sigma)
    assert gap / primal <= 1.1e-7


def test_polish_feasible_lasso_fixed_point():
    """polish_feasible_lasso: the f64 (β, Γ) loading fixed point — β
    certified at (λ0, Γ) AND Γ reproduced from β's exact residual to the
    reference's loading-stability rule (lasso.jl:154-194)."""
    X, y = _gen(300, 800, 10, seed=19)
    lam0 = float(np.sqrt(2 * np.log(800) / 300))
    sol = cd.feasible_lasso(jnp.asarray(X), jnp.asarray(y), lam0)
    res = cd.polish_feasible_lasso(X, y, sol.x, lam0)
    assert res.converged, (res.rel_gap, res.loading_rel_change,
                           res.loading_rounds)
    assert res.rel_gap <= 1e-7
    assert res.loading_rel_change <= 1e-7
    # the loadings are the exact f64 loadings of the returned residual
    r = np.asarray(y, np.float64) - np.asarray(X, np.float64) @ res.beta
    gam_chk = np.sqrt(np.mean(
        (np.asarray(X, np.float64) * r[:, None]) ** 2, axis=0))
    assert float(np.max(np.abs(gam_chk - res.loadings))
                 / np.max(gam_chk)) < 1e-12
    # β optimal for the weighted lasso at those loadings
    gap, primal = cd.lasso_duality_gap_compensated(
        X, y, res.beta, lam0, weights=res.loadings)
    assert gap / primal <= 1.1e-7


def test_polish_group_lasso_reaches_target():
    """polish_group_lasso: from an f32 group solve, the host-f64 block-CD
    with exact per-group subproblem solves must certify the compensated
    per-group relative KKT ≤ 1e-7; support groups outside the initial
    set are picked up by the roll-up augmentation."""
    X, y = _gen(300, 800, 10, seed=23)
    G = 8
    lam = 0.06
    sol = cd.group_lasso(jnp.asarray(X), jnp.asarray(y), lam, G)
    kkt0, _ = cd.group_lasso_kkt_compensated(X, y, sol.x, lam, G)
    res = cd.polish_group_lasso(X, y, sol.x, lam, G)
    assert res.converged, (res.kkt_rel, res.rounds)
    assert res.kkt_rel <= 1e-7
    kkt_chk, _ = cd.group_lasso_kkt_compensated(X, y, res.beta, lam, G)
    assert kkt_chk <= 1.1e-7
    # cold start from zero must also work (all support discovered via
    # augmentation)
    res0 = cd.polish_group_lasso(X, y, np.zeros(800), lam, G)
    assert res0.converged and res0.kkt_rel <= 1e-7
    assert np.max(np.abs(res0.beta - res.beta)) < 1e-8


def test_polish_group_lasso_ragged_tail_group():
    """p not divisible by group_size: the gathered set pads the tail
    group's out-of-range columns and the host block-CD must keep them
    pinned at zero while certifying the real coordinates."""
    X, y = _gen(200, 203, 6, seed=29)   # 203 = 25*8 + 3: ragged tail
    G = 8
    lam = 0.08
    sol = cd.group_lasso(jnp.asarray(X), jnp.asarray(y), lam, G)
    res = cd.polish_group_lasso(X, y, sol.x, lam, G)
    assert res.converged and res.kkt_rel <= 1e-7
    kkt_chk, _ = cd.group_lasso_kkt_compensated(X, y, res.beta, lam, G)
    assert kkt_chk <= 1.1e-7
    assert res.beta.shape == (203,)


def test_polish_sqrt_lasso_cold_start():
    """Cold start from zero: the sqrt polisher's KKT augmentation must
    discover the whole support and still certify at 1e-7."""
    X, y = _gen(300, 500, 8, seed=31)
    lam = 1.1 * float(np.sqrt(2 * np.log(500)))
    sol = cd.sqrt_lasso(jnp.asarray(X), jnp.asarray(y), lam,
                        standardize_X=False)
    ref = cd.polish_sqrt_lasso(X, y, sol.x, lam)
    res = cd.polish_sqrt_lasso(X, y, np.zeros(500), lam)
    assert res.converged and res.kkt_rel <= 1e-7
    assert np.max(np.abs(res.beta - ref.beta)) < 1e-8
