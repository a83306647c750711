#!/usr/bin/env python
"""Smoke test of the solver's main path on one NVIDIA GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the feature-sharded path only

One card, through the public API at the headline size (dense Gaussian
design, n = 10,000, p = 100,000, float32 — a 4 GB design — with a
scattered planted support of s = 100):

1. the ``gpu``-marked tests, in a pytest child process that finishes
   before this process touches the card (one JAX process per card);
2. ``lasso_path`` over 100 log-spaced λ from 0.5·λmax to 0.05·λmax, once
   with the auto default (batched certify/refine) and once with
   ``path_batch=0`` (sequential scan), every point certified;
3. one ``lasso`` solve (with ``compiled.memory_analysis()``), then
   ``polish_lasso`` to a relative duality gap ≤ 1e-7;
4. the ista inner pass (the default below float64) against the exact
   sequential scan at the headline width;
5. one call of each other estimator at ``bench.py``'s sizes;
6. the reference's own ``cd_bench`` shape (n = 3000, p = 5000) against
   the NumPy float64 sequential-CD oracle (``tests/oracle.py``).

Every solve passes its own certificate: the full KKT sweep (f32,
HIGHEST precision) and a float64 duality gap computed on the card.  Data
is drawn with NumPy from ``--seed`` and put on the device.  Any failed
check ends the run with a non-zero exit code; there is no fallback.  The
last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(n=10_000, p=100_000, s=100, points=100)
FOUR = dict(n=10_000, p=200_000, s=100, points=100)
# bench.py's sizes for the other estimators
GROUP = dict(n=10_000, p=100_000, G=8, active=12)
VC = dict(n=500, p=50, grid=1000)
ORACLE = dict(n=3000, p=5000, s=100)

# certificate limits.  f32 solves stop at the dtype's floor: a relative
# duality gap ~1e-6 (README "Certified 1e-7 duality gaps"); the limits
# give that floor a 10x margin.  The KKT excess is relative to λ.
REL_GAP_F32 = 1e-5
KKT_REL_F32 = 1e-3
REL_GAP_POLISH = 1e-7
# f32 solution vs the f64 oracle (README "Numerics")
ORACLE_COEF_ATOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    """Stop the run with a non-zero exit code unless ``ok``."""
    if not ok:
        print(f"chip_smoke: FAIL: {what}", file=sys.stderr, flush=True)
        raise SystemExit(1)
    log(f"  ok: {what}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def run_gpu_tests() -> None:
    """The ``gpu``-marked tests, in a child process that owns the card
    alone and has exited before this process initializes JAX's backend."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(ROOT, "tests")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    tail = out.stdout.strip().splitlines()[-1:] or [""]
    log(f"gpu tests: rc={out.returncode} {tail[0]} "
        f"({time.perf_counter() - t0:.1f} s)")
    if out.returncode != 0:
        print(out.stdout[-6000:], out.stderr[-4000:], file=sys.stderr)
    check(out.returncode == 0, "gpu-marked tests pass")
    passed = re.search(r"(\d+) passed", tail[0])
    check(passed is not None and "skipped" not in tail[0],
          "every gpu-marked test ran on the card")


# ---------------------------------------------------------------------------
# data and certificates
# ---------------------------------------------------------------------------


def make_data(n, p, s, seed, noise=1.0):
    """Dense Gaussian design, scattered support; y formed in float64 on
    the host so no device matmul precision enters the data."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p), dtype=np.float32)
    support = np.sort(rng.choice(p, s, replace=False))
    coef = rng.standard_normal(s)
    y = (X[:, support].astype(np.float64) @ coef
         + noise * rng.standard_normal(n)).astype(np.float32)
    return X, y


def lambda_grid(X, y, weights, points):
    """``points`` log-spaced λ from 0.5·λmax to 0.05·λmax, λmax the
    smallest λ at which β = 0 is optimal for these penalty weights."""
    import jax
    import jax.numpy as jnp

    n = X.shape[0]
    lmax = float(jax.jit(lambda X, y, w: jnp.max(jnp.abs(jnp.dot(
        y, X, precision=jax.lax.Precision.HIGHEST)) / (n * w)))(
            X, y, weights))
    return np.exp(np.linspace(np.log(0.5 * lmax), np.log(0.05 * lmax),
                              points)).astype(np.float32)


def certify(X, y, B, lams, weights):
    """Certificates of the rows of ``B`` (one per λ): the full KKT sweep
    in f32 at HIGHEST precision (max excess over λ·w, relative to λ) and
    the float64 relative duality gap, both computed on the card.
    Returns ``(kkt_rel, rel_gap, primal)`` arrays."""
    import jax
    import jax.numpy as jnp

    n = X.shape[0]
    hi = jax.lax.Precision.HIGHEST

    @jax.jit
    def kkt(X, y, B, lams, w):
        R = y[None, :] - jnp.dot(B, X.T, precision=hi)
        G = jnp.dot(R, X, precision=hi) / n
        lw = lams[:, None] * w[None, :]
        off = jnp.maximum(jnp.abs(G) - lw, 0.0)
        on = jnp.where(B != 0, jnp.abs(G - lw * jnp.sign(B)), 0.0)
        return jnp.max(jnp.maximum(off, on), axis=1) / lams

    with jax.enable_x64(True):
        @jax.jit
        def gap64(X, y, B, lams, w):
            X, y, B, lams, w = (a.astype(jnp.float64)
                                for a in (X, y, B, lams, w))
            R = y[None, :] - B @ X.T
            G = R @ X
            ratio = jnp.max(jnp.abs(G) / (n * lams[:, None] * w[None, :]),
                            axis=1)
            theta = R * jnp.minimum(1.0, 1.0 / ratio)[:, None]
            primal = (jnp.sum(R * R, axis=1) / (2 * n)
                      + lams * jnp.sum(w[None, :] * jnp.abs(B), axis=1))
            dual = (jnp.sum(y * y) - jnp.sum((y[None, :] - theta) ** 2,
                                             axis=1)) / (2 * n)
            return (primal - dual) / primal, primal

        rel, primal = gap64(X, y, jnp.asarray(B), jnp.asarray(lams),
                            weights)
        rel, primal = np.asarray(rel), np.asarray(primal)
    k = np.asarray(kkt(X, y, jnp.asarray(B, X.dtype),
                       jnp.asarray(lams, X.dtype), weights))
    return k, rel, primal


def check_certified(name, X, y, B, lams, weights, gap_limit=REL_GAP_F32):
    B = np.atleast_2d(np.asarray(B))
    lams = np.atleast_1d(np.asarray(lams, np.float32))
    k, rel, primal = certify(X, y, B, lams, weights)
    log(f"{name}: {len(lams)} point(s), max KKT excess/λ {k.max():.3e}, "
        f"max f64 rel gap {rel.max():.3e}, nnz(last) "
        f"{int(np.sum(B[-1] != 0))}")
    check(np.all(np.isfinite(B)), f"{name}: finite coefficients")
    check(k.max() <= KKT_REL_F32, f"{name}: KKT sweep ≤ {KKT_REL_F32}·λ")
    check(rel.max() <= gap_limit, f"{name}: f64 rel gap ≤ {gap_limit}")
    return primal, rel


def peak_bytes(device) -> int:
    """Most device memory the process's arrays have held on ``device``."""
    return device.memory_stats()["peak_bytes_in_use"]


def timed(fn, *args, **kw):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_paths(cd, X, y, size):
    """``lasso_path`` auto (batched) and scan, every point certified."""
    import jax.numpy as jnp

    w = cd.std_X(X)           # lasso_path's default penalty weights
    lams = lambda_grid(X, y, w, size["points"])
    stats = {}
    pb, t_c = timed(lambda: cd.lasso_path(X, y, lams, stats=stats)
                    .beta_path)
    pb, t_w = timed(lambda: cd.lasso_path(X, y, lams).beta_path)
    log(f"lasso_path auto: {t_c:.2f} s first call (compile + run), "
        f"{t_w:.3f} s warm; stats {stats}")
    check(stats.get("used_batched") and stats.get("batched_certified"),
          "auto default ran the batched certify/refine path and certified")
    check_certified("lasso_path auto", X, y, pb, lams, w)
    ps, t_c = timed(lambda: cd.lasso_path(X, y, lams, path_batch=0)
                    .beta_path)
    ps, t_w = timed(lambda: cd.lasso_path(X, y, lams, path_batch=0)
                    .beta_path)
    log(f"lasso_path scan: {t_c:.2f} s first call, {t_w:.3f} s warm")
    check_certified("lasso_path scan", X, y, ps, lams, w)
    diff = float(jnp.max(jnp.abs(pb - ps)))
    log(f"lasso_path batched vs scan: max|Δβ| {diff:.3e}")
    return lams


def phase_lasso_polish(cd, X, y, lam):
    """One ``lasso`` solve with its memory analysis, then the f64 polish
    to rel gap ≤ 1e-7, certified independently on the card."""
    import jax
    import jax.numpy as jnp

    ones = jnp.ones((X.shape[1],), X.dtype)
    compiled = jax.jit(lambda X, y: cd.lasso(X, y, lam).x).lower(
        X, y).compile()
    log(f"lasso memory_analysis: {compiled.memory_analysis()}")
    sol, t = timed(lambda: cd.lasso(X, y, lam).x)
    log(f"lasso: {t:.2f} s (first call)")
    sol, t = timed(lambda: cd.lasso(X, y, lam).x)
    log(f"lasso: {t:.3f} s warm")
    check_certified("lasso", X, y, sol, lam, ones)
    with jax.enable_x64(True):
        t0 = time.perf_counter()
        res = cd.polish_lasso(X, y, sol, float(lam), target_rel_gap=1e-7)
        t = time.perf_counter() - t0
    log(f"polish_lasso: rel gap {res.rel_gap:.3e} in {t:.2f} s, "
        f"{res.rounds} rounds, support {res.support_size}")
    check(res.converged and res.rel_gap <= REL_GAP_POLISH,
          "polish_lasso reaches rel gap ≤ 1e-7")
    _, rel, _ = certify(X, y, np.asarray(res.beta)[None], np.asarray([lam]),
                        ones)
    log(f"polished point: f64 rel gap on the card {rel[0]:.3e}")
    check(rel[0] <= REL_GAP_POLISH * (1 + 1e-3),
          "independent f64 gap of the polished point ≤ 1e-7")
    return sol


def phase_inner(cd, X, y, lam, sol_ista):
    """The ista pass against the exact scan at the headline width: the
    same converged support, objectives within their certified gaps."""
    import jax.numpy as jnp

    exact = cd.lasso(X, y, lam, options=cd.CDOptions(inner="exact")).x
    ones = jnp.ones((X.shape[1],), X.dtype)
    check_certified("lasso inner=exact", X, y, exact, lam, ones)
    _, rel, prim = certify(X, y, np.stack([np.asarray(sol_ista),
                                           np.asarray(exact)]),
                           np.asarray([lam, lam]), ones)
    s_i, s_e = np.asarray(sol_ista) != 0, np.asarray(exact) != 0
    log(f"ista vs exact: supports {int(s_i.sum())} / {int(s_e.sum())}, "
        f"symmetric difference {int(np.sum(s_e ^ s_i))}, f64 objectives "
        f"{prim[0]:.9e} / {prim[1]:.9e}")
    check(np.array_equal(s_e, s_i),
          "ista and exact passes converge to the same support")
    # each point is within its own f64 gap of the optimum
    check(abs(prim[0] - prim[1]) <= rel[0] * prim[0] + rel[1] * prim[1],
          "ista and exact objectives agree within their certified gaps")


def phase_estimators(cd, X, y, size, seed):
    """One call of every other estimator at bench.py's sizes."""
    import jax
    import jax.numpy as jnp

    n, p = X.shape
    # sqrt-lasso at the universal level for its |X_j'r| ≤ λ‖r‖ rule
    lam_sq = 1.1 * float(np.sqrt(2 * np.log(p)))
    sol, t = timed(lambda: cd.sqrt_lasso(X, y, lam_sq, standardize_X=False)
                   .x)
    with jax.enable_x64(True):
        kkt, _ = cd.sqrt_lasso_kkt_compensated(X, y, sol, lam_sq)
    log(f"sqrt_lasso: {t:.2f} s, nnz {int(jnp.sum(sol != 0))}, "
        f"compensated KKT rel {kkt:.3e}")
    check(np.all(np.isfinite(np.asarray(sol))) and kkt <= KKT_REL_F32,
          f"sqrt_lasso KKT ≤ {KKT_REL_F32} (relative)")

    lam_sc = float(np.sqrt(2 * np.log(p) / n))
    res, t = timed(lambda: cd.scaled_lasso(X, y, lam_sc))
    log(f"scaled_lasso: {t:.2f} s, σ {float(res.sigma):.4f}")
    # the solution is a Lasso at the λ·σ its last round used
    check_certified("scaled_lasso", X, y, res.x, float(res.penalty.lam0),
                    jnp.ones((p,), X.dtype))
    # feasible lasso returns the loadings re-estimated AFTER its last
    # solve (the reference's fixed-point output), so its certificate is
    # the f64 (β, Γ) fixed point of polish_feasible_lasso
    res, t = timed(lambda: cd.feasible_lasso(X, y, lam_sc))
    check(np.all(np.isfinite(np.asarray(res.x))),
          "feasible_lasso: finite coefficients")
    with jax.enable_x64(True):
        t0 = time.perf_counter()
        pol = cd.polish_feasible_lasso(X, y, res.x, lam_sc)
        t_pol = time.perf_counter() - t0
    log(f"feasible_lasso: {t:.2f} s, nnz {int(jnp.sum(res.x != 0))}; "
        f"fixed-point polish {t_pol:.2f} s: rel gap {pol.rel_gap:.3e}, "
        f"loading change {pol.loading_rel_change:.3e}, support "
        f"{int(np.sum(pol.beta != 0))}")
    check(pol.converged and pol.rel_gap <= REL_GAP_POLISH,
          "feasible_lasso reaches the certified (β, Γ) fixed point")

    # group lasso on its own design (freed before the next phase)
    g = GROUP
    rng = np.random.default_rng(seed + 11)
    Xg = rng.standard_normal((g["n"], g["p"]), dtype=np.float32)
    groups = rng.choice(g["p"] // g["G"], g["active"], replace=False)
    cols = (groups[:, None] * g["G"] + np.arange(g["G"])).ravel()
    yg = (Xg[:, cols].astype(np.float64).sum(axis=1)
          + 0.3 * rng.standard_normal(g["n"])).astype(np.float32)
    Xg, yg = jax.device_put(Xg), jax.device_put(yg)
    cg = jax.jit(lambda A, b: jnp.dot(
        b, A, precision=jax.lax.Precision.HIGHEST))(Xg, yg)
    lam_g = 0.3 * float(jnp.max(jnp.sqrt(jnp.sum(
        cg.reshape(-1, g["G"]) ** 2, axis=1))) / g["n"])
    sol, t = timed(lambda: cd.group_lasso(Xg, yg, lam_g, g["G"]).x)
    with jax.enable_x64(True):
        kkt, _ = cd.group_lasso_kkt_compensated(Xg, yg, sol, lam_g, g["G"])
    nzg = int(jnp.sum(jnp.any(sol.reshape(-1, g["G"]) != 0, axis=1)))
    log(f"group_lasso: {t:.2f} s, active groups {nzg}, compensated KKT "
        f"rel {kkt:.3e}")
    check(kkt <= KKT_REL_F32, f"group_lasso KKT ≤ {KKT_REL_F32} (relative)")
    del Xg, yg, cg

    # varying-coefficient suite (bench.py's grid)
    v = VC
    rng = np.random.default_rng(seed + 7)
    zv = rng.random(v["n"]).astype(np.float32)
    Xv = rng.standard_normal((v["n"], v["p"])).astype(np.float32)
    yv = (np.sin(2 * np.pi * zv) * Xv[:, 0]
          + 0.3 * rng.standard_normal(v["n"])).astype(np.float32)
    zgrid = np.linspace(0.05, 0.95, v["grid"]).astype(np.float32)
    kern = cd.GaussianKernel(0.1)
    vst = {}
    (ob, _), t_b = timed(lambda: cd.locpolyl1(Xv, zv, yv, zgrid, 1, kern,
                                              0.05, stats=vst))
    (os_, _), t_s = timed(lambda: cd.locpolyl1(Xv, zv, yv, zgrid, 1, kern,
                                               0.05, grid_batch=0))
    d = float(jnp.max(jnp.abs(ob - os_)))
    log(f"locpolyl1: auto {t_b:.2f} s (stats {vst}), scan {t_s:.2f} s, "
        f"max|Δ| {d:.3e}")
    check(vst.get("used_batched") and vst.get("batched_certified")
          and np.all(np.isfinite(np.asarray(ob))),
          "locpolyl1 batched grid certified and finite")
    check(d <= 1e-3, "locpolyl1 batched and scan agree to 1e-3")
    h_arr = [0.08, 0.12, 0.2, 0.3]
    cst = {}
    mse, t = timed(lambda: cd.lvocv_locpolyl1(
        Xv, zv, yv, 1, h_arr, cd.GaussianKernel, 0.05, stats=cst))
    log(f"lvocv_locpolyl1: {t:.2f} s (stats {cst}), MSE per bandwidth "
        f"{np.asarray(mse)}")
    check(cst.get("batched_certified") and np.all(np.isfinite(
        np.asarray(mse))), "lvocv_locpolyl1 batched lanes certified")


def phase_oracle(cd, seed):
    """The reference's cd_bench shape against the NumPy f64 oracle."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle import cd_lasso

    o = ORACLE
    rng = np.random.default_rng(seed + 1)
    Xo = rng.standard_normal((o["n"], o["p"]))
    bo = np.zeros(o["p"])
    bo[rng.choice(o["p"], o["s"], replace=False)] = rng.standard_normal(
        o["s"])
    yo = Xo @ bo + rng.standard_normal(o["n"])
    lam = 0.1 * float(np.max(np.abs(Xo.T @ yo)) / o["n"])
    t0 = time.perf_counter()
    b_or, _ = cd_lasso(Xo, yo, lam, max_epochs=2000, tol=1e-10)
    t_or = time.perf_counter() - t0
    Xd = jax.device_put(Xo.astype(np.float32))
    yd = jax.device_put(yo.astype(np.float32))
    sol, t = timed(lambda: cd.lasso(Xd, yd, lam).x)
    sol, t = timed(lambda: cd.lasso(Xd, yd, lam).x)
    b = np.asarray(sol, np.float64)
    err = float(np.max(np.abs(b - b_or)))
    log(f"cd_bench oracle: NumPy f64 {t_or:.2f} s, card f32 {t:.3f} s "
        f"warm, nnz {int(np.sum(b != 0))} / {int(np.sum(b_or != 0))}, "
        f"max|β − β_f64| {err:.3e}")
    check(np.array_equal(b != 0, b_or != 0), "same support as the oracle")
    check(err <= ORACLE_COEF_ATOL,
          f"coefficients within {ORACLE_COEF_ATOL} of the oracle")
    ones = jnp.ones((o["p"],), jnp.float32)
    check_certified("cd_bench lasso", Xd, yd, sol, lam, ones)


def run_one_card(cd, seed, size=HEADLINE):
    import jax

    t0 = time.perf_counter()
    X, y = make_data(size["n"], size["p"], size["s"], seed)
    X, y = jax.device_put(X), jax.device_put(y)
    log(f"data: n={size['n']} p={size['p']} s={size['s']} float32 "
        f"({X.nbytes / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")
    phase_t = time.perf_counter()
    lams = phase_paths(cd, X, y, size)
    log(f"phase paths: {time.perf_counter() - phase_t:.1f} s")
    lam = float(lams[-1])
    phase_t = time.perf_counter()
    sol = phase_lasso_polish(cd, X, y, lam)
    log(f"phase lasso+polish: {time.perf_counter() - phase_t:.1f} s")
    phase_t = time.perf_counter()
    phase_inner(cd, X, y, lam, sol)
    log(f"phase inner solvers: {time.perf_counter() - phase_t:.1f} s")
    phase_t = time.perf_counter()
    phase_estimators(cd, X, y, size, seed)
    log(f"phase estimators: {time.perf_counter() - phase_t:.1f} s")
    del X, y
    phase_t = time.perf_counter()
    phase_oracle(cd, seed)
    log(f"phase oracle: {time.perf_counter() - phase_t:.1f} s")


def run_four_cards(cd, seed, size=FOUR):
    """``lasso_path_sharded`` over a 4-card ``('feature',)`` mesh against
    the single-card ``lasso_path`` on the same data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    devs = jax.devices()
    check(len(devs) == 4, "four cards visible")
    mesh = cd.parallel.feature_mesh(devs)
    Xh, yh = make_data(size["n"], size["p"], size["s"], seed)
    X = jax.device_put(Xh, NamedSharding(mesh, P(None, "feature")))
    y = jax.device_put(yh, NamedSharding(mesh, P()))
    log(f"data: n={size['n']} p={size['p']} float32 "
        f"({Xh.nbytes / 1e9:.2f} GB) column-sharded over 4 cards")
    w = jax.jit(cd.std_X)(X)
    lams = lambda_grid(X, y, w, size["points"])
    stats = {}
    bs, t_c = timed(lambda: cd.parallel.lasso_path_sharded(
        X, y, lams, mesh, stats=stats).beta_path)
    bs, t_w = timed(lambda: cd.parallel.lasso_path_sharded(
        X, y, lams, mesh).beta_path)
    peaks = [peak_bytes(d) for d in devs]
    log(f"lasso_path_sharded: {t_c:.2f} s first call, {t_w:.3f} s warm; "
        f"stats {stats}")
    log("peak_bytes_in_use per card after the sharded path (GB): "
        + ", ".join(f"{b / 1e9:.2f}" for b in peaks))
    check(max(peaks) < 2 * min(peaks) and max(peaks) < Xh.nbytes,
          "the design is split across the cards, not held on card 0")
    bs = np.asarray(bs)
    del X, y

    d0 = devs[0]
    X1, y1 = jax.device_put(Xh, d0), jax.device_put(yh, d0)
    del Xh
    b1, t_c = timed(lambda: cd.lasso_path(X1, y1, lams).beta_path)
    log(f"lasso_path single card: {t_c:.2f} s first call")
    w1 = jax.device_put(w, d0)
    check_certified("lasso_path_sharded", X1, y1, bs, lams, w1)
    check_certified("lasso_path single card", X1, y1, b1, lams, w1)
    diff = float(np.max(np.abs(bs - np.asarray(b1))))
    same = int(np.sum((bs != 0) != (np.asarray(b1) != 0)))
    log(f"sharded vs single card: max|Δβ| {diff:.3e}, support "
        f"mismatches {same} over {bs.size} entries")
    check(diff <= 1e-3, "sharded and single-card paths agree to 1e-3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path and its "
                         "single-card comparison")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import coordinatedescent_jl_tpu as cd
    from coordinatedescent_jl_tpu.utils.compile_cache import (
        enable_compile_cache)

    card = gpu_name_and_power()
    log(f"nvidia-smi: {card}")
    if not args.four:
        run_gpu_tests()

    import jax

    cache = enable_compile_cache(os.path.join(ROOT, ".jax_cache"))
    devs = jax.devices()
    dev = devs[0]
    log(f"jax {jax.__version__}: platform {dev.platform}, device_kind "
        f"{dev.device_kind!r}, count {len(devs)}; compile cache {cache}")
    check(dev.platform == "gpu", "JAX runs on a GPU")
    if args.four:
        run_four_cards(cd, args.seed)
    else:
        run_one_card(cd, args.seed)
    log(f"total {time.perf_counter() - t_start:.1f} s; card {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
