"""End-to-end demo: production recipes for long-running / certified runs.

Four patterns a deployment actually needs on top of the estimator APIs:

1. run accounting for the certified batched executions (``stats={}``);
2. measurement-grade 1e-7 duality-gap certification from an f32 solve
   (``polish_lasso`` + ``lasso_duality_gap_compensated``);
3. host-chunked scans (``scan_chunk``) for environments that bound how
   long one device program may execute (the reference regime: a
   dense-support low-λ path scan is a single multi-minute program);
4. checkpoint / resume of an interrupted path (``lasso_path_resumable``).

Runs on whatever backend JAX selects (a GPU if available, else CPU):

    python examples/production_recipes.py          # default backend
    python examples/production_recipes.py --cpu    # force CPU
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # run from a checkout without install

import numpy as np
import jax

if "--cpu" in sys.argv:
    # the config update must land before the first backend touch
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

import coordinatedescent_jl_tpu as cd


def make_data(n=2000, p=4000, s=40, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    beta[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
    y = (X @ beta + 0.5 * rng.standard_normal(n)).astype(np.float32)
    return jnp.asarray(X), jnp.asarray(y)


def main():
    X, y = make_data()
    n, p = X.shape
    lam_max = float(jnp.max(jnp.abs(
        jnp.dot(y, X, precision=jax.lax.Precision.HIGHEST))) / n)
    lams = lam_max * np.logspace(-0.1, -1.5, 40)

    # -- 1. certified batched path with run accounting -------------------
    stats = {}
    path = cd.lasso_path(X, y, lams, stats=stats)
    print(f"path: {path.beta_path.shape[0]} points, "
          f"final nnz={int(jnp.sum(path.beta_path[-1] != 0))}, "
          f"stats={stats}")
    # stats['batched_certified'] False means the run fell back to the
    # sequential scan (identical solutions, more wall time) — alert on it
    # in production if you sized compact_size for the batched mode.

    # -- 2. measurement-grade certification (scoped x64) -----------------
    # the f64 tier needs x64, but a GLOBAL x64 flip breaks the f32
    # engine's index-dtype assumptions — scope it (bench.py does the
    # same); the f32 solve itself runs outside the scope
    lam = float(lams[-1])
    sol = cd.lasso(X, y, lam)
    with jax.enable_x64(True):
        gap0, primal0 = cd.lasso_duality_gap_compensated(X, y, sol.x, lam)
        res = cd.polish_lasso(X, y, sol.x, lam, target_rel_gap=1e-7)
    print(f"certified: rel gap {gap0 / primal0:.2e} -> "
          f"{res.rel_gap:.2e} in {res.rounds} round(s), "
          f"converged={res.converged}")

    # -- 3. host-chunked scan: bounded per-program runtime ---------------
    # scan_chunk splits the scan into 10-point device programs with the
    # warm-start carry round-tripped between them — the trajectory is
    # bitwise identical; use it when a single multi-minute program would
    # be killed (execution watchdogs) or must checkpoint coarsely.
    chunked = cd.lasso_path(X, y, lams, path_batch=0, scan_chunk=10)
    full = cd.lasso_path(X, y, lams, path_batch=0)
    same = bool(jnp.all(chunked.beta_path == full.beta_path))
    print(f"scan_chunk: bitwise identical to the monolithic scan: {same}")

    # -- 3b. the 1e-7 certification tier for every estimator -------------
    # each polish refines the f32 solution in f64 on its active set and
    # certifies against the real design (scoped x64; see README)
    lam_sq = 1.1 * float(np.sqrt(2 * np.log(X.shape[1])))
    sq = cd.sqrt_lasso(X, y, lam_sq, standardize_X=False)
    with jax.enable_x64(True):
        rs = cd.polish_sqrt_lasso(X, y, sq.x, lam_sq)
        print(f"sqrt polish: kkt_rel {rs.kkt_rel:.1e} "
              f"(converged={rs.converged})")
        lam_sc = float(np.sqrt(2 * np.log(X.shape[1]) / X.shape[0]))
        sc = cd.scaled_lasso(X, y, lam_sc)
        rsc = cd.polish_scaled_lasso(X, y, sc.x, lam_sc)
        print(f"scaled polish: rel_gap {rsc.rel_gap:.1e} "
              f"σ consistent to {rsc.sigma_rel_change:.1e}")

    # -- 4. checkpoint / resume ------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "path.npz")
        cd.lasso_path_resumable(X, y, lams[:20], ckpt)  # "interrupted"
        resumed = cd.lasso_path_resumable(X, y, lams[:20], ckpt)
        print(f"resume: {resumed.beta_path.shape[0]} points "
              f"(second call resumed from the checkpoint, 0 new solves)")


if __name__ == "__main__":
    main()
