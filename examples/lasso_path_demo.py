"""End-to-end demo: Lasso regularization path with diagnostics.

Runs on whatever backend JAX selects (a GPU if available, else CPU).

    python examples/lasso_path_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # run from a checkout without install

import numpy as np
import jax
import jax.numpy as jnp

import coordinatedescent_jl_tpu as cd


def main():
    rng = np.random.default_rng(0)
    n, p, s = 2000, 10_000, 40
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta_true = np.zeros(p, np.float32)
    support = rng.choice(p, s, replace=False)
    beta_true[support] = rng.standard_normal(s)
    y = (X @ beta_true + 0.5 * rng.standard_normal(n)).astype(np.float32)

    Xd, yd = jnp.asarray(X), jnp.asarray(y)
    lam_max = float(jnp.max(jnp.abs(yd @ Xd)) / n)
    lams = np.exp(np.linspace(np.log(0.8 * lam_max),
                              np.log(0.05 * lam_max), 50))

    opts = cd.CDOptions(opt_tol=1e-6)
    path = cd.lasso_path(Xd, yd, lams, options=opts, max_hat_s=4 * s)
    print(f"path: {path.beta_path.shape[0]} points "
          f"(early-stopped at support > {4 * s})")
    for i in [0, len(path.lam_path) // 2, len(path.lam_path) - 1]:
        b = np.asarray(path.beta_path[i])
        gap = float(cd.lasso_duality_gap(Xd, yd, path.beta_path[i],
                                         float(path.lam_path[i]),
                                         cd.std_X(Xd)))
        rec = len(set(np.nonzero(b)[0]) & set(support))
        print(f"  λ={float(path.lam_path[i]):.4f}: nnz={np.sum(b != 0):4d} "
              f"recovered {rec}/{s}, gap={gap:.2e}")

    refits = cd.refit_lasso_path(path, X, y)
    print(f"refits: {len(refits)} distinct supports")

    # batched execution: only every 8th point runs sequentially, the rest
    # refine in chunks where one R@X sweep certifies the whole chunk
    pb = cd.lasso_path(Xd, yd, lams, options=opts, max_hat_s=4 * s,
                       path_batch=16)
    if pb.beta_path.shape == path.beta_path.shape:
        agree = float(np.max(np.abs(np.asarray(pb.beta_path)
                                    - np.asarray(path.beta_path))))
        print(f"batched path: shape {pb.beta_path.shape}, "
              f"max |Δ| vs scan = {agree:.1e}")
    else:
        print(f"batched path: truncation DIFFERS from scan "
              f"({pb.beta_path.shape} vs {path.beta_path.shape})")

    beta, trace = cd.solve_with_trace(Xd, yd, float(lams[-1]), options=opts)
    print(f"trace: converged in {len(trace.max_h)} epochs, "
          f"final maxH={trace.max_h[-1]:.1e}, gap={trace.duality_gap[-1]:.1e}")


if __name__ == "__main__":
    main()
