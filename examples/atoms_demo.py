"""End-to-end demo: group atoms and symmetric-matrix iterates.

The reference driver accepts three iterate kinds
(coordinate_descent.jl:8): plain sparse vectors, ``AtomIterate`` group
atoms, and ``SymmetricSparseIterate`` packed symmetric matrices.  This
demo exercises the blocked analogues of the latter two:

    python examples/atoms_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # run from a checkout without install

import numpy as np
import jax.numpy as jnp

import coordinatedescent_jl_tpu as cd


def group_lasso_demo():
    rng = np.random.default_rng(0)
    n, p, G = 1000, 4096, 8
    ng = p // G
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    gsup = rng.choice(ng, 10, replace=False)
    for g in gsup:
        beta[g * G:(g + 1) * G] = rng.standard_normal(G)
    y = (X @ beta + 0.3 * rng.standard_normal(n)).astype(np.float32)

    sol = cd.group_lasso(X, y, 0.05, G)
    b = np.asarray(sol.x).reshape(ng, G)
    found = np.nonzero(np.any(b != 0, axis=1))[0]
    print(f"group lasso: {len(found)} active groups "
          f"(planted {len(gsup)}, recovered "
          f"{len(set(found) & set(gsup))}), σ̂={float(sol.sigma):.3f}")

    # the generic driver accepts the group penalty directly
    # (the AtomIterate driver contract)
    beta2, _ = cd.coordinate_descent(
        jnp.zeros((p,), jnp.float32),
        cd.LeastSquaresLoss(jnp.asarray(y), jnp.asarray(X)),
        cd.ProxL1Group(0.05, G), cd.CDOptions())
    print(f"driver ProxL1Group: max|Δ| vs group_lasso = "
          f"{float(jnp.max(jnp.abs(beta2 - sol.x))):.2e}")


def symmetric_demo():
    """Covariance thresholding over a symmetric iterate: minimize
    ½‖M − S‖_F² + λ‖M‖_{1,off} via the packed quadratic loss."""
    rng = np.random.default_rng(1)
    p = 64
    A = rng.standard_normal((p, 300)).astype(np.float32)
    S = (A @ A.T) / 300.0
    lam = 0.1
    ij = np.asarray(cd.sym_indices(p))
    off = (ij[:, 0] != ij[:, 1]).astype(np.float32)
    d = 1.0 + off                      # Frobenius multiplicities
    s = np.asarray(cd.sym_pack(jnp.asarray(S)))
    M, _ = cd.symmetric_coordinate_descent(
        jnp.zeros((p, p), jnp.float32),
        cd.QuadraticLoss(jnp.asarray(np.diag(d).astype(np.float32)),
                         jnp.asarray(-(d * s))),
        cd.ProxL1(lam, jnp.asarray(2.0 * off)),
        cd.CDOptions(opt_tol=1e-6))
    M = np.asarray(M)
    offm = ~np.eye(p, dtype=bool)
    print(f"symmetric thresholding: symmetric={np.array_equal(M, M.T)}, "
          f"off-diag sparsity={np.mean(M[offm] == 0):.1%}, "
          f"diag preserved={np.allclose(np.diag(M), np.diag(S), atol=1e-5)}")


if __name__ == "__main__":
    group_lasso_demo()
    symmetric_demo()
