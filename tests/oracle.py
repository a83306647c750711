"""Plain-NumPy sequential coordinate-descent oracles for cross-checks.

Independent re-derivations of the reference algorithms' math (SURVEY.md §4
pattern 2: cross-implementation equivalence).  Deliberately simple and
sequential — these define "ground truth" solutions that the block engine
must match.
"""

import numpy as np


def soft(x, t):
    return np.sign(x) * max(abs(x) - t, 0.0)


def cd_lasso(X, y, lam0, lamw=None, w=None, max_epochs=2000, tol=1e-12):
    """Cyclic sequential CD for (weighted) least-squares + weighted L1.

    Per-coordinate rule: a = Σ w X², b = Σ w X r,
    x_k ← soft(x_k + b/a, n λ_k / a), r ← r − X_k h.
    """
    n, p = X.shape
    if lamw is None:
        lamw = np.ones(p)
    if w is None:
        w = np.ones(n)
    beta = np.zeros(p)
    r = y.copy()
    a = (w[:, None] * X * X).sum(axis=0)
    for _ in range(max_epochs):
        maxh = 0.0
        for k in range(p):
            if a[k] <= 0:
                continue
            b = np.dot(w * X[:, k], r)
            val = soft(beta[k] + b / a[k], n * lam0 * lamw[k] / a[k])
            h = val - beta[k]
            if h != 0.0:
                r -= X[:, k] * h
                beta[k] = val
            maxh = max(maxh, abs(h))
        if maxh < tol:
            break
    return beta, r


def cd_sqrt_lasso(X, y, lam0, lamw=None, max_epochs=2000, tol=1e-12):
    """Cyclic sequential CD for sqrt-lasso with the exact three-branch
    coordinate minimizer."""
    n, p = X.shape
    if lamw is None:
        lamw = np.ones(p)
    beta = np.zeros(p)
    r = y.copy()
    for _ in range(max_epochs):
        maxh = 0.0
        for k in range(p):
            rb = r + X[:, k] * beta[k]
            a = np.dot(X[:, k], X[:, k])
            if a <= 0:
                continue
            s = np.dot(rb, X[:, k])
            rsqr = np.dot(rb, rb)
            lam = lam0 * lamw[k]
            old = beta[k]
            if abs(s) <= lam * np.sqrt(rsqr) or lam * lam >= a:
                new = 0.0
            else:
                mag = (abs(s) - lam / np.sqrt(1 - lam * lam / a)
                       * np.sqrt(max(rsqr - s * s / a, 0.0))) / a
                new = np.sign(s) * mag
            beta[k] = new
            r = rb - X[:, k] * new
            maxh = max(maxh, abs(new - old))
        if maxh < tol:
            break
    return beta, r


def cd_quadratic(A, q, lam0, lamw=None, max_epochs=2000, tol=1e-12):
    """Cyclic sequential CD for x'Ax/2 + x'q + weighted L1."""
    p = q.shape[0]
    if lamw is None:
        lamw = np.ones(p)
    beta = np.zeros(p)
    Ax = np.zeros(p)
    for _ in range(max_epochs):
        maxh = 0.0
        for k in range(p):
            a = A[k, k]
            if a <= 0:
                continue
            g = Ax[k] + q[k]
            val = soft(beta[k] - g / a, lam0 * lamw[k] / a)
            h = val - beta[k]
            if h != 0.0:
                Ax += A[:, k] * h
                beta[k] = val
            maxh = max(maxh, abs(h))
        if maxh < tol:
            break
    return beta, Ax
