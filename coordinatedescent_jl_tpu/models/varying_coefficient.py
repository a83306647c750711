"""Varying-coefficient (local-polynomial kernel) regression suite.

JAX equivalents of reference ``src/varying_coefficient_lasso.jl``:

- smoothing kernels                      — :3-21
- design expansion ``expand_X`` etc.     — :522-647 (here: one einsum)
- ``locpoly`` (low-dim, unpenalized)     — :197-235 (batched weighted lstsq,
  vmapped over the evaluation grid)
- ``locpolyl1`` (high-dim, L1)           — :30-79 (scan over the grid with
  warm-started β + weighted block-CD lasso per point)
- bandwidth selection ``lvocv_*`` /
  ``split_locpoly``                      — :82-137, :348-409 (LOO via
  weight-zeroing masks, vmapped over the held-out index)
- support / interpolation utilities      — :139-154, :237-255, :459-512
- sandwich standard errors               — :257-317

Design notes (SURVEY.md §7 delta 6): the reference mutates shared buffers
(`w`, `expandX`, `stdX`) per grid point and re-uses one ``SparseIterate`` β
across every solve in the suite; here every per-point problem is a pure
function of ``(X, z, z0)`` so grid points batch with ``vmap``/``scan``.
Warm-starting across grid points is kept where the reference forces it
(locpolyl1, :39-42) via a ``lax.scan`` carry; elsewhere (LOO-CV) points are
solved independently — warm starts only affect speed, not the converged
solution, which is what the reference's own invariance tests rely on.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.block_cd import (
    _to_blocked_beta,
    build_blocked,
    secant_alpha,
    solve_blocked,
)
from ..utils.helpers import get_sigma, std_X
from ..utils.options import (CDOptions, auto_batch_lanes,
                             resolve_extrapolate)
from ..ops.batched_certify import stall_escape_update


# ---------------------------------------------------------------------------
# Smoothing kernels (reference varying_coefficient_lasso.jl:3-21)
# ---------------------------------------------------------------------------


class GaussianKernel(NamedTuple):
    """``evaluate = exp(−(x−y)²/h)/h`` — note: matches the reference exactly
    (varying_coefficient_lasso.jl:17), which is *not* the standard N(0, h)
    density (no √π factor, h not squared)."""

    h: float


class EpanechnikovKernel(NamedTuple):
    """``0.75 (1 − u²)/h`` for ``|u| < 1`` with ``u = (x−y)/h``
    (varying_coefficient_lasso.jl:18-21)."""

    h: float


SmoothingKernel = Union[GaussianKernel, EpanechnikovKernel]


def create_kernel(kernel_type, h) -> SmoothingKernel:
    """Factory mirroring reference ``createKernel``
    (varying_coefficient_lasso.jl:14-15)."""
    return kernel_type(h)


def evaluate(kernel: SmoothingKernel, x, y):
    """Kernel weight(s); broadcasts elementwise over ``x``/``y``."""
    if isinstance(kernel, GaussianKernel):
        return jnp.exp(-((x - y) ** 2) / kernel.h) / kernel.h
    if isinstance(kernel, EpanechnikovKernel):
        u = (x - y) / kernel.h
        return jnp.where(jnp.abs(u) >= 1.0, 0.0,
                         0.75 * (1.0 - u * u) / kernel.h)
    raise TypeError(f"unsupported kernel: {type(kernel)!r}")


# ---------------------------------------------------------------------------
# Design expansion (reference :522-647) — loops become one einsum
# ---------------------------------------------------------------------------


def expand_X(X, z, z0, degree: int):
    """Row-wise Kronecker expansion: row i is
    ``X[i, :] ⊗ [1, (z_i − z0), …, (z_i − z0)^q]`` with feature-major /
    degree-minor column order (column ``j(q+1)+l`` is ``X_j ⋅ d^l``),
    matching reference ``_expand_X!`` (:550-569)."""
    n, p = X.shape
    d = z - z0
    powers = d[:, None] ** jnp.arange(degree + 1, dtype=X.dtype)[None, :]
    return (X[:, :, None] * powers[:, None, :]).reshape(n, p * (degree + 1))


def expand_wX(w, X, z, z0, degree: int):
    """``Diag(w) ⋅ expand_X`` (reference ``_expand_wX!``, :522-544)."""
    return w[:, None] * expand_X(X, z, z0, degree)


def expand_Xt_w_X(w, X, z, z0, degree: int):
    """``eX' W eX`` (reference ``_expand_Xt_w_X!``, :572-620)."""
    eX = expand_X(X, z, z0, degree)
    return eX.T @ (w[:, None] * eX)


def expand_Xt_w_Y(w, X, z, y, z0, degree: int):
    """``eX' W y`` (reference ``_expand_Xt_w_Y!``, :622-647)."""
    eX = expand_X(X, z, z0, degree)
    return eX.T @ (w * y)


# ---------------------------------------------------------------------------
# Local polynomial regression, low-dimensional (reference :197-235)
# ---------------------------------------------------------------------------


def _locpoly_point(X, z, y, z0, degree: int, kernel: SmoothingKernel):
    """Weighted LS via the normal equations + LU solve — one small
    batched factorization per point instead of the SVD that
    ``jnp.linalg.lstsq`` runs.  Method-identical to the reference's own
    ``locpoly_alt`` oracle (benchmark/locpoly_bench.jl:48-67; the
    primary ``_locpoly!`` at :197-210 is a QR backslash with the same
    solution on full-rank fits).  A rank-deficient fit (kernel mass ~0
    at z0) yields non-finite coefficients — ``locpoly`` patches those
    points with the rank-robust lstsq path."""
    from ..ops.block_cd import _PREC

    w = jnp.sqrt(evaluate(kernel, z, z0))
    wX = expand_wX(w, X, z, z0, degree)
    A = jnp.dot(wX.T, wX, precision=_PREC)
    b = jnp.dot(wX.T, w * y, precision=_PREC)
    coef = jnp.linalg.solve(A, b)
    # conditioning proxy (ADVICE r4): the normal equations square the
    # condition number, and a NEAR-singular fit (tiny kernel mass, not
    # exactly rank-deficient) returns finite-but-wrong coefficients the
    # non-finite check cannot see.  The normal-equation residual
    # ‖A·coef − b‖/‖b‖ is ~eps·cond(A) for an LU solve, so a 1e-3
    # threshold routes cond ≳ 1e4 fits to the rank-robust lstsq path.
    relres = (jnp.linalg.norm(jnp.dot(A, coef, precision=_PREC) - b)
              / jnp.maximum(jnp.linalg.norm(b), 1e-30))
    return coef, relres


def _locpoly_point_lstsq(X, z, y, z0, degree: int,
                         kernel: SmoothingKernel):
    """Rank-robust weighted LS (√w-scaled design + SVD lstsq) — the
    fallback for degenerate evaluation points."""
    w = jnp.sqrt(evaluate(kernel, z, z0))
    wX = expand_wX(w, X, z, z0, degree)
    coef, *_ = jnp.linalg.lstsq(wX, w * y)
    return coef


def locpoly(X, z, y, zgrid, degree: int,
            kernel: SmoothingKernel = None):
    """Local polynomial regression on a grid (or a single point).

    Reference ``locpoly`` (:217-235; default kernel ``GaussianKernel(1)``).
    Returns ``(p(degree+1), len(zgrid))`` — or a vector for scalar ``z0`` —
    in the reference's column layout.  Fits run as one vmapped
    normal-equation solve (see ``_locpoly_point``); any grid point whose
    fit comes back non-finite (rank-deficient local design) is
    recomputed with the SVD-based lstsq fallback.
    """
    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    y = jnp.asarray(y, X.dtype)
    if kernel is None:
        kernel = GaussianKernel(1.0)
    zgrid = jnp.asarray(zgrid, X.dtype)
    if zgrid.ndim == 0:
        out, relres = _locpoly_point(X, z, y, zgrid, degree, kernel)
        if (not bool(jnp.all(jnp.isfinite(out)))
                or float(relres) > 1e-3):
            out = _locpoly_point_lstsq(X, z, y, zgrid, degree, kernel)
        return out
    fit = jax.vmap(lambda z0: _locpoly_point(X, z, y, z0, degree, kernel))
    out, relres = fit(zgrid)                        # (g, ep), (g,)
    bad = np.asarray(~jnp.all(jnp.isfinite(out), axis=1)
                     | (relres > 1e-3))
    if bad.any():
        fit_f = jax.vmap(lambda z0: _locpoly_point_lstsq(
            X, z, y, z0, degree, kernel))
        out = jnp.asarray(out).at[jnp.asarray(np.nonzero(bad)[0])].set(
            fit_f(zgrid[jnp.asarray(np.nonzero(bad)[0])]))
    return out.T


# ---------------------------------------------------------------------------
# locpolyl1: high-dimensional varying-coefficient lasso (reference :30-79)
# ---------------------------------------------------------------------------


def _group_mask_expanded(beta_e, p: int, degree: int):
    """Expanded group-support mask: all (degree+1) coords of feature j are
    active iff any of them is nonzero (reference
    ``get_nonzero_coordinates!``, :488-512, expanded=true)."""
    grp = jnp.any(beta_e.reshape(p, degree + 1) != 0, axis=1)
    return jnp.repeat(grp, degree + 1)


def _masked_weighted_refit(eX, w, y, mask):
    """Weighted OLS on the masked columns without dynamic shapes: solve the
    full normal equations with inactive rows/cols replaced by the identity
    (so inactive coefficients are exactly 0).  Matches the reference's
    ``(Xs' W Xs) \\ (Xs' W y)`` on the support (:73-75)."""
    ep = eX.shape[1]
    A = eX.T @ (w[:, None] * eX)
    b = eX.T @ (w * y)
    m2 = jnp.outer(mask, mask)
    A = jnp.where(m2, A, jnp.eye(ep, dtype=A.dtype))
    b = jnp.where(mask, b, 0.0)
    return jnp.linalg.solve(A, b)


def _batched_masked_refit(X, y, w, dpow, B):
    """Batched (k-lane) form of ``_masked_weighted_refit`` on the
    implicit expanded design: lane k's columns are X_j·(z_i−z0_k)^d,
    materialized once per chunk as ``eXl``.  Shared by the batched
    z-grid refit (``_locpolyl1_batched_core``) and the batched LOO-CV
    refit (``_lvocv_locpolyl1_one_h_batched``) so the masked
    normal-equation identity substitution stays single-sourced.
    Off-mask rows of A become identity rows with b=0, so ``br`` is
    exactly 0 off-mask.  Returns ``(br, mask)``."""
    from ..ops.block_cd import _PREC

    k, n = w.shape
    p = X.shape[1]
    q1 = dpow.shape[2]
    ep = p * q1
    eXl = (X[None, :, :, None] * dpow[:, :, None, :]).reshape(k, n, ep)
    mask = jnp.repeat(jnp.any(B.reshape(k, p, q1) != 0, axis=2), q1,
                      axis=1)
    A = jnp.einsum("kne,kn,knf->kef", eXl, w, eXl, precision=_PREC)
    b = jnp.einsum("kne,kn->ke", eXl, w * y[None, :], precision=_PREC)
    m2 = mask[:, :, None] & mask[:, None, :]
    A = jnp.where(m2, A, jnp.eye(ep, dtype=X.dtype)[None])
    b = jnp.where(mask, b, 0.0)
    return jnp.linalg.solve(A, b[..., None])[..., 0], mask


@functools.partial(jax.jit,
                   static_argnames=("degree", "opts", "refit",
                                    "kernel_type", "resume"))
def _locpolyl1_core(X, z, y, zgrid, h, lam0, key, degree: int,
                    kernel_type, opts: CDOptions, refit: bool,
                    carry_in=None, resume: bool = False):
    """One warm-started scan over ``zgrid``; returns
    ``(out, out_refit, carry_out)``.  ``resume=True`` starts from a prior
    segment's ``carry_out`` — used by ``locpolyl1(scan_chunk=…)`` to
    bound single-device-program runtime with a trajectory identical to
    the monolithic scan."""
    n, p = X.shape
    ep = p * (degree + 1)
    kernel = kernel_type(h)
    beta_b0 = _to_blocked_beta(jnp.zeros((ep,), X.dtype), opts.block_size)

    def scan_body(carry, z0):
        beta_b, beta_prev, z_k, z_km1, key = carry
        beta_k = beta_b
        key, k1 = jax.random.split(key)
        # secant extrapolation of the warm start across grid points:
        # β(z0) is smooth between support changes, so shifting the start
        # along the last secant usually lands near the next solution
        # (same accelerant as block_cd._extrapolate_path_start; here the
        # residual is recomputed from scratch by the solver's init, so the
        # shift needs no cache bookkeeping).  Zero coordinates stay zero —
        # support changes are the solver's job.
        alpha = (secant_alpha(z0, z_k, z_km1, X.dtype)
                 if resolve_extrapolate(opts, True) else jnp.zeros((), X.dtype))
        start = jnp.where(beta_b != 0,
                          beta_b + alpha * (beta_b - beta_prev), 0.0)
        w = evaluate(kernel, z, z0)
        eX = expand_X(X, z, z0, degree)
        stdX = std_X(eX, w)
        prob = build_blocked("wls", opts, stdX, X=eX, y=y, w=w)
        st = solve_blocked("wls", opts, prob, lam0, start, k1)
        beta = st.beta.reshape(-1)[:ep]
        if refit:
            mask = _group_mask_expanded(beta, p, degree)
            br = _masked_weighted_refit(eX, w, y, mask)
        else:
            br = jnp.zeros((ep,), X.dtype)
        return (st.beta, beta_k, z0, z_k, key), (beta, br)

    if resume:
        carry0 = carry_in
    else:
        # initialize both abscissa carries with the FIRST grid value: the
        # first two steps then see denom == 0 and skip the shift (a
        # 0-sentinel would make step 2 extrapolate from a fictitious
        # (z=0, β=0) point on ascending grids)
        z_init = zgrid[0]
        carry0 = (beta_b0, beta_b0, z_init, z_init, key)
    carry_out, (out, out_r) = lax.scan(scan_body, carry0, zgrid)
    return out.T, out_r.T, carry_out


class _VcBatchOps:
    """Shared per-chunk machinery for the batched varying-coefficient
    executions (the z-grid ``_locpolyl1_batched_core`` and the LOO-CV
    ``_lvocv_locpolyl1_one_h_batched``): per-lane kernel weights + power
    tensors, closed-form diagonals, implicit-matvec preconditioned FISTA,
    and the noise-floor-masked KKT certify with the scan's f32 stall
    escape.  All members are tracers (constructed inside a jit trace);
    ``thrw`` is an argument everywhere so callers with per-round λ
    (the CV's λ·σ fixed point) reuse the same machinery."""

    def __init__(self, X, z, y, kernel, z0, degree: int,
                 opts: CDOptions, holdout=None):
        from ..ops.block_cd import _PREC

        n, p = X.shape
        q1 = degree + 1
        dt = X.dtype
        k = z0.shape[0]
        self.X, self.y, self.opts = X, y, opts
        self.n, self.p, self.q1, self.ep, self.k = n, p, q1, p * q1, k
        self.dt = dt
        self.n_scale = jnp.asarray(n, dt)
        self.sub_f64 = jnp.dtype(dt).itemsize < 8
        self.eps = jnp.finfo(dt).eps
        arange_q = jnp.arange(q1, dtype=dt)
        w = jax.vmap(lambda a: evaluate(kernel, z, a))(z0)     # (k, n)
        if holdout is not None:
            # leave-one-out: zero the held-out row's weight per lane
            w = w.at[jnp.arange(k), holdout].set(0.0)
        self.w = w
        d = z[None, :] - z0[:, None]
        self.dpow = d[:, :, None] ** arange_q[None, None, :]   # (k,n,q1)
        X2 = X * X
        # adiag_(j,d) = Σ_i w_i X_ij² d_i^{2d}; lamw = sqrt(adiag/n)
        # (std_X's divisor-is-n quirk, utils.jl:140-151); xwnorm uses w²
        # (wls Xw = w⊙X) for the engine's step-noise scale
        wd2 = w[:, :, None] * self.dpow * self.dpow
        adiag = jnp.einsum("knd,np->kpd", wd2, X2,
                           precision=_PREC).reshape(k, self.ep)
        self.adiag = jnp.maximum(adiag, jnp.asarray(1e-30, dt))
        self.lamw = jnp.sqrt(self.adiag / self.n_scale)
        xw2 = jnp.einsum("knd,np->kpd", w[:, :, None] * wd2, X2,
                         precision=_PREC).reshape(k, self.ep)
        self.xwnorm = jnp.sqrt(jnp.maximum(xw2, 1e-60))
        # preconditioner: solve in β̃ = √a·β units (raw expanded columns
        # span ~h^degree in scale, which starves plain FISTA)
        self.sc = jnp.sqrt(self.adiag)
        # per-lane Lipschitz bound of the SCALED Gram via power
        # iterations (each two shared contractions), once per chunk

        def power(carry, _):
            v, _ = carry
            u = self._Kv(v)
            nrm = jnp.sqrt(jnp.einsum("ke,ke->k", u, u,
                                      precision=_PREC))
            return (u / jnp.maximum(nrm[:, None], 1e-30), nrm), None

        # start vector with no symmetry the design could be orthogonal
        # to (a uniform vector can miss antisymmetric top modes of
        # degree≥1 expanded columns around a central z0); the estimate
        # is still a LOWER bound, so take a 1.2 margin — the certify
        # stall gate keeps any residual divergence uncertified (→ the
        # caller's fallback) rather than silently accepted
        ar = jnp.arange(self.ep, dtype=dt)
        v0 = jnp.where(ar % 2 == 0, 1.0, -1.0) * (1.0 + ar / self.ep)
        v0 = jnp.broadcast_to(v0 / jnp.sqrt(jnp.sum(v0 * v0)),
                              (k, self.ep))
        (_, Lt), _ = lax.scan(power, (v0, jnp.ones((k,), dt)), None,
                              length=16)
        self.Lt = 1.2 * jnp.maximum(Lt, 1e-30)                 # (k,)

    def _Kv(self, v):
        from ..ops.block_cd import _PREC

        u = v / self.sc
        pred = jnp.einsum("kpd,np,knd->kn",
                          u.reshape(self.k, self.p, self.q1), self.X,
                          self.dpow, precision=_PREC)
        Uw = (self.w * pred)[:, :, None] * self.dpow
        out = jnp.einsum("knd,np->kpd", Uw, self.X,
                         precision=_PREC).reshape(self.k, self.ep)
        return out / self.sc

    def residual(self, B):
        from ..ops.block_cd import _PREC

        pred = jnp.einsum("kpd,np,knd->kn",
                          B.reshape(self.k, self.p, self.q1), self.X,
                          self.dpow, precision=_PREC)
        return self.y[None, :] - pred

    def certify(self, B, R, thrw):
        from ..ops.block_cd import _PREC, noise_floor_mask

        U = (self.w * R)[:, :, None] * self.dpow
        Cg = jnp.einsum("knd,np->kpd", U, self.X,
                        precision=_PREC).reshape(self.k, self.ep)
        # cancellation-safe prox step (see
        # batched_certify.kkt_violation_lanes): B cancels algebraically
        gq = Cg / self.adiag
        tq = thrw / self.adiag
        zq = B + gq
        H = jnp.abs(jnp.where(jnp.abs(zq) > tq,
                              gq - tq * jnp.sign(zq), -B))
        if self.sub_f64:
            rnorm = jnp.sqrt(jnp.einsum("kn,kn->k", R, R,
                                        precision=_PREC))
            H = noise_floor_mask(
                H, B, 4 * self.eps * rnorm[:, None] / self.xwnorm)
        else:
            H = noise_floor_mask(H, B)
        return H

    def fista_phase(self, B, cert, thrw):
        """Fixed-count preconditioned FISTA sweep with implicit matvecs
        (two shared contractions per step); certified lanes frozen."""
        from ..ops.block_cd import _PREC
        from ..ops.prox import soft_threshold

        sc, Lt = self.sc, self.Lt
        Bt = B * sc
        thr_t = thrw / sc

        def fstep(carry, _):
            zt, vt, t = carry
            u = vt / sc
            pred = jnp.einsum("kpd,np,knd->kn",
                              u.reshape(self.k, self.p, self.q1),
                              self.X, self.dpow, precision=_PREC)
            rv = self.y[None, :] - pred
            Uw = (self.w * rv)[:, :, None] * self.dpow
            gv = jnp.einsum("knd,np->kpd", Uw, self.X,
                            precision=_PREC).reshape(self.k,
                                                     self.ep) / sc
            z_new = soft_threshold(vt + gv / Lt[:, None],
                                   thr_t / Lt[:, None])
            z_new = jnp.where(cert[:, None], zt, z_new)
            t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
            v_new = z_new + ((t - 1.0) / t_new) * (z_new - zt)
            return (z_new, v_new, t_new), None

        (Bt, _, _), _ = lax.scan(fstep, (Bt, Bt, jnp.ones((), self.dt)),
                                 None, length=self.opts.block_iters)
        return Bt / sc

    def solve(self, B0, thrw, frozen=None):
        """Certify/refine loop to the engine's KKT criterion (noise
        floor + f32 per-lane stall escape — see
        _locpolyl1_batched_core).  Returns ``(B, R, cert, escaped)``
        where ``escaped`` marks the lanes accepted via the near-tol
        stall escape rather than the strict rule (always all-False at
        f64)."""
        opts = self.opts
        tol = opts.opt_tol
        if frozen is None:
            frozen = jnp.zeros((self.k,), bool)
        R0 = self.residual(B0)
        H0 = self.certify(B0, R0, thrw)
        mx0 = jnp.max(H0, axis=1)
        cert0 = (mx0 < tol) | frozen
        patience = (opts.stall_patience if self.sub_f64
                    else np.iinfo(np.int32).max)
        stall0 = jnp.zeros((self.k,), jnp.int32)
        esc0 = jnp.zeros((self.k,), bool)

        def cond(s):
            B, R, cert, best, stall, esc, rounds = s
            return jnp.logical_and(~jnp.all(cert),
                                   rounds < 2 * opts.compact_rounds)

        def body(s):
            B, R, cert, best, stall, esc, rounds = s
            B = self.fista_phase(B, cert, thrw)
            # residual recomputed fresh each certify (an incrementally
            # maintained R would accumulate exactly the f32 drift the
            # certificate measures)
            R = self.residual(B)
            H = self.certify(B, R, thrw)
            mx = jnp.max(H, axis=1)
            cert, best, stall, esc = stall_escape_update(
                cert, best, stall, esc, mx, patience, tol)
            return (B, R, cert, best, stall, esc, rounds + 1)

        B, R, cert, _, _, esc, _ = lax.while_loop(
            cond, body, (B0, R0, cert0, mx0, stall0, esc0,
                         jnp.zeros((), jnp.int32)))
        return B, R, cert, esc


@functools.partial(jax.jit, static_argnames=("degree", "opts", "refit",
                                              "kernel_type", "stride",
                                              "batch"))
def _locpolyl1_batched_core(X, z, y, zgrid, h, lam0, key, degree: int,
                            kernel_type, opts: CDOptions, refit: bool,
                            stride: int, batch: int):
    """Batched z-grid execution: coarse anchor scan + chunked batched
    certify/refine — the λ-path scheme (``_lasso_path_batched_core``)
    transplanted to the varying-coefficient grid.

    The round-2 ``grid_batch`` failed because it vmapped FULL solves (every
    chunk pays the max-lane epoch count, and the docstring claimed the
    per-point designs "share no Gram").  That claim is wrong: every
    expanded column is ``X_j · (z_i − z0)^d``, so EVERY per-lane quantity
    is a small einsum against the shared ``X`` and the per-lane power
    tensor ``dpow[k, i, m] = (z_i − z0_k)^m`` — one stacked contraction
    certifies a whole chunk of z-points per round, exactly the
    amortization that makes the batched path win.  The refinement is
    ``_VcBatchOps``' preconditioned full-coordinate FISTA with implicit
    matvecs — fixed sweep count, lockstep, no max-lane-epoch tax, no
    union-Gram gathers (a per-lane union Gram was the first attempt and
    is pure HBM traffic at this problem shape: 14.6 s vs 0.10 s measured,
    PERF.md).  Every point's final certificate is the same
    order-independent wls KKT sweep (noise-floor-masked) the scan's
    solver uses, so certified outputs match the scan to solver tolerance.
    Returns ``(out, out_r, all_cert, n_escaped)``; on ``all_cert ==
    False`` the caller MUST fall back to the scan.  ``n_escaped`` counts
    the lanes accepted via the near-tol stall escape (always 0 at f64)."""
    from ..ops.block_cd import _PREC

    n, p = X.shape
    q1 = degree + 1
    ep = p * q1
    dt = X.dtype
    g = zgrid.shape[0]
    tol = opts.opt_tol
    n_scale = jnp.asarray(n, dt)
    kernel = kernel_type(h)

    cidx = np.arange(0, g, stride)
    if cidx[-1] != g - 1:
        cidx = np.append(cidx, g - 1)
    rest = np.setdiff1d(np.arange(g), cidx)

    out_c, _, _ = _locpolyl1_core(X, z, y, zgrid[jnp.asarray(cidx)], h, lam0,
                               key, degree, kernel_type, opts, False)
    betas_c = out_c.T                                   # (g_c, ep)

    def refine(args):
        z0, B0 = args                   # (k,), (k, ep)
        ops = _VcBatchOps(X, z, y, kernel, z0, degree, opts)
        thrw = ops.lamw * (lam0 * n_scale)
        B, _, cert, esc = ops.solve(B0, thrw)
        return B, cert, esc

    def lane_tensors(z0):
        """Per-lane kernel weights (k, n) and the power tensor
        (k, n, q1) — the refit chunks need them standalone."""
        w = jax.vmap(lambda a: evaluate(kernel, z, a))(z0)
        d = z[None, :] - z0[:, None]
        dpow = d[:, :, None] ** jnp.arange(q1, dtype=dt)[None, None, :]
        return w, dpow

    if rest.size:
        seg = np.searchsorted(cidx, rest) - 1
        z_lo = zgrid[jnp.asarray(cidx[seg])]
        z_hi = zgrid[jnp.asarray(cidx[seg + 1])]
        z_r = zgrid[jnp.asarray(rest)]
        denom = jnp.where(z_hi != z_lo, z_hi - z_lo, 1.0)
        a = jnp.clip((z_r - z_lo) / denom, 0.0, 1.0)
        starts = ((1.0 - a)[:, None] * betas_c[seg]
                  + a[:, None] * betas_c[seg + 1])
        k = min(batch, int(rest.size))
        nchunks = -(-int(rest.size) // k)
        pad = nchunks * k - int(rest.size)
        if pad:
            z_r = jnp.concatenate([z_r, jnp.repeat(z_r[-1:], pad)])
            starts = jnp.concatenate(
                [starts, jnp.repeat(starts[-1:], pad, axis=0)])
        if nchunks == 1:
            refined_all, certs, escs = refine((z_r, starts))
        else:
            refined_all, certs, escs = lax.map(
                refine, (z_r.reshape(nchunks, k),
                         starts.reshape(nchunks, k, ep)))
            refined_all = refined_all.reshape(nchunks * k, ep)
            certs = certs.reshape(nchunks * k)
            escs = escs.reshape(nchunks * k)
        refined = refined_all[:rest.size]
        all_cert = jnp.all(certs[:rest.size])
        n_escaped = jnp.sum(escs[:rest.size].astype(jnp.int32))
        betas = (jnp.zeros((g, ep), dt)
                 .at[jnp.asarray(cidx)].set(betas_c)
                 .at[jnp.asarray(rest)].set(refined))
    else:
        betas = betas_c
        all_cert = jnp.ones((), bool)
        n_escaped = jnp.zeros((), jnp.int32)

    if refit:
        def refit_chunk(args):
            z0, B = args
            w, dpow = lane_tensors(z0)
            br, _ = _batched_masked_refit(X, y, w, dpow, B)
            return br

        kr = min(batch, g)
        ncr = -(-g // kr)
        padr = ncr * kr - g
        zg_p = (jnp.concatenate([zgrid, jnp.repeat(zgrid[-1:], padr)])
                if padr else zgrid)
        be_p = (jnp.concatenate([betas, jnp.repeat(betas[-1:], padr,
                                                   axis=0)])
                if padr else betas)
        if ncr == 1:
            out_r = refit_chunk((zg_p, be_p))
        else:
            out_r = lax.map(refit_chunk,
                            (zg_p.reshape(ncr, kr),
                             be_p.reshape(ncr, kr, ep)))
            out_r = out_r.reshape(ncr * kr, ep)
        out_r = out_r[:g]
    else:
        out_r = jnp.zeros((g, ep), dt)
    return betas.T, out_r.T, all_cert, n_escaped


def _locpolyl1_scan_chunked(X, z, y, zgrid, h, lam0, key, degree: int,
                            kernel_type, opts: CDOptions, refit: bool,
                            chunk: int):
    """Host-chunked z-grid scan: segments of ``chunk`` points with the
    warm-start carry round-tripped between device programs — trajectory
    identical to the monolithic scan (bitwise at f64; tested), single
    program runtime bounded.  The last
    segment is padded by repeating the final z (one compiled program
    serves every segment); pad outputs are sliced off."""
    g = int(zgrid.shape[0])
    nseg = -(-g // chunk)
    pad = nseg * chunk - g
    if pad:
        zgrid = jnp.concatenate([zgrid, jnp.repeat(zgrid[-1:], pad)])
    outs, outs_r = [], []
    carry = None
    for s in range(nseg):
        seg = zgrid[s * chunk:(s + 1) * chunk]
        o, orf, carry = _locpolyl1_core(
            X, z, y, seg, h, lam0, key, degree, kernel_type, opts, refit,
            carry_in=carry, resume=s > 0)
        outs.append(o)
        outs_r.append(orf)
    return (jnp.concatenate(outs, axis=1)[:, :g],
            jnp.concatenate(outs_r, axis=1)[:, :g])


def locpolyl1(X, z, y, zgrid, degree: int, kernel: SmoothingKernel, lam0,
              refit: bool = True, options: CDOptions = CDOptions(), *,
              grid_batch: int | None = None,
              coarse_stride: int | None = None,
              scan_chunk: int | None = None, seed: int = 0,
              stats: dict | None = None):
    """Varying-coefficient lasso on a grid of evaluation points.

    Reference ``locpolyl1`` (:30-79): at each z0, kernel weights + expanded
    design + weighted column loadings, then a weighted Lasso solved by CD
    with β warm-started across grid points (warm start forced, :39-42).
    Returns ``(out, out_refit)``, both ``(p(degree+1), len(zgrid))``.

    ``grid_batch > 0`` selects the batched execution
    (``_locpolyl1_batched_core``): only every ``coarse_stride``-th grid
    point runs in the sequential scan; the rest are certify/refined in
    chunks of ``grid_batch`` lanes — preconditioned full-coordinate FISTA
    with IMPLICIT matvecs, every step two stacked contractions shared by
    the whole chunk.  This is NOT the round-2 ``grid_batch`` (vmapped
    full solves, removed for paying max-lane epochs): no lane ever pays
    another lane's epochs (fixed-count FISTA phases in lockstep), and the
    per-round cost is a few ``(k, n, degree+1)``-sized tensors, not a
    union-Gram gather.  Every point's final certificate is the same
    noise-floor-masked KKT sweep (with the scan's stall escape at f32);
    a run whose refinement fails to certify any lane falls back to the
    scan (warning) — the contract of ``lasso_path(path_batch=…)``.

    Batched and scan results agree to the f32 solver tolerance (f64
    matches to ~1e-9).  Defaults auto-resolve: ``None`` enables 128-lane
    batching with endpoint-ish anchors for sub-f64 dtypes on an
    accelerator on grids of ≥ 16 points; f64/CPU keep the scan.

    ``stats``, if a dict, receives ``used_batched``,
    ``batched_certified`` and ``stall_escaped_lanes`` — the same run
    accounting contract as ``lasso_path`` (escaped lanes are 0 whenever
    the scan result is returned, and always 0 at f64).

    ``scan_chunk > 0`` executes the sequential scan (including the
    fallback from an uncertified batched run) as host-driven segments of
    that many grid points with the warm-start carry round-tripped between
    device programs — identical trajectory, bounded single-program
    runtime (same contract and rationale as
    ``lasso_path(scan_chunk=…)``).
    """
    import warnings

    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    y = jnp.asarray(y, X.dtype)
    zgrid = jnp.asarray(zgrid, X.dtype)
    opts = options.replace(warm_start=True)
    key = jax.random.PRNGKey(seed)
    L = int(zgrid.shape[0])
    if grid_batch is None:
        grid_batch = auto_batch_lanes(X.dtype, L, min_points=16)
    if coarse_stride is None:
        coarse_stride = max(1, (L - 1) // 9)   # ~10 anchors
    if coarse_stride < 1:
        raise ValueError("coarse_stride must be >= 1")
    if grid_batch < 0:
        raise ValueError("grid_batch must be >= 0")
    if scan_chunk is not None and scan_chunk <= 0:
        raise ValueError("scan_chunk must be >= 1")
    if stats is not None:
        stats.update(used_batched=False, batched_certified=False,
                     stall_escaped_lanes=0)
    if grid_batch and L > max(2, coarse_stride):
        if stats is not None:
            # the attempt EXECUTES from here on — used_batched stays True
            # even on fallback (the run paid the attempt; same contract
            # as lasso_path)
            stats["used_batched"] = True
        out, out_r, all_cert, n_esc = _locpolyl1_batched_core(
            X, z, y, zgrid, jnp.asarray(kernel.h, X.dtype),
            jnp.asarray(lam0, X.dtype), key, degree, type(kernel), opts,
            refit, int(coarse_stride), int(grid_batch))
        if bool(all_cert):
            if stats is not None:
                stats.update(batched_certified=True,
                             stall_escaped_lanes=int(n_esc))
            return out, out_r
        warnings.warn(
            "locpolyl1(grid_batch=...): batched refinement did not "
            "certify every grid point; falling back to the sequential "
            "scan (consider a larger options.compact_size or a smaller "
            "grid_batch)", RuntimeWarning)
    if scan_chunk and L > scan_chunk:
        return _locpolyl1_scan_chunked(
            X, z, y, zgrid, jnp.asarray(kernel.h, X.dtype),
            jnp.asarray(lam0, X.dtype), key, degree, type(kernel), opts,
            refit, int(scan_chunk))
    out, out_r, _ = _locpolyl1_core(X, z, y, zgrid,
                                    jnp.asarray(kernel.h, X.dtype),
                                    jnp.asarray(lam0, X.dtype), key,
                                    degree, type(kernel), opts, refit)
    return out, out_r


def refit_locpolyl1(X, z, y, z0, degree: int, kernel: SmoothingKernel,
                    beta_e):
    """Unpenalized local-polynomial refit on the collapsed group support of
    ``beta_e`` (reference ``refit_locpolyl1``, :139-154).  Returns
    ``(beta_refit, support_mask)`` where ``beta_refit`` has
    ``|S|(degree+1)`` entries, matching the reference's view-based solve."""
    beta_np = np.asarray(beta_e)
    p = np.asarray(X).shape[1]
    S = np.any(beta_np.reshape(p, degree + 1) != 0, axis=1)
    Xs = jnp.asarray(np.asarray(X)[:, S])
    br = locpoly(Xs, z, y, jnp.asarray(z0), degree, kernel)
    return br, S


# ---------------------------------------------------------------------------
# Bandwidth selection (reference :82-137, :348-409)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit,
                   static_argnames=("degree", "opts", "kernel_type",
                                    "sigma_iters", "chunk"))
def _lvocv_locpolyl1_one_h(X, z, y, h, lam0, key, degree: int, kernel_type,
                           opts: CDOptions, sigma_iters: int = 10,
                           chunk: int = 64, points=None):
    """Sequential per-point LOO inner.  ``points=None`` sums the squared
    held-out errors over all n rows (the bandwidth's MSE numerator);
    an explicit index array instead returns the PER-POINT squared errors
    for exactly those rows — the strict-tolerance re-solve path for
    lanes the batched execution accepted via the stall escape."""
    n, p = X.shape
    ep = p * (degree + 1)
    kernel = kernel_type(h)
    s_screen = min(10, ep)

    def heldout(i, key):
        z0 = z[i]
        w = evaluate(kernel, z, z0)
        w = w.at[i].set(0.0)                       # leave one out (:108)
        eX = expand_X(X, z, z0, degree)
        stdX = std_X(eX, w)
        prob = build_blocked("wls", opts, stdX, X=eX, y=y, w=w)

        # screening init for σ (:109-117): weighted top-s OLS residuals
        c = jnp.abs(eX.T @ (w * y))
        _, idx = jax.lax.top_k(c, s_screen)
        Xs = jnp.take(eX, idx, axis=1)
        A = Xs.T @ (w[:, None] * Xs)
        b = Xs.T @ (w * y)
        r0 = y - Xs @ jnp.linalg.solve(A, b)
        sig = get_sigma(w, r0)

        beta_b0 = _to_blocked_beta(jnp.zeros((ep,), X.dtype),
                                   opts.block_size)

        # inner scaled-lasso-style σ loop, ≤ sigma_iters rounds, tol 1e-2
        # (:118-127); β warm-starts across rounds.
        def body(carry):
            beta_b, sig, it, done, key = carry
            key, k1 = jax.random.split(key)
            st = solve_blocked("wls", opts, prob, lam0 * sig, beta_b, k1)
            signew = get_sigma(w, st.r)
            done = jnp.abs(signew - sig) / sig < 1e-2
            sig = jnp.where(done, sig, signew)
            return (st.beta, sig, it + 1, done, key)

        def cond(carry):
            _, _, it, done, _ = carry
            return jnp.logical_and(~done, it < sigma_iters)

        beta_b, sig, _, _, key = lax.while_loop(
            cond, body, (beta_b0, sig, jnp.zeros((), jnp.int32),
                         jnp.zeros((), bool), key))
        beta = beta_b.reshape(-1)[:ep]

        # group-support weighted refit + prediction at the held-out row
        # (:130-134)
        mask = _group_mask_expanded(beta, p, degree)
        br = _masked_weighted_refit(eX, w, y, mask)
        yh = (eX[i] * mask) @ br
        return (yh - y[i]) ** 2

    pts = jnp.arange(n) if points is None else jnp.asarray(points,
                                                           jnp.int32)
    keys = jax.random.split(key, pts.shape[0])
    # chunked vmap (lax.map batches of `chunk` held-out points): a full
    # vmap materializes n expanded (n, ep) designs at once — O(n²·ep)
    # memory, which blows past HBM well before n=5000; chunking caps it
    # at O(chunk·n·ep) with identical results
    errs = lax.map(lambda ik: heldout(*ik), (pts, keys),
                   batch_size=min(chunk, int(pts.shape[0])))
    return jnp.sum(errs) if points is None else errs


@functools.partial(jax.jit, static_argnames=("degree", "kernel_type",
                                              "opts", "sigma_iters",
                                              "batch"))
def _lvocv_locpolyl1_one_h_batched(X, z, y, h, lam0, degree: int,
                                   kernel_type, opts: CDOptions,
                                   sigma_iters: int = 10,
                                   batch: int = 128):
    """Batched LOO-CV inner: every held-out point is a lane of the
    ``_VcBatchOps`` machinery (z0 = the held-out z with its own weight
    zeroed — exactly the reference's leave-one-out rule, :108), so the
    whole chunk shares each contraction instead of vmapping full solves.
    The per-point λ·σ fixed point (:118-127) batches too: thrw is
    per-lane, σ-converged lanes freeze, the loop runs until every lane's
    σ moved < 1e-2 rel (≤ ``sigma_iters`` rounds).  Returns
    ``(per-point squared errors (n,), all_cert, escaped mask (n,))``
    where the mask marks held-out lanes whose inner solve (any σ round)
    was accepted via the near-tol stall escape (always all-False at
    f64); the caller re-solves exactly those lanes sequentially."""
    from ..ops.block_cd import _PREC

    n, p = X.shape
    q1 = degree + 1
    ep = p * q1
    dt = X.dtype
    n_scale = jnp.asarray(n, dt)
    kernel = kernel_type(h)
    s_screen = min(10, ep)

    def chunk_stats(idx):
        k = idx.shape[0]
        z0 = z[idx]
        ops = _VcBatchOps(X, z, y, kernel, z0, degree, opts,
                          holdout=idx)
        w = ops.w

        # σ screening init (:109-117): weighted top-s OLS residuals,
        # batched — gathers are (k, n, s_screen) with s_screen ≤ 10
        U0 = (w * y[None, :])[:, :, None] * ops.dpow
        c = jnp.abs(jnp.einsum("knd,np->kpd", U0, X,
                               precision=_PREC).reshape(k, ep))
        _, sidx = lax.top_k(c, s_screen)                   # (k, s)
        jsel = sidx // q1
        dsel = sidx % q1
        Xg = jnp.take(X, jsel, axis=1).transpose(1, 0, 2)  # (k, n, s)
        dg = jnp.take_along_axis(
            ops.dpow, jnp.broadcast_to(dsel[:, None, :],
                                       (k, n, s_screen)), axis=2)
        Xs = Xg * dg
        A = jnp.einsum("kns,kn,knt->kst", Xs, w, Xs, precision=_PREC)
        A = A + 1e-12 * jnp.eye(s_screen, dtype=dt)[None]
        b = jnp.einsum("kns,kn->ks", Xs, w * y[None, :],
                       precision=_PREC)
        coef = jnp.linalg.solve(A, b[..., None])[..., 0]
        r0 = y[None, :] - jnp.einsum("kns,ks->kn", Xs, coef,
                                     precision=_PREC)
        wsum = jnp.maximum(jnp.sum(w, axis=1), 1e-30)
        sig = jnp.sqrt(jnp.einsum("kn,kn->k", w * r0, r0,
                                  precision=_PREC) / wsum)

        # batched λ·σ fixed point: converged lanes freeze
        def body(carry):
            B, sig, done, it, ok, esc = carry
            thrw = ops.lamw * (lam0 * n_scale) * sig[:, None]
            B, R, cert, esc_i = ops.solve(B, thrw, frozen=done)
            ok = ok & jnp.all(cert)
            esc = esc | esc_i
            signew = jnp.sqrt(jnp.einsum("kn,kn->k", w * R, R,
                                         precision=_PREC) / wsum)
            conv = jnp.abs(signew - sig) / jnp.maximum(sig, 1e-30) < 1e-2
            sig = jnp.where(done | conv, sig, signew)
            return (B, sig, done | conv, it + 1, ok, esc)

        def cond(carry):
            _, _, done, it, _, _ = carry
            return jnp.logical_and(~jnp.all(done), it < sigma_iters)

        B0 = jnp.zeros((k, ep), dt)
        B, sig, _, _, ok, esc = lax.while_loop(
            cond, body, (B0, sig, jnp.zeros((k,), bool),
                         jnp.zeros((), jnp.int32), jnp.ones((), bool),
                         jnp.zeros((k,), bool)))

        # group-support weighted refit + held-out prediction (:130-134);
        # the held-out row has (z_i − z0) = 0, so only its degree-0
        # entries predict: yh = Σ_j X[i,j]·(mask·br)[(j,0)]
        br, mask = _batched_masked_refit(X, y, w, ops.dpow, B)
        bm = (br * mask).reshape(k, p, q1)[:, :, 0]        # (k, p)
        yh = jnp.einsum("kp,kp->k", jnp.take(X, idx, axis=0), bm,
                        precision=_PREC)
        return (yh - y[idx]) ** 2, ok, esc

    k = min(batch, n)
    nchunks = -(-n // k)
    pad = nchunks * k - n
    # padded lanes repeat row 0; their errors/escapes are dropped below
    lanes = jnp.concatenate([jnp.arange(n),
                             jnp.zeros((pad,), jnp.int32)])
    if nchunks == 1:
        errs, oks, escs = chunk_stats(lanes)
        errs = errs[None]
        oks = oks[None]
        escs = escs[None]
    else:
        errs, oks, escs = lax.map(chunk_stats, lanes.reshape(nchunks, k))
    errs = errs.reshape(-1)[:n]
    escs = escs.reshape(-1)[:n]
    return errs, jnp.all(oks), escs


def lvocv_locpolyl1(X, z, y, degree: int, h_arr, kernel_type, lam0,
                    options: CDOptions = CDOptions(), *, seed: int = 0,
                    cv_batch: int | None = None,
                    stats: dict | None = None):
    """Leave-one-out CV for the bandwidth of ``locpolyl1``
    (reference ``lvocv_locpolyl1``, :82-137).  Returns the MSE per
    bandwidth.  Held-out points are vmapped; bandwidths loop on the host
    (the array is small).

    ``cv_batch > 0`` switches the inner per-bandwidth computation to the
    batched execution (``_lvocv_locpolyl1_one_h_batched``: every held-out
    point is a lane of shared stacked contractions, the per-point λ·σ
    fixed point batches with per-lane freezing).  Same
    certified-or-fallback contract as ``locpolyl1(grid_batch=…)`` — a
    bandwidth whose batched run fails to certify recomputes via the
    sequential per-point path (warning).  ``None`` auto-enables 128 lanes
    for sub-f64 dtypes off-CPU.

    ``stats``, if a dict, receives ``batched_certified`` (True iff every
    bandwidth's batched run certified) and ``stall_escaped_lanes`` (total
    held-out lanes accepted via the near-tol stall escape across the
    RETURNED batched bandwidths; 0 at f64 and for sequential runs)."""
    import warnings

    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    y = jnp.asarray(y, X.dtype)
    opts = options.replace(warm_start=True)
    key = jax.random.PRNGKey(seed)
    if cv_batch is None:
        cv_batch = auto_batch_lanes(X.dtype)
    mses = []
    all_cert = True
    n_resolved = 0
    for h in np.asarray(h_arr):
        hj = jnp.asarray(h, X.dtype)
        lj = jnp.asarray(lam0, X.dtype)
        done = False
        if cv_batch:
            errs, ok, esc = _lvocv_locpolyl1_one_h_batched(
                X, z, y, hj, lj, degree, kernel_type, opts,
                batch=int(cv_batch))
            done = bool(ok)
            if done:
                # escaped lanes are NOT accepted (an escape means the
                # batched inner stalled ≤4×tol, far from strict tol) —
                # re-solve exactly those held-out points via the strict-
                # tolerance sequential path and patch their errors
                esc_idx = np.nonzero(np.asarray(esc))[0]
                if esc_idx.size:
                    fixed = _lvocv_locpolyl1_one_h(
                        X, z, y, hj, lj, key, degree, kernel_type, opts,
                        points=jnp.asarray(esc_idx, jnp.int32))
                    errs = errs.at[jnp.asarray(esc_idx)].set(fixed)
                    n_resolved += int(esc_idx.size)
                mse = jnp.sum(errs)
            else:
                all_cert = False
                warnings.warn(
                    "lvocv_locpolyl1(cv_batch=...): batched LOO run for "
                    f"h={float(h):g} did not certify; recomputing via "
                    "the sequential per-point path", RuntimeWarning)
        if not done:
            mse = _lvocv_locpolyl1_one_h(
                X, z, y, hj, lj, key, degree, kernel_type, opts)
        mses.append(mse)
    if stats is not None:
        stats["batched_certified"] = bool(cv_batch) and all_cert
        # lanes accepted via the stall escape that REMAIN in the output:
        # always 0 now — every escaped lane is recomputed sequentially
        # (count reported separately for observability)
        stats["stall_escaped_lanes"] = 0
        stats["lanes_resolved_sequentially"] = n_resolved
    return jnp.stack(mses)


@functools.partial(jax.jit, static_argnames=("degree", "kernel_type",
                                             "chunk"))
def _lvocv_locpoly_one_h(X, z, y, h, degree: int, kernel_type,
                         chunk: int = 256):
    n = X.shape[0]
    ep1 = degree + 1
    kernel = kernel_type(h)

    def heldout(i):
        # weight-zeroing mask ≡ the reference's row views (:357-366):
        # a √w = 0 row contributes nothing to the LS fit.
        w = jnp.sqrt(evaluate(kernel, z, z[i]))
        w = w.at[i].set(0.0)
        wX = expand_wX(w, X, z, z[i], degree)
        coef, *_ = jnp.linalg.lstsq(wX, w * y)
        yh = X[i] @ coef[::ep1]                    # level coefficients
        return (yh - y[i]) ** 2

    # chunked for the same O(n²·ep) memory reason as _lvocv_locpolyl1_one_h
    return jnp.sum(lax.map(heldout, jnp.arange(n),
                           batch_size=min(chunk, n)))


def lvocv_locpoly(X, z, y, degree: int, h_arr, kernel_type):
    """Leave-one-out CV for the ``locpoly`` bandwidth
    (reference ``lvocv_locpoly``, :348-380)."""
    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    y = jnp.asarray(y, X.dtype)
    mses = [
        _lvocv_locpoly_one_h(X, z, y, jnp.asarray(h, X.dtype), degree,
                             kernel_type)
        for h in np.asarray(h_arr)
    ]
    return jnp.stack(mses)


def split_locpoly(X, z, y, X_test, z_test, y_test, zgrid, degree: int,
                  h_arr, kernel_type):
    """Train/test-split bandwidth scoring (reference ``split_locpoly``,
    :383-409): fit on the grid, interpolate β at each test z, score MSE.
    (The reference loops ``i = 1:size(X, 1)`` assuming equal train/test
    sizes; here the test size is used.)"""
    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    y = jnp.asarray(y, X.dtype)
    X_test = jnp.asarray(X_test, X.dtype)
    z_test = jnp.asarray(z_test, X.dtype)
    y_test = jnp.asarray(y_test, X.dtype)
    zgrid = jnp.asarray(zgrid, X.dtype)
    ep1 = degree + 1
    mses = []
    for h in np.asarray(h_arr):
        kernel = kernel_type(jnp.asarray(h, X.dtype))
        beta_grid = locpoly(X, z, y, zgrid, degree, kernel)

        def pred(xrow, z0):
            bi = get_beta(zgrid, beta_grid, z0)
            return xrow @ bi[::ep1]

        yh = jax.vmap(pred)(X_test, z_test)
        mses.append(jnp.sum((y_test - yh) ** 2))
    return jnp.stack(mses)


# ---------------------------------------------------------------------------
# Support / interpolation utilities (reference :237-255, :459-512)
# ---------------------------------------------------------------------------


def get_beta(zgrid, beta_grid, z0):
    """Linearly interpolate the β column between the two grid points
    bracketing ``z0`` (reference ``get_beta!``, :459-476).

    Deviation from the reference (SURVEY.md §7 "decide behavior, don't copy
    bugs"): the reference's interpolation weights are swapped
    (``α·β(z1) + (1−α)·β(z2)`` with ``α = (z0−z1)/(z2−z1)``), which is
    discontinuous at grid points and is on the untested-surface list; we use
    the standard ``(1−α)·β(z1) + α·β(z2)``.  Out-of-range ``z0`` clamps to
    the boundary column.
    """
    m = zgrid.shape[0]
    id2 = jnp.clip(jnp.searchsorted(zgrid, z0, side="left"), 0, m - 1)
    id1 = jnp.clip(jnp.searchsorted(zgrid, z0, side="right") - 1, 0, m - 1)
    z1 = zgrid[id1]
    z2 = zgrid[id2]
    denom = jnp.where(id1 == id2, 1.0, z2 - z1)
    alpha = jnp.clip((z0 - z1) / denom, 0.0, 1.0)
    return (1.0 - alpha) * beta_grid[:, id1] + alpha * beta_grid[:, id2]


def get_nonzero_coordinates(beta_e, p: int, degree: int, expanded: bool):
    """Group-collapsed support: feature j is active iff any of its
    (degree+1) polynomial coordinates is nonzero (reference
    ``get_nonzero_coordinates!``, :488-512)."""
    beta_e = jnp.asarray(beta_e)
    grp = jnp.any(beta_e.reshape(p, degree + 1) != 0, axis=1)
    if expanded:
        return jnp.repeat(grp, degree + 1)
    return grp


def sparse_coefficients(beta_grid, *, nse: int = None):
    """Sparse (BCOO) view of a dense ``(ep, m)`` coefficient grid.

    The reference returns ``locpolyl1``'s coefficient grids as
    ``SparseMatrixCSC`` (varying_coefficient_lasso.jl:47-48) because the
    per-grid-point support is tiny relative to ``ep``; this framework's
    solvers return dense arrays (static shapes are what XLA compiles), so
    the sparse representation is a boundary conversion instead — call this
    on ``locpolyl1``'s outputs when ``ep × m`` is too large to keep dense.
    ``nse`` optionally fixes the stored-element count (static shape; extra
    slots are padded) so the conversion itself can run under ``jit``.
    """
    from jax.experimental import sparse

    beta_grid = jnp.asarray(beta_grid)
    return sparse.BCOO.fromdense(beta_grid, nse=nse)


def get_residuals(X, z, y, zgrid, beta_grid, degree: int,
                  kernel: SmoothingKernel = None):
    """``ε̂_i = y_i − x_i' β̂(z_i)`` using grid interpolation of the level
    coefficients (reference ``getResiduals!``, :237-255; the kernel argument
    is unused there too)."""
    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    y = jnp.asarray(y, X.dtype)
    zgrid = jnp.asarray(zgrid, X.dtype)
    beta_grid = jnp.asarray(beta_grid, X.dtype)
    ep1 = degree + 1

    def resid(xrow, zi, yi):
        bi = get_beta(zgrid, beta_grid, zi)
        return yi - xrow @ bi[::ep1]

    return jax.vmap(resid)(X, z, y)


# ---------------------------------------------------------------------------
# Standard errors (reference :257-317)
# ---------------------------------------------------------------------------


def get_standard_error(X, z, sigma2, z0, degree: int,
                       kernel: SmoothingKernel):
    """Sandwich variance of the level (degree-0) coefficient per feature:
    ``σ² ⋅ diag_level[(X'WX)⁻¹ X'W²X (X'WX)⁻¹]``
    (reference ``getStandardError``, :257-286).

    Deviation: the reference accepts ``σ2`` but never multiplies by it
    (untested surface); we apply the intended ``σ²`` scaling.
    """
    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    p = X.shape[1]
    w = evaluate(kernel, z, z0)
    XtwX = expand_Xt_w_X(w, X, z, z0, degree)
    XtwwX = expand_Xt_w_X(w * w, X, z, z0, degree)
    A = jnp.linalg.inv(XtwX)
    var_mat = A @ XtwwX @ A
    idx = jnp.arange(p) * (degree + 1)
    return sigma2 * jnp.diagonal(var_mat)[idx]


def get_standard_error_hew(X, z, eps_sqr, z0, degree: int,
                           kernel: SmoothingKernel):
    """Heteroscedasticity-robust sandwich variance: middle matrix uses
    ``w² ε̂²`` (reference ``getStandardErrorHEW``, :288-317)."""
    X = jnp.asarray(X)
    z = jnp.asarray(z, X.dtype)
    eps_sqr = jnp.asarray(eps_sqr, X.dtype)
    p = X.shape[1]
    w = evaluate(kernel, z, z0)
    XtwX = expand_Xt_w_X(w, X, z, z0, degree)
    Xtw_psi_wX = expand_Xt_w_X(w * w * eps_sqr, X, z, z0, degree)
    A = jnp.linalg.inv(XtwX)
    var_mat = A @ Xtw_psi_wX @ A
    idx = jnp.arange(p) * (degree + 1)
    return jnp.diagonal(var_mat)[idx]
