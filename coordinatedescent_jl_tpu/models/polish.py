"""Active-set float64 polish: from an f32 solve to the 1e-7 duality gap.

The f32 engine certifies at its computational noise floor (rel gap
~1e-6); BASELINE.json's metric is time-to-**1e-7** gap.  SURVEY §7
hard-part (d) planned "float64 or compensated float32 accumulation" for
exactly this step.  ``polish_lasso`` closes the last decade this way:

1. the f32 solution's support (plus slack) becomes a static-size working
   set ``S``;
2. the restricted problem is solved by cyclic exact coordinate descent
   in TRUE f64 in RESIDUAL form on the gathered (n, C) columns — the
   reference's per-coordinate update (coordinate_descent.jl:94-110) with
   every contraction a true-f64 matrix-vector product (an f64 copy of the
   full design would double its memory, and the Gram-form build costs
   more than the rest of the polish — see ``_restricted_cd_resid_f64``);
3. one compensated full KKT sweep certifies ALL p coordinates — the
   hybrid ``grad_f64_certified`` (exact f64 on the near-max edge set,
   rigorously-bounded f32 elsewhere; exact for both certificate
   consumers, and cheaper than a full f64 sweep of the design);
   coordinates
   that violate join ``S`` and the loop repeats (classic active-set
   safeguard — same working-set-soundness argument as
   ``block_cd._compact_pass``: frozen coordinates are re-checked by the
   next full sweep);
4. done when the measurement-grade relative gap ≤ ``target_rel_gap``.

The returned β is float64.  Casting it back to f32 loses ~eps·|β_j| per
coordinate, which re-inflates the gap toward the f32 representation
floor — the polished certificate belongs to the f64 iterate, so keep it
f64 (it is tiny: one (p,) vector).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.compensated import (_require_x64, fenchel_gap_f64,
                               grad_f64_certified, residual_f64)

_PREC = lax.Precision.HIGHEST


class PolishResult(NamedTuple):
    beta: np.ndarray        # (p,) float64 polished coefficients
    gap: float              # absolute duality gap of beta
    rel_gap: float          # gap / primal
    primal: float
    rounds: int             # active-set rounds used
    support_size: int       # final working-set occupancy (nnz candidates)
    converged: bool         # rel_gap <= target


@functools.partial(jax.jit, static_argnames=("max_sweeps",))
def _restricted_cd_resid_f64(X, y, lamw, idx, lam_n, beta0, tol,
                             max_sweeps: int = 400):
    """Residual-form cyclic exact f64 coordinate descent on the gathered
    working set — the polish inner solver.

    Replaces the Gram-form path (gather + C serial f64 Gram matvecs +
    Gram CD): the Gram build dominated the polish, and an f32-fast Gram
    fails to certify (its ``m·eps32·(|A|'|A|)`` accumulation error
    exceeds the ~1e-3 absolute K-accuracy the 1e-7 gap needs).  Here
    every contraction is an f64 vector or matrix-vector product, so no
    accuracy is given up: per coordinate ``g_j = x_j'r`` is one f64 dot
    and the residual update one f64 axpy.
    One (n, C) gather serves the whole solve AND the exact final
    residual, which is returned alongside β (recomputed from scratch as
    ``y − X_S β`` so the certificate never sees incremental-update
    drift).  Padded slots (``idx == p`` → zero column + huge threshold)
    stay pinned at 0.  Returns ``(beta, r64, sweeps, maxh)``.
    """
    p = X.shape[1]
    Xs = jnp.take(X, idx, axis=1, mode="fill", fill_value=0)
    # column-major storage: each visit slices ONE column; on the (C, n)
    # transpose that is a contiguous leading-dim slice instead of a
    # strided lane gather of the f64 pair representation
    X64T = Xs.T.astype(jnp.float64)
    y64 = y.astype(jnp.float64)
    C = idx.shape[0]
    a = jnp.sum(X64T * X64T, axis=1)
    # magnitude guards stay within the FLOAT32 exponent range, so they
    # hold on backends that emulate f64 as a pair of f32 words
    a = jnp.maximum(a, jnp.asarray(1e-30, jnp.float64))
    thr = jnp.take(lamw, idx, mode="fill", fill_value=1e30)
    thr = jnp.where(idx < p, thr * lam_n, 1e30)

    def visit(carry, j):
        beta, r, mx = carry
        xj = lax.dynamic_slice_in_dim(X64T, j, 1, 0)[0]
        g = jnp.dot(xj, r, precision=_PREC)
        z = beta[j] + g / a[j]
        bn = jnp.sign(z) * jnp.maximum(jnp.abs(z) - thr[j] / a[j], 0.0)
        d = bn - beta[j]
        r = r - xj * d
        beta = beta.at[j].set(bn)
        return (beta, r, jnp.maximum(mx, jnp.abs(d))), None

    def sweep(state):
        beta, r, it, _ = state
        (beta, r, mx), _ = lax.scan(
            visit, (beta, r, jnp.zeros((), jnp.float64)), jnp.arange(C))
        return beta, r, it + 1, mx

    def cond(state):
        _, _, it, mx = state
        return jnp.logical_and(mx > tol, it < max_sweeps)

    r0 = y64 - jnp.dot(beta0, X64T, precision=_PREC)
    big = jnp.asarray(jnp.finfo(jnp.float64).max, jnp.float64)
    beta, _, it, mx = lax.while_loop(
        cond, sweep, (beta0, r0, jnp.zeros((), jnp.int32), big))
    # exact residual of the FINAL β (not the incrementally-updated one):
    # the certificate must evaluate a consistent (β, r) pair
    r64 = y64 - jnp.dot(beta, X64T, precision=_PREC)
    return beta, r64, it, mx


def polish_lasso(X, y, beta, lam0, weights=None, *,
                 target_rel_gap: float = 1e-7, max_rounds: int = 6,
                 support_cap: int = 4096,
                 col_chunk: int = 4096) -> PolishResult:
    """Refine an (f32) Lasso solution to ``rel gap ≤ target_rel_gap``.

    ``beta`` is the engine's solution at penalty level ``lam0`` (per-
    coordinate weights ``weights``, the reference's ``ProxL1(λ0, ω)``).
    Host-driven active-set loop; every numerical step is f64-accumulated
    (see module docstring).  Requires ``jax_enable_x64``.  If the support
    outgrows ``support_cap`` the loop stops early with
    ``converged=False`` — the gap of the best iterate is still reported
    honestly.
    """
    _require_x64("polish_lasso")
    X = jnp.asarray(X)
    n, p = X.shape
    y = jnp.asarray(y)
    lam0 = float(lam0)
    w_np = (np.ones((p,), np.float64) if weights is None
            else np.asarray(weights, np.float64))
    lamw = jnp.asarray(w_np)
    beta_np = np.asarray(beta, np.float64)
    yn = np.asarray(y, np.float64)
    y2 = float(yn @ yn)

    def host_gap(r_np, g_np, beta_full):
        # single-sourced certificate formula (ops.compensated)
        return fenchel_gap_f64(r_np, g_np, beta_full, lam0, w_np, n, yn,
                               y2=y2)

    sup = np.nonzero(beta_np)[0]
    # allocation: support + 25% slack rounded to a 128 multiple (the
    # inner solve is SERIAL in C, so a lean first allocation is ~2×
    # cheaper than the old 256-floor one; the loop re-grows on demand
    # and the certificate gates correctness)
    C = min(p, min(support_cap,
                   max(128, -(-int(1.25 * sup.size) // 128) * 128)))
    rounds = 0
    converged = False
    gap = rel = primal = float("nan")
    # 1e-10·scale start: the exact residual-form inner solve certifies
    # ~3 decades below the 1e-7 target from there (measured 5.5e-14 at
    # 1e-13); if a problem needs tighter, the no-new-candidates branch
    # below tightens ×10 and retries — certificate-gated, never trusted
    tol_inner = np.float64(
        1e-10 * max(1.0, float(np.max(np.abs(beta_np)) or 1.0)))
    while True:
        if sup.size > min(support_cap, p):
            # support exceeds the cap: certify the CURRENT iterate (one
            # oversized gather — host-driven, once) so the reported gap
            # is honest, then stop with converged=False
            r64 = residual_f64(X, y, jnp.asarray(sup),
                               jnp.asarray(beta_np[sup]))
            g_np = grad_f64_certified(X, r64, n * lam0 * w_np,
                                      col_chunk=min(col_chunk, p),
                                      as_numpy=True)
            gap, primal = host_gap(np.asarray(r64), g_np, beta_np)
            rel = gap / max(primal, 1e-300)
            break
        if sup.size > C:
            # re-grow the working-set allocation to the next 128 multiple.
            # NOTE the allocation is the cap ROUNDED UP to a 128 multiple
            # when support_cap is not one (≤127 extra gather slots); the
            # loop-top check still bounds the actual support by
            # support_cap exactly (ADVICE r4)
            C = min(p, -(-sup.size // 128) * 128)
        idx_np = np.full((C,), p, np.int64)
        idx_np[:sup.size] = sup
        beta_s0 = np.zeros((C,), np.float64)
        beta_s0[:sup.size] = beta_np[sup]
        idx = jnp.asarray(idx_np)
        beta_s, r64, _, _ = _restricted_cd_resid_f64(
            X, y, lamw, idx, jnp.asarray(n * lam0, jnp.float64),
            jnp.asarray(beta_s0), jnp.asarray(tol_inner))
        beta_s_np = np.asarray(beta_s)
        beta_np = np.zeros((p,), np.float64)
        beta_np[idx_np[idx_np < p]] = beta_s_np[idx_np < p]
        # compensated full certificate of the (β, exact r64) pair:
        # hybrid sweep, exact on the near-max edge set (see
        # grad_f64_certified — exact for BOTH consumers: the gap's ratio
        # max and the clipped violation ranking).  The finish runs on the
        # host from the (p,)-vector reads
        g_np = grad_f64_certified(X, r64, n * lam0 * w_np,
                                  col_chunk=min(col_chunk, p),
                                  as_numpy=True)
        gap, primal = host_gap(np.asarray(r64), g_np, beta_np)
        viol = np.maximum(np.abs(g_np) / n - lam0 * w_np, 0.0)
        viol[idx_np[idx_np < p]] = 0.0
        nz = np.nonzero(viol > 0)[0]
        extra_ranked = nz[np.argsort(-viol[nz])]
        rel = gap / max(primal, 1e-300)
        rounds += 1
        if rel <= target_rel_gap:
            converged = True
            break
        if rounds >= max_rounds:
            break
        # augment: support + the strongest off-set violations.  The
        # working set may GROW past its current allocation (the loop
        # top re-sizes C): room is bounded by support_cap, and per-round
        # additions by max(256, C) so one loose coarse solve cannot
        # force a single enormous gather — growth is geometric instead
        sup_now = np.nonzero(beta_np)[0]
        room = max(0, min(support_cap, p) - sup_now.size)
        extra = extra_ranked[: min(room, max(256, C))]
        new_sup = np.union1d(sup_now, extra)
        if new_sup.size == sup.size and np.array_equal(new_sup, sup):
            # no new candidates and gap still above target: the residual
            # decade must come from more inner sweeps — tighten and retry
            tol_inner = tol_inner / 10.0
        sup = new_sup

    return PolishResult(beta=beta_np, gap=float(gap), rel_gap=float(rel),
                        primal=float(primal), rounds=rounds,
                        support_size=int(sup.size), converged=converged)


# ---------------------------------------------------------------------------
# Sqrt-lasso polish (the 1e-7 certification tier for the sqrt loss)
# ---------------------------------------------------------------------------


class SqrtPolishResult(NamedTuple):
    beta: np.ndarray        # (p,) float64 polished coefficients
    kkt_rel: float          # compensated per-coordinate relative KKT
    norm_r: float           # ‖y − Xβ‖₂ of the polished iterate
    rounds: int
    support_size: int
    converged: bool         # kkt_rel <= target


@functools.partial(jax.jit, static_argnames=("max_sweeps",))
def _restricted_cd_sqrt_f64(X, y, lamw, idx, lam0, beta0, tol,
                            max_sweeps: int = 400):
    """Residual-form f64 sqrt-lasso CD on the gathered working set with
    the reference's exact three-branch minimizer
    (cd_differentiable_function.jl:242-291 — same formulas as the f32
    engine's ``block_cd._sqrt_candidate``, scalar per-coordinate here).
    Objective ``‖y − Xβ‖₂ + λ Σ ω_j |β_j|`` (the engine's plain-‖r‖
    normalization).  Same matvec-exact-class structure and padded-slot
    convention as ``_restricted_cd_resid_f64``; ``‖r‖²`` is carried
    incrementally through the three-branch update and refreshed exactly
    at every sweep start.  Returns ``(beta, r64, sweeps, maxh)``."""
    p = X.shape[1]
    Xs = jnp.take(X, idx, axis=1, mode="fill", fill_value=0)
    X64T = Xs.T.astype(jnp.float64)
    y64 = y.astype(jnp.float64)
    C = idx.shape[0]
    a = jnp.sum(X64T * X64T, axis=1)
    a = jnp.maximum(a, jnp.asarray(1e-30, jnp.float64))
    lamw_s = jnp.take(lamw, idx, mode="fill", fill_value=1e30)
    lamw_s = jnp.where(idx < p, lamw_s, 1e30)
    lam = lam0 * lamw_s

    def visit(carry, j):
        beta, r, rsqr, mx = carry
        xj = lax.dynamic_slice_in_dim(X64T, j, 1, 0)[0]
        c = jnp.dot(xj, r, precision=_PREC)
        bj, aj, lj = beta[j], a[j], lam[j]
        s = c + aj * bj
        rsb = jnp.maximum(rsqr + 2.0 * bj * c + bj * bj * aj, 0.0)
        ok = lj * lj < aj
        den = jnp.sqrt(jnp.where(ok, 1.0 - lj * lj / aj, 1.0))
        inner = jnp.sqrt(jnp.maximum(rsb - s * s / aj, 0.0))
        mag = (jnp.abs(s) - lj / den * inner) / aj
        nz = ok & (jnp.abs(s) > lj * jnp.sqrt(rsb))
        val = jnp.where(nz, jnp.sign(s) * mag, 0.0)
        d = val - bj
        r = r - xj * d
        rsqr = jnp.maximum(rsb - 2.0 * val * s + val * val * aj, 0.0)
        beta = beta.at[j].set(val)
        return (beta, r, rsqr, jnp.maximum(mx, jnp.abs(d))), None

    def sweep(state):
        beta, r, it, _ = state
        rsqr = jnp.dot(r, r, precision=_PREC)    # exact refresh per sweep
        (beta, r, _, mx), _ = lax.scan(
            visit, (beta, r, rsqr, jnp.zeros((), jnp.float64)),
            jnp.arange(C))
        return beta, r, it + 1, mx

    def cond(state):
        _, _, it, mx = state
        return jnp.logical_and(mx > tol, it < max_sweeps)

    r0 = y64 - jnp.dot(beta0, X64T, precision=_PREC)
    big = jnp.asarray(jnp.finfo(jnp.float64).max, jnp.float64)
    beta, _, it, mx = lax.while_loop(
        cond, sweep, (beta0, r0, jnp.zeros((), jnp.int32), big))
    r64 = y64 - jnp.dot(beta, X64T, precision=_PREC)
    return beta, r64, it, mx


def polish_sqrt_lasso(X, y, beta, lam0, weights=None, *,
                      target_kkt_rel: float = 1e-7, max_rounds: int = 6,
                      support_cap: int = 4096,
                      col_chunk: int = 4096) -> SqrtPolishResult:
    """Refine an (f32) sqrt-lasso solution to a compensated relative KKT
    residual ≤ ``target_kkt_rel`` (the sqrt-lasso analogue of
    ``polish_lasso``; certificate = ``sqrt_lasso_kkt_compensated``'s
    per-coordinate relative roll-up, reference zero rule
    cd_differentiable_function.jl:277-283).  Host-driven active-set loop
    with the exact three-branch f64 inner solver; honesty is external —
    the hybrid certified sweep measures against the real X every round.
    Requires ``jax_enable_x64``."""
    _require_x64("polish_sqrt_lasso")
    X = jnp.asarray(X)
    n, p = X.shape
    y = jnp.asarray(y)
    lam0 = float(lam0)
    w_np = (np.ones((p,), np.float64) if weights is None
            else np.asarray(weights, np.float64))
    lamw = jnp.asarray(w_np)
    beta_np = np.asarray(beta, np.float64)

    sup = np.nonzero(beta_np)[0]
    C = min(p, min(support_cap,
                   max(128, -(-int(1.25 * sup.size) // 128) * 128)))
    rounds = 0
    converged = False
    kkt = rn = float("nan")
    tol_inner = np.float64(
        1e-10 * max(1.0, float(np.max(np.abs(beta_np)) or 1.0)))
    while True:
        if sup.size > min(support_cap, p):
            r64, sup_now = _support_residual_np(X, y, beta_np)
            kkt, rn = _sqrt_cert(X, r64, beta_np, lam0, w_np, sup_now,
                                 col_chunk)
            break
        if sup.size > C:
            C = min(p, -(-sup.size // 128) * 128)
        idx_np = np.full((C,), p, np.int64)
        idx_np[:sup.size] = sup
        beta_s0 = np.zeros((C,), np.float64)
        beta_s0[:sup.size] = beta_np[sup]
        beta_s, r64, _, _ = _restricted_cd_sqrt_f64(
            X, y, lamw, idx_np, jnp.asarray(lam0, jnp.float64),
            jnp.asarray(beta_s0), jnp.asarray(tol_inner))
        beta_s_np = np.asarray(beta_s)
        beta_np = np.zeros((p,), np.float64)
        beta_np[idx_np[idx_np < p]] = beta_s_np[idx_np < p]
        sup_now = np.nonzero(beta_np)[0]
        kkt, rn, g_np, t = _sqrt_cert(X, r64, beta_np, lam0, w_np,
                                      sup_now, col_chunk, pieces=True)
        rounds += 1
        if kkt <= target_kkt_rel:
            converged = True
            break
        if rounds >= max_rounds:
            break
        viol = np.maximum(np.abs(g_np) - t, 0.0) / t
        viol[idx_np[idx_np < p]] = 0.0
        extra = np.nonzero(viol > 0)[0]
        room = max(0, min(support_cap, p) - sup_now.size)
        extra = extra[np.argsort(-viol[extra])][: min(room, max(256, C))]
        new_sup = np.union1d(sup_now, extra)
        if new_sup.size == sup.size and np.array_equal(new_sup, sup):
            tol_inner = tol_inner / 10.0
        sup = new_sup

    return SqrtPolishResult(beta=beta_np, kkt_rel=float(kkt),
                            norm_r=float(rn), rounds=rounds,
                            support_size=int(sup.size),
                            converged=converged)


def _sqrt_cert(X, r64, beta_np, lam0, w_np, sup, col_chunk,
               pieces: bool = False):
    """Compensated sqrt-KKT certificate of a (β, exact r64) pair — the
    shared finish of ``polish_sqrt_lasso``'s round and cap-exceeded
    paths (same formulas as ``sqrt_lasso_kkt_compensated``)."""
    from ..ops.compensated import _sqrt_kkt_rel_from_grad
    p = X.shape[1]
    r_np = np.asarray(r64)
    rn = float(np.sqrt(r_np @ r_np))
    t = np.maximum(lam0 * rn * w_np, 1e-300)
    g_np = grad_f64_certified(X, r64, t, col_chunk=min(col_chunk, p),
                              force=sup, as_numpy=True)
    kkt = _sqrt_kkt_rel_from_grad(g_np, t, sup, beta_np)
    if pieces:
        return kkt, rn, g_np, t
    return kkt, rn


def _support_residual_np(X, y, beta_np):
    """Exact f64 residual of a sparse β (compensated._support_residual
    re-exported under the polish namespace for the cap-exceeded paths)."""
    from ..ops.compensated import _support_residual
    return _support_residual(X, y, beta_np)


# ---------------------------------------------------------------------------
# Scaled-lasso polish: f64 (β, σ) fixed point via repeated lasso polish
# ---------------------------------------------------------------------------


class ScaledPolishResult(NamedTuple):
    beta: np.ndarray
    sigma: float            # ‖r‖/√n of the final polished iterate
    gap: float              # duality gap of the final λ·σ lasso subproblem
    rel_gap: float
    primal: float
    rounds: int             # total inner polish rounds
    sigma_rounds: int
    sigma_rel_change: float  # |σ_new − σ_used| / σ_used at the last round
    converged: bool         # rel_gap ≤ target AND σ consistent


def polish_scaled_lasso(X, y, beta, lam, weights=None, *,
                        target_rel_gap: float = 1e-7,
                        sigma_rtol: float = 1e-7,
                        max_sigma_rounds: int = 12,
                        **polish_kw) -> ScaledPolishResult:
    """Polish a scaled-lasso solution to the f64 (β, σ) fixed point:
    β optimal (rel gap ≤ target) for the Lasso at λ·σ, σ = ‖y−Xβ‖/√n
    (reference ``scaledLasso!`` alternation, lasso.jl:107-144, with the
    certification tier's accuracy).  Each σ round is one warm
    ``polish_lasso`` call at the current λ·σ; convergence requires BOTH
    the subproblem certificate and σ self-consistency (``sigma_rtol``).
    Requires ``jax_enable_x64``."""
    _require_x64("polish_scaled_lasso")
    X = jnp.asarray(X)
    n = X.shape[0]
    beta_np = np.asarray(beta, np.float64)
    lam = float(lam)
    r64, _ = _support_residual_np(X, y, beta_np)
    r_np = np.asarray(r64)
    sig = float(np.sqrt(r_np @ r_np / n))
    rounds = 0
    res = None
    rel_change = float("nan")
    converged = False
    for sr in range(max_sigma_rounds):
        res = polish_lasso(X, y, beta_np, lam * sig, weights,
                           target_rel_gap=target_rel_gap, **polish_kw)
        beta_np = res.beta
        rounds += res.rounds
        r64, _ = _support_residual_np(X, y, beta_np)
        r_np = np.asarray(r64)
        signew = float(np.sqrt(r_np @ r_np / n))
        h = signew - sig
        rel_change = abs(h) / max(sig, 1e-300)
        if res.converged and rel_change <= sigma_rtol:
            sig = signew
            converged = True
            break
        # restricted (β_S, σ) fixed point: with β's support settled the
        # off-support coordinates are zero, so the gathered residual IS
        # the full residual and the σ alternation can run entirely on
        # the working set — one (n, C) gather + f64 CD per inner round,
        # no full-X sweep.  A scalar secant on h(σ) = ‖r(β(λσ))‖/√n − σ
        # collapses the linearly-convergent alternation; the NEXT
        # certifying polish above validates the off-set KKT at the final
        # σ, so convergence stays certificate-gated
        p_ = X.shape[1]
        sup = np.nonzero(beta_np)[0]
        C = min(p_, max(128,
                        -(-int(1.25 * max(sup.size, 1)) // 128) * 128))
        if sup.size and sup.size <= C:
            idx_np = np.full((C,), p_, np.int64)
            idx_np[:sup.size] = sup
            idx = jnp.asarray(idx_np)
            w_np = (np.ones((p_,), np.float64) if weights is None
                    else np.asarray(weights, np.float64))
            lamw = jnp.asarray(w_np)
            tol_in = np.float64(
                1e-10 * max(1.0, float(np.max(np.abs(beta_np)) or 1.0)))
            beta_s0 = np.zeros((C,), np.float64)
            beta_s0[:sup.size] = beta_np[sup]
            sp = hp = None
            sig_i = signew
            for _ in range(40):
                beta_s, r64, _, _ = _restricted_cd_resid_f64(
                    X, y, lamw, idx,
                    jnp.asarray(n * lam * sig_i, jnp.float64),
                    jnp.asarray(beta_s0), jnp.asarray(tol_in))
                beta_s0 = np.asarray(beta_s)
                r_np = np.asarray(r64)
                so = float(np.sqrt(r_np @ r_np / n))
                hi = so - sig_i
                if abs(hi) / max(sig_i, 1e-300) <= 0.1 * sigma_rtol:
                    sig_i = so
                    break
                if hp is not None and hi != hp:
                    nxt = sig_i - hi * (sig_i - sp) / (hi - hp)
                    if not np.isfinite(nxt) or nxt <= 0:
                        nxt = so
                else:
                    nxt = so
                sp, hp = sig_i, hi
                sig_i = nxt
            beta_np = np.zeros((p_,), np.float64)
            beta_np[idx_np[idx_np < p_]] = beta_s0[idx_np < p_]
            sig = sig_i
        else:
            sig = signew
    return ScaledPolishResult(
        beta=beta_np, sigma=sig, gap=res.gap, rel_gap=res.rel_gap,
        primal=res.primal, rounds=rounds, sigma_rounds=sr + 1,
        sigma_rel_change=rel_change, converged=converged)


# ---------------------------------------------------------------------------
# Feasible-lasso polish: f64 (β, Γ) loading fixed point
# ---------------------------------------------------------------------------


class FeasiblePolishResult(NamedTuple):
    beta: np.ndarray
    loadings: np.ndarray     # (p,) f64 penalty loadings of the fixed point
    gap: float
    rel_gap: float
    primal: float
    rounds: int
    loading_rounds: int
    loading_rel_change: float
    converged: bool


@jax.jit
def _ws_loadings(X, idx, r64):
    """Working-set heteroscedastic loadings ``sqrt(mean((X_ij r_i)²))``
    over the gathered columns only — the cheap per-round update of the
    restricted (β_S, Γ_S) fixed-point loop (full-p loadings cost a whole
    f64 design sweep; on-set ones cost one (n, C) gather)."""
    n = X.shape[0]
    Xs = jnp.take(X, idx, axis=1, mode="fill", fill_value=0)
    X64 = Xs.astype(jnp.float64)
    return jnp.sqrt(jnp.einsum("nj,n->j", X64 * X64, r64 * r64,
                               precision=_PREC,
                               preferred_element_type=jnp.float64) / n)


def polish_feasible_lasso(X, y, beta, lam0, *,
                          target_rel_gap: float = 1e-7,
                          gamma_rtol: float = 1e-7,
                          max_loading_rounds: int = 12,
                          col_chunk: int = 2048,
                          **polish_kw) -> FeasiblePolishResult:
    """Polish a feasible (heteroscedastic) Lasso solution to the f64
    (β, Γ) fixed point: β optimal (rel gap ≤ target) for the weighted
    Lasso at (λ0, Γ), Γ_j = sqrt(mean((X_ij r_i)²)) recomputed from β's
    exact residual (reference ``feasibleLasso!`` loading rounds,
    lasso.jl:154-194, at certification accuracy — loadings via the f64
    ``loadings_f64`` sweep).  Convergence requires the subproblem
    certificate AND the reference's loading-stability rule
    ``max|ΔΓ|/maxΓ ≤ gamma_rtol``.  Requires ``jax_enable_x64``."""
    from ..ops.compensated import loadings_f64
    _require_x64("polish_feasible_lasso")
    X = jnp.asarray(X)
    beta_np = np.asarray(beta, np.float64)
    lam0 = float(lam0)
    r64, _ = _support_residual_np(X, y, beta_np)
    gam = np.asarray(loadings_f64(X, r64, col_chunk=col_chunk))
    n, p = X.shape
    rounds = 0
    res = None
    rel_change = float("nan")
    converged = False
    for lr in range(max_loading_rounds):
        res = polish_lasso(X, y, beta_np, lam0, gam,
                           target_rel_gap=target_rel_gap, **polish_kw)
        beta_np = res.beta
        rounds += res.rounds
        r64, _ = _support_residual_np(X, y, beta_np)
        gam_new = np.asarray(loadings_f64(X, r64, col_chunk=col_chunk))
        rel_change = float(np.max(np.abs(gam_new - gam))
                           / max(float(np.max(gam_new)), 1e-300))
        if res.converged and rel_change <= gamma_rtol:
            gam = gam_new
            converged = True
            break
        gam = gam_new
        # restricted (β_S, Γ_S) fixed point: with the support settled,
        # every full round only nudges the on-set loadings (the plain
        # alternation contracts at a measured ~0.5-0.8/round with
        # oscillating modes — Aitken barely helped).  The joint limit is
        # reached CHEAPLY by iterating the gathered subproblem — one
        # (n, C) gather + f64 CD per inner round, no full-X sweep — and
        # the NEXT certifying round above validates the off-set KKT at
        # the final loadings; convergence stays certificate-gated
        sup = np.nonzero(beta_np)[0]
        C = min(p, max(128, -(-int(1.25 * max(sup.size, 1)) // 128) * 128))
        if sup.size and sup.size <= C:
            idx_np = np.full((C,), p, np.int64)
            idx_np[:sup.size] = sup
            idx = jnp.asarray(idx_np)
            lamw_full = np.array(gam, np.float64)  # writable copy
            tol_in = np.float64(
                1e-10 * max(1.0, float(np.max(np.abs(beta_np)) or 1.0)))
            beta_s0 = np.zeros((C,), np.float64)
            beta_s0[:sup.size] = beta_np[sup]
            gmax = max(float(np.max(gam)), 1e-300)
            for _ in range(40):
                beta_s, r64, _, _ = _restricted_cd_resid_f64(
                    X, y, jnp.asarray(lamw_full), idx,
                    jnp.asarray(n * lam0, jnp.float64),
                    jnp.asarray(beta_s0), jnp.asarray(tol_in))
                gS = np.asarray(_ws_loadings(X, idx, r64))[:sup.size]
                dS = float(np.max(np.abs(gS - lamw_full[sup]))) / gmax
                lamw_full[sup] = gS
                beta_s0 = np.asarray(beta_s)
                if dS <= 0.1 * gamma_rtol:
                    break
            beta_np = np.zeros((p,), np.float64)
            beta_np[idx_np[idx_np < p]] = beta_s0[idx_np < p]
            gam = lamw_full
    return FeasiblePolishResult(
        beta=beta_np, loadings=gam, gap=res.gap, rel_gap=res.rel_gap,
        primal=res.primal, rounds=rounds, loading_rounds=lr + 1,
        loading_rel_change=rel_change, converged=converged)


# ---------------------------------------------------------------------------
# Group-lasso polish: f64 restricted block-CD over support groups
# ---------------------------------------------------------------------------


class GroupPolishResult(NamedTuple):
    beta: np.ndarray
    kkt_rel: float          # compensated per-group relative KKT
    rounds: int
    support_groups: int
    converged: bool


@jax.jit
def _gather_gram_f64(X, y, idx):
    """Exact f64 working-set Gram ``K = X_S'X_S`` and ``c = X_S'y``,
    assembled COLUMN-BY-COLUMN as matvecs, so every entry is a true f64
    dot product on any backend (an f64 matrix-matrix product can be
    decomposed into reduced-precision passes where f64 is emulated).
    Used by the group polisher, whose host
    block-CD consumes the whole (C, C) Gram (the group subproblem solve
    needs cross-group columns every sweep, unlike the vector case where
    the residual form avoids the build entirely)."""
    C = idx.shape[0]
    Xs = jnp.take(X, idx, axis=1, mode="fill", fill_value=0)

    def col(k):
        xk = jnp.take(Xs, k, axis=1)
        return jnp.einsum("nj,n->j", Xs, xk, precision=_PREC,
                          preferred_element_type=jnp.float64)

    Ks = lax.map(col, jnp.arange(C))          # symmetric: order-free
    cs = jnp.einsum("nj,n->j", Xs, y, precision=_PREC,
                    preferred_element_type=jnp.float64)
    return Ks, cs


def _group_subproblem(Kgg, ct, t, b0):
    """Exact f64 solve of ``min ½ b'K b − c̃'b + t‖b‖₂`` (host NumPy).

    Zero rule ``‖c̃‖ ≤ t``; otherwise the stationarity condition is
    ``(K + (t/s) I) b = c̃`` with ``s = ‖b‖``, i.e. in K's eigenbasis
    (``q = V'c̃``) the scalar root of the strictly decreasing
    ``ψ(s) = Σ q_i²/(λ_i s + t)² − 1`` (ψ(0) = ‖c̃‖²/t² − 1 > 0).
    Safeguarded Newton in f64 — exact to machine precision, unlike the
    f32 engine's FISTA/MM inner solves (which are certified externally).
    """
    cn = float(np.linalg.norm(ct))
    if cn <= t:
        return np.zeros_like(b0)
    lam_e, V = np.linalg.eigh(Kgg)
    lam_e = np.maximum(lam_e, 0.0)
    q2 = (V.T @ ct) ** 2
    # bracket: ψ decreasing; s_hi from the smallest eigenvalue bound
    s = max(float(np.linalg.norm(b0)), (cn - t) / max(lam_e[-1], 1e-30))
    lo, hi = 0.0, (cn - t) / max(lam_e[0], 1e-30) if lam_e[0] > 0 else None
    if hi is None:
        # singular K_gg along some direction: ψ(s) → (q_null/t)² > 0 for
        # any s if c̃ has null-space mass — cap the bracket generously
        hi = max(s, 1.0) * 1e6
    s = min(max(s, 1e-12), hi)
    for _ in range(100):
        d = lam_e * s + t
        psi = float(np.sum(q2 / (d * d))) - 1.0
        if abs(psi) < 1e-15:
            break
        if psi > 0:
            lo = s
        else:
            hi = s
        dpsi = float(np.sum(-2.0 * lam_e * q2 / (d * d * d)))
        step = s - psi / dpsi if dpsi != 0 else 0.5 * (lo + hi)
        s = step if lo < step < hi else 0.5 * (lo + hi)
    return V @ ((V.T @ ct) / (lam_e + t / s))


def _group_bcd_host(K, c, t_sel, G, b0, tol, max_sweeps=400):
    """Cyclic exact block CD on the gathered f64 Gram (host NumPy):
    group g's subproblem gradient is ``c̃_g = c_g − (Kβ)_g + K_gg β_g``;
    each visit solves it exactly (``_group_subproblem``).  ``t_sel`` is
    the per-selected-group threshold vector; groups are consecutive
    G-blocks of the gathered set.  Runs to the reference maxH rule."""
    ngs = t_sel.size
    beta = b0.copy()
    kb = K @ beta
    for _ in range(max_sweeps):
        mx = 0.0
        for gi in range(ngs):
            sl = slice(gi * G, (gi + 1) * G)
            Kgg = K[sl, sl]
            ct = c[sl] - kb[sl] + Kgg @ beta[sl]
            bnew = _group_subproblem(Kgg, ct, t_sel[gi], beta[sl])
            d = bnew - beta[sl]
            md = float(np.max(np.abs(d)))
            if md > 0:
                kb = kb + K[:, sl] @ d
                beta[sl] = bnew
                mx = max(mx, md)
        if mx < tol:
            break
    return beta


def polish_group_lasso(X, y, beta, lam0, group_size: int, weights=None, *,
                       target_kkt_rel: float = 1e-7, max_rounds: int = 6,
                       group_cap: int = 512,
                       col_chunk: int = 4096) -> GroupPolishResult:
    """Refine an (f32) group-lasso solution to a compensated per-group
    relative KKT residual ≤ ``target_kkt_rel`` (objective
    ``‖y−Xβ‖²/(2n) + λ Σ_g ω_g ‖β_g‖₂``, reference ``AtomIterate`` prox
    semantics).  Active-set loop over GROUPS: the selected groups'
    columns are gathered, their exact f64 Gram built on-device
    (``_gather_gram_f64``), and the restricted block-CD runs in host
    NumPy f64 with exact per-group subproblem solves
    (``_group_subproblem``) — the Gram is small (≤ group_cap·G wide) so
    the host solve is microseconds while every contraction that touches
    X stays on-device.  Certification: the hybrid per-group roll-up
    (``ops.compensated._group_kkt_pieces``) against the real X.
    Requires ``jax_enable_x64``."""
    from ..ops.compensated import _group_kkt_pieces
    _require_x64("polish_group_lasso")
    X = jnp.asarray(X)
    n, p = X.shape
    y = jnp.asarray(y)
    G = int(group_size)
    ng = -(-p // G)
    lam0 = float(lam0)
    w_np = (np.ones((ng,), np.float64) if weights is None
            else np.asarray(weights, np.float64))
    t = np.maximum(n * lam0 * w_np, 1e-300)
    beta_np = np.asarray(beta, np.float64)
    gidx = np.arange(p) // G

    selg = np.unique(gidx[beta_np != 0])
    rounds = 0
    converged = False
    kkt = float("nan")
    tol_inner = np.float64(
        1e-11 * max(1.0, float(np.max(np.abs(beta_np)) or 1.0)))
    while True:
        if selg.size > group_cap:
            kkt, _, _ = _group_kkt_pieces(X, y, beta_np, t, G,
                                          col_chunk=col_chunk)
            break
        if selg.size:
            # gathered set: the selected groups' columns, padded to a
            # whole number of groups so host block slices stay aligned
            cols = (selg[:, None] * G + np.arange(G)[None, :]).reshape(-1)
            cols = np.where(cols < p, cols, p)    # ragged tail group
            idx_np = cols.astype(np.int64)
            Ks, cs = _gather_gram_f64(X, y, jnp.asarray(idx_np))
            K_np = np.asarray(Ks)
            c_np = np.asarray(cs)
            b0 = beta_np[np.minimum(idx_np, p - 1)] * (idx_np < p)
            beta_sel = _group_bcd_host(K_np, c_np, t[selg], G, b0,
                                       float(tol_inner))
            beta_np = np.zeros((p,), np.float64)
            ok = idx_np < p
            beta_np[idx_np[ok]] = beta_sel[ok]
        # selg empty (cold start / λ ≥ λmax): certify β = 0 directly —
        # the roll-up below seeds the first working set
        kkt, off_excess, _ = _group_kkt_pieces(X, y, beta_np, t, G,
                                               col_chunk=col_chunk)
        rounds += 1
        if kkt <= target_kkt_rel:
            converged = True
            break
        if rounds >= max_rounds:
            break
        viol = off_excess.copy()
        viol[selg] = 0.0
        extra = np.nonzero(viol > 0)[0]
        room = max(0, group_cap - selg.size)
        extra = extra[np.argsort(-viol[extra])][: min(room, 64)]
        sel_now = np.unique(gidx[beta_np != 0])
        new_selg = np.union1d(np.union1d(sel_now, selg), extra)
        if new_selg.size == selg.size and np.array_equal(new_selg, selg):
            tol_inner = tol_inner / 10.0
        selg = new_selg

    return GroupPolishResult(beta=beta_np, kkt_rel=float(kkt),
                             rounds=rounds, support_groups=int(selg.size),
                             converged=converged)
