"""Compensated (float64-accumulated) certification.

SURVEY §7 hard-part (d): the BASELINE metric is time-to-1e-7 duality gap,
but f32 contractions measure the gap with ~1e-7 relative error themselves
(a plain HIGHEST-precision f32 ``X'r`` GEMV at n=10K carries ~1e-7
relative error — exactly the target scale), so both the certificate and
the solve floor were accumulation-bound.  This module provides
measurement-grade f64 building blocks that never materialize an f64 copy
of the full design (a 10K×100K design is 4 GB in f32, 8 GB in f64):

- ``grad_f64``      — ``X'r`` with true f64 accumulation, column-chunked
  under ``lax.map`` so the 8× emulation blowup applies to one (n, chunk)
  slice at a time (measured: 3.7e-15 relative error, 0.63 s at 10K×100K).
- ``residual_f64``  — exact f64 residual of a sparse β via a gathered
  support block (the only place the design enters is the (n, C) gather).
- ``lasso_duality_gap_compensated`` — host-driven measurement-grade
  Fenchel gap built from the two pieces; every scalar finishes in f64.

These functions require ``jax.config.jax_enable_x64`` (the f64 word type
must exist); they raise a clear error otherwise.  The solve-side consumer
is ``models.polish.polish_lasso`` — the active-set f64 refinement that
actually reaches the 1e-7 gap from an f32 solution.

Reference anchor: the criterion being exceeded is the reference's own
``optTol=1e-7`` coordinate-change rule (``src/utils.jl:17``,
``src/coordinate_descent.jl:83-89``) — our gap certificate is strictly
stronger (SURVEY §5.5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_PREC = lax.Precision.HIGHEST


def _require_x64(what: str) -> None:
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            f"{what} needs float64 scalars: wrap the call in "
            "`with jax.enable_x64(True):` (scoped — preferred; a global "
            "`jax.config.update('jax_enable_x64', True)` also works but "
            "flips index dtypes for every other program in the process). "
            "f32 inputs stay f32 — only the accumulators and the "
            "certificate arithmetic are widened")


@functools.partial(jax.jit, static_argnames=("col_chunk",))
def grad_f64(X, r64, col_chunk: int = 4096):
    """``X' r`` with genuine f64 accumulation, column-chunked.

    ``X`` stays f32 (exact inputs); each ``lax.map`` step upcasts ONE
    (n, col_chunk) slice inside the f64-emulated einsum, so peak extra
    memory is the emulation's multi-word copy of a single chunk instead
    of the whole design.  Returns f64 ``(p,)``.
    """
    n, p = X.shape
    pc = min(col_chunk, p)
    ncol = -(-p // pc)
    # pad to whole chunks: dynamic_slice clamps at the array edge, which
    # would make a ragged final chunk silently re-read earlier columns
    if ncol * pc != p:
        X = jnp.pad(X, ((0, 0), (0, ncol * pc - p)))

    def one(c):
        Xc = lax.dynamic_slice_in_dim(X, c * pc, pc, 1)
        return jnp.einsum("nj,n->j", Xc, r64, precision=_PREC,
                          preferred_element_type=jnp.float64)

    return lax.map(one, jnp.arange(ncol)).reshape(-1)[:p]


@jax.jit
def _grad32_and_mag(X, r32):
    """One fast pass: the f32 gradient estimate ``X' r32`` and the
    magnitude sweep ``|X|' |r32|`` that feeds its rigorous error bound.
    Two HIGHEST-pinned f32 matvecs at f32 speed."""
    g32 = jnp.einsum("nj,n->j", X, r32, precision=_PREC)
    mag = jnp.einsum("nj,n->j", jnp.abs(X), jnp.abs(r32), precision=_PREC)
    return g32, mag


def _hybrid_estimate(X, r64):
    """f32 gradient estimate + rigorous per-coordinate error bound —
    the single source of the ``1.01·(n+4)·eps32·(|X|'|r32|)_j`` constant
    (n·eps for the dot in any reduction order, +2 terms for the
    ``r64 → r32`` truncation, 1% inflation for the magnitude sweep's own
    f32 rounding).  Shared by every hybrid certificate consumer."""
    n = X.shape[0]
    g32, mag = _grad32_and_mag(X, jnp.asarray(r64, jnp.float32))
    eps = float(np.finfo(np.float32).eps)
    bnd = 1.01 * (n + 4) * eps * np.asarray(mag, np.float64)
    return np.asarray(g32, np.float64), bnd


def _exact_cols(X, r64, cols):
    """Exact f64 ``X[:, cols]' r`` via one padded gather contraction
    (shared edge-set recompute)."""
    p = X.shape[1]
    Ce = min(p, max(128, -(-max(1, cols.size) // 128) * 128))
    idx = np.full((Ce,), p, np.int64)
    idx[:cols.size] = cols
    Xs = jnp.take(X, jnp.asarray(idx), axis=1, mode="fill", fill_value=0)
    g = jnp.einsum("nj,n->j", Xs, r64, precision=_PREC,
                   preferred_element_type=jnp.float64)
    return np.asarray(g, np.float64)[: cols.size]


def _support_residual(X, y, beta_np):
    """Exact f64 residual via the gathered support — the shared entry
    step of all three certificate functions.  Returns ``(r64, sup)``."""
    p = X.shape[1]
    sup = np.nonzero(beta_np)[0]
    C = min(p, max(128, -(-max(1, sup.size) // 128) * 128))
    if sup.size > C:  # cannot happen (C >= nnz), defensive
        raise ValueError("support larger than working set")
    idx = np.full((C,), p, np.int64)
    idx[:sup.size] = sup
    beta_s = np.zeros((C,), np.float64)
    beta_s[:sup.size] = beta_np[sup]
    r64 = residual_f64(X, jnp.asarray(y), jnp.asarray(idx),
                       jnp.asarray(beta_s))
    return r64, sup


def grad_f64_certified(X, r64, nlamw, *, col_chunk: int = 4096,
                       cap: int = 8192, force=None, as_numpy: bool = False):
    """``X' r`` exact (f64-accumulated) wherever it can matter for the
    Fenchel certificate, f32 elsewhere — a drop-in for ``grad_f64`` in
    both certificate consumers, at a fraction of the cost.

    The certificate uses the gradient only through (a) the dual scaling
    ``ratio = max_j |g_j| / (nλw_j)`` and (b) the violation ranking
    ``max(|g_j|/n − λw_j, 0)``.  One f32 HIGHEST matvec gives ``g32``;
    a second magnitude matvec ``a = |X|'|r32|`` gives the rigorous
    any-summation-order error bound ``|g32_j − g_j| ≤ (n+4)·eps32·a_j``
    (n·eps for the dot in any reduction order, +2 terms for the
    ``r64 → r32`` truncation, +margin).  Columns whose certified UPPER
    bound ``u_j = (|g32_j|+b_j)/(nλw_j)`` falls below BOTH the best
    certified lower bound ``max_k l_k`` and 1.0 can neither attain the
    ratio max nor hold a violation — for those the f32 value is
    returned (its ratio is ≤ u_j < the exact max, and its clipped
    violation is exactly 0, so both consumers see exact results).  Every
    other column — the near-max "edge set", typically O(100) — is
    recomputed exactly by one (n, |S|) gathered f64 contraction.

    Falls back to the full ``grad_f64`` sweep when the edge set exceeds
    ``cap`` (pathological near-tie designs).  ``force`` (optional int
    index array) marks coordinates that must be exact regardless — for
    consumers that read ``g`` beyond the two certified uses (e.g. the
    sqrt-KKT on-support deviation).  Host-driven, like the rest of this
    module.  Requires x64.
    """
    _require_x64("grad_f64_certified")
    n, p = X.shape
    g32_np, bnd = _hybrid_estimate(X, r64)
    nlamw = np.asarray(nlamw, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (np.abs(g32_np) + bnd) / nlamw
        l_best = float(np.max((np.abs(g32_np) - bnd) / nlamw))
    thr = min(l_best, 1.0)
    keep = ~(u < thr)                     # keeps NaN/inf rows (w_j = 0)
    if force is not None:
        # consumers that read g at specific coordinates beyond the two
        # ratio/violation uses (e.g. the sqrt-KKT on-support deviation)
        # force those exact
        keep[np.asarray(force, np.int64)] = True
    sel = np.nonzero(keep)[0]
    if sel.size > cap:
        full = grad_f64(X, r64, col_chunk=col_chunk)
        return np.asarray(full) if as_numpy else full
    out = g32_np.copy()
    out[sel] = _exact_cols(X, r64, sel)
    # the hybrid result is assembled on the host anyway; as_numpy skips
    # the host→device→host round trip of a (p,) f64 vector for
    # host-finish consumers (polish, compensated certificates)
    return out if as_numpy else jnp.asarray(out)


@functools.partial(jax.jit, static_argnames=())
def residual_f64(X, y, idx, beta_s64):
    """Exact f64 residual ``y − X[:, idx] @ beta_s`` of a sparse β whose
    support is contained in ``idx`` (static-size working set; slots with
    ``idx == p`` gather zero columns).  Inputs ``X``/``y`` are exact f32;
    the (n, C) gather is the only design traffic."""
    p = X.shape[1]
    Xs = jnp.take(X, idx, axis=1, mode="fill", fill_value=0)
    return (y.astype(jnp.float64)
            - jnp.dot(Xs.astype(jnp.float64), beta_s64,
                      precision=jax.lax.Precision.HIGHEST))


def sqrt_lasso_kkt_compensated(X, y, beta, lam0, weights=None, *,
                               col_chunk: int = 4096):
    """Measurement-grade sqrt-lasso KKT residual, relative to the
    threshold scale.

    The sqrt-lasso zero rule thresholds ``|X_j'r|`` at ``λ·‖r‖·w_j``
    (reference ``cd_differentiable_function.jl:277-283``), so the
    certificate is the max PER-COORDINATE relative violation
    ``max_j max(|X_j'r| − t_j, 0)/t_j`` (off-support) /
    ``|X_j'r − t_j·sign β_j|/t_j`` (on-support) with ``t_j = λ‖r‖w_j`` —
    0 at an exact solution, and weight-correct (a violation at a
    low-weight coordinate is measured against ITS OWN threshold, not the
    unweighted scale).  Exact f64 residual via the gathered support,
    hybrid gradient sweep (``grad_f64_certified``) with the support
    coordinates forced exact (their deviation is read directly, beyond
    the two certified consumers), every scalar f64.  The f32 engine's
    own residual-based certificate sits at its ~1e-5 floor; this one
    measures the true value.  Returns ``(kkt_rel, norm_r)``.
    Requires x64.
    """
    _require_x64("sqrt_lasso_kkt_compensated")
    X = jnp.asarray(X)
    n, p = X.shape
    beta_np = np.asarray(beta, np.float64)
    w = (np.ones((p,), np.float64) if weights is None
         else np.asarray(weights, np.float64))
    r64, sup = _support_residual(X, y, beta_np)
    r_np = np.asarray(r64)
    rn = float(np.sqrt(r_np @ r_np))
    t = np.maximum(float(lam0) * rn * w, 1e-300)
    g_np = grad_f64_certified(X, r64, t, col_chunk=min(col_chunk, p),
                              force=sup, as_numpy=True)
    return _sqrt_kkt_rel_from_grad(g_np, t, sup, beta_np), rn


def _sqrt_kkt_rel_from_grad(g_np, t, sup, beta_np):
    """Sqrt-lasso KKT roll-up from an exact-where-it-matters gradient —
    shared by ``sqrt_lasso_kkt_compensated`` and
    ``models.polish.polish_sqrt_lasso`` (single source for the
    off-support excess / on-support stationarity-deviation formulas)."""
    off_rel = float(np.max(np.maximum(np.abs(g_np) - t, 0.0) / t))
    on_rel = (float(np.max(
        np.abs(g_np[sup] - t[sup] * np.sign(beta_np[sup])) / t[sup]))
        if sup.size else 0.0)
    return max(off_rel, on_rel)


def group_lasso_kkt_compensated(X, y, beta, lam0, group_size: int,
                                weights=None, *, col_chunk: int = 4096,
                                cap: int = 8192):
    """Measurement-grade group-lasso KKT residual, relative to the
    threshold scale — the third iterate kind's certificate (vector:
    ``lasso_duality_gap_compensated``; sqrt: ``sqrt_lasso_kkt_compensated``).

    Group-KKT (``ops.group_cd._group_full_check`` convention, reference
    ``AtomIterate`` prox semantics): zero groups ``‖X_g'r‖₂ ≤ n·λ0·ω_g``,
    active groups ``X_g'r = n·λ0·ω_g·β_g/‖β_g‖``.  Exact f64 residual via
    the gathered support-group columns; the f32 hybrid sweep's
    per-coordinate bounds roll up per group (``‖g−ĝ‖₂ ≤ ‖b_g‖₂``), zero
    groups whose certified upper bound stays under both the best lower
    bound and 1.0 are provably violation-free, and every other group
    (plus all active groups) is recomputed exactly in f64.  Returns
    ``(kkt_rel, n_exact_groups)``.  Requires x64.
    """
    _require_x64("group_lasso_kkt_compensated")
    X = jnp.asarray(X)
    n, p = X.shape
    G = int(group_size)
    ng = -(-p // G)
    beta_np = np.asarray(beta, np.float64)
    w = (np.ones((ng,), np.float64) if weights is None
         else np.asarray(weights, np.float64))
    t = np.maximum(n * float(lam0) * w, 1e-300)
    kkt_rel, _, n_exact = _group_kkt_pieces(
        X, y, beta_np, t, G, col_chunk=col_chunk, cap=cap)
    return kkt_rel, n_exact


def _group_kkt_pieces(X, y, beta_np, t, G, *, col_chunk: int = 4096,
                      cap: int = 8192):
    """Group-KKT roll-up machinery shared by
    ``group_lasso_kkt_compensated`` and
    ``models.polish.polish_group_lasso``: hybrid per-coordinate bounds
    rolled up per group, exact f64 recompute of the near-max ∪ active
    groups, certificate + per-group off-support excess for working-set
    augmentation.  Returns ``(kkt_rel, off_excess_rel (ng,), n_exact)``.
    """
    n, p = X.shape
    ng = -(-p // G)
    gidx = np.arange(p) // G                       # col → group
    act = np.zeros((ng,), bool)
    np.logical_or.at(act, gidx, beta_np != 0)
    r64, _ = _support_residual(X, y, beta_np)
    g32_np, b = _hybrid_estimate(X, r64)
    # per-group norm estimate + rolled-up bound (‖g−ĝ‖₂ ≤ ‖b_g‖₂)
    gn = np.zeros((ng,))
    bn = np.zeros((ng,))
    np.add.at(gn, gidx, g32_np * g32_np)
    np.add.at(bn, gidx, b * b)
    gn = np.sqrt(gn)
    bn = np.sqrt(bn)
    u = (gn + bn) / t
    l_best = float(np.max((gn - bn) / t))
    thr = min(l_best, 1.0)
    selg = np.nonzero(~((u < thr) & ~act))[0]     # near-max ∪ active
    cols = np.nonzero(np.isin(gidx, selg))[0]
    if cols.size > cap:
        # pathological near-tie: full f64 sweep (no oversized gather) —
        # EVERY group is then exact
        g_np = np.asarray(grad_f64(X, r64, col_chunk=min(col_chunk, p)))
        n_exact = ng
    else:
        g_np = g32_np.copy()
        g_np[cols] = _exact_cols(X, r64, cols)
        n_exact = int(selg.size)
    # certificate: off-excess on all groups (non-selected are provably
    # 0), stationarity deviation on active groups (exact columns)
    gn2 = np.zeros((ng,))
    np.add.at(gn2, gidx, g_np * g_np)
    gn2 = np.sqrt(gn2)
    off_excess = np.maximum(gn2 - t, 0.0) / t
    off_rel = float(np.max(off_excess))
    on_rel = 0.0
    for gi in np.nonzero(act)[0]:
        sl = slice(gi * G, min((gi + 1) * G, p))  # groups are consecutive
        bg = beta_np[sl]
        dir_g = bg / np.linalg.norm(bg)
        on_rel = max(on_rel, float(
            np.linalg.norm(g_np[sl] - t[gi] * dir_g) / t[gi]))
    return max(off_rel, on_rel), off_excess, n_exact


def fenchel_gap_f64(r_np, g_np, beta_np, lam0, w, n, yn, y2=None):
    """Host-f64 Fenchel gap finish shared by
    ``lasso_duality_gap_compensated`` and ``models.polish.polish_lasso``
    (single source — a clamp or weighted-coordinate fix must hit both
    certificate consumers at once).  ``θ = r · min(1, 1/max_j |g_j|/(nλw_j))``
    is dual-feasible by construction; the dual uses the cancellation-safe
    ``(‖y‖² − ‖y−θ‖²)/(2n)`` form.  Returns ``(gap, primal)``."""
    lam0 = float(lam0)
    ratio = np.max(np.abs(g_np) / (n * lam0 * w))
    theta = r_np * min(1.0, 1.0 / max(ratio, 1e-300))
    primal = float(r_np @ r_np / (2 * n)
                   + lam0 * np.sum(w * np.abs(beta_np)))
    if y2 is None:
        y2 = float(yn @ yn)
    dual = float((y2 - (yn - theta) @ (yn - theta)) / (2 * n))
    return primal - dual, primal


def lasso_duality_gap_compensated(X, y, beta, lam0, weights=None, *,
                                  col_chunk: int = 4096):
    """Measurement-grade ``(gap, primal)`` — all accumulation f64.

    Host-driven (not traceable): the support is gathered at a static size
    derived from ``nnz(beta)``, the residual is exact f64 via the
    gathered block, the full gradient is the column-chunked f64 sweep,
    and the scalar arithmetic finishes in host f64.  This is the
    certificate :mod:`models.polish` optimizes against; unlike
    ``lasso_duality_gap_f64`` (f32 device contractions, f64 finish) its
    error is ~1e-15, well under the 1e-7 target.
    """
    _require_x64("lasso_duality_gap_compensated")
    X = jnp.asarray(X)
    n, p = X.shape
    beta_np = np.asarray(beta, np.float64)
    w = (np.ones((p,), np.float64) if weights is None
         else np.asarray(weights, np.float64))
    sup = np.nonzero(beta_np)[0]
    C = min(p, max(128, -(-max(1, sup.size) // 128) * 128))
    if sup.size > C:  # cannot happen (C >= nnz), defensive
        raise ValueError("support larger than working set")
    idx = np.full((C,), p, np.int64)
    idx[:sup.size] = sup
    beta_s = np.zeros((C,), np.float64)
    beta_s[:sup.size] = beta_np[sup]
    r64 = residual_f64(X, jnp.asarray(y), jnp.asarray(idx),
                       jnp.asarray(beta_s))
    # hybrid sweep: exact f64 on the near-max edge set, bounded-f32
    # elsewhere — the ratio/violation consumers see exact values (see
    # grad_f64_certified; cheaper than a full f64 sweep)
    g_np = grad_f64_certified(X, r64, n * float(lam0) * w,
                              col_chunk=min(col_chunk, p), as_numpy=True)
    return fenchel_gap_f64(np.asarray(r64), g_np, beta_np,
                           lam0, w, n, np.asarray(y, np.float64))


@functools.partial(jax.jit, static_argnames=("col_chunk",))
def loadings_f64(X, r64, col_chunk: int = 2048):
    """Heteroscedastic penalty loadings ``sqrt(mean((X_ij r_i)²))`` with
    true f64 accumulation, column-chunked (``get_loadings`` semantics,
    reference utils.jl:153-164).

    The f32 form's squared terms alone carry ~eps32 ≈ 6e-8 relative
    error — too coarse for certifying the feasible-lasso loading fixed
    point at the 1e-7 tier (``models.polish.polish_feasible_lasso``).
    Per chunk: one (n, chunk) f64 square + one f64 matvec (the exact
    class); no X-sized temp is ever materialized."""
    n, p = X.shape
    pc = min(col_chunk, p)
    ncol = -(-p // pc)
    if ncol * pc != p:
        X = jnp.pad(X, ((0, 0), (0, ncol * pc - p)))
    rr = r64 * r64

    def one(c):
        Xc = lax.dynamic_slice_in_dim(X, c * pc, pc, 1).astype(jnp.float64)
        return jnp.einsum("nj,n->j", Xc * Xc, rr, precision=_PREC,
                          preferred_element_type=jnp.float64)

    out = lax.map(one, jnp.arange(ncol)).reshape(-1)[:p]
    return jnp.sqrt(out / n)
