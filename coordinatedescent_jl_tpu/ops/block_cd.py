"""Core block-coordinate-descent engine.

This is the accelerator-oriented re-design of the reference driver
(``src/coordinate_descent.jl:1-149``) plus the per-coordinate update rules of
the four losses (``src/cd_differentiable_function.jl``).  The reference's hot
loop is inherently sequential: each scalar coordinate update mutates the
residual vector before the next coordinate reads it.  Instead of
transliterating that, the engine here:

1. Partitions the ``p`` coordinates into blocks of width ``B`` (lane-width
   multiples).  ``X`` is stored column-blocked as ``Xb: (nb, n, B)`` so a
   block visit is one contiguous dynamic-index load.

2. Recovers **exact sequential CD semantics inside a block** via the Gram
   recursion: with ``K = Xw_blk' X_blk`` (one matmul, cached per problem
   or computed on the fly) and ``c = Xw_blk' r``, updating coordinate
   ``i`` by ``h`` implies ``c ← c − K[:, i] h``, which is exactly what the
   reference's per-coordinate residual refresh
   (cd_differentiable_function.jl:107-109) does to the gradients of the
   remaining coordinates.  After the block, one fused matvec applies
   ``r ← r − X_blk @ h`` once.  Within-block-sequential + across-block-cyclic
   therefore reproduces cyclic CD exactly (SURVEY.md §7 delta 2).

3. Replaces the reference's sequential *full pass*
   (coordinate_descent.jl:76-82) with a **vectorized KKT sweep**: one big
   matvec ``c = Xw' r`` gives every coordinate's Jacobi-style
   potential displacement ``h_pot`` at once; blocks containing violations are
   (re)activated.  Convergence is declared exactly like the reference —
   two consecutive converged passes, the confirming one being a full pass
   (coordinate_descent.jl:72-90) — with ``maxH < opt_tol`` on the
   order-independent ``h_pot`` certificate, which is at least as strict as
   the reference's sequential-pass criterion.

4. Keeps the active set as an on-device boolean **block mask** — the
   reference's ``SparseIterate`` + ``dropzeros!`` (coordinate_descent.jl:108)
   become a mask refresh ``active = any(beta ≠ 0, per block)``.

5. Runs λ-continuation (coordinate_descent.jl:24-37) as a ``lax.scan`` over
   log-spaced λ values carrying ``(β, r, mask)``, and the epoch loop as a
   ``lax.while_loop``.

Randomization (reference ``RandomIterator``, atom_iterator.jl:41-75) becomes
a per-pass permutation of the block visit order plus a per-pass permutation
of the within-block coordinate order, driven by a threaded PRNG key.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .losses import (
    QuadraticLoss,
    WeightedLSLoss,
)
from .prox import ProxL1, ProxL1Group, ProxZero, as_l1, soft_threshold
from ..utils.options import CDOptions, resolve_extrapolate

# CD convergence hinges on accurate coordinate gradients: an accelerator's
# default f32 matmul precision may round operands to TF32 or bf16 (~1e-3
# relative error), which silently caps the achievable KKT residual.  Every
# solver-critical contraction therefore pins HIGHEST precision (full f32).
_PREC = lax.Precision.HIGHEST


def noise_floor_mask(habs, beta, step_noise=None):
    """Zero out per-coordinate steps below that coordinate's computational
    noise floor (sub-f64 dtypes only).

    Two noise sources bound what a computed step can mean at f32:

    - **iterate quantization** ``2·eps·|β_j|`` — a smaller step cannot
      meaningfully move β_j;
    - **gradient accumulation** ``step_noise_j ≈ κ·eps·‖r‖/‖X_j‖`` — the
      rounding error of the (HIGHEST-pinned, f32-accumulated) dot
      ``c_j = X_j'r`` is ~``eps·‖X_j‖·‖r‖``, which divided by the
      curvature ``a_j = ‖X_j‖²`` is the noise in the *step*.  The observed
      f32 limit cycle repeats exactly this magnitude.

    Without the mask, f32 full checks at the reference-default
    ``opt_tol = 1e-7`` (utils.jl:11) cycle forever on this noise and every
    solve burns ``stall_patience`` full-check/active-solve rounds before
    the stall detector fires — ~20× the useful work in warm outer loops
    (σ rounds, λ paths).  The floor is per-coordinate on purpose: a global
    ``eps·max|β|`` floor would swallow genuine small steps on small
    coordinates when the iterate has wide dynamic range.  f64 keeps the
    reference's exact criterion (both terms are ~1e-16-scale, far below
    any real ``opt_tol``); the stall detector remains the backstop for
    noise above this floor."""
    if jnp.dtype(beta.dtype).itemsize >= 8:
        return habs
    eps = jnp.finfo(beta.dtype).eps
    floor = 2 * eps * jnp.abs(beta)
    if step_noise is not None:
        floor = floor + step_noise
    return jnp.where(habs <= floor, 0.0, habs)


def _step_noise(r, xwnorm, dtype):
    """Per-coordinate f32 step-noise scale ``κ·eps·‖r‖/‖Xw_j‖`` (see
    noise_floor_mask); κ=4 covers the RMS accumulation error of the pinned
    f32 dot with margin (the observed cycle noise is ≈1·eps·‖r‖/‖X_j‖)."""
    if jnp.dtype(dtype).itemsize >= 8:
        return None
    eps = jnp.finfo(dtype).eps
    rnorm = jnp.sqrt(jnp.dot(r, r, precision=_PREC))
    return 4 * eps * rnorm / jnp.maximum(xwnorm, 1e-30)


# ---------------------------------------------------------------------------
# Blocked problem representation
# ---------------------------------------------------------------------------


class BlockedProblem(NamedTuple):
    """Column-blocked problem data (a pytree; ``kind`` is carried statically).

    For ls/wls/sqrt: ``Xb`` is the design, ``Xwb`` its row-weighted copy
    (the same array when unweighted), ``y`` the response.
    For quad: ``Xb`` holds the column blocks of ``A`` (shape ``(nb, P, B)``),
    ``q`` the linear term; ``y``/``Xwb`` are unused.
    ``adiag[b, i]`` is the curvature of coordinate ``(b, i)``:
    ``Σ w X²`` for ls/wls/sqrt, ``A_jj`` for quad.
    ``lamw`` are the per-coordinate penalty weights, blocked.
    ``valid`` masks out the zero columns added by padding ``p`` up to a
    multiple of the block width.
    """

    Xb: jnp.ndarray
    Xwb: Optional[jnp.ndarray]
    y: Optional[jnp.ndarray]
    q: Optional[jnp.ndarray]
    adiag: jnp.ndarray
    lamw: jnp.ndarray
    valid: jnp.ndarray
    xwnorm: jnp.ndarray  # (nb, B) ‖Xw_j‖ — the per-coordinate staleness
                         # gain of the cached gradient: |Xw_j'Δr| ≤
                         # ‖Xw_j‖·‖Δr‖ (unused for quad)
    Kb: Optional[jnp.ndarray] = None  # (nb, B, B) cached per-block Grams
                                      # ``Xw_b' X_b`` (λ-independent; see
                                      # CDOptions.cache_gram) or None


class CDState(NamedTuple):
    """Solver state threaded through passes (a small pytree —
    this is also the checkpointable unit, SURVEY.md §5.4)."""

    beta: jnp.ndarray   # (nb, B) blocked coefficients
    r: jnp.ndarray      # residuals y - Xβ (ls/wls/sqrt) or Ax (quad)
    rsqr: jnp.ndarray   # ‖r‖² running value (sqrt-lasso only; else 0)
    active: jnp.ndarray  # (nb,) bool block mask
    key: jnp.ndarray    # PRNG key for randomized visit order
    it: jnp.ndarray     # epoch counter within the current solve
    conv: jnp.ndarray   # last pass converged (maxH < tol)
    done: jnp.ndarray   # two consecutive converged passes (full confirming)
    c: jnp.ndarray      # (nb, B) cached full gradient term from the last
                        # KKT sweep that refreshed each block (λ-independent;
                        # reused across λ-path points to skip X reads)
    drift: jnp.ndarray  # (nb,) per-block upper bound on ‖r − r_ref[b]‖
                        # where r_ref[b] is the residual when c[b] was last
                        # refreshed (triangle-inequality accumulation across
                        # passes).  drift[b] == 0 ⟺ c[b] exact for current r;
                        # also feeds the gap-safe screening bound
                        # |X_j'r − c_j| ≤ ‖X_j‖·drift[b].


def _pad_to_blocks(v, B, fill=0.0):
    p = v.shape[-1]
    P = -(-p // B) * B
    if P != p:
        pad = [(0, 0)] * (v.ndim - 1) + [(0, P - p)]
        v = jnp.pad(v, pad, constant_values=fill)
    return v


def _blockify_cols(X, B):
    """(n, P) → (nb, n, B) contiguous column blocks."""
    n, P = X.shape
    return X.reshape(n, P // B, B).transpose(1, 0, 2)


def build_blocked(kind: str, opts: CDOptions, lamw_full, *, X=None, y=None,
                  w=None, A=None, q=None) -> BlockedProblem:
    """Assemble the blocked problem representation (runs under jit)."""
    B = opts.block_size
    if kind == "quad":
        P0 = q.shape[0]
        dtype = q.dtype
        Ap = _pad_to_blocks(A, B)            # pad cols
        Ap = _pad_to_blocks(Ap.T, B).T       # pad rows (keeps symmetry)
        qp = _pad_to_blocks(q, B)
        Ab = _blockify_cols(Ap, B)           # (nb, P, B)
        adiag = _blockify_cols(jnp.diagonal(Ap)[None, :], B)[:, 0, :]
        Xb, Xwb, yv = Ab, None, None
        xwnorm = jnp.sqrt(jnp.maximum(adiag, 0.0))   # unused for quad
    else:
        P0 = X.shape[1]
        dtype = X.dtype
        Xp = _pad_to_blocks(X, B)
        Xb = _blockify_cols(Xp, B)
        if kind == "wls":
            Xwb = _blockify_cols(Xp * w[:, None], B)
        else:
            Xwb = Xb
        adiag = jnp.sum(Xwb * Xb, axis=1)    # (nb, B): Σ w X²  (= X'X unwtd)
        if kind == "wls":
            xwnorm = jnp.sqrt(jnp.sum(Xwb * Xwb, axis=1))   # ‖w·X_j‖
        else:
            xwnorm = jnp.sqrt(jnp.maximum(adiag, 0.0))      # ‖X_j‖
        yv, qp = y, None
    lamw_b = _blockify_cols(
        _pad_to_blocks(jnp.asarray(lamw_full, dtype), B, fill=1.0)[None, :], B
    )[:, 0, :]
    valid = _blockify_cols(
        _pad_to_blocks(jnp.ones((P0,), dtype=bool), B, fill=False)[None, :], B
    )[:, 0, :]
    Kb = None
    if kind != "quad" and _gram_mode(kind, opts, Xb.shape[0], B, dtype):
        Kb = _block_grams(Xwb, Xb)
    return BlockedProblem(Xb=Xb, Xwb=Xwb, y=yv, q=qp, adiag=adiag,
                          lamw=lamw_b, valid=valid, xwnorm=xwnorm, Kb=Kb)


def _gram_mode(kind, opts: CDOptions, nb: int, B: int, dtype=None) -> bool:
    """Static decision for the per-block Gram cache (CDOptions.cache_gram).
    Auto = on for the regression losses when the (nb, B, B) cache stays
    under 256 MiB AND working-set compaction will not engage (a compacting
    solve visits full-problem blocks only in rare fallback passes, so the
    ``2·n·p·B``-FLOP full build would never amortize — the gathered working
    set gets its own Gram cache instead, see ``WsCache.Kb``).  Pass
    ``dtype=None`` to skip the compaction check (used for sub-problems,
    whose caller already decided).  Quad never caches (its ``A`` blocks
    already hold K)."""
    if kind not in ("ls", "wls", "sqrt") or opts.cache_gram is False:
        return False
    if opts.cache_gram is True:
        return True
    if dtype is not None and _compact_nc(kind, opts, nb, B, dtype):
        return False
    itemsize = 4 if dtype is None else jnp.dtype(dtype).itemsize
    return nb * B * B * itemsize <= 256 * 1024 * 1024


def _block_grams(Xwb, Xb):
    """All per-block Grams ``K_b = Xw_b' X_b`` in one batched contraction
    (the one-time build that removes half of every visit's FLOPs)."""
    return jnp.einsum("bnk,bnl->bkl", Xwb, Xb, precision=_PREC)


# ---------------------------------------------------------------------------
# Per-coordinate update rules (shared by the in-block scan & the KKT sweep)
# ---------------------------------------------------------------------------


def _ls_candidate(beta, c, a, lam0, lamw, n_scale):
    """Closed-form (weighted) least-squares / quadratic coordinate minimizer.

    Matches reference ``descendCoordinate!`` for CDLeastSquaresLoss
    (cd_differentiable_function.jl:83-111): ``x ← prox(x + b/a; scale·λ/a)``
    where ``scale`` is ``n`` for ls/wls and ``1`` for quad (which calls
    ``cdprox!`` with ``γ = 1/a``, :324-348).
    """
    safe = a > 0
    asafe = jnp.where(safe, a, 1.0)
    z = beta + c / asafe
    val = soft_threshold(z, n_scale * lam0 * lamw / asafe)
    return jnp.where(safe, val, beta)


def _sqrt_candidate(beta, c, a, rsqr, lam0, lamw):
    """Exact sqrt-lasso coordinate minimizer (three-branch soft threshold).

    Matches reference cd_differentiable_function.jl:242-291.  With the
    coordinate's own contribution added back, ``s = X_k'r_back = c + a·β`` and
    ``rsqr_back = ‖r_back‖² = rsqr + 2βc + β²a``:

    - zero if ``|s| ≤ λ √rsqr_back``  (by Cauchy-Schwarz this always holds
      when ``λ² ≥ a``, so the λ²<a guard below never changes the result);
    - else ``sign(s)·(|s| − λ/√(1−λ²/a)·√(rsqr_back − s²/a)) / a``.

    Returns ``(val, s, rsqr_back)`` so callers can update ``rsqr``:
    ``‖r_back − X_k·val‖² = rsqr_back − 2·val·s + val²·a``.
    """
    safe = a > 0
    asafe = jnp.where(safe, a, 1.0)
    s = c + a * beta
    rsb = jnp.maximum(rsqr + 2.0 * beta * c + beta * beta * a, 0.0)
    lam = lam0 * lamw
    ok = safe & (lam * lam < a)
    den = jnp.sqrt(jnp.where(ok, 1.0 - lam * lam / asafe, 1.0))
    inner = jnp.sqrt(jnp.maximum(rsb - s * s / asafe, 0.0))
    mag = (jnp.abs(s) - lam / den * inner) / asafe
    nonzero = ok & (jnp.abs(s) > lam * jnp.sqrt(rsb))
    val = jnp.where(nonzero, jnp.sign(s) * mag, 0.0)
    val = jnp.where(safe, val, beta)
    return val, s, rsb


# ---------------------------------------------------------------------------
# Block visit: exact sequential CD on one block via the Gram recursion
# ---------------------------------------------------------------------------


def _visit_block(kind, K, beta_b, lamw_b, lam0, c, rsqr, n_scale,
                 order):
    """Sequentially minimize each coordinate of one block.

    ``K = Gw'G``, ``c = Gw'r`` on entry.  Equivalent to the reference's
    per-coordinate loop restricted to this block: after coordinate ``i``
    moves by ``h``, every remaining gradient shifts by ``K[:, i] h``
    (the lifted form of the rank-1 residual update at
    cd_differentiable_function.jl:107-109).
    """
    a_diag = jnp.diagonal(K)

    def step(carry, i):
        beta_b, c, rsqr, maxh = carry
        a = a_diag[i]
        bi = beta_b[i]
        ci = c[i]
        lw = lamw_b[i]
        if kind == "sqrt":
            val, s, rsb = _sqrt_candidate(bi, ci, a, rsqr, lam0, lw)
            rsqr = jnp.maximum(rsb - 2.0 * val * s + val * val * a, 0.0)
        else:
            val = _ls_candidate(bi, ci, a, lam0, lw, n_scale)
        h = val - bi
        c = c - K[:, i] * h
        beta_b = beta_b.at[i].set(val)
        maxh = jnp.maximum(maxh, jnp.abs(h))
        return (beta_b, c, rsqr, maxh), None

    zero = jnp.zeros((), beta_b.dtype)
    (beta_b, c, rsqr, maxh), _ = lax.scan(
        step, (beta_b, c, rsqr, zero), order)
    return beta_b, rsqr, maxh


def _active_first_order(active, border):
    """Visit order of one active pass: the active blocks first, in
    ``border`` (possibly permuted) order, then the skipped blocks.

    The block-granular form of the reference's ordered / random /
    sparse-aware iterators (atom_iterator.jl:11-85): the pass loops over
    the first ``n_active`` entries only, so its trip count is the active
    set's size, not ``nb``.  Returns ``(order, n_active)``."""
    keep = active[border]
    # stable partition: active blocks first, preserving the visit order
    idx = jnp.argsort(~keep, stable=True)
    return border[idx], jnp.sum(keep).astype(jnp.int32)


def _resolve_inner(kind, opts: Optional[CDOptions], dtype) -> str:
    """Within-block solver of the active pass (``CDOptions.inner``).
    Auto = ista for sub-f64 dtypes on the ls/wls/sqrt losses, exact
    otherwise; quad always runs the exact scan."""
    if opts is None or kind not in ("ls", "wls", "sqrt"):
        return "exact"
    if opts.inner == "auto":
        return "ista" if jnp.dtype(dtype).itemsize < 8 else "exact"
    return opts.inner


def _block_ista(K, c, beta0, lamw, thr_scale, iters: int):
    """Vectorized inexact block solve: ``iters`` FISTA steps on the block's
    (weighted) LS + L1 subproblem with per-coordinate thresholds
    ``thr_scale·λw`` (``thr_scale = n·λ0`` for ls/wls; ``λ0·‖r₀‖`` for the
    sqrt-lasso MM majorization ``‖r‖ ≤ (‖r‖² + ‖r₀‖²)/(2‖r₀‖)`` — each
    block visit then approximately minimizes a convex majorizer of the
    true objective; with the FISTA acceleration individual visits are
    only near-monotone, and final convergence is certified by the outer
    KKT sweep as always).

    Sequential scalar CD costs ``B`` dependent steps per block; this
    replaces them with ``iters`` ``B×B`` matvecs: with ``L ≥ λmax(K)``
    (Gershgorin row-sum bound), ``d ← soft(d + (c + K(β0 − d))/L;
    n·λ0·λw/L)`` has the same fixed points as exact coordinate descent, so
    the outer loop's KKT certificate (``_full_check``) guarantees the same
    converged solution — only the trajectory differs, which the
    reference's own config-invariance tests treat as equivalent
    (SURVEY.md §4.3).  ``K`` is symmetric (``Xw'X`` with diagonal
    weights).  Returns ``(d, maxh)``."""
    dt = c.dtype
    L = jnp.maximum(jnp.max(jnp.sum(jnp.abs(K), axis=0)), 1e-30)
    thr = thr_scale * lamw / L
    q0 = c + jnp.dot(beta0, K, precision=_PREC)

    # FISTA momentum t_{k+1} = (1+√(1+4t_k²))/2 at plain-ISTA cost per
    # step.  Unrolled: ``iters`` is small and static, and a rolled loop
    # would add a device→host trip-count check per step on the GPU
    def body(_, carry):
        d, d_prev, t = carry
        t_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        yv = d + ((t - 1.0) / t_next) * (d - d_prev)
        Ky = jnp.dot(yv, K, precision=_PREC)
        d_new = soft_threshold(yv + (q0 - Ky) / L, thr)
        return d_new, d, t_next

    d, _, _ = lax.fori_loop(0, iters, body,
                            (beta0, beta0, jnp.ones((), dt)), unroll=True)
    # zero-snap epilogue: a finite FISTA budget leaves tiny nonzero "dust"
    # on coordinates whose exact solo-optimum is 0.  The exact
    # coordinate-wise zero condition given the others fixed is
    # |a_k·d_k + q_k| ≤ thr_scale·λw_k (cd_differentiable_function.jl:
    # 101-103 rearranged); snapping those to 0 keeps the active set honest
    # and preserves the solver's exact-sparsity semantics
    q = q0 - jnp.dot(d, K, precision=_PREC)
    adiag = jnp.diagonal(K)
    d = jnp.where(jnp.abs(adiag * d + q) <= thr_scale * lamw, 0.0, d)
    # dead columns (zero curvature, e.g. padding) must not move
    d = jnp.where(adiag > 0.0, d, beta0)
    return d, jnp.max(jnp.abs(d - beta0))


def _active_pass(kind, prob: BlockedProblem, st: CDState, lam0, n_scale,
                 randomize: bool, opts: Optional[CDOptions] = None):
    """One pass over the active blocks (reference's nonzero pass,
    coordinate_descent.jl:94-110, at block granularity): per visited
    block a Gram (cached or computed), the block gradient, the
    within-block solve (``_resolve_inner``), and one residual matvec."""
    nb, B = prob.lamw.shape
    key, k1, k2 = jax.random.split(st.key, 3)
    if randomize:
        border = jax.random.permutation(k1, nb)
        corder = jax.random.permutation(k2, B)
    else:
        border = jnp.arange(nb)
        corder = jnp.arange(B)
    inner = _resolve_inner(kind, opts, st.beta.dtype)
    iters = opts.block_iters if opts is not None else 0
    order, n_active = _active_first_order(st.active, border)

    def body(t, carry):
        beta, r, rsqr, maxh = carry
        b = order[t]
        G = prob.Xb[b]
        if kind == "quad":
            K = lax.dynamic_slice(G, (b * B, 0), (B, B))
            rb = lax.dynamic_slice(r, (b * B,), (B,))
            qb = lax.dynamic_slice(prob.q, (b * B,), (B,))
            c = -(rb + qb)
        else:
            Gw = prob.Xwb[b]
            if prob.Kb is not None:
                K = prob.Kb[b]
            else:
                K = jnp.dot(Gw.T, G, preferred_element_type=G.dtype,
                            precision=_PREC)
            c = jnp.dot(Gw.T, r, precision=_PREC)
        bb = beta[b]
        if inner == "ista":
            if kind == "sqrt":
                # MM majorizer threshold λ0·‖r₀‖ at the current block
                ts = lam0 * jnp.sqrt(jnp.maximum(rsqr, 1e-30))
            else:
                ts = n_scale * lam0
            bb2, mh = _block_ista(K, c, bb, prob.lamw[b], ts, iters)
            rsqr2 = rsqr
        else:
            bb2, rsqr2, mh = _visit_block(
                kind, K, bb, prob.lamw[b], lam0, c, rsqr, n_scale, corder)
        h = bb2 - bb
        if kind == "quad":
            # Ax update (cd_diff…jl:344-346)
            r2 = r + jnp.dot(G, h, precision=_PREC)
        else:
            # residual update (:107-109)
            r2 = r - jnp.dot(G, h, precision=_PREC)
        if kind == "sqrt" and inner == "ista":
            # exact ‖r‖² refresh for the next block's majorizer
            rsqr2 = jnp.dot(r2, r2, precision=_PREC)
        return beta.at[b].set(bb2), r2, rsqr2, jnp.maximum(maxh, mh)

    zero = jnp.zeros((), st.beta.dtype)
    beta, r, rsqr, maxh = lax.fori_loop(
        0, n_active, body, (st.beta, st.r, st.rsqr, zero))
    # dropzeros! (coordinate_descent.jl:108) → mask refresh
    active = jnp.any(beta != 0, axis=1)
    # every cached gradient block goes stale by at most ‖Δr‖ (triangle
    # inequality) — the lifted form of "the pass invalidates c_fresh"
    dnorm = jnp.sqrt(jnp.sum((r - st.r) ** 2))
    return st._replace(beta=beta, r=r, rsqr=rsqr, active=active, key=key,
                       drift=st.drift + dnorm), maxh


def _full_gradient_c(kind, prob: BlockedProblem, r):
    """Blocked ``c`` for every coordinate at once (one batched matvec)."""
    if kind == "quad":
        nb, B = prob.lamw.shape
        return -(r.reshape(nb, B) + prob.q.reshape(nb, B))
    return jnp.einsum("bnk,n->bk", prob.Xwb, r, precision=_PREC)


def _potential_steps(kind, prob, beta, c, rsqr, lam0, n_scale):
    """Jacobi-style per-coordinate optimal displacement ``h_pot`` given the
    full gradient — the order-independent optimality residual used by the
    vectorized full pass."""
    if kind == "sqrt":
        val, _, _ = _sqrt_candidate(beta, c, prob.adiag, rsqr, lam0,
                                    prob.lamw)
    else:
        val = _ls_candidate(beta, c, prob.adiag, lam0, prob.lamw, n_scale)
    h = jnp.where(prob.valid, val - beta, 0.0)
    return h


def _gap_safe_core(c, beta, drift2, adiag, lamw, valid, lam0, n_scale,
                   rn2, ry):
    """Raw-array core of the gap-safe screen.  ``drift2`` is
    the per-block drift broadcast to ``(nb, 1)``; ``ry = r'y`` is computed
    by the caller.  Returns the per-block candidate mask as ``(nb, 1)``."""
    dt = beta.dtype
    eps = jnp.finfo(dt).eps
    xnorm = jnp.sqrt(jnp.maximum(adiag, 0.0))             # ‖X_j‖
    # rounding slack on the cached dot products (RMS-style bound)
    c_slack = xnorm * jnp.sqrt(rn2) * (8.0 * jnp.sqrt(n_scale) * eps)
    u = jnp.abs(c) + xnorm * drift2 + c_slack
    lamvec = n_scale * lam0 * lamw                        # n·λ0·ω_j
    pos = valid & (lamvec > 0)
    ratio_ub = jnp.max(jnp.where(pos, u, 0.0)
                       / jnp.where(pos, lamvec, 1.0))
    # the residual-rescaling dual certificate needs every valid coordinate
    # penalized; otherwise disable screening for this solve
    ok = jnp.max(jnp.where(valid & ~(lamvec > 0), 1.0, 0.0)) == 0
    scale = jnp.minimum(1.0, 1.0 / jnp.maximum(ratio_ub, 1e-30))
    primal = rn2 / (2.0 * n_scale) + lam0 * jnp.sum(
        jnp.where(valid, lamw * jnp.abs(beta), 0.0))
    dual = (2.0 * scale * ry - scale * scale * rn2) / (2.0 * n_scale)
    gap = (jnp.maximum(primal - dual, 0.0)
           + 64.0 * eps * (jnp.abs(primal) + jnp.abs(dual)))
    rho = jnp.sqrt(2.0 * n_scale * gap)
    screened = (ok & pos & (beta == 0)
                & (scale * u + rho * xnorm < lamvec * (1.0 - 8.0 * eps)))
    return jnp.max(jnp.where(valid & ~screened, 1.0, 0.0),
                   axis=1, keepdims=True) > 0


def _gap_safe_candidates(prob: BlockedProblem, st: CDState, lam0, n_scale,
                         rn2):
    """Gap-safe screening for the least-squares Lasso (a capability the
    reference lacks; standard safe-sphere rule à la Fercoq/Gramfort/Salmon,
    "Mind the duality gap", ICML 2015 — derived here from scratch for this
    engine's cached-gradient representation).

    With dual ``D(θ) = (‖y‖² − ‖y−θ‖²)/(2n)`` feasible iff
    ``|X_j'θ| ≤ n·λ0·ω_j`` and optimum ``θ* = r*``, strong concavity gives
    ``‖θ* − θ‖ ≤ √(2n·gap)``, so a coordinate with
    ``|X_j'θ| + ρ‖X_j‖ < n·λ0·ω_j`` is provably zero at the optimum.

    The twist: the exact ``X_j'r`` is not available without a full X read —
    only the cached ``c_j`` with the staleness bound
    ``|X_j'r − c_j| ≤ ‖X_j‖·drift[b]``.  Every bound below is taken on the
    conservative side (ratio over-estimated → dual under-estimated → gap and
    radius over-estimated), so screening stays *safe* with stale gradients.
    Small dtype-dependent slacks absorb floating-point rounding.

    Returns the per-block candidate mask (blocks NOT provably all-zero).
    Screened blocks are certified β*=0 at the exact optimum, which is a
    stronger statement than the tol-level KKT the sweep would report.
    """
    ry = jnp.dot(st.r, prob.y, precision=_PREC)
    return _gap_safe_core(st.c, st.beta, st.drift[:, None], prob.adiag,
                          prob.lamw, prob.valid, lam0, n_scale, rn2,
                          ry)[:, 0]


def _stale_certified(kind, prob: BlockedProblem, st: CDState, rsqr, lam0,
                     n_scale, opt_tol):
    """Per-block certificate that every potential step is < ``opt_tol``
    *without refreshing the cached gradient* (no X read).

    For ls/wls the coordinate map ``h(c) = soft(β + c/a, T) − β`` is
    1/a-Lipschitz in ``c``, and ``|c_exact − c_stale| ≤ ‖Xw_j‖·drift[b]``,
    so ``|h_exact| ≤ |h(c_stale)| + ‖Xw_j‖·drift[b]/a``.  For sqrt, only
    all-zero blocks are certified, via the exact zero condition
    ``|X_j'r| ≤ λ0·λw_j·‖r‖`` (cd_differentiable_function.jl:277-283)
    bounded from above with the same staleness ball.

    Certification is *decision-exact*: a certified block's exact potential
    steps are provably < tol, so the convergence / (re)activation decisions
    match what an exact refresh would produce — only the X traffic differs.
    Returns ``(certified, bound)`` with ``bound`` the per-coordinate upper
    bound on ``|h_exact|`` (valid only where certified can be trusted, i.e.
    finite entries)."""
    if kind != "sqrt":
        certified2, bound, _ = _stale_core_ls(
            st.c, st.beta, st.drift[:, None], prob.adiag, prob.lamw,
            prob.valid, prob.xwnorm, lam0, n_scale, opt_tol)
        return certified2[:, 0], bound
    dt = st.beta.dtype
    # drift accumulation rounding slack (the norm sums are finite-precision)
    dball = st.drift[:, None] * (1.0 + 64.0 * jnp.finfo(dt).eps)
    e_c = prob.xwnorm * dball                       # |c_exact − c_stale| ≤
    zero_blk = ~jnp.any(st.beta != 0, axis=1)
    thr = lam0 * prob.lamw * jnp.sqrt(jnp.maximum(rsqr, 0.0))
    ok = (jnp.abs(st.c) + e_c) <= thr
    bound = jnp.where(ok & zero_blk[:, None], 0.0, jnp.inf)
    bound = jnp.where(prob.valid, bound, 0.0)
    certified = jnp.all(bound < opt_tol, axis=1)
    return certified, bound


def _stale_core_ls(c, beta, drift2, adiag, lamw, valid, xwnorm, lam0,
                   n_scale, opt_tol):
    """Raw-array ls/wls core of ``_stale_certified``.  Returns
    ``(certified (nb,1), bound (nb,B), h_stale (nb,B))`` — ``h_stale`` is
    the potential step evaluated with the *cached* gradient, which IS the
    exact step for unrefreshed blocks."""
    dt = beta.dtype
    dball = drift2 * (1.0 + 64.0 * jnp.finfo(dt).eps)
    e_c = xwnorm * dball                            # |c_exact − c_stale| ≤
    val = _ls_candidate(beta, c, adiag, lam0, lamw, n_scale)
    h_stale = jnp.where(valid, val - beta, 0.0)
    asafe = jnp.where(adiag > 0, adiag, 1.0)
    bound = jnp.abs(h_stale) + e_c / asafe
    bound = jnp.where(valid, bound, 0.0)
    certified2 = jnp.max(jnp.where(bound < opt_tol, 0.0, 1.0),
                         axis=1, keepdims=True) == 0
    return certified2, bound, h_stale


def _full_check(kind, prob: BlockedProblem, st: CDState, lam0, n_scale,
                opt_tol, opts: Optional[CDOptions] = None,
                count_x: bool = False):
    """Vectorized full pass: KKT sweep + (re)activation of violating blocks
    (replaces the reference's sequential full pass, SURVEY.md §7).

    Three mechanisms decide which blocks' cached gradient ``c`` must be
    refreshed; when none must, the check reads no X at all:

    - **cached gradients**: blocks with ``drift == 0`` have an exact cached
      ``c`` (e.g. every block right after a confirming sweep — the cache is
      λ-independent, so a new λ-path point's first check reads no X at all);
    - **drift-ball certification** (``_stale_certified``): stale blocks whose
      conservative step bound is already < tol are accepted without a
      refresh — after a near-converged active pass this certifies almost
      every block;
    - **gap-safe screening** (ls only, ``opts.screen``): blocks whose every
      coordinate is provably zero at this λ's optimum are neither refreshed
      nor checked, and convergence is certified by restricted-KKT + the
      safe rule.

    A refresh is one dense blocked einsum over the whole design (which
    blocks need it is decided on the device, and XLA's shapes are static);
    only the needed blocks take its rows, the others keep their cached
    ``c`` and drift.
    """
    if kind == "sqrt":
        # refresh exact ‖r‖² (drift control) — pinned like every
        # solver-critical contraction (the sqrt zero-threshold λ·√rsqr
        # inherits this value's accuracy)
        rsqr = jnp.dot(st.r, st.r, precision=_PREC)
        rn2 = rsqr
    else:
        rsqr = st.rsqr
        rn2 = None
    nb, B = prob.lamw.shape

    if kind == "quad":
        # quad's gradient term is O(p) from the maintained Ax — recompute
        c = _full_gradient_c(kind, prob, st.r)
        drift_new = jnp.zeros_like(st.drift)
        cand = jnp.ones((nb,), bool)
        use_bound = jnp.zeros((nb,), bool)
        bound = jnp.zeros_like(st.c)
    else:
        screen = (kind == "ls" and opts is not None
                  and opts.screen is not False)
        if screen:
            rn2 = jnp.dot(st.r, st.r, precision=_PREC)
            cand = _gap_safe_candidates(prob, st, lam0, n_scale, rn2)
        else:
            cand = jnp.ones((nb,), bool)
        stale = st.drift > 0
        certified, bound = _stale_certified(kind, prob, st, rsqr, lam0,
                                            n_scale, opt_tol)
        need = cand & stale & ~certified
        use_bound = stale & certified      # keep stale c; report the bound

        c = lax.cond(jnp.any(need),
                     lambda: jnp.where(need[:, None],
                                       _full_gradient_c(kind, prob, st.r),
                                       st.c),
                     lambda: st.c)
        drift_new = jnp.where(need, 0.0, st.drift)

    h = _potential_steps(kind, prob, st.beta, c, rsqr, lam0, n_scale)
    habs = jnp.abs(h)
    # certified-stale blocks: the recomputed h used a stale c — substitute
    # the conservative (< tol) bound so reporting stays an upper bound
    habs = jnp.where(use_bound[:, None], bound, habs)
    habs = jnp.where(cand[:, None], habs, 0.0)  # screened ⇒ certified zero
    # quad's state caches Ax (not a residual) — its gradient-noise scale
    # doesn't follow the ‖r‖/‖X_j‖ formula, so only the iterate term
    habs = noise_floor_mask(
        habs, st.beta,
        None if kind == "quad" else _step_noise(st.r, prob.xwnorm,
                                                st.beta.dtype))
    maxh = jnp.max(habs)
    viol = jnp.any(habs >= opt_tol, axis=1)
    active = jnp.any(st.beta != 0, axis=1) | viol
    out_st = st._replace(rsqr=rsqr, active=active, c=c, drift=drift_new)
    if count_x:
        # a check that refreshes any block reads the whole design once
        # (the dense einsum); one that refreshes none reads no X
        if kind == "quad":
            xe = jnp.float32(0.0)
        else:
            xe = (jnp.any(need).astype(jnp.float32)
                  * jnp.float32(float(prob.y.shape[0]) * nb * B))
        return out_st, maxh, xe
    return out_st, maxh


# ---------------------------------------------------------------------------
# Working-set compaction
# ---------------------------------------------------------------------------


def _compact_mode(kind, opts: CDOptions, prob: BlockedProblem, dtype) -> int:
    """Static dispatch for working-set compaction: returns the number of
    working-set blocks ``nc`` (0 = off).

    A scattered support leaves most lanes of each ``B``-wide block idle:
    an active pass over ``k`` scattered coordinates streams ``k`` whole
    column blocks for ``k`` useful columns.  Compaction gathers the
    ``compact_size`` highest-priority coordinates into a dense ``(n, C)``
    subproblem once, then iterates on that — per-pass traffic scales with
    the support, not with how it is scattered.

    Enabled only when the working set is meaningfully smaller than the
    problem (``C + B ≤ P`` guarantees the top-``C`` priorities are all real
    coordinates; auto mode additionally wants ``nb ≥ 4·nc``).  Auto mode is
    off for float64 so reference-exact trajectories are preserved.
    """
    nb, B = prob.lamw.shape
    return _compact_nc(kind, opts, nb, B, dtype)


def _compact_nc(kind, opts: CDOptions, nb: int, B: int, dtype) -> int:
    """Shape-level core of :func:`_compact_mode` (also consulted by
    ``_gram_mode`` to decide whether a full-problem Gram cache would ever
    amortize)."""
    if kind not in ("ls", "wls", "sqrt") or opts.compact is False:
        return 0
    nc = -(-opts.compact_size // B)
    if nc + 1 > nb:
        return 0
    if opts.compact is True:
        return nc
    f32ish = jnp.dtype(dtype).itemsize < 8
    return nc if (f32ish and nb >= 4 * nc) else 0


class WsCache(NamedTuple):
    """Persistent working-set cache for compaction.

    ``idx`` are the gathered coordinates (sorted), ``Xb``/``Xwb`` the dense
    gathered column blocks, ``ok`` whether the cache holds a real gather.
    The cached columns are raw reads of the immutable design, so the cache
    never goes stale — only its *coverage* can lapse, which the pass checks
    against the current support + violations each round.  It lives in the
    λ-scan / outer-loop carries (NOT in ``CDState``), so checkpoints and
    the sharded engine are unaffected; a resume simply re-gathers.
    """

    idx: jnp.ndarray            # (C,) int32, sorted ascending
    Xb: jnp.ndarray             # (nc, n, B)
    Xwb: Optional[jnp.ndarray]  # row-weighted copy (wls only), else None
    ok: jnp.ndarray             # () bool
    Kb: Optional[jnp.ndarray] = None  # (nc, B, B) gathered-block Grams
                                      # (recomputed per gather, amortized
                                      # over every inner pass) or None


def _empty_ws_cache(kind, prob: BlockedProblem, nc: int,
                    opts: CDOptions) -> WsCache:
    n = prob.y.shape[0]
    B = prob.lamw.shape[1]
    Xb = jnp.zeros((nc, n, B), prob.Xb.dtype)
    gram = _gram_mode(kind, opts, nc, B)
    return WsCache(idx=jnp.zeros((nc * B,), jnp.int32), Xb=Xb,
                   Xwb=(jnp.zeros_like(Xb) if kind == "wls" else None),
                   ok=jnp.zeros((), bool),
                   Kb=(jnp.zeros((nc, B, B), prob.Xb.dtype) if gram
                       else None))


def secant_alpha(x_new, x_k, x_km1, dtype):
    """Clipped secant ratio ``(x_new − x_k)/(x_k − x_km1)`` for warm-start
    extrapolation along a parameter schedule (λ paths, z grids).

    Shared by the single-device path, the sharded path, and the locpolyl1
    grid so the kink-clip rule lives in one place.  Zero when the two
    previous abscissae coincide (the scan carries are initialized with the
    schedule's FIRST value twice, so the first two steps — where no real
    secant exists — skip the shift instead of extrapolating from a
    fictitious point).  Clipped to [0, 2]: between-kinks exactness only
    holds locally, and a kink right after x_k must not fling the start far
    off (the solver would recover, but from a worse point than the plain
    warm start)."""
    denom = x_k - x_km1
    alpha = jnp.where(jnp.abs(denom) > 0,
                      (x_new - x_k) / jnp.where(denom == 0, 1.0, denom),
                      0.0)
    return jnp.clip(alpha, 0.0, 2.0).astype(dtype)


def _extrapolate_path_start(st: CDState, cache: WsCache, beta_prev,
                            lam_k, lam_km1, lam_new):
    """Secant extrapolation of the warm start along a λ path.

    The Lasso solution is piecewise LINEAR in λ (fixed support + signs ⇒
    β(λ) solves a linear system affine in λ), so
    ``β(λ_new) ≈ β_k + α·(β_k − β_{k−1})`` with
    ``α = (λ_new − λ_k)/(λ_k − λ_{k−1})`` is *exact* between kinks — the
    extrapolated start usually lands within rounding of the next
    solution, collapsing the inner epochs per path point.  A capability
    the reference's plain warm start lacks (lasso.jl:250-252).

    The residual for the shifted start needs ``X·Δ``; the shift's support
    lives inside the compaction working set whenever both supports are
    covered, so the update uses only the CACHED columns (no large X
    read).  If coverage fails (support moved outside the set, or no
    cache yet) the extrapolation is skipped — it is an accelerant only,
    never required: the epoch loop's certification is unaffected by the
    start.  Drift grows by ‖Δr‖ like any pass."""
    nb, B = st.beta.shape
    nc = cache.Xb.shape[0]
    dt = st.beta.dtype
    alpha = secant_alpha(lam_new, lam_k, lam_km1, dt)
    # freeze coordinates currently at 0: a coordinate that just LEFT the
    # support sits at a kink — extrapolating through it would re-enter it
    # with a flipped sign; for the Lasso it locally stays out.  This also
    # keeps the start's support exactly supp(β_k) (honest active mask).
    delta = jnp.where(st.beta != 0, st.beta - beta_prev, 0.0)
    member = (jnp.zeros((nb * B,), bool).at[cache.idx].set(True)
              .reshape(nb, B))
    covered = cache.ok & ~jnp.any((delta != 0) & ~member)

    def apply(st):
        d = alpha * delta
        bi, li = cache.idx // B, cache.idx % B
        dws = d[bi, li].reshape(nc, B)
        dr = -jnp.einsum("bnk,bk->n", cache.Xb, dws, precision=_PREC)
        beta2 = st.beta + d
        dnorm = jnp.sqrt(jnp.sum(dr * dr))
        return st._replace(beta=beta2, r=st.r + dr,
                           active=jnp.any(beta2 != 0, axis=1),
                           drift=st.drift + dnorm)

    return lax.cond(covered & (alpha > 0), apply, lambda s: s, st)


def _ws_cache_from_idx(kind, prob: BlockedProblem, nc: int,
                       opts: CDOptions, idx, ok) -> WsCache:
    """(Re)build a working-set cache from a coordinate index set — the
    gather is a deterministic function of (X, idx), which is what lets a
    checkpoint persist only ``idx``/``ok`` and still reconstruct the cache
    exactly on resume (utils/checkpoint.py)."""
    B = prob.lamw.shape[1]
    idx = jnp.asarray(idx, jnp.int32)
    bi, li = idx // B, idx % B

    def grab(Ab):
        g = Ab[bi, :, li]
        return g.reshape(nc, B, -1).transpose(0, 2, 1)

    Xb = grab(prob.Xb)
    Xwb = grab(prob.Xwb) if kind == "wls" else None
    gram = _gram_mode(kind, opts, nc, B)
    Kb = (_block_grams(Xwb if kind == "wls" else Xb, Xb) if gram else None)
    return WsCache(idx=idx, Xb=Xb, Xwb=Xwb, ok=jnp.asarray(ok, bool),
                   Kb=Kb)


def _compact_pass(kind, prob: BlockedProblem, st: CDState, lam0, n_scale,
                  opts: CDOptions, nc: int, cache: WsCache,
                  count_x: bool = False):
    """One working-set round: solve a dense ``(n, C)`` subproblem over the
    top-``C`` priority coordinates (entire support + largest stale-KKT
    steps) with the ordinary engine, and scatter the result back.

    Correctness does not depend on the working-set choice: the outer loop's
    confirming ``_full_check`` certifies global KKT (and re-activates any
    violator outside the set, which the next round then covers), exactly
    like the reference's active-set/full-pass alternation
    (coordinate_descent.jl:72-90) — the working set is just a tighter,
    lane-dense "active set".  Because every nonzero coordinate gets maximal
    priority, the gathered problem is an *exact* restriction (all excluded
    coordinates are zero, so the shared residual is consistent).

    The expensive part is the gather itself: scattered picks read strided
    columns of the blocked design, so a fresh gather costs a sizeable
    fraction of a full active pass.
    It is therefore *cached* and amortized: as long as the cached index set
    still covers the support and every (stale-bound) KKT violation, the
    round reuses the cached dense columns and reads NO large X data at all
    — which is the steady state for warm-started λ-path points.  On a
    coverage miss the set is re-gathered (needs ≥ one spare block of
    headroom over the support; dense-support regimes and rounds past
    ``compact_rounds`` fall back to the ordinary dense active pass).

    Returns ``(state, maxh, cache)`` with ``maxh = 0`` for a compact round
    so the next outer pass is always the confirming full check.  With
    ``count_x=True`` a fourth element is appended: design elements read
    this round (gather C·n on a coverage miss + the inner solve's own
    traffic over the gathered (C, n) copy; a cache-hit round reads no
    large X at all) — the production X-traffic accounting behind
    ``utils.profiling.solve_x_traffic``.
    """
    nb, B = prob.lamw.shape
    C = nc * B
    dt = st.beta.dtype
    n = prob.y.shape[0]
    key, ksub = jax.random.split(st.key)

    # stale-gradient potential steps (fresh right after the full check that
    # scheduled this pass); they only affect working-set *selection*
    h = _potential_steps(kind, prob, st.beta, st.c, st.rsqr, lam0, n_scale)
    habs = jnp.where(prob.valid, jnp.abs(h), 0.0)
    required = (st.beta != 0) | (habs >= opts.opt_tol)
    member = (jnp.zeros((nb * B,), bool).at[cache.idx].set(True)
              .reshape(nb, B))
    covered = ~jnp.any(required & ~member)
    reuse = cache.ok & covered
    nnz = jnp.sum(st.beta != 0)
    # a re-gather needs room for the support PLUS at least one block of
    # violators — a saturated working set (nnz == C) makes no progress
    use = (reuse | (nnz <= C - B)) & (st.it < 2 * opts.compact_rounds)

    def regather(_):
        big = jnp.asarray(jnp.finfo(dt).max / 8, dt)
        pri = jnp.where(st.beta != 0, big, habs)
        pri = jnp.where(prob.valid, pri, -jnp.inf)
        _, idx = lax.top_k(pri.reshape(-1), C)
        idx = jnp.sort(idx)               # gather locality + fixed order
        return _ws_cache_from_idx(kind, prob, nc, opts, idx, True)

    def compact(args):
        st, cache = args
        cache = lax.cond(reuse, lambda c: c, regather, cache)
        bi, li = cache.idx // B, cache.idx % B
        sub_prob = BlockedProblem(
            Xb=cache.Xb, Xwb=(cache.Xwb if kind == "wls" else cache.Xb),
            y=prob.y, q=None,
            adiag=prob.adiag[bi, li].reshape(nc, B),
            lamw=prob.lamw[bi, li].reshape(nc, B),
            valid=prob.valid[bi, li].reshape(nc, B),
            xwnorm=prob.xwnorm[bi, li].reshape(nc, B),
            Kb=cache.Kb)
        beta_ws = st.beta[bi, li].reshape(nc, B)
        # seed the subproblem's gradient cache from the outer cache: the
        # working set's columns are raw gathers of the same X and the
        # residual is shared, so the cached c transfers coordinate-wise;
        # a working-set block's drift is bounded by the worst source
        # block's drift (per-coordinate bound |c_exact − c|_j ≤
        # ‖Xw_j‖·drift[block(j)] stays valid under the max).  In the warm
        # steady state (outer drift ≈ 0 right after the scheduling check)
        # this lets the inner solve's first full check certify without
        # re-reading the gathered columns at all.
        sub_c = st.c[bi, li].reshape(nc, B)
        sub_drift = jnp.max(st.drift[bi].reshape(nc, B), axis=1)
        sub_st = CDState(
            beta=beta_ws, r=st.r, rsqr=st.rsqr,
            active=jnp.any(beta_ws != 0, axis=1), key=ksub,
            it=jnp.zeros((), jnp.int32), conv=jnp.ones((), bool),
            done=jnp.zeros((), bool), c=sub_c, drift=sub_drift)
        sub_opts = opts.replace(compact=False)
        if count_x:
            sub, _, xe_in = _solve_at_lambda_ws(kind, sub_opts, sub_prob,
                                                lam0, sub_st, n_scale, None,
                                                count_x=True)
            xe = jnp.where(reuse, 0.0, float(C) * float(n)) + xe_in
        else:
            sub = _solve_at_lambda(kind, sub_opts, sub_prob, lam0, sub_st,
                                   n_scale)
        beta2 = st.beta.at[bi, li].set(sub.beta.reshape(-1))
        dnorm = jnp.sqrt(jnp.sum((sub.r - st.r) ** 2))
        out = (st._replace(
            beta=beta2, r=sub.r, rsqr=sub.rsqr,
            active=jnp.any(beta2 != 0, axis=1), key=key,
            drift=st.drift + dnorm), jnp.zeros((), dt), cache)
        return out + (xe,) if count_x else out

    def dense(args):
        st, cache = args
        st2, maxh = _active_pass(kind, prob, st, lam0, n_scale,
                                 opts.randomize, opts)
        out = (st2, maxh, cache)
        if count_x:
            xe = (jnp.sum(st.active).astype(jnp.float32)
                  * jnp.float32(float(n) * B))
            out = out + (xe,)
        return out

    return lax.cond(use, compact, dense, (st, cache))


# ---------------------------------------------------------------------------
# Epoch loop and λ-continuation
# ---------------------------------------------------------------------------


def _solve_at_lambda_ws(kind, opts: CDOptions, prob: BlockedProblem, lam0,
                        st: CDState, n_scale, cache, count_x: bool = False):
    """Reference ``_coordinateDescent!`` (coordinate_descent.jl:65-92):
    alternate full/active passes until two consecutive converged passes,
    the confirming one full.  A stall detector (no ≥30% maxH improvement
    for ``stall_patience`` epochs) bounds the epochs wasted at the float32
    rounding floor when ``opt_tol`` is unreachable; it is active only for
    sub-f64 dtypes — float64 runs keep pure reference semantics.

    ``cache`` is the compaction working-set cache (``WsCache`` or ``None``)
    threaded from the caller so warm-started outer loops (λ-path, σ rounds)
    amortize the expensive column gather across solves; returns
    ``(state, cache)``, plus a design-elements-read scalar when
    ``count_x=True`` (see ``_compact_pass``; quad kind unsupported —
    its operand is (p, p))."""
    tol = opts.opt_tol
    dtype = st.beta.dtype
    patience = (opts.stall_patience
                if jnp.dtype(dtype).itemsize < 8 else jnp.iinfo(jnp.int32).max)
    nc = _compact_mode(kind, opts, prob, dtype)
    if not nc:
        cache = None
    if count_x and kind == "quad":
        raise ValueError("count_x unsupported for the quad kind")
    nb, B = prob.lamw.shape
    n_rows = prob.y.shape[0] if kind != "quad" else nb * B

    def cond(c):
        s, cache, best, stall = c[:4]
        return jnp.logical_and(~s.done, s.it < opts.max_iter)

    def body(c):
        s, cache, best, stall = c[:4]
        was_full = s.conv

        def full(args):
            s, cache = args
            if count_x:
                s2, maxh, xe = _full_check(kind, prob, s, lam0, n_scale,
                                           tol, opts, count_x=True)
                return (s2, maxh, cache, xe)
            s2, maxh = _full_check(kind, prob, s, lam0, n_scale, tol, opts)
            return (s2, maxh, cache)

        def act(args):
            s, cache = args
            if nc:
                return _compact_pass(kind, prob, s, lam0, n_scale, opts, nc,
                                     cache, count_x=count_x)
            s2, maxh = _active_pass(kind, prob, s, lam0, n_scale,
                                    opts.randomize, opts)
            out = (s2, maxh, cache)
            if count_x:
                out = out + (jnp.sum(s.active).astype(jnp.float32)
                             * jnp.float32(float(n_rows) * B),)
            return out

        if count_x:
            s2, maxh, cache, dxe = lax.cond(was_full, full, act, (s, cache))
        else:
            s2, maxh, cache = lax.cond(was_full, full, act, (s, cache))
        conv = maxh < tol
        # stall accounting uses FULL-check maxh only — the certified
        # order-independent measure.  Active-pass maxh is trajectory noise:
        # it hits exact 0 whenever the current active set is quiescent
        # (which would poison a running best forever even though the next
        # full check reveals fresh violations), and slow-but-real decay
        # (sqrt-lasso at large λ: <1%/pass) must not false-trigger either.
        # At the f32 rounding floor, consecutive full checks repeat the
        # same sub-tol-but-not-quite maxh and the counter runs out.
        improved = was_full & (maxh < best)
        stall = jnp.where(was_full,
                          jnp.where(improved, 0, stall + 1), stall)
        best = jnp.where(was_full, jnp.minimum(best, maxh), best)
        done = (was_full & conv) | (stall >= patience)
        out = (s2._replace(it=s.it + 1, conv=conv, done=done), cache,
               best, stall)
        if count_x:
            out = out + (c[4] + dxe,)
        return out

    st = st._replace(it=jnp.zeros((), jnp.int32),
                     conv=jnp.ones((), bool),      # first pass is full
                     done=jnp.zeros((), bool))
    if nc and cache is None:
        cache = _empty_ws_cache(kind, prob, nc, opts)
    init = (st, cache, jnp.asarray(jnp.inf, dtype),
            jnp.zeros((), jnp.int32))
    if count_x:
        st, cache, _, _, xe = lax.while_loop(cond, body,
                                             init + (jnp.float32(0.0),))
        return st, cache, xe
    st, cache, _, _ = lax.while_loop(cond, body, init)
    return st, cache


def _solve_at_lambda(kind, opts: CDOptions, prob: BlockedProblem, lam0,
                     st: CDState, n_scale) -> CDState:
    """Single-solve wrapper around ``_solve_at_lambda_ws`` (no working-set
    cache carried across calls)."""
    st, _ = _solve_at_lambda_ws(kind, opts, prob, lam0, st, n_scale, None)
    return st


def _init_state(kind, prob: BlockedProblem, beta_b, key) -> CDState:
    """Reference ``initialize!``: recompute residuals (or Ax) from scratch
    (cd_differentiable_function.jl:59-72, :311-320)."""
    if kind == "quad":
        r = jnp.einsum("bpk,bk->p", prob.Xb, beta_b, precision=_PREC)
    else:
        r = prob.y - jnp.einsum("bnk,bk->n", prob.Xb, beta_b,
                                precision=_PREC)
    rsqr = (jnp.dot(r, r, precision=_PREC) if kind == "sqrt"
            else jnp.zeros((), r.dtype))
    active = jnp.any(beta_b != 0, axis=1)
    nb = beta_b.shape[0]
    return CDState(beta=beta_b, r=r, rsqr=rsqr, active=active, key=key,
                   it=jnp.zeros((), jnp.int32), conv=jnp.ones((), bool),
                   done=jnp.zeros((), bool),
                   c=jnp.zeros_like(beta_b),
                   # large finite sentinel: the zero-initialized cache is
                   # invalid, every block needs a refresh (inf would poison
                   # the screening arithmetic via inf·0 = nan)
                   drift=jnp.full((nb,), 1e30, beta_b.dtype))


def _lambda_max(kind, prob: BlockedProblem, st: CDState, n_scale):
    """Smallest λ0 zeroing the solution: ``max_k |∇_k f(0)| / λw_k``
    (reference ``_findLambdaMax``, coordinate_descent.jl:118-149)."""
    c = _full_gradient_c(kind, prob, st.r)
    if kind == "ls" or kind == "wls":
        g = jnp.abs(c) / n_scale
    elif kind == "sqrt":
        g = jnp.abs(c) / jnp.sqrt(jnp.maximum(st.rsqr, 1e-30))
    else:  # quad: gradient at 0 is q; c = -(Ax + q) with Ax = 0
        g = jnp.abs(c)
    t = jnp.where(prob.valid, g / prob.lamw, 0.0)
    return jnp.max(t)


def solve_blocked(kind: str, opts: CDOptions, prob: BlockedProblem, lam0,
                  beta0_b, key, count_x: bool = False) -> CDState:
    """Reference ``coordinateDescent!`` (coordinate_descent.jl:7-39):
    warm start from ``beta0`` or zero-start with log-spaced λ-continuation.
    ``count_x=True`` appends the design-elements-read accounting scalar
    (``utils.profiling.solve_x_traffic``)."""
    dtype = beta0_b.dtype
    if kind == "quad":
        n_scale = jnp.asarray(1.0, dtype)
    else:
        n_scale = jnp.asarray(prob.y.shape[0], dtype)
    lam0 = jnp.asarray(lam0, dtype)

    if opts.warm_start:
        st = _init_state(kind, prob, beta0_b, key)
        if count_x:
            st, _, xe = _solve_at_lambda_ws(kind, opts, prob, lam0, st,
                                            n_scale, None, count_x=True)
            return st, xe
        return _solve_at_lambda(kind, opts, prob, lam0, st, n_scale)

    # cold start: β = 0, then λmax → λ0 continuation
    st = _init_state(kind, prob, jnp.zeros_like(beta0_b), key)
    lammax = _lambda_max(kind, prob, st, n_scale)
    # log-spaced schedule, num_steps+1 points inclusive
    # (coordinate_descent.jl:29-36)
    ts = jnp.linspace(jnp.log(lammax), jnp.log(lam0), opts.num_steps + 1)
    lams = jnp.exp(ts)

    # the compaction working-set cache rides the continuation carry: the
    # support only grows as λ falls, so most steps reuse one gather
    nc = _compact_mode(kind, opts, prob, dtype)
    cache0 = _empty_ws_cache(kind, prob, nc, opts) if nc else None
    # secant extrapolation across continuation steps (same accelerant as
    # the lasso_path scan, _extrapolate_path_start); residual-form kinds
    # only — quad's CDState.r caches Ax, not a residual
    extrap = (nc and resolve_extrapolate(opts, True)
              and kind in ("ls", "wls", "sqrt"))

    def scan_body(carry, lam):
        s, cache, beta_prev, lam_k, lam_km1, xe = carry
        beta_k = s.beta
        if extrap:
            s = _extrapolate_path_start(s, cache, beta_prev, lam_k,
                                        lam_km1, lam)
        if count_x:
            s, cache, dxe = _solve_at_lambda_ws(kind, opts, prob, lam, s,
                                                n_scale, cache, count_x=True)
            xe = xe + dxe
        else:
            s, cache = _solve_at_lambda_ws(kind, opts, prob, lam, s,
                                           n_scale, cache)
        return (s, cache, beta_k, lam, lam_k, xe), None

    # both abscissa carries start at the first schedule value so the first
    # two steps skip the shift (secant_alpha)
    (st, _, _, _, _, xe), _ = lax.scan(
        scan_body, (st, cache0, st.beta, lams[0], lams[0],
                    jnp.float32(0.0)), lams)
    return (st, xe) if count_x else st


# ---------------------------------------------------------------------------
# Public driver
# ---------------------------------------------------------------------------


def _unblock(beta_b, p):
    return beta_b.reshape(-1)[:p]


def _to_blocked_beta(beta0, B):
    P = -(-beta0.shape[0] // B) * B
    return _pad_to_blocks(beta0, B).reshape(P // B, B)


@functools.partial(jax.jit, static_argnames=("kind", "opts"))
def _cd_ls_core(kind, opts, X, y, w, lam0, lamw, beta0, key):
    prob = build_blocked(kind, opts, lamw, X=X, y=y, w=w)
    st = solve_blocked(kind, opts, prob, lam0,
                       _to_blocked_beta(beta0, opts.block_size), key)
    return _unblock(st.beta, beta0.shape[0]), st.r, st.it


@functools.partial(jax.jit, static_argnames=("opts",))
def _cd_quad_core(opts, A, q, lam0, lamw, beta0, key):
    prob = build_blocked("quad", opts, lamw, A=A, q=q)
    st = solve_blocked("quad", opts, prob, lam0,
                       _to_blocked_beta(beta0, opts.block_size), key)
    return _unblock(st.beta, beta0.shape[0]), st.r, st.it


def coordinate_descent(beta0, loss, penalty, options: CDOptions = CDOptions(),
                       *, seed: int = 0, key=None):
    """Minimize ``f(β) + Σ_j λ0 λw_j |β_j|``.

    Functional analogue of the reference's ``coordinateDescent!``
    (coordinate_descent.jl:7-60): returns ``(beta, residuals)`` instead of
    mutating a ``SparseIterate``.  ``residuals`` is ``y − Xβ`` for the
    regression losses and ``Aβ`` for ``QuadraticLoss``.

    ``penalty`` is a ``ProxL1`` (optionally weighted), ``ProxZero``, or a
    ``ProxL1Group`` (equal-size group atoms — the reference driver's
    ``AtomIterate`` acceptance, coordinate_descent.jl:8; routed to the
    group engine, ops/group_cd.py).
    """
    if isinstance(penalty, ProxL1Group):
        from .group_cd import group_coordinate_descent

        return group_coordinate_descent(beta0, loss, penalty, options,
                                        seed=seed, key=key)
    p = beta0.shape[0]
    from .losses import num_coordinates
    if num_coordinates(loss) != p:
        raise ValueError("dimension mismatch between beta0 and loss")
    if isinstance(penalty, ProxL1) and penalty.weights is not None:
        if jnp.shape(penalty.weights) != (p,):
            raise ValueError("penalty weight vector has wrong length")
    if key is None:
        key = jax.random.PRNGKey(seed)

    if isinstance(penalty, ProxZero):
        # Reference coordinate_descent.jl:41-60: the unpenalized overload
        # never does λ-continuation — warm-start solves from beta0,
        # cold-start zeroes beta first, then a single solve either way.
        if not options.warm_start:
            beta0 = jnp.zeros_like(beta0)
        options = options.replace(warm_start=True)

    if isinstance(loss, QuadraticLoss):
        dtype = loss.b.dtype
        lam0, lamw = as_l1(penalty, p, dtype)
        beta0 = jnp.asarray(beta0, dtype)
        beta, r, _ = _cd_quad_core(options, loss.A, loss.b, lam0, lamw,
                                   beta0, key)
        return beta, r

    dtype = loss.X.dtype
    lam0, lamw = as_l1(penalty, p, dtype)
    beta0 = jnp.asarray(beta0, dtype)
    kind = loss.kind
    w = loss.w if isinstance(loss, WeightedLSLoss) else None
    if w is None:
        w = jnp.ones((loss.X.shape[0],), dtype)  # unused for ls/sqrt
    beta, r, _ = _cd_ls_core(kind, options, loss.X, loss.y, w, lam0, lamw,
                             beta0, key)
    return beta, r
