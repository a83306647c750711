"""Feature-sharded (multi-chip) block-coordinate descent.

The reference is single-threaded and single-process (SURVEY.md §2.5); its
serial axes — the feature dimension p, the λ-path, the evaluation grid — are
exactly what a multi-device mesh parallelizes.  This module implements the
feature-dimension sharding story (SURVEY.md §5.8 / §7 delta 7):

- Mesh axis ``'feature'``: the columns of ``X`` are partitioned across
  devices with ``PartitionSpec(None, 'feature')``; each device owns a
  contiguous column block of ``X`` (and the matching slices of the penalty
  weights and β).  ``X`` is never replicated — this is the "long axis"
  scaling mechanism.
- ``y`` and the residual vector ``r`` are replicated.  Each active-set pass,
  every shard runs exact within-shard sequential block CD on its own columns
  against the shared residual, producing a local residual correction
  ``Δr_s = −X_s Δβ_s``; one ``psum`` over the mesh merges them:
  ``r ← r + Σ_s Δr_s``.  This is the lifted, distributed form of the
  reference's rank-1 residual refresh (cd_differentiable_function.jl:107-109).
- Scalar consensus reductions ride the same axis: ``λ_max`` and the
  convergence certificate ``maxH`` are ``pmax`` (coordinate_descent.jl:118-149,
  :83-89), and σ for Scaled-Lasso is computed from the replicated residual so
  every shard agrees without extra communication (lasso.jl:134).

Convergence semantics.  Within one pass, shards update concurrently
(block-Jacobi across shards, exact sequential CD within a shard).  The
fixed points are identical to sequential CD — convergence is declared by the
same order-independent vectorized KKT sweep as the single-device engine
(``_full_check``), so a converged sharded solve satisfies exactly the same
certificate as a converged single-device solve and the solutions agree to
solver tolerance (verified by the single-device-vs-sharded equivalence tests
on the 8-device CPU mesh, SURVEY.md §4 test mapping (b)).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.block_cd import (
    _PREC,
    BlockedProblem,
    CDState,
    _active_pass,
    _block_grams,
    _compact_mode,
    _compact_pass,
    _empty_ws_cache,
    _full_check,
    _gram_mode,
    _lambda_max,
    _potential_steps,
    _solve_at_lambda,
    _to_blocked_beta,
    build_blocked,
    secant_alpha,
)
from ..ops.losses import LeastSquaresLoss, SqrtLassoLoss, WeightedLSLoss
from ..ops.prox import ProxL1, ProxZero, as_l1
from ..utils.options import (CDOptions, IterLassoOptions, auto_batch_lanes,
                             resolve_extrapolate)
from ..utils.helpers import sample_std, find_init_sigma


# ---------------------------------------------------------------------------
# In-shard collective pass primitives
# ---------------------------------------------------------------------------


def _sharded_extrapolate_start(st: CDState, cache, beta_prev, lam_k,
                               lam_km1, lam_new, axis):
    """Sharded twin of ``block_cd._extrapolate_path_start``: secant-shift
    the warm start along the λ path using only the shard's cached
    working-set columns.  Two deltas from the single-device version:
    ``covered`` is the all-shard AND (gathered, so every shard takes the
    same branch) and the residual correction is the psum of the local
    ``−X_s Δβ_s`` corrections (the replicated r tracks the global fit)."""
    nb, B = st.beta.shape
    nc = cache.Xb.shape[0]
    dt = st.beta.dtype
    alpha = secant_alpha(lam_new, lam_k, lam_km1, dt)
    delta = jnp.where(st.beta != 0, st.beta - beta_prev, 0.0)
    member = (jnp.zeros((nb * B,), bool).at[cache.idx].set(True)
              .reshape(nb, B))
    covered_local = cache.ok & ~jnp.any((delta != 0) & ~member)
    covered = jnp.all(lax.all_gather(covered_local, axis))

    def apply(st):
        d = alpha * delta
        bi, li = cache.idx // B, cache.idx % B
        dws = d[bi, li].reshape(nc, B)
        dr = lax.psum(
            -jnp.einsum("bnk,bk->n", cache.Xb, dws, precision=_PREC), axis)
        beta2 = st.beta + d
        dnorm = jnp.sqrt(jnp.sum(dr * dr))
        return st._replace(beta=beta2, r=st.r + dr,
                           active=jnp.any(beta2 != 0, axis=1),
                           drift=st.drift + dnorm)

    return lax.cond(covered & (alpha > 0), apply, lambda s: s, st)


def _sharded_objective(kind, prob, r, beta_b, lam0, n_scale, w, axis):
    """Global objective ``f(β) + λ0 Σ λw_j |β_j|`` from the replicated
    residual plus a psum of the local penalty contributions.  ``f`` must
    be EXACTLY the functional whose coordinate minimizers the engine
    implements — the safeguard's t=1-vs-1/D comparison and its convexity
    descent guarantee are meaningless against any other normalization:
    ``‖r‖²/(2n)`` for ls/wls (block_cd._ls_candidate's n·λ scale) and
    plain ``‖r‖`` for sqrt (the λ·‖r‖ zero rule of _sqrt_candidate;
    NOT ‖r‖/√n, which would over-weight the penalty by √n here)."""
    _P = lax.Precision.HIGHEST
    pen = lam0 * lax.psum(jnp.sum(prob.lamw * jnp.abs(beta_b)), axis)
    if kind == "ls":
        f = jnp.dot(r, r, precision=_P) / (2.0 * n_scale)
    elif kind == "wls":
        f = jnp.dot(w * r, r, precision=_P) / (2.0 * n_scale)
    else:  # sqrt
        f = jnp.sqrt(jnp.maximum(jnp.dot(r, r, precision=_P), 0.0))
    return f + pen


def _sharded_union_compact_pass(kind, prob, st: CDState, lam0, n_scale,
                                opts, nc: int, axis, n_shards: int):
    """Replicated UNION working-set round — the sharded analogue of
    ``block_cd._compact_pass`` that removes the block-Jacobi coupling
    penalty entirely.

    The per-shard Jacobi round (below) solves each shard's columns with
    the others frozen and merges by a safeguarded step: correct, but its
    convergence rate pays the cross-shard coupling — measured 13 outer
    epochs at 2 shards vs 5 single-device on an uncoupled Gaussian
    design, i.e. the sharded tier did ~1.3× the single-device WORK and
    strong scaling was capped at ~0.77 before any communication cost.
    Here instead every shard computes the same global top-C priority set
    (distributed top-k: local top-Cl → all_gather → top-C, identical on
    every shard — the ``lasso_path_sharded`` refinement's pattern), the
    union columns are psum-assembled into a REPLICATED (C, n) set from
    their owner shards, and every shard runs the identical restricted
    ``_solve_at_lambda`` on it — jointly over all shards' coordinates,
    so no coupling remains and the outer epoch count matches the
    single-device engine.  The replicated residual needs NO merge psum
    (all shards computed the same one), and correctness is inherited
    from the same argument as the single-device compact pass: the outer
    confirming sharded full check certifies global KKT regardless of the
    working-set choice.

    Priorities mirror ``_compact_pass`` (support coordinates maximal,
    then stale-KKT steps) from the shard-local cached gradient; callers
    gate on global-support headroom ``nnz_g ≤ C − B`` and the
    ``compact_rounds`` epoch cap exactly like the single-device ``use``
    rule.  Collective cost per round: one (C,)-sized top-k gather and
    one (C, n) psum (~C·n·4 bytes) — amortizable later with a
    replicated cache, but already far cheaper than the epochs it saves.
    Returns ``(state, maxh=0)``.
    """
    nb, B = prob.lamw.shape
    chunk = nb * B
    dt = st.beta.dtype
    C = nc * B
    Cl = min(C, chunk)
    s_idx = lax.axis_index(axis)
    key, ksub = jax.random.split(st.key)

    # ---- global top-C priority set (identical on every shard) ----
    h = _potential_steps(kind, prob, st.beta, st.c, st.rsqr, lam0, n_scale)
    habs = jnp.where(prob.valid, jnp.abs(h), 0.0)
    big = jnp.asarray(jnp.finfo(dt).max / 8, dt)
    pri = jnp.where(st.beta != 0, big, habs)
    pri = jnp.where(prob.valid, pri, -jnp.inf).reshape(-1)
    vloc, iloc = lax.top_k(pri, Cl)
    gidx = iloc + s_idx * chunk
    vg = lax.all_gather(vloc, axis).reshape(-1)
    ig = lax.all_gather(gidx, axis).reshape(-1)
    _, sel = lax.top_k(vg, C)
    idx = jnp.sort(ig[sel])                        # (C,) global, replicated

    # ---- psum-assemble the replicated restricted problem ----
    loc = idx - s_idx * chunk
    owned = (loc >= 0) & (loc < chunk)
    locc = jnp.clip(loc, 0, chunk - 1)
    bi, li = locc // B, locc % B
    ownf = owned.astype(dt)

    def grab_cols(Ab):
        g = Ab[bi, :, li] * ownf[:, None]          # (C, n) owner-only
        g = lax.psum(g, axis)                      # replicated
        return g.reshape(nc, B, -1).transpose(0, 2, 1)   # (nc, n, B)

    def grab_vec(vb, fill):
        v = lax.psum(vb[bi, li] * ownf, axis)
        return jnp.where(owned_any, v, fill).reshape(nc, B)

    owned_any = lax.psum(ownf, axis) > 0           # real (non-pad) slot
    Xs = grab_cols(prob.Xb)
    Xws = grab_cols(prob.Xwb) if kind == "wls" else Xs
    valid_s = (lax.psum((prob.valid[bi, li] & owned).astype(dt), axis)
               > 0).reshape(nc, B)
    sub_prob = BlockedProblem(
        Xb=Xs, Xwb=Xws, y=prob.y, q=None,
        adiag=grab_vec(prob.adiag, 0.0),
        lamw=grab_vec(prob.lamw, 1.0),
        valid=valid_s,
        xwnorm=grab_vec(prob.xwnorm, 0.0),
        Kb=(_block_grams(Xws, Xs)
            if _gram_mode(kind, opts, nc, B) else None))
    beta_ws = grab_vec(st.beta, 0.0)
    sub_c = grab_vec(st.c, 0.0)
    # per-working-block drift = worst member column's owner-block drift
    # (same per-coordinate bound argument as _compact_pass)
    drift_col = lax.psum(st.drift[bi] * ownf, axis)
    sub_drift = jnp.max(drift_col.reshape(nc, B), axis=1)
    sub_st = CDState(
        beta=beta_ws, r=st.r, rsqr=st.rsqr,
        active=jnp.any(beta_ws != 0, axis=1), key=ksub,
        it=jnp.zeros((), jnp.int32), conv=jnp.ones((), bool),
        done=jnp.zeros((), bool), c=sub_c, drift=sub_drift)

    # every shard runs the IDENTICAL restricted solve on identical
    # (post-collective) operands → bitwise-identical replicated result
    sub = _solve_at_lambda(kind, opts.replace(compact=False), sub_prob,
                           lam0, sub_st, n_scale)

    # ---- scatter owned coordinates back; residual needs no merge ----
    bs = sub.beta.reshape(-1)                      # (C,)
    loc_safe = jnp.where(owned, locc, chunk)       # OOB → dropped
    beta2 = (st.beta.reshape(-1).at[loc_safe].set(bs, mode="drop")
             .reshape(nb, B))
    dnorm = jnp.sqrt(jnp.sum((sub.r - st.r) ** 2))
    st2 = st._replace(beta=beta2, r=sub.r, rsqr=sub.rsqr,
                      active=jnp.any(beta2 != 0, axis=1), key=key,
                      drift=st.drift + dnorm)
    return st2, jnp.zeros((), dt)


def _sharded_active_pass(kind, prob, st: CDState, lam0, n_scale, randomize,
                         axis, n_shards: int, w=None, opts=None,
                         nc: int = 0, cache=None):
    """One concurrent pass: exact sequential block CD within each shard,
    block-Jacobi across shards, merged by one residual psum.

    Concurrent shards can overshoot on cross-shard-correlated columns
    (each computes its exact block step assuming the others are frozen), so
    the merged step is safeguarded: take the full merged step ``t=1`` if it
    decreases the global objective more than the averaged step ``t=1/D`` —
    which *always* decreases it: each shard's own sequential block pass is
    monotone for the shard's coordinates, and by convexity
    ``P(β + (1/D)·Σ_s Δ_s) ≤ (1/D)·Σ_s P(β + Δ_s) ≤ P(β)``.
    The fixed points are unchanged (Δ = 0 ⟺ per-shard KKT), and final
    convergence is certified by the order-independent KKT sweep either way.

    With ``nc > 0`` (working-set compaction, CDOptions.compact) the
    shard-local proposal comes from a compact working-set round
    (block_cd._compact_pass) over the shard's own columns instead of a
    dense pass: each shard solves its gathered dense subproblem against the
    replicated residual (others frozen — the same frozen-shard premise),
    which both cuts per-shard HBM traffic on scattered supports and
    replaces many per-pass psum merges with one merge per inner solve.
    The safeguard, exact-zero snap, and KKT certification are unchanged.
    Returns ``(state, maxh, cache)``.
    """
    def _jacobi(st, cache):
        r0, beta0_b = st.r, st.beta
        if nc:
            # screen=False: gap-safe screening's dual certificate assumes the
            # residual is y − X_restricted·β_restricted, but other shards'
            # frozen nonzero coefficients make the shard-local subproblem's
            # effective response y_eff = y − X_other·β_other ≠ y — the safe
            # rule would not be safe here.  The single-device compact path
            # keeps screening (its restriction is exact).
            st2, maxh, cache = _compact_pass(kind, prob, st, lam0, n_scale,
                                             opts.replace(screen=False), nc,
                                             cache)
        else:
            st2, maxh = _active_pass(kind, prob, st, lam0, n_scale, randomize,
                                     opts)
        dbeta = st2.beta - beta0_b
        # Δr_s = local residual drift = −X_s Δβ_s ; merge all shards' corrections
        dr = lax.psum(st2.r - r0, axis)
        maxh = lax.pmax(maxh, axis)

        if n_shards > 1:
            def at(t):
                return r0 + t * dr, beta0_b + t * dbeta

            p_full = _sharded_objective(kind, prob, *at(1.0), lam0, n_scale,
                                        w, axis)
            tavg = 1.0 / n_shards
            p_avg = _sharded_objective(kind, prob, *at(tavg), lam0, n_scale, w,
                                       axis)
            # third candidate: the EXACT minimizer of the smooth part along
            # the merged direction.  ``r(t) = r0 + t·dr`` is affine, so the
            # (weighted) L2 term is an exact quadratic with minimizer
            # ``t* = −⟨r0, dr⟩_w / ‖dr‖²_w`` (sqrt-lasso's ‖r‖ has the same
            # minimizer).  Without it the merge alternated between overshoot
            # (t=1 rejected) and the 1/D crawl — measured 21 epochs at 2
            # shards vs 5 single-device on an uncoupled Gaussian design; the
            # quadratic candidate restores near-single-device epoch counts.
            # The penalty term is ignored in t* — harmless, because t* is
            # only ever TAKEN when its measured total objective wins, and
            # the convexity argument for t=1/D keeps global convergence.
            rw = r0 if w is None else r0 * w
            drw = dr if w is None else dr * w
            tq = jnp.clip(
                -jnp.dot(rw, dr, precision=lax.Precision.HIGHEST)
                / jnp.maximum(jnp.dot(drw, dr,
                                      precision=lax.Precision.HIGHEST),
                              jnp.asarray(1e-30, r0.dtype)),
                tavg, 1.0)
            p_q = _sharded_objective(kind, prob, *at(tq), lam0, n_scale, w,
                                     axis)
            # note: maxh stays the *undamped* proposal magnitude — honest
            # progress measure for the stall detector, and conservative for
            # the convergence flags (a damped pass never declares conv early)
            # argmin over {1, t*, 1/D}, larger t on ties
            # ULP slack: near the optimum the three candidate objectives
            # agree to f32 rounding, and a strict comparison then picks the
            # damped step on 1-ulp noise — measured: a ×0.5 step-halving
            # limit cycle that inflated 5 single-device epochs to 21 at two
            # shards.  Prefer the larger step unless it measurably loses
            # (more than the objective evaluation's own rounding); step
            # SELECTION cannot affect correctness — convergence is declared
            # only by the order-independent KKT sweep.
            slack = (4.0 * jnp.finfo(r0.dtype).eps
                     * jnp.maximum(jnp.abs(p_full), jnp.abs(p_avg)))
            t = jnp.where(p_full <= jnp.minimum(p_q, p_avg) + slack, 1.0,
                          jnp.where(p_q <= p_avg + slack, tq, tavg))
            r_new, beta_new = at(t)
            # Exact-sparsity snap: a damped merge leaves ``β0·(1−t)`` dust on
            # coordinates whose exact per-shard proposal was 0 — the KKT sweep
            # would then converge (|h| < tol) with β ≠ 0, inflating the nnz
            # used by the ``max_hat_s`` early stop and breaking the exact-zero
            # semantics the single-device prox preserves.  Once the dust is
            # inside the tolerance ball, zero it and correct the replicated
            # residual (a perturbation of the same order as the tolerance).
            # Dust above tol keeps maxH ≥ ~tol via its own potential step, so
            # convergence is not declared while un-snapped dust remains.
            snap_tol = opts.opt_tol if opts is not None else 0.0
            delta = jnp.where((st2.beta == 0) & (jnp.abs(beta_new) <= snap_tol),
                              beta_new, 0.0)
            beta_new = beta_new - delta
            corr = lax.cond(
                jnp.any(delta != 0),
                lambda: jnp.einsum("bnk,bk->n", prob.Xb, delta,
                                   precision=lax.Precision.HIGHEST),
                lambda: jnp.zeros_like(r_new))
            r_new = r_new + lax.psum(corr, axis)
        else:
            r_new, beta_new = r0 + dr, beta0_b + dbeta

        # drift accounting must reflect the FINAL merged residual, not the
        # local pre-merge one _active_pass saw
        dnorm = jnp.sqrt(jnp.sum((r_new - r0) ** 2))
        st2 = st2._replace(r=r_new, beta=beta_new,
                           active=jnp.any(beta_new != 0, axis=1),
                           drift=st.drift + dnorm)
        if kind == "sqrt":
            st2 = st2._replace(
                rsqr=jnp.dot(r_new, r_new, precision=lax.Precision.HIGHEST))
        return st2, maxh, cache

    # union-round capacity is gated on the GLOBAL padded width, not the
    # per-shard compaction decision `nc` (which turns off exactly when
    # shards are small — the regime where the Jacobi crawl hurts most:
    # measured 30 epochs vs 3 single-device at 8 shards × 4 local
    # blocks).  All dtypes: the sharded trajectory is never the
    # reference-sequential one anyway, and correctness is certified by
    # the KKT sweep regardless of the working-set choice.
    nc_u = 0
    if kind in ("ls", "wls", "sqrt") and opts is not None             and opts.compact is not False and n_shards > 1:
        Bb = prob.lamw.shape[1]
        ncand = -(-opts.compact_size // Bb)
        if ncand + 1 <= prob.lamw.shape[0] * n_shards:
            nc_u = ncand
    if nc_u:
        # replicated union-working-set round when the global support
        # fits: single-device epoch counts instead of the Jacobi
        # coupling crawl (see _sharded_union_compact_pass); the Jacobi
        # round remains the dense-support / late-round fallback and the
        # two branches return identical pytrees
        Bb = prob.lamw.shape[1]
        Cg = nc_u * Bb
        nnzg = lax.psum(jnp.sum(st.beta != 0), axis)
        use_union = ((nnzg <= Cg - Bb)
                     & (st.it < 2 * opts.compact_rounds))

        def _union(args):
            st_, cache_ = args
            st2_, mh_ = _sharded_union_compact_pass(
                kind, prob, st_, lam0, n_scale, opts, nc_u, axis,
                n_shards)
            return st2_, mh_, cache_

        def _jac(args):
            st_, cache_ = args
            return _jacobi(st_, cache_)

        return lax.cond(use_union, _union, _jac, (st, cache))
    return _jacobi(st, cache)


def _sharded_full_check(kind, prob, st: CDState, lam0, n_scale, opt_tol,
                        axis):
    """Vectorized KKT sweep: each shard checks its own coordinates against
    the replicated residual; the certificate is the pmax over shards."""
    st2, maxh = _full_check(kind, prob, st, lam0, n_scale, opt_tol)
    return st2, lax.pmax(maxh, axis)


def _sharded_solve_at_lambda(kind, opts: CDOptions, prob, lam0, st: CDState,
                             n_scale, axis, n_shards: int = 1,
                             w=None, cache=None):
    """Distributed form of the reference ``_coordinateDescent!`` epoch loop
    (coordinate_descent.jl:65-92): alternate full KKT sweeps and concurrent
    active passes until two consecutive converged passes (full confirming).
    All convergence scalars are replicated across shards (post-pmax), so the
    ``while_loop`` trips identically on every device.

    ``cache`` is the per-shard compaction working-set cache (``WsCache`` or
    ``None``) threaded from the caller so warm-started outer loops amortize
    the gather across λ points — the sharded mirror of
    block_cd._solve_at_lambda_ws.  Returns ``(state, cache)``."""
    tol = opts.opt_tol
    dtype = st.beta.dtype
    patience = (opts.stall_patience
                if jnp.dtype(dtype).itemsize < 8 else jnp.iinfo(jnp.int32).max)
    nc = _compact_mode(kind, opts, prob, dtype)
    if not nc:
        cache = None
    elif cache is None:
        cache = _empty_ws_cache(kind, prob, nc, opts)

    def cond(c):
        s, cache, best, stall = c
        return jnp.logical_and(~s.done, s.it < opts.max_iter)

    def body(c):
        s, cache, best, stall = c
        was_full = s.conv

        def full(args):
            s, cache = args
            s2, maxh = _sharded_full_check(kind, prob, s, lam0, n_scale,
                                           tol, axis)
            return s2, maxh, cache

        def act(args):
            s, cache = args
            return _sharded_active_pass(kind, prob, s, lam0, n_scale,
                                        opts.randomize, axis, n_shards, w,
                                        opts, nc, cache)

        s2, maxh, cache = lax.cond(was_full, full, act, (s, cache))
        # maxh is already noise-floor-masked per coordinate inside
        # _full_check (block_cd.noise_floor_mask) and pmax'd, so the
        # criterion is shard-consistent as-is
        conv = maxh < tol
        # full-check-only stall accounting — same rationale as the
        # single-device loop (block_cd._solve_at_lambda): active-pass maxh
        # is trajectory noise, the certified full-check measure is not
        improved = was_full & (maxh < best)
        stall = jnp.where(was_full,
                          jnp.where(improved, 0, stall + 1), stall)
        best = jnp.where(was_full, jnp.minimum(best, maxh), best)
        done = (was_full & conv) | (stall >= patience)
        return (s2._replace(it=s.it + 1, conv=conv, done=done), cache,
                best, stall)

    st = st._replace(it=jnp.zeros((), jnp.int32),
                     conv=jnp.ones((), bool),
                     done=jnp.zeros((), bool))
    init = (st, cache, jnp.asarray(jnp.inf, dtype),
            jnp.zeros((), jnp.int32))
    st, cache, _, _ = lax.while_loop(cond, body, init)
    return st, cache


def _sharded_init_state(kind, prob, beta_b, key,
                        axis: str = "feature") -> CDState:
    """Residual re-initialization with a cross-shard psum of each shard's
    partial prediction: ``r = y − Σ_s X_s β_s``
    (reference ``initialize!``, cd_differentiable_function.jl:59-72)."""
    pred = jnp.einsum("bnk,bk->n", prob.Xb, beta_b,
                      precision=lax.Precision.HIGHEST)
    r = prob.y - lax.psum(pred, axis)
    rsqr = (jnp.dot(r, r, precision=lax.Precision.HIGHEST)
            if kind == "sqrt" else jnp.zeros((), r.dtype))
    active = jnp.any(beta_b != 0, axis=1)
    return CDState(beta=beta_b, r=r, rsqr=rsqr, active=active, key=key,
                   it=jnp.zeros((), jnp.int32), conv=jnp.ones((), bool),
                   done=jnp.zeros((), bool),
                   c=jnp.zeros_like(beta_b),
                   drift=jnp.full((beta_b.shape[0],), 1e30, beta_b.dtype))


def solve_blocked_sharded(kind: str, opts: CDOptions, prob, lam0, beta0_b,
                          key, axis: str = "feature", n_shards: int = 1,
                          w=None) -> CDState:
    """Sharded analogue of ``solve_blocked`` (block_cd.py): warm start or
    λ-continuation (coordinate_descent.jl:7-39) with pmax'd λ_max."""
    dtype = beta0_b.dtype
    n_scale = jnp.asarray(prob.y.shape[0], dtype)
    lam0 = jnp.asarray(lam0, dtype)

    if opts.warm_start:
        st = _sharded_init_state(kind, prob, beta0_b, key, axis)
        st, _ = _sharded_solve_at_lambda(kind, opts, prob, lam0, st,
                                         n_scale, axis, n_shards, w)
        return st

    st = _sharded_init_state(kind, prob, jnp.zeros_like(beta0_b), key, axis)
    lammax = lax.pmax(_lambda_max(kind, prob, st, n_scale), axis)
    ts = jnp.linspace(jnp.log(lammax), jnp.log(lam0), opts.num_steps + 1)
    lams = jnp.exp(ts)

    # the per-shard compaction working-set cache rides the continuation
    # carry (same amortization as block_cd.solve_blocked), and the warm
    # start is secant-shifted across steps like the single-device twin
    nc = _compact_mode(kind, opts, prob, dtype)
    cache0 = _empty_ws_cache(kind, prob, nc, opts) if nc else None
    extrap = (nc and resolve_extrapolate(opts, True)
              and kind in ("ls", "wls", "sqrt"))

    def scan_body(carry, lam):
        s, cache, beta_prev, lam_k, lam_km1 = carry
        beta_k = s.beta
        if extrap:
            s = _sharded_extrapolate_start(s, cache, beta_prev, lam_k,
                                           lam_km1, lam, axis)
        s, cache = _sharded_solve_at_lambda(kind, opts, prob, lam, s,
                                            n_scale, axis, n_shards, w,
                                            cache)
        return (s, cache, beta_k, lam, lam_k), None

    (st, _, _, _, _), _ = lax.scan(
        scan_body, (st, cache0, st.beta, lams[0], lams[0]), lams)
    return st


# ---------------------------------------------------------------------------
# shard_map drivers
# ---------------------------------------------------------------------------


def _shard_chunk(p: int, D: int, B: int):
    """Per-shard column-chunk arithmetic, the single source of truth for
    every sharded driver (and the sharded checkpoint's ws_idx sizing):
    each of the ``D`` shards owns ``chunk`` columns — the ceil-even split
    of ``p`` — and the design is padded to ``P_tot = chunk · D``.
    Returns ``(chunk, P_tot)``.

    ``chunk`` is rounded up to whole ``B``-wide blocks so the blocked
    solver state (``CDState.beta`` etc.) shards evenly over the mesh —
    the sharded checkpoint and trace tiers stack blocked state globally
    and rely on this.  The DESIGN padding itself happens INSIDE the
    jitted programs (``_pad_cols_in``), where XLA fuses the pad into the
    blockify copy: an eager ``jnp.pad`` outside the trace kept a second
    full-size array live (X + padded copy + blocked layout = 3× the
    design's memory)."""
    chunk = -(-p // D)
    chunk = -(-chunk // B) * B
    return chunk, chunk * D


def _pad_cols_to(X, p_target):
    """Column pad to the sharded width.  The main sharded drivers call
    this INSIDE their jitted programs (the ``outer`` wrappers below), so
    XLA fuses the pad into the blockify copy instead of materializing an
    eager second full-size design — eagerly padding outside the trace
    kept X + padded copy + blocked layout live simultaneously (~3× the
    design's memory)."""
    p = X.shape[1]
    if p_target != p:
        X = jnp.pad(X, ((0, 0), (0, p_target - p)))
    return X


def _pad_vec_to(v, p_target, fill):
    p = v.shape[0]
    if p_target != p:
        v = jnp.pad(v, (0, p_target - p), constant_values=fill)
    return v


@functools.lru_cache(maxsize=None)
def _make_sharded_cd(kind: str, opts: CDOptions, mesh: Mesh, axis: str,
                     weighted: bool):
    """Build + cache the jitted shard_map solver for one (kind, opts, mesh)."""

    D = mesh.shape[axis]

    def local_fn(Xl, y, w, lamwl, beta0l, lam0, key):
        if kind == "wls":
            prob = build_blocked(kind, opts, lamwl, X=Xl, y=y, w=w)
        else:
            prob = build_blocked(kind, opts, lamwl, X=Xl, y=y)
        beta_b0 = _to_blocked_beta(beta0l, opts.block_size)
        st = solve_blocked_sharded(kind, opts, prob, lam0, beta_b0, key,
                                   axis, D, w if kind == "wls" else None)
        beta_l = st.beta.reshape(-1)[: beta0l.shape[0]]
        return beta_l, st.r

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P(), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P()),
        check_vma=False,
    )

    def outer(X, y, w, lamw, beta0, lam0, key):
        # pad to the sharded width inside the trace (see _pad_cols_to)
        _, P_tot = _shard_chunk(X.shape[1], D, opts.block_size)
        return fn(_pad_cols_to(X, P_tot), y, w,
                  _pad_vec_to(lamw, P_tot, 1.0),
                  _pad_vec_to(beta0, P_tot, 0.0), lam0, key)

    return jax.jit(outer)


def coordinate_descent_sharded(beta0, loss, penalty, mesh: Mesh,
                               options: CDOptions = CDOptions(), *,
                               axis: str = "feature", seed: int = 0,
                               key=None):
    """Feature-sharded ``coordinate_descent`` over a device mesh.

    Distributed analogue of the reference ``coordinateDescent!``
    (coordinate_descent.jl:7-39) for the regression losses (ls / wls / sqrt;
    the Gram-form ``QuadraticLoss`` is a small-p construct and stays
    single-device).  ``X``'s columns are partitioned over ``mesh[axis]``;
    returns ``(beta, residuals)`` like the single-device driver.
    """
    if isinstance(loss, (LeastSquaresLoss, WeightedLSLoss, SqrtLassoLoss)):
        X, y = loss.X, loss.y
    else:
        raise TypeError(
            "sharded CD supports LeastSquares/WeightedLS/SqrtLasso losses; "
            f"got {type(loss)!r}")
    kind = loss.kind
    dtype = X.dtype
    n, p = X.shape
    D = mesh.shape[axis]

    lam0, lamw = as_l1(penalty, p, dtype)
    if isinstance(penalty, ProxZero):
        if not options.warm_start:
            beta0 = jnp.zeros_like(beta0)
        options = options.replace(warm_start=True)

    w = (loss.w if isinstance(loss, WeightedLSLoss)
         else jnp.ones((n,), dtype))
    if key is None:
        key = jax.random.PRNGKey(seed)

    solver = _make_sharded_cd(kind, options, mesh, axis,
                              isinstance(loss, WeightedLSLoss))
    beta, r = solver(jnp.asarray(X, dtype), jnp.asarray(y, dtype), w,
                     lamw, jnp.asarray(beta0, dtype),
                     jnp.asarray(lam0, dtype), key)
    return beta[:p], r


def lasso_sharded(X, y, lam, mesh: Mesh, weights=None,
                  options: CDOptions = CDOptions(), *,
                  axis: str = "feature", seed: int = 0):
    """Feature-sharded Lasso (reference ``lasso``, lasso.jl:26-53) returning
    the same ``LassoSolution`` record as the single-device API."""
    from ..models.lasso import LassoSolution

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    g = ProxL1(jnp.asarray(lam, X.dtype),
               None if weights is None else jnp.asarray(weights, X.dtype))
    beta0 = jnp.zeros((X.shape[1],), X.dtype)
    beta, r = coordinate_descent_sharded(
        beta0, LeastSquaresLoss(y, X), g, mesh, options, axis=axis,
        seed=seed)
    return LassoSolution(beta, r, g, sample_std(r))


def sqrt_lasso_sharded(X, y, lam, mesh: Mesh, weights=None,
                       options: CDOptions = CDOptions(), *,
                       axis: str = "feature", seed: int = 0):
    """Feature-sharded Sqrt-Lasso (reference ``sqrtLasso``, lasso.jl:62-98)."""
    from ..models.lasso import LassoSolution

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    g = ProxL1(jnp.asarray(lam, X.dtype),
               None if weights is None else jnp.asarray(weights, X.dtype))
    beta0 = jnp.zeros((X.shape[1],), X.dtype)
    beta, r = coordinate_descent_sharded(
        beta0, SqrtLassoLoss(y, X), g, mesh, options, axis=axis, seed=seed)
    return LassoSolution(beta, r, g, sample_std(r))


# ---------------------------------------------------------------------------
# Sharded Scaled-Lasso: consensus σ loop around the sharded solver
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _make_sharded_scaled(opts: IterLassoOptions, mesh: Mesh, axis: str,
                         init_procedure: str):
    cd = opts.options_cd
    D = mesh.shape[axis]

    def local_fn(Xl, y, lamwl, beta0l, lam, sig0, key):
        n = y.shape[0]
        prob = build_blocked("ls", cd, lamwl, X=Xl, y=y)
        beta_b = _to_blocked_beta(beta0l, cd.block_size)
        n_scale = jnp.asarray(n, Xl.dtype)
        sig = sig0
        st0 = _sharded_init_state("ls", prob, beta_b, key, axis)
        nc = _compact_mode("ls", cd, prob, Xl.dtype)
        cache0 = _empty_ws_cache("ls", prob, nc, cd) if nc else None

        def cond(c):
            it, done = c[4], c[5]
            return jnp.logical_and(~done, it < opts.max_iter)

        def body(c):
            (st, cache, sig, sig_used, it, done,
             beta_prev, lam_k, lam_km1) = c
            beta_k = st.beta
            lam_new = lam * sig
            key, k1 = jax.random.split(st.key)
            if cd.warm_start:
                if nc and resolve_extrapolate(cd, True):
                    # σ rounds move the penalty along the λ·σ abscissa —
                    # same secant accelerant as the single-device twin
                    st = _sharded_extrapolate_start(
                        st, cache, beta_prev, lam_k, lam_km1, lam_new,
                        axis)
                st, cache = _sharded_solve_at_lambda(
                    "ls", cd, prob, lam_new, st._replace(key=k1),
                    n_scale, axis, D, cache=cache)
            else:
                # reference semantics: cold λ-continuation every σ round
                st = solve_blocked_sharded("ls", cd, prob, lam_new,
                                           jnp.zeros_like(st.beta), k1,
                                           axis, D)
            # consensus σ: residual is replicated post-psum, every shard
            # computes the identical update (reference lasso.jl:134)
            signew = jnp.sqrt(jnp.sum(st.r * st.r) / n)
            done = jnp.abs(signew - sig) / sig < opts.opt_tol
            sig_used = sig
            sig = jnp.where(done, sig, signew)
            return (st, cache, sig, sig_used, it + 1, done,
                    beta_k, lam_new, lam_k)

        lam_first = lam * sig
        init = (st0, cache0, sig, sig, jnp.zeros((), jnp.int32),
                jnp.zeros((), bool), st0.beta, lam_first, lam_first)
        st, _, sig, sig_used, *_ = lax.while_loop(cond, body, init)
        return st.beta.reshape(-1)[: beta0l.shape[0]], st.r, sig_used

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P(axis), P(axis), P(), P(), P()),
        out_specs=(P(axis), P(), P()),
        check_vma=False,
    )

    def outer(X, y, lamw, lam, sig0, key):
        # pad to the sharded width inside the trace (see _pad_cols_to)
        _, P_tot = _shard_chunk(X.shape[1], D, cd.block_size)
        return fn(_pad_cols_to(X, P_tot), y,
                  _pad_vec_to(lamw, P_tot, 1.0),
                  jnp.zeros((P_tot,), X.dtype), lam, sig0, key)

    return jax.jit(outer)


def scaled_lasso_sharded(X, y, lam, mesh: Mesh, weights=None,
                         options: IterLassoOptions = IterLassoOptions(), *,
                         axis: str = "feature", seed: int = 0):
    """Feature-sharded Scaled Lasso (reference ``scaledLasso!``,
    lasso.jl:107-144): the outer σ loop runs replicated on every shard with
    the inner weighted-λ lasso feature-sharded; σ is the consensus scalar
    computed from the psum-merged residual."""
    from ..models.lasso import LassoSolution

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    n, p = X.shape
    D = mesh.shape[axis]
    cd = options.options_cd

    lamw = (jnp.ones((p,), X.dtype) if weights is None
            else jnp.asarray(weights, X.dtype))
    # σ init on the host side (screening is a global top-k; cheap)
    if options.init_procedure == "screening":
        sig0 = find_init_sigma(X, y, options.s_init)
    elif options.init_procedure == "init_std":
        sig0 = jnp.asarray(options.sigma_init, X.dtype)
    elif options.init_procedure == "warm_start":
        sig0 = sample_std(y)  # zero warm start → residual is y
    else:
        raise ValueError("init_procedure must be one of "
                         "'screening' | 'init_std' | 'warm_start'")

    solver = _make_sharded_scaled(options, mesh, axis,
                                  options.init_procedure)
    beta, r, sig_used = solver(
        X, y, lamw, jnp.asarray(lam, X.dtype),
        jnp.asarray(sig0, X.dtype), jax.random.PRNGKey(seed))
    g = ProxL1(jnp.asarray(lam, X.dtype) * sig_used, lamw)
    return LassoSolution(beta[:p], r, g, sample_std(r))


@functools.lru_cache(maxsize=None)
def _make_sharded_feasible(opts: IterLassoOptions, mesh: Mesh, axis: str,
                           init_procedure: str):
    from ..models.lasso import _blocked_weights
    from ..utils.helpers import get_loadings_blocked

    cd = opts.options_cd
    D = mesh.shape[axis]
    B = cd.block_size

    def local_fn(Xl, y, gam0l, validl, beta0l, lam0, r_init, key):
        prob = build_blocked("ls", cd, jnp.ones((Xl.shape[1],), Xl.dtype),
                             X=Xl, y=y)
        beta_b = _to_blocked_beta(beta0l, B)
        n_scale = jnp.asarray(y.shape[0], Xl.dtype)

        if init_procedure == "init_std":
            key, k0 = jax.random.split(key)
            st0 = solve_blocked_sharded(
                "ls", cd, prob._replace(lamw=_blocked_weights(gam0l, B)),
                lam0 * opts.sigma_init, beta_b, k0, axis, D)
            beta_b, r = st0.beta, st0.r
        else:
            # screening / warm_start residuals are host-supplied
            # (find_init_residuals is a global top-k; cheap on host)
            r = r_init
        # padded (zero) columns get loading 1.0 — their coefficients are
        # structurally zero either way, but a 0 loading would zero the
        # threshold on a zero-norm column.  Loadings come from the
        # blocked layout (helpers.get_loadings_blocked): the raw-Xl form
        # keeps shard-X-shaped temps live across the loading rounds —
        # the same ×3 memory multiplier the single-device core avoids at
        # 10K×100K
        gam = jnp.where(validl,
                        get_loadings_blocked(prob.Xb, r, Xl.shape[1]), 1.0)

        key, k0 = jax.random.split(key)
        st0 = _sharded_init_state("ls", prob, beta_b, k0, axis)
        nc = _compact_mode("ls", cd, prob, Xl.dtype)
        cache0 = _empty_ws_cache("ls", prob, nc, cd) if nc else None

        def cond(c):
            it, done = c[3], c[4]
            return jnp.logical_and(~done, it < opts.max_iter)

        def body(c):
            st, cache, gam, it, done = c
            key, k1 = jax.random.split(st.key)
            # cached KKT gradient is penalty-weight-independent → survives
            # the loading update (same property the single-device core
            # exploits, models/lasso.py::_feasible_lasso_core)
            prob_g = prob._replace(lamw=_blocked_weights(gam, B))
            if cd.warm_start:
                st, cache = _sharded_solve_at_lambda(
                    "ls", cd, prob_g, lam0, st._replace(key=k1), n_scale,
                    axis, D, cache=cache)
            else:
                st = solve_blocked_sharded("ls", cd, prob_g, lam0,
                                           jnp.zeros_like(st.beta), k1,
                                           axis, D)
            gam_new = jnp.where(
                validl, get_loadings_blocked(prob.Xb, st.r, Xl.shape[1]),
                1.0)
            # the stop criterion's maxes are GLOBAL (reference
            # lasso.jl:186-192 computes them over all p) — and over REAL
            # columns only: the padded 1.0 loadings would dominate the
            # denominator whenever every true loading is < 1 and stop the
            # loop early (numerator is safe: pads are constant, diff 0)
            num = lax.pmax(jnp.max(jnp.abs(gam - gam_new)), axis)
            den = lax.pmax(jnp.max(jnp.where(validl, gam_new, 0.0)),
                               axis)
            done = num / den < opts.opt_tol
            return (st, cache, gam_new, it + 1, done)

        init = (st0, cache0, gam, jnp.zeros((), jnp.int32),
                jnp.zeros((), bool))
        st, _, gam, _, _ = lax.while_loop(cond, body, init)
        return st.beta.reshape(-1)[: beta0l.shape[0]], st.r, gam

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P(axis), P(axis), P(axis), P(),
                  P(), P()),
        out_specs=(P(axis), P(), P(axis)),
        check_vma=False,
    )

    def outer(X, y, gam0, beta0, lam0, r_init, key):
        # pad to the sharded width inside the trace (see _pad_cols_to)
        p = X.shape[1]
        _, P_tot = _shard_chunk(p, D, B)
        valid = jnp.arange(P_tot) < p
        return fn(_pad_cols_to(X, P_tot), y,
                  _pad_vec_to(gam0, P_tot, 1.0), valid,
                  _pad_vec_to(beta0, P_tot, 0.0), lam0, r_init, key)

    return jax.jit(outer)


def feasible_lasso_sharded(X, y, lam0, mesh: Mesh,
                           options: IterLassoOptions = IterLassoOptions(),
                           *, beta0=None, axis: str = "feature",
                           seed: int = 0):
    """Feature-sharded feasible (Belloni-style heteroscedastic) Lasso
    (reference ``feasibleLasso!``, lasso.jl:154-194): the loadings
    ``Γ_j = sqrt(mean((X_ij ε_i)²))`` are shard-local (each shard owns its
    columns; the residual is replicated post-psum) and the stop criterion's
    global maxes are gathered — the loadings outer loop runs replicated
    like the σ loop of ``scaled_lasso_sharded``."""
    from ..models.lasso import LassoSolution
    from ..utils.helpers import find_init_residuals

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    n, p = X.shape
    D = mesh.shape[axis]
    cd = options.options_cd
    if beta0 is None:
        beta0 = jnp.zeros((p,), X.dtype)
    beta0 = jnp.asarray(beta0, X.dtype)

    if options.init_procedure == "screening":
        r_init = find_init_residuals(X, y, options.s_init)
    elif options.init_procedure == "warm_start":
        r_init = y - jnp.dot(X, beta0, precision=_PREC)
    elif options.init_procedure == "init_std":
        r_init = y  # unused: the pre-solve computes its own residual
    else:
        raise ValueError("init_procedure must be one of "
                         "'screening' | 'init_std' | 'warm_start'")
    from ..utils.helpers import std_X

    # gam0 feeds only the init_std pre-solve; for the other procedures a
    # ones-fill avoids an eager full-X sweep outside the jitted solve
    gam0 = (std_X(X) if options.init_procedure == "init_std"
            else jnp.ones((p,), X.dtype))

    solver = _make_sharded_feasible(options, mesh, axis,
                                    options.init_procedure)
    beta, r, gam = solver(
        X, y, gam0, beta0, jnp.asarray(lam0, X.dtype),
        r_init, jax.random.PRNGKey(seed))
    g = ProxL1(jnp.asarray(lam0, X.dtype), gam[:p])
    return LassoSolution(beta[:p], r, g, sample_std(r))


# ---------------------------------------------------------------------------
# Sharded warm-started λ-path
# ---------------------------------------------------------------------------


def _sharded_path_scan_local(Xl, y, lamwl, lam_path, max_hat_s, key,
                             opts: CDOptions, axis: str, D: int,
                             carry_in=None):
    """Shard-local body of the warm-started sharded path scan (shared by
    the plain, batched, and host-chunked drivers).  Returns ``(betas
    (g, p_local), valids (g,), carry_out)``; the carry's WsCache rides
    with its scalar ``ok`` wrapped to shape ``(1,)`` so every leaf has a
    shard axis for the chunked driver's ``P(axis)`` specs.  With
    ``carry_in`` (same wrapped form) the scan resumes a previous
    segment's state — trajectory identical to one monolithic scan."""
    prob = build_blocked("ls", opts, lamwl, X=Xl, y=y)
    p_local = Xl.shape[1]
    n_scale = jnp.asarray(y.shape[0], Xl.dtype)
    nc = _compact_mode("ls", opts, prob, Xl.dtype)

    def _wrap_cache(cache):
        return cache._replace(ok=cache.ok[None]) if nc else None

    if carry_in is not None:
        st0, cache_w, beta_prev0, lam_k0, lam_km10, stopped0 = carry_in
        cache0 = cache_w._replace(ok=cache_w.ok[0]) if nc else None
    else:
        beta_b0 = _to_blocked_beta(jnp.zeros((p_local,), Xl.dtype),
                                   opts.block_size)
        st0 = _sharded_init_state("ls", prob, beta_b0, key, axis)
        cache0 = _empty_ws_cache("ls", prob, nc, opts) if nc else None
        beta_prev0 = st0.beta
        lam_k0 = lam_km10 = lam_path[0]
        stopped0 = jnp.zeros((), bool)

    def scan_body(carry, lam):
        st, cache, beta_prev, lam_k, lam_km1, stopped = carry
        beta_k = st.beta
        key, k1 = jax.random.split(st.key)
        st = st._replace(key=key)

        def do(args):
            st, cache = args
            if opts.warm_start:
                if nc and resolve_extrapolate(opts, False):
                    st = _sharded_extrapolate_start(
                        st, cache, beta_prev, lam_k, lam_km1, lam,
                        axis)
                return _sharded_solve_at_lambda(
                    "ls", opts, prob, lam, st._replace(key=k1),
                    n_scale, axis, D, cache=cache)
            return solve_blocked_sharded(
                "ls", opts, prob, lam, jnp.zeros_like(st.beta), k1,
                axis, D), cache

        st, cache = lax.cond(stopped, lambda a: a, do, (st, cache))
        valid = ~stopped
        nnz = lax.psum(jnp.sum(st.beta != 0), axis)
        stopped = stopped | (nnz > max_hat_s)
        return ((st, cache, beta_k, lam, lam_k, stopped),
                (st.beta.reshape(-1)[:p_local], valid))

    # fresh start: both abscissa carries hold the first path value so the
    # first two steps skip the shift (block_cd.secant_alpha)
    (st_f, cache_f, bp_f, lk_f, lkm_f, stop_f), (betas, valids) = lax.scan(
        scan_body,
        (st0, cache0, beta_prev0, lam_k0, lam_km10, stopped0),
        lam_path)
    carry_out = (st_f, _wrap_cache(cache_f), bp_f, lk_f, lkm_f, stop_f)
    return betas, valids, carry_out


@functools.lru_cache(maxsize=None)
def _make_sharded_path(opts: CDOptions, mesh: Mesh, axis: str):
    D = mesh.shape[axis]

    def local_fn(Xl, y, lamwl, lam_path, max_hat_s, key):
        betas, valids, _ = _sharded_path_scan_local(
            Xl, y, lamwl, lam_path, max_hat_s, key, opts, axis, D)
        return betas, valids

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P(axis), P(), P(), P()),
        out_specs=(P(None, axis), P()),
        check_vma=False,
    )

    def outer(X, y, lamw, lam_path, max_hat_s, key):
        # pad to the sharded width inside the trace (see _pad_cols_to)
        _, P_tot = _shard_chunk(X.shape[1], D, opts.block_size)
        return fn(_pad_cols_to(X, P_tot), y,
                  _pad_vec_to(lamw, P_tot, 1.0), lam_path, max_hat_s,
                  key)

    return jax.jit(outer)


@functools.lru_cache(maxsize=None)
def _make_sharded_path_chunked(opts: CDOptions, mesh: Mesh, axis: str,
                               resume: bool):
    """Segment program for the host-chunked sharded path scan
    (``lasso_path_sharded(scan_chunk=…)``): one warm-started scan over a
    λ segment whose full carry (sharded CDState + per-shard WsCache +
    secant abscissae + stop flag) round-trips through the program
    boundary as sharded global arrays — same contract as the
    single-device ``lasso_path(scan_chunk=…)``, same rationale (bounded
    single-program runtime).  ``resume=False`` builds the first-segment program
    (zero-state init), ``resume=True`` the continuation program."""
    D = mesh.shape[axis]
    B = opts.block_size

    def outer(X, y, lamw, lam_path, max_hat_s, key, carry_in):
        from ..ops.block_cd import CDState, _compact_nc

        _, P_tot = _shard_chunk(X.shape[1], D, B)
        nb_local = (P_tot // D) // B
        nc = _compact_nc("ls", opts, nb_local, B, X.dtype)
        # specs for the carry pytree: block-indexed leaves shard over the
        # feature axis, replicated scalars/vectors ride P() (the same
        # layout utils.checkpoint's resumable sharded driver persists)
        state_spec = CDState(beta=P(axis), r=P(), rsqr=P(),
                             active=P(axis), key=P(), it=P(), conv=P(),
                             done=P(), c=P(axis), drift=P(axis))
        cache_spec = P(axis) if nc else None
        carry_spec = (state_spec, cache_spec, P(axis), P(), P(), P())
        data_specs = (P(None, axis), P(), P(axis), P(), P(), P())

        def local_fn(Xl, yv, lamwl, lams, mhs, k, carry):
            return _sharded_path_scan_local(
                Xl, yv, lamwl, lams, mhs, k, opts, axis, D,
                carry_in=(carry if resume else None))

        fn = jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=data_specs + ((carry_spec,) if resume else (P(),)),
            out_specs=(P(None, axis), P(), carry_spec),
            check_vma=False,
        )
        return fn(_pad_cols_to(X, P_tot), y,
                  _pad_vec_to(lamw, P_tot, 1.0), lam_path, max_hat_s,
                  key, carry_in)

    return jax.jit(outer)


@functools.lru_cache(maxsize=None)
def _make_sharded_path_batched(opts: CDOptions, mesh: Mesh, axis: str,
                               stride: int, batch: int,
                               batch_axis: str | None = None):
    """Feature-sharded twin of ``models.lasso_path._lasso_path_batched_core``:
    coarse sequential anchors + chunked batched certify/refine, with the
    feature dimension sharded over ``mesh[axis]``.

    The single-device batched path's one O(k·n·p) cost per round is the
    certify GEMM ``R @ X``; here each shard certifies only its own column
    block ``R @ X_s`` — the GEMM scales with the mesh.  The union working
    set is assembled by distributed top-k (local top-C → ``all_gather`` →
    global top-C of the D·C candidates, identical on every shard), its
    ``(n, Cp)`` column gather is a psum of ownership-masked local gathers,
    and the Gram-sized FISTA refinement then runs **replicated** on every
    shard (deterministic — all inputs are post-collective, so no extra
    communication).  Refined coordinates scatter back to their owning
    shard only.  Certification is the same sharded full-KKT rule as the
    scan path, so a certified batched run satisfies exactly the scan's
    certificate."""
    import numpy as np
    from ..ops.batched_certify import (
        kkt_violation_lanes,
        stall_escape_update,
        union_block_fista,
        union_priority,
    )
    from ..ops.block_cd import _PREC

    D = mesh.shape[axis]

    def local_fn(Xl, y, lamwl, lam_path, max_hat_s, key):
        # the anchor indices are shape-derived, so jit's shape cache (not
        # this maker's lru_cache) handles varying grid lengths
        g = lam_path.shape[0]
        cidx = np.arange(0, g, stride)
        if cidx[-1] != g - 1:
            cidx = np.append(cidx, g - 1)
        rest = np.setdiff1d(np.arange(g), cidx)

        n, chunk = Xl.shape
        dt = Xl.dtype
        P_tot = chunk * D
        tol = opts.opt_tol
        n_scale = jnp.asarray(n, dt)
        s_idx = lax.axis_index(axis)

        betas_c, valids_c, _ = _sharded_path_scan_local(
            Xl, y, lamwl, lam_path[jnp.asarray(cidx)], max_hat_s, key,
            opts, axis, D)

        adiag = jnp.maximum(jnp.einsum("nj,nj->j", Xl, Xl,
                                       precision=_PREC),
                            jnp.asarray(1e-30, dt))
        xnorm = jnp.sqrt(adiag)
        Bb = int(opts.block_size)
        C = int(min(opts.compact_size, P_tot))
        Cl = int(min(C, chunk))
        Cp = -(-C // Bb) * Bb

        def certify(Bl, R, thrwl):
            # each shard certifies its own columns — the R @ X_s GEMM is
            # the sharded form of the batched core's one X read per round
            return kkt_violation_lanes(Bl, R, thrwl, Xl, adiag, xnorm)

        def gmax_lanes(H):
            # per-lane certificate max over ALL columns
            return lax.pmax(jnp.max(H, axis=1), axis)

        def refine(args):
            lam_k, B0, frozen = args    # (k,), (k, chunk) local, (k,)
            thrwl = lamwl[None, :] * (lam_k * n_scale)[:, None]
            R = y[None, :] - lax.psum(
                jnp.dot(B0, Xl.T, precision=_PREC), axis)    # (k, n)

            H0 = certify(B0, R, thrwl)
            mx0 = gmax_lanes(H0)
            cert0 = (mx0 < tol) | frozen
            # per-lane f32 stall escape (see _lasso_path_batched_core:
            # lanes can limit-cycle a hair above tol; the scan exits such
            # points via its stall detector, so the batched certify must
            # have the same escape); all inputs are post-collective, so
            # the accounting is shard-consistent
            patience = (opts.stall_patience
                        if jnp.dtype(Xl.dtype).itemsize < 8
                        else np.iinfo(np.int32).max)
            stall0 = jnp.zeros(mx0.shape, jnp.int32)
            esc0 = jnp.zeros(mx0.shape, bool)

            def cond(st):
                B, R, H, cert, best, stall, esc, rounds = st
                return jnp.logical_and(~jnp.all(cert),
                                       rounds < 2 * opts.compact_rounds)

            def body(st):
                B, R, H, cert, best, stall, esc, rounds = st
                # same two-tier priority as the single-device core
                # (support above violations), computed per local column;
                # the tier offset must use the GLOBAL violation max so
                # every shard ranks on the same scale
                hi = 2.0 * lax.pmax(
                    jnp.max(jnp.where(cert[:, None], 0.0, H)), axis) + 1.0
                pri = union_priority(B, H, cert, hi)         # (chunk,)
                # distributed top-k: the global top-C contains at most C
                # columns per shard, so local top-Cl → gather → top-C of
                # the D·Cl candidates is exact; every shard computes the
                # identical (sorted) global index set
                vloc, iloc = lax.top_k(pri, Cl)
                gidx = iloc + s_idx * chunk
                vg = lax.all_gather(vloc, axis).reshape(-1)
                ig = lax.all_gather(gidx, axis).reshape(-1)
                _, sel = lax.top_k(vg, C)
                idx = jnp.sort(ig[sel])                      # (C,) global
                if Cp != C:             # pad → no shard owns index P_tot
                    idx = jnp.concatenate(
                        [idx, jnp.full((Cp - C,), P_tot, idx.dtype)])
                loc = idx - s_idx * chunk
                owned = (loc >= 0) & (loc < chunk)
                locc = jnp.clip(loc, 0, chunk - 1)
                ownf = owned.astype(dt)
                # replicated union-set views, psum-assembled from the
                # owning shards (each global column has exactly one owner)
                Xs = lax.psum(jnp.take(Xl, locc, axis=1) * ownf[None, :],
                              axis)                          # (n, Cp)
                Bs0 = lax.psum(jnp.take(B, locc, axis=1) * ownf[None, :],
                               axis)                         # (k, Cp)
                thr_full = lax.psum(
                    jnp.take(thrwl, locc, axis=1) * ownf[None, :], axis)
                # padded slots (owner-less): infinite threshold pins zero
                thr_full = jnp.where((idx < P_tot)[None, :], thr_full,
                                     jnp.finfo(dt).max / 8)
                Ks = jnp.dot(Xs.T, Xs, precision=_PREC)      # (Cp, Cp)
                cs0 = jnp.dot(R, Xs, precision=_PREC)        # (k, Cp)
                # from here the refinement is Gram-sized and replicated:
                # every shard runs the identical FISTA block sweeps
                bs = union_block_fista(Ks, thr_full, Bs0, cs0, cert,
                                       opts)
                # Xs is replicated, so the residual update needs no
                # collective; B takes back only the shard's own columns
                R = R - jnp.dot(bs - Bs0, Xs.T, precision=_PREC)
                # route non-owned lanes to the (dropped) OOB index chunk
                loc_safe = jnp.where(owned, locc, chunk)
                B = B.at[:, loc_safe].set(bs, mode="drop")
                H = certify(B, R, thrwl)
                mx = gmax_lanes(H)
                # all inputs are post-collective → shard-consistent
                cert, best, stall, esc = stall_escape_update(
                    cert, best, stall, esc, mx, patience, tol, frozen)
                return (B, R, H, cert, best, stall, esc, rounds + 1)

            B, _, _, cert, _, _, esc, _ = lax.while_loop(
                cond, body, (B0, R, H0, cert0, mx0, stall0, esc0,
                             jnp.zeros((), jnp.int32)))
            return B, cert, esc

        if rest.size:
            seg = np.searchsorted(cidx, rest) - 1
            lam_lo = lam_path[jnp.asarray(cidx[seg])]
            lam_hi = lam_path[jnp.asarray(cidx[seg + 1])]
            lam_r = lam_path[jnp.asarray(rest)]
            denom = jnp.where(lam_hi != lam_lo, lam_hi - lam_lo, 1.0)
            a = jnp.clip((lam_r - lam_lo) / denom, 0.0, 1.0)
            starts = ((1.0 - a)[:, None] * betas_c[seg]
                      + a[:, None] * betas_c[seg + 1])   # (r, chunk) local
            frozen = ~(valids_c[jnp.asarray(seg)]
                       & valids_c[jnp.asarray(seg + 1)])
            k = min(batch, int(rest.size))
            nchunks = -(-int(rest.size) // k)
            Db = mesh.shape[batch_axis] if batch_axis else 1
            # on a 2-D (batch × feature) mesh the refine chunks are
            # partitioned over the batch axis — each batch row of the
            # mesh refines its own λ lanes with its own feature-axis
            # collectives, so the refine phase scales with BOTH axes
            nchunks = -(-nchunks // Db) * Db
            pad = nchunks * k - int(rest.size)
            if pad:
                lam_r = jnp.concatenate(
                    [lam_r, jnp.repeat(lam_r[-1:], pad)])
                starts = jnp.concatenate(
                    [starts, jnp.repeat(starts[-1:], pad, axis=0)])
                frozen = jnp.concatenate([frozen,
                                          jnp.ones((pad,), bool)])
            lam_s = lam_r.reshape(nchunks, k)
            starts_s = starts.reshape(nchunks, k, chunk)
            frozen_s = frozen.reshape(nchunks, k)
            if batch_axis:
                nc_local = nchunks // Db
                b_idx = lax.axis_index(batch_axis)
                off = b_idx * nc_local
                lam_s = lax.dynamic_slice_in_dim(lam_s, off, nc_local)
                starts_s = lax.dynamic_slice_in_dim(starts_s, off,
                                                    nc_local)
                frozen_s = lax.dynamic_slice_in_dim(frozen_s, off,
                                                    nc_local)
            else:
                nc_local = nchunks
            if nc_local == 1:
                refined_all, certs, escs = refine(
                    (lam_s[0], starts_s[0], frozen_s[0]))
                refined_all = refined_all[None]
                certs = certs[None]
                escs = escs[None]
            else:
                refined_all, certs, escs = lax.map(
                    refine, (lam_s, starts_s, frozen_s))
            if batch_axis:
                # chunk c = b·nc_local + j → the gather's leading (batch)
                # axis is the outer chunk order, so a plain reshape
                # restores global lane order
                refined_all = lax.all_gather(refined_all, batch_axis)
                certs = lax.all_gather(certs, batch_axis)
                escs = lax.all_gather(escs, batch_axis)
            refined_all = refined_all.reshape(nchunks * k, chunk)
            certs = certs.reshape(nchunks * k)
            escs = escs.reshape(nchunks * k)
            refined = refined_all[:rest.size]
            all_cert = jnp.all(certs[:rest.size] | frozen[:rest.size])
            n_escaped = jnp.sum(escs[:rest.size].astype(jnp.int32))
            betas = (jnp.zeros((g, chunk), dt)
                     .at[jnp.asarray(cidx)].set(betas_c)
                     .at[jnp.asarray(rest)].set(refined))
        else:
            betas = betas_c
            all_cert = jnp.ones((), bool)
            n_escaped = jnp.zeros((), jnp.int32)

        # reference early-stop semantics on the GLOBAL support count
        nnz = lax.psum(jnp.sum(betas != 0, axis=1), axis)
        exceed = nnz > max_hat_s
        stopped_before = jnp.concatenate(
            [jnp.zeros((1,), bool), jnp.cumsum(exceed)[:-1] > 0])
        return betas, ~stopped_before, all_cert, n_escaped

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P(axis), P(), P(), P()),
        out_specs=(P(None, axis), P(), P(), P()),
        check_vma=False,
    )

    def outer(X, y, lamw, lam_path, max_hat_s, key):
        # pad to the sharded width inside the trace (see _pad_cols_to)
        _, P_tot = _shard_chunk(X.shape[1], D, opts.block_size)
        return fn(_pad_cols_to(X, P_tot), y,
                  _pad_vec_to(lamw, P_tot, 1.0), lam_path, max_hat_s,
                  key)

    return jax.jit(outer)


def _sharded_path_scan_chunked(opts: CDOptions, mesh: Mesh, axis: str,
                               args, chunk: int):
    """Host-driven segment loop for ``lasso_path_sharded(scan_chunk=…)``:
    same mechanics as the single-device ``_lasso_path_scan_chunked`` (pad
    the last segment with the final λ, round-trip the full carry, stop
    issuing segments once the ``max_hat_s`` flag is set), with the carry
    riding between programs as sharded global arrays."""
    from ..ops.batched_certify import run_chunked_segments

    X, y, lamw, lam_path, max_hat_s, key = args
    fresh = _make_sharded_path_chunked(opts, mesh, axis, False)
    cont = _make_sharded_path_chunked(opts, mesh, axis, True)

    def run_segment(s, seg, carry):
        return (fresh if s == 0 else cont)(
            X, y, lamw, seg, max_hat_s, key,
            # the fresh program takes (and ignores) a dummy scalar carry
            jnp.zeros(()) if s == 0 else carry)

    return run_chunked_segments(lam_path, chunk, run_segment)


def lasso_path_sharded(X, y, lam_path, mesh: Mesh,
                       options: CDOptions = CDOptions(), *,
                       max_hat_s: float = float("inf"),
                       standardize_X: bool = True, axis: str = "feature",
                       path_batch: int | None = None,
                       coarse_stride: int | None = None,
                       batch_axis: str | None = None,
                       scan_chunk: int | None = None,
                       seed: int = 0, stats: dict | None = None):
    """Feature-sharded warm-started Lasso path (reference ``LassoPath``,
    lasso.jl:229-260): β warm-starts across the decreasing λ grid on device;
    the support-size early stop uses a psum'd nonzero count.

    ``path_batch`` / ``coarse_stride`` select the batched execution
    (``_make_sharded_path_batched``) with the same auto-resolution and
    certified-or-fallback contract as the single-device ``lasso_path``:
    ``None`` enables 128 lanes for sub-f64 dtypes off-CPU on grids of ≥ 16
    points; a run whose refinement fails the sharded full-KKT certify
    falls back to the sequential sharded scan (warning).

    On a 2-D mesh, ``batch_axis`` additionally partitions the batched
    refinement's λ-lane chunks over that axis (each batch row of the mesh
    refines its own lanes with its own feature-axis collectives), so the
    refine phase scales with both mesh axes; the coarse anchor scan runs
    replicated over ``batch_axis``.

    ``scan_chunk > 0`` executes the sequential sharded scan (including
    the fallback from an uncertified batched run) as host-driven
    ``scan_chunk``-point segments, the full carry (sharded solver state +
    per-shard working-set cache + secant abscissae + stop flag)
    round-tripped between programs as sharded global arrays — identical
    trajectory, bounded single-program runtime (the same contract as the
    single-device ``lasso_path(scan_chunk=…)``).

    ``stats``, if a dict, receives the same run accounting as the
    single-device ``lasso_path``: ``used_batched``, ``batched_certified``
    and ``stall_escaped_lanes`` (0 whenever the scan result is returned,
    and always 0 at f64)."""
    import warnings

    import numpy as np
    from ..models.lasso_path import LassoPath
    from ..utils.helpers import std_X

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    n, p = X.shape
    D = mesh.shape[axis]
    lamw = std_X(X) if standardize_X else jnp.ones((p,), X.dtype)
    lam_path = jnp.asarray(lam_path, X.dtype)
    L = int(lam_path.shape[0])
    if path_batch is None:
        path_batch = auto_batch_lanes(X.dtype, L, min_points=16)
    if coarse_stride is None:
        coarse_stride = max(1, L - 1)
    if coarse_stride < 1:
        raise ValueError("coarse_stride must be >= 1")
    if path_batch < 0:
        raise ValueError("path_batch must be >= 0")
    if scan_chunk is not None and scan_chunk <= 0:
        raise ValueError("scan_chunk must be >= 1")

    args = (X, y, lamw, lam_path, jnp.asarray(max_hat_s, X.dtype),
            jax.random.PRNGKey(seed))
    batched_ok = False
    used_batched = False
    n_escaped = 0
    if batch_axis is not None:
        if batch_axis not in mesh.shape:
            raise ValueError(f"batch_axis {batch_axis!r} not in mesh "
                             f"axes {tuple(mesh.shape)}")
        if batch_axis == axis:
            # the λ-lane partition and the feature collectives must ride
            # DIFFERENT axes: sharing one makes shards take different
            # while_loop trip counts and deadlocks the collectives
            raise ValueError("batch_axis must differ from the feature "
                             f"axis ({axis!r})")
    if path_batch and L > max(2, coarse_stride):
        solver_b = _make_sharded_path_batched(
            options, mesh, axis, int(coarse_stride), int(path_batch),
            batch_axis)
        betas, valids, all_cert, n_esc = solver_b(*args)
        used_batched = True
        batched_ok = bool(all_cert)
        n_escaped = int(n_esc) if batched_ok else 0
        if not batched_ok:
            warnings.warn(
                "lasso_path_sharded(path_batch=...): batched refinement "
                "did not certify every point; falling back to the "
                "sequential sharded scan (consider a larger "
                "options.compact_size or a smaller path_batch)",
                RuntimeWarning)
    if not batched_ok:
        if scan_chunk and L > scan_chunk:
            betas, valids = _sharded_path_scan_chunked(
                options, mesh, axis, args, int(scan_chunk))
        else:
            solver = _make_sharded_path(options, mesh, axis)
            betas, valids = solver(*args)
    if stats is not None:
        stats["used_batched"] = used_batched
        stats["batched_certified"] = batched_ok
        stats["stall_escaped_lanes"] = n_escaped
    valids = np.asarray(valids)
    k = int(valids.sum())
    return LassoPath(lam_path[:k], betas[:k, :p])


def symmetric_coordinate_descent_sharded(M0, loss, penalty, mesh: Mesh,
                                         options: CDOptions = CDOptions(),
                                         *, axis: str = "feature",
                                         seed: int = 0, key=None):
    """Feature-sharded CD over a symmetric-matrix iterate — the reference
    driver called with a ``SymmetricSparseIterate``
    (coordinate_descent.jl:8), feature-sharded.  Exactly like the
    single-device twin (ops/symmetric.py) the iterate is the dense packed
    lower-triangle vector, so sharding it is ordinary column sharding of
    the packed design: the ``q = p(p+1)/2`` packed coordinates are
    partitioned over ``mesh[axis]``.  Returns ``(M, residuals)`` with
    ``M`` the full symmetric solution."""
    from ..ops.symmetric import sym_pack, sym_unpack

    p = M0.shape[0]
    v0 = sym_pack(jnp.asarray(M0))
    v, r = coordinate_descent_sharded(v0, loss, penalty, mesh, options,
                                      axis=axis, seed=seed, key=key)
    return sym_unpack(v, p), r
