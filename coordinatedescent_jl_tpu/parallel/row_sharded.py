"""Observation-sharded (data-parallel) block-coordinate descent.

The feature-sharded tier (``sharded_cd.py``) scales the p axis; this
module scales the **n axis** — the other dimension on which the
reference's single-threaded solver (SURVEY.md §2.5) cannot grow.  Rows
of ``X`` (and the matching entries of ``y`` / the WLS weights) are
partitioned over a mesh axis with ``PartitionSpec('obs', None)``; β is
replicated.

Communication pattern (the row-lifted form of the reference's
per-coordinate dot products, cd_differentiable_function.jl:83-111):

- **block Grams** ``K_b = Xw_b' X_b`` are exact cross-shard ``psum``s of
  the local row contributions, computed ONCE at build (they never change
  — the cached-Gram trick of the single-device engine, here doubling as
  the thing that makes every in-block solve communication-free);
- each block visit needs one ``psum`` of the local gradient contribution
  ``c_b = Xw_b' r_local`` (a ``B``-vector — latency, not bandwidth);
  the in-block **Gram-recursion scan is then replicated compute**
  (identical on every shard, ``block_cd._visit_block``), and the
  residual update ``r -= X_b Δβ_b`` touches only local rows;
- the full KKT sweep psums the whole local gradient ``Xw' r_local``
  (one ``(p,)`` all-reduce per check) and certifies with the engine's
  order-independent rule + f32 noise floor, so a converged
  row-sharded solve satisfies exactly the single-device certificate.

Unlike the feature tier there is no block-Jacobi approximation anywhere:
β is replicated and blocks are visited sequentially (exact Gauss-Seidel
across blocks), so the trajectory EQUALS the single-device engine's
exact-inner trajectory — equivalence tests pin solutions, not just fixed
points.  Padded rows are all-zero (x=0, y=0, w=0): they contribute
nothing to any psum and their residual entries stay 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.block_cd import (
    _PREC,
    _block_grams,
    _blockify_cols,
    _ls_candidate,
    _sqrt_candidate,
    _visit_block,
    noise_floor_mask,
)
from ..ops.losses import LeastSquaresLoss, SqrtLassoLoss, WeightedLSLoss
from ..ops.prox import ProxL1, ProxZero, as_l1
from ..utils.options import CDOptions
from .sharded_cd import _pad_vec_to


class RowProblem:
    """Shard-local blocked view of a row-partitioned problem.  Plain
    container (constructed inside the shard_map trace, never hashed)."""

    __slots__ = ("Xb", "Xwb", "y", "wrow", "lamw", "valid", "Kb",
                 "adiag", "xwnorm")

    def __init__(self, Xb, Xwb, y, wrow, lamw, valid, Kb, adiag, xwnorm):
        self.Xb = Xb          # (nb, n_local, B) local rows
        self.Xwb = Xwb        # w-scaled twin (== Xb for ls/sqrt)
        self.y = y            # (n_local,)
        self.wrow = wrow      # (n_local,) local row weights (wls)
        self.lamw = lamw      # (nb, B) penalty loadings
        self.valid = valid    # (nb, B) real (non-pad) columns
        self.Kb = Kb          # (nb, B, B) psum'd exact block Grams Xw'X
        self.adiag = adiag    # (nb, B) diag of Kb
        self.xwnorm = xwnorm  # (nb, B) ‖Xw_j‖ over ALL rows (psum'd)


def _row_build(kind, Xl, yl, w, lamw_b, valid_b, B, axis) -> RowProblem:
    Xb = _blockify_cols(Xl, B)
    Xwb = Xb * w[None, :, None] if kind == "wls" else Xb
    Kb = lax.psum(_block_grams(Xwb, Xb), axis)
    adiag = jnp.diagonal(Kb, axis1=1, axis2=2)
    if kind == "wls":
        xw2 = lax.psum(jnp.einsum("bnk,bnk->bk", Xwb, Xwb,
                                  precision=_PREC), axis)
    else:
        xw2 = adiag
    xwnorm = jnp.sqrt(jnp.maximum(xw2, 0.0))
    return RowProblem(Xb, Xwb, yl, w, lamw_b, valid_b, Kb, adiag, xwnorm)


def _row_rsqr(r, axis):
    return lax.psum(jnp.dot(r, r, precision=_PREC), axis)


def _row_full_c(prob: RowProblem, r, axis):
    """The engine's ``_full_gradient_c`` with the n-contraction psum'd
    over the row shards."""
    return lax.psum(jnp.einsum("bnk,n->bk", prob.Xwb, r, precision=_PREC),
                    axis)


def _feat_max(x, feat_axis):
    """max-reduce a scalar over the (optional) feature axis of a tiled
    mesh."""
    return x if feat_axis is None else lax.pmax(x, feat_axis)


def _row_full_check(kind, prob: RowProblem, beta_b, r, rsqr, lam0,
                    n_scale, opt_tol, axis, feat_axis=None):
    """Order-independent KKT sweep (engine ``_full_check`` semantics,
    without the drift-cache machinery — every check recomputes the exact
    gradient: one local GEMV + one ``(p_local,)`` psum over the obs
    axis).  Returns ``(active, rsqr, maxh)``; scalars are replicated
    (maxh max-reduced over the feature axis on tiled meshes)."""
    dt = beta_b.dtype
    if kind == "sqrt":
        rsqr = _row_rsqr(r, axis)
    c = _row_full_c(prob, r, axis)
    if kind == "sqrt":
        val, _, _ = _sqrt_candidate(beta_b, c, prob.adiag, rsqr, lam0,
                                    prob.lamw)
    else:
        val = _ls_candidate(beta_b, c, prob.adiag, lam0, prob.lamw,
                            n_scale)
    habs = jnp.abs(jnp.where(prob.valid, val - beta_b, 0.0))
    if jnp.dtype(dt).itemsize < 8:
        eps = jnp.finfo(dt).eps
        rnorm = jnp.sqrt(_row_rsqr(r, axis))
        habs = noise_floor_mask(
            habs, beta_b,
            4 * eps * rnorm / jnp.maximum(prob.xwnorm, 1e-30))
    else:
        habs = noise_floor_mask(habs, beta_b)
    maxh = _feat_max(jnp.max(habs), feat_axis)
    # (re)activation: support blocks plus any block with a violating
    # coordinate (engine _full_check:681-682)
    viol = jnp.any(habs >= opt_tol, axis=1)
    active = jnp.any(beta_b != 0, axis=1) | viol
    return active, rsqr, maxh


def _tile_objective(kind, prob: RowProblem, r, beta_b, lam0, n_scale,
                    axis, feat_axis):
    """Global objective on a tiled mesh: data term psum'd over the obs
    axis, penalty psum'd over the feature axis (same normalization
    contract as ``sharded_cd._sharded_objective`` — it must be EXACTLY
    the functional the coordinate minimizers descend)."""
    pen = lam0 * lax.psum(
        jnp.sum(jnp.where(prob.valid, prob.lamw * jnp.abs(beta_b), 0.0)),
        feat_axis)
    if kind == "wls":
        # wls residuals are raw; the w-weighting lives in Xwb for
        # gradients — the objective needs the weighted square
        rn2 = lax.psum(jnp.dot(prob.wrow * r, r, precision=_PREC), axis)
    else:
        rn2 = _row_rsqr(r, axis)
    if kind == "sqrt":
        f = jnp.sqrt(jnp.maximum(rn2, 0.0))
    else:
        f = rn2 / (2.0 * n_scale)
    return f + pen


def _row_active_pass(kind, prob: RowProblem, beta_b, r, rsqr, active,
                     lam0, n_scale, randomize, key, axis,
                     feat_axis=None, n_feat: int = 1, opt_tol=0.0):
    """One pass over the active blocks.

    Pure row sharding (``feat_axis=None``): exact Gauss-Seidel — per
    visited block one ``psum(B)`` gradient, replicated in-block Gram
    recursion, local-row residual update.

    Tiled (obs × feature): each feature shard runs that exact sequential
    pass over ITS OWN column blocks concurrently (block-Jacobi across
    feature shards, the ``sharded_cd._sharded_active_pass`` scheme), the
    row-local residual corrections merge with one psum over the feature
    axis, and the merged step is convexity-safeguarded (full step iff it
    beats the always-monotone 1/D-averaged step) with the exact-sparsity
    snap."""
    nb, B = prob.lamw.shape
    key, k1, k2 = jax.random.split(key, 3)
    if randomize:
        border = jax.random.permutation(k1, nb)
        corder = jax.random.permutation(k2, B)
    else:
        border = jnp.arange(nb)
        corder = jnp.arange(B)
    r0, beta0_b = r, beta_b

    def body(t, carry):
        beta, r, rsqr, maxh = carry
        b = border[t]

        def do(args):
            beta, r, rsqr, maxh = args
            c = lax.psum(jnp.dot(prob.Xwb[b].T, r, precision=_PREC),
                         axis)
            bb = beta[b]
            bb2, rsqr2, mh = _visit_block(
                kind, prob.Kb[b], bb, prob.lamw[b], lam0, c, rsqr,
                n_scale, corder)
            r2 = r - jnp.dot(prob.Xb[b], bb2 - bb, precision=_PREC)
            return beta.at[b].set(bb2), r2, rsqr2, jnp.maximum(maxh, mh)

        return lax.cond(active[b], do, lambda a: a,
                        (beta, r, rsqr, maxh))

    zero = jnp.zeros((), beta_b.dtype)
    beta_b, r, rsqr, maxh = lax.fori_loop(
        0, nb, body, (beta_b, r, rsqr, zero))

    if feat_axis is not None:
        maxh = _feat_max(maxh, feat_axis)
        dbeta = beta_b - beta0_b
        dr = lax.psum(r - r0, feat_axis)
        if n_feat > 1:
            def at(t):
                return r0 + t * dr, beta0_b + t * dbeta

            p_full = _tile_objective(kind, prob, *at(1.0), lam0, n_scale,
                                     axis, feat_axis)
            tavg = 1.0 / n_feat
            p_avg = _tile_objective(kind, prob, *at(tavg), lam0, n_scale,
                                    axis, feat_axis)
            t = jnp.where(p_full <= p_avg, 1.0, tavg)
            r, beta_new = at(t)
            # exact-sparsity snap (see _sharded_active_pass:190-208)
            delta = jnp.where((beta_b == 0)
                              & (jnp.abs(beta_new) <= opt_tol),
                              beta_new, 0.0)
            beta_b = beta_new - delta
            corr = lax.cond(
                jnp.any(delta != 0),
                lambda: jnp.einsum("bnk,bk->n", prob.Xb, delta,
                                   precision=_PREC),
                lambda: jnp.zeros_like(r))
            r = r + lax.psum(corr, feat_axis)
        else:
            r = r0 + dr
            beta_b = beta0_b + dbeta
        if kind == "sqrt":
            rsqr = _row_rsqr(r, axis)

    active = jnp.any(beta_b != 0, axis=1)
    return beta_b, r, rsqr, active, key, maxh


def _row_solve_at_lambda(kind, opts: CDOptions, prob: RowProblem, lam0,
                         beta_b, r, rsqr, active, key, n_scale, axis,
                         feat_axis=None, n_feat: int = 1):
    """Engine epoch loop (``_solve_at_lambda``): alternate full KKT sweeps
    and active passes until two consecutive converged passes, with the
    f32 stall detector.  All convergence scalars derive from psum'd
    quantities, so the ``while_loop`` trips identically on every shard."""
    tol = opts.opt_tol
    dt = beta_b.dtype
    patience = (opts.stall_patience if jnp.dtype(dt).itemsize < 8
                else jnp.iinfo(jnp.int32).max)

    def cond(c):
        (_, _, _, _, _, it, conv, done, best, stall) = c
        return jnp.logical_and(~done, it < opts.max_iter)

    def body(c):
        beta, r, rsqr, active, key, it, conv, done, best, stall = c
        was_full = conv

        def full(args):
            beta, r, rsqr, active, key = args
            active, rsqr, maxh = _row_full_check(
                kind, prob, beta, r, rsqr, lam0, n_scale, tol, axis,
                feat_axis)
            return beta, r, rsqr, active, key, maxh

        def act(args):
            beta, r, rsqr, active, key = args
            beta, r, rsqr, active, key, maxh = _row_active_pass(
                kind, prob, beta, r, rsqr, active, lam0, n_scale,
                opts.randomize, key, axis, feat_axis, n_feat, tol)
            return beta, r, rsqr, active, key, maxh

        beta, r, rsqr, active, key, maxh = lax.cond(
            was_full, full, act, (beta, r, rsqr, active, key))
        conv2 = maxh < tol
        improved = was_full & (maxh < best)
        stall = jnp.where(was_full,
                          jnp.where(improved, 0, stall + 1), stall)
        best = jnp.where(was_full, jnp.minimum(best, maxh), best)
        done = (was_full & conv2) | (stall >= patience)
        return (beta, r, rsqr, active, key, it + 1, conv2, done, best,
                stall)

    init = (beta_b, r, rsqr, active, key, jnp.zeros((), jnp.int32),
            jnp.ones((), bool), jnp.zeros((), bool),
            jnp.asarray(jnp.inf, dt), jnp.zeros((), jnp.int32))
    beta_b, r, rsqr, active, key, *_ = lax.while_loop(cond, body, init)
    return beta_b, r, rsqr, active, key


def _row_lambda_max(kind, prob: RowProblem, r, rsqr, n_scale, axis,
                    feat_axis=None):
    c = _row_full_c(prob, r, axis)
    if kind == "sqrt":
        g = jnp.abs(c) / jnp.sqrt(jnp.maximum(rsqr, 1e-30))
    else:
        g = jnp.abs(c) / n_scale
    return _feat_max(jnp.max(jnp.where(prob.valid, g / prob.lamw, 0.0)),
                     feat_axis)


def _row_solve(kind, opts: CDOptions, prob: RowProblem, lam0, beta0_b,
               key, n_scale, axis, feat_axis=None, n_feat: int = 1):
    """Warm start or λmax→λ0 log-continuation (reference
    ``coordinateDescent!``, coordinate_descent.jl:7-39).  ``n_scale`` is
    the TRUE row count (padded rows are data-free and must not inflate
    the ls threshold ``n·λ0·λw``)."""
    dt = beta0_b.dtype

    def init(beta_b):
        pred = jnp.einsum("bnk,bk->n", prob.Xb, beta_b, precision=_PREC)
        if feat_axis is not None:
            # each tile predicts with its own columns only
            pred = lax.psum(pred, feat_axis)
        r = prob.y - pred
        rsqr = (_row_rsqr(r, axis) if kind == "sqrt"
                else jnp.zeros((), dt))
        return r, rsqr, jnp.any(beta_b != 0, axis=1)

    if opts.warm_start:
        r, rsqr, active = init(beta0_b)
        beta_b, r, rsqr, active, key = _row_solve_at_lambda(
            kind, opts, prob, lam0, beta0_b, r, rsqr, active, key,
            n_scale, axis, feat_axis, n_feat)
        return beta_b, r

    beta_b = jnp.zeros_like(beta0_b)
    r, rsqr, active = init(beta_b)
    lammax = _row_lambda_max(kind, prob, r, rsqr, n_scale, axis,
                             feat_axis)
    ts = jnp.linspace(jnp.log(lammax), jnp.log(jnp.asarray(lam0, dt)),
                      opts.num_steps + 1)
    lams = jnp.exp(ts)

    def scan_body(carry, lam):
        beta_b, r, rsqr, active, key = carry
        beta_b, r, rsqr, active, key = _row_solve_at_lambda(
            kind, opts, prob, lam, beta_b, r, rsqr, active, key,
            n_scale, axis, feat_axis, n_feat)
        return (beta_b, r, rsqr, active, key), None

    (beta_b, r, *_), _ = lax.scan(scan_body,
                                  (beta_b, r, rsqr, active, key), lams)
    return beta_b, r


@functools.lru_cache(maxsize=None)
def _make_row_sharded_cd(kind: str, opts: CDOptions, mesh: Mesh,
                         axis: str, feat_axis: str | None = None):
    n_feat = mesh.shape[feat_axis] if feat_axis else 1

    def local_fn(Xl, yl, w, lamw, valid, beta0, lam0, n_true, key):
        B = int(opts.block_size)
        nb = Xl.shape[1] // B
        prob = _row_build(kind, Xl, yl, w, lamw.reshape(nb, B),
                          valid.reshape(nb, B), B, axis)
        beta_b, r = _row_solve(kind, opts, prob,
                               jnp.asarray(lam0, Xl.dtype),
                               beta0.reshape(nb, B), key, n_true, axis,
                               feat_axis, n_feat)
        return beta_b.reshape(-1), r

    fspec = feat_axis  # None → replicated over the (absent) feature axis
    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(axis, fspec), P(axis), P(axis), P(fspec), P(fspec),
                  P(fspec), P(), P(), P()),
        out_specs=(P(fspec), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


def coordinate_descent_row_sharded(beta0, loss, penalty, mesh: Mesh,
                                   options: CDOptions = CDOptions(), *,
                                   axis: str = "obs",
                                   feat_axis: str | None = None,
                                   seed: int = 0, key=None):
    """Observation-sharded ``coordinate_descent``: rows of ``X`` (and the
    matching ``y`` / WLS-weight entries) partitioned over ``mesh[axis]``,
    β replicated.  Same driver contract as the reference
    ``coordinateDescent!`` (coordinate_descent.jl:7-39); returns
    ``(beta, residuals)`` with the FULL residual vector.

    With ``feat_axis`` the mesh is 2-D and ``X`` is **tiled**: rows over
    ``axis``, columns over ``feat_axis`` — each device holds an
    (n/D_obs × p/D_feat) tile, so neither axis need fit one chip.  Column
    blocks are solved exactly within a feature shard and merged
    block-Jacobi across feature shards with the convexity safeguard
    (``sharded_cd._sharded_active_pass`` scheme); certification is the
    same order-independent KKT sweep."""
    if isinstance(loss, (LeastSquaresLoss, WeightedLSLoss, SqrtLassoLoss)):
        X, y = loss.X, loss.y
    else:
        raise TypeError(
            "row-sharded CD supports LeastSquares/WeightedLS/SqrtLasso "
            f"losses; got {type(loss)!r}")
    if feat_axis is not None:
        if feat_axis not in mesh.shape:
            raise ValueError(f"feat_axis {feat_axis!r} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        if feat_axis == axis:
            raise ValueError("feat_axis must differ from the obs axis "
                             f"({axis!r})")
    kind = loss.kind
    X = jnp.asarray(X)
    dtype = X.dtype
    n, p = X.shape
    # zero-padding silently zeroes real data when lengths mismatch — fail
    # loudly like the single-device driver does
    if y.shape[0] != n:
        raise ValueError(f"y has {y.shape[0]} rows, X has {n}")
    if isinstance(loss, WeightedLSLoss) and loss.w.shape[0] != n:
        raise ValueError(f"weights have {loss.w.shape[0]} rows, X has {n}")
    if beta0.shape[0] != p:
        raise ValueError(f"beta0 has {beta0.shape[0]} coordinates, "
                         f"X has {p} columns")
    D = mesh.shape[axis]
    B = int(options.block_size)
    if feat_axis is not None:
        from .sharded_cd import _shard_chunk
        _, p_pad = _shard_chunk(p, mesh.shape[feat_axis], B)
    else:
        p_pad = -(-p // B) * B
    n_pad = -(-n // D) * D

    lam0, lamw = as_l1(penalty, p, dtype)
    if isinstance(penalty, ProxZero):
        if not options.warm_start:
            beta0 = jnp.zeros_like(beta0)
        options = options.replace(warm_start=True)

    # padded rows are all-zero (x, y, w): no psum contribution, residual
    # entries pinned at 0; padded columns get lamw=1 and valid=False
    Xp = jnp.pad(X, ((0, n_pad - n), (0, p_pad - p)))
    yp = _pad_vec_to(jnp.asarray(y, dtype), n_pad, 0.0)
    w = (loss.w if isinstance(loss, WeightedLSLoss)
         else jnp.ones((n,), dtype))
    wp = _pad_vec_to(jnp.asarray(w, dtype), n_pad, 0.0)
    lamwp = _pad_vec_to(lamw, p_pad, 1.0)
    validp = _pad_vec_to(jnp.ones((p,), bool), p_pad, False)
    beta0p = _pad_vec_to(jnp.asarray(beta0, dtype), p_pad, 0.0)
    if key is None:
        key = jax.random.PRNGKey(seed)

    solver = _make_row_sharded_cd(kind, options, mesh, axis, feat_axis)
    beta, r = solver(Xp, yp, wp, lamwp, validp, beta0p,
                     jnp.asarray(lam0, dtype), jnp.asarray(n, dtype),
                     key)
    return beta[:p], r[:n]


def lasso_row_sharded(X, y, lam, mesh: Mesh, weights=None,
                      options: CDOptions = CDOptions(), *,
                      axis: str = "obs", seed: int = 0):
    """Observation-sharded Lasso (reference ``lasso``, lasso.jl:26-53) —
    the large-n twin of ``parallel.lasso_sharded``."""
    from ..models.lasso import LassoSolution
    from ..utils.helpers import sample_std

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    g = ProxL1(jnp.asarray(lam, X.dtype),
               None if weights is None else jnp.asarray(weights, X.dtype))
    beta0 = jnp.zeros((X.shape[1],), X.dtype)
    beta, r = coordinate_descent_row_sharded(
        beta0, LeastSquaresLoss(y, X), g, mesh, options, axis=axis,
        seed=seed)
    return LassoSolution(beta, r, g, sample_std(r))


@functools.lru_cache(maxsize=None)
def _make_row_sharded_path(opts: CDOptions, mesh: Mesh, axis: str,
                           feat_axis: str | None, resume: bool = False):
    """Row/tile-sharded path program.  ``resume=True`` builds the
    continuation variant used by ``lasso_path_row_sharded(scan_chunk=…)``:
    the scan carry (β blocks, sharded residual, ‖r‖² scalar, active mask,
    key, stop flag) round-trips through the program boundary — identical
    trajectory, bounded single-program runtime (same contract as
    ``lasso_path(scan_chunk=…)``).  Padding to the sharded widths
    happens INSIDE the jitted ``outer`` (no eager padded design copy)."""
    n_feat = mesh.shape[feat_axis] if feat_axis else 1

    def local_fn(Xl, yl, lamw, valid, lam_path, max_hat_s, n_true, key,
                 carry_in):
        B = int(opts.block_size)
        nb = Xl.shape[1] // B
        dt = Xl.dtype
        w = jnp.ones((Xl.shape[0],), dt)
        prob = _row_build("ls", Xl, yl, w, lamw.reshape(nb, B),
                          valid.reshape(nb, B), B, axis)
        if resume:
            beta_b, r, rsqr, active, key, stopped0 = carry_in
        else:
            beta_b = jnp.zeros((nb, B), dt)
            r = yl
            rsqr = jnp.zeros((), dt)
            active = jnp.zeros((nb,), bool)
            stopped0 = jnp.zeros((), bool)

        def scan_body(carry, lam):
            beta_b, r, rsqr, active, key, stopped = carry

            def do(args):
                beta_b, r, rsqr, active, key = args
                return _row_solve_at_lambda(
                    "ls", opts, prob, lam, beta_b, r, rsqr, active, key,
                    n_true, axis, feat_axis, n_feat)

            beta_b, r, rsqr, active, key = lax.cond(
                stopped, lambda a: a, do, (beta_b, r, rsqr, active, key))
            valid_pt = ~stopped
            nnz = jnp.sum(beta_b != 0)
            if feat_axis is not None:
                nnz = lax.psum(nnz, feat_axis)
            stopped = stopped | (nnz > max_hat_s)
            return ((beta_b, r, rsqr, active, key, stopped),
                    (beta_b.reshape(-1), valid_pt))

        carry_out, (betas, valids) = lax.scan(
            scan_body, (beta_b, r, rsqr, active, key, stopped0), lam_path)
        return betas, valids, carry_out

    fspec = feat_axis
    carry_spec = (P(fspec), P(axis), P(), P(fspec), P(), P())
    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(axis, fspec), P(axis), P(fspec), P(fspec), P(), P(),
                  P(), P()) + ((carry_spec,) if resume else (P(),)),
        out_specs=(P(None, fspec), P(), carry_spec),
        check_vma=False,
    )

    def outer(X, y, lamw, lam_path, max_hat_s, n_true, key, carry_in):
        # pad rows/columns to the sharded widths inside the trace (see
        # sharded_cd._pad_cols_to — an eager pad keeps a second
        # full-size design live)
        n, p = X.shape
        B = int(opts.block_size)
        if feat_axis is not None:
            from .sharded_cd import _shard_chunk
            _, p_pad = _shard_chunk(p, mesh.shape[feat_axis], B)
        else:
            p_pad = -(-p // B) * B
        n_pad = -(-n // mesh.shape[axis]) * mesh.shape[axis]
        Xp = jnp.pad(X, ((0, n_pad - n), (0, p_pad - p)))
        yp = _pad_vec_to(y, n_pad, 0.0)
        lamwp = _pad_vec_to(lamw, p_pad, 1.0)
        validp = _pad_vec_to(jnp.ones((p,), bool), p_pad, False)
        return fn(Xp, yp, lamwp, validp, lam_path, max_hat_s, n_true,
                  key, carry_in)

    return jax.jit(outer)


def lasso_path_row_sharded(X, y, lam_path, mesh: Mesh,
                           options: CDOptions = CDOptions(), *,
                           max_hat_s: float = float("inf"),
                           standardize_X: bool = True, axis: str = "obs",
                           feat_axis: str | None = None,
                           scan_chunk: int | None = None, seed: int = 0):
    """Warm-started Lasso path on the observation-sharded (or tiled)
    layout — reference ``LassoPath`` (lasso.jl:229-260) for designs whose
    ROWS don't fit one chip.  Same early-stop semantics as
    ``lasso_path_sharded`` (first support-exceeding point kept); the
    per-coordinate loadings of ``standardize_X`` are the cross-shard
    column RMS (the divisor-is-n quirk preserved via utils.std_X on the
    full matrix before sharding).  ``scan_chunk > 0`` runs the scan as
    host-driven segments with the carry round-tripped between programs —
    the same bounded-runtime contract (and identical-trajectory
    guarantee) as ``lasso_path(scan_chunk=…)``."""
    import numpy as np
    from ..models.lasso_path import LassoPath
    from ..utils.helpers import std_X

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    n, p = X.shape
    if y.shape[0] != n:
        raise ValueError(f"y has {y.shape[0]} rows, X has {n}")
    if feat_axis is not None:
        if feat_axis not in mesh.shape:
            raise ValueError(f"feat_axis {feat_axis!r} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        if feat_axis == axis:
            raise ValueError("feat_axis must differ from the obs axis "
                             f"({axis!r})")
    if scan_chunk is not None and scan_chunk <= 0:
        raise ValueError("scan_chunk must be >= 1")
    lamw = std_X(X) if standardize_X else jnp.ones((p,), X.dtype)
    lam_path = jnp.asarray(lam_path, X.dtype)
    g = int(lam_path.shape[0])
    mhs = jnp.asarray(max_hat_s, X.dtype)
    n_true = jnp.asarray(n, X.dtype)
    key = jax.random.PRNGKey(seed)

    if scan_chunk and g > scan_chunk:
        from ..ops.batched_certify import run_chunked_segments

        fresh = _make_row_sharded_path(options, mesh, axis, feat_axis,
                                       False)
        cont = _make_row_sharded_path(options, mesh, axis, feat_axis,
                                      True)

        def run_segment(s, seg, carry):
            return (fresh if s == 0 else cont)(
                X, y, lamw, seg, mhs, n_true, key,
                jnp.zeros(()) if s == 0 else carry)

        betas, valids = run_chunked_segments(lam_path, int(scan_chunk),
                                             run_segment)
    else:
        # resume=False passed explicitly: same lru_cache entry (and the
        # same compiled program) as the chunked branch's fresh segment
        solver = _make_row_sharded_path(options, mesh, axis, feat_axis,
                                        False)
        betas, valids, _ = solver(X, y, lamw, lam_path, mhs, n_true, key,
                                  jnp.zeros(()))
    valids = np.asarray(valids)
    k = int(valids.sum())
    return LassoPath(lam_path[:k], betas[:k, :p])


def lasso_tile_sharded(X, y, lam, mesh: Mesh, weights=None,
                       options: CDOptions = CDOptions(), *,
                       axis: str = "obs", feat_axis: str = "feature",
                       seed: int = 0):
    """Tile-sharded Lasso on a 2-D (obs × feature) mesh: each device
    holds an (n/D_obs × p/D_feat) tile of ``X``, so problems too large
    for EITHER 1-D tier fit.  Row contractions psum over ``axis``,
    column blocks merge block-Jacobi (safeguarded) over ``feat_axis``;
    the returned solution satisfies the single-device KKT certificate."""
    from ..models.lasso import LassoSolution
    from ..utils.helpers import sample_std

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    g = ProxL1(jnp.asarray(lam, X.dtype),
               None if weights is None else jnp.asarray(weights, X.dtype))
    beta0 = jnp.zeros((X.shape[1],), X.dtype)
    beta, r = coordinate_descent_row_sharded(
        beta0, LeastSquaresLoss(y, X), g, mesh, options, axis=axis,
        feat_axis=feat_axis, seed=seed)
    return LassoSolution(beta, r, g, sample_std(r))


def sqrt_lasso_row_sharded(X, y, lam, mesh: Mesh, weights=None,
                           options: CDOptions = CDOptions(), *,
                           axis: str = "obs", seed: int = 0):
    """Observation-sharded Sqrt-Lasso (reference ``sqrtLasso``,
    lasso.jl:62-98)."""
    from ..models.lasso import LassoSolution
    from ..utils.helpers import sample_std

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    g = ProxL1(jnp.asarray(lam, X.dtype),
               None if weights is None else jnp.asarray(weights, X.dtype))
    beta0 = jnp.zeros((X.shape[1],), X.dtype)
    beta, r = coordinate_descent_row_sharded(
        beta0, SqrtLassoLoss(y, X), g, mesh, options, axis=axis,
        seed=seed)
    return LassoSolution(beta, r, g, sample_std(r))
