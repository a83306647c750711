"""Feature-sharded group-coordinate descent (group Lasso across devices).

The group engine (ops/group_cd.py — the reference driver's ``AtomIterate``
acceptance, src/coordinate_descent.jl:8) is the iterate family that most
resembles real block sharding: atoms are contiguous lane groups, so the
feature axis shards into whole groups with zero lane fragmentation.  This
module gives it the same multi-chip story as the scalar engine
(parallel/sharded_cd.py):

- columns (whole groups) partitioned over ``mesh[axis]``; ``y``/``r``
  replicated; each pass is exact sequential group-block CD within a shard,
  block-Jacobi across shards, merged by one residual ``psum`` over the mesh;
- the merged step is safeguarded (t=1 vs t=1/D on the global group-lasso
  objective — the averaged step always descends by convexity), with an
  exact group-sparsity snap so damped merges cannot leave sub-tolerance
  dust on groups a shard proposed to zero;
- convergence is declared only by the order-independent group-KKT sweep,
  ``pmax`` certificates, identical fixed points to the single-device engine.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.group_cd import (
    GroupProblem,
    GroupState,
    _block_width,
    _build_group_problem,
    _group_active_pass,
    _group_full_check,
    _group_lambda_max,
)
from ..ops.prox import ProxL1Group
from ..utils.options import CDOptions
from .sharded_cd import _pad_cols_to, _pad_vec_to

_PREC = lax.Precision.HIGHEST


def _group_norms(beta, k: int, G: int):
    """Per-group ℓ2 norms of a (nb, k·G) blocked iterate → (nb, k)."""
    nb = beta.shape[0]
    bg = beta.reshape(nb, k, G)
    return jnp.sqrt(jnp.sum(bg * bg, axis=2))


def _sharded_group_active_pass(prob: GroupProblem, st: GroupState, lam0,
                               n_scale, randomize, iters, axis,
                               n_shards: int, w, opt_tol):
    """One concurrent pass: exact sequential group-block CD within each
    shard against the replicated residual, block-Jacobi across shards,
    one residual psum merge + objective safeguard + exact group-zero snap
    (the group analogue of sharded_cd._sharded_active_pass)."""
    r0, beta0 = st.r, st.beta
    st2, maxh = _group_active_pass(prob, st, lam0, n_scale, randomize,
                                   iters)
    dbeta = st2.beta - beta0
    dr = lax.psum(st2.r - r0, axis)
    maxh = lax.pmax(maxh, axis)
    nb, B = prob.valid.shape
    k = prob.lamw.shape[1]
    G = B // k

    def objective(r, beta):
        pen = lam0 * lax.psum(
            jnp.sum(prob.lamw * _group_norms(beta, k, G)), axis)
        rw = r if w is None else w * r
        return jnp.dot(rw, r, precision=_PREC) / (2.0 * n_scale) + pen

    if n_shards > 1:
        def at(t):
            return r0 + t * dr, beta0 + t * dbeta

        p_full = objective(*at(1.0))
        tavg = 1.0 / n_shards
        p_avg = objective(*at(tavg))
        t = jnp.where(p_full <= p_avg, 1.0, tavg)
        r_new, beta_new = at(t)
        # exact group-sparsity snap: groups the shard proposed to zero
        # whose damped merge left ≤-tol dust are zeroed, with the
        # replicated residual corrected (same rationale as the scalar
        # engine's snap — keeps the prox's exact-zero semantics)
        prop_zero = _group_norms(st2.beta, k, G) == 0          # (nb, k)
        dust = _group_norms(beta_new, k, G) <= opt_tol
        snap = jnp.repeat(prop_zero & dust, G, axis=1)         # (nb, B)
        delta = jnp.where(snap, beta_new, 0.0)
        beta_new = beta_new - delta
        corr = lax.cond(
            jnp.any(delta != 0),
            lambda: jnp.einsum("bnk,bk->n", prob.Xb, delta,
                               precision=_PREC),
            lambda: jnp.zeros_like(r_new))
        r_new = r_new + lax.psum(corr, axis)
    else:
        r_new, beta_new = r0 + dr, beta0 + dbeta

    active = jnp.any(beta_new != 0, axis=1)
    return st2._replace(r=r_new, beta=beta_new, active=active), maxh


def _sharded_group_solve_at_lambda(opts: CDOptions, prob: GroupProblem,
                                   lam0, st: GroupState, n_scale, axis,
                                   n_shards: int, w) -> GroupState:
    """Epoch loop: alternate pmax'd group-KKT sweeps and concurrent active
    passes until two consecutive converged passes — the distributed mirror
    of group_cd._group_solve_at_lambda (convergence scalars replicated
    post-gather so the while_loop trips identically on every shard)."""
    tol = opts.opt_tol
    dtype = st.beta.dtype
    patience = (opts.stall_patience
                if jnp.dtype(dtype).itemsize < 8
                else jnp.iinfo(jnp.int32).max)

    def cond(c):
        s, best, stall = c
        return jnp.logical_and(~s.done, s.it < opts.max_iter)

    def body(c):
        s, best, stall = c
        was_full = s.conv

        def full(s):
            s2, maxh = _group_full_check(prob, s, lam0, n_scale, tol)
            return s2, lax.pmax(maxh, axis)

        def act(s):
            return _sharded_group_active_pass(
                prob, s, lam0, n_scale, opts.randomize, opts.block_iters,
                axis, n_shards, w, tol)

        s2, maxh = lax.cond(was_full, full, act, s)
        conv = maxh < tol
        improved = was_full & (maxh < best)
        stall = jnp.where(was_full,
                          jnp.where(improved, 0, stall + 1), stall)
        best = jnp.where(was_full, jnp.minimum(best, maxh), best)
        done = (was_full & conv) | (stall >= patience)
        return (s2._replace(it=s.it + 1, conv=conv, done=done), best, stall)

    st = st._replace(it=jnp.zeros((), jnp.int32), conv=jnp.ones((), bool),
                     done=jnp.zeros((), bool))
    init = (st, jnp.asarray(jnp.inf, dtype), jnp.zeros((), jnp.int32))
    st, _, _ = lax.while_loop(cond, body, init)
    return st


@functools.lru_cache(maxsize=None)
def _make_sharded_group(G: int, opts: CDOptions, mesh: Mesh, axis: str,
                        weighted: bool):
    D = mesh.shape[axis]

    def local_fn(Xl, y, w, lamw_gl, lam0, beta0l, key):
        wv = w if weighted else None
        prob = _build_group_problem(Xl, y, lamw_gl, G, wv)
        nb, B = prob.valid.shape
        p_local = Xl.shape[1]
        beta_g = jnp.pad(beta0l, (0, nb * B - p_local)).reshape(nb, B)
        n_scale = jnp.asarray(y.shape[0], Xl.dtype)
        pred = jnp.einsum("bnk,bk->n", prob.Xb, beta_g, precision=_PREC)
        r = prob.y - lax.psum(pred, axis)
        st = GroupState(beta=beta_g, r=r,
                        active=jnp.any(beta_g != 0, axis=1), key=key,
                        it=jnp.zeros((), jnp.int32),
                        conv=jnp.ones((), bool),
                        done=jnp.zeros((), bool))

        if opts.warm_start:
            st = _sharded_group_solve_at_lambda(opts, prob, lam0, st,
                                                n_scale, axis, D, wv)
        else:
            lammax = lax.pmax(_group_lambda_max(prob, st, n_scale),
                                  axis)
            ts = jnp.linspace(jnp.log(lammax), jnp.log(lam0),
                              opts.num_steps + 1)

            def scan_body(s, lam):
                return _sharded_group_solve_at_lambda(
                    opts, prob, jnp.exp(lam), s, n_scale, axis, D, wv), None

            st, _ = lax.scan(scan_body, st, ts)
        return st.beta.reshape(-1)[:p_local], st.r

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P(), P(axis), P(), P(axis), P()),
        out_specs=(P(axis), P()),
        check_vma=False,
    )

    def outer(X, y, w, lamw_g, lam0, beta0, key):
        # pad to the sharded group width INSIDE the trace (same rationale
        # as sharded_cd._pad_cols_to: an eager pad materializes a second
        # full-size design on top of the blocked layout — the ×3
        # multiplier that OOMed the headline shape on one chip)
        p = X.shape[1]
        B = _block_width(G)
        k = B // G
        ng = -(-p // G)
        ng_shard = -(-ng // (D * k)) * k
        G_tot = ng_shard * D
        P_tot = G_tot * G
        return fn(_pad_cols_to(X, P_tot), y, w,
                  _pad_vec_to(lamw_g, G_tot, 1.0), lam0,
                  _pad_vec_to(beta0, P_tot, 0.0), key)

    return jax.jit(outer)


def group_coordinate_descent_sharded(beta0, loss, penalty: ProxL1Group,
                                     mesh: Mesh,
                                     options: CDOptions = CDOptions(), *,
                                     axis: str = "feature", seed: int = 0,
                                     key=None):
    """Feature-sharded group-coordinate descent: the reference driver with
    an ``AtomIterate`` (coordinate_descent.jl:8) scaled over a device mesh
    — whole groups are partitioned across ``mesh[axis]`` (groups never
    span shards), one psum merges the per-shard residual corrections, and
    the safeguarded merge + group-KKT sweep certify the same fixed points
    as the single-device engine.  LS and weighted-LS losses (the same
    acceptance as group_coordinate_descent).  Returns ``(beta, r)``."""
    from ..ops.losses import LeastSquaresLoss, WeightedLSLoss

    if isinstance(loss, WeightedLSLoss):
        w = jnp.asarray(loss.w, loss.X.dtype)
        weighted = True
    elif isinstance(loss, LeastSquaresLoss):
        w = None
        weighted = False
    else:
        raise TypeError("sharded group penalty supports the least-squares "
                        "and weighted-LS losses")
    X, y = loss.X, loss.y
    n, p = X.shape
    G = int(penalty.group_size)
    if G < 1:
        raise ValueError("group_size must be ≥ 1")
    ng = -(-p // G)
    dtype = X.dtype
    lamw_g = (jnp.ones((ng,), dtype) if penalty.weights is None
              else jnp.asarray(penalty.weights, dtype))
    if lamw_g.shape != (ng,):
        raise ValueError(f"group weight vector has shape {lamw_g.shape}, "
                         f"expected ({ng},)")

    if key is None:
        key = jax.random.PRNGKey(seed)

    # group/column padding to the sharded width happens INSIDE the jitted
    # solver (the maker's `outer` wrapper) — no eager padded copy
    solver = _make_sharded_group(G, options, mesh, axis, weighted)
    beta, r = solver(jnp.asarray(X, dtype), jnp.asarray(y, dtype),
                     (jnp.zeros((n,), dtype) if w is None else w),
                     lamw_g, jnp.asarray(penalty.lam0, dtype),
                     jnp.asarray(beta0, dtype), key)
    return beta[:p], r


def group_lasso_sharded(X, y, lam, group_size: int, mesh: Mesh,
                        weights=None, options: CDOptions = CDOptions(), *,
                        axis: str = "feature", seed: int = 0):
    """Feature-sharded Group Lasso over consecutive equal-size groups —
    the multi-chip twin of :func:`~coordinatedescent_jl_tpu.group_lasso`.
    Returns a ``LassoSolution``."""
    from ..models.lasso import LassoSolution
    from ..utils.helpers import sample_std
    from ..ops.losses import LeastSquaresLoss

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    g = ProxL1Group(jnp.asarray(lam, X.dtype), int(group_size),
                    None if weights is None else jnp.asarray(weights,
                                                             X.dtype))
    beta0 = jnp.zeros((X.shape[1],), X.dtype)
    beta, r = group_coordinate_descent_sharded(
        beta0, LeastSquaresLoss(y, X), g, mesh, options, axis=axis,
        seed=seed)
    return LassoSolution(beta, r, g, sample_std(r))
