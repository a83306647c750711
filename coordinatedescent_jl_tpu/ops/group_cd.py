"""Group-coordinate (atom) descent engine.

JAX implementation of the reference driver's ``AtomIterate``
acceptance (``src/coordinate_descent.jl:8``): ProximalBase's
``AtomIterate`` splits the iterate into equal-size atoms and ``cdprox!``
applies the ℓ2 prox per atom, i.e. the solved problem is the group Lasso

    min_β ‖y − Xβ‖² / (2n) + λ0 Σ_g ω_g ‖β_g‖₂ .

Design mirrors the scalar block engine (block_cd.py) — and the key to
making group visits lane-dense is NOT one-group-per-visit (a (n, G) slice
wastes 128−G lanes and serializes p/G tiny steps) but **blocks of
``k = ⌊128/G⌋`` whole groups**:

- ``X`` is stored column-blocked ``(nb, n, B)`` with ``B = k·G`` — a block
  visit touches ``k`` groups at once in one contiguous load.
- All per-block Grams ``K_b = X_b'X_b`` are precomputed once at build (the
  same cached-Gram lever as ``CDOptions.cache_gram``), along with the
  Gershgorin bound ``L_b ≥ λmax(K_b)``.
- A visit runs ``block_iters`` FISTA steps of proximal gradient on the
  block's joint subproblem with the group-separable prox
  (``group_soft_threshold`` over the ``(k, G)`` view) — the group analogue
  of ``block_cd._block_ista`` — followed by an exact per-group
  zero-snap so finite inner budgets keep exact group sparsity.  Inexact
  visits are sound exactly as in the scalar engine: convergence is only
  declared by the order-independent group-KKT fixed-point sweep.
- Full sweep: ``c = X'r`` for every group at once; one prox-gradient step
  from the current iterate is zero iff the group-KKT conditions hold
  (for β_g = 0: ‖X_g'r‖₂ ≤ n·λ0·ω_g; else X_g'r = n·λ0·ω_g·β_g/‖β_g‖).
  The reference's two-consecutive-converged-passes rule
  (coordinate_descent.jl:72-90), the active-block mask, λ-continuation and
  the f32 stall detector all carry over unchanged.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .block_cd import noise_floor_mask
from .prox import ProxL1Group, group_soft_threshold
from ..utils.options import CDOptions

_PREC = lax.Precision.HIGHEST


class GroupProblem(NamedTuple):
    """Group-blocked problem data (``k`` groups of width ``G`` per block,
    ``B = k·G`` lanes).  For the weighted-LS loss ``Xwb`` holds the
    row-weighted blocks ``diag(w)·X`` (the same array as ``Xb`` when
    unweighted): gradients are ``Xw'r``, Grams ``Xw'X``, residual updates
    use the raw ``X`` — mirroring block_cd's ls/wls split."""

    Xb: jnp.ndarray     # (nb, n, B) column blocks
    Xwb: jnp.ndarray    # (nb, n, B) row-weighted blocks (= Xb for ls)
    Kb: jnp.ndarray     # (nb, B, B) cached per-block Grams Xw_b'X_b
    y: jnp.ndarray      # (n,)
    Lb: jnp.ndarray     # (nb,) Gershgorin bound ≥ λmax(K_b)
    lamw: jnp.ndarray   # (nb, k) per-group penalty weights
    valid: jnp.ndarray  # (nb, B) column padding mask
    xwnorm: jnp.ndarray  # (nb, B) ‖Xw_j‖ — gradient accumulation-noise
                         # scale for the f32 noise floor


class GroupState(NamedTuple):
    beta: jnp.ndarray    # (nb, B)
    r: jnp.ndarray       # (n,)
    active: jnp.ndarray  # (nb,) bool
    key: jnp.ndarray
    it: jnp.ndarray
    conv: jnp.ndarray
    done: jnp.ndarray


def _block_width(G: int) -> int:
    """Lanes per block: as many whole groups as fit a 128-lane vector
    (one group per block when G > 128)."""
    return G * max(1, 128 // G)


def _build_group_problem(X, y, lamw_g, G: int, w=None) -> GroupProblem:
    n, p = X.shape
    B = _block_width(G)
    k = B // G
    ng = -(-p // G)
    nb = -(-ng // k)
    P = nb * B
    if P != p:
        X = jnp.pad(X, ((0, 0), (0, P - p)))
    Xb = X.reshape(n, nb, B).transpose(1, 0, 2)
    if w is None:
        Xwb = Xb
    else:
        Xwb = Xb * w[None, :, None]
    valid = (jnp.arange(P).reshape(nb, B) < p)
    Kb = jnp.einsum("bnk,bnl->bkl", Xwb, Xb, precision=_PREC)
    # Gershgorin row-sum bound ≥ λmax(K_b): always-safe majorizer for the
    # block's joint prox-gradient steps (no power iteration to go wrong)
    Lb = jnp.max(jnp.sum(jnp.abs(Kb), axis=2), axis=1)
    lamw_b = jnp.pad(jnp.asarray(lamw_g, X.dtype),
                     (0, nb * k - ng), constant_values=1.0).reshape(nb, k)
    xwnorm = jnp.sqrt(jnp.einsum("bnk,bnk->bk", Xwb, Xwb,
                                 precision=_PREC))
    return GroupProblem(Xb=Xb, Xwb=Xwb, Kb=Kb, y=y, Lb=Lb, lamw=lamw_b,
                        valid=valid, xwnorm=xwnorm)


def _group_prox(z, thr, k: int, G: int):
    """Group soft threshold over the (…, k·G) lane axis viewed as (k, G)
    groups; ``thr`` has a trailing (k,) axis."""
    shp = z.shape
    zg = z.reshape(shp[:-1] + (k, G))
    out = group_soft_threshold(zg, thr[..., None], axis=-1, keepdims=True)
    return out.reshape(shp)


def _block_visit(K, c0, beta0, L, thr, k: int, G: int, iters: int):
    """``iters`` FISTA proximal-gradient steps on one block's joint
    subproblem with the group-separable prox (the group analogue of
    block_cd._block_ista).  Entering gradient ``c0 = X_b'r``; the
    running gradient at iterate ``b`` is ``c0 − K(b − beta0)`` (Gram
    recursion — no X reads).  ``thr`` is the per-group prox level / L.

    Exact per-group zero-snap epilogue: a finite FISTA budget leaves tiny
    nonzero dust on groups whose exact solo-optimum is 0; the exact zero
    condition given the others fixed is ``‖c_g + K_gg·d_g‖ ≤ L·thr_g``
    (the group-KKT zero branch), and snapping those groups keeps the
    active mask honest and the solver's exact group sparsity."""
    dt = c0.dtype

    def body(_, carry):
        d, d_prev, t = carry
        t_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        yv = d + ((t - 1.0) / t_next) * (d - d_prev)
        grad = c0 - jnp.dot(K, yv - beta0, precision=_PREC,
                            preferred_element_type=dt)
        d_new = _group_prox(yv + grad / L, thr, k, G)
        return d_new, d, t_next

    d, _, _ = lax.fori_loop(0, iters, body,
                            (beta0, beta0, jnp.ones((), dt)))
    # solo-zero snap: back out each group's own contribution from the
    # running gradient via the diagonal G×G blocks of K
    q = c0 - jnp.dot(K, d - beta0, precision=_PREC,
                     preferred_element_type=dt)       # (B,) = X'(r − XΔ)
    Kdiag = jnp.diagonal(
        K.reshape(k, G, k, G), axis1=0, axis2=2)       # (G, G, k)
    dg = d.reshape(k, G)
    own = jnp.einsum("ijk,kj->ki", Kdiag, dg, precision=_PREC)  # (k, G)
    s = q.reshape(k, G) + own                          # c_g at d_g = 0
    solo_zero = jnp.sqrt(jnp.sum(s * s, axis=1)) <= L * thr
    d = jnp.where(jnp.repeat(solo_zero, G), 0.0, d)
    return d, jnp.max(jnp.abs(d - beta0))


def _group_active_pass(prob: GroupProblem, st: GroupState, lam0, n_scale,
                       randomize: bool, iters: int):
    """One Gauss-Seidel pass over the active blocks — ``k`` groups per
    visit (reference nonzero pass, coordinate_descent.jl:94-110, at atom
    granularity)."""
    nb, B = prob.valid.shape
    k = prob.lamw.shape[1]
    G = B // k
    key, k1 = jax.random.split(st.key)
    order = (jax.random.permutation(k1, nb) if randomize
             else jnp.arange(nb))

    def body(t, carry):
        beta, r, maxh = carry
        b = order[t]

        def do(args):
            beta, r, maxh = args
            Xg = prob.Xb[b]
            c0 = jnp.dot(prob.Xwb[b].T, r, precision=_PREC)
            L = jnp.maximum(prob.Lb[b], 1e-30)
            thr = n_scale * lam0 * prob.lamw[b] / L
            b0 = beta[b]
            b1, mh = _block_visit(prob.Kb[b], c0, b0, L, thr, k, G, iters)
            b1 = jnp.where(prob.valid[b], b1, 0.0)
            h = b1 - b0
            r2 = r - jnp.dot(Xg, h, precision=_PREC)
            return (beta.at[b].set(b1), r2, jnp.maximum(maxh, mh))

        return lax.cond(st.active[b], do, lambda a: a, (beta, r, maxh))

    zero = jnp.zeros((), st.beta.dtype)
    beta, r, maxh = lax.fori_loop(0, nb, body, (st.beta, st.r, zero))
    active = jnp.any(beta != 0, axis=1)
    return st._replace(beta=beta, r=r, active=active, key=key), maxh


def _group_full_check(prob: GroupProblem, st: GroupState, lam0, n_scale,
                      opt_tol):
    """Vectorized fixed-point sweep: one prox-gradient step per group from
    the current iterate — zero iff the group-KKT conditions hold
    (for β_g = 0: ‖X_g'r‖₂ ≤ n·λ0·ω_g; else X_g'r = n·λ0·ω_g·β_g/‖β_g‖).
    Blocks with steps ≥ tol are (re)activated."""
    nb, B = prob.valid.shape
    k = prob.lamw.shape[1]
    G = B // k
    c = jnp.einsum("bnk,n->bk", prob.Xwb, st.r, precision=_PREC)
    L = jnp.maximum(prob.Lb, 1e-30)[:, None]
    z = st.beta + c / L
    thr = n_scale * lam0 * prob.lamw / jnp.maximum(prob.Lb, 1e-30)[:, None]
    bstar = _group_prox(z, thr, k, G)
    h = jnp.where(prob.valid, bstar - st.beta, 0.0)
    # per-coordinate computational noise floor (block_cd.noise_floor_mask):
    # the group step is c/L_b, so its gradient-noise scale is
    # κ·eps·‖Xw_j‖·‖r‖/L_b
    if jnp.dtype(st.beta.dtype).itemsize < 8:
        eps = jnp.finfo(st.beta.dtype).eps
        rnorm = jnp.sqrt(jnp.dot(st.r, st.r, precision=_PREC))
        step_noise = 4 * eps * rnorm * prob.xwnorm / L
    else:
        step_noise = None
    habs = noise_floor_mask(jnp.abs(h), st.beta, step_noise)
    maxh = jnp.max(habs)
    viol = jnp.any(habs >= opt_tol, axis=1)
    active = jnp.any(st.beta != 0, axis=1) | viol
    return st._replace(active=active), maxh


def _group_solve_at_lambda(opts: CDOptions, prob: GroupProblem, lam0,
                           st: GroupState, n_scale) -> GroupState:
    """Epoch loop: alternate full sweeps / active passes until two
    consecutive converged passes (full confirming), with the f32 stall
    escape — structurally identical to block_cd._solve_at_lambda."""
    tol = opts.opt_tol
    dtype = st.beta.dtype
    patience = (opts.stall_patience
                if jnp.dtype(dtype).itemsize < 8 else jnp.iinfo(jnp.int32).max)

    def cond(c):
        s, best, stall = c
        return jnp.logical_and(~s.done, s.it < opts.max_iter)

    def body(c):
        s, best, stall = c
        was_full = s.conv

        def full(s):
            return _group_full_check(prob, s, lam0, n_scale, tol)

        def act(s):
            return _group_active_pass(prob, s, lam0, n_scale,
                                      opts.randomize, opts.block_iters)

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


def _group_lambda_max(prob: GroupProblem, st: GroupState, n_scale):
    """Smallest λ0 with all-zero solution: ``max_g ‖X_g'y‖₂ / (n·ω_g)``."""
    nb, B = prob.valid.shape
    k = prob.lamw.shape[1]
    G = B // k
    c = jnp.einsum("bnk,n->bk", prob.Xwb, st.r, precision=_PREC)
    cg = jnp.where(prob.valid, c, 0.0).reshape(nb, k, G)
    nrm = jnp.sqrt(jnp.sum(cg * cg, axis=2))
    return jnp.max(nrm / (n_scale * jnp.maximum(prob.lamw, 1e-30)))


@functools.partial(jax.jit, static_argnames=("G", "opts"))
def _group_cd_core(X, y, lam0, lamw_g, beta0, key, G: int,
                   opts: CDOptions, w=None):
    n, p = X.shape
    dtype = X.dtype
    prob = _build_group_problem(X, y, lamw_g, G, w)
    nb, B = prob.valid.shape
    beta_g = jnp.pad(beta0, (0, nb * B - p)).reshape(nb, B)
    n_scale = jnp.asarray(n, dtype)
    lam0 = jnp.asarray(lam0, dtype)

    def init_state(beta_g, key):
        r = prob.y - jnp.einsum("bnk,bk->n", prob.Xb, beta_g,
                                precision=_PREC)
        return GroupState(beta=beta_g, r=r,
                          active=jnp.any(beta_g != 0, axis=1), key=key,
                          it=jnp.zeros((), jnp.int32),
                          conv=jnp.ones((), bool),
                          done=jnp.zeros((), bool))

    if opts.warm_start:
        st = _group_solve_at_lambda(opts, prob, lam0,
                                    init_state(beta_g, key), n_scale)
    else:
        st = init_state(jnp.zeros_like(beta_g), key)
        lammax = _group_lambda_max(prob, st, n_scale)
        ts = jnp.linspace(jnp.log(lammax), jnp.log(lam0),
                          opts.num_steps + 1)

        def scan_body(s, lam):
            return _group_solve_at_lambda(opts, prob, jnp.exp(lam), s,
                                          n_scale), None

        st, _ = lax.scan(scan_body, st, ts)
    return st.beta.reshape(-1)[:p], st.r


@functools.partial(jax.jit, static_argnames=("G", "opts"))
def _group_sqrt_core(X, y, lam0, lamw_g, beta0, key, G: int,
                     opts: CDOptions):
    """Group atoms × sqrt-lasso loss: ``min ‖y − Xβ‖₂ + λ0 Σ_g ω_g ‖β_g‖``
    — the last loss×iterate cell of the reference's loss-generic driver
    (coordinate_descent.jl:8 accepts any loss with any iterate; the
    scalar sqrt minimizer is cd_differentiable_function.jl:242-291).

    MM via the variational identity ``‖r‖ = min_ρ (‖r‖²/(2ρ) + ρ/2)``:
    with ``ρ = ‖r‖`` fixed, the majorized subproblem is exactly the LS
    group engine's objective ``½‖r‖² + ρ·λ0·Σ ω_g‖β_g‖`` — i.e. one call
    to ``_group_solve_at_lambda`` with ``n_scale := ρ`` (the same lever
    the scalar engine's scaled-lasso σ rounds use, models/lasso.py).
    Each round is certified by the order-independent group-KKT sweep at
    the UPDATED ρ, so the declared fixed point satisfies the true sqrt
    group-KKT conditions: ``‖X_g'r‖ ≤ λ0·ω_g·‖r‖`` on zero groups,
    ``X_g'r = λ0·ω_g·‖r‖·β_g/‖β_g‖`` on active ones — the group analogue
    of the engine's ``|X_j'r| ≤ λ·‖r‖`` rule (block_cd._sqrt_candidate).
    ``warm_start=False`` zeroes β first (the subproblems then warm-start
    across MM rounds, matching the reference-default direct-solve
    semantics of ``sqrtLasso``, utils.jl:19)."""
    n, p = X.shape
    dtype = X.dtype
    prob = _build_group_problem(X, y, lamw_g, G, None)
    nb, B = prob.valid.shape
    if not opts.warm_start:
        beta0 = jnp.zeros_like(beta0)
    beta_g = jnp.pad(beta0, (0, nb * B - p)).reshape(nb, B)
    lam0 = jnp.asarray(lam0, dtype)
    tol = opts.opt_tol

    r0 = prob.y - jnp.einsum("bnk,bk->n", prob.Xb, beta_g,
                             precision=_PREC)
    st0 = GroupState(beta=beta_g, r=r0,
                     active=jnp.any(beta_g != 0, axis=1), key=key,
                     it=jnp.zeros((), jnp.int32),
                     conv=jnp.ones((), bool), done=jnp.zeros((), bool))

    def rho(s):
        return jnp.sqrt(jnp.maximum(
            jnp.dot(s.r, s.r, precision=_PREC), 1e-30))

    def cond(c):
        _, it, done = c
        return jnp.logical_and(~done, it < opts.max_iter)

    def body(c):
        s, it, done = c
        s = _group_solve_at_lambda(opts, prob, lam0, s, rho(s))
        # certify at the POST-solve ρ: zero sweep step there means the
        # true sqrt group-KKT holds, not just the majorizer's
        _, maxh = _group_full_check(prob, s, lam0, rho(s), tol)
        return (s, it + 1, maxh < tol)

    st, _, _ = lax.while_loop(cond, body,
                              (st0, jnp.zeros((), jnp.int32),
                               jnp.zeros((), bool)))
    return st.beta.reshape(-1)[:p], st.r


def group_coordinate_descent(beta0, loss, penalty: ProxL1Group,
                             options: CDOptions = CDOptions(), *,
                             seed: int = 0, key=None):
    """Minimize ``loss(β) + λ0 Σ_g ω_g ‖β_g‖₂`` over equal-size consecutive
    groups — the reference driver with an ``AtomIterate``
    (coordinate_descent.jl:8; its signature is loss-generic).  Accepts
    the least-squares, weighted-least-squares and sqrt-lasso losses
    (wls is the one with a real consumer: group-penalized varying
    coefficients, where the (degree+1)-sized expanded blocks are literal
    groups; sqrt completes the loss×iterate acceptance matrix via
    ``_group_sqrt_core``'s MM rounds).  Returns ``(beta, residuals)``."""
    from .losses import LeastSquaresLoss, SqrtLassoLoss, WeightedLSLoss

    sqrt_loss = False
    if isinstance(loss, WeightedLSLoss):
        w = jnp.asarray(loss.w, loss.X.dtype)
    elif isinstance(loss, SqrtLassoLoss):
        w = None
        sqrt_loss = True
    elif isinstance(loss, LeastSquaresLoss):
        w = None
    else:
        raise TypeError("group penalty supports the least-squares, "
                        "weighted-LS and sqrt-lasso losses")
    X, y = loss.X, loss.y
    p = X.shape[1]
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
    if sqrt_loss:
        return _group_sqrt_core(X, jnp.asarray(y, dtype),
                                jnp.asarray(penalty.lam0, dtype), lamw_g,
                                jnp.asarray(beta0, dtype), key, G,
                                options)
    return _group_cd_core(X, jnp.asarray(y, dtype),
                          jnp.asarray(penalty.lam0, dtype), lamw_g,
                          jnp.asarray(beta0, dtype), key, G, options, w)


def group_lasso(X, y, lam, group_size: int, weights=None,
                options: CDOptions = CDOptions(), *, seed: int = 0):
    """Group Lasso over consecutive equal-size groups:
    ``min ‖y−Xβ‖²/(2n) + λ Σ_g ω_g ‖β_g‖₂``.  Returns a
    ``LassoSolution`` like :func:`~coordinatedescent_jl_tpu.lasso`."""
    from ..models.lasso import LassoSolution
    from ..utils.helpers import sample_std
    from .losses import LeastSquaresLoss

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    g = ProxL1Group(jnp.asarray(lam, X.dtype), int(group_size),
                    None if weights is None else jnp.asarray(weights,
                                                             X.dtype))
    beta0 = jnp.zeros((X.shape[1],), X.dtype)
    beta, r = group_coordinate_descent(beta0, LeastSquaresLoss(y, X), g,
                                       options, seed=seed)
    return LassoSolution(beta, r, g, sample_std(r))
