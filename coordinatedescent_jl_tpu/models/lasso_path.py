"""Warm-started regularization paths + OLS refits.

JAX equivalents of reference ``src/lasso.jl:203-260``:

- ``lasso_path``        — ``LassoPath`` (lasso.jl:229-260): warm-start β
  across a decreasing λ grid, early-stop when the support size exceeds
  ``max_hat_s``.
- ``refit_lasso_path``  — ``refitLassoPath`` (lasso.jl:208-225): one OLS
  refit per distinct support.

The path solve is a single XLA program: a ``lax.scan`` over λ points
carrying ``(β, residuals, active mask)``; early stopping is a carried flag
that turns later solves into no-ops (compiled programs need static shapes, so
truncation happens on the host afterwards).
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.batched_certify import (
    kkt_violation_lanes,
    run_chunked_segments,
    stall_escape_update,
    union_block_fista,
    union_priority,
)
from ..ops.block_cd import (
    _compact_mode,
    _empty_ws_cache,
    _extrapolate_path_start,
    _init_state,
    _solve_at_lambda_ws,
    _to_blocked_beta,
    build_blocked,
    solve_blocked,
)
from ..utils.helpers import std_X
from ..utils.options import (CDOptions, auto_batch_lanes,
                             resolve_extrapolate)


class LassoPath(NamedTuple):
    """Mirrors reference ``LassoPath`` (lasso.jl:203-206); ``beta_path`` is a
    dense ``(num_lambda, p)`` matrix (zeros encode sparsity)."""

    lam_path: jnp.ndarray   # (num_lambda,)
    beta_path: jnp.ndarray  # (num_lambda, p)


@functools.partial(jax.jit, static_argnames=("opts", "resume"))
def _lasso_path_core(X, y, lam_path, lamw, key, max_hat_s,
                     opts: CDOptions, carry_in=None, resume: bool = False):
    """One warm-started scan over ``lam_path``.

    Returns ``(betas, valids, carry_out)``.  With ``resume=True`` the scan
    starts from ``carry_in`` (the ``carry_out`` of a previous segment)
    instead of the zero state — the host-chunked driver in ``lasso_path``
    uses this to bound any single device program's execution time while
    keeping the exact single-scan trajectory."""
    prob = build_blocked("ls", opts, lamw, X=X, y=y)
    p = X.shape[1]
    n_scale = jnp.asarray(y.shape[0], X.dtype)
    nc = _compact_mode("ls", opts, prob, X.dtype)
    if resume:
        st0, cache0, beta_prev0, lam_k0, lam_km10, stopped0 = carry_in
    else:
        beta_b0 = _to_blocked_beta(jnp.zeros((p,), X.dtype),
                                   opts.block_size)
        # the FULL solver state is carried across path points: the
        # residual is maintained exactly by the passes (no per-point
        # re-initialization sweep over X), and the confirming KKT sweep's
        # cached gradient is λ-independent, so the next point's first full
        # check is O(p) — two of the three O(n·p) X reads per path point
        # disappear vs naive warm starting (the reference re-runs
        # initialize! per point, lasso.jl:250)
        st0 = _init_state("ls", prob, beta_b0, key)
        # the compaction working-set cache rides the path carry: the
        # support only grows along a decreasing λ grid, so most points
        # reuse one gather
        cache0 = _empty_ws_cache("ls", prob, nc, opts) if nc else None
        beta_prev0 = st0.beta
        # both abscissa carries start at the first path value so the first
        # two steps skip the shift (block_cd.secant_alpha)
        lam_k0 = lam_km10 = lam_path[0]
        stopped0 = jnp.zeros((), bool)

    def scan_body(carry, lam):
        st, cache, beta_prev, lam_k, lam_km1, stopped = carry
        beta_k = st.beta

        def do(args):
            st, cache = args
            key, k1 = jax.random.split(st.key)
            if opts.warm_start:
                if nc and resolve_extrapolate(opts, False):
                    # secant extrapolation along the path: β(λ) is
                    # piecewise linear, so the shifted start usually lands
                    # within rounding of the next solution; the shift's
                    # residual update uses only the cached working-set
                    # columns (see _extrapolate_path_start)
                    st = _extrapolate_path_start(st, cache, beta_prev,
                                                 lam_k, lam_km1, lam)
                return _solve_at_lambda_ws("ls", opts, prob, lam,
                                           st._replace(key=k1), n_scale,
                                           cache)
            # warm_start=False: the reference zeroes β and re-runs the full
            # λ-continuation at every path point (lasso.jl:250-252 with
            # warmStart=false, coordinate_descent.jl:24-37)
            return solve_blocked("ls", opts, prob, lam,
                                 jnp.zeros_like(st.beta), k1), cache

        st, cache = lax.cond(stopped, lambda a: a, do, (st, cache))
        valid = ~stopped
        nnz = jnp.sum(st.beta != 0)
        # the point that first exceeds max_hat_s is still recorded
        # (lasso.jl:253-256)
        stopped = stopped | (nnz > max_hat_s)
        return (st, cache, beta_k, lam, lam_k, stopped), (st.beta, valid)

    carry_out, (betas, valids) = lax.scan(
        scan_body,
        (st0, cache0, beta_prev0, lam_k0, lam_km10, stopped0),
        lam_path)
    return betas.reshape(betas.shape[0], -1)[:, :p], valids, carry_out


@functools.partial(jax.jit, static_argnames=("opts", "stride", "batch"))
def _lasso_path_batched_core(X, y, lam_path, lamw, key, max_hat_s,
                             opts: CDOptions, stride: int, batch: int):
    """Batched λ-path: coarse sequential scan + chunked batched refinement.

    The scan path is inherently serial — every point pays its own
    confirming KKT sweep (one O(n·p) X read).  Here only every
    ``stride``-th point runs sequentially; the remaining points are
    refined in ``lax.map`` chunks of ``batch`` lanes from warm starts
    interpolated between the bracketing coarse solutions.  One certify
    GEMM ``R @ X`` then sweeps ALL lanes of a chunk per X read, and the
    violating coordinates are polished by **block-coordinate descent on a
    gathered union working set** — cyclic over ``block_size``-wide blocks
    of the union Gram with per-block Gershgorin majorizers (the same
    proven scheme as ``block_cd._visit_block``; a single whole-union
    majorizer is ~C/√n too loose and never certifies).  The restricted
    solve is sound for the same reason as ``block_cd._compact_pass``:
    coordinates outside the set stay fixed and the next certify catches
    any violation they develop.  Every point's final certify is the
    engine's order-independent full KKT sweep with the f32 noise floor.

    Returns ``(betas, valids, all_cert, n_escaped)``.  ``all_cert`` is
    False when any refined lane exhausted its round budget without passing
    the certify sweep (e.g. a chunk's union support saturating
    ``compact_size``) — the caller MUST then discard the batched result
    and fall back to the scan path, which handles those regimes; certified
    outputs match the scan to solver tolerance.  ``n_escaped`` counts the
    lanes accepted via the near-tol stall escape rather than the strict
    ``mx < tol`` rule (always 0 at f64 — see
    ``ops.batched_certify.stall_escape_update``).  Lanes past the coarse
    scan's ``max_hat_s`` stop are frozen (their anchors are stale by
    construction); they are truncated by the final prefix rule exactly
    like the scan's post-stop points."""
    from ..ops.block_cd import _PREC

    n, p = X.shape
    dt = X.dtype
    g = lam_path.shape[0]
    tol = opts.opt_tol
    n_scale = jnp.asarray(n, dt)
    sub_f64 = jnp.dtype(dt).itemsize < 8

    cidx = np.arange(0, g, stride)
    if cidx[-1] != g - 1:
        cidx = np.append(cidx, g - 1)
    rest = np.setdiff1d(np.arange(g), cidx)
    betas_c, valids_c, _ = _lasso_path_core(
        X, y, lam_path[jnp.asarray(cidx)], lamw, key, max_hat_s, opts)

    adiag = jnp.maximum(jnp.einsum("nj,nj->j", X, X, precision=_PREC),
                        jnp.asarray(1e-30, dt))
    xnorm = jnp.sqrt(adiag)
    # union working set size, padded up to a block multiple; padded gather
    # slots use index p (out of range) → zero columns via mode="fill"
    Bb = int(opts.block_size)
    C = int(min(opts.compact_size, p))
    Cp = -(-C // Bb) * Bb

    def certify(B, R, thrw):
        return kkt_violation_lanes(B, R, thrw, X, adiag, xnorm)

    def refine(args):
        lam_k, B0, frozen = args                           # (k,), (k,p), (k,)
        thrw = lamw[None, :] * (lam_k * n_scale)[:, None]
        R = y[None, :] - jnp.dot(B0, X.T, precision=_PREC)

        H0 = certify(B0, R, thrw)
        mx0 = jnp.max(H0, axis=1)
        cert0 = (mx0 < tol) | frozen
        # f32 lanes can limit-cycle a hair above tol; the scan escapes
        # via its per-point stall detector, so the batched certify gets
        # the same per-lane escape (f64 keeps the strict rule)
        patience = (opts.stall_patience if sub_f64
                    else np.iinfo(np.int32).max)
        stall0 = jnp.zeros(mx0.shape, jnp.int32)
        esc0 = jnp.zeros(mx0.shape, bool)

        def cond(s):
            B, R, H, cert, best, stall, esc, rounds = s
            return jnp.logical_and(~jnp.all(cert),
                                   rounds < 2 * opts.compact_rounds)

        def body(s):
            B, R, H, cert, best, stall, esc, rounds = s
            hi = 2.0 * jnp.max(jnp.where(cert[:, None], 0.0, H)) + 1.0
            pri = union_priority(B, H, cert, hi)
            _, idx = lax.top_k(pri, C)
            idx = jnp.sort(idx)
            if Cp != C:                       # pad → zero columns below
                idx = jnp.concatenate(
                    [idx, jnp.full((Cp - C,), p, idx.dtype)])
            Xs = jnp.take(X, idx, axis=1, mode="fill",
                          fill_value=0)                         # (n, Cp)
            Ks = jnp.dot(Xs.T, Xs, precision=_PREC)             # (Cp, Cp)
            Bs0 = jnp.take(B, idx, axis=1, mode="fill", fill_value=0)
            # padded slots: infinite threshold pins them at zero
            thr_full = jnp.take(thrw, idx, axis=1, mode="fill",
                                fill_value=jnp.finfo(dt).max / 8)
            cs0 = jnp.dot(R, Xs, precision=_PREC)          # (k, Cp) = Xs'R
            bs = union_block_fista(Ks, thr_full, Bs0, cs0, cert, opts)
            R = R - jnp.dot(bs - Bs0, Xs.T, precision=_PREC)
            B = B.at[:, idx].set(bs, mode="drop")
            H = certify(B, R, thrw)
            mx = jnp.max(H, axis=1)
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
                  + a[:, None] * betas_c[seg + 1])
        # lanes past the coarse scan's max_hat_s stop have stale anchors:
        # freeze them (no refinement work, no crowding of the chunk's
        # shared working set); the final prefix rule truncates them
        # exactly like the scan's post-stop points
        frozen = ~(valids_c[jnp.asarray(seg)]
                   & valids_c[jnp.asarray(seg + 1)])
        # same-shape chunks under lax.map (compiles refine ONCE for any
        # chunk count; a vmap over lanes would instead materialize one
        # (n, C) gather per lane — the refine body shares ONE union
        # working set across its whole chunk)
        k = min(batch, int(rest.size))
        nchunks = -(-int(rest.size) // k)
        pad = nchunks * k - int(rest.size)
        if pad:
            lam_r = jnp.concatenate([lam_r, jnp.repeat(lam_r[-1:], pad)])
            starts = jnp.concatenate(
                [starts, jnp.repeat(starts[-1:], pad, axis=0)])
            frozen = jnp.concatenate(
                [frozen, jnp.ones((pad,), bool)])
        if nchunks == 1:
            refined_all, certs, escs = refine((lam_r, starts, frozen))
        else:
            refined_all, certs, escs = lax.map(
                refine, (lam_r.reshape(nchunks, k),
                         starts.reshape(nchunks, k, p),
                         frozen.reshape(nchunks, k)))
            refined_all = refined_all.reshape(nchunks * k, p)
            certs = certs.reshape(nchunks * k)
            escs = escs.reshape(nchunks * k)
        refined = refined_all[:rest.size]
        all_cert = jnp.all(certs[:rest.size] | frozen[:rest.size])
        n_escaped = jnp.sum(escs[:rest.size].astype(jnp.int32))
        betas = (jnp.zeros((g, p), dt)
                 .at[jnp.asarray(cidx)].set(betas_c)
                 .at[jnp.asarray(rest)].set(refined))
    else:
        betas = betas_c
        all_cert = jnp.ones((), bool)
        n_escaped = jnp.zeros((), jnp.int32)

    # reference early-stop semantics: the first point whose support
    # exceeds max_hat_s is still recorded, later points are dropped
    exceed = jnp.sum(betas != 0, axis=1) > max_hat_s
    stopped_before = jnp.concatenate(
        [jnp.zeros((1,), bool), jnp.cumsum(exceed)[:-1] > 0])
    return betas, ~stopped_before, all_cert, n_escaped


def _lasso_path_scan_chunked(X, y, lam_path, lamw, key, max_hat_s,
                             opts: CDOptions, chunk: int):
    """Run the path scan as host-driven segments of ``chunk`` λ points.

    The carry (full solver state + working-set cache + secant abscissae +
    stop flag) round-trips through the jitted segment program unchanged,
    so the trajectory is IDENTICAL to the single-scan execution — the
    split only bounds how long any one device program runs.  Two wins on
    long/expensive grids: (a) no single program runs longer than one
    segment, so a host that needs control back between programs (progress
    reporting, checkpoints, a device watchdog) gets it; (b) the
    ``max_hat_s`` early stop actually skips the remaining segments on the
    host instead of running them as in-trace no-ops.

    Mechanics (pad/early-exit/truncation) are single-sourced in
    ``ops.batched_certify.run_chunked_segments``."""

    def run_segment(s, seg, carry):
        return _lasso_path_core(X, y, seg, lamw, key, max_hat_s, opts,
                                carry_in=carry, resume=s > 0)

    return run_chunked_segments(lam_path, chunk, run_segment)


def lasso_path(X, y, lam_path, options: CDOptions = CDOptions(), *,
               max_hat_s: float = np.inf, standardize_X: bool = True,
               path_batch: int | None = None,
               coarse_stride: int | None = None,
               scan_chunk: int | None = None,
               seed: int = 0, stats: dict | None = None) -> LassoPath:
    """Solve the Lasso along a **decreasing** λ grid with warm starts.

    Reference ``LassoPath`` (lasso.jl:229-260).  With ``standardize_X`` the
    per-coordinate penalty weights are the column RMS loadings
    (lasso.jl:237-242).  The path is truncated after the first point whose
    support size exceeds ``max_hat_s`` (that point is kept, matching the
    reference's ``resize!`` semantics).

    ``path_batch > 0`` switches to the batched execution
    (_lasso_path_batched_core): only every ``coarse_stride``-th point runs
    sequentially; the rest are refined in vmapped chunks of ``path_batch``
    lanes, amortizing each certifying X sweep across the whole chunk —
    same certified solutions, a fraction of the serial chain.  Grids no
    longer than ``max(2, coarse_stride)`` fall back to the scan.
    Coarser anchors win as long as certification holds, so the default
    anchors are the endpoints only.

    Defaults are auto-resolved: ``path_batch=None`` enables the batched
    execution (128 lanes) for sub-f64 dtypes on an accelerator — the
    production case — on grids of ≥ 16 points, and the
    sequential scan otherwise (f64 runs keep exact-CD scan trajectories;
    on CPU the batched trade — more FLOPs for a shorter serial chain —
    loses).  ``coarse_stride=None`` resolves to ``len(lam_path) − 1``.
    Pass ``path_batch=0`` to force the scan.  A batched run that fails
    its certify sweep falls back to the scan automatically (warning), so
    the auto mode never changes semantics — every returned point is
    certified by the same order-independent full-KKT rule either way.

    ``scan_chunk > 0`` executes the sequential scan (including the
    automatic fallback from an uncertified batched run) as host-driven
    segments of that many λ points, warm-start carry round-tripped
    between segments — the trajectory is identical to the monolithic
    scan (bitwise at f64; tested).  Use it to bound how long one device
    program runs on grids whose single-program execution would be very
    long (a dense-support low-λ 100-point scan is one such program); it
    also turns the ``max_hat_s`` stop into a true host-side early exit.

    ``stats``, if a dict, is populated with run accounting:
    ``used_batched`` (bool — the batched core EXECUTED, whether or not
    it certified; with ``batched_certified`` False this flags a run that
    paid the batched attempt and then fell back),
    ``batched_certified`` (bool — False both on
    fallback and when the batched mode never ran), and
    ``stall_escaped_lanes`` (int — lanes of the RETURNED batched result
    accepted via the near-tol stall escape instead of the strict rule;
    0 whenever the scan result is returned, and always 0 at f64).
    """
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
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
    lamw = std_X(X) if standardize_X else jnp.ones((X.shape[1],), X.dtype)
    key = jax.random.PRNGKey(seed)
    batched_ok = False
    used_batched = False
    n_escaped = 0
    if path_batch and lam_path.shape[0] > max(2, coarse_stride):
        used_batched = True
        betas, valids, all_cert, n_esc = _lasso_path_batched_core(
            X, y, lam_path, lamw, key, jnp.asarray(max_hat_s, X.dtype),
            options, int(coarse_stride), int(path_batch))
        batched_ok = bool(all_cert)
        n_escaped = int(n_esc) if batched_ok else 0
        if not batched_ok:
            # a refined lane exhausted its round budget without passing
            # the certify sweep (typically a chunk's union support
            # saturating compact_size): discard and fall back to the
            # scan, which handles that regime — correctness over speed
            warnings.warn(
                "lasso_path(path_batch=...): batched refinement did not "
                "certify every point; falling back to the sequential "
                "scan (consider a larger options.compact_size or a "
                "smaller path_batch)", RuntimeWarning)
    if not batched_ok:
        if scan_chunk and L > scan_chunk:
            betas, valids = _lasso_path_scan_chunked(
                X, y, lam_path, lamw, key,
                jnp.asarray(max_hat_s, X.dtype), options, int(scan_chunk))
        else:
            betas, valids, _ = _lasso_path_core(
                X, y, lam_path, lamw, key,
                jnp.asarray(max_hat_s, X.dtype), options)
    if stats is not None:
        stats["used_batched"] = used_batched
        stats["batched_certified"] = batched_ok
        stats["stall_escaped_lanes"] = n_escaped
    valids = np.asarray(valids)
    k = int(valids.sum())
    return LassoPath(lam_path[:k], betas[:k])


def refit_lasso_path(path: LassoPath, X, y) -> Dict[Tuple[int, ...],
                                                     np.ndarray]:
    """Least-squares refit on each *distinct* support along the path.

    Reference ``refitLassoPath`` (lasso.jl:208-225): returns a dict mapping
    the support (tuple of 0-based indices) to the OLS coefficients
    ``X[:, S] \\ y``.
    """
    Xn = np.asarray(X)
    yn = np.asarray(y)
    out: Dict[Tuple[int, ...], np.ndarray] = {}
    beta_np = np.asarray(path.beta_path)
    for i in range(beta_np.shape[0]):
        S = tuple(np.nonzero(beta_np[i])[0].tolist())
        if S in out:
            continue
        if len(S) == 0:
            out[S] = np.zeros((0,), dtype=Xn.dtype)
        else:
            out[S] = np.linalg.lstsq(Xn[:, list(S)], yn, rcond=None)[0]
    return out
