"""Observability: timing, convergence traces, roofline reporting, NaN mode.

The reference has no tracing, logging, or sanitizers (SURVEY.md §5.1-5.2,
§5.5) — only ad-hoc ``@time`` in benchmark scripts and the scalar ``maxH``
convergence check.  This module provides the equivalents:

- ``simple_timeit``       — synced wall timing of a jitted fn
- ``trace``               — ``jax.profiler`` trace context for a code region
- ``solve_with_trace``    — epoch-instrumented Lasso solve returning the
  per-epoch convergence history (maxH, nnz, duality gap, objective) — the
  observability the reference lacks (coordinate_descent.jl:83-87 tracks
  only maxH, and only internally)
- ``pass_roofline``       — achieved memory bandwidth of one active pass
  vs the device's peak (the north-star roofline report)
- ``debug_nans``          — context manager enabling JAX NaN checking
  (§5.2's sanitizer equivalent)
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.block_cd import (
    _active_pass,
    _full_check,
    _init_state,
    _to_blocked_beta,
    build_blocked,
    solve_blocked,
)
from ..ops.diagnostics import lasso_duality_gap
from ..utils.options import CDOptions

# Published peak device-memory bandwidth, bytes/s, keyed by JAX's
# ``device_kind``.  Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5,
# 80 GB HBM3: 3.35 TB/s).  ``measured_peak_hbm`` gives the achievable
# denominator on the device at hand.
_PEAK_HBM = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_hbm(device_kind: str) -> float:
    """Published peak memory bandwidth (bytes/s) of ``device_kind``; a
    device not in the table is an error, never a silent default."""
    try:
        return _PEAK_HBM[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peak bandwidth for device kind {device_kind!r}; "
            f"known: {sorted(_PEAK_HBM)}") from None


def measured_peak_hbm(nbytes: int = 2 << 30, dtype=jnp.float32,
                      chain: int = 8) -> float:
    """Achieved bytes/s of a pure streaming reduction — the realistic
    roofline denominator on this device.

    Measured with the SAME chained-slope method ``pass_roofline`` uses for
    the kernel numerator (slope between 1 and 1+k chained reads inside one
    jit): an absolute single-call time includes dispatch overhead that the
    slope subtracts, so mixing the two methods would let the reported
    fraction exceed 1.  Each chained term multiplies
    by a different scalar so XLA cannot CSE the reads away.
    """
    m = nbytes // np.dtype(dtype).itemsize
    x = jax.random.normal(jax.random.PRNGKey(0), (m,), dtype)
    s = jnp.asarray(1.5, dtype)

    # each term depends on the previous accumulator through a NONLINEAR
    # elementwise op, so XLA can neither CSE the terms nor factor the
    # reduction (``sum(x*(s+i)) == (s+i)*sum(x)`` gets hoisted to a single
    # read — observed: a 32 TB/s "peak")
    def chained(k):
        @jax.jit
        def fn(x, s):
            acc = s
            for _ in range(k):
                acc = jnp.sum(jnp.abs(x - acc * jnp.asarray(1e-9, dtype)))
            return acc
        return fn

    t1 = simple_timeit(chained(1), x, s)
    tk = simple_timeit(chained(1 + chain), x, s)
    sec = max((tk - t1) / chain, 1e-9)
    return m * np.dtype(dtype).itemsize / sec


def simple_timeit(f, *args, tries: int = 5, warmup: int = 2) -> float:
    """Median wall seconds of ``f(*args)``, each call synced with
    ``jax.block_until_ready`` on every output leaf."""
    for _ in range(warmup):
        jax.block_until_ready(f(*args))
    times = []
    for _ in range(tries):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@contextlib.contextmanager
def trace(dirname: str):
    """``jax.profiler`` trace around a code region (view with TensorBoard
    or xprof)."""
    with jax.profiler.trace(dirname):
        yield


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Enable JAX NaN debugging for a region (SURVEY.md §5.2)."""
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


class EpochTrace(NamedTuple):
    """Per-epoch convergence history of an instrumented solve.

    ``certificate`` is the loss-appropriate optimality certificate:
    the Fenchel duality gap for ls/wls (wls via the √w row scaling that
    maps it to an LS problem), and the KKT residual
    ``max(|X_j'r|/‖r‖ − λ_j, 0)`` for the sqrt-lasso (whose scale-free
    stationarity conditions have no finite gap at r → 0).
    ``duality_gap`` aliases it for backward compatibility."""

    max_h: np.ndarray        # max coordinate displacement per epoch
    nnz: np.ndarray          # support size per epoch
    certificate: np.ndarray  # optimality certificate per epoch (see above)
    seconds: np.ndarray      # cumulative wall seconds

    @property
    def duality_gap(self):
        return self.certificate


def solve_with_trace(X, y, lam, weights=None,
                     options: CDOptions = CDOptions(), *,
                     loss: str = "ls", w=None,
                     max_epochs: int = 200, seed: int = 0):
    """Penalized solve instrumented per epoch (ls / wls / sqrt losses).

    Runs the same full-check / active-pass alternation as the engine
    (coordinate_descent.jl:65-92 semantics) but one epoch per jit call so
    the host can record (maxH, nnz, certificate, time) after each — the
    metrics/observability subsystem the reference lacks (SURVEY.md §5.5).
    ``loss`` selects the loss kind (reference's loss-generic driver,
    coordinate_descent.jl:8): ``"ls"``, ``"wls"`` (pass row weights
    ``w``), or ``"sqrt"``.  Returns ``(beta, EpochTrace)``.
    """
    if loss not in ("ls", "wls", "sqrt"):
        raise ValueError("loss must be 'ls' | 'wls' | 'sqrt'")
    if loss == "wls" and w is None:
        raise ValueError("loss='wls' needs row weights w")
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    p = X.shape[1]
    lamw = (jnp.ones((p,), X.dtype) if weights is None
            else jnp.asarray(weights, X.dtype))
    lam = jnp.asarray(lam, X.dtype)
    # sqrt-lasso's stationarity is scale-free in r (gradient −X'r/‖r‖,
    # cd_differentiable_function.jl:234-235): n_scale is 1
    n_scale = jnp.asarray(1.0 if loss == "sqrt" else X.shape[0], X.dtype)
    wv = None if w is None else jnp.asarray(w, X.dtype)

    @jax.jit
    def prep():
        prob = build_blocked(loss, options, lamw, X=X, y=y, w=wv)
        st = _init_state(loss, prob,
                         _to_blocked_beta(jnp.zeros((p,), X.dtype),
                                          options.block_size),
                         jax.random.PRNGKey(seed))
        return prob, st

    @jax.jit
    def full_epoch(prob, st):
        st, maxh = _full_check(loss, prob, st, lam, n_scale,
                               options.opt_tol)
        return st, maxh

    @jax.jit
    def active_epoch(prob, st):
        st, maxh = _active_pass(loss, prob, st, lam, n_scale,
                                options.randomize, options)
        return st, maxh

    @jax.jit
    def certificate(beta):
        if loss == "sqrt":
            r = y - jnp.dot(X, beta, precision=jax.lax.Precision.HIGHEST)
            rn = jnp.sqrt(jnp.dot(r, r,
                                  precision=jax.lax.Precision.HIGHEST))
            c = jnp.abs(jnp.dot(r, X,
                                precision=jax.lax.Precision.HIGHEST))
            return jnp.max(jnp.maximum(
                c / jnp.maximum(rn, 1e-30) - lam * lamw, 0.0))
        if loss == "wls":
            sw = jnp.sqrt(wv)
            return lasso_duality_gap(X * sw[:, None], y * sw, beta, lam,
                                     lamw)
        return lasso_duality_gap(X, y, beta, lam, lamw)

    prob, st = prep()
    hs, nnzs, gaps, secs = [], [], [], []
    t0 = time.perf_counter()
    was_full = True
    converged_prev = False
    best, stall = float("inf"), 0
    f64 = jnp.dtype(X.dtype).itemsize >= 8
    for _ in range(max_epochs):
        st, maxh = (full_epoch if was_full else active_epoch)(prob, st)
        jax.block_until_ready(maxh)
        beta = st.beta.reshape(-1)[:p]
        hs.append(float(maxh))
        nnzs.append(int(jnp.sum(beta != 0)))
        gaps.append(float(certificate(beta)))
        secs.append(time.perf_counter() - t0)
        # maxh from _full_check is already noise-floor-masked per
        # coordinate (block_cd.noise_floor_mask), matching the engine
        conv = float(maxh) < options.opt_tol
        if was_full and conv and converged_prev:
            break
        # mirror the engine's f32 stall detector exactly
        # (block_cd._solve_at_lambda_ws): full-check epochs only, reset on
        # ANY improvement of the certified maxh
        if was_full:
            stall = 0 if float(maxh) < best else stall + 1
            best = min(best, float(maxh))
        if not f64 and stall >= options.stall_patience:
            break
        converged_prev = conv
        was_full = conv
    return st.beta.reshape(-1)[:p], EpochTrace(
        np.asarray(hs), np.asarray(nnzs), np.asarray(gaps),
        np.asarray(secs))


class SigmaRoundTrace(NamedTuple):
    """Per-σ-round history of an instrumented scaled-lasso solve —
    observability over the outer consensus loop (lasso.jl:131-141), where
    the interesting convergence behavior of the joint (β, σ) estimate
    lives."""

    sigma: np.ndarray        # σ estimate entering each round
    lam_eff: np.ndarray      # effective penalty λ·σ used by the round
    nnz: np.ndarray          # support size after the round's solve
    rel_change: np.ndarray   # |σ_new − σ| / σ per round (the stop metric)
    seconds: np.ndarray      # cumulative wall seconds


def scaled_lasso_with_trace(X, y, lam, weights=None,
                            options=None, *, seed: int = 0):
    """Scaled-lasso solve instrumented per σ round (reference
    ``scaledLasso!``, lasso.jl:107-144): one jit call per round so the
    host records (σ, λ·σ, nnz, relative σ change, time) after each.
    Returns ``(LassoSolution, SigmaRoundTrace)`` matching
    :func:`~coordinatedescent_jl_tpu.scaled_lasso` semantics
    (init_procedure honored; stop when the relative σ change < opt_tol)."""
    from ..models.lasso import LassoSolution
    from ..ops.block_cd import (_compact_mode, _empty_ws_cache,
                                _solve_at_lambda_ws, _unblock,
                                solve_blocked)
    from ..ops.prox import ProxL1
    from ..utils.helpers import find_init_sigma, sample_std
    from ..utils.options import IterLassoOptions

    if options is None:
        options = IterLassoOptions()
    cdo = options.options_cd
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    n, p = X.shape
    lamw = (jnp.ones((p,), X.dtype) if weights is None
            else jnp.asarray(weights, X.dtype))
    lam = jnp.asarray(lam, X.dtype)
    n_scale = jnp.asarray(n, X.dtype)

    @jax.jit
    def prep():
        prob = build_blocked("ls", cdo, lamw, X=X, y=y)
        st = _init_state("ls", prob,
                         _to_blocked_beta(jnp.zeros((p,), X.dtype),
                                          cdo.block_size),
                         jax.random.PRNGKey(seed))
        if options.init_procedure == "screening":
            sig = find_init_sigma(X, y, options.s_init)
        elif options.init_procedure == "init_std":
            sig = jnp.asarray(options.sigma_init, X.dtype)
        elif options.init_procedure == "warm_start":
            sig = sample_std(st.r)
        else:
            raise ValueError("bad init_procedure")
        return prob, st, sig

    @jax.jit
    def round_step(prob, st, cache, sig):
        lam_new = lam * sig
        key, k1 = jax.random.split(st.key)
        if cdo.warm_start:
            st, cache = _solve_at_lambda_ws("ls", cdo, prob, lam_new,
                                            st._replace(key=k1), n_scale,
                                            cache)
        else:
            st = solve_blocked("ls", cdo, prob, lam_new,
                               jnp.zeros_like(st.beta), k1)
        signew = jnp.sqrt(jnp.sum(st.r * st.r) / n)
        nnz = jnp.sum(st.beta != 0)
        return st, cache, signew, nnz

    prob, st, sig = prep()
    nc = _compact_mode("ls", cdo, prob, X.dtype)
    cache = _empty_ws_cache("ls", prob, nc, cdo) if nc else None
    sigs, lams_eff, nnzs, rels, secs = [], [], [], [], []
    t0 = time.perf_counter()
    sig_f = float(sig)
    sig_used = sig_f
    for _ in range(options.max_iter):
        st, cache, signew, nnz = round_step(prob, st, cache,
                                            jnp.asarray(sig_f, X.dtype))
        rel = abs(float(signew) - sig_f) / sig_f
        sigs.append(sig_f)
        lams_eff.append(float(lam) * sig_f)
        nnzs.append(int(nnz))
        rels.append(rel)
        secs.append(time.perf_counter() - t0)
        sig_used = sig_f
        if rel < options.opt_tol:
            break
        sig_f = float(signew)
    beta = _unblock(st.beta, p)
    g = ProxL1(lam * jnp.asarray(sig_used, X.dtype), lamw)
    sol = LassoSolution(beta, st.r, g, sample_std(st.r))
    return sol, SigmaRoundTrace(
        np.asarray(sigs), np.asarray(lams_eff), np.asarray(nnzs),
        np.asarray(rels), np.asarray(secs))


def group_solve_with_trace(X, y, lam, group_size: int, weights=None,
                           options: CDOptions = CDOptions(), *,
                           max_epochs: int = 200, seed: int = 0):
    """Group-lasso solve instrumented per epoch (the group engine's
    full-sweep / active-pass alternation, ops/group_cd.py).  The
    certificate is the max group-KKT violation
    ``max_g max(‖X_g'r‖₂/(n·ω_g) − λ, 0)``.
    Returns ``(beta, EpochTrace)``."""
    from ..ops.group_cd import (_build_group_problem, _group_active_pass,
                                _group_full_check, GroupState)

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    n, p = X.shape
    G = int(group_size)
    ng = -(-p // G)
    lamw_g = (jnp.ones((ng,), X.dtype) if weights is None
              else jnp.asarray(weights, X.dtype))
    lam = jnp.asarray(lam, X.dtype)
    n_scale = jnp.asarray(n, X.dtype)

    @jax.jit
    def prep():
        prob = _build_group_problem(X, y, lamw_g, G)
        nb, B = prob.valid.shape
        beta_g = jnp.zeros((nb, B), X.dtype)
        st = GroupState(beta=beta_g, r=y,
                        active=jnp.zeros((nb,), bool),
                        key=jax.random.PRNGKey(seed),
                        it=jnp.zeros((), jnp.int32),
                        conv=jnp.ones((), bool),
                        done=jnp.zeros((), bool))
        return prob, st

    @jax.jit
    def full_epoch(prob, st):
        return _group_full_check(prob, st, lam, n_scale, options.opt_tol)

    @jax.jit
    def active_epoch(prob, st):
        return _group_active_pass(prob, st, lam, n_scale,
                                  options.randomize, options.block_iters)

    @jax.jit
    def certificate(prob, st):
        nb, B = prob.valid.shape
        k = prob.lamw.shape[1]
        c = jnp.einsum("bnk,n->bk", prob.Xwb, st.r,
                       precision=jax.lax.Precision.HIGHEST)
        cg = jnp.where(prob.valid, c, 0.0).reshape(nb, k, G)
        nrm = jnp.sqrt(jnp.sum(cg * cg, axis=2))
        return jnp.max(jnp.maximum(
            nrm / (n_scale * jnp.maximum(prob.lamw, 1e-30)) - lam, 0.0))

    prob, st = prep()
    hs, nnzs, gaps, secs = [], [], [], []
    t0 = time.perf_counter()
    was_full = True
    converged_prev = False
    best, stall = float("inf"), 0
    f64 = jnp.dtype(X.dtype).itemsize >= 8
    for _ in range(max_epochs):
        st, maxh = (full_epoch if was_full else active_epoch)(prob, st)
        jax.block_until_ready(maxh)
        hs.append(float(maxh))
        nnzs.append(int(jnp.sum(st.beta != 0)))
        gaps.append(float(certificate(prob, st)))
        secs.append(time.perf_counter() - t0)
        conv = float(maxh) < options.opt_tol
        if was_full and conv and converged_prev:
            break
        if was_full:
            stall = 0 if float(maxh) < best else stall + 1
            best = min(best, float(maxh))
        if not f64 and stall >= options.stall_patience:
            break
        converged_prev = conv
        was_full = conv
    return st.beta.reshape(-1)[:p], EpochTrace(
        np.asarray(hs), np.asarray(nnzs), np.asarray(gaps),
        np.asarray(secs))


def lasso_sharded_with_trace(X, y, lam, mesh, weights=None,
                             options=None, *, axis: str = "feature",
                             seed: int = 0, max_epochs: int = 200):
    """Per-epoch trace of a *feature-sharded* Lasso solve — §5.5
    observability extended to the multi-chip tier.  Runs the sharded
    engine's full-check / concurrent-active-pass alternation
    (parallel/sharded_cd.py) one epoch per jit call so the host records
    (pmax'd maxH, global nnz, duality gap, seconds) after each; the
    certificate is the single-device diagnostic evaluated on the gathered
    global iterate, so a converged sharded trace certifies exactly what a
    single-device solve would.  Returns ``(beta, EpochTrace)``."""
    from jax.sharding import PartitionSpec as P

    from ..ops.block_cd import CDState, _compact_nc, _empty_ws_cache
    from ..parallel.sharded_cd import (
        _pad_cols_to,
        _pad_vec_to,
        _shard_chunk,
        _sharded_active_pass,
        _sharded_full_check,
        _sharded_init_state,
    )

    if options is None:
        options = CDOptions()
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    n, p = X.shape
    D = mesh.shape[axis]
    chunk, P_tot = _shard_chunk(p, D, options.block_size)
    lamw = (jnp.ones((p,), X.dtype) if weights is None
            else jnp.asarray(weights, X.dtype))
    Xp = _pad_cols_to(X, P_tot)
    lamwp = _pad_vec_to(lamw, P_tot, 1.0)
    lam = jnp.asarray(lam, X.dtype)
    n_scale = jnp.asarray(n, X.dtype)
    # compaction engages exactly as in the engine being traced (the
    # per-shard working-set cache is threaded across the host-stepped
    # epochs like the sharded checkpoint does, ok carried as shape (1,))
    nc = _compact_nc("ls", options, chunk // options.block_size,
                     options.block_size, X.dtype)

    state_spec = CDState(beta=P(axis), r=P(), rsqr=P(), active=P(axis),
                         key=P(), it=P(), conv=P(), done=P(),
                         c=P(axis), drift=P(axis))
    cache_spec = P(axis) if nc else None
    data_spec = (P(None, axis), P(), P(axis))

    def _wrap_cache(cache):
        return cache._replace(ok=cache.ok[None]) if nc else None

    def _unwrap_cache(g):
        return g._replace(ok=g.ok[0]) if nc else None

    def _init_local(Xl, yv, lamwl, key):
        prob = build_blocked("ls", options, lamwl, X=Xl, y=yv)
        beta0 = _to_blocked_beta(jnp.zeros((Xl.shape[1],), Xl.dtype),
                                 options.block_size)
        cache = (_empty_ws_cache("ls", prob, nc, options) if nc else None)
        return (_sharded_init_state("ls", prob, beta0, key, axis),
                _wrap_cache(cache))

    def _full_local(Xl, yv, lamwl, st):
        prob = build_blocked("ls", options, lamwl, X=Xl, y=yv)
        return _sharded_full_check("ls", prob, st, lam, n_scale,
                                   options.opt_tol, axis)

    def _active_local(Xl, yv, lamwl, st, g_cache):
        prob = build_blocked("ls", options, lamwl, X=Xl, y=yv)
        st, maxh, cache = _sharded_active_pass(
            "ls", prob, st, lam, n_scale, options.randomize, axis, D,
            None, options, nc, _unwrap_cache(g_cache))
        return st, maxh, _wrap_cache(cache)

    init_all = jax.jit(jax.shard_map(
        _init_local, mesh=mesh, in_specs=data_spec + (P(),),
        out_specs=(state_spec, cache_spec), check_vma=False))
    full_all = jax.jit(jax.shard_map(
        _full_local, mesh=mesh, in_specs=data_spec + (state_spec,),
        out_specs=(state_spec, P()), check_vma=False))
    active_all = jax.jit(jax.shard_map(
        _active_local, mesh=mesh,
        in_specs=data_spec + (state_spec, cache_spec),
        out_specs=(state_spec, P(), cache_spec), check_vma=False))

    st, cache_g = init_all(Xp, y, lamwp, jax.random.PRNGKey(seed))
    hs, nnzs, gaps, secs = [], [], [], []
    t0 = time.perf_counter()
    was_full = True
    converged_prev = False
    best, stall = float("inf"), 0
    f64 = jnp.dtype(X.dtype).itemsize >= 8
    for _ in range(max_epochs):
        if was_full:
            st, maxh = full_all(Xp, y, lamwp, st)
        else:
            st, maxh, cache_g = active_all(Xp, y, lamwp, st, cache_g)
        jax.block_until_ready(maxh)
        beta = st.beta.reshape(-1)[:p]
        hs.append(float(maxh))
        nnzs.append(int(jnp.sum(beta != 0)))
        gaps.append(float(lasso_duality_gap(X, y, beta, lam, lamw)))
        secs.append(time.perf_counter() - t0)
        conv = float(maxh) < options.opt_tol
        if was_full and conv and converged_prev:
            break
        if was_full:
            stall = 0 if float(maxh) < best else stall + 1
            best = min(best, float(maxh))
        if not f64 and stall >= options.stall_patience:
            break
        converged_prev = conv
        was_full = conv
    return st.beta.reshape(-1)[:p], EpochTrace(
        np.asarray(hs), np.asarray(nnzs), np.asarray(gaps),
        np.asarray(secs))


class RooflineReport(NamedTuple):
    seconds_per_pass: float
    bytes_per_pass: int
    achieved_gbps: float
    peak_gbps: float            # published peak (``_PEAK_HBM``)
    measured_peak_gbps: float   # pure-streaming measurement on this device
    fraction_of_roofline: float          # vs published peak
    fraction_of_measured_peak: float     # vs what the device can do
    device_kind: str


def pass_roofline(n: int, p: int, *, block_size: int = 128,
                  dtype=jnp.float32, active_fraction: float = 1.0,
                  inner: str = "ista", iters: int = 16,
                  seed: int = 0) -> RooflineReport:
    """Single-configuration wrapper around :func:`pass_roofline_multi`
    (see there for semantics)."""
    return pass_roofline_multi(n, p, block_size=block_size, dtype=dtype,
                               active_fraction=active_fraction,
                               inner=inner, iters_list=(iters,),
                               seed=seed)[0]


def pass_roofline_multi(n: int, p: int, *, block_size: int = 128,
                        dtype=jnp.float32, active_fraction: float = 1.0,
                        inner: str = "ista", iters_list=(16,),
                        seed: int = 0) -> list:
    """Measure the active pass's (``block_cd._active_pass``) achieved
    memory bandwidth on a synthetic problem and report it against the
    device's peak (the north-star roofline metric).

    Bandwidth accounting: one read of each active ``(n, B)`` X block per
    pass (4·n·B bytes f32) — the algorithm's minimum traffic; the pass
    touches each visited block twice (block gradient, then the residual
    update), and the second touch hits memory or cache as the device
    decides.  ``iters`` is the per-block inner-solve iteration count of
    ``inner="ista"``: at the production 16 the pass does 16 ``B×B``
    matvecs per block read and the achieved-bandwidth metric understates
    the streaming part; ``iters=1`` is the streaming-bound configuration.
    """
    peak = peak_hbm(jax.devices()[0].device_kind)
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    # denominator FIRST: its 2 GiB streaming buffer need not coexist with
    # the design and its blocked layout
    mpeak = measured_peak_hbm()
    X = jax.random.normal(k1, (n, p), dtype)
    y = jax.random.normal(k2, (n,), dtype)
    lamw = jnp.ones((p,), dtype)
    opts0 = CDOptions(block_size=block_size, randomize=False, inner=inner)
    prob = build_blocked("ls", opts0, lamw, X=X, y=y)
    del X          # only the blocked layout is read from here on
    nb, B = prob.lamw.shape
    n_act = max(1, int(round(active_fraction * nb)))
    beta_b = jnp.zeros((nb, B), dtype).at[:n_act, 0].set(1e-6)
    st = _init_state("ls", prob, beta_b, key)
    lam0 = jnp.asarray(0.0, dtype)
    nsc = jnp.asarray(float(n), dtype)

    # Per-pass time is the SLOPE between 1 and 1+k chained passes inside
    # one jit call, which subtracts dispatch and any one-time layout
    # conversion of the blocked design that in-solver invocations never
    # see.  All ``iters_list`` configurations share ONE design build and
    # ONE peak measurement.
    def chained(k, iters):
        opts = opts0.replace(block_iters=iters)

        @jax.jit
        def fn(prob, st):
            for _ in range(k):
                st, _ = _active_pass("ls", prob, st, lam0, nsc, False, opts)
            return st.beta, st.r
        return fn

    nbytes = n_act * n * B * np.dtype(dtype).itemsize
    kind = jax.devices()[0].device_kind
    out = []
    k = 16
    for iters in iters_list:
        t1 = simple_timeit(chained(1, iters), prob, st)
        tk = simple_timeit(chained(1 + k, iters), prob, st)
        sec = max((tk - t1) / k, 1e-9)
        achieved = nbytes / sec
        out.append(RooflineReport(
            seconds_per_pass=sec,
            bytes_per_pass=int(nbytes),
            achieved_gbps=achieved / 1e9,
            peak_gbps=peak / 1e9,
            measured_peak_gbps=mpeak / 1e9,
            fraction_of_roofline=achieved / peak,
            fraction_of_measured_peak=achieved / mpeak,
            device_kind=kind,
        ))
    return out


class XTrafficReport(NamedTuple):
    """Production X-traffic accounting of one benchmark solve (the
    roofline microbench reads every block every pass by construction; the
    *benchmark solve* reads far fewer bytes by design — caching,
    screening, compaction — and this is that number)."""

    x_bytes: int        # design-derived bytes actually read by the solve
    seconds: float      # wall time of the SAME counting program (min-of-2)
    achieved_gbps: float
    dense_equiv_bytes: int   # epochs x full design (what a cache-less
                             # engine would stream)
    epochs: int
    nnz: int


def solve_x_traffic(X, y, lam, weights=None,
                    options: CDOptions = CDOptions(), *,
                    loss: str = "ls", w=None,
                    seed: int = 0) -> XTrafficReport:
    """Run one warm-startable penalized solve with in-trace X-read
    accounting (``solve_blocked(count_x=True)``) and report the achieved
    design bandwidth of the production path.

    Counting rules (logical element reads of the design or its gathered
    working-set copy; see ``_compact_pass``/``_solve_at_lambda_ws``):
    full check = the whole design when it refreshes any block (one dense
    einsum), nothing when cached-exact, drift-certified and screened
    blocks cover every block; dense active pass = active blocks once;
    compact round = C·n on a coverage-miss gather plus the inner solve's
    own traffic over the (n, C) copy, and NO large-X reads on a cache
    hit.  The counter adds a few scalar ops per epoch, so timing the
    counting program is representative.
    """
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    p = X.shape[1]
    lamw = (jnp.ones((p,), X.dtype) if weights is None
            else jnp.asarray(weights, X.dtype))
    wv = None if w is None else jnp.asarray(w, X.dtype)
    opts = options

    @jax.jit
    def run(X, y, lam):
        prob = build_blocked(loss, opts, lamw, X=X, y=y, w=wv)
        beta0 = _to_blocked_beta(jnp.zeros((p,), X.dtype), opts.block_size)
        st, xe = solve_blocked(loss, opts, prob, lam, beta0,
                               jax.random.PRNGKey(seed), count_x=True)
        return st.beta.reshape(-1)[:p], st.it, xe

    lam = jnp.asarray(lam, X.dtype)
    beta, it, xe = jax.block_until_ready(run(X, y, lam))   # compile + warm
    sec = simple_timeit(run, X, y, lam, tries=2, warmup=0)
    itemsize = np.dtype(X.dtype).itemsize
    x_bytes = int(float(xe) * itemsize)
    nb = -(-p // opts.block_size)
    dense_bytes = int(it) * nb * opts.block_size * X.shape[0] * itemsize
    return XTrafficReport(
        x_bytes=x_bytes,
        seconds=sec,
        achieved_gbps=x_bytes / max(sec, 1e-12) / 1e9,
        dense_equiv_bytes=dense_bytes,
        epochs=int(it),
        nnz=int(jnp.sum(beta != 0)),
    )
