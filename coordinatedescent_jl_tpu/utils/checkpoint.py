"""Checkpoint / resume for long regularization paths.

The reference has no persistence; its *algorithmic* warm-start state is what
must be preserved (SURVEY.md §5.4): β carried across λ-path points
(lasso.jl:250-252), residuals, σ, and the active mask.  Here the checkpoint
persists the FULL solver state — including the PRNG key and the
drift-bounded cached KKT gradient (``CDState.c``/``drift``) — so a resumed
run is **trajectory-identical** to an uninterrupted one even with
``randomize=True``, and keeps the one-X-read-per-point cached-gradient
carry of the scan path (models/lasso_path.py).  The state is a small
pytree — ``PathCheckpoint`` — serialized with ``numpy.savez`` (the
orbax-style single-array-per-key layout).

``lasso_path_resumable`` wraps the warm-started path driver with per-point
checkpointing: each solved point appends to the checkpoint, and a re-run
with the same path skips already-solved points.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.lasso_path import LassoPath
from ..ops.block_cd import (
    _compact_nc,
    _empty_ws_cache,
    _extrapolate_path_start,
    _ws_cache_from_idx,
    _init_state,
    _solve_at_lambda_ws,
    _to_blocked_beta,
    build_blocked,
    solve_blocked,
)
from ..utils.helpers import std_X
from ..utils.options import CDOptions, resolve_extrapolate


class ShardedPathCheckpoint(NamedTuple):
    """Resumable state of a *feature-sharded* λ-path solve (SURVEY.md §5.4
    across devices).  The solver state is gathered to host as global arrays
    (β, residuals, the cached KKT gradient ``c``/``drift``, the active
    mask) plus the **per-shard** compaction working sets — ``ws_idx`` holds
    each shard's shard-local column indices, so a resume is tied to the
    same mesh shape (``n_shards``); the dense gathered columns are a
    deterministic re-gather exactly as in the single-device checkpoint."""

    lam_path: np.ndarray     # full λ grid (identifies the run)
    next_index: int          # first unsolved path point
    beta_path: np.ndarray    # (num_solved, p) solved coefficients
    beta_warm: np.ndarray    # (p,) warm-start iterate for next_index
    residuals: np.ndarray    # (n,) replicated residuals at beta_warm
    key: np.ndarray          # replicated PRNG key
    c: np.ndarray            # (nb_total, B) cached KKT gradient, all shards
    drift: np.ndarray        # (nb_total,) staleness bounds
    active: np.ndarray       # (nb_total,) active-block mask
    ws_idx: np.ndarray       # (n_shards, C) shard-LOCAL working-set indices
    ws_ok: np.ndarray        # (n_shards,) per-shard gather validity
    beta_prev: np.ndarray    # (p,) previous point (secant support point)
    lam_k: float
    lam_km1: float
    n_shards: int            # mesh size the state was captured under


def _to_host(a) -> np.ndarray:
    """Host value of a (possibly multi-process-sharded) array.  In a
    single-controller run this is a plain ``np.asarray``; in a
    multi-process run a feature-sharded leaf is not fully addressable, so
    the global value is assembled via ``process_allgather`` (every
    process gets the full array — the checkpoint is then written by
    process 0 only, see ``lasso_path_resumable_sharded``)."""
    if isinstance(a, jax.Array) and not a.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(a, tiled=True))
    return np.asarray(a)


def save_sharded_checkpoint(path: str, ck: ShardedPathCheckpoint) -> None:
    """Atomic write (tmp + rename) of the sharded checkpoint."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f: np.asarray(v) for f, v in ck._asdict().items()})
    os.replace(tmp, path)


def load_sharded_checkpoint(path: str) -> Optional[ShardedPathCheckpoint]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if any(f not in z.files for f in ShardedPathCheckpoint._fields):
            return None
        return ShardedPathCheckpoint(
            lam_path=z["lam_path"],
            next_index=int(z["next_index"]),
            beta_path=z["beta_path"],
            beta_warm=z["beta_warm"],
            residuals=z["residuals"],
            key=z["key"],
            c=z["c"],
            drift=z["drift"],
            active=z["active"],
            ws_idx=z["ws_idx"],
            ws_ok=z["ws_ok"],
            beta_prev=z["beta_prev"],
            lam_k=float(z["lam_k"]),
            lam_km1=float(z["lam_km1"]),
            n_shards=int(z["n_shards"]),
        )


def _broadcast_sharded_ck(ck, lam_np, n, p, D, C, P_tot, B):
    """Process-0-wins broadcast of the sharded checkpoint (or of the
    decision that there is none).  Called only when
    ``jax.process_count() > 1``: the checkpoint file is written by
    process 0 alone, so other processes' local reads are typically
    missing/stale — resuming from divergent states would invoke the
    collective solver programs a different number of times per process
    (distributed hang).  Every array is broadcast in a canonical dtype
    (f64 / int32 / bool / uint32); the resume code re-casts to the run
    dtype.  ``ck`` should already be validity-checked by the caller
    (pass None for "no usable checkpoint")."""
    from jax.experimental import multihost_utils as mh

    if jax.process_index() != 0:
        ck = None
    meta = np.asarray(mh.broadcast_one_to_all(np.asarray(
        [0 if ck is None else 1, 0 if ck is None else ck.next_index],
        np.int64)))
    if int(meta[0]) == 0:
        return None
    k = int(meta[1])
    nb_total = P_tot // B

    def canon(val, shape, dt):
        if ck is None or np.shape(val) != shape:
            return np.zeros(shape, dt)
        return np.asarray(val, dt)

    ws_shape = (D, C)
    payload = (
        canon(None if ck is None else ck.beta_path, (k, p), np.float64),
        canon(None if ck is None else ck.beta_warm, (p,), np.float64),
        canon(None if ck is None else ck.residuals, (n,), np.float64),
        canon(None if ck is None else ck.key, (2,), np.uint32),
        canon(None if ck is None else ck.c, (nb_total, B), np.float64),
        canon(None if ck is None else ck.drift, (nb_total,), np.float64),
        canon(None if ck is None else ck.active, (nb_total,), bool),
        canon(None if ck is None else ck.ws_idx, ws_shape, np.int32),
        # a shape-mismatched working set must broadcast as not-ok, or the
        # canonical zero indices would be rebuilt as a "valid" cache
        canon(None if (ck is None
                       or np.shape(ck.ws_idx) != ws_shape) else ck.ws_ok,
              (D,), bool),
        canon(None if ck is None else ck.beta_prev, (p,), np.float64),
        np.asarray([0.0, 0.0] if ck is None
                   else [ck.lam_k, ck.lam_km1], np.float64),
    )
    (beta_path, beta_warm, residuals, key, c, drift, active, ws_idx,
     ws_ok, beta_prev, lamk2) = jax.tree_util.tree_map(
        np.asarray, mh.broadcast_one_to_all(payload))
    return ShardedPathCheckpoint(
        lam_path=np.asarray(lam_np), next_index=k, beta_path=beta_path,
        beta_warm=beta_warm, residuals=residuals, key=key, c=c,
        drift=drift, active=active, ws_idx=ws_idx, ws_ok=ws_ok,
        beta_prev=beta_prev, lam_k=float(lamk2[0]),
        lam_km1=float(lamk2[1]), n_shards=D)


class PathCheckpoint(NamedTuple):
    """Resumable warm-start state of a λ-path solve (SURVEY.md §5.4).

    Complete CD solver state: resuming from it reproduces the exact
    trajectory an uninterrupted run would follow (key + cached-gradient
    state included; the transient per-solve counters ``it``/``conv``/
    ``done`` are reset by every solve and need no persistence)."""

    lam_path: np.ndarray     # full λ grid (identifies the run)
    next_index: int          # first unsolved path point
    beta_path: np.ndarray    # (num_solved, p) solved coefficients
    beta_warm: np.ndarray    # (p,) warm-start iterate for next_index
    residuals: np.ndarray    # (n,) residuals at beta_warm
    sigma: float             # running σ estimate (scaled-lasso outer loops)
    key: np.ndarray          # PRNG key driving randomized visit orders
    c: np.ndarray            # (nb, B) cached KKT gradient (λ-independent)
    drift: np.ndarray        # (nb,) staleness bound on each block of c
    active: np.ndarray       # (nb,) active-block mask
    ws_idx: np.ndarray       # (C,) compaction working-set indices
                             # (empty when compaction is off; the dense
                             # gathered columns are NOT persisted — they
                             # are a deterministic re-gather of ws_idx)
    ws_ok: bool              # whether ws_idx holds a real gather
    beta_prev: np.ndarray    # (p,) previous path point's solution — the
                             # secant warm-start extrapolation's second
                             # support point (_extrapolate_path_start)
    lam_k: float             # abscissa of beta_warm's path point
    lam_km1: float           # abscissa of beta_prev's path point


def save_checkpoint(path: str, ck: PathCheckpoint) -> None:
    """Atomic write (tmp + rename) of the checkpoint."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f: np.asarray(v) for f, v in ck._asdict().items()})
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[PathCheckpoint]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if any(f not in z.files for f in PathCheckpoint._fields):
            # old-format / foreign file: treat like a mismatched grid —
            # ignore and restart rather than crash mid-resume
            return None
        return PathCheckpoint(
            lam_path=z["lam_path"],
            next_index=int(z["next_index"]),
            beta_path=z["beta_path"],
            beta_warm=z["beta_warm"],
            residuals=z["residuals"],
            sigma=float(z["sigma"]),
            key=z["key"],
            c=z["c"],
            drift=z["drift"],
            active=z["active"],
            ws_idx=z["ws_idx"],
            ws_ok=bool(z["ws_ok"]),
            beta_prev=z["beta_prev"],
            lam_k=float(z["lam_k"]),
            lam_km1=float(z["lam_km1"]),
        )


def lasso_path_resumable(X, y, lam_path, checkpoint_file: str,
                         options: CDOptions = CDOptions(), *,
                         standardize_X: bool = True, seed: int = 0,
                         checkpoint_every: int = 1) -> LassoPath:
    """Warm-started Lasso path with per-point checkpointing.

    Same semantics (and, point for point, the same solver trajectory) as
    ``lasso_path`` (reference ``LassoPath``, lasso.jl:229-260), but each
    solved λ point persists the full warm-start state to
    ``checkpoint_file``; an interrupted run resumes at the first unsolved
    point and continues exactly as the uninterrupted run would have.
    Points are solved one jit call at a time (the scan variant in
    models/lasso_path.py is faster when resumability is not needed).
    """
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    n, p = X.shape
    lam_np = np.asarray(lam_path, dtype=np.dtype(X.dtype))
    lamw = std_X(X) if standardize_X else jnp.ones((p,), X.dtype)
    n_scale = jnp.asarray(n, X.dtype)

    nc = _compact_nc("ls", options, -(-p // options.block_size),
                     options.block_size, X.dtype)

    @jax.jit
    def init_state(key):
        prob = build_blocked("ls", options, lamw, X=X, y=y)
        cache = _empty_ws_cache("ls", prob, nc, options) if nc else None
        return _init_state(
            "ls", prob, _to_blocked_beta(jnp.zeros((p,), X.dtype),
                                         options.block_size), key), cache

    @jax.jit
    def rebuild_cache(idx, ok):
        prob = build_blocked("ls", options, lamw, X=X, y=y)
        return _ws_cache_from_idx("ls", prob, nc, options, idx, ok)

    @jax.jit
    def solve_one(lam, st, cache, beta_prev_b, lam_k, lam_km1):
        # mirror models/lasso_path._lasso_path_core.scan_body exactly —
        # including the carried compaction working-set cache and the
        # secant warm-start extrapolation — so resumable trajectories
        # coincide with the scan path's
        prob = build_blocked("ls", options, lamw, X=X, y=y)
        key, k1 = jax.random.split(st.key)
        if options.warm_start:
            if nc and resolve_extrapolate(options, False):
                st = _extrapolate_path_start(st, cache, beta_prev_b,
                                             lam_k, lam_km1, lam)
            st, cache = _solve_at_lambda_ws("ls", options, prob, lam,
                                            st._replace(key=k1), n_scale,
                                            cache)
        else:
            st = solve_blocked("ls", options, prob, lam,
                              jnp.zeros_like(st.beta), k1)
        return st, cache

    ck = load_checkpoint(checkpoint_file)
    if ck is not None and (ck.lam_path.shape == lam_np.shape
                           and np.allclose(ck.lam_path, lam_np)):
        start = ck.next_index
        betas = [b for b in ck.beta_path]
        st, cache = init_state(jnp.asarray(ck.key))  # shape/dtype template
        if nc and ck.ws_idx.shape[0] == nc * options.block_size:
            # the dense gathered columns are a deterministic function of
            # (X, ws_idx): reconstructing them restores the cache exactly,
            # so a resumed run's working-set choices (and hence its whole
            # trajectory) coincide with the uninterrupted run's
            cache = rebuild_cache(jnp.asarray(ck.ws_idx, jnp.int32),
                                  bool(ck.ws_ok))
        st = st._replace(
            beta=_to_blocked_beta(jnp.asarray(ck.beta_warm, X.dtype),
                                  options.block_size),
            r=jnp.asarray(ck.residuals, X.dtype),
            key=jnp.asarray(ck.key),
            c=jnp.asarray(ck.c, X.dtype),
            drift=jnp.asarray(ck.drift, X.dtype),
            active=jnp.asarray(ck.active, bool),
        )
        beta_prev_b = _to_blocked_beta(jnp.asarray(ck.beta_prev, X.dtype),
                                       options.block_size)
        lam_k, lam_km1 = ck.lam_k, ck.lam_km1
    else:
        start = 0
        betas = []
        st, cache = init_state(jax.random.PRNGKey(seed))
        beta_prev_b = st.beta
        # both abscissa carries start at the first path value (the scan
        # path's init) so the first two points skip the shift
        lam_k = lam_km1 = float(lam_np[0])

    for i in range(start, lam_np.shape[0]):
        beta_k_b = st.beta
        st, cache = solve_one(jnp.asarray(lam_np[i], X.dtype), st, cache,
                              beta_prev_b,
                              jnp.asarray(lam_k, X.dtype),
                              jnp.asarray(lam_km1, X.dtype))
        beta_prev_b, lam_km1, lam_k = beta_k_b, lam_k, float(lam_np[i])
        beta_i = np.asarray(st.beta.reshape(-1)[:p])
        betas.append(beta_i)
        if (i + 1) % checkpoint_every == 0 or i == lam_np.shape[0] - 1:
            r_np = np.asarray(st.r)
            save_checkpoint(checkpoint_file, PathCheckpoint(
                lam_path=lam_np,
                next_index=i + 1,
                beta_path=np.stack(betas) if betas else
                np.zeros((0, p), lam_np.dtype),
                beta_warm=beta_i,
                residuals=r_np,
                sigma=float(np.std(r_np)),
                key=np.asarray(st.key),
                c=np.asarray(st.c),
                drift=np.asarray(st.drift),
                active=np.asarray(st.active),
                ws_idx=(np.asarray(cache.idx) if cache is not None
                        else np.zeros((0,), np.int32)),
                ws_ok=(bool(cache.ok) if cache is not None else False),
                beta_prev=np.asarray(beta_prev_b.reshape(-1)[:p]),
                lam_k=float(lam_k),
                lam_km1=float(lam_km1),
            ))

    return LassoPath(jnp.asarray(lam_np), jnp.asarray(np.stack(betas)))


def lasso_path_resumable_sharded(X, y, lam_path, checkpoint_file: str,
                                 mesh, options: CDOptions = CDOptions(), *,
                                 standardize_X: bool = True,
                                 axis: str = "feature", seed: int = 0,
                                 checkpoint_every: int = 1) -> LassoPath:
    """Feature-sharded warm-started Lasso path with per-point
    checkpointing — the multi-device restart story (SURVEY.md §5.4 applied to
    §5.7's long-axis scaling; the reference's serial loop is
    lasso.jl:250-252).  Point for point this mirrors
    ``parallel.lasso_path_sharded``'s scan body (same secant warm-start
    policy, same per-shard compaction cache carried across points — the
    cache's dense columns live on device between calls and only
    ``ws_idx``/``ws_ok`` are persisted), so an interrupted run resumed
    from the checkpoint follows the identical trajectory, including with
    ``randomize=True``.  Resume requires the same mesh shape
    (``ShardedPathCheckpoint.n_shards``); a mismatch restarts cleanly.
    """
    from jax.sharding import PartitionSpec as P

    from ..ops.block_cd import CDState
    from ..parallel.sharded_cd import (
        _pad_cols_to,
        _pad_vec_to,
        _shard_chunk,
        _sharded_extrapolate_start,
        _sharded_init_state,
        _sharded_solve_at_lambda,
        solve_blocked_sharded,
    )

    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype)
    n, p = X.shape
    D = mesh.shape[axis]
    B = options.block_size
    chunk, P_tot = _shard_chunk(p, D, B)
    nb_local = chunk // B
    nc = _compact_nc("ls", options, nb_local, B, X.dtype)
    C = nc * B
    lam_np = np.asarray(lam_path, dtype=np.dtype(X.dtype))
    lamw = std_X(X) if standardize_X else jnp.ones((p,), X.dtype)
    n_scale = jnp.asarray(n, X.dtype)

    # pytree-of-specs for the globally-stacked solver state: block-indexed
    # leaves shard over the feature axis, scalars/vectors replicate
    state_spec = CDState(beta=P(axis), r=P(), rsqr=P(), active=P(axis),
                         key=P(), it=P(), conv=P(), done=P(),
                         c=P(axis), drift=P(axis))
    # the per-shard WsCache stacks every leaf on a leading shard axis
    # (scalar `ok` is carried as shape (1,) locally), so one P(axis)
    # prefix shards the whole subtree; None when compaction is off
    cache_spec = P(axis) if nc else None

    def _wrap_cache(cache):
        return cache._replace(ok=cache.ok[None]) if nc else None

    def _unwrap_cache(g):
        return g._replace(ok=g.ok[0]) if nc else None

    def _init_local(Xl, yv, lamwl, key):
        prob = build_blocked("ls", options, lamwl, X=Xl, y=yv)
        beta_b0 = _to_blocked_beta(jnp.zeros((Xl.shape[1],), Xl.dtype), B)
        st = _sharded_init_state("ls", prob, beta_b0, key, axis)
        cache = _empty_ws_cache("ls", prob, nc, options) if nc else None
        return st, _wrap_cache(cache)

    def _rebuild_local(Xl, yv, lamwl, idx, ok):
        prob = build_blocked("ls", options, lamwl, X=Xl, y=yv)
        return _wrap_cache(
            _ws_cache_from_idx("ls", prob, nc, options, idx, ok[0]))

    def _solve_local(Xl, yv, lamwl, lam, st, g_cache, beta_prev_b,
                     lam_k, lam_km1):
        # mirror parallel.sharded_cd._make_sharded_path.scan_body exactly
        prob = build_blocked("ls", options, lamwl, X=Xl, y=yv)
        cache = _unwrap_cache(g_cache)
        key, k1 = jax.random.split(st.key)
        st = st._replace(key=key)
        if options.warm_start:
            if nc and resolve_extrapolate(options, False):
                st = _sharded_extrapolate_start(st, cache, beta_prev_b,
                                                lam_k, lam_km1, lam, axis)
            st, cache = _sharded_solve_at_lambda(
                "ls", options, prob, lam, st._replace(key=k1), n_scale,
                axis, D, cache=cache)
        else:
            st = solve_blocked_sharded("ls", options, prob, lam,
                                       jnp.zeros_like(st.beta), k1, axis, D)
        return st, _wrap_cache(cache)

    data_spec = (P(None, axis), P(), P(axis))
    _init_sm = jax.shard_map(
        _init_local, mesh=mesh, in_specs=data_spec + (P(),),
        out_specs=(state_spec, cache_spec), check_vma=False)
    _rebuild_sm = jax.shard_map(
        _rebuild_local, mesh=mesh, in_specs=data_spec + (P(axis), P(axis)),
        out_specs=cache_spec, check_vma=False)
    _solve_sm = jax.shard_map(
        _solve_local, mesh=mesh,
        in_specs=data_spec + (P(), state_spec, cache_spec, P(axis),
                              P(), P()),
        out_specs=(state_spec, cache_spec), check_vma=False)

    # pad to the sharded width INSIDE each jitted program (sharded_cd
    # _pad_cols_to rationale: an eager Xp would keep a second full-size
    # design live across the whole path loop next to the blocked layout)
    def _padded(Xv, lamwv):
        return _pad_cols_to(Xv, P_tot), _pad_vec_to(lamwv, P_tot, 1.0)

    @jax.jit
    def init_all(Xv, yv, lamwv, key):
        Xp_, lamwp_ = _padded(Xv, lamwv)
        return _init_sm(Xp_, yv, lamwp_, key)

    @jax.jit
    def rebuild_all(Xv, yv, lamwv, idx, ok):
        Xp_, lamwp_ = _padded(Xv, lamwv)
        return _rebuild_sm(Xp_, yv, lamwp_, idx, ok)

    @jax.jit
    def solve_one(Xv, yv, lamwv, lam, st, g_cache, beta_prev_b,
                  lam_k, lam_km1):
        Xp_, lamwp_ = _padded(Xv, lamwv)
        return _solve_sm(Xp_, yv, lamwp_, lam, st, g_cache, beta_prev_b,
                         lam_k, lam_km1)

    ck = load_sharded_checkpoint(checkpoint_file)
    valid = (ck is not None and ck.n_shards == D
             and ck.lam_path.shape == lam_np.shape
             and np.allclose(ck.lam_path, lam_np))
    if jax.process_count() > 1:
        # multi-process: the checkpoint is WRITTEN by process 0 only and
        # no shared filesystem is assumed, so each process's local read
        # may disagree (typically: process 0 has the file, the rest have
        # nothing).  Every process must resume from the SAME state — the
        # jitted solve_one programs are cross-process collectives invoked
        # once per remaining path point, so divergent start indices are a
        # distributed hang.  Process 0's decision + state win.
        ck = _broadcast_sharded_ck(ck if valid else None, lam_np, n, p,
                                   D, C, P_tot, B)
        valid = ck is not None
    if valid:
        start = ck.next_index
        betas = [b for b in ck.beta_path]
        st, cache_g = init_all(X, y, lamw, jnp.asarray(ck.key))
        if nc and ck.ws_idx.shape == (D, C):
            cache_g = rebuild_all(X, y, lamw,
                                  jnp.asarray(ck.ws_idx,
                                              jnp.int32).reshape(-1),
                                  jnp.asarray(ck.ws_ok, bool))
        st = st._replace(
            beta=jnp.pad(jnp.asarray(ck.beta_warm, X.dtype),
                         (0, P_tot - p)).reshape(-1, B),
            r=jnp.asarray(ck.residuals, X.dtype),
            key=jnp.asarray(ck.key),
            c=jnp.asarray(ck.c, X.dtype),
            drift=jnp.asarray(ck.drift, X.dtype),
            active=jnp.asarray(ck.active, bool),
        )
        beta_prev_b = jnp.pad(jnp.asarray(ck.beta_prev, X.dtype),
                              (0, P_tot - p)).reshape(-1, B)
        lam_k, lam_km1 = ck.lam_k, ck.lam_km1
    else:
        start = 0
        betas = []
        st, cache_g = init_all(X, y, lamw, jax.random.PRNGKey(seed))
        beta_prev_b = st.beta
        lam_k = lam_km1 = float(lam_np[0])

    for i in range(start, lam_np.shape[0]):
        beta_k_b = st.beta
        st, cache_g = solve_one(X, y, lamw,
                                jnp.asarray(lam_np[i], X.dtype), st,
                                cache_g, beta_prev_b,
                                jnp.asarray(lam_k, X.dtype),
                                jnp.asarray(lam_km1, X.dtype))
        beta_prev_b, lam_km1, lam_k = beta_k_b, lam_k, float(lam_np[i])
        beta_i = _to_host(st.beta.reshape(-1)[:p])
        betas.append(beta_i)
        if (i + 1) % checkpoint_every == 0 or i == lam_np.shape[0] - 1:
            # multi-process: every process gathers the same host values
            # (the allgathers in _to_host are collective — ALL processes
            # must execute them), process 0 alone writes the file
            ck_out = ShardedPathCheckpoint(
                lam_path=lam_np,
                next_index=i + 1,
                beta_path=np.stack(betas) if betas else
                np.zeros((0, p), lam_np.dtype),
                beta_warm=beta_i,
                residuals=_to_host(st.r),
                key=_to_host(st.key),
                c=_to_host(st.c),
                drift=_to_host(st.drift),
                active=_to_host(st.active),
                ws_idx=(_to_host(cache_g.idx).reshape(D, C) if nc
                        else np.zeros((D, 0), np.int32)),
                ws_ok=(_to_host(cache_g.ok) if nc
                       else np.zeros((D,), bool)),
                beta_prev=_to_host(beta_prev_b.reshape(-1)[:p]),
                lam_k=float(lam_k),
                lam_km1=float(lam_km1),
                n_shards=D,
            )
            if jax.process_index() == 0:
                save_sharded_checkpoint(checkpoint_file, ck_out)

    return LassoPath(jnp.asarray(lam_np), jnp.asarray(np.stack(betas)))
