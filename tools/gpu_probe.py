#!/usr/bin/env python
"""Layer measurements on one NVIDIA GPU at the headline shape.

    python tools/gpu_probe.py [--out chiprun_out/probe.json]

Times, at n = 10,000, p = 100,000 float32 (the ``chip_smoke.py`` data):

- one active pass (``block_cd._active_pass``) with the exact and the ista
  inner solver, and the kernels each block visit launches (from a trace);
- one KKT full check (``block_cd._full_check``) that refreshes every block
  and one that refreshes none: wall time, kernels and device time;
- the sequential λ-path scan (``lasso_path(path_batch=0)``, 100 points):
  warm wall time;
- a trace of a 10-point scan: device busy share, kernel count, the idle
  gaps between kernels, and which event each gap follows (a gap after a
  device-to-host copy is the host reading a ``while_loop`` predicate);
- a trace of the batched path (auto default): busy share, top kernels.

Every number is printed with the card's name and power limit and written
to ``--out`` as JSON.  Needs a GPU; exits non-zero elsewhere.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def median_time(fn, *args, reps=7):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def device_events(fn, *args):
    """Run ``fn(*args)`` once under the profiler; return the GPU kernel
    events as ``(name, start_ns, duration_ns)`` and the trace's line
    names (for reading the trace by hand)."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))            # compile outside the trace
    d = tempfile.mkdtemp(prefix="probe_trace_")
    with jax.profiler.trace(d):
        jax.block_until_ready(fn(*args))
    path = glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)[0]
    events, lines = [], set()
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.add(f"{plane.name}|{line.name}")
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                events.append((e.name, e.start_ns, e.duration_ns))
    return events, sorted(lines)


def busy_and_gaps(events):
    """Union of kernel intervals over the window first-start..last-end:
    busy share, and the idle gaps between consecutive busy intervals."""
    iv = sorted((s, s + d) for _, s, d in events)
    if not iv:
        return 0.0, [], 0.0
    busy, gaps = 0.0, []
    cs, ce = iv[0]
    for s, e in iv[1:]:
        if s > ce:
            busy += ce - cs
            gaps.append(s - ce)
            cs, ce = s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    window = iv[-1][1] - iv[0][0] if len(iv) > 1 else ce - cs
    window = max(window, max(e for _, e in iv) - iv[0][0])
    return busy / window, gaps, window


def gaps_by_predecessor(events):
    """Idle time on the device grouped by the event that ends just before
    each gap: ``{name: (count, total_ms)}``."""
    iv = sorted((s, s + d, name) for name, s, d in events)
    out = {}
    end, last = None, None
    for s, e, name in iv:
        if end is not None and s > end:
            n, t = out.get(last, (0, 0.0))
            out[last] = (n + 1, t + (s - end) / 1e6)
        if end is None or e >= end:
            end, last = e, name
    return out


def top_kernels(events, k=8):
    """The ``k`` kernels with the most device time:
    ``(total_ms, name, calls)``."""
    tot = {}
    for name, _, d in events:
        t, c = tot.get(name, (0, 0))
        tot[name] = (t + d, c + 1)
    return sorted(((v[0] / 1e6, n[:80], v[1]) for n, v in tot.items()),
                  reverse=True)[:k]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                   "probe.json"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import chip_smoke as cs

    card = cs.gpu_name_and_power()
    import jax
    import jax.numpy as jnp

    import coordinatedescent_jl_tpu as cd
    from coordinatedescent_jl_tpu.ops import block_cd
    from coordinatedescent_jl_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache(os.path.join(ROOT, ".jax_cache"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"gpu_probe: no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    res = {"card": card, "device_kind": dev.device_kind}
    print(f"card: {card}; device_kind {dev.device_kind!r}", flush=True)

    def section(name, fn):
        t0 = time.perf_counter()
        try:
            res[name] = fn()
        except Exception as e:                # report and go on
            res[name] = {"error": f"{type(e).__name__}: {e}"[:2000]}
        print(f"[{name}] ({time.perf_counter() - t0:.1f} s) "
              f"{json.dumps(res[name], default=str)[:3000]}", flush=True)

    size = cs.HEADLINE
    Xh, yh = cs.make_data(size["n"], size["p"], size["s"], args.seed)
    X, y = jax.device_put(Xh), jax.device_put(yh)
    del Xh
    n, p = X.shape
    opts = cd.CDOptions()
    ones = jnp.ones((p,), X.dtype)
    prob = jax.jit(lambda X, y: block_cd.build_blocked(
        "ls", opts, ones, X=X, y=y))(X, y)
    nb, B = prob.lamw.shape
    lam = float(cs.lambda_grid(X, y, ones, 100)[-1])
    sol = cd.lasso(X, y, lam).x
    beta_b = block_cd._to_blocked_beta(sol, B)
    st0 = jax.jit(lambda prob, b: block_cd._init_state(
        "ls", prob, b, jax.random.PRNGKey(0)))(prob, beta_b)
    nsc = jnp.asarray(float(n), X.dtype)
    lam0 = jnp.asarray(lam, X.dtype)

    def passes():
        out = {}
        for n_act in (8, 64):
            act = jnp.zeros((nb,), bool).at[:n_act].set(True)
            b2 = beta_b.at[:n_act, 0].set(
                jnp.where(beta_b[:n_act, 0] == 0, 1e-3, beta_b[:n_act, 0]))
            st = jax.jit(lambda prob, b: block_cd._init_state(
                "ls", prob, b, jax.random.PRNGKey(0)))(prob, b2)
            st = st._replace(active=act)
            for inner in ("exact", "ista"):
                o = opts.replace(inner=inner, randomize=False)
                fn = jax.jit(lambda prob, st, o=o: block_cd._active_pass(
                    "ls", prob, st, lam0, nsc, False, o))
                ms = 1e3 * median_time(fn, prob, st, reps=5)
                ev, _ = device_events(fn, prob, st)
                busy, gaps, win = busy_and_gaps(ev)
                out[f"{inner}_{n_act}_blocks"] = {
                    "ms_per_pass": ms, "ms_per_block_visit": ms / n_act,
                    "kernels_per_block_visit": len(ev) / n_act,
                    "device_busy_share": busy,
                    "device_kernel_ms": sum(d for *_, d in ev) / 1e6}
        return out

    def full_check():
        out = {}
        o = opts
        fn = jax.jit(lambda prob, st: block_cd._full_check(
            "ls", prob, st, lam0, nsc, o.opt_tol, o))
        st_fresh, _ = fn(prob, st0)           # refreshes every block
        for name, st in (("refresh_all", st0), ("refresh_none", st_fresh)):
            ms = 1e3 * median_time(fn, prob, st)
            ev, lines = device_events(fn, prob, st)
            out[name] = {"ms": ms, "kernels": len(ev),
                         "device_kernel_ms": sum(d for *_, d in ev) / 1e6,
                         "top": top_kernels(ev, 5)}
        out["trace_lines"] = lines[:12]
        out["xla_dense_gradient_ms"] = 1e3 * median_time(
            jax.jit(lambda prob, r: block_cd._full_gradient_c(
                "ls", prob, r)), prob, st0.r)
        return out

    lams = cs.lambda_grid(X, y, cd.std_X(X), 100)

    def scan_wall():
        run = lambda: cd.lasso_path(X, y, lams, path_batch=0).beta_path
        return {"points": len(lams), "warm_s": median_time(run, reps=3)}

    def scan_trace():
        ev, _ = device_events(
            lambda: cd.lasso_path(X, y, lams[:10], path_batch=0).beta_path)
        busy, gaps, win = busy_and_gaps(ev)
        g = np.asarray(gaps, float)
        after = gaps_by_predecessor(ev)
        d2h = after.get("MemcpyD2H", (0, 0.0))
        return {"points": 10, "window_ms": win / 1e6, "kernels": len(ev),
                "device_busy_share": busy,
                "gaps": int(g.size),
                "gap_median_us": float(np.median(g) / 1e3) if g.size else 0,
                "gap_p90_us": float(np.percentile(g, 90) / 1e3)
                if g.size else 0,
                "gap_total_ms": float(g.sum() / 1e6),
                "d2h_copies": sum(1 for e in ev if e[0] == "MemcpyD2H"),
                "gaps_after_d2h": d2h[0],
                "gap_ms_after_d2h": d2h[1],
                "gap_ms_by_predecessor": sorted(
                    ((round(v[1], 3), k[:60], v[0])
                     for k, v in after.items()), reverse=True)[:8],
                "top": top_kernels(ev)}

    def batched_trace():
        ev, _ = device_events(
            lambda: cd.lasso_path(X, y, lams).beta_path)
        busy, gaps, win = busy_and_gaps(ev)
        return {"window_ms": win / 1e6, "kernels": len(ev),
                "device_busy_share": busy, "top": top_kernels(ev)}

    section("active_pass", passes)
    section("full_check", full_check)
    section("lambda_path_scan_wall", scan_wall)
    section("lambda_path_scan_trace", scan_trace)
    section("lambda_path_batched_trace", batched_trace)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(f"wrote {args.out}; card {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
