#!/usr/bin/env python
"""Two-process ``jax.distributed`` scaling measurement (the two-process
test proves correctness; this MEASURES the N≥2-process tier).

Strong scaling of ``parallel.lasso_sharded`` on the CPU backend with Gloo
collectives: the same global problem is solved by

- 1 process × 1 device holding all features (baseline), and
- 2 processes × 1 device each holding half the features,

with every process pinned to ONE core (taskset).  The pinning is the
measurement's validity condition: the XLA CPU backend multi-threads
WITHIN an op, so an unpinned 1-process baseline already uses every core
and any sharding shows zero speedup by construction (measured: a
feature-sharded GEMV runs 15.6/14.1/13.5 ms at 1/2/4 virtual devices on
4 unpinned cores).  With one core per worker the per-worker compute
resource is constant and the efficiency ratio isolates communication +
sharding overhead — the quantity that transfers to several accelerators,
where compute per device is likewise constant and collectives ride the
interconnect.

    efficiency = T_1proc / (nproc · T_nproc)      (strong scaling)

Collective accounting comes from the COMPILED module: the XLA HLO of the
sharded solve is scanned for ``all-reduce`` / ``all-gather`` /
``collective-permute`` ops and their result-shape bytes — the exact
communication schedule XLA emitted for one solve program (ops inside the
solver's while loops execute once per iteration; the static schedule is
recorded alongside the measured wall times, reference: SURVEY §5.8).

Runs standalone (``python tools/multiproc_bench.py``) and is invoked by
``bench.py`` to record the ``multiproc_efficiency`` block.
"""

import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, sys, time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 1)

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
out = sys.argv[4]

if nproc > 1:
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)

import numpy as np
import jax.numpy as jnp

import coordinatedescent_jl_tpu as cd
from coordinatedescent_jl_tpu.parallel.distributed import feature_mesh

mesh = feature_mesh()
assert len(jax.devices()) == nproc

rng = np.random.default_rng(11)
n, p, s = 10_000, 16384, 50
X = rng.standard_normal((n, p)).astype(np.float32)
b = np.zeros(p, np.float32)
b[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
y = (X @ b + 0.3 * rng.standard_normal(n)).astype(np.float32)
lam = 0.1 * float(np.max(np.abs(X.T @ y)) / n)
opts = cd.CDOptions(opt_tol=1e-6, randomize=False)

sol = cd.parallel.lasso_sharded(X, y, lam, mesh, options=opts)  # compile
nnz = int(jnp.sum(sol.x != 0))
best = float("inf")
for rep in range(3):
    t0 = time.perf_counter()
    sol = cd.parallel.lasso_sharded(X, y, lam * (1.0 + 1e-7 * (rep + 1)),
                                    mesh, options=opts)
    float(jnp.sum(sol.x))
    best = min(best, time.perf_counter() - t0)

if pid == 0:
    with open(out, "w") as f:
        json.dump({"t_solve": best, "nnz": nnz,
                   "n": n, "p": p, "nproc": nproc}, f)
"""

_HLO_WORKER = r"""
import json, sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

out = sys.argv[1]

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh

import coordinatedescent_jl_tpu as cd
from coordinatedescent_jl_tpu.utils.options import CDOptions

# 2-device mesh single-process: the COMPILED collective schedule is the
# same program SPMD-partitioned for 2 shards that the 2-process run
# executes (Gloo vs threads changes the transport, not the schedule)
mesh = Mesh(np.asarray(jax.devices()[:2]), ("feature",))
rng = np.random.default_rng(11)
n, p = 10_000, 16384
X = rng.standard_normal((n, p)).astype(np.float32)
y = rng.standard_normal(n).astype(np.float32)
lam = 0.05
opts = CDOptions(opt_tol=1e-6, randomize=False)

import re
from coordinatedescent_jl_tpu.parallel import lasso_sharded

def run(X, y, lam):
    return lasso_sharded(X, y, lam, mesh, options=opts).x

compiled = jax.jit(run).lower(X, y, lam).compile()
txt = compiled.as_text()

ops = {"all-reduce": 0, "all-gather": 0, "collective-permute": 0,
       "all-to-all": 0, "reduce-scatter": 0}
bytes_per = {k: 0 for k in ops}
# `<shapes> all-reduce(` with the op token not an operand reference
# (operands appear as `%all-reduce...`); shapes may carry `{layout}`
op_re = re.compile(r"=\s*(.+?)\s(?<!%)(all-reduce|all-gather|"
                   r"collective-permute|all-to-all|reduce-scatter)"
                   r"(?:-start)?\(")
_DT = {"f32": 4, "f64": 8, "s32": 4, "u32": 4, "pred": 1, "bf16": 2,
       "s8": 1, "u8": 1, "f16": 2, "s64": 8, "u64": 8}
for line in txt.splitlines():
    m = op_re.search(line)
    if not m:
        continue
    shapes, op = m.group(1), m.group(2)
    ops[op] += 1
    for sm in re.finditer(r"([a-z0-9]+)\[([0-9,]*)\]", shapes):
        dt, dims = sm.group(1), sm.group(2)
        sz = _DT.get(dt, 4)
        for d in dims.split(","):
            if d:
                sz *= int(d)
        bytes_per[op] += sz

with open(out, "w") as f:
    json.dump({"static_collective_ops": {k: v for k, v in ops.items() if v},
               "static_collective_bytes": {k: v for k, v in bytes_per.items()
                                           if v}}, f)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pin(cpus):
    if shutil.which("taskset"):
        return ["taskset", "-c", cpus]
    return []


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (env.get("PYTHONPATH", "") + os.pathsep + _REPO)
    env.pop("JAX_PLATFORMS", None)
    return env


def run(timeout=600):
    """Run the measurement; returns the result dict."""
    env = _env()
    with tempfile.TemporaryDirectory() as td:
        # single-process baseline on 2 cores
        out1 = os.path.join(td, "r1.json")
        subprocess.run(_pin("0") + [sys.executable, "-c", _WORKER,
                                      "0", "1", "0", out1],
                       check=True, env=env, timeout=timeout,
                       cwd=td)
        # two processes, 2 cores each
        port = str(_free_port())
        out2 = os.path.join(td, "r2.json")
        procs = [subprocess.Popen(
            _pin("0" if pid == 0 else "2")
            + [sys.executable, "-c", _WORKER, str(pid), "2", port, out2],
            env=env, cwd=td) for pid in range(2)]
        for pr in procs:
            if pr.wait(timeout=timeout) != 0:
                raise RuntimeError("worker failed")
        with open(out1) as f:
            r1 = json.load(f)
        with open(out2) as f:
            r2 = json.load(f)
        # static collective schedule of the 2-shard program
        outh = os.path.join(td, "hlo.json")
        coll = {}
        try:
            subprocess.run([sys.executable, "-c", _HLO_WORKER, outh],
                           check=True, env=env, timeout=timeout, cwd=td)
            with open(outh) as f:
                coll = json.load(f)
        except Exception as e:  # pragma: no cover
            coll = {"collective_accounting_error": str(e)[:200]}
    eff = r1["t_solve"] / (2.0 * r2["t_solve"])
    return {
        "shape": {"n": r1["n"], "p": r1["p"]},
        "t_1proc_s": round(r1["t_solve"], 4),
        "t_2proc_s": round(r2["t_solve"], 4),
        "speedup": round(r1["t_solve"] / r2["t_solve"], 3),
        "efficiency": round(eff, 3),
        "nnz_agree": r1["nnz"] == r2["nnz"],
        "cores_per_worker": 1,
        **coll,
    }


if __name__ == "__main__":
    print(json.dumps(run()))
